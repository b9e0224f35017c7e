"""Synthetic LM token streams: structured pseudo-text with learnable bigram
statistics, for the federated LM task (``federated/task.py::LmTask``). A
Zipfian unigram base plus a class-conditioned Markov kernel gives each
"domain" (client group) its own distribution — mirroring non-IID
federated text.

Stream version 2: ``make_stream`` used to run a per-token Python loop with an
``rng.choice(vocab, p=base)`` host call per emitted token — O(n_tokens) RNG
round-trips, which the federated LM sweep pays once per client. The loop is
replaced by precomputed inverse-CDF sampling (one ``searchsorted`` over the
Zipf CDF) plus a closed form for the deterministic bigram segments: between
two Zipf draws the chain iterates the affine map ``t -> (31 t + 7 + d) mod V``
whose m-th iterate is ``A[m] t0 + (7 + d) S[m] mod V`` with ``A[m] = 31^m``
and ``S[m] = sum_{i<m} 31^i`` — both tabulated once per call. The RNG draw
ORDER necessarily changed (the old stream interleaved branch/choice draws),
so the per-seed streams are intentionally re-versioned; the new streams are
pinned by a golden regression test (tests/test_task_lm.py) and keep the same
marginal statistics (Zipf unigrams, ~0.6 bigram-continuation rate).

A numpy copy of ``repro.data.tokens``: the same seed gives the same
stream and windows, byte for byte (tests/test_torch_lm.py pins it), and
``batches`` the same training batches (tests/test_torch_train.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def zipf_probs(vocab: int, s: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** s
    return p / p.sum()


def _affine_tables(n: int, vocab: int, domain: int):
    """(A, C) with A[m] = 31^m mod V and C[m] = (7+domain)*sum_{i<m} 31^i
    mod V — the m-th iterate of the bigram map is ``A[m]*t0 + C[m] mod V``.
    The power sequence is eventually periodic with period <= V, so only the
    cycle is computed in Python; the length-n tables are index lookups."""
    pows, seen = [], {}
    v = 1
    while v not in seen:
        seen[v] = len(pows)
        pows.append(v)
        v = (v * 31) % vocab
    start = seen[v]                      # cycle entry point
    period = len(pows) - start
    idx = np.arange(n)
    cyc = np.where(idx < len(pows), idx,
                   start + (idx - start) % period)
    A = np.asarray(pows, np.int64)[np.minimum(cyc, len(pows) - 1)]
    S = np.concatenate([[0], np.cumsum(A[:-1]) % vocab])
    C = ((7 + domain) % vocab) * S % vocab
    return A, C


def make_stream(n_tokens: int, vocab: int, seed: int = 0,
                domain: int = 0) -> np.ndarray:
    """Markov stream: next-token dist = mix(zipf, shifted-by-domain zipf).

    Vectorized (stream v2, see module docstring): three bulk RNG draws —
    the initial token, the per-step branch uniforms, and the per-step Zipf
    uniforms — then a closed-form evaluation of every deterministic bigram
    segment. No per-token host RNG calls.
    """
    rng = np.random.default_rng(seed + 7919 * domain)
    if n_tokens <= 0:
        return np.empty(0, np.int32)
    cdf = np.cumsum(zipf_probs(vocab))
    t0 = int(rng.integers(vocab))
    u_branch = rng.random(n_tokens)       # branch decision after token i
    u_tok = rng.random(n_tokens)          # inverse-CDF Zipf draw per step
    z = np.searchsorted(cdf, u_tok).astype(np.int64)

    # token 0 and every post-Zipf-draw position start a fresh affine segment
    is_start = np.empty(n_tokens, bool)
    is_start[0] = True
    is_start[1:] = u_branch[:-1] >= 0.6
    start_val = np.empty(n_tokens, np.int64)
    start_val[0] = t0
    start_val[1:] = z[:-1]

    pos = np.arange(n_tokens)
    seg = np.maximum.accumulate(np.where(is_start, pos, -1))
    off = pos - seg                       # iterate count within the segment
    A, C = _affine_tables(n_tokens, vocab, domain)
    toks = (A[off] * start_val[seg] + C[off]) % vocab
    return toks.astype(np.int32)


def batches(stream: np.ndarray, batch: int, seq: int,
            rng: np.random.Generator):
    """Yield {tokens: (B, S)} windows forever: each batch B window starts
    drawn uniformly from [0, len(stream) - seq - 1) — the training
    launchers' batches, the reference's draw for draw."""
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        yield {"tokens": np.stack([stream[s:s + seq] for s in starts])}


# ---------------------------------------------------------------------- #
# Federated token windows (the LM task's Dataset analogue)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class TokenDataset:
    """Fixed-length token windows with a per-window domain id.

    ``y`` holds the domain each window was drawn from — the LM analogue of
    the MNIST class label, so ``data.partition.partition`` (sort-by-label
    group allocation) works on token data unchanged. Quality statistics
    (histograms, Gini-Simpson) are computed over the TOKENS, not ``y``:
    the server never uses the domain ids, they only shape the non-IID
    allocation.
    """
    tokens: np.ndarray   # (N, seq) int32 windows
    y: np.ndarray        # (N,) int32 domain ids (partition sort key)

    def __len__(self):
        return self.tokens.shape[0]

    def subset(self, idx: np.ndarray) -> "TokenDataset":
        return TokenDataset(self.tokens[idx], self.y[idx])


def make_windows(n_windows: int, vocab: int, seq: int,
                 n_domains: int = 10, seed: int = 0) -> TokenDataset:
    """Cut ``n_windows`` fixed-length windows from ``n_domains`` domain
    streams, interleaved round-robin so truncation stays domain-balanced."""
    per = -(-n_windows // n_domains)
    toks = np.stack([make_stream(per * seq, vocab, seed=seed,
                                 domain=d).reshape(per, seq)
                     for d in range(n_domains)], axis=1)
    ys = np.broadcast_to(np.arange(n_domains, dtype=np.int32),
                         (per, n_domains))
    return TokenDataset(toks.reshape(per * n_domains, seq)[:n_windows],
                        ys.reshape(-1)[:n_windows].copy())
