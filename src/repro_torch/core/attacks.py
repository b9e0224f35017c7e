"""Threat-model plane: pluggable attack scenarios (paper §III-B, §V, §VI).

    AttackScenario — a named bundle of four orthogonal components:
        data     DataAttack        poisons a malicious UE's raw data at
                                   partition time (label flips with pair x
                                   fraction x multi-pair, feature noise;
                                   token-space TokenFlip/TokenNoise)
        model    ModelAttack       manipulates the *uploaded update*
                                   (sign-flip, boosted, free-rider,
                                   stale replay)
        report   ReportAttack      inflates the self-reported accuracy
                                   (the beta1 term's target)
        schedule MaliciousSchedule WHEN malicious UEs act: always,
                                   intermittent duty cycles, or a
                                   colluding round-robin rotation

A copy of ``repro.core.attacks``. The data attacks are host numpy and draw
from the host ``Generator`` (the stream of record) exactly as the reference
does, so the same seed poisons the same samples byte for byte. The model
attack is a torch op on ``{name: tensor}`` params: ``apply_loop`` for one
client, ``apply_stacked`` for the whole stacked cohort (one masked
``torch.where`` per leaf, bit-equal to the loop). The data attacks' stacked
twins (``LabelFlip.apply_rows``, ``FeatureNoise.apply_rows``) apply the
same poisoning to the padded (K, S) client layout as torch ops, one masked
``torch.where`` a flip pair, equal to the host path given the same draws.
The scenario registry and the metric helpers (recovery rounds, reputation
gap) live at the bottom.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

Pair = Tuple[int, int]
Params = Dict[str, torch.Tensor]


def _check_pairs(pairs, what: str) -> Tuple[Pair, ...]:
    pairs = tuple((int(s), int(t)) for s, t in pairs)
    sources = [s for s, _ in pairs]
    if len(set(sources)) != len(sources):
        raise ValueError(f"duplicate source {what} in {pairs}")
    return pairs


def _check_fraction(flip_fraction: float) -> None:
    if not 0.0 < flip_fraction <= 1.0:
        raise ValueError(f"flip_fraction {flip_fraction} not in (0, 1]")


# ---------------------------------------------------------------------- #
# Data attacks (partition-time, raw client data)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LabelFlip:
    """Label-flipping (paper §III-B.1), generalized: multiple
    ``(source, target)`` pairs and a per-class flip fraction.

    ``flip_fraction < 1`` flips exactly ``round(flip_fraction * n_source)``
    of each source class's samples — the ones with the smallest uniform
    draws (stable ranking). Pairs are resolved against the ORIGINAL labels,
    so chained pairs like (6,2),(2,8) never cascade.
    """
    pairs: Tuple[Pair, ...]
    flip_fraction: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "pairs", _check_pairs(self.pairs, "classes"))
        _check_fraction(self.flip_fraction)

    def draw(self, rng: np.random.Generator, x: np.ndarray,
             y: np.ndarray) -> Optional[np.ndarray]:
        """Per-sample float32 uniforms; None (no stream consumed) for a
        full flip."""
        if self.flip_fraction >= 1.0:
            return None
        return rng.random(len(y), dtype=np.float32)

    def _n_flip(self, n_source: int) -> int:
        return int(np.round(self.flip_fraction * float(n_source)))

    def apply_host(self, x: np.ndarray, y: np.ndarray,
                   u: Optional[np.ndarray]):
        out = y.copy()
        for s, t in self.pairs:
            src = np.flatnonzero(y == s)          # original labels
            if u is not None:
                n = self._n_flip(src.size)
                if n < src.size:
                    order = np.argsort(u[src], kind="stable")
                    src = src[order[:n]]
            out[src] = t
        return x, out

    def poison(self, x, y, rng):
        """Partition entry point: draw + apply in one call."""
        return self.apply_host(x, y, self.draw(rng, x, y))

    def apply_rows(self, x, y, valid, mal, u=None):
        """Stacked twin over (K, S) padded client tensors.

        x (K, S, D); y (K, S) int; valid (K, S) {0,1} real-sample mask;
        mal (K,) bool malicious rows; u (K, S) float32 draws (row k is
        ``draw``'s output for client k, zero-padded), None for a full flip.
        Pairs resolve against the original labels. Returns (x, y).
        """
        y = torch.as_tensor(y)
        y0 = y
        mal_col = torch.as_tensor(mal, dtype=torch.bool,
                                  device=y.device)[:, None]
        valid_b = torch.as_tensor(valid, device=y.device) > 0
        for s, t in self.pairs:
            is_src = (y0 == s) & valid_b
            if u is None:
                flip = is_src
            else:
                # round() on the host in float64, as ``_n_flip`` does
                S = y.shape[-1]
                table = torch.as_tensor(np.round(
                    self.flip_fraction * np.arange(S + 1, dtype=np.float64)
                ).astype(np.int64), device=y.device)
                n_flip = table[is_src.sum(-1)]
                key = torch.where(is_src, torch.as_tensor(u, device=y.device),
                                  torch.inf)
                order = torch.argsort(key, dim=-1, stable=True)
                rank = torch.argsort(order, dim=-1, stable=True)
                flip = is_src & (rank < n_flip[:, None])
            y = torch.where(mal_col & flip, t, y)
        return torch.as_tensor(x), y


@dataclasses.dataclass(frozen=True)
class FeatureNoise:
    """Unreliable-data scenario (cf. arXiv:2102.09491): additive Gaussian
    pixel noise on a malicious/faulty UE's features; labels untouched, so
    the UE's reported histogram — and Eq. 2 diversity — stay truthful and
    only the Eq. 1 test-set gap can catch it."""
    sigma: float = 0.8
    clip: Tuple[float, float] = (0.0, 1.0)   # the data domain of x

    def draw(self, rng: np.random.Generator, x: np.ndarray,
             y: np.ndarray) -> np.ndarray:
        return rng.standard_normal(x.shape).astype(np.float32)

    def apply_host(self, x, y, eps):
        noisy = np.clip(x + np.float32(self.sigma) * eps,
                        *self.clip).astype(np.float32)
        return noisy, y

    def poison(self, x, y, rng):
        return self.apply_host(x, y, self.draw(rng, x, y))

    def apply_rows(self, x, y, valid, mal, eps):
        """Stacked twin over (K, S, D) padded client tensors: the noise
        lands only on malicious rows' REAL samples (padding stays exactly
        zero, the cohort engine's contract). Returns (x, y)."""
        x = torch.as_tensor(x)
        m = (torch.as_tensor(mal, dtype=torch.bool, device=x.device)[:, None]
             & (torch.as_tensor(valid, device=x.device) > 0))[..., None]
        noisy = torch.clamp(
            x + float(np.float32(self.sigma))
            * torch.as_tensor(eps, device=x.device), *self.clip)
        return torch.where(m, noisy, x), torch.as_tensor(y)


@dataclasses.dataclass(frozen=True)
class TokenFlip:
    """Token substitution — the label-flip analogue for LM token streams:
    every occurrence of a source TOKEN in a malicious UE's windows is
    rewritten to the target token. ``flip_fraction < 1`` substitutes exactly
    ``round(fraction * n_source)`` occurrences — the ones with the smallest
    uniform draws (stable ranking). Pairs resolve against the ORIGINAL
    tokens, so chained pairs never cascade."""
    pairs: Tuple[Pair, ...]
    flip_fraction: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "pairs", _check_pairs(self.pairs, "tokens"))
        _check_fraction(self.flip_fraction)

    def poison_tokens(self, tokens: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        """tokens (N, seq) int -> substituted copy (same shape/dtype)."""
        flat = tokens.reshape(-1)
        u = (rng.random(flat.size, dtype=np.float32)
             if self.flip_fraction < 1.0 else None)
        out = flat.copy()
        for s, t in self.pairs:
            src = np.flatnonzero(flat == s)          # original tokens
            if u is not None:
                n = int(np.round(self.flip_fraction * float(src.size)))
                if n < src.size:
                    order = np.argsort(u[src], kind="stable")
                    src = src[order[:n]]
            out[src] = t
        return out.reshape(tokens.shape)


@dataclasses.dataclass(frozen=True)
class TokenNoise:
    """Unreliable-text scenario: each token of a malicious/faulty UE's
    windows is independently resampled uniformly over the vocabulary with
    probability ``rate`` (window domain ids untouched)."""
    rate: float = 0.3
    vocab: int = 64

    def poison_tokens(self, tokens: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        u = rng.random(tokens.shape, dtype=np.float32)
        repl = rng.integers(0, self.vocab,
                            size=tokens.shape).astype(tokens.dtype)
        return np.where(u < np.float32(self.rate), repl, tokens)


DataAttack = Union[LabelFlip, FeatureNoise, TokenFlip, TokenNoise]


def poison_dataset(attack, ds, rng: np.random.Generator,
                   context: str = ""):
    """Dataset-dispatching poison entry point (used by
    ``data.partition.partition``): token-space attacks rewrite a token
    dataset's windows, feature/label attacks rewrite a ``Dataset``'s
    ``(x, y)``; a mismatched (attack, dataset) pairing raises ``TypeError``
    naming ``context`` (the offending task/scenario pairing)."""
    where = f" [{context}]" if context else ""
    if hasattr(attack, "poison_tokens"):
        if not hasattr(ds, "tokens"):
            raise TypeError(
                f"{type(attack).__name__} is a token-space attack and needs "
                f"a token dataset, got {type(ds).__name__}{where} (use "
                "LabelFlip/FeatureNoise for feature/label data)")
        return type(ds)(attack.poison_tokens(ds.tokens, rng), ds.y.copy())
    if not hasattr(ds, "x"):
        raise TypeError(
            f"{type(attack).__name__} poisons (x, y) arrays and needs a "
            f"feature dataset, got {type(ds).__name__}{where} (use TokenFlip/"
            "TokenNoise for token data)")
    return type(ds)(*attack.poison(ds.x, ds.y, rng))


# ---------------------------------------------------------------------- #
# Model attacks (update-time, uploaded parameters)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ModelAttack:
    """Update manipulation ``Omega' = ref + scale * (Omega - g)``.

    scale = -1 — sign-flip (gradient-ascent);
    |scale| > 1 — boosted/backdoor-style amplification;
    scale = 0 — free-rider: the UE uploads ``ref`` untouched.
        ``staleness = 0`` makes ref the current global model (zero update);
        ``staleness = s > 0`` replays the global model from s rounds earlier
        (the server keeps that history, ``FeelServer._attack_ref_params``).
    """
    scale: float = -1.0
    staleness: int = 0

    def apply_loop(self, global_params: Params, local_params: Params,
                   ref_params: Optional[Params] = None) -> Params:
        """One client's poisoned upload (the loop engine's path)."""
        ref = global_params if ref_params is None else ref_params
        return {k: ref[k] + self.scale * (local_params[k] - global_params[k])
                for k in local_params}

    def apply_stacked(self, stacked: Params, global_params: Params, mal,
                      ref_params: Optional[Params] = None) -> Params:
        """The stacked cohort (leaves (N, ...)): malicious rows get the
        manipulated update, honest rows pass through — one masked
        ``torch.where`` per leaf, no per-client dispatch."""
        ref = global_params if ref_params is None else ref_params
        m = torch.as_tensor(np.asarray(mal, bool),
                            device=next(iter(stacked.values())).device)
        out = {}
        for k, l in stacked.items():
            mm = m.reshape(m.shape + (1,) * (l.dim() - 1))
            out[k] = torch.where(
                mm, ref[k] + self.scale * (l - global_params[k]), l)
        return out


@dataclasses.dataclass(frozen=True)
class ReportAttack:
    """Dishonest accuracy reporting: malicious UEs add ``boost`` to their
    self-reported local accuracy (clipped to 1) — the quantity Eq. 1's
    beta1 term treats as suspect."""
    boost: float = 0.3

    def apply(self, acc_local: np.ndarray, mal: np.ndarray) -> np.ndarray:
        return np.where(mal, np.minimum(acc_local + self.boost, 1.0),
                        acc_local)


# ---------------------------------------------------------------------- #
# Activity schedules (WHEN malicious UEs act)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MaliciousSchedule:
    """Round-dependent activity of the malicious set.

    always       — every malicious UE attacks every round.
    intermittent — all attack only when ``t % period < duty``.
    roundrobin   — colluding rotation: the malicious set splits into
                   ``period`` groups by rank and group ``t % period``
                   attacks in round t.

    Gates every component: model/report attacks directly per round, and
    data attacks through the clean twin a poisoned UE trains on in its off
    rounds (see ``federated.server.CohortData``).
    """
    kind: str = "always"      # always | intermittent | roundrobin
    period: int = 1
    duty: int = 1

    def __post_init__(self):
        if self.kind not in ("always", "intermittent", "roundrobin"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if not (self.period >= 1 and 1 <= self.duty <= self.period):
            raise ValueError((self.period, self.duty))

    def active(self, t: int, mal_mask: np.ndarray,
               mal_rank: np.ndarray) -> np.ndarray:
        """(K,) bool — the malicious UEs acting in round ``t``.

        mal_mask — (K,) bool malicious flags; mal_rank — (K,) rank of
        each UE within the malicious set (-1 for honest UEs).
        """
        if self.kind == "always":
            return mal_mask
        if self.kind == "intermittent":
            if t % self.period < self.duty:
                return mal_mask
            return np.zeros_like(mal_mask)
        return mal_mask & (mal_rank % self.period == t % self.period)


ALWAYS = MaliciousSchedule()


# ---------------------------------------------------------------------- #
# Scenario: the composite threat model
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AttackScenario:
    """A named threat model: data/model/report components + activity
    schedule. Any subset may be None; all-None is the benign control
    (malicious flags are not even set).

    ``watch`` is the (source, target) pair the metrics track
    (``source_acc``, attack success rate); it defaults to the data
    attack's first flip pair.
    """
    name: str
    data: Optional[DataAttack] = None
    model: Optional[ModelAttack] = None
    report: Optional[ReportAttack] = None
    schedule: MaliciousSchedule = ALWAYS
    watch: Optional[Pair] = None

    def __post_init__(self):
        if self.watch is None and isinstance(self.data,
                                             (LabelFlip, TokenFlip)):
            object.__setattr__(self, "watch", self.data.pairs[0])

    @property
    def benign(self) -> bool:
        return (self.data is None and self.model is None
                and self.report is None)

    def data_key(self):
        """Partition identity: runs whose partitions are identical (same
        labels/features AND same malicious flags) share this key."""
        if self.benign:
            return "none"
        if self.data is None:
            return "mal_only"      # clean data, malicious flags set
        return self.data           # frozen dataclass -> hashable


# ---------------------------------------------------------------------- #
# Registry + scenario constructors
# ---------------------------------------------------------------------- #
SCENARIOS: Dict[str, AttackScenario] = {}


def register(scenario: AttackScenario) -> AttackScenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def label_flip(source: int, target: int, flip_fraction: float = 1.0,
               name: Optional[str] = None) -> AttackScenario:
    if name is None:
        name = f"flip_{source}to{target}"
        if flip_fraction < 1.0:
            name += f"_f{int(round(flip_fraction * 100))}"
    return AttackScenario(name, data=LabelFlip(((source, target),),
                                               flip_fraction))


def multi_flip(pairs, flip_fraction: float = 1.0,
               name: Optional[str] = None) -> AttackScenario:
    pairs = tuple(tuple(p) for p in pairs)
    name = name or ("multi_flip_" + "_".join(f"{s}to{t}"
                                             for s, t in pairs))
    return AttackScenario(name, data=LabelFlip(pairs, flip_fraction))


def feature_noise(sigma: float = 0.8,
                  name: Optional[str] = None) -> AttackScenario:
    return AttackScenario(name or f"noise_{sigma:g}",
                          data=FeatureNoise(sigma))


def token_flip(source: int, target: int, flip_fraction: float = 1.0,
               name: Optional[str] = None) -> AttackScenario:
    """LM data attack: substitute the source TOKEN with the target token in
    malicious UEs' windows (watch pair = the token pair)."""
    if name is None:
        name = f"token_flip_{source}to{target}"
        if flip_fraction < 1.0:
            name += f"_f{int(round(flip_fraction * 100))}"
    return AttackScenario(name, data=TokenFlip(((source, target),),
                                               flip_fraction))


def token_noise(rate: float = 0.3, vocab: int = 64,
                name: Optional[str] = None) -> AttackScenario:
    return AttackScenario(name or f"token_noise_{rate:g}",
                          data=TokenNoise(rate, vocab))


def free_rider(staleness: int = 0,
               name: Optional[str] = None) -> AttackScenario:
    name = name or ("free_rider" if staleness == 0
                    else f"stale_rider_{staleness}")
    return AttackScenario(name, model=ModelAttack(0.0, staleness))


def model_poison(scale: float,
                 name: Optional[str] = None) -> AttackScenario:
    name = name or ("sign_flip" if scale == -1.0 else f"boost_{scale:g}")
    return AttackScenario(name, model=ModelAttack(scale))


def lie_boost(boost: float = 0.3, data: Optional[DataAttack] = None,
              name: Optional[str] = None) -> AttackScenario:
    return AttackScenario(name or f"lie_{boost:g}", data=data,
                          report=ReportAttack(boost))


def intermittent(base: AttackScenario, period: int, duty: int = 1,
                 name: Optional[str] = None) -> AttackScenario:
    """Wrap a scenario in an on-off duty cycle."""
    return dataclasses.replace(
        base, name=name or f"{base.name}_int{period}d{duty}",
        schedule=MaliciousSchedule("intermittent", period, duty))


def colluding(base: AttackScenario, period: int,
              name: Optional[str] = None) -> AttackScenario:
    """Wrap a scenario in a colluding round-robin rotation."""
    return dataclasses.replace(
        base, name=name or f"{base.name}_rr{period}",
        schedule=MaliciousSchedule("roundrobin", period, period))


NO_ATTACK = register(AttackScenario("none"))
register(label_flip(6, 2))                              # easy pair, §V
register(label_flip(8, 4, flip_fraction=0.5))           # partial flip
register(multi_flip(((6, 2), (8, 4))))                  # both §V pairs
register(feature_noise(0.8))
register(free_rider(0))                                 # zero update
register(free_rider(2))                                 # stale replay
register(model_poison(-1.0))                            # sign flip
register(model_poison(3.0))                             # boosted
register(lie_boost(0.3, data=LabelFlip(((8, 4),)),
                   name="lying_flip_8to4"))
register(intermittent(model_poison(-1.0), period=2))
register(colluding(model_poison(-1.0), period=2))
register(token_flip(1, 5))                              # LM data attack
register(token_noise(0.3))
register(intermittent(label_flip(6, 2), period=2,
                      name="flip_6to2_int2"))           # twin-array gather


def as_scenario(spec) -> AttackScenario:
    """Coerce a scenario spec: an AttackScenario passes through, a str
    looks up the registry, and a ``(source, target)`` pair becomes the
    full label flip."""
    if isinstance(spec, AttackScenario):
        return spec
    if isinstance(spec, str):
        return SCENARIOS[spec]
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return label_flip(int(spec[0]), int(spec[1]))
    raise TypeError(f"not an attack scenario spec: {spec!r}")


def legacy_scenario(attack_pair: Optional[Pair], no_attack: bool = False,
                    model_poison_scale: Optional[float] = None,
                    lie_boost_val: float = 0.0) -> AttackScenario:
    """The legacy knob set as one scenario:

    - ``no_attack=True`` wins over everything: no data attack, no model
      poisoning, no lie_boost, malicious flags not set;
    - otherwise ``model_poison_scale`` REPLACES the label-flip data attack
      (malicious UEs keep clean data and poison their updates instead);
    - ``lie_boost`` composes with whichever attack is active;
    - the metrics always watch ``attack_pair``.

    ``attack_pair=None`` is the server's knob set (``FeelServer``'s
    ``model_poison``/``lie_boost``): no data attack — the partition has
    already baked any into the clients — and no watched pair.
    """
    pair = (None if attack_pair is None
            else (int(attack_pair[0]), int(attack_pair[1])))
    pair_tag = "" if pair is None else f"_{pair[0]}to{pair[1]}"
    if no_attack:
        return AttackScenario(f"none_watch{pair_tag}", watch=pair)
    data = model = None
    if model_poison_scale is not None:
        model = ModelAttack(scale=float(model_poison_scale))
    elif pair is not None:
        data = LabelFlip((pair,))
    report = ReportAttack(lie_boost_val) if lie_boost_val else None
    tag = (f"mp_{model_poison_scale:g}" if model_poison_scale is not None
           else "flip")
    if lie_boost_val:
        tag += f"_lie{lie_boost_val:g}"
    return AttackScenario(f"legacy_{tag}{pair_tag}", data=data, model=model,
                          report=report, watch=pair)


# ---------------------------------------------------------------------- #
# Scenario metrics
# ---------------------------------------------------------------------- #
def recovery_rounds(attack_success, threshold: float = 0.5) -> int:
    """Rounds until the attack stays defeated: ``1 + t_last`` where
    ``t_last`` is the last round whose attack success rate is >=
    ``threshold``; 0 if the attack never reached the threshold; -1 when
    the metric is undefined (no watched source->target pair). A return
    equal to ``len(attack_success)`` means the final round was still at or
    above the threshold (not recovered within the horizon)."""
    a = np.asarray(attack_success, float)
    if a.size == 0 or not np.isfinite(a).any():
        return -1
    above = np.flatnonzero(np.nan_to_num(a, nan=-np.inf) >= threshold)
    return 0 if above.size == 0 else int(above[-1]) + 1


def reputation_gap(reputations: np.ndarray, mal_mask: np.ndarray) -> float:
    """Honest-vs-malicious reputation separation: mean honest reputation
    minus mean malicious reputation (NaN when either set is empty)."""
    mal_mask = np.asarray(mal_mask, bool)
    if not mal_mask.any() or mal_mask.all():
        return float("nan")
    return float(np.mean(reputations[~mal_mask])
                 - np.mean(reputations[mal_mask]))
