"""Non-IID federated partition (paper §V-A "Data distribution").

Sort the training data by label, form groups of ``group_size`` same-label
samples, then allocate uniformly between ``min_groups`` and ``max_groups``
groups to each of the K UEs. Groups are drawn without replacement, so
datasets are unbalanced AND class-skewed.

A numpy copy of ``repro.data.partition``: the same dataset and RNG give the
same clients, byte for byte, and consume the same draws
(tests/test_torch_data.py pins it). The padding helpers build the uniform
``(K, S)`` layout the vectorized cohort engine stacks: real samples occupy
each row's prefix, padding is all-zero with validity mask 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.attacks import poison_dataset

GROUP_SIZE = 50
MIN_GROUPS = 1
MAX_GROUPS = 30


@dataclasses.dataclass
class ClientData:
    """One UE's local dataset.

    ``clean`` keeps the pre-poison twin when a data attack rewrote
    ``data`` at partition time (None for honest UEs): round-scheduled data
    attacks gather the clean rows in the UE's off rounds (see
    ``federated.server.CohortData``).
    """
    ue_id: int
    data: object              # synthetic_mnist.Dataset or tokens.TokenDataset
    malicious: bool = False
    clean: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.data)


def partition(train, n_ues: int, rng: np.random.Generator,
              malicious: Optional[np.ndarray] = None,
              attack=None, group_size: int = GROUP_SIZE,
              min_groups: int = MIN_GROUPS,
              max_groups: int = MAX_GROUPS,
              context: str = "") -> List[ClientData]:
    """Allocate label-sorted sample groups to K UEs (module docstring).

    ``attack`` poisons each malicious UE's raw data: either a
    ``core.attacks`` data attack (dispatched on the dataset type by
    ``attacks.poison_dataset``, whose mismatch error names ``context``) or
    the legacy label-only ``core.poisoning.LabelFlipAttack``
    (``apply(y, rng)``). The clean twin of a poisoned dataset is kept on
    ``ClientData.clean``.
    """
    order = np.argsort(train.y, kind="stable")
    n_groups = len(train) // group_size
    groups = order[: n_groups * group_size].reshape(n_groups, group_size)

    perm = rng.permutation(n_groups)
    counts = rng.integers(min_groups, max_groups + 1, size=n_ues)
    # truncate if the draw exceeds the pool (keeps the protocol well-defined)
    while counts.sum() > n_groups:
        counts[np.argmax(counts)] -= 1

    clients, cursor = [], 0
    mal = set(malicious.tolist()) if malicious is not None else set()
    for k in range(n_ues):
        take = perm[cursor: cursor + counts[k]]
        cursor += counts[k]
        idx = groups[take].reshape(-1)
        ds = train.subset(idx)
        is_mal = k in mal
        clean = None
        if is_mal and attack is not None:
            clean = ds
            if hasattr(attack, "poison") or hasattr(attack, "poison_tokens"):
                ds = poison_dataset(attack, ds, rng, context=context)
            else:                               # legacy label-only attack
                ds = type(ds)(ds.x, attack.apply(ds.y, rng))
        clients.append(ClientData(ue_id=k, data=ds, malicious=is_mal,
                                  clean=clean))
    return clients


def label_histogram(ds, n_classes: int = 10) -> np.ndarray:
    return np.bincount(ds.y.astype(int), minlength=n_classes)


def sample_arrays(data) -> Dict[str, np.ndarray]:
    """Per-sample array dict of a dataset — the fields the padded cohort
    layout stacks: a token dataset's ``(N, seq)`` int windows, a feature
    dataset's ``(N, D)/(N,)`` (x, y) pair."""
    if hasattr(data, "tokens"):
        return {"tokens": data.tokens}
    return {"x": data.x, "y": data.y}


@dataclasses.dataclass
class PaddedClients:
    """Uniform-shape client layout for the vectorized cohort engine.

    ``arrays`` holds the per-sample fields (``sample_arrays``: ``tokens``
    for the LM task, ``x``/``y`` for the MLP), each leaf ``(K,
    max_samples, ...)`` zero-padded on the sample axis; ``mask`` is the
    {0,1} float validity mask. The masked SGD gives padding rows an
    exactly-zero gradient, so training on the padded layout reproduces the
    per-client unpadded run. ``x``/``y`` remain as properties for the
    feature layout.
    """
    arrays: Dict[str, np.ndarray]   # each (K, max_samples, ...)
    mask: np.ndarray                # (K, max_samples) float32, 1 = real
    sizes: np.ndarray               # (K,) true sample counts

    @property
    def x(self) -> np.ndarray:
        return self.arrays["x"]

    @property
    def y(self) -> np.ndarray:
        return self.arrays["y"]

    @property
    def max_samples(self) -> int:
        return self.mask.shape[1]


def bucket_levels(max_size: int, n_buckets: int,
                  multiple_of: int = 1) -> np.ndarray:
    """Quantized ``max_samples`` boundaries for size-bucketed sub-cohorts:
    the (rounded-up) max size split into ``n_buckets`` equal levels, each a
    multiple of ``multiple_of`` (the batch size)."""
    if n_buckets < 1 or max_size < 1:
        raise ValueError((max_size, n_buckets))
    step = -(-max_size // (n_buckets * multiple_of)) * multiple_of
    return step * np.arange(1, n_buckets + 1)


def assign_buckets(sizes: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """Smallest bucket level covering each client: (K,) bucket indices."""
    if sizes.max() > levels[-1]:
        raise ValueError(f"client of {sizes.max()} samples exceeds the top "
                         f"level {levels[-1]}")
    return np.searchsorted(levels, sizes)


def _padded_max(sizes: np.ndarray, pad_to: Optional[int]) -> int:
    s_max = int(sizes.max())
    if pad_to is not None:
        if pad_to < s_max:
            raise ValueError(f"pad_to={pad_to} below the largest client "
                             f"({s_max} samples)")
        s_max = pad_to
    return s_max


def pad_clients_bucketed(clients: List[ClientData], n_buckets: int = 3,
                         multiple_of: int = 1, pad_to: Optional[int] = None):
    """Split clients into size buckets, padding each bucket only to its own
    quantized level (see ``bucket_levels``) instead of the global maximum.

    Returns a list of ``(client_ids, PaddedClients)`` pairs, one per
    non-empty bucket, in increasing level order. ``pad_to`` fixes the level
    grid to a protocol constant.
    """
    sizes = np.array([c.size for c in clients], np.int64)
    levels = bucket_levels(_padded_max(sizes, pad_to), n_buckets,
                           multiple_of)
    b_of = assign_buckets(sizes, levels)
    out = []
    for b in range(n_buckets):
        ids = np.flatnonzero(b_of == b)
        if ids.size == 0:
            continue
        pd = pad_clients([clients[i] for i in ids], multiple_of,
                         pad_to=int(levels[b]))
        out.append((ids, pd))
    return out


def pad_clients(clients: List[ClientData], multiple_of: int = 1,
                pad_to: Optional[int] = None) -> PaddedClients:
    """Pad every client to the cohort-uniform shape (see PaddedClients).

    multiple_of — round ``max_samples`` up so the masked SGD's batch grid
    divides it exactly (callers pass their batch size).
    pad_to — pad to this constant instead of the data maximum; must cover
    the largest client.
    """
    sizes = np.array([c.size for c in clients], np.int64)
    s_max = _padded_max(sizes, pad_to)
    s_max = ((s_max + multiple_of - 1) // multiple_of) * multiple_of
    k = len(clients)
    fields = sample_arrays(clients[0].data)
    arrays = {f: np.zeros((k, s_max) + a.shape[1:], a.dtype)
              for f, a in fields.items()}
    mask = np.zeros((k, s_max), np.float32)
    for i, c in enumerate(clients):
        n = c.size
        for f, a in sample_arrays(c.data).items():
            arrays[f][i, :n] = a
        mask[i, :n] = 1.0
    return PaddedClients(arrays=arrays, mask=mask, sizes=sizes)
