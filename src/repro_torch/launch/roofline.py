"""Roofline terms and arithmetic-intensity context, H100 constants from
``launch/mesh.py``.

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = sum_ops factor(op) * bytes(op) / ICI_BW

Ring-model factors: all-reduce counts 2x (reduce-scatter + all-gather
phases), every other collective 1x. The byte counts of the collectives
are an input here: the port has no compiled HLO to read them from
(``collective_bytes`` comes with the sharded plane).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}


def roofline_terms(flops: float, hbm_bytes: float,
                   coll: Dict[str, int]) -> Dict[str, float]:
    """The three roofline terms in seconds; ``coll`` maps a collective op
    (a key of ``_FACTORS``) to the bytes it moves."""
    coll_s = sum(_FACTORS[op] * b for op, b in coll.items()) / ICI_BW
    return {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll_s,
    }


def dominant(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def model_flops(cfg, tokens: int, train: bool) -> float:
    """6*N*D (training) or 2*N*D (inference forward) with N = the active
    non-embedding parameters (a MoE layer counts its top-k routed and
    shared experts only)."""
    n = cfg.param_count(active_only=True) - cfg.vocab_size * cfg.d_model
    mult = 6.0 if train else 2.0
    return mult * n * tokens


def intensity_context(flops: float, hbm_bytes: float,
                      measured_s: float = 0.0) -> Dict:
    """Arithmetic-intensity context of a traced phase (obs.report).

    From the analytic flops/bytes estimates attached to a span: the
    intensity (FLOPs/byte), the H100's ridge point (PEAK_FLOPS_BF16 /
    HBM_BW), which side of the roof the phase sits on, the time floor the
    roof implies, and — given a measured wall time — the attained
    fraction of that floor."""
    if flops < 0 or hbm_bytes <= 0:
        raise ValueError(f"need flops >= 0 and bytes > 0: {flops}, "
                         f"{hbm_bytes}")
    ai = flops / hbm_bytes
    ridge = PEAK_FLOPS_BF16 / HBM_BW
    floor_s = max(flops / PEAK_FLOPS_BF16, hbm_bytes / HBM_BW)
    out = {"flops": flops, "hbm_bytes": hbm_bytes, "intensity": ai,
           "ridge": ridge,
           "bound": "compute" if ai >= ridge else "memory",
           "time_floor_s": floor_s}
    if measured_s > 0:
        out["attained_frac"] = floor_s / measured_s
    return out
