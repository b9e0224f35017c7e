"""Roofline terms and arithmetic-intensity context, H100 constants from
``launch/mesh.py``.

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = sum_ops factor(op) * bytes(op) / ICI_BW

Ring-model factors: all-reduce counts 2x (reduce-scatter + all-gather
phases), every other collective 1x; the (n-1)/n ring correction is folded
into 1, as in the reference. The reference sums each collective's output
bytes from compiled HLO, which torch does not have: here
``collective_bytes`` sums them from the collective operators that
``launch/dryrun.py``'s ``StepCounter`` saw run (the process group's
``c10d`` operators and the functional ones DTensor issues), by the
reference's op names.
"""
from __future__ import annotations

from typing import Dict, Mapping

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}
# torch's collective operators by the reference's HLO op names
C10D_OPS = {
    **dict.fromkeys(("c10d.allreduce_", "c10d.allreduce_coalesced_",
                     "_c10d_functional.all_reduce",
                     "_c10d_functional.all_reduce_",
                     "_c10d_functional.all_reduce_coalesced"), "all-reduce"),
    **dict.fromkeys(("c10d.allgather_", "c10d._allgather_base_",
                     "c10d.allgather_into_tensor_coalesced_",
                     "_c10d_functional.all_gather_into_tensor",
                     "_c10d_functional.all_gather_into_tensor_out",
                     "_c10d_functional.all_gather_into_tensor_coalesced"),
                    "all-gather"),
    **dict.fromkeys(("c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
                     "c10d.reduce_scatter_tensor_coalesced_",
                     "_c10d_functional.reduce_scatter_tensor",
                     "_c10d_functional.reduce_scatter_tensor_coalesced"),
                    "reduce-scatter"),
    **dict.fromkeys(("c10d.alltoall_", "c10d.alltoall_base_",
                     "_c10d_functional.all_to_all_single"), "all-to-all"),
}


def collective_bytes(op_bytes: Mapping[str, int]) -> Dict[str, int]:
    """Sum output bytes per collective op type: ``op_bytes`` maps a torch
    collective operator (a key of ``C10D_OPS``, as ``StepCounter``
    records them in ``op_collective_bytes``) to the bytes its outputs
    hold."""
    out: Dict[str, int] = {op: 0 for op in _COLL_OPS}
    for name, nbytes in op_bytes.items():
        out[C10D_OPS[name]] += int(nbytes)
    return out


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
