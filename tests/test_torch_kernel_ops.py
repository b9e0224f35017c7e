"""The kernels K1–K6 as operators of torch's dispatcher
(``kernels/oplib.py``): each operator's fake implementation (which serves
``meta`` tensors) gives its CPU implementation's shapes and dtypes and
computes nothing; ``FlopCounterMode`` counts each by the module's ``cost``;
each ``cost`` gives the bounds ``PERF.md`` §6 prints at the kernel table's
shapes (``chip_smoke.py``'s bound: the larger of the bytes over 3.35 TB/s
and the operations over the inputs' peak rate, K2's 32-bit operations at
half the float32 rate); a CPU call launches nothing; another device has no
implementation.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import decode_attention as k4
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import moe_gemm as k5
from repro_torch.kernels import oplib
from repro_torch.kernels import robust_aggregate as k2
from repro_torch.kernels import ssd_scan as k6
from repro_torch.kernels import weighted_aggregate as k1
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

F32, BF16 = torch.float32, torch.bfloat16
LAUNCHES = (k1.weighted_aggregate, k2.robust_aggregate, k3.flash_attention,
            k4.decode_attention, k5.moe_gemm, k6.ssd_scan)


def _rand(*shape, dtype=F32, seed=0):
    g = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(
        dtype)


def _calls(device):
    """(name, the wrapper's call) of every kernel at a small shape on
    ``device`` (CPU tensors drawn once, then moved)."""
    def on(t):
        return t.to(device)
    dt = on(torch.nn.functional.softplus(_rand(2, 64, 4, seed=3)))
    A = on(-torch.exp(0.2 * _rand(4, seed=4)))
    return [
        ("weighted_aggregate", lambda: k1.weighted_aggregate(
            on(_rand(5, 37)), on(_rand(5).abs() + 0.1))),
        ("robust_aggregate", lambda: k2.robust_aggregate(
            on(_rand(8, 37)), 7, trim=2)),
        ("robust_aggregate", lambda: k2.robust_aggregate(
            on(_rand(8, 37, dtype=BF16)), 8, mode="median")),
        ("flash_attention", lambda: k3.flash_attention(
            on(_rand(2, 4, 16, 16)), on(_rand(2, 2, 24, 16)),
            on(_rand(2, 2, 24, 16)), window=8)),
        ("decode_attention", lambda: k4.decode_attention(
            on(_rand(2, 4, 16, dtype=BF16)), on(_rand(2, 20, 2, 16, dtype=BF16)),
            on(_rand(2, 20, 2, 16, dtype=BF16)), 13)),
        ("moe_gemm", lambda: k5.moe_gemm(on(_rand(3, 9, 16)),
                                         on(_rand(3, 16, 5)))),
        ("ssd_scan", lambda: k6.ssd_scan(
            on(_rand(2, 64, 4, 16)), dt, A, on(_rand(2, 64, 2, 8)),
            on(_rand(2, 64, 2, 8)), chunk=32)),
        ("ssd_scan", lambda: k6.ssd_scan(
            on(_rand(2, 64, 4, 16, dtype=BF16)), dt, A,
            on(_rand(2, 64, 2, 8, dtype=BF16)),
            on(_rand(2, 64, 2, 8, dtype=BF16)), chunk=32,
            compute_dtype="bfloat16")),
    ]


def _meta(t):
    return [(x.shape, x.dtype) for x in (t if isinstance(t, tuple) else (t,))]


@pytest.mark.parametrize("i", range(len(_calls("cpu"))))
def test_fake_output_is_the_cpu_output_in_shape_and_dtype(i):
    name, cpu = _calls("cpu")[i]
    _, meta = _calls("meta")[i]
    before = [fn.launches for fn in LAUNCHES]
    got, want = meta(), cpu()
    assert _meta(got) == _meta(want), name
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)))
    assert [fn.launches for fn in LAUNCHES] == before


def test_every_kernel_is_an_operator_with_its_cost():
    names = {str(p).split(".")[-1] for p in oplib.COSTS}
    assert names == {"weighted_aggregate", "robust_aggregate",
                     "flash_attention", "decode_attention", "moe_gemm",
                     "ssd_scan", "bi_gemm", "bi_reduce"}
    for name in names:
        assert getattr(torch.ops.repro_torch, name) in oplib.COSTS


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("i", range(len(_calls("cpu"))))
def test_flop_counter_counts_each_kernel_by_its_cost(device, i):
    """One operator under FlopCounterMode: its FLOPs are its cost's, on
    real CPU tensors and on meta tensors alike (the CPU route's own
    arithmetic is not counted)."""
    name, call = _calls(device)[i]
    seen = []
    real = oplib.COSTS.copy()

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func._overloadpacket in real:
                seen.append(real[func._overloadpacket](*args, **(kwargs or {})))
            return out

    with FlopCounterMode(display=False) as fc, Spy():
        call()
    assert len(seen) == 1
    assert fc.get_total_flops() == int(seen[0][0]) > 0
    assert set(str(k) for k in fc.get_flop_counts()["Global"]) \
        == {f"repro_torch.{name}"}


def test_a_device_without_an_implementation_raises():
    """Only CPU, CUDA and meta tensors have an implementation: a tensor of
    another dispatch key (sparse) raises, reaching no plain version."""
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.moe_gemm.default(
            torch.zeros(2, 3, 4).to_sparse(), torch.zeros(2, 4, 5))


def _bound(flops, nbytes, rate):
    """(PERF.md's printed bound ms, what bounds it)."""
    by_bytes, by_ops = nbytes / HBM_BW, flops / rate
    return (f"{max(by_bytes, by_ops) * 1e3:.4g}",
            "bytes" if by_bytes >= by_ops else "operations")


@pytest.mark.parametrize("cost,rate,want", [
    # K1 at the main path's 48 rows
    (lambda: k1.cost(48, 50_890, F32), PEAK_FLOPS_F32, ("0.002978", "bytes")),
    # K2 run (a): trimmed mean of 44 of 48 rows
    (lambda: k2.cost(44, 50_890, 8, "trimmed_mean", F32), PEAK_FLOPS_F32 / 2,
     ("0.002734", "bytes")),
    # K3: lm_tiny, starcoder2 and qwen2-moe prefill, seamless's three
    (lambda: k3.cost(32, 4, 32, 32, 16, True, None, F32), PEAK_FLOPS_F32,
     ("0.000313", "bytes")),
    (lambda: k3.cost(8, 48, 2048, 2048, 128, True, None, BF16, 4),
     PEAK_FLOPS_BF16, ("0.4171", "operations")),
    (lambda: k3.cost(8, 16, 2048, 2048, 128, True, None, BF16),
     PEAK_FLOPS_BF16, ("0.139", "operations")),
    (lambda: k3.cost(8, 16, 2048, 2048, 64, True, None, BF16),
     PEAK_FLOPS_BF16, ("0.06952", "operations")),
    (lambda: k3.cost(8, 16, 2048, 2048, 64, False, None, BF16),
     PEAK_FLOPS_BF16, ("0.139", "operations")),
    (lambda: k3.cost(8, 16, 2048, 1024, 64, False, None, BF16),
     PEAK_FLOPS_BF16, ("0.06948", "operations")),
    # K3's backward at the training shape
    (lambda: k3.backward_cost(2, 16, 4096, 4096, 128, True, None, BF16),
     PEAK_FLOPS_BF16, ("0.3475", "operations")),
    # K4: starcoder2 and qwen2-moe decode, seamless cross and self
    (lambda: k4.cost(8, 48, 4, 2064, 128, BF16), PEAK_FLOPS_BF16,
     ("0.01015", "bytes")),
    (lambda: k4.cost(8, 16, 16, 2048, 128, BF16), PEAK_FLOPS_BF16,
     ("0.04008", "bytes")),
    (lambda: k4.cost(8, 16, 16, 2048, 64, BF16), PEAK_FLOPS_BF16,
     ("0.02004", "bytes")),
    (lambda: k4.cost(8, 16, 16, 2064, 64, BF16), PEAK_FLOPS_BF16,
     ("0.0202", "bytes")),
    # K5: qwen2-moe decode and prefill, DeepSeek prefill and decode, one
    # of the two backward products at the training shape
    (lambda: k5.cost(60, 8, 2048, 1408, BF16), PEAK_FLOPS_BF16,
     ("0.1043", "bytes")),
    (lambda: k5.cost(60, 1368, 2048, 1408, BF16), PEAK_FLOPS_BF16,
     ("0.4786", "operations")),
    (lambda: k5.cost(256, 640, 7168, 2048, BF16), PEAK_FLOPS_BF16,
     ("4.864", "operations")),
    (lambda: k5.cost(256, 8, 7168, 2048, BF16), PEAK_FLOPS_BF16,
     ("2.255", "bytes")),
    (lambda: k5.cost(60, 688, 2048, 1408, BF16), PEAK_FLOPS_BF16,
     ("0.2407", "operations")),
    # K6: mamba2's prefill, either compute dtype
    (lambda: k6.cost(8, 2048, 32, 64, 128, 1, 256, BF16), PEAK_FLOPS_BF16,
     ("0.0457", "bytes")),
])
def test_cost_gives_the_perf_table_bounds(cost, rate, want):
    assert _bound(*cost(), rate) == want


def test_ssd_cost_counts_the_initial_state_once():
    f0, b0 = k6.cost(2, 512, 4, 64, 128, 1, 256, BF16)
    f1, b1 = k6.cost(2, 512, 4, 64, 128, 1, 256, BF16, init=True)
    assert f0 == f1 and b1 - b0 == 2 * 4 * 128 * 64 * 4


@pytest.mark.parametrize("s,t,causal,window", [
    (1, 1, True, None), (37, 37, True, None), (100, 130, True, 48),
    (100, 130, False, 17), (64, 32, False, None), (2048, 2048, True, 1024)])
def test_band_pairs_counts_band_mask(s, t, causal, window):
    assert k3.band_pairs(s, t, causal, window) \
        == int(k3.band_mask(s, t, causal, window).sum())
