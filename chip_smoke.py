"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and no phase catches one:

 1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
 2. build every kernel of the port from its source with nvcc (one process
    a source, all at once), timed, with each kernel's registers and spills;
    the SASS of K2–K6 read back (``cuobjdump``): K3's bf16 kernels must
    issue HMMA (``mma.sync``), K5's wgmma kernels HGMMA fed by UTMALDG (TMA
    tensor loads), K4's tensor-core kernels HMMA fed by LDGSTS
    (``cp.async``), K6's chunk-state and chunk-scan kernels HMMA, and K2's
    instances up to 64 rows no shared- or local-memory access (LDS, STS,
    LDL, STL: the sort stays in registers), each looked up by name, K2's
    with its registers and spills;
 3. hold each kernel against its plain PyTorch version on the card — the
    main paths' shapes, ragged and misaligned shapes, bf16 and one
    bandwidth-sized case — with its time, the plain version's, one PyTorch
    library call's (a yardstick the port never calls) and its bound.
    ``weighted_aggregate`` (K1) within 1e-6·max|x|, ``robust_aggregate``
    (K2) bit for bit — and to the bit, zero signs included, against its
    algorithm in plain PyTorch — at its size-class boundaries, with NaN of
    either sign, +-inf, +-0, ties and garbage in the unread rows,
    ``flash_attention`` (K3) within 2e-5 (f32) / 2e-2
    (bf16) — every head dim at a ragged S and T, windowed and not, with
    grouped KV heads — and K3's gradient through its autograd Function
    equal to the plain version's within 1e-5, grouped KV heads too (and at
    starcoder2-15b's prefill shape, 48 query over 4 KV heads, and
    qwen2-moe-a2.7b's); ``decode_attention`` (K4) within
    2e-5 / 2e-2 at tests/test_kernels.py's shapes, at every group size of
    the zoo (G 1, 5, 7, 8, 12) and head dim (16–128) at a ragged length, at
    starcoder2-15b's GQA and qwen2-moe-a2.7b's serving shapes, on a
    window's view and a ring's prefix;
    ``ssd_scan`` (K6) within 5e-4 (the final state; y too in float32,
    2e-2 in bf16) at tests/test_kernels.py's shapes, at mamba2-370m's
    prefill shape with and without an initial state, at Jamba's grouping
    (8 B/C groups over 64 heads), at chunks of 64 and 128, and at a bf16
    shape the tensor-core route does not take (N 8);
    ``moe_gemm`` (K5) within 1e-4 (f32) / 2e-1 (bf16) at
    tests/test_kernels.py's shapes, ragged shapes, either side of its
    launcher's C threshold (the wgmma route from C = 128) and
    qwen2-moe-a2.7b's prefill and decode shapes, with the largest
    difference in bf16 ulps;
 4. the undefended main path at the paper's §V scale: K = 50 UEs,
    50,000/10,000 synthetic MNIST, 5 label flippers, DQS on the host
    control plane, the vectorized engine, 3 rounds on the GPU. Every
    kernel's launch count is set to 0 just before and read just after;
    then one round split into its phases and one under ``torch.profiler``
    say where the time goes;
 5. the defended path at the same scale through ``run_experiment``:
    (a) ``sign_flip`` under ``trimmed_mean+validation`` and (b)
    ``noise_0.8`` under ``median``, 3 rounds each, K2 launched once a round
    and K1 never; one round of (a) split into its phases and one profiled;
 6. K1's defended routes (``norm_clip``, ``krum``, ``validation``) at
    K = 10, 2 rounds each, K1 launched once a round; and the loop engine
    under ``trimmed_mean`` and ``median``, K2 launched once a round;
 7. small runs on the GPU and on the CPU, undefended and under
    ``trimmed_mean+validation``: the same selections and defense counts,
    accuracies within 1e-2;
 8. the LM path: federated fine-tuning of ``lm_tiny`` through
    ``run_experiment(task="lm_tiny")`` in the regime of
    ``examples/federated_llm.py`` (K = 20, 6 malicious, the
    vocabulary-collapse attack, 2,000/400 windows, DQS, 3 rounds; every
    attention forward through K3, FedAvg of the 82,240-parameter updates
    through K1 once a round), then ``policy="random"`` beside it; one round
    split into phases, one profiled; K3 again at the shape the run
    launched it at most; and a K = 8 run on the GPU and the CPU: the same
    selections, loss and accuracy within 1e-3;
 9. serving the decoder-only zoo: ``starcoder2-15b`` (all 40 layers, bf16,
    22 B parameters drawn on the card) and ``mamba2-370m`` (48 layers)
    each take 8 prompts of 2,048 tokens through ``api.prefill`` and 32
    greedy ``api.decode_step`` calls, every launch count set to 0 just before
    and read just after (K3 40 times at prefill and K4 40 times a step;
    K6 48 times at prefill), with prefill and per-token times, peak
    memory, and one uncounted prefill and one decode step profiled; check
    1 runs the same steps with K4's (K6's) plain version (logits within
    0.06·max|plain|, greedy tokens equal but for near ties of 8 bf16
    ulps) and must reject a negative control, a deliberately wrong plain
    version (K4 with the wrong GQA grouping, K6 without the inter-chunk
    term); check 2 runs each at full width, 2 layers, float32, prefill
    plus decode against ``lm_forward`` within 1e-3·max|logit| + 1e-3;
    then reduced configs on
    the GPU and the CPU (starcoder2's ring cache, qwen2.5 and mamba2
    greedy generation): the same tokens, logits within 1e-4;
10. serving the mixture-of-experts zoo: ``qwen2-moe-a2.7b`` (all 24
    layers, bf16, 14.3 B parameters drawn on the card) with the same
    traffic, every launch count set to 0 just before and read just after
    (K3 24 times at prefill, K4 24 times a step, K5 72 times at prefill
    and 72 times a step), the share of routes dropped at prefill, one
    decode step profiled; check 1 holds every MoE layer of the prefill
    and the decode steps, on its own input, against the same layer with
    K5's plain version (within ``MOE_LAYER_TOL``·max|plain|) and must
    reject a negative control (K5's plain version with the experts rolled
    by one) at every layer; the whole run with K5's plain version is
    reported beside it (logit gap, the (layer, token) expert sets that
    differ), not held to a tolerance; check 2
    at full width, 2 layers, float32, capacity factor 8.0; then the
    reduced qwen2-moe (also ``optimized``: group-local dispatch),
    moonshot and Jamba on the GPU and the CPU — the same tokens, logits
    within 1e-4, the Jamba run launching K3, K4, K5 and K6;
11. one JSON line of per-kernel numbers, then the result line.

Exits non-zero without printing a result where CUDA is absent. A kernel's
time is its device time from ``torch.profiler`` over back-to-back calls
(warm L2, as the main path leaves the freshly stacked updates in L2),
reported beside the CUDA-event time per call, which includes the host's
launch overhead.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core import attacks as atk  # noqa: E402
from repro_torch.core.poisoning import (EASY_PAIR, LabelFlipAttack,  # noqa: E402
                                        pick_malicious)
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic_mnist import generate  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.defenses import TrimmedMean  # noqa: E402
from repro_torch.data.tokens import make_stream  # noqa: E402
from repro_torch.federated import simulation  # noqa: E402
from repro_torch.federated.cohort import pad_count  # noqa: E402
from repro_torch.federated.server import FeelServer  # noqa: E402
from repro_torch.federated.task import LM_TINY  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as k4  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import moe_gemm as k5  # noqa: E402
from repro_torch.kernels import ssd_scan as k6  # noqa: E402
from repro_torch.kernels.robust_aggregate import (  # noqa: E402
    SIZE_CLASSES, robust_aggregate, robust_aggregate_network,
    robust_aggregate_ref)
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    weighted_aggregate, weighted_aggregate_ref)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
# one 32-bit instruction (a comparison, an add) a lane a clock: half the
# float32 FLOP rate, which counts an FMA as two
INSTR_PER_S = F32_FLOPS / 2
M_MLP = 784 * 64 + 64 + 64 * 10 + 10   # flattened MLP update, 50,890
KERNELS = {
    "weighted_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_aggregate.cu",
        "replaces": "src/repro/kernels/weighted_aggregate.py:21"},
    "robust_aggregate": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/robust_aggregate.cu",
        "replaces": "src/repro/kernels/robust_aggregate.py:31"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26"},
    "decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:22"},
    "moe_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:18"},
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:26"}}
LAUNCH_COUNTERS = {"weighted_aggregate": weighted_aggregate,
                   "robust_aggregate": robust_aggregate,
                   "flash_attention": k3.flash_attention,
                   "decode_attention": k4.decode_attention,
                   "moe_gemm": k5.moe_gemm,
                   "ssd_scan": k6.ssd_scan}
# examples/federated_llm.py's regime: the uplink of lm_tiny's 82,240 f32
# parameters over a 100 kHz cell binds the knapsack at K = 20
LM_CFG = dict(n_ues=20, n_malicious=6, deadline_s=60.0,
              model_size_bits=LM_TINY.param_count() * 32.0,
              bandwidth_hz=1e5)
# its vocabulary-collapse attack: malicious streams collapse to token 0
COLLAPSE = atk.AttackScenario(
    "token_collapse_all",
    data=atk.TokenFlip(tuple((s, 0) for s in range(1, 64))), watch=(1, 0))


def emit(**kw):
    print(json.dumps(kw), flush=True)


_BUILTIN = {"f": "float", "d": "double", "i": "int", "b": "bool"}


def _source_name(fn, i):
    """The <source-name> of a mangled name at ``i`` (its length in digits,
    then that many characters), and the index after it."""
    j = i
    while fn[j].isdigit():
        j += 1
    return fn[j:j + int(fn[i:j])], j + int(fn[i:j])


def _short(fn):
    """A kernel's name and template arguments from its mangled name
    (Itanium ABI, as nvcc, ptxas and cuobjdump print it): the last
    component of its nested name, e.g. ``flash_bf16_kernel<128>`` from
    ``_ZN12_GLOBAL__N_117flash_bf16_kernelILi128EEEvPK...``."""
    if not fn.startswith("_Z"):
        return fn
    nested = fn[2] == "N"
    i, name = 3 if nested else 2, None
    while fn[i].isdigit():
        name, i = _source_name(fn, i)
        if not nested:
            break
    args = []
    if fn[i] == "I":
        i += 1
        while fn[i] != "E":
            if fn[i] == "L":                # a literal: L <type> <value> E
                end = fn.index("E", i)
                args.append(fn[i + 2:end].replace("n", "-", 1)
                            if fn[i + 2] == "n" else fn[i + 2:end])
                i = end + 1
            elif fn[i].isdigit():
                arg, i = _source_name(fn, i)
                args.append(arg)
            else:
                args.append(_BUILTIN.get(fn[i], fn[i]))
                i += 1
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_summary(log):
    """{kernel: "R registers, S bytes spilled"} from nvcc's -Xptxas=-v."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = _short(line.split("'")[1])
        elif fn and "spill stores" in line:
            spill = line.split(",")[1].split()[0]
        elif fn and "Used" in line and "registers" in line:
            out[fn] = f"{line.split('Used')[1].split()[0]} registers, " \
                      f"{spill} bytes spilled"
            fn = None
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDSM", "LDGSTS", "LDS", "STS",
            "LDL", "STL")


def sass_ops(name):
    """{kernel: {SASS op: count}} of the built library ``name``, from
    ``cuobjdump -sass``: HGMMA is wgmma, UTMALDG a TMA tensor load, HMMA
    mma.sync, LDSM ldmatrix, LDGSTS cp.async, LDS/STS a shared-memory and
    LDL/STL a local-memory (spill) load and store; a predicated
    instruction counts as its op."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _short(line.split("Function :")[1].strip())
            out[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            op = line.split("*/", 1)[-1].split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op and op[0].split(".")[0] in out[fn]:
                out[fn][op[0].split(".")[0]] += 1
    return out


def device_us(prof):
    """{kernel name: summed GPU time in us} of a profiler run."""
    return {name: us for name, (us, _) in device_events(prof).items()}


def device_events(prof):
    """{kernel name: (summed GPU time in us, number of events)} of a
    profiler run."""
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, count = out.get(ev.name, (0.0, 0))
            out[ev.name] = (us + ev.time_range.elapsed_us(), count + 1)
    return out


def time_ms(fn, reps):
    """(device ms, call ms) per call of ``fn`` over ``reps`` back-to-back
    calls. Device ms is the GPU time of the kernels it launches (from
    torch.profiler): for each kernel name, its mean time times its
    launches a call (its events over ``reps``, rounded, at least 1), so a
    few events the profiler drops (it does, after a profiled round) bias
    nothing; call ms is the CUDA-event time per call, which the host's
    launch overhead sets whenever the kernels are shorter. The profiler
    now and then hands back no device events for a short run; then the
    profiled calls are made again, at most twice more, and a third empty
    reading raises."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / reps
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_ms = sum(us / count * max(1, round(count / reps))
                        for us, count in device_events(prof).values()) / 1e3
        if device_ms > 0:
            return device_ms, call_ms
    raise RuntimeError("torch.profiler recorded no device time in 3 runs")


def bound(n, m, dtype):
    """(least ms, what bounds it, bytes moved) of (N, M) x (N,) -> (M,):
    each input read once and the output written once at the memory rate,
    or 2*N*M flops at the f32 rate, whichever takes longer."""
    nbytes = (n * m + m) * torch.tensor([], dtype=dtype).element_size() \
        + n * 4
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2.0 * n * m / F32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def check_aggregate(n, m, dtype, label, assume_normalized=True,
                    misaligned=False, reps=200):
    """Kernel vs plain on the card at one shape; returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(n * 100_003 + m)
    # misaligned: the base pointer one element past the vector alignment
    x = torch.randn(n * m + misaligned, device="cuda", generator=g)
    x = x.to(dtype)[int(misaligned):].view(n, m)
    w = torch.rand(n, device="cuda", generator=g) + 1e-3
    if assume_normalized:
        w = w / w.sum()
    kw = dict(assume_normalized=assume_normalized)
    got = weighted_aggregate(x, w, **kw)
    want = weighted_aggregate_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m,) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    tol = (1e-6 * x.float().abs().max().item() if dtype == torch.float32
           else 1e-2)
    assert err <= tol, (label, n, m, dtype, err, tol)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: weighted_aggregate(x, w, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: weighted_aggregate_ref(x, w, **kw), max(reps // 10, 5))
    wl = w.to(dtype)
    library_ms, library_call_ms = time_ms(lambda: wl @ x, reps)
    b_ms, b_by, nbytes = bound(n, m, dtype)
    row = dict(phase="kernel_check", kernel="weighted_aggregate",
               case=label, n=n, m=m, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_us=b_ms * 1e3, bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def robust_bound(n, m, trim, mode, dtype):
    """(least ms, what bounds it, bytes moved) of the robust reduce of the
    first n rows of (N, M) -> (M,): the n real rows read once and the
    output written once at the memory rate, or the comparisons and adds at
    the 32-bit instruction rate — log2(n!) comparisons a column to order
    it and n - 2b adds for the trimmed mean, n - 1 comparisons (the least
    any selection needs) and 2 operations for the median."""
    nbytes = (n * m + m) * torch.tensor([], dtype=dtype).element_size()
    if mode == "median":
        ops = m * (n - 1 + 2)
    else:
        ops = m * (math.lgamma(n + 1) / math.log(2) + (n - 2 * trim))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INSTR_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def robust_specials(x, n, g):
    """Special values in the first n rows of x (rows, M), in place: the
    values rounded to integers (ties, and -0 from small negatives), then in
    column c a share (c % 8) * 3% of NaN with the sign bit set, quiet NaN,
    +inf and -inf (more NaN than the trim in some columns, fewer in
    others), and columns 128-191 all -0."""
    rows, m = x.shape
    real = (x[:n].float() * 2).round()
    u = torch.rand(n, m, device="cuda", generator=g)
    rate = (torch.arange(m, device="cuda") % 8) * 0.03
    # bits 0xFFC00000, 0x7FC00000, +inf, -inf
    values = torch.tensor([-0x400000, 0x7FC00000, 0x7F800000, -0x800000],
                          dtype=torch.int32, device="cuda").view(
                              torch.float32)
    for lo, hi, v in zip((0.0, 0.5, 0.7, 0.85), (0.5, 0.7, 0.85, 1.0),
                         values):
        real[(u >= rate * lo) & (u < rate * hi)] = v
    real[:, 128:192] = -0.0
    x[:n] = real.to(x.dtype)


def robust_garbage(x, n):
    """Rows n.. of x hold NaN of both signs, +-3e38 and +inf, in place:
    values the kernel must never read."""
    junk = torch.tensor([float("nan"), -float("nan"), 3e38, -3e38,
                         float("inf")], device="cuda")
    x[n:] = junk[torch.arange(x[n:].numel(), device="cuda") % 5].view(
        x[n:].shape).to(x.dtype)


def check_robust(rows, n, m, mode, dtype, label, reps=200, nan=False,
                 special=False, garbage=False):
    """K2 against its plain version on the card at one shape, bit for bit
    (NaN where it is NaN, equal values elsewhere: -0 and +0 are equal,
    since equal values have no stated order), and against the kernel's
    algorithm in plain PyTorch (``robust_aggregate_network``) to the bit,
    the sign of a zero included; rows >= n hold values the kernel must
    ignore. ``nan`` puts NaN in the first 64 columns past the rank window
    (the result is NaN there) and one NaN in the next 64 (trimmed or below
    the median); ``special`` puts in the values of ``robust_specials``,
    ``garbage`` those of ``robust_garbage``. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(rows * 7919 + n * 31 + m)
    x = torch.randn(rows, m, device="cuda", generator=g).to(dtype)
    if nan:
        x[:n // 2 + 1, :64] = float("nan")
        x[0, 64:128] = float("nan")
    if special:
        robust_specials(x, n, g)
    if garbage:
        robust_garbage(x, n)
    trim = TrimmedMean(0.2).n_trim(n) if mode == "trimmed_mean" else 0
    kw = dict(trim=trim, mode=mode)
    got = robust_aggregate(x, n, **kw)
    want = robust_aggregate_ref(x, n, **kw)
    net = robust_aggregate_network(x, n, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m,) and got.dtype == dtype
    is_nan = got.isnan()
    assert torch.equal(is_nan, want.isnan()), (label, rows, n, m, mode)
    assert torch.equal(is_nan, net.isnan()), (label, rows, n, m, mode)
    if not special:
        assert bool(is_nan[:64].all()) == nan and not bool(is_nan[64:].any())
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[~is_nan], want[~is_nan]) and torch.equal(
        got[~is_nan].view(bits), net[~is_nan].view(bits)), (
        label, rows, n, m, mode, dtype)
    finite = got.isfinite()
    err = (got.float() - want.float())[finite].abs().max().item() \
        if bool(finite.any()) else 0.0
    kernel_ms, kernel_call_ms = time_ms(
        lambda: robust_aggregate(x, n, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: robust_aggregate_ref(x, n, **kw), max(reps // 10, 3))
    real = x[:n]
    if mode == "median":
        library = "torch.quantile(midpoint)"
        # torch.quantile takes at most 2**24 elements
        lib_fn = (None if real.numel() > 1 << 24 or dtype != torch.float32
                  else lambda: torch.quantile(real, 0.5, dim=0,
                                              interpolation="midpoint"))
    else:
        library = "torch.sort (sort only)"
        lib_fn = lambda: torch.sort(real, dim=0)
    library_ms = library_call_ms = None
    if lib_fn is not None:
        library_ms, library_call_ms = time_ms(lib_fn, max(reps // 4, 3))
    b_ms, b_by, nbytes = robust_bound(n, m, trim, mode, dtype)
    row = dict(phase="kernel_check", kernel="robust_aggregate", case=label,
               rows=rows, n=n, trim=trim, m=m, mode=mode,
               dtype=str(dtype).split(".")[-1], max_abs_err=err,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library=library,
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def robust_cases():
    """Every ``check_robust`` call of phase 3, as (rows, n, m, mode, dtype,
    label, options): the main path's rows in both modes and types, n = N,
    n = 1, N = 128, NaN uploads, odd and even n, ragged M, one
    bandwidth-sized case; the kernel's size-class boundaries (n = 8/9,
    16/17, 32/33, 64/65, 127/128), each with n = N in the trimmed mean and
    with 3 rows more (at most 128) in the median; and the special values
    with garbage in the unread rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for mode in ("trimmed_mean", "median"):
        cases += [(48, 44, M_MLP, mode, f32, "main path rows", {}),
                  (8, 8, M_MLP, mode, f32, "n = N", {}),
                  (8, 1, M_MLP, mode, f32, "n = 1", {}),
                  (48, 44, M_MLP, mode, bf16, "bf16", {}),
                  (128, 128, M_MLP, mode, f32, "N = 128", {}),
                  (48, 44, M_MLP, mode, f32, "NaN uploads",
                   dict(reps=20, nan=True)),
                  (48, 44, M_MLP, mode, f32, "special values, garbage rows",
                   dict(reps=20, special=True, garbage=True))]
    cases += [(16, 13, M_MLP, "median", f32, "odd n", {}),
              (16, 12, M_MLP, "median", f32, "even n", {}),
              (16, 11, 4097, "trimmed_mean", f32, "ragged M", {}),
              (16, 11, M_MLP + 1, "median", f32, "ragged M", {}),
              (16, 11, 4097, "median", bf16, "bf16 ragged M", {}),
              (64, 60, 1 << 22, "trimmed_mean", f32, "bandwidth",
               dict(reps=5))]
    for n in (8, 9, 16, 17, 32, 33, 64, 65, 127, 128):
        cases += [(n, n, M_MLP, "trimmed_mean", f32, "class boundary, n = N",
                   dict(reps=20)),
                  (min(n + 3, 128), n, M_MLP, "median", f32,
                   "class boundary", dict(reps=20))]
    return cases


def flash_bound(b, h, s, t, d, causal, window, dtype, hkv=None):
    """(least ms, what bounds it, bytes moved) of attention: q read and o
    written once (H heads), k and v read once (their Hkv heads) at the
    memory rate, or 4·D flops for every (query head, key) pair inside the
    causal/window band at the peak rate of the inputs' type, whichever
    takes longer."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * d * (2 * h * s + 2 * (hkv or h) * t) * size
    pairs = int(k3.band_mask(s, t, causal, window).sum())
    flops = 4.0 * d * b * h * pairs
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def check_flash(b, h, s, t, d, causal, window, dtype, label, reps=100,
                hkv=None):
    """K3 against its plain version on the card at one shape (``hkv`` KV
    heads, H by default), within the tolerances of tests/test_kernels.py
    (|err| <= tol + tol·|plain|); returns the numbers. The library
    yardstick is PyTorch's scaled_dot_product_attention with the same mask
    and the same KV heads (``enable_gqa``)."""
    hkv = hkv or h
    g = torch.Generator(device="cuda").manual_seed(b * 7919 + s * 31 + d)
    q, k, v = (torch.randn(b, n_h, n, d, device="cuda", generator=g).to(
        dtype) for n_h, n in ((h, s), (hkv, t), (hkv, t)))
    kw = dict(causal=causal, window=window)
    got = k3.flash_attention(q, k, v, **kw)
    want = k3.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, b, h, s, t, d, causal, window, dtype, err)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k3.flash_attention(q, k, v, **kw), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k3.flash_attention_ref(q, k, v, **kw), max(reps // 5, 5))
    sdpa = functools.partial(
        torch.nn.functional.scaled_dot_product_attention, q, k, v,
        enable_gqa=hkv != h)
    if causal and s == t and window is None:
        lib = lambda: sdpa(is_causal=True)
    elif causal or window is not None:
        mask = k3.band_mask(s, t, causal, window, "cuda")
        lib = lambda: sdpa(attn_mask=mask)
    else:
        lib = sdpa
    library_ms, library_call_ms = time_ms(lib, reps)
    b_ms, b_by, nbytes = flash_bound(b, h, s, t, d, causal, window, dtype,
                                     hkv)
    row = dict(phase="kernel_check", kernel="flash_attention", case=label,
               b=b, h=h, hkv=hkv, s=s, t=t, d=d, causal=causal,
               window=window,
               dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library="scaled_dot_product_attention",
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               attained_tflops=4.0 * d * b * h * int(k3.band_mask(
                   s, t, causal, window).sum()) / (kernel_ms * 1e-3) / 1e12,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def check_flash_grad(b, h, s, d, hkv=None):
    """The gradient through K3's autograd Function (kernel forward, plain
    version's VJP) against the plain version's own, on the card; with
    ``hkv`` < H, dk and dv of the Hkv KV heads."""
    hkv = hkv or h
    g = torch.Generator(device="cuda").manual_seed(b + s + d)
    qkv = [torch.randn(b, n_h, s, d, device="cuda", generator=g)
           for n_h in (h, hkv, hkv)]
    cot = torch.randn(b, h, s, d, device="cuda", generator=g)
    outs = {}
    for name, fn in (("kernel", k3.flash_attention),
                     ("plain", k3.flash_attention_ref)):
        leaves = [x.clone().requires_grad_(True) for x in qkv]
        outs[name] = torch.autograd.grad(fn(*leaves), leaves, cot)
    err = max((a - b_).abs().max().item()
              for a, b_ in zip(outs["kernel"], outs["plain"]))
    assert [x.shape for x in outs["kernel"]] == [x.shape for x in qkv]
    emit(phase="kernel_grad_check", kernel="flash_attention", b=b, h=h,
         hkv=hkv, s=s, d=d, max_abs_err=err)
    assert err <= 1e-5, err


def decode_bound(b, h, hkv, length, d, dtype):
    """(least ms, what bounds it, bytes moved) of flash decode: q read and
    o written once, the ``length`` valid positions of K and V read once,
    at the memory rate; or 4·D flops a (query head, key) at the peak rate
    of the inputs' type, whichever takes longer."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * d + 2 * b * length * hkv * d) * size
    flops = 4.0 * d * b * h * length
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def check_decode(label, b, h, hkv, cap, d, length, dtype, lo=0, reps=100):
    """K4 against its plain version on the card: q (b, h, d) over the
    positions [lo, lo + length) of a (b, cap, hkv, d) cache, passed as a
    view; within the tolerances of tests/test_kernels.py (|err| <= tol +
    tol·|plain|). The library yardstick is PyTorch's
    scaled_dot_product_attention over the same view with a boolean mask
    and its own GQA. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(b * 7919 + cap + length)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(dtype)
    kc, vc = (torch.randn(b, cap, hkv, d, device="cuda", generator=g)
              .to(dtype) for _ in range(2))
    k, v = kc[:, lo:lo + length], vc[:, lo:lo + length]
    got = k4.decode_attention(q, k, v, length)
    want = k4.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, b, h, hkv, cap, d, length, lo, dtype, err)
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k4.decode_attention(q, k, v, length), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k4.decode_attention_ref(q, k, v, length), max(reps // 5, 5))
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = torch.ones(1, 1, 1, length, dtype=torch.bool, device="cuda")
    library_ms, library_call_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), reps)
    b_ms, b_by, nbytes = decode_bound(b, h, hkv, length, d, dtype)
    row = dict(phase="kernel_check", kernel="decode_attention", case=label,
               b=b, h=h, hkv=hkv, cache=cap, d=d, length=length, lo=lo,
               dtype=str(dtype).split(".")[-1],
               route=k4.route(dtype, h // hkv), max_abs_err=err, tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library="scaled_dot_product_attention(bool mask, gqa)",
               library_ms=library_ms, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def ssd_bound(b, length, h, p, n, g, q, dtype):
    """(least ms, what bounds it, bytes moved, flops) of the SSD scan: x,
    B, C and dt read once, y and the final state written once, at the
    memory rate; or the flops at the peak rate of the inputs' type,
    whichever takes longer. Per (b, h, chunk) the flops are counted once:
    Q·N·Q for the causal C·Bᵀ scores, Q·P·Q for their product with x·dt
    and 4·Q·N·P for the inter-chunk term and the state update. In bf16
    every product can run on the tensor cores (989 TFLOP/s): a float32
    operand split into a bf16 hi/lo pair doubles the tensor-core work but
    not the function's flops; in float32 they run on the CUDA cores (67
    TFLOP/s)."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((2 * b * length * h * p + 2 * b * length * g * n) * size
              + b * length * h * 4 + b * h * n * p * 4)
    units = b * h * (length // q)
    flops = (float(q) * n * q + float(q) * p * q + 4.0 * q * n * p) * units
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes, flops)


def check_ssd(label, b, length, h, p, n, g, chunk, dtype, reps=20,
              init=False):
    """K6 against its plain version (the sequential recurrence) on the
    card, y and the final state, within 5e-4 + 5e-4·|plain|
    (tests/test_kernels.py's tolerance) in float32; a bfloat16 y within
    2e-2 + 2e-2·|plain| (both round float32 results to 8 bits), its final
    state within 5e-4 + 5e-4·|plain| still. ``init`` starts from a random
    initial state. No single PyTorch call computes an SSD scan, so there
    is no library yardstick. Returns the numbers."""
    gen = torch.Generator(device="cuda").manual_seed(b * 7919 + length + n)
    x = torch.randn(b, length, h, p, device="cuda", generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, length, h, device="cuda", generator=gen))
    A = -torch.exp(0.2 * torch.randn(h, device="cuda", generator=gen))
    Bm, Cm = (torch.randn(b, length, g, n, device="cuda", generator=gen)
              .to(dtype) for _ in range(2))
    s0 = (torch.randn(b, h, n, p, device="cuda", generator=gen) if init
          else None)
    y, state = k6.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    y_ref, s_ref = k6.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                   initial_state=s0)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype
    tol = 5e-4 if dtype == torch.float32 else 2e-2
    dy = (y.float() - y_ref.float()).abs()
    ds = (state - s_ref).abs()
    assert bool((dy <= tol + tol * y_ref.float().abs()).all()), (
        label, dy.max().item())
    assert bool((ds <= 5e-4 + 5e-4 * s_ref.abs()).all()), (
        label, ds.max().item())
    kernel_ms, kernel_call_ms = time_ms(
        lambda: k6.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                            initial_state=s0), reps)
    plain_ms, plain_call_ms = time_ms(
        lambda: k6.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                initial_state=s0), 2)
    q = min(chunk, length)
    b_ms, b_by, nbytes, flops = ssd_bound(b, length, h, p, n, g, q, dtype)
    row = dict(phase="kernel_check", kernel="ssd_scan", case=label, b=b,
               l=length, h=h, p=p, n=n, g=g, chunk=q, init=init,
               dtype=str(dtype).split(".")[-1],
               route=k6.route(dtype, p, n, q),
               max_abs_err=max(dy.max().item(), ds.max().item()),
               y_err=dy.max().item(), state_err=ds.max().item(), tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library=None,
               library_ms=None, bound_ms=b_ms, bound_us=b_ms * 1e3,
               bound_by=b_by,
               attained_tflops=flops / (kernel_ms * 1e-3) / 1e12,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms)
    emit(**row)
    return row


def moe_bound(e, c, k, n, dtype):
    """(least ms, what bounds it, bytes moved) of the grouped product (E,
    C, K) x (E, K, N): x and w read once and the output written once at
    the memory rate, or 2·E·C·K·N flops at the peak rate of the inputs'
    type (bf16 tensor cores, f32 CUDA cores), whichever takes longer."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (e * c * k + e * k * n + e * c * n) * size
    flops = 2.0 * e * c * k * n
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def check_moe(label, e, c, k, n, dtype, reps=50):
    """K5 against its plain version (the float32 einsum, rounded once) on
    the card, within tests/test_kernels.py's tolerances (|err| <= tol +
    tol·|plain|, 1e-4 f32, 2e-1 bf16). In bf16 also the largest difference
    in ulps of the plain value, over all elements and over those at least
    1% of max|plain|, and the share of elements more than one ulp off:
    both sum in float32 and round once, so one ulp is expected where the
    sum is not a near-cancellation (there the float32 sums' own difference
    is many ulps of a tiny result). The library yardstick is
    ``torch.bmm`` at the same shape. Returns the numbers."""
    g = torch.Generator(device="cuda").manual_seed(e * 7919 + c + k + n)
    x = torch.randn(e, c, k, device="cuda", generator=g).to(dtype)
    w = torch.randn(e, k, n, device="cuda", generator=g).to(dtype)
    got = k5.moe_gemm(x, w)
    want = k5.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    assert got.shape == (e, c, n) and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-1
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        label, e, c, k, n, dtype, err)
    ulps = {}
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7)
        in_ulps = diff / ulp
        big = want.float().abs() >= 0.01 * want.float().abs().max()
        ulps = dict(max_ulps=in_ulps.max().item(),
                    max_ulps_above_1pct=in_ulps[big].max().item(),
                    share_over_1_ulp=(in_ulps > 1).float().mean().item())
    kernel_ms, kernel_call_ms = time_ms(lambda: k5.moe_gemm(x, w), reps)
    plain_ms, plain_call_ms = time_ms(lambda: k5.moe_gemm_ref(x, w),
                                      max(reps // 5, 2))
    library_ms, library_call_ms = time_ms(lambda: torch.bmm(x, w), reps)
    b_ms, b_by, nbytes = moe_bound(e, c, k, n, dtype)
    row = dict(phase="kernel_check", kernel="moe_gemm", case=label, e=e,
               c=c, k=k, n=n, dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, **ulps, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library="torch.bmm", library_ms=library_ms,
               bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
               attained_tflops=2.0 * e * c * k * n / (kernel_ms * 1e-3)
               / 1e12,
               attained_gbps=nbytes / (kernel_ms * 1e-3) / 1e9,
               kernel_call_ms=kernel_call_ms, plain_call_ms=plain_call_ms,
               library_call_ms=library_call_ms)
    emit(**row)
    return row


def reset_launches():
    for fn in LAUNCH_COUNTERS.values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in LAUNCH_COUNTERS.items()}


def only(**counts):
    """Launch counts of every kernel: those given, 0 for the rest."""
    return {k: counts.get(k, 0) for k in LAUNCH_COUNTERS}


def round_phases(server, t):
    """Round ``t`` split into its phases (host clock, the GPU synchronised
    after each). The detector's validation eval runs inside the cohort
    engine; it is timed there and reported apart from training."""
    phases = {}
    inner = server._eval_validation

    def timed_validation(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)       # numpy: the GPU work is done
        if out is not None:
            phases["validation_eval_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    server._eval_validation = timed_validation
    t0 = time.perf_counter()
    values, sched, sel, forced = server._schedule_round(t)
    phases["schedule_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    uploads, weights, acc_local, acc_test, acc_val = server._train_cohort(
        sel, t)
    torch.cuda.synchronize()
    phases["train_and_eval_uploads_ms"] = (
        (time.perf_counter() - t0) * 1e3 - phases.get("validation_eval_ms",
                                                      0.0))
    t0 = time.perf_counter()
    server._aggregate_uploads(sel, uploads, weights)
    torch.cuda.synchronize()
    phases["aggregate_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    g_acc, g_loss, src_acc, atk_succ = server._global_metrics()
    phases["global_eval_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    server._finalize_round(t, values, sched, sel, forced, acc_local,
                           acc_test, g_acc, src_acc, atk_succ, acc_val,
                           g_loss)
    phases["finalize_ms"] = (time.perf_counter() - t0) * 1e3
    del server._eval_validation
    return phases


def profile_round(server, t):
    """One round under torch.profiler: wall, device busy time, idle share,
    the device time of K1, K2 and K3 (and K3's share of the busy time),
    the top kernels by name."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_us(prof)
    busy_us = sum(by_kernel.values())
    flash_us = sum(v for k, v in by_kernel.items()
                   if "flash_f32_kernel" in k or "flash_bf16_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(round=t, wall_us=wall_us, device_busy_us=busy_us,
                device_idle_share=1.0 - busy_us / wall_us,
                n_device_events=sum(1 for ev in prof.events()
                                    if ev.device_type
                                    == torch.autograd.DeviceType.CUDA),
                agg_kernel_us=sum(v for k, v in by_kernel.items()
                                  if "agg_kernel" in k),
                robust_kernel_us=sum(v for k, v in by_kernel.items()
                                     if "robust_kernel" in k),
                flash_kernel_us=flash_us,
                flash_kernel_share=flash_us / busy_us,
                top_kernels_us=[[k[:80], v] for k, v in top])


class TimedServer(FeelServer):
    """A FeelServer that records each round's wall time (ending in a GPU
    synchronise), each round's kernel launches, and itself, so a path
    driven through ``run_experiment`` can still be read round by round."""
    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.round_ms = []
        self.round_launches = []
        TimedServer.made.append(self)

    def run_round(self, t):
        before = read_launches()
        t0 = time.perf_counter()
        log = super().run_round(t)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.round_ms.append((time.perf_counter() - t0) * 1e3)
        self.round_launches.append({k: v - before[k] for k, v in
                                    read_launches().items()})
        return log


def experiment(**kw):
    """``simulation.run_experiment(**kw)`` -> (result dict, its server)."""
    real, simulation.FeelServer = simulation.FeelServer, TimedServer
    try:
        out = simulation.run_experiment(**kw)
    finally:
        simulation.FeelServer = real
    return out, TimedServer.made[-1]


def defended_run(label, **kw):
    """One defended §V-scale run through run_experiment on the GPU with
    every launch count set to 0 just before and read just after."""
    reset_launches()
    out, server = experiment(
        cfg=FeelConfig(n_ues=50, n_malicious=5), n_train=50_000,
        n_test=10_000, policy="dqs", engine="vectorized", control="host",
        device="cuda", rounds=3, seed=0, **kw)
    launches = read_launches()
    for t, log in enumerate(server.logs):
        emit(phase="defended_path", run=label, round=t,
             wall_ms=server.round_ms[t], acc=log.global_acc,
             n_selected=int(log.selected.size),
             n_malicious_selected=int(log.n_malicious_selected),
             n_rejected=log.n_rejected, n_flagged=log.n_flagged,
             det_precision=log.det_precision, det_recall=log.det_recall,
             rep_gap=log.rep_gap, agg_rows=pad_count(int(log.selected.size)))
    emit(phase="defended_path_launches", run=label, launches=launches,
         scenario=out["scenario"], defense=out["defense"])
    assert launches == only(robust_aggregate=3), (label, launches)
    assert all(np.isfinite(out["acc"])), out["acc"]
    return out, server


def lm_run(policy, shapes=None):
    """The LM path through run_experiment on the GPU (examples/
    federated_llm.py's regime) with every launch count set to 0 just
    before and read just after. ``shapes`` (a Counter) records the q shape
    of every K3 launch."""
    real = k3._kernel

    def recording(q, *args):
        shapes[tuple(q.shape)] += 1
        return real(q, *args)

    if shapes is not None:
        k3._kernel = recording
    reset_launches()
    try:
        out, server = experiment(
            cfg=FeelConfig(**LM_CFG), scenario=COLLAPSE, task="lm_tiny",
            n_train=2000, n_test=400, policy=policy, engine="vectorized",
            control="host", device="cuda", rounds=3, seed=0)
    finally:
        k3._kernel = real
    launches = read_launches()
    for t, log in enumerate(server.logs):
        emit(phase="lm_path", policy=policy, round=t,
             wall_ms=server.round_ms[t], loss=log.global_loss,
             acc=log.global_acc, n_selected=int(log.selected.size),
             n_malicious_selected=int(log.n_malicious_selected),
             attack_success=log.attack_success,
             launches=server.round_launches[t],
             selected=log.selected.tolist())
    emit(phase="lm_path_launches", policy=policy, launches=launches)
    assert all(np.isfinite(out["loss"])) and all(np.isfinite(out["acc"]))
    return out, server


def lm_phases():
    """The LM path on the GPU: the DQS run (K3 launched in every round, K1
    once a round), random scheduling beside it, one round split into
    phases and one profiled, K3 at the shape the run launched it at most,
    and a K = 8 run on the GPU and the CPU. Returns (K3's launches in the
    DQS run, K3's numbers at that shape)."""
    shapes = collections.Counter()
    lm_dqs, server_lm = lm_run("dqs", shapes)
    for t, got in enumerate(server_lm.round_launches):
        assert got == only(flash_attention=got["flash_attention"],
                           weighted_aggregate=1) \
            and got["flash_attention"] > 0, (t, got)
    k3_launches = read_launches()["flash_attention"]
    emit(phase="lm_k3_shapes", launches_by_shape=sorted(
        ([list(k), n] for k, n in shapes.items()), key=lambda x: -x[1]))
    lm_random, _ = lm_run("random")
    emit(phase="lm_dqs_vs_random", dqs_loss=lm_dqs["loss"],
         random_loss=lm_random["loss"], dqs_acc=lm_dqs["acc"],
         random_acc=lm_random["acc"],
         dqs_malicious_selected=lm_dqs["malicious_selected"],
         random_malicious_selected=lm_random["malicious_selected"])
    emit(phase="round_phases", run="lm", round=3,
         **round_phases(server_lm, 3))
    row = profile_round(server_lm, 4)
    emit(phase="profile_round", run="lm", **row)
    # every attention forward of the round is K3's: a renamed kernel fails
    assert row["flash_kernel_us"] > 0, row
    (b, h, s_, d), _ = shapes.most_common(1)[0]
    k3_row = check_flash(b, h, s_, s_, d, True, None, torch.float32,
                         "LM path's most launched")

    # the LM path on the GPU and on the CPU, K = 8
    lm_small = {dev: experiment(
        cfg=FeelConfig(n_ues=8, n_malicious=2), scenario="token_flip_1to5",
        task="lm_tiny", n_train=960, n_test=240, rounds=2,
        device=dev)[1].logs for dev in ("cuda", "cpu")}
    for a, b_ in zip(lm_small["cuda"], lm_small["cpu"]):
        assert np.array_equal(a.selected, b_.selected), (a.selected,
                                                         b_.selected)
        assert abs(a.global_loss - b_.global_loss) <= 1e-3, (
            a.global_loss, b_.global_loss)
        assert abs(a.global_acc - b_.global_acc) <= 1e-3, (a.global_acc,
                                                           b_.global_acc)
        emit(phase="cuda_vs_cpu", run="lm_tiny token_flip_1to5",
             round=a.round, loss_cuda=a.global_loss, loss_cpu=b_.global_loss,
             acc_cuda=a.global_acc, acc_cpu=b_.global_acc,
             selected=a.selected.tolist())

    return k3_launches, k3_row


# ---------------------------------------------------------------------- #
# Serving the decoder-only zoo
# ---------------------------------------------------------------------- #
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
N_COMPARED = 8          # decode steps whose greedy tokens are compared
# check 1: max|Δ logit| over max|plain logit|, and a near tie in bf16 ulps
# of the top logit; the sound runs read at most 0.032 and 4 ulps, the
# negative controls at least 0.70 and 107 ulps (PERF.md; H100 80GB HBM3,
# 700 W)
LOGIT_TOL = 0.06
TIE_ULPS = 8
# check 1 of the MoE path: every MoE layer's output with K5 against the
# same layer with K5's plain version on the same input, max|Δ| over
# max|plain|; the sound calls read at most 0.0108, the negative control's
# at least 0.967 (PERF.md; H100 80GB HBM3, 700 W)
MOE_LAYER_TOL = 0.05


def prompts(cfg, b, s, seed=0):
    """b prompts of s tokens on the card: consecutive windows of the port's
    token stream (``data/tokens.make_stream``) over the config's
    vocabulary."""
    stream = make_stream(b * s, cfg.vocab_size, seed=seed)
    return torch.from_numpy(stream.astype(np.int64).reshape(b, s)).cuda()


def _k4_control(q, k, v, n):
    """K4's plain version with the wrong GQA grouping: query head h reads
    KV head h % Hkv instead of h // G."""
    g = q.shape[1] // k.shape[2]
    return k4.decode_attention_ref(q, k.repeat(1, 1, g, 1),
                                   v.repeat(1, 1, g, 1), n)


def _k6_control(x, dt, A, B_, C_, q, s0):
    """K6's plain version with the inter-chunk term dropped: every chunk
    starts from the initial state instead of the one carried from the
    chunk before."""
    ys, state = [], s0
    for c in range(0, x.shape[1], q):
        sl = slice(c, c + q)
        y, state = k6.ssd_scan_ref(x[:, sl], dt[:, sl], A, B_[:, sl],
                                   C_[:, sl], chunk=q, initial_state=s0)
        ys.append(y)
    return torch.cat(ys, 1), state


def _k5_control(x, w):
    """K5's plain version with the experts' weights rolled by one along E:
    expert e's slots meet expert e - 1's weights."""
    return k5.moe_gemm_ref(x, w.roll(1, 0))


@contextlib.contextmanager
def plain_route(module, control=False):
    """Within the block, the wrapper of ``module`` (K4, K5 or K6) runs its
    plain version on CUDA tensors, for check 1 of the serving phases; with
    ``control``, a deliberately wrong one (``_k4_control``,
    ``_k5_control``, ``_k6_control``), the negative control that check 1
    must reject. Nothing else in the script or the port routes a CUDA
    tensor so."""
    real = module._kernel
    if module is k4:
        module._kernel = _k4_control if control else (
            lambda q, k, v, n: k4.decode_attention_ref(q, k, v, n))
    elif module is k5:
        module._kernel = _k5_control if control else k5.moe_gemm_ref
    else:
        module._kernel = _k6_control if control else (
            lambda x, dt, A, B_, C_, q, s0: k6.ssd_scan_ref(
                x, dt, A, B_, C_, chunk=q, initial_state=s0))
    try:
        yield
    finally:
        module._kernel = real


def profile_fn(fn):
    """``fn()`` once under torch.profiler: (its result, wall us, device
    busy us, idle share, device events, top kernels by device time)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_us(prof)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # host calls that wait for the card (a synchronise, a blocking copy, a
    # tensor read into a Python number); the closing synchronise above and
    # the profiler's own are two of them
    waits = collections.Counter(
        ev.name for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CPU
        and ("Synchronize" in ev.name or ev.name in (
            "cudaMemcpy", "aten::item", "aten::_local_scalar_dense")))
    return out, dict(wall_us=wall_us, device_busy_us=busy_us,
                     host_waits=dict(waits),
                     device_idle_share=1.0 - busy_us / wall_us,
                     n_device_events=sum(
                         1 for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA),
                     top_kernels_us=[[k[:80], v] for k, v in top])


def greedy_decode(decode, params, cache, first, n, profile_at=None):
    """n greedy decode steps from ``cache`` starting with token ``first``
    (B, 1): (the tokens fed (B, n), the logits (n, B, V), each step's ms —
    host clock ending in a synchronise — the profile of step
    ``profile_at``, whose time is left out of the list, and the cache)."""
    tok, fed, logits_all, step_ms, prof = first, [], [], [], None
    for i in range(n):
        fed.append(tok)
        if i == profile_at:
            (logits, cache), prof = profile_fn(
                lambda: decode(params, cache, tok))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        logits_all.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.cat(fed, 1), torch.stack(logits_all), step_ms, prof, cache


def forced_decode(decode, params, cache, fed):
    """Decode the tokens ``fed`` (B, n) one step each: the logits (n, B,
    V)."""
    out = []
    for i in range(fed.shape[1]):
        logits, cache = decode(params, cache, fed[:, i:i + 1])
        out.append(logits)
    return torch.stack(out)


def logit_gap(label, got, want, phase="plain_check", tol=LOGIT_TOL):
    """The logits (n, B, V) of a run against the plain run's: max|Δ|, as
    a share of max|plain| too, and the root-mean-square Δ over that of the
    plain logits; and the greedy tokens of the first ``N_COMPARED`` steps,
    where a differing token is a near tie if the plain run's token is
    within ``TIE_ULPS`` bf16 ulps of the run's top logit. Emits the row
    and returns it."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    diff = got - want
    err = diff.abs().max().item()
    tk, tp = got.argmax(-1)[:N_COMPARED], want.argmax(-1)[:N_COMPARED]
    top = got[:N_COMPARED].max(-1).values
    at_plain = got[:N_COMPARED].gather(-1, tp[..., None])[..., 0]
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    gap_ulps = (top - at_plain) / ulp
    differ = tk != tp
    tie = gap_ulps <= TIE_ULPS
    row = dict(phase=phase, run=label, max_abs_err=err,
               rel_max_err=err / scale,
               rel_rms_err=(diff.norm() / want.norm()).item(),
               max_abs_logit=scale, tol=tol * scale,
               tokens_compared=tk.numel(),
               tokens_equal=int((~differ).sum()),
               near_ties=int((differ & tie).sum()),
               tokens_differ_outside_tie=int((differ & ~tie).sum()),
               max_gap_ulps_of_differing=gap_ulps[differ].max().item()
               if bool(differ.any()) else 0.0)
    emit(**row)
    return row


def check1_passes(row):
    """Check 1 of a serving phase: max|Δ| <= ``LOGIT_TOL``·max|plain| and
    no greedy token differs outside a near tie."""
    return (row["max_abs_err"] <= row["tol"]
            and row["tokens_differ_outside_tie"] == 0)


def compare_logits(label, got, want, tol=LOGIT_TOL):
    """Check 1 on the kernel run's logits against the plain run's.

    The kernel and its plain version agree within their own tolerances
    (phase 3), but each rounds its bf16 output in other places, and 40–48
    bf16 layers carry that into every logit. ``LOGIT_TOL`` lies between
    the sound runs' reading and that of the negative control
    (``plain_route(control=True)``), which the serving phases run beside
    check 1 and which check 1 must reject; PERF.md keeps both readings."""
    row = logit_gap(label, got, want, tol=tol)
    assert check1_passes(row), row
    return row


def expected_launches(cfg, steps):
    """The kernel launches of a prefill and ``steps`` decode steps of
    ``cfg``: K3 at every attention layer's prefill, K6 at every SSM
    layer's, K4 at every attention layer a step, K5 three times (gate, up,
    down) at every MoE layer of the prefill and of every step."""
    pattern, nb = cfg.block_pattern(), cfg.n_blocks
    n_attn = nb * sum(k["mixer"] == "attn" for k in pattern)
    n_ssm = nb * sum(k["mixer"] == "ssm" for k in pattern)
    n_moe = nb * sum(k["mlp"] == "moe" for k in pattern)
    return only(flash_attention=n_attn, ssd_scan=n_ssm,
                decode_attention=n_attn * steps,
                moe_gemm=3 * n_moe * (1 + steps))


def serve_phase(arch):
    """The serving main path of ``arch`` at full width: weights drawn on
    the card (seed 0), 8 prompts of 2,048 tokens through ``api.prefill``
    (target 2,080) and 32 greedy ``api.decode_step`` calls, every launch count
    set to 0 just before and read just after; one decode step profiled;
    then check 1, the same run with a kernel's plain version (K4's, K6's,
    or for a MoE K5's: ``moe_check1``), and its negative control. Returns
    the main run's launches."""
    cfg = registry.get(arch)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    target = SERVE_PROMPT + SERVE_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    tok = prompts(cfg, SERVE_BATCH, SERVE_PROMPT)
    batch = {"tokens": tok}
    with torch.inference_mode():
        prefill(params, batch, target)              # warm-up, not counted
        # not counted either: one prefill under the profiler, for the
        # device's busy share and the prefill's time by kernel
        out, prefill_prof = profile_fn(
            lambda: prefill(params, batch, target))
        del out
        emit(phase="serve_prefill_profile", arch=arch, **prefill_prof)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, target)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        at_prefill = read_launches()
        cache0 = ({k: v.clone() if torch.is_tensor(v) else v
                   for k, v in cache.items()}
                  if cfg.family == "dense" else None)
        first = logits.argmax(-1)[:, None]
        fed, step_logits, step_ms, prof, cache = greedy_decode(
            decode, params, cache, first, SERVE_NEW,
            profile_at=SERVE_NEW // 2)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert logits.shape == (SERVE_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert bool(torch.isfinite(step_logits).all())
        assert cache["index"] == target
        del cache
        steady = sorted(step_ms[1:])
        decode_ms = steady[len(steady) // 2]
        emit(phase="serve", arch=arch, n_layers=cfg.n_layers,
             dtype=cfg.dtype, n_params=n_params, init_s=init_s,
             batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
             prefill_ms=prefill_ms,
             prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT
             / (prefill_ms / 1e3),
             decode_ms_per_step_median=decode_ms,
             decode_ms_first=step_ms[0], decode_ms_max=max(step_ms[1:]),
             decode_tokens_per_s=SERVE_BATCH * len(step_ms)
             / (sum(step_ms) / 1e3),
             peak_memory_gb=peak_gb, launches_at_prefill=at_prefill,
             launches=launches,
             greedy_tokens_row0=torch.cat([fed[0], step_logits[-1].argmax(
                 -1)[:1]]).tolist())
        emit(phase="serve_profile", arch=arch, step=SERVE_NEW // 2, **prof)
        assert at_prefill == expected_launches(cfg, 0), at_prefill
        assert launches == expected_launches(cfg, SERVE_NEW), launches

        if cfg.family == "moe":
            moe_check1(arch, cfg, prefill, decode, params, batch, target,
                       logits, fed, step_logits)
            del params
            torch.cuda.empty_cache()
            return launches
        # check 1: the same decode (and, for the SSM, the prefill) with the
        # mixer kernel's plain version; then its negative control, the
        # first N_COMPARED steps with a wrong plain version, which check 1
        # must reject
        module = k6 if cfg.family == "ssm" else k4
        with plain_route(module):
            if cfg.family == "ssm":
                logits_p, cache0 = prefill(params, batch, target)
                compare_logits(arch + " prefill", logits[None],
                               logits_p[None])
            cache_c = {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in cache0.items()}
            plain_logits = forced_decode(decode, params, cache0, fed)
        compare_logits(arch + " decode", step_logits, plain_logits)
        del cache0
        with plain_route(module, control=True):
            if cfg.family == "ssm":
                del cache_c
                _, cache_c = prefill(params, batch, target)
            control_logits = forced_decode(decode, params, cache_c,
                                           fed[:, :N_COMPARED])
        control = logit_gap(arch + " decode, negative control",
                            control_logits, plain_logits[:N_COMPARED],
                            phase="control_check")
        assert not check1_passes(control), control
    del params, cache_c
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def moe_layers(check=False):
    """Within the block, every MoE layer call appends to the list it
    yields its tokens' top-k expert sets (ascending expert ids, (T, K); the
    router's softmax and top-k computed again on the layer's input) and,
    with ``check``, the layer's output computed twice more on the same
    input — with K5's plain version and with the negative control
    (``_k5_control``) — as max|Δ| over max|plain| of the layer's own
    output and the control's. The layer's own output is returned, so the
    run goes on as it would. For check 1 of the MoE path only, never
    timed."""
    rows = []
    real = blocks.moe_apply

    def recording(cfg, p, x, with_aux=True):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"], dim=-1)
        row = dict(routes=torch.topk(probs, cfg.moe.top_k, dim=-1)
                   .indices.sort(-1).values)
        y, aux = real(cfg, p, x, with_aux=with_aux)
        if check:
            outs = []
            for control in (False, True):
                with plain_route(k5, control=control):
                    outs.append(real(cfg, p, x, with_aux=False)[0].float())
            scale = outs[0].abs().max()
            row.update(gap=(y.float() - outs[0]).abs().max() / scale,
                       control_gap=(outs[1] - outs[0]).abs().max() / scale)
        rows.append(row)
        return y, aux

    blocks.moe_apply = recording
    try:
        yield rows
    finally:
        blocks.moe_apply = real


def moe_check1(arch, cfg, prefill, decode, params, batch, target, logits,
               fed, step_logits):
    """Check 1 of the MoE path.

    The kernel run is repeated with every MoE layer checked on its own
    input (``moe_layers(check=True)``): at prefill and at every decode
    step, the layer with K5 against the layer with K5's plain version, max
    |Δ| within ``MOE_LAYER_TOL`` of max|plain| at every call, and the
    negative control, K5's plain version with the experts rolled by one,
    rejected at every call. The repeated run's logits must be the main
    run's bit for bit (the dispatch and its combine have a fixed order);
    its routes give the share of routes dropped at prefill.

    Then the whole run with K5's plain version, end to end: its logit gap
    and the (layer, token) expert sets that differ from the kernel run's
    are reported, not held to a tolerance. A near tie of the router, moved
    by one bf16 ulp upstream, sends a token to another expert; with the
    reference's draw (σ = 1/√E experts, ROADMAP R4) that moves the token's
    state far, attention spreads it, and the sound end-to-end gap reads as
    large as that of the rolled-experts control (PERF.md), so only the
    layer-wise check decides."""
    E, K = cfg.moe.n_routed, cfg.moe.top_k
    with moe_layers(check=True) as kernel_rows:
        logits_k, cache_k = prefill(params, batch, target)
        n_pre = len(kernel_rows)
        rerun = forced_decode(decode, params, cache_k, fed)
    del cache_k
    rerun_gap = max((logits_k - logits).abs().max().item(),
                    (rerun - step_logits).abs().max().item())
    T = SERVE_BATCH * SERVE_PROMPT
    C = tmoe.capacity(T, cfg)
    dropped = [int((torch.bincount(r["routes"].reshape(-1), minlength=E)
                    - C).clamp_min(0).sum()) for r in kernel_rows[:n_pre]]
    emit(phase="moe_prefill_drops", arch=arch, tokens=T, top_k=K,
         capacity=C, slots=E * C, routes=T * K,
         dropped_share=sum(dropped) / (n_pre * T * K),
         dropped_share_by_layer=[d / (T * K) for d in dropped])
    gaps = [r["gap"].item() for r in kernel_rows]
    controls = [r["control_gap"].item() for r in kernel_rows]
    layer = dict(phase="moe_layer_check", arch=arch, calls=len(gaps),
                 prefill_calls=n_pre, tol=MOE_LAYER_TOL,
                 max_gap_prefill=max(gaps[:n_pre]),
                 max_gap_decode=max(gaps[n_pre:]),
                 min_control_gap_prefill=min(controls[:n_pre]),
                 min_control_gap_decode=min(controls[n_pre:]),
                 max_control_gap=max(controls),
                 kernel_rerun_max_abs_diff=rerun_gap)
    emit(**layer)
    assert rerun_gap == 0.0, rerun_gap
    assert max(gaps) <= MOE_LAYER_TOL, layer
    assert min(controls) > MOE_LAYER_TOL, layer

    with plain_route(k5), moe_layers() as plain_rows:
        logits_p, cache_p = prefill(params, batch, target)
        plain_logits = forced_decode(decode, params, cache_p, fed)
    del cache_p
    differ = [int((a["routes"] != b["routes"]).any(-1).sum())
              for a, b in zip(kernel_rows, plain_rows)]
    emit(phase="moe_route_check", arch=arch, prefill_sets=n_pre * T,
         prefill_sets_differ=sum(differ[:n_pre]),
         decode_sets=(len(differ) - n_pre) * SERVE_BATCH,
         decode_sets_differ=sum(differ[n_pre:]),
         prefill_sets_differ_by_layer=differ[:n_pre])
    logit_gap(arch + " prefill, end to end", logits[None], logits_p[None],
              phase="plain_check_end_to_end")
    logit_gap(arch + " decode, end to end", step_logits, plain_logits,
              phase="plain_check_end_to_end")


def consistency_phase(arch):
    """Check 2: full width at 2 layers in float32 — prefill of 24 tokens
    plus 8 decode steps reproduce ``lm_forward``'s logits within
    1e-3·max|logit| + 1e-3 (tests/test_decode_consistency.py's property,
    on the card), a MoE at capacity factor 8.0, as that test sets it, so
    that no token is dropped."""
    cfg = dataclasses.replace(registry.get(arch), n_layers=2,
                              dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    params = api.init(cfg, 1)
    tok = prompts(cfg, 2, 32, seed=1)
    with torch.inference_mode():
        full = tf.lm_forward(cfg, params, tok, window=cfg.sliding_window)
        logits, cache = api.prefill(cfg, params, {"tokens": tok[:, :24]},
                                    target_len=32)
        errs = [(logits - full[:, 23]).abs().max().item()]
        for t in range(24, 32):
            logits, cache = api.decode_step(cfg, params, cache,
                                            tok[:, t:t + 1])
            errs.append((logits - full[:, t]).abs().max().item())
    tol = 1e-3 * full.abs().max().item() + 1e-3
    emit(phase="prefill_decode_vs_forward", arch=arch, n_layers=2,
         dtype="float32", max_abs_err=max(errs), tol=tol, errs=errs)
    assert max(errs) <= tol, (arch, errs, tol)
    del params
    torch.cuda.empty_cache()


def zoo_cuda_vs_cpu():
    """Reduced float32 configs on the GPU and the CPU from the same
    weights: starcoder2 decoding 48 tokens from scratch through its ring
    cache (window 16); greedy generation (8 prompt tokens, 7 new; 32 prompt
    tokens, one chunk, where there are SSM layers) of qwen2.5, mamba2,
    qwen2-moe (also ``optimized``: group-local dispatch in 2 groups at
    prefill), moonshot and the Jamba hybrid. The same tokens, logits
    within 1e-4; every greedy GPU run launches what
    ``expected_launches`` says (the Jamba run K3, K4, K5 and K6)."""
    runs = [("starcoder2-15b", "ring", False), ("qwen2.5-32b", "greedy", False),
            ("mamba2-370m", "greedy", False),
            ("qwen2-moe-a2.7b", "greedy", False),
            ("qwen2-moe-a2.7b", "greedy", True),
            ("moonshot-v1-16b-a3b", "greedy", False),
            ("jamba-1.5-large-398b", "greedy", False)]
    for arch, mode, optimized in runs:
        cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                                  dtype="float32")
        if optimized:
            cfg = registry.optimized(cfg, 2)
        host = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(4)
        n_prompt = 32 if cfg.ssm is not None else 8
        toks = rng.integers(0, cfg.vocab_size, (1 if mode == "ring" else 2,
                                                48 if mode == "ring"
                                                else n_prompt))
        out = {}
        for dev in ("cuda", "cpu"):
            params = {k: v.to(dev) for k, v in host.items()}
            tt = torch.from_numpy(toks).to(dev)
            decode = steps.make_decode_step(cfg)
            reset_launches()
            with torch.inference_mode():
                if mode == "ring":
                    cache = api.cache_init(cfg, 1, 48, device=dev)
                    assert "slot_pos" in cache
                    logits = forced_decode(decode, params, cache, tt)
                    tokens = logits.argmax(-1)
                else:
                    first, cache = api.prefill(cfg, params, {"tokens": tt},
                                               target_len=n_prompt + 8)
                    fed, logits, _, _, _ = greedy_decode(
                        decode, params, cache, first.argmax(-1)[:, None], 7)
                    tokens = torch.cat([fed, logits[-1].argmax(-1)[:, None]],
                                       1)
            launches = read_launches()
            out[dev] = (tokens.cpu(), logits.float().cpu(), launches)
        err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
        label = f"{arch} reduced {mode}" + (", optimized" if optimized
                                            else "")
        emit(phase="cuda_vs_cpu", run=label, tokens=out["cuda"][0].tolist(),
             max_abs_logit_err=err, launches=out["cuda"][2])
        assert torch.equal(out["cuda"][0], out["cpu"][0]), (arch, out)
        assert err <= 1e-4, (arch, err)
        assert out["cpu"][2] == only(), out["cpu"][2]
        if mode == "greedy":
            assert out["cuda"][2] == expected_launches(cfg, 7), (
                label, out["cuda"][2])


def zoo_phases():
    """The serving path of the zoo: starcoder2-15b (dense, K3 at prefill,
    K4 at every decode step) and mamba2-370m (SSM, K6 at every prefill)
    at full width with checks 1 and 2, then qwen2-moe-a2.7b (K3, K4 and
    K5 at prefill and every decode step) likewise, then GPU against CPU.
    Returns the main-path launches of K4, K5 and K6 in their serving
    runs."""
    dense = serve_phase("starcoder2-15b")
    consistency_phase("starcoder2-15b")
    ssm = serve_phase("mamba2-370m")
    consistency_phase("mamba2-370m")
    moe = serve_phase("qwen2-moe-a2.7b")
    consistency_phase("qwen2-moe-a2.7b")
    zoo_cuda_vs_cpu()
    return (dense["decode_attention"], moe["moe_gemm"], ssm["ssd_scan"])


def quickstart(n_ues, n_malicious, n_train, n_test, device, seed=0):
    cfg = FeelConfig(n_ues=n_ues, n_malicious=n_malicious)
    train, test = generate(n_train, n_test, seed=seed)
    rng = np.random.default_rng(seed)
    mal = pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
    clients = partition(train, cfg.n_ues, rng, mal,
                        LabelFlipAttack(*EASY_PAIR))
    return FeelServer(cfg, clients, test, rng, policy="dqs",
                      engine="vectorized", control="host", device=device)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    emit(phase="device", gpu=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=platform.python_version())

    # 2. build every kernel from source
    assert set(KERNELS) == set(build.KERNELS), (KERNELS, build.KERNELS)
    t0 = time.perf_counter()
    logs = build.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         built=sorted(logs), ptxas={k: ptxas_summary(v)
                                    for k, v in logs.items()})
    # what the bf16 routes were compiled to: K3 on mma.sync (HMMA, fed by
    # ldmatrix), K5's prefill route on wgmma (HGMMA) fed by TMA tensor loads
    # (UTMALDG), K4's tensor-core route on mma.sync fed by cp.async
    # (LDGSTS), K6's chunk states and chunk scan on mma.sync
    sass = {name: sass_ops(name) for name in (
        "flash_attention", "moe_gemm", "decode_attention", "ssd_scan",
        "robust_aggregate")}
    emit(phase="sass", **sass)
    # K2 sorts each column in registers: no instance up to 64 rows may
    # touch shared or local memory; each instance's registers and spills
    k2_ptxas = ptxas_summary(logs.get("robust_aggregate", ""))
    k2 = {}
    for c in SIZE_CLASSES:
        name = f"robust_kernel<{c}>"
        ops = sass["robust_aggregate"][name]
        k2[name] = dict(ptxas=k2_ptxas.get(name), **{
            op: ops[op] for op in ("LDS", "STS", "LDL", "STL")})
        if c <= 64:
            assert not any(ops[op] for op in ("LDS", "STS", "LDL", "STL")), (
                name, ops)
    emit(phase="k2_instances", **k2)
    # every expected kernel must be found by name, so a renamed one fails
    for d in k3.HEAD_DIMS:
        ops = sass["flash_attention"][f"flash_bf16_kernel<{d}>"]
        assert ops["HMMA"] > 0, (d, ops)
    ops = sass["moe_gemm"]["moe_gemm_wgmma_kernel"]
    assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, ops
    for d in k4.HEAD_DIMS:
        ops = sass["decode_attention"][f"decode_mma_kernel<{d}>"]
        assert ops["HMMA"] > 0 and ops["LDGSTS"] > 0, (d, ops)
    for p in k6.MMA_HEAD_DIMS:
        for kernel in ("ssd_state_kernel", "ssd_chunk_scan_kernel"):
            ops = sass["ssd_scan"][f"{kernel}<{p}>"]
            assert ops["HMMA"] > 0, (kernel, p, ops)

    # 3. kernels against their plain versions
    for n in (8, 32, 56):
        check_aggregate(n, M_MLP, torch.float32, "main")
    check_aggregate(1, 1, torch.float32, "ragged", assume_normalized=False)
    check_aggregate(7, 4097, torch.float32, "ragged",
                    assume_normalized=False)
    check_aggregate(5, M_MLP + 1, torch.float32, "ragged odd M")
    check_aggregate(32, M_MLP, torch.float32, "misaligned",
                    misaligned=True)
    check_aggregate(32, M_MLP, torch.bfloat16, "bf16")
    check_aggregate(16, 1 << 16, torch.bfloat16, "bf16 wide")
    check_aggregate(7, 4097, torch.bfloat16, "bf16 ragged",
                    assume_normalized=False)
    check_aggregate(64, 1 << 22, torch.float32, "bandwidth", reps=20)

    for rows, n, m, mode, dtype, label, opts in robust_cases():
        check_robust(rows, n, m, mode, dtype, label, **opts)

    f32, bf16 = torch.float32, torch.bfloat16

    # lm_tiny's training shapes (8 windows a client row, a bucket's rows
    # padded to 1, 2, 4, 8, 16 or 24) and its evaluation shape (16 client
    # rows x 400 windows); then tests/test_kernels.py's five shapes in
    # both types, a ragged S and a window without causal
    for b in (8, 32, 64, 128, 192, 6400):
        check_flash(b, 4, 32, 32, 16, True, None, f32,
                    "lm_tiny eval" if b == 6400 else "lm_tiny train")
    for dt in (f32, bf16):
        for b, h, s_, t_, d, causal, window, label in (
                (2, 4, 256, 256, 64, True, None, "causal"),
                (1, 2, 128, 256, 64, True, None, "right-aligned S < T"),
                (2, 2, 256, 256, 128, True, 64, "window 64, D 128"),
                (1, 1, 256, 256, 64, False, None, "bidirectional"),
                (1, 2, 512, 512, 64, True, None, "S = 512"),
                (3, 2, 37, 37, 16, True, None, "ragged S = 37"),
                (2, 2, 100, 130, 32, False, 17, "window, not causal")):
            check_flash(b, h, s_, t_, d, causal, window, dt, label, reps=50)
    # the bf16 tensor-core route at every head dim, a ragged S and T (S =
    # 100 right-aligned in T = 130), windowed and not, with grouped KV
    # heads; then f32 with grouped KV heads
    for d in k3.HEAD_DIMS:
        for causal, window in ((True, None), (True, 48), (False, 17)):
            check_flash(2, 6, 100, 130, d, causal, window, bf16,
                        "ragged T, GQA 6/2", reps=20, hkv=2)
    check_flash(2, 12, 100, 130, 64, True, None, f32, "GQA 12/4", reps=20,
                hkv=4)
    check_flash_grad(128, 4, 32, 16)
    check_flash_grad(4, 12, 64, 32, hkv=4)
    # K3 at starcoder2-15b's prefill shape (48 query heads over its 4 KV
    # heads, read in place) and at qwen2-moe-a2.7b's (16 heads, no GQA)
    check_flash(SERVE_BATCH, 48, SERVE_PROMPT, SERVE_PROMPT, 128, True, None,
                bf16, "starcoder2-15b prefill", reps=5, hkv=4)
    check_flash(SERVE_BATCH, 16, SERVE_PROMPT, SERVE_PROMPT, 128, True, None,
                bf16, "qwen2-moe-a2.7b prefill", reps=5)

    # K4: tests/test_kernels.py's three shapes in both types; the GQA
    # serving shape of starcoder2-15b (48 query, 4 KV heads, D 128, bf16,
    # a cache of 2,080) and qwen2-moe-a2.7b's (16 query and KV heads: one
    # query head a block, and B·Hkv, which sets the split count, 4x
    # starcoder2's) at the first, a middle and the last length; a window's
    # view in the middle of a linear cache; a ring's prefix
    for dt in (f32, bf16):
        for b, h, t_, d, length in ((2, 4, 512, 64, 300),
                                    (1, 8, 1024, 128, 1024),
                                    (4, 2, 256, 64, 1)):
            check_decode("tests/test_kernels.py", b, h, h, t_, d, length, dt)
    cap = SERVE_PROMPT + SERVE_NEW
    for length in (1, 2048, cap):
        check_decode("starcoder2-15b serving", SERVE_BATCH, 48, 4, cap, 128,
                     length, bf16)
        check_decode("qwen2-moe-a2.7b serving", SERVE_BATCH, 16, 16, cap,
                     128, length, bf16)
    check_decode("window 1,024 view of a linear cache", SERVE_BATCH, 48, 4,
                 cap, 128, 1024, bf16, lo=1024)
    check_decode("ring prefix (1,001 of 4,096 slots)", SERVE_BATCH, 48, 4,
                 4096, 128, 1001, bf16)
    # the tensor-core route at every group size of the zoo (qwen2-moe and
    # moonshot 1, qwen2.5 5, yi 7, chameleon and Jamba 8, starcoder2 12) and
    # every head dim, at a ragged length (237 of 300 slots: a split's last
    # 16-key step cut short)
    for d in k4.HEAD_DIMS:
        for g in (1, 5, 7, 8, 12):
            row = check_decode(f"G {g}, D {d}, ragged", 3, 2 * g, 2, 300,
                               d, 237, bf16, reps=20)
            assert row["route"] == "tensor_cores", row

    # K6: tests/test_kernels.py's three shapes (grouped B/C included);
    # mamba2-370m's prefill shape in bf16
    for b, length, h, p, n, g, chunk in ((2, 256, 4, 32, 16, 4, 64),
                                         (1, 128, 2, 64, 32, 1, 128),
                                         (1, 64, 8, 16, 8, 8, 16)):
        check_ssd("tests/test_kernels.py", b, length, h, p, n, g, chunk, f32)
    summary_k6 = check_ssd("mamba2-370m prefill", SERVE_BATCH, SERVE_PROMPT,
                           32, 64, 128, 1, 256, bf16, reps=10)
    # the tensor-core route: mamba2's shape from an initial state (the
    # decode cache's prefill continued), Jamba's grouping (8 B/C groups over
    # 64 heads, L cut to 1,024), chunks of 64 and 128; and a bf16 shape it
    # does not take (N 8: the CUDA-core kernel)
    check_ssd("mamba2-370m prefill, initial state", SERVE_BATCH,
              SERVE_PROMPT, 32, 64, 128, 1, 256, bf16, reps=10, init=True)
    check_ssd("Jamba grouping", 2, 1024, 64, 64, 128, 8, 256, bf16, reps=10)
    check_ssd("chunk 64", 2, 512, 8, 64, 128, 1, 64, bf16, reps=10)
    check_ssd("chunk 128, initial state", 2, 512, 8, 32, 64, 2, 128, bf16,
              reps=10, init=True)
    row = check_ssd("N 8 (the CUDA-core route)", 1, 128, 4, 32, 8, 1, 64,
                    bf16, reps=10)
    assert row["route"] == "cuda_cores", row
    assert summary_k6["route"] == "tensor_cores", summary_k6

    # K5: tests/test_kernels.py's three shapes in both types; ragged shapes
    # (qwen2-moe's prefill capacity C = 1,368 at small E; K and N off the
    # tiles); bf16 on either side of the launcher's C threshold (128: the
    # wgmma route at and above it, mma.sync below), N a multiple of its
    # 256-wide tile and not; qwen2-moe-a2.7b's serving shapes
    # (60 experts, d 2,048, f 1,408): the gate/up and down products at
    # prefill (C 1,368 for 8 x 2,048 tokens) and at a decode step (C 8)
    for dt in (f32, bf16):
        for e, c, k, n in ((4, 128, 256, 128), (8, 64, 128, 384),
                           (2, 256, 512, 256)):
            check_moe("tests/test_kernels.py", e, c, k, n, dt)
        for e, c, k, n in ((3, 1368, 200, 136), (2, 37, 100, 70),
                           (5, 8, 33, 65), (1, 1, 7, 1)):
            check_moe("ragged", e, c, k, n, dt)
    for c in (127, 128, 129):
        for n in (384, 512):
            check_moe("C threshold", 4, c, 264, n, bf16)
    e, d, f = 60, 2048, 1408
    c_pre = tmoe.capacity(SERVE_BATCH * SERVE_PROMPT,
                          registry.get("qwen2-moe-a2.7b"))
    check_moe("qwen2-moe prefill gate/up", e, c_pre, d, f, bf16, reps=10)
    check_moe("qwen2-moe prefill down", e, c_pre, f, d, bf16, reps=10)
    summary_k5 = check_moe("qwen2-moe decode gate/up", e, 8, d, f, bf16)
    check_moe("qwen2-moe decode down", e, 8, f, d, bf16)

    # 4. the undefended main path at the paper's §V scale
    reset_launches()
    server = quickstart(50, 5, 50_000, 10_000, "cuda")
    emit(phase="main_path_init",
         w1_sum=float(server.params["w1"].double().sum()),
         w1_head=server.params["w1"][0, :4].tolist())
    rounds = []
    for t in range(3):
        t0 = time.perf_counter()
        log = server.run_round(t)
        torch.cuda.synchronize()
        rounds.append(dict(
            round=t, acc=log.global_acc, n_selected=int(log.selected.size),
            n_malicious_selected=int(log.n_malicious_selected),
            agg_rows=pad_count(int(log.selected.size)),
            wall_ms=(time.perf_counter() - t0) * 1e3,
            selected=log.selected.tolist()))
        emit(phase="main_path", **rounds[-1])
    launches = read_launches()
    emit(phase="main_path_launches", launches=launches)
    assert launches == only(weighted_aggregate=3), launches
    accs = [r["acc"] for r in rounds]
    assert all(np.isfinite(accs)), accs
    assert accs[2] > accs[0], accs

    # not counted: one round split into its phases, then one round under
    # the profiler for the device's busy share and kernel time by name
    emit(phase="round_phases", run="main", round=3,
         **round_phases(server, 3))
    emit(phase="profile_round", run="main", **profile_round(server, 4))

    # the kernel at the main path's aggregation shape, for the summary
    n_main = max(r["agg_rows"] for r in rounds)
    summary = {"weighted_aggregate": check_aggregate(
        n_main, M_MLP, torch.float32, "main path rows")}

    # 5. the defended path at the same scale, through run_experiment
    out_a, server_a = defended_run(
        "a", scenario="sign_flip", defense="trimmed_mean+validation")
    launches["robust_aggregate"] = read_launches()["robust_aggregate"]
    emit(phase="round_phases", run="a", round=3,
         **round_phases(server_a, 3))
    emit(phase="profile_round", run="a", **profile_round(server_a, 4))
    n_a = max(int(log.selected.size) for log in server_a.logs[:3])
    summary["robust_aggregate"] = check_robust(
        pad_count(n_a), n_a, M_MLP, "trimmed_mean", f32, "run (a) rows")
    defended_run("b", scenario="noise_0.8", defense="median")

    # 6. K1's defended routes
    for defense in ("norm_clip", "krum", "validation"):
        reset_launches()
        out, _ = experiment(
            cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000,
            n_test=500, scenario="sign_flip", defense=defense, rounds=2,
            device="cuda")
        got = read_launches()
        emit(phase="k1_defended_route", defense=defense, launches=got,
             acc=out["acc"], n_clipped=out["n_clipped"],
             n_rejected=out["n_rejected"], n_flagged=out["n_flagged"])
        assert got == only(weighted_aggregate=2), (defense, got)
    # the loop engine stacks its uploads on the card and aggregates there
    for defense in ("trimmed_mean", "median"):
        reset_launches()
        out, _ = experiment(
            cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000,
            n_test=500, scenario="sign_flip", defense=defense,
            engine="loop", rounds=2, device="cuda")
        got = read_launches()
        emit(phase="loop_defended_route", defense=defense, launches=got,
             acc=out["acc"], n_rejected=out["n_rejected"])
        assert got == only(robust_aggregate=2), (defense, got)
        assert all(np.isfinite(out["acc"])), out["acc"]

    # 7. small runs on the GPU and on the CPU
    small = {dev: quickstart(10, 2, 3000, 500, dev).run(2)
             for dev in ("cuda", "cpu")}
    for a, b in zip(small["cuda"], small["cpu"]):
        assert np.array_equal(a.selected, b.selected), (a.selected,
                                                        b.selected)
        assert abs(a.global_acc - b.global_acc) <= 1e-2, (a.global_acc,
                                                         b.global_acc)
        emit(phase="cuda_vs_cpu", run="undefended", round=a.round,
             acc_cuda=a.global_acc, acc_cpu=b.global_acc,
             selected=a.selected.tolist())
    defended = {dev: experiment(
        cfg=FeelConfig(n_ues=10, n_malicious=2), n_train=3000, n_test=500,
        scenario="sign_flip", defense="trimmed_mean+validation", rounds=2,
        device=dev)[1].logs for dev in ("cuda", "cpu")}
    for a, b in zip(defended["cuda"], defended["cpu"]):
        assert np.array_equal(a.selected, b.selected), (a.selected,
                                                        b.selected)
        assert (a.n_rejected, a.n_flagged) == (b.n_rejected, b.n_flagged)
        assert abs(a.global_acc - b.global_acc) <= 1e-2, (a.global_acc,
                                                         b.global_acc)
        emit(phase="cuda_vs_cpu", run="trimmed_mean+validation",
             round=a.round, acc_cuda=a.global_acc, acc_cpu=b.global_acc,
             n_rejected=a.n_rejected, n_flagged=a.n_flagged,
             selected=a.selected.tolist())

    # 8. the LM path
    launches["flash_attention"], summary["flash_attention"] = lm_phases()

    # 9./10. serving the decoder-only zoo, experts included
    (launches["decode_attention"], launches["moe_gemm"],
     launches["ssd_scan"]) = zoo_phases()
    # K4 at the serving path's median cache length (2,049 to 2,080 valid
    # positions over the 32 steps)
    summary["decode_attention"] = check_decode(
        "starcoder2-15b decode, median length", SERVE_BATCH, 48, 4,
        SERVE_PROMPT + SERVE_NEW, 128, SERVE_PROMPT + SERVE_NEW // 2,
        torch.bfloat16)
    summary["ssd_scan"] = summary_k6
    summary["moe_gemm"] = summary_k5

    # 11. summary and result
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [dict(
        name=name, **KERNELS[name], launches=launches[name],
        max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"])
        for name, row in summary.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
