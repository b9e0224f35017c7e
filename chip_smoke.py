"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and no phase catches one:

 1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
 2. build every kernel of the port from its source with nvcc, timed;
 3. hold each kernel against its plain PyTorch version on the card — the
    main path's shapes, ragged and misaligned shapes, bf16 and one
    bandwidth-sized case — with its time, the plain version's, one PyTorch
    library call's (a yardstick the port never calls) and its bound;
 4. the main path at the paper's §V scale: K = 50 UEs, 50,000/10,000
    synthetic MNIST, 5 label flippers, DQS on the host control plane, the
    vectorized engine, 3 rounds on the GPU. Every kernel's launch count is
    set to 0 just before and read just after; then one round split into
    its phases and one under ``torch.profiler`` say where the time goes;
 5. a small run on the GPU and on the CPU: the same selections, accuracies
    within 1e-2;
 6. one JSON line of per-kernel numbers, then the result line.

Exits non-zero without printing a result where CUDA is absent. A kernel's
time is its device time from ``torch.profiler`` over back-to-back calls
(warm L2, as the main path leaves the freshly stacked updates in L2),
reported beside the CUDA-event time per call, which includes the host's
launch overhead.
"""
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core.poisoning import (EASY_PAIR, LabelFlipAttack,  # noqa: E402
                                        pick_malicious)
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic_mnist import generate  # noqa: E402
from repro_torch.federated.cohort import pad_count  # noqa: E402
from repro_torch.federated.server import FeelServer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    weighted_aggregate, weighted_aggregate_ref)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
M_MLP = 784 * 64 + 64 + 64 * 10 + 10   # flattened MLP update, 50,890
KERNELS = {"weighted_aggregate": {
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/weighted_aggregate.cu",
    "replaces": "src/repro/kernels/weighted_aggregate.py:21"}}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def device_us(prof):
    """{kernel name: summed GPU time in us} of a profiler run."""
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return out


def time_ms(fn, reps):
    """(device ms, call ms) per call of ``fn`` over ``reps`` back-to-back
    calls. Device ms is the GPU time of the kernels it launches (from
    torch.profiler); call ms is the CUDA-event time per call, which the
    host's launch overhead sets whenever the kernels are shorter."""
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(device_us(prof).values()) / reps / 1e3, call_ms


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
         built=sorted(logs), ptxas={k: v.strip()[-600:]
                                    for k, v in logs.items()})

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

    # 4. the main path at the paper's §V scale
    weighted_aggregate.launches = 0
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
    launches = {"weighted_aggregate": weighted_aggregate.launches}
    emit(phase="main_path_launches", launches=launches)
    assert launches["weighted_aggregate"] == 3, launches
    accs = [r["acc"] for r in rounds]
    assert all(np.isfinite(accs)), accs
    assert accs[2] > accs[0], accs

    # not counted: one round split into its phases (host clock, the GPU
    # synchronised after each), then one round under the profiler for
    # the device's busy share and kernel time by name
    phases, t = {}, 3
    t0 = time.perf_counter()
    values, sched, sel, forced = server._schedule_round(t)
    phases["schedule_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    uploads, weights, acc_local, acc_test = server._train_cohort(sel, t)
    torch.cuda.synchronize()
    phases["train_and_eval_uploads_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    server._aggregate_uploads(uploads, weights)
    torch.cuda.synchronize()
    phases["aggregate_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    metrics = server._global_metrics()
    phases["global_eval_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    server._finalize_round(t, values, sched, sel, forced, acc_local,
                           acc_test, *metrics)
    phases["finalize_ms"] = (time.perf_counter() - t0) * 1e3
    emit(phase="round_phases", round=t, **phases)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round(4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = device_us(prof)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit(phase="profile_round", round=4, wall_us=wall_us,
         device_busy_us=busy_us, device_idle_share=1.0 - busy_us / wall_us,
         n_device_events=sum(1 for ev in prof.events() if ev.device_type
                             == torch.autograd.DeviceType.CUDA),
         agg_kernel_us=sum(v for k, v in by_kernel.items()
                           if "agg_kernel" in k),
         top_kernels_us=[[k[:80], v] for k, v in top])

    # the kernel at the main path's aggregation shape, for the summary
    n_main = max(r["agg_rows"] for r in rounds)
    main = check_aggregate(n_main, M_MLP, torch.float32, "main path rows")

    # 5. a small run on the GPU and on the CPU
    small = {dev: quickstart(10, 2, 3000, 500, dev).run(2)
             for dev in ("cuda", "cpu")}
    for a, b in zip(small["cuda"], small["cpu"]):
        assert np.array_equal(a.selected, b.selected), (a.selected,
                                                        b.selected)
        assert abs(a.global_acc - b.global_acc) <= 1e-2, (a.global_acc,
                                                         b.global_acc)
        emit(phase="cuda_vs_cpu", round=a.round, acc_cuda=a.global_acc,
             acc_cpu=b.global_acc, selected=a.selected.tolist())

    # 6. summary and result
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [dict(
        name=name, **KERNELS[name], launches=launches[name],
        max_abs_err=main["max_abs_err"], ms=main["kernel_ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"])
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
