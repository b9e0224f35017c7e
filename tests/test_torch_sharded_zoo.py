"""Port parity of the zoo sharded over a mesh: the DTensor rules of the
kernel operators K3–K6 (``kernels/oplib.py``), the zoo's train step and
its prefill and decode on ``DTensor``s placed by the reference's rules
(``sharding/dtensor.py``, ``launch/dryrun.sharded_step_args``), and the
dry run's meta trace on a mesh against a real sharded step's counts.

Every multi-rank case runs on gloo ranks spawned by
``torch.multiprocessing`` (four ranks, meshes ("data", "model") (2, 2)
and (4, 1), a ``FileStore`` under the test's temporary directory: no
port, no network); each spawn has a time limit of its own. The fake
process group runs only in a subprocess (it is global to its process).
The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: for four reduced
float32 archs it draws the params (``api.init``, ``PRNGKey(0)``) and a
numpy batch, computes ``api.loss`` and runs its jitted train step on a
2x2 host mesh, its state placed by its own rules; the port's ranks load
the same params (``convert.params_from_numpy``).

Tolerances: a kernel on its shards within 1e-6 (float32) of the
operator on the whole tensors; the sharded loss and every leaf's
gradient within 1e-5 (relative, ·max|g| for a gradient) of the port's
unsharded step from the same params, the loss within 1e-4 of the
reference's ``api.loss`` and of its sharded step's, the gradient norm
within 1e-4 of its sharded step's; decode logits within 1e-5·max of the
unsharded steps'. The meta trace's FLOPs, bytes and collective bytes equal
the real step's exactly, its peak within 5%.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["qwen2-moe-a2.7b", "mamba2-370m", "starcoder2-15b",
         "seamless-m4t-medium"]
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
# the counts: the four above and the hybrid (one reduced arch of each of
# the dense, MoE, SSM, hybrid and encoder-decoder families)
COUNTED = ARCHS + ["jamba-1.5-large-398b"]
DECODED = ["qwen2-moe-a2.7b", "starcoder2-15b"]
BATCH, SEQ, SRC_LEN = 4, 32, 32   # SRC_LEN: api.input_specs' at SEQ
SPAWN_S = 240            # each spawn's time limit
KERNEL_TOL = 1e-6
GRAD_TOL = 1e-5
REF_TOL = 1e-4
# the traced peak of a sharded step against the real one's: when DTensor
# frees a temporary depends on what its caches hold, which differs
# between a process that ran other steps first and one that did not (3.0%
# apart at most in this file's cases: starcoder2-15b's 13.65 against
# 14.08 MB); the argument bytes are exact
PEAK_TOL = 0.05


def _env():
    return {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


def _spawn(fn, args, world, store_dir):
    """``fn(rank, world, store, *args)`` on ``world`` spawned ranks, within
    ``SPAWN_S`` seconds."""
    ctx = torch.multiprocessing.spawn(
        fn, args=(world, os.path.join(store_dir, "store"), *args),
        nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} ran past {SPAWN_S} s")


def _init(rank, world, store):
    import logging
    import warnings
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _mesh(sizes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", sizes, mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------- #
# K3–K6: each strategy on its shards against the whole operator
# ---------------------------------------------------------------------- #
def _kernel_cases():
    """name: (mesh, kernel, the inputs' shapes, their placements on the
    mesh's two dims as (dim of ``data``, dim of ``model``) per tensor, a
    tensor dim or None, and the output placements the rule must give)."""
    q3, kv3 = (4, 8, 16, 16), (4, 8, 16, 16)
    gqa = (4, 2, 16, 16)
    x5, w5 = (4, 8, 16), (4, 16, 12)
    return {
        # K3 (B, H, S, D) x (B, Hkv, T, D)
        "k3_batch": ("2x2", "k3", (q3, kv3, kv3),
                     [(0, None)] * 3, "S(0)R"),
        "k3_heads": ("2x2", "k3", (q3, kv3, kv3),
                     [(None, 1)] * 3, "RS(1)"),
        "k3_gqa_heads": ("2x2", "k3", (q3, gqa, gqa),
                         [(None, 1)] * 3, "RS(1)"),
        "k3_batch_heads": ("2x2", "k3", (q3, gqa, gqa),
                           [(0, 1)] * 3, "S(0)S(1)"),
        "k3_batch_4": ("4x1", "k3", (q3, gqa, gqa), [(0, None)] * 3,
                       "S(0)R"),
        # GQA: H 8, Hkv 2 split 4 ways: the heads' split is refused and
        # the KV heads gathered
        "k3_gqa_heads_4": ("4x1", "k3", (q3, gqa, gqa), [(1, None)] * 3,
                           None),
        # K4 q (B, H, D), k/v (B, T, Hkv, D); T never split
        "k4_batch": ("2x2", "k4", ((4, 8, 16), (4, 24, 2, 16),
                                   (4, 24, 2, 16)), [(0, None)] * 3,
                     "S(0)R"),
        "k4_heads": ("2x2", "k4", ((4, 8, 16), (4, 24, 2, 16),
                                   (4, 24, 2, 16)),
                     [(None, 1), (None, 2), (None, 2)], "RS(1)"),
        "k4_seq_sharded_cache": ("2x2", "k4", ((4, 8, 16), (4, 24, 2, 16),
                                               (4, 24, 2, 16)),
                                 [(0, None), (0, 1), (0, 1)], "S(0)R"),
        "k4_gqa_heads_4": ("4x1", "k4", ((4, 8, 16), (4, 24, 2, 16),
                                         (4, 24, 2, 16)),
                           [(1, None), (2, None), (2, None)], None),
        # K5 (E, C, K) x (E, K, N)
        "k5_experts": ("2x2", "k5", (x5, w5), [(0, None), (0, None)],
                       "S(0)R"),
        "k5_n": ("2x2", "k5", (x5, w5), [(None, None), (None, 2)],
                 "RS(2)"),
        "k5_k_partial": ("2x2", "k5", (x5, w5), [(None, 2), (None, 1)],
                         "RP(sum)"),
        "k5_c": ("2x2", "k5", (x5, w5), [(1, None), (None, None)],
                 "S(1)R"),
        "k5_experts_n": ("2x2", "k5", (x5, w5), [(0, None), (0, 2)],
                         "S(0)S(2)"),
        "k5_e_over_4": ("4x1", "k5", (x5, w5), [(0, None), (0, None)],
                        "S(0)R"),
        # K6 x (B, L, H, P), dt (B, L, H), A (H,), B/C (B, L, G, N), the
        # initial state (B, H, N, P)
        "k6_batch": ("2x2", "k6", (1, True), [0, None], "S(0)R"),
        "k6_heads_one_group": ("2x2", "k6", (1, True), [None, "h"],
                               "RS(2)"),
        "k6_heads_groups": ("2x2", "k6", (2, False), [None, "h"],
                            "RS(2)"),
        "k6_batch_heads": ("2x2", "k6", (2, True), [0, "h"], "S(0)S(2)"),
        # two groups split 4 ways: the heads' split is refused
        "k6_groups_over_4": ("4x1", "k6", (2, False), ["h", None], None),
    }


def _k6_inputs(g, init, gen):
    b, length, h, p, n = 4, 32, 4, 16, 8
    x = torch.randn(b, length, h, p, generator=gen)
    dt = torch.rand(b, length, h, generator=gen) * 0.1 + 0.01
    A = -torch.rand(h, generator=gen) - 0.5
    B_ = torch.randn(b, length, g, n, generator=gen)
    C_ = torch.randn(b, length, g, n, generator=gen)
    s0 = torch.randn(b, h, n, p, generator=gen) if init else None
    return [x, dt, A, B_, C_, s0]


# the dims of K6's tensors a split of the batch / of the heads takes
_K6_DIMS = {0: [0, 0, None, 0, 0, 0], "h": [2, 2, 0, None, None, 1]}


def _kernel_rank(rank, world, store, names, wrong, out):
    _init(rank, world, store)
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import oplib
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    if wrong:
        # a deliberately wrong K3 rule: a rank's query heads against the
        # whole K/V
        def wrong_rule(q, k, v, causal, window, scale):
            none = [None] * 3
            return [([Replicate()], [Replicate()] * 3 + none),
                    ([Shard(1)], [Shard(1), Replicate(), Replicate()]
                     + none)]
        oplib.register_rule(torch.ops.repro_torch.flash_attention.default,
                            wrong_rule)
    meshes = {k: _mesh(v) for k, v in MESHES.items()}
    cases = _kernel_cases()
    res = {}
    for name in names:
        mesh_name, kernel, shapes, where, _ = cases[name]
        mesh = meshes[mesh_name]
        gen = torch.Generator().manual_seed(len(name))
        if kernel == "k6":
            g, init = shapes
            ins = _k6_inputs(g, init, gen)
            dims = [[_K6_DIMS[w][i] if w is not None else None
                     for w in where] for i in range(6)]
        else:
            ins = [torch.randn(s, generator=gen) for s in shapes]
            dims = [list(w) for w in where]

        def pl(d):
            return [Replicate() if x is None else Shard(x) for x in d]
        dts = [None if t is None else
               distribute_tensor(t, mesh, pl(d), src_data_rank=None)
               for t, d in zip(ins, dims)]
        if kernel == "k3":
            want = flash_attention(*ins)
            got = flash_attention(*dts)
        elif kernel == "k4":
            want = decode_attention(*ins, 20)
            got = decode_attention(*dts, 20)
        elif kernel == "k5":
            want = moe_gemm(*ins)
            got = moe_gemm(*dts)
        else:
            want = ssd_scan(*ins[:5], chunk=8, initial_state=ins[5])[0]
            got = ssd_scan(*dts[:5], chunk=8, initial_state=dts[5])[0]
        placements = ["R" if isinstance(p, Replicate) else
                      f"S({p.dim})" if isinstance(p, Shard) else
                      f"P({p.reduce_op})" for p in got.placements]
        full = got.full_tensor()
        res[name] = {"err": float((full - want).abs().max()),
                     "scale": float(want.abs().max()),
                     "placements": placements,
                     "local": list(got.to_local().shape)}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _kernels(tmp):
    """{"rules": each case's result, "wrong": the K3 cases under the wrong
    rule}."""
    out = {}
    for key, wrong in (("rules", False), ("wrong", True)):
        d = tmp / key
        d.mkdir()
        names = (list(_kernel_cases()) if not wrong else
                 ["k3_gqa_heads", "k3_batch_heads"])
        _spawn(_kernel_rank, (names, wrong, str(d / "out.json")), 4, str(d))
        out[key] = json.loads((d / "out.json").read_text())
    return out


@pytest.fixture(scope="module")
def kernels(runs):
    return runs["kernels"]


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_rule_matches_the_whole_operator(kernels, name):
    """The operator on each rank's shards, gathered, equals the operator
    on the whole tensors within 1e-6; the output's placements are the
    strategy's (None: the rule refused the split and DTensor gathered the
    inputs, so the output is replicated on that mesh dim)."""
    r = kernels["rules"][name]
    assert r["err"] <= KERNEL_TOL * max(r["scale"], 1.0), r
    kernel, want = _kernel_cases()[name][1], _kernel_cases()[name][4]
    if want is not None:
        assert "".join(r["placements"]) == want, r
    else:
        heads = "S(2)" if kernel == "k6" else "S(1)"
        assert r["placements"][0] != heads, r


def test_wrong_gqa_rule_is_rejected(kernels):
    """A K3 rule that pairs a rank's query heads with the whole K/V (H 8
    over 2 ranks against Hkv 2) makes the kernel group 2 query heads a KV
    head where the model groups 4: the comparison above catches it (the
    error is of the outputs' own size)."""
    for name in ("k3_gqa_heads", "k3_batch_heads"):
        r = kernels["wrong"][name]
        assert r["err"] > 1e-2 * r["scale"], r
    assert kernels["wrong"]["k3_gqa_heads"]["placements"] == ["R", "S(1)"]


# ---------------------------------------------------------------------- #
# The zoo: train step, prefill and decode, counts
# ---------------------------------------------------------------------- #
_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental, numpy as np
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import TrainConfig, get, reduced
from repro.launch.steps import init_state, make_train_step
from repro.models import api
from repro.sharding import opt_state_specs, param_specs
from repro_torch.convert import flatten_tree

archs, b, s, src_len, out = json.loads(sys.argv[1])
res = {}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
for arch in archs:
    cfg = dataclasses.replace(reduced(get(arch)), dtype="float32")
    tcfg = TrainConfig(optimizer="adamw", remat=False)
    params, opt, step = init_state(cfg, tcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["src"] = rng.standard_normal((b, src_len, cfg.d_model)).astype(
            np.float32)
    loss, _ = jax.jit(lambda p, x: api.loss(cfg, p, x))(params, batch)
    # the reference's own sharded step: its rules, a 2x2 host mesh
    ps = param_specs(cfg, params, mesh)
    os_ = opt_state_specs("adamw", params, ps, mesh)
    ns = lambda t, sp: jax.tree.map(
        lambda x, q: jax.device_put(x, NamedSharding(mesh, q)), t, sp)
    sb = {k: jax.device_put(v, NamedSharding(
        mesh, P("data", *([None] * (v.ndim - 1))))) for k, v in batch.items()}
    with mesh:
        m = jax.jit(make_train_step(cfg, tcfg))(ns(params, ps), ns(opt, os_),
                                                step, sb)[3]
    flat = flatten_tree(jax.tree.map(np.asarray, params))
    np.savez(os.path.join(out, arch + ".npz"),
             **{"p/" + k: v for k, v in flat.items()},
             **{"b/" + k: v for k, v in batch.items()})
    res[arch] = {"loss": float(loss), "sharded_loss": float(m["loss"]),
                 "sharded_grad_norm": float(m["grad_norm"])}
with open(os.path.join(out, "ref.json"), "w") as f:
    json.dump(res, f)
print("OK")
"""

_FAKE = r"""
import dataclasses, json, logging, sys, warnings
warnings.filterwarnings("ignore")
logging.disable(logging.WARNING)
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
archs, b, s, out = json.loads(sys.argv[1])
res = {}
with dryrun.fake_group(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in archs:
        cfg = dataclasses.replace(registry.reduced(registry.get(arch)),
                                  dtype="float32")
        c, _ = dryrun.trace_sharded(cfg, InputShape("t", s, b, "train"),
                                    mesh, "adamw", False)
        res[arch] = {"flops": c.flops, "bytes": c.bytes,
                     "op_flops": c.op_flops, "op_bytes": dict(c.op_bytes),
                     "op_calls": dict(c.op_calls),
                     "coll": dict(c.op_collective_bytes),
                     "memory": c.memory()}
with open(out, "w") as f:
    json.dump(res, f)
print("OK")
"""


def _cfg(arch):
    from repro_torch.configs import registry
    return dataclasses.replace(registry.reduced(registry.get(arch)),
                               dtype="float32")


def _load(data, arch):
    from repro_torch.convert import params_from_numpy
    d = np.load(os.path.join(data, arch + ".npz"))
    params = params_from_numpy({k[2:]: d[k] for k in d.files
                                if k.startswith("p/")}, "cpu")
    batch = {k[2:]: torch.from_numpy(d[k]) for k in d.files
             if k.startswith("b/")}
    return params, batch


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _counted_step(cfg, mesh, params, batch, counts, arch):
    """One sharded train step (AdamW from a zero state, the norm clipped)
    from ``params`` on ``batch``, under the dry run's ``StepCounter``:
    its counts go to ``counts[arch]``; returns its loss and norm."""
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding import specs as sp
    train = InputShape("t", SEQ, BATCH, "train")
    tcfg = TrainConfig(optimizer="adamw", remat=False)
    pspecs = sp.param_specs(cfg, params, mesh)
    opt = make_optimizer(tcfg).init(params)
    state = (dt.place(params, pspecs, mesh),
             dt.place(opt, sp.opt_state_specs("adamw", params, pspecs, mesh),
                      mesh),
             torch.zeros((), dtype=torch.int32),
             dt.place(batch, sp.batch_specs(cfg, train, mesh), mesh))
    step = dryrun.sharded_step(steps.make_train_step(cfg, tcfg), mesh, train)
    out = []
    c = dryrun.count_step(lambda *a: out.append(step(*a)) or out[0], state)
    counts[arch] = {
        "flops": c.flops, "bytes": c.bytes, "op_flops": c.op_flops,
        "op_bytes": dict(c.op_bytes), "op_calls": dict(c.op_calls),
        "coll": dict(c.op_collective_bytes), "memory": c.memory()}
    m = out[0][3]
    return {"loss": float(dt.full({"l": m["loss"]})["l"]),
            "grad_norm": float(dt.full({"g": m["grad_norm"]})["g"])}


def _zoo_rank(rank, world, store, data, out):
    _init(rank, world, store)
    import torch.distributed as dist
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import api
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding import specs as sp
    meshes = {k: _mesh(v) for k, v in MESHES.items()}
    train = InputShape("t", SEQ, BATCH, "train")
    res = {"grads": {}, "steps": {}, "decode": {}, "counts": {}}
    # first, one full train step on 2x2 of each counted arch, in the fake
    # trace's order (DTensor's caches, which decide when its temporaries
    # are freed, then hold the same entries in both processes): the four
    # from the reference's params, their loss and norm against the
    # reference's sharded step
    for arch in COUNTED:
        if arch in ARCHS:
            params, batch = _load(data, arch)
        else:
            _, (params, _, _, batch) = dryrun.step_args(
                _cfg(arch), train, "adamw", False, "cpu")
        res["steps"][arch] = _counted_step(_cfg(arch), meshes["2x2"], params,
                                           batch, res["counts"], arch)
    for arch in ARCHS:
        cfg = _cfg(arch)
        params, batch = _load(data, arch)
        loss0, _, g0 = steps.loss_and_grads(cfg, params, batch)
        for mname, mesh in meshes.items():
            P = dt.place(params, sp.param_specs(cfg, params, mesh), mesh)
            B = dt.place(batch, sp.batch_specs(cfg, train, mesh), mesh)
            run = dryrun.sharded_step(
                lambda p, x: steps.loss_and_grads(cfg, p, x), mesh, train)
            loss1, _, g1 = run(P, B)
            g1 = dt.full(g1)
            worst = max(g0, key=lambda k: _rel(g1[k], g0[k]))
            res["grads"][f"{arch}@{mname}"] = {
                "loss": float(loss0),
                "sharded_loss": float(dt.full({"l": loss1})["l"]),
                "worst_leaf": worst, "worst": _rel(g1[worst], g0[worst]),
                "leaves": sorted(g1) == sorted(g0)}
    # prefill, then 4 decode steps, caches placed by batch_specs
    mesh = meshes["2x2"]
    for arch in DECODED:
        cfg = _cfg(arch)
        params, _ = _load(data, arch)
        gen = torch.Generator().manual_seed(2)
        tokens = torch.randint(cfg.vocab_size, (BATCH, SEQ // 2),
                               generator=gen)
        nxt = torch.randint(cfg.vocab_size, (4, BATCH, 1), generator=gen)
        logits, cache = api.prefill(cfg, params, {"tokens": tokens},
                                    target_len=SEQ)
        want = [logits]
        for t in nxt:
            logits, cache = api.decode_step(cfg, params, cache, t)
            want.append(logits)
        pre = InputShape("p", SEQ // 2, BATCH, "prefill")
        dec = InputShape("d", SEQ, BATCH, "decode")
        bspecs = sp.batch_specs(cfg, dec, mesh)
        P = dt.place(params, sp.param_specs(cfg, params, mesh), mesh)
        step = dryrun.sharded_step(
            lambda p, b: api.prefill(cfg, p, b, target_len=SEQ), mesh, pre)
        logits, cache = step(P, dt.place({"tokens": tokens},
                                         sp.batch_specs(cfg, pre, mesh),
                                         mesh))
        cache = {k: v.redistribute(mesh, sp.named(mesh, bspecs["cache"][k]))
                 if dt.is_dtensor(v) else v for k, v in cache.items()}
        got = [logits]
        step = dryrun.sharded_step(
            lambda p, c, t: api.decode_step(cfg, p, c, t), mesh, dec)
        for t in nxt:
            logits, cache = step(P, cache, dt.place({"token": t}, bspecs,
                                                    mesh)["token"])
            got.append(logits)
        k = next(k for k in cache if k.endswith("/k"))
        res["decode"][arch] = {
            "errs": [_rel(dt.full({"x": g})["x"], w)
                     for g, w in zip(got, want)],
            "cache_k": [str(p) for p in cache[k].placements],
            "cache_spec": list(bspecs["cache"][k])}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"kernels": ``_kernels``, "ref": the reference's losses, "fake": the
    meta traces on a fake group of 4, "ranks": each rank's results}. The
    reference and the fake group run in subprocesses beside the kernels'
    ranks; the zoo's ranks wait for the reference's params."""
    data = tmp_path_factory.mktemp("zoo")
    fake_out = data / "fake.json"
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for name, code, args in (
            ("ref", _REFERENCE, [ARCHS, BATCH, SEQ, SRC_LEN, str(data)]),
            ("fake", _FAKE, [COUNTED, BATCH, SEQ, str(fake_out)]))}
    out = {"kernels": _kernels(data)}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=SPAWN_S)
        assert p.returncode == 0 and "OK" in stdout, (name, stderr[-3000:])
    _spawn(_zoo_rank, (str(data), str(data / "rank")), 4, str(data))
    out.update(ref=json.loads((data / "ref.json").read_text()),
               fake=json.loads(fake_out.read_text()),
               ranks=[json.loads((data / f"rank.{r}.json").read_text())
                      for r in range(4)])
    return out


@pytest.fixture(scope="module")
def zoo(runs):
    return runs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_the_unsharded_step(zoo, arch, mesh):
    """The loss and every leaf's gradient of the step on DTensors (params
    by ``param_specs``, the batch by ``batch_specs``, the reference's
    activation specs) against the port's step on plain tensors from the
    same params, on every rank."""
    for r in zoo["ranks"]:
        g = r["grads"][f"{arch}@{mesh}"]
        assert g["leaves"]
        assert abs(g["sharded_loss"] - g["loss"]) <= GRAD_TOL * abs(g["loss"])
        assert g["worst"] <= GRAD_TOL, g


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_the_reference(zoo, arch):
    """The sharded loss against the reference's ``api.loss`` on the same
    params and batch."""
    want = zoo["ref"][arch]["loss"]
    for mesh in MESHES:
        got = zoo["ranks"][0]["grads"][f"{arch}@{mesh}"]["sharded_loss"]
        assert abs(got - want) <= REF_TOL * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference_sharded_step(zoo, arch):
    """One full train step on the 2x2 mesh (AdamW, the norm clipped)
    against the reference's jitted step on a 2x2 host mesh, its state
    placed by its own rules: the loss and the gradient norm."""
    want = zoo["ref"][arch]
    for r in zoo["ranks"]:
        got = r["steps"][arch]
        assert abs(got["loss"] - want["sharded_loss"]) <= \
            REF_TOL * abs(want["sharded_loss"])
        assert abs(got["grad_norm"] - want["sharded_grad_norm"]) <= \
            REF_TOL * abs(want["sharded_grad_norm"])


@pytest.mark.parametrize("arch", DECODED)
def test_sharded_decode_matches_the_unsharded_steps(zoo, arch):
    """A prefill of 16 tokens, then 4 decode steps with the caches placed
    by ``batch_specs`` (batch over "data", sequence over "model"): every
    logit within 1e-5·max of the plain steps'; the caches keep their
    placements (the writes land in the rank that holds the slot)."""
    for r in zoo["ranks"]:
        d = r["decode"][arch]
        assert max(d["errs"]) <= GRAD_TOL, d
        assert d["cache_spec"][1:3] == ["data", "model"]
        assert d["cache_k"] == ["S(1)", "S(2)"], d


@pytest.mark.parametrize("arch", COUNTED)
def test_meta_trace_on_a_fake_mesh_counts_a_real_sharded_step(zoo, arch):
    """The dry run's trace of the sharded train step on ``meta`` as rank 0
    of a fake group of 4 ranks, against the same step on real tensors on
    each of 4 gloo ranks: the same FLOPs, bytes and collective bytes,
    operator by operator. The counts are one rank's local operators, with
    at least one collective. The arguments' bytes are equal, the peak
    within ``PEAK_TOL``."""
    want = zoo["fake"][arch]
    for r in zoo["ranks"]:
        got = r["counts"][arch]
        assert got["flops"] == want["flops"] > 0
        assert got["op_flops"] == want["op_flops"]
        assert got["bytes"] == want["bytes"] > 0
        assert got["op_bytes"] == want["op_bytes"]
        assert got["op_calls"] == want["op_calls"]
        assert got["coll"] == want["coll"] and sum(got["coll"].values()) > 0
        assert got["memory"]["argument_bytes"] == \
            want["memory"]["argument_bytes"]
        assert abs(got["memory"]["peak_bytes"]
                   - want["memory"]["peak_bytes"]) <= \
            PEAK_TOL * want["memory"]["peak_bytes"]
