"""Dry run: trace every (arch x input shape) step on the ``meta`` device,
for one H100 or as one chip of the reference's production mesh, and put
its cost on the H100's roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each step for a 512-device TPU mesh and reads XLA's
``cost_analysis`` and ``memory_analysis``. PyTorch runs eagerly and has
neither, so here the step itself — ``launch/steps.py``'s train, prefill or
decode step, the one the launchers and ``chip_smoke.py`` run — is run on
``meta`` tensors (``api.init(device="meta")``, ``api.input_specs``), which
carry shapes and dtypes and compute nothing, under ``StepCounter``:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, the aten products'
  formulas and the kernels' own (each kernel K1–K6 is an operator of the
  dispatcher with its ``cost`` registered, ``kernels/oplib.py``);
- bytes: per operator, each distinct input view read once and each output
  written once (views, and ``empty``, move nothing), a kernel's by its
  ``cost``. This is aten-level traffic: every intermediate goes to memory
  and back, so it over-counts what XLA's fused "bytes accessed" reports
  for the same step, by as much as a fusion would save;
- memory: the bytes of the live storages (not tensors: views share one),
  arguments included, followed op by op, and their peak.

The same counter runs a real step on the CPU or the card (``count_step``
on real tensors), where the counts are the meta trace's: the ops are the
same, and only their values differ. No scan-trip correction is made: the
port's ``scan_blocks`` is a Python loop, so the trace sees every block
(``--no-correction`` is accepted and changes nothing). A decode step is
traced at the cache's last position (``index`` = S - 1), where it reads
every cached position, as the reference's masked decode step does.

Without ``--mesh`` the zoo's steps are traced for one device (``mesh``
"1xH100", no collectives). ``--mesh single`` traces each on the 16x16
pod ("data", "model"), ``multi`` on 2x16x16 ("pod", "data", "model") and
``both`` on the two, as rank 0 of a ``fake`` process group of 256 or 512
ranks (``fake_group``, one at a time: it is global to its process): the
params, optimizer state, batch and caches are ``DTensor``s on ``meta``
placed by the reference's rules (``sharding/specs.py``,
``sharding/dtensor.place``), the step runs under the reference's
activation specs (``act_specs``), and every operator runs on the rank's
local shards (the kernels under their DTensor rules, ``oplib``), so the
counts are one chip's: its local operators, and the collectives DTensor
issues, which move nothing here and are priced by the bytes they would
move (``roofline.collective_bytes``). ``--cohort`` traces the
distributed FEEL round (``federated/distributed.py``) the same way, on
16x16 when no ``--mesh`` is given. The dry run touches no device and runs
the same with or without CUDA.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import traceback
import weakref
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.kernels import oplib
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import ADAFACTOR_ARCHS, make_production_mesh
from repro_torch.models import api, common
from repro_torch.obs.clock import wall_clock
from repro_torch.sharding.ctx import activation_specs
from repro_torch.sharding.dtensor import place, sharded
from repro_torch.sharding.specs import (batch_specs, data_axes, mesh_shape,
                                        opt_state_specs, param_specs)

MESH = "1xH100"
# ops that allocate without writing, or make views
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "empty_permuted"}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _tensors(tree):
    """The tensors of a tree, a ``DTensor`` as this rank's local shard."""
    return [t._local_tensor if _is_dtensor(t) else t
            for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _arg_tensors(args, kwargs):
    """The tensors among an operator's arguments (lists of tensors
    included)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@functools.lru_cache(maxsize=None)
def _op_info(func):
    """(name, overload packet, how its bytes are counted: "cost",
    "collective", "none" or "io", and whether it writes an argument) of an
    operator."""
    packet = func._overloadpacket
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in func._schema.arguments)
    if packet in oplib.COSTS:
        kind = "cost"
    elif str(packet) in rl.C10D_OPS:
        kind = "collective"
    elif packet.__name__ in _NO_TRAFFIC or (
            not writes and any(r.alias_info is not None
                               for r in func._schema.returns)):
        kind = "none"
    else:
        kind = "io"
    return str(packet), packet, kind, writes


class _Dispatch(TorchDispatchMode):
    """Hands every operator call to its ``StepCounter``. An operator on
    ``DTensor``s is handed back to DTensor (``NotImplemented``): it runs
    its strategy's local operators and collectives on this rank's shards,
    and those come back through this mode and ``FlopCounterMode``, which
    count them; a mode that ran the global operator itself would count
    the global shapes once (torch 2.13: a dispatch mode sees the
    ``DTensor`` operator first, its local ones only when it defers)."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor(t) for t in pytree.tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        self.counter._count(func, args, kwargs, out)
        return out


# DTensor's own bookkeeping, which runs torch operators of its own: the
# sharding propagation runs each new (operator, shapes, placements) once on
# fake tensors of the global shapes, to learn the output's (and builds a
# mesh of its own for some strategies); a redistribution's plan and a
# shard's offsets are computed with small tensors. None of them is part
# of the step, and whether they run depends on DTensor's caches. (module,
# class, function), where torch 2.13 has them.
_DTENSOR_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._redistribute", None,
     "_gen_transform_infos_non_cached"),
    ("torch.distributed.tensor._utils", None,
     "_compute_local_shape_and_global_offset"),
)
# a functional collective's wait (no bytes, no FLOPs; a fake group issues
# none), and a host value lifted to a tensor, which moves nothing and
# takes another operator on each device (DTensor's masked partial writes
# ``t[mask] = 0``: the 0 is a ``lift_fresh`` on the CPU, a
# ``scalar_tensor`` on ``meta``)
_UNCOUNTED = {"_c10d_functional.wait_tensor", "aten.scalar_tensor",
              "aten.lift_fresh"}


@contextlib.contextmanager
def _uncounted_bookkeeping():
    """Inside the block DTensor's bookkeeping (``_DTENSOR_BOOKKEEPING``)
    runs with the dispatch modes, the counters, set aside."""
    import importlib
    from torch.utils._python_dispatch import _disable_current_modes

    def quiet(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run
    patched = []
    for module, cls, name in _DTENSOR_BOOKKEEPING:
        try:
            owner = importlib.import_module(module)
        except ImportError:
            continue
        owner = getattr(owner, cls) if cls else owner
        if hasattr(owner, name):
            patched.append((owner, name, getattr(owner, name)))
            setattr(owner, name, quiet(getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)


class StepCounter:
    """FLOPs, bytes and live storage of what runs inside the block.

    ``hold(tree)`` first registers the step's arguments (their storages'
    bytes are ``argument_bytes``); ``finish(out)`` registers its outputs.
    After the block: ``flops`` and ``bytes`` in total, ``op_flops``,
    ``op_bytes`` and ``op_calls`` by operator name, ``memory()``, and
    ``op_collective_bytes``: by collective operator (``roofline.C10D_OPS``),
    the bytes its outputs hold (``roofline.collective_bytes`` prices
    them)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.op_flops = {}
        self.op_bytes = collections.Counter()
        self.op_calls = collections.Counter()
        self.op_collective_bytes = collections.Counter()
        self.argument_bytes = self.output_bytes = 0
        self.live_bytes = self.peak_bytes = 0
        self._live = {}
        self._args = set()

    # live storage
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def hold(self, tree) -> None:
        for t in _tensors(tree):
            self._track(t)
            self._args.add(_storage_key(t))
        self.argument_bytes = self.live_bytes

    def finish(self, out) -> None:
        new = {_storage_key(t): t.untyped_storage().nbytes()
               for t in _tensors(out)}
        self.output_bytes = sum(n for k, n in new.items()
                                if k not in self._args)

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` fields: arguments, outputs
        (the storages the step returns that it did not take: the port's
        optimizer updates its arguments in place), temporaries (the rest
        of the peak) and the peak of the live bytes."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": max(self.peak_bytes - self.argument_bytes
                                  - self.output_bytes, 0),
                "peak_bytes": self.peak_bytes}

    # one operator
    def _count(self, func, args, kwargs, out) -> None:
        name, packet, kind, writes = _op_info(func)
        if name in _UNCOUNTED:
            return
        outs = ([out] if isinstance(out, torch.Tensor)
                else [t for t in pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)])
        for t in outs:
            self._track(t)
        if kind == "cost":
            nb = int(oplib.COSTS[packet](*args, **kwargs)[1])
        elif kind == "collective":
            # the outputs are what it returns, or (an op that returns only
            # its Work) its first argument, c10d's output; HBM traffic:
            # each tensor argument read once, each output written once
            moved = outs or _tensors(args[:1])
            self.op_collective_bytes[name] += sum(_nbytes(t) for t in moved)
            ins = {id(t): t for t in _tensors((args, kwargs))}
            nb = (sum(_nbytes(t) for t in moved)
                  + sum(_nbytes(t) for t in ins.values()))
        elif kind == "none" or not outs:
            nb = 0
        else:
            ins = _arg_tensors(args, kwargs)
            keys = {}
            for t in ins:
                keys[(_storage_key(t), t.storage_offset(), t.shape,
                      t.stride())] = t
            in_storages = {k[0] for k in keys}
            # an output in an input's storage, nothing written: a view
            if not writes and all(_storage_key(t) in in_storages
                                  for t in outs):
                nb = 0
            else:
                nb = (sum(_nbytes(t) for t in outs)
                      + sum(_nbytes(t) for t in keys.values()))
        self.bytes += nb
        self.op_bytes[name] += nb
        self.op_calls[name] += 1

    def __enter__(self):
        self._quiet = _uncounted_bookkeeping()
        self._quiet.__enter__()
        self._flop_mode = FlopCounterMode(display=False)
        self._flop_mode.__enter__()
        self._mode = _Dispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        self._quiet.__exit__(*exc)
        counts = self._flop_mode.get_flop_counts().get("Global", {})
        self.op_flops = {str(k): int(v) for k, v in counts.items()}
        self.flops = int(self._flop_mode.get_total_flops())
        return False


def count_step(fn, args) -> StepCounter:
    """``fn(*args)`` under a ``StepCounter`` that holds ``args``. The RoPE
    tables, cached per device, are dropped first, so that every count
    includes making them, whatever ran before in the process."""
    common._rope_table.cache_clear()
    counter = StepCounter()
    counter.hold(args)
    with counter:
        out = fn(*args)
        counter.finish(out)
    return counter


def step_inputs(cfg, shape, device, seed: int = 0) -> dict:
    """``api.input_specs`` on ``meta``; elsewhere real inputs of the same
    shapes and dtypes, drawn from ``seed``: token ids below the
    vocabulary, normal frame embeddings, a zero cache."""
    specs = api.input_specs(cfg, shape)
    if torch.device(device).type == "meta":
        return specs
    g = torch.Generator(device="cpu").manual_seed(seed)

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(cfg.vocab_size, t.shape, generator=g,
                                 dtype=torch.int32).to(device)
        return torch.randn(t.shape, generator=g, dtype=t.dtype).to(device)
    out = {k: real(v) for k, v in specs.items() if k != "cache"}
    if shape.kind == "decode":
        out["cache"] = api.cache_init(cfg, shape.global_batch,
                                      shape.seq_len, device=device)
    return out


def step_args(cfg, shape, optimizer: str = "adamw", remat: bool = True,
              device="meta", seed: int = 0):
    """(step function, its arguments) of ``shape``'s kind on ``device``:
    train (``init_state`` at ``TrainConfig(optimizer, remat)``), prefill,
    or decode at the cache's last position."""
    batch = step_inputs(cfg, shape, device, seed)
    if shape.kind == "train":
        tcfg = TrainConfig(optimizer=optimizer, remat=remat)
        params, opt_state, step = steps.init_state(cfg, tcfg, seed,
                                                   device=device)
        return (steps.make_train_step(cfg, tcfg),
                (params, opt_state, step, batch))
    params = api.init(cfg, seed, device=device)
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg), (params, batch)
    batch["cache"]["index"] = shape.seq_len - 1
    return (steps.make_decode_step(cfg),
            (params, batch["cache"], batch["token"]))


def _trace_one(cfg, shape, optimizer: str, remat: bool = True):
    """Trace one step of ``shape`` on ``meta`` (the counterpart of the
    reference's ``_compile_one``); returns (its ``StepCounter``, the
    trace's seconds)."""
    t0 = wall_clock()
    counter = count_step(*step_args(cfg, shape, optimizer, remat))
    return counter, wall_clock() - t0


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    destroyed on leaving: every collective runs as an operator on its
    tensors and moves nothing. It is global to its process, so one runs
    at a time."""
    import torch.distributed as dist
    # a private module of torch's (seen in torch 2.11 and 2.13): a store
    # and process group that run every collective as a no-op
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_mesh(multi_pod: bool):
    """The ``DeviceMesh`` a production mesh is traced on, over the default
    process group (256 or 512 ranks). A "cuda" mesh, as the card's:
    DTensor moves a shard from one dim to another by an all-to-all there,
    on a "cpu" mesh by an all-gather (gloo has none). 16x16 is
    ``make_production_mesh``'s ("data", "model"). 2x16x16 is traced as
    ("data" 32, "model" 16): every rule of ``sharding/specs.py`` and every
    activation spec names "pod" and "data" together (``data_axes``), so a
    tensor split over both is split over their 32 ranks either way, and
    the rules give the same layouts on the two forms. On the 3-D form
    DTensor moves such a tensor in two collectives, one an axis, where
    one over the 32 ranks does (its own warning), and its planner took
    245 to 323 s for one cold trace of a reduced config (mamba2-370m
    decode_32k, qwen2-moe-a2.7b train_4k) against seconds on this one."""
    from torch.distributed.device_mesh import init_device_mesh
    if not multi_pod:
        return make_production_mesh(multi_pod=False, device_type="cuda")
    return init_device_mesh("cuda", (32, 16),
                            mesh_dim_names=("data", "model"))


def batch_shardable(shape, mesh) -> bool:
    """Whether ``shape``'s batch splits over the mesh's data axes (the
    reference's test at ``_compile_one``)."""
    n = math.prod(mesh_shape(mesh).shape[a] for a in data_axes(mesh))
    return shape.global_batch % n == 0 and shape.global_batch >= n


def act_specs(mesh, kind: str, batch_shardable: bool = True) -> dict:
    """The reference's ``_act_specs``: the residual stream split by batch
    over the data axes, the logits' vocabulary over ``model``; a decode
    step's hidden state by batch where the batch splits."""
    dax = data_axes(mesh)
    bax = dax if len(dax) > 1 else dax[0]
    if kind in ("train", "prefill"):
        return {"act": (bax, None, None), "logits": (bax, None, "model")}
    return {"dec": (bax if batch_shardable else None, None, None)}


def sharded_step_args(cfg, shape, mesh, optimizer: str = "adamw",
                      remat: bool = True, device="meta", seed: int = 0):
    """``step_args`` with every argument placed on the ``DeviceMesh``
    ``mesh`` by the reference's rules: params by ``param_specs``, the
    optimizer state by ``opt_state_specs``, the batch and the decode cache
    by ``batch_specs`` (the step counter stays a plain tensor, replicated
    inside ``sharded``)."""
    fn, args = step_args(cfg, shape, optimizer, remat, device, seed)
    pspecs = param_specs(cfg, args[0], mesh)
    bspecs = batch_specs(cfg, shape, mesh)
    params = place(args[0], pspecs, mesh)
    if shape.kind == "train":
        _, opt_state, step, batch = args
        ospecs = opt_state_specs(optimizer, args[0], pspecs, mesh)
        return fn, (params, place(opt_state, ospecs, mesh), step,
                    place(batch, bspecs, mesh))
    if shape.kind == "prefill":
        return fn, (params, place(args[1], bspecs, mesh))
    _, cache, token = args
    return fn, (params, place(cache, bspecs["cache"], mesh),
                place({"token": token}, bspecs, mesh)["token"])


def sharded_step(fn, mesh, shape, extra_specs_fn=None, cfg=None):
    """``fn`` run on ``DTensor``s: inside ``sharding.dtensor.sharded``,
    under ``act_specs`` for ``shape`` and whatever ``extra_specs_fn(mesh,
    cfg)`` adds (the hillclimb's variants)."""
    specs = act_specs(mesh, shape.kind, batch_shardable(shape, mesh))
    if extra_specs_fn is not None:
        specs.update(extra_specs_fn(mesh, cfg) or {})

    def step(*args):
        with activation_specs(specs), sharded():
            return fn(*args)
    return step


def trace_sharded(cfg, shape, mesh, optimizer: str, remat: bool = True,
                  extra_specs_fn=None):
    """Trace one step of ``shape`` on ``meta`` as this rank of ``mesh``
    (a ``DeviceMesh`` over the default process group); returns (its
    ``StepCounter``: this rank's local operators and the collectives
    DTensor issues, the trace's seconds)."""
    t0 = wall_clock()
    fn, args = sharded_step_args(cfg, shape, mesh, optimizer, remat)
    counter = count_step(sharded_step(fn, mesh, shape, extra_specs_fn, cfg),
                         args)
    return counter, wall_clock() - t0


def lower_pair(arch: str, shape_name: str, multi_pod: Optional[bool] = None,
               extra_tags=None, cfg_override=None, label=None,
               correct_scan: bool = True, extra_specs_fn=None,
               optimizer_override=None, remat: bool = True,
               donate: bool = False) -> dict:
    """The reference's record of one (arch, shape): status, FLOPs and
    bytes of the step a chip runs, its collectives, its roofline terms and
    dominant term, the model FLOPs (6ND / 2ND) and their share of the
    traced FLOPs over all chips, the memory a chip holds and the trace's
    seconds. ``multi_pod`` None traces for one H100 ("1xH100"); False and
    True on the reference's production meshes, 16x16 and 2x16x16, as rank
    0 of a ``fake`` process group of 256 or 512 ranks (``fake_group``;
    none may be open), with ``extra_specs_fn``'s activation specs.
    ``correct_scan`` and ``donate`` change nothing (the trace sees every
    block; decode writes its caches in place); ``remat`` is the train
    step's."""
    cfg = cfg_override or registry.get(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": label or arch, "shape": shape_name,
           "mesh": MESH if multi_pod is None else mesh_name(multi_pod),
           **(extra_tags or {})}
    ok, reason = api.supports_shape(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    optimizer = optimizer_override or (
        "adafactor" if arch in ADAFACTOR_ARCHS else "adamw")
    if shape.kind == "train":
        rec["optimizer"] = optimizer
    try:
        if multi_pod is None:
            chips = 1
            counter, t_lower = _trace_one(cfg, shape, optimizer, remat)
        else:
            chips = 512 if multi_pod else 256
            with fake_group(chips):
                counter, t_lower = trace_sharded(
                    cfg, shape, trace_mesh(multi_pod), optimizer, remat,
                    extra_specs_fn)
        coll = (rl.collective_bytes(counter.op_collective_bytes)
                if multi_pod is not None else {})
        flops, hbm = float(counter.flops), float(counter.bytes)
        terms = rl.roofline_terms(flops, hbm, coll)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mf = rl.model_flops(cfg, tokens, train=shape.kind == "train")
        rec.update(
            status="ok", flops_per_chip=flops, hbm_bytes_per_chip=hbm,
            collectives=coll, **terms, dominant=rl.dominant(terms),
            model_flops_total=mf,
            useful_flops_ratio=(mf / (flops * chips)) if flops else None,
            memory=counter.memory(), lower_s=round(t_lower, 1),
            compile_s=0.0)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def cohort_dryrun(multi_pod: bool) -> dict:
    """Trace the paper's distributed FEEL round (DESIGN.md §3) as one rank
    of the production mesh — per-client local SGD, then the masked
    weighted sum, K1 and the hierarchical ``all_reduce`` — at the
    reference's setting: the MLP, 256 samples a client, lr 0.1, 5 local
    steps, one client a rank of the client axes (16 or 32 clients). Starts
    a ``fake`` process group of 256 or 512 ranks and destroys it before
    returning, so a process runs one of these at a time."""
    from repro_torch.federated.distributed import (cohort_input_specs,
                                                   make_cohort_step)
    from repro_torch.models.mlp import mlp_init, mlp_loss
    axes = ("pod", "data") if multi_pod else ("data",)
    rec = {"arch": "feel-cohort-mlp", "shape": None,
           "mesh": mesh_name(multi_pod)}
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            n_clients = math.prod(mesh_shape(mesh).shape[a] for a in axes)
            rec["shape"] = f"clients_{n_clients}"
            params = mlp_init(common.MetaGenerator(), device="meta")
            batch, weights, select = cohort_input_specs(
                mesh, n_clients, {"x": ((256, 784), torch.float32),
                                  "y": ((256,), torch.int64)}, axes)
            step = make_cohort_step(mesh, mlp_loss, lr=0.1, local_steps=5,
                                    client_axes=axes)
            t0 = wall_clock()
            counter = count_step(step, (params, batch, weights, select))
            t_lower = wall_clock() - t0
            coll = rl.collective_bytes(counter.op_collective_bytes)
            flops, hbm = float(counter.flops), float(counter.bytes)
            terms = rl.roofline_terms(flops, hbm, coll)
            rec.update(status="ok", collectives=coll, **terms,
                       dominant=rl.dominant(terms), flops_per_chip=flops,
                       hbm_bytes_per_chip=hbm, memory=counter.memory(),
                       lower_s=round(t_lower, 1), compile_s=0.0)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def print_rec(rec):
    if rec.get("status") == "ok":
        useful = rec.get("useful_flops_ratio")
        print(f"[ok]   {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s "
              f"collective={rec['collective_s']:.3e}s dom={rec['dominant']} "
              f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
              + (f"useful={useful:.3f} " if useful is not None else "")
              + f"(trace {rec.get('lower_s', '-')}s)")
    elif rec.get("status") == "skipped":
        print(f"[skip] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"{rec['reason']}")
    else:
        print(f"[ERR]  {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"{rec.get('error')}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default=None,
                    help="the production mesh: 16x16 (single), 2x16x16 "
                         "(multi) or both; without it the zoo is traced "
                         "for one H100 and --cohort on 16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cohort", action="store_true",
                    help="the distributed FEEL round on the production "
                         "mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-correction", action="store_true",
                    help="accepted, changes nothing: the trace sees every "
                         "block, so there is no scan-trip correction")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    meshes = {None: [None], "single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.cohort:
        jobs = [("cohort", None, bool(mp)) for mp in meshes]
    else:
        archs = (registry.list_archs() if (args.all or not args.arch)
                 else [args.arch])
        shapes = (list(SHAPES) if (args.all or not args.shape)
                  else [args.shape])
        jobs = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    for a, s, mp in jobs:
        if a == "cohort":
            rec = cohort_dryrun(mp)
        else:
            name = MESH if mp is None else mesh_name(mp)
            if (a, s, name) in done and not args.force:
                continue
            rec = lower_pair(a, s, mp, correct_scan=not args.no_correction)
        print_rec(rec)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"])
                   != (rec["arch"], rec["shape"], rec["mesh"])]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"\n{len(results)} records, {n_err} errors -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
