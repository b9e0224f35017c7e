"""Training launcher of the zoo (the JAX package's ``launch/train.py``):
builds the config, its train state and, with ``--host-mesh`` or
``--multi-pod``, a mesh that shards the state; runs the train step on the
launcher's synthetic token batches, and checkpoints.

    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --steps 100
    python -m repro_torch.launch.train --arch yi-34b --smoke --steps 4 \\
        --ckpt /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train --arch mamba2-370m --smoke \\
        --device cpu                           # without a GPU
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-moe-a2.7b --smoke --host-mesh --device cpu

The flags and the lines printed are the reference's. Without a mesh flag
the run is on one device, ``--device`` (default ``cuda``, which raises
without CUDA), and the first line names the device; the reference's
default is its 16x16 production mesh, which no single machine holds
(ROADMAP P19). ``--host-mesh`` builds ``launch.mesh.make_host_mesh()``
("data" over every rank, "model" 1) over the process group: the one the
caller started, else the one ``torchrun``'s environment describes, else
a group of one (NCCL on ``cuda``, gloo on ``cpu``, over an in-memory
store: no file, no port). ``--multi-pod`` builds the 2x16x16 production
mesh and raises unless the group has 512 ranks. On a mesh the params and
the optimizer state are ``DTensor``s placed by ``sharding.specs``'
``param_specs`` and ``opt_state_specs``, and each batch by (the data
axes, None) (``sharding.dtensor.place``); the first line prints the mesh,
as the reference's does. The step is ``launch/steps.py``'s, run inside
``sharding.dtensor.sharded``: each operator on the local shards (K3, K5
and K6 under their DTensor rules), the gradient norm an all-reduce,
nothing read to the host.
The optimizer is the reference's policy (Adafactor for
``launch.mesh.ADAFACTOR_ARCHS``, else AdamW) unless ``--optimizer`` names
one, and remat is on unless ``--smoke``.

With ``--ckpt`` the run restores the latest checkpoint there (the
reference's layout, ``checkpoint/io.py``) and saves one every
``--ckpt-every`` steps. On a mesh every rank gathers the full tensors and
rank 0 writes them, in the same layout, and a restore places them again
by the specs: a checkpoint crosses between a mesh and one device either
way. A restored run resumes the batch stream where the checkpoint left it
(the reference's restarts it at its first batch), so that a run resumed
from step k sees the batches the uninterrupted run saw after step k
(ROADMAP P14). ``main`` returns the run's per-step metrics (device
tensors, ``DTensor``s on a mesh) and its final state, for callers that
drive it in-process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.data.tokens import batches, make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (ADAFACTOR_ARCHS, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.obs.clock import wall_clock
from repro_torch.random import PRNGKey
from repro_torch.sharding.dtensor import full, is_dtensor, place, sharded
from repro_torch.sharding.specs import (MeshShape, data_axes,
                                        opt_state_specs, param_specs)


@contextlib.contextmanager
def process_group(device: torch.device):
    """The default process group: the caller's where one is open, else
    the one ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) describes, else a group of one over an in-memory
    store; a group opened here is destroyed on leaving."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_mesh(args, device: torch.device):
    """The ``DeviceMesh`` of ``--host-mesh`` or ``--multi-pod``."""
    import torch.distributed as dist
    if args.multi_pod:
        mesh = make_production_mesh(multi_pod=True, device_type=device.type)
        if isinstance(mesh, MeshShape):
            raise SystemExit(
                f"--multi-pod needs a process group of 512 ranks (the "
                f"2x16x16 mesh); this one has {dist.get_world_size()}")
        return mesh
    mesh = make_host_mesh(device_type=device.type)
    if isinstance(mesh, MeshShape):
        raise SystemExit(f"--host-mesh: no mesh over the group's "
                         f"{dist.get_world_size()} ranks")
    return mesh


def main(argv=None, cfg=None):
    """The CLI's run; ``cfg``, given, is trained in place of ``--arch``'s
    config (``--arch`` still names the optimizer policy): a caller in
    process may cut a config's depth."""
    ap = argparse.ArgumentParser(
        description="Train an arch of the zoo on one device, or sharded "
                    "over a mesh (--host-mesh, --multi-pod).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config variant")
    ap.add_argument("--host-mesh", action="store_true",
                    help="a (data, model) mesh over the process group's "
                         "ranks (a group of one without torchrun)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (512 ranks)")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch (smoke runs)")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda, which "
                         "raises without CUDA)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = cfg or registry.get(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(registry.reduced(cfg), dtype="float32")
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec archs: the launcher's batches carry "
                         "tokens only, no source frames")
    shape = SHAPES[args.shape]
    B = args.batch or shape.global_batch
    S = args.seq or shape.seq_len

    opt_name = args.optimizer or (
        "adafactor" if args.arch in ADAFACTOR_ARCHS else "adamw")
    tcfg = TrainConfig(optimizer=opt_name, lr=args.lr, remat=not args.smoke)
    if not (args.host_mesh or args.multi_pod):
        print(f"device {device}  arch {cfg.name}  batch {B} seq {S}  "
              f"opt {opt_name}")
        return _run(args, cfg, tcfg, device, B, S, None)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    with process_group(device):
        mesh = build_mesh(args, device)
        _say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}  arch "
             f"{cfg.name}  batch {B} seq {S}  opt {opt_name}")
        return _run(args, cfg, tcfg, device, B, S, mesh)


def _say(line: str) -> None:
    """Print ``line`` on rank 0 of the process group (or without one)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line)


def _value(x) -> float:
    return float(x.full_tensor() if is_dtensor(x) else x)


def _run(args, cfg, tcfg, device, B, S, mesh):
    """The training loop, on one device (``mesh`` None) or on ``mesh``."""
    import torch.distributed as dist
    params, opt_state, step = init_state(cfg, tcfg, PRNGKey(0, device),
                                         device=device)
    stream = make_stream(max(200_000, 2 * B * S), cfg.vocab_size, seed=0)
    it = batches(stream, B, S, np.random.default_rng(0))
    if args.ckpt:
        state, meta = restore(args.ckpt, (params, opt_state, step))
        if state is not None:
            params, opt_state, step = state
            _say(f"restored step {meta['step']}")
            for _ in range(meta["step"]):
                next(it)
    run = contextlib.nullcontext
    if mesh is not None:
        pspecs = param_specs(cfg, params, mesh)
        ospecs = opt_state_specs(tcfg.optimizer, params, pspecs, mesh)
        params = place(params, pspecs, mesh)
        opt_state = place(opt_state, ospecs, mesh)
        dax = data_axes(mesh)
        bspec = {"tokens": (dax if len(dax) > 1 else dax[0], None)}
        run = sharded

    train_step = make_train_step(cfg, tcfg)
    history = []
    t0 = wall_clock()
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(next(it)["tokens"]).to(
            device, torch.int64)}
        if mesh is not None:
            batch = place(batch, bspec, mesh)
        with run():
            params, opt_state, step, m = train_step(params, opt_state, step,
                                                    batch)
        history.append(m)
        if i % 10 == 0 or i == args.steps - 1:
            _say(f"step {int(step):6d} loss={_value(m['loss']):.4f} "
                 f"({(wall_clock()-t0)/(i+1):.2f}s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            state = (full(params), full(opt_state), step)
            if mesh is None or dist.get_rank() == 0:
                save(args.ckpt, int(step), state)
            del state
            if mesh is not None:
                dist.barrier()
    _say("done")
    return {"metrics": history, "state": (params, opt_state, step)}


if __name__ == "__main__":
    main()
