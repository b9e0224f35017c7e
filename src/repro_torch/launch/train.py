"""Training launcher of the zoo on one device (the JAX package's
``launch/train.py``): builds the config and its train state, runs the
train step on the launcher's synthetic token batches, and checkpoints.

    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --steps 100
    python -m repro_torch.launch.train --arch yi-34b --smoke --steps 4 \\
        --ckpt /tmp/ck --ckpt-every 2
    python -m repro_torch.launch.train --arch mamba2-370m --smoke \\
        --device cpu                           # without a GPU

The flags and the lines printed are the reference's; the first line names
the device where the reference's names its mesh. The reference's
``--host-mesh`` and ``--multi-pod`` and its sharding of the state
(``sharding.specs``' rules, ``launch.mesh``'s meshes) are ROADMAP Queue 1
item 2: this launcher runs on one device, ``--device`` (default ``cuda``,
which raises without CUDA).
The optimizer is the reference's policy (Adafactor for
``launch.mesh.ADAFACTOR_ARCHS``, else AdamW) unless ``--optimizer`` names
one, and remat is on unless ``--smoke``.

With ``--ckpt`` the run restores the latest checkpoint there (the
reference's layout, ``checkpoint/io.py``) and saves one every
``--ckpt-every`` steps. A restored run resumes the batch stream where the
checkpoint left it (the reference's restarts it at its first batch), so
that a run resumed from step k sees the batches the uninterrupted run saw
after step k (ROADMAP P14). ``main`` returns the run's per-step metrics
(device tensors) and its final state, for callers that drive it
in-process.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.data.tokens import batches, make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ADAFACTOR_ARCHS
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.obs.clock import wall_clock


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train an arch of the zoo on one device. The "
                    "reference's --host-mesh / --multi-pod and its sharded "
                    "state are ROADMAP Queue 1 item 2.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config variant")
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
    cfg = registry.get(args.arch)
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
    print(f"device {device}  arch {cfg.name}  batch {B} seq {S}  "
          f"opt {opt_name}")

    params, opt_state, step = init_state(cfg, tcfg, 0, device=device)
    stream = make_stream(max(200_000, 2 * B * S), cfg.vocab_size, seed=0)
    it = batches(stream, B, S, np.random.default_rng(0))
    if args.ckpt:
        state, meta = restore(args.ckpt, (params, opt_state, step))
        if state is not None:
            params, opt_state, step = state
            print(f"restored step {meta['step']}")
            for _ in range(meta["step"]):
                next(it)

    train_step = make_train_step(cfg, tcfg)
    history = []
    t0 = wall_clock()
    for i in range(args.steps):
        tokens = torch.from_numpy(next(it)["tokens"]).to(device, torch.int64)
        params, opt_state, step, m = train_step(params, opt_state, step,
                                                {"tokens": tokens})
        history.append(m)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {int(step):6d} loss={float(m['loss']):.4f} "
                  f"({(wall_clock()-t0)/(i+1):.2f}s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(args.ckpt, int(step), (params, opt_state, step))
    print("done")
    return {"metrics": history, "state": (params, opt_state, step)}


if __name__ == "__main__":
    main()
