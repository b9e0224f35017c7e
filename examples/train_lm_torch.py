"""End-to-end LM training driver on the PyTorch/CUDA port
(``examples/train_lm.py`` on ``repro_torch``): any assigned architecture
family at reduced scale, or a ~100M dense preset, on synthetic token
streams with the full substrate (config -> data -> optimizer ->
checkpointing).

    python examples/train_lm_torch.py --preset smoke --steps 60
    python examples/train_lm_torch.py --preset 100m --steps 300
    python examples/train_lm_torch.py --arch qwen2-moe-a2.7b --steps 40
    python examples/train_lm_torch.py --preset smoke --device cpu

(--arch trains the reduced smoke variant of that architecture's family,
in float32; --preset 100m is a 12-layer d=768 GQA decoder ~= 100M params.)
It runs on ``--device`` (default ``cuda``, which raises without CUDA).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.data.tokens import batches, make_stream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import init_state, make_train_step  # noqa: E402
from repro_torch.obs.clock import wall_clock  # noqa: E402

PRESET_100M = ModelConfig(
    name="dense-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=3072, vocab_size=32_000,
    citation="[in-repo 100M preset]")

PRESET_SMOKE = ModelConfig(
    name="dense-smoke", family="dense", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=1024, vocab_size=2_000,
    citation="[in-repo smoke preset]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch:
        cfg = dataclasses.replace(registry.reduced(registry.get(args.arch)),
                                  dtype="float32")
    elif args.preset == "100m":
        cfg = PRESET_100M
    else:
        cfg = dataclasses.replace(PRESET_SMOKE, dtype="float32")
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec archs: use the seq2seq batch layout "
                         "(see tests/test_models_smoke.py)")

    tcfg = TrainConfig(optimizer="adamw", lr=args.lr, remat=False)
    params, opt_state, step = init_state(cfg, tcfg, 0, device=device)
    n_params = sum(x.numel() for x in params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"optimizer={tcfg.optimizer}")

    stream = make_stream(200_000, cfg.vocab_size, seed=0)
    it = batches(stream, args.batch, args.seq, np.random.default_rng(0))
    if args.ckpt:
        state, meta = restore(args.ckpt, (params, opt_state, step))
        if state is not None:
            params, opt_state, step = state
            print(f"restored step {meta['step']}")
    train_step = make_train_step(cfg, tcfg)

    t0 = wall_clock()
    for i in range(args.steps):
        tokens = torch.from_numpy(next(it)["tokens"]).to(device, torch.int64)
        params, opt_state, step, m = train_step(params, opt_state, step,
                                                {"tokens": tokens})
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {int(step):5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(wall_clock()-t0)/(i+1):.2f}s/step)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(args.ckpt, int(step), (params, opt_state, step))
            print(f"checkpointed step {int(step)}")
    final = float(m["loss"])
    print(f"done: final loss {final:.4f} "
          f"({args.steps} steps, {wall_clock()-t0:.0f}s)")
    if not np.isfinite(final):
        raise SystemExit(f"non-finite final loss {final}")
    return final


if __name__ == "__main__":
    main()
