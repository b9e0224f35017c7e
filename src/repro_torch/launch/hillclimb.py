"""Perf hillclimbing on one device: dry-run named variants of one
(arch x shape) pair and record each beside the others.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch mamba2-370m --shape train_4k \\
        --variants baseline,chunk128,ssd_bf16 --out results/perf_torch.json

The counterpart of the JAX package's ``launch/hillclimb.py``, over
``launch/dryrun.lower_pair`` (a meta trace of the step, no device).
Variants (composable with '+', e.g. ssd_bf16+chunk128), the reference's
config changes:

  baseline       the sweep configuration, unchanged
  chunk<q>       SSD chunk-length override (chunk64, chunk128, chunk512)
  ssd_bf16       the SSD's intra-chunk products in bf16 (ssm.compute_dtype)
  bf16_opt       momentum instead of the arch's optimizer   [train shapes]
  f32_params     float32 parameters
  pad_vocab      the vocabulary padded to a multiple of 256
  remat_off      no activation rematerialisation            [train shapes]
  moe_local<g>   group-local MoE dispatch, g groups (moe.dispatch_groups);
                 the reference also pins its activations to the mesh
                 (``moe_local``, ``moe_disp4a``, ...: the port's MoE names
                 them, ``sharding.ctx``), which needs the zoo's sharded
                 steps (ROADMAP Queue 1 item 1)
  donate         recorded, changes nothing: the port's decode step already
                 writes its caches in place
  moe_disp       a "skipped" record: it pins the dispatch buffer to the
                 expert sharding, which needs the zoo's sharded steps

``remat_off`` and ``donate`` reach ``lower_pair`` as arguments of their
own variant only; the reference sets environment variables that stay set
for every later variant of the same call (ROADMAP R8). An unknown name
raises ``KeyError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

from repro_torch.configs import registry
from repro_torch.launch.dryrun import MESH, SHARDED, lower_pair, print_rec


def apply_variant(name: str, cfg, kwargs: dict):
    """(cfg, ``lower_pair`` kwargs) for one atomic variant: returns the
    config and updates ``kwargs`` in place (``"skip"``: the reason the
    variant cannot run here)."""
    if name == "baseline":
        return cfg
    if name == "moe_disp":
        kwargs["skip"] = f"moe_disp pins the MoE dispatch to the expert " \
                         f"sharding: {SHARDED}"
        return cfg
    if name.startswith("chunk"):
        q = int(name[len("chunk"):])
        if cfg.ssm is None:
            raise ValueError("chunk variant needs an SSM config")
        return dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=q))
    if name == "ssd_bf16":
        if cfg.ssm is None:
            raise ValueError("ssd_bf16 variant needs an SSM config")
        return dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, compute_dtype="bfloat16"))
    if name.startswith("moe_local"):
        g = int(name[len("moe_local"):])
        if cfg.moe is None:
            raise ValueError("moe_local variant needs a MoE config")
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=g))
    if name == "bf16_opt":
        kwargs["optimizer_override"] = "momentum"
        return cfg
    if name == "f32_params":
        return dataclasses.replace(cfg, dtype="float32")
    if name == "pad_vocab":
        v = ((cfg.vocab_size + 255) // 256) * 256
        return dataclasses.replace(cfg, vocab_size=v)
    if name == "donate":
        kwargs["donate"] = True
        return cfg
    if name == "remat_off":
        kwargs["remat"] = False
        return cfg
    raise KeyError(f"unknown variant '{name}'")


def run_variant(arch: str, shape: str, variant: str) -> dict:
    """One variant's record: its atoms applied to a fresh config and fresh
    arguments, then ``lower_pair`` (or a skipped record)."""
    cfg = registry.get(arch)
    kwargs: dict = {}
    for atom in variant.split("+"):
        cfg = apply_variant(atom, cfg, kwargs)
    skip = kwargs.pop("skip", None)
    if skip is not None:
        return {"arch": arch, "shape": shape, "mesh": MESH,
                "variant": variant, "status": "skipped", "reason": skip}
    return lower_pair(arch, shape, extra_tags={"variant": variant},
                      cfg_override=cfg, **kwargs)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true",
                    help="waits for the zoo's sharded steps (ROADMAP "
                         "Queue 1 item 1)")
    ap.add_argument("--out", default="results/perf_torch.json")
    args = ap.parse_args(argv)
    if args.multi_pod:
        print(f"hillclimb: --multi-pod is not ported: {SHARDED}",
              file=sys.stderr)
        return 2

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for variant in args.variants.split(","):
        rec = run_variant(args.arch, args.shape, variant)
        print_rec(rec)
        results = [r for r in results
                   if (r["arch"], r["shape"], r.get("variant"), r["mesh"])
                   != (rec["arch"], rec["shape"], variant, rec["mesh"])]
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 1 if any(r.get("status") == "error" for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
