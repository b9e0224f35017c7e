"""Perf hillclimbing: dry-run named variants of one (arch x shape) pair
and record each beside the others.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch mamba2-370m --shape train_4k \\
        --variants baseline,chunk128,ssd_bf16 --out results/perf_torch.json
    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen2-moe-a2.7b --shape train_4k \\
        --variants baseline,moe_disp,moe_local4 --multi-pod

The counterpart of the JAX package's ``launch/hillclimb.py``, over
``launch/dryrun.lower_pair`` (a meta trace of the step, no device).
Variants (composable with '+', e.g. ssd_bf16+chunk128), the reference's
changes:

  baseline       the sweep configuration, unchanged
  chunk<q>       SSD chunk-length override (chunk64, chunk128, chunk512)
  ssd_bf16       the SSD's intra-chunk products in bf16 (ssm.compute_dtype)
  bf16_opt       momentum instead of the arch's optimizer   [train shapes]
  f32_params     float32 parameters
  pad_vocab      the vocabulary padded to a multiple of 256
  remat_off      no activation rematerialisation            [train shapes]
  moe_disp       pins the MoE dispatch buffer and hidden activations to
                 the experts' sharding ("moe_disp", "moe_hidden")
  moe_local<g>   group-local MoE dispatch, g groups (moe.dispatch_groups),
                 with the group-local names pinned ("moe_disp4a",
                 "moe_disp4", "moe_hidden4", "moe_out4", "moe_local")
  donate         recorded, changes nothing: the port's decode step already
                 writes its caches in place

The MoE variants' specs are the reference's, written for the layouts the
port's ``models/moe.py`` gives those names (its docstring): the
reference's group-local buffer is (G, E, C, ·), the port's (E, G·C, ·), so
its "moe_disp4a" (G over the data axes, E over "model") is here (E over
"model", G·C over the data axes); the others have the same layout in
both. A variant that sets specs needs a mesh: it traces on the
reference's 16x16 pod (``lower_pair(multi_pod=False)``), where the specs
take effect; ``--multi-pod`` puts every variant on 2x16x16. Every other
variant keeps the one-device trace ("1xH100"; the reference's default
is 16x16, ROADMAP P19).

``remat_off`` and ``donate`` reach ``lower_pair`` as arguments of their
own variant only; the reference sets environment variables that stay set
for every later variant of the same call (ROADMAP R8). An unknown name
raises ``KeyError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Optional

from repro_torch.configs import registry
from repro_torch.launch.dryrun import lower_pair, print_rec
from repro_torch.sharding.specs import data_axes, mesh_shape


def _experts_axis(mesh, cfg):
    """The experts' mesh axes: every axis where E divides the mesh (the
    reference's test), else "model"."""
    ms = mesh_shape(mesh)
    if cfg.moe.n_routed % math.prod(ms.sizes) == 0:
        return (*data_axes(mesh), "model")
    return "model"


def _data_axis(mesh):
    dax = data_axes(mesh)
    return dax if len(dax) > 1 else dax[0]


def moe_disp_specs(mesh, cfg) -> dict:
    """The reference's ``_moe_disp_specs``: the dispatch buffer (E, C, d)
    and the hidden activations (E, C, f) by expert, and f over the data
    axes where the experts cannot take them."""
    if cfg.moe is None:
        return {}
    e_ax = _experts_axis(mesh, cfg)
    if e_ax != "model":
        return {"moe_disp": (e_ax, None, None),
                "moe_hidden": (e_ax, None, None)}
    return {"moe_disp": ("model", None, None),
            "moe_hidden": ("model", None, _data_axis(mesh))}


def moe_local_specs(mesh, cfg) -> dict:
    """The reference's group-local specs in the port's layouts: tokens
    (G, T·K, d), buffer, hidden and output (E, G·C, ·)."""
    e_ax = _experts_axis(mesh, cfg)
    dx = _data_axis(mesh)
    return {"moe_disp4a": ("model", dx, None),
            "moe_disp4": (e_ax, None, None),
            "moe_hidden4": (e_ax, None, None),
            "moe_out4": (e_ax, None, None),
            "moe_local": (dx, None, "model")}


def _add_specs(kwargs: dict, fn) -> None:
    """Chain ``fn`` after the variant's earlier ``extra_specs_fn``."""
    prev = kwargs.get("extra_specs_fn")

    def specs(mesh, cfg, prev=prev):
        out = dict(prev(mesh, cfg) or {}) if prev else {}
        out.update(fn(mesh, cfg))
        return out
    kwargs["extra_specs_fn"] = specs


def apply_variant(name: str, cfg, kwargs: dict):
    """(cfg, ``lower_pair`` kwargs) for one atomic variant: returns the
    config and updates ``kwargs`` in place."""
    if name == "baseline":
        return cfg
    if name == "moe_disp":
        _add_specs(kwargs, moe_disp_specs)
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
        _add_specs(kwargs, moe_local_specs)
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


def run_variant(arch: str, shape: str, variant: str,
                multi_pod: bool = False) -> dict:
    """One variant's record: its atoms applied to a fresh config and fresh
    arguments, then ``lower_pair``: on 2x16x16 with ``multi_pod``, else on
    16x16 for a variant that sets activation specs, else for one
    device."""
    cfg = registry.get(arch)
    kwargs: dict = {}
    for atom in variant.split("+"):
        cfg = apply_variant(atom, cfg, kwargs)
    mesh = True if multi_pod else (
        False if "extra_specs_fn" in kwargs else None)
    return lower_pair(arch, shape, mesh, extra_tags={"variant": variant},
                      cfg_override=cfg, **kwargs)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true",
                    help="every variant on the 2x16x16 production mesh")
    ap.add_argument("--out", default="results/perf_torch.json")
    args = ap.parse_args(argv)

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for variant in args.variants.split(","):
        rec = run_variant(args.arch, args.shape, variant, args.multi_pod)
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
