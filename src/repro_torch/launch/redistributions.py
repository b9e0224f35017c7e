"""Where a sharded step's collectives come from: the dry run's trace of one
(arch, shape) on the 16x16 (or 2x16x16) production mesh, with each
collective's bytes charged to the place in the port that issued it.

    PYTHONPATH=src python -m repro_torch.launch.redistributions \\
        --arch qwen2-moe-a2.7b --shape train_4k [--multi-pod]

The places are the models' steps off DTensor's own operators
(``sharding/dtensor.py``): the MoE dispatch's all-gathers
(``replicated_local``), the heads' splits (``heads_ready``, and
``merged_heads`` in the backward), the cross-entropy's reduce
(``reduced``), the embedding lookup (``embed_lookup``), the plain VJPs
of K3 and K6 (``local_vjp``) and a decode step's attention over a
sequence-sharded cache (``attention.attn_decode``: its all-gather of the
cache before K4, and its cache write); everything else is DTensor's own
redistribution inside an operator ("dtensor"). Prints one JSON object:
the bytes each place's collectives hold by kind, and the record's
totals. Run as one process of its own (the fake process group is global
to its process).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import sys
from typing import Optional

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import ADAFACTOR_ARCHS

# (module, name) of each place, charged under its name
PLACES = (("repro_torch.sharding.dtensor", "replicated_local"),
          ("repro_torch.sharding.dtensor", "heads_ready"),
          ("repro_torch.sharding.dtensor", "reduced"),
          ("repro_torch.sharding.dtensor", "embed_lookup"),
          ("repro_torch.sharding.dtensor", "local_vjp"),
          ("repro_torch.models.attention", "attn_decode"))


@contextlib.contextmanager
def charged(sites: list):
    """Every place of ``PLACES``, in every module that imported it, wrapped
    to push its name on ``sites`` while it runs (the innermost wins)."""
    patched = []
    for module, name in PLACES:
        fn = getattr(sys.modules[module], name)

        @functools.wraps(fn)
        def run(*args, _fn=fn, _name=name, **kwargs):
            sites.append(_name)
            try:
                return _fn(*args, **kwargs)
            finally:
                sites.pop()
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("repro_torch") and \
                    getattr(mod, name, None) is fn:
                patched.append((mod, name, fn))
                setattr(mod, name, run)
    try:
        yield
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def attribute(arch: str, shape_name: str, multi_pod: bool = False) -> dict:
    """{place: {collective kind: bytes}} of one traced step, and the
    totals."""
    import repro_torch.models.attention  # noqa: F401  (a place)
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    optimizer = "adafactor" if arch in ADAFACTOR_ARCHS else "adamw"
    sites: list = []
    by_site = collections.defaultdict(collections.Counter)
    count = dryrun.StepCounter._count

    def charge(self, func, args, kwargs, out):
        before = dict(self.op_collective_bytes)
        count(self, func, args, kwargs, out)
        for op, n in self.op_collective_bytes.items():
            if n != before.get(op, 0):
                by_site[sites[-1] if sites else "dtensor"][op] += \
                    n - before.get(op, 0)
    dryrun.StepCounter._count = charge
    try:
        with dryrun.fake_group(512 if multi_pod else 256), charged(sites):
            counter, _ = dryrun.trace_sharded(
                cfg, shape, dryrun.trace_mesh(multi_pod), optimizer)
    finally:
        dryrun.StepCounter._count = count
    return {"arch": arch, "shape": shape_name,
            "mesh": dryrun.mesh_name(multi_pod),
            "by_place": {k: {kind: n for kind, n in
                             rl.collective_bytes(v).items() if n}
                         for k, v in sorted(by_site.items())},
            "collectives": rl.collective_bytes(counter.op_collective_bytes),
            "peak_bytes": counter.memory()["peak_bytes"]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(attribute(args.arch, args.shape, args.multi_pod)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
