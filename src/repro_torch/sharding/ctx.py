"""Logical activation-sharding context.

Models call ``constrain(x, name)`` at well-known points; outside a sharding
context this is the identity, inside (set by a launcher or the dry run) a
``DTensor`` is redistributed to the placements of the spec registered for
``name`` (``specs.named``), on its own mesh. Keeps the model code
mesh-agnostic while letting the layout be pinned where it matters
(activations, MoE dispatch buffers, decode caches).

A plain tensor, and any tensor outside a context, passes through untouched:
no operator runs and no bit changes. A spec that cannot apply to a
``DTensor`` (an axis its mesh lacks, more entries than the tensor has
dims) raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

from repro_torch.sharding.specs import Spec, named

_state = threading.local()


def _specs() -> Dict[str, Spec]:
    return getattr(_state, "specs", {})


@contextlib.contextmanager
def activation_specs(specs: Dict[str, Spec]):
    old = _specs()
    _state.specs = {**old, **specs}
    try:
        yield
    finally:
        _state.specs = old


def constrain(x, name: str):
    spec = _specs().get(name)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if len(spec) > x.dim():
        raise ValueError(f"activation spec {name!r} {spec} has more entries "
                         f"than the tensor's {x.dim()} dims")
    return x.redistribute(x.device_mesh, named(x.device_mesh, spec))
