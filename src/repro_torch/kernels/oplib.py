"""The port's kernels as operators of torch's dispatcher, namespace
``repro_torch`` (``torch.ops.repro_torch.<name>``).

Each kernel module defines its forward primitive here with ``define``:
the ``CUDA`` implementation is the module's kernel launch (the only route
of a CUDA tensor, which still counts its launches), the ``CPU`` one its
plain PyTorch version, and the fake one (``torch.library.register_fake``,
which also serves ``meta`` tensors) makes the outputs' shapes and dtypes
and computes nothing. A tensor on any other device has no implementation
and the dispatcher raises. So a step traced on ``meta`` tensors, or run
under a ``TorchDispatchMode``, sees each kernel as one operator, and
``torch.utils.flop_counter.FlopCounterMode`` counts its FLOPs by the
module's own ``cost`` formula (registered here); ``COSTS`` keeps the same
formula for the bytes (``launch/dryrun.py``).

The operators are defined with ``torch.library.Library``'s ``define`` and
``impl``, the dispatcher's lowest Python layer, and carry no autograd
formula: the modules' ``torch.autograd.Function``s call them inside their
forward, where autograd is off. No kernel is built here: a CUDA
implementation builds its kernel at its first launch.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
# the op's overload packet -> cost(*the op's arguments) -> (flops, bytes)
COSTS: Dict[object, Callable[..., Tuple[float, float]]] = {}


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable, cost: Callable) -> torch._ops.OpOverload:
    """Define ``repro_torch::<name><schema>`` with its three
    implementations and its cost; returns the operator's default
    overload, the callable the module's wrapper calls. The modules pass
    for ``cuda`` a lambda that looks up their ``_kernel`` at each call, so
    that a check which puts a plain version in its place on the card
    (``chip_smoke.plain_route``) reaches the operator too."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    COSTS[packet] = cost

    @register_flop_formula(packet, get_raw=True)
    def _flops(*args, out_val=None, **kwargs):
        return int(cost(*args, **kwargs)[0])

    return packet.default
