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

A module that passes ``sharding=`` gives its operator a DTensor sharding
rule: called on ``DTensor``s, the operator runs once on each rank's local
shards (the same CUDA, CPU or fake implementation, so on the card the
kernel) and its outputs come back as ``DTensor``s. The rule names, for
one mesh dim, the placements the operator accepts (see ``register_rule``);
DTensor takes every combination of them over the mesh's dims, this module
keeps those whose ``Shard``s divide their tensor dims exactly (an uneven
split of heads or groups would pair a rank's query heads with the wrong
KV heads), and DTensor redistributes an input whose placement no kept
strategy accepts, with the collectives that takes. An operator without a
rule raises on a ``DTensor``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
# the op's overload packet -> cost(*the op's arguments) -> (flops, bytes)
COSTS: Dict[object, Callable[..., Tuple[float, float]]] = {}


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable, cost: Callable,
           sharding: Optional[Callable] = None) -> torch._ops.OpOverload:
    """Define ``repro_torch::<name><schema>`` with its three
    implementations, its cost and, given one, its DTensor sharding rule
    (``register_rule``); returns the operator's default overload, the
    callable the module's wrapper calls. The modules pass for ``cuda`` a
    lambda that looks up their ``_kernel`` at each call, so that a check
    which puts a plain version in its place on the card
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

    if sharding is not None:
        register_rule(packet.default, sharding)
    return packet.default


def _evenly_split(spec) -> bool:
    """Whether every ``Shard`` of a DTensor spec divides its tensor dim
    exactly (over all the mesh dims that split it)."""
    from torch.distributed.tensor import Shard
    parts = [1] * len(spec.shape)
    for i, p in enumerate(spec.placements):
        if isinstance(p, Shard):
            parts[p.dim] *= spec.mesh.size(i)
    return all(n % k == 0 for n, k in zip(spec.shape, parts))


def _strategy(rule: Callable, n_out: int, op_schema):
    """DTensor's strategy of an operator under ``rule``: the rule's
    one-mesh-dim strategies over every mesh dim, the uneven ones left
    out."""
    from torch.distributed.tensor._op_schema import (OpStrategy,
                                                     TupleStrategy)
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    def spec(a):
        if isinstance(a, OpStrategy):
            return a.strategies[0].output_spec
        if isinstance(a, TupleStrategy):
            return tuple(spec(c) for c in a.children)
        return a
    args = [spec(a) for a in op_schema.args_schema]
    kwargs = {k: spec(v) for k, v in op_schema.kwargs_schema.items()}
    single = [list(outs) + list(ins) for outs, ins in rule(*args, **kwargs)]
    st = expand_to_full_mesh_op_strategy(op_schema.get_mesh_from_args(),
                                         op_schema, single,
                                         input_index=n_out)
    st.strategies = [s for s in st.strategies
                     if all(_evenly_split(i) for i in s.input_specs)]
    return st


def register_rule(op: torch._ops.OpOverload, rule: Callable) -> None:
    """Register ``rule`` as ``op``'s DTensor sharding rule (replacing any
    earlier one). ``rule(*args)`` is called with the operator's arguments,
    each tensor replaced by its ``DTensorSpec`` (``.shape`` is the global
    shape), and returns the strategies it accepts on one mesh dim: pairs
    (output placements, one per output; input placements, one per
    argument, ``None`` for an argument that is not a tensor). The
    arguments from the first non-tensor one on are part of DTensor's
    cache key."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    schema = op._schema
    static = next((i for i, a in enumerate(schema.arguments)
                   if "Tensor" not in str(a.type)), len(schema.arguments))
    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, functools.partial(_strategy, rule, len(schema.returns)),
        RuntimeSchemaInfo(static, needs_pytree=True))
