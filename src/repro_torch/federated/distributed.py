"""FEEL mapped onto a device mesh (DESIGN.md §3): the torch.distributed
expression of the paper's per-round communication pattern.

Each rank hosts a contiguous block of cohort clients along the mesh's
client axes (``client_slice``); a rank's coordinate on the other axes
(``model``) makes it a replica. It trains a local replica of the model for
each of its clients, ``local_steps`` full-batch SGD steps, then the
round's FedAvg aggregation (Alg. 1 line 13) is a masked, size-weighted
sum over the client axes — with the DQS selection vector ``x_k`` as the
mask, so an unscheduled client contributes exactly nothing, like a UE that
missed the deadline. On the multi-pod mesh aggregation is hierarchical:
an ``all_reduce`` over the ``data`` group (within a pod) then over the
``pod`` group, mirroring BS -> MEC -> cloud edge aggregation.

The rank's own weighted sum is one launch of ``kernels.weighted_aggregate``
(K1) over its clients' flattened updates (``aggregation.flatten_stacked``);
the collectives are ``torch.distributed``'s.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.federated.aggregation import flatten_stacked, unflatten
from repro_torch.kernels.weighted_aggregate import weighted_aggregate
from repro_torch.sharding.specs import mesh_shape

Params = Dict[str, torch.Tensor]


def _n_local(mesh, n_clients: int, client_axes) -> int:
    count = math.prod(mesh_shape(mesh).shape[a] for a in client_axes)
    if n_clients % count:
        raise ValueError(f"{n_clients} clients do not split over the "
                         f"{count} ranks of the client axes {client_axes}")
    return n_clients // count


def client_slice(mesh, n_clients: int,
                 client_axes: Tuple[str, ...] = ("data",)) -> slice:
    """This rank's clients among ``n_clients``: the blocks go along the
    client axes in mesh order, as the reference's ``shard_map`` over
    ``P(client_axes)`` deals them."""
    n = _n_local(mesh, n_clients, client_axes)
    sizes = mesh_shape(mesh).shape
    block = 0
    for a in client_axes:
        block = block * sizes[a] + mesh.get_local_rank(a)
    return slice(block * n, (block + 1) * n)


def make_cohort_step(mesh, loss_fn: Callable, lr: float, local_steps: int,
                     client_axes: Tuple[str, ...] = ("data",),
                     agg_dtype=None):
    """Build the distributed FEEL round step, ``step(params, batch,
    weights, select) -> params``, run on every rank of the
    ``DeviceMesh`` ``mesh`` (SPMD).

    loss_fn(params, batch) -> scalar for one client. Each rank passes its
    own clients (``client_slice``): batch leaves (n_local, ...), and
    ``weights`` and ``select`` (n_local,) float; params are the same on
    every rank, and the aggregate comes back on every rank in each
    param's dtype.

    The local SGD runs the rank's clients at once
    (``torch.func.vmap(torch.func.grad(loss_fn))``), each step
    ``p <- (p.float() - lr * g.float()).to(p.dtype)``. K1 then gives the
    rank's raw sum of w_i s_i x_i (float32, in client order); the sum of
    w_i s_i rides as one more element of the same buffer, which is cast to
    ``agg_dtype`` (float32 if None) and summed by ``all_reduce`` over the
    innermost client axis's group, then over each outer one. The quotient
    by ``max(wsum, 1e-9)`` is taken on the device in float32 after the
    collective; nothing reads a value back to the host.

    With one client a rank the casts are the reference's exactly (each
    client's product rounded to ``agg_dtype``, the weight sum too). With
    several, the rank's partial sum is float32 before the one cast.
    """
    sizes = mesh_shape(mesh).shape
    for a in client_axes:
        if a not in sizes:
            raise ValueError(f"client axis {a!r} is not an axis of the mesh "
                             f"{tuple(sizes)}")
    groups = [mesh.get_group(a) for a in client_axes]
    grad = torch.func.vmap(torch.func.grad(loss_fn))
    dtype = agg_dtype or torch.float32

    def local_sgd(params: Params, batch, n: int) -> Params:
        local = {k: v.expand(n, *v.shape) for k, v in params.items()}
        for _ in range(local_steps):
            g = grad(local, batch)
            local = {k: (p.float() - lr * g[k].float()).to(p.dtype)
                     for k, p in local.items()}
        return local

    def step(params: Params, batch, weights: torch.Tensor,
             select: torch.Tensor) -> Params:
        w = (weights * select).to(torch.float32)
        local = local_sgd(params, batch, w.shape[0])
        part = weighted_aggregate(flatten_stacked(local), w,
                                  assume_normalized=True)
        buf = torch.cat([part, w.sum().reshape(1)]).to(dtype)
        for group in reversed(groups):        # innermost axis first
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf = buf.to(torch.float32)
        return unflatten(buf[:-1] / torch.clamp_min(buf[-1], 1e-9), params)

    return step


def cohort_input_specs(mesh, n_clients: int, batch_shapes: dict,
                       client_axes: Tuple[str, ...] = ("data",)):
    """One rank's step inputs as ``meta`` tensors (the dry run's):
    ``batch_shapes`` maps a batch key to (one client's shape, dtype);
    returns (batch with leaves (n_local, *shape), the (n_local,) float32
    weights, select likewise: a tensor of its own, as in a real step, so
    that a trace reads both)."""
    n = _n_local(mesh, n_clients, client_axes)
    batch = {k: torch.empty((n, *s), dtype=d, device="meta")
             for k, (s, d) in batch_shapes.items()}
    weights, select = (torch.empty((n,), dtype=torch.float32, device="meta")
                       for _ in range(2))
    return batch, weights, select
