"""The zoo's steps on ``DTensor``s: placing a flat dict of tensors on a
``DeviceMesh`` by a spec dict (the JAX package's ``_sds_with`` and its
launcher's ``ns``), the context a sharded step runs in, and the few
places where a model steps off DTensor's operators onto the local
shards.

A step runs sharded when its params, optimizer state, batch and caches
are ``DTensor``s (``place``): every aten operator then runs under
DTensor's own sharding strategies, and the kernels K3–K6 under their
rules (``kernels/oplib.py``), on each rank's local shards, with the
collectives DTensor issues where a placement must change. Plain tensors
the models make on the way (positions, masks, the RoPE table) count as
replicated inside ``sharded``.

Two parts of the models do not run on DTensor's operators, and there the
``DTensor`` is redistributed to ``Replicate`` and its local tensor taken
(``replicated_local``), so that the all-gather is issued and priced:

- the MoE dispatch's routing and combine (``models/moe.py``): its sort,
  argsort, cumsum, ``scatter_add_``, ``index_copy_`` and the gathers by
  token. In torch 2.13 DTensor's ``index_copy_`` into a replicated buffer
  marks the buffer ``Shard(1)`` while its local tensor stays whole, so
  the strategies cannot be trusted there; on the replicated local
  tensors the dispatch is the plain code. The three expert products (K5)
  take the dispatch buffer back as a replicated ``DTensor``
  (``as_replicated``), so they run under K5's rule on the experts'
  shards;
- a decode step's cache write (``write_slot``): a slot of a
  sequence-sharded cache lives on one rank, which writes it in its local
  shard.

Before a view splits a sharded last dim into heads, a split of it that
does not divide the head count is undone (``heads_ready``: DTensor
refuses such a view; the reference's GSPMD pads instead), with the
all-gather that takes: yi-34b's 56 query heads over a model axis of 16,
or 4 KV heads of 128 over 16; where the forward merges heads into the
last dim, the backward's split of the gradient gets the same
(``merged_heads``). And one result is reduced as soon as it is
made (``reduced``): the
cross-entropy's gather of each label's logit from vocabulary-sharded
logits is a masked partial sum, which DTensor (torch 2.13) cannot reduce
after the ``squeeze`` that follows (its mask keeps the unsqueezed
shape).
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.sharding.specs import named


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(tree: Mapping, spec_tree: Mapping, mesh) -> dict:
    """Each tensor of the flat dict ``tree`` as a ``DTensor`` on ``mesh``
    placed by its spec in ``spec_tree`` (``specs.named``); anything else
    (a cache's host-int ``index``) as it is. Every rank holds the same
    full tensor (the same seed, or the same checkpoint) and keeps its own
    shard of it, with no collective; on ``meta`` nothing is allocated."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and not is_dtensor(v):
            v = distribute_tensor(v, mesh, named(mesh, spec_tree[k]),
                                  src_data_rank=None)
        out[k] = v
    return out


def full(tree: Mapping) -> dict:
    """The flat dict with each ``DTensor`` as its full tensor (an
    all-gather); anything else as it is."""
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in tree.items()}


@contextlib.contextmanager
def sharded():
    """The context of a step on ``DTensor``s: a plain tensor an operator
    meets beside a ``DTensor`` counts as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def replicated_local(x) -> Tuple[torch.Tensor, Optional[object]]:
    """(the full tensor of ``x`` on this rank, ``x``'s mesh): a ``DTensor``
    redistributed to ``Replicate`` (the all-gathers and all-reduces that
    takes), then its local tensor, differentiably; a plain tensor as it
    is, with no mesh."""
    if not is_dtensor(x):
        return x, None
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(), mesh


def reduced(x):
    """A ``DTensor`` with every partial placement reduced (all-reduced to
    ``Replicate``), its shards kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if isinstance(p, Partial) else p
                           for p in x.placements])


def heads_ready(x, n: int):
    """``x`` ready for its last dim to be split into ``n`` heads: a
    ``DTensor`` whose last dim is split over mesh dims whose product does
    not divide ``n`` has those mesh dims replicated (all-gathered); a
    plain tensor, or a split that divides ``n``, as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    if n % math.prod(mesh.size(i) for i in split) == 0:
        return x
    return x.redistribute(mesh, [Replicate() if i in split else p
                                 for i, p in enumerate(x.placements)])


class _GradHeadsReady(torch.autograd.Function):
    """The identity, whose backward makes the gradient ``heads_ready``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return heads_ready(g, ctx.n), None


def merged_heads(x, n: int):
    """``x``, whose last dim was merged from ``n`` heads, with its
    gradient made ``heads_ready`` for the backward's split back into
    heads (on a ``DTensor``; a plain tensor as it is)."""
    if not is_dtensor(x):
        return x
    return _GradHeadsReady.apply(x, n)


def local_vjp(vjp, mesh, args, arg_placements, grad_placements):
    """``vjp(*local args)`` on this rank's shards: each ``DTensor`` of
    ``args`` redistributed to its placements in ``arg_placements`` and
    its local tensor taken (``None`` passes through), then each gradient
    ``vjp`` returns wrapped as a ``DTensor`` on ``mesh`` with its
    placements in ``grad_placements`` (``None`` stays ``None``), made
    contiguous first: DTensor takes a local tensor's strides to be its
    global shape's, and a later view of a strided one fails."""
    from torch.distributed.tensor import DTensor
    local = [a if a is None else a.redistribute(mesh, p).to_local()
             for a, p in zip(args, arg_placements)]
    return [g if g is None else DTensor.from_local(g.contiguous(), mesh, p,
                                                   run_check=False)
            for g, p in zip(vjp(*local), grad_placements)]


class _Embed(torch.autograd.Function):
    """``embed[tokens]`` on each rank's shards, tokens split by rows (dim
    0 of each) and the table by columns: the output takes the tokens'
    splits and the table's column split on its last dim; the gradient is
    the same ``index_put`` with accumulation that ``embed[tokens]``'s own
    gradient is, on the local shards, partial where the tokens are
    split."""

    @staticmethod
    def forward(ctx, embed, tokens):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = embed.device_mesh
        tp = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in tokens.placements]
        # a mesh dim splits the tokens or the table's columns, not both
        ep = [Replicate() if isinstance(t, Shard) else e
              for t, e in zip(tp, embed.placements)]
        out_p = [Shard(0) if isinstance(t, Shard) else
                 Shard(tokens.dim()) if isinstance(e, Shard) else Replicate()
                 for t, e in zip(tp, ep)]
        local_tokens = tokens.redistribute(mesh, tp).to_local()
        local_embed = embed.redistribute(mesh, ep).to_local()
        ctx.save_for_backward(local_tokens)
        ctx.sharded = (mesh, out_p, tp, ep, local_embed.shape)
        return DTensor.from_local(local_embed[local_tokens], mesh, out_p,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Shard
        (local_tokens,) = ctx.saved_tensors
        mesh, out_p, tp, ep, shape = ctx.sharded
        g = g.redistribute(mesh, out_p).to_local()
        grad = g.new_zeros(shape).index_put_((local_tokens,), g,
                                             accumulate=True)
        grad_p = [Partial() if isinstance(t, Shard) else e
                  for t, e in zip(tp, ep)]
        return DTensor.from_local(grad, mesh, grad_p, run_check=False), None


def embed_lookup(embed, tokens):
    """``embed[tokens]``: on a ``DTensor`` table split by columns only
    (the rules' "embed") through ``_Embed`` on the local shards, where
    torch 2.11's DTensor rule for the gradient (``index_put``) raises;
    otherwise as it is."""
    from torch.distributed.tensor import Shard
    if is_dtensor(embed) and not any(
            isinstance(p, Shard) and p.dim == 0 for p in embed.placements):
        if not is_dtensor(tokens):
            tokens = as_replicated(tokens, embed.device_mesh)
        return _Embed.apply(embed, tokens)
    return embed[tokens]


def zero_pad(x, dim: int, before: int, after: int):
    """``x`` with ``before`` and ``after`` zeros on ``dim``: ``F.pad`` on a
    plain tensor; on a ``DTensor`` a ``cat`` with zeros (torch 2.11's
    DTensor rule for a pad gives its output one placement whatever the
    mesh)."""
    dim = dim % x.dim()
    if not is_dtensor(x):
        import torch.nn.functional as F
        return F.pad(x, (0, 0) * (x.dim() - 1 - dim) + (before, after))
    parts = []
    for n in (before, None, after):
        if n is None:
            parts.append(x)
        elif n:
            parts.append(x.new_zeros((*x.shape[:dim], n, *x.shape[dim + 1:])))
    return torch.cat(parts, dim=dim)


def as_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """A local tensor every rank holds whole, as a replicated ``DTensor``
    on ``mesh``; with no mesh, ``x`` as it is."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def write_slot(cache: torch.Tensor, dim: int, slot: int,
               value: torch.Tensor) -> None:
    """``cache.select(dim, slot).copy_(value)``, in place. On a
    ``DTensor`` cache each rank writes the part of the slot in its own
    shard: the value is redistributed to the cache's placements on its
    other dims (the slot's dim taken out), and a rank whose shard of
    ``dim`` does not hold the slot writes nothing."""
    if not is_dtensor(cache):
        cache.select(dim, slot).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    placements = []
    for p in cache.placements:
        if isinstance(p, Shard) and p.dim == dim:
            placements.append(Replicate())
        elif isinstance(p, Shard) and p.dim > dim:
            placements.append(Shard(p.dim - 1))
        else:
            placements.append(p)
    if not is_dtensor(value):
        from torch.distributed.tensor import distribute_tensor
        value = distribute_tensor(value, mesh, [Replicate()] * mesh.ndim,
                                  src_data_rank=None)
    local = value.redistribute(mesh, placements).to_local()
    lo = offset[dim]
    if lo <= slot < lo + shape[dim]:
        cache.to_local().select(dim, slot - lo).copy_(local)
