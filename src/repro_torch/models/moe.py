"""Mixture-of-experts MLP with sort-based dropless-with-capacity dispatch
(the JAX package's ``models/moe.py``).

Tokens are argsorted by assigned expert, gathered into a dense buffer of
``C = top_k * T * cf / E`` slots an expert (the capacity) and run through
the experts' SwiGLU as three grouped products, so the work is proportional
to the *active* parameters; tokens past an expert's capacity are dropped
(GShard-style). Shared experts (Qwen2-MoE) are one SwiGLU of width
``n_shared * d_ff_expert`` applied to every token.

Parameters are a flat dict: ``router`` (d, E) float32, ``wg``/``wu`` (E,
d, f), ``wd`` (E, f, d) and, with shared experts, ``shared/{wg,wu,wd}``.

The three expert products go through ``kernels.moe_gemm`` (K5): on the
card the hand-written kernel, on the CPU its plain version. The global
dispatch and the group-local one (``dispatch_groups`` > 1, where sort and
scatter stay inside each of G groups of tokens) share one code path: the
dispatch buffer is laid out (E, G·C, d), expert e's slots for group g at
rows [g·C, (g+1)·C), so one product a weight takes every group's rows (the
reference's ``"gecd,edf->gecf"``); the global dispatch is G = 1.

Nothing in the dispatch waits for the card: the capacity is host
arithmetic on the token count, the per-expert counts a ``scatter_add_`` on
the device, and no step reads a tensor's value on the host.

The dispatch names its tensors for ``sharding.ctx.constrain`` where the
reference's two paths do: the global one ``"moe_gather"`` (the gathered
tokens and, on the way back, the experts' rows), ``"moe_disp"`` (the
dispatch buffer) and ``"moe_hidden"``; the group-local one
``"moe_local"`` for the tokens both ways, ``"moe_disp4a"`` then
``"moe_disp4"`` for the buffer, ``"moe_hidden4"``, and ``"moe_out4"`` then
``"moe_disp4a"`` for the experts' output. The tensors have the port's
layout: tokens (G, T·K, d), G = 1 for the global dispatch where the
reference's are (T·K, d); buffer, hidden and output (E, G·C, ·) where the
reference's group-local ones are (G, E, C, ·). A spec registered for one
of these names is written for that layout.

On ``DTensor``s (a sharded step, ``sharding/dtensor.py``) the routing and
the combine run on the replicated local tensors — the tokens, and the
experts' output, are all-gathered first — and the three expert products
take the dispatch buffer back as a replicated ``DTensor``, so that K5
runs under its rule on the experts' shards; the names above that sit
inside the routing (``moe_gather``, ``moe_local``) then see plain
tensors. On plain tensors nothing of this runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.models.common import (dense_init, dtype_of, prefixed,
                                       subtree, swiglu_apply, swiglu_init)
from repro_torch.random import split
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.dtensor import as_replicated, replicated_local


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_init(key: torch.Tensor, cfg, d_model=None):
    """The MoE MLP's leaves, drawn on the key's device from the
    reference's subkeys (router, wg, wu, wd, shared). ``wg`` and ``wu``
    take their fan-in from their first axis, E, as the reference's
    ``dense_init(…, (E, d, f))`` does (ROADMAP R4)."""
    m = cfg.moe
    d = d_model or cfg.d_model
    f, E, dt = m.d_ff_expert, m.n_routed, dtype_of(cfg)
    ks = split(key, 5)
    p = {"router": dense_init(ks[0], (d, E), torch.float32),
         "wg": dense_init(ks[1], (E, d, f), dt),
         "wu": dense_init(ks[2], (E, d, f), dt),
         "wd": dense_init(ks[3], (E, f, d), dt, fan_in=f)}
    if m.n_shared:
        p.update(prefixed("shared/",
                          swiglu_init(ks[4], d, m.n_shared * f, dt)))
    return p


def capacity(T: int, cfg) -> int:
    """Slots an expert for T tokens: top_k·T·cf/E rounded up to 8, at
    least 8."""
    m = cfg.moe
    c = int(m.capacity_factor * T * m.top_k / m.n_routed)
    return max(_round_up(c, 8), 8)


def moe_apply(cfg, p, x: torch.Tensor, with_aux: bool = True):
    """x (..., d) -> (y (..., d), the load-balance aux loss: a float32
    scalar tensor, or None without ``with_aux``; decode leaves it out, as
    the reference discards it there)."""
    if p["router"].dim() != 2:
        raise ValueError("the MoE MLP takes one model's parameters, not a "
                         "stacked cohort (the federated twins are "
                         "dense-only, as in the reference)")
    m = cfg.moe
    d = x.shape[-1]
    x_local, mesh = replicated_local(x)
    x2 = x_local.reshape(-1, d)
    T = x2.shape[0]
    G = m.dispatch_groups
    if G > 1 and T % G == 0 and T // G >= m.top_k:
        x3 = x2.reshape(G, T // G, d)
    else:
        x3 = x2[None]
    y, aux = _dispatch(cfg, p, x3, with_aux, mesh)
    if mesh is None:
        if m.n_shared:
            y = y + swiglu_apply(subtree(p, "shared/"), x3)
        return y.reshape(x.shape), aux
    # a sharded step: the shared experts on the same tokens, added as the
    # plain path adds them (the gradients then meet at x3 in its order);
    # the sum reshaped to x's shape as a local tensor (a DTensor's
    # gradient could not always be split back into groups)
    y = as_replicated(y, mesh)
    if m.n_shared:
        y = y + swiglu_apply(subtree(p, "shared/"), as_replicated(x3, mesh))
    y = as_replicated(replicated_local(y)[0].reshape(x.shape), mesh)
    return y, None if aux is None else as_replicated(aux, mesh)


def _dispatch(cfg, p, x3: torch.Tensor, with_aux: bool, mesh=None):
    """Route, dispatch, run the routed experts and combine the tokens of
    x3 (G, T, d), each group on its own. Returns (y (G, T, d), aux or
    None). On a sharded step x3 is the replicated local tensor of the
    tokens and ``mesh`` their mesh: the expert products run on
    ``DTensor``s, and y and aux come back as local tensors."""
    m = cfg.moe
    G, T, d = x3.shape
    E, K = m.n_routed, m.top_k
    C = capacity(T, cfg)
    dev = x3.device
    router = replicated_local(p["router"])[0]

    # the router and its softmax in float32 on the activations' values.
    # torch.topk and jax.lax.top_k may order exact ties of two experts
    # differently; with float32 probabilities of real inputs they do not
    # occur, and the tests' random inputs have none
    probs = torch.softmax(x3.float() @ router, dim=-1)           # (G,T,E)
    gate, idx = torch.topk(probs, K, dim=-1)                     # (G,T,K)
    if m.normalize_gates:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # a token's K routes by ascending expert: they go to K distinct
    # experts, so the stable dispatch below is unchanged, and the combine
    # then adds a token's rows in the reference's order
    idx, perm = idx.sort(-1)
    gate = gate.gather(-1, perm)

    flat_e = idx.reshape(G, T * K)
    counts = flat_e.new_zeros((G, E)).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    aux = None
    if with_aux:
        # load-balance auxiliary loss (Switch/GShard)
        me = probs.mean((0, 1))
        ce = counts.sum(0).float() / (G * T * K)
        aux = E * torch.sum(me * ce) * m.router_aux_weight

    # sort-based dispatch. The sort must be stable, as jnp.argsort is:
    # which tokens keep a slot of an overflowing expert depends on it
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    tok = order // K
    offs = counts.cumsum(1) - counts                             # exclusive
    pos = torch.arange(T * K, device=dev)[None] - offs.gather(1, se)
    g = torch.arange(G, device=dev)[:, None]
    # a dropped route writes the sentinel row E·G·C, cut away below (many
    # may write it; nothing reads it)
    dest = torch.where(pos < C, se * (G * C) + g * C + pos, E * G * C)
    grouped = G > 1
    tokens = "moe_local" if grouped else "moe_gather"
    buf = x3.new_zeros((E * G * C + 1, d))
    buf.index_copy_(0, dest.reshape(-1),
                    constrain(x3[g, tok], tokens).reshape(-1, d))
    disp = as_replicated(buf[:E * G * C].view(E, G * C, d), mesh)
    if grouped:
        disp = constrain(constrain(disp, "moe_disp4a"), "moe_disp4")
    else:
        disp = constrain(disp, "moe_disp")

    h = F.silu(moe_gemm(disp, p["wg"])) * moe_gemm(disp, p["wu"])
    h = constrain(h, "moe_hidden4" if grouped else "moe_hidden")
    y = moe_gemm(h, p["wd"])
    if grouped:
        y = constrain(constrain(y, "moe_out4"), "moe_disp4a")
    y = replicated_local(y)[0].view(E * G * C, d)
    y = torch.cat([y, y.new_zeros((1, d))])                      # sentinel

    # combine in a fixed order: the reference adds a token's K rows in
    # sorted order (``.at[tok].add``), i.e. by ascending expert, in x's
    # dtype; so does this, where index_add_ on the card would add them in
    # an order that changes from run to run. Each route's row, back in
    # token order:
    dest_tok = torch.empty_like(dest).scatter_(1, order, dest)
    rows = (constrain(y[dest_tok], tokens).view(G, T, K, d)
            * gate.to(x3.dtype)[..., None])                      # (G,T,K,d)
    out = rows[:, :, 0]
    for k in range(1, K):
        out = out + rows[:, :, k]

    return out, aux
