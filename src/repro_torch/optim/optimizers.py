"""Optimizers of the zoo's training (the JAX package's
``optim/optimizers.py``): SGD, momentum, Adam, AdamW and Adafactor, plus
``global_norm`` and ``clip_by_global_norm``. Adafactor's factored second
moment keeps O(rows + cols) state a matrix instead of O(rows · cols).

    opt = make_optimizer(train_cfg)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step, lr)

Parameters and gradients are the port's flat dicts; the state is a flat
dict too, under the reference's tree paths: ``m/<leaf>`` and ``v/<leaf>``
(Adam, AdamW; ``m/<leaf>`` alone for momentum), ``s/<leaf>/vr`` and
``s/<leaf>/vc`` for a leaf of two or more axes and ``s/<leaf>/v`` for the
rest (Adafactor), nothing for SGD. Its sorted keys are the reference's
leaf order (``convert.py``), so a checkpoint crosses between the packages.

Every moment is float32; an update is computed in float32 from the leaf
and its gradient cast up, and rounded once to the leaf's dtype. ``step``
is a 0-d int32 tensor on the parameters' device and ``lr`` a float or a
0-d tensor; nothing is read to the host.

The rules are the reference's to the letter, on the port's *stacked*
leaves too (ROADMAP R6): a block leaf carries a leading ``n_blocks`` axis,
so a stacked norm scale (n_blocks, d) has two axes and, as in the
reference, takes AdamW's decoupled decay, and Adafactor factors it and
clips its update over all layers at once.

``update`` writes the moments and the parameters in place and returns the
same dicts, as the reference's launcher donates them to its jitted step
(``donate_argnums=(0, 1)``): one copy of the state lives on the card, and
a step's temporaries are one leaf's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import TrainConfig

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str = ""


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every leaf's squares), float32, summed leaf by leaf in
    the reference's leaf order (sorted keys)."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), each in its
    own dtype, and the norm before clipping)."""
    norm = global_norm(grads)
    # a tensor quotient: a scalar over a tensor is a reciprocal product
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm


def _write(p: torch.Tensor, new32: torch.Tensor) -> None:
    """The leaf's new value, rounded once to its dtype, in place."""
    p.copy_(new32.to(p.dtype))


# ---------------------------------------------------------------------- #
def sgd(cfg: TrainConfig) -> Optimizer:
    def init(params):
        return {}

    def update(params, grads, state, step, lr):
        for k, p in params.items():
            _write(p, p.float() - lr * grads[k].float())
        return params, state
    return Optimizer(init, update, "sgd")


def momentum(cfg: TrainConfig) -> Optimizer:
    def init(params):
        return {f"m/{k}": torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def update(params, grads, state, step, lr):
        for k, p in params.items():
            m = state[f"m/{k}"]
            m.mul_(cfg.beta1).add_(grads[k].float())
            _write(p, p.float() - lr * m)
        return params, state
    return Optimizer(init, update, "momentum")


def _adam_core(cfg: TrainConfig, decoupled_wd: float) -> Optimizer:
    b1, b2 = cfg.beta1, cfg.beta2

    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        return {**{f"m/{k}": v for k, v in z.items()},
                **{f"v/{k}": v.clone() for k, v in z.items()}}

    def update(params, grads, state, step, lr):
        t = step.float() + 1.0
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for k, p in params.items():
            g = grads[k].float()
            m, v = state[f"m/{k}"], state[f"v/{k}"]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            upd = (lr * (m / bc1)).div_(torch.sqrt(v / bc2).add_(cfg.eps))
            p32 = p.float()
            if decoupled_wd and p.dim() >= 2:    # no decay on norms/biases
                upd.add_((lr * decoupled_wd) * p32)
            _write(p, p32 - upd)
        return params, state
    return Optimizer(init, update, "adam" if not decoupled_wd else "adamw")


def adam(cfg: TrainConfig) -> Optimizer:
    return _adam_core(cfg, 0.0)


def adamw(cfg: TrainConfig) -> Optimizer:
    return _adam_core(cfg, cfg.weight_decay)


# ---------------------------------------------------------------------- #
def adafactor(cfg: TrainConfig) -> Optimizer:
    """Factored second moment (Shazeer & Stern 2018), no momentum, update
    clipping at 1.0, relative step off (the lr is passed explicitly)."""
    eps1 = 1e-30

    def init(params):
        out = {}
        for k, p in params.items():
            if p.dim() >= 2:
                out[f"s/{k}/vr"] = p.new_zeros(p.shape[:-1],
                                               dtype=torch.float32)
                out[f"s/{k}/vc"] = p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                               dtype=torch.float32)
            else:
                out[f"s/{k}/v"] = torch.zeros_like(p, dtype=torch.float32)
        return out

    def update(params, grads, state, step, lr):
        t = step.float() + 1.0
        beta2 = 1.0 - t ** -0.8
        for k, p in params.items():
            g = grads[k].float()
            g2 = torch.square(g) + eps1
            if p.dim() >= 2:
                vr, vc = state[f"s/{k}/vr"], state[f"s/{k}/vc"]
                vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(-1))
                vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(-2))
                del g2
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps1)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                u = g / torch.sqrt(vhat.add_(eps1))
            else:
                v = state[f"s/{k}/v"]
                v.copy_(beta2 * v + (1 - beta2) * g2)
                u = g / torch.sqrt(v + eps1)
            del g
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps1)
            u = u / torch.clamp(rms, min=1.0)
            _write(p, p.float() - lr * u)
        return params, state
    return Optimizer(init, update, "adafactor")


# ---------------------------------------------------------------------- #
_REGISTRY = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw,
             "adafactor": adafactor}


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer not in _REGISTRY:
        raise KeyError(f"unknown optimizer {cfg.optimizer}")
    return _REGISTRY[cfg.optimizer](cfg)
