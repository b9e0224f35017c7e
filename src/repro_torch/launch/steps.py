"""Train, prefill and decode steps of the zoo (the JAX package's
``launch/steps.py``), shared by the launchers. PyTorch runs eagerly, so a
step is a plain closure over the config. A batch holds ``tokens`` (B, S)
and, for an encoder-decoder, ``src`` (B, S_src, d) frame embeddings
(``api.loss`` and ``api.prefill`` read both).

``make_train_step``'s step takes the loss and its gradient from
``torch.autograd`` (through K3's, K5's and K6's autograd Functions on the
card), clips the gradient by its global norm and applies the optimizer,
which updates the parameters and its state in place (the reference's
launcher donates both). Nothing is read to the host: the loss, the norm
and the step counter come back as device tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.optim import clip_by_global_norm, make_optimizer


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, {"loss", "grad_norm", **the loss's metrics})."""
    opt = make_optimizer(tcfg)

    def train_step(params, opt_state, step, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                              tcfg.remat)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        with torch.no_grad():
            params, opt_state = opt.update(params, grads, opt_state, step,
                                           tcfg.lr)
        out = {"loss": loss.detach(), "grad_norm": gnorm,
               **{k: v.detach() if isinstance(v, torch.Tensor) else v
                  for k, v in metrics.items()}}
        return params, opt_state, step + 1, out

    return train_step


def loss_and_grads(cfg: ModelConfig, params, batch, remat: bool = False):
    """(loss, the loss's metrics, {leaf: its gradient}) of ``api.loss``
    at ``params``: the first half of a train step. A leaf the loss does
    not reach gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = api.loss(cfg, leaves, batch, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), materialize_grads=True)))
    return loss, metrics, grads


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, target_len=None):
        return api.prefill(cfg, params, batch, target_len=target_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, token):
        return api.decode_step(cfg, params, cache, token)
    return decode_step


def init_state(cfg: ModelConfig, tcfg: TrainConfig, key=0,
               device: DeviceLike = None):
    """(params, the optimizer's zero state, step 0 as a 0-d int32 tensor),
    on ``device``: the GPU unless the caller asks for the CPU, raising
    where CUDA is absent. ``key`` is ``api.init``'s."""
    device = resolve_device(device)
    params = api.init(cfg, key, device=device)
    opt = make_optimizer(tcfg)
    return params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                                 device=device)
