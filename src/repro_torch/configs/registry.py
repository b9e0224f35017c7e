"""Architecture registry of the decoder-only zoo the port serves:
``get(arch_id)``, ``list_archs()``, ``reduced(cfg)`` smoke variants,
``optimized(cfg)`` (group-local MoE dispatch) and the arch x shape
``grid()``.

The JAX package's registry holds ten archs. The port holds the eight
decoder-only ones (the dense, vlm, ssm, moe and hybrid families); ``get``
of one of the other two raises ``NotImplementedError`` naming the slice
that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen25
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.yi_34b import CONFIG as _yi

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _moonshot, _jamba, _mamba2, _yi, _qwen_moe, _chameleon, _starcoder2,
    _qwen25]}

# the reference's other archs: name -> the slice of the port that brings it
UNPORTED: Dict[str, str] = {
    "deepseek-v3-671b": "a later slice (MLA, MTP, leading dense layers)",
    "seamless-m4t-medium": "a later slice (the encoder-decoder)",
}


def get(arch_id: str) -> ModelConfig:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported; it comes with "
            f"{UNPORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family (the reference's
    ``reduced`` for the ported families): 2 layers, d_model 256, 4 heads
    of 64, <= 4 experts, tiny vocab; the MoE routing, SSD scan, hybrid
    interleave, biases, norms and sliding window kept."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        block_len=0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_routed=4, top_k=2, d_ff_expert=128,
                              n_shared=min(cfg.moe.n_shared, 1))
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=32, head_dim=32, expand=2,
                              n_groups=1, chunk=32)
    if cfg.attn_layer_period:           # hybrid: 1 attn + 1 mamba
        kw["attn_layer_period"] = 2
        kw["attn_layer_offset"] = 0
        kw["moe_layer_period"] = 2 if cfg.moe is not None else 1
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.long_context_window:
        kw["long_context_window"] = 16
    return dataclasses.replace(cfg, **kw)


def optimized(cfg: ModelConfig, data_axis_size: int = 16) -> ModelConfig:
    """The reference's production variant: group-local MoE dispatch in
    ``data_axis_size`` groups (``models/moe.py``). No-op for non-MoE
    architectures."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe,
                                     dispatch_groups=data_axis_size))


def grid():
    """All (arch x shape) pairs of the ported archs."""
    return [(a, s) for a in list_archs() for s in SHAPES]
