"""Architecture registry of the zoo, the JAX package's ten archs:
``get(arch_id)``, ``list_archs()``, ``reduced(cfg)`` smoke variants,
``optimized(cfg)`` (group-local MoE dispatch) and the arch x shape
``grid()``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen25
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.yi_34b import CONFIG as _yi

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _moonshot, _jamba, _mamba2, _yi, _seamless, _qwen_moe, _chameleon,
    _starcoder2, _qwen25, _deepseek]}


def get(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family (the reference's
    ``reduced``): 2 layers (3 with leading dense layers: 1 dense and 2
    scanned), d_model 256, 4 heads of 64, <= 4 experts, tiny vocab; the
    MoE routing, SSD scan, hybrid interleave, MLA (heads of 32), the
    encoder-decoder (2 encoder layers), biases, norms and sliding window
    kept."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        first_dense_layers=1 if cfg.first_dense_layers else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
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
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
        kw["head_dim"] = 32
    if cfg.first_dense_layers:
        kw["n_layers"] = 3              # 1 unrolled dense + 2 scanned
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
    """All (arch x shape) pairs."""
    return [(a, s) for a in list_archs() for s in SHAPES]
