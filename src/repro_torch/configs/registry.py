"""Architecture registry of the decoder-only zoo the port serves:
``get(arch_id)``, ``list_archs()`` and ``reduced(cfg)`` smoke variants.

The JAX package's registry holds ten archs. The port holds the five
without experts (the dense, vlm and ssm families); ``get`` of one of the
other five raises ``NotImplementedError`` naming the slice that brings it.
``optimized`` (MoE dispatch groups) and ``grid`` come with the MoE slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen25
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.yi_34b import CONFIG as _yi

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _mamba2, _yi, _chameleon, _starcoder2, _qwen25]}

# the reference's other archs: name -> the slice of the port that brings it
UNPORTED: Dict[str, str] = {
    "qwen2-moe-a2.7b": "the MoE slice (K5 moe_gemm)",
    "moonshot-v1-16b-a3b": "the MoE slice (K5 moe_gemm)",
    "jamba-1.5-large-398b": "the MoE slice (the Mamba2/attention hybrid "
                            "with experts)",
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
    of 64, tiny vocab; the SSD scan, biases, norms and sliding window
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
        block_len=0,
    )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=32, head_dim=32, expand=2,
                              n_groups=1, chunk=32)
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.long_context_window:
        kw["long_context_window"] = 16
    return dataclasses.replace(cfg, **kw)
