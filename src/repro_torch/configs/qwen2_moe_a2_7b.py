"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16H (kv=16), expert d_ff 1408, vocab 151936;
60 routed experts top-4 + 4 shared experts; QKV bias (Qwen family)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, top_k=4, d_ff_expert=1408, n_shared=4),
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    citation="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
)
