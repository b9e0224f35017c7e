"""moonshot-v1-16b-a3b — Moonlight-16B-A3B MoE
[hf:moonshotai/Moonlight-16B-A3B; DeepSeek-V3-style arch, kimi/moonlight].

48L, d_model 2048, 16H (GQA kv=16 i.e. MHA), expert d_ff 1408, vocab 163840,
64 routed experts top-6 (+2 shared per the model card)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,                      # dense-equivalent width (unused: all-MoE)
    vocab_size=163_840,
    moe=MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2),
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    rope_theta=50_000.0,
    citation="[hf:moonshotai/Moonlight-16B-A3B]",
)
