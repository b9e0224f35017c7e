"""deepseek-v3-671b — MLA + fine-grained MoE + MTP [arXiv:2412.19437].

61L (first 3 dense, 58 MoE), d_model 7168, 128 heads with multi-head latent
attention (q_lora 1536, kv_lora 512, decoupled RoPE 64, per-head nope/v dims
128), expert d_ff 2048, 256 routed experts top-8 + 1 shared, vocab 129280,
depth-1 multi-token-prediction head.

The ``n_kv_heads=128`` of the assignment row reflects MLA's MHA-equivalent
behaviour (every head has its own K/V derived from the shared 512-dim latent);
the cache stores only the compressed latent + rope key (576/token)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18_432,                     # dense MLP width of the first 3 layers
    vocab_size=129_280,
    head_dim=128,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, top_k=8, d_ff_expert=2048, n_shared=1),
    first_dense_layers=3,
    mtp=True,
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    rope_theta=10_000.0,
    citation="[arXiv:2412.19437]",
)
