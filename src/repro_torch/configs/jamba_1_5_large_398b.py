"""jamba-1.5-large-398b — hybrid Mamba+attention MoE [arXiv:2403.19887].

72L = 9 super-blocks x 8 layers; 1 attention layer per 8 (1:7 interleave,
attention at in-block offset 4); MoE MLP every 2nd layer, 16 experts top-2;
d_model 8192, 64H GQA kv=8, d_ff 24576, vocab 65536.

The Mamba layers use the Mamba2/SSD chunked formulation (``models/ssm.py``,
K6) rather than Mamba-1's selective scan — the same recurrence family, as
the JAX package's config has it."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    moe=MoEConfig(n_routed=16, top_k=2, d_ff_expert=24_576),
    moe_layer_period=2,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=8, chunk=256),
    attn_layer_period=8,
    attn_layer_offset=4,
    citation="[arXiv:2403.19887]",
)
