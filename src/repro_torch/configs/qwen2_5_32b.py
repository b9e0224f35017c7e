"""qwen2.5-32b — dense GQA decoder with QKV bias
[hf:Qwen/Qwen2.5-0.5B family card; 32B variant].

64L, d_model 5120, 40H GQA kv=8, d_ff 27648, vocab 152064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    citation="[hf:Qwen/Qwen2.5-0.5B]",
)
