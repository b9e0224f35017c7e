"""starcoder2-15b — dense code model with GQA + RoPE and native
sliding-window attention (4096) [arXiv:2402.19173].

40L, d_model 6144, 48H GQA kv=4, d_ff 24576, vocab 49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    sliding_window=4096,             # native SWA -> long_500k runs natively
    rope_theta=100_000.0,
    citation="[arXiv:2402.19173]",
)
