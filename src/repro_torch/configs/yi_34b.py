"""yi-34b — llama-architecture dense decoder with GQA [arXiv:2403.04652].

60L, d_model 7168, 56H GQA kv=8, d_ff 20480, vocab 64000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    citation="[arXiv:2403.04652]",
)
