"""chameleon-34b — early-fusion mixed-modal decoder [arXiv:2405.09818].

48L, d_model 8192, 64H GQA kv=8, d_ff 22016, vocab 65536 (VQ image codes share
the text vocabulary — early fusion means the backbone is a plain decoder over
interleaved text + image tokens). QK-norm per the Chameleon paper
(query-key RMSNorm for training stability). The VQ-GAN image tokenizer is a
frontend stub per the assignment carve-out: inputs are token ids."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    qk_norm=True,
    frontend="vlm",
    long_context_window=8192,        # long_500k SWA variant (DESIGN.md)
    citation="[arXiv:2405.09818]",
)
