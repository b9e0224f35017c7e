"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596].

Transformer backbone only (assignment carve-out): the speech frontend
(mel-spectrogram + conv feature extractor) is a stub; ``input_specs`` supplies
precomputed frame embeddings (B, S_src, 1024). 12L encoder + 12L decoder,
d_model 1024, 16H (kv=16), d_ff 4096, vocab 256206.

long_500k is SKIPPED for this arch (DESIGN.md §Arch-applicability): a
524288-token *target* sequence is not meaningful for a speech enc-dec."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    encoder_layers=12,
    is_encoder_decoder=True,
    frontend="audio",
    citation="[arXiv:2308.11596]",
)
