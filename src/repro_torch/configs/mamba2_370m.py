"""mamba2-370m — attention-free SSD state-space model [arXiv:2405.21060].

48L, d_model 1024, no attention / no MLP (Mamba2 blocks only, expand=2 so
d_inner=2048, head_dim 64 -> 32 heads), ssm_state N=128, vocab 50280."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,                      # unused (attention-free)
    n_kv_heads=16,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
    citation="[arXiv:2405.21060]",
)
