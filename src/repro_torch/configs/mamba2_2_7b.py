"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,                # no MLP: Mamba2 blocks are mixer-only
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,          # d_inner = 5120
    ssm_head_dim=64,       # 80 SSM heads
    ssm_ngroups=1,
    ssm_conv=4,
    norm_eps=1e-5,
    activation="silu",
    source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b",
)
