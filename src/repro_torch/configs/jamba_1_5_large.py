"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_period=2,          # MoE every other layer
    attn_period=8,         # attention 1:7 with Mamba
    ssm_state=128,
    ssm_expand=2,          # d_inner = 16384
    ssm_head_dim=128,
    ssm_ngroups=8,
    ssm_conv=4,
    activation="silu",
    source="arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large",
)
