"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,             # expert width
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    moe_period=2,          # interleaved MoE (every other layer dense) —
                           # matches the published 400B-total / 17B-active
    n_shared_experts=1,    # llama4 always-on shared expert
    rope_theta=5e5,
    activation="silu",
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (unverified)",
)
