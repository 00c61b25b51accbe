"""The paper's own evaluation models (§6.2): Qwen3-1.7B / 8B / 30B-A3B.

Used by the Table-2 compiler-statistics benchmark and the Fig. 9/11
latency reproductions, alongside the ten assigned architectures.
"""
from .base import ModelConfig

QWEN3_1_7B = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    rope_theta=1e6,
    activation="silu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-1.7B (paper §6.2)",
)

QWEN3_8B = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    rope_theta=1e6,
    activation="silu",
    source="hf:Qwen/Qwen3-8B (paper §6.2)",
)

QWEN3_30B_A3B = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    moe_period=1,
    rope_theta=1e6,
    activation="silu",
    source="hf:Qwen/Qwen3-30B-A3B (paper §6.2)",
)
