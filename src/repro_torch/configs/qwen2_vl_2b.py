"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only per the assignment: the vision frontend is a stub and
``input_specs()`` supplies precomputed patch embeddings.  M-RoPE splits the
rotary half-dim (hd/2 = 64) into temporal/height/width sections (16, 24, 24).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    activation="silu",
    embed_input=True,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B",
)
