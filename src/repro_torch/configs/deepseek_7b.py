"""deepseek-7b [dense] — llama-arch MHA [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    activation="silu",
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base",
)
