"""Architecture configuration schema.

One ``ModelConfig`` describes every assigned architecture family:
dense GQA transformers, MoE transformers, Mamba2 (SSM), Jamba-style
hybrids, and modality-stub backbones (VLM / audio).  The full configs are
exercised only via the dry-run (``ShapeDtypeStruct``, no allocation); the
``reduced()`` variants run real forward/train steps in the smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention details ---
    qkv_bias: bool = False         # Qwen-style QKV bias
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # Qwen2-VL M-RoPE
    # --- MLP details ---
    activation: str = "silu"       # silu (SwiGLU) | gelu (GeGLU)
    # --- MoE ---
    n_experts: int = 0             # 0 -> dense MLP
    top_k: int = 0
    moe_d_ff: int = 0              # expert FFN width (d_ff used if 0)
    moe_period: int = 1            # MoE every k-th layer (jamba: 2)
    n_shared_experts: int = 0      # llama4-style always-on shared expert
    capacity_factor: float = 1.25  # train/prefill dispatch capacity
    # --- SSM (Mamba2) ---
    ssm_state: int = 0             # N; 0 -> no SSM layers
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    attn_period: int = 0           # hybrid: attention every k-th layer
                                   # (jamba 1:7 -> 8); 0 = all attention
                                   # (or all SSM if family == "ssm")
    # --- modality stub ---
    embed_input: bool = False      # True: input is precomputed embeddings
    # --- misc ---
    norm_eps: float = 1e-6
    gemma_norm: bool = False       # (1 + w) RMSNorm scaling
    tie_embeddings: bool = False
    source: str = ""               # provenance note

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (500k) is architecturally supported."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' mixer for layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_period and self.family == "hybrid":
            return "attn" if i % self.attn_period == 0 else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' | 'mlp' | 'none' for layer i (Mamba2 blocks are mixer-only)."""
        p = max(1, self.moe_period)
        if self.n_experts and i % p == p - 1:
            return "moe"
        return "mlp" if self.d_ff else "none"

    @property
    def block_period(self) -> int:
        """Layers per scan block (homogeneous structure within a block)."""
        if self.family == "hybrid":
            import math
            p = max(1, self.attn_period)
            return (p * self.moe_period) // math.gcd(p, self.moe_period)
        return max(1, self.moe_period) if self.n_experts else 1

    # -------------------------------------------------------------- params
    def param_count(self) -> int:
        """Total parameters (for roofline MODEL_FLOPS = 6·N·D)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d, hd = self.d_model, self.hd
        n = self.vocab * d                      # embedding
        if not self.tie_embeddings:
            n += d * self.vocab                 # lm head
        n += d                                  # final norm
        for i in range(self.n_layers):
            n += d                              # mixer norm
            if self.layer_kind(i) == "attn":
                n += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                n += (self.n_heads * hd) * d
                if self.qkv_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:
                din, nh, ng, ns = (self.d_inner, self.ssm_nheads,
                                   self.ssm_ngroups, self.ssm_state)
                conv_dim = din + 2 * ng * ns
                n += d * (2 * din + 2 * ng * ns + nh)     # in_proj
                n += self.ssm_conv * conv_dim             # conv
                n += 3 * nh                               # A_log, D, dt_bias
                n += din                                  # gated norm
                n += din * d                              # out_proj
            ffn = self.ffn_kind(i)
            if ffn != "none":
                n += d                          # ffn norm
            if ffn == "moe":
                fe = self.moe_d_ff or self.d_ff
                e_used = (self.top_k + self.n_shared_experts
                          if active_only else
                          self.n_experts + self.n_shared_experts)
                n += d * self.n_experts         # router (always dense)
                n += e_used * (d * 2 * fe + fe * d)
            elif ffn == "mlp":
                n += d * 2 * self.d_ff + self.d_ff * d
        return n

    # -------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny variant for CPU smoke tests."""
        period = self.block_period
        n_layers = max(period, 2 if period == 1 else period)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(2, self.n_kv_heads) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab=512,
            n_experts=min(4, self.n_experts) if self.n_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_expand=2,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_ngroups=1,
            mrope_sections=(8, 4, 4) if self.mrope_sections else None,
            name=self.name + "-reduced",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str          # "train" | "prefill" | "decode"


#: The assigned input-shape set (same for every LM arch).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
