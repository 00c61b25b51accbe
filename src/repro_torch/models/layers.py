"""Shared layers of the torch model: norms, rotary embeddings, GQA
attention over a KV cache.

Plain functions on tensors, mirroring ``repro/models/layers.py`` (the
reference) operation for operation so that the port's model oracle
agrees with the JAX one to float32 rounding.  Layouts follow the
reference: queries ``(B, [N,] H, hd)``, caches ``(B, S, KV, hd)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["act_fn", "rmsnorm", "glu", "rope", "apply_rope",
           "decode_attention", "chunk_attention"]


def act_fn(name: str):
    """The activation by config name; GELU is the tanh form, as the
    reference's (``jax.nn.gelu`` defaults to it)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm with float32 statistics; gemma_style scales by (1 + w)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma_style else w.float()
    return (y * scale).to(x.dtype)


def glu(h: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """Fused gate/up projection output (..., 2F) -> activated (..., F)."""
    gate, up = torch.chunk(h, 2, dim=-1)
    return act_fn(activation)(gate) * up


def rope(positions: torch.Tensor, head_dim: int, theta: float,
         mrope_sections: Optional[Tuple[int, int, int]] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., head_dim // 2) for integer ``positions``:
    (...,) for plain RoPE, or (..., 3) (temporal, height, width) for
    M-RoPE, where section i of the rotary frequencies takes column i."""
    half = head_dim // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=positions.device) / half)
    if mrope_sections is None:
        ang = positions.float()[..., None] * inv_freq
    else:
        assert positions.shape[-1] == len(mrope_sections)
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[..., i:i + 1].float()
                         * inv_freq[start:start + sec])
            start += sec
        assert start == half, "mrope sections must cover head_dim//2"
        ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (..., n_heads, head_dim) by per-position cos/sin (..., hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, seq_lens: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention of one query token (B, H, hd) over the
    cache; ``seq_lens`` is the live length including the new token."""
    b, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd).float() * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s_idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = s_idx[None, :] < seq_lens[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, seq_lens: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention of N chunk queries (B, N, H, hd) over the
    cache.  Chunk position ``i`` of request ``b`` sits at absolute
    position ``seq_lens[b] + i`` and attends to cache entries
    ``< seq_lens[b] + i + 1``; for N == 1 this is ``decode_attention``."""
    b, n, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, n, kvh, g, hd).float() * scale
    logits = torch.einsum("bnkgd,bskd->bnkgs", qg, k_cache.float())
    lim = seq_lens[:, None] + torch.arange(n, device=q.device)[None, :] + 1
    s_idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = s_idx[None, None, :] < lim[:, :, None]
    logits = logits.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bnkgs,bskd->bnkgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float())
    return out.reshape(b, n, h, hd).to(q.dtype)
