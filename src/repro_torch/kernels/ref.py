"""Plain-torch oracles of the standalone kernels: the JAX package's
``repro/kernels/ref.py``, computing in float32 and casting back."""
from __future__ import annotations

import math

import torch

__all__ = ["matmul_ref", "rmsnorm_ref", "flash_attention_ref",
           "decode_attention_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q/k/v (B, S, H, hd) — MHA reference (full score matrix)."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lens: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k/v (B, S, KV, hd); lens (B,)."""
    b, h, hd = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(b, kv, h // kv, hd).float() * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qr, k.float())
    mask = torch.arange(k.shape[1], device=q.device)[None, :] \
        < lens.to(q.device)[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, hd).to(q.dtype)
