"""FlashAttention forward: ``flash_attention(q, k, v)`` on (B, S, H, hd)
MHA inputs, causal or not, computed in f32 and cast to ``q.dtype``.

For tensors on the card it launches the hand-written CUDA kernel
(``csrc/standalone.cu`` ``sk_flash_attention``: one CTA per (b·h,
128-query block), the online softmax in f32, q, k and v read through
their strides; bf16 on the tensor cores with P split into bf16 hi + lo,
f32 on FFMA), which replaces the Pallas kernel of the JAX package
(``repro/kernels/flash_attention.py`` ``flash_attention``, ``pallas_call``
at :77); for tensors on the CPU it runs ``flash_attention_plain``, and on
any other device it raises.  ``bq`` and ``bk`` keep the reference's clamp
and divisibility check; the CUDA tiles are the kernel's own.  The kernel
is built at the head widths ``HD_PAD`` and takes any hd up to
``MAX_HD`` there, the columns past hd read as zero; a wider head, whose K
and V tiles would not fit a CTA's shared memory, runs in the simple wide
kernel (256-column slices of the output, the logits recomputed for each
in 64-column chunks; f32 arithmetic for both types), so every hd runs, as
in the reference.  Inputs the kernel cannot copy as they lie are copied
first (``build.tma_ready``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .build import dtype_code, launch, placement, tma_ready

__all__ = ["flash_attention", "flash_attention_plain", "HD_PAD", "MAX_HD"]

#: head widths the CUDA kernel is compiled for; hd runs in the smallest
#: that holds it
HD_PAD = (64, 128, 256)
MAX_HD = HD_PAD[-1]

#: the kernel's query block (the wide kernel's, past MAX_HD): the grid's
#: second axis has at most 65535
_KERNEL_BQ = 128
_WIDE_BQ = 32


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
           bk: int) -> Tuple[int, ...]:
    """(b, s, h, hd, bq, bk) after the reference's clamp and checks."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention takes q, k, v of one (B, S, H, hd) "
                         f"shape, not {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if min(b, s, h, hd, bq, bk) <= 0:
        raise ValueError("flash_attention needs non-empty inputs and blocks")
    bq, bk = min(bq, s), min(bk, s)
    if s % bq or s % bk:
        raise ValueError(f"blocks ({bq}, {bk}) do not divide S={s}")
    return b, s, h, hd, bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 128, bk: int = 128,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v (B, S, H, hd) MHA -> (B, S, H, hd) in ``q.dtype``."""
    b, s, h, hd, bq, bk = _check(q, k, v, bq, bk)
    if placement(q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, bq=bq, bk=bk, causal=causal)
    code = dtype_code(q, k, v)
    bq_k = _KERNEL_BQ if hd <= MAX_HD else _WIDE_BQ
    if b * h >= 2 ** 31 or -(-s // bq_k) > 65535 or -(-hd // 256) > 65535:
        raise NotImplementedError("the CUDA flash_attention takes B·H < 2**31 "
                                  f"and S <= {65535 * bq_k}")
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), b, s, h, hd, *q.stride(),
           *k.stride(), *v.stride(), int(causal), 1.0 / math.sqrt(hd), code)
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, bq: int = 128, bk: int = 128,
                          causal: bool = True) -> torch.Tensor:
    """The reference kernel's algorithm in torch ops, on any device: per
    (bq) query block, the (bk) key blocks in order with the online softmax
    (running max from -1e30, masked logits -1e30, blocks wholly above the
    diagonal skipped, the sum clamped at 1e-30), every (b, h) at once."""
    b, s, h, hd, bq, bk = _check(q, k, v, bq, bk)
    scale = 1.0 / math.sqrt(hd)
    qr, kr, vr = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    out = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, bq):
        qb = qr[:, :, q0:q0 + bq] * scale
        m = torch.full((b, h, bq, 1), -1e30, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, hd), device=q.device)
        for k0 in range(0, s, bk):
            if causal and k0 > q0 + bq - 1:
                break
            logits = qb @ kr[:, :, k0:k0 + bk].transpose(-1, -2)
            if causal:
                visible = pos[k0:k0 + bk][None, :] <= pos[q0:q0 + bq][:, None]
                logits = logits.masked_fill(~visible, -1e30)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vr[:, :, k0:k0 + bk]
            m = m_new
        out[:, :, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)
