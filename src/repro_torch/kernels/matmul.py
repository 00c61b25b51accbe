"""Tiled matmul: ``matmul(a, b)`` = ``a @ b`` with an f32 accumulator,
cast to ``a.dtype``.

For tensors on the card it launches the hand-written CUDA GEMM
(``csrc/standalone.cu`` ``sk_matmul``), which replaces the Pallas kernel
of the JAX package (``repro/kernels/matmul.py`` ``matmul``,
``pallas_call`` at :48): bf16 on the tensor cores (wgmma on TMA tiles, a
persistent grid, 128 x BN tiles), f32 on FFMA (128 x 128 tiles, no TF32,
K split when the tiles alone would leave SMs idle, the partial tiles then
summed by a second kernel: such a call counts two launches).  ``plan``
picks BN and the split.  Operands the kernels cannot copy as they lie (an inner
stride other than 1, rows off 16-byte boundaries) are copied first
(``build.tma_ready``).  For tensors on the CPU it runs ``matmul_plain``,
and on any other device it raises.  ``bm``, ``bn`` and ``bk`` keep the
reference's meaning for the API (clamped to the dimension, which they
must divide); the CUDA tiles are the kernels' own.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import dtype_code, launch, placement, sm_count, tma_ready

__all__ = ["matmul", "matmul_plain", "plan"]

#: the kernels' tiles: bf16 128 x BN (BN one of the widths), f32 128 x 128
#: with K in slabs of 32, split at most F32_MAX_SPLITS ways
BF16_BM, BF16_WIDTHS = 128, (192, 128)
F32_TILE, F32_BK, F32_MAX_SPLITS = 128, 32, 4


def _blocks(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
            bk: int) -> Tuple[int, ...]:
    """(m, n, k, bm, bn, bk) after the reference's clamp and checks."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if min(m, n, k, bm, bn, bk) <= 0:
        raise ValueError("matmul needs non-empty operands and blocks")
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"blocks ({bm}, {bn}, {bk}) do not divide "
                         f"({m}, {n}, {k})")
    return m, n, k, bm, bn, bk


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 128) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in ``a.dtype``."""
    m, n, k, bm, bn, bk = _blocks(a, b, bm, bn, bk)
    if placement(a, b) == "cpu":
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk)
    code = dtype_code(a, b)
    if max(m, n, k) >= 2 ** 31:
        raise NotImplementedError("the CUDA matmul takes M, N, K < 2**31")
    a, b = tma_ready(a), tma_ready(b)
    sms = sm_count(a.device)
    variant, splits = plan(m, n, k, code, sms)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    ws = out if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=a.device)
    # a split product launches the GEMM and then the sum of its partials
    launch("matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           ws.data_ptr(), m, n, k, *a.stride(), *b.stride(), variant, splits,
           code, sms, kernels=1 if splits == 1 else 2)
    return out


def plan(m: int, n: int, k: int, code: int, sms: int) -> Tuple[int, int]:
    """(variant, splits) of one launch on ``sms`` SMs.  bf16 (code 1):
    the tile width BN whose 128 x BN tiles take the fewest waves of the
    persistent grid, weighted by BN (a CTA's time per tile), the widest
    among equals; one split.  f32 (code 0): variant 0 and the number of
    K ranges that spreads the 128 x 128 tiles' work most evenly over the
    SMs (the least work on the busiest SM, the fewest splits among
    equals), each range at least one 32-deep slab."""
    if code == 1:
        mt = -(-m // BF16_BM)
        cost = {bn: -(-(mt * -(-n // bn)) // sms) * bn for bn in BF16_WIDTHS}
        return min(BF16_WIDTHS, key=lambda bn: (cost[bn], -bn)), 1
    tiles = -(-m // F32_TILE) * -(-n // F32_TILE)
    slabs = -(-k // F32_BK)
    return 0, min(range(1, min(F32_MAX_SPLITS, slabs) + 1),
                  key=lambda z: (-(-(tiles * z) // sms) / z, z))


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128) -> torch.Tensor:
    """The reference kernel's algorithm in torch ops, on any device: the
    K axis in ``bk`` slabs summed into an f32 accumulator (every output
    tile sums the same slabs, so the (bm, bn) tiling is not repeated)."""
    m, n, k, bm, bn, bk = _blocks(a, b, bm, bn, bk)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(a.dtype)
