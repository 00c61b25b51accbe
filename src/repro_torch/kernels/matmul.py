"""Tiled matmul: ``matmul(a, b)`` = ``a @ b`` with an f32 accumulator,
cast to ``a.dtype``.

For tensors on the card it launches the hand-written CUDA GEMM
(``csrc/standalone.cu`` ``sk_matmul``: 128 x 128 output tiles, f32 FFMA,
no TF32), which replaces the Pallas kernel of the JAX package
(``repro/kernels/matmul.py`` ``matmul``, ``pallas_call`` at :48); for
tensors on the CPU it runs ``matmul_plain``, and on any other device it
raises.  ``bm``, ``bn`` and ``bk`` keep the reference's meaning for the
API (clamped to the dimension, which they must divide); the CUDA tile is
the kernel's own.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import dtype_code, launch, placement

__all__ = ["matmul", "matmul_plain"]


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
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    launch("matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           m, n, k, *a.stride(), *b.stride(), code)
    return out


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
