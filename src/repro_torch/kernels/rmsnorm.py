"""Row RMSNorm: ``rmsnorm(x, w)`` = ``x * rsqrt(mean(x²) + eps) * w``,
statistics in f32, cast to ``x.dtype``.

For tensors on the card it launches the hand-written CUDA kernel
(``csrc/standalone.cu`` ``sk_rmsnorm``: one CTA per row), which replaces
the Pallas kernel of the JAX package (``repro/kernels/rmsnorm.py``
``rmsnorm``, ``pallas_call`` at :27); for tensors on the CPU it runs
``rmsnorm_plain``, and on any other device it raises.  ``block_rows``
keeps the reference's clamp and divisibility check.
"""
from __future__ import annotations

import torch

from .build import dtype_code, launch, placement
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_plain"]


def _check(x: torch.Tensor, w: torch.Tensor, block_rows: int) -> None:
    if x.dim() != 2 or w.shape != x.shape[1:]:
        raise ValueError(f"rmsnorm of x {tuple(x.shape)} with w "
                         f"{tuple(w.shape)}")
    rows = x.shape[0]
    if min(rows, x.shape[1], block_rows) <= 0:
        raise ValueError("rmsnorm needs non-empty rows and blocks")
    if rows % min(block_rows, rows):
        raise ValueError(f"block_rows {block_rows} does not divide {rows}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 128) -> torch.Tensor:
    """x (rows, d), w (d,) -> (rows, d) in ``x.dtype``."""
    _check(x, w, block_rows)
    if placement(x, w) == "cpu":
        return rmsnorm_plain(x, w, eps=eps, block_rows=block_rows)
    code = dtype_code(x, w)
    rows, d = x.shape
    if rows >= 2 ** 31:
        raise NotImplementedError("the CUDA rmsnorm takes < 2**31 rows")
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    launch("rmsnorm", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
           rows, d, *x.stride(), w.stride(0), eps, code)
    return out


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                  block_rows: int = 128) -> torch.Tensor:
    """The reference kernel's algorithm in torch ops, on any device (rows
    are independent, so the row blocks are not repeated)."""
    _check(x, w, block_rows)
    return rmsnorm_ref(x, w, eps)
