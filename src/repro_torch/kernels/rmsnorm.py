"""Row RMSNorm: ``rmsnorm(x, w)`` = ``x * rsqrt(mean(x²) + eps) * w``,
statistics in f32, cast to ``x.dtype``.

For tensors on the card it launches the hand-written CUDA kernel
(``csrc/standalone.cu`` ``sk_rmsnorm``: 16-byte vectors and the row held
in registers where the rows allow it, else one CTA per row), which
replaces the Pallas kernel of the JAX package (``repro/kernels/rmsnorm.py``
``rmsnorm``, ``pallas_call`` at :27); for tensors on the CPU it runs
``rmsnorm_plain``, and on any other device it raises.  ``block_rows``
keeps the reference's clamp and divisibility check.

The launch path is short because a call's host time is most of its cost
at these sizes: the checks, the placement and the kernel's scalar
arguments are settled once per (shapes, strides, types, devices, eps,
block_rows) and kept, so that a repeated call allocates its output,
reads three pointers and the stream into a block, and makes one ctypes
call of two arguments.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build
from .build import dtype_code, placement, sm_count
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_plain"]

#: settled calls: key -> (device index, the kernel's scalar block, its
#: entry point), or None for the plain version (tensors on the CPU)
_CALLS: Dict[Tuple, Optional[Tuple[int, ctypes.Array, Callable]]] = {}
_MAX_CALLS = 256
_PTRS = ctypes.c_longlong * 4           # x, w, y, stream


def _check(x: torch.Tensor, w: torch.Tensor, block_rows: int) -> None:
    if x.dim() != 2 or w.shape != x.shape[1:]:
        raise ValueError(f"rmsnorm of x {tuple(x.shape)} with w "
                         f"{tuple(w.shape)}")
    rows = x.shape[0]
    if min(rows, x.shape[1], block_rows) <= 0:
        raise ValueError("rmsnorm needs non-empty rows and blocks")
    if rows % min(block_rows, rows):
        raise ValueError(f"block_rows {block_rows} does not divide {rows}")


def _settle(x: torch.Tensor, w: torch.Tensor, eps: float,
            block_rows: int) -> Optional[Tuple[int, ctypes.Array, Callable]]:
    """Check a call's tensors once; None for the plain version, else the
    device index, the scalar block ``sk_rmsnorm`` reads (rows, d, the
    strides of x and w, the type code, eps's float32 bits, the SM count)
    and the entry point (the library is built at the first call)."""
    _check(x, w, block_rows)
    if placement(x, w) == "cpu":
        return None
    code = dtype_code(x, w)
    rows, d = x.shape
    if rows >= 2 ** 31:
        raise NotImplementedError("the CUDA rmsnorm takes < 2**31 rows")
    eps_bits = struct.unpack("<I", struct.pack("<f", eps))[0]
    block = (ctypes.c_longlong * 8)(rows, d, *x.stride(), w.stride(0), code,
                                    eps_bits, sm_count(x.device))
    return x.device.index, block, build.bound("rmsnorm")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 128) -> torch.Tensor:
    """x (rows, d), w (d,) -> (rows, d) in ``x.dtype``."""
    key = (x.shape, x.stride(), w.shape, w.stride(), x.dtype, w.dtype,
           x.device, w.device, eps, block_rows)
    try:
        call = _CALLS[key]
    except KeyError:
        call = _settle(x, w, eps, block_rows)
        if len(_CALLS) >= _MAX_CALLS:
            _CALLS.clear()
        _CALLS[key] = call
    if call is None:
        return rmsnorm_plain(x, w, eps=eps, block_rows=block_rows)
    idx, block, fn = call
    out = x.new_empty(x.shape)
    ptrs = _PTRS(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 torch._C._cuda_getCurrentRawStream(idx))
    if torch._C._cuda_getDevice() == idx:     # no device switch
        err = fn(ptrs, block)
    else:
        with torch.cuda.device(idx):
            err = fn(ptrs, block)
    if err:
        build.raise_launch_error("rmsnorm", err)
    build.count_launch("rmsnorm")
    return out


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                  block_rows: int = 128) -> torch.Tensor:
    """The reference kernel's algorithm in torch ops, on any device (rows
    are independent, so the row blocks are not repeated)."""
    _check(x, w, block_rows)
    return rmsnorm_ref(x, w, eps)
