"""Build, load and launch the standalone kernels.

``nvcc`` compiles ``csrc/standalone.cu`` with the megakernel's flags
(``megakernel/build.py`` ``compile_source``) into
``build/repro_torch/libstandalone_<hash>.so`` at the first launch, never
at import.  ``launch`` calls one of its C entry points on the current
stream of the tensors' card, raises the CUDA error code it returns, and
adds one to that kernel's launch count.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = ["SOURCE", "build_library", "load_library", "placement",
           "dtype_code", "launch", "launch_counts", "reset_launch_counts"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "standalone.cu"

#: the kernels' element types, as the C interface numbers them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: Optional[ctypes.CDLL] = None
_LAUNCHES: Dict[str, int] = {"matmul": 0, "rmsnorm": 0,
                             "flash_attention": 0}


def build_library() -> Tuple[Path, str]:
    """Compile the kernels if this source and these flags have no build
    yet; returns (library path, the compiler's output or "cached")."""
    from ..megakernel.build import compile_source
    return compile_source(SOURCE, "standalone")


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures set (built at first use)."""
    global _LIB
    if _LIB is None:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sk_matmul.argtypes = [P, P, P] + [I64] * 7 + [I32, P]
        lib.sk_rmsnorm.argtypes = ([P, P, P] + [I64] * 5
                                   + [ctypes.c_float, I32, P])
        lib.sk_flash_attention.argtypes = ([P] * 4 + [I64] * 16
                                           + [I32, ctypes.c_float, I32, P])
        for fn in (lib.sk_matmul, lib.sk_rmsnorm, lib.sk_flash_attention):
            fn.restype = ctypes.c_int
        lib.sk_error_string.argtypes = [ctypes.c_int]
        lib.sk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def placement(*tensors: torch.Tensor) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel) for tensors on one
    device; any other device raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernels' code of the inputs' one element type; the kernels take
    float32 or bfloat16, all inputs of one type."""
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise NotImplementedError(
            "the CUDA kernels take float32 or bfloat16 inputs of one type, "
            f"not {sorted({str(t.dtype) for t in tensors})}")
    return _DTYPES[dt]


def launch(name: str, device: torch.device, *args) -> None:
    """Launch ``sk_<name>(*args, stream)`` on ``device``'s current stream;
    a launch the card refuses raises and is not counted."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "sk_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.sk_error_string(err).decode())
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches of each standalone kernel since the last
    ``reset_launch_counts``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
