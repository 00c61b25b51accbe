"""Build, load and launch the standalone kernels.

``nvcc`` compiles ``csrc/standalone.cu`` with the megakernel's flags
(``megakernel/build.py`` ``compile_source``) into
``build/repro_torch/libstandalone_<hash>.so`` at the first launch, never
at import.  ``launch`` calls one of its C entry points on the current
stream of the tensors' card, raises the CUDA error code it returns, and
adds the number of CUDA kernels it launched to that kernel's launch count.  The entry points are bound once;
the library caches the tensor maps it encodes.  ``tma_ready`` gives the
kernels operands they can copy by TMA or 16-byte ``cp.async``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["SOURCE", "build_library", "load_library", "placement",
           "dtype_code", "tma_ready", "sm_count", "launch", "bound",
           "raise_launch_error", "count_launch", "launch_counts",
           "reset_launch_counts"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "standalone.cu"

#: the kernels' element types, as the C interface numbers them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY: Dict[str, Callable[..., int]] = {}  # name -> bound C entry point
_SMS: Dict[int, int] = {}                   # device index -> SM count
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
        lib.sk_matmul.argtypes = [P] * 4 + [I64] * 7 + [I32] * 4 + [P]
        # two ctypes arrays, passed as pointers without a conversion
        lib.sk_rmsnorm.argtypes = None
        lib.sk_flash_attention.argtypes = ([P] * 4 + [I64] * 16
                                           + [I32, ctypes.c_float, I32, P])
        for fn in (lib.sk_matmul, lib.sk_rmsnorm, lib.sk_flash_attention):
            fn.restype = ctypes.c_int
        lib.sk_error_string.argtypes = [ctypes.c_int]
        lib.sk_error_string.restype = ctypes.c_char_p
        _ENTRY.update((n, getattr(lib, "sk_" + n)) for n in _LAUNCHES)
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


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can copy it as it lies (a unit inner stride,
    every other stride a positive multiple of 16 bytes, a 16-byte-aligned
    start), else a copy that can: the same values in a buffer whose rows
    are padded to 16 bytes.  The kernels read only the logical extent, so
    the padding is never read."""
    unit = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % unit == 0 for s in t.stride()[:-1])):
        return t
    inner = t.shape[-1]
    buf = t.new_empty((*t.shape[:-1], -(-inner // unit) * unit))
    return buf.narrow(-1, 0, inner).copy_(t)


def sm_count(device: torch.device) -> int:
    """The card's number of SMs (cached per device)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def bound(name: str) -> Callable[..., int]:
    """The C entry point ``sk_<name>`` with its signature set (the library
    is built and loaded at the first call)."""
    fn = _ENTRY.get(name)
    if fn is None:
        load_library()
        fn = _ENTRY[name]
    return fn


def raise_launch_error(name: str, err: int) -> None:
    raise RuntimeError(f"{name} launch failed: "
                       + _LIB.sk_error_string(err).decode())


def count_launch(name: str, kernels: int = 1) -> None:
    _LAUNCHES[name] += kernels


def launch(name: str, device: torch.device, *args,
           kernels: int = 1) -> None:
    """Call ``sk_<name>(*args, stream)`` on ``device``'s current stream and
    count the ``kernels`` CUDA kernels it launches there; a launch the card
    refuses raises and is not counted."""
    fn = bound(name)
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    if idx == cur:          # no device switch around the call
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise_launch_error(name, err)
    count_launch(name, kernels)


def launch_counts() -> Dict[str, int]:
    """CUDA kernel launches of each standalone kernel since the last
    ``reset_launch_counts``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
