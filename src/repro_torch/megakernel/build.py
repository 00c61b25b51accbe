"""Build and load the CUDA megakernel.

``nvcc`` compiles ``csrc/megakernel.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds).  The library goes into
``build/repro_torch/`` at the root of the checkout at first use, named
by a hash of the source and the flags so that an edited source is never
served a stale build.  ``nvcc`` is ``$CUDA_HOME/bin/nvcc``,
``/usr/local/cuda/bin/nvcc`` or the one on ``PATH``.  ``compile_source``
builds any other source of the port the same way (the standalone
kernels, ``repro_torch/kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "compile_source",
           "build_library", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "megakernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def compile_source(source: Path, stem: str) -> Tuple[Path, str]:
    """Compile ``source`` into ``BUILD_DIR/lib<stem>_<hash>.so`` if this
    source and these flags have no build yet; returns (library path, the
    compiler's output or "cached").  A failed compile raises with the
    compiler's output."""
    key = hashlib.sha1(source.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{key}.so"
    if lib.exists():
        return lib, "cached"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build_library() -> Tuple[Path, str]:
    """Compile the megakernel if this source and these flags have no
    build yet; returns (library path, the compiler's output or
    "cached")."""
    return compile_source(SOURCE, "megakernel")


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures set (built at first use)."""
    global _LIB
    if _LIB is None:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        P, I64 = ctypes.c_void_p, ctypes.c_longlong
        lib.mk_launch.argtypes = ([P, P] + [I64] * 11
                                  + [ctypes.c_double, I64, I64, I64, P]
                                  + [I64] * 13 + [P, P] + [I64] * 3 + [P])
        lib.mk_launch.restype = ctypes.c_int
        lib.mk_max_workers.argtypes = [I64, I64]
        lib.mk_max_workers.restype = I64
        lib.mk_last_statics.argtypes = [P]
        lib.mk_last_statics.restype = None
        lib.mk_error_string.argtypes = [ctypes.c_int]
        lib.mk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB

