#!/usr/bin/env python3
"""Where the host time of one ``repro_torch.kernels.rmsnorm`` call goes,
for the checkout's launch path and a parent's, on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/rmsnorm_host.py build/parent

At deepseek-7b's width (256, 4096) and the test shape (256, 512), f32 and
bf16: each piece of a call timed alone on the host clock
(``time.perf_counter_ns`` over batches of calls, the card synchronised
between batches, best of 5 batches), then the whole call, the parent's
whole call, ``F.rms_norm`` and an empty Python call, and the whole calls
by CUDA events (100 calls after 10 warm-up, as ``chip_smoke.py`` phase
4 times them).  The pieces of the parent's path: its shape checks,
``placement``, ``dtype_code``, ``torch.empty``, the current device and
stream queries, ctypes' conversion of its 11 arguments (bound to a C
function that ignores them, libc's ``getpid``) and the launch itself
(``sk_rmsnorm`` less that conversion).  The checkout's: the cache key,
its lookup, ``new_empty``, the device and stream queries, the pointer
block and ctypes' 2 arguments, and the launch.  Prints the card's name and power limit and
one line per piece in microseconds.  Imports no JAX.
"""
import argparse
import ctypes
import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from ab_megakernel import load_package  # noqa: E402

BATCH, ROUNDS = 400, 5


def host_us(fn):
    """Best mean microseconds of ``fn()`` over ROUNDS batches."""
    best = None
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(BATCH):
            fn()
        t = (time.perf_counter_ns() - t0) / BATCH / 1e3
        torch.cuda.synchronize()
        best = t if best is None else min(best, t)
    return best


def events_us(fn, n=100):
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="root of the parent checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_host: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import repro_torch.kernels as sk
    from repro_torch.kernels import build
    rms_mod = importlib.import_module("repro_torch.kernels.rmsnorm")
    parent = load_package(args.parent.resolve(), "repro_torch_parent")
    psk = importlib.import_module("repro_torch_parent.kernels")
    pbuild = importlib.import_module("repro_torch_parent.kernels.build")
    prms = importlib.import_module("repro_torch_parent.kernels.rmsnorm")
    plib, lib = pbuild.load_library(), build.load_library()
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libc = ctypes.CDLL(None)
    conv11 = ctypes.CFUNCTYPE(I32, *([P, P, P] + [I64] * 5
                                     + [ctypes.c_float, I32, P]))(
        ctypes.cast(libc.getpid, ctypes.c_void_p).value)
    conv2 = ctypes.CFUNCTYPE(I32, ctypes.POINTER(I64), ctypes.POINTER(I64))(
        ctypes.cast(libc.getpid, ctypes.c_void_p).value)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, d in ((256, 4096), (256, 512)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, d, device=dev, generator=gen).to(dt)
            w = torch.randn(d, device=dev, generator=gen).to(dt)
            out = torch.empty_like(x)
            idx = x.device.index
            st = torch._C._cuda_getCurrentRawStream(idx)
            ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
            old_args = ptrs + (rows, d, *x.stride(), w.stride(0), 1e-6,
                               pbuild.dtype_code(x, w))
            sk.rmsnorm(x, w)
            key = (x.shape, x.stride(), w.shape, w.stride(), x.dtype,
                   w.dtype, x.device, w.device, 1e-6, 128)
            block = rms_mod._CALLS[key][1]
            pieces = {
                "parent: shape checks": lambda: prms._check(x, w, 128),
                "parent: placement": lambda: pbuild.placement(x, w),
                "parent: dtype_code": lambda: pbuild.dtype_code(x, w),
                "parent: torch.empty": lambda: torch.empty(
                    (rows, d), dtype=x.dtype, device=x.device),
                "parent: device and stream": lambda: (
                    torch.cuda.current_device(),
                    torch._C._cuda_getCurrentRawStream(idx)),
                "parent: ctypes, 11 arguments": lambda: conv11(
                    *old_args, st),
                "parent: sk_rmsnorm (ctypes and launch)": lambda:
                    plib.sk_rmsnorm(*old_args, st),
                "parent: whole call": lambda: psk.rmsnorm(x, w),
                "change: cache key": lambda: (
                    x.shape, x.stride(), w.shape, w.stride(), x.dtype,
                    w.dtype, x.device, w.device, 1e-6, 128),
                "change: cache lookup": lambda: rms_mod._CALLS[key],
                "change: new_empty": lambda: x.new_empty(x.shape),
                "change: device and stream": lambda: (
                    torch._C._cuda_getDevice(),
                    torch._C._cuda_getCurrentRawStream(idx)),
                "change: pointer block": lambda: rms_mod._PTRS(*ptrs, st),
                "change: ctypes, 2 arguments": lambda: conv2(
                    rms_mod._PTRS(*ptrs, st), block),
                "change: sk_rmsnorm (block, ctypes and launch)": lambda:
                    lib.sk_rmsnorm(rms_mod._PTRS(*ptrs, st), block),
                "change: whole call": lambda: sk.rmsnorm(x, w),
                "F.rms_norm": lambda: F.rms_norm(x, (d,), w, 1e-6),
                "empty Python call": lambda: None,
            }
            print(f"({rows}, {d}) {str(dt).split('.')[-1]}, host us a call:",
                  flush=True)
            for name, fn in pieces.items():
                print(f"  {name}: {host_us(fn):.2f}", flush=True)
            for name, fn in (("parent", lambda: psk.rmsnorm(x, w)),
                             ("change", lambda: sk.rmsnorm(x, w)),
                             ("F.rms_norm",
                              lambda: F.rms_norm(x, (d,), w, 1e-6))):
                print(f"  by CUDA events, {name}: {events_us(fn):.2f}",
                      flush=True)
    del parent
    return 0


if __name__ == "__main__":
    sys.exit(main())
