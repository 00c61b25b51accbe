#!/usr/bin/env python3
"""Time two versions of the standalone kernels in turns, on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/ab_standalone.py build/parent [--pairs 10]

The parent's ``repro_torch`` (under ``<root>/src``) is imported as a
second package, ``repro_torch_parent``: its own wrappers, ``ctypes``
signatures and build of its ``standalone.cu`` (into
``<root>/build/repro_torch``).  At each full-width case of
``chip_smoke.py``'s phase 4 (deepseek-7b's up-projection, rmsnorm and
causal attention; f32 and bf16), from one set of seeded inputs, both
wrappers run ``--pairs`` pairs (CUDA events around a run of calls sized
to ~10 ms, after a warm-up call), the pair's first side alternating.
Both sides are held to the checkout's plain version at ``chip_smoke``'s
tolerances, and every launch of the change is bitwise its first.  The
rmsnorm kernel is the same on both sides, so its pairs compare the
wrappers' host cost.  Cases the parent refuses (gemma-7b's head width
256) are timed on the change alone.  Prints the card's name and power
limit, each side's times, medians, quartiles, the ratio of the medians
and how many pairs each side won.  Imports no JAX.
"""
import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (kernel, dims, keywords) at full width, as chip_smoke.py's phase 4
CASES = (("matmul", (256, 4096, 11008), {}),
         ("rmsnorm", (256, 4096), {}),
         ("flash_attention", (1, 4096, 32, 128), {}),
         ("flash_attention", (1, 4096, 16, 256), {}))


def load_parent(root: Path):
    """The parent checkout's ``repro_torch`` as ``repro_torch_parent``."""
    init = root / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_parent", init,
        submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("repro_torch_parent.kernels")


def run_ms(fn, n):
    """Mean milliseconds of ``n`` back-to-back calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="root of the parent checkout")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_standalone: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (STANDALONE_BF16_DIFFER, STANDALONE_TOL, _close,
                            _standalone_inputs)
    from repro_torch import kernels as change
    parent = load_parent(args.parent.resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, dims, kw in CASES:
        x32 = _standalone_inputs(name, dims, gen)
        for dt in (torch.float32, torch.bfloat16):
            xs = tuple(t.to(dt) for t in x32)
            want = getattr(change, name + "_plain")(*xs, **kw)
            rtol, atol = STANDALONE_TOL[name][dt == torch.bfloat16]
            sides = {"change": getattr(change, name)}
            try:
                getattr(parent, name)(*xs, **kw)
                sides["parent"] = getattr(parent, name)
            except NotImplementedError as exc:
                print(f"  parent refuses {name} {dims}: {exc}")
            first = {}
            for side, fn in sides.items():
                got = fn(*xs, **kw)
                _close(got, want, rtol, atol)
                differ = float((got != want).float().mean())
                assert dt == torch.float32 or differ <= \
                    STANDALONE_BF16_DIFFER, (side, differ)
                first[side] = got
            torch.cuda.synchronize()
            n = max(3, min(200, round(10 / run_ms(
                lambda: sides["change"](*xs, **kw), 3))))
            times = {side: [] for side in sides}
            for i in range(args.pairs):
                order = list(sides) if i % 2 == 0 else list(sides)[::-1]
                for side in order:
                    fn = sides[side]
                    out = fn(*xs, **kw)                     # warm-up
                    times[side].append(run_ms(lambda: fn(*xs, **kw), n))
                    if side == "change":
                        assert torch.equal(out, first["change"]), (name, i)
            print(f"{name} {dims} {str(dt)[6:]}: {args.pairs} pairs of {n} "
                  "calls, first side alternating; both sides within "
                  f"rtol {rtol:g}, atol {atol:g} of the plain version")
            for side, t in times.items():
                t = np.array(t)
                print(f"  {side}: median {np.median(t):.6f} ms, quartiles "
                      f"{np.percentile(t, 25):.6f}-"
                      f"{np.percentile(t, 75):.6f} ms; "
                      + " ".join(f"{x:.6f}" for x in t), flush=True)
            if "parent" in times:
                p, c = np.array(times["parent"]), np.array(times["change"])
                print(f"  change faster in {int((c < p).sum())} of "
                      f"{args.pairs} pairs; parent / change median "
                      f"{np.median(p) / np.median(c):.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
