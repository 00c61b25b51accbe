#!/usr/bin/env python3
"""Time the decode step of two versions of the CUDA megakernel in turns,
on one card, on one heap.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/ab_megakernel.py build/parent [--arch deepseek-7b]

The parent's ``repro_torch`` (under ``<root>/src``) is imported as a
second package, ``repro_torch_parent``: its own ``megakernel`` wrapper,
``ctypes`` signature and build of its ``megakernel.cu`` (into
``<root>/build/repro_torch``).  The checkout's package compiles the
plan once (static scheduler, full depth at W = the card's SM count, B=2,
S=128, weights drawn from seed 0) and both wrappers launch its table
against the same heap: ``--pairs`` pairs of 5 launches (CUDA events
around each launch, after the step's ``index_copy_``), the pair's first
side alternating, and every launch's logits bitwise those of the first.
Prints the card's name and power limit, each side's launch times, the
medians and quartiles and how many pairs each side won.  Imports no JAX.
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


def load_parent(root: Path):
    """The parent checkout's ``repro_torch`` as ``repro_torch_parent``."""
    init = root / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_parent", init,
        submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_parent"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("repro_torch_parent.megakernel")
    return mod


def step_ms(ex, launch, toks, lens):
    """One launch of ``launch`` after the step's inputs, by CUDA events."""
    ex.write_step_inputs(toks, lens)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="root of the parent checkout")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_megakernel: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel, megakernel)
    parent = load_parent(args.parent.resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    w = torch.cuda.get_device_properties(0).multi_processor_count
    plan = compile_decode_megakernel(cfg, 2, 128, num_workers=w)
    ex = MegakernelExecutor(plan, cfg, "cuda")
    ex.init_weights(torch.Generator(device="cuda").manual_seed(0))
    descs = torch.from_numpy(plan.descs).cuda()
    sides = {"parent": parent.megakernel.megakernel, "change": megakernel}
    toks = np.random.default_rng(0).integers(1, cfg.vocab, size=2)
    lens = np.array([64, 64])
    times = {k: [] for k in sides}
    first = None
    for i in range(args.pairs):
        for name in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            fn = sides[name]
            launch = lambda: fn(ex.heap, descs, plan.statics)  # noqa: E731
            step_ms(ex, launch, toks, lens)                    # warm-up
            times[name].append(float(np.mean(
                [step_ms(ex, launch, toks, lens) for _ in range(5)])))
            got = plan.view(ex.heap, "logits").clone()
            first = got if first is None else first
            assert torch.equal(got, first), (name, i)
    print(f"{cfg.name}, static step at lengths (64, 64), W={plan.num_workers}"
          f", {args.pairs} pairs of 5 launches, first side alternating; "
          "logits bitwise equal on both sides")
    p, c = np.array(times["parent"]), np.array(times["change"])
    for name, t in (("parent", p), ("change", c)):
        print(f"  {name}: median {np.median(t):.3f} ms, quartiles "
              f"{np.percentile(t, 25):.3f}-{np.percentile(t, 75):.3f} ms; "
              + " ".join(f"{x:.3f}" for x in t))
    print(f"  change faster in {int((c < p).sum())} of {args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
