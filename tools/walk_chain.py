#!/usr/bin/env python3
"""The event chain of a static megakernel plan, on the host (no card).

    python3 tools/walk_chain.py granite-moe-1b-a400m --rows-ms 0.766 \\
        --walk-ms 2.193 [--workers 132]

Compiles the model's static plan at full width (B=2, S=128, W the
partitioner picks up to ``--workers``) and reads its walk lists: the real
rows of each worker, the busiest worker's count, and the longest chain
of event links (a row that waits on an event follows every row that
signals it; a worker runs its rows in order).  Given the two walk
tables a card measured (``--rows-ms``: the rows-alone table, every row a
noop without event words; ``--walk-ms``: the all-noop table with them,
as ``tools/ab_megakernel.py`` and ``chip_smoke.py`` time them), it fits
a cost per row (the rows-alone time over the busiest worker's rows) and
the cost per link that makes the modelled walk equal the measured one.
The model: a row starts when its worker is free and, if it waits, one
link after the last of its event's signallers ended.  Imports no JAX.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def walk_time(descs, slots, W, c_row, c_link):
    """The modelled walk (ms) of rows costing ``c_row`` and links
    ``c_link``, in the reference's step-major order (every dependency
    crosses a step, so a signaller is always modelled first)."""
    free = np.zeros(W)
    ready = {}
    for s in slots:
        w, d = s % W, descs[s]
        t = free[w]
        if d[32] >= 0:
            t = max(t, ready.get(int(d[32]), 0.0) + c_link)
        free[w] = t = t + c_row
        if d[34] >= 0:
            ready[int(d[34])] = max(ready.get(int(d[34]), 0.0), t)
    return float(free.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("--workers", type=int, default=132)
    ap.add_argument("--rows-ms", type=float, required=True)
    ap.add_argument("--walk-ms", type=float, required=True)
    args = ap.parse_args()
    from repro_torch.configs import get_config
    from repro_torch.megakernel import compile_decode_megakernel
    t0 = time.perf_counter()
    plan = compile_decode_megakernel(get_config(args.arch), 2, 128,
                                     num_workers=args.workers)
    W, walk, descs = plan.num_workers, plan.walk, plan.descs
    slots = np.sort(walk[W + 1:])
    per = np.diff(walk[:W + 1])
    busiest = int(per.argmax())
    tasks = int((descs[slots, 0] != 0).sum())
    print(f"{args.arch}: W={W}, {plan.num_steps} steps, {descs.shape[0]} "
          f"grid rows, {slots.size} real rows ({tasks} tasks), mean "
          f"{per.mean():.1f} a worker, worker {busiest} {per[busiest]} "
          f"(host compile {time.perf_counter() - t0:.1f} s)")
    links = walk_time(descs, slots, W, 0.0, 1.0)
    c_row = args.rows_ms / per[busiest]
    lo, hi = 0.0, args.walk_ms
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if walk_time(descs, slots, W, c_row, mid) \
            < args.walk_ms else (lo, mid)
    print(f"  longest chain: {links:.0f} links; a row {c_row * 1e3:.3f} us "
          f"(rows-alone {args.rows_ms} ms over {per[busiest]} rows); a link "
          f"{lo * 1e3:.2f} us makes the walk {args.walk_ms} ms; rows alone "
          f"with free links model {walk_time(descs, slots, W, c_row, 0):.3f}"
          " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
