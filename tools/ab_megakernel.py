#!/usr/bin/env python3
"""Time the static decode step of several versions of the CUDA megakernel
in turns, on one card, on one heap per model.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 tools/ab_megakernel.py build/parent [more roots] \\
        [--arch served | deepseek-7b,granite-moe-1b-a400m,...] \\
        [--json build/ab_megakernel.json]

Each root's ``repro_torch`` (under ``<root>/src``) is imported as a
package of its own (``repro_torch_<i>``): its own ``megakernel`` wrapper,
``ctypes`` signature and build of its ``megakernel.cu`` (into
``<root>/build/repro_torch``; every side's library is built first, in
parallel).  The checkout's package ("change") compiles each model's
static plan once (full width, B=2, S=128, W = the card's SM count;
weights drawn from seed 0, the Mamba2 and qkv bias vectors redrawn per
head as ``chip_smoke.py`` does) and every side launches that table
against the same heap, the checkout's with the plan's walk lists.
``--arch served`` (the default) is every model ``chip_smoke.py`` serves:
deepseek-7b, granite-moe-1b-a400m, mamba2-2.7b at its served 16 layers,
qwen2-vl-2b, musicgen-large at its served 24 layers, granite at TP=4
(W = SMs // 4) and gemma-7b at its served 28 layers.  A side whose
package's ``check_plan`` refuses a model's plan (a parent from before
the kernel took that model: gemma-7b's 5,376-column head tiles before
the matmul's passes) sits that model out, and says so.

Per model, ``--pairs`` rounds; in each, every side in turn (the order
rotating by one a round): 5 launches of the step at lengths (64, 64),
then 3 of the all-noop table (every row a noop, its event words kept:
the walk) and 3 of the rows-alone table (every row a noop without event
words: the per-row cost; their difference is the event chain), CUDA
events around each launch after the step's ``index_copy_``; the
recurrent state (conv windows, SSD states) is restored before every
launch.  After each side's turn one more step from the restored state
must give logits, every state tensor and every router bitwise equal to
that side's first such step, and logits within ``LOGITS_TOL`` of the
checkout's (two versions may sum a matmul's K rows in other orders).
Prints the card's name and power limit, each side's
times, medians and quartiles, and how many rounds the checkout won
against the first root.

A side whose library exports ``mk_set_stamp`` (a stamped copy written by
``tools/prefetch_variants.py --stamp``) also runs one more step with its
per-task ``%globaltimer`` stamps on; the tool prints, in microseconds, the
busiest worker's (the one whose last task ends last) sum of each part of
its task rows (the wait; the primary tile in place after it; the first
weight bytes after that; thread 0's share of the weight stream; the rest
of the task up to its stores; the gap from a task's stores to the next
task's wait, which holds its signal, its noop rows and the next row's
copy), the medians of each part over every matmul and expert GEMM task
of the step, and the median gap.  Imports no JAX.
"""
import argparse
import ctypes
import dataclasses
import gc
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, S = 2, 128
#: logits of two sides may differ by their matmuls' summation orders: the
#: kernel's tolerance against its plain version (chip_smoke.py)
LOGITS_TOL = 2e-4
MAMBA_SERVED_LAYERS = 16
MUSICGEN_SERVED_LAYERS = 24
GEMMA_SERVED_LAYERS = 28
SERVED = ("deepseek-7b", "granite-moe-1b-a400m", "mamba2-2.7b",
          "qwen2-vl-2b", "musicgen-large", "granite-moe-1b-a400m tp=4",
          "gemma-7b")


def load_package(root: Path, name: str):
    """The ``repro_torch`` under ``root/src`` imported as ``name``."""
    init = root / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(name + ".megakernel")
    return mod


def _config(arch: str):
    """(config, tp) of one served model, cut as ``chip_smoke.py`` serves
    it."""
    from repro_torch.configs import get_config
    name, _, tp = arch.partition(" tp=")
    cfg = get_config(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    if name == "mamba2-2.7b":
        cfg = dataclasses.replace(cfg, n_layers=MAMBA_SERVED_LAYERS)
    if name == "musicgen-large":
        cfg = dataclasses.replace(cfg, n_layers=MUSICGEN_SERVED_LAYERS)
    if name == "gemma-7b":
        cfg = dataclasses.replace(cfg, n_layers=GEMMA_SERVED_LAYERS)
    return cfg, int(tp or 1)


def _redraw(plan, heap, gen):
    """The per-head vectors the reference initialises to one value
    (Mamba2's A_log, D_skip, dt_bias, conv biases) and the zero qkv
    biases, redrawn as ``chip_smoke.py`` does."""
    for name in plan.input_classes()["weights"]:
        leaf, v = name.split(".")[-1], plan.view(heap, name)
        if leaf == "A_log":
            v.uniform_(0.0, 2.8, generator=gen)
        elif leaf == "D_skip":
            v.uniform_(0.5, 1.5, generator=gen)
        elif leaf == "dt_bias":
            v.normal_(0.0, 0.5, generator=gen)
        elif leaf.startswith("conv_b") or leaf in ("bq", "bk", "bv"):
            v.normal_(0.0, 0.1, generator=gen)


def _stats(t):
    t = np.asarray(t)
    return {"median": float(np.median(t)), "q1": float(np.percentile(t, 25)),
            "q3": float(np.percentile(t, 75)), "all": [float(x) for x in t]}


#: the parts of a stamped task row: (name, first stamp, last stamp)
PARTS = (("wait", 0, 1), ("in_place", 1, 2), ("first_weight", 2, 3),
         ("stream", 3, 4), ("rest", 4, 5))


def stamp_tables(descs, W, st):
    """The stamp tables of one step from its (rows, 8) stamps (ns; 0:
    not stamped): the busiest worker's sums, the medians over the
    weight-streaming tasks (kinds 1 and 10), the median gap; µs."""
    rows = np.flatnonzero(st[:, 0] > 0)
    t = st[rows].astype(np.int64)
    kinds = descs[rows, 0]
    mm = np.isin(kinds, (1, 10))
    t[~mm, 3] = t[~mm, 4] = t[~mm, 2]    # no stream: in place -> rest
    part = {n: (t[:, b] - t[:, a]) / 1e3 for n, a, b in PARTS}
    workers = rows % W
    gap = np.full(rows.size, np.nan)
    span = {}
    for w in np.unique(workers):
        idx = np.flatnonzero(workers == w)
        idx = idx[np.argsort(t[idx, 0])]
        gap[idx[1:]] = (t[idx[1:], 0] - t[idx[:-1], 5]) / 1e3
        span[int(w)] = (idx, (t[idx[-1], 5] - t[idx[0], 0]) / 1e3)
    t_end = {w: t[idx[-1], 5] for w, (idx, _) in span.items()}
    busy = max(t_end, key=t_end.get)
    idx = span[busy][0]
    return {"worker": busy, "tasks": int(idx.size),
            "weight_tasks": int(mm[idx].sum()), "span_us": span[busy][1],
            "step_us": (t[:, 5].max() - t[:, 0].min()) / 1e3,
            "busiest_sum_us": {n: float(np.sum(v[idx]))
                               for n, v in part.items()}
            | {"gap": float(np.nansum(gap[idx]))},
            "weight_task_median_us": {n: float(np.median(v[mm]))
                                      for n, v in part.items()},
            "gap_median_us": float(np.nanmedian(gap))}


def run_model(arch, sides, pairs, w_max):
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel)
    cfg, tp = _config(arch)
    t0 = time.perf_counter()
    plan = compile_decode_megakernel(cfg, B, S, num_workers=w_max // tp,
                                     tp=tp)
    compile_s = time.perf_counter() - t0
    refused = {}
    for name, (_, _, check) in sides.items():
        try:
            check(plan.statics, plan.descs)
        except NotImplementedError as e:
            refused[name] = str(e)
    sides = {n: s for n, s in sides.items() if n not in refused}
    ex = MegakernelExecutor(plan, cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ex.init_weights(gen)
    _redraw(plan, ex.heap, gen)
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((B, cfg.d_model)).astype(np.float32)
              if cfg.embed_input else rng.integers(1, cfg.vocab, size=B))
    lens = np.array([64, 64])
    state = plan.input_classes()["state"]
    rec = [n for n in state if not n.endswith(("k_cache", "v_cache"))]
    pre = {n: plan.view(ex.heap, n).clone() for n in rec}
    watched = ["logits"] + state + [n for n in plan.layout
                                    if n.endswith(".router")]
    descs = torch.from_numpy(plan.descs).cuda()
    walk_t = plan.descs.copy()
    walk_t[:, 0] = 0
    rows_t = walk_t.copy()
    rows_t[:, 32:35] = -1
    tables = {"step": descs, "walk": torch.from_numpy(walk_t).cuda(),
              "rows": torch.from_numpy(rows_t).cuda()}

    def launcher(fn, table):
        kw = {"acks": ex._acks}
        if "walk" in inspect.signature(fn).parameters:
            kw["walk"] = ex._walk
        return lambda: fn(ex.heap, table, plan.statics, None, **kw)

    def launch_ms(launch):
        for n, t in pre.items():
            plan.view(ex.heap, n).copy_(t)
        ex.write_step_inputs(inputs, lens)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    names = list(sides)
    times = {n: {k: [] for k in tables} for n in names}
    first = {}                          # each side's first step
    logit_err = 0.0
    for i in range(pairs):
        order = names[i % len(names):] + names[:i % len(names)]
        for name in order:
            for k, table in tables.items():
                launch = launcher(sides[name][0], table)
                launch_ms(launch)                           # warm-up
                times[name][k].append(float(np.mean(
                    [launch_ms(launch) for _ in range(5 if k == "step"
                                                      else 3)])))
            launch_ms(launcher(sides[name][0], descs))
            got = {n: plan.view(ex.heap, n).clone() for n in watched}
            first.setdefault(name, got)
            for n in watched:
                assert torch.equal(got[n], first[name][n]), (arch, name, i, n)
            lead = first.get(names[0], got)
            err = (got["logits"] - lead["logits"]).abs().max().item()
            logit_err = max(logit_err, err)
            assert err <= LOGITS_TOL, (arch, name, i, err)
    stamps = {}
    for name, (fn, build, _) in sides.items():
        lib = build.load_library()
        if not hasattr(lib, "mk_set_stamp"):
            continue
        lib.mk_set_stamp.argtypes = [ctypes.c_void_p]
        lib.mk_set_stamp.restype = ctypes.c_int
        buf = torch.zeros(plan.descs.shape[0] * 8, dtype=torch.int64,
                          device="cuda")
        assert lib.mk_set_stamp(buf.data_ptr()) == 0
        launch_ms(launcher(fn, descs))
        assert lib.mk_set_stamp(None) == 0
        stamps[name] = stamp_tables(plan.descs, plan.num_workers,
                                    buf.view(-1, 8).cpu().numpy())
    out = {"arch": arch, "workers": plan.num_workers, "tp": tp,
           "layers": cfg.n_layers, "rows": int(plan.descs.shape[0]),
           "steps": plan.num_steps, "compile_s": compile_s,
           "real_rows": int(plan.walk.size - plan.num_workers - 1),
           "logits_max_abs_diff": logit_err,
           "sides": {n: {k: _stats(v) for k, v in t.items()}
                     for n, t in times.items()}, "stamps": stamps,
           "refused": refused}
    if len(names) > 1:
        base, chg = names[1], names[0]
        out["base"] = base
        out["change_faster"] = int((np.array(times[chg]["step"])
                                    < np.array(times[base]["step"])).sum())
    del ex, descs, tables, first, pre
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", type=Path, nargs="+",
                    help="roots of the other checkouts (the first is the "
                         "parent)")
    ap.add_argument("--arch", default="served",
                    help="'served' or a comma-separated list of models, "
                         "'<model> tp=4' for TP")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--json", type=Path, help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_megakernel: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.megakernel import build, megakernel
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.megakernel.kernel import check_plan
    sides = {"change": (megakernel, build, check_plan)}
    for i, root in enumerate(args.roots):
        pkg = load_package(root.resolve(), f"repro_torch_{i}")
        sides[root.resolve().name] = (
            pkg.megakernel.megakernel,
            importlib.import_module(f"repro_torch_{i}.megakernel.build"),
            importlib.import_module(
                f"repro_torch_{i}.megakernel.kernel").check_plan)
    builds = [b for _, b, _ in sides.values()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc per side
        list(pool.map(lambda m: m.build_library(), builds))
    print(f"built {len(builds)} megakernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    archs = SERVED if args.arch == "served" else args.arch.split(",")
    results = []
    for arch in archs:
        r = run_model(arch, sides, args.pairs, w_max)
        results.append(r)
        print(f"{arch}: {r['layers']} layers, W={r['workers']}, "
              f"{r['steps']} steps, {r['rows']} grid rows, "
              f"{r['real_rows']} real rows (host compile "
              f"{r['compile_s']:.1f} s); {args.pairs} rounds, first side "
              "rotating; logits, state and routers bitwise equal across "
              "each side's rounds, logits of the sides at most "
              f"{r['logits_max_abs_diff']:.3g} apart", flush=True)
        for name, t in r["sides"].items():
            print("  " + name + ": " + "; ".join(
                f"{k} median {v['median']:.3f} ms ({v['q1']:.3f}-"
                f"{v['q3']:.3f})" for k, v in t.items()), flush=True)
        for name, why in r["refused"].items():
            print(f"  {name} sits this model out: {why}", flush=True)
        if "change_faster" in r:
            print(f"  change faster than {r['base']} in "
                  f"{r['change_faster']} of {args.pairs} rounds", flush=True)
        for name, st in r["stamps"].items():
            print(f"  stamps {name}: busiest worker {st['worker']} "
                  f"({st['tasks']} tasks, {st['weight_tasks']} streaming "
                  f"weights, {st['span_us']:.1f} us of a {st['step_us']:.1f}"
                  " us step); its sums (us) " + ", ".join(
                      f"{k} {v:.1f}" for k, v in
                      st["busiest_sum_us"].items())
                  + "; medians over the weight-streaming tasks (us) "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              st["weight_task_median_us"].items())
                  + f"; median gap {st['gap_median_us']:.2f} us",
                  flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
