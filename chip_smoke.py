#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Drives the port's main path on the card, imports nothing of JAX or of the
JAX package, and fails (non-zero exit, no result line) on any fault.
W_max is the card's SM count (132 on an H100): the megakernel is asked
for that many workers, and the partitioner picks the width it uses.

1. prints the card's name and power limit, then builds the CUDA
   megakernel from ``src/repro_torch/megakernel/csrc`` for sm_90a; a W
   larger than the CTAs the card holds at once is refused before launch,
   and a wait on an event nobody signals fails its process at the
   deadline (a child process, since the fault ends its CUDA context);
2. full-width deepseek-7b cut to 2 layers (B=2, S=128), one heap image:
   one decode step at W ∈ {1, 2, 4, W_max} — logits and KV caches
   bitwise equal across W, each W within 2e-4 of the plain PyTorch
   version with the embedding and the cache-update copies bitwise, no
   event-wait violation and the waits and signals the table implies on
   every worker.  Then the same step traced at W_max: the heap outside
   the ring bitwise equal to the untraced run, the ticks a permutation,
   the event order clean, the Perfetto export valid;
3. the slice itself: full 30-layer deepseek-7b (B=2, S=128, random
   weights drawn from a seeded generator straight into the heap), one
   plan at W_max.  A ``ServingEngine`` answers 4 requests (16-token
   prompts, 8 new tokens) with every decode step one kernel launch; the
   same calls are then teacher-forced through the torch Program, which
   reads the weights as strided views of the same heap, and every decode
   step's logits are held to it within 3e-4.  The W = 1 table runs on
   the same heap (the layout of weights and state does not depend on W)
   and its logits equal W_max's bitwise.  Then the decode step is timed
   at W = 1 and at W_max (CUDA events, after warm-up) beside the torch
   Program's step and the plain version, the kernel's logits are held to
   the plain version's within 3e-4, the per-worker counters are shown,
   and each task kind is timed alone at W_max;
4. prints one JSON line on the kernels (launches on the main path, error
   against the plain version, times, the bound), the device line last.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
B, S = 2, 128
H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_F32_FLOPS = 67e12             # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def _events_ms(fn, n):
    """Mean milliseconds of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _close(a, b, tol):
    """max |a - b| after checking |a - b| <= tol + tol * |b| everywhere."""
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    err = (a - b).abs()
    assert bool((err <= tol + tol * b.abs()).all()), float(err.max())
    return float(err.max())


def phase_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.megakernel.build import build_library
    t0 = time.perf_counter()
    path, out = build_library()
    log(f"phase 1 ok: built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  nvcc:", line.strip())


_STUCK = r"""
import torch
from repro_torch.megakernel.kernel import megakernel
statics = {"W": 1, "TN": 128, "TK": 128, "HD": 128, "G": 1,
           "STORE_CH": 128, "THETA": 1e4, "EVENT_OFF": 0, "N_EVENTS": 1,
           "STATS_OFF": 8}
heap = torch.zeros(64, device="cuda")
descs = torch.zeros((1, 36), dtype=torch.int64)
descs[:, 32] = -1
descs[:, 34] = -1
megakernel(heap, descs.cuda(), statics)
torch.cuda.synchronize()
print("clean launch ok", flush=True)
descs[0, 32], descs[0, 33] = 0, 1
megakernel(heap, descs.cuda(), statics)
torch.cuda.synchronize()
print("no fault", flush=True)
"""


def phase_faults(plan, w_max):
    """With the statics of the full-width plan: a W that cannot be
    resident raises before launch; a wait past its deadline fails its
    process instead of hanging."""
    from repro_torch.megakernel import (launch_count, megakernel,
                                        reset_launch_count)
    from repro_torch.megakernel.kernel import (SPIN_TIMEOUT_S,
                                               check_workers, max_workers)
    n = max_workers(plan.statics, "cuda")
    assert n >= w_max, (n, w_max)
    statics = dict(plan.statics, W=n + 1)
    try:
        check_workers(statics, "cuda")
        raise AssertionError("check_workers took W beyond residency")
    except RuntimeError as exc:
        assert "resident" in str(exc), exc
    descs = torch.full((n + 1, 36), -1, dtype=torch.int64, device="cuda")
    descs[:, 0] = 0
    heap = torch.zeros(64, device="cuda")        # nothing may run on it
    reset_launch_count()
    try:
        megakernel(heap, descs, statics)
        raise AssertionError("a grid beyond residency was launched")
    except RuntimeError as exc:
        refused = str(exc)
    assert launch_count() == 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STUCK],
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True,
                          timeout=SPIN_TIMEOUT_S + 120)
    took = time.perf_counter() - t0
    assert proc.returncode != 0 and "clean launch ok" in proc.stdout \
        and "no fault" not in proc.stdout, (proc.stdout, proc.stderr)
    err = [ln for ln in proc.stderr.splitlines() if "CUDA error" in ln]
    assert err and took >= SPIN_TIMEOUT_S, (proc.stderr[-2000:], took)
    fault = [ln for ln in proc.stdout.splitlines() if "deadline" in ln]
    log(f"faults ok: {n} CTAs fit at once; W={n + 1} refused before "
        f"launch ({refused}); a wait on an unsignalled event failed its "
        f"process after {took:.1f} s (deadline {SPIN_TIMEOUT_S} s, process "
        f"start included): {err[-1].strip()}"
        + (f"; the kernel printed: {fault[0].strip()}" if fault else ""))


def _check_cache_updates(plan, heap, plain, seq_lens):
    """Each cache update copied its new K/V row exactly, into row
    ``seq_lens[b]`` only: in both heaps the written row equals its source
    bitwise and the kernel's other rows equal the plain version's; the
    new rows agree within 2e-4 across the two (they come out of RoPE and
    a matmul).  Returns the number of cache updates checked."""
    from repro_torch.core.graph import OpKind
    n = 0
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CACHE_UPDATE:
            continue
        cache, new = op.inputs[0], op.inputs[1]
        for h in (heap, plain):
            c, v = plan.view(h, cache), plan.view(h, new)
            for b, s in enumerate(seq_lens):
                assert torch.equal(c[b, s], v[b]), (cache, b)
        keep = torch.ones(plan.layout[cache].shape[:2], dtype=torch.bool)
        keep[torch.arange(len(seq_lens)), torch.tensor(seq_lens)] = False
        keep = keep.to(heap.device)
        assert torch.equal(plan.view(heap, cache)[keep],
                           plan.view(plain, cache)[keep]), cache
        _close(plan.view(heap, new), plan.view(plain, new), 2e-4)
        n += 1
    return n


def _table_events(plan):
    """Per worker: (tasks, waits, signals) that the descriptor grid
    holds."""
    d, W = plan.descs, plan.num_workers
    w = np.arange(d.shape[0]) % W
    return [(int((d[w == i, 0] != 0).sum()), int((d[w == i, 32] >= 0).sum()),
             int((d[w == i, 34] >= 0).sum())) for i in range(W)]


def _check_events(plan, counters):
    """Zero violations, and the waits and signals the table implies, on
    every worker; returns the totals (waits, signals)."""
    assert len(counters) == plan.num_workers
    for c, (_, waits, sigs) in zip(counters, _table_events(plan)):
        assert c["event_wait_violations"] == 0, c
        assert (c["event_waits"], c["event_signals"]) == (waits, sigs), c
    return (sum(c["event_waits"] for c in counters),
            sum(c["event_signals"] for c in counters))


def phase_workers(cfg, w_max):
    """Two layers at full width, one heap image: the kernel at W ∈ {1, 2,
    4, W_max} against each other and against its plain version, then
    traced at W_max."""
    import dataclasses
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.megakernel.desc import lower_tgraph
    from repro_torch.megakernel.ops import read_stats_block
    from repro_torch.obs import (check_event_order, chrome_trace,
                                 decode_ring, validate_chrome_trace)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    plans = {}
    for w in (1, 2, 4, w_max):
        t0 = time.perf_counter()
        plans[w] = compile_decode_megakernel(cfg2, B, S, num_workers=w)
        p = plans[w]
        log(f"  2-layer plan at W={w}: {p.num_workers} workers used, "
            f"{p.num_steps} steps, {p.descs.shape[0]} rows, {p.num_events} "
            f"event counters ({time.perf_counter() - t0:.1f} s)")
    wide = plans[w_max]
    traced = lower_tgraph(wide.compiled, cfg2, trace=True)
    p1 = plans[1]
    log(f"  heap {traced.heap_size * 4 / 1e9:.2f} GB, statics "
        f"TN={p1.statics['TN']} TM={p1.statics['TM']} TK={p1.statics['TK']}")
    phase_faults(wide, w_max)

    # one heap image, sized for the largest tail (the traced W_max plan)
    src = MegakernelExecutor(traced, cfg2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    src.init_weights(gen)
    for name in traced.input_classes()["state"]:
        traced.view(src.heap, name).normal_(0.0, 1.0, generator=gen)
    base = src.heap
    rng = np.random.default_rng(SEED)
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([37, 90])
    state = p1.input_classes()["state"]

    def run(plan):
        ex = MegakernelExecutor(plan, cfg2, "cuda")
        ex.upload(base.clone())
        ex.write_step_inputs(toks, lens)
        reset_launch_count()
        ex.launch()
        torch.cuda.synchronize()
        assert launch_count() == 1
        return ex

    errs, first, wide_heap = [], None, None
    for w, plan in plans.items():
        ex = run(plan)
        plain = base.clone()
        ex_plain = MegakernelExecutor(plan, cfg2, "cuda")
        ex_plain.upload(plain)
        ex_plain.write_step_inputs(toks, lens)
        megakernel_plain(plain, plan.descs, plan.statics)
        torch.cuda.synchronize()
        errs.append(_close(plan.view(ex.heap, "logits"),
                           plan.view(plain, "logits"), 2e-4))
        assert torch.equal(plan.view(ex.heap, "h0"), plan.view(plain, "h0"))
        n_caches = _check_cache_updates(plan, ex.heap, plain, list(lens))
        counters = ex.worker_counters()
        assert counters == read_stats_block(plain, plan.stats_offset,
                                            plan.num_workers)
        waits, sigs = _check_events(plan, counters)
        outs = {n: plan.view(ex.heap, n) for n in ["logits"] + state}
        if first is None:
            first = {n: v.clone() for n, v in outs.items()}
        for n, v in outs.items():
            assert torch.equal(v, first[n]), (w, n)
        log(f"  W={plan.num_workers}: logits and {len(state)} caches "
            f"{'kept' if w == 1 else 'bitwise equal to W=1'}; vs plain "
            f"max_err={errs[-1]:.3e} "
            f"(<= 2e-4), embedding and {n_caches} cache updates bitwise; "
            f"{waits} waits, {sigs} signals, 0 violations")
        del plain, ex_plain
        if w == w_max:
            wide_heap = ex.heap
        del ex
        torch.cuda.empty_cache()

    ex = run(traced)
    lo, hi = traced.ring_offset, traced.heap_size
    assert torch.equal(ex.heap[:lo], wide_heap[:lo])
    assert torch.equal(ex.heap[hi:], wide_heap[hi:])
    _check_events(traced, ex.worker_counters())
    ring = ex.task_ring()
    ticks = np.sort(np.concatenate([ring[:, 3], ring[:, 4]]))
    assert np.array_equal(ticks, np.arange(2 * ring.shape[0]))
    tl = decode_ring(traced, ring)
    order = check_event_order(tl)
    assert order == [], order[:5]
    assert validate_chrome_trace(chrome_trace(tl)) == []
    n_wait = sum(e.wait_ev >= 0 for e in tl.events)
    log(f"phase 2 ok: W in (1, 2, 4, {wide.num_workers}) bitwise equal, "
        f"max_err vs "
        f"plain {max(errs):.3e}; traced at W={traced.num_workers}: heap "
        f"outside the ring bitwise equal, {ring.shape[0]} slots with ticks "
        f"a permutation of 0..{2 * ring.shape[0] - 1}, check_event_order "
        f"clean over {len(tl.events)} events ({n_wait} waiters), "
        f"Perfetto JSON valid")
    del ex, wide_heap, src, base
    torch.cuda.empty_cache()
    return max(errs)


def _record(prog, calls):
    """Log every state-changing call of a megakernel Program with its
    result; every step must end with no event-wait violation."""
    step, prefill, reset = prog.step, prog.prefill, prog.reset_slot

    def rec_step(tokens, seq_lens, positions=None):
        out = step(tokens, seq_lens, positions)
        bad = prog.worker_stats["event_wait_violations"]
        assert bad == 0, bad
        calls.append(("step", np.array(tokens), np.array(seq_lens), out))
        return out

    def rec_prefill(tokens, seq_lens, chunk_lens=None):
        out = prefill(tokens, seq_lens, chunk_lens)
        calls.append(("prefill", np.array(tokens), np.array(seq_lens),
                      np.array(chunk_lens)))
        return out

    def rec_reset(slot):
        reset(slot)
        calls.append(("reset", slot))

    prog.step, prog.prefill, prog.reset_slot = rec_step, rec_prefill, \
        rec_reset


def _step_work(plan, cfg, lens):
    """Bytes a decode step must move and operations it must do, for these
    live lengths: every weight read once (of the embedding table only the
    B gathered rows), the live KV rows read once, the new KV rows and the
    logits written once; the FLOPs of the matmuls and of attention."""
    from repro_torch.core.graph import OpKind
    g = plan.compiled.graph
    shape = lambda n: plan.layout[n].shape
    weights = [n for n in plan.input_classes()["weights"] if n != "embed"]
    w_elems = sum(int(np.prod(shape(n))) for n in weights)
    mm_elems = sum(int(np.prod(shape(op.inputs[1]))) for op in g.ops
                   if op.kind == OpKind.MATMUL)
    kvd, qd = cfg.n_kv_heads * cfg.hd, cfg.n_heads * cfg.hd
    live = int(np.sum(np.asarray(lens) + 1))
    L = cfg.n_layers
    nbytes = 4 * (w_elems + B * cfg.d_model + 2 * L * live * kvd
                  + 2 * L * B * kvd + B * cfg.vocab)
    flops = 2 * B * mm_elems + 4 * L * live * qd
    return nbytes, flops


KIND_NAMES = ("noop", "matmul", "rmsnorm", "rope", "glu", "resid",
              "attention", "cache_update", "embed")


def _kernel_ms(ex, toks, lens, n, descs=None):
    """Mean milliseconds of the executor's kernel launch (or of a launch
    of ``descs`` on its heap) over ``n`` launches after one warm-up, by
    CUDA events around each launch alone; each launch follows the step's
    ``index_copy_``, which zeroes the event counters."""
    from repro_torch.megakernel import megakernel
    launch = ex.launch if descs is None else \
        (lambda: megakernel(ex.heap, descs, ex.plan.statics))
    times = []
    for i in range(n + 1):
        ex.write_step_inputs(toks, lens)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return sum(times) / n


def _time_by_kind(ex, plan, toks, lens):
    """Kernel time of each task kind alone: the step's descriptor table
    with every other row turned into a noop (its event words kept, so the
    workers still wait and signal), one launch after a warm-up.  The
    all-noop table is the walk itself (descriptor fetch, barriers, the
    event protocol).  Run last: the heap's activations are overwritten
    with partial results."""
    kinds = plan.descs[:, 0]
    out = []
    for code in [0] + sorted(set(kinds.tolist()) - {0}):
        table = plan.descs.copy()
        table[kinds != code, 0] = 0
        ms = _kernel_ms(ex, toks, lens, 1, torch.from_numpy(table).cuda())
        n = int((kinds == code).sum()) if code else len(kinds)
        out.append(f"{KIND_NAMES[code]} {ms:.2f} ms/{n}")
    return out


def phase_serve(cfg, w_max):
    """The slice: full deepseek-7b served through the kernel at W_max."""
    from repro_torch.api import compile as mk_compile
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.runtime import Request, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel", num_workers=w_max)
    plan = prog.plan
    W = plan.num_workers
    assert W >= 2, W
    log(f"  30-layer plan at W={w_max}: {W} workers used, {plan.num_steps} "
        f"steps, {plan.descs.shape[0]} rows, {plan.num_events} event "
        f"counters, heap {plan.heap_size * 4 / 1e9:.2f} GB "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    plan1 = compile_decode_megakernel(cfg, B, S)
    assert plan1.heap_size <= plan.heap_size
    assert all((plan1.layout[n].offset, plan1.layout[n].ld)
               == (plan.layout[n].offset, plan.layout[n].ld)
               for n in plan.layout)
    log(f"  30-layer plan at W=1: {plan1.descs.shape[0]} rows "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prog.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"  weights drawn into the heap in {time.perf_counter() - t0:.1f} s")
    ref = mk_compile(cfg, B, S, backend="torch").bind(prog.weight_views())

    calls = []
    _record(prog, calls)
    eng = ServingEngine(prog, chunk=16)
    rng = np.random.default_rng(SEED)
    for i in range(4):
        eng.submit(Request(i, rng.integers(1, cfg.vocab, size=16).tolist(),
                           max_new_tokens=8))
    reset_launch_count()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_count()
    assert len(done) == 4 and all(len(r.output) == 8 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.output)
    assert launches > 0 and launches == eng.decode_iterations, \
        (launches, eng.decode_iterations)
    log(f"  served 4 requests in {wall:.1f} s: {eng.iterations} iterations,"
        f" {eng.decode_iterations} decode steps, {launches} kernel launches")
    for r in sorted(done, key=lambda r: r.request_id):
        log(f"  req {r.request_id}: {r.output}")

    # teacher-force the same calls through the torch Program
    ref.init_state()
    worst, n_steps = 0.0, 0
    for c in calls:
        if c[0] == "reset":
            ref.reset_slot(c[1])
        elif c[0] == "prefill":
            ref.prefill(c[1], c[2], c[3])
        else:
            got = torch.from_numpy(c[3])
            assert got.shape == (B, cfg.vocab)
            want = torch.from_numpy(ref.step(c[1], c[2]))
            worst = max(worst, _close(got, want, 3e-4))
            n_steps += 1
    log(f"  teacher-forced {n_steps} decode steps through the torch Program:"
        f" max |logits diff| {worst:.3e} (<= 3e-4)")

    # W = 1 on the same heap: the same step's logits, bitwise
    ex = prog.executor
    ex1 = MegakernelExecutor(plan1, cfg, "cuda")
    ex1.upload(ex.heap)                     # the same tensor, no copy
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([64, 64])
    ex1.write_step_inputs(toks, lens)
    ex1.launch()
    logits1 = plan.view(ex.heap, "logits").clone()
    ex.write_step_inputs(toks, lens)
    ex.launch()
    assert torch.equal(plan.view(ex.heap, "logits"), logits1)
    log(f"  one step at W=1 and at W={W} on one heap: logits bitwise equal")

    # time the decode step at W_max and at W = 1, the torch Program's
    # step and the plain version
    ms = _kernel_ms(ex, toks, lens, 5)
    ms1 = _kernel_ms(ex1, toks, lens, 2)
    step_ms = _events_ms(lambda: type(prog).step(prog, toks, lens), 3)
    counters = ex.worker_counters()
    waits, sigs = _check_events(plan, counters)
    kernel_logits = plan.view(ex.heap, "logits").clone()
    ref.step(toks, lens)                             # warm-up
    library_ms = _events_ms(lambda: ref.step(toks, lens), 5)
    ex.write_step_inputs(toks, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err30 = _close(kernel_logits, plan.view(ex.heap, "logits"), 3e-4)
    nbytes, flops = _step_work(plan, cfg, lens)
    bound_ms = 1e3 * max(nbytes / H100_HBM_BYTES_PER_S,
                         flops / H100_F32_FLOPS)
    bound_by = "bytes" if nbytes / H100_HBM_BYTES_PER_S \
        >= flops / H100_F32_FLOPS else "operations"
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  decode step: kernel at W={W} {ms:.3f} ms, at W=1 {ms1:.3f} ms; "
        f"Program.step {step_ms:.3f} ms ({B / step_ms * 1e3:.2f} tokens/s), "
        f"torch Program step {library_ms:.3f} ms, plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB,"
        f" {flops / 1e9:.1f} GFLOP)")
    log(f"  kernel vs plain at 30 layers: logits max_err={err30:.3e}; peak "
        f"memory {peak_gb:.2f} GB")
    table = _table_events(plan)
    busy = sum(1 for t, _, _ in table if t > 0)
    per = [f"{t}/{c['event_waits']}/{c['event_signals']}"
           for (t, _, _), c in zip(table, counters)]
    runs = []                           # consecutive equal workers folded
    for p in per:
        if runs and runs[-1][0] == p:
            runs[-1][1] += 1
        else:
            runs.append([p, 1])
    util = prog.worker_stats["worker_utilization"]
    log(f"  per worker at W={W} (tasks/waits/signals; {busy} of {W} workers "
        f"ran tasks, {waits} waits and {sigs} signals in all, 0 "
        f"violations; the partitioner's estimated utilization under its "
        f"cost model min {min(util):.2f} mean {sum(util) / W:.2f} max "
        f"{max(util):.2f}): " + " ".join(p if k == 1 else f"{p} x{k}"
                                         for p, k in runs))
    log(f"  kernel time by kind alone at W={W} (kind ms/tasks; noop = the "
        "walk of all rows with the event protocol): "
        + ", ".join(_time_by_kind(ex, plan, toks, lens)))
    log("phase 3 ok")
    return {"launches": launches, "max_abs_err": err30, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "workers": W, "ms_w1": ms1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    cfg = get_config("deepseek-7b")
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    phase_build()
    err2 = phase_workers(cfg, w_max)
    k = phase_serve(cfg, w_max)
    k["max_abs_err"] = max(k["max_abs_err"], err2)
    kernel = {"name": "megakernel", "route": "cuda",
              "source": "src/repro_torch/megakernel/csrc/megakernel.cu",
              "replaces": "src/repro/kernels/megakernel/kernel.py:1175"}
    kernel.update(k)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
