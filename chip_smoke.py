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
   and a wait on an event nobody signals, and a dynamic plan whose one
   event never triggers, each fail their process at the deadline (child
   processes, since the fault ends their CUDA context);
2. full-width deepseek-7b cut to 2 layers (B=2, S=128), one heap image:
   one decode step at W ∈ {1, 2, 4, W_max} under the static scheduler —
   logits and KV caches bitwise equal across W, each W within 2e-4 of the
   plain PyTorch version with the embedding and the cache-update copies
   bitwise, no event-wait violation and the waits and signals the table
   implies on every worker — then the same step traced at W_max: the
   heap outside the ring bitwise equal to the untraced run, the ticks a
   permutation, the event order clean, the Perfetto export valid.  Then
   the dynamic scheduler (the ready pools, lowered from the same compiled
   graphs) at the same W: logits and caches bitwise equal to the static
   kernel's, within 2e-4 of the plain dynamic version, every pool
   drained, T pops with the pop trace a permutation of the rows, no
   violation; traced at W_max with a clean event order and the tensors
   and event counters bitwise equal to the untraced run; 50 launches
   back to back at W_max with bitwise-equal logits;
3. the slice itself: full 30-layer deepseek-7b (B=2, S=128, random
   weights drawn from a seeded generator straight into the heap), one
   compile at W_max lowered to the dynamic plan (the Program) and the
   static plan on one heap.  A ``ServingEngine`` answers 4 requests with
   ragged prompts (16, 40, 72 and 100 tokens, 8 new tokens each, chunk
   16) through ``scheduler="dynamic"``, every decode step one kernel
   launch; the same calls are then teacher-forced through the torch
   Program, which reads the weights as strided views of the same heap,
   and every decode step's logits are held to it within 3e-4.  On the
   same heap the static W_max table, the static W = 1 table (its own
   compile) and the dynamic table give bitwise-equal logits.  Then the
   decode step is timed (CUDA events, after warm-up): static at W_max and
   W = 1, dynamic at W_max, at equal (64, 64) and ragged (16, 120)
   lengths, and the dynamic walk of an all-noop table (the pops and
   pushes alone), beside the torch Program's step and the plain version;
   the kernel's logits are held to the plain version's within 3e-4, the
   per-worker counters and the dynamic pop sources are shown, and each
   task kind is timed alone under the static scheduler;
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


_STUCK_DYN = r"""
import dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
cfg = dataclasses.replace(get_config("deepseek-7b").reduced(), n_layers=1)
plan = compile_decode_megakernel(cfg, 2, 16, num_workers=4,
                                 scheduler="dynamic")
ex = MegakernelExecutor(plan, cfg, "cuda")
ex.init_weights(torch.Generator(device="cuda").manual_seed(0))
ex.write_step_inputs([3, 7], [1, 12])
ex.launch()
torch.cuda.synchronize()
print("clean launch ok", flush=True)
ex._sched[0, 0] += 1                     # event 0 never triggers
ex.write_step_inputs([3, 7], [1, 12])
ex.launch()
torch.cuda.synchronize()
print("no fault", flush=True)
"""


def _child_fails(script, what):
    """Run ``script`` in a child process that must fail at the deadline
    after one clean launch; returns a line for the log."""
    from repro_torch.megakernel.kernel import SPIN_TIMEOUT_S
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True,
                          timeout=SPIN_TIMEOUT_S + 180)
    took = time.perf_counter() - t0
    assert proc.returncode != 0 and "clean launch ok" in proc.stdout \
        and "no fault" not in proc.stdout, (proc.stdout, proc.stderr)
    err = [ln for ln in proc.stderr.splitlines() if "CUDA error" in ln]
    assert err and took >= SPIN_TIMEOUT_S, (proc.stderr[-2000:], took)
    fault = [ln for ln in proc.stdout.splitlines() if "deadline" in ln]
    return (f"{what} failed its process after {took:.1f} s (deadline "
            f"{SPIN_TIMEOUT_S} s, process start included): "
            f"{err[-1].strip()}"
            + (f"; the kernel printed: {fault[0].strip()}" if fault else ""))


def phase_faults(plan, w_max):
    """With the statics of the full-width plan: a W that cannot be
    resident raises before launch; a wait past its deadline, and a
    dynamic plan with an event that never triggers, fail their process
    instead of hanging."""
    from repro_torch.megakernel import (launch_count, megakernel,
                                        reset_launch_count)
    from repro_torch.megakernel.kernel import check_workers, max_workers
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
    stuck = _child_fails(_STUCK, "a wait on an unsignalled event")
    stuck_dyn = _child_fails(_STUCK_DYN, "a dynamic plan whose event 0 has "
                             "its trigger count raised by one")
    log(f"faults ok: {n} CTAs fit at once; W={n + 1} refused before "
        f"launch ({refused}); {stuck}; {stuck_dyn}")


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


def _check_dynamic(ex):
    """A dynamic launch's own accounting: zero violations, every wait and
    signal the table holds counted once, every pool drained (pushed ==
    popped), T pops from the three sources, and the pop trace a
    permutation of the T rows.  Returns the pop counters."""
    plan = ex.plan
    T = plan.dyn.num_tasks
    counters = ex.worker_counters()
    assert all(c["event_wait_violations"] == 0 for c in counters), counters
    assert sum(c["event_waits"] for c in counters) \
        == int((plan.descs[:, 32] >= 0).sum())
    assert sum(c["event_signals"] for c in counters) \
        == int((plan.descs[:, 34] >= 0).sum())
    qc = ex.scheduler_counters()
    assert qc["queue_pushed"] == qc["queue_popped"], qc
    assert sum(qc["queue_popped"]) == T, qc
    assert qc["pops_own"] + qc["pops_overflow"] + qc["steals"] == T, qc
    trace = ex.pop_trace()
    assert np.array_equal(np.sort(trace[:T]), np.arange(T))
    assert (trace[T:] == -1).all()
    return qc


def _pops(qc):
    return (f"pops {qc['pops_own']} own / {qc['pops_overflow']} overflow / "
            f"{qc['steals']} steals, {qc['idle_slots']} empty polls")


def phase_dynamic(cfg2, w_max, plans, base, first, toks, lens):
    """The dynamic scheduler at 2 layers from the static plans' compiled
    graphs on the same heap image: bitwise equal to the static kernel,
    within 2e-4 of the plain dynamic version, drained pools, a traced run
    with a clean event order, and 50 launches with equal logits."""
    from repro_torch.megakernel import (MegakernelExecutor, launch_count,
                                        lower_tgraph, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.obs import check_event_order, decode_ring

    def run(plan):
        ex = MegakernelExecutor(plan, cfg2, "cuda")
        ex.upload(base.clone())
        ex.write_step_inputs(toks, lens)
        reset_launch_count()
        ex.launch()
        torch.cuda.synchronize()
        assert launch_count() == 1
        return ex

    errs, wide = [], None
    for w, splan in plans.items():
        plan = lower_tgraph(splan.compiled, cfg2, scheduler="dynamic")
        ex = run(plan)
        for n, v in first.items():
            assert torch.equal(plan.view(ex.heap, n), v), (w, n)
        plain = base.clone()
        ex_plain = MegakernelExecutor(plan, cfg2, "cuda")
        ex_plain.upload(plain)
        ex_plain.write_step_inputs(toks, lens)
        megakernel_plain(plain, plan.descs, plan.statics,
                         plan.dyn.sched_table())
        errs.append(_close(plan.view(ex.heap, "logits"),
                           plan.view(plain, "logits"), 2e-4))
        qc = _check_dynamic(ex)
        log(f"  dynamic W={plan.num_workers}: {plan.dyn.num_tasks} tasks, "
            f"{plan.num_events} event counters, largest fan-out "
            f"{plan.dyn.max_out}; logits and caches bitwise equal to the "
            f"static kernel; vs plain max_err={errs[-1]:.3e}; pools "
            f"drained, pop trace a permutation, 0 violations; {_pops(qc)}")
        del plain, ex_plain
        if w == w_max:
            wide = ex
        else:
            del ex
        torch.cuda.empty_cache()

    traced = lower_tgraph(wide.plan.compiled, cfg2, scheduler="dynamic",
                          trace=True)
    ex = run(traced)
    lo = traced.queue_offset
    assert torch.equal(ex.heap[:lo], wide.heap[:lo])
    _check_dynamic(ex)
    ring = ex.task_ring()
    ticks = np.sort(np.concatenate([ring[:, 3], ring[:, 4]]))
    assert np.array_equal(ticks, np.arange(2 * ring.shape[0]))
    tl = decode_ring(traced, ring)
    assert 0 < len(tl.events) <= traced.dyn.num_tasks
    order = check_event_order(tl)
    assert order == [], order[:5]
    del ex
    torch.cuda.empty_cache()

    steals = []
    for i in range(50):
        wide.write_step_inputs(toks, lens)
        wide.launch()
        assert torch.equal(wide.plan.view(wide.heap, "logits"),
                           first["logits"]), i
        steals.append(_check_dynamic(wide)["steals"])
    log(f"phase 2 dynamic ok: W in (1, 2, 4, {wide.plan.num_workers}) "
        f"bitwise equal to static, max_err vs plain {max(errs):.3e}; traced "
        f"at W={traced.num_workers}: tensors and event counters bitwise "
        f"equal, ticks a permutation, check_event_order clean over "
        f"{len(tl.events)} pops; 50 launches at W={wide.plan.num_workers} "
        f"with bitwise-equal logits (steals per launch {min(steals)}-"
        f"{max(steals)})")
    del wide
    torch.cuda.empty_cache()
    return max(errs)


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

    # one heap image, sized for the largest tail (a traced W_max plan)
    big = max([traced, lower_tgraph(wide.compiled, cfg2, scheduler="dynamic",
                                    trace=True)], key=lambda p: p.heap_size)
    src = MegakernelExecutor(big, cfg2, "cuda")
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
    del ex, wide_heap
    torch.cuda.empty_cache()
    err_dyn = phase_dynamic(cfg2, w_max, plans, base, first, toks, lens)
    del src, base
    torch.cuda.empty_cache()
    return max(max(errs), err_dyn)


def _record(prog, calls):
    """Log every state-changing call of a megakernel Program with its
    result; every step must end with no event-wait violation and, under
    the dynamic scheduler, with its pools drained and T pops."""
    step, prefill, reset = prog.step, prog.prefill, prog.reset_slot

    def rec_step(tokens, seq_lens, positions=None):
        out = step(tokens, seq_lens, positions)
        bad = prog.executor.pipeline_counters()["event_wait_violations"]
        assert bad == 0, bad
        if prog.plan.dynamic:
            _check_dynamic(prog.executor)
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
    ``index_copy_``, which zeroes the event counters and rewrites the
    queue image."""
    from repro_torch.megakernel import megakernel
    launch = ex.launch
    if descs is not None:
        plan = ex.plan
        sched = torch.from_numpy(plan.dyn.sched_table()).cuda() \
            if plan.dynamic else None
        launch = lambda: megakernel(ex.heap, descs, plan.statics, sched)
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


PROMPTS = (16, 40, 72, 100)           # ragged prompt lengths, tokens


def phase_serve(cfg, w_max):
    """The slice: full deepseek-7b served through the dynamic kernel at
    W_max, the static tables on the same heap."""
    from repro_torch.api import compile as mk_compile
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, lower_tgraph,
                                        megakernel_plain,
                                        reset_launch_count)
    from repro_torch.runtime import Request, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel", num_workers=w_max,
                      scheduler="dynamic")
    dplan = prog.plan
    W = dplan.num_workers
    assert W >= 2, W
    log(f"  30-layer dynamic plan at W={w_max}: {W} workers used, "
        f"{dplan.dyn.num_tasks} tasks, {dplan.num_events} event counters, "
        f"largest fan-out {dplan.dyn.max_out}, initial ready set "
        f"{sum(map(len, dplan.dyn.initial))} rows, heap "
        f"{dplan.heap_size * 4 / 1e9:.2f} GB "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    plan = lower_tgraph(dplan.compiled, cfg)          # static, same graph
    plan1 = compile_decode_megakernel(cfg, B, S)
    for p in (plan, plan1):                 # both run on the dynamic heap
        assert p.heap_size <= dplan.trace_offset
        assert all((p.layout[n].offset, p.layout[n].ld)
                   == (dplan.layout[n].offset, dplan.layout[n].ld)
                   for n in dplan.layout)
    log(f"  30-layer static plans of the same compile at W={W}: "
        f"{plan.num_steps} steps, {plan.descs.shape[0]} rows, "
        f"{plan.num_events} event counters; at W=1 (its own compile): "
        f"{plan1.descs.shape[0]} rows ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prog.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"  weights drawn into the heap in {time.perf_counter() - t0:.1f} s")
    ref = mk_compile(cfg, B, S, backend="torch").bind(prog.weight_views())

    calls = []
    _record(prog, calls)
    eng = ServingEngine(prog, chunk=16)
    rng = np.random.default_rng(SEED)
    for i, n in enumerate(PROMPTS):
        eng.submit(Request(i, rng.integers(1, cfg.vocab, size=n).tolist(),
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
    log(f"  served 4 requests (prompts {PROMPTS} tokens, 8 new each, chunk "
        f"16) through scheduler='dynamic' in {wall:.1f} s: "
        f"{eng.iterations} iterations, {eng.decode_iterations} decode "
        f"steps, {launches} kernel launches")
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

    # the static tables at W_max and W = 1 on the same heap: the same
    # step's logits, bitwise
    exd = prog.executor
    ex = MegakernelExecutor(plan, cfg, "cuda")
    ex.upload(exd.heap)                     # the same tensor, no copy
    ex1 = MegakernelExecutor(plan1, cfg, "cuda")
    ex1.upload(exd.heap)
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([64, 64])
    ragged = np.array([16, 120])
    outs = []
    for e in (ex1, ex, exd):
        e.write_step_inputs(toks, lens)
        e.launch()
        outs.append(plan.view(exd.heap, "logits").clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    qc = _check_dynamic(exd)
    log(f"  one step of the static table at W=1 and W={W} and of the "
        f"dynamic table at W={W} on one heap: logits bitwise equal; "
        f"dynamic {_pops(qc)}")

    # time the decode step: static at W_max and W = 1, dynamic at W_max,
    # at equal and ragged lengths, the dynamic walk, the torch Program's
    # step and the plain version
    ms = _kernel_ms(ex, toks, lens, 5)
    ms_dyn = _kernel_ms(exd, toks, lens, 5)
    qc = _check_dynamic(exd)
    ms_static_ragged = _kernel_ms(ex, toks, ragged, 5)
    ms_dyn_ragged = _kernel_ms(exd, toks, ragged, 5)
    qc_ragged = _check_dynamic(exd)
    walk = dplan.descs.copy()
    walk[:, 0] = 0
    dyn_walk_ms = _kernel_ms(exd, toks, lens, 3,
                             torch.from_numpy(walk).cuda())
    qc_walk = _check_dynamic(exd)
    ms1 = _kernel_ms(ex1, toks, lens, 2)
    step_ms = _events_ms(lambda: type(prog).step(prog, toks, lens), 3)
    ex.write_step_inputs(toks, lens)
    ex.launch()
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
    rbytes, rflops = _step_work(plan, cfg, ragged)
    bound_ragged = 1e3 * max(rbytes / H100_HBM_BYTES_PER_S,
                             rflops / H100_F32_FLOPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  decode step at lengths {tuple(lens)}: static kernel at W={W} "
        f"{ms:.3f} ms, dynamic kernel at W={W} {ms_dyn:.3f} ms, static at "
        f"W=1 {ms1:.3f} ms; Program.step (dynamic) {step_ms:.3f} ms "
        f"({B / step_ms * 1e3:.2f} tokens/s), torch Program step "
        f"{library_ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} "
        f"GFLOP)")
    log(f"  decode step at ragged lengths {tuple(ragged)}: static "
        f"{ms_static_ragged:.3f} ms, dynamic {ms_dyn_ragged:.3f} ms, bound "
        f"{bound_ragged:.3f} ms; the dynamic walk of the all-noop table "
        f"(pops, pushes, waits and signals alone) {dyn_walk_ms:.3f} ms")
    log(f"  dynamic pop sources (last timed launch): equal lengths "
        f"{_pops(qc)}; ragged {_pops(qc_ragged)}; walk {_pops(qc_walk)}")
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
    util = plan.compiled.partition.worker_utilization()
    log(f"  per worker of the static table at W={W} (tasks/waits/signals; "
        f"{busy} of {W} workers ran tasks, {waits} waits and {sigs} signals "
        f"in all, 0 violations; the partitioner's estimated utilization "
        f"under its cost model min {min(util):.2f} mean "
        f"{sum(util) / W:.2f} max {max(util):.2f}): "
        + " ".join(p if k == 1 else f"{p} x{k}" for p, k in runs))
    log(f"  kernel time by kind alone under the static scheduler at W={W} "
        "(kind ms/tasks; noop = the walk of all rows with the event "
        "protocol): " + ", ".join(_time_by_kind(ex, plan, toks, lens)))
    log("phase 3 ok")
    return {"launches": launches, "max_abs_err": err30, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "workers": W, "ms_w1": ms1,
            "ms_dyn": ms_dyn, "ms_dyn_ragged": ms_dyn_ragged,
            "ms_static_ragged": ms_static_ragged, "dyn_walk_ms": dyn_walk_ms,
            "bound_ragged_ms": bound_ragged}


def standalone_bounds():
    """The bounds of the standalone TPU kernels still to port, at the
    largest float32 shape of ``tests/test_kernels.py`` (each input read
    once, the output written once; causal attention does half the
    products): (name, shape, bytes, FLOPs, bound ms, bound by)."""
    out = []
    m, k, n = 384, 128, 384
    out.append(("matmul", f"({m},{k})x({k},{n})", 4 * (m * k + k * n + m * n),
                2 * m * k * n))
    rows, d = 256, 512
    out.append(("rmsnorm", f"({rows},{d})", 4 * (2 * rows * d + d),
                4 * rows * d))
    b, s, h, hd = 2, 256, 4, 64
    out.append(("flash_attention", f"causal B={b} S={s} H={h} hd={hd}",
                4 * 4 * b * s * h * hd, 4 * b * h * s * s * hd // 2))
    rows_out = []
    for name, shape, nbytes, flops in out:
        t_b, t_f = nbytes / H100_HBM_BYTES_PER_S, flops / H100_F32_FLOPS
        rows_out.append((name, shape, nbytes, flops, 1e3 * max(t_b, t_f),
                         "bytes" if t_b >= t_f else "operations"))
    return rows_out


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
    for row in standalone_bounds():
        log("  still to port: %s at %s: %d bytes, %d FLOP, bound %.6f ms "
            "(%s)" % row)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
