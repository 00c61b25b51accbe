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
   step is timed through the kernel's dense and extended instantiations
   in ten pairs (the reason the dense ones exist; phase 3b times
   granite's through the extended and the full ones), the per-worker
   counters and the dynamic pop sources are shown, and each task kind is
   timed alone under the static scheduler;
2b. the same checks on granite-moe-1b-a400m cut to 2 layers at full width
   (32 experts, top-8; the MoE kinds 9-11: router top-k, expert GEMM,
   combine), with the routers' zeros bitwise the plain version's;
3b. the MoE slice: full 24-layer granite served as in phase 3 at
   ``capacity_factor = n_experts`` (the reference's dropless convention:
   the megakernel is dropless, and the torch Program and the prefill then
   are too), each decode step within 3e-4 of the torch Program; the step
   timed static and dynamic beside both of its bounds (every expert read,
   as the kernel does, and only the experts the step's routers chose),
   each task kind alone, the overflow pops and steals;
2c. the same checks on mamba2-2.7b cut to 2 layers at full width (80 SSM
   heads of 64, N=128, d_inner 5120; the SSM kinds 12-13: the SSD state
   update and the causal conv step), with A_log, D_skip, dt_bias and the
   conv biases redrawn per head and channel (their initial values are
   the same for every head), the SSD states within 2e-4 of the plain
   version and the conv windows' shifted rows bitwise;
3c. the SSM slice: the full 64-layer mamba2 served as in phase 3 (a
   49.8 GB heap: one compile at W_max lowered to both plans on it, never
   cloned), each decode step within 3e-4 of the torch Program; one step
   from one state through the static W_max, the W = 1 and the dynamic
   table gives bitwise-equal logits, conv windows and SSD states, within
   3e-4 of the plain version (the windows' shifted rows bitwise); the
   step timed static, dynamic and at W = 1 beside its bound (the
   weights, the SSD and conv states read and written once), each task
   kind alone;
2d. tensor parallelism over the fused transport (C chips as regions of
   one heap on the one card, kinds 14-15: the ring send and the
   all-reduce chunk): deepseek-7b and granite at 2 layers and full width,
   TP ∈ {1, 2, 4} at W ∈ {1, 2, W_max // C}, from one set of weights and
   state; logits bitwise equal across TP, W and chips, every collective
   an exact identity, within 2e-4 of the plain version, kinds 14-15
   alone bitwise the plain version's (collectives, staging buffers,
   arrival counters), traced at TP=2 with a clean event order, and chip
   1's wq scaled to show that its region is its own;
3d. the TP slice: the full 24-layer granite served at TP=4 through
   ``compile(..., tp=4)`` as in phase 3b: every decode step bitwise phase
   3b's and within 3e-4 of the torch Program, the static step timed at
   TP=2 and TP=4 beside its bound (every chip's bytes and the ring's),
   kinds 14-15 timed together;
4. prints the bounds of the standalone kernels still to port beside one
   PyTorch call that computes the same function, one JSON line on the
   kernels (launches on the main paths, the largest error against the
   plain version over all, times, the bounds) and the device line last.
   Every phase prints its wall time.
"""
import dataclasses
import gc
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
    names = {"ILb0ELi0E": "static", "ILb1ELi0E": "dynamic",
             "ILb0ELi1E": "static extended", "ILb1ELi1E": "dynamic extended",
             "ILb0ELi2E": "static full", "ILb1ELi2E": "dynamic full",
             "ILb0ELi3E": "static multichip"}
    which = ""
    for line in out.splitlines():
        if "megakernel" in line and ("Compiling" in line
                                     or "Function properties" in line):
            which = next((v for k, v in names.items() if k in line), "")
        if which and ("registers" in line or "spill" in line):
            log(f"  nvcc, {which} kernel:", line.strip())


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


def phase_dynamic(cfg2, w_max, plans, base, first, toks, lens, tag):
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
    rec = _recurrent(wide.plan)
    for i in range(50):
        for n in rec:                   # each launch from the same state
            wide.plan.view(wide.heap, n).copy_(wide.plan.view(base, n))
        wide.write_step_inputs(toks, lens)
        wide.launch()
        assert torch.equal(wide.plan.view(wide.heap, "logits"),
                           first["logits"]), i
        steals.append(_check_dynamic(wide)["steals"])
    log(f"phase {tag} dynamic ok ({cfg2.name}): W in (1, 2, 4, "
        f"{wide.plan.num_workers}) "
        f"bitwise equal to static, max_err vs plain {max(errs):.3e}; traced "
        f"at W={traced.num_workers}: tensors and event counters bitwise "
        f"equal, ticks a permutation, check_event_order clean over "
        f"{len(tl.events)} pops; 50 launches at W={wide.plan.num_workers} "
        f"with bitwise-equal logits (steals per launch {min(steals)}-"
        f"{max(steals)})")
    del wide
    torch.cuda.empty_cache()
    return max(errs)


def _routers(plan):
    """The MoE layers' router weights (kind 9's outputs) by name."""
    return [n for n in plan.layout if n.endswith(".router")]


def _ssm_vectors(plan, heap, seed=SEED + 1):
    """Redraw A_log, D_skip, dt_bias and the conv biases in ``heap`` per
    head and channel (U(0, 2.8), U(0.5, 1.5), N(0, 0.5), N(0, 0.1)): the
    reference initialises each to one value for every head, which would
    hide a wrong head offset or a dropped bias.  Returns how many vectors
    were drawn."""
    gen = torch.Generator(device=heap.device).manual_seed(seed)
    n = 0
    for name in plan.input_classes()["weights"]:
        leaf, v = name.split(".")[-1], plan.view(heap, name)
        if leaf == "A_log":
            v.uniform_(0.0, 2.8, generator=gen)
        elif leaf == "D_skip":
            v.uniform_(0.5, 1.5, generator=gen)
        elif leaf == "dt_bias":
            v.normal_(0.0, 0.5, generator=gen)
        elif leaf.startswith("conv_b"):
            v.normal_(0.0, 0.1, generator=gen)
        else:
            continue
        n += 1
    return n


def _recurrent(plan):
    """The state a step overwrites rather than appends to: the Mamba2
    layers' conv windows and SSD states (a KV cache update writes the
    same row again when a step is repeated).  Comparing two runs of one
    step needs these restored between them."""
    return [n for n in plan.input_classes()["state"]
            if not n.endswith(("k_cache", "v_cache"))]


def _check_conv_windows(plan, heap, plain):
    """Each conv step shifted its window by pure copies: in both heaps the
    new last row is that heap's projection row bitwise, and the rows
    before it are bitwise the plain version's.  Returns the number of
    windows checked."""
    from repro_torch.core.graph import OpKind
    n = 0
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CONV1D_UPDATE:
            continue
        src, win = op.inputs[0], op.outputs[1]
        for h in (heap, plain):
            assert torch.equal(plan.view(h, win)[:, -1],
                               plan.view(h, src)), win
        assert torch.equal(plan.view(heap, win)[:, :-1],
                           plan.view(plain, win)[:, :-1]), win
        n += 1
    return n


def phase_workers(cfg, w_max, tag):
    """Two layers at full width, one heap image: the kernel at W ∈ {1, 2,
    4, W_max} against each other and against its plain version, then
    traced at W_max; the deadline and residency faults in phase 2."""
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
    ssm = {k: p1.statics[k] for k in ("HD_SSM", "N_SSM", "NH_TILE",
                                       "W_CONV") if k in p1.statics}
    log(f"  heap {traced.heap_size * 4 / 1e9:.2f} GB, statics "
        f"TN={p1.statics['TN']} TM={p1.statics['TM']} TK={p1.statics['TK']}"
        f" TOPK={p1.statics['TOPK']} E_MAX={p1.statics['E_MAX']}"
        + "".join(f" {k}={v}" for k, v in ssm.items()))
    if tag == "2":
        phase_faults(wide, w_max)

    # one heap image, sized for the largest tail (a traced W_max plan)
    big = max([traced, lower_tgraph(wide.compiled, cfg2, scheduler="dynamic",
                                    trace=True)], key=lambda p: p.heap_size)
    src = MegakernelExecutor(big, cfg2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    src.init_weights(gen)
    _ssm_vectors(traced, src.heap)
    for name in traced.input_classes()["state"]:
        traced.view(src.heap, name).normal_(0.0, 1.0, generator=gen)
    base = src.heap
    rng = np.random.default_rng(SEED)
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([37, 90])
    state = p1.input_classes()["state"]
    routers = _routers(p1)

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
        n_windows = _check_conv_windows(plan, ex.heap, plain)
        for n in state:                 # KV caches, conv windows, SSD states
            _close(plan.view(ex.heap, n), plan.view(plain, n), 2e-4)
        for n in routers:               # the same experts chosen, bitwise
            assert torch.equal(plan.view(ex.heap, n) == 0,
                               plan.view(plain, n) == 0), n
            _close(plan.view(ex.heap, n), plan.view(plain, n), 2e-4)
        counters = ex.worker_counters()
        assert counters == read_stats_block(plain, plan.stats_offset,
                                            plan.num_workers)
        waits, sigs = _check_events(plan, counters)
        outs = {n: plan.view(ex.heap, n)
                for n in ["logits"] + state + routers}
        if first is None:
            first = {n: v.clone() for n, v in outs.items()}
        for n, v in outs.items():
            assert torch.equal(v, first[n]), (w, n)
        log(f"  W={plan.num_workers}: logits, {len(state)} caches and "
            f"{len(routers)} routers "
            f"{'kept' if w == 1 else 'bitwise equal to W=1'}; vs plain "
            f"max_err={errs[-1]:.3e} "
            f"(<= 2e-4), every state within 2e-4, embedding, "
            f"{n_caches} cache updates and {n_windows} conv windows' "
            f"copies bitwise, the routers' zeros the plain version's; "
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
    log(f"phase {tag} ok ({cfg.name}): W in (1, 2, 4, {wide.num_workers}) "
        f"bitwise equal, "
        f"max_err vs "
        f"plain {max(errs):.3e}; traced at W={traced.num_workers}: heap "
        f"outside the ring bitwise equal, {ring.shape[0]} slots with ticks "
        f"a permutation of 0..{2 * ring.shape[0] - 1}, check_event_order "
        f"clean over {len(tl.events)} events ({n_wait} waiters), "
        f"Perfetto JSON valid")
    del ex, wide_heap
    torch.cuda.empty_cache()
    err_dyn = phase_dynamic(cfg2, w_max, plans, base, first, toks, lens,
                            tag)
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


def _step_work(plan, cfg, lens, heap=None):
    """Bytes a decode step must move and operations it must do, for these
    live lengths: every weight read once (of the embedding table only the
    B gathered rows), the live KV rows read once, the new KV rows and the
    logits written once, the Mamba2 layers' SSD states and conv windows
    read and written once; the FLOPs of the matmuls, the expert GEMMs,
    attention, the SSD update (6 per state element: decay, outer
    product, the dot with C) and the conv taps.  MoE: with ``heap``
    (after the step), only the experts its routers chose (weight > 0)
    are read, each over the rows that chose it; without, every expert
    over every row, as the kernel computes."""
    from repro_torch.core.graph import OpKind
    g = plan.compiled.graph
    shape = lambda n: plan.layout[n].shape
    size = lambda n: int(np.prod(shape(n)))
    weights = [n for n in plan.input_classes()["weights"] if n != "embed"]
    experts = [n for n in weights if ".moe_w" in n]
    w_elems = sum(size(n) for n in weights if n not in experts)
    mm_elems = sum(size(op.inputs[1]) for op in g.ops
                   if op.kind == OpKind.MATMUL)
    e_elems = e_flops = 0
    for n in experts:                   # (E, ...) per layer and GEMM
        per = size(n) // shape(n)[0]
        if heap is None:
            e_elems += size(n)
            e_flops += 2 * B * size(n)
        else:
            w = plan.view(heap, n.split(".")[0] + ".router") > 0
            e_elems += per * int(w.any(0).sum())
            e_flops += 2 * per * int(w.sum())
    kvd, qd = cfg.n_kv_heads * cfg.hd, cfg.n_heads * cfg.hd
    live = int(np.sum(np.asarray(lens) + 1))
    L = cfg.n_layers
    ssd = sum(size(op.inputs[1]) for op in g.ops
              if op.kind == OpKind.SSM_UPDATE)      # B·nh·hd·N a layer
    conv = sum(size(op.inputs[1]) for op in g.ops
               if op.kind == OpKind.CONV1D_UPDATE)  # B·W·C a layer
    nbytes = 4 * (w_elems + e_elems + B * cfg.d_model + 2 * L * live * kvd
                  + 2 * L * B * kvd + B * cfg.vocab + 2 * ssd + 2 * conv)
    flops = 2 * B * mm_elems + e_flops + 4 * L * live * qd + 6 * ssd \
        + 2 * conv
    return nbytes, flops


def _bound(work):
    """(ms, "bytes" or "operations") of a step's (bytes, FLOPs) on the
    H100's published rates."""
    t_b, t_f = work[0] / H100_HBM_BYTES_PER_S, work[1] / H100_F32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


KIND_NAMES = ("noop", "matmul", "rmsnorm", "rope", "glu", "resid",
              "attention", "cache_update", "embed", "topk", "expert_gemm",
              "combine", "ssm", "conv", "send", "allreduce_chunk")


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
        launch = lambda: megakernel(ex.heap, descs, plan.statics, sched,
                                    ex._acks)
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
    event protocol).  The COMM kinds (14 send, 15 all-reduce chunk) run
    together: a ring send of round r >= 1 waits for its receiver's
    arrivals.  Run last: the heap's activations are overwritten with
    partial results.  Returns the log entries and {name: ms}."""
    kinds = plan.descs[:, 0]
    groups = [(c,) for c in [0] + sorted(set(kinds.tolist()) - {0, 14, 15})]
    if 14 in kinds:
        groups.append((14, 15))
    out, times = [], {}
    for codes in groups:
        table = plan.descs.copy()
        table[~np.isin(kinds, codes), 0] = 0
        ms = _kernel_ms(ex, toks, lens, 1, torch.from_numpy(table).cuda())
        n = int(np.isin(kinds, codes).sum()) if codes[0] else len(kinds)
        name = "+".join(KIND_NAMES[c] for c in codes)
        out.append(f"{name} {ms:.2f} ms/{n}")
        times[name] = ms
    return out, times


VARIANTS = ("dense", "extended", "full")   # kernel._variant's 0, 1, 2


def _instantiations_ab(ex, exd, toks, lens, sides, pairs=10):
    """A plan's step through the kernel instantiations it picks and
    through the next one (``sides``: two of ``VARIANTS``' indices; the
    extended one adds the MoE kinds and the matmul's tail, the full one
    the Mamba2 kinds as well), static and dynamic: ``pairs`` pairs of 5
    launches each, the pair's first side alternating.  Each step's logits
    are held to the first side's within 3e-4; a plan with recurrent state
    steps from the same state every time.  Returns {(scheduler,
    variant): [ms per pair]} and whether all logits were bitwise
    equal."""
    from repro_torch.megakernel import kernel as mk
    chosen = mk._variant
    rec = _recurrent(ex.plan)
    pre = {n: ex.plan.view(ex.heap, n).clone() for n in rec}
    times, logits, bitwise = {}, {}, True
    try:
        for i in range(pairs):
            for v in (sides if i % 2 == 0 else sides[::-1]):
                mk._variant = lambda statics, v=v: v
                for sched, e in (("static", ex), ("dynamic", exd)):
                    times.setdefault((sched, v), []).append(
                        _kernel_ms(e, toks, lens, 5))
                    for n, t in pre.items():
                        e.plan.view(e.heap, n).copy_(t)
                    e.write_step_inputs(toks, lens)
                    e.launch()
                    got = e.plan.view(e.heap, "logits").clone()
                    want = logits.setdefault(sched, got)
                    _close(got, want, 3e-4)
                    bitwise = bitwise and torch.equal(got, want)
    finally:
        mk._variant = chosen
    return times, bitwise


PROMPTS = (16, 40, 72, 100)           # ragged prompt lengths, tokens

#: per model served by ``phase_serve``: its decode steps' logits, and one
#: static step's logits after the run with that step's inputs (host)
SERVED = {}


def phase_serve(cfg, w_max, tag):
    """A slice: the full model served through the dynamic kernel at W_max,
    the static tables on the same heap."""
    from repro_torch.api import compile as mk_compile
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, lower_tgraph,
                                        megakernel_plain,
                                        reset_launch_count)
    from repro_torch.megakernel.kernel import _variant
    from repro_torch.runtime import Request, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel", num_workers=w_max,
                      scheduler="dynamic")
    compile_s = time.perf_counter() - t0
    dplan = prog.plan
    W = dplan.num_workers
    assert W >= 2, W
    L = cfg.n_layers
    log(f"  {L}-layer dynamic plan at W={w_max}: {W} workers used, "
        f"{dplan.dyn.num_tasks} tasks, {dplan.num_events} event counters, "
        f"largest fan-out {dplan.dyn.max_out}, initial ready set "
        f"{sum(map(len, dplan.dyn.initial))} rows, heap "
        f"{dplan.heap_size * 4 / 1e9:.2f} GB "
        f"(host compile {compile_s:.1f} s)")
    t0 = time.perf_counter()
    plan = lower_tgraph(dplan.compiled, cfg)          # static, same graph
    plan1 = compile_decode_megakernel(cfg, B, S)
    for p in (plan, plan1):                 # both run on the dynamic heap
        assert p.heap_size <= dplan.trace_offset
        assert all((p.layout[n].offset, p.layout[n].ld)
                   == (dplan.layout[n].offset, dplan.layout[n].ld)
                   for n in dplan.layout)
    log(f"  {L}-layer static plans of the same compile at W={W}: "
        f"{plan.num_steps} steps, {plan.descs.shape[0]} rows, "
        f"{plan.num_events} event counters; at W=1 (its own compile): "
        f"{plan1.descs.shape[0]} rows ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prog.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    n_vec = _ssm_vectors(dplan, prog.executor.heap)
    torch.cuda.synchronize()
    log(f"  weights drawn into the heap in {time.perf_counter() - t0:.1f} s"
        + (f" ({n_vec} A_log, D_skip, dt_bias and conv bias vectors "
           "redrawn per head and channel)" if n_vec else ""))
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
    rec = _recurrent(plan)
    pre = {n: plan.view(exd.heap, n).clone() for n in rec}

    def restore():                      # the recurrent state before a step
        for n, v in pre.items():
            plan.view(exd.heap, n).copy_(v)

    outs = []
    for e in (ex1, ex, exd):
        restore()
        e.write_step_inputs(toks, lens)
        e.launch()
        outs.append({n: plan.view(exd.heap, n).clone()
                     for n in ["logits"] + rec})
    for n in outs[0]:
        assert torch.equal(outs[0][n], outs[1][n]) \
            and torch.equal(outs[0][n], outs[2][n]), n
    # what phase 3d holds its tensor-parallel run to, on the host
    SERVED[cfg.name] = {
        "steps": [c[3] for c in calls if c[0] == "step"],
        "toks": toks, "lens": lens,
        "static_logits": outs[0]["logits"].cpu()}
    del outs
    qc = _check_dynamic(exd)
    log(f"  one step of the static table at W=1 and W={W} and of the "
        f"dynamic table at W={W} on one heap: logits and {len(rec)} "
        f"recurrent states bitwise equal; dynamic {_pops(qc)}")

    # time the decode step: static at W_max and W = 1, dynamic at W_max,
    # at equal and ragged lengths, the dynamic walk, the torch Program's
    # step and the plain version
    ms = _kernel_ms(ex, toks, lens, 5)
    SERVED[cfg.name]["ms"] = ms
    ms_dyn = _kernel_ms(exd, toks, lens, 5)
    qc = _check_dynamic(exd)
    ms_static_ragged = _kernel_ms(ex, toks, ragged, 5)
    ms_dyn_ragged = _kernel_ms(exd, toks, ragged, 5)
    qc_ragged = _check_dynamic(exd)
    moe = cfg.n_experts > 0
    # MoE: the heap now holds the ragged step's routers, so this bound, as
    # the (64, 64) one below, counts the experts that step's routers chose
    bound_ragged = _bound(_step_work(plan, cfg, ragged,
                                     ex.heap if moe else None))[0]
    walk = dplan.descs.copy()
    walk[:, 0] = 0
    dyn_walk_ms = _kernel_ms(exd, toks, lens, 3,
                             torch.from_numpy(walk).cuda())
    qc_walk = _check_dynamic(exd)
    ms1 = _kernel_ms(ex1, toks, lens, 2)
    ms1_ragged = _kernel_ms(ex1, toks, ragged, 2)
    step_ms = _events_ms(lambda: type(prog).step(prog, toks, lens), 3)
    restore()
    ex.write_step_inputs(toks, lens)
    ex.launch()
    counters = ex.worker_counters()
    waits, sigs = _check_events(plan, counters)
    kernel_logits = plan.view(ex.heap, "logits").clone()
    kernel_rec = {n: plan.view(ex.heap, n).clone() for n in rec}
    ref.step(toks, lens)                             # warm-up
    library_ms = _events_ms(lambda: ref.step(toks, lens), 5)
    restore()                           # the plain version's step from it
    pre.clear()
    ex.write_step_inputs(toks, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err30 = _close(kernel_logits, plan.view(ex.heap, "logits"), 3e-4)
    err_rec = 0.0                       # conv windows and SSD states
    for n, v in kernel_rec.items():
        got = plan.view(ex.heap, n)
        err_rec = max(err_rec, _close(v, got, 3e-4))
        if ".conv_" in n:               # the window's shifted rows: copies
            assert torch.equal(v[:, :-1], got[:, :-1]), n
    kernel_rec.clear()
    # MoE: the bound of the work this step's routers asked for (the
    # experts they chose), beside that of every expert (what the kernel,
    # like the reference's, reads)
    nbytes, flops = _step_work(plan, cfg, lens, ex.heap if moe else None)
    bound_ms, bound_by = _bound((nbytes, flops))
    all_bytes, all_flops = _step_work(plan, cfg, lens)
    bound_all_ms = _bound((all_bytes, all_flops))[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  decode step at lengths {tuple(lens)}: static kernel at W={W} "
        f"{ms:.3f} ms, dynamic kernel at W={W} {ms_dyn:.3f} ms, static at "
        f"W=1 {ms1:.3f} ms; Program.step (dynamic) {step_ms:.3f} ms "
        f"({B / step_ms * 1e3:.2f} tokens/s), torch Program step "
        f"{library_ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} "
        f"GFLOP)")
    log(f"  decode step at ragged lengths {tuple(ragged)}: static "
        f"{ms_static_ragged:.3f} ms, dynamic {ms_dyn_ragged:.3f} ms, static "
        f"at W=1 {ms1_ragged:.3f} ms, bound "
        f"{bound_ragged:.3f} ms{' (routed experts)' if moe else ''}; the "
        f"dynamic walk of the all-noop table "
        f"(pops, pushes, waits and signals alone) {dyn_walk_ms:.3f} ms")
    var = _variant(plan.statics)
    if var < len(VARIANTS) - 1:         # the next variant can run it too
        sides = (var, var + 1)
        a, b = (VARIANTS[v] for v in sides)
        ab, bitwise = _instantiations_ab(ex, exd, toks, lens, sides)
        for sched in ("static", "dynamic"):
            mine, other = ab[(sched, sides[0])], ab[(sched, sides[1])]
            log(f"  {sched} step (64, 64), {a} against {b} instantiation, "
                f"{len(mine)} pairs of 5 launches, first side alternating:"
                f" median {np.median(mine):.3f} against "
                f"{np.median(other):.3f} ms, {a} quartiles "
                f"{np.percentile(mine, 25):.3f}-"
                f"{np.percentile(mine, 75):.3f} ms, {a} faster in "
                f"{sum(d < x for d, x in zip(mine, other))} of {len(mine)}"
                f" pairs; {a} " + " ".join(f"{t:.3f}" for t in mine)
                + f"; {b} " + " ".join(f"{t:.3f}" for t in other))
        log(f"  {a} and {b} logits bitwise equal: {bitwise}")
    log(f"  dynamic pop sources (last timed launch): equal lengths "
        f"{_pops(qc)}; ragged {_pops(qc_ragged)}; walk {_pops(qc_walk)}")
    log(f"  kernel vs plain at {L} layers: logits max_err={err30:.3e}"
        + (f", {len(rec)} conv windows and SSD states max_err="
           f"{err_rec:.3e} (<= 3e-4), the windows' shifted rows bitwise"
           if rec else "") + f"; peak memory {peak_gb:.2f} GB")
    if moe:
        gg = plan.descs[:, 0] == 10
        steps = gg.reshape(-1, W).any(1)
        log(f"  MoE bound (the one the step is held to) counts the experts "
            f"this step's routers chose: {bound_ms:.3f} ms ({nbytes / 1e9:.2f}"
            f" GB, {flops / 1e9:.1f} GFLOP); with every expert read for "
            f"every row (what the kernel does, as the reference's) "
            f"{bound_all_ms:.3f} ms ({all_bytes / 1e9:.2f} GB, "
            f"{all_flops / 1e9:.1f} GFLOP)")
        log(f"  expert GEMMs (kind 10): {int(gg.sum())} tasks a step "
            f"({int(gg.sum()) // L} a layer) in {int(steps.sum())} of "
            f"{len(steps)} static grid steps; the widest step runs "
            f"{int(gg.reshape(-1, W).sum(1).max())} of them on {W} workers")
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
    by_kind, kind_ms = _time_by_kind(ex, plan, toks, lens)
    log(f"  kernel time by kind alone under the static scheduler at W={W} "
        "(kind ms/tasks; noop = the walk of all rows with the event "
        "protocol): " + ", ".join(by_kind))
    if moe:
        # does routing change an expert GEMM's time?  Kind 10 alone with
        # the routers the heap holds, then with every router weight 0
        # (every row masked)
        table = plan.descs.copy()
        table[table[:, 0] != 10, 0] = 0
        table = torch.from_numpy(table).cuda()
        routed = _kernel_ms(ex, toks, lens, 3, table)
        for n in _routers(plan):
            plan.view(ex.heap, n).zero_()
        masked = _kernel_ms(ex, toks, lens, 3, table)
        log(f"  expert GEMMs alone at W={W}: {routed:.3f} ms with the "
            f"heap's routing, {masked:.3f} ms with every row masked (all "
            f"router weights 0)")
    log(f"phase {tag} ok ({cfg.name})")
    out = {"launches": launches, "max_abs_err": max(err30, err_rec),
           "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "workers": W, "ms_w1": ms1,
           "ms_w1_ragged": ms1_ragged, "ms_dyn": ms_dyn,
           "ms_dyn_ragged": ms_dyn_ragged,
           "ms_static_ragged": ms_static_ragged, "dyn_walk_ms": dyn_walk_ms,
           "bound_ragged_ms": bound_ragged, "served_max_err": worst,
           "compile_s": compile_s, "walk_ms": kind_ms["noop"]}
    if var < len(VARIANTS) - 1:
        for (sched, v), t in ab.items():
            key = "ms_ab_" if sched == "static" else "ms_dyn_ab_"
            out[key + VARIANTS[v]] = float(np.median(t))
    if moe:
        out.update({"bound_all_experts_ms": bound_all_ms,
                    "expert_gemm_routed_ms": routed,
                    "expert_gemm_masked_ms": masked})
    return out


TP_DEGREES = (1, 2, 4)


def _allreduces(plan):
    """(output, input) of every collective of a TP graph."""
    from repro_torch.core.graph import OpKind
    return [(op.outputs[0], op.inputs[0]) for op in plan.compiled.graph.ops
            if op.kind == OpKind.ALLREDUCE]


def _fill_chips(heap, plan, src_plan, src):
    """Every graph input of ``src_plan``'s heap ``src``, by name, into
    chip 0's region of ``plan``'s ``heap``, then chip 0's region into the
    other chips' (one device copy each)."""
    for name in plan.compiled.graph.inputs:
        plan.view(heap, name).copy_(src_plan.view(src, name))
    for c in range(1, plan.n_chips):
        heap[c * plan.chip_stride:(c + 1) * plan.chip_stride].copy_(
            heap[:plan.chip_stride])


def _check_tp_run(plan, heap, counters, want):
    """One launch's results on every chip: the logits bitwise ``want``
    (host), every collective's output bitwise its input (the owner-masked
    ring is an exact identity when the chips hold the same bits), no
    violation and the waits and signals the table holds.  Returns the
    totals (waits, signals)."""
    for c in range(plan.n_chips):
        assert torch.equal(plan.view(heap, "logits", c).cpu(), want), c
        for out, inp in _allreduces(plan):
            assert torch.equal(plan.view(heap, out, c),
                               plan.view(heap, inp, c)), (out, c)
    return _check_events(plan, counters)


def _ring_bytes(plan):
    """Bytes the COMM rows of a step move: each word of a window read once
    and written once, and an accumulating arrival's destination read as
    well."""
    d = plan.descs
    comm = np.isin(d[:, 0], (14, 15))
    words = d[comm, 1] * d[comm, 3]
    acc = (d[comm, 0] == 15) & (d[comm, 14] == 1)
    return int(4 * (2 * words + acc * words).sum())


def phase_tp_workers(cfg, w_max, tag):
    """Tensor parallelism at 2 layers and full width over the fused
    transport: TP ∈ {1, 2, 4} at W ∈ {1, 2, W_max // C}, every run from
    the same weights and state (TP=1's heap, copied by name into chip 0
    and from there into every chip).  Logits bitwise equal across TP, W
    and chips, every collective an exact identity, 0 violations; the
    widest plan of each TP within 2e-4 of its plain version; kinds 14-15
    alone (the table's other rows noops) bitwise the plain version's in
    the collectives' outputs, the staging buffers and the arrival
    counters; traced at TP=2 with a clean event order over both chips;
    chip 1's wq scaled by 1 + 2^-10 moves both chips' logits, equally;
    ``init_weights`` draws the same weights into a TP=2 plan's chips as
    into TP=1's (phase 3d relies on it)."""
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, megakernel,
                                        megakernel_plain, reset_launch_count)
    from repro_torch.megakernel.ops import read_stats_block
    from repro_torch.obs import check_event_order, decode_ring
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    rng = np.random.default_rng(SEED)
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([37, 90])
    p1 = compile_decode_megakernel(cfg2, B, S)
    src = MegakernelExecutor(p1, cfg2, "cuda")
    src.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for name in p1.input_classes()["state"]:
        p1.view(src.heap, name).normal_(0.0, 1.0, generator=gen)
    base = src.heap
    weights = p1.input_classes()["weights"]
    want, errs = None, []
    for tp in TP_DEGREES:
        t0 = time.perf_counter()
        ws = (1, 2, w_max // tp)
        plans = {w: compile_decode_megakernel(cfg2, B, S, num_workers=w,
                                              tp=tp) for w in ws}
        wide = plans[ws[-1]]
        traced = compile_decode_megakernel(cfg2, B, S, num_workers=ws[-1],
                                           tp=tp, trace=True) \
            if tp == 2 else None
        size = max(p.heap_size for p in list(plans.values()) + [traced]
                   if p is not None)
        log(f"  TP={tp}: plans at W={ws} use "
            f"{[p.num_workers for p in plans.values()]} lanes (C x W), "
            f"{[p.num_steps for p in plans.values()]} steps, chip region "
            f"{wide.chip_stride * 4 / 1e9:.2f} GB, heap {size * 4 / 1e9:.2f}"
            f" GB ({time.perf_counter() - t0:.1f} s)")
        heap = torch.zeros(size, device="cuda")
        _fill_chips(heap, wide, p1, base)
        if tp == 2:                     # the draws phase 3d relies on
            chk = MegakernelExecutor(wide, cfg2, "cuda")
            chk.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
            for n in weights:
                for c in range(tp):
                    assert torch.equal(wide.view(chk.heap, n, c),
                                       p1.view(base, n)), (n, c)
            del chk
        if tp == TP_DEGREES[-1]:
            del src, base               # the last TP: chip 0 holds it all
        torch.cuda.empty_cache()
        pre = heap.clone()              # the image before the step
        for w, plan in plans.items():
            ex = MegakernelExecutor(plan, cfg2, "cuda")
            ex.upload(heap)             # the same tensor, no copy
            ex.write_step_inputs(toks, lens)
            reset_launch_count()
            ex.launch()
            torch.cuda.synchronize()
            assert launch_count() == 1
            got = plan.view(heap, "logits").cpu()
            want = got if want is None else want
            waits, sigs = _check_tp_run(plan, heap, ex.worker_counters(),
                                        want)
            log(f"  TP={tp} W={w} ({plan.num_workers} lanes): logits on "
                f"{plan.n_chips} chip(s) bitwise equal to TP=1 W=1, "
                f"{len(_allreduces(plan))} collectives exact identities, "
                f"{waits} waits, {sigs} signals, 0 violations")
        # the plain version from the image before the step
        ex_p = MegakernelExecutor(wide, cfg2, "cuda")
        ex_p.upload(pre)
        ex_p.write_step_inputs(toks, lens)
        megakernel_plain(pre, wide.descs, wide.statics, acks=wide.acks)
        errs.append(_close(wide.view(heap, "logits"),
                           wide.view(pre, "logits"), 2e-4))
        assert read_stats_block(heap, wide.stats_offset, wide.num_workers) \
            == read_stats_block(pre, wide.stats_offset, wide.num_workers)
        line = (f"  TP={tp} W={ws[-1]}: vs plain max_err={errs[-1]:.3e} "
                f"(<= 2e-4), counter blocks equal")
        if tp > 1:                      # kinds 14-15 alone, one image
            pre.copy_(heap)
            table = wide.descs.copy()
            table[~np.isin(table[:, 0], (14, 15)), 0] = 0
            ex.write_step_inputs(toks, lens)
            ex_p.write_step_inputs(toks, lens)
            reset_launch_count()
            megakernel(heap, torch.from_numpy(table).cuda(), wide.statics,
                       acks=ex._acks)
            torch.cuda.synchronize()
            assert launch_count() == 1
            megakernel_plain(pre, table, wide.statics, acks=wide.acks)
            for out, _ in _allreduces(wide):
                for c in range(tp):
                    assert torch.equal(wide.view(heap, out, c),
                                       wide.view(pre, out, c)), (out, c)
            lo, hi = wide.event_offset, wide.stats_offset
            assert torch.equal(heap[lo:hi], pre[lo:hi])
            assert torch.equal(heap[wide.ctl_offset:wide.heap_size],
                               pre[wide.ctl_offset:wide.heap_size])
            assert read_stats_block(heap, wide.stats_offset,
                                    wide.num_workers) \
                == read_stats_block(pre, wide.stats_offset, wide.num_workers)
            n_comm = int(np.isin(wide.descs[:, 0], (14, 15)).sum())
            line += (f"; kinds 14-15 alone ({n_comm} rows): collectives, "
                     f"{(hi - lo - wide.num_events) * 4 / 1e6:.2f} MB of "
                     f"staging and {wide.ctl_words} arrival counters bitwise"
                     f" the plain version's")
        log(line)
        del pre, ex_p
        torch.cuda.empty_cache()
        if traced is not None:          # the trace ring over both chips
            ex_t = MegakernelExecutor(traced, cfg2, "cuda")
            ex_t.upload(heap)
            ex_t.write_step_inputs(toks, lens)
            ex_t.launch()
            _check_tp_run(traced, heap, ex_t.worker_counters(), want)
            ring = ex_t.task_ring()
            ticks = np.sort(np.concatenate([ring[:, 3], ring[:, 4]]))
            assert np.array_equal(ticks, np.arange(2 * ring.shape[0]))
            tl = decode_ring(traced, ring)
            order = check_event_order(tl)
            assert order == [], order[:5]
            assert {e.chip for e in tl.events} == {0, 1}
            # chip isolation: chip 1's wq scaled by 1 + 2^-10
            wq = wide.view(heap, "L0.wq", 1)
            saved = wq.clone()
            wq.mul_(1.0009765625)
            ex.write_step_inputs(toks, lens)
            ex.launch()
            c0, c1 = (wide.view(heap, "logits", c).cpu() for c in (0, 1))
            assert not torch.equal(c0, want) and not torch.equal(c1, want)
            assert torch.equal(c0, c1)
            wq.copy_(saved)
            log(f"  TP=2 traced at W={ws[-1]}: ticks a permutation, "
                f"check_event_order clean over {len(tl.events)} events on "
                f"chips {sorted({e.chip for e in tl.events})}; chip 1's wq "
                f"x (1 + 2^-10): both chips' logits moved (max "
                f"{float((c0 - want).abs().max()):.3e}), bitwise equal to "
                f"each other; init_weights draws TP=2's chips bitwise "
                f"TP=1's weights")
            del ex_t, saved
        del ex, heap
        torch.cuda.empty_cache()
    log(f"phase {tag} ok ({cfg.name}): logits bitwise equal across TP in "
        f"{TP_DEGREES}, W and chips, max_err vs plain {max(errs):.3e}")
    return max(errs)


def phase_tp_serve(cfg, w_max, tag):
    """The TP slice: full-depth granite at TP=4 (W = W_max // 4) served
    through ``compile(..., tp=4)`` and a ``ServingEngine`` as in phase 3b,
    weights drawn from the same seed into chip 0 and copied to the
    others.  Every decode step bitwise phase 3b's (TP=1, dynamic), within
    3e-4 of the torch Program (teacher-forced on chip 0's weights); one
    static step after the run bitwise phase 3b's static step; the step
    from a zero state bitwise TP=2's.  Times the static step at TP=2 and
    TP=4 (and the walks), ``Program.step``, the compile and the stamp;
    holds the kernel to its plain version (3e-4); bounds: every chip's
    bytes plus the ring's; each kind alone, kinds 14-15 together."""
    from repro_torch.api import compile as mk_compile
    from repro_torch.megakernel import (launch_count, lower_tgraph,
                                        megakernel_plain, reset_launch_count)
    from repro_torch.megakernel.desc import stamp_multichip
    from repro_torch.runtime import Request, ServingEngine
    ref = SERVED[cfg.name]
    toks, lens = ref["toks"], ref["lens"]
    ragged = np.array([16, 120])
    gen = lambda: torch.Generator(device="cuda").manual_seed(SEED)

    def noop_walk(plan):
        walk = plan.descs.copy()
        walk[:, 0] = 0
        return torch.from_numpy(walk).cuda()

    # TP = 2: the step from a zero state, its time and its walk
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel",
                      num_workers=w_max // 2, tp=2)
    compile2 = time.perf_counter() - t0
    prog.init_weights(gen())
    prog.init_state()
    ex = prog.executor
    ex.write_step_inputs(toks, lens)
    ex.launch()
    zero2 = prog.plan.view(ex.heap, "logits").cpu()
    _check_tp_run(prog.plan, ex.heap, ex.worker_counters(), zero2)
    ms2 = _kernel_ms(ex, toks, lens, 5)
    walk2 = _kernel_ms(ex, toks, lens, 3, noop_walk(prog.plan))
    p2 = prog.plan
    log(f"  TP=2 plan at W={w_max // 2}: {p2.num_workers} lanes, "
        f"{p2.num_steps} steps, {p2.descs.shape[0]} rows, heap "
        f"{p2.heap_size * 4 / 1e9:.2f} GB (host compile and stamp "
        f"{compile2:.1f} s); static step {ms2:.3f} ms, walk {walk2:.3f} ms")
    del prog, ex, p2
    gc.collect()
    torch.cuda.empty_cache()

    # TP = 4: compile, draw, the zero-state step, then serve
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel",
                      num_workers=w_max // 4, tp=4)
    compile_s = time.perf_counter() - t0
    plan, ex = prog.plan, prog.executor
    t0 = time.perf_counter()
    stamp_multichip(lower_tgraph(plan.compiled, cfg), 4)
    stamp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog.init_weights(gen())
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_coll = len(_allreduces(plan))
    log(f"  TP=4 plan at W={w_max // 4}: {plan.num_workers} lanes (the "
        f"partition uses {plan.compiled.partition.num_workers} workers a "
        f"chip), {plan.num_steps} steps, {plan.descs.shape[0]} rows, "
        f"{n_coll} collectives of {4 * 4 - 3} ring steps, "
        f"{plan.num_events} event counters, {plan.ctl_words} arrival "
        f"counters, heap {plan.heap_size * 4 / 1e9:.2f} GB (4 regions of "
        f"{plan.chip_stride * 4 / 1e9:.2f} GB); host compile and stamp "
        f"{compile_s:.1f} s, of it the stamp {stamp_s:.1f} s; weights drawn "
        f"into chip 0 and copied to chips 1-3 in {draw_s:.1f} s")
    prog.init_state()
    ex.write_step_inputs(toks, lens)
    ex.launch()
    _check_tp_run(plan, ex.heap, ex.worker_counters(), zero2)
    prog.init_state()

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
    assert launches > 0 and launches == eng.decode_iterations
    steps = [c[3] for c in calls if c[0] == "step"]
    assert len(steps) == len(ref["steps"])
    for got, want in zip(steps, ref["steps"]):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    log(f"  served 4 requests at TP=4 in {wall:.1f} s: {eng.iterations} "
        f"iterations, {launches} decode steps and kernel launches, every "
        f"step's logits bitwise phase {tag[:-1]}b's (TP=1); outputs "
        + " ".join(str(r.output[:2]) for r in
                   sorted(done, key=lambda r: r.request_id)))
    torch_prog = mk_compile(cfg, B, S, backend="torch").bind(
        prog.weight_views())
    torch_prog.init_state()
    worst = 0.0
    for c in calls:
        if c[0] == "reset":
            torch_prog.reset_slot(c[1])
        elif c[0] == "prefill":
            torch_prog.prefill(c[1], c[2], c[3])
        else:
            worst = max(worst, _close(torch.from_numpy(c[3]), torch.from_numpy(
                torch_prog.step(c[1], c[2])), 3e-4))
    torch_prog.step(toks, lens)                       # warm-up
    library_ms = _events_ms(lambda: torch_prog.step(toks, lens), 3)
    del torch_prog
    torch.cuda.empty_cache()
    log(f"  teacher-forced {len(steps)} decode steps through the torch "
        f"Program: max |logits diff| {worst:.3e} (<= 3e-4)")

    # one static step after the run: bitwise phase 3b's
    ex.write_step_inputs(toks, lens)
    ex.launch()
    waits, sigs = _check_tp_run(plan, ex.heap, ex.worker_counters(),
                                ref["static_logits"])
    log(f"  one step at lengths {tuple(map(int, lens))} after the run: "
        f"logits on 4 "
        f"chips bitwise phase {tag[:-1]}b's static step, {n_coll} "
        f"collectives exact identities, {waits} waits, {sigs} signals, 0 "
        f"violations")

    ms = _kernel_ms(ex, toks, lens, 5)
    ms_ragged = _kernel_ms(ex, toks, ragged, 5)
    walk_ms = _kernel_ms(ex, toks, lens, 3, noop_walk(plan))
    step_ms = _events_ms(lambda: type(prog).step(prog, toks, lens), 3)
    ex.write_step_inputs(toks, lens)
    ex.launch()
    kernel_logits = plan.view(ex.heap, "logits").clone()
    nbytes, flops = _step_work(plan, cfg, lens, ex.heap)
    all_bytes, all_flops = _step_work(plan, cfg, lens)
    ring = _ring_bytes(plan)
    bound_ms, bound_by = _bound((4 * nbytes + ring, 4 * flops))
    bound_all_ms = _bound((4 * all_bytes + ring, 4 * all_flops))[0]
    ex.write_step_inputs(toks, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megakernel_plain(ex.heap, plan.descs, plan.statics, acks=plan.acks)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _close(kernel_logits, plan.view(ex.heap, "logits"), 3e-4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kind, kind_ms = _time_by_kind(ex, plan, toks, lens)
    log(f"  TP=4 decode step at lengths {tuple(map(int, lens))}: static "
        f"kernel {ms:.3f} ms (TP=2 {ms2:.3f} ms, TP=1 {ref['ms']:.3f} ms in "
        f"phase {tag[:-1]}b), ragged {tuple(map(int, ragged))} "
        f"{ms_ragged:.3f} ms; the walk of the all-noop "
        f"table {walk_ms:.3f} ms (TP=2 {walk2:.3f} ms); Program.step "
        f"{step_ms:.3f} ms; torch Program step {library_ms:.3f} ms; plain "
        f"version {plain_ms:.1f} ms, kernel vs plain max_err={err:.3e}; "
        f"bound {bound_ms:.3f} ms ({bound_by}: 4 x {nbytes / 1e9:.2f} GB of"
        f" the routed experts + {ring / 1e6:.2f} MB of ring traffic), "
        f"{bound_all_ms:.3f} ms with every expert; peak memory "
        f"{peak_gb:.2f} GB")
    log(f"  kernel time by kind alone at TP=4 (kind ms/tasks; noop = the "
        f"walk; send+allreduce_chunk = the COMM rows): " + ", ".join(by_kind))
    log(f"phase {tag} ok ({cfg.name} at TP=4)")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "tp": 4, "lanes": plan.num_workers,
            "ms_ragged": ms_ragged, "walk_ms": walk_ms, "ms_tp2": ms2,
            "walk_tp2_ms": walk2, "program_step_ms": step_ms,
            "compile_s": compile_s, "stamp_s": stamp_s, "peak_gb": peak_gb,
            "comm_ms": kind_ms["send+allreduce_chunk"],
            "bound_all_experts_ms": bound_all_ms, "ring_bytes": ring,
            "served_max_err": worst}


def standalone_bounds():
    """The standalone TPU kernels still to port, at the largest float32
    shape of ``tests/test_kernels.py``: each one's bound (each input read
    once, the output written once; causal attention does half the
    products) beside the time of the one PyTorch call that computes the
    same function (CUDA events over 100 calls after 10 warm-up calls,
    TF32 off).  Returns (name, shape, bytes, FLOPs, bound ms, bound by,
    library call, library ms) per kernel."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    m, k, n = 384, 128, 384
    a, b = rnd(m, k), rnd(k, n)
    rows, d = 256, 512
    x, w = rnd(rows, d), rnd(d)
    bb, s, h, hd = 2, 256, 4, 64
    q, kk, v = rnd(bb, h, s, hd), rnd(bb, h, s, hd), rnd(bb, h, s, hd)
    cases = [
        ("matmul", f"({m},{k})x({k},{n})", 4 * (m * k + k * n + m * n),
         2 * m * k * n, "torch.matmul", lambda: torch.matmul(a, b)),
        ("rmsnorm", f"({rows},{d})", 4 * (2 * rows * d + d), 4 * rows * d,
         "torch.nn.functional.rms_norm",
         lambda: F.rms_norm(x, (d,), w, 1e-6)),
        ("flash_attention", f"causal B={bb} S={s} H={h} hd={hd}",
         4 * 4 * bb * s * h * hd, 4 * bb * h * s * s * hd // 2,
         "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
         lambda: F.scaled_dot_product_attention(q, kk, v, is_causal=True)),
    ]
    out = []
    for name, shape, nbytes, flops, call, fn in cases:
        for _ in range(10):
            fn()
        lib_ms = _events_ms(fn, 100)
        out.append((name, shape, nbytes, flops) + _bound((nbytes, flops))
                   + (call, lib_ms))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    w_max = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(what, fn, *args):
        gc.collect()                    # the last phase's heaps go first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"  [{what}: {time.perf_counter() - t0:.1f} s]")
        return out

    timed("phase 1", phase_build)
    dense = get_config("deepseek-7b")
    # the MoE slice at the reference's dropless capacity factor: the
    # megakernel is dropless, and so are the torch Program and prefill
    granite = get_config("granite-moe-1b-a400m")
    granite = dataclasses.replace(granite,
                                  capacity_factor=float(granite.n_experts))
    err2 = timed("phase 2", phase_workers, dense, w_max, "2")
    k = timed("phase 3", phase_serve, dense, w_max, "3")
    err2b = timed("phase 2b", phase_workers, granite, w_max, "2b")
    kb = timed("phase 3b", phase_serve, granite, w_max, "3b")
    mamba = get_config("mamba2-2.7b")
    err2c = timed("phase 2c", phase_workers, mamba, w_max, "2c")
    kc = timed("phase 3c", phase_serve, mamba, w_max, "3c")
    err2d = max(timed("phase 2d", phase_tp_workers, m, w_max, "2d")
                for m in (dense, granite))
    kd = timed("phase 3d", phase_tp_serve, granite, w_max, "3d")
    lib = timed("standalone bounds", standalone_bounds)
    for row in lib:
        log("  still to port: %s at %s: %d bytes, %d FLOP, bound %.6f ms "
            "(%s); library yardstick %s %.6f ms" % row)
    kernel = {"name": "megakernel", "route": "cuda",
              "source": "src/repro_torch/megakernel/csrc/megakernel.cu",
              "replaces": "src/repro/kernels/megakernel/kernel.py:1175",
              "kinds": "0-15"}
    # the top-level times are deepseek-7b's (the dense slice); each
    # model's own numbers follow under "models"
    kernel.update(k)
    kernel["launches"] = k["launches"] + kb["launches"] + kc["launches"] \
        + kd["launches"]
    kernel["max_abs_err"] = max(k["max_abs_err"], err2, kb["max_abs_err"],
                                err2b, kc["max_abs_err"], err2c, err2d,
                                kd["max_abs_err"])
    kernel["models"] = {dense.name: k, granite.name: kb, mamba.name: kc,
                        f"{granite.name} tp=4": kd}
    log(f"chip_smoke took {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
