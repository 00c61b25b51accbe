#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Drives the port's main path on the card, imports nothing of JAX or of the
JAX package, and fails (non-zero exit, no result line) on any fault.
W_max is the card's SM count (132 on an H100): the megakernel is asked
for that many workers, and the partitioner picks the width it uses.

1. prints the card's name and power limit, then builds the CUDA
   megakernel from ``src/repro_torch/megakernel/csrc`` and the standalone
   kernels from ``src/repro_torch/kernels/csrc`` for sm_90a (two nvcc
   processes at once) and prints their registers and spills, checks the
   standalone SASS (``cuobjdump -sass``: HGMMA and UTMALDG in every bf16
   kernel, neither HGMMA nor HMMA in an f32 one), then reads
   back the statics one launch gave the kernel (``mk_last_statics``: the
   M-RoPE sections at the end of ``mk_launch``'s arguments); a W
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
   timed alone under the static scheduler, each worker walking its real
   rows (the plan's walk lists), beside the walk's two tables: every row
   a noop with its event words (the walk), and without them (the rows
   alone; the difference is the event chain);
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
3c. the SSM slice: mamba2 served as in phase 3 at 16 of its 64 layers
   (``MAMBA_SERVED_LAYERS``: the full model's host compile and
   musicgen's do not both fit the time limit; one compile at W_max
   lowered to both plans on one heap, never cloned), each decode step
   within 3e-4 of the torch Program; one step
   from one state through the static W_max, the W = 1 and the dynamic
   table gives bitwise-equal logits, conv windows and SSD states, within
   3e-4 of the plain version (the windows' shifted rows bitwise); the
   step timed static, dynamic and at W = 1 beside its bound (the
   weights, the SSD and conv states read and written once), each task
   kind alone;
2e. the embedding-input slice: qwen2-vl-2b cut to 2 layers at full width
   (d=1536, GQA 12/2 heads of 128, qkv bias redrawn, M-RoPE sections
   (16, 24, 24)) with the checks of phase 2, every step fed (B, D)
   embeddings (``h0``) and distinct (t, h, w) positions (image patches);
   kind 3 alone (``_time_by_kind``'s table) within 2e-4 of the plain
   version on those positions, and other q rows on text-mode positions;
3e. full 28-layer qwen2-vl served as in phase 3, but driven through
   ``Program.prefill`` and ``Program.step`` (the ``ServingEngine`` takes
   tokens only): 4 requests with ragged prompts of 16, 40, 72 and 100
   seeded embedding rows, chunk 16, 8 decode steps of one embedding row
   each, every decode step within 3e-4 of the torch Program
   (teacher-forced), the static W_max, W = 1 and dynamic tables bitwise
   on one heap, the step timed beside its bound;
3f. the same for musicgen-large (32 MHA heads of 64, tanh GELU) at 24
   of its 48 layers (``MUSICGEN_SERVED_LAYERS``: its 48-layer host
   compile took 204-343 s on the H100 machine's host and brought the
   script near its time limit); its 2-layer
   checks folded into this phase: the bitwise tables and the kernel
   against its plain version at the served depth;
2g. the same checks on gemma-7b cut to 2 layers at full width (d=3072,
   16 MHA heads of 256, so H * hd = 4096 differs from d; d_ff 24576 with
   GeGLU, the (1 + w) RMSNorm, the sqrt(d) embedding scale and the tied
   head, whose 5,376-column matmul tiles run as two passes over column
   ranges), and each task kind alone (``_time_by_kind``'s table) within
   2e-4 of the plain version, rope and attention at head_dim 256
   included;
3g. gemma-7b at ``GEMMA_SERVED_LAYERS`` of its 28 layers (all of them:
   the served phase fits the script's time limit, PERF.md section 4)
   served as in phase 3 (a ``ServingEngine``, 4 ragged requests, every
   decode step within 3e-4 of the torch Program, the static W_max, W = 1
   and dynamic tables bitwise on one heap), the step timed static and
   dynamic beside its bound, each task kind alone;
3h. llama4-maverick's shared experts (a GLU MLP on every token beside
   the routed experts, summed by a residual add; dense and MoE layers
   interleaved) at full width (d=5120, 40 heads of 128 over 8 KV heads,
   expert width 8192), cut to ``LLAMA4_SERVED`` (4 layers, 16 of its 128
   experts, a 32,000-token vocabulary: one MoE layer of all 128 experts
   is 64 GB, and the extended kernel refuses head tiles wider than one
   pass), dropless, served as in phase 3b;
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
4. the standalone kernels (``repro_torch.kernels``: matmul, rmsnorm and
   flash attention, hand-written CUDA built beside the megakernel in
   phase 1; bf16 on the tensor cores, f32 on FFMA) at the largest f32
   shapes of ``tests/test_kernels.py`` (and its non-causal case), at
   deepseek-7b's full width, attention at gemma-7b's head width of 256
   and at the padded widths 32 and 96, rmsnorm at full width also on
   strided and unaligned rows (its scalar path), f32 and bf16:
   each launched through its entry point and held to its plain version
   (f32 at the reference's tolerances, bf16 to one ulp with at most 1 %
   of the outputs' bits differing), each library call
   (``torch.matmul``, ``F.rms_norm``, ``F.scaled_dot_product_attention``)
   to the oracle at the reference's tolerances, then each timed beside
   its plain version, the library call and its bounds (bf16 at the
   tensor cores' peak), with the host's share of a call (events less the
   device time).  Then one JSON line on the kernels (launches on the main
   paths, the largest error against the plain version over all, times,
   the bounds) and the device line last.
   Every phase prints its wall time.
"""
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
B, S = 2, 128
H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_F32_FLOPS = 67e12             # float32 outside the tensor cores
H100_BF16_TC_FLOPS = 989e12        # dense bf16 on the tensor cores


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


def _device_ms(fn, n, key=None):
    """Mean device milliseconds per call of ``fn`` over ``n`` calls, by
    ``torch.profiler``: the CUDA kernels whose name holds ``key`` (or one
    of the tuple ``key``; all of them when None); None if the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    keys = (key,) if isinstance(key, str) else key
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_time_total > 0
                and (keys is None or any(k in e.key for k in keys)))
    return total / n / 1e3 if total else None


def _close(a, b, tol, atol=None):
    """max |a - b| after checking |a - b| <= atol + tol * |b| everywhere
    (atol = tol unless given)."""
    atol = tol if atol is None else atol
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    err = (a - b).abs()
    assert bool((err <= atol + tol * b.abs()).all()), float(err.max())
    return float(err.max())


def phase_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.kernels.build import build_library as build_standalone
    from repro_torch.megakernel.build import build_library
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # one nvcc per source, together
        standalone = pool.submit(build_standalone)
        path, out = build_library()
        spath, sout = standalone.result()
    log(f"phase 1 ok: built {path.name} and {spath.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    _log_standalone_ptxas(sout)
    _check_standalone_sass(spath)
    names = {"ILb0ELi0E": "static", "ILb1ELi0E": "dynamic",
             "ILb0ELi1E": "static extended", "ILb1ELi1E": "dynamic extended",
             "ILb0ELi2E": "static full", "ILb1ELi2E": "dynamic full",
             "ILb0ELi3E": "static multichip", "ILb0ELi4E": "static wide",
             "ILb1ELi4E": "dynamic wide"}
    which = ""
    for line in out.splitlines():
        if "megakernel" in line and ("Compiling" in line
                                     or "Function properties" in line):
            which = next((v for k, v in names.items() if k in line), "")
        if which and ("registers" in line or "spill" in line):
            log(f"  nvcc, {which} kernel:", line.strip())
    _echo_statics()


#: the statics of phase 1's one-noop launch: distinct values in every
#: integer field, M-RoPE sections included, so that an argument in the
#: wrong place of ``mk_launch``'s ctypes list shows
_ECHO = {"W": 1, "TN": 384, "TK": 1536, "HD": 128, "G": 6, "STORE_CH": 64,
         "THETA": 1e6, "EVENT_OFF": 40, "N_EVENTS": 1, "STATS_OFF": 48,
         "NG": 2, "S_MAX": 128, "TOPK": 8, "HD_SSM": 64, "N_SSM": 128,
         "NH_TILE": 2, "W_CONV": 4, "MROPE": (16, 24, 24)}


def _echo_statics():
    """One launch of a one-noop table through ``megakernel``, then the
    statics the kernel was given (``mk_last_statics``) against the values
    passed: the M-RoPE sections ride at the end of ``mk_launch``'s 36
    arguments, after the stream."""
    import ctypes
    from repro_torch.megakernel import megakernel
    from repro_torch.megakernel.build import load_library
    from repro_torch.megakernel.kernel import SPIN_TIMEOUT_S
    heap = torch.zeros(64, device="cuda")
    descs = torch.zeros((1, 36), dtype=torch.int64)
    descs[:, 32] = descs[:, 34] = -1
    megakernel(heap, descs.cuda(), _ECHO)
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * 26)()
    load_library().mk_last_statics(out)
    e = _ECHO
    want = [e["TN"], e["TK"], e["HD"], e["G"], e["STORE_CH"], e["STATS_OFF"],
            e["EVENT_OFF"], -1, int(SPIN_TIMEOUT_S * 1e9), e["NG"], 0, 0, 0,
            0, 0, 0, 0, 0, e["TOPK"], e["HD_SSM"], e["N_SSM"], e["NH_TILE"],
            e["W_CONV"], *e["MROPE"]]
    assert list(out) == want, (list(out), want)
    log(f"  mk_launch's statics read back from the library: {list(out)} "
        f"(as passed; M-RoPE sections {list(out)[-3:]})")


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


def _check_primaries(plan, counters):
    """The launch demand-loaded every primary tile (counter word 3) and
    prefetched none (word 2): the kernel reads the plan's prefetch words
    (24-27) and does not act on them.  Returns (the demand loads, the
    table's rows with word 27 = 1)."""
    d = plan.descs
    prim = (d[:, 0] != 0) & (d[:, 30] > 0)
    assert sum(c["prefetch_tiles"] for c in counters) == 0
    n_dl = sum(c["primary_fallbacks"] for c in counters)
    assert n_dl == int(prim.sum()) > 0, n_dl
    return n_dl, int((prim & (d[:, 27] == 1)).sum())


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


def phase_dynamic(cfg2, w_max, plans, base, first, toks, lens, tag,
                  pos=None):
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
        ex.write_step_inputs(toks, lens, pos)
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
        ex_plain.write_step_inputs(toks, lens, pos)
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
        wide.write_step_inputs(toks, lens, pos)
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


#: distinct (t, h, w) M-RoPE positions of the two rows of a step: image
#: patches at rows 3 and 4, columns 5 and 9, of images that start at
#: positions 30 and 80 (what a Qwen2-VL frontend gives an image's patches)
GRID_POS = np.array([[30, 33, 35], [80, 84, 89]])


def _step_inputs(cfg, rng):
    """One step's inputs: B token ids, or B seeded embedding rows (the
    (B, D) ``h0`` of an embedding-input config)."""
    if cfg.embed_input:
        return rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    return rng.integers(1, cfg.vocab, size=B)


def _bias_vectors(plan, heap, seed=SEED + 2):
    """Redraw the qkv biases N(0, 0.1): the reference initialises them to
    zero, which would hide a dropped bias.  Returns how many."""
    gen = torch.Generator(device=heap.device).manual_seed(seed)
    names = [n for n in plan.input_classes()["weights"]
             if n.split(".")[-1] in ("bq", "bk", "bv")]
    for n in names:
        plan.view(heap, n).normal_(0.0, 0.1, generator=gen)
    return len(names)


def _check_kinds_alone(plan, cfg2, base, toks, lens, pos, codes=(3,)):
    """Each task kind of ``codes`` alone (``_time_by_kind``'s table: every
    other row a noop, its event words kept) on the card and in the plain
    version, from a heap where the plain version has run the whole step
    (every kind's inputs in place): every output of the kind's ops within
    2e-4 of the plain version's.  Under M-RoPE, kind 3's rows take
    ``pos``, distinct (t, h, w) columns, and the same table on text-mode
    positions must give other q rows.  Returns the largest error."""
    from repro_torch.megakernel import (MegakernelExecutor, launch_count,
                                        megakernel, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.megakernel.desc import KIND_CODES
    ex = MegakernelExecutor(plan, cfg2, "cuda")
    ex.upload(base.clone())
    ex.write_step_inputs(toks, lens, pos)
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    image = ex.heap.clone()             # two heaps beside the phase's one
    worst = 0.0
    for code in codes:
        table = plan.descs.copy()
        table[table[:, 0] != code, 0] = 0
        table = torch.from_numpy(table).cuda()
        outs = [op.outputs[0] for op in plan.compiled.graph.ops
                if KIND_CODES.get(op.kind) == code]
        assert outs, code
        err, first = 0.0, {}
        mrope = code == 3 and pos is not None
        for p in ((pos, None) if mrope else (pos,)):
            ex.heap.copy_(image)
            ex.write_step_inputs(toks, lens, p)
            reset_launch_count()
            megakernel(ex.heap, table, plan.statics)
            torch.cuda.synchronize()
            assert launch_count() == 1
            assert all(c["event_wait_violations"] == 0
                       for c in ex.worker_counters())
            got = {n: plan.view(ex.heap, n).clone() for n in outs}
            ex.heap.copy_(image)        # the plain version on the same
            ex.write_step_inputs(toks, lens, p)   # heap, from the image
            megakernel_plain(ex.heap, table.cpu().numpy(), plan.statics)
            for n in outs:
                err = max(err, _close(got[n], plan.view(ex.heap, n), 2e-4))
            first[p is None] = got[outs[0]]
        if mrope:
            assert not torch.equal(first[False], first[True])
        log(f"  kind {code} ({KIND_NAMES[code]}) alone at "
            f"W={plan.num_workers} ({len(outs)} outputs, "
            f"{int((plan.descs[:, 0] == code).sum())} tasks"
            + (", distinct (t, h, w) positions and then text mode"
               if mrope else "")
            + (f", head_dim {plan.statics['HD']}" if code in (3, 6) else "")
            + f"): max_err vs plain {err:.3e} (<= 2e-4)")
        worst = max(worst, err)
    del ex, image
    torch.cuda.empty_cache()
    return worst


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


def phase_workers(cfg, w_max, tag, kinds_alone=False):
    """Two layers at full width, one heap image: the kernel at W ∈ {1, 2,
    4, W_max} against each other and against its plain version, then
    traced at W_max; the deadline and residency faults in phase 2.  With
    ``kinds_alone``, each task kind of the plan alone against the plain
    version (an embedding-input plan checks kind 3 alone always)."""
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
    n_bias = _bias_vectors(traced, src.heap)
    base = src.heap
    rng = np.random.default_rng(SEED)
    toks, lens = _step_inputs(cfg, rng), np.array([37, 90])
    pos = GRID_POS if cfg.mrope_sections is not None else None
    state = p1.input_classes()["state"]
    routers = _routers(p1)

    def run(plan):
        ex = MegakernelExecutor(plan, cfg2, "cuda")
        ex.upload(base.clone())
        ex.write_step_inputs(toks, lens, pos)
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
        ex_plain.write_step_inputs(toks, lens, pos)
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
        n_dl, _ = _check_primaries(plan, counters)
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
            f"{waits} waits, {sigs} signals, 0 violations; counter blocks "
            f"(words 0-11) the plain version's, {n_dl} primary tiles "
            f"demand-loaded")
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
    if kinds_alone:
        codes = sorted(set(wide.descs[:, 0].tolist()) - {0})
        errs.append(_check_kinds_alone(wide, cfg2, base, toks, lens, pos,
                                       codes))
    if cfg.embed_input:
        if not kinds_alone:
            errs.append(_check_kinds_alone(wide, cfg2, base, toks, lens,
                                           pos))
        log(f"  the step took (B, D) embeddings (h0) in place of tokens"
            + (f", {n_bias} qkv bias vectors redrawn" if n_bias else "")
            + (f", positions {pos.tolist()} (t, h, w) with M-RoPE "
               f"sections {cfg.mrope_sections}" if pos is not None else ""))
    err_dyn = phase_dynamic(cfg2, w_max, plans, base, first, toks, lens,
                            tag, pos)
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


def _bound(work, flops_per_s=H100_F32_FLOPS):
    """(ms, "bytes" or "operations") of a step's (bytes, FLOPs) on the
    H100's published rates: its memory rate and the peak for the data
    type (f32 unless given)."""
    t_b, t_f = work[0] / H100_HBM_BYTES_PER_S, work[1] / flops_per_s
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def _stream_partition(plan):
    """How the static partition spreads the weight stream: the matmul
    and expert-GEMM weight words (rows · columns of each tile) each
    worker reads, the busiest worker's against the mean over the workers
    that read any, and the matmul tiles wider than one pass of the
    kernel's matmul (``MM_PASS``) and the workers that run them."""
    from repro_torch.megakernel.kernel import MM_PASS
    d, W = plan.descs, plan.num_workers
    lane = np.arange(d.shape[0]) % W
    mm = np.isin(d[:, 0], (1, 10))
    words = np.bincount(lane[mm], weights=(d[mm, 3] * d[mm, 2])
                        .astype(np.float64), minlength=W)
    wide = np.bincount(lane[(d[:, 0] == 1) & (d[:, 2] > MM_PASS)],
                       minlength=W)
    top = int(words.argmax())
    return {"busiest_worker": top, "busiest_words": float(words[top]),
            "mean_words": float(words[words > 0].mean()),
            "matmul_workers": int((words > 0).sum()),
            "wide_tiles": int(wide.sum()), "wide_workers":
            int((wide > 0).sum()), "busiest_wide_tiles": int(wide[top])}


KIND_NAMES = ("noop", "matmul", "rmsnorm", "rope", "glu", "resid",
              "attention", "cache_update", "embed", "topk", "expert_gemm",
              "combine", "ssm", "conv", "send", "allreduce_chunk")


def _kernel_ms(ex, toks, lens, n, descs=None):
    """Mean milliseconds of the executor's kernel launch (or of a launch
    of ``descs`` on its heap, through the plan's walk lists) over ``n``
    launches after one warm-up, by CUDA events around each launch alone;
    each launch follows the step's ``index_copy_``, which zeroes the event
    counters and rewrites the queue image."""
    from repro_torch.megakernel import megakernel
    launch = ex.launch
    if descs is not None:
        plan = ex.plan
        sched = torch.from_numpy(plan.dyn.sched_table()).cuda() \
            if plan.dynamic else None
        launch = lambda: megakernel(ex.heap, descs, plan.statics, sched,
                                    ex._acks, ex._walk)
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


def _rows_alone(plan):
    """The walk's second table: every row a noop with its event words
    cleared, walked through the plan's lists (each worker's real rows):
    the per-row cost alone (ring, barriers, dispatch).  The all-noop
    table less this one is the event chain."""
    table = plan.descs.copy()
    table[:, 0] = 0
    table[:, 32:35] = -1
    return torch.from_numpy(table).cuda()


def _time_by_kind(ex, plan, toks, lens):
    """Kernel time of each task kind alone: the step's descriptor table
    with every other row turned into a noop (its event words kept, so the
    workers still wait and signal), one launch after a warm-up, each
    worker walking its real rows (the plan's lists).  The all-noop table
    is the walk itself (ring, barriers, the event protocol), and the
    rows-alone table (``_rows_alone``) its per-row part.  The COMM kinds
    (14 send, 15 all-reduce chunk) run together: a ring send of round r
    >= 1 waits for its receiver's arrivals.  Run last: the heap's
    activations are overwritten with partial results.  Returns the log
    entries and {name: ms}, "rows" the rows-alone table's."""
    kinds = plan.descs[:, 0]
    real = plan.walk.size - plan.num_workers - 1
    groups = [(c,) for c in [0] + sorted(set(kinds.tolist()) - {0, 14, 15})]
    if 14 in kinds:
        groups.append((14, 15))
    out, times = [], {}
    for codes in groups:
        table = plan.descs.copy()
        table[~np.isin(kinds, codes), 0] = 0
        ms = _kernel_ms(ex, toks, lens, 1, torch.from_numpy(table).cuda())
        n = int(np.isin(kinds, codes).sum()) if codes[0] else real
        name = "+".join(KIND_NAMES[c] for c in codes)
        out.append(f"{name} {ms:.2f} ms/{n}")
        times[name] = ms
    times["rows"] = _kernel_ms(ex, toks, lens, 1, _rows_alone(plan))
    out.append(f"rows alone {times['rows']:.2f} ms/{real} (event chain "
               f"{times['noop'] - times['rows']:.2f} ms)")
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

#: layers of mamba2-2.7b's served phase 3c (of 64): the 64-layer plan's
#: host compile and the 48-layer musicgen's (105-244 s and 204-248 s on
#: the host CPU of an H100 machine) do not both fit the script's time
#: limit
MAMBA_SERVED_LAYERS = 16

#: layers of musicgen-large's served phase 3f (of 48): its 48-layer host
#: compile took up to 343 s on the host of an H100 machine, which with
#: the other phases' host time left the script within 10 % of its limit
MUSICGEN_SERVED_LAYERS = 24

#: layers of gemma-7b's served phase 3g (of 28): all of them; its heap is
#: 70.0 GB of the card's 80 GB, and the phase's host compile and run fit
#: the script's time limit (PERF.md section 4)
GEMMA_SERVED_LAYERS = 28

#: llama4-maverick's served phase 3h: (layers, experts, vocabulary) of
#: its (48, 128, 202048), at full width.  One MoE layer of all 128
#: experts is 64 GB in float32; 16 experts over 4 layers (two of them
#: MoE, each with its shared expert) make a 36.7 GB heap.  The MoE kinds
#: run in the extended kernel, which refuses matmul tiles wider than one
#: pass (``kernel.MM_PASS``): the full vocabulary's head tiles are 4,224
#: columns, 32,000's under one pass
LLAMA4_SERVED = (4, 16, 32000)


def _serve_embeds(prog, cfg, rng, chunk=16, new=8):
    """Serve the ``PROMPTS`` requests of an embedding-input model straight
    through the Program (the ``ServingEngine`` takes tokens only, as the
    reference's does): two requests at a time on the B = 2 slots, each
    slot reset, its prompt of seeded embedding rows prefilled in
    ``chunk``-row chunks (the shorter prompt's rows past its end are
    padding, chunk length 0), then ``new`` decode steps of one seeded
    embedding row per slot (the next frame or patch a frontend would
    give), each one kernel launch.  Returns {request: the argmax of each
    step's logits} and the number of steps."""
    outputs, n_steps = {}, 0
    for pair in (PROMPTS[:B], PROMPTS[B:]):
        ids = [PROMPTS.index(n) for n in pair]
        for slot in range(B):
            prog.reset_slot(slot)
        prompts = [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
                   for n in pair]
        for c0 in range(0, max(pair), chunk):
            rows = np.zeros((B, chunk, cfg.d_model), np.float32)
            clens = np.zeros((B,), np.int64)
            for b, x in enumerate(prompts):
                part = x[c0:c0 + chunk]
                rows[b, :len(part)] = part
                clens[b] = len(part)
            prog.prefill(rows, np.minimum(pair, c0), clens)
        lens = np.array(pair)
        for _ in range(new):
            logits = prog.step(_step_inputs(cfg, rng), lens)
            for b, i in enumerate(ids):
                outputs.setdefault(i, []).append(int(logits[b].argmax()))
            lens = lens + 1
            n_steps += 1
    return outputs, n_steps

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
    n_vec += _bias_vectors(dplan, prog.executor.heap)
    torch.cuda.synchronize()
    log(f"  weights drawn into the heap in {time.perf_counter() - t0:.1f} s"
        + (f" ({n_vec} A_log, D_skip, dt_bias, conv bias or qkv bias "
           "vectors redrawn per head and channel)" if n_vec else ""))
    ref = mk_compile(cfg, B, S, backend="torch").bind(prog.weight_views())

    calls = []
    _record(prog, calls)
    rng = np.random.default_rng(SEED)
    reset_launch_count()
    t0 = time.perf_counter()
    if cfg.embed_input:
        outputs, n_steps = _serve_embeds(prog, cfg, rng)
        what = (f"prompts of {PROMPTS} seeded embedding rows, 8 decode "
                f"steps of one embedding row each, chunk 16) through "
                f"Program.prefill and Program.step")
    else:
        eng = ServingEngine(prog, chunk=16)
        for i, n in enumerate(PROMPTS):
            eng.submit(Request(i, rng.integers(1, cfg.vocab,
                                               size=n).tolist(),
                               max_new_tokens=8))
        done = eng.run()
        assert len(done) == 4 and all(len(r.output) == 8 for r in done)
        outputs = {r.request_id: r.output for r in done}
        n_steps = eng.decode_iterations
        what = (f"prompts {PROMPTS} tokens, 8 new each, chunk 16) through "
                f"a ServingEngine, {eng.iterations} iterations")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_count()
    assert all(0 <= t < cfg.vocab for o in outputs.values() for t in o)
    assert launches > 0 and launches == n_steps, (launches, n_steps)
    log(f"  served 4 requests ({what}, scheduler='dynamic', in {wall:.1f} "
        f"s: {n_steps} decode steps, {launches} kernel launches")
    for i in sorted(outputs):
        log(f"  req {i}: {outputs[i]}")

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
    toks, lens = _step_inputs(cfg, rng), np.array([64, 64])
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
    n_dl, n_plan = _check_primaries(plan, counters)
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
    plain_counters = ex.worker_counters()
    words03 = ("bulk_copies", "row_copies", "prefetch_tiles",
               "primary_fallbacks")
    assert [[c[k] for k in words03] for c in counters] \
        == [[c[k] for k in words03] for c in plain_counters]
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
    ps = plan.pipeline_stats()
    log(f"  primary tiles (static, W={W}): {n_dl} demand-loaded (counter "
        f"word 3), none prefetched (word 2), though {n_plan} rows carry "
        f"word 27 = 1 (the plan's coverage {ps['prefetched_tasks']} of "
        f"{ps['prefetchable_tasks']} tasks, "
        f"{ps['prefetch_coverage']:.3f}); words 0-3 of every worker's "
        f"block the plain version's")
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
    stream = _stream_partition(plan)
    log(f"  matmul weight words each worker streams (the partition): "
        f"busiest worker {stream['busiest_worker']} "
        f"{stream['busiest_words'] / 1e6:.1f} M words, mean "
        f"{stream['mean_words'] / 1e6:.1f} M over the "
        f"{stream['matmul_workers']} workers with matmuls; tiles wider "
        f"than one pass ({stream['wide_tiles']}) on "
        f"{stream['wide_workers']} workers, "
        f"{stream['busiest_wide_tiles']} of them on the busiest")
    by_kind, kind_ms = _time_by_kind(ex, plan, toks, lens)
    log(f"  kernel time by kind alone under the static scheduler at W={W} "
        "(kind ms/tasks; noop = the walk of each worker's real rows with "
        "the event protocol): " + ", ".join(by_kind))
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
           "demand_loads": n_dl,
           "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "workers": W, "ms_w1": ms1,
           "ms_w1_ragged": ms1_ragged, "ms_dyn": ms_dyn,
           "ms_dyn_ragged": ms_dyn_ragged,
           "ms_static_ragged": ms_static_ragged, "dyn_walk_ms": dyn_walk_ms,
           "bound_ragged_ms": bound_ragged, "served_max_err": worst,
           "compile_s": compile_s, "walk_ms": kind_ms["noop"],
           "walk_rows_ms": kind_ms["rows"],
           "walk_events_ms": kind_ms["noop"] - kind_ms["rows"],
           "real_rows": int(plan.walk.size - W - 1),
           "grid_rows": int(plan.descs.shape[0]), **stream}
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
    counters = ex.worker_counters()
    waits, sigs = _check_tp_run(plan, ex.heap, counters,
                                ref["static_logits"])
    n_dl, _ = _check_primaries(plan, counters)
    log(f"  one step at lengths {tuple(map(int, lens))} after the run: "
        f"logits on 4 "
        f"chips bitwise phase {tag[:-1]}b's static step, {n_coll} "
        f"collectives exact identities, {waits} waits, {sigs} signals, 0 "
        f"violations, {n_dl} primary tiles demand-loaded")

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
    words03 = ("bulk_copies", "row_copies", "prefetch_tiles",
               "primary_fallbacks")
    assert [[c[k] for k in words03] for c in counters] \
        == [[c[k] for k in words03] for c in ex.worker_counters()]
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
            "demand_loads": n_dl,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "tp": 4, "lanes": plan.num_workers,
            "ms_ragged": ms_ragged, "walk_ms": walk_ms,
            "walk_rows_ms": kind_ms["rows"],
            "walk_events_ms": kind_ms["noop"] - kind_ms["rows"],
            "real_rows": int(plan.walk.size - plan.num_workers - 1),
            "grid_rows": int(plan.descs.shape[0]), "ms_tp2": ms2,
            "walk_tp2_ms": walk2, "program_step_ms": step_ms,
            "compile_s": compile_s, "stamp_s": stamp_s, "peak_gb": peak_gb,
            "comm_ms": kind_ms["send+allreduce_chunk"],
            "bound_all_experts_ms": bound_all_ms, "ring_bytes": ring,
            "served_max_err": worst}


#: phase 4's cases: (kernel, label, dims, keywords); (a) the largest
#: float32 shapes of tests/test_kernels.py (PERF.md's table) and its
#: non-causal case, (b) deepseek-7b at full width: the up-projection of a
#: B=2, 128-token prefill chunk, its rmsnorm, and causal attention over
#: deepseek-llm-7b's 4096-token context (32 heads of 128), (c) attention
#: at gemma-7b's head width (16 heads of 256, configs/gemma_7b.py) over
#: the same context, at the widths the kernel pads (32, every reduced
#: config's; 96) and at heads wider than 256 (320 and 512: the wide
#: kernel; no config of the repo has one); rmsnorm also on rows its
#: scalar path takes
#: (``_layout``: every other column of a wider tensor, and a start one
#: element past a 16-byte boundary)
STANDALONE_CASES = (
    ("matmul", "test", (384, 128, 384), {}),
    ("matmul", "full", (256, 4096, 11008), {}),
    ("rmsnorm", "test", (256, 512), {}),
    ("rmsnorm", "full", (256, 4096), {}),
    ("rmsnorm", "full strided", (256, 4096), {"layout": "strided"}),
    ("rmsnorm", "full unaligned", (256, 4096), {"layout": "unaligned"}),
    ("flash_attention", "test", (2, 256, 4, 64), {"bq": 128, "bk": 64}),
    ("flash_attention", "test non-causal", (1, 128, 2, 64),
     {"bq": 64, "bk": 64, "causal": False}),
    ("flash_attention", "full", (1, 4096, 32, 128), {}),
    ("flash_attention", "full hd=256", (1, 4096, 16, 256), {}),
    ("flash_attention", "hd=32", (2, 512, 8, 32), {}),
    ("flash_attention", "hd=96 non-causal", (2, 384, 4, 96),
     {"causal": False}),
    ("flash_attention", "hd=320", (1, 1024, 8, 320), {}),
    ("flash_attention", "hd=512", (1, 1024, 8, 512), {}),
    ("flash_attention", "hd=512 non-causal", (1, 1024, 8, 512),
     {"causal": False}),
)

#: (rtol, atol) of a kernel against its plain version, f32 then bf16.
#: f32: the reference's (tests/test_kernels.py:22, :35, :52, :66).  bf16:
#: both sides compute in f32 (in other orders) and round once, so they
#: differ by at most one bf16 ulp, 2^-7 of the value at most: rtol 8e-3,
#: and an atol for outputs near zero, where the f32 orders' difference
#: is the larger (matmul's 1.41e-5 at K = 4096, PERF.md §2).  Both are
#: tighter than the reference's bf16 3e-2, which at full width is about
#: the size of a typical flash-attention output (|o| ~ 0.03 at S = 4096).
STANDALONE_TOL = {"matmul": ((1e-4, 1e-4), (8e-3, 1e-3)),
                  "rmsnorm": ((1e-5, 1e-5), (8e-3, 1e-3)),
                  "flash_attention": ((2e-5, 2e-5), (8e-3, 1e-4))}

#: the share of bf16 outputs whose bits may differ from the plain
#: version's: a one-ulp fault (a truncating f32 -> bf16 store, a drift in
#: a load) moves about half of them and passes any rtol above one ulp;
#: one f32 rounding order against another moves the few that lie near a
#: rounding boundary
STANDALONE_BF16_DIFFER = 0.01

#: the library call against the oracle of repro_torch.kernels.ref: the
#: reference's tolerances (rtol = atol, f32 then bf16); the library may
#: round inside (SDPA's bf16 probabilities), so it is a check that the
#: yardstick computes the same function, not of a kernel
LIBRARY_TOL = {"matmul": (1e-4, 2e-2), "rmsnorm": (1e-5, 3e-2),
               "flash_attention": (2e-5, 3e-2)}

#: the kernels' symbols, for the profiler (each prefixes its kernels':
#: matmul_kernel_wgmma<BN> and matmul_kernel_ffma, flash_kernel_wgmma<HD>
#: and flash_kernel_ffma<HD>)
STANDALONE_SYMBOLS = {"matmul": ("matmul_kernel", "matmul_reduce_kernel"),
                      "rmsnorm": ("rmsnorm_kernel", "rmsnorm_vec_kernel"),
                      "flash_attention": "flash_kernel"}

#: ptxas and SASS labels of the library's kernels, by symbol; the bf16
#: kernels must hold HGMMA and UTMALDG (wgmma fed by TMA), the f32 ones
#: neither HGMMA nor HMMA (no TF32)
STANDALONE_KERNELS = (("matmul_kernel_wgmma", "matmul bf16 wgmma", "bf16"),
                      ("matmul_kernel_ffma", "matmul f32 ffma", "f32"),
                      ("matmul_reduce_kernel", "matmul f32 split-K sum",
                       None),
                      ("flash_kernel_wgmma", "flash_attention bf16 wgmma",
                       "bf16"),
                      ("flash_kernel_ffma", "flash_attention f32 ffma",
                       "f32"),
                      ("flash_kernel_wide", "flash_attention wide ffma",
                       "f32"),
                      ("rmsnorm_kernel", "rmsnorm scalar", None),
                      ("rmsnorm_vec_kernel", "rmsnorm vector", None))

STANDALONE_REPLACES = {"matmul": "src/repro/kernels/matmul.py:48",
                       "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
                       "flash_attention":
                           "src/repro/kernels/flash_attention.py:77"}


def _standalone_label(line):
    """"matmul bf16 wgmma BN=192", "flash_attention f32 ffma HD=256",
    "rmsnorm vector bf16", ... for a ptxas or cuobjdump line that names one of
    the standalone kernels, else None."""
    for sym, label, _kind in STANDALONE_KERNELS:
        if sym in line:
            rest = line.split(sym, 1)[1]
            if sym.startswith("rmsnorm") or sym == "flash_kernel_wide":
                label += (" bf16" if rest.startswith("I13__nv_bfloat16")
                          else " f32")
            width = re.match(r"ILi(\d+)E", rest)
            if width:
                label += (" BN=" if sym.startswith("matmul") else " HD=") \
                    + width.group(1)
            return label
    return None


def _log_standalone_ptxas(out):
    which = None
    for line in out.splitlines():
        if "C7512" in line:     # wgmma serialised for want of registers
            log(f"  nvcc, {_standalone_label(line)}:", line.strip()[:120])
        elif "Compiling" in line or "Function properties" in line:
            which = _standalone_label(line)
        elif which and ("registers" in line or "spill" in line):
            log(f"  nvcc, {which}:", line.strip())


def _check_standalone_sass(lib):
    """Phase 1: the SASS of each bf16 kernel holds HGMMA and UTMALDG, of
    each f32 kernel neither HGMMA nor HMMA (``cuobjdump -sass`` of the
    built library); says so when the toolkit has no cuobjdump."""
    from repro_torch.megakernel.build import _nvcc
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log(f"  SASS: not checked ({tool} is missing)")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, kind, label = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            label = _standalone_label(line)
            kind = next((k for sym, _l, k in STANDALONE_KERNELS
                         if sym in line), None)
            counts[label] = (kind, {op: 0 for op in ("HGMMA", "UTMALDG",
                                                     "HMMA")})
        elif label is not None:
            for op in counts[label][1]:
                counts[label][1][op] += op + "." in line or op + " " in line
    for label, (kind, n) in sorted(counts.items(), key=lambda kv: str(kv)):
        log(f"  SASS, {label}: HGMMA {n['HGMMA']}, UTMALDG {n['UTMALDG']}, "
            f"HMMA {n['HMMA']}")
        if kind == "bf16":
            assert n["HGMMA"] and n["UTMALDG"], (label, n)
        elif kind == "f32":
            assert not n["HGMMA"] and not n["HMMA"], (label, n)
    assert {k for k, _n in counts.values()} >= {"bf16", "f32"}, counts


def _standalone_inputs(name, dims, gen):
    """f32 inputs drawn as a model's are (the matmul's weight scaled by
    1/sqrt(K)); the bf16 inputs are their casts."""
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    if name == "matmul":
        m, k, n = dims
        return rnd(m, k), rnd(k, n) / k ** 0.5
    if name == "rmsnorm":
        rows, d = dims
        return rnd(rows, d), rnd(d)
    return rnd(*dims), rnd(*dims), rnd(*dims)


def _layout(x, layout):
    """``x`` copied into the layout a phase-4 case names: "strided" (the
    even columns of a tensor twice as wide) or "unaligned" (a view that
    starts one element past a 16-byte boundary); ``x`` itself for None."""
    if layout is None:
        return x
    rows, d = x.shape
    if layout == "strided":
        wide = x.new_zeros((rows, 2 * d))
        wide[:, ::2] = x
        return wide[:, ::2]
    if layout == "unaligned":
        flat = x.new_zeros((rows * d + 1,))
        view = flat[1:].view(rows, d)
        view.copy_(x)
        return view
    raise ValueError(f"no layout {layout!r}")


def _standalone_launches(name, dims, dtype):
    """CUDA kernels one call launches: 2 for an f32 matmul whose K the
    plan splits (the GEMM, then the sum of its partial tiles), else 1."""
    if name != "matmul" or dtype != torch.float32:
        return 1
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.matmul import plan
    m, k, n = dims
    return 1 if plan(m, n, k, 0, sm_count(torch.device("cuda")))[1] == 1 \
        else 2


def _standalone_work(name, dims, kw, itemsize):
    """(bytes, FLOPs) of one call: each input read once, the output
    written once; causal attention does the s(s+1)/2 products of its
    visible pairs."""
    if name == "matmul":
        m, k, n = dims
        return itemsize * (m * k + k * n + m * n), 2 * m * k * n
    if name == "rmsnorm":
        rows, d = dims
        return itemsize * (2 * rows * d + d), 4 * rows * d
    b, s, h, hd = dims
    pairs = s * (s + 1) // 2 if kw.get("causal", True) else s * s
    return itemsize * 4 * b * s * h * hd, 4 * b * h * hd * pairs


def phase_standalone():
    """Phase 4: the standalone kernels through ``repro_torch.kernels``, the
    entry point a user calls, on phase 1's build of the library.
    Launches each kernel at every case of
    ``STANDALONE_CASES`` in f32 and bf16 (the path: launch counts reset
    just before and read just after: each call launches its kernel once,
    a split f32 matmul its GEMM and the sum of its partials)
    and holds each output to its plain version within
    ``STANDALONE_TOL`` (in bf16 with at most ``STANDALONE_BF16_DIFFER``
    of the outputs' bits differing), and the library call to the oracle
    of ``repro_torch.kernels.ref`` within ``LIBRARY_TOL``.  Then times the
    kernel and the library call (CUDA events over 100 calls after 10
    warm-up calls) and the plain version (10 calls after 2) beside the
    bounds, and the kernel's and the library call's device time alone by
    ``torch.profiler`` (20 calls): at small shapes the events measure the
    host's cost of a call.  Returns the three entries of the ``kernels`` JSON line, each
    with its full-width f32 case at the top level."""
    import torch.nn.functional as F
    from repro_torch import kernels as sk
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import SOURCE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    runs = []
    for name, label, dims, kw in STANDALONE_CASES:
        x32 = _standalone_inputs(name, dims, gen)
        layout = kw.get("layout")
        kw = {k: v for k, v in kw.items() if k != "layout"}
        for dt in (torch.float32, torch.bfloat16):
            xs = tuple(t.to(dt) for t in x32)
            runs.append((name, label, dims, kw, dt,
                         (_layout(xs[0], layout),) + xs[1:]))
    sk.reset_launch_counts()
    outs = [getattr(sk, name)(*xs, **kw)
            for name, label, dims, kw, dt, xs in runs]
    torch.cuda.synchronize()
    launches = sk.launch_counts()
    for name in STANDALONE_REPLACES:
        want = sum(_standalone_launches(r[0], r[2], r[4]) for r in runs
                   if r[0] == name)
        assert launches[name] == want, (name, launches)
    lib_calls = {
        "matmul": lambda a, b, **kw: torch.matmul(a, b),
        "rmsnorm": lambda x, w, **kw: F.rms_norm(x, (x.shape[1],), w, 1e-6),
        "flash_attention": lambda q, k, v, causal=True, **kw:
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal).transpose(1, 2)}
    oracles = {"matmul": lambda a, b, **kw: ref.matmul_ref(a, b),
               "rmsnorm": lambda x, w, **kw: ref.rmsnorm_ref(x, w),
               "flash_attention": lambda q, k, v, causal=True, **kw:
                   ref.flash_attention_ref(q, k, v, causal)}
    rows = {name: [] for name in STANDALONE_REPLACES}
    for (name, label, dims, kw, dt, xs), got in zip(runs, outs):
        bf16 = dt == torch.bfloat16
        rtol, atol = STANDALONE_TOL[name][bf16]
        kernel = getattr(sk, name)
        plain = getattr(sk, name + "_plain")
        want = plain(*xs, **kw)
        assert got.dtype == dt and got.shape == want.shape
        err = _close(got, want, rtol, atol)
        differ = float((got != want).float().mean())
        assert not bf16 or differ <= STANDALONE_BF16_DIFFER, (name, differ)
        library = lib_calls[name]
        lib_err = _close(library(*xs, **kw), oracles[name](*xs, **kw),
                         LIBRARY_TOL[name][bf16])
        for _ in range(10):
            kernel(*xs, **kw)
        ms = _events_ms(lambda: kernel(*xs, **kw), 100)
        for _ in range(10):
            library(*xs, **kw)
        lib_ms = _events_ms(lambda: library(*xs, **kw), 100)
        for _ in range(2):
            plain(*xs, **kw)
        plain_ms = _events_ms(lambda: plain(*xs, **kw), 10)
        device_ms = _device_ms(lambda: kernel(*xs, **kw), 20,
                               STANDALONE_SYMBOLS[name])
        lib_device_ms = _device_ms(lambda: library(*xs, **kw), 20)
        nbytes, flops = _standalone_work(name, dims, kw, xs[0].element_size())
        # the bound at the card's peak for the data type: bf16 on the
        # tensor cores (the kernels' own FFMA path is beside it)
        bound_ms, bound_by = _bound(
            (nbytes, flops), H100_BF16_TC_FLOPS if bf16 else H100_F32_FLOPS)
        row = {"case": label, "dims": list(dims), "dtype": str(dt)[6:],
               **{k: v for k, v in kw.items() if k == "causal"},
               "max_abs_err": err, "bits_differ": differ,
               "library_max_abs_err": lib_err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "device_ms": device_ms, "library_device_ms": lib_device_ms,
               "host_ms": None if device_ms is None else ms - device_ms,
               "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
               "bound_by": bound_by}
        if bf16:
            row["bound_ffma_ms"] = _bound((nbytes, flops))[0]
        rows[name].append(row)
        dev = lambda t: "none" if t is None else f"{t:.6f}"
        log(f"  {name} {label} {tuple(dims)} {row['dtype']}: kernel "
            f"{ms:.6f} ms (device {dev(device_ms)}, host share "
            f"{dev(row['host_ms'])}), plain {plain_ms:.6f} "
            f"ms, library {lib_ms:.6f} ms (device {dev(lib_device_ms)}), "
            f"bound {bound_ms:.6f} ms ({bound_by}"
            + (f" at the bf16 tensor cores' peak; {row['bound_ffma_ms']:.6f}"
               " ms at the f32 FFMA rate" if bf16 else "")
            + f"); max |err| {err:.3g} vs plain (rtol {rtol:g}, atol "
            f"{atol:g}), bits differ in {differ:.3g} of the outputs; "
            f"library {lib_err:.3g} vs the oracle")
    log(f"phase 4 ok: launches {launches}")
    entries = []
    for name, cases in rows.items():
        top = next(r for r in cases
                   if r["case"] == "full" and r["dtype"] == "float32")
        entries.append({
            "name": name, "route": "cuda",
            "source": str(SOURCE.relative_to(ROOT)),
            "replaces": STANDALONE_REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "device_ms",
                                   "library_device_ms", "dims", "dtype")},
            "cases": cases})
    return entries


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
    mamba = get_config("mamba2-2.7b")
    qwen = get_config("qwen2-vl-2b")
    # served cut to MUSICGEN_SERVED_LAYERS of its 48 layers, for the time
    # limit
    music = dataclasses.replace(get_config("musicgen-large"),
                                n_layers=MUSICGEN_SERVED_LAYERS)
    gemma = get_config("gemma-7b")
    gemma_served = dataclasses.replace(gemma, n_layers=GEMMA_SERVED_LAYERS)
    n_l, n_e, n_v = LLAMA4_SERVED
    llama4 = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                                 n_layers=n_l, n_experts=n_e, vocab=n_v,
                                 capacity_factor=float(n_e))
    err2 = timed("phase 2", phase_workers, dense, w_max, "2")
    k = timed("phase 3", phase_serve, dense, w_max, "3")
    err2b = timed("phase 2b", phase_workers, granite, w_max, "2b")
    kb = timed("phase 3b", phase_serve, granite, w_max, "3b")
    err2c = timed("phase 2c", phase_workers, mamba, w_max, "2c")
    # served cut to MAMBA_SERVED_LAYERS of its 64 layers, for the time
    # limit: its host compile was the script's longest before musicgen's
    kc = timed("phase 3c", phase_serve,
               dataclasses.replace(mamba, n_layers=MAMBA_SERVED_LAYERS),
               w_max, "3c")
    err2e = timed("phase 2e", phase_workers, qwen, w_max, "2e")
    ke = timed("phase 3e", phase_serve, qwen, w_max, "3e")
    kf = timed("phase 3f", phase_serve, music, w_max, "3f")
    err2g = timed("phase 2g", phase_workers, gemma, w_max, "2g", True)
    kg = timed("phase 3g", phase_serve, gemma_served, w_max, "3g")
    kh = timed("phase 3h", phase_serve, llama4, w_max, "3h")
    err2d = max(timed("phase 2d", phase_tp_workers, m, w_max, "2d")
                for m in (dense, granite))
    kd = timed("phase 3d", phase_tp_serve, granite, w_max, "3d")
    from repro_torch.kernels import launch_counts
    served = launch_counts()            # the served paths launch none
    assert not any(served.values()), served
    standalone = timed("phase 4", phase_standalone)
    for entry in standalone:
        entry["served_launches"] = served[entry["name"]]
    kernel = {"name": "megakernel", "route": "cuda",
              "source": "src/repro_torch/megakernel/csrc/megakernel.cu",
              "replaces": "src/repro/kernels/megakernel/kernel.py:1175",
              "kinds": "0-15, kind 3 with M-RoPE"}
    # the top-level times are deepseek-7b's (the dense slice); each
    # model's own numbers follow under "models"
    kernel.update(k)
    kernel["launches"] = sum(m["launches"]
                             for m in (k, kb, kc, kd, ke, kf, kg, kh))
    kernel["max_abs_err"] = max(k["max_abs_err"], err2, kb["max_abs_err"],
                                err2b, kc["max_abs_err"], err2c, err2d,
                                kd["max_abs_err"], ke["max_abs_err"], err2e,
                                kf["max_abs_err"], kg["max_abs_err"], err2g,
                                kh["max_abs_err"])
    kernel["models"] = {dense.name: k, granite.name: kb, mamba.name: kc,
                        f"{granite.name} tp=4": kd, qwen.name: ke,
                        music.name: kf, gemma.name: kg, llama4.name: kh}
    log(f"chip_smoke took {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": [kernel] + standalone}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
