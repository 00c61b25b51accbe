"""On the card: the hand-written CUDA megakernel against its plain PyTorch
version, at the reduced size (deepseek-7b reduced: GQA with 4 query heads
over 2 KV heads; granite-moe reduced; mamba2 reduced, and mamba2's kinds
12-13 at full width; qwen2-vl and musicgen reduced, and at full width
their ``h0`` step and kind 3 with M-RoPE on distinct (t, h, w)
positions), under the static and the dynamic scheduler; and the
standalone kernels (``repro_torch.kernels``) against theirs, at the
shapes of ``tests/test_kernels.py`` and at deepseek-7b's full width.
Every test here is marked ``gpu`` and skips without a CUDA device; the
file imports no JAX, so it runs where JAX is absent:

    pytest -m gpu tests/test_torch_*.py
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.api import compile as torch_compile
from repro_torch.configs import get_config
from repro_torch.core.graph import OpKind
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel, launch_count,
                                    lower_tgraph, megakernel_plain,
                                    reset_launch_count)
from repro_torch.megakernel.desc import dynamic_tail
from repro_torch.megakernel.kernel import (SPIN_TIMEOUT_S, check_workers,
                                           max_workers, megakernel)
from repro_torch.megakernel.ops import read_stats_block
from repro_torch.obs import check_event_order, decode_ring
from repro_torch.runtime.dyn_sched import DynSchedPlan

B, S = 2, 16
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(layers):
    return dataclasses.replace(get_config("deepseek-7b").reduced(),
                               n_layers=layers)


def _check_cache_updates(plan, heap, plain, seq_lens):
    """Each cache update copied its new K/V row exactly, into row
    ``seq_lens[b]`` only: in the kernel's heap the written row equals its
    source bitwise and every other row equals the plain version's; the
    new rows themselves agree within 2e-4 (RoPE's cos/sin and the
    matmul's summation order differ in the last bits)."""
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CACHE_UPDATE:
            continue
        cache, new = op.inputs[0], op.inputs[1]
        for h in (heap, plain):
            c, n = plan.view(h, cache), plan.view(h, new)
            for b, s in enumerate(seq_lens):
                assert torch.equal(c[b, s], n[b]), (cache, b)
        mask = torch.ones(plan.layout[cache].shape[:2], dtype=torch.bool)
        mask[torch.arange(len(seq_lens)), torch.tensor(seq_lens)] = False
        mask = mask.to(heap.device)
        assert torch.equal(plan.view(heap, cache)[mask],
                           plan.view(plain, cache)[mask]), cache
        torch.testing.assert_close(plan.view(heap, new),
                                   plan.view(plain, new), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [1, 2])
def test_cuda_kernel_matches_plain_version(cuda, layers):
    """One step on one heap image: logits within 2e-4, the embedding and
    the cache-update copies bitwise, the counters equal, one launch
    counted."""
    cfg = _cfg(layers)
    plan = compile_decode_megakernel(cfg, B, S)
    ex = MegakernelExecutor(plan, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ex.init_weights(gen)
    for name in plan.input_classes()["state"]:
        plan.view(ex.heap, name).normal_(0.0, 1.0, generator=gen)
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    plain = ex.heap.clone()
    reset_launch_count()
    ex.launch()
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, plan.descs, plan.statics)
    torch.testing.assert_close(plan.view(ex.heap, "logits"),
                               plan.view(plain, "logits"), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(plan.view(ex.heap, "h0"), plan.view(plain, "h0"))
    _check_cache_updates(plan, ex.heap, plain, [1, 12])
    assert read_stats_block(ex.heap, plan.stats_offset, 1) \
        == read_stats_block(plain, plan.stats_offset, 1)


@pytest.mark.gpu
def test_cuda_program_matches_torch_program(cuda):
    """Eight decode steps through the megakernel Program on the card
    against the torch Program on the same weights, within 3e-4."""
    cfg = _cfg(2)
    mk = torch_compile(cfg, B, S, backend="megakernel")
    mk.init_weights(torch.Generator(device=cuda).manual_seed(4))
    ref = torch_compile(cfg, B, S, backend="torch").bind(mk.weight_views())
    mk.init_state()
    ref.init_state()
    reset_launch_count()
    rng = np.random.default_rng(0)
    lens = np.zeros((B,), np.int32)
    for i in range(8):
        toks = rng.integers(1, cfg.vocab, size=B)
        np.testing.assert_allclose(mk.step(toks, lens), ref.step(toks, lens),
                                   rtol=3e-4, atol=3e-4, err_msg=f"step {i}")
        lens += 1
    assert launch_count() == 8


def _step_at(plan, cfg, base, cuda):
    """One launch of ``plan`` on a clone of the heap image ``base``."""
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(base.clone())
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    plain = ex.heap.clone()
    ex.launch()
    torch.cuda.synchronize()
    return ex, plain


@pytest.mark.gpu
def test_cuda_kernel_bitwise_across_workers(cuda):
    """W ∈ {1, 2, 4} CTAs from one heap image: logits and every cache
    bitwise equal across W, each W within 2e-4 of its plain version, the
    table's waits and signals counted with no violation, and the traced
    W = 4 run's ring in a clean event order with a permutation of ticks
    and the heap outside the ring unchanged."""
    cfg = _cfg(2)
    plans = {w: compile_decode_megakernel(cfg, B, S, num_workers=w)
             for w in (1, 2, 4)}
    traced = compile_decode_megakernel(cfg, B, S, num_workers=4, trace=True)
    assert [p.num_workers for p in plans.values()] == [1, 2, 4]
    ex = MegakernelExecutor(traced, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ex.init_weights(gen)
    for name in traced.input_classes()["state"]:
        traced.view(ex.heap, name).normal_(0.0, 1.0, generator=gen)
    base = ex.heap
    outs = {}
    for w, plan in plans.items():
        run, plain = _step_at(plan, cfg, base, cuda)
        megakernel_plain(plain, plan.descs, plan.statics)
        torch.testing.assert_close(plan.view(run.heap, "logits"),
                                   plan.view(plain, "logits"), rtol=2e-4,
                                   atol=2e-4)
        outs[w] = {n: plan.view(run.heap, n).clone() for n in
                   ["logits"] + plan.input_classes()["state"]}
        counters = run.worker_counters()
        rows = np.arange(plan.descs.shape[0]) % w
        for i, c in enumerate(counters):
            assert c["event_wait_violations"] == 0
            assert c["event_waits"] == int((plan.descs[rows == i, 32]
                                            >= 0).sum())
            assert c["event_signals"] == int((plan.descs[rows == i, 34]
                                              >= 0).sum())
        assert counters == read_stats_block(plain, plan.stats_offset, w)
        if w == 4:
            untraced = run.heap
    for w in (2, 4):
        for n, v in outs[1].items():
            assert torch.equal(outs[w][n], v), (w, n)
    run, _ = _step_at(traced, cfg, base, cuda)
    lo = traced.ring_offset
    assert torch.equal(run.heap[:lo], untraced[:lo])
    ring = run.task_ring()
    ticks = np.sort(np.concatenate([ring[:, 3], ring[:, 4]]))
    assert np.array_equal(ticks, np.arange(2 * ring.shape[0]))
    tl = decode_ring(traced, ring)
    assert any(e.wait_ev >= 0 for e in tl.events)
    assert check_event_order(tl) == []


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "tp2"])
def test_cuda_compacted_walk_bitwise_full_walk(cuda, family):
    """The executor's launch (each worker runs its walk list) against a
    launch that walks the whole grid, from one heap image: the whole heap
    (outputs, state, event counters, counter blocks) bitwise equal, for
    the dense, MoE and SSM families at W = 4 and a TP=2 stamp."""
    cfg, tp = {"dense": (_cfg(2), 1), "moe": (_moe_cfg(1), 1),
               "ssm": (_ssm_cfg(1), 1), "tp2": (_cfg(1), 2)}[family]
    plan = compile_decode_megakernel(cfg, B, S, num_workers=4 // tp, tp=tp)
    assert plan.walk.size - plan.num_workers - 1 < plan.descs.shape[0]
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.init_weights(torch.Generator(device=cuda).manual_seed(3))
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    full = ex.heap.clone()
    ex.launch()
    megakernel(full, ex._descs, plan.statics, acks=ex._acks)
    torch.cuda.synchronize()
    assert torch.equal(ex.heap, full)


def _counter_case(family, cuda):
    """(config, tp, heap image, step inputs, positions) of one family of
    the counter test, its heap drawn for the widest W of the test."""
    cfg, tp = {"dense": (_cfg(2), 1), "moe": (_moe_cfg(1), 1),
               "ssm": (_ssm_cfg(1), 1),
               "embed": (_embed_cfg("qwen2-vl-2b", 1, False), 1),
               "gemma": (_gemma_cfg(1, False), 1),
               "tp2": (_cfg(1), 2)}[family]
    plan = compile_decode_megakernel(cfg, B, S, num_workers=4 // tp, tp=tp)
    if cfg.embed_input:
        base, x, pos = _embed_inputs(cfg, plan, cuda)
    else:
        base, x, pos = _base_heap(plan, cfg, cuda), np.array([3, 7]), None
        _ssm_vectors(plan, base)
    return cfg, tp, base, x, pos


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "embed", "gemma",
                                    "tp2"])
def test_cuda_static_counters_match_plain_version(cuda, family):
    """Under the static scheduler at W ∈ {1, 2, 4} (TP=2: 1 and 2 a chip;
    gemma: the reduced model with its head tiles wider than one pass, in
    the kernel's wide instantiation):
    each worker's counter block (words 0-11: transfers, rows, prefetched
    tiles, demand loads, waits, violations, signals) equal to the plain
    version's from the same heap, no tile prefetched and every primary
    tile demand-loaded (the kernel does not act on words 24-27); the
    logits and every state tensor bitwise equal across W."""
    cfg, tp, base, x, pos = _counter_case(family, cuda)
    first = None
    for w in ((1, 2) if tp > 1 else (1, 2, 4)):
        plan = compile_decode_megakernel(cfg, B, S, num_workers=w, tp=tp)
        ex = MegakernelExecutor(plan, cfg, cuda)
        ex.upload(base.clone())
        ex.write_step_inputs(x, np.array([1, 12]), pos)
        plain = ex.heap.clone()
        ex.launch()
        megakernel_plain(plain, plan.descs, plan.statics, acks=plan.acks)
        torch.cuda.synchronize()
        counters = ex.worker_counters()
        assert counters == read_stats_block(plain, plan.stats_offset,
                                            plan.num_workers)
        prim = (plan.descs[:, 0] != 0) & (plan.descs[:, 30] > 0)
        assert sum(c["prefetch_tiles"] for c in counters) == 0
        assert sum(c["primary_fallbacks"] for c in counters) \
            == int(prim.sum()) > 0
        assert all(c["event_wait_violations"] == 0 for c in counters)
        names = ["logits"] + plan.input_classes()["state"]
        outs = {n: plan.view(ex.heap, n).clone() for n in names}
        if first is None:
            first = outs
        for n in names:
            assert torch.equal(outs[n], first[n]), (w, n)


@pytest.mark.gpu
def test_workers_that_cannot_be_resident_raise(cuda):
    """A W larger than the CTAs the card can hold at once is refused
    before anything runs: by the executor's check and by the launch."""
    cfg = _cfg(1)
    plan = compile_decode_megakernel(cfg, B, S)
    n = max_workers(plan.statics, cuda)
    assert n >= torch.cuda.get_device_properties(0).multi_processor_count
    statics = dict(plan.statics, W=n + 1)
    with pytest.raises(RuntimeError, match="resident"):
        check_workers(statics, cuda)
    heap = torch.zeros(plan.heap_size + 16 * (n + 1), device=cuda)
    descs = torch.zeros(((n + 1), 36), dtype=torch.int64, device=cuda)
    descs[:, 32] = -1
    descs[:, 34] = -1
    reset_launch_count()
    with pytest.raises(RuntimeError, match="launch failed"):
        megakernel(heap, descs, statics)
    assert launch_count() == 0
    torch.cuda.synchronize()


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
megakernel(heap, descs.cuda(), statics)         # a row that waits on nothing
torch.cuda.synchronize()
print("clean launch ok", flush=True)
descs[0, 32], descs[0, 33] = 0, 1               # waits on an unsignalled event
megakernel(heap, descs.cuda(), statics)
torch.cuda.synchronize()
print("no fault", flush=True)
"""


@pytest.mark.gpu
def test_wait_past_its_deadline_fails_the_run(cuda):
    """A wait on an event that nobody signals traps at its deadline: the
    process's next synchronisation raises instead of hanging."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STUCK], env=env,
                          capture_output=True, text=True,
                          timeout=SPIN_TIMEOUT_S + 120)
    took = time.perf_counter() - t0
    assert proc.returncode != 0, proc.stdout
    assert "clean launch ok" in proc.stdout and "no fault" not in proc.stdout
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]
    assert took >= SPIN_TIMEOUT_S


def fanout_plan(T: int, W: int):
    """A dynamic plan of ``T`` noop rows: row 0 signals one event whose
    ``T - 1`` consumers all have worker 0's pool as affinity, so that the
    one push of its fan-out fills the pool and spills the rest into the
    overflow queue.  Returns (scheduler plan, descriptor table, statics,
    heap size); ``queue_image`` gives the initial pools."""
    wait = np.zeros(T, np.int32)
    wait[0] = -1
    sig = np.full(T, -1, np.int32)
    sig[0] = 0
    dyn = DynSchedPlan(W, T, np.zeros(T, np.int32), np.array([1], np.int32),
                       [list(range(1, T))], [[0]], wait, sig,
                       [[0]] + [[] for _ in range(W - 1)], [],
                       list(range(T)))
    descs = np.zeros((T, 36), np.int64)
    descs[:, 32], descs[:, 34] = wait, sig
    descs[1:, 33] = 1
    tail = dynamic_tail(dyn, 0)
    statics = {"TN": 128, "TK": 128, "HD": 128, "G": 1, "STORE_CH": 128,
               "THETA": 1e4, **tail["statics"]}
    return dyn, descs, statics, tail["heap_size"]


def fanout_heap(dyn, statics, heap_size, device):
    """A zeroed heap holding the fan-out plan's initial queue image."""
    heap = torch.zeros(heap_size, device=device)
    pools, cursors = dyn.queue_image()
    q0 = statics["QOFF"]
    heap[q0:q0 + pools.size] = torch.from_numpy(pools).to(device)
    c0 = statics["QC_OFF"]
    heap[c0:c0 + cursors.size] = torch.from_numpy(cursors).to(device)
    return heap


def _base_heap(plan, cfg, cuda, seed=3):
    """Random weights and a random cache in a heap laid out for ``plan``."""
    ex = MegakernelExecutor(plan, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ex.init_weights(gen)
    for name in plan.input_classes()["state"]:
        plan.view(ex.heap, name).normal_(0.0, 1.0, generator=gen)
    return ex.heap


def _check_dynamic(ex):
    """The dynamic launch's own accounting: every pool drained, T pops,
    the pop trace a permutation of the rows, no wait violation."""
    plan = ex.plan
    T = plan.dyn.num_tasks
    qc = ex.scheduler_counters()
    assert qc["queue_pushed"] == qc["queue_popped"], qc
    assert sum(qc["queue_popped"]) == T
    assert qc["pops_own"] + qc["pops_overflow"] + qc["steals"] == T
    trace = ex.pop_trace()
    assert np.array_equal(np.sort(trace[:T]), np.arange(T))
    assert (trace[T:] == -1).all()
    assert all(c["event_wait_violations"] == 0
               for c in ex.worker_counters())
    return qc


@pytest.mark.gpu
def test_cuda_dynamic_bitwise_equal_static(cuda):
    """The dynamic kernel at W ∈ {1, 2, 4, W_max} from one heap image:
    logits and every cache bitwise equal to the static kernel's, within
    2e-4 of the plain dynamic version, pools drained, T pops, the pop
    trace a permutation; traced at W_max, a clean event order and the
    tensors and event counters unchanged by the ring."""
    cfg = _cfg(2)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    static = compile_decode_megakernel(cfg, B, S)
    dyn_plans = {}
    for w in (1, 2, 4, w_max):
        p = compile_decode_megakernel(cfg, B, S, num_workers=w)
        dyn_plans[w] = lower_tgraph(p.compiled, cfg, scheduler="dynamic")
    traced = lower_tgraph(dyn_plans[w_max].compiled, cfg,
                          scheduler="dynamic", trace=True)
    base = _base_heap(traced, cfg, cuda)
    run, _ = _step_at(static, cfg, base, cuda)
    names = ["logits"] + static.input_classes()["state"]
    want = {n: static.view(run.heap, n).clone() for n in names}
    for w, plan in dyn_plans.items():
        run, plain = _step_at(plan, cfg, base, cuda)
        for n in names:
            assert torch.equal(plan.view(run.heap, n), want[n]), (w, n)
        megakernel_plain(plain, plan.descs, plan.statics,
                         plan.dyn.sched_table())
        torch.testing.assert_close(plan.view(run.heap, "logits"),
                                   plan.view(plain, "logits"), rtol=2e-4,
                                   atol=2e-4)
        _check_dynamic(run)
        untraced = run.heap
    run, _ = _step_at(traced, cfg, base, cuda)
    lo = traced.queue_offset
    assert torch.equal(run.heap[:lo], untraced[:lo])
    _check_dynamic(run)
    tl = decode_ring(traced, run.task_ring())
    assert len(tl.events) == traced.dyn.num_tasks
    assert check_event_order(tl) == []


@pytest.mark.gpu
def test_cuda_dynamic_repeated_launches_bitwise(cuda):
    """Twenty launches at W_max on one heap give bitwise-equal logits:
    the pop order changes from launch to launch, the outputs do not."""
    cfg = _cfg(2)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    plan = compile_decode_megakernel(cfg, B, S, num_workers=w_max,
                                     scheduler="dynamic")
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(_base_heap(plan, cfg, cuda))
    first = None
    for _ in range(20):
        ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
        ex.launch()
        logits = plan.view(ex.heap, "logits").clone()
        first = logits if first is None else first
        assert torch.equal(logits, first)
    _check_dynamic(ex)


@pytest.mark.gpu
def test_cuda_dynamic_overflow_and_steal(cuda):
    """A fan-out of 299 consumers into one pool of 128 words: what does
    not fit spills into the overflow queue, and the four workers drain
    both.  Workers pop and steal from the pool while the pushes run, so
    the spill is whatever the cursors report, at most 299 - 128; every
    push is popped, every overflow push through an overflow pop."""
    dyn, descs, statics, size = fanout_plan(300, 4)
    heap = fanout_heap(dyn, statics, size, cuda)
    megakernel(heap, torch.from_numpy(descs).to(cuda), statics,
               torch.from_numpy(dyn.sched_table()).to(cuda))
    torch.cuda.synchronize()
    c0, W = statics["QC_OFF"], 4
    qc = heap[c0:c0 + 2 * (W + 1)].cpu().numpy()
    assert (qc[0::2] == qc[1::2]).all() and qc[1::2].sum() == 300
    # the root's push is the initial image's; its fan-out pushes 299
    assert qc[0:2 * W:2].sum() - 1 + qc[2 * W] == 300 - 1
    assert 0 <= qc[2 * W] <= 300 - 1 - 128       # the spill
    stats = read_stats_block(heap, statics["STATS_OFF"], W)
    assert sum(c["pops_overflow"] for c in stats) == qc[2 * W + 1]
    t0 = statics["TRACE_OFF"]
    assert np.array_equal(np.sort(heap[t0:t0 + 300].cpu().numpy()),
                          np.arange(300))


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


@pytest.mark.gpu
def test_dynamic_deadline_fails_the_run(cuda):
    """A dynamic plan whose one event has its trigger count raised by one
    never pushes that event's consumers: the workers find every pool
    empty with tasks left, and the kernel traps at the deadline instead
    of hanging."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _STUCK_DYN], env=env,
                          capture_output=True, text=True,
                          timeout=SPIN_TIMEOUT_S + 180)
    took = time.perf_counter() - t0
    assert proc.returncode != 0, proc.stdout
    assert "clean launch ok" in proc.stdout and "no fault" not in proc.stdout
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]
    assert took >= SPIN_TIMEOUT_S


# ---------------------------------------------------------------------------
# The MoE kinds (granite-moe-1b-a400m reduced: 4 experts, top-2).
# ---------------------------------------------------------------------------


def _moe_cfg(layers):
    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               n_layers=layers)


@pytest.mark.gpu
@pytest.mark.parametrize("code", [9, 10, 11])
def test_cuda_moe_kind_matches_plain_version(cuda, code):
    """Kind 9 (router top-k), 10 (expert GEMM) or 11 (combine) alone: on
    a heap where the plain version has run the whole step (every input
    of the kind in place), the table with every other row made a noop
    runs on the card and in the plain version from the same image.  The
    outputs agree within 2e-4; the router's zeros are the plain
    version's, bitwise, with ties among the logits of layer 0 broken to
    the lower expert."""
    cfg = _moe_cfg(1)
    plan = compile_decode_megakernel(cfg, B, S)
    base = _base_heap(plan, cfg, cuda)
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(base)
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    logits = plan.view(ex.heap, "L0.router_logits")
    logits[0] = torch.tensor([1.0, 3.0, 3.0, 2.0])       # a tie for first
    logits[1] = torch.tensor([0.5, -1.0, 0.5, 0.5])      # and for second
    table = plan.descs.copy()
    table[table[:, 0] != code, 0] = 0
    plain = ex.heap.clone()
    reset_launch_count()
    megakernel(ex.heap, torch.from_numpy(table).to(cuda), plan.statics)
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, table, plan.statics)
    out = {9: "L0.router", 10: "L0.eo", 11: "L0.moe_out"}[code]
    names = [out, "L0.eh"] if code == 10 else [out]
    for name in names:
        torch.testing.assert_close(plan.view(ex.heap, name),
                                   plan.view(plain, name), rtol=2e-4,
                                   atol=2e-4)
    if code == 9:
        got = plan.view(ex.heap, out)
        assert torch.equal(got == 0, plan.view(plain, out) == 0)
        assert (got[0] > 0).tolist() == [False, True, True, False]
        assert (got[1] > 0).tolist() == [True, False, True, False]
    assert read_stats_block(ex.heap, plan.stats_offset, 1) \
        == read_stats_block(plain, plan.stats_offset, 1)


@pytest.mark.gpu
def test_cuda_moe_step_bitwise_across_workers_and_schedulers(cuda):
    """Two MoE layers, one heap image: the static and the dynamic kernel
    at W ∈ {1, 2, 4, W_max} give bitwise-equal logits, caches and router
    weights, within 2e-4 of the plain version; pools drained, 0
    violations."""
    cfg = _moe_cfg(2)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for w in (1, 2, 4, w_max):
        p = compile_decode_megakernel(cfg, B, S, num_workers=w)
        plans += [p, lower_tgraph(p.compiled, cfg, scheduler="dynamic")]
    base = _base_heap(max(plans, key=lambda p: p.heap_size), cfg, cuda)
    names = ["logits", "L0.router", "L1.router", "L1.moe_out"] \
        + plans[0].input_classes()["state"]
    want = None
    for plan in plans:
        run, plain = _step_at(plan, cfg, base, cuda)
        got = {n: plan.view(run.heap, n).clone() for n in names}
        want = want or got
        for n in names:
            assert torch.equal(got[n], want[n]), (plan.num_workers, n)
        if plan.dynamic:
            _check_dynamic(run)
        else:
            assert all(c["event_wait_violations"] == 0
                       for c in run.worker_counters())
        if plan.num_workers == 1:
            megakernel_plain(plain, plan.descs, plan.statics,
                             plan.dyn.sched_table() if plan.dynamic
                             else None)
            torch.testing.assert_close(plan.view(run.heap, "logits"),
                                       plan.view(plain, "logits"),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_matmul_odd_store_width(cuda):
    """A dense model with a vocabulary of 1027: the LM head's last tile is
    3 columns wide and the masked-store chunk 1 column, so the wrapper
    picks the extended kernel, whose matmul tail pass computes all three
    columns of that tile.  Logits within 2e-4 of the plain version."""
    cfg = dataclasses.replace(_cfg(1), vocab=1027)
    plan = compile_decode_megakernel(cfg, B, S)
    assert plan.statics["STORE_CH"] == 1 and plan.statics["TOPK"] == 0
    run, plain = _step_at(plan, cfg, _base_heap(plan, cfg, cuda), cuda)
    megakernel_plain(plain, plan.descs, plan.statics)
    torch.testing.assert_close(plan.view(run.heap, "logits"),
                               plan.view(plain, "logits"), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# The Mamba2 kinds (mamba2-2.7b reduced: 8 heads of 32, N=16; and at full
# width: 80 heads of 64, N=128, the x conv 5120 channels wide).
# ---------------------------------------------------------------------------


def _ssm_cfg(layers, full=False):
    cfg = get_config("mamba2-2.7b")
    return dataclasses.replace(cfg if full else cfg.reduced(),
                               n_layers=layers)


def _ssm_vectors(plan, heap, seed=5):
    """A_log, D_skip, dt_bias and the conv biases redrawn per head and
    channel (their initial values are the same for every head, which
    would hide a wrong head offset or a dropped bias)."""
    gen = torch.Generator(device=heap.device).manual_seed(seed)
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


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("code", [12, 13])
def test_cuda_ssm_kind_matches_plain_version(cuda, code, full):
    """Kind 12 (SSD state update) or 13 (conv step) alone: on a heap where
    the plain version has run the whole step (every input of the kind in
    place), the table with every other row made a noop runs on the card
    and in the plain version from the same image.  Outputs and SSD
    states agree within 2e-4, the conv windows bitwise, the counters
    equal."""
    cfg = _ssm_cfg(1, full)
    plan = compile_decode_megakernel(cfg, B, 128 if full else S)
    base = _base_heap(plan, cfg, cuda)
    _ssm_vectors(plan, base)
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(base)
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    table = plan.descs.copy()
    table[table[:, 0] != code, 0] = 0
    plain = ex.heap.clone()
    reset_launch_count()
    megakernel(ex.heap, torch.from_numpy(table).to(cuda), plan.statics)
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, table, plan.statics)
    kind = OpKind.SSM_UPDATE if code == 12 else OpKind.CONV1D_UPDATE
    widths = set()
    for op in plan.compiled.graph.ops:
        if op.kind != kind:
            continue
        y, state = op.outputs
        torch.testing.assert_close(plan.view(ex.heap, y),
                                   plan.view(plain, y), rtol=2e-4,
                                   atol=2e-4)
        if code == 13:
            assert torch.equal(plan.view(ex.heap, state),
                               plan.view(plain, state)), state
        else:
            torch.testing.assert_close(plan.view(ex.heap, state),
                                       plan.view(plain, state), rtol=2e-4,
                                       atol=2e-4)
        widths.add(plan.layout[y].shape[-1])
    if full:
        assert widths == ({cfg.d_inner, cfg.ssm_state} if code == 13
                          else {cfg.d_inner})
        assert plan.statics["HD_SSM"] == 64 and plan.statics["N_SSM"] == 128
    assert read_stats_block(ex.heap, plan.stats_offset, 1) \
        == read_stats_block(plain, plan.stats_offset, 1)


@pytest.mark.gpu
def test_cuda_ssm_step_bitwise_across_workers_and_schedulers(cuda):
    """Two Mamba2 layers, one heap image: the static and the dynamic
    kernel at W ∈ {1, 2, 4, W_max} give bitwise-equal logits, conv windows
    and SSD states, within 2e-4 of the plain version (the windows' shifted
    rows bitwise); pools drained, 0 violations."""
    cfg = _ssm_cfg(2)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for w in (1, 2, 4, w_max):
        p = compile_decode_megakernel(cfg, B, S, num_workers=w)
        plans += [p, lower_tgraph(p.compiled, cfg, scheduler="dynamic")]
    base = _base_heap(max(plans, key=lambda p: p.heap_size), cfg, cuda)
    _ssm_vectors(plans[0], base)
    state = plans[0].input_classes()["state"]
    names = ["logits"] + state
    want = None
    for plan in plans:
        run, plain = _step_at(plan, cfg, base, cuda)
        got = {n: plan.view(run.heap, n).clone() for n in names}
        want = want or got
        for n in names:
            assert torch.equal(got[n], want[n]), (plan.num_workers, n)
        if plan.dynamic:
            _check_dynamic(run)
        else:
            assert all(c["event_wait_violations"] == 0
                       for c in run.worker_counters())
        if plan.num_workers == 1:
            megakernel_plain(plain, plan.descs, plan.statics,
                             plan.dyn.sched_table() if plan.dynamic
                             else None)
            for n in names:
                torch.testing.assert_close(plan.view(run.heap, n),
                                           plan.view(plain, n), rtol=2e-4,
                                           atol=2e-4)
            _check_conv_windows(plan, run.heap, plain)


def _check_conv_windows(plan, heap, plain):
    """The conv steps shifted their windows by pure copies: in each heap
    the new last row is that heap's projection row (``L.xp``, ``L.bp``,
    ``L.cp``) bitwise, and the rows before it are bitwise the plain
    version's."""
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CONV1D_UPDATE:
            continue
        src, win = op.inputs[0], op.outputs[1]
        for h in (heap, plain):
            assert torch.equal(plan.view(h, win)[:, -1],
                               plan.view(h, src)), win
        assert torch.equal(plan.view(heap, win)[:, :-1],
                           plan.view(plain, win)[:, :-1]), win


# ---------------------------------------------------------------------------
# Embedding inputs (the h0 input) and M-RoPE in kind 3.
# ---------------------------------------------------------------------------

#: distinct (t, h, w) positions, two patches of a 2-D image grid
GRID_POS = np.array([[2, 5, 9], [2, 11, 3]])


def _embed_cfg(arch, layers, full):
    cfg = get_config(arch)
    return dataclasses.replace(cfg if full else cfg.reduced(),
                               n_layers=layers)


def _embed_inputs(cfg, plan, cuda, seed=3):
    """A heap image with random weights, qkv biases and cache, and the
    step's (B, D) embeddings and positions: distinct (t, h, w) columns
    under M-RoPE, else the lengths."""
    base = _base_heap(plan, cfg, cuda, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    for name in plan.input_classes()["weights"]:
        if name.split(".")[-1] in ("bq", "bk", "bv"):
            plan.view(base, name).normal_(0.0, 0.1, generator=gen)
    x = np.random.default_rng(seed).standard_normal((B, cfg.d_model)) \
        .astype(np.float32)
    pos = GRID_POS if cfg.mrope_sections is not None else None
    return base, x, pos


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_cuda_embed_step_and_rope_match_plain_version(cuda, arch):
    """Two layers at full width (qwen2-vl: M-RoPE sections (16, 24, 24)
    of hd 128, 6 query heads per KV head, qkv bias; musicgen: 32 heads
    of 64, GELU), one step from an ``h0`` input: the logits within 2e-4
    of the plain version, ``h0`` and the cache-update copies bitwise.
    Then kind 3 alone (every other row a noop) on the step's q and k:
    the rotated rows within 2e-4 of the plain version's; under M-RoPE
    with distinct (t, h, w) positions, which text-mode positions do not
    reproduce."""
    cfg = _embed_cfg(arch, 2, full=True)
    plan = compile_decode_megakernel(cfg, B, S)
    assert plan.statics["MROPE"] == tuple(cfg.mrope_sections or ())
    base, x, pos = _embed_inputs(cfg, plan, cuda)
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(base)
    ex.write_step_inputs(x, [1, 12], pos)
    plain = ex.heap.clone()
    reset_launch_count()
    ex.launch()
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, plan.descs, plan.statics)
    torch.testing.assert_close(plan.view(ex.heap, "logits"),
                               plan.view(plain, "logits"), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(plan.view(ex.heap, "h0"),
                       torch.from_numpy(x).to(cuda))
    _check_cache_updates(plan, ex.heap, plain, [1, 12])
    assert all(c["event_wait_violations"] == 0
               for c in ex.worker_counters())

    table = plan.descs.copy()
    table[table[:, 0] != 3, 0] = 0
    outs = [f"L{i}.{t}r" for i in range(2) for t in "qk"]
    image = ex.heap.clone()             # the step's q and k in place
    got = {}
    for p in (pos, None) if pos is not None else (None,):
        ex.upload(image.clone())
        ex.write_step_inputs(x, [1, 12], p)
        plain = ex.heap.clone()
        megakernel(ex.heap, torch.from_numpy(table).to(cuda), plan.statics)
        torch.cuda.synchronize()
        megakernel_plain(plain, table, plan.statics)
        for n in outs:
            torch.testing.assert_close(plan.view(ex.heap, n),
                                       plan.view(plain, n), rtol=2e-4,
                                       atol=2e-4)
        got[p is None] = plan.view(ex.heap, outs[0]).clone()
    if pos is not None:                 # the sections read their columns
        assert not torch.equal(got[False], got[True])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_cuda_h0_step_bitwise_across_workers_and_schedulers(cuda, arch):
    """Two reduced layers, one heap image, an ``h0`` step (qwen2-vl with
    distinct (t, h, w) positions): the static and the dynamic kernel at
    W ∈ {1, 2, 4, W_max} give bitwise-equal logits and caches, within
    2e-4 of the plain version; pools drained, 0 violations."""
    cfg = _embed_cfg(arch, 2, full=False)
    w_max = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for w in (1, 2, 4, w_max):
        p = compile_decode_megakernel(cfg, B, S, num_workers=w)
        plans += [p, lower_tgraph(p.compiled, cfg, scheduler="dynamic")]
    base, x, pos = _embed_inputs(cfg, max(plans, key=lambda p: p.heap_size),
                                 cuda)
    names = ["logits"] + plans[0].input_classes()["state"]
    want = None
    for plan in plans:
        run = MegakernelExecutor(plan, cfg, cuda)
        run.upload(base.clone())
        run.write_step_inputs(x, [1, 12], pos)
        plain = run.heap.clone()
        run.launch()
        torch.cuda.synchronize()
        got = {n: plan.view(run.heap, n).clone() for n in names}
        want = want or got
        for n in names:
            assert torch.equal(got[n], want[n]), (plan.num_workers, n)
        if plan.dynamic:
            _check_dynamic(run)
        else:
            assert all(c["event_wait_violations"] == 0
                       for c in run.worker_counters())
        if plan.num_workers == 1:
            megakernel_plain(plain, plan.descs, plan.statics,
                             plan.dyn.sched_table() if plan.dynamic
                             else None)
            torch.testing.assert_close(plan.view(run.heap, "logits"),
                                       plan.view(plain, "logits"),
                                       rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Tensor parallelism over the fused transport: kinds 14-15.
# ---------------------------------------------------------------------------


def _tp_bindings(cfg, cuda, seed=3):
    """Random weights and a random cache as graph bindings on the card
    (one set for every TP degree)."""
    from repro_torch.core.lowering import decode_bindings
    from repro_torch.models.lm import init_cache, init_params
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = init_params(cfg, gen, device=cuda)
    cache = {k: torch.randn(v.shape, generator=gen, device=cuda)
             for k, v in init_cache(cfg, B, S, device=cuda).items()}
    return decode_bindings(cfg, params, cache, np.array([3, 7]),
                           np.array([1, 12]))


# ---------------------------------------------------------------------------
# gemma-7b: the tied head's 5,376-column matmul tiles (wider than one pass
# of the kernel's matmul, so run as passes over column ranges), heads of
# 256 in kinds 3 and 6, the (1 + w) norm, GeGLU and the sqrt(d) scale.
# ---------------------------------------------------------------------------


#: the reduced gemma's vocabulary, widened so that the head's tiles (4,224
#: columns) are wider than one pass (``test_torch_gemma.py``'s)
GEMMA_WIDE_VOCAB = 200_000


def _gemma_cfg(layers, full):
    cfg = get_config("gemma-7b")
    if full:
        return dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg.reduced(), n_layers=layers,
                               vocab=GEMMA_WIDE_VOCAB)


@pytest.mark.gpu
def test_cuda_gemma_wide_head_tiles_match_plain_version(cuda):
    """gemma-7b reduced (d = 128) with its vocabulary widened to 200,000:
    the head's tiles are 4,224 columns wide.  One step at W ∈ {1, 4} under
    both schedulers from one heap image: logits within 2e-4 of the plain
    version and bitwise equal across W and schedulers."""
    from repro_torch.megakernel.kernel import MM_PASS
    cfg = _gemma_cfg(1, False)
    plans = [compile_decode_megakernel(cfg, B, S, num_workers=w,
                                       scheduler=sched)
             for w in (1, 4) for sched in ("static", "dynamic")]
    mm = plans[0].descs[plans[0].descs[:, 0] == 1]
    assert mm[:, 2].max() == 4224 > MM_PASS
    base = _base_heap(max(plans, key=lambda p: p.heap_size), cfg, cuda)
    first = None
    for plan in plans:
        run, plain = _step_at(plan, cfg, base, cuda)
        megakernel_plain(plain, plan.descs, plan.statics,
                         plan.dyn.sched_table() if plan.dynamic else None)
        got = plan.view(run.heap, "logits")
        torch.testing.assert_close(got, plan.view(plain, "logits"),
                                   rtol=2e-4, atol=2e-4)
        if first is None:
            first = got.clone()
        assert torch.equal(got, first)
        assert all(c["event_wait_violations"] == 0
                   for c in run.worker_counters())


@pytest.mark.gpu
@pytest.mark.parametrize("code", [3, 6])
def test_cuda_gemma_hd256_kind_matches_plain_version(cuda, code):
    """gemma-7b at full width, one layer (16 MHA heads of 256, H * hd =
    4096 against d = 3072): one step, then kind 3 (rope) or kind 6
    (attention) alone, every other row a noop, on the step's heap: each
    output of the kind within 2e-4 of the plain version's."""
    from repro_torch.megakernel.desc import KIND_CODES
    cfg = _gemma_cfg(1, True)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=4)
    assert plan.statics["HD"] == 256
    run, _ = _step_at(plan, cfg, _base_heap(plan, cfg, cuda), cuda)
    table = plan.descs.copy()
    table[table[:, 0] != code, 0] = 0
    assert (table[:, 0] == code).any()
    outs = [op.outputs[0] for op in plan.compiled.graph.ops
            if KIND_CODES.get(op.kind) == code]
    plain = run.heap.clone()
    megakernel(run.heap, torch.from_numpy(table).to(cuda), plan.statics)
    torch.cuda.synchronize()
    megakernel_plain(plain, table, plan.statics)
    for n in outs:
        got = plan.view(run.heap, n)
        assert torch.isfinite(got).all() and got.abs().max() > 0
        torch.testing.assert_close(got, plan.view(plain, n), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
def test_cuda_comm_kinds_match_plain_version(cuda, tp):
    """Kinds 14 (ring send) and 15 (all-reduce chunk) alone at TP ∈ {2,
    4}, W = 2: on a heap where the plain version has run the whole step,
    the table with every other row a noop (its event words kept) runs on
    the card and in the plain version from the same image, counters
    zeroed.  Every collective's output, on every chip, the staging
    buffers and the arrival counters are bitwise the plain version's,
    the outputs bitwise equal across chips, the counter blocks equal, no
    violation."""
    cfg = _cfg(1)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=2, tp=tp)
    assert plan.n_chips == tp and plan.num_workers == 2 * tp
    ex = MegakernelExecutor(plan, cfg, cuda)
    ex.upload(plan.build_heap(_tp_bindings(cfg, cuda), cuda))
    toks, lens = np.array([3, 7]), np.array([1, 12])
    ex.write_step_inputs(toks, lens)
    megakernel_plain(ex.heap, plan.descs, plan.statics, acks=plan.acks)
    ex.write_step_inputs(toks, lens)      # zero the counters again
    table = plan.descs.copy()
    table[~np.isin(table[:, 0], (14, 15)), 0] = 0
    plain = ex.heap.clone()
    reset_launch_count()
    megakernel(ex.heap, torch.from_numpy(table).to(cuda), plan.statics,
               acks=ex._acks)
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, table, plan.statics, acks=plan.acks)
    outs = [n for n in plan.layout if n.endswith(("o_ar", "ffn_ar"))]
    assert len(outs) == 2
    for n in outs:
        for c in range(tp):
            got = plan.view(ex.heap, n, c)
            assert torch.equal(got, plan.view(plain, n, c)), (n, c)
            assert torch.equal(got, plan.view(ex.heap, n, 0)), (n, c)
    lo = plan.event_offset
    assert torch.equal(ex.heap[lo:plan.stats_offset],
                       plain[lo:plan.stats_offset])
    assert torch.equal(ex.heap[plan.ctl_offset:], plain[plan.ctl_offset:])
    counters = read_stats_block(ex.heap, plan.stats_offset, plan.num_workers)
    assert counters == read_stats_block(plain, plan.stats_offset,
                                        plan.num_workers)
    assert all(c["event_wait_violations"] == 0 for c in counters)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_cuda_tp_step_bitwise_across_tp_chips_and_workers(cuda, arch):
    """Two layers, TP ∈ {1, 2, 4} × W ∈ {1, 2}: logits bitwise equal
    across TP, W and chips, each within 2e-4 of its plain version, no
    violation, one launch a step; traced at TP = 2 with a clean event
    order."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    binds = _tp_bindings(cfg, cuda)
    want = None
    for tp in (1, 2, 4):
        for w in (1, 2):
            plan = compile_decode_megakernel(cfg, B, S, num_workers=w, tp=tp,
                                             trace=(tp, w) == (2, 2))
            ex = MegakernelExecutor(plan, cfg, cuda)
            ex.upload(plan.build_heap(binds, cuda))
            ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
            plain = ex.heap.clone()
            reset_launch_count()
            ex.launch()
            torch.cuda.synchronize()
            assert launch_count() == 1
            got = plan.view(ex.heap, "logits").clone()
            want = got if want is None else want
            assert torch.equal(got, want), (tp, w)
            for c in range(plan.n_chips):
                assert torch.equal(plan.view(ex.heap, "logits", c), got)
            assert all(c["event_wait_violations"] == 0
                       for c in ex.worker_counters())
            megakernel_plain(plain, plan.descs, plan.statics, acks=plan.acks)
            torch.testing.assert_close(got, plan.view(plain, "logits"),
                                       rtol=2e-4, atol=2e-4)
            if plan.trace:
                tl = decode_ring(plan, ex.task_ring())
                assert check_event_order(tl) == []
                assert {e.chip for e in tl.events} == {0, 1}


@pytest.mark.gpu
def test_cuda_tp2_chip_isolation(cuda):
    """The chip regions are disjoint on the card: scaling chip 1's wq by
    1 + 2^-10 moves both chips' logits away from the clean run (chip 1's
    owned ring chunks carry its compute to chip 0), and the ring still
    leaves the two chips bitwise equal."""
    cfg = _cfg(1)
    plan = compile_decode_megakernel(cfg, B, S, tp=2)
    ex = MegakernelExecutor(plan, cfg, cuda)
    heap = plan.build_heap(_tp_bindings(cfg, cuda), cuda)
    ex.upload(heap.clone())
    toks, lens = np.array([3, 7]), np.array([1, 12])
    clean = ex.step(toks, lens)
    plan.view(heap, "L0.wq", 1).mul_(1.0009765625)
    ex.upload(heap)
    ex.step(toks, lens)
    c0, c1 = (plan.view(ex.heap, "logits", c) for c in (0, 1))
    assert not torch.equal(c0, clean) and not torch.equal(c1, clean)
    assert torch.equal(c0, c1)


#: the standalone kernels' cases: every shape of tests/test_kernels.py
#: (flash attention at B=2, with its (bq, bk)), then deepseek-7b's full
#: width (the up-projection of a B=2, 128-token prefill chunk, its
#: rmsnorm, attention over the 4096-token context with 32 heads of 128)
#: and attention at gemma-7b's (16 heads of 256)
STANDALONE = [
    ("matmul", (128, 128, 128), {}), ("matmul", (256, 384, 128), {}),
    ("matmul", (128, 512, 256), {}), ("matmul", (384, 128, 384), {}),
    ("matmul", (256, 4096, 11008), {}),
    ("rmsnorm", (128, 256), {}), ("rmsnorm", (256, 512), {}),
    ("rmsnorm", (384, 128), {}), ("rmsnorm", (256, 4096), {}),
    ("flash_attention", (2, 128, 2, 64), {"bq": 64, "bk": 64}),
    ("flash_attention", (2, 256, 4, 64), {"bq": 128, "bk": 64}),
    ("flash_attention", (2, 128, 2, 128), {"bq": 64, "bk": 128}),
    ("flash_attention", (1, 128, 2, 64),
     {"bq": 64, "bk": 64, "causal": False}),
    ("flash_attention", (1, 4096, 32, 128), {}),
    ("flash_attention", (1, 4096, 32, 128), {"causal": False}),
    ("flash_attention", (1, 4096, 16, 256), {}),
]

#: (rtol, atol) of a kernel against its plain version, f32 then bf16.
#: f32: tests/test_kernels.py's.  bf16: both sides compute in f32 (in
#: other orders) and round once, so they differ by at most one bf16 ulp,
#: 2^-7 of the value at most: rtol 8e-3, with an atol for outputs near
#: zero.  The reference's bf16 3e-2 is about the size of a typical
#: flash-attention output at S = 4096 and would hold nothing there.
STANDALONE_TOL = {"matmul": ((1e-4, 1e-4), (8e-3, 1e-3)),
                  "rmsnorm": ((1e-5, 1e-5), (8e-3, 1e-3)),
                  "flash_attention": ((2e-5, 2e-5), (8e-3, 1e-4))}


def _assert_standalone_close(name, got, want):
    """``got`` within STANDALONE_TOL of ``want``; in bf16 also at most 1 %
    (and one) of the outputs' bits differ, since a one-ulp fault (a
    truncating store, a drift in a load) moves about half of them while
    another f32 summation order moves only those near a rounding
    boundary."""
    bf16 = got.dtype == torch.bfloat16
    rtol, atol = STANDALONE_TOL[name][bf16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if bf16:
        assert int((got != want).sum()) <= 1 + got.numel() // 100


def _standalone_inputs(name, dims, dtype, seed=0):
    """f32 normals drawn on the card (the matmul's weight scaled by
    1/sqrt(K), as a model's), cast to ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    if name == "matmul":
        m, k, n = dims
        xs = rnd(m, k), rnd(k, n) / k ** 0.5
    elif name == "rmsnorm":
        xs = rnd(*dims), rnd(dims[1])
    else:
        xs = rnd(*dims), rnd(*dims), rnd(*dims)
    return tuple(x.to(dtype) for x in xs)


def _standalone_launches(name, dims, dtype):
    """CUDA kernels one call launches: 1, or 2 for an f32 matmul whose K
    is split (the GEMM, then the sum of its partial tiles)."""
    if name != "matmul" or dtype != torch.float32:
        return 1
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.matmul import plan
    m, k, n = dims
    return 1 if plan(m, n, k, 0, sm_count(torch.device("cuda")))[1] == 1 \
        else 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,dims,kw", STANDALONE)
def test_cuda_standalone_kernel_matches_plain_version(cuda, name, dims, kw,
                                                      dtype):
    """One call of the kernel, each CUDA kernel it launches counted once,
    within STANDALONE_TOL of the plain version on the same inputs, in the
    input's type and shape."""
    from repro_torch import kernels as sk
    xs = _standalone_inputs(name, dims, dtype)
    sk.reset_launch_counts()
    got = getattr(sk, name)(*xs, **kw)
    torch.cuda.synchronize()
    assert sk.launch_counts()[name] == _standalone_launches(name, dims, dtype)
    want = getattr(sk, name + "_plain")(*xs, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    _assert_standalone_close(name, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,dims,kw", [
    ("matmul", (100, 60, 72), {}), ("matmul", (1, 4096, 3), {}),
    ("matmul", (130, 17, 257), {"bm": 130, "bn": 257}),
    ("rmsnorm", (96, 40), {}), ("rmsnorm", (3, 4097), {}),
    ("flash_attention", (1, 96, 2, 64), {}),
    ("flash_attention", (2, 100, 3, 128), {"causal": False}),
    ("flash_attention", (1, 1, 1, 64), {}),
])
def test_cuda_standalone_kernel_ragged_shapes(cuda, name, dims, kw, dtype):
    """Shapes that are no multiple of the kernels' own tiles (the API's
    blocks clamp to them): the masked edges of every tile agree with the
    plain version within STANDALONE_TOL."""
    from repro_torch import kernels as sk
    xs = _standalone_inputs(name, dims, dtype, seed=1)
    got = getattr(sk, name)(*xs, **kw)
    want = getattr(sk, name + "_plain")(*xs, **kw)
    assert torch.isfinite(got.float()).all()
    _assert_standalone_close(name, got, want)


def _rmsnorm_layout(layout, rows, d, dtype):
    """x (rows, d) and w (d,) of ``dtype`` laid out as ``layout`` says:
    "contiguous", "strided" (every other column of a wider tensor),
    "unaligned" (starting one element past a 16-byte boundary) or
    "row_pad" (rows one element longer than d: a row stride that is no
    whole number of 16-byte vectors)."""
    x, w = _standalone_inputs("rmsnorm", (rows, 2 * d + 1), dtype, seed=2)
    w = w[:d]
    if layout == "strided":
        return x[:, :2 * d:2], w
    if layout == "unaligned":
        return x.reshape(-1)[1:1 + rows * d].view(rows, d), w
    if layout == "row_pad":
        return x.reshape(-1)[:rows * (d + 1)].view(rows, d + 1)[:, :d], w
    return x[:, :d].contiguous(), w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,rows,d", [
    ("contiguous", 384, 128),     # vector kernel, several rows a CTA
    ("contiguous", 256, 512),     # vector kernel, a warp a row
    ("contiguous", 256, 4096),    # vector kernel, 8 warps a row
    ("contiguous", 8, 40000),     # vector kernel, the row read again
    ("strided", 256, 512),        # scalar kernel: a non-unit stride
    ("unaligned", 256, 512),      # scalar kernel: off a 16-byte boundary
    ("row_pad", 64, 512),         # scalar kernel: row stride not vectors
    ("contiguous", 64, 4097),     # scalar kernel: width not vectors
])
def test_cuda_rmsnorm_vector_and_scalar_paths(cuda, layout, rows, d, dtype):
    """Each of rmsnorm's paths within STANDALONE_TOL of the plain version
    (bf16: at most 1 % of the bits differ), one launch a call, and a
    second call on the same shape (the settled launch path) bitwise the
    first."""
    from repro_torch import kernels as sk
    x, w = _rmsnorm_layout(layout, rows, d, dtype)
    sk.reset_launch_counts()
    got = sk.rmsnorm(x, w)
    again = sk.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert sk.launch_counts()["rmsnorm"] == 2
    assert got.shape == (rows, d) and got.is_contiguous()
    assert torch.equal(got, again)
    _assert_standalone_close("rmsnorm", got, sk.rmsnorm_plain(x, w))


@pytest.mark.gpu
def test_cuda_standalone_kernels_read_strides(cuda):
    """The kernels read their inputs through strides: a transposed B, a
    row-strided x and q, k, v as (B, H, S, hd) tensors seen as (B, S, H,
    hd) give what the contiguous copies give, bitwise."""
    from repro_torch import kernels as sk
    a, b = _standalone_inputs("matmul", (256, 384, 128), torch.float32)
    bt = b.T.contiguous().T
    assert not bt.is_contiguous()
    assert torch.equal(sk.matmul(a, bt), sk.matmul(a, b))
    x, w = _standalone_inputs("rmsnorm", (128, 512), torch.bfloat16)
    assert torch.equal(sk.rmsnorm(x[:, :256], w[:256]),
                       sk.rmsnorm(x[:, :256].contiguous(), w[:256]))
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _standalone_inputs("flash_attention", (2, 256, 4, 64),
                                  torch.float32))
    assert not q.is_contiguous()
    assert torch.equal(sk.flash_attention(q, k, v),
                       sk.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous()))


@pytest.mark.gpu
def test_cuda_standalone_limits_raise_before_launch(cuda):
    """Bad shapes raise ValueError, an unsupported element type
    NotImplementedError, inputs on two devices ValueError; none of them
    launches a kernel (a head wider than 256 runs: the flash test of every
    head width)."""
    from repro_torch import kernels as sk
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                     device="cuda")
    sk.reset_launch_counts()
    for bad in [lambda: sk.matmul(z(192, 64), z(64, 128)),
                lambda: sk.matmul(z(128, 64), z(32, 128)),
                lambda: sk.rmsnorm(z(192, 64), z(64)),
                lambda: sk.flash_attention(*[z(1, 192, 2, 64)] * 3),
                lambda: sk.rmsnorm(z(128, 64), torch.zeros(64))]:
        with pytest.raises(ValueError):
            bad()
    for bad in [lambda: sk.matmul(z(128, 64, dt=torch.float16),
                                  z(64, 128, dt=torch.float16)),
                lambda: sk.rmsnorm(z(128, 64), z(64, dt=torch.bfloat16))]:
        with pytest.raises(NotImplementedError):
            bad()
    torch.cuda.synchronize()
    assert not any(sk.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 33, 64, 96, 128, 256, 320, 512])
def test_cuda_flash_attention_every_head_width(cuda, hd, causal, dtype):
    """Every head width up to 256 runs in the smallest build that holds
    it (64, 128 or 256 columns, the rest read as zero), a wider one in
    the wide kernel (256-column output slices), within STANDALONE_TOL of
    the plain version, at S = 200 (no multiple of the kernels' tiles);
    hd = 33 rows are no multiple of 16 bytes, so the wrapper copies them
    first."""
    from repro_torch import kernels as sk
    xs = _standalone_inputs("flash_attention", (2, 200, 3, hd), dtype,
                            seed=hd)
    kw = {"bq": 200, "bk": 200, "causal": causal}
    sk.reset_launch_counts()
    got = sk.flash_attention(*xs, **kw)
    torch.cuda.synchronize()
    assert sk.launch_counts()["flash_attention"] == 1
    want = sk.flash_attention_plain(*xs, **kw)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    _assert_standalone_close("flash_attention", got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,dims,kw", [
    ("matmul", (256, 4096, 11008), {}), ("matmul", (1, 4096, 3), {}),
    ("rmsnorm", (256, 4096), {}),
    ("flash_attention", (1, 4096, 32, 128), {}),
    ("flash_attention", (1, 1024, 8, 256), {"causal": False}),
])
def test_cuda_standalone_repeated_launches_bitwise(cuda, name, dims, kw,
                                                   dtype):
    """Two launches on the same inputs agree bit for bit: no atomics, the
    f32 matmul's split-K partial tiles summed in a fixed order."""
    from repro_torch import kernels as sk
    xs = _standalone_inputs(name, dims, dtype, seed=2)
    first = getattr(sk, name)(*xs, **kw)
    assert torch.equal(getattr(sk, name)(*xs, **kw), first)
