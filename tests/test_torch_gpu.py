"""On the card: the hand-written CUDA megakernel against its plain PyTorch
version, at the reduced size (deepseek-7b reduced: GQA with 4 query heads
over 2 KV heads; granite-moe reduced; mamba2 reduced, and mamba2's kinds
12-13 at full width), under the static and the dynamic scheduler.  Every test
here is marked ``gpu`` and skips without a CUDA device; the file imports
no JAX, so it runs where JAX is absent:

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
    """A fan-out of 299 consumers into one pool: 128 fill it, the rest
    spill into the overflow queue, and the four workers drain both."""
    dyn, descs, statics, size = fanout_plan(300, 4)
    heap = fanout_heap(dyn, statics, size, cuda)
    megakernel(heap, torch.from_numpy(descs).to(cuda), statics,
               torch.from_numpy(dyn.sched_table()).to(cuda))
    torch.cuda.synchronize()
    c0, W = statics["QC_OFF"], 4
    qc = heap[c0:c0 + 2 * (W + 1)].cpu().numpy()
    assert (qc[0::2] == qc[1::2]).all() and qc[1::2].sum() == 300
    assert qc[2 * W] == 300 - 1 - 128            # the spill
    stats = read_stats_block(heap, statics["STATS_OFF"], W)
    assert sum(c["pops_overflow"] for c in stats) == 171
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
