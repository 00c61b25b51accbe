"""The port's dynamic scheduler against the reference's: the lowering
(flat table, heap image, scheduler table, queue image), the protocol's
sequential replay and ``mpk_dyn`` simulation, the plain version's heap
after one step against the Pallas megakernel in interpret mode (every
integer word of the tail bitwise, logits within 2e-4), the plain version
against the static scheduler and across W, serving through
``Program(scheduler="dynamic")`` and the decoded dynamic trace ring.
The CUDA kernel's dynamic branch is ``test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

import mpk
from repro.configs import get_config
from repro.core.compile import CompileOptions as RefOptions
from repro.core.compile import megakernelize as ref_megakernelize
from repro.core.lowering import build_decode_graph as ref_build_graph
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.core.runtime_sim import SimConfig as RefSimConfig
from repro.core.runtime_sim import predicted_timeline as ref_timeline
from repro.core.runtime_sim import simulate as ref_simulate
from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.obs import decode_ring as ref_decode_ring
from repro.obs import sequential_trace as ref_sequential_trace
from repro.runtime import Request as RefRequest
from repro.runtime import ServingEngine as RefEngine
from repro.runtime.dyn_sched import build_dyn_sched as ref_build_dyn
from repro.runtime.dyn_sched import replay_sequential as ref_replay
from repro_torch.api import compile as torch_compile
from repro_torch.core.compile import CompileOptions, megakernelize
from repro_torch.core.lowering import build_decode_graph, decode_bindings
from repro_torch.core.runtime_sim import (SimConfig, predicted_timeline,
                                          simulate)
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel, lower_tgraph)
from repro_torch.megakernel.desc import CTL_WORDS
from repro_torch.megakernel.kernel import megakernel_plain
from repro_torch.models import params_from_jax
from repro_torch.obs import check_event_order, decode_ring, sequential_trace
from repro_torch.runtime import Request, ServingEngine
from repro_torch.runtime.dyn_sched import (QUEUE_CAP, build_dyn_sched,
                                           replay_sequential)

B, S = 2, 16
TOKS = np.array([3, 7], np.int32)
LENS = np.array([1, 4], np.int32)
DYN_STATICS = ("W", "NUM_STEPS", "EVENT_OFF", "N_EVENTS", "STATS_OFF",
               "DYN", "QOFF", "QCAP", "OV_ROWS", "QC_OFF", "TRACE_OFF",
               "T_TASKS", "MAX_OUT", "TRACE", "TR_OFF")


def _cfg(layers, arch="deepseek-7b"):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=layers)


def _params(cfg, seed=5):
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jp)


def _bindings(cfg, np_tree):
    """The same inputs as reference and port bindings (a random cache, so
    that attention reads more than zeros)."""
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    ref = ref_decode_bindings(cfg, np_tree, jcache, TOKS, LENS)
    tcache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(np_tree, cfg, device="cpu"),
                           tcache, TOKS, LENS)
    return ref, port


def _compiled_pair(cfg, workers):
    """The same decode graph compiled by the reference and the port."""
    ref = ref_megakernelize(ref_build_graph(cfg, B, S),
                            RefOptions(num_workers=workers))
    port = megakernelize(build_decode_graph(cfg, B, S),
                         CompileOptions(num_workers=workers))
    return ref, port


# ---------------------------------------------------------------------------
# The lowering.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("arch,layers", [("deepseek-7b", 2),
                                         ("gemma-7b", 1)])
def test_dynamic_lowering_matches_reference(arch, layers, workers, trace):
    """The same config and W → the same flat table (int32 → int64), the
    same scheduler table and queue image, the same tail layout, and a
    heap image equal to the reference's word for word, followed by the
    port's control words."""
    cfg = _cfg(layers, arch)
    ref = ref_compile(cfg, B, S, num_workers=workers, scheduler="dynamic",
                      trace=trace)
    port = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                     scheduler="dynamic", trace=trace)
    assert port.scheduler == "dynamic" and port.dynamic
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert np.array_equal(port.dyn.sched_table(), ref.dyn.sched_table())
    for a, b in zip(port.dyn.queue_image(), ref.dyn.queue_image()):
        assert np.array_equal(a, b)
    for attr in ("num_workers", "num_steps", "stats_offset", "event_offset",
                 "num_events", "queue_offset", "qc_offset", "trace_offset",
                 "trace", "ring_offset"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for k in DYN_STATICS:
        assert port.statics.get(k) == ref.statics.get(k), k
    assert port.ctl_offset == ref.heap_size
    assert port.heap_size == ref.heap_size + CTL_WORDS
    rb, pb = _bindings(cfg, _params(cfg))
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap[:ref.heap_size].view(np.int32),
                          ref_heap.view(np.int32))
    assert not port_heap[ref.heap_size:].any()


def test_dynamic_and_static_share_the_compiled_graph():
    """Both schedulers lower from one compiled graph: the same tensor
    layout, and the dynamic table is the static grid's tasks in
    linearized order."""
    cfg = _cfg(1)
    static = compile_decode_megakernel(cfg, B, S, num_workers=2)
    dyn = lower_tgraph(static.compiled, cfg, scheduler="dynamic")
    assert all((dyn.layout[n].offset, dyn.layout[n].ld)
               == (static.layout[n].offset, static.layout[n].ld)
               for n in static.layout)
    assert dyn.event_offset == static.event_offset
    part = static.compiled.partition
    for pos, tid in enumerate(static.compiled.order):
        row = part.step_of[tid] * 2 + part.worker_of[tid]
        assert np.array_equal(dyn.descs[pos, :24], static.descs[row, :24])
        assert dyn.descs[pos, 35] == part.worker_of[tid]
    with pytest.raises(ValueError, match="scheduler"):
        lower_tgraph(static.compiled, cfg, scheduler="magic")


# ---------------------------------------------------------------------------
# The protocol: replay and simulation.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_replay_and_simulation_match_reference(workers):
    """``build_dyn_sched``, ``replay_sequential``, the ``mpk_dyn``
    makespan and its predicted timeline equal the reference's on the same
    graph; at W = 1 the replay is the linearized order."""
    ref_c, port_c = _compiled_pair(_cfg(2), workers)
    ref_plan, plan = ref_build_dyn(ref_c), build_dyn_sched(port_c)
    assert plan.initial == ref_plan.initial
    assert plan.consumers == ref_plan.consumers
    ref_tr, tr = ref_replay(ref_plan), replay_sequential(plan)
    assert dataclasses.asdict(tr) == dataclasses.asdict(ref_tr)
    assert sorted(tr.order) == list(range(plan.num_tasks))
    if workers == 1:
        assert tr.order == list(range(plan.num_tasks))
    for mode in ("mpk", "mpk_dyn"):
        got = simulate(port_c, SimConfig(mode=mode, n_workers=workers))
        want = ref_simulate(ref_c, RefSimConfig(mode=mode,
                                                n_workers=workers))
        assert got.makespan == want.makespan, mode
        assert got.worker_busy == want.worker_busy, mode
    got = predicted_timeline(port_c, SimConfig(mode="mpk_dyn",
                                               n_workers=workers))
    want = ref_timeline(ref_c, RefSimConfig(mode="mpk_dyn",
                                            n_workers=workers))
    assert got == want


def test_mpk_dyn_reduces_to_the_static_replay_at_w1():
    _, port_c = _compiled_pair(_cfg(1), 1)
    st = simulate(port_c, SimConfig(mode="mpk", n_workers=1))
    dy = simulate(port_c, SimConfig(mode="mpk_dyn", n_workers=1))
    assert dy.makespan == pytest.approx(st.makespan, rel=1e-12)
    with pytest.raises(NotImplementedError):
        simulate(port_c, SimConfig(mode="mpk_tp", tp=2))


# ---------------------------------------------------------------------------
# The plain version against the Pallas megakernel in interpret mode.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step():
    """One traced step per W ∈ {1, 2, 4} of the reference's Pallas
    megakernel (interpret mode) and of the port's plain version, from the
    same inputs: (reference executor, its outputs, port executor, its
    outputs) per W."""
    cfg = _cfg(1)
    rb, pb = _bindings(cfg, _params(cfg))
    out = {}
    for W in (1, 2, 4):
        ref = RefExecutor(ref_compile(cfg, B, S, num_workers=W,
                                      scheduler="dynamic", trace=True), cfg)
        ref_out = ref.run_once(rb)
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W,
                                         scheduler="dynamic", trace=True)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        out[W] = (ref, ref_out, ex, ex.run_once(pb))
    return out


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_heap_matches_pallas_interpret(one_step, workers):
    """After one step every word of the heap tail (event counters, pools,
    cursors, pop trace, counter blocks 0-11, the ring) is bitwise the
    reference's, and every output is within 2e-4."""
    ref, ref_out, ex, out = one_step[workers]
    plan = ex.plan
    ref_heap = np.asarray(ref._heap)
    heap = ex.heap.numpy()
    lo, hi = plan.event_offset, ref.plan.heap_size
    assert np.array_equal(heap[lo:hi].view(np.int32),
                          ref_heap[lo:hi].view(np.int32))
    assert heap[plan.ctl_offset] == plan.dyn.num_tasks      # ticket
    assert set(out) == set(ref_out)
    for name in ref_out:
        np.testing.assert_allclose(out[name].numpy(), ref_out[name],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert ex.worker_counters() == ref.worker_counters()
    assert ex.scheduler_counters() == ref.scheduler_counters()


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_pop_trace_is_the_replay(one_step, workers):
    """The pop trace is ``replay_sequential``'s order, idle past T; every
    pool drains and the pops add up to T."""
    _, _, ex, _ = one_step[workers]
    plan = ex.plan
    tr = replay_sequential(plan.dyn)
    slots = plan.num_steps * plan.num_workers
    T = plan.dyn.num_tasks
    assert np.array_equal(ex.pop_trace(),
                          np.array(tr.order + [-1] * (slots - T)))
    qc = ex.scheduler_counters()
    assert qc["queue_pushed"] == qc["queue_popped"]
    assert sum(qc["queue_popped"]) == T
    assert qc["pops_own"] + qc["pops_overflow"] + qc["steals"] == T
    assert (qc["pops_own"], qc["steals"]) == (tr.pops_own, tr.steals)
    assert qc["idle_slots"] == slots - T
    counters = ex.worker_counters()
    assert all(c["event_wait_violations"] == 0 for c in counters)
    assert sum(c["event_waits"] for c in counters) \
        == int((plan.descs[:, 32] >= 0).sum())


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_dynamic_ring_decodes_like_the_reference(one_step, workers):
    """``decode_ring`` of the plain version's dynamic ring equals the
    reference's decode of its own ring; the event order is clean and the
    sequential trace of the replay equals the reference's."""
    ref, _, ex, _ = one_step[workers]
    got = decode_ring(ex.plan, ex.task_ring())
    want = ref_decode_ring(ref.plan, ref.task_ring())
    assert got.scheduler == want.scheduler == "dynamic"
    assert len(got.events) == len(want.events) == ex.plan.dyn.num_tasks
    fields = ("task", "row", "worker", "kind", "start", "end", "source",
              "wait_cnt", "wait_ev", "sig_ev")
    for a, b in zip(got.events, want.events):
        assert [getattr(a, f) for f in fields] \
            == [getattr(b, f) for f in fields]
    assert check_event_order(got) == []
    seq = replay_sequential(ex.plan.dyn)
    mine = sequential_trace(ex.plan.compiled, "dynamic", seq)
    theirs = ref_sequential_trace(ref.plan.compiled, "dynamic",
                                  ref_replay(ref.plan.dyn))
    assert [(e.task, e.worker, e.source, e.start) for e in mine.events] \
        == [(e.task, e.worker, e.source, e.start) for e in theirs.events]


# ---------------------------------------------------------------------------
# The plain version against the static scheduler and across W.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layers", [("deepseek-7b", 2),
                                         ("gemma-7b", 1)])
def test_plain_dynamic_bitwise_equal_static_and_across_w(arch, layers):
    """One step from one heap image: the dynamic plain version's outputs
    are bitwise the static plain version's, at every W."""
    cfg = _cfg(layers, arch)
    _, pb = _bindings(cfg, _params(cfg))
    base = MegakernelExecutor(compile_decode_megakernel(cfg, B, S), cfg,
                              device="cpu").run_once(pb)
    for W in (1, 2, 4):
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W,
                                         scheduler="dynamic")
        got = MegakernelExecutor(plan, cfg, device="cpu").run_once(pb)
        assert set(got) == set(base)
        for name in base:
            assert torch.equal(got[name], base[name]), (W, name)


def test_executor_rewrites_the_queue_image_between_steps():
    """Two consecutive steps both pop every task from the initial image:
    the second finds pools, cursors, counters and ticket reset."""
    cfg = _cfg(1)
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         num_workers=4, scheduler="dynamic")
    prog.bind(params_from_jax(_params(cfg), cfg, device="cpu")).init_state()
    T = prog.plan.dyn.num_tasks
    lens, toks = np.array([0, 2], np.int32), np.array([5, 9], np.int32)
    traces = []
    for _ in range(2):
        assert np.isfinite(prog.step(toks, lens)).all()
        ws = prog.worker_stats
        assert ws["scheduler"] == "dynamic"
        assert ws["event_wait_violations"] == 0
        assert sum(ws["kernel_queue_popped"]) == T
        assert ws["kernel_queue_pushed"] == ws["kernel_queue_popped"]
        assert prog.executor.heap[prog.plan.ctl_offset] == T
        traces.append(prog.executor.pop_trace())
        lens += 1
    assert np.array_equal(traces[0], traces[1])


def test_worker_stats_match_reference():
    """The dynamic scheduler's plan-side numbers in ``worker_stats``
    equal the reference Program's."""
    cfg = _cfg(1)
    jp = _params(cfg)
    ref = mpk.compile(cfg, B, S, backend="megakernel", num_workers=2,
                      scheduler="dynamic")
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         num_workers=2, scheduler="dynamic")
    prog.bind(params_from_jax(jp, cfg, device="cpu"))
    got, want = prog.worker_stats, ref.worker_stats
    for k in ("scheduler", "num_workers", "dyn_sim_makespan_us",
              "queue_max_depth", "replay_pops_own", "replay_pops_overflow",
              "replay_steals"):
        assert got[k] == want[k], k


def test_scheduler_argument_validation():
    cfg = _cfg(1)
    with pytest.raises(ValueError, match="scheduler"):
        torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                      scheduler="magic")
    with pytest.raises(ValueError, match="scheduler"):
        megakernelize(build_decode_graph(cfg, B, S),
                      CompileOptions(scheduler="magic"))


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def test_engine_streams_dynamic_match_static_and_jax():
    """The ``ServingEngine`` on ``Program(scheduler="dynamic")`` gives the
    same greedy streams as on the static Program and as the reference
    engine on the JAX Program."""
    cfg = get_config("deepseek-7b").reduced()
    jp = jax_init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in (5, 9, 3)]

    ref_eng = RefEngine(mpk.compile(cfg, 2, 32, backend="jax").bind(jp),
                        chunk=8)
    for i, p in enumerate(prompts):
        ref_eng.submit(RefRequest(i, p, max_new_tokens=4))
    want = {r.request_id: r.output for r in ref_eng.run()}

    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    streams = {}
    for scheduler in ("static", "dynamic"):
        prog = torch_compile(cfg, 2, 32, backend="megakernel", device="cpu",
                             num_workers=2, scheduler=scheduler)
        prog.bind(params)
        eng = ServingEngine(prog, chunk=8)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=4))
        streams[scheduler] = {r.request_id: r.output for r in eng.run()}
        assert eng.decode_iterations > 0
        assert prog.worker_stats["event_wait_violations"] == 0
    assert streams["dynamic"] == streams["static"] == want


def test_overflow_queue_takes_a_full_pool():
    """A fan-out of 299 consumers into one pool: the plain version pushes
    128 into it and spills the rest into the overflow queue, and its pop
    trace is ``replay_sequential``'s, overflow pops and steals included."""
    from test_torch_gpu import fanout_heap, fanout_plan
    dyn, descs, statics, size = fanout_plan(300, 4)
    heap = fanout_heap(dyn, statics, size, "cpu")
    megakernel_plain(heap, descs, statics, dyn.sched_table())
    tr = replay_sequential(dyn)
    assert tr.pops_overflow > 0 and tr.steals > 0
    t0 = statics["TRACE_OFF"]
    assert heap[t0:t0 + 300].long().tolist() == tr.order
    c0, W = statics["QC_OFF"], 4
    qc = heap[c0:c0 + 2 * (W + 1)].long().tolist()
    assert qc[0::2] == qc[1::2] and sum(qc[1::2]) == 300
    assert qc[2 * W] == 300 - 1 - QUEUE_CAP
    off = statics["STATS_OFF"]
    stats = heap[off:off + W * 12].reshape(W, 12)[:, 8:11].sum(0)
    assert stats.long().tolist() == [tr.pops_own, tr.pops_overflow,
                                     tr.steals]
