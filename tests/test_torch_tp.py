"""Tensor parallelism in the port against the reference, no card: the
ring planner (``distributed/comm_tasks``), the ALLREDUCE insertion of the
lowering, the stamped multichip descriptor table (``stamp_multichip``,
compared word for word with the reference's, cast to int64), its
port-only send guards, the ``mpk_tp`` simulator and the API's refusals.
Deepseek-7b and granite-moe-1b-a400m reduced to one layer, B=2, S=16.
Everything here is exact: integer tables and float makespans compare
with ``==``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import torch  # noqa: E402

from repro.configs import get_config
from repro.core.compile import CompileOptions as RefOptions
from repro.core.compile import megakernelize as ref_megakernelize
from repro.core.lowering import build_decode_graph as ref_build_graph
from repro.core.runtime_sim import SimConfig as RefSimConfig
from repro.core.runtime_sim import simulate as ref_simulate
from repro.distributed import comm_tasks as ref_ct
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro_torch.api import compile as torch_compile
from repro_torch.core.compile import CompileOptions, megakernelize
from repro_torch.core.decompose import DecomposeConfig
from repro_torch.core.lowering import build_decode_graph
from repro_torch.core.runtime_sim import SimConfig, simulate
from repro_torch.distributed import comm_tasks as ct
from repro_torch.megakernel import compile_decode_megakernel
from repro_torch.megakernel.desc import (AR_CHUNK_CODE, REMOTE_COPY_CODE,
                                         lower_tgraph, stamp_multichip)
from repro_torch.megakernel.kernel import megakernel

B, S = 2, 16
ARCHS = ("deepseek-7b", "granite-moe-1b-a400m")


def _cfg(arch="deepseek-7b", layers=1):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=layers)


# ---------------------------------------------------------------------------
# The ring planner.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chips", [1, 2, 3, 4, 8])
def test_ring_plan_equals_reference(n_chips):
    """The same task list, step counts, event counts, chunks, rounds and
    costs as the reference's planner."""
    for span in (7, 1001, 4096):
        got = [dataclasses.astuple(t)
               for t in ct.expand_ring_allreduce(span, n_chips)]
        want = [dataclasses.astuple(t)
                for t in ref_ct.expand_ring_allreduce(span, n_chips)]
        assert got == want, span
        assert ct.ring_chunks(span, n_chips) == \
            ref_ct.ring_chunks(span, n_chips)
        assert ct.send_rounds(span, n_chips) == \
            ref_ct.send_rounds(span, n_chips)
        assert ct.ring_duration(span, n_chips) == \
            ref_ct.ring_duration(span, n_chips)
        assert ct.serialized_duration(span, n_chips) == \
            ref_ct.serialized_duration(span, n_chips)
    assert ct.n_ring_steps(n_chips) == ref_ct.n_ring_steps(n_chips)
    assert ct.n_comm_events(n_chips) == ref_ct.n_comm_events(n_chips)
    assert (ct.MODE_INIT, ct.MODE_ACC, ct.MODE_STORE) == \
        (ref_ct.MODE_INIT, ref_ct.MODE_ACC, ref_ct.MODE_STORE)


@pytest.mark.parametrize("n_chips", [1, 2, 4, 5])
def test_ref_ring_allreduce_exact(n_chips):
    """The numpy protocol oracle equals the reference's bitwise:
    replicated inputs come out unchanged, distinct ones resolve to each
    chunk's owner."""
    rng = np.random.default_rng(n_chips)
    for span in (7, 64, 4096):
        x = rng.standard_normal(span).astype(np.float32)
        for shards in ([x.copy() for _ in range(n_chips)],
                       [rng.standard_normal(span).astype(np.float32)
                        for _ in range(n_chips)]):
            got = ct.ref_ring_allreduce(shards)
            want = ref_ct.ref_ring_allreduce(shards)
            for g, w in zip(got, want):
                assert np.array_equal(g.view(np.int32), w.view(np.int32))
        for o in ct.ref_ring_allreduce([x.copy() for _ in range(n_chips)]):
            assert np.array_equal(o, x)


# ---------------------------------------------------------------------------
# The lowering and the stamped table.
# ---------------------------------------------------------------------------


def _ops(g):
    return [(o.kind, o.inputs, o.outputs, sorted(o.attrs.items(), key=str))
            for o in g.ops]


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-2.7b",))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_graph_matches_reference(arch, tp):
    """ALLREDUCE after every attention or SSM output projection and every
    FFN or MoE output, node for node the reference's graph, and the
    compiler's statistics of it equal."""
    cfg = get_config(arch).reduced()
    g, rg = build_decode_graph(cfg, B, S, tp=tp), \
        ref_build_graph(cfg, B, S, tp=tp)
    assert _ops(g) == _ops(rg)
    assert list(g.tensors) == list(rg.tensors)
    n_ar = sum(o.kind == "allreduce" for o in g.ops)
    assert n_ar == cfg.n_layers * (1 if arch.startswith("mamba") else 2)
    opts = dict(num_workers=2)
    got = megakernelize(g, CompileOptions(**opts)).stats
    want = ref_megakernelize(rg, RefOptions(**opts)).stats
    assert {k: v for k, v in got.items() if k in want} == want


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_stamped_table_matches_reference(arch, tp, workers, trace):
    """``compile(..., backend="megakernel", tp=C)`` lowers to the
    reference's stamped table cast to int64, with its chip stride, event
    table, staging, counter blocks and ring, and the heap the reference's
    up to the port-only arrival counters (two per collective and chip)."""
    cfg = _cfg(arch)
    ref = ref_compile(cfg, B, S, num_workers=workers, tp=tp, trace=trace)
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         num_workers=workers, tp=tp, trace=trace)
    port = prog.plan
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    for attr in ("n_chips", "chip_stride", "event_offset", "num_events",
                 "stats_offset", "num_workers", "num_steps", "ring_offset"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for k, v in ref.statics.items():
        if k != "MROPE":
            assert port.statics[k] == v, k
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    n_coll = int(((port.descs[:, 0] == AR_CHUNK_CODE)
                  & (port.descs[:, 14] == 0)).sum()) // tp
    assert n_coll == 2
    assert port.ctl_offset == ref.heap_size
    assert port.ctl_words == 2 * tp * n_coll
    assert port.statics["KINDS"][-2:] == (REMOTE_COPY_CODE, AR_CHUNK_CODE)


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_send_guards(tp):
    """The port-only side table: every arrival (an accumulate or store)
    adds to the counter of its (collective, chip, phase), and a send of
    round r >= 1 waits for r arrivals on its receiver's counter of that
    phase; nothing else is guarded."""
    cfg = _cfg()
    plan = compile_decode_megakernel(cfg, B, S, tp=tp)
    d, acks = plan.descs, plan.acks
    assert acks.shape == (d.shape[0], 2)
    recv = (d[:, 0] == AR_CHUNK_CODE) & (d[:, 14] > 0)
    send = d[:, 0] == REMOTE_COPY_CODE
    guarded = acks[:, 0] >= 0
    assert (guarded <= (recv | send)).all()
    assert guarded[recv].all() and (acks[recv, 1] == 0).all()
    lo, hi = plan.ctl_offset, plan.heap_size
    assert ((acks[guarded, 0] >= lo) & (acks[guarded, 0] < hi)).all()
    # each counter takes C - 1 arrivals; its sends wait for 1 .. C - 2
    words, counts = np.unique(acks[recv, 0], return_counts=True)
    assert len(words) == hi - lo and (counts == tp - 1).all()
    for word in words:
        waits = sorted(acks[send & (acks[:, 0] == word), 1].tolist())
        assert waits == list(range(1, tp - 1))
    # a send's receiver is its peer (word 21): the counter's chip
    for row in np.nonzero(send & guarded)[0]:
        chip = (acks[row, 0] - lo) // 2 % tp
        assert chip == d[row, 21]


def test_stamp_refusals():
    """Stamping a dynamic plan or one that asks for the remote-copy
    transport raises, and so does the kernel's wrapper for the latter; a
    static plan stamped for one chip is itself."""
    cfg = _cfg()
    c = megakernelize(build_decode_graph(cfg, B, S, tp=2),
                      CompileOptions(decompose=DecomposeConfig(max_rows=8)))
    static = lower_tgraph(c, cfg)
    assert stamp_multichip(static, 1) is static
    with pytest.raises(NotImplementedError):
        stamp_multichip(lower_tgraph(c, cfg, scheduler="dynamic"), 2)
    plan = stamp_multichip(static, 2)
    statics = dict(plan.statics, REMOTE_DMA=1)
    heap = plan.alloc_heap("cpu")
    with pytest.raises(NotImplementedError):
        megakernel(heap, torch.from_numpy(plan.descs), statics,
                   acks=torch.from_numpy(plan.acks))


# ---------------------------------------------------------------------------
# The simulator and the API.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_mpk_tp_equals_reference(tp):
    """``simulate(mode="mpk_tp")`` charges each collective its ring (or
    the whole-tensor baseline) exactly as the reference does, and reduces
    exactly to ``mpk`` at tp=1."""
    cfg = _cfg()
    opts = dict(num_workers=2)
    rc = ref_megakernelize(ref_build_graph(cfg, B, S, tp=tp),
                           RefOptions(**opts))
    pc = megakernelize(build_decode_graph(cfg, B, S, tp=tp),
                       CompileOptions(**opts))
    for plan in ("ring", "serialized"):
        for overlap in (True, False):
            kw = dict(mode="mpk_tp", tp=tp, n_workers=2, comm_plan=plan,
                      overlap_comm=overlap)
            got, want = simulate(pc, SimConfig(**kw)), \
                ref_simulate(rc, RefSimConfig(**kw))
            assert got.makespan == want.makespan, (plan, overlap)
            assert got.worker_busy == want.worker_busy
    ring = simulate(pc, SimConfig(mode="mpk_tp", tp=tp, n_workers=2))
    ser = simulate(pc, SimConfig(mode="mpk_tp", tp=tp, n_workers=2,
                                 comm_plan="serialized"))
    assert ring.makespan != ser.makespan
    one = simulate(pc, SimConfig(mode="mpk_tp", tp=1, n_workers=2))
    base = simulate(pc, SimConfig(mode="mpk", n_workers=2))
    assert one.makespan == base.makespan
    assert one.worker_busy == base.worker_busy


def test_api_tp_refusals():
    """tp on the torch backend is a ValueError, tp with the dynamic
    scheduler NotImplementedError; the megakernel Program's plan has C
    chips of W lanes."""
    cfg = _cfg()
    with pytest.raises(ValueError):
        torch_compile(cfg, B, S, backend="torch", device="cpu", tp=2)
    with pytest.raises(ValueError):
        torch_compile(cfg, B, S, backend="megakernel", device="cpu", tp=0)
    with pytest.raises(NotImplementedError):
        torch_compile(cfg, B, S, backend="megakernel", device="cpu", tp=2,
                      scheduler="dynamic")
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         tp=4, num_workers=2)
    assert prog.plan.n_chips == 4 and prog.plan.num_workers == 8
