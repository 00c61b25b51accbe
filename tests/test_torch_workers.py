"""The W-worker megakernel of the port against the reference: the event
lowering (descriptor table and heap image at W ∈ {1, 2, 4}, trace off
and on), the plain PyTorch version across W and against the Pallas
megakernel in interpret mode, and the executor's per-step reset of the
event counters.  The CUDA kernel across W is ``test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.api import compile as torch_compile
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.models import params_from_jax

B, S = 2, 16
EVENT_COUNTERS = ("event_waits", "event_wait_violations", "event_signals")


def _setup(layers, seed=5, arch="deepseek-7b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, jp)


def _bindings(cfg, np_tree):
    """The same inputs as reference and port bindings (a random cache, so
    that attention reads more than zeros)."""
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    toks = np.array([3, 7], np.int32)
    lens = np.array([1, 4], np.int32)
    ref = ref_decode_bindings(cfg, np_tree, jcache, toks, lens)
    tcache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(np_tree, cfg, device="cpu"),
                           tcache, toks, lens)
    return ref, port


def _events_of_table(descs, W):
    """Per worker: (waits, signals) that the descriptor grid implies."""
    w = np.arange(descs.shape[0]) % W
    return [(int((descs[w == i, 32] >= 0).sum()),
             int((descs[w == i, 34] >= 0).sum())) for i in range(W)]


@pytest.fixture(scope="module")
def one_layer():
    cfg, np_tree = _setup(1)
    return cfg, np_tree, _bindings(cfg, np_tree)


@pytest.fixture(scope="module")
def plain_runs(one_layer):
    """One step of the plain version at W ∈ {1, 2, 4} from one heap
    image: (outputs, per-worker counters, plan) per W."""
    cfg, _, (_, pb) = one_layer
    out = {}
    for W in (1, 2, 4):
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W)
        assert plan.num_workers == W
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        out[W] = (ex.run_once(pb), ex.worker_counters(), plan)
    return out


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("arch,layers", [("deepseek-7b", 2),
                                         ("gemma-7b", 1)])
def test_event_lowering_matches_reference(arch, layers, workers, trace):
    """The same config and W → the same grid (int32 → int64), the same
    tail layout (event table, stats blocks, trace ring) and a
    bitwise-equal heap image from the same inputs."""
    cfg, np_tree = _setup(layers, arch=arch)
    ref = ref_compile(cfg, B, S, num_workers=workers, trace=trace)
    port = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                     trace=trace)
    assert port.num_workers == ref.num_workers
    assert port.num_steps == ref.num_steps
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    for attr in ("heap_size", "stats_offset", "event_offset", "num_events",
                 "trace", "ring_offset"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    for k in ("W", "NUM_STEPS", "EVENT_OFF", "N_EVENTS", "STATS_OFF",
              "TRACE", "TR_OFF"):
        assert port.statics.get(k) == ref.statics.get(k), k
    rb, pb = _bindings(cfg, np_tree)
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap.view(np.int32), ref_heap.view(np.int32))


def test_trace_off_layout_is_a_prefix_of_trace_on():
    """The ring is appended after every other region: the traced plan's
    table and tail offsets equal the untraced plan's."""
    cfg, _ = _setup(1)
    off = compile_decode_megakernel(cfg, B, S, num_workers=2)
    on = compile_decode_megakernel(cfg, B, S, num_workers=2, trace=True)
    assert np.array_equal(off.descs, on.descs)
    assert (off.event_offset, off.stats_offset) \
        == (on.event_offset, on.stats_offset)
    assert on.ring_offset == off.heap_size
    assert "TRACE" not in off.statics and on.statics["TRACE"] == 1


@pytest.mark.parametrize("workers", [2, 4])
def test_plain_bitwise_equal_across_workers(plain_runs, workers):
    """Logits and every written cache are bitwise equal to W = 1."""
    base = plain_runs[1][0]
    got = plain_runs[workers][0]
    assert set(got) == set(base)
    for name in base:
        assert torch.equal(got[name], base[name]), name


@pytest.mark.parametrize("workers", [2, 4])
def test_plain_counters_follow_the_table(plain_runs, workers):
    """Every wait and every signal the grid holds is counted on its
    worker, and no wait found its counter short of its trigger count."""
    _, counters, plan = plain_runs[workers]
    assert len(counters) == workers
    expect = _events_of_table(plan.descs, workers)
    assert [(c["event_waits"], c["event_signals"]) for c in counters] \
        == expect
    assert all(c["event_wait_violations"] == 0 for c in counters)
    assert sum(c["event_waits"] for c in counters) > 0


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_matches_pallas_interpret_across_workers(one_layer, plain_runs,
                                                       workers):
    """The reference's Pallas megakernel in interpret mode at the same W:
    every output within 2e-4, and the per-worker wait, violation and
    signal counters equal, and so are the tile transfers and their rows
    (the reference counts a primary tile when it prefetches it, the port
    when it demand-loads it: the same tiles)."""
    cfg, _, (rb, _) = one_layer
    ref_ex = RefExecutor(ref_compile(cfg, B, S, num_workers=workers), cfg)
    ref = ref_ex.run_once(rb)
    got, counters, _ = plain_runs[workers]
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    ref_counters = ref_ex.worker_counters()
    keys = EVENT_COUNTERS + ("bulk_copies", "row_copies")
    assert [{k: c[k] for k in keys} for c in counters] \
        == [{k: c[k] for k in keys} for c in ref_counters]
    assert [c["primary_fallbacks"] for c in counters] \
        == [c["primary_fallbacks"] + c["prefetch_tiles"]
            for c in ref_counters]
    assert all(c["prefetch_tiles"] == 0 for c in counters)


def test_executor_resets_counters_between_steps():
    """Two consecutive steps at W = 4 both find their counters zeroed:
    each counts the table's waits and signals and no violation (without
    the reset the second step's counters would start at their trigger
    counts)."""
    cfg, np_tree = _setup(1)
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         num_workers=4)
    prog.bind(params_from_jax(np_tree, cfg, device="cpu")).init_state()
    plan = prog.plan
    expect = _events_of_table(plan.descs, 4)
    lens = np.array([0, 2], np.int32)
    toks = np.array([5, 9], np.int32)
    for _ in range(2):
        assert np.isfinite(prog.step(toks, lens)).all()
        ws = prog.worker_stats
        assert ws["num_workers"] == 4 and ws["event_wait_violations"] == 0
        assert [(c["event_waits"], c["event_signals"])
                for c in ws["kernel_workers"]] == expect
        lens += 1


def test_program_workers_match_jax_serve_step_and_w1():
    """Four decode steps through W = 1 and W = 4 megakernel Programs on
    the CPU: logits bitwise equal to each other and within 3e-4 of the
    JAX oracle (``serve_step``)."""
    from repro.models import serve_step as jax_serve_step
    cfg, np_tree = _setup(2)
    progs = [torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                           num_workers=w) for w in (1, 4)]
    for p in progs:
        p.bind(params_from_jax(np_tree, cfg, device="cpu")).init_state()
    assert progs[1].worker_stats["num_workers"] == 4
    jp = jax.tree.map(jnp.asarray, np_tree)
    jcache = jax_init_cache(cfg, B, S, dtype=jnp.float32)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    lens = np.array([0, 3], np.int32)
    toks = np.array([11, 4], np.int32)
    for i in range(4):
        w1, w4 = (p.step(toks, lens) for p in progs)
        assert np.array_equal(w1, w4), f"step {i}"
        ref, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                            jnp.asarray(lens))
        np.testing.assert_allclose(w4, np.asarray(ref), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
        toks = np.asarray(ref).argmax(-1).astype(np.int32)
        lens += 1
