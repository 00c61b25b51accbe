"""The port's trace ring and ``obs`` package against the reference's: the
ring the plain version writes equals the Pallas interpret-mode ring word
for word, its ticks are a permutation, its event order is clean, the
ring leaves everything else bitwise unchanged, and the Perfetto export
validates."""
import dataclasses
import json

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
from repro.obs import decode_ring as ref_decode_ring
from repro.obs import sequential_trace as ref_sequential_trace
from repro_torch.api import compile as torch_compile
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.models import params_from_jax
from repro_torch.obs import (check_event_order, chrome_trace, decode_ring,
                             sequential_trace, validate_chrome_trace,
                             write_chrome_trace)

B, S, W = 2, 16, 2
TOKS = np.array([3, 7], np.int32)
LENS = np.array([1, 4], np.int32)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              n_layers=1)
    jp = jax_init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    np_tree = jax.tree.map(np.asarray, jp)
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    rb = ref_decode_bindings(cfg, np_tree, jcache, TOKS, LENS)
    pb = decode_bindings(cfg, params_from_jax(np_tree, cfg, device="cpu"),
                         {k: torch.from_numpy(v) for k, v in jcache.items()},
                         TOKS, LENS)
    return cfg, np_tree, rb, pb


@pytest.fixture(scope="module")
def traced(setup):
    """One traced step of the plain version at W = 2 and the untraced
    step from the same heap image."""
    cfg, _, _, pb = setup
    out = {}
    for trace in (False, True):
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W,
                                         trace=trace)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        out[trace] = (ex.run_once(pb), ex, plan)
    return out


def test_ring_equals_pallas_interpret_ring(setup, traced):
    """The reference's Pallas megakernel in interpret mode at W = 2 with
    the ring on: the same records word for word, the same tick word, and
    the same decoded timeline."""
    cfg, _, rb, _ = setup
    rplan = ref_compile(cfg, B, S, num_workers=W, trace=True)
    rex = RefExecutor(rplan, cfg)
    rex.run_once(rb)
    _, ex, plan = traced[True]
    ring = ex.task_ring()
    assert ring.shape == (plan.num_steps * W, 8)
    assert np.array_equal(ring, rex.task_ring())
    assert float(ex.heap[plan.ring_offset]) \
        == float(rex.read_heap()[rplan.ring_offset])
    ours = decode_ring(plan, ring).events
    theirs = ref_decode_ring(rplan, rex.task_ring()).events
    assert [dataclasses.astuple(e) for e in ours] \
        == [dataclasses.astuple(e) for e in theirs]


def test_ticks_permutation_and_event_order(traced):
    _, ex, plan = traced[True]
    ring = ex.task_ring()
    ticks = np.concatenate([ring[:, 3], ring[:, 4]]).astype(np.int64)
    assert np.array_equal(np.sort(ticks), np.arange(2 * ring.shape[0]))
    assert (ring[:, 0] == np.arange(ring.shape[0]) % W).all()
    assert (ring[:, 5] == -1).all() and (ring[:, 7] == 0).all()
    tl = decode_ring(plan, ring)
    assert any(e.wait_ev >= 0 for e in tl.events)
    assert check_event_order(tl) == []


def test_check_event_order_catches_a_waiter_before_its_signaller(traced):
    """Moving a waiter's start before its signaller's end is reported."""
    _, ex, plan = traced[True]
    tl = decode_ring(plan, ex.task_ring())
    waiter = next(e for e in tl.events if e.wait_ev >= 0)
    waiter.start = -1.0
    assert any(f"waiter row {waiter.row}" in p
               for p in check_event_order(tl))


def test_trace_off_is_bitwise_neutral(traced):
    """Every output and every heap word before the ring are the same
    with the ring on and off."""
    out_off, ex_off, plan_off = traced[False]
    out_on, ex_on, plan_on = traced[True]
    for name in out_off:
        assert torch.equal(out_off[name], out_on[name]), name
    assert torch.equal(ex_off.heap, ex_on.heap[:plan_off.heap_size])


def test_sequential_trace_matches_reference(setup):
    cfg = setup[0]
    ours = sequential_trace(
        compile_decode_megakernel(cfg, B, S, num_workers=W).compiled)
    theirs = ref_sequential_trace(ref_compile(cfg, B, S,
                                              num_workers=W).compiled)
    assert [dataclasses.astuple(e) for e in ours.events] \
        == [dataclasses.astuple(e) for e in theirs.events]


def test_perfetto_export_validates(traced, tmp_path):
    _, ex, plan = traced[True]
    tl = decode_ring(plan, ex.task_ring())
    obj = chrome_trace(tl)
    assert validate_chrome_trace(obj) == []
    assert validate_chrome_trace(json.dumps(obj)) == []
    assert validate_chrome_trace({"traceEvents": [{"ph": "X"}]}) != []
    path = tmp_path / "trace.json"
    write_chrome_trace(tl, str(path))
    loaded = json.loads(path.read_text())
    tracks = {e["tid"] for e in loaded["traceEvents"] if e["ph"] == "X"}
    assert tracks == set(range(W))


def test_program_trace(setup):
    """``Program.trace()`` decodes the last step's ring; a program
    compiled without the ring raises."""
    cfg, np_tree, _, _ = setup
    params = params_from_jax(np_tree, cfg, device="cpu")
    plain = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                          num_workers=W).bind(params).init_state()
    plain.step(TOKS, LENS)
    with pytest.raises(ValueError, match="trace=True"):
        plain.trace()
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                         num_workers=W, trace=True).bind(params).init_state()
    with pytest.raises(ValueError, match="no step"):
        prog.trace()
    assert np.array_equal(prog.step(TOKS, LENS), plain.step(TOKS, LENS))
    tl = prog.trace()
    assert tl.origin == "kernel" and tl.num_workers == W
    assert check_event_order(tl) == []
    assert {e.task for e in tl.events if e.kind > 0} \
        == {t for t, task in prog.plan.compiled.tg.tasks.items()
            if not task.is_dummy}
