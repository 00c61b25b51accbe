"""The port's MoE lowering and plain megakernel against the reference's,
under the static scheduler (granite-moe-1b-a400m reduced: 4 experts,
top-2, one layer): the descriptor table, statics, layout and heap image
at W ∈ {1, 2, 4} under both schedulers with the trace ring off and on,
and the plain version's step against the Pallas megakernel in interpret
mode.  The dynamic scheduler's heap is ``test_torch_moe_dyn.py``.

Tolerance 2e-4 on every output against the interpret heap, the
reference's megakernel-vs-interpreter tolerance; integer words (event
counters, transfer counts, the trace ring) bitwise."""
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
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.megakernel.desc import CTL_WORDS
from repro_torch.models import params_from_jax

B, S = 2, 16
TOKS = np.array([3, 7], np.int32)
LENS = np.array([1, 4], np.int32)
STATICS = ("TN", "TM", "TK", "HD", "G", "STORE_CH", "NG", "S_MAX", "TOPK",
           "E_MAX", "W", "NUM_STEPS", "EVENT_OFF", "N_EVENTS", "STATS_OFF",
           "TRACE", "TR_OFF", "DYN", "QOFF", "QCAP", "OV_ROWS", "QC_OFF",
           "TRACE_OFF", "T_TASKS", "MAX_OUT")


def moe_cfg(layers=1):
    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               n_layers=layers)


def moe_bindings(cfg, seed=5):
    """The same weights and a random cache as reference and port
    bindings (so that attention reads more than zeros)."""
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    ref = ref_decode_bindings(cfg, tree, jcache, TOKS, LENS)
    tcache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(tree, cfg, device="cpu"),
                           tcache, TOKS, LENS)
    return ref, port


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_moe_lowering_matches_reference(scheduler, workers, trace):
    """The same MoE config, W and scheduler → the same descriptor table
    (int32 → int64; kinds 9-11 with their words), statics, layout and
    tail offsets, and a heap image equal to the reference's word for
    word (a dynamic plan then has the port's control words, zero)."""
    cfg = moe_cfg(2)
    ref = ref_compile(cfg, B, S, num_workers=workers, scheduler=scheduler,
                      trace=trace)
    port = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                     scheduler=scheduler, trace=trace)
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert {9, 10, 11} <= set(port.descs[:, 0].tolist())
    for k in STATICS:
        assert port.statics.get(k) == ref.statics.get(k), k
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    for attr in ("num_workers", "num_steps", "stats_offset", "event_offset",
                 "num_events", "ring_offset"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    extra = CTL_WORDS if scheduler == "dynamic" else 0
    assert port.heap_size == ref.heap_size + extra
    if scheduler == "dynamic":
        assert np.array_equal(port.dyn.sched_table(), ref.dyn.sched_table())
    rb, pb = moe_bindings(cfg)
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap[:ref.heap_size].view(np.int32),
                          ref_heap.view(np.int32))
    assert not port_heap[ref.heap_size:].any()


@pytest.fixture(scope="module")
def static_steps():
    """One traced step per W ∈ {1, 2, 4} of the reference's Pallas
    megakernel (interpret mode) and of the port's plain version under the
    static scheduler, from the same inputs."""
    cfg = moe_cfg()
    rb, pb = moe_bindings(cfg)
    out = {}
    for W in (1, 2, 4):
        ref = RefExecutor(ref_compile(cfg, B, S, num_workers=W, trace=True),
                          cfg)
        ref_out = ref.run_once(rb)
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W,
                                         trace=True)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        out[W] = (ref, ref_out, ex, ex.run_once(pb))
    return out


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_static_matches_pallas_interpret(static_steps, workers):
    """Every output (logits, caches) within 2e-4 of the interpret heap;
    the event counters, the trace ring and, per worker, the tile
    transfers and their rows bitwise (the reference counts a primary
    tile when it prefetches it, the port when it demand-loads it: the
    same tiles)."""
    ref, ref_out, ex, out = static_steps[workers]
    assert set(out) == set(ref_out)
    for name in ref_out:
        np.testing.assert_allclose(out[name].numpy(), ref_out[name],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    plan = ex.plan
    heap, ref_heap = ex.heap.numpy(), np.asarray(ref._heap)
    for lo, hi in ((plan.event_offset, plan.event_offset + plan.num_events),
                   (plan.ring_offset, plan.heap_size)):
        assert np.array_equal(heap[lo:hi].view(np.int32),
                              ref_heap[lo:hi].view(np.int32))
    for got, want in zip(ex.worker_counters(), ref.worker_counters()):
        for k in ("bulk_copies", "row_copies", "event_waits",
                  "event_wait_violations", "event_signals"):
            assert got[k] == want[k], k
        assert got["primary_fallbacks"] \
            == want["primary_fallbacks"] + want["prefetch_tiles"]


def test_plain_static_bitwise_across_workers(static_steps):
    """The plain version's outputs are bitwise equal across W."""
    base = static_steps[1][3]
    for w in (2, 4):
        got = static_steps[w][3]
        for name in base:
            assert torch.equal(got[name], base[name]), (w, name)
