"""The port's SSM lowering and plain megakernel against the reference's,
under the static scheduler (mamba2-2.7b reduced: 8 heads of 32, N=16):
the descriptor table with kinds 12 (SSD state update) and 13 (conv step),
the statics, layout and heap image at W ∈ {1, 2, 4} under both
schedulers with the trace ring off and on; the plain version's step
against the Pallas megakernel in interpret mode, and against the
reference's tGraph interpreter and the JAX oracle.  The dynamic
scheduler's heap is ``test_torch_ssm_dyn.py``.

Tolerance 2e-4 on every output against the interpret heap and the
interpreter, the reference's megakernel-vs-interpreter tolerance; 3e-4
against the JAX oracle (``tests/test_megakernel.py``); integer words
(event counters, transfer counts, the trace ring) bitwise."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.core.interpreter import execute_reference
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import serve_step as jax_serve_step
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.megakernel.desc import CTL_WORDS
from repro_torch.models import params_from_jax
from test_torch_ssm import random_cache, ssm_cfg, ssm_tree

B, S = 2, 16
TOKS = np.array([3, 7], np.int32)
LENS = np.array([1, 4], np.int32)
STATICS = ("TN", "TM", "TK", "HD", "G", "STORE_CH", "NG", "S_MAX", "TOPK",
           "E_MAX", "HD_SSM", "N_SSM", "W_CONV", "NH_TILE", "NEG_EXP_A",
           "W", "NUM_STEPS", "EVENT_OFF", "N_EVENTS", "STATS_OFF", "TRACE",
           "TR_OFF", "DYN", "QOFF", "QCAP", "OV_ROWS", "QC_OFF", "TRACE_OFF",
           "T_TASKS", "MAX_OUT")


def ssm_bindings(cfg, seed=5):
    """The same weights (A_log, D, dt_bias and conv biases per head and
    channel) and a random state as reference and port bindings."""
    tree = ssm_tree(cfg, seed)
    jcache = random_cache(cfg, B, seed=7)
    ref = ref_decode_bindings(cfg, tree, jcache, TOKS, LENS)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(tree, cfg, device="cpu"),
                           tcache, TOKS, LENS)
    return ref, port, tree, jcache


def check_conv_windows(plan, heap, out, ref_out):
    """The new conv windows are pure copies: their first W-1 rows equal
    the reference's bitwise (the old window shifted), and the last row is
    the port's own projection row (``L.xp``, ``L.bp`` or ``L.cp``)
    bitwise.  Returns the number of windows checked."""
    n = 0
    for name in out:
        if not name.endswith("_state2") or ".conv_" not in name:
            continue
        layer, tag = name.split(".")[0], name.split("_")[1]
        got = out[name].numpy()
        assert np.array_equal(got[:, :-1], ref_out[name][:, :-1]), name
        src = plan.view(heap, f"{layer}.{tag}p").numpy()
        assert np.array_equal(got[:, -1], src), name
        n += 1
    return n


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_ssm_lowering_matches_reference(scheduler, workers, trace):
    """The same SSM config, W and scheduler → the same descriptor table
    (int32 → int64; kinds 12 and 13 with their words), statics, layout
    and tail offsets, and a heap image equal to the reference's word for
    word (the 4-D SSD state bound in its graph shape; a dynamic plan then
    has the port's control words, zero)."""
    cfg = ssm_cfg()
    ref = ref_compile(cfg, B, S, num_workers=workers, scheduler=scheduler,
                      trace=trace)
    port = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                     scheduler=scheduler, trace=trace)
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert {12, 13} <= set(port.descs[:, 0].tolist())
    for k in STATICS:
        assert port.statics.get(k) == ref.statics.get(k), k
    assert port.statics["KINDS"] == (1, 2, 4, 5, 8, 12, 13)
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    for attr in ("num_workers", "num_steps", "stats_offset", "event_offset",
                 "num_events", "ring_offset"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    extra = CTL_WORDS if scheduler == "dynamic" else 0
    assert port.heap_size == ref.heap_size + extra
    if scheduler == "dynamic":
        assert np.array_equal(port.dyn.sched_table(), ref.dyn.sched_table())
    assert port.input_classes() == ref.input_classes()
    rb, pb, _, _ = ssm_bindings(cfg)
    assert tuple(pb["L0.ssm_state"].shape) == (B, cfg.ssm_nheads,
                                               cfg.ssm_head_dim,
                                               cfg.ssm_state)
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap[:ref.heap_size].view(np.int32),
                          ref_heap.view(np.int32))
    assert not port_heap[ref.heap_size:].any()


@pytest.fixture(scope="module")
def static_steps():
    """One traced step per W ∈ {1, 2, 4} of the reference's Pallas
    megakernel (interpret mode) and of the port's plain version under the
    static scheduler, from the same inputs (one layer)."""
    cfg = ssm_cfg(1)
    rb, pb, _, _ = ssm_bindings(cfg)
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
    """Every output (logits, conv windows, SSD states) within 2e-4 of the
    interpret heap, the conv windows' copies bitwise; the event counters,
    the trace ring and, per worker, the tile transfers and their rows
    bitwise (the reference counts a primary tile when it prefetches it,
    the port when it demand-loads it: the same tiles)."""
    ref, ref_out, ex, out = static_steps[workers]
    assert set(out) == set(ref_out)
    for name in ref_out:
        np.testing.assert_allclose(out[name].numpy(), ref_out[name],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    plan = ex.plan
    assert check_conv_windows(plan, ex.heap, out, ref_out) == 3
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


def test_megakernel_matches_interpreter_and_jax():
    """Two layers: the plain megakernel's step within 2e-4 of the
    reference's tGraph interpreter on every graph output, and its logits
    within 3e-4 of the JAX model oracle from the same state, as the
    reference's ``tests/test_megakernel.py`` holds its megakernel."""
    cfg = ssm_cfg()
    rb, pb, tree, jcache = ssm_bindings(cfg)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=2)
    out = MegakernelExecutor(plan, cfg, device="cpu").run_once(pb)
    want = execute_reference(plan.compiled.graph, rb)
    assert set(want) == set(out)
    for name in want:
        np.testing.assert_allclose(out[name].numpy(), want[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    jl, _ = jax_serve_step(jax.tree.map(jnp.asarray, tree), cfg,
                           {k: jnp.asarray(v) for k, v in jcache.items()},
                           jnp.asarray(TOKS), jnp.asarray(LENS))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jl),
                               rtol=3e-4, atol=3e-4)
