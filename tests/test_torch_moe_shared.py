"""The port's shared experts (llama4-maverick reduced: dense and MoE
layers interleaved, ``moe_period=2``; 4 routed experts, top-1, one
shared expert beside them) against the reference: ``moe_ffn``, the weight
tree, the decode graph and its compiled task set, the descriptor table
and heap image, the torch model's decode step and chunked prefill, the
plain megakernel against the Pallas megakernel in interpret mode, and
the megakernel Programs against the JAX oracle.

The reference lowers the shared experts as a GLU MLP on every token
beside the routed ones (two matmuls, GLU_MUL, the down matmul), summed
by a RESIDUAL_ADD (``repro/core/lowering.py``); its oracle adds them in
``moe_ffn`` (``repro/models/moe.py``).  No new megakernel kind: matmul,
GLU and residual add (kinds 1, 4, 5) beside the MoE kinds 9-11.

Tolerances: 3e-4 against the JAX oracle (the reference's own
megakernel-vs-oracle tolerance), 2e-4 against the interpret heap (its
megakernel-vs-interpreter tolerance); integer words bitwise."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config
from repro.core.compile import CompileOptions as RefOptions
from repro.core.compile import megakernelize as ref_megakernelize
from repro.core.lowering import build_decode_graph as ref_build_graph
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import serve_step as jax_serve_step
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.api import compile as torch_compile
from repro_torch.core.compile import CompileOptions, megakernelize
from repro_torch.core.graph import OpKind
from repro_torch.core.lowering import build_decode_graph, decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.models import (init_cache, params_from_jax, prefill_chunk,
                                serve_step)
from repro_torch.models.lm import check_supported, param_specs
from repro_torch.models.moe import moe_ffn

ARCH = "llama4-maverick-400b-a17b"
TOL = dict(rtol=3e-4, atol=3e-4)
B, S = 2, 16


def _cfg(layers=4, dropless=False):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers)
    if dropless:   # the reference's dropless convention (engine.py:99-101)
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _params(cfg, seed=0):
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _np(t):
    return t.detach().cpu().numpy()


def test_reduced_config_interleaves_shared_expert_layers():
    """The reduced config keeps llama4's layout: dense and MoE layers in
    turn, each MoE layer with a shared expert, and the port takes it."""
    cfg = _cfg()
    check_supported(cfg)
    assert cfg.n_shared_experts == 1 and cfg.moe_period == 2
    assert [cfg.ffn_kind(i) for i in range(cfg.n_layers)] \
        == ["mlp", "moe", "mlp", "moe"]


@pytest.mark.parametrize("tokens", [1, 3, 8])
def test_moe_ffn_with_shared_expert_matches_reference(tokens):
    """The same flat tokens through the reference's and the port's
    ``moe_ffn`` (routed experts at the default capacity factor plus the
    shared expert on every token)."""
    cfg = _cfg()
    _, tree = _params(cfg)
    moe = {k: np.array(tree["blocks"]["moe"][k][0, 0])
           for k in ("router", "w1", "w2", "shared_wi", "shared_wo")}
    x = np.random.default_rng(tokens).standard_normal(
        (tokens, cfg.d_model)).astype(np.float32)
    want = jax_moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in moe.items()}, cfg)
    p = {k: torch.from_numpy(moe[k]) for k in ("router", "w1", "w2")}
    p["shared_gate"] = torch.from_numpy(moe["shared_wi"][:, 0].copy())
    p["shared_up"] = torch.from_numpy(moe["shared_wi"][:, 1].copy())
    p["shared_down"] = torch.from_numpy(moe["shared_wo"])
    got = moe_ffn(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the shared expert adds something: without it the sums differ
    routed = moe_ffn(torch.from_numpy(x), p,
                     dataclasses.replace(cfg, n_shared_experts=0))
    assert not np.allclose(_np(routed), np.asarray(want), **TOL)


def test_params_from_jax_round_trip():
    """The reference's tree becomes the port's graph-named weights: the
    same names and shapes as ``param_specs`` and, value for value, what
    the reference's ``decode_bindings`` binds to those graph tensors (the
    shared experts' fused (D, 2, F) weights split into gate and up)."""
    cfg = _cfg()
    _, tree = _params(cfg)
    got = params_from_jax(tree, cfg, device="cpu")
    specs = param_specs(cfg)
    assert set(got) == set(specs)
    for name, (shape, _std) in specs.items():
        assert tuple(got[name].shape) == shape, name
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, 1, S,
                                                     dtype=jnp.float32))
    ref = ref_decode_bindings(cfg, tree, jcache, np.zeros(1, np.int32),
                              np.zeros(1, np.int32))
    for name, v in got.items():
        assert np.array_equal(_np(v), ref[name]), name
    assert {"L1.shared_gate_w", "L3.shared_down_w", "L0.wi_gate"} <= set(got)
    assert "L0.shared_up_w" not in got


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_compiled_graph_matches_reference(workers):
    """The same decode graph compiled by the reference and the port: the
    same ops (the shared experts' matmuls, GLU and residual add among
    them), task set, linearized order and worker partition."""
    cfg = _cfg()
    ref = ref_megakernelize(ref_build_graph(cfg, B, S),
                            RefOptions(num_workers=workers))
    port = megakernelize(build_decode_graph(cfg, B, S),
                         CompileOptions(num_workers=workers))
    assert [(o.kind, o.inputs, o.outputs) for o in port.graph.ops] \
        == [(o.kind, o.inputs, o.outputs) for o in ref.graph.ops]
    outs = {o.outputs[0]: o.kind for o in port.graph.ops}
    assert outs["L1.sglu"] == OpKind.GLU_MUL
    assert outs["L1.moe_total"] == OpKind.RESIDUAL_ADD
    assert "L0.sglu" not in outs
    assert port.order == ref.order
    assert sorted(port.tg.tasks) == sorted(ref.tg.tasks)
    pp, rp = port.partition, ref.partition
    assert pp.worker_of == rp.worker_of and pp.step_of == rp.step_of


def _bindings(cfg, seed=5):
    """The same weights and a random cache as reference and port
    bindings."""
    _, tree = _params(cfg, seed)
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    toks, lens = np.array([3, 7], np.int32), np.array([1, 4], np.int32)
    ref = ref_decode_bindings(cfg, tree, jcache, toks, lens)
    tcache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(tree, cfg, device="cpu"),
                           tcache, toks, lens)
    return ref, port


@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
@pytest.mark.parametrize("workers", [1, 4])
def test_lowering_and_heap_match_reference(scheduler, workers):
    """The descriptor table (int32 → int64), layout and heap image equal
    the reference's word for word."""
    cfg = _cfg()
    ref = ref_compile(cfg, B, S, num_workers=workers, scheduler=scheduler)
    port = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                     scheduler=scheduler)
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert {1, 4, 5, 9, 10, 11} <= set(port.descs[:, 0].tolist())
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    rb, pb = _bindings(cfg)
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap[:ref.heap_size].view(np.int32),
                          ref_heap.view(np.int32))


def test_plain_static_matches_pallas_interpret():
    """One step of the reference's Pallas megakernel (interpret mode) and
    of the port's plain version at W = 2 from the same inputs: every
    output within 2e-4, the event counters bitwise, and per worker the
    transfers, waits and signals the same."""
    cfg = _cfg(2)
    rb, pb = _bindings(cfg)
    ref = RefExecutor(ref_compile(cfg, B, S, num_workers=2), cfg)
    ref_out = ref.run_once(rb)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=2)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    out = ex.run_once(pb)
    assert set(out) == set(ref_out)
    for name in ref_out:
        np.testing.assert_allclose(out[name].numpy(), ref_out[name],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    lo, hi = plan.event_offset, plan.event_offset + plan.num_events
    assert np.array_equal(ex.heap.numpy()[lo:hi].view(np.int32),
                          np.asarray(ref._heap)[lo:hi].view(np.int32))
    for got, want in zip(ex.worker_counters(), ref.worker_counters()):
        for k in ("bulk_copies", "row_copies", "event_waits",
                  "event_wait_violations", "event_signals"):
            assert got[k] == want[k], k


@pytest.mark.parametrize("batch", [1, 3])
def test_serve_and_prefill_match_jax(batch):
    """A ragged chunked prefill, then four greedy decode steps through the
    torch model and the JAX oracle at the default capacity factor:
    logits and caches within 3e-4 at every step."""
    cfg = _cfg()
    jp, tree = _params(cfg, seed=batch)
    tp = params_from_jax(tree, cfg, device="cpu")
    jcache = jax_init_cache(cfg, batch, S, dtype=jnp.float32)
    tcache = init_cache(cfg, batch, S, device="cpu")
    rng = np.random.default_rng(batch)
    chunk = rng.integers(1, cfg.vocab, size=(batch, 6)).astype(np.int32)
    lens = np.zeros((batch,), np.int32)
    clens = np.array([6, 4, 5][:batch], np.int32)
    jl, jcache = jax.jit(jax_prefill_chunk, static_argnums=1)(
        jp, cfg, jcache, jnp.asarray(chunk), jnp.asarray(lens),
        jnp.asarray(clens))
    tl, tcache = prefill_chunk(tp, cfg, tcache, torch.from_numpy(chunk),
                               torch.from_numpy(lens),
                               torch.from_numpy(clens))
    for r in range(batch):
        np.testing.assert_allclose(_np(tl)[r, :clens[r]],
                                   np.asarray(jl)[r, :clens[r]], **TOL)
    lens = clens.copy()
    toks = np.asarray(jl)[np.arange(batch), clens - 1].argmax(-1)
    toks = toks.astype(np.int32)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    for step in range(4):
        jl, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                           jnp.asarray(lens))
        tl, tcache = serve_step(tp, cfg, tcache, torch.from_numpy(toks),
                                torch.from_numpy(lens))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[key]),
                                       np.asarray(jcache[key]), **TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        lens += 1


@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_megakernel_program_matches_jax_dropless(scheduler):
    """Four greedy decode steps at batch 3 through megakernel Programs at
    W = 1 and W = 4 against the JAX oracle at ``capacity_factor =
    n_experts`` (the megakernel is dropless): logits bitwise equal
    across W, within 3e-4 of JAX."""
    cfg = _cfg(dropless=True)
    jp, tree = _params(cfg, seed=3)
    params = params_from_jax(tree, cfg, device="cpu")
    progs = [torch_compile(cfg, 3, S, backend="megakernel", device="cpu",
                           num_workers=w, scheduler=scheduler)
             for w in (1, 4)]
    for p in progs:
        p.bind(params).init_state()
    jcache = jax_init_cache(cfg, 3, S, dtype=jnp.float32)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    lens = np.array([0, 2, 5], np.int32)
    toks = np.array([11, 4, 300], np.int32)
    for i in range(4):
        w1, w4 = (p.step(toks, lens) for p in progs)
        assert np.array_equal(w1, w4), f"step {i}"
        ref, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                            jnp.asarray(lens))
        np.testing.assert_allclose(w4, np.asarray(ref), **TOL,
                                   err_msg=f"step {i}")
        toks = np.asarray(ref).argmax(-1).astype(np.int32)
        lens += 1
