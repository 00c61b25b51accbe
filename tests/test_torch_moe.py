"""The port's MoE family (granite-moe-1b-a400m reduced: 4 experts, top-2)
against the reference: ``moe_ffn`` with its capacity drops, the torch
model's decode step and chunked prefill, the weight tree, the compiler
passes on the MoE decode graph, the plain versions of megakernel kinds
9-11 against the reference's ``task_semantics``, and the megakernel
Programs against the JAX oracle.  The plain megakernel against the Pallas interpret heap is
``test_torch_moe_heap.py``; the CUDA kinds against their plain versions
are in ``test_torch_gpu.py``.

Tolerances: 3e-4 against the JAX oracle (the reference's own
megakernel-vs-oracle tolerance, ``tests/test_megakernel.py``), 2e-4 for a
kind against its tile-local oracle.  Both sides run float32 on the CPU;
only summation orders differ."""
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
from repro.core.runtime_sim import SimConfig as RefSimConfig
from repro.core.runtime_sim import simulate as ref_simulate
from repro.core.task_semantics import TASK_FNS as REF_TASK_FNS
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import serve_step as jax_serve_step
from repro.models.moe import expert_capacity as jax_expert_capacity
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.api import compile as torch_compile
from repro_torch.core.compile import CompileOptions, megakernelize
from repro_torch.core.graph import OpKind
from repro_torch.core.lowering import build_decode_graph
from repro_torch.core.runtime_sim import SimConfig, simulate
from repro_torch.core.task_semantics import TASK_FNS
from repro_torch.megakernel import MegakernelExecutor, \
    compile_decode_megakernel
from repro_torch.models import (init_cache, params_from_jax, prefill_chunk,
                                serve_step)
from repro_torch.models.lm import param_specs
from repro_torch.models.moe import expert_capacity, moe_ffn, route

ARCH = "granite-moe-1b-a400m"
TOL = dict(rtol=3e-4, atol=3e-4)
S = 16


def _cfg(layers=1, dropless=False):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers)
    if dropless:   # the reference's dropless convention (engine.py:99-101)
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _params(cfg, seed=0):
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# moe_ffn and the torch model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,repeat", [(1, 1), (2, 1), (3, 1), (3, 3),
                                           (12, 4)])
def test_moe_ffn_matches_reference_with_drops(tokens, repeat):
    """The same flat tokens through the reference's and the port's
    ``moe_ffn`` at the default capacity factor (1.25).  With each row
    repeated ``repeat`` times (the same token several times in a batch)
    an expert is chosen by more rows than its capacity holds, and both
    drop the rows past it."""
    cfg = _cfg()
    _, tree = _params(cfg)
    moe = {k: np.array(tree["blocks"]["moe"][k][0, 0])
           for k in ("router", "w1", "w2")}
    x = np.random.default_rng(tokens).standard_normal(
        (tokens // repeat, cfg.d_model)).astype(np.float32)
    x = np.repeat(x, repeat, axis=0)
    want = jax_moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in moe.items()}, cfg)
    got = moe_ffn(torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in moe.items()}, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    cap = expert_capacity(tokens, cfg.top_k, cfg.n_experts,
                          cfg.capacity_factor)
    assert cap == jax_expert_capacity(tokens, cfg.top_k, cfg.n_experts,
                                      cfg.capacity_factor)
    logits = torch.from_numpy(x) @ torch.from_numpy(moe["router"])
    load = torch.bincount(route(logits, cfg.top_k)[1].reshape(-1),
                          minlength=cfg.n_experts)
    assert (int(load.max()) > cap) == (repeat > 1), (load, cap)


def test_route_takes_the_lower_index_on_ties():
    """Equal logits: the lower expert first, as ``jax.lax.top_k``."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    w, idx = route(logits, 3)
    jw, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4]]
    np.testing.assert_allclose(_np(w), np.asarray(jax.nn.softmax(jw, -1)),
                               rtol=1e-6)


def test_params_from_jax_round_trip():
    """The reference's tree becomes the port's graph-named weights: the
    same names and shapes as ``param_specs`` and, value for value, what
    the reference's ``decode_bindings`` binds to those graph tensors."""
    cfg = _cfg(2)
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
    assert "L1.moe_w1" in got and "L1.wi_gate" not in got


def _count_drops(monkeypatch):
    """Record, per ``moe_ffn`` call of the port, (tokens, rows dropped)."""
    import repro_torch.models.moe as moe_mod
    calls, inner = [], moe_mod._moe_local

    def counted(x2d, router_w, w1, w2, **kw):
        ids = route((x2d @ router_w).float(), kw["top_k"])[1]
        load = torch.bincount(ids.reshape(-1), minlength=kw["n_experts"])
        calls.append((x2d.shape[0],
                      int((load - kw["capacity"]).clamp(min=0).sum())))
        return inner(x2d, router_w, w1, w2, **kw)

    monkeypatch.setattr(moe_mod, "_moe_local", counted)
    return calls


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_serve_and_prefill_match_jax_with_drops(batch, monkeypatch):
    """A ragged chunked prefill, then six greedy decode steps through the
    torch model and the JAX oracle at the default capacity factor: the
    chunk (padding rows included) and, at batch 3, decode steps overflow
    an expert's capacity and drop rows, in the JAX oracle as in the port.
    Logits and caches within 3e-4 at every step."""
    drops = _count_drops(monkeypatch)
    cfg = _cfg(2)
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
    for step in range(6):
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
    assert sum(n for t, n in drops if t > batch) > 0        # the chunk
    decode_drops = sum(n for t, n in drops if t == batch)
    assert (decode_drops > 0) == (batch == 3), drops


# ---------------------------------------------------------------------------
# The compiler passes on the MoE decode graph.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_compiled_moe_graph_matches_reference(workers):
    """The same MoE decode graph compiled by the reference and the port:
    the same ops, task set (kinds, regions, events), linearized order,
    worker partition and simulated makespans."""
    cfg = _cfg(2)
    ref = ref_megakernelize(ref_build_graph(cfg, 2, S),
                            RefOptions(num_workers=workers))
    port = megakernelize(build_decode_graph(cfg, 2, S),
                         CompileOptions(num_workers=workers))
    assert [(o.kind, o.inputs, o.outputs) for o in port.graph.ops] \
        == [(o.kind, o.inputs, o.outputs) for o in ref.graph.ops]
    kinds = {o.kind for o in port.graph.ops}
    assert {OpKind.SOFTMAX_TOPK, OpKind.MOE_GATHER_GEMM,
            OpKind.MOE_COMBINE} <= kinds
    assert port.order == ref.order
    assert sorted(port.tg.tasks) == sorted(ref.tg.tasks)
    for tid, t in port.tg.tasks.items():
        r = ref.tg.tasks[tid]
        assert (t.op_id, t.is_dummy, t.dependent_events,
                t.triggering_events) == (r.op_id, r.is_dummy,
                                         r.dependent_events,
                                         r.triggering_events), tid
        assert {n: (g.starts, g.shape) for n, g in t.out_regions.items()} \
            == {n: (g.starts, g.shape) for n, g in r.out_regions.items()}
    pp, rp = port.partition, ref.partition
    assert (pp.num_workers, pp.num_steps) == (rp.num_workers, rp.num_steps)
    assert pp.worker_of == rp.worker_of and pp.step_of == rp.step_of
    for mode in ("mpk", "mpk_dyn", "kernel_per_op"):
        got = simulate(port, SimConfig(mode=mode, n_workers=workers))
        want = ref_simulate(ref, RefSimConfig(mode=mode, n_workers=workers))
        assert got.makespan == want.makespan, mode


# ---------------------------------------------------------------------------
# Kinds 9-11: the plain versions against the tile-local oracle.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_plain_kinds_match_task_semantics(scheduler):
    """After one step of the plain megakernel, every router top-k, expert
    GEMM and combine task's output region equals the reference's
    ``task_semantics`` on its input regions read from the same heap
    (2e-4); the router's zeros are exact.  The port's copy of
    ``task_semantics`` gives the reference's bits on the same inputs."""
    cfg = _cfg(2)
    _, tree = _params(cfg)
    plan = compile_decode_megakernel(cfg, 2, S, num_workers=2,
                                     scheduler=scheduler)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    ex.bind(params_from_jax(tree, cfg, device="cpu"))
    ex.step(np.array([5, 9]), np.array([0, 3]))
    g, tg = plan.compiled.graph, plan.compiled.tg
    seen = {}
    for tid in plan.compiled.order:
        task = tg.tasks[tid]
        if task.is_dummy:
            continue
        op = g.op(task.op_id)
        if op.kind not in (OpKind.SOFTMAX_TOPK, OpKind.MOE_GATHER_GEMM,
                           OpKind.MOE_COMBINE):
            continue
        ins = [_np(plan.view(ex.heap, t))[task.in_regions[t].slices()]
               for t in op.inputs]
        pr = task.out_regions[op.outputs[0]]
        ctx = {"row_start": pr.starts[0], "col_start": pr.starts[-1],
               "expert_local": pr.starts[0] if pr.ndim == 3 else 0}
        want = REF_TASK_FNS[op.kind](ins, op.attrs, ctx)
        np.testing.assert_array_equal(TASK_FNS[op.kind](ins, op.attrs, ctx),
                                      want)
        got = _np(plan.view(ex.heap, op.outputs[0]))[pr.slices()]
        np.testing.assert_allclose(got, np.asarray(want).reshape(pr.shape),
                                   rtol=2e-4, atol=2e-4, err_msg=str(tid))
        if op.kind == OpKind.SOFTMAX_TOPK:
            assert np.array_equal(got == 0, np.asarray(want) == 0)
            assert ((got > 0).sum(-1) == cfg.top_k).all()
        seen[op.kind] = seen.get(op.kind, 0) + 1
    assert set(seen) == {OpKind.SOFTMAX_TOPK, OpKind.MOE_GATHER_GEMM,
                         OpKind.MOE_COMBINE}
    assert seen[OpKind.MOE_GATHER_GEMM] == 2 * 2 * cfg.n_experts, seen


def test_router_weight_that_underflows_masks_its_row():
    """Kind 10 masks a row by ``router weight > 0``, not by "chosen": a
    chosen expert whose weight is 0 adds nothing, in the plain version as
    in the reference's ``task_semantics``."""
    from repro_torch.megakernel.kernel import _run_task
    heap = torch.zeros(4096)
    rng = np.random.default_rng(0)
    m, k, n = 2, 8, 4
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    router = torch.tensor([0.0, 0.7])       # row 0 chose it with weight 0
    heap[0:m * 16].view(m, 16)[:, :k] = x
    heap[512:512 + k * 16].view(k, 16)[:, :n] = w
    heap[1024:1024 + m * 16].view(m, 16)[:, 0] = router
    d = [10, m, n, k, 2048, 16, 0, 16, 512, 16, 1024, 16] + [0] * 24
    d[14], d[15], d[19] = 0, 0, -1
    tile = lambda off, ld, rows, cols: torch.as_strided(heap, (rows, cols),
                                                        (ld, 1), off)
    _run_task(d, tile, lambda v: 4, None, heap, 4, 2, 1, 1, None, 2)
    want = REF_TASK_FNS[OpKind.MOE_GATHER_GEMM](
        [x.numpy(), router.numpy()[:, None], w.numpy()[None]], {}, {})[0]
    got = tile(2048, 16, m, n)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    assert (got[0] == 0).all() and (got[1] != 0).all()


# ---------------------------------------------------------------------------
# The Programs.
# ---------------------------------------------------------------------------


def test_programs_compile_with_both_backends_schedulers_and_w():
    """The reduced MoE config compiles with both backends, both
    schedulers and W ∈ {1, 2, 4}; MoE adds no state: ``reset_slot``,
    ``get_state`` and ``set_state`` hold the KV cache only."""
    cfg = _cfg(2)
    torch_compile(cfg, 2, S, device="cpu")
    for scheduler in ("static", "dynamic"):
        for w in (1, 2, 4):
            prog = torch_compile(cfg, 2, S, backend="megakernel",
                                 device="cpu", num_workers=w,
                                 scheduler=scheduler)
            assert prog.plan.num_workers == w
            codes = set(prog.plan.descs[:, 0].tolist())
            assert {9, 10, 11} <= codes
    prog.init_weights(torch.Generator().manual_seed(0))
    assert set(prog.init_state().get_state()) == {"k", "v"}


@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_megakernel_program_matches_jax_dropless(scheduler):
    """Five greedy decode steps at batch 3 through megakernel Programs at
    W = 1 and W = 4 against the JAX oracle at ``capacity_factor =
    n_experts``, the reference's dropless convention (the megakernel is
    dropless): logits bitwise equal across W, within 3e-4 of JAX."""
    cfg = _cfg(2, dropless=True)
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
    for i in range(5):
        w1, w4 = (p.step(toks, lens) for p in progs)
        assert np.array_equal(w1, w4), f"step {i}"
        ref, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                            jnp.asarray(lens))
        np.testing.assert_allclose(w4, np.asarray(ref), **TOL,
                                   err_msg=f"step {i}")
        toks = np.asarray(ref).argmax(-1).astype(np.int32)
        lens += 1


def test_odd_vocabulary_plan_runs_with_single_column_stores():
    """granite's own vocabulary (49155, odd) leaves the LM head's last
    tile 3 columns wide, so the masked-store chunk is 1 column, as in the
    reference: the CUDA launch guards take the plan (the matmul finishes
    such a tile one dot product at a time) and the plain version's
    logits agree with the torch Program within 3e-4."""
    from repro_torch.megakernel.kernel import check_plan
    cfg = dataclasses.replace(_cfg(1, dropless=True), vocab=49155)
    ref_plan = ref_compile(cfg, 2, S)
    mk = torch_compile(cfg, 2, S, backend="megakernel", device="cpu",
                       num_workers=2)
    assert mk.plan.statics["STORE_CH"] == ref_plan.statics["STORE_CH"] == 1
    check_plan(mk.plan.statics, mk.plan.descs)
    mk.init_weights(torch.Generator().manual_seed(1)).init_state()
    ref = torch_compile(cfg, 2, S, device="cpu").bind(mk.weight_views())
    ref.init_state()
    toks, lens = np.array([5, 49154]), np.array([0, 3])
    for i in range(2):
        got, want = mk.step(toks, lens), ref.step(toks, lens)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")
        toks, lens = want.argmax(-1), lens + 1
