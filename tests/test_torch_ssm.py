"""The port's SSM family (mamba2-2.7b reduced: d=128, d_inner=256, 8
heads of 32, N=16, conv width 4) against the reference: ``conv_decode``
and ``ssm_decode``, the torch model's decode step and chunked prefill
(padding included), the weight tree, ``reset_slot`` and the state
round trip on both backends, and the plain versions of megakernel kinds
12 (SSD state update) and 13 (conv step) against the reference's
``task_semantics``.  The plain megakernel against the Pallas interpret
heap is ``test_torch_ssm_heap.py`` (static) and ``test_torch_ssm_dyn.py``
(dynamic); the CUDA kinds against their plain versions are in
``test_torch_gpu.py``.

The reference initialises A_log = 0, D_skip = 1 and every bias to 0, the
same for every head and channel: with those a wrong head offset or a
dropped bias would go unseen.  ``ssm_tree`` overwrites them with seeded
values that differ by head and by channel, and hands the same arrays to
JAX and to the port.

Tolerances: 3e-4 against the JAX oracle (the reference's own
megakernel-vs-oracle tolerance, ``tests/test_megakernel.py``), 2e-4 for a
kind against its tile-local oracle, 1e-5 for the model's building
blocks.  Both sides run float32 on the CPU; only summation orders
differ."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.core.task_semantics import TASK_FNS as REF_TASK_FNS
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import serve_step as jax_serve_step
from repro.models.ssm import conv_decode as jax_conv_decode
from repro.models.ssm import ssm_decode as jax_ssm_decode
from repro_torch.api import compile as torch_compile
from repro_torch.core.graph import OpKind
from repro_torch.core.task_semantics import TASK_FNS
from repro_torch.megakernel import MegakernelExecutor, \
    compile_decode_megakernel
from repro_torch.models import (init_cache, params_from_jax, prefill_chunk,
                                serve_step)
from repro_torch.models.lm import param_specs
from repro_torch.models.ssm import conv_decode, ssm_decode

ARCH = "mamba2-2.7b"
TOL = dict(rtol=3e-4, atol=3e-4)
S = 16


def ssm_cfg(layers=2):
    return dataclasses.replace(get_config(ARCH).reduced(), n_layers=layers)


def ssm_tree(cfg, seed=0):
    """The reference's float32 weights (numpy) with A_log, D_skip,
    dt_bias and the conv biases redrawn per head and channel."""
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(1000 + seed)
    ssm = tree["blocks"]["ssm"]
    draw = {"A_log": lambda s: rng.uniform(0.0, 2.8, s),
            "D_skip": lambda s: rng.uniform(0.5, 1.5, s),
            "dt_bias": lambda s: rng.normal(0.0, 0.5, s)}
    for k in ("conv_bx", "conv_bb", "conv_bc"):
        draw[k] = lambda s: rng.normal(0.0, 0.1, s)
    for k, fn in draw.items():
        ssm[k][...] = fn(ssm[k].shape).astype(np.float32)
    return tree


def random_cache(cfg, b, seed=7, scale=0.5):
    """A reference-layout state with every leaf random (numpy)."""
    jc = jax.tree.map(np.asarray, jax_init_cache(cfg, b, S,
                                                 dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in jc.items()}


def _np(t):
    return t.detach().cpu().numpy()


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _layer(tree, i=0):
    return {k: np.array(v[i, 0]) for k, v in tree["blocks"]["ssm"].items()}


# ---------------------------------------------------------------------------
# The mixer's building blocks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,bias", [(256, True), (16, True), (16, False)])
def test_conv_decode_matches_reference(width, bias):
    """One conv step over a random (B, W, C) window: the output within
    1e-5 and the shifted window bitwise the reference's."""
    rng = np.random.default_rng(width)
    x = rng.standard_normal((3, width)).astype(np.float32)
    st = rng.standard_normal((3, 4, width)).astype(np.float32)
    w = rng.standard_normal((4, width)).astype(np.float32)
    b = (rng.standard_normal(width) if bias
         else np.zeros(width)).astype(np.float32)
    y, new = conv_decode(*map(torch.from_numpy, (x, st, w, b)))
    jy, jnew = jax_conv_decode(*map(jnp.asarray, (x, st, w, b)))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert np.array_equal(_np(new), np.asarray(jnew))


def test_ssm_decode_matches_reference():
    """One Mamba2 step of layer 0's weights from random conv and SSD
    states: y and every new state within 1e-5 of the reference's."""
    cfg = ssm_cfg(1)
    p = _layer(ssm_tree(cfg))
    cache = random_cache(cfg, 2)
    states = {k: cache[k][0, 0] for k in ("conv_x", "conv_b", "conv_c",
                                          "ssm")}
    x = np.random.default_rng(3).standard_normal((2, cfg.d_model)) \
        .astype(np.float32)
    y, new = ssm_decode(torch.from_numpy(x), _t(states), _t(p), cfg)
    jy, jnew = jax_ssm_decode(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in states.items()},
                              {k: jnp.asarray(v) for k, v in p.items()}, cfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in states:
        np.testing.assert_allclose(_np(new[k]), np.asarray(jnew[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The torch model against JAX.
# ---------------------------------------------------------------------------


def test_serve_step_matches_jax():
    """Four greedy decode steps from a random state: logits and every
    state leaf within 3e-4 of the reference's ``serve_step``."""
    cfg = ssm_cfg()
    tree = ssm_tree(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    jcache = random_cache(cfg, 2)
    cache = _t(jcache)
    jp = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    jc = {k: jnp.asarray(v) for k, v in jcache.items()}
    toks, lens = np.array([3, 7], np.int32), np.array([1, 4], np.int32)
    for i in range(4):
        logits, cache = serve_step(params, cfg, cache, torch.from_numpy(toks),
                                   torch.from_numpy(lens))
        jl, jc = jstep(jp, cfg, jc, jnp.asarray(toks), jnp.asarray(lens))
        np.testing.assert_allclose(_np(logits), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        for k in jc:
            np.testing.assert_allclose(_np(cache[k]), np.asarray(jc[k]),
                                       **TOL, err_msg=f"step {i} {k}")
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        lens += 1


def test_prefill_chunk_matches_jax_with_padding():
    """A 5-token chunk with request 1 padded after 3 tokens, from a
    random state: the valid positions' logits and every state leaf within
    3e-4 of the reference (the padded positions leave request 1's states
    where its third token put them), the cache updated in place."""
    cfg = ssm_cfg()
    tree = ssm_tree(cfg, seed=2)
    params = params_from_jax(tree, cfg, device="cpu")
    jcache = random_cache(cfg, 2, seed=9)
    cache = _t(jcache)
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, 5)) \
        .astype(np.int32)
    lens, clens = np.array([0, 2], np.int32), np.array([5, 3], np.int32)
    logits, out = prefill_chunk(params, cfg, cache, torch.from_numpy(toks),
                                torch.from_numpy(lens),
                                torch.from_numpy(clens))
    assert out is cache
    jl, jc = jax_prefill_chunk(jax.tree.map(jnp.asarray, tree), cfg,
                               {k: jnp.asarray(v) for k, v in jcache.items()},
                               jnp.asarray(toks), jnp.asarray(lens),
                               jnp.asarray(clens))
    for b in range(2):
        np.testing.assert_allclose(_np(logits[b, :clens[b]]),
                                   np.asarray(jl)[b, :clens[b]], **TOL)
    for k in jc:
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jc[k]), **TOL,
                                   err_msg=k)
    # request 1 after its 3 valid tokens equals 3 decode steps of it
    # alone (1e-5: a batch of one sums the projections in another order)
    one = {k: torch.from_numpy(v[:, :, 1:2].copy()) for k, v in
           jcache.items()}
    for i in range(3):
        serve_step(params, cfg, one, torch.from_numpy(toks[1:2, i]),
                   torch.from_numpy(lens[1:2] + i))
    for k in one:
        np.testing.assert_allclose(_np(cache[k][:, :, 1:2]), _np(one[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_params_from_jax_round_trip():
    """The reference's tree becomes the port's graph-named weights: the
    names and shapes of ``param_specs`` and, value for value, what the
    reference's ``decode_bindings`` binds to those graph tensors
    (``gnorm`` as ``gnorm_w``, ``ln`` as ``ln_w``)."""
    cfg = ssm_cfg()
    tree = ssm_tree(cfg)
    got = params_from_jax(tree, cfg, device="cpu")
    specs = param_specs(cfg)
    assert set(got) == set(specs)
    for name, (shape, _std) in specs.items():
        assert tuple(got[name].shape) == shape, name
    jcache = random_cache(cfg, 1)
    ref = ref_decode_bindings(cfg, tree, jcache, np.zeros(1, np.int32),
                              np.zeros(1, np.int32))
    for name, v in got.items():
        assert np.array_equal(_np(v), ref[name]), name
    assert {"L1.gnorm_w", "L1.A_log", "L1.conv_bc"} <= set(got)
    assert "L1.ln2_w" not in got and "L0.wq" not in got


def test_groups_other_than_one_raise():
    """One group of B and C is ported; more raise (jamba has 8)."""
    cfg = dataclasses.replace(ssm_cfg(), ssm_ngroups=2)
    with pytest.raises(NotImplementedError, match="groups"):
        torch_compile(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# The Programs: slot reuse and the state round trip.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "megakernel"])
def test_reset_slot_isolates_requests(backend):
    """``reset_slot(0)`` zeroes slot 0's conv and SSD states and leaves
    slot 1's bitwise as they were; the next step then equals a fresh
    torch Program that saw slot 1's history only (3e-4), as the
    reference's ``tests/test_program_api.py`` checks."""
    cfg = ssm_cfg()
    params = params_from_jax(ssm_tree(cfg), cfg, device="cpu")
    b = 2
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (4, b))
    prog = torch_compile(cfg, b, S, backend=backend, device="cpu",
                         num_workers=2)
    prog.bind(params).init_state()
    lens = np.zeros((b,), np.int32)
    for i in range(3):
        prog.step(toks[i], lens)
        lens += 1
    before = {k: v.clone() for k, v in prog.get_state().items()}
    assert set(before) == {"conv_x", "conv_b", "conv_c", "ssm"}
    prog.reset_slot(0)
    after = prog.get_state()
    for k in before:
        assert not after[k][:, :, 0].any(), k
        assert before[k][:, :, 0].any(), k
        assert torch.equal(after[k][:, :, 1], before[k][:, :, 1]), k
    got = prog.step(toks[3], np.array([0, lens[1]], np.int32))

    fresh = torch_compile(cfg, b, S, device="cpu").bind(params).init_state()
    flens = np.zeros((b,), np.int32)
    for i in range(3):
        fresh.step(np.stack([toks[i][1], toks[i][1]]), flens)
        flens += 1
    fresh.reset_slot(0)
    want = fresh.step(toks[3], np.array([0, flens[1]], np.int32))
    np.testing.assert_allclose(got, want, **TOL)


def test_megakernel_state_round_trip():
    """``set_state`` then ``get_state`` on the megakernel Program gives
    back every leaf (the 4-D SSD state included) bitwise, and a step
    from it agrees with the torch Program from the same state."""
    cfg = ssm_cfg()
    params = params_from_jax(ssm_tree(cfg), cfg, device="cpu")
    state = _t(random_cache(cfg, 2, seed=11))
    mk = torch_compile(cfg, 2, S, backend="megakernel", device="cpu")
    mk.bind(params).init_state()
    mk.set_state(state)
    got = mk.get_state()
    assert set(got) == set(state)
    for k in state:
        assert torch.equal(got[k], state[k]), k
    ref = torch_compile(cfg, 2, S, device="cpu").bind(params)
    ref.set_state({k: v.clone() for k, v in state.items()})
    toks, lens = np.array([5, 9]), np.array([3, 0])
    np.testing.assert_allclose(mk.step(toks, lens), ref.step(toks, lens),
                               **TOL)


# ---------------------------------------------------------------------------
# Kinds 12-13: the plain versions against the tile-local oracle.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["static", "dynamic"])
def test_plain_kinds_match_task_semantics(scheduler):
    """Every SSD update and conv task of one step of the plain megakernel
    equals the reference's ``task_semantics`` on its input regions, read
    from the heap before the step (kinds 12 and 13 update their state in
    place): outputs and new SSD states within 2e-4, the new conv windows
    bitwise.  The port's copy of ``task_semantics`` gives the
    reference's bits on the same inputs."""
    cfg = ssm_cfg()
    plan = compile_decode_megakernel(cfg, 2, S, num_workers=2,
                                     scheduler=scheduler)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    ex.bind(params_from_jax(ssm_tree(cfg), cfg, device="cpu"))
    gen = torch.Generator().manual_seed(5)
    for name in plan.input_classes()["state"]:
        plan.view(ex.heap, name).normal_(0.0, 0.5, generator=gen)
    before = ex.heap.clone()
    ex.step(np.array([5, 9]), np.array([0, 3]))
    after = ex.heap
    g, tg = plan.compiled.graph, plan.compiled.tg
    seen = {}
    for tid in plan.compiled.order:
        task = tg.tasks[tid]
        if task.is_dummy:
            continue
        op = g.op(task.op_id)
        if op.kind not in (OpKind.SSM_UPDATE, OpKind.CONV1D_UPDATE):
            continue
        state = op.inputs[1]
        # the inputs as the task saw them: the state from before the step,
        # the activations from after it (written by earlier tasks)
        ins = [_np(plan.view(before if t == state else after, t))
               [task.in_regions[t].slices()] for t in op.inputs]
        want = REF_TASK_FNS[op.kind](ins, op.attrs, {})
        for a, b in zip(TASK_FNS[op.kind](ins, op.attrs, {}), want):
            np.testing.assert_array_equal(a, b)
        for out, ref in zip(op.outputs, want):
            reg = task.out_regions[out]
            got = _np(plan.view(after, out))[reg.slices()]
            ref = np.asarray(ref).reshape(reg.shape)
            if op.kind == OpKind.CONV1D_UPDATE and out == op.outputs[1]:
                assert np.array_equal(got, ref), (tid, out)
            else:
                np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4,
                                           err_msg=f"{tid} {out}")
        seen[op.kind] = seen.get(op.kind, 0) + 1
    kinds = plan.descs[:, 0].tolist()
    assert seen[OpKind.SSM_UPDATE] == kinds.count(12) >= cfg.n_layers, seen
    assert seen[OpKind.CONV1D_UPDATE] == kinds.count(13) \
        >= 3 * cfg.n_layers, seen


def test_full_width_plan_passes_the_kernels_checks():
    """mamba2-2.7b at full width (one layer, B=2, S=128): ``TN`` = 5120
    (a norm and a conv row, which loop over any width) and ``HD`` = 2560
    (``d_model``: there is no attention) no longer refuse the plan; the
    matmul tiles stay within ``MAX_TN``, the kernel's shared memory is
    sized without ``HD``, and the full instantiation (the one with kinds
    12-13) is picked."""
    from repro_torch.megakernel.kernel import (MAX_TN, _attn_hd, _variant,
                                               check_plan)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    plan = compile_decode_megakernel(cfg, 2, 128)
    st = plan.statics
    assert (st["TN"], st["HD"], st["HD_SSM"], st["N_SSM"], st["W_CONV"],
            st["NH_TILE"]) == (5120, 2560, 64, 128, 4, 2)
    check_plan(st, plan.descs)
    assert _attn_hd(st) == 0 and _variant(st) == 2
    mm = plan.descs[plan.descs[:, 0] == 1]
    assert 0 < mm[:, 2].max() <= MAX_TN
    assert not {3, 6} & set(plan.descs[:, 0].tolist())
