"""The embedding-input slice against the reference: M-RoPE (``rope`` with
sections), the lowering with the ``h0`` input and (B, 3) positions, and the plain megakernel's kind 3 with
distinct (t, h, w) positions against the Pallas megakernel in interpret
mode.  qwen2-vl-2b reduced (M-RoPE sections (8, 4, 4) of hd/2 = 16, GQA
4/2, qkv bias) and musicgen-large reduced (plain RoPE, GELU).  The qkv
biases, which the reference initialises to zero, are redrawn so that a
dropped bias shows.  The torch model on embeddings against JAX's is
``test_torch_model.py``; the CUDA ``k_rope`` against the plain version
is ``test_torch_gpu.py``."""
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
from repro.models.layers import rope as jax_rope
from repro_torch.api import compile as torch_compile
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel, lower_tgraph)
from repro_torch.megakernel.kernel import check_plan
from repro_torch.models import params_from_jax
from repro_torch.models.layers import rope
from repro_torch.models.lm import param_specs

B, S = 2, 16
LENS = np.array([1, 4], np.int32)
#: distinct (t, h, w) positions: two patches of an image grid
POS = np.array([[1, 3, 5], [4, 0, 7]], np.int32)
EMBED_ARCHS = ["qwen2-vl-2b", "musicgen-large"]


def _cfg(arch, layers):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=layers)


def _params(cfg, seed=5):
    """The reference's weights as numpy, the qkv biases redrawn."""
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["attn"]
    for nm in ("bq", "bk", "bv"):
        if nm in attn:
            attn[nm] = (rng.standard_normal(attn[nm].shape) * 0.1) \
                .astype(np.float32)
    return tree


def _embeds(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hd,sections", [(32, (8, 4, 4)),
                                         (128, (16, 24, 24))])
def test_rope_sections_match_reference(hd, sections):
    """cos/sin of (B, N, 3) positions (distinct columns) against the
    reference's ``rope``, within 1e-6; text mode (three equal columns)
    equals plain RoPE of one column.  Positions stay below 128, the
    context the card serves (max_seq 128): XLA's and PyTorch's float32
    ``pow`` and ``cos`` differ in the last bits, and the angle carries
    that error times the position (1.9e-6 apart at hd 128 for positions
    below 256, 3e-5 at 4096), which is not the sections' doing."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 128, size=(2, 5, 3)).astype(np.int32)
    jc, js = jax_rope(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = rope(torch.from_numpy(pos), hd, 1e6, sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    text = torch.from_numpy(pos[..., 0])
    c3, s3 = rope(torch.stack([text] * 3, dim=-1), hd, 1e6, sections)
    c1, s1 = rope(text, hd, 1e6)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)


def _bindings(cfg, tree, positions):
    """The same inputs (embeddings, a random cache, ``positions``) as
    reference and port bindings."""
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    h0 = _embeds(rng, B, cfg.d_model)
    ref = ref_decode_bindings(cfg, tree, jcache, h0, LENS, positions)
    tcache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(tree, cfg, device="cpu"),
                           tcache, h0, LENS, positions)
    return ref, port


def test_lowering_with_distinct_positions_matches_reference():
    """qwen2-vl reduced at two layers: the ``h0`` input, (B, 3)
    positions on both ROPE ops, descriptor words 15, 19 and 20, the
    ``MROPE`` static, the layout and the heap image built from distinct
    (t, h, w) positions, all equal to the reference's."""
    cfg = _cfg("qwen2-vl-2b", 2)
    ref, port = ref_compile(cfg, B, S), compile_decode_megakernel(cfg, B, S)
    g = port.compiled.graph
    assert "h0" in g.inputs and "tokens" not in g.inputs \
        and "embed" not in g.inputs
    assert g.spec("positions").shape == (B, 3)
    rope_rows = port.descs[port.descs[:, 0] == 3]
    assert len(rope_rows) and (rope_rows[:, 15] == 1).all()
    assert (rope_rows[:, 20] == port.layout["positions"].ld).all()
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert port.statics["MROPE"] == ref.statics["MROPE"] == (8, 4, 4)
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    assert port.input_classes()["per_step"] == \
        ["h0", "positions", "seq_lens", "live_lens"]
    rb, pb = _bindings(cfg, _params(cfg), POS)
    assert np.array_equal(pb["positions"].numpy(), rb["positions"])
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap.view(np.int32), ref_heap.view(np.int32))


def test_plain_megakernel_matches_pallas_interpret_distinct_positions():
    """One layer, one step with distinct (t, h, w) positions: the plain
    version against the reference's Pallas megakernel in interpret mode,
    every output (logits and the written KV caches) within 2e-4.  The
    same step with text-mode positions differs, so the sections are
    read."""
    cfg = _cfg("qwen2-vl-2b", 1)
    rb, pb = _bindings(cfg, _params(cfg), POS)
    ref = RefExecutor(ref_compile(cfg, B, S), cfg).run_once(rb)
    plan = compile_decode_megakernel(cfg, B, S)
    got = MegakernelExecutor(plan, cfg, device="cpu").run_once(pb)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    text = dict(pb, positions=torch.from_numpy(np.stack([LENS] * 3, -1)))
    other = MegakernelExecutor(plan, cfg, device="cpu").run_once(text)
    assert not torch.equal(other["logits"], got["logits"])


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_plain_static_and_dynamic_bitwise_across_workers(arch):
    """One step of an ``h0`` input (qwen2-vl with distinct positions)
    from one heap image: the plain static and dynamic versions at W ∈
    {1, 2, 4} give bitwise-equal logits and caches, with no event-wait
    violation."""
    cfg = _cfg(arch, 2)
    pos = POS if cfg.mrope_sections is not None else None
    _, pb = _bindings(cfg, _params(cfg), pos)
    first = None
    for w in (1, 2, 4):
        splan = compile_decode_megakernel(cfg, B, S, num_workers=w)
        for plan in (splan, lower_tgraph(splan.compiled, cfg,
                                         scheduler="dynamic")):
            ex = MegakernelExecutor(plan, cfg, device="cpu")
            out = ex.run_once(pb)
            assert ex.pipeline_counters()["event_wait_violations"] == 0
            if first is None:
                first = out
            for name, v in out.items():
                assert torch.equal(v, first[name]), (w, plan.scheduler,
                                                     name)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_programs_on_embeddings_agree(arch):
    """The megakernel Program (plain version, dynamic, W=2) against the
    torch Program on the same weights: a ragged prefill of embedding
    chunks, then four steps of one embedding row per request, within
    3e-4.  ``step`` with text-mode positions given as (B, 3) columns (or
    as (B,)) equals ``step`` without them, bitwise."""
    cfg = _cfg(arch, 2)
    mk = torch_compile(cfg, B, S, backend="megakernel", device="cpu",
                       num_workers=2, scheduler="dynamic")
    mk.init_weights(torch.Generator().manual_seed(3))
    ref = torch_compile(cfg, B, S, backend="torch", device="cpu") \
        .bind(mk.weight_views())
    mk.init_state()
    ref.init_state()
    rng = np.random.default_rng(2)
    chunk = _embeds(rng, B, 6, cfg.d_model)
    clens = np.array([6, 4])
    np.testing.assert_allclose(mk.prefill(chunk, [0, 0], clens),
                               ref.prefill(chunk, [0, 0], clens), rtol=3e-4,
                               atol=3e-4)
    lens = clens.copy()
    for i in range(4):
        x = _embeds(rng, B, cfg.d_model)
        state = mk.get_state()
        got = mk.step(x, lens)
        pos = np.stack([lens] * 3, -1) if cfg.mrope_sections else lens
        mk.set_state(state)
        assert np.array_equal(mk.step(x, lens, pos), got)
        np.testing.assert_allclose(got, ref.step(x, lens), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
        lens += 1
    assert mk.pipeline_stats["event_wait_violations"] == 0


def test_check_plan_refuses_bad_sections():
    """The kernel takes at most three sections, none negative, that sum
    to hd / 2; M-RoPE rows without sections are refused too."""
    cfg = _cfg("qwen2-vl-2b", 1)
    plan = compile_decode_megakernel(cfg, B, S)
    check_plan(plan.statics, plan.descs)
    for sec in ((8, 4, 5), (4, 4, 4, 4), (), (20, -4, 0)):
        with pytest.raises(NotImplementedError, match="M-RoPE"):
            check_plan(dict(plan.statics, MROPE=sec), plan.descs)


def test_embed_input_has_no_embedding_table():
    """An embedding-input config has no ``embed`` weight; with tied
    embeddings it raises ``ValueError``, as the reference's
    ``init_params`` does; the megakernel heap holds no table."""
    cfg = _cfg("qwen2-vl-2b", 1)
    assert "embed" not in param_specs(cfg) and "lm_head" in param_specs(cfg)
    with pytest.raises(ValueError, match="tied"):
        param_specs(dataclasses.replace(cfg, tie_embeddings=True))
    with pytest.raises(ValueError, match="tied"):
        jax_init_params(dataclasses.replace(cfg, tie_embeddings=True),
                        jax.random.PRNGKey(0))
    plan = compile_decode_megakernel(cfg, B, S)
    assert "embed" not in plan.layout and 8 not in set(plan.descs[:, 0])
