"""The port's torch model against the JAX model oracle: the same numpy
weights and tokens through ``repro.models`` and ``repro_torch.models``.

Tolerance 1e-5: both run float32 on the CPU; only the summation order of
the matrix products differs."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import serve_step as jax_serve_step
from repro.models.layers import decode_attention as jax_decode_attention
from repro.models.layers import glu as jax_glu
from repro_torch.models import (init_cache, params_from_jax, prefill_chunk,
                                serve_step)
from repro_torch.models.layers import decode_attention, glu

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch, layers, seed=0):
    """The reference's weights, as JAX arrays and as the port's dict; qkv
    biases (which the reference initialises to zero) redrawn so that a
    dropped bias shows."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    np_tree = jax.tree.map(np.asarray, jp)
    attn = np_tree["blocks"].get("attn", {})
    rng = np.random.default_rng(seed)
    for nm in ("bq", "bk", "bv"):
        if nm in attn:
            attn[nm] = (rng.standard_normal(attn[nm].shape) * 0.1) \
                .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_tree)
    return cfg, jp, params_from_jax(np_tree, cfg, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _assert_cache(jcache, tcache):
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]),
                                   **TOL)


@pytest.mark.parametrize("arch,layers", [
    ("deepseek-7b", 2), ("gemma-7b", 1),
    ("qwen2-vl-2b", 2),      # embedding input, M-RoPE, qkv bias
    ("musicgen-large", 1),   # embedding input, GELU
])
def test_greedy_decode_and_chunked_prefill_match_jax(arch, layers):
    """One 16-token chunked prefill (ragged chunk lengths), then an
    8-step greedy decode loop: logits and caches at every step.  An
    embedding-input config takes seeded embeddings for the chunk and for
    each step in place of tokens."""
    cfg, jp, tp = _setup(arch, layers)
    b, s = 2, 32
    jcache = jax_init_cache(cfg, b, s, dtype=jnp.float32)
    tcache = init_cache(cfg, b, s, device="cpu")
    rng = np.random.default_rng(1)
    if cfg.embed_input:
        chunk = rng.standard_normal((b, 16, cfg.d_model)).astype(np.float32)
    else:
        chunk = rng.integers(1, cfg.vocab, size=(b, 16)).astype(np.int32)
    lens = np.zeros((b,), np.int32)
    clens = np.array([16, 11], np.int32)

    jl, jcache = jax.jit(jax_prefill_chunk, static_argnums=1)(
        jp, cfg, jcache, jnp.asarray(chunk), jnp.asarray(lens),
        jnp.asarray(clens))
    tl, tcache = prefill_chunk(tp, cfg, tcache, torch.from_numpy(chunk),
                               torch.from_numpy(lens),
                               torch.from_numpy(clens))
    for r in range(b):   # padding positions' logits are garbage by contract
        np.testing.assert_allclose(_np(tl)[r, :clens[r]],
                                   np.asarray(jl)[r, :clens[r]], **TOL)
    _assert_cache(jcache, tcache)

    def next_input(last_logits):        # greedy token, or an embedding
        if cfg.embed_input:
            return rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        return last_logits.argmax(-1).astype(np.int32)

    lens = clens.copy()
    toks = next_input(np.asarray(jl)[np.arange(b), clens - 1])
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    for step in range(8):
        jl, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                           jnp.asarray(lens))
        tl, tcache = serve_step(tp, cfg, tcache, torch.from_numpy(toks),
                                torch.from_numpy(lens))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        _assert_cache(jcache, tcache)
        toks = next_input(np.asarray(jl))
        lens += 1


def test_decode_attention_matches_jax():
    """GQA decode attention (4 query heads over 2 KV heads) with ragged
    live lengths."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 32)).astype(np.float32)
    k = rng.standard_normal((3, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((3, 16, 2, 32)).astype(np.float32)
    lens = np.array([1, 9, 16], np.int32)
    ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lens))
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_glu_matches_jax(activation):
    """The fused gate/up GLU, SwiGLU and GeGLU (tanh GELU)."""
    h = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    ref = jax_glu(jnp.asarray(h), activation)
    np.testing.assert_allclose(_np(glu(torch.from_numpy(h), activation)),
                               np.asarray(ref), **TOL)
