"""The port's megakernel against the reference: the lowering (descriptor
table and heap image), the plain PyTorch version of the kernel against
the JAX model oracle and the interpret-mode Pallas kernel.  The CUDA
kernel against its plain version is ``test_torch_gpu.py``."""
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
from repro.models import serve_step as jax_serve_step
from repro_torch.api import compile as torch_compile
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel, launch_count,
                                    megakernel, megakernel_plain)
from repro_torch.models import params_from_jax

B, S = 2, 16


def _setup(layers, seed=5, arch="deepseek-7b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    jp = jax_init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, jp)


def _bindings(cfg, np_tree, device="cpu"):
    """The same inputs as reference and port bindings."""
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    toks = np.array([3, 7], np.int32)
    if cfg.embed_input:                 # the (B, D) embeddings h0
        toks = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    lens = np.array([1, 4], np.int32)
    ref = ref_decode_bindings(cfg, np_tree, jcache, toks, lens)
    tcache = {k: torch.from_numpy(v).to(device) for k, v in jcache.items()}
    port = decode_bindings(cfg, params_from_jax(np_tree, cfg, device=device),
                           tcache, toks, lens)
    return ref, port


@pytest.mark.parametrize("arch,layers", [
    ("deepseek-7b", 1), ("deepseek-7b", 2),
    ("gemma-7b", 1),         # √d scale-add, (1 + w) norm, GeGLU, tied head
    ("qwen1.5-110b", 1),     # QKV bias
    ("qwen2-vl-2b", 1),      # h0 input, (B, 3) positions, M-RoPE, bias
    ("musicgen-large", 1),   # h0 input, GeGLU
])
def test_lowering_matches_reference(arch, layers):
    """Same config → the same descriptor table (int32 → int64), the same
    layout, and a bitwise-equal heap image from the same inputs."""
    cfg, np_tree = _setup(layers, arch=arch)
    ref = ref_compile(cfg, B, S)
    port = compile_decode_megakernel(cfg, B, S)
    assert port.descs.dtype == np.int64
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert port.heap_size == ref.heap_size
    assert port.stats_offset == ref.stats_offset
    for k in ("TN", "TM", "TK", "HD", "G", "STORE_CH", "NG", "S_MAX",
              "MROPE"):
        assert port.statics[k] == ref.statics[k], k
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    rb, pb = _bindings(cfg, np_tree)
    ref_heap = ref.build_heap(rb)
    port_heap = port.build_heap(pb, "cpu").numpy()
    assert np.array_equal(port_heap.view(np.int32), ref_heap.view(np.int32))


@pytest.mark.parametrize("arch,layers", [
    ("deepseek-7b", 2), ("gemma-7b", 1),
    ("qwen2-vl-2b", 2), ("musicgen-large", 1),   # seeded embeddings
])
def test_plain_megakernel_matches_jax_serve_step(arch, layers):
    """Eight decode steps through the megakernel Program (plain version
    on the CPU heap) against JAX ``serve_step``: logits within 3e-4, the
    reference's megakernel-vs-oracle tolerance.  An embedding-input
    config takes a seeded (B, D) embedding row per step."""
    cfg, np_tree = _setup(layers, arch=arch)
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu")
    prog.bind(params_from_jax(np_tree, cfg, device="cpu")).init_state()
    jp = jax.tree.map(jnp.asarray, np_tree)
    jcache = jax_init_cache(cfg, B, S, dtype=jnp.float32)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    rng = np.random.default_rng(0)
    lens = np.array([0, 3], np.int32)
    def embeds():
        return rng.standard_normal((B, cfg.d_model)).astype(np.float32)

    toks = embeds() if cfg.embed_input \
        else rng.integers(1, cfg.vocab, size=B).astype(np.int32)
    for i in range(8):
        got = prog.step(toks, lens)
        ref, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                            jnp.asarray(lens))
        np.testing.assert_allclose(got, np.asarray(ref), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
        toks = embeds() if cfg.embed_input \
            else np.asarray(ref).argmax(-1).astype(np.int32)
        lens += 1
    state = prog.get_state()
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jcache[key]), rtol=3e-4,
                                   atol=3e-4)
    assert prog.upload_count == 1 and prog.step_count == 8
    counters = prog.pipeline_stats
    assert counters["primary_fallbacks"] > 0
    assert counters["event_wait_violations"] == 0


def test_plain_megakernel_matches_pallas_interpret():
    """One layer, one step: the plain version against the reference's
    Pallas megakernel in interpret mode, every output (logits and the
    written KV caches) within 2e-4."""
    cfg, np_tree = _setup(1)
    rb, pb = _bindings(cfg, np_tree)
    ref = RefExecutor(ref_compile(cfg, B, S), cfg).run_once(rb)
    got = MegakernelExecutor(compile_decode_megakernel(cfg, B, S), cfg,
                             device="cpu").run_once(pb)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_cpu_heap_runs_plain_version_and_counts_no_launch():
    """On a CPU heap the wrapper runs the plain version and launches
    nothing: the launch count stays where it was."""
    cfg, np_tree = _setup(1)
    _, pb = _bindings(cfg, np_tree)
    plan = compile_decode_megakernel(cfg, B, S)
    heap = plan.build_heap(pb, "cpu")
    ref = heap.clone()
    before = launch_count()
    megakernel(heap, torch.from_numpy(plan.descs), plan.statics)
    megakernel_plain(ref, plan.descs, plan.statics)
    assert launch_count() == before
    assert torch.equal(heap, ref)
