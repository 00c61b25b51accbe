"""gemma-7b in the port's megakernel at the widths the card serves.

gemma-7b ties its LM head to the embedding (256,000 columns), so its
plan's widest matmul tile is 5,376 columns: wider than one pass of the
CUDA kernel's matmul (``MM_PASS``, 4,096 columns), which then runs the
tile as passes over column ranges (``mm_passes``).  Here, on the CPU and
without building a full-width heap (a 2-layer gemma-7b heap is 16 GB):
``check_plan`` admits the 2-layer full-width plans of gemma-7b and
mistral-nemo-12b (plans only); and gemma-7b reduced with its vocabulary
widened to ``WIDE_VOCAB`` (at d = 128 the head's tiles are then 4,224
columns wide; the reduced config's own 512 gives 128) lowers to the
reference's descriptor table and runs through the plain megakernel
within 3e-4 of the JAX model.  Its heap is 0.9 G words (3.6 GB), so the
test makes it once, as the Program's own heap.  The CUDA kernel on the
wide tiles and at head_dim 256 is ``test_torch_gpu.py``'s (marked
``gpu``)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import serve_step as jax_serve_step
from repro_torch.api import compile as torch_compile
from repro_torch.configs import get_config
from repro_torch.megakernel import compile_decode_megakernel
from repro_torch.megakernel.kernel import (MAX_TK, MAX_TN, MM_PASS,
                                           _variant, check_plan,
                                           megakernel_plain, mm_passes)
from repro_torch.models import params_from_jax

B, S = 2, 16
#: the smallest round vocabulary above 48 tiles of 4,096 columns (the
#: decomposition's target tile count), so that the head's tiles are wider
#: than one pass
WIDE_VOCAB = 200_000


def _widest_matmul(plan):
    mm = plan.descs[plan.descs[:, 0] == 1]
    chw = min(plan.statics["STORE_CH"], plan.statics["TN"])
    return int(np.minimum(plan.statics["TN"],
                          -(-mm[:, 2] // chw) * chw).max())


@pytest.mark.parametrize("arch", ["gemma-7b", "mistral-nemo-12b"])
def test_check_plan_admits_full_width(arch):
    """Two layers at full width, B = 2, S = 128, the W chip_smoke.py asks
    for on an H100 (132): the plan (no heap) passes ``check_plan``.
    gemma-7b's statics are TN = 5376, TK = 24576 (its d_ff; the x rows
    fit the kernel's shared memory) and HD = 256, and its head tiles are
    wider than one pass, so it takes the kernel's wide instantiation
    (variant 4); mistral-nemo-12b's are not, and it keeps the dense one
    (0)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    plan = compile_decode_megakernel(cfg, 2, 128, num_workers=132)
    check_plan(plan.statics, plan.descs)
    widest = _widest_matmul(plan)
    if arch == "gemma-7b":
        st = plan.statics
        assert (st["TN"], st["TK"], st["HD"]) == (5376, 24576, 256)
        assert st["TK"] <= MAX_TK
        assert widest == st["MM_WIDTH"] == 5376 > MM_PASS
        assert mm_passes(widest) == [(0, 2688), (2688, 5376)]
        assert _variant(st) == 4
    else:
        assert widest <= MM_PASS and _variant(plan.statics) == 0


@pytest.mark.parametrize("ws,want", [
    (4096, [(0, 4096)]),                # one pass, as before
    (4099, [(0, 4099)]),                # 1024 groups and the tail
    (4224, [(0, 2112), (2112, 4224)]),  # WIDE_VOCAB's head tile
    (5376, [(0, 2688), (2688, 5376)]),  # gemma-7b's head tile
    (8195, [(0, 4096), (4096, 8195)]),  # the tail rides the last pass
    (12292, [(0, 3076), (3076, 6152), (6152, 9228), (9228, 12292)]),
])
def test_mm_passes(ws, want):
    """The plain version cuts a matmul tile into the CUDA kernel's passes
    (``mm_wide``): at most ``MM_PASS`` columns each, float4 groups split
    evenly, each pass wider than half a pass (so the kernel keeps K whole
    in every one), the columns past the whole groups in the last."""
    got = mm_passes(ws)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == ws
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(c1 - c0 <= MM_PASS + 3 for c0, c1 in got)
    if len(got) > 1:
        assert all(c1 - c0 > MM_PASS // 2 for c0, c1 in got)


def _ref_cfg(layers=1):
    return dataclasses.replace(ref_get_config("gemma-7b").reduced(),
                               n_layers=layers, vocab=WIDE_VOCAB)


@pytest.fixture(scope="module")
def gemma():
    """gemma-7b reduced (d = 128, heads of 32) with its vocabulary widened
    to ``WIDE_VOCAB``, one layer, and its JAX parameters as numpy
    arrays."""
    cfg = _ref_cfg()
    jp = jax_init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, jp)


def test_wide_vocab_lowering_matches_reference(gemma):
    """The port lowers the reduced model with the widened vocabulary to the
    reference's descriptor table (int32 → int64) and layout, with head
    tiles wider than one pass, and ``check_plan`` admits it at W = 1 and
    W = 4; a plan that needs the extended kernel (a top-k) is refused
    such tiles."""
    cfg, _ = gemma
    ref = ref_compile(cfg, B, S)
    port = compile_decode_megakernel(cfg, B, S)
    assert np.array_equal(port.descs, ref.descs.astype(np.int64))
    assert port.heap_size == ref.heap_size
    assert {n: (s.offset, s.ld, s.shape) for n, s in port.layout.items()} \
        == {n: (s.offset, s.ld, s.shape) for n, s in ref.layout.items()}
    assert _widest_matmul(port) == 4224 > MM_PASS
    check_plan(port.statics, port.descs)
    check_plan(*(lambda p: (p.statics, p.descs))(
        compile_decode_megakernel(cfg, B, S, num_workers=4)))
    with pytest.raises(NotImplementedError, match="wider than one pass"):
        check_plan(dict(port.statics, TOPK=2), port.descs)


def test_wide_vocab_plain_megakernel_matches_jax(gemma):
    """Four decode steps through the megakernel Program (the plain
    version on a CPU heap, the head's 4,224-column tiles cut into the
    kernel's passes) against JAX ``serve_step``: logits within 3e-4, the
    reference's megakernel-vs-oracle tolerance, and the KV caches."""
    cfg, np_tree = gemma
    prog = torch_compile(cfg, B, S, backend="megakernel", device="cpu")
    prog.bind(params_from_jax(np_tree, cfg, device="cpu")).init_state()
    jp = jax.tree.map(jnp.asarray, np_tree)
    jcache = jax_init_cache(cfg, B, S, dtype=jnp.float32)
    jstep = jax.jit(jax_serve_step, static_argnums=1)
    rng = np.random.default_rng(0)
    lens = np.array([0, 3], np.int32)
    toks = rng.integers(1, cfg.vocab, size=B).astype(np.int32)
    for i in range(4):
        got = prog.step(toks, lens)
        ref, jcache = jstep(jp, cfg, jcache, jnp.asarray(toks),
                            jnp.asarray(lens))
        assert got.shape == (B, WIDE_VOCAB)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
        toks = np.asarray(ref).argmax(-1).astype(np.int32)
        lens += 1
    state = prog.get_state()
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jcache[key]), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("ws", [4224, 5376, 8195])
def test_plain_matmul_passes_match_one_product(ws):
    """The plain version's matmul over the kernel's passes computes the
    whole tile's product, on a heap of a few million words built for one
    descriptor row: a tile ``ws`` columns wide (K = 96, TN = ws) against
    one torch product within 1e-5, without and with a bias and the tanh
    GELU; the store touches no column past the tile."""
    k, m = 96, 2
    rng = np.random.default_rng(ws)
    x_off, w_off, b_off = 0, 2 * k, 2 * k + k * (ws + 4)
    y_off = b_off + ws
    heap = torch.from_numpy(rng.standard_normal(
        y_off + m * (ws + 4) + 64, dtype=np.float32))
    tile = lambda off, ld, r, c: torch.as_strided(heap, (r, c), (ld, 1),
                                                  off)
    x, wt = tile(x_off, k, m, k).clone(), tile(w_off, ws + 4, k, ws).clone()
    bias = heap[b_off:b_off + ws].clone()
    row = np.zeros(36, np.int64)
    row[:10] = (1, m, ws, k, y_off, ws + 4, x_off, k, w_off, ws + 4)
    row[10], row[14] = -1, 0
    row[32:35] = -1                     # no event words
    gelu = row.copy()
    gelu[10], gelu[14] = b_off, 2
    statics = {"TN": ws, "TK": k, "HD": 32, "G": 1, "W": 1, "STORE_CH": 128,
               "THETA": 10000.0, "EVENT_OFF": 0, "N_EVENTS": 0,
               "STATS_OFF": heap.numel() - 12}
    for d, want in ((row, x @ wt),
                    (gelu, torch.nn.functional.gelu(x @ wt + bias,
                                                    approximate="tanh"))):
        out = tile(y_off, ws + 4, m, ws + 1)
        past = out[:, ws].clone()
        megakernel_plain(heap, d[None], statics)
        torch.testing.assert_close(out[:, :ws], want, rtol=1e-5, atol=1e-5)
        assert torch.equal(out[:, ws], past)
    assert MAX_TN == MM_PASS            # the expert GEMM keeps one pass
