"""The static megakernel's walk lists (``desc.walk_lists``, the port-only
side table ``MegakernelPlan.walk``) and the compacted walk of the plain
version, on the CPU: every real row in its lane's list once, in step
order, and no pad, for the dense, MoE, SSM and embedding-input (qwen2-vl)
plans at W ∈ {1, 2, 4} and a TP=2 stamp; the plain version's heap over
the lists bitwise its heap over the whole grid, counter blocks included;
a traced run walking every slot; one compacted run against the
reference's Pallas megakernel in interpret mode; and the standalone
rmsnorm's plain version against the reference's kernel on contiguous,
strided and unaligned rows and a width that is not a multiple of 4.

Tolerances: the reference's megakernel-vs-interpreter 2e-4 against the
interpret heap, and ``tests/test_kernels.py``'s 1e-5 / 3e-2 (f32 / bf16)
for rmsnorm.  The CUDA kernel's compacted walk against its full walk is
``tests/test_torch_gpu.py``'s."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel,
                                    megakernel_plain)
from repro_torch.megakernel.ops import read_stats_block

B, S = 2, 16
FAMILIES = {"dense": "deepseek-7b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-2.7b", "embed": "qwen2-vl-2b"}
CASES = [(f, w, 1) for f in FAMILIES for w in (1, 2, 4)] + [("dense", 2, 2)]

_RUNS = {}


def _cfg(family, layers=1):
    return dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                               n_layers=layers)


def _run(family, workers, tp):
    """(plan, heap after the executor's launch (the compacted walk), heap
    after the plain version's full walk from the same image), once per
    case."""
    key = (family, workers, tp)
    if key not in _RUNS:
        cfg = _cfg(family)
        plan = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                         tp=tp)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        ex.init_weights(torch.Generator().manual_seed(3))
        rng = np.random.default_rng(1)
        inputs = (rng.standard_normal((B, cfg.d_model)).astype(np.float32)
                  if cfg.embed_input else rng.integers(1, cfg.vocab, B))
        ex.write_step_inputs(inputs, np.array([1, 4]))
        full = ex.heap.clone()
        ex.launch()
        megakernel_plain(full, plan.descs, plan.statics, acks=plan.acks)
        _RUNS[key] = plan, ex.heap, full
    return _RUNS[key]


@pytest.mark.parametrize("family,workers,tp", CASES)
def test_walk_lists_hold_every_real_row_once(family, workers, tp):
    """W + 1 offsets, then each lane's slots: every slot of lane w is
    ``s * W + w``, in rising step order, and the lists together are
    exactly the grid's rows that wait, signal or run a task."""
    plan = compile_decode_megakernel(_cfg(family), B, S,
                                     num_workers=workers, tp=tp)
    W, d = plan.num_workers, plan.descs
    assert W == workers * tp
    offsets, slots = plan.walk[:W + 1], plan.walk[W + 1:]
    assert offsets[0] == 0 and offsets[-1] == slots.size
    real = (d[:, 0] != 0) | (d[:, 32] >= 0) | (d[:, 34] >= 0)
    for w in range(W):
        lane = slots[offsets[w]:offsets[w + 1]]
        assert (lane % W == w).all()
        assert (np.diff(lane) > 0).all()
    assert np.array_equal(np.sort(slots), np.flatnonzero(real))
    assert real.sum() < d.shape[0]


@pytest.mark.parametrize("family,workers,tp", CASES)
def test_compacted_walk_bitwise_full_walk(family, workers, tp):
    """One step from one heap image: the executor's launch (the plain
    version over the walk lists) and the plain version over the whole
    grid leave every word of the heap equal."""
    _, compact, full = _run(family, workers, tp)
    assert torch.equal(compact.view(torch.int32), full.view(torch.int32))


@pytest.mark.parametrize("family,workers,tp",
                         [(f, 4, 1) for f in FAMILIES] + [("dense", 2, 2)])
def test_compacted_walk_keeps_the_counter_blocks(family, workers, tp):
    """Each worker's counter block after the compacted walk is the full
    walk's: the tile transfers, and the waits and signals its grid column
    holds, with no violation."""
    plan, compact, full = _run(family, workers, tp)
    W = plan.num_workers
    got = read_stats_block(compact, plan.stats_offset, W)
    assert got == read_stats_block(full, plan.stats_offset, W)
    lane = np.arange(plan.descs.shape[0]) % W
    for w, c in enumerate(got):
        assert c["event_wait_violations"] == 0
        assert c["event_waits"] == int((plan.descs[lane == w, 32] >= 0).sum())
        assert c["event_signals"] == int(
            (plan.descs[lane == w, 34] >= 0).sum())
    assert sum(c["bulk_copies"] for c in got) > 0


def test_traced_run_walks_every_slot():
    """With the trace ring on, the lists are not used: the ring holds a
    record for every grid slot, pads included, with every tick once, and
    the heap before the ring equals the untraced compacted run's."""
    cfg = _cfg("dense", 2)
    traced = compile_decode_megakernel(cfg, B, S, num_workers=4, trace=True)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=4)
    heaps = []
    for p in (plan, traced):
        ex = MegakernelExecutor(p, cfg, device="cpu")
        ex.init_weights(torch.Generator().manual_seed(3))
        ex.write_step_inputs(np.array([3, 7]), np.array([1, 4]))
        ex.launch()
        heaps.append(ex)
    ring = heaps[1].task_ring()
    n = traced.descs.shape[0]
    assert ring.shape[0] == n > traced.walk.size - traced.num_workers - 1
    assert np.array_equal(ring[:, 1], np.arange(n))
    ticks = np.sort(np.concatenate([ring[:, 3], ring[:, 4]]))
    assert np.array_equal(ticks, np.arange(2 * n))
    lo = plan.heap_size
    assert torch.equal(heaps[0].heap[:lo], heaps[1].heap[:lo])


def test_compacted_walk_matches_pallas_interpret():
    """The plain version over the walk lists at W = 4 against the
    reference's Pallas megakernel in interpret mode from the same
    bindings: every output within 2e-4, and the per-worker waits,
    violations and signals equal."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.core.lowering import decode_bindings as ref_bindings
    from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
    from repro.kernels.megakernel.ops import \
        compile_decode_megakernel as ref_compile
    from repro.models import init_cache, init_params
    from repro_torch.core.lowering import decode_bindings
    from repro_torch.models import params_from_jax

    cfg = dataclasses.replace(ref_config("deepseek-7b").reduced(),
                              n_layers=1)
    tree = jax.tree.map(np.asarray, init_params(
        cfg, jax.random.PRNGKey(5), dtype=jnp.float32))
    rng = np.random.default_rng(7)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
             for k, v in jax.tree.map(np.asarray, init_cache(
                 cfg, B, S, dtype=jnp.float32)).items()}
    toks, lens = np.array([3, 7], np.int32), np.array([1, 4], np.int32)
    ref_ex = RefExecutor(ref_compile(cfg, B, S, num_workers=4), cfg)
    ref = ref_ex.run_once(ref_bindings(cfg, tree, cache, toks, lens))
    plan = compile_decode_megakernel(cfg, B, S, num_workers=4)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    got = ex.run_once(decode_bindings(
        cfg, params_from_jax(tree, cfg, device="cpu"),
        {k: torch.from_numpy(v) for k, v in cache.items()}, toks, lens))
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    keys = ("event_waits", "event_wait_violations", "event_signals")
    assert [{k: c[k] for k in keys} for c in ex.worker_counters()] \
        == [{k: c[k] for k in keys} for c in ref_ex.worker_counters()]


def _rmsnorm_input(layout, dtype, rows=128, d=256):
    """x (rows, d) and w as seeded numpy f32 arrays, and x as the torch
    tensor of ``layout``: contiguous, strided (every other column of a
    wider tensor), unaligned (one element past a 16-byte boundary) or
    row-padded (a row stride of d + 1)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    big = torch.zeros((rows, 2 * d + 1), dtype=dtype)
    if layout == "strided":
        xt = big[:, :2 * d:2]
    elif layout == "unaligned":
        xt = big.reshape(-1)[1:1 + rows * d].view(rows, d)
    elif layout == "row_pad":
        xt = big.reshape(-1)[:rows * (d + 1)].view(rows, d + 1)[:, :d]
    else:
        xt = big[:, :d].contiguous()
    xt.copy_(torch.from_numpy(x))
    return x, w, xt, torch.from_numpy(w).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,d", [
    ("contiguous", 256), ("strided", 256), ("unaligned", 256),
    ("row_pad", 256), ("contiguous", 130)])
def test_rmsnorm_plain_layouts_match_reference(layout, d, dtype):
    """The port's ``rmsnorm`` on the CPU (its plain version) over rows laid
    out as the CUDA kernel's vector and scalar paths take them, against
    the reference's Pallas kernel in interpret mode on the same values,
    within tests/test_kernels.py's tolerance."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import kernels as jk
    from repro_torch import kernels as tk
    tdt = getattr(torch, dtype)
    x, w, xt, wt = _rmsnorm_input(layout, tdt, d=d)
    assert xt.is_contiguous() == (layout in ("contiguous", "unaligned"))
    assert (xt.data_ptr() % 16 != 0) == (layout == "unaligned")
    got = tk.rmsnorm(xt, wt)
    assert got.dtype == tdt and got.shape == xt.shape and got.is_contiguous()
    want = jk.rmsnorm(jnp.asarray(x).astype(dtype),
                      jnp.asarray(w).astype(dtype))
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
