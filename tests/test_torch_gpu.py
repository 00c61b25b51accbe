"""On the card: the hand-written CUDA megakernel against its plain PyTorch
version, at the reduced size (deepseek-7b reduced: GQA with 4 query heads
over 2 KV heads).  Every test here is marked ``gpu`` and skips without a
CUDA device; the file imports no JAX, so it runs where JAX is absent:

    pytest -m gpu tests/test_torch_*.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import compile as torch_compile
from repro_torch.configs import get_config
from repro_torch.core.graph import OpKind
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel, launch_count,
                                    megakernel_plain, reset_launch_count)
from repro_torch.megakernel.ops import read_stats_block

B, S = 2, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(layers):
    return dataclasses.replace(get_config("deepseek-7b").reduced(),
                               n_layers=layers)


def _check_cache_updates(plan, heap, plain, seq_lens):
    """Each cache update copied its new K/V row exactly, into row
    ``seq_lens[b]`` only: in the kernel's heap the written row equals its
    source bitwise and every other row equals the plain version's; the
    new rows themselves agree within 2e-4 (RoPE's cos/sin and the
    matmul's summation order differ in the last bits)."""
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CACHE_UPDATE:
            continue
        cache, new = op.inputs[0], op.inputs[1]
        for h in (heap, plain):
            c, n = plan.view(h, cache), plan.view(h, new)
            for b, s in enumerate(seq_lens):
                assert torch.equal(c[b, s], n[b]), (cache, b)
        mask = torch.ones(plan.layout[cache].shape[:2], dtype=torch.bool)
        mask[torch.arange(len(seq_lens)), torch.tensor(seq_lens)] = False
        mask = mask.to(heap.device)
        assert torch.equal(plan.view(heap, cache)[mask],
                           plan.view(plain, cache)[mask]), cache
        torch.testing.assert_close(plan.view(heap, new),
                                   plan.view(plain, new), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [1, 2])
def test_cuda_kernel_matches_plain_version(cuda, layers):
    """One step on one heap image: logits within 2e-4, the embedding and
    the cache-update copies bitwise, the counters equal, one launch
    counted."""
    cfg = _cfg(layers)
    plan = compile_decode_megakernel(cfg, B, S)
    ex = MegakernelExecutor(plan, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ex.init_weights(gen)
    for name in plan.input_classes()["state"]:
        plan.view(ex.heap, name).normal_(0.0, 1.0, generator=gen)
    ex.write_step_inputs(np.array([3, 7]), np.array([1, 12]))
    plain = ex.heap.clone()
    reset_launch_count()
    ex.launch()
    torch.cuda.synchronize()
    assert launch_count() == 1
    megakernel_plain(plain, plan.descs, plan.statics)
    torch.testing.assert_close(plan.view(ex.heap, "logits"),
                               plan.view(plain, "logits"), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(plan.view(ex.heap, "h0"), plan.view(plain, "h0"))
    _check_cache_updates(plan, ex.heap, plain, [1, 12])
    assert read_stats_block(ex.heap, plan.stats_offset, 1) \
        == read_stats_block(plain, plan.stats_offset, 1)


@pytest.mark.gpu
def test_cuda_program_matches_torch_program(cuda):
    """Eight decode steps through the megakernel Program on the card
    against the torch Program on the same weights, within 3e-4."""
    cfg = _cfg(2)
    mk = torch_compile(cfg, B, S, backend="megakernel")
    mk.init_weights(torch.Generator(device=cuda).manual_seed(4))
    ref = torch_compile(cfg, B, S, backend="torch").bind(mk.weight_views())
    mk.init_state()
    ref.init_state()
    reset_launch_count()
    rng = np.random.default_rng(0)
    lens = np.zeros((B,), np.int32)
    for i in range(8):
        toks = rng.integers(1, cfg.vocab, size=B)
        np.testing.assert_allclose(mk.step(toks, lens), ref.step(toks, lens),
                                   rtol=3e-4, atol=3e-4, err_msg=f"step {i}")
        lens += 1
    assert launch_count() == 8
