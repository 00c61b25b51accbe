"""The port's plain megakernel on stamped multichip plans: against the
reference's Pallas megakernel in interpret mode (deepseek-7b reduced at
TP=2, granite-moe reduced at TP=4, one layer: two interpret runs, about
50 s), bitwise across TP ∈ {1, 2, 4}, W and chips for the dense and the
MoE family, the chip regions' isolation, and a served
``Program(tp=2)`` against ``Program(tp=1)``.

Tolerance 2e-4 against the interpret heap (the reference's
megakernel-vs-interpreter tolerance); integer words (event counters,
transfer counts) bitwise; the port against itself bitwise: the
owner-masked ring adds zeros, so TP changes no bit."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config
from repro.core.lowering import decode_bindings as ref_decode_bindings
from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.api import compile as torch_compile
from repro_torch.core.lowering import decode_bindings
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.models import params_from_jax
from repro_torch.runtime import Request, ServingEngine

B, S = 2, 16
TOKS = np.array([3, 7], np.int32)
LENS = np.array([1, 4], np.int32)


def _cfg(arch="deepseek-7b", layers=1):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    if cfg.n_experts:                   # the megakernel is dropless
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _bindings(cfg, seed=5):
    """The same weights and a random cache as reference and port
    bindings."""
    tree = jax.tree.map(np.asarray, jax_init_params(
        cfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    jcache = jax.tree.map(np.asarray, jax_init_cache(cfg, B, S,
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(7)
    jcache = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in jcache.items()}
    ref = ref_decode_bindings(cfg, tree, jcache, TOKS, LENS)
    port = decode_bindings(cfg, params_from_jax(tree, cfg, device="cpu"),
                           {k: torch.from_numpy(v) for k, v in jcache.items()},
                           TOKS, LENS)
    return ref, port


def _collectives(plan):
    return [(op.outputs[0], op.inputs[0]) for op in plan.compiled.graph.ops
            if op.kind == "allreduce"]


@pytest.mark.parametrize("arch,tp,workers", [
    ("deepseek-7b", 2, 1), ("granite-moe-1b-a400m", 4, 2)])
def test_plain_tp_matches_pallas_interpret(arch, tp, workers):
    """Deepseek at TP=2, W=1 and granite at TP=4, W=2 (three ring rounds
    a phase through one staging buffer): every output of every chip
    within 2e-4 of the interpret heap, the collectives' outputs bitwise
    their inputs on every chip, the staging buffers within 2e-4, the
    event counters and, per worker lane, the transfers and their rows,
    waits, signals and violations bitwise (the reference counts a
    primary tile when it prefetches it, the port when it demand-loads
    it)."""
    cfg = _cfg(arch)
    rb, pb = _bindings(cfg)
    ref = RefExecutor(ref_compile(cfg, B, S, tp=tp, num_workers=workers),
                      cfg)
    ref_out = ref.run_once(rb)
    plan = compile_decode_megakernel(cfg, B, S, tp=tp, num_workers=workers)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    out = ex.run_once(pb)
    assert set(out) == set(ref_out)
    heap, ref_heap = ex.heap.numpy(), np.asarray(ref._heap)
    for name in ref_out:
        for c in range(tp):
            np.testing.assert_allclose(
                plan.read_output(ex.heap, name, c).numpy(),
                ref.plan.read_output(ref_heap, name, c), rtol=2e-4,
                atol=2e-4, err_msg=f"{name} chip {c}")
    assert len(_collectives(plan)) == 2
    for o, i in _collectives(plan):
        for c in range(tp):
            assert torch.equal(plan.view(ex.heap, o, c),
                               plan.view(ex.heap, i, c)), (o, c)
            np.testing.assert_allclose(
                plan.read_output(ex.heap, o, c).numpy(),
                ref.plan.read_output(ref_heap, o, c), rtol=2e-4, atol=2e-4)
    lo = plan.event_offset
    ev = lo + plan.num_events
    assert np.array_equal(heap[lo:ev].view(np.int32),
                          ref_heap[lo:ev].view(np.int32))
    np.testing.assert_allclose(heap[ev:plan.stats_offset],
                               ref_heap[ev:plan.stats_offset], rtol=2e-4,
                               atol=2e-4)
    got, want = ex.worker_counters(), ref.worker_counters()
    assert len(got) == len(want) == tp * workers
    for g, w in zip(got, want):
        for k in ("bulk_copies", "row_copies", "event_waits",
                  "event_wait_violations", "event_signals"):
            assert g[k] == w[k], k
        assert g["primary_fallbacks"] \
            == w["primary_fallbacks"] + w["prefetch_tiles"]
    # each chip's arrival counters hold C - 1 arrivals a phase
    assert (heap[plan.ctl_offset:plan.heap_size] == tp - 1).all()


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_plain_bitwise_across_tp_workers_and_chips(arch):
    """TP ∈ {1, 2, 4} × W ∈ {1, 2}: logits and every cache bitwise equal
    to TP=1, W=1 on every chip, 0 violations."""
    cfg = _cfg(arch)
    _, pb = _bindings(cfg)
    base = None
    for tp in (1, 2, 4):
        for w in (1, 2):
            plan = compile_decode_megakernel(cfg, B, S, num_workers=w, tp=tp)
            ex = MegakernelExecutor(plan, cfg, device="cpu")
            ex.run_once(pb)
            names = ["logits"] + plan.input_classes()["state"]
            for c in range(plan.n_chips):
                got = {n: plan.view(ex.heap, n, c) for n in names}
                base = base or {n: v.clone() for n, v in got.items()}
                for n in names:
                    assert torch.equal(got[n], base[n]), (tp, w, c, n)
            assert ex.pipeline_counters()["event_wait_violations"] == 0


def test_plain_tp2_chip_isolation():
    """Chip 1's wq scaled by 1 + 2^-10 in the heap moves both chips'
    logits (chip 1's owned chunks reach chip 0 through the ring), which
    stay bitwise equal to each other."""
    cfg = _cfg()
    _, pb = _bindings(cfg)
    plan = compile_decode_megakernel(cfg, B, S, tp=2)
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    heap = plan.build_heap(pb, "cpu")
    ex.upload(heap.clone())
    clean = ex.step(TOKS, LENS).clone()
    plan.view(heap, "L0.wq", 1).mul_(1.0009765625)
    ex.upload(heap)
    ex.step(TOKS, LENS)
    c0, c1 = (plan.view(ex.heap, "logits", c) for c in (0, 1))
    assert not torch.equal(c0, clean) and not torch.equal(c1, clean)
    assert torch.equal(c0, c1)


def _serve(prog):
    eng = ServingEngine(prog, chunk=4)
    rng = np.random.default_rng(11)
    for i, n in enumerate((3, 6, 9)):
        eng.submit(Request(i, rng.integers(1, 200, size=n).tolist(),
                           max_new_tokens=4))
    done = eng.run()
    return {r.request_id: r.output for r in done}, eng.decode_iterations


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_served_tp2_program_bitwise_tp1(arch):
    """A ``Program(tp=2)`` served through the engine (chunked prefill
    through torch on chip 0's weights, written into both chips' regions,
    then decode steps in the kernel) gives the token streams and the
    per-step logits of ``Program(tp=1)`` bitwise; every chip's state is
    chip 0's."""
    cfg = _cfg(arch, layers=2)
    gen = lambda: torch.Generator().manual_seed(0)
    runs = {}
    for tp in (1, 2):
        prog = torch_compile(cfg, B, 32, backend="megakernel", device="cpu",
                             num_workers=2, tp=tp)
        prog.init_weights(gen()).init_state()
        steps = []
        step = prog.step
        prog.step = lambda *a, **k: steps.append(step(*a, **k)) or steps[-1]
        runs[tp] = _serve(prog) + (steps,)
        plan = prog.plan
        for n in plan.input_classes()["state"]:
            for c in range(1, plan.n_chips):
                assert torch.equal(plan.view(prog.executor.heap, n, c),
                                   plan.view(prog.executor.heap, n, 0)), n
    (out1, it1, st1), (out2, it2, st2) = runs[1], runs[2]
    assert out1 == out2 and it1 == it2 and len(st1) == it1 > 0
    for a, b in zip(st1, st2):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
