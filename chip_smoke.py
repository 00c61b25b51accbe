#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Drives the port's main path on the card, imports nothing of JAX or of the
JAX package, and fails (non-zero exit, no result line) on any fault:

1. prints the card's name and power limit, then builds the CUDA
   megakernel from ``src/repro_torch/megakernel/csrc`` for sm_90a;
2. full-width deepseek-7b cut to 2 layers (B=2, S=128): one decode step
   through the kernel and through its plain PyTorch version on one heap
   image — logits within 2e-4, the embedding and the KV cache-update
   copies bitwise, the kernel's counters equal;
3. the slice itself: full 30-layer deepseek-7b (B=2, S=128, random
   weights drawn from a seeded generator straight into the heap).  A
   ``ServingEngine`` answers 4 requests (16-token prompts, 8 new tokens)
   with every decode step one kernel launch; the same calls are then
   teacher-forced through the torch Program, which reads the weights as
   strided views of the same heap, and every decode step's logits are
   held to it within 3e-4.  Then the decode step is timed (CUDA events,
   after warm-up) beside the torch Program's step and the plain version,
   and the kernel's logits at those inputs are held to the plain
   version's within 3e-4; last, each task kind is timed alone;
4. prints one JSON line on the kernels (launches on the main path, error
   against the plain version, times, the bound), the device line last.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
B, S = 2, 128
H100_HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
H100_F32_FLOPS = 67e12             # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def _events_ms(fn, n):
    """Mean milliseconds of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _close(a, b, tol):
    """max |a - b| after checking |a - b| <= tol + tol * |b| everywhere."""
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    err = (a - b).abs()
    assert bool((err <= tol + tol * b.abs()).all()), float(err.max())
    return float(err.max())


def phase_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    from repro_torch.megakernel.build import build_library
    t0 = time.perf_counter()
    path, out = build_library()
    log(f"phase 1 ok: built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  nvcc:", line.strip())


def _check_cache_updates(plan, heap, plain, seq_lens):
    """Each cache update copied its new K/V row exactly, into row
    ``seq_lens[b]`` only: in both heaps the written row equals its source
    bitwise and the kernel's other rows equal the plain version's; the
    new rows agree within 2e-4 across the two (they come out of RoPE and
    a matmul).  Returns the number of cache updates checked."""
    from repro_torch.core.graph import OpKind
    n = 0
    for op in plan.compiled.graph.ops:
        if op.kind != OpKind.CACHE_UPDATE:
            continue
        cache, new = op.inputs[0], op.inputs[1]
        for h in (heap, plain):
            c, v = plan.view(h, cache), plan.view(h, new)
            for b, s in enumerate(seq_lens):
                assert torch.equal(c[b, s], v[b]), (cache, b)
        keep = torch.ones(plan.layout[cache].shape[:2], dtype=torch.bool)
        keep[torch.arange(len(seq_lens)), torch.tensor(seq_lens)] = False
        keep = keep.to(heap.device)
        assert torch.equal(plan.view(heap, cache)[keep],
                           plan.view(plain, cache)[keep]), cache
        _close(plan.view(heap, new), plan.view(plain, new), 2e-4)
        n += 1
    return n


def phase_kernel_vs_plain(cfg):
    """Two layers at full width: the kernel against its plain version."""
    import dataclasses
    from repro_torch.megakernel import (MegakernelExecutor,
                                        compile_decode_megakernel,
                                        launch_count, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.megakernel.ops import read_stats_block
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    t0 = time.perf_counter()
    plan = compile_decode_megakernel(cfg2, B, S)
    ex = MegakernelExecutor(plan, cfg2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ex.init_weights(gen)
    for name in plan.input_classes()["state"]:
        plan.view(ex.heap, name).normal_(0.0, 1.0, generator=gen)
    rng = np.random.default_rng(SEED)
    ex.write_step_inputs(rng.integers(1, cfg.vocab, size=B),
                         np.array([37, 90]))
    plain = ex.heap.clone()
    log(f"  2-layer plan: {plan.descs.shape[0]} tasks, heap "
        f"{plan.heap_size * 4 / 1e9:.2f} GB, statics TN={plan.statics['TN']} "
        f"TM={plan.statics['TM']} TK={plan.statics['TK']} "
        f"({time.perf_counter() - t0:.1f} s)")
    reset_launch_count()
    ex.launch()
    torch.cuda.synchronize()
    launches = launch_count()
    assert launches == 1, launches
    megakernel_plain(plain, plan.descs, plan.statics)
    torch.cuda.synchronize()
    err = _close(plan.view(ex.heap, "logits"), plan.view(plain, "logits"),
                 2e-4)
    assert torch.equal(plan.view(ex.heap, "h0"), plan.view(plain, "h0"))
    n_caches = _check_cache_updates(plan, ex.heap, plain, [37, 90])
    counters = read_stats_block(ex.heap, plan.stats_offset, 1)
    assert counters == read_stats_block(plain, plan.stats_offset, 1)
    log(f"phase 2 ok: kernel vs plain at 2 layers, {launches} launch, "
        f"logits max_err={err:.3e} (<= 2e-4), embedding and {n_caches} "
        f"cache updates bitwise, counters {counters[0]}")
    del ex, plain
    torch.cuda.empty_cache()
    return err


def _record(prog, calls):
    """Log every state-changing Program call with its result."""
    step, prefill, reset = prog.step, prog.prefill, prog.reset_slot

    def rec_step(tokens, seq_lens, positions=None):
        out = step(tokens, seq_lens, positions)
        calls.append(("step", np.array(tokens), np.array(seq_lens), out))
        return out

    def rec_prefill(tokens, seq_lens, chunk_lens=None):
        out = prefill(tokens, seq_lens, chunk_lens)
        calls.append(("prefill", np.array(tokens), np.array(seq_lens),
                      np.array(chunk_lens)))
        return out

    def rec_reset(slot):
        reset(slot)
        calls.append(("reset", slot))

    prog.step, prog.prefill, prog.reset_slot = rec_step, rec_prefill, \
        rec_reset


def _step_work(plan, cfg, lens):
    """Bytes a decode step must move and operations it must do, for these
    live lengths: every weight read once (of the embedding table only the
    B gathered rows), the live KV rows read once, the new KV rows and the
    logits written once; the FLOPs of the matmuls and of attention."""
    from repro_torch.core.graph import OpKind
    g = plan.compiled.graph
    shape = lambda n: plan.layout[n].shape
    weights = [n for n in plan.input_classes()["weights"] if n != "embed"]
    w_elems = sum(int(np.prod(shape(n))) for n in weights)
    mm_elems = sum(int(np.prod(shape(op.inputs[1]))) for op in g.ops
                   if op.kind == OpKind.MATMUL)
    kvd, qd = cfg.n_kv_heads * cfg.hd, cfg.n_heads * cfg.hd
    live = int(np.sum(np.asarray(lens) + 1))
    L = cfg.n_layers
    nbytes = 4 * (w_elems + B * cfg.d_model + 2 * L * live * kvd
                  + 2 * L * B * kvd + B * cfg.vocab)
    flops = 2 * B * mm_elems + 4 * L * live * qd
    return nbytes, flops


KIND_NAMES = ("noop", "matmul", "rmsnorm", "rope", "glu", "resid",
              "attention", "cache_update", "embed")


def _time_by_kind(ex, plan):
    """Kernel time of each task kind alone: the step's descriptor table
    with every other row turned into a noop, one launch after a warm-up.
    The all-noop table is the walk itself (descriptor fetch, barriers).
    Run last: the heap's activations are overwritten with partial
    results."""
    from repro_torch.megakernel import megakernel
    kinds = plan.descs[:, 0]
    out = []
    for code in [0] + sorted(set(kinds.tolist()) - {0}):
        table = plan.descs.copy()
        table[kinds != code, 0] = 0
        dev = torch.from_numpy(table).cuda()
        megakernel(ex.heap, dev, plan.statics)
        ms = _events_ms(lambda: megakernel(ex.heap, dev, plan.statics), 2)
        n = int((kinds == code).sum()) if code else len(kinds)
        out.append(f"{KIND_NAMES[code]} {ms:.2f} ms/{n}")
    return out


def phase_serve(cfg):
    """The slice: full deepseek-7b served through the kernel."""
    from repro_torch.api import compile as mk_compile
    from repro_torch.megakernel import (launch_count, megakernel_plain,
                                        reset_launch_count)
    from repro_torch.runtime import Request, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = mk_compile(cfg, B, S, backend="megakernel")
    plan = prog.plan
    log(f"  30-layer plan: {plan.descs.shape[0]} tasks, heap "
        f"{plan.heap_size * 4 / 1e9:.2f} GB, statics TN={plan.statics['TN']}"
        f" TM={plan.statics['TM']} TK={plan.statics['TK']} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prog.init_weights(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"  weights drawn into the heap in {time.perf_counter() - t0:.1f} s")
    ref = mk_compile(cfg, B, S, backend="torch").bind(prog.weight_views())

    calls = []
    _record(prog, calls)
    eng = ServingEngine(prog, chunk=16)
    rng = np.random.default_rng(SEED)
    for i in range(4):
        eng.submit(Request(i, rng.integers(1, cfg.vocab, size=16).tolist(),
                           max_new_tokens=8))
    reset_launch_count()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_count()
    assert len(done) == 4 and all(len(r.output) == 8 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.output)
    assert launches > 0 and launches == eng.decode_iterations, \
        (launches, eng.decode_iterations)
    log(f"  served 4 requests in {wall:.1f} s: {eng.iterations} iterations,"
        f" {eng.decode_iterations} decode steps, {launches} kernel launches")
    for r in sorted(done, key=lambda r: r.request_id):
        log(f"  req {r.request_id}: {r.output}")

    # teacher-force the same calls through the torch Program
    ref.init_state()
    worst, n_steps = 0.0, 0
    for c in calls:
        if c[0] == "reset":
            ref.reset_slot(c[1])
        elif c[0] == "prefill":
            ref.prefill(c[1], c[2], c[3])
        else:
            got = torch.from_numpy(c[3])
            assert got.shape == (B, cfg.vocab)
            want = torch.from_numpy(ref.step(c[1], c[2]))
            worst = max(worst, _close(got, want, 3e-4))
            n_steps += 1
    log(f"  teacher-forced {n_steps} decode steps through the torch Program:"
        f" max |logits diff| {worst:.3e} (<= 3e-4)")

    # time the decode step, the torch Program's step and the plain version
    ex = prog.executor
    toks, lens = rng.integers(1, cfg.vocab, size=B), np.array([64, 64])
    ex.write_step_inputs(toks, lens)
    ex.launch()                                      # warm-up
    ms = _events_ms(ex.launch, 5)
    step_ms = _events_ms(lambda: prog.step(toks, lens), 3)
    kernel_logits = plan.view(ex.heap, "logits").clone()
    ref.step(toks, lens)                             # warm-up
    library_ms = _events_ms(lambda: ref.step(toks, lens), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megakernel_plain(ex.heap, plan.descs, plan.statics)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err30 = _close(kernel_logits, plan.view(ex.heap, "logits"), 3e-4)
    nbytes, flops = _step_work(plan, cfg, lens)
    bound_ms = 1e3 * max(nbytes / H100_HBM_BYTES_PER_S,
                         flops / H100_F32_FLOPS)
    bound_by = "bytes" if nbytes / H100_HBM_BYTES_PER_S \
        >= flops / H100_F32_FLOPS else "operations"
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  decode step: kernel {ms:.3f} ms, Program.step {step_ms:.3f} ms "
        f"({B / step_ms * 1e3:.2f} tokens/s), torch Program step "
        f"{library_ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP)")
    log(f"  kernel vs plain at 30 layers: logits max_err={err30:.3e}; peak "
        f"memory {peak_gb:.2f} GB")
    log("  kernel time by kind alone (kind ms/tasks; noop = the bare walk "
        "of all rows): " + ", ".join(_time_by_kind(ex, plan)))
    log("phase 3 ok")
    return {"launches": launches, "max_abs_err": err30, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    cfg = get_config("deepseek-7b")
    phase_build()
    err2 = phase_kernel_vs_plain(cfg)
    k = phase_serve(cfg)
    k["max_abs_err"] = max(k["max_abs_err"], err2)
    kernel = {"name": "megakernel", "route": "cuda",
              "source": "src/repro_torch/megakernel/csrc/megakernel.cu",
              "replaces": "src/repro/kernels/megakernel/kernel.py:1175"}
    kernel.update(k)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
