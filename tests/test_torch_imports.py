"""The port stands alone: importing it pulls in neither jax nor the
reference package, and its entry points never fall back to the CPU."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
need = ("repro_torch.runtime.dyn_sched", "repro_torch.core.runtime_sim",
        "repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.core.task_semantics", "repro_torch.distributed",
        "repro_torch.distributed.comm_tasks", "repro_torch.kernels",
        "repro_torch.kernels.ref")
missing = [m for m in need if m not in sys.modules]
n = sum(1 for k in sys.modules if k.startswith("repro_torch"))
print("BAD", bad, "MISSING", missing, "N", n)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True).stdout
    assert "BAD [] MISSING [] " in out, out
    assert int(out.split("N")[-1]) > 20, out


def test_compile_without_device_needs_a_card():
    from repro_torch.api import compile
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              n_layers=1)
    if torch.cuda.is_available():
        assert compile(cfg, 1, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compile(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compile(cfg, 1, 8, backend="megakernel")
    assert compile(cfg, 1, 8, device="cpu").device.type == "cpu"


def test_later_slices_raise():
    """The MoE and SSM families are ported: granite and mamba2 compile
    with both backends, and so do the embedding-input backbones
    (qwen2-vl with M-RoPE, musicgen): an ``h0`` input and no embedding
    kind.  The hybrid family (jamba) is a later slice and raises.  W > 1
    workers are ported and compile to a W-worker plan with event
    counters."""
    from repro_torch.api import compile
    from repro_torch.configs import get_config
    moe = get_config("granite-moe-1b-a400m").reduced()
    assert compile(moe, 1, 8, device="cpu").backend == "torch"
    prog = compile(moe, 1, 8, backend="megakernel", device="cpu")
    assert {9, 10, 11} <= set(prog.plan.descs[:, 0].tolist())
    ssm = get_config("mamba2-2.7b").reduced()
    assert compile(ssm, 1, 8, device="cpu").backend == "torch"
    prog = compile(ssm, 1, 8, backend="megakernel", device="cpu")
    assert {12, 13} <= set(prog.plan.descs[:, 0].tolist())
    for name in ("qwen2-vl-2b", "musicgen-large"):
        emb = get_config(name).reduced()
        assert compile(emb, 1, 8, device="cpu").backend == "torch"
        prog = compile(emb, 1, 8, backend="megakernel", device="cpu")
        assert "h0" in prog.plan.input_classes()["per_step"]
        assert 8 not in set(prog.plan.descs[:, 0].tolist())
        assert prog.plan.statics["MROPE"] == tuple(emb.mrope_sections or ())
    later = get_config("jamba-1.5-large-398b").reduced()
    for backend in ("torch", "megakernel"):
        with pytest.raises(NotImplementedError):
            compile(later, 1, 8, backend=backend, device="cpu")
    dense = dataclasses.replace(get_config("deepseek-7b").reduced(),
                                n_layers=1)
    prog = compile(dense, 1, 8, backend="megakernel", device="cpu",
                   num_workers=2)
    assert prog.plan.num_workers == 2 and prog.plan.num_events > 0


@pytest.mark.parametrize("backend", ["torch", "megakernel"])
@pytest.mark.parametrize("workers", [0, -1])
def test_compile_refuses_fewer_than_one_worker(backend, workers):
    """``num_workers < 1`` raises ``ValueError`` on every backend, with
    the reference's message, before anything is compiled."""
    from repro_torch.api import compile
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              n_layers=1)
    with pytest.raises(ValueError,
                       match=f"num_workers must be >= 1, got {workers}"):
        compile(cfg, 2, 16, backend=backend, device="cpu",
                num_workers=workers)


def test_later_lowerings_raise():
    """The multichip stamp is ported for the static scheduler: stamping a
    dynamic plan raises, and so does a plan that asks for the remote-copy
    transport (there is no fallback to the fused one).  The dynamic
    scheduler is ported: it lowers to a flat table with the ready pools in
    the heap.  The trace ring is ported: it is appended to the heap."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile import CompileOptions, megakernelize
    from repro_torch.core.lowering import build_decode_graph
    from repro_torch.megakernel.desc import lower_tgraph, stamp_multichip
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              n_layers=1)
    compiled = megakernelize(build_decode_graph(cfg, 1, 8), CompileOptions())
    dyn = lower_tgraph(compiled, cfg, scheduler="dynamic")
    assert dyn.scheduler == "dynamic" and dyn.statics["DYN"] == 1
    assert dyn.descs.shape[0] == len(compiled.order)
    assert dyn.event_offset < dyn.queue_offset < dyn.qc_offset \
        < dyn.trace_offset < dyn.stats_offset < dyn.ctl_offset
    plain, traced = lower_tgraph(compiled, cfg), \
        lower_tgraph(compiled, cfg, trace=True)
    assert traced.trace and traced.ring_offset == plain.heap_size
    with pytest.raises(NotImplementedError):
        stamp_multichip(dyn, 2)
    static = lower_tgraph(compiled, cfg)
    static.statics["REMOTE_DMA"] = 1
    with pytest.raises(NotImplementedError):
        stamp_multichip(static, 2)
