"""The port's plain megakernel under the dynamic scheduler on the SSM
family (mamba2-2.7b reduced, one layer) against the reference's Pallas
megakernel in interpret mode: after one step every word of the heap tail
bitwise (event counters, pools, cursors, pop trace, counter blocks, the
ring), every output within 2e-4 with the conv windows' copies bitwise,
the pop trace the protocol's sequential replay, and the outputs bitwise
equal to the static scheduler's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent where only the port runs
import torch

from repro.kernels.megakernel import MegakernelExecutor as RefExecutor
from repro.kernels.megakernel.ops import \
    compile_decode_megakernel as ref_compile
from repro.obs import decode_ring as ref_decode_ring
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel)
from repro_torch.obs import check_event_order, decode_ring
from repro_torch.runtime.dyn_sched import replay_sequential
from test_torch_ssm import ssm_cfg
from test_torch_ssm_heap import B, S, check_conv_windows, ssm_bindings


@pytest.fixture(scope="module")
def dyn_steps():
    """One traced dynamic step per W ∈ {1, 2, 4} of the reference's
    interpret megakernel and of the port's plain version, and the port's
    static step, from the same inputs."""
    cfg = ssm_cfg(1)
    rb, pb, _, _ = ssm_bindings(cfg)
    out = {}
    for W in (1, 2, 4):
        ref = RefExecutor(ref_compile(cfg, B, S, num_workers=W,
                                      scheduler="dynamic", trace=True), cfg)
        ref_out = ref.run_once(rb)
        plan = compile_decode_megakernel(cfg, B, S, num_workers=W,
                                         scheduler="dynamic", trace=True)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        out[W] = (ref, ref_out, ex, ex.run_once(pb))
    static = MegakernelExecutor(compile_decode_megakernel(cfg, B, S), cfg,
                                device="cpu")
    return out, static.run_once(pb)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_dynamic_matches_pallas_interpret(dyn_steps, workers):
    """Every word of the tail bitwise the reference's, the ticket T,
    every output within 2e-4 (the conv windows' copies bitwise), the
    counters and cursors equal."""
    ref, ref_out, ex, out = dyn_steps[0][workers]
    plan = ex.plan
    lo, hi = plan.event_offset, ref.plan.heap_size
    assert np.array_equal(ex.heap.numpy()[lo:hi].view(np.int32),
                          np.asarray(ref._heap)[lo:hi].view(np.int32))
    assert ex.heap[plan.ctl_offset] == plan.dyn.num_tasks
    assert set(out) == set(ref_out)
    for name in ref_out:
        np.testing.assert_allclose(out[name].numpy(), ref_out[name],
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert check_conv_windows(plan, ex.heap, out, ref_out) == 3
    assert ex.worker_counters() == ref.worker_counters()
    assert ex.scheduler_counters() == ref.scheduler_counters()


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_plain_dynamic_pops_replay_and_ring(dyn_steps, workers):
    """The pop trace is ``replay_sequential``'s order; every pool drains
    with T pops and no pop from overflow; the decoded ring equals the
    reference's with a clean event order; every SSD update waits on the
    conv steps and the dt projection of its tile."""
    ref, _, ex, _ = dyn_steps[0][workers]
    plan = ex.plan
    T = plan.dyn.num_tasks
    tr = replay_sequential(plan.dyn)
    slots = plan.num_steps * plan.num_workers
    assert np.array_equal(ex.pop_trace(),
                          np.array(tr.order + [-1] * (slots - T)))
    qc = ex.scheduler_counters()
    assert qc["queue_pushed"] == qc["queue_popped"]
    assert sum(qc["queue_popped"]) == T and qc["pops_overflow"] == 0
    got = decode_ring(plan, ex.task_ring())
    want = ref_decode_ring(ref.plan, ref.task_ring())
    assert [(e.task, e.worker, e.kind, e.start, e.end, e.source)
            for e in got.events] == [(e.task, e.worker, e.kind, e.start,
                                      e.end, e.source) for e in want.events]
    assert check_event_order(got) == []
    ssm_rows = np.flatnonzero(plan.descs[:, 0] == 12)
    assert len(ssm_rows) and (plan.descs[ssm_rows, 32] >= 0).all()
    assert (plan.descs[ssm_rows, 33] >= 2).all()


def test_plain_dynamic_bitwise_equal_static(dyn_steps):
    """The dynamic plain version's outputs are bitwise the static one's
    at every W."""
    steps, base = dyn_steps
    for w, (_, _, _, got) in steps.items():
        for name in base:
            assert torch.equal(got[name], base[name]), (w, name)
