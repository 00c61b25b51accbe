"""The reference's hardware cost model (a TPU v5e-class chip).

These constants are the JAX package's roofline model, copied so that the
port's compiler prices tasks exactly as the reference does: the
latency-aware scheduler and the worker partitioner
(``core/schedule.py``) weigh tasks with :data:`TPU_V5E`, and so the
port's linearized order, worker partition and descriptor table equal the
reference's.  They are not the H100's figures and predict no time on
the card; the card's own rates (3.35 TB/s, 67 TFLOP/s in float32) are
in ``chip_smoke.py`` and ``PERF.md``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "TPU_V5E", "WORKERS_PER_CHIP", "COMPUTE_LATENCY",
           "TASK_OVERHEAD", "COMM_LATENCY", "AOT_EVENT_WAIT", "JIT_HOP",
           "comm_time"]

#: SM/core-equivalent worker lanes one chip is modeled as (the paper's
#: per-SM task granularity): each worker owns 1/Wth of the chip's peak
#: FLOPs and HBM bandwidth in the scheduler's and simulator's cost model.
WORKERS_PER_CHIP = 8

#: runtime-model latency terms (seconds) — defined once here so the
#: worker partitioner's cost model and ``runtime_sim.SimConfig`` cannot
#: drift apart (the simulator must replay the compiler's exact schedule)
COMPUTE_LATENCY = 0.25e-6    # VPU/MXU issue-latency floor per task
TASK_OVERHEAD = 0.1e-6       # dequeue + descriptor decode
COMM_LATENCY = 2.0e-6        # per-collective base latency (hops)
AOT_EVENT_WAIT = 0.2e-6      # one in-heap event-counter wait (§5.2)
JIT_HOP = 0.6e-6             # worker->scheduler->worker hop (§5.2)


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float   # FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_link_bw: float       # bytes/s per link
    ici_links: int           # links per chip (2D torus -> 4)
    hbm_bytes: float         # capacity per chip


TPU_V5E = HW(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_link_bw=50e9,
    ici_links=4,
    hbm_bytes=16e9,
)


def comm_time(nbytes: float, *, ici_bw: float = TPU_V5E.ici_link_bw,
              latency: float = COMM_LATENCY) -> float:
    """Duration of one inter-chip transfer: ``bytes / ici_bw + latency``.

    The single comm cost model shared by the worker partitioner
    (``core/schedule.default_task_time``), the runtime simulator
    (``core/runtime_sim``) and the dynamic-scheduler replay — previously
    each carried its own copy of this formula.
    """
    return nbytes / ici_bw + latency
