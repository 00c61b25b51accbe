"""Typed task timelines: the one schema the port's producers emit.

* :func:`decode_ring` — the megakernel's heap-resident trace ring
  (``MegakernelExecutor.task_ring()``), the observed timeline in logical
  ticks (two global fetch-and-increment ticks per grid slot, or per pop
  under the dynamic scheduler);
* :func:`sequential_trace` — a sequential execution on the same
  two-ticks-per-task clock: of the compiled order, or of the dynamic
  scheduler's protocol replay.

``chrome_trace`` (``obs/perfetto.py``) exports either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..megakernel.desc import KIND_CODES, TRACE_WORDS

#: kind code -> short human name (the Chrome-trace event names); the first
#: name wins where codes are shared (residual_add / elementwise)
KIND_NAMES: Dict[int, str] = {}
for _k, _v in KIND_CODES.items():
    KIND_NAMES.setdefault(_v, str(_k))

__all__ = ["TaskEvent", "TaskTrace", "KIND_NAMES", "decode_ring",
           "sequential_trace", "check_event_order"]


@dataclasses.dataclass
class TaskEvent:
    """One executed task: half-open interval [start, end) on a worker."""

    task: int          # tGraph task id (-1 when unmapped)
    row: int           # descriptor row / grid slot the kernel executed
    worker: int        # worker lane
    kind: int          # kind code (desc.KIND_CODES)
    name: str          # human name ("matmul", "attention_decode", ...)
    start: float       # ticks
    end: float
    source: int = -1   # pop source: -1 under the static scheduler
    wait_cnt: int = 0  # event-wait trigger count (0 = no wait word)
    chip: int = 0      # chip of a stamped multichip plan
    wait_ev: int = -1  # descriptor wait-event id (word 32)
    sig_ev: int = -1   # descriptor signal-event id (word 34)


@dataclasses.dataclass
class TaskTrace:
    """A full timeline: events plus enough context to export it."""

    origin: str                    # "kernel" | "interpreter"
    scheduler: str                 # "static" | "dynamic"
    num_workers: int
    events: List[TaskEvent]
    n_chips: int = 1
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return max((e.end for e in self.events), default=0.0)

    def by_task(self) -> Dict[int, TaskEvent]:
        return {e.task: e for e in self.events if e.task >= 0}


def _live_slots(ring: np.ndarray, descs) -> np.ndarray:
    """Rows of a raw task ring worth decoding: every slot that computed
    (kind > 0) or synchronized (a wait or signal word on its descriptor:
    dummy tasks carry the compiler's start/final events, and dropping
    them would make the event-order check miss their signals).  Dynamic
    idle entries (row -1) and silent static noop pads are skipped."""
    rows = ring[:, 1].astype(np.int64)
    live = rows >= 0
    idx = np.clip(rows, 0, len(descs) - 1)
    synced = (descs[idx, 32] >= 0) | (descs[idx, 34] >= 0)
    return live & ((ring[:, 2] > 0) | synced)


def decode_ring(plan, ring: np.ndarray) -> TaskTrace:
    """Decode a raw ``task_ring()`` array against its plan into the
    observed :class:`TaskTrace` (times are logical ticks).  The ring's
    row word is the descriptor row: under the dynamic scheduler the
    linearized position (task id ``compiled.order[row]``), under the
    static one the grid slot, which maps back through the worker
    partition.  A stamped multichip grid (COMM tasks, per-chip copies)
    maps no row to one task: its events keep ``task=-1``, and each
    carries the chip of its worker lane."""
    assert ring.ndim == 2 and ring.shape[1] == TRACE_WORDS
    W = plan.num_workers
    n_chips = max(1, plan.n_chips)
    w_per_chip = max(1, W // n_chips)
    row_tid: Dict[int, int] = {}
    if plan.scheduler == "dynamic":
        order = plan.compiled.order
        row_tid = {r: order[r] for r in range(len(order))}
    elif n_chips == 1:
        part = plan.compiled.partition
        row_tid = {part.step_of[t] * W + part.worker_of[t]: t
                   for t in part.step_of}

    events: List[TaskEvent] = []
    for i in np.nonzero(_live_slots(ring, plan.descs))[0]:
        rec = ring[i]
        row = int(rec[1])
        kind = int(rec[2])
        d = plan.descs[row]
        events.append(TaskEvent(
            task=row_tid.get(row, -1),
            row=row,
            worker=int(rec[0]),
            kind=kind,
            name=KIND_NAMES.get(kind, f"kind{kind}"),
            start=float(rec[3]),
            end=float(rec[4]),
            source=int(rec[5]),
            wait_cnt=int(rec[6]),
            chip=int(rec[0]) // w_per_chip,
            wait_ev=int(d[32]),
            sig_ev=int(d[34]),
        ))
    return TaskTrace(
        origin="kernel", scheduler=plan.scheduler, num_workers=W,
        events=events, n_chips=n_chips,
        meta={"num_steps": plan.num_steps,
              "ring_slots": int(ring.shape[0]),
              "time_unit": "tick"})


def sequential_trace(compiled, scheduler: str = "static",
                     seq=None) -> TaskTrace:
    """A sequential execution on the kernel ring's two-ticks-per-task
    clock (task *i* spans [2i, 2i+1)).  Static: ``compiled.order``, each
    task on the worker its partition gives it.  Dynamic: ``seq`` is the
    :class:`~repro_torch.runtime.dyn_sched.SeqTrace` of the protocol
    replay (pop order, workers, sources)."""
    tg = compiled.tg
    part = compiled.partition

    def _ev(i, tid, worker, source=-1):
        task = tg.tasks[tid]
        kind = KIND_CODES.get("noop" if task.is_dummy else task.kind, 0)
        return TaskEvent(
            task=tid, row=i, worker=worker, kind=kind,
            name=KIND_NAMES.get(kind, f"kind{kind}"),
            start=float(2 * i), end=float(2 * i + 1), source=source)

    events: List[TaskEvent] = []
    if scheduler == "dynamic" and seq is not None:
        src_code = {"own": 0, "overflow": 1, "steal": 2}
        order = compiled.order
        for i, (row, w, src) in enumerate(zip(seq.order, seq.worker,
                                              seq.source)):
            events.append(_ev(i, order[row], w, src_code.get(src, -1)))
        W = max(seq.worker, default=0) + 1 if seq.worker else 1
    else:
        worker_of = part.worker_of if part is not None else {}
        for i, tid in enumerate(compiled.order):
            events.append(_ev(i, tid, int(worker_of.get(tid, 0))))
        W = part.num_workers if part is not None else 1
    return TaskTrace(origin="interpreter", scheduler=scheduler,
                     num_workers=W, events=events,
                     meta={"time_unit": "tick"})


def check_event_order(trace: TaskTrace, plan=None) -> List[str]:
    """Validate a timeline against the descriptor event-counter
    semantics; returns a list of violation strings (empty = consistent).

    * every waiter on event *e* must start at/after the end of every
      signaler of *e* (the counter can only have reached the trigger
      count once all signals landed),
    * a waiter's recorded trigger count must equal the number of
      signalers of its event.

    Needs wait/sig event ids on the events, i.e. a kernel-ring trace
    (:func:`decode_ring` fills them from the descriptor table)."""
    problems: List[str] = []
    signalers: Dict[int, List[TaskEvent]] = {}
    for e in trace.events:
        if e.sig_ev >= 0:
            signalers.setdefault(e.sig_ev, []).append(e)
    for e in trace.events:
        if e.wait_ev < 0:
            continue
        sigs = signalers.get(e.wait_ev, [])
        for s in sigs:
            if s.end > e.start:
                problems.append(
                    f"event {e.wait_ev}: waiter row {e.row} starts at "
                    f"{e.start} before signaler row {s.row} ends at "
                    f"{s.end}")
        if e.wait_cnt and e.wait_cnt != len(sigs):
            problems.append(
                f"event {e.wait_ev}: waiter row {e.row} expects "
                f"{e.wait_cnt} signals, trace has {len(sigs)} signalers")
    return problems
