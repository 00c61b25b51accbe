"""Decentralized in-kernel dynamic scheduler (paper §5): heap-resident
ready pools, event-triggered dispatch, work stealing.

The port's copy of the reference's ``repro/runtime/dyn_sched.py``
(numpy only).  The static megakernel runs "worker *w* runs descriptor
row ``(step, w)``": a compile-time partition that cannot absorb latency
skew (ragged KV lengths, MoE routing imbalance).  This module defines
the *dynamic* protocol that replaces it: worker *w* pops the next ready
task from a heap-resident pool, and completing a task signals its event
counter, which enqueues the consumers it makes ready.

This file is the protocol's single source of truth for the port:

* ``megakernel/desc.py`` lowers the pools, the event table and the
  scheduler table into the heap and descriptor layout;
* ``megakernel/kernel.py`` runs it: ``megakernel_plain`` in the
  sequential slot order of :func:`replay_sequential`, the CUDA kernel
  (``megakernel/csrc/megakernel.cu``) concurrently on every CTA;
* ``core/runtime_sim.py`` (``mode="mpk_dyn"``) replays it under the
  reference's cost model.

Protocol (the paper's per-SM ready queues, one pool per worker CTA):

* **Per-worker ready pool**: ``QUEUE_CAP`` (= 128) float32 words per
  worker in the heap.  A slot holds a ready task's descriptor-row id or
  the ``QUEUE_EMPTY`` sentinel.  A *push* writes the row id into the
  first empty slot; a *pop* takes the **minimum** row id (row ids are
  linearized-schedule positions, so the pop priority is "earliest
  static position", and ids are unique).  On the card one warp scans a
  pool (four words a lane, then a shuffle-min) and claims the minimum
  with a compare-and-swap on the word's bits, so the pool needs no
  head or tail: the in-heap [pushed, popped] counters per pool remain
  (occupancy = pushed - popped), as an occupancy hint.
* **Shared overflow queue**: the same representation, with room for
  every task; it takes the pushes whose affinity pool is full, and
  every worker drains it once its own pool is empty.
* **Pop order** for worker *w*: own pool, then the overflow queue, then
  **steal**: the first victim in ``(w+1) % W, (w+2) % W, ...`` that
  holds an entry gives up its minimum.
* **Event-triggered dispatch**: every task carries its dependent event
  (wait word) and its triggering event (signal word); the event
  counters live in the heap and cover *every* event with producers and
  consumers.  Completing a task adds one to its triggering event's
  counter; the producer that brings it to the trigger count pushes all
  of the event's consumers onto their affinity workers' pools.  The
  affinity is the static partition's ``worker_of``: a placement hint
  that stealing is free to break.
* **Initial ready set**: the tasks whose dependent event has no
  producers (the start event) are written into the pools at lowering
  time; the executor rewrites this initial queue image before every
  launch.

Determinism: :func:`replay_sequential` runs the pops in grid-slot order
(step-major, worker-fastest), as the reference's interpret-mode kernel
and the port's plain version do, and predicts their pop trace exactly.
At W = 1 the min-row-id pop replays the linearized order verbatim: the
next task in ``lin.order`` is always ready (the order is topological)
and always the minimum ready row.

On the card the pops, pushes and cursor updates are atomic operations
on the heap words and the CTAs run concurrently; the pop order is one
legal serialization among many, and the outputs do not depend on it.
A popped task's event counter must already equal its trigger count (a
consumer is pushed only after its event fully triggered): anything else
is a scheduler bug, counted as a violation that must stay zero.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "QUEUE_CAP",
    "QUEUE_EMPTY",
    "DynSchedPlan",
    "build_dyn_sched",
    "SeqTrace",
    "replay_sequential",
    "DynSimResult",
    "simulate_dynamic",
]

#: per-worker ready-pool capacity in float32 words: one warp scans a
#: pool with four words a lane
QUEUE_CAP = 128

#: sentinel marking an empty pool slot (row ids stay far below this and
#: are exact in f32)
QUEUE_EMPTY = 1.0e9


@dataclasses.dataclass
class DynSchedPlan:
    """The static half of the dynamic scheduler: everything the kernel
    lowering, the sequential replay and the event-driven simulator share.
    Row ids are positions in the compiled linearized order (which is how
    the descriptor table is laid out in dynamic mode)."""

    num_workers: int
    num_tasks: int                     # descriptor rows == pops required
    affinity: np.ndarray               # (T,) int32: static placement hint
    #: per dynamic event: number of producers that must signal it
    trigger: np.ndarray                # (E,) int32
    #: per dynamic event: consumer rows, ascending (the enqueue order)
    consumers: List[List[int]]
    #: per dynamic event: producer rows (the in-tasks) — used by the
    #: simulator's cross-worker wait/stall charges, not by the kernel
    producers: List[List[int]]
    wait_ev: np.ndarray                # (T,) int32 event idx or -1
    sig_ev: np.ndarray                 # (T,) int32 event idx or -1
    initial: List[List[int]]           # per worker: initial ready rows
    initial_overflow: List[int]        # spill of the initial set
    row_task: List[int]                # row -> tGraph task id

    @property
    def num_events(self) -> int:
        return len(self.trigger)

    @property
    def max_out(self) -> int:
        return max((len(c) for c in self.consumers), default=0)

    @property
    def overflow_cap(self) -> int:
        """Overflow capacity: every task alive at once fits, padded to a
        whole number of pool-sized rows for the kernel's row-by-row scan."""
        return max(QUEUE_CAP,
                   -(-self.num_tasks // QUEUE_CAP) * QUEUE_CAP)

    def queue_image(self) -> Tuple[np.ndarray, np.ndarray]:
        """The initial in-heap queue state rewritten before every launch:
        ``(pools, counters)`` where ``pools`` is the per-worker pools and
        the overflow region (f32 row ids / QUEUE_EMPTY) and ``counters``
        is the per-pool [pushed, popped] pairs (one pair per worker +
        one for overflow), pushed pre-charged with the initial image."""
        W = self.num_workers
        pools = np.full((W * QUEUE_CAP + self.overflow_cap,), QUEUE_EMPTY,
                        np.float32)
        counters = np.zeros((2 * (W + 1),), np.float32)
        for w, rows in enumerate(self.initial):
            pools[w * QUEUE_CAP : w * QUEUE_CAP + len(rows)] = rows
            counters[2 * w] = len(rows)
        ov = W * QUEUE_CAP
        pools[ov : ov + len(self.initial_overflow)] = self.initial_overflow
        counters[2 * W] = len(self.initial_overflow)
        return pools, counters

    def sched_table(self) -> np.ndarray:
        """(num_events, 2 + max_out) int32: ``[trigger_count, n_out,
        consumer rows…]``: the kernel's event-triggered dispatch table,
        uploaded once."""
        width = 2 + max(1, self.max_out)
        out = np.full((max(1, self.num_events), width), -1, np.int32)
        for e in range(self.num_events):
            out[e, 0] = self.trigger[e]
            out[e, 1] = len(self.consumers[e])
            for j, c in enumerate(self.consumers[e]):
                out[e, 2 + j] = c
        return out


def build_dyn_sched(compiled, partition=None) -> DynSchedPlan:
    """Derive the dynamic-scheduler plan from a compiled tGraph.

    ``partition`` (default: ``compiled.partition``) supplies the worker
    affinity hints; the event structure comes from the normalized tGraph
    (every task has exactly one dependent and one triggering event).
    Events with producers *and* consumers get an in-heap counter; the
    start event's consumers (no producers) form the initial ready set;
    the final event (no consumers) needs no signal.
    """
    tg = compiled.tg
    part = partition if partition is not None else compiled.partition
    order = compiled.order
    T = len(order)
    pos = {tid: row for row, tid in enumerate(order)}
    W = part.num_workers

    dyn_events = sorted(
        eid for eid, e in tg.events.items() if e.in_tasks and e.out_tasks)
    eidx = {eid: i for i, eid in enumerate(dyn_events)}

    affinity = np.zeros((T,), np.int32)
    wait_ev = np.full((T,), -1, np.int32)
    sig_ev = np.full((T,), -1, np.int32)
    trigger = np.zeros((len(dyn_events),), np.int32)
    consumers: List[List[int]] = [[] for _ in dyn_events]
    producers: List[List[int]] = [[] for _ in dyn_events]
    for eid, i in eidx.items():
        e = tg.events[eid]
        trigger[i] = len(e.in_tasks)
        consumers[i] = sorted(pos[t] for t in e.out_tasks)
        producers[i] = sorted(pos[t] for t in e.in_tasks)

    initial_rows: List[int] = []
    for row, tid in enumerate(order):
        task = tg.tasks[tid]
        affinity[row] = part.worker_of[tid]
        deps = [eid for eid in task.dependent_events if eid in eidx]
        if deps:                       # normalized: at most one
            wait_ev[row] = eidx[deps[0]]
        else:                          # start event (no producers): ready
            initial_rows.append(row)
        sigs = [eid for eid in task.triggering_events if eid in eidx]
        if sigs:
            sig_ev[row] = eidx[sigs[0]]

    initial: List[List[int]] = [[] for _ in range(W)]
    overflow: List[int] = []
    for row in sorted(initial_rows):
        pool = initial[affinity[row]]
        if len(pool) < QUEUE_CAP:
            pool.append(row)
        else:
            overflow.append(row)

    return DynSchedPlan(W, T, affinity, trigger, consumers, producers,
                        wait_ev, sig_ev, initial, overflow, list(order))


# ---------------------------------------------------------------------------
# The live queue state both replays below share.
# ---------------------------------------------------------------------------


class _Queues:
    """Mutable pool state mirroring the in-heap representation: per-slot
    values (row id or empty), first-empty pushes, min-value pops.  Pools
    whose [pushed, popped] cursors say they are empty are not scanned (in
    a sequential replay the cursors are exact); the results are the
    reference's."""

    def __init__(self, plan: DynSchedPlan):
        self.plan = plan
        W = plan.num_workers
        self.pools: List[List[Optional[int]]] = [
            [None] * QUEUE_CAP for _ in range(W)]
        self.overflow: List[Optional[int]] = [None] * plan.overflow_cap
        for w, rows in enumerate(plan.initial):
            for j, r in enumerate(rows):
                self.pools[w][j] = r
        for j, r in enumerate(plan.initial_overflow):
            self.overflow[j] = r
        self.pushed = [len(rows) for rows in plan.initial] \
            + [len(plan.initial_overflow)]
        self.popped = [0] * (W + 1)
        self.max_depth = [len(rows) for rows in plan.initial] \
            + [len(plan.initial_overflow)]
        self.steals = 0
        self.pops_own = 0
        self.pops_overflow = 0

    @staticmethod
    def _min_slot(pool: List[Optional[int]]) -> Optional[int]:
        best = None
        for j, v in enumerate(pool):
            if v is not None and (best is None or v < pool[best]):
                best = j
        return best

    def pool(self, ctr: int) -> List[Optional[int]]:
        """Pool ``ctr``: a worker's, or the overflow queue at ``W``."""
        return self.overflow if ctr == self.plan.num_workers \
            else self.pools[ctr]

    def live(self, ctr: int) -> bool:
        return self.pushed[ctr] > self.popped[ctr]

    def push(self, row: int) -> None:
        w = int(self.plan.affinity[row])
        pool, ctr = self.pools[w], w
        slot = next((j for j, v in enumerate(pool) if v is None), None)
        if slot is None:               # affinity pool full: overflow
            pool, ctr = self.overflow, self.plan.num_workers
            slot = next(j for j, v in enumerate(pool) if v is None)
        pool[slot] = row
        self.pushed[ctr] += 1
        depth = self.pushed[ctr] - self.popped[ctr]
        self.max_depth[ctr] = max(self.max_depth[ctr], depth)

    def pop(self, w: int) -> Optional[Tuple[int, str]]:
        """Pop for worker ``w`` per the protocol order; returns
        ``(row, source)`` or None when every pool is empty."""
        j = self._min_slot(self.pools[w]) if self.live(w) else None
        if j is not None:
            row = self.pools[w][j]
            self.pools[w][j] = None
            self.popped[w] += 1
            self.pops_own += 1
            return row, "own"
        W = self.plan.num_workers
        j = self._min_slot(self.overflow) if self.live(W) else None
        if j is not None:
            row = self.overflow[j]
            self.overflow[j] = None
            self.popped[W] += 1
            self.pops_overflow += 1
            return row, "overflow"
        for k in range(1, W):
            v = (w + k) % W
            j = self._min_slot(self.pools[v]) if self.live(v) else None
            if j is not None:
                row = self.pools[v][j]
                self.pools[v][j] = None
                self.popped[v] += 1
                self.steals += 1
                return row, "steal"
        return None


# ---------------------------------------------------------------------------
# Sequential replay: the bitwise oracle of the plain version.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SeqTrace:
    """One legal execution of the protocol in grid-slot order."""

    order: List[int]                   # popped row per executing slot
    worker: List[int]                  # lane that executed each pop
    source: List[str]                  # "own" | "overflow" | "steal"
    slots: int                         # grid slots incl. trailing idles
    pops_own: int
    pops_overflow: int
    steals: int
    max_depth: List[int]               # per pool (W workers + overflow)

    def task_order(self, plan: DynSchedPlan) -> List[int]:
        """The executed order as tGraph task ids (the sequential
        execution order for ``scheduler="dynamic"``)."""
        return [plan.row_task[r] for r in self.order]


def replay_sequential(plan: DynSchedPlan) -> SeqTrace:
    """Replay the protocol in the plain version's slot order:
    slot ``i`` is executed by worker lane ``i % W``.  While tasks remain
    un-popped some pool is non-empty (a topologically-minimal remaining
    task was enqueued when its last producer signaled), and stealing
    reaches every pool, so exactly ``num_tasks`` slots pop; the trailing
    ``slots - num_tasks`` grid slots idle."""
    W = plan.num_workers
    q = _Queues(plan)
    counters = np.zeros((plan.num_events,), np.int64)
    order: List[int] = []
    worker: List[int] = []
    source: List[str] = []
    slot = 0
    while len(order) < plan.num_tasks:
        w = slot % W
        got = q.pop(w)
        assert got is not None, (
            f"dynamic-scheduler deadlock at slot {slot}: "
            f"{plan.num_tasks - len(order)} tasks remain but no pool "
            "has a ready entry")
        row, src = got
        e = int(plan.wait_ev[row])
        assert e < 0 or counters[e] == plan.trigger[e], (
            "popped task's event not fully triggered (scheduler bug)")
        order.append(row)
        worker.append(w)
        source.append(src)
        e = int(plan.sig_ev[row])
        if e >= 0:
            counters[e] += 1
            if counters[e] == plan.trigger[e]:
                for c in plan.consumers[e]:
                    q.push(c)
        slot += 1
    seen = sorted(order)
    assert seen == list(range(plan.num_tasks)), "pop set != task set"
    slots = -(-plan.num_tasks // W) * W
    return SeqTrace(order, worker, source, slots, q.pops_own,
                    q.pops_overflow, q.steals, list(q.max_depth))


# ---------------------------------------------------------------------------
# Event-driven replay: the skew-aware makespan model (mode="mpk_dyn").
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DynSimResult:
    makespan: float
    busy: List[float]                  # per-worker busy seconds
    done: Dict[int, float]             # row -> completion time
    pops_own: int
    pops_overflow: int
    steals: int
    max_depth: List[int]
    #: row -> start time (the predicted timeline ``obs`` reconciles
    #: against the kernel's trace ring)
    start: Dict[int, float] = dataclasses.field(default_factory=dict)
    #: row -> worker lane that popped it
    worker: Dict[int, int] = dataclasses.field(default_factory=dict)


def simulate_dynamic(plan: DynSchedPlan, tasks: Sequence,
                     time_fn: Callable, wait_fn: Callable,
                     queue_overhead: float = 0.0,
                     pipeline_depth: int = 2,
                     overlap_comm: bool = False,
                     n_dma: int = 4) -> DynSimResult:
    """Event-driven replay of the protocol in *time* order: each worker,
    when free, pops the best entry available to it (own pool → overflow
    → steal) among entries whose producers have finished; a worker with
    no available entry idles until the earliest pending one.

    ``tasks[row]`` is the tGraph task of descriptor row ``row``;
    ``time_fn(task, stalled)`` / ``wait_fn(task)`` are the shared
    roofline cost hooks (``core/schedule.py``), charged exactly as
    :func:`~repro_torch.core.schedule.replay_partition` charges the static
    replay so the two makespans are directly comparable:

    * a popped task starts once every producer has finished, producers
      popped by *another* worker adding one event wait (``wait_fn``);
    * a task runs pipelined — its pop-ahead (the queue head is known
      while the previous task computes, the dynamic analogue of the
      static stream's double buffer) hides the operand load — UNLESS a
      producer completed fewer than ``pipeline_depth`` pops earlier in
      the global pop sequence, in which case the pop-ahead could not
      have prefetched it and the task pays the demand-load stall
      (``time_fn(task, True)``) — the same rule
      ``count_pipeline_stalls`` applies to static step gaps;
    * every pop additionally pays ``queue_overhead`` (dequeue +
      scheduler-table decode, which the static stream amortizes at
      compile time);
    * with ``overlap_comm``, communication tasks are issued onto one of
      ``n_dma`` DMA lanes without occupying the popping worker — the
      same channel model ``replay_partition`` applies.

    Under uniform costs at W = 1 the pop order is the linearized order
    and every charge coincides with the static replay's, so the dynamic
    makespan **equals** ``replay_partition`` exactly (modulo
    ``queue_overhead``); under skewed costs the stealing rebalances what
    the static partition cannot.
    """
    W = plan.num_workers
    counters = np.zeros((plan.num_events,), np.int64)
    # entry visibility: a row is poppable once enqueued (its producers
    # finished); the cross-worker wait is charged at pop, not enqueue
    q = _Queues(plan)
    ready_ts: Dict[int, float] = {row: 0.0
                                  for rows in plan.initial for row in rows}
    ready_ts.update({row: 0.0 for row in plan.initial_overflow})
    preds: Dict[int, List[int]] = {}
    for e in range(plan.num_events):
        for c in plan.consumers[e]:
            preds.setdefault(c, []).extend(plan.producers[e])

    def _peek(ctr, now):
        if not q.live(ctr):
            return None
        pool = q.pool(ctr)
        best = None
        for j, v in enumerate(pool):
            if v is not None and ready_ts[v] <= now and (
                    best is None or v < pool[best]):
                best = j
        return best

    def available(w: int, now: float) -> Optional[Tuple[int, str]]:
        """Best entry worker ``w`` may pop at time ``now`` (protocol
        order, readiness respected) — peek only."""
        j = _peek(w, now)
        if j is not None:
            return q.pools[w][j], "own"
        j = _peek(W, now)
        if j is not None:
            return q.overflow[j], "overflow"
        for k in range(1, W):
            v = (w + k) % W
            j = _peek(v, now)
            if j is not None:
                return q.pools[v][j], "steal"
        return None

    def earliest_ts() -> Optional[float]:
        ts = [ready_ts[v] for c in range(W + 1) if q.live(c)
              for v in q.pool(c) if v is not None]
        return min(ts) if ts else None

    clock = [(0.0, w) for w in range(W)]
    heapq.heapify(clock)
    busy = [0.0] * W
    dma = [0.0] * n_dma
    done: Dict[int, float] = {}
    popper: Dict[int, int] = {}
    pop_seq: Dict[int, int] = {}
    starts: Dict[int, float] = {}
    n_done = 0
    while n_done < plan.num_tasks:
        t, w = heapq.heappop(clock)
        got = available(w, t)
        if got is None:
            nt = earliest_ts()
            assert nt is not None, "dynamic-scheduler deadlock (sim)"
            # entries available at nt (strictly > t, else it was popped)
            heapq.heappush(clock, (max(nt, t + 1e-18), w))
            continue
        row, src = got
        # consume through the pool abstraction (keeps counters/steal
        # stats identical to the sequential replay's accounting)
        if src == "own":
            j = _peek(w, t)
            q.pools[w][j] = None
            q.popped[w] += 1
            q.pops_own += 1
        elif src == "overflow":
            j = _peek(W, t)
            q.overflow[j] = None
            q.popped[W] += 1
            q.pops_overflow += 1
        else:
            for k in range(1, W):
                v = (w + k) % W
                j = _peek(v, t)
                if j is not None:
                    q.pools[v][j] = None
                    q.popped[v] += 1
                    q.steals += 1
                    break
        task = tasks[row]
        wait = wait_fn(task)
        start = t
        stalled = False
        for p in preds.get(row, ()):
            t_ready = done[p] + (0.0 if popper[p] == w else wait)
            if t_ready > start:
                start = t_ready
            if 0 < n_done - pop_seq[p] < pipeline_depth:
                stalled = True
        dt = time_fn(task, stalled) + queue_overhead
        if task.is_comm and overlap_comm:
            # issued onto a DMA lane; the popping worker stays free
            lane = dma.index(min(dma))
            start = max(start, dma[lane])
            dma[lane] = start + dt
            end = start + dt
        else:
            end = start + dt
            busy[w] += dt
        done[row] = end
        starts[row] = start
        popper[row] = w
        pop_seq[row] = n_done
        n_done += 1
        e = int(plan.sig_ev[row])
        if e >= 0:
            counters[e] += 1
            if counters[e] == plan.trigger[e]:
                for c in plan.consumers[e]:
                    ready_ts[c] = end
                    q.push(c)
        # an overlapped comm pop leaves the worker free at its own time
        heapq.heappush(
            clock, (t if task.is_comm and overlap_comm else end, w))
    makespan = max(done.values(), default=0.0)
    return DynSimResult(makespan, busy, done, q.pops_own,
                        q.pops_overflow, q.steals, list(q.max_depth),
                        starts, dict(popper))
