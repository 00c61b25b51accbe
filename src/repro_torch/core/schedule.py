"""Latency-aware scheduling and worker partitioning on top of
linearization (beyond-paper; see README.md "Megakernel internals" and the
runtime sections of PAPER.md).

On GPU, MPK's in-kernel scheduler dynamically overlaps tasks at runtime.  On
TPU the linearized order *is* the schedule (the persistent kernel executes
grid steps in order, with the double-buffered pipeline prefetching the next
task's tiles).  Three scheduling knobs remain inside Algorithm 1's
guarantees:

* the order in which *ready* events are dequeued,
* the order of tasks within one event's launch group, and
* which ready event to dequeue *given what was just emitted*.

We exploit all three:  (1) communication tasks are released as early as
possible so their DMA time hides behind unrelated compute (the paper's
fine-grained MatMul/AllReduce overlap, realized statically); (2) events on
the critical path are preferred so the pipeline never drains; (3) a
dynamic event selector actively separates producer→consumer pairs by
≥ pipeline depth: each launch group is placed where it incurs the fewest
same-window hazards, so the megakernel's prefetch plan covers more tasks
(``desc._plan_prefetch`` must demand-load any tile its producer wrote in
the previous step).

``count_pipeline_stalls`` is the metric the §Perf loop drives down;
``latency_aware_linearize`` now *optimizes* it (and falls back to the
naive order if greedy placement ever loses, so the scheduled stall count
never exceeds the naive one).

``partition_workers`` is the multi-worker layer on top (paper §5's
decentralized execution): the linearized schedule is split into W
per-worker ordered queues by makespan-minimizing critical-path list
scheduling over the same roofline task costs, the queues are aligned
onto a shared step axis (every dependency crosses a step boundary, so
the megakernel's sequential ``(step, worker)`` interpret-mode iteration
is a legal execution of the parallel schedule), and the cross-worker
dependency cut is reported for the event-counter lowering in
``kernels/megakernel/desc.py``.  ``replay_partition`` is the shared
deterministic cost replay both the partitioner's width selection and
``core/runtime_sim.py`` use, so the simulator measures the compiler's
actual schedule rather than inventing its own lane assignment.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Set, Tuple

import numpy as np

from ..roofline.hw import (AOT_EVENT_WAIT, COMPUTE_LATENCY, JIT_HOP,
                           TASK_OVERHEAD, TPU_V5E, WORKERS_PER_CHIP,
                           comm_time)
from .linearize import LinearizedTGraph, linearize
from .tgraph import TGraph

__all__ = [
    "critical_path_depths",
    "latency_aware_linearize",
    "count_pipeline_stalls",
    "overlap_statistics",
    "WorkerPartition",
    "partition_workers",
    "replay_partition",
    "default_task_time",
    "default_cross_wait",
]

#: per-worker roofline terms: one worker owns 1/Wth of the chip (the
#: paper's SM-granularity cost model).  Every constant below comes from
#: ``roofline/hw.py``: the reference's TPU cost model, kept so that the
#: port's partition equals the reference's.  They are not the H100's
#: figures.
_WORKER_FLOPS = TPU_V5E.peak_flops_bf16 / WORKERS_PER_CHIP
_WORKER_BW = TPU_V5E.hbm_bw / WORKERS_PER_CHIP


def critical_path_depths(tg: TGraph) -> Dict[int, float]:
    """Longest cost-weighted path from each task to a sink (task cost =
    flops/peak + bytes/bw in abstract units)."""
    succ: Dict[int, list] = {tid: [] for tid in tg.tasks}
    indeg: Dict[int, int] = {tid: 0 for tid in tg.tasks}
    for a, b in tg.task_dependencies():
        succ[a].append(b)
        indeg[b] += 1
    # reverse topological accumulation
    topo = []
    ready = [t for t, d in indeg.items() if d == 0]
    indeg2 = dict(indeg)
    while ready:
        n = ready.pop()
        topo.append(n)
        for m in succ[n]:
            indeg2[m] -= 1
            if indeg2[m] == 0:
                ready.append(m)
    depth: Dict[int, float] = {}
    for n in reversed(topo):
        t = tg.tasks[n]
        cost = (t.flops() / TPU_V5E.peak_flops_bf16
                + t.bytes_moved() / TPU_V5E.hbm_bw + 1e-9)
        depth[n] = cost + max((depth[m] for m in succ[n]), default=0.0)
    return depth


def latency_aware_linearize(tg: TGraph,
                            pipeline_depth: int = 2) -> LinearizedTGraph:
    """Stall-aware Algorithm 1: among the ready events, dequeue the one
    whose launch group lands the fewest producer→consumer pairs closer
    than ``pipeline_depth`` to their producers (ties broken by the static
    comm-first / critical-path priority).  Guaranteed never to yield more
    stalls than naive FIFO linearization: the naive order is computed too
    and returned when greedy placement loses.  The naive/scheduled stall
    counts are recorded in ``tg.stats`` for the compiler report."""
    depth = critical_path_depths(tg)

    def event_priority(tg_: TGraph, eid: int) -> float:
        e = tg_.events[eid]
        if not e.out_tasks:
            return float("inf")  # terminal events last
        has_comm = any(tg_.tasks[t].is_comm for t in e.out_tasks)
        d = max(depth.get(t, 0.0) for t in e.out_tasks)
        # communication first (issue DMAs early), then deepest critical path
        return (0.0 if has_comm else 1e6) - d

    def task_order(tg_: TGraph, tid: int) -> Tuple[float, float]:
        t = tg_.tasks[tid]
        return (0.0 if t.is_comm else 1.0, -depth.get(tid, 0.0))

    # producer map for the stall penalty of a candidate placement
    preds: Dict[int, Set[int]] = {}
    for a, b in tg.task_dependencies():
        preds.setdefault(b, set()).add(a)

    def group_order(tg_: TGraph, tids, order, index, overlay=None):
        """Dynamic within-group order: tasks whose producers just ran go
        LAST, maximizing each tight pair's separation (decode graphs are
        chain-shaped, so this knob moves far more pairs than the event
        choice).  Group-internal pairs cannot exist — a consumer's
        dependent event is triggered *by* its producer, so the two are
        never launched by the same event — which makes any permutation
        dependency-safe.  ``overlay`` holds simulated placements on top
        of ``index`` during selector lookahead."""
        def key(t):
            latest = -(1 << 30)
            for p in preds.get(t, ()):
                pi = index.get(p) if overlay is None else \
                    overlay.get(p, index.get(p))
                if pi is not None and pi > latest:
                    latest = pi
            return (latest, task_order(tg_, t), t)
        return sorted(tids, key=key)

    #: candidate/lookahead beam — the ready set of a production-size
    #: graph can hold hundreds of events; evaluating stalls for every
    #: pair would make scheduling quadratic (~90s on a 25k-task graph).
    #: Decode graphs keep their real freedom in a handful of ready
    #: events, so a small beam loses nothing measurable.
    BEAM = 8

    def stall_penalty(tg_: TGraph, eid: int, base: int, index,
                      overlay=None) -> int:
        """Stalls created by emitting this event's group at position
        ``base``: pairs whose producer would sit fewer than
        ``pipeline_depth`` steps before the consumer (under the same
        dynamic group order the emission will use).  Only the group's
        first ``pipeline_depth - 1`` tasks can conflict with already
        emitted producers (and group-internal pairs cannot exist), so
        the scan stops there.  ``overlay`` holds simulated placements on
        top of ``index`` (never copied — it can be 10^4+ entries)."""
        lookup = index.get if overlay is None else \
            (lambda p: overlay.get(p, index.get(p)))
        group = group_order(tg_, tg_.events[eid].out_tasks, None, index,
                            overlay)
        pen = 0
        for j, tid in enumerate(group[: pipeline_depth - 1]):
            pos = base + j
            for p in preds.get(tid, ()):
                pi = lookup(p)
                if pi is not None and 0 < pos - pi < pipeline_depth:
                    pen += 1
        return pen

    def event_selector(tg_: TGraph, candidates, order, index):
        """Greedy with one step of lookahead.  Myopic stall counting
        fails on chain-shaped decode graphs: emitting a zero-penalty
        group often *forces* its tight consumer group next, when it is
        the only candidate left.  So each candidate is charged its own
        stalls plus the cheapest achievable stalls of the step after it
        (simulated placement: the candidate's tasks get overlay indices,
        and events it fully triggers join the ready set)."""
        base = len(order)
        if len(candidates) > BEAM:
            cands = sorted(candidates)[:BEAM]     # best static priorities
        else:
            cands = candidates

        best, best_key = None, None
        for entry in cands:
            prio, seq, eid = entry
            pen = stall_penalty(tg_, eid, base, index)
            # --- simulate emitting this group (overlay, no index copy) ---
            group = group_order(tg_, tg_.events[eid].out_tasks, None, index)
            overlay = {tid: base + j for j, tid in enumerate(group)}
            nxt_base = base + len(group)
            nxt_ready = [oid for (_p, _s, oid) in cands if oid != eid]
            for tid in group:
                for eprime in tg_.tasks[tid].triggering_events:
                    ev = tg_.events[eprime]
                    if ev.out_tasks and all(t in overlay or t in index
                                            for t in ev.in_tasks):
                        nxt_ready.append(eprime)
            if nxt_ready:
                pen += min(stall_penalty(tg_, oid, nxt_base, index, overlay)
                           for oid in nxt_ready[:BEAM])
            key = (pen, prio, seq)
            if best_key is None or key < best_key:
                best, best_key = entry, key
        return best

    scheduled = linearize(tg, event_priority=event_priority,
                          task_order=task_order,
                          event_selector=event_selector,
                          group_order=group_order)
    naive = linearize(tg)
    n_sched = count_pipeline_stalls(scheduled, pipeline_depth)
    n_naive = count_pipeline_stalls(naive, pipeline_depth)
    tg.stats["pipeline_stalls_naive"] = n_naive
    return scheduled if n_sched <= n_naive else naive


def count_pipeline_stalls(lin: LinearizedTGraph, pipeline_depth: int = 2) -> int:
    """Number of direct producer→consumer pairs scheduled fewer than
    ``pipeline_depth`` steps apart: each such pair forces the persistent
    kernel to wait for the producer's writeback before the consumer's
    prefetch, draining the double-buffered VMEM pipeline (the prefetch
    plan demand-loads exactly these tiles)."""
    stalls = 0
    for a, b in lin.tg.task_dependencies():
        if 0 < lin.index[b] - lin.index[a] < pipeline_depth:
            stalls += 1
    return stalls


def overlap_statistics(lin: LinearizedTGraph, window: int = 8) -> Dict[str, float]:
    """How well communication tasks are interleaved with compute: fraction of
    comm tasks that have ≥1 independent compute task within ``window``
    following steps (those DMAs are hidden behind compute)."""
    tg = lin.tg
    # successor sets built once: each probe below is an O(1) membership
    # test against the comm task's own (small) successor set, not a scan
    # of the full dependency relation
    succ: Dict[int, Set[int]] = {}
    for a, b in tg.task_dependencies():
        succ.setdefault(a, set()).add(b)
    comm = [tid for tid in lin.order if tg.tasks[tid].is_comm]
    if not comm:
        return {"comm_tasks": 0, "overlapped_frac": 1.0}
    hidden = 0
    for tid in comm:
        i = lin.index[tid]
        mine = succ.get(tid, ())
        for j in range(i + 1, min(i + 1 + window, len(lin.order))):
            other = lin.order[j]
            if not tg.tasks[other].is_comm and other not in mine:
                hidden += 1
                break
    return {"comm_tasks": len(comm), "overlapped_frac": hidden / len(comm)}


# ===========================================================================
# Multi-worker partitioning (paper §5: decentralized per-worker queues).
# ===========================================================================


def default_task_time(task, stalled: bool = False) -> float:
    """The canonical per-task cost: max(load, compute) inside the
    software-pipelined persistent kernel, serialized load+compute+decode
    when the schedule stalled the prefetch (same formula as
    ``runtime_sim._task_time`` with the default ``SimConfig``)."""
    if task.is_dummy:
        return 0.0
    if task.is_comm:
        return comm_time(task.bytes_moved())
    load = task.bytes_moved() / _WORKER_BW
    comp = task.flops() / _WORKER_FLOPS + COMPUTE_LATENCY
    if stalled:
        return load + comp + TASK_OVERHEAD
    return max(load, comp)


def default_cross_wait(task) -> float:
    """Cost a consumer pays for a cross-worker dependency: one in-heap
    event-counter wait for AOT tasks, the worker→scheduler→worker hop
    for JIT tasks (paper §5.2)."""
    return JIT_HOP if task.launch_mode == "jit" else AOT_EVENT_WAIT


@dataclasses.dataclass
class WorkerPartition:
    """W per-worker ordered task queues + the cross-worker dependency cut.

    ``queues[w]`` is worker *w*'s static stream in execution order;
    ``step_of`` aligns the queues onto one global step axis such that
    every dependency strictly crosses a step boundary
    (``step_of[producer] < step_of[consumer]``) — which makes the
    megakernel's sequential step-major interpret-mode iteration a legal
    execution of the parallel schedule, and turns every in-kernel event
    wait into a checkable assertion.  ``requested_workers`` is the W the
    caller asked for; ``num_workers`` is the width the makespan-
    minimizing selection actually uses (≤ requested — extra workers are
    dropped when they can only add cross-worker waits)."""

    requested_workers: int
    queues: List[List[int]]
    worker_of: Dict[int, int]
    step_of: Dict[int, int]
    num_steps: int
    cross_deps: Set[Tuple[int, int]]
    est_makespan: float
    est_busy: List[float]              # per-worker busy time (seconds)

    @property
    def num_workers(self) -> int:
        return len(self.queues)

    def worker_utilization(self) -> List[float]:
        m = max(self.est_makespan, 1e-30)
        return [b / m for b in self.est_busy]

    def validate(self, tg: TGraph,
                 deps: Set[Tuple[int, int]] = None) -> None:
        flat = [t for q in self.queues for t in q]
        assert sorted(flat) == sorted(tg.tasks.keys()), (
            "partition must enumerate every task exactly once")
        for w, q in enumerate(self.queues):
            steps = [self.step_of[t] for t in q]
            assert steps == sorted(steps) and len(set(steps)) == len(steps), (
                f"worker {w} steps not strictly increasing")
            for t in q:
                assert self.worker_of[t] == w
        for a, b in (tg.task_dependencies() if deps is None else deps):
            assert self.step_of[a] < self.step_of[b], (
                f"dependency {a}->{b} does not cross a step boundary")
        for a, b in self.cross_deps:
            assert self.worker_of[a] != self.worker_of[b]


def _preds_map(deps: Set[Tuple[int, int]]) -> Dict[int, Set[int]]:
    preds: Dict[int, Set[int]] = {}
    for a, b in deps:
        preds.setdefault(b, set()).add(a)
    return preds


def _list_schedule(tg: TGraph, lin: LinearizedTGraph, width: int,
                   depth: Dict[int, float], deps: Set[Tuple[int, int]],
                   preds: Dict[int, Set[int]],
                   cost: Dict[int, Tuple[float, float]]) -> List[List[int]]:
    """Critical-path list scheduling (HEFT-style earliest-finish
    insertion) onto ``width`` identical workers.  Ready tasks are
    released in longest-critical-path order (ties broken by the
    latency-aware linearized position, so width 1 degenerates to a
    topological order consistent with ``lin``); each is placed on the
    worker where it can finish earliest (the lowest such worker),
    cross-worker producers charging one event wait.

    A task's earliest start on worker ``k`` is the latest of the worker's
    free time, its producers' finish times on ``k`` and the others'
    finish times plus the wait: every worker without a producer takes the
    latest of all the latter, so only the producers' workers are priced
    one by one (the same maxima as a loop over every (worker, producer)
    pair, in O(width + producers) a task).  ``cost`` holds each task's
    (time, cross-worker wait)."""
    succ: Dict[int, List[int]] = {tid: [] for tid in tg.tasks}
    indeg: Dict[int, int] = {tid: 0 for tid in tg.tasks}
    for a, b in deps:
        succ[a].append(b)
        indeg[b] += 1

    ready: List[Tuple[float, int, int]] = []
    for tid, d0 in indeg.items():
        if d0 == 0:
            heapq.heappush(ready, (-depth.get(tid, 0.0),
                                   lin.index[tid], tid))
    queues: List[List[int]] = [[] for _ in range(width)]
    worker_free = np.zeros(width)
    worker_of: Dict[int, int] = {}
    done: Dict[int, float] = {}
    inf = float("inf")
    while ready:
        _d, _i, tid = heapq.heappop(ready)
        dt, wait = cost[tid]
        own: Dict[int, float] = {}      # worker -> its producers' finish
        far: Dict[int, float] = {}      # worker -> the same plus the wait
        for p in preds.get(tid, ()):
            k, t = worker_of[p], done[p]
            if t > own.get(k, -inf):
                own[k] = t
            if t + wait > far.get(k, -inf):
                far[k] = t + wait
        if far:
            k1 = max(far, key=far.__getitem__)
            v1 = far[k1]
            v2 = max((v for k, v in far.items() if k != k1), default=-inf)
            avail = np.maximum(worker_free, v1)
            for k, t in own.items():
                avail[k] = max(worker_free[k], t, v2 if k == k1 else v1)
        else:
            avail = worker_free
        best_w = int(np.argmin(avail))
        worker_of[tid] = best_w
        queues[best_w].append(tid)
        done[tid] = float(avail[best_w]) + dt
        worker_free[best_w] = done[tid]
        for m in succ[tid]:
            indeg[m] -= 1
            if indeg[m] == 0:
                heapq.heappush(ready, (-depth.get(m, 0.0),
                                       lin.index[m], m))
    return queues


def _assign_steps(tg: TGraph, queues: List[List[int]],
                  preds: Dict[int, Set[int]]
                  ) -> Tuple[Dict[int, int], int]:
    """Align the queues onto one step axis: each task's step strictly
    exceeds every producer's step (any worker) and its queue
    predecessor's step.  Gaps become noop padding slots in the lowered
    descriptor streams."""
    step_of: Dict[int, int] = {}
    heads = [0] * len(queues)
    next_free = [0] * len(queues)
    remaining = sum(len(q) for q in queues)
    while remaining:
        progressed = False
        for w, q in enumerate(queues):
            while heads[w] < len(q):
                tid = q[heads[w]]
                ps = preds.get(tid, ())
                if any(p not in step_of for p in ps):
                    break
                step = next_free[w]
                for p in ps:
                    if step_of[p] + 1 > step:
                        step = step_of[p] + 1
                step_of[tid] = step
                next_free[w] = step + 1
                heads[w] += 1
                remaining -= 1
                progressed = True
        assert progressed, "queues are not topologically consistent"
    num_steps = max(step_of.values(), default=-1) + 1
    return step_of, num_steps


@dataclasses.dataclass
class ReplayResult:
    makespan: float
    busy: List[float]                 # per-worker busy seconds
    done: Dict[int, float]            # task completion times
    stalled: int                      # tasks that lost their prefetch
    #: task start times (the predicted timeline ``obs`` reconciles
    #: against the kernel's trace ring)
    start: Dict[int, float] = dataclasses.field(default_factory=dict)


def replay_partition(tg: TGraph, queues: List[List[int]],
                     step_of: Dict[int, int], *,
                     time_fn: Callable = default_task_time,
                     wait_fn: Callable = default_cross_wait,
                     pipeline_depth: int = 2,
                     overlap_comm: bool = False,
                     n_dma: int = 4,
                     deps: Set[Tuple[int, int]] = None,
                     preds: Dict[int, Set[int]] = None) -> ReplayResult:
    """Deterministic replay of a worker partition under the roofline cost
    model: worker *w* executes ``queues[w]`` in order, a task starts once
    its worker is free and every producer has finished (cross-worker
    producers add one event wait), and a task whose producer sits fewer
    than ``pipeline_depth`` steps earlier pays the demand-load stall.
    Used for the partitioner's width selection AND by
    ``runtime_sim.simulate`` — the simulated makespan IS this number.
    ``deps`` (and ``preds``, its producers by consumer) lets callers reuse
    an already-materialized dependency set."""
    if deps is None:
        deps = tg.task_dependencies()
    worker_of = {t: w for w, q in enumerate(queues) for t in q}
    stalled: Set[int] = set()
    if pipeline_depth > 1:
        for a, b in deps:
            if 0 < step_of[b] - step_of[a] < pipeline_depth:
                stalled.add(b)
    if preds is None:
        preds = _preds_map(deps)
    order = sorted(((step_of[t], w, t)
                    for w, q in enumerate(queues) for t in q))
    worker_t = [0.0] * len(queues)
    busy = [0.0] * len(queues)
    dma = [0.0] * n_dma
    done: Dict[int, float] = {}
    starts: Dict[int, float] = {}
    for _s, w, tid in order:
        task = tg.tasks[tid]
        wait = wait_fn(task)
        avail = 0.0
        for p in preds.get(tid, ()):
            t_ready = done[p] + (0.0 if worker_of[p] == w else wait)
            if t_ready > avail:
                avail = t_ready
        dt = time_fn(task, tid in stalled)
        if task.is_comm and overlap_comm:
            lane = dma.index(min(dma))
            start = max(avail, dma[lane])
            dma[lane] = start + dt
        else:
            start = max(avail, worker_t[w])
            worker_t[w] = start + dt
            busy[w] += dt
        done[tid] = start + dt
        starts[tid] = start
    makespan = max(done.values(), default=0.0)
    return ReplayResult(makespan, busy, done, len(stalled), starts)


def partition_workers(tg: TGraph, lin: LinearizedTGraph, num_workers: int,
                      pipeline_depth: int = 2, *,
                      time_fn: Callable = default_task_time,
                      wait_fn: Callable = default_cross_wait,
                      overlap_comm: bool = False,
                      n_dma: int = 4) -> WorkerPartition:
    """Makespan-minimizing worker partition of a linearized tGraph.

    Candidate widths 1..``num_workers`` are list-scheduled and evaluated
    under :func:`replay_partition` (including demand-load stalls at
    ``pipeline_depth``); the best replayed makespan wins, ties preferring
    fewer workers (fewer cross-worker events).  Because the candidate
    sets nest, the winning makespan is monotonically non-increasing in
    ``num_workers``; width 1 reduces *exactly* to
    ``latency_aware_linearize``'s order (the queue is ``lin.order``
    verbatim).  ``overlap_comm``/``n_dma`` put communication tasks on
    DMA lanes during evaluation — pass the simulator's values so width
    selection optimizes the same objective the replay reports."""
    assert num_workers >= 1
    deps = tg.task_dependencies()
    preds = _preds_map(deps)
    depth = critical_path_depths(tg)
    cost = {tid: (time_fn(t, False), wait_fn(t))
            for tid, t in tg.tasks.items()}
    best = None
    for width in range(1, num_workers + 1):
        if width == 1:
            queues = [list(lin.order)]
        else:
            queues = _list_schedule(tg, lin, width, depth, deps, preds,
                                    cost)
            queues = [q for q in queues if q]  # drop never-used workers
        step_of, num_steps = _assign_steps(tg, queues, preds)
        res = replay_partition(tg, queues, step_of, time_fn=time_fn,
                               wait_fn=wait_fn,
                               pipeline_depth=pipeline_depth,
                               overlap_comm=overlap_comm, n_dma=n_dma,
                               deps=deps, preds=preds)
        if best is None or res.makespan < best[0]:
            best = (res.makespan, queues, step_of, num_steps, res)
    makespan, queues, step_of, num_steps, res = best
    worker_of = {t: w for w, q in enumerate(queues) for t in q}
    cross = {(a, b) for a, b in deps if worker_of[a] != worker_of[b]}
    part = WorkerPartition(num_workers, queues, worker_of, step_of,
                           num_steps, cross, makespan, res.busy)
    part.validate(tg, deps)
    return part
