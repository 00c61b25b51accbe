"""tGraph linearization (paper §4.1, Algorithm 1, C6).

BFS over the normalized tGraph producing a task order in which all tasks
launched by the same event are *consecutive*, so each event's fan-out is
encoded as a ``[first_task, last_task]`` index range instead of an explicit
task list.  On TPU this order is additionally the *execution schedule* of the
persistent megakernel (one grid step per task), so the event-dequeue priority
doubles as a latency-aware scheduler hook (see ``core/schedule.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from .tgraph import TGraph

__all__ = ["LinearizedTGraph", "linearize"]


@dataclasses.dataclass
class LinearizedTGraph:
    tg: TGraph
    order: List[int]                      # task ids in execution order
    index: Dict[int, int]                 # task id -> position
    #: event id -> (num_triggers, first_task_pos, last_task_pos); (-1, -1)
    #: range for events with no dependent tasks (graph-final events)
    event_ranges: Dict[int, Tuple[int, int, int]]
    start_events: List[int]

    def validate(self) -> None:
        assert sorted(self.order) == sorted(self.tg.tasks.keys()), (
            "linearization must enumerate every task exactly once"
        )
        # dependency order: every producer precedes its consumers
        for a, b in self.tg.task_dependencies():
            assert self.index[a] < self.index[b], (a, b)
        # contiguity: tasks launched by one event occupy a dense range
        for eid, (_n, first, last) in self.event_ranges.items():
            out = self.tg.events[eid].out_tasks
            if not out:
                assert (first, last) == (-1, -1)
                continue
            positions = sorted(self.index[t] for t in out)
            assert positions == list(range(first, last + 1)), (
                f"event {eid} fan-out not contiguous: {positions}"
            )

    # Table-2 "Lin." column: successor-encoding footprint.
    def footprint_bytes(self) -> Tuple[int, int]:
        """(without linearization, with linearization) in bytes: explicit
        4-byte successor indices vs an 8-byte [first,last] range per event."""
        naive = sum(4 * len(e.out_tasks) for e in self.tg.events.values())
        linear = 8 * len(self.tg.events)
        return naive, linear


def linearize(
    tg: TGraph,
    event_priority: Optional[Callable[[TGraph, int], float]] = None,
    task_order: Optional[Callable[[TGraph, int], float]] = None,
    event_selector: Optional[Callable] = None,
    group_order: Optional[Callable] = None,
) -> LinearizedTGraph:
    """Algorithm 1.  ``event_priority`` orders the event queue ``E`` (lower
    first; default FIFO) and ``task_order`` orders tasks within one event's
    launch group — both leave the algorithm's guarantees intact because any
    dequeue order of *ready* events yields a valid dependency order.

    ``event_selector(tg, candidates, order, index) -> entry`` replaces the
    static priority queue with a *dynamic* choice over the ready set:
    ``candidates`` is a list of ``(priority, seq, event_id)`` entries and
    the returned entry is dequeued next.  ``group_order(tg, out_tasks,
    order, index) -> list`` likewise replaces the static ``task_order``
    sort within one event's launch group.  The scheduler uses both to
    place each launch group — and each task within it — where it stalls
    the megakernel pipeline least (the choice depends on what has already
    been emitted, which a static priority cannot express)."""
    order: List[int] = []
    index: Dict[int, int] = {}
    event_ranges: Dict[int, Tuple[int, int, int]] = {}

    # remaining trigger counts per event
    remaining = {eid: len(e.in_tasks) for eid, e in tg.events.items()}
    enqueued: Dict[int, bool] = {eid: False for eid in tg.events}

    heap: List[Tuple[float, int, int]] = []  # (priority, seq, event_id)
    seq = 0

    def push(eid: int) -> None:
        nonlocal seq
        if enqueued[eid]:
            return
        enqueued[eid] = True
        prio = event_priority(tg, eid) if event_priority else float(seq)
        if event_selector is not None:
            heap.append((prio, seq, eid))
        else:
            heapq.heappush(heap, (prio, seq, eid))
        seq += 1

    # Line 2: enqueue all events with no dependent (triggering) tasks.
    start_events = [eid for eid, e in tg.events.items() if not e.in_tasks]
    for eid in sorted(start_events):
        push(eid)

    while heap:
        if event_selector is not None:
            entry = event_selector(tg, heap, order, index)
            heap.remove(entry)
            _p, _s, eid = entry
        else:
            _p, _s, eid = heapq.heappop(heap)
        e = tg.events[eid]
        if group_order is not None:
            out = group_order(tg, e.out_tasks, order, index)
        else:
            out = sorted(
                e.out_tasks,
                key=(lambda t: (task_order(tg, t), t)) if task_order
                else (lambda t: t),
            )
        first = len(order)
        for tid in out:  # lines 5-7: consecutive placement
            index[tid] = len(order)
            order.append(tid)
            t = tg.tasks[tid]
            for eprime in t.triggering_events:  # normalized: at most one
                remaining[eprime] -= 1
                if remaining[eprime] == 0:  # line 9
                    push(eprime)
        last = len(order) - 1
        event_ranges[eid] = (
            (len(e.in_tasks), first, last) if out else (len(e.in_tasks), -1, -1)
        )
        if not out:
            event_ranges[eid] = (len(e.in_tasks), -1, -1)

    lin = LinearizedTGraph(tg, order, index, event_ranges, start_events)
    lin.validate()
    naive, packed = lin.footprint_bytes()
    tg.stats["lin_footprint_naive"] = naive
    tg.stats["lin_footprint_packed"] = packed
    tg.stats["lin_reduction"] = naive / max(1, packed)
    return lin
