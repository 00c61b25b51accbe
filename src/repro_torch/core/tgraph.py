"""tGraph: the SM-level task/event graph (paper §3).

Nodes are *tasks* (a unit of computation or communication executed by one
SM — one Pallas grid step in the TPU adaptation) and *events* (synchronization
points).  Tasks and events alternate: a task has incoming edges only from its
*dependent events* and outgoing edges only to its *triggering events*; an
event is activated once every task that triggers it has completed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

from .graph import OpKind
from .regions import Region

__all__ = ["Task", "Event", "TGraph"]


@dataclasses.dataclass
class Task:
    task_id: int
    op_id: int                     # producing operator (-1 for dummies)
    kind: str                      # OpKind
    #: region of each output tensor this task computes: {tensor: Region}
    out_regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    #: region of each input tensor this task reads: {tensor: Region}
    in_regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    launch_mode: str = "aot"       # "jit" | "aot" (paper §5.2 hybrid launch)
    #: dependency edges (event ids).  Before normalization these may hold any
    #: number of entries; normalization reduces both to at most one.
    dependent_events: List[int] = dataclasses.field(default_factory=list)
    triggering_events: List[int] = dataclasses.field(default_factory=list)

    @property
    def is_comm(self) -> bool:
        return self.kind in OpKind.COMM_KINDS

    @property
    def is_dummy(self) -> bool:
        return self.kind == OpKind.NOOP

    def flops(self) -> int:
        """Rough per-task FLOP estimate for the latency-aware scheduler."""
        return int(self.attrs.get("flops", 0))

    def bytes_moved(self) -> int:
        return int(self.attrs.get("bytes", 0))


@dataclasses.dataclass
class Event:
    event_id: int
    #: tasks that must complete to activate this event (InTasks in the paper)
    in_tasks: Set[int] = dataclasses.field(default_factory=set)
    #: tasks launched when this event activates (OutTasks in the paper)
    out_tasks: Set[int] = dataclasses.field(default_factory=set)

    @property
    def num_triggers(self) -> int:
        return len(self.in_tasks)


class TGraph:
    """Mutable task/event graph manipulated by the compiler passes."""

    def __init__(self, name: str = "tgraph"):
        self.name = name
        self.tasks: Dict[int, Task] = {}
        self.events: Dict[int, Event] = {}
        self._next_task = 0
        self._next_event = 0
        #: statistics accumulated by the passes (Table 2 reproduction)
        self.stats: Dict[str, Any] = {}

    # ----------------------------------------------------------------- build
    def new_task(self, op_id: int, kind: str, **kw: Any) -> Task:
        t = Task(self._next_task, op_id, kind, **kw)
        self.tasks[t.task_id] = t
        self._next_task += 1
        return t

    def new_event(self) -> Event:
        e = Event(self._next_event)
        self.events[e.event_id] = e
        self._next_event += 1
        return e

    def connect(self, t1: Task, e: Event, t2: Task) -> None:
        """Add edges (t1 -> e) and (e -> t2)."""
        self.add_trigger(t1, e)
        self.add_dependent(e, t2)

    def add_trigger(self, t: Task, e: Event) -> None:
        if e.event_id not in t.triggering_events:
            t.triggering_events.append(e.event_id)
        e.in_tasks.add(t.task_id)

    def add_dependent(self, e: Event, t: Task) -> None:
        if e.event_id not in t.dependent_events:
            t.dependent_events.append(e.event_id)
        e.out_tasks.add(t.task_id)

    def remove_event(self, event_id: int) -> None:
        e = self.events.pop(event_id)
        for tid in e.in_tasks:
            t = self.tasks[tid]
            if event_id in t.triggering_events:
                t.triggering_events.remove(event_id)
        for tid in e.out_tasks:
            t = self.tasks[tid]
            if event_id in t.dependent_events:
                t.dependent_events.remove(event_id)

    # ----------------------------------------------------------------- query
    def num_tasks(self) -> int:
        return len(self.tasks)

    def num_events(self) -> int:
        return len(self.events)

    def task_dependencies(self) -> Set[Tuple[int, int]]:
        """The set of (producer_task, consumer_task) pairs implied by events.

        This is the *semantic* dependency relation: fusion/normalization must
        preserve its transitive closure restricted to real tasks.
        """
        deps: Set[Tuple[int, int]] = set()
        for e in self.events.values():
            for a in e.in_tasks:
                for b in e.out_tasks:
                    deps.add((a, b))
        return deps

    def reachable_real_deps(self) -> Set[Tuple[int, int]]:
        """(producer, consumer) pairs between *non-dummy* tasks, through any
        chain of events and dummy tasks.  Invariant checked by tests: this set
        must only ever grow (never lose a dependency) across passes, and for
        fusion it must stay exactly equal."""
        # adjacency over tasks (via direct events)
        succ: Dict[int, Set[int]] = {tid: set() for tid in self.tasks}
        for a, b in self.task_dependencies():
            succ[a].add(b)
        real = {tid for tid, t in self.tasks.items() if not t.is_dummy}
        out: Set[Tuple[int, int]] = set()
        for src in real:
            # BFS through dummy tasks
            seen: Set[int] = set()
            frontier = list(succ[src])
            while frontier:
                nxt = frontier.pop()
                if nxt in seen:
                    continue
                seen.add(nxt)
                if self.tasks[nxt].is_dummy:
                    frontier.extend(succ[nxt])
                else:
                    out.add((src, nxt))
        return out

    def validate(self, normalized: bool = False) -> None:
        for t in self.tasks.values():
            for eid in t.dependent_events:
                assert t.task_id in self.events[eid].out_tasks, (t, eid)
            for eid in t.triggering_events:
                assert t.task_id in self.events[eid].in_tasks, (t, eid)
            if normalized:
                assert len(t.dependent_events) <= 1, f"task {t.task_id} fan-in"
                assert len(t.triggering_events) <= 1, f"task {t.task_id} fan-out"
        for e in self.events.values():
            for tid in e.in_tasks:
                assert e.event_id in self.tasks[tid].triggering_events
            for tid in e.out_tasks:
                assert e.event_id in self.tasks[tid].dependent_events
        # acyclicity over the task-dependency relation
        assert self._is_acyclic(), "tGraph has a cycle"

    def _is_acyclic(self) -> bool:
        succ: Dict[int, Set[int]] = {tid: set() for tid in self.tasks}
        for a, b in self.task_dependencies():
            succ[a].add(b)
        state: Dict[int, int] = {}

        def visit(n: int) -> bool:
            state[n] = 1
            for m in succ[n]:
                s = state.get(m, 0)
                if s == 1:
                    return False
                if s == 0 and not visit(m):
                    return False
            state[n] = 2
            return True

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, len(self.tasks) * 2 + 100))
        try:
            for n in list(self.tasks):
                if state.get(n, 0) == 0:
                    if not visit(n):
                        return False
            return True
        finally:
            sys.setrecursionlimit(old)

    def summary(self) -> Dict[str, Any]:
        return {
            "tasks": self.num_tasks(),
            "events": self.num_events(),
            "dummy_tasks": sum(1 for t in self.tasks.values() if t.is_dummy),
            "comm_tasks": sum(1 for t in self.tasks.values() if t.is_comm),
            **self.stats,
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"TGraph({self.name}: {self.num_tasks()} tasks, {self.num_events()} events)"
