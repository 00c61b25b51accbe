"""tGraph normalization (paper §4.1, Figure 6, C5).

Rewrites an arbitrary tGraph into a functionally equivalent form in which
every task has at most one dependent event and at most one triggering event,
so task descriptors store exactly two event ids (fixed-size, indirection-free
encoding).  Dummy (empty) tasks are inserted only at forks/joins; the paper
observes <1% overhead on real models because compiled LLM graphs are "deep,
not wide".
"""
from __future__ import annotations

from .graph import OpKind
from .tgraph import TGraph

__all__ = ["normalize"]


def _reduce_fanout(tg: TGraph) -> int:
    """Figure 6a: task T0 triggering events e1..ek (k>1) -> T0 triggers a new
    event e'; k dummy tasks each depend on e' and trigger one original e_i."""
    added = 0
    for t0 in list(tg.tasks.values()):
        if len(t0.triggering_events) <= 1:
            continue
        originals = list(t0.triggering_events)
        e_prime = tg.new_event()
        for eid in originals:
            e = tg.events[eid]
            e.in_tasks.discard(t0.task_id)
            t0.triggering_events.remove(eid)
            dummy = tg.new_task(-1, OpKind.NOOP)
            tg.add_dependent(e_prime, dummy)
            tg.add_trigger(dummy, e)
            added += 1
        tg.add_trigger(t0, e_prime)
    return added


def _reduce_fanin(tg: TGraph) -> int:
    """Figure 6b: task T0 depending on events e1..ek (k>1) -> T0 depends on a
    new event e'; k dummy tasks each depend on one e_i and trigger e'."""
    added = 0
    for t0 in list(tg.tasks.values()):
        if len(t0.dependent_events) <= 1:
            continue
        originals = list(t0.dependent_events)
        e_prime = tg.new_event()
        for eid in originals:
            e = tg.events[eid]
            e.out_tasks.discard(t0.task_id)
            t0.dependent_events.remove(eid)
            dummy = tg.new_task(-1, OpKind.NOOP)
            tg.add_dependent(e, dummy)
            tg.add_trigger(dummy, e_prime)
            added += 1
        tg.add_dependent(e_prime, t0)
    return added


def normalize(tg: TGraph) -> TGraph:
    tasks_before = tg.num_tasks()
    added = _reduce_fanout(tg)
    added += _reduce_fanin(tg)
    tg.stats["dummy_tasks_added"] = added
    tg.stats["normalization_overhead"] = added / max(1, tasks_before)
    tg.validate(normalized=True)
    return tg
