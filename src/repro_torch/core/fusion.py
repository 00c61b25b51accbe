"""Event fusion (paper §4.1, Definitions 4.1 and 4.2, C4).

*Successor-set fusion* merges events with identical ``OutTasks`` sets;
*predecessor-set fusion* merges events with identical ``InTasks`` sets.
Both are applied to a fixpoint.  Fusion preserves the task-dependency
relation exactly (checked by property tests): it only collapses redundant
synchronization points.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List

from .tgraph import TGraph

__all__ = ["fuse_events"]


def _fuse_by(tg: TGraph, key: str) -> int:
    """One fusion round keyed on ``in_tasks`` or ``out_tasks``; returns the
    number of events eliminated."""
    groups: Dict[FrozenSet[int], List[int]] = defaultdict(list)
    for e in tg.events.values():
        groups[frozenset(getattr(e, key))].append(e.event_id)
    eliminated = 0
    for sig, eids in groups.items():
        if len(eids) < 2 or not sig:
            continue
        keep = tg.events[eids[0]]
        for other_id in eids[1:]:
            other = tg.events[other_id]
            # merge the *other* side of the keyed set into `keep`
            for tid in list(other.in_tasks):
                tg.add_trigger(tg.tasks[tid], keep)
            for tid in list(other.out_tasks):
                tg.add_dependent(keep, tg.tasks[tid])
            tg.remove_event(other_id)
            eliminated += 1
    return eliminated


def fuse_events(tg: TGraph, max_rounds: int = 16) -> TGraph:
    """Apply successor-set + predecessor-set fusion to a fixpoint."""
    before = tg.num_events()
    for _ in range(max_rounds):
        removed = _fuse_by(tg, "out_tasks")   # Def. 4.1 (successor-set)
        removed += _fuse_by(tg, "in_tasks")   # Def. 4.2 (predecessor-set)
        if removed == 0:
            break
    after = tg.num_events()
    tg.stats["events_post_fusion"] = after
    tg.stats["fusion_reduction"] = (before / after) if after else float("inf")
    return tg
