"""Dependency analysis (paper §4.1, C3).

For any two operators sharing a tensor, MPK enumerates all task pairs from
the two operators and introduces an event ``e`` for a pair ``(t1, t2)`` iff
the output region produced by ``t1`` overlaps the input region consumed by
``t2``.  Edges ``(t1, e)`` and ``(e, t2)`` are inserted into the tGraph.
"""
from __future__ import annotations

from typing import Dict, List

from .graph import ComputationGraph
from .tgraph import TGraph

__all__ = ["analyze_dependencies"]


def analyze_dependencies(g: ComputationGraph, tg: TGraph) -> TGraph:
    per_op_tasks: Dict[int, List[int]] = tg.stats["per_op_tasks"]
    pair_count = 0
    for prod_op, cons_op, tensor in g.edges():
        prod_tasks = per_op_tasks[prod_op]
        cons_tasks = per_op_tasks[cons_op]
        # Pre-extract the regions touching `tensor` once per task.
        prod_regions = [
            (tid, tg.tasks[tid].out_regions.get(tensor)) for tid in prod_tasks
        ]
        cons_regions = [
            (tid, tg.tasks[tid].in_regions.get(tensor)) for tid in cons_tasks
        ]
        for t1, out_r in prod_regions:
            if out_r is None:
                continue
            for t2, in_r in cons_regions:
                if in_r is None:
                    continue
                if out_r.overlaps(in_r):
                    e = tg.new_event()
                    tg.connect(tg.tasks[t1], e, tg.tasks[t2])
                    pair_count += 1
    # Table-2 "Fusion" column baseline: one event per producer–consumer task
    # pair before fusion.
    tg.stats["pair_dependencies"] = pair_count
    tg.stats["events_pre_fusion"] = pair_count
    return tg
