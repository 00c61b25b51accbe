"""End-to-end MPK compilation driver (paper §4 + Figure 5).

computation graph → decompose → dependency analysis → hybrid-launch
classification → event fusion → start/final events → normalization →
linearization (latency-aware) → ``CompiledTGraph``.

The ``CompiledTGraph`` carries everything downstream consumers need: the
linearized schedule, range-encoded event table, per-tensor workspace layout
(for the megakernel's unified activation buffer), and per-stage statistics
reproducing the paper's Table 2.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .decompose import DecomposeConfig, decompose
from .deps import analyze_dependencies
from .fusion import fuse_events
from .graph import ComputationGraph, OpKind
from .linearize import LinearizedTGraph, linearize
from .normalize import normalize
from .schedule import (
    WorkerPartition,
    count_pipeline_stalls,
    latency_aware_linearize,
    overlap_statistics,
    partition_workers,
)
from .tgraph import TGraph

__all__ = ["CompileOptions", "CompiledTGraph", "megakernelize"]


@dataclasses.dataclass
class CompileOptions:
    decompose: DecomposeConfig = dataclasses.field(default_factory=DecomposeConfig)
    #: use the latency-aware scheduler (beyond-paper); False = plain FIFO
    #: Algorithm 1, which is the paper-faithful baseline
    latency_aware_schedule: bool = True
    #: apply event fusion (ablatable — paper Table 2 "Fusion" column)
    event_fusion: bool = True
    #: workspace alignment in elements
    workspace_align: int = 128
    #: megakernel software-pipeline depth the scheduler separates
    #: producer→consumer pairs by (2 = the kernel's double buffer)
    pipeline_depth: int = 2
    #: decentralized workers the schedule is partitioned onto (paper §5):
    #: the linearized order is split into per-worker queues by the
    #: makespan-minimizing partitioner, lowered to per-worker descriptor
    #: streams synchronized through in-heap event counters
    num_workers: int = 1
    #: task dispatch at runtime (paper §5.1): "static" executes the
    #: partition's per-worker streams as lowered; "dynamic" replaces
    #: them with heap-resident ready queues — workers pop the next ready
    #: task, event-counter triggers enqueue newly-ready consumers, and
    #: the partition survives only as a placement hint
    #: (``runtime/dyn_sched.py``)
    scheduler: str = "static"
    #: emit the heap-resident per-task trace ring (observability): the
    #: kernel timestamps every executed task slot with a logical tick
    #: counter and records worker/task/kind/pop-source/wait-count.  Off
    #: by default so the descriptor table and heap layout stay bitwise
    #: identical to the untraced build.
    trace: bool = False


@dataclasses.dataclass
class CompiledTGraph:
    graph: ComputationGraph
    tg: TGraph
    lin: LinearizedTGraph
    #: tensor -> (offset, size) in the flat activation workspace; graph inputs
    #: are *not* in the workspace (they are passed as separate buffers)
    workspace_layout: Dict[str, Tuple[int, int]]
    workspace_size: int
    stats: Dict[str, Any]
    #: the worker partition of the linearized schedule (always present
    #: after ``megakernelize``; width 1 is exactly the linearized order)
    partition: Optional[WorkerPartition] = None

    # ------------------------------------------------------------------
    @property
    def order(self) -> List[int]:
        return self.lin.order

    def event_table(self) -> np.ndarray:
        """(num_events, 3) int32: [num_triggers, first_task, last_task]."""
        eids = sorted(self.lin.event_ranges)
        out = np.zeros((len(eids), 3), np.int32)
        for row, eid in enumerate(eids):
            out[row] = self.lin.event_ranges[eid]
        return out

    def table2_row(self) -> Dict[str, Any]:
        """The paper's Table-2 columns for this graph."""
        s = self.stats
        return {
            "model": self.graph.name,
            "ops": s["num_ops"],
            "tasks_per_op": round(s["tasks_per_op"], 1),
            "events": s["events_post_fusion"],
            "fusion_x": round(s["fusion_reduction"], 1),
            "lin_x": round(s["lin_reduction"], 1),
            "pair_dependencies": s["pair_dependencies"],
            "dummy_tasks": s.get("dummy_tasks_added", 0),
        }


# --------------------------------------------------------------------------
# Hybrid JIT/AOT launch classification (paper §5.2).
# --------------------------------------------------------------------------


def _classify_launch_modes(g: ComputationGraph, tg: TGraph) -> None:
    """Operators with data-dependent durations are JIT; downstream operators
    remain JIT until a *global barrier* (an event triggered by all tasks of
    every predecessor op), after which operators revert to AOT."""
    per_op_tasks: Dict[int, List[int]] = tg.stats["per_op_tasks"]
    # op-level successor map
    succ: Dict[int, set] = {op.op_id: set() for op in g.ops}
    for prod, cons, _t in g.edges():
        if prod != cons:
            succ[prod].add(cons)

    def is_barrier(op_id: int) -> bool:
        """All tasks of every predecessor op funnel into the dependent events
        of this op's tasks — accumulated imbalance is flushed here."""
        tasks = per_op_tasks[op_id]
        dep_in: set = set()
        for tid in tasks:
            for eid in tg.tasks[tid].dependent_events:
                dep_in |= tg.events[eid].in_tasks
        preds = {
            g.producer[t]
            for tid in tasks
            for t in g.op(tg.tasks[tid].op_id).inputs
            if t in g.producer
        }
        return all(set(per_op_tasks[p]) <= dep_in for p in preds) and len(tasks) == 1

    jit_ops: set = set()
    frontier = [op.op_id for op in g.ops if op.kind in OpKind.DATA_DEPENDENT_KINDS]
    jit_ops.update(frontier)
    while frontier:
        nxt: List[int] = []
        for oid in frontier:
            for m in succ[oid]:
                if m in jit_ops:
                    continue
                if is_barrier(m):
                    continue  # barrier flushes imbalance -> downstream is AOT
                jit_ops.add(m)
                nxt.append(m)
        frontier = nxt
    for op in g.ops:
        op.launch_mode = "jit" if op.op_id in jit_ops else "aot"
    for t in tg.tasks.values():
        if t.op_id >= 0:
            t.launch_mode = g.op(t.op_id).launch_mode
    tg.stats["jit_ops"] = len(jit_ops)
    tg.stats["aot_ops"] = len(g.ops) - len(jit_ops)


# --------------------------------------------------------------------------


def _add_start_final_events(tg: TGraph) -> None:
    """Every tGraph begins with a designated start event (paper §5.1) that
    launches all source tasks, and ends with a final event triggered by all
    sink tasks (used by the runtime to detect step completion)."""
    start = tg.new_event()
    final = tg.new_event()
    for t in tg.tasks.values():
        if not t.dependent_events and t.task_id not in start.out_tasks:
            tg.add_dependent(start, t)
        if not t.triggering_events and t.task_id not in final.in_tasks:
            tg.add_trigger(t, final)
    tg.stats["start_event"] = start.event_id
    tg.stats["final_event"] = final.event_id


def _pack_workspace(
    g: ComputationGraph, align: int, lin: Optional[LinearizedTGraph] = None,
    tg: Optional[TGraph] = None,
) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """Assign every non-input tensor an offset in one flat workspace buffer,
    reusing slots via liveness: a tensor's slot is freed after the *last
    task of its last consumer* in linearized order, so tensors with
    disjoint live ranges share bytes.

    This is the compiler's activation-memory plan (reported as
    ``workspace_elements`` / ``workspace_reuse_x``); the interpret-mode
    megakernel heap in ``kernels/megakernel/desc.py`` still lays tensors
    out row-padded without reuse — wiring its ``_build_layout`` to these
    offsets (valid: the grid executes in linearized order) is recorded
    future work.

    Live range of tensor ``t`` (in linearized task positions): from the
    first task of its producer op to the last task of any consumer op
    (graph outputs stay live forever).  Allocation is first-fit over an
    address-ordered free list with coalescing; without ``lin`` (no
    schedule yet) it degrades to the plain bump allocator.
    """
    inputs = set(g.inputs)
    outputs = set(g.outputs)
    names = [n for n in g.tensors if n not in inputs]

    # ---- live ranges in linearized task positions ----
    if lin is not None and tg is not None:
        op_first: Dict[int, int] = {}
        op_last: Dict[int, int] = {}
        for pos, tid in enumerate(lin.order):
            oid = tg.tasks[tid].op_id
            if oid < 0:
                continue
            op_first.setdefault(oid, pos)
            op_last[oid] = pos
        infinity = len(lin.order) + 1

        def live_range(name: str) -> Tuple[int, int]:
            prod = g.producer.get(name)
            start = op_first.get(prod, 0) if prod is not None else 0
            if name in outputs:
                return start, infinity
            # the producer's own last task keeps the slot live: an
            # interleaved schedule may finish every consumer before the
            # producer's final tile lands
            end = op_last.get(prod, start) if prod is not None else start
            for cons in g.consumers.get(name, ()):
                end = max(end, op_last.get(cons, start))
            return start, end
    else:
        def live_range(name: str) -> Tuple[int, int]:
            return 0, len(names) + 1

    ranges = {n: live_range(n) for n in names}
    aligned = lambda s: (s + align - 1) // align * align

    # ---- first-fit free-list allocation in order of first use ----
    layout: Dict[str, Tuple[int, int]] = {}
    free: List[Tuple[int, int]] = []       # (offset, size), address-ordered
    pending: List[Tuple[int, int, int]] = []  # (free_pos, offset, size)
    top = 0

    def release(off: int, size: int) -> None:
        i = bisect.bisect_left(free, (off, size))
        if i < len(free) and off + size == free[i][0]:  # merge right
            size += free[i][1]
            free.pop(i)
        if i > 0 and free[i - 1][0] + free[i - 1][1] == off:  # merge left
            off = free[i - 1][0]
            size += free[i - 1][1]
            free.pop(i - 1)
            i -= 1
        free.insert(i, (off, size))

    for name in sorted(names, key=lambda n: (ranges[n][0], n)):
        start, end = ranges[name]
        still = []
        for fp, off, size in pending:
            if fp < start:
                release(off, size)
            else:
                still.append((fp, off, size))
        pending = still
        size = aligned(g.tensors[name].size)
        slot = None
        for i, (off, fsize) in enumerate(free):
            if fsize >= size:
                slot = off
                if fsize > size:
                    free[i] = (off + size, fsize - size)
                else:
                    free.pop(i)
                break
        if slot is None:
            slot = top
            top += size
        layout[name] = (slot, g.tensors[name].size)
        pending.append((end, slot, size))
    return layout, top


def megakernelize(
    g: ComputationGraph, options: Optional[CompileOptions] = None
) -> CompiledTGraph:
    """The MPK compiler: computation graph → compiled SM-level tGraph."""
    opts = options or CompileOptions()
    if opts.scheduler not in ("static", "dynamic"):
        raise ValueError(f"unknown scheduler {opts.scheduler!r}; "
                         "expected 'static' or 'dynamic'")
    g.validate()

    tg = decompose(g, opts.decompose)
    analyze_dependencies(g, tg)
    _classify_launch_modes(g, tg)
    if opts.event_fusion:
        fuse_events(tg)
    else:
        tg.stats["events_post_fusion"] = tg.num_events()
        tg.stats["fusion_reduction"] = 1.0
    _add_start_final_events(tg)
    normalize(tg)
    if opts.latency_aware_schedule:
        lin = latency_aware_linearize(tg, opts.pipeline_depth)
    else:
        lin = linearize(tg)

    layout, ws_size = _pack_workspace(g, opts.workspace_align, lin, tg)

    partition = partition_workers(tg, lin, opts.num_workers,
                                  opts.pipeline_depth)

    stats = dict(tg.stats)
    stats.pop("per_op_tasks", None)
    stats["pipeline_depth"] = opts.pipeline_depth
    stats["pipeline_stalls"] = count_pipeline_stalls(lin, opts.pipeline_depth)
    stats.setdefault("pipeline_stalls_naive", stats["pipeline_stalls"])
    stats["stall_reduction"] = (
        max(1, stats["pipeline_stalls_naive"])
        / max(1, stats["pipeline_stalls"]))
    stats.update(overlap_statistics(lin))
    stats["workspace_elements"] = ws_size
    # the bump-allocator footprint (no reuse), for the shrink report
    bump = sum((g.tensors[n].size + opts.workspace_align - 1)
               // opts.workspace_align * opts.workspace_align
               for n in layout)
    stats["workspace_elements_no_reuse"] = bump
    stats["workspace_reuse_x"] = bump / max(ws_size, 1)
    stats["scheduler"] = opts.scheduler
    stats["num_workers"] = partition.num_workers
    stats["worker_queue_lens"] = [len(q) for q in partition.queues]
    stats["cross_worker_deps"] = len(partition.cross_deps)
    stats["partition_steps"] = partition.num_steps
    stats["partition_makespan_est_us"] = partition.est_makespan * 1e6
    compiled = CompiledTGraph(g, tg, lin, layout, ws_size, stats, partition)
    return compiled
