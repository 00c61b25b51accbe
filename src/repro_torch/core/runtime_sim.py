"""Discrete-event simulator of the in-kernel parallel runtime (paper §5).

The port's copy of the reference's ``repro/core/runtime_sim.py``.  It
executes the compiled tGraph with a discrete-event model of workers,
schedulers and DMA channels, with per-task times from the roofline
terms of ``roofline/hw.py``: the reference's TPU cost model, kept so
that its makespans equal the reference's.  They are model numbers, not
the H100's; the card's own times come from ``chip_smoke.py``.  Five
execution models:

  kernel_per_op — operator-at-a-time with a kernel barrier + launch
                  overhead between operators (the baseline of Fig. 2/9),
  mpk           — the compiler's actual worker partition
                  (``core/schedule.partition_workers``) replayed queue by
                  queue: per-worker static streams, cross-worker
                  dependencies paying one event-counter wait (AOT) or the
                  worker→scheduler→worker hop (JIT, §5.2), communication
                  overlapped on DMA channels (§6.5).  The simulator no
                  longer invents its own greedy lane assignment — the
                  makespan/utilization it reports measure the schedule the
                  megakernel really executes,
  mpk_coarse    — event-driven execution with operator-granularity events
                  (Fig. 5c), the compute–communication-overlap ablation
                  of Fig. 13,
  mpk_tp        — the multi-chip megakernel (``SimConfig.tp`` chips):
                  the same worker-partition replay as ``mpk``, but every
                  ALLREDUCE task charges the chunked ring-allreduce of
                  ``distributed/comm_tasks.py`` — the SAME
                  ``expand_ring_allreduce`` schedule the descriptor
                  stamper lowers into the kernel.  At ``tp <= 1`` the
                  branch reduces *exactly* to ``mpk`` (identical code
                  path).  ``comm_plan="serialized"`` is the whole-tensor
                  baseline: the tensor crosses the wire twice per
                  collective with no chunking,
  mpk_dyn       — the decentralized *dynamic* scheduler
                  (``runtime/dyn_sched.py``): workers pop ready tasks
                  from heap-resident queues (own pool → shared overflow
                  → stealing), event-counter triggers enqueue newly-
                  ready consumers at runtime.  Charges match the mpk
                  replay task for task (same pipelined costs, same
                  cross-worker event waits, the same demand-load stall
                  rule applied to pop gaps), so mpk vs mpk_dyn isolates
                  exactly what runtime dispatch buys.

Per-task time = max(flops/worker_flops, bytes/worker_bw) + task_overhead;
comm-task time = bytes/ici_bw.  Hardware constants come from
``roofline/hw.py`` (the reference's TPU-v5e-class chip) so that
scheduler and simulator share one source of truth.

**Skewed-cost model** (``SimConfig.kv_lens``): per-batch-slot live KV
lengths scale every ATTENTION_DECODE task's cost by
``mean(kv_lens[rows]) / max(kv_lens)`` — the nominal roofline cost
assumes every slot reads the full cache, so a ragged decode batch makes
some attention tiles proportionally cheaper.  The static partition was
balanced for uniform costs and cannot react; the dynamic scheduler
rebalances by construction.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

from ..roofline.hw import (AOT_EVENT_WAIT, COMM_LATENCY, COMPUTE_LATENCY,
                           JIT_HOP, TASK_OVERHEAD, TPU_V5E, WORKERS_PER_CHIP,
                           comm_time)
from .compile import CompiledTGraph
from .graph import OpKind
from .schedule import partition_workers, replay_partition

__all__ = ["SimConfig", "SimResult", "simulate", "skewed_time_fn",
           "ragged_kv_lens", "predicted_timeline"]


@dataclasses.dataclass
class SimConfig:
    n_workers: int = WORKERS_PER_CHIP          # SM/core-equivalents per chip
    worker_flops: float = TPU_V5E.peak_flops_bf16 / WORKERS_PER_CHIP
    worker_bw: float = TPU_V5E.hbm_bw / WORKERS_PER_CHIP
    ici_bw: float = TPU_V5E.ici_link_bw
    n_dma: int = 4                   # concurrent comm channels
    task_overhead: float = TASK_OVERHEAD      # dequeue + descriptor decode
    compute_latency: float = COMPUTE_LATENCY  # VPU/MXU issue floor per task
    comm_latency: float = COMM_LATENCY    # per-collective base latency
    jit_hop: float = JIT_HOP          # worker->scheduler->worker (§5.2)
    aot_wait: float = AOT_EVENT_WAIT  # one event wait
    launch_overhead: float = 3.8e-6  # per-kernel launch (paper §6.6)
    mode: str = "mpk"   # kernel_per_op | mpk | mpk_coarse | mpk_dyn | mpk_tp
    overlap_comm: bool = True
    #: number of TP chips (mode="mpk_tp"); tp<=1 reduces exactly to "mpk"
    tp: int = 1
    #: collective cost model for mode="mpk_tp": "ring" charges the
    #: chunked ring rounds the kernel really executes, "serialized" the
    #: whole-tensor two-pass baseline of fig13
    comm_plan: str = "ring"
    #: per-batch-slot live KV lengths (ragged decode): scales attention
    #: task costs by mean(kv_lens[task rows]) / max(kv_lens); None =
    #: uniform (every slot at the nominal full-cache cost)
    kv_lens: Optional[Sequence[int]] = None
    #: model cross-task software pipelining (paper §5 / Fig. 12): a task's
    #: operand loads overlap the previous task's compute, so per-task time
    #: is max(load, compute) instead of load + compute — EXCEPT for tasks
    #: scheduled fewer than ``pipeline_depth`` steps after a producer,
    #: whose prefetch the megakernel must demand-load (a pipeline stall).
    #: ``pipelined=False`` is the per-row synchronous-copy baseline.
    pipelined: bool = True
    pipeline_depth: int = 2
    #: extra per-pop cost of the dynamic scheduler (mode="mpk_dyn").
    #: Default 0: the queue-head pop-ahead hides the dequeue behind the
    #: previous task's compute exactly as descriptor prefetch hides the
    #: static stream's decode — set > 0 for sensitivity analysis.
    queue_overhead: float = 0.0


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy_frac: float                 # mean worker utilization
    n_tasks: int
    n_comm: int
    launches: int
    #: per-worker utilization (busy/makespan) when the run replayed a
    #: worker partition (mode="mpk"); None for the other models
    worker_busy: Optional[List[float]] = None


def _task_time(task, cfg: SimConfig, stalled: bool = False,
               in_kernel: bool = True) -> float:
    if task.is_dummy:
        return 0.0
    if task.is_comm:
        return comm_time(task.bytes_moved(), ici_bw=cfg.ici_bw,
                         latency=cfg.comm_latency)
    load = task.bytes_moved() / cfg.worker_bw
    comp = task.flops() / cfg.worker_flops + cfg.compute_latency
    if cfg.pipelined and not stalled:
        # operand loads hidden behind the previous task's compute; the
        # dequeue+decode overhead is hidden too, but ONLY inside the
        # persistent kernel (descriptor prefetch, paper §5.3) — per-op
        # kernels pipeline their tiles internally yet still pay dispatch
        core = max(load, comp)
        return core if in_kernel else core + cfg.task_overhead
    # serialized decode-then-load-then-compute (the per-row-copy kernel)
    return load + comp + cfg.task_overhead


def ragged_kv_lens(batch: int, max_seq: int, skew: float) -> List[int]:
    """A ragged decode batch with skew factor ``skew``: per-slot live KV
    lengths ramping linearly from ``max_seq`` (slot 0) down to
    ``max_seq / skew`` (last slot).  ``skew=1`` is the uniform batch."""
    assert skew >= 1.0 and batch >= 1
    if batch == 1:
        return [max_seq]
    lo = max_seq / skew
    return [max(1, round(max_seq - (max_seq - lo) * i / (batch - 1)))
            for i in range(batch)]


def skewed_time_fn(base_fn, kv_lens: Sequence[int]):
    """Wrap a ``time_fn(task, stalled)`` with the ragged-decode cost
    model: an ATTENTION_DECODE task covering batch rows ``[r0, r0+m)``
    costs ``mean(kv_lens[r0:r0+m]) / max(kv_lens)`` of its nominal time
    (the nominal roofline cost reads the full cache for every slot).
    Non-attention tasks are unchanged, so the skew isolates exactly the
    raggedness the paper's dynamic scheduler absorbs."""
    kv = list(kv_lens)
    ref = max(kv) if kv else 1

    def fn(task, stalled):
        t = base_fn(task, stalled)
        if task.kind == OpKind.ATTENTION_DECODE and ref > 0:
            region = next(iter(task.out_regions.values()), None)
            if region is not None:
                r0 = region.starts[0]
                m = max(1, region.shape[0])
                rows = [kv[min(r, len(kv) - 1)]
                        for r in range(r0, r0 + m)]
                t = t * (sum(rows) / len(rows)) / ref
        return t
    return fn


def _mpk_cost_model(compiled: CompiledTGraph, cfg: SimConfig):
    """The ``(partition, time_fn, wait_fn)`` triple the mpk/mpk_dyn/
    mpk_tp replays run under (paper §5).  The partition IS the schedule
    the megakernel executes: static per-worker queues cut out of the
    linearized order, synchronized by in-heap event counters on the
    cross-worker edges.  When the compile-time width differs from the
    simulated one (W sweeps), the same partitioner is re-run at the
    requested width — never an ad-hoc greedy lane assignment."""
    tg = compiled.tg
    part = compiled.partition

    if cfg.mode == "mpk_tp" and cfg.tp > 1:
        # multi-chip: collectives charge the lockstep ring expansion
        # (or the whole-tensor baseline), everything else is the
        # single-chip cost — the TP model keeps global shapes
        from ..distributed.comm_tasks import (ring_duration,
                                              serialized_duration)

        def _wire(nbytes):
            return comm_time(nbytes, ici_bw=cfg.ici_bw,
                             latency=cfg.comm_latency)
        coll_fn = (serialized_duration
                   if cfg.comm_plan == "serialized" else ring_duration)

        def base_time_fn(task, is_stalled):
            if task.is_comm and not task.is_dummy:
                span_words = int(task.bytes_moved() // 4)
                return coll_fn(span_words, cfg.tp, time_fn=_wire)
            return _task_time(task, cfg, is_stalled)
    else:
        def base_time_fn(task, is_stalled):
            return _task_time(task, cfg, is_stalled)

    def wait_fn(task):
        return (cfg.jit_hop if task.launch_mode == "jit"
                else cfg.aot_wait)

    if part is None or part.requested_workers != cfg.n_workers:
        # the partitioner always balances for the NOMINAL (uniform)
        # costs — compile time cannot predict runtime raggedness,
        # which is exactly what mpk vs mpk_dyn measures under skew
        part = partition_workers(tg, compiled.lin, cfg.n_workers,
                                 cfg.pipeline_depth,
                                 time_fn=base_time_fn,
                                 wait_fn=wait_fn,
                                 overlap_comm=cfg.overlap_comm,
                                 n_dma=cfg.n_dma)
    time_fn = (skewed_time_fn(base_time_fn, cfg.kv_lens)
               if cfg.kv_lens is not None else base_time_fn)
    return part, time_fn, wait_fn


def predicted_timeline(compiled: CompiledTGraph,
                       cfg: Optional[SimConfig] = None) -> Dict[str, object]:
    """The *predicted* per-task timeline of the mpk replays, in one
    schema: ``{"mode", "makespan", "start", "end", "worker"}`` with
    ``start``/``end``/``worker`` keyed by task id.  ``mode="mpk"`` (or
    ``"mpk_tp"``) replays the static partition with
    :func:`~repro_torch.core.schedule.replay_partition`; ``mode="mpk_dyn"``
    runs :func:`~repro_torch.runtime.dyn_sched.simulate_dynamic` and converts
    its descriptor-row keys back to task ids.  The ``obs`` package
    reconciles this against the kernel's trace ring."""
    cfg = cfg or SimConfig()
    if cfg.mode not in ("mpk", "mpk_dyn", "mpk_tp"):
        raise ValueError(f"predicted_timeline needs an mpk mode, got "
                         f"{cfg.mode!r}")
    tg = compiled.tg
    part, time_fn, wait_fn = _mpk_cost_model(compiled, cfg)

    if cfg.mode == "mpk_dyn":
        from ..runtime.dyn_sched import build_dyn_sched, simulate_dynamic
        dyn = build_dyn_sched(compiled, part)
        tasks = [tg.tasks[tid] for tid in compiled.order]
        dres = simulate_dynamic(
            dyn, tasks, time_fn, wait_fn,
            queue_overhead=cfg.queue_overhead,
            pipeline_depth=(cfg.pipeline_depth if cfg.pipelined else 1),
            overlap_comm=cfg.overlap_comm, n_dma=cfg.n_dma)
        order = compiled.order
        return {
            "mode": cfg.mode,
            "makespan": dres.makespan,
            "start": {order[r]: t for r, t in dres.start.items()},
            "end": {order[r]: t for r, t in dres.done.items()},
            "worker": {order[r]: w for r, w in dres.worker.items()},
        }

    res = replay_partition(
        tg, part.queues, part.step_of, time_fn=time_fn, wait_fn=wait_fn,
        pipeline_depth=cfg.pipeline_depth if cfg.pipelined else 1,
        overlap_comm=cfg.overlap_comm, n_dma=cfg.n_dma)
    return {
        "mode": cfg.mode,
        "makespan": res.makespan,
        "start": dict(res.start),
        "end": dict(res.done),
        "worker": dict(part.worker_of),
    }


def simulate(compiled: CompiledTGraph,
             cfg: Optional[SimConfig] = None) -> SimResult:
    cfg = cfg or SimConfig()
    tg = compiled.tg
    g = compiled.graph

    if cfg.mode == "kernel_per_op":
        # operator-at-a-time: tasks of one op run in waves over workers;
        # a kernel barrier + launch overhead separates operators.
        t = 0.0
        busy = 0.0
        per_op: Dict[int, List[int]] = {}
        for tid in compiled.order:
            task = tg.tasks[tid]
            if task.is_dummy:
                continue
            per_op.setdefault(task.op_id, []).append(tid)
        for op in g.topo_order():
            tids = per_op.get(op, [])
            if not tids:
                continue
            t += cfg.launch_overhead
            lanes = [0.0] * (cfg.n_workers if not g.op(op).is_comm
                             else cfg.n_dma)
            for tid in tids:
                i = lanes.index(min(lanes))
                dt = _task_time(tg.tasks[tid], cfg, in_kernel=False)
                lanes[i] += dt
                busy += dt
            t += max(lanes)
        return SimResult(t, busy / (t * cfg.n_workers + 1e-30),
                         sum(len(v) for v in per_op.values()),
                         sum(1 for x in tg.tasks.values() if x.is_comm),
                         len(per_op))

    if cfg.mode in ("mpk", "mpk_dyn", "mpk_tp"):
        part, time_fn, wait_fn = _mpk_cost_model(compiled, cfg)
        width = max(1, part.num_workers)

        if cfg.mode == "mpk_dyn":
            # ---- decentralized dynamic scheduler (ready queues) ----
            from ..runtime.dyn_sched import build_dyn_sched, simulate_dynamic
            dyn = build_dyn_sched(compiled, part)
            tasks = [tg.tasks[tid] for tid in compiled.order]
            dres = simulate_dynamic(
                dyn, tasks, time_fn, wait_fn,
                queue_overhead=cfg.queue_overhead,
                pipeline_depth=(cfg.pipeline_depth if cfg.pipelined
                                else 1),
                overlap_comm=cfg.overlap_comm, n_dma=cfg.n_dma)
            makespan = dres.makespan
            return SimResult(
                makespan,
                sum(dres.busy) / (makespan * width + 1e-30),
                sum(1 for x in tg.tasks.values() if not x.is_dummy),
                sum(1 for x in tg.tasks.values() if x.is_comm),
                1,
                worker_busy=[b / max(makespan, 1e-30)
                             for b in dres.busy])

        res = replay_partition(
            tg, part.queues, part.step_of, time_fn=time_fn,
            wait_fn=wait_fn,
            pipeline_depth=cfg.pipeline_depth if cfg.pipelined else 1,
            overlap_comm=cfg.overlap_comm, n_dma=cfg.n_dma)
        makespan = res.makespan
        return SimResult(
            makespan,
            sum(res.busy) / (makespan * width + 1e-30),
            sum(1 for x in tg.tasks.values() if not x.is_dummy),
            sum(1 for x in tg.tasks.values() if x.is_comm),
            1,
            worker_busy=[b / max(makespan, 1e-30) for b in res.busy])

    # ---- event-driven runtime with operator-granularity events ----
    # (mpk_coarse, the Fig. 5c/13 ablation: coarse events cannot express
    # a per-task worker cut, so this keeps the event-driven model)
    stalled: set = set()
    if cfg.pipelined:
        pos = compiled.lin.index
        for a, b in tg.task_dependencies():
            if 0 < pos[b] - pos[a] < cfg.pipeline_depth:
                stalled.add(b)

    # coarse mode: a task depends on ALL tasks of its producer operators
    deps_done: Dict[int, int] = {}
    dependents: Dict[int, List[int]] = {tid: [] for tid in tg.tasks}
    if cfg.mode == "mpk_coarse":
        per_op: Dict[int, List[int]] = {}
        for tid, task in tg.tasks.items():
            if not task.is_dummy:
                per_op.setdefault(task.op_id, []).append(tid)
        n_deps = {tid: 0 for tid in tg.tasks}
        for prod, cons, _t in g.edges():
            if prod == cons:
                continue
            for a in per_op.get(prod, ()):
                for b in per_op.get(cons, ()):
                    dependents[a].append(b)
                    n_deps[b] += 1
        # dummies: free
        deps_left = n_deps
    else:
        deps_left = {tid: 0 for tid in tg.tasks}
        for a, b in tg.task_dependencies():
            dependents[a].append(b)
            deps_left[b] += 1

    ready: List[tuple] = []
    seq = 0
    for tid in compiled.order:
        if deps_left[tid] == 0:
            extra = (cfg.jit_hop if tg.tasks[tid].launch_mode == "jit"
                     else cfg.aot_wait)
            heapq.heappush(ready, (0.0 + extra, seq, tid))
            seq += 1

    workers = [0.0] * cfg.n_workers
    dma = [0.0] * cfg.n_dma
    busy = 0.0
    done_time: Dict[int, float] = {}
    n_done = 0
    while ready:
        avail, _s, tid = heapq.heappop(ready)
        task = tg.tasks[tid]
        dt = _task_time(task, cfg, tid in stalled)
        if task.is_comm and cfg.overlap_comm:
            lane = dma.index(min(dma))
            start = max(avail, dma[lane])
            dma[lane] = start + dt
        else:
            lane = workers.index(min(workers))
            start = max(avail, workers[lane])
            workers[lane] = start + dt
            busy += dt
        end = start + dt
        done_time[tid] = end
        n_done += 1
        for m in dependents[tid]:
            deps_left[m] -= 1
            if deps_left[m] == 0:
                extra = (cfg.jit_hop if tg.tasks[m].launch_mode == "jit"
                         else cfg.aot_wait)
                heapq.heappush(ready, (end + extra, seq, m))
                seq += 1
    assert n_done == len(tg.tasks), (n_done, len(tg.tasks))
    makespan = max(done_time.values()) if done_time else 0.0
    return SimResult(makespan,
                     busy / (makespan * cfg.n_workers + 1e-30),
                     sum(1 for x in tg.tasks.values() if not x.is_dummy),
                     sum(1 for x in tg.tasks.values() if x.is_comm),
                     1)
