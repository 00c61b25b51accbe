"""Megakernel execution: a static plan compiled once, then a persistent
executor that runs every decode step as ONE kernel launch against a
device-resident heap.

``compile_decode_megakernel`` lowers a config's decode step to a
:class:`~.desc.MegakernelPlan`; :class:`MegakernelExecutor` makes it a
live program, as the reference's executor does:

* the heap is built once (``upload_count``): weights go into their slots
  one tensor at a time, state slots start at zero;
* the KV cache stays in the heap across steps (the kernel updates it in
  place);
* the per-step inputs (tokens, positions, seq_lens, live_lens) go into
  the heap through one ``index_copy_`` before each launch.  The same copy
  writes zeros over the event table and the trace ring's tick counter:
  the kernel counts both up during a launch, and a launch that found its
  counters at their trigger counts would let every wait pass before its
  producers ran.  Under the dynamic scheduler it also rewrites the
  initial queue image (pools, overflow, [pushed, popped] pairs), which a
  launch consumes, and zeroes the ticket: still one host operation
  and one launch per step;
* a dynamic plan's scheduler table goes to the device once, and so do
  the idle entries of its pop trace and ring (the slots past T of the
  reference's grid, which the kernel never writes).

``tp > 1`` compiles the TP graph (ALLREDUCE after every output
projection) and stamps the plan for ``tp`` chips over the fused
transport (``desc.stamp_multichip``): C copies of the tensor region in
one heap, the collectives run as COMM tasks of the one launch.  The
executor writes the per-step inputs into every chip's region, zeroes the
arrival counters with the events, builds the weights in chip 0's region
and copies it to the others on the device, writes state into chip 0 and
copies it likewise, and reads logits and state from chip 0 (every chip
holds the same bits).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.compile import CompileOptions, megakernelize
from ..core.decompose import DecomposeConfig
from ..core.lowering import build_decode_graph
from ..device import resolve_device
from ..models.lm import fill_params
from ..runtime.dyn_sched import QUEUE_EMPTY
from .desc import (STATS_WORDS, TRACE_HEADER, TRACE_WORDS,
                   MegakernelPlan, lower_tgraph, stamp_multichip)
from .kernel import check_plan, check_workers, megakernel

__all__ = ["compile_decode_megakernel", "MegakernelExecutor",
           "STATS_FIELDS", "decode_stats_row", "read_stats_block"]

#: named field map of the per-worker STATS block: counter name → word.
#: Word 4 is the 2^20-unit spill of ``row_copies``, folded back in by
#: ``decode_stats_row``.
STATS_FIELDS = {
    "bulk_copies": 0,
    "row_copies": 1,
    "prefetch_tiles": 2,
    "primary_fallbacks": 3,
    "event_waits": 5,
    "event_wait_violations": 6,
    "event_signals": 7,
    "pops_own": 8,
    "pops_overflow": 9,
    "steals": 10,
    "idle_slots": 11,
}

ROW_SPILL_WORD = 4
ROW_SPILL_UNIT = 1 << 20


def decode_stats_row(v) -> Dict[str, int]:
    """One worker's STATS block as named integer counters."""
    out = {name: int(v[i]) for name, i in STATS_FIELDS.items()}
    out["row_copies"] += ROW_SPILL_UNIT * int(v[ROW_SPILL_WORD])
    return out


def read_stats_block(heap: torch.Tensor, stats_offset: int,
                     num_workers: int) -> List[Dict[str, int]]:
    """The per-worker STATS blocks of a heap, one counter dict each."""
    flat = heap[stats_offset:stats_offset + num_workers * STATS_WORDS]
    flat = flat.cpu().numpy()
    return [decode_stats_row(flat[w * STATS_WORDS:(w + 1) * STATS_WORDS])
            for w in range(num_workers)]


def compile_decode_megakernel(cfg, batch: int, max_seq: int,
                              *, num_workers: int = 1,
                              scheduler: str = "static",
                              tp: int = 1,
                              trace: bool = False) -> MegakernelPlan:
    """Lower cfg's decode step: op graph → tGraph → descriptors, with the
    reference's default compile options (tile rows capped at 8, the
    megakernel's TM).  ``num_workers`` is the W the partitioner may use
    (it picks the width with the least estimated makespan, at most W);
    ``scheduler`` is "static" (per-worker descriptor streams) or
    "dynamic" (the ready pools of ``runtime/dyn_sched.py``, with the
    partition as the affinity hint); ``trace`` adds the trace ring to
    the heap.  ``lower_tgraph(plan.compiled, cfg, scheduler=...)`` lowers
    the other scheduler's plan from the same compiled graph.  ``tp > 1``
    inserts the ALLREDUCE ops and stamps the plan for ``tp`` chips, whose
    C · W worker lanes must all be resident on the card (static
    scheduler only, as in the reference)."""
    if tp > 1 and scheduler != "static":
        raise NotImplementedError(
            "tp > 1 megakernels require scheduler='static' (the dynamic "
            "ready pools are not chip-stamped)")
    g = build_decode_graph(cfg, batch, max_seq, tp=tp)
    opts = CompileOptions(decompose=DecomposeConfig(max_rows=8),
                          num_workers=num_workers, scheduler=scheduler,
                          trace=trace)
    plan = lower_tgraph(megakernelize(g, opts), cfg, scheduler=scheduler,
                        trace=trace)
    return stamp_multichip(plan, tp) if tp > 1 else plan


class MegakernelExecutor:
    """The live half of a compiled megakernel program.

    Lifecycle::

        ex = MegakernelExecutor(plan, cfg, device="cuda")
        ex.bind(params)                       # the ONE heap build
        logits = ex.step(tokens, seq_lens)    # index_copy_ + 1 launch
        logits = ex.step(tokens, seq_lens + 1)  # state carried in-heap
    """

    def __init__(self, plan: MegakernelPlan, cfg, device=None):
        self.plan = plan
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_plan(plan.statics, plan.descs)
            check_workers(plan.statics, self.device)
        self.upload_count = 0
        self.state_scatter_count = 0
        classes = plan.input_classes()
        self._weights: List[str] = classes["weights"]
        self._state: List[str] = classes["state"]

        # flat heap indices of every per-step input element, in one
        # int64 index for the per-step index_copy_
        idx, self._entries = [], []
        chips = np.arange(plan.n_chips, dtype=np.int64) * plan.chip_stride
        for name in classes["per_step"]:
            slot = plan.layout[name]
            cols = slot.shape[-1]
            grid = (slot.offset + np.arange(slot.rows)[:, None] * slot.ld
                    + np.arange(cols)[None, :])
            self._entries.append((name, slot.rows * cols))
            idx.append((chips[:, None] + grid.ravel()[None, :]).ravel())
        # counters the kernel counts up, zeroed before every launch, and
        # under the dynamic scheduler the queue image it consumes
        tail = [np.zeros((plan.num_events,), np.float32)]
        idx.append(np.arange(plan.event_offset,
                             plan.event_offset + plan.num_events))
        self._sched = None
        if plan.dynamic:
            pools, cursors = plan.dyn.queue_image()
            image = np.concatenate([pools, cursors])
            tail.append(image)
            idx.append(np.arange(plan.queue_offset,
                                 plan.queue_offset + image.size))
            self._sched = torch.from_numpy(plan.dyn.sched_table()) \
                .to(self.device)
        if plan.trace:
            tail.append(np.zeros((1,), np.float32))
            idx.append(np.array([plan.ring_offset]))
        # the ticket, or a multichip plan's arrival counters
        tail.append(np.zeros((plan.ctl_words,), np.float32))
        idx.append(np.arange(plan.ctl_offset,
                             plan.ctl_offset + plan.ctl_words))
        self._tail = np.concatenate(tail)
        self._upd_idx = torch.from_numpy(
            np.concatenate(idx).astype(np.int64)).to(self.device)
        self._descs = torch.from_numpy(plan.descs).to(self.device)
        self._acks = None if plan.acks is None else \
            torch.from_numpy(plan.acks).to(self.device)
        self.heap: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ the heap
    def upload(self, heap: torch.Tensor) -> None:
        """Adopt a full heap (weights included): once per ``bind``.  A
        dynamic plan's idle pop-trace and ring entries are written here,
        as the reference's grid leaves them."""
        self.heap = heap.to(self.device)
        self.upload_count += 1
        plan = self.plan
        if plan.dynamic:
            T, W = plan.dyn.num_tasks, plan.num_workers
            slots = plan.num_steps * W
            self.heap[plan.trace_offset + T:plan.trace_offset + slots] = \
                QUEUE_EMPTY
            if plan.trace:
                i = np.arange(T, slots)
                idle = np.zeros((slots - T, TRACE_WORDS), np.float32)
                idle[:, 0] = i % W
                idle[:, 1:3] = -1.0
                idle[:, 3], idle[:, 4] = 2 * i, 2 * i + 1
                idle[:, 5] = -1.0
                base = plan.ring_offset + TRACE_HEADER
                self.heap[base + T * TRACE_WORDS:base + slots * TRACE_WORDS] \
                    = torch.from_numpy(idle.ravel()).to(self.device)

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Build the heap from graph-named weights, one tensor at a time
        into chip 0's region (then copied to the other chips'); state and
        per-step slots start at zero."""
        heap = self.plan.alloc_heap(self.device)
        for name in self._weights:
            w = params["embed"].T if (name == "lm_head"
                                      and "lm_head" not in params) \
                else params[name]
            self.plan.view(heap, name).copy_(w)
        self._replicate(heap, 0, self.plan.chip_stride)
        self.upload(heap)

    def init_weights(self, generator: torch.Generator) -> None:
        """Build the heap with random weights drawn straight into their
        slots of chip 0's region (``models.lm.fill_params``), then copied
        to the other chips' on the device: no copy of the weights outside
        the heap ever exists."""
        heap = self.plan.alloc_heap(self.device)
        fill_params(self.cfg, self._views(heap, self._weights), generator)
        self._replicate(heap, 0, self.plan.chip_stride)
        self.upload(heap)

    def _replicate(self, heap: torch.Tensor, lo: int, hi: int) -> None:
        """Copy words [lo, hi) of chip 0's region into every other
        chip's (a device copy each)."""
        for c in range(1, self.plan.n_chips):
            base = c * self.plan.chip_stride
            heap[base + lo:base + hi].copy_(heap[lo:hi])

    def _views(self, heap, names) -> Dict[str, torch.Tensor]:
        return {n: self.plan.view(heap, n) for n in names}

    def weight_views(self) -> Dict[str, torch.Tensor]:
        """Every weight as a strided view of the resident heap."""
        assert self.heap is not None, "bind() first"
        return self._views(self.heap, self._weights)

    # --------------------------------------------------------------- state
    def reset_state(self, slot: Optional[int] = None) -> None:
        """Zero the state in place, in every chip's region: one batch
        row, or all of them."""
        for c in range(self.plan.n_chips):
            for n in self._state:
                v = self.plan.view(self.heap, n, c)
                (v if slot is None else v[slot]).zero_()

    def read_state(self) -> Dict[str, torch.Tensor]:
        """A copy of every state tensor (graph-shaped) of chip 0, weights
        untouched."""
        return {n: v.clone() for n, v in
                self._views(self.heap, self._state).items()}

    def write_state(self, tensors: Mapping[str, torch.Tensor]) -> None:
        """Write new values for every state tensor into chip 0's region
        and copy each state slot to the other chips' on the device."""
        for n, v in self._views(self.heap, self._state).items():
            v.copy_(tensors[n])
            slot = self.plan.layout[n]
            self._replicate(self.heap, slot.offset,
                            slot.offset + slot.rows * slot.ld)
        self.state_scatter_count += 1

    # ---------------------------------------------------------------- steps
    def write_step_inputs(self, tokens, seq_lens, positions=None) -> None:
        """Write one step's tokens, positions and lengths into the heap
        (every chip's region), zero the event counters, the tick and a
        multichip plan's arrival counters and, under the dynamic
        scheduler, rewrite the initial queue image and zero the
        ticket (one ``index_copy_``)."""
        lens = np.asarray(seq_lens, np.int64)
        vals = {"tokens": np.asarray(tokens), "seq_lens": lens,
                "live_lens": lens + 1,
                "positions": lens if positions is None
                else np.asarray(positions)}
        flat = np.concatenate([np.tile(np.asarray(vals[n], np.float32)
                                       .reshape(size), self.plan.n_chips)
                               for n, size in self._entries]
                              + [self._tail])
        self.heap.index_copy_(0, self._upd_idx,
                              torch.from_numpy(flat).to(self.device))

    def launch(self) -> None:
        """One kernel launch over the whole descriptor table; it follows
        ``write_step_inputs``, which zeroes the counters it counts up and
        rewrites the queue image."""
        megakernel(self.heap, self._descs, self.plan.statics, self._sched,
                   self._acks)

    def step(self, tokens, seq_lens, positions=None) -> torch.Tensor:
        """One decode step inside the kernel; returns the logits (B, V) on
        the device (chip 0's).  The cache advances in the resident
        heap."""
        assert self.heap is not None, "bind() before step()"
        self.write_step_inputs(tokens, seq_lens, positions)
        self.launch()
        return self.plan.read_output(self.heap, "logits")

    def run_once(self, bindings: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Build the heap from full bindings, run one step, return every
        graph output (one-shot semantics, for tests)."""
        self.upload(self.plan.build_heap(bindings, self.device))
        self.step(bindings["tokens"], bindings["seq_lens"],
                  bindings.get("positions"))
        return {name: self.plan.read_output(self.heap, name)
                for name in self.plan.compiled.graph.outputs}

    # ------------------------------------------------------------ counters
    def worker_counters(self) -> List[Dict[str, int]]:
        """The kernel's counters of the LAST step, one dict per worker:
        tile transfers and their rows, primary tiles demand-loaded, event
        waits, wait violations (zero unless the lowering is wrong) and
        event signals."""
        assert self.heap is not None, "bind() first"
        return read_stats_block(self.heap, self.plan.stats_offset,
                                self.plan.num_workers)

    def pipeline_counters(self) -> Dict[str, int]:
        """The kernel's counters of the LAST step, summed over workers."""
        per_worker = self.worker_counters()
        return {k: sum(d[k] for d in per_worker) for k in STATS_FIELDS}

    def scheduler_counters(self) -> Dict[str, Any]:
        """The dynamic scheduler's accounting of the LAST step: the
        [pushed, popped] cursors of every pool (W workers, then the
        overflow queue) and the pop sources summed over workers.  Every
        pool drains (pushed == popped) and the pops add up to T."""
        assert self.plan.dynamic, "the static scheduler has no queues"
        assert self.heap is not None, "bind() first"
        W = self.plan.num_workers
        off = self.plan.qc_offset
        qc = self.heap[off:off + 2 * (W + 1)].cpu().numpy()
        per = self.pipeline_counters()
        return {
            "queue_pushed": [int(qc[2 * i]) for i in range(W + 1)],
            "queue_popped": [int(qc[2 * i + 1]) for i in range(W + 1)],
            "pops_own": per["pops_own"],
            "pops_overflow": per["pops_overflow"],
            "steals": per["steals"],
            "idle_slots": per["idle_slots"],
        }

    def pop_trace(self) -> np.ndarray:
        """The dynamic scheduler's pop trace of the LAST step: the
        descriptor row of each task in ticket order (the order the tasks
        completed on the card, slot order in the plain version), -1 for
        the idle entries past T."""
        assert self.plan.dynamic, "the static scheduler has no pop trace"
        assert self.heap is not None, "bind() first"
        off = self.plan.trace_offset
        n = self.plan.num_steps * self.plan.num_workers
        raw = self.heap[off:off + n].cpu().numpy()
        return np.where(raw >= QUEUE_EMPTY / 2, -1, raw).astype(np.int64)

    def task_ring(self) -> np.ndarray:
        """The trace ring of the LAST step: ``(num_steps * W,
        TRACE_WORDS)`` float32 records in grid-slot order, or in pop
        ticket order under the dynamic scheduler (``obs`` decodes
        them)."""
        assert self.plan.trace, "plan compiled without trace=True"
        assert self.heap is not None, "bind() first"
        off = self.plan.ring_offset + TRACE_HEADER
        n = self.plan.num_steps * self.plan.num_workers
        return self.heap[off:off + n * TRACE_WORDS].cpu().numpy() \
            .reshape(n, TRACE_WORDS)
