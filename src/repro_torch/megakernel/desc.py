"""Megakernel lowering: CompiledTGraph → (heap layout, task descriptors).

The port's copy of ``repro/kernels/megakernel/desc.py`` (the reference)
for both schedulers and the task kinds of the dense, MoE and SSM
families.  Every task becomes a ``DESC_WORDS`` = 36-word
descriptor; the heap is one flat float32 buffer holding every graph
tensor.  A tensor of shape ``(..., cols)`` is stored as ``rows =
prod(shape[:-1])`` rows with padded row stride ``ld = align128(cols +
TN)``, so a TN-wide tile access from any legal column stays inside its
own row slot.

What differs from the reference:

* descriptor words and heap offsets are **int64**.  At the full width of
  deepseek-7b (B=2, S=128) the heap holds 11.85 G float32 words and the
  reference's int32 table overflows (``desc.py:623`` raises
  ``OverflowError``).  Float words (17/18) keep their int32 bit pattern
  (sign-extended);
* ``build_heap`` writes into a device tensor one binding at a time and
  never builds a host-side image of the heap;
* a dynamic plan ends in ``CTL_WORDS`` port-only control words after
  the reference's heap (at ``ctl_offset``: word 0 is the ticket the CUDA
  kernel takes per completed task), so that everything before them keeps
  the reference's layout;
* a stamped multichip plan (``stamp_multichip``) ends in port-only
  arrival counters after the reference's heap (at ``ctl_offset``, one per
  collective, chip and ring phase) with a port-only side table
  (``MegakernelPlan.acks``, one (counter, count) pair per descriptor
  row): a (chip, phase) staging buffer holds one chunk and the ``C - 1``
  rounds of a phase reuse it, which the reference's step-major grid makes
  safe.  On the card, where a chip's worker may run ahead of its peer's,
  a send of round ``r >= 1`` first waits until the receiver's counter
  shows its ``r`` earlier arrivals done.  The descriptor table itself is
  the reference's;
* a static plan carries a port-only side table of walk lists
  (``MegakernelPlan.walk``, built by ``walk_lists``): per worker lane the
  grid slots that are not pads, in step order, so that the CUDA kernel's
  worker visits only its real rows.  A pad (kind 0 with neither a wait
  nor a signal) does nothing, so skipping it changes no word of the heap.

Descriptor words (per kind, see ``lower_tgraph``):
   0 kind   1 m      2 n      3 k      4 out_off 5 ldo
   6 a_off  7 lda    8 b_off  9 ldb   10 c_off  11 ldc
  12 d_off 13 ldd   14 act   15 aux0  16 aux1   17 fbits0
  18 fbits1 19 e_off 20 lde  21 aux2  22 aux3   23 aux4
  24-26 prefetch plan for the next task, 27 self_pf (planned as the
  reference plans them; the port's kernel reads and ignores them),
  28-30 the task's own primary tile record (off, ld, rows),
  32 wait event (-1: none), 33 its trigger count, 34 signalled event
  (-1: none), 35 affinity (the dynamic scheduler's pool for the task;
  0 under the static scheduler).

Static scheduler: the descriptor grid is ``(num_steps * W,
DESC_WORDS)``: row ``s * W + w`` is worker ``w``'s task at step ``s`` (a
noop where the worker idles).
The heap tail carries, in this order, the event table (one counter per
event with a cross-worker consumer, at ``event_offset``), one
``STATS_WORDS`` counter block per worker (at ``stats_offset``) and, with
``trace=True``, the trace ring (at ``ring_offset``: a ``TRACE_HEADER``
whose word 0 is the tick counter, then one ``TRACE_WORDS`` record per
grid slot).  The ring comes last so that the trace-off layout is
bitwise identical.

Multichip (``stamp_multichip``, the fused transport): a static plan
stamped for C chips runs C · W worker lanes (lane ``c * W + w`` is chip
``c``'s worker ``w``) over one heap that holds C copies of the tensor
region (``chip_stride`` words each), then the shared event table (every
chip's events, then the ring's cross-chip arrival events), the
collectives' staging buffers (two packed phase buffers per chip), the
counter blocks and the optional ring.  Each ALLREDUCE step becomes the
``4C - 3`` steps of ``distributed/comm_tasks.expand_ring_allreduce``:
kind 14 (``REMOTE_COPY``) sends a chunk into the peer chip's staging
buffer and signals its arrival event; kind 15 (``ALLREDUCE_CHUNK``) is
the owner-masked init (mode 0) or an arrival's accumulate (1) or store
(2).  Both move a window of word 3 words in each of the word 1 rows,
from ``d[6] + r * d[7]`` to ``d[4] + r * d[5]``; their words 21-23 are
peer, chunk and chip count, not offsets.

Dynamic scheduler (``scheduler="dynamic"``, protocol in
``runtime/dyn_sched.py``): the table is flat, one row per task in
linearized order (the row id is the pop priority), and the heap tail
holds the event table (every event with producers and consumers), the
ready pools (``QUEUE_CAP`` words per worker, then the overflow queue),
the [pushed, popped] cursor pair of each pool, the pop trace (one word
per slot of the reference's ``(num_steps, W)`` grid: the row of ticket
``i``), the counter blocks, the optional ring and the control
words.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.compile import CompiledTGraph
from ..core.graph import OpKind

__all__ = ["KIND_CODES", "DESC_WORDS", "STATS_WORDS", "TRACE_WORDS",
           "TRACE_HEADER", "CTL_WORDS", "PER_STEP_INPUTS", "TensorSlot",
           "MegakernelPlan", "lower_tgraph", "dynamic_tail",
           "stamp_multichip", "refuse_remote_dma", "walk_lists",
           "REMOTE_COPY_CODE", "AR_CHUNK_CODE"]

#: graph inputs that change every decode step — everything else in the heap
#: (weights, caches) is uploaded once and lives on the device
PER_STEP_INPUTS = ("tokens", "h0", "positions", "seq_lens", "live_lens")

DESC_WORDS = 36

#: float32 words reserved PER WORKER at the heap tail for the kernel's
#: counters, the reference's layout: [0] tile transfers, [1] rows in them
#: (2^20-unit spill in [4]), [2] prefetched tiles, [3] primary tiles
#: demand-loaded, [5]-[7] event waits / violations / signals, [8]-[11]
#: dynamic-scheduler pops from the worker's own pool, from overflow, by
#: steal, and idle (zero under the static scheduler).  Word 11 is the
#: plain version's count of idle grid slots, as in the reference; the
#: CUDA kernel, which has no grid, counts its polls that found every
#: pool empty there instead
STATS_WORDS = 12

#: float32 words PER GRID SLOT in the optional trace ring: [0] worker,
#: [1] descriptor row, [2] kind code, [3] start tick, [4] end tick,
#: [5] pop source (0 own pool, 1 overflow, 2 steal; -1 under the static
#: scheduler and for an idle slot), [6] the wait's trigger
#: count (0 when the slot waits on nothing), [7] 0
TRACE_WORDS = 8

#: words at the head of the trace ring, before the records: word 0 is the
#: global tick counter the kernel fetch-and-increments, the rest pads the
#: records to ``TRACE_WORDS`` alignment
TRACE_HEADER = 8

#: port-only words after a dynamic plan's reference layout: [0] the
#: ticket (one fetch-and-add per completed task on the card: the index of
#: the pop-trace entry and ring record the task writes, and T once every
#: task has run)
CTL_WORDS = 1

KIND_CODES = {
    "noop": 0,
    OpKind.MATMUL: 1,
    OpKind.RMSNORM: 2,
    OpKind.ROPE: 3,
    OpKind.GLU_MUL: 4,
    OpKind.RESIDUAL_ADD: 5,
    OpKind.ELEMENTWISE: 5,          # scale-add, b absent
    OpKind.ATTENTION_DECODE: 6,
    OpKind.CACHE_UPDATE: 7,
    OpKind.EMBED_LOOKUP: 8,
    OpKind.SOFTMAX_TOPK: 9,
    OpKind.MOE_GATHER_GEMM: 10,
    OpKind.MOE_COMBINE: 11,
    OpKind.SSM_UPDATE: 12,
    OpKind.CONV1D_UPDATE: 13,
    "remote_copy": 14,              # COMM: send a chunk to the peer chip
    OpKind.ALLREDUCE: 15,           # COMM: init / accumulate / store
}

#: the COMM kinds of a stamped multichip plan (``stamp_multichip``).
#: ``REMOTE_COPY`` words: 1 rows, 3 window words per row, 4 the peer
#: chip's staging buffer (packed: 5 = the window), 6/7 the source rows,
#: 10 the peer chip (the reference's semaphore lane; unused here), 21 peer
#: chip, 22 chunk id, 23 chip count, 34 the peer's arrival event.
#: ``ALLREDUCE_CHUNK`` words: 1/3/4/5/6/7 as above, 14 mode (0 owner-masked
#: init, 1 accumulate, 2 store), 15/16 the owned window (init only),
#: 21-23 as above, 32/33 the arrival it waits on.
REMOTE_COPY_CODE = 14
AR_CHUNK_CODE = 15

_ACT_IDS = {None: 0, "identity": 0, "silu": 1, "gelu": 2}


def _align(n: int, a: int = 128) -> int:
    return (n + a - 1) // a * a


def _fbits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


@dataclasses.dataclass
class TensorSlot:
    offset: int       # heap element offset of [0, ..., 0]
    ld: int           # row stride (elements) of the last dim
    shape: Tuple[int, ...]

    @property
    def rows(self) -> int:
        r = 1
        for s in self.shape[:-1]:
            r *= s
        return r

    def elem(self, *idx: int) -> int:
        """Heap offset of element ``idx`` (last index is a column)."""
        assert len(idx) == len(self.shape)
        row = 0
        for s, i in zip(self.shape[:-1], idx[:-1]):
            row = row * s + i
        return self.offset + row * self.ld + idx[-1]

    def view(self, heap: torch.Tensor, base: int = 0) -> torch.Tensor:
        """The slot as a strided view of ``heap`` in the tensor's shape,
        ``base`` words further on (a chip's region)."""
        cols = self.shape[-1]
        rows2d = torch.as_strided(heap, (self.rows, cols), (self.ld, 1),
                                  self.offset + base)
        return rows2d.view(self.shape) if len(self.shape) > 1 else \
            rows2d.view(cols)


@dataclasses.dataclass
class MegakernelPlan:
    """The static half of a compiled megakernel: descriptor table, heap
    layout and kernel statics, a pure function of (graph, cfg).  The live
    half (resident heap, launches) is ``ops.MegakernelExecutor``."""

    compiled: CompiledTGraph
    descs: np.ndarray                 # (rows, DESC_WORDS) int64
    layout: Dict[str, TensorSlot]
    heap_size: int
    statics: Dict[str, Any]           # compile-time kernel parameters
    stats_offset: int = 0
    num_workers: int = 1
    num_steps: int = 0
    event_offset: int = 0
    num_events: int = 0
    trace: bool = False               # the trace ring is in the heap
    ring_offset: int = 0              # heap offset of the ring (0: off)
    scheduler: str = "static"         # "static" | "dynamic"
    dyn: Any = None                   # runtime.dyn_sched.DynSchedPlan
    queue_offset: int = 0             # ready pools, then overflow
    qc_offset: int = 0                # [pushed, popped] per pool
    trace_offset: int = 0             # pop trace
    ctl_offset: int = 0               # port-only control words
    n_chips: int = 1                  # chips of a stamped plan
    chip_stride: int = 0              # words per chip region (0: one chip)
    acks: Optional[np.ndarray] = None  # (rows, 2) port-only send guards
    walk: Optional[np.ndarray] = None  # port-only walk lists (walk_lists)

    @property
    def dynamic(self) -> bool:
        return self.scheduler == "dynamic"

    @property
    def ctl_words(self) -> int:
        """Port-only words after the reference's heap, zeroed before every
        launch: a dynamic plan's ticket, a stamped plan's arrival
        counters."""
        return self.heap_size - self.ctl_offset if self.ctl_offset else 0

    def pipeline_stats(self) -> Dict[str, Any]:
        """Scheduler stalls plus the prefetch plan's coverage over the
        descriptor table (the plan the reference's kernel follows; the
        port's kernel demand-loads every primary tile for now)."""
        s = self.compiled.stats
        kinds = self.descs[:, 0]
        prefetchable = int(np.isin(kinds, list(_PRIMARY_ROWS_M)
                                   + [KIND_CODES[OpKind.EMBED_LOOKUP]]).sum())
        prefetched = int((self.descs[:, 27] == 1).sum())
        return {
            "stalls": s.get("pipeline_stalls", 0),
            "stalls_naive": s.get("pipeline_stalls_naive",
                                  s.get("pipeline_stalls", 0)),
            "pipeline_depth": s.get("pipeline_depth", 2),
            "prefetchable_tasks": prefetchable,
            "prefetched_tasks": prefetched,
            "prefetch_coverage": prefetched / max(1, prefetchable),
        }

    def input_classes(self) -> Dict[str, List[str]]:
        """Graph inputs as ``per_step`` (tokens/positions/lengths),
        ``state`` (the KV cache, aliased in place) and ``weights``."""
        g = self.compiled.graph
        state = set()
        for op in g.ops:
            amap = _ALIAS_OPS.get(op.kind)
            if amap:
                for in_i in amap.values():
                    state.add(op.inputs[in_i])
        per_step = [n for n in g.inputs if n in PER_STEP_INPUTS]
        weights = [n for n in g.inputs
                   if n not in state and n not in PER_STEP_INPUTS]
        return {"per_step": per_step,
                "state": [n for n in g.inputs if n in state],
                "weights": weights}

    def view(self, heap: torch.Tensor, name: str,
             chip: int = 0) -> torch.Tensor:
        """Tensor ``name`` of chip ``chip``'s region as a strided view of
        ``heap`` (no copy)."""
        return self.layout[name].view(heap, chip * self.chip_stride)

    def alloc_heap(self, device) -> torch.Tensor:
        """A zeroed heap on ``device``: pad columns and the tail are 0."""
        return torch.zeros((self.heap_size,), dtype=torch.float32,
                           device=device)

    def build_heap(self, bindings: Mapping[str, Any],
                   device) -> torch.Tensor:
        """Pack bindings into a new heap on ``device``, one binding at a
        time (ids and lengths are stored as float32 values), into every
        chip's region of a multichip plan."""
        heap = self.alloc_heap(device)
        for name in self.compiled.graph.inputs:
            for c in range(self.n_chips):
                self.view(heap, name, c).copy_(
                    torch.as_tensor(bindings[name]).reshape(
                        self.layout[name].shape))
        return heap

    def read_output(self, heap: torch.Tensor, name: str,
                    chip: int = 0) -> torch.Tensor:
        """A copy of tensor ``name`` of chip ``chip`` out of ``heap``."""
        return self.view(heap, name, chip).clone()


#: kinds whose leading operand is a regular (m-row, descriptor-addressed)
#: tile: code -> index of that operand in ``op.inputs``.  EMBED_LOOKUP is
#: special-cased (a single token-id row); MOE_COMBINE and noop have no
#: primary tile.
_PRIMARY_ROWS_M = {
    KIND_CODES[OpKind.MATMUL]: 0,
    KIND_CODES[OpKind.RMSNORM]: 0,
    KIND_CODES[OpKind.ROPE]: 0,
    KIND_CODES[OpKind.GLU_MUL]: 0,
    KIND_CODES[OpKind.RESIDUAL_ADD]: 0,      # ELEMENTWISE shares code 5
    KIND_CODES[OpKind.ATTENTION_DECODE]: 0,
    KIND_CODES[OpKind.CACHE_UPDATE]: 1,      # the new K/V rows, not cache
    KIND_CODES[OpKind.SOFTMAX_TOPK]: 0,
    KIND_CODES[OpKind.MOE_GATHER_GEMM]: 0,
    KIND_CODES[OpKind.SSM_UPDATE]: 0,        # the x tile
    KIND_CODES[OpKind.CONV1D_UPDATE]: 0,     # the x tile
}


def _primary_record(d: np.ndarray):
    """(off, ld, rows) of a descriptor's primary operand tile, or None."""
    code = int(d[0])
    if code == KIND_CODES[OpKind.EMBED_LOOKUP]:
        return int(d[6]), 1, 1
    if code in _PRIMARY_ROWS_M:
        return int(d[6]), max(1, int(d[7])), int(d[1])
    return None


def _plan_prefetch(compiled: CompiledTGraph, layout: Dict[str, TensorSlot],
                   grid: np.ndarray, num_steps: int, W: int) -> None:
    """Emit the per-worker prefetch plan (descriptor words 24-31), exactly
    as the reference does: the slot at ``(w, s)`` prefetches the primary
    tile of ``(w, s + 1)`` iff that tile's slot is disjoint from every
    output slot written at steps ``s`` and ``s + 1`` (the consumer's own
    outputs excepted).  Words 28-30 always carry the task's own record."""
    g = compiled.graph
    tg = compiled.tg
    part = compiled.partition

    def slot_iv(name: str):
        s = layout[name]
        return s.offset, s.offset + s.rows * s.ld

    n_rows = num_steps * W
    prim_iv = [None] * n_rows
    out_ivs = [[] for _ in range(n_rows)]
    for tid in compiled.order:
        task = tg.tasks[tid]
        row = part.step_of[tid] * W + part.worker_of[tid]
        if task.is_dummy:
            continue
        op = g.op(task.op_id)
        code = int(grid[row, 0])
        if code == KIND_CODES[OpKind.EMBED_LOOKUP]:
            prim_iv[row] = slot_iv(op.inputs[0])
        elif code in _PRIMARY_ROWS_M:
            prim_iv[row] = slot_iv(op.inputs[_PRIMARY_ROWS_M[code]])
        out_ivs[row] = [slot_iv(name) for name in task.out_regions]

    for row in range(n_rows):
        rec = _primary_record(grid[row])
        if rec is not None:
            grid[row, 28:31] = rec

    def step_out_ivs(s: int, skip_row: int = -1):
        ivs = []
        for w in range(W):
            r = s * W + w
            if r != skip_row:
                ivs.extend(out_ivs[r])
        return ivs

    for s in range(num_steps - 1):
        hazard_now = step_out_ivs(s)
        for w in range(W):
            row = s * W + w
            crow = (s + 1) * W + w
            rec = _primary_record(grid[crow])
            if rec is None:
                continue
            lo, hi = prim_iv[crow]
            hazard = hazard_now + step_out_ivs(s + 1, skip_row=crow)
            if any(wlo < hi and lo < whi for wlo, whi in hazard):
                continue
            grid[row, 24:27] = rec
            grid[crow, 27] = 1
    for row in range(W, n_rows):
        if grid[row, 27] == 1:
            assert (grid[row - W, 24:27] == grid[row, 28:31]).all(), row


def _emit_events(compiled: CompiledTGraph, grid: np.ndarray, W: int
                 ) -> int:
    """Emit the wait/signal words (32-34) and return the number of
    in-heap event counters, as the reference does.

    Only events with at least one cross-worker consumer get a counter: a
    task waits on its (single, normalized) dependent event iff some
    producer runs on another worker; same-worker producers are ordered by
    the worker's own stream.  Every in-task of a waited event signals it,
    so the counter reaches exactly the trigger count (``len(in_tasks)``)
    once every producer ran."""
    tg = compiled.tg
    part = compiled.partition
    waited: set = set()
    for tid, task in tg.tasks.items():
        for eid in task.dependent_events:       # normalized: at most one
            e = tg.events[eid]
            if any(part.worker_of[p] != part.worker_of[tid]
                   for p in e.in_tasks):
                waited.add(eid)
    eidx = {eid: i for i, eid in enumerate(sorted(waited))}
    for tid, task in tg.tasks.items():
        row = part.step_of[tid] * W + part.worker_of[tid]
        for eid in task.dependent_events:
            e = tg.events[eid]
            if eid in waited and any(part.worker_of[p] != part.worker_of[tid]
                                     for p in e.in_tasks):
                grid[row, 32] = eidx[eid]
                grid[row, 33] = len(e.in_tasks)
        for eid in task.triggering_events:      # normalized: at most one
            if eid in waited:
                grid[row, 34] = eidx[eid]
    return len(eidx)


#: outputs that alias an input region (in-place state update)
_ALIAS_OPS = {
    OpKind.CACHE_UPDATE: {0: 0},      # out0 aliases ins[0] (the cache)
    OpKind.CONV1D_UPDATE: {1: 1},     # new conv window aliases ins[1]
    OpKind.SSM_UPDATE: {1: 1},        # new SSD state aliases ins[1]
}


def _build_layout(compiled: CompiledTGraph, tn: int
                  ) -> Tuple[Dict[str, TensorSlot], int]:
    g = compiled.graph
    alias: Dict[str, str] = {}
    for op in g.ops:
        amap = _ALIAS_OPS.get(op.kind)
        if amap:
            for out_i, in_i in amap.items():
                alias[op.outputs[out_i]] = op.inputs[in_i]
    layout: Dict[str, TensorSlot] = {}
    off = 0
    for name, spec in g.tensors.items():
        if name in alias:
            continue
        cols = spec.shape[-1] if spec.shape else 1
        ld = _align(cols + tn)
        rows = 1
        for s in spec.shape[:-1]:
            rows *= s
        layout[name] = TensorSlot(off, ld, tuple(spec.shape) or (1,))
        off += rows * ld
    for dst, src in alias.items():
        root = src
        while root in alias:
            root = alias[root]
        base = layout[root]
        layout[dst] = TensorSlot(base.offset, base.ld,
                                 tuple(g.spec(dst).shape))
    return layout, off + tn  # trailing pad


def lower_tgraph(compiled: CompiledTGraph, cfg,
                 tn: Optional[int] = None,
                 scheduler: str = "static",
                 trace: bool = False) -> MegakernelPlan:
    """Lower a compiled decode graph to the static W-worker plan or, with
    ``scheduler="dynamic"``, to the ready-pool plan; with ``trace`` the
    heap holds the trace ring."""
    if scheduler not in ("static", "dynamic"):
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         "expected 'static' or 'dynamic'")
    g = compiled.graph
    tg = compiled.tg

    # tile-size statics from the task set
    max_n = max_m = max_k = 1
    for t in tg.tasks.values():
        if t.is_dummy:
            continue
        op = g.op(t.op_id)
        if op.kind not in KIND_CODES:
            raise NotImplementedError(
                f"megakernel task kind {op.kind} is not ported yet")
        pr = t.out_regions[op.outputs[0]]
        max_m = max(max_m, pr.shape[0])
        if pr.ndim >= 2:
            max_n = max(max_n, pr.shape[-1])
        if op.kind == OpKind.MATMUL:
            max_k = max(max_k, g.spec(op.inputs[0]).shape[-1])
        if op.kind == OpKind.RMSNORM:
            max_n = max(max_n, g.spec(op.inputs[0]).shape[-1])
    tn = tn or _align(max_n)
    layout, heap_size = _build_layout(compiled, tn)

    # ---- store chunk width: the masked write-back granularity ----
    # Stores are masked to STORE_CH-wide chunks whose start lies before
    # the task's valid width; STORE_CH divides every column start and
    # width of every column-tiled tensor, so masked stores never reach a
    # neighbouring column tile (row-only tensors overhang into their own
    # row slot's zero padding only).
    store_ch = 128
    col_starts: Dict[str, set] = {}
    col_geom: Dict[str, list] = {}
    for t in tg.tasks.values():
        if t.is_dummy:
            continue
        op = g.op(t.op_id)
        pr = t.out_regions[op.outputs[0]]
        c0 = pr.starts[-1] if pr.ndim >= 2 else 0
        nw = pr.shape[-1] if pr.ndim >= 2 else 1
        col_starts.setdefault(op.outputs[0], set()).add(c0)
        col_geom.setdefault(op.outputs[0], []).append((c0, nw))
    for name, starts in col_starts.items():
        if len(starts) > 1:
            for c0, nw in col_geom[name]:
                store_ch = math.gcd(store_ch, math.gcd(c0 or store_ch, nw))
    store_ch = max(1, store_ch)

    descs = np.zeros((len(compiled.order), DESC_WORDS), np.int64)
    descs[:, 32] = -1                  # wait_ev sentinel (no wait)
    descs[:, 34] = -1                  # sig_ev sentinel (no signal)
    statics: Dict[str, Any] = {
        "TN": tn, "TM": max_m, "TK": _align(max_k),
        "HD": cfg.hd, "G": cfg.q_per_kv,
        "THETA": float(cfg.rope_theta),
        "MROPE": tuple(cfg.mrope_sections or ()),
        "HD_SSM": cfg.ssm_head_dim, "N_SSM": cfg.ssm_state,
        "W_CONV": cfg.ssm_conv, "TOPK": cfg.top_k,
        "NEG_EXP_A": True,
        "EPS": cfg.norm_eps,
        "STORE_CH": store_ch,
    }

    for pos, tid in enumerate(compiled.order):
        task = tg.tasks[tid]
        d = descs[pos]
        if task.is_dummy:
            d[0] = 0
            continue
        op = g.op(task.op_id)
        kind = op.kind
        d[0] = KIND_CODES[kind]
        pr = task.out_regions[op.outputs[0]]
        out = layout[op.outputs[0]]
        ins = op.inputs
        sl = lambda i: layout[ins[i]]

        r0 = pr.starts[0]
        c0 = pr.starts[-1] if pr.ndim >= 2 else 0
        m = pr.shape[0]
        n = pr.shape[-1] if pr.ndim >= 2 else 1
        d[1], d[2] = m, n
        if pr.ndim == 2:
            d[4], d[5] = out.elem(r0, c0), out.ld

        if kind == OpKind.MATMUL:
            a, w = sl(0), sl(1)
            k = a.shape[-1]
            d[3] = k
            d[6], d[7] = a.elem(r0, 0), a.ld
            d[8], d[9] = w.elem(0, c0), w.ld
            d[10] = sl(2).elem(c0) if len(ins) > 2 else -1
            d[14] = _ACT_IDS[op.attrs.get("activation")]
        elif kind == OpKind.RMSNORM:
            x, w = sl(0), sl(1)
            d[2] = x.shape[-1]
            d[6], d[7] = x.elem(r0, 0), x.ld
            d[10] = w.elem(0)
            d[14] = 1 if op.attrs.get("gemma_style") else 0
            d[17] = _fbits(op.attrs.get("eps", 1e-6))
        elif kind == OpKind.ROPE:
            x = sl(0)
            d[6], d[7] = x.elem(r0, c0), x.ld
            pos_slot, mrope = sl(1), len(g.spec(ins[1]).shape) == 2
            d[19] = pos_slot.elem(r0, 0) if mrope else pos_slot.elem(r0)
            d[20] = pos_slot.ld if mrope else 1
            d[15] = int(mrope)                       # (B, 3) positions
            d[16] = c0                               # global col offset
        elif kind == OpKind.GLU_MUL:
            a, bb = sl(0), sl(1)
            d[6], d[7] = a.elem(r0, c0), a.ld
            d[8], d[9] = bb.elem(r0, c0), bb.ld
            d[14] = _ACT_IDS[op.attrs.get("activation", "silu")]
        elif kind in (OpKind.RESIDUAL_ADD, OpKind.ELEMENTWISE):
            a = sl(0)
            d[6], d[7] = a.elem(r0, c0), a.ld
            if len(ins) > 1:
                bb = sl(1)
                d[8], d[9] = bb.elem(r0, c0), bb.ld
            else:
                d[8] = -1
            d[17] = _fbits(op.attrs.get("scale", 1.0))
        elif kind == OpKind.ATTENTION_DECODE:
            q, kc, vc = sl(0), sl(1), sl(2)
            _b, s_cache, _kvd = kc.shape
            hd, grp = op.attrs["head_dim"], op.attrs["q_per_kv"]
            kv0 = c0 // (hd * grp)                   # first kv head in tile
            d[3] = s_cache
            d[6], d[7] = q.elem(r0, c0), q.ld
            d[8], d[9] = kc.elem(r0, 0, kv0 * hd), kc.ld
            d[15] = s_cache * kc.ld                  # batch stride
            d[10], d[11] = vc.elem(r0, 0, kv0 * hd), vc.ld
            d[12] = sl(3).elem(r0)                   # live_lens
            d[17] = _fbits(op.attrs.get("scale", hd ** -0.5))
            d[16] = n // (hd * grp)                  # groups in this tile
        elif kind == OpKind.CACHE_UPDATE:
            cache, new = sl(0), sl(1)
            _b, s_cache, _kvd = cache.shape
            d[2] = task.in_regions[ins[1]].shape[-1]
            d[4], d[5] = cache.elem(r0, 0, pr.starts[-1]), cache.ld
            d[15] = s_cache * cache.ld               # batch stride
            d[6], d[7] = new.elem(r0, pr.starts[-1]), new.ld
            d[12] = sl(2).elem(r0)                   # seq_lens
        elif kind == OpKind.EMBED_LOOKUP:
            ids, table = sl(0), sl(1)
            d[6] = ids.elem(r0)
            d[8], d[9] = table.elem(0, c0), table.ld
        elif kind == OpKind.SOFTMAX_TOPK:
            x = sl(0)
            d[2] = x.shape[-1]
            d[3] = op.attrs["top_k"]
            d[6], d[7] = x.elem(r0, 0), x.ld
        elif kind == OpKind.MOE_GATHER_GEMM:
            # one expert's (tokens, F-tile) output over all m tokens
            e0, f0 = pr.starts[0], pr.starts[2]
            x, router, w = sl(0), sl(1), sl(2)
            d[1], d[2] = pr.shape[1], pr.shape[2]
            d[4], d[5] = out.elem(e0, 0, f0), out.ld
            if len(x.shape) == 3:    # second gemm: expert-local hidden
                d[6], d[7] = x.elem(e0, 0, 0), x.ld
            else:
                d[6], d[7] = x.elem(0, 0), x.ld
            d[3] = x.shape[-1]
            if len(w.shape) == 4:    # fused GLU weights (E, D, 2, F)
                d[8], d[9] = w.elem(e0, 0, 0, f0), 2 * w.ld
                d[19] = w.elem(e0, 0, 1, f0)             # the up half
                d[15] = 1                                # glu flag
            else:
                d[8], d[9] = w.elem(e0, 0, f0), w.ld
                d[19] = -1
                d[15] = 0
            d[10], d[11] = router.elem(0, e0), router.ld  # its router column
            d[14] = _ACT_IDS[op.attrs.get("activation")]
        elif kind == OpKind.MOE_COMBINE:
            eo, router = sl(0), sl(1)
            n_exp, toks, _dm = eo.shape
            d[3] = n_exp
            d[6], d[7] = eo.elem(0, r0, c0), eo.ld
            d[15] = toks * eo.ld                         # expert stride
            d[10], d[11] = router.elem(r0, 0), router.ld
        elif kind == OpKind.SSM_UPDATE:
            # NH_TILE heads of one row tile: x, the (hd, N) state tiles
            # (row and head strides), dt, A_log, B and C rows, D
            x, state, dt, a_log, bmat, cmat = (sl(i) for i in range(6))
            h0 = c0 // op.attrs["head_dim"]
            _b, nh, hd, nst = state.shape
            d[3] = nst
            d[6], d[7] = x.elem(r0, c0), x.ld
            d[8], d[9] = state.elem(r0, h0, 0, 0), state.ld
            d[15] = nh * hd * state.ld               # batch stride
            d[16] = hd * state.ld                    # head stride
            d[10], d[11] = dt.elem(r0, h0), dt.ld
            d[12] = a_log.elem(h0)
            d[19], d[20] = bmat.elem(r0, 0), bmat.ld   # group 0 only
            d[21], d[22] = cmat.elem(r0, 0), cmat.ld
            d[23] = sl(6).elem(h0) if len(ins) > 6 else -1
        elif kind == OpKind.CONV1D_UPDATE:
            x, state, w = sl(0), sl(1), sl(2)
            _b, wconv, _c = state.shape
            d[3] = wconv
            d[6], d[7] = x.elem(r0, c0), x.ld
            d[8], d[9] = state.elem(r0, 0, c0), state.ld
            d[15] = wconv * state.ld                 # batch stride
            d[10], d[11] = w.elem(0, c0), w.ld
            d[12] = sl(3).elem(c0) if len(ins) > 3 else -1
        elif kind == OpKind.ALLREDUCE:
            # single-chip lowering: an identity ALLREDUCE_CHUNK whose
            # owned window is the whole tile (the TP model keeps global
            # shapes); ``stamp_multichip`` replaces this placeholder with
            # the chunked ring at tp > 1
            src = sl(0)
            assert c0 == 0 and src.ld == out.ld, \
                "allreduce tasks must span whole rows of an ld-matched pair"
            d[3] = n                         # per-row window = REAL width
            d[6], d[7] = src.elem(r0, 0), src.ld
            d[14] = 0                        # mode: init
            d[15], d[16] = 0, n              # owned window: everything
            d[21], d[22], d[23] = -1, 0, 1   # peer / chunk id / count

    # ---- post-pass statics from the descriptor table ----
    kinds = descs[:, 0]
    # port-only: the kinds the table holds (the kernel's instantiation and
    # its shared memory depend on them)
    statics["KINDS"] = tuple(sorted(set(kinds.tolist()) - {0}))
    # compute tiles only: a collective's rows (the whole batch) do not
    # size the tile scratch
    statics["TM"] = int(descs[kinds < REMOTE_COPY_CODE, 1].max(initial=1))
    attn = kinds == KIND_CODES[OpKind.ATTENTION_DECODE]
    statics["NG"] = int(descs[attn, 16].max(initial=1))
    statics["S_MAX"] = int(descs[attn, 3].max(initial=1))
    ssm = kinds == KIND_CODES[OpKind.SSM_UPDATE]
    if ssm.any():
        statics["NH_TILE"] = int(
            (descs[ssm, 2] // max(1, cfg.ssm_head_dim)).max(initial=1))
    comb = kinds == KIND_CODES[OpKind.MOE_COMBINE]
    statics["E_MAX"] = int(descs[comb, 3].max(initial=1))
    mm = np.isin(kinds, (KIND_CODES[OpKind.MATMUL],
                         KIND_CODES[OpKind.MOE_GATHER_GEMM]))
    statics["TK"] = _align(max(statics["TK"],
                               int(descs[mm, 3].max(initial=1))))
    # port-only: the widest matmul tile's store width (valid columns in
    # STORE_CH chunks, capped at TN), which picks the kernel's wide
    # instantiation past one matmul pass
    chw = min(statics["STORE_CH"], statics["TN"])
    n = descs[kinds == KIND_CODES[OpKind.MATMUL], 2]
    statics["MM_WIDTH"] = int(np.minimum(statics["TN"], -(-n // chw) * chw)
                              .max(initial=0))

    part = compiled.partition
    if scheduler == "dynamic":
        return _lower_dynamic(compiled, descs, layout, heap_size, statics,
                              part, trace)
    W = part.num_workers
    num_steps = part.num_steps
    grid = np.zeros((num_steps * W, DESC_WORDS), np.int64)
    grid[:, 32] = -1
    grid[:, 34] = -1
    for pos, tid in enumerate(compiled.order):
        grid[part.step_of[tid] * W + part.worker_of[tid]] = descs[pos]

    num_events = _emit_events(compiled, grid, W)
    _plan_prefetch(compiled, layout, grid, num_steps, W)
    event_offset = heap_size
    heap_size += num_events
    stats_offset = heap_size
    heap_size += STATS_WORDS * W
    statics.update({"W": W, "NUM_STEPS": num_steps,
                    "EVENT_OFF": event_offset, "N_EVENTS": num_events,
                    "STATS_OFF": stats_offset})
    ring_offset = 0
    if trace:
        ring_offset = heap_size
        heap_size += TRACE_HEADER + num_steps * W * TRACE_WORDS
        statics.update({"TRACE": 1, "TR_OFF": ring_offset})
    return MegakernelPlan(compiled, grid, layout, heap_size, statics,
                          stats_offset, W, num_steps, event_offset,
                          num_events, trace, ring_offset,
                          walk=walk_lists(grid, W))


def walk_lists(grid: np.ndarray, W: int) -> np.ndarray:
    """The walk lists of a static ``(num_steps * W, DESC_WORDS)`` grid as
    one int64 CSR: ``W + 1`` offsets, then for each lane ``w`` in turn the
    grid slots ``s * W + w`` that are not pads, in step order.  A pad is
    a noop (kind 0) that neither waits nor signals (words 32 and 34 both
    -1); a noop with an event word stays in its lane's list."""
    real = (grid[:, 0] != 0) | (grid[:, 32] >= 0) | (grid[:, 34] >= 0)
    slots = np.flatnonzero(real)
    lanes = slots % W
    offsets = np.zeros(W + 1, np.int64)
    np.cumsum(np.bincount(lanes, minlength=W), out=offsets[1:])
    return np.concatenate([offsets, slots[np.argsort(lanes, kind="stable")]]
                          ).astype(np.int64)


def _lower_dynamic(compiled: CompiledTGraph, descs: np.ndarray,
                   layout: Dict[str, TensorSlot], heap_size: int,
                   statics: Dict[str, Any], part,
                   trace: bool = False) -> MegakernelPlan:
    """Finish the lowering for ``scheduler="dynamic"`` as the reference
    does: keep the flat per-task table in linearized order (row id ==
    position, the pop priority), stamp every row's primary record, event
    wait and signal words and affinity, and append the ready-pool
    regions to the heap.  No prefetch plan: which task a worker runs
    next is decided at run time, so every task demand-loads its primary
    tile.  The port-only control words come after the reference's
    heap."""
    from ..runtime.dyn_sched import build_dyn_sched

    dyn = build_dyn_sched(compiled, part)
    W = dyn.num_workers
    T = dyn.num_tasks
    assert descs.shape[0] == T

    for row in range(T):
        rec = _primary_record(descs[row])
        if rec is not None:
            descs[row, 28:31] = rec
        descs[row, 35] = dyn.affinity[row]
        e = int(dyn.wait_ev[row])
        if e >= 0:
            descs[row, 32] = e
            descs[row, 33] = dyn.trigger[e]
        descs[row, 34] = dyn.sig_ev[row]

    tail = dynamic_tail(dyn, heap_size, trace)
    statics.update(tail["statics"])
    heap_size = tail["heap_size"]
    return MegakernelPlan(compiled, descs, layout, heap_size, statics,
                          tail["stats_offset"], W, tail["num_steps"],
                          tail["event_offset"], dyn.num_events, trace,
                          tail["ring_offset"], scheduler="dynamic", dyn=dyn,
                          queue_offset=tail["queue_offset"],
                          qc_offset=tail["qc_offset"],
                          trace_offset=tail["trace_offset"],
                          ctl_offset=tail["ctl_offset"])


def dynamic_tail(dyn, heap_size: int, trace: bool = False
                 ) -> Dict[str, Any]:
    """The heap regions a dynamic plan appends after ``heap_size`` words,
    in the reference's order (event table, pools and overflow, cursor
    pairs, pop trace, counter blocks, optional ring), then the port's
    control words: their offsets, the kernel statics that name them and
    the new heap size."""
    from ..runtime.dyn_sched import QUEUE_CAP

    W, T = dyn.num_workers, dyn.num_tasks
    num_steps = -(-T // W)             # the reference's pop slots per worker
    out: Dict[str, Any] = {"num_steps": num_steps, "ring_offset": 0}
    for name, words in (("event_offset", dyn.num_events),
                        ("queue_offset", W * QUEUE_CAP + dyn.overflow_cap),
                        ("qc_offset", 2 * (W + 1)),
                        ("trace_offset", num_steps * W),
                        ("stats_offset", STATS_WORDS * W)):
        out[name] = heap_size
        heap_size += words
    if trace:
        out["ring_offset"] = heap_size
        heap_size += TRACE_HEADER + num_steps * W * TRACE_WORDS
    out["ctl_offset"] = heap_size
    out["heap_size"] = heap_size + CTL_WORDS
    out["statics"] = {
        "W": W, "NUM_STEPS": num_steps, "EVENT_OFF": out["event_offset"],
        "N_EVENTS": dyn.num_events, "STATS_OFF": out["stats_offset"],
        "DYN": 1, "QOFF": out["queue_offset"], "QCAP": QUEUE_CAP,
        "OV_ROWS": dyn.overflow_cap // QUEUE_CAP,
        "QC_OFF": out["qc_offset"], "TRACE_OFF": out["trace_offset"],
        "T_TASKS": T, "MAX_OUT": dyn.max_out, "CTL_OFF": out["ctl_offset"],
    }
    if trace:
        out["statics"].update({"TRACE": 1, "TR_OFF": out["ring_offset"]})
    return out


#: descriptor words holding absolute heap offsets, per kind code: the
#: multichip stamp shifts exactly these (where >= 0: -1 marks an absent
#: operand) by the chip's region base.  Words 21-23 of the COMM kinds are
#: peer, chunk and chip count, not offsets.
_OFFSET_WORDS = {
    0: (),
    KIND_CODES[OpKind.MATMUL]: (4, 6, 8, 10),
    KIND_CODES[OpKind.RMSNORM]: (4, 6, 10),
    KIND_CODES[OpKind.ROPE]: (4, 6, 19),
    KIND_CODES[OpKind.GLU_MUL]: (4, 6, 8),
    KIND_CODES[OpKind.RESIDUAL_ADD]: (4, 6, 8),   # ELEMENTWISE shares 5
    KIND_CODES[OpKind.ATTENTION_DECODE]: (4, 6, 8, 10, 12),
    KIND_CODES[OpKind.CACHE_UPDATE]: (4, 6, 12),
    KIND_CODES[OpKind.EMBED_LOOKUP]: (4, 6, 8),
    KIND_CODES[OpKind.SOFTMAX_TOPK]: (4, 6),
    KIND_CODES[OpKind.MOE_GATHER_GEMM]: (4, 6, 8, 10, 19),
    KIND_CODES[OpKind.MOE_COMBINE]: (4, 6, 10),
    KIND_CODES[OpKind.SSM_UPDATE]: (4, 6, 8, 10, 12, 19, 21, 23),
    KIND_CODES[OpKind.CONV1D_UPDATE]: (4, 6, 8, 10, 12),
    REMOTE_COPY_CODE: (4, 6),
    AR_CHUNK_CODE: (4, 6),
}


def refuse_remote_dma(statics: Mapping[str, Any]) -> None:
    """Raise for a plan that asks for the transport between cards
    (``REMOTE_DMA``): not ported, and never replaced by the fused one."""
    if statics.get("REMOTE_DMA"):
        raise NotImplementedError(
            "REMOTE_DMA: the peer-to-peer transport between cards is not "
            "ported; the fused transport runs every chip on one card")


def _noop_row() -> np.ndarray:
    d = np.zeros(DESC_WORDS, np.int64)
    d[32] = -1
    d[34] = -1
    return d


def _comm_desc(t, d0: np.ndarray, c: int, stage_sz: int, sbase: int,
               ebase: int, chip_stride: int, n_chips: int) -> np.ndarray:
    """The descriptor row of ring task ``t`` (a ``CommTask`` of the
    placeholder ``d0``'s expansion) for chip ``c``, as the reference
    lowers it: a column window over the placeholder's ``m`` rows (the
    REAL width chunked: pad columns never enter the ring).  ``sbase`` is
    the collective's staging base (two packed phase buffers of
    ``stage_sz`` words per chip), ``ebase`` its first arrival event."""
    from ..distributed.comm_tasks import MODE_INIT
    d = _noop_row()
    m, out_ld, src_ld = int(d0[1]), int(d0[5]), int(d0[7])
    out0 = int(d0[4]) + c * chip_stride      # chip c's output tile
    src0 = int(d0[6]) + c * chip_stride      # chip c's input tile
    stage = lambda chip, phase: sbase + (chip * 2 + phase) * stage_sz
    d[1] = m
    d[21], d[22], d[23] = t.peer, t.chunk, n_chips
    d[3] = t.nwords
    if t.kind == "init":
        d[0] = AR_CHUNK_CODE
        d[14] = MODE_INIT
        d[4], d[5] = out0, out_ld
        d[6], d[7] = src0, src_ld
        d[15], d[16] = t.own_start, t.own_len
    elif t.kind == "send":
        d[0] = REMOTE_COPY_CODE
        d[6], d[7] = out0 + t.start, out_ld
        d[4], d[5] = stage(t.peer, t.phase), t.nwords   # packed staging
        d[10] = t.peer                       # the reference's sem lane
        d[34] = ebase + t.sig_ev             # the peer's arrival event
    else:                                    # recv: accumulate / store
        d[0] = AR_CHUNK_CODE
        d[14] = t.mode
        d[6], d[7] = stage(c, t.phase), t.nwords
        d[4], d[5] = out0 + t.start, out_ld
        d[32], d[33] = ebase + t.wait_ev, 1
    return d


def _ring_round(t, n_chips: int) -> int:
    """The round (0 .. C-2) of ring task ``t`` within its phase."""
    first = 1 if t.phase == 0 else 2 * n_chips - 1
    return (t.step - first) // 2


def _stamp_rows(rows: np.ndarray, n_chips: int, chip_stride: int,
                nev0: int) -> np.ndarray:
    """``rows`` (n, DESC_WORDS) shifted for every chip: (C, n,
    DESC_WORDS).  Chip ``c`` adds ``c * chip_stride`` to each offset word
    of its kind that is >= 0, to the prefetch source (word 24) of a row
    with a prefetch and to its own primary record (word 28), and ``c *
    nev0`` to its wait and signal events, as the reference's
    ``stamp_row`` does."""
    off = np.zeros(rows.shape, bool)
    for code, words in _OFFSET_WORDS.items():
        sel = rows[:, 0] == code
        for wd in words:
            off[sel, wd] = rows[sel, wd] >= 0
    off[:, 24] = rows[:, 26] > 0
    off[:, 28] = rows[:, 30] > 0
    ev = np.zeros(rows.shape, bool)
    ev[:, 32] = rows[:, 32] >= 0
    ev[:, 34] = rows[:, 34] >= 0
    c = np.arange(n_chips, dtype=np.int64)[:, None, None]
    return rows[None] + c * chip_stride * off + c * nev0 * ev


def stamp_multichip(plan: MegakernelPlan, n_chips: int) -> MegakernelPlan:
    """Stamp a single-chip static plan into a ``C``-chip plan over the
    fused transport (paper §6.5; the reference's ``stamp_multichip``,
    table for table).

    The grid is replicated per chip (worker lane ``c * W + w`` is chip
    ``c``'s worker ``w``; every heap offset moves by the chip's region
    base, every event id by the chip's event block), and each ALLREDUCE
    placeholder step becomes the ``expand_ring_allreduce`` sequence over
    the tile's REAL row width, as ``4C - 3`` full-width grid steps: at
    inserted step ``t`` every chip runs its ring task of relative step
    ``t`` on the lane that held the placeholder, every other lane a noop.
    The init inherits the placeholder's wait, the last arrival its signal
    and the prefetch plan that moved past the inserted steps (words 24-26
    of the lane's last inserted row), as in the reference.

    The chips are heap regions of one launch: one card runs the TP
    protocol, its ring steps synchronised by the cross-chip arrival
    events.  Port-only: the arrival counters after the reference's heap
    and the ``acks`` side table that guards a staging buffer's reuse, and
    the walk lists of the ``C · W`` lanes (module docstring)."""
    from ..distributed.comm_tasks import (expand_ring_allreduce,
                                          n_comm_events, n_ring_steps)
    if plan.dynamic:
        raise NotImplementedError(
            "tp > 1 needs the static scheduler (the dynamic ready pools "
            "are not chip-stamped)")
    refuse_remote_dma(plan.statics)
    C = n_chips
    if C <= 1:
        return plan
    W = plan.num_workers
    S0 = plan.num_steps
    Wt = C * W
    grid0 = plan.descs
    chip_stride = plan.event_offset          # words per chip region
    nev0 = plan.num_events
    K = n_ring_steps(C)

    # collectives in (step, worker) order; their staging and event bases
    colls = [(s, w) for s in range(S0) for w in range(W)
             if grid0[s * W + w, 0] == AR_CHUNK_CODE]
    event_off = C * chip_stride
    n_comm_ev = len(colls) * n_comm_events(C)
    cursor = event_off + C * nev0 + n_comm_ev
    info = {}
    for i, (s, w) in enumerate(colls):
        d0 = grid0[s * W + w]
        stage_sz = int(d0[1]) * -(-int(d0[2]) // C)
        info[(s, w)] = (i, stage_sz, cursor, C * nev0 + i * n_comm_events(C))
        cursor += 2 * C * stage_sz
    stats_off = cursor
    heap_size = stats_off + STATS_WORDS * Wt

    stamped = _stamp_rows(grid0, C, chip_stride, nev0)   # (C, S0*W, 36)
    stamped = stamped.reshape(C, S0, W, DESC_WORDS).transpose(1, 0, 2, 3) \
        .reshape(S0, Wt, DESC_WORDS)
    noop = _noop_row()
    blocks: List[np.ndarray] = []
    ack_blocks: List[np.ndarray] = []
    ack_rows: List[Tuple[int, int, int, int]] = []   # (block, lane, word, n)
    s_prev = 0
    for s in sorted({s for s, _ in colls}):
        blocks.append(stamped[s_prev:s].reshape(-1, DESC_WORDS))
        ph = {w: grid0[s * W + w] for w in range(W)
              if grid0[s * W + w, 0] == AR_CHUNK_CODE}
        ring: Dict[Tuple[int, int, int], Any] = {}
        for w, d0 in ph.items():
            i, stage_sz, sbase, ebase = info[(s, w)]
            for t in expand_ring_allreduce(int(d0[2]), C):
                row = _comm_desc(t, d0, t.chip, stage_sz, sbase, ebase,
                                 chip_stride, C)
                # port-only guard word: (collective, receiving chip, phase)
                if t.kind == "send" and _ring_round(t, C) > 0:
                    word = (i * C + t.peer) * 2 + t.phase
                    guard = (word, _ring_round(t, C))
                elif t.kind == "recv":
                    guard = ((i * C + t.chip) * 2 + t.phase, 0)
                else:
                    guard = None
                ring[(w, t.chip, t.step)] = (row, guard)
        for ti in range(K):
            block = np.tile(noop, (Wt, 1))
            for c in range(C):
                for w in range(W):
                    lane = c * W + w
                    src = grid0[s * W + w]
                    if w in ph:
                        row, guard = ring[(w, c, ti)]
                        row = row.copy()
                        if ti == 0 and src[32] >= 0:
                            # the init inherits the placeholder's wait
                            row[32] = src[32] + c * nev0
                            row[33] = src[33]
                        if ti == K - 1:
                            # the last arrival inherits the placeholder's
                            # signal and its moved prefetch plan
                            if src[34] >= 0:
                                row[34] = src[34] + c * nev0
                            if src[26] > 0:
                                row[24:27] = src[24:27]
                                row[24] += c * chip_stride
                        block[lane] = row
                        if guard is not None:
                            ack_rows.append((len(blocks), lane) + guard)
                    elif ti == 0:
                        block[lane] = stamped[s, lane]
                        block[lane, 24:27] = 0   # moved to the last step
                    elif ti == K - 1 and src[26] > 0:
                        block[lane, 24:27] = src[24:27]
                        block[lane, 24] += c * chip_stride
            blocks.append(block)
        s_prev = s + 1
    blocks.append(stamped[s_prev:].reshape(-1, DESC_WORDS))
    sizes = [b.shape[0] for b in blocks]
    grid = np.concatenate(blocks)
    S = grid.shape[0] // Wt
    # the prefetch pair invariant on the stamped grid: a consumer's own
    # record equals its stream predecessor's plan
    cons = np.nonzero(grid[Wt:, 27] == 1)[0] + Wt
    assert (grid[cons - Wt, 24:27] == grid[cons, 28:31]).all()

    statics = dict(plan.statics)
    ring_off = 0
    if plan.trace:
        ring_off = heap_size
        heap_size += TRACE_HEADER + S * Wt * TRACE_WORDS
        statics.update({"TRACE": 1, "TR_OFF": ring_off})
    # the reference's trailing pad (its span copies run in 256-word
    # blocks that may read past a window; the port's never do)
    heap_size += 256
    ctl_offset = heap_size
    heap_size += 2 * C * len(colls)
    acks = np.full((grid.shape[0], 2), -1, np.int64)
    starts = np.cumsum([0] + sizes)
    for b, lane, word, n in ack_rows:
        acks[starts[b] + lane] = (ctl_offset + word, n)
    statics.update({"W": Wt, "NUM_STEPS": S, "EVENT_OFF": event_off,
                    "N_EVENTS": C * nev0 + n_comm_ev,
                    "STATS_OFF": stats_off, "N_CHIPS": C,
                    "KINDS": tuple(sorted(set(statics["KINDS"])
                                          | {REMOTE_COPY_CODE}))})
    return MegakernelPlan(plan.compiled, grid, plan.layout, heap_size,
                          statics, stats_off, Wt, S, event_off,
                          C * nev0 + n_comm_ev, plan.trace, ring_off,
                          ctl_offset=ctl_offset, n_chips=C,
                          chip_stride=chip_stride, acks=acks,
                          walk=walk_lists(grid, Wt))
