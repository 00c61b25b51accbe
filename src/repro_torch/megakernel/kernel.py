"""The decode megakernel's wrapper, its launch count, and its plain
PyTorch version.

``megakernel(heap, descs, statics, sched)`` runs one decode step against
the float32 heap, in place: every row of the ``(num_steps * W, 36)``
descriptor grid under the static scheduler, or every row of the flat
task table popped from the heap's ready pools under the dynamic one
(``statics["DYN"]``, with the scheduler table ``sched``).  For a heap on
the card it launches the hand-written CUDA kernel
(``csrc/megakernel.cu``, built by ``build.py``), one CTA per worker, and
adds one to the launch count; for a heap on the CPU it runs
``megakernel_plain``, and on any other device it raises.  It replaces
the Pallas megakernel of the JAX package
(``repro/kernels/megakernel/kernel.py`` ``make_megakernel``) for both
schedulers and the task kinds 0-15 (the dense family's, rope's M-RoPE
branch included, the MoE family's router top-k, expert GEMM and
combine, the SSM family's Mamba2 state update and conv step, and the
COMM kinds of a stamped multichip plan: the ring send and the
all-reduce chunk), with its event counters and trace ring.  A
multichip plan runs over the fused transport (its chips are regions of
the one heap) under the static scheduler; ``acks`` is then its
port-only side table (``desc.stamp_multichip``).  A plan that asks for
the remote-copy transport (``REMOTE_DMA``) is refused.  Under the static
scheduler ``walk`` (``plan.walk``, ``desc.walk_lists``) lists each
worker's real rows: the kernel's CTA ``w`` then runs only those, in step
order, and skips the pads, which do nothing.  Without it, or with the
trace ring on (whose records cover every grid slot), each CTA walks every
slot of its grid column.

``megakernel_plain`` is a Python loop over the reference's grid slots,
step-major and worker-fastest, that runs each kind with torch ops on
views of the heap.  Under the static scheduler slot ``s * W + w`` runs
grid row ``s * W + w``; the partition makes that order legal, since
every dependency crosses a step.  With ``walk`` (and the ring off) it
visits only the slots the lists name, in the same order.  Under the
dynamic scheduler slot ``s * W + w`` pops for worker ``w`` as the
reference's interpret grid does (own pool, then overflow, then the first
non-empty victim in ``(w + k) % W`` order; the minimum row id;
first-empty pushes that spill to overflow), so its heap after a step
equals the reference's in every integer word.  It computes what the kernel computes (same tiles,
same masked store widths, same counters, the same trace records) on any
device, and handles the event words as the reference's interpret mode
does: a waited counter must already equal its trigger count, or the wait
counts a violation.  The CPU tests run it, and ``chip_smoke.py`` holds
the kernel against it on the card.  Nothing on the main path calls it.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.ssm import softplus
from ..runtime.dyn_sched import QUEUE_CAP, QUEUE_EMPTY
from .desc import (DESC_WORDS, STATS_WORDS, TRACE_HEADER, TRACE_WORDS,
                   refuse_remote_dma)

__all__ = ["megakernel", "megakernel_plain", "launch_count",
           "reset_launch_count", "check_plan", "check_workers",
           "max_workers", "mm_passes", "MM_PASS", "MAX_TN", "MAX_HD",
           "MAX_TK", "MAX_EXPERTS", "MAX_MROPE", "SPIN_TIMEOUT_S"]

#: limits of the CUDA kernel's tiling: 512 threads × 2 float4 column
#: groups per matmul thread in one pass (``MM_PASS``: in a plan of the
#: dense kinds a matmul tile wider than that runs as passes over column
#: ranges, on the x rows staged once, in the kernel's wide instantiation,
#: so kind 1 takes any width there; the expert GEMM, kind 10, runs one
#: pass and keeps ``MAX_TN``; the other kinds loop over any width), 8
#: head elements per lane in attention, and the two staged rows of x (2 ·
#: TK words) beside the K-slice partial sums (16 KB) and the staged and
#: running descriptor rows (1536 bytes with the reduction words) in the
#: H100's 227 KB of shared memory
MM_PASS = 4096
MAX_TN = MM_PASS
MAX_HD = 256
MAX_TK = 26752

#: M-RoPE sections the kernel takes (temporal, height, width)
MAX_MROPE = 3

#: the router top-k (kind 9) runs one warp per row with 4 expert columns
#: a lane
MAX_EXPERTS = 128

#: deadline of one event wait on the card: a wait longer than this is a
#: fault (the kernel traps, the next synchronisation raises).  A whole
#: decode step at W = 1 takes under 0.4 s on an H100.
SPIN_TIMEOUT_S = 5.0

#: the dynamic kernel keeps the W + 1 pool occupancies of a poll in the
#: matmul's reduction scratch (2 · 512 · 4 words)
MAX_DYN_WORKERS = 4095

#: words of one block of the reference's COMM span op (kinds 14-15): the
#: transfer counts follow its blocks
COMM_BLOCK = 256

_ROW_SPILL = 1 << 20
_LAUNCHES = 0


def launch_count() -> int:
    """CUDA kernel launches since the last ``reset_launch_count``."""
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _kinds(statics: Mapping[str, Any]):
    """The task kinds of the plan's table (``lower_tgraph`` records them;
    a table built by hand is taken to hold attention)."""
    return statics.get("KINDS", (3, 6))


def _attn_hd(statics: Mapping[str, Any]) -> int:
    """The attention head width the kernel's shared memory is sized for:
    ``HD`` when the plan has rope or attention tasks (kinds 3 and 6),
    else 0 (an attention-free plan's ``HD`` is ``d_model``)."""
    return statics["HD"] if {3, 6} & set(_kinds(statics)) else 0


def check_plan(statics: Mapping[str, Any], descs: np.ndarray) -> None:
    """Raise for a plan the CUDA kernel's tiling cannot run: expert tiles
    wider than ``MAX_TN``, matmul tiles wider than ``MM_PASS`` outside
    the dense kinds (the wide kernel's), matmuls deeper than ``MAX_TK``,
    rope or attention heads wider than ``MAX_HD`` or odd, matmul weights
    not addressable as float4, SSD state tiles (kind 12) not addressable
    as float4 or not ``NH_TILE`` heads wide, or a dynamic
    plan whose pools are not one warp's 128 words, whose row ids are not
    exact in float32 or whose W + 1 pool occupancies do not fit the
    kernel's scratch, a router wider than ``MAX_EXPERTS`` or a top-k
    outside 1..E, and expert weights (kind 10: words 8 and 19, row
    stride word 9) not addressable as float4 or expert tiles whose
    store width is not a whole number of float4 groups (a matmul tile
    may be: the kernel finishes its last columns one at a time), and
    M-RoPE rows (kind 3, word 15 = 1) or sections (``MROPE``) unless
    there are at most ``MAX_MROPE`` sections, none negative, that sum
    to HD / 2."""
    if statics.get("DYN"):
        if statics["QCAP"] != QUEUE_CAP or statics["T_TASKS"] >= 1 << 24 \
                or statics["W"] >= MAX_DYN_WORKERS:
            raise NotImplementedError(
                f"dynamic plan with QCAP={statics['QCAP']}, "
                f"T={statics['T_TASKS']}, W={statics['W']}")
    chw = min(statics["STORE_CH"], statics["TN"])
    mm = descs[descs[:, 0] == 1]
    gg = descs[descs[:, 0] == 10]
    widest = int(np.minimum(statics["TN"], -(-gg[:, 2] // chw) * chw)
                 .max(initial=0))
    if widest > MAX_TN or statics["TK"] > MAX_TK:
        raise NotImplementedError(
            f"expert tile {widest} wide, TK={statics['TK']}: exceeds "
            f"{MAX_TN}x{MAX_TK}")
    mm_widest = int(np.minimum(statics["TN"], -(-mm[:, 2] // chw) * chw)
                    .max(initial=0))
    if mm_widest > MM_PASS and _variant(statics) != 4:
        raise NotImplementedError(
            f"matmul tile {mm_widest} wide: only the dense kinds' wide "
            "kernel runs tiles wider than one pass")
    hd = _attn_hd(statics)
    if hd > MAX_HD or hd % 2:
        raise NotImplementedError(f"head_dim {hd}")
    if (mm[:, 8] % 4).any() or (mm[:, 9] % 4).any() or \
            (gg[:, 8] % 4).any() or (gg[:, 9] % 4).any() or \
            (gg[gg[:, 19] >= 0, 19] % 4).any() or \
            (-(-gg[:, 2] // chw) * chw % 4).any():
        raise NotImplementedError("matmul and expert weights must be "
                                  "float4-aligned, and expert tiles "
                                  "whole float4 groups wide")
    ssm = descs[descs[:, 0] == 12]
    if len(ssm) and (statics["N_SSM"] % 4 or not statics["NEG_EXP_A"]
                     or (ssm[:, [8, 9, 15, 16, 19, 20, 21, 22]] % 4).any()
                     or (ssm[:, 2] != statics["NH_TILE"]
                         * statics["HD_SSM"]).any()):
        raise NotImplementedError(
            "SSD state tiles must be float4-addressable (N and every state, "
            "B and C offset and stride a multiple of 4), A = -exp(A_log), "
            "and every tile NH_TILE heads wide")
    sec = tuple(statics.get("MROPE", ()))
    rope = descs[descs[:, 0] == 3]
    if (sec or (rope[:, 15] == 1).any()) and (
            len(sec) > MAX_MROPE or min(sec, default=-1) < 0
            or sum(sec) != statics["HD"] // 2):
        raise NotImplementedError(
            f"M-RoPE sections {sec} for head_dim {statics['HD']}")
    topk = descs[descs[:, 0] == 9]
    if len(topk) and ((topk[:, 2] > MAX_EXPERTS).any()
                      or not 1 <= statics["TOPK"] <= topk[:, 2].min()):
        raise NotImplementedError(
            f"router top-{statics['TOPK']} of {topk[:, 2].max()} experts")


def _mrope(statics: Mapping[str, Any]):
    """The M-RoPE sections as the kernel's three words (0 past the
    plan's sections; all 0 for plain RoPE)."""
    sec = tuple(statics.get("MROPE", ()))
    return sec + (0,) * (MAX_MROPE - len(sec))


def _variant(statics: Mapping[str, Any]) -> int:
    """The kernel instantiation the plan needs: 3 (multichip, static
    only: every kind and the COMM kinds 14-15) for a stamped plan, 2
    (full) for the Mamba2 kinds (12-13), 1 (extended) for the MoE kinds
    (a top-k) or a masked-store chunk that is not a whole float4 group
    (the matmul's tail pass), else 4 (wide: the dense kinds and the
    matmul's passes over tiles wider than ``MM_PASS``) for a matmul tile
    wider than that (the port-only ``MM_WIDTH``; ``TN`` where a table
    built by hand lacks it), else 0 (dense).  Each of 1-3 adds its kinds
    to the one before; every instantiation but the one a plan needs
    keeps its code and registers."""
    if statics.get("N_CHIPS", 1) > 1 or {14, 15} & set(_kinds(statics)):
        return 3
    if {12, 13} & set(_kinds(statics)):
        return 2
    if statics.get("TOPK", 0) > 0 \
            or min(statics["STORE_CH"], statics["TN"]) % 4 != 0:
        return 1
    return 4 if statics.get("MM_WIDTH", statics["TN"]) > MM_PASS else 0


def max_workers(statics: Mapping[str, Any], device=None) -> int:
    """The most CTAs of the kernel that can be resident at once on the
    card for a plan with these statics (its shared memory per CTA: the
    matmul's x rows, or the attention's merge scratch)."""
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(device):
        n = lib.mk_max_workers(statics["TK"], _attn_hd(statics))
    if n < 0:
        raise RuntimeError("megakernel occupancy query failed: "
                           + lib.mk_error_string(-n).decode())
    return n


def check_workers(statics: Mapping[str, Any], device=None) -> None:
    """Raise unless all W workers of the plan fit on the card at once: a
    worker whose CTA is not resident would leave the workers that wait on
    it spinning.  W is never shrunk."""
    n = max_workers(statics, device)
    if statics["W"] > n:
        raise RuntimeError(
            f"W={statics['W']} workers cannot be resident at once on "
            f"{torch.cuda.get_device_name(device)}: at most {n} CTAs fit")


def megakernel(heap: torch.Tensor, descs: torch.Tensor,
               statics: Mapping[str, Any],
               sched: Optional[torch.Tensor] = None,
               acks: Optional[torch.Tensor] = None,
               walk: Optional[torch.Tensor] = None) -> None:
    """One decode step: run the descriptor table ``descs`` ((rows, 36)
    int64, on the heap's device) against ``heap`` (flat float32) in
    place.  The event counters and the tick must be zero, and under the
    dynamic scheduler the pools, cursors and ticket must hold the
    initial queue image (the executor writes all of them with the step's
    inputs); ``sched`` is then the plan's (events, 2 + max_out) int32
    scheduler table on the same device.  A table for the card must pass
    ``check_plan``; a W that cannot be resident at once is refused before
    anything runs.  A multichip plan takes its ``acks``: a contiguous
    (rows, 2) int64 tensor on the heap's device; one that asks for the
    remote-copy transport between cards (``REMOTE_DMA``) is refused.  A
    static plan may take its ``walk`` lists (a contiguous 1-D int64
    tensor on the heap's device, ``W + 1`` offsets then the slots); they
    are not used while the trace ring is on."""
    global _LAUNCHES
    refuse_remote_dma(statics)
    dyn = bool(statics.get("DYN"))
    if acks is not None and (acks.dtype != torch.int64
                             or tuple(acks.shape) != (descs.shape[0], 2)
                             or not acks.is_contiguous()
                             or acks.device != heap.device):
        raise ValueError("acks must be a contiguous (rows, 2) int64 tensor "
                         "on the heap's device")
    if walk is not None and (dyn or walk.dtype != torch.int64
                             or walk.dim() != 1 or not walk.is_contiguous()
                             or walk.numel() < statics["W"] + 1
                             or walk.device != heap.device):
        raise ValueError("walk must be a static plan's contiguous 1-D int64 "
                         "lists (W + 1 offsets, then the slots) on the "
                         "heap's device")
    if statics.get("TRACE"):
        walk = None                     # the ring records every grid slot
    if dyn and (sched is None or sched.dtype != torch.int32
                or sched.dim() != 2 or not sched.is_contiguous()
                or sched.device != heap.device):
        raise ValueError("a dynamic plan needs its scheduler table: a "
                         "contiguous 2-D int32 tensor on the heap's device")
    if heap.dtype != torch.float32 or heap.dim() != 1 \
            or not heap.is_contiguous():
        raise ValueError("heap must be a contiguous 1-D float32 tensor")
    if descs.dtype != torch.int64 or descs.dim() != 2 \
            or descs.shape[1] != DESC_WORDS or not descs.is_contiguous():
        raise ValueError(f"descs must be a contiguous (rows, {DESC_WORDS}) "
                         "int64 tensor")
    if descs.device != heap.device:
        raise ValueError("heap and descs must be on one device")
    if heap.device.type == "cpu":
        megakernel_plain(heap, descs, statics, sched, acks, walk)
        return
    if heap.device.type != "cuda":
        raise ValueError(f"no megakernel for device {heap.device}")
    if statics.get("N_CHIPS", 1) > 1 and acks is None:
        raise ValueError("a multichip plan runs with its plan's acks")
    if descs.data_ptr() % 16:
        raise ValueError("descs must start on a 16-byte boundary (the "
                         "kernel stages its rows with 16-byte copies)")
    from .build import load_library
    lib = load_library()
    W = statics["W"]
    with torch.cuda.device(heap.device):
        stream = torch.cuda.current_stream(heap.device).cuda_stream
        err = lib.mk_launch(heap.data_ptr(), descs.data_ptr(),
                            0 if dyn else descs.shape[0] // W, W,
                            statics["TN"],
                            statics["TK"], _attn_hd(statics), statics["G"],
                            statics["STORE_CH"], statics["STATS_OFF"],
                            statics["EVENT_OFF"],
                            statics["TR_OFF"] if statics.get("TRACE")
                            else -1, int(SPIN_TIMEOUT_S * 1e9),
                            float(statics["THETA"]), statics.get("NG", 1),
                            statics.get("S_MAX", 1), int(dyn),
                            sched.data_ptr() if dyn else None,
                            sched.shape[1] if dyn else 0,
                            statics.get("QOFF", 0),
                            statics.get("OV_ROWS", 0) * QUEUE_CAP,
                            statics.get("QC_OFF", 0),
                            statics.get("TRACE_OFF", 0),
                            statics.get("CTL_OFF", 0),
                            statics.get("T_TASKS", 0),
                            statics.get("TOPK", 0), _variant(statics),
                            statics.get("HD_SSM", 0), statics.get("N_SSM", 0),
                            statics.get("NH_TILE", 0),
                            statics.get("W_CONV", 0),
                            acks.data_ptr() if acks is not None else None,
                            stream, *_mrope(statics),
                            walk.data_ptr() if walk is not None else None)
    if err != 0:
        raise RuntimeError("megakernel launch failed: "
                           + lib.mk_error_string(err).decode())
    _LAUNCHES += 1


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _f32(bits: int) -> float:
    return float(np.array(bits, np.int64).astype(np.int32).view(np.float32))


def _act(y: torch.Tensor, act_id: int) -> torch.Tensor:
    if act_id == 1:
        return F.silu(y)
    if act_id == 2:
        return F.gelu(y, approximate="tanh")
    return y


class _PlainPools:
    """The dynamic scheduler's ready pools, cursors and pop trace as the
    plain version keeps them during a step: numpy copies of the heap's
    words, written back once (only this loop touches them).  Pops take
    the minimum row id, pushes the first empty slot, as the reference's
    interpret grid does."""

    def __init__(self, heap, statics, rows_list, sched):
        self.W = W = statics["W"]
        self.q0 = statics["QOFF"]
        n = (W + statics["OV_ROWS"]) * QUEUE_CAP
        self.words = heap[self.q0:self.q0 + n].cpu().numpy().copy()
        self.qc0 = statics["QC_OFF"]
        self.qc = heap[self.qc0:self.qc0 + 2 * (W + 1)].cpu().numpy() \
            .astype(np.int64)
        self.sched = (sched.cpu().numpy() if isinstance(sched, torch.Tensor)
                      else np.asarray(sched))
        self.affinity = [d[35] for d in rows_list]
        self.pt0 = statics["TRACE_OFF"]
        self.pop_trace = np.full((statics["NUM_STEPS"] * W,), QUEUE_EMPTY,
                                 np.float32)
        self.ctl = statics["CTL_OFF"]

    def _region(self, p: int) -> np.ndarray:
        if p < self.W:
            return self.words[p * QUEUE_CAP:(p + 1) * QUEUE_CAP]
        return self.words[self.W * QUEUE_CAP:]

    def _take(self, p: int) -> Optional[int]:
        seg = self._region(p)
        j = int(np.argmin(seg))
        if seg[j] >= QUEUE_EMPTY / 2:
            return None
        row = int(seg[j])
        seg[j] = QUEUE_EMPTY
        self.qc[2 * p + 1] += 1
        return row

    def pop(self, w: int):
        """(row, source) for worker ``w``: own pool (0), overflow (1),
        then steal (2) from the first non-empty victim; None if all are
        empty."""
        for src, p in [(0, w), (1, self.W)] + \
                [(2, (w + k) % self.W) for k in range(1, self.W)]:
            row = self._take(p)
            if row is not None:
                return row, src
        return None

    def push(self, row: int) -> None:
        for p in (self.affinity[row], self.W):
            seg = self._region(p)
            free = np.flatnonzero(seg >= QUEUE_EMPTY / 2)
            if free.size:
                seg[free[0]] = row
                self.qc[2 * p] += 1
                return
        raise AssertionError("the overflow queue holds every task")

    def signal(self, e: int, count: int) -> None:
        """Push the consumers of event ``e`` when ``count`` reached its
        trigger count."""
        ent = self.sched[e]
        if count == ent[0]:
            for c in ent[2:2 + ent[1]]:
                self.push(int(c))

    def store(self, heap, pops: int) -> None:
        dev = heap.device
        heap[self.q0:self.q0 + self.words.size] = \
            torch.from_numpy(self.words).to(dev)
        heap[self.qc0:self.qc0 + self.qc.size] = \
            torch.from_numpy(self.qc.astype(np.float32)).to(dev)
        heap[self.pt0:self.pt0 + self.pop_trace.size] = \
            torch.from_numpy(self.pop_trace).to(dev)
        heap[self.ctl] += float(pops)


def megakernel_plain(heap: torch.Tensor, descs,
                     statics: Mapping[str, Any], sched=None,
                     acks=None, walk=None) -> None:
    """The kernel's function with torch ops, one grid slot at a time in
    the reference's order (slot ``s * W + w``): the static grid's row
    ``s * W + w``, or under the dynamic scheduler the row that worker
    ``w`` pops there (``sched``: the plan's scheduler table).  Under the
    static scheduler with the ring off, ``walk`` (the plan's walk lists)
    restricts the walk to the slots it lists, in the same order: the
    compacted walk of the CUDA kernel.

    Every store writes the kernel's masked width: the valid columns
    rounded up to ``STORE_CH`` chunks, capped at ``TN`` (the tail chunk
    overhangs only into the row slot's zero padding).  Each slot, noops
    included, checks its wait (the counter must already be at its
    trigger count), runs its task, signals its event (pushing the
    consumers of an event it completes) and, with the trace ring on,
    records its two ticks; a dynamic slot that pops nothing idles, and
    records row and kind -1.  The per-worker counter blocks get the same
    counts the kernel writes (word 11: the idle slots).  With ``acks`` (a
    multichip plan's side table) an arrival (kind 15) adds one to its
    counter after its task, and a send (kind 14) asserts that its counter
    already holds the arrivals it follows, as slot order guarantees."""
    rows_list = (descs.tolist() if isinstance(descs, torch.Tensor)
                 else np.asarray(descs).tolist())
    TN, HD, G = statics["TN"], statics["HD"], statics["G"]
    W = statics["W"]
    chw = min(statics["STORE_CH"], TN)
    theta = float(statics["THETA"])
    half = HD // 2
    inv_freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                       device=heap.device) / half)

    def tile(off, ld, m, w):
        return torch.as_strided(heap, (m, w), (ld, 1), off)

    def width(valid):
        return min(TN, -(-valid // chw) * chw) if valid > 0 else 0

    def scalar(off):
        return int(heap[off].item())

    # the counters the kernel counts up in the heap, kept here and
    # written back once: only this loop touches them while it runs
    ev_off, n_ev = statics["EVENT_OFF"], statics["N_EVENTS"]
    events = heap[ev_off:ev_off + n_ev].tolist()
    trace = bool(statics.get("TRACE"))
    tr_off = statics.get("TR_OFF", 0)
    tick = int(heap[tr_off].item()) if trace else 0
    pools = None
    slots = range(len(rows_list))
    if statics.get("DYN"):
        pools = _PlainPools(heap, statics, rows_list, sched)
        slots = range(statics["NUM_STEPS"] * W)
    elif walk is not None and not trace:
        lists = (walk.cpu().numpy() if isinstance(walk, torch.Tensor)
                 else np.asarray(walk))
        slots = np.sort(lists[W + 1:]).tolist()
    ring = np.zeros((len(rows_list) if pools is None else len(slots),
                     TRACE_WORDS), np.float32)
    counts = np.zeros((W, STATS_WORDS), np.int64)
    pops = 0
    guard = (acks.tolist() if isinstance(acks, torch.Tensor)
             else np.asarray(acks).tolist()) if acks is not None else None
    arrived = {}

    for i in slots:
        w = i % W
        cnt = counts[w]
        row, src = i, -1
        if pools is not None:
            got = pools.pop(w)
            if got is None:             # idle slot
                cnt[11] += 1
                ring[i] = (w, -1, -1, tick, tick + 1, -1, 0, 0)
                tick += 2
                continue
            row, src = got
            cnt[8 + src] += 1
            pools.pop_trace[i] = row
            pops += 1
        d = rows_list[row]
        if d[32] >= 0:                  # wait: must already hold
            cnt[5] += 1
            cnt[6] += events[d[32]] != d[33]
        t_start = tick
        tick += 1
        if d[0] != 0:
            if d[30] > 0:               # primary tile, demand-loaded
                cnt[0] += 1
                cnt[1] += d[30]
                cnt[3] += 1
            n, r = _operand_transfers(d, statics, scalar)
            cnt[0] += n
            cnt[1] += r
            word, want = guard[row] if guard is not None else (-1, 0)
            if word >= 0 and word not in arrived:
                arrived[word] = int(heap[word].item())
            if word >= 0 and d[0] == 14:    # the arrivals it follows
                assert arrived[word] >= want, (row, word, want)
            _run_task(d, tile, width, scalar, heap, TN, HD, G, half,
                      inv_freq, statics.get("TOPK", 0), statics)
            if word >= 0 and d[0] == 15:
                arrived[word] += 1
        ring[i] = (w, row, d[0], t_start, tick, src,
                   d[33] if d[32] >= 0 else 0, 0)
        tick += 1
        if d[34] >= 0:                  # signal (and enqueue)
            events[d[34]] += 1
            cnt[7] += 1
            if pools is not None:
                pools.signal(d[34], events[d[34]])

    stats = np.zeros((W, STATS_WORDS), np.float32)
    stats[:, [0, 3, 5, 6, 7, 8, 9, 10, 11]] = \
        counts[:, [0, 3, 5, 6, 7, 8, 9, 10, 11]]
    stats[:, 1] = counts[:, 1] % _ROW_SPILL
    stats[:, 4] = counts[:, 1] // _ROW_SPILL
    off = statics["STATS_OFF"]
    heap[off:off + W * STATS_WORDS] = \
        torch.from_numpy(stats.ravel()).to(heap.device)
    if n_ev:
        heap[ev_off:ev_off + n_ev] = torch.tensor(
            events, dtype=heap.dtype, device=heap.device)
    for word, n in arrived.items():
        heap[word] = float(n)
    if pools is not None:
        pools.store(heap, pops)
    if trace:
        heap[tr_off] = float(tick)
        base = tr_off + TRACE_HEADER
        heap[base:base + ring.size] = \
            torch.from_numpy(ring.ravel()).to(heap.device)


def _operand_transfers(d, statics, scalar):
    """(tile transfers, rows in them) of one task's operands and results
    other than its primary tile, as the reference's kernel counts its
    bulk copies: the matmul's A and B tiles per ``TKC``-deep chunk, the
    bias, norm-weight, position, lengths and second-operand rows, the
    attention's K and V tiles per (row, group, ``TS``-position chunk)
    holding live positions, the expert GEMM's router column and its one
    or two (gate, up) weight tiles per chunk, the combine's expert tile
    and router column per expert, the SSD update's A_log and D rows and
    per row its dt, B and C rows and the ``NH_TILE`` state tiles in and
    out, the conv step's taps and bias and per row its window in and out,
    and the stores; a COMM task (kinds 14-15) counts one transfer of
    three ``COMM_BLOCK``-word blocks per row and block of its window, as
    the reference's span op does.  The CUDA kernel counts the same
    (``Counts::task``, and the COMM tasks where it runs them)."""
    code, m = d[0], d[1]
    if code in (1, 10):                 # KCH chunks of TKC rows of K
        tk = statics["TK"]
        tkc = min(128, max(8, tk))
        kch = -(-tk // tkc)
        nb = min(kch, -(-d[3] // tkc)) if d[3] > 0 else 0
        if code == 10:                  # router column, gate (and up)
            nw = 2 if d[15] == 1 else 1
            return 1 + (kch - 1) + nw * nb + 1, \
                m + (kch - 1) * m + nw * min(d[3], kch * tkc) + m
        n = (kch - 1) + nb + (1 if d[10] >= 0 else 0) + 1
        return n, (kch - 1) * m + min(d[3], kch * tkc) \
            + (1 if d[10] >= 0 else 0) + m
    if code == 2:
        return 2, 1 + m
    if code in (3, 4):
        return 2, 2 * m
    if code == 5:
        return (2, 2 * m) if d[8] >= 0 else (1, m)
    if code == 6:                       # SCH chunks of TS cache rows
        s_max, ng = statics["S_MAX"], statics["NG"]
        ts = min(128, s_max)
        sch = -(-s_max // ts)
        n, r = 1 + m, 1 + m
        for row in range(m):
            live = scalar(d[12] + row)
            if live > 0:
                n += 2 * ng * min(sch, -(-live // ts))
                r += 2 * ng * min(live, sch * ts)
        return n, r
    if code == 7:
        return 1 + m, 1 + m
    if code == 8:
        return 2 * m, 2 * m
    if code == 9:
        return 1, m
    if code == 11:                      # an expert tile and router column
        return 2 * d[3] + 1, 2 * d[3] * m + m
    if code == 12:
        nht, dsk = statics["NH_TILE"], int(d[23] >= 0)
        return 1 + dsk + m * (4 + 2 * nht), \
            1 + dsk + m * (4 + 2 * nht * statics["HD_SSM"])
    if code == 13:
        wc, bias = statics["W_CONV"], int(d[12] >= 0)
        return 1 + bias + 3 * m, wc + bias + m * (2 * wc + 1)
    if code in (14, 15) and d[3] > 0:   # source, destination, write-back
        return 1, 3 * -(-d[3] // COMM_BLOCK) * m
    return 0, 0


def mm_passes(ws: int):
    """The column ranges ``[c0, c1)`` of a matmul tile ``ws`` columns wide
    that the CUDA kernel runs as one pass each (``mm_wide``): the whole
    tile up to ``MM_PASS`` columns, else equal ranges of float4 groups,
    each at most ``MM_PASS`` wide, the last one taking the columns past
    the whole groups (the kernel's tail pass)."""
    ncg = ws // 4
    if ncg * 4 <= MM_PASS:
        return [(0, ws)]
    passes = -(-ncg * 4 // MM_PASS)
    pw = -(-ncg // passes)
    cuts = [4 * g for g in range(0, ncg, pw)] + [ws]
    return list(zip(cuts[:-1], cuts[1:]))


def _run_task(d, tile, width, scalar, heap, TN, HD, G, half, inv_freq,
              topk, statics=None):
    """One task of kind ``d[0]`` (1-15) on the heap, in place; the
    Mamba2 kinds (12-13) read their shapes from ``statics``."""
    code, m = d[0], d[1]
    if code == 1:                       # matmul + bias + activation
        k, x = d[3], tile(d[6], d[7], m, d[3])
        for c0, c1 in mm_passes(width(d[2])):
            y = x @ tile(d[8] + c0, d[9], k, c1 - c0)
            if d[10] >= 0:
                y = y + heap[d[10] + c0:d[10] + c1]
            tile(d[4] + c0, d[5], m, c1 - c0).copy_(_act(y, d[14]))
    elif code == 2:                     # rmsnorm
        n = d[2]
        ws = width(n)
        x = tile(d[6], d[7], m, n)
        inv = torch.rsqrt(torch.sum(x * x, dim=1, keepdim=True) / n
                          + _f32(d[17]))
        w = heap[d[10]:d[10] + n]
        wg = 1.0 + w if d[14] == 1 else w
        out = tile(d[4], d[5], m, ws)
        out[:, :n] = x * inv * wg
        out[:, n:] = 0.0
    elif code == 3:                     # rope (rotate-half, per head)
        ws = width(d[2])
        nh = TN // HD
        if d[15] == 1:                  # M-RoPE: section i reads column i
            sec = statics["MROPE"]
            col = torch.repeat_interleave(
                torch.arange(len(sec), device=heap.device),
                torch.tensor(sec, device=heap.device))
            pos = tile(d[19], d[20], m, len(sec))[:, col]
        else:
            pos = tile(d[19], d[20], m, 1)
        ang = pos * inv_freq[None, :]
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x = tile(d[6], d[7], m, nh * HD).reshape(m, nh, HD)
        x1, x2 = x[..., :half], x[..., half:]
        rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        out = torch.zeros((m, TN), dtype=heap.dtype, device=heap.device)
        out[:, :nh * HD] = rot.reshape(m, nh * HD)
        tile(d[4], d[5], m, ws).copy_(out[:, :ws])
    elif code == 4:                     # glu: act(a) * b
        ws = width(d[2])
        tile(d[4], d[5], m, ws).copy_(
            _act(tile(d[6], d[7], m, ws), d[14]) * tile(d[8], d[9], m, ws))
    elif code == 5:                     # residual / scale-add
        ws = width(d[2])
        y = tile(d[6], d[7], m, ws) * _f32(d[17])
        if d[8] >= 0:
            y = y + tile(d[8], d[9], m, ws)
        tile(d[4], d[5], m, ws).copy_(y)
    elif code == 6:                     # GQA decode attention
        ws = width(d[2])
        scale = _f32(d[17])
        out = torch.zeros((m, ws), dtype=heap.dtype, device=heap.device)
        for r in range(m):
            live = min(scalar(d[12] + r), d[3])
            if live <= 0:
                continue
            for gi in range(d[16]):
                q = tile(d[6] + r * d[7] + gi * G * HD, HD, G, HD) * scale
                kk = tile(d[8] + r * d[15] + gi * HD, d[9], live, HD)
                vv = tile(d[10] + r * d[15] + gi * HD, d[11], live, HD)
                p = torch.softmax(q @ kk.T, dim=-1)
                out[r, gi * G * HD:(gi + 1) * G * HD] = \
                    (p @ vv).reshape(G * HD)
        tile(d[4], d[5], m, ws).copy_(out)
    elif code == 7:                     # KV cache row write at seq_lens[r]
        ws = width(d[2])
        for r in range(m):
            dst = d[4] + r * d[15] + scalar(d[12] + r) * d[5]
            heap[dst:dst + ws] = heap[d[6] + r * d[7]:d[6] + r * d[7] + ws]
    elif code == 8:                     # embedding rows by token id
        ws = width(d[2])
        for r in range(m):
            src = d[8] + scalar(d[6] + r) * d[9]
            heap[d[4] + r * d[5]:d[4] + r * d[5] + ws] = heap[src:src + ws]
    elif code == 9:                     # router top-k, softmax, scatter
        ws = width(d[2])
        x = tile(d[6], d[7], m, d[2])
        # a stable descending sort: equal logits in column order, the
        # reference's first-hit rule
        order = torch.sort(x, dim=1, descending=True,
                           stable=True).indices[:, :topk]
        out = torch.zeros((m, ws), dtype=heap.dtype, device=heap.device)
        out.scatter_(1, order, torch.softmax(torch.gather(x, 1, order), 1))
        tile(d[4], d[5], m, ws).copy_(out)
    elif code == 10:                    # one expert over the routed rows
        ws, k = width(d[2]), d[3]
        mask = (tile(d[10], d[11], m, 1) > 0).to(heap.dtype)
        x = tile(d[6], d[7], m, k) * mask
        y = x @ tile(d[8], d[9], k, ws)
        if d[15] == 1:                  # fused GLU: act(x Wg) * (x Wu)
            y = _act(y, d[14]) * (x @ tile(d[19], d[9], k, ws))
        tile(d[4], d[5], m, ws).copy_(y)
    elif code == 11:                    # sum_e expert_out[e] * router[:, e]
        ws = width(d[2])
        acc = torch.zeros((m, ws), dtype=heap.dtype, device=heap.device)
        for e in range(d[3]):
            acc = acc + tile(d[6] + e * d[15], d[7], m, ws) \
                * tile(d[10] + e, d[11], m, 1)
        tile(d[4], d[5], m, ws).copy_(acc)
    elif code == 12:                    # Mamba2 SSD update, NH_TILE heads
        ws, nht = width(d[2]), statics["NH_TILE"]
        hds, ns = statics["HD_SSM"], statics["N_SSM"]
        x = tile(d[6], d[7], m, nht * hds).reshape(m, nht, hds)
        state = torch.as_strided(heap, (m, nht, hds, ns),
                                 (d[15], d[16], d[9], 1), d[8])
        dt = softplus(tile(d[10], d[11], m, nht))             # (m, nht)
        da = torch.exp(dt * -torch.exp(heap[d[12]:d[12] + nht]))
        bvec, cvec = tile(d[19], d[20], m, ns), tile(d[21], d[22], m, ns)
        new = state * da[..., None, None] \
            + (dt[..., None] * x)[..., None] * bvec[:, None, None, :]
        y = (new @ cvec[:, None, :, None])[..., 0]        # (m, nht, hds)
        if d[23] >= 0:
            y = y + heap[d[23]:d[23] + nht][None, :, None] * x
        state.copy_(new)
        out = torch.zeros((m, ws), dtype=heap.dtype, device=heap.device)
        out[:, :nht * hds] = y.reshape(m, nht * hds)
        tile(d[4], d[5], m, ws).copy_(out)
    elif code == 13:                    # causal conv step, window in place
        ws, wc = width(d[2]), statics["W_CONV"]
        win = torch.as_strided(heap, (m, wc, ws), (d[15], d[9], 1), d[8])
        new = torch.cat([win[:, 1:], tile(d[6], d[7], m, ws)[:, None]], 1)
        y = heap[d[12]:d[12] + ws].expand(m, ws) if d[12] >= 0 else \
            torch.zeros((m, ws), dtype=heap.dtype, device=heap.device)
        for t in range(wc):             # the reference's order, bias first
            y = y + new[:, t] * heap[d[10] + t * d[11]:
                                     d[10] + t * d[11] + ws]
        win.copy_(new)
        tile(d[4], d[5], m, ws).copy_(F.silu(y))
    elif code in (14, 15):              # COMM: a window of d[3] words a row
        nw = d[3]
        if nw <= 0:
            return
        src, dst = tile(d[6], d[7], m, nw), tile(d[4], d[5], m, nw)
        if code == 14 or d[14] == 2:    # send; an all-gather arrival
            dst.copy_(src)
        elif d[14] == 1:                # a reduce-scatter arrival
            dst.copy_(dst + src)
        else:                           # owner-masked init
            rel = torch.arange(nw, device=heap.device)
            own = (rel >= d[15]) & (rel < d[15] + d[16])
            dst.copy_(torch.where(own, src, torch.zeros_like(src)))
    else:
        raise NotImplementedError(f"megakernel task kind {code}")
