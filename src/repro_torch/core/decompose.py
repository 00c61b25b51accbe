"""Operator decomposition (paper §4.1, C2).

Each operator's output tensor is partitioned into disjoint tiles; each tile
becomes one *task*.  MPK chooses partitions that (a) minimize device-memory
traffic and (b) produce a task count proportional to the number of workers.
On TPU the "worker count" target keeps per-task working sets VMEM-sized and
MXU-aligned (multiples of 128 on the lane dimension).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

from .graph import ComputationGraph, OpKind, OpNode
from .regions import Region, TensorSpec, tile_regions
from .tgraph import Task, TGraph

__all__ = ["DecomposeConfig", "decompose"]


@dataclasses.dataclass
class DecomposeConfig:
    #: target number of tasks per operator — the paper generates a task count
    #: proportional to the number of SMs (≈#workers); we target the same so
    #: Table-2 statistics are comparable.
    target_tasks_per_op: int = 48
    #: lane alignment for column tiles (MXU/VPU lane width)
    align: int = 128
    #: maximum rows per task tile (sublane-friendly)
    max_rows: int = 256


# --------------------------------------------------------------------------
# Partitioning: choose the tile grid for an op's primary output.
# --------------------------------------------------------------------------

_ROW_ONLY_KINDS = {
    OpKind.RMSNORM,
    OpKind.SOFTMAX_TOPK,
    OpKind.CONV1D_UPDATE,
    OpKind.MOE_COMBINE,
}


def _col_tile(n: int, target: int, align: int) -> int:
    """Column tile size: ~``target`` tiles, aligned; never zero."""
    if n <= align:
        return max(n, 1)
    n_tiles = max(1, min(target, math.ceil(n / align)))
    return int(math.ceil(n / n_tiles / align) * align)


def _partition_primary(
    op: OpNode, out_spec: TensorSpec, cfg: DecomposeConfig
) -> List[Region]:
    """Tile the primary output of ``op`` into task regions."""
    shape = out_spec.shape
    if op.kind == OpKind.ALLREDUCE:
        # collectives are atomic: their chunking is the ring protocol's
        # own (``distributed.comm_tasks.ring_chunks``), not the tiler's.
        # Splitting a collective into tiles would shrink every ring
        # chunk into the latency-bound regime and break the megakernel
        # lowering's whole-rows assumption.
        return list(tile_regions(shape, shape))
    if op.kind in _ROW_ONLY_KINDS or op.attrs.get("row_only", False):
        # full-width row tiles (reductions over the feature dimension)
        rows = shape[0]
        row_tile = max(1, min(cfg.max_rows, math.ceil(rows / cfg.target_tasks_per_op)))
        tile = (row_tile,) + tuple(shape[1:])
        return list(tile_regions(shape, tile))

    if op.kind == OpKind.MOE_GATHER_GEMM:
        # output (E, tokens, d_ff): one expert per task row-group, f tiled
        e, toks, dff = shape
        n_f = max(1, min(max(1, cfg.target_tasks_per_op // e), math.ceil(dff / cfg.align)))
        f_tile = int(math.ceil(dff / n_f / cfg.align) * cfg.align) if dff > cfg.align else dff
        return list(tile_regions(shape, (1, toks, max(1, f_tile))))

    if len(shape) == 1:
        tile = (_col_tile(shape[0], cfg.target_tasks_per_op, cfg.align),)
        return list(tile_regions(shape, tile))

    rows, cols = shape[0], shape[-1]
    # alignment override: RoPE / attention tiles must not split a head
    align = int(op.attrs.get("col_align", cfg.align))
    user_degree = op.attrs.get("parallel_degree")  # user-specified partitioning
    if user_degree is not None:
        n_col = max(1, int(user_degree))
        col = int(math.ceil(cols / n_col / align) * align)
    else:
        n_col = max(1, min(cfg.target_tasks_per_op, math.ceil(cols / align)))
        col = int(math.ceil(cols / n_col / align) * align)
    col = max(col, min(cols, align))
    n_col_actual = math.ceil(cols / col)
    # spend leftover parallelism on rows
    row_budget = max(1, cfg.target_tasks_per_op // n_col_actual)
    row = max(1, min(cfg.max_rows, math.ceil(rows / row_budget)))
    tile = (row,) + tuple(shape[1:-1]) + (col,)
    return list(tile_regions(shape, tile))


# --------------------------------------------------------------------------
# Footprints: output region -> regions of each input read (paper §4.1's
# overlap test operates on these).
# --------------------------------------------------------------------------


def _footprint(
    g: ComputationGraph, op: OpNode, out_r: Region
) -> Dict[str, Region]:
    k = op.kind
    ins = op.inputs
    t = lambda i: g.spec(ins[i])
    fullr = lambda s: Region(tuple(0 for _ in s.shape), tuple(s.shape))
    rows = (out_r.starts[0], out_r.stops[0])
    cols = (out_r.starts[-1], out_r.stops[-1]) if out_r.ndim >= 2 else rows

    if k == OpKind.MATMUL:
        a, w = t(0), t(1)
        fp = {
            ins[0]: Region((rows[0], 0), (rows[1], a.shape[1])),
            ins[1]: Region((0, cols[0]), (w.shape[0], cols[1])),
        }
        if len(ins) > 2:  # bias
            fp[ins[2]] = Region((cols[0],), (cols[1],))
        return fp
    if k == OpKind.EMBED_LOOKUP:
        ids, table = t(0), t(1)
        return {
            ins[0]: Region((rows[0],), (rows[1],)),
            ins[1]: Region((0, cols[0]), (table.shape[0], cols[1])),
        }
    if k == OpKind.RMSNORM:
        x, wgt = t(0), t(1)
        return {
            ins[0]: Region((rows[0], 0), (rows[1], x.shape[1])),
            ins[1]: Region((0,), (wgt.shape[0],)),
        }
    if k == OpKind.ROPE:
        fp = {ins[0]: out_r}
        if len(ins) > 1:  # positions
            fp[ins[1]] = Region((rows[0],) + (0,) * (t(1).ndim - 1),
                                (rows[1],) + tuple(t(1).shape[1:]))
        return fp
    if k == OpKind.ATTENTION_DECODE:
        # out (B, H*hd); inputs: q (B, H*hd), k_cache/v_cache (B, S, KV*hd)
        hd = int(op.attrs["head_dim"])
        group = int(op.attrs["q_per_kv"])  # H // KV
        kv0 = cols[0] // (hd * group) * hd
        kv1 = math.ceil(cols[1] / (hd * group)) * hd
        kc, vc = t(1), t(2)
        fp = {
            ins[0]: Region((rows[0], cols[0]), (rows[1], cols[1])),
            ins[1]: Region((rows[0], 0, kv0), (rows[1], kc.shape[1], kv1)),
            ins[2]: Region((rows[0], 0, kv0), (rows[1], vc.shape[1], kv1)),
        }
        if len(ins) > 3:  # live seq lens
            fp[ins[3]] = Region((rows[0],), (rows[1],))
        return fp
    if k == OpKind.ATTENTION_PREFILL:
        # out (B*S, H*hd); causal: reads K/V rows up to its last query row
        hd = int(op.attrs["head_dim"])
        group = int(op.attrs["q_per_kv"])
        kv0 = cols[0] // (hd * group) * hd
        kv1 = math.ceil(cols[1] / (hd * group)) * hd
        return {
            ins[0]: Region((rows[0], cols[0]), (rows[1], cols[1])),
            ins[1]: Region((0, kv0), (rows[1], kv1)),
            ins[2]: Region((0, kv0), (rows[1], kv1)),
        }
    if k in (OpKind.GLU_MUL, OpKind.RESIDUAL_ADD, OpKind.ELEMENTWISE) or (
        k in OpKind.COMM_KINDS
    ):
        # elementwise: identity region on every input (this is exactly the
        # fine-grained AllReduce dependency of paper Fig. 3/4)
        return {name: out_r for name in ins}
    if k == OpKind.SOFTMAX_TOPK:
        x = t(0)
        return {ins[0]: Region((rows[0], 0), (rows[1], x.shape[1]))}
    if k == OpKind.MOE_GATHER_GEMM:
        # out (E, toks, f); inputs: x (toks, d) | (E, toks, d_ff),
        # router (toks, E), w (E, d, 2, f) fused-GLU | (E, f_in, f_out)
        e0, e1 = out_r.starts[0], out_r.stops[0]
        f0, f1 = out_r.starts[2], out_r.stops[2]
        x, router, w = t(0), t(1), t(2)
        if x.ndim == 3:  # second gemm: expert-local hidden, sliced to e
            x_region = Region((e0, 0, 0), (e1, x.shape[1], x.shape[2]))
        else:            # routing is data dependent: read all token rows
            x_region = fullr(x)
        if w.ndim == 4:
            w_region = Region((e0, 0, 0, f0), (e1, w.shape[1], 2, f1))
        else:
            w_region = Region((e0, 0, f0), (e1, w.shape[1], f1))
        return {
            ins[0]: x_region,
            ins[1]: Region((0, e0), (router.shape[0], e1)),
            ins[2]: w_region,
        }
    if k == OpKind.MOE_COMBINE:
        # out (toks, d); inputs: expert_out (E, toks, d), router (toks, E)
        eo, router = t(0), t(1)
        return {
            ins[0]: Region((0, rows[0], 0), (eo.shape[0], rows[1], eo.shape[2])),
            ins[1]: Region((rows[0], 0), (rows[1], router.shape[1])),
        }
    if k == OpKind.SSM_UPDATE:
        # out y (B, H*hd); inputs: x (B,H*hd), state (B,H,hd,N), dt (B,H),
        # A (H,), Bm (B,N), Cm (B,N)
        hd = int(op.attrs["head_dim"])
        h0, h1 = cols[0] // hd, math.ceil(cols[1] / hd)
        st = t(1)
        fp = {
            ins[0]: out_r,
            ins[1]: Region((rows[0], h0, 0, 0), (rows[1], h1, st.shape[2], st.shape[3])),
            ins[2]: Region((rows[0], h0), (rows[1], h1)),
            ins[3]: Region((h0,), (h1,)),
            ins[4]: Region((rows[0], 0), (rows[1], t(4).shape[1])),
            ins[5]: Region((rows[0], 0), (rows[1], t(5).shape[1])),
        }
        if len(ins) > 6:  # D skip (nh,)
            fp[ins[6]] = Region((h0,), (h1,))
        return fp
    if k == OpKind.CACHE_UPDATE:
        # out (B, S, KV*hd) = cache with row seq_lens[b] overwritten by new
        # (B, KV*hd).  Tile: batch rows × kv-column tile, full S.
        kv0, kv1 = out_r.starts[-1], out_r.stops[-1]
        return {
            ins[0]: out_r,                                   # old cache tile
            ins[1]: Region((rows[0], kv0), (rows[1], kv1)),  # new K/V
            ins[2]: Region((rows[0],), (rows[1],)),          # seq_lens
        }
    if k == OpKind.CONV1D_UPDATE:
        # out (B, D); inputs: x (B, D), conv_state (B, W, D), w (W, D), b (D,)
        fp = {ins[0]: out_r}
        if len(ins) > 1:
            cs = t(1)
            fp[ins[1]] = Region((rows[0], 0, 0), (rows[1], cs.shape[1], cs.shape[2]))
        for i in range(2, len(ins)):
            fp[ins[i]] = fullr(t(i))
        return fp
    if k == OpKind.NOOP:
        return {}
    raise NotImplementedError(f"footprint for op kind {k!r}")


def _secondary_out_region(
    g: ComputationGraph, op: OpNode, primary_r: Region, out_name: str
) -> Region:
    """Region of a secondary output tile derived from the primary tile."""
    spec = g.spec(out_name)
    if op.kind == OpKind.SSM_UPDATE:
        # secondary output: new state (B, H, hd, N) — same rows + head range
        hd = int(op.attrs["head_dim"])
        r0, r1 = primary_r.starts[0], primary_r.stops[0]
        h0 = primary_r.starts[1] // hd
        h1 = math.ceil(primary_r.stops[1] / hd)
        return Region((r0, h0, 0, 0), (r1, h1, spec.shape[2], spec.shape[3]))
    if op.kind == OpKind.CONV1D_UPDATE:
        r0, r1 = primary_r.starts[0], primary_r.stops[0]
        return Region((r0, 0, 0), (r1, spec.shape[1], spec.shape[2]))
    if spec.shape == g.spec(op.outputs[0]).shape:
        return primary_r
    raise NotImplementedError(
        f"secondary output region for {op.kind}:{out_name}"
    )


# --------------------------------------------------------------------------
# FLOP / byte estimates per task (drives the latency-aware schedule).
# --------------------------------------------------------------------------


def _task_cost(g: ComputationGraph, op: OpNode, out_r: Region) -> Tuple[int, int]:
    rows = out_r.shape[0] if out_r.ndim else 1
    cols = out_r.shape[-1] if out_r.ndim >= 2 else 1
    k = op.kind
    if k == OpKind.MATMUL:
        kdim = g.spec(op.inputs[0]).shape[1]
        return 2 * rows * cols * kdim, 2 * (rows * kdim + kdim * cols + rows * cols)
    if k in (OpKind.ATTENTION_DECODE, OpKind.ATTENTION_PREFILL):
        s = g.spec(op.inputs[1]).shape[1 if k == OpKind.ATTENTION_DECODE else 0]
        return 4 * rows * cols * s, 2 * rows * s * cols // max(1, int(op.attrs.get("q_per_kv", 1)))
    if k == OpKind.MOE_GATHER_GEMM:
        toks, dff = out_r.shape[1], out_r.shape[2]
        w = g.spec(op.inputs[2])
        kdim = w.shape[1]
        glu = 2 if w.ndim == 4 else 1
        return (2 * glu * toks * dff * kdim,
                2 * (glu * kdim * dff + toks * kdim))
    if k == OpKind.SSM_UPDATE:
        n = g.spec(op.inputs[1]).shape[3]
        return 6 * rows * cols * n, 4 * rows * cols * n
    if k == OpKind.CACHE_UPDATE:
        # the task writes ONE new K/V row per batch slot at its seq_len
        # (plus reads the incoming projection row); its aliased out
        # region spans the whole cache for dependency purposes, but the
        # traffic is O(rows × kv_width) — independent of cache length
        # (charging 2·out_r.size here made a decode step look like it
        # rewrote the entire cache, drowning every other cost at long
        # context)
        width = out_r.shape[-1] if out_r.ndim >= 2 else 1
        nbytes = 2 * rows * width
        return 2 * rows * width, 3 * nbytes
    nbytes = 2 * out_r.size
    return 2 * out_r.size, 3 * nbytes


# --------------------------------------------------------------------------


def decompose(g: ComputationGraph, cfg: DecomposeConfig | None = None) -> TGraph:
    """Lower every operator into SM-level tasks (no events yet)."""
    cfg = cfg or DecomposeConfig()
    tg = TGraph(g.name)
    per_op_tasks: Dict[int, List[int]] = {}
    for op in g.ops:
        primary = g.spec(op.outputs[0])
        regions = _partition_primary(op, primary, cfg)
        tids: List[int] = []
        for r in regions:
            outs = {op.outputs[0]: r}
            for extra in op.outputs[1:]:
                outs[extra] = _secondary_out_region(g, op, r, extra)
            flops, nbytes = _task_cost(g, op, r)
            task = tg.new_task(
                op.op_id,
                op.kind,
                out_regions=outs,
                in_regions=_footprint(g, op, r),
                attrs={"flops": flops, "bytes": nbytes, **{
                    kk: vv for kk, vv in op.attrs.items() if kk in (
                        "head_dim", "q_per_kv", "activation", "mesh_axis",
                        "expert", "top_k", "scale", "eps", "causal")}},
                launch_mode=op.launch_mode,
            )
            tids.append(task.task_id)
        per_op_tasks[op.op_id] = tids
    tg.stats["tasks_per_op"] = (
        sum(len(v) for v in per_op_tasks.values()) / max(1, len(per_op_tasks))
    )
    tg.stats["num_ops"] = len(g.ops)
    tg.stats["per_op_tasks"] = per_op_tasks
    return tg
