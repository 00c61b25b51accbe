"""Reference numerical semantics for every task kind (numpy, float32).

Shared by the tGraph interpreter (the end-to-end oracle) and by the Pallas
kernel tests.  Each function receives the task's *full input regions* as
arrays and returns the array for the task's primary-output region (plus
secondary outputs where applicable).  Shapes are exactly the region shapes —
these functions are deliberately tile-local, mirroring what one SM / one grid
step computes.

The port's copy of ``repro/core/task_semantics.py`` (the reference),
numpy only: ``_softmax_topk``, ``_moe_gather_gemm`` and ``_moe_combine``
are the tile-local oracle of the megakernel's kinds 9-11.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["TASK_FNS", "silu", "gelu", "rope_rotate", "softmax"]


def silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def gelu(x: np.ndarray) -> np.ndarray:
    # tanh approximation (matches jax.nn.gelu default)
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


_ACT = {"silu": silu, "gelu": gelu, "identity": lambda x: x}


def rope_rotate(
    x: np.ndarray,
    positions: np.ndarray,
    head_dim: int,
    theta: float = 10000.0,
    col_start: int = 0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
) -> np.ndarray:
    """NeoX-style rotary embedding on a column tile of a (rows, n_heads*hd)
    tensor.  ``col_start`` is the tile's global column offset (tiles are
    head-aligned so every tile holds whole heads).  For M-RoPE (Qwen2-VL),
    ``positions`` is (rows, 3) and ``mrope_sections`` splits the rotary dims
    into temporal/height/width groups."""
    rows, cols = x.shape
    assert cols % head_dim == 0 and col_start % head_dim == 0
    half = head_dim // 2
    inv_freq = theta ** (-np.arange(0, half, dtype=np.float64) / half)
    if mrope_sections is None:
        pos = positions.astype(np.float64).reshape(rows, 1)
        ang = pos * inv_freq[None, :]  # (rows, half)
    else:
        assert positions.ndim == 2 and positions.shape[1] == len(mrope_sections)
        ang = np.zeros((rows, half), np.float64)
        start = 0
        for sec_i, sec in enumerate(mrope_sections):
            ang[:, start : start + sec] = (
                positions[:, sec_i : sec_i + 1].astype(np.float64)
                * inv_freq[None, start : start + sec]
            )
            start += sec
        assert start == half, "mrope sections must cover head_dim/2"
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    out = np.empty_like(x)
    for h in range(cols // head_dim):
        blk = x[:, h * head_dim : (h + 1) * head_dim]
        x1, x2 = blk[:, :half], blk[:, half:]
        out[:, h * head_dim : h * head_dim + half] = x1 * cos - x2 * sin
        out[:, h * head_dim + half : (h + 1) * head_dim] = x2 * cos + x1 * sin
    return out


# --------------------------------------------------------------------------
# Per-kind task functions.  Signature: fn(ins: list[np.ndarray], attrs, ctx)
# -> np.ndarray | tuple[np.ndarray, ...].  ``ctx`` carries tile geometry
# (global offsets) needed by position-dependent ops.
# --------------------------------------------------------------------------


def _embed_lookup(ins, attrs, ctx):
    ids, table = ins  # ids (rows,), table (V, ctile)
    return table[ids.astype(np.int64)]


def _rmsnorm(ins, attrs, ctx):
    x, w = ins
    eps = float(attrs.get("eps", 1e-6))
    var = np.mean(x.astype(np.float32) ** 2, axis=-1, keepdims=True)
    y = x / np.sqrt(var + eps)
    if attrs.get("gemma_style", False):  # gemma: (1 + w)
        return y * (1.0 + w)
    return y * w


def _matmul(ins, attrs, ctx):
    a, w = ins[0], ins[1]
    y = a.astype(np.float32) @ w.astype(np.float32)
    if len(ins) > 2:
        y = y + ins[2]
    act = attrs.get("activation")
    if act:
        y = _ACT[act](y)
    return y


def _rope(ins, attrs, ctx):
    x = ins[0]
    positions = ins[1]
    return rope_rotate(
        x,
        positions,
        head_dim=int(attrs["head_dim"]),
        theta=float(attrs.get("theta", 10000.0)),
        col_start=ctx.get("col_start", 0),
        mrope_sections=attrs.get("mrope_sections"),
    )


def _attention_decode(ins, attrs, ctx):
    # q (rows, n_heads_tile*hd); k/v (rows, S, n_kv_tile*hd); seq_lens (rows,)
    q, k, v = ins[0], ins[1], ins[2]
    seq_lens = ins[3] if len(ins) > 3 else None
    hd = int(attrs["head_dim"])
    group = int(attrs["q_per_kv"])
    scale = float(attrs.get("scale", hd**-0.5))
    rows, qcols = q.shape
    n_heads = qcols // hd
    s = k.shape[1]
    n_kv = k.shape[2] // hd
    qr = q.reshape(rows, n_heads, hd)
    kr = k.reshape(rows, s, n_kv, hd)
    vr = v.reshape(rows, s, n_kv, hd)
    out = np.empty_like(qr)
    for h in range(n_heads):
        g = h // group
        logits = np.einsum("bd,bsd->bs", qr[:, h], kr[:, :, g]) * scale
        if seq_lens is not None:
            mask = np.arange(s)[None, :] >= seq_lens[:, None]
            logits = np.where(mask, -1e30, logits)
        p = softmax(logits, axis=-1)
        out[:, h] = np.einsum("bs,bsd->bd", p, vr[:, :, g])
    return out.reshape(rows, qcols)


def _attention_prefill(ins, attrs, ctx):
    # q (rowtile, H_tile*hd); k/v (rows_le, KV_tile*hd); causal within one seq
    q, k, v = ins[0], ins[1], ins[2]
    hd = int(attrs["head_dim"])
    group = int(attrs["q_per_kv"])
    scale = float(attrs.get("scale", hd**-0.5))
    row_start = ctx.get("row_start", 0)
    rows, qcols = q.shape
    n_heads = qcols // hd
    s = k.shape[0]
    n_kv = k.shape[1] // hd
    qr = q.reshape(rows, n_heads, hd)
    kr = k.reshape(s, n_kv, hd)
    vr = v.reshape(s, n_kv, hd)
    out = np.empty_like(qr)
    qpos = row_start + np.arange(rows)
    kpos = np.arange(s)
    causal = kpos[None, :] > qpos[:, None]
    for h in range(n_heads):
        g = h // group
        logits = qr[:, h] @ kr[:, g].T * scale
        logits = np.where(causal, -1e30, logits)
        p = softmax(logits, axis=-1)
        out[:, h] = p @ vr[:, g]
    return out.reshape(rows, qcols)


def _glu_mul(ins, attrs, ctx):
    gate, up = ins[0], ins[1]
    return _ACT[attrs.get("activation", "silu")](gate.astype(np.float32)) * up


def _residual_add(ins, attrs, ctx):
    return ins[0].astype(np.float32) + ins[1]


def _elementwise(ins, attrs, ctx):
    y = _ACT[attrs.get("activation", "identity")](ins[0].astype(np.float32))
    return y * float(attrs.get("scale", 1.0))


def _softmax_topk(ins, attrs, ctx):
    # router logits (rows, E) -> sparse weights (rows, E); softmax over the
    # selected top-k (renormalized), zeros elsewhere
    (logits,) = ins
    k = int(attrs["top_k"])
    rows, e = logits.shape
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    weights = np.zeros((rows, e), np.float32)
    sel = np.take_along_axis(logits, order, axis=-1)
    p = softmax(sel, axis=-1)
    np.put_along_axis(weights, order, p, axis=-1)
    return weights


def _moe_gather_gemm(ins, attrs, ctx):
    # out (1, toks, f_tile) for expert e; ins: x (toks, d) | (E, toks, d),
    # router weights (toks, e0:e1) [tile-local col 0 = this expert],
    # w (1, d, f_tile)
    x, router, w = ins[0], ins[1], ins[2]
    outs = []
    for e in range(w.shape[0]):  # tile E-extent (1 per task; E whole-op)
        x2d = x[e] if x.ndim == 3 else x
        mask = (router[:, e] > 0).astype(np.float32)
        xm = (x2d * mask[:, None]).astype(np.float32)
        if w.ndim == 4:  # fused gate/up GLU GEMM
            gate = xm @ w[e, :, 0, :].astype(np.float32)
            up = xm @ w[e, :, 1, :].astype(np.float32)
            y = _ACT[attrs.get("activation", "silu")](gate) * up
        else:
            y = xm @ w[e].astype(np.float32)
        outs.append(y)
    return np.stack(outs, axis=0)


def _moe_combine(ins, attrs, ctx):
    # out (rows, d) = sum_e router[b, e] * expert_out[e, b, :]
    expert_out, router = ins[0], ins[1]
    return np.einsum("ebd,be->bd", expert_out.astype(np.float32), router)


def _ssm_update(ins, attrs, ctx):
    # Mamba2 single-token state update (SSD decode step).
    # ins: x (rows, h_tile*hd), state (rows, h_tile, hd, N), dt (rows, h_tile),
    #      A (h_tile,), B (rows, N), C (rows, N), D (h_tile,)
    x, state, dt, a, bmat, cmat = ins[:6]
    dskip = ins[6] if len(ins) > 6 else None
    hd = int(attrs["head_dim"])
    rows = x.shape[0]
    h = x.shape[1] // hd
    xr = x.reshape(rows, h, hd).astype(np.float32)
    dt_sp = np.log1p(np.exp(dt.astype(np.float32)))  # softplus
    da = np.exp(dt_sp * (-np.exp(a.astype(np.float32)))[None, :])  # (rows, h)
    new_state = state * da[:, :, None, None] + (
        (dt_sp[:, :, None] * xr)[..., None] * bmat[:, None, None, :]
    )
    y = np.einsum("bhdn,bn->bhd", new_state, cmat.astype(np.float32))
    if dskip is not None:
        y = y + dskip[None, :, None] * xr
    return y.reshape(rows, h * hd), new_state


def _conv1d_update(ins, attrs, ctx):
    # causal depthwise conv, single-token update.
    # ins: x (rows, d), conv_state (rows, W, d), w (W, d), b (d,)
    x, state, w = ins[0], ins[1], ins[2]
    b = ins[3] if len(ins) > 3 else None
    new_state = np.concatenate([state[:, 1:], x[:, None, :]], axis=1)
    y = np.einsum("bwd,wd->bd", new_state.astype(np.float32), w.astype(np.float32))
    if b is not None:
        y = y + b
    if attrs.get("activation"):
        y = _ACT[attrs["activation"]](y)
    return y, new_state


def _cache_update(ins, attrs, ctx):
    # out = cache tile with row seq_lens[b] overwritten by the new K/V.
    cache, new, seq_lens = ins[0], ins[1], ins[2]
    out = np.array(cache, np.float32, copy=True)
    rows = out.shape[0]
    for b in range(rows):
        out[b, int(seq_lens[b])] = new[b]
    return out


def _identity_comm(ins, attrs, ctx):
    # single-host semantics of collectives: the interpreter models one shard
    return np.asarray(ins[0], np.float32)


TASK_FNS = {
    "embed_lookup": _embed_lookup,
    "rmsnorm": _rmsnorm,
    "matmul": _matmul,
    "rope": _rope,
    "attention_decode": _attention_decode,
    "attention_prefill": _attention_prefill,
    "glu_mul": _glu_mul,
    "residual_add": _residual_add,
    "elementwise": _elementwise,
    "softmax_topk": _softmax_topk,
    "moe_gather_gemm": _moe_gather_gemm,
    "moe_combine": _moe_combine,
    "ssm_update": _ssm_update,
    "conv1d_update": _conv1d_update,
    "cache_update": _cache_update,
    "allreduce": _identity_comm,
    "allgather": _identity_comm,
    "reduce_scatter": _identity_comm,
    "alltoall": _identity_comm,
}
