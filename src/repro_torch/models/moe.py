"""The Mixture-of-Experts FFN in PyTorch: the port's copy of
``repro/models/moe.py`` (the reference) on its single-shard path
(``mesh=None``), which the model oracle and the decode step use.

The capacity semantics are the reference's, drops included: each expert
has ``C = ceil(T·K·cf / E)`` token rows; the T·K (token, choice) pairs
are sorted by expert (stably, so within an expert in token order) and an
expert's pairs past its first C are dropped.  Routing takes the top K of
the router logits and softmaxes over the chosen values.

Ties: ``jax.lax.top_k`` returns the lower index first among equal
values.  ``torch.topk`` leaves the order of equal values unspecified, so
the port takes its top K from a stable descending sort
(``torch.sort(..., descending=True, stable=True)``), which keeps equal
logits in index order: the same choice and the same order as the
reference.

Weight layout: router (D, E), w1 (E, D, 2, F) with gate and up on axis
-2, w2 (E, F, D).  Shared experts (llama4) are a later slice.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch

from .layers import act_fn

__all__ = ["expert_capacity", "moe_ffn", "route"]


def expert_capacity(tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    return max(1, math.ceil(tokens * top_k * capacity_factor / n_experts))


def route(logits: torch.Tensor, top_k: int):
    """(weights (T, K), expert ids (T, K)) of the top K logits per row,
    equal logits in index order, softmaxed over the chosen values."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    topi = order[:, :top_k]
    topw = torch.gather(logits, -1, topi)
    return torch.softmax(topw, dim=-1), topi


def _moe_local(x2d: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor, *, top_k: int, n_experts: int,
               capacity: int, activation: str) -> torch.Tensor:
    t, d = x2d.shape
    act = act_fn(activation)

    # ---- routing: counts per expert ----
    logits = (x2d @ router_w.to(x2d.dtype)).float()
    topw, topi = route(logits, top_k)
    flat_ids = topi.reshape(-1)                           # (T*K,)
    flat_w = topw.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)       # (T*K,)
    counts = torch.bincount(flat_ids, minlength=n_experts)
    offsets = torch.cumsum(counts, 0) - counts            # exclusive

    slot = torch.arange(capacity, device=x2d.device)
    pos = offsets[:, None] + slot[None, :]                # (E, C)
    valid = slot[None, :] < counts[:, None]
    srows = sort_idx[torch.clamp(pos, 0, t * top_k - 1)]  # sorted order
    token = srows // top_k                                # (E, C)

    # ---- gather + dense expert GEMMs ----
    xg = x2d[token] * valid[..., None].to(x2d.dtype)      # (E, C, D)
    h = torch.einsum("ecd,edgf->ecgf", xg, w1.to(x2d.dtype))
    h = act(h[..., 0, :]) * h[..., 1, :]                  # (E, C, F)
    yo = torch.einsum("ecf,efd->ecd", h, w2.to(x2d.dtype))

    # ---- weighted combine; dropped rows add nothing ----
    # each kept (token, k) choice has one (expert, slot) row: put it in
    # place, then sum a token's K choices in order (no atomics, so the
    # bits do not change from run to run on the card)
    wrow = (flat_w[srows] * valid).to(x2d.dtype)          # (E, C)
    per = torch.zeros((t * top_k, d), dtype=x2d.dtype, device=x2d.device)
    per[srows[valid]] = (yo * wrow[..., None])[valid]
    return per.view(t, top_k, d).sum(1)


def moe_ffn(x2d: torch.Tensor, p: Mapping[str, torch.Tensor], cfg: Any, *,
            capacity_factor: Optional[float] = None) -> torch.Tensor:
    """MoE FFN over flat tokens (T, D) with the reference's single-shard
    semantics; ``p`` holds ``router``, ``w1`` and ``w2``.  The capacity
    factor defaults to ``cfg.capacity_factor``."""
    if cfg.n_shared_experts:
        raise NotImplementedError(
            f"{cfg.name}: shared experts are not ported yet")
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor
    cap = expert_capacity(x2d.shape[0], cfg.top_k, cfg.n_experts, cf)
    return _moe_local(x2d, p["router"], p["w1"], p["w2"], top_k=cfg.top_k,
                      n_experts=cfg.n_experts, capacity=cap,
                      activation=cfg.activation)
