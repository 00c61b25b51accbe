"""The Mamba2 (SSD) mixer's decode step in PyTorch: the port's copy of
``repro/models/ssm.py`` (the reference) for serving, ``conv_decode`` and
``ssm_decode``.  ``prefill_chunk`` steps ``ssm_decode`` token by token,
as the reference's does, so the chunked scan (``causal_conv``,
``_ssd_scan``, ``ssm_prefill``), which serves the reference's
``forward`` and training, is not needed here (ROADMAP: the training
slice).

Layouts are the reference's: x_t (B, D); conv_state (B, W, C); the SSD
state (B, nh, hd, N).  Only one group of B and C (``ssm_ngroups == 1``,
as mamba2) is ported: ``models.lm.check_supported`` refuses more.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm

__all__ = ["softplus", "conv_decode", "ssm_decode"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))``: the stable form that
    ``jax.nn.softplus`` computes."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def conv_decode(x_t: torch.Tensor, conv_state: torch.Tensor,
                conv_w: torch.Tensor, conv_b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal depthwise conv.  x_t (B, C); conv_state (B, W,
    C); returns (silu(conv + bias) (B, C), the shifted window)."""
    new_state = torch.cat([conv_state[:, 1:], x_t[:, None]], dim=1)
    y = torch.einsum("bwc,wc->bc", new_state.float(), conv_w.float()) \
        + conv_b.float()
    return F.silu(y).to(x_t.dtype), new_state.to(conv_state.dtype)


def ssm_decode(x_t: torch.Tensor, states: Mapping[str, torch.Tensor],
               p: Mapping[str, torch.Tensor], cfg
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Mamba2 step.  x_t (B, D) (already normed); states: conv_x (B,
    W, d_inner), conv_b / conv_c (B, W, N), ssm (B, nh, hd, N); ``p``
    holds the layer's weights under the reference's names (zproj, xproj,
    bproj, cproj, dtproj, conv_w{x,b,c}, conv_b{x,b,c}, A_log, D_skip,
    dt_bias, gnorm, out_proj).  Returns (y (B, D), new states)."""
    bsz = x_t.shape[0]
    nh, n, hd = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_head_dim
    z = x_t @ p["zproj"]
    xx, conv_x = conv_decode(x_t @ p["xproj"], states["conv_x"],
                             p["conv_wx"], p["conv_bx"])
    bb, conv_b = conv_decode(x_t @ p["bproj"], states["conv_b"],
                             p["conv_wb"], p["conv_bb"])
    cc, conv_c = conv_decode(x_t @ p["cproj"], states["conv_c"],
                             p["conv_wc"], p["conv_bc"])
    dt_raw = x_t @ p["dtproj"]
    xs = xx.reshape(bsz, nh, hd).float()
    bmat = bb.reshape(bsz, n).float()
    cmat = cc.reshape(bsz, n).float()
    dt = softplus(dt_raw.float() + p["dt_bias"].float())          # (B, nh)
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a)                                        # (B, nh)
    new_state = (states["ssm"] * da[..., None, None]
                 + (dt[..., None] * xs)[..., None] * bmat[:, None, None, :])
    y = torch.einsum("bnpq,bq->bnp", new_state, cmat)
    y = y + p["D_skip"].float()[None, :, None] * xs
    y = y.reshape(bsz, cfg.d_inner)
    y = rmsnorm((y * F.silu(z.float())).to(x_t.dtype), p["gnorm"],
                cfg.norm_eps)
    new_states = {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                  "ssm": new_state.to(states["ssm"].dtype)}
    return y @ p["out_proj"], new_states
