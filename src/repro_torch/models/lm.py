"""The dense decoder LM in PyTorch: the port's model oracle and its
prefill path.

It mirrors ``repro/models/lm.py`` (the reference) for the dense family
(attention + gated MLP in every layer), the MoE family (attention + a
routed-expert FFN, ``models/moe.py``, with llama4's shared experts
beside it, dense and MoE layers interleaved or not), the SSM family (a Mamba2 mixer
and no FFN in every layer, ``models/ssm.py``, one group of B and C) and
the embedding-input backbones of the dense family (``embed_input``:
float embeddings in place of token ids and no embedding table; M-RoPE
where the config has sections).  The hybrid family is a later slice
and raises ``NotImplementedError``.

Parameters are a flat dict keyed by the decode graph's tensor names
(``embed`` unless the config takes embeddings, ``L0.wq``,
``L0.wi_gate``, ``L0.router_w`` or ``L0.zproj``, ..., ``final_ln_w``,
``lm_head``; see
``core/lowering.py``), so a megakernel heap slot and a model weight are
the same tensor: the torch model can run on strided views of the heap.
``params_from_jax`` turns the reference's stacked parameter tree (as
numpy arrays) into this dict.  The cache keeps the reference's
``init_cache`` layout: ``{"k", "v"}: (n_blocks, 1, B, S, KV, hd)`` for
attention, ``{"conv_x", "conv_b", "conv_c"}: (n_blocks, 1, B, W, C)``
and ``"ssm": (n_blocks, 1, B, nh, hd, N)`` for the Mamba2 mixer.

Unlike the reference, ``prefill_chunk`` updates the cache in place (it
returns the same dict): a full-width cache is hundreds of megabytes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .layers import act_fn, apply_rope, chunk_attention, rmsnorm, rope
from .moe import moe_ffn
from .ssm import ssm_decode

__all__ = ["block_structure", "check_supported", "param_specs", "fill_params",
           "init_params", "params_from_jax", "init_cache",
           "prefill_chunk", "serve_step"]


def block_structure(cfg) -> Dict[str, Any]:
    """Per-block layer layout: which positions are attn/ssm and mlp/moe."""
    p = cfg.block_period
    attn_pos = [i for i in range(p) if cfg.layer_kind(i) == "attn"]
    ssm_pos = [i for i in range(p) if cfg.layer_kind(i) == "ssm"]
    mlp_pos = [i for i in range(p) if cfg.ffn_kind(i) == "mlp"]
    moe_pos = [i for i in range(p) if cfg.ffn_kind(i) == "moe"]
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return {
        "period": p,
        "n_blocks": cfg.n_layers // p,
        "attn_pos": attn_pos,
        "ssm_pos": ssm_pos,
        "mlp_pos": mlp_pos,
        "moe_pos": moe_pos,
    }


def check_supported(cfg) -> None:
    """Raise for configurations outside the ported slices: attention and
    a gated MLP or routed experts (shared ones beside them or not) in
    every layer, or a Mamba2 mixer with one group of B and C and no FFN in
    every layer.  Token or embedding inputs, RoPE or M-RoPE."""
    layers = {(cfg.layer_kind(i), cfg.ffn_kind(i))
              for i in range(cfg.n_layers)}
    if not (layers <= {("attn", "mlp"), ("attn", "moe")}
            or layers == {("ssm", "none")}):
        raise NotImplementedError(
            f"{cfg.name}: only the dense, MoE and SSM families (attention "
            "+ MLP or experts in every layer, or a Mamba2 mixer alone in "
            "every layer) are ported yet")
    if ("ssm", "none") in layers and cfg.ssm_ngroups != 1:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 with {cfg.ssm_ngroups} groups of B and C "
            "is not ported yet (one group only)")


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------


def param_specs(cfg) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Every weight by graph name: (shape, init std), where std ``None``
    means ones (norm weights) and ``0.0`` zeros (biases).  The scales are
    the reference's ``init_params`` scales."""
    check_supported(cfg)
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    e, fe = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    specs: Dict[str, Tuple[Tuple[int, ...], Optional[float]]] = {}
    if not cfg.embed_input:
        specs["embed"] = ((cfg.vocab, d), 0.02)
    elif cfg.tie_embeddings:
        raise ValueError("tied embeddings require an embedding table")
    for i in range(cfg.n_layers):
        L = f"L{i}"
        specs[f"{L}.ln_w"] = ((d,), None)
        if cfg.layer_kind(i) == "ssm":
            specs.update(_ssm_specs(cfg, L))
            continue
        specs[f"{L}.wq"] = ((d, qd), d ** -0.5)
        specs[f"{L}.wk"] = ((d, kvd), d ** -0.5)
        specs[f"{L}.wv"] = ((d, kvd), d ** -0.5)
        if cfg.qkv_bias:
            specs[f"{L}.bq"] = ((qd,), 0.0)
            specs[f"{L}.bk"] = ((kvd,), 0.0)
            specs[f"{L}.bv"] = ((kvd,), 0.0)
        specs[f"{L}.wo"] = ((qd, d), qd ** -0.5)
        specs[f"{L}.ln2_w"] = ((d,), None)
        if cfg.ffn_kind(i) == "moe":
            specs[f"{L}.router_w"] = ((d, e), d ** -0.5)
            specs[f"{L}.moe_w1"] = ((e, d, 2, fe), d ** -0.5)
            specs[f"{L}.moe_w2"] = ((e, fe, d), fe ** -0.5)
            if cfg.n_shared_experts:
                fs = fe * cfg.n_shared_experts
                specs[f"{L}.shared_gate_w"] = ((d, fs), d ** -0.5)
                specs[f"{L}.shared_up_w"] = ((d, fs), d ** -0.5)
                specs[f"{L}.shared_down_w"] = ((fs, d), fs ** -0.5)
        else:
            specs[f"{L}.wi_gate"] = ((d, f), d ** -0.5)
            specs[f"{L}.wi_up"] = ((d, f), d ** -0.5)
            specs[f"{L}.wo2"] = ((f, d), f ** -0.5)
    specs["final_ln_w"] = ((d,), None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.vocab), d ** -0.5)
    return specs


def _ssm_specs(cfg, L: str):
    """The Mamba2 mixer's weights of layer ``L`` at the reference's init
    scales (``repro/models/lm.py`` ``init_params``)."""
    d, din, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    gn, w = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_conv
    specs = {f"{L}.zproj": ((d, din), d ** -0.5),
             f"{L}.xproj": ((d, din), d ** -0.5),
             f"{L}.bproj": ((d, gn), d ** -0.5),
             f"{L}.cproj": ((d, gn), d ** -0.5),
             f"{L}.dtproj": ((d, nh), d ** -0.5),
             f"{L}.dt_bias": ((nh,), 0.0)}
    for tag, width in (("x", din), ("b", gn), ("c", gn)):
        specs[f"{L}.conv_w{tag}"] = ((w, width), 0.2)
        specs[f"{L}.conv_b{tag}"] = ((width,), 0.0)
    specs.update({f"{L}.A_log": ((nh,), 0.0), f"{L}.D_skip": ((nh,), None),
                  f"{L}.gnorm_w": ((din,), None),
                  f"{L}.out_proj": ((din, d), din ** -0.5)})
    return specs


def fill_params(cfg, views: Mapping[str, torch.Tensor],
                generator: torch.Generator) -> None:
    """Draw every weight of ``param_specs`` in place into ``views`` (any
    tensors of the right shapes, e.g. strided views of a megakernel
    heap), one tensor at a time.  A tied ``lm_head`` view, where given,
    receives ``embed.T``."""
    for name, (_shape, std) in param_specs(cfg).items():
        v = views[name]
        if std is None:
            v.fill_(1.0)
        elif std == 0.0:
            v.zero_()
        else:
            v.normal_(0.0, std, generator=generator)
    if cfg.tie_embeddings and "lm_head" in views:
        views["lm_head"].copy_(views["embed"].T)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights (flat, graph-named); random draws come from
    ``generator`` (seed 0 on ``device`` when omitted)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, (shape, _std) in param_specs(cfg).items()}
    fill_params(cfg, params, generator)
    return params


#: the port's (graph) names of a Mamba2 layer's weights -> the
#: reference's keys in ``blocks["ssm"]``
_SSM_NAMES = {nm: nm for nm in (
    "zproj", "xproj", "bproj", "cproj", "dtproj", "dt_bias", "conv_wx",
    "conv_bx", "conv_wb", "conv_bb", "conv_wc", "conv_bc", "A_log",
    "D_skip", "out_proj")}
_SSM_NAMES["gnorm_w"] = "gnorm"


def params_from_jax(np_tree, cfg, device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (``repro.models.init_params``,
    leaves as numpy arrays) as the port's flat float32 dict."""
    check_supported(cfg)
    device = resolve_device(device)
    st = block_structure(cfg)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    blocks = np_tree["blocks"]
    out = {"final_ln_w": t(np_tree["final_ln"])}
    if not cfg.embed_input:
        out["embed"] = t(np_tree["embed"])
    if not cfg.tie_embeddings:
        out["lm_head"] = t(np_tree["lm_head"])
    for i in range(cfg.n_layers):
        L = f"L{i}"
        blk, pos = divmod(i, st["period"])
        if cfg.layer_kind(i) == "ssm":
            ssm, si = blocks["ssm"], st["ssm_pos"].index(pos)
            out[f"{L}.ln_w"] = t(ssm["ln"][blk, si])
            for nm, src in _SSM_NAMES.items():
                out[f"{L}.{nm}"] = t(ssm[src][blk, si])
            continue
        attn = blocks["attn"]
        ai = st["attn_pos"].index(pos)
        out[f"{L}.ln_w"] = t(attn["ln"][blk, ai])
        for nm in ("wq", "wk", "wv", "wo"):
            out[f"{L}.{nm}"] = t(attn[nm][blk, ai])
        if cfg.qkv_bias:
            for nm in ("bq", "bk", "bv"):
                out[f"{L}.{nm}"] = t(attn[nm][blk, ai])
        if cfg.ffn_kind(i) == "moe":
            moe, ei = blocks["moe"], st["moe_pos"].index(pos)
            out[f"{L}.ln2_w"] = t(moe["ln"][blk, ei])
            out[f"{L}.router_w"] = t(moe["router"][blk, ei])
            out[f"{L}.moe_w1"] = t(moe["w1"][blk, ei])      # (E, D, 2, F)
            out[f"{L}.moe_w2"] = t(moe["w2"][blk, ei])      # (E, F, D)
            if cfg.n_shared_experts:
                swi = np.asarray(moe["shared_wi"][blk, ei], np.float32)
                out[f"{L}.shared_gate_w"] = t(swi[:, 0])    # (D, F_s)
                out[f"{L}.shared_up_w"] = t(swi[:, 1])
                out[f"{L}.shared_down_w"] = t(moe["shared_wo"][blk, ei])
            continue
        mlp, mi = blocks["mlp"], st["mlp_pos"].index(pos)
        out[f"{L}.ln2_w"] = t(mlp["ln"][blk, mi])
        wi = np.asarray(mlp["wi"][blk, mi], np.float32)      # (D, 2, F)
        out[f"{L}.wi_gate"], out[f"{L}.wi_up"] = t(wi[:, 0]), t(wi[:, 1])
        out[f"{L}.wo2"] = t(mlp["wo"][blk, mi])
    return out


def init_cache(cfg, batch: int, max_seq: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Zeroed float32 decode state in the reference's stacked layout: the
    KV cache of the attention layers, the conv windows and SSD states of
    the Mamba2 layers."""
    check_supported(cfg)
    device = resolve_device(device)
    st = block_structure(cfg)
    nb = st["n_blocks"]
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    cache = {}
    if st["attn_pos"]:
        shape = (nb, len(st["attn_pos"]), batch, max_seq, cfg.n_kv_heads,
                 cfg.hd)
        cache["k"], cache["v"] = zeros(*shape), zeros(*shape)
    if st["ssm_pos"]:
        ns, w = len(st["ssm_pos"]), cfg.ssm_conv
        gn = cfg.ssm_ngroups * cfg.ssm_state
        cache["conv_x"] = zeros(nb, ns, batch, w, cfg.d_inner)
        cache["conv_b"] = zeros(nb, ns, batch, w, gn)
        cache["conv_c"] = zeros(nb, ns, batch, w, gn)
        cache["ssm"] = zeros(nb, ns, batch, cfg.ssm_nheads,
                             cfg.ssm_head_dim, cfg.ssm_state)
    return cache


# ---------------------------------------------------------------------------
# Chunked prefill and the decode step.
# ---------------------------------------------------------------------------


def _attn_chunk(h, params, L, cache_k, cache_v, cfg, cos, sin, seq_lens,
                valid):
    """Attention sub-layer for an N-token chunk, h (B, N, D).  The chunk's
    K/V land in the cache at ``seq_lens[b] + i`` (in place; padding
    positions write nothing), then every chunk query attends over it."""
    b, n, _d = h.shape
    x = rmsnorm(h, params[f"{L}.ln_w"], cfg.norm_eps, cfg.gemma_norm)
    q = x @ params[f"{L}.wq"]
    k = x @ params[f"{L}.wk"]
    v = x @ params[f"{L}.wv"]
    if cfg.qkv_bias:
        q = q + params[f"{L}.bq"]
        k = k + params[f"{L}.bk"]
        v = v + params[f"{L}.bv"]
    q = q.reshape(b, n, cfg.n_heads, cfg.hd)
    k = k.reshape(b, n, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, n, cfg.n_kv_heads, cfg.hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    pos = seq_lens[:, None] + torch.arange(n, device=h.device)[None, :]
    keep = valid & (pos < cache_k.shape[1])
    bidx = torch.arange(b, device=h.device)[:, None].expand(b, n)[keep]
    cache_k[bidx, pos[keep]] = k[keep]
    cache_v[bidx, pos[keep]] = v[keep]
    o = chunk_attention(q, cache_k, cache_v, seq_lens)
    o = o.reshape(b, n, cfg.n_heads * cfg.hd) @ params[f"{L}.wo"]
    return h + o


def _ffn(h, params, L, cfg):
    """The layer's FFN sub-layer: the gated MLP, or the routed experts
    over all B·N chunk rows (padding included, as in the reference)."""
    x = rmsnorm(h, params[f"{L}.ln2_w"], cfg.norm_eps, cfg.gemma_norm)
    if f"{L}.router_w" in params:
        p = {"router": params[f"{L}.router_w"], "w1": params[f"{L}.moe_w1"],
             "w2": params[f"{L}.moe_w2"]}
        if cfg.n_shared_experts:
            for nm in ("gate", "up", "down"):
                p[f"shared_{nm}"] = params[f"{L}.shared_{nm}_w"]
        return h + moe_ffn(x.reshape(-1, x.shape[-1]), p,
                           cfg).reshape(h.shape)
    gate = x @ params[f"{L}.wi_gate"]
    up = x @ params[f"{L}.wi_up"]
    return h + (act_fn(cfg.activation)(gate) * up) @ params[f"{L}.wo2"]


def _ssm_chunk(h, params, L, states, cfg, valid):
    """Mamba2 sub-layer for an N-token chunk, h (B, N, D): ``ssm_decode``
    stepped over the chunk positions, as the reference's ``_ssm_chunk``.
    ``states`` (conv_x, conv_b, conv_c, ssm) are views of the cache,
    updated in place; a padding position (``valid`` False) leaves its
    request's states as they were."""
    p = {nm: params[f"{L}.{nm}"] for nm in _SSM_NAMES}
    p["gnorm"] = p.pop("gnorm_w")
    x = rmsnorm(h, params[f"{L}.ln_w"], cfg.norm_eps, cfg.gemma_norm)
    ys = []
    for i in range(h.shape[1]):
        y, new = ssm_decode(x[:, i], states, p, cfg)
        for k, v in new.items():
            keep = valid[:, i].reshape((-1,) + (1,) * (v.dim() - 1))
            states[k].copy_(torch.where(keep, v, states[k]))
        ys.append(y)
    return h + torch.stack(ys, dim=1)


def prefill_chunk(params: Mapping[str, torch.Tensor], cfg,
                  cache: Dict[str, torch.Tensor],
                  tokens_or_embeds: torch.Tensor, seq_lens: torch.Tensor,
                  chunk_lens: Optional[torch.Tensor] = None):
    """Consume N prompt tokens per request in one step.

    tokens (B, N) integer, or embeds (B, N, D) float when
    ``cfg.embed_input``; seq_lens (B,) = live length *before* the chunk
    (token i lands at position seq_lens + i, the same position in all
    three M-RoPE columns: text mode, as the reference); chunk_lens (B,) =
    valid tokens per request (default N).  Positions >= chunk_lens are padding:
    they write no cache or SSM state and their logits are garbage (the
    experts of an MoE layer route them too, so they take expert
    capacity, as in the reference).  Returns
    (logits (B, N, V) float32, cache), the cache updated in place."""
    check_supported(cfg)
    st = block_structure(cfg)
    if cfg.embed_input:
        h = tokens_or_embeds.float()
    else:
        h = params["embed"][tokens_or_embeds.long()]
    b, n = h.shape[:2]
    seq_lens = seq_lens.long()
    if chunk_lens is None:
        chunk_lens = torch.full((b,), n, dtype=torch.long, device=h.device)
    valid = (torch.arange(n, device=h.device)[None, :]
             < chunk_lens.long()[:, None])
    if cfg.gemma_norm:
        h = h * math.sqrt(cfg.d_model)
    if st["attn_pos"]:
        pos = seq_lens[:, None] + torch.arange(n, device=h.device)[None, :]
        if cfg.mrope_sections is not None:
            pos = torch.stack([pos] * 3, dim=-1)     # text-mode M-RoPE
        cos, sin = rope(pos, cfg.hd, cfg.rope_theta, cfg.mrope_sections)
    for i in range(cfg.n_layers):
        L = f"L{i}"
        blk, at = divmod(i, st["period"])
        if cfg.layer_kind(i) == "ssm":
            si = st["ssm_pos"].index(at)
            states = {k: cache[k][blk, si]
                      for k in ("conv_x", "conv_b", "conv_c", "ssm")}
            h = _ssm_chunk(h, params, L, states, cfg, valid)
        else:
            ai = st["attn_pos"].index(at)
            h = _attn_chunk(h, params, L, cache["k"][blk, ai],
                            cache["v"][blk, ai], cfg, cos, sin, seq_lens,
                            valid)
        if cfg.ffn_kind(i) != "none":
            h = _ffn(h, params, L, cfg)
    h = rmsnorm(h, params["final_ln_w"], cfg.norm_eps, cfg.gemma_norm)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return (h @ head).float(), cache


def serve_step(params, cfg, cache, tokens_or_embeds: torch.Tensor,
               seq_lens: torch.Tensor):
    """One decode step: ``prefill_chunk`` with a width-1 chunk.  tokens
    (B,), or embeds (B, D) when ``cfg.embed_input``; returns (logits
    (B, V) float32, cache)."""
    logits, cache = prefill_chunk(params, cfg, cache,
                                  tokens_or_embeds[:, None], seq_lens)
    return logits[:, 0], cache
