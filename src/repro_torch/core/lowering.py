"""Lowering: ModelConfig → kernel-level decode-step ComputationGraph.

The port's copy of ``repro/core/lowering.py`` for the dense, MoE and
SSM families and the embedding-input backbones (the ``h0`` graph input,
and (B, 3) positions for M-RoPE), the shared experts beside the routed
ones (llama4), with the TP AllReduce insertion (the hybrid branch is a
later slice and raises).  The
graph's tensor names double as binding keys and as the port's parameter
names, so ``decode_bindings`` is the parameter dict plus the cache and
the per-step inputs.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..models.lm import block_structure, check_supported
from .graph import ComputationGraph, OpKind

__all__ = ["build_decode_graph", "decode_bindings"]


def build_decode_graph(
    cfg,
    batch: int,
    max_seq: int,
    *,
    tp: int = 1,
    name: Optional[str] = None,
) -> ComputationGraph:
    """One decode step (one new token per request) as an operator graph,
    node for node the reference's graph of the same config.

    ``tp > 1`` inserts an ALLREDUCE after every attention or SSM output
    projection and every FFN or MoE output (paper §6.5); shapes stay
    global (the graph is one shard's schedule)."""
    check_supported(cfg)
    g = ComputationGraph(name or f"{cfg.name}-decode-b{batch}")
    d, hd = cfg.d_model, cfg.hd
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    b = batch

    # ---- graph inputs ----
    if cfg.embed_input:
        g.add_tensor("h0", (b, d), is_input=True)
    else:
        g.add_tensor("tokens", (b,), "int32", is_input=True)
        g.add_tensor("embed", (cfg.vocab, d), is_input=True)
    pos_shape = (b, 3) if cfg.mrope_sections is not None else (b,)
    if any(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)):
        g.add_tensor("positions", pos_shape, "int32", is_input=True)
    g.add_tensor("seq_lens", (b,), "int32", is_input=True)
    g.add_tensor("live_lens", (b,), "int32", is_input=True)  # seq_lens + 1

    if not cfg.embed_input:
        g.add_tensor("h0", (b, d))
        g.add_op(OpKind.EMBED_LOOKUP, ["tokens", "embed"], ["h0"])
    h = "h0"
    if cfg.gemma_norm:  # gemma scales embeddings by sqrt(d_model)
        g.add_tensor("h0s", (b, d))
        g.add_op(OpKind.ELEMENTWISE, [h], ["h0s"], scale=float(d) ** 0.5)
        h = "h0s"

    mrope = (tuple(cfg.mrope_sections)
             if cfg.mrope_sections is not None else None)

    def matmul(x: str, w: str, out: str, out_cols: int, *, bias: str = "",
               activation=None) -> str:
        g.add_tensor(w, (g.spec(x).shape[-1], out_cols), is_input=True)
        ins = [x, w]
        if bias:
            g.add_tensor(bias, (out_cols,), is_input=True)
            ins.append(bias)
        g.add_tensor(out, (b, out_cols))
        kw = {"activation": activation} if activation else {}
        g.add_op(OpKind.MATMUL, ins, [out], **kw)
        return out

    def allreduce(y: str, out: str) -> str:
        if tp <= 1:
            return y
        g.add_tensor(out, (b, d))
        g.add_op(OpKind.ALLREDUCE, [y], [out], mesh_axis="model", tp=tp)
        return out

    def ssm_mixer(L: str, x: str) -> str:
        """The Mamba2 mixer of layer ``L`` on the normed input ``x``: the
        five input projections (dt with its bias), the three conv steps,
        the SSD state update, the gate, the gated norm and out_proj;
        returns the mixer's output tensor."""
        din, nh = cfg.d_inner, cfg.ssm_nheads
        gn = cfg.ssm_ngroups * cfg.ssm_state
        w = cfg.ssm_conv
        z = matmul(x, f"{L}.zproj", f"{L}.z", din)
        xp = matmul(x, f"{L}.xproj", f"{L}.xp", din)
        bp = matmul(x, f"{L}.bproj", f"{L}.bp", gn)
        cp = matmul(x, f"{L}.cproj", f"{L}.cp", gn)
        dt = matmul(x, f"{L}.dtproj", f"{L}.dt", nh, bias=f"{L}.dt_bias")
        conv_outs = {}
        for tag, src, width in (("x", xp, din), ("b", bp, gn),
                                ("c", cp, gn)):
            g.add_tensor(f"{L}.conv_{tag}_state", (b, w, width),
                         is_input=True)
            g.add_tensor(f"{L}.conv_w{tag}", (w, width), is_input=True)
            g.add_tensor(f"{L}.conv_b{tag}", (width,), is_input=True)
            g.add_tensor(f"{L}.conv_{tag}", (b, width))
            g.add_tensor(f"{L}.conv_{tag}_state2", (b, w, width))
            g.add_op(OpKind.CONV1D_UPDATE,
                     [src, f"{L}.conv_{tag}_state", f"{L}.conv_w{tag}",
                      f"{L}.conv_b{tag}"],
                     [f"{L}.conv_{tag}", f"{L}.conv_{tag}_state2"],
                     activation="silu")
            g.mark_output(f"{L}.conv_{tag}_state2")
            conv_outs[tag] = f"{L}.conv_{tag}"
        sshape = (b, nh, cfg.ssm_head_dim, cfg.ssm_state)
        g.add_tensor(f"{L}.ssm_state", sshape, is_input=True)
        g.add_tensor(f"{L}.A_log", (nh,), is_input=True)
        g.add_tensor(f"{L}.D_skip", (nh,), is_input=True)
        g.add_tensor(f"{L}.y", (b, din))
        g.add_tensor(f"{L}.ssm_state2", sshape)
        g.add_op(OpKind.SSM_UPDATE,
                 [conv_outs["x"], f"{L}.ssm_state", dt, f"{L}.A_log",
                  conv_outs["b"], conv_outs["c"], f"{L}.D_skip"],
                 [f"{L}.y", f"{L}.ssm_state2"],
                 head_dim=cfg.ssm_head_dim, col_align=cfg.ssm_head_dim)
        g.mark_output(f"{L}.ssm_state2")
        g.add_tensor(f"{L}.gated", (b, din))
        g.add_op(OpKind.GLU_MUL, [z, f"{L}.y"], [f"{L}.gated"],
                 activation="silu")
        g.add_tensor(f"{L}.gnorm_w", (din,), is_input=True)
        g.add_tensor(f"{L}.gn", (b, din))
        g.add_op(OpKind.RMSNORM, [f"{L}.gated", f"{L}.gnorm_w"],
                 [f"{L}.gn"], eps=cfg.norm_eps)
        return matmul(f"{L}.gn", f"{L}.out_proj", f"{L}.o", d)

    for i in range(cfg.n_layers):
        L = f"L{i}"
        g.add_tensor(f"{L}.ln_w", (d,), is_input=True)
        g.add_tensor(f"{L}.x", (b, d))
        g.add_op(OpKind.RMSNORM, [h, f"{L}.ln_w"], [f"{L}.x"],
                 eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
        x = f"{L}.x"
        if cfg.layer_kind(i) == "ssm":
            o = allreduce(ssm_mixer(L, x), f"{L}.o_ar")
            g.add_tensor(f"{L}.h", (b, d))
            g.add_op(OpKind.RESIDUAL_ADD, [h, o], [f"{L}.h"])
            h = f"{L}.h"
            continue                    # mixer-only: no FFN (checked)
        bq = f"{L}.bq" if cfg.qkv_bias else ""
        bk = f"{L}.bk" if cfg.qkv_bias else ""
        bv = f"{L}.bv" if cfg.qkv_bias else ""
        q = matmul(x, f"{L}.wq", f"{L}.q", qd, bias=bq)
        k = matmul(x, f"{L}.wk", f"{L}.k", kvd, bias=bk)
        v = matmul(x, f"{L}.wv", f"{L}.v", kvd, bias=bv)
        # RoPE (head-aligned tiles)
        g.add_tensor(f"{L}.qr", (b, qd))
        g.add_op(OpKind.ROPE, [q, "positions"], [f"{L}.qr"],
                 head_dim=hd, theta=cfg.rope_theta,
                 mrope_sections=mrope, col_align=hd)
        g.add_tensor(f"{L}.kr", (b, kvd))
        g.add_op(OpKind.ROPE, [k, "positions"], [f"{L}.kr"],
                 head_dim=hd, theta=cfg.rope_theta,
                 mrope_sections=mrope, col_align=hd)
        # KV-cache update, then attention over the updated cache
        for cname, new in ((f"{L}.k_cache", f"{L}.kr"),
                           (f"{L}.v_cache", v)):
            g.add_tensor(cname, (b, max_seq, kvd), is_input=True)
            g.add_tensor(cname + "2", (b, max_seq, kvd))
            g.add_op(OpKind.CACHE_UPDATE, [cname, new, "seq_lens"],
                     [cname + "2"], col_align=hd)
            g.mark_output(cname + "2")
        g.add_tensor(f"{L}.attn", (b, qd))
        g.add_op(
            OpKind.ATTENTION_DECODE,
            [f"{L}.qr", f"{L}.k_cache2", f"{L}.v_cache2", "live_lens"],
            [f"{L}.attn"], head_dim=hd, q_per_kv=cfg.q_per_kv,
            col_align=hd * cfg.q_per_kv)
        o = allreduce(matmul(f"{L}.attn", f"{L}.wo", f"{L}.o", d),
                      f"{L}.o_ar")
        g.add_tensor(f"{L}.h", (b, d))
        g.add_op(OpKind.RESIDUAL_ADD, [h, o], [f"{L}.h"])
        h = f"{L}.h"

        # ---- FFN ----
        g.add_tensor(f"{L}.ln2_w", (d,), is_input=True)
        g.add_tensor(f"{L}.x2", (b, d))
        g.add_op(OpKind.RMSNORM, [h, f"{L}.ln2_w"], [f"{L}.x2"],
                 eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
        x = f"{L}.x2"
        if cfg.ffn_kind(i) == "mlp":
            f = cfg.d_ff
            gate = matmul(x, f"{L}.wi_gate", f"{L}.gate", f)
            up = matmul(x, f"{L}.wi_up", f"{L}.up", f)
            g.add_tensor(f"{L}.glu", (b, f))
            g.add_op(OpKind.GLU_MUL, [gate, up], [f"{L}.glu"],
                     activation=cfg.activation)
            y = matmul(f"{L}.glu", f"{L}.wo2", f"{L}.ffn", d)
        else:  # moe: router, top-k, the experts' fused GLU and down GEMMs
            e, fe = cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
            logits = matmul(x, f"{L}.router_w", f"{L}.router_logits", e)
            g.add_tensor(f"{L}.router", (b, e))
            g.add_op(OpKind.SOFTMAX_TOPK, [logits], [f"{L}.router"],
                     top_k=cfg.top_k)
            g.add_tensor(f"{L}.moe_w1", (e, d, 2, fe), is_input=True)
            g.add_tensor(f"{L}.eh", (e, b, fe))
            g.add_op(OpKind.MOE_GATHER_GEMM,
                     [x, f"{L}.router", f"{L}.moe_w1"], [f"{L}.eh"],
                     activation=cfg.activation)
            g.add_tensor(f"{L}.moe_w2", (e, fe, d), is_input=True)
            g.add_tensor(f"{L}.eo", (e, b, d))
            g.add_op(OpKind.MOE_GATHER_GEMM,
                     [f"{L}.eh", f"{L}.router", f"{L}.moe_w2"], [f"{L}.eo"])
            g.add_tensor(f"{L}.moe_out", (b, d))
            g.add_op(OpKind.MOE_COMBINE, [f"{L}.eo", f"{L}.router"],
                     [f"{L}.moe_out"])
            y = f"{L}.moe_out"
            if cfg.n_shared_experts:    # a GLU MLP beside, always on
                fs = fe * cfg.n_shared_experts
                sg = matmul(x, f"{L}.shared_gate_w", f"{L}.sgate", fs)
                su = matmul(x, f"{L}.shared_up_w", f"{L}.sup", fs)
                g.add_tensor(f"{L}.sglu", (b, fs))
                g.add_op(OpKind.GLU_MUL, [sg, su], [f"{L}.sglu"],
                         activation=cfg.activation)
                so = matmul(f"{L}.sglu", f"{L}.shared_down_w",
                            f"{L}.shared_out", d)
                g.add_tensor(f"{L}.moe_total", (b, d))
                g.add_op(OpKind.RESIDUAL_ADD, [y, so], [f"{L}.moe_total"])
                y = f"{L}.moe_total"
        y = allreduce(y, f"{L}.ffn_ar")
        g.add_tensor(f"{L}.h2", (b, d))
        g.add_op(OpKind.RESIDUAL_ADD, [h, y], [f"{L}.h2"])
        h = f"{L}.h2"

    # ---- final norm + LM head ----
    g.add_tensor("final_ln_w", (d,), is_input=True)
    g.add_tensor("hf", (b, d))
    g.add_op(OpKind.RMSNORM, [h, "final_ln_w"], ["hf"], eps=cfg.norm_eps,
             gemma_style=cfg.gemma_norm)
    g.add_tensor("lm_head", (d, cfg.vocab), is_input=True)
    g.add_tensor("logits", (b, cfg.vocab))
    g.add_op(OpKind.MATMUL, ["hf", "lm_head"], ["logits"])
    g.mark_output("logits")
    g.validate()
    return g


# ---------------------------------------------------------------------------
# Bindings: the port's parameter dict and cache onto graph tensor names.
# ---------------------------------------------------------------------------


def state_map(cfg):
    """One entry per graph state tensor: its input/output names and where
    it lives in the ``init_cache`` dict (leaf key + (block, index)), as
    the reference's ``api/program.py`` ``_state_map``."""
    st = block_structure(cfg)
    out = []
    for i in range(cfg.n_layers):
        L = f"L{i}"
        blk, pos = divmod(i, st["period"])
        if cfg.layer_kind(i) == "ssm":
            si = st["ssm_pos"].index(pos)
            names = [(f"{L}.conv_{t}_state", f"conv_{t}") for t in "xbc"] \
                + [(f"{L}.ssm_state", "ssm")]
            out += [{"in": name, "out": name + "2", "key": key, "blk": blk,
                     "idx": si} for name, key in names]
            continue
        ai = st["attn_pos"].index(pos)
        for name, key in ((f"{L}.k_cache", "k"), (f"{L}.v_cache", "v")):
            out.append({"in": name, "out": name + "2", "key": key,
                        "blk": blk, "idx": ai})
    return out


def decode_bindings(cfg, params: Mapping[str, torch.Tensor],
                    cache: Mapping[str, torch.Tensor], tokens_or_embeds,
                    seq_lens, positions=None) -> Dict[str, torch.Tensor]:
    """A tensor for every graph input of ``build_decode_graph``: the
    weights as given (graph-named), the cache leaves reshaped to the
    graph's state tensors ((B, S, KV·hd) KV caches, (B, W, C) conv
    windows, (B, nh, hd, N) SSD states), and the per-step inputs: token
    ids, or the (B, D) embeddings ``h0`` when ``cfg.embed_input``, and
    the positions (``seq_lens`` unless given; 1-D positions stacked to
    the three M-RoPE columns)."""
    check_supported(cfg)
    lens = torch.as_tensor(seq_lens, dtype=torch.int32)
    out: Dict[str, torch.Tensor] = dict(params)
    if cfg.tie_embeddings:
        out["lm_head"] = params["embed"].T
    if cfg.embed_input:
        out["h0"] = torch.as_tensor(tokens_or_embeds, dtype=torch.float32)
    else:
        out["tokens"] = torch.as_tensor(tokens_or_embeds, dtype=torch.int32)
    out["seq_lens"] = lens
    out["live_lens"] = lens + 1
    pos = torch.as_tensor(seq_lens if positions is None else positions,
                          dtype=torch.int32)
    if cfg.mrope_sections is not None and pos.dim() == 1:
        pos = torch.stack([pos] * 3, dim=-1)
    out["positions"] = pos
    for ent in state_map(cfg):
        leaf = cache[ent["key"]][ent["blk"], ent["idx"]]
        if ent["key"] in ("k", "v"):    # (B, S, KV, hd) -> (B, S, KV·hd)
            leaf = leaf.reshape(leaf.shape[0], leaf.shape[1], -1)
        out[ent["in"]] = leaf
    return out
