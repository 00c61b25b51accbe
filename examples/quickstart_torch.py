"""Quickstart of the PyTorch/CUDA port: compile once, decode many.

    python examples/quickstart_torch.py          # on a machine with a card
    python examples/quickstart_torch.py --cpu    # reduced size, on the CPU

``repro_torch.api.compile`` lowers a model's decode step through the MPK
compiler (decompose, deps, fuse, normalize, linearize, partition) and
returns a stateful Program; the two backends are interchangeable:

* ``torch``      — the torch model, the decode oracle;
* ``megakernel`` — ONE launch of the hand-written CUDA persistent kernel
  per step against a device-resident heap (weights drawn into it once),
  W workers (one CTA each) under the static or the dynamic scheduler;
  on the CPU its plain PyTorch version.

The megakernel Program, at W=4 under each scheduler, is held against the
torch Program, which reads the same weights as views of the heap, within
3e-4 at every step, for a dense model, an MoE model (at
``capacity_factor = n_experts``, the dropless convention: the megakernel
never drops a token), a Mamba2 model (the SSD state update and the
causal conv step, kinds 12-13) and qwen2-vl, an embedding-input model
with M-RoPE: each step takes one seeded (B, D) embedding row per
request (a vision frontend's patch embeddings) in place of a token, and
its heap holds no embedding table.  Imports no JAX.
"""
import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))
from repro_torch.api import compile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run at reduced size on the CPU (the megakernel's "
                         "plain version)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None          # the card otherwise
    B, S = 2, 16
    for name in ("deepseek-7b", "granite-moe-1b-a400m", "mamba2-2.7b",
                 "qwen2-vl-2b"):
        cfg = get_config(name).reduced()
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.n_experts))
        for scheduler in ("static", "dynamic"):
            mk = compile(cfg, B, S, backend="megakernel", device=device,
                         num_workers=4, scheduler=scheduler)
            gen = torch.Generator(device=mk.device).manual_seed(0)
            mk.init_weights(gen).init_state()
            ref = compile(cfg, B, S, device=device).bind(mk.weight_views())
            ref.init_state()
            print(f"{cfg.name}: {len(mk.plan.compiled.order)} tasks a "
                  f"launch, W={mk.plan.num_workers} ({scheduler}), "
                  f"{mk.stats['events_post_fusion']} events, "
                  f"{mk.upload_count} heap upload, on {mk.device}")

            rng = np.random.default_rng(0)
            lens = np.zeros((B,), np.int32)

            def embeds():                       # seeded (B, D) embeddings
                return rng.standard_normal((B, cfg.d_model)) \
                    .astype(np.float32)

            toks = embeds() if cfg.embed_input \
                else rng.integers(1, cfg.vocab, size=B).astype(np.int32)
            worst = 0.0
            for i in range(8):
                got, want = mk.step(toks, lens), ref.step(toks, lens)
                err = float(np.abs(got - want).max())
                assert err < 3e-4, (cfg.name, scheduler, i, err)
                worst = max(worst, err)
                toks = embeds() if cfg.embed_input \
                    else want.argmax(axis=-1).astype(np.int32)
                lens += 1
            what = "embedding" if cfg.embed_input else "greedy decode"
            print(f"  8 {what} steps: megakernel within {worst:.2e} "
                  f"of the torch Program")


if __name__ == "__main__":
    main()
