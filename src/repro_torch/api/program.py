"""``Program``: one compile-once / step-many API over the port's two
backends, with the contract of the reference's ``repro.api.Program``.

    prog = compile(cfg, batch=2, max_seq=128, backend="megakernel")
    prog.bind(params)              # weights into the heap, once
    prog.init_state()              # zero the KV cache in place
    logits = prog.step(tokens, seq_lens)        # one decode step
    logits = prog.prefill(chunk, seq_lens, chunk_lens)  # N-token chunks

An embedding-input config (``cfg.embed_input``: qwen2-vl, musicgen) takes
float embeddings in place of token ids: ``step`` (B, D), ``prefill``
(B, N, D); its heap holds no embedding table.  ``positions`` of ``step``
reach the megakernel (``(B, 3)`` temporal/height/width columns under
M-RoPE; ``seq_lens`` in every column when omitted); the torch backend,
like the reference's oracle, ignores them and uses text-mode positions.

Backends:

* ``"torch"``      — the torch model (``models.lm``), the decode oracle;
* ``"megakernel"`` — the hand-written CUDA persistent kernel: one launch
  per decode step against the device-resident heap, W workers (one CTA
  each) synchronised by in-heap event counters (the plain PyTorch
  version of the kernel on a CPU heap).  ``scheduler="static"`` walks
  the compiler's per-worker streams; ``scheduler="dynamic"`` pops ready
  tasks from heap-resident pools, with stealing, and pushes the
  consumers each completed event makes ready.  ``trace=True`` adds the
  trace ring, read back by ``Program.trace()``.  ``tp=C`` compiles
  tensor parallelism over the fused transport: C chips as regions of one
  heap on one card, their ALLREDUCEs run in the kernel as a chunked ring
  (static scheduler only; bitwise equal to ``tp=1``).

``prefill`` runs the torch ``prefill_chunk`` against the program's state
on both: the megakernel program reads the cache out of its heap, runs it
with the weights as views of that heap, and writes the cache back.
Arrays go in as numpy or tensors; ``step`` and ``prefill`` return numpy.
Programs run on ``cuda`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.compile import CompiledTGraph, CompileOptions, megakernelize
from ..core.lowering import build_decode_graph, state_map
from ..device import resolve_device
from ..models.lm import (check_supported, init_cache, prefill_chunk,
                         serve_step)

__all__ = ["BACKENDS", "SCHEDULERS", "Program", "TorchProgram",
           "MegakernelProgram", "compile"]

BACKENDS = ("torch", "megakernel")
SCHEDULERS = ("static", "dynamic")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return str(obj)


class Program:
    """A compiled, stateful decode executable (compile once / step many).

    Subclasses implement ``bind``, ``init_state``, ``step``,
    ``get_state``/``set_state`` and ``reset_slot``; ``prefill`` is
    shared."""

    backend = "abstract"

    def __init__(self, cfg, batch: int, max_seq: int, device):
        check_supported(cfg)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.device = device
        self.step_count = 0
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._compiled: Optional[CompiledTGraph] = None

    # ----------------------------------------------------------- lifecycle
    def bind(self, params: Mapping[str, Any]) -> "Program":
        raise NotImplementedError

    def init_state(self) -> "Program":
        raise NotImplementedError

    def step(self, tokens_or_embeds, seq_lens,
             positions=None) -> np.ndarray:
        """One decode step: tokens (B,), or embeddings (B, D) when
        ``cfg.embed_input``; returns logits (B, V)."""
        raise NotImplementedError

    def get_state(self) -> Dict[str, torch.Tensor]:
        """The KV cache in the ``init_cache`` layout."""
        raise NotImplementedError

    def set_state(self, state: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def reset_slot(self, slot: int) -> None:
        """Zero one batch row's state (serving: slot reuse on admission)."""
        raise NotImplementedError

    # ------------------------------------------------------------- helpers
    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    def _inputs(self, tokens_or_embeds) -> torch.Tensor:
        """Token ids as int64, or embeddings as float32 when
        ``cfg.embed_input``, on the program's device."""
        if self.cfg.embed_input:
            return torch.as_tensor(np.asarray(tokens_or_embeds),
                                   dtype=torch.float32, device=self.device)
        return self._ints(tokens_or_embeds)

    # ------------------------------------------------------------ prefill
    def prefill(self, tokens_or_embeds, seq_lens,
                chunk_lens=None) -> np.ndarray:
        """Consume an N-token chunk per request, tokens (B, N) or
        embeddings (B, N, D) when ``cfg.embed_input``; returns logits
        (B, N, V).  Positions >= ``chunk_lens`` are padding (no state
        written)."""
        assert self._params is not None, "bind() before prefill()"
        tokens = self._inputs(tokens_or_embeds)
        if chunk_lens is None:
            chunk_lens = np.full((self.batch,), tokens.shape[1], np.int64)
        with torch.no_grad():
            logits, state = prefill_chunk(self._params, self.cfg,
                                          self.get_state(), tokens,
                                          self._ints(seq_lens),
                                          self._ints(chunk_lens))
        self.set_state(state)
        return logits.cpu().numpy()

    # -------------------------------------------------------------- stats
    @property
    def compiled(self) -> CompiledTGraph:
        """The compiled tGraph (built lazily for the torch backend)."""
        if self._compiled is None:
            g = build_decode_graph(self.cfg, self.batch, self.max_seq)
            self._compiled = megakernelize(g, CompileOptions())
        return self._compiled

    @property
    def stats(self) -> Dict[str, Any]:
        return self.compiled.stats

    @property
    def pipeline_stats(self) -> Dict[str, Any]:
        """Compiler side of the schedule→kernel contract: stalls at the
        configured pipeline depth and the reduction over naive order."""
        s = self.compiled.stats
        return {
            "stalls": s.get("pipeline_stalls", 0),
            "stalls_naive": s.get("pipeline_stalls_naive",
                                  s.get("pipeline_stalls", 0)),
            "stall_reduction": s.get("stall_reduction", 1.0),
            "pipeline_depth": s.get("pipeline_depth", 2),
        }

    def describe(self) -> Dict[str, Any]:
        c = self.compiled
        return {
            "backend": self.backend,
            "arch": self.cfg.name,
            "batch": self.batch,
            "max_seq": self.max_seq,
            "device": str(self.device),
            "ops": len(c.graph.ops),
            "tasks": c.tg.num_tasks(),
            "events": c.stats["events_post_fusion"],
            "workspace_elements": c.stats["workspace_elements"],
        }

    def metrics_snapshot(self, serving: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Program identity, compiler stats, the pipeline contract and, when
        a serving engine passes its summary, its latency percentiles."""
        snap: Dict[str, Any] = {
            "program": self.describe(),
            "compiler": dict(self.stats),
            "pipeline": self.pipeline_stats,
            "step_count": self.step_count,
        }
        if serving is not None:
            snap["serving"] = dict(serving)
        return _jsonable(snap)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Program<{self.backend}>({self.cfg.name}, "
                f"batch={self.batch}, max_seq={self.max_seq}, "
                f"device={self.device})")


class TorchProgram(Program):
    """The torch model as a Program: the decode oracle of the port."""

    backend = "torch"

    def __init__(self, cfg, batch, max_seq, device):
        super().__init__(cfg, batch, max_seq, device)
        self._cache: Optional[Dict[str, torch.Tensor]] = None

    def bind(self, params) -> "Program":
        """Keep the weights; tensors already on the device as float32
        (e.g. views of a megakernel heap) are used as they are."""
        self._params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                        for k, v in params.items()}
        return self

    def init_state(self) -> "Program":
        self._cache = init_cache(self.cfg, self.batch, self.max_seq,
                                 device=self.device)
        return self

    def get_state(self):
        assert self._cache is not None, "init_state() first"
        return self._cache

    def set_state(self, state) -> None:
        self._cache = {k: torch.as_tensor(v).to(self.device, torch.float32)
                       for k, v in state.items()}

    def step(self, tokens_or_embeds, seq_lens,
             positions=None) -> np.ndarray:
        """``positions`` is ignored: the oracle uses text-mode positions
        (``seq_lens``), as the reference's does."""
        assert self._params is not None, "bind() first"
        with torch.no_grad():
            logits, self._cache = serve_step(self._params, self.cfg,
                                             self.get_state(),
                                             self._inputs(tokens_or_embeds),
                                             self._ints(seq_lens))
        self.step_count += 1
        return logits.cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        for leaf in self.get_state().values():
            leaf[:, :, slot].zero_()


class MegakernelProgram(Program):
    """The persistent CUDA megakernel as a Program (``megakernel/``)."""

    backend = "megakernel"

    def __init__(self, cfg, batch, max_seq, device, num_workers: int = 1,
                 trace: bool = False, scheduler: str = "static",
                 tp: int = 1):
        super().__init__(cfg, batch, max_seq, device)
        from ..megakernel import MegakernelExecutor, compile_decode_megakernel
        self.scheduler = scheduler
        self.plan = compile_decode_megakernel(cfg, batch, max_seq,
                                              num_workers=num_workers,
                                              scheduler=scheduler, tp=tp,
                                              trace=trace)
        self._compiled = self.plan.compiled
        self.executor = MegakernelExecutor(self.plan, cfg, device)
        self._smap = state_map(cfg)

    @property
    def upload_count(self) -> int:
        return self.executor.upload_count

    @property
    def pipeline_stats(self) -> Dict[str, Any]:
        """Compiler stats + the prefetch plan's coverage + — once a step
        has run — the kernel's own counters of the last step."""
        out = dict(Program.pipeline_stats.fget(self))
        out.update(self.plan.pipeline_stats())
        if self.step_count > 0:
            out.update(self.executor.pipeline_counters())
        return out

    @property
    def worker_stats(self) -> Dict[str, Any]:
        """The W-worker schedule: the compiler's partition (queue
        lengths, the cross-worker dependency cut, its estimated makespan
        and per-worker utilization under the reference's cost model) and,
        once a step has run, the kernel's own per-worker counters of the
        last step with the event totals.  Under the dynamic scheduler it
        adds the protocol's static numbers (``_dyn_sched_stats``) and,
        after a step, the kernel's queue cursors and pop sources."""
        part = self.plan.compiled.partition
        out: Dict[str, Any] = {
            "scheduler": self.scheduler,
            "num_workers": part.num_workers,
            "requested_workers": part.requested_workers,
            "queue_lens": [len(q) for q in part.queues],
            "cross_worker_deps": len(part.cross_deps),
            "partition_steps": part.num_steps,
            "num_events": self.plan.num_events,
            "partition_makespan_est_us": part.est_makespan * 1e6,
            "worker_utilization": part.worker_utilization(),
        }
        if self.step_count > 0:
            per_worker = self.executor.worker_counters()
            out["kernel_workers"] = per_worker
            for k in ("event_waits", "event_wait_violations",
                      "event_signals"):
                out[k] = sum(d[k] for d in per_worker)
        if self.plan.dynamic:
            out.update(self._dyn_sched_stats())
            if self.step_count > 0:
                out.update({f"kernel_{k}": v for k, v in
                            self.executor.scheduler_counters().items()})
        return out

    def _dyn_sched_stats(self) -> Dict[str, Any]:
        """The dynamic scheduler's numbers that depend only on the plan,
        computed once: the ``mpk_dyn`` makespan under the reference's
        cost model and the sequential replay's pool depths and pop
        sources (what the plain version does), both in Python over every
        pop."""
        if getattr(self, "_dyn_stats_cache", None) is None:
            from ..core.runtime_sim import SimConfig, simulate
            from ..runtime.dyn_sched import replay_sequential
            part = self.plan.compiled.partition
            depth = self.plan.compiled.stats.get("pipeline_depth", 2)
            dres = simulate(self.plan.compiled,
                            SimConfig(mode="mpk_dyn",
                                      n_workers=part.requested_workers,
                                      pipeline_depth=depth))
            tr = replay_sequential(self.plan.dyn)
            self._dyn_stats_cache = {
                "dyn_sim_makespan_us": dres.makespan * 1e6,
                "queue_max_depth": tr.max_depth,
                "replay_pops_own": tr.pops_own,
                "replay_pops_overflow": tr.pops_overflow,
                "replay_steals": tr.steals,
            }
        return self._dyn_stats_cache

    def trace(self):
        """The kernel-written trace ring of the LAST step as an
        ``obs.TaskTrace`` (logical ticks).  Needs ``trace=True`` at
        compile and at least one step."""
        from ..obs import decode_ring
        if not self.plan.trace:
            raise ValueError("program compiled without trace=True: the "
                             "kernel wrote no trace ring")
        if self.step_count == 0:
            raise ValueError("no step executed yet: the trace ring is "
                             "empty; run step() first")
        return decode_ring(self.plan, self.executor.task_ring())

    def bind(self, params) -> "Program":
        """Write the weights into the heap, exactly once; prefill then
        reads them as views of the heap."""
        self.executor.bind({k: torch.as_tensor(v) for k, v in params.items()})
        self._params = self.executor.weight_views()
        return self

    def init_weights(self, generator: torch.Generator) -> "Program":
        """``bind`` with random weights drawn straight into the heap."""
        self.executor.init_weights(generator)
        self._params = self.executor.weight_views()
        return self

    def weight_views(self) -> Dict[str, torch.Tensor]:
        """The weights as strided views of the heap (no copy)."""
        return self.executor.weight_views()

    def init_state(self) -> "Program":
        self.executor.reset_state()
        return self

    def step(self, tokens_or_embeds, seq_lens,
             positions=None) -> np.ndarray:
        """One launch; ``positions`` (B,) or, under M-RoPE, (B, 3)
        override ``seq_lens`` as the rotary positions."""
        logits = self.executor.step(tokens_or_embeds, seq_lens, positions)
        self.step_count += 1
        return logits.cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        self.executor.reset_state(slot)

    def get_state(self):
        tensors = self.executor.read_state()
        state = init_cache(self.cfg, self.batch, self.max_seq,
                           device=self.device)
        for ent in self._smap:
            leaf = state[ent["key"]][ent["blk"], ent["idx"]]
            leaf.copy_(tensors[ent["in"]].reshape(leaf.shape))
        return state

    def set_state(self, state) -> None:
        g = self.plan.compiled.graph
        tensors = {}
        for ent in self._smap:
            leaf = torch.as_tensor(state[ent["key"]])[ent["blk"], ent["idx"]]
            tensors[ent["in"]] = leaf.reshape(g.spec(ent["in"]).shape)
        self.executor.write_state(tensors)


def compile(cfg, batch: int, max_seq: int, backend: str = "torch", *,
            device=None, num_workers: int = 1, scheduler: str = "static",
            tp: int = 1, trace: bool = False) -> Program:
    """Compile ``cfg``'s decode step once; returns a stateful
    :class:`Program` for ``backend`` ("torch" | "megakernel") on
    ``device`` (the card unless ``device="cpu"``; with no card and no
    device this raises).  The compiler runs with the reference's default
    options.  For the megakernel, ``num_workers`` is the most workers the
    partitioner may use (one CTA each on the card), ``scheduler`` is
    "static" (the partition's per-worker streams) or "dynamic" (ready
    pools with stealing, the partition as the affinity hint) and
    ``trace`` adds the trace ring; the torch backend ignores all three
    (``num_workers < 1`` raises ``ValueError`` on both backends).
    ``tp`` (megakernel only) is the tensor-parallel degree: the plan is
    stamped for ``tp`` chips over the fused transport, and its ``tp *
    num_workers`` lanes must fit on the card at once."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         f"expected one of {SCHEDULERS}")
    device = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if backend == "megakernel":
        return MegakernelProgram(cfg, batch, max_seq, device, num_workers,
                                 trace, scheduler, tp)
    if tp != 1:
        raise ValueError(f"tp={tp} is only supported on the megakernel "
                         "backend")
    return TorchProgram(cfg, batch, max_seq, device)
