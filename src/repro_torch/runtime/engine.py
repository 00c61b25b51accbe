"""Continuous-batching serving engine (paper §6.1): chunked prefill,
page-pressure preemption, per-request latency metrics — driving a
backend-agnostic compiled :class:`repro_torch.api.Program`.  The port's
copy of ``repro/runtime/engine.py``; only the Program it drives differs.

Every iteration: (1) retire finished requests, (2) admit newly arrived
ones (slot-gated only — page pressure is resolved by preemption, not by
blocking admission; the admitted slot's stale cache/SSM state is zeroed
through ``Program.reset_slot``), (3) plan a per-slot token chunk under a
shared iteration token budget (decode slots first, then prefill chunks
FCFS), (4) evict the lowest-priority request back to ``waiting`` if the
planned growth exceeds the free page quota, then (5) run ONE program
call over the whole batch: iterations where every running request
decodes exactly one token dispatch to ``Program.step`` — for the
megakernel backend that is a single persistent-kernel launch against the
device-resident heap — and mixed prefill/decode iterations dispatch to
``Program.prefill`` (decode slots are 1-token chunks), through the exact
same cache-write machinery, so mixing phases never changes any request's
sampled stream.  Like the paper's per-batch-size tGraph specialization,
the program caches jitted prefill functions keyed by the power-of-two
chunk width and the engine dispatches to the smallest width that fits.

Preemption is recompute-style: an evicted request's KV quota is dropped
and on re-admission it replays ``prompt + output`` through prefill — the
last sampled (not yet consumed) token is the final replayed position, so
its logits seed the next decode step exactly as if nothing happened.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from .kv_cache import PagedKVCache

__all__ = ["Request", "RequestMetrics", "ServingEngine"]


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock latency milestones, all relative to the engine epoch."""
    arrival_s: float = 0.0
    first_sched_s: Optional[float] = None   # first admitted to a slot
    first_token_s: Optional[float] = None   # TTFT endpoint
    finish_s: Optional[float] = None
    n_preemptions: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def queue_s(self) -> Optional[float]:
        if self.first_sched_s is None:
            return None
        return self.first_sched_s - self.arrival_s

    def tpot_s(self, n_tokens: int) -> Optional[float]:
        """Mean time-per-output-token over the decode phase."""
        if self.first_token_s is None or self.finish_s is None \
                or n_tokens < 2:
            return None
        return (self.finish_s - self.first_token_s) / (n_tokens - 1)


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    arrival_time: float = 0.0   # offset from engine epoch (workload replay)
    priority: Optional[int] = None  # lower = more important; default FCFS
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


class ServingEngine:
    """Single-host engine driving a compiled backend-agnostic ``Program``.

    The program supplies the model, the weights and the resident
    cache/state; the engine owns scheduling only.  Construct one with
    ``ServingEngine(program, ...)`` where ``program`` came from
    ``repro_torch.api.compile(cfg, batch, max_seq, backend=...)`` and has
    been ``bind()``-ed, or use :meth:`from_model` for the
    ``(cfg, params)`` form (a torch-backend program is compiled for you).

    ``prefill_mode="chunked"`` (default) consumes up to ``chunk`` prompt
    tokens per iteration per prefilling request; ``"token"`` pins the
    chunk width to 1, reproducing the legacy token-by-token prefill as a
    baseline — both modes produce identical greedy streams, only the
    schedule differs.  (MoE configs: expert capacity scales with the
    iteration token count, so stream equality additionally requires a
    dropless ``capacity_factor`` — e.g. ``n_experts`` — as the dense
    dispatch drops different tokens at different chunk widths.)
    ``token_budget`` caps the total tokens (decode + prefill) consumed
    per iteration across the batch.
    """

    def __init__(self, program, *, page_size: int = 32,
                 greedy: bool = True, chunk: int = 16,
                 token_budget: Optional[int] = None,
                 prefill_mode: str = "chunked",
                 total_pages: Optional[int] = None):
        assert prefill_mode in ("chunked", "token"), prefill_mode
        from ..api import Program  # late: keep runtime importable alone
        assert isinstance(program, Program), (
            "ServingEngine consumes a compiled repro_torch.api.Program; "
            "build one with repro_torch.api.compile(...) (or "
            "ServingEngine.from_model for the (cfg, params) form)")
        self.program = program
        self.cfg = program.cfg
        max_slots, max_seq = program.batch, program.max_seq
        self.kv = PagedKVCache(max_slots, max_seq, page_size,
                               total_pages=total_pages)
        program.init_state()
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.greedy = greedy
        self.chunk = 1 if prefill_mode == "token" else max(1, chunk)
        self.token_budget = (token_budget if token_budget is not None
                             else max_slots + self.chunk)
        if self.token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1, got {self.token_budget} "
                "(a zero budget schedules no tokens and the engine spins)")
        self.iterations = 0
        self.decode_iterations = 0    # iterations served by Program.step
        self._slot_tokens = np.zeros((max_slots,), np.int64)
        self._pending_prefill: Dict[int, List[int]] = {}
        # rid -> earliest scheduler tick for re-admission after a
        # preemption (exponential hold-off so a page-starved request
        # doesn't cycle admit -> evict every iteration, zero progress).
        # Ticks count every step() call, idle ones included, so a
        # hold-off always expires even while nothing is running.
        self._backoff: Dict[int, int] = {}
        self._ticks = 0
        self._submit_seq = 0
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- public
    @classmethod
    def from_model(cls, cfg, params, *, max_slots: int = 8,
                   max_seq: int = 128, backend: str = "torch",
                   device=None, **kw) -> "ServingEngine":
        """Construction from ``(cfg, params)``: compiles a Program for
        ``backend`` on ``device`` and binds the weights."""
        from ..api import compile as mpk_compile
        program = mpk_compile(cfg, max_slots, max_seq, backend=backend,
                              device=device).bind(params)
        return cls(program, **kw)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                f"request {req.request_id}: empty prompt — there is no "
                "position to sample the first token from")
        if len(req.prompt) + req.max_new_tokens > self.kv.max_seq:
            raise ValueError(
                f"request {req.request_id}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds max_seq "
                f"({self.kv.max_seq})")
        if req.priority is None:
            req.priority = self._submit_seq
        self._submit_seq += 1
        if req.arrival_time == 0.0:
            # live submission: measure TTFT/queue from now, not from the
            # engine epoch (workload replay sets arrival_time explicitly)
            req.arrival_time = self._now()
        req.metrics.arrival_s = req.arrival_time
        self.waiting.append(req)

    # ---------------------------------------------------------- scheduling
    def _plan(self) -> Dict[int, int]:
        """Tokens per running request this iteration under the shared
        budget: decode slots first (1 each, latency-critical), then
        prefill chunks, both in priority/FCFS order."""
        order = sorted(self.running.values(),
                       key=lambda r: (r.priority, r.request_id))
        budget = self.token_budget
        plan: Dict[int, int] = {}
        for req in order:
            if not self._pending_prefill.get(req.request_id):
                n = 1 if budget > 0 else 0
                plan[req.request_id] = n
                budget -= n
        for req in order:
            pending = self._pending_prefill.get(req.request_id)
            if pending:
                n = min(len(pending), self.chunk, max(budget, 0))
                plan[req.request_id] = n
                budget -= n
        return plan

    def _preempt(self, req: Request) -> None:
        """Evict back to the waiting queue (recompute-style): the replay
        stream ``prompt + output`` is rebuilt at re-admission."""
        self.kv.evict(req.request_id)
        req.slot = -1
        req.metrics.n_preemptions += 1
        self._pending_prefill.pop(req.request_id, None)
        del self.running[req.request_id]
        self._backoff[req.request_id] = self._ticks + min(
            32, 2 ** req.metrics.n_preemptions)
        self.waiting.append(req)  # admission re-sorts by (arrival, priority)

    def _resolve_page_pressure(self, plan: Dict[int, int]) -> None:
        """Evict lowest-priority requests until the planned growth fits
        the free page quota; a sole survivor shrinks its chunk instead."""
        def deficit() -> int:
            need = sum(self.kv.pages_needed(rid, n)
                       for rid, n in plan.items() if n)
            return need - self.kv.free_pages

        while deficit() > 0 and len(self.running) > 1:
            victim = max(self.running.values(),
                         key=lambda r: (r.priority, r.request_id))
            self._preempt(victim)
            plan.pop(victim.request_id, None)
        if deficit() > 0:
            (rid,) = self.running.keys()
            n = plan.get(rid, 0)
            while n > 1 and deficit() > 0:
                n -= 1
                plan[rid] = n
            assert deficit() <= 0, (
                "single request exceeds the physical page quota; "
                "max_seq/page_size misconfigured")

    # --------------------------------------------------------------- step
    def step(self) -> int:
        """One serving iteration; returns number of live requests."""
        self._ticks += 1
        now = self._now()
        # (1) retire finished
        for rid in [r for r, q in self.running.items() if q.done]:
            req = self.running.pop(rid)
            self.kv.release(rid)
            req.metrics.finish_s = now
            self.finished.append(req)
        # (2) admit arrived requests while slots are free (page pressure
        # is handled by preemption below, not by blocking admission)
        self.waiting.sort(key=lambda r: (r.arrival_time, r.priority))
        while self.kv.has_free_slot and self.kv.free_pages > 0:
            req = next(
                (r for r in self.waiting if r.arrival_time <= now
                 and self._backoff.get(r.request_id, 0) <= self._ticks),
                None)
            if req is None:
                break
            self.waiting.remove(req)
            self._backoff.pop(req.request_id, None)
            req.slot = self.kv.admit(req.request_id, 0)
            # slot reuse: zero the slot's cache/conv/SSM state so the new
            # (or replayed) request never sees a predecessor's state
            self.program.reset_slot(req.slot)
            self.running[req.request_id] = req
            # replay stream: prompt plus anything sampled before a
            # preemption (empty output for fresh requests)
            self._pending_prefill[req.request_id] = \
                list(req.prompt) + list(req.output)
            if req.metrics.first_sched_s is None:
                req.metrics.first_sched_s = now
        if not self.running:
            return 0  # idle poll: not a serving iteration
        self.iterations += 1
        # (3) plan chunks under the token budget, (4) resolve page pressure
        plan = self._plan()
        self._resolve_page_pressure(plan)
        maxn = max(plan.values(), default=0)
        if maxn == 0:
            return len(self.running)
        # (5) one batched program call; width padded to a power of two so
        # the jit cache stays small (padding is masked via chunk_lens)
        n_pad = 1 << (maxn - 1).bit_length()
        tokens = np.zeros((self.kv.n_slots, n_pad), np.int32)
        chunk_lens = np.zeros((self.kv.n_slots,), np.int32)
        seq_lens = np.asarray(self.kv.seq_lens(), np.int32)
        # every running request decoding exactly one token -> the pure
        # decode path, served inside the backend (for the megakernel this
        # is one persistent-kernel launch; free slots are reset at admit)
        pure_decode = (not self._pending_prefill
                       and all(plan.get(rid, 0) == 1 for rid in self.running))
        for rid, n in plan.items():
            if n == 0:
                continue
            req = self.running[rid]
            pending = self._pending_prefill.get(rid)
            if pending:
                tokens[req.slot, :n] = pending[:n]
                del pending[:n]
                if not pending:
                    del self._pending_prefill[rid]
            else:
                tokens[req.slot, 0] = self._slot_tokens[req.slot]
            chunk_lens[req.slot] = n
        if pure_decode:
            logits = self.program.step(tokens[:, 0], seq_lens)[:, None]
            self.decode_iterations += 1
        else:
            logits = self.program.prefill(tokens, seq_lens, chunk_lens)
        # (6) sample + bookkeeping: a request samples only once its whole
        # replay stream has been consumed (logits of its LAST fed token)
        t_done = self._now()
        for rid, n in plan.items():
            if n == 0:
                continue
            req = self.running[rid]
            self.kv.advance_n(rid, n)
            if rid not in self._pending_prefill:
                nxt = int(np.argmax(logits[req.slot, n - 1]))
                req.output.append(nxt)
                self._slot_tokens[req.slot] = nxt
                if req.metrics.first_token_s is None:
                    req.metrics.first_token_s = t_done
        return len(self.running)

    # ---------------------------------------------------------------- run
    def run(self, max_iterations: int = 10_000) -> List[Request]:
        while (self.waiting or self.running) and \
                self.iterations < max_iterations:
            if not self.running and self.waiting:
                wait = min(r.arrival_time for r in self.waiting) - self._now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
            self.step()
        return self.finished

    # ------------------------------------------------------------ metrics
    def metrics_summary(self) -> Dict[str, float]:
        """Aggregate TTFT / TPOT / queue-time over finished requests."""
        ms = [r.metrics for r in self.finished]
        ttft = [m.ttft_s for m in ms if m.ttft_s is not None]
        queue = [m.queue_s for m in ms if m.queue_s is not None]
        tpot = [m.tpot_s(len(r.output)) for r, m in
                zip(self.finished, ms) if m.tpot_s(len(r.output)) is not None]

        def stats(tag, vals):
            if not vals:
                return {}
            a = np.asarray(vals)
            return {f"{tag}_mean_s": float(a.mean()),
                    f"{tag}_p50_s": float(np.percentile(a, 50)),
                    f"{tag}_p95_s": float(np.percentile(a, 95))}

        out = {"n_finished": float(len(ms)),
               "iterations": float(self.iterations),
               "decode_iterations": float(self.decode_iterations),
               "preemptions": float(sum(m.n_preemptions for m in ms))}
        out.update(stats("ttft", ttft))
        out.update(stats("queue", queue))
        out.update(stats("tpot", tpot))
        return out

    def metrics_snapshot(self) -> Dict[str, float]:
        """The unified end-of-run snapshot: the program's
        ``metrics_snapshot`` (compiler stats, pipeline contract, kernel
        worker/scheduler counters) joined with this engine's serving
        latency summary — one JSON-ready dict for scripting
        (``mpk-serve --metrics-json``)."""
        return self.program.metrics_snapshot(
            serving=self.metrics_summary())
