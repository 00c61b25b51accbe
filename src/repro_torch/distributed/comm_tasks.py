"""Chunked ring-allreduce planner: the COMM-task subsystem's source of
truth, the port's copy of the reference's
``repro/distributed/comm_tasks.py`` (numpy only; the cost model from the
port's ``roofline/hw.py``).

Every ``OpKind.ALLREDUCE`` task of a TP-sharded tGraph is expanded into a
fixed per-chip sequence of COMM tasks — ``REMOTE_COPY`` (neighbour send)
and ``ALLREDUCE_CHUNK`` (owner-mask init / accumulate / store on
arrival) — that both consumers of this module execute in lockstep:

* ``megakernel/desc.stamp_multichip`` lowers the expansion to descriptor
  rows of each chip's task table (inserted as full-width grid steps,
  synchronized through cross-chip event counters in the shared event
  table), and
* ``core/runtime_sim.simulate(mode="mpk_tp")`` charges the same
  expansion's rounds per collective.

Protocol (classic 2-phase ring over ``C`` chips, ``C`` contiguous chunks
of the collective's span, chunk ``j`` *owned* by chip ``j``).  The
chunked span is the collective's REAL row width in words — the desc
stamper applies each chunk as a column window to every row of the tile,
so the ld-alignment pad columns never enter the partition:

* **init** (step 0): chip ``c`` copies its replicated input span into the
  collective's output span, keeping values only inside its owned chunk
  and zeroing the rest.  The TP model keeps global shapes (every chip
  computes the full tensor; AllReduce is numerically an identity), so
  owner-masked partials make the ring's reduction *exact*: each word is
  contributed by exactly one chip and ``x + 0.0 == x`` bitwise — TP ∈
  {1, 2, 4} outputs stay bit-identical.
* **reduce-scatter** round ``r`` (steps ``1+2r`` / ``2+2r``, ``r ∈ [0,
  C-2]``): chip ``c`` sends chunk ``(c-r) % C`` to chip ``(c+1) % C``'s
  phase-0 staging buffer and signals the receiver's event; the receiver
  accumulates the staged chunk into its output span.  After the last
  round chip ``c`` holds the complete chunk ``(c+1) % C``.
* **all-gather** round ``r`` (steps ``2C-1+2r`` / ``2C+2r``): chip ``c``
  sends its complete chunk ``(c+1-r) % C`` to the neighbour's phase-1
  staging buffer; the receiver stores it.  ``4C-3`` steps total.

Every receive's matching send sits at a strictly earlier step, so the
step-major execution of the stamped grid is dependency-safe for any
worker order within a step.  A (chip, phase) staging buffer holds one
chunk: the ``C - 1`` rounds of a phase reuse it, which step-major order
makes safe.  Where chips run ahead of each other (the CUDA kernel), a
send of round ``r >= 1`` must first see the receiver's round ``r - 1``
arrival done; ``desc.stamp_multichip`` adds those port-only counters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np

from ..roofline.hw import comm_time

__all__ = ["CommTask", "MODE_INIT", "MODE_ACC", "MODE_STORE",
           "n_ring_steps", "n_comm_events", "ring_chunks",
           "expand_ring_allreduce", "send_rounds", "ring_duration",
           "serialized_duration", "ref_ring_allreduce"]

#: ``ALLREDUCE_CHUNK`` arrival modes (descriptor word 14)
MODE_INIT = 0      # owner-masked copy input → output span
MODE_ACC = 1       # output chunk += staged chunk (reduce-scatter arrival)
MODE_STORE = 2     # output chunk = staged chunk (all-gather arrival)


def n_ring_steps(n_chips: int) -> int:
    """Grid steps one collective expands into (1 init + 2(C-1) send/recv
    pairs per phase × 2 phases = ``4C-3``); 1 when C == 1 (identity)."""
    return 1 if n_chips <= 1 else 4 * n_chips - 3


def n_comm_events(n_chips: int) -> int:
    """Cross-chip event counters one collective needs: one per receive
    (trigger count 1), ``2(C-1)`` receives on each of ``C`` chips."""
    return 0 if n_chips <= 1 else 2 * (n_chips - 1) * n_chips


def ring_chunks(span_words: int, n_chips: int) -> List[Tuple[int, int]]:
    """Split a contiguous ``span_words`` span into C ``(start, length)``
    chunks; the tail chunk absorbs the remainder (possibly length 0)."""
    s = -(-span_words // n_chips)
    return [(j * s, max(0, min((j + 1) * s, span_words) - j * s))
            for j in range(n_chips)]


@dataclasses.dataclass(frozen=True)
class CommTask:
    """One step of a collective's per-chip expansion, span-relative.

    ``kind`` is ``"init"`` / ``"send"`` / ``"recv"``; sends lower to
    ``REMOTE_COPY`` descriptors, init/recv to ``ALLREDUCE_CHUNK``.
    ``start``/``nwords`` locate the moved chunk inside the collective's
    span; ``phase`` is 0 (reduce-scatter) or 1 (all-gather) and selects
    the receiver-side staging buffer; event ids are collective-relative
    (the desc stamper and the simulator add their own bases).
    """
    kind: str
    chip: int
    step: int            # 0 .. n_ring_steps-1, relative grid step
    chunk: int           # chunk index within the collective
    start: int           # span-relative word offset of the chunk
    nwords: int
    phase: int = 0       # staging phase the chunk moves through
    peer: int = -1       # dst chip for sends, src chip for recvs
    wait_ev: int = -1    # collective-relative event this task waits on
    sig_ev: int = -1     # collective-relative event this task signals
    mode: int = MODE_INIT   # ALLREDUCE_CHUNK arrival mode (init/recv)
    own_start: int = 0   # init only: owned span start (span-relative)
    own_len: int = 0     # init only: owned span length


def expand_ring_allreduce(span_words: int, n_chips: int
                          ) -> List[CommTask]:
    """The full per-chip task sequence of one chunked ring allreduce.

    Returns ``C * n_ring_steps(C)`` tasks (``C`` at each relative step).
    At ``n_chips == 1`` the expansion degenerates to the identity init —
    exactly the single-chip lowering of ``OpKind.ALLREDUCE``.
    """
    C = n_chips
    if C <= 1:
        return [CommTask("init", 0, 0, 0, 0, span_words,
                         mode=MODE_INIT, own_start=0, own_len=span_words)]
    chunks = ring_chunks(span_words, C)
    ev_rs = lambda r, chip: r * C + chip                 # reduce recv
    ev_ag = lambda r, chip: (C - 1) * C + r * C + chip   # gather recv
    out: List[CommTask] = []
    for c in range(C):
        own0, ownl = chunks[c]
        out.append(CommTask("init", c, 0, c, 0, span_words,
                            mode=MODE_INIT, own_start=own0, own_len=ownl))
        for r in range(C - 1):
            j = (c - r) % C                      # chunk sent this round
            out.append(CommTask(
                "send", c, 1 + 2 * r, j, chunks[j][0], chunks[j][1],
                phase=0, peer=(c + 1) % C,
                sig_ev=ev_rs(r, (c + 1) % C)))
            j = (c - 1 - r) % C                  # chunk arriving
            out.append(CommTask(
                "recv", c, 2 + 2 * r, j, chunks[j][0], chunks[j][1],
                phase=0, peer=(c - 1) % C,
                wait_ev=ev_rs(r, c), mode=MODE_ACC))
        for r in range(C - 1):
            j = (c + 1 - r) % C                  # complete chunk onward
            out.append(CommTask(
                "send", c, 2 * C - 1 + 2 * r, j, chunks[j][0],
                chunks[j][1], phase=1, peer=(c + 1) % C,
                sig_ev=ev_ag(r, (c + 1) % C)))
            j = (c - r) % C
            out.append(CommTask(
                "recv", c, 2 * C + 2 * r, j, chunks[j][0], chunks[j][1],
                phase=1, peer=(c - 1) % C,
                wait_ev=ev_ag(r, c), mode=MODE_STORE))
    return out


def send_rounds(span_words: int, n_chips: int) -> List[int]:
    """Per transfer round, the widest chunk (words) on the wire — every
    chip transfers concurrently within a round, so the round's duration
    is governed by its largest chunk.  ``2(C-1)`` rounds."""
    tasks = expand_ring_allreduce(span_words, n_chips)
    rounds: dict = {}
    for t in tasks:
        if t.kind == "send":
            rounds[t.step] = max(rounds.get(t.step, 0), t.nwords)
    return [rounds[s] for s in sorted(rounds)]


def ring_duration(span_words: int, n_chips: int, *, word_bytes: int = 4,
                  time_fn: Callable[[float], float] = comm_time) -> float:
    """Wall-clock of the chunked ring (rounds are sequential; chips
    transfer in parallel within a round) — what ``mode="mpk_tp"``
    charges one collective."""
    return sum(time_fn(w * word_bytes)
               for w in send_rounds(span_words, n_chips))


def serialized_duration(span_words: int, n_chips: int, *,
                        word_bytes: int = 4,
                        time_fn: Callable[[float], float] = comm_time
                        ) -> float:
    """The whole-tensor baseline the ring is compared against (fig13):
    a serialized allreduce moves the full span twice over the wire
    (reduce to root, broadcast back) with no chunking, so consumers
    block on ``2 × comm_time(full bytes)``."""
    if n_chips <= 1:
        return 0.0
    return 2 * time_fn(span_words * word_bytes)


def ref_ring_allreduce(shards: Sequence[np.ndarray]
                       ) -> List[np.ndarray]:
    """Numpy reference of the exact protocol (staging buffers, event
    ordering, owner-masked init) — the oracle the desc/kernel tests pin
    the in-kernel execution against.  ``shards[c]`` is chip ``c``'s
    replicated input span; returns each chip's output span after the
    ring (all identical, each word taken from its owner chip)."""
    C = len(shards)
    span = int(shards[0].size)
    tasks = expand_ring_allreduce(span, C)
    out = [np.zeros(span, shards[0].dtype) for _ in range(C)]
    stage = [[np.zeros(span, shards[0].dtype) for _ in range(2)]
             for _ in range(C)]
    events: dict = {}
    for step in range(n_ring_steps(C)):
        for t in [x for x in tasks if x.step == step]:
            sl = slice(t.start, t.start + t.nwords)
            if t.kind == "init":
                osl = slice(t.own_start, t.own_start + t.own_len)
                out[t.chip][osl] = shards[t.chip][osl]
            elif t.kind == "send":
                stage[t.peer][t.phase][sl] = out[t.chip][sl]
                events[t.sig_ev] = events.get(t.sig_ev, 0) + 1
            else:                                 # recv
                assert events.get(t.wait_ev, 0) == 1, \
                    f"event {t.wait_ev} not triggered before step {step}"
                staged = stage[t.chip][t.phase][sl]
                if t.mode == MODE_ACC:
                    out[t.chip][sl] = out[t.chip][sl] + staged
                else:
                    out[t.chip][sl] = staged
    return out
