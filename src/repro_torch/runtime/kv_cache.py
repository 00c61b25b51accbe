"""Paged KV-cache manager (paper §6.1: paged attention + in-kernel page
allocation).

Physical cache layout stays the dense (nb, na, B_slots, S_max, KV, hd)
arrays the models consume; *logical* requests are mapped onto batch slots
and page-granular sequence quota by this allocator.  Matching the paper,
page allocation is metadata-only (no tensor copies): admitting/evicting a
request flips slot ownership and the per-slot ``seq_lens`` entry, which is
exactly the state the paper's scheduler updates when "processing the start
event of a tGraph".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["PagedKVCache"]


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    seq_len: int = 0


class PagedKVCache:
    """Slot + page bookkeeping over a fixed (B_slots, S_max) physical cache."""

    def __init__(self, n_slots: int, max_seq: int, page_size: int = 256,
                 total_pages: Optional[int] = None):
        """``total_pages`` below the dense worst case ``n_slots *
        max_seq/page_size`` oversubscribes the pool (the realistic serving
        regime): slots then compete for quota and the engine resolves
        pressure by preempting, exactly as the paper's in-kernel page
        allocator blocks a tGraph start event until pages free up."""
        if max_seq % page_size != 0:
            raise ValueError(
                f"page_size ({page_size}) must divide max_seq ({max_seq})")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        dense = n_slots * (max_seq // page_size)
        if total_pages is not None:
            # the pool must at least hold one full-length request, or a
            # sole survivor could hit pressure with nothing left to evict
            if total_pages < max_seq // page_size:
                raise ValueError(
                    f"total_pages ({total_pages}) must cover one full "
                    f"request: >= max_seq/page_size = "
                    f"{max_seq // page_size}")
            self.total_pages = min(total_pages, dense)
        else:
            self.total_pages = dense
        self.slots: List[_Slot] = [_Slot() for _ in range(n_slots)]
        self.by_request: Dict[int, int] = {}

    # -------------------------------------------------------------- pages
    def pages_of(self, seq_len: int) -> int:
        return -(-max(seq_len, 1) // self.page_size)

    @property
    def used_pages(self) -> int:
        return sum(self.pages_of(s.seq_len) for s in self.slots
                   if s.request_id is not None)

    @property
    def free_pages(self) -> int:
        return self.total_pages - self.used_pages

    # -------------------------------------------------------------- admit
    @property
    def has_free_slot(self) -> bool:
        return any(s.request_id is None for s in self.slots)

    def can_admit(self, prompt_len: int) -> bool:
        return (self.has_free_slot
                and self.pages_of(prompt_len) <= self.free_pages
                and prompt_len < self.max_seq)

    def admit(self, request_id: int, prompt_len: int) -> int:
        """Assign a slot; returns the slot index."""
        assert self.can_admit(prompt_len), "admission check failed"
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                s.request_id = request_id
                s.seq_len = prompt_len
                self.by_request[request_id] = i
                return i
        raise RuntimeError("unreachable")

    def advance(self, request_id: int) -> int:
        """One decoded token; returns the new seq_len."""
        return self.advance_n(request_id, 1)

    def advance_n(self, request_id: int, n: int) -> int:
        """n consumed tokens (chunked prefill); returns the new seq_len."""
        s = self.slots[self.by_request[request_id]]
        s.seq_len += n
        assert s.seq_len <= self.max_seq
        return s.seq_len

    def pages_needed(self, request_id: int, n_new: int) -> int:
        """Extra pages this request must acquire to grow by ``n_new``
        tokens (0 when the growth fits in its current last page)."""
        s = self.slots[self.by_request[request_id]]
        return self.pages_of(s.seq_len + n_new) - self.pages_of(s.seq_len)

    def release(self, request_id: int) -> None:
        i = self.by_request.pop(request_id)
        self.slots[i] = _Slot()

    # ------------------------------------------------------------- evict
    def evict(self, request_id: int) -> int:
        """Preempt a request under page pressure: drop its slot + page
        quota (metadata-only, like admission — the physical K/V rows are
        simply overwritten by the next occupant).  Returns the number of
        pages freed.  The caller re-queues the request; on re-admission it
        replays its tokens through prefill (recompute-style preemption)."""
        i = self.by_request[request_id]
        freed = self.pages_of(self.slots[i].seq_len)
        self.release(request_id)
        return freed

    # ------------------------------------------------------------- views
    def seq_lens(self) -> List[int]:
        """Per-slot live lengths (0 for empty slots — predicated out, the
        JIT-task analogue: inactive rows cost no useful work)."""
        return [s.seq_len if s.request_id is not None else 0
                for s in self.slots]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.request_id is not None]
