#!/usr/bin/env python3
"""Write the ablation variants of the megakernel's static walk, for
``tools/ab_megakernel.py``.

    python3 tools/walk_variants.py build/variants
    python3 tools/ab_megakernel.py build/parent build/variants/* \\
        --arch granite-moe-1b-a400m

The static walk has five design items: (1) each worker runs only its
walk list (the pads skipped), (2) descriptor rows staged ahead in a ring
by ``cp.async`` (``RING`` rows), (3) the event protocol without full
fences (the signal a ``red.release``, no fence after the wait's acquire
spin), (4) two barriers a task, (5) the noop rows that remain (joins
that only wait and signal) run by warp 0 alone, without barriers.  The
checkout's ``megakernel.cu`` has all five, with ``RING`` = 4.  Each
variant is a copy of the checkout's ``src/repro_torch`` whose
``megakernel.cu`` takes some of them back:

    walk           item 1: threads 0-35 load the next row into registers
                   while a row runs and store it into shared memory after
                   the task; three barriers a task (the row in place, the
                   wait held, the stores landed); a __threadfence() after
                   the wait's spin and before the signal's atomicAdd
    walk+ring      item 1 and 2: the ring, still three barriers and fences
    walk+release   item 1 and 3: as walk, without the fences
    walk+2bar      item 1 and 4: as walk, but thread 0 loads the event words
                   of the next row itself, so the row-in-place barrier
                   folds into the wait's
    items1-4       items 1-4: every row, noops included, runs as a task
                   with its two barriers (through the running row)
    ring8          items 1-5 with a ring of 8 rows

Each edit asserts that the text it replaces is found exactly once, so a
variant never silently diverges from the checkout's source.  Imports
nothing of JAX or of the port.
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch") / "megakernel" / "csrc" / "megakernel.cu"

#: the full fences of the parent's event protocol
FENCES = [
    ('''  asm volatile("red.release.gpu.global.add.f32 [%0], %1;"
               :: "l"(p), "f"(v) : "memory");''',
     '''  __threadfence();
  atomicAdd(p, v);'''),
    ('''      __nanosleep(32);
    }
  }
  ++c.waits;''',
     '''      __nanosleep(32);
    }
  }
  __threadfence();
  ++c.waits;'''),
    ('''      __nanosleep(32);
    }
  }
}''',
     '''      __nanosleep(32);
    }
  }
  __threadfence();
}'''),
]

#: the ring with a barrier for the row and another for the wait
RING3 = [
    ('''      __syncwarp();
      if (threadIdx.x == 0) {
        row = wk.slot(i);''',
     '''    }
    __syncthreads();                    // row i is in place
    {
      if (threadIdx.x == 0) {
        row = wk.slot(i);'''),
]

_EXT3_HEAD = '''        if constexpr (EXT == 3) {
          if (kind == 14 || kind == 15) {
            if (kind == 14 && S.acks != nullptr && S.acks[2 * row] >= 0)
              wait_ack(heap, S, wk.w, row, heap + S.acks[2 * row],
                       S.acks[2 * row + 1]);
            if (d[3] > 0) {
              c.bulk += 1;
              c.rows += 3 * ((d[3] + 255) / 256) * d[1];
            }
          }
        }
'''

_EXT3_TAIL = '''      if constexpr (EXT == 3) {
        if (kind == 15 && S.acks != nullptr && S.acks[2 * row] >= 0)
          red_release(heap + S.acks[2 * row], 1.0f);
      }
'''

#: items 1-4: the checkout's loop without item 5, every row a task
LOOP4 = '''template <int EXT>
__device__ void static_loop(float* heap, const long long* __restrict__ descs,
                            const Walk& wk, const Statics& S, const Smem& sm,
                            Counts& c) {
  long long* d = sm.d;
  if (threadIdx.x < 32)
    for (int k = 0; k < RING - 1; ++k) stage_row(descs, wk, k, sm.ring);
  for (long long i = 0; i < wk.n; ++i) {
    long long row = 0;
    float t_start = 0.0f;
    if (threadIdx.x < 32) {
      __syncwarp();
      stage_row(descs, wk, i + RING - 1, sm.ring);
      cp_async_wait<RING - 1>();
      if (threadIdx.x < ROW_CHUNKS)
        reinterpret_cast<uint4*>(d)[threadIdx.x] =
            reinterpret_cast<const uint4*>(
                sm.ring + (i & (RING - 1)) * DESC_WORDS)[threadIdx.x];
      __syncwarp();
      if (threadIdx.x == 0) {
        row = wk.slot(i);
        if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], c);
        const long long kind = d[0];
''' + _EXT3_HEAD + '''        if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, 1.0f);
      }
    }
    __syncthreads();
    const long long kind = d[0];
    run_task<EXT>(kind, heap, d, S, sm);
    __syncthreads();
    if (threadIdx.x == 0) {
''' + _EXT3_TAIL + '''      if (S.tr_off >= 0)
        write_record(heap, S, row, wk.w, row, kind, t_start,
                     atomicAdd(heap + S.tr_off, 1.0f), -1.0f, d[32], d[33]);
      if (d[34] >= 0) {
        red_release(heap + S.event_off + d[34], 1.0f);
        ++c.signals;
      }
    }
  }
  if (threadIdx.x < 32) cp_async_wait<0>();
  count_rows(descs, wk, heap, S, sm, c);
}

'''

#: the parent's fetch over the walk list: three barriers a task
FETCH3 = '''template <int EXT>
__device__ void static_loop(float* heap, const long long* __restrict__ descs,
                            const Walk& wk, const Statics& S, const Smem& sm,
                            Counts& c) {
  if (threadIdx.x < DESC_WORDS && wk.n > 0)
    sm.d[threadIdx.x] = descs[wk.slot(0) * DESC_WORDS + threadIdx.x];
  for (long long i = 0; i < wk.n; ++i) {
    __syncthreads();
    long long next = 0;
    if (threadIdx.x < DESC_WORDS && i + 1 < wk.n)
      next = descs[wk.slot(i + 1) * DESC_WORDS + threadIdx.x];
    const long long* d = sm.d;
    const long long kind = d[0];
    const long long wait_ev = d[32], wait_cnt = d[33], sig_ev = d[34];
    long long row = 0;
    float t_start = 0.0f;
    if (threadIdx.x == 0) {
      row = wk.slot(i);
      if (wait_ev >= 0) wait_event(heap, S, wk.w, row, wait_ev, wait_cnt, c);
''' + _EXT3_HEAD + '''        if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, 1.0f);
    }
    __syncthreads();
    run_task<EXT>(kind, heap, d, S, sm);
    __syncthreads();
    if (threadIdx.x < DESC_WORDS) sm.d[threadIdx.x] = next;
    if (threadIdx.x == 0) {
''' + _EXT3_TAIL + '''      if (S.tr_off >= 0)
        write_record(heap, S, row, wk.w, row, kind, t_start,
                     atomicAdd(heap + S.tr_off, 1.0f), -1.0f, wait_ev,
                     wait_cnt);
      if (sig_ev >= 0) {
        red_release(heap + S.event_off + sig_ev, 1.0f);
        ++c.signals;
      }
    }
  }
  count_rows(descs, wk, heap, S, sm, c);
}

'''

#: the parent's fetch, thread 0 loading the next row's event words
#: itself: two barriers a task
FETCH2 = '''template <int EXT>
__device__ void static_loop(float* heap, const long long* __restrict__ descs,
                            const Walk& wk, const Statics& S, const Smem& sm,
                            Counts& c) {
  long long ev[3] = {-1, 0, -1};
  if (wk.n > 0) {
    const long long* r0 = descs + wk.slot(0) * DESC_WORDS;
    if (threadIdx.x < DESC_WORDS) sm.d[threadIdx.x] = r0[threadIdx.x];
    if (threadIdx.x == 0)
      for (int k = 0; k < 3; ++k) ev[k] = r0[32 + k];
  }
  for (long long i = 0; i < wk.n; ++i) {
    long long next = 0, nev[3] = {-1, 0, -1};
    if (i + 1 < wk.n) {
      const long long* rn = descs + wk.slot(i + 1) * DESC_WORDS;
      if (threadIdx.x < DESC_WORDS) next = rn[threadIdx.x];
      if (threadIdx.x == 0)
        for (int k = 0; k < 3; ++k) nev[k] = rn[32 + k];
    }
    __syncwarp();
    const long long* d = sm.d;
    long long row = 0;
    float t_start = 0.0f;
    if (threadIdx.x == 0) {
      const long long kind = d[0];
      row = wk.slot(i);
      if (ev[0] >= 0) wait_event(heap, S, wk.w, row, ev[0], ev[1], c);
''' + _EXT3_HEAD + '''      if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, 1.0f);
    }
    __syncthreads();
    const long long kind = d[0];
    run_task<EXT>(kind, heap, d, S, sm);
    __syncthreads();
    if (threadIdx.x < DESC_WORDS) sm.d[threadIdx.x] = next;
    if (threadIdx.x == 0) {
''' + _EXT3_TAIL + '''      if (S.tr_off >= 0)
        write_record(heap, S, row, wk.w, row, kind, t_start,
                     atomicAdd(heap + S.tr_off, 1.0f), -1.0f, ev[0], ev[1]);
      if (ev[2] >= 0) {
        red_release(heap + S.event_off + ev[2], 1.0f);
        ++c.signals;
      }
      for (int k = 0; k < 3; ++k) ev[k] = nev[k];
    }
  }
  count_rows(descs, wk, heap, S, sm, c);
}

'''

LOOP_START = "template <int EXT>\n__device__ void static_loop("
LOOP_END = "// Pop with the calling warp"


def _edit(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"walk_variants: {text.count(old)} matches of "
                         f"{old[:60]!r}")
    return text.replace(old, new)


def _loop(text, loop):
    a, b = text.index(LOOP_START), text.index(LOOP_END)
    return text[:a] + loop + text[b:]


def variants(src: str):
    """{name: megakernel.cu text} of the ablation variants."""
    fenced = src
    for old, new in FENCES:
        fenced = _edit(fenced, old, new)
    ring3 = _loop(fenced, LOOP4)
    for old, new in RING3:
        ring3 = _edit(ring3, old, new)
    return {"walk": _loop(fenced, FETCH3),
            "walk+ring": ring3,
            "walk+release": _loop(src, FETCH3),
            "walk+2bar": _loop(fenced, FETCH2),
            "items1-4": _loop(src, LOOP4),
            "ring8": _edit(src, "constexpr int RING = 4;",
                           "constexpr int RING = 8;")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="directory for the variants")
    args = ap.parse_args()
    src = (ROOT / "src" / CU).read_text()
    for name, text in variants(src).items():
        pkg = args.out / name / "src" / "repro_torch"
        if pkg.exists():
            shutil.rmtree(pkg)
        shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (args.out / name / "src" / CU).write_text(text)
        print(f"{args.out / name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
