#!/usr/bin/env python3
"""Write variants of the megakernel's source for ``tools/ab_megakernel.py``:
ablations of the checkout's task boundary, and a per-task
``%globaltimer`` stamp of any checkout.

    python3 tools/prefetch_variants.py build/variants --stamp .
    python3 tools/ab_megakernel.py build/variants/* --arch deepseek-7b

The ablations (copies of the checkout's ``src/repro_torch``) each change
one thing at the boundary between two tasks:

    vec-stage      the matmul's x rows staged with 16-byte loads, eight in
                   flight a thread, by a function the matmul calls
    l2             before a task's barrier, lanes of warp 0 send the first
                   64 weight rows of the walk's next row (a matmul or
                   expert GEMM: words 8, 9, 3) to L2 with
                   ``cp.async.bulk.prefetch.L2``, ahead of its wait

``--stamp ROOT`` writes ``stamp-<name of ROOT>`` (``stamp-change`` for the
checkout), a copy of ROOT's package whose static kernel records, for
every task row (indexed by grid slot, 8 words a slot), with thread 0's
``%globaltimer``: 0 the wait's start, 1 its end, 2 the primary tile in
place (the task's start after its barrier; a matmul's or expert GEMM's x
rows in shared memory), 3 its first weight bytes returned (thread 0 loads
the first weight float4 and stores it into word 6, so that the next stamp
issues after the load has returned), 4 the end of thread 0's share of the
weight stream, 5 the task's stores landed (the barrier before the
signal).  The copy's library exports ``mk_set_stamp(pointer)`` (null:
off), which ``tools/ab_megakernel.py`` uses.  Each edit asserts that the
text it replaces appears exactly once.  Imports nothing of JAX or of the
port.
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch") / "megakernel" / "csrc" / "megakernel.cu"

STAMP_FNS = '''// The stamp buffer (null: off) and the running row's grid slot, kept in
// the block-reduction words past those block_sum uses; the timer read is
// a compiler memory barrier, so that no load moves across a stamp.
__device__ unsigned long long* g_stamp = nullptr;

__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ void set_slot(const Smem& sm, long long slot) {
  *reinterpret_cast<long long*>(sm.scal + 20) = slot;
}

__device__ __forceinline__ void stamp(const Smem& sm, int k) {
  const long long slot = *reinterpret_cast<const long long*>(sm.scal + 20);
  if (g_stamp != nullptr && slot >= 0) g_stamp[slot * 8 + k] = stamp_ns();
}

// Store a loaded word into the slot's word 6: the store waits for the
// load, and the stamp after it issues after the store.
__device__ __forceinline__ void stamp_sink(const Smem& sm, float v) {
  const long long slot = *reinterpret_cast<const long long*>(sm.scal + 20);
  if (g_stamp != nullptr && slot >= 0)
    g_stamp[slot * 8 + 6] = __float_as_uint(v);
}

'''

#: (old, new): the old text must appear exactly once
STAMP_EDITS = [
    ("// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)",
     STAMP_FNS + "// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)"),
    ("    bool live[CPT];\n",
     "    if (threadIdx.x == 0 && r0 == 0 && !MUL_OUT) {\n"
     "      stamp(sm, 2);\n"
     "      stamp_sink(sm, __ldg(wp).x);\n"
     "      stamp(sm, 3);\n"
     "    }\n"
     "    bool live[CPT];\n"),
    ("  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n",
     "  if (threadIdx.x == 0 && !MUL_OUT) stamp(sm, 4);\n"
     "  if (nks > 1) {                        // then CPT == 1: reduce K "
     "slices\n"),
    ("          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n",
     "          set_slot(sm, row);\n"
     "          stamp(sm, 0);\n"
     "          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n"),
    ("          if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, "
     "1.0f);\n",
     "          stamp(sm, 1);\n"
     "          if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, "
     "1.0f);\n"),
    ("    run_task<EXT>(d[0], heap, d, S, sm);\n",
     "    if (threadIdx.x == 0) stamp(sm, 2);\n"
     "    run_task<EXT>(d[0], heap, d, S, sm);\n"),
    ("    __syncthreads();                    // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n",
     "    __syncthreads();                    // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n"
     "      stamp(sm, 5);\n"),
    ("  const long long w = blockIdx.x;\n",
     "  const long long w = blockIdx.x;\n"
     "  if (threadIdx.x == 0) set_slot(sm, -1);\n"),
    ('extern "C" const char* mk_error_string(int err) {',
     '// Point the stamp buffer at `p` (null: off).\n'
     'extern "C" int mk_set_stamp(void* p) {\n'
     '  return static_cast<int>(cudaMemcpyToSymbol(g_stamp, &p, '
     'sizeof p));\n'
     '}\n\n'
     'extern "C" const char* mk_error_string(int err) {'),
]

L2_FN = '''// Lanes of warp 0: send the first 64 weight rows of a matmul or expert
// GEMM row (words 8, 9, 3; the float4 groups of its store width) to L2,
// one bulk prefetch a row.  No task writes weights.
__device__ __noinline__ void prefetch_weights(const float* heap,
                                              const long long* nx,
                                              const Statics& S) {
  if ((nx[0] != 1 && nx[0] != 10) || ((nx[8] | nx[9]) & 3) != 0) return;
  const long long ncg = store_width(nx[2], S) / VEC;
  const long long rows = lmin(nx[3], 64);
  if (ncg <= 0) return;
  for (long long r = threadIdx.x; r < rows; r += 32)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(heap + nx[8] + r * nx[9]),
                    "r"(static_cast<unsigned>(ncg * 16)) : "memory");
}

'''

VEC_FN = '''// RP rows of K words (row stride ld; rows past `rows` zero) into dst,
// 16-byte loads when everything is whole float4s, eight in flight a thread.
__device__ __noinline__ void stage_rows(const float* src, long long ld,
                                        int rows, int K, float* dst) {
  if (((reinterpret_cast<unsigned long long>(src) | (ld | K) * 4) & 15)
      == 0) {
    const int per = K / VEC, n = RP * per;
    for (int base = threadIdx.x; base < n; base += NT * 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = base + u * NT, r = e / per;
        if (e < n)
          v[u] = r < rows ? *reinterpret_cast<const float4*>(
                                src + r * ld + (e - r * per) * VEC)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = base + u * NT;
        if (e < n) reinterpret_cast<float4*>(dst)[e] = v[u];
      }
    }
  } else {
    for (int e = threadIdx.x; e < RP * K; e += NT)
      dst[e] = e / K < rows ? src[(e / K) * ld + e % K] : 0.0f;
  }
}

'''

#: the ablations of the checkout's source: (old, new) edits
ABLATIONS = {
    "vec-stage": [
        ("// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)",
         VEC_FN + "// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)"),
        ("    for (int r = 0; r < RP; ++r)\n"
         "      for (long long k = threadIdx.x; k < K; k += NT)\n"
         "        sm.x[r * K + k] = r < rp ? heap[d[6] + (r0 + r) * d[7] + k]"
         " : 0.0f;\n"
         "    __syncthreads();\n"
         "    if constexpr (EXT) {\n",
         "    stage_rows(heap + d[6] + r0 * d[7], d[7], rp,\n"
         "               static_cast<int>(K), sm.x);\n"
         "    __syncthreads();\n"
         "    if constexpr (EXT) {\n")],
    "l2": [
        ("// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)",
         L2_FN + "// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias)"),
        ("      if (threadIdx.x == 0) {\n        s_task = i;\n",
         "      cp_async_wait<RING - 2>();        // row i + 1 landed too\n"
         "      __syncwarp();\n"
         "      if (i + 1 < wk.n)\n"
         "        prefetch_weights(heap, sm.ring + ((i + 1) & (RING - 1))\n"
         "                         * DESC_WORDS, S);\n"
         "      if (threadIdx.x == 0) {\n        s_task = i;\n")],
}


def _edit(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"prefetch_variants: {text.count(old)} matches "
                         f"of {old[:60]!r}")
    return text.replace(old, new)


def stamped(text: str) -> str:
    """``text`` (a megakernel.cu) with the per-task stamps."""
    for old, new in STAMP_EDITS:
        text = _edit(text, old, new)
    return text


def _write(out: Path, src_root: Path, text: str) -> None:
    pkg = out / "src" / "repro_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(src_root / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (out / "src" / CU).write_text(text)
    print(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="directory for the variants")
    ap.add_argument("--stamp", type=Path, nargs="*", default=[],
                    help="roots whose stamped copies to write")
    args = ap.parse_args()
    src = (ROOT / "src" / CU).read_text()
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            text = _edit(text, old, new)
        _write(args.out / name, ROOT, text)
    for root in args.stamp:
        root = root.resolve()
        name = "stamp-" + ("change" if root == ROOT else root.name)
        _write(args.out / name, root, stamped((root / "src" / CU).read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
