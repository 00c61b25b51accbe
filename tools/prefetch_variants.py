#!/usr/bin/env python3
"""Write variants of the megakernel's source for ``tools/ab_megakernel.py``:
ablations of the checkout's task boundary, and a per-task
``%globaltimer`` stamp of any checkout.

    python3 tools/prefetch_variants.py build/variants --stamp .
    python3 tools/prefetch_variants.py build/variants --producer
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
off), which ``tools/ab_megakernel.py`` uses.

``--producer`` also writes the two producer-warp designs of the
prefetch (descriptor words 24-30; ``primary()`` of the JAX package's
kernel): a 17th warp (warp 16, 544 threads) copies a task's primary tile
(words 28-30, TN words a row) into one of two sides of a shared-memory
buffer (2 · RP rows of TN words after the x rows; a plan whose sides do
not fit beside its x rows runs with the copies off), and the task reads
it there (kinds 1-8, at most RP rows, word 27 = 1; every other primary
tile is demand-loaded).  The compute warps (0-15) keep the matmul's
K-slice split and sums (512 threads) and synchronise among themselves on
named barrier 1 (``bar.sync 1, 512``); counter word 2 counts the tiles
read from a side, word 3 the demand loads.  544 threads cap a thread's
registers at 96 (a CTA's warps are allocated registers four at a time:
20 warps' worth of the SM's 64K), against the kernel's 128.

    producer-warp  variant (a): warp 16 walks the worker's rows on its
                   own, ahead of the compute warps: for each row with a
                   prefetched tile it waits for the side to be free, for
                   the compute warps to have passed the wait of the row's
                   grid predecessor (or finished the row before it when
                   that predecessor is a pad), and for the row's own
                   event, copies the tile and raises the side's fill
                   count; thread 0 waits for that count with the task's
                   event wait.  The handshakes are shared-memory counters
                   under the event wait's deadline.
    warp17         variant (b): warp 16 runs in step with the compute
                   warps (both task barriers hold all 544 threads); during
                   a task whose next row is a prefetched task with this
                   task as its grid predecessor, it polls that row's event
                   until the compute warps have signalled (thread 0 now
                   signals before the second barrier) and copies the tile
                   if the event triggered, else the row demand-loads.

Each edit asserts that the text it replaces appears exactly once.
Imports nothing of JAX or of the port.
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


PF_COMMON_FNS = r'''// ---- the producer warp (warp 16) of the prefetch ------------------------
constexpr int NTB = NT + 32;           // threads a CTA: NT + the producer

// The compute warps' barrier (warps 0-15); barrier 0 holds warp 16 too.
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, 512;" ::: "memory");
}

// Progress words between the compute warps and warp 16 (shared memory).
__shared__ volatile long long pf_pass;   // walk index whose wait passed
__shared__ volatile long long pf_done;   // walk index whose stores landed
__shared__ volatile long long pf_full[2], pf_free[2];  // side fills, frees
__shared__ volatile long long pf_next[2];  // (b): slot prefetched, by parity

'''

PF_HELPERS = r'''// A row whose primary tile the producer copies: kinds 1-8, word 27 = 1,
// at most RP rows, with the sides in shared memory.
__device__ __forceinline__ bool pf_row_ok(const long long* d,
                                          const Statics& S) {
  return S.pf_on && d[0] >= 1 && d[0] <= 8 && d[27] == 1 && d[30] > 0
         && d[30] <= RP;
}

// Warp 16: the row's primary tile (words 28-30: offset, row stride, rows;
// TN words a row, as the JAX package's prefetch copies) into `dst`.
__device__ __forceinline__ void pf_copy(const float* heap, const long long* d,
                                        const Statics& S, float* dst) {
  const int lane = threadIdx.x & 31;
  const long long rows = d[30], tn = S.tn;
  if (((d[28] | d[29] | tn) & 3) == 0) {
    const long long n4 = tn / VEC;
    for (long long r = 0; r < rows; ++r) {
      const float4* src =
          reinterpret_cast<const float4*>(heap + d[28] + r * d[29]);
      float4* o = reinterpret_cast<float4*>(dst + r * tn);
#pragma unroll 4
      for (long long e = lane; e < n4; e += 32) o[e] = src[e];
    }
  } else {
    for (long long e = lane; e < rows * tn; e += 32)
      dst[e] = heap[d[28] + (e / tn) * d[29] + e % tn];
  }
}

// One thread: spin until *p >= want (a shared progress word, or with
// `gpu` an event counter read with acquire loads), under the event wait's
// deadline; past it the kernel traps.
__device__ __noinline__ void pf_spin(float* heap, const Statics& S,
                                     const volatile long long* p,
                                     const float* ev, long long want,
                                     int what) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    if (ev != nullptr ? ld_acquire(ev) >= static_cast<float>(want)
                      : *p >= want)
      break;
    if (global_ns() - t0 > static_cast<unsigned long long>(S.spin_ns)) {
      printf("megakernel: block %d thread %d waited past its deadline in "
             "the prefetch handshake %d (want %lld)\n", blockIdx.x,
             threadIdx.x, what, want);
      __trap();
    }
    __nanosleep(32);
  }
  __threadfence_block();
}

'''

COMMON_EDITS = [
    ("struct Statics {\n", PF_COMMON_FNS + "struct Statics {\n"),
    ("  long long mrope[3];\n};\n",
     "  long long mrope[3];\n"
     "  long long pf_on;       // the producer's two sides fit\n};\n"),
    ("  float* x;\n};\n",
     "  float* x;\n"
     "  float* pf;             // the producer's sides: 2 x RP rows of TN\n"
     "};\n"),
    # PF kinds: each reads its primary tile from the side (sm.pf, TN words
    # a row) when PF, from the heap otherwise
    ("template <bool EXT, bool WIDE = false>\n__device__ void k_matmul(",
     "template <bool EXT, bool WIDE = false, bool PF = false>\n"
     "__device__ void k_matmul("),
    ("        sm.x[r * K + k] = r < rp ? heap[d[6] + (r0 + r) * d[7] + k] : "
     "0.0f;\n",
     "        sm.x[r * K + k] = r < rp ? (PF && k < S.tn\n"
     "                                    ? sm.pf[(r0 + r) * S.tn + k]\n"
     "                                    : heap[d[6] + (r0 + r) * d[7] + k])"
     "\n                                 : 0.0f;\n"),
    ("__device__ void k_rmsnorm(float* heap,",
     "template <bool PF>\n__device__ void k_rmsnorm(float* heap,"),
    ("    const float* x = heap + d[6] + r * d[7];\n    float ss = 0.0f;\n",
     "    const float* x = PF ? sm.pf + r * S.tn : heap + d[6] + r * d[7];\n"
     "    float ss = 0.0f;\n"),
    ("__device__ void k_rope(float* heap, const long long* d, const Statics& S)"
     " {\n",
     "template <bool PF>\n"
     "__device__ void k_rope(float* heap, const long long* d, const Statics& S,"
     "\n                       const Smem& sm) {\n"),
    ("      const float* x = heap + d[6] + r * d[7] + h * hd;\n",
     "      const float* x = (PF ? sm.pf + r * S.tn : heap + d[6] + r * d[7])\n"
     "                       + h * hd;\n"),
    ("__device__ void k_glu(float* heap, const long long* d, const Statics& S)"
     " {\n",
     "template <bool PF>\n"
     "__device__ void k_glu(float* heap, const long long* d, const Statics& S,"
     "\n                      const Smem& sm) {\n"),
    ("        act(heap[d[6] + r * d[7] + j], d[14]) * heap[d[8] + r * d[9] + j];"
     "\n",
     "        act(PF ? sm.pf[r * S.tn + j] : heap[d[6] + r * d[7] + j], d[14])\n"
     "        * heap[d[8] + r * d[9] + j];\n"),
    ("__device__ void k_resid(float* heap, const long long* d, const Statics& S)"
     " {\n",
     "template <bool PF>\n"
     "__device__ void k_resid(float* heap, const long long* d, const Statics& S,"
     "\n                        const Smem& sm) {\n"),
    ("    float y = heap[d[6] + r * d[7] + j] * scale;\n",
     "    float y = (PF ? sm.pf[r * S.tn + j] : heap[d[6] + r * d[7] + j])\n"
     "              * scale;\n"),
    ("__device__ void k_attn(float* heap,",
     "template <bool PF>\n__device__ void k_attn(float* heap,"),
    ("      const float* qp = heap + d[6] + r * d[7] + qh * hd;\n",
     "      const float* qp = (PF ? sm.pf + r * S.tn : heap + d[6] + r * d[7])\n"
     "                        + qh * hd;\n"),
    ("__device__ void k_cache_update(float* heap, const long long* d,\n"
     "                               const Statics& S) {\n",
     "template <bool PF>\n"
     "__device__ void k_cache_update(float* heap, const long long* d,\n"
     "                               const Statics& S, const Smem& sm) {\n"),
    ("    heap[d[4] + r * d[15] + seq * d[5] + j] = heap[d[6] + r * d[7] + j];"
     "\n",
     "    heap[d[4] + r * d[15] + seq * d[5] + j] =\n"
     "        PF ? sm.pf[r * S.tn + j] : heap[d[6] + r * d[7] + j];\n"),
    ("__device__ void k_embed(float* heap, const long long* d, const Statics& S)"
     " {\n",
     "template <bool PF>\n"
     "__device__ void k_embed(float* heap, const long long* d, const Statics& S,"
     "\n                        const Smem& sm) {\n"),
    ("    const long long tok = static_cast<long long>(heap[d[6] + r]);\n",
     "    const long long tok =\n"
     "        static_cast<long long>(PF ? sm.pf[r] : heap[d[6] + r]);\n"),
    # run_task: a PF instantiation holds kinds 1-8 only
    ("template <int EXT>\n__device__ __forceinline__ void run_task(",
     "template <int EXT, bool PF = false>\n"
     "__device__ __forceinline__ void run_task("),
    ("  if constexpr (EXT == 3) {\n    if (kind == 14 || kind == 15) {",
     "  if constexpr (!PF && EXT == 3) {\n    if (kind == 14 || kind == 15) {"),
    ("  if constexpr (EXT == 2 || EXT == 3) {\n",
     "  if constexpr (!PF && (EXT == 2 || EXT == 3)) {\n"),
    ("  if constexpr (EXT >= 1 && EXT <= 3) {\n    switch (kind) {\n"
     "      case 9:",
     "  if constexpr (!PF && EXT >= 1 && EXT <= 3) {\n    switch (kind) {\n"
     "      case 9:"),
    ("    case 1: k_matmul<(EXT >= 1 && EXT <= 3), EXT == 4>(heap, d, S, sm); "
     "break;\n"
     "    case 2: k_rmsnorm(heap, d, S, sm); break;\n"
     "    case 3: k_rope(heap, d, S); break;\n"
     "    case 4: k_glu(heap, d, S); break;\n"
     "    case 5: k_resid(heap, d, S); break;\n"
     "    case 6: k_attn(heap, d, S, sm); break;\n"
     "    case 7: k_cache_update(heap, d, S); break;\n"
     "    case 8: k_embed(heap, d, S); break;\n",
     "    case 1: k_matmul<(EXT >= 1 && EXT <= 3), EXT == 4, PF>(heap, d, S, sm);"
     "\n      break;\n"
     "    case 2: k_rmsnorm<PF>(heap, d, S, sm); break;\n"
     "    case 3: k_rope<PF>(heap, d, S, sm); break;\n"
     "    case 4: k_glu<PF>(heap, d, S, sm); break;\n"
     "    case 5: k_resid<PF>(heap, d, S, sm); break;\n"
     "    case 6: k_attn<PF>(heap, d, S, sm); break;\n"
     "    case 7: k_cache_update<PF>(heap, d, S, sm); break;\n"
     "    case 8: k_embed<PF>(heap, d, S, sm); break;\n"),
    # counters: word 2 the tiles read from a side (thread 0's count), word 3
    # the demand loads
    ("  long long bulk, rows, fallbacks;\n",
     "  long long bulk, rows, fallbacks, pf;\n"),
    ("    bulk = rows = fallbacks = waits = violations = signals = 0;\n",
     "    bulk = rows = fallbacks = pf = waits = violations = signals = 0;\n"),
    ("    st[2] = 0.0f;\n    st[3] = static_cast<float>(fallbacks);\n",
     "    st[2] = static_cast<float>(pf);\n"
     "    st[3] = static_cast<float>(fallbacks - pf);\n"),
    # the helpers, before the static walk
    ("// The rows a static worker runs: the n entries of its walk list, or "
     "the\n",
     "@@HELPERS@@// The rows a static worker runs: the n entries of its walk "
     "list, or the\n"),
    # launch: 544 threads, the sides after the x rows when they fit
    ("__global__ void __launch_bounds__(NT)\n",
     "__global__ void __launch_bounds__(NTB)\n"),
    ("  sm.x = sm.red + RP * NT * VEC;\n",
     "  sm.x = sm.red + RP * NT * VEC;\n"
     "  sm.pf = sm.x + (RP * S.tk > NWARP * (S.hd + 2) ? RP * S.tk\n"
     "                                                 : NWARP * (S.hd + 2));\n"),
    ("  if constexpr (DYN) {\n    // in shared memory",
     "  if constexpr (DYN) {\n"
     "    if (threadIdx.x >= NT) return;    // no prefetch plan: warp 16 "
     "idles\n"
     "    // in shared memory"),
    ("           &per_sm, kernel, NT, smem)) != cudaSuccess) return 0;\n",
     "           &per_sm, kernel, NTB, smem)) != cudaSuccess) return 0;\n"),
    ("  g_last = S;\n  const size_t smem = smem_bytes(tk, hd);\n",
     "  size_t smem = smem_bytes(tk, hd);\n"
     "  {                                     // the producer's two sides\n"
     "    int dev = 0, optin = 0;\n"
     "    cudaGetDevice(&dev);\n"
     "    cudaDeviceGetAttribute(&optin,\n"
     "                           cudaDevAttrMaxSharedMemoryPerBlockOptin, "
     "dev);\n"
     "    const size_t pf = sizeof(float) * 2 * RP * tn;\n"
     "    S.pf_on = dyn == 0 && smem + pf + 1024 <= static_cast<size_t>(optin);"
     "\n    if (S.pf_on) smem += pf;\n"
     "  }\n"
     "  g_last = S;\n"),
    ("      dim3(static_cast<unsigned>(num_workers)), dim3(NT), args, smem,\n",
     "      dim3(static_cast<unsigned>(num_workers)), dim3(NTB), args, smem,\n"),
]

#: (a): warp 16 runs ahead on its own
A_EDITS = [
    ("  long long i = 0;                      // warp 0's next row\n",
     "  long long i = 0;                      // warp 0's next row\n"
     "  long long npf = 0;                    // tasks that read a side\n"),
    ("        if (threadIdx.x == 0) run_noop(heap, S, wk, i, d, c);\n",
     "        if (threadIdx.x == 0) {\n"
     "          run_noop(heap, S, wk, i, d, c);\n"
     "          __threadfence_block();\n"
     "          pf_pass = i;\n"
     "          pf_done = i;\n"
     "        }\n"),
    ("          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n          if constexpr (EXT == 3) {\n",
     "          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], "
     "c);\n"
     "          __threadfence_block();\n"
     "          pf_pass = i;\n"
     "          if (pf_row_ok(d, S))          // the producer filled its side\n"
     "            pf_spin(heap, S, &pf_full[npf & 1], nullptr, npf / 2 + 1, 0);\n"
     "          if constexpr (EXT == 3) {\n"),
    ("    run_task<EXT>(d[0], heap, d, S, sm);\n",
     "    const bool pf = pf_row_ok(d, S);\n"
     "    if (pf) {\n"
     "      Smem sp = sm;\n"
     "      sp.pf = sm.pf + (npf & 1) * RP * S.tn;\n"
     "      run_task<EXT, true>(d[0], heap, d, S, sp);\n"
     "    } else {\n"
     "      run_task<EXT>(d[0], heap, d, S, sm);\n"
     "    }\n"),
    ("        red_release(heap + S.event_off + d[34], 1.0f);\n"
     "        ++c.signals;\n      }\n    }\n    ++i;\n",
     "        red_release(heap + S.event_off + d[34], 1.0f);\n"
     "        ++c.signals;\n      }\n"
     "      __threadfence_block();\n"
     "      if (pf) {                         // its side is free again\n"
     "        pf_free[npf & 1] = npf / 2 + 1;\n"
     "        ++c.pf;\n"
     "      }\n"
     "      pf_done = i;\n"
     "    }\n"
     "    npf += pf;\n"
     "    ++i;\n"),
    ("// Pop with the calling warp from `words` words of ready-pool slots (a",
     r'''// Variant (a): warp 16 walks the worker's rows ahead of the compute
// warps.  A row with a prefetched tile (pf_row_ok) takes side k & 1 (k:
// such rows before it); the copy starts once task k - 2 freed the side,
// the compute warps passed the wait of the row's grid predecessor (or
// finished the row before it, when that predecessor is a pad the walk
// skips: then every lane writer of the tile is done), and the row's own
// event triggered; then the side's fill count rises.
__device__ void producer_loop(float* heap,
                              const long long* __restrict__ descs,
                              const Walk& wk, const Statics& S,
                              const Smem& sm) {
  const int lane = threadIdx.x & 31;
  long long k = 0;
  for (long long q = 0; q < wk.n; ++q) {
    const long long* dg = descs + wk.slot(q) * DESC_WORDS;
    if (!pf_row_ok(dg, S)) continue;
    const int side = static_cast<int>(k & 1);
    if (lane == 0) {
      if (k >= 2) pf_spin(heap, S, &pf_free[side], nullptr, k / 2, 1);
      const bool pred = q > 0 && wk.slot(q - 1) == wk.slot(q) - wk.W;
      pf_spin(heap, S, pred ? &pf_pass : &pf_done, nullptr, q - 1, 2);
      if (dg[32] >= 0)
        pf_spin(heap, S, nullptr, heap + S.event_off + dg[32], dg[33], 3);
    }
    __syncwarp();
    pf_copy(heap, dg, S, sm.pf + side * RP * S.tn);
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      pf_full[side] = k / 2 + 1;
    }
    ++k;
  }
}

// Pop with the calling warp from `words` words of ready-pool slots (a'''),
    ("    Counts c;                           // thread 0's\n    c.zero();\n",
     "    if (threadIdx.x == 0) {\n"
     "      pf_pass = pf_done = -1;\n"
     "      pf_full[0] = pf_full[1] = pf_free[0] = pf_free[1] = 0;\n"
     "    }\n"
     "    __syncthreads();                    // all 544\n"
     "    Counts c;                           // thread 0's\n    c.zero();\n"),
    ("    static_loop<EXT>(heap, descs, wk, S, sm, c);\n",
     "    if (threadIdx.x >= NT) {\n"
     "      producer_loop(heap, descs, wk, S, sm);\n"
     "      return;\n"
     "    }\n"
     "    static_loop<EXT>(heap, descs, wk, S, sm, c);\n"),
]

#: (b): warp 16 in step with the compute warps
B_EDITS = [
    ("  long long i = 0;                      // warp 0's next row\n",
     "  long long i = 0;                      // warp 0's next row\n"
     "  long long npf = 0, t = 0;             // side reads; task rows\n"),
    ("    csync();                    // the task row is in place; the\n"
     "    if (s_task >= wk.n) break;          // wait held\n",
     "    __syncthreads();                    // the task row is in place; the"
     "\n    if (s_task >= wk.n) break;          // wait held (all 544)\n"),
    ("    run_task<EXT>(d[0], heap, d, S, sm);\n"
     "    csync();                    // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n",
     "    const bool pf = S.pf_on && pf_next[t & 1] == wk.slot(s_task);\n"
     "    if (threadIdx.x >= NT) {            // warp 16: the next row's tile\n"
     "      warp17_next(heap, descs, wk, S, sm, s_task, t, npf + pf);\n"
     "    } else if (pf) {\n"
     "      Smem sp = sm;\n"
     "      sp.pf = sm.pf + (npf & 1) * RP * S.tn;\n"
     "      run_task<EXT, true>(d[0], heap, d, S, sp);\n"
     "    } else {\n"
     "      run_task<EXT>(d[0], heap, d, S, sm);\n"
     "    }\n"
     "    if (threadIdx.x < NT) csync();      // the task's stores landed\n"
     "    if (threadIdx.x == 0) {\n"),
    ("        red_release(heap + S.event_off + d[34], 1.0f);\n"
     "        ++c.signals;\n      }\n    }\n    ++i;\n",
     "        red_release(heap + S.event_off + d[34], 1.0f);\n"
     "        ++c.signals;\n      }\n"
     "      c.pf += pf;\n"
     "      __threadfence_block();\n"
     "      pf_done = s_task;                 // signalled\n"
     "    }\n"
     "    __syncthreads();                    // all 544: the next copy landed\n"
     "    npf += pf;\n"
     "    ++t;\n"
     "    ++i;\n"),
    ("  if (threadIdx.x < 32) cp_async_wait<0>();   // only empty groups remain"
     "\n",
     "  if (threadIdx.x >= NT) return;\n"
     "  if (threadIdx.x < 32) cp_async_wait<0>();   // only empty groups remain"
     "\n"),
    ("// Static scheduler: CTA w runs the rows of its walk in order, each staged"
     "\n",
     r'''// Variant (b), warp 16 during task row s (the t-th task row): when the
// walk's next row is a prefetched task whose grid predecessor is this
// row, poll its event until it triggers or this task has signalled, and
// copy its tile into side `side` if it triggered; pf_next[(t + 1) & 1]
// tells the compute warps which row's tile is in place.
__device__ __noinline__ void warp17_next(float* heap,
                                         const long long* __restrict__ descs,
                                         const Walk& wk, const Statics& S,
                                         const Smem& sm, long long s,
                                         long long t, long long side) {
  const int lane = threadIdx.x & 31;
  long long got = -1;
  if (s + 1 < wk.n && wk.slot(s + 1) == wk.slot(s) + wk.W) {
    const long long* dg = descs + wk.slot(s + 1) * DESC_WORDS;
    if (pf_row_ok(dg, S)) {
      int ok = 0;
      if (lane == 0) {
        const float* ev = dg[32] >= 0 ? heap + S.event_off + dg[32]
                                      : nullptr;
        const float want = static_cast<float>(dg[33]);
        const unsigned long long t0 = global_ns();
        for (;;) {
          const bool done = pf_done >= s;
          __threadfence_block();
          if (ev == nullptr || ld_acquire(ev) >= want) { ok = 1; break; }
          if (done) break;
          if (global_ns() - t0 > static_cast<unsigned long long>(S.spin_ns))
            __trap();
          __nanosleep(32);
        }
      }
      ok = __shfl_sync(0xffffffffu, ok, 0);
      if (ok) {
        pf_copy(heap, dg, S, sm.pf + (side & 1) * RP * S.tn);
        got = wk.slot(s + 1);
      }
    }
  }
  __syncwarp();
  if (lane == 0) pf_next[(t + 1) & 1] = got;
}

// Static scheduler: CTA w runs the rows of its walk in order, each staged
'''),
    ("    Counts c;                           // thread 0's\n    c.zero();\n",
     "    if (threadIdx.x == 0) {\n"
     "      pf_pass = pf_done = -1;\n"
     "      pf_next[0] = pf_next[1] = -1;\n"
     "    }\n"
     "    __syncthreads();                    // all 544\n"
     "    Counts c;                           // thread 0's\n    c.zero();\n"),
]

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

#: the producer-warp variants of the checkout: (name, edits after the
#: common ones)
PRODUCERS = {"producer-warp": A_EDITS, "warp17": B_EDITS}


def producer_variant(text: str, edits) -> str:
    """``text`` (a megakernel.cu) with warp 16: every barrier of the compute
    warps on named barrier 1, then the common edits, then ``edits``."""
    n = text.count("__syncthreads();")
    if n == 0:
        raise SystemExit("prefetch_variants: no barrier to rename")
    text = text.replace("__syncthreads();", "csync();")
    for old, new in COMMON_EDITS:
        text = _edit(text, old, new.replace("@@HELPERS@@", PF_HELPERS))
    for old, new in edits:
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
    ap.add_argument("--producer", action="store_true",
                    help="also write the producer-warp designs")
    args = ap.parse_args()
    src = (ROOT / "src" / CU).read_text()
    if args.producer:
        for name, edits in PRODUCERS.items():
            _write(args.out / name, ROOT, producer_variant(src, edits))
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
