// The decode megakernel: one persistent CUDA kernel runs every task of a
// decode step from the descriptor table against one float32 heap.
//
// Replaces: the Pallas persistent megakernel of the JAX package,
// repro/kernels/megakernel/kernel.py `make_megakernel` (pallas_call at
// kernel.py:1175), for the static W-worker scheduler, the dynamic
// scheduler (its pop at kernel.py:411-499, `_push` at :1039, the
// signal-and-enqueue at :1063 and the dynamic trace record at :1104) and
// the task kinds 0-13: the dense family's 0-8 (noop, matmul + bias +
// activation, rmsnorm, rope, glu, residual/scale-add, GQA decode
// attention, KV cache update, embedding; rope with its M-RoPE branch,
// `k_rope` at kernel.py:775), the MoE family's 9-11 (the
// router's top-k softmax, `k_softmax_topk` at kernel.py:896; the expert
// GEMM, `k_moe_gg` at :914; the weighted combine, `k_moe_combine` at
// :947) and the SSM family's 12-13 (the Mamba2 SSD state update, `k_ssm`
// at :959; the causal conv step, `k_conv` at :998) and the COMM kinds
// 14-15 of a stamped multichip plan (the ring send, `k_remote_copy` at
// :679, and the all-reduce chunk, `k_ar_chunk` at :713, both over the
// span op `span_op` at :641), with the in-heap event wait and signal and
// the trace ring.
//
// Design: one CTA of 512 threads per worker, all W CTAs resident at once
// (a cooperative launch, which refuses a grid that cannot be).  Under the
// static scheduler CTA w runs the rows of its walk list in order: the
// grid slots s * W + w that are not pads (the plan's port-only side table
// `walk`, desc.walk_lists: W + 1 offsets, then each lane's slots).  A pad
// (kind 0, no wait, no signal) does nothing, so a worker skips it whole;
// at full width most slots are pads (granite: 96 % of them), and each
// cost three barriers and an exposed row fetch when the walk visited
// them.  Without the lists, or with the trace ring on, the CTA walks
// every slot of its column (see the ring below).  The dynamic scheduler
// is below.  Each kind is a __device__ function selected by a switch on
// word 0.  The rows are staged ahead: warp 0 copies row i + RING - 1 of
// the walk into a ring of RING rows in shared memory with 16-byte
// cp.async (one commit group a row) while row i runs, so that a short
// task (rope, resid, cache_update: under a microsecond) finds the next
// row in place; its turn come, each lane copies its part into the
// running row, whose address is fixed (static_loop says why).  Two
// barriers a task: one after thread 0's wait, which also publishes the
// running row (cp.async.wait_group, the copy, then __syncwarp for thread
// 0), and one after the task's stores.  A noop
// row that waits or signals (a join of the event graph: granite's
// busiest worker runs 1,919 of them and 2 tasks) has no task, so warp 0
// runs it alone, thread 0 waiting and signalling, and the other warps
// wait at the next task row's barrier.
// Offsets are int64: a full-width heap holds 11.85 G words.
//
// Across CTAs, tasks synchronise through the event counters in the heap
// (descriptor words 32-34), whatever the row's kind, noops included:
//   wait   (word 32 >= 0): before the task's first load, thread 0 spins
//          with ld.acquire.gpu until the counter reaches the trigger
//          count (word 33), bounded by a %globaltimer deadline past which
//          the fault goes into the worker's counter block and the kernel
//          traps; then __syncthreads() (no fence: wait_event says why);
//   signal (word 34 >= 0): after the task's stores, __syncthreads(), then
//          thread 0's red.release.gpu adds 1 to the counter.
// Every load of data another CTA may write in the launch is a plain
// coherent load; only the matmul's weights (written by no task) go
// through the non-coherent path.  The trace ring, when on, takes one
// tick (an atomicAdd on the counter at the ring's head) after the wait
// and one after the stores, before the signal, so that a waiter's start
// always follows its signallers' ends, and writes one 8-word record per
// slot.  The ring has a record for every grid slot, pads included, so a
// traced launch walks the whole grid (the wrapper passes no lists): its
// records, ticks and order are the full walk's, and a traced run stays
// a correctness run of everything but the compaction.  Every primary
// tile is read on demand through the descriptor's addresses (words 28-30 describe the same tile); the prefetch plan
// (words 24-27) is read and ignored: it assumes that workers stay within
// one step of each other, which the card does not give.  Stores write
// only the valid columns, rounded up to STORE_CH chunks and capped at TN,
// as the reference's masked stores do.
//
// Bound: at full width a decode step is bound by its weight bytes.
// deepseek-7b (30 layers, d = 4096, d_ff = 11008, vocab 102400) reads
// about 6.49 G float32 weight elements per step, 25.96 GB, so the bound on
// an H100 (3.35 TB/s) is about 7.75 ms.  The matmul is a GEMV (TM = 2
// rows): the rows of x are staged whole in shared memory, threads own
// 4-column groups of the output and stream K with 16-byte weight loads
// 8-16 deep, reading weight rows that are contiguous along N so a warp's
// loads coalesce; narrow tiles split K across thread groups and reduce
// through shared memory.  Attention splits each (row, head)'s cache
// positions across warps and merges their online-softmax states.  One
// CTA keeps one SM's worth of loads in flight, so the W workers (one per
// SM) are what bring the weight stream towards the card's rate.
//
// Dynamic scheduler (a plan with the DYN static; protocol in
// repro_torch/runtime/dyn_sched.py).  The table is flat, one row per task
// in linearized order, and no CTA knows its tasks in advance: each loops
//   pop -> wait check -> task -> signal-and-enqueue
// until every one of the T tasks has run, which it reads off the ticket
// (a port-only control word that every completed task fetch-and-adds).
//   pop    one warp scans the CTA's own 128-word pool (four words a lane,
//          then a shuffle-min) and claims the minimum row id with a
//          compare-and-swap of the word's bits (row -> QUEUE_EMPTY; row
//          ids are exact in float32); a lost race rescans.  Meanwhile the
//          other threads read all W + 1 [pushed, popped] cursor pairs in
//          one coalesced pass.  With its own pool empty the CTA scans the
//          overflow queue if its occupancy is positive, else the first
//          victim in (w + k) % W order whose occupancy is positive.  The
//          cursors lag the slots (they are added after the slot's CAS),
//          so they only choose where to scan: the scan decides.  A poll
//          that claims nothing backs off (__nanosleep) and polls again,
//          under the same %globaltimer deadline as an event wait (no pop
//          for that long traps, with the fault in the counter block).
//   wait   the popped task's event was fully triggered before it was
//          pushed, so thread 0's acquire load must already see the
//          trigger count; anything else counts a violation (which must
//          stay 0) and falls back to the bounded spin.
//   signal after the task's stores: __syncthreads(), __threadfence(),
//          then old = atomicAdd(counter, 1).  Only the producer that sees
//          old + 1 == trigger pushes the event's consumers (the scheduler
//          table), one consumer per thread, each thread fencing before it
//          CASes QUEUE_EMPTY -> row into the first empty slot of the
//          consumer's affinity pool (descriptor word 35), or of the
//          overflow queue when that pool is full.
// The pop trace and the trace ring are indexed by the ticket, not a grid
// slot (under concurrency slots are no sequence): they list the tasks in
// the order they completed.  Their entries past T stay as the executor
// wrote them at upload.  The descriptor row is
// loaded after the claim: nothing can be fetched ahead.  Each scheduler
// is its own instantiation of the kernel (a template on DYN), so that the
// dynamic loop's state takes no registers from the static loop's tasks.
//
// MoE (kinds 9-11).  The router top-k runs one warp per token row over
// the E <= 128 expert columns (4 a lane): TOPK rounds of a warp argmax
// that takes the lowest column among equal values (the reference's
// first-hit rule), a softmax over the chosen values, zeros elsewhere.
// The expert GEMM is the matmul's GEMV pass over one expert's weights,
// with the rows of x staged times the router mask (weight > 0, as the
// reference masks: a weight that underflowed to 0 masks its row) and, for
// the fused (E, D, 2, F) GLU weights, a second pass over the up half
// whose epilogue multiplies into the stored act(gate).  Like the
// reference it reads every expert's weights whether or not a token chose
// the expert, so its bound is every expert's bytes.  The combine sums
// expert_out[e] * router[:, e] in the order e = 0..E-1.  The kinds are
// compiled only into the extended instantiations of the kernel (a
// template on the variant EXT: 0 dense, 1 extended, 2 full), with the
// matmul's tail pass for a store width that is not a whole number of
// float4 groups (granite's odd vocabulary makes the masked-store chunk 1
// column); the host picks them for a plan with a top-k (TOPK > 0) or such
// a chunk, so the dense kernels keep the code and registers they had.
//
// Mamba2 (kinds 12-13).  The SSD state update (`k_ssm` at kernel.py:959)
// is bound by its state tile, read and written once: per (row, head) a
// (HD_SSM, N) float32 tile in the heap, 2 * 80 * 64 * 128 floats a layer
// at mamba2-2.7b's width (5.2 MB each way).  The tile is streamed from
// device memory, never staged: a group of lanes owns one state row (a
// lane per float4 of N, 32 lanes at N = 128, 4 at N = 16, so a warp holds
// 32 / lanes rows), updates it in registers, writes it back in place and
// reduces y = state . C + D * x over its lanes with __shfl_xor_sync; the
// 16 warps take the m * NH_TILE * HD_SSM rows of the task in turn.  The
// causal conv step (`k_conv` at :998) is a thread per (row, channel) that
// shifts its column of the (W, n) window in place (pure copies, so the
// window equals the plain version's bitwise) and sums the taps in the
// reference's order, bias first.  Both are compiled only into the full
// instantiations (EXT 2: every kind), and not inlined, so that their
// registers stay out of the matmul's allocation; the host picks the full
// kernel for a plan with either kind, so the dense and the extended
// kernels keep the code and registers they had.
//
// Tensor parallelism (kinds 14-15).  A plan stamped for C chips over the
// fused transport (repro_torch/megakernel/desc.py `stamp_multichip`) runs
// C * W CTAs over one heap holding C copies of the tensor region; every
// ALLREDUCE is a chunked ring of 4C - 3 grid steps.  The send (14) copies
// m rows of a window of d[3] words from its chip's output (d[6], row
// stride d[7]) into the peer chip's packed staging buffer (d[4], d[5]),
// then signals the peer's arrival event through the word-34 path; the
// all-reduce chunk (15) combines a staged window into its chip's output
// by mode d[14]: 0 the owner-masked init (the source inside the owned
// window [d[15], d[15] + d[16]), else 0), 1 accumulate (dst + src), 2
// store.  Both are bound by a few KB of copies: a thread per word with
// scalar loads and stores (the windows start at any column), the source
// read through the coherent path (another CTA wrote it in this launch).
// Unlike the reference's 256-word blocks, which write back whole blocks
// and restore the words past the window, only the window is read and
// written: on the card other lanes may store the neighbouring words at
// the same time.  Ordering: a send's stores are released by the
// signal's __syncthreads() (every thread's stores) and thread 0's
// release add; a receive waits on word 32 with the acquire spin.  A
// (chip, phase) staging buffer holds one chunk and the C - 1 rounds of
// a phase reuse it, so the chips may not run more than one round apart:
// each arrival adds one to a port-only counter after its reads (the
// plan's side table `acks`: counter, count per row), and a send of round
// r >= 1 first spins until the receiver's counter reaches r.  The kinds
// and the guard are compiled only into the multichip instantiation
// (static only, EXT 3: every kind), so the other kernels keep their code
// and registers.
//
// Numerics follow the reference in float32: no TF32, no fast math, GELU
// in its tanh form.  A task's arithmetic does not depend on W, so the
// outputs are bitwise equal across W.
//
// Built by repro_torch/megakernel/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cstdio>

extern __shared__ __align__(16) unsigned char smem_raw[];

namespace {

constexpr int NT = 512;            // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int RP = 2;              // matmul output rows per pass
constexpr int VEC = 4;             // floats per weight load (float4)
constexpr int HPL = 8;             // attention head elements per lane
constexpr int DESC_WORDS = 36;
constexpr int STATS_WORDS = 12;
constexpr int RING = 4;            // descriptor rows staged ahead (static)
constexpr int ROW_BYTES = DESC_WORDS * 8;
constexpr int ROW_CHUNKS = ROW_BYTES / 16;   // 16-byte copies a row
constexpr int SCAL_BYTES = 96;     // block-reduction words
// the running descriptor row, the ring of staged rows, the reduction words
constexpr int HEAD_BYTES = (RING + 1) * ROW_BYTES + SCAL_BYTES;
constexpr int TRACE_HEADER = 8;
constexpr int TRACE_WORDS = 8;
constexpr long long ROW_SPILL = 1LL << 20;
constexpr int QCAP = 128;          // words of one ready pool
constexpr float QUEUE_EMPTY = 1.0e9f;
constexpr float QTH = QUEUE_EMPTY * 0.5f;  // below: a row id
// the code mk_launch returns for a grid that cannot be co-resident
constexpr int ERR_NOT_RESIDENT = static_cast<int>(
    cudaErrorCooperativeLaunchTooLarge);

struct Statics {
  long long tn;          // tile width TN
  long long tk;          // matmul depth bound TK
  long long hd;          // head_dim
  long long g;           // query heads per KV head
  long long store_ch;    // masked-store chunk width
  long long stats_off;   // heap offset of the per-worker counter blocks
  long long event_off;   // heap offset of the event counters
  long long tr_off;      // heap offset of the trace ring, -1: no ring
  long long spin_ns;     // deadline of one event wait
  float theta;           // RoPE base
  long long ng;          // most KV groups of an attention tile
  // the reference's chunking, for the transfer counts: TKC-deep matmul
  // chunks (KCH of them) and TS-row attention chunks (SCH of them)
  int tkc, kch, ts, sch;
  // dynamic scheduler (dyn == 0: the static grid)
  long long dyn;
  const int* sched;      // (events, sched_w) [trigger, n_out, consumers]
  long long sched_w;
  long long qoff;        // heap offset of the pools, then the overflow
  long long ov_words;    // words of the overflow queue
  long long qc_off;      // heap offset of the W + 1 [pushed, popped] pairs
  long long pt_off;      // heap offset of the pop trace
  long long ctl_off;     // heap offset of the ticket
  long long n_tasks;     // T: pops that end the launch
  long long topk;        // experts a token row routes to (kind 9)
  // Mamba2 (kinds 12-13): SSD head width, state width N, the heads of one
  // kind-12 tile, conv taps
  long long hd_ssm, n_ssm, nh_tile, w_conv;
  // a multichip plan's (rows, 2) side table: per row the heap offset of
  // an arrival counter (-1: none) and, for a send, the count to wait for
  const long long* acks;
  // M-RoPE (kind 3 rows with word 15 = 1): the widths of the temporal,
  // height and width sections of the rotary half (all 0: plain RoPE)
  long long mrope[3];
};

// Dynamic shared memory: [the running descriptor row | RING staged rows
// (static) | block-reduction words] [matmul partial sums: RP * NT * VEC]
// [matmul x rows: RP * TK, which doubles as the attention merge scratch].
struct Smem {
  long long* d;
  long long* ring;
  float* scal;
  float* red;
  float* x;
};

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

// Columns a store writes: `valid` rounded up to whole chunks, capped at TN.
__device__ __forceinline__ long long store_width(long long valid,
                                                 const Statics& S) {
  if (valid <= 0) return 0;
  const long long chw = lmin(S.store_ch, S.tn);
  return lmin(S.tn, (valid + chw - 1) / chw * chw);
}

__device__ __forceinline__ float word_f32(long long w) {
  return __int_as_float(static_cast<int>(w));
}

__device__ __forceinline__ float act(float y, long long id) {
  if (id == 1) return y / (1.0f + expf(-y));                   // silu
  if (id == 2) {                                               // gelu-tanh
    const float c = 0.7978845608028654f;                       // sqrt(2/pi)
    return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  return y;
}

// Acquire load at GPU scope: the loads that follow it (after the CTA's
// barrier) see every store released before the value it read.
__device__ __forceinline__ float ld_acquire(const float* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return __uint_as_float(v);
}

// Relaxed load at GPU scope: a word other CTAs update in this launch.
__device__ __forceinline__ float ld_relaxed(const float* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return __uint_as_float(v);
}

// Add `v` to a counter with release semantics at GPU scope (thread 0,
// after the CTA's barrier): the signal of an event or an arrival.
__device__ __forceinline__ void red_release(float* p, float v) {
  asm volatile("red.release.gpu.global.add.f32 [%0], %1;"
               :: "l"(p), "f"(v) : "memory");
}

// One 16-byte copy from global to shared memory that completes
// asynchronously (through L2 only), its commit group, and the wait until
// at most N of the calling thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ bool cas_word(float* p, float expect,
                                         float value) {
  const unsigned e = __float_as_uint(expect);
  return atomicCAS(reinterpret_cast<unsigned*>(p), e,
                   __float_as_uint(value)) == e;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that outlived its deadline: the lowering or the launch is wrong.
// The fault goes into the worker's counter block (word 6 +1, words 8-11:
// row, event, counter seen, -1) and the kernel traps, so that the next
// synchronisation on the host raises instead of hanging.
__device__ __noinline__ void spin_fault(float* heap, const Statics& S,
                                        long long w, long long row,
                                        long long ev, float seen,
                                        long long want) {
  float* st = heap + S.stats_off + w * STATS_WORDS;
  st[6] += 1.0f;
  st[8] = static_cast<float>(row);
  st[9] = static_cast<float>(ev);
  st[10] = seen;
  st[11] = -1.0f;
  __threadfence_system();
  printf("megakernel: worker %lld row %lld waited past its deadline on "
         "event %lld (counter %.0f of %lld)\n", w, row, ev, seen, want);
  __trap();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the CTA; every thread gets the total.
__device__ float block_sum(float v, float* scal) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scal[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < NWARP ? scal[threadIdx.x & 31] : 0.0f;
  return warp_sum(v);
}

// ---- kind 1: out[m, ws] = act(x[m, K] @ W[K, ws] + bias) ---------------
// One pass over RP rows of x (staged in shared memory).  Thread (ks, jt)
// owns CPT float4 column groups and the K rows ks, ks + nks, ...; the
// weights are read-only for the whole launch, so they stream through the
// non-coherent load path.  MUL_OUT (the expert GEMM's up pass): the
// epilogue multiplies the sum into the output already stored, with no
// bias and no activation.
template <int CPT, int UNROLL, bool MUL_OUT = false>
__device__ void mm_pass(float* heap, const long long* d, long long r0,
                        int rp, long long K, long long ncg, const Smem& sm) {
  const int tid = threadIdx.x;
  const int ct = static_cast<int>(lmin(NT, (ncg + 31) / 32 * 32));
  const int nks = NT / ct;
  const int ks = tid / ct, jt = tid % ct;
  float acc[RP][CPT][VEC];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][c][e] = 0.0f;
  if (ks < nks) {
    const long long ld4 = d[9] / VEC;
    const float4* wp = reinterpret_cast<const float4*>(heap + d[8])
                       + ks * ld4 + jt;
    const long long step = static_cast<long long>(nks) * ld4;
    bool live[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) live[c] = jt + c * ct < ncg;
#pragma unroll (UNROLL)
    for (long long k = ks; k < K; k += nks) {
      float4 w[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        w[c] = live[c] ? __ldg(wp + c * ct) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const float xv = sm.x[r * K + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[r][c][0] = fmaf(xv, w[c].x, acc[r][c][0]);
          acc[r][c][1] = fmaf(xv, w[c].y, acc[r][c][1]);
          acc[r][c][2] = fmaf(xv, w[c].z, acc[r][c][2]);
          acc[r][c][3] = fmaf(xv, w[c].w, acc[r][c][3]);
        }
      }
      wp += step;
    }
  }
  if (nks > 1) {                        // then CPT == 1: reduce K slices
    if (ks < nks)
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm.red[((ks * RP + r) * ct + jt) * VEC + e] = acc[r][0][e];
    __syncthreads();
    if (ks == 0)
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float s = 0.0f;
          for (int q = 0; q < nks; ++q)
            s += sm.red[((q * RP + r) * ct + jt) * VEC + e];
          acc[r][0][e] = s;
        }
  }
  if (ks == 0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long long grp = jt + static_cast<long long>(c) * ct;
      if (grp >= ncg) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const long long j = grp * VEC + e;
        if constexpr (MUL_OUT) {
#pragma unroll
          for (int r = 0; r < RP; ++r)
            if (r < rp) {
              float* o = heap + d[4] + (r0 + r) * d[5] + j;
              *o = *o * acc[r][c][e];
            }
        } else {
          const float bias = d[10] >= 0 ? heap[d[10] + j] : 0.0f;
#pragma unroll
          for (int r = 0; r < RP; ++r)
            if (r < rp)
              heap[d[4] + (r0 + r) * d[5] + j] =
                  act(acc[r][c][e] + bias, d[14]);
        }
      }
    }
  }
}

// The last columns [c0, ws) of a store width that is not a whole number
// of float4 groups (a tile whose width the STORE_CH chunks do not round
// to 4, as the last tile of an odd vocabulary): one warp a (row, column),
// its lanes striding K, for at most RP * (VEC - 1) dot products.
__device__ void mm_tail(float* heap, const long long* d, long long r0,
                        int rp, long long K, long long c0, long long ws,
                        const Smem& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long pairs = rp * (ws - c0);
  for (long long p = wid; p < pairs; p += NWARP) {
    const long long r = p / (ws - c0), j = c0 + p % (ws - c0);
    float acc = 0.0f;
    for (long long k = lane; k < K; k += 32)
      acc = fmaf(sm.x[r * K + k], __ldg(heap + d[8] + k * d[9] + j), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const float bias = d[10] >= 0 ? heap[d[10] + j] : 0.0f;
      heap[d[4] + (r0 + r) * d[5] + j] = act(acc + bias, d[14]);
    }
  }
}

// Float4 column groups one mm_pass takes: 2 a thread, 4096 columns.
constexpr long long MM_GROUPS = 2 * NT;

// A matmul tile wider than one pass (gemma-7b's tied head: 5376 columns)
// as passes over column ranges of equal width, each at least NT groups
// wide, so that every pass keeps K whole (nks = 1: each column sums k =
// 0, 1, ... in order) and needs no reduction scratch, all on the x rows
// staged once.  Each pass runs the one-pass code on a copy of the words
// it reads (4, 5, 8, 9, 10, 14) with the output, weight and bias columns
// moved to the pass's first column, as the expert GEMM rewrites them.
__device__ void mm_wide(float* heap, const long long* d, long long r0,
                        int rp, long long K, long long ncg, const Smem& sm) {
  __shared__ long long dd[16];
  const long long passes = (ncg + MM_GROUPS - 1) / MM_GROUPS;
  const long long pw = (ncg + passes - 1) / passes;
  for (long long g0 = 0; g0 < ncg; g0 += pw) {
    __syncthreads();                    // the last pass has read dd
    if (threadIdx.x == 0) {
      const long long c0 = g0 * VEC;
      dd[4] = d[4] + c0;
      dd[5] = d[5];
      dd[8] = d[8] + c0;
      dd[9] = d[9];
      dd[10] = d[10] >= 0 ? d[10] + c0 : -1;
      dd[14] = d[14];
    }
    __syncthreads();
    mm_pass<2, 8>(heap, dd, r0, rp, K, lmin(pw, ncg - g0), sm);
  }
}

// EXT: the tail pass for the columns past the whole float4 groups;
// without it the store width is a whole number of groups (the host picks
// the EXT kernel otherwise).  WIDE: tiles wider than one pass (mm_wide),
// compiled only into the wide instantiations (the host picks them for a
// plan with such a tile), so that the others keep their code.
template <bool EXT, bool WIDE = false>
__device__ void k_matmul(float* heap, const long long* d, const Statics& S,
                         const Smem& sm) {
  const long long m = d[1], K = d[3];
  const long long ws = store_width(d[2], S);
  if (ws <= 0 || m <= 0) return;
  const long long ncg = ws / VEC;
  for (long long r0 = 0; r0 < m; r0 += RP) {
    const int rp = static_cast<int>(lmin(RP, m - r0));
    __syncthreads();                    // x and red are free
    for (int r = 0; r < RP; ++r)
      for (long long k = threadIdx.x; k < K; k += NT)
        sm.x[r * K + k] = r < rp ? heap[d[6] + (r0 + r) * d[7] + k] : 0.0f;
    __syncthreads();
    if constexpr (EXT) {
      if (ncg > 0) {
        if (ncg <= NT) mm_pass<1, 16>(heap, d, r0, rp, K, ncg, sm);
        else mm_pass<2, 8>(heap, d, r0, rp, K, ncg, sm);
      }
      if (ncg * VEC < ws) mm_tail(heap, d, r0, rp, K, ncg * VEC, ws, sm);
    } else if constexpr (WIDE) {
      if (ncg <= NT) mm_pass<1, 16>(heap, d, r0, rp, K, ncg, sm);
      else if (ncg <= MM_GROUPS) mm_pass<2, 8>(heap, d, r0, rp, K, ncg, sm);
      else mm_wide(heap, d, r0, rp, K, ncg, sm);
    } else {
      if (ncg <= NT) mm_pass<1, 16>(heap, d, r0, rp, K, ncg, sm);
      else mm_pass<2, 8>(heap, d, r0, rp, K, ncg, sm);
    }
  }
}

// ---- kind 2: out = x * rsqrt(mean(x^2) + eps) * (w or 1 + w) ------------
__device__ void k_rmsnorm(float* heap, const long long* d, const Statics& S,
                          const Smem& sm) {
  const long long m = d[1], n = d[2];
  const long long ws = store_width(n, S);
  const float eps = word_f32(d[17]);
  const bool gemma = d[14] == 1;
  for (long long r = 0; r < m; ++r) {
    const float* x = heap + d[6] + r * d[7];
    float ss = 0.0f;
    for (long long j = threadIdx.x; j < n; j += NT) ss += x[j] * x[j];
    ss = block_sum(ss, sm.scal);
    const float inv = rsqrtf(ss / static_cast<float>(n) + eps);
    for (long long j = threadIdx.x; j < ws; j += NT) {
      float y = 0.0f;
      if (j < n) {
        const float w = heap[d[10] + j];
        y = x[j] * inv * (gemma ? 1.0f + w : w);
      }
      heap[d[4] + r * d[5] + j] = y;
    }
  }
}

// ---- kind 3: rotate-half RoPE of each head at angle pos * theta^(-i/half)
// With word 15 = 1 (M-RoPE) the positions are a (rows, 3) tile at word 19
// with row stride word 20, and rotary element ii takes column si, the
// section (S.mrope) that holds ii: temporal, height or width.
__device__ void k_rope(float* heap, const long long* d, const Statics& S) {
  const long long m = d[1];
  const long long ws = store_width(d[2], S);
  const long long hd = S.hd, half = S.hd / 2, nh = S.tn / S.hd;
  const bool mrope = d[15] == 1;
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws, h = j / hd, e = j % hd;
    float y = 0.0f;
    if (h < nh) {
      const long long ii = e < half ? e : e - half;
      const long long si = !mrope ? 0
                           : ii < S.mrope[0] ? 0
                           : ii < S.mrope[0] + S.mrope[1] ? 1 : 2;
      const float pos = heap[d[19] + r * d[20] + si];
      const float f = powf(S.theta, -static_cast<float>(ii)
                                        / static_cast<float>(half));
      const float ang = pos * f;
      const float c = cosf(ang), s = sinf(ang);
      const float* x = heap + d[6] + r * d[7] + h * hd;
      const float x1 = x[ii], x2 = x[ii + half];
      y = e < half ? x1 * c - x2 * s : x2 * c + x1 * s;
    }
    heap[d[4] + r * d[5] + j] = y;
  }
}

// ---- kind 4: out = act(a) * b --------------------------------------------
__device__ void k_glu(float* heap, const long long* d, const Statics& S) {
  const long long m = d[1];
  const long long ws = store_width(d[2], S);
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    heap[d[4] + r * d[5] + j] =
        act(heap[d[6] + r * d[7] + j], d[14]) * heap[d[8] + r * d[9] + j];
  }
}

// ---- kind 5: out = a * scale + b (b absent: scale only) -----------------
__device__ void k_resid(float* heap, const long long* d, const Statics& S) {
  const long long m = d[1];
  const long long ws = store_width(d[2], S);
  const float scale = word_f32(d[17]);
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    float y = heap[d[6] + r * d[7] + j] * scale;
    if (d[8] >= 0) y = y + heap[d[8] + r * d[9] + j];
    heap[d[4] + r * d[5] + j] = y;
  }
}

// ---- kind 6: GQA decode attention ----------------------------------------
// Each (row, query head) pair gets `nsplit` warps; warp j runs an online
// softmax over the live cache positions j, j + nsplit, ... (lanes hold
// head elements), then the warps' (max, sum, acc) states are merged
// through shared memory.
__device__ void k_attn(float* heap, const long long* d, const Statics& S,
                       const Smem& sm) {
  const long long m = d[1], s_len = d[3];
  const long long ws = store_width(d[2], S);
  const long long hd = S.hd, heads = d[16] * S.g;
  const float scale = word_f32(d[17]);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    if (j >= heads * hd) heap[d[4] + r * d[5] + j] = 0.0f;
  }
  const long long npairs = m * heads;
  if (npairs <= 0) return;
  const int nsplit = npairs >= NWARP ? 1 : NWARP / static_cast<int>(npairs);
  const int per_round = NWARP / nsplit;
  float* part = sm.x;                   // NWARP states of (hd + 2) words
  for (long long p0 = 0; p0 < npairs; p0 += per_round) {
    const long long p = p0 + wid / nsplit;
    const int split = wid % nsplit;
    const bool active = wid < per_round * nsplit && p < npairs;
    float mrun = -1e30f, l = 0.0f, o[HPL];
#pragma unroll
    for (int e = 0; e < HPL; ++e) o[e] = 0.0f;
    if (active) {
      const long long r = p / heads, qh = p % heads, gi = qh / S.g;
      const long long live = lmin(static_cast<long long>(heap[d[12] + r]),
                                  s_len);
      const float* qp = heap + d[6] + r * d[7] + qh * hd;
      const float* kp = heap + d[8] + r * d[15] + gi * hd;
      const float* vp = heap + d[10] + r * d[15] + gi * hd;
      float q[HPL];
#pragma unroll
      for (int e = 0; e < HPL; ++e) {
        const long long c = lane + 32 * e;
        q[e] = c < hd ? qp[c] * scale : 0.0f;
      }
      for (long long s = split; s < live; s += nsplit) {
        float part_dot = 0.0f, v[HPL];
#pragma unroll
        for (int e = 0; e < HPL; ++e) {
          const long long c = lane + 32 * e;
          v[e] = c < hd ? vp[s * d[11] + c] : 0.0f;
          if (c < hd) part_dot = fmaf(kp[s * d[9] + c], q[e], part_dot);
        }
        const float logit = warp_sum(part_dot);
        const float mnew = fmaxf(mrun, logit);
        const float corr = expf(mrun - mnew), pe = expf(logit - mnew);
        l = l * corr + pe;
#pragma unroll
        for (int e = 0; e < HPL; ++e) o[e] = o[e] * corr + pe * v[e];
        mrun = mnew;
      }
    }
    float* ps = part + wid * (hd + 2);
    if (active) {
      if (lane == 0) { ps[0] = mrun; ps[1] = l; }
#pragma unroll
      for (int e = 0; e < HPL; ++e)
        if (lane + 32 * e < hd) ps[2 + lane + 32 * e] = o[e];
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < per_round * hd; i += NT) {
      const long long pi = i / hd, c = i % hd, pp = p0 + pi;
      if (pp >= npairs) continue;
      const float* base = part + pi * nsplit * (hd + 2);
      float mx = -1e30f;
      for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, base[j * (hd + 2)]);
      float num = 0.0f, den = 0.0f;
      for (int j = 0; j < nsplit; ++j) {
        const float* sj = base + j * (hd + 2);
        const float wgt = expf(sj[0] - mx);
        num += wgt * sj[2 + c];
        den += wgt * sj[1];
      }
      const long long r = pp / heads, qh = pp % heads;
      if (qh * hd + c < ws)
        heap[d[4] + r * d[5] + qh * hd + c] = num / fmaxf(den, 1e-30f);
    }
    __syncthreads();
  }
}

// ---- kind 7: write each new K/V row at cache row seq_lens[r] -------------
__device__ void k_cache_update(float* heap, const long long* d,
                               const Statics& S) {
  const long long m = d[1];
  const long long ws = store_width(d[2], S);
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    const long long seq = static_cast<long long>(heap[d[12] + r]);
    heap[d[4] + r * d[15] + seq * d[5] + j] = heap[d[6] + r * d[7] + j];
  }
}

// ---- kind 8: embedding rows by token id ----------------------------------
__device__ void k_embed(float* heap, const long long* d, const Statics& S) {
  const long long m = d[1];
  const long long ws = store_width(d[2], S);
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    const long long tok = static_cast<long long>(heap[d[6] + r]);
    heap[d[4] + r * d[5] + j] = heap[d[8] + tok * d[9] + j];
  }
}

// ---- kind 9: router logits -> dense top-k softmax weights --------------
// One warp per row; lane l holds expert columns l, l + 32, l + 64, l + 96.
constexpr int TOPK_CPL = 4;            // columns a lane: E <= 128

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ void k_softmax_topk(float* heap, const long long* d,
                               const Statics& S) {
  const long long m = d[1], n = d[2];
  const long long ws = store_width(n, S);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (long long r = wid; r < m; r += NWARP) {
    const float* x = heap + d[6] + r * d[7];
    float v[TOPK_CPL], orig[TOPK_CPL];
    unsigned chosen = 0;
#pragma unroll
    for (int c = 0; c < TOPK_CPL; ++c) {
      const long long col = lane + 32 * c;
      orig[c] = col < n ? x[col] : neg_inf();
      v[c] = orig[c];
    }
    float top = 0.0f, sum = 0.0f;
    for (long long i = 0; i < S.topk; ++i) {
      // this lane's first maximum, then the warp's: the larger value, or
      // on equal values the lower column
      float best = v[0];
      int at = lane;
#pragma unroll
      for (int c = 1; c < TOPK_CPL; ++c)
        if (v[c] > best) { best = v[c]; at = lane + 32 * c; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, at, o);
        if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
      }
      if ((at & 31) == lane) {
        v[at >> 5] = neg_inf();
        chosen |= 1u << (at >> 5);
      }
      if (i == 0) top = best;           // the largest chosen value
      sum += expf(best - top);
    }
#pragma unroll
    for (int c = 0; c < TOPK_CPL; ++c) {
      const long long col = lane + 32 * c;
      if (col < ws)
        heap[d[4] + r * d[5] + col] =
            (chosen >> c) & 1u ? expf(orig[c] - top) / sum : 0.0f;
    }
    for (long long col = 32 * TOPK_CPL + lane; col < ws; col += 32)
      heap[d[4] + r * d[5] + col] = 0.0f;
  }
}

// ---- kind 10: one expert's GEMM over the rows its router weight keeps ----
// out[m, ws] = (x * mask) @ W, or with the fused GLU weights
// act((x * mask) @ Wg) * ((x * mask) @ Wu): the matmul's pass with the
// descriptor words it reads (4, 5, 8, 9, 10, 14) rewritten in shared
// memory, once over Wg (word 8) and once over Wu (word 19).
__device__ void k_moe_gg(float* heap, const long long* d, const Statics& S,
                         const Smem& sm) {
  __shared__ long long dd[16];
  const long long m = d[1], K = d[3];
  const long long ws = store_width(d[2], S);
  if (ws <= 0 || m <= 0) return;
  const long long ncg = ws / VEC;      // ws % VEC == 0: checked at load
  const bool glu = d[15] == 1;
  for (long long r0 = 0; r0 < m; r0 += RP) {
    const int rp = static_cast<int>(lmin(RP, m - r0));
    __syncthreads();                    // x, red and dd are free
    if (threadIdx.x == 0) {
      dd[4] = d[4]; dd[5] = d[5]; dd[8] = d[8]; dd[9] = d[9];
      dd[10] = -1;                      // no bias
      dd[14] = glu ? d[14] : 0;         // a plain expert GEMM: no act
    }
    for (int r = 0; r < RP; ++r) {
      const float mask =
          r < rp && heap[d[10] + (r0 + r) * d[11]] > 0.0f ? 1.0f : 0.0f;
      for (long long k = threadIdx.x; k < K; k += NT)
        sm.x[r * K + k] =
            r < rp ? heap[d[6] + (r0 + r) * d[7] + k] * mask : 0.0f;
    }
    __syncthreads();
    if (ncg <= NT) mm_pass<1, 16>(heap, dd, r0, rp, K, ncg, sm);
    else mm_pass<2, 8>(heap, dd, r0, rp, K, ncg, sm);
    if (glu) {
      __syncthreads();                  // red is free, act(gate) stored
      if (threadIdx.x == 0) dd[8] = d[19];
      __syncthreads();
      if (ncg <= NT) mm_pass<1, 16, true>(heap, dd, r0, rp, K, ncg, sm);
      else mm_pass<2, 8, true>(heap, dd, r0, rp, K, ncg, sm);
    }
  }
}

// ---- kind 11: out = sum_e expert_out[e] * router[:, e], e = 0..E-1 -------
__device__ void k_moe_combine(float* heap, const long long* d,
                              const Statics& S) {
  const long long m = d[1], n_exp = d[3];
  const long long ws = store_width(d[2], S);
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    const float* eo = heap + d[6] + r * d[7] + j;
    const float* rw = heap + d[10] + r * d[11];
    float acc = 0.0f;
    for (long long e = 0; e < n_exp; ++e) acc += eo[e * d[15]] * rw[e];
    heap[d[4] + r * d[5] + j] = acc;
  }
}

// ---- kind 12: Mamba2 SSD state update, NH_TILE heads of m rows --------
// For row r and head h of the tile, with dt = softplus(dt_raw[r, h]) and
// dA = exp(-dt * exp(A_log[h])): state[r, h] <- state[r, h] * dA + (dt *
// x[r, h]) (x) B[r], then y[r, h] = state[r, h] . C[r] + D[h] * x[r, h].
// Descriptor words: x at 6/7, the state tile at 8 with row stride 9, row
// (batch) stride 15 and head stride 16, dt at 10/11, A_log at 12, B at
// 19/20, C at 21/22, D at 23 (< 0: none), y at 4/5.
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The statics it needs come by value (`ws` the store width): a reference
// to the kernel's parameters would put them in local memory.
__device__ __noinline__ void k_ssm(float* heap, const long long* d,
                                   long long ws, long long hds,
                                   long long nht, long long n_ssm) {
  const long long m = d[1];
  const long long n4 = n_ssm / VEC;
  // lanes a state row: the least power of two >= N / 4, at most 32
  int lpr = 1;
  while (lpr < 32 && lpr < n4) lpr <<= 1;
  const int sub = threadIdx.x % lpr;
  const long long groups = NT / lpr, g0 = threadIdx.x / lpr;
  const long long total = m * nht * hds;
  // every thread runs the same number of rounds: the shuffles need the
  // whole warp
  for (long long u0 = 0; u0 < total; u0 += groups) {
    const long long u = u0 + g0;
    const bool live = u < total;
    const long long r = live ? u / (nht * hds) : 0;
    const long long hh = live ? (u / hds) % nht : 0;
    const long long p = live ? u % hds : 0;
    float acc = 0.0f, xv = 0.0f;
    if (live) {
      const float dt = softplus_f(heap[d[10] + r * d[11] + hh]);
      const float da = expf(dt * -expf(heap[d[12] + hh]));
      xv = heap[d[6] + r * d[7] + hh * hds + p];
      const float dtx = dt * xv;
      float4* st = reinterpret_cast<float4*>(
          heap + d[8] + r * d[15] + hh * d[16] + p * d[9]);
      const float4* bv = reinterpret_cast<const float4*>(
          heap + d[19] + r * d[20]);
      const float4* cv = reinterpret_cast<const float4*>(
          heap + d[21] + r * d[22]);
      for (long long q = sub; q < n4; q += lpr) {
        float4 s = st[q];
        const float4 b = bv[q], c = cv[q];
        s.x = s.x * da + dtx * b.x;
        s.y = s.y * da + dtx * b.y;
        s.z = s.z * da + dtx * b.z;
        s.w = s.w * da + dtx * b.w;
        st[q] = s;
        acc += s.x * c.x + s.y * c.y + s.z * c.z + s.w * c.w;
      }
    }
    for (int o = lpr / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (live && sub == 0) {
      const float dsk = d[23] >= 0 ? heap[d[23] + hh] : 0.0f;
      heap[d[4] + r * d[5] + hh * hds + p] = acc + dsk * xv;
    }
  }
  for (long long i = threadIdx.x; i < m * ws; i += NT) {   // past the heads
    const long long r = i / ws, j = i % ws;
    if (j >= nht * hds) heap[d[4] + r * d[5] + j] = 0.0f;
  }
}

// ---- kind 13: causal depthwise conv step, m rows of n channels ----------
// window[r] <- [window[r][1:], x[r]] in place, y[r] = silu(bias + sum_j
// window[r][j] * w[j]).  Words: x at 6/7, the window at 8 with tap stride
// 9 and row stride 15, the taps w at 10/11, the bias at 12 (< 0: none),
// y at 4/5.
__device__ __noinline__ void k_conv(float* heap, const long long* d,
                                    long long ws, long long taps) {
  const long long m = d[1];
  for (long long i = threadIdx.x; i < m * ws; i += NT) {
    const long long r = i / ws, j = i % ws;
    float* win = heap + d[8] + r * d[15] + j;
    float y = d[12] >= 0 ? heap[d[12] + j] : 0.0f;
    for (long long t = 0; t < taps; ++t) {
      const float v = t + 1 < taps ? win[(t + 1) * d[9]]
                                   : heap[d[6] + r * d[7] + j];
      win[t * d[9]] = v;
      y = y + v * heap[d[10] + t * d[11] + j];
    }
    heap[d[4] + r * d[5] + j] = act(y, 1);
  }
}

// ---- kinds 14-15: the ring send and the all-reduce chunk ----------------
// m rows (word 1) of a window of d[3] words: source row d[6] + r * d[7],
// destination row d[4] + r * d[5].  Kind 14 and mode 2 copy, mode 1 adds
// the source to the destination, mode 0 keeps the source inside the owned
// window [d[15], d[15] + d[16]) and writes 0 elsewhere.
__device__ __noinline__ void k_comm(float* heap, const long long* d) {
  const long long m = d[1], nw = d[3];
  if (nw <= 0) return;
  const bool copy = d[0] == 14 || d[14] == 2, acc = !copy && d[14] == 1;
  const long long own0 = d[15], own1 = d[15] + d[16];
  for (long long i = threadIdx.x; i < m * nw; i += NT) {
    const long long r = i / nw, rel = i - r * nw;
    const float s = heap[d[6] + r * d[7] + rel];
    float* o = heap + d[4] + r * d[5] + rel;
    *o = copy ? s : acc ? *o + s : (rel >= own0 && rel < own1 ? s : 0.0f);
  }
}

// The counters thread 0 keeps for its worker and writes into the
// worker's block at the end of the launch (the same counts the plain
// version writes): tile transfers, rows in them, primary tiles
// demand-loaded, event waits, wait violations, event signals, and under
// the dynamic scheduler the pops from the own pool, from overflow, by
// steal, and the polls that found nothing to claim.  The transfers are
// counted off the tasks' path (count_rows, and thread 32 in dyn_loop).
// No initializers: the dynamic kernel keeps its counters in shared
// memory.
struct Counts {
  long long bulk, rows, fallbacks;
  long long waits, violations, signals;
  long long own, overflow, steals, idle;

  __device__ void zero() {
    bulk = rows = fallbacks = waits = violations = signals = 0;
    own = overflow = steals = idle = 0;
  }

  // One task's tile transfers as the reference's kernel counts its bulk
  // copies: the primary tile (demand-loaded), then the operands and
  // results (megakernel_plain's _operand_transfers), in closed form.
  // Reads only words of the heap that no task writes (its live lengths).
  __device__ void task(const long long* d, const float* heap,
                       const Statics& S) {
    const long long kind = d[0], m = d[1];
    if (kind == 0) return;
    long long n = 0, r = 0;
    if (d[30] > 0) { n = 1; r = d[30]; ++fallbacks; }
    switch (kind) {
      case 1: {                         // KCH chunks of TKC rows of K
        const int k = static_cast<int>(d[3]);
        const long long nb = k > 0 ? min(S.kch, (k + S.tkc - 1) / S.tkc) : 0;
        const long long bias = d[10] >= 0 ? 1 : 0;
        n += (S.kch - 1) + nb + bias + 1;
        r += (S.kch - 1) * m + min(k, S.kch * S.tkc) + bias + m;
        break;
      }
      case 10: {                        // router column, gate (and up)
        const int k = static_cast<int>(d[3]);
        const long long nb = k > 0 ? min(S.kch, (k + S.tkc - 1) / S.tkc) : 0;
        const long long nw = d[15] == 1 ? 2 : 1;
        n += 1 + (S.kch - 1) + nw * nb + 1;
        r += m + (S.kch - 1) * m + nw * min(k, S.kch * S.tkc) + m;
        break;
      }
      case 9: n += 1; r += m; break;
      case 11: n += 2 * d[3] + 1; r += 2 * d[3] * m + m; break;
      case 2: n += 2; r += 1 + m; break;
      case 3: case 4: n += 2; r += 2 * m; break;
      case 5: n += d[8] >= 0 ? 2 : 1; r += d[8] >= 0 ? 2 * m : m; break;
      case 6: {                         // SCH chunks of TS cache rows
        n += 1 + m;
        r += 1 + m;
        for (long long i = 0; i < m; ++i) {
          const int live = static_cast<int>(heap[d[12] + i]);
          if (live > 0) {
            n += 2 * S.ng * min(S.sch, (live + S.ts - 1) / S.ts);
            r += 2 * S.ng * min(live, S.sch * S.ts);
          }
        }
        break;
      }
      case 7: n += 1 + m; r += 1 + m; break;
      case 8: n += 2 * m; r += 2 * m; break;
      case 12: {                        // A_log, D; per row dt, B, C, the
        const long long dsk = d[23] >= 0 ? 1 : 0;   // heads' tiles, y
        n += 1 + dsk + m * (4 + 2 * S.nh_tile);
        r += 1 + dsk + m * (4 + 2 * S.nh_tile * S.hd_ssm);
        break;
      }
      case 13: {                        // taps, bias; per row the window
        const long long bias = d[12] >= 0 ? 1 : 0;  // in and out, y
        n += 1 + bias + 3 * m;
        r += S.w_conv + bias + m * (2 * S.w_conv + 1);
        break;
      }
    }
    bulk += n;
    rows += r;
  }

  __device__ void store(float* heap, const Statics& S, long long w) const {
    float* st = heap + S.stats_off + w * STATS_WORDS;
    st[0] = static_cast<float>(bulk);
    st[1] = static_cast<float>(rows % ROW_SPILL);
    st[2] = 0.0f;
    st[3] = static_cast<float>(fallbacks);
    st[4] = static_cast<float>(rows / ROW_SPILL);
    st[5] = static_cast<float>(waits);
    st[6] = static_cast<float>(violations);
    st[7] = static_cast<float>(signals);
    st[8] = static_cast<float>(own);
    st[9] = static_cast<float>(overflow);
    st[10] = static_cast<float>(steals);
    st[11] = static_cast<float>(idle);
  }
};

// Thread 0: wait until event `ev` reaches `want` signals, with acquire
// loads, bounded by the deadline.  Under the static scheduler a counter
// past its trigger count is a violation; under the dynamic one the count
// must already be there, since a consumer is pushed only once its event
// fully triggered.
//
// No fence follows the spin: the caller's __syncthreads() does, or for a
// noop row thread 0's own release (cumulative).  In the PTX memory model each producer's stores precede its thread 0's release
// add in causality order (program order, then the producer's barrier,
// which synchronises its threads at CTA scope).  The counter's adds are
// morally strong read-modify-writes at GPU scope, so the value this
// acquire load reads is observed through the chain of every earlier add,
// and each producer's release synchronises with the acquire.  The
// consumer's barrier orders the acquire before its threads' loads, and
// causality order is transitive, so every producer's stores precede
// those loads: they read the values stored or later ones.  The same
// pattern (barrier, thread 0's release; thread 0's acquire, barrier) is
// CUTLASS's inter-CTA semaphore.  The __threadfence() (fence.sc) that
// followed the spin, with the one before each signal's atomicAdd, made
// granite's walk about 1 ms slower on an H100 (tools/walk_variants.py).
__device__ __forceinline__ void wait_event(float* heap, const Statics& S,
                                           long long w, long long row,
                                           long long ev, long long cnt,
                                           Counts& c) {
  const float* p = heap + S.event_off + ev;
  const float want = static_cast<float>(cnt);
  float seen = ld_acquire(p);
  const bool early = seen != want;
  if (seen < want) {
    const unsigned long long t0 = global_ns();
    while ((seen = ld_acquire(p)) < want) {
      if (global_ns() - t0 > static_cast<unsigned long long>(S.spin_ns))
        spin_fault(heap, S, w, row, ev, seen, cnt);
      __nanosleep(32);
    }
  }
  ++c.waits;
  if (S.dyn ? early : seen > want) ++c.violations;
}

// EXT: 0 the dense kinds (0-8), 1 with the MoE kinds (9-11) and the
// matmul's tail pass, 2 with the Mamba2 kinds (12-13) as well, 3 (static
// only) with the COMM kinds (14-15) as well; 4 the dense kinds with the
// matmul's passes over tiles wider than one (mm_wide).
template <int EXT>
__device__ __forceinline__ void run_task(long long kind, float* heap,
                                         const long long* d,
                                         const Statics& S, const Smem& sm) {
  if constexpr (EXT == 3) {
    if (kind == 14 || kind == 15) {
      k_comm(heap, d);
      return;
    }
  }
  if constexpr (EXT == 2 || EXT == 3) {
    switch (kind) {
      case 12:
        k_ssm(heap, d, store_width(d[2], S), S.hd_ssm, S.nh_tile, S.n_ssm);
        return;
      case 13: k_conv(heap, d, store_width(d[2], S), S.w_conv); return;
      default: break;
    }
  }
  if constexpr (EXT >= 1 && EXT <= 3) {
    switch (kind) {
      case 9: k_softmax_topk(heap, d, S); return;
      case 10: k_moe_gg(heap, d, S, sm); return;
      case 11: k_moe_combine(heap, d, S); return;
      default: break;
    }
  }
  switch (kind) {
    case 0: break;
    case 1: k_matmul<(EXT >= 1 && EXT <= 3), EXT == 4>(heap, d, S, sm); break;
    case 2: k_rmsnorm(heap, d, S, sm); break;
    case 3: k_rope(heap, d, S); break;
    case 4: k_glu(heap, d, S); break;
    case 5: k_resid(heap, d, S); break;
    case 6: k_attn(heap, d, S, sm); break;
    case 7: k_cache_update(heap, d, S); break;
    case 8: k_embed(heap, d, S); break;
    default: __trap();                  // a kind of a later slice
  }
}

// Thread 0, before a ring send of round r >= 1: spin with acquire loads
// until the receiver's arrival counter `p` reaches `want` (its staging
// buffer is free again), under the event wait's deadline (a fault shows
// event -1).  Not counted as an event wait.  Ordered as an event wait is
// (wait_event): the receiver's reads precede its release add, the
// caller's barrier follows this acquire.
__device__ __noinline__ void wait_ack(float* heap, const Statics& S,
                                      long long w, long long row,
                                      const float* p, long long want) {
  const float target = static_cast<float>(want);
  float seen = ld_acquire(p);
  if (seen < target) {
    const unsigned long long t0 = global_ns();
    while ((seen = ld_acquire(p)) < target) {
      if (global_ns() - t0 > static_cast<unsigned long long>(S.spin_ns))
        spin_fault(heap, S, w, row, -1, seen, want);
      __nanosleep(32);
    }
  }
}

// Thread 0: the trace record of one task.
__device__ __forceinline__ void write_record(float* heap, const Statics& S,
                                             long long slot, long long w,
                                             long long row, long long kind,
                                             float t_start, float t_end,
                                             float src, long long wait_ev,
                                             long long wait_cnt) {
  float* rec = heap + S.tr_off + TRACE_HEADER + slot * TRACE_WORDS;
  rec[0] = static_cast<float>(w);
  rec[1] = static_cast<float>(row);
  rec[2] = static_cast<float>(kind);
  rec[3] = t_start;
  rec[4] = t_end;
  rec[5] = src;
  rec[6] = wait_ev >= 0 ? static_cast<float>(wait_cnt) : 0.0f;
  rec[7] = 0.0f;
}

// The rows a static worker runs: the n entries of its walk list, or the
// n = num_steps slots i * W + w of its grid column when list is null.
struct Walk {
  const long long* list;
  long long n, w, W;

  __device__ __forceinline__ long long slot(long long i) const {
    return list != nullptr ? list[i] : i * W + w;
  }
};

// Warp 0: stage row i of the walk into ring slot i % RING, one 16-byte
// cp.async by each of lanes 0-17 (the lane that later copies that part
// into the running row); every lane commits one group a call (empty past
// the walk's end), so that a wait on the group count is a wait on rows.
__device__ __forceinline__ void stage_row(const long long* descs,
                                          const Walk& wk, long long i,
                                          long long* ring) {
  const int lane = threadIdx.x;
  if (i < wk.n && lane < ROW_CHUNKS)
    cp_async16(ring + (i & (RING - 1)) * DESC_WORDS + 2 * lane,
               descs + wk.slot(i) * DESC_WORDS + 2 * lane);
  cp_async_commit();
}

// The tile transfers of the worker's rows, counted by the whole CTA after
// its tasks and summed into thread 0's counters.  The rows a walk list
// leaves out are pads, which count nothing, so the counts are the whole
// grid column's.
__device__ void count_rows(const long long* descs, const Walk& wk,
                           const float* heap, const Statics& S,
                           const Smem& sm, Counts& c) {
  Counts mine;
  mine.zero();
  for (long long i = threadIdx.x; i < wk.n; i += NT)
    mine.task(descs + wk.slot(i) * DESC_WORDS, heap, S);
  long long v[3] = {mine.bulk, mine.rows, mine.fallbacks};
  long long* part = reinterpret_cast<long long*>(sm.red);
  __syncthreads();                      // sm.red is free
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if ((threadIdx.x & 31) == 0) part[k * NWARP + (threadIdx.x >> 5)] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < NWARP; ++i) {
      c.bulk += part[i];
      c.rows += part[NWARP + i];
      c.fallbacks += part[2 * NWARP + i];
    }
}

// Thread 0: a noop row of the static walk, run by warp 0 alone (no task,
// so no barrier): the wait, the trace record, the signal.  The signal's
// release is cumulative, so it passes on what the wait acquired.
__device__ __forceinline__ void run_noop(float* heap, const Statics& S,
                                         const Walk& wk, long long i,
                                         const long long* d, Counts& c) {
  const long long row = wk.slot(i);
  if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], c);
  if (S.tr_off >= 0) {
    const float t_start = atomicAdd(heap + S.tr_off, 1.0f);
    write_record(heap, S, row, wk.w, row, 0, t_start,
                 atomicAdd(heap + S.tr_off, 1.0f), -1.0f, d[32], d[33]);
  }
  if (d[34] >= 0) {
    red_release(heap + S.event_off + d[34], 1.0f);
    ++c.signals;
  }
}

// Static scheduler: CTA w runs the rows of its walk in order, each staged
// RING - 1 rows ahead by warp 0 and copied into the running row (sm.d)
// when its turn comes.  The running row has a fixed address: read
// through the ring's moving slot, the tasks' code lost the proof that its
// shared-memory stores leave the row alone, and deepseek-7b's and
// qwen2-vl's matmuls ran 4-13 % slower on an H100.  Warp 0 runs the noop
// rows (the joins that only wait and signal) on its own, up to the next
// task row; the other warps wait at that row's barrier.
template <int EXT>
__device__ void static_loop(float* heap, const long long* __restrict__ descs,
                            const Walk& wk, const Statics& S, const Smem& sm,
                            Counts& c) {
  __shared__ long long s_task;          // the next task row (wk.n: none)
  long long* d = sm.d;
  long long i = 0;                      // warp 0's next row
  if (threadIdx.x < 32)
    for (int k = 0; k < RING - 1; ++k) stage_row(descs, wk, k, sm.ring);
  for (;;) {
    long long row = 0;                  // thread 0's
    float t_start = 0.0f;
    if (threadIdx.x < 32) {
      for (;; ++i) {                    // the noop rows before the task
        __syncwarp();                   // thread 0 is done with row i - 1
        // into the slot row i - 1 left
        stage_row(descs, wk, i + RING - 1, sm.ring);
        if (i >= wk.n) break;
        cp_async_wait<RING - 1>();      // this lane's part of row i landed
        if (threadIdx.x < ROW_CHUNKS)
          reinterpret_cast<uint4*>(d)[threadIdx.x] =
              reinterpret_cast<const uint4*>(
                  sm.ring + (i & (RING - 1)) * DESC_WORDS)[threadIdx.x];
        __syncwarp();                   // every lane's, for every lane
        if (d[0] != 0) break;
        if (threadIdx.x == 0) run_noop(heap, S, wk, i, d, c);
      }
      if (threadIdx.x == 0) {
        s_task = i;
        if (i < wk.n) {
          row = wk.slot(i);
          if (d[32] >= 0) wait_event(heap, S, wk.w, row, d[32], d[33], c);
          if constexpr (EXT == 3) {
            const long long kind = d[0];
            if (kind == 14 || kind == 15) {
              // a send waits until the receiver's buffer is free again
              if (kind == 14 && S.acks != nullptr && S.acks[2 * row] >= 0)
                wait_ack(heap, S, wk.w, row, heap + S.acks[2 * row],
                         S.acks[2 * row + 1]);
              if (d[3] > 0) {           // the reference's span-op blocks
                c.bulk += 1;
                c.rows += 3 * ((d[3] + 255) / 256) * d[1];
              }
            }
          }
          if (S.tr_off >= 0) t_start = atomicAdd(heap + S.tr_off, 1.0f);
        }
      }
    }
    __syncthreads();                    // the task row is in place; the
    if (s_task >= wk.n) break;          // wait held
    run_task<EXT>(d[0], heap, d, S, sm);
    __syncthreads();                    // the task's stores landed
    if (threadIdx.x == 0) {
      if constexpr (EXT == 3) {         // an arrival's reads are done
        if (d[0] == 15 && S.acks != nullptr && S.acks[2 * row] >= 0)
          red_release(heap + S.acks[2 * row], 1.0f);
      }
      if (S.tr_off >= 0)
        write_record(heap, S, row, wk.w, row, d[0], t_start,
                     atomicAdd(heap + S.tr_off, 1.0f), -1.0f, d[32], d[33]);
      if (d[34] >= 0) {                 // release this task's stores
        red_release(heap + S.event_off + d[34], 1.0f);
        ++c.signals;
      }
    }
    ++i;
  }
  if (threadIdx.x < 32) cp_async_wait<0>();   // only empty groups remain
  count_rows(descs, wk, heap, S, sm, c);
}

// Pop with the calling warp from `words` words of ready-pool slots (a
// pool or the overflow queue): the minimum row id, claimed by lane 0 with
// a CAS (row -> QUEUE_EMPTY); a lost race rescans.  Every lane gets the
// row, or -1 when the region holds none.  The pop and push helpers are
// not inlined: their registers stay out of the tasks' allocation.
__device__ __noinline__ long long warp_pop(float* region, long long words) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    float best = QUEUE_EMPTY;
    long long at = -1;
    for (long long base = 0; base < words; base += QCAP) {
#pragma unroll
      for (int e = 0; e < QCAP / 32; ++e) {
        const long long j = base + lane + 32 * e;
        const float v = ld_relaxed(region + j);
        if (v < best) { best = v; at = j; }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const long long oa = __shfl_xor_sync(0xffffffffu, at, o);
      if (ob < best) { best = ob; at = oa; }
    }
    if (best >= QTH) return -1;
    int won = 0;
    if (lane == 0) won = cas_word(region + at, best, QUEUE_EMPTY);
    if (__shfl_sync(0xffffffffu, won, 0)) return static_cast<long long>(best);
  }
}

// Push `row` with one thread into the first empty slot of `words` words
// of ready-pool slots, scanning 32 words at a time; false when every slot
// is taken.
__device__ __noinline__ bool thread_push(float* region, long long words,
                                        float row) {
  for (long long base = 0; base < words; base += 32) {
    float v[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] = ld_relaxed(region + base + e);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (v[e] >= QTH && cas_word(region + base + e, QUEUE_EMPTY, row))
        return true;
  }
  return false;
}

// A worker that popped nothing for the deadline while tasks remain: the
// plan or the launch is wrong (an event that never triggers, a push that
// went missing).  The fault goes into the worker's counter block (word 6
// +1, words 8-11: -1, -1, the ticket seen, -1) and the kernel traps.
__device__ __noinline__ void pop_fault(float* heap, const Statics& S,
                                       long long w, float ticket) {
  float* st = heap + S.stats_off + w * STATS_WORDS;
  st[6] += 1.0f;
  st[8] = -1.0f;
  st[9] = -1.0f;
  st[10] = ticket;
  st[11] = -1.0f;
  __threadfence_system();
  printf("megakernel: worker %lld popped nothing past its deadline "
         "(%.0f of %lld tasks done)\n", w, ticket, S.n_tasks);
  __trap();
}

// Dynamic scheduler: pop -> wait check -> task -> signal-and-enqueue
// until all T tasks have been popped.  `c` is in shared memory: thread 32
// counts the transfers, thread 0 the rest.
template <int EXT>
__device__ void dyn_loop(float* heap, const long long* __restrict__ descs,
                         long long W, const Statics& S, const Smem& sm,
                         long long w, Counts& c) {
  __shared__ long long s_row, s_pool;
  __shared__ int s_src, s_victim, s_done, s_push;
  __shared__ float s_start;
  __shared__ unsigned long long s_last_pop;
  __shared__ unsigned s_backoff;
  const int tid = threadIdx.x, warp = tid >> 5;
  float* occ = sm.red;                  // W + 1 occupancies, between tasks
  if (tid == 0) { s_last_pop = global_ns(); s_backoff = 32; }
  for (;;) {
    float* pools = heap + S.qoff;
    float* over = pools + W * QCAP;
    float* qc = heap + S.qc_off;
    __syncthreads();                    // the last round's words are read
    // own pool (warp 0) beside every pool's occupancy (the rest)
    if (warp == 0) {
      const long long r = warp_pop(pools + w * QCAP, QCAP);
      if (tid == 0) { s_row = r; s_pool = w; s_src = 0; s_victim = 1 << 30; }
    } else {
      for (long long i = tid - 32; i <= W; i += NT - 32)
        occ[i] = ld_relaxed(qc + 2 * i) - ld_relaxed(qc + 2 * i + 1);
    }
    __syncthreads();
    if (s_row < 0) {                    // overflow, then steal
      for (long long k = tid + 1; k < W; k += NT)
        if (occ[(w + k) % W] > 0.5f) atomicMin(&s_victim, static_cast<int>(k));
      __syncthreads();
      if (warp == 0) {
        long long r = -1, pool = -1;
        int src = -1;
        if (occ[W] > 0.5f) {
          r = warp_pop(over, S.ov_words);
          pool = W;
          src = 1;
        }
        if (r < 0 && s_victim < W) {
          pool = (w + s_victim) % W;
          r = warp_pop(pools + pool * QCAP, QCAP);
          src = 2;
        }
        if (tid == 0) { s_row = r; s_pool = pool; s_src = src; }
      }
      __syncthreads();
    }
    // warps 1-2 load the claimed row while thread 0 counts the pop
    if (s_row >= 0 && tid >= 32 && tid < 32 + DESC_WORDS)
      sm.d[tid - 32] = descs[s_row * DESC_WORDS + tid - 32];
    if (tid == 0) {
      s_done = 0;
      if (s_row >= 0) {
        __threadfence();                // the push we saw, then its event
        atomicAdd(qc + 2 * s_pool + 1, 1.0f);          // popped cursor
        if (s_src == 0) ++c.own;
        else if (s_src == 1) ++c.overflow;
        else ++c.steals;
        s_last_pop = global_ns();
        s_backoff = 32;
      } else {
        ++c.idle;
        const float ticket = ld_relaxed(heap + S.ctl_off);
        if (ticket >= static_cast<float>(S.n_tasks)) {
          s_done = 1;
        } else {
          if (global_ns() - s_last_pop
              > static_cast<unsigned long long>(S.spin_ns))
            pop_fault(heap, S, w, ticket);
          __nanosleep(s_backoff);
          s_backoff = s_backoff < 1024 ? 2 * s_backoff : 1024;
        }
      }
    }
    __syncthreads();
    if (s_done) break;
    if (s_row < 0) continue;
    // the task's words stay in shared memory (sm.d, s_row, s_start)
    // across the task, so that they hold no registers there
    if (tid == 32) c.task(sm.d, heap, S);   // beside thread 0's wait
    if (tid == 0) {
      const long long* d = sm.d;
      if (d[32] >= 0) wait_event(heap, S, w, s_row, d[32], d[33], c);
      if (S.tr_off >= 0) s_start = atomicAdd(heap + S.tr_off, 1.0f);
    }
    __syncthreads();                    // the wait held
    run_task<EXT>(sm.d[0], heap, sm.d, S, sm);
    __syncthreads();                    // the task's stores landed
    if (tid == 0) {
      const long long* d = sm.d;
      const long long sig_ev = d[34];
      const float t_end = S.tr_off >= 0 ? atomicAdd(heap + S.tr_off, 1.0f)
                                        : 0.0f;
      s_push = -1;
      if (sig_ev >= 0) {                // release, then maybe enqueue
        __threadfence();
        const float old = atomicAdd(heap + S.event_off + sig_ev, 1.0f);
        ++c.signals;
        if (old + 1.0f == static_cast<float>(S.sched[sig_ev * S.sched_w]))
          s_push = static_cast<int>(sig_ev);
      }
      // the ticket, taken off the hand-off's path: the pop trace and the
      // ring are in the order in which tasks completed
      const long long ticket = static_cast<long long>(
          atomicAdd(heap + S.ctl_off, 1.0f));
      if (S.tr_off >= 0)
        write_record(heap, S, ticket, w, s_row, d[0], s_start, t_end,
                     static_cast<float>(s_src), d[32], d[33]);
      heap[S.pt_off + ticket] = static_cast<float>(s_row);
    }
    __syncthreads();
    if (s_push >= 0) {                  // the event fully triggered
      float* pools = heap + S.qoff;
      float* over = pools + W * QCAP;
      float* qc = heap + S.qc_off;
      const int* ent = S.sched + static_cast<long long>(s_push) * S.sched_w;
      const int n_out = ent[1];
      for (int j = tid; j < n_out; j += NT) {
        const long long cr = ent[2 + j];
        const long long aw = descs[cr * DESC_WORDS + 35];
        __threadfence();
        if (thread_push(pools + aw * QCAP, QCAP, static_cast<float>(cr))) {
          atomicAdd(qc + 2 * aw, 1.0f);
        } else if (thread_push(over, S.ov_words, static_cast<float>(cr))) {
          atomicAdd(qc + 2 * W, 1.0f);
        } else {
          __trap();                     // overflow holds every task
        }
      }
    }
  }
  __syncthreads();                      // thread 32's counts landed
}

// One kernel per scheduler and variant: each gets its own register
// allocation, so the dynamic loop's state costs the static loop nothing
// (a runtime branch between the two loops in one kernel halved the static
// loop's matmul rate on the card), the MoE kinds and the matmul's tail
// cost the dense kernels nothing, the Mamba2 kinds cost the extended
// ones nothing (in one kernel with the MoE kinds they raised the static
// extended kernel's spill from 100 to 124 bytes), and the COMM kinds and
// their guard cost the single-chip kernels nothing (megakernel<false, 3>
// is the only instantiation with them), and the matmul's wide passes cost
// every other kernel nothing (megakernel<DYN, 4> is the only
// instantiation with them: the others keep their code and registers).
template <bool DYN, int EXT>
__global__ void __launch_bounds__(NT)
megakernel(float* heap, const long long* __restrict__ descs,
           long long num_steps, long long num_workers,
           const long long* __restrict__ walk, Statics S) {
  Smem sm;
  sm.d = reinterpret_cast<long long*>(smem_raw);
  sm.ring = reinterpret_cast<long long*>(smem_raw + ROW_BYTES);
  sm.scal = reinterpret_cast<float*>(smem_raw + (RING + 1) * ROW_BYTES);
  sm.red = reinterpret_cast<float*>(smem_raw + HEAD_BYTES);
  sm.x = sm.red + RP * NT * VEC;
  const long long w = blockIdx.x;
  if constexpr (DYN) {
    // in shared memory: the loop's state then leaves the tasks all 128
    // registers (in registers the counters made the matmul spill)
    __shared__ Counts c;
    if (threadIdx.x == 0) c.zero();
    __syncthreads();
    dyn_loop<EXT>(heap, descs, num_workers, S, sm, w, c);
    if (threadIdx.x == 0) c.store(heap, S, w);
  } else {
    Counts c;                           // thread 0's
    c.zero();
    const Walk wk{walk != nullptr ? walk + num_workers + 1 + walk[w] : nullptr,
                  walk != nullptr ? walk[w + 1] - walk[w] : num_steps, w,
                  num_workers};
    static_loop<EXT>(heap, descs, wk, S, sm, c);
    if (threadIdx.x == 0) c.store(heap, S, w);
  }
}

size_t smem_bytes(long long tk, long long hd) {
  const long long x_words = RP * tk > NWARP * (hd + 2) ? RP * tk
                                                       : NWARP * (hd + 2);
  return HEAD_BYTES + sizeof(float) * (RP * NT * VEC + x_words);
}

// CTAs of the scheduler's kernel that can be resident at once on the
// current device with this much shared memory (0 with the CUDA error in
// *err).
long long resident_ctas(const void* kernel, size_t smem, cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess) return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, smem)) != cudaSuccess) return 0;
  return static_cast<long long>(per_sm) * sms;
}

const void* kernel_for(bool dyn, long long ext) {
  if (ext == 4)
    return dyn ? reinterpret_cast<const void*>(megakernel<true, 4>)
               : reinterpret_cast<const void*>(megakernel<false, 4>);
  if (ext == 3)                         // static only
    return dyn ? nullptr : reinterpret_cast<const void*>(megakernel<false, 3>);
  if (ext == 2)
    return dyn ? reinterpret_cast<const void*>(megakernel<true, 2>)
               : reinterpret_cast<const void*>(megakernel<false, 2>);
  if (ext == 1)
    return dyn ? reinterpret_cast<const void*>(megakernel<true, 1>)
               : reinterpret_cast<const void*>(megakernel<false, 1>);
  return dyn ? reinterpret_cast<const void*>(megakernel<true, 0>)
             : reinterpret_cast<const void*>(megakernel<false, 0>);
}

// the statics of the last mk_launch call (host side; mk_last_statics)
Statics g_last{};

}  // namespace

// The most workers (CTAs) that can be resident at once for a plan with
// these statics, under either scheduler and in every variant; negative:
// minus the CUDA error.
extern "C" long long mk_max_workers(long long tk, long long hd) {
  cudaError_t err;
  long long n = -1;
  for (const bool dyn : {false, true})
    for (const long long ext : {0, 1, 2, 3, 4}) {
      if (dyn && ext == 3) continue;    // the multichip kernel is static
      const long long k = resident_ctas(kernel_for(dyn, ext),
                                        smem_bytes(tk, hd), &err);
      if (err != cudaSuccess) return -static_cast<long long>(err);
      n = n < 0 || k < n ? k : n;
    }
  return n;
}

// One launch of `num_workers` CTAs against the heap on `stream`, all
// resident at once (a cooperative launch; a grid that cannot be
// co-resident is refused with ERR_NOT_RESIDENT before anything runs).
// Static scheduler (`dyn` 0): the CTAs walk the (num_steps, num_workers)
// descriptor grid.  Dynamic scheduler (`dyn` 1): they pop the T =
// `n_tasks` rows of the flat table from the ready pools at `qoff`
// (`ov_words` words of overflow after the W pools), with the cursor
// pairs at `qc_off`, the pop trace at `pt_off`, the ticket at
// `ctl_off` and the (events, `sched_w`) int32 scheduler table `sched`.
// `tr_off` < 0: no trace ring.  `topk` is the experts a token routes to
// (kind 9).  `ext` selects the variant: 1 the extended kernel (a plan
// with the MoE kinds or a masked-store chunk that is not a whole float4
// group), 2 the full one (a plan with the Mamba2 kinds), 3 the multichip
// one (a stamped plan, static only), 4 the wide one (a dense plan with a
// matmul tile wider than one pass), 0 the dense.  `hd_ssm`, `n_ssm`,
// `nh_tile` and `w_conv` shape the Mamba2 kinds (12-13); `acks` is a
// multichip plan's (rows, 2) side table (null otherwise).  `mrope0-2`
// are the M-RoPE sections (0, 0, 0 without), after `stream` so that the
// earlier arguments keep their places.  `walk` is a static plan's walk
// lists (W + 1 offsets, then each lane's non-pad slots in step order;
// null: every CTA walks its whole grid column), last for the same reason.
// `descs` must be 16-byte aligned (its rows are staged by cp.async).
// Returns the CUDA error of the launch (0 on success).
extern "C" int mk_launch(float* heap, const long long* descs,
                         long long num_steps, long long num_workers,
                         long long tn, long long tk, long long hd,
                         long long g, long long store_ch,
                         long long stats_off, long long event_off,
                         long long tr_off, long long spin_ns, double theta,
                         long long ng, long long s_max, long long dyn,
                         const int* sched, long long sched_w,
                         long long qoff, long long ov_words,
                         long long qc_off, long long pt_off,
                         long long ctl_off, long long n_tasks,
                         long long topk, long long ext,
                         long long hd_ssm, long long n_ssm,
                         long long nh_tile, long long w_conv,
                         const long long* acks, void* stream,
                         long long mrope0, long long mrope1,
                         long long mrope2, const long long* walk) {
  const int tkc = static_cast<int>(tk < 8 ? 8 : (tk > 128 ? 128 : tk));
  const int ts = static_cast<int>(s_max < 128 ? s_max : 128);
  Statics S{tn, tk, hd, g, store_ch, stats_off, event_off, tr_off, spin_ns,
            static_cast<float>(theta), ng, tkc,
            static_cast<int>((tk + tkc - 1) / tkc), ts,
            static_cast<int>((s_max + ts - 1) / ts), dyn, sched, sched_w,
            qoff, ov_words, qc_off, pt_off, ctl_off, n_tasks, topk,
            hd_ssm, n_ssm, nh_tile, w_conv, acks, {mrope0, mrope1, mrope2}};
  g_last = S;
  const size_t smem = smem_bytes(tk, hd);
  const void* kernel = kernel_for(dyn != 0, ext);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const long long resident = resident_ctas(kernel, smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_workers < 1 || num_workers > resident) return ERR_NOT_RESIDENT;
  if (dyn != 0) walk = nullptr;
  void* args[] = {&heap, &descs, &num_steps, &num_workers, &walk, &S};
  err = cudaLaunchCooperativeKernel(
      kernel,
      dim3(static_cast<unsigned>(num_workers)), dim3(NT), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The integer statics of the last mk_launch call, in the order of its
// arguments: tn, tk, hd, g, store_ch, stats_off, event_off, tr_off,
// spin_ns, ng, dyn, sched_w, qoff, ov_words, qc_off, pt_off, ctl_off,
// n_tasks, topk, hd_ssm, n_ssm, nh_tile, w_conv, mrope0-2 (26 words):
// what the kernel was given, for a check that the ctypes argument list
// matches this signature.
extern "C" void mk_last_statics(long long* out) {
  const Statics& S = g_last;
  const long long v[] = {S.tn, S.tk, S.hd, S.g, S.store_ch, S.stats_off,
                         S.event_off, S.tr_off, S.spin_ns, S.ng, S.dyn,
                         S.sched_w, S.qoff, S.ov_words, S.qc_off, S.pt_off,
                         S.ctl_off, S.n_tasks, S.topk, S.hd_ssm, S.n_ssm,
                         S.nh_tile, S.w_conv, S.mrope[0], S.mrope[1],
                         S.mrope[2]};
  for (int i = 0; i < 26; ++i) out[i] = v[i];
}

extern "C" const char* mk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
