// Stream a weight-shaped fp32 region through shared memory, one CTA of 512
// threads per SM (132), and print the rate: how fast the megakernel's
// matmul could stream its weights through a ring of stages with nothing
// else on the stage's path.
//
//   bash tools/tma_stream_bench.sh        (on the card: builds and runs)
//   tma_stream_bench MODE COLS KC NS [FLAGS [CTAS]]
//
// Each CTA reads its own 4096 rows of COLS floats at a row stride of 8192
// floats (deepseek-7b's layout of a 128-column tile: 512-byte rows 32 KB
// apart), KC rows a stage, through a ring of NS stages with a full and an
// empty mbarrier each; the 512 threads sum each stage, then each warp
// releases it.  MODE:
//   0  one 2-D TMA box a stage (COLS x KC), issued by thread 0
//   1  one 1-D bulk copy a row, issued by thread 0
//   2  one 1-D bulk copy a row, issued by the 32 lanes of warp 0
//   3  no ring: each thread loads float4s with __ldg, one at a time
//   4  as 0, and two 1-D bulk copies a stage of KC floats (x rows)
//   5  as 0, and one 2-D TMA box a stage of 2 rows of KC floats (x rows)
// The rate counts the weight bytes once; the time is the mean of 5
// launches after one.  Imports nothing of the port.
//
// Modes 6-10 do the megakernel matmul's own stage work (k_matmul and
// mm_pass in src/repro_torch/megakernel/csrc/megakernel.cu) on a GEMV of
// RP = 2 x rows: each CTA runs TILES tiles of 2 MB in turn (COLS columns
// at a row stride of 132 * COLS floats, CTA b on columns b * COLS, so
// deepseek-7b's 128-column, K = 4096 tiles at COLS = 128), with mm_pass's
// geometry of ct column threads (float4 groups, CPT a thread) by nks K
// slices, the K-slice reduction through shared memory and the stores at
// the end of each tile.  The outputs are checked against the host's sums.
//   6  the yardstick: no ring; x staged whole in shared memory at each
//      tile's start, weights loaded with __ldg float4 into registers
//      (mm_pass's loop, 512 threads)
//   7  variant (i): a ring of NS stages of KC weight rows (2-D TMA boxes
//      of at most 256 columns) and the stage's KC-deep slice of both x
//      rows (two 1-D bulk copies), issued by thread 0, which also
//      computes its share; 512 threads compute, float4 weights and x
//      read from the stage; one empty-barrier arrive a warp after
//      __syncwarp
//   8  as 7, one empty-barrier arrive a thread
//   9  variant (ii): as 7, issued by one elected lane of warp 15, which
//      computes nothing; warps 0-14 compute (480 threads, a named
//      barrier for the reduction); one arrive a warp.  Variant (iii) is
//      mode 9 with 64 KB stages (KC doubled)
//  10  as 9, one arrive a thread
// The issuer of 7-10 runs ahead across tile boundaries, as a producer
// that knows the next tile would.  An optional fifth argument FLAGS adds,
// bit by bit, what a ring inside the megakernel may add to a stage's path:
//    1  every mbarrier wait bounded by a %globaltimer deadline, with
//       __nanosleep(32) between polls (the kernel's event-wait pattern)
//    2  x not by stage: the computing threads stage both x rows of a tile
//       whole with plain loads at its start, between two barriers (the
//       kernel's x staging), and the ring carries weights only
//    4  fence.proxy.async by the issuer before each stage's copies
//    8  one tensor map a tile (132 * TILES maps) instead of one for all
//   16  no issue across tiles: a CTA barrier after each tile, and the
//       next tile's first stage issued only after it
//   32  every mbarrier wait a test_wait poll (never suspends)
//   64  every mbarrier wait a try_wait with a 20 ns suspend-time hint
// and a sixth, CTAS, runs modes 6-10 on that many of the 132 CTAs (the
// rest of the card idle), as a plan that uses fewer workers does.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <vector>

extern __shared__ __align__(128) unsigned char sm[];

namespace {

__device__ unsigned su(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ void minit(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(su(b)), "r"(count) : "memory");
}

__device__ void mexpect(unsigned long long* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(su(b)), "r"(bytes) : "memory");
}

__device__ void marrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(su(b)) : "memory");
}

__device__ bool mtry(unsigned long long* b, unsigned parity) {
  unsigned ok;
  asm volatile("{.reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 "
               "q, [%1], %2; selp.u32 %0, 1, 0, q;}"
               : "=r"(ok) : "r"(su(b)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the wait of FLAGS bit 32: test_wait polls, which never suspend
__device__ void mwait_test(unsigned long long* b, unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile("{.reg .pred q; mbarrier.test_wait.parity.shared::cta.b64 "
                 "q, [%1], %2; selp.u32 %0, 1, 0, q;}"
                 : "=r"(ok) : "r"(su(b)), "r"(parity) : "memory");
}

// the wait of FLAGS bit 64: try_wait with a suspend-time hint of 20 ns
__device__ void mwait_hint(unsigned long long* b, unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile("{.reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 "
                 "q, [%1], %2, %3; selp.u32 %0, 1, 0, q;}"
                 : "=r"(ok) : "r"(su(b)), "r"(parity), "r"(20u) : "memory");
}

// the wait of FLAGS bit 1: a deadline, and a nap between polls
__device__ void mwait_dl(unsigned long long* b, unsigned parity) {
  if (mtry(b, parity)) return;
  const unsigned long long t0 = gtime();
  while (!mtry(b, parity)) {
    if (gtime() - t0 > 5000000000ull) __trap();
    __nanosleep(32);
  }
}

__device__ void mwait(unsigned long long* b, unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile("{.reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 "
                 "q, [%1], %2; selp.u32 %0, 1, 0, q;}"
                 : "=r"(ok) : "r"(su(b)), "r"(parity) : "memory");
}

__device__ void bulk(void* dst, const void* src, unsigned bytes,
                     unsigned long long* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(su(dst)), "l"(src), "r"(bytes), "r"(su(b))
               : "memory");
}

__device__ void tma2(void* dst, const CUtensorMap* map,
                     unsigned long long* b, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
               :: "r"(su(dst)),
                  "l"(reinterpret_cast<unsigned long long>(map)),
                  "r"(su(b)), "r"(x), "r"(y) : "memory");
}

constexpr int CTAS = 132, ROWS = 4096;
constexpr long long LD = 8192;

__global__ void __launch_bounds__(512)
stream(const float* base, const CUtensorMap* maps, const float* xsrc,
       int cols, int kc, int ns, int mode, float* out) {
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm);
  unsigned long long* empty = full + 16;
  unsigned char* slots = sm + 256;
  unsigned char* xs = slots + ns * cols * kc * 4;   // 2 KB a stage
  const int sbytes = cols * kc * 4;
  const int xbytes = mode >= 4 ? 2 * kc * 4 : 0;
  const float* reg = base + static_cast<long long>(blockIdx.x) * ROWS * LD;
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      minit(full + i, 1);
      minit(empty + i, 16);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float acc = 0.f;
  const int nst = ROWS / kc;
  if (mode == 3) {
    const int c4 = cols / 4;
    for (int r = tid / c4; r < ROWS; r += 512 / c4) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(reg + r * LD) + tid % c4);
      acc += v.x + v.y + v.z + v.w;
    }
  } else {
    // warp 0 fills stage st's slot
    auto issue = [&](int st) {
      const int s = st % ns;
      unsigned char* dst = slots + s * sbytes;
      if (mode == 2) {
        if (lane == 0) mexpect(full + s, sbytes);
        __syncwarp();
        for (int j = lane; j < kc; j += 32)
          bulk(dst + j * cols * 4, reg + (st * kc + j) * LD, cols * 4,
               full + s);
        return;
      }
      if (tid != 0) return;
      mexpect(full + s, sbytes + xbytes);
      if (mode == 1) {
        for (int j = 0; j < kc; ++j)
          bulk(dst + j * cols * 4, reg + (st * kc + j) * LD, cols * 4,
               full + s);
        return;
      }
      tma2(dst, maps + blockIdx.x, full + s, 0, st * kc);
      const int k0 = (st * kc) % 4096;
      if (mode == 4)
        for (int r = 0; r < 2; ++r)
          bulk(xs + (s * 2 + r) * 1024, xsrc + r * 8192 + k0, kc * 4,
               full + s);
      else if (mode == 5)
        tma2(xs + s * 2048, maps + CTAS, full + s, k0, 0);
    };
    if (tid < 32)
      for (int st = 0; st < ns && st < nst; ++st) issue(st);
    for (int q = 0; q < nst; ++q) {
      const int p = q - 1 + ns;         // into the slot stage q - 1 left
      if (q >= 1 && p < nst && tid < 32) {
        if (lane == 0) mwait(empty + p % ns, ((p / ns) - 1) & 1);
        __syncwarp();
        issue(p);
      }
      const int s = q % ns;
      mwait(full + s, (q / ns) & 1);
      const float* w = reinterpret_cast<const float*>(slots + s * sbytes);
      for (int i = tid; i < cols * kc; i += 512) acc += w[i];
      __syncwarp();
      if (lane == 0) marrive(empty + s);
    }
  }
  if (acc == 12345.f) out[0] = acc;     // keeps the sums
}

// ---- modes 6-10: the matmul's stage work ---------------------------------

constexpr int RP = 2, TILES = 8, TILE_BYTES = 2 << 20, XLD = 4096;

__device__ __forceinline__ void bar_compute(int nc) {
  if (nc == 512) __syncthreads();
  else asm volatile("bar.sync 1, %0;" :: "r"(nc) : "memory");
}

// Geometry of mm_pass for nc computing threads and ncg float4 groups.
struct Geo {
  int ct, nks;
};

__host__ __device__ inline Geo geometry(int nc, int ncg, int cpt) {
  Geo g;
  if (cpt == 1) {
    g.ct = ncg < nc ? (ncg + 31) / 32 * 32 : nc;
  } else {
    g.ct = (ncg + cpt - 1) / cpt;
  }
  g.nks = nc / g.ct;
  return g;
}

// The end of a tile: reduce the K slices through shared memory, store.
template <int CPT>
__device__ void finish_tile(float (&acc)[RP][CPT][4], const Geo& gm, int ks,
                            int jt, int ncg, int nc, float* red,
                            float* out) {
  if (gm.nks > 1) {
    if (ks < gm.nks)
      for (int r = 0; r < RP; ++r)
        for (int e = 0; e < 4; ++e)
          red[((ks * RP + r) * gm.ct + jt) * 4 + e] = acc[r][0][e];
    bar_compute(nc);
    if (ks == 0)
      for (int r = 0; r < RP; ++r)
        for (int e = 0; e < 4; ++e) {
          float s = 0.f;
          for (int q = 0; q < gm.nks; ++q)
            s += red[((q * RP + r) * gm.ct + jt) * 4 + e];
          acc[r][0][e] = s;
        }
  }
  if (ks == 0)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int grp = jt + c * gm.ct;
      if (grp >= ncg) continue;
      for (int r = 0; r < RP; ++r)
        for (int e = 0; e < 4; ++e) out[r * ncg * 4 + grp * 4 + e] =
            acc[r][c][e];
    }
  bar_compute(nc);                      // red is free
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
}

// Mode 6: mm_pass's register stream, x staged whole a tile.
template <int CPT, int UNROLL>
__global__ void __launch_bounds__(512)
mm_reg(const float* w, const float* xsrc, int cols, float* out) {
  float* red = reinterpret_cast<float*>(sm);
  float* xs = red + 4096;
  const int tid = threadIdx.x, ncg = cols / 4;
  const int kt = TILE_BYTES / (cols * 4);
  const long long ld4 = 132LL * cols / 4;
  const Geo gm = geometry(512, ncg, CPT);
  const int ks = tid / gm.ct, jt = tid % gm.ct;
  float acc[RP][CPT][4] = {};
  bool live[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) live[c] = jt + c * gm.ct < ncg;
  for (int t = 0; t < TILES; ++t) {
    for (int r = 0; r < RP; ++r)
      for (int k = tid; k < kt; k += 512) xs[r * kt + k] = xsrc[r * XLD + k];
    __syncthreads();
    if (ks < gm.nks) {
      const float4* wp = reinterpret_cast<const float4*>(w)
                         + (static_cast<long long>(t) * kt + ks) * ld4
                         + blockIdx.x * ncg + jt;
      const long long step = gm.nks * ld4;
#pragma unroll(UNROLL)
      for (int k = ks; k < kt; k += gm.nks) {
        float4 v[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          v[c] = live[c] ? __ldg(wp + c * gm.ct) : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float xv = xs[r * kt + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[r][c][0] = fmaf(xv, v[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(xv, v[c].y, acc[r][c][1]);
            acc[r][c][2] = fmaf(xv, v[c].z, acc[r][c][2]);
            acc[r][c][3] = fmaf(xv, v[c].w, acc[r][c][3]);
          }
        }
        wp += step;
      }
    }
    finish_tile<CPT>(acc, gm, ks, jt, ncg, 512, red,
                     out + (static_cast<long long>(blockIdx.x) * TILES + t)
                               * RP * cols);
  }
}

// Modes 7-10: the ring.  Stage s holds KC weight rows as boxes of at most
// 256 columns ([box][row][column]) and both x rows' KC-deep slice.
template <int CPT>
__global__ void __launch_bounds__(512)
mm_ring(const CUtensorMap* wmap, const float* xsrc, int cols, int kc,
        int ns, int mode, int flags, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dl = flags & 1, xwhole = flags & 2, fence = flags & 4;
  const bool map_tile = flags & 8, drain = flags & 16;
  auto wait = [&](unsigned long long* b, unsigned parity) {
    if (dl) mwait_dl(b, parity);
    else if (flags & 32) mwait_test(b, parity);
    else if (flags & 64) mwait_hint(b, parity);
    else mwait(b, parity);
  };
  const bool producer_warp = mode >= 9;
  const int nc = producer_warp ? 480 : 512;
  const bool per_thread = mode == 8 || mode == 10;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm);
  unsigned long long* empty = full + 16;
  float* red = reinterpret_cast<float*>(sm + 256);
  unsigned char* slots = sm + 256 + 4096 * 4;
  const int ncg = cols / 4, kt = TILE_BYTES / (cols * 4);
  float* xw = nullptr;                  // FLAGS 2: a tile's x rows, whole
  const int bw = ncg < 64 ? ncg : 64;             // float4 groups a box
  const int nbox = ncg / bw;
  const int xk = (kc + 3) / 4 * 4 + 4;            // floats a staged x row
  const int wbytes = cols * kc * 4;
  const int sbytes = (wbytes + RP * xk * 4 + 127) / 128 * 128;
  const int spt = kt / kc, total = TILES * spt;
  xw = reinterpret_cast<float*>(slots + ns * sbytes);
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      minit(full + i, 1);
      minit(empty + i, per_thread ? nc : nc / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // issue stage p (of the CTA's whole run) into slot p % ns
  auto issue = [&](int p) {
    const int s = p % ns, t = p / spt, q = p % spt;
    unsigned char* dst = slots + s * sbytes;
    const int k0 = q * kc, ka = k0 & ~3;
    const int xb = ((k0 - ka + kc + 3) / 4) * 16;
    if (fence) asm volatile("fence.proxy.async;" ::: "memory");
    mexpect(full + s, wbytes + (xwhole ? 0 : RP * xb));
    const CUtensorMap* m = map_tile ? wmap + 1 + blockIdx.x * TILES + t
                                    : wmap;
    for (int i = 0; i < nbox; ++i)
      tma2(dst + i * bw * 16 * kc, m, full + s,
           (map_tile ? 0 : blockIdx.x * cols) + i * bw * 4,
           (map_tile ? 0 : t * kt) + k0);
    if (!xwhole)
      for (int r = 0; r < RP; ++r)
        bulk(dst + wbytes + r * xk * 4, xsrc + r * XLD + ka, xb, full + s);
  };
  if (producer_warp && warp == 15) {
    for (int p = 0; p < total; ++p) {
      if (drain && p > 0 && p % spt == 0) __syncthreads();
      if (lane == 0) {
        if (p >= ns) wait(empty + p % ns, ((p / ns) - 1) & 1);
        issue(p);
      }
      __syncwarp();
    }
    return;
  }
  if (!producer_warp && tid == 0)
    for (int p = 0; p < ns && p < (drain ? spt : total); ++p) issue(p);
  const Geo gm = geometry(nc, ncg, CPT);
  const int ks = tid / gm.ct, jt = tid % gm.ct;
  float acc[RP][CPT][4] = {};
  bool live[CPT];
  int boff[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int g = jt + c * gm.ct;
    live[c] = g < ncg && ks < gm.nks;
    boff[c] = (g / bw) * bw * kc + g % bw;        // float4s: box, column
  }
  for (int g = 0; g < total; ++g) {
    const int q = g % spt;
    if (drain && g > 0 && q == 0) {
      __syncthreads();                  // the last tile is done
      if (!producer_warp && tid == 0)   // its first stages, in its slots
        for (int p = g; p < g + ns && p < g + spt; ++p) {
          if (p >= ns) wait(empty + p % ns, ((p / ns) - 1) & 1);
          issue(p);
        }
    }
    if (xwhole && q == 0) {
      bar_compute(nc);                  // xw is free
      for (int r = 0; r < RP; ++r)
        for (int k = tid; k < kt; k += nc) xw[r * kt + k] = xsrc[r * XLD + k];
      bar_compute(nc);
    }
    if (!producer_warp && g >= 1) {
      const int p = g - 1 + ns;           // into the slot stage g - 1 left
      if (tid == 0 && p < total
          && (!drain || (q > 0 && p / spt == g / spt))) {
        wait(empty + p % ns, ((p / ns) - 1) & 1);
        issue(p);
      }
    }
    const int s = g % ns;
    wait(full + s, (g / ns) & 1);
    const float4* ws = reinterpret_cast<const float4*>(slots + s * sbytes);
    const int xo = q * kc - ((q * kc) & ~3);
    const float* x0 =
        xwhole ? xw + q * kc
               : reinterpret_cast<const float*>(slots + s * sbytes + wbytes)
                     + xo;
    const int xstride = xwhole ? kt : xk;
    if (ks < gm.nks)
      for (int j = ks; j < kc; j += gm.nks) {
        float4 v[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          v[c] = live[c] ? ws[boff[c] + j * bw] : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float xv = x0[r * xstride + j];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[r][c][0] = fmaf(xv, v[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(xv, v[c].y, acc[r][c][1]);
            acc[r][c][2] = fmaf(xv, v[c].z, acc[r][c][2]);
            acc[r][c][3] = fmaf(xv, v[c].w, acc[r][c][3]);
          }
        }
      }
    if (per_thread) {
      marrive(empty + s);
    } else {
      __syncwarp();
      if (lane == 0) marrive(empty + s);
    }
    if (q == spt - 1)
      finish_tile<CPT>(acc, gm, ks, jt, ncg, nc, red,
                       out + (static_cast<long long>(blockIdx.x) * TILES
                              + g / spt) * RP * cols);
  }
}

__global__ void fill(float* w, long long rows, long long ld, float* x) {
  const long long n = rows * ld;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += 256LL * gridDim.x)
    w[i] = static_cast<float>((i / ld + i % ld) % 7 - 3);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < RP * XLD; i += 256)
      x[i] = static_cast<float>(i % XLD % 5 + i / XLD);
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

bool encode(Encode enc, CUtensorMap* m, void* ptr, cuuint64_t d0,
            cuuint64_t d1, cuuint64_t stride, cuuint32_t b0, cuuint32_t b1) {
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {b0, b1}, ones[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Modes 6-10: time the matmul's stage work and check its sums.
int run_mm(Encode enc, int mode, int cols, int kc, int ns, int flags,
           int ctas) {
  const int ncg = cols / 4, kt = TILE_BYTES / (cols * 4);
  const int nc = mode >= 9 ? 480 : 512;
  const int cpt = (ncg + nc - 1) / nc;
  if (cols % 128 || cols > 4096 || cpt > 3
      || (mode != 6 && (kc < 1 || kt % kc || kc > 256 || ns < 1 || ns > 16))) {
    fprintf(stderr, "unsupported mm case\n");
    return 2;
  }
  const long long ld = 132LL * cols, rows = 1LL * TILES * kt;
  float *w = nullptr, *x = nullptr, *out = nullptr;
  const size_t nout = 132ull * TILES * RP * cols;
  if (cudaMalloc(&w, rows * ld * 4) != cudaSuccess
      || cudaMalloc(&x, RP * XLD * 4) != cudaSuccess
      || cudaMalloc(&out, nout * 4) != cudaSuccess) {
    fprintf(stderr, "out of device memory\n");
    return 1;
  }
  fill<<<1024, 256>>>(w, rows, ld, x);
  cudaMemset(out, 0, nout * 4);
  // map 0 for the whole region, then one a (CTA, tile) (FLAGS 8)
  std::vector<CUtensorMap> maps(1 + 132 * TILES);
  const int bw = cols < 256 ? cols : 256;
  if (mode != 6) {
    if (!encode(enc, &maps[0], w, ld, rows, ld * 4, bw, kc)) return 1;
    for (int b = 0; b < 132; ++b)
      for (int t = 0; t < TILES; ++t)
        if (!encode(enc, &maps[1 + b * TILES + t],
                    w + 1LL * t * kt * ld + 1LL * b * cols, cols, kt, ld * 4,
                    bw, kc))
          return 1;
  }
  CUtensorMap* dmap = nullptr;
  cudaMalloc(&dmap, maps.size() * sizeof(CUtensorMap));
  cudaMemcpy(dmap, maps.data(), maps.size() * sizeof(CUtensorMap),
             cudaMemcpyHostToDevice);
  const int xk = (kc + 3) / 4 * 4 + 4;
  const int sbytes = (cols * kc * 4 + RP * xk * 4 + 127) / 128 * 128;
  const int smem = mode == 6 ? (4096 + RP * kt) * 4
                             : 256 + 4096 * 4 + ns * sbytes
                                   + (flags & 2 ? RP * kt * 4 : 0);
  if (smem > 232448) {
    fprintf(stderr, "%d bytes of shared memory\n", smem);
    return 2;
  }
  auto launch = [&]() {
    if (mode == 6) {
      if (cpt == 1) mm_reg<1, 16><<<ctas, 512, smem>>>(w, x, cols, out);
      else mm_reg<2, 8><<<ctas, 512, smem>>>(w, x, cols, out);
    } else if (cpt == 1) {
      mm_ring<1><<<ctas, 512, smem>>>(dmap, x, cols, kc, ns, mode, flags,
                                     out);
    } else if (cpt == 2) {
      mm_ring<2><<<ctas, 512, smem>>>(dmap, x, cols, kc, ns, mode, flags,
                                     out);
    } else {
      mm_ring<3><<<ctas, 512, smem>>>(dmap, x, cols, kc, ns, mode, flags,
                                     out);
    }
  };
  cudaFuncSetAttribute(mm_reg<1, 16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mm_reg<2, 8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mm_ring<1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mm_ring<2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(mm_ring<3>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaEventRecord(a);
  for (int i = 0; i < 5; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const cudaError_t e = cudaGetLastError();
  // check CTAs 0 and 131 against the host's sums (exact: small integers)
  std::vector<float> h(nout);
  cudaMemcpy(h.data(), out, nout * 4, cudaMemcpyDeviceToHost);
  long long bad = 0;
  for (int blk : {0, ctas - 1})
    for (int t = 0; t < TILES; ++t)
      for (int r = 0; r < RP; ++r)
        for (int c = 0; c < cols; ++c) {
          double want = 0;
          const long long gc = 1LL * blk * cols + c;
          for (int k = 0; k < kt; ++k)
            want += (k % 5 + r) * static_cast<double>(
                        (1LL * t * kt + k + gc) % 7 - 3);
          const float got =
              h[((1ull * blk * TILES + t) * RP + r) * cols + c];
          bad += got != static_cast<float>(want);
        }
  const double bytes = 1.0 * ctas * TILES * TILE_BYTES;
  printf("mode %d cols %d kc %d ns %d flags %d threads %d ctas %d: %.3f ms, "
         "%.2f TB/s, %.1f GB/s per SM, %lld wrong sums (%s)\n", mode, cols,
         mode == 6 ? 0 : kc, mode == 6 ? 0 : ns, flags, nc, ctas, ms,
         bytes / ms / 1e9,
         bytes / ms / 1e6 / ctas, bad, cudaGetErrorString(e));
  cudaFree(w);
  cudaFree(x);
  cudaFree(out);
  cudaFree(dmap);
  return e == cudaSuccess && bad == 0 ? 0 : 1;
}

int main(int argc, char** argv) {
  if (argc < 5 || argc > 7) {
    fprintf(stderr, "usage: %s MODE COLS KC NS [FLAGS [CTAS]]\n", argv[0]);
    return 2;
  }
  const int mode = atoi(argv[1]), cols = atoi(argv[2]), kc = atoi(argv[3]);
  const int ns = atoi(argv[4]), flags = argc >= 6 ? atoi(argv[5]) : 0;
  const int ctas = argc == 7 ? atoi(argv[6]) : 132;
  if (ctas < 1 || ctas > 132) return 2;
  if (mode >= 6) {
    void* fp = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fp, cudaEnableDefault,
                            &found);
    if (found != cudaDriverEntryPointSuccess) return 1;
    return run_mm(reinterpret_cast<Encode>(fp), mode, cols, kc, ns, flags,
                  ctas);
  }
  const size_t n = static_cast<size_t>(CTAS) * ROWS * LD;
  float *base = nullptr, *xsrc = nullptr, *out = nullptr;
  if (cudaMalloc(&base, n * 4) != cudaSuccess
      || cudaMalloc(&xsrc, 2 * 8192 * 4 + 1024) != cudaSuccess
      || cudaMalloc(&out, 4) != cudaSuccess) {
    fprintf(stderr, "out of device memory\n");
    return 1;
  }
  cudaMemset(base, 0, n * 4);
  cudaMemset(xsrc, 0, 2 * 8192 * 4 + 1024);
  void* fp = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fp, cudaEnableDefault,
                          &found);
  if (found != cudaDriverEntryPointSuccess) return 1;
  const Encode enc = reinterpret_cast<Encode>(fp);
  std::vector<CUtensorMap> maps(CTAS + 1);
  for (int b = 0; b < CTAS; ++b)
    if (!encode(enc, &maps[b], base + static_cast<size_t>(b) * ROWS * LD,
                cols, ROWS, LD * 4, cols, kc))
      return 1;
  if (!encode(enc, &maps[CTAS], xsrc, 8192, 2, 8192 * 4, kc, 2)) return 1;
  CUtensorMap* dmaps = nullptr;
  cudaMalloc(&dmaps, maps.size() * sizeof(CUtensorMap));
  cudaMemcpy(dmaps, maps.data(), maps.size() * sizeof(CUtensorMap),
             cudaMemcpyHostToDevice);
  const int smem = 256 + ns * (cols * kc * 4 + 2048);
  cudaFuncSetAttribute(stream, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  stream<<<CTAS, 512, smem>>>(base, dmaps, xsrc, cols, kc, ns, mode, out);
  cudaEventRecord(a);
  for (int i = 0; i < 5; ++i)
    stream<<<CTAS, 512, smem>>>(base, dmaps, xsrc, cols, kc, ns, mode, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const cudaError_t e = cudaGetLastError();
  const double bytes = static_cast<double>(CTAS) * ROWS * cols * 4;
  printf("mode %d cols %d kc %d ns %d: %.3f ms, %.2f TB/s, %.1f GB/s per "
         "SM (%s)\n", mode, cols, kc, ns, ms, bytes / ms / 1e9,
         bytes / ms / 1e6 / CTAS, cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
