// The standalone kernels of the port: a GEMM, a row RMSNorm and a
// FlashAttention forward, each for float32 and bfloat16 inputs, written by
// hand for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (repro_torch/kernels/build.py loads it with ctypes).  Every entry point
// launches on the caller's stream, allocates nothing, and returns the
// cudaGetLastError() code of its launch, or SK_ENCODE_ERROR plus the
// CUresult of a tensor map the driver refused; the wrapper raises it.
//
// Replaces the Pallas kernels of the JAX package:
//   sk_matmul          repro/kernels/matmul.py `matmul` (pallas_call :48)
//   sk_rmsnorm         repro/kernels/rmsnorm.py `rmsnorm` (pallas_call :27)
//   sk_flash_attention repro/kernels/flash_attention.py `flash_attention`
//                      (pallas_call :77)
// Each computes in float32 and stores in the input's type, rounding to
// nearest even, as the reference does.  No fast math: expf, rsqrtf and true
// division; only the bf16 attention takes exp2f of logits in log2 units,
// whose 2-ulp error lies far below a bf16 output's rounding.
//
// bfloat16 runs on the tensor cores: wgmma.mma_async (bf16 x bf16 products,
// exact in f32, f32 accumulators) on tiles that TMA copies into shared
// memory with the 128-byte swizzle, in rings of stages guarded by
// full/empty mbarriers; one producer thread (a warpgroup whose registers
// setmaxnreg lowers) issues the copies, two consumer warpgroups of 64 rows
// each issue the wgmmas.  float32 runs on FFMA: no TF32, whose 10-bit
// mantissa the f32 tolerances of the reference's tests (1e-4 at K = 512,
// 2e-5 for attention) leave no room for; its tiles arrive by 16-byte
// cp.async so that the next copy runs under the current FFMAs.
//
// Bounds on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor cores, 67
// TFLOP/s f32 FFMA):
//   matmul bf16: bytes at deepseek-7b's (256, 4096) x (4096, 11008), where B
//     is 92 % of them: a persistent grid of min(tiles, SMs) CTAs walks
//     128 x BN output tiles (BN in {128, 192}, picked by the wrapper
//     so that the tiles fill the SMs in the fewest waves), the two M halves
//     of a B tile on neighbouring CTAs so that L2 serves the second read;
//     K in slabs of 64 through a 5-6 stage ring.
//   matmul f32: operations; the register-tiled SGEMM: a 128 x 128 tile per
//     CTA of 256 threads (one CTA an SM: two would cap the registers at 128
//     and spill), an 8 x 8 register tile per thread, K in slabs of 32
//     through a 4-stage cp.async ring with one barrier a slab.  When the
//     tiles would leave SMs idle, K is split (the wrapper picks the count)
//     and a second kernel sums the f32 partial tiles in split order: no
//     atomics, so two launches agree bit for bit.
//   rmsnorm: bytes (a handful of FLOPs per element).  Rows whose x, w and
//     y are 16-byte aligned with a unit inner stride, and whose width and
//     row stride are whole 16-byte vectors, take the vector kernel: TPR
//     threads a row (32 to 1024, 16 elements each: 4 vectors in f32, 2
//     in bf16, which measured faster than 4 at deepseek-7b's width),
//     several rows a CTA at narrow widths while the grid still covers
//     every SM, x read once with 16-byte loads and held in registers
//     from the sum of squares to the scaled store (rows of up to 16,384
//     elements; wider rows read the rest again), the sum reduced by warp
//     shuffles
//     and, across a row's warps, one barrier.  Other rows (strided,
//     unaligned, or a width that is not whole vectors) take the scalar
//     kernel: one CTA of 256 threads a row, x read twice.
//   flash attention: operations at the model's widths (4 S^2 H hd FLOPs,
//     half of it under the causal mask, against 4 S H hd elements).  Head
//     widths up to 256: the kernels are built at HD in {64, 128, 256} and
//     read hd <= HD columns, the rest zero (zero columns change no entry of
//     q k^T; the output drops them).  Key tiles wholly above the diagonal
//     are skipped and the heaviest (last) query blocks launch first.
//     bf16 (FA3-like): one CTA per (batch x head, 128-query block); Q once
//     by TMA, K and V tiles (a 4-D tensor map over the (B, S, H, hd)
//     strides) of BK = 8192 / HD keys (the most the consumers' registers
//     hold: HD / 2 accumulators of O, BK / 2 logits, BK / 4 words each of
//     P hi and lo) through a 4-stage ring; S = Q K^T by wgmma, scaled in
//     f32 after the product; the online softmax in registers; P split into
//     bf16 hi = bf16(P) and lo = bf16(P - hi), O += hi V + lo V by two
//     register-A wgmmas (a bf16 P alone moves ~40 % of the outputs' bits
//     against the f32 algorithm, the split ~0.2 %).
//     f32: one CTA of 256 threads per (batch x head, 128-query block); each
//     thread holds 8 query rows: 8 x BK/16 logits and 8 x HD/16 outputs; K
//     and V tiles by cp.async, each copy under the other's math (K of the
//     next tile under this tile's softmax and P V, V under Q K^T).
//     Wider heads (hd > 256; the reference takes any hd), f32 and bf16
//     alike: flash_kernel_wide, one CTA per (batch x head, 32-query block,
//     256-column slice of the output), the logits recomputed by every
//     slice over hd in 64-column chunks staged in shared memory, all in
//     f32 on FFMA.  Simple, not tuned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, cp.async, wgmma (inline PTX).
// ---------------------------------------------------------------------------

// a wait longer than this is a fault (a copy that never lands): the
// kernel traps, and the launch fails, rather than hang the card
constexpr unsigned long long SK_DEADLINE_NS = 5000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
      " selp.u32 %0, 1, 0, p;}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > SK_DEADLINE_NS) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared, the last 16 - bytes of them zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to wgmma registers across the
// asynchronous instructions that own them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor of a tile in the 128-byte swizzle that
// TMA's CU_TENSOR_MAP_SWIZZLE_128B writes (rows of 128 bytes, repeating
// every 8 rows; tiles start on 1024-byte boundaries).  K-major: the rows
// are the M or N index, sbo = 1024 (the next 8 rows), lbo unused (16).
// MN-major: the rows are the K index, 64 M/N elements wide; sbo = 1024 (the
// next 8 K rows), lbo = the bytes between 64-wide column blocks.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16: D (64 x N) in registers as
// the m64nN accumulator layout (thread t of the warpgroup: rows
// 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1});
// B from shared memory (TB = 0 K-major, 1 MN-major); A from shared memory
// (K-major) or from registers (the m16n8k16 A fragment of the warp's 16
// rows).  scale_d = 0 overwrites D.
#define SK_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SK_D32(i) SK_D8(i), SK_D8(i + 8), SK_D8(i + 16), SK_D8(i + 24)

template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, %19;}\n"
      : SK_D8(0), SK_D8(8)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, %35;}\n"
      : SK_D32(0)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, %67;}\n"
      : SK_D32(0), SK_D32(32)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, %96, %97, p, 1, 1, 0, %99;}\n"
      : SK_D32(0), SK_D32(32), SK_D32(64)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;}\n"
      : SK_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, %70;}\n"
      : SK_D32(0), SK_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, %134;}\n"
      : SK_D32(0), SK_D32(32), SK_D32(64), SK_D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32)
    wgmma_ss_n32<TB>(d, a, b, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64<TB>(d, a, b, scale_d);
  else if constexpr (N == 128)
    wgmma_ss_n128<TB>(d, a, b, scale_d);
  else
    wgmma_ss_n192<TB>(d, a, b, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_rs_n64<TB>(d, a, b, scale_d);
  else if constexpr (N == 128)
    wgmma_rs_n128<TB>(d, a, b, scale_d);
  else
    wgmma_rs_n256<TB>(d, a, b, scale_d);
}

// dynamic shared memory rounded up to the 1024 bytes the swizzle needs
__device__ __forceinline__ uint8_t* smem_1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// the 384 threads of a TMA/wgmma kernel: warpgroup 0 produces (its thread 0
// issues every copy), warpgroups 1 and 2 consume, 64 rows each
constexpr int WG_THREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// ---------------------------------------------------------------------------
// matmul bf16: c (M, N) = a (M, K) @ b (K, N) on the tensor cores.  a is
// read K-major and b MN-major (each with a unit inner stride; the wrapper
// copies any other layout), both by TMA from the maps the entry point
// encodes; c is contiguous.
// ---------------------------------------------------------------------------

template <int BN>
struct MmCfg {
  static constexpr int BM = 128, BK = 64;
  static constexpr int A_BYTES = BM * BK * 2;  // [128 rows][64 k], 16 KB
  static constexpr int B_BLOCK = BK * 64 * 2;  // [64 k][64 n], 8 KB
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_BLOCK;
  static constexpr int STAGES = BN == 192 ? 5 : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    matmul_kernel_wgmma(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  using C = MmCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int mt = (M + C::BM - 1) / C::BM, nt = (N + BN - 1) / BN;
  const int tiles = mt * nt, kbs = (K + C::BK - 1) / C::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      // tiles in M-fastest order: the M halves of one B tile run on
      // neighbouring CTAs at the same time
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * C::BM, n0 = (tile / mt) * BN;
        for (int kb = 0; kb < kbs; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * C::STAGE;
          mbar_expect_tx(&full[stage], C::STAGE);
          tma_load_2d(st, &map_a, &full[stage], kb * C::BK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + C::A_BYTES + j * C::B_BLOCK, &map_b,
                        &full[stage], n0 + j * 64, kb * C::BK);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4,
              lane = threadIdx.x % 32;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * C::BM, n0 = (tile / mt) * BN;
      int held = -1;  // the stage the wgmmas in flight read
      for (int kb = 0; kb < kbs; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * C::STAGE;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BK / 16; ++k)
          wgmma_ss<BN, 1>(
              acc, smem_desc(st + cw * 64 * 128 + k * 32, 16, 1024),
              smem_desc(st + C::A_BYTES + k * 16 * 128, C::B_BLOCK, 1024),
              kb > 0 || k > 0);
        wgmma_commit();
        // one group stays in flight: the one before it is done, so its
        // stage goes back to the producer
        wgmma_wait<1>();
        fence_regs(acc);
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      // the tile's rows of this thread: r and r + 8, columns 8 j + 2 (lane
      // % 4) + {0, 1}; pairs stored as one bf16x2 where both fit
      const int r = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r + 8 * h;
        if (row >= M) continue;
        __nv_bfloat16* out = c + row * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + j * 8 + 2 * (lane % 4);
          const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
          if (col + 1 < N && (N % 2) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < N) out[col] = __float2bfloat16(v0);
            if (col + 1 < N) out[col + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// matmul f32: c (M, N) = a (M, K) @ b (K, N) on FFMA; a and b with a unit
// inner stride and rows on 16-byte boundaries (the wrapper copies any other
// layout).  A grid of (M tiles) x (splits) x (N tiles) CTAs, M fastest;
// split z sums its contiguous range of K slabs into out + z M N.
// ---------------------------------------------------------------------------

constexpr int MF_BM = 128, MF_BN = 128, MF_BK = 32, MF_STAGES = 4,
              MF_THREADS = 256;
constexpr int MF_ALD = MF_BK + 4;  // A rows padded: a warp's two rows of one
                                   // float4 read fall in other banks
constexpr int MF_A = MF_BM * MF_ALD, MF_B = MF_BK * MF_BN;  // floats
constexpr size_t MF_SMEM = sizeof(float) * MF_STAGES * (MF_A + MF_B);

// a thread's copies of one slab: A's rows r + 32 i (r = tid / 8) at column
// chunk tid % 8, B's rows r' + 8 i (r' = tid / 32) at column chunk tid % 32
// (i < 4), each 16 bytes, zero past M, N and K.  The row pointers and the
// M and N masks are the thread's own for the whole kernel.
struct MfLoader {
  const float* a;  // a + (m0 + r) sam + column
  const float* b;  // b + r' sbk + n0 + column
  long long a_step, ak, bn_left;
  int a_rows, a_off, b_off, kr;  // rows of A in range; smem offsets

  __device__ __forceinline__ MfLoader(const float* __restrict__ a0,
                                      const float* __restrict__ b0,
                                      long long M, long long N, long long sam,
                                      long long sbk, long long m0,
                                      long long n0) {
    const int tid = threadIdx.x;
    const int ar = tid >> 3, ac = (tid & 7) * 4;
    const int br = tid >> 5, bc = (tid & 31) * 4;
    a = a0 + (m0 + ar) * sam + ac;
    b = b0 + br * sbk + n0 + bc;
    a_step = 32 * sam;
    ak = ac;
    const long long rows_left = M - m0 - ar;  // rows ar + 32 i < M
    a_rows = rows_left <= 0 ? 0 : (int)min(4LL, (rows_left + 31) / 32);
    bn_left = N - n0 - bc;
    a_off = ar * MF_ALD + ac;
    b_off = br * MF_BN + bc;
    kr = br;
  }

  __device__ __forceinline__ void load(float* As, float* Bs, long long K,
                                       long long k0, long long sbk) const {
    const long long k = k0 + ak;
    const int abytes = k < K ? (int)min(16LL, 4 * (K - k)) : 0;
    const int bbytes = bn_left > 0 ? (int)min(16LL, 4 * bn_left) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ain = i < a_rows && abytes > 0;
      cp_async16(As + a_off + i * 32 * MF_ALD,
                 ain ? a + i * a_step + k0 : a, ain ? abytes : 0);
      const bool bin = k0 + kr + 8 * i < K && bbytes > 0;
      cp_async16(Bs + b_off + i * 8 * MF_BN,
                 bin ? b + (k0 + 8 * i) * sbk : b, bin ? bbytes : 0);
    }
  }
};

__global__ void __launch_bounds__(MF_THREADS, 1)
    matmul_kernel_ffma(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       long long M, long long N, long long K, long long sam,
                       long long sbk, int splits) {
  extern __shared__ __align__(16) float mf_smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long mt = (M + MF_BM - 1) / MF_BM;
  long long u = blockIdx.x;
  const long long m0 = (u % mt) * MF_BM;
  u /= mt;
  const int split = (int)(u % splits);
  const long long n0 = (u / splits) * MF_BN;
  const long long slabs = (K + MF_BK - 1) / MF_BK;
  const long long s0 = slabs * split / splits;
  const int n_slabs = (int)(slabs * (split + 1) / splits - s0);
  out += split * M * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const MfLoader ld(a, b, M, N, sam, sbk, m0, n0);
#pragma unroll
  for (int s = 0; s < MF_STAGES - 1; ++s) {
    if (s < n_slabs) {
      float* As = mf_smem + s * (MF_A + MF_B);
      ld.load(As, As + MF_A, K, (s0 + s) * MF_BK, sbk);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_slabs; ++t) {
    cp_async_wait<MF_STAGES - 2>();
    __syncthreads();  // slab t landed; every thread is done with slab t - 1
    const int nx = t + MF_STAGES - 1;
    if (nx < n_slabs) {  // into slab t - 1's stage, under slab t's FFMAs
      float* As = mf_smem + (nx % MF_STAGES) * (MF_A + MF_B);
      ld.load(As, As + MF_A, K, (s0 + nx) * MF_BK, sbk);
    }
    cp_async_commit();
    const float* As = mf_smem + (t % MF_STAGES) * (MF_A + MF_B);
    const float* Bs = As + MF_A;
    // a thread's rows are ty*4 + {0..3} and 64 + ty*4 + {0..3}, its columns
    // tx*4 + {0..3} and 64 + tx*4 + {0..3}
#pragma unroll
    for (int kk = 0; kk < MF_BK; kk += 4) {
      float av[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        const float4 v =
            *reinterpret_cast<const float4*>(As + row * MF_ALD + kk);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(Bs + (kk + q) * MF_BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            Bs + (kk + q) * MF_BN + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i][q], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (m >= M) continue;
    float* row = out + m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + h * 64 + tx * 4;
      if (n + 3 < N && (N % 4) == 0) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// c = sum over z of ws[z] (each M N), in the order z = 0, 1, ...
__global__ void matmul_reduce_kernel(const float* __restrict__ ws,
                                     float* __restrict__ c, long long mn,
                                     int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    c[i] = s;
  }
}

// ---------------------------------------------------------------------------
// rmsnorm: y[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, statistics in f32.
// ---------------------------------------------------------------------------

constexpr int RMS_THREADS = 256;   // scalar kernel: threads a row
constexpr int RMS_EPT = 16;        // vector kernel: elements a thread holds
constexpr int RMS_CTA = 256;       // vector kernel: threads a CTA at most,
                                   // unless a row needs more

// The scalar kernel: any strides and alignment; x is read twice.
template <typename T>
__global__ void __launch_bounds__(RMS_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, long long d, long long sx0,
                   long long sx1, long long sw, float eps) {
  __shared__ float part[RMS_THREADS / 32];
  __shared__ float rinv;
  const T* xr = x + (long long)blockIdx.x * sx0;
  T* yr = y + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (long long i = threadIdx.x; i < d; i += RMS_THREADS) {
    const float v = to_f32(xr[i * sx1]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < RMS_THREADS / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) rinv = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = rinv;
  for (long long i = threadIdx.x; i < d; i += RMS_THREADS)
    yr[i] = from_f32<T>(to_f32(xr[i * sx1]) * r * to_f32(w[i * sw]));
}

// The squares of a 16-byte vector's elements, summed in order.
__device__ __forceinline__ float vec_sumsq(const uint4& v, float) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y),
              c = __uint_as_float(v.z), e = __uint_as_float(v.w);
  return a * a + b * b + c * c + e * e;
}
__device__ __forceinline__ float vec_sumsq(const uint4& v, __nv_bfloat16) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    s += f.x * f.x + f.y * f.y;
  }
  return s;
}

// x * r * w elementwise over a 16-byte vector, rounded to the type.
__device__ __forceinline__ uint4 vec_scale(const uint4& x, const uint4& w,
                                           float r, float) {
  return make_uint4(
      __float_as_uint(__uint_as_float(x.x) * r * __uint_as_float(w.x)),
      __float_as_uint(__uint_as_float(x.y) * r * __uint_as_float(w.y)),
      __float_as_uint(__uint_as_float(x.z) * r * __uint_as_float(w.z)),
      __float_as_uint(__uint_as_float(x.w) * r * __uint_as_float(w.w)));
}
__device__ __forceinline__ uint4 vec_scale(const uint4& x, const uint4& w,
                                           float r, __nv_bfloat16) {
  const unsigned xu[4] = {x.x, x.y, x.z, x.w}, wu[4] = {w.x, w.y, w.z, w.w};
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xu[k]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wu[k]));
    const __nv_bfloat162 v = __floats2bfloat162_rn(a.x * r * b.x,
                                                   a.y * r * b.y);
    o[k] = *reinterpret_cast<const unsigned*>(&v);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The vector kernel: `tpr` threads (a multiple of 32) a row, blockDim.x /
// tpr rows a CTA; rows of nv = d / (16 / sizeof(T)) vectors with the row
// stride sx0 (elements), x, w and y 16-byte aligned, y packed.  Each
// thread loads its first VPT vectors of x and w before any arithmetic,
// so a row is in flight at once, and keeps them for the store; vectors
// past tpr * VPT are read again.
template <typename T>
__global__ void __launch_bounds__(1024)
    rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ y, long long rows, long long nv,
                       long long sx0, float fd, float eps, int tpr) {
  constexpr int VPT = RMS_EPT * sizeof(T) / 16;
  __shared__ float part[32];
  const int t = threadIdx.x % tpr, g = threadIdx.x / tpr;
  const long long r = (long long)blockIdx.x * (blockDim.x / tpr) + g;
  const bool live = r < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? r : 0) * sx0);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + r * nv * (16 / sizeof(T)));
  uint4 xk[VPT], wk[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const long long j = t + (long long)k * tpr;
    if (live && j < nv) {
      xk[k] = xr[j];
      wk[k] = __ldg(wv + j);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (live && t + (long long)k * tpr < nv) ss += vec_sumsq(xk[k], T());
  for (long long j = t + (long long)VPT * tpr; live && j < nv; j += tpr)
    ss += vec_sumsq(xr[j], T());
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {                       // across the row's warps
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = g * (tpr / 32);
    ss = 0.f;
    for (int k = 0; k < tpr / 32; ++k) ss += part[w0 + k];
  }
  if (!live) return;
  const float rinv = rsqrtf(ss / fd + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const long long j = t + (long long)k * tpr;
    if (j < nv) yr[j] = vec_scale(xk[k], wk[k], rinv, T());
  }
  for (long long j = t + (long long)VPT * tpr; j < nv; j += tpr)
    yr[j] = vec_scale(xr[j], __ldg(wv + j), rinv, T());
}

// ---------------------------------------------------------------------------
// flash attention: o (B, S, H, hd) = softmax(q k^T / sqrt(hd)) v per (b, h),
// causal or not, with the reference's masking: -1e30 above the diagonal,
// -inf past S, the running max from -1e30, the row sum clamped at 1e-30.
// The kernels are built at HD in {64, 128, 256} and take hd <= HD.
// ---------------------------------------------------------------------------

// the last key a query block sees, and so its number of key tiles
__device__ __forceinline__ int fa_tiles(long long q0, int bq, int bk,
                                        long long S, int causal) {
  const long long last = causal && q0 + bq < S ? q0 + bq - 1 : S - 1;
  return (int)(last / bk + 1);
}

template <int HD>
struct FaCfg {  // bf16, tensor cores
  // key tiles as wide as the registers allow: a consumer thread holds
  // HD / 2 accumulators of O, BK / 2 logits and BK / 4 words of P hi and lo
  static constexpr int BQ = 128, BK = 8192 / HD, CH = HD / 64;
  static constexpr int Q_BYTES = BQ * HD * 2;   // CH blocks of [128][64]
  static constexpr int KV_BYTES = BK * HD * 2;  // CH blocks of [BK][64]
  static constexpr int STAGES = 4;
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + (1 + 3 * STAGES) * 8;
};

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int H, int S, int hd,
                       int causal, float scale) {
  using C = FaCfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, CH = C::CH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + C::Q_BYTES;                  // [stage]
  uint8_t* Vs = Ks + C::STAGES * C::KV_BYTES;     // [stage]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + C::STAGES;
  uint64_t* empty = vfull + C::STAGES;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int n_tiles = fa_tiles(q0, BQ, BK, S, causal);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load_4d(Qs + c * BQ * 128, &map_q, qbar, c * 64, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kst = Ks + stage * C::KV_BYTES;
        uint8_t* vst = Vs + stage * C::KV_BYTES;
        mbar_expect_tx(&kfull[stage], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_4d(kst + c * BK * 128, &map_k, &kfull[stage], c * 64,
                      t * BK, h, b);
        mbar_expect_tx(&vfull[stage], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_4d(vst + c * BK * 128, &map_v, &vfull[stage], c * 64,
                      t * BK, h, b);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1, warp = (threadIdx.x / 32) % 4,
              lane = threadIdx.x % 32;
    // this thread's rows: q0 + r0 and q0 + r0 + 8 (h = 0, 1 below); its
    // columns of S and O: 8 j + 2 (lane % 4) + {0, 1}
    const int r0 = cw * 64 + warp * 16 + lane / 4;
    float s[BK / 2], acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    const float scale_log2 = scale * 1.44269504088896341f;
    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;
      // S = Q K^T (bf16 in, f32 out)
      mbar_wait(&kfull[stage], phase);
      const uint8_t* kst = Ks + stage * C::KV_BYTES;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_ss<BK, 0>(
              s,
              smem_desc(Qs + c * BQ * 128 + cw * 64 * 128 + k * 32, 16, 1024),
              smem_desc(kst + c * BK * 128 + k * 32, 16, 1024), c > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      // the online softmax, in f32, on logits in log2 units (exp2 of them is
      // exp of the natural ones; its 2-ulp error is far below bf16's
      // rounding); a row's 4 threads are one lane quad, its max and sum run
      // as 4 interleaved chains.  Only the tiles that cross the diagonal or
      // S of this warpgroup's rows are masked.
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > q0 + cw * 64);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = q0 + r0 + 8 * hh;
        float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + 2 * (lane % 4) + e;
            float x = s[4 * j + 2 * hh + e] * scale_log2;
            if (masked) {
              if (kj >= S)
                x = -INFINITY;  // past the sequence: weight exactly 0
              else if (causal && kj > qi)
                x = -1e30f;  // the reference's mask value
            }
            s[4 * j + 2 * hh + e] = x;
            mx4[(2 * j + e) % 4] = fmaxf(mx4[(2 * j + e) % 4], x);
          }
        float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        float sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * hh + e] - m_new);
            s[4 * j + 2 * hh + e] = p;
            sum4[(2 * j + e) % 4] += p;
          }
        float sum = (sum4[0] + sum4[1]) + (sum4[2] + sum4[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float corr = exp2f(m[hh] - m_new);
        l[hh] = l[hh] * corr + sum;
        m[hh] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j + 2 * hh] *= corr;
          acc[4 * j + 2 * hh + 1] *= corr;
        }
      }
      // P = hi + lo in bf16, as the A fragments of the key blocks of 16:
      // register r of block kk holds the pair at s[8 kk + 2 r]
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
          __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          phi[kk][r] = *reinterpret_cast<uint32_t*>(&hi);
          plo[kk][r] =
              pack_bf16(x - __low2float(hi), y - __high2float(hi));
        }
      // O += hi V + lo V
      mbar_wait(&vfull[stage], phase);
      const uint8_t* vst = Vs + stage * C::KV_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vd = smem_desc(vst + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<HD, 1>(acc, phi[kk], vd, 1);
        wgmma_rs<HD, 1>(acc, plo[kk], vd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // o = acc / max(l, 1e-30), in o's contiguous (B, S, H, hd) layout
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long qi = q0 + r0 + 8 * hh;
      if (qi >= S) continue;
      const float denom = fmaxf(l[hh], 1e-30f);
      __nv_bfloat16* orow = o + ((b * (long long)S + qi) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float v0 = acc[4 * j + 2 * hh] / denom;
        const float v1 = acc[4 * j + 2 * hh + 1] / denom;
        if (col + 1 < hd && (hd % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < hd) orow[col] = __float2bfloat16(v0);
          if (col + 1 < hd) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int HD>
struct FfCfg {  // f32, FFMA
  static constexpr int BQ = 128, BK = HD == 256 ? 32 : 64, THREADS = 256;
  static constexpr int LD = HD + 4;    // Q and K rows: an odd number of
                                       // 16-byte units, so 8 rows' float4s
                                       // fall in 8 bank groups
  static constexpr int PLD = BK + 16;  // P rows: a warp's two half warps
                                       // write other banks
  static constexpr int Q = BQ * LD, K = BK * LD, V = BK * HD, P = BQ * PLD;
  static constexpr size_t SMEM = sizeof(float) * (Q + K + V + P);
  static constexpr int MIN_BLOCKS = HD == 64 ? 2 : 1;
};

// rows [r0, r0 + ROWS) of one (b, h) slice, HD columns, into dst (row
// stride LDD) by 16-byte cp.async: zero past S and past hd
template <int HD, int ROWS, int LDD>
__device__ __forceinline__ void ff_load(float* dst,
                                        const float* __restrict__ src,
                                        long long r0, long long S,
                                        long long ss, int hd) {
  constexpr int CHUNKS = HD / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += 256) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 4;
    const bool in = r0 + r < S && c < hd;
    cp_async16(dst + r * LDD + c, in ? src + (r0 + r) * ss + c : src,
               in ? min(16, 4 * (hd - c)) : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(256, FfCfg<HD>::MIN_BLOCKS)
    flash_kernel_ffma(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int H, long long S, int hd, long long sqb,
                      long long sqs, long long sqh, long long skb,
                      long long sks, long long skh, long long svb,
                      long long svs, long long svh, int causal,
                      float scale) {
  using C = FfCfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, CJ = BK / 16, G = HD / 64;
  extern __shared__ __align__(16) float ff_smem[];
  float* Qs = ff_smem;
  float* Ks = Qs + C::Q;
  float* Vs = Ks + C::K;
  float* Ps = Vs + C::V;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long q0 = (long long)(gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const int n_tiles = fa_tiles(q0, BQ, BK, S, causal);

  ff_load<HD, BQ, C::LD>(Qs, qb, q0, S, sqs, hd);
  ff_load<HD, BK, C::LD>(Ks, kb, 0, S, sks, hd);
  cp_async_commit();

  // a thread owns query rows ty + 16 i (i < 8); in S the keys tx + 16 j
  // (j < CJ), in O the head columns g*64 + tx*4 + {0..3} (g < G)
  float m[8], l[8], acc[8][4 * G];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const long long k0 = (long long)t * BK;
    cp_async_wait<0>();
    __syncthreads();  // K(t) (and Q) landed; every thread is done with V
    if (t == 0) {     // q * scale in f32 before the product, as the reference
      for (int e = tid; e < BQ * HD; e += 256)
        Qs[(e / HD) * C::LD + e % HD] *= scale;
      __syncthreads();
    }
    ff_load<HD, BK, HD>(Vs, vb, k0, S, svs, hd);  // under Q K^T
    cp_async_commit();

    float s[8][CJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * C::LD +
                                                 d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * C::LD + d);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V(t) landed; every thread is done with K(t)
    if (t + 1 < n_tiles)  // under the softmax and P V
      ff_load<HD, BK, C::LD>(Ks, kb, k0 + BK, S, sks, hd);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const long long kj = k0 + tx + 16 * j;
        if (kj >= S)
          s[i][j] = -INFINITY;  // past the sequence: weight exactly 0
        else if (causal && kj > qi)
          s[i][j] = -1e30f;  // the reference's mask value
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row are one half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(ty + 16 * i) * C::PLD + tx + 16 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * G; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's P is written and read by its own half warp

#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 vv[4][G];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int g = 0; g < G; ++g)
          vv[cc][g] = *reinterpret_cast<const float4*>(
              Vs + (c + cc) * HD + g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * C::PLD + c);
        const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[i][4 * g] = fmaf(p[cc], vv[cc][g].x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(p[cc], vv[cc][g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p[cc], vv[cc][g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p[cc], vv[cc][g].w, acc[i][4 * g + 3]);
          }
      }
    }
  }
  cp_async_wait<0>();
  // o = acc / max(l, 1e-30), in o's contiguous (B, S, H, hd) layout
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((b * S + qi) * H + h) * (long long)hd;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 64 + tx * 4;
      if (col + 3 < hd && (hd % 4) == 0) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
            acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < hd) orow[col + j] = acc[i][4 * g + j] / denom;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, shared-memory limits, launches.
// ---------------------------------------------------------------------------

// a refused tensor map returns SK_ENCODE_ERROR + its CUresult
constexpr int SK_ENCODE_ERROR = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

std::mutex g_mu;  // guards the caches below (ctypes drops the GIL)

// cuTensorMapEncodeTiled from the driver the runtime already loaded (the
// library links no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// encoded maps by (pointer, dims, strides, box): a call on the same tensors
// again encodes nothing
struct MapKey {
  const void* ptr;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  int rank;
};
struct MapEntry {
  MapKey key;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
MapEntry g_maps[MAP_CACHE];
int g_n_maps = 0, g_next_map = 0;

// a bf16 tensor map of rank 2 or 4 with the 128-byte swizzle; elements past
// dims read as zero
int bf16_map(CUtensorMap* out, int rank, const void* ptr,
             const cuuint64_t* dims, const cuuint64_t* strides_bytes,
             const cuuint32_t* box) {
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = ptr;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides_bytes[i];
  }
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_n_maps; ++i)
    if (memcmp(&g_maps[i].key, &key, sizeof key) == 0) {
      *out = g_maps[i].map;
      return 0;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return SK_ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return SK_ENCODE_ERROR + static_cast<int>(r);
  g_maps[g_next_map] = MapEntry{key, *out};
  g_next_map = (g_next_map + 1) % MAP_CACHE;
  if (g_n_maps < MAP_CACHE) ++g_n_maps;
  return 0;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per kernel and
// device
int allow_smem(const void* kernel, int bytes) {
  struct Done {
    const void* kernel;
    int device;
  };
  static Done done[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].kernel == kernel && done[i].device == dev) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_done < 64) done[n_done++] = Done{kernel, dev};
  return 0;
}

// flash attention at hd > 256: one CTA of 256 threads per (b·h, BQ-query
// block, DV-column slice of the output), so that the slice's O rows stay
// in registers (DV / 8 a thread).  Per BK-key tile: S = (q * scale) k^T
// over hd in DC-column chunks (q and k chunks staged in shared memory,
// thread (qi, kj0) summing 8 logits of query qi), the masked logits at
// -1e30, the online softmax of each query row across its 8 threads (warp
// shuffles), P and the tile's V slice through shared memory, O += P V.
// Keys past the query block's last row are skipped under the causal mask;
// rows past S and columns past hd read as zero and are not stored.
struct FwCfg {
  static constexpr int BQ = 32, BK = 64, DC = 64, DV = 256, THREADS = 256;
  static constexpr int LD = DC + 1, PLD = BK + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * LD + BK * LD + BQ * PLD + BK * DV);
};

template <typename T>
__global__ void __launch_bounds__(256)
    flash_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      long long S, int hd, long long sqb, long long sqs,
                      long long sqh, long long skb, long long sks,
                      long long skh, long long svb, long long svs,
                      long long svh, int causal, float scale) {
  using C = FwCfg;
  constexpr int BQ = C::BQ, BK = C::BK, DC = C::DC, DV = C::DV;
  constexpr int NO = DV / 8;           // O columns a thread
  extern __shared__ __align__(16) float fw_smem[];
  float* Qs = fw_smem;
  float* Ks = Qs + BQ * C::LD;
  float* Ps = Ks + BK * C::LD;
  float* Vs = Ps + BQ * C::PLD;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x, b = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long q0 = static_cast<long long>(blockIdx.y) * BQ;
  const int c0 = blockIdx.z * DV;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const int qi = tid / 8, kj0 = (tid % 8) * 8, oc = tid % 8;
  float m = -1e30f, l = 0.0f, acc[NO];
#pragma unroll
  for (int u = 0; u < NO; ++u) acc[u] = 0.0f;
  const long long kend = causal ? (q0 + BQ < S ? q0 + BQ : S) : S;
  for (long long k0 = 0; k0 < kend; k0 += BK) {
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += DC) {
      __syncthreads();                 // Qs and Ks are free
      for (int e = tid; e < BQ * DC; e += C::THREADS) {
        const int r = e / DC, c = e % DC;
        Qs[r * C::LD + c] = q0 + r < S && d0 + c < hd
            ? to_f32(qb[(q0 + r) * sqs + d0 + c]) * scale : 0.0f;
      }
      for (int e = tid; e < BK * DC; e += C::THREADS) {
        const int r = e / DC, c = e % DC;
        Ks[r * C::LD + c] = k0 + r < S && d0 + c < hd
            ? to_f32(kb[(k0 + r) * sks + d0 + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float qv = Qs[qi * C::LD + c];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = fmaf(qv, Ks[(kj0 + j) * C::LD + c], s[j]);
      }
    }
    float tmax = -1e30f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long key = k0 + kj0 + j;
      if (key >= S || (causal && key > q0 + qi)) s[j] = -1e30f;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, sh));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
      Ps[qi * C::PLD + kj0 + j] = s[j];
    }
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, sh);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    for (int e = tid; e < BK * DV; e += C::THREADS) {
      const int r = e / DV, c = e % DV;
      Vs[e] = k0 + r < S && c0 + c < hd
          ? to_f32(vb[(k0 + r) * svs + c0 + c]) : 0.0f;
    }
    __syncthreads();                   // P and the V slice are in place
#pragma unroll
    for (int u = 0; u < NO; ++u) acc[u] *= corr;
    for (int kj = 0; kj < BK; ++kj) {
      const float pv = Ps[qi * C::PLD + kj];
#pragma unroll
      for (int u = 0; u < NO; ++u)
        acc[u] = fmaf(pv, Vs[kj * DV + oc + 8 * u], acc[u]);
    }
  }
  if (q0 + qi >= S) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + ((b * S + q0 + qi) * H + h) * static_cast<long long>(hd);
#pragma unroll
  for (int u = 0; u < NO; ++u) {
    const int col = c0 + oc + 8 * u;
    if (col < hd) orow[col] = from_f32<T>(acc[u] / denom);
  }
}

template <int BN>
int launch_matmul_wgmma(const void* a, const void* b, void* c, long long m,
                        long long n, long long k, long long sam,
                        long long sbk, int sms, cudaStream_t stream) {
  using C = MmCfg<BN>;
  CUtensorMap ma, mb;
  const cuuint64_t da[2] = {(cuuint64_t)k, (cuuint64_t)m},
                   sa[1] = {(cuuint64_t)sam * 2};
  const cuuint32_t ba[2] = {64, C::BM};
  const cuuint64_t db[2] = {(cuuint64_t)n, (cuuint64_t)k},
                   sb[1] = {(cuuint64_t)sbk * 2};
  const cuuint32_t bb[2] = {64, C::BK};
  int err = bf16_map(&ma, 2, a, da, sa, ba);
  if (err == 0) err = bf16_map(&mb, 2, b, db, sb, bb);
  if (err == 0)
    err = allow_smem(reinterpret_cast<const void*>(&matmul_kernel_wgmma<BN>),
                     C::SMEM);
  if (err != 0) return err;
  const long long tiles = ((m + C::BM - 1) / C::BM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  matmul_kernel_wgmma<BN><<<grid, WG_THREADS, C::SMEM, stream>>>(
      ma, mb, static_cast<__nv_bfloat16*>(c), (int)m, (int)n, (int)k);
  return static_cast<int>(cudaGetLastError());
}

int launch_matmul_ffma(const void* a, const void* b, void* c, void* ws,
                       long long m, long long n, long long k, long long sam,
                       long long sbk, int splits, int sms,
                       cudaStream_t stream) {
  int err = allow_smem(reinterpret_cast<const void*>(&matmul_kernel_ffma),
                       (int)MF_SMEM);
  if (err != 0) return err;
  const long long units = ((m + MF_BM - 1) / MF_BM) * splits *
                          ((n + MF_BN - 1) / MF_BN);
  float* out = static_cast<float*>(splits > 1 ? ws : c);
  matmul_kernel_ffma<<<(unsigned)units, MF_THREADS, MF_SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), out, m, n,
      k, sam, sbk, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long mn = m * n, blocks = (mn + 255) / 256,
                  cap = 8LL * sms;
  matmul_reduce_kernel<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0,
                         stream>>>(out, static_cast<float*>(c), mn, splits);
  return static_cast<int>(cudaGetLastError());
}

// The vector kernel where the rows allow it (see the header), else the
// scalar one.  The vector kernel takes TPR = the row's elements over
// RMS_EPT, rounded up to whole warps (32-1024), and doubles the rows of a
// CTA while that stays within RMS_CTA threads and leaves a CTA for every
// one of the card's `sms` SMs.
template <typename T>
int launch_rmsnorm(const void* x, const void* w, void* y, long long rows,
                   long long d, long long sx0, long long sx1, long long sw,
                   float eps, long long sms, cudaStream_t stream) {
  constexpr long long E = 16 / sizeof(T);
  const bool vec = sx1 == 1 && sw == 1 && d % E == 0 && sx0 % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (!vec) {
    rmsnorm_kernel<T><<<(unsigned)rows, RMS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), d, sx0, sx1, sw, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nv = d / E;
  long long tpr = ((d + RMS_EPT - 1) / RMS_EPT + 31) / 32 * 32;
  tpr = tpr < 32 ? 32 : (tpr > 1024 ? 1024 : tpr);
  long long rpc = 1;
  while (2 * rpc * tpr <= RMS_CTA && (rows + 2 * rpc - 1) / (2 * rpc) >= sms)
    rpc *= 2;
  rmsnorm_vec_kernel<T><<<(unsigned)((rows + rpc - 1) / rpc),
                          (unsigned)(rpc * tpr), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rows, nv, sx0, (float)d, eps, (int)tpr);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       long long b, long long s, long long h, long long hd,
                       const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  using C = FaCfg<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const void* ptrs[3] = {q, k, v};
  const cuuint32_t rows[3] = {C::BQ, C::BK, C::BK};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {  // strides (b, s, h, d) of q, k, v
    const long long* t = st + 4 * i;
    const cuuint64_t strides[3] = {(cuuint64_t)t[1] * 2,
                                   (cuuint64_t)t[2] * 2,
                                   (cuuint64_t)t[0] * 2};
    const cuuint32_t box[4] = {64, rows[i], 1, 1};
    const int err = bf16_map(&maps[i], 4, ptrs[i], dims, strides, box);
    if (err != 0) return err;
  }
  const int err = allow_smem(
      reinterpret_cast<const void*>(&flash_kernel_wgmma<HD>), C::SMEM);
  if (err != 0) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + C::BQ - 1) / C::BQ));
  flash_kernel_wgmma<HD><<<grid, WG_THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), (int)h,
      (int)s, (int)hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_flash_ffma(const void* q, const void* k, const void* v, void* o,
                      long long b, long long s, long long h, long long hd,
                      const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  using C = FfCfg<HD>;
  const int err = allow_smem(
      reinterpret_cast<const void*>(&flash_kernel_ffma<HD>), (int)C::SMEM);
  if (err != 0) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + C::BQ - 1) / C::BQ));
  flash_kernel_ffma<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), (int)h, s,
      (int)hd, st[0], st[1], st[2], st[4], st[5], st[6], st[8], st[9],
      st[10], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash_wide(const void* q, const void* k, const void* v, void* o,
                      long long b, long long s, long long h, long long hd,
                      const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  using C = FwCfg;
  const int err = allow_smem(
      reinterpret_cast<const void*>(&flash_kernel_wide<T>), (int)C::SMEM);
  if (err != 0) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + C::BQ - 1) / C::BQ),
                  (unsigned)((hd + C::DV - 1) / C::DV));
  flash_kernel_wide<T><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)h, s, (int)hd,
      st[0], st[1], st[2], st[4], st[5], st[6], st[8], st[9], st[10],
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Shapes, strides (in elements) and limits
// are checked by the Python wrappers before the call: unit inner strides,
// other strides on 16-byte boundaries, M, N, K, S < 2**31.  An argument
// outside them returns cudaErrorInvalidValue.

// c = a @ b.  bf16: `variant` is the tile width BN (128 or 192),
// splits 1, a persistent grid of min(tiles, sms) CTAs.  f32: `splits` K
// ranges, each summed into ws + z m n (f32, splits m n elements) and then
// into c in split order by a second kernel; ws unused at 1.  `sms` is the
// card's SM count.
extern "C" int sk_matmul(const void* a, const void* b, void* c, void* ws,
                         long long m, long long n, long long k, long long sam,
                         long long sak, long long sbk, long long sbn,
                         int variant, int splits, int dtype, int sms,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sak != 1 || sbn != 1 || splits < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_matmul_ffma(a, b, c, ws, m, n, k, sam, sbk, splits, sms,
                              st);
  if (dtype == 1 && splits == 1) {
    if (variant == 128)
      return launch_matmul_wgmma<128>(a, b, c, m, n, k, sam, sbk, sms, st);
    if (variant == 192)
      return launch_matmul_wgmma<192>(a, b, c, m, n, k, sam, sbk, sms, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A call's arguments arrive in two blocks, so that ctypes converts two
// arguments, not eleven: `a` = {x, w, y, stream} (built per call) and `p`
// = {rows, d, sx0, sx1, sw, dtype, the bits of the float32 eps, SM count}
// (built once per shape by the wrapper).
extern "C" int sk_rmsnorm(const long long* a, const long long* p) {
  const void* x = reinterpret_cast<const void*>(a[0]);
  const void* w = reinterpret_cast<const void*>(a[1]);
  void* y = reinterpret_cast<void*>(a[2]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[3]);
  const unsigned bits = static_cast<unsigned>(p[6]);
  float eps;
  std::memcpy(&eps, &bits, sizeof eps);
  if (p[5] == 0)
    return launch_rmsnorm<float>(x, w, y, p[0], p[1], p[2], p[3], p[4], eps,
                                 p[7], st);
  if (p[5] == 1)
    return launch_rmsnorm<__nv_bfloat16>(x, w, y, p[0], p[1], p[2], p[3],
                                         p[4], eps, p[7], st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sk_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long b,
    long long s, long long h, long long hd, long long sqb, long long sqs,
    long long sqh, long long sqd, long long skb, long long sks, long long skh,
    long long skd, long long svb, long long svs, long long svh, long long svd,
    int causal, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long strides[12] = {sqb, sqs, sqh, sqd, skb, sks,
                                 skh, skd, svb, svs, svh, svd};
  if (sqd != 1 || skd != 1 || svd != 1 || hd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd > 256) {
    if (dtype == 0)
      return launch_flash_wide<float>(q, k, v, o, b, s, h, hd, strides,
                                      causal, scale, st);
    if (dtype == 1)
      return launch_flash_wide<__nv_bfloat16>(q, k, v, o, b, s, h, hd,
                                              strides, causal, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pad = hd <= 64 ? 64 : (hd <= 128 ? 128 : 256);
  if (dtype == 0) {
    if (pad == 64)
      return launch_flash_ffma<64>(q, k, v, o, b, s, h, hd, strides, causal,
                                   scale, st);
    if (pad == 128)
      return launch_flash_ffma<128>(q, k, v, o, b, s, h, hd, strides, causal,
                                    scale, st);
    return launch_flash_ffma<256>(q, k, v, o, b, s, h, hd, strides, causal,
                                  scale, st);
  }
  if (dtype == 1) {
    if (pad == 64)
      return launch_flash_wgmma<64>(q, k, v, o, b, s, h, hd, strides, causal,
                                    scale, st);
    if (pad == 128)
      return launch_flash_wgmma<128>(q, k, v, o, b, s, h, hd, strides,
                                     causal, scale, st);
    return launch_flash_wgmma<256>(q, k, v, o, b, s, h, hd, strides, causal,
                                   scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sk_error_string(int err) {
  if (err >= SK_ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - SK_ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
