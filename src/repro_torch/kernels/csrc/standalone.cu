// The standalone kernels of the port: a tiled GEMM, a row RMSNorm and a
// FlashAttention forward, each for float32 and bfloat16 inputs, written by
// hand for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (repro_torch/kernels/build.py loads it with ctypes).  Every entry point
// launches on the caller's stream, allocates nothing, and returns the
// cudaGetLastError() code of its launch; the wrapper raises it.
//
// Replaces the Pallas kernels of the JAX package:
//   sk_matmul          repro/kernels/matmul.py `matmul` (pallas_call :48)
//   sk_rmsnorm         repro/kernels/rmsnorm.py `rmsnorm` (pallas_call :27)
//   sk_flash_attention repro/kernels/flash_attention.py `flash_attention`
//                      (pallas_call :77)
// Each computes in float32 and stores in the input's type, as the
// reference does.  No tensor cores: float32 is not rounded to TF32, and
// bfloat16 operands are widened to float32 as they are loaded, so every
// product and sum is an f32 FFMA (the f32 tolerances of the reference's
// tests, 1e-4 at K = 512 and 2e-5 for attention, leave no room for TF32).
// No fast math: expf, rsqrtf and true division.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 FFMA):
//   matmul: operations for any shape worth a launch (2MNK FLOPs against
//     (MK + KN + MN) elements); the design is the classic register-tiled
//     SGEMM: a 128 x 128 output tile per CTA of 256 threads, each thread
//     an 8 x 8 tile of f32 accumulators, K walked in slabs of 16 staged in
//     shared memory (A transposed), the next slab's global loads issued
//     into registers before the current slab's FFMAs.
//   rmsnorm: bytes (a handful of FLOPs per element); one CTA per row, the
//     sum of squares reduced by warp shuffles and shared memory.
//   flash attention: operations at the model's widths (4 S^2 H hd FLOPs,
//     half of it under the causal mask, against 4 S H hd elements); one CTA
//     per (batch x head, 64-query block), keys in tiles of 64: S = Q K^T
//     and O += P V are 4 x 4 and 4 x (hd / 16) register tiles per thread
//     read from shared memory as float4s (Q and K transposed so that both
//     operands of S are float4 loads), the online softmax's row max and sum
//     by shuffles within the 16 lanes that share a row.  The heaviest
//     (last) query blocks are launched first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// matmul: c (M, N) = a (M, K) @ b (K, N), f32 accumulators, any strides.
// ---------------------------------------------------------------------------

constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 16, MM_THREADS = 256;
constexpr int MM_APAD = 4;  // As rows padded: 132 words keep float4 reads
                            // aligned and the transposed stores 2-way

// one slab's global loads into registers: A's slab is 128 rows of 16, a
// thread takes column ak = tid % 16 of rows am + 16 i (am = tid / 16); B's
// slab is 16 rows of 128, a thread takes column bn = tid % 128 of rows
// bk + 2 i (bk = tid / 128), so a warp reads 128 contiguous bytes of B
template <typename T>
__device__ __forceinline__ void mm_fetch(
    const T* __restrict__ a, const T* __restrict__ b, float (&ra)[8],
    float (&rb)[8], long long M, long long N, long long K, long long sam,
    long long sak, long long sbk, long long sbn, long long m0, long long n0,
    long long k0, int ak, int am, int bn, int bk) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + am + 16 * i, k = k0 + ak;
    ra[i] = (m < M && k < K) ? to_f32(a[m * sam + k * sak]) : 0.f;
    const long long kb = k0 + bk + 2 * i, n = n0 + bn;
    rb[i] = (kb < K && n < N) ? to_f32(b[kb * sbk + n * sbn]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 2)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, long long M, long long N, long long K,
                  long long sam, long long sak, long long sbk,
                  long long sbn) {
  __shared__ __align__(16) float As[MM_BK][MM_BM + MM_APAD];  // [k][m]
  __shared__ __align__(16) float Bs[MM_BK][MM_BN];            // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * MM_BM;
  const long long n0 = (long long)blockIdx.x * MM_BN;
  const int ak = tid & 15, am = tid >> 4;
  const int bn = tid & 127, bk = tid >> 7;
  float ra[8], rb[8];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  mm_fetch(a, b, ra, rb, M, N, K, sam, sak, sbk, sbn, m0, n0, 0, ak, am, bn,
           bk);
  for (long long k0 = 0; k0 < K; k0 += MM_BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      As[ak][am + 16 * i] = ra[i];
      Bs[bk + 2 * i][bn] = rb[i];
    }
    __syncthreads();
    if (k0 + MM_BK < K)  // in flight under the FFMAs
      mm_fetch(a, b, ra, rb, M, N, K, sam, sak, sbk, sbn, m0, n0, k0 + MM_BK,
               ak, am, bn, bk);
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      // a thread's rows are ty*4 + {0..3} and 64 + ty*4 + {0..3}, its
      // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}: each quarter warp
      // reads 128 contiguous bytes, so no bank conflict
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) c[m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// rmsnorm: y[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * w, statistics in f32.
// ---------------------------------------------------------------------------

constexpr int RMS_THREADS = 256;

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

// ---------------------------------------------------------------------------
// flash attention: o (B, S, H, HD) = softmax(q k^T / sqrt(HD)) v per (b, h),
// causal or not, q/k/v read through their (B, S, H, HD) strides.
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;

template <int HD>
constexpr size_t fa_smem_bytes() {
  // Qt [HD][BQ], Kt [HD][BK], Vs [BK][HD], Ps [BQ][BK], all f32
  return sizeof(float) * (HD * FA_BQ + HD * FA_BK + FA_BK * HD + FA_BQ * FA_BK);
}

// rows [r0, r0 + 64) of one (b, h) slice, transposed into dst[d][r] (the
// lanes of a warp take consecutive rows, so the shared stores do not
// conflict); rows at or past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long r0, long long S,
                                                long long ss, long long sd,
                                                float scale) {
  const int r = threadIdx.x & 63;
  const bool in = r0 + r < S;
  const T* row = src + (r0 + r) * ss;
  for (int d = threadIdx.x >> 6; d < HD; d += FA_THREADS / 64)
    dst[d * 64 + r] = in ? to_f32(row[d * sd]) * scale : 0.f;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 long long S, long long sqb, long long sqs, long long sqh,
                 long long sqd, long long skb, long long sks, long long skh,
                 long long skd, long long svb, long long svs, long long svh,
                 long long svd, int causal, float scale) {
  constexpr int G = HD / 64;  // float4 column groups of O per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * FA_BQ;
  float* Vs = Kt + HD * FA_BK;
  float* Ps = Vs + FA_BK * HD;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long q0 = (long long)(gridDim.y - 1 - blockIdx.y) * FA_BQ;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // q * scale in f32 before the product, as the reference
  load_transposed<T, HD>(Qt, qb, q0, S, sqs, sqd, scale);

  // a thread owns query rows ty*4 + i; in S its key columns tx*4 + j, in
  // O its head columns g*64 + tx*4 + j
  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
  }
  // key tiles wholly above the diagonal are skipped
  const long long last =
      causal && q0 + FA_BQ < S ? q0 + FA_BQ - 1 : S - 1;
  const long long n_tiles = last / FA_BK + 1;
  for (long long t = 0; t < n_tiles; ++t) {
    const long long k0 = t * FA_BK;
    load_transposed<T, HD>(Kt, kb, k0, S, sks, skd, 1.f);
    for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
      const int r = e / HD, d = e % HD;
      Vs[e] = k0 + r < S ? to_f32(vb[(k0 + r) * svs + d * svd]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&Qt[d * FA_BQ + ty * 4]);
      const float4 ka =
          *reinterpret_cast<const float4*>(&Kt[d * FA_BK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kj = k0 + tx * 4 + j;
        if (kj >= S)
          s[i][j] = -INFINITY;  // past the sequence: weight exactly 0
        else if (causal && kj > qi)
          s[i][j] = -1e30f;  // the reference's mask value
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row are one half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * G; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * FA_BK + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < FA_BK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * FA_BK + c]);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * HD + g * 64 + tx * 4]);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][g * 4 + j] = fmaf(p[i][cc], vr[j], acc[i][g * 4 + j]);
        }
      }
    }
    __syncthreads();
  }
  // o = acc / max(l, 1e-30), in o's contiguous (B, S, H, HD) layout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((b * S + qi) * H + h) * (long long)HD;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[g * 64 + tx * 4 + j] = from_f32<T>(acc[i][g * 4 + j] / denom);
  }
}

template <typename T>
int launch_matmul(const void* a, const void* b, void* c, long long m,
                  long long n, long long k, long long sam, long long sak,
                  long long sbk, long long sbn, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + MM_BN - 1) / MM_BN),
                  (unsigned)((m + MM_BM - 1) / MM_BM));
  matmul_kernel<T><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, sam, sak, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rmsnorm(const void* x, const void* w, void* y, long long rows,
                   long long d, long long sx0, long long sx1, long long sw,
                   float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<(unsigned)rows, RMS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, sx0, sx1, sw, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 long long b, long long s, long long h, const long long* st,
                 int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)(b * h), (unsigned)((s + FA_BQ - 1) / FA_BQ));
  flash_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)h, s, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Shapes, strides (in elements) and the
// limits (hd in {64, 128}, grid sizes) are checked by the Python wrappers
// before the call; an unknown dtype or hd returns cudaErrorInvalidValue.

extern "C" int sk_matmul(const void* a, const void* b, void* c, long long m,
                         long long n, long long k, long long sam,
                         long long sak, long long sbk, long long sbn,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_matmul<float>(a, b, c, m, n, k, sam, sak, sbk, sbn, st);
  if (dtype == 1)
    return launch_matmul<__nv_bfloat16>(a, b, c, m, n, k, sam, sak, sbk, sbn,
                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sk_rmsnorm(const void* x, const void* w, void* y,
                          long long rows, long long d, long long sx0,
                          long long sx1, long long sw, float eps, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rmsnorm<float>(x, w, y, rows, d, sx0, sx1, sw, eps, st);
  if (dtype == 1)
    return launch_rmsnorm<__nv_bfloat16>(x, w, y, rows, d, sx0, sx1, sw, eps,
                                         st);
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
  if (dtype == 0 && hd == 64)
    return launch_flash<float, 64>(q, k, v, o, b, s, h, strides, causal,
                                   scale, st);
  if (dtype == 0 && hd == 128)
    return launch_flash<float, 128>(q, k, v, o, b, s, h, strides, causal,
                                    scale, st);
  if (dtype == 1 && hd == 64)
    return launch_flash<__nv_bfloat16, 64>(q, k, v, o, b, s, h, strides,
                                           causal, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_flash<__nv_bfloat16, 128>(q, k, v, o, b, s, h, strides,
                                            causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
