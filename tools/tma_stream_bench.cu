// Stream a weight-shaped fp32 region through shared memory, one CTA of 512
// threads per SM (132), and print the rate: how fast the megakernel's
// matmul could stream its weights through a ring of stages with nothing
// else on the stage's path.
//
//   bash tools/tma_stream_bench.sh        (on the card: builds and runs)
//   tma_stream_bench MODE COLS KC NS
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

int main(int argc, char** argv) {
  if (argc != 5) {
    fprintf(stderr, "usage: %s MODE COLS KC NS\n", argv[0]);
    return 2;
  }
  const int mode = atoi(argv[1]), cols = atoi(argv[2]), kc = atoi(argv[3]);
  const int ns = atoi(argv[4]);
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
