// Fused int8-weight matmul for Hopper (sm_90a): x (M, K) bf16 or f32,
// w (K, N) int8, scale (N,) f32 -> out (M, N) f32.
//
// Replaces the Pallas kernel `_wq_matmul_kernel` reached through
// `wq_matmul` in pathway_tpu/models/wq_matmul.py. Same contract: the int8
// weight tile is widened where it is read (int8 values are exact in bf16
// and in f32, so widening to f32 directly gives the bf16 path's values),
// products accumulate in f32, and each output column is multiplied by its
// scale. No full-precision copy of the weight is written anywhere.
//
// What bounds it on an H100: at the decoder's shapes (M = 16 decode rows or
// 64 prefill rows; K x N one of 768x2304, 768x768, 768x3072, 3072x768) the
// work is 2*M*K*N flops against ~K*N weight bytes, 2*M flop/byte (32 in
// decode), far below the ~295 where the bf16 tensor cores would become the
// limit. So it is bound by the weight bytes; each is read from device
// memory once per 16-row tile of x (later tiles hit L2). A first design
// (one thread per output column, K walked 64 rows at a time with a barrier
// pair per step) was latency-bound on that serial walk: ~76 us a launch in
// decode, slower than widening the weight and calling cuBLAS.
//
// Design (weight stream first; mma/wgmma tiles and TMA are later work):
// * a block of 256 threads owns a 16 x 32 output tile. The 32 columns are 8
//   groups of 4; each thread owns one group and one of 32 "k-lanes", so the
//   block walks K 32 rows at a time and every thread reads its group's 4
//   weight bytes of a row with one 4-byte load (a warp reads 4 rows x 32
//   bytes, whole sectors);
// * x is staged in shared memory as f32, 16 rows x 512 columns at a time;
//   each thread then issues its 16 weight loads of the chunk before it uses
//   any, so many loads are in flight, and accumulates 16 x 4 outputs in f32
//   registers;
// * the 32 k-lanes' partial sums meet in a fixed order (two warp shuffles,
//   then the 8 warps through shared memory), so results do not vary from
//   run to run; the scale multiplies the sum;
// * every load is guarded: any M, K and N work, nothing outside the operands
//   is read, and out-of-range elements count as zero (a ragged N, or a
//   weight not 4-byte aligned, takes byte loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16;                     // output rows per block
constexpr int kCols = 4;                    // output columns per thread
constexpr int kGroups = 8;                  // column groups per block
constexpr int kBN = kGroups * kCols;        // output columns per block (32)
constexpr int kLanes = kThreads / kGroups;  // k-lanes (32)
constexpr int kBK = 512;                    // x columns staged at a time
constexpr int kSteps = kBK / kLanes;        // weight rows per thread per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 4 weight bytes of row k at columns col..col+3, packed; zero outside
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ w, int k,
                                          bool ok, int col, int N, bool vec) {
  if (!ok) return 0u;
  const int8_t* p = w + static_cast<size_t>(k) * N + col;
  if (vec && col + kCols <= N) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (col + j < N) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  }
  return v;
}

__device__ __forceinline__ float byte_f32(uint32_t v, int j) {
  return static_cast<float>(static_cast<int8_t>((v >> (8 * j)) & 0xffu));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int K, int N, bool vec) {
  // the x chunk, then the warps' partial sums
  __shared__ __align__(16) float smem[kBM * kBK];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cg = lane % kGroups;
  const int kl = warp * (32 / kGroups) + lane / kGroups;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int col = n0 + cg * kCols;
  float acc[kBM][kCols];
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kend = min(kBK, K - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK, m = m0 + r;
      smem[i] = (m < M && c < kend) ? to_f32(x[static_cast<size_t>(m) * K + k0 + c]) : 0.f;
    }
    uint32_t wv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int kk = kl + u * kLanes;
      wv[u] = load4(w, k0 + kk, kk < kend, col, N, vec);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int kk = kl + u * kLanes;
      float wf[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) wf[j] = byte_f32(wv[u], j);
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const float xv = smem[m * kBK + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }

  // the 4 k-lanes of a warp that share a column group (lanes 8 apart)
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  __syncthreads();  // the last x chunk is consumed
  float* red = smem;  // [kWarps][kBM][kBN]
  if (lane < kGroups) {
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) red[(warp * kBM + m) * kBN + cg * kCols + j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * kBM + r) * kBN + c];
      out[static_cast<size_t>(m) * N + n] = s * scale[n];
    }
  }
}

}  // namespace

// x: (M, K) contiguous, bf16 (x_bf16 = 1) or f32. w: (K, N) int8
// contiguous. scale: (N,) f32. out: (M, N) f32. Launches on `stream` and
// returns the launch status; it does not synchronise.
extern "C" cudaError_t pathway_wq_matmul(const void* x, const void* w,
                                         const void* scale, void* out, int M,
                                         int K, int N, int x_bf16,
                                         void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + kBM - 1) / kBM > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  // 4-byte weight loads need every row start 4-byte aligned
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % kCols == 0;
  if (x_bf16) {
    wq_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wp, sp, op, M, K, N, vec);
  } else {
    wq_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), wp, sp, op, M, K, N, vec);
  }
  return cudaGetLastError();
}
