// Paged-attention decode for Hopper (sm_90a): one query position per serving
// slot over the global paged KV pool, bf16 or f32 queries, K/V in the
// query's type or int8 with per-token f32 scales; output in the query's
// type.
//
// Replaces the Pallas kernel `_decode_kernel` reached through
// `paged_attn_decode` in pathway_tpu/models/paged_attention.py. Same
// contract: slot b's logical column c lives in physical block
// tbl[b, c / block] at block column c % block; column c is attended when
// slot_mask[b, c] > 0; scores are q.k * sm_scale in f32 with an online
// softmax (running max starts at the finite sentinel -1e30) across the
// slot's blocks; int8 K/V are widened and multiplied by their scales where
// they are read, so no dequantized copy exists; a slot with no live column
// divides by 1 and returns exact zeros.
//
// What bounds it on an H100: each live K/V row is read once and used for
// one dot product and one axpy per head, ~1 flop per byte: memory-bound on
// the live K/V bytes. Columns that are not live are not read at all (the
// result is the same: their weight is exactly 0), and a block with no live
// column is skipped without touching its K/V.
//
// Design (simple and right first; cp.async/TMA double buffering is later
// work):
// * a block of 128 threads per (slot, head) walks the slot's table row;
// * per physical block: the live mask of its columns is read, the live K/V
//   rows are staged in shared memory as f32 (scaled when int8), rows padded
//   to head_dim + 1 floats so that one thread per column reads its row
//   without bank conflicts;
// * one thread per column computes its score; the block's max and sum come
//   from warp shuffles and one shared-memory pass; each thread then owns up
//   to two head_dim columns of the f32 accumulator and sums p * v over the
//   live columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 2;     // head_dim columns per thread: head_dim <= 256
constexpr float kNeg = -1e30f;  // finite sentinel: exp(kNeg - kNeg) == 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Block-wide max / sum of one value per thread; every thread gets the
// result. The leading barrier lets the previous call's readers finish
// before `red` is overwritten; the second publishes it.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) r += red[i];
  return r;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kb,
                    const KT* __restrict__ vb, const float* __restrict__ kbs,
                    const float* __restrict__ vbs, const int* __restrict__ tbl,
                    const int* __restrict__ mask, QT* __restrict__ out, int nh,
                    int hd, int Bk, int M, float sm_scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* ks = smem;             // [Bk][ld]
  float* vs = ks + Bk * ld;     // [Bk][ld]
  float* qs = vs + Bk * ld;     // [hd]
  float* ps = qs + hd;          // [Bk] scores, then probabilities
  int* live = reinterpret_cast<int*>(ps + Bk);  // [Bk]
  __shared__ float red[kWarps];

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const size_t qoff = (static_cast<size_t>(b) * nh + h) * hd;
  for (int d = tid; d < hd; d += kThreads) qs[d] = to_f32(q[qoff + d]);

  float acc[kMaxDims];
#pragma unroll
  for (int j = 0; j < kMaxDims; ++j) acc[j] = 0.f;
  float m = kNeg;
  float l = 0.f;
  const int* mrow = mask + static_cast<size_t>(b) * M * Bk;

  for (int blk = 0; blk < M; ++blk) {
    __syncthreads();  // the previous block's shared tiles are consumed
    int any = 0;
    for (int c = tid; c < Bk; c += kThreads) {
      const int lv = mrow[blk * Bk + c] > 0;
      live[c] = lv;
      any |= lv;
    }
    if (!__syncthreads_or(any)) continue;  // nothing live: K/V not read

    const size_t base = (static_cast<size_t>(tbl[b * M + blk]) * nh + h) * Bk;
    for (int i = tid; i < Bk * hd; i += kThreads) {
      const int c = i / hd;
      const int d = i - c * hd;
      if (live[c]) {
        float kv = to_f32(kb[(base + c) * hd + d]);
        float vv = to_f32(vb[(base + c) * hd + d]);
        if (kbs != nullptr) {
          kv *= kbs[base + c];
          vv *= vbs[base + c];
        }
        ks[c * ld + d] = kv;
        vs[c * ld + d] = vv;
      }
    }
    __syncthreads();

    float lmax = kNeg;
    for (int c = tid; c < Bk; c += kThreads) {
      float s = kNeg;
      if (live[c]) {
        const float* kr = ks + c * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qs[d], kr[d], dot);
        s = dot * sm_scale;
      }
      ps[c] = s;
      lmax = fmaxf(lmax, s);
    }
    const float m_new = fmaxf(m, block_max(lmax, red));
    const float alpha = __expf(m - m_new);
    float lsum = 0.f;
    for (int c = tid; c < Bk; c += kThreads) {
      const float p = live[c] ? __expf(ps[c] - m_new) : 0.f;
      ps[c] = p;
      lsum += p;
    }
    l = l * alpha + block_sum(lsum, red);  // its barriers publish ps
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      const int d = tid + j * kThreads;
      if (d < hd) {
        float a = acc[j] * alpha;
        for (int c = 0; c < Bk; ++c) {
          if (live[c]) a = fmaf(ps[c], vs[c * ld + d], a);
        }
        acc[j] = a;
      }
    }
    m = m_new;
  }

  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int j = 0; j < kMaxDims; ++j) {
    const int d = tid + j * kThreads;
    if (d < hd) store(out + qoff + d, acc[j] / denom);
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* kb, const void* vb,
                   const float* kbs, const float* vbs, const int* tbl,
                   const int* mask, void* out, int B, int nh, int hd, int Bk,
                   int M, float sm_scale, cudaStream_t st) {
  const size_t smem = (2 * static_cast<size_t>(Bk) * (hd + 1) + hd + Bk) * sizeof(float)
                      + Bk * sizeof(int);
  auto kern = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(B) * nh, kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kb),
      static_cast<const KT*>(vb), kbs, vbs, tbl, mask, static_cast<QT*>(out),
      nh, hd, Bk, M, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, nh, hd) bf16 (q_bf16 = 1) or f32. kb/vb: (n_blocks, nh, Bk, hd) in
// q's type (kv_kind 0 = f32, 1 = bf16) or int8 (kv_kind 2, with kbs/vbs
// (n_blocks, nh, Bk, 1) f32). tbl: (B, M) int32. mask: (B, M * Bk) int32.
// out: (B, nh, hd) in q's type. All contiguous. Launches on `stream` and
// returns the launch status; it does not synchronise.
extern "C" cudaError_t pathway_paged_attn_decode(
    const void* q, const void* kb, const void* vb, const void* kbs,
    const void* vbs, const void* tbl, const void* mask, void* out, int B,
    int nh, int hd, int Bk, int M, float sm_scale, int q_bf16, int kv_kind,
    void* stream) {
  if (B <= 0 || nh <= 0 || hd <= 0 || hd > kMaxDims * kThreads || Bk <= 0 ||
      M <= 0 || static_cast<long long>(B) * nh > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const bool quant = kv_kind == 2;
  if (quant ? (kbs == nullptr || vbs == nullptr) : kv_kind != q_bf16) {
    return cudaErrorInvalidValue;
  }
  const float* ks = static_cast<const float*>(kbs);
  const float* vs = static_cast<const float*>(vbs);
  const int* t = static_cast<const int*>(tbl);
  const int* mk = static_cast<const int*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (quant) {
      return launch<__nv_bfloat16, int8_t>(q, kb, vb, ks, vs, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
    }
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kb, vb, nullptr, nullptr, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
  }
  if (quant) {
    return launch<float, int8_t>(q, kb, vb, ks, vs, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
  }
  return launch<float, float>(q, kb, vb, nullptr, nullptr, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
}
