// Chunk-vs-cache flash attention for Hopper (sm_90a): a T-token query piece
// at absolute offset `start` over one serving slot's cache, bf16 or f32
// queries, K/V in the query's type or int8 with per-token f32 scales; f32
// out. Two index modes in one kernel: a dense cache row (heads, C, hd), or
// the paged pool's block planes (n_blocks, heads, block, hd) walked through
// one slot's block-table row.
//
// Replaces the Pallas kernel `_chunk_kernel` reached through
// `flash_chunk_attn` and `flash_chunk_attn_paged` in
// pathway_tpu/models/flash_attention.py. Same contract: query row t attends
// column c when row_mask[c] > 0 and c <= start + t; scores q.k * sm_scale in
// f32 with an online softmax whose running max starts at the finite
// sentinel -1e30; int8 K/V are widened and multiplied by their scales where
// a tile is read; a row with nothing to attend divides by 1 and is exact
// zeros.
//
// What bounds it on an H100: at the prefill piece (T = 64 queries, 12 heads,
// head_dim 64, cache_len 704) each live K/V row feeds 64 query rows, 4*64
// flops per 2*hd*itemsize bytes -- about 64 flop/byte for bf16 K/V, below
// the ~295 where the tensor cores would become the limit, so the bound is
// the live K/V bytes; but this first version runs on CUDA cores in f32, so
// it is in practice bound by its own arithmetic (and by the few blocks a
// piece gives: 2 per head).
//
// Design (simple and right first; mma/wgmma tiles and a split over the
// cache are later work), as csrc/flash_attn.cu:
// * a block of 64 threads serves 64 / TPR query rows of one head; each row
//   is served by TPR threads (1, 2 or 4: head_dim / 32 rounded up), each
//   owning 32 head_dim columns of q and of the f32 accumulator in
//   registers; partial dot products meet through warp shuffles;
// * the cache is walked in tiles of 32 columns: tiles wholly past the
//   block's last query column (start + its last row) are skipped, as are
//   tiles with no live column; only live columns' K/V rows are loaded
//   (16-byte vector loads, 8-byte for int8) and staged as f32;
// * each tile is consumed in chunks of 16 columns: scores, one running-max
//   update and accumulator rescale, then P.V with P in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;
constexpr int kDims = 32;       // head_dim columns per thread
constexpr int kTile = 32;       // cache columns per shared-memory tile
constexpr int kChunk = 16;      // cache columns per online-softmax update
constexpr float kNeg = -1e30f;  // finite sentinel: exp(kNeg - kNeg) == 1

__device__ __forceinline__ void load8(const float* __restrict__ p, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* __restrict__ p, float* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = static_cast<float>(b[i]);
}

template <typename QT, typename KT, int TPR>
__global__ void __launch_bounds__(kThreads)
chunk_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ tbl,
                  const int* __restrict__ mask, float* __restrict__ out,
                  int nh, int T, int hd, int C, int Bk, int start,
                  float sm_scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int R = kThreads / TPR;  // query rows per block
  // floats per column slice in shared memory: 32, padded by 4 when a row
  // has several slices so that they start in different banks
  constexpr int PS = TPR == 1 ? kDims : kDims + 4;
  __shared__ __align__(16) float k_s[kTile][TPR * PS];
  __shared__ __align__(16) float v_s[kTile][TPR * PS];
  __shared__ int live_s[kTile];

  const int tid = threadIdx.x;
  const int part = tid % TPR;  // which 32-column slice of head_dim
  const int slot = tid / TPR;  // query row slot in the block
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int row = q0 + slot;
  const bool active = row < T;
  const int hd8 = hd / 8;
  const int d0 = part * kDims;
  const int my8 = max(0, min(kDims, hd - d0)) / 8;  // my 8-column chunks

  // head_dim columns >= hd stay zero for the whole kernel: tile loads
  // write only columns < hd
  if (hd < TPR * kDims) {
    for (int i = tid; i < kTile * TPR * kDims; i += kThreads) {
      const int dim = i % (TPR * kDims);
      if (dim >= hd) {
        const int r = i / (TPR * kDims);
        const int at = (dim / kDims) * PS + dim % kDims;
        k_s[r][at] = 0.f;
        v_s[r][at] = 0.f;
      }
    }
  }

  float qr[kDims];
  float acc[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    const QT* qp = q + (static_cast<size_t>(h) * T + row) * hd + d0;
#pragma unroll
    for (int c = 0; c < kDims / 8; ++c) {
      if (c < my8) load8(qp + 8 * c, &qr[8 * c]);
    }
  }

  float m = kNeg;
  float l = 0.f;
  const int qcol = start + row;  // this row attends columns <= qcol
  const int last_col = start + min(q0 + R, T) - 1;  // the block's last
  const int kt_end = last_col < 0 ? 0 : min((C + kTile - 1) / kTile, last_col / kTile + 1);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int c0 = kt * kTile;
    __syncthreads();  // every thread is done with the previous tile
    int any = 0;
    for (int i = tid; i < kTile; i += kThreads) {
      const int col = c0 + i;
      const int lv = col < C && mask[col] > 0;
      live_s[i] = lv;
      any |= lv;
    }
    if (!__syncthreads_or(any)) continue;  // no live column: nothing read
    for (int i = tid; i < kTile * hd8; i += kThreads) {
      const int r = i / hd8;
      const int dim = (i - r * hd8) * 8;
      const int at = (dim / kDims) * PS + dim % kDims;
      if (live_s[r]) {
        const int col = c0 + r;
        // the cache row of this column: dense row, or physical block
        const size_t kv = tbl == nullptr
            ? static_cast<size_t>(h) * C + col
            : (static_cast<size_t>(tbl[col / Bk]) * nh + h) * Bk + col % Bk;
        load8(k + kv * hd + dim, &k_s[r][at]);
        load8(v + kv * hd + dim, &v_s[r][at]);
        if (kQuant) {
          const float sk = ks[kv], sv = vs[kv];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            k_s[r][at + e] *= sk;
            v_s[r][at + e] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          k_s[r][at + e] = 0.f;
          v_s[r][at + e] = 0.f;
        }
      }
    }
    __syncthreads();

    const float* kg = &k_s[0][part * PS];
    const float* vg = &v_s[0][part * PS];
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      // every thread computes scores (inactive ones on zeros) so that the
      // shuffles below always see the whole warp
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = kg + (j0 + j) * TPR * PS;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kDims; ++d) dot = fmaf(qr[d], kr[d], dot);
#pragma unroll
        for (int o = TPR / 2; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[j] = dot * sm_scale;
      }
      unsigned live_bits = 0u;
      float cmax = kNeg;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (live_s[j0 + j] && c0 + j0 + j <= qcol) {
          live_bits |= 1u << j;
          cmax = fmaxf(cmax, s[j]);
        }
      }
      // a chunk with no live column changes nothing (alpha == 1, p == 0)
      if (active && live_bits != 0u) {
        const float m_new = fmaxf(m, cmax);
        const float alpha = __expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kDims; ++d) acc[d] *= alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float p = (live_bits >> j) & 1u ? __expf(s[j] - m_new) : 0.f;
          l += p;
          const float* vr = vg + (j0 + j) * TPR * PS;
#pragma unroll
          for (int d = 0; d < kDims; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
        }
        m = m_new;
      }
    }
  }

  if (active) {
    const float denom = l == 0.f ? 1.f : l;
    float* op = out + (static_cast<size_t>(h) * T + row) * hd + d0;
#pragma unroll
    for (int c = 0; c < kDims / 8; ++c) {
      if (c < my8) {
        float4 a, b2;
        a.x = acc[8 * c + 0] / denom; a.y = acc[8 * c + 1] / denom;
        a.z = acc[8 * c + 2] / denom; a.w = acc[8 * c + 3] / denom;
        b2.x = acc[8 * c + 4] / denom; b2.y = acc[8 * c + 5] / denom;
        b2.z = acc[8 * c + 6] / denom; b2.w = acc[8 * c + 7] / denom;
        reinterpret_cast<float4*>(op + 8 * c)[0] = a;
        reinterpret_cast<float4*>(op + 8 * c)[1] = b2;
      }
    }
  }
}

template <typename QT, typename KT, int TPR>
cudaError_t launch_tpr(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* tbl,
                       const int* mask, float* out, int nh, int T, int hd,
                       int C, int Bk, int start, float sm_scale,
                       cudaStream_t st) {
  constexpr int R = kThreads / TPR;
  const dim3 grid(static_cast<unsigned>((T + R - 1) / R), static_cast<unsigned>(nh));
  chunk_attn_kernel<QT, KT, TPR><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tbl, mask, out, nh, T, hd, C, Bk,
      start, sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* tbl,
                         const int* mask, float* out, int nh, int T, int hd,
                         int C, int Bk, int start, float sm_scale,
                         cudaStream_t st) {
  if (hd <= 32) return launch_tpr<QT, KT, 1>(q, k, v, ks, vs, tbl, mask, out, nh, T, hd, C, Bk, start, sm_scale, st);
  if (hd <= 64) return launch_tpr<QT, KT, 2>(q, k, v, ks, vs, tbl, mask, out, nh, T, hd, C, Bk, start, sm_scale, st);
  return launch_tpr<QT, KT, 4>(q, k, v, ks, vs, tbl, mask, out, nh, T, hd, C, Bk, start, sm_scale, st);
}

}  // namespace

// q: (nh, T, hd) bf16 (q_bf16 = 1) or f32, 16-byte aligned. Dense mode
// (tbl == NULL): k/v (nh, C, hd), scales (nh, C, 1). Paged mode: k/v
// (n_blocks, nh, Bk, hd), scales (n_blocks, nh, Bk, 1), tbl (C / Bk,) int32.
// K/V in q's type (kv_kind 0 = f32, 1 = bf16) or int8 (kv_kind 2, with
// scales). mask: (C,) int32. out: (nh, T, hd) f32. All contiguous.
// Launches on `stream` and returns the launch status; it does not
// synchronise.
extern "C" cudaError_t pathway_flash_chunk_attn(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tbl, const void* mask, void* out, int nh,
    int T, int hd, int C, int Bk, int start, float sm_scale, int q_bf16,
    int kv_kind, void* stream) {
  if (nh <= 0 || nh > 65535 || T <= 0 || C <= 0 || Bk <= 0 || hd < 8 ||
      hd > 128 || hd % 8 != 0 || (tbl != nullptr && C % Bk != 0)) {
    return cudaErrorInvalidValue;
  }
  const bool quant = kv_kind == 2;
  if (quant ? (ks == nullptr || vs == nullptr) : kv_kind != q_bf16) {
    return cudaErrorInvalidValue;
  }
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* t = static_cast<const int*>(tbl);
  const int* mk = static_cast<const int*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (quant) {
      return launch_typed<__nv_bfloat16, int8_t>(q, k, v, ksp, vsp, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
    }
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
  }
  if (quant) {
    return launch_typed<float, int8_t>(q, k, v, ksp, vsp, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
  }
  return launch_typed<float, float>(q, k, v, nullptr, nullptr, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
}
