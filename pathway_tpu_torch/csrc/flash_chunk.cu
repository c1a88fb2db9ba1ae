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
// sentinel -1e30; int8 K/V are exact in bf16 and their per-token scales
// multiply the score column (K) and the probability (V); a row with nothing
// to attend divides by 1 and is exact zeros.
//
// What bounds it on an H100: at the prefill piece (T = 64 queries, 12 heads,
// head_dim 64, 512 live columns of 704) each live K/V row feeds 64 query
// rows, 4*64 flops per 2*hd*itemsize bytes -- about 64 flop/byte for bf16
// K/V, below the ~295 where the tensor cores would become the limit, so the
// bound is the live K/V bytes (~1.9 MB, ~0.6 us). The earlier design (f32
// FMA on CUDA cores, synchronous loads widened to f32 behind two barriers a
// tile, a (T/32, heads) grid: 24 blocks of 2 warps on 132 SMs) ran at ~150x
// that bound and 3x slower than one scaled_dot_product_attention call.
//
// Design of the bf16-query path (tensor cores, split over the cache):
// * mma.sync.m16n8k16 bf16 -> f32, one warp per 16 query rows (a block of
//   4 warps serves 64 rows of one head) with its Q fragment in registers. mma.sync, not wgmma: at 64 query rows
//   and ~64 flop/byte the kernel is bytes- and latency-bound, and m16 tiles
//   per warp need no warpgroup synchronisation. S = Q.K^T from ldmatrix'd K; the score column takes
//   the K scale. P.V keeps P in f32 as JAX does: p (times the V scale) is
//   split into hi = bf16(p) and lo = bf16(p - hi) and two mma's add hi.V and
//   lo.V, leaving ~2^-17 relative error where one bf16 P would leave 2^-9.
// * K/V tiles of 32 columns come into shared memory by 16-byte cp.async
//   (8-byte for 8-byte int8 rows) through a 2-stage ring, rows padded so
//   ldmatrix reads are conflict-free. Each column's row address (its dense
//   row, or its physical block in paged mode) and liveness, and its int8
//   scales, are staged for up to 256 columns in one parallel pass first,
//   so no tile's copies wait on a dependent load of the mask or the table.
//   A column that is not live is zero-filled and never read;
//   int8 tiles are widened to bf16 in shared memory once per tile.
//   head_dim is zero-padded to the mma depth.
// * Flash-decoding split: the host's plan (`chunk_plan` in
//   models/flash_attention.py) cuts the live columns [0, min(C, start + T))
//   into splits of 32 logical columns (64 was timed beside it: PERF.md),
//   the same in dense and paged mode whatever the block size, so the paged
//   result equals the dense one bit for bit. Each (query tile, head, split) block writes f32
//   partials (m, l, acc); a second kernel, one thread per (row, 4 head_dim
//   columns), combines them in split order, skipping splits with l = 0. A
//   split wholly past the tile's last query column does no work. (A first
//   version combined in the last block of each (query tile, head) to
//   arrive: one block per head reading 16 splits' partials as a chain of
//   dependent loads took 0.129 ms.)
//
// The f32-query path (the card-vs-CPU f32 check) keeps the earlier design,
// f32 FMA on CUDA cores, unchanged below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kDims = 32;       // head_dim columns per thread
constexpr int kTile = 32;       // cache columns per shared-memory tile
constexpr int kChunk = 16;      // cache columns per online-softmax update

__device__ __forceinline__ void load8(const float* __restrict__ p, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
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

// ------------------------------------------------ bf16-query path (mma)

constexpr int kCThreads = 128;     // 4 warps: 16 query rows each
constexpr int kCRows = 64;         // query rows per block
constexpr int kCCols = 32;         // cache columns per ring stage
constexpr int kCWindow = 256;      // columns whose row addresses are staged at once
constexpr int kMaxSplits = 64;     // splits a plan may hold (wider splits past it)
constexpr int kCombineThreads = 128;

template <typename KT, int HD>
struct ChunkSmem {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int kLd = HD + 8;  // bf16 per tile row: conflict-free ldmatrix
  // bf16 K/V: the ring itself; int8 K/V: a ring of raw rows + one widened tile
  static constexpr int kRing = kQuant ? 2 * 2 * kCCols * HD : 2 * 2 * kCCols * kLd * 2;
  static constexpr int kWork = kQuant ? 2 * kCCols * kLd * 2 : 0;
  static constexpr int kBytes = kRing + kWork;
};

template <typename KT, int HD>
__global__ void __launch_bounds__(kCThreads)
chunk_attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                      const KT* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs, const int* __restrict__ tbl,
                      const int* __restrict__ mask, float* __restrict__ out,
                      float* __restrict__ part, int nh, int T, int hd, int C, int Bk,
                      int start, float sm_scale, int split_cols) {
  using S = ChunkSmem<KT, HD>;
  constexpr bool kQuant = S::kQuant;
  constexpr int kLd = S::kLd;
  constexpr int kKS = HD / 16;  // mma depth steps over head_dim (padded)
  constexpr int kDT = HD / 8;   // n8 tiles of head_dim
  __shared__ __align__(16) uint8_t smem[S::kBytes];
  // a window of the split's columns: each one's cache row (-1: not live)
  // and, for int8 K/V, its scales
  __shared__ int row_s[kCWindow];
  __shared__ float ks_s[kCWindow];
  __shared__ float vs_s[kCWindow];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, h = blockIdx.y, split = blockIdx.z, n_splits = gridDim.z;
  const int q0 = qt * kCRows;
  const int rows_end = min(T, q0 + kCRows);
  const int last_col = start + rows_end - 1;  // the tile's last query column
  const int live_end = min(C, start + T);
  const int c_lo = split * split_cols;
  const int c_hi = min(min(c_lo + split_cols, live_end), last_col + 1);
  const bool needed = n_splits == 1 || c_lo <= last_col;
  const int hd16 = (hd + 15) / 16;
  const int wrow0 = q0 + 16 * warp;  // this warp's first query row
  const bool warp_rows = wrow0 < T;
  const int warp_last_col = start + min(wrow0 + 15, T - 1);

  // tile buffers: [stage][K|V][col][kLd] bf16 (bf16 K/V), or raw rows
  // [stage][K|V][col][HD] int8 and a widened tile [K|V][col][kLd]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* raw = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* work = reinterpret_cast<__nv_bfloat16*>(smem + S::kRing);
  auto tile = [&](int stage, int which) -> __nv_bfloat16* {
    return kQuant ? work + which * kCCols * kLd : ring + (stage * 2 + which) * kCCols * kLd;
  };

  float m_r[2] = {kNeg, kNeg};
  float l_r[2] = {0.f, 0.f};  // this thread's share; the quad's sum at the end
  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  if (needed) {
    // head_dim columns >= hd stay zero: tile loads write only columns < hd
    if (hd < HD) {
      const int n_tiles = kQuant ? 2 : 4;
      __nv_bfloat16* base = kQuant ? work : ring;
      for (int i = tid; i < n_tiles * kCCols * (HD - hd); i += kCThreads) {
        const int r = i / (HD - hd);
        base[r * kLd + hd + i % (HD - hd)] = __float2bfloat16(0.f);
      }
    }
    // the warp's Q fragment: rows wrow0 + g (+8), head_dim padded with zeros
    uint32_t qf[kKS][4];
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow0 + g + 8 * (e & 1);
        const int d = 16 * s + 2 * t + 8 * (e >> 1);
        qf[s][e] = row < T && d < hd
            ? *reinterpret_cast<const uint32_t*>(q + (static_cast<size_t>(h) * T + row) * hd + d)
            : 0u;
      }
    }

    const int row_bytes = hd * static_cast<int>(sizeof(KT));
    const int cp = row_bytes % 16 == 0 ? 16 : 8;  // copy width
    const int per_row = row_bytes / cp;
    // K/V rows of columns [c0, c0 + 32) of the window at w0 into a stage;
    // a column that is not live is zero-filled and not read
    auto load_tile = [&](int stage, int c0, int w0) {
      for (int i = tid; i < 2 * kCCols * per_row; i += kCThreads) {
        const int which = i / (kCCols * per_row);  // 0: K, 1: V
        const int r = (i / per_row) % kCCols;
        const int chunk = i % per_row;
        const int kv = row_s[c0 - w0 + r];
        const KT* src = (which ? v : k) + static_cast<size_t>(kv < 0 ? 0 : kv) * hd;
        uint8_t* dst = kQuant
            ? reinterpret_cast<uint8_t*>(raw + ((stage * 2 + which) * kCCols + r) * HD)
            : reinterpret_cast<uint8_t*>(ring + ((stage * 2 + which) * kCCols + r) * kLd);
        cp_async(dst + chunk * cp, reinterpret_cast<const uint8_t*>(src) + chunk * cp, cp, kv >= 0);
      }
    };

    for (int w0 = c_lo; w0 < c_hi; w0 += kCWindow) {
      const int w1 = min(c_hi, w0 + kCWindow);
      const int n_col_tiles = (w1 - w0 + kCCols - 1) / kCCols;
      __syncthreads();  // the previous window is consumed
      // every column's mask and table entry in one parallel pass, so no
      // tile's copies wait on a dependent load
      for (int i = tid; i < n_col_tiles * kCCols; i += kCThreads) {
        const int col = w0 + i;
        const bool lv = col < w1 && mask[col] > 0;
        const int blk = tbl != nullptr && col < w1 ? tbl[col / Bk] : 0;
        const int kv = !lv ? -1 : tbl == nullptr ? h * C + col : (blk * nh + h) * Bk + col % Bk;
        row_s[i] = kv;
        if (kQuant) {
          ks_s[i] = lv ? ks[kv] : 0.f;
          vs_s[i] = lv ? vs[kv] : 0.f;
        }
      }
      __syncthreads();
      load_tile(0, w0, w0);
      cp_async_commit();
      for (int it = 0; it < n_col_tiles; ++it) {
        const int st = it % 2;
        const int c0 = w0 + it * kCCols;
        const int* rows_t = row_s + (c0 - w0);  // this tile's columns
        if (it + 1 < n_col_tiles) load_tile((it + 1) % 2, c0 + kCCols, w0);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile `it` landed for every thread
        if (kQuant) {
          // widen the raw int8 rows to bf16 (exact)
          for (int i = tid; i < 2 * kCCols * (hd / 4); i += kCThreads) {
            const int which = i / (kCCols * (hd / 4));
            const int r = (i / (hd / 4)) % kCCols;
            const int d = 4 * (i % (hd / 4));
            const uint32_t u = *reinterpret_cast<const uint32_t*>(
                raw + ((st * 2 + which) * kCCols + r) * HD + d) ^ 0x80808080u;
            uint2 o;
            o.x = pack_bf16(biased_byte(u, 0), biased_byte(u, 1));
            o.y = pack_bf16(biased_byte(u, 2), biased_byte(u, 3));
            *reinterpret_cast<uint2*>(work + (which * kCCols + r) * kLd + d) = o;
          }
          __syncthreads();
        }
        // a warp whose rows end before the tile, or a tile with no live
        // column, changes nothing (alpha == 1, p == 0)
        const bool any = __any_sync(0xffffffffu, rows_t[lane] >= 0);
        if (warp_rows && c0 <= warp_last_col && any) {
          const __nv_bfloat16* kt = tile(st, 0);
          const __nv_bfloat16* vt = tile(st, 1);
          // S = Q.K^T over the tile's 32 columns: 4 n8 tiles
          float s[4][4];
  #pragma unroll
          for (int n = 0; n < 4; ++n)
  #pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  #pragma unroll
          for (int ksi = 0; ksi < kKS; ++ksi) {
            if (ksi < hd16) {
  #pragma unroll
              for (int np = 0; np < 2; ++np) {
                const int mi = lane / 8;
                uint32_t b[4];
                ldsm_x4(b, kt + (np * 16 + (mi >> 1) * 8 + lane % 8) * kLd + ksi * 16 + (mi & 1) * 8);
                mma_bf16(s[2 * np], qf[ksi], b[0], b[1]);
                mma_bf16(s[2 * np + 1], qf[ksi], b[2], b[3]);
              }
            }
          }
          // scale, mask, online softmax: s[n][e] is row g (e < 2) or g + 8,
          // column c0 + 8n + 2t + (e & 1)
          float cmax[2] = {kNeg, kNeg};
          bool ok[4][4];
  #pragma unroll
          for (int n = 0; n < 4; ++n) {
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = 8 * n + 2 * t + (e & 1);
              const int row = wrow0 + g + 8 * (e >> 1);
              ok[n][e] = rows_t[cl] >= 0 && c0 + cl <= start + row;
              s[n][e] *= kQuant ? sm_scale * ks_s[c0 - w0 + cl] : sm_scale;
              if (ok[n][e]) cmax[e >> 1] = fmaxf(cmax[e >> 1], s[n][e]);
            }
          }
          float alpha[2];
  #pragma unroll
          for (int r = 0; r < 2; ++r) {
            cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
            cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
            const float m_new = fmaxf(m_r[r], cmax[r]);
            alpha[r] = __expf(m_r[r] - m_new);
            m_r[r] = m_new;
            l_r[r] *= alpha[r];
          }
  #pragma unroll
          for (int i = 0; i < kDT; ++i) {
            acc[i][0] *= alpha[0];
            acc[i][1] *= alpha[0];
            acc[i][2] *= alpha[1];
            acc[i][3] *= alpha[1];
          }
          // p, then p times the V scale split into bf16 hi + lo A fragments
          uint32_t ph[2][4], pl[2][4];
  #pragma unroll
          for (int n = 0; n < 4; ++n) {
            float p[4];
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = ok[n][e] ? __expf(s[n][e] - m_r[e >> 1]) : 0.f;
              l_r[e >> 1] += p[e];
              if (kQuant) p[e] *= vs_s[c0 - w0 + 8 * n + 2 * t + (e & 1)];
            }
            // k16 step n / 2; n8 tile n % 2 is its columns 0-7 or 8-15
            split_bf16(p[0], p[1], ph[n / 2][2 * (n % 2)], pl[n / 2][2 * (n % 2)]);
            split_bf16(p[2], p[3], ph[n / 2][2 * (n % 2) + 1], pl[n / 2][2 * (n % 2) + 1]);
          }
          // acc += P.V over the tile: 2 k16 steps x head_dim n8 tiles
  #pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
  #pragma unroll
            for (int dp = 0; dp < kKS; ++dp) {
              if (dp < hd16) {
                const int mi = lane / 8;
                uint32_t b[4];
                ldsm_x4_trans(b, vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * kLd + dp * 16 + (mi >> 1) * 8);
                mma_bf16(acc[2 * dp], ph[kk], b[0], b[1]);
                mma_bf16(acc[2 * dp], pl[kk], b[0], b[1]);
                mma_bf16(acc[2 * dp + 1], ph[kk], b[2], b[3]);
                mma_bf16(acc[2 * dp + 1], pl[kk], b[2], b[3]);
              }
            }
          }
        }
        __syncthreads();  // every warp is done with stage st (and the widened tile)
      }
      cp_async_wait<0>();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    // acc[i][e]: row wrow0 + g + 8 (e >> 1), head_dim 8 i + 2 t + (e & 1)
    if (n_splits == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wrow0 + g + 8 * r;
        if (row >= T) continue;
        const float denom = l_r[r] == 0.f ? 1.f : l_r[r];
        float* op = out + (static_cast<size_t>(h) * T + row) * hd;
#pragma unroll
        for (int i = 0; i < kDT; ++i) {
          if (8 * i < hd) {
            *reinterpret_cast<float2*>(op + 8 * i + 2 * t) =
                make_float2(acc[i][2 * r] / denom, acc[i][2 * r + 1] / denom);
          }
        }
      }
      return;
    }
    // partials: acc (heads, splits, T, hd), then (m, l) (heads, splits, T,
    // 2); chunk_combine_kernel adds them up
    const size_t hs = static_cast<size_t>(h) * n_splits + split;
    float* ml = part + static_cast<size_t>(nh) * n_splits * T * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow0 + g + 8 * r;
      if (row >= T) continue;
      float* ap = part + (hs * T + row) * hd;
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        if (8 * i < hd) {
          *reinterpret_cast<float2*>(ap + 8 * i + 2 * t) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
        }
      }
      if (t == 0) *reinterpret_cast<float2*>(ml + (hs * T + row) * 2) = make_float2(m_r[r], l_r[r]);
    }
  }
}

// out = sum over splits s (in order, those with l_s > 0) of e_s acc_s,
// divided by sum e_s l_s (or 1), with e_s = exp(m_s - max m). One thread
// per (row, 4 head_dim columns); grid (ceil(T * hd / 4 / 128), heads).
__global__ void __launch_bounds__(kCombineThreads)
chunk_combine_kernel(const float* __restrict__ part, float* __restrict__ out, int nh, int T,
                     int hd, int start, int split_cols, int n_splits) {
  const int hd4 = hd / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  if (i >= T * hd4) return;
  const int row = i / hd4, d = 4 * (i % hd4);
  const int col = start + row;  // the row attends columns <= col
  const int used = col < 0 ? 0 : min(n_splits, col / split_cols + 1);
  const size_t hs = static_cast<size_t>(h) * n_splits;
  const float2* ml = reinterpret_cast<const float2*>(part + static_cast<size_t>(nh) * n_splits * T * hd);
  float mx = kNeg;
  for (int s0 = 0; s0 < used; s0 += 8) {
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = s0 + u < used ? __ldcg(ml + (hs + s0 + u) * T + row) : make_float2(kNeg, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (v[u].y > 0.f) mx = fmaxf(mx, v[u].x);
    }
  }
  float den = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < used; s0 += 8) {
    float2 v[8];
    float4 a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = s0 + u < used;
      v[u] = in ? __ldcg(ml + (hs + s0 + u) * T + row) : make_float2(kNeg, 0.f);
      a[u] = in ? __ldcg(reinterpret_cast<const float4*>(part + ((hs + s0 + u) * T + row) * hd + d))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (v[u].y > 0.f) {  // a split with nothing live for this row adds nothing
        const float e = __expf(v[u].x - mx);
        den += v[u].y * e;
        o.x += e * a[u].x;
        o.y += e * a[u].y;
        o.z += e * a[u].z;
        o.w += e * a[u].w;
      }
    }
  }
  const float inv = den == 0.f ? 1.f : den;
  *reinterpret_cast<float4*>(out + (static_cast<size_t>(h) * T + row) * hd + d) =
      make_float4(o.x / inv, o.y / inv, o.z / inv, o.w / inv);
}

template <typename KT, int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* ks,
                       const float* vs, const int* tbl, const int* mask, float* out,
                       float* part, int nh, int T, int hd, int C, int Bk, int start,
                       float sm_scale, int split_cols, int n_splits, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((T + kCRows - 1) / kCRows), static_cast<unsigned>(nh),
                  static_cast<unsigned>(n_splits));
  chunk_attn_mma_kernel<KT, HD><<<grid, kCThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tbl, mask, out, part, nh, T, hd, C, Bk, start,
      sm_scale, split_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const dim3 cgrid(static_cast<unsigned>((T * (hd / 4) + kCombineThreads - 1) / kCombineThreads),
                   static_cast<unsigned>(nh));
  chunk_combine_kernel<<<cgrid, kCombineThreads, 0, st>>>(part, out, nh, T, hd, start,
                                                          split_cols, n_splits);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_mma_hd(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, const int* tbl, const int* mask, float* out,
                          float* part, int nh, int T, int hd, int C, int Bk, int start,
                          float sm_scale, int split_cols, int n_splits, cudaStream_t st) {
  if (hd <= 32) return launch_mma<KT, 32>(q, k, v, ks, vs, tbl, mask, out, part, nh, T, hd, C, Bk, start, sm_scale, split_cols, n_splits, st);
  if (hd <= 64) return launch_mma<KT, 64>(q, k, v, ks, vs, tbl, mask, out, part, nh, T, hd, C, Bk, start, sm_scale, split_cols, n_splits, st);
  return launch_mma<KT, 128>(q, k, v, ks, vs, tbl, mask, out, part, nh, T, hd, C, Bk, start, sm_scale, split_cols, n_splits, st);
}

}  // namespace

// q: (nh, T, hd) bf16 (q_bf16 = 1) or f32, 16-byte aligned. Dense mode
// (tbl == NULL): k/v (nh, C, hd), scales (nh, C, 1). Paged mode: k/v
// (n_blocks, nh, Bk, hd), scales (n_blocks, nh, Bk, 1), tbl (C / Bk,) int32.
// K/V in q's type (kv_kind 0 = f32, 1 = bf16) or int8 (kv_kind 2, with
// scales). mask: (C,) int32. out: (nh, T, hd) f32. All contiguous.
// The bf16 path takes the host's plan: n_splits splits of split_cols
// columns (a multiple of 32) over [0, min(C, start + T)); with n_splits > 1,
// `part` holds
// nh * n_splits * T * (hd + 2) f32 and a second kernel combines the splits.
// The f32 path ignores the plan. Launches on `stream` and returns the
// launch status; it does not synchronise.
extern "C" cudaError_t pathway_flash_chunk_attn(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tbl, const void* mask, void* out, int nh,
    int T, int hd, int C, int Bk, int start, float sm_scale, int q_bf16,
    int kv_kind, int split_cols, int n_splits, void* part, void* stream) {
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
    const long long live_end = std::max(0LL, std::min<long long>(C, static_cast<long long>(start) + T));
    if (split_cols <= 0 || split_cols % kCCols != 0 || n_splits <= 0 ||
        n_splits > kMaxSplits || (n_splits > 1 && part == nullptr) ||
        static_cast<long long>(n_splits) * split_cols < live_end ||
        (n_splits > 1 && static_cast<long long>(n_splits - 1) * split_cols >= live_end)) {
      return cudaErrorInvalidValue;
    }
    float* pp = static_cast<float*>(part);
    if (quant) {
      return launch_mma_hd<int8_t>(q, k, v, ksp, vsp, t, mk, o, pp, nh, T, hd, C, Bk, start, sm_scale, split_cols, n_splits, st);
    }
    return launch_mma_hd<__nv_bfloat16>(q, k, v, nullptr, nullptr, t, mk, o, pp, nh, T, hd, C, Bk, start, sm_scale, split_cols, n_splits, st);
  }
  if (quant) {
    return launch_typed<float, int8_t>(q, k, v, ksp, vsp, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
  }
  return launch_typed<float, float>(q, k, v, nullptr, nullptr, t, mk, o, nh, T, hd, C, Bk, start, sm_scale, st);
}
