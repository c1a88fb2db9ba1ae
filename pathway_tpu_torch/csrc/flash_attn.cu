// Whole-sequence flash attention for Hopper (sm_90a), bf16 or f32 in,
// f32 out.
//
// Replaces the Pallas kernel `_self_attn_kernel` reached through
// `flash_attn` in pathway_tpu/models/flash_attention.py. Same contract:
//   out[b,h,r,:] = softmax_c(q[b,h,r,:] . k[b,h,c,:] * sm_scale) @ v[b,h,c,:]
// over the live columns c of row r: mask[b,c] > 0, c < S, and with
// `causal` also c <= r. The mask is read as a (B, S) int32 vector and
// applied here, so no (B, heads, S, S) score, probability or bias tensor
// is written to device memory. A row with no live column divides by 1 and
// comes out as exact zeros.
//
// What bounds it on an H100: at the encoder's shapes (S = 16..32, head_dim
// 32) the work is B*nh*S*S*hd*4 flops against B*nh*S*hd*(3*2 + 4) bytes, a
// few flops per byte, far below the ~295 flop/byte where the tensor cores
// would become the limit: q, k, v read once and the f32 output written
// once (ingest batch: 151 MB in, 101 MB out, ~75 us). The earlier design
// (64-thread blocks holding 32 q and 32 accumulator floats a thread; every
// K/V tile loaded synchronously and widened to f32 in shared memory between
// two barriers; scalar f32 FMAs reading shared memory) reached 43% of that
// bound.
//
// Design of the bf16 path (tensor cores, a persistent ring):
// * mma.sync.m16n8k16 bf16 -> f32 for Q.K^T and P.V, one warp per 16 query
//   rows of one (b, h), its Q fragment in registers (ldmatrix). P stays f32
//   in effect: p is split into bf16 hi + lo and both are multiplied, ~2^-17
//   relative error where one bf16 P would leave 2^-9.
// * A group is 64 query rows: 4 consecutive heads at S <= 16 (key tiles of
//   16; one batch row's when the heads divide by 4, as the encoder's 12
//   do), 2 heads at S <= 32 (tiles of 32), else 64 rows of one head (tiles
//   of 64). A head's rows and its batch row's (B, S) mask are contiguous,
//   so a group's Q, each key tile's K and V and the mask come
//   by 16-byte (mask: 4-byte) cp.async straight into shared memory in bf16,
//   rows padded by 16 bytes so ldmatrix is conflict-free; head_dim columns
//   past hd are zero-filled by the same copies.
// * Persistent blocks (as many as fit on the card) walk their groups'
//   (group, key tile) items through a 2-stage ring: the next item's bytes,
//   with its group's Q, are in flight while one is computed. (3 stages
//   timed slower: fewer blocks fit an SM.)
// * Each warp stages its 16 normalised f32 output rows in its head's K/V
//   rows of the finished stage (no shared memory of their own, so more
//   blocks fit an SM) and stores them with 16-byte coalesced writes.
// * head_dim 32 / 64 / 128 templates; other multiples of 8 are zero-padded
//   (to 16 in the mma depth). With `causal`, key tiles past a group's last
//   row are not loaded and a warp skips tiles past its own last row.
//
// Measured (PERF.md): 70% of the bytes bound at the ingest shape, ~2.3 TB/s
// of reads and writes; 3 stages and register caps for more blocks an SM
// were slower.
//
// The f32 path (the card-vs-CPU f32 check) keeps the earlier design, below
// the bf16 path, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_common.cuh"

namespace {

// ------------------------------------------------------ bf16 path (mma)

constexpr int kMThreads = 128;  // 4 warps, 16 query rows each
constexpr int kGroupRows = 64;  // query rows of a group
constexpr int kStages = 2;      // ring depth: one item in flight while one is computed

// dynamic shared memory: [Q: group slot][64][kLd] bf16, [K|V ring: stage]
// [K|V][64][kLd] bf16 (a group's heads x KT key rows), [mask: stage][64]
// int32. A Q slot per stage: the ring may hold the first items of kStages
// groups.
template <int HD, int KT>
struct AttnSmem {
  static constexpr int kLd = HD + 8;
  static constexpr int kQ = kStages * kGroupRows * kLd * 2;
  static constexpr int kKV = kStages * 2 * 64 * kLd * 2;
  static constexpr int kMask = kStages * 64 * 4;
  static constexpr int kBytes = kQ + kKV + kMask;
};

template <int HD, int KT>
__global__ void __launch_bounds__(kMThreads)
flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                      float* __restrict__ out, int BH, int nh, int S, int hd, float sm_scale,
                      int causal, int n_groups) {
  using L = AttnSmem<HD, KT>;
  constexpr int kLd = L::kLd;
  constexpr int kHeads = 64 / KT;   // heads a group holds
  constexpr int kWph = 4 / kHeads;  // warps (16-row query tiles) a head
  constexpr int kKS = HD / 16;      // mma depth steps over head_dim (padded)
  constexpr int kDT = HD / 8;       // n8 tiles of head_dim
  constexpr int kNT = KT / 8;       // n8 tiles of a key tile
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvbuf = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  int* mbuf = reinterpret_cast<int*>(smem + L::kQ + L::kKV);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int hd8 = hd / 8, hd16 = (hd + 15) / 16;
  const int q_tiles = (S + 15) / 16;
  const int q_chunks = q_tiles > 4 ? (q_tiles + 3) / 4 : 1;  // groups a head (S > 64)
  const int n_kt = (S + KT - 1) / KT;
  const int hs = warp / kWph;  // this warp's head in the group

  int gi = blockIdx.x;
  if (gi >= n_groups) return;

  auto group_bh0 = [&](int gr) { return q_chunks == 1 ? gr * kHeads : gr / q_chunks; };
  auto group_qc = [&](int gr) { return q_chunks == 1 ? 0 : gr % q_chunks; };
  auto group_nkt = [&](int gr) {
    if (!causal) return n_kt;
    const int last = min(S, (group_qc(gr) * 4 + kWph) * 16) - 1;  // the group's last row
    return min(n_kt, last / KT + 1);
  };

  // key tile kt of group gr (and, with with_q, the group's Q) into a stage;
  // rows past S or past the last head, and head_dim columns past hd, are
  // zero-filled and not read (every copy rewrites the padding: a finished
  // stage holds staged output until its next copy)
  constexpr int kCh = HD / 8;  // 16-byte chunks of a padded row
  auto load_item = [&](int stage, int gr, int kt, bool with_q, int qslot) {
    const int bh0 = group_bh0(gr), qc = group_qc(gr), c0 = kt * KT;
    __nv_bfloat16* kd = kvbuf + stage * 2 * 64 * kLd;
    for (int i = tid; i < 2 * 64 * kCh; i += kMThreads) {
      const int which = i / (64 * kCh);
      const int rr = (i / kCh) % 64;  // head (rr / KT), key row (rr % KT)
      const int c = i % kCh;
      const int bh = bh0 + rr / KT, col = c0 + rr % KT;
      const bool ok = bh < BH && col < S && c < hd8;
      const __nv_bfloat16* src = (which ? v : k) + (ok ? (static_cast<size_t>(bh) * S + col) * hd + 8 * c : 0);
      cp_async(kd + (which * 64 + rr) * kLd + 8 * c, src, 16, ok);
    }
    if (tid < 64) {
      const int bh = bh0 + tid / KT, col = c0 + tid % KT;
      const bool ok = bh < BH && col < S;
      cp_async(mbuf + stage * 64 + tid, mask + (ok ? static_cast<size_t>(bh / nh) * S + col : 0), 4, ok);
    }
    if (with_q) {
      __nv_bfloat16* qd = qbuf + qslot * kGroupRows * kLd;
      for (int i = tid; i < kGroupRows * kCh; i += kMThreads) {
        const int rr = i / kCh, c = i % kCh;  // rr: warp rr / 16, its row rr % 16
        const int w = rr / 16;
        const int bh = bh0 + w / kWph;
        const int row = (qc * 4 + w % kWph) * 16 + rr % 16;
        const bool ok = bh < BH && row < S && c < hd8;
        cp_async(qd + rr * kLd + 8 * c, q + (ok ? (static_cast<size_t>(bh) * S + row) * hd + 8 * c : 0), 16, ok);
      }
    }
  };

  uint32_t qf[kKS][4];
  float m_r[2], l_r[2];  // l_r: this thread's share; the quad's sum at the end
  float acc[kDT][4];

  // the load cursor runs kStages - 1 items ahead of the compute cursor;
  // each cursor's group ordinal picks its Q slot
  int lg = gi, lk = 0, lq = 0, ls = 0;
  auto load_next = [&]() {
    if (lg < n_groups) {
      load_item(ls, lg, lk, lk == 0, lq);
      if (lk + 1 < group_nkt(lg)) {
        ++lk;
      } else {
        lg += gridDim.x;
        lk = 0;
        lq = (lq + 1) % kStages;
      }
    }
    ls = (ls + 1) % kStages;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();
  int kt = 0, st = 0, qs = 0;
  int nkt = group_nkt(gi);
  while (gi < n_groups) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item (gi, kt) landed; the stage it replaces is consumed
    load_next();

    const int bh = group_bh0(gi) + hs;
    const int qt = group_qc(gi) * 4 + warp % kWph;
    const int row0 = qt * 16;
    const bool active = bh < BH && row0 < S;
    const int c0 = kt * KT;
    if (active && kt == 0) {  // a new group: Q fragment, fresh softmax state
      const __nv_bfloat16* qw = qbuf + (qs * kGroupRows + warp * 16) * kLd;
#pragma unroll
      for (int s = 0; s < kKS; ++s) ldsm_x4(qf[s], qw + (lane % 16) * kLd + s * 16 + (lane / 16) * 8);
      m_r[0] = m_r[1] = kNeg;
      l_r[0] = l_r[1] = 0.f;
#pragma unroll
      for (int i = 0; i < kDT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
    if (active && (!causal || c0 <= min(S, row0 + 16) - 1)) {
      const __nv_bfloat16* kt_s = kvbuf + (st * 2 * 64 + hs * KT) * kLd;
      const __nv_bfloat16* vt_s = kt_s + 64 * kLd;
      const int* mk = mbuf + st * 64 + hs * KT;
      const int mi = lane / 8;
      // S = Q.K^T over the tile's KT columns
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ksi = 0; ksi < kKS; ++ksi) {
        if (ksi < hd16) {
#pragma unroll
          for (int np = 0; np < KT / 16; ++np) {
            uint32_t b[4];
            ldsm_x4(b, kt_s + (np * 16 + (mi >> 1) * 8 + lane % 8) * kLd + ksi * 16 + (mi & 1) * 8);
            mma_bf16(s[2 * np], qf[ksi], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[ksi], b[2], b[3]);
          }
        }
      }
      // scale, mask, online softmax: s[n][e] is row row0 + g (e < 2) or
      // + 8, column c0 + 8n + 2t + (e & 1)
      float cmax[2] = {kNeg, kNeg};
      bool ok[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * n + 2 * t + (e & 1);
          const int row = row0 + g + 8 * (e >> 1);
          ok[n][e] = mk[cl] > 0 && (!causal || c0 + cl <= row);
          s[n][e] *= sm_scale;
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
      // p split into bf16 hi + lo A fragments
      uint32_t ph[KT / 16][4], pl[KT / 16][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ok[n][e] ? __expf(s[n][e] - m_r[e >> 1]) : 0.f;
          l_r[e >> 1] += p[e];
        }
        // k16 step n / 2; n8 tile n % 2 is its columns 0-7 or 8-15
        split_bf16(p[0], p[1], ph[n / 2][2 * (n % 2)], pl[n / 2][2 * (n % 2)]);
        split_bf16(p[2], p[3], ph[n / 2][2 * (n % 2) + 1], pl[n / 2][2 * (n % 2) + 1]);
      }
      // acc += P.V over the tile: KT / 16 k16 steps x head_dim n8 tiles
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < kKS; ++dp) {
          if (dp < hd16) {
            uint32_t b[4];
            ldsm_x4_trans(b, vt_s + (kk * 16 + (mi & 1) * 8 + lane % 8) * kLd + dp * 16 + (mi >> 1) * 8);
            mma_bf16(acc[2 * dp], ph[kk], b[0], b[1]);
            mma_bf16(acc[2 * dp], pl[kk], b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], ph[kk], b[2], b[3]);
            mma_bf16(acc[2 * dp + 1], pl[kk], b[2], b[3]);
          }
        }
      }
    }
    if (kWph > 1 && kt == nkt - 1) {
      // the head's warps are done with its K/V rows of this stage, which
      // now stage their output
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hs), "r"(32 * kWph));
    }
    if (active && kt == nkt - 1) {
      // the group's last tile: normalise into this warp's staging rows (its
      // rows 0-7 in the head's K rows of the stage, 8-15 in its V rows),
      // then 16-byte coalesced stores of the rows below S
      float* ow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ow[r] = reinterpret_cast<float*>(kvbuf + (st * 2 * 64 + 64 * r + hs * KT) * kLd) +
                (warp % kWph) * 8 * (HD + 4);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
        for (int i = 0; i < kDT; ++i) {
          if (8 * i < hd) {
            *reinterpret_cast<float2*>(ow[r] + g * (HD + 4) + 8 * i + 2 * t) =
                make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
          }
        }
      }
      __syncwarp();
      const int hd4 = hd / 4;
      for (int i = lane; i < 16 * hd4; i += 32) {
        const int r = i / hd4, c = i % hd4;
        if (row0 + r < S) {
          *reinterpret_cast<float4*>(out + (static_cast<size_t>(bh) * S + row0 + r) * hd + 4 * c) =
              *reinterpret_cast<const float4*>(ow[r / 8] + (r % 8) * (HD + 4) + 4 * c);
        }
      }
      __syncwarp();
    }
    st = (st + 1) % kStages;
    if (++kt == nkt) {
      gi += gridDim.x;
      kt = 0;
      qs = (qs + 1) % kStages;
      if (gi < n_groups) nkt = group_nkt(gi);
    }
  }
  cp_async_wait<0>();
}

template <int HD, int KT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* mask, float* out,
                       int BH, int nh, int S, int hd, float sm_scale, int causal,
                       cudaStream_t st) {
  constexpr int kBytes = AttnSmem<HD, KT>::kBytes;
  auto kern = flash_attn_mma_kernel<HD, KT>;
  // once per device (the calls cost far more than a launch): the shared
  // memory ceiling, the card's SMs and how many blocks of this variant fit
  // on one; the persistent grid is their product
  static int sms = 0, per_sm = 0, ready_on = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != ready_on) {
    if (kBytes > 48 * 1024) e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kMThreads, kBytes);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    ready_on = dev;
  }
  const int q_tiles = (S + 15) / 16;
  const long long groups = q_tiles > 4 ? static_cast<long long>(BH) * ((q_tiles + 3) / 4)
                                       : (static_cast<long long>(BH) + 64 / KT - 1) / (64 / KT);
  if (groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(std::min<long long>(groups, static_cast<long long>(sms) * per_sm));
  kern<<<blocks, kMThreads, kBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, out, BH, nh, S, hd, sm_scale, causal,
      static_cast<int>(groups));
  return cudaGetLastError();
}

// head_dim template (32 / 64 / 128, zero-padded up to it) and key tile
// (16 / 32 / 64: the smallest that covers a short S)
template <int HD>
cudaError_t launch_mma_s(const void* q, const void* k, const void* v, const int* mask, float* out,
                         int BH, int nh, int S, int hd, float sm_scale, int causal,
                         cudaStream_t st) {
  if (S <= 16) return launch_mma<HD, 16>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
  if (S <= 32) return launch_mma<HD, 32>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
  return launch_mma<HD, 64>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
}

// ------------------------------------------------ f32 path (earlier design)
//
// A block of 64 threads; each query row is served by TPR threads (1, 2 or
// 4: head_dim / 32 rounded up), each owning 32 of its head_dim columns of q
// and of the f32 accumulator in registers; partial dot products meet
// through warp shuffles. The query tile has QT rows (16, 32 or 64) and a
// block serves as many heads as its rows allow. K/V tiles of QT columns
// per head are staged through shared memory as f32; each tile is consumed
// in chunks of 16 columns (scores, one running-max update, P.V). With
// `causal`, key tiles entirely above the tile's last row are skipped.

constexpr int kThreads = 64;
constexpr int kDims = 32;       // head_dim columns per thread
constexpr int kChunk = 16;      // key columns per online-softmax update

__device__ __forceinline__ void load8(const float* __restrict__ p, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

template <typename T, int TPR, int QT>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ mask,
                  float* __restrict__ out, int BH, int nh, int S, int hd,
                  float sm_scale, int causal) {
  constexpr int R = kThreads / TPR;  // query rows per block
  constexpr int G = R / QT;          // heads per block
  constexpr int BK = QT;             // key columns per tile
  // floats per column slice in shared memory: 32, padded by 4 when a row
  // has several slices so that they start in different banks
  constexpr int PS = TPR == 1 ? kDims : kDims + 4;
  __shared__ __align__(16) float ks[G][BK][TPR * PS];
  __shared__ __align__(16) float vs[G][BK][TPR * PS];
  __shared__ int live_s[G][BK];

  const int tid = threadIdx.x;
  const int part = tid % TPR;  // which 32-column slice of head_dim
  const int slot = tid / TPR;  // query row slot in the block
  const int g = slot / QT;
  const int bh = blockIdx.x * G + g;  // b * nh + h of this thread's head
  const int q0 = blockIdx.y * QT;
  const int row = q0 + slot % QT;
  const bool active = bh < BH && row < S;
  const int hd8 = hd / 8;
  const int d0 = part * kDims;
  const int my8 = max(0, min(kDims, hd - d0)) / 8;  // my 8-column chunks

  // head_dim columns >= hd stay zero for the whole kernel: tile loads
  // write only columns < hd
  if (hd < TPR * kDims) {
    for (int i = tid; i < G * BK * TPR * kDims; i += kThreads) {
      const int dim = i % (TPR * kDims);
      if (dim >= hd) {
        const int gr = i / (TPR * kDims);  // g * BK + r
        const int at = (dim / kDims) * PS + dim % kDims;
        (&ks[0][0][0])[gr * TPR * PS + at] = 0.f;
        (&vs[0][0][0])[gr * TPR * PS + at] = 0.f;
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
    const T* qp = q + (static_cast<size_t>(bh) * S + row) * hd + d0;
#pragma unroll
    for (int c = 0; c < kDims / 8; ++c) {
      if (c < my8) load8(qp + 8 * c, &qr[8 * c]);
    }
  }

  float m = kNeg;
  float l = 0.f;
  int kt_end = (S + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + QT, S) - 1;
    kt_end = min(kt_end, last_row / BK + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int c0 = kt * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < G * BK * hd8; i += kThreads) {
      const int gi = i / (BK * hd8);
      const int rest = i - gi * (BK * hd8);
      const int r = rest / hd8;
      const int dim = (rest - r * hd8) * 8;
      const int at = (dim / kDims) * PS + dim % kDims;
      const int col = c0 + r;
      const int bhi = blockIdx.x * G + gi;
      if (bhi < BH && col < S) {
        const size_t off = (static_cast<size_t>(bhi) * S + col) * hd + dim;
        load8(k + off, &ks[gi][r][at]);
        load8(v + off, &vs[gi][r][at]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[gi][r][at + e] = 0.f;
          vs[gi][r][at + e] = 0.f;
        }
      }
    }
    for (int i = tid; i < G * BK; i += kThreads) {
      const int gi = i / BK;
      const int col = c0 + i % BK;
      const int bhi = blockIdx.x * G + gi;
      live_s[gi][i % BK] =
          bhi < BH && col < S &&
          mask[static_cast<size_t>(bhi / nh) * S + col] > 0;
    }
    __syncthreads();

    const float* kg = &ks[g][0][part * PS];
    const float* vg = &vs[g][0][part * PS];
#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kChunk) {
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
        if (live_s[g][j0 + j] && (!causal || c0 + j0 + j <= row)) {
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
    float* op = out + (static_cast<size_t>(bh) * S + row) * hd + d0;
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

template <typename T, int TPR, int QT>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const int* mask, float* out, int BH, int nh, int S,
                        int hd, float sm_scale, int causal,
                        cudaStream_t stream) {
  constexpr int G = kThreads / TPR / QT;
  const dim3 grid(static_cast<unsigned>((BH + G - 1) / G),
                  static_cast<unsigned>((S + QT - 1) / QT));
  flash_attn_kernel<T, TPR, QT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, out, BH, nh, S, hd, sm_scale, causal);
  return cudaGetLastError();
}

// Threads per row from head_dim; query tile: the smallest of 16, 32, 64
// rows that covers a short S, within the block's 64 / TPR rows.
template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* mask, float* out, int BH, int nh, int S,
                         int hd, float sm_scale, int causal,
                         cudaStream_t st) {
  if (hd <= 32) {
    if (S <= 16) return launch_tile<T, 1, 16>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
    if (S <= 32) return launch_tile<T, 1, 32>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
    return launch_tile<T, 1, 64>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
  }
  if (hd <= 64) {
    if (S <= 16) return launch_tile<T, 2, 16>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
    return launch_tile<T, 2, 32>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
  }
  return launch_tile<T, 4, 16>(q, k, v, mask, out, BH, nh, S, hd, sm_scale, causal, st);
}

}  // namespace

// q, k, v: (B, nh, S, hd) contiguous, bf16 (is_bf16 = 1) or f32; 16-byte
// aligned. mask: (B, S) int32. out: (B, nh, S, hd) f32, 16-byte aligned.
// Launches on `stream` and returns the launch status; it does not
// synchronise.
extern "C" cudaError_t pathway_flash_attn(const void* q, const void* k,
                                          const void* v, const void* mask,
                                          void* out, int B, int nh, int S,
                                          int hd, float sm_scale, int causal,
                                          int is_bf16, void* stream) {
  if (B <= 0 || nh <= 0 || S <= 0 || hd < 8 || hd > 128 || hd % 8 != 0 ||
      static_cast<long long>(B) * nh > 0x7fffffffLL || (S + 15) / 16 > 65535) {
    return cudaErrorInvalidValue;
  }
  const int BH = B * nh;
  const int* m = static_cast<const int*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd <= 32) return launch_mma_s<32>(q, k, v, m, o, BH, nh, S, hd, sm_scale, causal, st);
    if (hd <= 64) return launch_mma_s<64>(q, k, v, m, o, BH, nh, S, hd, sm_scale, causal, st);
    return launch_mma_s<128>(q, k, v, m, o, BH, nh, S, hd, sm_scale, causal, st);
  }
  return launch_typed<float>(q, k, v, m, o, BH, nh, S, hd, sm_scale, causal, st);
}
