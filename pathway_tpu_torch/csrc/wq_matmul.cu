// Fused int8-weight matmul for Hopper (sm_90a): x (M, K) bf16 or f32,
// w (K, N) int8, scale (N,) f32 -> out (M, N) f32.
//
// Replaces the Pallas kernel `_wq_matmul_kernel` reached through
// `wq_matmul` in pathway_tpu/models/wq_matmul.py. Same contract: the int8
// weight tile is widened to the activation type where it is read (int8
// values are exact in bf16 and in f32), products accumulate in f32, and
// each output column is multiplied by its scale once, on the final sum. No
// full-precision copy of the weight is written anywhere.
//
// What bounds it on an H100: at the decoder's shapes (M = 16 decode rows or
// 64 prefill rows; K x N one of 768x2304, 768x768, 768x3072, 3072x768) the
// work is 2*M*K*N flops against ~K*N weight bytes, 2*M flop/byte (32 in
// decode), far below the ~295 where the bf16 tensor cores become the
// limit: the weight bytes bound it, 0.6-2.4 MB a product, well under a
// microsecond each at 3.35 TB/s. What kept the earlier design (f32 FMA on
// CUDA cores, 4-byte weight loads, x re-staged per 512-column chunk, 16-row
// tiles, a (N/32, M/16) grid) at ~33x its bound was too few blocks (24 of
// 132 SMs for the N = 768 products, each walking K serially), latency-bound
// narrow loads, and each weight byte fetched once per 16-row tile.
//
// Design of the bf16 path (tensor cores, split K in a cluster):
// * mma.sync.m16n8k16 bf16 -> f32 (wgmma's 64-row tiles would be 3/4
//   padding at decode's 16 rows, and the kernel is bound by bytes and
//   latency, not by the tensor cores). A block of 4 warps owns 32 output
//   columns and up to 64 rows (4 m16 fragments), so each weight byte is
//   read once per call at M <= 64; larger M loops over 64-row tiles,
//   spread over gridDim.z. The 4 warps take alternate 16-row K steps and
//   their sums meet in shared memory in a fixed order.
// * Weights and x stream through a shared-memory ring with 16-byte
//   cp.async: 8 stages of 64 K rows for decode (M <= 16: a whole split in
//   flight at once), 3 stages with 64 x rows otherwise; x is staged once
//   per block, as bf16. Weight rows are XOR-swizzled by 16-byte chunk and
//   x rows padded so the warps' reads hit distinct banks.
// * The mma contracts any permutation of k, and its output columns can sit
//   anywhere: a thread reads 4 weight bytes (4 columns) of each of the 4
//   rows it needs, and k-slots {2t, 2t+1, 2t+8, 2t+9} of the fragment map to
//   rows {4t, ..., 4t+3}, so x's A fragment is one 8-byte read and the
//   weight's B fragment for 4 n8 tiles comes from 4 reads with no
//   transposition. int8 -> bf16 is exact and done in registers (byte
//   permute into an f32 magic number, one subtract, keep the top half).
// * K is cut into gridDim.y <= 8 splits of whole 16-row steps by the
//   host's plan (`wq_plan` in models/wq_matmul.py), for >= 2 blocks an SM
//   at the decoder's shapes. The splits of a column tile run as one
//   thread-block cluster: each pushes its sums into the shared memory of
//   the split that owns those rows, and after one cluster barrier the
//   owners add them split by split, so results do not vary from run to
//   run. No workspace, atomic or second kernel is involved.
// * Every load is guarded: any M, K and N work and nothing outside the
//   operands is read. A weight pointer or N that breaks 16-byte alignment,
//   or an x pointer or K that breaks it for x, takes guarded narrow loads
//   into the same ring; out-of-range elements are zero.
//
// Measured on the card (PERF.md, tools/time_kernels.py): a decode product
// costs a few microseconds, most of it launch, the first round trip to
// memory and the split reduction. Variants that were slower and dropped:
// 128-column tiles with a workspace reduced by the last block to arrive (a
// dependent chain of loads: 0.110 ms a decode layer); 32-column tiles with
// that reduction (0.032 ms); a cluster whose splits read each other's sums
// (0.025 ms); one ring per warp without block barriers; 128-row stages.
//
// The f32 path (f32 x: the card-vs-CPU f32 check) keeps the earlier design,
// f32 FMA on CUDA cores, unchanged below.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ f32 path

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

// ------------------------------------------------------ bf16 path (mma)

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcBN = 32;        // output columns per block
constexpr int kTcBM = 64;        // rows per row tile at most (4 m16 fragments)
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kMaxSplits = 8;    // K splits of a column tile: one cluster (portable size)
constexpr int kSumLd = kTcBN + 1;  // floats per row of a warp's sums: conflict-free writes

// A ring of STAGES stages of BK k rows (one 16-row step a warp per 64) and
// ROWS x rows: 16 rows and 8 stages for decode (M <= 16: a whole split in
// flight at once), 64 rows and 3 stages otherwise. x rows are padded to BK + 16 bf16 (an odd
// multiple of 32 bytes), so the warps' 8-byte x reads are conflict-free.
template <int ROWS, int STAGES, int BK>
struct WqRing {
  static constexpr int kXStride = BK + 16;
  static constexpr int kWStage = BK * kTcBN;            // bytes of weight per stage
  static constexpr int kXStage = ROWS * kXStride * 2;   // bytes of x per stage
  static constexpr int kRing = STAGES * (kWStage + kXStage);
  static constexpr int kSums = kTcWarps * ROWS * kSumLd * 4;  // the warps' sums, after the ring
  static constexpr int kBytes = kRing > kSums ? kRing : kSums;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte j of a word of int8 biased by 0x80 (u = v + 128), as the bits of
// the f32 2^23 + u; minus 2^23 + 128 gives v exactly
__device__ __forceinline__ float biased_byte(uint32_t u, int j) {
  return __int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u, 0x7540u | j))) - 8388736.f;
}

// two small integers held exactly in f32 -> bf16x2 (lo in the low half):
// their low 16 bits are zero, so the bf16 is the top half of each
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// byte offset of (row, byte) in a weight stage of 32-byte rows: four rows
// make a 128-byte group, whose eight 16-byte chunks are permuted by XOR
// with 2 * (group % 4), so the rows 4 apart that a warp reads together land
// in distinct banks
__device__ __forceinline__ int wsw(int row, int byte) {
  const int group = row >> 2;
  const int slot = (((row & 3) << 1) | (byte >> 4)) ^ ((group & 3) << 1);
  return (group << 7) + (slot << 4) + (byte & 15);
}

// One ring stage: weight rows [k0, k0 + BK) of the block's 32 columns and
// x rows [r0, r0 + rows) over the same k. Zero past K, the split's end, M
// and N. vec_w / vec_x: 16-byte cp.async is legal (alignment holds).
template <int ROWS, int BK>
__device__ __forceinline__ void load_stage(
    uint8_t* ws, __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int r0, int rows,
    int n0, int k0, int ke, bool vec_w, bool vec_x, int tid) {
  constexpr int kXStride = BK + 16;
#pragma unroll
  for (int i = 0; i < BK * 2 / kTcThreads; ++i) {  // BK rows x 2 chunks
    const int q = tid + i * kTcThreads;
    const int row = q >> 1, c = q & 1;
    const int k = k0 + row, col = n0 + 16 * c;
    uint8_t* dst = ws + wsw(row, 16 * c);
    const int8_t* src = w + static_cast<size_t>(k) * N + col;
    if (vec_w) {
      cp_async16(dst, k < ke && col < N ? src : w, k < ke && col < N);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < ke) {
        for (int b = 0; b < 16; ++b) {
          if (col + b < N) v[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b % 4));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS * (BK / 8) / kTcThreads; ++i) {  // rows x BK / 8 chunks
    const int q = tid + i * kTcThreads;
    const int row = q / (BK / 8), c = q % (BK / 8);
    if (row >= rows) continue;  // fragments past the tile's rows are never read
    const int m = r0 + row, k = k0 + 8 * c;
    __nv_bfloat16* dst = xs + row * kXStride + 8 * c;
    const __nv_bfloat16* src = x + static_cast<size_t>(m) * K + k;
    if (vec_x) {
      cp_async16(dst, m < M && k < ke ? src : x, m < M && k < ke);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
        for (int e = 0; e < 8; ++e) {
          if (k + e < ke) {
            v[e / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[e])) << (16 * (e % 2));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int ROWS, int STAGES, int BK>
__global__ void __launch_bounds__(kTcThreads)
wq_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int K, int N, int k_per_split, bool vec_w, bool vec_x) {
  using Ring = WqRing<ROWS, STAGES, BK>;
  constexpr int kXStride = Ring::kXStride;
  constexpr int kWStage = Ring::kWStage;
  constexpr int kXStage = Ring::kXStage;
  constexpr int kMT = ROWS / 16;  // m16 fragments a tile holds
  __shared__ __align__(16) uint8_t smem[Ring::kBytes];
  // the owned rows' sums of every split: [split][owned elements]
  __shared__ float recv_s[kTcBN * (ROWS + kMaxSplits)];
  uint8_t* w_ring = smem;
  __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * kWStage);
  float* red = reinterpret_cast<float*>(smem);  // [warp][ROWS][kSumLd], after the ring

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTcBN;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int kb = split * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int n_stages = (ke - kb + BK - 1) / BK;
  const int row_tiles = (M + kTcBM - 1) / kTcBM;
  const int per_group = (row_tiles + gridDim.z - 1) / gridDim.z;
  // a thread's output column is the same in every epilogue pass below
  const int my_n = n0 + tid % kTcBN;
  const float my_scale = my_n < N ? scale[my_n] : 0.f;

  for (int rt = blockIdx.z * per_group; rt < min(row_tiles, (blockIdx.z + 1) * per_group); ++rt) {
    const int r0 = rt * kTcBM;
    const int rows = min(kTcBM, M - r0);
    const int mt_n = (rows + 15) / 16;  // live m16 fragments (<= kMT)
    float acc[kMT][4][4];
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

    __syncthreads();  // the previous row tile is done with the shared memory
    auto load = [&](int s) {
      load_stage<ROWS, BK>(w_ring + (s % STAGES) * kWStage, x_ring + (s % STAGES) * (kXStage / 2),
                           x, w, M, K, N, r0, mt_n * 16, n0, kb + s * BK, ke, vec_w, vec_x, tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages) load(s);
      cp_async_commit();
    }
    for (int st = 0; st < n_stages; ++st) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage st landed for all; stage st - 1 consumed by all
      if (st + STAGES - 1 < n_stages) load(st + STAGES - 1);
      cp_async_commit();
      const uint8_t* wst = w_ring + (st % STAGES) * kWStage;
      const __nv_bfloat16* xst = x_ring + (st % STAGES) * (kXStage / 2);
      // warp w takes the stage's 16-row steps w, w + 4, ... (zero past the
      // split's end)
#pragma unroll
      for (int step = warp; step < BK / 16; step += kTcWarps) {
        if (kb + st * BK + 16 * step >= ke) break;
        uint32_t u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u[r] = *reinterpret_cast<const uint32_t*>(wst + wsw(16 * step + 4 * t + r, 4 * g)) ^ 0x80808080u;
        }
        uint32_t b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = pack_bf16(biased_byte(u[0], j), biased_byte(u[1], j));
          b1[j] = pack_bf16(biased_byte(u[2], j), biased_byte(u[3], j));
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (mt < mt_n) {
            const uint2 lo = *reinterpret_cast<const uint2*>(
                xst + (16 * mt + g) * kXStride + 16 * step + 4 * t);
            const uint2 hi = *reinterpret_cast<const uint2*>(
                xst + (16 * mt + g + 8) * kXStride + 16 * step + 4 * t);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], lo.x, hi.x, lo.y, hi.y, b0[j], b1[j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: the warps' sums go there

    // accumulator (mt, j, 2h + e) is tile row 16 mt + g + 8 h, column
    // 8 t + 4 e + j (n8 tile j holds columns 4 g + j)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= mt_n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            red[(warp * ROWS + 16 * mt + g + 8 * h) * kSumLd + 8 * t + 4 * e + j] = acc[mt][j][2 * h + e];
          }
    }
    // element i of the tile is row i / 32, column i % 32 (the thread's own)
    auto sum_at = [&](const float* r, int i) {
      return r + (i / kTcBN) * kSumLd + i % kTcBN;
    };
    if (n_splits == 1) {
      __syncthreads();
      // the 4 warps' k steps meet in a fixed order
      for (int i = tid; i < rows * kTcBN; i += kTcThreads) {
        float v = *sum_at(red, i);
#pragma unroll
        for (int wi = 1; wi < kTcWarps; ++wi) v += *sum_at(red + wi * ROWS * kSumLd, i);
        if (my_n < N) out[static_cast<size_t>(r0 + i / kTcBN) * N + my_n] = v * my_scale;
      }
      continue;
    }

    // The K splits of this tile are one thread-block cluster. Split s
    // owns rows [s * rows_per, (s + 1) * rows_per) of the tile; every split
    // stores its sums of those rows into the owner's shared memory, and
    // after one cluster barrier each owner adds its rows' sums split by
    // split, so results do not vary from run to run.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (rt != blockIdx.z * per_group) cluster.sync();  // owners are done with the last tile
    __syncthreads();
    const int chunk = kTcBN * ((rows + n_splits - 1) / n_splits);  // elements a split owns
    for (int i = tid; i < rows * kTcBN; i += kTcThreads) {
      float v = *sum_at(red, i);
#pragma unroll
      for (int wi = 1; wi < kTcWarps; ++wi) v += *sum_at(red + wi * ROWS * kSumLd, i);
      const int owner = i / chunk;
      *cluster.map_shared_rank(recv_s + split * chunk + (i - owner * chunk), owner) = v;
    }
    cluster.sync();  // every split's sums are at their owners
    const int mine = min(chunk, rows * kTcBN - split * chunk);
    for (int j = tid; j < mine; j += kTcThreads) {
      float v = recv_s[j];
      for (int sp = 1; sp < n_splits; ++sp) v += recv_s[sp * chunk + j];
      if (my_n < N) out[static_cast<size_t>(r0 + (split * chunk + j) / kTcBN) * N + my_n] = v * my_scale;
    }
  }
}

}  // namespace

// x: (M, K) contiguous, bf16 (x_bf16 = 1) or f32. w: (K, N) int8
// contiguous. scale: (N,) f32. out: (M, N) f32. The bf16 path takes the
// host's plan: k_per_split (a multiple of 16) and n_splits (at most 8:
// the splits of a column tile are one cluster) cut K, with
// (n_splits - 1) * k_per_split < K <= n_splits * k_per_split; row_groups
// blocks share the 64-row tiles of M. The f32 path ignores the plan.
// Launches on `stream` and returns the launch status; it does not
// synchronise.
extern "C" cudaError_t pathway_wq_matmul(const void* x, const void* w,
                                         const void* scale, void* out, int M,
                                         int K, int N, int x_bf16,
                                         int k_per_split, int n_splits,
                                         int row_groups, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (x_bf16) {
    if (k_per_split <= 0 || k_per_split % 16 != 0 || n_splits <= 0 || n_splits > kMaxSplits ||
        static_cast<long long>(n_splits - 1) * k_per_split >= K ||
        static_cast<long long>(n_splits) * k_per_split < K || row_groups <= 0 ||
        row_groups > 65535 || row_groups > (M + kTcBM - 1) / kTcBM) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid(static_cast<unsigned>((N + kTcBN - 1) / kTcBN),
                    static_cast<unsigned>(n_splits), static_cast<unsigned>(row_groups));
    const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const bool vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kTcThreads);
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = static_cast<unsigned>(n_splits);
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = n_splits > 1 ? 1 : 0;
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    cudaError_t err = M <= 16
        ? cudaLaunchKernelEx(&cfg, wq_matmul_mma_kernel<16, 8, 64>, xp, wp, sp, op, M, K, N,
                             k_per_split, vec_w, vec_x)
        : cudaLaunchKernelEx(&cfg, wq_matmul_mma_kernel<64, 3, 64>, xp, wp, sp, op, M, K, N,
                             k_per_split, vec_w, vec_x);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  if ((M + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  // 4-byte weight loads need every row start 4-byte aligned
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % kCols == 0;
  wq_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), wp, sp, op, M, K, N, vec);
  return cudaGetLastError();
}
