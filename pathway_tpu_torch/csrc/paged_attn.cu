// Paged-attention decode for Hopper (sm_90a): one query position per serving
// slot over the global paged KV pool, bf16 or f32 queries, K/V in the
// query's type or int8 with per-token f32 scales; output in the query's
// type.
//
// Replaces the Pallas kernel `_decode_kernel` reached through
// `paged_attn_decode` in pathway_tpu/models/paged_attention.py. Same
// contract: slot b's logical column c lives in physical block
// tbl[b, c / block] at block column c % block; column c is attended when
// slot_mask[b, c] > 0 (any pattern, not only a prefix; the sentinel block's
// columns are masked by the caller); scores are q.k * sm_scale in f32 with
// an online softmax whose running max starts at the finite sentinel -1e30;
// int8 K/V are widened and multiplied by their scales where they are read,
// so no dequantized copy exists; a slot with no live column divides by 1
// and returns exact zeros.
//
// What bounds it on an H100: each live K/V row is read once and used for
// one dot product and one axpy, ~1 flop per byte, so the live K/V bytes
// bound it (13.07 MB, ~3.9 us at the main-path shape: 16 slots x 12 heads
// x 64, blocks of 64, 4,225 live columns). Tensor cores do not help a
// single query row. The earlier design (one block of 128 threads per (slot,
// head) walking its table row serially; element-wise 2-byte loads widened
// to f32 into shared memory between barriers; one thread per column for
// the scores and per head_dim column for P.V, half the threads idle) ran
// at 24x that bound: 192 blocks on 132 SMs with nothing in flight while
// they computed.
//
// Design of the bf16-query path (flash-decoding, no tensor cores):
// * Split the cache across blocks: grid (split, head, slot), a split being
//   a run of `entries` table entries chosen by the host's plan
//   (`decode_plan` in models/paged_attention.py). A split first stages its
//   columns' mask and table entries in one parallel pass, and a split with
//   no live column exits without copying any K/V.
// * A tile is up to 64 columns of one (physical block, head): contiguous in
//   the (n_blocks, heads, block, hd) planes. Its K and V rows (and int8
//   scales) come in the stored type by cp.async of 16 bytes (8 or 4 where
//   rows are narrower) through a 2-stage ring, so the next tile is in
//   flight while one is consumed (3 stages timed no faster, with fewer
//   blocks an SM); tiles with no live column are not copied. Rows
//   are padded in shared memory to a power of two of 16-byte chunks,
//   the padding zero.
// * Every lane owns one 16-byte chunk of a row (8 bf16 or 16 int8 values,
//   widened in registers) and the matching slice of q and of the f32
//   accumulator; ch = row bytes / 16 lanes share a row, a warp holds
//   32 / ch rows at a time and the block 4 times that. Scores meet through
//   shuffles; each warp keeps its own online softmax (max, sum, acc), so a
//   tile needs no block barrier beyond the ring's; warps merge once at the
//   end of the split.
// * The splits of a (slot, head) are one thread-block cluster: each pushes
//   its (m, l, acc) into the first split's shared memory through
//   distributed shared memory, and after one cluster barrier the first
//   split combines them in split order, skipping those with nothing live.
//   A second, fully parallel combine kernel over a workspace was timed
//   beside it and lost (PERF.md): its launch and round trip through L2 cost
//   more than the cluster barrier.
//
// Measured (PERF.md): ~4.6x the bound at the main-path shape. Stripped
// copies of the kernel show each block's chain of round trips (mask,
// tiles, cluster barrier) and its per-tile arithmetic set the time, not
// the bytes.
//
// The f32-query path (the card-vs-CPU f32 check) keeps the earlier design,
// below the bf16 path, unchanged.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

// ------------------------------------------------ bf16-query path (split)

constexpr int kSThreads = 128;
constexpr int kSWarps = kSThreads / 32;
constexpr int kStages = 2;        // ring depth: one tile in flight while one is consumed
constexpr int kMaxTile = 64;      // columns a tile holds at most
constexpr int kTileBytes = 8192;  // bytes of K (or of V) a tile holds at most: 4 passes of the block's rows
constexpr int kWinTiles = 16;     // tiles whose mask and table entries are staged at once
constexpr int kMaxSplits = 8;     // splits of a (slot, head): one portable cluster

// byte offsets of the dynamic shared memory, the same on host and device
struct SplitSmem {
  int scales, live, rowoff, tany, red, recv, total;
  __host__ __device__ SplitSmem(int tw, int rowb, int hdp, bool cluster) {
    // [ring: stage][K|V][tw rows][rowb] [scales: stage][K|V][tw] [live:
    // window columns] [rowoff, tany: window tiles] [red: warp][m, l, acc]
    // [recv, cluster only: split][m, l, acc]
    scales = kStages * 2 * tw * rowb;
    live = scales + kStages * 2 * tw * 4;
    rowoff = live + (kWinTiles * tw + 15) / 16 * 16;
    tany = rowoff + kWinTiles * 4;
    red = tany + kWinTiles * 4;
    recv = red + kSWarps * (hdp + 2) * 4;
    total = recv + (cluster ? kMaxSplits * (hdp + 2) * 4 : 0);
  }
};

// the 16-byte chunk at p (in shared memory) as f32
__device__ __forceinline__ void widen(const uint8_t* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void widen(const uint8_t* p, float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = biased_byte(w[i / 4], i % 4);
}

template <typename KT, bool kCluster>
__global__ void __launch_bounds__(kSThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ kb,
                   const KT* __restrict__ vb, const float* __restrict__ kbs,
                   const float* __restrict__ vbs, const int* __restrict__ tbl,
                   const int* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                   int nh, int hd, int Bk, int M, float sm_scale,
                   int tw, int hdp, int gran, int entries, int n_splits) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int E = 16 / sizeof(KT);  // values of one 16-byte chunk
  extern __shared__ __align__(16) uint8_t smem[];
  const int rowb = hdp * static_cast<int>(sizeof(KT));  // bytes of a row in shared memory
  const SplitSmem L(tw, rowb, hdp, kCluster);
  uint8_t* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + L.scales);
  uint8_t* live_s = smem + L.live;
  int* rowoff_s = reinterpret_cast<int*>(smem + L.rowoff);
  int* tany_s = reinterpret_cast<int*>(smem + L.tany);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x % n_splits;  // the cluster's rank, with kCluster
  const int bh = blockIdx.x / n_splits;
  const int b = bh / nh, h = bh % nh;
  const int ch = rowb / 16;                 // lanes a row, one chunk each (power of 2)
  const int rpw = 32 / ch;                  // rows a warp holds at once
  const int rpp = kSWarps * rpw;            // rows the block holds at once
  const int j = lane % ch;                  // this lane's chunk
  const int slot = warp * rpw + lane / ch;  // this lane's row in a pass
  const int C = M * Bk;
  const int c_lo = split * entries * Bk;
  const int n_tiles = (min(C, c_lo + entries * Bk) - c_lo) / tw;
  const int kv_rowb = hd * static_cast<int>(sizeof(KT));  // bytes of a row in the pool
  // every block of the cluster has started before any writes into another's
  // shared memory: arrive now, wait just before the first remote store
  if (kCluster) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  // head_dim columns past hd stay zero: copies write only a row's first
  // kv_rowb bytes
  if (kv_rowb < rowb) {
    const int pad = rowb - kv_rowb;
    for (int i = tid; i < kStages * 2 * tw * pad; i += kSThreads) {
      ring[(i / pad) * rowb + kv_rowb + i % pad] = 0;
    }
  }
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = j * E + e;
    qv[e] = d < hd ? __bfloat162float(q[static_cast<size_t>(bh) * hd + d]) : 0.f;
  }

  // the (physical block, head) rows of window tile t into a stage
  auto load_tile = [&](int stage, int t) {
    const size_t r0 = static_cast<size_t>(rowoff_s[t]);
    uint8_t* kd = ring + stage * 2 * tw * rowb;
    uint8_t* vd = kd + tw * rowb;
    const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(kb) + r0 * kv_rowb;
    const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(vb) + r0 * kv_rowb;
    if (gran) {
      const int per_row = kv_rowb / gran;
      for (int i = tid; i < 2 * tw * per_row; i += kSThreads) {
        const int which = i / (tw * per_row);
        const int r = (i / per_row) % tw, c = i % per_row;
        cp_async((which ? vd : kd) + r * rowb + c * gran,
                 (which ? vsrc : ksrc) + static_cast<size_t>(r) * kv_rowb + c * gran, gran, true);
      }
    } else {  // rows of an odd byte count: plain byte copies
      for (int i = tid; i < 2 * tw * kv_rowb; i += kSThreads) {
        const int which = i / (tw * kv_rowb), rem = i % (tw * kv_rowb);
        (which ? vd : kd)[(rem / kv_rowb) * rowb + rem % kv_rowb] = (which ? vsrc : ksrc)[rem];
      }
    }
    if (kQuant) {
      for (int i = tid; i < 2 * tw; i += kSThreads) {
        const int which = i / tw, r = i % tw;
        cp_async(sc + (stage * 2 + which) * tw + r, (which ? vbs : kbs) + r0 + r, 4, true);
      }
    }
  };

  // this warp's online softmax: m is the same in every lane; l counts each
  // row once (in its chunk-0 lane); acc is this lane's chunk over its rows
  float m = kNeg, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  bool any_live = false;

  for (int w0 = 0; w0 < n_tiles; w0 += kWinTiles) {
    const int wn = min(kWinTiles, n_tiles - w0);
    const int col0 = c_lo + w0 * tw;
    __syncthreads();  // the previous window's metadata and stages are consumed
    for (int i = tid; i < kWinTiles; i += kSThreads) tany_s[i] = 0;
    __syncthreads();
    for (int i = tid; i < wn * tw; i += kSThreads) {
      const bool lv = mask[static_cast<size_t>(b) * C + col0 + i] > 0;
      live_s[i] = lv;
      if (lv) tany_s[i / tw] = 1;
    }
    for (int t = tid; t < wn; t += kSThreads) {
      const int col = col0 + t * tw;
      rowoff_s[t] = (tbl[static_cast<size_t>(b) * M + col / Bk] * nh + h) * Bk + col % Bk;
    }
    __syncthreads();
    unsigned bits = 0u;  // the window's tiles with a live column
    for (int t = 0; t < wn; ++t) bits |= (tany_s[t] ? 1u : 0u) << t;
    if (bits == 0u) continue;  // nothing live: no K/V read
    any_live = true;
    unsigned ld = bits;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (ld) {
        load_tile(s, __ffs(ld) - 1);
        ld &= ld - 1;
      }
      cp_async_commit();
    }
    const int n_live = __popc(bits);
    for (int it = 0; it < n_live; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile `it` landed for all; its stage's last user is done
      if (ld) {
        load_tile((it + kStages - 1) % kStages, __ffs(ld) - 1);
        ld &= ld - 1;
      }
      cp_async_commit();
      const int t = __ffs(bits) - 1;
      bits &= bits - 1;
      const int st = it % kStages;
      const uint8_t* kt = ring + st * 2 * tw * rowb;
      const uint8_t* vt = kt + tw * rowb;
      const float* kss = sc + st * 2 * tw;
      const float* vss = kss + tw;
      const uint8_t* lv = live_s + t * tw;

      // the lane's row in each of the 4 passes (a row past the tile reads
      // nothing and scores 0): dot products in two chains, then the
      // passes' shuffle reductions interleaved
      float s[4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int r = pp * rpp + slot;
        float d0 = 0.f, d1 = 0.f;
        if (r < tw) {
          float kv[E];
          widen(kt + r * rowb + j * 16, kv);
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            d0 = fmaf(qv[e], kv[e], d0);
            d1 = fmaf(qv[e + 1], kv[e + 1], d1);
          }
        }
        s[pp] = d0 + d1;
      }
      for (int o = ch / 2; o > 0; o /= 2) {
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) s[pp] += __shfl_xor_sync(0xffffffffu, s[pp], o);
      }
      bool ok[4];
      float tmax = kNeg;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int r = pp * rpp + slot;
        ok[pp] = r < tw && lv[r];
        if (ok[pp]) {
          s[pp] *= kQuant ? sm_scale * kss[r] : sm_scale;
          tmax = fmaxf(tmax, s[pp]);
        }
      }
      for (int o = ch; o < 32; o *= 2) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      if (tmax > m) {  // rescale only when the running max moves
        const float alpha = __expf(m - tmax);
        m = tmax;
        l *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] *= alpha;
      }
      // P.V over every row of the tile: a dead column's p is 0 (times its
      // finite V, as in the JAX kernel)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int r = pp * rpp + slot;
        if (r < tw) {
          const float p = ok[pp] ? __expf(s[pp] - m) : 0.f;
          if (j == 0) l += p;
          const float pv = kQuant ? p * vss[r] : p;
          float vv[E];
          widen(vt + r * rowb + j * 16, vv);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(pv, vv[e], acc[e]);
        }
      }
    }
    cp_async_wait<0>();
  }

  // the split's (m, l, acc): this warp's sums over its rows, then the
  // warps merged in a fixed order (red: [warp][m, l, acc[hdp]])
  float mx = kNeg, den = 0.f;
  const int ld_red = hdp + 2;
  if (any_live) {
#pragma unroll
    for (int o = 1; o < 32; o *= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    for (int o = ch; o < 32; o *= 2) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (lane == 0) {
      red[warp * ld_red] = m;
      red[warp * ld_red + 1] = l;
    }
    if (lane < ch) {
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp * ld_red + 2 + j * E + e] = acc[e];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) mx = fmaxf(mx, red[w * ld_red]);
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) den += red[w * ld_red + 1] * __expf(red[w * ld_red] - mx);
  }
  // this thread's head_dim columns d = tid, tid + 128 (hd <= 256)
  auto acc_at = [&](int d) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) o += __expf(red[w * ld_red] - mx) * red[w * ld_red + 2 + d];
    return o;
  };

  if (n_splits == 1) {
    const float inv = den == 0.f ? 1.f : den;
    for (int d = tid; d < hd; d += kSThreads) {
      out[static_cast<size_t>(bh) * hd + d] = __float2bfloat16(any_live ? acc_at(d) / inv : 0.f);
    }
    return;
  }
  // the splits of this (slot, head) are one cluster: each pushes (m, l,
  // acc) into split 0's shared memory; after one cluster barrier split 0
  // adds them up in split order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
  float* recv = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.recv), 0) + split * ld_red;
  if (tid == 0) {
    recv[0] = mx;
    recv[1] = den;
  }
  if (any_live) {
    for (int d = tid; d < hd; d += kSThreads) recv[2 + d] = acc_at(d);
  }
  cluster.sync();
  if (split != 0) return;
  const float* rs = reinterpret_cast<const float*>(smem + L.recv);
  float gm = kNeg;
  for (int s = 0; s < n_splits; ++s) {
    if (rs[s * ld_red + 1] > 0.f) gm = fmaxf(gm, rs[s * ld_red]);
  }
  for (int d = tid; d < hd; d += kSThreads) {
    float o = 0.f, dn = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* r = rs + s * ld_red;
      if (r[1] > 0.f) {  // a split with nothing live adds nothing
        const float e = __expf(r[0] - gm);
        dn += r[1] * e;
        o += e * r[2 + d];
      }
    }
    out[static_cast<size_t>(bh) * hd + d] = __float2bfloat16(o / (dn == 0.f ? 1.f : dn));
  }
}

template <typename KT>
cudaError_t launch_split(const void* q, const void* kb, const void* vb, const float* kbs,
                         const float* vbs, const int* tbl, const int* mask, void* out,
                         int B, int nh, int hd, int Bk, int M, float sm_scale,
                         int entries, int n_splits, cudaStream_t st) {
  const int elem = static_cast<int>(sizeof(KT));
  int hdp = 16 / elem;  // a power of two of 16-byte chunks that holds hd
  while (hdp < hd) hdp *= 2;
  const int rowb = hdp * elem;
  int tw = 1;  // the largest power of two dividing Bk, within the tile caps
  while (tw < kMaxTile && Bk % (2 * tw) == 0 && 2 * tw * rowb <= kTileBytes) tw *= 2;
  const int kv_rowb = hd * elem;
  int gran = 16;  // cp.async width: divides the row bytes and both planes' alignment
  while (gran >= 4 && (kv_rowb % gran != 0 || reinterpret_cast<uintptr_t>(kb) % gran != 0 ||
                       reinterpret_cast<uintptr_t>(vb) % gran != 0)) {
    gran /= 2;
  }
  if (gran < 4) gran = 0;
  const bool use_cluster = n_splits > 1;
  const SplitSmem L(tw, rowb, hdp, use_cluster);
  const size_t smem = static_cast<size_t>(L.total);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = use_cluster ? paged_split_kernel<KT, true> : paged_split_kernel<KT, false>;
  // the shared memory ceiling is raised to the card's maximum once per
  // device and variant: the call costs far more than a launch
  static int ready_on[2] = {-1, -1};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (ready_on[use_cluster] != dev) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    ready_on[use_cluster] = dev;
  }
  const long long blocks = static_cast<long long>(B) * nh * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = use_cluster ? 1 : 0;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(kb),
      static_cast<const KT*>(vb), kbs, vbs, tbl, mask, o, nh, hd, Bk, M, sm_scale, tw,
      hdp, gran, entries, n_splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ------------------------------------------------ f32-query path (earlier design)
//
// A block of 128 threads per (slot, head) walks the slot's table row; per
// physical block the live K/V rows are staged in shared memory as f32
// (scaled when int8), rows padded to head_dim + 1 floats; one thread per
// column computes its score, the block's max and sum come from warp
// shuffles and one shared-memory pass, and each thread owns up to two
// head_dim columns of the f32 accumulator.

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 2;     // head_dim columns per thread: head_dim <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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

template <typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q, const KT* __restrict__ kb,
                        const KT* __restrict__ vb, const float* __restrict__ kbs,
                        const float* __restrict__ vbs, const int* __restrict__ tbl,
                        const int* __restrict__ mask, float* __restrict__ out, int nh,
                        int hd, int Bk, int M, float sm_scale) {
  extern __shared__ float smem_f[];
  const int ld = hd + 1;
  float* ks = smem_f;           // [Bk][ld]
  float* vs = ks + Bk * ld;     // [Bk][ld]
  float* qs = vs + Bk * ld;     // [hd]
  float* ps = qs + hd;          // [Bk] scores, then probabilities
  int* live = reinterpret_cast<int*>(ps + Bk);  // [Bk]
  __shared__ float red[kWarps];

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const size_t qoff = (static_cast<size_t>(b) * nh + h) * hd;
  for (int d = tid; d < hd; d += kThreads) qs[d] = q[qoff + d];

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
    if (d < hd) out[qoff + d] = acc[j] / denom;
  }
}

template <typename KT>
cudaError_t launch_f32(const void* q, const void* kb, const void* vb, const float* kbs,
                       const float* vbs, const int* tbl, const int* mask, void* out, int B,
                       int nh, int hd, int Bk, int M, float sm_scale, cudaStream_t st) {
  const size_t smem = (2 * static_cast<size_t>(Bk) * (hd + 1) + hd + Bk) * sizeof(float)
                      + Bk * sizeof(int);
  auto kern = paged_decode_f32_kernel<KT>;
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(B) * nh, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const KT*>(kb), static_cast<const KT*>(vb),
      kbs, vbs, tbl, mask, static_cast<float*>(out), nh, hd, Bk, M, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, nh, hd) bf16 (q_bf16 = 1) or f32. kb/vb: (n_blocks, nh, Bk, hd) in
// q's type (kv_kind 0 = f32, 1 = bf16) or int8 (kv_kind 2, with kbs/vbs
// (n_blocks, nh, Bk, 1) f32). tbl: (B, M) int32. mask: (B, M * Bk) int32.
// out: (B, nh, hd) in q's type. All contiguous. The bf16 path takes the
// host's plan: n_splits (<= 8, one cluster) splits of `entries` table
// entries, with (n_splits - 1) * entries < M <= n_splits * entries. The f32
// path ignores the plan. Launches on `stream` and returns the launch
// status; it does not synchronise.
extern "C" cudaError_t pathway_paged_attn_decode(
    const void* q, const void* kb, const void* vb, const void* kbs,
    const void* vbs, const void* tbl, const void* mask, void* out, int B,
    int nh, int hd, int Bk, int M, float sm_scale, int q_bf16, int kv_kind,
    int entries, int n_splits, void* stream) {
  if (B <= 0 || nh <= 0 || hd <= 0 || hd > kMaxDims * kThreads || Bk <= 0 ||
      M <= 0 || static_cast<long long>(B) * nh > 0x7fffffffLL ||
      static_cast<long long>(M) * Bk > 0x7fffffffLL) {
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
    if (entries <= 0 || n_splits <= 0 || n_splits > kMaxSplits ||
        static_cast<long long>(n_splits - 1) * entries >= M ||
        static_cast<long long>(n_splits) * entries < M) {
      return cudaErrorInvalidValue;
    }
    if (quant) {
      return launch_split<int8_t>(q, kb, vb, ks, vs, t, mk, out, B, nh, hd, Bk, M, sm_scale,
                                  entries, n_splits, st);
    }
    return launch_split<__nv_bfloat16>(q, kb, vb, nullptr, nullptr, t, mk, out, B, nh, hd, Bk,
                                       M, sm_scale, entries, n_splits, st);
  }
  if (quant) {
    return launch_f32<int8_t>(q, kb, vb, ks, vs, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
  }
  return launch_f32<float>(q, kb, vb, nullptr, nullptr, t, mk, out, B, nh, hd, Bk, M, sm_scale, st);
}
