// Volume-free backward of the fused correlation-pyramid lookup
// (csrc/corr_fused.cu): the factor gradients d_f1 and d_f2 from the lookup's
// output cotangent g [B*Q, L*(2r+1)^2] (dx-major channels, level-major
// stripes), without any [B*Q, h2, w2] cotangent volume.
//
// Replaces flow_supervisor_tpu/kernels/corr_fused.py `_bwd_df1_kernel` (K8)
// and `_bwd_df2_kernel` (K9), the backward `_try_bwd_kernel` runs. For each
// query q and level l, the window cotangent g_l [9, 9] becomes the support
// cotangent d_sup [10, 10] by the transposed 4-tap bilinear (JAX's
// `_support_cotangent`, fx, fy the fractional parts of coords / 2^l), with the
// taps outside [0, h2) x [0, w2) zeroed (the clip and mask of
// `_try_bwd_kernel`) and the whole scaled by 1/sqrt(C). Then
//   K8: d_f1[b, q, :] = sum_l sum_{u,v} d_sup[u, v] * f2_l[b, y0+u, x0+v, :]
//   K9: d_f2_l[b, y0+u, x0+v, :] += d_sup[u, v] * f1[b, q, :]
// with fp32 sums; d_f1 is written in f1's dtype, d_f2_l into fp32
// accumulators that the wrapper zeroes and then casts to f2_l's dtype. The
// window base is clamped in float as in the forward, so coords far out of
// bounds cannot overflow. Any batch: b = q / q_per_b.
//
// The TPU design scattered each query tile's support cotangents into a zeroed
// [TQ, hp, wp] VMEM slab with lane rolls and 8-queries-per-lane-group packing,
// then contracted the slab on the MXU (K8: d_f1_tile = slab . f2_l, one
// pallas_call per level, summed over levels in fp32 in level order). Both
// kernels here keep the tile, but contract only the bounding box of the
// tile's valid taps, not the whole map.
//
// What bounds them on an H100:
// - K8's unique bytes (g, the pooled f2 pyramid, d_f1: about 53 MB at the
//   chairs Baseline step's lookup, B=10 at 46x62, bf16) bound it at about
//   16 us a call; the flops (2*C per support tap) are far below the tensor
//   cores' rate. Its first design, one warp per query and all levels in one
//   launch, gathered every nonzero support tap's C-channel row of f2 for
//   each query: up to 400 rows of 512 bytes a query, 5.8 GB of L1/L2 reads a
//   chairs call, where neighbouring queries' supports overlap. It took 0.666
//   ms a chairs call on an NVIDIA H100 80GB HBM3 at 700 W (2.4 % of its
//   bound), and indexed the levels at run time (a local-memory frame). Now a
//   block takes an 8x8 tile of neighbouring queries of one sample (the
//   forward's tiles, tiles.cuh) and a slice of 256 channels. Per level: the
//   windows, the box of the valid taps and every query's d_sup in shared
//   memory (the level's pointers selected by static index), then per pass
//   of kBoxChunk box taps the dense cotangent D [64 queries, taps] and
//   acc += D . f2_box[taps, 256] into fp32 registers: on the tensor cores
//   for bf16 with C % 8 == 0 (mma.sync m16n8k16, D as a bf16 high part and
//   the bf16 rest, both into one fp32 accumulator, as K9; the box rows
//   stream by cp.async through two buffers, addressed without integer
//   division), on the CUDA cores in fp32 otherwise. A level whose box
//   exceeds kMaxBoxTaps takes a per-query body into shared memory, added
//   into the same accumulator at that level. One block walks the levels
//   0..L-1 and writes its sums once: no atomics, a fixed order of sums, the
//   same bits from run to run. On that card (python -m
//   flow_supervisor_tpu_torch.probe_k8) a chairs call (480 tiles) takes
//   about 0.14 ms, a sup call (B=1 at 50x90: 84 tiles, 84 blocks for 132
//   SMs) about 0.05; at chairs the level prologues (d_sup from g) take about
//   a third, the mma.sync a quarter, the box rows' staging a fifth. A block
//   per level and a second kernel that sums the levels in order (the
//   probe's layout B) was faster at sup only, by about 0.02 ms a call.
// - K9 was bound by its atomic traffic to L2, not by bytes: its first
//   design (one warp per (query, level), every valid tap adding the query's
//   whole C-channel row with 16-byte atomics) took 55.07 ms per Sintel semi
//   step on an NVIDIA H100 80GB HBM3 at 700 W, 0.16 % of its bound. At the
//   50x90 supervised shape a lookup backward adds 1.37 million rows (up to
//   2,900 onto each level-3 pixel), and each level took about a quarter of
//   the call's 1.54 ms. Now a block takes a kTileY x kTileX tile of
//   neighbouring queries of one sample at one level, the TPU kernel's
//   pre-reduction in shared memory: it computes the tile's d_sup and the
//   bounding box of their valid taps (clipped to the map), then, per pass of
//   kBoxChunk box taps, the dense cotangent D [queries, taps] and out = D^T
//   . f1_tile, 256 channels of f1 staged in shared memory at a time: on the
//   tensor cores for bf16 f1 (mma.sync m16n8k16, D as a bf16 high part and
//   the bf16 rest, both into one fp32 accumulator, so that d_sup keeps
//   about 16 bits), on the CUDA cores in fp32 otherwise. It adds out into
//   the fp32 accumulator with one 16-byte atomic per 4 channels of each box
//   tap (all-zero ones skipped): 32 times fewer rows at the model's flow
//   (chip_smoke.py's train_bwd_timing line). On that card the
//   tensor-core body takes 0.065 ms a call at that shape, 0.047 without its
//   flush (python -m flow_supervisor_tpu_torch.probe_k9): the atomics are
//   29 % of it, and the rest is each block's latency (gathered loads of g
//   for d_sup, the D build) with 336 blocks, 1.3 waves of two an SM. A
//   tile whose box exceeds kMaxBoxTaps (coords that scatter the tile's
//   windows) takes the first design's per-query atomic body instead, so
//   any coords stay correct at a bounded cost per block. The atomics still
//   sum in an order that changes from run to run, so d_f2 differs between
//   runs by fp32 rounding. Channels not a multiple of 8 take a scalar path
//   (lane + 32*i), and C > 256 loops over 256-channel chunks.
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tiles.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // warps per block

struct Levels {
  void* p[kMaxLevels];  // K8: the pooled f2 [B, h2, w2, C]; K9: fp32 d_f2 accumulators
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// Window cotangent at dy index iy, dx index ix (channel ix*k + iy); 0 outside.
template <typename TG>
__device__ __forceinline__ float gwin(const TG* __restrict__ gl, int k, int iy, int ix) {
  return (iy >= 0 && iy < k && ix >= 0 && ix < k) ? fst_load(gl, ix * k + iy) : 0.f;
}

// d_sup[u, v] of one query at one level: the transposed bilinear of the
// window cotangent gl, zero at taps outside the map, times scale.
template <typename TG>
__device__ __forceinline__ float dsup_at(const TG* __restrict__ gl, int radius, const Window& w,
                                         int u, int v, int h2, int w2, float scale) {
  const int k = 2 * radius + 1;
  const int y = w.by + u;
  const int x = w.bx + v;
  if (y < 0 || y >= h2 || x < 0 || x >= w2) return 0.f;
  const float d = (1.f - w.fy) * (1.f - w.fx) * gwin(gl, k, u, v) +
                  (1.f - w.fy) * w.fx * gwin(gl, k, u, v - 1) +
                  w.fy * (1.f - w.fx) * gwin(gl, k, u - 1, v) +
                  w.fy * w.fx * gwin(gl, k, u - 1, v - 1);
  return d * scale;
}

// acc[c] += d * a[i] for the 8 channels of fst_load8's layout, atomically.
template <bool VEC>
__device__ __forceinline__ void atomic_add8(float* __restrict__ row, int chunk, int lane, int C,
                                            float d, const float a[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
      atomicAdd(reinterpret_cast<float4*>(row + c),
                make_float4(d * a[0], d * a[1], d * a[2], d * a[3]));
      atomicAdd(reinterpret_cast<float4*>(row + c + 4),
                make_float4(d * a[4], d * a[5], d * a[6], d * a[7]));
#else
#pragma unroll
      for (int i = 0; i < 8; ++i) atomicAdd(row + c + i, d * a[i]);
#endif
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      if (c < C) atomicAdd(row + c, d * a[i]);
    }
  }
}

// ---- K9 ----

constexpr int kBoxChunk = 64;      // box taps per contraction pass: 8 per warp
constexpr int kChunkC = 256;       // channels of f1 staged at a time
constexpr int kThreads = kWarps * 32;

// A block's tile at one level: its valid queries (a window tap inside the
// map) and the box [x0, x0 + bw) x [y0, y0 + bh) of their valid taps.
struct TileBox {
  int l, b, h2, w2, nvalid, x0, y0, bw, bh;
};

// Per-query shared memory of a tile of TQ queries: d_sup [TQ, (2r+2)^2], then
// the valid queries' row q, window base and fractional part, then 5
// reduction slots per query warp.
struct TileQueries {
  float* dsup;
  int* qrow;
  int* qbx;
  int* qby;
  float* qfx;
  float* qfy;
  int* wstat;
};

__host__ __device__ inline long tile_query_words(int tq, int radius) {
  const long sp = 2L * radius + 2;
  return tq * (sp * sp + 5) + (tq / 32) * 5;
}

template <int TQ>
__device__ inline TileQueries tile_queries(float* base, int ns) {
  TileQueries sq;
  sq.dsup = base;
  sq.qrow = reinterpret_cast<int*>(base + TQ * ns);
  sq.qbx = sq.qrow + TQ;
  sq.qby = sq.qbx + TQ;
  sq.qfx = reinterpret_cast<float*>(sq.qby + TQ);
  sq.qfy = sq.qfx + TQ;
  sq.wstat = reinterpret_cast<int*>(sq.qfy + TQ);
  return sq;
}

// Block-wide: find this block's (level, sample, tile), its valid queries (in
// tile order) and their box, and every valid query's d_sup. Blocks are
// level-major from level0, so the heavy level-0 tiles start first.
template <typename TG, int TY, int TX>
__device__ TileBox tile_prologue(const Levels& acc, int levels, int level0, const QueryGrid& grid,
                                 int batch, const float* __restrict__ coords,
                                 const TG* __restrict__ g, int q_per_b, int C, int radius,
                                 const TileQueries& sq) {
  constexpr int TQ = TY * TX;
  constexpr int NW = TQ / 32;  // warps that hold a query each lane
  static_assert(TQ % 32 == 0 && TQ <= kThreads, "a tile is whole warps of one block");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tiles = grid.tiles_y * grid.tiles_x;
  const long per_level = (long)batch * tiles;
  TileBox box;
  box.l = level0 + (int)(blockIdx.x / per_level);
  const long rem = blockIdx.x % per_level;
  box.b = (int)(rem / tiles);
  const int tile = (int)(rem % tiles);
  box.h2 = acc.h2[box.l];
  box.w2 = acc.w2[box.l];
  const int sp = 2 * radius + 2;
  const float s = 1.0f / (float)(1 << box.l);
  bool valid = false;
  int q = 0;
  Window w = {0, 0, 0.f, 0.f};
  unsigned mask = 0;
  if (warp < NW) {
    const int qy = (tile / grid.tiles_x) * TY + tid / TX;
    const int qx = (tile % grid.tiles_x) * TX + tid % TX;
    int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
    if (qy < grid.qh && qx < grid.qw) {
      q = box.b * q_per_b + qy * grid.qw + qx;
      w = window_at(coords[2 * (long)q] * s, coords[2 * (long)q + 1] * s, radius, box.h2, box.w2);
      const int vx0 = max(w.bx, 0), vx1 = min(w.bx + sp, box.w2);
      const int vy0 = max(w.by, 0), vy1 = min(w.by + sp, box.h2);
      valid = vx0 < vx1 && vy0 < vy1;
      if (valid) {
        x0 = vx0;
        x1 = vx1;
        y0 = vy0;
        y1 = vy1;
      }
    }
    mask = __ballot_sync(0xffffffffu, valid);
    x0 = __reduce_min_sync(0xffffffffu, x0);
    y0 = __reduce_min_sync(0xffffffffu, y0);
    x1 = __reduce_max_sync(0xffffffffu, x1);
    y1 = __reduce_max_sync(0xffffffffu, y1);
    if (lane == 0) {
      int* ws = sq.wstat + warp * 5;
      ws[0] = x0;
      ws[1] = y0;
      ws[2] = x1;
      ws[3] = y1;
      ws[4] = __popc(mask);
    }
  }
  __syncthreads();
  int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN, n = 0, before = 0;
  for (int i = 0; i < NW; ++i) {
    const int* ws = sq.wstat + i * 5;
    x0 = min(x0, ws[0]);
    y0 = min(y0, ws[1]);
    x1 = max(x1, ws[2]);
    y1 = max(y1, ws[3]);
    before += i < warp ? ws[4] : 0;
    n += ws[4];
  }
  box.nvalid = n;
  box.x0 = x0;
  box.y0 = y0;
  box.bw = x1 - x0;
  box.bh = y1 - y0;
  if (n == 0) return box;  // the same for every thread
  if (valid) {
    const int r = before + __popc(mask & ((1u << lane) - 1u));
    sq.qrow[r] = q;
    sq.qbx[r] = w.bx;
    sq.qby[r] = w.by;
    sq.qfx[r] = w.fx;
    sq.qfy[r] = w.fy;
  }
  __syncthreads();
  const int ns = sp * sp;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const float scale = 1.f / sqrtf((float)C);
  for (int e = tid; e < n * ns; e += blockDim.x) {
    const int t = e / ns;
    const int si = e - t * ns;
    const Window wq = {sq.qbx[t], sq.qby[t], sq.qfx[t], sq.qfy[t]};
    sq.dsup[e] = dsup_at(g + (long)sq.qrow[t] * levels * k2 + box.l * k2, radius, wq, si / sp,
                         si % sp, box.h2, box.w2, scale);
  }
  __syncthreads();
  return box;
}

// The overflow body, the first K9 design: each warp takes the tile's queries
// in turn and adds d_sup[tap] * f1[q] into every valid tap with atomics.
template <typename TIn, bool VEC>
__device__ void tile_per_query(const TIn* __restrict__ f1, float* __restrict__ accb,
                               const TileBox& box, const TileQueries& sq, int C, int radius) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int nchunks = (C + 255) / 256;
  for (int t = warp; t < box.nvalid; t += blockDim.x / 32) {
    const long q = sq.qrow[t];
    const int bx = sq.qbx[t];
    const int by = sq.qby[t];
    const float* ds = sq.dsup + t * ns;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      float a[8];
      fst_load8<VEC>(f1 + q * C, chunk, lane, C, a);
      int u = 0;
      int v = 0;
      for (int tt = 0; tt < ns; ++tt) {
        const float d = ds[tt];  // the same slot on every lane: a broadcast
        const int y = by + u;
        const int x = bx + v;
        v = v + 1 == sp ? 0 : v + 1;
        u += v == 0;
        if (d != 0.f) atomic_add8<VEC>(accb + ((long)y * box.w2 + x) * C, chunk, lane, C, d, a);
      }
    }
  }
}

// row[c, c + 4) += v atomically, skipped where v is zero; c < C
template <bool VEC>
__device__ __forceinline__ void flush4(float* __restrict__ row, int c, int C, const float* v) {
  if (c >= C) return;
  if (VEC) {
    if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
      atomicAdd(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
#else
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicAdd(row + c + i, v[i]);
#endif
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c + i < C && v[i] != 0.f) atomicAdd(row + c + i, v[i]);
    }
  }
}

// The tile body: per 256-channel chunk, f1's valid rows into f1s [TQ, 256]
// fp32; per pass of kBoxChunk box taps, D [n, kBoxChunk] from d_sup, then
// warp w computes taps [8w, 8w + 8) x lane's channels {4 lane + i, 128 + 4
// lane + i} of D^T . f1s in registers and flushes them.
template <typename TIn, bool VEC>
__device__ void tile_contract(const TIn* __restrict__ f1, float* __restrict__ accb,
                              const TileBox& box, const TileQueries& sq, float* f1s, float* dt,
                              int C, int radius) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int n = box.nvalid;
  const int A = box.bw * box.bh;
  const int nchunks = (C + kChunkC - 1) / kChunkC;
  for (int cc = 0; cc < nchunks; ++cc) {
    for (int e = tid; e < n * 32; e += blockDim.x) {
      const int t = e / 32;
      const int grp = e % 32;
      float v[8];
      fst_load8<VEC>(f1 + (long)sq.qrow[t] * C, cc, grp, C, v);
      float* row = f1s + t * kChunkC;
      if (VEC) {
        *reinterpret_cast<float4*>(row + grp * 8) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(row + grp * 8 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) row[grp + 32 * i] = v[i];
      }
    }
    for (int a0 = 0; a0 < A; a0 += kBoxChunk) {
      for (int e = tid; e < n * kBoxChunk; e += blockDim.x) {
        const int t = e / kBoxChunk;
        const int a = a0 + e % kBoxChunk;
        float d = 0.f;
        if (a < A) {
          const int u = box.y0 + a / box.bw - sq.qby[t];
          const int v = box.x0 + a % box.bw - sq.qbx[t];
          if (u >= 0 && u < sp && v >= 0 && v < sp) d = sq.dsup[t * ns + u * sp + v];
        }
        dt[e] = d;
      }
      __syncthreads();
      const int j0 = warp * 8;
      if (a0 + j0 < A) {
        float acc[8][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
        }
#pragma unroll 2
        for (int t = 0; t < n; ++t) {
          const float4 d0 = *reinterpret_cast<const float4*>(dt + t * kBoxChunk + j0);
          const float4 d1 = *reinterpret_cast<const float4*>(dt + t * kBoxChunk + j0 + 4);
          const float4 fa = *reinterpret_cast<const float4*>(f1s + t * kChunkC + 4 * lane);
          const float4 fb = *reinterpret_cast<const float4*>(f1s + t * kChunkC + 128 + 4 * lane);
          const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
          const float fv[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(dv[j], fv[i], acc[j][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int a = a0 + j0 + j;
          if (a < A) {
            float* row = accb + ((long)(box.y0 + a / box.bw) * box.w2 + box.x0 + a % box.bw) * C;
            flush4<VEC>(row, cc * kChunkC + 4 * lane, C, acc[j]);
            flush4<VEC>(row, cc * kChunkC + 128 + 4 * lane, C, acc[j] + 4);
          }
        }
      }
      __syncthreads();  // dt and f1s are rewritten next
    }
  }
}

// The tensor-core tile body, for bf16 f1 with C % 8 == 0 and 8x8 tiles. Per
// 256-channel chunk f1h [kp, 256] bf16 (kp: the valid queries rounded up to
// 16, zero rows after them); per pass D^T [kBoxChunk taps, kp] as a bf16 high
// part and the bf16 rest, so that d_sup keeps about 16 bits; warp w computes
// all 64 taps x channels [32 w, 32 w + 32) as 4 x 4 mma.sync m16n8k16 tiles,
// each k-step twice (high, low) into one fp32 accumulator. bf16 x bf16
// products are exact in fp32.
constexpr int kTcQueries = 64;
constexpr int kTcF1Stride = kChunkC + 8;  // bf16; ldmatrix's 8 rows on distinct banks
constexpr int kTcDStride = kTcQueries + 8;

__device__ void tile_contract_tc(const __nv_bfloat16* __restrict__ f1, float* __restrict__ accb,
                                 const TileBox& box, const TileQueries& sq, float* smem, int C,
                                 int radius) {
  using bf16 = __nv_bfloat16;
  bf16* f1h = reinterpret_cast<bf16*>(smem);
  bf16* dth = f1h + kTcQueries * kTcF1Stride;
  bf16* dtl = dth + kBoxChunk * kTcDStride;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int n = box.nvalid;
  const int kp = (n + 15) & ~15;
  const int A = box.bw * box.bh;
  for (int cc = 0; cc < (C + kChunkC - 1) / kChunkC; ++cc) {
    for (int e = tid; e < kp * 32; e += blockDim.x) {
      const int t = e / 32;
      const int c = cc * kChunkC + (e % 32) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < n && c < C) v = *reinterpret_cast<const uint4*>(f1 + (long)sq.qrow[t] * C + c);
      *reinterpret_cast<uint4*>(f1h + t * kTcF1Stride + (e % 32) * 8) = v;
    }
    for (int a0 = 0; a0 < A; a0 += kBoxChunk) {
      for (int e = tid; e < kBoxChunk * kp; e += blockDim.x) {
        const int j = e / kp;
        const int t = e - j * kp;
        const int a = a0 + j;
        float d = 0.f;
        if (t < n && a < A) {
          const int u = box.y0 + a / box.bw - sq.qby[t];
          const int v = box.x0 + a % box.bw - sq.qbx[t];
          if (u >= 0 && u < sp && v >= 0 && v < sp) d = sq.dsup[t * ns + u * sp + v];
        }
        const bf16 hi = __float2bfloat16(d);
        dth[j * kTcDStride + t] = hi;
        dtl[j * kTcDStride + t] = __float2bfloat16(d - __bfloat162float(hi));
      }
      __syncthreads();
      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
        }
      }
      for (int k0 = 0; k0 < kp; k0 += 16) {
        unsigned bfr[2][4];  // B fragments of n-tiles (0, 1) and (2, 3)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int krow = k0 + (lane % 8) + ((lane / 8) % 2) * 8;
          const int ncol = warp * 32 + p * 16 + (lane / 16) * 8;
          ldsm_x4_trans(f1h + krow * kTcF1Stride + ncol, bfr[p]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned ah[4];
          unsigned al[4];
          const int off = (mt * 16 + lane % 16) * kTcDStride + k0 + (lane / 16) * 8;
          ldsm_x4(dth + off, ah);
          ldsm_x4(dtl + off, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const unsigned b0 = bfr[nt / 2][(nt % 2) * 2];
            const unsigned b1 = bfr[nt / 2][(nt % 2) * 2 + 1];
            mma_bf16(acc[mt][nt], ah, b0, b1);
            mma_bf16(acc[mt][nt], al, b0, b1);
          }
        }
      }
      // acc[mt][nt] holds (tap mt*16 + lane/4, channels 2 (lane%4) + {0, 1})
      // and the same for tap + 8; lane pairs swap halves, so that each lane
      // adds 4 channels of one tap with one 16-byte atomic
      const int gid = lane / 4;
      const int tig = lane % 4;
      const bool even = (tig & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c = acc[mt][nt];
          const float x0 = __shfl_xor_sync(0xffffffffu, even ? c[2] : c[0], 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, even ? c[3] : c[1], 1);
          const float v[4] = {even ? c[0] : x0, even ? c[1] : x1, even ? x0 : c[2],
                              even ? x1 : c[3]};
          const int a = a0 + mt * 16 + gid + (even ? 0 : 8);
          if (a < A) {
            float* row = accb + ((long)(box.y0 + a / box.bw) * box.w2 + box.x0 + a % box.bw) * C;
            flush4<true>(row, cc * kChunkC + warp * 32 + nt * 8 + (tig & ~1) * 2, C, v);
          }
        }
      }
      __syncthreads();  // the operands are rewritten next
    }
  }
}

// Shared memory of the K9 kernel in 4-byte words: the contraction's operands
// (tensor cores: f1h and D^T high and low, bf16; CUDA cores: f1s [TQ, 256]
// and D [TQ, kBoxChunk], fp32), then the tile's queries.
__host__ __device__ inline long df2_operand_words(int tq, bool tc) {
  return tc ? ((long)kTcQueries * kTcF1Stride + 2L * kBoxChunk * kTcDStride) / 2
            : (long)tq * (kChunkC + kBoxChunk);
}

__host__ __device__ inline long df2_smem_words(int tq, bool tc, int radius) {
  return df2_operand_words(tq, tc) + tile_query_words(tq, radius);
}

// K9: one block per (level, sample, tile of TY x TX queries).
// acc.p[l]: fp32 [B, h2, w2, C]. TC: the tensor-core body (bf16 f1, VEC, 8x8).
template <typename TIn, typename TG, bool VEC, int TY, int TX, bool TC>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_df2_kernel(const TIn* __restrict__ f1, Levels acc, int levels, int level0,
                   QueryGrid grid, int batch, const float* __restrict__ coords,
                   const TG* __restrict__ g, int q_per_b, int C, int radius) {
  constexpr int TQ = TY * TX;
  extern __shared__ __align__(16) float smem[];
  const int ns = (2 * radius + 2) * (2 * radius + 2);
  const TileQueries sq = tile_queries<TQ>(smem + df2_operand_words(TQ, TC), ns);
  const TileBox box = tile_prologue<TG, TY, TX>(acc, levels, level0, grid, batch, coords, g,
                                                q_per_b, C, radius, sq);
  if (box.nvalid == 0) return;
  float* accb = static_cast<float*>(acc.p[box.l]) + (long)box.b * box.h2 * box.w2 * C;
  if (box.bw * box.bh > kMaxBoxTaps) {
    tile_per_query<TIn, VEC>(f1, accb, box, sq, C, radius);
  } else if constexpr (TC) {
    static_assert(VEC && TQ == kTcQueries, "the tensor-core body takes 8x8 tiles, C % 8 == 0");
    tile_contract_tc(f1, accb, box, sq, smem, C, radius);
  } else {
    tile_contract<TIn, VEC>(f1, accb, box, sq, smem, smem + TQ * kChunkC, C, radius);
  }
}

// ---- K8 ----
//
// A block takes a kTileY x kTileX tile of neighbouring queries of one sample
// and one slice of W channels [c0, c0 + W) (df1_tile), and walks its levels
// in order, holding the tile's d_f1 slice in fp32 registers across them. Per
// level: the queries' windows, the box of their valid taps and their d_sup
// (df1_level); then, per pass of kBoxChunk box taps, the dense cotangent D
// [64 queries, taps] and acc += D . f2_box[taps, W]. A level whose box
// exceeds kMaxBoxTaps takes the per-query body into shared memory instead,
// added into acc before the next level. The block writes acc once, after
// the last level. No atomics, a fixed order of sums: bitwise the same from
// run to run. The kernel takes W = kDf1Slice on the tensor cores.

constexpr int kTileQ = kTileY * kTileX;  // a K8 block's queries, in tile order
constexpr int kOutside = -(1 << 30);     // window base of a query with no valid tap
constexpr int kDStride = kBoxChunk + 8;  // bf16 D [query, tap]; ldmatrix's 8 rows on distinct banks
constexpr int kDtStride = kBoxChunk + 4; // fp32 D^T [tap, query] of the CUDA-core body
constexpr int kDf1Slice = 256;           // channels a block takes on the tensor cores
constexpr int kCcSlice = 128;            // channels a block takes on the CUDA cores

// K8's shared memory after the operands: each query's d_sup at the current
// level (stride ds = (2r+2)^2 | 1, odd, so that neighbouring queries' slots
// fall on distinct banks), its row in B*Q (-1 outside the grid), window base
// (kOutside without a valid tap) and fractional part, then 5 reduction slots
// per query warp.
struct Df1Smem {
  float* dsup;
  int* qrow;
  int* qbx;
  int* qby;
  float* qfx;
  float* qfy;
  int* wstat;
};

__host__ __device__ inline int dsup_stride(int radius) {
  const int sp = 2 * radius + 2;
  return (sp * sp) | 1;
}

// The operands in 4-byte words. Tensor cores: two buffers of kBoxChunk f2
// rows of W bf16 (stride W + 8) and D's high and low part; CUDA cores: f2
// rows [kBoxChunk, kCcSlice + 4] and D^T [kBoxChunk, kDtStride], fp32. The
// per-query body's fp32 sums [64, W + 8] (tensor cores) or [64, kCcSlice + 4]
// alias the f2 rows: the same words.
__host__ __device__ inline long df1_operand_words(int w, bool tc) {
  return tc ? (long)kBoxChunk * (w + 8) + (long)kTileQ * kDStride
            : (long)kBoxChunk * (kCcSlice + 4) + (long)kBoxChunk * kDtStride;
}

__host__ __device__ inline long df1_smem_words(int w, bool tc, int radius) {
  return df1_operand_words(w, tc) + (long)kTileQ * (dsup_stride(radius) + 5) +
         kTileQ / 32 * 5;
}

__device__ inline Df1Smem df1_smem(float* base, int ds) {
  Df1Smem sm;
  sm.dsup = base;
  sm.qrow = reinterpret_cast<int*>(base + kTileQ * ds);
  sm.qbx = sm.qrow + kTileQ;
  sm.qby = sm.qbx + kTileQ;
  sm.qfx = reinterpret_cast<float*>(sm.qby + kTileQ);
  sm.qfy = sm.qfx + kTileQ;
  sm.wstat = reinterpret_cast<int*>(sm.qfy + kTileQ);
  return sm;
}

// A tile at one level: the map's size, the number of queries with a valid
// tap and the box [x0, x0 + bw) x [y0, y0 + bh) of their valid taps (inv_bw =
// 1 / bw).
struct Df1Level {
  int h2, w2, nvalid, x0, y0, bw, bh;
  float inv_bw;
};

// Box tap a -> its map row y and column x, by a float reciprocal of the box
// width (exact for a < kMaxBoxTaps + kBoxChunk, as in corr_fused.cu).
__device__ __forceinline__ void box_tap(const Df1Level& t, int a, int& y, int& x) {
  const int r = (int)(((float)a + 0.5f) * t.inv_bw);
  y = t.y0 + r;
  x = t.x0 + a - r * t.bw;
}

// Block-wide, at level l of a map h2 x w2: thread q < 64 holds its query's
// row (-1 outside the grid) and coords (cx, cy) at level 0. Writes each
// query's window, finds the box and writes every valid query's d_sup. Ends
// with a barrier, so the caller may use all of it.
template <typename TG>
__device__ Df1Level df1_level(const Df1Smem& sm, int l, int levels, int h2, int w2, int row,
                              float cx, float cy, const TG* __restrict__ g, int C, int radius,
                              int ds) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  if (warp < kTileQ / 32) {
    Window w = {kOutside, kOutside, 0.f, 0.f};
    bool valid = false;
    int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
    if (row >= 0) {
      const float s = 1.0f / (float)(1 << l);
      w = window_at(cx * s, cy * s, radius, h2, w2);
      const int vx0 = max(w.bx, 0), vx1 = min(w.bx + sp, w2);
      const int vy0 = max(w.by, 0), vy1 = min(w.by + sp, h2);
      valid = vx0 < vx1 && vy0 < vy1;
      if (valid) {
        x0 = vx0;
        x1 = vx1;
        y0 = vy0;
        y1 = vy1;
      } else {
        w.bx = w.by = kOutside;  // no box tap lies in its window
      }
    }
    sm.qbx[tid] = w.bx;
    sm.qby[tid] = w.by;
    sm.qfx[tid] = w.fx;
    sm.qfy[tid] = w.fy;
    const unsigned mask = __ballot_sync(0xffffffffu, valid);
    x0 = __reduce_min_sync(0xffffffffu, x0);
    y0 = __reduce_min_sync(0xffffffffu, y0);
    x1 = __reduce_max_sync(0xffffffffu, x1);
    y1 = __reduce_max_sync(0xffffffffu, y1);
    if (lane == 0) {
      int* ws = sm.wstat + warp * 5;
      ws[0] = x0;
      ws[1] = y0;
      ws[2] = x1;
      ws[3] = y1;
      ws[4] = __popc(mask);
    }
  }
  __syncthreads();
  Df1Level t;
  t.h2 = h2;
  t.w2 = w2;
  int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN, n = 0;
  for (int i = 0; i < kTileQ / 32; ++i) {
    const int* ws = sm.wstat + i * 5;
    x0 = min(x0, ws[0]);
    y0 = min(y0, ws[1]);
    x1 = max(x1, ws[2]);
    y1 = max(y1, ws[3]);
    n += ws[4];
  }
  t.nvalid = n;
  t.x0 = x0;
  t.y0 = y0;
  t.bw = x1 - x0;
  t.bh = y1 - y0;
  t.inv_bw = n > 0 ? 1.f / (float)t.bw : 0.f;
  if (n > 0) {
    // d_sup of the valid queries (as dsup_at): a thread takes (query,
    // support column v) and walks down the column, keeping the row above's
    // two window values
    const int k = 2 * radius + 1;
    const float scale = 1.f / sqrtf((float)C);
    for (int e = tid; e < kTileQ * sp; e += blockDim.x) {
      const int q = e / sp;
      const int v = e - q * sp;
      const int bx = sm.qbx[q];
      if (bx == kOutside) continue;
      const int by = sm.qby[q];
      const float fx = sm.qfx[q];
      const float fy = sm.qfy[q];
      const bool xin = bx + v >= 0 && bx + v < w2;
      const TG* gv = g + ((long)sm.qrow[q] * levels + l) * k * k + v * k;  // dy index iy at gv[iy]
      float up = 0.f, up_left = 0.f;  // window values at (u - 1, v) and (u - 1, v - 1)
      for (int u = 0; u < sp; ++u) {
        const float cur = u < k && v < k ? fst_load(gv, u) : 0.f;
        const float left = u < k && v >= 1 ? fst_load(gv, u - k) : 0.f;
        const float d = (1.f - fy) * (1.f - fx) * cur + (1.f - fy) * fx * left +
                        fy * (1.f - fx) * up + fy * fx * up_left;
        sm.dsup[q * ds + u * sp + v] = xin && by + u >= 0 && by + u < h2 ? d * scale : 0.f;
        up = cur;
        up_left = left;
      }
    }
  }
  __syncthreads();  // the windows, box and d_sup are read next; wstat is rewritten a level on
  return t;
}

// 2 channels [c, c + 2) of a row as fp32, zero past C; VEC: C % 8 == 0 and
// 16-byte aligned rows (c even).
template <bool VEC>
__device__ __forceinline__ float2 load2(const float* __restrict__ row, int c, int C) {
  if (VEC) return c < C ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.f, 0.f);
  return make_float2(c < C ? row[c] : 0.f, c + 1 < C ? row[c + 1] : 0.f);
}

template <bool VEC>
__device__ __forceinline__ float2 load2(const __nv_bfloat16* __restrict__ row, int c, int C) {
  if (VEC) {
    return c < C ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c))
                 : make_float2(0.f, 0.f);
  }
  return make_float2(c < C ? __bfloat162float(row[c]) : 0.f,
                     c + 1 < C ? __bfloat162float(row[c + 1]) : 0.f);
}

// The per-query body, for a level whose box exceeds kMaxBoxTaps: warp w takes
// queries w, w + kWarps, ...; lane i sums d_sup * f2 over the query's nonzero
// taps for channels c0 + 2 (i + 32 j) + {0, 1}, j < W / 64, in fp32, and
// writes them into sums [64, STRIDE] (zeros for a query with no valid tap).
template <typename TIn, bool VEC, int W, int STRIDE>
__device__ void df1_per_query(const TIn* __restrict__ f2b, const Df1Level& t, const Df1Smem& sm,
                              int c0, int C, int radius, int ds, float* sums) {
  constexpr int NJ = W / 64;
  const int lane = threadIdx.x % 32;
  const int sp = 2 * radius + 2;
  for (int q = threadIdx.x / 32; q < kTileQ; q += kWarps) {
    float s[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = 0.f;
    const int bx = sm.qbx[q];
    const int by = sm.qby[q];
    if (bx != kOutside) {  // the same for the whole warp
      const float* dq = sm.dsup + q * ds;
      for (int u = 0; u < sp; ++u) {
        for (int v = 0; v < sp; ++v) {
          const float d = dq[u * sp + v];  // a broadcast; 0 at taps outside the map
          if (d == 0.f) continue;
          const TIn* row = f2b + ((long)(by + u) * t.w2 + bx + v) * C;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float2 f = load2<VEC>(row, c0 + 2 * (lane + 32 * j), C);
            s[j][0] = fmaf(d, f.x, s[j][0]);
            s[j][1] = fmaf(d, f.y, s[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(sums + q * STRIDE + 2 * (lane + 32 * j)) =
          make_float2(s[j][0], s[j][1]);
    }
  }
}

// ---- the tensor-core body: bf16, C % 8 == 0 ----
// Warp w holds acc for queries (w % 4) * 16 + lane / 4 + {0, 8} times
// channels c0 + (w / 4) * W / 2 + 8 nt + 2 (lane % 4) + {0, 1}, nt < W / 16:
// the m16n8k16 accumulator layout, 4 floats an n-tile.

// Stage the f2 rows of box taps [a0, a0 + kBoxChunk), channels [c0, c0 + W),
// into dst [kBoxChunk, W + 8] by cp.async (zeros past the box and past C).
template <int W>
__device__ __forceinline__ void df1_stage(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ f2b,
                                          const Df1Level& t, int a0, int c0, int C) {
  constexpr int SEGS = W / 8;  // 16-byte segments a row
  const int A = t.bw * t.bh;
  for (int e = threadIdx.x; e < kBoxChunk * SEGS; e += kThreads) {
    const int j = e / SEGS;
    const int sg = e % SEGS;
    const int a = a0 + j;
    const int c = c0 + sg * 8;
    const bool in = a < A && c < C;
    int y, x;
    box_tap(t, a, y, x);
    cp_async16(dst + j * (W + 8) + sg * 8, in ? f2b + ((long)y * t.w2 + x) * C + c : f2b,
               in ? 16 : 0);
  }
}

// D [64 queries, kBoxChunk taps] of box taps [a0, a0 + kBoxChunk) as a bf16
// high part dh and the bf16 rest dl: thread i takes query i / 4, taps 16 (i %
// 4) + [0, 16), stepping along the box rows without a division.
__device__ __forceinline__ void df1_build_d(const Df1Level& t, const Df1Smem& sm, int a0,
                                            int radius, int ds, __nv_bfloat16* dh,
                                            __nv_bfloat16* dl) {
  const int q = threadIdx.x / 4;
  const int j0 = (threadIdx.x % 4) * 16;
  const int sp = 2 * radius + 2;
  const int bx = sm.qbx[q];
  const int by = sm.qby[q];
  const float* dq = sm.dsup + q * ds;
  const int left = t.bw * t.bh - a0 - j0;  // taps of the box from the first
  int y, x;
  box_tap(t, a0 + j0, y, x);
  uint4 hv[2], lv[2];
  __nv_bfloat162* h2p = reinterpret_cast<__nv_bfloat162*>(hv);
  __nv_bfloat162* l2p = reinterpret_cast<__nv_bfloat162*>(lv);
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    float d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = y - by;
      const int v = x - bx;
      d[h] = j + h < left && (unsigned)u < (unsigned)sp && (unsigned)v < (unsigned)sp
                 ? dq[u * sp + v] : 0.f;
      if (++x == t.x0 + t.bw) {
        x = t.x0;
        ++y;
      }
    }
    const __nv_bfloat162 hi = __floats2bfloat162_rn(d[0], d[1]);
    const float2 hf = __bfloat1622float2(hi);
    h2p[j / 2] = hi;
    l2p[j / 2] = __floats2bfloat162_rn(d[0] - hf.x, d[1] - hf.y);
  }
  uint4* ph = reinterpret_cast<uint4*>(dh + q * kDStride + j0);
  uint4* pl = reinterpret_cast<uint4*>(dl + q * kDStride + j0);
  ph[0] = hv[0];
  ph[1] = hv[1];
  pl[0] = lv[0];
  pl[1] = lv[1];
}

// acc += D[:, :kt] . f2_rows[:kt, W] (kt a multiple of 16), each k-step
// twice (high, low) into the same fp32 accumulator. bf16 x bf16 products are
// exact in fp32.
template <int W>
__device__ __forceinline__ void df1_mma(const __nv_bfloat16* rows, const __nv_bfloat16* dh,
                                        const __nv_bfloat16* dl, int kt, float* acc) {
  constexpr int NTW = W / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = (warp / 4) * (W / 2);
  for (int k0 = 0; k0 < kt; k0 += 16) {
    unsigned ah[4];
    unsigned al[4];
    const int off = ((warp % 4) * 16 + lane % 16) * kDStride + k0 + (lane / 16) * 8;
    ldsm_x4(dh + off, ah);
    ldsm_x4(dl + off, al);
    const __nv_bfloat16* brow = rows + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * (W + 8) + n0 +
                                (lane / 16) * 8;
#pragma unroll
    for (int p = 0; p < NTW / 2; ++p) {
      unsigned b[4];  // b0, b1 of n-tiles 2p and 2p + 1
      ldsm_x4_trans(brow + p * 16, b);
      mma_bf16(acc + 8 * p, ah, b[0], b[1]);
      mma_bf16(acc + 8 * p, al, b[0], b[1]);
      mma_bf16(acc + 8 * p + 4, ah, b[2], b[3]);
      mma_bf16(acc + 8 * p + 4, al, b[2], b[3]);
    }
  }
}

// One level of a tile on the tensor cores: the box's rows stream through two
// buffers by cp.async, the next pass loading while D of the current one is
// built and its product taken.
template <int W>
__device__ __forceinline__ void df1_contract_tc(const __nv_bfloat16* __restrict__ f2b,
                                                const Df1Level& t, const Df1Smem& sm, int c0,
                                                int C, int radius, int ds, float* ops,
                                                float* acc) {
  using bf16 = __nv_bfloat16;
  bf16* const buf[2] = {reinterpret_cast<bf16*>(ops),
                        reinterpret_cast<bf16*>(ops) + kBoxChunk * (W + 8)};
  bf16* const dh = buf[1] + kBoxChunk * (W + 8);
  bf16* const dl = dh + kTileQ * kDStride;
  const int A = t.bw * t.bh;
  const int passes = (A + kBoxChunk - 1) / kBoxChunk;
  df1_stage<W>(buf[0], f2b, t, 0, c0, C);
  cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    const int a0 = p * kBoxChunk;
    if (p + 1 < passes) {
      df1_stage<W>(buf[(p + 1) % 2], f2b, t, a0 + kBoxChunk, c0, C);
      cp_async_commit();
    }
    df1_build_d(t, sm, a0, radius, ds, dh, dl);
    if (p + 1 < passes) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    df1_mma<W>(buf[p % 2], dh, dl, min(kBoxChunk, (A - a0 + 15) & ~15), acc);
    __syncthreads();  // buf[p % 2] takes pass p + 2, D pass p + 1
  }
}

// ---- the CUDA-core body: fp32 sums, any dtype and C ----
// Thread i holds acc[8 r + s] for query 4 (i / 16) + r and channel c0 + 4 (i
// % 16) + s (s < 4) or c0 + 64 + 4 (i % 16) + s - 4 (s >= 4). Per pass of
// kBoxChunk box taps, the f2 rows [taps, kCcSlice] and D^T [taps, 64] in
// shared memory; a tap adds 32 products from three float4 reads.
template <typename TIn, bool VEC>
__device__ __forceinline__ void df1_contract_cc(const TIn* __restrict__ f2b, const Df1Level& t,
                                                const Df1Smem& sm, int c0, int C, int radius,
                                                int ds, float* ops, float* acc) {
  constexpr int FS = kCcSlice + 4;
  float* f2s = ops;
  float* dts = ops + kBoxChunk * FS;
  const int tid = threadIdx.x;
  const int tq = tid / 16;
  const int tc = tid % 16;
  const int sp = 2 * radius + 2;
  const int A = t.bw * t.bh;
  for (int a0 = 0; a0 < A; a0 += kBoxChunk) {
    for (int e = tid; e < kBoxChunk * (kCcSlice / 4); e += kThreads) {
      const int j = e / (kCcSlice / 4);
      const int c = (e % (kCcSlice / 4)) * 4;
      int y, x;
      box_tap(t, a0 + j, y, x);
      *reinterpret_cast<float4*>(f2s + j * FS + c) =
          a0 + j < A ? load4<VEC>(f2b + ((long)y * t.w2 + x) * C, c0 + c, C)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    {
      const int q = tid % kTileQ;
      const int bx = sm.qbx[q];
      const int by = sm.qby[q];
      for (int j = tid / kTileQ; j < kBoxChunk; j += kThreads / kTileQ) {
        int y, x;
        box_tap(t, a0 + j, y, x);
        const int u = y - by;
        const int v = x - bx;
        dts[j * kDtStride + q] = a0 + j < A && (unsigned)u < (unsigned)sp && (unsigned)v < (unsigned)sp
                                     ? sm.dsup[q * ds + u * sp + v] : 0.f;
      }
    }
    __syncthreads();
    const int kn = min(kBoxChunk, A - a0);
    for (int k = 0; k < kn; ++k) {
      const float4 d = *reinterpret_cast<const float4*>(dts + k * kDtStride + 4 * tq);
      const float4 fa = *reinterpret_cast<const float4*>(f2s + k * FS + 4 * tc);
      const float4 fb = *reinterpret_cast<const float4*>(f2s + k * FS + 64 + 4 * tc);
      const float dv[4] = {d.x, d.y, d.z, d.w};
      const float fv[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[8 * r + s] = fmaf(dv[r], fv[s], acc[8 * r + s]);
      }
    }
    __syncthreads();  // the operands are rewritten next
  }
}

// 4 fp32 values into row[c, c + 4) (those below C); VEC: c < C covers all 4
// and the row is 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ row, int c, int C, const float* v) {
  if (VEC) {
    if (c < C) *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c + i < C) row[c + i] = v[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ row, int c, int C,
                                       const float* v) {
  if (VEC) {
    if (c < C) {
      uint2 raw;
      reinterpret_cast<__nv_bfloat162*>(&raw)[0] = __floats2bfloat162_rn(v[0], v[1]);
      reinterpret_cast<__nv_bfloat162*>(&raw)[1] = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(row + c) = raw;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c + i < C) row[c + i] = __float2bfloat16(v[i]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The per-query body's sums [64, STRIDE] into acc, in the body's layout.
template <int W, bool TC>
__device__ __forceinline__ void df1_add_sums(const float* sums, float* acc) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (TC) {
    const int qa = (warp % 4) * 16 + lane / 4;
    const int n0 = (warp / 4) * (W / 2) + 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < W / 16; ++nt) {
      const float2 a = *reinterpret_cast<const float2*>(sums + qa * (W + 8) + n0 + 8 * nt);
      const float2 b = *reinterpret_cast<const float2*>(sums + (qa + 8) * (W + 8) + n0 + 8 * nt);
      acc[4 * nt] += a.x;
      acc[4 * nt + 1] += a.y;
      acc[4 * nt + 2] += b.x;
      acc[4 * nt + 3] += b.y;
    }
  } else {
    const int tq = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        acc[8 * r + s] += sums[(4 * tq + r) * (kCcSlice + 4) + 4 * tc + (s / 4) * 64 + s % 4];
      }
    }
  }
}

// The tile's d_f1 slice from acc into out (rows of C values), in TOut.
template <typename TOut, bool VEC, int W, bool TC>
__device__ __forceinline__ void df1_store(const Df1Smem& sm, const float* acc, TOut* __restrict__ out,
                                          int c0, int C) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (TC) {
    const int qa = (warp % 4) * 16 + lane / 4;
    const int c = c0 + (warp / 4) * (W / 2) + 2 * (lane % 4);
    const long ra = sm.qrow[qa];
    const long rb = sm.qrow[qa + 8];
#pragma unroll
    for (int nt = 0; nt < W / 16; ++nt) {
      if (c + 8 * nt >= C) continue;
      if (ra >= 0) store2(out + ra * C + c + 8 * nt, acc[4 * nt], acc[4 * nt + 1]);
      if (rb >= 0) store2(out + rb * C + c + 8 * nt, acc[4 * nt + 2], acc[4 * nt + 3]);
    }
  } else {
    const int tq = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long row = sm.qrow[4 * tq + r];
      if (row < 0) continue;
      store4<VEC>(out + row * C, c0 + 4 * tc, C, acc + 8 * r);
      store4<VEC>(out + row * C, c0 + 64 + 4 * tc, C, acc + 8 * r + 4);
    }
  }
}

// One K8 block: sample b, tile `tile` of the grid, channels [c0, c0 + W),
// levels [level0, level1) in order into acc (zeroed here). TC: the
// tensor-core body (bf16, VEC), W channels; else the CUDA-core body,
// kCcSlice channels. Returns with acc holding the tile's sums; thread q < 64
// wrote sm.qrow[q].
template <typename TIn, typename TG, bool VEC, int W, bool TC>
__device__ __forceinline__ void df1_tile(const Levels& lv, int levels, int level0, int level1,
                                         const QueryGrid& grid, int b, int tile,
                                         const float* __restrict__ coords,
                                         const TG* __restrict__ g, int q_per_b, int c0, int C,
                                         int radius, float* smem, const Df1Smem& sm, float* acc) {
  constexpr int ACC = TC ? W / 4 : 32;
  constexpr int STRIDE = TC ? W + 8 : kCcSlice + 4;
  constexpr int SW = TC ? W : kCcSlice;
  const int tid = threadIdx.x;
  const int ds = dsup_stride(radius);
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  int row = -1;
  float cx = 0.f, cy = 0.f;
  if (tid < kTileQ) {
    const int qy = (tile / grid.tiles_x) * kTileY + tid / kTileX;
    const int qx = (tile % grid.tiles_x) * kTileX + tid % kTileX;
    if (qy < grid.qh && qx < grid.qw) {
      row = b * q_per_b + qy * grid.qw + qx;
      cx = coords[2 * (long)row];
      cy = coords[2 * (long)row + 1];
    }
    sm.qrow[tid] = row;
  }
  for (int l = level0; l < level1; ++l) {
    const void* f2 = nullptr;
    int h2 = 0, w2 = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {  // static indices: lv stays in the parameter space
      if (i == l) {
        f2 = lv.p[i];
        h2 = lv.h2[i];
        w2 = lv.w2[i];
      }
    }
    const Df1Level t = df1_level(sm, l, levels, h2, w2, row, cx, cy, g, C, radius, ds);
    if (t.nvalid == 0) continue;  // the same for every thread
    const TIn* f2b = static_cast<const TIn*>(f2) + (long)b * h2 * w2 * C;
    if (t.bw * t.bh > kMaxBoxTaps) {
      df1_per_query<TIn, VEC, SW, STRIDE>(f2b, t, sm, c0, C, radius, ds, smem);
      __syncthreads();
      df1_add_sums<W, TC>(smem, acc);
      __syncthreads();  // the sums' words take the next level's operands
    } else if constexpr (TC) {
      static_assert(VEC && std::is_same<TIn, __nv_bfloat16>::value, "tensor cores take bf16");
      df1_contract_tc<W>(f2b, t, sm, c0, C, radius, ds, smem, acc);
    } else {
      df1_contract_cc<TIn, VEC>(f2b, t, sm, c0, C, radius, ds, smem, acc);
    }
  }
}

// K8: one block per (sample, tile, channel slice): blocks sample-major,
// then tile, then slice (the slices of a tile start together and share its
// g and f2 rows in L2). TC: the tensor-core body, kDf1Slice channels a
// block; else the CUDA-core body, kCcSlice. d_f1 [B*Q, C] in TIn.
template <typename TIn, typename TG, bool VEC, bool TC>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_df1_kernel(Levels lv, int levels, QueryGrid grid, int slices,
                   const float* __restrict__ coords, const TG* __restrict__ g,
                   TIn* __restrict__ d_f1, int q_per_b, int C, int radius) {
  constexpr int W = TC ? kDf1Slice : kCcSlice;
  extern __shared__ __align__(16) float smem[];
  const Df1Smem sm = df1_smem(smem + df1_operand_words(W, TC), dsup_stride(radius));
  const int tiles = grid.tiles_y * grid.tiles_x;
  const int b = (int)blockIdx.x / (tiles * slices);
  const int rem = (int)blockIdx.x - b * tiles * slices;
  const int tile = rem / slices;
  const int c0 = (rem - tile * slices) * W;
  float acc[TC ? W / 4 : 32];
  df1_tile<TIn, TG, VEC, W, TC>(lv, levels, 0, levels, grid, b, tile, coords, g, q_per_b, c0, C,
                                radius, smem, sm, acc);
  df1_store<TIn, VEC, W, TC>(sm, acc, d_f1, c0, C);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// K8 over all `levels`: the tensor-core body for bf16 with VEC, else the
// CUDA-core body.
template <typename TIn, typename TG, bool VEC>
cudaError_t launch_df1(const Levels& lv, int levels, const float* coords, const void* g,
                       void* d_f1, int bq, int q_per_b, int C, int radius, cudaStream_t s) {
  constexpr bool tc = std::is_same<TIn, __nv_bfloat16>::value && VEC;
  constexpr int width = tc ? kDf1Slice : kCcSlice;
  const QueryGrid grid = query_grid<kTileY, kTileX>(q_per_b, lv.h2[0], lv.w2[0]);
  const int slices = (C + width - 1) / width;
  const long blocks = (long)(bq / q_per_b) * grid.tiles_y * grid.tiles_x * slices;
  const long smem = df1_smem_words(width, tc, radius) * (long)sizeof(float);
  auto kernel = bwd_df1_kernel<TIn, TG, VEC, tc>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(lv, levels, grid, slices, coords,
                                                  static_cast<const TG*>(g),
                                                  static_cast<TIn*>(d_f1), q_per_b, C, radius);
  return cudaGetLastError();
}

// K9 over levels [level0, level1) of the `levels` in g's rows; bf16 f1 with
// C % 8 == 0 at 8x8 tiles takes the tensor-core body unless TENSOR_CORES is
// false.
template <typename TIn, typename TG, bool VEC, int TY = kTileY, int TX = kTileX,
          bool TENSOR_CORES = true>
cudaError_t launch_df2(const void* f1, const Levels& acc, int levels, int level0, int level1,
                       const float* coords, const void* g, int bq, int q_per_b, int C,
                       int radius, cudaStream_t s) {
  constexpr bool tc = TENSOR_CORES && std::is_same<TIn, __nv_bfloat16>::value && VEC &&
                      TY * TX == kTcQueries;
  const QueryGrid grid = query_grid<TY, TX>(q_per_b, acc.h2[0], acc.w2[0]);
  const int batch = bq / q_per_b;
  const long blocks = (long)(level1 - level0) * batch * grid.tiles_y * grid.tiles_x;
  const long smem = df2_smem_words(TY * TX, tc, radius) * (long)sizeof(float);
  auto kernel = bwd_df2_kernel<TIn, TG, VEC, TY, TX, tc>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const TIn*>(f1), acc, levels, level0, grid, batch, coords,
      static_cast<const TG*>(g), q_per_b, C, radius);
  return cudaGetLastError();
}

// LAUNCH<TIn, TG, VEC>(args...) for the runtime dtype codes and `vec`
#define FST_BWD_DISPATCH(LAUNCH, ...)                                                 \
  do {                                                                                \
    if (in_dtype == FST_F32 && g_dtype == FST_F32)                                    \
      return (int)(vec ? LAUNCH<float, float, true>(__VA_ARGS__)                      \
                       : LAUNCH<float, float, false>(__VA_ARGS__));                   \
    if (in_dtype == FST_F32 && g_dtype == FST_BF16)                                   \
      return (int)(vec ? LAUNCH<float, __nv_bfloat16, true>(__VA_ARGS__)              \
                       : LAUNCH<float, __nv_bfloat16, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && g_dtype == FST_F32)                                   \
      return (int)(vec ? LAUNCH<__nv_bfloat16, float, true>(__VA_ARGS__)              \
                       : LAUNCH<__nv_bfloat16, float, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && g_dtype == FST_BF16)                                  \
      return (int)(vec ? LAUNCH<__nv_bfloat16, __nv_bfloat16, true>(__VA_ARGS__)      \
                       : LAUNCH<__nv_bfloat16, __nv_bfloat16, false>(__VA_ARGS__));   \
    return (int)cudaErrorInvalidValue;                                                \
  } while (0)

// shared memory is checked against the card's limit at the launch
bool valid_args(int levels, int bq, int q_per_b, int C, int radius) {
  return levels >= 1 && levels <= kMaxLevels && bq >= 1 && q_per_b >= 1 && bq % q_per_b == 0 &&
         C >= 1 && radius >= 0 && radius <= 4096;
}

}  // namespace

extern "C" {

int fst_corr_fused_bwd_df1(void* const* f2, const int* h2, const int* w2, int levels,
                           const void* coords, const void* g, void* d_f1, int bq, int q_per_b,
                           int C, int radius, int in_dtype, int g_dtype, void* stream) {
  if (!valid_args(levels, bq, q_per_b, C, radius)) return (int)cudaErrorInvalidValue;
  Levels lv;
  bool vec = C % 8 == 0 && aligned16(d_f1);
  for (int l = 0; l < levels; ++l) {
    lv.p[l] = f2[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
    vec = vec && aligned16(f2[l]);
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  FST_BWD_DISPATCH(launch_df1, lv, levels, c, g, d_f1, bq, q_per_b, C, radius, s);
}

int fst_corr_fused_bwd_df2(const void* f1, void* const* acc, const int* h2, const int* w2,
                           int levels, const void* coords, const void* g, int bq, int q_per_b,
                           int C, int radius, int in_dtype, int g_dtype, void* stream) {
  if (!valid_args(levels, bq, q_per_b, C, radius)) return (int)cudaErrorInvalidValue;
  Levels lv;
  bool vec = C % 8 == 0 && aligned16(f1);
  for (int l = 0; l < levels; ++l) {
    lv.p[l] = acc[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
    vec = vec && aligned16(acc[l]);
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  FST_BWD_DISPATCH(launch_df2, f1, lv, levels, 0, levels, c, g, bq, q_per_b, C, radius, s);
}

}  // extern "C"
