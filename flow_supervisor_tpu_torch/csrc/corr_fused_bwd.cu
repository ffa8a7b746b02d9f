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
// then contracted the slab on the MXU, because Mosaic cannot gather or
// scatter. A GPU can, so K8 touches only the support taps; K9 keeps the
// tile's pre-reduction (below), because its sums collide.
//
// What bounds them on an H100:
// - K8 reads, per query and level, the same <= 100 support vectors of C
//   values as the forward K6 and does 2*C flops on each; neighbouring
//   queries' supports overlap, so that traffic hits L1/L2 and the unique
//   bytes (g, the pooled f2, d_f1) bound it at microseconds, far below what
//   the per-query re-reads cost. One warp per query, all levels in one launch:
//   lanes build every level's d_sup in shared memory, then each lane owns 8
//   channels (one 16-byte load of a bf16 row per lane) and accumulates the
//   weighted support vectors in registers. d_f1 is written once, with no
//   atomics, so it is deterministic.
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
//   runs by fp32 rounding.
// Channels not a multiple of 8 take a scalar path (lane + 32*i), and C > 256
// loops over 256-channel chunks, as in the forward.
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // warps per block

struct Levels {
  void* p[kMaxLevels];  // K8: the pooled f2 [B, h2, w2, C]; K9: fp32 d_f2 accumulators
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// The window of one query at one level: base (clamped) and fractional part.
struct Window {
  int bx, by;
  float fx, fy;
};

__device__ __forceinline__ Window window_at(float cx, float cy, int radius, int h2, int w2) {
  const int sp = 2 * radius + 2;
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  Window w;
  w.fx = cx - flx;
  w.fy = cy - fly;
  w.bx = (int)fminf(fmaxf(flx - radius, -(float)sp), (float)w2);
  w.by = (int)fminf(fmaxf(fly - radius, -(float)sp), (float)h2);
  return w;
}

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

// d_sup [(2r+2)^2] of one query at one level into shared memory, by the
// warp's lanes.
template <typename TG>
__device__ void support_cotangent(const TG* __restrict__ gl, int radius, const Window& w,
                                  int h2, int w2, float scale, float* dsup, int lane) {
  const int sp = 2 * radius + 2;
  for (int s = lane; s < sp * sp; s += 32) {
    dsup[s] = dsup_at(gl, radius, w, s / sp, s % sp, h2, w2, scale);  // row u (y), column v (x)
  }
}

// Write the 8 fp32 values of fst_load8's layout into a row of float / bf16.
template <bool VEC>
__device__ __forceinline__ void store8(float* __restrict__ row, int chunk, int lane, int C,
                                       const float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(row + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      if (c < C) row[c] = v[i];
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ row, int chunk, int lane,
                                       int C, const float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      uint4 raw;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(row + c) = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      if (c < C) row[c] = __float2bfloat16(v[i]);
    }
  }
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

// K8: one warp per query, all levels. d_f1 [B*Q, C] in TIn.
template <typename TIn, typename TG, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    bwd_df1_kernel(Levels lv, int levels, const float* __restrict__ coords,
                   const TG* __restrict__ g, TIn* __restrict__ d_f1, int bq, int q_per_b, int C,
                   int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;  // the whole warp leaves together
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  float* dsup = smem + (long)warp * levels * ns;
  const long b = q / q_per_b;
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const float scale = 1.f / sqrtf((float)C);
  for (int l = 0; l < levels; ++l) {
    const float s = 1.0f / (float)(1 << l);
    const Window w = window_at(cx * s, cy * s, radius, lv.h2[l], lv.w2[l]);
    support_cotangent(g + q * (long)levels * k2 + l * k2, radius, w, lv.h2[l], lv.w2[l], scale,
                      dsup + l * ns, lane);
  }
  __syncwarp();
  const int nchunks = (C + 255) / 256;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int l = 0; l < levels; ++l) {
      const int h2 = lv.h2[l];
      const int w2 = lv.w2[l];
      const float s = 1.0f / (float)(1 << l);
      const Window w = window_at(cx * s, cy * s, radius, h2, w2);
      const TIn* f2b = static_cast<const TIn*>(lv.p[l]) + b * (long)h2 * w2 * C;
      const float* ds = dsup + l * ns;
      int u = 0;
      int v = 0;
      for (int t = 0; t < ns; ++t) {
        const float d = ds[t];  // the same slot on every lane: a broadcast
        const int y = w.by + u;
        const int x = w.bx + v;
        v = v + 1 == sp ? 0 : v + 1;
        u += v == 0;
        if (d != 0.f) {  // taps outside the map hold 0
          float f[8];
          fst_load8<VEC>(f2b + ((long)y * w2 + x) * C, chunk, lane, C, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(d, f[i], acc[i]);
        }
      }
    }
    store8<VEC>(d_f1 + q * C, chunk, lane, C, acc);
  }
}

// ---- K9 ----

constexpr int kTileY = 8;          // a block's queries: kTileY x kTileX neighbours of one sample
constexpr int kTileX = 8;
constexpr int kBoxChunk = 64;      // box taps per contraction pass: 8 per warp
constexpr int kMaxBoxTaps = 1024;  // larger boxes take the per-query body
constexpr int kChunkC = 256;       // channels of f1 staged at a time
constexpr int kThreads = kWarps * 32;

// The queries of one sample as a qh x qw grid: the level-0 map when it holds
// q_per_b queries (f1 and f2 come from one feature-map size), else one row;
// cut into tiles_y x tiles_x tiles, the last ones ragged.
struct QueryGrid {
  int qh, qw, tiles_y, tiles_x;
};

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(const __nv_bfloat16* p, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline int support_size(int radius) { return (2 * radius + 2) * (2 * radius + 2); }

template <typename TIn, typename TG, bool VEC>
cudaError_t launch_df1(const Levels& lv, int levels, const float* coords, const void* g,
                       void* d_f1, int bq, int q_per_b, int C, int radius, cudaStream_t s) {
  const int blocks = (bq + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * levels * support_size(radius) * sizeof(float);
  bwd_df1_kernel<TIn, TG, VEC><<<blocks, kWarps * 32, smem, s>>>(
      lv, levels, coords, static_cast<const TG*>(g), static_cast<TIn*>(d_f1), bq, q_per_b, C,
      radius);
  return cudaGetLastError();
}

template <int TY, int TX>
QueryGrid query_grid(int q_per_b, int h0, int w0) {
  QueryGrid grid;
  grid.qh = (long)h0 * w0 == q_per_b ? h0 : 1;
  grid.qw = (long)h0 * w0 == q_per_b ? w0 : q_per_b;
  grid.tiles_y = (grid.qh + TY - 1) / TY;
  grid.tiles_x = (grid.qw + TX - 1) / TX;
  return grid;
}

// Opt a kernel into `bytes` of dynamic shared memory; refuses (before any
// launch) a size beyond what the card gives a block.
inline cudaError_t allow_smem(const void* kernel, long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

bool valid_args(int levels, int bq, int q_per_b, int C, int radius, size_t smem) {
  return levels >= 1 && levels <= kMaxLevels && bq >= 1 && q_per_b >= 1 && C >= 1 &&
         radius >= 0 && smem <= 48 * 1024;
}

}  // namespace

extern "C" {

int fst_corr_fused_bwd_df1(void* const* f2, const int* h2, const int* w2, int levels,
                           const void* coords, const void* g, void* d_f1, int bq, int q_per_b,
                           int C, int radius, int in_dtype, int g_dtype, void* stream) {
  const size_t smem = (size_t)kWarps * levels * support_size(radius) * sizeof(float);
  if (!valid_args(levels, bq, q_per_b, C, radius, smem)) return (int)cudaErrorInvalidValue;
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
  // shared memory is checked against the card's limit at the launch
  if (!valid_args(levels, bq, q_per_b, C, radius, 0) || bq % q_per_b != 0 || radius > 4096) {
    return (int)cudaErrorInvalidValue;
  }
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
