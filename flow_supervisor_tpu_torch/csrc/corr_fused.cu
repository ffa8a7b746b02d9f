// Volume-free correlation-pyramid lookup from the feature-map factors.
//
// Replaces flow_supervisor_tpu/kernels/corr_fused.py `_fused_all_kernel` (K6:
// all levels in one launch, the B=1 path of `_lookup_impl`) and
// `_fused_level_kernel` (K7: one level per launch, the B>1 path). Nothing of
// size [B*Q, h2, w2] exists: for each query q and level l, the kernel computes
// only the (2r+2)^2 correlations <f1[q], f2_l[b, y, x]> / sqrt(C) at the
// support of the window centred at coords[q] / 2^l, in fp32, then writes the
// (2r+1)^2 bilinear samples at channel l*(2r+1)^2 + dx*(2r+1) + dy (dx-major,
// level-major stripes of one [BQ, L*(2r+1)^2] output). Support taps outside
// [0, h2) x [0, w2) contribute 0. The correlation is not rounded to the
// compute dtype before the combine; the output is written in the compute dtype.
//
// The window base is clamped to [-(2r+2), dim] in float before it becomes an
// integer (tiles.cuh `window_at`): coords far out of bounds cannot overflow,
// and a clamped window lies wholly outside the map, so it reads 0.
//
// What bounds it on an H100: the unique bytes (f1, the pooled f2, the
// output: 13 MB at 448x1024 B=1 bf16) bound it at a few microseconds a call,
// and the dot products (2*C flops per support tap) are far below the tensor
// cores' rate. The TPU kernel recomputed a whole [TQ, h2, w2] slab per query
// tile with MXU dots because Mosaic cannot gather. The first design here
// gathered instead, one warp per query, each query reading its own 100
// support rows of C values: 2.9 GB of rows per level-0 launch at 448x1024
// B=8, where the unique bytes are about 30 MB, and 23.26 ms per B=8 forward
// on an NVIDIA H100 80GB HBM3 at 700 W (3 % of its bound). Neighbouring
// queries' supports overlap, so now a block takes a kTileY x kTileX tile of
// neighbouring queries of one sample at one level (the tiles of K9 in
// corr_fused_bwd.cu), finds the bounding box of their valid support taps
// (clipped to the map), and per 256-channel chunk takes the dense product
// S = f1_tile . f2_box^T pass by pass of kPassTaps box taps:
// - bf16 inputs with C % 8 == 0: on the tensor cores (mma.sync m16n8k16,
//   fp32 accumulators; bf16 x bf16 products are exact in fp32, so only the
//   order of the sums changes); the tile's f1 rows go through shared memory
//   into registers once a chunk, and the box's rows stream by cp.async
//   through two buffers, the next pass loading while the current one's
//   product runs;
// - otherwise on the CUDA cores in fp32, 128 channels a chunk.
// Each query takes the S values of its own support taps into its (2r+2)^2
// support in shared memory (zero where a tap is outside the map); then the
// block writes every query's (2r+1)^2 bilinear outputs. That reads each f2
// row about (17 / 8)^2 = 4.5 times a level-0 launch instead of 100 times:
// 3.77 ms per B=8 forward on the same card (python3 chip_smoke.py), of
// which, by python -m flow_supervisor_tpu_torch.probe_k7, the row staging
// is about 60 % at level 0 (L2 traffic), the adds into the supports 25 %,
// the mma.sync 3 %. A tile whose box exceeds kMaxBoxTaps (coords that scatter
// the tile's windows) takes the first design's per-query body
// (`lookup_level`, a warp per query), so any coords stay correct at a
// bounded cost per block. K6 launches one block per (level, sample, tile),
// K7 one per (sample, tile) of its level. The queries' grid is (h1, w1) when
// it holds the Q queries of a sample, else one row.
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tiles.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPassTaps = 64;              // box taps per contraction pass
constexpr int kTcChunkC = 256;             // channels staged at a time, tensor cores (bf16)
constexpr int kTcStride = kTcChunkC + 8;   // bf16 a staged row; ldmatrix's 8 rows on distinct banks
constexpr int kCcChunkC = 128;             // the same for the CUDA cores (fp32)
constexpr int kCcStride = kCcChunkC + 4;   // floats a staged row
constexpr int kOutside = -(1 << 30);       // window base of a query with no valid tap

struct Levels {
  const void* f2[kMaxLevels];  // [B, h2, w2, C] pooled target features
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// Support slots per warp: (2r+2)^2 rounded up to whole groups of 32.
__host__ __device__ inline int support_slots(int radius) {
  const int sp = 2 * radius + 2;
  return (sp * sp + 31) / 32 * 32;
}

// One step of the warp's butterfly reduce-scatter of p[0, 2W): a lane keeps
// the half of its slots selected by bit W of its lane id, in p[0, W), and
// adds the partner's copy of that half. After the steps 16, 8, 4, 2, 1,
// p[0] on lane L is the warp's sum of slot L. W is a template argument so
// that every index is static and p stays in registers.
template <int W>
__device__ __forceinline__ void reduce_scatter(float* p, int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? p[i] : p[i + W];
    const float keep = upper ? p[i + W] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// The per-query body: one query at one level, by one warp. Each lane holds 8
// channels of f1[q] (one 16-byte load per lane for bf16, so a C=256 bf16 row
// of f2 is one coalesced 512-byte read), the warp accumulates 32 support dots
// in registers, and a butterfly reduce-scatter (31 shuffles for 32 dots)
// leaves dot s on lane s. Channels not a multiple of 8 take a scalar path
// (lane + 32*i), and C > 256 loops over 256-channel chunks. f1q: the query's
// feature row; f2b: the sample's [h2, w2, C] map; (cx, cy): coords at this
// level's scale; sup: the warp's support_slots(radius) floats of shared
// memory; outq + ch0: where the (2r+1)^2 outputs go.
template <typename TIn, typename TOut, bool VEC>
__device__ void lookup_level(const TIn* __restrict__ f1q, const TIn* __restrict__ f2b, int h2,
                             int w2, int C, float cx, float cy, int radius, float* sup,
                             TOut* __restrict__ outq, int ch0, int lane) {
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k = 2 * radius + 1;
  const Window w = window_at(cx, cy, radius, h2, w2);
  const int nchunks = (C + 255) / 256;
  const float root_c = sqrtf((float)C);

  for (int g = 0; g < ns; g += 32) {
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      float a[8];
      fst_load8<VEC>(f1q, chunk, lane, C, a);
      // slot g + j is support row u, column v, stepped without a division
      int u = g / sp;
      int v = g % sp;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int y = w.by + u;
        const int x = w.bx + v;
        // warp-uniform: every lane has the same slot
        const bool valid = u < sp && y >= 0 && y < h2 && x >= 0 && x < w2;
        v = v + 1 == sp ? 0 : v + 1;
        u += v == 0;
        if (valid) {
          float b[8];
          fst_load8<VEC>(f2b + ((long)y * w2 + x) * C, chunk, lane, C, b);
          float d = p[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(a[i], b[i], d);
          p[j] = d;
        }
      }
    }
    reduce_scatter<16>(p, lane);
    reduce_scatter<8>(p, lane);
    reduce_scatter<4>(p, lane);
    reduce_scatter<2>(p, lane);
    reduce_scatter<1>(p, lane);
    if (g + lane < ns) sup[g + lane] = p[0] / root_c;
  }
  __syncwarp();
  for (int o = lane; o < k * k; o += 32) {
    const int ix = o / k;  // dx index (major)
    const int iy = o % k;  // dy index (minor)
    const float* r0 = sup + iy * sp + ix;
    const float v = (1.f - w.fy) * (1.f - w.fx) * r0[0] + (1.f - w.fy) * w.fx * r0[1] +
                    w.fy * (1.f - w.fx) * r0[sp] + w.fy * w.fx * r0[sp + 1];
    fst_store(outq, ch0 + o, v);
  }
  __syncwarp();  // the caller reuses sup
}

// ---- the tile design ----

// A block's tile at one level: level l, sample b, the level's map f2 (all
// samples), the number of queries with a valid tap and the box [x0, x0 + bw)
// x [y0, y0 + bh) of their valid taps (inv_bw = 1 / bw).
struct Tile {
  const void* f2;
  int l, b, h2, w2, nvalid, x0, y0, bw, bh;
  float inv_bw;
};

// Box tap a (row-major in the box, a < kMaxBoxTaps) -> its map row y and
// column x. floor((a + 0.5) / bw) by a float reciprocal is exact here: its
// error (below 2^-22 of a / bw) is far from the distance 0.5 / bw of
// (a + 0.5) / bw to the next integer.
__device__ __forceinline__ void box_tap(const Tile& t, int a, int& y, int& x) {
  const int r = (int)(((float)a + 0.5f) * t.inv_bw);
  y = t.y0 + r;
  x = t.x0 + a - r * t.bw;
}

// Shared memory of a tile of TQ queries after the operands: the support S
// [TQ, (2r+2)^2] (fp32 sums; / sqrt(C) after the last chunk), then per query its row in
// f1 (-1 outside the grid), window base (kOutside without a valid tap) and
// fractional part, then 5 reduction slots per query warp.
struct TileSmem {
  float* sup;
  int* qrow;
  int* qbx;
  int* qby;
  float* qfx;
  float* qfy;
  int* wstat;
};

__host__ __device__ inline long tile_operand_words(int tq, bool tc) {
  return tc ? (long)(tq + kPassTaps) * kTcStride / 2 : (long)(tq + kPassTaps) * kCcStride;
}

__host__ __device__ inline long tile_smem_words(int tq, bool tc, int radius) {
  const long sp = 2L * radius + 2;
  return tile_operand_words(tq, tc) + tq * (sp * sp + 5) + (tq / 32) * 5;
}

template <int TQ>
__device__ inline TileSmem tile_smem(float* base, int ns) {
  TileSmem ts;
  ts.sup = base;
  ts.qrow = reinterpret_cast<int*>(base + TQ * ns);
  ts.qbx = ts.qrow + TQ;
  ts.qby = ts.qbx + TQ;
  ts.qfx = reinterpret_cast<float*>(ts.qby + TQ);
  ts.qfy = ts.qfx + TQ;
  ts.wstat = reinterpret_cast<int*>(ts.qfy + TQ);
  return ts;
}

// Block-wide: find this block's (level, sample, tile) (blocks level-major
// from level0, so the heavy level-0 tiles start first), each query's row and
// window, and the box of the valid taps; zero the support.
template <int TY, int TX>
__device__ Tile tile_prologue(const Levels& lv, int level0, const QueryGrid& grid, int batch,
                              const float* __restrict__ coords, int q_per_b, int radius,
                              const TileSmem& ts) {
  constexpr int TQ = TY * TX;
  constexpr int NW = TQ / 32;  // warps that hold a query each lane
  static_assert(TQ % 32 == 0 && TQ <= kThreads, "a tile is whole warps of one block");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  for (int e = tid; e < TQ * sp * sp; e += kThreads) ts.sup[e] = 0.f;
  const int tiles = grid.tiles_y * grid.tiles_x;
  const int per_level = batch * tiles;  // the launcher keeps the grid below 2^31 blocks
  const int li = (int)blockIdx.x / per_level;
  const int rem = (int)blockIdx.x - li * per_level;
  const int tile = rem % tiles;
  Tile t;
  t.l = level0 + li;
  t.b = rem / tiles;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {  // static indices: lv stays in the parameter space
    if (i == li) {
      t.f2 = lv.f2[i];
      t.h2 = lv.h2[i];
      t.w2 = lv.w2[i];
    }
  }
  const float s = 1.0f / (float)(1 << t.l);
  if (warp < NW) {
    const int qy = (tile / grid.tiles_x) * TY + tid / TX;
    const int qx = (tile % grid.tiles_x) * TX + tid % TX;
    int row = -1;
    Window w = {kOutside, kOutside, 0.f, 0.f};
    bool valid = false;
    int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
    if (qy < grid.qh && qx < grid.qw) {
      row = t.b * q_per_b + qy * grid.qw + qx;
      w = window_at(coords[2 * (long)row] * s, coords[2 * (long)row + 1] * s, radius, t.h2,
                    t.w2);
      const int vx0 = max(w.bx, 0), vx1 = min(w.bx + sp, t.w2);
      const int vy0 = max(w.by, 0), vy1 = min(w.by + sp, t.h2);
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
    ts.qrow[tid] = row;
    ts.qbx[tid] = w.bx;
    ts.qby[tid] = w.by;
    ts.qfx[tid] = w.fx;
    ts.qfy[tid] = w.fy;
    const unsigned mask = __ballot_sync(kFull, valid);
    x0 = __reduce_min_sync(kFull, x0);
    y0 = __reduce_min_sync(kFull, y0);
    x1 = __reduce_max_sync(kFull, x1);
    y1 = __reduce_max_sync(kFull, y1);
    if (lane == 0) {
      int* ws = ts.wstat + warp * 5;
      ws[0] = x0;
      ws[1] = y0;
      ws[2] = x1;
      ws[3] = y1;
      ws[4] = __popc(mask);
    }
  }
  __syncthreads();
  int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN, n = 0;
  for (int i = 0; i < NW; ++i) {
    const int* ws = ts.wstat + i * 5;
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
  return t;
}

// The overflow body: each warp takes the tile's queries in turn through the
// per-query body, its support in the warp's part of ts.sup.
template <typename TIn, typename TOut, bool VEC, int TQ>
__device__ void tile_per_query(const TIn* __restrict__ f1, const TIn* __restrict__ f2b,
                               const Tile& t, const TileSmem& ts, const float* __restrict__ coords,
                               TOut* __restrict__ out, int out_stride, int ch0, int C,
                               int radius) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sup = ts.sup + warp * support_slots(radius);
  const float s = 1.0f / (float)(1 << t.l);
  for (int i = warp; i < TQ; i += kWarps) {
    const long row = ts.qrow[i];
    if (row < 0) continue;  // the whole warp
    lookup_level<TIn, TOut, VEC>(f1 + row * C, f2b, t.h2, t.w2, C, coords[2 * row] * s,
                                 coords[2 * row + 1] * s, radius, sup,
                                 out + row * out_stride, ch0, lane);
  }
}

// S[query q, box tap (y, x)] into q's support (window base (bx, by)) where
// the tap lies in its window: each (query, slot) gets one add per channel
// chunk, and the last chunk's add divides the sum by sqrt(C) (root_c; 0
// before the last chunk).
__device__ __forceinline__ void add_to_support(const TileSmem& ts, int ns, int sp, int q, int bx,
                                               int by, int y, int x, float v, float root_c) {
  const int u = y - by;
  const int w = x - bx;
  if ((unsigned)u < (unsigned)sp && (unsigned)w < (unsigned)sp) {
    float* s = ts.sup + q * ns + u * sp + w;
    *s = root_c != 0.f ? (*s + v) / root_c : *s + v;
  }
}

// Stage the rows of box taps [a0, a0 + kPassTaps) of 256-channel chunk cc
// into dst [kPassTaps, kTcStride] by cp.async (zeros past the box and past C).
__device__ __forceinline__ void stage_pass(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ f2b,
                                           const Tile& t, int a0, int cc, int C) {
  const int A = t.bw * t.bh;
  const int lane = threadIdx.x % 32;
  const int c = cc * kTcChunkC + lane * 8;  // a warp stages a tap's row
  for (int j = threadIdx.x / 32; j < kPassTaps; j += kWarps) {
    const int a = a0 + j;
    const bool in = a < A && c < C;
    int y, x;
    box_tap(t, a, y, x);
    const __nv_bfloat16* src = in ? f2b + ((long)y * t.w2 + x) * C + c : f2b;
    cp_async16(dst + j * kTcStride + lane * 8, src, in ? 16 : 0);
  }
}

// The tensor-core body (bf16, C % 8 == 0, 8x8 tiles). Per 256-channel chunk
// the tile's f1 rows pass through shared memory into registers: warp w holds
// the A fragments of its m-tile of 16 queries mt = w / 2 for the whole
// chunk. Then the box's f2 rows stream through two buffers of kPassTaps rows
// by cp.async, the next pass loading while the warps take the product of the
// current one: warp w computes its 16 queries times n-tiles of 8 taps
// [32 (w % 2), 32 (w % 2) + 32) of the pass, mma.sync m16n8k16 into fp32,
// and adds each value into the support.
template <int TQ>
__device__ void tile_contract_tc(const __nv_bfloat16* __restrict__ f1,
                                 const __nv_bfloat16* __restrict__ f2b, const Tile& t,
                                 const TileSmem& ts, float* smem, int C, int radius) {
  using bf16 = __nv_bfloat16;
  constexpr int KSTEPS = kTcChunkC / 16;
  constexpr int NTW = kPassTaps / 8 / 2;  // n-tiles of 8 taps per warp
  static_assert(TQ == 64 && kWarps == 8 && TQ == kPassTaps,
                "8 warps: 4 m-tiles of 16 queries x 2 halves of the pass; f1 and a pass fill one buffer");
  bf16* const buf[2] = {reinterpret_cast<bf16*>(smem) + TQ * kTcStride, reinterpret_cast<bf16*>(smem)};
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int A = t.bw * t.bh;
  const int passes = (A + kPassTaps - 1) / kPassTaps;
  const int mt = warp / 2;
  const int n0 = (warp % 2) * NTW * 8;
  const int qa = mt * 16 + lane / 4;  // the lane's accumulator rows qa and qa + 8
  const int bxa = ts.qbx[qa], bya = ts.qby[qa], bxb = ts.qbx[qa + 8], byb = ts.qby[qa + 8];
  const int nchunks = (C + kTcChunkC - 1) / kTcChunkC;
  for (int cc = 0; cc < nchunks; ++cc) {
    const float root_c = cc + 1 == nchunks ? sqrtf((float)C) : 0.f;
    const int ksteps = (min(kTcChunkC, C - cc * kTcChunkC) + 15) / 16;
    // f1's chunk into buf[1] (a warp stages a query's row), the first pass into buf[0]
    const int c = cc * kTcChunkC + lane * 8;
    for (int r = warp; r < TQ; r += kWarps) {
      const long row = ts.qrow[r];
      const bool in = row >= 0 && c < C;
      cp_async16(buf[1] + r * kTcStride + lane * 8, in ? f1 + row * C + c : f1, in ? 16 : 0);
    }
    stage_pass(buf[0], f2b, t, 0, cc, C);
    cp_async_wait_all();
    __syncthreads();
    unsigned af[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks < ksteps) ldsm_x4(buf[1] + (mt * 16 + lane % 16) * kTcStride + ks * 16 + (lane / 16) * 8, af[ks]);
    }
    __syncthreads();  // buf[1] takes the second pass
    for (int p = 0; p < passes; ++p) {
      if (p + 1 < passes) {
        stage_pass(buf[(p + 1) % 2], f2b, t, (p + 1) * kPassTaps, cc, C);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* cur = buf[p % 2];
      float acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if (ks < ksteps) {
          unsigned bf[NTW / 2][4];  // b0, b1 of n-tiles 2j and 2j + 1: the pass's rows are B's columns
#pragma unroll
          for (int j = 0; j < NTW / 2; ++j) {
            ldsm_x4(cur + (n0 + j * 16 + (lane / 16) * 8 + lane % 8) * kTcStride + ks * 16 +
                        ((lane / 8) % 2) * 8,
                    bf[j]);
          }
#pragma unroll
          for (int j = 0; j < NTW / 2; ++j) {
            mma_bf16(acc[2 * j], af[ks], bf[j][0], bf[j][1]);
            mma_bf16(acc[2 * j + 1], af[ks], bf[j][2], bf[j][3]);
          }
        }
      }
      // acc[nt] holds (query qa, taps n0 + 8 nt + 2 (lane % 4) + {0, 1}) and
      // the same for query qa + 8
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = p * kPassTaps + n0 + nt * 8 + 2 * (lane % 4) + h;
          if (a < A) {
            int y, x;
            box_tap(t, a, y, x);
            add_to_support(ts, ns, sp, qa, bxa, bya, y, x, acc[nt][h], root_c);
            add_to_support(ts, ns, sp, qa + 8, bxb, byb, y, x, acc[nt][2 + h], root_c);
          }
        }
      }
      __syncthreads();  // buf[p % 2] takes pass p + 2 (or the next chunk's f1)
    }
  }
}

// 4 channels [c, c + 4) of a row as fp32, zero past C; VEC: C % 8 == 0 and
// 16-byte aligned rows (c is a multiple of 4).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int C) {
  if (VEC) return c < C ? *reinterpret_cast<const float4*>(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < C ? row[c + i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ row, int c, int C) {
  if (VEC) {
    if (c >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
    const uint2 raw = *reinterpret_cast<const uint2*>(row + c);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < C ? __bfloat162float(row[c + i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The CUDA-core body, fp32. Per 128-channel chunk f1s [TQ, 128]; per pass
// f2s [kPassTaps, 128]; a thread computes queries tq + 16 i (i < TQ / 16)
// times taps ta + 16 j (j < 4) from float4 reads (the strided rows keep a
// quarter warp's reads on distinct banks).
template <typename TIn, bool VEC, int TQ>
__device__ void tile_contract(const TIn* __restrict__ f1, const TIn* __restrict__ f2b,
                              const Tile& t, const TileSmem& ts, float* smem, int C, int radius) {
  constexpr int QT = TQ / 16;  // queries per thread
  float* f1s = smem;
  float* f2s = smem + TQ * kCcStride;
  const int tid = threadIdx.x;
  const int tq = tid / 16;
  const int ta = tid % 16;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int A = t.bw * t.bh;
  const int nchunks = (C + kCcChunkC - 1) / kCcChunkC;
  for (int cc = 0; cc < nchunks; ++cc) {
    const float root_c = cc + 1 == nchunks ? sqrtf((float)C) : 0.f;
    for (int e = tid; e < TQ * 32; e += kThreads) {
      const int r = e / 32;
      const long row = ts.qrow[r];
      const int c = cc * kCcChunkC + (e % 32) * 4;
      *reinterpret_cast<float4*>(f1s + r * kCcStride + (e % 32) * 4) =
          row >= 0 ? load4<VEC>(f1 + row * C, c, C) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int kn = min(kCcChunkC, C - cc * kCcChunkC);
    for (int a0 = 0; a0 < A; a0 += kPassTaps) {
      for (int e = tid; e < kPassTaps * 32; e += kThreads) {
        const int a = a0 + e / 32;
        const int c = cc * kCcChunkC + (e % 32) * 4;
        int y, x;
        box_tap(t, a, y, x);
        *reinterpret_cast<float4*>(f2s + (e / 32) * kCcStride + (e % 32) * 4) =
            a < A ? load4<VEC>(f2b + ((long)y * t.w2 + x) * C, c, C) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      float acc[QT][4];
#pragma unroll
      for (int i = 0; i < QT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int k = 0; k < kn; k += 4) {
        float4 fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fb[j] = *reinterpret_cast<const float4*>(f2s + (ta + 16 * j) * kCcStride + k);
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const float4 fa = *reinterpret_cast<const float4*>(f1s + (tq + 16 * i) * kCcStride + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(fa.x, fb[j].x, acc[i][j]);
            acc[i][j] = fmaf(fa.y, fb[j].y, acc[i][j]);
            acc[i][j] = fmaf(fa.z, fb[j].z, acc[i][j]);
            acc[i][j] = fmaf(fa.w, fb[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = a0 + ta + 16 * j;
        if (a < A) {
          int y, x;
          box_tap(t, a, y, x);
#pragma unroll
          for (int i = 0; i < QT; ++i) {
            const int q = tq + 16 * i;
            add_to_support(ts, ns, sp, q, ts.qbx[q], ts.qby[q], y, x, acc[i][j], root_c);
          }
        }
      }
      __syncthreads();  // f2s (and after the last pass f1s) is rewritten next
    }
  }
}

// Every query of the tile: its (2r+1)^2 bilinear outputs from its support.
// Warp w takes queries w, w + kWarps, ...; lane i output o = o0 + i.
template <typename TOut, int TQ>
__device__ void tile_combine(const TileSmem& ts, TOut* __restrict__ out, int out_stride, int ch0,
                             int radius) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k = 2 * radius + 1;
  for (int o = lane; o < k * k; o += 32) {
    const int ix = o / k;  // dx index (major)
    const int iy = o % k;  // dy index (minor)
    for (int q = warp; q < TQ; q += kWarps) {
      const long row = ts.qrow[q];
      if (row < 0) continue;
      const float* r0 = ts.sup + q * ns + iy * sp + ix;
      const float fx = ts.qfx[q];
      const float fy = ts.qfy[q];
      const float v = (1.f - fy) * (1.f - fx) * r0[0] + (1.f - fy) * fx * r0[1] +
                      fy * (1.f - fx) * r0[sp] + fy * fx * r0[sp + 1];
      fst_store(out + row * out_stride, ch0 + o, v);
    }
  }
}

// One block: a tile of TY x TX queries at one level. TC: the tensor-core
// contraction (bf16, VEC).
template <typename TIn, typename TOut, bool VEC, int TY, int TX, bool TC>
__device__ void lookup_tile(const TIn* __restrict__ f1, const Levels& lv, int level0,
                            const QueryGrid& grid, int batch, const float* __restrict__ coords,
                            TOut* __restrict__ out, int out_stride, int q_per_b, int C, int radius,
                            float* smem) {
  constexpr int TQ = TY * TX;
  const int ns = (2 * radius + 2) * (2 * radius + 2);
  const TileSmem ts = tile_smem<TQ>(smem + tile_operand_words(TQ, TC), ns);
  const Tile t = tile_prologue<TY, TX>(lv, level0, grid, batch, coords, q_per_b, radius, ts);
  const TIn* f2b = static_cast<const TIn*>(t.f2) + (long)t.b * t.h2 * t.w2 * C;
  const int ch0 = t.l * (2 * radius + 1) * (2 * radius + 1);
  if (t.nvalid > 0 && t.bw * t.bh > kMaxBoxTaps) {
    tile_per_query<TIn, TOut, VEC, TQ>(f1, f2b, t, ts, coords, out, out_stride, ch0, C, radius);
    return;
  }
  if (t.nvalid > 0) {  // else every query reads 0
    if constexpr (TC) {
      static_assert(VEC && std::is_same<TIn, __nv_bfloat16>::value, "tensor cores take bf16");
      tile_contract_tc<TQ>(f1, f2b, t, ts, smem, C, radius);
    } else {
      tile_contract<TIn, VEC, TQ>(f1, f2b, t, ts, smem, C, radius);
    }
  }
  __syncthreads();
  tile_combine<TOut, TQ>(ts, out, out_stride, ch0, radius);
}

// K6: one block per (level, sample, tile), all levels; lv holds every level.
template <typename TIn, typename TOut, bool VEC, int TY, int TX, bool TC>
__global__ void __launch_bounds__(kThreads, 2)
    corr_fused_all_kernel(const TIn* __restrict__ f1, Levels lv, int level0, QueryGrid grid,
                          int batch, const float* __restrict__ coords, TOut* __restrict__ out,
                          int out_stride, int q_per_b, int C, int radius) {
  extern __shared__ __align__(16) float smem[];
  lookup_tile<TIn, TOut, VEC, TY, TX, TC>(f1, lv, level0, grid, batch, coords, out, out_stride,
                                          q_per_b, C, radius, smem);
}

// K7: one block per (sample, tile) of level level0, whose map is lv's only
// entry; writes channels [level0 * k^2, (level0 + 1) * k^2) of rows of
// out_stride values.
template <typename TIn, typename TOut, bool VEC, int TY, int TX, bool TC>
__global__ void __launch_bounds__(kThreads, 2)
    corr_fused_level_kernel(const TIn* __restrict__ f1, Levels lv, int level0, QueryGrid grid,
                            int batch, const float* __restrict__ coords, TOut* __restrict__ out,
                            int out_stride, int q_per_b, int C, int radius) {
  extern __shared__ __align__(16) float smem[];
  lookup_tile<TIn, TOut, VEC, TY, TX, TC>(f1, lv, level0, grid, batch, coords, out, out_stride,
                                          q_per_b, C, radius, smem);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// K6 (all) or K7 over the nlev levels of lv, from level level0; bf16 with
// VEC takes the tensor-core body unless TENSOR_CORES is false.
template <typename TIn, typename TOut, bool VEC, int TY = kTileY, int TX = kTileX,
          bool TENSOR_CORES = true>
cudaError_t launch_tiles(bool all, const void* f1, const Levels& lv, int nlev, int level0,
                         int h1, int w1, const float* coords, void* out, int out_stride, int bq,
                         int q_per_b, int C, int radius, cudaStream_t s) {
  constexpr bool tc = TENSOR_CORES && std::is_same<TIn, __nv_bfloat16>::value && VEC;
  const QueryGrid grid = query_grid<TY, TX>(q_per_b, h1, w1);
  const int batch = bq / q_per_b;
  const long blocks = (long)nlev * batch * grid.tiles_y * grid.tiles_x;
  const long smem = tile_smem_words(TY * TX, tc, radius) * (long)sizeof(float);
  auto kernel = all ? corr_fused_all_kernel<TIn, TOut, VEC, TY, TX, tc>
                    : corr_fused_level_kernel<TIn, TOut, VEC, TY, TX, tc>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(static_cast<const TIn*>(f1), lv, level0, grid,
                                                  batch, coords, static_cast<TOut*>(out),
                                                  out_stride, q_per_b, C, radius);
  return cudaGetLastError();
}

// LAUNCH<TIn, TOut, VEC>(args...) for the runtime dtype codes and `vec`
#define FST_DISPATCH(LAUNCH, ...)                                                     \
  do {                                                                                \
    if (in_dtype == FST_F32 && out_dtype == FST_F32)                                  \
      return (int)(vec ? LAUNCH<float, float, true>(__VA_ARGS__)                      \
                       : LAUNCH<float, float, false>(__VA_ARGS__));                   \
    if (in_dtype == FST_F32 && out_dtype == FST_BF16)                                 \
      return (int)(vec ? LAUNCH<float, __nv_bfloat16, true>(__VA_ARGS__)              \
                       : LAUNCH<float, __nv_bfloat16, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && out_dtype == FST_F32)                                 \
      return (int)(vec ? LAUNCH<__nv_bfloat16, float, true>(__VA_ARGS__)              \
                       : LAUNCH<__nv_bfloat16, float, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && out_dtype == FST_BF16)                                \
      return (int)(vec ? LAUNCH<__nv_bfloat16, __nv_bfloat16, true>(__VA_ARGS__)      \
                       : LAUNCH<__nv_bfloat16, __nv_bfloat16, false>(__VA_ARGS__));   \
    return (int)cudaErrorInvalidValue;                                                \
  } while (0)

bool valid_args(int bq, int q_per_b, int h1, int w1, int C, int radius) {
  // shared memory is checked against the card's limit at the launch
  return bq >= 1 && q_per_b >= 1 && bq % q_per_b == 0 && h1 >= 1 && w1 >= 1 && C >= 1 &&
         radius >= 0 && radius <= 4096;
}

}  // namespace

extern "C" {

int fst_corr_fused_all(const void* f1, const void* const* f2, const int* h2, const int* w2,
                       int levels, int h1, int w1, const void* coords, void* out, int bq,
                       int q_per_b, int C, int radius, int in_dtype, int out_dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || !valid_args(bq, q_per_b, h1, w1, C, radius))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  bool vec = C % 8 == 0 && aligned16(f1);
  for (int l = 0; l < levels; ++l) {
    lv.f2[l] = f2[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
    vec = vec && aligned16(f2[l]);
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  FST_DISPATCH(launch_tiles, true, f1, lv, levels, 0, h1, w1, c, out, levels * k2, bq, q_per_b,
               C, radius, s);
}

int fst_corr_fused_level(const void* f1, const void* f2, int h2, int w2, int level, int h1,
                         int w1, const void* coords, void* out, int out_stride, int bq,
                         int q_per_b, int C, int radius, int in_dtype, int out_dtype,
                         void* stream) {
  if (level < 0 || level >= kMaxLevels || !valid_args(bq, q_per_b, h1, w1, C, radius) ||
      out_stride < (level + 1) * (2 * radius + 1) * (2 * radius + 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.f2[0] = f2;
  lv.h2[0] = h2;
  lv.w2[0] = w2;
  const bool vec = C % 8 == 0 && aligned16(f1) && aligned16(f2);
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  FST_DISPATCH(launch_tiles, false, f1, lv, 1, level, h1, w1, c, out, out_stride, bq, q_per_b, C,
               radius, s);
}

}  // extern "C"
