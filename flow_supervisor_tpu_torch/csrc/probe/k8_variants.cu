// Variants of K8 (csrc/corr_fused_bwd.cu) for the A/B timing of
// flow_supervisor_tpu_torch/probe_k8.py; not part of the kernel library.
// Each runs over levels [level0, level1), so that levels time alone. bf16
// (C % 8 == 0) unless noted.
//
//   0  the first K8: one warp per query, all levels; every nonzero support
//      tap's row of f2 read per query
//   1  layout A: a block per (sample, 8x8 tile, slice of 256 channels),
//      levels in order, D . f2_box on the tensor cores into fp32 registers
//      held across the levels (the library's)
//   2  1 with slices of 128 channels
//   3  1 with slices of 64 channels
//   4  layout B: a block per (level, sample, tile, 256 channels) writes its
//      fp32 sums into scratch [L, B*Q, C]; a second kernel sums the levels
//      in order and casts
//   5  1 on the CUDA cores (fp32 sums, 128 channels a block; the library's
//      body for fp32 and C % 8 != 0)
//   6  diagnostic: 1 without the mma.sync
//   7  diagnostic: 1 without the D build
//   8  diagnostic: 1 without the staging of the box rows
//   9  diagnostic: 1 with none of the three (the level prologues: windows,
//      box, d_sup; and the store)
//  10  1 with D's low part zeroed: D as bf16 alone (a right sum to about 8
//      bits, which must fail the one-ulp check)
#include <stdint.h>

#include "../corr_fused_bwd.cu"

namespace k8probe {

using bf16 = __nv_bfloat16;

// ---- 0: the first K8 ----

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
__device__ __forceinline__ void store8(bf16* __restrict__ row, int chunk, int lane, int C,
                                       const float v[8]) {
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

template <typename TIn, typename TG>
__global__ void __launch_bounds__(kWarps * 32)
    first_df1_kernel(Levels lv, int levels, int level0, int level1,
                     const float* __restrict__ coords, const TG* __restrict__ g,
                     TIn* __restrict__ d_f1, int bq, int q_per_b, int C, int radius) {
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
  for (int l = level0; l < level1; ++l) {
    const float s = 1.0f / (float)(1 << l);
    const Window w = window_at(cx * s, cy * s, radius, lv.h2[l], lv.w2[l]);
    const TG* gl = g + q * (long)levels * k2 + l * k2;
    for (int e = lane; e < ns; e += 32) {
      dsup[l * ns + e] = dsup_at(gl, radius, w, e / sp, e % sp, lv.h2[l], lv.w2[l], scale);
    }
  }
  __syncwarp();
  const int nchunks = (C + 255) / 256;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int l = level0; l < level1; ++l) {
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
          fst_load8<true>(f2b + ((long)y * w2 + x) * C, chunk, lane, C, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(d, f[i], acc[i]);
        }
      }
    }
    store8<true>(d_f1 + q * C, chunk, lane, C, acc);
  }
}

// ---- 1-10: the tile design's layouts, slices and diagnostics ----

// SKIP bits of skip_contract_tc
constexpr int kSkipStage = 1, kSkipD = 2, kSkipMma = 4, kSkipLow = 8;

// df1_contract_tc with the parts in SKIP left out (kSkipLow: D's low part
// zeroed after its build)
template <int W, int SKIP>
__device__ __forceinline__ void skip_contract_tc(const bf16* __restrict__ f2b, const Df1Level& t,
                                                 const Df1Smem& sm, int c0, int C, int radius,
                                                 int ds, float* ops, float* acc) {
  bf16* const buf[2] = {reinterpret_cast<bf16*>(ops),
                        reinterpret_cast<bf16*>(ops) + kBoxChunk * (W + 8)};
  bf16* const dh = buf[1] + kBoxChunk * (W + 8);
  bf16* const dl = dh + kTileQ * kDStride;
  const int A = t.bw * t.bh;
  const int passes = (A + kBoxChunk - 1) / kBoxChunk;
  if (!(SKIP & kSkipStage)) df1_stage<W>(buf[0], f2b, t, 0, c0, C);
  cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    const int a0 = p * kBoxChunk;
    if (p + 1 < passes) {
      if (!(SKIP & kSkipStage)) df1_stage<W>(buf[(p + 1) % 2], f2b, t, a0 + kBoxChunk, c0, C);
      cp_async_commit();
    }
    if (!(SKIP & kSkipD)) df1_build_d(t, sm, a0, radius, ds, dh, dl);
    if (SKIP & kSkipLow) {  // the 16 taps df1_build_d wrote for this thread
      uint4* pl = reinterpret_cast<uint4*>(dl + (threadIdx.x / 4) * kDStride + (threadIdx.x % 4) * 16);
      pl[0] = pl[1] = make_uint4(0, 0, 0, 0);
    }
    if (p + 1 < passes) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!(SKIP & kSkipMma)) df1_mma<W>(buf[p % 2], dh, dl, min(kBoxChunk, (A - a0 + 15) & ~15), acc);
    __syncthreads();
  }
}

// df1_tile on the tensor cores (bf16) with skip_contract_tc
template <typename TG, int W, int SKIP>
__device__ __forceinline__ void skip_tile(const Levels& lv, int levels, int level0, int level1,
                                          const QueryGrid& grid, int b, int tile,
                                          const float* __restrict__ coords,
                                          const TG* __restrict__ g, int q_per_b, int c0, int C,
                                          int radius, float* smem, const Df1Smem& sm, float* acc) {
  const int tid = threadIdx.x;
  const int ds = dsup_stride(radius);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) acc[i] = 0.f;
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
    for (int i = 0; i < kMaxLevels; ++i) {
      if (i == l) {
        f2 = lv.p[i];
        h2 = lv.h2[i];
        w2 = lv.w2[i];
      }
    }
    const Df1Level t = df1_level(sm, l, levels, h2, w2, row, cx, cy, g, C, radius, ds);
    if (t.nvalid == 0) continue;
    const bf16* f2b = static_cast<const bf16*>(f2) + (long)b * h2 * w2 * C;
    if (t.bw * t.bh > kMaxBoxTaps) {
      df1_per_query<bf16, true, W, W + 8>(f2b, t, sm, c0, C, radius, ds, smem);
      __syncthreads();
      df1_add_sums<W, true>(smem, acc);
      __syncthreads();
    } else {
      skip_contract_tc<W, SKIP>(f2b, t, sm, c0, C, radius, ds, smem, acc);
    }
  }
}

// Layout A over levels [level0, level1): a block per (sample, tile, W
// channels), as the library's bwd_df1_kernel; SKIP (bf16 on the tensor
// cores only) takes skip_tile.
template <typename TIn, typename TG, int W, bool TC, int SKIP>
__global__ void __launch_bounds__(kThreads, W <= 64 ? 3 : 2)
    probe_df1_kernel(Levels lv, int levels, int level0, int level1, QueryGrid grid, int slices,
                     const float* __restrict__ coords, const TG* __restrict__ g,
                     TIn* __restrict__ d_f1, int q_per_b, int C, int radius) {
  extern __shared__ __align__(16) float smem[];
  const Df1Smem sm = df1_smem(smem + df1_operand_words(W, TC), dsup_stride(radius));
  const int tiles = grid.tiles_y * grid.tiles_x;
  const int b = (int)blockIdx.x / (tiles * slices);
  const int rem = (int)blockIdx.x - b * tiles * slices;
  const int tile = rem / slices;
  const int c0 = (rem - tile * slices) * W;
  float acc[TC ? W / 4 : 32];
  if constexpr (SKIP == 0) {
    df1_tile<TIn, TG, true, W, TC>(lv, levels, level0, level1, grid, b, tile, coords, g, q_per_b,
                                   c0, C, radius, smem, sm, acc);
  } else {
    static_assert(TC && std::is_same<TIn, bf16>::value, "the diagnostics take bf16 tensor cores");
    skip_tile<TG, W, SKIP>(lv, levels, level0, level1, grid, b, tile, coords, g, q_per_b, c0, C,
                           radius, smem, sm, acc);
  }
  df1_store<TIn, true, W, TC>(sm, acc, d_f1, c0, C);
}

// Layout B: a block per (level, sample, tile, W channels), blocks
// level-major from level0, each writing its level's sums into scratch[l]
// [B*Q, C] fp32; then probe_sum_levels adds the levels in order.
template <typename TIn, typename TG, int W>
__global__ void __launch_bounds__(kThreads, 2)
    probe_df1_level_kernel(Levels lv, int levels, int level0, QueryGrid grid, int batch,
                           int slices, const float* __restrict__ coords,
                           const TG* __restrict__ g, float* __restrict__ scratch, int bq,
                           int q_per_b, int C, int radius) {
  extern __shared__ __align__(16) float smem[];
  const Df1Smem sm = df1_smem(smem + df1_operand_words(W, true), dsup_stride(radius));
  const int per_level = batch * grid.tiles_y * grid.tiles_x * slices;
  const int l = level0 + (int)blockIdx.x / per_level;
  const int rem = (int)blockIdx.x - (l - level0) * per_level;
  const int b = rem / (grid.tiles_y * grid.tiles_x * slices);
  const int tile = rem / slices - b * grid.tiles_y * grid.tiles_x;
  const int c0 = rem % slices * W;
  float acc[W / 4];
  df1_tile<TIn, TG, true, W, true>(lv, levels, l, l + 1, grid, b, tile, coords, g, q_per_b, c0,
                                   C, radius, smem, sm, acc);
  df1_store<float, true, W, true>(sm, acc, scratch + (long)l * bq * C, c0, C);
}

// d_f1 = the sum of scratch[level0 .. level1) in level order (fp32), in TIn
template <typename TIn>
__global__ void probe_sum_levels(const float* __restrict__ scratch, TIn* __restrict__ d_f1, long n,
                                 int level0, int level1) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int l = level0; l < level1; ++l) s += scratch[l * n + i];
  fst_store(d_f1, i, s);
}

template <typename TIn, typename TG, int W, bool TC, int SKIP>
cudaError_t launch_a(const Levels& lv, int levels, int level0, int level1, const float* coords,
                     const void* g, void* d_f1, int bq, int q_per_b, int C, int radius,
                     cudaStream_t s) {
  constexpr bool tc = TC && std::is_same<TIn, bf16>::value;
  constexpr int width = tc ? W : kCcSlice;
  const QueryGrid grid = query_grid<kTileY, kTileX>(q_per_b, lv.h2[0], lv.w2[0]);
  const int slices = (C + width - 1) / width;
  const long blocks = (long)(bq / q_per_b) * grid.tiles_y * grid.tiles_x * slices;
  const long smem = df1_smem_words(width, tc, radius) * (long)sizeof(float);
  auto kernel = probe_df1_kernel<TIn, TG, width, tc, SKIP>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(lv, levels, level0, level1, grid, slices, coords,
                                                  static_cast<const TG*>(g),
                                                  static_cast<TIn*>(d_f1), q_per_b, C, radius);
  return cudaGetLastError();
}

template <typename TIn, typename TG>
cudaError_t launch_b(const Levels& lv, int levels, int level0, int level1, const float* coords,
                     const void* g, void* d_f1, float* scratch, int bq, int q_per_b, int C,
                     int radius, cudaStream_t s) {
  if (!std::is_same<TIn, bf16>::value || scratch == nullptr) return cudaErrorInvalidValue;
  constexpr int W = 256;
  const QueryGrid grid = query_grid<kTileY, kTileX>(q_per_b, lv.h2[0], lv.w2[0]);
  const int batch = bq / q_per_b;
  const int slices = (C + W - 1) / W;
  const long blocks = (long)(level1 - level0) * batch * grid.tiles_y * grid.tiles_x * slices;
  const long smem = df1_smem_words(W, true, radius) * (long)sizeof(float);
  auto kernel = probe_df1_level_kernel<bf16, TG, W>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(lv, levels, level0, grid, batch, slices, coords,
                                                  static_cast<const TG*>(g), scratch, bq, q_per_b,
                                                  C, radius);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)bq * C;
  probe_sum_levels<TIn><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      scratch, static_cast<TIn*>(d_f1), n, level0, level1);
  return cudaGetLastError();
}

template <typename TIn, typename TG>
cudaError_t launch_variant(int variant, const Levels& lv, int levels, int level0, int level1,
                           const float* coords, const void* g, void* d_f1, float* scratch,
                           int bq, int q_per_b, int C, int radius, cudaStream_t s) {
  if (variant == 0) {
    const int blocks = (bq + kWarps - 1) / kWarps;
    const size_t smem = (size_t)kWarps * levels * (2 * radius + 2) * (2 * radius + 2) * sizeof(float);
    first_df1_kernel<TIn, TG><<<blocks, kWarps * 32, smem, s>>>(
        lv, levels, level0, level1, coords, static_cast<const TG*>(g), static_cast<TIn*>(d_f1), bq,
        q_per_b, C, radius);
    return cudaGetLastError();
  }
  if (variant == 4) {
    return launch_b<TIn, TG>(lv, levels, level0, level1, coords, g, d_f1, scratch, bq, q_per_b, C,
                             radius, s);
  }
#define K8_PROBE(W, TC, SKIP)                                                                  \
  launch_a<TIn, TG, W, TC, std::is_same<TIn, bf16>::value ? SKIP : 0>(                         \
      lv, levels, level0, level1, coords, g, d_f1, bq, q_per_b, C, radius, s)
  const bool bf = std::is_same<TIn, bf16>::value;
  switch (variant) {
    case 1: return K8_PROBE(256, true, 0);
    case 2: return K8_PROBE(128, true, 0);
    case 3: return K8_PROBE(64, true, 0);
    case 5: return K8_PROBE(256, false, 0);
    // the diagnostics: bf16 only
    case 6: return bf ? K8_PROBE(256, true, kSkipMma) : cudaErrorInvalidValue;
    case 7: return bf ? K8_PROBE(256, true, kSkipD) : cudaErrorInvalidValue;
    case 8: return bf ? K8_PROBE(256, true, kSkipStage) : cudaErrorInvalidValue;
    case 9: return bf ? K8_PROBE(256, true, kSkipStage | kSkipD | kSkipMma) : cudaErrorInvalidValue;
    case 10: return bf ? K8_PROBE(256, true, kSkipLow) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef K8_PROBE
}

}  // namespace k8probe

extern "C" {

// The probe's one entry: variant (above) over levels [level0, level1); C % 8
// == 0 and 16-byte aligned rows only. scratch: fp32 [levels, bq, C] for
// layout B (variant 4), else unused. Returns the launch's CUDA error.
int k8_probe(int variant, void* const* f2, const int* h2, const int* w2, int levels, int level0,
             int level1, const void* coords, const void* g, void* d_f1, void* scratch, int bq,
             int q_per_b, int C, int radius, int in_dtype, int g_dtype, void* stream) {
  if (!valid_args(levels, bq, q_per_b, C, radius) || level0 < 0 || level1 > levels ||
      level0 >= level1 || C % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < levels; ++l) {
    lv.p[l] = f2[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
  }
  const float* c = static_cast<const float*>(coords);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == FST_BF16 && g_dtype == FST_BF16) {
    return (int)k8probe::launch_variant<__nv_bfloat16, __nv_bfloat16>(variant, lv, levels, level0, level1, c, g,
                                                     d_f1, sc, bq, q_per_b, C, radius, s);
  }
  if (in_dtype == FST_F32 && g_dtype == FST_F32) {
    return (int)k8probe::launch_variant<float, float>(variant, lv, levels, level0, level1, c, g,
                                                       d_f1, sc, bq, q_per_b, C, radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
