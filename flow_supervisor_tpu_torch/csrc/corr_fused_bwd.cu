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
// scatter. A GPU can, so these kernels touch only the support taps.
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
// - K9 is bound by its atomic traffic to L2: every valid tap of every query
//   and level adds C fp32 values. One warp per (query, level), level-major so
//   that neighbouring warps add into neighbouring taps of one level; each lane
//   adds its 8 channels as two 16-byte vector atomics (sm_90). The order of
//   the sums changes from run to run, so d_f2 differs between runs by fp32
//   rounding. A deterministic two-pass scatter, and sharing each tap's sum
//   across the neighbouring queries of a block before one atomic, are later
//   work.
// Channels not a multiple of 8 take a scalar path (lane + 32*i), and C > 256
// loops over 256-channel chunks, as in the forward.
#include <stdint.h>

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

// d_sup [(2r+2)^2] of one query at one level into shared memory, by the
// warp's lanes: the transposed bilinear of the window cotangent gl, zero at
// taps outside the map, times scale.
template <typename TG>
__device__ void support_cotangent(const TG* __restrict__ gl, int radius, const Window& w,
                                  int h2, int w2, float scale, float* dsup, int lane) {
  const int k = 2 * radius + 1;
  const int sp = k + 1;
  for (int s = lane; s < sp * sp; s += 32) {
    const int u = s / sp;  // support row (y)
    const int v = s % sp;  // support column (x)
    const int y = w.by + u;
    const int x = w.bx + v;
    float d = 0.f;
    if (y >= 0 && y < h2 && x >= 0 && x < w2) {
      d = (1.f - w.fy) * (1.f - w.fx) * gwin(gl, k, u, v) +
          (1.f - w.fy) * w.fx * gwin(gl, k, u, v - 1) +
          w.fy * (1.f - w.fx) * gwin(gl, k, u - 1, v) + w.fy * w.fx * gwin(gl, k, u - 1, v - 1);
      d *= scale;
    }
    dsup[s] = d;
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

// K9: one warp per (query, level), level-major. acc.p[l]: fp32 [B, h2, w2, C].
template <typename TIn, typename TG, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    bwd_df2_kernel(const TIn* __restrict__ f1, Levels acc, int levels,
                   const float* __restrict__ coords, const TG* __restrict__ g, int bq,
                   int q_per_b, int C, int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long wq = (long)blockIdx.x * kWarps + warp;
  if (wq >= (long)bq * levels) return;
  const int l = (int)(wq / bq);
  const long q = wq % bq;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const int h2 = acc.h2[l];
  const int w2 = acc.w2[l];
  float* dsup = smem + (long)warp * ns;
  const long b = q / q_per_b;
  const float s = 1.0f / (float)(1 << l);
  const Window w = window_at(coords[2 * q] * s, coords[2 * q + 1] * s, radius, h2, w2);
  support_cotangent(g + q * (long)levels * k2 + l * k2, radius, w, h2, w2,
                    1.f / sqrtf((float)C), dsup, lane);
  __syncwarp();
  float* accb = static_cast<float*>(acc.p[l]) + b * (long)h2 * w2 * C;
  const int nchunks = (C + 255) / 256;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    float a[8];
    fst_load8<VEC>(f1 + q * C, chunk, lane, C, a);
    int u = 0;
    int v = 0;
    for (int t = 0; t < ns; ++t) {
      const float d = dsup[t];
      const int y = w.by + u;
      const int x = w.bx + v;
      v = v + 1 == sp ? 0 : v + 1;
      u += v == 0;
      if (d != 0.f) atomic_add8<VEC>(accb + ((long)y * w2 + x) * C, chunk, lane, C, d, a);
    }
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

template <typename TIn, typename TG, bool VEC>
cudaError_t launch_df2(const void* f1, const Levels& acc, int levels, const float* coords,
                       const void* g, int bq, int q_per_b, int C, int radius, cudaStream_t s) {
  const long warps = (long)bq * levels;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * support_size(radius) * sizeof(float);
  bwd_df2_kernel<TIn, TG, VEC><<<blocks, kWarps * 32, smem, s>>>(
      static_cast<const TIn*>(f1), acc, levels, coords, static_cast<const TG*>(g), bq, q_per_b,
      C, radius);
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
  const size_t smem = (size_t)kWarps * support_size(radius) * sizeof(float);
  if (!valid_args(levels, bq, q_per_b, C, radius, smem)) return (int)cudaErrorInvalidValue;
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
  FST_BWD_DISPATCH(launch_df2, f1, lv, levels, c, g, bq, q_per_b, C, radius, s);
}

}  // extern "C"
