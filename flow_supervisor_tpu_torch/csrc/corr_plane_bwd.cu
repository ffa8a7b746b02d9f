// Backward of the plane lookups (K1, corr_plane.cu) and (K10,
// corr_window.cu): the cotangent of every per-query plane.
//
// Replaces no Pallas kernel: the JAX package computes it in XLA
// (flow_supervisor_tpu/kernels/corr_plane.py `_lookup_bwd` and
// corr_lookup_v2.py `_lookup_bwd`, both through corr_fused.py
// `lookup_vjp_dvols`: the transposed 4-tap lerp, then two one-hot products).
// For each query q and level l it writes q's whole plane row d_plane[l][q]
// [h2, w2]: zero, except at the query's (2r+2)^2 support taps inside the
// plane (window base clip(floor(c) - r, -(2r+2), dim) at c = coords[q] / 2^l,
// as window.cuh), which hold the support cotangent
//   d_sup[u][v] = ((w00 g[u][v] + w01 g[u][v-1]) + w10 g[u-1][v]) + w11 g[u-1][v-1]
// (g[dy][dx] = g_in[q, l * (2r+1)^2 + dx * (2r+1) + dy], out of range 0; the
// weights of the forward's combine), every step rounded as the plain version
// (ops/corr.py `support_cotangent`) rounds it: no fused multiply-add. With a
// bf16 g the value is rounded to bf16 (JAX's d_vol dtype), then stored in
// the planes' dtype. The taps of one query are distinct positions and each
// query owns its rows, so there are no atomics and the output is the same
// from run to run; the plane build's matmul (torch.matmul, autograd) carries
// d_plane on to the feature maps.
//
// What bounds it on an H100: the bytes of d_plane, written once (a 54x128
// level-0 plane is 6,912 values a query); g and coords are a few hundred
// bytes a query. The design is window.cuh's transposed: one warp per query,
// all levels in one launch; the lanes compute the support cotangent of each
// level into the warp's slice of shared memory, then write the rows as
// consecutive 16-byte vectors of the flat row (8 bf16 or 4 fp32 values a
// lane) where the level's rows are 16-byte aligned, else one value a lane.
// A vector that misses the support's flat range is stored as zeros without
// any index arithmetic; the few that meet it look each value up.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBwdMaxLevels = 8;
constexpr int kBwdWarps = 8;  // queries per block

struct BwdLevels {
  void* out[kBwdMaxLevels];
  int h2[kBwdMaxLevels];
  int w2[kBwdMaxLevels];
  int vec[kBwdMaxLevels];  // 1: rows start 16-byte aligned and hold whole vectors
};

__device__ __forceinline__ float round_like(float v, const float*) { return v; }
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename TOut>
struct Vec16 {
  static constexpr int N = 16 / sizeof(TOut);
};

__device__ __forceinline__ void store_zero16(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void store_zero16(__nv_bfloat16* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename TG, typename TOut>
__global__ void __launch_bounds__(kBwdWarps * 32)
plane_bwd_kernel(BwdLevels lv, int levels, const float* __restrict__ coords,
                 const TG* __restrict__ g, int bq, int radius) {
  extern __shared__ float s_dsup[];
  const int r = radius;
  const int S = 2 * r + 2;  // support side
  const int K = 2 * r + 1;  // window side
  const int K2 = K * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kBwdWarps + warp;
  if (q >= bq) return;  // whole warps only: no block-wide barrier below
  float* dsup = s_dsup + (long)warp * levels * S * S;
  const float qx = coords[2L * q];
  const float qy = coords[2L * q + 1];
  const TG* gq = g + (long)q * levels * K2;

  // 1. the support cotangent of every level, as support_cotangent computes it
  for (int l = 0; l < levels; ++l) {
    const float scale = 1.f / (float)(1 << l);
    const float cx = qx * scale;
    const float cy = qy * scale;
    const float fx = __fsub_rn(cx, floorf(cx));
    const float fy = __fsub_rn(cy, floorf(cy));
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gy, gx);
    const float w01 = __fmul_rn(gy, fx);
    const float w10 = __fmul_rn(fy, gx);
    const float w11 = __fmul_rn(fy, fx);
    const TG* gl = gq + l * K2;
    for (int t = lane; t < S * S; t += 32) {
      const int u = t / S;  // dy
      const int v = t - u * S;  // dx
      // g[dy][dx] is channel dx * K + dy
      const float g00 = (u < K && v < K) ? fst_load(gl, v * K + u) : 0.f;
      const float g01 = (u < K && v >= 1) ? fst_load(gl, (v - 1) * K + u) : 0.f;
      const float g10 = (u >= 1 && v < K) ? fst_load(gl, v * K + u - 1) : 0.f;
      const float g11 = (u >= 1 && v >= 1) ? fst_load(gl, (v - 1) * K + u - 1) : 0.f;
      const float acc = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(w00, g00), __fmul_rn(w01, g01)), __fmul_rn(w10, g10)),
          __fmul_rn(w11, g11));
      dsup[l * S * S + t] = round_like(acc, g);
    }
  }
  __syncwarp();

  // 2. each level's row: zeros, the support cotangent at its taps
  for (int l = 0; l < levels; ++l) {
    const float scale = 1.f / (float)(1 << l);
    const int h2 = lv.h2[l];
    const int w2 = lv.w2[l];
    const int bx = (int)fminf(fmaxf(floorf(qx * scale) - r, -(float)S), (float)w2);
    const int by = (int)fminf(fmaxf(floorf(qy * scale) - r, -(float)S), (float)h2);
    // the support's taps inside the plane: rows [y0, y1), columns [x0, x1)
    const int y0 = max(by, 0), y1 = min(by + S, h2);
    const int x0 = max(bx, 0), x1 = min(bx + S, w2);
    const long n = (long)h2 * w2;
    // the flat range [lo, hi) holds every tap inside the plane
    const long lo = (y0 < y1 && x0 < x1) ? (long)y0 * w2 + x0 : n;
    const long hi = (y0 < y1 && x0 < x1) ? (long)(y1 - 1) * w2 + x1 : n;
    const float* ds = dsup + l * S * S;
    TOut* row = static_cast<TOut*>(lv.out[l]) + (long)q * n;
    auto value = [&](long i) -> float {
      if (i < lo || i >= hi) return 0.f;
      const int y = (int)(i / w2);
      const int x = (int)(i - (long)y * w2);
      return (y >= y0 && y < y1 && x >= x0 && x < x1) ? ds[(y - by) * S + (x - bx)] : 0.f;
    };
    if (lv.vec[l]) {
      constexpr int N = Vec16<TOut>::N;
      for (long i = (long)lane * N; i < n; i += 32L * N) {
        if (i + N <= lo || i >= hi) {
          store_zero16(row + i);
        } else {
          float v[N];
#pragma unroll
          for (int j = 0; j < N; ++j) v[j] = value(i + j);
          store16(row + i, v);
        }
      }
    } else {
      for (long i = lane; i < n; i += 32) fst_store(row, i, value(i));
    }
  }
}

template <typename TG, typename TOut>
cudaError_t plane_bwd_launch(const BwdLevels& lv, int levels, const float* coords, const void* g,
                             int bq, int radius, cudaStream_t s) {
  const long s_side = 2L * radius + 2;
  const long smem = kBwdWarps * levels * s_side * s_side * (long)sizeof(float);
  auto kernel = plane_bwd_kernel<TG, TOut>;
  if (smem > 48 * 1024) {  // beyond the default: the card's opt-in limit holds
    int dev = 0;
    int optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    if (smem > optin) return cudaErrorInvalidValue;  // the supports do not fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (bq + kBwdWarps - 1) / kBwdWarps;
  kernel<<<blocks, kBwdWarps * 32, smem, s>>>(lv, levels, coords, static_cast<const TG*>(g), bq,
                                              radius);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t plane_bwd_out(const BwdLevels& lv, int levels, const float* coords, const void* g,
                          int bq, int radius, int out_dtype, cudaStream_t s) {
  if (out_dtype == FST_F32) return plane_bwd_launch<TG, float>(lv, levels, coords, g, bq, radius, s);
  if (out_dtype == FST_BF16) {
    return plane_bwd_launch<TG, __nv_bfloat16>(lv, levels, coords, g, bq, radius, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// d_planes[L] ([bq, h2, w2] in out_dtype, written whole), h2[L], w2[L],
// levels, coords [bq, 2] fp32 (x, y) at level 0, g [bq, L * (2r+1)^2] in
// g_dtype (dx-major per level), bq, radius.
int fst_corr_plane_bwd(void* const* d_planes, const int* h2, const int* w2, int levels,
                       const void* coords, const void* g, int bq, int radius, int g_dtype,
                       int out_dtype, void* stream) {
  if (levels < 1 || levels > kBwdMaxLevels || bq < 1 || radius < 0 || radius > 4096) {
    return (int)cudaErrorInvalidValue;
  }
  BwdLevels lv;
  const int esize = out_dtype == FST_BF16 ? 2 : 4;
  for (int l = 0; l < levels; ++l) {
    if (h2[l] < 1 || w2[l] < 1) return (int)cudaErrorInvalidValue;
    lv.out[l] = d_planes[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
    const long row_bytes = (long)h2[l] * w2[l] * esize;
    lv.vec[l] = (reinterpret_cast<uintptr_t>(d_planes[l]) % 16 == 0) && (row_bytes % 16 == 0);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  if (g_dtype == FST_F32) return (int)plane_bwd_out<float>(lv, levels, c, g, bq, radius, out_dtype, s);
  if (g_dtype == FST_BF16) {
    return (int)plane_bwd_out<__nv_bfloat16>(lv, levels, c, g, bq, radius, out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
