// Shared helpers for the port's kernels: dtype codes (mirrored in
// kernels/_build.py DTYPE_CODES) and fp32 load/store for float and bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FST_F32 0
#define FST_BF16 1

__device__ __forceinline__ float fst_load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float fst_load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void fst_store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void fst_store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// 8 channels of a feature row as fp32, for `lane` of 256-channel chunk
// `chunk`: channels chunk*256 + lane*8 + [0, 8) when VEC (C % 8 == 0, rows
// 16-byte aligned: one 16-byte load per lane for bf16, two for fp32), else
// chunk*256 + lane + 32*[0, 8). Channels >= C read 0. Shared by the fused
// lookup (corr_fused.cu) and its backward (corr_fused_bwd.cu).
template <bool VEC>
__device__ __forceinline__ void fst_load8(const float* __restrict__ row, int chunk, int lane,
                                          int C, float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      const float4 a = *reinterpret_cast<const float4*>(row + c);
      const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      v[i] = c < C ? row[c] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void fst_load8(const __nv_bfloat16* __restrict__ row, int chunk,
                                          int lane, int C, float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      v[i] = c < C ? __bfloat162float(row[c]) : 0.f;
    }
  }
}

// Deterministic finalize shared by conv3x3_stats and instance_norm_stats:
// partials [B, P, 2, C] (sum, sum of squares, fp32) -> stats [B, 2, C] =
// (mean, rsqrt(max(E[x^2] - mean^2, 0) + eps)). Defined in norm.cu.
cudaError_t fst_stats_finalize(const float* partials, float* stats, int B, int P,
                               int C, long count, float eps, cudaStream_t stream);
