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

// Deterministic finalize shared by conv3x3_stats and instance_norm_stats:
// partials [B, P, 2, C] (sum, sum of squares, fp32) -> stats [B, 2, C] =
// (mean, rsqrt(max(E[x^2] - mean^2, 0) + eps)). Defined in norm.cu.
cudaError_t fst_stats_finalize(const float* partials, float* stats, int B, int P,
                               int C, long count, float eps, cudaStream_t stream);
