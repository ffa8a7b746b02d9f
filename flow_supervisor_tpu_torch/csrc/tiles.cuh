// Shared by the fused lookup (corr_fused.cu, K6/K7) and its backward
// (corr_fused_bwd.cu, K8/K9): a query's window at one level, the tiles of
// neighbouring queries these kernels cut the query grid into, and the
// loads, shared-memory and tensor-core primitives of their tile bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 8;          // a block's queries: kTileY x kTileX neighbours of one sample
constexpr int kTileX = 8;
constexpr int kMaxBoxTaps = 1024;  // a tile whose box holds more taps takes the per-query body

// The window of one query at one level: base (clamped) and fractional part.
// The base is clamped to [-(2r+2), dim] in float before it becomes an
// integer: coords far out of bounds cannot overflow, and a clamped window
// lies wholly outside the map.
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

// The queries of one sample as a qh x qw grid: the level-0 map (h0, w0) when
// it holds q_per_b queries (f1 and f2 come from one feature-map size), else
// one row; cut into tiles_y x tiles_x tiles, the last ones ragged.
struct QueryGrid {
  int qh, qw, tiles_y, tiles_x;
};

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (all 16 when it is 0) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
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

// c += a . b on the tensor cores: a 16x16 bf16 A fragment (row), a 16x8 bf16
// B fragment (col), a 16x8 fp32 accumulator. bf16 x bf16 products are exact
// in fp32.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
