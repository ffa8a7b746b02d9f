// The window gather shared by the three plane lookups: K1 (corr_plane.cu,
// the plane backend), K10 (corr_window.cu, the pallas backend) and K11
// (corr_lookup.cu, the 5-D volume). All three read, for each query q and
// level l, the plane [h2, w2] of correlations of q at that level (K1 and K10
// from the per-level planes [BQ, h2, w2], K11 from the volume [B, h1, w1,
// h2, w2], which is the same layout), centre a (2r+1)^2 window at
// coords[q] / 2^l, and sample it bilinearly with taps outside the plane
// reading 0. The TPU needed three kernels for layout reasons only (band
// slices and rolls, one-hot matmuls, 16-lane outputs); on the H100 they are
// one body with two output modes:
//
// - window: the (2r+1)^2 bilinear window of every level at channel
//   l*(2r+1)^2 + dx*(2r+1) + dy (dx-major, the reference channel order of
//   ops/corr.py), in the query's contiguous output row [levels * (2r+1)^2];
// - support: the (2r+2)^2 support [y, x] of every level in fp32, no combine,
//   at out[q, l] ([BQ, levels, 2r+2, 2r+2]): the TPU kernel K10's own output.
//
// The window base is clamped to [-(2r+2), dim] in float before it becomes an
// integer (as corr_plane.py `_index_planes` clamps bx/by): coords far out of
// bounds cannot overflow, and a clamped window lies wholly outside the plane,
// so it still reads 0.
//
// What bounds it on an H100: a gather with no reuse across queries. Each
// query reads the (2r+2)^2 support of its window in its own plane at every
// level (400 values at r = 4, L = 4: 800 bytes in bf16, in 20-byte row
// segments) and does 4 products per output, so the bytes bound it; what
// limits it in practice is the latency of those scattered loads.
//
// The design: one warp per query, all levels in one launch. The lanes read
// the coords once; each level's base and fractions are computed once per
// lane, with no integer division at run time for RAFT's radius (4 is
// compiled with the radius fixed; any other radius runs the same body with
// it as an argument). Every support tap is read once: neighbouring lanes read
// neighbouring columns of one plane row, zeros stand where a tap lies outside
// the plane, and the support goes into the warp's slice of shared memory (row
// stride 2r+3, odd, so lanes on neighbouring window rows hit distinct banks)
// or, in support mode, straight to the output. Each lane then combines its
// outputs' 4 taps with the plain version's weights in its order and rounding
// (ops/corr.py `combine_support`: no fused multiply-add), so an fp32 output
// equals the plain version's, and writes them: neighbouring lanes write
// neighbouring channels of the query's contiguous output row. No atomics: the
// output is the same from run to run. A radius whose support does not fit in
// shared memory is refused (cudaErrorInvalidValue). Staging all levels' loads
// in registers first, a staged output row written in 16-byte stores, 16
// warps a block, persistent warps that prefetch the next query, and cp.async
// staging of the rows' aligned words were each slower on the card for K1,
// and the first of them for K10 and K11 too
// (flow_supervisor_tpu_torch/probe_k1.py, PERF.md).
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // queries per block

// output modes of window_kernel
constexpr int kWindowMode = 0;   // the bilinear windows, combined
constexpr int kSupportMode = 1;  // the fp32 supports, not combined

struct Levels {
  const void* plane[kMaxLevels];
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// Shared memory of one warp in window mode: the support [levels][2r+2][2r+3]
// in fp32.
__host__ __device__ inline long warp_floats(int levels, int radius) {
  const long s = 2L * radius + 2;
  return levels * s * (s + 1);
}

// R >= 0: the radius is fixed at compile time (the loops unroll and the
// divisions by 2r+1 and 2r+2 become multiplications); R < 0: it is the argument.
template <typename TIn, typename TOut, int R, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
window_kernel(Levels lv, int levels, const float* __restrict__ coords,
              TOut* __restrict__ out, int bq, int radius_arg) {
  extern __shared__ float s_sup[];
  const int r = R >= 0 ? R : radius_arg;
  const int S = 2 * r + 2;  // support side
  const int SP = S + 1;     // support row stride in shared memory
  const int K = 2 * r + 1;  // window side
  const int K2 = K * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= bq) return;  // whole warps only: no block-wide barrier below
  float* sup = s_sup + warp * warp_floats(levels, r);
  const float qx = coords[2L * q];
  const float qy = coords[2L * q + 1];

  // 1. every support tap of every level, read once
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels) {
      const float scale = 1.f / (float)(1 << l);
      const int h2 = lv.h2[l];
      const int w2 = lv.w2[l];
      const int bx = (int)fminf(fmaxf(floorf(qx * scale) - r, -(float)S), (float)w2);
      const int by = (int)fminf(fmaxf(floorf(qy * scale) - r, -(float)S), (float)h2);
      const TIn* plane = static_cast<const TIn*>(lv.plane[l]) + (long)q * h2 * w2;
#pragma unroll
      for (int j = 0; j < (S * S + 31) / 32; ++j) {
        const int t = lane + 32 * j;
        const int u = t / S;
        const int v = t - u * S;
        const int y = by + u;
        const int x = bx + v;
        if (t < S * S) {
          const float p = (y >= 0 && y < h2 && x >= 0 && x < w2)
                              ? fst_load(plane, (long)y * w2 + x)
                              : 0.f;
          if (MODE == kSupportMode) {
            fst_store(out, ((long)q * levels + l) * (S * S) + t, p);
          } else {
            sup[(l * S + u) * SP + v] = p;
          }
        }
      }
    }
  }
  if (MODE == kSupportMode) return;
  __syncwarp();

  // 2. each lane combines its outputs' 4 taps, as combine_support does:
  //    ((w00 * p00 + w01 * p01) + w10 * p10) + w11 * p11, every step rounded
  TOut* orow = out + (long)q * levels * K2;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels) {
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
      const float* ps = sup + l * S * SP;
#pragma unroll
      for (int m = 0; m < (K2 + 31) / 32; ++m) {
        const int o = lane + 32 * m;
        if (o < K2) {
          const int dx = o / K;  // dx-major: o = dx * K + dy
          const int dy = o - dx * K;
          const float* p = ps + dy * SP + dx;
          const float acc = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(w00, p[0]), __fmul_rn(w01, p[1])),
                        __fmul_rn(w10, p[SP])),
              __fmul_rn(w11, p[SP + 1]));
          fst_store(orow, l * K2 + o, acc);
        }
      }
    }
  }
}

template <typename TIn, typename TOut, int R, int MODE>
cudaError_t window_launch(const Levels& lv, int levels, const float* coords, void* out, int bq,
                          int radius, cudaStream_t s) {
  const long smem =
      MODE == kSupportMode ? 0 : kWarps * warp_floats(levels, radius) * (long)sizeof(float);
  auto kernel = window_kernel<TIn, TOut, R, MODE>;
  if (smem > 48 * 1024) {  // beyond the default: the card's opt-in limit holds
    int dev = 0;
    int optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    if (smem > optin) return cudaErrorInvalidValue;  // the support does not fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (bq + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, s>>>(lv, levels, coords, static_cast<TOut*>(out), bq,
                                          radius);
  return cudaGetLastError();
}

// RAFT's radius 4 on the compiled body, any other on the runtime one
template <typename TIn, typename TOut, int MODE>
cudaError_t window_launch_radius(const Levels& lv, int levels, const float* coords, void* out,
                                 int bq, int radius, cudaStream_t s) {
  if (radius == 4) return window_launch<TIn, TOut, 4, MODE>(lv, levels, coords, out, bq, radius, s);
  return window_launch<TIn, TOut, -1, MODE>(lv, levels, coords, out, bq, radius, s);
}

// The C entries' argument check: false for arguments no launch takes; else
// the per-level arrays copied into lv.
inline bool window_levels(const void* const* planes, const int* h2, const int* w2, int levels,
                          int bq, int radius, Levels* lv) {
  if (levels < 1 || levels > kMaxLevels || bq < 1 || radius < 0 || radius > 4096) return false;
  for (int l = 0; l < levels; ++l) {
    lv->plane[l] = planes[l];
    lv->h2[l] = h2[l];
    lv->w2[l] = w2[l];
  }
  return true;
}

}  // namespace
