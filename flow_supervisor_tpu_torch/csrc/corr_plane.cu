// Correlation-pyramid window lookup from materialized per-level planes.
//
// Replaces flow_supervisor_tpu/kernels/corr_plane.py `_plane_kernel` (K1,
// behind `_lookup_impl` / `corr_pyramid_lookup_plane`). For each query q and
// level l it reads the plane [h2, w2] of correlations of q against the pooled
// level-l target map, centres a (2r+1)^2 window at coords[q] / 2^l, and writes
// its bilinear samples at channel l*(2r+1)^2 + dx*(2r+1) + dy (dx-major, the
// reference channel order of ops/corr.py). Taps outside the plane read 0.
// Accumulation is fp32; the output is written in the compute dtype.
//
// The window base is clamped to [-(2r+2), dim] in float before it becomes an
// integer (as corr_plane.py `_index_planes` clamps bx/by): coords far out of
// bounds cannot overflow, and a clamped window lies wholly outside the plane,
// so it still reads 0.
//
// What bounds it on an H100: it is a bandwidth- and latency-bound gather with
// no reuse across queries -- each query reads about 100 values of its own
// plane per level ((2r+2)^2 support) and does ~4 FMAs per value. This first
// version gives every output element its own thread (4 taps each, neighbouring
// threads on neighbouring window rows, so the support's repeated reads hit L1)
// and writes the output row of each query contiguously. The TPU version's
// 128-lane group packing, BAND row padding and SMEM index planes existed for
// the TPU's (8, 128) tiling and are not carried over: planes are plain
// [BQ, h2, w2] arrays and each thread does its own index math.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;

struct Levels {
  const void* plane[kMaxLevels];
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

template <typename TIn, typename TOut>
__global__ void corr_plane_kernel(Levels lv, int levels, const float* __restrict__ coords,
                                  TOut* __restrict__ out, int bq, int radius) {
  const int k = 2 * radius + 1;
  const int k2 = k * k;
  const int row = levels * k2;
  const long total = (long)bq * row;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long q = idx / row;
    const int ch = (int)(idx % row);
    const int l = ch / k2;
    const int t = ch % k2;
    const int ix = t / k;  // dx index (major)
    const int iy = t % k;  // dy index (minor)
    const TIn* plane = static_cast<const TIn*>(lv.plane[l]);
    const int h2 = lv.h2[l];
    const int w2 = lv.w2[l];
    const float scale = 1.0f / (float)(1 << l);
    const float cx = coords[2 * q] * scale;
    const float cy = coords[2 * q + 1] * scale;
    const float flx = floorf(cx);
    const float fly = floorf(cy);
    const float fx = cx - flx;
    const float fy = cy - fly;
    const float sup = (float)(2 * radius + 2);
    const int bx = (int)fminf(fmaxf(flx - radius, -sup), (float)w2);
    const int by = (int)fminf(fmaxf(fly - radius, -sup), (float)h2);
    const int x0 = bx + ix;
    const int y0 = by + iy;
    const TIn* base = plane + q * (long)h2 * w2;
    float p[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int yy = y0 + a;
        const int xx = x0 + c;
        p[a][c] = (yy >= 0 && yy < h2 && xx >= 0 && xx < w2)
                      ? fst_load(base, (long)yy * w2 + xx)
                      : 0.f;
      }
    }
    const float v = (1.f - fy) * (1.f - fx) * p[0][0] + (1.f - fy) * fx * p[0][1] +
                    fy * (1.f - fx) * p[1][0] + fy * fx * p[1][1];
    fst_store(out, idx, v);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const Levels& lv, int levels, const float* coords, void* out, int bq,
                   int radius, cudaStream_t s) {
  const long total = (long)bq * levels * (2 * radius + 1) * (2 * radius + 1);
  const int threads = 256;
  const long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132L * 64 ? want : 132L * 64);
  corr_plane_kernel<TIn, TOut><<<blocks, threads, 0, s>>>(lv, levels, coords,
                                                         static_cast<TOut*>(out), bq, radius);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fst_corr_plane_lookup(const void* const* planes, const int* h2, const int* w2, int levels,
                          const void* coords, void* out, int bq, int radius, int in_dtype,
                          int out_dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || bq < 1) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < levels; ++l) {
    lv.plane[l] = planes[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  cudaError_t err;
  if (in_dtype == FST_F32 && out_dtype == FST_F32) {
    err = launch<float, float>(lv, levels, c, out, bq, radius, s);
  } else if (in_dtype == FST_F32 && out_dtype == FST_BF16) {
    err = launch<float, __nv_bfloat16>(lv, levels, c, out, bq, radius, s);
  } else if (in_dtype == FST_BF16 && out_dtype == FST_F32) {
    err = launch<__nv_bfloat16, float>(lv, levels, c, out, bq, radius, s);
  } else if (in_dtype == FST_BF16 && out_dtype == FST_BF16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(lv, levels, c, out, bq, radius, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
