// Window lookup of one level of the 5-D correlation volume.
//
// Replaces flow_supervisor_tpu/kernels/corr_lookup.py `_lookup_kernel` (K11,
// behind `lookup_level_pallas` / `corr_pyramid_lookup_pallas`). For each
// query q the level's volume holds a plane [h2, w2] (the volume
// [B, h1, w1, h2, w2] read as [BQ, h2, w2]); the kernel samples the
// (2r+1)^2 bilinear window at coords[q] * scale, taps outside the plane
// reading 0, and writes it in fp32, dx-major, at out[q * out_stride + ...]
// (one level's stripe of the pyramid's output).
//
// The TPU kernel zero-pads every plane by 2r+2 into an fp32 copy
// (`_pad_and_index`) and extracts each window with two one-hot matmuls,
// because Mosaic cannot slice by data. Neither is carried over: one warp per
// query reads the (2r+2)^2 support of its window straight from the unpadded
// plane, with bounds checks giving the pad's zeros, into shared memory, then
// each lane combines the four taps of its outputs. The TPU kernel clamps the
// padded base into the padded plane; a clamped window lies wholly in the
// pad, so the clamp never changes a value. Here the base is clamped to
// [-(2r+2), dim] in float before it becomes an integer, so coords far out of
// bounds (to +-3e38) cannot overflow and still read 0.
//
// What bounds it on an H100: a gather of about (2r+2)^2 values of its own
// plane per query with no reuse across queries and 4 FMAs per output, so the
// bytes of the support taps (and the fp32 output) bound it.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // queries per block

template <typename TIn>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_level_kernel(const TIn* __restrict__ vol, int h2, int w2,
                         const float* __restrict__ coords, float scale,
                         float* __restrict__ out, int out_stride, int bq, int radius) {
  extern __shared__ float s_sup[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sup = 2 * radius + 2;
  const int k = 2 * radius + 1;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;  // whole warps only: no block-wide barrier below
  float* patch = s_sup + warp * sup * sup;

  const float cx = coords[2 * q] * scale;
  const float cy = coords[2 * q + 1] * scale;
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  const float fx = cx - flx;
  const float fy = cy - fly;
  const int bx = (int)fminf(fmaxf(flx - radius, -(float)sup), (float)w2);
  const int by = (int)fminf(fmaxf(fly - radius, -(float)sup), (float)h2);
  const TIn* plane = vol + q * (long)h2 * w2;
  for (int t = lane; t < sup * sup; t += 32) {
    const int yy = by + t / sup;
    const int xx = bx + t % sup;
    patch[t] = (yy >= 0 && yy < h2 && xx >= 0 && xx < w2)
                   ? fst_load(plane, (long)yy * w2 + xx)
                   : 0.f;
  }
  __syncwarp();
  const float w00 = (1.f - fy) * (1.f - fx);
  const float w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx);
  const float w11 = fy * fx;
  float* orow = out + q * (long)out_stride;
  for (int o = lane; o < k * k; o += 32) {
    const float* p = patch + (o % k) * sup + o / k;  // dx-major: o = dx * k + dy
    orow[o] = w00 * p[0] + w01 * p[1] + w10 * p[sup] + w11 * p[sup + 1];
  }
}

}  // namespace

extern "C" {

// vol: level volume [bq, h2, w2] (fp32 or bf16); coords: [bq, 2] fp32 (x, y)
// at level 0, scaled by 2^-level here; out: fp32, row q at q * out_stride.
int fst_corr_lookup_level(const void* vol, int h2, int w2, const void* coords, int level,
                          void* out, int out_stride, int bq, int radius, int in_dtype,
                          void* stream) {
  if (bq < 1 || radius < 0 || level < 0 || level > 30) return (int)cudaErrorInvalidValue;
  const int sup = 2 * radius + 2;
  const size_t smem = (size_t)kWarps * sup * sup * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (bq + kWarps - 1) / kWarps;
  const float scale = 1.0f / (float)(1 << level);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (in_dtype == FST_F32) {
    corr_lookup_level_kernel<float><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(vol), h2, w2, c, scale, o, out_stride, bq, radius);
  } else if (in_dtype == FST_BF16) {
    corr_lookup_level_kernel<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vol), h2, w2, c, scale, o, out_stride, bq, radius);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
