// Correlation-pyramid window lookup from materialized per-level planes.
//
// Replaces flow_supervisor_tpu/kernels/corr_plane.py `_plane_kernel` (K1,
// behind `_lookup_impl` / `corr_pyramid_lookup_plane`). For each query q and
// level l it reads the plane [h2, w2] of correlations of q against the pooled
// level-l target map, centres a (2r+1)^2 window at coords[q] / 2^l, and writes
// its bilinear samples at channel l*(2r+1)^2 + dx*(2r+1) + dy (dx-major).
// Taps outside the plane read 0. Accumulation is fp32; the output is written
// in the compute dtype (fp32 or bf16).
//
// The body is window.cuh's, in window mode (one warp per query, all levels in
// one launch), shared with K10 (corr_window.cu) and K11 (corr_lookup.cu). The
// first K1 gave every output element its own thread: each recomputed the
// window base, did a 64-bit division, and loaded its own 4 taps, so every
// support value was read about 3.2 times; it took 1.108 ms per 448x1024
// forward's 12 lookups against 0.12 for this body (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).
#include "window.cuh"

extern "C" {

int fst_corr_plane_lookup(const void* const* planes, const int* h2, const int* w2, int levels,
                          const void* coords, void* out, int bq, int radius, int in_dtype,
                          int out_dtype, void* stream) {
  Levels lv;
  if (!window_levels(planes, h2, w2, levels, bq, radius, &lv)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  if (in_dtype == FST_F32 && out_dtype == FST_F32) {
    return (int)window_launch_radius<float, float, kWindowMode>(lv, levels, c, out, bq, radius,
                                                                s);
  }
  if (in_dtype == FST_F32 && out_dtype == FST_BF16) {
    return (int)window_launch_radius<float, __nv_bfloat16, kWindowMode>(lv, levels, c, out, bq,
                                                                        radius, s);
  }
  if (in_dtype == FST_BF16 && out_dtype == FST_F32) {
    return (int)window_launch_radius<__nv_bfloat16, float, kWindowMode>(lv, levels, c, out, bq,
                                                                        radius, s);
  }
  if (in_dtype == FST_BF16 && out_dtype == FST_BF16) {
    return (int)window_launch_radius<__nv_bfloat16, __nv_bfloat16, kWindowMode>(
        lv, levels, c, out, bq, radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
