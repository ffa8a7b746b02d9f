// The pallas backend's window lookup from materialized per-level planes.
//
// Replaces flow_supervisor_tpu/kernels/corr_lookup_v2.py `_window_kernel`
// (K10, behind `_level_support` / `corr_pyramid_lookup_v2`). The TPU kernel
// writes each query's (2r+2)^2 support patch of one level in fp32 and leaves
// the 4-tap bilinear combine, the dx-major reorder and the level concat to
// XLA, which fuses them behind it. Here one launch does all of that for all
// levels: window.cuh's body in window mode with an fp32 output (JAX's
// `_combine` is fp32), the body K1 (corr_plane.cu) and K11 (corr_lookup.cu)
// run too. The TPU kernel's own output, one level's support patches, is the
// same body in support mode.
//
// The TPU's bottom-padded planes, band slice + rolls and 16-lane output width
// existed for the (8, 128) tiling and are not carried over.
#include "window.cuh"

extern "C" {

// planes[L] ([bq, h2, w2], fp32 or bf16), coords [bq, 2] fp32 (x, y) at
// level 0 -> out [bq, L * (2r+1)^2] fp32, dx-major per level.
int fst_corr_window_lookup(const void* const* planes, const int* h2, const int* w2, int levels,
                           const void* coords, void* out, int bq, int radius, int in_dtype,
                           void* stream) {
  Levels lv;
  if (!window_levels(planes, h2, w2, levels, bq, radius, &lv)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  if (in_dtype == FST_F32) {
    return (int)window_launch_radius<float, float, kWindowMode>(lv, levels, c, out, bq, radius,
                                                                s);
  }
  if (in_dtype == FST_BF16) {
    return (int)window_launch_radius<__nv_bfloat16, float, kWindowMode>(lv, levels, c, out, bq,
                                                                        radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One level: plane [bq, h2, w2], coords [bq, 2] fp32 at the level's scale ->
// out [bq, 2r+2, 2r+2] fp32 support patches [y, x], 0 outside the plane.
int fst_corr_window(const void* plane, int h2, int w2, const void* coords, void* out, int bq,
                    int radius, int in_dtype, void* stream) {
  Levels lv;
  if (h2 < 1 || w2 < 1 || !window_levels(&plane, &h2, &w2, 1, bq, radius, &lv)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  if (in_dtype == FST_F32) {
    return (int)window_launch_radius<float, float, kSupportMode>(lv, 1, c, out, bq, radius, s);
  }
  if (in_dtype == FST_BF16) {
    return (int)window_launch_radius<__nv_bfloat16, float, kSupportMode>(lv, 1, c, out, bq,
                                                                         radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
