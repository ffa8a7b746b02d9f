// Window lookup of the 5-D correlation volume pyramid.
//
// Replaces flow_supervisor_tpu/kernels/corr_lookup.py `_lookup_kernel` (K11,
// behind `lookup_level_pallas` / `corr_pyramid_lookup_pallas`). For each
// query q a level's volume [B, h1, w1, h2, w2] holds a plane [h2, w2] (the
// volume read as [BQ, h2, w2], the layout of K1's planes); the kernel samples
// the (2r+1)^2 bilinear window at coords[q] / 2^l of every level, taps
// outside the plane reading 0, and writes it in fp32, dx-major, levels
// concatenated: one launch for the pyramid, window.cuh's body in window mode,
// the body K1 (corr_plane.cu) and K10 (corr_window.cu) run too.
//
// The TPU kernel zero-pads every plane by 2r+2 into an fp32 copy
// (`_pad_and_index`) and extracts each window with two one-hot matmuls,
// because Mosaic cannot slice by data. Neither is carried over: the bounds
// checks give the pad's zeros. The TPU kernel clamps the padded base into the
// padded plane; a clamped window lies wholly in the pad, so the clamp never
// changes a value, and window.cuh's float clamp is the same.
#include "window.cuh"

extern "C" {

// vols[L] (level l's volume as [bq, h2, w2], fp32 or bf16, all one dtype),
// coords [bq, 2] fp32 (x, y) at level 0 -> out [bq, L * (2r+1)^2] fp32.
int fst_corr_lookup(const void* const* vols, const int* h2, const int* w2, int levels,
                    const void* coords, void* out, int bq, int radius, int in_dtype,
                    void* stream) {
  Levels lv;
  if (!window_levels(vols, h2, w2, levels, bq, radius, &lv)) return (int)cudaErrorInvalidValue;
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

}  // extern "C"
