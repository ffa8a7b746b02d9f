// Support-patch extraction from one level's materialized correlation planes.
//
// Replaces flow_supervisor_tpu/kernels/corr_lookup_v2.py `_window_kernel` (K10,
// behind `_level_support`, the "pallas" lookup backend). For each query q it
// writes the (2r+2)^2 support patch out[q, u, v] = plane[q, by + u, bx + v]
// (0 where the tap lies outside [0, h2) x [0, w2)) in fp32, with
// (bx, by) = clip(floor(coords[q]) - r, -(2r+2), dim) and coords already at
// the level's scale. The 4-tap bilinear combine, the dx-major reorder and the
// level concat stay outside, in PyTorch, as in the JAX package.
//
// The base is clamped in float before it becomes an integer (as in
// csrc/corr_plane.cu), so coords far out of bounds cannot overflow.
//
// What bounds it on an H100: a gather of 100 values of each query's own plane
// (no reuse across queries) plus a 400-byte fp32 write per query: latency of
// scattered 20-byte row segments, then bytes. One thread per support tap,
// neighbouring threads on neighbouring columns of one plane row, so a row's
// reads share sectors and the output is written contiguously. The TPU's
// bottom-padded planes, band slice + rolls and 16-lane output width existed
// for the (8, 128) tiling and are not carried over.
#include "common.cuh"

namespace {

template <typename TIn>
__global__ void corr_window_kernel(const TIn* __restrict__ plane, int h2, int w2,
                                   const float* __restrict__ coords, float* __restrict__ out,
                                   int bq, int radius) {
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const long total = (long)bq * ns;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long q = idx / ns;
    const int s = (int)(idx % ns);
    const int bx = (int)fminf(fmaxf(floorf(coords[2 * q]) - radius, -(float)sp), (float)w2);
    const int by = (int)fminf(fmaxf(floorf(coords[2 * q + 1]) - radius, -(float)sp), (float)h2);
    const int y = by + s / sp;
    const int x = bx + s % sp;
    out[idx] = (y >= 0 && y < h2 && x >= 0 && x < w2)
                   ? fst_load(plane, (q * h2 + y) * (long)w2 + x)
                   : 0.f;
  }
}

template <typename TIn>
cudaError_t launch(const void* plane, int h2, int w2, const float* coords, float* out, int bq,
                   int radius, cudaStream_t s) {
  const long total = (long)bq * (2 * radius + 2) * (2 * radius + 2);
  const int threads = 256;
  const long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132L * 64 ? want : 132L * 64);
  corr_window_kernel<TIn><<<blocks, threads, 0, s>>>(static_cast<const TIn*>(plane), h2, w2,
                                                     coords, out, bq, radius);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fst_corr_window(const void* plane, int h2, int w2, const void* coords, void* out, int bq,
                    int radius, int in_dtype, void* stream) {
  if (bq < 1 || h2 < 1 || w2 < 1 || radius < 0) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == FST_F32) return (int)launch<float>(plane, h2, w2, c, o, bq, radius, s);
  if (in_dtype == FST_BF16) return (int)launch<__nv_bfloat16>(plane, h2, w2, c, o, bq, radius, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
