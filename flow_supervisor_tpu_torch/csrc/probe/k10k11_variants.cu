// The first K10 and K11 and a variant of their shared body, for the A/B
// timing of flow_supervisor_tpu_torch/probe_k1.py (--kernels k10k11); not
// part of the kernel library.
//
//   first_k10  csrc/corr_window.cu before the shared body: one thread per
//              support tap of one level (a 64-bit division and the query's
//              coords reloaded per tap), fp32 support patches out; the
//              probe adds the PyTorch combine, reorder and concat behind it,
//              as the pallas backend ran them
//   first_k11  csrc/corr_lookup.cu before the shared body: one launch per
//              level, a warp per query, the radius at run time, shared row
//              stride 2r+2 (even), a contracted (FMA) combine
//   regs       window.cuh's body at r = 4, fp32 out, with all levels' loads
//              issued into registers before the first shared-memory store
#include "../window.cuh"

namespace k10k11probe {

constexpr int R = 4;
constexpr int S = 2 * R + 2;
constexpr int SP = S + 1;
constexpr int SS = S * S;
constexpr int kSlots = (SS + 31) / 32;
constexpr int K = 2 * R + 1;
constexpr int K2 = K * K;

template <typename TIn>
__global__ void first_k10(const TIn* __restrict__ plane, int h2, int w2,
                          const float* __restrict__ coords, float* __restrict__ out, int bq,
                          int radius) {
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
__global__ void __launch_bounds__(kWarps * 32)
first_k11(const TIn* __restrict__ vol, int h2, int w2, const float* __restrict__ coords,
          float scale, float* __restrict__ out, int out_stride, int bq, int radius) {
  extern __shared__ float s_sup[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sup = 2 * radius + 2;
  const int k = 2 * radius + 1;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;
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
    const float* p = patch + (o % k) * sup + o / k;
    orow[o] = w00 * p[0] + w01 * p[1] + w10 * p[sup] + w11 * p[sup + 1];
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kWarps * 32)
regs_kernel(Levels lv, int levels, const float* __restrict__ coords, float* __restrict__ out,
            int bq) {
  extern __shared__ float s_sup[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= bq) return;
  float* sup = s_sup + warp * warp_floats(levels, R);
  const float qx = coords[2L * q];
  const float qy = coords[2L * q + 1];
  float v[kMaxLevels][kSlots];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels) {
      const float scale = 1.f / (float)(1 << l);
      const int h2 = lv.h2[l];
      const int w2 = lv.w2[l];
      const int bx = (int)fminf(fmaxf(floorf(qx * scale) - R, -(float)S), (float)w2);
      const int by = (int)fminf(fmaxf(floorf(qy * scale) - R, -(float)S), (float)h2);
      const TIn* plane = static_cast<const TIn*>(lv.plane[l]) + (long)q * h2 * w2;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int t = lane + 32 * j;
        const int y = by + t / S;
        const int x = bx + t % S;
        v[l][j] = (t < SS && y >= 0 && y < h2 && x >= 0 && x < w2)
                      ? fst_load(plane, (long)y * w2 + x)
                      : 0.f;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int t = lane + 32 * j;
        if (t < SS) sup[(l * S + t / S) * SP + t % S] = v[l][j];
      }
    }
  }
  __syncwarp();
  float* orow = out + (long)q * levels * K2;
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
          const int dx = o / K;
          const int dy = o - dx * K;
          const float* p = ps + dy * SP + dx;
          orow[l * K2 + o] = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(w00, p[0]), __fmul_rn(w01, p[1])),
                        __fmul_rn(w10, p[SP])),
              __fmul_rn(w11, p[SP + 1]));
        }
      }
    }
  }
}

}  // namespace k10k11probe

extern "C" {

// one level's fp32 support patches [bq, 2r+2, 2r+2] at coords already at its scale
int probe_first_k10(const void* plane, int h2, int w2, const void* coords, void* out, int bq,
                    int radius, int in_dtype, void* stream) {
  const long total = (long)bq * (2 * radius + 2) * (2 * radius + 2);
  const long want = (total + 255) / 256;
  const int blocks = (int)(want < 132L * 64 ? want : 132L * 64);
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (in_dtype == FST_F32) {
    k10k11probe::first_k10<<<blocks, 256, 0, s>>>(static_cast<const float*>(plane), h2, w2, c, o,
                                                  bq, radius);
  } else {
    k10k11probe::first_k10<<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(plane), h2,
                                                  w2, c, o, bq, radius);
  }
  return (int)cudaGetLastError();
}

// one level at coords (level 0) / 2^level, fp32 rows at out + q * out_stride
int probe_first_k11(const void* vol, int h2, int w2, const void* coords, int level, void* out,
                    int out_stride, int bq, int radius, int in_dtype, void* stream) {
  const int sup = 2 * radius + 2;
  const size_t smem = (size_t)kWarps * sup * sup * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (bq + kWarps - 1) / kWarps;
  const float scale = 1.0f / (float)(1 << level);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (in_dtype == FST_F32) {
    k10k11probe::first_k11<<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const float*>(vol), h2, w2, c, scale, o, out_stride, bq, radius);
  } else {
    k10k11probe::first_k11<<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vol), h2, w2, c, scale, o, out_stride, bq, radius);
  }
  return (int)cudaGetLastError();
}

// all levels, r = 4, fp32 out [bq, L * 81]
int probe_regs(const void* const* planes, const int* h2, const int* w2, int levels,
               const void* coords, void* out, int bq, int in_dtype, void* stream) {
  Levels lv;
  if (!window_levels(planes, h2, w2, levels, bq, k10k11probe::R, &lv)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = kWarps * warp_floats(levels, k10k11probe::R) * sizeof(float);
  const int blocks = (bq + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (in_dtype == FST_F32) {
    k10k11probe::regs_kernel<float><<<blocks, kWarps * 32, smem, s>>>(lv, levels, c, o, bq);
  } else {
    k10k11probe::regs_kernel<__nv_bfloat16><<<blocks, kWarps * 32, smem, s>>>(lv, levels, c, o,
                                                                               bq);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
