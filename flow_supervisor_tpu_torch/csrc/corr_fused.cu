// Volume-free correlation-pyramid lookup from the feature-map factors.
//
// Replaces flow_supervisor_tpu/kernels/corr_fused.py `_fused_all_kernel` (K6:
// all levels in one launch, the B=1 path of `_lookup_impl`) and
// `_fused_level_kernel` (K7: one level per launch, the B>1 path). Nothing of
// size [B*Q, h2, w2] exists: for each query q and level l, the kernel computes
// only the (2r+2)^2 correlations <f1[q], f2_l[b, y, x]> / sqrt(C) at the
// support of the window centred at coords[q] / 2^l, in fp32, then writes the
// (2r+1)^2 bilinear samples at channel l*(2r+1)^2 + dx*(2r+1) + dy (dx-major,
// level-major stripes of one [BQ, L*(2r+1)^2] output). Support taps outside
// [0, h2) x [0, w2) contribute 0. The correlation is not rounded to the
// compute dtype before the combine; the output is written in the compute dtype.
//
// The window base is clamped to [-(2r+2), dim] in float before it becomes an
// integer (as in csrc/corr_plane.cu): coords far out of bounds cannot
// overflow, and a clamped window lies wholly outside the map, so it reads 0.
//
// What bounds it on an H100: per query and level it reads (2r+2)^2 = 100
// feature vectors of C values (51 KB at C=256 bf16) and does 2*C flops on
// each; neighbouring queries' supports overlap, so nearly all of that traffic
// hits L1/L2, and the unique bytes (f1, the pooled f2, the output: 13 MB at
// 448x1024 B=1 bf16) bound it at a few microseconds. The TPU kernel
// recomputed a whole [TQ, h2, w2] slab per query tile with MXU dots (24x the
// flops) because Mosaic cannot gather; a GPU can, so this design gathers.
// One warp per query: each lane holds 8 channels of f1[q] (one 16-byte load
// per lane for bf16, so a C=256 bf16 row of f2 is one coalesced 512-byte
// read), the warp accumulates 32 support dots in registers, and a butterfly
// reduce-scatter (31 shuffles for 32 dots) leaves dot s on lane s. The support
// is staged in shared memory for the combine. Channels not a multiple of 8
// take a scalar path (lane + 32*i), and C > 256 loops over 256-channel chunks.
// Tensor cores, reuse of overlapping supports across queries through shared
// memory, and TMA are left for later.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // queries per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* f2[kMaxLevels];  // [B, h2, w2, C] pooled target features
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

// Support slots per warp: (2r+2)^2 rounded up to whole groups of 32.
__host__ __device__ inline int support_slots(int radius) {
  const int sp = 2 * radius + 2;
  return (sp * sp + 31) / 32 * 32;
}

// 8 channels of a feature row as fp32, for `lane` of 256-channel chunk
// `chunk`: channels chunk*256 + lane*8 + [0, 8) when VEC (C % 8 == 0, rows
// 16-byte aligned), else chunk*256 + lane + 32*[0, 8). Channels >= C read 0.
template <bool VEC>
__device__ __forceinline__ void load8(const float* __restrict__ row, int chunk, int lane, int C,
                                      float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      const float4 a = *reinterpret_cast<const float4*>(row + c);
      const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      v[i] = c < C ? row[c] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ row, int chunk, int lane,
                                      int C, float v[8]) {
  if (VEC) {
    const int c = chunk * 256 + lane * 8;
    if (c < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = chunk * 256 + lane + 32 * i;
      v[i] = c < C ? __bfloat162float(row[c]) : 0.f;
    }
  }
}

// One step of the warp's butterfly reduce-scatter of p[0, 2W): a lane keeps
// the half of its slots selected by bit W of its lane id, in p[0, W), and
// adds the partner's copy of that half. After the steps 16, 8, 4, 2, 1,
// p[0] on lane L is the warp's sum of slot L. W is a template argument so
// that every index is static and p stays in registers.
template <int W>
__device__ __forceinline__ void reduce_scatter(float* p, int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? p[i] : p[i + W];
    const float keep = upper ? p[i + W] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// One query at one level, by one warp. f1q: the query's feature row; f2b: the
// sample's [h2, w2, C] map; (cx, cy): coords at this level's scale; sup: the
// warp's support_slots(radius) floats of shared memory; outq + ch0: where the
// (2r+1)^2 outputs go.
template <typename TIn, typename TOut, bool VEC>
__device__ void lookup_level(const TIn* __restrict__ f1q, const TIn* __restrict__ f2b, int h2,
                             int w2, int C, float cx, float cy, int radius, float* sup,
                             TOut* __restrict__ outq, int ch0, int lane) {
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k = 2 * radius + 1;
  const float flx = floorf(cx);
  const float fly = floorf(cy);
  const float fx = cx - flx;
  const float fy = cy - fly;
  const int bx = (int)fminf(fmaxf(flx - radius, -(float)sp), (float)w2);
  const int by = (int)fminf(fmaxf(fly - radius, -(float)sp), (float)h2);
  const int nchunks = (C + 255) / 256;
  const float root_c = sqrtf((float)C);

  for (int g = 0; g < ns; g += 32) {
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      float a[8];
      load8<VEC>(f1q, chunk, lane, C, a);
      // slot g + j is support row u, column v, stepped without a division
      int u = g / sp;
      int v = g % sp;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int y = by + u;
        const int x = bx + v;
        // warp-uniform: every lane has the same slot
        const bool valid = u < sp && y >= 0 && y < h2 && x >= 0 && x < w2;
        v = v + 1 == sp ? 0 : v + 1;
        u += v == 0;
        if (valid) {
          float b[8];
          load8<VEC>(f2b + ((long)y * w2 + x) * C, chunk, lane, C, b);
          float d = p[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(a[i], b[i], d);
          p[j] = d;
        }
      }
    }
    reduce_scatter<16>(p, lane);
    reduce_scatter<8>(p, lane);
    reduce_scatter<4>(p, lane);
    reduce_scatter<2>(p, lane);
    reduce_scatter<1>(p, lane);
    if (g + lane < ns) sup[g + lane] = p[0] / root_c;
  }
  __syncwarp();
  for (int o = lane; o < k * k; o += 32) {
    const int ix = o / k;  // dx index (major)
    const int iy = o % k;  // dy index (minor)
    const float* r0 = sup + iy * sp + ix;
    const float v = (1.f - fy) * (1.f - fx) * r0[0] + (1.f - fy) * fx * r0[1] +
                    fy * (1.f - fx) * r0[sp] + fy * fx * r0[sp + 1];
    fst_store(outq, ch0 + o, v);
  }
  __syncwarp();  // the next level reuses sup
}

// K6: all levels of one query per warp. f1 [B*Q, C]; out [B*Q, levels*k^2].
template <typename TIn, typename TOut, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    corr_fused_all_kernel(const TIn* __restrict__ f1, Levels lv, int levels,
                          const float* __restrict__ coords, TOut* __restrict__ out, int bq,
                          int q_per_b, int C, int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;  // the whole warp leaves together
  float* sup = smem + warp * support_slots(radius);
  const long b = q / q_per_b;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  for (int l = 0; l < levels; ++l) {
    const float scale = 1.0f / (float)(1 << l);
    const long plane = (long)lv.h2[l] * lv.w2[l] * C;
    lookup_level<TIn, TOut, VEC>(f1 + q * C, static_cast<const TIn*>(lv.f2[l]) + b * plane,
                                 lv.h2[l], lv.w2[l], C, cx * scale, cy * scale, radius, sup,
                                 out + q * (long)levels * k2, l * k2, lane);
  }
}

// K7: one level; writes channels [level*k^2, (level+1)*k^2) of rows of
// out_stride values.
template <typename TIn, typename TOut, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    corr_fused_level_kernel(const TIn* __restrict__ f1, const TIn* __restrict__ f2, int h2,
                            int w2, int level, const float* __restrict__ coords,
                            TOut* __restrict__ out, int out_stride, int bq, int q_per_b, int C,
                            int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;
  float* sup = smem + warp * support_slots(radius);
  const long b = q / q_per_b;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const float scale = 1.0f / (float)(1 << level);
  lookup_level<TIn, TOut, VEC>(f1 + q * C, f2 + b * (long)h2 * w2 * C, h2, w2, C,
                               coords[2 * q] * scale, coords[2 * q + 1] * scale, radius, sup,
                               out + q * (long)out_stride, level * k2, lane);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

size_t smem_bytes(int radius) { return (size_t)kWarps * support_slots(radius) * sizeof(float); }

template <typename TIn, typename TOut, bool VEC>
cudaError_t launch_all(const void* f1, const Levels& lv, int levels, const float* coords,
                       void* out, int bq, int q_per_b, int C, int radius, cudaStream_t s) {
  const int blocks = (bq + kWarps - 1) / kWarps;
  corr_fused_all_kernel<TIn, TOut, VEC><<<blocks, kWarps * 32, smem_bytes(radius), s>>>(
      static_cast<const TIn*>(f1), lv, levels, coords, static_cast<TOut*>(out), bq, q_per_b,
      C, radius);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, bool VEC>
cudaError_t launch_level(const void* f1, const void* f2, int h2, int w2, int level,
                         const float* coords, void* out, int out_stride, int bq, int q_per_b,
                         int C, int radius, cudaStream_t s) {
  const int blocks = (bq + kWarps - 1) / kWarps;
  corr_fused_level_kernel<TIn, TOut, VEC><<<blocks, kWarps * 32, smem_bytes(radius), s>>>(
      static_cast<const TIn*>(f1), static_cast<const TIn*>(f2), h2, w2, level, coords,
      static_cast<TOut*>(out), out_stride, bq, q_per_b, C, radius);
  return cudaGetLastError();
}

// LAUNCH<TIn, TOut, VEC>(args...) for the runtime dtype codes and `vec`
#define FST_DISPATCH(LAUNCH, ...)                                                     \
  do {                                                                                \
    if (in_dtype == FST_F32 && out_dtype == FST_F32)                                  \
      return (int)(vec ? LAUNCH<float, float, true>(__VA_ARGS__)                      \
                       : LAUNCH<float, float, false>(__VA_ARGS__));                   \
    if (in_dtype == FST_F32 && out_dtype == FST_BF16)                                 \
      return (int)(vec ? LAUNCH<float, __nv_bfloat16, true>(__VA_ARGS__)              \
                       : LAUNCH<float, __nv_bfloat16, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && out_dtype == FST_F32)                                 \
      return (int)(vec ? LAUNCH<__nv_bfloat16, float, true>(__VA_ARGS__)              \
                       : LAUNCH<__nv_bfloat16, float, false>(__VA_ARGS__));           \
    if (in_dtype == FST_BF16 && out_dtype == FST_BF16)                                \
      return (int)(vec ? LAUNCH<__nv_bfloat16, __nv_bfloat16, true>(__VA_ARGS__)      \
                       : LAUNCH<__nv_bfloat16, __nv_bfloat16, false>(__VA_ARGS__));   \
    return (int)cudaErrorInvalidValue;                                                \
  } while (0)

}  // namespace

extern "C" {

int fst_corr_fused_all(const void* f1, const void* const* f2, const int* h2, const int* w2,
                       int levels, const void* coords, void* out, int bq, int q_per_b, int C,
                       int radius, int in_dtype, int out_dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || bq < 1 || q_per_b < 1 || C < 1 || radius < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(radius);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Levels lv;
  bool vec = C % 8 == 0 && aligned16(f1);
  for (int l = 0; l < levels; ++l) {
    lv.f2[l] = f2[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
    vec = vec && aligned16(f2[l]);
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  FST_DISPATCH(launch_all, f1, lv, levels, c, out, bq, q_per_b, C, radius, s);
}

int fst_corr_fused_level(const void* f1, const void* f2, int h2, int w2, int level,
                         const void* coords, void* out, int out_stride, int bq, int q_per_b,
                         int C, int radius, int in_dtype, int out_dtype, void* stream) {
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  if (level < 0 || level >= kMaxLevels || bq < 1 || q_per_b < 1 || C < 1 || radius < 0 ||
      out_stride < (level + 1) * k2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(radius);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const bool vec = C % 8 == 0 && aligned16(f1) && aligned16(f2);
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  FST_DISPATCH(launch_level, f1, f2, h2, w2, level, c, out, out_stride, bq, q_per_b, C, radius,
               s);
}

}  // extern "C"
