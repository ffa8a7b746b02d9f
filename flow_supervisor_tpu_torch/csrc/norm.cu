// Affine-free instance norm for NHWC activations, in two passes.
//
// Replaces flow_supervisor_tpu/kernels/norm.py: `_stats_kernel` (K3, the
// per-(b, c) fp32 sum / sum of squares -> (mean, rsqrt(var + eps))) and
// `_apply_kernel` (K4, (x - mean) * r, optional relu, cast to x's dtype).
//
// What bounds them on an H100: both are pure streaming passes (K3 reads x
// once, K4 reads x once and writes y once, a few flops per byte), so device
// memory bandwidth bounds them. The TPU grid carried the running sums from one
// grid step to the next; CUDA blocks run in no order, so K3 writes per-block
// partial sums and a small finalize kernel folds them in a fixed order. The
// result is the same from run to run (no atomics). Neighbouring threads read
// neighbouring channels of one pixel, so every warp load is coalesced. The
// TPU's lane packing for C < 128 is not carried over: it existed for the
// TPU's 128-lane tiles.
#include "common.cuh"

namespace {

constexpr int kRowsPerChunk = 512;
constexpr int kRowLanes = 8;

template <typename T>
__global__ void stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                     int M, int C, int P) {
  __shared__ float s1s[kRowLanes][32];
  __shared__ float s2s[kRowLanes][32];
  const int chunk = blockIdx.x;
  const int c = blockIdx.y * 32 + threadIdx.x;
  const int b = blockIdx.z;
  const int m_end = min(M, (chunk + 1) * kRowsPerChunk);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const long base = (long)b * M * C + c;
    for (int m = chunk * kRowsPerChunk + threadIdx.y; m < m_end; m += kRowLanes) {
      const float v = fst_load(x, base + (long)m * C);
      s1 += v;
      s2 += v * v;
    }
  }
  s1s[threadIdx.y][threadIdx.x] = s1;
  s2s[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < kRowLanes; ++r) {
      t1 += s1s[r][threadIdx.x];
      t2 += s2s[r][threadIdx.x];
    }
    float* out = partials + ((long)b * P + chunk) * 2 * C;
    out[c] = t1;
    out[C + c] = t2;
  }
}

constexpr int kFinalizeThreads = 256;

__global__ void stats_finalize_kernel(const float* __restrict__ partials,
                                      float* __restrict__ stats, int P, int C,
                                      float inv_count, float eps) {
  __shared__ float r1[kFinalizeThreads];
  __shared__ float r2[kFinalizeThreads];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  float s1 = 0.f, s2 = 0.f;
  for (int p = threadIdx.x; p < P; p += kFinalizeThreads) {
    const float* row = partials + ((long)b * P + p) * 2 * C;
    s1 += row[c];
    s2 += row[C + c];
  }
  r1[threadIdx.x] = s1;
  r2[threadIdx.x] = s2;
  __syncthreads();
  for (int step = kFinalizeThreads / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
      r1[threadIdx.x] += r1[threadIdx.x + step];
      r2[threadIdx.x] += r2[threadIdx.x + step];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float mean = r1[0] * inv_count;
    const float var = fmaxf(r2[0] * inv_count - mean * mean, 0.f);
    stats[(long)b * 2 * C + c] = mean;
    stats[(long)b * 2 * C + C + c] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                             T* __restrict__ y, long total, long MC, int C, int relu) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long b = i / MC;
    const float mean = stats[b * 2 * C + c];
    const float r = stats[b * 2 * C + C + c];
    float v = (fst_load(x, i) - mean) * r;
    if (relu) v = fmaxf(v, 0.f);
    fst_store(y, i, v);
  }
}

}  // namespace

cudaError_t fst_stats_finalize(const float* partials, float* stats, int B, int P, int C,
                               long count, float eps, cudaStream_t stream) {
  dim3 grid(C, B);
  stats_finalize_kernel<<<grid, kFinalizeThreads, 0, stream>>>(
      partials, stats, P, C, 1.0f / (float)count, eps);
  return cudaGetLastError();
}

extern "C" {

const char* fst_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Number of partial rows fst_instance_norm_stats needs per sample:
// ceil(M / kRowsPerChunk); the wrapper allocates partials [B, P, 2, C].
int fst_instance_norm_chunks(int M) { return (M + kRowsPerChunk - 1) / kRowsPerChunk; }

int fst_instance_norm_stats(const void* x, void* partials, void* stats, int B, int M, int C,
                            int dtype, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int P = (M + kRowsPerChunk - 1) / kRowsPerChunk;
  dim3 grid(P, (C + 31) / 32, B);
  dim3 block(32, kRowLanes);
  if (dtype == FST_F32) {
    stats_partial_kernel<float><<<grid, block, 0, s>>>((const float*)x, (float*)partials, M, C, P);
  } else if (dtype == FST_BF16) {
    stats_partial_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (float*)partials, M, C, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fst_stats_finalize((const float*)partials, (float*)stats, B, P, C, (long)M, eps, s);
}

int fst_instance_norm_apply(const void* x, const void* stats, void* y, int B, int M, int C,
                            int dtype, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long total = (long)B * M * C;
  const int threads = 256;
  const long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132L * 32 ? want : 132L * 32);
  if (dtype == FST_F32) {
    apply_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (const float*)stats, (float*)y, total, (long)M * C, C, relu);
  } else if (dtype == FST_BF16) {
    apply_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)stats, (__nv_bfloat16*)y, total, (long)M * C,
        C, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
