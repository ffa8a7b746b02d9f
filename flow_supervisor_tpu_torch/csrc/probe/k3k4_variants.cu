// Variants of K3 and K4 (csrc/norm.cu) for the A/B timing of
// flow_supervisor_tpu_torch/probe_k3k4.py; not part of the kernel library.
//
//   0  the first K3 (the port's first design): 32 threads a pixel row with
//      scalar loads over 512-row chunks into partial rows, then K2's finalize
//      (stats_finalize_kernel, a block per channel and sample): two launches
//   1  the library's partial rows (stats_partial_row), then a fold kernel of
//      one block per sample (stats_fold, the library's last-block fold as a
//      kernel of its own): two launches
//   2  the library's partial rows, then K2's finalize: two launches
//   3  the library's K3: partial rows and the sample's last block folding
//      them, one launch
//   4  the first K4 (the port's first design): one element a thread a
//      grid-stride step, with i % C and i / (M C) per element
//   5  the library's K4 body
//   6  a diagnostic: 3 without the fold (the last block returns; stats are
//      not written), for the fold's share of 3's time
//
// `per_sm` sets the grid of variants 1-3, 5 and 6: blocks an SM over the
// card, at most `max_parts` a sample (K3's partial rows); `unroll` their rows
// in flight a thread (4 or 8 for K3, 1, 2 or 4 for K4; the library:
// kStatsBlocksPerSm, kStatsMaxParts and kStatsUnroll, kApplyBlocksPerSm and
// kApplyUnroll).
#include <stdint.h>

#include "../norm.cu"

namespace k3k4probe {

constexpr int kOldRowsPerChunk = 512;
constexpr int kOldRowLanes = 8;

// ---- 0: the first K3's partial sums ----
template <typename T>
__global__ void first_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                           int M, int C, int P) {
  __shared__ float s1s[kOldRowLanes][32];
  __shared__ float s2s[kOldRowLanes][32];
  const int chunk = blockIdx.x;
  const int c = blockIdx.y * 32 + threadIdx.x;
  const int b = blockIdx.z;
  const int m_end = min(M, (chunk + 1) * kOldRowsPerChunk);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const long base = (long)b * M * C + c;
    for (int m = chunk * kOldRowsPerChunk + threadIdx.y; m < m_end; m += kOldRowLanes) {
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
    for (int r = 0; r < kOldRowLanes; ++r) {
      t1 += s1s[r][threadIdx.x];
      t2 += s2s[r][threadIdx.x];
    }
    float* out = partials + ((long)b * P + chunk) * 2 * C;
    out[c] = t1;
    out[C + c] = t2;
  }
}

// ---- 4: the first K4 ----
template <typename T>
__global__ void first_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
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

// ---- 1, 2: the library's partial rows alone, and a fold kernel ----
template <typename T, int V, int U>
__global__ void __launch_bounds__(kStatsThreads)
    partial_rows_kernel(const T* __restrict__ x, float* __restrict__ partials, int M, int C,
                        RowMap map) {
  __shared__ float red[kStatsThreads * 2 * V];
  __shared__ float seg[kStatsThreads];
  stats_partial_row<T, V, U>(x, partials, M, C, map, red, seg);
}

// ---- 6: 3 without its fold ----
template <typename T, int V, int U>
__global__ void __launch_bounds__(kStatsThreads)
    no_fold_kernel(const T* __restrict__ x, float* __restrict__ partials,
                   unsigned* __restrict__ counters, int M, int C, RowMap map) {
  __shared__ float red[kStatsThreads * 2 * V];
  __shared__ float seg[kStatsThreads];
  stats_partial_row<T, V, U>(x, partials, M, C, map, red, seg);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicInc(counters + blockIdx.z, gridDim.x * gridDim.y - 1);
}

__global__ void __launch_bounds__(kStatsThreads)
    fold_kernel(const float* __restrict__ partials, float* __restrict__ stats, int P, int C,
                float count, float eps) {
  __shared__ float red[kStatsThreads];
  __shared__ float seg[kStatsThreads];
  stats_fold(partials, stats, blockIdx.x, P, C, count, eps, red, seg);
}

template <typename T, int V, int U>
cudaError_t apply_unroll(const T* x, const float* stats, T* y, int B, int M, int C, int relu,
                         int per_sm, cudaStream_t s) {
  const RowMap map = row_map(B, M, C, V, kApplyThreads, U, per_sm, M);
  const dim3 grid(map.blocks, map.gy, B);
  if (relu) {
    norm_apply_kernel<T, V, U, true><<<grid, kApplyThreads, 0, s>>>(x, stats, y, M, C, map);
  } else {
    norm_apply_kernel<T, V, U, false><<<grid, kApplyThreads, 0, s>>>(x, stats, y, M, C, map);
  }
  return cudaGetLastError();
}

template <typename T, int V, int U>
cudaError_t stats_variant(int variant, int per_sm, int max_parts, const T* x, float* partials,
                          unsigned* counters, float* stats, int B, int M, int C, float eps,
                          cudaStream_t s) {
  const RowMap map = row_map(B, M, C, V, kStatsThreads, U, per_sm, max_parts);
  const dim3 grid(map.blocks, map.gy, B);
  if (variant == 6) {
    no_fold_kernel<T, V, U><<<grid, kStatsThreads, 0, s>>>(x, partials, counters, M, C, map);
    return cudaGetLastError();
  }
  if (variant == 3) {
    norm_stats_kernel<T, V, U><<<grid, kStatsThreads, 0, s>>>(x, partials, counters, stats, M, C,
                                                              map, eps);
    return cudaGetLastError();
  }
  partial_rows_kernel<T, V, U><<<grid, kStatsThreads, 0, s>>>(x, partials, M, C, map);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (variant == 2) return fst_stats_finalize(partials, stats, B, map.blocks, C, M, eps, s);
  fold_kernel<<<B, kStatsThreads, 0, s>>>(partials, stats, map.blocks, C, (float)M, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run(int variant, int per_sm, int unroll, int max_parts, const T* x,
                float* partials, unsigned* counters, float* stats, T* y, int B, int M, int C,
                int relu, float eps, cudaStream_t s) {
  if (variant == 0) {
    const int P = (M + kOldRowsPerChunk - 1) / kOldRowsPerChunk;
    first_stats_partial_kernel<T><<<dim3(P, (C + 31) / 32, B), dim3(32, kOldRowLanes), 0, s>>>(
        x, partials, M, C, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return fst_stats_finalize(partials, stats, B, P, C, M, eps, s);
  }
  const bool k3 = (variant >= 1 && variant <= 3) || variant == 6;
  if (k3 && unroll == 4) {
    return stats_variant<T, V, 4>(variant, per_sm, max_parts, x, partials, counters, stats, B, M,
                                  C, eps, s);
  }
  if (k3 && unroll == 8) {
    return stats_variant<T, V, 8>(variant, per_sm, max_parts, x, partials, counters, stats, B, M,
                                  C, eps, s);
  }
  if (variant == 4) {
    const long total = (long)B * M * C;
    const long want = (total + 255) / 256;
    const int blocks = (int)(want < 132L * 32 ? want : 132L * 32);
    first_apply_kernel<T><<<blocks, 256, 0, s>>>(x, stats, y, total, (long)M * C, C, relu);
    return cudaGetLastError();
  }
  if (variant == 5) {
    if (unroll == 1) return apply_unroll<T, V, 1>(x, stats, y, B, M, C, relu, per_sm, s);
    if (unroll == 2) return apply_unroll<T, V, 2>(x, stats, y, B, M, C, relu, per_sm, s);
    if (unroll == 4) return apply_unroll<T, V, 4>(x, stats, y, B, M, C, relu, per_sm, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace k3k4probe

extern "C" {

// Partial rows per sample that variant `variant` writes (partials [B, P, 2, C]).
int k3k4_probe_chunks(int variant, int per_sm, int unroll, int max_parts, int B, int M, int C,
                      int dtype, int vec) {
  if (variant == 0) return (M + k3k4probe::kOldRowsPerChunk - 1) / k3k4probe::kOldRowsPerChunk;
  const int v = vec ? (dtype == FST_BF16 ? 8 : 4) : 1;
  return row_map(B, M, C, v, kStatsThreads, unroll, per_sm, max_parts).blocks;
}

// One variant (above) on x [B, M, C]: K3's write stats, K4's read them and
// write y. vec: the vector body (variants 1-3 and 5), refused unless vector_ok.
int k3k4_probe(int variant, int per_sm, int unroll, int max_parts, const void* x,
               void* partials, void* counters, void* stats, void* y, int B, int M, int C,
               int dtype, int vec, int relu, float eps, void* stream) {
  if (vec && !vector_ok(dtype, C, x, y)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partials;
  unsigned* n = (unsigned*)counters;
  float* st = (float*)stats;
  using bf16 = __nv_bfloat16;
  if (dtype == FST_BF16) {
    const bf16* xb = (const bf16*)x;
    bf16* yb = (bf16*)y;
    return (int)(vec ? k3k4probe::run<bf16, 8>(variant, per_sm, unroll, max_parts, xb, p, n, st,
                                               yb, B, M, C, relu, eps, s)
                     : k3k4probe::run<bf16, 1>(variant, per_sm, unroll, max_parts, xb, p, n, st,
                                               yb, B, M, C, relu, eps, s));
  }
  if (dtype == FST_F32) {
    const float* xf = (const float*)x;
    float* yf = (float*)y;
    return (int)(vec ? k3k4probe::run<float, 4>(variant, per_sm, unroll, max_parts, xf, p, n, st,
                                                yf, B, M, C, relu, eps, s)
                     : k3k4probe::run<float, 1>(variant, per_sm, unroll, max_parts, xf, p, n, st,
                                                yf, B, M, C, relu, eps, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
