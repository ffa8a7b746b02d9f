// Affine-free instance norm for NHWC activations: statistics, then apply.
//
// Replaces flow_supervisor_tpu/kernels/norm.py: `_stats_kernel` (K3, the
// per-(b, c) fp32 sum / sum of squares -> (mean, rsqrt(var + eps))) and
// `_apply_kernel` (K4, (x - mean) * r, optional relu, cast to x's dtype).
//
// What bounds them on an H100: both are pure streaming passes (K3 reads x
// once, K4 reads x once and writes y once, a few flops per byte), so device
// memory bandwidth bounds them. The design keeps enough 16-byte loads in
// flight and spends no instruction per element on indexing:
//
// - Rows: a block's threads are (channel group, row lane) pairs. A thread
//   owns one group of V channels (V = 8 bf16 or 4 fp32: one 16-byte vector;
//   V = 1, the scalar body, when C is not a multiple of that or x is not
//   16-byte aligned) for the whole launch, and its row lane walks the pixel
//   rows of one sample (blockIdx.z), 4 rows in flight. A block pass
//   covers RP whole rows, so a warp reads contiguous bytes (512 at C = 64).
//   No division per element: the channel is fixed and the sample comes from
//   the grid.
// - K4 loads the thread's 2 x V statistics once, then per element computes
//   (x - mean) * r rounded twice (no FMA), relu, and a round-to-nearest cast:
//   the plain PyTorch version's arithmetic, so the result is bit-identical.
// - K3: each thread sums its rows in fp32 registers, the block adds its row
//   lanes in shared memory in a fixed order and writes one partial row per
//   sample, then the sample's last block (a per-sample counter that
//   atomicInc wraps back to 0) folds the sample's partial rows in index
//   order and writes the statistics, each step rounded as the plain version
//   rounds it: one launch, no atomics on the data, the same bits from run to
//   run. The TPU grid carried the running sums from one
//   grid step to the next; CUDA blocks run in no order, hence the partials.
//
// The TPU's lane packing for C < 128 is not carried over: it existed for the
// TPU's 128-lane tiles. K2 (conv3x3.cu) takes its statistics through
// fst_stats_finalize below, a separate kernel kept as it was.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kApplyThreads = 256;
constexpr int kApplyUnroll = 4;
constexpr int kApplyBlocksPerSm = 8;
constexpr int kStatsThreads = 512;
constexpr int kStatsUnroll = 4;
constexpr int kStatsBlocksPerSm = 2;
// at most this many partial rows a sample: the sample's last block reads
// them all, and at a small B its fold would cost more than the blocks gain
constexpr int kStatsMaxParts = 64;

// SMs of the current device (0 if it cannot be read), asked once a device.
int norm_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 64) dev = 63;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// How a block covers x [B, M, C]: G groups of V channels, GB of them a block
// (blockIdx.y picks which), RP rows a pass; rows [blockIdx.x * chunk, + chunk).
struct RowMap {
  int G, GB, RP, gy, chunk, blocks;
};

// `per_sm` blocks an SM over the card but at most `max_parts` a sample, each a
// whole number of `unroll`-row passes where the rows allow it.
RowMap row_map(int B, int M, int C, int V, int threads, int unroll, int per_sm,
               int max_parts) {
  RowMap r;
  r.G = C / V;
  r.GB = r.G < threads ? r.G : threads;
  r.RP = threads / r.GB;
  r.gy = cdiv(r.G, r.GB);
  const int sms = norm_sms() > 0 ? norm_sms() : 1;
  long want = (long)per_sm * sms / ((long)B * r.gy);
  if (want > max_parts) want = max_parts;
  int chunk = cdiv(M, want > 0 ? want : 1);
  const int step = chunk >= r.RP * unroll ? r.RP * unroll : r.RP;
  r.chunk = cdiv(chunk, step) * step;
  r.blocks = cdiv(M, r.chunk);
  return r;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// V channels from p as fp32: one 16-byte load for V = 16 / sizeof(T).
template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// ---- K4 ----

template <int V, bool RELU>
__device__ __forceinline__ void normalize(float (&v)[V], const float (&mean)[V],
                                          const float (&r)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float t = __fmul_rn(__fsub_rn(v[i], mean[i]), r[i]);
    if (RELU) t = fmaxf(t, 0.f);
    v[i] = t;
  }
}

// y = (x - mean) * r (+ relu) over rows [blockIdx.x * chunk, + chunk) of
// sample blockIdx.z, channel group blockIdx.y * GB + threadIdx.x % GB; U rows
// in flight a thread.
template <typename T, int V, int U, bool RELU>
__global__ void __launch_bounds__(kApplyThreads)
    norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                      T* __restrict__ y, int M, int C, RowMap map) {
  const int tg = threadIdx.x % map.GB;
  const int tr = threadIdx.x / map.GB;
  const int g = blockIdx.y * map.GB + tg;
  if (tr >= map.RP || g >= map.G) return;
  const int c0 = g * V;
  const float* sb = stats + (long)blockIdx.z * 2 * C + c0;
  float mean[V], r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = sb[i];
    r[i] = sb[C + i];
  }
  const long off = (long)blockIdx.z * M * C + c0;
  const T* xb = x + off;
  T* yb = y + off;
  const int m1 = min(M, (int)(blockIdx.x + 1) * map.chunk);
  int m = (int)blockIdx.x * map.chunk + tr;
  for (; m + (U - 1) * map.RP < m1; m += U * map.RP) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) load_v(xb + (long)(m + u * map.RP) * C, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      normalize<V, RELU>(v[u], mean, r);
      store_v(yb + (long)(m + u * map.RP) * C, v[u]);
    }
  }
  for (; m < m1; m += map.RP) {
    float v[V];
    load_v(xb + (long)m * C, v);
    normalize<V, RELU>(v, mean, r);
    store_v(yb + (long)m * C, v);
  }
}

// ---- K3 ----

// Sums `rows` rows of `nv` values (value v of row r is at(r, v)) in a fixed
// order: with S = blockDim / nv segments, thread t adds value t % nv over rows
// t / nv, t / nv + S, ... in turn into seg[], then thread v < nv adds the S
// segment sums in turn and calls put(v, sum). A thread issues the loads of up
// to kFoldBatch rows at once (the fold's rows come from L2, and its time is
// their latency), then adds them in order. nv > blockDim: a thread walks
// values t, t + blockDim, ... over all rows. Every thread of the block calls
// it (a barrier inside).
constexpr int kFoldBatch = 32;

template <typename At, typename Put>
__device__ __forceinline__ void fixed_order_sum(int rows, int nv, float* seg, At at, Put put) {
  const int t = threadIdx.x;
  if (nv > (int)blockDim.x) {
    for (int v = t; v < nv; v += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += at(r, v);
      put(v, s);
    }
    return;
  }
  const int S = blockDim.x / nv;
  const int v = t % nv;
  const int sg = t / nv;
  if (sg < S) {
    float s = 0.f;
    for (int r0 = sg; r0 < rows; r0 += kFoldBatch * S) {
      float a[kFoldBatch];
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k) a[k] = r0 + k * S < rows ? at(r0 + k * S, v) : 0.f;
#pragma unroll
      for (int k = 0; k < kFoldBatch; ++k) s += a[k];  // past the rows: + 0, s unchanged
    }
    seg[sg * nv + v] = s;
  }
  __syncthreads();
  if (t < nv) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += seg[k * nv + t];
    put(t, s);
  }
}

// The block's partial row: the sums and sums of squares of its channels over
// its rows into partials[blockIdx.z, blockIdx.x, 2, C]. red: kStatsThreads *
// 2 * V floats, seg: kStatsThreads floats.
template <typename T, int V, int U>
__device__ __forceinline__ void stats_partial_row(const T* __restrict__ x,
                                                  float* __restrict__ partials, int M, int C,
                                                  const RowMap& map, float* red, float* seg) {
  const int tg = threadIdx.x % map.GB;
  const int tr = threadIdx.x / map.GB;
  const int g = blockIdx.y * map.GB + tg;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (tr < map.RP && g < map.G) {
    const T* xb = x + (long)blockIdx.z * M * C + g * V;
    const int m1 = min(M, (int)(blockIdx.x + 1) * map.chunk);
    int m = (int)blockIdx.x * map.chunk + tr;
    for (; m + (U - 1) * map.RP < m1; m += U * map.RP) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) load_v(xb + (long)(m + u * map.RP) * C, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += v[u][i];
          s2[i] += v[u][i] * v[u][i];
        }
      }
    }
    for (; m < m1; m += map.RP) {
      float v[V];
      load_v(xb + (long)m * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += v[i];
        s2[i] += v[i] * v[i];
      }
    }
  }
  const int cb = map.GB * V;  // the block's channels (those past C stay 0)
  const int nv = 2 * cb;
  if (tr < map.RP) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[tr * nv + tg * V + i] = s1[i];
      red[tr * nv + cb + tg * V + i] = s2[i];
    }
  }
  __syncthreads();
  float* row = partials + ((long)blockIdx.z * gridDim.x + blockIdx.x) * 2 * C;
  const int cbase = blockIdx.y * cb;
  fixed_order_sum(
      map.RP, nv, seg, [&](int r, int v) { return red[r * nv + v]; },
      [&](int v, float s) {
        const int c = cbase + (v < cb ? v : v - cb);
        if (c < C) row[(v < cb ? 0 : C) + c] = s;
      });
}

// Sample b's P partial rows, folded in index order, into stats[b] = (mean,
// rsqrt(max(E[x^2] - mean^2, 0) + eps)), kStatsThreads / 2 channels at a time.
// Each step is rounded as the plain version rounds it (no FMA), so a variance
// that is 0 in exact arithmetic (M = 1) comes out 0. red and seg:
// kStatsThreads floats each.
__device__ __forceinline__ void stats_fold(const float* __restrict__ partials,
                                           float* __restrict__ stats, int b, int P, int C,
                                           float count, float eps, float* red, float* seg) {
  const float* rows = partials + (long)b * P * 2 * C;
  constexpr int kChannels = kStatsThreads / 2;
  for (int c0 = 0; c0 < C; c0 += kChannels) {
    const int nc = min(C - c0, kChannels);
    fixed_order_sum(
        P, 2 * nc, seg,
        [&](int p, int v) {
          return __ldcg(rows + (long)p * 2 * C + (v < nc ? c0 + v : C + c0 + v - nc));
        },
        [&](int v, float s) { red[v] = s; });
    __syncthreads();
    const int t = threadIdx.x;
    if (t < nc) {
      const float mean = __fdiv_rn(red[t], count);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(red[nc + t], count), __fmul_rn(mean, mean)), 0.f);
      stats[(long)b * 2 * C + c0 + t] = mean;
      stats[(long)b * 2 * C + C + c0 + t] = rsqrtf(var + eps);
    }
    __syncthreads();  // red and seg are rewritten for the next channels
  }
}

// K3 in one launch: every block writes its partial row; the last block of a
// sample to finish (counters[b] counts the sample's blocks and wraps to 0)
// folds the sample's rows.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kStatsThreads)
    norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                      unsigned* __restrict__ counters, float* __restrict__ stats, int M, int C,
                      RowMap map, float eps) {
  __shared__ float red[kStatsThreads * 2 * V];
  __shared__ float seg[kStatsThreads];
  __shared__ bool last;
  stats_partial_row<T, V, U>(x, partials, M, C, map, red, seg);
  __threadfence();  // the partial row is visible to the block that folds
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned n = gridDim.x * gridDim.y;
    last = atomicInc(counters + blockIdx.z, n - 1) == n - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  stats_fold(partials, stats, blockIdx.z, gridDim.x, C, (float)M, eps, red, seg);
}

RowMap stats_map(int B, int M, int C, int V) {
  return row_map(B, M, C, V, kStatsThreads, kStatsUnroll, kStatsBlocksPerSm, kStatsMaxParts);
}

template <typename T, int V>
cudaError_t launch_stats(const void* x, float* partials, unsigned* counters, float* stats,
                         int B, int M, int C, float eps, cudaStream_t s) {
  const RowMap map = stats_map(B, M, C, V);
  norm_stats_kernel<T, V, kStatsUnroll><<<dim3(map.blocks, map.gy, B), kStatsThreads, 0, s>>>(
      (const T*)x, partials, counters, stats, M, C, map, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const float* stats, void* y, int B, int M, int C,
                         bool relu, cudaStream_t s) {
  const RowMap map =
      row_map(B, M, C, V, kApplyThreads, kApplyUnroll, kApplyBlocksPerSm, M);
  const dim3 grid(map.blocks, map.gy, B);
  if (relu) {
    norm_apply_kernel<T, V, kApplyUnroll, true><<<grid, kApplyThreads, 0, s>>>(
        (const T*)x, stats, (T*)y, M, C, map);
  } else {
    norm_apply_kernel<T, V, kApplyUnroll, false><<<grid, kApplyThreads, 0, s>>>(
        (const T*)x, stats, (T*)y, M, C, map);
  }
  return cudaGetLastError();
}

// The vector body takes C a multiple of 16 / sizeof(T) channels and 16-byte
// aligned x and y (kernels/norm.py `vector_body` mirrors the rule).
bool vector_ok(int dtype, int C, const void* x, const void* y) {
  const int v = dtype == FST_BF16 ? 8 : 4;
  return C % v == 0 && aligned16(x) && (y == nullptr || aligned16(y));
}

// ---- K2's finalize ----

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

// Partial rows per sample fst_instance_norm_stats needs for x [B, M, C] of
// `dtype` on the body `vec` picks; the wrapper allocates partials [B, P, 2, C].
int fst_instance_norm_chunks(int B, int M, int C, int dtype, int vec) {
  const int v = vec ? (dtype == FST_BF16 ? 8 : 4) : 1;
  return stats_map(B, M, C, v).blocks;
}

// K3. counters: B unsigned ints, 0 before the launch and 0 after it.
// vec: the vector body (refused unless vector_ok), else the scalar body.
int fst_instance_norm_stats(const void* x, void* partials, void* counters, void* stats, int B,
                            int M, int C, int dtype, int vec, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partials;
  unsigned* n = (unsigned*)counters;
  float* st = (float*)stats;
  if (B < 1 || M < 1 || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (vec && !vector_ok(dtype, C, x, nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == FST_F32) {
    return (int)(vec ? launch_stats<float, 4>(x, p, n, st, B, M, C, eps, s)
                     : launch_stats<float, 1>(x, p, n, st, B, M, C, eps, s));
  }
  if (dtype == FST_BF16) {
    return (int)(vec ? launch_stats<__nv_bfloat16, 8>(x, p, n, st, B, M, C, eps, s)
                     : launch_stats<__nv_bfloat16, 1>(x, p, n, st, B, M, C, eps, s));
  }
  return (int)cudaErrorInvalidValue;
}

// K4, on the body `vec` picks (as for K3).
int fst_instance_norm_apply(const void* x, const void* stats, void* y, int B, int M, int C,
                            int dtype, int vec, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  if (B < 1 || M < 1 || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (vec && !vector_ok(dtype, C, x, y)) return (int)cudaErrorInvalidValue;
  if (dtype == FST_F32) {
    return (int)(vec ? launch_apply<float, 4>(x, st, y, B, M, C, relu, s)
                     : launch_apply<float, 1>(x, st, y, B, M, C, relu, s));
  }
  if (dtype == FST_BF16) {
    return (int)(vec ? launch_apply<__nv_bfloat16, 8>(x, st, y, B, M, C, relu, s)
                     : launch_apply<__nv_bfloat16, 1>(x, st, y, B, M, C, relu, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
