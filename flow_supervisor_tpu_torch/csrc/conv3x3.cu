// Direct 3x3 stride-1 SAME conv + bias over NHWC, with an instance-norm
// statistics epilogue (K2) or a relu epilogue (K5).
//
// Replaces flow_supervisor_tpu/kernels/conv3x3.py `_conv_stats_kernel` /
// `_conv_body` (K2): y = conv(x, w) + b written in x's dtype, and per-(b, cout)
// (mean, rsqrt(var + eps)) of the conv output for the instance norm that
// follows (applied by norm.cu's apply kernel).
//
// And `_conv_kernel` (K5, behind `conv3x3_fused`): the same body without the
// statistics, y = conv(x, w) + b, optionally relu'd in fp32 before the cast
// to x's dtype (template flags STATS and RELU of one kernel). K5 is bound by
// the same operations as K2 and gets the same design.
//
// Statistics are taken from the fp32 accumulator (bias included) BEFORE the
// cast to x's dtype, as the TPU kernel does. The JAX package's CPU
// composition (conv3x3.py `_cin_fwd_impl`, non-TPU branch) reads the rounded y
// instead; for fp32 the two agree, for bf16 this kernel follows the TPU kernel.
//
// What bounds it on an H100: at the encoder's shapes this is 4-17 GFLOP per
// call over 29-58 MB of activations, so arithmetic bounds it. This first
// version runs on the CUDA cores in fp32 (tensor cores, wgmma and TMA are
// later work): a block computes a tile of 128 pixels of one row x 32 output
// channels; each step stages a 3-row x 130-pixel x 16-channel input slab and
// the matching 3x3x16x32 weights in shared memory (the input is read from
// device memory about once per output-channel tile, not nine times), and
// every thread accumulates 4 pixels x 4 output channels in registers.
//
// The TPU grid carried the statistics sums across sequential grid steps;
// CUDA blocks run in no order, so each block writes its per-channel partial
// (sum, sum of squares) and norm.cu's finalize folds them in a fixed order:
// the statistics are the same from run to run (no atomics).
#include "common.cuh"

namespace {

constexpr int kTP = 128;  // output pixels per tile (along W)
constexpr int kTC = 32;   // output channels per tile
constexpr int kCK = 16;   // input channels per shared-memory step
constexpr int kThreads = 256;
constexpr int kInStride = kCK + 1;  // pad to avoid shared-memory bank conflicts
constexpr int kInElems = 3 * (kTP + 2) * kInStride;
constexpr int kWElems = 9 * kCK * kTC;

template <typename T, bool STATS, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y,
                     float* __restrict__ partials, int H, int W, int C, int Cout,
                     int n_ct, int P) {
  __shared__ float s_in[kInElems];
  __shared__ __align__(16) float s_w[kWElems];

  const int wt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_ct;
  const int co0 = (blockIdx.z % n_ct) * kTC;
  const int w0 = wt * kTP;
  const int tx = threadIdx.x % 8;   // output-channel group: couts tx*4 .. tx*4+3
  const int ty = threadIdx.x / 8;   // pixel group: pixels ty + 32*i, i < 4

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    // input slab: rows h-1..h+1, cols w0-1..w0+kTP, channels c0..c0+kCK-1 (zero outside)
    for (int e = threadIdx.x; e < 3 * (kTP + 2) * kCK; e += kThreads) {
      const int ck = e % kCK;
      const int col = (e / kCK) % (kTP + 2);
      const int r = e / (kCK * (kTP + 2));
      const int hh = h + r - 1;
      const int ww = w0 + col - 1;
      const int c = c0 + ck;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < C)
        v = fst_load(x, (((long)b * H + hh) * W + ww) * C + c);
      s_in[(r * (kTP + 2) + col) * kInStride + ck] = v;
    }
    // weights: HWIO [3][3][C][Cout] -> s_w[tap][ck][co]
    for (int e = threadIdx.x; e < kWElems; e += kThreads) {
      const int co = e % kTC;
      const int ck = (e / kTC) % kCK;
      const int tap = e / (kTC * kCK);
      const int c = c0 + ck;
      float v = 0.f;
      if (c < C && co0 + co < Cout) v = fst_load(w, ((long)tap * C + c) * Cout + co0 + co);
      s_w[e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wrow = s_w + (dy * 3 + dx) * kCK * kTC + tx * 4;
        const float* irow = s_in + (dy * (kTP + 2) + dx + ty) * kInStride;
#pragma unroll 4
        for (int ck = 0; ck < kCK; ++ck) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + ck * kTC);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = irow[(32 * i) * kInStride + ck];
            acc[i][0] += xv * wv.x;
            acc[i][1] += xv * wv.y;
            acc[i][2] += xv * wv.z;
            acc[i][3] += xv * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias (+ relu), cast + store, per-channel partial statistics of
  // the fp32 values
  float ps1[4] = {0.f, 0.f, 0.f, 0.f};
  float ps2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tx * 4 + j;
    if (co >= Cout) continue;
    const float bj = fst_load(bias, co);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ww = w0 + ty + 32 * i;
      if (ww >= W) continue;
      const float v = RELU ? fmaxf(acc[i][j] + bj, 0.f) : acc[i][j] + bj;
      fst_store(y, (((long)b * H + h) * W + ww) * Cout + co, v);
      ps1[j] += v;
      ps2[j] += v * v;
    }
  }
  if constexpr (STATS) {
    // fixed-order reduction over the 32 pixel groups (s_in is free after the
    // last __syncthreads of the main loop)
    float* red1 = s_in;               // [32][kTC]
    float* red2 = s_in + 32 * kTC;    // [32][kTC]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red1[ty * kTC + tx * 4 + j] = ps1[j];
      red2[ty * kTC + tx * 4 + j] = ps2[j];
    }
    __syncthreads();
    if (threadIdx.x < kTC && co0 + threadIdx.x < Cout) {
      float t1 = 0.f, t2 = 0.f;
      for (int g = 0; g < 32; ++g) {
        t1 += red1[g * kTC + threadIdx.x];
        t2 += red2[g * kTC + threadIdx.x];
      }
      const int p = h * gridDim.x + wt;
      float* out = partials + ((long)b * P + p) * 2 * Cout;
      out[co0 + threadIdx.x] = t1;
      out[Cout + co0 + threadIdx.x] = t2;
    }
  }
}

}  // namespace

extern "C" {

// Number of partial rows fst_conv3x3_stats needs per sample: H * ceil(W / 128);
// the wrapper allocates partials [B, P, 2, Cout].
int fst_conv3x3_partials(int H, int W) { return H * ((W + kTP - 1) / kTP); }

int fst_conv3x3_stats(const void* x, const void* w, const void* bias, void* y, void* partials,
                      void* stats, int B, int H, int W, int C, int Cout, int dtype, float eps,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_wt = (W + kTP - 1) / kTP;
  const int n_ct = (Cout + kTC - 1) / kTC;
  const int P = H * n_wt;
  if (H > 65535 || (long)B * n_ct > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n_wt, H, B * n_ct);
  if (dtype == FST_F32) {
    conv3x3_kernel<float, true, false><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias, (float*)y, (float*)partials, H,
        W, C, Cout, n_ct, P);
  } else if (dtype == FST_BF16) {
    conv3x3_kernel<__nv_bfloat16, true, false><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
        (__nv_bfloat16*)y, (float*)partials, H, W, C, Cout, n_ct, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fst_stats_finalize((const float*)partials, (float*)stats, B, P, Cout,
                                 (long)H * W, eps, s);
}

// K5: y = conv(x, w) + b (relu'd when relu != 0), no statistics.
int fst_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                int C, int Cout, int dtype, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_wt = (W + kTP - 1) / kTP;
  const int n_ct = (Cout + kTC - 1) / kTC;
  if (H > 65535 || (long)B * n_ct > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n_wt, H, B * n_ct);
#define FST_CONV_LAUNCH(T, R)                                                             \
  conv3x3_kernel<T, false, R><<<grid, kThreads, 0, s>>>(                                  \
      (const T*)x, (const T*)w, (const T*)bias, (T*)y, nullptr, H, W, C, Cout, n_ct, 0)
  if (dtype == FST_F32) {
    if (relu) FST_CONV_LAUNCH(float, true); else FST_CONV_LAUNCH(float, false);
  } else if (dtype == FST_BF16) {
    if (relu) FST_CONV_LAUNCH(__nv_bfloat16, true); else FST_CONV_LAUNCH(__nv_bfloat16, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FST_CONV_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
