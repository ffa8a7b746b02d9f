// The update block's conv epilogues: bias, activation and GRU gating applied
// to a bias-free cuDNN output, written where the next conv reads it.
//
// Replaces no TPU kernel (XLA fuses these elementwise ops into its convs on
// the TPU). It was added because on the H100 ATen ran every conv's bias add
// (its generic strided kernel on a channels_last output), every relu,
// sigmoid and tanh, the GRU's (1 - z) * h + z * q and the block's
// concatenations as passes of their own: 34 % of an inference pair's device
// time at 32 pairs a batch.
//
// Modes (kernels/update_epilogue.py holds the plain PyTorch version of each):
// - ACT:    out = act(x + bias) * scale, act relu or none, scale 1 or 0.25;
// - GATE:   z <- sigmoid(z + bz) (kept for UPDATE), rh = sigmoid(r + br) * h;
// - UPDATE: h' = (1 - z) * h + z * tanh(q + bq), written to two places (the
//           hidden state and the h slot of the GRU's [h | x] input).
// Every tensor is a [P, C] channel slice of an NHWC buffer: channels
// innermost, one row stride a tensor, so an output lands at a channel offset
// of a wider buffer. The biases are the convs' parameters as they are, fp32
// or the tensors' dtype (a model held in bf16, or in fp32 and run in bf16),
// so no caller casts them. All arithmetic is fp32, rounded once to the
// tensors' dtype (fp32 or bf16) on store. An output may alias its mode's input of the
// same position (x in ACT, z in GATE, h in UPDATE): each element is read
// before the same thread writes it.
//
// What bounds it on an H100: device memory. A few flops a byte; each input
// is read once and each output written once. The design:
// - a thread owns one group of 8 channels for the whole launch, its bias in
//   registers, and walks pixel rows; a block's threads are (group, row lane)
//   pairs, so a warp reads contiguous bytes of consecutive rows;
// - 16-byte loads and stores (8 bf16 or 2 x 4 fp32) for each tensor whose
//   pointer is 16-byte aligned and row stride a multiple of 16 bytes, else
//   one element at a time (the motion conv's 126-channel output); a group
//   past C (126 or 2 channels) takes a masked tail;
// - 4 rows in flight a thread in ACT, 2 in GATE and UPDATE (three inputs),
//   held as loaded (bf16: 4 registers for 8 channels) until used;
// - one wave of blocks (as many as the SMs hold), each a contiguous chunk of
//   rows;
// - sigmoid and tanh from the hardware's exp2 and a rounded reciprocal, in
//   place of the longer expf / tanhf.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 8 * kThreads;
constexpr int kAct = 0, kGate = 1, kUpdate = 2;

struct EpilogueArgs {
  long P;                  // pixel rows
  int C;                   // channels
  const void* a; long sa;  // ACT x, GATE z, UPDATE q (raw conv outputs)
  const void* b; long sb;  // GATE r (raw), UPDATE sigmoid(z)
  const void* h; long sh;  // GATE / UPDATE h
  const void* bias0;       // ACT x's, GATE z's, UPDATE q's
  const void* bias1;       // GATE r's
  int bias_f32;            // biases fp32 (else the tensors' dtype)
  void* o0; long so0;      // ACT out, GATE sigmoid(z), UPDATE h'
  void* o1; long so1;      // GATE r * h, UPDATE h' again
  int relu;
  float scale;
  int vec;  // bit per tensor (a, b, h, o0, o1): 16-byte vectors (vector_bits)
};

// G groups of 8 channels, RP rows a pass; rows [blockIdx.x * chunk, + chunk).
struct RowMap {
  int G, RP;
  long chunk;
};

int epilogue_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 64) dev = 63;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 8 channels as loaded, converted to fp32 only when used: in bf16 one
// 16-byte vector (4 registers), in fp32 two.
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};

// 8 channels at p; n < 8 (the tail group) or !vec reads them one by one, 0 past n.
__device__ __forceinline__ void load8(const float* p, int n, bool vec, Raw8<float>& r) {
  if (vec && n == 8) {
    r.a = *reinterpret_cast<const float4*>(p);
    r.b = *reinterpret_cast<const float4*>(p + 4);
  } else {
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = i < n ? p[i] : 0.f;
    r.a = make_float4(t[0], t[1], t[2], t[3]);
    r.b = make_float4(t[4], t[5], t[6], t[7]);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, bool vec,
                                      Raw8<__nv_bfloat16>& r) {
  if (vec && n == 8) {
    r.u = *reinterpret_cast<const uint4*>(p);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = 2 * i < n ? __bfloat16_as_ushort(p[2 * i]) : 0u;
      const unsigned hi = 2 * i + 1 < n ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
      w[i] = lo | (hi << 16);
    }
    r.u = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void to_f32(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ void to_f32(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, bool vec, float (&v)[8]) {
  Raw8<T> r;
  load8(p, n, vec, r);
  to_f32(r, v);
}

__device__ __forceinline__ void store8(float* p, int n, bool vec, const float (&v)[8]) {
  if (vec && n == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = v[i];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int n, bool vec, const float (&v)[8]) {
  if (vec && n == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// The hardware's exp2 (a few ulps) and a correctly rounded reciprocal: far
// below bf16's rounding, and within 1e-6 of ATen's fp32 sigmoid and tanh.
// Both saturate to the right limit: 1 / inf = 0.
__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - 2.f * __frcp_rn(__expf(2.f * v) + 1.f);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    update_epilogue_kernel(EpilogueArgs e, RowMap map) {
  constexpr int U = MODE == kAct ? 4 : 2;  // rows in flight a thread
  const int tg = threadIdx.x % map.G;
  const int tr = threadIdx.x / map.G;
  if (tr >= map.RP) return;
  const int c0 = tg * 8;
  const int n = min(8, e.C - c0);
  const T* A = static_cast<const T*>(e.a) + c0;
  const T* B = static_cast<const T*>(e.b) + c0;
  const T* H = static_cast<const T*>(e.h) + c0;
  T* O0 = static_cast<T*>(e.o0) + c0;
  T* O1 = static_cast<T*>(e.o1) + c0;
  const bool va = e.vec & 1, vb = e.vec & 2, vh = e.vec & 4, vo0 = e.vec & 8, vo1 = e.vec & 16;
  float b0[8], b1[8];
  if (e.bias_f32) {
    load8(static_cast<const float*>(e.bias0) + c0, n, false, b0);
    if (MODE == kGate) load8(static_cast<const float*>(e.bias1) + c0, n, false, b1);
  } else {
    load8(static_cast<const T*>(e.bias0) + c0, n, false, b0);
    if (MODE == kGate) load8(static_cast<const T*>(e.bias1) + c0, n, false, b1);
  }
  const long m1 = min(e.P, ((long)blockIdx.x + 1) * map.chunk);
  for (long m = (long)blockIdx.x * map.chunk + tr; m < m1; m += (long)U * map.RP) {
    Raw8<T> xr[U], yr[U], hr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long p = m + (long)u * map.RP;
      if (p < m1) {
        load8(A + p * e.sa, n, va, xr[u]);
        if (MODE != kAct) {
          load8(B + p * e.sb, n, vb, yr[u]);
          load8(H + p * e.sh, n, vh, hr[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long p = m + (long)u * map.RP;
      if (p >= m1) continue;
      float x[8], y[8], h[8];
      to_f32(xr[u], x);
      if (MODE == kAct) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = x[i] + b0[i];
          if (e.relu) v = v < 0.f ? 0.f : v;
          x[i] = v * e.scale;
        }
        store8(O0 + p * e.so0, n, vo0, x);
        continue;
      }
      to_f32(yr[u], y);
      to_f32(hr[u], h);
      if (MODE == kGate) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = sigmoid(x[i] + b0[i]);
          y[i] = sigmoid(y[i] + b1[i]) * h[i];
        }
        store8(O0 + p * e.so0, n, vo0, x);
        store8(O1 + p * e.so1, n, vo1, y);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = (1.f - y[i]) * h[i] + y[i] * tanh_fast(x[i] + b0[i]);
        store8(O0 + p * e.so0, n, vo0, x);
        store8(O1 + p * e.so1, n, vo1, x);
      }
    }
  }
}

// The 16-byte vector bit of each tensor (EpilogueArgs::vec): its pointer
// 16-byte aligned and its row stride a whole number of 16 bytes.
int vector_bits(const EpilogueArgs& e, int elem) {
  const void* ptrs[5] = {e.a, e.b, e.h, e.o0, e.o1};
  const long strides[5] = {e.sa, e.sb, e.sh, e.so0, e.so1};
  int bits = 0;
  for (int i = 0; i < 5; ++i)
    if (aligned16(ptrs[i]) && (strides[i] * elem) % 16 == 0) bits |= 1 << i;
  return bits;
}

// Blocks of kThreads resident on one SM, asked once a kernel.
template <typename T, int MODE>
int blocks_per_sm() {
  static int n = 0;
  if (n == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, update_epilogue_kernel<T, MODE>, kThreads, 0) != cudaSuccess)
    n = 0;
  return n > 0 ? n : 1;
}

// One wave: as many blocks as the SMs hold, each a contiguous chunk of rows
// (a whole number of U-row passes where the rows allow it).
template <typename T, int MODE>
cudaError_t launch(EpilogueArgs e, cudaStream_t stream) {
  constexpr int U = MODE == kAct ? 4 : 2;
  e.vec = vector_bits(e, (int)sizeof(T));
  RowMap map;
  map.G = (e.C + 7) / 8;
  map.RP = kThreads / map.G;
  const long want = (long)(epilogue_sms() > 0 ? epilogue_sms() : 1) * blocks_per_sm<T, MODE>();
  const long chunk = (e.P + want - 1) / want;
  const long step = chunk >= (long)map.RP * U ? (long)map.RP * U : map.RP;
  map.chunk = (chunk + step - 1) / step * step;
  const long blocks = (e.P + map.chunk - 1) / map.chunk;
  update_epilogue_kernel<T, MODE><<<(unsigned)blocks, map.G * map.RP, 0, stream>>>(e, map);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const EpilogueArgs& e, int mode, cudaStream_t stream) {
  if (mode == kAct) return launch<T, kAct>(e, stream);
  if (mode == kGate) return launch<T, kGate>(e, stream);
  return launch<T, kUpdate>(e, stream);
}

}  // namespace

extern "C" {

// mode 0 (ACT): a = x, bias0, o0 = out, relu, scale;
// mode 1 (GATE): a = z, b = r, h, bias0 = bz, bias1 = br, o0 = sigmoid(z), o1 = r * h;
// mode 2 (UPDATE): a = q, b = sigmoid(z), h, bias0 = bq, o0 = o1 = h'.
// Biases [C] in bias_dtype: fp32 or dtype; strides in elements. Unused
// pointers may be null. Refuses (cudaErrorInvalidValue) a mode, dtype, bias
// dtype, P or C out of range.
int fst_update_epilogue(int mode, int dtype, int bias_dtype, long P, int C, const void* a,
                        long sa, const void* b, long sb, const void* h, long sh,
                        const void* bias0, const void* bias1, void* o0, long so0, void* o1,
                        long so1, int relu, float scale, void* stream) {
  if (mode < kAct || mode > kUpdate || P <= 0 || C <= 0 || C > kMaxChannels ||
      (dtype != FST_F32 && dtype != FST_BF16) || (bias_dtype != FST_F32 && bias_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  const EpilogueArgs e{P,  C,   a,  sa,  b,    sb,    h, sh, bias0, bias1, bias_dtype == FST_F32,
                       o0, so0, o1, so1, relu, scale, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == FST_BF16 ? launch_mode<__nv_bfloat16>(e, mode, s)
                                            : launch_mode<float>(e, mode, s);
  return (int)err;
}

}  // extern "C"
