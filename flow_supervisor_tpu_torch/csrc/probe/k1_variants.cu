// Variants of K1 (csrc/corr_plane.cu) for the A/B timing of
// flow_supervisor_tpu_torch/probe_k1.py; not part of the kernel library.
// Radius 4, bf16 planes and output, as on the plane backend's main path.
//
//   0  the first K1: one thread per output element, 4 loads each
//   1  one warp per query, support loaded straight into shared memory,
//      one 2-byte store per output, 8 warps a block: csrc/corr_plane.cu's
//      design, written in this file's style (ptxas gives it 40 registers,
//      the library's body 32), so that each later switch changes one thing
//   2  1 + all levels' loads staged in registers before the first store
//   3  2 + the output row staged and written with 16-byte stores
//   4  3 with 16 warps a block
//   5  3 as persistent warps: as many blocks as fit at once, each warp
//      loads query i+1's support into registers while it combines query i
//   6  1 + the wide output row, with the support rows staged by cp.async as
//      the aligned 4-byte words that cover each row
//   7  csrc/window.cuh's body (the library's K1) with the radius as an argument
//   8  1 with 4 warps a block
//   9  1 with 16 warps a block
//  10  1 + the wide output row of 3
#include <stdint.h>

#include "../corr_plane.cu"

namespace k1probe {


constexpr int kMaxLevels = 8;
constexpr int R = 4;
constexpr int S = 2 * R + 2;
constexpr int SP = S + 1;
constexpr int SS = S * S;
constexpr int kSlots = (SS + 31) / 32;
constexpr int K = 2 * R + 1;
constexpr int K2 = K * K;
using bf16 = __nv_bfloat16;

struct Levels {
  const void* plane[kMaxLevels];
  int h2[kMaxLevels];
  int w2[kMaxLevels];
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }
// variant 6 keeps each support row as 6 words (12 bf16 slots), the rest fp32
__host__ __device__ inline int support_bytes(int levels, bool words) {
  return round16(words ? levels * S * 6 * 4 : levels * S * SP * 4);
}
__host__ __device__ inline int warp_bytes(int levels, bool words) {
  return support_bytes(levels, words) + round16(16 + levels * K2 * 2);
}

__global__ void old_kernel(Levels lv, int levels, const float* __restrict__ coords,
                           bf16* __restrict__ out, int bq) {
  const int row = levels * K2;
  const long total = (long)bq * row;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long)gridDim.x * blockDim.x) {
    const long q = idx / row;
    const int ch = (int)(idx % row);
    const int l = ch / K2;
    const int t = ch % K2;
    const int ix = t / K;
    const int iy = t % K;
    const bf16* plane = static_cast<const bf16*>(lv.plane[l]);
    const int h2 = lv.h2[l];
    const int w2 = lv.w2[l];
    const float scale = 1.0f / (float)(1 << l);
    const float cx = coords[2 * q] * scale;
    const float cy = coords[2 * q + 1] * scale;
    const float flx = floorf(cx);
    const float fly = floorf(cy);
    const float fx = cx - flx;
    const float fy = cy - fly;
    const int bx = (int)fminf(fmaxf(flx - R, -(float)S), (float)w2);
    const int by = (int)fminf(fmaxf(fly - R, -(float)S), (float)h2);
    const int x0 = bx + ix;
    const int y0 = by + iy;
    const bf16* base = plane + q * (long)h2 * w2;
    float p[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int yy = y0 + a;
        const int xx = x0 + c;
        p[a][c] = (yy >= 0 && yy < h2 && xx >= 0 && xx < w2)
                      ? fst_load(base, (long)yy * w2 + xx)
                      : 0.f;
      }
    }
    const float v = (1.f - fy) * (1.f - fx) * p[0][0] + (1.f - fy) * fx * p[0][1] +
                    fy * (1.f - fx) * p[1][0] + fy * fx * p[1][1];
    fst_store(out, idx, v);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 4 : 0;  // 0 source bytes: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

template <int kW, bool kReg, bool kWide, bool kPersist, bool kCp>
__global__ void __launch_bounds__(kW * 32)
variant_kernel(Levels lv, int levels, const float* __restrict__ coords, bf16* __restrict__ out,
               int bq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = levels * K2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int q = blockIdx.x * kW + warp;
  if (q >= bq) return;
  const int step = kPersist ? gridDim.x * kW : bq;
  unsigned char* base = smem + warp * warp_bytes(levels, kCp);
  float* sup = reinterpret_cast<float*>(base);
  unsigned char* stage = base + support_bytes(levels, kCp);

  float v[kMaxLevels][kSlots];
  auto fetch = [&](int qq, float qx, float qy) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < levels) {
        const float scale = 1.f / (float)(1 << l);
        const int h2 = lv.h2[l];
        const int w2 = lv.w2[l];
        const int bx = (int)fminf(fmaxf(floorf(qx * scale) - R, -(float)S), (float)w2);
        const int by = (int)fminf(fmaxf(floorf(qy * scale) - R, -(float)S), (float)h2);
        const bf16* plane = static_cast<const bf16*>(lv.plane[l]) + (long)qq * h2 * w2;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int t = lane + 32 * j;
          const int y = by + t / S;
          const int x = bx + t % S;
          const bool ok = t < SS && y >= 0 && y < h2 && x >= 0 && x < w2;
          if (kReg) {
            v[l][j] = ok ? fst_load(plane, (long)y * w2 + x) : 0.f;
          } else if (t < SS) {
            sup[(l * S + t / S) * SP + t % S] = ok ? fst_load(plane, (long)y * w2 + x) : 0.f;
          }
        }
      }
    }
  };
  // variant 6: words [l][u][0..5] are the aligned words that cover support
  // row u of level l, from the word of its first element e on; element c of
  // the row is bf16 slot (e & 1) + c. Words with no element of the plane row
  // are zero-filled; taps outside the plane are masked when read.
  auto fetch_words = [&](int qq, float qx, float qy) {
    unsigned* words = reinterpret_cast<unsigned*>(sup);
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < levels) {
        const float scale = 1.f / (float)(1 << l);
        const int h2 = lv.h2[l];
        const int w2 = lv.w2[l];
        const int bx = (int)fminf(fmaxf(floorf(qx * scale) - R, -(float)S), (float)w2);
        const int by = (int)fminf(fmaxf(floorf(qy * scale) - R, -(float)S), (float)h2);
        const bf16* plane = static_cast<const bf16*>(lv.plane[l]);
        const long pb = (long)qq * h2 * w2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = lane + 32 * j;
          if (t < S * 6) {
            const int u = t / 6;
            const int wi = t - u * 6;
            const int y = by + u;
            const long rs = pb + (long)y * w2;  // the plane row's first element
            const long ew = 2 * ((rs + bx) >> 1) + 2 * wi;
            const bool in = y >= 0 && y < h2 && ew + 1 >= rs && ew < rs + w2;
            cp_async4(words + (l * S + u) * 6 + wi, plane + (in ? ew : 0), in);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  };

  float qx = coords[2L * q];
  float qy = coords[2L * q + 1];
  if (kReg && !kCp) fetch(q, qx, qy);
  while (true) {
    if (kCp) {
      fetch_words(q, qx, qy);
    } else if (kReg) {
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
    } else {
      fetch(q, qx, qy);
    }
    __syncwarp();
    const int qn = q + step;
    float nx = 0.f, ny = 0.f;
    if (kPersist && qn < bq) {
      nx = coords[2L * qn];
      ny = coords[2L * qn + 1];
      fetch(qn, nx, ny);
    }
    bf16* dst = out + (long)q * row;
    const int mis = kWide ? (int)(reinterpret_cast<uintptr_t>(dst) & 15) : 0;
    bf16* srow = kWide ? reinterpret_cast<bf16*>(stage + mis) : dst;
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
        const int h2 = lv.h2[l];
        const int w2 = lv.w2[l];
        const int bx = (int)fminf(fmaxf(floorf(cx) - R, -(float)S), (float)w2);
        const int by = (int)fminf(fmaxf(floorf(cy) - R, -(float)S), (float)h2);
#pragma unroll
        for (int m = 0; m < (K2 + 31) / 32; ++m) {
          const int o = lane + 32 * m;
          if (o < K2) {
            const int dx = o / K;
            const int dy = o - dx * K;
            float p00, p01, p10, p11;
            if (kCp) {
              auto tap = [&](int u, int c) -> float {
                const int y = by + u;
                const int x = bx + c;
                if (y < 0 || y >= h2 || x < 0 || x >= w2) return 0.f;
                const long e = (long)q * h2 * w2 + (long)y * w2 + bx;
                const bf16* w = reinterpret_cast<const bf16*>(sup) + (l * S + u) * 12;
                return __bfloat162float(w[(int)(e & 1) + c]);
              };
              p00 = tap(dy, dx);
              p01 = tap(dy, dx + 1);
              p10 = tap(dy + 1, dx);
              p11 = tap(dy + 1, dx + 1);
            } else {
              const float* p = ps + dy * SP + dx;
              p00 = p[0];
              p01 = p[1];
              p10 = p[SP];
              p11 = p[SP + 1];
            }
            const float acc = __fadd_rn(
                __fadd_rn(__fadd_rn(__fmul_rn(w00, p00), __fmul_rn(w01, p01)),
                          __fmul_rn(w10, p10)),
                __fmul_rn(w11, p11));
            fst_store(srow, l * K2 + o, acc);
          }
        }
      }
    }
    __syncwarp();
    if (kWide) {
      const int end = mis + row * 2;
      unsigned char* d16 = reinterpret_cast<unsigned char*>(dst) - mis;
      for (int lo = lane * 16; lo < end; lo += 32 * 16) {
        if (lo >= mis && lo + 16 <= end) {
          *reinterpret_cast<uint4*>(d16 + lo) = *reinterpret_cast<const uint4*>(stage + lo);
        } else {
          for (int b = lo > mis ? lo : mis; b < lo + 16 && b < end; b += 2) {
            *reinterpret_cast<bf16*>(d16 + b) = *reinterpret_cast<const bf16*>(stage + b);
          }
        }
      }
    }
    if (qn >= bq) break;
    q = qn;
    qx = nx;
    qy = ny;
  }
}

template <int kW, bool kReg, bool kWide, bool kPersist, bool kCp>
cudaError_t run(const Levels& lv, int levels, const float* c, bf16* o, int bq, cudaStream_t s) {
  auto kernel = variant_kernel<kW, kReg, kWide, kPersist, kCp>;
  const int smem = kW * warp_bytes(levels, kCp);
  int blocks = (bq + kW - 1) / kW;
  if (kPersist) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kW * 32, smem);
    if (per_sm * sms < blocks) blocks = per_sm * sms;
  }
  kernel<<<blocks, kW * 32, smem, s>>>(lv, levels, c, o, bq);
  return cudaGetLastError();
}

int dispatch(int variant, const void* const* planes, const int* h2, const int* w2, int levels,
             const void* coords, void* out, int bq, void* stream) {
  if (levels < 1 || levels > kMaxLevels || bq < 1) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < levels; ++l) {
    lv.plane[l] = planes[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(coords);
  bf16* o = static_cast<bf16*>(out);
  switch (variant) {
    case 0: {
      const long total = (long)bq * levels * K2;
      const long want = (total + 255) / 256;
      old_kernel<<<(int)(want < 132L * 64 ? want : 132L * 64), 256, 0, s>>>(lv, levels, c, o, bq);
      return (int)cudaGetLastError();
    }
    case 1: return (int)run<8, false, false, false, false>(lv, levels, c, o, bq, s);
    case 2: return (int)run<8, true, false, false, false>(lv, levels, c, o, bq, s);
    case 3: return (int)run<8, true, true, false, false>(lv, levels, c, o, bq, s);
    case 4: return (int)run<16, true, true, false, false>(lv, levels, c, o, bq, s);
    case 5: return (int)run<8, true, true, true, false>(lv, levels, c, o, bq, s);
    case 6: return (int)run<8, false, true, false, true>(lv, levels, c, o, bq, s);
    case 7: {
      ::Levels lib;
      for (int l = 0; l < levels; ++l) {
        lib.plane[l] = planes[l];
        lib.h2[l] = h2[l];
        lib.w2[l] = w2[l];
      }
      return (int)::window_launch<bf16, bf16, -1, ::kWindowMode>(lib, levels, c, o, bq, R, s);
    }
    case 8: return (int)run<4, false, false, false, false>(lv, levels, c, o, bq, s);
    case 9: return (int)run<16, false, false, false, false>(lv, levels, c, o, bq, s);
    case 10: return (int)run<8, false, true, false, false>(lv, levels, c, o, bq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k1probe

extern "C" {

int k1_probe(int variant, const void* const* planes, const int* h2, const int* w2, int levels,
             const void* coords, void* out, int bq, void* stream) {
  return k1probe::dispatch(variant, planes, h2, w2, levels, coords, out, bq, stream);
}

}  // extern "C"
