// Variants of K6 / K7 (csrc/corr_fused.cu) for the A/B timing of
// flow_supervisor_tpu_torch/probe_k7.py; not part of the kernel library.
// bf16 in and out, C % 8 == 0. Each runs either as K7 (one launch per level
// of [level0, level1)) or as K6 (one launch for all levels).
//
//   0  the first K6 / K7: one warp per query, each query gathering its own
//      (2r+2)^2 support rows (the library's per-query body, 8 queries a block)
//   1  the tile design, 8x8 query tiles, S = f1_tile . f2_box^T on the CUDA
//      cores in fp32 (the library's body for fp32 or C % 8 != 0)
//   2  the library's: 1 with the product on the tensor cores (mma.sync), the
//      tile's f1 in registers, the passes double-buffered
//   3  the step before 2: f1 read from shared memory by every pass, one pass
//      buffer (each pass waits for its rows)
//   4  3 with 8x16 tiles (16 queries wide, 8 high)
//   5  a diagnostic: 2 without its combine (no output is written)
//   6  a diagnostic: 2 without its product (the combine of zero supports)
//   7  a diagnostic: 2's prologue alone (tile, windows and box)
//   8  a diagnostic: 2 without the mma.sync (the supports add zeros)
//   9  a diagnostic: 2 without the adds into the supports
// 5-9 are for the shares of 2's time; their outputs are not checked.
#include <stdint.h>

#include "../corr_fused.cu"

namespace k7probe {

using bf16 = __nv_bfloat16;

// ---- 0: the first design ----
__global__ void __launch_bounds__(kWarps * 32)
    first_all_kernel(const bf16* __restrict__ f1, Levels lv, int levels,
                     const float* __restrict__ coords, bf16* __restrict__ out, int bq, int q_per_b,
                     int C, int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;
  float* sup = smem + warp * support_slots(radius);
  const long b = q / q_per_b;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  for (int l = 0; l < levels; ++l) {
    const float scale = 1.0f / (float)(1 << l);
    const long plane = (long)lv.h2[l] * lv.w2[l] * C;
    lookup_level<bf16, bf16, true>(f1 + q * C, static_cast<const bf16*>(lv.f2[l]) + b * plane,
                                   lv.h2[l], lv.w2[l], C, coords[2 * q] * scale,
                                   coords[2 * q + 1] * scale, radius, sup,
                                   out + q * (long)levels * k2, l * k2, lane);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    first_level_kernel(const bf16* __restrict__ f1, const bf16* __restrict__ f2, int h2, int w2,
                       int level, const float* __restrict__ coords, bf16* __restrict__ out,
                       int out_stride, int bq, int q_per_b, int C, int radius) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long q = (long)blockIdx.x * kWarps + warp;
  if (q >= bq) return;
  float* sup = smem + warp * support_slots(radius);
  const long b = q / q_per_b;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const float scale = 1.0f / (float)(1 << level);
  lookup_level<bf16, bf16, true>(f1 + q * C, f2 + b * (long)h2 * w2 * C, h2, w2, C,
                                 coords[2 * q] * scale, coords[2 * q + 1] * scale, radius, sup,
                                 out + q * (long)out_stride, level * k2, lane);
}

// ---- 3, 4: one pass buffer, f1 from shared memory ----
template <int TQ>
__device__ void contract_tc_single(const bf16* __restrict__ f1, const bf16* __restrict__ f2b,
                                   const Tile& t, const TileSmem& ts, float* smem, int C,
                                   int radius) {
  constexpr int MT = TQ / 16;               // m-tiles of 16 queries
  constexpr int WPM = kWarps / MT;          // warps per m-tile
  constexpr int NTW = kPassTaps / 8 / WPM;  // n-tiles of 8 taps per warp
  static_assert(kWarps % MT == 0 && NTW % 2 == 0, "warps cover the pass in pairs of n-tiles");
  bf16* f1h = reinterpret_cast<bf16*>(smem);
  bf16* f2h = f1h + TQ * kTcStride;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int A = t.bw * t.bh;
  const int mt = warp / WPM;
  const int n0 = (warp % WPM) * NTW * 8;
  const int qa = mt * 16 + lane / 4;
  const int nchunks = (C + kTcChunkC - 1) / kTcChunkC;
  for (int cc = 0; cc < nchunks; ++cc) {
    const float root_c = cc + 1 == nchunks ? sqrtf((float)C) : 0.f;
    for (int e = tid; e < TQ * 32; e += kThreads) {
      const int r = e / 32;
      const int c = cc * kTcChunkC + (e % 32) * 8;
      const long row = ts.qrow[r];
      const bool in = row >= 0 && c < C;
      cp_async16(f1h + r * kTcStride + (e % 32) * 8, in ? f1 + row * C + c : f1, in ? 16 : 0);
    }
    const int ksteps = (min(kTcChunkC, C - cc * kTcChunkC) + 15) / 16;
    for (int a0 = 0; a0 < A; a0 += kPassTaps) {
      stage_pass(f2h, f2b, t, a0, cc, C);
      cp_async_wait_all();
      __syncthreads();
      float acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 16;
        unsigned af[4];
        ldsm_x4(f1h + (mt * 16 + lane % 16) * kTcStride + k0 + (lane / 16) * 8, af);
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          unsigned bf[4];
          ldsm_x4(f2h + (n0 + p * 16 + (lane / 16) * 8 + lane % 8) * kTcStride + k0 +
                      ((lane / 8) % 2) * 8,
                  bf);
          mma_bf16(acc[2 * p], af, bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = a0 + n0 + nt * 8 + 2 * (lane % 4) + h;
          if (a < A) {
            const int y = t.y0 + a / t.bw;
            const int x = t.x0 + a % t.bw;
            add_to_support(ts, ns, sp, qa, ts.qbx[qa], ts.qby[qa], y, x, acc[nt][h], root_c);
            add_to_support(ts, ns, sp, qa + 8, ts.qbx[qa + 8], ts.qby[qa + 8], y, x, acc[nt][2 + h],
                           root_c);
          }
        }
      }
      __syncthreads();
    }
  }
}

// ---- 8, 9: the library's tensor-core body without a part ----
template <int TQ, int SKIP>
__device__ void contract_tc_skip(const __nv_bfloat16* __restrict__ f1,
                                 const __nv_bfloat16* __restrict__ f2b, const Tile& t,
                                 const TileSmem& ts, float* smem, int C, int radius) {
  using bf16 = __nv_bfloat16;
  constexpr int KSTEPS = kTcChunkC / 16;
  constexpr int NTW = kPassTaps / 8 / 2;  // n-tiles of 8 taps per warp
  static_assert(TQ == 64 && kWarps == 8 && TQ == kPassTaps,
                "8 warps: 4 m-tiles of 16 queries x 2 halves of the pass; f1 and a pass fill one buffer");
  bf16* const buf[2] = {reinterpret_cast<bf16*>(smem) + TQ * kTcStride, reinterpret_cast<bf16*>(smem)};
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int A = t.bw * t.bh;
  const int passes = (A + kPassTaps - 1) / kPassTaps;
  const int mt = warp / 2;
  const int n0 = (warp % 2) * NTW * 8;
  const int qa = mt * 16 + lane / 4;  // the lane's accumulator rows qa and qa + 8
  const int bxa = ts.qbx[qa], bya = ts.qby[qa], bxb = ts.qbx[qa + 8], byb = ts.qby[qa + 8];
  const int nchunks = (C + kTcChunkC - 1) / kTcChunkC;
  for (int cc = 0; cc < nchunks; ++cc) {
    const float root_c = cc + 1 == nchunks ? sqrtf((float)C) : 0.f;
    const int ksteps = (min(kTcChunkC, C - cc * kTcChunkC) + 15) / 16;
    // f1's chunk into buf[1] (a warp stages a query's row), the first pass into buf[0]
    const int c = cc * kTcChunkC + lane * 8;
    for (int r = warp; r < TQ; r += kWarps) {
      const long row = ts.qrow[r];
      const bool in = row >= 0 && c < C;
      cp_async16(buf[1] + r * kTcStride + lane * 8, in ? f1 + row * C + c : f1, in ? 16 : 0);
    }
    stage_pass(buf[0], f2b, t, 0, cc, C);
    cp_async_wait_all();
    __syncthreads();
    unsigned af[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks < ksteps) ldsm_x4(buf[1] + (mt * 16 + lane % 16) * kTcStride + ks * 16 + (lane / 16) * 8, af[ks]);
    }
    __syncthreads();  // buf[1] takes the second pass
    for (int p = 0; p < passes; ++p) {
      if (p + 1 < passes) {
        stage_pass(buf[(p + 1) % 2], f2b, t, (p + 1) * kPassTaps, cc, C);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* cur = buf[p % 2];
      float acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if (ks < ksteps) {
          unsigned bf[NTW / 2][4];  // b0, b1 of n-tiles 2j and 2j + 1: the pass's rows are B's columns
#pragma unroll
          for (int j = 0; j < NTW / 2; ++j) {
            ldsm_x4(cur + (n0 + j * 16 + (lane / 16) * 8 + lane % 8) * kTcStride + ks * 16 +
                        ((lane / 8) % 2) * 8,
                    bf[j]);
          }
          if (SKIP != 8) {
#pragma unroll
            for (int j = 0; j < NTW / 2; ++j) {
              mma_bf16(acc[2 * j], af[ks], bf[j][0], bf[j][1]);
              mma_bf16(acc[2 * j + 1], af[ks], bf[j][2], bf[j][3]);
            }
          }
        }
      }
      // acc[nt] holds (query qa, taps n0 + 8 nt + 2 (lane % 4) + {0, 1}) and
      // the same for query qa + 8
      if (SKIP == 9) {  // keep the product alive: one add per lane
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) sum += acc[nt][0] + acc[nt][1] + acc[nt][2] + acc[nt][3];
        ts.sup[tid] += sum;
      }
#pragma unroll
      for (int nt = 0; nt < NTW && SKIP != 9; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = p * kPassTaps + n0 + nt * 8 + 2 * (lane % 4) + h;
          if (a < A) {
            int y, x;
            box_tap(t, a, y, x);
            add_to_support(ts, ns, sp, qa, bxa, bya, y, x, acc[nt][h], root_c);
            add_to_support(ts, ns, sp, qa + 8, bxb, byb, y, x, acc[nt][2 + h], root_c);
          }
        }
      }
      __syncthreads();  // buf[p % 2] takes pass p + 2 (or the next chunk's f1)
    }
  }
}

// ---- 3-9: bodies built from the library's parts ----
// PART 3: prologue, contract_tc_single, combine; 5: the library's without the
// combine; 6: without the product; 7: the prologue alone; 8, 9: the library's
// with contract_tc_skip.
template <int PART, int TY, int TX>
__global__ void __launch_bounds__(kThreads, 2)
    part_kernel(const bf16* __restrict__ f1, Levels lv, int level0, QueryGrid grid, int batch,
                const float* __restrict__ coords, bf16* __restrict__ out, int out_stride,
                int q_per_b, int C, int radius) {
  constexpr int TQ = TY * TX;
  extern __shared__ __align__(16) float smem[];
  const int ns = (2 * radius + 2) * (2 * radius + 2);
  const TileSmem ts = tile_smem<TQ>(smem + tile_operand_words(TQ, true), ns);
  const Tile t = tile_prologue<TY, TX>(lv, level0, grid, batch, coords, q_per_b, radius, ts);
  if (PART == 7) return;
  const bf16* f2b = static_cast<const bf16*>(t.f2) + (long)t.b * t.h2 * t.w2 * C;
  const int ch0 = t.l * (2 * radius + 1) * (2 * radius + 1);
  if (t.nvalid > 0 && t.bw * t.bh > kMaxBoxTaps) {
    if (PART == 3) tile_per_query<bf16, bf16, true, TQ>(f1, f2b, t, ts, coords, out, out_stride, ch0, C, radius);
    return;
  }
  if (t.nvalid > 0) {
    if constexpr (PART == 3) contract_tc_single<TQ>(f1, f2b, t, ts, smem, C, radius);
    if constexpr (PART == 5) tile_contract_tc<TQ>(f1, f2b, t, ts, smem, C, radius);
    if constexpr (PART == 8 || PART == 9) contract_tc_skip<TQ, PART>(f1, f2b, t, ts, smem, C, radius);
  }
  if (PART == 3 || PART == 6 || PART == 8 || PART == 9) {
    __syncthreads();
    tile_combine<bf16, TQ>(ts, out, out_stride, ch0, radius);
  }
}

template <int PART, int TY = kTileY, int TX = kTileX>
cudaError_t launch_part(const void* f1, const Levels& lv, int nlev, int level0, int h1, int w1,
                        const float* coords, void* out, int out_stride, int bq, int q_per_b, int C,
                        int radius, cudaStream_t s) {
  const QueryGrid grid = query_grid<TY, TX>(q_per_b, h1, w1);
  const long blocks = (long)nlev * (bq / q_per_b) * grid.tiles_y * grid.tiles_x;
  const long smem = tile_smem_words(TY * TX, true, radius) * (long)sizeof(float);
  auto kernel = part_kernel<PART, TY, TX>;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(static_cast<const bf16*>(f1), lv, level0, grid,
                                                  bq / q_per_b, coords, static_cast<bf16*>(out),
                                                  out_stride, q_per_b, C, radius);
  return cudaGetLastError();
}

cudaError_t launch_variant(int variant, bool all, const void* f1, const Levels& lv, int nlev,
                           int level0, int h1, int w1, const float* coords, void* out,
                           int out_stride, int bq, int q_per_b, int C, int radius,
                           cudaStream_t s) {
  if (variant == 0) {
    const int blocks = (bq + kWarps - 1) / kWarps;
    const size_t smem = (size_t)kWarps * support_slots(radius) * sizeof(float);
    if (all) {
      first_all_kernel<<<blocks, kWarps * 32, smem, s>>>(static_cast<const bf16*>(f1), lv, nlev,
                                                         coords, static_cast<bf16*>(out), bq,
                                                         q_per_b, C, radius);
    } else {
      first_level_kernel<<<blocks, kWarps * 32, smem, s>>>(
          static_cast<const bf16*>(f1), static_cast<const bf16*>(lv.f2[0]), lv.h2[0], lv.w2[0],
          level0, coords, static_cast<bf16*>(out), out_stride, bq, q_per_b, C, radius);
    }
    return cudaGetLastError();
  }
  if (variant == 1) {
    return launch_tiles<bf16, bf16, true, 8, 8, false>(all, f1, lv, nlev, level0, h1, w1, coords,
                                                       out, out_stride, bq, q_per_b, C, radius, s);
  }
  if (variant == 2) {
    return launch_tiles<bf16, bf16, true>(all, f1, lv, nlev, level0, h1, w1, coords, out,
                                          out_stride, bq, q_per_b, C, radius, s);
  }
  if (variant == 3) {
    return launch_part<3>(f1, lv, nlev, level0, h1, w1, coords, out, out_stride, bq, q_per_b, C,
                          radius, s);
  }
  if (variant == 4) {
    return launch_part<3, 8, 16>(f1, lv, nlev, level0, h1, w1, coords, out, out_stride, bq,
                                 q_per_b, C, radius, s);
  }
  if (variant >= 5 && variant <= 9) {
    auto launch = variant == 5   ? launch_part<5>
                  : variant == 6 ? launch_part<6>
                  : variant == 7 ? launch_part<7>
                  : variant == 8 ? launch_part<8>
                                 : launch_part<9>;
    return launch(f1, lv, nlev, level0, h1, w1, coords, out, out_stride, bq, q_per_b, C, radius,
                  s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace k7probe

extern "C" {

// The probe's one entry: variant (above) as K6 (all != 0: every level in one
// launch) or as K7 (one launch per level of [level0, level1)); bf16 f1, f2
// and out [bq, levels * (2r+1)^2], C % 8 == 0, 16-byte aligned rows.
int k7_probe(int variant, int all, const void* f1, const void* const* f2, const int* h2,
             const int* w2, int levels, int level0, int level1, int h1, int w1,
             const void* coords, void* out, int bq, int q_per_b, int C, int radius,
             void* stream) {
  if (levels < 1 || levels > kMaxLevels || level0 < 0 || level1 > levels || level0 >= level1 ||
      C % 8 != 0 || !valid_args(bq, q_per_b, h1, w1, C, radius)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  const int stride = levels * (2 * radius + 1) * (2 * radius + 1);
  Levels lv;
  if (all) {
    for (int l = 0; l < levels; ++l) {
      lv.f2[l] = f2[l];
      lv.h2[l] = h2[l];
      lv.w2[l] = w2[l];
    }
    return (int)k7probe::launch_variant(variant, true, f1, lv, levels, 0, h1, w1, c, out, stride,
                                        bq, q_per_b, C, radius, s);
  }
  for (int l = level0; l < level1; ++l) {
    lv.f2[0] = f2[l];
    lv.h2[0] = h2[l];
    lv.w2[0] = w2[l];
    const cudaError_t err = k7probe::launch_variant(variant, false, f1, lv, 1, l, h1, w1, c, out,
                                                    stride, bq, q_per_b, C, radius, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
