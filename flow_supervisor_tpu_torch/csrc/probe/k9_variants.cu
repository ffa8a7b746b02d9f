// Variants of K9 (csrc/corr_fused_bwd.cu) for the A/B timing of
// flow_supervisor_tpu_torch/probe_k9.py; not part of the kernel library.
// Each runs over levels [level0, level1), so that levels time alone.
//
//   0  the first K9: one warp per (query, level), every valid tap
//      adds the query's f1 row with two 16-byte atomics per lane
//   1  the tile design, 8x8 query tiles, D^T . f1 on the CUDA cores in fp32
//      (the library's body for fp32 f1)
//   2  1 with 16x8 tiles (16 queries wide, 8 high)
//   3  the library's K9: 1 with the contraction on the tensor cores for bf16
//      f1 (mma.sync m16n8k16, D split into a bf16 high and low part)
//   4  a diagnostic: 3 without its flush (no atomics; its sums go nowhere),
//      for the flush's share of 3's time; bf16 only
#include <stdint.h>

#include "../corr_fused_bwd.cu"

namespace k9probe {

inline int support_size(int radius) { return (2 * radius + 2) * (2 * radius + 2); }

// d_sup [(2r+2)^2] of one query at one level into shared memory, by the
// warp's lanes.
template <typename TG>
__device__ void support_cotangent(const TG* __restrict__ gl, int radius, const Window& w,
                                  int h2, int w2, float scale, float* dsup, int lane) {
  const int sp = 2 * radius + 2;
  for (int s = lane; s < sp * sp; s += 32) {
    dsup[s] = dsup_at(gl, radius, w, s / sp, s % sp, h2, w2, scale);  // row u (y), column v (x)
  }
}

// ---- 0: the first K9 ----
template <typename TIn, typename TG>
__global__ void __launch_bounds__(kWarps * 32)
    first_df2_kernel(const TIn* __restrict__ f1, Levels acc, int levels, int level0,
                     const float* __restrict__ coords, const TG* __restrict__ g, int bq,
                     int q_per_b, int C, int radius, long warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long wq = (long)blockIdx.x * kWarps + warp;
  if (wq >= warps) return;
  const int l = level0 + (int)(wq / bq);
  const long q = wq % bq;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int k2 = (2 * radius + 1) * (2 * radius + 1);
  const int h2 = acc.h2[l];
  const int w2 = acc.w2[l];
  float* dsup = smem + (long)warp * ns;
  const long b = q / q_per_b;
  const float s = 1.0f / (float)(1 << l);
  const Window w = window_at(coords[2 * q] * s, coords[2 * q + 1] * s, radius, h2, w2);
  support_cotangent(g + q * (long)levels * k2 + l * k2, radius, w, h2, w2,
                    1.f / sqrtf((float)C), dsup, lane);
  __syncwarp();
  float* accb = static_cast<float*>(acc.p[l]) + b * (long)h2 * w2 * C;
  for (int chunk = 0; chunk < (C + 255) / 256; ++chunk) {
    float a[8];
    fst_load8<true>(f1 + q * C, chunk, lane, C, a);
    int u = 0;
    int v = 0;
    for (int t = 0; t < ns; ++t) {
      const float d = dsup[t];
      const int y = w.by + u;
      const int x = w.bx + v;
      v = v + 1 == sp ? 0 : v + 1;
      u += v == 0;
      if (d != 0.f) atomic_add8<true>(accb + ((long)y * w2 + x) * C, chunk, lane, C, d, a);
    }
  }
}

// ---- 4: diagnostic, the library's tensor-core body without its flush
// (timing only: its sums are not added anywhere) ----
__device__ void contract_tc_no_flush(const __nv_bfloat16* __restrict__ f1,
                                     float* __restrict__ accb, const TileBox& box,
                                     const TileQueries& sq, float* smem, int C, int radius) {
  using bf16 = __nv_bfloat16;
  bf16* f1h = reinterpret_cast<bf16*>(smem);
  bf16* dth = f1h + kTcQueries * kTcF1Stride;
  bf16* dtl = dth + kBoxChunk * kTcDStride;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = 2 * radius + 2;
  const int ns = sp * sp;
  const int n = box.nvalid;
  const int kp = (n + 15) & ~15;
  const int A = box.bw * box.bh;
  for (int cc = 0; cc < (C + kChunkC - 1) / kChunkC; ++cc) {
    for (int e = tid; e < kp * 32; e += blockDim.x) {
      const int t = e / 32;
      const int c = cc * kChunkC + (e % 32) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < n && c < C) v = *reinterpret_cast<const uint4*>(f1 + (long)sq.qrow[t] * C + c);
      *reinterpret_cast<uint4*>(f1h + t * kTcF1Stride + (e % 32) * 8) = v;
    }
    for (int a0 = 0; a0 < A; a0 += kBoxChunk) {
      for (int e = tid; e < kBoxChunk * kp; e += blockDim.x) {
        const int j = e / kp;
        const int t = e - j * kp;
        const int a = a0 + j;
        float d = 0.f;
        if (t < n && a < A) {
          const int u = box.y0 + a / box.bw - sq.qby[t];
          const int v = box.x0 + a % box.bw - sq.qbx[t];
          if (u >= 0 && u < sp && v >= 0 && v < sp) d = sq.dsup[t * ns + u * sp + v];
        }
        const bf16 hi = __float2bfloat16(d);
        dth[j * kTcDStride + t] = hi;
        dtl[j * kTcDStride + t] = __float2bfloat16(d - __bfloat162float(hi));
      }
      __syncthreads();
      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
        }
      }
      for (int k0 = 0; k0 < kp; k0 += 16) {
        unsigned bfr[2][4];  // B fragments of n-tiles (0, 1) and (2, 3)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int krow = k0 + (lane % 8) + ((lane / 8) % 2) * 8;
          const int ncol = warp * 32 + p * 16 + (lane / 16) * 8;
          ldsm_x4_trans(f1h + krow * kTcF1Stride + ncol, bfr[p]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          unsigned ah[4];
          unsigned al[4];
          const int off = (mt * 16 + lane % 16) * kTcDStride + k0 + (lane / 16) * 8;
          ldsm_x4(dth + off, ah);
          ldsm_x4(dtl + off, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const unsigned b0 = bfr[nt / 2][(nt % 2) * 2];
            const unsigned b1 = bfr[nt / 2][(nt % 2) * 2 + 1];
            mma_bf16(acc[mt][nt], ah, b0, b1);
            mma_bf16(acc[mt][nt], al, b0, b1);
          }
        }
      }
      // acc[mt][nt] holds (tap mt*16 + lane/4, channels 2 (lane%4) + {0, 1})
      // and the same for tap + 8; lane pairs swap halves, so that each lane
      // adds 4 channels of one tap with one 16-byte atomic
      const int gid = lane / 4;
      const int tig = lane % 4;
      const bool even = (tig & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c = acc[mt][nt];
          const float x0 = __shfl_xor_sync(0xffffffffu, even ? c[2] : c[0], 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, even ? c[3] : c[1], 1);
          const float v[4] = {even ? c[0] : x0, even ? c[1] : x1, even ? x0 : c[2],
                              even ? x1 : c[3]};
          const int a = a0 + mt * 16 + gid + (even ? 0 : 8);
          // no atomics; a store no input makes keeps the products alive
          if (a < A && v[0] + v[1] + v[2] + v[3] == 1.2345e-30f) accb[a] = v[0];
        }
      }
      __syncthreads();  // the operands are rewritten next
    }
  }
}

template <typename TG>
__global__ void __launch_bounds__(kThreads, 2)
    no_flush_kernel(const __nv_bfloat16* __restrict__ f1, Levels acc, int levels, int level0,
                    QueryGrid grid, int batch, const float* __restrict__ coords,
                    const TG* __restrict__ g, int q_per_b, int C, int radius) {
  extern __shared__ __align__(16) float smem[];
  const TileQueries sq = tile_queries<kTcQueries>(smem + df2_operand_words(kTcQueries, true),
                                                  (2 * radius + 2) * (2 * radius + 2));
  const TileBox box = tile_prologue<TG, kTileY, kTileX>(acc, levels, level0, grid, batch, coords,
                                                        g, q_per_b, C, radius, sq);
  if (box.nvalid == 0 || box.bw * box.bh > kMaxBoxTaps) return;
  float* accb = static_cast<float*>(acc.p[box.l]) + (long)box.b * box.h2 * box.w2 * C;
  contract_tc_no_flush(f1, accb, box, sq, smem, C, radius);
}

template <typename TIn, typename TG>
cudaError_t launch_variant(int variant, const void* f1, const Levels& acc, int levels, int level0,
                           int level1, const float* coords, const void* g, int bq, int q_per_b,
                           int C, int radius, cudaStream_t s) {
  if (variant == 0) {
    const long warps = (long)(level1 - level0) * bq;
    const int blocks = (int)((warps + kWarps - 1) / kWarps);
    const size_t smem = (size_t)kWarps * support_size(radius) * sizeof(float);
    first_df2_kernel<TIn, TG><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const TIn*>(f1), acc, levels, level0, coords, static_cast<const TG*>(g), bq,
        q_per_b, C, radius, warps);
    return cudaGetLastError();
  }
  if (variant == 1) {
    return launch_df2<TIn, TG, true, 8, 8, false>(f1, acc, levels, level0, level1, coords, g, bq,
                                                  q_per_b, C, radius, s);
  }
  if (variant == 2) {
    return launch_df2<TIn, TG, true, 8, 16, false>(f1, acc, levels, level0, level1, coords, g,
                                                   bq, q_per_b, C, radius, s);
  }
  if (variant == 3) {
    return launch_df2<TIn, TG, true>(f1, acc, levels, level0, level1, coords, g, bq, q_per_b, C,
                                     radius, s);
  }
  if (variant == 4 && sizeof(TIn) == 2) {
    const QueryGrid grid = query_grid<kTileY, kTileX>(q_per_b, acc.h2[0], acc.w2[0]);
    const long blocks = (long)(level1 - level0) * (bq / q_per_b) * grid.tiles_y * grid.tiles_x;
    const long smem = df2_smem_words(kTcQueries, true, radius) * (long)sizeof(float);
    auto kernel = no_flush_kernel<TG>;
    cudaError_t err = allow_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(f1), acc, levels, level0, grid, bq / q_per_b,
        coords, static_cast<const TG*>(g), q_per_b, C, radius);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace k9probe

extern "C" {

// The probe's one entry: variant (above) over levels [level0, level1); C % 8
// == 0 and 16-byte aligned rows only.
int k9_probe(int variant, const void* f1, void* const* acc, const int* h2, const int* w2,
             int levels, int level0, int level1, const void* coords, const void* g, int bq,
             int q_per_b, int C, int radius, int in_dtype, int g_dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || level0 < 0 || level1 > levels || level0 >= level1 ||
      C % 8 != 0 || bq % q_per_b != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < levels; ++l) {
    lv.p[l] = acc[l];
    lv.h2[l] = h2[l];
    lv.w2[l] = w2[l];
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == FST_BF16 && g_dtype == FST_BF16) {
    return (int)k9probe::launch_variant<__nv_bfloat16, __nv_bfloat16>(
        variant, f1, lv, levels, level0, level1, c, g, bq, q_per_b, C, radius, s);
  }
  if (in_dtype == FST_F32 && g_dtype == FST_F32) {
    return (int)k9probe::launch_variant<float, float>(variant, f1, lv, levels, level0, level1, c,
                                                      g, bq, q_per_b, C, radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
