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
// to x's dtype (template flags STATS and RELU of each body).
//
// Statistics are taken from the fp32 accumulator (bias included) BEFORE the
// cast to x's dtype, as the TPU kernel does. The JAX package's CPU
// composition (conv3x3.py `_cin_fwd_impl`, non-TPU branch) reads the rounded y
// instead; for fp32 the two agree, for bf16 this kernel follows the TPU kernel.
// The TPU grid carried the statistics sums across sequential grid steps;
// CUDA blocks run in no order, so each worker writes partial (sum, sum of
// squares) rows and norm.cu's finalize folds them in a fixed order: the
// statistics are the same from run to run on one card (no atomics).
//
// What bounds it on an H100: at the encoder's shapes a call is 4-17 GFLOP
// over 7-59 MB, about 340 FLOP per byte, just above the bf16 tensor cores'
// ridge (295): the operations bound it, and only on the tensor cores.
//
// Two bodies:
//
// - The tensor-core body (bf16 with C % 16 == 0, C <= 128, Cout % 8 == 0,
//   Cout <= 128: every conv of the model) is an implicit GEMM, M = output
//   pixels, N = Cout, K = 9 taps x C, on wgmma.mma_async m64nNk16 with both
//   operands in shared memory and fp32 accumulators; bf16 x bf16 products are
//   exact in fp32, so only the summation order differs from the fp32 body.
//   - The weights of a block's output channels (all of Cout rounded up to 64,
//     96 or 128, or half of it where that does not fit) stay in shared memory
//     for the whole launch: one block an SM, loaded once. Streaming them per
//     tile through a cp.async ring left the kernel waiting on L2 at every
//     stage.
//   - Each warpgroup (up to three a block) works alone on a contiguous range
//     of 64-pixel row tiles, ordered down 64-pixel column strips, so a tile
//     needs one new slab row (66 pixels with the halo); a ring of four rows
//     lets the next row's cp.async (zero-filled outside the image: the SAME
//     pad) overlap the current tile's 9 x C/16 wgmmas, and no block-wide
//     barrier ties the warpgroups together.
//   - The slab is channel-blocked, [C / 8][67 pixels][8]: the 8 consecutive
//     pixels of a core matrix of A are 128 contiguous bytes, so the window of
//     tap (dy, dx) is only another start address in the descriptor (no
//     ldmatrix, no A in registers). B is [tap][Cout / 8][C][8], N-major.
//     Neither is swizzled: a 128-byte-swizzled layout measured no faster.
//   - The epilogue adds the bias, applies the relu, stages each warp's 16
//     pixels x N outputs in shared memory and writes them as 16-byte stores
//     (4-byte stores straight from the accumulator layout were slower),
//     and keeps per-thread running (sum, sum of squares) over the warpgroup's
//     tiles of a sample, reduced once a sample (shuffles, then warps in
//     order) into the warpgroup's partial row.
//   What bounds it now: the wgmma rate at N = 48-64 (a third of the bf16
//   peak at the 64-channel stage, PERF.md), with a tile's epilogue
//   overlapped only by the other warpgroups' products, and at the
//   128-channel stage one warpgroup an SM, as the weights fill shared memory.
// - The CUDA-core body (fp32, and bf16 shapes the tensor-core body does not
//   take) runs in fp32: fp32 convs need full fp32 products (TF32 would keep
//   about three digits). A block computes 128 pixels of one row x 32 output
//   channels; each step stages a 3-row x 130-pixel x 16-channel input slab and
//   the matching 3x3x16x32 weights in shared memory, and every thread
//   accumulates 4 pixels x 4 output channels in registers.
#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core body (fp32, and the bf16 shapes the tensor-core body does not take)

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


// ---------------------------------------------------------------------------
// Tensor-core body (bf16): an implicit GEMM with M = output pixels, N = Cout,
// K = 9 taps x C, on wgmma.mma_async with both operands in shared memory.

constexpr int kTcTile = 64;         // output pixels of a tile: 64 of one image row
constexpr int kTcRowPix = 67;       // slab row: the tile's 64 pixels and the halo (66), odd
constexpr int kTcRing = 4;          // slab rows a warpgroup holds: 3 in use, 1 loading
constexpr int kTcMaxThreads = 384;  // three warpgroups
constexpr int kTcSmemLimit = 232448;

__host__ __device__ constexpr int tc_cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes of one slab row: [C / 8][kTcRowPix][8] bf16. With the channels
// blocked by 8, the 8 consecutive pixels of one core matrix of A are 128
// contiguous bytes, so a tap's shifted window is only another start address;
// the odd pixel stride keeps the copies' 16-byte writes of one pixel in
// different bank groups.
__host__ __device__ inline int tc_row_bytes(int C) { return C / 8 * kTcRowPix * 16; }

// Bytes of a block's weights: 9 taps x C input channels x nb output channels,
// laid out [tap][nb / 8][C][8] so that each 8 x 8 core matrix of the N-major
// B operand is 128 contiguous bytes.
__host__ __device__ inline int tc_weight_bytes(int C, int nb) { return 9 * C * nb * 2; }

// Bytes of one warpgroup's statistics reduction: (sum, sum of squares) x 4 warps x nb.
__host__ __device__ constexpr int tc_red_bytes(int nb) { return 2 * 4 * nb * 4; }

// Bytes of one warp's output staging: 16 pixels x nb bf16, rows padded by 16
// bytes so that the 8 pixels a store instruction spans hit different banks.
__host__ __device__ constexpr int tc_stage_row(int nb) { return nb * 2 + 16; }
__host__ __device__ constexpr int tc_stage_bytes(int nb) { return 16 * tc_stage_row(nb); }

__host__ __device__ inline int tc_smem_bytes(int nb, int C, int nwg) {
  return tc_weight_bytes(C, nb) +
         nwg * (kTcRing * tc_row_bytes(C) + tc_red_bytes(nb) + 4 * tc_stage_bytes(nb));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros (the SAME pad)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make the copies visible to wgmma, which reads shared memory through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of the 128 threads of one warpgroup (ids 1-3; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across it; only
// outside the wgmma pipeline (ptxas serializes every wgmma of a kernel in which
// another instruction defines an accumulator while one is in flight)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor without swizzle: start address, the byte
// offset between core matrices adjacent in K (leading) and in M or N (stride).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x N] += a[64 x 16] (K-major) * b[16 x N] (N-major: imm-trans-b = 1),
// bf16 in shared memory, fp32 accumulators; issued by a whole warpgroup.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// A block holds the weights of NB output channels (part blockIdx.y of Cout)
// for all 9 taps in shared memory, loaded once. Its warpgroups then work
// alone: each takes a contiguous range of row tiles u = (b, 64-pixel column
// segment, h), h fastest, so that it walks down a column strip and each tile
// needs one new slab row; the row of the next tile loads (cp.async) while
// the current tile's 9 x C/16 wgmmas run. Warp i of a warpgroup holds pixels
// 16i .. 16i + 15 of the tile (rows 16i .. 16i + 15 of the 64-row M tile).
template <int NB, bool STATS, bool RELU>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ partials, int B, int H, int W, int C, int Cout,
                  int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, nwg = blockDim.x / 128;
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int co0 = blockIdx.y * NB;  // this block's output channels: co0 .. co0 + NB - 1
  const int row_bytes = tc_row_bytes(C);
  const uint32_t w_addr = smem_addr(smem);
  const uint32_t ring = w_addr + tc_weight_bytes(C, NB) + wg * kTcRing * row_bytes;
  float* red = reinterpret_cast<float*>(smem + tc_weight_bytes(C, NB) +
                                        nwg * kTcRing * row_bytes + wg * tc_red_bytes(NB));
  unsigned char* stage = smem + tc_weight_bytes(C, NB) +
                         nwg * (kTcRing * row_bytes + tc_red_bytes(NB)) +
                         (wg * 4 + warp) * tc_stage_bytes(NB);

  // the weights, HWIO [tap][C][Cout] -> [tap][NB / 8][C][8]; a warp copies 8
  // input channels x 4 column groups, so that its 16-byte writes fall in
  // distinct bank groups and its reads are 64-byte runs of one HWIO row
  for (int e = tid; e < 9 * C * (NB / 8); e += blockDim.x) {
    const int ng = (e / 8) % (NB / 8);
    const int kk = e % 8 + e / NB * 8;  // tap * C + input channel
    const int tap = kk / C, c = kk % C;
    const bool in = co0 + ng * 8 < Cout;
    const __nv_bfloat16* src = in ? w + (long)kk * Cout + co0 + ng * 8 : w;
    cp_async16(w_addr + ((tap * (NB / 8) + ng) * C + c) * 16, src, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait0();
  fence_async_shared();
  __syncthreads();

  const int nseg = tc_cdiv(W, kTcTile);  // 64-pixel segments of an image row
  const int P_img = H * nseg;            // tiles per sample
  const long U = (long)B * P_img;        // tiles, ordered (b, segment, h)
  const int nworkers = gridDim.x * nwg;  // = P, the partial rows per sample
  const int wid = blockIdx.x * nwg + wg;
  const long u_end = (wid + 1) * U / nworkers;

  // per-thread running (sum, sum of squares) of its channels over the
  // worker's tiles of one sample: channels 8j + 2 (lane % 4) + {0, 1}
  float sum[NB / 8][4];
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) sum[j][0] = sum[j][1] = sum[j][2] = sum[j][3] = 0.f;
  // the worker's partial row of sample bb: over the 8 lanes that hold the
  // same channels, then the 4 warps, in a fixed order; then zero the sums
  auto flush = [&](int bb) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = sum[j][k];
#pragma unroll
        for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 4) red[((k / 2) * 4 + warp) * NB + j * 8 + (lane % 4) * 2 + k % 2] = v;
        sum[j][k] = 0.f;
      }
    }
    warpgroup_sync(wg);
    float* out = partials + ((long)bb * P + wid) * 2 * Cout;
    for (int cl = wt; cl < NB && co0 + cl < Cout; cl += 128) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t1 += red[i * NB + cl];
        t2 += red[(4 + i) * NB + cl];
      }
      out[co0 + cl] = t1;
      out[Cout + co0 + cl] = t2;
    }
    warpgroup_sync(wg);  // red is free again
  };
  const int cpp = C / 8;  // 16-byte chunks per pixel
  const int nks = C / 16;

  // image row r of column strip `strip` (b * nseg + segment), pixels w0 - 1
  // .. w0 + 64, into ring slot (r + 1) % 4; zero outside the image
  auto load_row = [&](int strip, int r) {
    const int b = strip / nseg, wbase = (strip % nseg) * kTcTile - 1;
    const uint32_t dst = ring + ((r + 1) & (kTcRing - 1)) * row_bytes;
    for (int e = wt; e < (kTcTile + 2) * cpp; e += 128) {
      const int kg = e % cpp, px = e / cpp;
      const int ww = wbase + px;
      const bool in = r >= 0 && r < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src = in ? x + (((long)b * H + r) * W + ww) * C + kg * 8 : x;
      cp_async16(dst + (kg * kTcRowPix + px) * 16, src, in ? 16 : 0);
    }
  };

  for (long u = wid * U / nworkers; u < u_end; ++u) {
    const int strip = (int)(u / H), h = (int)(u % H);  // u / P_img is the sample
    const int b = strip / nseg, w0 = (strip % nseg) * kTcTile;
    if (u == wid * U / nworkers || h == 0) {  // a new strip: rows h - 1, h, h + 1
      warpgroup_sync(wg);  // the previous tile's slab rows are free
      for (int r = h - 1; r <= h + 1; ++r) load_row(strip, r);
    }
    cp_async_commit();
    cp_async_wait0();
    fence_async_shared();
    // rows h - 1 .. h + 1 landed for the whole warpgroup, which is done with
    // its previous tile (and the slot of row h - 2 that the next load takes)
    warpgroup_sync(wg);
    if (u + 1 < u_end && h + 1 < H) load_row(strip, h + 2);

    float acc[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    for (int dy = 0; dy < 3; ++dy) {
      const uint32_t a_row = ring + ((h + dy) & (kTcRing - 1)) * row_bytes;  // row h + dy - 1
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t b_tap = w_addr + (dy * 3 + dx) * (NB / 8) * C * 16;
        for (int ks = 0; ks < nks; ++ks)
          wgmma_ss<NB>(acc, smem_desc(a_row + (2 * ks * kTcRowPix + dx) * 16, kTcRowPix * 16, 128),
                       smem_desc(b_tap + ks * 256, 128, C * 16));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);

    // epilogue: bias (+ relu), bf16 into the warp's staging rows, and
    // per-channel (sum, sum of squares) of the fp32 values. Lane l holds
    // pixels 16 warp + l / 4 and + 8, channels 8j + 2 (l % 4) + {0, 1} for
    // each j.
    const int wa = w0 + warp * 16 + lane / 4;
    const bool va = wa < W, vb = wa + 8 < W;
    unsigned char* sa = stage + (lane / 4) * tc_stage_row(NB);
    unsigned char* sb = sa + 8 * tc_stage_row(NB);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int cl = j * 8 + (lane % 4) * 2;  // channel within the block's NB
      const int co = co0 + cl;
      if (co < Cout) {  // the same for the whole warp: Cout % 8 == 0
        const float b0 = fst_load(bias, co), b1 = fst_load(bias, co + 1);
        float v0 = acc[4 * j] + b0, v1 = acc[4 * j + 1] + b1;
        float v2 = acc[4 * j + 2] + b0, v3 = acc[4 * j + 3] + b1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(sa + cl * 2) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(sb + cl * 2) = __floats2bfloat162_rn(v2, v3);
        if constexpr (STATS) {
          if (va) { sum[j][0] += v0; sum[j][1] += v1; sum[j][2] += v0 * v0; sum[j][3] += v1 * v1; }
          if (vb) { sum[j][0] += v2; sum[j][1] += v3; sum[j][2] += v2 * v2; sum[j][3] += v3 * v3; }
        }
      }
    }
    // the warp's 16 pixels x NB channels out of staging in 16-byte stores:
    // one contiguous run a pixel (the whole 16-pixel run when NB == Cout)
    __syncwarp();
    for (int e = lane; e < 16 * (NB / 8); e += 32) {
      const int px = e / (NB / 8), c8 = e % (NB / 8);
      const int ww = w0 + warp * 16 + px;
      if (ww < W && co0 + c8 * 8 < Cout)
        *reinterpret_cast<uint4*>(y + (((long)b * H + h) * W + ww) * Cout + co0 + c8 * 8) =
            *reinterpret_cast<const uint4*>(stage + px * tc_stage_row(NB) + c8 * 16);
    }
    __syncwarp();  // staging is free for the next tile
    if constexpr (STATS)
      if (u + 1 == u_end || (u + 1) / P_img != b) flush(b);  // the worker's last tile of sample b
  }
  if constexpr (STATS) {
    // samples this worker has no tile of: zero rows
    const long u_first = wid * U / nworkers;
    const int b_first = u_first < u_end ? (int)(u_first / P_img) : B;
    const int b_last = u_first < u_end ? (int)((u_end - 1) / P_img) : -1;
    for (int bb = 0; bb < B; ++bb)
      if (bb < b_first || bb > b_last)
        for (int cl = wt; cl < NB && co0 + cl < Cout; cl += 128) {
          float* out = partials + ((long)bb * P + wid) * 2 * Cout;
          out[co0 + cl] = 0.f;
          out[Cout + co0 + cl] = 0.f;
        }
  }
}

// The shapes the tensor-core body takes (kernels/conv3x3.py
// tensor_core_body): C % 16 == 0 (a wgmma's K is 16 channels), C <= 128 (a
// block's weights and slab rows fit in shared memory), Cout % 8 == 0 and
// Cout <= 128 (one wgmma of N = 64, 96 or 128, or half of it, covers a
// block's part), x and w 16-byte aligned (cp.async).
bool tc_shape_ok(const void* x, const void* w, int B, int C, int Cout) {
  return C % 16 == 0 && C >= 16 && C <= 128 && Cout % 8 == 0 && Cout >= 8 && Cout <= 128 &&
         (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0 && B >= 1;
}

// How a conv is spread over blocks: nb output channels a block (Cout rounded
// up to nt = 64, 96 or 128, else half of nt), with as many warpgroups (up to
// three) as the weights and their slabs leave room for in shared memory; one
// block an SM (its shared memory allows no second), split among the parts,
// and no more warpgroups than tiles. Each warpgroup writes one partial row of
// statistics per sample: P = blocks * nwg.
struct TcPlan {
  int nb, parts, nwg, smem, blocks;
};

// SMs of the current device (0 if it cannot be read), asked once a device
int tc_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 64) dev = 63;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

TcPlan tc_plan(int B, int H, int W, int C, int Cout) {
  const int nt = Cout <= 64 ? 64 : Cout <= 96 ? 96 : 128;
  const long tiles = (long)B * H * tc_cdiv(W, kTcTile);
  const int sms = tc_sms();
  for (int nwg = kTcMaxThreads / 128; nwg >= 1; --nwg)
    for (int nb = nt; nb >= nt / 2; nb -= nt / 2) {
      const int smem = tc_smem_bytes(nb, C, nwg);
      if (smem > kTcSmemLimit) continue;
      const int parts = tc_cdiv(Cout, nb);
      long blocks = sms / parts > 0 ? sms / parts : 1;
      if (blocks * nwg > tiles) blocks = (tiles + nwg - 1) / nwg;
      return {nb, parts, nwg, smem, (int)blocks};
    }
  return {0, 0, 0, 0, 0};  // unreachable for tc_shape_ok's shapes
}

template <int NB, bool STATS, bool RELU>
cudaError_t tc_launch(const void* x, const void* w, const void* bias, void* y, float* partials,
                      int B, int H, int W, int C, int Cout, const TcPlan& plan, cudaStream_t s) {
  auto kernel = conv3x3_tc_kernel<NB, STATS, RELU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(plan.blocks, plan.parts), 128 * plan.nwg, plan.smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)y, partials, B, H, W, C, Cout, plan.blocks * plan.nwg);
  return cudaGetLastError();
}

template <bool STATS, bool RELU>
cudaError_t tc_dispatch(const void* x, const void* w, const void* bias, void* y, float* partials,
                        int B, int H, int W, int C, int Cout, const TcPlan& plan, cudaStream_t s) {
  switch (plan.nb) {
    case 32: return tc_launch<32, STATS, RELU>(x, w, bias, y, partials, B, H, W, C, Cout, plan, s);
    case 48: return tc_launch<48, STATS, RELU>(x, w, bias, y, partials, B, H, W, C, Cout, plan, s);
    case 64: return tc_launch<64, STATS, RELU>(x, w, bias, y, partials, B, H, W, C, Cout, plan, s);
    case 96: return tc_launch<96, STATS, RELU>(x, w, bias, y, partials, B, H, W, C, Cout, plan, s);
    case 128:
      return tc_launch<128, STATS, RELU>(x, w, bias, y, partials, B, H, W, C, Cout, plan, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Partial rows per sample that either body may write: H * ceil(W / 128) for
// the CUDA-core body, one per warpgroup (at most three an SM) for the
// tensor-core body; the wrapper allocates partials [B, P, 2, Cout] and each
// entry point folds the rows its body wrote.
int fst_conv3x3_partials(int H, int W) {
  const int cuda_core = H * tc_cdiv(W, kTP);
  const int tensor_core = kTcMaxThreads / 128 * tc_sms();
  return cuda_core > tensor_core ? cuda_core : tensor_core;
}

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

// K2 on the tensor cores (bf16; tc_shape_ok's shapes, else cudaErrorInvalidValue).
int fst_conv3x3_tc_stats(const void* x, const void* w, const void* bias, void* y,
                         void* partials, void* stats, int B, int H, int W, int C, int Cout,
                         float eps, void* stream) {
  if (!tc_shape_ok(x, w, B, C, Cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const TcPlan plan = tc_plan(B, H, W, C, Cout);
  if (plan.blocks < 1) return (int)cudaErrorInvalidValue;
  const int P = plan.blocks * plan.nwg;
  cudaError_t err = tc_dispatch<true, false>(x, w, bias, y, (float*)partials, B, H, W, C, Cout,
                                             plan, s);
  if (err != cudaSuccess) return (int)err;
  return (int)fst_stats_finalize((const float*)partials, (float*)stats, B, P, Cout,
                                 (long)H * W, eps, s);
}

// K5 on the tensor cores: y = conv(x, w) + b (relu'd when relu != 0).
int fst_conv3x3_tc(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                   int C, int Cout, int relu, void* stream) {
  if (!tc_shape_ok(x, w, B, C, Cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const TcPlan plan = tc_plan(B, H, W, C, Cout);
  if (plan.blocks < 1) return (int)cudaErrorInvalidValue;
  if (relu) return (int)tc_dispatch<false, true>(x, w, bias, y, nullptr, B, H, W, C, Cout, plan, s);
  return (int)tc_dispatch<false, false>(x, w, bias, y, nullptr, B, H, W, C, Cout, plan, s);
}

}  // extern "C"
