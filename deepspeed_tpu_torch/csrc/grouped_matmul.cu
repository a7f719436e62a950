// Grouped (per-expert) matmul on a tile-aligned row layout for Hopper
// (sm_90a): the MoE expert GEMM, out[Mp, N] = x[Mp, K] @ W[tile_expert],
// bf16 x and output, fp32 accumulation, W a bf16 expert stack [E, K, N] or
// grouped quantized expert carriers.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/grouped_matmul.py:
//   _gmm_kernel       (the `pl.pallas_call` in _gmm_raw)       -> scheme 0
//   _gmm_quant_kernel (the `pl.pallas_call` in _gmm_quant_raw) -> schemes 1-3
// Rows are sorted by expert and each expert's group is zero-padded to the
// row tile (16 or 64), so every row tile belongs to one expert,
// tile_expert[tile]; the block reads its own tile's expert (the TPU's
// scalar prefetch). Tiles at or past *used_tiles, which the routing writes
// on the device, hold no rows: their blocks write zeros and read no weight,
// so an expert with no rows costs nothing and the host never learns the
// count. Quantized carriers are decoded and scaled into bf16 in shared
// memory exactly as dequantize_grouped does (quant_gemm.cuh).
//
// What bounds it on an H100: the weight bytes of the experts the batch
// touches. Decoding 8 tokens (16 rows, top-2) through one Mixtral layer's
// [8, 4096, 14336] int8 stack reads 469.8 MB of carriers and 3.7 MB of
// scales when every expert is hit, ~141 us at 3.35 TB/s; a 528-row prefill
// chunk does 33x the flops on the same bytes and is still bytes-bound.
//
// What the design does about that: each (row tile, 64 columns) block
// streams its expert's column slice once; decode takes 16-row tiles, so a
// decode batch reads each touched expert's slab about once (twice where an
// expert holds more than 16 rows); the grid is the static worst case of the
// layout, and unused tiles exit at once. The carrier stream is not yet
// pipelined against the decode and the MMAs.

#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "quant_gemm.cuh"

using namespace qgemm;

// Plain C entry for ctypes. Device pointers to contiguous tensors: x bf16
// [Mp, K]; w bf16 [E, K, N] (scheme 0) or carriers int8 / float8_e4m3fn
// [E, K, N] or uint8 [E, K, 3N/4] (fp6); scales fp32 [E, K, ng] (null for
// scheme 0); tile_expert int32 [Mp / tm]; used_tiles int32 [1]; out bf16
// [Mp, N]. scheme: 0 bf16, 1 int8, 2 fp8, 3 fp6; tm: 16 or 64. The wrapper
// in ops/kernels/grouped_matmul.py checks shapes and types. Returns
// cudaGetLastError() of the launch.
extern "C" int ds_grouped_matmul(const void* x, const void* w, const void* scales,
                                 const void* tile_expert, const void* used_tiles, void* out,
                                 int Mp, int K, int N, int ng, int E, int scheme, int tm,
                                 void* stream) {
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scales), static_cast<const int32_t*>(tile_expert),
         static_cast<const int32_t*>(used_tiles), static_cast<uint16_t*>(out), nullptr,
         Mp, K, N, ng, ng > 0 ? N / ng : 0, E, (K + BK - 1) / BK * BK};
  if (bad_args(a, scheme, tm) || E <= 0 || Mp % tm != 0 || tile_expert == nullptr ||
      used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case kBF16: return (int)launch_bm<kBF16, true>(a, tm, 1, st);
    case kInt8: return (int)launch_bm<kInt8, true>(a, tm, 1, st);
    case kFP8: return (int)launch_bm<kFP8, true>(a, tm, 1, st);
    default: return (int)launch_bm<kFP6, true>(a, tm, 1, st);
  }
}

// ---------------------------------------------------------------------------
// The backward kernels of K5.
//
// dx[Mp, K] = dy[Mp, N] @ W[tile_expert]^T, W [E, K, N] read as it is
// stored (no transposed copy of the stack). It replaces _gmm_quant_dx_kernel
// (the `pl.pallas_call` in _gmm_quant_dx_raw) for carriers (schemes 1-3)
// and computes the input gradient of gmm (scheme 0), which the TPU package
// runs as _gmm_kernel on w.swapaxes(1, 2). Each weight is decoded and
// scaled as dequantize_grouped does and rounded to bf16 once; the products
// sum in fp32, rounded to bf16 once; rows at or past *used_tiles are zero;
// each output is written once (no atomics, no split of N), so the same
// inputs give the same bits; the host never learns the routing.
//
// What bounds dx on an H100: operations. At Mixtral's w1 [8, 4096, 14336]
// and 8192 rows (T*k) it is 2 * 8192 * 4096 * 14336 = 9.6e11 flops, 0.97 ms
// at 989 TFLOP/s, against 1.24 GB of dy, the touched W and dx (0.37 ms at
// 3.35 TB/s); w2 is the same count. The first design (gmm_dx_kernel below:
// a 64 x 64 tile of dx on mma.sync, a 32-wide step between two barriers,
// the next step's loads one step deep in registers) moved ~31 GB from L2 at
// 32 flops a byte and set its own pace, 7.2-7.5 ms bf16 and 16-18 ms
// through carriers.
//
// What the wgmma design (gmm_dx_wgmma_kernel) does about that:
//  - a block owns 128 dx rows x 256 dx columns: two consumer warpgroups of
//    64 rows, each issuing wgmma m64n256k16 with its 128 fp32 accumulators
//    a thread in registers (setmaxnreg hands them the producer's), 85
//    flops a loaded byte. dy [rows][N] and W [K rows][N] both run along
//    the contraction, wgmma's native K-major layout, so W needs no
//    transpose;
//  - one producer thread keeps a ring of 4 stages, 64 of N deep (128 bytes
//    of bf16: TMA's 128-byte swizzle, which the wgmma descriptors read),
//    fed with TMA tile loads under full/empty mbarriers; a consumer waits
//    on full, issues its wgmma, and releases a stage once the next step's
//    wgmma is in flight;
//  - carriers arrive raw (int8/fp8 [256][64] bytes, fp6 [256][48]); the 256
//    consumer threads decode a step (the values of quant_gemm.cuh's
//    decoders, on the integer and FMA pipes) into one of three swizzled
//    bf16 tiles while the previous step's wgmma runs, and a named barrier
//    between the two consumers publishes the tile; scales are read two
//    steps ahead and only when a row's group changes (one a row and step
//    when the group width is a multiple of 16, else one an element);
//  - a work list the wrapper builds on the device (gmm_dx_plan) puts up to
//    128 / tm consecutive tiles of one expert in an item, so no block mixes
//    experts; the blocks of one expert's run take its column blocks in
//    turn, its items fastest, so its dy rows and each W column block stay
//    in the 50 MB L2 while they are read, and the list's spare slots write
//    the zeros of the rows past *used_tiles.
// TMA wants 16-byte aligned bases and rows of dy and W a multiple of 16
// bytes (N % 8 for bf16, N % 16 for int8 and fp8, N % 64 for fp6); the
// wrapper gives other shapes to the first design, chosen by shape before
// the launch and counted by design.
//
// gmm_dw_kernel replaces _gmm_dw_kernel (the `pl.pallas_call` in
// _gmm_dw_raw): dW[e] = sum over expert e's row tiles of x_tile^T dy_tile,
// x [Mp, K] and dy [Mp, N] bf16, fp32 sums rounded once to bf16 [E, K, N]
// (the TPU package sums in fp32 and casts to the weight's dtype: the same
// bits at half the bytes). One block per (expert, 128 K, 128 N) output tile
// finds its expert's contiguous run of row tiles on the device, walks it 16
// rows at a time (x^T through ldmatrix.trans as the A operand, dy through
// ldmatrix.trans as the B operand) and writes its tile once: no atomics,
// so the same inputs give the same bits, and an expert with no rows gets
// zeros. Pad rows are zero in x and dy and add nothing.
//
// What bounds dW on an H100: operations, the same 9.6e11 flops at w1
// against 1.24 GB of x (67 MB), dy (235 MB) and dW (940 MB), 0.37 ms at
// 3.35 TB/s. What its design does about that: tensor cores (mma.sync
// m16n8k16, fp32 accumulators), a large output tile so that each loaded
// byte feeds many MMAs, the next step's global reads held in registers
// while this step's MMAs run, and a grid with the expert slowest so that
// one expert's rows stay in the 50 MB L2 while its tiles run. Not done yet
// for dW: wgmma and a TMA pipeline.

namespace {

// ldmatrix.x4 lane address over a 16 x 16 block at (row0, col0) of a shared
// tile, matrices ordered (rows 0-7, cols 0-7), (rows 0-7, cols 8-15), (rows
// 8-15, cols 0-7), (rows 8-15, cols 8-15): without .trans, the B fragments
// of two n8 tiles of a [n][k] tile; with .trans, the A fragment of a [k][m]
// tile
template <int LD>
__device__ __forceinline__ const uint16_t* t_order(const uint16_t* t, int row0, int col0,
                                                   int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return t + (row0 + (mi >> 1) * 8 + r) * LD + col0 + (mi & 1) * 8;
}

constexpr int DX_BK = 64;           // dx outputs (K columns) per block
constexpr int DX_BN = 32;           // N (the contraction) per step
constexpr int DX_LD = DX_BN + kPad; // bf16 per shared row of the dy and W tiles

__host__ __device__ constexpr int dx_tile_bytes(int s) {  // carrier bytes of one W row's step
  return s == kBF16 ? 2 * DX_BN : s == kFP6 ? DX_BN / 4 * 3 : DX_BN;
}

template <int S, int BM>
__global__ void __launch_bounds__(kThreads) gmm_dx_kernel(const Args a) {
  // here a.x is dy [rows, N], a.w the stack [E, K, row_bytes(N)], a.out dx [rows, K]
  constexpr int WM = BM / 16;
  constexpr int WC = DX_BK * WM / 4;  // output columns per warp
  constexpr int NT = WC / 8;
  constexpr int TB = dx_tile_bytes(S);
  constexpr int WV = 64 * TB / 8;     // 8-byte carrier words of one step's W tile
  constexpr int WPT = (WV + kThreads - 1) / kThreads;
  constexpr int XC = (BM * (DX_BN / 8) + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint16_t sX[BM * DX_LD];
  __shared__ __align__(16) uint16_t sW[DX_BK * DX_LD];
  __shared__ __align__(16) uint8_t sRaw[S == kBF16 ? 16 : DX_BK * TB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * DX_BK, m0 = blockIdx.y * BM;
  const int wr = (warp % WM) * 16, wc = (warp / WM) * WC;
  const int N = a.N, K = a.K;

  const int e = (int)blockIdx.y < *a.used_tiles ? a.tile_expert[blockIdx.y] : -1;
  if (e < 0 || e >= a.E) {
    for (int i = tid; i < BM * DX_BK; i += kThreads) {
      const int r = m0 + i / DX_BK, c = k0 + i % DX_BK;
      if (r < a.rows && c < K) a.out[(size_t)r * K + c] = 0;
    }
    return;
  }
  const size_t rb = row_bytes(S, N);
  const uint8_t* wbase = a.w + (size_t)e * K * rb;
  const float* sbase = S == kBF16 ? nullptr : a.scales + (size_t)e * K * a.ng;

  // this thread decodes columns 4 cq .. 4 cq + 3 of the step in rows r0 + 16 i
  const int cq = tid & 7, r0 = tid >> 3;
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  uint4 xv[XC];
  uint2 wv[WPT];
  float sv[4][4];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (DX_BN / 8), c = (i % (DX_BN / 8)) * 8;
      const int row = m0 + r, nc = n0 + c;
      union { uint4 v; uint16_t h[8]; } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (i < BM * (DX_BN / 8) && row < a.rows) {
        const uint16_t* src = a.x + (size_t)row * N + nc;
        if (nc + 8 <= N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          u.v = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u.h[j] = nc + j < N ? src[j] : (uint16_t)0;
        }
      }
      xv[q] = u.v;
    }
    const size_t cb0 = row_bytes(S, n0);
    const int vb = (int)(rb - cb0 < (size_t)TB ? rb - cb0 : (size_t)TB);  // valid bytes a row
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (TB / 8), c = (i % (TB / 8)) * 8;
      const int kr = k0 + r;
      union { uint2 v; uint8_t b[8]; } u;
      u.v = make_uint2(0u, 0u);
      if (i < WV && kr < K && c < vb) {
        const uint8_t* src = wbase + (size_t)kr * rb + cb0 + c;
        if (c + 8 <= vb && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
          u.v = *reinterpret_cast<const uint2*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u.b[j] = c + j < vb ? src[j] : (uint8_t)0;
        }
      }
      wv[q] = u.v;
    }
    if constexpr (S != kBF16) {
      const int c0 = n0 + 4 * cq;  // this thread's quad: one scale when one group holds it
      const bool one_group = c0 + 3 < N && c0 / a.g == (c0 + 3) / a.g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + r0 + 16 * i;
        sv[i][0] = sv[i][1] = sv[i][2] = sv[i][3] = 0.f;
        if (kr < K) {
          const float* srow = sbase + (size_t)kr * a.ng;
          if (one_group) {
            sv[i][0] = sv[i][1] = sv[i][2] = sv[i][3] = srow[c0 / a.g];
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < N) sv[i][j] = srow[(c0 + j) / a.g];
          }
        }
      }
    }
  };

  uint8_t* raw = S == kBF16 ? reinterpret_cast<uint8_t*>(sW) : sRaw;
  constexpr int DST_LD = S == kBF16 ? DX_LD * 2 : TB;  // bytes per row where raw bytes land
  fetch(0);
  for (int n0 = 0; n0 < N; n0 += DX_BN) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int i = tid + q * kThreads;
      if (i < BM * (DX_BN / 8))
        *reinterpret_cast<uint4*>(sX + (i / (DX_BN / 8)) * DX_LD + (i % (DX_BN / 8)) * 8) = xv[q];
    }
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const int i = tid + q * kThreads;
      if (i < WV)
        *reinterpret_cast<uint2*>(raw + (i / (TB / 8)) * DST_LD + (i % (TB / 8)) * 8) = wv[q];
    }
    float s[4][4];
    if constexpr (S != kBF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = sv[i][j];
    }
    __syncthreads();
    if (n0 + DX_BN < N) fetch(n0 + DX_BN);

    if constexpr (S != kBF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 16 * i;
        float v[4];
        if constexpr (S == kFP6) {
          const uint8_t* p = sRaw + r * TB + 3 * cq;
          const uint32_t word = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = e3m2_to_float((word >> (6 * j)) & 0x3Fu);
        } else {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(sRaw + r * TB + 4 * cq);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = (word >> (8 * j)) & 0xFFu;
            v[j] = S == kInt8 ? (float)(int8_t)b : fp8_to_float(b);
          }
        }
        uint2 w2;
        w2.x = pack_bf16(v[0] * s[i][0], v[1] * s[i][1]);
        w2.y = pack_bf16(v[2] * s[i][2], v[3] * s[i][3]);
        *reinterpret_cast<uint2*>(sW + r * DX_LD + 4 * cq) = w2;
      }
      __syncthreads();
    }

#pragma unroll
    for (int kk = 0; kk < DX_BN / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a_order<DX_LD>(sX, wr, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bb[4];
        ldsm_x4(bb, t_order<DX_LD>(sW, wc + nn * 16, kk * 16, lane));
        mma16816(acc[2 * nn], af, bb[0], bb[1]);
        mma16816(acc[2 * nn + 1], af, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wr + g8 + 8 * half;
      if (row >= a.rows) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + wc + nt * 8 + t4 * 2 + j;
        if (col < K)
          a.out[(size_t)row * K + col] =
              __bfloat16_as_ushort(__float2bfloat16_rn(acc[nt][2 * half + j]));
      }
    }
  }
}

constexpr int DW_B = 128;              // dW outputs per block: 128 K x 128 N
constexpr int DW_R = 16;               // rows (the contraction) per step
constexpr int DW_LD = DW_B + kPad;     // bf16 per shared row of the x and dy tiles
constexpr int DW_THREADS = 256;        // 8 warps: 4 along K x 2 along N, 32 x 64 each

struct DwArgs {
  const uint16_t* x;           // [rows, K] bf16
  const uint16_t* dy;          // [rows, N] bf16
  const int32_t* tile_expert;  // [rows / tm]
  const int32_t* used_tiles;   // [1]
  uint16_t* dw;                // [E, K, N] bf16
  int rows, K, N, E, tm;
};

__global__ void __launch_bounds__(DW_THREADS) gmm_dw_kernel(const DwArgs a) {
  __shared__ __align__(16) uint16_t sX[DW_R * DW_LD];
  __shared__ __align__(16) uint16_t sD[DW_R * DW_LD];
  __shared__ int s_first, s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * DW_B, k0 = blockIdx.y * DW_B, e = blockIdx.z;
  const int wk = (warp & 3) * 32, wn = (warp >> 2) * 64;

  // the expert's run of row tiles: [s_first, s_last] among the used ones
  if (tid == 0) { s_first = INT_MAX; s_last = -1; }
  __syncthreads();
  const int used = min(*a.used_tiles, a.rows / a.tm);
  for (int t = tid; t < used; t += DW_THREADS) {
    if (a.tile_expert[t] == e) { atomicMin(&s_first, t); atomicMax(&s_last, t); }
  }
  __syncthreads();
  const int r_begin = s_last < 0 ? 0 : s_first * a.tm;
  const int r_end = s_last < 0 ? 0 : (s_last + 1) * a.tm;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // one uint4 of x and one of dy per thread and step: row tid / 16, columns (tid % 16) * 8
  const int lr = tid / 16, lc = (tid % 16) * 8;
  uint4 xv, dv;
  auto load = [&](const uint16_t* base, int ld, int row, int col) {
    union { uint4 v; uint16_t h[8]; } u;
    u.v = make_uint4(0u, 0u, 0u, 0u);
    if (col < ld) {
      const uint16_t* src = base + (size_t)row * ld + col;
      if (col + 8 <= ld && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        u.v = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) u.h[j] = col + j < ld ? src[j] : (uint16_t)0;
      }
    }
    return u.v;
  };
  if (r_begin < r_end) {
    xv = load(a.x, a.K, r_begin + lr, k0 + lc);
    dv = load(a.dy, a.N, r_begin + lr, n0 + lc);
  }
  for (int r0 = r_begin; r0 < r_end; r0 += DW_R) {
    __syncthreads();
    *reinterpret_cast<uint4*>(sX + lr * DW_LD + lc) = xv;
    *reinterpret_cast<uint4*>(sD + lr * DW_LD + lc) = dv;
    __syncthreads();
    if (r0 + DW_R < r_end) {
      xv = load(a.x, a.K, r0 + DW_R + lr, k0 + lc);
      dv = load(a.dy, a.N, r0 + DW_R + lr, n0 + lc);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4_t(af[i], t_order<DW_LD>(sX, 0, wk + 16 * i, lane));
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t bb[4];
      ldsm_x4_t(bb, a_order<DW_LD>(sD, 0, wn + nn * 16, lane));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma16816(acc[i][2 * nn], af[i], bb[0], bb[1]);
        mma16816(acc[i][2 * nn + 1], af[i], bb[2], bb[3]);
      }
    }
  }

  uint16_t* out = a.dw + (size_t)e * a.K * a.N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kr = k0 + wk + 16 * i + g8 + 8 * half;
        if (kr >= a.K) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn + nt * 8 + t4 * 2 + j;
          if (col < a.N)
            out[(size_t)kr * a.N + col] =
                __bfloat16_as_ushort(__float2bfloat16_rn(acc[i][nt][2 * half + j]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gmm_dx_wgmma_kernel: the wgmma design of dx (the note above says why).

constexpr int DXW_ROWS = 128;     // dx rows a block: two consumer warpgroups of 64
constexpr int DXW_COLS = 256;     // dx columns (K outputs) a block: wgmma's n
constexpr int DXW_STEP = 64;      // contraction (N) a stage: 128 bytes of bf16, the swizzle span
constexpr int DXW_STAGES = 4;
constexpr int DXW_THREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int DXW_PLAN = 5;       // int32 fields of a work item

template <int S>
struct DxwSmem {
  static constexpr int kA = DXW_ROWS * DXW_STEP * 2;  // one stage of dy: 16 KB
  static constexpr int kB = DXW_COLS * DXW_STEP * 2;  // one stage of bf16 W: 32 KB
  static constexpr int kRaw =                         // one stage of W as stored
      S == kBF16 ? kB : S == kFP6 ? DXW_COLS * DXW_STEP * 3 / 4 : DXW_COLS * DXW_STEP;
  static constexpr int kDec = S == kBF16 ? 0 : 3;     // decoded bf16 W tiles (carriers)
  static constexpr int kBar = DXW_STAGES * (kA + kRaw) + kDec * kB;  // where the barriers start
  static constexpr int kBytes = kBar + 2 * DXW_STAGES * 8 + 1024;    // + 1024-byte alignment slack
};

struct DxwArgs {
  const int32_t* plan;  // [items, DXW_PLAN]: first row, rows, expert (-1: zero fill), the
                        // item's group: its first item and its item count
  const float* scales;  // [E, K, ng] fp32, null for bf16
  uint16_t* dx;         // [Mp, K] bf16
  int Mp, K, N, ng, g, E, cols;
};

// the raw carrier bytes of columns 16 c .. 16 c + 15 of one W row's step:
// 16 int8/fp8 codes, or 16 fp6 codes in 12 bytes (w[3] unused)
struct Chunk {
  uint32_t w[4];
};

template <int S>
__device__ __forceinline__ Chunk load_chunk(const uint8_t* raw_row, int c) {
  Chunk ch;
  if constexpr (S == kFP6) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(raw_row + 12 * c);
    ch.w[0] = p[0], ch.w[1] = p[1], ch.w[2] = p[2], ch.w[3] = 0u;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(raw_row + 16 * c);
    ch.w[0] = u.x, ch.w[1] = u.y, ch.w[2] = u.z, ch.w[3] = u.w;
  }
  return ch;
}

// a chunk's 16 codes → their fp32 values
template <int S>
__device__ __forceinline__ void decode16(const Chunk& ch, float* v) {
  if constexpr (S == kFP6) {
    const uint32_t u0 = ch.w[0], u1 = ch.w[1], u2 = ch.w[2];
    const uint32_t w[4] = {u0 & 0xFFFFFFu, (u0 >> 24) | ((u1 & 0xFFFFu) << 8),
                           (u1 >> 16) | ((u2 & 0xFFu) << 16), u2 >> 8};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[4 * q + t] = e3m2_code(w[q] >> (6 * t));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[4 * q + t] =
            S == kInt8 ? int8_code(ch.w[q] ^ 0x80808080u, t) : fp8_code(ch.w[q] >> (8 * t));
  }
}

__device__ void dxw_zero(const DxwArgs& a, int r_begin, int r_end, int k0) {
  const int cols = min(DXW_COLS, a.K - k0);
  for (int i = threadIdx.x; i < (r_end - r_begin) * cols; i += DXW_THREADS)
    a.dx[(size_t)(r_begin + i / cols) * a.K + k0 + i % cols] = 0;
}

template <int S>
__global__ void __launch_bounds__(DXW_THREADS, 1)
    gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_w, const DxwArgs a) {
  using L = DxwSmem<S>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;

  // The block's item and column block: the blocks of a group (the items of
  // one run of an expert's tiles, or the zero fill) take its column blocks
  // in turn, its items fastest.
  // (Values every thread of a warp holds are broadcast from lane 0, so that
  // ptxas sees the branches they take as warp-uniform: wgmma in a path it
  // must treat as divergent is serialized.)
  const int32_t* grp = a.plan + (size_t)(blockIdx.x / a.cols) * DXW_PLAN;
  const int first = __shfl_sync(~0u, grp[3], 0), count = __shfl_sync(~0u, grp[4], 0);
  const int local = (int)blockIdx.x - first * a.cols;
  const int item = first + local % count, k0 = local / count * DXW_COLS;
  const int32_t* work = a.plan + (size_t)item * DXW_PLAN;
  const int row0 = __shfl_sync(~0u, work[0], 0), rows = __shfl_sync(~0u, work[1], 0);
  const int e = __shfl_sync(~0u, work[2], 0);
  if (e < 0 || e >= a.E) {  // rows with no expert, or the rows past the used tiles: zeros
    if (rows > 0) {
      dxw_zero(a, row0, row0 + rows, k0);
    } else {
      for (int r = row0 + DXW_ROWS * (item - first); r < a.Mp; r += DXW_ROWS * count)
        dxw_zero(a, r, min(r + DXW_ROWS, a.Mp), k0);
    }
    return;
  }

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                          // dy tiles [128 rows][64], 128-byte swizzle
  uint8_t* sW = sA + DXW_STAGES * L::kA;       // W tiles [256 rows][64] as stored
  uint8_t* sDec = sW + DXW_STAGES * L::kRaw;   // carriers decoded: bf16, 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + DXW_STAGES;
  const int steps = (a.N + DXW_STEP - 1) / DXW_STEP;
  if (tid == 0) {
    for (int s = 0; s < DXW_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer warpgroup: one thread keeps the ring fed
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % DXW_STAGES;
        hopper::mbar_wait(&empty[s], ((i / DXW_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kA + L::kRaw);
        hopper::tma_load_2d(sA + s * L::kA, &map_dy, &full[s], i * DXW_STEP, row0);
        hopper::tma_load_3d(sW + s * L::kRaw, &map_w, &full[s],
                            S == kFP6 ? i * DXW_STEP * 3 / 4 : i * DXW_STEP, k0, e);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;               // this consumer computes the item's rows 64 cw .. 64 cw + 63
  const int ct = tid - 128;            // 0 .. 255 among the consumers
  const bool active = 64 * cw < rows;  // a one-tile item leaves the second consumer idle
  float acc[128];  // the first step's first wgmma overwrites them

  // carriers: this thread decodes columns 16 c .. 16 c + 15 of each step in
  // W rows (ct >> 2) + 64 j, j < 4; with a group width of a multiple of 16
  // those columns share one scale a row
  const int c = ct & 3;
  const bool one_scale = a.g % 16 == 0;
  const float* srow[4];  // the scales of this thread's W rows, null past K
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + (ct >> 2) + 64 * j;
    srow[j] = S != kBF16 && k < a.K ? a.scales + ((size_t)e * a.K + k) * a.ng : nullptr;
  }
  auto scale = [&](int j, int n) {
    return srow[j] != nullptr && n < a.N ? __ldg(srow[j] + n / a.g) : 0.f;
  };
  // With one scale a row and step: the scales of even and of odd steps,
  // each set read two steps ahead and again only when the step's group
  // changes (scattered reads from L2 cost more than the decode).
  float sc_even[4] = {0.f, 0.f, 0.f, 0.f}, sc_odd[4] = {0.f, 0.f, 0.f, 0.f};
  int grp_even = -1, grp_odd = -1;  // the group each set holds
  auto row_scales = [&](int n, float(&sc)[4], int& held) {
    const int grp = n / a.g;
    if (grp != held) {
      held = grp;
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = scale(j, n);
    }
  };
  if constexpr (S != kBF16) {
    if (one_scale) {
      row_scales(16 * c, sc_even, grp_even);
      row_scales(DXW_STEP + 16 * c, sc_odd, grp_odd);
    }
  }

  // The step loop, with or without the wgmma (an idle consumer still
  // decodes its half of each carrier tile and releases each stage), and
  // with one scale a row and step or one an element: separate copies, so
  // that no branch around the wgmma inside the loop makes ptxas wait on
  // the accumulators it defines, and the decode has no branch at all.
  auto consume = [&](auto mma, auto row_scale) {
    auto step = [&](int i, float(&sc)[4], int& held) {
      const int s = i % DXW_STAGES;
      hopper::mbar_wait(&full[s], (i / DXW_STAGES) & 1);
      uint32_t b_addr = hopper::smem_addr(sW + s * L::kRaw);
      if constexpr (S != kBF16) {
        // decode into one of three bf16 tiles: the step before may still be
        // in the other consumer's wgmma, the one before that is done (its
        // wait came before the last barrier)
        uint8_t* dec = sDec + (i % 3) * L::kB;
        const uint8_t* raw = sW + s * L::kRaw;
        const int n0 = i * DXW_STEP;
        Chunk ch[4];  // every chunk read before the first store to the decoded tile
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ch[j] = load_chunk<S>(raw + ((ct >> 2) + 64 * j) * (L::kRaw / DXW_COLS), c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = (ct >> 2) + 64 * j;
          float v[16];
          decode16<S>(ch[j], v);
          if constexpr (decltype(row_scale)::value) {
#pragma unroll
            for (int t = 0; t < 16; ++t) v[t] *= sc[j];
          } else {
#pragma unroll
            for (int t = 0; t < 16; ++t) v[t] *= scale(j, n0 + 16 * c + t);
          }
          uint32_t pk[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) pk[q] = pack_bf16(v[2 * q], v[2 * q + 1]);
          uint8_t* drow = dec + r * 128;
          *reinterpret_cast<uint4*>(drow + (((2 * c) ^ (r & 7)) << 4)) =
              make_uint4(pk[0], pk[1], pk[2], pk[3]);
          *reinterpret_cast<uint4*>(drow + (((2 * c + 1) ^ (r & 7)) << 4)) =
              make_uint4(pk[4], pk[5], pk[6], pk[7]);
        }
        hopper::fence_proxy_async();
        hopper::named_sync(1, 256);
        b_addr = hopper::smem_addr(dec);
      }
      if constexpr (decltype(mma)::value) {
        const uint64_t da =
            hopper::sw128_desc(hopper::smem_addr(sA + s * L::kA) + cw * (L::kA / 2));
        const uint64_t db = hopper::sw128_desc(b_addr);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DXW_STEP / 16; ++kk)
          hopper::wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, i > 0 || kk > 0);
        hopper::wgmma_commit();
      }
      if constexpr (S != kBF16 && decltype(row_scale)::value) {
        // this set's next scales, two steps on, read while the wgmma runs
        if (i + 2 < steps) row_scales((i + 2) * DXW_STEP + 16 * c, sc, held);
      }
      if constexpr (decltype(mma)::value) {
        hopper::wgmma_wait<1>();  // the step before is done: release its stage
        hopper::fence_regs(acc);
      }
      if (i > 0 && (tid & 31) == 0) hopper::mbar_arrive(&empty[(i - 1) % DXW_STAGES]);
    };
    for (int i = 0; i < steps; i += 2) {
      step(i, sc_even, grp_even);
      if (i + 1 < steps) step(i + 1, sc_odd, grp_odd);
    }
  };
  auto run = [&](auto mma) {
    if (S == kBF16 || one_scale) consume(mma, std::true_type{});
    else consume(mma, std::false_type{});
  };
  if (!active) {
    run(std::false_type{});
    return;
  }
  run(std::true_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int lane = tid & 31;
  const int rl = 64 * cw + 16 * ((tid & 127) >> 5) + (lane >> 2);  // item row of acc[4j]
  const bool pairs = (a.K & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < 32; ++jn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, col = k0 + 8 * jn + 2 * (lane & 3);
      if (r >= rows || col >= a.K) continue;
      uint16_t* dst = a.dx + (size_t)(row0 + r) * a.K + col;
      const float lo = acc[4 * jn + 2 * h], hi = acc[4 * jn + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
      } else {
        dst[0] = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
        if (col + 1 < a.K) dst[1] = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
      }
    }
  }
}

// what TMA needs: 16-byte aligned bases and row pitches of dy and W
inline bool dx_wgmma_ok(const Args& a, int scheme) {
  return (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(a.w) & 15) == 0 && ((size_t)a.N * 2) % 16 == 0 &&
         row_bytes(scheme, a.N) % 16 == 0;
}

template <int S>
cudaError_t launch_dx_wgmma(const Args& a, const int32_t* plan, int items, cudaStream_t st) {
  using L = DxwSmem<S>;
  const uint64_t rb = row_bytes(S, a.N);
  const uint64_t dy_dims[2] = {(uint64_t)a.N, (uint64_t)a.rows}, dy_pitch[1] = {(uint64_t)a.N * 2};
  const uint32_t dy_box[2] = {DXW_STEP, DXW_ROWS};
  const uint64_t w_dims[3] = {S == kBF16 ? (uint64_t)a.N : rb, (uint64_t)a.K, (uint64_t)a.E};
  const uint64_t w_pitch[2] = {rb, rb * (uint64_t)a.K};
  const uint32_t w_box[3] = {S == kFP6 ? DXW_STEP * 3 / 4 : DXW_STEP, DXW_COLS, 1};
  CUtensorMap map_dy, map_w;
  if (!hopper::encode_map(&map_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, dy_dims, dy_pitch,
                          dy_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&map_w,
                          S == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          3, a.w, w_dims, w_pitch, w_box,
                          S == kBF16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const DxwArgs w{plan, a.scales, a.out, a.rows, a.K, a.N, a.ng, a.g, a.E,
                  (a.K + DXW_COLS - 1) / DXW_COLS};
  if ((long long)w.cols * items > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_dx_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  gmm_dx_wgmma_kernel<S><<<w.cols * items, DXW_THREADS, L::kBytes, st>>>(map_dy, map_w, w);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_dx(const Args& a, int tm, cudaStream_t st) {
  const dim3 grid((a.K + DX_BK - 1) / DX_BK, a.rows / tm);
  if (tm == 16) gmm_dx_kernel<S, 16><<<grid, kThreads, 0, st>>>(a);
  else gmm_dx_kernel<S, 64><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: dx [Mp, K] bf16 = dy [Mp, N] bf16 @ W[tile]^T,
// W bf16 [E, K, N] (scheme 0, scales null) or carriers as in
// ds_grouped_matmul (schemes 1-3, scales fp32 [E, K, ng]); tile_expert
// int32 [Mp / tm]; used_tiles int32 [1]; tm 16 or 64. With a work plan
// (int32 [plan_items, 5], built by the wrapper from tile_expert and
// used_tiles) the wgmma design runs, and the call is refused unless TMA can
// read dy and W; without one, the general design. Returns
// cudaGetLastError() of the launch.
extern "C" int ds_gmm_dx(const void* dy, const void* w, const void* scales,
                         const void* tile_expert, const void* used_tiles, void* dx, int Mp,
                         int K, int N, int ng, int E, int scheme, int tm, const void* plan,
                         int plan_items, void* stream) {
  Args a{static_cast<const uint16_t*>(dy), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scales), static_cast<const int32_t*>(tile_expert),
         static_cast<const int32_t*>(used_tiles), static_cast<uint16_t*>(dx), nullptr,
         Mp, K, N, ng, ng > 0 ? N / ng : 0, E, BK};
  if (bad_args(a, scheme, tm) || E <= 0 || Mp % tm != 0 || tile_expert == nullptr ||
      used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan != nullptr) {
    if (plan_items <= 0 || !dx_wgmma_ok(a, scheme)) return (int)cudaErrorInvalidValue;
    const int32_t* p = static_cast<const int32_t*>(plan);
    switch (scheme) {
      case kBF16: return (int)launch_dx_wgmma<kBF16>(a, p, plan_items, st);
      case kInt8: return (int)launch_dx_wgmma<kInt8>(a, p, plan_items, st);
      case kFP8: return (int)launch_dx_wgmma<kFP8>(a, p, plan_items, st);
      default: return (int)launch_dx_wgmma<kFP6>(a, p, plan_items, st);
    }
  }
  switch (scheme) {
    case kBF16: return (int)launch_dx<kBF16>(a, tm, st);
    case kInt8: return (int)launch_dx<kInt8>(a, tm, st);
    case kFP8: return (int)launch_dx<kFP8>(a, tm, st);
    default: return (int)launch_dx<kFP6>(a, tm, st);
  }
}

// Plain C entry for ctypes: dw [E, K, N] bf16 = per expert, the sum over its
// row tiles of x_tile^T @ dy_tile; x [Mp, K], dy [Mp, N] bf16; tile_expert
// int32 [Mp / tm], each expert's used tiles contiguous (tile_layout);
// used_tiles int32 [1]. Returns cudaGetLastError() of the launch.
extern "C" int ds_gmm_dw(const void* x, const void* dy, const void* tile_expert,
                         const void* used_tiles, void* dw, int Mp, int K, int N, int E, int tm,
                         void* stream) {
  if (Mp <= 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || (tm != 16 && tm != 64) ||
      Mp % tm != 0 || x == nullptr || dy == nullptr || tile_expert == nullptr ||
      used_tiles == nullptr || dw == nullptr || (K + DW_B - 1) / DW_B > 65535)
    return (int)cudaErrorInvalidValue;
  DwArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
           static_cast<const int32_t*>(tile_expert), static_cast<const int32_t*>(used_tiles),
           static_cast<uint16_t*>(dw), Mp, K, N, E, tm};
  const dim3 grid((N + DW_B - 1) / DW_B, (K + DW_B - 1) / DW_B, E);
  gmm_dw_kernel<<<grid, DW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
