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
// gmm_dx_kernel replaces _gmm_quant_dx_kernel (the `pl.pallas_call` in
// _gmm_quant_dx_raw) for carriers (schemes 1-3) and computes the input
// gradient of gmm (scheme 0), which the TPU package runs as _gmm_kernel on
// w.swapaxes(1, 2): dx[Mp, K] = dy[Mp, N] @ W[tile_expert]^T, W [E, K, N]
// read as it is stored (no transposed copy of the stack). A block owns a
// BM x 64 tile of dx (one row tile, 64 of the K outputs) and walks N in
// steps of 32: the dy tile as the A operand (ldmatrix), the W tile [64 k
// rows][32 n] decoded and scaled into bf16 in shared memory exactly as
// dequantize_grouped does (the forward's decode, quant_gemm.cuh) and fed as
// the B operand through ldmatrix without .trans, since [k][n] is the
// column-major [n][k] that mma.sync's B wants. Tiles at or past *used_tiles
// write zeros and read no weight.
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
// What bounds them on an H100: operations. dW of one Mixtral stack at
// T*k = 8192 rows is 2 * 8192 * 4096 * 14336 = 9.6e11 flops (0.97 ms at
// 989 TFLOP/s) against 0.32 GB of x, dy and dW (0.10 ms at 3.35 TB/s); dx
// is the same count. What the design does about that: tensor cores
// (mma.sync m16n8k16, fp32 accumulators), large output tiles so that each
// loaded byte feeds many MMAs, the next step's global reads held in
// registers while this step's MMAs run, and for dW a grid with the expert
// slowest so that one expert's rows stay in the 50 MB L2 while its tiles
// run. Not done yet: wgmma, TMA, a multi-stage pipeline.

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
// int32 [Mp / tm]; used_tiles int32 [1]; tm 16 or 64. Returns
// cudaGetLastError() of the launch.
extern "C" int ds_gmm_dx(const void* dy, const void* w, const void* scales,
                         const void* tile_expert, const void* used_tiles, void* dx, int Mp,
                         int K, int N, int ng, int E, int scheme, int tm, void* stream) {
  Args a{static_cast<const uint16_t*>(dy), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scales), static_cast<const int32_t*>(tile_expert),
         static_cast<const int32_t*>(used_tiles), static_cast<uint16_t*>(dx), nullptr,
         Mp, K, N, ng, ng > 0 ? N / ng : 0, E, BK};
  if (bad_args(a, scheme, tm) || E <= 0 || Mp % tm != 0 || tile_expert == nullptr ||
      used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
