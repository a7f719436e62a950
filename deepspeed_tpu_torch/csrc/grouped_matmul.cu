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
// tile_expert[tile]. Tiles at or past *used_tiles, which the routing writes
// on the device, hold no rows: they are written as zeros and no weight is
// read for them, so an expert with no rows costs nothing and the host never
// learns the count. Quantized carriers are decoded and scaled into bf16 in
// shared memory exactly as dequantize_grouped does (quant_gemm.cuh).
//
// The designs, chosen by the wrapper from (scheme, tm, K, N, alignment)
// before the launch, never from the routing:
//
// - Shapes TMA cannot read (unaligned bases, rows of x or W not a multiple
//   of 16 bytes: fp6 rows of 27 bytes, ragged N) and a bf16 stack at
//   decode's 16-row tiles take quant_gemm.cuh's qgemm_kernel, the general
//   design: a (row tile, 64 columns) block on mma.sync, its carrier stream
//   not pipelined against the decode and the MMAs (a bf16 stack at decode
//   runs at ~82% of its byte bound there; carriers at 14%).
// - Carriers at 64-row tiles (serving prefill, the frozen-base training
//   forward) take gmm_wgmma_kernel<S, true>, the ring (ring_gemm.cuh): the producer
//   TMAs each [64 K][256 N] stage of raw carrier bytes, the consumers
//   decode it (decode_fwd_stage) into the four MN-major [64 K][64 N] bf16
//   boxes that TMA gives the bf16 forward, while the previous stage's
//   wgmma runs. What bounds it: at a 528-row prefill chunk through
//   Mixtral's w1 int8, the 469.8 MB of carriers (0.14 ms at 3.35 TB/s)
//   against 62 GFLOP (63 us at 989 TFLOP/s), bytes; at 8192 training rows,
//   operations. The work list puts an expert's rows (up to 128) in one
//   item, so each carrier byte of a touched expert is read and decoded once
//   per 256-column block; the first design's grid fetched and decoded it
//   once per 64-row tile.
// - Carriers at 16-row tiles (decode) take gmm_stream_kernel, whose
//   operands are swapped: out^T [N, rows] = W[e]^T x^T, the decoded box
//   the A operand (64 N a wgmma, read MN-major) and the item's few 16-row
//   x tiles B (K-major, m64n{16,32,64,128}k16), so the same decoder feeds
//   a product 16 rows wide. What bounds it: the weight bytes (decoding 8
//   tokens, 16 rows top-2, through one Mixtral layer's [8, 4096, 14336]
//   int8 stack reads 469.8 MB of carriers and 3.7 MB of scales when every
//   expert is hit, ~141 us at 3.35 TB/s). The ring keeps 4 stages of 16 KB
//   of carriers in flight an SM. Mixtral's w2 gives 8 x 16 = 128 blocks for
//   132 SMs, and streams its bytes as fast as w1's 448 blocks do; a split
//   of K into 2 or 4 (fp32 partials summed in order) measured slower on an
//   H100, so K is not split and each output is written once.
// Both carrier designs decode on the integer and FMA pipes (decode16), read
// a touched expert's carriers once per item (up to 128 rows) and column
// block, and never read a weight for the rows past *used_tiles.
// - A bf16 stack at 64-row tiles (training, serving prefill) whose x and W
//   TMA can read (16-byte aligned bases, K % 8 and N % 8) takes
//   gmm_wgmma_kernel<kBF16, true>, dx's design (ring_gemm.cuh) with W read across
//   its rows. What bounds it: operations; at Mixtral's w1 and 8192 rows,
//   9.6e11 flops, 0.97 ms at 989 TFLOP/s, against 1.12 GB of x, the
//   touched W and the output (0.33 ms at 3.35 TB/s). The first design's
//   64 x 64 mma.sync blocks moved ~30 GB from L2 at 32 flops a byte, and
//   its column-fastest grid swept each expert's 117 MB of W past the 50 MB
//   L2 (6.2 ms at w1 on an H100 at 700 W). What this one does: 128 x 256 output tiles on
//   wgmma, 85 flops a loaded byte, fed by the TMA ring, over the work list
//   whose blocks take one expert's items fastest, so its x rows and one W
//   column block stay in L2 while they are read.

#include <climits>
#include <type_traits>

#include "ring_gemm.cuh"

using namespace qgemm;

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
// What the wgmma design (gmm_wgmma_kernel<S, false>) does about that:
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
//  - a work list built on the device (gmm_plan_kernel, one thread, one
//    launch) puts up to 128 / tm consecutive tiles of one expert in an
//    item, so no block mixes
//    experts; the blocks of one expert's run take its column blocks in
//    turn, its items fastest, so its dy rows and each W column block stay
//    in the 50 MB L2 while they are read, and the list's spare slots write
//    the zeros of the rows past *used_tiles.
// TMA wants 16-byte aligned bases and rows of dy and W a multiple of 16
// bytes (N % 8 for bf16, N % 16 for int8 and fp8, N % 64 for fp6); the
// wrapper gives other shapes to the first design, chosen by shape before
// the launch and counted by design. The forward is the same kernel with
// FWD set: x [rows][K] is A (K-major, as dy is), and W [K][N] is B read
// across its rows, MN-major (N contiguous): each stage is four [64 K][64
// N] TMA boxes of a bf16 stack, read by wgmma with its B transposed, or
// the raw carrier bytes of [64 K][256 N] decoded into the same four boxes.
//
// dW[e] = sum over expert e's row tiles of x_tile^T dy_tile replaces
// _gmm_dw_kernel (the `pl.pallas_call` in _gmm_dw_raw): x [Mp, K] and dy
// [Mp, N] bf16, fp32 sums rounded once to bf16 [E, K, N] (the TPU package
// sums in fp32 and casts to the weight's dtype: the same bits at half the
// bytes). Each output tile is written once by one block (no atomics, no
// split of the rows), so the same inputs give the same bits; an expert
// with no rows gets zeros; pad rows are zero in x and dy and add nothing.
//
// What bounds dW on an H100: operations, the same 9.6e11 flops at w1
// against 1.24 GB of x (67 MB), dy (235 MB) and dW (940 MB), 0.37 ms at
// 3.35 TB/s. The first design (gmm_dw_kernel below: a 128 x 128 tile on
// mma.sync, 16 rows a step between two barriers, 8 MMAs a warp a step, one
// step of register prefetch, each block scanning tile_expert with shared
// atomics for its expert's run) was paced by its barriers and load
// latency: 6.0 ms at w1 on an H100 at 700 W. It remains for 16-row tiles,
// whose runs need not be whole 64-row stages, and for rows TMA cannot read.
//
// What the wgmma design (gmm_dw_wgmma_kernel) does about that: a block
// owns 128 K x 256 N of dW[e], two consumer warpgroups of 64 K rows on
// wgmma m64n256k16, both operands MN-major (x_tile^T: K contiguous; dy:
// N contiguous), the contraction 64 of the expert's rows a stage on the
// same 4-stage TMA ring (48 KB a stage); the block's first warp finds its
// expert's run (first tile, tiles) among the used tiles with two warp
// reductions before the ring starts, which replaces the shared-atomic scan
// (136 tiles at 8192 rows: five loads a lane); within an expert the output
// dimension whose operand is the smaller slab runs fastest (K blocks at
// w1, where x[e] is at most 16 MB and dy[e] 59 MB; N blocks at w2), so
// that slab stays in L2 while the other operand's slice is held. Each
// block takes one tile: a persistent grid, its blocks looping over tiles
// with the ring running on across them, measured no faster on an H100.

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

// ---------------------------------------------------------------------------
// gmm_dw_wgmma_kernel: the Hopper design of dW (the note above says why).
// A block owns 128 K x 256 N of dW[e]: consumer warpgroup cw the K rows
// 64 cw .. 64 cw + 63. A stage is 64 of the expert's rows: x [64 rows][128
// K] as two [64 rows][64 K] boxes (A = x^T, MN-major: M = K is contiguous)
// and dy [64 rows][256 N] as four [64 rows][64 N] boxes (B, MN-major).

constexpr int DWW_K = 128;  // dW rows (K) a block: two consumer warpgroups of 64

struct DwwSmem {
  static constexpr int kA = 2 * RING_BOX;  // a stage of x: 16 KB
  static constexpr int kB = 4 * RING_BOX;  // a stage of dy: 32 KB
  static constexpr int kBar = RING_STAGES * (kA + kB);
  static constexpr int kBytes = kBar + 2 * RING_STAGES * 8 + 1024;
};

struct DwwArgs {
  const int32_t* tile_expert;  // [tiles]: each 64-row tile's expert
  const int32_t* used_tiles;   // [1]
  uint16_t* dw;                // [E, K, N] bf16
  int tiles, K, N, E, kblocks, nblocks;
  int k_fast;                  // 1: within an expert, K blocks run fastest
};

__global__ void __launch_bounds__(RING_THREADS, 1)
    gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy, const DwwArgs a) {
  using L = DwwSmem;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  // the expert slowest; within it the output dimension whose operand is the
  // smaller slab fastest, so that slab stays in L2 while the other's slice is held
  const int per_e = a.kblocks * a.nblocks;
  const int e = (int)blockIdx.x / per_e, local = (int)blockIdx.x % per_e;
  const int k0 = (a.k_fast ? local % a.kblocks : local / a.nblocks) * DWW_K;
  const int n0 = (a.k_fast ? local / a.kblocks : local % a.nblocks) * RING_COLS;
  // the expert's run among the used tiles, found by the first warp: its first
  // tile and its tile count (each expert's used tiles are one run, as
  // tile_layout makes them; gmm_dw_runs_ref is the plain version)
  __shared__ int s_run[2];
  if (tid < 32) {
    const int used = min(max(*a.used_tiles, 0), a.tiles);
    int first = INT_MAX, count = 0;
    for (int t = tid; t < used; t += 32) {
      if (a.tile_expert[t] == e) first = min(first, t), ++count;
    }
    first = __reduce_min_sync(~0u, first);
    count = __reduce_add_sync(~0u, count);
    if (tid == 0) s_run[0] = first, s_run[1] = count;
  }
  __syncthreads();
  const int tiles = __shfl_sync(~0u, s_run[1], 0);  // broadcast: warp-uniform to ptxas
  const int row0 = tiles > 0 ? __shfl_sync(~0u, s_run[0], 0) * 64 : 0, rows = tiles * 64;
  uint16_t* out = a.dw + (size_t)e * a.K * a.N;
  if (rows <= 0) {  // an expert with no rows: zeros, and nothing is read
    const int kc = min(DWW_K, a.K - k0), nc = min(RING_COLS, a.N - n0);
    for (int i = tid; i < kc * nc; i += RING_THREADS)
      out[(size_t)(k0 + i / nc) * a.N + n0 + i % nc] = 0;
    return;
  }

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                      // x boxes [64 rows][64 K], 128-byte swizzle
  uint8_t* sB = sA + RING_STAGES * L::kA;  // dy boxes [64 rows][64 N], 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + RING_STAGES;
  const int steps = rows / 64;
  if (tid == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
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
      // boxes wholly past K or N are not read (their rows and columns are not stored)
      const int xb = min(2, (a.K - k0 + 63) / 64), db = min(4, (a.N - n0 + 63) / 64);
      for (int i = 0; i < steps; ++i) {
        const int s = i % RING_STAGES;
        hopper::mbar_wait(&empty[s], ((i / RING_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], (xb + db) * RING_BOX);
        for (int j = 0; j < xb; ++j)
          hopper::tma_load_2d(sA + s * L::kA + j * RING_BOX, &map_x, &full[s], k0 + 64 * j,
                              row0 + 64 * i);
        for (int j = 0; j < db; ++j)
          hopper::tma_load_2d(sB + s * L::kB + j * RING_BOX, &map_dy, &full[s], n0 + 64 * j,
                              row0 + 64 * i);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;                  // this consumer computes dW rows k0 + 64 cw + (0..63)
  const bool active = k0 + 64 * cw < a.K;  // past K the second consumer only releases stages
  float acc[128];  // the first step's first wgmma overwrites them

  // the step loop with or without the wgmma: separate copies, as in gmm_wgmma_kernel
  auto consume = [&](auto mma) {
    for (int i = 0; i < steps; ++i) {
      const int s = i % RING_STAGES;
      hopper::mbar_wait(&full[s], (i / RING_STAGES) & 1);
      if constexpr (decltype(mma)::value) {
        const uint64_t da =
            hopper::sw128_mn_desc(hopper::smem_addr(sA + s * L::kA + cw * RING_BOX), RING_BOX);
        const uint64_t db = hopper::sw128_mn_desc(hopper::smem_addr(sB + s * L::kB), RING_BOX);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16 rows a slice: 2048 bytes down each box
          hopper::wgmma_m64n256k16<1, 1>(acc, da + 128 * kk, db + 128 * kk, i > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the step before is done: release its stage
        hopper::fence_regs(acc);
      }
      if (i > 0 && (tid & 31) == 0) hopper::mbar_arrive(&empty[(i - 1) % RING_STAGES]);
    }
  };
  if (!active) {
    consume(std::false_type{});
    return;
  }
  consume(std::true_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  store_acc(acc, out + (size_t)k0 * a.N, a.N, 64 * cw, a.K - k0, n0);
}

cudaError_t launch_dw_wgmma(const DwArgs& a, cudaStream_t st) {
  const uint64_t x_dims[2] = {(uint64_t)a.K, (uint64_t)a.rows}, x_pitch[1] = {(uint64_t)a.K * 2};
  const uint64_t dy_dims[2] = {(uint64_t)a.N, (uint64_t)a.rows};
  const uint64_t dy_pitch[1] = {(uint64_t)a.N * 2};
  const uint32_t box[2] = {64, 64};
  CUtensorMap map_x, map_dy;
  if (!hopper::encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, x_dims, x_pitch, box,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&map_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.dy, dy_dims, dy_pitch,
                          box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // x[e] is [rows][K], dy[e] [rows][N]: K blocks fastest when x's slab is the smaller
  const DwwArgs w{a.tile_expert, a.used_tiles, a.dw, a.rows / 64, a.K, a.N, a.E,
                  (a.K + DWW_K - 1) / DWW_K, (a.N + RING_COLS - 1) / RING_COLS, a.K <= a.N};
  const long long blocks = (long long)a.E * w.kblocks * w.nblocks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DwwSmem::kBytes);
  if (err != cudaSuccess) return err;
  gmm_dw_wgmma_kernel<<<(int)blocks, RING_THREADS, DwwSmem::kBytes, st>>>(map_x, map_dy, w);
  return cudaGetLastError();
}

// The work list of gmm_wgmma_kernel, built on the device in one launch
// (gmm_plan_ref in ops/kernels/grouped_matmul.py is its plain version: the
// same integers). One thread walks the used tiles once: an item starts at
// a run's first tile and every P tiles after it; the items tile the used
// tiles in order, so an item's rows end where the next item's begin.
__global__ void gmm_plan_kernel(const int32_t* __restrict__ te, const int32_t* __restrict__ used_p,
                                int T, int tm, int P, int bound, int32_t* __restrict__ plan) {
  const int used = min(max(*used_p, 0), T);
  int n = 0, run_start = 0, run_first = 0, prev = 0;
  for (int t = 0; t < used; ++t) {
    const int e = te[t];
    if (t == 0 || e != prev) run_start = t, run_first = n;
    if ((t - run_start) % P == 0) {
      if (n < bound) {
        int32_t* p = plan + (size_t)n * PLAN_FIELDS;
        p[0] = t * tm, p[2] = e, p[3] = run_first;
      }
      ++n;
    }
    prev = e;
  }
  n = min(n, bound);
  for (int i = n - 1, next_row = used * tm, end = n; i >= 0; --i) {
    int32_t* p = plan + (size_t)i * PLAN_FIELDS;
    if (i + 1 < n && p[3] != p[PLAN_FIELDS + 3]) end = i + 1;  // item i ends its run
    p[1] = next_row - p[0], p[4] = end - p[3];
    next_row = p[0];
  }
  for (int i = n; i < bound; ++i) {  // the zero fill: the rows past the used tiles
    int32_t* p = plan + (size_t)i * PLAN_FIELDS;
    p[0] = used * tm, p[1] = 0, p[2] = -1, p[3] = n, p[4] = bound - n;
  }
}

}  // namespace

// Plain C entry for ctypes: the work list of the wgmma forward and dx
// designs, plan int32 [bound, 5], from tile_expert int32 [T] and used_tiles
// int32 [1] (T = Mp / tm; P = 128 / tm tiles an item). Returns
// cudaGetLastError() of the launch.
extern "C" int ds_gmm_plan(const void* tile_expert, const void* used_tiles, int T, int tm,
                           int bound, void* plan, void* stream) {
  if (T <= 0 || (tm != 16 && tm != 64) || bound <= 0 || tile_expert == nullptr ||
      used_tiles == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gmm_plan_kernel<<<1, 1, 0, st>>>(
      static_cast<const int32_t*>(tile_expert), static_cast<const int32_t*>(used_tiles), T, tm,
      RING_ROWS / tm, bound, static_cast<int32_t*>(plan));
  return (int)cudaGetLastError();
}

// Plain C entry for ctypes. Device pointers to contiguous tensors: x bf16
// [Mp, K]; w bf16 [E, K, N] (scheme 0) or carriers int8 / float8_e4m3fn
// [E, K, N] or uint8 [E, K, 3N/4] (fp6); scales fp32 [E, K, ng] (null for
// scheme 0); tile_expert int32 [Mp / tm]; used_tiles int32 [1]; out bf16
// [Mp, N]. scheme: 0 bf16, 1 int8, 2 fp8, 3 fp6; tm: 16 or 64. With a work
// plan (int32 [plan_items, 5], built by the wrapper from tile_expert and
// used_tiles, as for ds_gmm_dx) a Hopper design runs, and the call is
// refused unless it takes the case: at tm 64 the forward ring (a bf16 stack
// or carriers), at tm 16 the decode design (carriers), both with x and W
// TMA can read. Without a plan, qgemm_kernel.
// The wrapper in ops/kernels/grouped_matmul.py checks shapes and types.
// Returns cudaGetLastError() of the launches.
extern "C" int ds_grouped_matmul(const void* x, const void* w, const void* scales,
                                 const void* tile_expert, const void* used_tiles, void* out,
                                 int Mp, int K, int N, int ng, int E, int scheme, int tm,
                                 const void* plan, int plan_items, void* stream) {
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scales), static_cast<const int32_t*>(tile_expert),
         static_cast<const int32_t*>(used_tiles), static_cast<uint16_t*>(out), nullptr,
         Mp, K, N, ng, ng > 0 ? N / ng : 0, E, (K + BK - 1) / BK * BK};
  if (bad_args(a, scheme, tm) || E <= 0 || Mp % tm != 0 || tile_expert == nullptr ||
      used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan != nullptr) {
    const int32_t* p = static_cast<const int32_t*>(plan);
    if (plan_items <= 0) return (int)cudaErrorInvalidValue;
    if (scheme == kBF16) {
      if (!ring_ok(x, w, K, N, tm)) return (int)cudaErrorInvalidValue;
      return (int)launch_wgmma<kBF16, true>(a, p, plan_items, st);
    }
    if (!quant_ring_ok(a, scheme)) return (int)cudaErrorInvalidValue;
    switch (scheme * 100 + tm) {
      case kInt8 * 100 + 64: return (int)launch_wgmma<kInt8, true>(a, p, plan_items, st);
      case kFP8 * 100 + 64: return (int)launch_wgmma<kFP8, true>(a, p, plan_items, st);
      case kFP6 * 100 + 64: return (int)launch_wgmma<kFP6, true>(a, p, plan_items, st);
      case kInt8 * 100 + 16: return (int)launch_stream<kInt8>(a, p, plan_items, st);
      case kFP8 * 100 + 16: return (int)launch_stream<kFP8>(a, p, plan_items, st);
      default: return (int)launch_stream<kFP6>(a, p, plan_items, st);
    }
  }
  switch (scheme) {
    case kBF16: return (int)launch_bm<kBF16, true>(a, tm, 1, st);
    case kInt8: return (int)launch_bm<kInt8, true>(a, tm, 1, st);
    case kFP8: return (int)launch_bm<kFP8, true>(a, tm, 1, st);
    default: return (int)launch_bm<kFP6, true>(a, tm, 1, st);
  }
}

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
      case kBF16: return (int)launch_wgmma<kBF16, false>(a, p, plan_items, st);
      case kInt8: return (int)launch_wgmma<kInt8, false>(a, p, plan_items, st);
      case kFP8: return (int)launch_wgmma<kFP8, false>(a, p, plan_items, st);
      default: return (int)launch_wgmma<kFP6, false>(a, p, plan_items, st);
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
// used_tiles int32 [1]. With wgmma set the wgmma design runs, and the call
// is refused unless it takes the case (tm 64, TMA-readable x and dy); else
// gmm_dw_kernel. Returns cudaGetLastError() of the launch.
extern "C" int ds_gmm_dw(const void* x, const void* dy, const void* tile_expert,
                         const void* used_tiles, void* dw, int Mp, int K, int N, int E, int tm,
                         int wgmma, void* stream) {
  if (Mp <= 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 || (tm != 16 && tm != 64) ||
      Mp % tm != 0 || x == nullptr || dy == nullptr || tile_expert == nullptr ||
      used_tiles == nullptr || dw == nullptr || (K + DW_B - 1) / DW_B > 65535)
    return (int)cudaErrorInvalidValue;
  DwArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
           static_cast<const int32_t*>(tile_expert), static_cast<const int32_t*>(used_tiles),
           static_cast<uint16_t*>(dw), Mp, K, N, E, tm};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!ring_ok(x, dy, K, N, tm)) return (int)cudaErrorInvalidValue;
    return (int)launch_dw_wgmma(a, st);
  }
  const dim3 grid((N + DW_B - 1) / DW_B, (K + DW_B - 1) / DW_B, E);
  gmm_dw_kernel<<<grid, DW_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
