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
//   forward) take gmm_wgmma_kernel<S, true>, the ring below: the producer
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
//   gmm_wgmma_kernel<kBF16, true>, dx's design below with W read across
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

#include "hopper.cuh"
#include "quant_gemm.cuh"

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

// ---------------------------------------------------------------------------
// gmm_wgmma_kernel: the Hopper design of the forward (FWD: out = x @ W[e],
// a bf16 stack or carriers) and of dx (out = dy @ W[e]^T, a bf16 stack or
// carriers); the notes above say why. One template, so that the two share
// the producer, the ring, the work list and the zero fill: only the B
// operand differs. dx reads W [K rows][N] along its contraction N (K-major,
// one [256][64] box a stage); the forward reads W [K][N] across it
// (MN-major: four [64 K][64 N] bf16 boxes a stage, wgmma's B transposed,
// from TMA or from decode_fwd_stage).

constexpr int RING_ROWS = 128;     // output rows a block: two consumer warpgroups of 64
constexpr int RING_COLS = 256;     // output columns a block: wgmma's n
constexpr int RING_STEP = 64;      // contraction a stage: 128 bytes of bf16, the swizzle span
constexpr int RING_STAGES = 4;
constexpr int RING_THREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int RING_BOX = 64 * 64 * 2;  // one [64][64] bf16 TMA box: 8 KB
constexpr int PLAN_FIELDS = 5;     // int32 fields of a work item

template <int S>
struct RingSmem {
  static constexpr int kA = RING_ROWS * RING_STEP * 2;  // one stage of x or dy: 16 KB
  static constexpr int kB = RING_COLS * RING_STEP * 2;  // one stage of bf16 W: 32 KB
  static constexpr int kRaw =                           // one stage of W as stored
      S == kBF16 ? kB : S == kFP6 ? RING_COLS * RING_STEP * 3 / 4 : RING_COLS * RING_STEP;
  static constexpr int kDec = S == kBF16 ? 0 : 3;       // decoded bf16 W tiles (carriers)
  static constexpr int kBar = RING_STAGES * (kA + kRaw) + kDec * kB;  // where the barriers start
  static constexpr int kBytes = kBar + 2 * RING_STAGES * 8 + 1024;    // + 1024-byte alignment slack
};

struct RingArgs {
  const int32_t* plan;  // [items, PLAN_FIELDS]: first row, rows, expert (-1: zero fill), the
                        // item's group: its first item and its item count
  const float* scales;  // [E, K, ng] fp32 (dx through carriers), else null
  uint16_t* out;        // [Mp, N] (forward) or [Mp, K] (dx) bf16
  int Mp, K, N, ng, g, E, cols;  // K, N: the stack's [E, K, N]; cols: column blocks of out
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

// The forward's carrier stage: W rows k0 .. k0 + 63 and columns c0 .. c0 +
// 255 of one expert as TMA lands them, int8/fp8 as two [64][128-byte]
// boxes, 128-byte swizzled (row k's 16-byte chunk j at chunk j ^ (k % 8)),
// fp6 as one plain [64][192-byte] box. Thread ct (0 .. 255) of the two
// consumer warpgroups decodes one W row k of the stage in one box b of 64
// columns (fwd_task): each quarter warp takes 8 consecutive rows of one box,
// so its 16-byte raw reads (int8/fp8) and decoded writes fall on 8
// distinct chunk positions, free of bank conflicts, and a warp spans few
// rows, so its scale loads touch few cache lines (a row's scales lie 4 ng
// bytes apart): 8 rows of all four boxes in the forward ring, 16 rows of
// the consumer's own two boxes in the decode design, whose consumers read
// only their own boxes. (tests/test_torch_gmm_quant_plan.py replicates
// this map.)
template <bool STREAM>
__device__ __forceinline__ int2 fwd_task(int ct) {  // → (row k, box b)
  const int lane = ct & 31, w = ct >> 5;
  if constexpr (STREAM)
    return make_int2(16 * (w & 3) + 8 * (lane >> 4) + (lane & 7), 2 * (w >> 2) + ((lane >> 3) & 1));
  return make_int2(8 * w + (lane & 7), lane >> 3);
}

template <int S>
__device__ __forceinline__ void load_fwd_chunks(const uint8_t* raw, int k, int b, Chunk (&ch)[4]) {
  if constexpr (S == kFP6) {  // 48 bytes: 64 codes, 16 to a chunk of 12 bytes
    const uint4* p = reinterpret_cast<const uint4*>(raw + k * 192 + 48 * b);
    const uint4 u0 = p[0], u1 = p[1], u2 = p[2];
    ch[0] = Chunk{{u0.x, u0.y, u0.z, 0u}};
    ch[1] = Chunk{{u0.w, u1.x, u1.y, 0u}};
    ch[2] = Chunk{{u1.z, u1.w, u2.x, 0u}};
    ch[3] = Chunk{{u2.y, u2.z, u2.w, 0u}};
  } else {
    const uint8_t* row = raw + (b >> 1) * RING_BOX + k * 128;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + (((4 * (b & 1) + t) ^ (k & 7)) << 4));
      ch[t] = Chunk{{u.x, u.y, u.z, u.w}};
    }
  }
}

// This thread's 64 weights of a forward stage (W row k, columns n0 .. n0 +
// 63), each decode(code) * scale rounded once to bf16, into box b of the
// four MN-major [64 K][64 N] boxes at dec, as TMA's
// 128-byte swizzle lays out the bf16 forward's boxes (row k at byte 128 k
// of the box, its 16-byte chunk c at chunk c ^ (k % 8)): sw128_mn_desc reads
// them. ONE_SCALE: the 64 columns share the scale `sc` (a group width that
// is a multiple of 64; 0 past K or N); else one scale an element from
// `srow` (the row's scales, null past K).
template <int S, bool ONE_SCALE>
__device__ __forceinline__ void decode_fwd_stage(const uint8_t* raw, uint8_t* dec, int2 task,
                                                 float sc, const float* srow, int n0, int N,
                                                 int g) {
  const int k = task.x, b = task.y;
  Chunk ch[4];  // every chunk read before the first store
  load_fwd_chunks<S>(raw, k, b, ch);
  uint8_t* drow = dec + b * RING_BOX + k * 128;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float v[16];
    decode16<S>(ch[t], v);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if constexpr (ONE_SCALE) {
        v[u] *= sc;
      } else {
        const int n = n0 + 16 * t + u;
        v[u] *= srow != nullptr && n < N ? __ldg(srow + n / g) : 0.f;
      }
    }
    uint32_t pk[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) pk[q] = pack_bf16(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(drow + (((2 * t) ^ (k & 7)) << 4)) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
    *reinterpret_cast<uint4*>(drow + (((2 * t + 1) ^ (k & 7)) << 4)) =
        make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
}

// A forward consumer thread's scales: W row 64 i + fk of expert e for step
// i (null past K), and its scale in group grp (-1: columns past N, scale
// 0), the row pointer stepped by 64 ng a step: one multiply-add and one
// load a step, no division in the loop (which cost an H100 ~7% at decode).
struct FwdScales {
  const float* base;  // row fk
  size_t step;        // 64 ng
  int rows, grp;      // steps i with 64 i < rows lie within K
  __device__ __forceinline__ FwdScales(const float* scales, int e, int K, int ng, int fk,
                                       int group)
      : base(scales + ((size_t)e * K + fk) * ng),
        step((size_t)RING_STEP * ng),
        rows(K - fk),
        grp(group) {}
  __device__ __forceinline__ const float* row(int i) const {
    return i * RING_STEP < rows ? base + i * step : nullptr;
  }
  __device__ __forceinline__ float scale(int i) const {
    return grp >= 0 && i * RING_STEP < rows ? __ldg(base + i * step + grp) : 0.f;
  }
};

// The forward's L2 prefetch of a stage's scale rows k0 .. k0 + 63 of expert
// e ([rows][ng] fp32, contiguous), issued by the producer with the stage's
// TMA. The blocks of one item walk K together, each thread loading its
// row's scale two steps before its decode: without this, the first touch
// of each scale row came from HBM under the carrier stream and outlasted
// the two steps. In the forward ring one block of each item (column block
// 0, launched first) prefetches for all of them; in the decode design every
// block does (measured faster there, and slower at training's 8192 rows).
__device__ __forceinline__ void prefetch_scales(const float* scales, int e, int K, int ng,
                                                int k0) {
  const float* p = scales + ((size_t)e * K + k0) * ng;
  const uint32_t bytes = (uint32_t)(min(RING_STEP, K - k0) * ng * 4) & ~15u;
  if (bytes > 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) hopper::prefetch_l2(p, bytes);
}

// zeros into rows [r_begin, r_end) and columns c0 .. c0 + 255 of a [rows][width] output
__device__ void zero_rows(uint16_t* out, int width, int r_begin, int r_end, int c0) {
  const int cols = min(RING_COLS, width - c0);
  for (int i = threadIdx.x; i < (r_end - r_begin) * cols; i += RING_THREADS)
    out[(size_t)(r_begin + i / cols) * width + c0 + i % cols] = 0;
}

// the 128 accumulators of a consumer warpgroup, rounded once to bf16, into
// rows r0 + (its rows) and columns c0 + (its columns) of a [.][width] output,
// rows at or past r_end and columns at or past width not written
__device__ __forceinline__ void store_acc(const float (&acc)[128], uint16_t* out, int width,
                                          int r0, int r_end, int c0) {
  const int lane = threadIdx.x & 31;
  const int rl = r0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);  // row of acc[4j]
  const bool pairs = (width & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < 32; ++jn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, col = c0 + 8 * jn + 2 * (lane & 3);
      if (r >= r_end || col >= width) continue;
      uint16_t* dst = out + (size_t)r * width + col;
      const float lo = acc[4 * jn + 2 * h], hi = acc[4 * jn + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
      } else {
        dst[0] = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
        if (col + 1 < width) dst[1] = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
      }
    }
  }
}

template <int S, bool FWD>
__global__ void __launch_bounds__(RING_THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  using L = RingSmem<S>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int width = FWD ? a.N : a.K, depth = FWD ? a.K : a.N;  // out columns, contraction

  // The block's item and column block: the blocks of a group (the items of
  // one run of an expert's tiles, or the zero fill) take its column blocks
  // in turn, its items fastest.
  // (Values every thread of a warp holds are broadcast from lane 0, so that
  // ptxas sees the branches they take as warp-uniform: wgmma in a path it
  // must treat as divergent is serialized.)
  const int32_t* grp = a.plan + (size_t)(blockIdx.x / a.cols) * PLAN_FIELDS;
  const int first = __shfl_sync(~0u, grp[3], 0), count = __shfl_sync(~0u, grp[4], 0);
  const int local = (int)blockIdx.x - first * a.cols;
  const int item = first + local % count, c0 = local / count * RING_COLS;
  const int32_t* work = a.plan + (size_t)item * PLAN_FIELDS;
  const int row0 = __shfl_sync(~0u, work[0], 0), rows = __shfl_sync(~0u, work[1], 0);
  const int e = __shfl_sync(~0u, work[2], 0);
  if (e < 0 || e >= a.E) {  // rows with no expert, or the rows past the used tiles: zeros
    if (rows > 0) {
      zero_rows(a.out, width, row0, row0 + rows, c0);
    } else {
      for (int r = row0 + RING_ROWS * (item - first); r < a.Mp; r += RING_ROWS * count)
        zero_rows(a.out, width, r, min(r + RING_ROWS, a.Mp), c0);
    }
    return;
  }

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                          // x / dy tiles [128 rows][64], 128-byte swizzle
  uint8_t* sW = sA + RING_STAGES * L::kA;      // W tiles as stored (carrier stages: see above)
  uint8_t* sDec = sW + RING_STAGES * L::kRaw;  // carriers decoded: bf16, 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + RING_STAGES;
  const int steps = (depth + RING_STEP - 1) / RING_STEP;
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
      // the forward's W stage: [64 K][256 N] as four bf16 [64][64] boxes, or
      // the carriers' two [64][128-byte] boxes (fp6: one [64][192-byte]); a
      // box wholly past N is not read (its columns are not stored)
      const int boxes = !FWD ? 1 : S == kBF16 ? min(4, (a.N - c0 + 63) / 64)
                                 : S == kFP6 ? 1 : min(2, (a.N - c0 + 127) / 128);
      const int w_bytes = FWD && S != kFP6 ? boxes * RING_BOX : L::kRaw;
      for (int i = 0; i < steps; ++i) {
        const int s = i % RING_STAGES;
        hopper::mbar_wait(&empty[s], ((i / RING_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kA + w_bytes);
        hopper::tma_load_2d(sA + s * L::kA, &map_a, &full[s], i * RING_STEP, row0);
        if constexpr (FWD && S != kBF16) {
          if (c0 == 0) prefetch_scales(a.scales, e, a.K, a.ng, i * RING_STEP);
        }
        if constexpr (FWD) {
          for (int j = 0; j < boxes; ++j)
            hopper::tma_load_3d(sW + s * L::kRaw + j * RING_BOX, &map_w, &full[s],
                                S == kBF16 ? c0 + 64 * j : S == kFP6 ? c0 / 4 * 3 : c0 + 128 * j,
                                i * RING_STEP, e);
        } else {
          hopper::tma_load_3d(sW + s * L::kRaw, &map_w, &full[s],
                              S == kFP6 ? i * RING_STEP * 3 / 4 : i * RING_STEP, c0, e);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;               // this consumer computes the item's rows 64 cw .. 64 cw + 63
  const int ct = tid - 128;            // 0 .. 255 among the consumers
  const bool active = 64 * cw < rows;  // a one-tile item leaves the second consumer idle
  float acc[128];  // the first step's first wgmma overwrites them

  // dx through carriers: this thread decodes columns 16 c .. 16 c + 15 of
  // each step in W rows (ct >> 2) + 64 j, j < 4; with a group width of a
  // multiple of 16 those columns share one scale a row. The forward: W row
  // fk of each step, columns fn .. fn + 63 (fwd_task, decode_fwd_stage), one
  // scale a step with a group width of a multiple of 64.
  const int c = ct & 3;
  const bool one_scale = a.g % (FWD ? 64 : 16) == 0;
  const float* srow[4];  // the scales of this thread's W rows, null past K
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = c0 + (ct >> 2) + 64 * j;
    srow[j] = S != kBF16 && !FWD && k < a.K ? a.scales + ((size_t)e * a.K + k) * a.ng : nullptr;
  }
  const int2 task = fwd_task<false>(ct);
  const int fk = task.x, fn = c0 + 64 * task.y;
  // the forward's scales of W row 64 i + fk (null past K), and with one
  // scale a step its scale: the address stepped, nothing divided in the loop
  const FwdScales fs(a.scales, e, a.K, a.ng, fk, fn < a.N ? fn / a.g : -1);
  auto fwd_srow = [&](int i) { return fs.row(i); };
  auto fwd_scale = [&](int i) { return fs.scale(i); };
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
      if constexpr (FWD) {  // the forward's rows change every step: no group to hold
        sc_even[0] = fwd_scale(0);
        sc_odd[0] = fwd_scale(1);
      } else {
        row_scales(16 * c, sc_even, grp_even);
        row_scales(RING_STEP + 16 * c, sc_odd, grp_odd);
      }
    }
  }

  // The step loop, with or without the wgmma (an idle consumer still
  // decodes its half of each carrier tile and releases each stage), and
  // with one scale a row and step or one an element: separate copies, so
  // that no branch around the wgmma inside the loop makes ptxas wait on
  // the accumulators it defines, and the decode has no branch at all.
  auto consume = [&](auto mma, auto row_scale) {
    auto step = [&](int i, float(&sc)[4], int& held) {
      const int s = i % RING_STAGES;
      hopper::mbar_wait(&full[s], (i / RING_STAGES) & 1);
      uint32_t b_addr = hopper::smem_addr(sW + s * L::kRaw);
      if constexpr (S != kBF16) {
        // decode into one of three bf16 tiles: the step before may still be
        // in the other consumer's wgmma, the one before that is done (its
        // wait came before the last barrier)
        uint8_t* dec = sDec + (i % 3) * L::kB;
        const uint8_t* raw = sW + s * L::kRaw;
        if constexpr (FWD) {
          decode_fwd_stage<S, decltype(row_scale)::value>(raw, dec, task, sc[0], fwd_srow(i),
                                                          fn, a.N, a.g);
        } else {
          const int n0 = i * RING_STEP;
          Chunk ch[4];  // every chunk read before the first store to the decoded tile
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ch[j] = load_chunk<S>(raw + ((ct >> 2) + 64 * j) * (L::kRaw / RING_COLS), c);
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
        }
        hopper::fence_proxy_async();
        hopper::named_sync(1, 256);
        b_addr = hopper::smem_addr(dec);
      }
      if constexpr (decltype(mma)::value) {
        const uint64_t da =
            hopper::sw128_desc(hopper::smem_addr(sA + s * L::kA) + cw * (L::kA / 2));
        // a 16-deep slice: 32 bytes on along a K-major row, 16 rows (2048
        // bytes) down an MN-major box
        const uint64_t db =
            FWD ? hopper::sw128_mn_desc(b_addr, RING_BOX) : hopper::sw128_desc(b_addr);
        constexpr int kStepB = FWD ? 2048 / 16 : 2;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RING_STEP / 16; ++kk)
          hopper::wgmma_m64n256k16<0, FWD ? 1 : 0>(acc, da + 2 * kk, db + kStepB * kk,
                                                   i > 0 || kk > 0);
        hopper::wgmma_commit();
      }
      if constexpr (S != kBF16 && decltype(row_scale)::value) {
        // this set's next scales, two steps on, read while the wgmma runs
        if (i + 2 < steps) {
          if constexpr (FWD) sc[0] = fwd_scale(i + 2);
          else row_scales((i + 2) * RING_STEP + 16 * c, sc, held);
        }
      }
      if constexpr (decltype(mma)::value) {
        hopper::wgmma_wait<1>();  // the step before is done: release its stage
        hopper::fence_regs(acc);
      }
      if (i > 0 && (tid & 31) == 0) hopper::mbar_arrive(&empty[(i - 1) % RING_STAGES]);
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
  store_acc(acc, a.out + (size_t)row0 * width, width, 64 * cw, rows, c0);
}

// ---------------------------------------------------------------------------
// gmm_stream_kernel: the decode design of the forward through carriers
// (16-row tiles; the header note says why). A block owns one work item (up
// to 8 of an expert's 16-row tiles) and 256 output columns: the producer
// streams [64 K][256 N] carrier stages and the item's x tiles
// ([16 rows][64 K] TMA boxes, 128-byte swizzle) through the 4-stage ring;
// consumer warpgroup cw decodes boxes 2 cw and 2 cw + 1 of each stage
// (decode_fwd_stage: the same map and values as the forward ring) and
// multiplies them as A, MN-major, by the x tiles as B, K-major:
// out^T [64 N][16 NT rows] per box, NT = 1, 2, 4 or 8 tiles (a separate
// loop each, chosen before the ring starts). Each consumer reads only its
// own boxes, so a 128-thread named barrier publishes them.

template <int NT, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16xk16(float (&d)[8 * NT], uint64_t da, uint64_t db,
                                                 bool accumulate) {
  if constexpr (NT == 1) hopper::wgmma_m64n16k16<TA, TB>(d, da, db, accumulate);
  else if constexpr (NT == 2) hopper::wgmma_m64n32k16<TA, TB>(d, da, db, accumulate);
  else if constexpr (NT == 4) hopper::wgmma_m64n64k16<TA, TB>(d, da, db, accumulate);
  else hopper::wgmma_m64n128k16<TA, TB>(d, da, db, accumulate);
}

template <int S>
__global__ void __launch_bounds__(RING_THREADS, 1)
    gmm_stream_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  using L = RingSmem<S>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  // the item and column block, as gmm_wgmma_kernel takes them (values
  // broadcast from lane 0: warp-uniform to ptxas)
  const int32_t* grp = a.plan + (size_t)(blockIdx.x / a.cols) * PLAN_FIELDS;
  const int first = __shfl_sync(~0u, grp[3], 0), count = __shfl_sync(~0u, grp[4], 0);
  const int local = (int)blockIdx.x - first * a.cols;
  const int item = first + local % count, c0 = local / count * RING_COLS;
  const int32_t* work = a.plan + (size_t)item * PLAN_FIELDS;
  const int row0 = __shfl_sync(~0u, work[0], 0), rows = __shfl_sync(~0u, work[1], 0);
  const int e = __shfl_sync(~0u, work[2], 0);
  if (e < 0 || e >= a.E) {  // rows with no expert, or the rows past the used tiles: zeros
    if (rows > 0) {
      zero_rows(a.out, a.N, row0, row0 + rows, c0);
    } else {
      for (int r = row0 + RING_ROWS * (item - first); r < a.Mp; r += RING_ROWS * count)
        zero_rows(a.out, a.N, r, min(r + RING_ROWS, a.Mp), c0);
    }
    return;
  }

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                          // x tiles [16 NT rows][64 K], 128-byte swizzle
  uint8_t* sW = sA + RING_STAGES * L::kA;      // carrier stages as TMA lands them
  uint8_t* sDec = sW + RING_STAGES * L::kRaw;  // decoded: four MN-major bf16 boxes a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + RING_STAGES;
  const int steps = (a.K + RING_STEP - 1) / RING_STEP;
  const int tiles = rows / 16;  // the item's x tiles: 1 .. 8
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
      const int boxes = S == kFP6 ? 1 : min(2, (a.N - c0 + 127) / 128);
      const int w_bytes = S == kFP6 ? L::kRaw : boxes * RING_BOX;
      for (int i = 0; i < steps; ++i) {
        const int s = i % RING_STAGES, k0 = i * RING_STEP;
        hopper::mbar_wait(&empty[s], ((i / RING_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], tiles * 2048 + w_bytes);
        prefetch_scales(a.scales, e, a.K, a.ng, k0);
        for (int t = 0; t < tiles; ++t)
          hopper::tma_load_2d(sA + s * L::kA + t * 2048, &map_x, &full[s], k0, row0 + 16 * t);
        for (int j = 0; j < boxes; ++j)
          hopper::tma_load_3d(sW + s * L::kRaw + j * RING_BOX, &map_w, &full[s],
                              S == kFP6 ? c0 / 4 * 3 : c0 + 128 * j, k0, e);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1, ct = tid - 128;  // consumer cw decodes and multiplies boxes 2 cw, 2 cw + 1
  const int2 task = fwd_task<true>(ct);
  const int fk = task.x, fn = c0 + 64 * task.y;
  const FwdScales fs(a.scales, e, a.K, a.ng, fk, fn < a.N ? fn / a.g : -1);
  auto srow = [&](int i) { return fs.row(i); };
  auto row_scale = [&](int i) { return fs.scale(i); };
  const int nt = __shfl_sync(~0u, tiles <= 1 ? 1 : tiles <= 2 ? 2 : tiles <= 4 ? 4 : 8, 0);

  // The ring with NT x tiles and one scale a row and step or one an
  // element: separate copies, so that no branch sits around the wgmma in
  // the loop and the decode has none.
  auto run = [&](auto nt_c, auto one_scale) {
    constexpr int NT = decltype(nt_c)::value;
    constexpr bool ONE = decltype(one_scale)::value;
    float acc[2][8 * NT];  // the first step's first wgmma overwrites them
    float sc_even = ONE ? row_scale(0) : 0.f, sc_odd = ONE ? row_scale(1) : 0.f;
    auto step = [&](int i, float& sc) {
      const int s = i % RING_STAGES;
      hopper::mbar_wait(&full[s], (i / RING_STAGES) & 1);
      uint8_t* dec = sDec + (i % 3) * L::kB;
      decode_fwd_stage<S, ONE>(sW + s * L::kRaw, dec, task, sc, srow(i), fn, a.N, a.g);
      hopper::fence_proxy_async();
      hopper::named_sync(1 + cw, 128);
      const uint64_t db = hopper::sw128_desc(hopper::smem_addr(sA + s * L::kA));
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        // A: 64 N of one decoded box, MN-major, a 16-deep slice 2048 bytes
        // on; B: the x tiles, K-major, a slice 32 bytes on
        const uint64_t da =
            hopper::sw128_mn_desc(hopper::smem_addr(dec + (2 * cw + bb) * RING_BOX), RING_BOX);
#pragma unroll
        for (int kk = 0; kk < RING_STEP / 16; ++kk)
          wgmma_m64n16xk16<NT, 1, 0>(acc[bb], da + 128 * kk, db + 2 * kk, i > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if constexpr (ONE) {  // this set's next scale, two steps on, read while the wgmma runs
        if (i + 2 < steps) sc = row_scale(i + 2);
      }
      hopper::wgmma_wait<1>();  // the step before is done: release its stage
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      if (i > 0 && (tid & 31) == 0) hopper::mbar_arrive(&empty[(i - 1) % RING_STAGES]);
    };
    for (int i = 0; i < steps; i += 2) {
      step(i, sc_even);
      if (i + 1 < steps) step(i + 1, sc_odd);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    // acc[bb][4 j + 2 h + q]: W column 16 w + lane / 4 + 8 h of box 2 cw + bb
    // (w the warp within the warpgroup), x row 8 j + 2 (lane % 4) + q
    const int lane = tid & 31, wq = (tid & 127) >> 5;
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = c0 + 64 * (2 * cw + bb) + 16 * wq + (lane >> 2) + 8 * h;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int r = 8 * j + 2 * (lane & 3) + q;
            if (r >= rows || n >= a.N) continue;
            a.out[(size_t)(row0 + r) * a.N + n] =
                __bfloat16_as_ushort(__float2bfloat16_rn(acc[bb][4 * j + 2 * h + q]));
          }
        }
      }
    }
  };
  auto by_scale = [&](auto nt_c) {
    if (a.g % 64 == 0) run(nt_c, std::true_type{});
    else run(nt_c, std::false_type{});
  };
  if (nt == 1) by_scale(std::integral_constant<int, 1>{});
  else if (nt == 2) by_scale(std::integral_constant<int, 2>{});
  else if (nt == 4) by_scale(std::integral_constant<int, 4>{});
  else by_scale(std::integral_constant<int, 8>{});
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// what TMA needs for dx: 16-byte aligned bases and row pitches of dy and W
inline bool dx_wgmma_ok(const Args& a, int scheme) {
  return aligned16(a.x) && aligned16(a.w) && ((size_t)a.N * 2) % 16 == 0 &&
         row_bytes(scheme, a.N) % 16 == 0;
}

// what the forward and dW designs over bf16 need: 64-row tiles (dW's stages
// are whole tiles) and 16-byte aligned bases and rows of both bf16 operands
inline bool ring_ok(const void* p, const void* q, int K, int N, int tm) {
  return tm == 64 && aligned16(p) && aligned16(q) && K % 8 == 0 && N % 8 == 0;
}

// what the forward's carrier designs need: 16-byte aligned bases of x and
// the carriers, rows of x (K % 8) and of the carriers (N % 16 for int8 and
// fp8, N % 64 for fp6's 3N/4 bytes) a multiple of 16 bytes
inline bool quant_ring_ok(const Args& a, int scheme) {
  return aligned16(a.x) && aligned16(a.w) && a.K % 8 == 0 && row_bytes(scheme, a.N) % 16 == 0;
}

// W's tensor map: dx reads [256 K rows][64 N] a stage (K-major); the
// forward [64 K][64 N] bf16 boxes, or the carriers' raw [64 K][128 bytes]
// (int8, fp8: 128-byte swizzle) or [64 K][192 bytes] (fp6, plain)
template <int S, bool FWD>
bool encode_w_map(CUtensorMap* map, const Args& a) {
  const uint64_t rb = row_bytes(S, a.N);
  const uint64_t dims[3] = {S == kBF16 ? (uint64_t)a.N : rb, (uint64_t)a.K, (uint64_t)a.E};
  const uint64_t pitch[2] = {rb, rb * (uint64_t)a.K};
  const uint32_t box[3] = {FWD ? (S == kBF16 ? 64u : S == kFP6 ? 192u : 128u)
                               : (S == kFP6 ? RING_STEP * 3 / 4 : RING_STEP),
                           FWD ? (uint32_t)RING_STEP : RING_COLS, 1};
  const bool swizzle = S == kBF16 || (FWD && S != kFP6);
  return hopper::encode_map(
      map, S == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, a.w,
      dims, pitch, box, swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int S, bool FWD>
cudaError_t launch_wgmma(const Args& a, const int32_t* plan, int items, cudaStream_t st) {
  using L = RingSmem<S>;
  const int width = FWD ? a.N : a.K, depth = FWD ? a.K : a.N;
  const uint64_t a_dims[2] = {(uint64_t)depth, (uint64_t)a.rows};
  const uint64_t a_pitch[1] = {(uint64_t)depth * 2};
  const uint32_t a_box[2] = {RING_STEP, RING_ROWS};
  CUtensorMap map_a, map_w;
  if (!hopper::encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a_dims, a_pitch,
                          a_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_w_map<S, FWD>(&map_w, a))
    return cudaErrorInvalidValue;
  const RingArgs w{plan, a.scales, a.out, a.rows, a.K, a.N, a.ng, a.g, a.E,
                   (width + RING_COLS - 1) / RING_COLS};
  if ((long long)w.cols * items > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_kernel<S, FWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  gmm_wgmma_kernel<S, FWD><<<w.cols * items, RING_THREADS, L::kBytes, st>>>(map_a, map_w, w);
  return cudaGetLastError();
}

// the decode design: x as [16 rows][64 K] boxes, the carriers as the
// forward ring reads them; the same work list and RingArgs
template <int S>
cudaError_t launch_stream(const Args& a, const int32_t* plan, int items, cudaStream_t st) {
  using L = RingSmem<S>;
  const uint64_t x_dims[2] = {(uint64_t)a.K, (uint64_t)a.rows}, x_pitch[1] = {(uint64_t)a.K * 2};
  const uint32_t x_box[2] = {RING_STEP, 16};
  CUtensorMap map_x, map_w;
  if (!hopper::encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, x_dims, x_pitch,
                          x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_w_map<S, true>(&map_w, a))
    return cudaErrorInvalidValue;
  const RingArgs w{plan, a.scales, a.out, a.rows, a.K, a.N, a.ng, a.g, a.E,
                   (a.N + RING_COLS - 1) / RING_COLS};
  if ((long long)w.cols * items > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_stream_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  gmm_stream_kernel<S><<<w.cols * items, RING_THREADS, L::kBytes, st>>>(map_x, map_w, w);
  return cudaGetLastError();
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
