// The tile GEMM shared by fused_quant_matmul.cu (K4) and grouped_matmul.cu
// (K5): out[M, N] = x[M, K] (bf16) @ W[K, N], where W is a bf16 weight or
// a grouped quantized carrier decoded on the way into shared memory, for
// one weight or, row tile by row tile, for the expert each tile belongs to.
//
// Carriers (the grouped layout of inference/quantization): int8 or
// float8_e4m3fn bytes [K, N], or packed fp6 e3m2 [K, 3N/4] (4 codes per
// little-endian 24-bit word, at bit offsets 0/6/12/18), beside fp32 scales
// [K, ng], group width g = N / ng. Weight (k, n) is decode(code) *
// scales[k, n / g] in fp32, rounded to bf16 with __float2bfloat16_rn, which
// is JAX's (w * s).astype(bfloat16): the products then see exactly the
// bf16 weights that dequantize_grouped gives, and only the fp32 summation
// order differs from the plain versions.
//
// Block: 128 threads, a BM x 64 output tile (BM = 16 for decode-sized
// batches, with the four warps side by side over the columns; BM = 64
// otherwise, one 16-row slab per warp), a K loop in steps of 32:
//   1. the x tile and the raw carrier tile (32 rows x 64 columns' bytes)
//      are read into shared memory as 16-byte vectors where the address
//      is aligned and the row holds 16 more bytes, byte by byte (or
//      element by element) where not: fp6 rows of 3N/4 bytes need not
//      start on a 16-byte boundary, and ragged K and N edges are
//      zero-filled, so every shape the layout allows is taken;
//   2. each thread decodes a fixed quad of columns in 4 rows (one 3-byte
//      fp6 word, or 4 int8/fp8 bytes), scales it with the per-(k, group)
//      scale and stores bf16 into the shared weight tile; a quad's group
//      indices are computed once, before the loop;
//   3. bf16 mma.sync.m16n8k16 tiles with fp32 accumulators, fed by
//      ldmatrix (the weight tile [k][n] through ldmatrix.trans).
// A bf16 weight skips step 2: its bytes land in the weight tile directly.
// This template is the general design of K4 (quant_matmul, dense_matmul)
// and of K5's forward (gmm over a bf16 stack, gmm_quant over carriers): the
// shapes TMA cannot read, and K5's bf16 stack at decode's 16-row tiles.
// K4's other calls run the Hopper designs of fused_quant_matmul.cu. What bounds
// it there is the weight bytes (on an H100 at 700 W, a decode call over
// Mixtral's bf16 w1 runs at ~82% of its byte bound). K5's forward at
// 64-row tiles, gmm_quant at 16-row tiles, its input gradient and its
// weight gradient run the Hopper designs in grouped_matmul.cu instead
// (wgmma fed by a TMA ring; through carriers, the decoders below fill
// swizzled bf16 tiles while the previous step's wgmma runs). Prefill-sized
// calls of this template are operations-bound and are not pipelined: no
// cp.async or TMA ring, no wgmma, no persistent schedule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qgemm {

enum Scheme : int { kBF16 = 0, kInt8 = 1, kFP8 = 2, kFP6 = 3 };

constexpr int kThreads = 128;
constexpr int BN = 64, BK = 32, kPad = 8;
constexpr int LDX = BK + kPad;  // bf16 per shared x row: 80 bytes
constexpr int LDW = BN + kPad;  // bf16 per shared weight row: 144 bytes

// carrier bytes of one row of a BN-column tile
__host__ __device__ constexpr int tile_bytes(int s) { return s == kBF16 ? 2 * BN : s == kFP6 ? BN / 4 * 3 : BN; }

// carrier bytes of one row of N columns, and the offset of column n0 (a
// multiple of 4) within it
__host__ __device__ inline size_t row_bytes(int s, int n) {
  return s == kBF16 ? (size_t)n * 2 : s == kFP6 ? (size_t)n / 4 * 3 : (size_t)n;
}

struct Args {
  const uint16_t* x;           // [rows, K] bf16
  const uint8_t* w;            // [E, K, row_bytes(N)] carriers or bf16
  const float* scales;         // [E, K, ng] fp32; null for bf16
  const int32_t* tile_expert;  // [rows / BM] each row tile's expert (grouped only)
  const int32_t* used_tiles;   // [1] tiles holding rows (grouped only)
  uint16_t* out;               // [rows, N] bf16
  float* partial;              // [splits, rows, N] fp32 sums of a split K, or null
  int rows, K, N, ng, g, E, k_chunk;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix.x4 lane address over a 16 x 16 block at (row0, col0) of a shared
// tile with leading dimension LD, matrices ordered (rows 0-7, cols 0-7),
// (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15): the
// A fragment of m16n8k16, or, with .trans, the B fragments of two n8 tiles
// of a [k][n] tile
template <int LD>
__device__ __forceinline__ const uint16_t* a_order(const uint16_t* t, int row0, int col0,
                                                   int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return t + (row0 + (mi & 1) * 8 + r) * LD + col0 + (mi >> 1) * 8;
}

// float8_e4m3fn byte -> fp32, exactly (bias 7; no infinities, and carriers
// hold no NaN)
__device__ __forceinline__ float fp8_to_float(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xFu, m = b & 7u;
  const float v = e == 0u ? (float)m * 0.001953125f  // subnormal: m * 2^-9
                          : __uint_as_float(((e + 120u) << 23) | (m << 20));
  return (b & 0x80u) ? -v : v;
}

// e3m2 code -> fp32 (_decode_e3m2): magnitudes 0..7 are the grid
// +-mag * 2^-4, the rest are assembled as fp32 bits (exponent E - 3 + 127)
__device__ __forceinline__ float e3m2_to_float(uint32_t c) {
  const uint32_t mag = c & 0x1Fu;
  if (mag < 8u) return ((c & 0x20u) ? -0.0625f : 0.0625f) * (float)mag;
  return __uint_as_float(((c & 0x20u) << 26) | (((mag >> 2) + 124u) << 23) |
                         ((mag & 3u) << 21));
}

// The same fp32 values as (float)(int8_t)b, fp8_to_float and e3m2_to_float,
// bit for bit (checked over every code), computed on the integer and FMA
// pipes: no int-to-float conversion (a quarter-rate instruction on Hopper)
// and no branch. int8: byte t of w ^ 0x80808080 is x + 128, placed under
// the fp32 exponent of 2^23 and 2^23 + 128 taken off. fp8 and e3m2: the
// code's exponent and mantissa bits placed in fp32's (a zero exponent
// lands on an fp32 subnormal), then scaled by 2^(127 - bias).
__device__ __forceinline__ float int8_code(uint32_t w_x80, int t) {
  return __uint_as_float(__byte_perm(w_x80, 0x4B000000u, 0x7440u | (uint32_t)t)) - 8388736.f;
}

__device__ __forceinline__ float fp8_code(uint32_t b) {  // the code in bits 0-7
  return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) * 0x1p120f;
}

__device__ __forceinline__ float e3m2_code(uint32_t c) {  // the code in bits 0-5
  return __uint_as_float(((c & 0x20u) << 26) | ((c & 0x1Fu) << 21)) * 0x1p124f;
}

// G: grouped (K5, one expert per row tile) or one weight (K4); the two are
// separate instances, so a profile tells them apart by name
template <int S, int BM, bool G>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(const Args a) {
  constexpr int WM = BM / 16;   // warps along the rows
  constexpr int WC = BN * WM / 4;  // columns per warp
  constexpr int NT = WC / 8;    // n8 tiles per warp
  constexpr int TB = tile_bytes(S);
  constexpr int DST_LD = S == kBF16 ? LDW * 2 : TB;  // bytes per row where raw bytes land
  __shared__ __align__(16) uint16_t sX[BM * LDX];
  __shared__ __align__(16) uint16_t sW[BK * LDW];
  __shared__ __align__(16) uint8_t sRaw[S == kBF16 ? 16 : BK * TB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wr = (warp % WM) * 16, wc = (warp / WM) * WC;

  int e = 0;
  if constexpr (G) {
    e = (int)blockIdx.y < *a.used_tiles ? a.tile_expert[blockIdx.y] : -1;
    if (e < 0 || e >= a.E) {  // a tile with no rows: zeros, and no weight is read
      for (int i = tid; i < BM * BN; i += kThreads) {
        const int r = m0 + i / BN, c = n0 + i % BN;
        if (r < a.rows && c < a.N) a.out[(size_t)r * a.N + c] = 0;
      }
      return;
    }
  }
  const size_t rb = row_bytes(S, a.N);
  const uint8_t* wbase = a.w + (size_t)e * a.K * rb;
  const float* sbase = S == kBF16 ? nullptr : a.scales + (size_t)e * a.K * a.ng;
  const size_t tb0 = row_bytes(S, n0);
  const int vb = (int)(rb - tb0 < (size_t)TB ? rb - tb0 : (size_t)TB);  // valid tile bytes
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  uint8_t* raw = S == kBF16 ? reinterpret_cast<uint8_t*>(sW) : sRaw;

  // this thread decodes columns 4 cq .. 4 cq + 3 in rows r0 + 8 i
  const int cq = tid & 15, r0 = tid >> 4;
  int grp[4];
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 4 * cq + j;
    col_ok[j] = col < a.N;
    grp[j] = col_ok[j] ? col / a.g : 0;
  }
  const bool one_group = col_ok[3] && grp[0] == grp[3];

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // One K step's global reads are held in registers: the next step's are
  // issued right after this step's reach shared memory, so their latency
  // runs under this step's decode and MMAs.
  constexpr int XC = (BM * (BK / 8) + kThreads - 1) / kThreads;  // x vectors per thread
  constexpr int RC = (BK * (TB / 16) + kThreads - 1) / kThreads;  // carrier vectors per thread
  uint4 xv[XC], wv[RC];
  float sv[BK / 8][4];  // scales of the rows and columns this thread decodes

  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int row = m0 + r, kc = k0 + c;
      union { uint4 v; uint16_t h[8]; } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (i < BM * (BK / 8) && row < a.rows) {
        const uint16_t* src = a.x + (size_t)row * a.K + kc;
        if (kc + 8 <= k_end && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          u.v = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) u.h[j] = kc + j < k_end ? src[j] : (uint16_t)0;
        }
      }
      xv[q] = u.v;
    }
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int i = tid + q * kThreads;
      const int r = i / (TB / 16), c = (i % (TB / 16)) * 16;
      const int kr = k0 + r;
      union { uint4 v; uint8_t b[16]; } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (i < BK * (TB / 16) && kr < k_end && c < vb) {
        const uint8_t* src = wbase + (size_t)kr * rb + tb0 + c;
        if (c + 16 <= vb && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          u.v = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) u.b[j] = c + j < vb ? src[j] : (uint8_t)0;
        }
      }
      wv[q] = u.v;
    }
    if constexpr (S != kBF16) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int kr = k0 + r0 + 8 * i;
        sv[i][0] = sv[i][1] = sv[i][2] = sv[i][3] = 0.f;  // rows past the K range, columns past N
        if (kr < k_end) {
          const float* srow = sbase + (size_t)kr * a.ng;
          if (one_group) {
            sv[i][0] = sv[i][1] = sv[i][2] = sv[i][3] = srow[grp[0]];
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) sv[i][j] = col_ok[j] ? srow[grp[j]] : 0.f;
          }
        }
      }
    }
  };

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const int i = tid + q * kThreads;
      if (i < BM * (BK / 8))
        *reinterpret_cast<uint4*>(sX + (i / (BK / 8)) * LDX + (i % (BK / 8)) * 8) = xv[q];
    }
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int i = tid + q * kThreads;
      if (i < BK * (TB / 16))
        *reinterpret_cast<uint4*>(raw + (i / (TB / 16)) * DST_LD + (i % (TB / 16)) * 16) = wv[q];
    }
    float s[BK / 8][4];  // this step's scales: the fetch below overwrites sv
    if constexpr (S != kBF16) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = sv[i][j];
    }
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);

    if constexpr (S != kBF16) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int r = r0 + 8 * i;
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
        *reinterpret_cast<uint2*>(sW + r * LDW + 4 * cq) = w2;
      }
      __syncthreads();
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a_order<LDX>(sX, wr, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bb[4];
        ldsm_x4_t(bb, a_order<LDW>(sW, kk * 16, wc + nn * 16, lane));
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
        const int col = n0 + wc + nt * 8 + t4 * 2 + j;
        if (col >= a.N) continue;
        const float val = acc[nt][2 * half + j];
        if (a.partial != nullptr)
          a.partial[((size_t)blockIdx.z * a.rows + row) * a.N + col] = val;
        else
          a.out[(size_t)row * a.N + col] = __bfloat16_as_ushort(__float2bfloat16_rn(val));
      }
    }
  }
}

// out = bf16(sum over the splits of partial), the splits summed in order
__global__ void reduce_splits_kernel(const float* __restrict__ partial, uint16_t* __restrict__ out,
                                     size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
    out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
}

template <int S, int BM, bool G>
cudaError_t launch(const Args& a, int splits, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.rows + BM - 1) / BM, splits);
  qgemm_kernel<S, BM, G><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int S, bool G>
cudaError_t launch_bm(const Args& a, int bm, int splits, cudaStream_t st) {
  return bm == 16 ? launch<S, 16, G>(a, splits, st) : launch<S, 64, G>(a, splits, st);
}

// the shape checks every entry point makes before launching
inline bool bad_args(const Args& a, int scheme, int bm) {
  return a.rows <= 0 || a.K <= 0 || a.N <= 0 || a.ng <= 0 || a.N % a.ng != 0 ||
         scheme < kBF16 || scheme > kFP6 || (bm != 16 && bm != 64) ||
         (scheme == kFP6 && (a.g % 4 != 0)) || (scheme != kBF16 && a.scales == nullptr) ||
         a.k_chunk <= 0 || a.k_chunk % BK != 0 || (a.rows + bm - 1) / bm > 65535;
}

}  // namespace qgemm
