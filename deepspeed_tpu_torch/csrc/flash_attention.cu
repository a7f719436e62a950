// Flash attention forward and backward for Hopper (sm_90a), bf16 in, fp32
// accumulation, on [B, S, H, D] tensors read with their strides.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   _fwd_kernel (the `pl.pallas_call` in _fwd_impl)  -> flash_fwd_kernel
//   _dkv_kernel (the first `pl.pallas_call` in _bwd_impl) -> flash_bwd_dkv_kernel
//   _dq_kernel  (the second `pl.pallas_call` in _bwd_impl) -> flash_bwd_dq_kernel
// Same math as those kernels:
//   forward  s = q k^T * sm_scale, masked to NEG_INF = -1e30 (finite) where
//            not valid; online softmax with m starting at NEG_INF,
//            alpha = exp(m_prev - m_new), p = exp(s - m_new), l += sum(p)
//            (fp32 p), acc = acc * alpha + bf16(p) v; o = acc / (l == 0 ? 1 : l),
//            lse = m + log(l == 0 ? 1 : l). A tile that is fully masked for a
//            row gives p = 1 there, which the next valid tile wipes with
//            alpha = 0, exactly as on the TPU.
//   backward p = valid ? exp(s - lse) : 0, dv += bf16(p)^T do,
//            dp = do v^T, ds = bf16(p * (dp - delta) * sm_scale),
//            dk += ds^T q, dq += ds k; delta = sum(do * o) comes from the
//            caller (fp32, [B, H, S]).
//   valid  = key < S, and query >= key when causal, and seg[query] ==
//            seg[key] when segment ids are given (the TPU `_mask`).
// The softmax runs in the exp2 domain (scores pre-multiplied by log2(e));
// lse is stored in the natural-log domain as the TPU kernel stores it.
//
// What bounds it at the training shape (B=4, S=2048, H=16, D=128, causal):
// operations. The forward does about 2 * 2 * B*H*S*S/2 * D = 6.9e10 flops
// against 4 * B*S*H*D * 2 = 67 MB of q/k/v/o traffic (about 1000 flops per
// byte, far above the H100's ~295 flops/byte balance point), so the tensor
// cores are the limit; the backward's five products likewise.
//
// What the design does about that:
//   - bf16 mma.sync.m16n8k16 tensor-core tiles with fp32 accumulators, fed
//     from shared memory by ldmatrix (ldmatrix.trans for the operands that
//     are used transposed), rows padded by 8 bf16 so the eight 16-byte row
//     reads of each ldmatrix phase fall on distinct banks;
//   - the S x S scores and probabilities never leave registers: the score
//     accumulator fragment is re-packed in place as the A operand of the
//     next product (the FlashAttention-2 register layout);
//   - causal tiles wholly above the diagonal are skipped, and the forward
//     and dQ grids run the longest query tiles first;
//   - strided [B, S, H, D] reads and writes replace the TPU's [BH, S, D]
//     transposes; rows past S are zero-filled in shared memory and never
//     written, so no padded copies are made.
// Not done yet (work for a later change): wgmma and TMA (the route to the
// card's full tensor-core rate), double-buffered cp.async K/V loads, and
// warp specialisation. Head dims 64 and 128 are instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;                 // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                           // bf16 of padding per shared row

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

// Lane addresses for ldmatrix.x4 over a 16 x 16 block at (row0, col0) of a
// shared tile with leading dimension LD. "A order" gives the four 8x8
// matrices as (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7,
// cols 8-15), (rows 8-15, cols 8-15): the A fragment of m16n8k16, or, with
// .trans, the B fragments of two n8 tiles of a [k][n] tile. "B order"
// swaps the middle two: the B fragments of two n8 tiles of an [n][k] tile.
template <int LD>
__device__ __forceinline__ const uint16_t* a_order(const uint16_t* t, int row0, int col0,
                                                   int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return t + (row0 + (mi & 1) * 8 + r) * LD + col0 + (mi >> 1) * 8;
}

template <int LD>
__device__ __forceinline__ const uint16_t* b_order(const uint16_t* t, int row0, int col0,
                                                   int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return t + (row0 + (mi >> 1) * 8 + r) * LD + col0 + (mi & 1) * 8;
}

// rows [row0, row0 + ROWS) of a [S, D] slice with row stride `rs` elements
// into a shared tile; rows at or past S are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint16_t* sm, const uint16_t* g, int row0, int S,
                                          size_t rs) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = i - (i / CH) * CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * rs + c * 8);
    *reinterpret_cast<uint4*>(sm + r * (D + kPad) + c * 8) = v;
  }
}

template <int N>
__device__ __forceinline__ void load_seg(int* sm, const int32_t* seg, int row0, int S) {
  for (int i = threadIdx.x; i < N; i += kThreads)
    sm[i] = (seg != nullptr && row0 + i < S) ? seg[row0 + i] : 0;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows r0 and r0 + 8 of a warp's 16-row fp32 accumulator [16, D] -> bf16
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* g, const float (*acc)[4], int r0, int S,
                                           size_t rs, int t, float f0, float f1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= S) continue;
    const float f = half ? f1 : f0;
    uint16_t* dst = g + (size_t)row * rs + t * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * half] * f, acc[dt][2 * half + 1] * f);
  }
}

// ---------------------------------------------------------------- forward
// grid (ceil(S / 64), B * H); 4 warps, each owning 16 query rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int32_t* __restrict__ seg,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int H, int S,
                 float scale_log2, int causal) {
  constexpr int BR = 64, BC = 64, LD = D + kPad;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + BR * LD;
  uint16_t* sV = sK + BC * LD;
  __shared__ int sSegQ[BR];
  __shared__ int sSegK[BC];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh - (bh / H) * H;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                 // the warp's first row in the tile

  load_tile<BR, D>(sQ, q + base, q0, S, rs);
  load_seg<BR>(sSegQ, segb, q0, S);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();                        // the previous tile's readers are done
    load_tile<BC, D>(sK, k + base, k0, S, rs);
    load_tile<BC, D>(sV, v + base, k0, S, rs);
    load_seg<BC>(sSegK, segb, k0, S);
    __syncthreads();

    float s[BC / 8][4];
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_order<LD>(sQ, wr, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bb[4];
        ldsm_x4(bb, b_order<LD>(sK, nn * 16, kk * 16, lane));
        mma16816(s[2 * nn], a, bb[0], bb[1]);
        mma16816(s[2 * nn + 1], a, bb[2], bb[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + (e >> 1) * 8;           // row within the tile
        const int cl = nt * 8 + t * 2 + (e & 1);        // key within the tile
        bool valid = k0 + cl < S;
        if (causal) valid = valid && (q0 + rl >= k0 + cl);
        if (segb != nullptr) valid = valid && (sSegQ[rl] == sSegK[cl]);
        const float x = valid ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        ldsm_x4_t(bb, a_order<LD>(sV, kk * 16, dn * 16, lane));
        mma16816(acc[2 * dn], a, bb[0], bb[1]);
        mma16816(acc[2 * dn + 1], a, bb[2], bb[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const float l_safe = lt == 0.f ? 1.f : lt;
    inv[r] = 1.f / l_safe;
    const int row = q0 + wr + g + r * 8;
    if (t == 0 && row < S) lse[(size_t)bh * S + row] = m[r] * kLn2 + logf(l_safe);
  }
  store_rows<D>(o + base, acc, q0 + wr + g, S, rs, t, inv[0], inv[1]);
}

// ---------------------------------------------------------- backward dK/dV
// grid (ceil(S / 64), B * H); 4 warps, each owning 16 keys; the block walks
// the query tiles 32 rows at a time.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int32_t* __restrict__ seg, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int H, int S, float scale_log2, float sm_scale,
                     int causal) {
  constexpr int BC = 64, BQ = 32, LD = D + kPad;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + BC * LD;
  uint16_t* sQ = sV + BC * LD;
  uint16_t* sdO = sQ + BQ * LD;
  __shared__ float sLse[BQ];
  __shared__ float sDelta[BQ];
  __shared__ int sSegQ[BQ];
  __shared__ int sSegK[BC];

  const int k0 = blockIdx.x * BC;
  const int bh = blockIdx.y, b = bh / H, h = bh - (bh / H) * H;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  const float* lseb = lse + (size_t)bh * S;
  const float* deltab = delta + (size_t)bh * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  load_tile<BC, D>(sK, k + base, k0, S, rs);
  load_tile<BC, D>(sV, v + base, k0, S, rs);
  load_seg<BC>(sSegK, segb, k0, S);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  // causal: query rows before k0 see none of this block's keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile<BQ, D>(sQ, q + base, q0, S, rs);
    load_tile<BQ, D>(sdO, dout + base, q0, S, rs);
    load_seg<BQ>(sSegQ, segb, q0, S);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < S;
      sLse[i] = in ? lseb[q0 + i] * kLog2e : 0.f;
      sDelta[i] = in ? deltab[q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp(K Q^T * scale - lse): this warp's 16 keys x BQ queries
    float p[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], av[4];
      ldsm_x4(a, a_order<LD>(sK, wr, kk * 16, lane));
      ldsm_x4(av, a_order<LD>(sV, wr, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < BQ / 16; ++nn) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, b_order<LD>(sQ, nn * 16, kk * 16, lane));
        mma16816(p[2 * nn], a, bq[0], bq[1]);
        mma16816(p[2 * nn + 1], a, bq[2], bq[3]);
        // dP^T = V dO^T
        ldsm_x4(bo, b_order<LD>(sdO, nn * 16, kk * 16, lane));
        mma16816(dp[2 * nn], av, bo[0], bo[1]);
        mma16816(dp[2 * nn + 1], av, bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = wr + g + (e >> 1) * 8;           // key within the tile
        const int ql = nt * 8 + t * 2 + (e & 1);        // query within the tile
        bool valid = (k0 + kl < S) && (q0 + ql < S);
        if (causal) valid = valid && (q0 + ql >= k0 + kl);
        if (segb != nullptr) valid = valid && (sSegQ[ql] == sSegK[kl]);
        const float pv = valid ? exp2f(p[nt][e] * scale_log2 - sLse[ql]) : 0.f;
        p[nt][e] = pv;
        dp[nt][e] = pv * (dp[nt][e] - sDelta[ql]) * sm_scale;   // dS^T
      }
    }
    // dV += P^T dO and dK += dS^T Q, contracting over the BQ queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t ap[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const uint32_t as[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, a_order<LD>(sdO, kk * 16, dn * 16, lane));
        mma16816(dv_acc[2 * dn], ap, bo[0], bo[1]);
        mma16816(dv_acc[2 * dn + 1], ap, bo[2], bo[3]);
        ldsm_x4_t(bq, a_order<LD>(sQ, kk * 16, dn * 16, lane));
        mma16816(dk_acc[2 * dn], as, bq[0], bq[1]);
        mma16816(dk_acc[2 * dn + 1], as, bq[2], bq[3]);
      }
    }
  }
  store_rows<D>(dk + base, dk_acc, k0 + wr + g, S, rs, t, 1.f, 1.f);
  store_rows<D>(dv + base, dv_acc, k0 + wr + g, S, rs, t, 1.f, 1.f);
}

// -------------------------------------------------------------- backward dQ
// grid (ceil(S / 64), B * H); 4 warps, each owning 16 query rows; the block
// walks the key tiles 64 at a time.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int32_t* __restrict__ seg, uint16_t* __restrict__ dq, int H, int S,
                    float scale_log2, float sm_scale, int causal) {
  constexpr int BR = 64, BC = 64, LD = D + kPad;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sdO = sQ + BR * LD;
  uint16_t* sK = sdO + BR * LD;
  uint16_t* sV = sK + BC * LD;
  __shared__ int sSegQ[BR];
  __shared__ int sSegK[BC];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int bh = blockIdx.y, b = bh / H, h = bh - (bh / H) * H;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  load_tile<BR, D>(sQ, q + base, q0, S, rs);
  load_tile<BR, D>(sdO, dout + base, q0, S, rs);
  load_seg<BR>(sSegQ, segb, q0, S);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    lse2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  const int kv_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();
    load_tile<BC, D>(sK, k + base, k0, S, rs);
    load_tile<BC, D>(sV, v + base, k0, S, rs);
    load_seg<BC>(sSegK, segb, k0, S);
    __syncthreads();

    float p[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int i = 0; i < BC / 8; ++i) {
      p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, a_order<LD>(sQ, wr, kk * 16, lane));
      ldsm_x4(ao, a_order<LD>(sdO, wr, kk * 16, lane));
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_order<LD>(sK, nn * 16, kk * 16, lane));
        mma16816(p[2 * nn], aq, bk[0], bk[1]);
        mma16816(p[2 * nn + 1], aq, bk[2], bk[3]);
        ldsm_x4(bv, b_order<LD>(sV, nn * 16, kk * 16, lane));
        mma16816(dp[2 * nn], ao, bv[0], bv[1]);
        mma16816(dp[2 * nn + 1], ao, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + (e >> 1) * 8;
        const int cl = nt * 8 + t * 2 + (e & 1);
        bool valid = k0 + cl < S;
        if (causal) valid = valid && (q0 + rl >= k0 + cl);
        if (segb != nullptr) valid = valid && (sSegQ[rl] == sSegK[cl]);
        const float pv = valid ? exp2f(p[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[nt][e] = pv * (dp[nt][e] - dlt[e >> 1]) * sm_scale;   // dS
      }
    }
    // dQ += dS K, contracting over the BC keys
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t as[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, a_order<LD>(sK, kk * 16, dn * 16, lane));
        mma16816(dq_acc[2 * dn], as, bk[0], bk[1]);
        mma16816(dq_acc[2 * dn + 1], as, bk[2], bk[3]);
      }
    }
  }
  store_rows<D>(dq + base, dq_acc, q0 + wr + g, S, rs, t, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t launch_cfg(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

bool bad_shape(int B, int H, int S, int D) {
  return B <= 0 || H <= 0 || S <= 0 || (D != 64 && D != 128) || (long long)B * H > 65535;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* lse, int B, int H, int S, float sm_scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(uint16_t) * 3 * 64 * (D + kPad);
  cudaError_t err = launch_cfg(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int32_t*>(seg),
      static_cast<uint16_t*>(o), static_cast<float*>(lse), H, S, sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                    int B, int H, int S, float sm_scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(uint16_t) * (2 * 64 + 2 * 32) * (D + kPad);
  cudaError_t err = launch_cfg(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      H, S, sm_scale * kLog2e, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                   int S, float sm_scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(uint16_t) * 4 * 64 * (D + kPad);
  cudaError_t err = launch_cfg(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<uint16_t*>(dq), H, S, sm_scale * kLog2e,
      sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous tensors: q/k/v/o/dout/dq/dk/dv bf16 [B, S, H, D]; lse/delta
// fp32 [B, H, S]; seg int32 [B, S] or null. The wrapper in
// ops/kernels/flash_attention.py checks shapes, types and alignment before
// calling. Each returns cudaGetLastError() of its launch.
extern "C" int ds_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* seg,
                                 void* o, void* lse, int B, int H, int S, int D, float sm_scale,
                                 int causal, void* stream) {
  if (bad_shape(B, H, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? fwd<64>(q, k, v, seg, o, lse, B, H, S, sm_scale, causal, st)
                       : fwd<128>(q, k, v, seg, o, lse, B, H, S, sm_scale, causal, st));
}

extern "C" int ds_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* seg, void* dk, void* dv, int B, int H, int S,
                                     int D, float sm_scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 64
                   ? bwd_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, sm_scale,
                                 causal, st)
                   : bwd_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, sm_scale,
                                  causal, st));
}

extern "C" int ds_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* seg, void* dq, int B, int H, int S, int D,
                                    float sm_scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_dq<64>(q, k, v, dout, lse, delta, seg, dq, B, H, S, sm_scale,
                                    causal, st)
                       : bwd_dq<128>(q, k, v, dout, lse, delta, seg, dq, B, H, S, sm_scale,
                                     causal, st));
}
