// Block-sparse attention forward and backward for Hopper (sm_90a), bf16 in,
// fp32 accumulation, on [B, S, H, D] tensors read with their strides.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   _fwd_kernel (the `pl.pallas_call` in _fwd_impl)         -> bsa_fwd_kernel
//   _dq_kernel  (the first `pl.pallas_call` in _bwd_impl)   -> bsa_dq_kernel
//   _dkv_kernel (the second `pl.pallas_call` in _bwd_impl)  -> bsa_dkv_kernel
// Same math as those kernels, over the key blocks a [H, nq, nk] layout
// admits (no mask inside an admitted block; S is a multiple of the block):
//   forward  per query block, for each admitted key block in list order:
//            s = q k^T * sm_scale, online softmax with m starting at
//            NEG_INF = -1e30, alpha = exp(m_prev - m_new), p = exp(s - m_new),
//            l += sum(p) (fp32 p), acc = acc * alpha + bf16(p) v;
//            o = acc / (l == 0 ? 1 : l), lse = m + log(l == 0 ? 1 : l). A row
//            with no admitted block writes o = 0 and lse = NEG_INF.
//   dQ       per query block over the same list: p = exp(s - lse),
//            dp = do v^T, ds = bf16(p * (dp - delta) * sm_scale), dq += ds k.
//   dK/dV    per key block over the transposed list (the query blocks that
//            admit it): dv += bf16(p)^T do, dk += ds^T q. A key block no
//            query admits writes zeros.
//   delta = sum(do * o) comes from the caller (fp32, [B, H, S]).
// The softmax runs in the exp2 domain (scores pre-multiplied by log2(e));
// lse is stored in the natural-log domain as the TPU kernel stores it.
//
// What bounds it at the BERT-large training shape (B=4, S=4096, H=16, D=64,
// BigBird block 64 admitting 9.13% of the block pairs): the forward moves
// 4 * B*S*H*D * 2 = 134 MB (q, k, v, o) and does 4 * D * 9.13% * B*H*S*S =
// 2.5e10 flops, so bytes bound it (40 us at 3.35 TB/s against 25 us of
// tensor-core time); the backward's kernels likewise. A kernel that reads
// each admitted key block once per query block re-reads k and v about 5x
// (the median row's admitted count) from L2.
//
// What the design does about that:
//   - the TPU kernel's SMEM index-list DMA does not carry over: each group
//     of warps reads its row's admitted-block list (k_idx, k_nnz) itself
//     and walks it, loading each admitted block's rows into shared memory;
//     no work is spent on blocks the layout does not admit;
//   - K1's building blocks (attention_tiles.cuh): bf16 mma.sync.m16n8k16
//     tiles with fp32 accumulators fed by ldmatrix (.trans for operands used
//     transposed) from padded shared rows, the scores and probabilities kept
//     in registers, strided [B, S, H, D] reads and writes with no transposes;
//   - one CTA per (b, h, query block) for the forward and dQ, one per
//     (b, h, key block) for dK/dV over the transposed lists: no atomics,
//     so every result is deterministic. A block of 64 rows is 4 warps, 128
//     rows 8 warps; blocks of 16 and 32 rows are too small for a CTA each,
//     so a CTA takes 4 or 2 of them, one group of warps each, every group
//     walking its own list and synchronising on its own named barrier;
//   - load balance: BigBird's global row admits every key block against 5
//     in the median row, and every row admits key block 0. The grid's slow
//     dimension is a rank, and `order` maps rank r of head h to its r-th
//     longest row, so the longest rows of every (b, h) start first.
// Not done yet (work for a later change): wgmma and TMA, double-buffered
// cp.async loads of the next admitted block, keeping k and v of shared
// key blocks (the global columns) resident. Head dims 64 and 128 and blocks
// of 16, 32, 64 and 128 rows are instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

template <int BLOCK>
struct Shape {
  static constexpr int kRows = BLOCK > 64 ? BLOCK : 64;  // rows a CTA owns
  static constexpr int kGroups = kRows / BLOCK;          // blocks a CTA takes
  static constexpr int kGroupWarps = BLOCK / 16;         // warps walking one list
  static constexpr int kGroupThreads = kGroupWarps * 32;
  static constexpr int kThreads = kRows / 16 * 32;
  static constexpr int KT = BLOCK < 64 ? BLOCK : 64;     // key rows a step (fwd, dQ)
  static constexpr int QT = BLOCK < 32 ? BLOCK : 32;     // query rows a step (dK/dV)
};

// barrier 1 + group, over the group's threads only: groups walk lists of
// different lengths, so no barrier may span the whole CTA
__device__ __forceinline__ void group_sync(int group, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(nthreads) : "memory");
}

// rows [row0, row0 + ROWS) of a [S, D] slice with row stride `rs` elements
// into a shared tile, by the `n` threads of a group (thread `i0` of them)
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(uint16_t* sm, const uint16_t* g, int row0, size_t rs,
                                          int i0, int n) {
  constexpr int CH = D / 8;
  for (int i = i0; i < ROWS * CH; i += n) {
    const int r = i / CH, c = i - (i / CH) * CH;
    *reinterpret_cast<uint4*>(sm + r * (D + kPad) + c * 8) =
        *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * rs + c * 8);
  }
}

// Where a CTA thread works: its group, the block row its group owns (-1 when
// the group's rank is past the rows), and that row's admitted list.
struct Work {
  int group, gt, wr, row, nnz;
  const int32_t* list;
};

template <int BLOCK>
__device__ __forceinline__ Work find_work(const int32_t* idx, const int32_t* nnz,
                                          const int32_t* order, int h, int rows, int A) {
  using Sh = Shape<BLOCK>;
  const int warp = threadIdx.x >> 5;
  Work w;
  w.group = warp / Sh::kGroupWarps;
  w.gt = threadIdx.x - w.group * Sh::kGroupThreads;
  w.wr = (warp - w.group * Sh::kGroupWarps) * 16;  // the warp's first row in the block
  const int rank = blockIdx.y * Sh::kGroups + w.group;
  w.row = rank < rows ? order[h * rows + rank] : -1;
  w.nnz = w.row < 0 ? 0 : nnz[h * rows + w.row];
  w.list = idx + ((size_t)h * rows + (w.row < 0 ? 0 : w.row)) * A;
  return w;
}

// ---------------------------------------------------------------- forward
// grid (B * H, ceil(nq / kGroups)); each group owns one query block.
template <int D, int BLOCK>
__global__ void __launch_bounds__(Shape<BLOCK>::kThreads)
bsa_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ o, float* __restrict__ lse,
               const int32_t* __restrict__ k_idx, const int32_t* __restrict__ k_nnz,
               const int32_t* __restrict__ k_order, int H, int S, int A, float scale_log2) {
  using Sh = Shape<BLOCK>;
  constexpr int LD = D + kPad, KT = Sh::KT, GT = Sh::kGroupThreads;
  extern __shared__ __align__(16) uint16_t smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const Work w = find_work<BLOCK>(k_idx, k_nnz, k_order, h, S / BLOCK, A);
  if (w.row < 0) return;  // the whole group leaves together
  uint16_t* sQ = smem + w.group * BLOCK * LD;
  uint16_t* sK = smem + (Sh::kRows + w.group * KT) * LD;
  uint16_t* sV = smem + (Sh::kRows + (Sh::kGroups + w.group) * KT) * LD;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int q0 = w.row * BLOCK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  load_rows<BLOCK, D>(sQ, q + base, q0, rs, w.gt, GT);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < w.nnz; ++j) {
    const int kb = w.list[j] * BLOCK;
    for (int k0 = kb; k0 < kb + BLOCK; k0 += KT) {
      group_sync(w.group, GT);  // the previous tile's readers are done
      load_rows<KT, D>(sK, k + base, k0, rs, w.gt, GT);
      load_rows<KT, D>(sV, v + base, k0, rs, w.gt, GT);
      group_sync(w.group, GT);

      float s[KT / 8][4];
#pragma unroll
      for (int i = 0; i < KT / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_order<LD>(sQ, w.wr, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < KT / 16; ++nn) {
          uint32_t bb[4];
          ldsm_x4(bb, b_order<LD>(sK, nn * 16, kk * 16, lane));
          mma16816(s[2 * nn], a, bb[0], bb[1]);
          mma16816(s[2 * nn + 1], a, bb[2], bb[3]);
        }
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
      for (int nt = 0; nt < KT / 8; ++nt) {
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
      for (int kk = 0; kk < KT / 16; ++kk) {
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
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    inv[r] = lt == 0.f ? 1.f : 1.f / lt;
    const int row = q0 + w.wr + g + r * 8;
    if (t == 0) lse[(size_t)bh * S + row] = lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
  }
  store_rows<D>(o + base, acc, q0 + w.wr + g, S, rs, t, inv[0], inv[1]);
}

// -------------------------------------------------------------- backward dQ
// grid (B * H, ceil(nq / kGroups)); each group owns one query block and
// walks its admitted key blocks KT rows at a time.
template <int D, int BLOCK>
__global__ void __launch_bounds__(Shape<BLOCK>::kThreads)
bsa_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              uint16_t* __restrict__ dq, const int32_t* __restrict__ k_idx,
              const int32_t* __restrict__ k_nnz, const int32_t* __restrict__ k_order, int H,
              int S, int A, float scale_log2, float sm_scale) {
  using Sh = Shape<BLOCK>;
  constexpr int LD = D + kPad, KT = Sh::KT, GT = Sh::kGroupThreads;
  extern __shared__ __align__(16) uint16_t smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const Work w = find_work<BLOCK>(k_idx, k_nnz, k_order, h, S / BLOCK, A);
  if (w.row < 0) return;
  uint16_t* sQ = smem + w.group * BLOCK * LD;
  uint16_t* sdO = smem + (Sh::kRows + w.group * BLOCK) * LD;
  uint16_t* sK = smem + (2 * Sh::kRows + w.group * KT) * LD;
  uint16_t* sV = smem + (2 * Sh::kRows + (Sh::kGroups + w.group) * KT) * LD;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int q0 = w.row * BLOCK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  load_rows<BLOCK, D>(sQ, q + base, q0, rs, w.gt, GT);
  load_rows<BLOCK, D>(sdO, dout + base, q0, rs, w.gt, GT);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t)bh * S + q0 + w.wr + g + r * 8;
    lse2[r] = lse[at] * kLog2e;
    dlt[r] = delta[at];
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int j = 0; j < w.nnz; ++j) {
    const int kb = w.list[j] * BLOCK;
    for (int k0 = kb; k0 < kb + BLOCK; k0 += KT) {
      group_sync(w.group, GT);
      load_rows<KT, D>(sK, k + base, k0, rs, w.gt, GT);
      load_rows<KT, D>(sV, v + base, k0, rs, w.gt, GT);
      group_sync(w.group, GT);

      float p[KT / 8][4], dp[KT / 8][4];
#pragma unroll
      for (int i = 0; i < KT / 8; ++i) {
        p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        ldsm_x4(aq, a_order<LD>(sQ, w.wr, kk * 16, lane));
        ldsm_x4(ao, a_order<LD>(sdO, w.wr, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < KT / 16; ++nn) {
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
      for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = exp2f(p[nt][e] * scale_log2 - lse2[e >> 1]);
          dp[nt][e] = pv * (dp[nt][e] - dlt[e >> 1]) * sm_scale;  // dS
        }
      }
      // dQ += dS K, contracting over the KT keys
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
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
  }
  store_rows<D>(dq + base, dq_acc, q0 + w.wr + g, S, rs, t, 1.f, 1.f);
}

// ---------------------------------------------------------- backward dK/dV
// grid (B * H, ceil(nk / kGroups)); each group owns one key block (16 keys
// a warp) and walks the query blocks that admit it, QT rows at a time.
template <int D, int BLOCK>
__global__ void __launch_bounds__(Shape<BLOCK>::kThreads)
bsa_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
               const int32_t* __restrict__ q_idx, const int32_t* __restrict__ q_nnz,
               const int32_t* __restrict__ q_order, int H, int S, int A, float scale_log2,
               float sm_scale) {
  using Sh = Shape<BLOCK>;
  constexpr int LD = D + kPad, QT = Sh::QT, GT = Sh::kGroupThreads;
  extern __shared__ __align__(16) uint16_t smem[];
  __shared__ float sLse[Sh::kGroups * QT];
  __shared__ float sDelta[Sh::kGroups * QT];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const Work w = find_work<BLOCK>(q_idx, q_nnz, q_order, h, S / BLOCK, A);
  if (w.row < 0) return;
  uint16_t* sK = smem + w.group * BLOCK * LD;
  uint16_t* sV = smem + (Sh::kRows + w.group * BLOCK) * LD;
  uint16_t* sQ = smem + (2 * Sh::kRows + w.group * QT) * LD;
  uint16_t* sdO = smem + (2 * Sh::kRows + (Sh::kGroups + w.group) * QT) * LD;
  float* gLse = sLse + w.group * QT;
  float* gDelta = sDelta + w.group * QT;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const float* lseb = lse + (size_t)bh * S;
  const float* deltab = delta + (size_t)bh * S;
  const int k0 = w.row * BLOCK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  load_rows<BLOCK, D>(sK, k + base, k0, rs, w.gt, GT);
  load_rows<BLOCK, D>(sV, v + base, k0, rs, w.gt, GT);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int j = 0; j < w.nnz; ++j) {
    const int qb = w.list[j] * BLOCK;
    for (int q0 = qb; q0 < qb + BLOCK; q0 += QT) {
      group_sync(w.group, GT);
      load_rows<QT, D>(sQ, q + base, q0, rs, w.gt, GT);
      load_rows<QT, D>(sdO, dout + base, q0, rs, w.gt, GT);
      for (int i = w.gt; i < QT; i += GT) {
        gLse[i] = lseb[q0 + i] * kLog2e;
        gDelta[i] = deltab[q0 + i];
      }
      group_sync(w.group, GT);

      // P^T = exp(K Q^T * scale - lse): this warp's 16 keys x QT queries
      float p[QT / 8][4], dp[QT / 8][4];
#pragma unroll
      for (int i = 0; i < QT / 8; ++i) {
        p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], av[4];
        ldsm_x4(a, a_order<LD>(sK, w.wr, kk * 16, lane));
        ldsm_x4(av, a_order<LD>(sV, w.wr, kk * 16, lane));
#pragma unroll
        for (int nn = 0; nn < QT / 16; ++nn) {
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
      for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nt * 8 + t * 2 + (e & 1);  // query within the tile
          const float pv = exp2f(p[nt][e] * scale_log2 - gLse[ql]);
          p[nt][e] = pv;
          dp[nt][e] = pv * (dp[nt][e] - gDelta[ql]) * sm_scale;  // dS^T
        }
      }
      // dV += P^T dO and dK += dS^T Q, contracting over the QT queries
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
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
  }
  store_rows<D>(dk + base, dk_acc, k0 + w.wr + g, S, rs, t, 1.f, 1.f);
  store_rows<D>(dv + base, dv_acc, k0 + w.wr + g, S, rs, t, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t smem_cfg(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *idx, *nnz, *order;
  void *o, *lse_out, *dq, *dk, *dv;
  int B, H, S, A;
  float sm_scale;
  cudaStream_t st;
};

// kind 0 = forward, 1 = dQ, 2 = dK/dV
template <int D, int BLOCK>
cudaError_t run(int kind, const Args& a) {
  using Sh = Shape<BLOCK>;
  constexpr size_t row_bytes = sizeof(uint16_t) * (D + kPad);
  const dim3 grid(a.B * a.H, (a.S / BLOCK + Sh::kGroups - 1) / Sh::kGroups);
  const float scale_log2 = a.sm_scale * kLog2e;
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* k = static_cast<const uint16_t*>(a.k);
  const uint16_t* v = static_cast<const uint16_t*>(a.v);
  const int32_t* idx = static_cast<const int32_t*>(a.idx);
  const int32_t* nnz = static_cast<const int32_t*>(a.nnz);
  const int32_t* order = static_cast<const int32_t*>(a.order);
  cudaError_t err;
  if (kind == 0) {
    const size_t smem = row_bytes * (Sh::kRows + 2 * Sh::kGroups * Sh::KT);
    if ((err = smem_cfg(bsa_fwd_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_fwd_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<uint16_t*>(a.o), static_cast<float*>(a.lse_out), idx, nnz, order,
        a.H, a.S, a.A, scale_log2);
  } else if (kind == 1) {
    const size_t smem = row_bytes * (2 * Sh::kRows + 2 * Sh::kGroups * Sh::KT);
    if ((err = smem_cfg(bsa_dq_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_dq_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<uint16_t*>(a.dq), idx, nnz, order, a.H,
        a.S, a.A, scale_log2, a.sm_scale);
  } else {
    const size_t smem = row_bytes * (2 * Sh::kRows + 2 * Sh::kGroups * Sh::QT);
    if ((err = smem_cfg(bsa_dkv_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_dkv_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<uint16_t*>(a.dk),
        static_cast<uint16_t*>(a.dv), idx, nnz, order, a.H, a.S, a.A, scale_log2, a.sm_scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t run_block(int kind, int block, const Args& a) {
  switch (block) {
    case 16: return run<D, 16>(kind, a);
    case 32: return run<D, 32>(kind, a);
    case 64: return run<D, 64>(kind, a);
    default: return run<D, 128>(kind, a);
  }
}

int dispatch(int kind, int D, int block, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.A <= 0 || (D != 64 && D != 128) ||
      (block != 16 && block != 32 && block != 64 && block != 128) || a.S % block != 0 ||
      a.S / block > 65535 * (block > 64 ? 1 : 64 / block) || (long long)a.B * a.H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)(D == 64 ? run_block<64>(kind, block, a) : run_block<128>(kind, block, a));
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous tensors: q/k/v/o/dout/dq/dk/dv bf16 [B, S, H, D]; lse/delta
// fp32 [B, H, S]; the lists int32: idx [H, rows, A] (admitted blocks of each
// row, zero-padded), nnz [H, rows] (their counts), order [H, rows] (each
// head's rows, longest list first), with rows = S / block; the forward and
// dQ take the query rows' lists (k_idx), dK/dV the key rows' (q_idx). The
// wrapper in ops/kernels/block_sparse_attention.py checks shapes, types and
// alignment before calling. Each returns cudaGetLastError() of its launch.
extern "C" int ds_bsa_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                               const void* k_idx, const void* k_nnz, const void* k_order, int B,
                               int H, int S, int D, int block, int A, float sm_scale,
                               void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.idx = k_idx; a.nnz = k_nnz; a.order = k_order;
  a.B = B; a.H = H; a.S = S; a.A = A; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(0, D, block, a);
}

extern "C" int ds_bsa_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, const void* k_idx,
                              const void* k_nnz, const void* k_order, int B, int H, int S, int D,
                              int block, int A, float sm_scale, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.idx = k_idx; a.nnz = k_nnz; a.order = k_order;
  a.B = B; a.H = H; a.S = S; a.A = A; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(1, D, block, a);
}

extern "C" int ds_bsa_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv,
                               const void* q_idx, const void* q_nnz, const void* q_order, int B,
                               int H, int S, int D, int block, int A, float sm_scale,
                               void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.idx = q_idx; a.nnz = q_nnz; a.order = q_order;
  a.B = B; a.H = H; a.S = S; a.A = A; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(2, D, block, a);
}
