// Block-sparse attention forward and backward for Hopper (sm_90a), bf16 in,
// fp32 accumulation, on [B, S, H, D] tensors read with their strides.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   _fwd_kernel (the `pl.pallas_call` in _fwd_impl)         -> bsa_fwd_wgmma_kernel
//                                         (blocks 64, 128), bsa_fwd_kernel (16, 32)
//   _dq_kernel  (the first `pl.pallas_call` in _bwd_impl)   -> bsa_dq_wgmma_kernel
//                                         (blocks 64, 128), bsa_dq_kernel (16, 32)
//   _dkv_kernel (the second `pl.pallas_call` in _bwd_impl)  -> bsa_dkv_wgmma_kernel
//                                         (blocks 64, 128), bsa_dkv_kernel (16, 32)
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
//            A row with no admitted block writes zeros.
//   dK/dV    per key block over the transposed list (the query blocks that
//            admit it): dv += bf16(p)^T do, dk += ds^T q. A key block no
//            query admits writes zeros.
//   delta = sum(do * o) comes from the caller (fp32, [B, H, S]).
// The softmax runs in the exp2 domain (scores pre-multiplied by log2(e));
// lse is stored in the natural-log domain as the TPU kernel stores it.
//
// What bounds them at the BERT-large training shape (B=4, S=4096, H=16,
// D=64, BigBird block 64 admitting 9.13% of the block pairs): the forward
// moves 4 * B*S*H*D * 2 = 134 MB (q, k, v, o) and does 4 * D * 9.13% *
// B*H*S*S = 2.5e10 flops, so bytes bound it (40 us at 3.35 TB/s against 25
// us of tensor-core time). The backward's two bounds are close: dK/dV
// moves 201 MB (q, k, v, do, dk, dv, lse, delta), 60.8 us, against 5.0e10
// flops (four products), 50.7 us at 989 TFLOP/s; dQ 170 MB, 50.8 us,
// against 3.8e10 flops (three products), 38.1 us. Neither is within reach
// of mma.sync fed by synchronous loads: the tensor cores must be wgmma and
// every tile's load must overlap an earlier tile's products. A kernel that
// reads each admitted block once per visiting block re-reads k and v (or q
// and do) about 5x (the median row's admitted count) from L2.
//
// The first design (all three kernels at blocks of 16 and 32, which give no
// 64-row tile of one list):
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
// The wgmma designs of the forward, dQ and dK/dV (blocks of 64 and 128,
// whose 64-row tiles are wgmma's M): K1's designs (flash_attention.cu, on
// hopper.cuh and attention_wgmma.cuh) walking the layout's lists instead
// of a causal range:
//   - an item is one query block (forward, dQ) or key block (dK/dV); a
//     consumer warpgroup owns 64 of its rows (one at block 64, two at block
//     128, which take turns issuing, as in K1). The item's own Q (forward),
//     Q, dO, lse and delta (dQ) or K and V (dK/dV) come by TMA into one of
//     two item slots, and the tiles of its list stream through a ring of
//     full/empty mbarriers: the forward's and dQ's K and V tiles (64 keys,
//     128 at block 128 and D 64), dK/dV's 64-row Q and dO tiles with their
//     lse and delta (two bulk copies into the same stage). The forward's
//     slot holds Q alone, so its ring keeps 4 stages at every shape (3 at
//     block 64 and D 128, for two blocks an SM) where dQ's keeps 2 at block
//     128 and D 128. 3-D tensor maps over [B, S, H, D], 128-byte swizzle;
//   - forward: S = Q K^T is m64n{keys}k16 (both K-major); the online
//     softmax runs in registers in the exp2 domain (the row max over the raw
//     scores, p = 2^(s scale log2(e) - m) one FFMA and one MUFU, l the sum of
//     fp32 p); O is rescaled by alpha and O += bf16(P) V is m64n{D}k16 with
//     P re-packed from the S accumulator as the A operand from registers
//     and V MN-major (K1's forward). Tile i's S is issued with tile i - 1's
//     P V, so its softmax runs under P V; the rescale of O waits for that P
//     V. o = O / l leaves by TMA store from the slot's Q boxes (Q is dead
//     once the item's last S is in), lse from registers;
//   - dK/dV: S^T = K Q^T and dP^T = V dO^T are m64n64k16 in one group,
//     p and dS^T = bf16(p (dP^T - delta) sm_scale) in registers, then dV +=
//     bf16(P^T) dO and dK += dS^T Q are m64n{D}k16 with A from registers
//     and dO, Q read MN-major from the stage that fed the first two;
//   - dQ: S = Q K^T and dP = dO V^T in one group (both K-major), p and dS
//     in registers, dQ += dS K with dS from registers and K MN-major; tile
//     i's S and dP are issued with tile i - 1's dS K;
//   - the grid is persistent (blocks an SM times SMs) and takes items from
//     a counter: the lists' longest ranks first (BigBird's global row and
//     column, 64 tiles against ~6), then the rest in groups of 16 head-rows
//     so that a group's shared tiles stay in L2. Lists are short, so what
//     a block does between items decides its speed (a fully dense layout
//     runs at K1's rate a tile): warp 1 of the producer warpgroup fetches
//     items ahead (the counter, then the item's block, count and padded
//     list together, read once into shared memory) through a ring of
//     descriptors, so the loading thread never waits on a global read; an
//     item's output leaves by TMA store from the slot its own rows came in,
//     so no thread waits on scattered stores; an item whose list is empty
//     is written as zeros (and the forward's lse as NEG_INF) by the fetcher
//     and never reaches a consumer;
//   - at block 64 a block is 256 threads and two blocks share an SM, so one
//     block's exponentials run under the other's products (the producer
//     keeps 24 registers, and spills a few words around the counter, so
//     that the consumer has 232);
//   - each item's trip count is broadcast from lane 0, so wgmma never sits
//     in a branch ptxas must treat as divergent; no atomics on the outputs,
//     so two runs give the same bits.
// Tried and measured no faster at BERT-large's path, so not kept: two
// dK/dV consumers in one block taking a key block's tiles by parity (their
// partial sums added in order at the end), and chaining dQ's items (an
// item's first S and dP issued with the last item's dS K).
// Not done yet (work for a later change): keeping k and v of shared key
// blocks (the global columns) resident; overlapping a consumer's
// exponentials with its own next products beyond the forward's one-tile
// lag (registers). Head dims 64 and 128 and blocks of 16, 32, 64 and 128
// rows are instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attention_wgmma.cuh"

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

// ------------------------------------------------------- the wgmma designs
// Blocks of 64 and 128 rows at head dims 64 and 128 (bsa_design in the
// wrapper). The grid is persistent: its blocks take work items from a
// counter in the order item_at gives. An item is one key block (dK/dV) or
// query block (forward, dQ); each consumer warpgroup owns 64 of its rows
// (one consumer at block 64, two at block 128). Warp 1 of the producer
// warpgroup (the fetcher) takes the items and reads their lists; thread 0
// (the loader) brings each item's own rows (K and V, Q, or Q and dO with
// lse and delta) into one of two item slots, so the next item's are loaded
// while this one runs, and streams the tiles of its list through a ring of
// full/empty mbarriers. The lists come ranked: row r of head h of idx and
// nnz is the list of block order[h * rows + r], so an item's reads of its
// block, its count and its list do not wait on each other.
constexpr int DESCS = 4;  // items a block's fetcher runs ahead of its loader

template <int D, int BLOCK>
struct WgDkv {
  static constexpr int kConsumers = BLOCK / 64;
  static constexpr int kStages = D == 64 ? 4 : BLOCK == 64 ? 3 : 2;  // within 227 KB
  static constexpr int kKBox = BLOCK * BOX_ROW;        // one [BLOCK keys][64] box
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kQBox = 64 * BOX_ROW;           // one [64 queries][64] box: 8 KB
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kStage = 2 * 2 * kKTile;        // item slot j: K, V; then stage s: Q, dO
  static constexpr int kStats = kStage + kStages * 2 * kQTile;  // stage s: lse[64], delta[64]
  static constexpr int kItem = kStats + kStages * 2 * 64 * 4;   // item slot j: row, nnz, b H + h
  static constexpr int kBar = kItem + 2 * 16;
  static constexpr int kDescs = kBar + (2 * kStages + 4 + 2 * DESCS) * 8;  // the fetched items
};

template <int D, int BLOCK>
struct WgDq {
  static constexpr int kConsumers = BLOCK / 64;
  static constexpr int kKeys = BLOCK == 128 && D == 64 ? 128 : 64;  // keys a stage: registers,
                                                                    // as in K1's dQ
  static constexpr int kStages = D == 64 ? 4 : BLOCK == 64 ? 3 : 2;
  static constexpr int kQBox = BLOCK * BOX_ROW;        // one [BLOCK queries][64] box
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kKBox = kKeys * BOX_ROW;        // one [keys][64] box
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kStage = 2 * 2 * kQTile;        // item slot j: Q, dO; then stage s: K, V
  static constexpr int kStats = kStage + kStages * 2 * kKTile;  // slot j: lse, delta [BLOCK]
  static constexpr int kItem = kStats + 2 * 2 * BLOCK * 4;      // item slot j: row, nnz, b H + h
  static constexpr int kBar = kItem + 2 * 16;
  static constexpr int kDescs = kBar + (2 * kStages + 4 + 2 * DESCS) * 8;
};

// The forward's item slot holds Q only, half of dQ's, so its ring has room
// for 4 stages at every shape (dQ's has 2 at block 128 and D 128).
template <int D, int BLOCK>
struct WgFwd {
  static constexpr int kConsumers = BLOCK / 64;
  static constexpr int kKeys = WgDq<D, BLOCK>::kKeys;  // keys a stage: registers, as dQ
  static constexpr int kStages = D == 128 && BLOCK == 64 ? 3 : 4;  // two blocks an SM at 64
  static constexpr int kQBox = BLOCK * BOX_ROW;
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kKBox = kKeys * BOX_ROW;
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kStage = 2 * kQTile;            // item slot j: Q; then stage s: K, V
  static constexpr int kItem = kStage + kStages * 2 * kKTile;  // item slot j: row, nnz, b H + h
  static constexpr int kBar = kItem + 2 * 16;
  static constexpr int kDescs = kBar + (2 * kStages + 4 + 2 * DESCS) * 8;
};

// 256 threads (a producer warpgroup, one consumer) and two blocks an SM at
// block 64; 384 threads (two consumers) and one block an SM at block 128.
// The producer's registers go to the consumers: 24 + 232 = 2 x 128 at block
// 64, 40 + 2 x 232 = 3 x 168 at block 128.
template <int BLOCK>
struct WgThreads {
  static constexpr int kThreads = 128 + 2 * BLOCK;
  static constexpr int kMinBlocks = BLOCK == 64 ? 2 : 1;
  static constexpr int kProducerRegs = BLOCK == 64 ? 24 : 40;
};

// Item w of the take order → (b H + h, rank): first the `lead` ranks of
// every head-row (the long lists, such as BigBird's global rows and
// columns: 64 tiles against ~6), rank-major, so that they start first;
// then the other ranks in groups of HEAD_GROUP head-rows, rank-major within
// a group, so that the tiles a group's items share (1 MB of Q and dO, or of
// K and V, a head-row at BERT-large's path) stay in L2 while it runs.
// `lead` = rows is the first design's order.
constexpr int HEAD_GROUP = 16;

__device__ __forceinline__ void item_at(int w, int BH, int rows, int lead, int& bh, int& rank) {
  if (w < lead * BH) {
    rank = w / BH;
    bh = w - rank * BH;
    return;
  }
  w -= lead * BH;
  const int per = rows - lead, group = w / (HEAD_GROUP * per);
  const int size = min(HEAD_GROUP, BH - group * HEAD_GROUP);  // the last group may be short
  const int r = w - group * HEAD_GROUP * per;
  rank = lead + r / size;
  bh = group * HEAD_GROUP + r - (r / size) * size;
}

// zeros into BLOCK rows of one head of a [B, S, H, D] tensor (`g` at the
// first), row stride rs, by a warp: an item whose list is empty
template <int D, int BLOCK>
__device__ __forceinline__ void store_zero_rows(uint16_t* g, size_t rs, int lane) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = lane; i < BLOCK * CH; i += 32)
    *reinterpret_cast<uint4*>(g + (size_t)(i / CH) * rs + (i % CH) * 8) = make_uint4(0, 0, 0, 0);
}

// The fetcher, warp 1 of the producer warpgroup: takes items from the
// counter one at a time and hands each to the loader (thread 0) with its
// list, read once into shared memory, through a ring of DESCS descriptors
// ({row, nnz, b H + h, -}, then the list; `ints` a descriptor), so that the
// loader never waits on the counter or a list. An item's block, count and
// padded list are read together, none waiting on another. An item whose
// list is empty is stored as zeros (into z0, and z1 when given; its lse,
// fp32 [B H, S], as NEG_INF into zlse when given) here and not handed on;
// a descriptor of row -1 ends the loader's items.
template <int D, int BLOCK>
__device__ __forceinline__ void fetch_items(int32_t* descs, int ints, uint64_t* desc_full,
                                            uint64_t* desc_empty, int* counter,
                                            const int32_t* idx, const int32_t* nnz,
                                            const int32_t* order, int BH, int H, int S, int A,
                                            int lead, uint16_t* z0, uint16_t* z1, float* zlse,
                                            int lane) {
  const int rows = S / BLOCK;
  const size_t rs = (size_t)H * D;
  for (int n = 0;;) {
    int w = 0;
    if (lane == 0) w = atomicAdd(counter, 1);
    w = __shfl_sync(~0u, w, 0);
    int row = -1, count = 0, bh = 0;
    size_t at = 0;
    if (w < BH * rows) {
      int rank;
      item_at(w, BH, rows, lead, bh, rank);
      at = (size_t)(bh % H) * rows + rank;
      row = order[at];
      count = nnz[at];
    }
    if (row >= 0 && count == 0) {  // its rows admit nothing: zeros, not handed on
      const int b = bh / H, h = bh - (bh / H) * H;
      const size_t off = ((size_t)b * S + (size_t)row * BLOCK) * rs + (size_t)h * D;
      store_zero_rows<D, BLOCK>(z0 + off, rs, lane);
      if (z1 != nullptr) store_zero_rows<D, BLOCK>(z1 + off, rs, lane);
      if (zlse != nullptr)  // the forward's lse of those rows
        for (int i = lane; i < BLOCK; i += 32)
          zlse[(size_t)bh * S + (size_t)row * BLOCK + i] = kNegInf;
      continue;
    }
    const int d = n % DESCS;
    hopper::mbar_wait(&desc_empty[d], ((n / DESCS) & 1) ^ 1);
    int32_t* desc = descs + d * ints;
    if (row >= 0)
      for (int j = lane; j < A; j += 32) desc[4 + j] = idx[at * A + j];
    if (lane == 0) {
      desc[0] = row;
      desc[1] = count;
      desc[2] = bh;
    }
    hopper::mbar_arrive(&desc_full[d]);  // every lane: its list entries are written
    if (row < 0) return;
    ++n;
  }
}

// dK/dV: an item is keys row * BLOCK .. + BLOCK - 1 (consumer cw the 64
// from 64 cw); K and V are loaded once into its slot, and the query blocks
// that admit those keys are walked 64 rows a tile, each tile's Q, dO, lse
// and delta in one stage.
template <int D, int BLOCK>
__global__ void __launch_bounds__(WgThreads<BLOCK>::kThreads, WgThreads<BLOCK>::kMinBlocks)
    bsa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dk,
                         const __grid_constant__ CUtensorMap map_dv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                         const int32_t* __restrict__ q_idx, const int32_t* __restrict__ q_nnz,
                         const int32_t* __restrict__ q_order, int* __restrict__ counter, int BH,
                         int H, int S, int A, int lead, float scale_log2, float sm_scale) {
  using L = WgDkv<D, BLOCK>;
  constexpr int NC = L::kConsumers, QT = 64, TPB = BLOCK / QT, ST = L::kStages;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* slot_full = empty + ST;
  uint64_t* slot_empty = slot_full + 2;
  uint64_t* desc_full = slot_empty + 2;
  uint64_t* desc_empty = desc_full + DESCS;
  int* sItem = reinterpret_cast<int*>(base + L::kItem);
  int32_t* descs = reinterpret_cast<int32_t*>(base + L::kDescs);
  const int tid = threadIdx.x, ints = 4 + (A + 3) / 4 * 4;  // a descriptor's int32s
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);        // the loader's expect_tx; TMA and bulk bytes
      hopper::mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    for (int j = 0; j < 2; ++j) {
      hopper::mbar_init(&slot_full[j], 1);
      hopper::mbar_init(&slot_empty[j], NC);  // each consumer's storing thread
    }
    for (int d = 0; d < DESCS; ++d) {
      hopper::mbar_init(&desc_full[d], 32);  // the fetcher's lanes
      hopper::mbar_init(&desc_empty[d], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 1 fetches items, thread 0 loads them
    hopper::setmaxnreg_dec<WgThreads<BLOCK>::kProducerRegs>();
    if (tid >= 32 && tid < 64) {
      fetch_items<D, BLOCK>(descs, ints, desc_full, desc_empty, counter, q_idx, q_nnz, q_order,
                            BH, H, S, A, lead, dk, dv, nullptr, tid - 32);
    } else if (tid == 0) {  // an item's K and V into its slot, then its tiles into the ring
      int t = 0;            // tiles asked for so far: the ring's position
      for (int n = 0;; ++n) {
        const int d = n % DESCS, slot = n & 1;
        hopper::mbar_wait(&desc_full[d], (n / DESCS) & 1);
        const int32_t* desc = descs + d * ints;
        const int row = desc[0], nnz = desc[1], bh = desc[2];
        hopper::mbar_wait(&slot_empty[slot], ((n >> 1) & 1) ^ 1);
        sItem[4 * slot] = row;
        sItem[4 * slot + 1] = nnz;
        sItem[4 * slot + 2] = bh;
        if (row < 0) {
          hopper::mbar_arrive(&slot_full[slot]);  // no more items
          break;
        }
        const int b = bh / H, c0 = (bh - b * H) * D, k0 = row * BLOCK;
        uint8_t* kv = base + slot * 2 * L::kKTile;
        hopper::mbar_expect_tx(&slot_full[slot], 2 * L::kKTile);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_3d(kv + c * L::kKBox, &map_k, &slot_full[slot], c0 + 64 * c, k0, b);
          hopper::tma_load_3d(kv + L::kKTile + c * L::kKBox, &map_v, &slot_full[slot],
                              c0 + 64 * c, k0, b);
        }
        const float* lseb = lse + (size_t)bh * S;
        const float* deltab = delta + (size_t)bh * S;
        for (int i = 0; i < nnz * TPB; ++i, ++t) {
          const int s = t % ST, q0 = desc[4 + i / TPB] * BLOCK + (i % TPB) * QT;
          hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
          uint8_t* st = base + L::kStage + s * 2 * L::kQTile;
          float* stats = reinterpret_cast<float*>(base + L::kStats + s * 2 * QT * 4);
          hopper::mbar_expect_tx(&full[s], 2 * L::kQTile + 2 * QT * 4);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_3d(st + c * L::kQBox, &map_q, &full[s], c0 + 64 * c, q0, b);
            hopper::tma_load_3d(st + L::kQTile + c * L::kQBox, &map_do, &full[s], c0 + 64 * c,
                                q0, b);
          }
          hopper::bulk_load(stats, lseb + q0, QT * 4, &full[s]);
          hopper::bulk_load(stats + QT, deltab + q0, QT * 4, &full[s]);
        }
        hopper::mbar_arrive(&desc_empty[d]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, t4 = lane & 3;
  float dk_acc[D / 2], dv_acc[D / 2];  // an item's first wgmma overwrites them
  float sc[QT / 2], dp[QT / 2];
  uint32_t pa[QT / 16][4], da[QT / 16][4];
  // two consumers take turns issuing their products (ping-pong, as in K1)
  auto my_turn = [&]() {
    if constexpr (NC == 2) hopper::named_sync(1 + cw, 256);
  };
  auto their_turn = [&]() {
    if constexpr (NC == 2) hopper::named_arrive(2 - cw, 256);
  };
  if (NC == 2 && cw == 1) hopper::named_arrive(1, 256);

  int t = 0;  // tiles taken so far: the ring's position
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    hopper::mbar_wait(&slot_full[slot], (j >> 1) & 1);
    // (item values are broadcast from lane 0, so that ptxas sees the
    // branches and trip counts they give as warp-uniform)
    const int row = __shfl_sync(~0u, sItem[4 * slot], 0);
    if (row < 0) break;
    const int steps = __shfl_sync(~0u, sItem[4 * slot + 1], 0) * TPB;  // 64-row query tiles
    const int bh = __shfl_sync(~0u, sItem[4 * slot + 2], 0);
    const uint32_t k_addr = hopper::smem_addr(base + slot * 2 * L::kKTile) + cw * 64 * BOX_ROW;
    const uint32_t v_addr = k_addr + L::kKTile;

    for (int i = 0; i < steps; ++i) {
      const int s = (t + i) % ST;
      hopper::mbar_wait(&full[s], ((t + i) / ST) & 1);
      const uint32_t q_addr = hopper::smem_addr(base + L::kStage + s * 2 * L::kQTile);
      const uint32_t do_addr = q_addr + L::kQTile;
      const float* st_lse = reinterpret_cast<const float*>(base + L::kStats + s * 2 * QT * 4);
      const float* st_delta = st_lse + QT;

      // S^T = K Q^T and dP^T = V dO^T, both operands K-major
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      my_turn();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ok = kk / 4 * L::kKBox + kk % 4 * 32, oq = kk / 4 * L::kQBox + kk % 4 * 32;
        hopper::wgmma_m64n64k16<0, 0>(sc, hopper::sw128_desc(k_addr + ok),
                                      hopper::sw128_desc(q_addr + oq), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ok = kk / 4 * L::kKBox + kk % 4 * 32, oq = kk / 4 * L::kQBox + kk % 4 * 32;
        hopper::wgmma_m64n64k16<0, 0>(dp, hopper::sw128_desc(v_addr + ok),
                                      hopper::sw128_desc(do_addr + oq), kk > 0);
      }
      hopper::wgmma_commit();
      their_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P^T = exp2(s scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T -
      // delta) sm_scale, p in fp32 until both are rounded to bf16; no mask
      // inside an admitted block
#pragma unroll
      for (int jj = 0; jj < QT / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * jj + 2 * t4 + (e & 1);  // the query within the tile
          const float pv = fast_exp2(fmaf(sc[4 * jj + e], scale_log2, -st_lse[ql] * kLog2e));
          sc[4 * jj + e] = pv;
          dp[4 * jj + e] = pv * (dp[4 * jj + e] - st_delta[ql]) * sm_scale;
        }
      }
      pack_a(pa, sc);
      pack_a(da, dp);

      // dV += P^T dO and dK += dS^T Q: dO and Q are the MN-major B operands,
      // read from the same stage, a 16-deep slice 16 rows (2048 bytes) down
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
      my_turn();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wgmma_rs<D, 1>(dv_acc, pa[kk],
                       hopper::sw128_mn_desc(do_addr + kk * 16 * BOX_ROW, L::kQBox),
                       i > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        wgmma_rs<D, 1>(dk_acc, da[kk],
                       hopper::sw128_mn_desc(q_addr + kk * 16 * BOX_ROW, L::kQBox),
                       i > 0 || kk > 0);
      hopper::wgmma_commit();
      their_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    t += steps;
    // dK and dV of its 64 keys go out by TMA from the slot's boxes that this
    // consumer's K and V rows came in (no other consumer reads them); the
    // slot is free once the stores have read them
    uint8_t* out = base + slot * 2 * L::kKTile + cw * 64 * BOX_ROW;
    stage_wg_rows<D>(out, L::kKBox, dk_acc, 16 * warp + (lane >> 2), t4);
    stage_wg_rows<D>(out + L::kKTile, L::kKBox, dv_acc, 16 * warp + (lane >> 2), t4);
    hopper::fence_proxy_async();
    hopper::named_sync(3 + cw, 128);
    if ((tid & 127) == 0) {
      const int b = bh / H, c0 = (bh - b * H) * D, k0 = row * BLOCK + 64 * cw;
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_store_3d(&map_dk, out + c * L::kKBox, c0 + 64 * c, k0, b);
        hopper::tma_store_3d(&map_dv, out + L::kKTile + c * L::kKBox, c0 + 64 * c, k0, b);
      }
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();
      hopper::mbar_arrive(&slot_empty[slot]);
    }
  }
  if ((tid & 127) == 0) hopper::bulk_wait<0>();
}

// dQ: an item is query rows row * BLOCK .. + BLOCK - 1 (consumer cw the 64
// from 64 cw); Q, dO, lse and delta are loaded once into its slot, and its
// admitted key blocks are walked kKeys keys a stage (a block of 128 at D
// 128 is two stages).
template <int D, int BLOCK>
__global__ void __launch_bounds__(WgThreads<BLOCK>::kThreads, WgThreads<BLOCK>::kMinBlocks)
    bsa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        uint16_t* __restrict__ dq, const int32_t* __restrict__ k_idx,
                        const int32_t* __restrict__ k_nnz, const int32_t* __restrict__ k_order,
                        int* __restrict__ counter, int BH, int H, int S, int A, int lead,
                        float scale_log2, float sm_scale) {
  using L = WgDq<D, BLOCK>;
  constexpr int NC = L::kConsumers, BK = L::kKeys, TPB = BLOCK / BK, ST = L::kStages;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* slot_full = empty + ST;
  uint64_t* slot_empty = slot_full + 2;
  uint64_t* desc_full = slot_empty + 2;
  uint64_t* desc_empty = desc_full + DESCS;
  int* sItem = reinterpret_cast<int*>(base + L::kItem);
  int32_t* descs = reinterpret_cast<int32_t*>(base + L::kDescs);
  const int tid = threadIdx.x, ints = 4 + (A + 3) / 4 * 4;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NC);
    }
    for (int j = 0; j < 2; ++j) {
      hopper::mbar_init(&slot_full[j], 1);
      hopper::mbar_init(&slot_empty[j], NC);  // each consumer's storing thread
    }
    for (int d = 0; d < DESCS; ++d) {
      hopper::mbar_init(&desc_full[d], 32);
      hopper::mbar_init(&desc_empty[d], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 1 fetches items, thread 0 loads them
    hopper::setmaxnreg_dec<WgThreads<BLOCK>::kProducerRegs>();
    if (tid >= 32 && tid < 64) {
      fetch_items<D, BLOCK>(descs, ints, desc_full, desc_empty, counter, k_idx, k_nnz, k_order,
                            BH, H, S, A, lead, dq, nullptr, nullptr, tid - 32);
    } else if (tid == 0) {  // an item's Q, dO, lse and delta into its slot, then K/V tiles
      int t = 0;
      for (int n = 0;; ++n) {
        const int d = n % DESCS, slot = n & 1;
        hopper::mbar_wait(&desc_full[d], (n / DESCS) & 1);
        const int32_t* desc = descs + d * ints;
        const int row = desc[0], nnz = desc[1], bh = desc[2];
        hopper::mbar_wait(&slot_empty[slot], ((n >> 1) & 1) ^ 1);
        sItem[4 * slot] = row;
        sItem[4 * slot + 1] = nnz;
        sItem[4 * slot + 2] = bh;
        if (row < 0) {
          hopper::mbar_arrive(&slot_full[slot]);  // no more items
          break;
        }
        const int b = bh / H, c0 = (bh - b * H) * D, q0 = row * BLOCK;
        uint8_t* qd = base + slot * 2 * L::kQTile;
        float* stats = reinterpret_cast<float*>(base + L::kStats + slot * 2 * BLOCK * 4);
        hopper::mbar_expect_tx(&slot_full[slot], 2 * L::kQTile + 2 * BLOCK * 4);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_3d(qd + c * L::kQBox, &map_q, &slot_full[slot], c0 + 64 * c, q0, b);
          hopper::tma_load_3d(qd + L::kQTile + c * L::kQBox, &map_do, &slot_full[slot],
                              c0 + 64 * c, q0, b);
        }
        hopper::bulk_load(stats, lse + (size_t)bh * S + q0, BLOCK * 4, &slot_full[slot]);
        hopper::bulk_load(stats + BLOCK, delta + (size_t)bh * S + q0, BLOCK * 4,
                          &slot_full[slot]);
        for (int i = 0; i < nnz * TPB; ++i, ++t) {
          const int s = t % ST, k0 = desc[4 + i / TPB] * BLOCK + (i % TPB) * BK;
          hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
          uint8_t* st = base + L::kStage + s * 2 * L::kKTile;
          hopper::mbar_expect_tx(&full[s], 2 * L::kKTile);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_3d(st + c * L::kKBox, &map_k, &full[s], c0 + 64 * c, k0, b);
            hopper::tma_load_3d(st + L::kKTile + c * L::kKBox, &map_v, &full[s], c0 + 64 * c,
                                k0, b);
          }
        }
        hopper::mbar_arrive(&desc_empty[d]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, t4 = lane & 3;
  const int r0 = 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows of an item: r0, r0 + 8
  float acc[D / 2];  // dQ: an item's first dS K product overwrites it
  float sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];
  float lse2[2], dlt[2];  // lse in the exp2 domain, and delta, of this thread's rows
  uint32_t q_addr = 0, do_addr = 0;
  auto k_addr = [&](int t) { return hopper::smem_addr(base + L::kStage + t % ST * 2 * L::kKTile); };
  // S = Q K^T and dP = dO V^T in one group, both operands K-major (ring tile t)
  auto sdp = [&](int t) {
    hopper::mbar_wait(&full[t % ST], (t / ST) & 1);
    const uint32_t ka = k_addr(t), va = ka + L::kKTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t oq = kk / 4 * L::kQBox + kk % 4 * 32, ok = kk / 4 * L::kKBox + kk % 4 * 32;
      wgmma_ss<BK>(sc, hopper::sw128_desc(q_addr + oq), hopper::sw128_desc(ka + ok), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t oq = kk / 4 * L::kQBox + kk % 4 * 32, ok = kk / 4 * L::kKBox + kk % 4 * 32;
      wgmma_ss<BK>(dp, hopper::sw128_desc(do_addr + oq), hopper::sw128_desc(va + ok), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // dQ += dS K: K is the MN-major B operand, a 16-deep slice 16 keys down;
  // `first` (the item's first tile) overwrites the accumulator
  auto dsk = [&](int t, bool first) {
    const uint32_t ka = k_addr(t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(acc, da[kk], hopper::sw128_mn_desc(ka + kk * 16 * BOX_ROW, L::kKBox),
                     !first || kk > 0);
    hopper::wgmma_commit();
  };
  // p = exp2(s scale log2(e) - lse log2(e)) and dS = p (dP - delta)
  // sm_scale in fp32, into dp; no mask inside an admitted block
  auto dscores = [&]() {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = fast_exp2(fmaf(sc[4 * jj + e], scale_log2, -lse2[r]));
        dp[4 * jj + e] = pv * (dp[4 * jj + e] - dlt[r]) * sm_scale;
      }
    }
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  auto my_turn = [&]() {
    if constexpr (NC == 2) hopper::named_sync(1 + cw, 256);
  };
  auto their_turn = [&]() {
    if constexpr (NC == 2) hopper::named_arrive(2 - cw, 256);
  };
  if (NC == 2 && cw == 1) hopper::named_arrive(1, 256);

  int t = 0;  // tiles taken so far: the ring's position
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    hopper::mbar_wait(&slot_full[slot], (j >> 1) & 1);
    const int row = __shfl_sync(~0u, sItem[4 * slot], 0);
    if (row < 0) break;
    const int steps = __shfl_sync(~0u, sItem[4 * slot + 1], 0) * TPB;  // key tiles, >= 1
    const int bh = __shfl_sync(~0u, sItem[4 * slot + 2], 0);
    q_addr = hopper::smem_addr(base + slot * 2 * L::kQTile) + cw * 64 * BOX_ROW;
    do_addr = q_addr + L::kQTile;
    const float* stats = reinterpret_cast<const float*>(base + L::kStats + slot * 2 * BLOCK * 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = stats[r0 + 8 * r] * kLog2e;
      dlt[r] = stats[BLOCK + r0 + 8 * r];
    }

    // Tile i's S and dP are issued with tile i - 1's dS K, so that tile i's
    // p and dS are formed while the tensor cores finish dS K (K1's dQ); a
    // stage is freed once its K has fed dS K.
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    my_turn();
    sdp(t);
    their_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    dscores();
    pack_a(da, dp);
    for (int i = 1; i < steps; ++i) {
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      my_turn();
      sdp(t + i);
      dsk(t + i - 1, i == 1);
      their_turn();
      hopper::wgmma_wait<1>();  // S and dP of tile i are in; dS K of tile i - 1 may still run
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      dscores();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(da);
      release(&empty[(t + i - 1) % ST]);
      pack_a(da, dp);
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    my_turn();
    dsk(t + steps - 1, steps == 1);
    their_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    release(&empty[(t + steps - 1) % ST]);
    t += steps;
    // dQ of its 64 rows goes out by TMA from the slot's boxes that this
    // consumer's Q rows came in; the slot is free once the store has read them
    uint8_t* out = base + slot * 2 * L::kQTile + cw * 64 * BOX_ROW;
    stage_wg_rows<D>(out, L::kQBox, acc, 16 * warp + (lane >> 2), t4);
    hopper::fence_proxy_async();
    hopper::named_sync(3 + cw, 128);
    if ((tid & 127) == 0) {
      const int b = bh / H, c0 = (bh - b * H) * D, q0 = row * BLOCK + 64 * cw;
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_store_3d(&map_dq, out + c * L::kQBox, c0 + 64 * c, q0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();
      hopper::mbar_arrive(&slot_empty[slot]);
    }
  }
  if ((tid & 127) == 0) hopper::bulk_wait<0>();
}

// The forward: an item is query rows row * BLOCK .. + BLOCK - 1 (consumer
// cw the 64 from 64 cw); Q is loaded once into its slot, and its admitted
// key blocks are walked kKeys keys a stage, each stage's K and V together.
// o leaves by TMA store from the slot's Q boxes, lse from registers.
template <int D, int BLOCK>
__global__ void __launch_bounds__(WgThreads<BLOCK>::kThreads, WgThreads<BLOCK>::kMinBlocks)
    bsa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o, uint16_t* __restrict__ o,
                         float* __restrict__ lse, const int32_t* __restrict__ k_idx,
                         const int32_t* __restrict__ k_nnz, const int32_t* __restrict__ k_order,
                         int* __restrict__ counter, int BH, int H, int S, int A, int lead,
                         float scale_log2) {
  using L = WgFwd<D, BLOCK>;
  constexpr int NC = L::kConsumers, BK = L::kKeys, TPB = BLOCK / BK, ST = L::kStages;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* slot_full = empty + ST;
  uint64_t* slot_empty = slot_full + 2;
  uint64_t* desc_full = slot_empty + 2;
  uint64_t* desc_empty = desc_full + DESCS;
  int* sItem = reinterpret_cast<int*>(base + L::kItem);
  int32_t* descs = reinterpret_cast<int32_t*>(base + L::kDescs);
  const int tid = threadIdx.x, ints = 4 + (A + 3) / 4 * 4;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NC);
    }
    for (int j = 0; j < 2; ++j) {
      hopper::mbar_init(&slot_full[j], 1);
      hopper::mbar_init(&slot_empty[j], NC);  // each consumer's storing thread
    }
    for (int d = 0; d < DESCS; ++d) {
      hopper::mbar_init(&desc_full[d], 32);
      hopper::mbar_init(&desc_empty[d], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 1 fetches items, thread 0 loads them
    hopper::setmaxnreg_dec<WgThreads<BLOCK>::kProducerRegs>();
    if (tid >= 32 && tid < 64) {
      fetch_items<D, BLOCK>(descs, ints, desc_full, desc_empty, counter, k_idx, k_nnz, k_order,
                            BH, H, S, A, lead, o, nullptr, lse, tid - 32);
    } else if (tid == 0) {  // an item's Q into its slot, then its K/V tiles into the ring
      int t = 0;
      for (int n = 0;; ++n) {
        const int d = n % DESCS, slot = n & 1;
        hopper::mbar_wait(&desc_full[d], (n / DESCS) & 1);
        const int32_t* desc = descs + d * ints;
        const int row = desc[0], nnz = desc[1], bh = desc[2];
        hopper::mbar_wait(&slot_empty[slot], ((n >> 1) & 1) ^ 1);
        sItem[4 * slot] = row;
        sItem[4 * slot + 1] = nnz;
        sItem[4 * slot + 2] = bh;
        if (row < 0) {
          hopper::mbar_arrive(&slot_full[slot]);  // no more items
          break;
        }
        const int b = bh / H, c0 = (bh - b * H) * D, q0 = row * BLOCK;
        uint8_t* qs = base + slot * L::kQTile;
        hopper::mbar_expect_tx(&slot_full[slot], L::kQTile);
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_3d(qs + c * L::kQBox, &map_q, &slot_full[slot], c0 + 64 * c, q0, b);
        for (int i = 0; i < nnz * TPB; ++i, ++t) {
          const int s = t % ST, k0 = desc[4 + i / TPB] * BLOCK + (i % TPB) * BK;
          hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
          uint8_t* st = base + L::kStage + s * 2 * L::kKTile;
          hopper::mbar_expect_tx(&full[s], 2 * L::kKTile);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_3d(st + c * L::kKBox, &map_k, &full[s], c0 + 64 * c, k0, b);
            hopper::tma_load_3d(st + L::kKTile + c * L::kKBox, &map_v, &full[s], c0 + 64 * c,
                                k0, b);
          }
        }
        hopper::mbar_arrive(&desc_empty[d]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, t4 = lane & 3;
  const int r0 = 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows of an item: r0, r0 + 8
  float acc[D / 2];  // O: an item's first P V overwrites it
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  float m[2], l[2], alpha[2];  // the online softmax of this thread's rows, exp2 domain
  uint32_t q_addr = 0;
  auto k_addr = [&](int t) { return hopper::smem_addr(base + L::kStage + t % ST * 2 * L::kKTile); };
  // S = Q K^T, both operands K-major (ring tile t)
  auto qk = [&](int t) {
    hopper::mbar_wait(&full[t % ST], (t / ST) & 1);
    const uint32_t ka = k_addr(t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t oq = kk / 4 * L::kQBox + kk % 4 * 32, ok = kk / 4 * L::kKBox + kk % 4 * 32;
      wgmma_ss<BK>(sc, hopper::sw128_desc(q_addr + oq), hopper::sw128_desc(ka + ok), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V: V is the MN-major B operand, a 16-deep slice 16 keys down;
  // `first` (the item's first tile) overwrites the accumulator
  auto pv = [&](int t, bool first) {
    const uint32_t va = k_addr(t) + L::kKTile;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], hopper::sw128_mn_desc(va + kk * 16 * BOX_ROW, L::kKBox),
                     !first || kk > 0);
    hopper::wgmma_commit();
  };
  // the tile's scores → p (fp32) in sc; m and l move on, alpha is the
  // factor O takes. The row max is taken over the raw scores (the scale is
  // positive), so p = 2^(s scale log2(e) - m) is one FFMA and one MUFU; no
  // mask inside an admitted block.
  auto softmax = [&]() {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
      sc[i] = p;
      l[r] += p;
    }
  };
  // O *= alpha, and P (bf16) into the A fragments of the next P V
  auto rescale_pack = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    pack_a(pa, sc);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  auto my_turn = [&]() {
    if constexpr (NC == 2) hopper::named_sync(1 + cw, 256);
  };
  auto their_turn = [&]() {
    if constexpr (NC == 2) hopper::named_arrive(2 - cw, 256);
  };
  if (NC == 2 && cw == 1) hopper::named_arrive(1, 256);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  int t = 0;  // tiles taken so far: the ring's position
  for (int j = 0;; ++j) {
    const int slot = j & 1;
    hopper::mbar_wait(&slot_full[slot], (j >> 1) & 1);
    // (item values are broadcast from lane 0, so that ptxas sees the
    // branches and trip counts they give as warp-uniform)
    const int row = __shfl_sync(~0u, sItem[4 * slot], 0);
    if (row < 0) break;
    const int steps = __shfl_sync(~0u, sItem[4 * slot + 1], 0) * TPB;  // key tiles, >= 1
    const int bh = __shfl_sync(~0u, sItem[4 * slot + 2], 0);
    q_addr = hopper::smem_addr(base + slot * L::kQTile) + cw * 64 * BOX_ROW;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    // Tile i's S is issued with tile i - 1's P V, so that tile i's softmax
    // runs while the tensor cores finish P V (K1's forward); O is rescaled
    // and P repacked only once that P V is retired, and a stage is freed
    // once its V has fed P V.
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    my_turn();
    qk(t);
    their_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax();
    rescale_pack();
    for (int i = 1; i < steps; ++i) {
      hopper::fence_regs(sc);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      my_turn();
      qk(t + i);
      pv(t + i - 1, i == 1);
      their_turn();
      hopper::wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 may still run
      hopper::fence_regs(sc);
      softmax();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      release(&empty[(t + i - 1) % ST]);
      rescale_pack();
    }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    my_turn();
    pv(t + steps - 1, steps == 1);
    their_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    release(&empty[(t + steps - 1) % ST]);
    t += steps;

    // o = O / l and lse = m ln 2 + log(l) (NEG_INF where l is 0); o goes out
    // by TMA from the slot's boxes that this consumer's Q rows came in (its
    // last S has read them), and the slot is free once the store has read it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      if (t4 == 0)
        lse[(size_t)bh * S + (size_t)row * BLOCK + r0 + 8 * r] =
            lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        acc[4 * jj + 2 * r] *= inv;
        acc[4 * jj + 2 * r + 1] *= inv;
      }
    }
    uint8_t* out = base + slot * L::kQTile + cw * 64 * BOX_ROW;
    stage_wg_rows<D>(out, L::kQBox, acc, 16 * warp + (lane >> 2), t4);
    hopper::fence_proxy_async();
    hopper::named_sync(3 + cw, 128);
    if ((tid & 127) == 0) {
      const int b = bh / H, c0 = (bh - b * H) * D, q0 = row * BLOCK + 64 * cw;
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_store_3d(&map_o, out + c * L::kQBox, c0 + 64 * c, q0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();
      hopper::mbar_arrive(&slot_empty[slot]);
    }
  }
  if ((tid & 127) == 0) hopper::bulk_wait<0>();
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *idx, *nnz, *order;
  void *o, *lse_out, *dq, *dk, *dv, *counter;
  int B, H, S, A, lead;
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
    if ((err = launch_cfg(bsa_fwd_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_fwd_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<uint16_t*>(a.o), static_cast<float*>(a.lse_out), idx, nnz, order,
        a.H, a.S, a.A, scale_log2);
  } else if (kind == 1) {
    const size_t smem = row_bytes * (2 * Sh::kRows + 2 * Sh::kGroups * Sh::KT);
    if ((err = launch_cfg(bsa_dq_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_dq_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<uint16_t*>(a.dq), idx, nnz, order, a.H,
        a.S, a.A, scale_log2, a.sm_scale);
  } else {
    const size_t smem = row_bytes * (2 * Sh::kRows + 2 * Sh::kGroups * Sh::QT);
    if ((err = launch_cfg(bsa_dkv_kernel<D, BLOCK>, smem)) != cudaSuccess) return err;
    bsa_dkv_kernel<D, BLOCK><<<grid, Sh::kThreads, smem, a.st>>>(
        q, k, v, static_cast<const uint16_t*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<uint16_t*>(a.dk),
        static_cast<uint16_t*>(a.dv), idx, nnz, order, a.H, a.S, a.A, scale_log2, a.sm_scale);
  }
  return cudaGetLastError();
}

// the persistent grid of `kernel`: its blocks an SM times the SMs, or the
// items where they are fewer
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int items, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = launch_cfg(kernel, smem)) != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  grid = std::min(items, sms * std::max(per_sm, 1));
  return cudaSuccess;
}

// kind 0 = forward, 1 = dQ, 2 = dK/dV on the wgmma designs; idx and nnz
// ranked (see the kernels' note), `counter` one int the caller zeroed
template <int D, int BLOCK>
cudaError_t run_wgmma(int kind, const Args& a) {
  const bool dkv = kind == 2;
  const int q_rows = dkv ? 64 : BLOCK, k_rows = dkv ? BLOCK : WgDq<D, BLOCK>::kKeys;
  CUtensorMap mq, mk, mv, mdo, m0, m1;  // m0, m1: the outputs, stored 64 rows a box
  if (!bshd_map<D>(&mq, a.q, a.B, a.H, a.S, q_rows) ||
      !bshd_map<D>(&mk, a.k, a.B, a.H, a.S, k_rows) ||
      !bshd_map<D>(&mv, a.v, a.B, a.H, a.S, k_rows) ||
      (kind != 0 && !bshd_map<D>(&mdo, a.dout, a.B, a.H, a.S, q_rows)) ||
      !bshd_map<D>(&m0, kind == 0 ? a.o : kind == 1 ? a.dq : a.dk, a.B, a.H, a.S, 64) ||
      (dkv && !bshd_map<D>(&m1, a.dv, a.B, a.H, a.S, 64)))
    return cudaErrorInvalidValue;
  // + the fetcher's descriptors, and slack to align the base to 1024 bytes
  const size_t smem = (size_t)(kind == 0   ? WgFwd<D, BLOCK>::kDescs
                               : kind == 1 ? WgDq<D, BLOCK>::kDescs
                                           : WgDkv<D, BLOCK>::kDescs) +
                      (size_t)DESCS * 4 * (4 + (a.A + 3) / 4 * 4) + 1024;
  if (smem > 232448) return cudaErrorInvalidValue;
  const float scale_log2 = a.sm_scale * kLog2e;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int32_t* idx = static_cast<const int32_t*>(a.idx);
  const int32_t* nnz = static_cast<const int32_t*>(a.nnz);
  const int32_t* order = static_cast<const int32_t*>(a.order);
  int* counter = static_cast<int*>(a.counter);
  const int BH = a.B * a.H, items = BH * (a.S / BLOCK);
  constexpr int threads = WgThreads<BLOCK>::kThreads;
  int grid = 0;
  cudaError_t err;
  if (kind == 0) {
    auto kernel = bsa_fwd_wgmma_kernel<D, BLOCK>;
    if ((err = persistent_grid(kernel, threads, smem, items, grid)) != cudaSuccess) return err;
    kernel<<<grid, threads, smem, a.st>>>(mq, mk, mv, m0, static_cast<uint16_t*>(a.o),
                                          static_cast<float*>(a.lse_out), idx, nnz, order,
                                          counter, BH, a.H, a.S, a.A, a.lead, scale_log2);
  } else if (kind == 1) {
    auto kernel = bsa_dq_wgmma_kernel<D, BLOCK>;
    if ((err = persistent_grid(kernel, threads, smem, items, grid)) != cudaSuccess) return err;
    kernel<<<grid, threads, smem, a.st>>>(mq, mk, mv, mdo, m0, lse, delta,
                                          static_cast<uint16_t*>(a.dq), idx, nnz, order, counter,
                                          BH, a.H, a.S, a.A, a.lead, scale_log2, a.sm_scale);
  } else {
    auto kernel = bsa_dkv_wgmma_kernel<D, BLOCK>;
    if ((err = persistent_grid(kernel, threads, smem, items, grid)) != cudaSuccess) return err;
    kernel<<<grid, threads, smem, a.st>>>(mq, mk, mv, mdo, m0, m1, lse, delta,
                                          static_cast<uint16_t*>(a.dk),
                                          static_cast<uint16_t*>(a.dv), idx, nnz, order, counter,
                                          BH, a.H, a.S, a.A, a.lead, scale_log2, a.sm_scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t run_block(int kind, int block, bool wgmma, const Args& a) {
  switch (block) {
    case 16: return run<D, 16>(kind, a);
    case 32: return run<D, 32>(kind, a);
    case 64: return wgmma ? run_wgmma<D, 64>(kind, a) : run<D, 64>(kind, a);
    default: return wgmma ? run_wgmma<D, 128>(kind, a) : run<D, 128>(kind, a);
  }
}

int dispatch(int kind, int D, int block, const Args& a, bool wgmma = false) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.A <= 0 || (D != 64 && D != 128) ||
      (block != 16 && block != 32 && block != 64 && block != 128) || a.S % block != 0 ||
      a.S / block > 65535 * (block > 64 ? 1 : 64 / block) || (long long)a.B * a.H > 0x7fffffff ||
      (wgmma && (block < 64 || a.A > a.S / block || a.lead < 0 ||
                 a.lead > a.S / block ||
                 (long long)a.B * a.H * (a.S / block) > 0x7fffffff - 0x10000)))
    return (int)cudaErrorInvalidValue;
  return (int)(D == 64 ? run_block<64>(kind, block, wgmma, a)
                       : run_block<128>(kind, block, wgmma, a));
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

// The wgmma designs of the forward, dQ and dK/dV (blocks of 64 and 128),
// with the same arguments as the entries above except that idx and nnz are
// ranked (row r of head h is the list, and count, of block order[h * rows +
// r]), `counter` is one int32, zero, that the persistent grid takes its
// work items from, and `lead` (0 .. rows) is how many ranks of every
// head-row to take before the head groups (see item_at).
extern "C" int ds_bsa_fwd_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, const void* k_idx, const void* k_nnz,
                                     const void* k_order, void* counter, int B, int H, int S,
                                     int D, int block, int A, int lead, float sm_scale,
                                     void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.idx = k_idx; a.nnz = k_nnz; a.order = k_order; a.counter = counter;
  a.B = B; a.H = H; a.S = S; a.A = A; a.lead = lead; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(0, D, block, a, true);
}

extern "C" int ds_bsa_dq_wgmma_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, const void* k_idx, const void* k_nnz,
                                    const void* k_order, void* counter, int B, int H, int S,
                                    int D, int block, int A, int lead, float sm_scale,
                                    void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.idx = k_idx; a.nnz = k_nnz; a.order = k_order; a.counter = counter;
  a.B = B; a.H = H; a.S = S; a.A = A; a.lead = lead; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(1, D, block, a, true);
}

extern "C" int ds_bsa_dkv_wgmma_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, const void* q_idx, const void* q_nnz,
                                     const void* q_order, void* counter, int B, int H, int S,
                                     int D, int block, int A, int lead, float sm_scale,
                                     void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.idx = q_idx; a.nnz = q_nnz; a.order = q_order; a.counter = counter;
  a.B = B; a.H = H; a.S = S; a.A = A; a.lead = lead; a.sm_scale = sm_scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(2, D, block, a, true);
}
