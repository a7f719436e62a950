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
// cores are the limit; the backward's five products likewise. dQ alone does
// three of them (S = Q K^T, dP = dO V^T, dQ += dS K: 1.0e11 flops, 104 us
// at 989 TFLOP/s) against 5 [B, S, H, D] tensors and 2 [B, H, S] ones
// (169 MB, 50 us at 3.35 TB/s): operations, and the p and dS arithmetic
// between its second and third product, which the tensor cores must not
// wait for.
//
// All three kernels are warp-specialised wgmma designs fed by TMA
// (csrc/hopper.cuh's building blocks), for head dims 64 and 128:
//   - a block has 384 threads: a producer warpgroup (setmaxnreg 40; one
//     warp works) and two consumer warpgroups (setmaxnreg 232) of 64 rows
//     each. The forward's block owns 128 query rows: Q is loaded once, and
//     128-key tiles of K and V stream through two 3-stage rings of
//     full/empty mbarriers, K one tile ahead of V (a K stage is freed once
//     its scores are taken, a V stage once its P V is done). The dK/dV
//     block owns 128 keys: K and V are loaded once, and 64-row query tiles
//     of Q and dO, with their lse, delta and segment ids (plain loads by
//     the producer warp into the stage), stream through a 3-stage ring.
//     The dQ block owns 128 query rows: Q and dO are loaded once, and key
//     tiles of K and V (64 keys at D 128, 128 at D 64), with their segment
//     ids, stream through a 4-stage ring (a stage stays until its K has
//     fed dS K, one tile after its scores);
//   - tiles come in through 3-D tensor maps (H*D, S, B), boxes of 64 values
//     by the tile's rows, 128-byte swizzle: rows at or past S read as
//     zeros within each batch row, so no padded copies are made, and
//     strided [B, S, H, D] tensors are read as they lie;
//   - forward: S = Q K^T is wgmma m64n128k16 with both operands K-major in
//     shared memory; O += P V is m64n{D}k16 with P from registers (the
//     score accumulator re-packed in place as bf16, the FlashAttention-3
//     hand-over) and V the MN-major B operand. Tile i's Q K^T is issued
//     with tile i - 1's P V, so tile i's softmax runs while P V finishes;
//   - dK/dV: S^T = K Q^T and dP^T = V dO^T are m64n64k16 in one group,
//     then dV += bf16(P^T) dO and dK += bf16(dS^T) Q are m64n{D}k16 with
//     A from registers and dO, Q read MN-major from the same swizzled stage
//     that fed the first two products. No atomics: dQ is its own kernel;
//   - dQ: the forward's shape with one more product. S = Q K^T and dP =
//     dO V^T are m64n{keys}k16 in one group, both operands K-major; p and
//     dS = bf16(p (dP - delta) sm_scale) are formed in registers; dQ += dS
//     K is m64n{D}k16 with dS from registers and K the MN-major B operand
//     (as V in the forward). Tile i's S and dP are issued with tile i - 1's
//     dS K, so tile i's p and dS are formed while dS K finishes. No
//     atomics: each dQ row is stored once, by one block, so two runs give
//     the same bits. Registers bound the key tile: dQ's accumulator is D/2
//     a thread, S and dP keys/2 each, dS's fragments keys/4, so D 128
//     takes 64 keys (144 live) and D 64 takes 128 (192);
//   - the two consumers take turns issuing their products (ping-pong on
//     two named barriers), so one's softmax (or p and ds) runs under the
//     other's products;
//   - causal tiles wholly above the diagonal are skipped (the forward's
//     and dQ's key loops end at the block's last row, dK/dV's query loop
//     starts at its first key), the elementwise mask runs only on tiles
//     that cross the diagonal or S, or on every tile with segment ids; the
//     1-D grid (block_tile) takes the heads in groups of 16 and, within a
//     group, the longest tiles first, which shortens the causal tail while
//     a group's heads share their tiles in L2.
// Not done yet (work for a later change): dK/dV's p and ds wait for their
// tile's products (only the other consumer's products overlap them);
// outputs are stored from registers, not through TMA; the forward's and
// dQ's blocks read each K/V tile for 128 query rows only (no cluster
// multicast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "attention_wgmma.cuh"

namespace {

// ------------------------------------------------------ the wgmma designs
constexpr int WG_THREADS = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int WG_ROWS = 128;      // query rows (forward) or keys (dK/dV) a block
constexpr int FWD_KEYS = 128;     // keys a forward stage
constexpr int DKV_QROWS = 64;     // query rows a dK/dV stage
constexpr int STAGES = 3;
constexpr int DQ_STAGES = 4;      // dQ frees a stage one tile later (K feeds dS K)

template <int D>
struct FwdSmem {
  static constexpr int kBox = WG_ROWS * BOX_ROW;      // one [128 rows][64] box: 16 KB
  static constexpr int kTile = D / 64 * kBox;          // a [128 rows][D] tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                     // the K ring: STAGES tiles
  static constexpr int kV = kK + STAGES * kTile;       // the V ring
  static constexpr int kSeg = kV + STAGES * kTile;     // [STAGES][128] key segment ids (K's)
  static constexpr int kBar = kSeg + STAGES * FWD_KEYS * 4;
  static constexpr int kBytes = kBar + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

static_assert(FwdSmem<128>::kBytes <= 232448, "the forward's rings exceed a block's shared memory");

template <int D>
struct DkvSmem {
  static constexpr int kKBox = WG_ROWS * BOX_ROW;      // one [128 keys][64] box: 16 KB
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kQBox = DKV_QROWS * BOX_ROW;    // one [64 queries][64] box: 8 KB
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kK = 0, kV = kKTile;
  static constexpr int kStage = 2 * kKTile;            // stage s: Q, then dO
  static constexpr int kStats = kStage + STAGES * 2 * kQTile;  // stage s: lse, delta, seg [64]
  static constexpr int kStatsBytes = 3 * DKV_QROWS * 4;
  static constexpr int kBar = kStats + STAGES * kStatsBytes;
  static constexpr int kBytes = kBar + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
struct DqSmem {
  static constexpr int kKeys = D == 64 ? 128 : 64;     // keys a stage (registers: see the header)
  static constexpr int kQBox = WG_ROWS * BOX_ROW;      // one [128 queries][64] box: 16 KB
  static constexpr int kQTile = D / 64 * kQBox;
  static constexpr int kKBox = kKeys * BOX_ROW;        // one [keys][64] box
  static constexpr int kKTile = D / 64 * kKBox;
  static constexpr int kQ = 0, kDO = kQTile;
  static constexpr int kStage = 2 * kQTile;            // stage s: K, then V
  static constexpr int kSeg = kStage + DQ_STAGES * 2 * kKTile;  // [DQ_STAGES][keys] segment ids
  static constexpr int kBar = kSeg + DQ_STAGES * kKeys * 4;
  static constexpr int kBytes = kBar + (1 + 2 * DQ_STAGES) * 8 + 1024;
};

static_assert(DqSmem<128>::kBytes <= 232448 && DqSmem<64>::kBytes <= 232448,
              "dQ's ring exceeds a block's shared memory");

// The block order of the wgmma designs' 1-D grids: (B * H) heads in
// groups of HEAD_GROUP, a group's blocks one after another; within a group
// the tile ranks in turn, each over the group's heads. Rank 0 is the
// longest tile (the forward's last query tile, dK/dV's first key tile),
// so the card starts the longest causal blocks first and a group's heads
// share their K and V (or Q and dO) in L2.
constexpr int HEAD_GROUP = 16;

__device__ __forceinline__ void block_tile(int tiles, int heads, int& rank, int& bh) {
  const int L = blockIdx.x, group = L / (tiles * HEAD_GROUP);
  const int size = min(HEAD_GROUP, heads - group * HEAD_GROUP);  // the last group may be short
  const int r = L - group * tiles * HEAD_GROUP;
  rank = r / size;
  bh = group * HEAD_GROUP + r - rank * size;
}

// ---------------------------------------------------------------- forward
// grid (ceil(S / 128), B * H): a block owns query rows q0 .. q0 + 127,
// consumer warpgroup cw the rows 64 cw .. 64 cw + 63 of them.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const int32_t* __restrict__ seg,
                     uint16_t* __restrict__ o, float* __restrict__ lse, int H, int S,
                     float scale_log2, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full_k = qbar + 1;  // K and V run in rings of their own: a K stage is
  uint64_t* empty_k = full_k + STAGES;  // free once its scores are taken, a V
  uint64_t* full_v = empty_k + STAGES;  // stage once its P V is done
  uint64_t* empty_v = full_v + STAGES;
  int* sSeg = reinterpret_cast<int*>(base + L::kSeg);
  const int tid = threadIdx.x;
  const int tiles = (S + WG_ROWS - 1) / WG_ROWS;
  int rank, bh;
  block_tile(tiles, (int)(gridDim.x / tiles), rank, bh);
  const int q0 = (tiles - 1 - rank) * WG_ROWS;  // longest causal rows first
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kv_end = causal ? min(S, q0 + WG_ROWS) : S;
  const int steps = (kv_end + FWD_KEYS - 1) / FWD_KEYS;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 32);  // the producer warp's lanes (they write segment ids)
      hopper::mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty_v[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // (block values are broadcast from lane 0, so that ptxas sees the
  // branches they take as warp-uniform: wgmma on a path it must treat as
  // divergent is serialized)
  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 0 keeps the rings fed, K one tile ahead of V
    hopper::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int c0 = h * D;
      if (tid == 0) {
        hopper::mbar_expect_tx(qbar, L::kTile);
        for (int j = 0; j < D / 64; ++j)
          hopper::tma_load_3d(base + L::kQ + j * L::kBox, &map_q, qbar, c0 + 64 * j, q0, b);
      }
      auto load_k = [&](int i) {
        const int s = i % STAGES, k0 = i * FWD_KEYS;
        hopper::mbar_wait(&empty_k[s], ((i / STAGES) & 1) ^ 1);
        if (segb != nullptr) {
          for (int r = tid; r < FWD_KEYS; r += 32)
            sSeg[s * FWD_KEYS + r] = k0 + r < S ? segb[k0 + r] : 0;
        }
        if (tid == 0) {
          hopper::mbar_expect_tx(&full_k[s], L::kTile);
          for (int j = 0; j < D / 64; ++j)
            hopper::tma_load_3d(base + L::kK + s * L::kTile + j * L::kBox, &map_k, &full_k[s],
                                c0 + 64 * j, k0, b);
        } else {
          hopper::mbar_arrive(&full_k[s]);
        }
      };
      auto load_v = [&](int i) {
        const int s = i % STAGES;
        if (tid == 0) {
          hopper::mbar_wait(&empty_v[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full_v[s], L::kTile);
          for (int j = 0; j < D / 64; ++j)
            hopper::tma_load_3d(base + L::kV + s * L::kTile + j * L::kBox, &map_v, &full_v[s],
                                c0 + 64 * j, i * FWD_KEYS, b);
        }
      };
      load_k(0);
      for (int i = 0; i < steps; ++i) {
        if (i + 1 < steps) load_k(i + 1);
        load_v(i);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  int seg_q[2] = {0, 0};
  if (segb != nullptr) {
    seg_q[0] = row0 < S ? segb[row0] : 0;
    seg_q[1] = row0 + 8 < S ? segb[row0 + 8] : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[FWD_KEYS / 2];
  uint32_t p[FWD_KEYS / 16][4];
  const uint32_t q_addr = hopper::smem_addr(base + L::kQ) + cw * 64 * BOX_ROW;
  hopper::mbar_wait(qbar, 0);

  // the online softmax of tile i's scores, in the exp2 domain: p (fp32)
  // replaces them in sc, l and m move on, alpha rescales O; the mask only
  // where the tile crosses the diagonal or S, or with segment ids
  float alpha[2];
  auto softmax = [&](int i) {
    const int s = i % STAGES, k0 = i * FWD_KEYS;
    const bool masked = __shfl_sync(
        ~0u, (int)(segb != nullptr || k0 + FWD_KEYS > S || (causal && k0 + FWD_KEYS > q0)), 0);
    // unmasked, the row max is taken over the raw scores (the scale is
    // positive) and p = 2^(s scale - m) is one FFMA and one MUFU; masked,
    // the scores are scaled first and set to NEG_INF where not valid
    auto run = [&](auto mask) {
      constexpr bool kMask = decltype(mask)::value;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < FWD_KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if constexpr (kMask) {
            const int row = row0 + 8 * (e >> 1), cl = 8 * j + 2 * t + (e & 1), col = k0 + cl;
            bool valid = col < S;
            if (causal) valid = valid && row >= col;
            if (segb != nullptr) valid = valid && seg_q[e >> 1] == sSeg[s * FWD_KEYS + cl];
            x = valid ? x * scale_log2 : kNegInf;
            sc[4 * j + e] = x;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_tile = quad_max(mx[r]);
        const float m_new = fmaxf(m[r], kMask ? m_tile : m_tile * scale_log2);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i2 = 0; i2 < FWD_KEYS / 2; ++i2) {
        const int r = (i2 >> 1) & 1;
        const float pv = kMask ? fast_exp2(sc[i2] - m[r])
                               : fast_exp2(fmaf(sc[i2], scale_log2, -m[r]));
        sc[i2] = pv;
        l[r] += pv;
      }
    };
    if (masked) run(std::true_type{});
    else run(std::false_type{});
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
    pack_a(p, sc);
  };
  // S = Q K^T: a 16-deep slice is 32 bytes on along the rows of one box
  auto qk = [&](int i) {
    hopper::mbar_wait(&full_k[i % STAGES], (i / STAGES) & 1);
    const uint32_t k_addr = hopper::smem_addr(base + L::kK + i % STAGES * L::kTile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = kk / 4 * L::kBox + kk % 4 * 32;
      hopper::wgmma_m64n128k16<0, 0>(sc, hopper::sw128_desc(q_addr + off),
                                     hopper::sw128_desc(k_addr + off), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V: V is the MN-major B operand, [128 keys][64] boxes (the next
  // 64 columns one box on), a 16-deep slice 16 rows (2048 bytes) down
  auto pv = [&](int i) {
    hopper::mbar_wait(&full_v[i % STAGES], (i / STAGES) & 1);
    const uint32_t v_addr = hopper::smem_addr(base + L::kV + i % STAGES * L::kTile);
#pragma unroll
    for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
      wgmma_rs<D, 1>(acc, p[kk], hopper::sw128_mn_desc(v_addr + kk * 16 * BOX_ROW, L::kBox),
                     true);
    hopper::wgmma_commit();
  };
  auto release = [&](uint64_t* empty, int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % STAGES]);
  };
  // ping-pong: a consumer issues its products only after the other has
  // issued its own (named barrier 1 + cw is consumer cw's turn), so one's
  // softmax runs under the other's products; consumer 0 goes first
  auto my_turn = [&]() { hopper::named_sync(1 + cw, 256); };
  auto their_turn = [&]() { hopper::named_arrive(2 - cw, 256); };
  if (cw == 1) hopper::named_arrive(1, 256);

  // Tile i's S = Q K^T and tile i - 1's O += P V are issued together, so
  // that tile i's softmax runs while the tensor cores finish P V; O is
  // rescaled and P repacked only once that P V is retired.
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
  my_turn();
  qk(0);
  their_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  softmax(0);
  release(empty_k, 0);
  rescale_pack();
  for (int i = 1; i < steps; ++i) {
    hopper::fence_regs(sc);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    my_turn();
    qk(i);
    pv(i - 1);
    their_turn();
    hopper::wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 may still run
    hopper::fence_regs(sc);
    softmax(i);
    release(empty_k, i);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(p);
    release(empty_v, i - 1);
    rescale_pack();
  }
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  my_turn();
  pv(steps - 1);
  their_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(p);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const float l_safe = lt == 0.f ? 1.f : lt;
    inv[r] = 1.f / l_safe;
    const int row = row0 + 8 * r;
    if (t == 0 && row < S) lse[(size_t)bh * S + row] = m[r] * kLn2 + logf(l_safe);
  }
  const size_t rs = (size_t)H * D;
  store_wg_rows<D>(o + (size_t)b * S * rs + (size_t)h * D, acc, row0, S, rs, t, inv[0], inv[1]);
}

// ---------------------------------------------------------- backward dK/dV
// grid (ceil(S / 128), B * H): a block owns keys k0 .. k0 + 127, consumer
// warpgroup cw the keys 64 cw .. 64 cw + 63 of them, and walks the query
// tiles 64 rows at a time (causal: from k0 on).
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int32_t* __restrict__ seg, uint16_t* __restrict__ dk,
                         uint16_t* __restrict__ dv, int H, int S, float scale_log2,
                         float sm_scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int tiles = (S + WG_ROWS - 1) / WG_ROWS;
  int rank, bh;
  block_tile(tiles, (int)(gridDim.x / tiles), rank, bh);
  const int k0 = rank * WG_ROWS;  // causal: the first key tiles see the most queries
  const int b = bh / H, h = bh - (bh / H) * H;
  const int qs = causal ? k0 : 0;       // causal: query rows before k0 see none of these keys
  const int steps = (S - qs + DKV_QROWS - 1) / DKV_QROWS;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 0 keeps the ring fed
    hopper::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int c0 = h * D;
      const float* lseb = lse + (size_t)bh * S;
      const float* deltab = delta + (size_t)bh * S;
      if (tid == 0) {
        hopper::mbar_expect_tx(kvbar, 2 * L::kKTile);
        for (int j = 0; j < D / 64; ++j) {
          hopper::tma_load_3d(base + L::kK + j * L::kKBox, &map_k, kvbar, c0 + 64 * j, k0, b);
          hopper::tma_load_3d(base + L::kV + j * L::kKBox, &map_v, kvbar, c0 + 64 * j, k0, b);
        }
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES, q0 = qs + i * DKV_QROWS;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        float* st_lse = reinterpret_cast<float*>(base + L::kStats + s * L::kStatsBytes);
        float* st_delta = st_lse + DKV_QROWS;
        int* st_seg = reinterpret_cast<int*>(st_delta + DKV_QROWS);
        for (int r = tid; r < DKV_QROWS; r += 32) {
          const int q = q0 + r;
          const bool in = q < S;
          st_lse[r] = in ? lseb[q] * kLog2e : 0.f;
          st_delta[r] = in ? deltab[q] : 0.f;
          st_seg[r] = in && segb != nullptr ? segb[q] : 0;
        }
        if (tid == 0) {
          uint8_t* st = base + L::kStage + s * 2 * L::kQTile;
          hopper::mbar_expect_tx(&full[s], 2 * L::kQTile);
          for (int j = 0; j < D / 64; ++j) {
            hopper::tma_load_3d(st + j * L::kQBox, &map_q, &full[s], c0 + 64 * j, q0, b);
            hopper::tma_load_3d(st + L::kQTile + j * L::kQBox, &map_do, &full[s], c0 + 64 * j,
                                q0, b);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 64 * cw + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  int seg_k[2] = {0, 0};
  if (segb != nullptr) {
    seg_k[0] = key0 < S ? segb[key0] : 0;
    seg_k[1] = key0 + 8 < S ? segb[key0 + 8] : 0;
  }
  float dk_acc[D / 2], dv_acc[D / 2];  // the first step's first wgmma overwrites them
  float sc[DKV_QROWS / 2], dp[DKV_QROWS / 2];
  uint32_t pa[DKV_QROWS / 16][4], da[DKV_QROWS / 16][4];
  const uint32_t k_addr = hopper::smem_addr(base + L::kK) + cw * 64 * BOX_ROW;
  const uint32_t v_addr = hopper::smem_addr(base + L::kV) + cw * 64 * BOX_ROW;
  // ping-pong, as in the forward: the consumers take turns issuing
  auto my_turn = [&]() { hopper::named_sync(1 + cw, 256); };
  auto their_turn = [&]() { hopper::named_arrive(2 - cw, 256); };
  if (cw == 1) hopper::named_arrive(1, 256);
  hopper::mbar_wait(kvbar, 0);

  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES, q0 = qs + i * DKV_QROWS;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t q_addr = hopper::smem_addr(base + L::kStage + s * 2 * L::kQTile);
    const uint32_t do_addr = q_addr + L::kQTile;
    const float* st_lse = reinterpret_cast<const float*>(base + L::kStats + s * L::kStatsBytes);
    const float* st_delta = st_lse + DKV_QROWS;
    const int* st_seg = reinterpret_cast<const int*>(st_delta + DKV_QROWS);

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

    // P^T = valid ? exp(s - lse) : 0 and dS^T = P^T (dP^T - delta) sm_scale,
    // p in fp32 until both are rounded to bf16
    const bool masked = __shfl_sync(
        ~0u, (int)(segb != nullptr || q0 + DKV_QROWS > S || k0 + WG_ROWS > S ||
                   (causal && q0 < k0 + WG_ROWS)), 0);
    auto probs = [&](auto mask) {
#pragma unroll
      for (int j = 0; j < DKV_QROWS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          float pv = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -st_lse[ql]));
          if constexpr (decltype(mask)::value) {
            const int key = key0 + 8 * (e >> 1), q = q0 + ql;
            bool valid = key < S && q < S;
            if (causal) valid = valid && q >= key;
            if (segb != nullptr) valid = valid && st_seg[ql] == seg_k[e >> 1];
            if (!valid) pv = 0.f;
          }
          sc[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - st_delta[ql]) * sm_scale;
        }
      }
    };
    if (masked) probs(std::true_type{});
    else probs(std::false_type{});
    pack_a(pa, sc);
    pack_a(da, dp);

    // dV += P^T dO and dK += dS^T Q: dO and Q are the MN-major B operands,
    // read from the same stage, [64 queries][64] boxes (the next 64
    // columns one box on), a 16-deep slice 16 rows (2048 bytes) down
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
    my_turn();
#pragma unroll
    for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
      wgmma_rs<D, 1>(dv_acc, pa[kk],
                     hopper::sw128_mn_desc(do_addr + kk * 16 * BOX_ROW, L::kQBox), i > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
      wgmma_rs<D, 1>(dk_acc, da[kk],
                     hopper::sw128_mn_desc(q_addr + kk * 16 * BOX_ROW, L::kQBox), i > 0 || kk > 0);
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

  const size_t rs = (size_t)H * D;
  const size_t off = (size_t)b * S * rs + (size_t)h * D;
  store_wg_rows<D>(dk + off, dk_acc, key0, S, rs, t, 1.f, 1.f);
  store_wg_rows<D>(dv + off, dv_acc, key0, S, rs, t, 1.f, 1.f);
}

// -------------------------------------------------------------- backward dQ
// 1-D grid in block_tile's order: a block owns query rows q0 .. q0 + 127
// (the longest causal rows first), consumer warpgroup cw the rows 64 cw ..
// 64 cw + 63 of them, and walks the key tiles DqSmem<D>::kKeys at a time up
// to its last row (causal) or S.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int32_t* __restrict__ seg, uint16_t* __restrict__ dq, int H, int S,
                        float scale_log2, float sm_scale, int causal) {
  using L = DqSmem<D>;
  constexpr int BK = L::kKeys;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024u - (hopper::smem_addr(wg_smem) & 1023u)) & 1023u);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + DQ_STAGES;
  int* sSeg = reinterpret_cast<int*>(base + L::kSeg);
  const int tid = threadIdx.x;
  const int tiles = (S + WG_ROWS - 1) / WG_ROWS;
  int rank, bh;
  block_tile(tiles, (int)(gridDim.x / tiles), rank, bh);
  const int q0 = (tiles - 1 - rank) * WG_ROWS;  // longest causal rows first
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kv_end = causal ? min(S, q0 + WG_ROWS) : S;
  const int steps = (kv_end + BK - 1) / BK;
  const int32_t* segb = seg != nullptr ? seg + (size_t)b * S : nullptr;
  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes (they write segment ids)
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(~0u, tid / 128, 0);
  if (wg == 0) {  // the producer: warp 0 loads Q and dO once and keeps the K/V ring fed
    hopper::setmaxnreg_dec<40>();
    if (tid < 32) {
      const int c0 = h * D;
      if (tid == 0) {
        hopper::mbar_expect_tx(qbar, 2 * L::kQTile);
        for (int j = 0; j < D / 64; ++j) {
          hopper::tma_load_3d(base + L::kQ + j * L::kQBox, &map_q, qbar, c0 + 64 * j, q0, b);
          hopper::tma_load_3d(base + L::kDO + j * L::kQBox, &map_do, qbar, c0 + 64 * j, q0, b);
        }
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % DQ_STAGES, k0 = i * BK;
        hopper::mbar_wait(&empty[s], ((i / DQ_STAGES) & 1) ^ 1);
        if (segb != nullptr) {
          for (int r = tid; r < BK; r += 32) sSeg[s * BK + r] = k0 + r < S ? segb[k0 + r] : 0;
        }
        if (tid == 0) {
          uint8_t* st = base + L::kStage + s * 2 * L::kKTile;
          hopper::mbar_expect_tx(&full[s], 2 * L::kKTile);
          for (int j = 0; j < D / 64; ++j) {
            hopper::tma_load_3d(st + j * L::kKBox, &map_k, &full[s], c0 + 64 * j, k0, b);
            hopper::tma_load_3d(st + L::kKTile + j * L::kKBox, &map_v, &full[s], c0 + 64 * j,
                                k0, b);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float lse2[2], dlt[2];  // lse in the exp2 domain, and delta, of this thread's rows
  int seg_q[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool in = row < S;
    lse2[r] = in ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
    dlt[r] = in ? delta[(size_t)bh * S + row] : 0.f;
    seg_q[r] = in && segb != nullptr ? segb[row] : 0;
  }
  float acc[D / 2];  // dQ: the first dS K product overwrites it
  float sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];
  const uint32_t q_addr = hopper::smem_addr(base + L::kQ) + cw * 64 * BOX_ROW;
  const uint32_t do_addr = hopper::smem_addr(base + L::kDO) + cw * 64 * BOX_ROW;
  auto k_addr = [&](int i) {
    return hopper::smem_addr(base + L::kStage + i % DQ_STAGES * 2 * L::kKTile);
  };
  hopper::mbar_wait(qbar, 0);

  // S = Q K^T and dP = dO V^T in one group, both operands K-major: a
  // 16-deep slice is 32 bytes on along the rows of one box
  auto sdp = [&](int i) {
    hopper::mbar_wait(&full[i % DQ_STAGES], (i / DQ_STAGES) & 1);
    const uint32_t ka = k_addr(i), va = ka + L::kKTile;
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
  // dQ += dS K: K is the MN-major B operand, [BK keys][64] boxes (the next
  // 64 columns one box on), a 16-deep slice 16 keys (2048 bytes) down
  auto dsk = [&](int i) {
    const uint32_t ka = k_addr(i);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(acc, da[kk], hopper::sw128_mn_desc(ka + kk * 16 * BOX_ROW, L::kKBox),
                     i > 0 || kk > 0);
    hopper::wgmma_commit();
  };
  // p = valid ? exp(s - lse) : 0 and dS = p (dP - delta) sm_scale in fp32,
  // into dp; the mask only where the tile crosses the diagonal or S, or
  // with segment ids
  auto dscores = [&](int i) {
    const int s = i % DQ_STAGES, k0 = i * BK;
    const bool masked = __shfl_sync(
        ~0u, (int)(segb != nullptr || k0 + BK > S || (causal && k0 + BK > q0)), 0);
    auto run = [&](auto mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, cl = 8 * j + 2 * t + (e & 1);
          float pv = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lse2[r]));
          if constexpr (decltype(mask)::value) {
            const int row = row0 + 8 * r, col = k0 + cl;
            bool valid = col < S;
            if (causal) valid = valid && row >= col;
            if (segb != nullptr) valid = valid && seg_q[r] == sSeg[s * BK + cl];
            if (!valid) pv = 0.f;
          }
          dp[4 * j + e] = pv * (dp[4 * j + e] - dlt[r]) * sm_scale;
        }
      }
    };
    if (masked) run(std::true_type{});
    else run(std::false_type{});
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % DQ_STAGES]);
  };
  // ping-pong, as in the forward: the consumers take turns issuing
  auto my_turn = [&]() { hopper::named_sync(1 + cw, 256); };
  auto their_turn = [&]() { hopper::named_arrive(2 - cw, 256); };
  if (cw == 1) hopper::named_arrive(1, 256);

  // Tile i's S and dP are issued with tile i - 1's dS K, so that tile i's
  // p and dS are formed while the tensor cores finish dS K; dS is packed
  // into the A fragments only once that product is retired, and a stage
  // is freed once its K has fed dS K.
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
  my_turn();
  sdp(0);
  their_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
  dscores(0);
  pack_a(da, dp);
  for (int i = 1; i < steps; ++i) {
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    my_turn();
    sdp(i);
    dsk(i - 1);
    their_turn();
    hopper::wgmma_wait<1>();  // S and dP of tile i are in; dS K of tile i - 1 may still run
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    dscores(i);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    release(i - 1);
    pack_a(da, dp);
  }
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  my_turn();
  dsk(steps - 1);
  their_turn();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  hopper::fence_regs(da);

  const size_t rs = (size_t)H * D;
  store_wg_rows<D>(dq + (size_t)b * S * rs + (size_t)h * D, acc, row0, S, rs, t, 1.f, 1.f);
}

bool bad_shape(int B, int H, int S, int D) {
  return B <= 0 || H <= 0 || S <= 0 || (D != 64 && D != 128) || (long long)B * H > 65535;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* lse, int B, int H, int S, float sm_scale, int causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!bshd_map<D>(&mq, q, B, H, S, WG_ROWS) || !bshd_map<D>(&mk, k, B, H, S, FWD_KEYS) ||
      !bshd_map<D>(&mv, v, B, H, S, FWD_KEYS))
    return cudaErrorInvalidValue;
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err = launch_cfg(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((S + WG_ROWS - 1) / WG_ROWS) * B * H;  // block_tile's order
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<(int)grid, WG_THREADS, smem, st>>>(
      mq, mk, mv, static_cast<const int32_t*>(seg), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), H, S, sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                    int B, int H, int S, float sm_scale, int causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  if (!bshd_map<D>(&mq, q, B, H, S, DKV_QROWS) || !bshd_map<D>(&mk, k, B, H, S, WG_ROWS) ||
      !bshd_map<D>(&mv, v, B, H, S, WG_ROWS) || !bshd_map<D>(&mdo, dout, B, H, S, DKV_QROWS))
    return cudaErrorInvalidValue;
  const int smem = DkvSmem<D>::kBytes;
  cudaError_t err = launch_cfg(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((S + WG_ROWS - 1) / WG_ROWS) * B * H;  // block_tile's order
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<D><<<(int)grid, WG_THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      H, S, sm_scale * kLog2e, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                   int S, float sm_scale, int causal, cudaStream_t st) {
  constexpr int BK = DqSmem<D>::kKeys;
  CUtensorMap mq, mk, mv, mdo;
  if (!bshd_map<D>(&mq, q, B, H, S, WG_ROWS) || !bshd_map<D>(&mk, k, B, H, S, BK) ||
      !bshd_map<D>(&mv, v, B, H, S, BK) || !bshd_map<D>(&mdo, dout, B, H, S, WG_ROWS))
    return cudaErrorInvalidValue;
  const int smem = DqSmem<D>::kBytes;
  cudaError_t err = launch_cfg(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((S + WG_ROWS - 1) / WG_ROWS) * B * H;  // block_tile's order
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D><<<(int)grid, WG_THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<uint16_t*>(dq), H, S, sm_scale * kLog2e,
      sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous tensors: q/k/v/o/dout/dq/dk/dv bf16 [B, S, H, D]; lse/delta
// fp32 [B, H, S]; seg int32 [B, S] or null. The wrapper in
// ops/kernels/flash_attention.py checks shapes, types and alignment (TMA
// reads from 16-byte aligned bases) before calling. Each returns
// cudaGetLastError() of its launch, or cudaErrorInvalidValue where the
// shape is refused or libcuda refuses a tensor map.
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
