// Paged attention for Hopper (sm_90a): query tokens against their
// block-tabled KV context, GQA, online softmax in fp32. Two designs, chosen
// by shape alone in ops/kernels/paged_attention.py (`paged_design`).
//
// Replaces the TPU kernel `_kernel` / `paged_decode_attention` in
// deepspeed_tpu/ops/pallas/paged_attention.py (the `pl.pallas_call` there).
// Same contract as that module's `xla_paged_attention`:
//   q [T, H, Dh] bf16, kc/vc [NB, bs, Hkv, Dh] bf16 (one layer's pool slice),
//   block_tables [T, MB] int32 (one row per token), token_pos [T] int32
//   -> out [T, H, Dh] bf16, token t attending to positions <= token_pos[t]
//   of its own blocks 0 .. min(pos // bs + 1, MB) - 1, scale 1/sqrt(Dh),
//   query head h reading KV head h / (H / Hkv).
//
// What bounds it: the bytes of K and V read from device memory, about
//   (unique rows attended) * Hkv * Dh * 2 (K and V) * 2 bytes,
// against 3.35 TB/s on an H100 SXM. It does 4 * H * Dh flops per attended
// (token, position), about one flop per byte of KV at decode (G = 4).
//
// The tiled design (paged_tiled_kernel, the serving path's):
//   - query tiles: a run of consecutive tokens that read the same table
//     prefix at consecutive positions, cut where a position is a multiple of
//     TQ = 64 / G. One block takes one (tile, KV head) and packs its TQ
//     tokens x G query heads as the 64 rows of one product, so each K/V row
//     is read once per tile, not once per token. A decode token or a pad
//     row is a tile of one token. The grid is static, about two blocks an
//     SM, and each block finds its own work, with no work list and no host
//     sync: it takes every 263rd (token, KV head, chunk) item; one read of the
//     positions says whether a token anchors a run (consecutive positions up
//     to the next multiple of TQ), and the anchor cuts the run into tiles
//     where a token's table prefix differs from the token's before it;
//   - tensor cores: S = Q K^T and O = P V on mma.sync.m16n8k16 (bf16
//     operands, fp32 sums; attention_tiles.cuh, as K8), P as two bf16 terms
//     (hi and lo) for P V, l summed from fp32 P. Four warps share each 16-row
//     tile: warp w scores a quarter of the stage's KV rows and sums a
//     quarter of the output columns, the row maxima and P passing through
//     shared memory, so a decode token's one tile is not one warp's chain.
//     Every row runs the same instructions whatever the tile holds;
//   - K/V staged through shared memory in a cp.async ring of kStages
//     stages of KT rows, the table entries of the block's range read once;
//   - long contexts split over blocks by fixed absolute chunks of kChunk
//     positions: each chunk's softmax state starts fresh; when the tile's
//     context spans more than one chunk, each block writes fp32 partials
//     (m, l, acc) and the last block of the (tile, KV head) to arrive merges
//     them in ascending chunk order, s = c0, s = merge(s, c1), ...
//   A row's bits depend on its own q row, its own positions' K/V and its
//   position only: the KV tiles and chunks are cut at absolute positions, a
//   KV tile that is all masked for a row leaves its state unchanged (alpha 1,
//   P 0), and an empty chunk merges as the identity. So a token gives the
//   same bits alone, first or last in a tile, beside any other sequences, at
//   any T.
//
// The token design (paged_decode_kernel, the first one; shapes the tiled
// design does not take):
//   - one thread block per (token, KV head, group of <= 8 query heads), so the
//     G query heads sharing a KV head read each K/V row once, not G times;
//   - each K/V row is read as 16-byte vectors by a group of lanes (Dh / 8
//     lanes, rounded up to a power of two), so a warp covers whole rows with
//     coalesced loads;
//   - every lane group keeps kUnroll rows' loads in flight before it uses any
//     of them, and 8 warps per block walk the context together, to hide the
//     device-memory latency;
//   - scores, softmax state and the P.V accumulator stay in fp32 registers;
//     the warps merge their partial softmax states once, through shared
//     memory.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // context rows a lane group has in flight per trip
constexpr int kMaxHeads = 8; // query heads one block handles (grid.z splits more)

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  // bf16 is the upper half of an fp32: widening is a shift, exact.
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint16_t float_to_bf16_rne(float x) {
  // round to nearest even; inputs here are finite
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

template <int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ kc,
                    const uint16_t* __restrict__ vc,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ token_pos,
                    uint16_t* __restrict__ out,
                    int H, int Hkv, int Dh, int bs, int MB, float scale_log2) {
  extern __shared__ float smem[];
  float* sm_m = smem;                          // [kWarps][GT]
  float* sm_l = sm_m + kWarps * GT;            // [kWarps][GT]
  float* sm_acc = sm_l + kWarps * GT;          // [kWarps][GT][Dh]

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int g0 = blockIdx.z * GT;
  const int gn = min(GT, G - g0);
  const int h0 = kvh * G + g0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int chunks = Dh >> 3;                  // 16-byte chunks in one head row
  int lpr = 1;                                 // lanes per row, a power of two
  while (lpr < chunks) lpr <<= 1;
  const int rpw = 32 / lpr;                    // rows a warp reads at once
  const int grp = lane / lpr;
  const int c = lane % lpr;
  const bool active = c < chunks;
  const int rows_per_trip = kWarps * rpw;

  // q for this lane's chunk, pre-scaled into the log2 domain (exp2 below)
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn && active) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          q + ((size_t)t * H + h0 + g) * Dh + c * 8);
      bf16x8_to_float(v, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -FLT_MAX;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int n_pos = min(token_pos[t] + 1, MB * bs);
  const int32_t* tab = tables + (size_t)t * MB;
  const size_t row_stride = (size_t)Hkv * Dh;
  const size_t head_off = (size_t)kvh * Dh + c * 8;

  // The trip count depends only on the warp, never on the lane, so every
  // lane reaches the shuffles below.
  for (int base = warp * rpw; base < n_pos; base += rows_per_trip * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + grp + u * rows_per_trip;
      ok[u] = p < n_pos;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && active) {
        const int blk = __ldg(tab + p / bs);
        const size_t off = ((size_t)blk * bs + p % bs) * row_stride + head_off;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kc + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vc + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[8];
      bf16x8_to_float(kr[u], kf);
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
        for (int o = lpr >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[g] = d;
      }
      if (ok[u]) {
        float vf[8];
        bf16x8_to_float(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = exp2f(m[g] - m_new);
          const float p = exp2f(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vf[e]);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warp's row groups (lanes with the same chunk index)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = exp2f(m[g] - m_new);
      const float b = exp2f(m_o - m_new);
      l[g] = l[g] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * b;
      }
      m[g] = m_new;
    }
  }

  // merge the warps through shared memory
  if (grp == 0 && active) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < gn) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sm_acc[(warp * GT + g) * Dh + c * 8 + e] = acc[g][e];
        if (c == 0) {
          sm_m[warp * GT + g] = m[g];
          sm_l[warp * GT + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    float mx = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * GT + g] - mx);
      lsum += sm_l[w * GT + g] * f;
      a += sm_acc[(w * GT + g) * Dh + d] * f;
    }
    out[((size_t)t * H + h0 + g) * Dh + d] = float_to_bf16_rne(a / fmaxf(lsum, 1e-30f));
  }
}

template <int GT>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* tables,
                   const void* pos, void* out, int T, int H, int Hkv, int Dh, int bs,
                   int MB, cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(T, Hkv, (G + GT - 1) / GT);
  const size_t smem = sizeof(float) * kWarps * GT * (2 + Dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  paged_decode_kernel<GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(kc),
      static_cast<const uint16_t*>(vc), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<uint16_t*>(out),
      H, Hkv, Dh, bs, MB, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tiled design
namespace tiled {

constexpr int kRows = 64;              // product rows a block: TQ tokens x G heads
constexpr int kGroups = kRows / 16;    // 16-row mma tiles a block
constexpr int kColWarps = 4;           // warps that share one 16-row tile
constexpr int kWarps = kGroups * kColWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;            // positions a block walks: the split's fixed cut
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kMaxTab = kChunk / 8 + 2;  // table entries a chunk can touch (bs >= 8)
constexpr int kMaxBlocks = 263;        // about two an SM (one resident): odd, so cuts every TQ spread

// KT: KV rows a stage (64, or 32 past Dh 128: about 16 KB of K and of V).
// Warp w of a 16-row tile scores KV rows w KT/4 .. (w + 1) KT/4 - 1 and sums
// output columns w Dh/4 .. (w + 1) Dh/4 - 1 of P V.
template <int D>
struct Cfg {
  static constexpr int KT = D <= 128 ? 64 : 32;
  static constexpr int KW = KT / kColWarps;  // KV rows a warp scores: 16 or 8
  static constexpr int DW = D / kColWarps;   // output columns a warp sums
  static constexpr int LD = D + kPad;        // padded shared row, bf16
  static constexpr int LDP = KT + kPad;      // P's padded rows
  static constexpr int CH = D / 8;           // 16-byte chunks a row
  static constexpr size_t kSmem =
      sizeof(uint16_t) * ((size_t)(kRows + 2 * kStages * KT) * LD + 2 * (size_t)kRows * LDP) +
      sizeof(float) * kRows * kColWarps + sizeof(int) * kMaxTab;
};

// the 4 warps of one 16-row tile (barrier 1 + group; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kColWarps * 32) : "memory");
}

__device__ __forceinline__ int n_blocks(int p, int bs, int MB) { return min(p / bs + 1, MB); }

struct Args {
  const uint16_t* __restrict__ q;
  const uint16_t* __restrict__ kc;
  const uint16_t* __restrict__ vc;
  const int32_t* __restrict__ tables;
  const int32_t* __restrict__ token_pos;
  uint16_t* __restrict__ out;
  float* __restrict__ ws;        // [T, H, chunks, D + 2] fp32: (m, l, acc) a row and chunk
  int32_t* __restrict__ counts;  // [T, Hkv]: chunks stored a tile; zero before and after
  int T, H, Hkv, bs, MB, NC;
  int bs_shift;                  // log2(bs) when bs is a power of two, else -1
  float scale_log2;
};

// One (tile, KV head, chunk): tokens t .. t + n - 1 at positions p0 .. p0 + n
// - 1, all reading the last token's table. Called by every thread of the
// block; `smem` holds Q, the ring, P, the cross-warp sums and the chunk's
// table entries.
template <int D>
__device__ __forceinline__ void tile_body(const Args& a, uint16_t* smem, int t, int n, int p0,
                                          int kvh, int c) {
  using C = Cfg<D>;
  constexpr int KT = C::KT, KW = C::KW, DW = C::DW, LD = C::LD, LDP = C::LDP, CH = C::CH;
  uint16_t* sQ = smem;                                   // [kRows][LD]
  uint16_t* sKV = sQ + kRows * LD;                       // [kStages][2][KT][LD]
  uint16_t* sP = sKV + 2 * kStages * KT * LD;            // [2][kRows][LDP]: P's bf16 hi, lo
  float* sRed = reinterpret_cast<float*>(sP + 2 * kRows * LDP);  // [kRows][kColWarps]
  int* sTab = reinterpret_cast<int*>(sRed + kRows * kColWarps);  // [kMaxTab]
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int G = a.H / a.Hkv, H = a.H, bs = a.bs, MB = a.MB;
  const int tl = t + n - 1;                               // the tile's last token
  const int ctx = min(p0 + n, MB * bs);                   // positions the last token reads
  const int nc = (ctx + kChunk - 1) / kChunk;             // chunks the tile spans
  if (c >= nc) return;                                    // uniform: another block's chunk
  const int kv_begin = c * kChunk, kv_end = min(kv_begin + kChunk, ctx);
  __syncthreads();  // the previous tile's readers of shared memory are done

  // Q's rows (cp.async, in flight while the table entries load), then the
  // table entries of this chunk from the last token's row
  const int rows = n * G;
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i - (i / CH) * CH;
    const bool live = r < rows;
    const int tq = live ? r / G : 0;
    const uint16_t* src =
        a.q + ((size_t)(t + tq) * H + kvh * G + (live ? r - tq * G : 0)) * D + ch * 8;
    cp_async16(sQ + r * LD + ch * 8, src, live);
  }
  cp_commit();
  const int j0 = kv_begin / bs, nj = (kv_end - 1) / bs - j0 + 1;
  for (int j = tid; j < nj; j += kThreads) sTab[j] = __ldg(a.tables + (size_t)tl * MB + j0 + j);
  __syncthreads();  // sTab

  const size_t row_stride = (size_t)a.Hkv * D;
  const int n_tiles = (kv_end - kv_begin + KT - 1) / KT;
  auto load_stage = [&](int it) {
    uint16_t* sK = sKV + (it % kStages) * 2 * KT * LD;
    uint16_t* sV = sK + KT * LD;
    const int base = kv_begin + it * KT;
    for (int i = tid; i < KT * CH; i += kThreads) {
      const int r = i / CH, ch = i - (i / CH) * CH;
      const int p = base + r;
      const bool live = p < kv_end;
      size_t off = 0;
      if (live) {
        const int blk = a.bs_shift >= 0 ? p >> a.bs_shift : p / bs;
        off = ((size_t)sTab[blk - j0] * bs + (p - blk * bs)) * row_stride + (size_t)kvh * D +
              ch * 8;
      }
      cp_async16(sK + r * LD + ch * 8, a.kc + off, live);
      cp_async16(sV + r * LD + ch * 8, a.vc + off, live);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_stage(st);
    cp_commit();
  }

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq4 = lane & 3;
  const int grp = warp / kColWarps, cw = warp % kColWarps;
  const int wr = grp * 16;                  // the group's first row
  const bool computes = wr < rows;          // uniform over the group
  // each lane's two rows (g, g + 8): the last position each reads, + 1
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + g + 8 * h;
    lim[h] = r < rows ? min(min(p0 + r / G + 1, MB * bs), kv_end) : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage it landed for every thread; stage it - 1, P, sRed are free
    if (it + kStages - 1 < n_tiles) load_stage(it + kStages - 1);
    cp_commit();
    if (!computes) continue;
    const uint16_t* sK = sKV + (it % kStages) * 2 * KT * LD;
    const uint16_t* sV = sK + KT * LD;
    const int col0 = kv_begin + it * KT + cw * KW;  // this warp's first KV row

    // S = Q K^T over this warp's KW rows of the stage
    float s[KW / 8][4];
#pragma unroll
    for (int i = 0; i < KW / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a_order<LD>(sQ, wr, kk * 16, lane));
      if constexpr (KW == 16) {
        uint32_t bb[4];
        ldsm_x4(bb, b_order<LD>(sK, cw * KW, kk * 16, lane));
        mma16816(s[0], af, bb[0], bb[1]);
        mma16816(s[1], af, bb[2], bb[3]);
      } else {
        uint32_t bb[2];  // lanes 0-15: rows cw KW .. + 7 at k kk 16 and kk 16 + 8
        ldsm_x2(bb, sK + (cw * KW + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[0], af, bb[0], bb[1]);
      }
    }
    // the rows' maxima over the whole stage: this warp's, then the group's
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = col0 + nt * 8 + tq4 * 2 + (e & 1);
        s[nt][e] = p < lim[e >> 1] ? s[nt][e] * a.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      if (tq4 == 0) sRed[(wr + g + 8 * h) * kColWarps + cw] = mx[h];
    }
    group_sync(grp);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* red = sRed + (wr + g + 8 * h) * kColWarps;
      const float m_new = fmaxf(m[h], fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3])));
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    // P = exp2(S - m): fp32 into this warp's l, and into the group's P as
    // two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so P V keeps
    // about 16 bits of p
#pragma unroll
    for (int nt = 0; nt < KW / 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0v = exp2f(s[nt][2 * h] - m[h]), p1v = exp2f(s[nt][2 * h + 1] - m[h]);
        l[h] += p0v;
        l[h] += p1v;
        const uint32_t hi = pack_bf16(p0v, p1v);
        const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
        const int o = (wr + g + 8 * h) * LDP + cw * KW + nt * 8 + tq4 * 2;
        *reinterpret_cast<uint32_t*>(sP + o) = hi;
        *reinterpret_cast<uint32_t*>(sP + kRows * LDP + o) =
            pack_bf16(__fsub_rn(p0v, h0), __fsub_rn(p1v, h1));
      }
    }
#pragma unroll
    for (int dt = 0; dt < DW / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    group_sync(grp);  // the group's P is stored, and its maxima read
    // O += P_hi V + P_lo V over this warp's DW output columns
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t ph[4], pl[4];
      ldsm_x4(ph, a_order<LDP>(sP, wr, kk * 16, lane));
      ldsm_x4(pl, a_order<LDP>(sP + kRows * LDP, wr, kk * 16, lane));
#pragma unroll
      for (int dn = 0; dn < DW / 16; ++dn) {
        uint32_t bb[4];
        ldsm_x4_t(bb, a_order<LD>(sV, kk * 16, cw * DW + dn * 16, lane));
        mma16816(acc[2 * dn], ph, bb[0], bb[1]);
        mma16816(acc[2 * dn + 1], ph, bb[2], bb[3]);
        mma16816(acc[2 * dn], pl, bb[0], bb[1]);
        mma16816(acc[2 * dn + 1], pl, bb[2], bb[3]);
      }
      if constexpr (DW % 16 != 0) {  // an odd last 8-column tile
        uint32_t bb[2];
        ldsm_x2_t(bb, a_order<LD>(sV, kk * 16, cw * DW + (DW / 16) * 16, lane));
        mma16816(acc[DW / 8 - 1], ph, bb[0], bb[1]);
        mma16816(acc[DW / 8 - 1], pl, bb[0], bb[1]);
      }
    }
  }
  cp_wait<0>();

  // l: each warp's over its KV rows, added in warp order
  float lt[2] = {0.f, 0.f};
  if (computes) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lw = quad_sum(l[h]);
      if (tq4 == 0) sRed[(wr + g + 8 * h) * kColWarps + cw] = lw;
    }
    group_sync(grp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* red = sRed + (wr + g + 8 * h) * kColWarps;
      lt[h] = ((red[0] + red[1]) + red[2]) + red[3];
    }
  }
  // One chunk: normalise and write. Several: store this chunk's state,
  // and the last block of the (tile, KV head) to arrive merges them in order.
  if (nc == 1) {
    if (!computes) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + g + 8 * h;
      if (r >= rows) continue;
      const float inv = 1.f / lt[h];
      const int tq = r / G;
      uint16_t* dst =
          a.out + ((size_t)(t + tq) * H + kvh * G + (r - tq * G)) * D + cw * DW + tq4 * 2;
#pragma unroll
      for (int dt = 0; dt < DW / 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16(__fmul_rn(acc[dt][2 * h], inv), __fmul_rn(acc[dt][2 * h + 1], inv));
    }
    return;
  }
  constexpr int PW = D + 2;  // a partial row: m, l, acc[D]
  if (computes) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + g + 8 * h;
      if (r >= rows) continue;
      const int tq = r / G;
      float* dst = a.ws + (((size_t)(t + tq) * H + kvh * G + (r - tq * G)) * a.NC + c) * PW;
      if (tq4 == 0 && cw == 0) {
        dst[0] = m[h];
        dst[1] = lt[h];
      }
#pragma unroll
      for (int dt = 0; dt < DW / 8; ++dt) {
        dst[2 + cw * DW + dt * 8 + tq4 * 2] = acc[dt][2 * h];
        dst[2 + cw * DW + dt * 8 + tq4 * 2 + 1] = acc[dt][2 * h + 1];
      }
    }
  }
  __threadfence();  // this thread's partials, before the arrival
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counts + (size_t)t * a.Hkv + kvh, 1) == nc - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // the other chunks' partials, after their arrivals
  for (int i = tid; i < rows * (D / 2); i += kThreads) {
    const int r = i / (D / 2), d = 2 * (i - r * (D / 2));
    const int tq = r / G;
    const size_t row = (size_t)(t + tq) * H + kvh * G + (r - tq * G);
    const float* src = a.ws + row * a.NC * PW;
    float sm = __ldcg(src), sl = __ldcg(src + 1);
    float2 sa = __ldcg(reinterpret_cast<const float2*>(src + 2 + d));
    for (int cc = 1; cc < nc; ++cc) {
      const float* pc = src + (size_t)cc * PW;
      const float mc = __ldcg(pc), lc = __ldcg(pc + 1);
      const float2 ac = __ldcg(reinterpret_cast<const float2*>(pc + 2 + d));
      const float mn = fmaxf(sm, mc);
      const float fa = exp2f(sm - mn), fb = exp2f(mc - mn);
      sl = __fmaf_rn(sl, fa, __fmul_rn(lc, fb));
      sa.x = __fmaf_rn(sa.x, fa, __fmul_rn(ac.x, fb));
      sa.y = __fmaf_rn(sa.y, fa, __fmul_rn(ac.y, fb));
      sm = mn;
    }
    const float inv = 1.f / sl;
    *reinterpret_cast<uint32_t*>(a.out + row * D + d) =
        pack_bf16(__fmul_rn(sa.x, inv), __fmul_rn(sa.y, inv));
  }
  if (tid == 0) a.counts[(size_t)t * a.Hkv + kvh] = 0;
}

// A 1-D grid of P = min(items, 263) blocks of 512 threads (one resident an
// SM, so the card's scheduler hands a second block to each SM that ends
// its first: the items differ in cost).
// The work items are (candidate token, KV head, chunk), the token fastest;
// block b takes items b, b + P, ... (P odd, so tiles that start every TQ
// tokens spread over the blocks) and reads all their positions at once. A
// candidate anchors a run when it is the first token, its position is a
// multiple of TQ, or it does not sit at the position after the token before
// it. The anchor cuts its run (at most TQ tokens at consecutive positions)
// where a token's table prefix differs from the token's before it, and takes
// the tiles in turn.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) paged_tiled_kernel(const Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  __shared__ int s_pos[kRows + 1];           // positions of tokens cand - 1 .. cand + TQ - 1
  __shared__ unsigned long long s_cut;       // bit i: token cand + i starts a tile
  __shared__ unsigned char s_kind[kThreads];  // an item: 0 nothing to do, 1 a run, 2 one token
  const int tid = threadIdx.x, P = gridDim.x;
  const int G = a.H / a.Hkv, TQ = kRows / G;
  const int items = a.T * a.Hkv * a.NC;
  const int mine = (items - (int)blockIdx.x + P - 1) / P;
  for (int base = 0; base < mine; base += kThreads) {
    __syncthreads();  // the previous items' readers of s_kind are done
    if (base + tid < mine) {
      const int item = blockIdx.x + (base + tid) * P;
      const int cand = item % a.T, c = item / (a.T * a.Hkv);
      const int p = __ldg(a.token_pos + cand);
      const int prev = cand > 0 ? __ldg(a.token_pos + cand - 1) : -2;
      const int next = cand + 1 < a.T ? __ldg(a.token_pos + cand + 1) : -2;
      const bool anchor = cand == 0 || p % TQ == 0 || prev != p - 1;
      const bool alone = next != p + 1 || (p + 1) % TQ == 0;  // a run of one token
      const int ctx = min(p + 1, a.MB * a.bs);
      s_kind[tid] = !anchor ? 0 : !alone ? 1 : c * kChunk < ctx ? 2 : 0;
    }
    __syncthreads();
    const int todo = min(kThreads, mine - base);
    for (int j = 0; j < todo; ++j) {
      const int kind = s_kind[j];
      if (kind == 0) continue;  // uniform: inside a run, or past the token's chunks
      const int item = blockIdx.x + (base + j) * P;
      const int cand = item % a.T, kvh = item / a.T % a.Hkv, c = item / (a.T * a.Hkv);
      if (kind == 2) {
        tile_body<D>(a, smem, cand, 1, __ldg(a.token_pos + cand), kvh, c);
        continue;
      }
      __syncthreads();  // the previous anchor's readers of s_pos and s_cut are done
      if (tid <= TQ) {
        const int t = cand - 1 + tid;
        s_pos[tid] = t >= 0 && t < a.T ? __ldg(a.token_pos + t) : -2;
      }
      if (tid == 0) s_cut = 0ull;
      __syncthreads();
      const int p0 = s_pos[1];
      int m = min(TQ - p0 % TQ, a.T - cand);  // the run: consecutive positions up to a cut
      for (int i = 1; i < m; ++i)
        if (s_pos[i + 1] != p0 + i) m = i;
      for (int f = tid; f < (m - 1) * a.MB; f += kThreads) {
        const int i = 1 + f / a.MB, jj = f - (f / a.MB) * a.MB;
        if (jj < n_blocks(p0 + i - 1, a.bs, a.MB) &&
            __ldg(a.tables + (size_t)(cand + i - 1) * a.MB + jj) !=
                __ldg(a.tables + (size_t)(cand + i) * a.MB + jj))
          atomicOr(&s_cut, 1ull << i);
      }
      __syncthreads();
      const unsigned long long cut = s_cut;
      for (int i0 = 0; i0 < m;) {
        int n = 1;
        while (i0 + n < m && !(cut >> (i0 + n) & 1ull)) ++n;
        tile_body<D>(a, smem, cand + i0, n, p0 + i0, kvh, c);
        i0 += n;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* tables,
                   const void* pos, void* out, void* ws, void* counts, int T, int H, int Hkv,
                   int bs, int MB, cudaStream_t stream) {
  const int NC = (MB * bs + kChunk - 1) / kChunk;
  if (NC > 1 && (ws == nullptr || counts == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = Cfg<D>::kSmem;
  static unsigned long long attr_set = 0;  // a bit per device: the opt-in is per context
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(attr_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(paged_tiled_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attr_set |= 1ull << dev;
  }
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.kc = static_cast<const uint16_t*>(kc);
  a.vc = static_cast<const uint16_t*>(vc);
  a.tables = static_cast<const int32_t*>(tables);
  a.token_pos = static_cast<const int32_t*>(pos);
  a.out = static_cast<uint16_t*>(out);
  a.ws = static_cast<float*>(ws);
  a.counts = static_cast<int32_t*>(counts);
  a.T = T, a.H = H, a.Hkv = Hkv, a.bs = bs, a.MB = MB, a.NC = NC;
  a.bs_shift = (bs & (bs - 1)) == 0 ? __builtin_ctz((unsigned)bs) : -1;
  a.scale_log2 = kLog2e / sqrtf((float)D);
  const long long items = (long long)T * Hkv * NC;
  if (items > 0x7fffffffll) return cudaErrorInvalidValue;
  const int P = items < kMaxBlocks ? (int)items : kMaxBlocks;
  paged_tiled_kernel<D><<<P, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tiled

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to contiguous
// tensors; the wrapper in ops/kernels/paged_attention.py checks shapes, types
// and alignment before calling. Returns cudaGetLastError() of the launch.
extern "C" int ds_paged_decode_attention_bf16(const void* q, const void* kc, const void* vc,
                                              const void* tables, const void* pos, void* out,
                                              int T, int H, int Hkv, int Dh, int bs, int MB,
                                              void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Dh % 8 != 0 || Dh <= 0 || Dh > 256 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (G == 1)
    err = launch<1>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else if (G == 2)
    err = launch<2>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else if (G <= 4)
    err = launch<4>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else
    err = launch<kMaxHeads>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  return (int)err;
}

// The tiled design's entry: Dh a multiple of 32 up to 256, G = H / Hkv 1-8,
// bs a multiple of 8. ws (fp32, T * H * chunks * (Dh + 2)) and counts
// (int32, T * Hkv, zero) are needed when MB * bs > 512 (more than one chunk),
// else may be null. Returns cudaGetLastError() of the launch.
extern "C" int ds_paged_attention_tiled_bf16(const void* q, const void* kc, const void* vc,
                                             const void* tables, const void* pos, void* out,
                                             void* ws, void* counts, int T, int H, int Hkv,
                                             int Dh, int bs, int MB, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 8 || bs <= 0 || bs % 8 != 0 || MB <= 0 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
#define DS_TILED(D) \
  case D:           \
    return (int)tiled::launch<D>(q, kc, vc, tables, pos, out, ws, counts, T, H, Hkv, bs, MB, s);
    DS_TILED(32) DS_TILED(64) DS_TILED(96) DS_TILED(128) DS_TILED(160) DS_TILED(192)
    DS_TILED(224) DS_TILED(256)
#undef DS_TILED
    default:
      return (int)cudaErrorInvalidValue;
  }
}
