// The TMA-fed wgmma designs of the forward through a weight [K][N] (bf16,
// or grouped quantized carriers decoded into bf16 in shared memory) and of
// K5's input gradient, shared by grouped_matmul.cu (K5: an expert stack and
// a work list built from the routing) and fused_quant_matmul.cu (K4: one
// weight, ONE_W below, its work fixed by the row count on the host, its K
// loop optionally split over blocks whose fp32 partials the last block of
// each output tile to arrive adds in split order). grouped_matmul.cu's
// header note says what bounds each design and why it is built so.

#pragma once

#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "quant_gemm.cuh"

namespace {

using namespace qgemm;

// ---------------------------------------------------------------------------
// gmm_wgmma_kernel: the Hopper design of the forward (FWD: out = x @ W[e],
// a bf16 stack or carriers) and of dx (out = dy @ W[e]^T, a bf16 stack or
// carriers); grouped_matmul.cu's notes say why. One template, so that the two share
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
  // one weight (K4, no plan): block b takes item b % items (128 rows each),
  // column block b / items % cols and split b / (items cols) of `splits`,
  // each split_steps steps of K long; with splits > 1 the splits' fp32 sums
  // go to partial [splits][Mp][N], and arrivals (zero before the launch,
  // zero again after it) counts the splits stored of each (item, column
  // block, consumer warpgroup)
  int items, splits, split_steps;
  float* partial;
  int32_t* arrivals;
};

// The last of an output tile's splits to arrive adds the splits' partials in
// split order (s = 0, then s += p[0], p[1], ...: reduce_splits_kernel's
// order) and writes bf16, then zeroes the tile's arrival count for the next
// launch. Called by the 128 threads of one consumer warpgroup (thread t,
// named barrier `bar`, flag `slot`) once their partials of rows r0 .. r1 - 1
// and columns n0 .. n1 - 1 are stored. Four columns a load (the designs'
// N, n0 and n1 are multiples of 4: TMA's 16-byte rows), and SU x SZ loads
// issued before the first add: one thread's loads are dependent round
// trips to L2 otherwise, and they set the pace of the whole launch.
constexpr int SU = 4, SZ = 4;

__device__ __forceinline__ void finish_split(const RingArgs& a, int idx, int r0, int r1, int n0,
                                             int n1, int bar, int slot, int t) {
  __shared__ int last[2];
  __threadfence();  // this thread's partials, before the arrival
  hopper::named_sync(bar, 128);
  if (t == 0) last[slot] = atomicAdd(a.arrivals + idx, 1) == a.splits - 1;
  hopper::named_sync(bar, 128);
  if (!last[slot]) return;
  __threadfence();  // the other splits' partials, after their arrivals
  const size_t plane = (size_t)a.Mp * a.N;
  const int quads = (n1 - n0) / 4, total = (r1 - r0) * quads;
  for (int i0 = t; i0 < total; i0 += 128 * SU) {
    size_t o[SU];
    float4 s[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int i = min(i0 + 128 * u, total - 1);  // past the end: a repeat, not stored
      o[u] = (size_t)(r0 + i / quads) * a.N + n0 + 4 * (i % quads);
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int z0 = 0; z0 < a.splits; z0 += SZ) {
      float4 p[SU][SZ];
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int j = 0; j < SZ; ++j)
          if (z0 + j < a.splits)
            p[u][j] = __ldcg(reinterpret_cast<const float4*>(a.partial + (z0 + j) * plane + o[u]));
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int j = 0; j < SZ; ++j)
          if (z0 + j < a.splits) {
            s[u].x += p[u][j].x, s[u].y += p[u][j].y;
            s[u].z += p[u][j].z, s[u].w += p[u][j].w;
          }
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (i0 + 128 * u < total)
        *reinterpret_cast<uint2*>(a.out + o[u]) =
            make_uint2(pack_bf16(s[u].x, s[u].y), pack_bf16(s[u].z, s[u].w));
  }
  if (t == 0) a.arrivals[idx] = 0;
}

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
// them. MODE 1: the 64 columns share the scale `sc` (a group width that is
// a multiple of 64; 0 past K or N); MODE 2 (a group width of 64 or more,
// not a multiple of 64: at most one group boundary among the 64 columns)
// `sc` before column nb and `sc2` from it (0 past N); MODE 0 one scale an
// element from `srow` (the row's scales, null past K).
template <int S, int MODE>
__device__ __forceinline__ void decode_fwd_stage(const uint8_t* raw, uint8_t* dec, int2 task,
                                                 float sc, float sc2, int nb, const float* srow,
                                                 int n0, int N, int g) {
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
      if constexpr (MODE == 1) {
        v[u] *= sc;
      } else if constexpr (MODE == 2) {
        v[u] *= 16 * t + u < nb ? sc : sc2;
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
// i (null past K), and its scales in groups grp and grp2 (-1: columns past
// N, scale 0), the row pointer stepped by 64 ng a step: one multiply-add
// and a load a scale a step, no division in the loop (which cost an H100
// ~7% at decode). Its 64 columns from n0 lie in group grp before column nb
// and in grp2 from it (a group width of 64 or more: at most two groups).
struct FwdScales {
  const float* base;    // row fk
  size_t step;          // 64 ng
  int rows, grp, grp2;  // steps i with 64 i < rows lie within K
  int nb;
  __device__ __forceinline__ FwdScales(const float* scales, int e, int K, int ng, int fk, int n0,
                                       int N, int g)
      : base(scales + ((size_t)e * K + fk) * ng),
        step((size_t)RING_STEP * ng),
        rows(K - fk),
        grp(n0 < N ? n0 / g : -1),
        grp2(-1),
        nb(RING_STEP) {
    if (grp >= 0 && (grp + 1) * g < n0 + RING_STEP) {
      nb = (grp + 1) * g - n0;
      if ((grp + 1) * g < N) grp2 = grp + 1;  // else the columns from nb lie past N
    }
  }
  __device__ __forceinline__ const float* row(int i) const {
    return i * RING_STEP < rows ? base + i * step : nullptr;
  }
  __device__ __forceinline__ float scale(int i) const {
    return grp >= 0 && i * RING_STEP < rows ? __ldg(base + i * step + grp) : 0.f;
  }
  __device__ __forceinline__ float scale2(int i) const {
    return grp2 >= 0 && i * RING_STEP < rows ? __ldg(base + i * step + grp2) : 0.f;
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

// the NA accumulators of a consumer warpgroup (NA / 2 columns: 8-column
// block j in acc[4j .. 4j + 3]), rounded once to bf16 (T uint16_t) or kept
// in fp32 (T float, a split's partial sums), into rows r0 + (its rows) and
// columns c0 + (its columns) of a [.][width] output, rows at or past r_end
// and columns at or past width not written
template <int NA, typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[NA], T* out, int width, int r0,
                                          int r_end, int c0) {
  const int lane = threadIdx.x & 31;
  const int rl = r0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);  // row of acc[4j]
  const bool pairs = (width & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < NA / 4; ++jn) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, col = c0 + 8 * jn + 2 * (lane & 3);
      if (r >= r_end || col >= width) continue;
      T* dst = out + (size_t)r * width + col;
      const float lo = acc[4 * jn + 2 * h], hi = acc[4 * jn + 2 * h + 1];
      if constexpr (std::is_same<T, float>::value) {
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          dst[0] = lo;
          if (col + 1 < width) dst[1] = hi;
        }
      } else if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
      } else {
        dst[0] = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
        if (col + 1 < width) dst[1] = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
      }
    }
  }
}

// A block's work: the item (rows row0 .. row0 + rows - 1 of expert e), the
// column block from c0 and, for one weight (ONE_W), the split z. With a plan
// (K5) the blocks of a group (the items of one run of an expert's tiles, or
// the zero fill) take its column blocks in turn, its items fastest, and a
// block of the zero fill writes its zeros here (→ false: nothing more to
// do). Values every thread of a warp holds are broadcast from lane 0, so
// that ptxas sees the branches they take as warp-uniform: wgmma in a path
// it must treat as divergent is serialized.
struct Work {
  int item, c0, z, row0, rows, e;
};

template <bool ONE_W>
__device__ __forceinline__ bool find_work(const RingArgs& a, int width, Work& w) {
  if constexpr (ONE_W) {
    const int b = (int)blockIdx.x;
    w.item = b % a.items;
    w.c0 = b / a.items % a.cols * RING_COLS;
    w.z = b / (a.items * a.cols);
    w.row0 = w.item * RING_ROWS;
    w.rows = min(RING_ROWS, a.Mp - w.row0);
    w.e = 0;
    return true;
  } else {
    const int32_t* grp = a.plan + (size_t)(blockIdx.x / a.cols) * PLAN_FIELDS;
    const int first = __shfl_sync(~0u, grp[3], 0), count = __shfl_sync(~0u, grp[4], 0);
    const int local = (int)blockIdx.x - first * a.cols;
    w.item = first + local % count, w.c0 = local / count * RING_COLS, w.z = 0;
    const int32_t* work = a.plan + (size_t)w.item * PLAN_FIELDS;
    w.row0 = __shfl_sync(~0u, work[0], 0), w.rows = __shfl_sync(~0u, work[1], 0);
    w.e = __shfl_sync(~0u, work[2], 0);
    if (w.e >= 0 && w.e < a.E) return true;
    // rows with no expert, or the rows past the used tiles: zeros
    if (w.rows > 0) {
      zero_rows(a.out, width, w.row0, w.row0 + w.rows, w.c0);
    } else {
      for (int r = w.row0 + RING_ROWS * (w.item - first); r < a.Mp; r += RING_ROWS * count)
        zero_rows(a.out, width, r, min(r + RING_ROWS, a.Mp), w.c0);
    }
    return false;
  }
}

// the K steps of a block: all of them, or its split's (ONE_W) → (first, count)
template <bool ONE_W>
__device__ __forceinline__ int2 split_steps(const RingArgs& a, int depth, int z) {
  const int steps = (depth + RING_STEP - 1) / RING_STEP;
  if constexpr (ONE_W) return make_int2(z * a.split_steps, min(a.split_steps, steps - z * a.split_steps));
  return make_int2(0, steps);
}

template <int S, bool FWD, bool ONE_W>
__device__ __forceinline__ void ring_body(const CUtensorMap& map_a, const CUtensorMap& map_w,
                                          const RingArgs& a) {
  using L = RingSmem<S>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int width = FWD ? a.N : a.K, depth = FWD ? a.K : a.N;  // out columns, contraction
  Work wk;
  if (!find_work<ONE_W>(a, width, wk)) return;
  const int item = wk.item, c0 = wk.c0, row0 = wk.row0, rows = wk.rows, e = wk.e;

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                          // x / dy tiles [128 rows][64], 128-byte swizzle
  uint8_t* sW = sA + RING_STAGES * L::kA;      // W tiles as stored (carrier stages: see above)
  uint8_t* sDec = sW + RING_STAGES * L::kRaw;  // carriers decoded: bf16, 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + RING_STAGES;
  const int2 range = split_steps<ONE_W>(a, depth, wk.z);
  const int i0 = range.x, steps = range.y;  // the block's K steps: i0 + (0 .. steps - 1)
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
        const int s = i % RING_STAGES, k0 = (i0 + i) * RING_STEP;
        hopper::mbar_wait(&empty[s], ((i / RING_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kA + w_bytes);
        hopper::tma_load_2d(sA + s * L::kA, &map_a, &full[s], k0, row0);
        if constexpr (FWD && S != kBF16) {
          if (c0 == 0) prefetch_scales(a.scales, e, a.K, a.ng, k0);
        }
        if constexpr (FWD) {
          for (int j = 0; j < boxes; ++j)
            hopper::tma_load_3d(sW + s * L::kRaw + j * RING_BOX, &map_w, &full[s],
                                S == kBF16 ? c0 + 64 * j : S == kFP6 ? c0 / 4 * 3 : c0 + 128 * j,
                                k0, e);
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
  // scale a step with a group width of a multiple of 64, two from 64 on.
  const int c = ct & 3;
  const bool one_scale = a.g % (FWD ? 64 : 16) == 0;
  const bool two_scales = ONE_W && FWD && !one_scale && a.g >= RING_STEP;
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
  const FwdScales fs(a.scales, e, a.K, a.ng, fk, fn, a.N, a.g);
  auto fwd_srow = [&](int i) { return fs.row(i0 + i); };
  auto fwd_scale = [&](int i) { return fs.scale(i0 + i); };
  auto fwd_scale2 = [&](int i) { return fs.scale2(i0 + i); };
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
    if (one_scale || two_scales) {
      if constexpr (FWD) {  // the forward's rows change every step: no group to hold
        sc_even[0] = fwd_scale(0), sc_even[1] = fwd_scale2(0);
        sc_odd[0] = fwd_scale(1), sc_odd[1] = fwd_scale2(1);
      } else {
        row_scales(16 * c, sc_even, grp_even);
        row_scales(RING_STEP + 16 * c, sc_odd, grp_odd);
      }
    }
  }

  // The step loop, with or without the wgmma (an idle consumer still
  // decodes its half of each carrier tile and releases each stage), and
  // with one scale a row and step (row_scale 1), two (2, the forward) or
  // one an element (0): separate copies, so
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
          decode_fwd_stage<S, decltype(row_scale)::value>(raw, dec, task, sc[0], sc[1], fs.nb,
                                                          fwd_srow(i), fn, a.N, a.g);
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
          if constexpr (FWD) {
            sc[0] = fwd_scale(i + 2);
            if constexpr (decltype(row_scale)::value == 2) sc[1] = fwd_scale2(i + 2);
          } else {
            row_scales((i + 2) * RING_STEP + 16 * c, sc, held);
          }
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
    using One = std::integral_constant<int, 1>;
    if (S == kBF16 || one_scale) {
      consume(mma, One{});
      return;
    }
    if constexpr (ONE_W && FWD && S != kBF16) {  // K4's head: a group width of 500
      if (two_scales) {
        consume(mma, std::integral_constant<int, 2>{});
        return;
      }
    }
    consume(mma, std::integral_constant<int, 0>{});
  };
  if (!active) {
    run(std::false_type{});
    return;
  }
  run(std::true_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if constexpr (ONE_W) {
    if (a.splits > 1) {  // this split's fp32 sums; the tile's last split adds them up
      store_acc(acc, a.partial + (size_t)wk.z * a.Mp * a.N + (size_t)row0 * width, width,
                64 * cw, rows, c0);
      finish_split(a, (item * a.cols + c0 / RING_COLS) * 2 + cw, row0 + 64 * cw,
                   row0 + min(rows, 64 * cw + 64), c0, min(a.N, c0 + RING_COLS), 2 + cw, cw,
                   ct & 127);
      return;
    }
  }
  store_acc(acc, a.out + (size_t)row0 * width, width, 64 * cw, rows, c0);
}

template <int S, bool FWD>
__global__ void __launch_bounds__(RING_THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  ring_body<S, FWD, false>(map_a, map_w, a);
}

// ---------------------------------------------------------------------------
// gmm_stream_kernel: the decode design of the forward through carriers
// (16-row tiles; grouped_matmul.cu's note says why). A block owns one work item (up
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

// S = kBF16 (K4's dense_matmul): the producer lands the weight's four
// [64 K][64 N] bf16 boxes as TMA gives the bf16 forward ring its stage, and
// the consumers multiply them as they are, with no decode and no barrier.
template <int S, bool ONE_W>
__device__ __forceinline__ void stream_body(const CUtensorMap& map_x, const CUtensorMap& map_w,
                                            const RingArgs& a) {
  using L = RingSmem<S>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  Work wk;  // the item and column block (and split), as ring_body takes them
  if (!find_work<ONE_W>(a, a.N, wk)) return;
  const int item = wk.item, c0 = wk.c0, row0 = wk.row0, rows = wk.rows, e = wk.e;

  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;                          // x tiles [16 NT rows][64 K], 128-byte swizzle
  uint8_t* sW = sA + RING_STAGES * L::kA;      // carrier stages as TMA lands them
  uint8_t* sDec = sW + RING_STAGES * L::kRaw;  // decoded: four MN-major bf16 boxes a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + RING_STAGES;
  const int2 range = split_steps<ONE_W>(a, a.K, wk.z);
  const int i0 = range.x, steps = range.y;  // the block's K steps: i0 + (0 .. steps - 1)
  const int tiles = (rows + 15) / 16;       // the item's x tiles: 1 .. 8
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
      // a box wholly past N is not read (its columns are not stored)
      const int boxes = S == kBF16 ? min(4, (a.N - c0 + 63) / 64)
                        : S == kFP6 ? 1 : min(2, (a.N - c0 + 127) / 128);
      const int w_bytes = S == kFP6 ? L::kRaw : boxes * RING_BOX;
      for (int i = 0; i < steps; ++i) {
        const int s = i % RING_STAGES, k0 = (i0 + i) * RING_STEP;
        hopper::mbar_wait(&empty[s], ((i / RING_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], tiles * 2048 + w_bytes);
        if constexpr (S != kBF16) prefetch_scales(a.scales, e, a.K, a.ng, k0);
        for (int t = 0; t < tiles; ++t)
          hopper::tma_load_2d(sA + s * L::kA + t * 2048, &map_x, &full[s], k0, row0 + 16 * t);
        for (int j = 0; j < boxes; ++j)
          hopper::tma_load_3d(sW + s * L::kRaw + j * RING_BOX, &map_w, &full[s],
                              S == kBF16 ? c0 + 64 * j : S == kFP6 ? c0 / 4 * 3 : c0 + 128 * j,
                              k0, e);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1, ct = tid - 128;  // consumer cw decodes and multiplies boxes 2 cw, 2 cw + 1
  const int2 task = fwd_task<true>(ct);
  const int fk = task.x, fn = c0 + 64 * task.y;
  const FwdScales fs(a.scales, e, a.K, a.ng, fk, fn, a.N, a.g);
  auto srow = [&](int i) { return fs.row(i0 + i); };
  auto row_scales = [&](auto mode, int i) {  // MODE 1: the one scale; 2: both
    if constexpr (decltype(mode)::value == 2)
      return make_float2(fs.scale(i0 + i), fs.scale2(i0 + i));
    else
      return fs.scale(i0 + i);
  };
  const int nt = __shfl_sync(~0u, tiles <= 1 ? 1 : tiles <= 2 ? 2 : tiles <= 4 ? 4 : 8, 0);

  // The ring with NT x tiles and one scale a row and step (MODE 1), two (2)
  // or one an element (0): separate copies, so that no branch sits around
  // the wgmma in the loop and the decode has none.
  auto run = [&](auto nt_c, auto mode) {
    constexpr int NT = decltype(nt_c)::value;
    constexpr int MODE = decltype(mode)::value;
    float acc[2][8 * NT];  // the first step's first wgmma overwrites them
    using Sc = std::conditional_t<MODE == 2, float2, float>;
    Sc sc_even{}, sc_odd{};
    if constexpr (MODE != 0) sc_even = row_scales(mode, 0), sc_odd = row_scales(mode, 1);
    auto step = [&](int i, Sc& sc) {
      const int s = i % RING_STAGES;
      hopper::mbar_wait(&full[s], (i / RING_STAGES) & 1);
      uint32_t boxes = hopper::smem_addr(sW + s * L::kRaw);  // bf16: the stage as TMA landed it
      if constexpr (S != kBF16) {
        uint8_t* dec = sDec + (i % 3) * L::kB;
        if constexpr (MODE == 2)
          decode_fwd_stage<S, 2>(sW + s * L::kRaw, dec, task, sc.x, sc.y, fs.nb, srow(i), fn,
                                 a.N, a.g);
        else
          decode_fwd_stage<S, MODE>(sW + s * L::kRaw, dec, task, sc, 0.f, RING_STEP, srow(i),
                                    fn, a.N, a.g);
        hopper::fence_proxy_async();
        hopper::named_sync(1 + cw, 128);
        boxes = hopper::smem_addr(dec);
      }
      const uint64_t db = hopper::sw128_desc(hopper::smem_addr(sA + s * L::kA));
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        // A: 64 N of one decoded box, MN-major, a 16-deep slice 2048 bytes
        // on; B: the x tiles, K-major, a slice 32 bytes on
        const uint64_t da = hopper::sw128_mn_desc(boxes + (2 * cw + bb) * RING_BOX, RING_BOX);
#pragma unroll
        for (int kk = 0; kk < RING_STEP / 16; ++kk)
          wgmma_m64n16xk16<NT, 1, 0>(acc[bb], da + 128 * kk, db + 2 * kk, i > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if constexpr (MODE != 0) {  // this set's next scales, two steps on, read while the wgmma runs
        if (i + 2 < steps) sc = row_scales(mode, i + 2);
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
    // (w the warp within the warpgroup), x row 8 j + 2 (lane % 4) + q; a
    // split of one weight's K stores its fp32 sums, and its tile's last split
    // adds them up
    const int lane = tid & 31, wq = (tid & 127) >> 5;
    const bool split = ONE_W && a.splits > 1;
    float* part = split ? a.partial + (size_t)wk.z * a.Mp * a.N : nullptr;
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
            const size_t o = (size_t)(row0 + r) * a.N + n;
            const float v = acc[bb][4 * j + 2 * h + q];
            if (split) part[o] = v;
            else a.out[o] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
        }
      }
    }
    if (split)
      finish_split(a, (item * a.cols + c0 / RING_COLS) * 2 + cw, row0, row0 + rows,
                   min(a.N, c0 + 128 * cw), min(a.N, c0 + 128 * cw + 128), 1 + cw, cw, tid & 127);
  };
  auto by_scale = [&](auto nt_c) {
    using Mode0 = std::integral_constant<int, 0>;
    if constexpr (S == kBF16) run(nt_c, Mode0{});  // no scales to read
    else if (a.g % 64 == 0) run(nt_c, std::integral_constant<int, 1>{});
    else if (ONE_W && a.g >= 64) run(nt_c, std::integral_constant<int, 2 * ONE_W>{});
    else run(nt_c, Mode0{});
  };
  if (nt == 1) by_scale(std::integral_constant<int, 1>{});
  else if (nt == 2) by_scale(std::integral_constant<int, 2>{});
  else if (nt == 4) by_scale(std::integral_constant<int, 4>{});
  else by_scale(std::integral_constant<int, 8>{});
}

template <int S>
__global__ void __launch_bounds__(RING_THREADS, 1)
    gmm_stream_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  stream_body<S, false>(map_x, map_w, a);
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


}  // namespace
