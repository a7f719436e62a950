// Segmented multi-tenant LoRA delta for Hopper (sm_90a): for every token t
// whose adapter slot g is not 0,
//   y[t, :] = round(y[t, :] + round(((x[t, :] @ A[g]) @ B[g]) * scale[g]))
// in x's type (bf16 or fp32), both products with fp32 operands and fp32
// sums: the rank-r intermediate h stays fp32 and is never rounded to bf16.
//
// Replaces the TPU kernel _lora_kernel of deepspeed_tpu/ops/pallas/lora_matmul.py
// (the `pl.pallas_call` in _lora_raw, behind lora_delta_pallas), and fuses
// what the JAX code does around it: the scale, the cast to x's type and the
// runner's `y + delta`. The rows are not gathered into a padded copy of x:
// the layout (ops/kernels/lora_matmul.py:lora_layout) gives each padded row
// its token, rows[p] (-1 for padding), and each 16-row tile its slot,
// tile_groups[tile]; the block reads x and writes y at those tokens. Tiles
// of slot 0 (base and pad tokens) and tiles at or past *used_tiles, which
// the layout writes on the device, return at once: they read no slab and
// leave y as the base projection computed it.
//
// Row independence, bit for bit: a row's result depends on its own x row
// and its slot's slabs only. In the first design each h[i][j] is summed by
// the block's 256 threads over k = t, t + 256, ... in ascending k, combined by a fixed xor
// butterfly in each warp and then over the 8 warps in order; each output
// column sums j = 0 .. r-1 in order (the mma design's orders are in its
// section). The order is fixed by K and r alone: no split-K that depends on
// the batch, no atomics.
//
// What bounds it on an H100: bytes, and at decode the launch. A decode step
// (16 tokens, 8 adapters, r = 8, q_proj 4096 -> 4096) moves x 131 KB, the
// touched A and B slabs 524 KB each and y 262 KB both ways, ~0.43 us at
// 3.35 TB/s, below a launch; a 512-token prefill chunk ~13.6 MB, ~4.1 us.
//
// Two designs, chosen by ops/kernels/lora_matmul.py's `lora_design` from the
// dtype, K, N, r and the operands' alignment: the mma design (below,
// lora_mma_kernel: bf16 with 16-byte rows, the serving path's), and the
// first design (lora_kernel: fp32, or what the mma design cannot read).
//
// What the first design does about the bound: one block per (16-row tile,
// 512 columns), whose cost is a chain of trips to memory more than bytes or
// FMAs. The tile's count, slot and rows are read in one trip. Phase 1
// computes h[16, r] with fp32 FMAs on CUDA cores, all 256 threads splitting
// K for up to 32 / r rows at a time (a decode tile, whose rows are mostly
// padding, skips its empty passes and still has 256 threads loading), the
// loads of 32 / r k steps issued before their FMAs, A rows read as 16-byte
// vectors where r fills them; neighbouring threads read neighbouring rows
// of A and elements of x. Phase 2 reads B_g's column slice 8 ranks at a
// time and the live rows' y with the first 8, then writes y once. h is
// recomputed for each column tile (x and A_g come from L2 after the first).
// Not done in either design: the host's cost of 4 x L launches a forward
// (a CUDA graph).

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int TM = 16;                // rows per tile (the layout's tm)
constexpr int TN = 512;               // output columns per block
constexpr int kCols = TN / kThreads;  // output columns per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// values of T in one 16-byte vector, and loading them as fp32
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

// One row of A (r values, r <= RB) as fp32 into out[0, RB), zeros past r.
template <typename T, int RB, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int r, float* out) {
  if constexpr (VEC) {
    constexpr int V = Vec<T>::V;
#pragma unroll
    for (int j0 = 0; j0 < RB; j0 += V) {
      if (j0 < r) {
        Vec<T>::load(p + j0, out + j0);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) out[j0 + e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < RB; ++j) out[j] = j < r ? to_f(p[j]) : 0.f;
  }
}

// RB: the rank bucket the registers are sized for (r <= RB). VEC: A's rows
// are whole 16-byte vectors (r a multiple of Vec<T>::V, A 16-byte aligned).
template <typename T, int RB, bool VEC>
__global__ void __launch_bounds__(kThreads)
    lora_kernel(const T* __restrict__ x, long long ldx, T* __restrict__ y, long long ldy,
                const T* __restrict__ A, const T* __restrict__ B,
                const float* __restrict__ scales, const int32_t* __restrict__ rows,
                const int32_t* __restrict__ tile_groups,
                const int32_t* __restrict__ used_tiles, int K, int N, int r) {
  const int tile = blockIdx.y;
  // the tile's count, slot and rows are read together: one trip to memory
  const int used = __ldg(used_tiles), g = __ldg(tile_groups + tile);
  const int my_row = threadIdx.x < TM ? __ldg(rows + tile * TM + threadIdx.x) : -1;
  if (tile >= used || g == 0) return;  // no rows, or base and pad rows: y stays as it is

  constexpr int RP = RB >= 32 ? 1 : 32 / RB;  // rows per pass: RP * RB fp32 sums a thread
  constexpr int U = RB >= 32 ? 1 : 32 / RB;   // k steps whose loads are issued together
  __shared__ int rs[TM];
  __shared__ float hs[TM * RB];
  __shared__ float red[kWarps * RP * RB];
  if (threadIdx.x < TM) rs[threadIdx.x] = my_row;
  __syncthreads();

  // phase 1: h[i][:] = x[rows[i]] @ A_g, RP rows at a time over all 256
  // threads: thread t sums k = t, t + 256, ... in ascending k, then a xor
  // butterfly within each warp and the 8 warps' sums in warp order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* Ag = A + (size_t)g * K * r;
  for (int i0 = 0; i0 < TM; i0 += RP) {
    int live = -1;
#pragma unroll
    for (int q = RP - 1; q >= 0; --q)
      if (rs[i0 + q] >= 0) live = rs[i0 + q];
    if (live < 0) continue;  // uniform over the block: rs is in shared memory
    // a pad row of the pass reads a live row's x: its sums are never written
    const T* xr[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q)
      xr[q] = x + (long long)(rs[i0 + q] >= 0 ? rs[i0 + q] : live) * ldx;
    float acc[RP][RB];
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[q][j] = 0.f;
    int k = threadIdx.x;
    for (; k + (U - 1) * kThreads < K; k += U * kThreads) {
      float xv[U][RP], av[U][RB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < RP; ++q) xv[u][q] = to_f(xr[q][k + u * kThreads]);
        load_row<T, RB, VEC>(Ag + (size_t)(k + u * kThreads) * r, r, av[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int j = 0; j < RB; ++j) acc[q][j] = fmaf(xv[u][q], av[u][j], acc[q][j]);
    }
    for (; k < K; k += kThreads) {  // the last k steps, when U does not divide them
      float xv[RP], av[RB];
#pragma unroll
      for (int q = 0; q < RP; ++q) xv[q] = to_f(xr[q][k]);
      load_row<T, RB, VEC>(Ag + (size_t)k * r, r, av);
#pragma unroll
      for (int q = 0; q < RP; ++q)
#pragma unroll
        for (int j = 0; j < RB; ++j) acc[q][j] = fmaf(xv[q], av[j], acc[q][j]);
    }
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        float v = acc[q][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[(warp * RP + q) * RB + j] = v;
      }
    __syncthreads();
    for (int o = threadIdx.x; o < RP * RB; o += kThreads) {
      float v = red[o];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w * RP * RB + o];
      hs[i0 * RB + o] = v;
    }
    __syncthreads();
  }

  // phase 2: y[rows[i], c] += round(h[i] @ B_g[:, c] * scale) for this
  // block's columns. B's rows come 8 at a time and the live rows' y with
  // the first 8, all loads issued before the FMAs: a rank-8 tile waits on
  // memory once.
  const T* Bg = B + (size_t)g * r * N;
  const int c0 = blockIdx.x * TN + threadIdx.x;
  float out[kCols][TM], yv[kCols][TM];
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int c = c0 + cc * kThreads;
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      out[cc][t] = 0.f;
      yv[cc][t] = rs[t] >= 0 && c < N ? to_f(y[(long long)rs[t] * ldy + c]) : 0.f;
    }
  }
#pragma unroll
  for (int j0 = 0; j0 < RB; j0 += 8) {
    if (j0 >= r) break;
    float bv[8][kCols];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int c = c0 + cc * kThreads;
        bv[e][cc] = j0 + e < r && c < N ? to_f(Bg[(size_t)(j0 + e) * N + c]) : 0.f;
      }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (j0 + e >= r) break;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
        for (int t = 0; t < TM; ++t)
          out[cc][t] = fmaf(hs[t * RB + j0 + e], bv[e][cc], out[cc][t]);
    }
  }
  const float s = __ldg(scales + g);
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int c = c0 + cc * kThreads;
    if (c >= N) continue;
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      if (rs[t] < 0) continue;
      const T d = from_f<T>(__fmul_rn(out[cc][t], s));
      y[(long long)rs[t] * ldy + c] = from_f<T>(__fadd_rn(yv[cc][t], to_f(d)));
    }
  }
}

template <typename T, int RB>
cudaError_t launch(const void* x, long long ldx, void* y, long long ldy, const void* a,
                   const void* b, const float* scales, const int32_t* rows,
                   const int32_t* tile_groups, const int32_t* used, int Mp, int K, int N,
                   int r, cudaStream_t st) {
  const dim3 grid((N + TN - 1) / TN, Mp / TM);
  const bool vec = r % Vec<T>::V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (vec)
    lora_kernel<T, RB, true><<<grid, kThreads, 0, st>>>(xp, ldx, yp, ldy, ap, bp, scales, rows,
                                                        tile_groups, used, K, N, r);
  else
    lora_kernel<T, RB, false><<<grid, kThreads, 0, st>>>(xp, ldx, yp, ldy, ap, bp, scales, rows,
                                                         tile_groups, used, K, N, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, long long ldx, void* y, long long ldy, const void* a,
                     const void* b, const float* scales, const int32_t* rows,
                     const int32_t* tile_groups, const int32_t* used, int Mp, int K, int N,
                     int r, cudaStream_t st) {
  if (r <= 8) return launch<T, 8>(x, ldx, y, ldy, a, b, scales, rows, tile_groups, used, Mp, K, N, r, st);
  if (r <= 16) return launch<T, 16>(x, ldx, y, ldy, a, b, scales, rows, tile_groups, used, Mp, K, N, r, st);
  if (r <= 32) return launch<T, 32>(x, ldx, y, ldy, a, b, scales, rows, tile_groups, used, Mp, K, N, r, st);
  return launch<T, 64>(x, ldx, y, ldy, a, b, scales, rows, tile_groups, used, Mp, K, N, r, st);
}

// ------------------------------------------------------------------ mma design
// bf16 x, y and slabs with 16-byte rows (the serving path's). A thread block
// cluster of CS blocks (CS = 1, 2, 4 or 8, by N alone) takes one 16-row
// tile; block b of it takes the b-th of CS equal column ranges. 256 threads.
//   phase 1: h[16, RB] = x_tile @ A_g on mma.sync.m16n8k16 (bf16 operands,
//     whose products are exact, fp32 sums: the first design's fp32 h). K is
//     cut by K alone into kSlices contiguous slices, each summed from zero by
//     one warp in 16-deep mma steps, 32 k of its rows of x and of A_g staged
//     at a time through the warp's own cp.async ring (ldmatrix, .trans for
//     A_g). The cluster's blocks share the slices (16 / CS each), so x and
//     A_g are read once a tile, and every block adds all kSlices partials in
//     slice order, reading the others' through distributed shared memory.
//   phase 2: as the first design's, on CUDA cores: each output sums
//     h[i][j] B_g[j][c] over j in order with fp32 FMAs, then
//     y = round(y + round(sum * scale)); a thread owns 8 columns (16-byte
//     vectors of y and B_g) of 4 rows, B_g's rows 8 at a time.
// A row's h and delta depend on its own x row, its slot's slabs and K only.
constexpr int kSlices = 16;      // the K cut: K / kSlices a slice
constexpr int kStep = 32;        // k a warp stages at a time
constexpr int LDX = kStep + 8;   // padded x rows in shared memory (bf16)
constexpr int kMaxCluster = 8;

template <int RB>
struct MmaCfg {
  static constexpr int LDA = RB + ((RB / 8) % 2 == 0 ? 8 : 0);  // odd 16-byte units
  static constexpr int kStages = RB <= 16 ? 6 : 2;
  static constexpr int kStageElems = TM * LDX + kStep * LDA;     // bf16 a stage
  // a ring for each warp that sums slices (min(8, 16 / CS) of them), then the
  // block's slices' partial h [16 / CS][TM][RB] fp32
  static __host__ __device__ size_t ring(int cs) {
    const int w = kSlices / cs < kWarps ? kSlices / cs : kWarps;
    return sizeof(uint16_t) * (size_t)w * kStages * kStageElems;
  }
  static __host__ __device__ size_t smem(int cs) { return ring(cs) + sizeof(float) * (size_t)(kSlices / cs) * TM * RB; }
};

// CS for N: about 512 columns a block, a power of two up to kMaxCluster
inline int cluster_size(int N) {
  int cs = 1;
  while (cs < kMaxCluster && cs * 512 < N) cs *= 2;
  return cs;
}

template <int RB>
__global__ void __launch_bounds__(kThreads)
    lora_mma_kernel(const uint16_t* __restrict__ x, long long ldx, uint16_t* __restrict__ y,
                    long long ldy, const uint16_t* __restrict__ A,
                    const uint16_t* __restrict__ B, const float* __restrict__ scales,
                    const int32_t* __restrict__ rows, const int32_t* __restrict__ tile_groups,
                    const int32_t* __restrict__ used_tiles, int K, int N, int r) {
  using C = MmaCfg<RB>;
  constexpr int LDA = C::LDA, S = C::kStages;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int rs[TM];
  __shared__ float hs[TM * RB];
  const int tile = blockIdx.y;
  const int used = __ldg(used_tiles), g = __ldg(tile_groups + tile);
  const int my_row = threadIdx.x < TM ? __ldg(rows + tile * TM + threadIdx.x) : -1;
  // uniform over the cluster (one tile): no rows, or base and pad rows
  if (tile >= used || g == 0) return;
  if (threadIdx.x < TM) rs[threadIdx.x] = my_row;
  __syncthreads();

  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int span = ((N + CS - 1) / CS + 7) / 8 * 8;  // columns a block, whole 16-byte groups
  const int c_begin = rank * span, c_end = min(N, c_begin + span);
  const uint16_t* Bg = B + (size_t)g * r * N;
  // phase 2's y rows and B_g rows into L2 while phase 1 runs (128-byte lines)
  for (int i = threadIdx.x; i < (TM + r) * ((span + 63) / 64); i += kThreads) {
    const int row = i / ((span + 63) / 64), c = c_begin + (i % ((span + 63) / 64)) * 64;
    if (c >= c_end) continue;
    const uint16_t* line = row < TM ? (rs[row] >= 0 ? y + (long long)rs[row] * ldy + c : nullptr)
                                    : Bg + (size_t)(row - TM) * N + c;
    if (line != nullptr) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
  }

  // phase 1: this block's slices rank L .. rank L + L - 1, warp w taking w, w + 8
  const int L = kSlices / CS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_raw) + (size_t)warp * S * C::kStageElems;
  float* hpart = reinterpret_cast<float*>(smem_raw + C::ring(CS));  // [L][TM][RB]
  const uint16_t* Ag = A + (size_t)g * K * r;
  const int slice = K / kSlices, steps = slice / kStep;
  for (int ls = warp; ls < L; ls += kWarps) {
    const int k_begin = (rank * L + ls) * slice;
    auto load = [&](int st) {
      uint16_t* sX = ring + (st % S) * C::kStageElems;
      uint16_t* sA = sX + TM * LDX;
      const int k0 = k_begin + st * kStep;
      // x: 16 rows x 32 k = 64 chunks of 16 bytes; pad rows read as zeros
      for (int i = lane; i < TM * (kStep / 8); i += 32) {
        const int row = i / (kStep / 8), ch = i % (kStep / 8);
        const int src_row = rs[row];
        cp_async16(sX + row * LDX + ch * 8,
                   x + (long long)max(src_row, 0) * ldx + k0 + ch * 8, src_row >= 0);
      }
      // A_g: 32 k rows of RB columns, zeros past r
      for (int i = lane; i < kStep * (RB / 8); i += 32) {
        const int kr = i / (RB / 8), ch = i % (RB / 8);
        const bool live = ch * 8 < r;
        cp_async16(sA + kr * LDA + ch * 8, Ag + (size_t)(k0 + kr) * r + (live ? ch * 8 : 0),
                   live);
      }
    };
    float hacc[RB / 8][4];
#pragma unroll
    for (int j = 0; j < RB / 8; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
    __syncwarp();  // the ring's last readers of the previous slice are done
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < steps) load(st);
      cp_commit();
    }
    for (int st = 0; st < steps; ++st) {
      cp_wait<S - 2>();
      __syncwarp();  // stage st landed for every lane; stage st - 1 is free
      if (st + S - 1 < steps) load(st + S - 1);
      cp_commit();
      const uint16_t* sX = ring + (st % S) * C::kStageElems;
      const uint16_t* sA = sX + TM * LDX;
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sX + ((mi & 1) * 8 + rr) * LDX + kk * 16 + (mi >> 1) * 8);
        if constexpr (RB == 8) {
          uint32_t b[2];
          ldsm_x2_t(b, sA + (kk * 16 + (mi & 1) * 8 + rr) * LDA);
          mma16816(hacc[0], a, b[0], b[1]);
        } else {
#pragma unroll
          for (int np = 0; np < RB / 16; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, sA + (kk * 16 + (mi & 1) * 8 + rr) * LDA + np * 16 + (mi >> 1) * 8);
            mma16816(hacc[2 * np], a, b[0], b[1]);
            mma16816(hacc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_wait<0>();
    const int gr = lane >> 2, tq = lane & 3;
    float* hp = hpart + ls * TM * RB;
#pragma unroll
    for (int j = 0; j < RB / 8; ++j) {
      hp[gr * RB + j * 8 + tq * 2] = hacc[j][0];
      hp[gr * RB + j * 8 + tq * 2 + 1] = hacc[j][1];
      hp[(gr + 8) * RB + j * 8 + tq * 2] = hacc[j][2];
      hp[(gr + 8) * RB + j * 8 + tq * 2 + 1] = hacc[j][3];
    }
  }
  cluster.sync();  // every block's partials are stored
  for (int o = threadIdx.x; o < TM * RB; o += kThreads) {
    float v = 0.f;
#pragma unroll 4
    for (int sl = 0; sl < kSlices; ++sl) {
      const float* src = cluster.map_shared_rank(hpart, sl / L) + (sl % L) * TM * RB + o;
      v = sl == 0 ? *src : v + *src;
    }
    hs[o] = v;
  }
  __syncthreads();

  // phase 2: this block's columns, thread (column group cg of 8, rows 4 q .. 4 q + 3)
  const float s = __ldg(scales + g);
  const int groups = span / 8;
  for (int item = threadIdx.x; item < groups * (TM / 4); item += kThreads) {
    const int q4 = item / groups, c = c_begin + (item - q4 * groups) * 8;
    if (c >= c_end) continue;
    float out[4][8], yv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = rs[q4 * 4 + i];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[i][e] = 0.f;
      if (t >= 0) {  // a plain load: this kernel writes y
        const uint4 u = *reinterpret_cast<const uint4*>(y + (long long)t * ldy + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          yv[i][2 * e] = f.x;
          yv[i][2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) yv[i][e] = 0.f;
      }
    }
    for (int j0 = 0; j0 < r; j0 += 8) {  // r % 8 == 0: B's 8 rows loaded before their FMAs
      float bv[8][8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        Vec<__nv_bfloat16>::load(
            reinterpret_cast<const __nv_bfloat16*>(Bg + (size_t)(j0 + e) * N + c), bv[e]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h = hs[(q4 * 4 + i) * RB + j0 + e];
#pragma unroll
          for (int q = 0; q < 8; ++q) out[i][q] = fmaf(h, bv[e][q], out[i][q]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = rs[q4 * 4 + i];
      if (t < 0) continue;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 d0 = __float2bfloat16_rn(__fmul_rn(out[i][2 * e], s));
        const __nv_bfloat16 d1 = __float2bfloat16_rn(__fmul_rn(out[i][2 * e + 1], s));
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            __fadd_rn(yv[i][2 * e], __bfloat162float(d0)),
            __fadd_rn(yv[i][2 * e + 1], __bfloat162float(d1)));
        w[e] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(y + (long long)t * ldy + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cluster.sync();  // the other blocks have read this block's partials
}

template <int RB>
cudaError_t launch_mma(const void* x, long long ldx, void* y, long long ldy, const void* a,
                       const void* b, const float* scales, const int32_t* rows,
                       const int32_t* tile_groups, const int32_t* used, int Mp, int K, int N,
                       int r, cudaStream_t st) {
  const int cs = cluster_size(N);
  const size_t smem = MmaCfg<RB>::smem(cs);
  static unsigned long long attr_set = 0;  // a bit per device: the opt-in is per context
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(attr_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(lora_mma_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MmaCfg<RB>::smem(1));
    if (err != cudaSuccess) return err;
    if (dev < 64) attr_set |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, Mp / TM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_mma_kernel<RB>, static_cast<const uint16_t*>(x), ldx,
                           static_cast<uint16_t*>(y), ldy, static_cast<const uint16_t*>(a),
                           static_cast<const uint16_t*>(b), scales, rows, tile_groups, used, K,
                           N, r);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Device pointers: x [T, K] with row stride ldx
// and y [T, N] with row stride ldy (unit column stride), of dtype 0 (bf16)
// or 1 (fp32); one layer's slabs a [S, K, r] and b [S, r, N], contiguous,
// of the same dtype; scales fp32 [S]; rows int32 [Mp]; tile_groups int32
// [Mp / tm]; used_tiles int32 [1]. tm must be 16 and r 1-64. The wrapper
// in ops/kernels/lora_matmul.py checks shapes and types. y is updated in
// place. Returns cudaGetLastError() of the launch.
extern "C" int ds_lora_delta(const void* x, long long ldx, void* y, long long ldy,
                             const void* a, const void* b, const void* scales,
                             const void* rows, const void* tile_groups,
                             const void* used_tiles, int Mp, int K, int N, int r, int dtype,
                             int tm, void* stream) {
  if (tm != TM || r < 1 || r > kMaxRank || K < 1 || N < 1 || Mp < TM || Mp % TM != 0 ||
      Mp / TM > 65535 || ldx < K || ldy < N || (dtype != 0 && dtype != 1) ||
      x == nullptr || y == nullptr || a == nullptr || b == nullptr || scales == nullptr ||
      rows == nullptr || tile_groups == nullptr || used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  const int32_t* tg = static_cast<const int32_t*>(tile_groups);
  const int32_t* used = static_cast<const int32_t*>(used_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<__nv_bfloat16>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
  return (int)dispatch<float>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
}

// The mma design's entry (bf16 only): K a multiple of 512, N and r multiples
// of 8 (r <= 64), x, y, a and b 16-byte aligned with row strides ldx and
// ldy multiples of 8. Same arguments and result otherwise as ds_lora_delta.
extern "C" int ds_lora_delta_mma(const void* x, long long ldx, void* y, long long ldy,
                                 const void* a, const void* b, const void* scales,
                                 const void* rows, const void* tile_groups,
                                 const void* used_tiles, int Mp, int K, int N, int r, int tm,
                                 void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (tm != TM || r < 8 || r > kMaxRank || r % 8 || K < kSlices * kStep ||
      K % (kSlices * kStep) || N < 8 || N % 8 ||
      Mp < TM || Mp % TM != 0 || Mp / TM > 65535 || ldx < K || ldy < N || ldx % 8 || ldy % 8 ||
      x == nullptr || y == nullptr || a == nullptr || b == nullptr || scales == nullptr ||
      rows == nullptr || tile_groups == nullptr || used_tiles == nullptr || misaligned(x) ||
      misaligned(y) || misaligned(a) || misaligned(b))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  const int32_t* tg = static_cast<const int32_t*>(tile_groups);
  const int32_t* used = static_cast<const int32_t*>(used_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 8) return (int)launch_mma<8>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
  if (r <= 16) return (int)launch_mma<16>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
  if (r <= 32) return (int)launch_mma<32>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
  return (int)launch_mma<64>(x, ldx, y, ldy, a, b, sc, rw, tg, used, Mp, K, N, r, st);
}
