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
// and its slot's slabs only. Each h[i][j] is summed by the block's 256
// threads over k = t, t + 256, ... in ascending k, combined by a fixed xor
// butterfly in each warp and then over the 8 warps in order; each output
// column sums j = 0 .. r-1 in order. The order is fixed by K and r alone:
// no split-K that depends on the batch, no atomics.
//
// What bounds it on an H100: bytes, and at decode the launch. A decode step
// (16 tokens, 8 adapters, r = 8, q_proj 4096 -> 4096) moves x 131 KB, the
// touched A and B slabs 524 KB each and y 262 KB both ways, ~0.43 us at
// 3.35 TB/s, below a launch; a 512-token prefill chunk ~13.6 MB, ~4.1 us.
//
// What the design does about that: one block per (16-row tile, 512
// columns), whose cost is a chain of trips to memory more than bytes or
// FMAs. The tile's count, slot and rows are read in one trip. Phase 1
// computes h[16, r] with fp32 FMAs on CUDA cores, all 256 threads splitting
// K for up to 32 / r rows at a time (a decode tile, whose rows are mostly
// padding, skips its empty passes and still has 256 threads loading), the
// loads of 32 / r k steps issued before their FMAs, A rows read as 16-byte
// vectors where r fills them; neighbouring threads read neighbouring rows
// of A and elements of x. Phase 2 reads B_g's column slice 8 ranks at a
// time and the live rows' y with the first 8, then writes y once. h is
// recomputed for each column tile (x and A_g come from L2 after the first).
// The work is small (~67 MFLOP at a 512-token chunk), so no tensor cores:
// an mma would round h to bf16, which is another result. Not done yet: a
// persistent schedule, sharing h across column tiles, and the host's cost
// of 4 x L launches a forward (a CUDA graph).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
