// wgmma building blocks shared by the attention kernels' Hopper designs
// (flash_attention.cu, block_sparse_attention.cu): the products of a
// consumer warpgroup's 64-row tile (A from registers or shared memory, B
// from TMA's 128-byte-swizzled boxes), the exp2 of the softmax, the
// repacking of an accumulator as the A operand of the next product, the
// bf16 store of a consumer's rows (from registers, or staged for a TMA
// store), and the TMA tensor map over a [B, S, H, D] tensor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int BOX_ROW = 128;      // bytes of one swizzled box row: 64 bf16

// d[64 x D] (+)= A[64 x 16] B[16 x D], A from registers
template <int D, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, bool accumulate) {
  if constexpr (D == 128) hopper::wgmma_m64n128k16_rs<TB>(d, a, desc_b, accumulate);
  else hopper::wgmma_m64n64k16_rs<TB>(d, a, desc_b, accumulate);
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         bool accumulate) {
  if constexpr (N == 128) hopper::wgmma_m64n128k16<0, 0>(d, desc_a, desc_b, accumulate);
  else hopper::wgmma_m64n64k16<0, 0>(d, desc_a, desc_b, accumulate);
}

// 2^x on the special-function unit, a result below 2^-126 flushed to zero
// (exp2f adds a range check and two multiplies to keep such results): a p
// that small weighs nothing beside its row's largest, which is 1
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the A fragments of an m64 x (16 K) accumulator's 16-deep slices, bf16:
// slice k is its 8-column blocks 2k and 2k + 1
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&d)[K * 8]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k][0] = pack_bf16(d[8 * k], d[8 * k + 1]);
    a[k][1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
    a[k][2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
    a[k][3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
  }
}

// rows r0 and r0 + 8 (this thread's) of a consumer's [64, D] accumulator,
// scaled by f0 / f1, into bf16 rows of stride rs; rows at or past S not written
template <int D>
__device__ __forceinline__ void store_wg_rows(uint16_t* g, const float (&acc)[D / 2], int r0,
                                              int S, size_t rs, int t, float f0, float f1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
    const float f = half ? f1 : f0;
    uint16_t* dst = g + (size_t)row * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half] * f, acc[4 * j + 2 * half + 1] * f);
  }
}

// rows r and r + 8 (this thread's: r = 16 warp + lane / 4) of a consumer's
// [64, D] accumulator, as bf16, into D/64 boxes of [64 rows][64 columns]
// laid out as TMA's 128-byte swizzle reads them for a store (box c at
// `box + c * stride`): the 16-byte chunk j of row r sits at chunk j ^ (r %
// 8), so the quads of a warp write one column chunk to 32 distinct banks
template <int D>
__device__ __forceinline__ void stage_wg_rows(uint8_t* box, int stride, const float (&acc)[D / 2],
                                              int r, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      *reinterpret_cast<uint32_t*>(box + j / 8 * stride + row * BOX_ROW +
                                   ((j % 8 ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// a tensor map over one bf16 [B, S, H, D] tensor as (H * D, S, B): boxes of
// 64 values of one head's row by `rows` rows, 128-byte swizzle; rows at or
// past S (within each batch row) read as zeros
template <int D>
bool bshd_map(CUtensorMap* map, const void* base, int B, int H, int S, int rows) {
  const uint64_t dims[3] = {(uint64_t)H * D, (uint64_t)S, (uint64_t)B};
  const uint64_t pitch[2] = {(uint64_t)H * D * 2, (uint64_t)S * H * D * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, pitch, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Kernel>
cudaError_t launch_cfg(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace
