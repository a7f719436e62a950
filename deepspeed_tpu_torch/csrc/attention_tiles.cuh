// Tensor-core building blocks shared by the attention kernels
// (flash_attention.cu, block_sparse_attention.cu, paged_attention.cu) and
// the LoRA kernel (lora_matmul.cu): bf16 mma.sync.m16n8k16 with fp32
// accumulators, ldmatrix (and .trans) lane addressing over shared tiles
// whose rows are padded by kPad bf16, cp.async copies, bf16 packing, the
// quad reductions over the four lanes that hold one accumulator row, and
// the bf16 store of a warp's 16-row accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;                 // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

// lanes 0-15 give the rows of two 8x8 matrices (.trans: of a [k][n] tile)
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without registers; src-size 0 writes 16 zero
// bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

}  // namespace
