// Grouped (per-expert) matmul on a tile-aligned row layout for Hopper
// (sm_90a): the MoE expert GEMM, out[Mp, N] = x[Mp, K] @ W[tile_expert],
// bf16 x and output, fp32 accumulation, W a bf16 expert stack [E, K, N] or
// grouped quantized expert carriers.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/grouped_matmul.py:
//   _gmm_kernel       (the `pl.pallas_call` in _gmm_raw)       -> scheme 0
//   _gmm_quant_kernel (the `pl.pallas_call` in _gmm_quant_raw) -> schemes 1-3
// Rows are sorted by expert and each expert's group is zero-padded to the
// row tile (16 or 64), so every row tile belongs to one expert,
// tile_expert[tile]; the block reads its own tile's expert (the TPU's
// scalar prefetch). Tiles at or past *used_tiles, which the routing writes
// on the device, hold no rows: their blocks write zeros and read no weight,
// so an expert with no rows costs nothing and the host never learns the
// count. Quantized carriers are decoded and scaled into bf16 in shared
// memory exactly as dequantize_grouped does (quant_gemm.cuh).
//
// What bounds it on an H100: the weight bytes of the experts the batch
// touches. Decoding 8 tokens (16 rows, top-2) through one Mixtral layer's
// [8, 4096, 14336] int8 stack reads 469.8 MB of carriers and 3.7 MB of
// scales when every expert is hit, ~141 us at 3.35 TB/s; a 528-row prefill
// chunk does 33x the flops on the same bytes and is still bytes-bound.
//
// What the design does about that: each (row tile, 64 columns) block
// streams its expert's column slice once; decode takes 16-row tiles, so a
// decode batch reads each touched expert's slab about once (twice where an
// expert holds more than 16 rows); the grid is the static worst case of the
// layout, and unused tiles exit at once. The carrier stream is not yet
// pipelined against the decode and the MMAs.

#include "quant_gemm.cuh"

using namespace qgemm;

// Plain C entry for ctypes. Device pointers to contiguous tensors: x bf16
// [Mp, K]; w bf16 [E, K, N] (scheme 0) or carriers int8 / float8_e4m3fn
// [E, K, N] or uint8 [E, K, 3N/4] (fp6); scales fp32 [E, K, ng] (null for
// scheme 0); tile_expert int32 [Mp / tm]; used_tiles int32 [1]; out bf16
// [Mp, N]. scheme: 0 bf16, 1 int8, 2 fp8, 3 fp6; tm: 16 or 64. The wrapper
// in ops/kernels/grouped_matmul.py checks shapes and types. Returns
// cudaGetLastError() of the launch.
extern "C" int ds_grouped_matmul(const void* x, const void* w, const void* scales,
                                 const void* tile_expert, const void* used_tiles, void* out,
                                 int Mp, int K, int N, int ng, int E, int scheme, int tm,
                                 void* stream) {
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<const float*>(scales), static_cast<const int32_t*>(tile_expert),
         static_cast<const int32_t*>(used_tiles), static_cast<uint16_t*>(out), nullptr,
         Mp, K, N, ng, ng > 0 ? N / ng : 0, E, (K + BK - 1) / BK * BK};
  if (bad_args(a, scheme, tm) || E <= 0 || Mp % tm != 0 || tile_expert == nullptr ||
      used_tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case kBF16: return (int)launch_bm<kBF16, true>(a, tm, 1, st);
    case kInt8: return (int)launch_bm<kInt8, true>(a, tm, 1, st);
    case kFP8: return (int)launch_bm<kFP8, true>(a, tm, 1, st);
    default: return (int)launch_bm<kFP6, true>(a, tm, 1, st);
  }
}
