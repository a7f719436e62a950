// Fused dequantize-matmul over grouped quantized carriers for Hopper
// (sm_90a): out[M, N] = x[M, K] @ dequant(values, scales), bf16 x and
// output, fp32 accumulation.
//
// Replaces the TPU kernel _qmm_kernel of
// deepspeed_tpu/ops/pallas/fused_quant_matmul.py (the `pl.pallas_call` in
// _qmm_pallas): int8, float8_e4m3fn or packed fp6 e3m2 carriers [K, N]
// ([K, 3N/4] for fp6) with fp32 scales [K, N / g], each weight decoded in
// fp32, scaled per (k, n-group) and rounded to bf16 before the product
// (quant_gemm.cuh has the tile GEMM and its decode).
//
// What bounds it on an H100: at decode (M = 8 sequences) the carrier bytes.
// A [4096, 4096] int8 projection moves 16.8 MB of carriers and 0.13 MB of
// scales for 0.27 GFLOP, about 16 flops per byte against the card's ~295
// balance point: ~5.0 us at 3.35 TB/s. A 264-token prefill chunk does 33x
// the flops on the same bytes and is still below the balance point, so
// bytes bound every call of the serving path.
//
// What the design does about that: every carrier byte is read once per row
// tile, and decode-sized batches (M <= 16) take a 16-row tile, so at decode
// each byte is read once per launch; the weights exist in bf16 only in
// shared memory, one 32 x 64 tile at a time. When the output tiles alone
// would leave SMs idle (a [4096, 4096] projection at M = 8 has 64 of them)
// the K loop is split over blockIdx.z, each split writing fp32 partial sums
// that a second small kernel adds in a fixed order and rounds to bf16, so
// all 132 SMs stream disjoint slices of the carriers. The carrier stream is
// not yet pipelined against the decode and the MMAs.

#include "quant_gemm.cuh"

using namespace qgemm;

// Plain C entry for ctypes. Device pointers to contiguous tensors: x bf16
// [M, K]; values int8 / float8_e4m3fn [K, N] or uint8 [K, 3N/4] (fp6);
// scales fp32 [K, ng]; out bf16 [M, N]; partial fp32 [splits, M, N] when
// splits > 1 (else null). scheme: 1 int8, 2 fp8, 3 fp6. bm: the row tile,
// 16 or 64; k_chunk: the K rows of one split, a multiple of 32. The
// wrapper in ops/kernels/fused_quant_matmul.py checks shapes and types.
// Returns cudaGetLastError() of the launches.
extern "C" int ds_quant_matmul(const void* x, const void* values, const void* scales, void* out,
                               void* partial, int M, int K, int N, int ng, int scheme, int bm,
                               int splits, int k_chunk, void* stream) {
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(values),
         static_cast<const float*>(scales), nullptr, nullptr, static_cast<uint16_t*>(out),
         splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N, ng,
         ng > 0 ? N / ng : 0, 1, k_chunk};
  if (bad_args(a, scheme, bm) || scheme == kBF16 || splits < 1 ||
      (splits > 1 && partial == nullptr) || (long long)(splits - 1) * k_chunk >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = scheme == kInt8 ? launch_bm<kInt8, false>(a, bm, splits, st)
                    : scheme == kFP8 ? launch_bm<kFP8, false>(a, bm, splits, st)
                                     : launch_bm<kFP6, false>(a, bm, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)M * N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                                static_cast<uint16_t*>(out), n, splits);
  return (int)cudaGetLastError();
}
