// Fused dequantize-matmul over grouped quantized carriers for Hopper
// (sm_90a): out[M, N] = x[M, K] @ dequant(values, scales), bf16 x and
// output, fp32 accumulation.
//
// Replaces the TPU kernel _qmm_kernel of
// deepspeed_tpu/ops/pallas/fused_quant_matmul.py (the `pl.pallas_call` in
// _qmm_pallas): int8, float8_e4m3fn or packed fp6 e3m2 carriers [K, N]
// ([K, 3N/4] for fp6) with fp32 scales [K, N / g], each weight decoded in
// fp32, scaled per (k, n-group) and rounded to bf16 before the product.
// Scheme 0 is a bf16 weight [K, N] (dense_matmul, the serving path's dense
// projections): the same product with no decode.
//
// What bounds it on an H100: at decode (M <= 16 rows) the weight bytes. A
// [4096, 4096] int8 projection moves 16.8 MB of carriers and 0.13 MB of
// scales for 0.27 GFLOP: ~5.0 us at 3.35 TB/s; a bf16 [4096, 14336] weight
// 117 MB, ~35 us. At a 512-row prefill chunk a bf16 projection is
// operations-bound ([4096, 14336]: 60 GFLOP, ~61 us at 989 TFLOP/s); the
// carriers of a 264-row chunk are still below the card's balance point.
//
// The designs, chosen by the wrapper before the launch from (instance, M
// bucket, K, N, alignment), all reading each weight as dequantize_grouped
// gives it (decode(code) * scale rounded once to bf16), so that only the
// fp32 summation order differs from the plain version:
//  - decode (M <= 16): k4_stream_kernel, ring_gemm.cuh's byte-streaming
//    design over one weight. The operands are swapped, out^T = W^T x^T:
//    each block streams [64 K][256 N] stages of the weight (carriers
//    decoded into four MN-major bf16 boxes, or bf16 boxes as TMA lands
//    them) through a 4-stage TMA ring and multiplies each box, as A, by
//    the 16-row x tile at m64n16k16. K is split over blocks by (N, K) alone
//    (k4_split in the wrapper: ~64 blocks for a bf16 weight, ~128 for
//    carriers, whose decode costs more a byte), so HBM is kept busy at
//    every shape; each split stores fp32 sums, and the last split of each
//    output tile to arrive (an atomic count in a workspace) adds them in
//    split order and writes bf16: one launch a call.
//  - prefill (M > 16) through carriers: k4_ring_kernel, ring_gemm.cuh's
//    wgmma ring (128 x 256 output tiles, two consumer warpgroups at
//    m64n256k16) over one weight, the 128-row items fixed by M; K split
//    over blocks, as above, when the tiles alone would leave SMs idle.
//  - prefill (M > 16) over a bf16 weight: k4_dense_ring_kernel below, 128
//    x BN tiles (BN 128; 64 is built, for a caller's choice) on wgmma fed by
//    a 6-stage TMA ring. dense_matmul must give a row the same bits at
//    every M (batch invariance), so this design cuts K into the decode
//    design's chunks: it restarts its accumulators at each chunk boundary
//    and adds them into fp32 totals in chunk order, the same operations in
//    the same order as the decode design's splits and their in-order sum,
//    with no partial sums through memory (the totals beside m64n256
//    accumulators would not fit the registers: hence BN <= 128). Where its
//    tiles would leave SMs idle (few rows, or N 1024), or where K is one
//    chunk and 128 x 256 tiles fill the card (the head, the MLP's gate and
//    up), k4_ring_kernel over the bf16 weight: 128 x 256 tiles, the chunks
//    split over blocks and summed as in the decode design.
//  - shapes TMA cannot read (unaligned bases, K % 8 != 0, weight rows not a
//    multiple of 16 bytes): quant_gemm.cuh's qgemm_kernel, the general
//    design (mma.sync on 64 x 64 or 16 x 64 tiles, K split over
//    blockIdx.z, the splits added by reduce_splits_kernel in order).

#include <map>
#include <mutex>
#include <tuple>

#include "ring_gemm.cuh"

namespace {

constexpr int DENSE_STAGES = 6;

template <int BN>
struct DenseSmem {
  static constexpr int kA = RING_ROWS * RING_STEP * 2;  // x: [128 rows][64 K], 16 KB
  static constexpr int kB = BN * RING_STEP * 2;         // W: BN / 64 [64 K][64 N] boxes
  static constexpr int kBar = DENSE_STAGES * (kA + kB);
  static constexpr int kBytes = kBar + 2 * DENSE_STAGES * 8 + 1024;  // + alignment slack
};

struct DenseArgs {
  uint16_t* out;                    // [M, N] bf16
  int M, K, N, items, chunk_steps;  // items: 128-row blocks; chunk_steps: K steps a chunk
};

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                         bool accumulate) {
  if constexpr (BN == 128) hopper::wgmma_m64n128k16<0, 1>(d, da, db, accumulate);
  else hopper::wgmma_m64n64k16<0, 1>(d, da, db, accumulate);
}

// A block owns rows 128 item .. and columns BN c ..: the producer warpgroup
// TMAs x [128 rows][64 K] (A, K-major) and BN / 64 [64 K][64 N] boxes of W
// (B, MN-major) a stage; consumer warpgroup cw multiplies its 64 rows. The
// accumulators restart at each chunk of chunk_steps steps and are added
// into the totals after it (when K has more than one chunk).
template <int BN>
__global__ void __launch_bounds__(RING_THREADS, 1)
    k4_dense_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w, const DenseArgs a) {
  using L = DenseSmem<BN>;
  constexpr int NA = BN / 2;  // accumulators a thread
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int item = (int)blockIdx.x % a.items, c0 = (int)blockIdx.x / a.items * BN;
  const int row0 = item * RING_ROWS, rows = min(RING_ROWS, a.M - row0);
  uint8_t* base = smem + ((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
  uint8_t* sA = base;
  uint8_t* sB = sA + DENSE_STAGES * L::kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + DENSE_STAGES;
  const int steps = (a.K + RING_STEP - 1) / RING_STEP;
  if (tid == 0) {
    for (int s = 0; s < DENSE_STAGES; ++s) {
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
      const int boxes = min(BN / 64, (a.N - c0 + 63) / 64);  // none wholly past N
      for (int i = 0; i < steps; ++i) {
        const int s = i % DENSE_STAGES;
        hopper::mbar_wait(&empty[s], ((i / DENSE_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::kA + boxes * RING_BOX);
        hopper::tma_load_2d(sA + s * L::kA, &map_x, &full[s], i * RING_STEP, row0);
        for (int j = 0; j < boxes; ++j)
          hopper::tma_load_3d(sB + s * L::kB + j * RING_BOX, &map_w, &full[s], c0 + 64 * j,
                              i * RING_STEP, 0);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int cw = wg - 1;               // this consumer computes rows 64 cw .. 64 cw + 63
  const bool active = 64 * cw < rows;  // an item of 64 rows or fewer leaves the second idle
  const bool chunked = a.chunk_steps < steps;
  float acc[NA];  // each chunk's first wgmma overwrites them
  float total[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) total[j] = 0.f;

  // the step loop with or without the wgmma (an idle consumer still
  // releases each stage): separate copies, so no branch sits around it
  auto consume = [&](auto mma) {
    for (int c = 0; c < steps; c += a.chunk_steps) {
      const int end = min(steps, c + a.chunk_steps);
      for (int i = c; i < end; ++i) {
        const int s = i % DENSE_STAGES;
        hopper::mbar_wait(&full[s], (i / DENSE_STAGES) & 1);
        if constexpr (decltype(mma)::value) {
          const uint64_t da =
              hopper::sw128_desc(hopper::smem_addr(sA + s * L::kA) + cw * (L::kA / 2));
          const uint64_t db = hopper::sw128_mn_desc(hopper::smem_addr(sB + s * L::kB), RING_BOX);
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < RING_STEP / 16; ++kk)  // A 32 bytes on, B 2048 bytes down
            wgmma_bn<BN>(acc, da + 2 * kk, db + 128 * kk, i > c || kk > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // the step before is done: release its stage
          hopper::fence_regs(acc);
        }
        if (i > 0 && (tid & 31) == 0) hopper::mbar_arrive(&empty[(i - 1) % DENSE_STAGES]);
      }
      if constexpr (decltype(mma)::value) {
        if (chunked) {  // the chunk's sums into the totals, in chunk order
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
#pragma unroll
          for (int j = 0; j < NA; ++j) total[j] += acc[j];
        }
      }
    }
  };
  if (!active) {
    consume(std::false_type{});
    return;
  }
  consume(std::true_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (chunked) store_acc(total, a.out + (size_t)row0 * a.N, a.N, 64 * cw, rows, c0);
  else store_acc(acc, a.out + (size_t)row0 * a.N, a.N, 64 * cw, rows, c0);
}

template <int S>
__global__ void __launch_bounds__(RING_THREADS, 1)
    k4_stream_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  stream_body<S, true>(map_x, map_w, a);
}

template <int S>
__global__ void __launch_bounds__(RING_THREADS, 1)
    k4_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, const RingArgs a) {
  ring_body<S, true, true>(map_x, map_w, a);
}

// The weight's tensor map, encoded once per (base, K, N, scheme): the
// serving path calls every projection's weight each forward, and encoding
// costs host time on a forward that is host-bound. A map holds only the
// base, the shape and the box, so an entry is right for any tensor that
// has them.
bool weight_map(CUtensorMap* map, const Args& a, int scheme) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(static_cast<const void*>(a.w), a.K, a.N, scheme);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const bool ok = scheme == kBF16  ? encode_w_map<kBF16, true>(map, a)
                  : scheme == kInt8 ? encode_w_map<kInt8, true>(map, a)
                  : scheme == kFP8  ? encode_w_map<kFP8, true>(map, a)
                                    : encode_w_map<kFP6, true>(map, a);
  if (!ok) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// x [M][K] bf16 as [rows][64 K] boxes, 128-byte swizzle
bool x_map(CUtensorMap* map, const Args& a, uint32_t rows) {
  const uint64_t dims[2] = {(uint64_t)a.K, (uint64_t)a.rows}, pitch[1] = {(uint64_t)a.K * 2};
  const uint32_t box[2] = {RING_STEP, rows};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, dims, pitch, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
}

// a kernel's dynamic shared memory limit, raised once per device
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int S, bool STREAM>
constexpr auto k4_kernel() {  // only the named design is instantiated
  if constexpr (STREAM) return k4_stream_kernel<S>;
  else return k4_ring_kernel<S>;
}

// design 1 (STREAM) or 2 through carriers, or design 1 over a bf16 weight
template <int S, bool STREAM>
cudaError_t launch_one(const Args& a, int splits, int k_chunk, int32_t* arrivals,
                       cudaStream_t st) {
  using L = RingSmem<S>;
  constexpr auto kernel = k4_kernel<S, STREAM>();
  CUtensorMap map_x, map_w;
  if (!x_map(&map_x, a, STREAM ? 16 : RING_ROWS) || !weight_map(&map_w, a, S))
    return cudaErrorInvalidValue;
  const RingArgs w{nullptr, a.scales, a.out, a.rows, a.K, a.N, a.ng, a.g, 1,
                   (a.N + RING_COLS - 1) / RING_COLS, (a.rows + RING_ROWS - 1) / RING_ROWS,
                   splits, k_chunk / RING_STEP, a.partial, arrivals};
  const long long blocks = (long long)w.items * w.cols * splits;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<kernel>(L::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(int)blocks, RING_THREADS, L::kBytes, st>>>(map_x, map_w, w);
  return cudaGetLastError();
}

// design 2 over a bf16 weight: 128 x bn tiles, K in chunks of k_chunk
template <int BN>
cudaError_t launch_dense_ring(const Args& a, int k_chunk, cudaStream_t st) {
  CUtensorMap map_x, map_w;
  if (!x_map(&map_x, a, RING_ROWS) || !weight_map(&map_w, a, kBF16)) return cudaErrorInvalidValue;
  const DenseArgs w{a.out, a.rows, a.K, a.N, (a.rows + RING_ROWS - 1) / RING_ROWS,
                    k_chunk / RING_STEP};
  const long long blocks = (long long)w.items * ((a.N + BN - 1) / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<k4_dense_ring_kernel<BN>>(DenseSmem<BN>::kBytes);
  if (err != cudaSuccess) return err;
  k4_dense_ring_kernel<BN><<<(int)blocks, RING_THREADS, DenseSmem<BN>::kBytes, st>>>(map_x, map_w,
                                                                                     w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Device pointers to contiguous tensors: x bf16
// [M, K]; values int8 / float8_e4m3fn [K, N] or uint8 [K, 3N/4] (fp6), or a
// bf16 weight [K, N] (scheme 0); scales fp32 [K, ng] (null for scheme 0);
// out bf16 [M, N]. scheme: 0 bf16, 1 int8, 2 fp8, 3 fp6. design: 0 the
// general design (tile: its row tile, 16 or 64; k_chunk a multiple of 32);
// 1 the decode design; 2 the prefill design (tile, over a bf16 weight: 64
// or 128 for the dense ring, 256 for k4_ring_kernel with the chunks split
// over blocks). Designs 1 and 2 are refused unless TMA can read x and the
// weight (16-byte aligned bases, K % 8 == 0, weight rows of a multiple of
// 16 bytes); their k_chunk, the K rows of a chunk, is a multiple of 64.
// splits: the K chunks; with splits > 1, partial fp32 [splits, M, N] and,
// for designs 1 and 2, arrivals int32 [ceil(M / 128) ceil(N / 256) 2], zero
// (the launch leaves it zero), except for the dense ring, which sums its
// chunks in registers. The wrapper in ops/kernels/fused_quant_matmul.py
// checks shapes and types and picks the design (k4_plan; its k4_design is
// the one predicate): the checks here only refuse, with
// cudaErrorInvalidValue, arguments that would make a kernel read out of
// bounds. Returns cudaGetLastError() of the launches.
extern "C" int ds_quant_matmul(const void* x, const void* values, const void* scales, void* out,
                               void* partial, void* arrivals, int M, int K, int N, int ng,
                               int scheme, int design, int splits, int k_chunk, int tile,
                               void* stream) {
  Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(values),
         static_cast<const float*>(scales), nullptr, nullptr, static_cast<uint16_t*>(out),
         splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N, ng,
         ng > 0 ? N / ng : 0, 1, k_chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (bad_args(a, scheme, tile) || splits < 1 || (splits > 1 && partial == nullptr) ||
        (long long)(splits - 1) * k_chunk >= K)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = scheme == kBF16 ? launch_bm<kBF16, false>(a, tile, splits, st)
                      : scheme == kInt8 ? launch_bm<kInt8, false>(a, tile, splits, st)
                      : scheme == kFP8 ? launch_bm<kFP8, false>(a, tile, splits, st)
                                       : launch_bm<kFP6, false>(a, tile, splits, st);
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)M * N;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    reduce_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                                  static_cast<uint16_t*>(out), n, splits);
    return (int)cudaGetLastError();
  }
  const bool dense_ring = design == 2 && scheme == kBF16 && tile != 256;
  a.k_chunk = RING_STEP;  // bad_args' check of the general design's chunk
  if (bad_args(a, scheme, 16) || (design != 1 && design != 2) || splits < 1 ||
      k_chunk <= 0 || k_chunk % RING_STEP != 0 || (long long)(splits - 1) * k_chunk >= K ||
      (long long)splits * k_chunk < K || !aligned16(x) || !aligned16(values) || K % 8 != 0 ||
      row_bytes(scheme, N) % 16 != 0 || (dense_ring && tile != 64 && tile != 128) ||
      (splits > 1 && !dense_ring && (partial == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dense_ring)
    return (int)(tile == 128 ? launch_dense_ring<128>(a, k_chunk, st)
                             : launch_dense_ring<64>(a, k_chunk, st));
  int32_t* arr = static_cast<int32_t*>(arrivals);
  const bool stream_design = design == 1;
  switch (scheme) {
    case kBF16:
      return (int)(stream_design ? launch_one<kBF16, true>(a, splits, k_chunk, arr, st)
                                 : launch_one<kBF16, false>(a, splits, k_chunk, arr, st));
    case kInt8:
      return (int)(stream_design ? launch_one<kInt8, true>(a, splits, k_chunk, arr, st)
                                 : launch_one<kInt8, false>(a, splits, k_chunk, arr, st));
    case kFP8:
      return (int)(stream_design ? launch_one<kFP8, true>(a, splits, k_chunk, arr, st)
                                 : launch_one<kFP8, false>(a, splits, k_chunk, arr, st));
    default:
      return (int)(stream_design ? launch_one<kFP6, true>(a, splits, k_chunk, arr, st)
                                 : launch_one<kFP6, false>(a, splits, k_chunk, arr, st));
  }
}
