// Fused RMSNorm forward for Hopper (sm_90a): one warp per row, fp32
// statistics, bf16 or fp32 in and out.
//
// Replaces the TPU kernel `_rms_fwd_kernel` of
// deepspeed_tpu/ops/pallas/fused_norms.py (the `pl.pallas_call` in
// `_row_call`, reached from `fused_rms_norm`). Same math, per row of
// x [rows, D]:
//   x32 = float(x); var = mean(x32^2); rstd = rsqrt(var + eps);
//   out = cast(x32 * rstd * float(scale)).
//
// What bounds it: bytes. It reads x and writes out once (2 * rows * D *
// sizeof(T)) and does ~4 flops per element, far below the card's ~295
// flops/byte balance point. At the training shape [8192, 2048] bf16 that is
// 67 MB, 20 us at 3.35 TB/s.
//
// What the design does about that:
//   - one warp per row, reading 16-byte vectors with neighbouring lanes on
//     neighbouring addresses, so every load is fully coalesced;
//   - the row (4 KB at D = 2048 bf16) is read a second time for the output
//     pass straight after the first, so the second read comes from L1/L2
//     and device memory sees x once;
//   - the sum of squares is reduced with warp shuffles, no shared memory
//     and no block barrier; 8 rows per 256-thread block.
// The backward stays in PyTorch ops, as the JAX package leaves `_rms_bwd`
// to XLA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Bf16 {
  static constexpr int kVec = 8;  // elements per 16-byte vector
  typedef uint16_t T;
  __device__ static void load(const T* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the upper half of an fp32: exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(T* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct F32 {
  static constexpr int kVec = 4;
  typedef float T;
  __device__ static void load(const T* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(T* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ scale,
               typename V::T* __restrict__ out, int rows, int D, float eps) {
  constexpr int VEC = V::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const typename V::T* xr = x + (size_t)row * D;
  typename V::T* yr = out + (size_t)row * D;

  float ss = 0.f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float f[VEC];
    V::load(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rstd = rsqrtf(ss / (float)D + eps);

  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float f[VEC], s[VEC];
    V::load(xr + c, f);
    V::load(scale + c, s);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = f[i] * rstd * s[i];
    V::store(yr + c, f);
  }
}

template <typename V>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D, float eps,
                   cudaStream_t st) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  rms_fwd_kernel<V><<<blocks, kThreads, 0, st>>>(
      static_cast<const typename V::T*>(x), static_cast<const typename V::T*>(scale),
      static_cast<typename V::T*>(out), rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x and out are contiguous [rows, D] device
// tensors and scale [D], all of one dtype: `dtype` 0 = bf16, 1 = fp32. D is
// a multiple of 8. The wrapper in ops/kernels/fused_norms.py checks types,
// shapes and alignment. Returns cudaGetLastError() of the launch.
extern "C" int ds_rms_norm_fwd(const void* x, const void* scale, void* out, int rows, int D,
                               float eps, int dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (D <= 0 || D % 8 != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch<Bf16>(x, scale, out, rows, D, eps, st)
                          : launch<F32>(x, scale, out, rows, D, eps, st));
}
