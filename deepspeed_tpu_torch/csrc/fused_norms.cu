// Fused RMSNorm and LayerNorm forwards for Hopper (sm_90a): one warp per
// row, fp32 statistics, bf16 or fp32 in and out.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/fused_norms.py (the
// `pl.pallas_call` in `_row_call`):
//   `_rms_fwd_kernel` (reached from `fused_rms_norm`) -> rms_fwd_kernel:
//     x32 = float(x); var = mean(x32^2); rstd = rsqrt(var + eps);
//     out = cast(x32 * rstd * float(scale)).
//   `_ln_fwd_kernel` (reached from `fused_layer_norm`) -> ln_fwd_kernel:
//     x32 = float(x); mean = mean(x32); xc = x32 - mean;
//     var = mean(xc^2) (two passes, not E[x^2] - E[x]^2);
//     rstd = rsqrt(var + eps); out = cast(xc * rstd * float(scale) + float(bias)).
//
// What bounds them: bytes. Each reads x and writes out once (2 * rows * D *
// sizeof(T)) and does a few flops per element, far below the card's ~295
// flops/byte balance point. At the Llama training shape [8192, 2048] bf16
// that is 67 MB, 20 us at 3.35 TB/s; at BERT-large's [16384, 1024] the same.
// So the card's memory pipe must be kept full: enough 16-byte loads in
// flight on every SM, and no byte of x read from device memory twice.
//
// What the RMS design does about that, at the widths the models use (D
// 2048 and 4096; rms_fwd_kernel<V, NV> with NV = D / (32 * vector) 16-byte
// vectors a lane):
//   - a warp issues all of its row's loads at once, into registers (2048
//     bf16: 8 vectors a lane, 4 KB a warp in flight), and takes the sum of
//     squares and the output from those registers, so x is read once and a
//     row's loads never wait on one another;
//   - scale is copied into shared memory once per block, and the block's
//     warps walk the rows with a grid stride, a grid of as many blocks as
//     fit on the card at once, so no row re-reads scale from L2;
//   - sums are reduced with warp shuffles, in the same order as the
//     general instance (each lane's vectors in column order, then the
//     butterfly), so both give the same bits.
// Any other D (NV = 0, the general instance) walks its row in a loop of
// runtime length and reads it again from L1/L2 for the output, one warp a
// row, 8 rows per 256-thread block. LayerNorm keeps that design (three
// passes, the later two from L1/L2).
// The backwards stay in PyTorch ops, as the JAX package leaves `_rms_bwd`
// and `_ln_bwd` to XLA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Bf16 {
  static constexpr int kVec = 8;  // elements per 16-byte vector
  typedef uint16_t T;
  __device__ static void unpack(const uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the upper half of an fp32: exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void load(const T* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
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
  __device__ static void unpack(const uint4 v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static void load(const T* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ static void store(T* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NV > 0: rows of D = 32 * kVec * NV, a lane's NV vectors held in
// registers, scale in shared memory, rows by grid stride. NV = 0: any D
// (a multiple of the vector), one row a warp, read twice.
template <typename V, int NV>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ scale,
               typename V::T* __restrict__ out, int rows, int D, float eps) {
  constexpr int VEC = V::kVec;
  typedef typename V::T T;
  const int lane = threadIdx.x & 31;
  if constexpr (NV > 0) {
    constexpr int W = 32 * VEC * NV;  // == D
    __shared__ __align__(16) T s_scale[W];
    for (int c = threadIdx.x * VEC; c < W; c += kThreads * VEC)
      *reinterpret_cast<uint4*>(s_scale + c) = *reinterpret_cast<const uint4*>(scale + c);
    __syncthreads();
    for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
         row += gridDim.x * kWarps) {  // whole warps take each row
      const T* xr = x + (size_t)row * W;
      uint4 v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        v[i] = *reinterpret_cast<const uint4*>(xr + (32 * i + lane) * VEC);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float f[VEC];
        V::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
      }
      const float rstd = rsqrtf(warp_sum(ss) / (float)W + eps);
      T* yr = out + (size_t)row * W;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (32 * i + lane) * VEC;
        float f[VEC], s[VEC];
        V::unpack(v[i], f);
        V::load(s_scale + c, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = f[e] * rstd * s[e];
        V::store(yr + c, f);
      }
    }
  } else {
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;  // whole warp leaves together
    const T* xr = x + (size_t)row * D;
    T* yr = out + (size_t)row * D;

    float ss = 0.f;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      float f[VEC];
      V::load(xr + c, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
    }
    const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);

    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      float f[VEC], s[VEC];
      V::load(xr + c, f);
      V::load(scale + c, s);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = f[i] * rstd * s[i];
      V::store(yr + c, f);
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const typename V::T* __restrict__ x, const typename V::T* __restrict__ scale,
              const typename V::T* __restrict__ bias, typename V::T* __restrict__ out,
              int rows, int D, float eps) {
  constexpr int VEC = V::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const typename V::T* xr = x + (size_t)row * D;
  typename V::T* yr = out + (size_t)row * D;

  float sum = 0.f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float f[VEC];
    V::load(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum += f[i];
  }
  const float mean = warp_sum(sum) / (float)D;

  float ss = 0.f;  // second pass: the centered sum of squares
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float f[VEC];
    V::load(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = f[i] - mean;
      ss = fmaf(d, d, ss);
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);

  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    float f[VEC], s[VEC], b[VEC];
    V::load(xr + c, f);
    V::load(scale + c, s);
    V::load(bias + c, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = (f[i] - mean) * rstd * s[i] + b[i];
    V::store(yr + c, f);
  }
}

// rows of D = 32 * kVec * NV: a grid of as many blocks as fit on the card
// at once (fewer when the rows need fewer), each walking rows by stride
template <typename V, int NV>
cudaError_t launch_rows(const void* x, const void* scale, void* out, int rows, float eps,
                        cudaStream_t st) {
  static int per_sm = 0;  // blocks an SM holds at once: a property of the kernel
  if (per_sm == 0) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rms_fwd_kernel<V, NV>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = min((rows + kWarps - 1) / kWarps, sms * per_sm);
  rms_fwd_kernel<V, NV><<<blocks, kThreads, 0, st>>>(
      static_cast<const typename V::T*>(x), static_cast<const typename V::T*>(scale),
      static_cast<typename V::T*>(out), rows, 32 * V::kVec * NV, eps);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D, float eps,
                   cudaStream_t st) {
  constexpr int kRow = 32 * V::kVec;  // a warp's row elements in one vector a lane
  // the models' widths keep a row in registers, at most 16 vectors a lane
  if (D == 2048) return launch_rows<V, 2048 / kRow>(x, scale, out, rows, eps, st);
  if constexpr (4096 / kRow <= 16) {
    if (D == 4096) return launch_rows<V, 4096 / kRow>(x, scale, out, rows, eps, st);
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  rms_fwd_kernel<V, 0><<<blocks, kThreads, 0, st>>>(
      static_cast<const typename V::T*>(x), static_cast<const typename V::T*>(scale),
      static_cast<typename V::T*>(out), rows, D, eps);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_ln(const void* x, const void* scale, const void* bias, void* out, int rows,
                      int D, float eps, cudaStream_t st) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<V><<<blocks, kThreads, 0, st>>>(
      static_cast<const typename V::T*>(x), static_cast<const typename V::T*>(scale),
      static_cast<const typename V::T*>(bias), static_cast<typename V::T*>(out), rows, D, eps);
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

// LayerNorm: as above, with bias [D] of the same dtype.
extern "C" int ds_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* out,
                                 int rows, int D, float eps, int dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (D <= 0 || D % 8 != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_ln<Bf16>(x, scale, bias, out, rows, D, eps, st)
                          : launch_ln<F32>(x, scale, bias, out, rows, D, eps, st));
}
