// Group-wise symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels `_quant_kernel` and `_dequant_kernel` of
// deepspeed_tpu/ops/pallas/quantization.py (the `pl.pallas_call`s in
// `quantize_int8` and `dequantize_int8`). Same math, per group g of the
// flattened tensor viewed as [G, gs]:
//   quantize:   absmax = max |x|; scale = absmax == 0 ? 1 : absmax / 127;
//               q = clip(rint(x / scale), -127, 127)            (half to even)
//               or, stochastic, q = clip(floor(x / scale) + (u < frac), ...)
//               with u a counter-based hash of (seed, g, index) in [0, 1);
//   dequantize: out[rows[g]] = cast(float(q) * scale), rows the identity
//               unless the caller maps groups onto rows of another tensor
//               (the KV pool: a restore writes straight into its blocks).
//
// Exactness is the contract (the deterministic path must be bit-exact with
// the JAX package's eager path): both divisions are IEEE divisions
// (__fdiv_rn, never a product with a reciprocal), rounding is
// __float2int_rn (half to even), the all-zero group's scale is 1 and the
// clip is at -127. The build has no -use_fast_math. The TPU's hardware
// PRNG of the stochastic branch is not carried over: the plain PyTorch
// version computes the same hash with integer ops, so kernel and plain
// version agree bit for bit on the card; against the TPU only the
// distribution is comparable.
//
// What bounds it: bytes. Quantize reads 2 (bf16) or 4 (fp32) bytes and
// writes 1 per value, plus 4 per group; dequantize reads 1 and writes 2 or
// 4. At the KV tier's shape, one Mistral-7B block is 32 layers x 32768
// values for each of k and v: ~6.3 MB, ~1.9 us at 3.35 TB/s.
//
// What the designs do about that (the wrapper's k7_design names one from
// the group size, the dtype and the alignment; each is exact as above):
//   - quantize, groups of up to 1024 values: a warp a group, two passes
//     (absmax, then the codes) over the group, the second mostly from L1;
//   - quantize, the cluster design: a group of 4097 .. 65536 values in
//     whole 8-value units, x 16-byte aligned (every KV tier slab), is split
//     over a thread block cluster of 2-8 blocks of 256 threads
//     (k7_cluster_size: at most 16 values a thread below 8 blocks), so a
//     demotion's 64 slabs are 512 blocks on 132 SMs, not 64. Each thread
//     reads its values once, with 16-byte loads all in flight together,
//     into registers; the group's absmax is reduced in the block (warp
//     shuffles, then shared memory), then across the cluster through
//     distributed shared memory (mapa and ld.shared::cluster after a
//     barrier.cluster arrive/wait); the codes are formed from the
//     registers and stored 8 at a time. No value is read twice or staged.
//     Its blocks each make one dependent round (load, reduce, cluster
//     barrier, codes), so it is chosen only where the groups' blocks run in
//     one wave (4 an SM); past that the two-pass design streams faster
//     (H100: 7.7 against 10.4 us at 64 slab groups, 13.3 against 11.8 at
//     128, 40.9 against 30.4 at 512);
//   - quantize, the two-pass design (every other group of more than 1024
//     values): one 256-thread block a group, an absmax pass that stages a
//     group of up to 128 KB in shared memory, then the rounding pass from
//     there (larger groups are read twice, the second read mostly from
//     L2); 16-byte
//     loads, 8 in flight a thread, and 8- or 4-byte stores of q where the
//     group is a whole number of vectors and the tensor 16-byte aligned;
//   - dequantize: a grid-stride loop, 8 codes a thread (an 8-byte load,
//     a 16- or 32-byte store), the group and its destination row from the
//     element index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 128 * 1024;  // largest group staged in shared memory
constexpr int kUnroll = 8;            // 16-byte loads a thread keeps in flight in pass 1

__device__ __forceinline__ uint32_t mix32(uint32_t x) {  // lowbias32
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Bf16 {
  typedef uint16_t T;
  static constexpr int kVec = 8;  // values per 16-byte vector
  typedef uint2 QVec;             // 8 int8 codes
  __device__ static float one(const T* p) { return __uint_as_float((uint32_t)(*p) << 16); }
  __device__ static void unpack(const uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the upper half of an fp32: exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct F32 {
  typedef float T;
  static constexpr int kVec = 4;
  typedef uint32_t QVec;  // 4 int8 codes
  __device__ static float one(const T* p) { return *p; }
  __device__ static void unpack(const uint4 v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
};

// The code of one value: deterministic rint, or stochastic floor + (u < frac).
// A zero's code is 0 either way (0 / scale is a zero, and u < 0 never
// holds), so its division is not made: a zero dividend sends the IEEE
// division to its slow path, and with one all-zero head in every KV slab
// that path was most of the two-pass design's time (H100: 25.4 us against
// 10.4 without it at 64 slab groups).
__device__ __forceinline__ int8_t code(float x, float scale, bool stochastic, uint32_t key,
                                       uint32_t index) {
  const bool zero = x == 0.f;
  const float s = __fdiv_rn(zero ? scale : x, scale);
  int q;
  if (stochastic) {
    const float lo = floorf(s);
    const float u = __fmul_rn(__uint2float_rn(mix32(key ^ index) >> 9), 1.1920928955078125e-07f);
    q = (int)(u < __fsub_rn(s, lo) ? __fadd_rn(lo, 1.f) : lo);
  } else {
    q = __float2int_rn(s);
  }
  return zero ? (int8_t)0 : (int8_t)max(-127, min(127, q));
}

// TPG threads quantize one group: TPG = 32 (a warp) or kThreads (the block).
template <typename V, int TPG>
__global__ void __launch_bounds__(kThreads)
    quant_kernel(const typename V::T* __restrict__ x, int8_t* __restrict__ values,
                 float* __restrict__ scales, long long groups, int gs, bool vec, bool stage,
                 bool stochastic, uint32_t seed_key) {
  typedef typename V::T T;
  constexpr int VEC = V::kVec;
  extern __shared__ uint4 smem_raw[];
  T* staged = reinterpret_cast<T*>(smem_raw);
  __shared__ float red[kThreads / 32];

  const int lane = threadIdx.x % TPG;
  const long long g = (long long)blockIdx.x * (kThreads / TPG) + threadIdx.x / TPG;
  const bool live = g < groups;  // a warp past the end still joins the block's barriers
  const T* xg = x + (live ? g : 0) * (long long)gs;

  // pass 1: absmax (and the group into shared memory), kUnroll vectors a
  // thread in flight at once: a few blocks' groups are too few to hide the
  // memory latency otherwise
  float amax = 0.f;
  if (live) {
    if (vec) {
      constexpr int STEP = TPG * VEC;
      for (int i0 = lane * VEC; i0 < gs; i0 += kUnroll * STEP) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i0 + u * STEP < gs) raw[u] = *reinterpret_cast<const uint4*>(xg + i0 + u * STEP);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u * STEP >= gs) break;
          if (stage) *reinterpret_cast<uint4*>(staged + i0 + u * STEP) = raw[u];
          float f[VEC];
          V::unpack(raw[u], f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(f[e]));
        }
      }
    } else {
      for (int i = lane; i < gs; i += TPG) {
        if (stage) staged[i] = xg[i];
        amax = fmaxf(amax, fabsf(V::one(xg + i)));
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (TPG == kThreads) {  // max is exact: the order of the reduction cannot matter
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  }
  if (!live) return;
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  if (lane == 0) scales[g] = scale;
  const uint32_t key = mix32(seed_key ^ (uint32_t)g);

  // pass 2: the codes, from shared memory when staged
  const T* src = stage ? staged : xg;
  int8_t* qg = values + g * (long long)gs;
  if (vec) {
    for (int i = lane * VEC; i < gs; i += TPG * VEC) {
      float f[VEC];
      V::unpack(*reinterpret_cast<const uint4*>(src + i), f);
      union { typename V::QVec v; int8_t b[VEC]; } out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.b[e] = code(f[e], scale, stochastic, key, i + e);
      *reinterpret_cast<typename V::QVec*>(qg + i) = out.v;
    }
  } else {
    for (int i = lane; i < gs; i += TPG) qg[i] = code(V::one(src + i), scale, stochastic, key, i);
  }
}

// ------------------------------------------------------------ cluster design
// A group of 4097 .. kClusterMax values, gs % 8 == 0, x 16-byte aligned:
// split over a thread block cluster of CS blocks (k7_cluster_size), block r
// of it the r-th of CS equal slices of the group's 8-value units, a thread
// the units r * per + tid + u * kThreads (u < kUnits). Each value is read
// once, into registers, with 16-byte loads all issued before the first is
// used; the group's absmax is the max of the blocks' maxima, each block's
// read by the others through distributed shared memory after a cluster
// barrier; the codes are formed from the registers and stored 8 at a time.
constexpr int kUnits = 4;                           // 8-value units a thread at most
constexpr int kMaxCluster = 8;                      // portable cluster size
constexpr int kClusterMax = kMaxCluster * kThreads * kUnits * 8;  // 65536 values

// the least power-of-two cluster (up to 8) that gives each thread at most
// 16 values, or 32 at the largest cluster
inline int k7_cluster_size(int gs) {
  int cs = 1;
  while (cs < kMaxCluster && cs * kThreads * 16 < gs) cs *= 2;
  return cs;
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at `p` in the shared memory of cluster block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    quant_cluster_kernel(const typename V::T* __restrict__ x, int8_t* __restrict__ values,
                         float* __restrict__ scales, int gs, int cs, bool stochastic,
                         uint32_t seed_key) {
  constexpr int LPU = 8 / V::kVec;  // 16-byte loads an 8-value unit
  __shared__ float red[kThreads / 32];
  __shared__ float block_max;
  const uint32_t rank = cluster_ctarank();
  const long long g = blockIdx.x / cs;
  const int units = gs / 8, per = (units + cs - 1) / cs;
  const int u0 = rank * per, u1 = min(units, u0 + per);
  const uint4* xg = reinterpret_cast<const uint4*>(x + g * (long long)gs);

  uint4 raw[kUnits][LPU];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int unit = u0 + threadIdx.x + u * kThreads;
    if (unit < u1) {
#pragma unroll
      for (int j = 0; j < LPU; ++j) raw[u][j] = xg[unit * LPU + j];
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    if (u0 + threadIdx.x + u * kThreads < u1) {
#pragma unroll
      for (int j = 0; j < LPU; ++j) {
        float f[V::kVec];
        V::unpack(raw[u][j], f);
#pragma unroll
        for (int e = 0; e < V::kVec; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
  }
  // max is exact: the order of the reduction cannot matter
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    block_max = m;
  }
  cluster_arrive();  // every block's maximum is in its shared memory
  cluster_wait();
  const int lane = threadIdx.x & 31;
  amax = lane < cs ? ld_cluster(&block_max, lane) : 0.f;
#pragma unroll
  for (int o = 4; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = __shfl_sync(0xffffffffu, amax, 0);
  cluster_arrive();  // this block has read the others' maxima
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  if (rank == 0 && threadIdx.x == 0) scales[g] = scale;
  const uint32_t key = mix32(seed_key ^ (uint32_t)g);

  int8_t* qg = values + g * (long long)gs;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int unit = u0 + threadIdx.x + u * kThreads;
    if (unit < u1) {
      union { uint2 v; int8_t b[8]; } out;
#pragma unroll
      for (int j = 0; j < LPU; ++j) {
        float f[V::kVec];
        V::unpack(raw[u][j], f);
#pragma unroll
        for (int e = 0; e < V::kVec; ++e) {
          const int i = unit * 8 + j * V::kVec + e;
          out.b[j * V::kVec + e] = code(f[e], scale, stochastic, key, i);
        }
      }
      *reinterpret_cast<uint2*>(qg + unit * 8) = out.v;
    }
  }
  cluster_wait();  // no block leaves while another may read its maximum
}

template <typename V>
cudaError_t launch_quant_cluster(const void* x, int8_t* values, float* scales, long long groups,
                                 int gs, bool stochastic, uint32_t seed_key, cudaStream_t st) {
  const int cs = k7_cluster_size(gs);
  if (groups * cs > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quant_cluster_kernel<V>,
                                       static_cast<const typename V::T*>(x), values, scales, gs,
                                       cs, stochastic, seed_key);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

__device__ __forceinline__ void store8(uint16_t* p, const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store1(uint16_t* p, float f) {
  const __nv_bfloat16 b = __float2bfloat16_rn(f);
  *p = *reinterpret_cast<const uint16_t*>(&b);
}
__device__ __forceinline__ void store1(float* p, float f) { *p = f; }

// out[rows[g]][j] = cast(float(values[g][j]) * scales[g]); rows null = identity.
// vec: gs a multiple of 8 and every pointer aligned for 8 codes and 8 outputs.
template <typename O>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                   const int32_t* __restrict__ rows, O* __restrict__ out, long long groups,
                   int gs, bool vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  if (vec) {
    const long long nvec = groups * (gs / 8);
    for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nvec; v += stride) {
      const long long e = v * 8;
      const long long g = e / gs;
      const long long j = e - g * gs;
      const float s = __ldg(scales + g);
      const long long dst = (rows ? (long long)__ldg(rows + g) : g) * gs + j;
      const uint2 q = *reinterpret_cast<const uint2*>(values + e);
      const int8_t* b = reinterpret_cast<const int8_t*>(&q);
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __fmul_rn((float)b[i], s);
      store8(out + dst, f);
    }
  } else {
    const long long n = groups * gs;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
      const long long g = e / gs;
      const long long dst = (rows ? (long long)__ldg(rows + g) : g) * gs + (e - g * gs);
      store1(out + dst, __fmul_rn((float)values[e], __ldg(scales + g)));
    }
  }
}

template <typename V, int TPG>
cudaError_t launch_quant(const void* x, int8_t* values, float* scales, long long groups, int gs,
                         bool vec, bool stochastic, uint32_t seed_key, cudaStream_t st) {
  const long long per_block = kThreads / TPG;
  const long long blocks = (groups + per_block - 1) / per_block;
  const size_t bytes = (size_t)gs * sizeof(typename V::T);
  const bool stage = TPG == kThreads && bytes <= (size_t)kSmemMax;
  const size_t smem = stage ? bytes : 0;
  if (smem > 48 * 1024) {  // raise the instance's limit once per device, to the most it stages
    static int configured_device = -1;
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != configured_device) {
      err = cudaFuncSetAttribute(quant_kernel<V, TPG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err == cudaSuccess) configured_device = device;
    }
    if (err != cudaSuccess) return err;
  }
  quant_kernel<V, TPG><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const typename V::T*>(x), values, scales, groups, gs, vec, stage, stochastic,
      seed_key);
  return cudaGetLastError();
}

// design 0: a warp a group; 1: the cluster design; 2: a block a group, two passes
template <typename V>
cudaError_t quant_dispatch(int design, const void* x, int8_t* values, float* scales,
                           long long groups, int gs, bool vec, bool stochastic, uint32_t seed_key,
                           cudaStream_t st) {
  if (design == 0)
    return launch_quant<V, 32>(x, values, scales, groups, gs, vec, stochastic, seed_key, st);
  if (design == 1)
    return launch_quant_cluster<V>(x, values, scales, groups, gs, stochastic, seed_key, st);
  return launch_quant<V, kThreads>(x, values, scales, groups, gs, vec, stochastic, seed_key, st);
}

template <typename O>
cudaError_t launch_dequant(const int8_t* values, const float* scales, const int32_t* rows,
                           void* out, long long groups, int gs, bool vec, cudaStream_t st) {
  const long long work = vec ? groups * (gs / 8) : groups * gs;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks an SM
  dequant_kernel<O><<<(unsigned)blocks, kThreads, 0, st>>>(values, scales, rows,
                                                           static_cast<O*>(out), groups, gs, vec);
  return cudaGetLastError();
}

}  // namespace

// x [groups, gs] (dtype 0 bf16, 1 fp32) -> values int8 [groups, gs], scales fp32 [groups].
// vec: gs a multiple of the 16-byte vector and x 16-byte aligned. seed_key: the
// stochastic branch's key (mix of the caller's seed), ignored when deterministic.
// design: 0 a warp a group, 1 the cluster design (vec, gs % 8 == 0, 4096 < gs <=
// 65536), 2 a block a group in two passes; the wrapper's k7_design names it.
extern "C" int ds_quantize_int8(const void* x, int8_t* values, float* scales, long long groups,
                                int gs, int dtype, int vec, int stochastic, unsigned seed_key,
                                int design, void* stream) {
  if (groups <= 0) return (int)cudaSuccess;
  if (gs <= 0 || (dtype != 0 && dtype != 1) || design < 0 || design > 2)
    return (int)cudaErrorInvalidValue;
  if (vec && gs % (dtype == 0 ? Bf16::kVec : F32::kVec)) return (int)cudaErrorInvalidValue;
  if (design == 1 && (!vec || gs % 8 || gs <= kThreads * 16 || gs > kClusterMax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? quant_dispatch<Bf16>(design, x, values, scales, groups, gs, vec != 0,
                                                 stochastic != 0, seed_key, st)
                          : quant_dispatch<F32>(design, x, values, scales, groups, gs, vec != 0,
                                                stochastic != 0, seed_key, st));
}

// values int8 [groups, gs], scales fp32 [groups] -> out[rows[g]] (dtype 0 bf16, 1 fp32),
// out viewed as [R, gs]; rows null writes row g.
extern "C" int ds_dequantize_int8(const int8_t* values, const float* scales, const int32_t* rows,
                                  void* out, long long groups, int gs, int dtype, int vec,
                                  void* stream) {
  if (groups <= 0) return (int)cudaSuccess;
  if (gs <= 0 || (dtype != 0 && dtype != 1) || (vec && gs % 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_dequant<uint16_t>(values, scales, rows, out, groups, gs,
                                                     vec != 0, st)
                          : launch_dequant<float>(values, scales, rows, out, groups, gs,
                                                  vec != 0, st));
}
