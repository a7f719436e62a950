// Paged decode attention for Hopper (sm_90a): one query token against its
// block-tabled KV context, GQA, online softmax in fp32.
//
// Replaces the TPU kernel `_kernel` / `paged_decode_attention` in
// deepspeed_tpu/ops/pallas/paged_attention.py (the `pl.pallas_call` there).
// Same contract as that module's `xla_paged_attention`:
//   q [T, H, Dh] bf16, kc/vc [NB, bs, Hkv, Dh] bf16 (one layer's pool slice),
//   block_tables [T, MB] int32 (one row per token), token_pos [T] int32
//   -> out [T, H, Dh] bf16, token t attending to positions <= token_pos[t]
//   of its own blocks 0 .. min(pos // bs + 1, MB) - 1, scale 1/sqrt(Dh),
//   query head h reading KV head h / (H / Hkv).
//
// What bounds it: the bytes of K and V read from device memory, about
//   sum_t ceil((pos_t + 1) / bs) * bs * Hkv * Dh * 2 (K and V) * 2 bytes,
// against 3.35 TB/s on an H100 SXM. It does 4 * H * Dh flops per attended
// position, about one flop per byte of KV at G = 4: far below the card's
// ~295 flops/byte balance point, so the tensor cores would not help and the
// kernel computes in fp32 on the CUDA cores.
//
// What the design does about the bound:
//   - one thread block per (token, KV head, group of <= 8 query heads), so the
//     G query heads sharing a KV head read each K/V row once, not G times;
//   - each K/V row is read as 16-byte vectors by a group of lanes (Dh / 8
//     lanes, rounded up to a power of two), so a warp covers whole rows with
//     coalesced loads;
//   - every lane group keeps kUnroll rows' loads in flight before it uses any
//     of them, and 8 warps per block walk the context together, to hide the
//     device-memory latency;
//   - scores, softmax state and the P.V accumulator stay in registers; the
//     warps merge their partial softmax states once, through shared memory.
// Not done yet (work for a later change): splitting one long context over
// several blocks (flash-decoding), which a small decode batch needs to fill
// all 132 SMs, and TMA / cp.async staging.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // context rows a lane group has in flight per trip
constexpr int kMaxHeads = 8; // query heads one block handles (grid.z splits more)

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  // bf16 is the upper half of an fp32: widening is a shift, exact.
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint16_t float_to_bf16_rne(float x) {
  // round to nearest even; inputs here are finite
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

template <int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ kc,
                    const uint16_t* __restrict__ vc,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ token_pos,
                    uint16_t* __restrict__ out,
                    int H, int Hkv, int Dh, int bs, int MB, float scale_log2) {
  extern __shared__ float smem[];
  float* sm_m = smem;                          // [kWarps][GT]
  float* sm_l = sm_m + kWarps * GT;            // [kWarps][GT]
  float* sm_acc = sm_l + kWarps * GT;          // [kWarps][GT][Dh]

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int g0 = blockIdx.z * GT;
  const int gn = min(GT, G - g0);
  const int h0 = kvh * G + g0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int chunks = Dh >> 3;                  // 16-byte chunks in one head row
  int lpr = 1;                                 // lanes per row, a power of two
  while (lpr < chunks) lpr <<= 1;
  const int rpw = 32 / lpr;                    // rows a warp reads at once
  const int grp = lane / lpr;
  const int c = lane % lpr;
  const bool active = c < chunks;
  const int rows_per_trip = kWarps * rpw;

  // q for this lane's chunk, pre-scaled into the log2 domain (exp2 below)
  float qr[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn && active) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          q + ((size_t)t * H + h0 + g) * Dh + c * 8);
      bf16x8_to_float(v, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -FLT_MAX;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int n_pos = min(token_pos[t] + 1, MB * bs);
  const int32_t* tab = tables + (size_t)t * MB;
  const size_t row_stride = (size_t)Hkv * Dh;
  const size_t head_off = (size_t)kvh * Dh + c * 8;

  // The trip count depends only on the warp, never on the lane, so every
  // lane reaches the shuffles below.
  for (int base = warp * rpw; base < n_pos; base += rows_per_trip * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + grp + u * rows_per_trip;
      ok[u] = p < n_pos;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && active) {
        const int blk = __ldg(tab + p / bs);
        const size_t off = ((size_t)blk * bs + p % bs) * row_stride + head_off;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kc + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vc + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[8];
      bf16x8_to_float(kr[u], kf);
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
        for (int o = lpr >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[g] = d;
      }
      if (ok[u]) {
        float vf[8];
        bf16x8_to_float(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = exp2f(m[g] - m_new);
          const float p = exp2f(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(acc[g][e], alpha, p * vf[e]);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warp's row groups (lanes with the same chunk index)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = exp2f(m[g] - m_new);
      const float b = exp2f(m_o - m_new);
      l[g] = l[g] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * b;
      }
      m[g] = m_new;
    }
  }

  // merge the warps through shared memory
  if (grp == 0 && active) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < gn) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sm_acc[(warp * GT + g) * Dh + c * 8 + e] = acc[g][e];
        if (c == 0) {
          sm_m[warp * GT + g] = m[g];
          sm_l[warp * GT + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    float mx = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * GT + g] - mx);
      lsum += sm_l[w * GT + g] * f;
      a += sm_acc[(w * GT + g) * Dh + d] * f;
    }
    out[((size_t)t * H + h0 + g) * Dh + d] = float_to_bf16_rne(a / fmaxf(lsum, 1e-30f));
  }
}

template <int GT>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* tables,
                   const void* pos, void* out, int T, int H, int Hkv, int Dh, int bs,
                   int MB, cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(T, Hkv, (G + GT - 1) / GT);
  const size_t smem = sizeof(float) * kWarps * GT * (2 + Dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)Dh);
  paged_decode_kernel<GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(kc),
      static_cast<const uint16_t*>(vc), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<uint16_t*>(out),
      H, Hkv, Dh, bs, MB, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to contiguous
// tensors; the wrapper in ops/kernels/paged_attention.py checks shapes, types
// and alignment before calling. Returns cudaGetLastError() of the launch.
extern "C" int ds_paged_decode_attention_bf16(const void* q, const void* kc, const void* vc,
                                              const void* tables, const void* pos, void* out,
                                              int T, int H, int Hkv, int Dh, int bs, int MB,
                                              void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Dh % 8 != 0 || Dh <= 0 || Dh > 256 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (G == 1)
    err = launch<1>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else if (G == 2)
    err = launch<2>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else if (G <= 4)
    err = launch<4>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  else
    err = launch<kMaxHeads>(q, kc, vc, tables, pos, out, T, H, Hkv, Dh, bs, MB, s);
  return (int)err;
}
