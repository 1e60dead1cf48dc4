// Flash-decode on Hopper: one query token per sequence against a KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel).  Same function: for each sequence b
// and kv head h, the G query heads of the group attend to cache slots
// [0, length) with scale hd^-0.5, an fp32 online softmax (m, l, acc), l
// floored at 1e-30 and the output cast to q's dtype.
//
// What bounds it on the card: bytes.  Each cache slot is read once and used
// for G dot products and G axpys, so at G <= 8 the kernel does ~2G flops per
// byte read, far below the ~295 flop/byte ridge of an H100.  The design
// therefore only tries to keep many independent loads in flight:
//   * one thread block per (b, kv head, chunk of up to GT query heads);
//   * the block's kWarps warps stride over the slots below `length`, kUnroll
//     slots per step, so each warp has kUnroll K rows and kUnroll V rows in
//     flight before it touches its softmax state;
//   * lanes split the head dimension (lane l owns elements l, l+32, ...), so
//     a warp reads one cache row as HD/32 coalesced loads;
//   * every warp keeps its own running (m, l, acc) in registers; the warps
//     are combined once in shared memory, in a fixed order, so the result is
//     bit-reproducible from run to run.
// `length` is read from device memory: the decode loop keeps the cache
// cursor on the card and never synchronises with the host to launch this.
// Tensor cores, TMA and split-K across blocks are left for later work.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu
// The C entry point repro_decode_attention takes raw pointers and PyTorch's
// current stream; it launches, does not synchronise and returns the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMaxChunkElems = 1024;  // GT * HD, bounds shared memory at 32 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q [B*Hkv, G, HD], k/v [B*Hkv, C, HD], out like q; grid (B*Hkv, ceil(G/GT)).
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ length,
                        T* __restrict__ out, int G, int C, float scale) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  static_assert(GT * HD <= kMaxChunkElems, "chunk too large for shared memory");
  constexpr int EPL = HD / 32;  // head-dim elements per lane

  const int bh = blockIdx.x;
  const int g0 = blockIdx.y * GT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + (size_t)bh * G * HD;
  const T* kb = k + (size_t)bh * C * HD;
  const T* vb = v + (size_t)bh * C * HD;

  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = (g0 + g < G) ? to_f32(qb[(g0 + g) * HD + lane + 32 * e]) * scale : 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int n = max(0, min(*length, C));
  // The first slot of every step (c0) is below n, so m is finite after the
  // first step and exp(-inf - m) == 0 masks the padded tail slots.
  for (int c0 = warp; c0 < n; c0 += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kWarps;
      valid[u] = c < n;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = valid[u] ? to_f32(kb[(size_t)c * HD + lane + 32 * e]) : 0.f;
        vr[u][e] = valid[u] ? to_f32(vb[(size_t)c * HD + lane + 32 * e]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s[kUnroll];
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[u][e], d);
        d = warp_sum(d);
        s[u] = valid[u] ? d : -INFINITY;
        m_new = fmaxf(m_new, s[u]);
      }
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - m_new);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT * HD];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g * HD + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < GT * HD; i += blockDim.x) {
    const int g = i / HD;
    if (g0 + g >= G) continue;
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot has m == -inf and contributes nothing
      const float cw = sm_m[w][g] == -INFINITY ? 0.f : expf(sm_m[w][g] - big);
      den = fmaf(sm_l[w][g], cw, den);
      num = fmaf(sm_acc[w][i], cw, num);
    }
    out[(size_t)bh * G * HD + (size_t)(g0 + g) * HD + (i - g * HD)] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   void* out, int BH, int G, int C, float scale, cudaStream_t stream) {
  dim3 grid(BH, (G + GT - 1) / GT);
  decode_attention_kernel<T, HD, GT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      length, static_cast<T*>(out), G, C, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(int gt, const void* q, const void* k, const void* v,
                      const int* length, void* out, int BH, int G, int C, float scale,
                      cudaStream_t stream) {
  switch (gt) {
    case 1: return launch<T, HD, 1>(q, k, v, length, out, BH, G, C, scale, stream);
    case 2: return launch<T, HD, 2>(q, k, v, length, out, BH, G, C, scale, stream);
    case 4: return launch<T, HD, 4>(q, k, v, length, out, BH, G, C, scale, stream);
    default:
      if constexpr (8 * HD <= kMaxChunkElems) {
        return launch<T, HD, 8>(q, k, v, length, out, BH, G, C, scale, stream);
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int hd, int gt, const void* q, const void* k, const void* v,
                     const int* length, void* out, int BH, int G, int C, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(gt, q, k, v, length, out, BH, G, C, scale, stream);
    case 96: return launch_hd<T, 96>(gt, q, k, v, length, out, BH, G, C, scale, stream);
    case 128: return launch_hd<T, 128>(gt, q, k, v, length, out, BH, G, C, scale, stream);
    case 256: return launch_hd<T, 256>(gt, q, k, v, length, out, BH, G, C, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Query heads per block: as many of the group as fit one register/shared-
// memory chunk (GT * hd <= 1024, GT a power of two up to 8).
int chunk_heads(int G, int hd) {
  int gt = 8;
  while (gt > 1 && (gt > G || gt * hd > kMaxChunkElems)) gt >>= 1;
  return gt;
}

}  // namespace

// q [B, Hkv*G, hd], k/v [B, Hkv, C, hd] contiguous; length: one int32 on the
// device; dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* out, int B, int Hkv,
                                      int G, int C, int hd, int dtype, float scale,
                                      void* stream) {
  const int gt = chunk_heads(G, hd);
  const int BH = B * Hkv;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_t<float>(hd, gt, q, k, v, len, out, BH, G, C, scale, st);
  } else if (dtype == 1) {
    err = launch_t<__nv_bfloat16>(hd, gt, q, k, v, len, out, BH, G, C, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
