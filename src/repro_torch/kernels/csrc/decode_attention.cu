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
// byte read, far below the ~295 flop/byte ridge of an H100.  At the serving
// shape (B 4, 32 kv heads, C 1024, hd 96, bf16) the cache is 50 MB, 15 us at
// 3.35 TB/s, and (batch, kv head) pairs alone give 128 blocks for 132 SMs.
// So the design is split-K (flash-decoding), two launches a call:
//   * split pass: one block of 4 warps per (chunk of the cache, chunk of up
//     to GT query heads of the group, batch x kv head).  The chunk length is
//     chosen on the host from C alone (decode_attention.py's split_chunk,
//     never from `length`, the batch or the card), so a sequence's partials
//     and their order, and so its output bits, do not depend on the rest of
//     the batch; at the serving shape it gives 8 blocks an SM.  A block
//     writes its chunk's partial softmax (m, l, acc[hd]) in fp32 to a
//     workspace; a chunk at or past `length` writes the empty partial
//     (m = -1e30, l = 0, acc = 0);
//   * loads: a group of LPK lanes (8, or 4 for bf16 at hd 96) owns a key,
//     each lane loading 16-byte vectors of its K and V rows (the group's
//     lanes read contiguous 16-byte pieces), so a dot product reduces over
//     log2(LPK) shuffles and a warp reads whole rows of 32 / LPK keys per
//     load instruction.  A step takes U keys a group (1-4, as the row's
//     width allows), and the next step's rows are loaded into registers
//     while this step's are used.  The loads skip L1 and ask L2 for
//     256-byte blocks (ld.global.nc.L1::no_allocate.L2::256B: 18% off the
//     split pass in a same-call A/B, tools/kernel_ab.py);
//   * the softmax runs in the log2 domain: q is scaled by hd^-0.5 * log2(e)
//     as it is loaded, and every exponent is one ex2.approx.ftz;
//   * a block's key groups are combined by a fixed shfl_xor butterfly, its
//     warps in shared memory in a fixed order;
//   * merge pass: one block per (batch, q head), one thread per head-dim
//     element, combines the partials in chunk order and writes the output.
// No atomics: the same inputs (and card) give the same bits.  `length` is
// read from device memory: the decode loop keeps the cache cursor on the card
// and never synchronises with the host to launch this.
//
// The CUDA-core kernel this replaced (one block per batch x kv head, lanes
// splitting the head dimension) took 0.0504 ms at the serving shape against
// the split-K kernels' 0.0321 ms (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu
// The C entry points take raw pointers and PyTorch's current stream; they
// launch, do not synchronise and return the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------- split-K
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kEmpty = -1e30f;  // m of a partial that saw no slot
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// How a block reads a cache row of HD elements of T.
template <typename T, int HD>
struct Rows {
  static constexpr int VEC = 16 / sizeof(T);              // elements a 16-byte load
  static constexpr int LPK = (HD / VEC) % 8 ? 4 : 8;      // lanes a key
  static constexpr int NV = HD / VEC / LPK;               // loads a lane a row
  static constexpr int EPL = NV * VEC;                    // elements a lane
  static constexpr int U = NV >= 4 ? 1 : NV == 1 ? 4 : 2; // keys a group in flight
  // column of element e of lane `sub`: its loads take every LPK-th vector
  static __device__ __forceinline__ int col(int sub, int e) {
    return (sub + LPK * (e / VEC)) * VEC + e % VEC;
  }
  // a lane's accumulators (GT x EPL floats): 64, but 32 for fp32 at hd 256,
  // where 2 query heads a block spilled 132 bytes
  static constexpr int kAccs = sizeof(T) == 4 && HD == 256 ? 32 : 64;
  // query heads a block takes: the group rounded up to a power of two, as
  // far as kAccs allows
  static int heads(int G) {
    int gt = 1;
    while (gt < G && gt < 8 && 2 * gt * EPL <= kAccs) gt *= 2;
    return gt;
  }
};

// 16 bytes of the cache, read once: no L1 line, and L2 asked to fetch the
// whole 256-byte block around it (a group's next rows)
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void unpack(const uint4& r, float (&out)[4]) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float (&out)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The split pass.  q [B*Hkv, G, HD], k/v [B*Hkv, C, HD]; grid (splits,
// ceil(G/GT), B*Hkv).  Partials: ml [B*Hq, splits, 2] (m in the log2
// domain, l), acc [B*Hq, splits, HD].
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ length,
                              float* __restrict__ part_ml, float* __restrict__ part_acc, int G,
                              int C, int chunk, float scale) {
  using R = Rows<T, HD>;
  constexpr int VEC = R::VEC, LPK = R::LPK, NV = R::NV, EPL = R::EPL, U = R::U;
  constexpr int NG = kThreads / LPK;  // key groups a block
  static_assert(GT * EPL <= R::kAccs, "a lane's accumulators");

  const int split = blockIdx.x, splits = gridDim.x, g0 = blockIdx.y * GT, bh = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPK, grp = threadIdx.x / LPK;
  const int n = max(0, min(*length, C));
  const int c_begin = split * chunk, c_end = min(c_begin + chunk, n);
  const T* kb = k + static_cast<size_t>(bh) * C * HD;
  const T* vb = v + static_cast<size_t>(bh) * C * HD;

  // q scaled by hd^-0.5 * log2(e): scores come out in the log2 domain
  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = g0 + g < G ? to_f32(q[(static_cast<size_t>(bh) * G + g0 + g) * HD +
                                       R::col(sub, e)]) * (scale * kLog2e)
                            : 0.f;
    }
  }
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kEmpty;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // group grp takes keys c0 + grp + NG * u of a step
  auto load = [&](int c0, uint4 (&kr)[U][NV], uint4 (&vr)[U][NV], bool (&valid)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * NG + grp;
      valid[u] = c < c_end;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        const size_t at = static_cast<size_t>(c) * HD + (sub + LPK * j) * VEC;
        kr[u][j] = valid[u] ? load16(kb + at) : zero;
        vr[u][j] = valid[u] ? load16(vb + at) : zero;
      }
    }
  };
  uint4 kr[U][NV], vr[U][NV];
  bool valid[U];
  load(c_begin, kr, vr, valid);
  // every thread takes the same steps (the shuffles need the whole warp)
  for (int c0 = c_begin; c0 < c_end; c0 += NG * U) {
    uint4 kn[U][NV], vn[U][NV];
    bool valid_n[U];
    load(c0 + NG * U, kn, vn, valid_n);  // the next step's rows, in flight meanwhile
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s[U];
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float kf[VEC];
          unpack(kr[u][j], kf);
#pragma unroll
          for (int t = 0; t < VEC; ++t) dot = fmaf(qr[g][j * VEC + t], kf[t], dot);
        }
#pragma unroll
        for (int off = 1; off < LPK; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = valid[u] ? dot : -INFINITY;
        m_new = fmaxf(m_new, s[u]);
      }
      const float corr = ex2(m[g] - m_new);  // 1 while no slot was seen, m finite
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ex2(s[u] - m_new);  // 0 for a slot past the chunk
        l[g] += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          unpack(vr[u][j], vf);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[g][j * VEC + t] = fmaf(p, vf[t], acc[g][j * VEC + t]);
        }
      }
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      valid[u] = valid_n[u];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        kr[u][j] = kn[u][j];
        vr[u][j] = vn[u][j];
      }
    }
  }

  // the warp's key groups, by a fixed butterfly over the group bits
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = ex2(m[g] - mn), b = ex2(mo - mn);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * b;
      m[g] = mn;
    }
  }

  // then the block's warps, in order
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][HD];
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][R::col(sub, e)] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GT * HD; i += kThreads) {
    const int g = i / HD, col = i % HD;
    if (g0 + g >= G) continue;
    float big = kEmpty;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(sm_m[w][g] - big);
      den = fmaf(sm_l[w][g], c, den);
      num = fmaf(sm_acc[w][g][col], c, num);
    }
    const size_t at = (static_cast<size_t>(bh) * G + g0 + g) * splits + split;
    if (col == 0) {
      part_ml[2 * at] = big;
      part_ml[2 * at + 1] = den;
    }
    part_acc[at * HD + col] = num;
  }
}

// The merge pass: one block per (batch, q head) row, one thread per
// head-dim element; the partials in chunk order.
template <typename T>
__global__ void decode_attention_merge_kernel(const float* __restrict__ part_ml,
                                              const float* __restrict__ part_acc,
                                              T* __restrict__ out, int splits, int hd) {
  const size_t row = blockIdx.x;
  const int col = threadIdx.x;
  const float* ml = part_ml + row * splits * 2;
  float big = kEmpty;
  for (int s = 0; s < splits; ++s) big = fmaxf(big, ml[2 * s]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = ex2(ml[2 * s] - big);
    den = fmaf(ml[2 * s + 1], c, den);
    num = fmaf(part_acc[(row * splits + s) * hd + col], c, num);
  }
  out[row * hd + col] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int HD, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length, void* out,
                   float* ws, int BH, int G, int C, int chunk, float scale, cudaStream_t stream) {
  if constexpr (GT * Rows<T, HD>::EPL > Rows<T, HD>::kAccs) {
    return cudaErrorInvalidValue;
  } else {
    const int splits = (C + chunk - 1) / chunk;
    float* part_ml = ws;
    float* part_acc = ws + static_cast<size_t>(BH) * G * splits * 2;
    decode_attention_split_kernel<T, HD, GT>
        <<<dim3(splits, (G + GT - 1) / GT, BH), kThreads, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            length, part_ml, part_acc, G, C, chunk, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_attention_merge_kernel<T>
        <<<BH * G, HD, 0, stream>>>(part_ml, part_acc, static_cast<T*>(out), splits, HD);
    return cudaGetLastError();
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* length,
                      void* out, float* ws, int BH, int G, int C, int chunk, float scale,
                      cudaStream_t stream) {
  switch (Rows<T, HD>::heads(G)) {
    case 1: return launch<T, HD, 1>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 2: return launch<T, HD, 2>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 4: return launch<T, HD, 4>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 8: return launch<T, HD, 8>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int hd, const void* q, const void* k, const void* v, const int* length,
                     void* out, float* ws, int BH, int G, int C, int chunk, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 96: return launch_hd<T, 96>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, length, out, ws, BH, G, C, chunk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int heads_t(int hd, int G) {
  switch (hd) {
    case 64: return Rows<T, 64>::heads(G);
    case 96: return Rows<T, 96>::heads(G);
    case 128: return Rows<T, 128>::heads(G);
    case 256: return Rows<T, 256>::heads(G);
    default: return -1;
  }
}

}  // namespace split

}  // namespace

// q [B, Hkv*G, hd], k/v [B, Hkv, C, hd] contiguous, 16-byte aligned; length:
// one int32 on the device; dtype 0 = float32, 1 = bfloat16; chunk cache
// slots a split-pass block (decode_attention.py chooses it from C); ws:
// B*Hkv*G * ceil(C/chunk) * (2 + hd) floats of workspace.  The query heads a
// block takes are repro_decode_attention_heads'.  Two launches.  Returns the
// cudaError_t of the launches.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* out, void* ws, int B, int Hkv,
                                      int G, int C, int hd, int dtype, int chunk, float scale,
                                      void* stream) {
  const int* len = static_cast<const int*>(length);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = split::launch_t<float>(hd, q, k, v, len, out, w, B * Hkv, G, C, chunk, scale, st);
  } else if (dtype == 1) {
    err = split::launch_t<__nv_bfloat16>(hd, q, k, v, len, out, w, B * Hkv, G, C, chunk, scale,
                                         st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Query heads of a group that one split-pass block takes at (hd, dtype, G);
// -1 for a shape repro_decode_attention refuses.
extern "C" int repro_decode_attention_heads(int hd, int dtype, int G) {
  if (G <= 0) return -1;
  if (dtype == 0) return split::heads_t<float>(hd, G);
  if (dtype == 1) return split::heads_t<__nv_bfloat16>(hd, G);
  return -1;
}
