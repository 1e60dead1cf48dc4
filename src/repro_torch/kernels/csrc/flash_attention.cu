// Flash attention on Hopper, forward and backward, for the training path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  Same function: q [B,S,Hq,hd] and
// k/v [B,S,Hkv,hd] in fp32 or bf16, query head h reading kv head h / G
// (G = Hq / Hkv), scale hd^-0.5 applied to q in fp32, an fp32 online softmax,
// l floored at 1e-30, the output cast to q's dtype.  Masks: causal, causal
// with a sliding window (k_pos > q_pos - window), or none; positions are
// arange(S), as on the Pallas path.  The Pallas kernel is forward-only; the
// backward here is the standard flash-attention backward, checked against
// autograd of the plain version (kernels/ref.py::flash_attention_ref).
//
// What bounds it on the card: at the training shape (S = 1024, hd = 96) the
// work is operations (~4 S^2 hd / 2 flops a head against ~8 S hd bytes), so
// the bound is the tensor cores' rate.  This first version runs on the CUDA
// cores in fp32 (fp32 inputs have to stay fp32 to hold 2e-5), so it is far
// from that bound; the design only keeps the operands in shared memory and
// the output tile in registers:
//   * TPU: the k-block grid axis is sequential with (m, l, acc) in VMEM.
//     Here one thread block owns a (batch, q head, q tile) and loops over
//     the k tiles itself, from the window's first tile to the causal
//     diagonal, so no masked tile is read;
//   * 256 threads as a 16 x 16 grid: thread (ty, tx) computes rows
//     ty*RM .. ty*RM+RM-1 and columns tx, tx+16, ... of each score tile, and
//     columns tx, tx+16, ... of the output rows it owns (hd/16 of them, so
//     hd = 80 and 96 need no padding);
//   * tiles live in shared memory in fp32 with a row stride of hd+1, which
//     keeps the 16 column threads on 16 different banks;
//   * the 16 threads of a row reduce their maxima and sums with
//     __shfl_xor_sync in a fixed order: every result is bit-reproducible.
// The forward also writes the row log-sum-exp lse [B,Hq,S] (fp32), from
// which the backward recomputes P without a second softmax pass.
//
// The backward is two launches of this source, with no atomics:
//   * dkdv: one block per (batch, kv head, k tile) loops over the G query
//     heads of its group and over the q tiles that see the k tile,
//     accumulating dK and dV in registers;
//   * dq: one block per (batch, q head, q tile) loops over the k tiles like
//     the forward, accumulating dQ in registers.
// Each recomputes D = rowsum(dO * O) for the q rows it loads, and
// P = exp(s - lse).  Tensor cores (wgmma), TMA and a pipelined ring of tiles
// are later work.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The C entry points take raw pointers and PyTorch's current stream; they
// launch, do not synchronise and return the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kGrid = 16;

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

// Reductions over the 16 threads of one tile row (lanes that differ in their
// low four bits), in a fixed order.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] += sum_d A[(ty*RM + i) * lda + d] * B[(tx + 16 j) * ldb + d]
template <int RM, int CN, int HD>
__device__ __forceinline__ void tile_dot(const float* A, int lda, const float* B, int ldb,
                                         float (&acc)[RM][CN], int ty, int tx) {
  const float* a0 = A + ty * RM * lda;
  const float* b0 = B + tx * ldb;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = a0[i * lda + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = b0[j * kGrid * ldb + d];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][e] += sum_k P[(ty*RM + i) * ldp + k] * V[k * ldv + tx + 16 e], k < K
template <int RM, int EN, int K>
__device__ __forceinline__ void tile_pv(const float* P, int ldp, const float* V, int ldv,
                                        float (&acc)[RM][EN], int ty, int tx) {
  const float* p0 = P + ty * RM * ldp;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float p[RM], v[EN];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = p0[i * ldp + k];
#pragma unroll
    for (int e = 0; e < EN; ++e) v[e] = V[k * ldv + tx + kGrid * e];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int e = 0; e < EN; ++e) acc[i][e] = fmaf(p[i], v[e], acc[i][e]);
    }
  }
}

// rows [r0, r0 + R) of one head of a [B, S, H, HD] tensor (row stride
// H * HD) into shared memory [R][HD + 1] as fp32 times `mul`; rows >= S as 0.
template <typename T, int R, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t row_stride, int r0,
                                          int S, float mul) {
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    const int s = r0 + r;
    dst[r * (HD + 1) + c] = s < S ? to_f32(src[(size_t)s * row_stride + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ bool allowed(int qi, int kj, int S, int causal, int window) {
  bool ok = kj < S;
  if (causal) {
    ok = ok && kj <= qi;
    if (window > 0) ok = ok && kj > qi - window;
  }
  return ok;
}

// The k tiles a q tile [q0, q0 + BQ) sees.
__device__ __forceinline__ void k_tile_range(int q0, int BQ, int BK, int S, int causal,
                                             int window, int* lo, int* hi) {
  int k_lo = 0, k_hi = S;
  if (causal) {
    k_hi = min(S, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  *lo = k_lo / BK;
  *hi = (k_hi + BK - 1) / BK;
}

// ---------------------------------------------------------------- forward
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Hq, int Hkv,
                 int causal, int window, float scale) {
  constexpr int RM = BQ / kGrid, CN = BK / kGrid, EN = HD / kGrid;
  constexpr int LD = HD + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;          // [BQ][LD], q * scale
  float* Ks = Qs + BQ * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;  // [BK][LD]
  float* Ps = Vs + BK * LD;  // [BQ][LP]

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const size_t qs = (size_t)Hq * HD, ks = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * qs + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * ks + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * ks + (size_t)hk * HD;

  load_rows<T, BQ, HD>(Qs, qb, qs, q0, S, scale);

  float m[RM], lsum[RM], acc[RM][EN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -1e30f;  // finite: a fully masked tile leaves m, l and acc as they are
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EN; ++e) acc[i][e] = 0.f;
  }

  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_rows<T, BK, HD>(Ks, kb, ks, k0, S, 1.f);
    load_rows<T, BK, HD>(Vs, vb, ks, k0, S, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    }
    tile_dot<RM, CN, HD>(Qs, LD, Ks, LD, s, ty, tx);

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        if (!allowed(qi, k0 + tx + kGrid * j, S, causal, window)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      lsum[i] *= corr;
#pragma unroll
      for (int e = 0; e < EN; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 where masked
        lsum[i] += p;
        Ps[(ty * RM + i) * LP + tx + kGrid * j] = p;
      }
    }
    __syncthreads();
    tile_pv<RM, EN, BK>(Ps, LP, Vs, LD, acc, ty, tx);
  }

  T* ob = o + (size_t)b * S * qs + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    const float l = fmaxf(row_sum(lsum[i]), 1e-30f);
    if (qi < S) {
#pragma unroll
      for (int e = 0; e < EN; ++e) ob[(size_t)qi * qs + tx + kGrid * e] = from_f32<T>(acc[i][e] / l);
      if (tx == 0) lse[((size_t)b * Hq + h) * S + qi] = m[i] + logf(l);
    }
  }
}

// D[r] = sum_c dO[r][c] * O[r][c] for rows [r0, r0 + R), one warp a row;
// lse of those rows beside it (0 past S).
template <typename T, int R, int HD>
__device__ __forceinline__ void load_row_stats(float* Ds, float* Ls, const T* dob, const T* ob,
                                               const float* lseb, size_t row_stride, int r0,
                                               int S) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kThreads / 32) {
    const int s = r0 + r;
    float d = 0.f;
    if (s < S) {
      for (int c = lane; c < HD; c += 32)
        d = fmaf(to_f32(dob[(size_t)s * row_stride + c]), to_f32(ob[(size_t)s * row_stride + c]), d);
    }
    d = warp_sum(d);
    if (lane == 0) {
      Ds[r] = d;
      Ls[r] = s < S ? lseb[s] : 0.f;
    }
  }
}

// ------------------------------------------------------- backward: dK, dV
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const float* __restrict__ lse, const T* __restrict__ dout,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int Hq, int Hkv,
                      int causal, int window, float scale) {
  constexpr int RM = BK / kGrid, CN = BQ / kGrid, EN = HD / kGrid;
  constexpr int LD = HD + 1, LQ = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;           // [BK][LD]
  float* Vs = Ks + BK * LD;   // [BK][LD]
  float* Qs = Vs + BK * LD;   // [BQ][LD], q * scale
  float* dOs = Qs + BQ * LD;  // [BQ][LD]
  float* Pt = dOs + BQ * LD;  // [BK][LQ], P transposed
  float* dSt = Pt + BK * LQ;  // [BK][LQ], dS transposed
  float* Ds = dSt + BK * LQ;  // [BQ]
  float* Ls = Ds + BQ;        // [BQ]

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = Hq / Hkv;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const size_t qs = (size_t)Hq * HD, ks = (size_t)Hkv * HD;

  load_rows<T, BK, HD>(Ks, k + (size_t)b * S * ks + (size_t)hk * HD, ks, k0, S, 1.f);
  load_rows<T, BK, HD>(Vs, v + (size_t)b * S * ks + (size_t)hk * HD, ks, k0, S, 1.f);

  float dk_acc[RM][EN], dv_acc[RM][EN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int e = 0; e < EN; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  // the q rows that see keys [k0, k0 + BK)
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + BK - 1 + window);
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t head = (size_t)b * S * qs + (size_t)h * HD;
    const float* lseb = lse + ((size_t)b * Hq + h) * S;
    for (int qt = q_lo / BQ; qt < (q_hi + BQ - 1) / BQ; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile is consumed
      load_rows<T, BQ, HD>(Qs, q + head, qs, q0, S, scale);
      load_rows<T, BQ, HD>(dOs, dout + head, qs, q0, S, 1.f);
      load_row_stats<T, BQ, HD>(Ds, Ls, dout + head, o + head, lseb, qs, q0, S);
      __syncthreads();

      float st[RM][CN], dpt[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < CN; ++j) st[i][j] = dpt[i][j] = 0.f;
      }
      tile_dot<RM, CN, HD>(Ks, LD, Qs, LD, st, ty, tx);
      tile_dot<RM, CN, HD>(Vs, LD, dOs, LD, dpt, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kj = k0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int c = tx + kGrid * j;
          const int qi = q0 + c;
          const bool ok = qi < S && allowed(qi, kj, S, causal, window);
          const float p = ok ? expf(st[i][j] - Ls[c]) : 0.f;
          Pt[(ty * RM + i) * LQ + c] = p;
          dSt[(ty * RM + i) * LQ + c] = p * (dpt[i][j] - Ds[c]);
        }
      }
      __syncthreads();
      tile_pv<RM, EN, BQ>(Pt, LQ, dOs, LD, dv_acc, ty, tx);
      tile_pv<RM, EN, BQ>(dSt, LQ, Qs, LD, dk_acc, ty, tx);
    }
  }

  T* dkb = dk + (size_t)b * S * ks + (size_t)hk * HD;
  T* dvb = dv + (size_t)b * S * ks + (size_t)hk * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty * RM + i;
    if (kj < S) {
#pragma unroll
      for (int e = 0; e < EN; ++e) {
        dkb[(size_t)kj * ks + tx + kGrid * e] = from_f32<T>(dk_acc[i][e]);
        dvb[(size_t)kj * ks + tx + kGrid * e] = from_f32<T>(dv_acc[i][e]);
      }
    }
  }
}

// ------------------------------------------------------------ backward: dQ
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dq, int S, int Hq, int Hkv,
                    int causal, int window, float scale) {
  constexpr int RM = BQ / kGrid, CN = BK / kGrid, EN = HD / kGrid;
  constexpr int LD = HD + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][LD], q * scale
  float* dOs = Qs + BQ * LD;  // [BQ][LD]
  float* Ks = dOs + BQ * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;   // [BK][LD]
  float* dSs = Vs + BK * LD;  // [BQ][LP]
  float* Ds = dSs + BQ * LP;  // [BQ]
  float* Ls = Ds + BQ;        // [BQ]

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const size_t qs = (size_t)Hq * HD, ks = (size_t)Hkv * HD;
  const size_t head = (size_t)b * S * qs + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * ks + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * ks + (size_t)hk * HD;

  load_rows<T, BQ, HD>(Qs, q + head, qs, q0, S, scale);
  load_rows<T, BQ, HD>(dOs, dout + head, qs, q0, S, 1.f);
  load_row_stats<T, BQ, HD>(Ds, Ls, dout + head, o + head, lse + ((size_t)b * Hq + h) * S, qs,
                            q0, S);

  float acc[RM][EN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int e = 0; e < EN; ++e) acc[i][e] = 0.f;
  }

  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, BK, HD>(Ks, kb, ks, k0, S, 1.f);
    load_rows<T, BK, HD>(Vs, vb, ks, k0, S, 1.f);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    tile_dot<RM, CN, HD>(Qs, LD, Ks, LD, s, ty, tx);
    tile_dot<RM, CN, HD>(dOs, LD, Vs, LD, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + kGrid * j;
        const bool ok = qi < S && allowed(qi, kj, S, causal, window);
        const float p = ok ? expf(s[i][j] - Ls[r]) : 0.f;
        dSs[r * LP + tx + kGrid * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    tile_pv<RM, EN, BK>(dSs, LP, Ks, LD, acc, ty, tx);
  }

  T* dqb = dq + head;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi < S) {
#pragma unroll
      for (int e = 0; e < EN; ++e)
        dqb[(size_t)qi * qs + tx + kGrid * e] = from_f32<T>(acc[i][e] * scale);
    }
  }
}

// ---------------------------------------------------------------- launches
// Tiles: 64 x 64 up to hd 128; 32 x 32 at hd 256, where a 64-row fp32 tile
// would not leave room for the others in 227 KB.
template <int HD>
struct Tile {
  static constexpr int B = HD > 128 ? 32 : 64;
};

template <int HD>
constexpr size_t fwd_smem() {
  constexpr int B = Tile<HD>::B;
  return sizeof(float) * (3 * B * (HD + 1) + B * (B + 1));
}
template <int HD>
constexpr size_t dkdv_smem() {
  constexpr int B = Tile<HD>::B;
  return sizeof(float) * (4 * B * (HD + 1) + 2 * B * (B + 1) + 2 * B);
}
template <int HD>
constexpr size_t dq_smem() {
  constexpr int B = Tile<HD>::B;
  return sizeof(float) * (4 * B * (HD + 1) + B * (B + 1) + 2 * B);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BT = Tile<HD>::B;
  auto kernel = flash_fwd_kernel<T, HD, BT, BT>;
  cudaError_t err = allow_smem(kernel, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, B * Hq);
  kernel<<<grid, kThreads, fwd_smem<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
                int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BT = Tile<HD>::B;
  auto dkdv = flash_bwd_dkdv_kernel<T, HD, BT, BT>;
  auto dqk = flash_bwd_dq_kernel<T, HD, BT, BT>;
  cudaError_t err = allow_smem(dkdv, dkdv_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(dqk, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  dim3 grid_kv((S + BT - 1) / BT, B * Hkv);
  dkdv<<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(
      qt, kt, vt, ot, lt, dot, static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((S + BT - 1) / BT, B * Hq);
  dqk<<<grid_q, kThreads, dq_smem<HD>(), stream>>>(qt, kt, vt, ot, lt, dot, static_cast<T*>(dq),
                                                    S, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

#define REPRO_HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(256)

}  // namespace

// q [B, S, Hq, hd], k/v [B, S, Hkv, hd], o like q, lse [B, Hq, S] fp32, all
// contiguous; dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int B, int S, int Hq, int Hkv, int hd,
                                         int dtype, int causal, int window, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(HD)                                                                      \
  if (hd == HD) {                                                                          \
    if (dtype == 0) return (int)fwd<float, HD>(q, k, v, o, lse, B, S, Hq, Hkv, causal,     \
                                               window, scale, st);                        \
    if (dtype == 1) return (int)fwd<__nv_bfloat16, HD>(q, k, v, o, lse, B, S, Hq, Hkv,     \
                                                       causal, window, scale, st);        \
  }
  REPRO_HEAD_DIMS(REPRO_FWD)
#undef REPRO_FWD
  return (int)cudaErrorInvalidValue;
}

// The backward: dq like q, dk/dv like k; one call launches the dK/dV pass
// and then the dQ pass on the stream.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, int B, int S, int Hq,
                                         int Hkv, int hd, int dtype, int causal, int window,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(HD)                                                                      \
  if (hd == HD) {                                                                          \
    if (dtype == 0) return (int)bwd<float, HD>(q, k, v, o, lse, dout, dq, dk, dv, B, S, Hq, \
                                               Hkv, causal, window, scale, st);           \
    if (dtype == 1) return (int)bwd<__nv_bfloat16, HD>(q, k, v, o, lse, dout, dq, dk, dv,  \
                                                       B, S, Hq, Hkv, causal, window,      \
                                                       scale, st);                        \
  }
  REPRO_HEAD_DIMS(REPRO_BWD)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
