// Flash attention on Hopper, forward and backward, for the training path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  Same function: q [B,S,Hq,hd] and
// k/v [B,S,Hkv,hd] in fp32 or bf16, query head h reading kv head h / G
// (G = Hq / Hkv), scale hd^-0.5, an fp32 online softmax, l floored at 1e-30,
// the output cast to q's dtype.  Masks: causal, causal with a sliding
// window (k_pos > q_pos - window), or none; positions are arange(S), as on
// the Pallas path.  The Pallas kernel is forward-only; the backward here is
// the standard flash-attention backward, checked against autograd of the
// plain version (kernels/ref.py::flash_attention_ref).  The forward also
// writes the row log-sum-exp lse [B,Hq,S] (fp32), from which the backward
// recomputes P without a second softmax pass.
//
// What bounds it on the card: at the training shape (S = 1024, hd = 96) the
// work is operations (~4 S^2 hd / 2 flops a head forward, 10 S^2 hd / 2
// backward, against ~8 S hd bytes), so the bound is the tensor cores' rate.
// Three designs, chosen per call by flash_attention.py's route() before the
// launch:
//
// "wgmma" -- bf16 at hd 64, 80, 96, 128 or 256 with 16-byte aligned
// pointers (TMA's rules):
//   * TMA reads 4-D tensor maps (hd, H, S, B) laid straight on the
//     [B,S,H,hd] tensors, in boxes of 64 columns x 1 head x R rows,
//     128B-swizzled; no transposed copies.  TMA fills rows past S and
//     columns past hd with zeros, so ragged S needs no masked loads, and hd
//     80 and 96 are two boxes, the second partly zeros (the products over
//     the head dim skip the zero k16 steps; P V and the gradients run at
//     N = 128);
//   * forward: one block per (batch, q head, 128 q rows): two consumer
//     warpgroups of 64 rows (wgmma's M) and a producer warp (setmaxnreg 232
//     / 40).  Q arrives once; K and V tiles of 128 keys through a 2-stage
//     mbarrier ring, K and V on barriers of their own so that Q K^T starts
//     before V lands.  S = Q K^T with both operands K-major from shared
//     memory; the scale hd^-0.5 goes on the fp32 scores, folded with
//     log2(e) into the FMA that feeds each exponent; masks only on tiles
//     that hold a disallowed pair (the diagonal, the window's edge, keys
//     past S); the online softmax runs on the accumulator fragments in the
//     log2 domain, each row's four lanes reducing with shfl_xor in a fixed
//     order; P is packed to bf16 in registers, which is the A fragment
//     layout of a register-A wgmma, and O += P V reads V in place as the
//     MN-major B operand (imm-trans-b = 1);
//   * exponents are one ex2.approx.ftz each on the special-function unit:
//     the softmax, not the tensor cores, is the long pole of these kernels,
//     and exp2f without fast math costs several instructions more per
//     score;
//   * backward: three launches, no atomics.  D = rowsum(dO * O) [B,Hq,S]
//     fp32, once.  dK/dV: one block per (batch, kv head, 128 keys) keeps K
//     and V in shared memory and streams 64-row Q and dO tiles (with lse
//     and D, which the producer warp's lanes copy beside them) over the G
//     query heads of the group and the q tiles that see the keys; S^T =
//     K Q^T and dP^T = V dO^T on wgmma, P^T = exp(S^T scale - lse),
//     dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q with A from
//     registers and B MN-major.  dQ: one block per (batch, q head, 128 q
//     rows) keeps Q and dO and streams 64-key K and V tiles: S, dP, dS and
//     dQ += dS K; dK and dQ are scaled once at the end.  The two passes
//     recompute S and dP each: 14 hd flops a (q, k) pair against the 10 hd
//     of one pass with an atomic dQ, paid for gradients that are the same
//     bits on every run (train_full compares replicas bit for bit);
//   * stores are bf16 pairs straight from the accumulators to global
//     memory, masked at the edges;
//   * hd 256 (gemma3-4b): a row is four boxes, and an accumulator over the
//     head dim (O, dQ, dK, dV) is 128 fp32 registers a thread, held as two
//     128-column chunks, one wgmma of N = 128 each.  Tiles shrink so that
//     two stages fit 227 KB (fwd_bk, kv_bk, dq_bk): the forward streams
//     64-key K and V tiles (192 KB), the dQ pass 32-key tiles (192 KB), and
//     consumers take setmaxnreg 240 (the producer 24).  dK and dV of 64 keys
//     (256 registers a thread) do not fit one warpgroup, so the dK/dV pass
//     gives both warpgroups the block's 64 keys: warpgroup 0 computes S^T,
//     P^T and dV, warpgroup 1 dP^T, dS^T and dK, P^T passing between them
//     through shared memory (flash_wgmma_dkdv_split_kernel): the same four
//     products a pair, no atomics.  At gemma3-4b's shapes the grid is one
//     wave (128 blocks), so a causal mask leaves the longest block twice the
//     mean block's work.
// "tf32x3" -- fp32 at hd 64, 80, 96 or 128 with 16-byte aligned pointers
// (replaces the simt kernels below for these shapes; the Pallas kernel's
// fp32 path is the same function; hd 256 takes the design of namespace x3w
// below, wgmma on split planes):
//   * why three products: fp32 inputs have to hold 2e-5 (outputs) and 1e-4
//     (gradients), and one TF32 product (10-bit mantissas) misses that by
//     two orders of magnitude.  Each operand x is split once into hi =
//     tf32(x) (cvt.rna) and lo = tf32(x - hi), and each product is
//     a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 products into one fp32
//     accumulator in that fixed order; the dropped a_lo b_lo is ~2^-22 of
//     the product, so the result is as close to fp32 as fp32 FMAs are;
//   * the bound: 3 TF32 products per counted flop at the dense TF32 rate
//     (495 TFLOP/s), 165 TFLOP/s of fp32-accurate work, against the CUDA
//     cores' 67; mma.sync itself peaks near two thirds of the dense rate
//     (tools/mma_sync_ceiling.py);
//   * mma.sync.m16n8k8.tf32, not wgmma: wgmma takes a TF32 B operand from
//     shared memory K-major only, and P V, P^T dO, dS^T Q and dS K have
//     their B MN-major as [B, S, H, hd] lays it out; mma.sync's fragments
//     are loaded by the threads (ldmatrix where the layout allows), so any
//     layout serves;
//   * tiles are split once into hi and lo planes as they enter shared
//     memory, rows hd + 4 floats apart so that fragment loads hit 32 banks;
//   * P and dS are split in registers.  The fragment permutation: the m16n8
//     accumulator holds columns 2t and 2t + 1 of each 8-column block, the
//     A fragment wants columns t and t + 4.  A product reduced over those
//     8 columns may take them in any order A and B agree on, so A takes
//     the accumulator registers as they are (c0, c2, c1, c3) and B reads
//     rows 2t and 2t + 1 of V (dO, Q, K) where it would read rows t and
//     t + 4: no shuffle;
//   * the tensor cores' fp32 accumulation truncates.  The products that
//     sum over a streamed dimension (P V, P^T dO, dS^T Q, dS K) take each
//     tile in a fresh accumulator and add it to the running sum with IEEE
//     adds: one accumulator over 5,120 q rows (dV at S 1024, G 5) drifted
//     by more than 1e-4;
//   * forward: one block per (batch, q head, 64 q rows), 4 warps of 16 rows,
//     two blocks an SM; K and V tiles of 32 keys (16 at hd 128) loaded into
//     registers one tile ahead; the online softmax on the accumulator
//     fragments as on the wgmma route (log2 domain, one ex2.approx.ftz per
//     score fed by an FMA that folds scale * log2(e), fixed-order shfl_xor
//     reductions, masks only on tiles that hold a disallowed pair, masked
//     tiles skipped);
//   * backward: D = rowsum(dO * O) once in a launch of its own (shared with
//     the wgmma route), then a dK/dV pass (64 keys resident, Q and dO tiles
//     streamed over the G heads of the group) and a dQ pass (64 q rows
//     resident, K and V tiles streamed), each recomputing S and dP; all
//     five products on 3xTF32; no atomics.  The passes' planes fill shared
//     memory for one block an SM, so a block has 8 warps: warps w and w + 4
//     share 16 resident rows, take half of each streamed tile (staged by
//     cp.async) and add their two partial sums once at the end.  At hd 128
//     dK and dV together do not fit the registers: the dK/dV pass runs as
//     two launches, dV and then dK.
// "simt" -- tensors the other routes cannot load (misaligned pointers):
// fp32 FMAs on the CUDA cores, the operands in shared memory and the output
// tile in registers:
//   * TPU: the k-block grid axis is sequential with (m, l, acc) in VMEM.
//     Here one thread block owns a (batch, q head, q tile) and loops over
//     the k tiles itself, from the window's first tile to the causal
//     diagonal, so no masked tile is read;
//   * 256 threads as a 16 x 16 grid: thread (ty, tx) computes rows
//     ty*RM .. ty*RM+RM-1 and columns tx, tx+16, ... of each score tile, and
//     columns tx, tx+16, ... of the output rows it owns (hd/16 of them, so
//     hd = 80 and 96 need no padding);
//   * tiles live in shared memory in fp32 with a row stride of hd+1, which
//     keeps the 16 column threads on 16 different banks; q is scaled by
//     hd^-0.5 in fp32 as it is loaded;
//   * the 16 threads of a row reduce their maxima and sums with
//     __shfl_xor_sync in a fixed order: every result is bit-reproducible;
//   * the backward is two launches with no atomics: dkdv, one block per
//     (batch, kv head, k tile), loops over the G query heads of its group
//     and the q tiles that see the k tile, accumulating dK and dV in
//     registers; dq, one block per (batch, q head, q tile), loops over the k
//     tiles like the forward.  Each recomputes D = rowsum(dO * O) for the q
//     rows it loads, and P = exp(s - lse).
//
// "tf32x3" at hd 256 (gemma3-4b in fp32) -- namespace x3w: a split pass
// writes hi/lo planes (some transposed) into a per-call workspace, then
// wgmma TF32 takes them by TMA, three products a product; its header
// comment has the design.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The C entry points take raw pointers and PyTorch's current stream; they
// launch, do not synchronise and return the CUDA error.  The wgmma entry
// points encode their TMA descriptors on the host (hopper.cuh).  Each
// tensor-core route has a one-tile probe entry point that checks its
// fragment layouts against a matrix product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// dQ = scale * sum_j dS_ij (k_j - c) for kmean's c, the keys' mean over the
// sequence ([B, Hkv, HD] in T), as in the wgmma dQ pass: the same gradient,
// since sum_j dS_ij is zero in exact arithmetic, but D = rowsum(dO O) comes
// from the rounded O, so that sum is not zero, and times keys that share a
// large common component it costs dq a few percent of its largest value.
// Each row's sum of dS is kept in fp32 (its 16 lanes reduced in a fixed
// order) and r_i c subtracted before the store.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const float* __restrict__ lse,
                    const T* __restrict__ dout, const T* __restrict__ kmean,
                    T* __restrict__ dq, int S, int Hq, int Hkv, int causal, int window,
                    float scale) {
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

  float acc[RM][EN], rs[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    rs[i] = 0.f;
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
        const float ds = p * (dp[i][j] - Ds[r]);
        dSs[r * LP + tx + kGrid * j] = ds;
        rs[i] += ds;
      }
    }
    __syncthreads();
    tile_pv<RM, EN, BK>(dSs, LP, Ks, LD, acc, ty, tx);
  }

  // dQ -= r c: the row's 16 lanes hold its partial sums of dS
  const T* c = kmean + ((size_t)b * Hkv + hk) * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) rs[i] = row_sum(rs[i]);
  T* dqb = dq + head;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi < S) {
#pragma unroll
      for (int e = 0; e < EN; ++e) {
        const int col = tx + kGrid * e;
        dqb[(size_t)qi * qs + col] =
            from_f32<T>(fmaf(-rs[i], to_f32(c[col]), acc[i][e]) * scale);
      }
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
                const void* dout, void* dq, void* dk, void* dv, const void* kmean, int B, int S,
                int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
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
  dqk<<<grid_q, kThreads, dq_smem<HD>(), stream>>>(qt, kt, vt, ot, lt, dot,
                                                    static_cast<const T*>(kmean),
                                                    static_cast<T*>(dq), S, Hq, Hkv, causal,
                                                    window, scale);
  return cudaGetLastError();
}

// ------------------------------------------- backward: D = rowsum(dO * O)
// The first launch of both tensor-core backwards.  Eight lanes a row of
// [B, S, Hq, hd], in memory order, 16 bytes a load, each pair of elements
// folded in the same order in either dtype; D is [B, Hq, S] fp32.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                   int rows, int S, int Hq) {
  constexpr int kVec = 16 / sizeof(T);
  const int r = blockIdx.x * 32 + threadIdx.x / 8, sub = threadIdx.x % 8;
  float d = 0.f;
  if (r < rows) {
    const size_t at = static_cast<size_t>(r) * HD;
#pragma unroll
    for (int c = kVec * sub; c < HD; c += 8 * kVec) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + at + c);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + at + c);
      const T* xp = reinterpret_cast<const T*>(&x);
      const T* yp = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < kVec; e += 2)
        d = fmaf(to_f32(xp[e]), to_f32(yp[e]), fmaf(to_f32(xp[e + 1]), to_f32(yp[e + 1]), d));
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 4);
  if (r < rows && sub == 0) {
    const int bs = r / Hq, h = r % Hq;
    delta[(static_cast<size_t>(bs / S) * Hq + h) * S + bs % S] = d;
  }
}

// ------------------------------------------------------------ wgmma route
namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;  // warpgroups of 64 rows each; warpgroup 2 loads
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;     // ring depth of the streamed tiles
constexpr int kFwdBQ = 128;    // forward: q rows per block
constexpr int kKvBQ = 64;      // dK/dV pass: q rows per streamed tile
constexpr int kDqBQ = 128;     // dQ pass: q rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles that depend on the head dim.  At hd 256 a row is 512 bytes, so a
// 128-row tile is 64 KB: the forward streams 64-key K and V tiles (Q 64 KB
// + 2 stages x 64 KB), the dQ pass 32-key tiles (Q and dO 128 KB + 2 stages
// x 32 KB), and the dK/dV pass holds 64 keys (K and V 64 KB + 2 stages of
// 64-row Q and dO tiles, 128 KB, + P^T 16 KB), all within 227 KB.
__host__ __device__ constexpr int fwd_bk(int hd) { return hd > 128 ? 64 : 128; }
__host__ __device__ constexpr int kv_bk(int hd) { return hd > 128 ? 64 : 128; }
__host__ __device__ constexpr int dq_bk(int hd) { return hd > 128 ? 32 : 64; }
// Registers a thread (setmaxnreg) of the consumer warpgroups and of the
// producer's: hd 256's accumulators, 128 fp32 registers a thread, take 240,
// which leaves the producer 24 of the block's 64K.
__host__ __device__ constexpr int consumer_regs(int hd) { return hd > 128 ? 240 : 232; }
__host__ __device__ constexpr int producer_regs(int hd) { return hd > 128 ? 24 : 40; }
// An accumulator over the head dim (O, dQ, and dK or dV at hd 256) as
// chunks of at most 128 columns, one wgmma of N <= 128 each.
__host__ __device__ constexpr int acc_chunks(int hd) { return hd > 128 ? 2 : 1; }

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d[64x32] (+)= A[64x16] * B[16x32], both K-major in shared memory (the dQ
// pass's S and dP at hd 256); d is overwritten when scale_d is 0.
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64x64] (+)= A[64x16] * B[16x64], both K-major in shared memory;
// d is overwritten when scale_d is 0.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64x128] (+)= A[64x16] * B[16x128], both K-major in shared memory;
// d is overwritten when scale_d is 0.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64x64] += A[64x16] * B[16x64]: A in registers (bf16 pairs in the
// accumulator layout), B MN-major in shared memory (imm-trans-b = 1).
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d[64x128] += A[64x16] * B[16x128]: A in registers (bf16 pairs in the
// accumulator layout), B MN-major in shared memory (imm-trans-b = 1).
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// Keep the compiler from reusing a register A fragment before the wgmma
// that reads it has completed.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x on the special-function unit, one instruction (denormal results
// flush to zero, far below what a bf16 probability can hold).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fetch a tensor map's descriptor ahead of its first TMA load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A tile of R rows of one head of a [B, S, H, hd] tensor lies in shared
// memory as HDP / 64 TMA boxes of R rows x 64 columns (128 bytes a row,
// 128B-swizzled), box after box; HDP is hd rounded up to 64 or 128, and the
// columns past hd are TMA's zeros.
__host__ __device__ constexpr int n_boxes(int hd) { return hd > 128 ? 4 : hd > 64 ? 2 : 1; }

template <int HD, int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return n_boxes(HD) * R * 128;
}

template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b) {
#pragma unroll
  for (int nb = 0; nb < n_boxes(HD); ++nb)
    tma_load_4d(dst + nb * R * 128, map, bar, 64 * nb, head, row0, b);
}

// K-major operand (A or B of a product reduced over the head dim): rows
// row0.. of an R-row tile, k16 step kk of the head dim (32 bytes of a box
// row); 8-row groups 1 KB apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return desc(tile + (kk / 4) * (R * 128) + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand (a product reduced over the tile's R rows, N = the
// head dim): k16 step kk of the rows (2 KB); the leading offset steps
// between the 64-column boxes along N, the stride offset between 8-row
// groups.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, R * 128, 1024);
}

// acc += A B for k16 step kk of a product reduced over an R-row tile: A from
// registers (a[4 kk] .. a[4 kk + 3]), B the tile, MN-major, its columns (the
// head dim) split over the accumulator's NC chunks of 2 AW columns, chunk c
// reading the boxes from c * 2 AW / 64 on.
template <int R, int NC, int AW, int NA>
__device__ __forceinline__ void mma_rs_chunks(float (&acc)[NC][AW], const uint32_t (&a)[NA],
                                              uint32_t tile, int kk) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    mma_rs(acc[c], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
           mnmajor<R>(tile + c * AW * R * 4, kk));
}

template <int NC, int AW>
__device__ __forceinline__ void fence_chunks(float (&acc)[NC][AW]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
}

// Store a [64 x HD] accumulator (NC chunks, accumulator layout) as bf16
// pairs into rows row0 and row0 + 8 of a [., row_stride] tensor at `out`,
// row row0 + 8 hh times mul[hh]; rows from S on and columns from HD on
// skipped.
template <int HD, int NC, int AW>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, size_t row_stride, int row0,
                                          int col0, int S, const float (&acc)[NC][AW],
                                          const float (&mul)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < AW / 4; ++j) {
        const int col = c * 2 * AW + 8 * j + col0;
        if (col < HD)
          *reinterpret_cast<__nv_bfloat162*>(out + row * row_stride + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * hh] * mul[hh],
                                    acc[c][4 * j + 2 * hh + 1] * mul[hh]);
      }
    }
  }
}

// Named barriers between the two consumer warpgroups (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}

// Whether a tile pair [q0, q0 + bq) x [k0, k0 + bk) holds a disallowed
// (q, k) pair or a position past S: only such tiles apply masks.
__device__ __forceinline__ bool needs_mask(int q0, int bq, int k0, int bk, int S, int causal,
                                           int window) {
  return q0 + bq > S || k0 + bk > S ||
         (causal && (k0 + bk - 1 > q0 || (window > 0 && q0 + bq - 1 - k0 >= window)));
}

// Accumulator i of a thread of a consumer warpgroup: row 16 * warp + lane / 4
// + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.  Packing
// pairs (2j, 2j + 1) to bf16 gives register j of the A fragment of a
// register-A wgmma, registers 4kk .. 4kk + 3 for its k16 step kk.

// ---------------------------------------------------------------- forward
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int Hq,
                       int Hkv, int causal, int window, float scale_log2) {
  constexpr int BQ = kFwdBQ, BK = fwd_bk(HD), HDP = 64 * n_boxes(HD);
  constexpr int NC = acc_chunks(HD), AW = HDP / NC / 2;
  constexpr uint32_t kQ = tile_bytes<HD, BQ>(), kKV = tile_bytes<HD, BK>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  auto k_tile = [&](int s) { return base + kQ + s * kKV; };
  auto v_tile = [&](int s) { return base + kQ + (kStages + s) * kKV; };
  const uint32_t bars = base + kQ + 2 * kStages * kKV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // causal: the q tiles with the most k tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);
  const int n = kt_hi - kt_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread loads Q once, then K and V tiles into the ring
    regs_dec<producer_regs(HD)>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, kQ);
      load_tile<HD, BQ>(q_tile, &map_q, q_full, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const uint32_t ph = ((it / kStages) & 1) ^ 1;  // the first round passes at once
        const int k0 = (kt_lo + it) * BK;
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), kKV);
        load_tile<HD, BK>(k_tile(s), &map_k, k_full(s), hk, k0, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), kKV);
        load_tile<HD, BK>(v_tile(s), &map_v, v_full(s), hk, k0, b);
      }
    }
  } else {
    // ---- consumers: q rows q0 + 64 wg .. q0 + 64 wg + 63
    regs_inc<consumer_regs(HD)>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
    const int col0 = 2 * (lane % 4);
    float m[2] = {-1e30f, -1e30f};  // finite: a fully masked row leaves m, l and acc as they are
    float l[2] = {0.f, 0.f};
    float acc[NC][AW];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < AW; ++i) acc[c][i] = 0.f;
    }

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kt_lo + it) * BK;

      // S = Q K^T: A = Q, B = K, both K-major (the head dim is contiguous)
      float sc[BK / 2];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(sc, kmajor<BQ>(q_tile, wg * 64, kk), kmajor<BK>(k_tile(s), 0, kk), kk);
      wgmma_commit_wait();
      fence_acc(sc);
      if (threadIdx.x % 128 == 0) mbar_arrive(k_empty(s));

      // masks only on tiles that hold a disallowed pair (the diagonal, the
      // window's edge, keys past S); online softmax in the log2 domain, m
      // being the running maximum of the scaled scores times log2(e), so
      // that the fp32 scale folds into the exponent's FMA; each row's four
      // lanes reduce in a fixed order
      if (needs_mask(q0, BQ, k0, BK, S, causal, window)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (!allowed(row0 + 8 * ((i / 2) % 2), k0 + 8 * (i / 4) + col0 + i % 2, S, causal,
                       window))
            sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY}, corr[2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
        corr[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int i = 0; i < AW; ++i) acc[c][i] *= corr[(i / 2) % 2];
      }
      uint32_t p[BK / 4];  // P in bf16: the A fragment of P V
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p0 = ex2(fmaf(sc[2 * j], scale_log2, -m[j % 2]));
        const float p1 = ex2(fmaf(sc[2 * j + 1], scale_log2, -m[j % 2]));
        l[j % 2] += p0 + p1;
        p[j] = pack_bf16(p0, p1);
      }

      // O += P V: A = P from registers, B = V, MN-major, read in place
      mbar_wait(v_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) mma_rs_chunks<BK>(acc, p, v_tile(s), kk);
      wgmma_commit_wait();
      fence_chunks(acc);
      fence_regs(p);
      if (threadIdx.x % 128 == 0) mbar_arrive(v_empty(s));
    }

    // epilogue: o = acc / l in bf16 pairs, lse = m + log(l) in fp32
    const size_t row_stride = static_cast<size_t>(Hq) * HD;
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = fmaxf(l[hh], 1e-30f);
      inv[hh] = 1.f / l[hh];
      const int row = row0 + 8 * hh;
      if (row < S && lane % 4 == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * S + row] = (m[hh] + log2f(l[hh])) * kLn2;
    }
    store_acc<HD>(o + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * HD,
                  row_stride, row0, col0, S, acc, inv);
  }
}

// ------------------------------------------------------- backward: dK, dV
// One block per (batch, kv head, 128 keys); K and V stay in shared memory,
// Q and dO tiles of 64 rows (with their lse and D) stream through the ring
// over the G query heads of the group and the q tiles that see the keys.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                        int Hq, int Hkv, int causal, int window, float scale, float scale_log2) {
  static_assert(HD <= 128, "hd 256 takes flash_wgmma_dkdv_split_kernel");
  constexpr int BK = kv_bk(HD), BQ = kKvBQ, HDP = 64 * n_boxes(HD);
  constexpr uint32_t kK = tile_bytes<HD, BK>(), kQ = tile_bytes<HD, BQ>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));  // generic address of base
  const uint32_t k_tile = base, v_tile = base + kK;
  auto q_tile = [&](int s) { return base + 2 * kK + s * 2 * kQ; };
  auto do_tile = [&](int s) { return base + 2 * kK + s * 2 * kQ + kQ; };
  const uint32_t stats = 2 * kK + kStages * 2 * kQ;  // offset of lse * log2(e), then D, per stage
  auto lse_s = [&](int s) { return reinterpret_cast<float*>(gbase + stats + s * 2 * BQ * 4); };
  auto d_s = [&](int s) { return lse_s(s) + BQ; };
  const uint32_t bars = base + stats + kStages * 2 * BQ * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = Hq / Hkv;
  // the q rows that see keys [k0, k0 + BK)
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + BK - 1 + window);
  }
  const int qt_lo = q_lo / BQ, nq = (q_hi + BQ - 1) / BQ - qt_lo;
  const int n = G * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    prefetch_map(&map_do);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes: lse and D by hand, lane 0 the TMA
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: warp 0 of the warpgroup
    regs_dec<producer_regs(HD)>();
    if (threadIdx.x / 32 == kConsumers * 4) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kK);
        load_tile<HD, BK>(k_tile, &map_k, kv_full, hk, k0, b);
        load_tile<HD, BK>(v_tile, &map_v, kv_full, hk, k0, b);
      }
      for (int it = 0; it < n; ++it) {
        const int h = hk * G + it / nq, q0 = (qt_lo + it % nq) * BQ;
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const size_t row = (static_cast<size_t>(b) * Hq + h) * S;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const int q = q0 + r;
          lse_s(s)[r] = q < S ? lse[row + q] * kLog2e : 0.f;
          d_s(s)[r] = q < S ? delta[row + q] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * kQ);
          load_tile<HD, BQ>(q_tile(s), &map_q, full(s), h, q0, b);
          load_tile<HD, BQ>(do_tile(s), &map_do, full(s), h, q0, b);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: keys k0 + 64 wg .. k0 + 64 wg + 63
    regs_inc<consumer_regs(HD)>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;  // keys key0 and key0 + 8
    const int col0 = 2 * (lane % 4);
    float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int q0 = (qt_lo + it % nq) * BQ;
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, all four operands K-major
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(st, kmajor<BK>(k_tile, wg * 64, kk), kmajor<BQ>(q_tile(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(dpt, kmajor<BK>(v_tile, wg * 64, kk), kmajor<BQ>(do_tile(s), 0, kk), kk);
      wgmma_commit_wait();
      fence_acc(st);
      fence_acc(dpt);

      // P^T = exp(S^T * scale - lse), dS^T = P^T (dP^T - D); masks only on
      // tiles that hold a disallowed pair or rows past S
      const float* ls = lse_s(s);
      const float* ds = d_s(s);
      const bool mask = needs_mask(q0, BQ, k0, BK, S, causal, window);
      uint32_t pt[BQ / 4], dst[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 4; ++j) {
        // accumulators 2j, 2j + 1: key key0 + 8 (j % 2), q columns c, c + 1
        const int c = 8 * (j / 2) + col0;
        const float2 lc = *reinterpret_cast<const float2*>(ls + c);
        const float2 dc = *reinterpret_cast<const float2*>(ds + c);
        float p0 = ex2(fmaf(st[2 * j], scale_log2, -lc.x));
        float p1 = ex2(fmaf(st[2 * j + 1], scale_log2, -lc.y));
        if (mask) {
          const int key = key0 + 8 * (j % 2);
          if (!(q0 + c < S && allowed(q0 + c, key, S, causal, window))) p0 = 0.f;
          if (!(q0 + c + 1 < S && allowed(q0 + c + 1, key, S, causal, window))) p1 = 0.f;
        }
        pt[j] = pack_bf16(p0, p1);
        dst[j] = pack_bf16(p0 * (dpt[2 * j] - dc.x), p1 * (dpt[2 * j + 1] - dc.y));
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, B MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs(dv_acc, pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3],
               mnmajor<BQ>(do_tile(s), kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs(dk_acc, dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2], dst[4 * kk + 3],
               mnmajor<BQ>(q_tile(s), kk));
      wgmma_commit_wait();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      fence_regs(pt);
      fence_regs(dst);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
    }

    const size_t row_stride = static_cast<size_t>(Hkv) * HD;
    const size_t head = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(hk) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= S) continue;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col >= HD) continue;
        const size_t at = head + key * row_stride + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// ------------------------------------------------ backward: dK, dV at hd 256
// dK and dV of 64 keys are 2 x 128 fp32 registers a thread: one warpgroup
// cannot hold both.  One block per (batch, kv head, 64 keys), and both
// consumer warpgroups take the same keys: warpgroup 0 computes S^T = K Q^T,
// P^T = exp(S^T scale - lse) and dV += P^T dO, warpgroup 1 dP^T = V dO^T,
// dS^T = P^T (dP^T - D) and dK += dS^T Q.  P^T passes from warpgroup 0 to
// warpgroup 1 through shared memory in fp32, each thread's fragment where
// the same thread of the other warpgroup reads it (no bank conflicts),
// behind two named barriers (full, empty).  Four products a (q, key) pair,
// as in the fused pass; no atomics.  Q and dO tiles of 64 rows, with lse and
// D, stream as in the fused pass.
constexpr int kPFull = 1, kPEmpty = 2;  // named barrier ids

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_dkdv_split_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int S, int Hq, int Hkv, int causal, int window, float scale,
                              float scale_log2) {
  constexpr int BK = kv_bk(HD), BQ = kKvBQ, HDP = 64 * n_boxes(HD);
  constexpr int NC = acc_chunks(HD), AW = HDP / NC / 2;
  static_assert(BK == 64, "both warpgroups take the block's 64 keys");
  constexpr uint32_t kK = tile_bytes<HD, BK>(), kQ = tile_bytes<HD, BQ>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));  // generic address of base
  const uint32_t k_tile = base, v_tile = base + kK;
  auto q_tile = [&](int s) { return base + 2 * kK + s * 2 * kQ; };
  auto do_tile = [&](int s) { return base + 2 * kK + s * 2 * kQ + kQ; };
  const uint32_t stats = 2 * kK + kStages * 2 * kQ;  // offset of lse * log2(e), then D, per stage
  auto lse_s = [&](int s) { return reinterpret_cast<float*>(gbase + stats + s * 2 * BQ * 4); };
  auto d_s = [&](int s) { return lse_s(s) + BQ; };
  const uint32_t p_off = stats + kStages * 2 * BQ * 4;  // P^T, [BQ / 2][128] fp32
  float* const p_buf = reinterpret_cast<float*>(gbase + p_off);
  const uint32_t bars = base + p_off + BK * BQ * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = Hq / Hkv;
  // the q rows that see keys [k0, k0 + BK)
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + BK - 1 + window);
  }
  const int qt_lo = q_lo / BQ, nq = (q_hi + BQ - 1) / BQ - qt_lo;
  const int n = G * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    prefetch_map(&map_do);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes: lse and D by hand, lane 0 the TMA
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: warp 0 of the warpgroup
    regs_dec<producer_regs(HD)>();
    if (threadIdx.x / 32 == kConsumers * 4) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kK);
        load_tile<HD, BK>(k_tile, &map_k, kv_full, hk, k0, b);
        load_tile<HD, BK>(v_tile, &map_v, kv_full, hk, k0, b);
      }
      for (int it = 0; it < n; ++it) {
        const int h = hk * G + it / nq, q0 = (qt_lo + it % nq) * BQ;
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const size_t row = (static_cast<size_t>(b) * Hq + h) * S;
        for (int r = lane; r < BQ; r += 32) {
          const int q = q0 + r;
          lse_s(s)[r] = q < S ? lse[row + q] * kLog2e : 0.f;
          d_s(s)[r] = q < S ? delta[row + q] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * kQ);
          load_tile<HD, BQ>(q_tile(s), &map_q, full(s), h, q0, b);
          load_tile<HD, BQ>(do_tile(s), &map_do, full(s), h, q0, b);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers: keys k0 .. k0 + 63, warpgroup 0 for dV, 1 for dK
    regs_inc<consumer_regs(HD)>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int key0 = k0 + warp * 16 + lane / 4;  // keys key0 and key0 + 8
    const int col0 = 2 * (lane % 4);
    // warpgroup 0: S^T = K Q^T, then dV += P^T dO; warpgroup 1: dP^T = V dO^T,
    // then dK += dS^T Q
    const uint32_t a_tile = wg == 0 ? k_tile : v_tile;
    float acc[NC][AW];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < AW; ++i) acc[c][i] = 0.f;
    }

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int q0 = (qt_lo + it % nq) * BQ;
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t qs = q_tile(s), dos = do_tile(s);

      float st[BQ / 2];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(st, kmajor<BK>(a_tile, 0, kk), kmajor<BQ>(wg == 0 ? qs : dos, 0, kk), kk);
      wgmma_commit_wait();
      fence_acc(st);

      // accumulators 2j, 2j + 1: key key0 + 8 (j % 2), q columns c, c + 1
      uint32_t a[BQ / 4];
      if (wg == 0) {
        // P^T, masked only on tiles that hold a disallowed pair or rows past S
        const float* ls = lse_s(s);
        const bool mask = needs_mask(q0, BQ, k0, BK, S, causal, window);
        float pt[BQ / 2];
#pragma unroll
        for (int j = 0; j < BQ / 4; ++j) {
          const int c = 8 * (j / 2) + col0;
          const float2 lc = *reinterpret_cast<const float2*>(ls + c);
          pt[2 * j] = ex2(fmaf(st[2 * j], scale_log2, -lc.x));
          pt[2 * j + 1] = ex2(fmaf(st[2 * j + 1], scale_log2, -lc.y));
          if (mask) {
            const int key = key0 + 8 * (j % 2);
            if (!(q0 + c < S && allowed(q0 + c, key, S, causal, window))) pt[2 * j] = 0.f;
            if (!(q0 + c + 1 < S && allowed(q0 + c + 1, key, S, causal, window)))
              pt[2 * j + 1] = 0.f;
          }
          a[j] = pack_bf16(pt[2 * j], pt[2 * j + 1]);
        }
        if (it > 0) named_sync(kPEmpty);  // warpgroup 1 has read the last P^T
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) p_buf[i * 128 + t] = pt[i];
        __threadfence_block();
        named_arrive(kPFull);
      } else {
        const float* ds = d_s(s);
        named_sync(kPFull);
#pragma unroll
        for (int j = 0; j < BQ / 4; ++j) {
          const int c = 8 * (j / 2) + col0;
          const float2 dc = *reinterpret_cast<const float2*>(ds + c);
          a[j] = pack_bf16(p_buf[(2 * j) * 128 + t] * (st[2 * j] - dc.x),
                           p_buf[(2 * j + 1) * 128 + t] * (st[2 * j + 1] - dc.y));
        }
        if (it + 1 < n) named_arrive(kPEmpty);
      }

      // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1): A from
      // registers, B MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) mma_rs_chunks<BQ>(acc, a, wg == 0 ? dos : qs, kk);
      wgmma_commit_wait();
      fence_chunks(acc);
      fence_regs(a);
      if (t == 0) mbar_arrive(empty(s));
    }

    const size_t row_stride = static_cast<size_t>(Hkv) * HD;
    const size_t head = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(hk) * HD;
    if (wg == 0)
      store_acc<HD>(dv + head, row_stride, key0, col0, S, acc, {1.f, 1.f});
    else
      store_acc<HD>(dk + head, row_stride, key0, col0, S, acc, {scale, scale});
  }
}

// ------------------------------------------------------------ backward: dQ
// One block per (batch, q head, 128 q rows); Q and dO stay in shared
// memory, K and V tiles of 64 keys stream through the ring.
//
// dQ = scale * sum_j dS_ij (k_j - c) for kmean's c, the keys' mean over the
// sequence ([B, Hkv, HD] bf16): the same gradient, since sum_j dS_ij is zero
// in exact arithmetic, but D = rowsum(dO O) comes from the rounded O and dS
// is rounded to bf16, so that sum is not zero, and times keys that share a
// large common component it cost dq 4% of its largest value (bert-large's
// deeper layers at init; SDPA's flash backend as much).  Each row's sum of
// the rounded dS is kept in fp32 and r_i c subtracted before the store.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const __nv_bfloat16* __restrict__ kmean,
                      __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv, int causal,
                      int window, float scale, float scale_log2) {
  constexpr int BQ = kDqBQ, BK = dq_bk(HD), HDP = 64 * n_boxes(HD);
  constexpr int NC = acc_chunks(HD), AW = HDP / NC / 2;
  constexpr uint32_t kQ = tile_bytes<HD, BQ>(), kK = tile_bytes<HD, BK>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + kQ;
  auto k_tile = [&](int s) { return base + 2 * kQ + s * 2 * kK; };
  auto v_tile = [&](int s) { return base + 2 * kQ + s * 2 * kK + kK; };
  const uint32_t bars = base + 2 * kQ + kStages * 2 * kK;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);
  const int n = kt_hi - kt_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    prefetch_map(&map_do);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dec<producer_regs(HD)>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, 2 * kQ);
      load_tile<HD, BQ>(q_tile, &map_q, q_full, h, q0, b);
      load_tile<HD, BQ>(do_tile, &map_do, q_full, h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int k0 = (kt_lo + it) * BK;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kK);
        load_tile<HD, BK>(k_tile(s), &map_k, full(s), hk, k0, b);
        load_tile<HD, BK>(v_tile(s), &map_v, full(s), hk, k0, b);
      }
    }
  } else {
    regs_inc<consumer_regs(HD)>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
    const int col0 = 2 * (lane % 4);
    const size_t stat = (static_cast<size_t>(b) * Hq + h) * S;
    float lse2[2], dd[2], rs[2] = {0.f, 0.f};  // rs: each row's sum of the rounded dS
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      lse2[hh] = row < S ? lse[stat + row] * kLog2e : 0.f;
      dd[hh] = row < S ? delta[stat + row] : 0.f;
    }
    float acc[NC][AW];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < AW; ++i) acc[c][i] = 0.f;
    }

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const int k0 = (kt_lo + it) * BK;
      mbar_wait(full(s), (it / kStages) & 1);

      // S = Q K^T and dP = dO V^T, all four operands K-major
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(sc, kmajor<BQ>(q_tile, wg * 64, kk), kmajor<BK>(k_tile(s), 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_ss(dp, kmajor<BQ>(do_tile, wg * 64, kk), kmajor<BK>(v_tile(s), 0, kk), kk);
      wgmma_commit_wait();
      fence_acc(sc);
      fence_acc(dp);

      const bool mask = needs_mask(q0, BQ, k0, BK, S, causal, window);
      uint32_t dsr[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int hh = j % 2;
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          float p = ex2(fmaf(sc[i], scale_log2, -lse2[hh]));
          if (mask && !allowed(row0 + 8 * hh, k0 + 8 * (i / 4) + col0 + e, S, causal, window))
            p = 0.f;
          dsv[e] = p * (dp[i] - dd[hh]);
        }
        dsr[j] = pack_bf16(dsv[0], dsv[1]);
        const float2 rounded = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dsr[j]));
        rs[hh] += rounded.x + rounded.y;
      }

      // dQ += dS K: A from registers, B = K, MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) mma_rs_chunks<BK>(acc, dsr, k_tile(s), kk);
      wgmma_commit_wait();
      fence_chunks(acc);
      fence_regs(dsr);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
    }

    // dQ -= r c: each row's four lanes reduce in a fixed order
    const __nv_bfloat16* c = kmean + (static_cast<size_t>(b) * Hkv + hk) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int j = 0; j < AW / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cc * 2 * AW + 8 * j + col0 + e;
          const float cv = col < HD ? __bfloat162float(c[col]) : 0.f;
          acc[cc][4 * j + e] -= rs[0] * cv;
          acc[cc][4 * j + 2 + e] -= rs[1] * cv;
        }
      }
    }
    const size_t row_stride = static_cast<size_t>(Hq) * HD;
    store_acc<HD>(dq + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * HD,
                  row_stride, row0, col0, S, acc, {scale, scale});
  }
}

// -------------------------------------------------------------- the probe
// One 64 x BK tile of S = Q K^T (fp32) and O = bf16(S) V (fp32) from one
// warpgroup: the forward's descriptors and fragment layouts alone.
template <int HD, int BK>
__global__ void __launch_bounds__(128, 1)
flash_wgmma_probe_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, float* __restrict__ s_out,
                         float* __restrict__ o_out) {
  constexpr int HDP = 64 * n_boxes(HD);
  constexpr int NC = acc_chunks(HD), AW = HDP / NC / 2;
  constexpr uint32_t kQ = tile_bytes<HD, 64>(), kK = tile_bytes<HD, BK>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base, k_tile = base + kQ, v_tile = base + kQ + kK;
  const uint32_t bar = base + kQ + 2 * kK;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kQ + 2 * kK);
    load_tile<HD, 64>(q_tile, &map_q, bar, 0, 0, 0);
    load_tile<HD, BK>(k_tile, &map_k, bar, 0, 0, 0);
    load_tile<HD, BK>(v_tile, &map_v, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  float sc[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_ss(sc, kmajor<64>(q_tile, 0, kk), kmajor<BK>(k_tile, 0, kk), kk);
  wgmma_commit_wait();
  fence_acc(sc);
  uint32_t p[BK / 4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    s_out[(row0 + 8 * ((i / 2) % 2)) * BK + 8 * (i / 4) + col0 + i % 2] = sc[i];
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);

  float acc[NC][AW];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < AW; ++i) acc[c][i] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) mma_rs_chunks<BK>(acc, p, v_tile, kk);
  wgmma_commit_wait();
  fence_chunks(acc);
  fence_regs(p);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < AW; ++i) {
      const int col = c * 2 * AW + 8 * (i / 4) + col0 + i % 2;
      if (col < HD) o_out[(row0 + 8 * ((i / 2) % 2)) * HD + col] = acc[c][i];
    }
  }
}

// ---------------------------------------------------------------- launches
// A [B, S, H, hd] bf16 tensor as a 4-D tensor map (hd, H, S, B), boxes of 64
// columns x 1 head x box_rows rows, 128B-swizzled; elements out of bounds
// (rows past S, columns past hd) read as zeros.  Flattening to 2-D would
// not do: a box past hd would read the next head's columns.
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory of each block: the tiles, the barriers and up to
// 1 KB to align the first tile.
template <int HD>
constexpr int fwd_smem() {
  return tile_bytes<HD, kFwdBQ>() + 2 * kStages * tile_bytes<HD, fwd_bk(HD)>() +
         8 * (1 + 4 * kStages) + 1024;
}
template <int HD>
constexpr int dkdv_smem() {  // at hd 256 also P^T, kv_bk x kKvBQ fp32
  return 2 * tile_bytes<HD, kv_bk(HD)>() + kStages * 2 * tile_bytes<HD, kKvBQ>() +
         kStages * 2 * kKvBQ * 4 + (HD > 128 ? kv_bk(HD) * kKvBQ * 4 : 0) +
         8 * (1 + 2 * kStages) + 1024;
}
template <int HD>
constexpr int dq_smem() {
  return 2 * tile_bytes<HD, kDqBQ>() + kStages * 2 * tile_bytes<HD, dq_bk(HD)>() +
         8 * (1 + 2 * kStages) + 1024;
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode_bshd(&mq, q, B, S, Hq, HD, kFwdBQ) ||
      !encode_bshd(&mk, k, B, S, Hkv, HD, fwd_bk(HD)) ||
      !encode_bshd(&mv, v, B, S, Hkv, HD, fwd_bk(HD)))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_fwd_kernel<HD>;
  cudaError_t err = allow_smem(kernel, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + kFwdBQ - 1) / kFwdBQ, B * Hq);
  kernel<<<grid, kThreads, fwd_smem<HD>(), stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, Hq, Hkv, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* delta, void* dq, void* dk, void* dv, const void* kmean,
                int B, int S, int Hq, int Hkv, int causal, int window, float scale,
                cudaStream_t stream) {
  CUtensorMap kv_q, kv_k, kv_v, kv_do, q_q, q_k, q_v, q_do;
  // the dK/dV pass streams 64-row Q and dO tiles against 128 keys (64 at hd
  // 256), the dQ pass 64-key K and V tiles (32 at hd 256) against 128 q rows
  constexpr int kv_keys = kv_bk(HD), dq_keys = dq_bk(HD);
  if (!encode_bshd(&kv_q, q, B, S, Hq, HD, kKvBQ) ||
      !encode_bshd(&kv_do, dout, B, S, Hq, HD, kKvBQ) ||
      !encode_bshd(&kv_k, k, B, S, Hkv, HD, kv_keys) ||
      !encode_bshd(&kv_v, v, B, S, Hkv, HD, kv_keys) ||
      !encode_bshd(&q_q, q, B, S, Hq, HD, kDqBQ) ||
      !encode_bshd(&q_do, dout, B, S, Hq, HD, kDqBQ) ||
      !encode_bshd(&q_k, k, B, S, Hkv, HD, dq_keys) ||
      !encode_bshd(&q_v, v, B, S, Hkv, HD, dq_keys))
    return cudaErrorInvalidValue;
  auto dkdv = [] {
    if constexpr (HD > 128)
      return flash_wgmma_dkdv_split_kernel<HD>;
    else
      return flash_wgmma_dkdv_kernel<HD>;
  }();
  auto dqk = flash_wgmma_dq_kernel<HD>;
  cudaError_t err = allow_smem(dkdv, dkdv_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(dqk, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  const int rows = B * S * Hq;
  flash_delta_kernel<__nv_bfloat16, HD><<<(rows + 31) / 32, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dt, rows, S,
      Hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((S + kv_keys - 1) / kv_keys, B * Hkv);
  dkdv<<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(
      kv_q, kv_k, kv_v, kv_do, lt, dt, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Hq, Hkv, causal, window, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((S + kDqBQ - 1) / kDqBQ, B * Hq);
  dqk<<<grid_q, kThreads, dq_smem<HD>(), stream>>>(
      q_q, q_k, q_v, q_do, lt, dt, static_cast<const __nv_bfloat16*>(kmean),
      static_cast<__nv_bfloat16*>(dq), S, Hq, Hkv, causal, window, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int HD, int BK>
cudaError_t probe(const void* q, const void* k, const void* v, void* s, void* o,
                  cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode_bshd(&mq, q, 1, 64, 1, HD, 64) || !encode_bshd(&mk, k, 1, BK, 1, HD, BK) ||
      !encode_bshd(&mv, v, 1, BK, 1, HD, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = tile_bytes<HD, 64>() + 2 * tile_bytes<HD, BK>() + 8 + 1024;
  auto kernel = flash_wgmma_probe_kernel<HD, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, 128, smem, stream>>>(mq, mk, mv, static_cast<float*>(s), static_cast<float*>(o));
  return cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------- tf32x3 route
namespace x3 {

using tc::ex2;
using tc::kLn2;
using tc::kLog2e;
using tc::needs_mask;

constexpr int kThreads = 128;     // the forward: 4 warps of 16 resident rows each
constexpr int kBwdThreads = 256;  // the backward passes: warps w and w + 4 share 16
                                  // resident rows and take half of each streamed tile
constexpr int kRows = 64;         // resident rows of a block: q rows, or keys in the dK/dV pass

// Rows of a streamed tile (K and V in the forward and the dQ pass, Q and dO
// in the dK/dV pass): 16 at hd 128, so that the planes, the staging and the
// accumulators fit in shared memory and registers.
template <int HD>
__host__ __device__ constexpr int stream_rows() { return HD > 96 ? 16 : 32; }

// Row stride of a plane, in floats: hd + 4 is 4 x an odd number at hd 64, 80,
// 96 and 128, so the fragment loads below (8 rows x 4 columns, or rows 2t
// and 2t + 1 of 8 columns) fall on 32 different banks.
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 4; }

// tf32(x), rounded to nearest with ties away from zero: the low 13 bits of
// the fp32 pattern cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in fp32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// One 16 x 8 x 8 TF32 product with fp32 accumulation: d += a b.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of mma.m16n8k8.tf32, lane = 4 g + t: A (16 x 8) registers
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) (t, g), (t + 4, g);
// the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d[n] += a b[n] for n < N, each as three TF32 products into its one fp32
// accumulator in a fixed order, the small terms first: lo hi, hi lo, hi hi
// (lo lo, ~2^-22 of the product, is dropped).  The N accumulators take
// turns, product by product, so that no product waits on the one before.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.hi, b[n].hi);
}

// Four 8 x 4 tiles of 32-bit elements in one instruction: lane 8i + r gives
// the address of row r of tile i, and register i of lane 4g + t receives
// element (g, t) of tile i (ldmatrix of 8 x 8 16-bit tiles, read as pairs).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}

// A fragment of rows m0.., columns k0.. of a row-major [rows][LD] plane pair.
template <int LD>
__device__ __forceinline__ FragA load_a(const uint32_t* hi, const uint32_t* lo, int m0, int k0,
                                        int g, int t) {
  // tiles (m0, k0), (m0 + 8, k0), (m0, k0 + 4), (m0 + 8, k0 + 4)
  const int lane = 4 * g + t, i = lane / 8;
  const int at = (m0 + lane % 8 + 8 * (i % 2)) * LD + k0 + 4 * (i / 2);
  FragA a;
  ldsm4(a.hi, hi + at);
  ldsm4(a.lo, lo + at);
  return a;
}

// B fragment of a product reduced over the plane's columns (B = X^T, X
// rows n0.., columns k0..): Q K^T, K Q^T, dO V^T, V dO^T.
template <int LD>
__device__ __forceinline__ FragB load_bt(const uint32_t* hi, const uint32_t* lo, int n0, int k0,
                                         int g, int t) {
  const int i = (n0 + g) * LD + k0 + t;
  return {{hi[i], hi[i + 4]}, {lo[i], lo[i + 4]}};
}

// The B fragments of N such blocks, rows n0 + 8 j, two blocks an ldmatrix
// (tiles (n0, k0), (n0, k0 + 4), (n0 + 8, k0), (n0 + 8, k0 + 4)) where N is
// even.
template <int LD, int N>
__device__ __forceinline__ void load_bts(FragB (&b)[N], const uint32_t* hi, const uint32_t* lo,
                                         int n0, int k0, int g, int t) {
  if constexpr (N % 2 == 0) {
    const int lane = 4 * g + t, i = lane / 8;
    const int at = (n0 + lane % 8 + 8 * (i / 2)) * LD + k0 + 4 * (i % 2);
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t h[4], l[4];
      ldsm4(h, hi + at + 8 * j * LD);
      ldsm4(l, lo + at + 8 * j * LD);
      b[j] = {{h[0], h[1]}, {l[0], l[1]}};
      b[j + 1] = {{h[2], h[3]}, {l[2], l[3]}};
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = load_bt<LD>(hi, lo, n0 + 8 * j, k0, g, t);
  }
}

// The permutation that feeds an accumulator to the next product without a
// shuffle: the accumulator of an n8 block holds columns 2t and 2t + 1, the A
// fragment wants columns t and t + 4.  A product reduced over those 8
// columns may take them in any order that A and B share, so A's column t is
// accumulator column 2t and its column t + 4 is column 2t + 1: A = (c0, c2,
// c1, c3), split into hi and lo in registers, and B's row t is plane row
// k0 + 2t, its row t + 4 plane row k0 + 2t + 1 (load_bp).
__device__ __forceinline__ FragA split_acc(const float (&c)[4]) {
  FragA a;
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
  return a;
}

// B fragment of a product reduced over the plane's rows k0..k0 + 7 in the
// permuted order, columns n0..: P V, P^T dO, dS^T Q, dS K.
template <int LD>
__device__ __forceinline__ FragB load_bp(const uint32_t* hi, const uint32_t* lo, int k0, int n0,
                                         int g, int t) {
  const int i = (k0 + 2 * t) * LD + n0 + g;
  return {{hi[i], hi[i + LD]}, {lo[i], lo[i + LD]}};
}

// The products that accumulate over a streamed dimension (P V over the
// keys, P^T dO and dS^T Q over the q rows of G heads, dS K over the keys)
// add each streamed tile's contribution, taken in a fresh accumulator (at
// most 12 products), into the running fp32 sum with IEEE round-to-nearest
// adds: the tensor cores' fp32 accumulation truncates, and thousands of
// truncating accumulations into one sum (dV over 5,120 q rows at S 1024,
// G 5) bias it by ~1e-4.  run[c0 + cc] += sum over j of a[j] B(j, c0 + cc)
// for cc < 2 (every head dim here has an even number of column blocks).
template <int LD, int J, int N>
__device__ __forceinline__ void mma3_tile(float (&run)[N][4], int c0, const FragA (&a)[J],
                                          const uint32_t* hi, const uint32_t* lo, int g, int t) {
  float part[2][4] = {};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const FragB b[2] = {load_bp<LD>(hi, lo, 8 * j, 8 * c0, g, t),
                        load_bp<LD>(hi, lo, 8 * j, 8 * c0 + 8, g, t)};
    mma3(part, a[j], b);
  }
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[c0 + cc][e] += part[cc][e];
}

// ------------------------------------------------------- loading the tiles
// Float4 i of a tile of one head's rows [r0, r0 + R) of a [B, S, H, HD] fp32
// tensor (row stride `stride` floats, `src` at the head's first column) is
// row i / (HD / 4), columns 4 (i % (HD / 4)); rows past S read as zeros.

// 16 bytes global -> shared without registers (cp.async); zeros when `in`
// is false (no bytes are read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// The raw tile into a shared staging buffer [R][HD] by NT threads,
// asynchronously; the caller commits the group and waits for it.
template <int HD, int R, int NT>
__device__ __forceinline__ void stage_async(float* stage, const float* src, size_t stride, int r0,
                                            int S) {
#pragma unroll
  for (int i = threadIdx.x; i < R * HD / 4; i += NT) {
    const int row = i / (HD / 4), c = 4 * (i % (HD / 4));
    const bool in = r0 + row < S;
    cp_async16(stage + 4 * i, src + static_cast<size_t>(in ? r0 + row : r0) * stride + c, in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One float4 split once into the hi and lo planes [rows][LD] at float4 i.
template <int HD>
__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo, int i, float4 x) {
  const int at = (i / (HD / 4)) * ld<HD>() + 4 * (i % (HD / 4));
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + at) = h;
  *reinterpret_cast<uint4*>(lo + at) = l;
}

// A staged tile into its planes, by NT threads.
template <int HD, int R, int NT>
__device__ __forceinline__ void split_stage(uint32_t* hi, uint32_t* lo, const float* stage) {
#pragma unroll
  for (int i = threadIdx.x; i < R * HD / 4; i += NT)
    store_split<HD>(hi, lo, i, *reinterpret_cast<const float4*>(stage + 4 * i));
}

// A tile loaded into registers (the forward's K and V, one tile ahead: the
// forward keeps two blocks an SM, which a staging buffer would not leave
// room for), then split into its planes.
template <int HD, int R>
struct Tile {
  static_assert(R * HD % (4 * kThreads) == 0, "a tile is a whole number of float4s a thread");
  static constexpr int kPerThread = R * HD / 4 / kThreads;
  float4 v[kPerThread];

  __device__ __forceinline__ void load(const float* src, size_t stride, int r0, int S) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads, row = i / (HD / 4), c = 4 * (i % (HD / 4));
      v[j] = r0 + row < S
                 ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + row) * stride + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(uint32_t* hi, uint32_t* lo) const {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) store_split<HD>(hi, lo, threadIdx.x + j * kThreads, v[j]);
  }
};

// A resident tile of R rows, loaded and split by NT threads.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_planes(uint32_t* hi, uint32_t* lo, const float* src,
                                            size_t stride, int r0, int S) {
#pragma unroll 4
  for (int i = threadIdx.x; i < R * HD / 4; i += NT) {
    const int row = i / (HD / 4), c = 4 * (i % (HD / 4));
    store_split<HD>(hi, lo, i,
                    r0 + row < S ? __ldg(reinterpret_cast<const float4*>(
                                       src + static_cast<size_t>(r0 + row) * stride + c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// The two partial sums of each warp pair (w, w + 4) added in a fixed order:
// warps 4..7 leave theirs in `scratch` (4 x M x N x 128 floats, over planes
// that are consumed), warps 0..3 add them to their own.
template <int M, int N>
__device__ __forceinline__ void pair_sum(float (&acc)[M][N][4], float* scratch, int warp,
                                         int lane) {
  float* at = scratch + (warp % 4) * M * N * 128 + lane;
  __syncthreads();
  if (warp >= 4) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[((m * N + n) * 4 + e) * 32] = acc[m][n][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += at[((m * N + n) * 4 + e) * 32];
  }
}

// ---------------------------------------------------------------- forward
// One block per (batch, q head, 64 q rows), warp w owning rows 16w..16w+15;
// Q split once into shared memory, K and V tiles loaded into registers one
// tile ahead (the loads fly during the tile's products) and split into
// their planes between two barriers.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_tf32x3_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int S, int Hq, int Hkv, int causal, int window,
                        float scale_log2) {
  constexpr int BQ = kRows, BK = stream_rows<HD>(), LD = ld<HD>();
  extern __shared__ __align__(16) uint32_t smem_x3[];
  uint32_t* q_hi = smem_x3;
  uint32_t* q_lo = q_hi + BQ * LD;
  uint32_t* k_hi = q_lo + BQ * LD;
  uint32_t* k_lo = k_hi + BK * LD;
  uint32_t* v_hi = k_lo + BK * LD;
  uint32_t* v_lo = v_hi + BK * LD;

  // causal: the q tiles with the most k tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t qs = static_cast<size_t>(Hq) * HD, ks = static_cast<size_t>(Hkv) * HD;
  const float* kb = k + static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * HD;
  const float* vb = v + static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * HD;
  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);

  Tile<HD, BK> kr, vr;
  if (kt_lo < kt_hi) {
    kr.load(kb, ks, kt_lo * BK, S);
    vr.load(vb, ks, kt_lo * BK, S);
  }
  load_planes<HD, BQ, kThreads>(
      q_hi, q_lo, q + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD, qs, q0, S);

  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8
  float m[2] = {-1e30f, -1e30f};        // finite: a fully masked row leaves m, l and acc as they are
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's planes are consumed
    kr.store(k_hi, k_lo);
    vr.store(v_hi, v_lo);
    __syncthreads();
    if (kt + 1 < kt_hi) {
      kr.load(kb, ks, k0 + BK, S);
      vr.load(vb, ks, k0 + BK, S);
    }

    // S = Q K^T, unscaled fp32
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      FragB bk[BK / 8];
      load_bts<LD>(bk, k_hi, k_lo, 0, 8 * kk, g, t);
      mma3(sc, load_a<LD>(q_hi, q_lo, warp * 16, 8 * kk, g, t), bk);
    }

    // masks only on tiles that hold a disallowed pair; the online softmax in
    // the log2 domain (m is the running maximum of the scaled scores times
    // log2(e), so the scale folds into each exponent's FMA), each row's four
    // lanes reducing with shfl_xor in a fixed order
    if (needs_mask(q0, BQ, k0, BK, S, causal, window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!allowed(row0 + 8 * (e / 2), k0 + 8 * j + 2 * t + e % 2, S, causal, window))
            sc[j][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, corr[2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
      corr[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }

    // P in registers, split; O = O corr + P V, the tile's P V in a fresh
    // accumulator
    FragA p[BK / 8];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(fmaf(sc[j][e], scale_log2, -m[e / 2]));  // 0 where masked
        l[e / 2] += sc[j][e];
      }
      p[j] = split_acc(sc[j]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) mma3_tile<LD, BK / 8>(acc, n, p, v_hi, v_lo, g, t);
  }

  // epilogue: o = acc / l in float2 pairs, lse = m + log(l)
  float* ob = o + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(ob + row * qs + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
    if (t == 0) lse[(static_cast<size_t>(b) * Hq + h) * S + row] = (m[hh] + log2f(l[hh])) * kLn2;
  }
}

// ------------------------------------------------------- backward: dK, dV
// One block per (batch, kv head, 64 keys) of 8 warps: warps w and w + 4 own
// keys 16 (w % 4).. and take the first and the second half of each streamed
// q tile.  K and V split once into shared memory; Q and dO tiles (with their
// lse and D) staged by cp.async one tile ahead, over the G query heads of
// the group and the q tiles that see the keys.  S^T = K Q^T and dP^T =
// V dO^T, P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - D), then dV +=
// P^T dO and dK += dS^T Q; each pair adds its two halves at the end.
// PARTS says which gradients a launch computes: both, or at hd 128, where
// dK and dV together (128 registers a thread) leave too few registers for
// the rest, one a launch (dV from S^T alone, then dK, recomputing S^T).
constexpr int kDK = 1, kDV = 2;

template <int HD>
constexpr int dkdv_parts() { return HD > 96 ? kDV : kDK | kDV; }

template <int HD, int PARTS>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_tf32x3_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv,
                         int causal, int window, float scale, float scale_log2) {
  constexpr int BK = kRows, BQ = stream_rows<HD>(), LD = ld<HD>(), JW = BQ / 16;
  constexpr bool kWantDK = PARTS & kDK, kWantDV = PARTS & kDV;
  constexpr int M = kWantDK + kWantDV;  // accumulators: dK first, then dV
  extern __shared__ __align__(16) uint32_t smem_x3[];
  uint32_t* k_hi = smem_x3;
  uint32_t* k_lo = k_hi + BK * LD;
  uint32_t* v_hi = k_lo + BK * LD;
  uint32_t* v_lo = v_hi + BK * LD;
  uint32_t* q_hi = v_lo + BK * LD;
  uint32_t* q_lo = q_hi + BQ * LD;
  uint32_t* do_hi = q_lo + BQ * LD;
  uint32_t* do_lo = do_hi + BQ * LD;
  float* q_stage = reinterpret_cast<float*>(do_lo + BQ * LD);  // [BQ][HD], raw
  float* do_stage = q_stage + BQ * HD;
  float* ls = do_stage + BQ * HD;  // lse * log2(e) of the tile's rows
  float* ds = ls + BQ;             // D of the tile's rows

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int j0 = (warp / 4) * JW;  // the warp's first k-step (8 q rows) of each tile
  const size_t qs = static_cast<size_t>(Hq) * HD, ks = static_cast<size_t>(Hkv) * HD;
  // the q rows [first, end) that see keys [k0, k0 + BK)
  int first = 0, end = S;
  if (causal) {
    first = k0;
    if (window > 0) end = min(S, k0 + BK - 1 + window);
  }
  const int qt_lo = first / BQ, nq = (end + BQ - 1) / BQ - qt_lo;
  const int n = G * nq;

  // tile it: query head hk * G + it / nq, rows from (qt_lo + it % nq) * BQ;
  // its lse and D wait in registers of the first BQ threads
  float lr = 0.f, dr = 0.f;
  auto fetch = [&](int it) {
    const int h = hk * G + it / nq, q0 = (qt_lo + it % nq) * BQ;
    const size_t head = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
    stage_async<HD, BQ, kBwdThreads>(q_stage, q + head, qs, q0, S);
    stage_async<HD, BQ, kBwdThreads>(do_stage, dout + head, qs, q0, S);
    cp_async_commit();
    if (threadIdx.x < BQ) {
      const size_t row = (static_cast<size_t>(b) * Hq + h) * S + q0 + threadIdx.x;
      const bool in = q0 + static_cast<int>(threadIdx.x) < S;
      lr = in ? lse[row] * kLog2e : 0.f;
      dr = in ? delta[row] : 0.f;
    }
  };
  if (n > 0) fetch(0);
  const size_t kv_head = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * HD;
  load_planes<HD, BK, kBwdThreads>(k_hi, k_lo, k + kv_head, ks, k0, S);
  load_planes<HD, BK, kBwdThreads>(v_hi, v_lo, v + kv_head, ks, k0, S);

  const int key0 = k0 + (warp % 4) * 16 + g;  // keys key0 and key0 + 8
  float acc[M][HD / 8][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int q0 = (qt_lo + it % nq) * BQ;
    cp_async_wait();
    __syncthreads();  // the tile is staged; the previous tile's planes are consumed
    split_stage<HD, BQ, kBwdThreads>(q_hi, q_lo, q_stage);
    split_stage<HD, BQ, kBwdThreads>(do_hi, do_lo, do_stage);
    if (threadIdx.x < BQ) {
      ls[threadIdx.x] = lr;
      ds[threadIdx.x] = dr;
    }
    __syncthreads();  // the planes are ready; the staging buffers are free
    if (it + 1 < n) fetch(it + 1);

    // S^T = K Q^T and dP^T = V dO^T over the warp's half: columns are q rows
    // 8 j0 .. 8 (j0 + JW) - 1 of the tile
    float st[JW][4], dpt[JW][4];
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      FragB bq[JW], bd[JW];
      load_bts<LD>(bq, q_hi, q_lo, 8 * j0, 8 * kk, g, t);
      mma3(st, load_a<LD>(k_hi, k_lo, (warp % 4) * 16, 8 * kk, g, t), bq);
      if constexpr (kWantDK) {
        load_bts<LD>(bd, do_hi, do_lo, 8 * j0, 8 * kk, g, t);
        mma3(dpt, load_a<LD>(v_hi, v_lo, (warp % 4) * 16, 8 * kk, g, t), bd);
      }
    }

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - D); masks only on tiles
    // that hold a disallowed pair or rows past S
    const bool mask = needs_mask(q0, BQ, k0, BK, S, causal, window);
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * (j0 + j) + 2 * t + e % 2;
        float p = ex2(fmaf(st[j][e], scale_log2, -ls[c]));
        if (mask && !(q0 + c < S && allowed(q0 + c, key0 + 8 * (e / 2), S, causal, window)))
          p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ds[c]);
      }

    // dV += P^T dO, then dK += dS^T Q, reduced over the warp's half of the
    // tile, each A operand split in registers just before its products
    const int half = 8 * j0 * LD;
    if constexpr (kWantDV) {
      FragA pa[JW];
#pragma unroll
      for (int j = 0; j < JW; ++j) pa[j] = split_acc(st[j]);
#pragma unroll
      for (int c = 0; c < HD / 8; c += 2)
        mma3_tile<LD, JW>(acc[M - 1], c, pa, do_hi + half, do_lo + half, g, t);
    }
    if constexpr (kWantDK) {
      FragA da[JW];
#pragma unroll
      for (int j = 0; j < JW; ++j) da[j] = split_acc(dpt[j]);
#pragma unroll
      for (int c = 0; c < HD / 8; c += 2)
        mma3_tile<LD, JW>(acc[0], c, da, q_hi + half, q_lo + half, g, t);
    }
  }

  pair_sum(acc, reinterpret_cast<float*>(smem_x3), warp, lane);
  if (warp >= 4) return;
  float* dkb = dk + kv_head;
  float* dvb = dv + kv_head;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const size_t at = key * ks + 8 * c + 2 * t;
      if constexpr (kWantDK)
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(acc[0][c][2 * hh] * scale, acc[0][c][2 * hh + 1] * scale);
      if constexpr (kWantDV)
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(acc[M - 1][c][2 * hh], acc[M - 1][c][2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------ backward: dQ
// One block per (batch, q head, 64 q rows) of 8 warps: warps w and w + 4 own
// rows 16 (w % 4).. and take the first and the second half of each streamed
// k tile.  Q and dO split once into shared memory, K and V tiles staged by
// cp.async one tile ahead: S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ +=
// dS K; each pair adds its two halves at the end, and dQ (like dK) is scaled
// once.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int S, int Hq, int Hkv, int causal, int window,
                       float scale, float scale_log2) {
  constexpr int BQ = kRows, BK = stream_rows<HD>(), LD = ld<HD>(), JW = BK / 16;
  extern __shared__ __align__(16) uint32_t smem_x3[];
  uint32_t* q_hi = smem_x3;
  uint32_t* q_lo = q_hi + BQ * LD;
  uint32_t* do_hi = q_lo + BQ * LD;
  uint32_t* do_lo = do_hi + BQ * LD;
  uint32_t* k_hi = do_lo + BQ * LD;
  uint32_t* k_lo = k_hi + BK * LD;
  uint32_t* v_hi = k_lo + BK * LD;
  uint32_t* v_lo = v_hi + BK * LD;
  float* k_stage = reinterpret_cast<float*>(v_lo + BK * LD);  // [BK][HD], raw
  float* v_stage = k_stage + BK * HD;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int j0 = (warp / 4) * JW;  // the warp's first k-step (8 keys) of each tile
  const size_t qs = static_cast<size_t>(Hq) * HD, ks = static_cast<size_t>(Hkv) * HD;
  const size_t head = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * HD;
  const float* kb = k + static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * HD;
  const float* vb = v + static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * HD;
  int kt_lo, kt_hi;
  k_tile_range(q0, BQ, BK, S, causal, window, &kt_lo, &kt_hi);

  auto fetch = [&](int kt) {
    stage_async<HD, BK, kBwdThreads>(k_stage, kb, ks, kt * BK, S);
    stage_async<HD, BK, kBwdThreads>(v_stage, vb, ks, kt * BK, S);
    cp_async_commit();
  };
  if (kt_lo < kt_hi) fetch(kt_lo);
  load_planes<HD, BQ, kBwdThreads>(q_hi, q_lo, q + head, qs, q0, S);
  load_planes<HD, BQ, kBwdThreads>(do_hi, do_lo, dout + head, qs, q0, S);

  const int row0 = q0 + (warp % 4) * 16 + g;  // rows row0 and row0 + 8
  const size_t stat = (static_cast<size_t>(b) * Hq + h) * S;
  float lse2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lse2[hh] = row < S ? lse[stat + row] * kLog2e : 0.f;
    dd[hh] = row < S ? delta[stat + row] : 0.f;
  }
  float acc[1][HD / 8][4];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][c][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait();
    __syncthreads();  // the tile is staged; the previous tile's planes are consumed
    split_stage<HD, BK, kBwdThreads>(k_hi, k_lo, k_stage);
    split_stage<HD, BK, kBwdThreads>(v_hi, v_lo, v_stage);
    __syncthreads();  // the planes are ready; the staging buffers are free
    if (kt + 1 < kt_hi) fetch(kt + 1);

    // S = Q K^T and dP = dO V^T over the warp's half of the tile's keys
    float sc[JW][4], dp[JW][4];
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      FragB bk[JW], bv[JW];
      load_bts<LD>(bk, k_hi, k_lo, 8 * j0, 8 * kk, g, t);
      load_bts<LD>(bv, v_hi, v_lo, 8 * j0, 8 * kk, g, t);
      mma3(sc, load_a<LD>(q_hi, q_lo, (warp % 4) * 16, 8 * kk, g, t), bk);
      mma3(dp, load_a<LD>(do_hi, do_lo, (warp % 4) * 16, 8 * kk, g, t), bv);
    }

    // dS = P (dP - D), split in registers; then dQ += dS K over the warp's keys
    const bool mask = needs_mask(q0, BQ, k0, BK, S, causal, window);
    FragA da[JW];
#pragma unroll
    for (int j = 0; j < JW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sc[j][e], scale_log2, -lse2[e / 2]));
        if (mask && !allowed(row0 + 8 * (e / 2), k0 + 8 * (j0 + j) + 2 * t + e % 2, S, causal,
                             window))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - dd[e / 2]);
      }
      da[j] = split_acc(dp[j]);
    }
    const int half = 8 * j0 * LD;
#pragma unroll
    for (int c = 0; c < HD / 8; c += 2)
      mma3_tile<LD, JW>(acc[0], c, da, k_hi + half, k_lo + half, g, t);
  }

  pair_sum(acc, reinterpret_cast<float*>(smem_x3), warp, lane);
  if (warp >= 4) return;
  float* dqb = dq + head;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(dqb + row * qs + 8 * c + 2 * t) =
          make_float2(acc[0][c][2 * hh] * scale, acc[0][c][2 * hh + 1] * scale);
  }
}

// -------------------------------------------------------------- the probe
// One warp's 16-row tile of the forward's products, through the forward's
// planes, fragment loads and permutation: s = q k^T [16, 32] and o = s v
// [16, hd] (s itself as P), q [16, hd], k and v [32, hd], all fp32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tf32x3_probe_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ s_out,
                          float* __restrict__ o_out) {
  constexpr int BK = 32, LD = ld<HD>();
  extern __shared__ __align__(16) uint32_t smem_x3[];
  uint32_t* q_hi = smem_x3;
  uint32_t* q_lo = q_hi + 16 * LD;
  uint32_t* k_hi = q_lo + 16 * LD;
  uint32_t* k_lo = k_hi + BK * LD;
  uint32_t* v_hi = k_lo + BK * LD;
  uint32_t* v_lo = v_hi + BK * LD;
  Tile<HD, 16> qr;
  Tile<HD, BK> kr, vr;
  qr.load(q, HD, 0, 16);
  kr.load(k, HD, 0, BK);
  vr.load(v, HD, 0, BK);
  qr.store(q_hi, q_lo);
  kr.store(k_hi, k_lo);
  vr.store(v_hi, v_lo);
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int g = threadIdx.x / 4, t = threadIdx.x % 4;
  float sc[BK / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    FragB bk[BK / 8];
    load_bts<LD>(bk, k_hi, k_lo, 0, 8 * kk, g, t);
    mma3(sc, load_a<LD>(q_hi, q_lo, 0, 8 * kk, g, t), bk);
  }
  FragA p[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_out[(g + 8 * (e / 2)) * BK + 8 * j + 2 * t + e % 2] = sc[j][e];
    p[j] = split_acc(sc[j]);
  }
  float acc[HD / 8][4] = {};
#pragma unroll
  for (int c = 0; c < HD / 8; c += 2) mma3_tile<LD, BK / 8>(acc, c, p, v_hi, v_lo, g, t);
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_out[(g + 8 * (e / 2)) * HD + 8 * c + 2 * t + e % 2] = acc[c][e];
}

// ---------------------------------------------------------------- launches
// Dynamic shared memory of each block: the hi and lo planes; the backward
// passes' staging buffers (and the dK/dV pass's lse and D).
template <int HD>
constexpr int fwd_smem() {
  return 4 * 2 * (kRows + 2 * stream_rows<HD>()) * ld<HD>();
}
template <int HD>
constexpr int dkdv_smem() {
  constexpr int R = stream_rows<HD>();
  return 4 * (2 * (2 * kRows + 2 * R) * ld<HD>() + 2 * R * HD + 2 * R);
}
template <int HD>
constexpr int dq_smem() {
  constexpr int R = stream_rows<HD>();
  return 4 * (2 * (2 * kRows + 2 * R) * ld<HD>() + 2 * R * HD);
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_tf32x3_fwd_kernel<HD>;
  cudaError_t err = allow_smem(kernel, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + kRows - 1) / kRows, B * Hq);
  kernel<<<grid, kThreads, fwd_smem<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, Hq, Hkv, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* delta, void* dq, void* dk, void* dv, int B, int S, int Hq,
                int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  auto dkdv = flash_tf32x3_dkdv_kernel<HD, dkdv_parts<HD>()>;
  auto dqk = flash_tf32x3_dq_kernel<HD>;
  cudaError_t err = allow_smem(dkdv, dkdv_smem<HD>());
  if (err == cudaSuccess) err = allow_smem(dqk, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  const int rows = B * S * Hq;
  flash_delta_kernel<float, HD><<<(rows + 31) / 32, 256, 0, stream>>>(
      static_cast<const float*>(o), dot, dt, rows, S, Hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((S + kRows - 1) / kRows, B * Hkv);
  dkdv<<<grid_kv, kBwdThreads, dkdv_smem<HD>(), stream>>>(qt, kt, vt, dot, lt, dt,
                                                        static_cast<float*>(dk),
                                                        static_cast<float*>(dv), S, Hq, Hkv,
                                                        causal, window, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (dkdv_parts<HD>() == kDV) {  // hd 128: dK in a second launch
    auto dk_only = flash_tf32x3_dkdv_kernel<HD, kDK>;
    err = allow_smem(dk_only, dkdv_smem<HD>());
    if (err != cudaSuccess) return err;
    dk_only<<<grid_kv, kBwdThreads, dkdv_smem<HD>(), stream>>>(
        qt, kt, vt, dot, lt, dt, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
        causal, window, scale, scale * kLog2e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid_q((S + kRows - 1) / kRows, B * Hq);
  dqk<<<grid_q, kBwdThreads, dq_smem<HD>(), stream>>>(qt, kt, vt, dot, lt, dt, static_cast<float*>(dq),
                                                    S, Hq, Hkv, causal, window, scale,
                                                    scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t probe(const void* q, const void* k, const void* v, void* s, void* o,
                  cudaStream_t stream) {
  constexpr int smem = 4 * 2 * (16 + 2 * 32) * ld<HD>();
  auto kernel = flash_tf32x3_probe_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(s),
                                         static_cast<float*>(o));
  return cudaGetLastError();
}

}  // namespace x3

// ------------------------------------------------ tf32x3 route at hd 256
// fp32 at hd 256 (gemma3-4b) on wgmma: each fp32 product as three TF32
// products (x3::split's hi/lo, the order lo hi, hi lo, hi hi), wgmma taking
// both operands from split planes by TMA.  wgmma takes a TF32 operand from
// shared memory K-major only, so a split pass writes, per call, into a
// workspace the wrapper allocates:
//   * natural planes [B, S, H, 256] (hi, lo) of what a product reduces over
//     the head dim: Q and K forward (S = Q K^T); Q, K, V and dO backward;
//   * transposed planes [B, H, 256, S_pad] of what a product reduces over
//     keys or q rows: V forward (O = P V); Q, dO and K backward (dK = dS^T Q,
//     dV = P^T dO, dQ = dS K).  S_pad is S rounded up to kPad, zero-filled, so
//     TMA's 16-byte stride rule holds and ragged S needs no masked loads.
//     Within each group of 8 positions, position p holds row 8 (p / 8) +
//     perm8(p % 8): the order in which an accumulator's columns feed a
//     register A fragment (x3::split_acc's permutation), so P goes from the
//     scores' accumulator to O = P V without a shuffle or shared memory.
//
// The budget that decides the design: a hi/lo pair costs 8 bytes an element,
// so a 64-row operand over hd 256 is 128 KB of the block's 227 KB, and two
// (Q and K, or K and V, as the 64-row A of a wgmma) do not fit.  Each
// K / V byte brought from L2 feeds only the q rows the block holds (64 rows:
// ~16 counted flops a byte), so a block is capped near 50 TFLOP/s by L2 alone
// whatever its tensor rate.  The three options weighed:
//   1. 64 resident q rows and 32-key tiles through a ring (chosen for the
//      forward: Q 128 KB + 3 slots of 32 KB);
//   2. a cluster of two blocks sharing each K / V tile by TMA multicast
//      (doubles the reuse; not tried: left for a later slice);
//   3. O as 64-column chunks, each tile's P V in a fresh accumulator (chosen:
//      O is 128 registers a thread, the fresh chunk 32).
// ptxas (CUDA 12.8): forward 230 registers, dK/dV pass 240, dQ pass 190,
// probe 233, 0 spill bytes each; one block an SM (230 KB of shared memory).
// Forward, one block per (batch, q head, 64 q rows): one consumer warpgroup
// and a producer warp.  Q's planes arrive once; each 32-key tile is four
// items through a 3-slot ring of 32 KB: K over hd 0-127 and 128-255 (S = Q K^T,
// m64n32k8, both operands K-major from shared memory, each half in a fresh
// accumulator), then V^T over hd 0-127 and 128-255 (O += P V, m64n64k8 with P
// as the register A operand, one fresh accumulator a 64-column chunk).  The
// online softmax runs in the log2 domain on the accumulator fragments as on
// the wgmma route; masks only on tiles that hold a disallowed pair.
// Backward: D = rowsum(dO O) (flash_delta_kernel), then two passes of one
// template, neither keeping a 64-row operand of a score product resident.
// Both score products (S and dP) take the streamed tile as their 64-row A
// (hd chunks of 32 columns, Q and dO or K and V, 32 KB an item through a
// 2-slot ring) and the block's 32 resident rows as B (K and V, or Q and dO:
// 128 KB); P and dS are written into shared memory as B operands (rows the
// resident index, columns the streamed one in the planes' order), and the
// gradients are taken transposed, M = the head dim: dV^T = dO^T P and dK^T =
// Q^T dS (dK/dV pass, a block per (batch, kv head, 32 keys), streaming the
// 64-row q tiles of the G query heads), dQ^T = K^T dS (dQ pass, a block per
// (batch, q head, 32 q rows), streaming 64-key tiles).  The accumulators over
// the head dim are 4 x 16 registers a thread each.  14 hd flops a (q, k) pair,
// no atomics: two calls give the same bits.
// Accumulation: the tensor cores' fp32 adds truncate, so each product summed
// over a streamed dimension takes each tile in a fresh accumulator added to
// its running sum with IEEE adds: every kPvRefresh keys of O = P V and every
// kGradRefresh rows of dV, dK and dQ; the scores take a fresh accumulator
// every kScoreRefreshFwd (forward) and kScoreRefreshBwd (backward) head-dim
// columns.  tests/test_torch_kernels.py emulates this summation on the CPU
// with the same intervals (FLASH_HD256_REFRESH).
namespace x3w {

using namespace hopper;
using tc::ex2;
using tc::fence_regs;
using tc::kLn2;
using tc::kLog2e;
using tc::needs_mask;
using tc::prefetch_map;
using tc::wgmma_commit_wait;
using tc::wgmma_fence;

constexpr int HD = 256;
constexpr int kConsumer = 128;            // one consumer warpgroup
constexpr int kThreads = kConsumer + 32;  // and a producer warp
constexpr int kPad = 64;                  // the transposed planes' S rounds up to this
constexpr int kSlot = 32 * 1024;          // a ring slot: one item, hi and lo planes
constexpr int kFwdRows = 64;              // forward: q rows a block
constexpr int kFwdKeys = 32;              // forward: keys a tile
constexpr int kFwdSlots = 3;
constexpr int kRes = 32;                  // backward: resident rows a block
constexpr int kTile = 64;                 // backward: rows of a streamed tile
constexpr int kBwdSlots = 2;
// fresh-accumulator intervals (tests/test_torch_kernels.py: FLASH_HD256_REFRESH)
constexpr int kScoreRefreshFwd = 128;  // head-dim columns of S = Q K^T, forward: an item
constexpr int kScoreRefreshBwd = 32;   // head-dim columns of S and dP, backward: an item
constexpr int kPvRefresh = kFwdKeys;   // keys of O = P V: a tile
constexpr int kGradRefresh = kTile;    // rows of dV, dK (q) and dQ (keys): a tile

__host__ __device__ constexpr int padded(int S) { return (S + kPad - 1) / kPad * kPad; }
// Position p of an 8-group holds row 8 (p / 8) + perm8(p % 8); row r sits at
// position 8 (r / 8) + ipos8(r % 8).
__host__ __device__ constexpr int perm8(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }
__host__ __device__ constexpr int ipos8(int r) { return r % 2 == 0 ? r / 2 : r / 2 + 4; }

// K-major operand, 128B swizzle: rows of 128 bytes (32 fp32), 8-row groups
// 1 KB apart; a k8 step is 32 bytes along the row.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return desc(addr, 16, 1024); }

// d[64x32] (+)= A[64x8] B[8x32], TF32, both K-major in shared memory; d is
// overwritten when scale_d is 0.
__device__ __forceinline__ void mma32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64x64] (+)= A[64x8] B[8x64], TF32: A from registers (the fragment
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each warp's 16 rows), B
// K-major in shared memory.
__device__ __forceinline__ void mma64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = A B over k8 steps [0, n_k) as three TF32 products a step (lo hi, hi lo,
// hi hi) into a fresh accumulator; a_lo = a_hi + a_dlo, b_lo = b_hi + b_dlo,
// step kk at a(kk) and b(kk) bytes past the hi planes.
template <int NK, typename AOff, typename BOff>
__device__ __forceinline__ void product32(float (&d)[16], uint32_t a_hi, uint32_t a_dlo,
                                          uint32_t b_hi, uint32_t b_dlo, AOff a, BOff b) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t ah = a_hi + a(kk), bh = b_hi + b(kk);
    mma32(d, kdesc(ah + a_dlo), kdesc(bh), kk > 0);
    mma32(d, kdesc(ah), kdesc(bh + b_dlo), 1);
    mma32(d, kdesc(ah), kdesc(bh), 1);
  }
}

// Byte offset of element (row r, column c) of a [R x 32] fp32 box, 128B-swizzled.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c / 4) ^ (r % 8)) & 7) << 4) + (c % 4) * 4;
}

// ---------------------------------------------------------------- split pass
// a[j] with constant indices only: a runtime index into an array of a kernel
// parameter copies the array to local memory, in every thread
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int j) {
  T x = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (j == i) x = a[i];
  return x;
}

struct SplitRows {  // elementwise: src -> hi, lo, n4 float4s each
  const float4* src[4];
  float4* hi[4];
  float4* lo[4];
  long long n4[4];
};

__global__ void __launch_bounds__(256)
flash_tf32x3_split_kernel(const SplitRows jobs) {
  const int j = blockIdx.y;
  const float4* src = pick(jobs.src, j);
  float4* hi = pick(jobs.hi, j);
  float4* lo = pick(jobs.lo, j);
  const long long n4 = pick(jobs.n4, j);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    const float4 v = __ldg(src + i);
    uint4 h, l;
    x3::split(v.x, h.x, l.x);
    x3::split(v.y, h.y, l.y);
    x3::split(v.z, h.z, l.z);
    x3::split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

struct SplitT {  // [B, S, H, 256] -> [B, H, 256, S_pad], permuted and padded
  const float* src[3];
  uint32_t* hi[3];
  uint32_t* lo[3];
  int H[3];
};

// Block (32 positions, 32 head-dim columns of one head): the rows through a
// 32 x 33 shared tile, both sides coalesced.
__global__ void __launch_bounds__(256)
flash_tf32x3_split_t_kernel(const SplitT jobs, int B, int S, int S_pad) {
  __shared__ float tile[32][33];
  const int j = blockIdx.z / B, b = blockIdx.z % B;
  const int H = pick(jobs.H, j), h = blockIdx.y / (HD / 32), d0 = (blockIdx.y % (HD / 32)) * 32;
  if (h >= H) return;
  const int p0 = blockIdx.x * 32, tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* src = pick(jobs.src, j);
  uint32_t* const hi_plane = pick(jobs.hi, j);
  uint32_t* const lo_plane = pick(jobs.lo, j);
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int s = p0 + r;
    tile[r][tx] = s < S ? __ldg(src + ((static_cast<size_t>(b) * S + s) * H + h) * HD + d0 + tx)
                        : 0.f;
  }
  __syncthreads();
  const int row = 8 * (tx / 8) + perm8(tx % 8);
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    uint32_t hi, lo;
    x3::split(tile[row][r], hi, lo);
    const size_t at = ((static_cast<size_t>(b) * H + h) * HD + d0 + r) * S_pad + p0 + tx;
    hi_plane[at] = hi;
    lo_plane[at] = lo;
  }
}

// ---------------------------------------------------------------- forward
struct FwdMaps {
  CUtensorMap q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_tf32x3_hd256_fwd_kernel(const __grid_constant__ FwdMaps maps, float* __restrict__ o,
                              float* __restrict__ lse, int S, int Hq, int Hkv, int causal,
                              int window, float scale_log2) {
  constexpr uint32_t kQPlane = kFwdRows * HD * 4;  // 64 KB: 8 boxes of 64 rows x 32 columns
  constexpr uint32_t kHalf = kSlot / 2;            // an item's lo plane follows its hi plane
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_hi = base;
  auto slot = [&](int s) { return base + 2 * kQPlane + s * kSlot; };
  const uint32_t bars = base + 2 * kQPlane + kFwdSlots * kSlot;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kFwdSlots + s); };

  // causal: the q tiles with the most k tiles start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kFwdRows;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / (Hq / Hkv);
  int kt_lo, kt_hi;
  k_tile_range(q0, kFwdRows, kFwdKeys, S, causal, window, &kt_lo, &kt_hi);
  const int n = kt_hi - kt_lo;

  if (threadIdx.x == 0) {
    prefetch_map(&maps.q_hi);
    prefetch_map(&maps.k_hi);
    prefetch_map(&maps.vt_hi);
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumer) {
    // ---- producer: Q once, then per key tile K (hd 0-127, 128-255) and V^T
    // (hd 0-127, 128-255), one item a slot
    if (threadIdx.x == kConsumer) {
      mbar_expect_tx(q_full, 2 * kQPlane);
      for (int bx = 0; bx < HD / 32; ++bx) {
        tma_load_4d(q_hi + bx * 8192, &maps.q_hi, q_full, 32 * bx, h, q0, b);
        tma_load_4d(q_hi + kQPlane + bx * 8192, &maps.q_lo, q_full, 32 * bx, h, q0, b);
      }
      for (int j = 0; j < 4 * n; ++j) {
        const int s = j % kFwdSlots, part = j % 4, half = part % 2;
        const int k0 = (kt_lo + j / 4) * kFwdKeys;
        mbar_wait(empty(s), ((j / kFwdSlots) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), kSlot);
        if (part < 2) {  // K rows k0.., columns 128 half..: 4 boxes of 32 x 32 a plane
          for (int bx = 0; bx < 4; ++bx) {
            const int c = 128 * half + 32 * bx;
            tma_load_4d(slot(s) + bx * 4096, &maps.k_hi, full(s), c, hk, k0, b);
            tma_load_4d(slot(s) + kHalf + bx * 4096, &maps.k_lo, full(s), c, hk, k0, b);
          }
        } else {  // V^T rows 128 half.. (head dim), positions k0..: one 128 x 32 box a plane
          tma_load_4d(slot(s), &maps.vt_hi, full(s), k0, 128 * half, hk, b);
          tma_load_4d(slot(s) + kHalf, &maps.vt_lo, full(s), k0, 128 * half, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: q rows q0 .. q0 + 63
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);
  float m[2] = {-1e30f, -1e30f};  // finite: a fully masked row leaves m, l and acc as they are
  float l[2] = {0.f, 0.f};
  float acc[4][32];  // O, 64-column chunk c in acc[c]
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_lo + it) * kFwdKeys;
    // S = Q K^T, unscaled: each head-dim half (an item) in a fresh accumulator
    float part[2][16];
    const int s0 = (4 * it) % kFwdSlots, s1 = (4 * it + 1) % kFwdSlots;
    mbar_wait(full(s0), ((4 * it) / kFwdSlots) & 1);
    mbar_wait(full(s1), ((4 * it + 1) / kFwdSlots) & 1);
    wgmma_fence();
#pragma unroll
    static_assert(kScoreRefreshFwd == HD / 2, "an item is half the head dim");
#pragma unroll
    for (int half = 0; half < 2; ++half)
      product32<kScoreRefreshFwd / 8>(part[half], q_hi + half * 4 * 8192, kQPlane,
                                      slot(half ? s1 : s0), kHalf,
                    [](int kk) { return (kk / 4) * 8192 + (kk % 4) * 32; },
                    [](int kk) { return (kk / 4) * 4096 + (kk % 4) * 32; });
    wgmma_commit_wait();
    fence_acc(part[0]);
    fence_acc(part[1]);
    if (t == 0) {
      mbar_arrive(empty(s0));
      mbar_arrive(empty(s1));
    }
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = part[0][i] + part[1][i];

    // masks only on tiles that hold a disallowed pair; the online softmax in
    // the log2 domain, each row's four lanes reducing in a fixed order
    if (needs_mask(q0, kFwdRows, k0, kFwdKeys, S, causal, window)) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (!allowed(row0 + 8 * ((i / 2) % 2), k0 + 8 * (i / 4) + col0 + i % 2, S, causal,
                     window))
          sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, corr[2];
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
      corr[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i / 2) % 2];
    // P, split in registers: k8 step kk is keys 8 kk.. of the tile, the A
    // fragment (c0, c2, c1, c3) of its accumulator block (the V^T planes
    // hold the keys in that order)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(sc[4 * kk + e], scale_log2, -m[e / 2]));  // 0 where masked
        l[e / 2] += p[e];
      }
      x3::split(p[0], ph[kk][0], pl[kk][0]);
      x3::split(p[2], ph[kk][1], pl[kk][1]);
      x3::split(p[1], ph[kk][2], pl[kk][2]);
      x3::split(p[3], ph[kk][3], pl[kk][3]);
    }

    // O += P V: per head-dim half (an item), per 64-column chunk, the tile's
    // product in a fresh accumulator added with IEEE adds
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 4 * it + 2 + half, s = j % kFwdSlots;
      mbar_wait(full(s), (j / kFwdSlots) & 1);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float f[32];
        wgmma_fence();
        static_assert(kPvRefresh == kFwdKeys, "a tile's P V in a fresh accumulator");
#pragma unroll
        for (int kk = 0; kk < kPvRefresh / 8; ++kk) {
          const uint32_t vb = slot(s) + c * 8192 + kk * 32;
          mma64_rs(f, pl[kk], kdesc(vb), kk > 0);
          mma64_rs(f, ph[kk], kdesc(vb + kHalf), 1);
          mma64_rs(f, ph[kk], kdesc(vb), 1);
        }
        wgmma_commit_wait();
        fence_acc(f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(ph[kk]);
          fence_regs(pl[kk]);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[2 * half + c][i] += f[i];
      }
      if (t == 0) mbar_arrive(empty(s));
    }
  }

  // epilogue: o = acc / l in float2 pairs, lse = m + log(l)
  const size_t row_stride = static_cast<size_t>(Hq) * HD;
  float* ob = o + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(ob + row * row_stride + 64 * c + 8 * j + col0) =
            make_float2(acc[c][4 * j + 2 * hh] * inv, acc[c][4 * j + 2 * hh + 1] * inv);
    if (lane % 4 == 0) lse[(static_cast<size_t>(b) * Hq + h) * S + row] = (m[hh] + log2f(l[hh])) * kLn2;
  }
}

// ---------------------------------------------------------------- backward
// kKV: the dK/dV pass (resident K and V; streamed Q and dO; gradients dV^T =
// dO^T P and dK^T = Q^T dS).  !kKV: the dQ pass (resident Q and dO; streamed
// K and V; dQ^T = K^T dS).  The score products X0 = S and X1 = dP are taken
// with the streamed tile as A (M, 64 rows) and the resident rows as B (N, 32
// rows), so in the dQ pass they are S^T and dP^T.
struct BwdMaps {
  CUtensorMap res_hi[2], res_lo[2];  // natural, boxes of 32 rows: K, V or Q, dO
  CUtensorMap str_hi[2], str_lo[2];  // natural, boxes of 64 rows: Q, dO or K, V
  CUtensorMap tr_hi[2], tr_lo[2];    // transposed, boxes of 64 x 32: dO^T, Q^T or K^T
};

template <bool kKV>
__device__ __forceinline__ void bwd_pass(const BwdMaps& maps, const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         float* __restrict__ out0, float* __restrict__ out1,
                                         int S, int Hq, int Hkv, int causal, int window,
                                         float scale, float scale_log2) {
  constexpr int NO = kKV ? 2 : 1;                 // gradients a block writes
  constexpr uint32_t kResPlane = kRes * HD * 4;   // 32 KB: 8 boxes of 32 rows x 32 columns
  constexpr uint32_t kBPlane = kRes * kTile * 4;  // 8 KB: a written B operand, 2 boxes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));  // generic address of base
  // resident X_i's B: hi at res(i), lo a plane later
  auto res = [&](int i) { return base + 2 * i * kResPlane; };
  auto slot = [&](int s) { return base + 4 * kResPlane + s * kSlot; };
  const uint32_t bops = 4 * kResPlane + kBwdSlots * kSlot;  // offset of the written B operands
  const uint32_t bars = base + bops + NO * 2 * kBPlane;
  const uint32_t res_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kBwdSlots + s); };

  const int G = Hq / Hkv;
  const int b = blockIdx.y / (kKV ? Hkv : Hq), hb = blockIdx.y % (kKV ? Hkv : Hq);
  // the block's resident rows [r0, r0 + 32): keys (dK/dV) or q rows (dQ)
  const int rt = kKV || !causal ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int r0 = rt * kRes;
  // the streamed tiles: q tiles of the G heads that see the keys, or the
  // key tiles the q rows see
  int lo_t, nt, n;
  if (kKV) {
    int first = 0, end = S;
    if (causal) {
      first = r0;
      if (window > 0) end = min(S, r0 + kRes - 1 + window);
    }
    lo_t = first / kTile;
    nt = (end + kTile - 1) / kTile - lo_t;
    n = G * nt;
  } else {
    int kt_hi;
    k_tile_range(r0, kRes, kTile, S, causal, window, &lo_t, &kt_hi);
    nt = kt_hi - lo_t;
    n = nt;
  }
  // tile it: its first streamed row and its head (the streamed tensors' head)
  auto tile_row = [&](int it) { return (lo_t + it % nt) * kTile; };
  auto tile_head = [&](int it) { return kKV ? hb * G + it / nt : hb / G; };

  if (threadIdx.x == 0) {
    prefetch_map(&maps.res_hi[0]);
    prefetch_map(&maps.str_hi[0]);
    prefetch_map(&maps.tr_hi[0]);
    mbar_init(res_full, 1);
    for (int s = 0; s < kBwdSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumer) {
    // ---- producer: the resident rows once, then per streamed tile 8 score
    // items (hd chunk c of both streamed tensors) and 4 gradient items per
    // output (head-dim rows 64 mb.. of its transposed plane, 64 positions)
    if (threadIdx.x == kConsumer) {
      mbar_expect_tx(res_full, 4 * kResPlane);
      for (int i = 0; i < 2; ++i)
        for (int bx = 0; bx < HD / 32; ++bx) {
          tma_load_4d(res(i) + bx * 4096, &maps.res_hi[i], res_full, 32 * bx, hb, r0, b);
          tma_load_4d(res(i) + kResPlane + bx * 4096, &maps.res_lo[i], res_full, 32 * bx, hb,
                      r0, b);
        }
      int j = 0;
      for (int it = 0; it < n; ++it) {
        const int t0 = tile_row(it), th = tile_head(it);
        // the transposed planes' head: Q^T and dO^T by q head, K^T by kv head
        for (int item = 0; item < 8 + 4 * NO; ++item, ++j) {
          const int s = j % kBwdSlots;
          mbar_wait(empty(s), ((j / kBwdSlots) & 1) ^ 1);
          mbar_expect_tx(full(s), kSlot);
          if (item < 8) {  // X0's and X1's A: rows t0.., hd columns 32 item..
            for (int i = 0; i < 2; ++i) {
              tma_load_4d(slot(s) + i * 16384, &maps.str_hi[i], full(s), 32 * item, th, t0, b);
              tma_load_4d(slot(s) + i * 16384 + 8192, &maps.str_lo[i], full(s), 32 * item, th,
                          t0, b);
            }
          } else {  // output (item - 8) / 4's A: hd rows 64 mb.., positions t0..
            const int ot = (item - 8) / 4, mb = (item - 8) % 4;
            for (int sub = 0; sub < 2; ++sub) {
              tma_load_4d(slot(s) + sub * 8192, &maps.tr_hi[ot], full(s), t0 + 32 * sub, 64 * mb,
                          th, b);
              tma_load_4d(slot(s) + 16384 + sub * 8192, &maps.tr_lo[ot], full(s), t0 + 32 * sub,
                          64 * mb, th, b);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  // the dQ pass's statistics are by column (its q rows), fixed for the block
  float cl[8], cd[8];
  if (!kKV) {
    const size_t stat = (static_cast<size_t>(b) * Hq + hb) * S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = r0 + 8 * (i / 2) + 2 * tq + i % 2;
      cl[i] = q < S ? lse[stat + q] * kLog2e : 0.f;
      cd[i] = q < S ? delta[stat + q] : 0.f;
    }
  }
  float acc[NO][4][16];  // the gradients, transposed: head-dim rows 64 mb.. in acc[o][mb]
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[o][mb][i] = 0.f;

  mbar_wait(res_full, 0);
  int j = 0;
  for (int it = 0; it < n; ++it) {
    const int t0 = tile_row(it), th = tile_head(it);
    // the dK/dV pass's statistics are by row (the tile's q rows)
    float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
    if (kKV) {
      const size_t stat = (static_cast<size_t>(b) * Hq + th) * S;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = t0 + 16 * warp + g + 8 * hh;
        rl[hh] = q < S ? lse[stat + q] * kLog2e : 0.f;
        rd[hh] = q < S ? delta[stat + q] : 0.f;
      }
    }
    // X0 = S and X1 = dP (dQ pass: transposed), each hd chunk in a fresh
    // accumulator
    static_assert(kScoreRefreshBwd == 32, "an item is 32 head-dim columns, a 128-byte box");
    float x[2][16] = {};
    for (int c = 0; c < HD / kScoreRefreshBwd; ++c, ++j) {
      const int s = j % kBwdSlots;
      mbar_wait(full(s), (j / kBwdSlots) & 1);
      float part[2][16];
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i)
        product32<kScoreRefreshBwd / 8>(part[i], slot(s) + i * 16384, 8192,
                                        res(i) + c * 4096, kResPlane,
                     [](int kk) { return kk * 32; }, [](int kk) { return kk * 32; });
      wgmma_commit_wait();
      fence_acc(part[0]);
      fence_acc(part[1]);
      if (t == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 16; ++e) x[i][e] += part[i][e];
    }

    // P = exp(S scale - lse) and dS = P (dP - D), masked only on tiles that
    // hold a disallowed pair or rows past S
    const int q_first = kKV ? t0 : r0, k_first = kKV ? r0 : t0;
    const bool mask = needs_mask(q_first, kKV ? kTile : kRes, k_first, kKV ? kRes : kTile, S,
                                 causal, window);
    float pv[16], dsv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // accumulator i: streamed row mr (M), resident row nc (N)
      const int hh = (i / 2) % 2, ci = 2 * (i / 4) + i % 2;
      const int mr = 16 * warp + g + 8 * hh, nc = 8 * (i / 4) + 2 * tq + i % 2;
      const int q = kKV ? t0 + mr : r0 + nc, key = kKV ? r0 + nc : t0 + mr;
      float p = ex2(fmaf(x[0][i], scale_log2, -(kKV ? rl[hh] : cl[ci])));
      if (mask && !(q < S && allowed(q, key, S, causal, window))) p = 0.f;
      pv[i] = p;
      dsv[i] = p * (x[1][i] - (kKV ? rd[hh] : cd[ci]));
    }
    // ... written as the gradient products' B operands (the last tile's
    // products that read them have completed): row = the resident row,
    // column = the streamed row's position in the planes' order, hi then lo
    // plane, 128B-swizzled.  dK/dV: P^T for dV, dS^T for dK; dQ: dS.
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int hh = (i / 2) % 2;
      const int nc = 8 * (i / 4) + 2 * tq + i % 2;
      const int pos = 8 * (2 * warp + hh) + ipos8(g);  // of streamed row 16 warp + g + 8 hh
      uint32_t* at = reinterpret_cast<uint32_t*>(gbase + bops + (pos / 32) * 4096 +
                                                 swz(nc, pos % 32));
      constexpr int kLo = kBPlane / 4, kNext = 2 * kBPlane / 4;  // in words
      uint32_t hi, lo;
      x3::split(kKV ? pv[i] : dsv[i], hi, lo);
      at[0] = hi;
      at[kLo] = lo;
      if (kKV) {
        x3::split(dsv[i], hi, lo);
        at[kNext] = hi;
        at[kNext + kLo] = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumer) : "memory");

    // the gradients, transposed (M = the head dim): output o's head-dim rows
    // 64 mb.. from its transposed plane (an item) times its B operand, the
    // tile's product in a fresh accumulator added with IEEE adds
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int mb = 0; mb < 4; ++mb, ++j) {
        const int s = j % kBwdSlots;
        mbar_wait(full(s), (j / kBwdSlots) & 1);
        float f[16];
        wgmma_fence();
        static_assert(kGradRefresh == kTile, "a streamed tile's rows in a fresh accumulator");
        product32<kGradRefresh / 8>(f, slot(s), 16384, base + bops + o * 2 * kBPlane, kBPlane,
                     [](int kk) { return (kk / 4) * 8192 + (kk % 4) * 32; },
                     [](int kk) { return (kk / 4) * 4096 + (kk % 4) * 32; });
        wgmma_commit_wait();
        fence_acc(f);
        if (t == 0) mbar_arrive(empty(s));
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[o][mb][i] += f[i];
      }
    }
  }

  // epilogue: acc[o][mb][i] is head-dim row 64 mb + 16 warp + g + 8 ((i / 2) %
  // 2) of resident row r0 + 8 (i / 4) + 2 tq + i % 2; dK and dQ scaled once
  const int Ho = kKV ? Hkv : Hq;
  const size_t row_stride = static_cast<size_t>(Ho) * HD;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    float* ob = (o == 0 ? out0 : out1) + static_cast<size_t>(b) * S * row_stride +
                static_cast<size_t>(hb) * HD;
    const float mul = kKV && o == 0 ? 1.f : scale;
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = r0 + 8 * (i / 4) + 2 * tq + i % 2;
        if (row < S)
          ob[row * row_stride + 64 * mb + 16 * warp + g + 8 * ((i / 2) % 2)] = acc[o][mb][i] * mul;
      }
  }
}

// The two passes as kernels of their own names (profiles tell them apart).
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32x3_hd256_dkdv_kernel(const __grid_constant__ BwdMaps maps,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dv, float* __restrict__ dk, int S, int Hq,
                               int Hkv, int causal, int window, float scale, float scale_log2) {
  bwd_pass<true>(maps, lse, delta, dv, dk, S, Hq, Hkv, causal, window, scale, scale_log2);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_tf32x3_hd256_dq_kernel(const __grid_constant__ BwdMaps maps,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int Hq, int Hkv, int causal,
                             int window, float scale, float scale_log2) {
  bwd_pass<false>(maps, lse, delta, dq, nullptr, S, Hq, Hkv, causal, window, scale, scale_log2);
}

// -------------------------------------------------------------- the probe
// The route's building blocks on one tile, from the split pass's planes: s =
// q k^T [64 x 32] (both K-major from shared memory), o = s v [64 x 256] (s as
// the register A operand against the permuted V^T planes) and z = s^T q
// [32 x 256] (s written as a B operand in the planes' order, Q^T as A: the
// backward's transposed gradient product); q [64, 256], k and v [32, 256].
struct ProbeMaps {
  CUtensorMap q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo, qt_hi, qt_lo;
};

__global__ void __launch_bounds__(kConsumer, 1)
flash_tf32x3_hd256_probe_kernel(const __grid_constant__ ProbeMaps maps, float* __restrict__ s_out,
                                float* __restrict__ o_out, float* __restrict__ z_out) {
  constexpr uint32_t kQPlane = 64 * HD * 4, kHalf = kSlot / 2, kBPlane = kRes * kTile * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t a_reg = base, b_reg = base + 2 * kQPlane, bop = b_reg + 2 * kSlot;
  const uint32_t bar = bop + 2 * kBPlane;  // three barriers, one a phase
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {  // Q's planes, and K as the forward's two items
    mbar_expect_tx(bar, 2 * kQPlane + 2 * kSlot);
    for (int bx = 0; bx < HD / 32; ++bx) {
      tma_load_4d(a_reg + bx * 8192, &maps.q_hi, bar, 32 * bx, 0, 0, 0);
      tma_load_4d(a_reg + kQPlane + bx * 8192, &maps.q_lo, bar, 32 * bx, 0, 0, 0);
      const uint32_t kb = b_reg + (bx / 4) * kSlot + (bx % 4) * 4096;
      tma_load_4d(kb, &maps.k_hi, bar, 32 * bx, 0, 0, 0);
      tma_load_4d(kb + kHalf, &maps.k_lo, bar, 32 * bx, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float part[2][16];
  wgmma_fence();
#pragma unroll
  for (int half = 0; half < 2; ++half)
    product32<16>(part[half], a_reg + half * 4 * 8192, kQPlane, b_reg + half * kSlot, kHalf,
                  [](int kk) { return (kk / 4) * 8192 + (kk % 4) * 32; },
                  [](int kk) { return (kk / 4) * 4096 + (kk % 4) * 32; });
  wgmma_commit_wait();
  fence_acc(part[0]);
  fence_acc(part[1]);
  float sc[16];
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[i] = part[0][i] + part[1][i];
    s_out[(16 * warp + g + 8 * ((i / 2) % 2)) * 32 + 8 * (i / 4) + 2 * tq + i % 2] = sc[i];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    x3::split(sc[4 * kk], ph[kk][0], pl[kk][0]);
    x3::split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
    x3::split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
    x3::split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
  __syncthreads();  // K is consumed: V^T's two items take its place
  if (t == 0) {
    mbar_expect_tx(bar + 8, 2 * kSlot);
    for (int half = 0; half < 2; ++half) {
      tma_load_4d(b_reg + half * kSlot, &maps.vt_hi, bar + 8, 0, 128 * half, 0, 0);
      tma_load_4d(b_reg + half * kSlot + kHalf, &maps.vt_lo, bar + 8, 0, 128 * half, 0, 0);
    }
  }
  mbar_wait(bar + 8, 0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float f[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t vb = b_reg + (c / 2) * kSlot + (c % 2) * 8192 + kk * 32;
      mma64_rs(f, pl[kk], kdesc(vb), kk > 0);
      mma64_rs(f, ph[kk], kdesc(vb + kHalf), 1);
      mma64_rs(f, ph[kk], kdesc(vb), 1);
    }
    wgmma_commit_wait();
    fence_acc(f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      o_out[(16 * warp + g + 8 * ((i / 2) % 2)) * HD + 64 * c + 8 * (i / 4) + 2 * tq + i % 2] =
          f[i];
  }
  // s as the B operand [32 keys x 64 q positions], as the dK/dV pass writes P^T
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int hh = (i / 2) % 2, nc = 8 * (i / 4) + 2 * tq + i % 2;
    const int pos = 8 * (2 * warp + hh) + ipos8(g);
    uint32_t* at = reinterpret_cast<uint32_t*>(gbase + (bop - base) + (pos / 32) * 4096 +
                                               swz(nc, pos % 32));
    uint32_t hi, lo;
    x3::split(sc[i], hi, lo);
    at[0] = hi;
    at[kBPlane / 4] = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // and Q is consumed: Q^T's four items take its place
  if (t == 0) {
    mbar_expect_tx(bar + 16, 4 * kSlot);
    for (int mb = 0; mb < 4; ++mb)
      for (int sub = 0; sub < 2; ++sub) {
        tma_load_4d(a_reg + mb * kSlot + sub * 8192, &maps.qt_hi, bar + 16, 32 * sub, 64 * mb, 0,
                    0);
        tma_load_4d(a_reg + mb * kSlot + 16384 + sub * 8192, &maps.qt_lo, bar + 16, 32 * sub,
                    64 * mb, 0, 0);
      }
  }
  mbar_wait(bar + 16, 0);
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
    float f[16];
    wgmma_fence();
    product32<8>(f, a_reg + mb * kSlot, 16384, bop, kBPlane,
                 [](int kk) { return (kk / 4) * 8192 + (kk % 4) * 32; },
                 [](int kk) { return (kk / 4) * 4096 + (kk % 4) * 32; });
    wgmma_commit_wait();
    fence_acc(f);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      z_out[(8 * (i / 4) + 2 * tq + i % 2) * HD + 64 * mb + 16 * warp + g + 8 * ((i / 2) % 2)] =
          f[i];
  }
}

// ---------------------------------------------------------------- launches
// A 4-D fp32 tensor map over a contiguous array of extents dims (innermost
// first), boxes of `box`, 128B-swizzled (the inner box is 32 floats, 128
// bytes); elements out of bounds read as zeros.
bool encode_f32(CUtensorMap* map, const float* ptr, const int (&dims)[4], const int (&box)[4]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[4], strides[3];
  cuuint32_t bx[4], elem_strides[4] = {1, 1, 1, 1};
  cuuint64_t stride = 4;
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    stride *= d[i];
    if (i < 3) strides[i] = stride;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), d, strides, bx,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A natural plane [B, S, H, 256] in boxes of 32 columns x `rows` rows.
bool encode_nat(CUtensorMap* map, const float* p, int B, int S, int H, int rows) {
  return encode_f32(map, p, {HD, H, S, B}, {32, 1, rows, 1});
}
// A transposed plane [B, H, 256, S_pad] in boxes of 32 positions x `rows`
// head-dim rows.
bool encode_tr(CUtensorMap* map, const float* p, int B, int S_pad, int H, int rows) {
  return encode_f32(map, p, {S_pad, HD, H, B}, {32, rows, 1, 1});
}

// The workspace, in floats, as kernels/flash_attention.py's workspace()
// allocates it: hi and lo planes, natural ones first.  Forward: Q, K, V^T.
// Backward: Q, dO, K, V, Q^T, dO^T, K^T.
struct Carve {
  float* at;
  float* take(size_t n) {
    float* p = at;
    at += n;
    return p;
  }
};

cudaError_t split_rows(const SplitRows& jobs, int njobs, long long max_n4, cudaStream_t stream) {
  const long long want = (max_n4 + 255) / 256;
  dim3 grid(static_cast<unsigned>(want < 2048 ? want : 2048), njobs);
  flash_tf32x3_split_kernel<<<grid, 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

cudaError_t split_t(const SplitT& jobs, int njobs, int B, int S, int Hmax, cudaStream_t stream) {
  dim3 grid(padded(S) / 32, Hmax * (HD / 32), B * njobs);
  flash_tf32x3_split_t_kernel<<<grid, 256, 0, stream>>>(jobs, B, S, padded(S));
  return cudaGetLastError();
}

constexpr int fwd_smem() { return 2 * kFwdRows * HD * 4 + kFwdSlots * kSlot + 8 * (1 + 2 * kFwdSlots) + 1024; }
template <bool kKV>
constexpr int bwd_smem() {
  return 4 * kRes * HD * 4 + kBwdSlots * kSlot + (kKV ? 2 : 1) * 2 * kRes * kTile * 4 +
         8 * (1 + 2 * kBwdSlots) + 1024;
}
constexpr int probe_smem() { return 2 * 64 * HD * 4 + 2 * kSlot + 2 * kRes * kTile * 4 + 24 + 1024; }

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* ws, int B,
                int S, int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const size_t nq = static_cast<size_t>(B) * S * Hq * HD, nk = static_cast<size_t>(B) * S * Hkv * HD;
  const size_t nkt = static_cast<size_t>(B) * Hkv * HD * padded(S);
  Carve w{static_cast<float*>(ws)};
  float *qh = w.take(nq), *ql = w.take(nq), *kh = w.take(nk), *kl = w.take(nk);
  float *vth = w.take(nkt), *vtl = w.take(nkt);
  SplitRows rows{{static_cast<const float4*>(q), static_cast<const float4*>(k)},
                 {reinterpret_cast<float4*>(qh), reinterpret_cast<float4*>(kh)},
                 {reinterpret_cast<float4*>(ql), reinterpret_cast<float4*>(kl)},
                 {static_cast<long long>(nq / 4), static_cast<long long>(nk / 4)}};
  cudaError_t err = split_rows(rows, 2, nq / 4, stream);
  if (err != cudaSuccess) return err;
  SplitT tr{{static_cast<const float*>(v)}, {reinterpret_cast<uint32_t*>(vth)},
            {reinterpret_cast<uint32_t*>(vtl)}, {Hkv}};
  err = split_t(tr, 1, B, S, Hkv, stream);
  if (err != cudaSuccess) return err;
  FwdMaps maps;
  if (!encode_nat(&maps.q_hi, qh, B, S, Hq, kFwdRows) ||
      !encode_nat(&maps.q_lo, ql, B, S, Hq, kFwdRows) ||
      !encode_nat(&maps.k_hi, kh, B, S, Hkv, kFwdKeys) ||
      !encode_nat(&maps.k_lo, kl, B, S, Hkv, kFwdKeys) ||
      !encode_tr(&maps.vt_hi, vth, B, padded(S), Hkv, 128) ||
      !encode_tr(&maps.vt_lo, vtl, B, padded(S), Hkv, 128))
    return cudaErrorInvalidValue;
  err = allow_smem(flash_tf32x3_hd256_fwd_kernel, fwd_smem());
  if (err != cudaSuccess) return err;
  dim3 grid((S + kFwdRows - 1) / kFwdRows, B * Hq);
  flash_tf32x3_hd256_fwd_kernel<<<grid, kThreads, fwd_smem(), stream>>>(
      maps, static_cast<float*>(o), static_cast<float*>(lse), S, Hq, Hkv, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* delta, void* dq, void* dk, void* dv, void* ws, int B,
                int S, int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const int Sp = padded(S);
  const size_t nq = static_cast<size_t>(B) * S * Hq * HD, nk = static_cast<size_t>(B) * S * Hkv * HD;
  const size_t nqt = static_cast<size_t>(B) * Hq * HD * Sp, nkt = static_cast<size_t>(B) * Hkv * HD * Sp;
  Carve w{static_cast<float*>(ws)};
  float *qh = w.take(nq), *ql = w.take(nq), *doh = w.take(nq), *dol = w.take(nq);
  float *kh = w.take(nk), *kl = w.take(nk), *vh = w.take(nk), *vl = w.take(nk);
  float *qth = w.take(nqt), *qtl = w.take(nqt), *doth = w.take(nqt), *dotl = w.take(nqt);
  float *kth = w.take(nkt), *ktl = w.take(nkt);
  auto f4 = [](const void* p) { return static_cast<const float4*>(p); };
  auto w4 = [](float* p) { return reinterpret_cast<float4*>(p); };
  auto u = [](float* p) { return reinterpret_cast<uint32_t*>(p); };
  const long long n4q = static_cast<long long>(nq / 4), n4k = static_cast<long long>(nk / 4);
  SplitRows rows{{f4(q), f4(dout), f4(k), f4(v)},
                 {w4(qh), w4(doh), w4(kh), w4(vh)},
                 {w4(ql), w4(dol), w4(kl), w4(vl)},
                 {n4q, n4q, n4k, n4k}};
  cudaError_t err = split_rows(rows, 4, n4q, stream);
  if (err != cudaSuccess) return err;
  SplitT tr{{static_cast<const float*>(q), static_cast<const float*>(dout),
             static_cast<const float*>(k)},
            {u(qth), u(doth), u(kth)},
            {u(qtl), u(dotl), u(ktl)},
            {Hq, Hq, Hkv}};
  err = split_t(tr, 3, B, S, Hq, stream);
  if (err != cudaSuccess) return err;
  const int rows_total = B * S * Hq;
  float* dt = static_cast<float*>(delta);
  flash_delta_kernel<float, HD><<<(rows_total + 31) / 32, 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dt, rows_total, S, Hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dK/dV: resident K, V (32 keys), streamed Q, dO (64 rows), dO^T for dV
  // and Q^T for dK
  BwdMaps kv, dqm;
  if (!encode_nat(&kv.res_hi[0], kh, B, S, Hkv, kRes) || !encode_nat(&kv.res_lo[0], kl, B, S, Hkv, kRes) ||
      !encode_nat(&kv.res_hi[1], vh, B, S, Hkv, kRes) || !encode_nat(&kv.res_lo[1], vl, B, S, Hkv, kRes) ||
      !encode_nat(&kv.str_hi[0], qh, B, S, Hq, kTile) || !encode_nat(&kv.str_lo[0], ql, B, S, Hq, kTile) ||
      !encode_nat(&kv.str_hi[1], doh, B, S, Hq, kTile) ||
      !encode_nat(&kv.str_lo[1], dol, B, S, Hq, kTile) ||
      !encode_tr(&kv.tr_hi[0], doth, B, Sp, Hq, kTile) || !encode_tr(&kv.tr_lo[0], dotl, B, Sp, Hq, kTile) ||
      !encode_tr(&kv.tr_hi[1], qth, B, Sp, Hq, kTile) || !encode_tr(&kv.tr_lo[1], qtl, B, Sp, Hq, kTile))
    return cudaErrorInvalidValue;
  // dQ: resident Q, dO (32 rows), streamed K, V (64 keys), K^T
  if (!encode_nat(&dqm.res_hi[0], qh, B, S, Hq, kRes) || !encode_nat(&dqm.res_lo[0], ql, B, S, Hq, kRes) ||
      !encode_nat(&dqm.res_hi[1], doh, B, S, Hq, kRes) ||
      !encode_nat(&dqm.res_lo[1], dol, B, S, Hq, kRes) ||
      !encode_nat(&dqm.str_hi[0], kh, B, S, Hkv, kTile) ||
      !encode_nat(&dqm.str_lo[0], kl, B, S, Hkv, kTile) ||
      !encode_nat(&dqm.str_hi[1], vh, B, S, Hkv, kTile) ||
      !encode_nat(&dqm.str_lo[1], vl, B, S, Hkv, kTile) ||
      !encode_tr(&dqm.tr_hi[0], kth, B, Sp, Hkv, kTile) ||
      !encode_tr(&dqm.tr_lo[0], ktl, B, Sp, Hkv, kTile))
    return cudaErrorInvalidValue;
  dqm.tr_hi[1] = dqm.tr_hi[0];
  dqm.tr_lo[1] = dqm.tr_lo[0];
  err = allow_smem(flash_tf32x3_hd256_dkdv_kernel, bwd_smem<true>());
  if (err == cudaSuccess) err = allow_smem(flash_tf32x3_hd256_dq_kernel, bwd_smem<false>());
  if (err != cudaSuccess) return err;
  const float* lt = static_cast<const float*>(lse);
  flash_tf32x3_hd256_dkdv_kernel<<<dim3((S + kRes - 1) / kRes, B * Hkv), kThreads,
                                   bwd_smem<true>(), stream>>>(
      kv, lt, dt, static_cast<float*>(dv), static_cast<float*>(dk), S, Hq, Hkv, causal, window,
      scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_tf32x3_hd256_dq_kernel<<<dim3((S + kRes - 1) / kRes, B * Hq), kThreads,
                                 bwd_smem<false>(), stream>>>(
      dqm, lt, dt, static_cast<float*>(dq), S, Hq, Hkv, causal, window, scale, scale * kLog2e);
  return cudaGetLastError();
}

// q [64, 256], k and v [32, 256]; s [64, 32], o [64, 256], z [32, 256]; ws
// holds eight planes of 64 x 256 floats.
cudaError_t probe(const void* q, const void* k, const void* v, void* s, void* o, void* z,
                  void* ws, cudaStream_t stream) {
  constexpr size_t kPlaneFloats = 64 * HD;
  Carve w{static_cast<float*>(ws)};
  float *qh = w.take(kPlaneFloats), *ql = w.take(kPlaneFloats), *kh = w.take(kPlaneFloats);
  float *kl = w.take(kPlaneFloats), *vth = w.take(kPlaneFloats), *vtl = w.take(kPlaneFloats);
  float *qth = w.take(kPlaneFloats), *qtl = w.take(kPlaneFloats);
  SplitRows rows{{static_cast<const float4*>(q), static_cast<const float4*>(k)},
                 {reinterpret_cast<float4*>(qh), reinterpret_cast<float4*>(kh)},
                 {reinterpret_cast<float4*>(ql), reinterpret_cast<float4*>(kl)},
                 {64 * HD / 4, 32 * HD / 4}};
  cudaError_t err = split_rows(rows, 2, 64 * HD / 4, stream);
  if (err != cudaSuccess) return err;
  SplitT vt{{static_cast<const float*>(v)}, {reinterpret_cast<uint32_t*>(vth)},
            {reinterpret_cast<uint32_t*>(vtl)}, {1}};
  SplitT qt{{static_cast<const float*>(q)}, {reinterpret_cast<uint32_t*>(qth)},
            {reinterpret_cast<uint32_t*>(qtl)}, {1}};
  err = split_t(vt, 1, 1, 32, 1, stream);
  if (err == cudaSuccess) err = split_t(qt, 1, 1, 64, 1, stream);
  if (err != cudaSuccess) return err;
  ProbeMaps maps;
  if (!encode_nat(&maps.q_hi, qh, 1, 64, 1, 64) || !encode_nat(&maps.q_lo, ql, 1, 64, 1, 64) ||
      !encode_nat(&maps.k_hi, kh, 1, 32, 1, 32) || !encode_nat(&maps.k_lo, kl, 1, 32, 1, 32) ||
      !encode_tr(&maps.vt_hi, vth, 1, padded(32), 1, 128) ||
      !encode_tr(&maps.vt_lo, vtl, 1, padded(32), 1, 128) ||
      !encode_tr(&maps.qt_hi, qth, 1, padded(64), 1, 64) ||
      !encode_tr(&maps.qt_lo, qtl, 1, padded(64), 1, 64))
    return cudaErrorInvalidValue;
  err = allow_smem(flash_tf32x3_hd256_probe_kernel, probe_smem());
  if (err != cudaSuccess) return err;
  flash_tf32x3_hd256_probe_kernel<<<1, kConsumer, probe_smem(), stream>>>(
      maps, static_cast<float*>(s), static_cast<float*>(o), static_cast<float*>(z));
  return cudaGetLastError();
}

}  // namespace x3w

#define REPRO_TF32X3_HEAD_DIMS(X) X(64) X(80) X(96) X(128)

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
// and then the dQ pass on the stream.  kmean is the keys' mean over the
// sequence, [B, Hkv, hd] in q's dtype (the dQ pass's correction).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, const void* kmean, int B,
                                         int S, int Hq, int Hkv, int hd, int dtype, int causal,
                                         int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(HD)                                                                      \
  if (hd == HD) {                                                                          \
    if (dtype == 0) return (int)bwd<float, HD>(q, k, v, o, lse, dout, dq, dk, dv, kmean, B, \
                                               S, Hq, Hkv, causal, window, scale, st);    \
    if (dtype == 1) return (int)bwd<__nv_bfloat16, HD>(q, k, v, o, lse, dout, dq, dk, dv,  \
                                                       kmean, B, S, Hq, Hkv, causal,       \
                                                       window, scale, st);                \
  }
  REPRO_HEAD_DIMS(REPRO_BWD)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// The wgmma route: bf16, hd 64, 80, 96, 128 or 256, every pointer 16-byte aligned
// (flash_attention.py's route() decides).  Same arguments as above, no dtype.
extern "C" int repro_flash_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int S, int Hq, int Hkv, int hd, int causal,
                                     int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WGMMA_FWD(HD) \
  if (hd == HD) return (int)tc::fwd<HD>(q, k, v, o, lse, B, S, Hq, Hkv, causal, window, scale, st);
  REPRO_HEAD_DIMS(REPRO_WGMMA_FWD)
#undef REPRO_WGMMA_FWD
  return (int)cudaErrorInvalidValue;
}

// The backward's three launches: D = rowsum(dO * O) into `delta` ([B, Hq, S]
// fp32 scratch), the dK/dV pass, the dQ pass; kmean is the keys' mean over
// the sequence, [B, Hkv, hd] bf16 (the dQ pass's correction).
extern "C" int repro_flash_wgmma_bwd(const void* q, const void* k, const void* v, const void* o,
                                     const void* lse, const void* dout, void* delta, void* dq,
                                     void* dk, void* dv, const void* kmean, int B, int S, int Hq,
                                     int Hkv, int hd, int causal, int window, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WGMMA_BWD(HD)                                                                     \
  if (hd == HD)                                                                                 \
    return (int)tc::bwd<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, kmean, B, S, Hq, Hkv,     \
                            causal, window, scale, st);
  REPRO_HEAD_DIMS(REPRO_WGMMA_BWD)
#undef REPRO_WGMMA_BWD
  return (int)cudaErrorInvalidValue;
}

// One tile of the forward's products, for checking the descriptors and
// fragment layouts against a matrix product: q [64, hd], k and v [bk, hd]
// bf16; s = q k^T [64, bk] and o = bf16(s) v [64, hd], both fp32.  hd 96 or
// 128 with bk 64 or 128; hd 256 with bk 32 (the dQ pass's tiles) or 64 (the
// forward's and the dK/dV pass's).
extern "C" int repro_flash_wgmma_probe(const void* q, const void* k, const void* v, void* s,
                                       void* o, int hd, int bk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 96 && bk == 64) return (int)tc::probe<96, 64>(q, k, v, s, o, st);
  if (hd == 96 && bk == 128) return (int)tc::probe<96, 128>(q, k, v, s, o, st);
  if (hd == 128 && bk == 64) return (int)tc::probe<128, 64>(q, k, v, s, o, st);
  if (hd == 128 && bk == 128) return (int)tc::probe<128, 128>(q, k, v, s, o, st);
  if (hd == 256 && bk == 32) return (int)tc::probe<256, 32>(q, k, v, s, o, st);
  if (hd == 256 && bk == 64) return (int)tc::probe<256, 64>(q, k, v, s, o, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a wgmma block at head dim hd, for build reports:
// kernel 0 the forward, 1 the dK/dV pass, 2 the dQ pass; -1 for another hd.
extern "C" int repro_flash_wgmma_smem_bytes(int kernel, int hd) {
#define REPRO_WGMMA_SMEM(HD) \
  if (hd == HD)              \
    return kernel == 0 ? tc::fwd_smem<HD>() : kernel == 1 ? tc::dkdv_smem<HD>() : tc::dq_smem<HD>();
  REPRO_HEAD_DIMS(REPRO_WGMMA_SMEM)
#undef REPRO_WGMMA_SMEM
  return -1;
}

// The tf32x3 route: fp32, hd 64, 80, 96, 128 or 256, every pointer 16-byte
// aligned (flash_attention.py's route() decides).  The same arguments as the
// wgmma route's entry points and `ws`, the split planes' workspace at hd 256
// (flash_attention.py's workspace() allocates it per call; unused below hd
// 256); the backward's launches are D = rowsum(dO * O) into `delta`, the
// dK/dV pass and the dQ pass, after the split pass at hd 256.
extern "C" int repro_flash_tf32x3_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, void* ws, int B, int S, int Hq, int Hkv, int hd,
                                      int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 256) return (int)x3w::fwd(q, k, v, o, lse, ws, B, S, Hq, Hkv, causal, window, scale, st);
#define REPRO_X3_FWD(HD) \
  if (hd == HD) return (int)x3::fwd<HD>(q, k, v, o, lse, B, S, Hq, Hkv, causal, window, scale, st);
  REPRO_TF32X3_HEAD_DIMS(REPRO_X3_FWD)
#undef REPRO_X3_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_tf32x3_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, void* ws, int B, int S, int Hq, int Hkv,
                                      int hd, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return (int)x3w::bwd(q, k, v, o, lse, dout, delta, dq, dk, dv, ws, B, S, Hq, Hkv, causal,
                         window, scale, st);
#define REPRO_X3_BWD(HD)                                                                     \
  if (hd == HD)                                                                              \
    return (int)x3::bwd<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, S, Hq, Hkv, causal, \
                            window, scale, st);
  REPRO_TF32X3_HEAD_DIMS(REPRO_X3_BWD)
#undef REPRO_X3_BWD
  return (int)cudaErrorInvalidValue;
}

// One 16-row tile of the forward's products, for checking the planes,
// fragment layouts and permutation against a matrix product: q [16, hd], k
// and v [32, hd] fp32; s = q k^T [16, 32] and o = s v [16, hd], both fp32.
// hd 96 or 128.
extern "C" int repro_flash_tf32x3_probe(const void* q, const void* k, const void* v, void* s,
                                        void* o, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 96) return (int)x3::probe<96>(q, k, v, s, o, st);
  if (hd == 128) return (int)x3::probe<128>(q, k, v, s, o, st);
  return (int)cudaErrorInvalidValue;
}

// The hd-256 design's building blocks on one tile (x3w::probe): q [64, 256],
// k and v [32, 256] fp32; s = q k^T [64, 32], o = s v [64, 256] and z = s^T q
// [32, 256]; `ws` holds eight planes of 64 x 256 floats.
extern "C" int repro_flash_tf32x3_hd256_probe(const void* q, const void* k, const void* v,
                                              void* s, void* o, void* z, void* ws, void* stream) {
  return (int)x3w::probe(q, k, v, s, o, z, ws, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a tf32x3 block at head dim hd, for build reports:
// kernel 0 the forward, 1 the dK/dV pass, 2 the dQ pass; -1 for another hd.
extern "C" int repro_flash_tf32x3_smem_bytes(int kernel, int hd) {
  if (hd == 256)
    return kernel == 0 ? x3w::fwd_smem() : kernel == 1 ? x3w::bwd_smem<true>() : x3w::bwd_smem<false>();
#define REPRO_X3_SMEM(HD) \
  if (hd == HD)           \
    return kernel == 0 ? x3::fwd_smem<HD>() : kernel == 1 ? x3::dkdv_smem<HD>() : x3::dq_smem<HD>();
  REPRO_TF32X3_HEAD_DIMS(REPRO_X3_SMEM)
#undef REPRO_X3_SMEM
  return -1;
}
