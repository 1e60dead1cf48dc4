// Fused SwiGLU on Hopper, forward and backward, for the training path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py:57 (swiglu, body
// _swiglu_kernel).  Same function: out = silu(x @ w_gate) * (x @ w_up) with
// x [T, d] and the weights [d, f] in fp32 or bf16, both products accumulated
// in fp32, the output cast to x's dtype.  The Pallas kernel's point is that
// g = x @ w_gate and u = x @ w_up never reach device memory: both products
// share the streamed x tile, and the silu * mul epilogue runs on the two
// accumulators.  The same holds here, and the backward keeps it: its kernel
// recomputes g and u tile by tile and its epilogue turns dout into
// dg = dout * u * silu'(g) and du = dout * silu(g), written in x's dtype.
// The products dx = dg w_gate^T + du w_up^T, dW_gate = x^T dg and
// dW_up = x^T du are plain matrix products and stay with torch.matmul.
//
// What bounds it on the card: operations.  At the training shape (T 2048,
// d 3072, f 8192) the kernel does 2 * 2 T d f = 206 GFLOP on 0.1 GB of
// operands, far above the H100's ~295 flop/byte ridge, so only the tensor
// cores come near its bounds: 0.208 ms in bf16 (989 TFLOP/s), 1.249 ms in
// fp32 as three TF32 products a flop (495 / 3 TFLOP/s; the CUDA cores' fp32
// peak of 67 TFLOP/s needs 3.07 ms).  Three designs, chosen per call by
// swiglu.py's route() before the launch:
//
// "wgmma" -- bf16 with d % 8 == 0, f % 8 == 0 and 16-byte aligned pointers
// (TMA's rules for global strides and base addresses):
//   * one block of 3 warpgroups owns a 128 (T) x 128 (f) tile of both g and
//     u and steps over d in 64-wide k-tiles; a ring of 4 stages of 48 KB
//     (x [128 x 64], w_gate and w_up [64 x 128], bf16, 128B-swizzled) in
//     dynamic shared memory;
//   * warpgroup 2 is the producer: one thread issues the TMA loads of a
//     stage against its "empty" mbarrier and arms its "full" mbarrier with
//     the stage's bytes (setmaxnreg 40);
//   * warpgroups 0 and 1 each own 64 rows and issue
//     wgmma.m64n128k16.f32.bf16.bf16 twice per k16 step, into the g and the
//     u accumulator (2 x 64 fp32 registers a thread, setmaxnreg 232); one
//     wgmma group stays in flight and the stage before it is released;
//   * x is the K-major A operand; the weights stay [d, f] row-major and are
//     the MN-major B operand (imm-trans-b = 1): each 64-column TMA box is one
//     128B swizzle atom wide, the descriptor's LBO steps between the two
//     boxes along f (8 KB) and its SBO between 8-row groups along d (1 KB);
//   * TMA fills out-of-bounds elements with zeros, which covers the ragged
//     edges of T, d (the last k-tile) and f; the epilogue runs on the
//     accumulators in registers and stores bf16 pairs straight to global
//     memory, masked at the edges (16 bytes of each 32-byte sector a store
//     instruction touches; a shared-memory + TMA store is later work); the
//     backward loads its dout pairs in the same layout before the mainloop,
//     so their latency hides behind it;
//   * no split-K and no atomics: the same inputs give the same bits.
// "tf32x3" -- fp32 with d % 4 == 0, f % 4 == 0 and 16-byte aligned pointers:
//   * why three products: fp32 has to hold 2e-5, and one TF32 product (10-bit
//     mantissas) misses it.  Each operand x is split into hi = tf32(x)
//     (cvt.rna) and lo = tf32(x - hi), and each product is a_lo b_hi +
//     a_hi b_lo + a_hi b_hi, in that fixed order (a_lo b_lo, ~2^-22 of the
//     product, is dropped);
//   * wgmma takes TF32 operands K-major only, and the weights are [d, f]
//     (MN-major as B).  So a split pass (two launches: x's planes, and the
//     weights' planes transposed through 32 x 32 shared-memory tiles) writes
//     x_hi, x_lo [T, d] and w_hi, w_lo [f, d] for both weights into a
//     workspace of 2 T d + 4 f d floats (453 MB at the training shape) that
//     the wrapper allocates per call;
//   * the main kernel has the wgmma route's shape: a block of 3 warpgroups
//     owns 128 (T) x 128 (f) of g and u and steps over d in 32-wide k-tiles
//     (128 bytes of fp32, one 128B swizzle row); one producer thread loads
//     the six 16 KB plane tiles of a stage by TMA into a ring of 2 stages of
//     96 KB (197,664 bytes with the barriers: 3 stages do not fit 227 KB);
//     two consumer warpgroups of 64 rows issue wgmma.m64n128k8.f32.tf32.tf32
//     three times a k8 step;
//   * the tensor cores' fp32 accumulation truncates toward zero: over d 3072
//     one accumulator takes 1,152 truncating adds, and a CPU emulation puts
//     it 60x further from the exact product than fresh accumulators
//     (tests/test_torch_kernels.py::test_swiglu_tf32x3_arithmetic_holds_
//     fp32_tolerances).  So each k-tile's 12 products go into a fresh
//     accumulator (scale-d 0 on the first), which is added to the running g
//     or u with IEEE adds: 64 + 64 running and 64 fresh registers a thread,
//     one fresh accumulator taken in turn for g and for u (setmaxnreg 232);
//     the other consumer warpgroup's wgmmas run while one adds;
//   * the epilogue is the wgmma route's on fp32 pairs; TMA's zero fill
//     covers ragged T, d and f; no split-K and no atomics.
// "simt" -- shapes and pointers the tensor-core routes cannot take: a
// register-tiled product of fp32 FMAs on the CUDA cores:
//   * TPU: the d axis is the sequential innermost grid axis with two fp32
//     VMEM accumulators.  Here one thread block owns a 64 x 128 tile of
//     (T, f) and loops over d in slices of 16 itself;
//   * each slice of x (transposed) and of both weights is staged in shared
//     memory in fp32; each of the 256 threads keeps a 4 x 8 tile of g and one
//     of u in registers (64 accumulators), reading x as one float4 and each
//     weight as two float4s per step of d;
//   * every edge (T, d, f) is masked, so any T is taken: the JAX rule
//     "oracle when T % 8" has no counterpart on the card.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libswiglu.so swiglu.cu
// The C entry points take raw pointers and PyTorch's current stream; they
// launch, do not synchronise and return the CUDA error.  The tensor-core
// entry points encode their TMA descriptors on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda is needed).  The
// Hopper primitives (mbarriers, TMA loads, the wgmma descriptor, the
// tensor-map encoder) live in hopper.cuh, shared with flash_attention.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------- simt route

constexpr int kThreads = 256;
constexpr int BM = 64;    // rows of x (T) per block
constexpr int BN = 128;   // columns of the weights (f) per block
constexpr int BKD = 16;   // slice of d per step
constexpr int TM = 4;     // rows per thread
constexpr int TN = 8;     // columns per thread: two float4s, 64 apart
constexpr int XLD = BM + 4;  // x slice row stride: 16-byte aligned, fewer conflicts

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

// kBwd false: out0 = silu(g) * u.  kBwd true: out0 = dg, out1 = du from dout.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
              const T* __restrict__ dout, T* __restrict__ out0, T* __restrict__ out1, int Tn,
              int d, int f) {
  __shared__ __align__(16) float xs[BKD][XLD];  // x slice, transposed: xs[k][m]
  __shared__ __align__(16) float gs[BKD][BN];   // w_gate slice
  __shared__ __align__(16) float us[BKD][BN];   // w_up slice

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*TM.., columns tx*4 + 64*{0,1} + 0..3

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += BKD) {
    __syncthreads();  // the previous slice is consumed
    for (int i = tid; i < BM * BKD; i += kThreads) {
      const int m = i / BKD, kk = i % BKD;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < Tn && gk < d) ? to_f32(x[(size_t)gm * d + gk]) : 0.f;
    }
    for (int i = tid; i < BKD * BN; i += kThreads) {
      const int kk = i / BN, n = i % BN;
      const int gk = k0 + kk, gn = n0 + n;
      const bool ok = gk < d && gn < f;
      gs[kk][n] = ok ? to_f32(wg[(size_t)gk * f + gn]) : 0.f;
      us[kk][n] = ok ? to_f32(wu[(size_t)gk * f + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKD; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      float bg[TN], bu[TN];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 g4 = *reinterpret_cast<const float4*>(&gs[kk][tx * 4 + 64 * h]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[kk][tx * 4 + 64 * h]);
        bg[4 * h + 0] = g4.x; bg[4 * h + 1] = g4.y; bg[4 * h + 2] = g4.z; bg[4 * h + 3] = g4.w;
        bu[4 * h + 0] = u4.x; bu[4 * h + 1] = u4.y; bu[4 * h + 2] = u4.z; bu[4 * h + 3] = u4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accg[i][j] = fmaf(av[i], bg[j], accg[i][j]);
          accu[i][j] = fmaf(av[i], bu[j], accu[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * 4 + 64 * (j / 4) + (j % 4);
      if (gn >= f) continue;
      const size_t at = (size_t)gm * f + gn;
      const float g = accg[i][j], u = accu[i][j];
      const float sig = 1.f / (1.f + expf(-g));
      if (kBwd) {
        const float dy = to_f32(dout[at]);
        out0[at] = from_f32<T>(dy * u * (sig * (1.f + g * (1.f - sig))));
        out1[at] = from_f32<T>(dy * (g * sig));
      } else {
        out0[at] = from_f32<T>(g * sig * u);
      }
    }
  }
}

template <typename T, bool kBwd>
cudaError_t launch(const void* x, const void* wg, const void* wu, const void* dout, void* out0,
                   void* out1, int Tn, int d, int f, cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (Tn + BM - 1) / BM);
  swiglu_kernel<T, kBwd><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(dout), static_cast<T*>(out0), static_cast<T*>(out1), Tn, d, f);
  return cudaGetLastError();
}


// The 64 fp32 accumulator registers of an m64n128 wgmma, as asm operands.
#define SWIGLU_ACC64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SWIGLU_ACC8(d, i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SWIGLU_ACC64_OPERANDS(d)                                                        \
  SWIGLU_ACC8(d, 0), SWIGLU_ACC8(d, 8), SWIGLU_ACC8(d, 16), SWIGLU_ACC8(d, 24),         \
      SWIGLU_ACC8(d, 32), SWIGLU_ACC8(d, 40), SWIGLU_ACC8(d, 48), SWIGLU_ACC8(d, 56)

// ------------------------------------------------------------ wgmma route
namespace tc {

using namespace hopper;

constexpr int BM = 128;        // rows of x (T) per block: two consumer warpgroups
constexpr int BN = 128;        // columns of the weights (f) per block
constexpr int BK = 64;         // k-tile of d: 128 bytes of bf16, one swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 rows; warpgroup 2 loads
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kXBytes = BM * BK * 2;            // 16 KB
constexpr int kBoxBytes = BK * 64 * 2;          // one 64-column box of a weight, 8 KB
constexpr int kWBytes = 2 * kBoxBytes;          // 16 KB
constexpr int kStageBytes = kXBytes + 2 * kWBytes;  // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, align

enum Epi { kFwd = 0, kBwd = 1, kProducts = 2 };

// d[64x128] += A[64x16] (K-major) * B[16x128] (MN-major), fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SWIGLU_ACC64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : SWIGLU_ACC64_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

// kFwd: out0 = silu(g) * u.  kBwd: out0 = dg, out1 = du from dout.
// kProducts: out0 = g, out1 = u (the probe of the mainloop alone).
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_wg,
                    const __grid_constant__ CUtensorMap map_wu,
                    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ out0,
                    __nv_bfloat16* __restrict__ out1, int Tn, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  auto x_tile = [&](int s) { return base + s * kStageBytes; };
  auto g_tile = [&](int s) { return base + s * kStageBytes + kXBytes; };
  auto u_tile = [&](int s) { return base + s * kStageBytes + kXBytes + kWBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (d + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), kStageBytes);
        const int k0 = kt * BK;
        tma_load(x_tile(s), &map_x, full(s), k0, m0);
        tma_load(g_tile(s), &map_wg, full(s), n0, k0);
        tma_load(g_tile(s) + kBoxBytes, &map_wg, full(s), n0 + 64, k0);
        tma_load(u_tile(s), &map_wu, full(s), n0, k0);
        tma_load(u_tile(s) + kBoxBytes, &map_wu, full(s), n0 + 64, k0);
      }
    }
  } else {
    // ---- consumers: rows wg*64 .. wg*64+63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float accg[64], accu[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) accg[i] = accu[i] = 0.f;

    // accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
    // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    // the backward's dout pairs, in the same layout, are loaded before the
    // mainloop so that their latency hides behind it (32 registers)
    __nv_bfloat162 dy[kEpi == kBwd ? 32 : 1];
    if (kEpi == kBwd) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = col0 + 8 * j;
          dy[2 * j + h] =
              row < Tn && col < f
                  ? __ldg(reinterpret_cast<const __nv_bfloat162*>(
                        dout + static_cast<size_t>(row) * f + col))
                  : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    }

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        // A: 64 rows of 128 bytes, 8-row groups 1 KB apart; k16 steps 32 bytes
        const uint64_t a = desc(x_tile(s) + wg * 64 * 128 + k * 32, 16, 1024);
        // B: 16 rows of d (2 KB) from each of the two 64-column boxes
        const uint64_t bg = desc(g_tile(s) + k * 2048, kBoxBytes, 1024);
        const uint64_t bu = desc(u_tile(s) + k * 2048, kBoxBytes, 1024);
        wgmma_m64n128k16(accg, a, bg);
        wgmma_m64n128k16(accu, a, bu);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      // the group of k-tile kt-1 is done: its stage goes back to the producer
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((kt - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(accg);
    fence_acc(accu);

#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= f) continue;  // f is even, so col + 1 < f as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Tn) continue;
        const size_t at = static_cast<size_t>(row) * f + col;
        const float g0 = accg[4 * j + 2 * h], g1 = accg[4 * j + 2 * h + 1];
        const float u0 = accu[4 * j + 2 * h], u1 = accu[4 * j + 2 * h + 1];
        if (kEpi == kProducts) {
          *reinterpret_cast<__nv_bfloat162*>(out0 + at) = __floats2bfloat162_rn(g0, g1);
          *reinterpret_cast<__nv_bfloat162*>(out1 + at) = __floats2bfloat162_rn(u0, u1);
          continue;
        }
        const float s0 = 1.f / (1.f + expf(-g0)), s1 = 1.f / (1.f + expf(-g1));
        if (kEpi == kBwd) {
          const float2 y = __bfloat1622float2(dy[kEpi == kBwd ? 2 * j + h : 0]);
          *reinterpret_cast<__nv_bfloat162*>(out0 + at) =
              __floats2bfloat162_rn(y.x * u0 * (s0 * (1.f + g0 * (1.f - s0))),
                                    y.y * u1 * (s1 * (1.f + g1 * (1.f - s1))));
          *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
              __floats2bfloat162_rn(y.x * (g0 * s0), y.y * (g1 * s1));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out0 + at) =
              __floats2bfloat162_rn(g0 * s0 * u0, g1 * s1 * u1);
        }
      }
    }
  }
}

template <int kEpi>
cudaError_t launch(const void* x, const void* wg, const void* wu, const void* dout, void* out0,
                   void* out1, int Tn, int d, int f, cudaStream_t stream) {
  CUtensorMap map_x, map_wg, map_wu;
  if (!encode(&map_x, x, Tn, d, BM) || !encode(&map_wg, wg, d, f, BK) ||
      !encode(&map_wu, wu, d, f, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_wgmma_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // T tiles vary fastest: the blocks in flight share a few weight tiles and
  // all of x, which stays in L2, so the weights are read from memory once
  dim3 grid((Tn + BM - 1) / BM, (f + BN - 1) / BN);
  swiglu_wgmma_kernel<kEpi><<<grid, kThreads, kSmemBytes, stream>>>(
      map_x, map_wg, map_wu, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1), Tn, d, f);
  return cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------- tf32x3 route
namespace x3 {

using namespace hopper;

constexpr int BM = 128;        // rows of x (T) per block: two consumer warpgroups
constexpr int BN = 128;        // columns of the weights (f) per block
constexpr int BK = 32;         // k-tile of d: 128 bytes of fp32, one swizzle row
constexpr int kStages = 2;
constexpr int kConsumers = 2;  // warpgroups of 64 rows; warpgroup 2 loads
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kPlaneBytes = 128 * BK * 4;     // one 128-row tile of a plane, 16 KB
constexpr int kStageBytes = 6 * kPlaneBytes;  // x, w_gate, w_up, hi and lo: 96 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, align
constexpr int kSplitThreads = 256;

enum Epi { kFwd = 0, kBwd = 1, kProducts = 2 };
// the planes of a stage, in shared memory and in the workspace
enum Plane { kXHi = 0, kXLo, kGHi, kGLo, kUHi, kULo };

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi), each an fp32
// pattern whose 13 low bits are clear (cvt.rna: to nearest, ties away).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  hi = __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - hi));
  lo = __uint_as_float(l);
}

// x [n4 float4s] -> its hi and lo planes, in the same layout.
__global__ void __launch_bounds__(kSplitThreads)
swiglu_split_rows_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                         float4* __restrict__ lo, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)kSplitThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kSplitThreads) {
    const float4 v = __ldg(x + i);
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// w_gate (blockIdx.z 0) or w_up (1), [d, f] -> hi and lo planes transposed,
// [f, d]: 32 x 32 tiles through shared memory, both sides coalesced.
__global__ void __launch_bounds__(kSplitThreads)
swiglu_split_transpose_kernel(const float* __restrict__ wg, const float* __restrict__ wu,
                              float* __restrict__ planes, int d, int f) {
  __shared__ float tile[32][33];
  const float* w = blockIdx.z ? wu : wg;
  float* hi = planes + (size_t)(2 * blockIdx.z) * f * d;
  float* lo = hi + (size_t)f * d;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 32; j += kSplitThreads / 32) {
    const int k = k0 + ty + j, n = n0 + tx;
    tile[ty + j][tx] = k < d && n < f ? __ldg(w + (size_t)k * f + n) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += kSplitThreads / 32) {
    const int n = n0 + ty + j, k = k0 + tx;
    if (n < f && k < d) {
      float h, l;
      split(tile[tx][ty + j], h, l);
      hi[(size_t)n * d + k] = h;
      lo[(size_t)n * d + k] = l;
    }
  }
}

// d[64x128] (+)= A[64x8] * B[8x128], TF32 from shared memory, both K-major,
// fp32 accumulators; scale_d 0 starts a fresh accumulator.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SWIGLU_ACC64
      ", %64, %65, p, 1, 1;\n}\n"
      : SWIGLU_ACC64_OPERANDS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// acc = A B over one k-tile, 64 rows of A (x) by 128 rows of B (a weight,
// transposed), in a fresh accumulator: per k8 step three TF32 products in a
// fixed order, lo hi, hi lo, hi hi (lo lo, ~2^-22 of the product, is
// dropped): 12 accumulating products, then the wait.  Each plane tile is
// rows of 128 bytes, 8-row groups 1 KB apart; a k8 step is 32 bytes.
__device__ __forceinline__ void tile_product(float (&acc)[64], uint32_t a_hi, uint32_t a_lo,
                                             uint32_t b_hi, uint32_t b_lo) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < BK / 8; ++k) {
    const uint64_t ah = desc(a_hi + k * 32, 16, 1024), al = desc(a_lo + k * 32, 16, 1024);
    const uint64_t bh = desc(b_hi + k * 32, 16, 1024), bl = desc(b_lo + k * 32, 16, 1024);
    wgmma_m64n128k8(acc, al, bh, k > 0);
    wgmma_m64n128k8(acc, ah, bl, 1);
    wgmma_m64n128k8(acc, ah, bh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// kFwd: out0 = silu(g) * u.  kBwd: out0 = dg, out1 = du from dout.
// kProducts: out0 = g, out1 = u (the probe of the mainloop alone).
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
swiglu_tf32x3_kernel(const __grid_constant__ CUtensorMap map_xh,
                     const __grid_constant__ CUtensorMap map_xl,
                     const __grid_constant__ CUtensorMap map_gh,
                     const __grid_constant__ CUtensorMap map_gl,
                     const __grid_constant__ CUtensorMap map_uh,
                     const __grid_constant__ CUtensorMap map_ul, const float* __restrict__ dout,
                     float* __restrict__ out0, float* __restrict__ out1, int Tn, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  auto tile = [&](int s, int plane) { return base + s * kStageBytes + plane * kPlaneBytes; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (d + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const CUtensorMap* maps[6] = {&map_xh, &map_xl, &map_gh, &map_gl, &map_uh, &map_ul};
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), kStageBytes);
#pragma unroll
        for (int p = 0; p < 6; ++p)
          tma_load(tile(s, p), maps[p], full(s), kt * BK, p < kGHi ? m0 : n0);
      }
    }
  } else {
    // ---- consumers: rows wg*64 .. wg*64+63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float accg[64], accu[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) accg[i] = accu[i] = 0.f;

    const uint32_t rows = wg * 64 * 128;  // this warpgroup's 64 rows of the x planes
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      // each k-tile's 12 truncating accumulations in a fresh accumulator,
      // added to the running sums with IEEE round-to-nearest adds
      tile_product(acc, tile(s, kXHi) + rows, tile(s, kXLo) + rows, tile(s, kGHi),
                   tile(s, kGLo));
#pragma unroll
      for (int i = 0; i < 64; ++i) accg[i] += acc[i];
      tile_product(acc, tile(s, kXHi) + rows, tile(s, kXLo) + rows, tile(s, kUHi),
                   tile(s, kULo));
#pragma unroll
      for (int i = 0; i < 64; ++i) accu[i] += acc[i];
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));  // the stage goes back
    }

    // accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
    // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= f) continue;  // f is even, so col + 1 < f as well
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Tn) continue;
        const size_t at = static_cast<size_t>(row) * f + col;
        const float g0 = accg[4 * j + 2 * h], g1 = accg[4 * j + 2 * h + 1];
        const float u0 = accu[4 * j + 2 * h], u1 = accu[4 * j + 2 * h + 1];
        if (kEpi == kProducts) {
          *reinterpret_cast<float2*>(out0 + at) = make_float2(g0, g1);
          *reinterpret_cast<float2*>(out1 + at) = make_float2(u0, u1);
          continue;
        }
        const float s0 = 1.f / (1.f + expf(-g0)), s1 = 1.f / (1.f + expf(-g1));
        if (kEpi == kBwd) {
          const float2 y = __ldg(reinterpret_cast<const float2*>(dout + at));
          *reinterpret_cast<float2*>(out0 + at) =
              make_float2(y.x * u0 * (s0 * (1.f + g0 * (1.f - s0))),
                          y.y * u1 * (s1 * (1.f + g1 * (1.f - s1))));
          *reinterpret_cast<float2*>(out1 + at) = make_float2(y.x * (g0 * s0), y.y * (g1 * s1));
        } else {
          *reinterpret_cast<float2*>(out0 + at) = make_float2(g0 * s0 * u0, g1 * s1 * u1);
        }
      }
    }
  }
}

// The planes in the workspace: x's hi and lo [T, d], then w_gate's and
// w_up's hi and lo, each [f, d] (transposed).
inline float* plane(void* ws, int which, int Tn, int d, int f) {
  float* p = static_cast<float*>(ws);
  const size_t x_floats = static_cast<size_t>(Tn) * d, w_floats = static_cast<size_t>(f) * d;
  return which < kGHi ? p + which * x_floats : p + 2 * x_floats + (which - kGHi) * w_floats;
}

// The split pass: two launches, x's planes and the weights' transposed ones.
cudaError_t split_all(const void* x, const void* wg, const void* wu, void* ws, int Tn, int d,
                      int f, cudaStream_t stream) {
  const size_t n4 = static_cast<size_t>(Tn) * d / 4;
  const size_t want = (n4 + kSplitThreads - 1) / kSplitThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  swiglu_split_rows_kernel<<<blocks, kSplitThreads, 0, stream>>>(
      static_cast<const float4*>(x), reinterpret_cast<float4*>(plane(ws, kXHi, Tn, d, f)),
      reinterpret_cast<float4*>(plane(ws, kXLo, Tn, d, f)), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((f + 31) / 32, (d + 31) / 32, 2);
  swiglu_split_transpose_kernel<<<grid, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(wg), static_cast<const float*>(wu),
      plane(ws, kGHi, Tn, d, f), d, f);
  return cudaGetLastError();
}

template <int kEpi>
cudaError_t launch(const void* x, const void* wg, const void* wu, const void* dout, void* out0,
                   void* out1, void* ws, int Tn, int d, int f, cudaStream_t stream) {
  cudaError_t err = split_all(x, wg, wu, ws, Tn, d, f, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[6];
  for (int p = 0; p < 6; ++p) {
    const bool is_x = p < kGHi;
    if (!encode(&maps[p], plane(ws, p, Tn, d, f), is_x ? Tn : f, d, is_x ? BM : BN, true))
      return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(swiglu_tf32x3_kernel<kEpi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // T tiles vary fastest, as on the wgmma route
  dim3 grid((Tn + BM - 1) / BM, (f + BN - 1) / BN);
  swiglu_tf32x3_kernel<kEpi><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<const float*>(dout),
      static_cast<float*>(out0), static_cast<float*>(out1), Tn, d, f);
  return cudaGetLastError();
}

}  // namespace x3

}  // namespace

// The simt route.  x [T, d], w_gate/w_up [d, f], out [T, f], all contiguous;
// dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_swiglu_fwd(const void* x, const void* wg, const void* wu, void* out, int T,
                                int d, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, false>(x, wg, wu, nullptr, out, nullptr, T, d, f, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(x, wg, wu, nullptr, out, nullptr, T, d, f, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's fused part: dout [T, f] in, dg and du [T, f] out.
extern "C" int repro_swiglu_bwd(const void* x, const void* wg, const void* wu, const void* dout,
                                void* dg, void* du, int T, int d, int f, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, true>(x, wg, wu, dout, dg, du, T, d, f, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, true>(x, wg, wu, dout, dg, du, T, d, f, st);
  return (int)cudaErrorInvalidValue;
}

// The wgmma route: bf16, d and f multiples of 8, every pointer 16-byte
// aligned (swiglu.py's route() decides).  Same arguments as above, no dtype.
extern "C" int repro_swiglu_wgmma_fwd(const void* x, const void* wg, const void* wu, void* out,
                                      int T, int d, int f, void* stream) {
  return (int)tc::launch<tc::kFwd>(x, wg, wu, nullptr, out, nullptr, T, d, f,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int repro_swiglu_wgmma_bwd(const void* x, const void* wg, const void* wu,
                                      const void* dout, void* dg, void* du, int T, int d, int f,
                                      void* stream) {
  return (int)tc::launch<tc::kBwd>(x, wg, wu, dout, dg, du, T, d, f,
                                   static_cast<cudaStream_t>(stream));
}

// The mainloop alone: g = x @ w_gate and u = x @ w_up in bf16, for checking
// the tensor-core products against a matrix product.
extern "C" int repro_swiglu_wgmma_products(const void* x, const void* wg, const void* wu, void* g,
                                           void* u, int T, int d, int f, void* stream) {
  return (int)tc::launch<tc::kProducts>(x, wg, wu, nullptr, g, u, T, d, f,
                                        static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a wgmma block, for build reports.
extern "C" int repro_swiglu_wgmma_smem_bytes() { return tc::kSmemBytes; }

// The tf32x3 route: fp32, d and f multiples of 4, every pointer 16-byte
// aligned (swiglu.py's route() decides).  `ws` is the split pass's
// workspace, 2 T d + 4 f d floats (swiglu.py allocates it per call).
extern "C" int repro_swiglu_tf32x3_fwd(const void* x, const void* wg, const void* wu, void* out,
                                       void* ws, int T, int d, int f, void* stream) {
  return (int)x3::launch<x3::kFwd>(x, wg, wu, nullptr, out, nullptr, ws, T, d, f,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int repro_swiglu_tf32x3_bwd(const void* x, const void* wg, const void* wu,
                                       const void* dout, void* dg, void* du, void* ws, int T,
                                       int d, int f, void* stream) {
  return (int)x3::launch<x3::kBwd>(x, wg, wu, dout, dg, du, ws, T, d, f,
                                   static_cast<cudaStream_t>(stream));
}

// The mainloop alone: g = x @ w_gate and u = x @ w_up in fp32, for checking
// the tensor-core products against a matrix product.
extern "C" int repro_swiglu_tf32x3_products(const void* x, const void* wg, const void* wu,
                                            void* g, void* u, void* ws, int T, int d, int f,
                                            void* stream) {
  return (int)x3::launch<x3::kProducts>(x, wg, wu, nullptr, g, u, ws, T, d, f,
                                        static_cast<cudaStream_t>(stream));
}

// The split pass alone (its time apart from the route's).
extern "C" int repro_swiglu_tf32x3_split(const void* x, const void* wg, const void* wu, void* ws,
                                         int T, int d, int f, void* stream) {
  return (int)x3::split_all(x, wg, wu, ws, T, d, f, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a tf32x3 block, for build reports.
extern "C" int repro_swiglu_tf32x3_smem_bytes() { return x3::kSmemBytes; }
