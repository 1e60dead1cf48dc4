// Fused SwiGLU on Hopper, forward and backward, for the training path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::swiglu (body
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
// operands, far above the H100's ~295 flop/byte ridge.  This first version
// runs on the CUDA cores with fp32 FMAs (fp32 inputs have to stay fp32 to
// hold 2e-5), so it is far from the tensor cores' rate; its design is the
// classic register-tiled product:
//   * TPU: the d axis is the sequential innermost grid axis with two fp32
//     VMEM accumulators.  Here one thread block owns a 64 x 128 tile of
//     (T, f) and loops over d in slices of 16 itself;
//   * each slice of x (transposed) and of both weights is staged in shared
//     memory in fp32; each of the 256 threads keeps a 4 x 8 tile of g and one
//     of u in registers (64 accumulators), reading x as one float4 and each
//     weight as two float4s per step of d;
//   * every edge (T, d, f) is masked, so any T is taken: the JAX rule
//     "oracle when T % 8" has no counterpart on the card.
// Tensor cores (wgmma), TMA and double buffering are later work.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libswiglu.so swiglu.cu
// The C entry points take raw pointers and PyTorch's current stream; they
// launch, do not synchronise and return the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

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

}  // namespace

// x [T, d], w_gate/w_up [d, f], out [T, f], all contiguous; dtype 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
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
