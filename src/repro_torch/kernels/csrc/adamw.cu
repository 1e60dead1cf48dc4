// AdamW over a stage worker's flat fp32 state, in place, one launch a step.
//
// Replaces no TPU kernel.  The JAX package's optimizer
// (src/repro/optim/optimizers.py::AdamW) is elementwise code that XLA fuses
// into one pass on the TPU; in eager PyTorch the same update
// (src/repro_torch/optim/optimizers.py::AdamW.update) is ~16 fp32 kernels a
// leaf, each reading and writing the whole leaf and allocating a new tensor,
// plus the cast to bf16 and the reduced gradient's division by the number of
// replicas.  This kernel is that update as one pass.
//
// What bounds it on the card: bytes.  A parameter needs its gradient,
// master, m and v read (16 B), master, m and v written (12 B) and its bf16
// copy written (2 B): 30 B for ~15 flops, far below the ~295 flop/byte ridge
// of an H100.  At 3.35 TB/s a phi3-mini stage of 325 M parameters takes at
// least 2.9 ms.  So the design is a single pass that moves those 30 B and
// nothing else:
//   * one launch for the worker's whole stage: the leaf table (gradient
//     offset in the unpadded scatter-reduce vector, state offset in the
//     padded flat buffers, count) lives in device memory, and persistent
//     blocks (as many as fit on the card at once) stride over each leaf in
//     turn, so a small leaf (a norm's weights) costs one short sweep and no
//     launch;
//   * 16-byte loads and stores of the fp32 state and 8-byte stores of the
//     bf16 parameters (the worker starts every leaf on a multiple of 8
//     elements); the gradient is read by 16 bytes where its leaf's offset
//     allows, else by 4 (the payload stays unpadded, in jax.tree.flatten
//     order); the leaf's last n % 4 elements one a thread;
//   * every load and store is streaming (ld/st.global.cs): no value is read
//     twice, and the 50 MB L2 cannot hold a stage.
//
// Same arithmetic, same bits: each element takes the plain path's
// operations in its order and rounding, as PyTorch's separate elementwise
// kernels compute them on the card, so master, m, v and the bf16 parameter
// equal AdamW.update followed by .to(bfloat16) bit for bit:
//   * the gradient times the float32 reciprocal of d (PyTorch's tensor / int
//     multiplies by the reciprocal of a CPU scalar);
//   * m / (1 - b1 ** t) as m times the float32 reciprocal of the float32
//     bias correction (a 0-dim CPU tensor: again a reciprocal), both
//     computed on the host (adamw.py);
//   * 1 - b1 taken in double on the host and rounded to float32, as a Python
//     scalar is; weight_decay * master added after the quotient, even at
//     weight decay 0;
//   * no FMA contraction: every operation is a round-to-nearest intrinsic
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn).
// No atomics and no reduction: replicas given the same inputs hold the same
// bits.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libadamw.so adamw.cu
// The C entry point takes raw pointers and PyTorch's current stream; it
// launches, does not synchronise, allocates nothing and returns the CUDA
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One row of the leaf table: an int64 [L, 3] tensor on the device.
struct Leaf {
  long long g_off;  // first element in the gradient
  long long s_off;  // first element in master, m, v and the parameters
  long long n;      // elements
};

// The step's constants, each a float32 as PyTorch's kernels see it.
struct Hyper {
  float inv_d;             // 1 / d
  float b1, one_minus_b1;  // b1, 1 - b1
  float b2, one_minus_b2;
  float inv_bc1, inv_bc2;  // 1 / (1 - b1 ** t), 1 / (1 - b2 ** t)
  float eps, weight_decay, lr;
};

// One element: AdamW.update's operations in its order.
__device__ __forceinline__ void adamw_one(float g, float& p, float& m, float& v, const Hyper& h) {
  g = __fmul_rn(g, h.inv_d);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float mhat = __fmul_rn(m, h.inv_bc1);
  const float vhat = __fmul_rn(v, h.inv_bc2);
  const float q = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  const float upd = __fadd_rn(q, __fmul_rn(h.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&two);
}

// kParam: whether to write a bf16 copy of the masters (fp32 parameters are
// the masters themselves).
template <bool kParam>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Leaf* __restrict__ table, int n_leaves, const float* __restrict__ grad,
                 float* __restrict__ master, float* __restrict__ m, float* __restrict__ v,
                 __nv_bfloat16* __restrict__ param, Hyper h) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int l = 0; l < n_leaves; ++l) {
    const Leaf leaf = table[l];
    const float* g = grad + leaf.g_off;
    float4* p4 = reinterpret_cast<float4*>(master + leaf.s_off);
    float4* m4 = reinterpret_cast<float4*>(m + leaf.s_off);
    float4* v4 = reinterpret_cast<float4*>(v + leaf.s_off);
    uint2* b4 = kParam ? reinterpret_cast<uint2*>(param + leaf.s_off) : nullptr;
    const bool g_vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    const long long nv = leaf.n >> 2;
    for (long long i = tid; i < nv; i += stride) {
      float4 gv;
      if (g_vec) {
        gv = __ldcs(reinterpret_cast<const float4*>(g) + i);
      } else {
        gv = make_float4(__ldcs(g + 4 * i), __ldcs(g + 4 * i + 1), __ldcs(g + 4 * i + 2),
                         __ldcs(g + 4 * i + 3));
      }
      float4 pv = __ldcs(p4 + i), mv = __ldcs(m4 + i), vv = __ldcs(v4 + i);
      adamw_one(gv.x, pv.x, mv.x, vv.x, h);
      adamw_one(gv.y, pv.y, mv.y, vv.y, h);
      adamw_one(gv.z, pv.z, mv.z, vv.z, h);
      adamw_one(gv.w, pv.w, mv.w, vv.w, h);
      __stcs(p4 + i, pv);
      __stcs(m4 + i, mv);
      __stcs(v4 + i, vv);
      if (kParam) __stcs(b4 + i, make_uint2(pack_bf16(pv.x, pv.y), pack_bf16(pv.z, pv.w)));
    }
    const long long j = (nv << 2) + tid;  // the leaf's last n % 4 elements
    if (j < leaf.n) {
      const long long s = leaf.s_off + j;
      float pj = master[s], mj = m[s], vj = v[s];
      adamw_one(g[j], pj, mj, vj, h);
      master[s] = pj;
      m[s] = mj;
      v[s] = vj;
      if (kParam) param[s] = __float2bfloat16_rn(pj);
    }
  }
}

// Persistent blocks: as many as are resident on the card at once (a few
// microseconds of queries a launch, beside milliseconds of work).
template <bool kParam>
cudaError_t launch(const Leaf* table, int n_leaves, const float* grad, float* master, float* m,
                   float* v, __nv_bfloat16* param, const Hyper& h, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel<kParam>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  adamw_kernel<kParam><<<sms * per_sm, kThreads, 0, stream>>>(table, n_leaves, grad, master, m, v,
                                                                param, h);
  return cudaGetLastError();
}

}  // namespace

// One step over a stage: `table` an int64 [n_leaves, 3] device array of
// (gradient offset, state offset, count); `grad` the reduced fp32 gradient;
// `master`, `m`, `v` the flat fp32 state, updated in place, each leaf's
// state offset a multiple of 4 and every pointer 16-byte aligned; `param`
// the flat bf16 parameters written beside the masters, or null where the
// parameters are the fp32 masters.
extern "C" int repro_adamw(const void* table, int n_leaves, const void* grad, void* master,
                           void* m, void* v, void* param, float inv_d, float b1,
                           float one_minus_b1, float b2, float one_minus_b2, float inv_bc1,
                           float inv_bc2, float eps, float weight_decay, float lr,
                           void* stream) {
  const Hyper h{inv_d, b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, weight_decay,
                lr};
  const Leaf* t = static_cast<const Leaf*>(table);
  const float* g = static_cast<const float*>(grad);
  float* pm = static_cast<float*>(master);
  float* mm = static_cast<float*>(m);
  float* vm = static_cast<float*>(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (param != nullptr)
    return (int)launch<true>(t, n_leaves, g, pm, mm, vm, static_cast<__nv_bfloat16*>(param), h, st);
  return (int)launch<false>(t, n_leaves, g, pm, mm, vm, nullptr, h, st);
}
