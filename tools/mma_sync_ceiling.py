#!/usr/bin/env python3
"""The tensor cores' rate through ``mma.sync`` on the card, operands in registers.

    python3 tools/mma_sync_ceiling.py

Independent accumulators per warp (4 or 8), no loads: the most a kernel built
on ``mma.sync.m16n8k8`` TF32 (the flash-attention tf32x3 route) or
``m16n8k16`` bf16 can get from the tensor cores, beside the published dense
peaks (495 TFLOP/s TF32, 989 bf16; ``wgmma`` only reaches those).  Builds
with ``nvcc`` into ``build/tools/`` and prints one JSON line with the card's
name and power limit.  Needs one CUDA card.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define OPERANDS                                                                   \
  "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                       \
  : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])                     \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])
template <int KIND, int NACC>
__global__ void mma_loop(float* out, int iters) {
  float d[NACC][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      if constexpr (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 " OPERANDS);
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 " OPERANDS);
    }
  }
  float s = 0.f;
  for (int n = 0; n < NACC; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int KIND>
void launch(int nacc, dim3 grid, dim3 block, float* out, int iters) {
  if (nacc == 4) mma_loop<KIND, 4><<<grid, block>>>(out, iters);
  else mma_loop<KIND, 8><<<grid, block>>>(out, iters);
}
// TFLOP/s of `kind` (0 TF32 m16n8k8, 1 bf16 m16n8k16), or -1 on a CUDA error
extern "C" float mma_tflops(int kind, int nacc, int warps, int blocks, int iters) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * warps * 32) != cudaSuccess) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  dim3 grid(blocks), block(32 * warps);
  auto run = [&] { kind == 0 ? launch<0>(nacc, grid, block, out, iters)
                             : launch<1>(nacc, grid, block, out, iters); };
  run();
  cudaEventRecord(e0);
  run();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const bool ok = cudaGetLastError() == cudaSuccess;
  cudaFree(out);
  const double flops = 2.0 * 16 * 8 * (kind == 0 ? 8 : 16) * double(nacc) * iters * warps * blocks;
  return ok ? float(flops / (ms * 1e-3) / 1e12) : -1.f;
}
"""


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    root = Path(__file__).resolve().parents[1] / "build" / "tools"
    root.mkdir(parents=True, exist_ok=True)
    src, lib_path = root / "mma_sync_ceiling.cu", root / "libmma_sync_ceiling.so"
    src.write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tflops.restype = ctypes.c_float
    lib.mma_tflops.argtypes = [ctypes.c_int] * 5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rates = {}
    for kind, name in ((0, "tf32_m16n8k8"), (1, "bf16_m16n8k16")):
        for nacc in (4, 8):
            for warps_per_sm in (4, 8, 16):
                rates[f"{name} acc{nacc} warps/SM {warps_per_sm}"] = lib.mma_tflops(
                    kind, nacc, 4, sms * warps_per_sm // 4, 20000)
    print(json.dumps({"card": card, "sms": sms, "tflop_per_s": rates}))


if __name__ == "__main__":
    main()
