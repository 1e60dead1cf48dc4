"""Serverless platform models (§5.1 testbeds); a copy of
``repro.serverless.platform``, so plan fingerprints and costs agree.

Memory options, memory->bandwidth and memory->CPU scaling, pricing and
storage characteristics for the two platforms the paper evaluates.  Numbers
follow the paper's measurements: ~70 MB/s per AWS Lambda function, <40 ms S3
latency, 1 vCPU per 1769 MB, price proportional to GB-s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

MB = 1024**2
GB = 1024**3


@dataclass(frozen=True)
class Platform:
    name: str
    memory_options: Tuple[int, ...]          # bytes
    price_per_gb_s: float                    # $ / (GB * s)
    storage_latency: float                   # t_lat, seconds
    base_memory: int                         # s0 — runtime/framework footprint
    max_function_bandwidth: float            # bytes/s at full allocation
    full_bw_memory: int                      # memory at/above which bw saturates
    cpu_per_memory: float                    # vCPUs per byte of memory
    max_vcpus: float
    flops_per_vcpu: float                    # effective f32 FLOP/s per vCPU
    storage_total_bandwidth: Optional[float] = None  # cloud-storage side cap
    contention_beta: float = 1.15            # paper's beta (comm/compute overlap)
    max_lifetime: float = 15 * 60.0          # function timeout, seconds

    def bandwidth(self, mem: int) -> float:
        frac = min(1.0, mem / self.full_bw_memory)
        return self.max_function_bandwidth * frac

    def vcpus(self, mem: int) -> float:
        return min(self.max_vcpus, mem * self.cpu_per_memory)

    def compute_time(self, flops: float, mem: int) -> float:
        return flops / (self.flops_per_vcpu * self.vcpus(mem))

    def cost(self, mem: int, runtime: float, n_workers: int = 1) -> float:
        return self.price_per_gb_s * (mem / GB) * runtime * n_workers


AWS_LAMBDA = Platform(
    name="aws_lambda",
    memory_options=(512 * MB, 1024 * MB, 2048 * MB, 3072 * MB, 4096 * MB,
                    6144 * MB, 8192 * MB, 10240 * MB),
    price_per_gb_s=0.0000166667,
    storage_latency=0.040,
    base_memory=300 * MB,
    max_function_bandwidth=70 * MB,
    full_bw_memory=1769 * MB,
    cpu_per_memory=1.0 / (1769 * MB),
    max_vcpus=6.0,
    flops_per_vcpu=40e9,
    storage_total_bandwidth=None,  # S3: effectively unlimited concurrent bw
)

ALIBABA_FC = Platform(
    name="alibaba_fc",
    memory_options=(1 * GB, 2 * GB, 4 * GB, 8 * GB, 16 * GB, 32 * GB),
    price_per_gb_s=0.000016384,
    storage_latency=0.035,
    base_memory=300 * MB,
    max_function_bandwidth=80 * MB,
    full_bw_memory=2 * GB,
    cpu_per_memory=1.0 / (2 * GB),
    max_vcpus=16.0,
    flops_per_vcpu=40e9,
    storage_total_bandwidth=10e9 / 8,  # OSS: 10 Gb/s total (§5.7)
)


# name -> Platform, including the short aliases the CLI accepts; serialized
# DeploymentPlans record `Platform.name` so loading resolves through here
PLATFORMS = {
    "aws_lambda": AWS_LAMBDA,
    "aws": AWS_LAMBDA,
    "alibaba_fc": ALIBABA_FC,
    "alibaba": ALIBABA_FC,
}


def get_platform(name: str) -> Platform:
    """Resolve a platform by name or alias (case-insensitive)."""
    try:
        return PLATFORMS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown platform {name!r}; known: {sorted(set(PLATFORMS))}"
        ) from None
