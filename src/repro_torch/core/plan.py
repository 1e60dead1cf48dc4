"""Pipeline execution plan: how an arch maps onto the mesh
(``repro.core.plan`` in torch).

The ``model`` axis of the rank mesh factors into (pipeline stages x tensor
parallel), the ``data`` axis carries data parallelism, expert parallelism
and (long-context decode) sequence sharding, and the micro-batch count
trades bubble time for activation memory.  Every field equals the JAX
package's for the same arguments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig, InputShape


@dataclass(frozen=True)
class PipelinePlan:
    stages: int              # pipeline stages (S_eff)
    tensor: int              # TP within a stage; stages * tensor == model axis
    microbatches: int        # per data-shard micro-batches per step
    ep: int                  # expert-parallel factor over the data axis
    n_instances: int         # padded period instances (stages * ppstage)
    data: int                # data axis size
    pods: int                # pod axis size (1 = single pod)
    seq_shards: int = 1      # KV/sequence sharding over data (long decode)
    remat: str = "tick"      # none | tick | layer

    @property
    def ppstage(self) -> int:
        return self.n_instances // self.stages

    @property
    def model_axis(self) -> int:
        return self.stages * self.tensor

    @property
    def world(self) -> int:
        """Ranks of the mesh: pods x data x model."""
        return self.pods * self.data * self.model_axis


def make_plan(cfg: ArchConfig, shape: InputShape, *, data: int = 16, model: int = 16,
              pods: int = 1, stages: Optional[int] = None, tensor: Optional[int] = None,
              microbatches: Optional[int] = None, remat: str = "tick") -> PipelinePlan:
    stages = stages if stages is not None else cfg.stages
    tensor = tensor if tensor is not None else cfg.tensor
    if stages * tensor != model:
        raise ValueError(f"stages {stages} x tensor {tensor} != model axis {model}")
    n_inst = -(-cfg.n_periods // stages) * stages

    ep = 1
    if cfg.moe is not None:
        ep = math.gcd(cfg.moe.n_experts, data)

    seq_shards = 1
    B = shape.global_batch
    local_batch = max(1, B // pods)
    if shape.kind == "decode" and B < pods * data:
        # batch too small to shard: replicate it everywhere and shard the
        # long KV sequence over (pod x data) instead (flash-decode combine)
        seq_shards = pods * data
        local_batch = B
        ep = 1  # replicated tokens take the psum EP path

    if microbatches is None:
        if shape.kind == "train":
            microbatches = max(1, min(2 * stages, local_batch // data))
        else:
            microbatches = max(1, min(stages, local_batch // max(1, data)))
    return PipelinePlan(stages=stages, tensor=tensor, microbatches=microbatches, ep=ep,
                        n_instances=n_inst, data=data, pods=pods, seq_shards=seq_shards,
                        remat=remat)
