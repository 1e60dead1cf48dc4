#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (``script_s``: the seconds since the
script started); any failure is an uncaught exception
and a non-zero exit:

1. device -- CUDA must be present; the card's name and power limit.
2. build -- compile the three kernel sources from ``src/`` with nvcc, one
   process each, all at once; every kernel's registers and spills, each
   swiglu and flash-attention kernel's registers, shared memory and spills
   (the tf32x3 kernels' apart, and the wgmma route's hd-256 kernels', which
   must not spill), and the tensor-core blocks' dynamic shared memory.
3. kernel parity -- first the tensor-core routes' one-tile probes (flash
   attention's wgmma probe at hd 128 and at hd 256 with 32 and 64 keys, its
   tf32x3 probes at hd 96 and 128 and at hd 256 (the split pass, S = Q K^T,
   O = S V with S as a register operand, S^T Q with S written as a shared-
   memory operand), and swiglu's) against fp32 and float64 matrix products;
   then
   each CUDA kernel against its plain PyTorch version: decode attention on
   the sweep of ``tests/test_kernels.py::test_decode_attention``, phi3-mini-
   3.8b's decode shape and the split-K pass's chunk edges, two calls held
   bit-equal and each sequence alone held bit-equal to its batch; flash
   attention (forward, and the backward's dq/dk/dv) on every case of
   ``tests/test_kernels.py:18-58``, ragged S, qwen2.5-14b's GQA shape (bf16),
   the training shape [2,1024,32,96] and, in bf16, gemma3-4b's hd-256
   shapes (train_gemma's global and window-1024 layers at S 2048, [2,1024],
   ragged S 200, MQA, window 48 over S 200, no mask), the same in fp32
   (their inputs from a generator of their own), each case's route asserted
   through the launch counters (bf16 on wgmma, fp32 on tf32x3) and two
   backward calls held bit-equal;
   swiglu (forward, dg/du, and dx/dW_gate/dW_up) on the cases of
   ``:74-84``, the edges of its tensor-core routes (T 1 and 100, d 200, f
   520), odd shapes that take the simt route, a 256-row slice of phi3's FFN
   and the training shape T 2048, d 3072, f 8192, each case's route asserted
   through the launch counters (bf16 on wgmma, fp32 on tf32x3) and two
   backward calls held bit-equal; in fp32 at d 3072 (the slice and the
   training shape) the kernels are held against a float64 oracle, the plain
   version's bar is reported beside it with the plain version's own
   distance from the oracle (its fp32 sums down d are the less exact), and
   at T 2048 each output and gradient must be no further from float64 than
   the plain path's, by max |err| and by elements past the bar.  Outputs at
   2e-5 (fp32) and 2e-2 (bf16), gradients at 1e-4 (fp32) and 2e-2 x
   max|ref| (bf16).  Each
   kernel's median time at its main-path shape (CUDA events, L2 flushed, a
   sleep kernel covering the host's enqueue) beside its bound, the plain
   version and a PyTorch yardstick (``scaled_dot_product_attention``,
   pinned to one backend, the flash backend in bf16; for swiglu the
   compositions ``silu(x@wg) * (x@wu)`` and its backward's ``dg``/``du``);
   flash attention also in fp32 (tf32x3, with the simt kernels on the same
   inputs) and at hd 256: bf16 on wgmma and fp32 on tf32x3 at train_gemma's
   two shapes and at [2,1024,8,4,256], the simt kernels on the same inputs,
   fp32 beside SDPA's memory-efficient backend where no window is set, with
   the passes' device ms (the split pass apart); swiglu also in fp32 (tf32x3, its
   split pass apart, with the simt kernels on the same inputs); decode
   attention with its kernels per call on a line of its own.  Then the
   MoE and Mamba families' shapes (``_families_parity``): flash attention
   forward and backward at qwen3-moe-235b-a22b's [1,2048,64 q,4 kv,128]
   (bf16, G 16, wgmma) and decode attention at jamba-v0.1-52b's [4,32 q,8
   kv,128] over 1040 slots (a short last chunk), each against its plain
   version and timed beside its bound, its plain version and SDPA.
3b. AdamW (``adamw``) -- a phi3-mini-3.8b stage at full width (the embedding
   and 2 layers of ``train_full``'s model, 325 M parameters, bf16 params,
   fp32 masters and moments) as two ``StageWorker``s of a stage of 2
   replicas: one on the AdamW kernel (``use_kernels=True``), one on the
   plain path; 3 steps from the same gradients, master, m, v and the bf16
   params bit-equal after each, one launch a step; then each path's median
   time a step (CUDA events, L2 flushed, a sleep kernel covering the
   enqueue) beside the kernel's bound (30 B a parameter over 3.35 TB/s).
4. full-width serve -- phi3-mini-3.8b, all 32 layers, bf16, random weights
   from seed 0, a hand-built 4-stage serve plan run through
   ``run_serve_plan(..., use_kernels=True)``: kernel launches counted, tokens
   bit-identical to the monolithic loop, store drained.  Then, teacher-forced
   with those tokens, every decode-attention call of the loop is held
   against the plain version (``impl="ref"``) on its real inputs (bf16,
   2e-2); the same full-width model cast to fp32 holds each step's logits
   within 2e-4 of the plain version's.  In bf16 the step logits are only
   reported, beside the drift a float64 attention causes: 32 bf16 layers
   amplify any change of rounding past 2e-2.
5. reduced fp32 serve -- phi3-mini-3.8b@reduced through the same entry point
   with and without the kernel: identical tokens.
6. full-width training -- phi3-mini-3.8b at full width cut to 4 layers,
   bf16, seed 0: 2 stages x 2 replicas, 2 micro-batches of 2 x 1024 tokens,
   AdamW, 2 steps through ``run_plan(..., execution=Execution(...,
   use_kernels=True))``.  Exact launch counts per step, every flash and
   swiglu launch on the wgmma route; in step 1 every kernel call held
   against ``impl="ref"`` on its real inputs, outputs and gradients; finite losses; replicas bit-identical after each step; store
   drained; virtual clock, cost and ``StoreStats`` equal to a timing-only
   run; the first loss within 2e-2 of the plain path's (``use_kernels=
   False``).  Step wall time, peak memory and one profiled step.
7. full-width fp32 training -- the same model in fp32, d = 1, SGD, 1 step,
   kernels on and off: losses within 5e-5, every param within 1e-4; flash
   attention and swiglu on the tf32x3 route.  One profiled step.
8. reduced training -- phi3-mini-3.8b@reduced (4 layers, fp32) on the plan of
   ``tests/test_runtime.py:230-240``, kernels on and off: losses within
   2e-4, params within 2e-3; flash attention on tf32x3 (hd 64, S 16: a
   tile's ragged edge), swiglu on tf32x3.
9. gemma3-4b training (``train_gemma``) -- full width cut to 12 layers (two
   periods of five window-1024 layers and one global layer, heads of 256,
   q/k norms), bf16, seed 0: 2 stages of one period, d 1, 2 micro-batches
   of 1 x 2048 tokens, AdamW, 2 steps through ``run_plan(...,
   use_kernels=True)``.  24 + 24 flash attention launches a step, all on
   the wgmma route at hd 256, swiglu's on wgmma; in step 1 every flash
   attention and swiglu call held against ``impl="ref"``; finite losses,
   the first within 2e-2 of the plain path's; peak memory; one profiled
   step.
10. gemma3-4b training in fp32 (``train_gemma_fp32``) -- full width cut to
   one period (five window-1024 layers and one global layer), fp32, seed 0:
   one stage, d 1, 2 micro-batches of 1 x 2048 tokens, SGD, 1 step through
   ``run_plan(..., use_kernels=True)`` and the same plan with
   ``use_kernels=False``.  12 + 12 flash attention launches, all on the
   tf32x3 route at hd 256 (10 window, 2 global), swiglu's on tf32x3; every
   flash attention call held against ``impl="ref"`` at 2e-5 (output) and
   1e-4 (gradients); the kernel path within 5e-5 (loss) and 1e-4 (params)
   of the plain path; finite losses; peak memory; one profiled step.
11. process serving (``serve_process``, run right after ``serve_full``) --
   ``serve_full``'s request through ``run_serve_plan(...,
   backend="process", use_kernels=True)``: each of the 4 stages a spawned
   worker process with its own CUDA context, each stage's KV cache through
   a file every round (payload-true bytes), traced (``trace=True``).
   Tokens bit-identical to ``serve_full``'s emulated run (which equal the
   monolithic loop's), the children's (16 - 1) x 32 decode-attention
   launches, store drained; the trace validates, has exactly the phases
   prefill and decode and reconciles its span bytes with ``StoreStats``;
   request wall time, each child's peak memory and each stage's compute,
   upload and download seconds in prefill and in decode.
12. training on the wall-clock backends (``train_backends``, after
   ``train_full``) -- ``train_full``'s plan on the emulated backend, on
   ``local`` (a thread per worker) with eq (2) and eq (1) and on
   ``process`` (a spawned process per worker over a file store) with eq
   (2), each untraced and then traced (``trace=True``): losses equal and
   every param bit-identical to the untraced emulated run's, each step's
   launches exactly ``train_full``'s (summed from the children on
   ``process``), store drained, puts, gets and modeled bytes equal to the
   emulated run's; every trace validates, covers the 2 x 2 workers and
   reconciles its span bytes with ``StoreStats`` (1e-6 relative), and on
   ``emulated`` each step's last span ends at its ``step_ends``.  Step
   wall times traced and untraced (on ``local`` and ``process`` a traced
   compute span waits for the device work it launched), per stage the
   compute, bubble, upload and download fractions, per worker and step the
   busy seconds of each phase/op, the straggler ratio, and each child's
   peak memory.  Each process run's file store root (a tmpfs with room if
   the run's temporary directory is one, else a disk directory) is printed
   with its free space first.

13. fault recovery (``train_chaos``, after ``train_planned``) --
   ``train_full``'s plan for 3 steps through ``tests/test_faults.py``'s
   chaos schedule (a transient put, a transient get, a crash in a
   backward, a 2-step function lifetime) with its recovery policy (retry
   from a 10 ms base, a checkpoint into the object store after every
   step, restarts from the newest): on ``emulated`` and ``local`` at full
   width, and on ``process`` at one layer a stage, where the crash SIGKILLs
   a child.  Each recovered run's params bit-identical to the fault-free
   run's (the same backend's; the emulated run's on ``process``), losses
   equal, at least one retry, restart, planned restart and checkpoint, all
   launches on wgmma; reports, checkpoint bytes, step and run wall times,
   peak memory and the device's free memory before and after.
14. calibration (``calibrate_replan``) -- ``train_full``'s plan traced for
   3 steps on ``process`` with payload-true bytes; ``calibrate_profile``
   folds the trace into a measured profile (scales, warnings, the max
   per-stage error before and after), ``replan`` re-solves on it (paper
   weights, d in (1, 2), M 4), and the re-planned plan trains 2 steps on
   ``emulated`` with the kernels, its first loss within 2e-2 of its
   plain-version run; old and new plans, step times beside train_full's.

15. MoE and Mamba serving (``serve_jamba``) -- jamba-v0.1-52b at full width
   cut to one period (``@layers8``: 7 Mamba layers and one attention
   layer, 4 MoE FFNs of 16 experts top-2 and 4 dense FFNs; 13.3 B params),
   bf16, seed 0, through ``run_serve_plan(..., use_kernels=True)`` on 2
   stages [embed + period | head], batch 4, 1024 + 16 tokens: 15 decode-
   attention launches, tokens bit-identical to the monolithic loop, every
   decode-attention call within 2e-2 of ``impl="ref"``, the Mamba and KV
   bytes a round equal to what crossed the store; round times, peak memory,
   and a profiled prefill and decode with the MoE steps (routing, slots,
   dispatch, expert products, combine) and Mamba's scan apart.
16. ``serve_jamba_reduced`` -- ``tests/test_models_unit.py:23-48`` on the
   card: jamba@reduced in fp32 with capacity ``n_experts``, prefill then 4
   decode steps (decode attention on the kernel) against the full
   forward's logits at 1e-4 / 2e-4.
17. MoE training (``train_moe``) -- qwen3-moe-235b-a22b at full width, one
   layer (3.73 B params), bf16, seed 0: 2 stages [embed + layer | head],
   d 1, 2 micro-batches of 1 x 2048 tokens, eq (2), SGD, 2 steps: 2 + 2
   flash launches a step on the wgmma route (hd 128, G 16), each held
   against ``impl="ref"`` in step 1; finite ce and aux, the first loss
   within 2e-2 of the kernels' plain versions; peak memory; a profiled step
   with the MoE's steps and backward nodes apart.
18. ``train_jamba_reduced`` -- jamba@reduced, fp32, one stage, SGD, 1 step,
   kernels on and off: Mamba's backward, 2 flash and 8 swiglu launches on
   tf32x3; losses within 5e-5, params within 1e-4.
19. encoder training (``train_bert``) -- bert-large at full width, cut to
   12 layers since PR 25 (24 before), bf16, seed 0: 2 stages of 6 layers x 2
   replicas, 2 micro-batches of 4 x 512 tokens, AdamW, 2 steps through
   ``run_plan(..., use_kernels=True)``: the encoder's loss (no shift) and
   attention with no mask; 48 + 48 flash and 48 + 48 swiglu launches a
   step, all wgmma and none causal, every call of step 1 held against
   ``impl="ref"``; the first loss within 2e-2 of the kernels' plain
   versions'; replicas bit-identical; step times and peak memory.
20. audio (``train_hubert``) -- hubert-xlarge at full width, cut to 24
   layers since PR 25 (48 before), bf16: ``registry.loss_fn(use_kernels=True)`` on
   a frames batch of 2 x 1024 and its backward (the stage workers refuse
   frontends in both packages): 24 + 24 flash launches at hd 80 with no
   mask and 24 + 24 swiglu, each call held; the loss within 2e-2 of the
   kernels' plain versions'; no gradient for the unused embedding; one SGD
   step lowers the loss.
21. xLSTM training (``train_xlstm``) -- xlstm-125m at full width, cut to 4
   layers since PR 25 (12 before), bf16: 2 stages of one period x 2 replicas, 2
   micro-batches of 4 x 512 tokens (two mLSTM chunks), AdamW, 1 step: no
   kernel launch (the scans are plain PyTorch), the first loss near
   ln(50304), replicas bit-identical, the device's idle share in the step;
   then at full width in fp32 the mLSTM's and sLSTM's parallel forms
   against their decodes stepped over 512 tokens (3e-4 x max|ref|).
22. xLSTM serving (``serve_xlstm``) -- xlstm-125m, 12 layers, bf16, 2
   stages, batch 4, 512 + 16 tokens through ``run_serve_plan``: tokens
   bit-identical to the monolithic loop, 57,250,176 cache bytes (mLSTM and
   sLSTM states) through the store a round, round times, a profiled round.
23. vision (``serve_internvl2``) -- internvl2-26b at full width cut to 8
   layers (4.26 B params), bf16: the monolithic prefill of 1024 tokens whose
   first 256 positions are patch embeddings, then 15 decode rounds on the
   kernel: 120 decode launches at G 6, each held within 2e-2 of
   ``impl="ref"``; prefill and round times, peak memory.

24. mesh training (``train_mesh``) -- ``train_full``'s model (phi3-mini-3.8b,
   full width, 4 layers, bf16) and batches on the rank mesh: four spawned
   ranks share the card, each with its own CUDA context, every collective
   through gloo over a host copy.  (a) data 2 x model 2 (2 stages, tp 1, mu
   2), AdamW(1e-4), 2 steps on the bidirectional ring, then step 2 again
   from the state after step 1 on the unidirectional ring; (b) data 1 x
   model 4 (2 stages x tp 2, mu 4), the same 2 steps, then one SGD(1.0)
   step from the initial state.  Holds: (a)'s first loss within 2e-2 of
   ``train_full``'s and of the single-process plain loss, (b)'s within 2e-2
   of (a)'s, the data replicas bit-identical after every step, the two
   rings' step-2 parameters within 2e-2 x max|ref| of each other, (b)'s
   SGD step within 2e-2 x max|ref| of the single-process step with the
   plain versions on every leaf, exact launches (the forward's twice a
   micro-batch under remat "tick") all on wgmma.  Step wall times, each
   step's collectives by category (seconds, calls, bytes), peak memory and
   launches by rank.
25. mesh serving (``serve_mesh``) -- ``serve_full``'s request (32 layers,
   batch 4, 1008 + 16) on four ranks: 4 stages x tp 1 with one
   micro-batch, tokens equal to ``serve_full``'s; 2 stages x tp 2 fed the
   same tokens, its tokens and largest logit drift reported; decode
   attention launches (8 / 16 layers a rank x 15 rounds), prefill and round
   times, peak memory and collectives by rank.
26. the planner's own plan (``plan_auto``), in the same world of four
   ranks -- ``core.tpu_planner.solve`` for ``train_mesh``'s model and batch
   on data 2 x model 2 with the H100's constants (``launch.roofline.h100``:
   80e9 / 4 bytes a rank, the host-staged gloo rate as the link): its top
   five plans (``t_step_est``, ``hbm_est``, objective) and how many were
   feasible; its first plan trained 2 steps with AdamW(1e-4).  Holds: the
   first loss within 2e-2 of ``train_full``'s, the replicas bit-identical,
   exact launches all on wgmma, and, where the plan is neither of
   ``train_mesh``'s, one SGD(1.0) step within 2e-2 x max|ref| of the
   single-process step.  Reported side by side: the analytic step time and
   the measured second step, the analytic collective bytes by kind and each
   rank's issued ones (``launch.roofline.issued_roofline`` of its
   ``cc.stats()``), the planner's memory estimate, the dry run's argument
   bytes (``launch.dryrun.argument_bytes``) and each rank's peak.

``kernel_parity`` also holds and times (``_encoders_parity``) flash
attention with no mask at bert-large's [4,512,16,16,64] and
hubert-xlarge's [2,1024,16,16,80], swiglu at their FFNs' shapes, decode
attention at internvl2-26b's [4,48,8,128] over 1040 slots and, in bf16 and
fp32, at gemma3-4b's global layers' [4,8,4,256]; and (``_simt_dq_correction``)
the simt flash backward's key-mean dQ correction on misaligned bf16 tensors
at bert-large's shape with keys that share a common component: dq, dk and
dv within 2e-2 x max|ref| of the fp32 plain version, the uncorrected
product's errors beside them.

The traced runs' Chrome traces (``Trace.save``; Perfetto loads them, and
``Trace.load`` in either package) are written to ``chiprun_out/traces/``.

The last lines are the kernels' record (twenty-five rows: decode attention,
the bf16 main paths' training kernels on the wgmma route, hd 256's from
train_gemma, the fp32 rows on the tf32x3 route, fp32 hd 256's from
train_gemma_fp32, and the families' shapes: ``decode_attention_jamba``
from serve_jamba, ``flash_attention_qwen3_moe`` and its backward from
train_moe; ``launches`` includes the backend phases' launches, also
given apart as ``launches_backend_phases``, those of ``train_planned``,
``train_chaos`` and ``calibrate_replan`` apart too, and the reduced
families' runs' as ``launches_reduced_families``; and the encoders' and
the vision model's shapes: ``flash_attention_bert``, ``swiglu_bert`` and
their backwards from train_bert, the same ``_hubert`` rows from
train_hubert, ``decode_attention_internvl2`` from serve_internvl2; every
row's ``launches_mesh`` the mesh phases' launches summed over the ranks
and ``launches_plan_auto`` plan_auto's, both included in ``launches``), the
``nvidia-smi`` name/power line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# train_gemma holds ~60 GB; segments that grow keep the allocator's free
# blocks usable across the phases' differing sizes
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api.plan import DeploymentPlan, profile_fingerprint  # noqa: E402
from repro_torch.api.session import DEFAULT_ALPHA  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN, DENSE_FF, InputShape  # noqa: E402
from repro_torch.core import collectives as mesh_cc  # noqa: E402
from repro_torch.core import planner, sharding, tpu_planner  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.core.perfmodel import Config  # noqa: E402
from repro_torch.core.profiler import arch_model_profile, resolve_profile  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels import decode_attention as da_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kernel_ref  # noqa: E402
from repro_torch.kernels import swiglu as sg_kernel  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshShape, run_jobs  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs import pipeline_health, validate_trace  # noqa: E402
from repro_torch.optim import SGD, AdamW  # noqa: E402
from repro_torch.serverless.platform import get_platform  # noqa: E402
from repro_torch.serverless.runtime import Execution, run_plan  # noqa: E402
from repro_torch.serverless.runtime import worker as worker_mod  # noqa: E402
from repro_torch.serverless.runtime.store import classify_key  # noqa: E402
from repro_torch.serverless.simulator import simulate_funcpipe  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServingSpec,
    arch_config_for_model,
    estimate_serving,
    make_prompt,
    reference_decode,
    run_serve_plan,
)
from repro_torch.serving.worker import greedy_token  # noqa: E402
from repro_torch.testing.pipeline_equiv import reference_step  # noqa: E402
from repro_torch.train import serve_step as mesh_serve  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    local_batch,
    make_train_state,
    make_train_step,
)

SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's clock: covers a call's host side
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  fp32-accurate
# products run on the tensor cores as three TF32 products each (the tf32x3
# route), so the least time for fp32 work is three TF32 products a flop at
# the dense TF32 rate, 495 / 3 = 165 TFLOP/s, not the CUDA cores' 67: one
# yardstick for every fp32 row, which none can read over.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}

KERNEL_CASES = [(512, 1), (512, 511), (1024, 700), (2048, 2048)]
KERNEL_HEADS = [(8, 2, 64), (4, 4, 128), (16, 2, 128)]
PHI3_DECODE = dict(B=4, H=32, hd=96, C=1024)
SERVE = dict(batch=4, prefill_tokens=1008, new_tokens=16)   # s_ctx = 1024
SERVE_CUTS = (8, 16, 24)       # 4 stages of 8 layers (profile: embed, 32, head)
REDUCED = dict(batch=2, prefill_tokens=24, new_tokens=8)
FP32_STEPS = 5                 # teacher-forced steps of the fp32 full-width check

# training: flash cases of tests/test_kernels.py:18-58 (B, S, Hq, Hkv, hd,
# causal, window), ragged S (100, and 200 with a window of 48), and the
# full-width train shape; in bf16 also qwen2.5-14b's attention (GQA 40/8, hd
# 128) on the wgmma route
FLASH_CASES = [(2, S, Hq, Hkv, hd, True, 0) for S, Hq, Hkv, hd in (
    (128, 4, 4, 64), (256, 8, 2, 64), (256, 4, 1, 128), (128, 2, 2, 96), (384, 8, 4, 256))]
FLASH_CASES += [(1, 256, 4, 2, 64, True, w) for w in (64, 128, 1024)]
FLASH_CASES += [(2, 128, 4, 4, 80, False, 0), (2, 100, 4, 2, 96, True, 0),
                (1, 200, 4, 4, 64, True, 48)]
FLASH_BF16_CASES = [(1, 1024, 40, 8, 128, True, 0)]
FLASH_TRAIN = (2, 1024, 32, 32, 96, True, 0)
# gemma3-4b's attention (Hq 8, Hkv 4, hd 256) at train_gemma's shapes: its
# global and its window-1024 layers at S 2048
FLASH_GEMMA = [(1, 2048, 8, 4, 256, True, 0), (1, 2048, 8, 4, 256, True, 1024)]
# the same heads at train_full's batch and length: the hd-256 timing shape of
# earlier runs (simt in bf16 until the wgmma route took hd 256)
FLASH_HD256 = (2, 1024, 8, 4, 256, True, 0)
# bf16 at hd 256 on the wgmma route: the shapes above, a ragged S, MQA, a
# window that is no tile's multiple over a ragged S, and no mask
FLASH_HD256_CASES = FLASH_GEMMA + [FLASH_HD256, (2, 200, 8, 4, 256, True, 0),
                                   (2, 256, 4, 1, 256, True, 0), (1, 200, 4, 4, 256, True, 48),
                                   (2, 128, 4, 4, 256, False, 0)]
# swiglu: the cases of tests/test_kernels.py:74-84, the tensor-core routes'
# edges (T 1 and 100, a ragged last k-tile at d 200, a ragged column tile at
# f 520) and odd shapes that take the simt route (37 x 200 x 300 in bf16, 37
# x 198 x 302 in both); a slice of phi3's FFN (in fp32, as at the training
# shape, against a float64 oracle and beside the plain version: at d 3072
# the fp32 plain version's sums are less exact than the kernel's, and the two
# differ by more than 2e-5; see _swiglu_fp32_vs_float64)
SWIGLU_CASES = [(256, 256, 512), (512, 512, 2048), (128, 384, 1536), (100, 256, 512),
                (1, 256, 512), (128, 200, 512), (128, 256, 520), (37, 200, 300),
                (37, 198, 302)]
SWIGLU_SLICE = (256, 3072, 8192)
SWIGLU_TRAIN = (2048, 3072, 8192)
TRAIN = dict(n_layers=4, seq=1024, micro_batch=2, d=2, mu=2, steps=2, cut=2)
TRAIN_REDUCED = dict(n_layers=4, seq=16, micro_batch=2, d=2, mu=2, steps=2, cut=2)
# gemma3-4b: two periods of six layers, a stage each (cuts are period-aligned)
# train_planned: train_full's model, depth, sequence and micro-batch, with the
# stage cut, memory and d chosen by the port's planner (d <= 2 keeps the
# emulated replicas on one card, as train_full's d = 2 does)
TRAIN_PLANNED = dict(n_layers=4, seq=1024, micro_batch=2, total_micro_batches=4,
                     d_options=(1, 2), steps=2)
# train_chaos: train_full's plan for 3 steps (the chaos schedule's crash
# falls in step 1 and its lifetime cap needs a third), and on process the
# same plan cut to one layer a stage
CHAOS_STEPS = 3
TRAIN_CHAOS_CUT = dict(TRAIN, n_layers=2, cut=1)
# calibrate_replan: 3 traced steps (step 0, the warm-up, is dropped)
CALIBRATE_STEPS = 3
# numbers one phase passes to a later one
RESULTS: dict = {}
TRAIN_GEMMA = dict(n_layers=12, seq=2048, micro_batch=1, d=1, mu=2, steps=2, cut=6)
# gemma3-4b in fp32: one period, one stage (no cut)
TRAIN_GEMMA_FP32 = dict(n_layers=6, seq=2048, micro_batch=1, d=1, mu=2, steps=1, cut=-1)


T_START = time.perf_counter()


def emit(doc: dict) -> None:
    """One JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in doc:
        doc = {**doc, "script_s": time.perf_counter() - T_START}
    print(json.dumps(doc), flush=True)


def _close_at(out, ref, rtol, atol, what):
    err = float((out.double() - ref.double()).abs().max())
    if not torch.allclose(out.double(), ref.double(), rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its reference, max |err| {err}")
    return err


def _close(out, ref, tol, what):
    return _close_at(out, ref, tol, tol, what)


def _time_ms(fn, flush, reps=25):
    """Median of ``reps`` single-call CUDA-event timings, L2 flushed before
    each (the decode path finds each layer's cache cold).  A sleep kernel
    holds the card while the host enqueues the call (python, autograd,
    launches), so the time is the card's alone: without it a call whose
    host side outlasts its kernels, as autograd of SDPA does, times the
    host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms_by_kernel(fn, flush, calls=5, word="flash") -> dict:
    """Device ms a call of ``fn`` by kernel whose name holds ``word``
    (``torch.profiler`` over ``calls`` calls, L2 flushed before each): which
    pass of a kernel pair takes the time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"(\w+_kernel)", e.key)
        if name and e.device_type == torch.autograd.DeviceType.CUDA and word in e.key:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            out[name.group(1)] = out.get(name.group(1), 0.0) + us / 1e3 / calls
    return out


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def _entry_label(mangled: str) -> str:
    """``flash_tf32x3_fwd_kernel<96>``-like label of a mangled entry name
    (``_ZN<len><name>...<len><name>I<args>EEv...``): the nested name's
    identifier that ends in ``_kernel``, with its template arguments."""
    def ident(at):   # <length><identifier> at ``at`` -> (identifier, end)
        digits = re.match(r"\d+", mangled[at:])
        end = at + digits.end() + int(digits.group())
        return mangled[at + digits.end():end], end

    at = 3
    while mangled.startswith("_ZN") and at < len(mangled) and mangled[at].isdigit():
        name, at = ident(at)
        if not name.endswith("_kernel"):
            continue
        args, close = [], mangled.find("EEv", at)
        at += 1 if mangled.startswith("I", at) else len(mangled)
        while at < close:
            value = re.match(r"L[ib](-?\d+)E", mangled[at:])
            if value:
                args.append(value.group(1))
                at += value.end()
            elif mangled[at].isdigit():
                arg, at = ident(at)
                args.append(arg)
            else:
                args.append({"f": "float", "i": "int"}.get(mangled[at], mangled[at]))
                at += 1
        return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def _kernel_reports(log: str) -> list:
    """Per entry function of a ptxas -v report: registers, static shared
    memory and spill bytes."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out.append({"entry": _entry_label(name),
                    "registers": int(regs.group(1)) if regs else None,
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "spill_bytes": int(spill.group(1)) + int(spill.group(2)) if spill else None})
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    info = kernel_build.build_all()
    libs = {}
    for name, rec in info.items():
        log = rec["compiler_log"]
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        libs[name] = {"library": rec["path"], "seconds": rec["seconds"],
                      "cached": rec["cached"],
                      "kernels": len(regs), "registers": regs,
                      "max_registers": max(regs, default=None),
                      "spill_bytes": spills, "max_spill_bytes": max(spills, default=None)}
    libs["swiglu"]["per_kernel"] = _kernel_reports(info["swiglu"]["compiler_log"])
    libs["decode_attention"]["per_kernel"] = _kernel_reports(
        info["decode_attention"]["compiler_log"])
    lib = sg_kernel.build()
    libs["swiglu"]["wgmma_dynamic_smem_bytes"] = lib.repro_swiglu_wgmma_smem_bytes()
    libs["swiglu"]["tf32x3_dynamic_smem_bytes"] = lib.repro_swiglu_tf32x3_smem_bytes()
    libs["flash_attention"]["per_kernel"] = _kernel_reports(
        info["flash_attention"]["compiler_log"])
    lib = fa_kernel.build()
    for way, dims in (("wgmma", fa_kernel.HEAD_DIMS), ("tf32x3", fa_kernel.TF32X3_HEAD_DIMS)):
        smem = getattr(lib, f"repro_flash_{way}_smem_bytes")
        libs["flash_attention"][f"{way}_dynamic_smem_bytes"] = {
            f"hd{hd}": dict(zip(("fwd", "dkdv", "dq"), (smem(kernel, hd) for kernel in range(3))))
            for hd in dims}
    # the tf32x3 kernels' ptxas report on a line of its own
    libs["flash_attention"]["tf32x3_kernels"] = [
        r for r in libs["flash_attention"]["per_kernel"]
        if "tf32x3" in r["entry"] or r["entry"].startswith("flash_delta_kernel")]
    # and the wgmma route's hd-256 kernels', which must not spill
    hd256 = [r for r in libs["flash_attention"]["per_kernel"]
             if re.match(r"flash_(wgmma\w*<256|delta_kernel<__nv_bfloat16,256)", r["entry"])]
    libs["flash_attention"]["wgmma_hd256_kernels"] = hd256
    # and the tf32x3 route's at hd 256 (forward, dK/dV, dQ, probe, the split
    # pass's two, D in fp32), which must not spill either
    x3w = [r for r in libs["flash_attention"]["per_kernel"]
           if re.match(r"flash_(tf32x3_(hd256|split)|delta_kernel<float,256>)", r["entry"])]
    libs["flash_attention"]["tf32x3_hd256_kernels"] = x3w
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": libs})
    if len(hd256) < 6 or any(r["spill_bytes"] != 0 for r in hd256):
        raise AssertionError(f"hd-256 wgmma kernels missing or spilling: {hd256}")
    if len(x3w) < 7 or any(r["spill_bytes"] != 0 for r in x3w):
        raise AssertionError(f"hd-256 tf32x3 kernels missing or spilling: {x3w}")


def _bound(nbytes: float, flops: float, dtype) -> tuple:
    """The least time the card could take: bytes over HBM, operations over
    the peak rate of the inputs' type; (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _decode_parity(gen, flush) -> tuple:
    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    n_cases = 0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for C, length in KERNEL_CASES:
            for Hq, Hkv, hd in KERNEL_HEADS:
                q, k, v = rand(2, Hq, hd, dtype=dtype), rand(2, Hkv, C, hd, dtype=dtype), \
                    rand(2, Hkv, C, hd, dtype=dtype)
                L = torch.tensor([length], dtype=torch.int32, device="cuda")
                _close(ops.decode_attention(q, k, v, L),
                       ops.decode_attention(q, k, v, L, impl="ref"), tol,
                       f"C={C} length={length} Hq={Hq} Hkv={Hkv} hd={hd} {dtype}")
                n_cases += 1

    # the split pass's chunk edges (lengths around a chunk's end, G 1, 4, 8),
    # and two calls on the same inputs: the same bits
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for G in (1, 4, 8):
            C, hd = 1024, 128
            q, k, v = rand(2, 2 * G, hd, dtype=dtype), rand(2, 2, C, hd, dtype=dtype), \
                rand(2, 2, C, hd, dtype=dtype)
            chunk = da_kernel.split_chunk(C)
            for length in (1, chunk - 1, chunk, chunk + 1, C - 1, C):
                L = torch.tensor([length], dtype=torch.int32, device="cuda")
                out = ops.decode_attention(q, k, v, L)
                _close(out, ops.decode_attention(q, k, v, L, impl="ref"), tol,
                       f"split edge G={G} chunk={chunk} length={length} {dtype}")
                if not torch.equal(out, ops.decode_attention(q, k, v, L)):
                    raise AssertionError(f"decode G={G} length={length}: two calls differ")
                n_cases += 1
            # each sequence alone gives the bits it gets in the batch
            for b in range(2):
                alone = ops.decode_attention(*(t[b:b + 1].contiguous() for t in (q, k, v)), L)
                if not torch.equal(alone[0], out[b]):
                    raise AssertionError(f"decode G={G} {dtype}: sequence {b} alone differs")

    B, H, hd, C = (PHI3_DECODE[k] for k in ("B", "H", "hd", "C"))
    phi3_err = {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = rand(B, H, hd, dtype=dtype), rand(B, H, C, hd, dtype=dtype), \
            rand(B, H, C, hd, dtype=dtype)
        for length in (1, 700, 1024):
            L = torch.tensor([length], dtype=torch.int32, device="cuda")
            err = _close(ops.decode_attention(q, k, v, L),
                         ops.decode_attention(q, k, v, L, impl="ref"), tol,
                         f"phi3 B={B} H={H} hd={hd} C={C} length={length} {dtype}")
            phi3_err[f"{str(dtype)[6:]}@{length}"] = err
            n_cases += 1
    torch.cuda.synchronize()

    # timing at the serve phase's shape: bf16, a full cache (length = C)
    q, k, v = rand(B, H, hd, dtype=torch.bfloat16), \
        rand(B, H, C, hd, dtype=torch.bfloat16), rand(B, H, C, hd, dtype=torch.bfloat16)
    length = C
    L = torch.tensor([length], dtype=torch.int32, device="cuda")
    mask = (torch.arange(C, device="cuda") < length).view(1, 1, 1, C)
    ms = _time_ms(lambda: da_kernel.decode_attention(q, k, v, L), flush)
    plain_ms = _time_ms(lambda: ops.decode_attention(q, k, v, L, impl="ref"), flush)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q.unsqueeze(2), k, v, attn_mask=mask), flush)
    by_kernel = _device_ms_by_kernel(lambda: da_kernel.decode_attention(q, k, v, L), flush,
                                     calls=20, word="decode_attention")
    esz = q.element_size()
    nbytes = 2 * B * H * length * hd * esz + 2 * q.numel() * esz   # K,V to length; q; out
    flops = 4 * B * H * length * hd                                # QK^T and PV
    bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "scaled_dot_product_attention",
           "bound_ms": bound_ms, "bound_by": bound_by, "kernel_route": "splitk",
           "tflop_per_s": flops / ms / 1e9, "max_abs_err": phi3_err["bfloat16@1024"],
           "hbm_gb_per_s": nbytes / (ms * 1e-3) / 1e9, "roofline_share": bound_ms / ms}
    gt = da_kernel.build().repro_decode_attention_heads(hd, 1, 1)
    chunk = da_kernel.split_chunk(C)
    emit({"decode_attention_kernels_per_call": len(by_kernel),
          "device_ms_by_kernel": by_kernel, "chunk": chunk, "splits": -(-C // chunk),
          "heads_per_block": gt, "split_blocks": B * H * -(-C // chunk)})
    detail = {"cases": n_cases, "phi3_max_abs_err": phi3_err,
              "timing_shape": {"B": B, "Hq": H, "Hkv": H, "hd": hd, "C": C,
                               "length": length, "dtype": "bfloat16"},
              "bytes": nbytes, "flops": flops}
    return rec, detail


def _fwd_bwd(fn, inputs, dout):
    """fn's output and the gradients of its inputs for cotangent ``dout``."""
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(out, ts, dout)


def _grad_errs(grads, refs, dtype, what) -> float:
    """Gradients at 1e-4 (fp32) and 2e-2 x max|ref| (bf16); max |err|."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(grads, refs)):
        err = float((g.float() - r.float()).abs().max())
        if dtype == torch.float32:
            ok = torch.allclose(g, r, rtol=1e-4, atol=1e-4)
        else:
            ok = err <= 2e-2 * float(r.float().abs().max())
        if not ok:
            raise AssertionError(f"{what}: gradient {i} disagrees with plain, max |err| {err}")
        worst = max(worst, err)
    return worst


def _check_kernel(kernel, plain, inputs, dout, what) -> dict:
    dtype = inputs[0].dtype
    out, grads = _fwd_bwd(kernel, inputs, dout)
    ref, refs = _fwd_bwd(plain, inputs, dout)
    return {"out": _close(out, ref, 2e-5 if dtype == torch.float32 else 2e-2, what),
            "grad": _grad_errs(grads, refs, dtype, what)}


def _flash_way(dtype, hd: int) -> str:
    """The route a flash call on fresh (aligned) tensors must take."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _flash_wgmma_probe(gen) -> dict:
    """The wgmma route's one-tile probe (``repro_flash_wgmma_probe``), run
    before any full case: S = Q K^T against an fp32 product of the same bf16
    inputs and O = bf16(S) V against the product of the kernel's own S, at
    hd 128 and at hd 256 with 32 keys (the dQ pass's tiles) and 64 (the
    forward's and the dK/dV pass's); max |err| by shape."""
    lib = fa_kernel.build()
    out = {}
    for hd, bk in ((128, 128), (256, 32), (256, 64)):
        q, k, v = (torch.randn(rows, hd, generator=gen, device="cuda").bfloat16()
                   for rows in (64, bk, bk))
        s = torch.full((64, bk), float("nan"), device="cuda")
        o = torch.full((64, hd), float("nan"), device="cuda")
        err = lib.repro_flash_wgmma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          s.data_ptr(), o.data_ptr(), hd, bk,
                                          kernel_build.stream_of(q))
        if err != 0:
            raise RuntimeError(f"wgmma probe launch failed at hd {hd}, bk {bk}: cudaError {err}")
        torch.cuda.synchronize()
        what = f"wgmma probe hd={hd} bk={bk}"
        out[f"hd{hd}_bk{bk}"] = {
            "S": _close_at(s, q.float() @ k.float().T, 1e-3, 1e-3, f"{what} S"),
            "PV": _close_at(o, s.bfloat16().float() @ v.float(), 1e-3, 1e-2, f"{what} PV")}
    return out


def _flash_tf32x3_probe(gen) -> dict:
    """The tf32x3 route's one-tile probes (``repro_flash_tf32x3_probe`` at
    hd 96 and 128, ``repro_flash_tf32x3_hd256_probe`` at hd 256), run
    before any full case: S = Q K^T against an fp32 (float64 at hd 256)
    matrix product and O = S V (and at hd 256 S^T Q) against the product
    of the kernel's own S, at bars one TF32 product would miss; max |err|
    by hd."""
    lib = fa_kernel.build()
    out = {}
    for hd in (96, 128):
        q, k, v = (torch.randn(rows, hd, generator=gen, device="cuda") for rows in (16, 32, 32))
        s = torch.full((16, 32), float("nan"), device="cuda")
        o = torch.full((16, hd), float("nan"), device="cuda")
        err = lib.repro_flash_tf32x3_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           s.data_ptr(), o.data_ptr(), hd,
                                           kernel_build.stream_of(q))
        if err != 0:
            raise RuntimeError(f"tf32x3 probe launch failed: cudaError {err}")
        torch.cuda.synchronize()
        out[f"hd{hd}"] = {"S": _close_at(s, q @ k.T, 1e-5, 1e-4, f"tf32x3 probe S hd={hd}"),
                          "SV": _close_at(o, s @ v, 1e-5, 1e-3, f"tf32x3 probe SV hd={hd}")}
    # hd 256 (wgmma on the split planes): s = q k^T, o = s v with s as the
    # register A operand, z = s^T q with s written as a shared-memory B
    # operand, each against float64 products of the kernel's own s
    q, k, v = (torch.randn(rows, 256, generator=gen, device="cuda") for rows in (64, 32, 32))
    s, o, z = (torch.full(shape, float("nan"), device="cuda")
               for shape in ((64, 32), (64, 256), (32, 256)))
    ws = torch.empty(8 * 64 * 256, device="cuda")
    err = lib.repro_flash_tf32x3_hd256_probe(*(t.data_ptr() for t in (q, k, v, s, o, z, ws)),
                                             kernel_build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"tf32x3 hd-256 probe launch failed: cudaError {err}")
    torch.cuda.synchronize()
    s64 = s.double()
    out["hd256"] = {"S": _close_at(s64, q.double() @ k.double().T, 1e-5, 1e-4,
                                   "tf32x3 probe S hd=256"),
                    "SV": _close_at(o, s64 @ v.double(), 1e-5, 1e-3, "tf32x3 probe SV hd=256"),
                    "StQ": _close_at(z, s64.T @ q.double(), 1e-5, 1e-3,
                                     "tf32x3 probe S^T Q hd=256")}
    return out


def _flash_parity(gen, gen256, gen256f, flush) -> tuple:
    """Flash attention against its plain version on every case, then its
    timings.  The hd-256 cases and timings added with the wgmma route at hd
    256 draw from ``gen256``, those added with the tf32x3 route at hd 256
    (fp32) from ``gen256f``, the rest from ``gen`` in the order they always
    did, so no sweep's inputs depend on another's case list."""
    n_cases, train_err, hd256_err, hd256_fp32_err, routes = 0, {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        extra = FLASH_BF16_CASES + FLASH_HD256_CASES if dtype == torch.bfloat16 \
            else FLASH_HD256_CASES
        for case in FLASH_CASES + extra + [FLASH_TRAIN]:
            B, S, Hq, Hkv, hd, causal, window = case
            g = gen
            if case in FLASH_HD256_CASES:
                g = gen256 if dtype == torch.bfloat16 else gen256f
            q = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(B, S, Hkv, hd, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            do = torch.randn(B, S, Hq, hd, generator=g, device="cuda").to(dtype)
            what = (f"flash B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} causal={causal} "
                    f"window={window} {dtype}")
            ops.reset_launch_counts()
            err = _check_kernel(
                lambda a, b, c: ops.flash_attention(a, b, c, causal=causal, window=window),
                lambda a, b, c: ops.flash_attention(a, b, c, causal=causal, window=window,
                                                    impl="ref"),
                (q, k, v), do, what)
            # the backward twice on the same inputs: the same bits (no atomics)
            o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
            grads = [fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                   window=window) for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*grads)):
                raise AssertionError(f"{what}: two backward calls differ")
            way = _flash_way(dtype, hd)
            counts = ops.launch_counts()
            if (counts[f"flash_attention_{way}"], counts[f"flash_attention_bwd_{way}"]) != (2, 3) \
                    or (counts["flash_attention"], counts["flash_attention_bwd"]) != (2, 3):
                raise AssertionError(f"{what}: expected the {way} route, launches {counts}")
            routes[f"{B}x{S}x{Hq}/{Hkv}x{hd} causal={causal} window={window} "
                   f"{str(dtype)[6:]}"] = way
            n_cases += 1
            if (B, S, Hq, Hkv, hd, causal, window) == FLASH_TRAIN:
                train_err[str(dtype)[6:]] = err
            elif dtype == torch.bfloat16 and hd == 256:
                hd256_err[(B, S, Hq, Hkv, hd, causal, window)] = err
            elif case in FLASH_HD256_CASES:
                hd256_fp32_err[case] = err
    torch.cuda.synchronize()

    bf16 = _flash_timing(gen, flush, torch.bfloat16)
    fp32 = _flash_timing(gen, flush, torch.float32)
    # hd 256: gemma3-4b's training shapes in bf16 (the global layers' is the
    # row of the kernels' record), and the earlier timing shape in bf16 and
    # in fp32 (simt)
    hd256 = {(FLASH_HD256, torch.bfloat16): _flash_timing(gen, flush, torch.bfloat16,
                                                          FLASH_HD256)}
    hd256 |= {(shape, dtype): _flash_timing(gen256, flush, dtype, shape)
              for shape, dtype in [(shape, torch.bfloat16) for shape in FLASH_GEMMA]
              + [(FLASH_HD256, torch.float32)]}
    # fp32 at train_gemma_fp32's shapes (tf32x3 at hd 256)
    hd256 |= {(shape, torch.float32): _flash_timing(gen256f, flush, torch.float32, shape)
              for shape in FLASH_GEMMA}
    g_global = FLASH_GEMMA[0]
    gemma = hd256[g_global, torch.bfloat16]
    gemma_fp32 = hd256[g_global, torch.float32]
    B, S, H, _, hd, _, _ = FLASH_TRAIN

    def rec(r, err):
        return {k: v for k, v in r.items() if k not in ("bytes", "flops")} | \
            {"max_abs_err": err}

    fp32_way = _flash_way(torch.float32, hd)
    recs = {"flash_attention": rec(bf16["fwd"], train_err["bfloat16"]["out"]),
            "flash_attention_bwd": rec(bf16["bwd"], train_err["bfloat16"]["grad"]),
            "flash_attention_hd256": rec(gemma["fwd"], hd256_err[g_global]["out"]),
            "flash_attention_bwd_hd256": rec(gemma["bwd"], hd256_err[g_global]["grad"]),
            f"flash_attention_{fp32_way}": rec(fp32["fwd"], train_err["float32"]["out"]),
            f"flash_attention_bwd_{fp32_way}": rec(fp32["bwd"], train_err["float32"]["grad"]),
            f"flash_attention_hd256_{fp32_way}": rec(gemma_fp32["fwd"],
                                                     hd256_fp32_err[g_global]["out"]),
            f"flash_attention_bwd_hd256_{fp32_way}": rec(gemma_fp32["bwd"],
                                                         hd256_fp32_err[g_global]["grad"])}
    detail = {"cases": n_cases, "routes": routes, "train_shape_max_abs_err": train_err,
              "timing_shape": {"B": B, "S": S, "Hq": H, "Hkv": H, "hd": hd, "causal": True,
                               "dtype": ["bfloat16", "float32"]},
              "bytes_flops": {f"{k} {dtype}": {"bytes": r[k]["bytes"], "flops": r[k]["flops"],
                                               "tflop_per_s": r[k]["tflop_per_s"]}
                              for dtype, r in (("bfloat16", bf16), ("float32", fp32))
                              for k in ("fwd", "bwd")},
              "sdpa": {"bfloat16": bf16["sdpa"], "float32": fp32["sdpa"]},
              "simt_kernels_on_bf16_ms": bf16["simt"],
              "simt_kernels_on_fp32_ms": fp32["simt"],
              "bwd_passes_ms": {"bfloat16": bf16["bwd_passes_ms"],
                                "float32": fp32["bwd_passes_ms"]},
              # gemma3-4b's attention: bf16 on the wgmma route and fp32 on
              # the tf32x3 route at the training shapes and at the earlier
              # [2,1024] shape, with the simt kernels on the same inputs
              "hd256_max_abs_err": {str(k): v for k, v in hd256_err.items()},
              "hd256_fp32_max_abs_err": {str(k): v for k, v in hd256_fp32_err.items()},
              "hd256": {f"{'x'.join(map(str, shape[:5]))} window={shape[6]} "
                        f"{str(dtype)[6:]}": r for (shape, dtype), r in hd256.items()}}
    return recs, detail


def _sdpa_times(q, k, v, do, flush, backend, causal=True) -> dict:
    """scaled_dot_product_attention (causal unless ``causal`` is False)
    forward, backward and both, in [B, H, S, hd] layout, with the
    dispatcher pinned to ``backend`` (None: its default choice): the
    yardstick of the flash kernels' times (the port never calls it)."""
    from torch.nn.attention import sdpa_kernel

    G = q.shape[2] // k.shape[2]   # GQA: K and V heads repeated to the query heads
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (qh, kh, vh))
    with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
        fwd = _time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
                       flush)
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        bwd = _time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), doh, retain_graph=True),
                       flush)

        def fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), doh)

        both = _time_ms(fwd_bwd, flush)
    return {"backend": backend.name if backend is not None else "default", "fwd_ms": fwd,
            "bwd_ms": bwd, "fwd_bwd_ms": both}


def _causal_pairs(S: int, window: int) -> int:
    """(q, k) pairs of one head that a causal mask allows, with a sliding
    window of ``window`` keys if it is > 0."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_timing(gen, flush, dtype, shape=FLASH_TRAIN) -> dict:
    """The forward and backward kernels at ``shape`` (its mask: causal, with
    its window, or none; the training shape by default) in ``dtype``, beside
    their plain versions, SDPA pinned to one backend (flash attention in
    bf16, memory-efficient attention in fp32, which the flash backend does
    not take; none with a window, which no SDPA backend computes) and the bound;
    SDPA's default dispatch beside it; on a tensor-core route, the simt
    kernels on the same inputs too."""
    from torch.nn.attention import SDPBackend

    B, S, H, Hkv, hd, causal, window = shape
    q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    way = _flash_way(dtype, hd)
    ops.reset_launch_counts()
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    fwd_ms = _time_ms(lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window),
                      flush)
    bwd_ms = _time_ms(lambda: fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                            window=window), flush)
    passes = _device_ms_by_kernel(
        lambda: fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window),
        flush)
    fwd_passes = _device_ms_by_kernel(
        lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window), flush)
    counts = ops.launch_counts()
    if counts[f"flash_attention_{way}"] != counts["flash_attention"] or \
            counts[f"flash_attention_bwd_{way}"] != counts["flash_attention_bwd"]:
        raise AssertionError(f"timed flash {dtype} off the {way} route: {counts}")
    backend = SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16 \
        else SDPBackend.EFFICIENT_ATTENTION
    if window:
        sdpa = {"backend": None, "fwd_ms": None, "bwd_ms": None, "fwd_bwd_ms": None}
    else:
        sdpa = _sdpa_times(q, k, v, do, flush, backend, causal)
        sdpa["deterministic_algorithms"] = torch.are_deterministic_algorithms_enabled()
        sdpa["default_dispatch"] = _sdpa_times(q, k, v, do, flush, None, causal)
    simt = {}
    if way != "simt":
        # the simt kernels on the same inputs, through their C entry points
        # (uncounted): the design the tensor-core kernels replace
        lib, stream = fa_kernel.build(), kernel_build.stream_of(q)
        so, slse = torch.empty_like(q), torch.empty_like(lse)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ptrs = [t.data_ptr() for t in (q, k, v)]
        args = (B, S, H, Hkv, hd, fa_kernel._DTYPES[dtype], int(causal), window, hd ** -0.5,
                stream)
        simt["fwd_ms"] = _time_ms(lambda: lib.repro_flash_attention_fwd(
            *ptrs, so.data_ptr(), slse.data_ptr(), *args), flush, reps=10)
        kmean = fa_kernel.key_means(k)
        simt["bwd_ms"] = _time_ms(lambda: lib.repro_flash_attention_bwd(
            *ptrs, o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), kmean.data_ptr(), *args), flush, reps=10)
        _close(so, o, 2e-5 if dtype == torch.float32 else 2e-2, f"flash simt vs {way}, {dtype}")
    fwd_plain = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window,
                                                     impl="ref"), flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref_out = ops.flash_attention(qg, kg, vg, causal=causal, window=window, impl="ref")
    bwd_plain = _time_ms(lambda: torch.autograd.grad(ref_out, (qg, kg, vg), do,
                                                     retain_graph=True), flush)
    slab = B * S * H * hd * q.element_size()     # one of q, o, do, dq
    kv_slab = B * S * Hkv * hd * q.element_size()  # one of k, v, dk, dv
    # (q, k) pairs the mask allows: all S^2 of a head without one
    pairs = B * H * (_causal_pairs(S, window) if causal else S * S)
    lse_b = B * H * S * 4
    fwd_b, fwd_f = 2 * slab + 2 * kv_slab + lse_b, 4 * hd * pairs    # QK^T, PV
    bwd_b, bwd_f = 4 * slab + 4 * kv_slab + lse_b, 10 * hd * pairs   # S, dP, dV, dK, dQ
    fwd_bound, fwd_by = _bound(fwd_b, fwd_f, dtype)
    bwd_bound, bwd_by = _bound(bwd_b, bwd_f, dtype)
    call = f"scaled_dot_product_attention(is_causal={causal}), {sdpa['backend']} backend" \
        if sdpa["backend"] else None

    def split(by_kernel):   # the tf32x3 route at hd 256: its split pass's device ms
        ms = sum(t for name, t in by_kernel.items() if name.startswith("flash_tf32x3_split"))
        return {"split_ms": ms} if ms else {}

    return {
        "fwd": {"ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": sdpa["fwd_ms"],
                "library_call": call, "bound_ms": fwd_bound, "bound_by": fwd_by,
                "kernel_route": way, "tflop_per_s": fwd_f / fwd_ms / 1e9,
                "bytes": fwd_b, "flops": fwd_f, **split(fwd_passes)},
        "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": sdpa["bwd_ms"],
                "library_call": call and f"autograd of {call}", "bound_ms": bwd_bound,
                "bound_by": bwd_by, "kernel_route": way, "tflop_per_s": bwd_f / bwd_ms / 1e9,
                "bytes": bwd_b, "flops": bwd_f, **split(passes)},
        "sdpa": sdpa, "simt": simt, "fwd_passes_ms": fwd_passes, "bwd_passes_ms": passes}


def _swiglu_way(dtype, d: int, f: int) -> str:
    """The route a swiglu call on fresh (aligned) tensors must take."""
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "wgmma"
    return "tf32x3" if dtype == torch.float32 and d % 4 == 0 and f % 4 == 0 else "simt"


def _swiglu_tf32x3_probe(gen) -> dict:
    """The swiglu tf32x3 route's mainloop alone (``repro_swiglu_tf32x3_
    products``, after its split pass), one tile and one k-tile first, run
    before any full case: g and u against float64 products at 2e-5, a bar
    one TF32 product misses; max |err| by shape."""
    lib = sg_kernel.build()
    out = {}
    for T, d, f in ((128, 32, 128), (64, 32, 128), (100, 200, 520)):
        x = torch.randn(T, d, generator=gen, device="cuda")
        wg, wu = (0.05 * torch.randn(d, f, generator=gen, device="cuda") for _ in range(2))
        g, u = (torch.full((T, f), float("nan"), device="cuda") for _ in range(2))
        ws = sg_kernel.workspace(T, d, f, x.device)
        err = lib.repro_swiglu_tf32x3_products(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                               g.data_ptr(), u.data_ptr(), ws.data_ptr(), T, d,
                                               f, kernel_build.stream_of(x))
        if err != 0:
            raise RuntimeError(f"swiglu tf32x3 probe launch failed: cudaError {err}")
        torch.cuda.synchronize()
        out[f"{T}x{d}x{f}"] = {
            name: _close(got.double(), x.double() @ w.double(), 2e-5,
                         f"swiglu tf32x3 probe {name} T={T} d={d} f={f}")
            for got, w, name in ((g, wg, "g"), (u, wu, "u"))}
    return out


def _swiglu_bwd_composition(x, wg, wu, dout):
    """The backward kernel's function as PyTorch calls in x's dtype: the
    yardstick of its time (the port never calls it)."""
    g, u = x @ wg, x @ wu
    s = torch.sigmoid(g)
    return dout * u * s * (1 + g * (1 - s)), dout * g * s


def _swiglu_timing(gen, flush, dtype, shape=SWIGLU_TRAIN) -> dict:
    """The forward and backward kernels at ``shape`` (T, d, f; the training
    shape by default) in ``dtype``, beside their plain versions, the PyTorch
    compositions and the bound."""
    T, d, f = shape
    x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
    wg, wu = ((0.02 * torch.randn(d, f, generator=gen, device="cuda")).to(dtype)
              for _ in range(2))
    dout = torch.randn(T, f, generator=gen, device="cuda").to(dtype)
    way = _swiglu_way(dtype, d, f)
    ops.reset_launch_counts()
    fwd_ms = _time_ms(lambda: sg_kernel.swiglu_fwd(x, wg, wu), flush, reps=10)
    bwd_ms = _time_ms(lambda: sg_kernel.swiglu_bwd(x, wg, wu, dout), flush, reps=10)
    counts = ops.launch_counts()
    if counts[f"swiglu_{way}"] != counts["swiglu"] or \
            counts[f"swiglu_bwd_{way}"] != counts["swiglu_bwd"]:
        raise AssertionError(f"timed swiglu {dtype} off the {way} route: {counts}")
    simt, split_ms = {}, None
    lib, stream = sg_kernel.build(), kernel_build.stream_of(x)
    ptrs = [t.data_ptr() for t in (x, wg, wu)]
    if way != "simt":
        # the simt kernels on the same inputs, through their C entry points
        # (uncounted): the design the tensor-core kernels replace
        out, dg, du = (torch.empty(T, f, dtype=dtype, device="cuda") for _ in range(3))
        code = sg_kernel._DTYPES[dtype]
        simt["fwd_ms"] = _time_ms(lambda: lib.repro_swiglu_fwd(
            *ptrs, out.data_ptr(), T, d, f, code, stream), flush, reps=10)
        simt["bwd_ms"] = _time_ms(lambda: lib.repro_swiglu_bwd(
            *ptrs, dout.data_ptr(), dg.data_ptr(), du.data_ptr(), T, d, f, code, stream),
            flush, reps=10)
        _close(out, sg_kernel.swiglu_fwd(x, wg, wu), 2e-5 if dtype == torch.float32 else 2e-2,
               f"swiglu simt vs {way}, {dtype}")
    if way == "tf32x3":
        # the split pass alone: part of each tf32x3 call's time
        ws = sg_kernel.workspace(T, d, f, x.device)
        split_ms = _time_ms(lambda: lib.repro_swiglu_tf32x3_split(
            *ptrs, ws.data_ptr(), T, d, f, stream), flush, reps=10)
        del ws
    fwd_plain = _time_ms(lambda: ops.swiglu(x, wg, wu, impl="ref"), flush, reps=10)
    bwd_plain = _time_ms(lambda: kernel_ref.swiglu_bwd_ref(x, wg, wu, dout), flush, reps=10)
    fwd_lib = _time_ms(lambda: F.silu(x @ wg) * (x @ wu), flush, reps=10)
    bwd_lib = _time_ms(lambda: _swiglu_bwd_composition(x, wg, wu, dout), flush, reps=10)
    esz = x.element_size()
    flops = 2 * 2 * T * d * f
    fwd_b = (T * d + 2 * d * f + T * f) * esz
    bwd_b = (T * d + 2 * d * f + 3 * T * f) * esz
    fwd_bound, fwd_by = _bound(fwd_b, flops, dtype)
    bwd_bound, bwd_by = _bound(bwd_b, flops, dtype)

    def split(ms):   # the tf32x3 route: its split pass, and the main kernel's TF32 rate
        if split_ms is None:
            return {}
        return {"split_ms": split_ms,
                "tf32_tflop_per_s_of_products": 3 * flops / (ms - split_ms) / 1e9}

    return {
        "fwd": {"ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": fwd_lib,
                "library_call": "composition: silu(x@wg) * (x@wu)",
                "bound_ms": fwd_bound, "bound_by": fwd_by, "kernel_route": way,
                "tflop_per_s": flops / fwd_ms / 1e9, "bytes": fwd_b, "flops": flops,
                **split(fwd_ms)},
        "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": bwd_lib,
                "library_call": "composition: g=x@wg, u=x@wu, s=sigmoid(g), "
                                "dg=dout*u*s*(1+g*(1-s)), du=dout*g*s",
                "bound_ms": bwd_bound, "bound_by": bwd_by, "kernel_route": way,
                "tflop_per_s": flops / bwd_ms / 1e9, "bytes": bwd_b, "flops": flops,
                **split(bwd_ms)},
        "simt": simt}


def _past_bar(a, b, tol) -> dict:
    """max |a - b| and the elements past ``|a - b| <= tol + tol |b|``."""
    err = (a.double() - b.double()).abs()
    return {"max_abs_err": float(err.max()),
            "past_bar": int((err > tol + tol * b.double().abs()).sum()), "of": err.numel()}


def _swiglu_fp32_vs_float64(gen, shape) -> dict:
    """One fp32 case at d 3072 on the tf32x3 route.  The kernels' outputs
    (out, dg and du) are held against a float64 oracle at 2e-5; at T 256
    the gradients (the chain rule's fp32 products of dg and du) are too, at
    1e-4.  The 2e-5 / 1e-4 bars against the fp32 plain version are kept and
    reported with the elements past them: at d 3072 the plain version's
    sums (cuBLAS, one fp32 accumulator down k) are further from the exact
    ones than the kernels' (a fresh accumulator every 32 of k), and the two
    differ by more than the bar on a few elements.  At T 2048, where dW sums
    2048 rows in fp32 and the plain path misses 1e-4 against float64 itself,
    every one of out, dg, du, dx, dW_gate and dW_up must be no further from
    float64 than the plain path's, by max |err| and by the elements past
    the bar.  Two backward calls give the same bits."""
    T, d, f = shape
    x = torch.randn(T, d, generator=gen, device="cuda")
    wg, wu = (0.05 * torch.randn(d, f, generator=gen, device="cuda") for _ in range(2))
    dout = torch.randn(T, f, generator=gen, device="cuda")
    what = f"swiglu fp32 T={T} d={d} f={f}"
    ops.reset_launch_counts()
    out, grads = _fwd_bwd(ops.swiglu, (x, wg, wu), dout)
    dg, du = sg_kernel.swiglu_bwd(x, wg, wu, dout)
    if not all(torch.equal(a, b) for a, b in zip((dg, du), sg_kernel.swiglu_bwd(x, wg, wu, dout))):
        raise AssertionError(f"{what}: two backward calls differ")
    counts = ops.launch_counts()
    if (counts["swiglu_tf32x3"], counts["swiglu_bwd_tf32x3"]) != (1, 3):
        raise AssertionError(f"{what}: expected the tf32x3 route, launches {counts}")
    x64, wg64, wu64, dout64 = (t.double() for t in (x, wg, wu, dout))
    ref, ref_grads = _fwd_bwd(lambda a, b, c: F.silu(a @ b) * (a @ c), (x64, wg64, wu64),
                              dout64)
    g64, u64 = x64 @ wg64, x64 @ wu64
    sig = torch.sigmoid(g64)
    exact = {"out": ref, "dg": dout64 * u64 * sig * (1 + g64 * (1 - sig)), "du": dout64 * g64 * sig}
    del g64, u64, sig
    got = {"out": out, "dg": dg, "du": du}
    rec = {"vs_float64": {name: _close(got[name], exact[name], 2e-5, f"{what} {name} vs float64")
                          for name in got}}
    if shape == SWIGLU_SLICE:
        rec["vs_float64"]["grad"] = max(_close_at(g, r, 1e-4, 1e-4, f"{what} gradient vs float64")
                                        for g, r in zip(grads, ref_grads))
    # beside it, the fp32 plain version: reported, with its own distance
    # from the oracle
    plain = {"out": ops.swiglu(x, wg, wu, impl="ref")}
    plain["dg"], plain["du"] = kernel_ref.swiglu_bwd_ref(x, wg, wu, dout)
    _, plain_grads = _fwd_bwd(lambda a, b, c: ops.swiglu(a, b, c, impl="ref"), (x, wg, wu), dout)
    names = ("dx", "dw_gate", "dw_up")
    rec["vs_fp32_plain"] = {name: _past_bar(got[name], plain[name], 2e-5) for name in got} | {
        name: _past_bar(g, p, 1e-4) for name, g, p in zip(names, grads, plain_grads)}
    rec["grads_vs_float64"] = {name: _past_bar(g, r, 1e-4)
                               for name, g, r in zip(names, grads, ref_grads)}
    rec["fp32_plain_vs_float64"] = {name: _past_bar(plain[name], exact[name], 2e-5)
                                    for name in got} | {
        name: _past_bar(p, r, 1e-4) for name, p, r in zip(names, plain_grads, ref_grads)}
    rec["plain_bar_held"] = not any(r["past_bar"] for r in rec["vs_fp32_plain"].values())
    if shape != SWIGLU_SLICE:
        kernel = {name: _past_bar(got[name], exact[name], 2e-5) for name in got} | \
            rec["grads_vs_float64"]
        for name, k in kernel.items():
            p = rec["fp32_plain_vs_float64"][name]
            if k["max_abs_err"] > p["max_abs_err"] or k["past_bar"] > p["past_bar"]:
                raise AssertionError(f"{what} {name}: further from float64 than the fp32 plain "
                                     f"path, {k} against {p}")
    return rec


def _swiglu_parity(gen, flush) -> tuple:
    n_cases, train_err, routes = 0, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        # fp32 at d 3072: _swiglu_fp32_vs_float64 below
        extra = [SWIGLU_SLICE, SWIGLU_TRAIN] if dtype == torch.bfloat16 else []
        for T, d, f in SWIGLU_CASES + extra:
            x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
            wg, wu = ((0.05 * torch.randn(d, f, generator=gen, device="cuda")).to(dtype)
                      for _ in range(2))
            dout = torch.randn(T, f, generator=gen, device="cuda").to(dtype)
            what = f"swiglu T={T} d={d} f={f} {dtype}"
            ops.reset_launch_counts()
            err = _check_kernel(ops.swiglu, lambda a, b, c: ops.swiglu(a, b, c, impl="ref"),
                                (x, wg, wu), dout, what)
            n_cases += 1
            if (T, d, f) == SWIGLU_TRAIN:
                train_err[str(dtype)[6:]] = err
            # the backward kernel's dg/du against their plain version, and a
            # second call: the same bits
            dg, du = sg_kernel.swiglu_bwd(x, wg, wu, dout)
            pdg, pdu = kernel_ref.swiglu_bwd_ref(x, wg, wu, dout)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            _close(dg, pdg, tol, f"swiglu dg T={T} d={d} f={f} {dtype}")
            _close(du, pdu, tol, f"swiglu du T={T} d={d} f={f} {dtype}")
            if not all(torch.equal(a, b) for a, b in zip((dg, du),
                                                         sg_kernel.swiglu_bwd(x, wg, wu, dout))):
                raise AssertionError(f"{what}: two backward calls differ")
            way = _swiglu_way(dtype, d, f)
            counts = ops.launch_counts()
            if (counts[f"swiglu_{way}"], counts[f"swiglu_bwd_{way}"]) != (1, 3) or \
                    (counts["swiglu"], counts["swiglu_bwd"]) != (1, 3):
                raise AssertionError(f"{what}: expected the {way} route, launches {counts}")
            routes[f"{T}x{d}x{f} {str(dtype)[6:]}"] = way
    fp32_d3072 = {}
    for shape in (SWIGLU_SLICE, SWIGLU_TRAIN):
        key = "x".join(map(str, shape))
        fp32_d3072[key] = _swiglu_fp32_vs_float64(gen, shape)
        routes[f"{key} float32"] = "tf32x3"
        n_cases += 1
    train = fp32_d3072["x".join(map(str, SWIGLU_TRAIN))]
    train_err["float32"] = {"out": train["vs_fp32_plain"]["out"]["max_abs_err"],
                            "grad": max(train["vs_fp32_plain"][name]["max_abs_err"]
                                        for name in ("dx", "dw_gate", "dw_up"))}
    torch.cuda.synchronize()

    bf16 = _swiglu_timing(gen, flush, torch.bfloat16)
    fp32 = _swiglu_timing(gen, flush, torch.float32)
    T, d, f = SWIGLU_TRAIN

    def rec(r, err, **extra):
        return {k: v for k, v in r.items() if k not in ("bytes", "flops")} | \
            {"max_abs_err": err, **extra}

    fp32_way = _swiglu_way(torch.float32, d, f)
    vs64 = train["vs_float64"]
    recs = {"swiglu": rec(bf16["fwd"], train_err["bfloat16"]["out"]),
            "swiglu_bwd": rec(bf16["bwd"], train_err["bfloat16"]["grad"]),
            f"swiglu_{fp32_way}": rec(fp32["fwd"], train_err["float32"]["out"],
                                      max_abs_err_float64=vs64["out"]),
            f"swiglu_bwd_{fp32_way}": rec(fp32["bwd"], train_err["float32"]["grad"],
                                          max_abs_err_float64=max(vs64["dg"], vs64["du"]))}
    detail = {"cases": n_cases, "routes": routes, "train_shape_max_abs_err": train_err,
              "fp32_d3072": fp32_d3072,
              "timing_shape": {"T": T, "d": d, "f": f, "dtype": ["bfloat16", "float32"]},
              "bytes_flops": {f"{k} {dtype}": {"bytes": r[k]["bytes"], "flops": r[k]["flops"]}
                              for dtype, r in (("bfloat16", bf16), ("float32", fp32))
                              for k in ("fwd", "bwd")},
              "simt_kernels_on_bf16_ms": bf16["simt"],
              "simt_kernels_on_fp32_ms": fp32["simt"]}
    return recs, detail


FLASH_SIMT_DQ = (4, 512, 16, 16, 64, False, 0)   # bert-large's attention, no mask


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element past an aligned allocation, so
    that the kernels' ``route()`` takes the CUDA-core ("simt") kernels."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _simt_dq_correction(gen) -> dict:
    """The simt flash backward's dQ correction (the keys' mean subtracted,
    as on the wgmma route): misaligned bf16 tensors at bert-large's [4, 512,
    16, 16, 64] with no mask, q, k and v sharing a common component per head
    as bert's deeper layers do at init.  dq, dk and dv are held at 2e-2 x
    max|ref| against autograd of the plain version in fp32 on the same bf16
    inputs, the route by the launch counters; the uncorrected product (the
    same C entry given a zero mean) is reported beside it."""
    B, S, Hq, Hkv, hd, causal, window = FLASH_SIMT_DQ

    def rows(H, common_scale, noise_scale):
        common = torch.randn(1, 1, H, hd, generator=gen, device="cuda")
        x = common_scale * common + noise_scale * torch.randn(B, S, H, hd, generator=gen,
                                                              device="cuda")
        return _misaligned(x.to(torch.bfloat16))

    q, k, v = rows(Hq, 0.6, 0.3), rows(Hkv, 0.6, 0.3), rows(Hkv, 0.6, 0.3)
    do = rows(Hq, 0.0, 1e-3)
    ops.reset_launch_counts()
    ts = [t.detach().requires_grad_() for t in (q, k, v)]    # no copy: still misaligned
    out = ops.flash_attention(*ts, causal=causal, window=window)
    grads = torch.autograd.grad(out, ts, do)
    counts = ops.launch_counts()
    if (counts["flash_attention_simt"], counts["flash_attention_bwd_simt"],
            counts["flash_attention"], counts["flash_attention_bwd"]) != (1, 1, 1, 1):
        raise AssertionError(f"simt dQ case: expected one simt launch each way, {counts}")
    ref, refs = _fwd_bwd(lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                                             window=window, impl="ref"),
                         [t.float() for t in (q, k, v)], do.float())
    # the uncorrected product: the same kernels with c = 0
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    plain = [torch.empty_like(t) for t in (q, k, v)]
    zero = torch.zeros(B, Hkv, hd, dtype=q.dtype, device="cuda")
    err = fa_kernel.build().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        *(t.data_ptr() for t in plain), zero.data_ptr(), B, S, Hq, Hkv, hd,
        fa_kernel._DTYPES[q.dtype], int(causal), window, hd ** -0.5,
        kernel_build.stream_of(q))
    if err:
        raise RuntimeError(f"simt backward without the correction: cudaError {err}")
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b).abs().max()) / float(b.abs().max())

    names = ("dq", "dk", "dv")
    corrected = {n: rel(g, r) for n, g, r in zip(names, grads, refs)}
    uncorrected = {n: rel(g, r) for n, g, r in zip(names, plain, refs)}
    if max(corrected.values()) > 2e-2 or rel(out, ref) > 2e-2:
        raise AssertionError(f"simt backward with the dQ correction: {corrected}, "
                             f"output {rel(out, ref)} of max|ref| (bar 2e-2)")
    return {"shape": FLASH_SIMT_DQ, "dtype": "bfloat16", "route": "simt",
            "offset_elements": 1, "out_err_over_max_ref": rel(out, ref),
            "grad_err_over_max_ref": corrected,
            "grad_err_over_max_ref_without_correction": uncorrected, "bar": 2e-2}


def phase_kernel_parity(smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    gen256 = torch.Generator(device="cuda").manual_seed(17)   # hd 256's (_flash_parity)
    gen256f = torch.Generator(device="cuda").manual_seed(29)  # and hd 256's in fp32
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    wgmma_probe = _flash_wgmma_probe(gen256)
    probe = _flash_tf32x3_probe(gen)
    swiglu_probe = _swiglu_tf32x3_probe(gen)
    decode, decode_detail = _decode_parity(gen, flush)
    flash, flash_detail = _flash_parity(gen, gen256, gen256f, flush)
    swiglu, swiglu_detail = _swiglu_parity(gen, flush)
    families, families_detail = _families_parity(flush)
    encoders, encoders_detail = _encoders_parity(flush)
    simt_dq = _simt_dq_correction(torch.Generator(device="cuda").manual_seed(53))
    recs = {"decode_attention": decode, **flash, **swiglu, **families, **encoders}
    emit({"phase": "kernel_parity", "card": smi, "kernels": recs,
          "flash_wgmma_probe_max_abs_err": wgmma_probe,
          "flash_tf32x3_probe_max_abs_err": probe,
          "swiglu_tf32x3_probe_max_abs_err": swiglu_probe,
          "decode_attention": decode_detail, "flash_attention": flash_detail,
          "swiglu": swiglu_detail, "families": families_detail,
          "encoders": encoders_detail, "flash_simt_dq_correction": simt_dq})
    return recs


def phase_adamw(smi: str) -> dict:
    """The AdamW kernel against the plain path at a phi3-mini stage (module
    docstring, 3b)."""
    t0 = time.perf_counter()
    spec = TRAIN
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    _, _, config, _ = train_setup(cfg, spec)
    span = worker_mod.stage_instance_ranges(cfg, config.x)[0]
    opt = AdamW(lr=1e-4)
    workers = {impl: worker_mod.StageWorker(cfg, span, params, mu=spec["mu"], optimizer=opt,
                                            use_kernels=impl == "kernel", device="cuda",
                                            replicas=spec["d"])
               for impl in ("kernel", "plain")}
    del params
    n = int(workers["kernel"].grad_nbytes // 4)
    gen = torch.Generator(device="cuda").manual_seed(7)
    steps = 3
    ops.reset_launch_counts()
    for step in range(steps):
        grad = 1e-2 * torch.randn(n, generator=gen, device="cuda")
        for w in workers.values():
            w.apply_update(grad, step=step)
        torch.cuda.synchronize()
        kernel, plain = (w.export_state() for w in workers.values())
        for name, a, b in ((f"{k}[{i}]", a, b) for k in kernel for i, (a, b) in
                           enumerate(zip(tree_leaves(kernel[k]), tree_leaves(plain[k])))):
            if not torch.equal(a, b):
                raise AssertionError(f"adamw step {step}: {name} differs from the plain path "
                                     f"in {int((a != b).sum())} elements")
    launches = ops.launch_counts()["adamw"]
    if launches != steps:
        raise AssertionError(f"adamw launches {launches}, expected {steps}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    times = {impl: _time_ms(lambda w=w: w.apply_update(grad, step=steps), flush, reps=10)
             for impl, w in workers.items()}
    # bytes bound it (~15 flops a parameter): gradient, master, m, v read;
    # master, m, v and the bf16 param written
    nbytes = 30.0 * n
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"params": n, "replicas": spec["d"], "steps_bit_equal": steps, "launches": launches,
           "kernel_ms": times["kernel"], "plain_ms": times["plain"], "bound_ms": bound,
           "bound": "bytes", "share_of_bound": bound / times["kernel"],
           "kernel_gb_per_s": nbytes / times["kernel"] / 1e6,
           "plain_over_kernel": times["plain"] / times["kernel"]}
    del workers, flush, grad
    torch.cuda.empty_cache()
    emit({"phase": "adamw", "card": smi, "seconds": time.perf_counter() - t0, **rec})
    return rec


def manual_serve_plan(model: str, *, cuts, batch: int, prefill_tokens: int,
                      new_tokens: int, platform: str = "aws",
                      mem_index: int = -1) -> DeploymentPlan:
    """A hand-built ``workload="serve"`` plan: period-aligned stage cuts at
    profile layers ``cuts`` and one memory option for every layer."""
    plat = get_platform(platform)
    cfg = arch_config_for_model(model)
    profile = resolve_profile(model, plat, seq=prefill_tokens, micro_batch=batch)
    x = [0] * (profile.L - 1)
    for c in cuts:
        x[c] = 1
    z = (mem_index % len(plat.memory_options),) * profile.L
    spec = ServingSpec(slo_s=3600.0, batch=batch, prefill_tokens=prefill_tokens,
                       new_tokens=new_tokens)
    est = estimate_serving(profile, plat, Config(x=tuple(x), d=1, z=z), cfg, spec)
    return DeploymentPlan(
        model=model, platform=plat.name, x=tuple(x), z=z, d=1,
        total_micro_batches=1, alpha=(1.0, 0.0), pipelined_sync=False,
        merge_to=None, seq=prefill_tokens, micro_batch=batch,
        profile_fingerprint=profile_fingerprint(profile, plat),
        t_iter=est.t_request, c_iter=est.cost_per_request,
        objective=est.cost_per_request, solver="manual", engine="-",
        solve_seconds=0.0, workload="serve",
        serving={**spec.as_dict(), "t_prefill": est.t_prefill,
                 "t_token": est.t_token, "t_request": est.t_request,
                 "cost_per_request": est.cost_per_request,
                 "cost_per_1k": est.cost_per_1k,
                 "kv_bytes": list(est.kv_bytes)})


@contextlib.contextmanager
def routed(fn):
    """Route the model's decode-attention calls through ``fn`` in the block
    (``models.attention`` looks ``ops.decode_attention`` up at each call)."""
    real = ops.decode_attention
    ops.decode_attention = fn
    try:
        yield
    finally:
        ops.decode_attention = real


def attention_fp64(q, k_cache, v_cache, length, **_):
    """The plain version's arithmetic in float64: a second correct rounding,
    which measures how far bf16 noise alone moves the logits."""
    B, Hq, hd = q.shape
    Hkv, C = k_cache.shape[1], k_cache.shape[2]
    qg = (q.double() * hd**-0.5).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhcd->bhgc", qg, k_cache.double())
    s = torch.where(torch.arange(C, device=q.device) < length.reshape(-1)[0], s, -1e30)
    o = torch.einsum("bhgc,bhcd->bhgd", torch.softmax(s, dim=-1), v_cache.double())
    return o.reshape(B, Hq, hd).to(q.dtype)


def teacher_forced(cfg, params, prompt, tokens, *, s_ctx, call_tol, logit_tol=None,
                   image_embeds=None):
    """Feed the decode loop ``tokens``.  Every decode-attention call of the
    kernel loop is held against the plain version (``impl="ref"``) on the
    same inputs at ``call_tol``; every step is also rerun from the same
    caches with the plain version and with a float64 attention, and the
    step logits compared (held at ``logit_tol`` when given).  A vision
    model's prefill takes ``image_embeds`` too."""
    dev = params["embed"].device
    toks = torch.from_numpy(tokens).to(dev)
    batch = {"tokens": torch.from_numpy(prompt).to(dev)}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    _, caches = registry.prefill(cfg, params, batch, capacity=s_ctx)
    kernel = ops.decode_attention
    rec = {"calls": 0, "call_max_abs_err": 0.0, "calls_ok": True, "step_kernel_vs_ref": [],
           "step_ref_vs_fp64": [], "step_kernel_vs_fp64": [], "logits_ok": True,
           "logits_abs_max": 0.0}

    def checked(q, k, v, length, **_):
        out = kernel(q, k, v, length)
        ref = kernel(q, k, v, length, impl="ref")
        rec["calls"] += 1
        rec["call_max_abs_err"] = max(rec["call_max_abs_err"],
                                      float((out.float() - ref.float()).abs().max()))
        rec["calls_ok"] &= bool(torch.allclose(out.float(), ref.float(),
                                               rtol=call_tol, atol=call_tol))
        return out

    def step(fn, c, tok):
        with routed(fn):
            return registry.decode_step(cfg, params, c, tok, use_kernels=True)[0].float()

    for t in range(1, tokens.shape[1]):
        tok = toks[:, t - 1:t]
        ref = step(lambda q, k, v, n, **_: kernel(q, k, v, n, impl="ref"),
                   tree_map(torch.clone, caches), tok)
        f64 = step(attention_fp64, tree_map(torch.clone, caches), tok)
        got = step(checked, caches, tok)
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite logits on the kernel path at step {t}")
        rec["step_kernel_vs_ref"].append(float((got - ref).abs().max()))
        rec["step_ref_vs_fp64"].append(float((ref - f64).abs().max()))
        rec["step_kernel_vs_fp64"].append(float((got - f64).abs().max()))
        rec["logits_abs_max"] = max(rec["logits_abs_max"], float(got.abs().max()))
        if logit_tol is not None:
            rec["logits_ok"] &= bool(torch.allclose(got, ref, rtol=logit_tol, atol=logit_tol))
    n_attn = n_layers_of(cfg, mixer=ATTN)
    if rec["calls"] != (tokens.shape[1] - 1) * n_attn:
        raise AssertionError(f"{rec['calls']} decode-attention calls, expected "
                             f"{(tokens.shape[1] - 1) * n_attn}")
    if not (rec["calls_ok"] and rec["logits_ok"]):
        raise AssertionError(f"kernel path disagrees with impl='ref': {rec}")
    return rec


def profile_decode(cfg, params, prompt, tokens, *, s_ctx, steps=2, split=False) -> dict:
    """Where a decode round's time goes: ``torch.profiler`` over ``steps``
    monolithic decode steps (the stage workers make the same per-layer
    calls), after one warm-up step; ``split`` adds the MoE and Mamba steps'
    device time (:func:`device_split`)."""
    from torch.profiler import ProfilerActivity, profile

    dev = params["embed"].device
    toks = torch.from_numpy(tokens).to(dev)
    _, caches = registry.prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt).to(dev)}, capacity=s_ctx)
    registry.decode_step(cfg, params, caches, toks[:, :1], use_kernels=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with family_regions() if split else contextlib.nullcontext():
            for t in range(1, steps + 1):
                registry.decode_step(cfg, params, caches, toks[:, t:t + 1], use_kernels=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _profile_summary(prof, wall, steps, split=split)


def _profile_summary(prof, wall: float, steps: int, split: bool = False) -> dict:
    """Device busy and idle share, the top kernels and host ops per step
    (with ``split``, also :func:`device_split`'s)."""
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device events, less the ranges family_regions() marks on the device
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in region_labels()]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    # the port's kernels by source (every kernel whose name holds the word)
    # and one by one
    words = ("flash", "swiglu", "decode_attention")
    by_source = {word: sum(dev_us(e) for e in kernels if word in e.key) / 1e3 / steps
                 for word in words}
    port = {}
    for e in kernels:
        name = re.search(r"(\w+_kernel)", e.key)
        if name and any(word in e.key for word in words):
            key = name.group(1)
            ms, n = port.get(key, (0.0, 0))
            port[key] = (ms + dev_us(e) / 1e3 / steps, n + e.count // steps)
    wall_ms = wall * 1e3 / steps
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    host = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "port_kernels_ms_per_step": by_source,
            "port_kernels_ms_launches_per_step": port,
            "top_kernels_ms_per_step": [[e.key[:80], dev_us(e) / 1e3 / steps, e.count // steps]
                                        for e in top],
            "top_host_ops_ms_per_step": [[e.key[:60], e.self_cpu_time_total / 1e3 / steps,
                                          e.count // steps] for e in host],
            **({"device_ms_split_per_step": device_split(prof, steps)} if split else {})}


def phase_serve_full(smi: str) -> int:
    torch.use_deterministic_algorithms(True)
    model = "phi3-mini-3.8b"
    cfg = arch_config_for_model(model)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    plan = manual_serve_plan(model, cuts=SERVE_CUTS, **SERVE)
    prompt = make_prompt(cfg, SERVE["batch"], SERVE["prefill_tokens"], seed=0)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_serve_plan(plan, params=params, prompt=prompt, use_kernels=True)
    launches = ops.launch_counts()["decode_attention"]
    expect = (SERVE["new_tokens"] - 1) * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected (new_tokens - 1) x n_layers = {expect}")
    peak = torch.cuda.max_memory_allocated()

    mono = reference_decode(cfg, params, prompt, SERVE["new_tokens"], use_kernels=True)
    if not np.array_equal(res.tokens, mono):
        raise AssertionError(f"pipelined tokens differ from the monolithic loop:\n"
                             f"{res.tokens}\n{mono}")
    s_ctx = SERVE["prefill_tokens"] + SERVE["new_tokens"]
    tf_bf16 = teacher_forced(cfg, params, prompt, res.tokens, s_ctx=s_ctx, call_tol=2e-2)
    prof = profile_decode(cfg, params, prompt, res.tokens, s_ctx=s_ctx)
    # the same model in fp32: the logits of the kernel path hold at 2e-4
    params = tree_map(lambda a: a.float(), params)
    torch.cuda.empty_cache()
    tf_fp32 = teacher_forced(dataclasses.replace(cfg, param_dtype="float32"), params,
                             prompt, res.tokens[:, :FP32_STEPS], s_ctx=s_ctx, call_tol=2e-5,
                             logit_tol=2e-4)
    emit({"phase": "serve_full", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "stages": plan.n_stages, **SERVE,
          "s_ctx": s_ctx,
          "kernel_launches": launches, "tokens_match_monolithic": True,
          "teacher_forced_bf16": tf_bf16, "teacher_forced_fp32": tf_fp32,
          "decode_profile": prof,
          "store_drained": True,
          "store": res.store_stats.as_dict(),
          "t_request_virtual_s": res.t_request,
          "param_init_s": t_init,
          "prefill_wall_s": res.round_wall_s[0],
          "decode_round_wall_s": list(res.round_wall_s[1:]),
          "decode_round_wall_s_median": statistics.median(res.round_wall_s[1:]),
          "max_memory_allocated_bytes": peak,
          "tokens_head": res.tokens[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches, res.tokens


def phase_serve_reduced(smi: str) -> None:
    model = "phi3-mini-3.8b@reduced"
    cfg = arch_config_for_model(model)
    plan = manual_serve_plan(model, cuts=(1,), **REDUCED)
    ops.reset_launch_counts()
    with_kernel = run_serve_plan(plan, seed=0, use_kernels=True)
    launches = ops.launch_counts()["decode_attention"]
    plain = run_serve_plan(plan, seed=0, use_kernels=False)
    expect = (REDUCED["new_tokens"] - 1) * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"reduced serve launched {launches}, expected {expect}")
    if not np.array_equal(with_kernel.tokens, plain.tokens):
        raise AssertionError(f"kernel and plain tokens differ:\n{with_kernel.tokens}\n"
                             f"{plain.tokens}")
    emit({"phase": "serve_reduced", "card": smi, "model": model,
          "dtype": cfg.param_dtype, "stages": plan.n_stages, **REDUCED,
          "kernel_launches": launches, "tokens_match_plain": True,
          "t_request_virtual_s": with_kernel.t_request})


# ---------------------------------------------------------- process backends
def _mount_of(path: Path) -> tuple:
    """(mount point, filesystem type) that holds ``path``, from /proc/mounts."""
    real, best = str(path.resolve()), ("/", "?")
    for line in Path("/proc/mounts").read_text().splitlines():
        _dev, mnt, fs = line.split()[:3]
        if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[0]):
            best = (mnt, fs)
    return best


def store_root(need_bytes: float) -> dict:
    """Where a process backend's file store lives: of the run's temporary
    directory and the checkout's ``build/`` (the run writes nowhere else), a
    tmpfs with room for ``need_bytes`` twice over, else the one with the
    most room.  Printed with its filesystem and ``shutil.disk_usage`` before
    the phase that uses it."""
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    options = []
    for base in (Path(tempfile.gettempdir()), build):
        mnt, fs = _mount_of(base)
        usage = shutil.disk_usage(base)
        options.append((fs == "tmpfs" and usage.free >= 2 * need_bytes, usage.free, base, fs,
                        mnt, usage))
    tmpfs_ok, free, base, fs, mnt, usage = max(options, key=lambda o: o[:2])
    if free < need_bytes:
        raise RuntimeError(f"no room for the file store: {need_bytes:.3g} bytes needed, "
                           f"{[(str(o[2]), o[1]) for o in options]} free")
    doc = {"root": tempfile.mkdtemp(prefix="funcpipe-store-", dir=base), "fs": fs,
           "mount": mnt, "tmpfs": fs == "tmpfs", "need_bytes": need_bytes,
           "disk_usage": {"total": usage.total, "used": usage.used, "free": usage.free}}
    emit({"store_root": doc})
    return doc


TRACE_DIR = Path(__file__).resolve().parent / "chiprun_out" / "traces"


def trace_summary(trace, name: str) -> dict:
    """Check a traced run's spans and reduce them to what the smoke line
    prints: the span count, per stage the compute, bubble, upload and
    download fractions of ``pipeline_health``, per worker the busy seconds
    of each phase/op in each step (``step`` = the span's), each step's span
    window (first start, last end) beside its ``step_ends`` entry (time
    after a step's last span is in no span: the update, the replies), the
    straggler ratio, and where the Chrome trace was saved (``Trace.save``).  Raises
    unless the trace validates, covers every worker of its S x d grid and
    its span bytes reconcile with ``StoreStats`` (1e-6 relative)."""
    validate_trace(trace)
    meta = trace.meta
    workers = {f"s{s}r{r}" for s in range(meta["S"]) for r in range(meta["d"])}
    if {sp.worker for sp in trace.spans} != workers:
        raise AssertionError(f"{name}: spans of {sorted({sp.worker for sp in trace.spans})}, "
                             f"expected {sorted(workers)}")
    health = pipeline_health(trace)
    if not health["reconciliation"]["ok"]:
        raise AssertionError(f"{name}: span bytes do not reconcile: {health['reconciliation']}")
    busy: dict = {}
    for sp in trace.spans:
        steps = busy.setdefault(sp.worker, [dict() for _ in range(meta["steps"])])
        cell = f"{sp.phase}/{sp.op}"
        steps[sp.step][cell] = steps[sp.step].get(cell, 0.0) + sp.duration
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    trace.save(path)
    windows = [[min(sp.start for sp in trace.spans if sp.step == k),
                max(sp.end for sp in trace.spans if sp.step == k)] for k in range(meta["steps"])]
    return {"spans": len(trace.spans), "clock": meta["clock"], "path": str(path),
            "t_total": meta["t_total"], "step_ends": meta.get("step_ends"),
            "step_span_windows": windows,
            "stages": [{k: row[k] for k in ("stage", "compute_frac", "bubble_frac", "up_frac",
                                            "dn_frac")} for row in health["stages"]],
            "straggler_ratio": health["straggler_ratio"],
            "busy_s_by_worker_step": {w: busy[w] for w in sorted(busy)},
            "reconciliation": health["reconciliation"]}


def device_profiler():
    """A ``torch.profiler`` that records the card's kernels only (every
    stream), for :func:`device_busy`."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_busy(prof) -> dict:
    """The device work a profiler window saw: its kernels' summed durations
    and the union of their intervals (kernels of concurrent streams
    overlap, so the union is the time the card was busy), in seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    union, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            union += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    union += 0.0 if hi is None else hi - lo
    return {"kernels": len(spans), "kernel_sum_s": sum(b - a for a, b in spans) / 1e6,
            "kernel_union_s": union / 1e6}


def compute_vs_device(trace, busy: dict, step: int) -> dict:
    """Each worker's compute spans in ``step``: their device seconds (the
    spans' device intervals) and launch seconds (their host intervals), the
    sums and the union of the device intervals, beside the device work of
    that step (from the step's start to the run's end: the step's stage
    math, its update and ``assemble_params``'s copies)."""
    device: dict = {}
    launch: dict = {}
    intervals = []
    for sp in trace.spans:
        if sp.step == step and sp.op == "compute" and sp.device_start is not None:
            device[sp.worker] = device.get(sp.worker, 0.0) + sp.device_duration
            launch[sp.worker] = launch.get(sp.worker, 0.0) + sp.duration
            intervals.append((sp.device_start, sp.device_end))
    union, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            union += b - a
            hi = b
        elif b > hi:
            union += b - hi
            hi = b
    total = sum(device.values())
    return {"compute_device_s_by_worker": dict(sorted(device.items())),
            "compute_launch_s_by_worker": dict(sorted(launch.items())),
            "compute_device_s_sum": total, "compute_device_union_s": union,
            "device": busy, "compute_device_union_over_device_union":
            union / busy["kernel_union_s"] if busy["kernel_union_s"] else None}


def phase_train_backends(smi: str) -> dict:
    """``train_full``'s plan (phi3-mini-3.8b, full width, 4 layers, bf16,
    seed 0, 2 stages x 2 replicas, 2 micro-batches of 2 x 1024 tokens,
    AdamW(1e-4), 2 steps, ``use_kernels=True``) on the emulated backend, on
    ``local`` (worker threads) with eq (2) and eq (1), and on ``process``
    (spawned worker processes over a file store) with eq (2), each untraced
    and then traced (``trace=True``).  Each run's losses equal the untraced
    emulated run's and every param is bit-identical to it; each step
    launches the wgmma kernels exactly as ``train_full`` does (on
    ``process`` the children report their launches and the parent sums
    them); the store drains, and its puts, gets and modeled bytes equal the
    emulated run's.  An untraced run carries no trace; a traced one must
    validate, cover all S x d workers and reconcile its span bytes, and on
    ``emulated`` each step's last span ends at its ``step_ends`` entry.
    Step wall times traced and untraced, each traced run's split of the
    step by worker and phase/op, each child's peak memory and the store
    roots are printed; the traces are saved under ``chiprun_out/traces``."""
    from repro_torch.serverless.backends import ProcessBackend

    spec = TRAIN
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    prof, plat, config, M = train_setup(cfg, spec)
    d, mu, steps = spec["d"], spec["mu"], spec["steps"]
    batches = train_batches(cfg, spec, d, steps)
    expect = _expected_launches(d * mu * cfg.n_layers, "wgmma", "wgmma", adamw=_workers(config))
    # a step's sync objects: every stage's fp32 gradient, a part and a
    # reduced chunk per replica
    grad_bytes = 4.0 * sum(a.numel() for a in tree_leaves(params))
    roots = []
    runs = {}
    for name, backend, pipelined in (
            ("emulated", "emulated", True), ("local_eq2", "local", True),
            ("local_eq1", "local", False), ("process_eq2", "process", True)):
        for traced in (False, True):
            run_name = f"{name}_traced" if traced else name
            if backend == "process":     # a fresh store (and its counters) a run
                roots.append(store_root(2 * grad_bytes))
                be = ProcessBackend(root=roots[-1]["root"])
            else:
                be = backend
            marks, counts = [], []
            # a traced local run's step 1 is profiled: the device work its
            # compute spans are read against
            profiled = {} if traced and backend == "local" else None

            def batch_fn(k):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                counts.append(ops.launch_counts())
                if profiled is not None and k == 1:
                    profiled["prof"] = device_profiler()
                    profiled["prof"].start()
                return batches[k]

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            res = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=pipelined,
                           backend=be, trace=traced,
                           execution=Execution(cfg=cfg, optimizer=AdamW(lr=1e-4),
                                               init_params=params, batch_fn=batch_fn,
                                               use_kernels=True, device="cuda"))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            counts.append(ops.launch_counts())
            if profiled is not None:
                profiled["prof"].stop()
            rec = {"backend": res.backend, "wall_clock": res.wall_clock, "traced": traced,
                   "pipelined_sync": pipelined, "losses": res.losses,
                   "step_wall_s": [b - a for a, b in zip(marks, marks[1:])],
                   "t_total_s": res.t_total, "breakdown": res.breakdown,
                   "store": res.store_stats.as_dict(),
                   "parent_max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            if isinstance(be, ProcessBackend):
                reports = be.reports[:steps]
                rec["launches_per_step"] = [
                    {k: sum(w["launches"][k] for w in step.values()) for k in expect}
                    for step in reports]
                rec["child_max_memory_allocated_bytes"] = {
                    f"s{s}r{r}": w["max_memory_allocated"] for (s, r), w in reports[-1].items()}
                rec["store_root"] = roots[-1]["root"]
                if any(counts[-1][k] for k in expect):
                    raise AssertionError(f"the parent launched kernels itself: {counts[-1]}")
            else:
                rec["launches_per_step"] = [{k: b[k] - a[k] for k in a}
                                            for a, b in zip(counts, counts[1:])]
            if any(c != expect for c in rec["launches_per_step"]) or \
                    len(rec["launches_per_step"]) != steps:
                raise AssertionError(f"{run_name}: launches per step "
                                     f"{rec['launches_per_step']}, expected {expect} in each "
                                     f"of {steps}")
            if not all(np.isfinite(res.losses)):
                raise AssertionError(f"{run_name}: non-finite losses {res.losses}")
            if not traced and res.trace is not None:
                raise AssertionError(f"{run_name}: an untraced run returned a trace")
            if traced:
                rec["trace"] = trace_summary(res.trace, f"train_backends_{run_name}")
            if profiled is not None:
                rec["step1_compute_vs_device"] = compute_vs_device(
                    res.trace, device_busy(profiled.pop("prof")), step=1)
                if backend == "emulated":
                    ends = [max(sp.end for sp in res.trace.spans if sp.step == k)
                            for k in range(steps)]
                    if ends != res.trace.meta["step_ends"]:
                        raise AssertionError(f"{run_name}: last span ends {ends} != "
                                             f"step_ends {res.trace.meta['step_ends']}")
            runs[run_name] = (rec, tree_map(lambda a: a.cpu(), res.params))
            del res
            torch.cuda.empty_cache()
    ref, ref_params = runs["emulated"]
    st0 = ref["store"]
    for name, (rec, got) in runs.items():
        if rec["losses"] != ref["losses"]:
            raise AssertionError(f"{name}: losses {rec['losses']} != emulated {ref['losses']}")
        same = [bool(torch.equal(a, b)) for a, b in zip(tree_leaves(got), tree_leaves(ref_params))]
        if not all(same):
            raise AssertionError(f"{name}: {same.count(False)} of {len(same)} params differ "
                                 "from the emulated run's")
        st = rec["store"]
        if (st["puts"], st["gets"], st["deletes"]) != (st0["puts"], st0["gets"], st0["deletes"]) \
                or abs(st["bytes_in"] - st0["bytes_in"]) > 1e-9 * st0["bytes_in"] \
                or abs(st["bytes_out"] - st0["bytes_out"]) > 1e-9 * st0["bytes_out"]:
            raise AssertionError(f"{name}: store traffic {st} != emulated {st0}")
        rec["params_bit_identical_to_emulated"] = True
    launches = {k: sum(step[k] for rec, _ in runs.values() for step in rec["launches_per_step"])
                for k in expect}
    overhead = {name: {"untraced_step_wall_s": runs[name][0]["step_wall_s"],
                       "traced_step_wall_s": runs[f"{name}_traced"][0]["step_wall_s"]}
                for name in ("emulated", "local_eq2", "local_eq1", "process_eq2")}
    emit({"phase": "train_backends", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "stages": 2, "d": d, "mu": mu,
          "micro_batch": spec["micro_batch"], "seq": spec["seq"], "steps": steps,
          "optimizer": "AdamW(lr=1e-4)", "store_roots": roots,
          "runs": {name: rec for name, (rec, _) in runs.items()},
          "tracing_overhead": overhead, "traces_validated": True,
          "store_drained": True, "kernel_launches": launches})
    for root in roots:
        shutil.rmtree(root["root"])
    del params, batches, runs
    torch.cuda.empty_cache()
    return launches


def phase_serve_process(smi: str, tokens: np.ndarray) -> int:
    """``serve_full``'s request (phi3-mini-3.8b at full width and depth, 32
    layers, bf16, seed 0, batch 4, 1008 + 16 tokens, 4 stages of 8 layers)
    through ``run_serve_plan(..., backend="process", use_kernels=True,
    trace=True)``: every stage a spawned worker process, each KV cache
    through a file every round.  Tokens bit-identical to ``serve_full``'s
    emulated run, which equal the monolithic ``reference_decode``; the
    children count (16 - 1) x 32 decode-attention launches; the store
    drains; the trace validates, has exactly the phases prefill and decode
    and reconciles its span bytes.  Request wall time, payload-true bytes,
    each child's peak memory and each stage's compute, upload and download
    seconds in prefill and in decode are printed; the trace is saved under
    ``chiprun_out/traces``."""
    torch.use_deterministic_algorithms(True)
    model = "phi3-mini-3.8b"
    cfg = arch_config_for_model(model)
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    plan = manual_serve_plan(model, cuts=SERVE_CUTS, **SERVE)
    prompt = make_prompt(cfg, SERVE["batch"], SERVE["prefill_tokens"], seed=0)
    rp = plan.resolve()
    kv = sum(estimate_serving(rp.profile, rp.platform, rp.config, cfg,
                              ServingSpec(slo_s=3600.0, **SERVE)).kv_bytes)
    root = store_root(2 * kv)
    ops.reset_launch_counts()
    res = run_serve_plan(plan, backend="process", params=params, prompt=prompt,
                         use_kernels=True, root=root["root"], trace=True)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the parent launched kernels itself: {ops.launch_counts()}")
    launches = sum(w["launches"]["decode_attention"] for w in res.worker_reports)
    expect = (SERVE["new_tokens"] - 1) * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"the stage processes launched decode_attention {launches} "
                             f"times, expected (new_tokens - 1) x n_layers = {expect}")
    if not np.array_equal(res.tokens, tokens):
        raise AssertionError(f"process tokens differ from the emulated run's "
                             f"(= reference_decode's):\n{res.tokens}\n{tokens}")
    phases = {sp.phase for sp in res.trace.spans}
    if phases != {"prefill", "decode"}:
        raise AssertionError(f"serve trace phases {sorted(phases)}, expected prefill and decode")
    summary = trace_summary(res.trace, "serve_process")
    # by key class too: the KV caches ("kv") apart from the boundaries and
    # tokens ("act", "other")
    by_stage = [{phase: {} for phase in ("prefill", "decode")} for _ in range(plan.n_stages)]
    for sp in res.trace.spans:
        cell = by_stage[sp.stage][sp.phase]
        if sp.op == "compute":
            cell["compute"] = cell.get("compute", 0.0) + sp.duration
        else:
            by_key = cell.setdefault(sp.op, {})
            cls = classify_key(sp.key)
            by_key[cls] = by_key.get(cls, 0.0) + sp.duration
    emit({"phase": "serve_process", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "stages": plan.n_stages, **SERVE,
          "kernel_launches": launches, "tokens_match_emulated_and_monolithic": True,
          "store_drained": True, "store_root": root, "payload_true": True,
          "store": res.store_stats.as_dict(), "request_wall_s": res.t_request,
          "child_max_memory_allocated_bytes": [w["max_memory_allocated"]
                                               for w in res.worker_reports],
          "trace": {k: v for k, v in summary.items() if k != "busy_s_by_worker_step"},
          "seconds_by_stage_phase_op": by_stage, "tokens_head": res.tokens[0].tolist()})
    shutil.rmtree(root["root"])
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- training
def train_setup(cfg, spec: dict, d=None):
    """The training plan of a phase: ``arch_model_profile`` at the phase's
    sequence and micro-batch, cut after profile layer ``cut`` (embed and the
    first layers on stage 0, the rest and the head on stage 1)."""
    plat = get_platform("aws")
    prof = arch_model_profile(cfg, plat, seq=spec["seq"], micro_batch=spec["micro_batch"])
    x = tuple(1 if i == spec["cut"] else 0 for i in range(prof.L - 1))
    d = spec["d"] if d is None else d
    return prof, plat, Config(x=x, d=d, z=(0,) * prof.L), d * spec["mu"]


def train_batches(cfg, spec: dict, d: int, steps: int) -> list:
    """Global batches of d x mu micro-batches, made from seed 0 on the host
    and moved to the card once."""
    shape = InputShape("train", spec["seq"], d * spec["mu"] * spec["micro_batch"], "train")
    return [{k: v.cuda() for k, v in make_batch(cfg, shape, seed=0, step=k,
                                                device="cpu").items()}
            for k in range(steps)]


class TrackedWorker(worker_mod.StageWorker):
    """A StageWorker that records itself, so the smoke run can compare the
    replicas of each stage between steps."""

    instances: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        TrackedWorker.instances.append(self)


@contextlib.contextmanager
def tracked_workers():
    real = worker_mod.StageWorker
    TrackedWorker.instances = []
    worker_mod.StageWorker = TrackedWorker
    try:
        yield TrackedWorker.instances
    finally:
        worker_mod.StageWorker = real
        # emptied, not only dropped: a run's batch_fn closes over the list,
        # and its workers' states (train_moe's are ~50 GB) must not outlive
        # the run while the execution lives on for the next one
        TrackedWorker.instances.clear()
        TrackedWorker.instances = []


def replicas_identical(workers) -> bool:
    by_stage: dict = {}
    for w in workers:
        by_stage.setdefault(w.span.index, []).append(w)
    for ws in by_stage.values():
        ref = tree_leaves(ws[0].export_state())
        for w in ws[1:]:
            if not all(torch.equal(a, b) for a, b in zip(ref, tree_leaves(w.export_state()))):
                return False
    return True


class CallChecker:
    """Routes ``ops.flash_attention`` and ``ops.swiglu`` (or those of
    ``names``) through checks for one step: each call launches the kernel as
    the model asked, and its output is held against ``impl="ref"`` on the
    same inputs; hooks on the output and on the inputs hold the kernel's
    gradients against autograd of the plain version for the cotangent that
    arrives.  Bars by dtype: bf16 2e-2 (outputs) and 2e-2 x max|ref|
    (gradients), fp32 2e-5 and 1e-4.  Flash calls are also counted by
    window and by ``causal``."""

    def __init__(self, names=("flash_attention", "swiglu")):
        self.names = names
        self.windows: dict = {}
        self.causal: dict = {}
        self.real = {"flash_attention": ops.flash_attention, "swiglu": ops.swiglu}
        self.calls = {"flash_attention": 0, "swiglu": 0}
        self.grads = {"flash_attention": 0, "swiglu": 0}
        self.out_err = {"flash_attention": 0.0, "swiglu": 0.0}
        self.grad_err = {"flash_attention": 0.0, "swiglu": 0.0}
        self.failures: list = []

    def _check(self, name, plain, inputs, out):
        ref = plain(*(t.detach() for t in inputs))
        err = float((out.detach().float() - ref.float()).abs().max())
        fp32 = out.dtype == torch.float32
        self.calls[name] += 1
        self.out_err[name] = max(self.out_err[name], err)
        tol = 2e-5 if fp32 else 2e-2
        if not torch.allclose(out.detach().float(), ref.float(), rtol=tol, atol=tol):
            self.failures.append(f"{name} output, max |err| {err}")
        if not out.requires_grad:
            return
        frozen = [t.detach() for t in inputs]
        refs = {}

        def on_dout(dout):
            ts = [t.clone().requires_grad_() for t in frozen]
            with torch.enable_grad():
                refs["grads"] = torch.autograd.grad(plain(*ts), ts, dout)

        def on_grad(g, i):
            r = refs["grads"][i]
            err = float((g.float() - r.float()).abs().max())
            self.grads[name] += 1
            self.grad_err[name] = max(self.grad_err[name], err)
            ok = torch.allclose(g, r, rtol=1e-4, atol=1e-4) if fp32 else \
                err <= 2e-2 * float(r.float().abs().max())
            if not ok:
                self.failures.append(f"{name} gradient {i}, max |err| {err}")

        out.register_hook(on_dout)
        for i, t in enumerate(inputs):
            if t.requires_grad:
                t.register_hook(lambda g, i=i: on_grad(g, i))

    def flash_attention(self, q, k, v, *, causal=True, window=0, impl="auto"):
        real = self.real["flash_attention"]
        self.windows[window] = self.windows.get(window, 0) + 1
        self.causal[causal] = self.causal.get(causal, 0) + 1
        out = real(q, k, v, causal=causal, window=window, impl=impl)
        self._check("flash_attention",
                    lambda a, b, c: real(a, b, c, causal=causal, window=window, impl="ref"),
                    (q, k, v), out)
        return out

    def swiglu(self, x, w_gate, w_up, *, impl="auto"):
        real = self.real["swiglu"]
        out = real(x, w_gate, w_up, impl=impl)
        self._check("swiglu", lambda a, b, c: real(a, b, c, impl="ref"),
                    (x, w_gate, w_up), out)
        return out

    def install(self):
        for name in self.names:
            setattr(ops, name, getattr(self, name))

    def remove(self):
        for name in self.names:
            setattr(ops, name, self.real[name])


def phase_train_full(smi: str) -> dict:
    spec = TRAIN
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    d, mu, steps = spec["d"], spec["mu"], spec["steps"]
    per_step = d * mu * cfg.n_layers
    checker = CallChecker()
    run = _tracked_training(cfg, spec, params, AdamW(lr=1e-4), checker=checker)
    res, launches, step_counts = run.pop("res"), run["launches"], run["launches_per_step"]
    prof, plat, config, M = run["plan"]
    batches = run["batches"]
    expect = _expected_launches(per_step, "wgmma", "wgmma", adamw=_workers(config))
    if any(c != expect for c in step_counts):
        raise AssertionError(f"launches per step {step_counts}, expected {expect}")
    if checker.failures:
        raise AssertionError(f"kernel calls disagree with impl='ref': {checker.failures[:5]}")
    want_calls = {"flash_attention": per_step, "swiglu": per_step}
    want_grads = {"flash_attention": 3 * per_step, "swiglu": 3 * per_step}
    if checker.calls != want_calls or checker.grads != want_grads:
        raise AssertionError(f"checked {checker.calls} calls and {checker.grads} gradients, "
                             f"expected {want_calls} and {want_grads}")
    timing = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=True)
    same = (timing.t_iter == res.t_iter and timing.t_total == res.t_total
            and timing.cost == res.cost
            and timing.store_stats.as_dict() == res.store_stats.as_dict())
    if not same:
        raise AssertionError(f"numeric run's clock {res.t_iter} / {res.cost} differs from the "
                             f"timing-only run's {timing.t_iter} / {timing.cost}")
    losses, store, t_iter = res.losses, res.store_stats.as_dict(), res.t_iter
    del res, timing
    # the same two steps on the plain path: the first loss (no update yet)
    # agrees at bf16's tolerance; the second shows what AdamW's first step
    # does at this width with either path
    plain = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=True,
                     execution=dataclasses.replace(run["execution"],
                                                   batch_fn=lambda k: batches[k],
                                                   use_kernels=False))
    losses_plain = plain.losses
    del plain
    if abs(losses[0] - losses_plain[0]) > 2e-2:
        raise AssertionError(f"first loss {losses[0]} on the kernel path, "
                             f"{losses_plain[0]} on the plain path")
    profile = profile_train_step(cfg, prof, plat, config, M, params, batches, AdamW(lr=1e-4))
    RESULTS["train_full_step_wall_s"] = run["step_wall_s"]
    RESULTS["train_full_losses"] = losses
    emit({"phase": "train_full", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "params": n_params,
          "stages": 2, "d": d, "mu": mu, "micro_batch": spec["micro_batch"],
          "seq": spec["seq"], "steps": steps, "optimizer": "AdamW(lr=1e-4)",
          "losses": losses, "losses_plain_path": losses_plain,
          "t_iter_virtual_s": t_iter, "store": store,
          "launches_per_step": step_counts, "kernel_launches": launches,
          "checked_calls": checker.calls, "checked_gradients": checker.grads,
          "call_max_abs_err": checker.out_err, "grad_max_abs_err": checker.grad_err,
          "replicas_bit_identical": [True] * steps, "store_drained": True,
          "clock_equals_timing_only": True, "step_wall_s": run["step_wall_s"],
          "max_memory_allocated_bytes": run["peak"], "train_profile": profile})
    del params, batches, run
    torch.cuda.empty_cache()
    return launches


def phase_train_planned(smi: str) -> dict:
    """The first plan the port's own planner solves, trained on the card.

    ``arch_model_profile`` of phi3-mini-3.8b at full width and
    ``train_full``'s depth (4 layers: L = 6 profile layers), sequence and
    micro-batch on ``aws``, solved by ``planner.solve`` (batch engine) with
    the paper's default weights, 4 micro-batches and d in (1, 2), and by
    ``planner.dp_solve``, which must be no worse.  The plan goes
    ``DeploymentPlan.from_result`` -> ``to_json`` -> ``from_json`` ->
    ``resolve`` (the profile passed in, since the model id alone rebuilds
    all 32 layers, and fingerprint-checked), is evaluated and simulated,
    then trained for 2 steps on ``emulated`` in bf16 with AdamW(1e-4) and
    the kernels.  Exact launches per step, all on the wgmma route;
    replicas bit-identical after each step; finite losses, the first
    within 2e-2 of the same plan with the kernels' plain versions; the
    emulated clock's ``t_iter`` within 5% of ``simulate_funcpipe``'s.
    Second-step wall time and peak memory."""
    spec = TRAIN_PLANNED
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    plat = get_platform("aws")
    prof = arch_model_profile(cfg, plat, seq=spec["seq"], micro_batch=spec["micro_batch"])
    M = spec["total_micro_batches"]
    kw = dict(alpha=DEFAULT_ALPHA, total_micro_batches=M, d_options=spec["d_options"])
    t0 = time.perf_counter()
    solved = planner.solve(prof, plat, **kw)
    t1 = time.perf_counter()
    dp = planner.dp_solve(prof, plat, **kw)
    t2 = time.perf_counter()
    if solved is None or dp is None:
        raise AssertionError(f"no feasible plan: batch {solved}, dp {dp}")
    if dp.objective > solved.objective * (1 + 1e-9):
        raise AssertionError(f"dp objective {dp.objective} worse than batch {solved.objective}")
    plan = DeploymentPlan.from_result(solved, platform=plat, alpha=DEFAULT_ALPHA,
                                      total_micro_batches=M, seq=spec["seq"],
                                      micro_batch=spec["micro_batch"])
    back = DeploymentPlan.from_json(plan.to_json())
    if back.to_json() != plan.to_json():
        raise AssertionError("plan JSON does not round-trip")
    rp = back.resolve(profile=prof)
    ev = back.evaluate(profile=prof)
    sim = back.simulate(profile=prof)
    d = rp.config.d
    mu = M // d
    run_spec = dict(spec, d=d, mu=mu)

    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    batches = train_batches(cfg, run_spec, d, spec["steps"])
    per_step = d * mu * cfg.n_layers
    marks, counts, replicas_ok = [], [], []

    def batch_fn(k):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
        if k > 0:
            replicas_ok.append(replicas_identical(workers))
        return batches[k]

    execution = Execution(cfg=cfg, optimizer=AdamW(lr=1e-4), init_params=params,
                          batch_fn=batch_fn, use_kernels=True, device="cuda")
    run_args = (rp.profile, rp.platform, rp.config, rp.total_micro_batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with tracked_workers() as workers:
        res = run_plan(*run_args, steps=spec["steps"], pipelined_sync=rp.pipelined_sync,
                       execution=execution)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
        replicas_ok.append(replicas_identical(workers))
    peak = torch.cuda.max_memory_allocated()
    launches = counts[-1]
    step_counts = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
    expect = _expected_launches(per_step, "wgmma", "wgmma", adamw=_workers(rp.config))
    if any(c != expect for c in step_counts) or len(step_counts) != spec["steps"]:
        raise AssertionError(f"launches per step {step_counts}, expected {expect}")
    if not all(replicas_ok) or len(replicas_ok) != spec["steps"]:
        raise AssertionError(f"replicas differ after a step: {replicas_ok}")
    if not all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    rel = abs(res.t_iter - sim.t_iter) / sim.t_iter
    if rel > 0.05:
        raise AssertionError(f"emulated t_iter {res.t_iter} is {rel:.2%} from the "
                             f"simulator's {sim.t_iter}")
    losses, t_iter = res.losses, res.t_iter
    del res
    with training_kernels_as_plain():
        plain = run_plan(*run_args, steps=1, pipelined_sync=rp.pipelined_sync,
                         execution=dataclasses.replace(execution,
                                                       batch_fn=lambda k: batches[k]))
    losses_plain = plain.losses
    del plain
    if abs(losses[0] - losses_plain[0]) > 2e-2:
        raise AssertionError(f"first loss {losses[0]} with the kernels, {losses_plain[0]} "
                             "with their plain versions")

    def described(r):
        return {"x": list(r.config.x), "d": r.config.d, "z": list(r.config.z),
                "objective": r.objective, "t_iter": r.evaluation.t_iter,
                "c_iter": r.evaluation.c_iter, "stats": dataclasses.asdict(r.stats)}

    emit({"phase": "train_planned", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "profile_L": prof.L,
          "seq": spec["seq"], "micro_batch": spec["micro_batch"], "platform": plat.name,
          "alpha": list(DEFAULT_ALPHA), "total_micro_batches": M,
          "d_options": list(spec["d_options"]),
          "plan_batch": described(solved), "plan_dp": described(dp),
          "solve_s": {"batch": t1 - t0, "dp": t2 - t1},
          "plan": back.describe(), "plan_hash": back.content_hash,
          "profile_fingerprint": back.profile_fingerprint,
          "evaluate": {"t_iter": ev.t_iter, "c_iter": ev.c_iter},
          "simulate": {"t_iter": sim.t_iter, "cost": sim.cost,
                       "breakdown": sim.breakdown},
          "stages": back.n_stages, "d": d, "mu": mu, "steps": spec["steps"],
          "optimizer": "AdamW(lr=1e-4)", "losses": losses,
          "losses_kernels_as_plain": losses_plain, "t_iter_emulated_s": t_iter,
          "t_iter_emulated_vs_simulated_rel_err": rel,
          "launches_per_step": step_counts, "kernel_launches": launches,
          "replicas_bit_identical": replicas_ok,
          "step_wall_s": [b - a for a, b in zip(marks, marks[1:])],
          "max_memory_allocated_bytes": peak})
    del params, batches
    torch.cuda.empty_cache()
    return launches


def _launches_by_route(counts: dict) -> dict:
    """The training kernels' launches of ``ops.launch_counts()``-shaped
    counts (each kernel and each of its routes, forward and backward)."""
    return {k: v for k, v in counts.items() if k.startswith(("flash_attention", "swiglu"))}


def _wgmma_only(counts: dict, what: str) -> None:
    """Every flash attention and swiglu launch took the wgmma route, and
    each kernel launched at least once."""
    for name in FP32_WAYS:
        for kind in (name, f"{name}_bwd"):
            if counts[kind] == 0 or counts[f"{kind}_wgmma"] != counts[kind]:
                raise AssertionError(f"{what}: {kind} launches {counts[kind]}, "
                                     f"on wgmma {counts[f'{kind}_wgmma']}")


def _chaos_tolerance():
    """``tests/test_faults.py:114-120``'s recovery policy: a 10 ms retry
    base, lifetime safety 0.9, a checkpoint after every step (the
    ``FaultTolerance`` default)."""
    from repro_torch.serverless import faults as F

    return F.FaultTolerance(retry=F.RetryPolicy(base_delay_s=0.01), lifetime_safety=0.9)


def _chaos_plan():
    """``tests/test_faults.py:76-86``'s schedule: a transient put (stage 0,
    replica 0, step 0), a transient get (stage 1, replica 1, step 1), a crash
    of stage 1, replica 0 in the backward of step 1, and a 2-step function
    lifetime."""
    from repro_torch.serverless import faults as F

    return F.FaultPlan(events=(
        F.FaultEvent(kind="transient", stage=0, replica=0, step=0, op="put", index=0),
        F.FaultEvent(kind="transient", stage=1, replica=1, step=1, op="get", index=1),
        F.FaultEvent(kind="crash", stage=1, replica=0, step=1, phase="bwd"),
    ), lifetime_steps=2, seed=None)


def _chaos_run(prof, plat, config, M, execution, backend, *, chaos: bool) -> dict:
    """One 3-step run (fault-free or through the chaos schedule) on the
    card: losses, step wall times (from batch_fn to batch_fn), the report,
    checkpoint bytes, peak memory, launches by route and the params on the
    host."""
    from repro_torch.serverless.backends import ProcessBackend
    from repro_torch.serverless.execution import ExecutionConfig

    marks = []

    def batch_fn(k):
        torch.cuda.synchronize()
        marks.append((k, time.perf_counter()))
        return execution.batch_fn(k)

    ec = ExecutionConfig(backend=backend, steps=CHAOS_STEPS,
                         faults=_chaos_plan() if chaos else None,
                         tolerance=_chaos_tolerance() if chaos else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_plan(prof, plat, config, M, ec, pipelined_sync=True,
                   execution=dataclasses.replace(execution, batch_fn=batch_fn))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    marks.append((None, t1))
    if isinstance(backend, ProcessBackend):
        counts = {k: sum(w["launches"][k] for rep in backend.reports for w in rep.values())
                  for k in ops.launch_counts()}
        child_peak = {f"s{s}r{r}": w["max_memory_allocated"]
                      for (s, r), w in backend.reports[-1].items()}
    else:
        counts, child_peak = ops.launch_counts(), None
    if not all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    st = res.store_stats
    rec = {"backend": res.backend, "losses": res.losses, "run_wall_s": t1 - t0,
           "step_wall_s": [(k, b - a) for (k, a), (_, b) in zip(marks, marks[1:])],
           "launches": _launches_by_route(counts),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "store": {"puts": st.puts, "bytes_in": st.bytes_in,
                     "class_bytes_in": dict(st.class_bytes_in)}}
    if child_peak is not None:
        rec["child_max_memory_allocated_bytes"] = child_peak
    if res.fault_report is not None:
        rec["fault_report"] = res.fault_report.as_dict()
        rec["checkpoint_bytes"] = st.class_bytes_in.get("ckpt", 0.0)
    return rec, tree_map(lambda a: a.cpu(), res.params)


def phase_train_chaos(smi: str) -> dict:
    """``train_full``'s plan for 3 steps through ``tests/test_faults.py``'s
    chaos schedule (a transient put, a transient get, a crash in a backward,
    a 2-step function lifetime) with its recovery policy (retry with a 10 ms
    base, a checkpoint into the object store after every step): phi3-mini-
    3.8b at full width, 4 layers, bf16, 2 stages x 2 replicas, 2 micro-
    batches of 2 x 1024 tokens, AdamW(1e-4), the kernels on.  On
    ``emulated`` and on ``local`` the recovered run lands on the same
    backend's fault-free 3-step run: every param bit-identical, the losses
    equal, with at least one retry, one restart, one planned restart and
    one checkpoint reported.  On ``process`` the same schedule at full width
    and a cut depth (1 layer a stage), where the crash SIGKILLs a child and
    the backend reaps and respawns it; its params bit-identical to the
    emulated fault-free run of that depth.  Every flash attention and swiglu
    launch on the wgmma route.  Printed: each run's report, checkpoint
    bytes, step wall times, run wall time, peak memory (the children's on
    ``process``), the device's free memory before and after, and launches
    by route."""
    from repro_torch.serverless.backends import ProcessBackend

    torch.use_deterministic_algorithms(True)
    plat = get_platform("aws")
    runs, launches = {}, {}
    t_phase = time.perf_counter()
    for depth, spec, backends in (
            ("full", TRAIN, ("emulated", "local")),
            ("cut", TRAIN_CHAOS_CUT, ("process",))):
        cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
        torch.cuda.empty_cache()
        params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                      device="cuda")
        prof, _, config, M = train_setup(cfg, spec)
        batches = train_batches(cfg, spec, spec["d"], CHAOS_STEPS)
        execution = Execution(cfg=cfg, optimizer=AdamW(lr=1e-4), init_params=params,
                              batch_fn=lambda k: batches[k], use_kernels=True, device="cuda")
        refs = {}
        for backend in backends:
            ref_backend = "emulated" if backend == "process" else backend
            if ref_backend not in refs:
                refs[ref_backend] = _chaos_run(prof, plat, config, M, execution, ref_backend,
                                               chaos=False)
            ref, ref_params = refs[ref_backend]
            free_before = torch.cuda.mem_get_info()[0]
            be = backend
            if backend == "process":
                root = store_root(8.0 * sum(a.numel() for a in tree_leaves(params)) * 2)
                be = ProcessBackend(root=root["root"])
            rec, got = _chaos_run(prof, plat, config, M, execution, be, chaos=True)
            if backend == "process":
                shutil.rmtree(root["root"])
            rec["device_free_bytes_before_after"] = [free_before, torch.cuda.mem_get_info()[0]]
            rep = rec["fault_report"]
            if not (rep["retries"] >= 1 and rep["restarts"] >= 1 and rep["planned_restarts"] >= 1
                    and rep["checkpoints"] >= 1 and rep["injected"].get("crash") == 1):
                raise AssertionError(f"{backend}: report {rep}")
            if rec["losses"] != ref["losses"]:
                raise AssertionError(f"{backend}: losses {rec['losses']} != fault-free "
                                     f"{ref['losses']}")
            same = [bool(torch.equal(a, b)) for a, b in zip(tree_leaves(got),
                                                            tree_leaves(ref_params))]
            if not all(same):
                raise AssertionError(f"{backend}: {same.count(False)} of {len(same)} params "
                                     "differ from the fault-free run's")
            _wgmma_only(rec["launches"], f"train_chaos {backend}")
            rec["params_bit_identical_to_fault_free"] = True
            rec["fault_free_run"] = f"{ref_backend}_{depth}"
            runs[f"{backend}_{depth}"] = rec
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
            del got
        for name, (ref, _) in refs.items():
            runs[f"{name}_{depth}_fault_free"] = ref
            for k, v in ref["launches"].items():
                launches[k] = launches.get(k, 0) + v
        del params, batches, refs, execution
        torch.cuda.empty_cache()
    emit({"phase": "train_chaos", "card": smi, "model": "phi3-mini-3.8b", "dtype": "bfloat16",
          "n_layers": {"full": TRAIN["n_layers"], "cut": TRAIN_CHAOS_CUT["n_layers"]},
          "stages": 2, "d": TRAIN["d"], "mu": TRAIN["mu"], "micro_batch": TRAIN["micro_batch"],
          "seq": TRAIN["seq"], "steps": CHAOS_STEPS, "optimizer": "AdamW(lr=1e-4)",
          "fault_plan": json.loads(_chaos_plan().to_json()),
          "tolerance": dataclasses.asdict(_chaos_tolerance()), "runs": runs,
          "kernel_launches": launches, "phase_wall_s": time.perf_counter() - t_phase})
    return launches


def phase_calibrate_replan(smi: str) -> dict:
    """Calibrate on the card, re-plan, and train the re-planned plan.

    ``train_full``'s plan (phi3-mini-3.8b, full width, 4 layers, bf16, 2
    stages x 2 replicas, M 4) runs 3 traced steps on ``process`` with
    ``payload_true`` (each child's compute spans wait for its own device
    work, and upload spans carry the real bf16 boundary bytes; no
    throttle).  ``calibrate_profile`` folds the trace (step 0 dropped, the
    wall clock's warm-up) into a measured profile: its scales, warnings and
    the max per-stage relative error of the analytic and the measured
    tables.  ``replan`` re-solves on it with the paper's default weights, d
    in (1, 2) and M 4 (the port's planner, dp engine), and the re-planned
    plan (resolved against the measured profile) trains 2 steps on
    ``emulated`` with the kernels, every launch on wgmma, its first loss
    within 2e-2 of the same plan with the kernels' plain versions.  Printed:
    the old and new plans, the re-planned plan's step wall time beside
    ``train_full``'s, and the launches."""
    from repro_torch.obs import calibrate_profile, replan
    from repro_torch.serverless.backends import ProcessBackend
    from repro_torch.serverless.execution import ExecutionConfig

    spec = TRAIN
    torch.use_deterministic_algorithms(True)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    prof, plat, config, M = train_setup(cfg, spec)
    plan = DeploymentPlan.from_config(prof, plat, config, M, model="phi3-mini-3.8b",
                                      seq=spec["seq"], micro_batch=spec["micro_batch"],
                                      solver="manual")
    batches = train_batches(cfg, spec, spec["d"], CALIBRATE_STEPS)
    grad_bytes = 4.0 * sum(a.numel() for a in tree_leaves(params))
    root = store_root(2 * grad_bytes)
    be = ProcessBackend(root=root["root"])
    execution = Execution(cfg=cfg, optimizer=AdamW(lr=1e-4), init_params=params,
                          batch_fn=lambda k: batches[k], use_kernels=True, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan.emulate(ExecutionConfig(backend=be, steps=CALIBRATE_STEPS, trace=True,
                                       payload_true=True),
                       execution=execution, profile=prof)
    t_traced = time.perf_counter() - t0
    shutil.rmtree(root["root"])
    launches = _launches_by_route(
        {k: sum(w["launches"][k] for rep in be.reports for w in rep.values())
         for k in ops.launch_counts()})
    _wgmma_only(launches, "calibrate_replan traced run")
    trace = res.trace
    validate_trace(trace)
    if trace.meta["plan"] != plan._as_dict() or not trace.meta["payload_true"]:
        raise AssertionError("the traced run's meta lacks its plan or payload_true")
    summary = trace_summary(trace, "calibrate_replan_process")
    losses_traced = res.losses
    del res
    cal = calibrate_profile(trace, prof, plat, config, M, pipelined_sync=True)
    if cal.warmup != 1 or cal.profile.source != "measured":
        raise AssertionError(f"warmup {cal.warmup}, source {cal.profile.source}")
    if not cal.residual["max_rel_err"] <= cal.baseline["max_rel_err"]:
        raise AssertionError(f"calibration raised the error: {cal.baseline['max_rel_err']} -> "
                             f"{cal.residual['max_rel_err']}")
    rep = replan(cal, plan, alpha=DEFAULT_ALPHA, d_options=(1, 2))
    new = rep.new_plan
    rp = new.resolve(profile=cal.profile)
    d = rp.config.d
    run_spec = dict(spec, d=d, mu=M // d)
    nbatches = train_batches(cfg, run_spec, d, 2)
    marks, counts = [], []

    def batch_fn(k):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
        return nbatches[k]

    nexec = dataclasses.replace(execution, batch_fn=batch_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    nres = new.emulate(ExecutionConfig(steps=2), execution=nexec, profile=cal.profile)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts.append(ops.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    new_launches = _launches_by_route(counts[-1])
    _wgmma_only(new_launches, "calibrate_replan re-planned run")
    if not all(np.isfinite(nres.losses)):
        raise AssertionError(f"non-finite losses {nres.losses}")
    losses = nres.losses
    del nres
    with training_kernels_as_plain():
        plain = new.emulate(ExecutionConfig(steps=1), profile=cal.profile,
                            execution=dataclasses.replace(execution,
                                                          batch_fn=lambda k: nbatches[k]))
    losses_plain = plain.losses
    del plain
    if abs(losses[0] - losses_plain[0]) > 2e-2:
        raise AssertionError(f"first loss {losses[0]} with the kernels, {losses_plain[0]} "
                             "with their plain versions")
    for k, v in new_launches.items():
        launches[k] += v
    step_wall = [b - a for a, b in zip(marks, marks[1:])]
    emit({"phase": "calibrate_replan", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "steps_traced": CALIBRATE_STEPS,
          "traced_backend": "process", "payload_true": True, "throttle": False,
          "store_root": root["root"], "traced_run_wall_s": t_traced,
          "losses_traced": losses_traced, "trace": summary,
          "calibration": {"warmup": cal.warmup, "scales": cal.scales,
                          "warnings": [w.describe() for w in cal.warnings],
                          "max_rel_err_before": cal.baseline["max_rel_err"],
                          "max_rel_err_after": cal.residual["max_rel_err"],
                          "observed_sync_s": cal.observed_sync,
                          "predicted_sync_s": cal.predicted_sync,
                          "observations": [dataclasses.asdict(o) for o in cal.observations],
                          "describe": cal.describe()},
          "replan": {"alpha": list(DEFAULT_ALPHA), "d_options": [1, 2], "M": M,
                     "engine": "dp", "old_plan": plan.describe(), "new_plan": new.describe(),
                     "new_plan_config": {"x": list(new.x), "z": list(new.z), "d": new.d},
                     "report": rep.describe()},
          "replanned_run": {"backend": "emulated", "steps": 2, "losses": losses,
                            "losses_kernels_as_plain": losses_plain,
                            "step_wall_s": step_wall,
                            "train_full_step_wall_s": RESULTS.get("train_full_step_wall_s"),
                            "max_memory_allocated_bytes": peak,
                            "launches": new_launches},
          "kernel_launches": launches, "phase_wall_s": time.perf_counter() - t_phase})
    del params, batches, nbatches, execution, nexec
    torch.cuda.empty_cache()
    return launches


def profile_train_step(cfg, prof, plat, config, M, params, batches, optimizer,
                       split=False) -> dict:
    """Where a training step's time goes: a second run of the same plan,
    with ``torch.profiler`` over its second step only (``split``: and the
    MoE and Mamba steps' device time, :func:`device_split`)."""
    from torch.profiler import ProfilerActivity, profile

    window = {}

    def batch_fn(k):
        if k == 1:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        return batches[k]

    with family_regions() if split else contextlib.nullcontext():
        run_plan(prof, plat, config, M, steps=2, pipelined_sync=True,
                 execution=Execution(cfg=cfg, optimizer=optimizer, init_params=params,
                                     batch_fn=batch_fn, use_kernels=True, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - window["t0"]
    window["prof"].stop()
    return _profile_summary(window["prof"], wall, 1, split=split)


def _max_param_diff(a: dict, b: dict) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@contextlib.contextmanager
def training_kernels_as_plain():
    """Route ``ops.flash_attention``, ``ops.swiglu`` and ``ops.adamw_`` to
    their plain versions (``impl="ref"``) on the card: the kernel path's own
    arithmetic without the kernels."""
    real = ops.flash_attention, ops.swiglu, ops.adamw_
    ops.flash_attention = lambda *a, **k: real[0](*a, **{**k, "impl": "ref"})
    ops.swiglu = lambda *a, **k: real[1](*a, **{**k, "impl": "ref"})
    ops.adamw_ = lambda *a, **k: real[2](*a, **{**k, "impl": "ref"})
    try:
        yield
    finally:
        ops.flash_attention, ops.swiglu, ops.adamw_ = real


def _expected_launches(n: int, flash_way: str, swiglu_way: str, n_swiglu=None,
                       adamw: int = 0) -> dict:
    """``ops.launch_counts()`` after n launches of each training kernel,
    forward and backward, flash attention on route ``flash_way`` and swiglu
    on ``swiglu_way`` (``n_swiglu`` of swiglu's, when it differs), and
    ``adamw`` of the AdamW kernel."""
    counts = {"decode_attention": 0, "adamw": adamw}
    for name, mod, way, k in (("flash_attention", fa_kernel, flash_way, n),
                              ("swiglu", sg_kernel, swiglu_way,
                               n if n_swiglu is None else n_swiglu)):
        counts |= {name: k, f"{name}_bwd": k}
        for route in mod.ROUTES:
            counts |= {f"{name}_{route}": k if route == way else 0,
                       f"{name}_bwd_{route}": k if route == way else 0}
    return counts


def _workers(config) -> int:
    """A plan's stage workers: one AdamW launch each a step with the
    kernels on."""
    return (sum(config.x) + 1) * config.d


# the routes of the fp32 training runs (train_fp32 at hd 96, train_reduced
# at hd 64, train_gemma_fp32 at hd 256): flash attention and swiglu on the
# tensor cores, three TF32 products a product
FP32_WAYS = {"flash_attention": "tf32x3", "swiglu": "tf32x3"}


def train_routes(cfg, spec, optimizer, params, *, d: int, steps: int, routes) -> dict:
    """One run_plan per route on the same params and batches: "kernel"
    (``use_kernels=True``), "kernel_plain" (the same path with the kernels'
    plain versions) and "plain" (``use_kernels=False``); these runs are fp32,
    so flash attention and swiglu take the tf32x3 route (``FP32_WAYS``)."""
    prof, plat, config, M = train_setup(cfg, spec, d=d)
    batches = train_batches(cfg, spec, d, steps)
    per_call = d * spec["mu"] * steps       # a layer's calls in the run
    per_flash = per_call * n_layers_of(cfg, mixer=ATTN)
    per_swiglu = per_call * n_layers_of(cfg, ff=DENSE_FF)
    out = {}
    for route in routes:
        ops.reset_launch_counts()
        ctx = training_kernels_as_plain() if route == "kernel_plain" else contextlib.nullcontext()
        with ctx:
            res = run_plan(prof, plat, config, M, steps=steps, execution=Execution(
                cfg=cfg, optimizer=optimizer, init_params=params,
                batch_fn=lambda k: batches[k], use_kernels=route != "plain", device="cuda"))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        on = route == "kernel"
        adamw = _workers(config) * steps if on and type(optimizer) is AdamW else 0
        want = _expected_launches(per_flash if on else 0, FP32_WAYS["flash_attention"],
                                  FP32_WAYS["swiglu"], n_swiglu=per_swiglu if on else 0,
                                  adamw=adamw)
        if counts != want:
            raise AssertionError(f"route {route}: launches {counts}, expected {want}")
        out[route] = (res.losses, res.params, counts)
        del res
    return out


def _diff(routes: dict, a: str, b: str) -> dict:
    (la, pa, _), (lb, pb, _) = routes[a], routes[b]
    return {"loss_max_abs_diff": max(abs(x - y) for x, y in zip(la, lb)),
            "param_max_abs_diff": _max_param_diff(pa, pb)}


def phase_train_fp32(smi: str) -> dict:
    """Full width in fp32: the kernel path within 5e-5 (losses) and 1e-4
    (params) of the plain path after one SGD step (tests/test_runtime.py:
    286-288)."""
    spec = TRAIN
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"],
                              param_dtype="float32")
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    t0 = time.perf_counter()
    routes = train_routes(cfg, spec, SGD(lr=0.05), params, d=1, steps=1,
                          routes=("kernel", "plain"))
    rec = _diff(routes, "kernel", "plain")
    if rec["loss_max_abs_diff"] > 5e-5 or rec["param_max_abs_diff"] > 1e-4:
        raise AssertionError(f"fp32 kernel path disagrees with the plain path: {rec}")
    wall = time.perf_counter() - t0
    losses = {"losses_kernel": routes["kernel"][0], "losses_plain": routes["plain"][0]}
    launches = routes["kernel"][2]
    del routes
    # one more run of the same plan, its second step profiled
    prof, plat, config, M = train_setup(cfg, spec, d=1)
    profile = profile_train_step(cfg, prof, plat, config, M, params,
                                 train_batches(cfg, spec, 1, 2), SGD(lr=0.05))
    emit({"phase": "train_fp32", "card": smi, "model": "phi3-mini-3.8b", "dtype": "float32",
          "n_layers": cfg.n_layers, "d": 1, "mu": spec["mu"], "steps": 1,
          "optimizer": "SGD(lr=0.05)", "wall_s": wall, **losses,
          "kernel_launches": launches, **rec, "train_profile": profile})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_train_reduced(smi: str) -> None:
    """phi3-mini-3.8b@reduced with 4 layers, fp32, on the plan of
    tests/test_runtime.py:230-240, AdamW(1e-2), 2 steps.  The kernel path
    holds 2e-4 on losses and 2e-3 on params both against the same path with
    the kernels' plain versions and against ``use_kernels=False``."""
    spec = TRAIN_REDUCED
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                              n_layers=spec["n_layers"])
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    routes = train_routes(cfg, spec, AdamW(lr=1e-2), params, d=spec["d"],
                          steps=spec["steps"], routes=("kernel", "kernel_plain", "plain"))
    vs_own = _diff(routes, "kernel", "kernel_plain")
    vs_plain = _diff(routes, "kernel", "plain")
    if any(rec["loss_max_abs_diff"] > 2e-4 or rec["param_max_abs_diff"] > 2e-3
           for rec in (vs_own, vs_plain)):
        raise AssertionError(f"reduced kernel path disagrees: vs its plain versions {vs_own}, "
                             f"vs the plain path {vs_plain}")
    emit({"phase": "train_reduced", "card": smi, "model": "phi3-mini-3.8b@reduced",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "d": spec["d"],
          "mu": spec["mu"], "steps": spec["steps"], "optimizer": "AdamW(lr=1e-2)",
          "losses": {r: v[0] for r, v in routes.items()},
          "kernel_launches": routes["kernel"][2],
          "kernel_vs_kernel_plain": vs_own, "kernel_vs_plain": vs_plain})


def phase_train_gemma(smi: str) -> dict:
    """gemma3-4b at full width cut to 12 layers (two periods: ten window-1024
    layers and two global ones, heads of 256, q/k norms), bf16, seed 0: 2
    stages of one period, d 1, 2 micro-batches of 1 x 2048 tokens, AdamW, 2
    steps through ``run_plan(..., use_kernels=True)``.  24 + 24 flash
    attention launches a step, all on the wgmma route (hd 256), and swiglu's
    on wgmma; in step 1 every flash attention and swiglu call held against
    ``impl="ref"`` on its real inputs, outputs and gradients; finite losses,
    the first within 2e-2 of the plain path's; peak memory; one profiled
    step."""
    spec = TRAIN_GEMMA
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    prof, plat, config, M = train_setup(cfg, spec)
    d, mu, steps = spec["d"], spec["mu"], spec["steps"]
    batches = train_batches(cfg, spec, d, steps)
    per_step = d * mu * cfg.n_layers
    checker = CallChecker()
    marks, counts = [], []

    def batch_fn(k):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
        if k > 0:
            checker.remove()
        else:
            checker.install()
        return batches[k]

    execution = Execution(cfg=cfg, optimizer=AdamW(lr=1e-4), init_params=params,
                          batch_fn=batch_fn, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        res = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=True,
                       execution=execution)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
    finally:
        checker.remove()
    peak = torch.cuda.max_memory_allocated()
    launches = counts[-1]
    step_counts = [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])]
    expect = _expected_launches(per_step, "wgmma", "wgmma", adamw=_workers(config))
    if any(c != expect for c in step_counts):
        raise AssertionError(f"launches per step {step_counts}, expected {expect}")
    if checker.failures:
        raise AssertionError(f"kernel calls disagree with impl='ref': {checker.failures[:5]}")
    want_calls = {"flash_attention": per_step, "swiglu": per_step}
    want_grads = {"flash_attention": 3 * per_step, "swiglu": 3 * per_step}
    if checker.calls != want_calls or checker.grads != want_grads:
        raise AssertionError(f"checked {checker.calls} calls and {checker.grads} gradients, "
                             f"expected {want_calls} and {want_grads}")
    if not all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    losses, t_iter = res.losses, res.t_iter
    del res
    plain = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=True,
                     execution=dataclasses.replace(execution, batch_fn=lambda k: batches[k],
                                                   use_kernels=False))
    losses_plain = plain.losses
    del plain
    if abs(losses[0] - losses_plain[0]) > 2e-2:
        raise AssertionError(f"first loss {losses[0]} on the kernel path, "
                             f"{losses_plain[0]} on the plain path")
    profile = profile_train_step(cfg, prof, plat, config, M, params, batches, AdamW(lr=1e-4))
    emit({"phase": "train_gemma", "card": smi, "model": "gemma3-4b", "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "windows": [s.window for s in cfg.period],
          "params": n_params, "stages": 2, "d": d, "mu": mu,
          "micro_batch": spec["micro_batch"], "seq": spec["seq"], "steps": steps,
          "optimizer": "AdamW(lr=1e-4)", "losses": losses, "losses_plain_path": losses_plain,
          "t_iter_virtual_s": t_iter, "launches_per_step": step_counts,
          "kernel_launches": launches, "checked_calls": checker.calls,
          "checked_gradients": checker.grads, "call_max_abs_err": checker.out_err,
          "grad_max_abs_err": checker.grad_err,
          "step_wall_s": [b - a for a, b in zip(marks, marks[1:])],
          "max_memory_allocated_bytes": peak, "train_profile": profile})
    del params, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_gemma_fp32(smi: str) -> dict:
    """gemma3-4b at full width cut to one period (five window-1024 layers and
    one global layer, heads of 256), fp32, seed 0: one stage, d 1, 2
    micro-batches of 1 x 2048 tokens, SGD(0.05), 1 step through ``run_plan``
    with ``use_kernels`` True and False (``FP32_WAYS``).  12 + 12 flash
    attention launches, all on the tf32x3 route at hd 256 (10 window, 2
    global) and none on simt, swiglu's on tf32x3; every flash attention call
    held against ``impl="ref"`` on its real inputs at 2e-5 (output) and 1e-4
    (gradients).  swiglu's calls at d 2560 are not held per call: there the
    fp32 plain version is the less exact sum (ROADMAP §3), and the end-to-end
    bar covers them: the kernel path within 5e-5 (loss) and 1e-4 (params) of
    the plain path (tests/test_runtime.py:286-288).  Finite losses, peak
    memory, one profiled step."""
    spec = TRAIN_GEMMA_FP32
    cfg = dataclasses.replace(get_config("gemma3-4b"), n_layers=spec["n_layers"],
                              param_dtype="float32")
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    prof, plat, config, M = train_setup(cfg, spec)
    batches = train_batches(cfg, spec, spec["d"], 2)   # the profiled run takes a second step
    per_step = spec["mu"] * cfg.n_layers
    checker = CallChecker(names=("flash_attention",))
    runs, walls, peaks = {}, {}, {}
    for route in ("kernel", "plain"):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if route == "kernel":
            checker.install()
        try:
            t0 = time.perf_counter()
            res = run_plan(prof, plat, config, M, steps=spec["steps"], execution=Execution(
                cfg=cfg, optimizer=SGD(lr=0.05), init_params=params,
                batch_fn=lambda k: batches[k], use_kernels=route == "kernel", device="cuda"))
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
        finally:
            checker.remove()
        peaks[route] = torch.cuda.max_memory_allocated()
        runs[route] = (res.losses, res.params, ops.launch_counts())
        del res
    for route, n in (("kernel", per_step), ("plain", 0)):
        want = _expected_launches(n, FP32_WAYS["flash_attention"], FP32_WAYS["swiglu"])
        if runs[route][2] != want:
            raise AssertionError(f"route {route}: launches {runs[route][2]}, expected {want}")
    if checker.failures:
        raise AssertionError(f"flash calls disagree with impl='ref': {checker.failures[:5]}")
    windows = [s.window for s in cfg.period]
    want_windows = {w: spec["mu"] * windows.count(w) for w in set(windows)}
    if checker.calls != {"flash_attention": per_step, "swiglu": 0} or \
            checker.grads != {"flash_attention": 3 * per_step, "swiglu": 0} or \
            checker.windows != want_windows:
        raise AssertionError(f"checked {checker.calls} calls, {checker.grads} gradients, "
                             f"windows {checker.windows}; expected {per_step}, "
                             f"{3 * per_step}, {want_windows}")
    losses = {"losses_kernel": runs["kernel"][0], "losses_plain": runs["plain"][0]}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    rec = _diff(runs, "kernel", "plain")
    if rec["loss_max_abs_diff"] > 5e-5 or rec["param_max_abs_diff"] > 1e-4:
        raise AssertionError(f"fp32 gemma kernel path disagrees with the plain path: {rec}")
    launches = runs["kernel"][2]
    del runs
    profile = profile_train_step(cfg, prof, plat, config, M, params, batches, SGD(lr=0.05))
    emit({"phase": "train_gemma_fp32", "card": smi, "model": "gemma3-4b", "dtype": "float32",
          "n_layers": cfg.n_layers, "windows": windows, "params": n_params, "stages": 1,
          "d": spec["d"], "mu": spec["mu"], "micro_batch": spec["micro_batch"],
          "seq": spec["seq"], "steps": spec["steps"], "optimizer": "SGD(lr=0.05)", **losses,
          **rec, "kernel_launches": launches, "checked_calls": checker.calls,
          "checked_gradients": checker.grads, "flash_calls_by_window": checker.windows,
          "call_max_abs_err": checker.out_err, "grad_max_abs_err": checker.grad_err,
          "wall_s": walls, "max_memory_allocated_bytes": peaks, "train_profile": profile})
    del params, batches
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------- the MoE and Mamba families
# jamba-v0.1-52b served at full width, one period (7 Mamba layers and one
# attention layer, 4 MoE FFNs of 16 experts and 4 dense FFNs); a prompt of
# 1024 tokens (a multiple of Mamba's chunk of 256) and 16 new tokens
SERVE_JAMBA = dict(batch=4, prefill_tokens=1024, new_tokens=16)   # s_ctx = 1040
JAMBA_LAYERS = 8
# qwen3-moe-235b-a22b trained at full width, one layer (64 q / 4 kv heads of
# 128 with q/k norms, 128 experts top-8 of width 1536): [embed + layer | head]
TRAIN_MOE = dict(n_layers=1, seq=2048, micro_batch=1, d=1, mu=2, steps=2, cut=1,
                 lr=5e-3)
# jamba@reduced in fp32 on one stage: Mamba's backward, a hybrid period's
# swiglu (4 dense FFNs) and flash attention (hd 64) on the tf32x3 route
TRAIN_JAMBA_REDUCED = dict(n_layers=8, seq=128, micro_batch=2, d=1, mu=2, steps=1, cut=-1)
# the kernels at the families' shapes: flash attention at qwen3-moe's
# training shape (G 16, hd 128) and decode attention at jamba's decode shape
# (G 4, hd 128) over 1024 + 16 slots (a short last chunk of the split pass)
FLASH_QWEN3_MOE = (1, 2048, 64, 4, 128, True, 0)
JAMBA_DECODE = dict(B=4, Hq=32, Hkv=8, hd=128, C=1040)
# the steps of the MoE FFN and the Mamba mixer timed apart on the device
FAMILY_REGIONS = {moe_mod: ("route", "slots", "dispatch", "experts", "combine"),
                  mamba_mod: ("selective_scan", "mamba_decode")}
# autograd nodes of their backward: the expert products and the row gathers
FAMILY_BACKWARD = {"experts": "BmmBackward0", "dispatch_combine": "_RowGatherBackward"}


def n_layers_of(cfg, mixer=None, ff=None) -> int:
    """Layers of ``cfg`` with that mixer and/or FFN kind."""
    return sum(1 for i in range(cfg.n_layers)
               if (mixer is None or cfg.layer_spec(i).mixer == mixer)
               and (ff is None or cfg.layer_spec(i).ff == ff))


def region_labels() -> set:
    """The ``record_function`` names of ``family_regions``."""
    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{n}"
            for mod, names in FAMILY_REGIONS.items() for n in names}


@contextlib.contextmanager
def family_regions():
    """Wrap each step of ``FAMILY_REGIONS`` in a ``record_function`` range
    named ``<module>.<step>`` (``moe.dispatch``, ``mamba.selective_scan``,
    ...), so a profile gives each its device time.  The modules look the
    steps up at each call."""
    saved = []
    for mod, names in FAMILY_REGIONS.items():
        for name in names:
            real = getattr(mod, name)
            label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

            def wrapped(*a, _real=real, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _real(*a, **k)

            saved.append((mod, name, real))
            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def _kernel_family(name: str) -> str:
    if "flash" in name:
        return "flash_attention"
    if "decode_attention" in name:
        return "decode_attention"
    if "swiglu" in name:
        return "swiglu"
    if re.search(r"gemm|cutlass|xmma|sm90_|gemv|cublas|nvjet", name, re.I):
        return "cublas"
    if re.search(r"index|gather|scatter", name, re.I):
        return "index"
    if re.search(r"sort|radix|scan", name, re.I):
        return "sort_cumsum"
    if re.search(r"elementwise|vectorized|reduce|softmax|cat|copy|fill", name, re.I):
        return "elementwise_reduce"
    return "other"


def device_split(prof, steps: int) -> dict:
    """Device ms per step: by ``family_regions`` range (the kernels launched
    inside it, forward), by backward node of ``FAMILY_BACKWARD``, and over
    all kernels by family of name (cuBLAS, elementwise and reductions, index
    gathers, sorts and scans, the port's kernels)."""
    def dev_us(e):
        return e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total

    def self_us(e):
        return e.self_device_time_total if hasattr(e, "self_device_time_total") \
            else e.self_cuda_time_total

    labels = region_labels()
    regions, backward, families = {}, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in labels:   # the range itself on the device timeline
                continue
            fam = _kernel_family(e.name)
            families[fam] = families.get(fam, 0.0) + self_us(e) / 1e3 / steps
        elif e.name in labels:
            regions[e.name] = regions.get(e.name, 0.0) + dev_us(e) / 1e3 / steps
        else:
            for what, node in FAMILY_BACKWARD.items():
                if e.name.startswith("autograd::engine::evaluate_function: ") \
                        and e.name.endswith(node):
                    backward[what] = backward.get(what, 0.0) + dev_us(e) / 1e3 / steps
    return {"forward_regions": regions, "backward_nodes": backward,
            "kernel_families": families}


def _record(r: dict, err: float) -> dict:
    """A kernels-record row of a timing: its bytes and flops out, the
    parity's max |error| in."""
    return {k: v for k, v in r.items() if k not in ("bytes", "flops")} | {"max_abs_err": err}


def _flash_case(gen, flush, shape, tag: str) -> tuple:
    """bf16 flash attention at ``shape`` against its plain version, forward
    and backward, on the wgmma route (asserted through the launch counters),
    two backward calls bit-equal, then timed (:func:`_flash_timing`) ->
    ({"flash_attention_<tag>": ..., "flash_attention_bwd_<tag>": ...},
    the timing)."""
    B, S, Hq, Hkv, hd, causal, window = shape
    dtype = torch.bfloat16
    q, do = (torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    what = f"flash {tag} {shape}"
    ops.reset_launch_counts()
    err = _check_kernel(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal, window=window),
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal, window=window, impl="ref"),
        (q, k, v), do, what)
    counts = ops.launch_counts()
    if (counts["flash_attention_wgmma"], counts["flash_attention_bwd_wgmma"]) != (1, 1):
        raise AssertionError(f"{what}: expected the wgmma route, launches {counts}")
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    grads = [fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
             for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*grads)):
        raise AssertionError(f"{what}: two backward calls differ")
    t = _flash_timing(gen, flush, dtype, shape)
    return {f"flash_attention_{tag}": _record(t["fwd"], err["out"]),
            f"flash_attention_bwd_{tag}": _record(t["bwd"], err["grad"])}, t


def _families_parity(flush) -> tuple:
    """The kernels at the new families' shapes, each against its plain
    version: flash attention forward and backward at qwen3-moe's
    [1, 2048, 64 q, 4 kv, 128] (bf16, the wgmma route, two backward calls
    bit-equal), and decode attention at jamba's [4, 32 q, 8 kv, 128] over a
    1040-slot cache at lengths around the short last chunk (fp32 2e-5, bf16
    2e-2); each timed beside its bound, its plain version and SDPA (pinned
    to its flash backend for flash attention, with the default dispatch
    beside it; with ``enable_gqa`` for decode)."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    recs, flash = _flash_case(gen, flush, FLASH_QWEN3_MOE, "qwen3_moe")

    C = JAMBA_DECODE["C"]
    recs["decode_attention_jamba"], decode = _decode_case(gen, flush, JAMBA_DECODE,
                                                          lengths=(1, 1024, 1025, C))
    detail = {"flash_shape": FLASH_QWEN3_MOE, "flash_sdpa": flash["sdpa"],
              "flash_simt_ms": flash["simt"], "flash_bwd_passes_ms": flash["bwd_passes_ms"],
              "decode_shape": JAMBA_DECODE, "decode_max_abs_err": decode["max_abs_err"],
              "decode_chunk": decode["chunk"], "decode_splits": decode["splits"]}
    return recs, detail


def _cache_bytes(caches) -> dict:
    """Bytes of one period instance's decode caches by kind."""
    out = {"mamba": 0, "kv": 0}
    for c in caches:
        kind = "mamba" if isinstance(c, mamba_mod.MambaCache) else "kv"
        out[kind] += sum(int(np.prod(a.shape[1:])) * a.element_size() for a in c)
    return out


def profile_prefill(cfg, params, prompt, *, s_ctx) -> dict:
    """Where a prefill's time goes (one monolithic prefill after a warm-up
    one), with the MoE and Mamba steps apart."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(prompt).cuda()
    registry.prefill(cfg, params, {"tokens": toks}, capacity=s_ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with family_regions():
            registry.prefill(cfg, params, {"tokens": toks}, capacity=s_ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _profile_summary(prof, wall, 1, split=True)


def phase_serve_jamba(smi: str) -> int:
    """jamba-v0.1-52b at full width, one period (``@layers8``: 13.3 B
    params, bf16, seed 0), served through ``run_serve_plan`` on emulated, 2
    stages [embed + period | head]: 1 decode-attention launch a round,
    tokens bit-identical to the monolithic loop, every decode-attention call
    within 2e-2 of ``impl="ref"``; the Mamba and KV bytes that cross the
    store each round, round times, peak memory, and the device time of
    prefill and decode by step (MoE routing, dispatch, experts, combine,
    Mamba scan and decode) and by kernel family."""
    torch.use_deterministic_algorithms(True)
    spec = SERVE_JAMBA
    model = f"jamba-v0.1-52b@layers{JAMBA_LAYERS}"
    cfg = arch_config_for_model(model)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(a.numel() for a in tree_leaves(params))
    plan = manual_serve_plan(model, cuts=(JAMBA_LAYERS,), **spec)
    prompt = make_prompt(cfg, spec["batch"], spec["prefill_tokens"], seed=0)
    s_ctx = spec["prefill_tokens"] + spec["new_tokens"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_serve_plan(plan, params=params, prompt=prompt, use_kernels=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()["decode_attention"]
    expect = (spec["new_tokens"] - 1) * n_layers_of(cfg, mixer=ATTN)
    if launches != expect:
        raise AssertionError(f"decode_attention launched {launches} times, expected {expect}")
    mono = reference_decode(cfg, params, prompt, spec["new_tokens"], use_kernels=True)
    if not np.array_equal(res.tokens, mono):
        raise AssertionError(f"pipelined tokens differ from the monolithic loop:\n"
                             f"{res.tokens}\n{mono}")
    tf = teacher_forced(cfg, params, prompt, res.tokens, s_ctx=s_ctx, call_tol=2e-2)
    per_round = _cache_bytes(registry.init_decode_caches(cfg, spec["batch"], s_ctx,
                                                         device="meta"))
    kv_store = res.store_stats.class_bytes_in["kv"]
    if kv_store != spec["new_tokens"] * (per_round["mamba"] + per_round["kv"]):
        raise AssertionError(f"{kv_store} cache bytes put in the store, expected "
                             f"{spec['new_tokens']} x {per_round}")
    prefill_profile = profile_prefill(cfg, params, prompt, s_ctx=s_ctx)
    decode_profile = profile_decode(cfg, params, prompt, res.tokens, s_ctx=s_ctx, split=True)
    emit({"phase": "serve_jamba", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "reduced": {"n_layers": [32, cfg.n_layers]},
          "period": [[s_.mixer, s_.ff] for s_ in cfg.period], "params": n_params,
          "stages": plan.n_stages, **spec, "s_ctx": s_ctx,
          "kernel_launches": launches, "tokens_match_monolithic": True,
          "teacher_forced_bf16": tf,
          "cache_bytes_per_round": per_round, "store_cache_bytes_in": kv_store,
          "kv_bytes_estimate": list(res.kv_bytes), "store": res.store_stats.as_dict(),
          "t_request_virtual_s": res.t_request, "param_init_s": t_init,
          "prefill_wall_s": res.round_wall_s[0],
          "decode_round_wall_s": list(res.round_wall_s[1:]),
          "decode_round_wall_s_median": statistics.median(res.round_wall_s[1:]),
          "max_memory_allocated_bytes": peak, "prefill_profile": prefill_profile,
          "decode_profile": decode_profile, "tokens_head": res.tokens[0].tolist(),
          "training_at_full_width": "not run: one period needs >= 10 B a param "
          "(bf16 weights, fp32 masters, fp32 gradients), >= 133 GB; it waits for the "
          "mesh path (ROADMAP port queue item 7)"})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_serve_jamba_reduced(smi: str) -> int:
    """tests/test_models_unit.py:23-48 on the card: jamba@reduced in fp32,
    capacity ``n_experts`` (no drops), weights from seed 0: the prefill of
    28 tokens then 4 decode steps (decode attention on the kernel) against
    the full forward's logits at 1e-4 / 2e-4."""
    cfg = arch_config_for_model("jamba-v0.1-52b@reduced")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_params(cfg, gen, device="cuda")
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    h, aux = registry.forward(cfg, params, {"tokens": toks, "labels": toks})
    ref = registry._logits(cfg, params, h)
    logits, caches = registry.prefill(cfg, params, {"tokens": toks[:, :S - 4]}, capacity=S)
    errs = [_close_at(logits[:, 0], ref[:, S - 5], 1e-4, 1e-4, "jamba@reduced prefill")]
    ops.reset_launch_counts()
    for t in range(S - 4, S):
        logits, caches = registry.decode_step(cfg, params, caches, toks[:, t:t + 1],
                                              use_kernels=True)
        errs.append(_close_at(logits[:, 0], ref[:, t], 1e-4, 2e-4,
                              f"jamba@reduced decode step {t}"))
    launches = ops.launch_counts()["decode_attention"]
    if launches != 4 * n_layers_of(cfg, mixer=ATTN):
        raise AssertionError(f"decode_attention launched {launches} times")
    emit({"phase": "serve_jamba_reduced", "card": smi, "model": "jamba-v0.1-52b@reduced",
          "dtype": cfg.param_dtype, "capacity_factor": cfg.moe.capacity_factor,
          "prompt": S - 4, "decode_steps": 4, "aux": float(aux),
          "prefill_max_abs_err": errs[0], "decode_max_abs_err": errs[1:],
          "kernel_launches": launches})
    return launches


def phase_train_moe(smi: str) -> dict:
    """qwen3-moe-235b-a22b at full width, one layer (3.73 B params), bf16,
    seed 0: 2 stages [embed + layer | head], d 1, 2 micro-batches of 1 x
    2048 tokens, eq (2), SGD, 2 steps through ``run_plan(...,
    use_kernels=True)``.  2 + 2 flash attention launches a step, all on the
    wgmma route (hd 128, G 16), none of swiglu (the layer's FFN is the MoE's
    expert products); in step 1 every flash call held against
    ``impl="ref"``; finite losses (ce and aux apart), the first within 2e-2
    of the same plan with the kernels' plain versions; peak memory; one
    profiled step with the MoE's steps apart."""
    spec = TRAIN_MOE
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    d, mu, steps = spec["d"], spec["mu"], spec["steps"]
    per_step = d * mu * n_layers_of(cfg, mixer=ATTN)
    checker = CallChecker(names=("flash_attention",))
    run = _tracked_training(cfg, spec, params, SGD(lr=spec["lr"]), checker=checker)
    res, launches, step_counts = run.pop("res"), run["launches"], run["launches_per_step"]
    prof, plat, config, M = run["plan"]
    batches, execution = run["batches"], run["execution"]
    expect = _expected_launches(per_step, "wgmma", "wgmma", n_swiglu=0)
    if any(c != expect for c in step_counts):
        raise AssertionError(f"launches per step {step_counts}, expected {expect}")
    if checker.failures:
        raise AssertionError(f"flash calls disagree with impl='ref': {checker.failures[:5]}")
    if checker.calls["flash_attention"] != per_step or \
            checker.grads["flash_attention"] != 3 * per_step:
        raise AssertionError(f"checked {checker.calls} calls and {checker.grads} gradients")
    metrics = res.metrics
    if not all(np.isfinite([m[k] for m in metrics for k in ("ce", "aux")])):
        raise AssertionError(f"non-finite losses {metrics}")
    t_iter = res.t_iter
    del res
    with training_kernels_as_plain():
        plain = run_plan(prof, plat, config, M, steps=steps, pipelined_sync=True,
                         execution=dataclasses.replace(execution,
                                                       batch_fn=lambda k: batches[k]))
    metrics_plain = plain.metrics
    del plain
    if abs(metrics[0]["loss"] - metrics_plain[0]["loss"]) > 2e-2:
        raise AssertionError(f"first loss {metrics[0]} on the kernel path, "
                             f"{metrics_plain[0]} with the kernels' plain versions")
    profile = profile_train_step(cfg, prof, plat, config, M, params, batches,
                                 SGD(lr=spec["lr"]), split=True)
    emit({"phase": "train_moe", "card": smi, "model": "qwen3-moe-235b-a22b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers,
          "reduced": {"n_layers": [94, cfg.n_layers]}, "params": n_params,
          "stages": 2, "d": d, "mu": mu, "micro_batch": spec["micro_batch"],
          "seq": spec["seq"], "steps": steps, "optimizer": f"SGD(lr={spec['lr']})",
          "capacity": moe_mod.capacity(spec["micro_batch"] * spec["seq"], cfg.moe),
          "metrics": metrics, "metrics_kernels_as_plain": metrics_plain,
          "t_iter_virtual_s": t_iter, "launches_per_step": step_counts,
          "launches_by_route": _launches_by_route(launches),
          "kernel_launches": launches, "checked_calls": checker.calls,
          "checked_gradients": checker.grads, "call_max_abs_err": checker.out_err,
          "grad_max_abs_err": checker.grad_err, "step_wall_s": run["step_wall_s"],
          "max_memory_allocated_bytes": run["peak"], "train_profile": profile})
    del params, batches, execution, run
    torch.cuda.empty_cache()
    return launches


def phase_train_jamba_reduced(smi: str) -> dict:
    """jamba@reduced (one period: 7 Mamba layers and one attention layer, 4
    MoE and 4 dense FFNs), fp32, seed 0: one stage, d 1, 2 micro-batches of
    2 x 128 tokens, SGD(0.05), 1 step with the kernels and without: 2 flash
    attention and 8 swiglu launches, all on tf32x3; losses within 5e-5 and
    params within 1e-4 (tests/test_runtime.py:286-288)."""
    spec = TRAIN_JAMBA_REDUCED
    cfg = arch_config_for_model("jamba-v0.1-52b@reduced")
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    routes = train_routes(cfg, spec, SGD(lr=0.05), params, d=spec["d"], steps=spec["steps"],
                          routes=("kernel", "plain"))
    rec = _diff(routes, "kernel", "plain")
    losses = {r: v[0] for r, v in routes.items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    if rec["loss_max_abs_diff"] > 5e-5 or rec["param_max_abs_diff"] > 1e-4:
        raise AssertionError(f"jamba@reduced kernel path disagrees with the plain path: {rec}")
    emit({"phase": "train_jamba_reduced", "card": smi, "model": "jamba-v0.1-52b@reduced",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "d": spec["d"],
          "mu": spec["mu"], "seq": spec["seq"], "steps": spec["steps"],
          "optimizer": "SGD(lr=0.05)", "losses": losses,
          "kernel_launches": routes["kernel"][2], **rec})
    return routes["kernel"][2]


# ------------------------------------------- xLSTM, the encoders, vision
# bert-large and hubert-xlarge's attention (no mask; heads of 64 and 80)
# and FFNs at their phases' shapes, internvl2-26b's decode (G 6) over 1024
# + 16 slots, and gemma3-4b's global layers' decode (G 2, hd 256)
FLASH_BERT = (4, 512, 16, 16, 64, False, 0)
FLASH_HUBERT = (2, 1024, 16, 16, 80, False, 0)
SWIGLU_BERT = (2048, 1024, 4096)
SWIGLU_HUBERT = (2048, 1280, 5120)
INTERNVL2_DECODE = dict(B=4, Hq=48, Hkv=8, hd=128, C=1040)
GEMMA3_DECODE = dict(B=4, Hq=8, Hkv=4, hd=256, C=1040)
# bert-large at full width, cut to 12 of its 24 layers (the script's time
# budget): 2 stages of 6 layers x 2 replicas
TRAIN_BERT = dict(n_layers=12, seq=512, micro_batch=4, d=2, mu=2, steps=2, cut=6)
# hubert-xlarge's loss and gradients: one frames batch of 2 x 1024; the SGD
# step tries JAX's test's lr first and halves it (about 2/5 each time) until
# the loss falls: at d 1280 a softmax head's curvature is ~d/4 per unit of
# lr, so 0.05 overshoots (it raised the loss 6.45 -> 8.20 on an H100)
# (full width, cut to 24 of its 48 layers for the script's time budget)
HUBERT_BATCH = dict(batch=2, seq=1024, n_layers=24,
                    lrs=(0.05, 0.02, 0.01, 0.005, 0.002, 0.001))
# xlstm-125m at full width, cut to 4 of its 12 layers (the script's time
# budget): 2 stages of one period x 2 replicas; 512 tokens are two mLSTM
# chunks; one step (at 12 layers ~27-45 s on an H100: the sLSTM's step
# loop launches ~1.1 M kernels a step from the host)
TRAIN_XLSTM = dict(n_layers=4, seq=512, micro_batch=4, d=2, mu=2, steps=1, cut=2)
SERVE_XLSTM = dict(batch=4, prefill_tokens=512, new_tokens=16)
# the decode caches of xlstm-125m at batch 4, summed over its 6 periods: 6 x
# (mLSTM C, n, m, conv 9,498,688 + sLSTM c, n, m, h 43,008) bytes, as JAX's
# init_decode_caches sizes them (tests/test_torch_xlstm_encoders.py holds
# the port's sizes to JAX's)
XLSTM_CACHE_BYTES_PER_ROUND = 57_250_176
SERVE_INTERNVL2 = dict(batch=4, prefill_tokens=1024, new_tokens=16)   # s_ctx = 1040
INTERNVL2_LAYERS = 8


def _decode_case(gen, flush, shape: dict, lengths=None, timed=(torch.bfloat16,)) -> tuple:
    """Decode attention at ``shape`` against its plain version in fp32
    (2e-5) and bf16 (2e-2) at ``lengths`` (1, C - 16 and C by default), two
    calls bit-equal; then, with a full cache, timed in each dtype of
    ``timed`` beside its bound, its plain version and SDPA (``enable_gqa``)
    -> (the record of the first timed dtype, errors and every timed dtype's
    record)."""
    B, Hq, Hkv, hd, C = (shape[x] for x in ("B", "Hq", "Hkv", "hd", "C"))
    errs, recs = {}, {}
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn(B, Hq, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Hkv, C, hd, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        for length in lengths or (1, C - 16, C):
            L = torch.tensor([length], dtype=torch.int32, device="cuda")
            out = ops.decode_attention(q, k, v, L)
            errs[f"{str(dtype)[6:]}@{length}"] = _close(
                out, ops.decode_attention(q, k, v, L, impl="ref"), tol,
                f"decode {shape} length={length} {dtype}")
            if not torch.equal(out, ops.decode_attention(q, k, v, L)):
                raise AssertionError(f"decode {shape} length={length}: two calls differ")
        if dtype not in timed:
            continue
        L = torch.tensor([C], dtype=torch.int32, device="cuda")
        mask = torch.ones((1, 1, 1, C), dtype=torch.bool, device="cuda")
        ms = _time_ms(lambda: da_kernel.decode_attention(q, k, v, L), flush)
        plain_ms = _time_ms(lambda: ops.decode_attention(q, k, v, L, impl="ref"), flush)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q.unsqueeze(2), k, v, attn_mask=mask, enable_gqa=True), flush)
        esz = q.element_size()
        nbytes = 2 * B * Hkv * C * hd * esz + 2 * q.numel() * esz
        flops = 4 * B * Hq * C * hd
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
        recs[str(dtype)[6:]] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "scaled_dot_product_attention(enable_gqa=True)",
            "bound_ms": bound_ms, "bound_by": bound_by, "kernel_route": "splitk",
            "tflop_per_s": flops / ms / 1e9, "max_abs_err": errs[f"{str(dtype)[6:]}@{C}"],
            "hbm_gb_per_s": nbytes / (ms * 1e-3) / 1e9, "roofline_share": bound_ms / ms,
            "kv_bytes": 2 * B * Hkv * C * hd * esz,
            # query heads a split-pass block takes for the group's Hq / Hkv
            "heads_per_block": da_kernel.build().repro_decode_attention_heads(
                hd, int(dtype == torch.bfloat16), Hq // Hkv)}
    first = str(timed[0])[6:]
    return recs[first], {"max_abs_err": errs, "times": recs,
                         "chunk": da_kernel.split_chunk(C),
                         "splits": -(-C // da_kernel.split_chunk(C))}


def _encoders_parity(flush) -> tuple:
    """The kernels at the encoders' and the vision model's shapes, each
    against its plain version and timed beside its bound, its plain version
    and a library call: flash attention with no mask at bert-large's [4,
    512, 16, 16, 64] and hubert-xlarge's [2, 1024, 16, 16, 80] (bf16, the
    wgmma route, two backward calls bit-equal; SDPA with ``is_causal=False``,
    its flash backend and its default dispatch), swiglu at their FFNs'
    shapes (T 2048, d 1024, f 4096 and T 2048, d 1280, f 5120; wgmma),
    decode attention at internvl2-26b's [4, 48 q, 8 kv, 128] (G 6) over
    1040 slots and, timed in bf16 and fp32, at gemma3-4b's global layers'
    [4, 8 q, 4 kv, 256] (G 2)."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    recs, detail = {}, {}
    for name, shape in (("bert", FLASH_BERT), ("hubert", FLASH_HUBERT)):
        rows, t = _flash_case(gen, flush, shape, name)
        recs |= rows
        detail[f"flash_{name}"] = {"shape": shape, "sdpa": t["sdpa"],
                                   "simt_ms": t["simt"], "fwd_passes_ms": t["fwd_passes_ms"],
                                   "bwd_passes_ms": t["bwd_passes_ms"]}

    for name, shape in (("bert", SWIGLU_BERT), ("hubert", SWIGLU_HUBERT)):
        T, d, f = shape
        dtype = torch.bfloat16
        x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
        wg, wu = ((0.02 * torch.randn(d, f, generator=gen, device="cuda")).to(dtype)
                  for _ in range(2))
        dout = torch.randn(T, f, generator=gen, device="cuda").to(dtype)
        what = f"swiglu {name} {shape}"
        ops.reset_launch_counts()
        err = _check_kernel(lambda a, b, c: ops.swiglu(a, b, c),
                            lambda a, b, c: ops.swiglu(a, b, c, impl="ref"),
                            (x, wg, wu), dout, what)
        counts = ops.launch_counts()
        if (counts["swiglu_wgmma"], counts["swiglu_bwd_wgmma"]) != (1, 1):
            raise AssertionError(f"{what}: expected the wgmma route, launches {counts}")
        t = _swiglu_timing(gen, flush, dtype, shape)
        recs[f"swiglu_{name}"] = _record(t["fwd"], err["out"])
        recs[f"swiglu_bwd_{name}"] = _record(t["bwd"], err["grad"])
        detail[f"swiglu_{name}"] = {"shape": shape, "simt_ms": t["simt"]}

    recs["decode_attention_internvl2"], detail["decode_internvl2"] = _decode_case(
        gen, flush, INTERNVL2_DECODE)
    detail["decode_internvl2"]["shape"] = INTERNVL2_DECODE
    _, detail["decode_gemma3_global"] = _decode_case(
        gen, flush, GEMMA3_DECODE, timed=(torch.bfloat16, torch.float32))
    detail["decode_gemma3_global"]["shape"] = GEMMA3_DECODE
    return recs, detail


def _tracked_training(cfg, spec: dict, params, optimizer, *, checker=None,
                      profile_step: int = -1) -> dict:
    """``run_plan`` of ``spec``'s plan with the kernels on, its stage
    workers tracked: ``checker`` (a CallChecker) installed for step 0 only,
    the replicas compared after each step, launches counted per step, and
    with ``profile_step`` >= 0 that step under ``device_profiler``."""
    torch.use_deterministic_algorithms(True)   # replicas must stay bit-identical
    prof, plat, config, M = train_setup(cfg, spec)
    batches = train_batches(cfg, spec, spec["d"], spec["steps"])
    marks, counts, replicas_ok, window = [], [], [], {}

    def batch_fn(k):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(ops.launch_counts())
        if k > 0:
            replicas_ok.append(replicas_identical(workers))
        if checker is not None:
            (checker.install if k == 0 else checker.remove)()
        if k == profile_step:
            window["prof"] = device_profiler()
            window["prof"].start()
        elif "prof" in window and "busy" not in window:
            window["prof"].stop()
            window["busy"] = device_busy(window["prof"])
        return batches[k]

    execution = Execution(cfg=cfg, optimizer=optimizer, init_params=params,
                          batch_fn=batch_fn, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        with tracked_workers() as workers:
            res = run_plan(prof, plat, config, M, steps=spec["steps"], pipelined_sync=True,
                           execution=execution)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            counts.append(ops.launch_counts())
            replicas_ok.append(replicas_identical(workers))
    finally:
        if checker is not None:
            checker.remove()
    if "prof" in window and "busy" not in window:
        window["prof"].stop()
        window["busy"] = device_busy(window["prof"])
    if not all(replicas_ok) or len(replicas_ok) != spec["steps"]:
        raise AssertionError(f"replicas differ after a step: {replicas_ok}")
    if not all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    walls = [b - a for a, b in zip(marks, marks[1:])]
    out = {"res": res, "batches": batches, "execution": execution,
           "plan": (prof, plat, config, M), "step_wall_s": walls,
           "launches_per_step": [{k: b[k] - a[k] for k in a} for a, b in zip(counts, counts[1:])],
           "launches": counts[-1], "peak": torch.cuda.max_memory_allocated()}
    if "busy" in window:
        busy, wall = window["busy"], walls[profile_step]
        out["profiled_step"] = {"step": profile_step, "wall_s": wall, **busy,
                                "device_idle_share": 1.0 - busy["kernel_union_s"] / wall}
    return out


def phase_train_bert(smi: str) -> dict:
    """bert-large at full width cut to 12 layers (``TRAIN_BERT``), bf16,
    seed 0: 2 stages of 6 layers x 2 replicas, 2 micro-batches of 4 x 512
    tokens, AdamW, 2 steps through ``run_plan(..., use_kernels=True)``.  Its
    loss is the encoder's masked prediction (no shift) and its attention
    has no mask: 48 + 48 flash attention and 48 + 48 swiglu launches a step,
    all on the wgmma route and none causal; in step 1 every call held
    against ``impl="ref"``; finite losses, the first within 2e-2 of the same
    plan with the kernels' plain versions; replicas bit-identical; store
    drained (``run_plan`` checks it); step times and peak memory."""
    spec = TRAIN_BERT
    cfg = dataclasses.replace(get_config("bert-large"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    per_step = spec["d"] * spec["mu"] * cfg.n_layers
    checker = CallChecker()
    run = _tracked_training(cfg, spec, params, AdamW(lr=1e-4), checker=checker)
    res = run.pop("res")
    expect = _expected_launches(per_step, "wgmma", "wgmma", adamw=_workers(run["plan"][2]))
    if any(c != expect for c in run["launches_per_step"]):
        raise AssertionError(f"launches per step {run['launches_per_step']}, expected {expect}")
    if checker.failures:
        raise AssertionError(f"kernel calls disagree with impl='ref': {checker.failures[:5]}")
    want = {"flash_attention": per_step, "swiglu": per_step}
    if checker.calls != want or checker.grads != {k: 3 * v for k, v in want.items()} \
            or checker.causal != {False: per_step}:
        raise AssertionError(f"checked {checker.calls} calls, {checker.grads} gradients, "
                             f"causal {checker.causal}")
    losses, store, t_iter = res.losses, res.store_stats.as_dict(), res.t_iter
    del res
    prof, plat, config, M = run["plan"]
    batches = run["batches"]
    with training_kernels_as_plain():
        plain = run_plan(prof, plat, config, M, steps=spec["steps"], pipelined_sync=True,
                         execution=dataclasses.replace(run["execution"],
                                                       batch_fn=lambda k: batches[k]))
    losses_plain = plain.losses
    del plain
    if abs(losses[0] - losses_plain[0]) > 2e-2:
        raise AssertionError(f"first loss {losses[0]} on the kernel path, "
                             f"{losses_plain[0]} with the kernels' plain versions")
    emit({"phase": "train_bert", "card": smi, "model": "bert-large", "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "params": n_params, "causal": cfg.causal,
          "is_encoder": cfg.is_encoder, "stages": 2, "d": spec["d"], "mu": spec["mu"],
          "micro_batch": spec["micro_batch"], "seq": spec["seq"], "steps": spec["steps"],
          "optimizer": "AdamW(lr=1e-4)", "losses": losses,
          "losses_kernels_as_plain": losses_plain, "ln_vocab": float(np.log(cfg.vocab_size)),
          "t_iter_virtual_s": t_iter, "store": store,
          "launches_per_step": run["launches_per_step"],
          "launches_by_route": _launches_by_route(run["launches"]),
          "checked_calls": checker.calls, "checked_gradients": checker.grads,
          "flash_calls_by_causal": {str(k): v for k, v in checker.causal.items()},
          "call_max_abs_err": checker.out_err, "grad_max_abs_err": checker.grad_err,
          "replicas_bit_identical": True, "store_drained": True,
          "step_wall_s": run["step_wall_s"], "max_memory_allocated_bytes": run["peak"]})
    launches = run["launches"]
    del params, run, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_hubert(smi: str) -> dict:
    """hubert-xlarge at full width cut to 24 layers (``HUBERT_BATCH``),
    bf16, seed 0: the audio model's entry point, ``registry.loss_fn(...,
    use_kernels=True)``, on a frames batch of 2 x 1024 (the stage workers
    refuse frontends in both packages), then its backward: 24 + 24 flash
    attention launches at hd 80 with no mask and 24 + 24 swiglu, all on the
    wgmma route, every call and gradient held against ``impl="ref"``; the
    loss within 2e-2 of the kernels' plain versions'; the unused ``embed``
    gets no gradient (exactly zero, as ``jax.grad`` gives); one SGD step
    lowers the loss (``tests/test_smoke_archs.py:20-46``; its lr 0.05
    first, then smaller ones until one does).  Times and peak memory."""
    spec = HUBERT_BATCH
    cfg = dataclasses.replace(get_config("hubert-xlarge"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    leaves = tree_leaves(params)
    n_params = sum(a.numel() for a in leaves)
    batch = {k: v.cuda() for k, v in make_batch(
        cfg, InputShape("train", spec["seq"], spec["batch"], "train"), seed=0,
        device="cpu").items()}
    for a in leaves:
        a.requires_grad_()
    checker = CallChecker()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    checker.install()
    try:
        t0 = time.perf_counter()
        loss, metrics = registry.loss_fn(cfg, params, batch, use_kernels=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        checker.remove()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    expect = _expected_launches(n, "wgmma", "wgmma")
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if checker.failures:
        raise AssertionError(f"kernel calls disagree with impl='ref': {checker.failures[:5]}")
    want = {"flash_attention": n, "swiglu": n}
    if checker.calls != want or checker.grads != {k: 3 * v for k, v in want.items()} \
            or checker.causal != {False: n}:
        raise AssertionError(f"checked {checker.calls} calls, {checker.grads} gradients, "
                             f"causal {checker.causal}")
    embed_at = next(i for i, a in enumerate(leaves) if a is params["embed"])
    if grads[embed_at] is not None:
        raise AssertionError("the unused embedding got a gradient")
    missing = [i for i, g in enumerate(grads) if g is None and i != embed_at]
    if missing or not all(torch.isfinite(g).all() for g in grads if g is not None):
        raise AssertionError(f"gradients missing at {missing} or not finite")
    loss = float(loss.detach())
    with torch.no_grad(), training_kernels_as_plain():
        loss_plain = float(registry.loss_fn(cfg, params, batch, use_kernels=True)[0])
    if not np.isfinite(loss) or abs(loss - loss_plain) > 2e-2:
        raise AssertionError(f"loss {loss} on the kernel path, {loss_plain} with the "
                             "kernels' plain versions")
    from repro_torch.models.common import tree_unflatten

    stepped_losses = {}
    with torch.no_grad():
        for lr in spec["lrs"]:
            stepped = [a if g is None else (a.float() - lr * g.float()).to(a.dtype)
                       for a, g in zip(leaves, grads)]
            stepped_losses[lr] = float(registry.loss_fn(
                cfg, tree_unflatten(params, stepped), batch, use_kernels=True)[0])
            del stepped
            if stepped_losses[lr] < loss:
                break
    del grads
    if not min(stepped_losses.values()) < loss:
        raise AssertionError(f"no SGD step along the gradient lowered the loss {loss}: "
                             f"{stepped_losses}")
    emit({"phase": "train_hubert", "card": smi, "model": "hubert-xlarge",
          "dtype": cfg.param_dtype, "n_layers": n, "params": n_params,
          "frontend": cfg.frontend, "causal": cfg.causal, "batch": spec["batch"],
          "seq": spec["seq"], "loss": loss, "ce": float(metrics["ce"].detach()),
          "loss_kernels_as_plain": loss_plain, "ln_vocab": float(np.log(cfg.vocab_size)),
          "loss_after_sgd_step_by_lr": stepped_losses, "launches": launches,
          "checked_calls": checker.calls, "checked_gradients": checker.grads,
          "flash_calls_by_causal": {str(k): v for k, v in checker.causal.items()},
          "call_max_abs_err": checker.out_err, "grad_max_abs_err": checker.grad_err,
          "embed_gradient": "none (exactly zero)", "forward_checked_s": t1 - t0,
          "backward_checked_s": t2 - t1, "max_memory_allocated_bytes": peak})
    del params, leaves, batch
    torch.cuda.empty_cache()
    return launches


def _xlstm_recurrent_parity() -> dict:
    """JAX's test_mlstm_chunked_vs_recurrent at xlstm-125m's full width in
    fp32 on the card: ``mlstm_forward`` over 2 x 512 tokens (two chunks)
    against ``mlstm_decode`` stepped over the same sequence, outputs and the
    final (C, n, m) at 3e-4 x max|ref|; ``slstm_forward``'s final state
    against ``slstm_decode``'s after the same steps, and its outputs."""
    cfg = dataclasses.replace(get_config("xlstm-125m"), param_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, S = 2, 512
    x = 0.5 * torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
    out = {}
    for kind, init_p, init_c, fwd, dec in (
            ("mlstm", xlstm_mod.init_mlstm_params, xlstm_mod.init_mlstm_cache,
             xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode),
            ("slstm", xlstm_mod.init_slstm_params, xlstm_mod.init_slstm_cache,
             xlstm_mod.slstm_forward, xlstm_mod.slstm_decode)):
        p = {k: v[0] for k, v in init_p(gen, cfg, torch.float32, 1).items()}
        stacked = init_c(1, B, cfg, torch.float32, "cuda")
        cache = type(stacked)(*(a[0] for a in stacked))
        with torch.no_grad():
            par, state = fwd(p, x, cfg=cfg, return_state=True)
            t0 = time.perf_counter()
            rec = torch.cat([dec(p, x[:, t:t + 1], cache, cfg=cfg)[0] for t in range(S)], dim=1)
            torch.cuda.synchronize()
            steps_s = time.perf_counter() - t0
        errs = {}
        for name, a, b in [("out", rec, par)] + [
                (f"state_{f}", c, s_) for f, c, s_ in zip(cache._fields, cache, state)
                if f != "conv"]:
            scale = float(b.abs().max())
            errs[name] = _close_at(a, b, 3e-4, 3e-4 * scale, f"{kind} {name}: recurrent vs "
                                   "parallel") / scale
        out[kind] = {"rel_max_abs_err": errs, "decode_steps": S, "decode_steps_s": steps_s}
    return out


def phase_train_xlstm(smi: str) -> dict:
    """xlstm-125m at full width cut to 4 layers (``TRAIN_XLSTM``), bf16,
    seed 0: 2 stages of one period (an mLSTM and an sLSTM layer) x 2
    replicas, 2 micro-batches of 4 x 512 tokens (two mLSTM chunks, so the
    carried state runs), AdamW, 1 step through ``run_plan``: no model kernel
    of the port on this path (its scans are plain PyTorch, as they are plain
    JAX), so every launch count but AdamW's (one a worker and step) stays 0;
    the first loss near ln(50304);
    finite losses; replicas bit-identical; the device's busy time and idle
    share in that step (the sLSTM's step loop is expected to keep the host
    busy).  Then the recurrent and parallel forms at full width in fp32
    (:func:`_xlstm_recurrent_parity`)."""
    spec = TRAIN_XLSTM
    cfg = dataclasses.replace(get_config("xlstm-125m"), n_layers=spec["n_layers"])
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    run = _tracked_training(cfg, spec, params, AdamW(lr=1e-4), profile_step=0)
    res = run.pop("res")
    zero = _expected_launches(0, "wgmma", "wgmma",
                              adamw=_workers(run["plan"][2]) * spec["steps"])
    if run["launches"] != zero:
        raise AssertionError(f"a kernel launched on the xLSTM path: {run['launches']}")
    ln_v = float(np.log(cfg.vocab_size))
    if abs(res.losses[0] - ln_v) > 1.0:
        raise AssertionError(f"first loss {res.losses[0]}, expected near ln(V) = {ln_v}")
    parity = _xlstm_recurrent_parity()
    emit({"phase": "train_xlstm", "card": smi, "model": "xlstm-125m", "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "params": n_params,
          "period": [[s_.mixer, s_.ff] for s_ in cfg.period], "stages": 2, "d": spec["d"],
          "mu": spec["mu"], "micro_batch": spec["micro_batch"], "seq": spec["seq"],
          "mlstm_chunks": spec["seq"] // xlstm_mod.MLSTM_CHUNK, "steps": spec["steps"],
          "optimizer": "AdamW(lr=1e-4)", "losses": res.losses, "ln_vocab": ln_v,
          "t_iter_virtual_s": res.t_iter, "store": res.store_stats.as_dict(),
          "launches": run["launches"], "replicas_bit_identical": True,
          "step_wall_s": run["step_wall_s"], "profiled_step": run["profiled_step"],
          "max_memory_allocated_bytes": run["peak"], "recurrent_vs_parallel_fp32": parity})
    del params, run, res
    torch.cuda.empty_cache()
    return zero


def phase_serve_xlstm(smi: str) -> dict:
    """xlstm-125m at full depth (12 layers), bf16, seed 0, served through
    ``run_serve_plan(..., use_kernels=True)`` on emulated, 2 stages of 3
    periods, batch 4, 512 + 16 tokens: tokens bit-identical to the
    monolithic loop; the mLSTM (C, n, m, conv) and sLSTM (c, n, m, h) caches
    cross the store every round, exactly 57,250,176 bytes a round (JAX's
    sizes); no kernel launch (no attention); prefill and round times and a
    profiled decode round."""
    torch.use_deterministic_algorithms(True)
    spec = SERVE_XLSTM
    model = "xlstm-125m"
    cfg = arch_config_for_model(model)
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    plan = manual_serve_plan(model, cuts=(6,), **spec)
    prompt = make_prompt(cfg, spec["batch"], spec["prefill_tokens"], seed=0)
    s_ctx = spec["prefill_tokens"] + spec["new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_serve_plan(plan, params=params, prompt=prompt, use_kernels=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the xLSTM serve path: {launches}")
    mono = reference_decode(cfg, params, prompt, spec["new_tokens"], use_kernels=True)
    if not np.array_equal(res.tokens, mono):
        raise AssertionError(f"pipelined tokens differ from the monolithic loop:\n"
                             f"{res.tokens}\n{mono}")
    caches = registry.init_decode_caches(cfg, spec["batch"], s_ctx, device="meta")
    by_kind = {type(c).__name__: sum(a.numel() * a.element_size() for a in c) for c in caches}
    per_round = sum(by_kind.values())
    kv_store = res.store_stats.class_bytes_in["kv"]
    if per_round != XLSTM_CACHE_BYTES_PER_ROUND or \
            kv_store != spec["new_tokens"] * XLSTM_CACHE_BYTES_PER_ROUND:
        raise AssertionError(f"{kv_store} cache bytes put in the store, {per_round} a round; "
                             f"expected {spec['new_tokens']} x {XLSTM_CACHE_BYTES_PER_ROUND}")
    decode_profile = profile_decode(cfg, params, prompt, res.tokens, s_ctx=s_ctx)
    emit({"phase": "serve_xlstm", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "params": n_params, "stages": plan.n_stages, **spec,
          "s_ctx": s_ctx, "kernel_launches": launches, "tokens_match_monolithic": True,
          "cache_bytes_per_round": per_round, "cache_bytes_per_round_by_kind": by_kind,
          "store_cache_bytes_in": kv_store, "kv_bytes_estimate": list(res.kv_bytes),
          "store": res.store_stats.as_dict(), "t_request_virtual_s": res.t_request,
          "prefill_wall_s": res.round_wall_s[0],
          "decode_round_wall_s": list(res.round_wall_s[1:]),
          "decode_round_wall_s_median": statistics.median(res.round_wall_s[1:]),
          "max_memory_allocated_bytes": peak, "decode_profile": decode_profile,
          "tokens_head": res.tokens[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_serve_internvl2(smi: str) -> int:
    """internvl2-26b at full width cut to 8 layers (``@layers8``: 4.26 B
    params), bf16, seed 0: the monolithic ``registry.prefill`` of a
    1024-token prompt whose first 256 positions are patch embeddings, then
    15 ``decode_step(use_kernels=True)`` rounds (pipelined serving refuses
    frontends in both packages): 120 decode-attention launches at [4, 48 q,
    8 kv, 128] (G 6) over 1040 slots, each held within 2e-2 of
    ``impl="ref"`` on its real inputs (teacher-forced with the greedy
    tokens); prefill and round times, peak memory."""
    from repro_torch.models import multimodal

    torch.use_deterministic_algorithms(True)
    spec = SERVE_INTERNVL2
    model = f"internvl2-26b@layers{INTERNVL2_LAYERS}"
    cfg = arch_config_for_model(model)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_params(cfg, gen, device="cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    prompt = make_prompt(cfg, spec["batch"], spec["prefill_tokens"], seed=0)
    image = multimodal.synth_patch_embeds(gen, cfg, spec["batch"])
    s_ctx = spec["prefill_tokens"] + spec["new_tokens"]
    toks = torch.from_numpy(prompt).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = registry.prefill(cfg, params, {"tokens": toks, "image_embeds": image},
                                      capacity=s_ctx)
    out = [greedy_token(logits)]
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    for _ in range(1, spec["new_tokens"]):
        t0 = time.perf_counter()
        logits, caches = registry.decode_step(cfg, params, caches, out[-1], use_kernels=True)
        out.append(greedy_token(logits))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = ops.launch_counts()["decode_attention"]
    peak = torch.cuda.max_memory_allocated()
    expect = (spec["new_tokens"] - 1) * n_layers_of(cfg, mixer=ATTN)
    if launches != expect:
        raise AssertionError(f"decode_attention launched {launches} times, expected {expect}")
    tokens = torch.cat(out, dim=1).cpu().numpy()
    del caches
    tf = teacher_forced(cfg, params, prompt, tokens, s_ctx=s_ctx, call_tol=2e-2,
                        image_embeds=image)
    emit({"phase": "serve_internvl2", "card": smi, "model": model, "dtype": cfg.param_dtype,
          "n_layers": cfg.n_layers, "reduced": {"n_layers": [48, cfg.n_layers]},
          "params": n_params, "frontend": cfg.frontend,
          "n_frontend_tokens": cfg.n_frontend_tokens, **spec, "s_ctx": s_ctx,
          "kernel_launches": launches, "teacher_forced_bf16": tf,
          "prefill_wall_s": walls[0], "decode_round_wall_s": walls[1:],
          "decode_round_wall_s_median": statistics.median(walls[1:]),
          "max_memory_allocated_bytes": peak, "tokens_head": tokens[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches

# --------------------------------------------------------------- the mesh path
MESH_TRAIN = dict(TRAIN)        # train_full's model, batch (2 x 2 x 2 x 1024) and steps
MESH_SGD_LR = 1.0               # large enough that one step moves bf16 weights visibly
MESH_RANKS = 4                  # four ranks share the card, each its own CUDA context


def _param_digest(params) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _rel_err(got, want) -> dict:
    """Per leaf max |got - want| over max |want|: the worst leaf's index and
    ratio."""
    worst = (-1, 0.0)
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        scale = max(float(b.float().abs().max()), 1e-30)
        r = float((a.float() - b.float()).abs().max()) / scale
        if r > worst[1]:
            worst = (i, r)
    return {"leaf": worst[0], "max_abs_err_over_max_ref": worst[1]}


def _mesh_layers(cfg, plan) -> int:
    """Real layers one rank of ``plan`` holds."""
    return int(sharding.layer_mask_array(cfg, plan)[0].sum())


def _mesh_train_rank(mesh, cfg, plan, spec: dict, optimizer, alt_ring: bool,
                     sgd_ref) -> dict:
    """One rank of train_mesh: ``spec["steps"]`` steps of ``optimizer`` on
    train_full's batches with the kernels, each step's wall time,
    collectives and parameter digest; with ``alt_ring`` the last step again
    from the state before it on the unidirectional ring; with ``sgd_ref``
    (the single-process SGD step's parameters, a file) one SGD step from
    the initial state held against it."""
    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    shape = InputShape("train", spec["seq"], spec["d"] * spec["mu"] * spec["micro_batch"],
                       "train")

    def batch(k):
        b = make_batch(cfg, shape, seed=0, step=k, device="cpu")
        return local_batch({n: v.to(dev) for n, v in b.items()}, plan, mesh)

    def fresh(opt):
        base = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                    device=dev)
        state = make_train_state(cfg, plan, mesh, base, opt)
        del base
        torch.cuda.empty_cache()
        return state

    params, opt = fresh(optimizer)
    step = make_train_step(cfg, plan, mesh, optimizer, bidirectional=True, use_kernels=True)
    out = {"rank": mesh.rank, "d": mesh.d, "m": mesh.m, "losses": [], "step_wall_s": [],
           "collectives": [], "digests": [],
           "axis_sizes": {name: axis.size for name, axis in mesh.axes.items()}}
    snapshot = None
    ops.reset_launch_counts()
    for k in range(spec["steps"]):
        if alt_ring and k == spec["steps"] - 1:
            snapshot = (tree_map(torch.clone, params), tree_map(torch.clone, opt))
        b = batch(k)
        mesh_cc.reset_stats()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, b, k)
        torch.cuda.synchronize(dev)
        out["step_wall_s"].append(time.perf_counter() - t0)
        out["losses"].append(metrics["loss"])
        out["collectives"].append(mesh_cc.stats())
        out["digests"].append(_param_digest(params))
    out["launches"] = ops.launch_counts()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    if snapshot is not None:
        uni = make_train_step(cfg, plan, mesh, optimizer, bidirectional=False,
                              use_kernels=True)
        p_uni, _, m_uni = uni(*snapshot, batch(spec["steps"] - 1), spec["steps"] - 1)
        out["uni_ring_last_loss"] = m_uni["loss"]
        out["bidi_vs_uni_ring"] = _rel_err(params, p_uni)
        out["uni_ring_bit_identical"] = _param_digest(p_uni) == out["digests"][-1]
        del snapshot, p_uni
    if sgd_ref is not None:
        del params, opt
        sgd = SGD(lr=MESH_SGD_LR)
        params, opt = fresh(sgd)
        params, opt, metrics = make_train_step(cfg, plan, mesh, sgd, use_kernels=True)(
            params, opt, batch(0), 0)
        ref = sharding.local_params(cfg, plan, torch.load(sgd_ref, mmap=True),
                                    d=mesh.d, m=mesh.m)
        out["sgd_loss"] = metrics["loss"]
        out["sgd_vs_single_process"] = _rel_err(params, tree_map(lambda a: a.to(dev), ref))
    return out


def _mesh_summary(results: list, cfg, plan, spec: dict) -> dict:
    """Checks common to the mesh's training runs: finite losses equal on
    every rank, data replicas bit-identical after every step, exact launches
    (the forward's kernels twice a micro-batch under remat "tick" or
    "layer", once under "none") all on wgmma; the per-step collectives of
    each rank."""
    losses = results[0]["losses"]
    if any(r["losses"] != losses for r in results) or not all(np.isfinite(losses)):
        raise AssertionError(f"losses differ across ranks or are not finite: "
                             f"{[r['losses'] for r in results]}")
    for r in results:
        twin = next(o for o in results if o["m"] == r["m"] and o["d"] == 0)
        if r["digests"] != twin["digests"]:
            raise AssertionError(f"rank {r['rank']}'s parameters differ from its data "
                                 f"replica's after a step")
    L = _mesh_layers(cfg, plan)
    calls = L * plan.microbatches * spec["steps"]
    fwd = calls * (1 if plan.remat == "none" else 2)
    for r in results:
        _wgmma_only(r["launches"], f"mesh rank {r['rank']}")
        for name in FP32_WAYS:
            if (r["launches"][name], r["launches"][f"{name}_bwd"]) != (fwd, calls):
                raise AssertionError(f"rank {r['rank']}: {name} launched "
                                     f"{r['launches'][name]} + {r['launches'][f'{name}_bwd']},"
                                     f" expected {fwd} + {calls}")
    return {"plan": dataclasses.asdict(plan), "losses": losses,
            "replicas_bit_identical": [True] * spec["steps"],
            "step_wall_s_by_rank": [r["step_wall_s"] for r in results],
            "collectives_per_step_by_rank": [r["collectives"] for r in results],
            "max_memory_allocated_bytes_by_rank":
                [r["max_memory_allocated_bytes"] for r in results],
            "launches_by_rank": [_launches_by_route(r["launches"]) for r in results]}


def _train_mesh_jobs(spec: dict):
    """train_mesh's preparation: the single-process SGD step with the plain
    versions (its parameters to a file the ranks read) and the jobs of (a)
    and (b)."""
    base_cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=spec["n_layers"])
    shape = InputShape("train", spec["seq"], spec["d"] * spec["mu"] * spec["micro_batch"],
                       "train")
    params = registry.init_params(base_cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    batch0 = {k: v.cuda() for k, v in make_batch(base_cfg, shape, seed=0, device="cpu").items()}
    t0 = time.perf_counter()
    ref_new, ref_loss, _ = reference_step(base_cfg, params, batch0, SGD(lr=MESH_SGD_LR))
    torch.cuda.synchronize()
    ctx = {"cfg": base_cfg, "shape": shape, "ref_loss": ref_loss,
           "t_ref": time.perf_counter() - t0,
           "n_params": sum(a.numel() for a in tree_leaves(params)),
           # how far the step moves the weights: its largest change over the
           # largest weight (a zero-initialised norm has no scale of its own)
           "update": (max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(tree_leaves(ref_new), tree_leaves(params)))
                      / max(float(b.float().abs().max()) for b in tree_leaves(params)))}
    TRACE_DIR.parent.mkdir(parents=True, exist_ok=True)
    ctx["ref_path"] = str(TRACE_DIR.parent / "mesh_sgd_ref.pt")
    torch.save(tree_map(lambda a: a.cpu(), ref_new), ctx["ref_path"])
    del params, ref_new, batch0
    torch.cuda.empty_cache()
    jobs, ctx["meshes"] = [], {}
    for name, (data, stages, tensor, mu) in {"a": (2, 2, 1, 2), "b": (1, 2, 2, 4)}.items():
        cfg = dataclasses.replace(base_cfg, stages=stages, tensor=tensor)
        plan = make_plan(cfg, shape, data=data, model=stages * tensor, microbatches=mu)
        ctx["meshes"][name] = (cfg, plan)
        jobs.append((_mesh_train_rank,
                     MeshShape(data=data, model=stages * tensor, tensor=tensor,
                               kv_heads=cfg.n_kv_heads),
                     (cfg, plan, spec, AdamW(lr=1e-4), name == "a",
                      ctx["ref_path"] if name == "b" else None)))
    return jobs, ctx


def _train_mesh_report(smi: str, spec: dict, ctx: dict, outs: list, wall: float) -> dict:
    """train_mesh's holds and its line: (a)'s first loss within 2e-2 of
    train_full's and of the single-process plain loss, (b)'s within 2e-2 of
    (a)'s, the rings' step 2 and (b)'s SGD step within 2e-2 x max|ref|."""
    a, b = (_mesh_summary(o, *ctx["meshes"][k], spec) for k, o in zip("ab", outs))
    full_first = RESULTS.get("train_full_losses", [None])[0]
    for want, what in ((full_first, "train_full's first loss"),
                       (ctx["ref_loss"], "the single-process plain loss")):
        if want is not None and abs(a["losses"][0] - want) > 2e-2:
            raise AssertionError(f"(a)'s first loss {a['losses'][0]} vs {what} {want}")
    if abs(b["losses"][0] - a["losses"][0]) > 2e-2:
        raise AssertionError(f"(b)'s first loss {b['losses'][0]} vs (a)'s {a['losses'][0]}")
    rings = [r["bidi_vs_uni_ring"] for r in outs[0]]
    if max(r["max_abs_err_over_max_ref"] for r in rings) > 2e-2:
        raise AssertionError(f"the rings' step-2 parameters differ past the bf16 bar: {rings}")
    sgd = [r["sgd_vs_single_process"] for r in outs[1]]
    if max(r["max_abs_err_over_max_ref"] for r in sgd) > 2e-2:
        raise AssertionError(f"(b)'s SGD step differs from the single-process step: {sgd}")
    launches = {k: sum(r["launches"][k] for o in outs for r in o)
                for k in ("flash_attention", "flash_attention_bwd", "swiglu", "swiglu_bwd")}
    cfg = ctx["cfg"]
    emit({"phase": "train_mesh", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "params": ctx["n_params"],
          "ranks": MESH_RANKS, "transport": mesh_cc.TRANSPORT, "seq": spec["seq"],
          "global_batch": ctx["shape"].global_batch, "optimizer": "AdamW(lr=1e-4)",
          "remat": "tick", "world_wall_s": wall,
          "first_loss_train_full": full_first,
          "first_loss_single_process_plain": ctx["ref_loss"],
          "single_process_sgd_step_s": ctx["t_ref"],
          "a_data2_model2": {**a, "ring": "bidirectional",
                             "step2_uni_ring_loss": outs[0][0]["uni_ring_last_loss"],
                             "step2_bidi_vs_uni_ring_by_rank": rings,
                             "step2_uni_ring_bit_identical":
                                 [r["uni_ring_bit_identical"] for r in outs[0]]},
          "b_data1_model4_tp2": {**b, "sgd_lr": MESH_SGD_LR,
                                 "sgd_loss": outs[1][0]["sgd_loss"],
                                 "sgd_single_process_update_over_max_param": ctx["update"],
                                 "sgd_vs_single_process_by_rank": sgd},
          "kernel_launches": launches})
    return launches


PLAN_AUTO_MESH = dict(data=2, model=2)   # four ranks of the card
PLAN_AUTO_TOP = 5


def _plan_auto_jobs(spec: dict, ctx: dict):
    """plan_auto's preparation: the port's ``tpu_planner.solve`` for
    train_full's model and batch on data 2 x model 2 with the H100's
    constants (80e9 / 4 bytes a rank), and the job that trains its first
    plan; where that plan is neither of train_mesh's (a) and (b), the job
    also takes one SGD step held against the single-process step that
    ``_train_mesh_jobs`` saved."""
    base_cfg, shape = ctx["cfg"], ctx["shape"]
    chip = roofline.h100(MESH_RANKS)
    t0 = time.perf_counter()
    results = tpu_planner.solve(base_cfg, shape, chip=chip, **PLAN_AUTO_MESH)
    solve_s = time.perf_counter() - t0
    if not results:
        raise AssertionError(f"plan_auto: no plan fits {chip.hbm_bytes} bytes a rank")
    p = results[0].plan
    print(f"[plan auto] S={p.stages} tp={p.tensor} mu={p.microbatches} remat={p.remat} "
          f"(est {results[0].t_step_est*1e3:.1f} ms/step)", flush=True)
    cfg, plan = dataclasses.replace(base_cfg, stages=p.stages, tensor=p.tensor), p
    known = {(2, 2, 1, 2, "tick"): "a", (1, 2, 2, 4, "tick"): "b"}
    same_as = known.get((p.data, p.stages, p.tensor, p.microbatches, p.remat))
    pctx = {"chip": chip, "cfg": cfg, "plan": plan, "results": results, "solve_s": solve_s,
            "same_as": same_as,
            "analytic": roofline.analytic_roofline(cfg, shape, plan, chip=chip),
            "argument_bytes": dryrun.argument_bytes(cfg, shape, plan)}
    job = (_mesh_train_rank,
           MeshShape(data=plan.data, model=plan.model_axis, tensor=plan.tensor,
                     kv_heads=cfg.n_kv_heads),
           (cfg, plan, spec, AdamW(lr=1e-4), False,
            ctx["ref_path"] if same_as is None else None))
    return job, pctx


def _plan_auto_report(smi: str, spec: dict, ctx: dict, pctx: dict, outs: list) -> dict:
    """plan_auto's holds and its line: the first loss within 2e-2 of
    train_full's, replicas bit-identical, every launch on wgmma (in
    ``_mesh_summary``), the SGD step within 2e-2 x max|ref| where it ran;
    reported beside each other, not held: the analytic step time and the
    measured second step, the analytic collective bytes and the issued
    ones (each rank's ``cc.stats()`` of step 2 as a roofline), the
    planner's memory estimate, the dry run's argument bytes and each
    rank's peak."""
    cfg, plan, chip, analytic = pctx["cfg"], pctx["plan"], pctx["chip"], pctx["analytic"]
    summary = _mesh_summary(outs, cfg, plan, spec)
    full_first = RESULTS.get("train_full_losses", [None])[0]
    if full_first is not None and abs(summary["losses"][0] - full_first) > 2e-2:
        raise AssertionError(f"plan_auto's first loss {summary['losses'][0]} vs "
                             f"train_full's {full_first}")
    sgd = None
    if pctx["same_as"] is None:
        sgd = [r["sgd_vs_single_process"] for r in outs]
        if max(r["max_abs_err_over_max_ref"] for r in sgd) > 2e-2:
            raise AssertionError(f"plan_auto's SGD step differs from the single-process "
                                 f"step: {sgd}")
    issued = [roofline.issued_roofline(r["collectives"][-1], r["axis_sizes"],
                                       flops=analytic.flops, hbm_bytes=analytic.hbm_bytes,
                                       bubble_factor=analytic.bubble_factor, chip=chip)
              for r in outs]
    second = [r["step_wall_s"][-1] for r in outs]
    collective_s = [sum(v["seconds"] for v in r["collectives"][-1].values()) for r in outs]
    launches = {k: sum(r["launches"][k] for r in outs)
                for k in ("flash_attention", "flash_attention_bwd", "swiglu", "swiglu_bwd")}

    def row(r):
        return {"plan": {k: getattr(r.plan, k) for k in ("stages", "tensor", "microbatches",
                                                          "remat")},
                "t_step_est_s": r.t_step_est, "hbm_est_bytes": r.hbm_est,
                "objective": r.objective}

    emit({"phase": "plan_auto", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg.param_dtype, "n_layers": cfg.n_layers, "ranks": MESH_RANKS,
          "mesh": PLAN_AUTO_MESH, "seq": spec["seq"], "global_batch": ctx["shape"].global_batch,
          "optimizer": "AdamW(lr=1e-4)", "transport": mesh_cc.TRANSPORT,
          "solver": {"chip": chip.name, "chip_constants": dataclasses.asdict(chip),
                     "feasible_plans": len(pctx["results"]), "solve_s": pctx["solve_s"],
                     f"top{PLAN_AUTO_TOP}": [row(r) for r in pctx["results"][:PLAN_AUTO_TOP]]},
          "same_as_train_mesh": pctx["same_as"],
          **summary, "first_loss_train_full": full_first,
          "sgd_lr": MESH_SGD_LR if sgd is not None else None,
          "sgd_vs_single_process_by_rank": sgd,
          "step_time": {"analytic_t_step_est_s": analytic.t_step_est,
                        "analytic_terms_s": {"compute": analytic.t_compute,
                                             "memory": analytic.t_memory,
                                             "collective": analytic.t_collective,
                                             "bubble_factor": analytic.bubble_factor},
                        "measured_second_step_s_by_rank": second,
                        "measured_collective_s_by_rank": collective_s,
                        "issued_t_step_est_s_by_rank": [r.t_step_est for r in issued]},
          "collective_bytes": {"analytic_by_kind": analytic.collective_bytes_by_kind,
                               "analytic_link_bytes": analytic.link_bytes,
                               "issued_by_kind_by_rank":
                                   [r.collective_bytes_by_kind for r in issued],
                               "issued_counts_by_rank": [r.collective_counts for r in issued],
                               "issued_link_bytes_by_rank": [r.link_bytes for r in issued]},
          "memory": {"hbm_est_bytes": pctx["results"][0].hbm_est,
                     "dryrun_argument_bytes": pctx["argument_bytes"]["total"],
                     "dryrun_argument_bytes_by_part":
                         {k: v for k, v in pctx["argument_bytes"].items() if k != "total"},
                     "max_memory_allocated_bytes_by_rank":
                         summary["max_memory_allocated_bytes_by_rank"]},
          "kernel_launches": launches})
    return launches


def _mesh_serve_rank(mesh, cfg, plan, prompt_np, new_tokens: int, teacher) -> dict:
    """One rank of serve_mesh: prefill then ``new_tokens - 1`` decode
    rounds with the kernels; greedy, or fed ``teacher``'s tokens."""
    dev = mesh.device
    torch.cuda.empty_cache()
    base = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = sharding.local_params(cfg, plan, base, d=mesh.d, m=mesh.m)
    del base
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prompt = torch.from_numpy(prompt_np).to(dev)
    s_ctx = prompt.shape[1] + new_tokens
    prefill = mesh_serve.make_prefill_step(cfg, plan, mesh, capacity=s_ctx)
    decode = mesh_serve.make_decode_step(cfg, plan, mesh, use_kernels=True)
    ops.reset_launch_counts()
    mesh_cc.reset_stats()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize(dev)
    out = {"rank": mesh.rank, "prefill_wall_s": time.perf_counter() - t0,
           "decode_round_wall_s": []}
    toks, steps = [greedy_token(logits)], [logits]
    for r in range(new_tokens - 1):
        inp = toks[-1] if teacher is None else torch.from_numpy(teacher[:, r:r + 1]).to(dev)
        t0 = time.perf_counter()
        logits, caches = decode(params, caches, inp)
        torch.cuda.synchronize(dev)
        out["decode_round_wall_s"].append(time.perf_counter() - t0)
        toks.append(greedy_token(logits))
        steps.append(logits)
    out["launches"] = ops.launch_counts()["decode_attention"]
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["collectives"] = mesh_cc.stats()
    out["tokens"] = torch.cat(toks, dim=1).cpu().numpy()
    if mesh.rank == 0:
        out["logits"] = torch.stack(steps).float().cpu().numpy()
    return out


def _serve_mesh_jobs(tokens: np.ndarray):
    """serve_mesh's jobs: 4 stages x tp 1 (greedy) and 2 stages x tp 2 fed
    ``tokens``, each with one micro-batch."""
    cfg0 = arch_config_for_model("phi3-mini-3.8b")
    prompt_np = make_prompt(cfg0, SERVE["batch"], SERVE["prefill_tokens"], seed=0)
    shape = InputShape("serve", SERVE["prefill_tokens"] + SERVE["new_tokens"],
                       SERVE["batch"], "decode")
    jobs, plans = [], {}
    for name, (stages, tensor) in {"tp1": (4, 1), "tp2": (2, 2)}.items():
        cfg = dataclasses.replace(cfg0, stages=stages, tensor=tensor)
        plans[name] = make_plan(cfg, shape, data=1, model=4, microbatches=1)
        jobs.append((_mesh_serve_rank,
                     MeshShape(data=1, model=4, tensor=tensor, kv_heads=cfg.n_kv_heads),
                     (cfg, plans[name], prompt_np, SERVE["new_tokens"],
                      None if name == "tp1" else np.asarray(tokens))))
    return jobs, {"cfg": cfg0, "plans": plans, "s_ctx": shape.seq_len}


def _serve_mesh_report(smi: str, ctx: dict, tp1: list, tp2: list, tokens: np.ndarray,
                       wall: float) -> int:
    """serve_mesh's holds and its line: every rank's tokens equal, 4 x 1's
    equal to serve_full's, exact decode-attention launches; 2 x 2's tokens
    and largest logit drift reported."""
    cfg0 = ctx["cfg"]
    for res in (tp1, tp2):
        if any(not np.array_equal(r["tokens"], res[0]["tokens"]) for r in res):
            raise AssertionError("the ranks' tokens differ")
    if not np.array_equal(tp1[0]["tokens"], tokens):
        raise AssertionError(f"4 x 1 mesh tokens differ from serve_full's:\n"
                             f"{tp1[0]['tokens']}\n{tokens}")
    expect = {"tp1": (SERVE["new_tokens"] - 1) * cfg0.n_layers // 4,
              "tp2": (SERVE["new_tokens"] - 1) * cfg0.n_layers // 2}
    for name, res in (("tp1", tp1), ("tp2", tp2)):
        if any(r["launches"] != expect[name] for r in res):
            raise AssertionError(f"{name}: decode_attention launched "
                                 f"{[r['launches'] for r in res]}, expected {expect[name]} a rank")
    drift = float(np.abs(tp2[0]["logits"] - tp1[0]["logits"]).max())
    launches = sum(r["launches"] for res in (tp1, tp2) for r in res)

    def summary(res, name):
        return {"plan": dataclasses.asdict(ctx["plans"][name]),
                "tokens_head": res[0]["tokens"][0].tolist(),
                "prefill_wall_s": max(r["prefill_wall_s"] for r in res),
                "decode_round_wall_s": [max(r["decode_round_wall_s"][i] for r in res)
                                        for i in range(SERVE["new_tokens"] - 1)],
                "decode_attention_launches_by_rank": [r["launches"] for r in res],
                "max_memory_allocated_bytes_by_rank":
                    [r["max_memory_allocated_bytes"] for r in res],
                "collectives_by_rank": [r["collectives"] for r in res]}

    emit({"phase": "serve_mesh", "card": smi, "model": "phi3-mini-3.8b",
          "dtype": cfg0.param_dtype, "n_layers": cfg0.n_layers, **SERVE, "s_ctx": ctx["s_ctx"],
          "ranks": MESH_RANKS, "transport": mesh_cc.TRANSPORT, "world_wall_s": wall,
          "stages4_tp1": {**summary(tp1, "tp1"), "tokens_match_serve_full": True},
          "stages2_tp2": {**summary(tp2, "tp2"), "fed_serve_full_tokens": True,
                          "tokens_match_serve_full":
                              bool(np.array_equal(tp2[0]["tokens"], tokens)),
                          "tokens_differing": int((tp2[0]["tokens"] != tokens).sum()),
                          "max_logit_drift_vs_tp1": drift},
          "kernel_launches": launches})
    return launches


def phase_mesh(smi: str, tokens: np.ndarray) -> tuple:
    """``train_mesh`` and ``serve_mesh`` in one world of four ranks (a world's
    start, each rank importing this script and making its CUDA context,
    costs more than a serving job): train_full's model (phi3-mini-3.8b,
    full width, 4 layers, bf16) and batches on (a) data 2 x model 2 (2
    stages, tp 1), AdamW(1e-4), 2 steps on the bidirectional ring, then step
    2 again on the unidirectional ring, and (b) data 1 x model 4 (2 stages x
    tp 2), the same steps, then one SGD step from the initial state against
    the single-process step on the card with the plain versions; then
    serve_full's request (32 layers, batch 4, 1008 + 16) on 4 stages x tp 1
    with one micro-batch (serve_full's shapes), tokens equal to serve_full's,
    and on 2 stages x tp 2 fed the same tokens, its tokens and largest logit
    drift reported (32 bf16 layers amplify a change of summation order).
    Then plan_auto (``_plan_auto_jobs``): the plan the port's solver picks
    for the same model and batch on data 2 x model 2, trained the same way.
    Returns the training kernels' launches (train_mesh's, plan_auto's) and
    decode attention's."""
    spec = MESH_TRAIN
    torch.use_deterministic_algorithms(True)
    torch.cuda.empty_cache()
    train_jobs, train_ctx = _train_mesh_jobs(spec)
    serve_jobs, serve_ctx = _serve_mesh_jobs(tokens)
    auto_job, auto_ctx = _plan_auto_jobs(spec, train_ctx)
    t0 = time.perf_counter()
    try:
        outs = run_jobs(train_jobs + serve_jobs + [auto_job], device="cuda")
    finally:
        os.remove(train_ctx["ref_path"])
    wall = time.perf_counter() - t0
    train = _train_mesh_report(smi, spec, train_ctx, outs[:2], wall)
    serve = _serve_mesh_report(smi, serve_ctx, *outs[2:4], tokens, wall)
    auto = _plan_auto_report(smi, spec, train_ctx, auto_ctx, outs[4])
    return train, serve, auto


def main() -> None:
    smi = phase_device()
    phase_build()
    recs = phase_kernel_parity(smi)
    phase_adamw(smi)
    launches = {}
    launches["decode_attention"], tokens = phase_serve_full(smi)
    process_decode = phase_serve_process(smi, tokens)
    phase_serve_reduced(smi)
    train = phase_train_full(smi)
    backends = phase_train_backends(smi)
    planned = phase_train_planned(smi)
    chaos = phase_train_chaos(smi)
    calibrated = phase_calibrate_replan(smi)
    fp32 = phase_train_fp32(smi)
    # the bf16 main path's training launches all took the wgmma kernels, the
    # fp32 path's the tf32x3 kernels
    for name, way in FP32_WAYS.items():
        launches |= {name: train[f"{name}_wgmma"], f"{name}_bwd": train[f"{name}_bwd_wgmma"],
                     f"{name}_{way}": fp32[f"{name}_{way}"],
                     f"{name}_bwd_{way}": fp32[f"{name}_bwd_{way}"]}
    # the backend phases' runs (train_backends: emulated, local, process;
    # serve_process) launch them too
    on_backends = {"decode_attention": process_decode,
                   **{name: backends[f"{name}_wgmma"] for name in FP32_WAYS},
                   **{f"{name}_bwd": backends[f"{name}_bwd_wgmma"] for name in FP32_WAYS}}
    # and the planned plan's run (train_planned), on the wgmma route too
    on_planned = {**{name: planned[f"{name}_wgmma"] for name in FP32_WAYS},
                  **{f"{name}_bwd": planned[f"{name}_bwd_wgmma"] for name in FP32_WAYS}}
    # and the chaos-recovered runs (train_chaos) and the calibrated re-plan
    # (calibrate_replan), all on the wgmma route
    on_chaos = {**{name: chaos[f"{name}_wgmma"] for name in FP32_WAYS},
                **{f"{name}_bwd": chaos[f"{name}_bwd_wgmma"] for name in FP32_WAYS}}
    on_replan = {**{name: calibrated[f"{name}_wgmma"] for name in FP32_WAYS},
                 **{f"{name}_bwd": calibrated[f"{name}_bwd_wgmma"] for name in FP32_WAYS}}
    phase_train_reduced(smi)
    # gemma3-4b's path: every flash launch at hd 256 on the wgmma route
    gemma = phase_train_gemma(smi)
    launches |= {"flash_attention_hd256": gemma["flash_attention_wgmma"],
                 "flash_attention_bwd_hd256": gemma["flash_attention_bwd_wgmma"]}
    # and in fp32: every flash launch at hd 256 on the tf32x3 route
    gemma_fp32 = phase_train_gemma_fp32(smi)
    way = FP32_WAYS["flash_attention"]
    launches |= {f"flash_attention_hd256_{way}": gemma_fp32[f"flash_attention_{way}"],
                 f"flash_attention_bwd_hd256_{way}": gemma_fp32[f"flash_attention_bwd_{way}"]}
    # the MoE and Mamba families: jamba's decode (G 4, hd 128), qwen3-moe's
    # flash attention (G 16, hd 128, wgmma); their reduced fp32 runs' launches
    # (decode attention at hd 64, flash attention and swiglu on tf32x3) count
    # in the rows of those routes
    launches["decode_attention_jamba"] = phase_serve_jamba(smi)
    jamba_reduced_decode = phase_serve_jamba_reduced(smi)
    moe = phase_train_moe(smi)
    launches |= {"flash_attention_qwen3_moe": moe["flash_attention_wgmma"],
                 "flash_attention_bwd_qwen3_moe": moe["flash_attention_bwd_wgmma"]}
    jamba_reduced = phase_train_jamba_reduced(smi)
    on_families = {"decode_attention": jamba_reduced_decode}
    for name in FP32_WAYS:
        on_families |= {f"{name}_{way}": jamba_reduced[f"{name}_{way}"],
                        f"{name}_bwd_{way}": jamba_reduced[f"{name}_bwd_{way}"]}
    # xLSTM, the encoders and the vision model: bert-large's and
    # hubert-xlarge's flash attention (no mask) and swiglu on wgmma,
    # internvl2-26b's decode (G 6); the xLSTM phases launch no kernel
    for phase, tag in ((phase_train_bert, "bert"), (phase_train_hubert, "hubert")):
        counts = phase(smi)
        for name in FP32_WAYS:
            launches |= {f"{name}_{tag}": counts[f"{name}_wgmma"],
                         f"{name}_bwd_{tag}": counts[f"{name}_bwd_wgmma"]}
    phase_train_xlstm(smi)
    phase_serve_xlstm(smi)
    launches["decode_attention_internvl2"] = phase_serve_internvl2(smi)
    # the mesh path: four ranks on the card; phi3's flash attention and
    # swiglu on wgmma, its decode attention
    on_mesh, on_mesh["decode_attention"], on_plan_auto = phase_mesh(smi, tokens)
    source = "src/repro_torch/kernels/csrc/{}.cu"
    tpu = {"decode_attention": "src/repro/kernels/decode_attention.py:68",
           "flash_attention": "src/repro/kernels/flash_attention.py:83",
           "swiglu": "src/repro/kernels/swiglu.py:57"}
    kernels = []
    for name, rec in recs.items():
        base = next(b for b in tpu if name.startswith(b))
        extra, more = on_backends.get(name, 0), on_planned.get(name, 0)
        chaotic, replanned = on_chaos.get(name, 0), on_replan.get(name, 0)
        family, mesh = on_families.get(name, 0), on_mesh.get(name, 0)
        auto = on_plan_auto.get(name, 0)
        kernels.append({"name": name, "route": "cuda", "source": source.format(base),
                        "replaces": tpu[base],
                        "launches": launches[name] + extra + more + chaotic + replanned
                        + family + mesh + auto,
                        "launches_backend_phases": extra, "launches_train_planned": more,
                        "launches_train_chaos": chaotic,
                        "launches_calibrate_replan": replanned,
                        "launches_reduced_families": family, "launches_mesh": mesh,
                        "launches_plan_auto": auto,
                        **rec})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
