"""Drive the PyTorch port on one CUDA card (an H100) and check it.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — the hand-written kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (wall time printed as set-up);
3. kernels — every distinct ResNet-34 conv at batch 8 and 224 px, and the
   FC head, in bf16 (the opt flow) and fp32 (the base flow), plus four fp32
   convs with the BN fold and ReLU (one a shape class, in no forward),
   MobileNetV1's first conv (both dtypes) and its 32-channel pointwise
   conv (bf16), and LeNet-5's two convs and its two FC layers that run on
   ``simt`` (120 -> 84, 84 -> 10; bf16, as its forward runs them): each
   records the schedule it took (conv2d_fused: ``wgmma`` in bf16, ``ffma``
   in fp32, ``small_ci`` for the stem, MobileNetV1's first conv and
   LeNet-5's convs, ``mid_ci`` for the pointwise conv), is held against its
   plain PyTorch version (relerr < 2e-2 in bf16, < 1e-5 in fp32) beside
   the old SIMT kernel at the same shape (held to it too), and is timed
   beside them, the PyTorch library call for the same function (for the
   convs one cuDNN conv on a pre-padded input, and the chain of pad, conv
   and the BN/ReLU ops; for the FC layers ``torch.matmul`` + bias (+ ReLU))
   and the card's bound for the work; the convs as CUDA-graph replays and
   by events.  The stem on ``small_ci`` must be no slower than cuDNN's
   conv alone in both flows, MobileNetV1's first conv in bf16 no slower
   than the SIMT kernel, its pointwise conv on ``mid_ci`` no slower than
   the SIMT kernel and within twice its bound (0.0116 ms); that conv is
   also timed at batch 4, 8, 16 and 32 beside cuDNN's;
4. LM kernels — at full-width llama3.2-1b shapes, in bf16 and fp32:
   ``flash_attention`` at the prefill (B=8, 512 tokens, 32 heads over 8 KV
   heads of 64, causal), recording its schedule (``wgmma`` in bf16,
   ``ffma`` in fp32), timed as CUDA-graph replays and by events beside
   the SIMT kernel at the same shape (held to the plain version too) and
   SDPA (with the name of the kernel it ran); ``decode_attention`` over a
   1024-slot cache half full, on its ``mma`` (bf16) or ``ffma`` (fp32)
   schedule, timed as CUDA-graph replays beside the SIMT kernel (forced,
   held to the plain version too) and SDPA, and
   ``matmul_fused`` at every projection of a llama layer and every
   distinct projection of recurrentgemma-2b (2560 -> 2560, 2560 ->
   256, the 2560 -> 7680 GLU pair, 7680 -> 2560), for the prefill's 4096
   rows and a decode step's 8 (in bf16 also llama's q at 128, 64 and 40
   rows and its GLU pair at 40 and 32, each timed on both tensor-core
   schedules: the crossover); each
   case records the schedule that ran, is held against its plain version
   and timed beside it, the old SIMT kernel at the same shape, the PyTorch
   call for the same function (``scaled_dot_product_attention``,
   ``torch.matmul``) and the bound.  The matmuls are timed as CUDA-graph
   replays (device time without the host's launch cost) and, at 64 rows or
   fewer, rotate over enough weight copies to read them cold from HBM, as
   a decode step does.  Then the base variant (``vmem_accum=False``, tile
   (256, 512, 256)) at the ResNet-34 FC shape and at 4096 x 2048 x 2048,
   in bf16 and fp32: the schedule it took (the CW cores: ``small_m`` /
   ``ffma_small_m`` at 8 rows, ``wgmma`` / ``ffma`` at 4096), against its
   plain version, the same bits twice, timed beside the old SIMT base
   kernel (which it must beat), the CW form at the same shape,
   ``torch.matmul`` where that is the same function, and its bound;
5. path — full-width ResNet-34 (224 px, batch 8, random weights from seed 0)
   through ``repro_torch.flow.compile`` in the opt, base and folded flows:
   the plan dispatches conv2d and matmul to ``cuda``, one forward launches
   36 convs and 1 matmul, the logits are (8, 1000), finite, and agree with
   the same model on the ``reference`` backend; then ``measure("prefill")``.
   Then LeNet-5 and MobileNetV1 at full config, with the same checks;
6. LM path — full-width llama3.2-1b (16 layers, random weights from seed
   0), ``ShapeConfig("serve", "decode", 1024, 8)``, a 512-token prompt per
   row from ``RandomState(0)``: in bf16 the plan dispatches attention,
   decode attention and both matmuls to ``cuda``; ``generate`` runs 32
   steps; one prefill and each decode step launch the kernels the plan
   says (16 flash / 96 matmul, 16 decode / 96 matmul); the prefill's and
   every teacher-forced decode step's logits agree with the ``reference``
   backend.  In fp32 the greedy tokens of 32 steps are identical to the
   reference backend's, and the fp32 prefill is timed with flash on its
   ``ffma`` schedule, forced onto the SIMT kernel, and on ``ffma`` again.
   Then ``measure("prefill")`` at 8 x 512 tokens,
   ``measure("decode")`` and a profile of each;
7. serving kernels — ``paged_decode_attention`` at the serving shape (8
   rows of ~520 live tokens in a 513-block pool of 16-token blocks, one
   query a row and five), on its ``mma`` or ``ffma`` schedule beside the
   SIMT kernel (forced, by graph),
   and ``copy_block`` on the folded 16-layer K and V
   pools (one launch a fork), in bf16 and fp32, each held against its plain
   version and timed beside it, the library yardstick (gather +
   ``scaled_dot_product_attention``; ``torch._foreach_copy_``) and the
   bound, as CUDA-graph replays and by events;
8. serving — full-width llama3.2-1b through ``repro_torch.serving.Engine.run``
   (``EngineConfig(max_batch=8, max_seq_len=1024, block_size=16)``):
   workloads A (16 prompts of 64-512 tokens), B (a shared 392-token prefix
   and a 200-token prompt served in two waves, prefix cache on: hits and a
   copy-on-write fork), C (A with chunked prefill of 16 and ``ngram:4``
   speculation) and D (A with decode segments of 8), 32 new tokens a
   request.  In bf16 each run's launches are those the plan and the run's
   ticks say (16 paged attention and 96 matmul launches a tick, one
   ``copy_block`` launch a fork for the K and V pools), A's logits agree with the reference
   backend's and a decode segment runs without a device-to-host read; in
   fp32 every workload's greedy tokens equal the reference backend's, C's
   and D's equal A's and B's equal its cold run.  Per workload: tokens/s,
   TTFT and latency percentiles, ms per tick, host syncs per token, pool
   bytes, and the device-busy share of one profiled run;
9. recurrent kernels — at full-width recurrentgemma-2b shapes, in bf16 and
   fp32: ``flash_attention`` with 10 heads
   over 1 KV head of 256 and the 2048-token window at 8 x 512 tokens and at
   one row of 2080 (the window cuts), ``decode_attention`` over the
   1024-slot and the wrapped 2048-slot cache, ``paged_decode_attention`` at
   workload R's shape (both beside their SIMT kernels); each held against
   its plain version and timed beside it, the library yardstick and the
   bound;
10. recurrent path — full-width recurrentgemma-2b (26 layers, random
   weights from seed 0), bf16 then fp32: ``generate`` of 32 tokens after a
   512-token prompt a row (``ShapeConfig("serve", "decode", 1024, 8)``) with
   the launches the plan says (8 flash + 18 lru_scan + 138 matmul a
   prefill, 8 decode + 138 matmul and no lru_scan a step), the prefill and
   every teacher-forced step's logits against the reference backend, the
   fp32 greedy tokens identical to it, in bf16 ``measure`` and
   profiles, in fp32 the prefill timed on ``ffma``, SIMT, ``ffma``; the
   window run (one row, a 2080-token prompt, 24 steps over the 2048-slot
   rolling cache) with the same checks; ``Engine.run`` on
   workload R (16 prompts of exactly 256 tokens, 16-48 new tokens each,
   exact prompt buckets) with its launches per tick and per prefill batch,
   bf16 logits against the reference backend, fp32 tokens identical to it,
   the refusals of a padded prompt, the prefix cache, chunked prefill and
   speculation, and the serving metrics with the pool's and the dense
   state's bytes and the device-busy share of one profiled run.  Every
   run's lru_scan launches are on ``chunked``, and their shapes recorded;
11. lru_scan — at every (B, S, W) shape phase 10 launched it at (fp32, as
   ``op_rg_lru`` hands it: the 8 x 512 prefill, the window run's one row of
   2080, workload R's prefill batches of 256-token prompts) and at the 8 x
   512 prefill in bf16 (a kernel case): the ``chunked`` schedule by CUDA
   graph (through the wrapper, and launched directly into one buffer) and
   by events, held against its plain version, beside the
   sequential kernel it replaced (by graph, held to the plain version too)
   and the bound (no PyTorch call computes a linear recurrence); at each
   path shape the chunked kernel must be no slower than the sequential
   one;
12. dense kernels — at the heads and projections of qwen1.5-4b (20 heads
   over 20 KV heads of 128), phi4-mini-3.8b (24 over 8 of 128: a group of
   3) and stablelm-1.6b (32 over 32 of 64), bf16 and fp32:
   ``flash_attention`` at the 8 x 512 prefill, ``decode_attention`` over
   the 1024-slot cache half full and ``paged_decode_attention`` at a
   serving tick, each beside its SIMT kernel, SDPA (gather + SDPA) and the
   plain version; ``matmul_fused`` at each of the model's projection
   shapes (from its plan) at 4096 and 8 rows;
13. dense path — the three at full width and depth (random weights from
   seed 0, drawn once in bf16; the fp32 runs take them widened), one after
   the other: ``generate`` of 32 tokens after a 512-token prompt a row
   (``ShapeConfig("serve", "decode", 1024, 8)``) with the launches the
   plan says (L flash + 6 L matmul a prefill, L decode + 6 L matmul a
   step, L layers), the prefill's and every teacher-forced step's logits
   against the reference backend (bf16 within 5e-2, fp32 within 1e-4),
   the fp32 greedy tokens identical to it; in bf16 ``measure`` of the 8 x
   512 prefill and a decode step with profiles, and the head's unembed
   timed alone; then ``Engine.run`` on workload A (llama's serving
   configuration) with its launches by schedule (each prefill batch's
   projections by its rows) and the pool's bytes, fp32 tokens identical
   to the reference backend's ``Engine.run``.  Each model's weights,
   states and pools are freed before the next;
14. train — full-width llama3.2-1b (16 layers, 1.24 B parameters, fp32
   masters, bf16 compute, block remat), ``ShapeConfig("train", "train",
   512, 8)``: 20 ``AdamW(lr=3e-4, warmup_steps=3, total_steps=20)`` steps
   on one fixed ``SyntheticLM`` batch (step 0, 8 x 512): every loss
   finite, the last at least 1.0 nat below the first; the forward
   products on the hand kernels (the backward is the reference ops'
   autograd, recomputed), each layer's projections and flash call twice
   a step (the remat's recompute) on ``wgmma``, no other kernel, no
   dispatch rejection; the trained tree cast to bf16 into
   ``ShapeConfig("serve", "decode", 1024, 8)``: a 32-step generate on the
   batch's 512 tokens with the launches by schedule of phase 6 and every
   logit held to the reference backend (< 5e-2), and in an fp32 serve
   plan greedy tokens identical to it; ``measure("train")`` (min of 5)
   and a profile of two steps.  Then a 2-layer llama3.2-1b at full width,
   fp32, one train step on the card (its forward on the kernels) and on
   the host CPU from the same tree: loss relerr < 1e-5, every gradient
   < 1e-4, and one AdamW update of the card's gradients on the card and
   on the CPU < 1e-4.  Then ResNet-34 at 224 px, batch 8: 10 steps of
   ``AdamW(lr=1e-3, warmup_steps=2, total_steps=10)`` on one fixed
   ``SyntheticImages`` batch with BatchNorm on the batch's statistics
   (the loss falls by at least 0.5; the convs on ``wgmma`` and the stem on
   ``small_ci``, the FC on ``small_m``), the checkpoint of its
   parameters and AdamW state under ``build/`` restored bit-exactly (then
   deleted) and one step after the restore within 1e-4 of the
   uninterrupted one, then the trained tree served in bf16 and fp32
   (``ShapeConfig("serve", "prefill", 64, 8)``, BN folded into the convs)
   with phase 5's launches by schedule and limits, and ``measure("train")``;
15. tune — the static verifier and the tuning stack: ``verify_plan`` on the
   card's plan of every ported config (three CNNs at batch 8, five LMs at
   ``ShapeConfig("serve", "decode", 1024, 8)``; no weight is made), all
   ``ok (9 checks)`` with no diagnostic, each hand kernel's largest
   working set (the shared bytes a block asks for) printed and every
   call's working set held to the kernel library's own ``*_smem`` query;
   the survivors of each measured search built and run once, untimed,
   before the search; ResNet-34 (224
   px, batch 8) through ``flow.compile(autotune=True, validate="measure",
   verify=True)`` with a fresh tune database under ``build/``: each
   measured survivor's ms beside the estimator's h100 prediction, no conv
   on ``simt`` during the search, the winner (or, when the ``reference``
   backend wins, the fastest survivor on the hand kernels) through
   conv2d_fused with phase 5's launches by schedule and its logits within
   the limit of the ``reference`` backend at its own flow, a second
   search on the same database a hit with nothing measured, and a
   ``validate="compile"`` search whose one survivor's footprint is a
   measured step's peak of allocated memory; llama3.2-1b
   at full width through ``autotune_decode`` (``ServingProfile(
   batch_buckets=(4, 8), max_seq_len=1024, block_sizes=(16, 32))``,
   ``validate="measure"``, three timed runs a candidate, bench and
   replay, the speculation replay on an envelope of 128 tokens): all six
   benches banked (and the engine replay that confirms a chunk width
   above 1), every paged launch on ``mma``, the block and chunk
   benches re-run and counted on ``mma``, then the pinned engine on
   workload A in the winner's precision and the winner's flow in the
   other (on the hand kernels: with the ``auto`` backend when the
   ``reference`` backend won), with launches by schedule, bf16 logits
   within the limit and fp32 tokens identical to the ``reference``
   backend's, and the engine's defaults on A beside it; no dispatch
   rejection; ``launch.tune show`` lists every record under the card's
   ``cuda:<name>`` key.

The kernel phases 3, 4 and 7 run before the path phases 5, 6 and 8; phases
9, 10 and 11 come next, then 12, 13, 14 and 15. Every path phase also reads
matmul_fused's launches by schedule: the LM prefills on ``wgmma`` (``ffma`` in fp32) and the decode
steps on ``small_m`` (``ffma_small_m``) in the counts the plan gives, no
serving projection on ``simt`` in either precision; the CNN heads as their
shapes say; the base variant never (no op-layer caller passes
``vmem_accum=False``); and conv2d_fused's: ResNet-34 35 on ``wgmma`` (opt
and folded) or ``ffma`` (base) and the stem on ``small_ci``, MobileNetV1 12
on ``wgmma``, its first conv on ``small_ci`` and its 32-channel pointwise
conv on ``mid_ci``, LeNet-5 2 on ``small_ci``; no conv on ``simt``.
Every path phase reads flash_attention's launches by schedule too: in bf16
all on ``wgmma`` (llama's prefill, serving A-D, the hybrid's generate,
window run and workload R, the dense family's generates and workload A),
in fp32 all on ``ffma``, none on ``simt``; and decode_attention's and
paged_decode_attention's: in bf16 all on ``mma`` (llama's generate and
each decode step, serving A-D, the hybrid's generate, window run and
workload R, the dense family's generates, decode steps and workload A),
in fp32 all on ``ffma``, none on ``simt``. TF32
is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so every fp32 reference is full
fp32. The last line is ``{"ok": true, "device": {...}}``; the line with the
``"kernels"`` list and the ``nvidia-smi`` line come just before it. Exits
non-zero, printing no result, without a CUDA card. Details go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet, dense: bf16 tensor cores; fp32 outside the tensor
# cores (the kernels' fp32 path); HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}      # kernel vs plain
PATH_TOL = {"bf16": 5e-2, "fp32": 1e-4}                # model vs reference
SEED = 0
B = 8

# llama3.2-1b at full width (configs/llama32_1b.py): the prefill batch of
# 8 rows x 512 tokens, the 1024-slot decode cache, and the projections of
# one layer as (name, K, N, GLU pair); each runs once per layer
LM_ARCH = "llama3.2-1b"
LM_S, LM_C, LM_H, LM_KV, LM_D, LM_LAYERS = 512, 1024, 32, 8, 64, 16
LM_STEPS = 32
LM_MATMULS = [("q", 2048, 2048, False), ("k", 2048, 512, False),
              ("v", 2048, 512, False), ("o", 2048, 2048, False),
              ("glu", 2048, 8192, True), ("down", 8192, 2048, False)]

# Every distinct ResNet-34 conv at 224 px: (name, H_in, CI, CO, k, stride,
# uses per forward, act in the opt flow).  All carry the BN fold in the opt
# flow; the base flow runs them bare (BN and ReLU are separate ops there).
RESNET_CONVS = [
    ("stem7x7s2", 224, 3, 64, 7, 2, 1, "relu"),
    ("3x3s1_64@56", 56, 64, 64, 3, 1, 6, "relu"),
    ("3x3s2_64to128", 56, 64, 128, 3, 2, 1, "relu"),
    ("3x3s1_128@28", 28, 128, 128, 3, 1, 7, "relu"),
    ("1x1s2_64to128", 56, 64, 128, 1, 2, 1, None),
    ("3x3s2_128to256", 28, 128, 256, 3, 2, 1, "relu"),
    ("3x3s1_256@14", 14, 256, 256, 3, 1, 11, "relu"),
    ("1x1s2_128to256", 28, 128, 256, 1, 2, 1, None),
    ("3x3s2_256to512", 14, 256, 512, 3, 2, 1, "relu"),
    ("3x3s1_512@7", 7, 512, 512, 3, 1, 5, "relu"),
    ("1x1s2_256to512", 14, 256, 512, 1, 2, 1, None),
]
FC = (512, 1000)
# MobileNetV1 at 224 px (configs/mobilenetv1.py), BN + ReLU as the opt
# flow runs them: its first conv (3x3, stride 2, CI 3 -> 32; small_ci), in
# both dtypes, and its 32 -> 64 pointwise conv at 112 px (mid_ci in bf16)
MBV1_FIRST = ("mbv1_first3x3s2", 224, 3, 32, 3, 2, 1, "relu")
MBV1_PW32 = ("mbv1_pw1x1_32to64", 112, 32, 64, 1, 1, 1, "relu")
PW_BATCHES = (4, 8, 16, 32)     # the pointwise conv's batch sweep
# LeNet-5 at 32 px (configs/lenet5.py) as the opt flow runs it in bf16: its
# two 5x5 VALID convs with the ReLU fused, no BN (small_ci), and the FC
# layers that run on simt (N or K off the 8-grid): (name, K, N, act)
LENET_CONVS = [("lenet_c1_5x5", 32, 1, 6, 5, 1, 1, "relu"),
               ("lenet_c3_5x5", 14, 6, 16, 5, 1, 1, "relu")]
LENET_FCS = [("lenet_f6_120to84", 120, 84, "relu"),
             ("lenet_out_84to10", 84, 10, None)]


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    """The launch counts of the seven kernel wrappers."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import lru_scan as kl
    from repro_torch.kernels import matmul_fused as km
    return {"conv2d_fused": kc.conv2d_fused, "matmul_fused": km.matmul_fused,
            "flash_attention": ka.flash_attention,
            "decode_attention": kd.decode_attention,
            "paged_decode_attention": kd.paged_decode_attention,
            "copy_block": kd.copy_block, "lru_scan": kl.lru_scan}


def reset_counts() -> None:
    """Every launch count to 0: the seven wrappers', matmul_fused's,
    conv2d_fused's, flash_attention's, decode_attention's,
    paged_decode_attention's and lru_scan's splits by schedule, lru_scan's
    by shape and the base variant's."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import lru_scan as kl
    from repro_torch.kernels import matmul_fused as km
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    km.matmul_fused.schedule_launches = dict.fromkeys(km.SCHEDULES, 0)
    kc.conv2d_fused.schedule_launches = dict.fromkeys(kc.SCHEDULES, 0)
    km.matmul_fused.base_launches = 0
    km.matmul_fused.base_schedule_launches = dict.fromkeys(km.SCHEDULES, 0)
    kl.lru_scan.schedules = dict.fromkeys(kl.SCHEDULES, 0)
    kl.lru_scan.shapes = {}
    ka.flash_attention.schedules = dict.fromkeys(ka.SCHEDULES, 0)
    kd.decode_attention.schedules = dict.fromkeys(kd.SCHEDULES, 0)
    kd.paged_decode_attention.schedules = dict.fromkeys(kd.SCHEDULES, 0)


def read_counts():
    """The launch counts; ``matmul_fused_base`` is the base variant's."""
    from repro_torch.kernels import matmul_fused as km
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counters().items()}
    got["matmul_fused_base"] = km.matmul_fused.base_launches
    return got


def read_schedules(kernel="matmul_fused"):
    """matmul_fused's (or flash_attention's, conv2d_fused's,
    decode_attention's, paged_decode_attention's or lru_scan's) launches
    since the last reset, by schedule."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import lru_scan as kl
    from repro_torch.kernels import matmul_fused as km
    torch.cuda.synchronize()
    if kernel == "lru_scan":
        return dict(kl.lru_scan.schedules)
    if kernel == "flash_attention":
        return dict(ka.flash_attention.schedules)
    if kernel in ("decode_attention", "paged_decode_attention"):
        return dict(getattr(kd, kernel).schedules)
    if kernel == "conv2d_fused":
        return dict(kc.conv2d_fused.schedule_launches)
    return dict(km.matmul_fused.schedule_launches)


def _scheduled(want, what, kernel="matmul_fused"):
    """The kernel's launches by schedule must be ``want`` (a schedule left
    out must be 0)."""
    got = read_schedules(kernel)
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: {kernel} schedules {got}, want "
                             f"{full}")
    return {k: v for k, v in got.items() if v}


FLASH_SCHEDULES = {"bf16": "wgmma", "fp32": "ffma"}   # at head widths 64-256


def _flash_scheduled(n, prec, what):
    """All ``n`` flash_attention launches on wgmma in bf16 and on ffma in
    fp32 (every head width of the LM paths is 64 or 256), none on simt."""
    return _scheduled({FLASH_SCHEDULES[prec]: n}, what, "flash_attention")


# decode_attention's and paged_decode_attention's schedule at head widths
# 64-256 (every LM path's), by precision
DECODE_SCHEDULES = {"bf16": "mma", "fp32": "ffma"}


def _decode_scheduled(n, prec, what, kernel="decode_attention"):
    """All ``n`` launches of decode_attention (or paged_decode_attention)
    on mma in bf16 and on ffma in fp32, none on simt."""
    return _scheduled({DECODE_SCHEDULES[prec]: n}, what, kernel)


# matmul_fused's schedules of the LM projections (every one aligned), by
# precision: the large-M one, the small-M one
LM_SCHEDULES = {"bf16": ("wgmma", "small_m"), "fp32": ("ffma", "ffma_small_m")}


def _lm_scheduled(prefill, decode, prec, what):
    """``prefill`` projections on the precision's large-M schedule,
    ``decode`` on its small-M one, none on simt or the other precision's."""
    big, small = LM_SCHEDULES[prec]
    return _scheduled({big: prefill, small: decode}, what)


def _lru_scheduled(n, what):
    """All ``n`` lru_scan launches on the chunked schedule, and lru_scan's
    launches by (B, S, W, dtype) since the last reset, as
    [[B, S, W, dtype, launches], ...]."""
    from repro_torch.kernels import lru_scan as kl
    _scheduled({"chunked": n}, what, "lru_scan")
    return [[*k, v] for k, v in sorted(kl.lru_scan.shapes.items())]


def _aligned_only(total, prec, what):
    """Every one of ``total`` projections ran on the precision's two
    schedules (tensor-core in bf16, FFMA in fp32), none on simt."""
    got = read_schedules()
    ok = sum(got[k] for k in LM_SCHEDULES[prec])
    if ok != total or ok != sum(got.values()):
        raise AssertionError(f"{what}: matmul_fused schedules {got}, want "
                             f"{total} on {' + '.join(LM_SCHEDULES[prec])}"
                             " and none on simt")
    return {k: v for k, v in got.items() if v}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device ms of ``fn``: ``iters`` calls captured in one CUDA graph,
    replayed twice between CUDA events.  The replay takes the host's launch
    cost out, which at 8 rows is several times the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    graph.replay()
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1) / (2 * iters)
    del graph
    return ms


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def bound_ms(flops: float, nbytes: float, dt: torch.dtype):
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name} capability={cap} count={torch.cuda.device_count()}"
        f" torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from repro_torch.device import hopper_ok
    from repro_torch.kernels import _build
    if not hopper_ok():
        raise RuntimeError("the kernels target sm_90a; this card is "
                           f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    info = _build.LIBRARY.info
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {info.seconds:.2f}s,"
        f" built={info.built}) -> {info.path}")
    kernel = "?"
    for line in info.log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = _short_kernel(m.group(1))
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {kernel}: {line.split(':', 1)[-1].strip()}")
    return {"seconds": time.perf_counter() - t0, "built": info.built}


def _short_kernel(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled symbol
    (``matmul_wgmma_kernelILi128ELi1ELi3ELi2E13__nv_bfloat16``)."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}\d+",
                  "", mangled)
    return re.sub(r"^_Z\d+", "", name).split("EEv")[0].split("Ev")[0][:80]


def _conv_simt(x, w, stride, bn, act, padding="SAME"):
    """The SIMT kernel on the same operands, launched directly (no wrapper
    counts it): the schedule every conv ran on before the wgmma and ffma
    kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d as kc
    N, H, W, CI = x.shape
    k, CO = w.shape[0], w.shape[3]
    (pt, _), (pl, _), ho, wo = kc.conv_geometry(H, W, k, k, stride, padding)
    out = torch.empty((N, ho, wo, CO), dtype=x.dtype, device=x.device)
    bnp = [_build.ptr(t) for t in bn] if bn is not None else [None] * 4

    def run():
        _build.call("conv2d_fused", _build.DTYPE_CODES[x.dtype],
                    x.data_ptr(), w.data_ptr(), *bnp, out.data_ptr(), N, H,
                    W, CI, CO, k, k, stride, pt, pl, ho, wo,
                    _build.ACT_CODES[act], _build.stream())
        return out
    return run


# one fp32 case per shape class with the BN fold and ReLU (the base flow
# runs its convs bare, so these count in no forward): the epilogue of the
# ffma kernel at ResNet shapes, unsplit (56 x 56) and split
FP32_EPILOGUE = ("stem7x7s2", "3x3s1_64@56", "3x3s2_128to256",
                 "1x1s2_256to512")


def _conv_case(spec, dt, gen, epilogue=False, padding="SAME", bn_on=True):
    """conv2d_fused at one ResNet-34 shape: the schedule the wrapper took,
    held against the plain version; its CUDA-graph device time (and by
    events) beside the SIMT kernel's at the same shape (held to the plain
    version too), the plain version's, the library's and the bound.  The
    library is cuDNN's conv on an input padded outside the timed region
    (``library_conv_ms``) and the whole yardstick chain of pad, conv and
    the fp32 BN/ReLU ops (``library_ms``).  The bf16 (opt flow) cases carry
    the BN fold and act, the fp32 (base flow) ones run bare, as the flows
    run them, but with ``epilogue`` (a case in no forward: uses 0).
    ``bn_on=False`` drops the BN fold (LeNet-5 has none)."""
    from repro_torch.kernels import conv2d as kc
    name, H, CI, CO, k, s, uses, act = spec
    dev = torch.device("cuda")
    x = torch.randn(B, H, H, CI, generator=gen, device=dev).to(dt)
    w = (torch.randn(k, k, CI, CO, generator=gen, device=dev)
         * (k * k * CI) ** -0.5).to(dt)
    fused = dt == torch.bfloat16 or epilogue
    bn = tuple(torch.rand(CO, generator=gen, device=dev) + 0.5
               for _ in range(4)) if fused and bn_on else None
    act = act if fused else None

    def kern():
        return kc.conv2d_fused(x, w, stride=s, padding=padding, bn=bn,
                               act=act)

    def plain():
        return kc.conv2d_fused_plain(x, w, stride=s, padding=padding, bn=bn,
                                     act=act)

    (pt, pb), (pl, pr), ho, wo = kc.conv_geometry(H, H, k, k, s, padding)
    xn = x.permute(0, 3, 1, 2)                  # NCHW view, channels_last
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xpad = F.pad(xn, (pl, pr, pt, pb))

    def library():                              # cuDNN, the yardstick only
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), wn, stride=s)
        if bn is not None:
            sc, bi, mu, var = bn
            y = ((y.float() - mu[:, None, None])
                 * (torch.rsqrt(var + 1e-5) * sc)[:, None, None]
                 + bi[:, None, None])
        if act:
            y = F.relu(y)
        return y.to(dt)

    def library_conv():                         # one cuDNN call
        return F.conv2d(xpad, wn, stride=s)

    c0 = read_schedules("conv2d_fused")
    y = kern()
    torch.cuda.synchronize()
    sched = [k_ for k_, v in read_schedules("conv2d_fused").items()
             if v != c0[k_]]
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    lib_err = relerr(library().permute(0, 2, 3, 1), p)
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"conv2d_fused {name} {dt}: relerr {err} "
                             f"(tol {TOL[dt]}), shape {tuple(y.shape)}, "
                             f"schedules {sched}")
    simt = (_conv_simt(x, w, s, bn, act, padding) if sched[0] != "simt"
            else kern)
    ys = simt()
    simt_err = relerr(ys, p)
    simt_aerr = (ys.float() - p.float()).abs().max().item()
    if simt_err >= TOL[dt]:
        raise AssertionError(f"conv2d_fused {name} {dt}: the SIMT kernel's "
                             f"relerr {simt_err}")
    flops = 2.0 * B * ho * wo * k * k * CI * CO
    esz = x.element_size()
    nbytes = (x.numel() + w.numel() + B * ho * wo * CO) * esz \
        + (4 * CO * 4 if bn else 0)
    bms, by = bound_ms(flops, nbytes, dt)
    return {"shape": name + ("+bn_relu" if epilogue else ""),
            "dtype": str(dt).split(".")[-1], "uses": 0 if epilogue else uses,
            "schedule": sched[0],
            "x": [B, H, H, CI], "w": [k, k, CI, CO], "stride": s,
            "padding": padding, "bn": bn is not None, "act": act,
            "relerr": err, "max_abs_err": aerr, "tol": TOL[dt],
            "simt_relerr": simt_err, "simt_max_abs_err": simt_aerr,
            "library_relerr": lib_err, "flops": flops, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by, "timer": "cuda_graph",
            "ms": graph_ms(kern), "event_ms": cuda_ms(kern),
            "simt_ms": graph_ms(simt), "simt_event_ms": cuda_ms(simt),
            "plain_ms": graph_ms(plain), "library_ms": graph_ms(library),
            "library_event_ms": cuda_ms(library),
            "library_conv_ms": graph_ms(library_conv)}


def _simt_wrapper(x, w, **kw):
    """One call as the wrapper made it before the tensor-core schedules:
    check and allocate (``_prepare``), then the SIMT kernel.  Its event time
    beside the wrapper's own is the host cost the schedule choice, the
    split and the second launch add."""
    from repro_torch.kernels import matmul_fused as km
    c = km._prepare(x, w, **kw)
    km._launch_simt(c)
    return c.out


def _fc_case(dt, gen):
    """The ResNet-34 FC head: event-timed (the host's launch rate, as a
    forward sees it) and graph-timed (device time), in bf16 beside the SIMT
    kernel through the old wrapper's steps (``_simt_wrapper``)."""
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    K, N = FC
    x = torch.randn(B, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt)

    def simt():
        return _simt_wrapper(x, w, bias=b, out_dtype=dt)

    def kern():
        return km.matmul_fused(x, w, bias=b, out_dtype=dt)

    def plain():
        return km.matmul_fused_plain(x, w, bias=b, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        return (torch.matmul(x, w).float() + b.float()).to(dt)

    c0 = read_schedules()
    y = kern()
    torch.cuda.synchronize()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    p = plain()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == (B, N) and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"matmul_fused FC {dt}: relerr {err}, "
                             f"schedules {sched}")
    flops = 2.0 * B * K * N
    nbytes = (x.numel() + w.numel() + b.numel() + B * N) * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    old = sched[0] != "simt"
    if old and relerr(simt(), p) >= TOL[dt]:
        raise AssertionError(f"matmul_fused FC {dt}: the SIMT kernel differs "
                             "from the plain version")
    return {"shape": f"fc_{B}x{K}x{N}", "dtype": str(dt).split(".")[-1],
            "uses": 1, "schedule": sched[0], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p), "flops": flops,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": cuda_ms(kern, 100), "graph_ms": graph_ms(kern, 100),
            "simt_ms": cuda_ms(simt, 100) if old else None,
            "simt_graph_ms": graph_ms(simt, 100) if old else None,
            "plain_ms": cuda_ms(plain, 100),
            "library_ms": cuda_ms(library, 100)}


def _lenet_fc_case(spec, gen, dt=torch.bfloat16):
    """One LeNet-5 FC layer at batch 8 as its forward runs it (bias, and
    the ReLU fused where the graph has one): the schedule it took, held
    against its plain version, timed by CUDA graph (and by events) beside
    ``torch.matmul`` + bias (+ ReLU) and its bound."""
    from repro_torch.kernels import matmul_fused as km
    name, K, N, act = spec
    dev = torch.device("cuda")
    x = torch.randn(B, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt)

    def kern():
        return km.matmul_fused(x, w, bias=b, act=act, out_dtype=dt)

    def plain():
        return km.matmul_fused_plain(x, w, bias=b, act=act, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        y = torch.matmul(x, w).float() + b.float()
        return (F.relu(y) if act else y).to(dt)

    c0 = read_schedules()
    kern()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    if len(sched) != 1:
        raise AssertionError(f"matmul_fused {name}: schedules {sched}")
    flops = 2.0 * B * K * N
    nbytes = (B * K + K * N + N + B * N) * x.element_size()
    rec = _timed_case(kern, plain, library, dt, flops, nbytes,
                      timer=lambda fn: graph_ms(fn, 100))
    return {"shape": name, "arch": "lenet5", "uses": 1, "rows": B,
            "schedule": sched[0], "timer": "cuda_graph", **rec,
            "event_ms": cuda_ms(kern, 100)}


def _pw_batches():
    """MobileNetV1's pointwise conv (BN + ReLU, bf16) on its schedule at
    batch 4-32 beside cuDNN's conv alone, graph ms: how the time grows
    with the batch, and where it starts."""
    from repro_torch.kernels import conv2d as kc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    _, H, CI, CO, _, _, _, _ = MBV1_PW32
    dev = torch.device("cuda")
    w = (torch.randn(1, 1, CI, CO, generator=gen, device=dev)
         * CI ** -0.5).bfloat16()
    bn = tuple(torch.rand(CO, generator=gen, device=dev) + 0.5
               for _ in range(4))
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = []
    for nb in PW_BATCHES:
        x = torch.randn(nb, H, H, CI, generator=gen, device=dev).bfloat16()
        xn = x.permute(0, 3, 1, 2)
        nbytes = (x.numel() + w.numel() + nb * H * H * CO) * 2 + 4 * CO * 4
        out.append({"batch": nb, "bytes": nbytes,
                    "bound_ms": nbytes / PEAK_BYTES * 1e3,
                    "ms": graph_ms(lambda: kc.conv2d_fused(
                        x, w, bn=bn, act="relu")),
                    "library_conv_ms": graph_ms(lambda: F.conv2d(xn, wn))})
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"conv2d_fused": [], "matmul_fused": []}
    for dt in (torch.bfloat16, torch.float32):
        for spec in RESNET_CONVS:
            c = _conv_case(spec, dt, gen)
            cases["conv2d_fused"].append(c)
            log(json.dumps({"kernel": "conv2d_fused", **c}))
        c = _fc_case(dt, gen)
        cases["matmul_fused"].append(c)
        log(json.dumps({"kernel": "matmul_fused", **c}))
    # drawn last, so that every other case's inputs stay as they were
    for spec in RESNET_CONVS:
        if spec[0] in FP32_EPILOGUE:
            c = _conv_case(spec, torch.float32, gen, epilogue=True)
            cases["conv2d_fused"].append(c)
            log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec, dt in ((MBV1_FIRST, torch.bfloat16), (MBV1_FIRST, torch.float32),
                     (MBV1_PW32, torch.bfloat16)):
        c = {**_conv_case(spec, dt, gen), "arch": "mobilenetv1"}
        if spec is MBV1_PW32:
            c["batch_sweep"] = _pw_batches()
        cases["conv2d_fused"].append(c)
        log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec in LENET_CONVS:
        c = {**_conv_case(spec, torch.bfloat16, gen, padding="VALID",
                          bn_on=False), "arch": "lenet5"}
        cases["conv2d_fused"].append(c)
        log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec in LENET_FCS:
        c = _lenet_fc_case(spec, gen)
        cases["matmul_fused"].append(c)
        log(json.dumps({"kernel": "matmul_fused", **c}))
    _conv_checks(cases["conv2d_fused"])
    return cases


def _conv_checks(cases):
    """By graph device time, each pair timed in this run: the small_ci
    schedule at ResNet-34's stem, as the flows run it (bf16 with BN + ReLU,
    fp32 bare), no slower than cuDNN's conv alone; MobileNetV1's first conv
    (small_ci) and its pointwise conv (mid_ci) in bf16 no slower than the
    SIMT kernel; the pointwise conv within twice its bound (at least half
    the card's byte rate: 0.0116 ms)."""
    for c in cases:
        arch, sched = c.get("arch"), c["schedule"]
        if c["uses"] == 0:
            continue
        if arch is None and sched == "small_ci":
            other = "library_conv_ms"
        elif arch == "mobilenetv1" and c["dtype"] == "bfloat16" and \
                sched in ("small_ci", "mid_ci"):
            other = "simt_ms"
        else:
            continue
        if c["ms"] > c[other]:
            raise AssertionError(f"conv2d_fused[{sched}] {c['shape']} "
                                 f"{c['dtype']}: {c['ms']:.4f} ms, slower "
                                 f"than {other} {c[other]:.4f}")
        if sched == "mid_ci" and c["ms"] > 2 * c["bound_ms"]:
            raise AssertionError(f"conv2d_fused[mid_ci] {c['shape']}: "
                                 f"{c['ms']:.4f} ms, over twice its bound "
                                 f"{c['bound_ms']:.4f}")


def _timed_case(kern, plain, library, dt, flops, nbytes, iters=20,
                timer=None):
    """Kernel vs plain version (relerr, max |diff|), then the three times
    and the bound of one call.  ``library`` is None where no one PyTorch
    call computes the same function.  The times are CUDA events over
    back-to-back calls, or ``timer(fn)``."""
    y = kern()
    torch.cuda.synchronize()
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt]):
        raise AssertionError(f"relerr {err} (tol {TOL[dt]}), shape "
                             f"{tuple(y.shape)}")
    bms, by = bound_ms(flops, nbytes, dt)
    warm = 1 if iters < 20 else 3
    lib = library is not None
    timer = timer or (lambda fn: cuda_ms(fn, iters, warm))
    return {"dtype": str(dt).split(".")[-1], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p) if lib else None,
            "flops": flops, "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": timer(kern), "plain_ms": timer(plain),
            "library_ms": timer(library) if lib else None}


def _flash_simt(q, k, v, window):
    """The SIMT kernel on the same operands, launched directly (no wrapper
    counts it): the schedule bf16 and fp32 at D >= 64 ran on before the
    wgmma and ffma kernels."""
    from repro_torch.kernels import _build
    b, S, H, D = q.shape
    KV = k.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(b, S)
    pos = pos.contiguous()
    out = torch.empty_like(q)

    def run():
        _build.call("flash_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, k, v, pos, pos, out)],
                    b, S, S, H, KV, D, 1, int(window or 0), 0.0, 0,
                    _build.stream())
        return out
    return run


def _flash_case(dt, gen, b=B, S=LM_S, H=LM_H, KV=LM_KV, D=LM_D, window=None,
                iters=20):
    """flash_attention, causal, at llama3.2-1b's prefill by default; with
    ``window`` the keys older than it are masked (recurrentgemma-2b).  The
    schedule the wrapper took, its CUDA-graph device time (and by events)
    beside the plain version's, SDPA's (and the name of the kernel SDPA
    ran) and the bound; the SIMT kernel's at the same shape, held to the
    plain version too."""
    from repro_torch.kernels import attention as ka
    dev = torch.device("cuda")
    q = torch.randn(b, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(b, S, KV, D, generator=gen, device=dev).to(dt)
    v = torch.randn(b, S, KV, D, generator=gen, device=dev).to(dt)
    # the library call takes (B, H, S, D) with the KV heads repeated
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    if window is None:
        pairs = S * (S + 1) / 2                      # causal pairs only
        sdpa = dict(is_causal=True)
    else:
        ar = torch.arange(S, device=dev)
        mask = (ar[None, :] <= ar[:, None]) & (ar[None, :] > ar[:, None]
                                               - window)
        pairs = float(mask.sum().item())             # live (q, k) pairs
        sdpa = dict(attn_mask=mask)
    flops = 4.0 * D * b * H * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()

    def kern():
        return ka.flash_attention(q, k, v, causal=True, window=window)

    def plain():
        return ka.flash_attention_plain(q, k, v, causal=True, window=window)
    s0 = read_schedules("flash_attention")
    kern()
    sched = [n for n, c in read_schedules("flash_attention").items()
             if c != s0[n]]
    want = FLASH_SCHEDULES["bf16" if dt == torch.bfloat16 else "fp32"]
    if sched != [want]:
        raise AssertionError(f"flash_attention {dt} D={D}: schedules "
                             f"{sched}, want {want}")
    def library():                              # SDPA, the yardstick only
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              **sdpa).transpose(1, 2)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=iters,
                    timer=lambda fn: graph_ms(fn, iters))
    c.update(shape=f"prefill_B{b}_S{S}_H{H}_KV{KV}_D{D}_causal"
                   + (f"_window{window}" if window else ""), rows=b,
             schedule=sched[0], event_ms=cuda_ms(kern, iters, 1),
             timer="cuda_graph", library_kernels=_kernel_names(library))
    simt = _flash_simt(q, k, v, window)
    p, y = plain(), simt()
    err = relerr(y, p)
    if err >= TOL[dt]:
        raise AssertionError(f"flash_attention {c['shape']}: the SIMT "
                             f"kernel's relerr {err}")
    c.update(simt_ms=graph_ms(simt, iters), simt_relerr=err,
             simt_max_abs_err=(y.float() - p.float()).abs().max().item())
    return c


def _simt_twin(c):
    """A flash, decode or paged case as the SIMT kernel's own entry
    (``flash_attention[simt]`` and so on in the kernels line): its times
    and error from the case, its launches on the main path 0 (no path runs
    it at D >= 64)."""
    return {**c, "schedule": "simt", "ms": c["simt_ms"], "event_ms": None,
            "relerr": c["simt_relerr"], "max_abs_err": c["simt_max_abs_err"]}


def _kernel_names(fn):
    """The CUDA kernels one call of ``fn`` runs, by device time (the
    profiler's names, cut to 80 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return [k[:80] for us, k in rows if us > 0]


def _decode_simt(q, kc, vc, pos, qp, window):
    """The SIMT kernels (a split launch and a combine launch) on the same
    operands, launched directly (no wrapper counts them): the schedule bf16
    and fp32 at D >= 64 ran on before the mma and ffma kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kd
    b, _, H, D = q.shape
    C, KV = kc.shape[1], kc.shape[2]
    nsplit, chunk = kd._simt_splits(b, C, KV, kd._n_sm(q.device))
    ws = torch.empty(b * KV * nsplit * (H // KV) * (D + 2),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)

    def run():
        _build.call("decode_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, kc, vc, pos, qp, out, ws)],
                    b, C, H, KV, D, int(window or 0), 0.0, nsplit, chunk,
                    _build.stream())
        return out
    return run


def _new_schedule(kernel, fn, prec):
    """Run ``fn`` once; the schedule it launched, which must be the
    precision's (mma in bf16, ffma in fp32)."""
    s0 = read_schedules(kernel)
    fn()
    sched = [n for n, c in read_schedules(kernel).items() if c != s0[n]]
    if sched != [DECODE_SCHEDULES[prec]]:
        raise AssertionError(f"{kernel} {prec}: schedules {sched}, want "
                             f"{DECODE_SCHEDULES[prec]}")
    return sched[0]


def _with_simt(c, simt, plain, dt, iters=100):
    """A case record with the SIMT kernel's graph time and error beside,
    held to the plain version too."""
    p, y = plain(), simt()
    err = relerr(y, p)
    if err >= TOL[dt]:
        raise AssertionError(f"{c['shape']}: the SIMT kernel's relerr {err}")
    c.update(simt_ms=graph_ms(simt, iters), simt_relerr=err,
             simt_max_abs_err=(y.float() - p.float()).abs().max().item())
    return c


def _decode_case(dt, gen, b=B, C=LM_C, qpos=LM_C // 2 - 1, H=LM_H, KV=LM_KV,
                 D=LM_D, window=None):
    """decode_attention over a rolling cache of C slots holding positions
    max(0, qpos-C+1) .. qpos (slot c holds the position = c mod C): by
    default llama3.2-1b's 1024-slot cache, half full.  The new schedule
    (mma or ffma) by CUDA graph and by events, beside the SIMT kernel
    (forced, by graph), SDPA and the plain version."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    lo = max(0, qpos - C + 1)
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    slot_pos = lo + (ar - lo) % C
    pos = torch.where(slot_pos <= qpos, slot_pos, torch.full_like(ar, -1))
    pos = pos.expand(b, C).contiguous()
    qp = torch.full((b, 1), qpos, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, H, D, generator=gen, device=dev).to(dt)
    kc = torch.randn(b, C, KV, D, generator=gen, device=dev).to(dt)
    vc = torch.randn(b, C, KV, D, generator=gen, device=dev).to(dt)
    valid = (pos >= 0) & (pos <= qp)
    if window is not None:
        valid &= pos > qp - window
    live = int(valid[0].sum().item())
    qt = q.transpose(1, 2)
    kt = kc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = vc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    flops = 4.0 * D * b * H * live
    # the live slots' K and V, every slot's position, q, qpos and out
    nbytes = (2 * b * live * KV * D + 2 * q.numel()) * q.element_size() \
        + (pos.numel() + qp.numel()) * 4

    def kern():
        return kd.decode_attention(q, kc, vc, pos, qp, window=window)

    def plain():
        return kd.decode_attention_plain(q, kc, vc, pos, qp, window=window)

    def library():                              # SDPA, the yardstick only
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :]).transpose(1, 2)
    prec = "bf16" if dt == torch.bfloat16 else "fp32"
    sched = _new_schedule("decode_attention", kern, prec)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=100)
    c.update(shape=f"decode_B{b}_C{C}_qpos{qpos}_live{live}_H{H}_KV{KV}"
                   f"_D{D}", rows=b, schedule=sched,
             **_graph_times(c, kern, library))
    return _with_simt(c, _decode_simt(q, kc, vc, pos, qp, window), plain, dt)


def _graph_times(c, kern, library, iters=100):
    """``ms`` and ``library_ms`` of a ``_timed_case`` record as CUDA-graph
    device times, its events times beside them as ``event_ms`` and
    ``library_event_ms`` (at these sizes they carry the host's cost a
    call)."""
    return {"event_ms": c["ms"], "library_event_ms": c["library_ms"],
            "ms": graph_ms(kern, iters),
            "library_ms": graph_ms(library, iters), "timer": "cuda_graph"}


# L2 is 50 MB: at M <= 64 (decode, serving ticks) a call rotates over
# enough copies of its weights to read them cold, as a decode step finds
# them after the other layers' weights
COLD_BYTES = 100e6


def _lm_matmul_case(name, M, K, N, glu, dt, gen, uses, crossover=False):
    """matmul_fused at one projection shape: the kernel the wrapper's
    schedule picks, held against the plain version; its device time beside
    the SIMT kernel's at the same shape (the old schedule, bf16 only, also
    held against the plain version), the plain version's, ``torch.matmul``'s
    and the bound.  With ``crossover`` the other tensor-core schedule too,
    forced (small_m only up to 64 rows).  Timed with CUDA graphs
    (``graph_ms``), cold weights at M <= 64; the wrapper and the old
    wrapper's steps (``_simt_wrapper``) also with events (``event_ms``,
    ``simt_event_ms``), which at few rows read the host's cost a call."""
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    n_w = 2 if glu else 1
    wbytes = n_w * K * N * torch.tensor([], dtype=dt).element_size()
    copies = max(1, -(-int(COLD_BYTES) // wbytes)) if M <= 64 else 1
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    ws = [[(torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
           for _ in range(n_w)] for _ in range(copies)]
    act = "silu" if glu else None
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        w = ws[turn[0]]
        return w[0], (w[1] if glu else None)

    def kern():
        w, w2 = nxt()
        return km.matmul_fused(x, w, w2=w2, act=act, out_dtype=dt)

    def plain():
        w, w2 = nxt()
        return km.matmul_fused_plain(x, w, w2=w2, act=act, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        w, w2 = nxt()
        if not glu:
            return torch.matmul(x, w)
        return (F.silu(torch.matmul(x, w).float())
                * torch.matmul(x, w2).float()).to(dt)

    simt_calls = [km._prepare(x, w[0], w2=w[1] if glu else None, act=act,
                              out_dtype=dt) for w in ws]

    def simt():                                 # the old kernel, same shape
        turn[0] = (turn[0] + 1) % copies
        km._launch_simt(simt_calls[turn[0]])

    def simt_wrapper():
        w, w2 = nxt()
        return _simt_wrapper(x, w, w2=w2, act=act, out_dtype=dt)

    turn[0] = copies - 1
    c0 = read_schedules()
    y = kern()
    torch.cuda.synchronize()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    turn[0] = copies - 1
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"matmul_fused {name} {M} rows {dt}: relerr "
                             f"{err} (tol {TOL[dt]}), schedules {sched}")
    old = sched[0] != "simt"
    if old:
        turn[0] = copies - 1
        simt()
        torch.cuda.synchronize()
        if relerr(simt_calls[0].out, p) >= TOL[dt]:
            raise AssertionError(f"matmul_fused {name} {M} rows: the SIMT "
                                 "kernel differs from the plain version")
    alt = {}                   # the other tensor-core schedule, forced
    others = [o for o in ("wgmma", "small_m") if o != sched[0]
              and (o == "wgmma" or M <= 64)] if crossover else []
    for o in others:
        launch = km._LAUNCH[o]

        def forced(launch=launch):
            turn[0] = (turn[0] + 1) % copies
            launch(simt_calls[turn[0]])
        turn[0] = copies - 1
        forced()
        torch.cuda.synchronize()
        if relerr(simt_calls[0].out, p) >= TOL[dt]:
            raise AssertionError(f"matmul_fused {name} {M} rows: forced {o} "
                                 "differs from the plain version")
        alt[o] = forced
    turn[0] = copies - 1
    lib_err = relerr(library(), p)
    flops = 2.0 * M * K * N * n_w
    nbytes = (M * K + n_w * K * N + M * N) * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    iters = copies * -(-20 // copies) if M <= 64 else 5
    ms = graph_ms(kern, iters)
    simt_ms = graph_ms(simt, iters) if old else ms
    return {"shape": f"{name}_{M}x{K}x{N}" + ("_glu" if glu else ""),
            "dtype": str(dt).split(".")[-1], "rows": M, "schedule": sched[0],
            "relerr": err, "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": lib_err, "flops": flops, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by, "ms": ms, "simt_ms": simt_ms,
            "event_ms": cuda_ms(kern, iters, 1),
            "simt_event_ms": cuda_ms(simt_wrapper, iters, 1) if old else None,
            "plain_ms": graph_ms(plain, iters),
            "library_ms": graph_ms(library, iters),
            "other_schedule_ms": {o: graph_ms(f, iters)
                                  for o, f in alt.items()},
            "weight_copies": copies, "timer": "cuda_graph",
            "uses_per_forward": uses}


# recurrentgemma-2b's distinct projections (d_model 2560, one KV head of
# 256, d_ff 7680, RG-LRU width 2560) as (name, K, N, GLU pair, uses per
# forward): q, o and the recurrent blocks' two in-branches and out
# projection are 2560 -> 2560 (8 x 2 + 18 x 3), k and v 2560 -> 256 (8 x 2),
# every layer's GLU pair and down projection (26 each): 138 in all
RG_MATMUL_SHAPES = [("d2560", 2560, 2560, False, 70),
                    ("kv", 2560, 256, False, 16),
                    ("glu", 2560, 7680, True, 26),
                    ("down", 7680, 2560, False, 26)]


# rows between a decode step's 8 and a prefill's 4096 where the two
# tensor-core schedules are both timed (bf16, llama): the plain form's
# crossover at 64 rows, the GLU pair's at 32, a verify batch's 40 and a
# chunked catch-up's 128
CROSSOVER = {128: ("q",), 64: ("q",), 40: ("q", "glu"), 32: ("glu",)}


def phase_lm_kernels():
    """Phase 4: the LM kernels at llama3.2-1b's shapes, and matmul_fused at
    both LM models' projections: 4096 prefill rows and 8 decode rows, and
    in bf16 the llama rows of ``CROSSOVER`` between them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "matmul_fused": []}
    rg_cases = []
    for dt in (torch.bfloat16, torch.float32):
        for kname, c in (("flash_attention", _flash_case(dt, gen)),
                         ("decode_attention", _decode_case(dt, gen))):
            cases[kname].append(c)
            log(json.dumps({"kernel": kname, **c}))
        rows = (B * LM_S, 128, 64, 40, 32, B) if dt == torch.bfloat16 \
            else (B * LM_S, B)
        for M in rows:
            for name, K, N, glu in LM_MATMULS:
                if M in CROSSOVER and name not in CROSSOVER[M]:
                    continue
                c = _lm_matmul_case(name, M, K, N, glu, dt, gen, LM_LAYERS,
                                    crossover=M in CROSSOVER)
                cases["matmul_fused"].append(c)
                log(json.dumps({"kernel": "matmul_fused", **c}))
        for M in (B * RG_S, B):
            for name, K, N, glu, uses in RG_MATMUL_SHAPES:
                c = _lm_matmul_case(name, M, K, N, glu, dt, gen, uses)
                rg_cases.append(c)
                log(json.dumps({"kernel": "matmul_fused", "arch": RG_ARCH,
                                **c}))
    for kname in ("flash_attention", "decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases, rg_cases


BASE_TILE = (256, 512, 256)     # repro/kernels/ops.py's default tile


def _base_case(M, K, N, has_bias, dt, gen):
    """The base variant (``vmem_accum=False``, tile (256, 512, 256)) against
    its plain version, on the schedule it took, with the same bits twice;
    timed by CUDA graph beside the old SIMT base kernel (launched directly,
    held to the plain version too; the base variant must beat it), the CW
    form at the same shape and its library call, ``torch.matmul`` (+ bias)
    where that computes the same function: in fp32, where rounding a slab's
    fp32 sum to fp32 changes nothing, and in bf16 at one slab, round(x @ w)
    + bias; none where several bf16 slabs are rounded, which no one
    PyTorch call does."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt) if has_bias else None
    kw = dict(bias=b, tile=BASE_TILE, vmem_accum=False, out_dtype=dt)
    b0 = km.matmul_fused.base_launches
    s0 = dict(km.matmul_fused.base_schedule_launches)
    y = km.matmul_fused(x, w, **kw)
    torch.cuda.synchronize()
    sched = [k for k, v in km.matmul_fused.base_schedule_launches.items()
             if v != s0[k]]
    if km.matmul_fused.base_launches != b0 + 1 or len(sched) != 1:
        raise AssertionError("the base variant did not count its launch: "
                             f"schedules {sched}")
    p = km.matmul_fused_plain(x, w, **kw)
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and err < TOL[dt]):
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: relerr "
                             f"{err} (tol {TOL[dt]})")
    if not torch.equal(km.matmul_fused(x, w, **kw), y):
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: the "
                             "bits differ on a repeat")
    c = km._prepare(x, w, bias=b, out_dtype=dt)

    def simt():                                 # the SIMT base kernel
        _build.call("matmul_base", *km._codes(c), _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(c.out),
                    c.M, c.K, c.N, km._slab_depth(K, BASE_TILE), 0,
                    _build.stream())
        return c.out
    ys = simt()
    simt_err = relerr(ys, p)
    if simt_err >= TOL[dt]:
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: the SIMT "
                             f"base kernel's relerr {simt_err}")

    def cw():
        return km.matmul_fused(x, w, bias=b, out_dtype=dt)
    c0 = read_schedules()
    cw()
    cw_sched = [k for k, v in read_schedules().items() if v != c0[k]]
    flops = 2.0 * M * K * N
    nbytes = (M * K + K * N + M * N + (N if has_bias else 0)) \
        * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    iters = 20 if M <= 64 else 3
    slabs = -(-K // km._slab_depth(K, BASE_TILE))

    def library():                              # cuBLAS, the yardstick only
        y = torch.matmul(x, w)
        return y if b is None else (y.float() + b.float()).to(dt)
    lib = dt == torch.float32 or slabs == 1
    ms = graph_ms(lambda: km.matmul_fused(x, w, **kw), iters)
    simt_ms = graph_ms(simt, iters)
    if ms >= simt_ms:
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt} on "
                             f"{sched[0]}: {ms:.4f} ms, not faster than the "
                             f"SIMT base kernel's {simt_ms:.4f}")
    return {"shape": f"base_{M}x{K}x{N}" + ("_bias" if has_bias else ""),
            "dtype": str(dt).split(".")[-1], "rows": M, "tile": BASE_TILE,
            "slabs": slabs, "schedule": sched[0], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt], "simt_relerr": simt_err,
            "simt_max_abs_err": (ys.float() - p.float()).abs().max().item(),
            "library_relerr": relerr(library(), p) if lib else None,
            "flops": flops, "bytes": nbytes, "bound_ms": bms,
            "bound_by": by, "timer": "cuda_graph", "ms": ms,
            "simt_ms": simt_ms, "cw_schedule": cw_sched[0],
            "cw_ms": graph_ms(cw, iters),
            "plain_ms": graph_ms(lambda: km.matmul_fused_plain(x, w, **kw),
                                 iters),
            "library_ms": graph_ms(library, iters) if lib else None}


def phase_base_kernels():
    """The base variant at the ResNet-34 FC shape and a 4096-row llama
    projection, bf16 and fp32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for M, K, N, has_bias in ((B, FC[0], FC[1], True),
                                  (B * LM_S, 2048, 2048, False)):
            c = _base_case(M, K, N, has_bias, dt, gen)
            cases.append(c)
            log(json.dumps({"kernel": "matmul_fused_base", **c}))
    return {"matmul_fused_base": cases}


def _profile(fn, iters: int = 5):
    """Device busy share of ``iters`` forwards under torch.profiler: the
    summed device time of the device-side kernel events over the window's
    wall time (one stream, so kernels do not overlap), and the top kernels
    by device time.
    The profiler's own cost makes the window longer than an unprofiled one.
    Returns None for the share when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_us(e), e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(us for us, _ in rows)
    return {"iters": iters, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "top": [{"kernel": k[:80], "ms_per_forward": us / 1e3 / iters}
                    for us, k in rows[:6]]}


def _check_logits(name, y, yr, vocab, prec):
    if tuple(y.shape) != (B, vocab) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{name}: logits {tuple(y.shape)} not finite "
                             f"(8, {vocab})")
    err = relerr(y, yr)
    if err >= PATH_TOL[prec]:
        raise AssertionError(f"{name}: logits relerr {err} vs the reference "
                             f"backend (tol {PATH_TOL[prec]})")
    return err


def _forward(arch, flow, want_conv, want_mm, want_sched, smi, measure=True,
             params=None):
    """One forward through the port's entry point with the counters read
    just around it (conv2d_fused's split by schedule ``want_conv``,
    matmul_fused's ``want_sched``), held against the reference backend on
    the same weights (``params``, or drawn from the seed) and images."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    serve = ShapeConfig("serve", "prefill", 64, B)
    cm = tflow.compile(get_config(arch), serve, flow)
    ks = cm.plan.kernels
    if ks["conv2d"] != "cuda" or ks["matmul"] != "cuda":
        raise AssertionError(f"{arch}: plan.kernels {ks}")
    params = cm.init_params(SEED) if params is None else params
    rng = np.random.RandomState(SEED)
    cfg = cm.cfg
    x = torch.from_numpy(rng.randn(B, cfg.image_size, cfg.image_size,
                                   cfg.image_channels).astype(np.float32))
    batch = {"images": x.cuda()}
    reset_counts()
    y, _, _ = cm.prefill(params, batch)
    launches = read_counts()
    n_conv = sum(want_conv.values())
    if launches != {"conv2d_fused": n_conv, "matmul_fused": want_mm,
                    "flash_attention": 0, "decode_attention": 0,
                    "paged_decode_attention": 0, "copy_block": 0,
                    "lru_scan": 0, "matmul_fused_base": 0}:
        raise AssertionError(f"{arch}: launches {launches}, want "
                             f"{n_conv} conv / {want_mm} matmul")
    launches = {k: launches[k] for k in ("conv2d_fused", "matmul_fused")}
    schedules = _scheduled(want_sched, arch)
    conv_schedules = _scheduled(want_conv, arch, "conv2d_fused")
    ref = tflow.compile(get_config(arch), serve, flow, backend="reference")
    if any(b != "ref" for b in ref.plan.kernels.values()):
        raise AssertionError(f"reference plan {ref.plan.kernels}")
    yr, _, _ = ref.prefill(params, batch)
    err = _check_logits(arch, y, yr, cfg.vocab_size, flow.precision)
    rec = {"arch": arch, "flow": flow.precision, "mode": cm.plan.stream.mode,
           "units": cm.describe().splitlines()[2].strip(),
           "launches": launches, "matmul_schedules": schedules,
           "conv_schedules": conv_schedules,
           "logits_relerr_vs_reference": err,
           "logits_max_abs": y.float().abs().max().item()}
    if measure:
        m = cm.measure("prefill", iters=10, seed=SEED)
        mr = ref.measure("prefill", iters=10, seed=SEED)
        rec.update({"ms_per_forward": m["measured_step_s"] * 1e3,
                    "mean_ms_per_forward": m["mean_step_s"] * 1e3,
                    "images_per_s": m["images_per_s"],
                    "peak_bytes": m["peak_bytes"],
                    "reference_ms_per_forward": mr["measured_step_s"] * 1e3,
                    "device": m["device"], "nvidia_smi": smi,
                    "profile": _profile(lambda: cm.prefill(params, batch))})
    log(json.dumps({"path": rec}))
    return rec


def phase_path(smi):
    from repro_torch.configs.base import FlowConfig
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    out = []
    # ResNet-34's convs: the 7x7 stem (CI 3) on small_ci, the other 35 on
    # wgmma in bf16 and on ffma in fp32; the FC heads at batch 8 on small_m
    # in bf16, on ffma_small_m in fp32
    bf16_conv = {"wgmma": 35, "small_ci": 1}
    fp32_conv = {"ffma": 35, "small_ci": 1}
    flows = [("opt", FlowConfig(mode="auto"), bf16_conv, {"small_m": 1}),
             ("base", FlowConfig().base(), fp32_conv, {"ffma_small_m": 1}),
             ("folded", FlowConfig(mode="folded"), bf16_conv,
              {"small_m": 1})]
    for label, fl, conv, sched in flows:
        rec = _forward("resnet34", fl, conv, 1, sched, smi)
        rec["flow_name"] = label
        out.append(rec)
    if "4 folded: 3x1, 3x1, 5x1, 2x1" not in out[2]["units"]:
        raise AssertionError(f"folded flow units: {out[2]['units']}")
    # LeNet-5: both convs (CI 1 and 6) on small_ci; 400 -> 120 on small_m;
    # 120 -> 84 and 84 -> 10 (N or K not a multiple of 8) on simt
    out.append(_forward("lenet5", FlowConfig(mode="auto"), {"small_ci": 2},
                        3, {"small_m": 1, "simt": 2}, smi, measure=False))
    # MobileNetV1: the 12 pointwise convs from 64 channels up on wgmma, the
    # first conv (CI 3) on small_ci, the 32-channel pointwise conv on mid_ci
    DISPATCH_REJECTIONS.clear()
    out.append(_forward("mobilenetv1", FlowConfig(mode="auto"),
                        {"wgmma": 12, "small_ci": 1, "mid_ci": 1}, 1,
                        {"small_m": 1}, smi, measure=False))
    dw = sum(n for (op, _), n in DISPATCH_REJECTIONS.items()
             if op == "conv2d")
    if dw != 13:
        raise AssertionError(f"mobilenetv1: {dw} depthwise convs took the "
                             "reference op, want 13")
    return out


def _plan_launches(plan, mode):
    """Kernel launches one ``mode`` call of the model makes, derived from
    the plan: its live attention, matmul and RG-LRU ops, times each unit's
    reps (an RG-LRU scans with ``lru_scan`` in prefill; its decode step is
    plain elementwise work, so a model with one wants 0 there)."""
    from repro_torch.core.lowering import live_ops
    want = {"flash_attention": 0, "decode_attention": 0, "matmul_fused": 0}
    for unit in plan.units:
        for j in range(unit.period):
            blk = plan.graph.blocks[unit.indices[j]]
            for op in live_ops(blk, mode):
                if op.op == "attention":
                    k = "flash_attention" if mode == "prefill" \
                        else "decode_attention"
                    want[k] += unit.reps
                elif op.op in ("matmul", "glu_matmul"):
                    want["matmul_fused"] += unit.reps
                elif op.op == "rg_lru":
                    want["lru_scan"] = want.get("lru_scan", 0) + (
                        unit.reps if mode == "prefill" else 0)
    return want


def _counted(got, want, what):
    """The counts of the kernels in ``want`` (every other kernel must not
    have launched)."""
    got = {k: v for k, v in got.items() if k in want or v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def _lm_check_logits(what, y, yr, tol):
    b, V = yr.shape[0], yr.shape[-1]
    if tuple(y.shape) != (b, 1, V) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{what}: logits {tuple(y.shape)} not finite "
                             f"({b}, 1, {V})")
    err = relerr(y, yr)
    if err >= tol:
        raise AssertionError(f"{what}: logits relerr {err} vs the reference "
                             f"backend (tol {tol})")
    return err


def _flash_ab(cm_p, params, iters):
    """The fp32 prefill (``measure``, CUDA events) with flash_attention on
    its ffma schedule, then forced onto the SIMT kernel, then on ffma again
    (A, B, A in one process): what the new schedule moves end to end."""
    from repro_torch.kernels import attention as ka
    chosen = ka._schedule

    def prefill_ms(force_simt):
        if force_simt:
            ka._schedule = lambda dtype, D: "simt"
        try:
            return cm_p.measure("prefill", iters=iters, seed=SEED,
                                params=params)["measured_step_s"] * 1e3
        finally:
            ka._schedule = chosen
    a = prefill_ms(False)
    b = prefill_ms(True)
    return {"ffma_ms": [a, prefill_ms(False)], "simt_ms": b}


def phase_lm_path(smi):
    """Full-width llama3.2-1b through the port's entry points."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    rec = {"arch": LM_ARCH, "nvidia_smi": smi}
    serve = ShapeConfig("serve", "decode", LM_C, B)
    cm = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"))
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                     "matmul", "glu_matmul")):
        raise AssertionError(f"{LM_ARCH}: plan.kernels {ks}")
    ref = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"),
                        backend="reference")
    want_p = _plan_launches(cm.plan, "prefill")
    want_d = _plan_launches(cm.plan, "decode")
    n_mm = LM_LAYERS * len(LM_MATMULS)
    if want_p != {"flash_attention": LM_LAYERS, "decode_attention": 0,
                  "matmul_fused": n_mm} or \
            want_d != {"flash_attention": 0, "decode_attention": LM_LAYERS,
                       "matmul_fused": n_mm}:
        raise AssertionError(f"plan launches {want_p} / {want_d}")
    rec["units"] = cm.describe().splitlines()[2].strip()
    rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
    t0 = time.perf_counter()
    params = cm.init_params(SEED)
    torch.cuda.synchronize()
    rec["init_params_s"] = time.perf_counter() - t0
    V = cm.cfg.vocab_size
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, V, (B, LM_S)).astype(np.int64)).cuda()
    batch = {"tokens": prompt}

    # the main path: greedy generate, 32 tokens per row
    reset_counts()
    toks, _ = cm.generate(params, batch, steps=LM_STEPS)
    rec["launches"] = _counted(read_counts(), {
        k: want_p[k] + (LM_STEPS - 1) * want_d[k] for k in want_p},
        "generate")
    # 4096 prefill rows on wgmma, 8 decode rows on small_m
    rec["matmul_schedules"] = _lm_scheduled(
        want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
        "bf16", "generate")
    rec["flash_schedules"] = _flash_scheduled(want_p["flash_attention"],
                                              "bf16", "generate")
    rec["decode_schedules"] = _decode_scheduled(
        (LM_STEPS - 1) * want_d["decode_attention"], "bf16", "generate")
    if tuple(toks.shape) != (B, LM_STEPS) or not ((toks >= 0)
                                                  & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")

    # teacher-forced on those tokens, beside the reference backend
    reset_counts()
    y, st, _ = cm.prefill(params, batch)
    _counted(read_counts(), want_p, "one prefill")
    _scheduled({"wgmma": want_p["matmul_fused"]}, "one prefill")
    _flash_scheduled(want_p["flash_attention"], "bf16", "one prefill")
    yr, st_r, _ = ref.prefill(params, batch)
    errs = [_lm_check_logits("prefill", y, yr, PATH_TOL["bf16"])]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    same = torch.equal(y[:, -1].argmax(-1).to(torch.int32), toks[:, 0])
    for t in range(LM_STEPS - 1):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        y, st, _ = cm.decode(params, tok, st, LM_S + t)
        _counted(read_counts(), want_d, f"decode step {t}")
        _scheduled({"small_m": want_d["matmul_fused"]}, f"decode step {t}")
        _decode_scheduled(want_d["decode_attention"], "bf16",
                          f"decode step {t}")
        yr, st_r, _ = ref.decode(params, tok, st_r, LM_S + t)
        errs.append(_lm_check_logits(f"decode step {t}", y, yr,
                                     PATH_TOL["bf16"]))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
        same = same and torch.equal(y[:, -1].argmax(-1).to(torch.int32),
                                    toks[:, t + 1])
    rec["bf16"] = {"teacher_forced_repeats_generate": same,
                   "prefill_relerr": errs[0],
                   "decode_relerr_max": max(errs[1:]),
                   "decode_relerr": errs[1:],
                   "greedy_agreement_share": sum(agree) / len(agree),
                   "tokens_row0": toks[0].tolist()}
    log(f"llama bf16: prefill relerr {errs[0]:.3e}, decode relerr max "
        f"{max(errs[1:]):.3e}, greedy tokens agreeing with the reference "
        f"backend: {sum(agree) / len(agree):.3f}")

    # measurements: prefill at 8 x 512 tokens, decode steps
    pre = ShapeConfig("serve", "prefill", LM_S, B)
    cm_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"))
    ref_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"),
                          backend="reference")
    mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
    mpr = ref_p.measure("prefill", iters=5, seed=SEED, params=params)
    md = cm.measure("decode", iters=20, seed=SEED, params=params)
    mdr = ref.measure("decode", iters=20, seed=SEED, params=params)
    dstate = cm.init_state(B)
    dtok = {"tokens": prompt[:, :1]}
    rec["measure"] = {
        "device": mp["device"],
        "prefill_ms": mp["measured_step_s"] * 1e3,
        "prefill_mean_ms": mp["mean_step_s"] * 1e3,
        "prefill_tokens_per_s": mp["tokens_per_s"],
        "prefill_peak_bytes": mp["peak_bytes"],
        "reference_prefill_ms": mpr["measured_step_s"] * 1e3,
        "decode_ms": md["measured_step_s"] * 1e3,
        "decode_mean_ms": md["mean_step_s"] * 1e3,
        "decode_tokens_per_s": md["tokens_per_s"],
        "reference_decode_ms": mdr["measured_step_s"] * 1e3,
        "prefill_profile": _profile(lambda: cm_p.prefill(params, batch), 2),
        "decode_profile": _profile(
            lambda: cm.decode(params, dtok, dstate, 100), 10)}
    log(json.dumps({"lm_measure": rec["measure"]}))
    del params, st, st_r, dstate

    # fp32: greedy tokens identical to the reference backend's
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = tflow.compile(LM_ARCH, serve, f32)
    ref32 = tflow.compile(LM_ARCH, serve, f32, backend="reference")
    if cm32.plan.kernels["attention"] != "cuda":
        raise AssertionError(f"fp32 plan.kernels {cm32.plan.kernels}")
    p32 = cm32.init_params(SEED)
    reset_counts()
    t32, _ = cm32.generate(p32, batch, steps=LM_STEPS)
    rec["launches_fp32"] = _counted(read_counts(), rec["launches"],
                                    "fp32 generate")
    # 4096 prefill rows on ffma, 8 decode rows on ffma_small_m
    rec["matmul_schedules_fp32"] = _lm_scheduled(
        want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
        "fp32", "fp32 generate")
    rec["flash_schedules_fp32"] = _flash_scheduled(
        rec["launches"]["flash_attention"], "fp32", "fp32 generate")
    rec["decode_schedules_fp32"] = _decode_scheduled(
        rec["launches"]["decode_attention"], "fp32", "fp32 generate")
    t32r, _ = ref32.generate(p32, batch, steps=LM_STEPS)
    if not torch.equal(t32, t32r):
        diff = (t32 != t32r).float().mean().item()
        raise AssertionError(f"fp32 greedy tokens differ from the reference "
                             f"backend's ({diff:.3f} of them)")
    rec["fp32"] = {"greedy_identical_steps": LM_STEPS,
                   "tokens_row0": t32[0].tolist()}
    rec["fp32_prefill"] = _flash_ab(tflow.compile(LM_ARCH, pre, f32), p32,
                                    5)
    log(json.dumps({"lm_fp32_prefill": rec["fp32_prefill"]}))
    log(json.dumps({"lm_path": {k: v for k, v in rec.items()
                                if k != "measure"}}))
    return rec


# ---------------------------------------------------------------------------
# serving: the engine over the paged KV pool
# ---------------------------------------------------------------------------

# the serving configuration: full-width llama3.2-1b, 8 slots of up to 1024
# tokens in blocks of 16 (a pool of 1 + 8 x 64 = 513 blocks)
SERVE_SLOTS, SERVE_SEQ, SERVE_BS, SERVE_NEW = 8, 1024, 16, 32
SERVE_LIVE = [505 + 4 * b for b in range(8)]     # kernel phase: ~520 a row


def _paged_simt(q, kp, vp, bt, qpos, window):
    """The SIMT kernels of paged_decode_attention on the same operands,
    launched directly (no wrapper counts them)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kd
    b, sq, H, D = q.shape
    NB, bs, KV = kp.shape[0], kp.shape[1], kp.shape[2]
    nblk, R = bt.shape[1], sq * (H // KV)
    n_rt = -(-R // kd.paged_rows(D))
    nsplit = kd._simt_paged_splits(b, KV, n_rt, nblk * bs, kd._n_sm(q.device))
    ws = torch.empty(b * KV * nsplit * R * (D + 2), dtype=torch.float32,
                     device=q.device)
    qp = qpos.to(torch.int32).contiguous()
    out = torch.empty_like(q)

    def run():
        _build.call("paged_decode_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, kp, vp, bt, qp, out, ws)],
                    b, sq, H, KV, D, NB, bs, nblk, int(window or 0), 0.0,
                    nsplit, _build.stream())
        return out
    return run


def _paged_case(sq, dt, gen, H=LM_H, KV=LM_KV, D=LM_D, filled=SERVE_LIVE,
                window=None):
    """paged_decode_attention at the serving shape: 8 rows of ``filled``
    tokens so far (by default ~520) in a 513-block pool of 16-token blocks,
    one query a row (a decode tick) or five (a verify row of ngram:4).  The
    new schedule by CUDA graph and by events, beside the SIMT kernel
    (forced, by graph), gather + SDPA and the plain version."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    bs = SERVE_BS
    nblk = SERVE_SEQ // bs
    NB = 1 + SERVE_SLOTS * nblk
    q = torch.randn(B, sq, H, D, generator=gen, device=dev).to(dt)
    kp = torch.randn(NB, bs, KV, D, generator=gen, device=dev).to(dt)
    vp = torch.randn(NB, bs, KV, D, generator=gen, device=dev).to(dt)
    bt = (1 + torch.randperm(B * nblk, generator=gen, device=dev)
          .reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor(filled, dtype=torch.int32, device=dev)
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device=dev)[None]
    kw = dict(qpos=qpos if sq > 1 else None, window=window)
    C = nblk * bs
    kpos = torch.arange(C, device=dev)
    mask = (kpos[None, None, None, :] <= qpos[:, None, :, None])

    def library():                  # gather + SDPA, the yardstick only
        kc = kp[bt.long()].reshape(B, C, KV, D)
        vc = vp[bt.long()].reshape(B, C, KV, D)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.repeat_interleave(H // KV, 2).transpose(1, 2),
            vc.repeat_interleave(H // KV, 2).transpose(1, 2),
            attn_mask=mask).transpose(1, 2)

    live = [int(qpos[b].max().item()) + 1 for b in range(B)]
    flops = 4.0 * D * H * sum(sq * n for n in live)
    nbytes = (2 * sum(live) * KV * D + 2 * q.numel()) * q.element_size() \
        + (B * nblk + qpos.numel()) * 4

    def kern():
        return kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)

    def plain():
        return kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    prec = "bf16" if dt == torch.bfloat16 else "fp32"
    sched = _new_schedule("paged_decode_attention", kern, prec)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=100)
    c.update(shape=f"paged_B{B}_Sq{sq}_H{H}_KV{KV}_D{D}_bs{bs}_live"
                   f"{min(live)}-{max(live)}", sq=sq, schedule=sched,
             **_graph_times(c, kern, library))
    return _with_simt(c, _paged_simt(q, kp, vp, bt, qpos, window), plain, dt)


def _copy_case(dt, gen):
    """copy_block on the folded K and V pools of the serving configuration
    (16 layers x 513 blocks of 16 x 8 x 64 each), one fork: the kernel's
    CUDA-graph device time (and by events, the host's cost a call) beside
    the plain version's and ``torch._foreach_copy_`` on the two blocks (one
    PyTorch call for the same copies)."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    NB = 1 + SERVE_SLOTS * SERVE_SEQ // SERVE_BS
    pair = tuple(torch.randn(LM_LAYERS, NB, SERVE_BS, LM_KV, LM_D,
                             generator=gen, device=dev).to(dt)
                 for _ in range(2))
    plain_pair = tuple(p.clone() for p in pair)
    src, dst = 3, 400
    kd.copy_block(pair, src, dst)
    torch.cuda.synchronize()
    for p in plain_pair:
        kd.copy_block_plain(p, src, dst)
    if not all(torch.equal(a, b) for a, b in zip(pair, plain_pair)):
        raise AssertionError(f"copy_block {dt}: differs from its plain "
                             "version")
    # each pool's block read once and written once
    nbytes = 2.0 * 2 * LM_LAYERS * SERVE_BS * LM_KV * LM_D * \
        pair[0].element_size()
    bms, by = bound_ms(0.0, nbytes, dt)
    dsts, srcs = [p[:, dst] for p in pair], [p[:, src] for p in pair]

    def kern():
        kd.copy_block(pair, src, dst)

    def plain():
        for p in pair:
            kd.copy_block_plain(p, src, dst)

    def library():                      # one PyTorch call, the yardstick
        torch._foreach_copy_(dsts, srcs)
    return {"dtype": str(dt).split(".")[-1],
            "shape": f"pools_2x{LM_LAYERS}x{NB}x{SERVE_BS}x{LM_KV}x{LM_D}",
            "relerr": 0.0, "max_abs_err": 0.0, "tol": 0.0, "flops": 0.0,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "timer": "cuda_graph", "ms": graph_ms(kern, 200),
            "plain_ms": graph_ms(plain, 200),
            "library_ms": graph_ms(library, 200),
            "event_ms": cuda_ms(kern, 200),
            "plain_event_ms": cuda_ms(plain, 200),
            "library_event_ms": cuda_ms(library, 200)}


def phase_serving_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"paged_decode_attention": [], "copy_block": []}
    for dt in (torch.bfloat16, torch.float32):
        for sq in (1, 5):
            c = _paged_case(sq, dt, gen)
            cases["paged_decode_attention"].append(c)
            log(json.dumps({"kernel": "paged_decode_attention", **c}))
        c = _copy_case(dt, gen)
        cases["copy_block"].append(c)
        log(json.dumps({"kernel": "copy_block", **c}))
    cases["paged_decode_attention"] += [
        _simt_twin(c) for c in cases["paged_decode_attention"]]
    return cases


def _serve_workloads(V):
    """The serving workloads' requests, from RandomState(0): A, 16 prompts
    of 64-512 tokens; B, 8 prompts sharing a 392-token prefix with their
    own 16-token tails and one 200-token prompt (12.5 blocks) sent twice in
    each of two waves, ordered so that the second wave hits the prefix
    index and its two copies of the 200-token prompt share, and fork, the
    released partial block.  32 new tokens a request."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED)
    a = [Request(f"a{i}", rng.randint(0, V, int(rng.randint(64, 513))),
                 max_new_tokens=SERVE_NEW) for i in range(16)]
    prefix = rng.randint(0, V, 392)
    s = [Request(f"s{i}", np.concatenate([prefix, rng.randint(0, V, 16)]),
                 max_new_tokens=SERVE_NEW) for i in range(8)]
    p200 = rng.randint(0, V, 200)
    x = [Request(f"x{i}", p200, max_new_tokens=SERVE_NEW) for i in range(4)]
    return {"A": a, "B": s[:6] + x[:2] + s[6:] + x[2:]}


# workload -> (requests, engine knobs)
SERVE_KNOBS = {"A": ("A", {}), "B": ("B", dict(prefix_cache=True)),
               "C": ("A", dict(chunked_prefill=True, chunk_size=16,
                               speculation="ngram:4")),
               "D": ("A", dict(fori_seg=8))}


def _engine_run(cm, params, reqs, **kw):
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cm, params, EngineConfig(
        max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ, block_size=SERVE_BS,
        **kw))
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, rep


def _tokens(rep):
    return {r.rid: r.tokens for r in rep.results}


def _tick_ms(eng):
    """Median host-clock ms of a decode tick (tick spans end after the
    tick's read-back) and of a tick inside a decode segment."""
    ev = eng.tracer.events()
    ticks = sorted(e["dur"] / 1e3 for e in ev if e["name"] == "tick.decode")
    seg = sorted(e["dur"] / 1e3 / e["args"]["seg"] for e in ev
                 if e["name"] == "tick.fori")
    med = (lambda v: v[len(v) // 2] if v else None)
    return med(ticks), med(seg)


def _serve_record(eng, rep):
    m = rep.metrics
    tick, seg = _tick_ms(eng)
    return {k: m[k] for k in (
        "n_requests", "generated_tokens", "wall_s", "tokens_per_s",
        "p50_ttft_s", "p95_ttft_s", "p50_latency_s", "p95_latency_s",
        "decode_ticks", "prefill_batches", "admissions", "evictions",
        "refills", "fori_segments", "host_syncs", "host_syncs_per_token",
        "pool_blocks", "pool_bytes", "peak_used_blocks", "prefix_hits",
        "cow_forks", "catchup_tokens", "spec_ticks", "spec_tokens_drafted",
        "spec_tokens_accepted")} | {"ms_per_tick": tick,
                                     "ms_per_segment_tick": seg}


def _segment_is_host_free(cm, params):
    """A decode segment at the serving shape queues its 8 ticks without a
    device-to-host read: run it with PyTorch's sync debug mode set to
    raise on any synchronising call."""
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cm, params, EngineConfig(max_batch=SERVE_SLOTS,
                                          max_seq_len=SERVE_SEQ,
                                          block_size=SERVE_BS))
    cache = eng.new_cache()
    seg = cm.decode_segment(8)
    z = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    seg(params, cache.state, z, z, gen)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, _, _ = seg(params, cache.state, z, z + 8, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return tuple(toks.shape) == (SERVE_SLOTS, 8)


def _serve_want(rep, want_p, per_tick, n_forks=0):
    """The kernel launches of a serving run, from its prefill batches and
    decode ticks."""
    m = rep.metrics
    return {"flash_attention": want_p["flash_attention"] * m["prefill_batches"],
            "matmul_fused": want_p["matmul_fused"] * m["prefill_batches"]
            + per_tick["matmul_fused"] * m["decode_ticks"],
            "paged_decode_attention":
                per_tick["decode_attention"] * m["decode_ticks"],
            "copy_block": n_forks}


def phase_serving(smi):
    """Full-width llama3.2-1b through ``Engine.run`` over the paged pool."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    rec = {"arch": LM_ARCH, "nvidia_smi": smi, "slots": SERVE_SLOTS,
           "max_seq_len": SERVE_SEQ, "block_size": SERVE_BS}
    cm = tflow.compile(LM_ARCH, shape, FlowConfig(mode="folded"))
    ref = tflow.compile(LM_ARCH, shape, FlowConfig(mode="folded"),
                        backend="reference")
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("paged_decode_attention", "copy_block",
                                     "attention", "matmul", "glu_matmul")):
        raise AssertionError(f"serving plan.kernels {ks}")
    want_p = _plan_launches(cm.plan, "prefill")
    per_tick = _plan_launches(cm.plan, "decode")
    n_entries = 1                  # one folded unit, one attention state
    params = cm.init_params(SEED)
    works = _serve_workloads(cm.cfg.vocab_size)

    def counted(rep, what):
        return _counted(read_counts(), _serve_want(
            rep, want_p, per_tick, n_entries * rep.metrics["cow_forks"]),
            what)

    # the main path, bf16: each workload with the counts set to 0 just
    # before it and read just after
    runs, launches, scheds, fscheds = {}, {}, {}, {}
    for name, (wl, kw) in SERVE_KNOBS.items():
        reset_counts()
        eng, rep = _engine_run(cm, params, works[wl], trace=True, **kw)
        launches[name] = counted(rep, f"workload {name}")
        scheds[name] = _aligned_only(launches[name]["matmul_fused"], "bf16",
                                     f"workload {name}")
        fscheds[name] = _flash_scheduled(launches[name]["flash_attention"],
                                         "bf16", f"workload {name}")
        psched = _decode_scheduled(
            launches[name]["paged_decode_attention"], "bf16",
            f"workload {name}", "paged_decode_attention")
        runs[name] = rep
        r = _serve_record(eng, rep)
        r["launches"] = launches[name]
        r["matmul_schedules"] = scheds[name]
        r["flash_schedules"] = fscheds[name]
        r["paged_schedules"] = psched
        rec[f"bf16_{name}"] = r
        log(json.dumps({"serving": name, "precision": "bf16", **r}))
    b = runs["B"].metrics
    if b["prefix_hits"] < 1 or b["cow_forks"] < 1:
        raise AssertionError(f"workload B: prefix_hits {b['prefix_hits']}, "
                             f"cow_forks {b['cow_forks']}")
    rec["launches"] = {k: sum(launches[w][k] for w in launches)
                       for k in launches["A"]}
    rec["flash_schedules"] = {"wgmma": rec["launches"]["flash_attention"]}
    rec["paged_schedules"] = {
        "mma": rec["launches"]["paged_decode_attention"]}
    rec["segment_host_free"] = _segment_is_host_free(cm, params)

    # bf16 logits of A against the reference backend, up to each request's
    # first differing token
    _, cap = _engine_run(cm, params, works["A"], capture_logits=True)
    _, cap_r = _engine_run(ref, params, works["A"], capture_logits=True)
    errs, agree, total = [], 0, 0
    for r in cap.results:
        rr = cap_r.by_id[r.rid]
        for t, (a, b_) in enumerate(zip(r.tokens, rr.tokens)):
            la, lb = torch.from_numpy(r.logits[t]), torch.from_numpy(
                rr.logits[t])
            if not torch.isfinite(la).all():
                raise AssertionError(f"{r.rid}: logits not finite at {t}")
            errs.append(relerr(la, lb))
            if a != b_:
                break
        agree += sum(a == b_ for a, b_ in zip(r.tokens, rr.tokens))
        total += len(rr.tokens)
    if max(errs) >= PATH_TOL["bf16"]:
        raise AssertionError(f"serving bf16 logits relerr {max(errs)} vs the "
                             f"reference backend (tol {PATH_TOL['bf16']})")
    rec["bf16_logits"] = {"relerr_max": max(errs), "rows": len(errs),
                          "greedy_agreement_share": agree / total}
    log(f"serving bf16: logits relerr max {max(errs):.3e} over {len(errs)} "
        f"rows; greedy tokens agreeing with the reference backend: "
        f"{agree / total:.3f}")

    # the device-busy share of one profiled run (A's first wave)
    rec["profile"] = _profile(
        lambda: _engine_run(cm, params, works["A"][:SERVE_SLOTS]), 1)
    del params, cap, cap_r

    # fp32: every workload's greedy tokens equal the reference backend's;
    # C and D equal A, B equals its own cold run
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = tflow.compile(LM_ARCH, shape, f32)
    ref32 = tflow.compile(LM_ARCH, shape, f32, backend="reference")
    p32 = cm32.init_params(SEED)
    toks, launches32 = {}, {}
    for name, (wl, kw) in SERVE_KNOBS.items():
        reset_counts()
        eng, rep = _engine_run(cm32, p32, works[wl], **kw)
        launches32[name] = counted(rep, f"fp32 workload {name}")
        _aligned_only(launches32[name]["matmul_fused"], "fp32",
                      f"fp32 workload {name}")
        _flash_scheduled(launches32[name]["flash_attention"], "fp32",
                         f"fp32 workload {name}")
        _decode_scheduled(launches32[name]["paged_decode_attention"], "fp32",
                          f"fp32 workload {name}", "paged_decode_attention")
        _, rep_r = _engine_run(ref32, p32, works[wl], **kw)
        toks[name] = _tokens(rep)
        if toks[name] != _tokens(rep_r):
            raise AssertionError(f"fp32 workload {name}: greedy tokens "
                                 "differ from the reference backend's")
    _, cold = _engine_run(cm32, p32, works["B"])
    checks = {"C == A": toks["C"] == toks["A"], "D == A": toks["D"] == toks["A"],
              "B == B cold": toks["B"] == _tokens(cold)}
    if not all(checks.values()):
        raise AssertionError(f"fp32 serving identities {checks}")
    rec["fp32"] = {"identical_to_reference": list(SERVE_KNOBS),
                   "identities": list(checks),
                   "tokens_a0": toks["A"]["a0"]}
    rec["launches_fp32"] = {k: sum(launches32[w][k] for w in launches32)
                            for k in launches32["A"]}
    rec["paged_schedules_fp32"] = {
        "ffma": rec["launches_fp32"]["paged_decode_attention"]}
    log(json.dumps({"serving_path": {k: v for k, v in rec.items()
                                     if not k.startswith("bf16_")}}))
    return rec


# ---------------------------------------------------------------------------
# recurrent: the RG-LRU hybrid, recurrentgemma-2b
# ---------------------------------------------------------------------------

# recurrentgemma-2b at full width (configs/recurrentgemma_2b.py): 26 layers,
# (rec, rec, attn) x 8 + (rec, rec); 10 heads over 1 KV head of 256 with a
# 2048-token window; RG-LRU width 2560
RG_ARCH = "recurrentgemma-2b"
RG_S, RG_C, RG_H, RG_KV, RG_D, RG_W = 512, 1024, 10, 1, 256, 2560
RG_WINDOW, RG_ATTN, RG_REC = 2048, 8, 18
RG_MATMULS = 138       # a prefill or decode step: 8 attn x 6 + 18 rec x 5
RG_STEPS = 32
# the window run: one row, a 2080-token prompt (the window cuts in the
# prefill), 24 decode steps over the 2048-slot rolling cache (it wraps)
RG_LONG, RG_LONG_STEPS = 2080, 24
# workload R: 16 prompts of exactly 256 tokens (the bucket), 16-48 new
# tokens each, greedy, 8 slots of up to 1024 tokens in blocks of 16
RG_PROMPT, RG_REQS = 256, 16
# the paged kernel's case: 8 rows of 260-295 tokens so far (a 256-token
# prompt and its new tokens)
RG_FILLED = [260 + 5 * b for b in range(8)]


def _lru_case(shape, dt, gen):
    """lru_scan at one (B, S, W) shape: a in (0, 1) as the RG-LRU gate gives
    it, the kernel on its schedule by CUDA graph and by events, the
    sequential kernel it replaced at the same shape (launched directly, no
    wrapper counts it; held to the plain version too) by graph, the plain
    version by events.  The wrapper allocates h every call, so its graph
    replays write a fresh buffer each; ``direct_ms`` times the chunked
    kernel launched directly into one buffer, as the sequential kernel is.
    No single PyTorch call computes a linear recurrence, so there is no
    library time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import lru_scan as kl
    Bn, S, W = shape
    dev = torch.device("cuda")
    a = torch.rand(Bn, S, W, generator=gen, device=dev).to(dt)
    b = torch.randn(Bn, S, W, generator=gen, device=dev).to(dt)
    flops = 2.0 * a.numel()                         # one FMA an element
    nbytes = 3.0 * a.numel() * a.element_size()     # read a, b; write h
    hs = torch.empty_like(a)
    steps = kl.scan_geometry(Bn, S, W, a.element_size(),
                             torch.cuda.get_device_properties(
                                 0).multi_processor_count)[0]

    def kern():
        return kl.lru_scan(a, b)

    def seq():
        _build.call("lru_scan", _build.DTYPE_CODES[dt], a.data_ptr(),
                    b.data_ptr(), hs.data_ptr(), Bn, S, W, _build.stream())
        return hs

    def direct():      # the chunked kernel into one buffer, as seq() is
        _build.call("lru_scan_chunked", _build.DTYPE_CODES[dt],
                    a.data_ptr(), b.data_ptr(), hs.data_ptr(), Bn, S, W,
                    steps, _build.stream())
        return hs
    s0 = read_schedules("lru_scan")
    c = _timed_case(kern, lambda: kl.lru_scan_plain(a, b), None, dt, flops,
                    nbytes, iters=50)
    sched = [k for k, v in read_schedules("lru_scan").items() if v != s0[k]]
    p = kl.lru_scan_plain(a, b)
    seq_err = relerr(seq(), p)
    if seq_err >= TOL[dt]:
        raise AssertionError(f"lru_scan {shape} {dt}: the sequential "
                             f"kernel's relerr {seq_err}")
    c.update(shape=f"scan_B{Bn}_S{S}_W{W}", rows=Bn, B=Bn, S=S, W=W,
             schedule=sched[0], event_ms=c["ms"], ms=graph_ms(kern, 50),
             timer="cuda_graph", seq_ms=graph_ms(seq, 50),
             seq_relerr=seq_err,
             seq_max_abs_err=(seq().float() - p.float()).abs().max().item(),
             direct_ms=graph_ms(direct, 50), steps=steps)
    if relerr(direct(), p) >= TOL[dt]:
        raise AssertionError(f"lru_scan {shape} {dt}: the chunked kernel "
                             "launched directly differs from the plain "
                             "version")
    return c


def _seq_twin(c):
    """The sequential lru_scan kernel's record at a case's shape
    (``lru_scan[seq]`` in the kernels line)."""
    return {**c, "schedule": "seq", "ms": c["seq_ms"], "event_ms": None,
            "relerr": c["seq_relerr"], "max_abs_err": c["seq_max_abs_err"]}


def phase_lru_kernels(rg):
    """Phase 11: lru_scan at every (B, S, W) shape the recurrent path
    launched it at (fp32: ``op_rg_lru`` hands it fp32 ``a`` and ``b`` in
    both model precisions), and at the 8 x 512 prefill in bf16 (a kernel
    case no path runs).  At each path shape the chunked kernel must be no
    slower by graph device time than the sequential one."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    seen = {}
    for run in ("generate", "window", "serve"):
        for prec in ("bf16", "fp32"):
            for Bn, S, W, dt, n in rg[f"{run}_{prec}"]["lru_shapes"]:
                key = (Bn, S, W, dt)
                seen[key] = seen.get(key, 0) + n
    if any(k[3] != "float32" for k in seen):
        raise AssertionError(f"lru_scan path shapes {seen}: want fp32 only")
    cases = []
    for (Bn, S, W, dt), n in sorted(seen.items(), key=lambda kv: (
            -kv[0][0] * kv[0][1], kv[0])):
        c = {**_lru_case((Bn, S, W), torch.float32, gen), "path_launches": n}
        if c["ms"] > c["seq_ms"]:
            raise AssertionError(f"lru_scan {c['shape']}: chunked "
                                 f"{c['ms']:.4f} ms, slower than the "
                                 f"sequential kernel {c['seq_ms']:.4f}")
        cases.append(c)
        log(json.dumps({"kernel": "lru_scan", "arch": RG_ARCH, **c}))
    c = {**_lru_case((B, RG_S, RG_W), torch.bfloat16, gen),
         "path_launches": 0}
    cases.append(c)
    log(json.dumps({"kernel": "lru_scan", "arch": RG_ARCH, **c}))
    return {"lru_scan": cases}


def phase_rec_kernels():
    """Phase 9: the recurrent path's kernels at its shapes, bf16 and fp32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "paged_decode_attention": []}
    heads = dict(H=RG_H, KV=RG_KV, D=RG_D, window=RG_WINDOW)
    for dt in (torch.bfloat16, torch.float32):
        for kname, c in (
                ("flash_attention",
                 _flash_case(dt, gen, S=RG_S, iters=10, **heads)),
                ("flash_attention",
                 _flash_case(dt, gen, b=1, S=RG_LONG, iters=10, **heads)),
                ("decode_attention", _decode_case(
                    dt, gen, C=RG_C, qpos=RG_S + RG_STEPS - 2, **heads)),
                ("decode_attention", _decode_case(
                    dt, gen, b=1, C=RG_WINDOW,
                    qpos=RG_LONG + RG_LONG_STEPS - 2, **heads)),
                ("paged_decode_attention",
                 _paged_case(1, dt, gen, filled=RG_FILLED, **heads))):
            cases[kname].append(c)
            log(json.dumps({"kernel": kname, "arch": RG_ARCH, **c}))
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


def _rg_requests(V):
    """Workload R from RandomState(0): 16 prompts of exactly 256 tokens,
    16-48 new tokens each, so evictions and refills come at different
    ticks."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED)
    return [Request(f"r{i}", rng.randint(0, V, RG_PROMPT).astype(np.int32),
                    max_new_tokens=int(rng.randint(16, 49)))
            for i in range(RG_REQS)]


def _rg_engine(cm, params, reqs, **kw):
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cm, params, EngineConfig(
        max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ, block_size=SERVE_BS,
        prompt_buckets=(RG_PROMPT,), **kw))
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, rep


def _serve_logits(cap, ref, prec, what="workload R"):
    """Every logits row that ``cap`` captured against ``ref``'s, up to the
    first token where a request's two streams part: finite, and relerr
    under PATH_TOL[prec]."""
    errs, agree, total = [], 0, 0
    for x in cap.results:
        xr = ref.by_id[x.rid]
        for t, (a, b_) in enumerate(zip(x.tokens, xr.tokens)):
            la = torch.from_numpy(x.logits[t])
            if not torch.isfinite(la).all():
                raise AssertionError(f"{x.rid}: logits not finite")
            errs.append(relerr(la, torch.from_numpy(xr.logits[t])))
            if a != b_:
                break
        agree += sum(a == b_ for a, b_ in zip(x.tokens, xr.tokens))
        total += len(xr.tokens)
    if max(errs) >= PATH_TOL[prec]:
        raise AssertionError(f"{what} {prec} logits relerr {max(errs)} "
                             "vs the reference backend")
    return {"relerr_max": max(errs), "rows": len(errs),
            "greedy_agreement_share": agree / total}


def _refused(what, fn, match):
    """``fn`` must raise the ValueError that refuses ``what``."""
    try:
        fn()
    except ValueError as e:
        if match not in str(e):
            raise AssertionError(f"{what}: refused with {e!r}, want "
                                 f"{match!r}") from e
        return str(e)
    raise AssertionError(f"{what} was served; it must be refused")


def _lm_generate(cm, ref, params, prompt, steps, want_p, want_d, prec):
    """One generate through the port's entry point with the counts set to
    0 just before and read just after; then the prefill and each
    teacher-forced decode step held against the reference backend (logits
    within ``PATH_TOL[prec]``), and in fp32 the greedy tokens identical to
    the reference backend's."""
    b, S = prompt.shape
    batch = {"tokens": prompt}
    reset_counts()
    toks, _ = cm.generate(params, batch, steps=steps)
    launches = _counted(read_counts(), {
        k: want_p.get(k, 0) + (steps - 1) * want_d.get(k, 0)
        for k in set(want_p) | set(want_d)}, f"{prec} generate")
    # the prefill's rows (b x S >= 512) on wgmma (ffma in fp32), decode rows
    # (b <= 8) on small_m (ffma_small_m)
    sched = _lm_scheduled(want_p["matmul_fused"],
                          (steps - 1) * want_d["matmul_fused"], prec,
                          f"{prec} generate")
    fsched = _flash_scheduled(launches["flash_attention"], prec,
                              f"{prec} generate")
    dsched = _decode_scheduled(launches["decode_attention"], prec,
                               f"{prec} generate")
    lshapes = _lru_scheduled(launches.get("lru_scan", 0),
                             f"{prec} generate")
    V = cm.cfg.vocab_size
    if tuple(toks.shape) != (b, steps) or not ((toks >= 0) & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")
    rec = {"launches": launches, "matmul_schedules": sched,
           "flash_schedules": fsched, "decode_schedules": dsched,
           "lru_shapes": lshapes, "tokens_row0": toks[0].tolist()}
    if prec == "fp32":
        tr, _ = ref.generate(params, batch, steps=steps)
        if not torch.equal(toks, tr):
            diff = (toks != tr).float().mean().item()
            raise AssertionError(f"fp32 greedy tokens differ from the "
                                 f"reference backend's ({diff:.3f} of them)")
        rec["greedy_identical_steps"] = steps
    reset_counts()
    y, st, _ = cm.prefill(params, batch)
    _counted(read_counts(), want_p, "one prefill")
    _flash_scheduled(want_p["flash_attention"], prec, "one prefill")
    yr, st_r, _ = ref.prefill(params, batch)
    errs = [_lm_check_logits("prefill", y, yr, PATH_TOL[prec])]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    for t in range(steps - 1):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        y, st, _ = cm.decode(params, tok, st, S + t)
        _counted(read_counts(), want_d, f"decode step {t}")
        _decode_scheduled(want_d["decode_attention"], prec,
                          f"decode step {t}")
        yr, st_r, _ = ref.decode(params, tok, st_r, S + t)
        errs.append(_lm_check_logits(f"decode step {t}", y, yr,
                                     PATH_TOL[prec]))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
    rec.update(prefill_relerr=errs[0], decode_relerr_max=max(errs[1:]),
               greedy_agreement_share=sum(agree) / len(agree))
    return rec


def phase_rec_path(smi):
    """Phase 10: full-width recurrentgemma-2b (random weights from seed 0)
    through ``flow.compile`` (generate; the window run) and
    ``Engine.run`` (workload R), bf16 then fp32."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    rec = {"arch": RG_ARCH, "nvidia_smi": smi}
    gen_shape = ShapeConfig("serve", "decode", RG_C, B)
    long_shape = ShapeConfig("serve", "decode", 4096, 1)
    srv_shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    V = None
    runs = {}
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(RG_ARCH, gen_shape, fl)
        ref = tflow.compile(RG_ARCH, gen_shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                         "matmul", "glu_matmul", "rg_lru")):
            raise AssertionError(f"{RG_ARCH}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        if want_p != {"flash_attention": RG_ATTN, "decode_attention": 0,
                      "matmul_fused": RG_MATMULS, "lru_scan": RG_REC} or \
                want_d != {"flash_attention": 0, "decode_attention": RG_ATTN,
                           "matmul_fused": RG_MATMULS, "lru_scan": 0}:
            raise AssertionError(f"plan launches {want_p} / {want_d}")
        rec["units"] = cm.describe().splitlines()[2].strip()
        rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
        t0 = time.perf_counter()
        params = cm.init_params(SEED)
        torch.cuda.synchronize()
        rec[f"init_params_s_{prec}"] = time.perf_counter() - t0
        V = cm.cfg.vocab_size
        rs = np.random.RandomState(SEED)
        prompt = torch.from_numpy(rs.randint(0, V, (B, RG_S))).cuda()
        long_prompt = torch.from_numpy(rs.randint(0, V, (1, RG_LONG))).cuda()

        # a. generate: 32 tokens a row after a 512-token prompt
        g = _lm_generate(cm, ref, params, prompt, RG_STEPS, want_p, want_d,
                         prec)
        rec[f"generate_{prec}"] = g
        log(json.dumps({"rec_generate": prec, **g}))
        if prec == "bf16":
            pre = ShapeConfig("serve", "prefill", RG_S, B)
            cm_p = tflow.compile(RG_ARCH, pre, fl)
            ref_p = tflow.compile(RG_ARCH, pre, fl, backend="reference")
            mp = cm_p.measure("prefill", iters=3, seed=SEED, params=params)
            mpr = ref_p.measure("prefill", iters=3, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            mdr = ref.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": prompt[:, :1]}
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "reference_prefill_ms": mpr["measured_step_s"] * 1e3,
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "reference_decode_ms": mdr["measured_step_s"] * 1e3,
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, {"tokens": prompt}), 2),
                "decode_profile": _profile(
                    lambda: cm.decode(params, dtok, dstate, 100), 10)}
            log(json.dumps({"rec_measure": rec["measure"]}))
            del dstate
        else:
            rec["fp32_prefill"] = _flash_ab(tflow.compile(
                RG_ARCH, ShapeConfig("serve", "prefill", RG_S, B), fl),
                params, 3)
            log(json.dumps({"rec_fp32_prefill": rec["fp32_prefill"]}))

        # b. the window: 2080-token prompt, 24 steps over 2048 slots
        cml = tflow.compile(RG_ARCH, long_shape, fl)
        refl = tflow.compile(RG_ARCH, long_shape, fl, backend="reference")
        if cml.plan.cache_len != RG_WINDOW:
            raise AssertionError(f"window run: cache_len "
                                 f"{cml.plan.cache_len}")
        w = _lm_generate(cml, refl, params, long_prompt, RG_LONG_STEPS,
                         _plan_launches(cml.plan, "prefill"),
                         _plan_launches(cml.plan, "decode"), prec)
        rec[f"window_{prec}"] = w
        log(json.dumps({"rec_window": prec, **w}))

        # c. serving: workload R through Engine.run
        cms = tflow.compile(RG_ARCH, srv_shape, fl)
        refs = tflow.compile(RG_ARCH, srv_shape, fl, backend="reference")
        sp = _plan_launches(cms.plan, "prefill")
        st = _plan_launches(cms.plan, "decode")
        reqs = _rg_requests(V)
        reset_counts()
        eng, rep = _rg_engine(cms, params, reqs, trace=prec == "bf16")
        m = rep.metrics
        want = {"flash_attention": sp["flash_attention"] * m["prefill_batches"],
                "lru_scan": sp["lru_scan"] * m["prefill_batches"],
                "matmul_fused": sp["matmul_fused"] * m["prefill_batches"]
                + st["matmul_fused"] * m["decode_ticks"],
                "paged_decode_attention":
                    st["decode_attention"] * m["decode_ticks"]}
        s_launch = _counted(read_counts(), want, f"{prec} workload R")
        # prefill batches (>= 256 rows) on wgmma (ffma in fp32), ticks on
        # small_m (ffma_small_m)
        s_sched = _lm_scheduled(
            sp["matmul_fused"] * m["prefill_batches"],
            st["matmul_fused"] * m["decode_ticks"], prec,
            f"{prec} workload R")
        f_sched = _flash_scheduled(want["flash_attention"], prec,
                                   f"{prec} workload R")
        p_sched = _decode_scheduled(want["paged_decode_attention"], prec,
                                    f"{prec} workload R",
                                    "paged_decode_attention")
        l_shapes = _lru_scheduled(want["lru_scan"], f"{prec} workload R")
        runs[prec] = rep
        r = _serve_record(eng, rep)
        r.update(launches=s_launch, matmul_schedules=s_sched,
                 flash_schedules=f_sched, paged_schedules=p_sched,
                 lru_shapes=l_shapes,
                 dense_state_bytes=eng.last_cache.dense_bytes())
        rec[f"serve_{prec}"] = r
        log(json.dumps({"serving": "R", "arch": RG_ARCH, "precision": prec,
                        **r}))
        _, rep_r = _rg_engine(refs, params, reqs, capture_logits=True)
        _, cap = _rg_engine(cms, params, reqs, capture_logits=True)
        logits = _serve_logits(cap, rep_r, prec)
        if prec == "fp32":
            if not _tokens(rep) == _tokens(cap) == _tokens(rep_r):
                raise AssertionError("fp32 workload R: greedy tokens differ "
                                     "from the reference backend's")
            rec["serve_fp32"].update(identical_to_reference=True,
                                     logits=logits)
        else:
            rec["serve_bf16_logits"] = logits
            # the refusals, with the recurrent state's own messages
            pad = [dataclasses.replace(reqs[0], rid="pad",
                                       prompt=reqs[0].prompt[1:])]
            rec["refusals"] = {
                "padded_prompt": _refused(
                    "a padded prompt", lambda: _rg_engine(cms, params, pad),
                    "recurrent temporal-mixing"),
                "prefix_cache": _refused(
                    "prefix_cache", lambda: _rg_engine(
                        cms, params, reqs[:1], prefix_cache=True),
                    "prefix_cache requires a pure attention decoder"),
                "chunked_prefill": _refused(
                    "chunked prefill", lambda: _rg_engine(
                        cms, params, reqs[:1], chunked_prefill=True),
                    "chunked prefill"),
                "speculation": _refused(
                    "speculation", lambda: _rg_engine(
                        cms, params, reqs[:1], speculation="ngram:4"),
                    "speculative decoding needs")}
            rec["serve_profile"] = _profile(
                lambda: _rg_engine(cms, params, reqs[:SERVE_SLOTS]), 1)
            log(json.dumps({"rec_serving_checks": {
                k: rec[k] for k in ("serve_bf16_logits", "serve_profile")}}))
        del params, cm, ref, cml, refl, cms, refs
        torch.cuda.empty_cache()
    for prec in ("bf16", "fp32"):
        g, w = rec[f"generate_{prec}"], rec[f"window_{prec}"]
        log(f"{RG_ARCH} {prec}: logits relerr vs the reference backend: "
            f"generate prefill {g['prefill_relerr']:.3e}, decode max "
            f"{g['decode_relerr_max']:.3e}; window prefill "
            f"{w['prefill_relerr']:.3e}, decode max "
            f"{w['decode_relerr_max']:.3e}")
    log(f"{RG_ARCH}: workload R logits relerr vs the reference backend: bf16 "
        f"{rec['serve_bf16_logits']['relerr_max']:.3e}, fp32 "
        f"{rec['serve_fp32']['logits']['relerr_max']:.3e}")
    log(f"{RG_ARCH}: fp32 greedy tokens identical to the reference backend "
        "(generate, window, workload R)")
    return rec


# ---------------------------------------------------------------------------
# the rest of the dense family: qwen1.5-4b, phi4-mini-3.8b, stablelm-1.6b
# ---------------------------------------------------------------------------

# at full width and depth (configs/qwen15_4b.py, phi4_mini_38b.py,
# stablelm_16b.py): qwen 40 layers, 20 heads over 20 KV heads of 128, QKV
# bias, rope base 1e6; phi4 32 layers, 24 over 8 of 128, rope on 96 of 128,
# tied embeddings; stablelm 24 layers, 32 over 32 of 64, LayerNorm, rope on
# 16 of 64, QKV bias.  Each generates (a 512-token prompt a row, 32 greedy
# tokens, at llama's ShapeConfig("serve", "decode", 1024, 8)) and serves
# workload A (llama's serving configuration: 8 slots of 1024 tokens in
# blocks of 16, a pool of 513 blocks), bf16 then fp32.
DENSE_ARCHS = ("qwen1.5-4b", "phi4-mini-3.8b", "stablelm-1.6b")


def _heads(arch):
    """(layers, heads, KV heads, head width) of a full config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    a = cfg.attention
    return cfg.n_layers, a.n_heads, a.n_kv_heads, a.head_dim


def _plan_matmuls(plan):
    """The distinct matmul_fused shapes of one prefill (or decode step) of
    the plan, as [(name, K, N, GLU pair, launches)]: the projections as the
    fusion pass left them (a QKV bias stays its own op: the pass fuses a
    bias only into the matmul just before it, as the JAX package's does)."""
    from repro_torch.core.lowering import live_ops
    uses = {}
    for unit in plan.units:
        for j in range(unit.period):
            blk = plan.graph.blocks[unit.indices[j]]
            for op in live_ops(blk, "prefill"):
                if op.op in ("matmul", "glu_matmul"):
                    if op.attrs.get("bias"):
                        raise AssertionError(f"{op.op} with a fused bias")
                    K, N = op.params[0].shape
                    key = (K, N, op.op == "glu_matmul")
                    uses[key] = uses.get(key, 0) + unit.reps
    return [(f"{K}to{N}" + ("_glu" if glu else ""), K, N, glu, n)
            for (K, N, glu), n in uses.items()]


def phase_dense_kernels():
    """Phase 12: the kernels of qwen1.5-4b, phi4-mini-3.8b and
    stablelm-1.6b at their heads and projections, bf16 and fp32:
    flash_attention at the 8 x 512 prefill, decode_attention over the
    1024-slot cache half full, paged_decode_attention at a workload-A tick
    (Sq 1), each beside the SIMT kernel, SDPA (gather + SDPA) and the
    plain version; matmul_fused at every projection of a layer at the
    prefill's 4096 rows and a decode step's 8.  Each case carries its
    model's name."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "paged_decode_attention": [], "matmul_fused": []}
    for arch in DENSE_ARCHS:
        _, H, KV, D = _heads(arch)
        plan = tflow.compile(arch, ShapeConfig("serve", "decode", LM_C, B),
                             FlowConfig(mode="folded")).plan
        for dt in (torch.bfloat16, torch.float32):
            heads = dict(H=H, KV=KV, D=D)
            for kname, c in (
                    ("flash_attention", _flash_case(dt, gen, **heads)),
                    ("decode_attention", _decode_case(dt, gen, **heads)),
                    ("paged_decode_attention",
                     _paged_case(1, dt, gen, **heads))):
                cases[kname].append({**c, "arch": arch})
                log(json.dumps({"kernel": kname, "arch": arch, **c}))
            for M in (B * LM_S, B):
                for name, K, N, glu, uses in _plan_matmuls(plan):
                    c = _lm_matmul_case(name, M, K, N, glu, dt, gen, uses)
                    cases["matmul_fused"].append({**c, "arch": arch})
                    log(json.dumps({"kernel": "matmul_fused", "arch": arch,
                                    **c}))
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


def _widened(params):
    """The parameter tree in fp32: the fp32 runs take the bf16 draw
    widened, not a second draw."""
    return {k: {n: t.float() for n, t in d.items()}
            for k, d in params.items()}


def _unembed(cm, params):
    """CUDA-event ms of the head's ``op_unembed`` at a decode step's 8 rows
    (the whole table widened to fp32, then an fp32 GEMM), on the model's
    own table."""
    from types import SimpleNamespace
    from repro_torch.core.ops_impl import op_unembed
    cfg = cm.cfg
    dt = cm.plan.prec.compute_dtype
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["head"]["lm_head"]
    x = torch.randn(B, 1, cfg.d_model, device=table.device).to(dt)
    ctx = SimpleNamespace(compute_dtype=dt)
    op = SimpleNamespace(attrs={"true_vocab": cfg.vocab_size})

    def fn():
        return op_unembed(ctx, op, {"lm_head": table}, x)
    return cuda_ms(fn, 10, 2)


def _serve_split(eng, rep, shapes, prec):
    """matmul_fused's launches of a traced serving run by schedule: each
    prefill batch's projections (its rows: batch bucket x prompt bucket)
    on the precision's large-M schedule above ``SMALL_M_MAX`` rows of the
    form, small-M at or below; every decode tick's on small-M."""
    from repro_torch.kernels.matmul_fused import SMALL_M_MAX
    big, small = LM_SCHEDULES[prec]
    want = {big: 0, small: sum(n for *_, n in shapes)
            * rep.metrics["decode_ticks"]}
    batches = [e["args"] for e in eng.tracer.events()
               if e["name"] == "prefill"]
    if len(batches) != rep.metrics["prefill_batches"]:
        raise AssertionError(f"{len(batches)} prefill spans, "
                             f"{rep.metrics['prefill_batches']} batches")
    for a in batches:
        rows = a["batch"] * a["bucket"]
        for _, _, _, glu, n in shapes:
            want[small if rows <= SMALL_M_MAX[glu] else big] += n
    return want


def _dense_model(arch, smi):
    """One model of the rest of the dense family through ``generate`` and
    ``Engine.run`` on workload A, bf16 then fp32, each held to the
    ``reference`` backend; its weights, states and pools freed after."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    layers, H, KV, D = _heads(arch)
    shape = ShapeConfig("serve", "decode", LM_C, B)
    rec = {"arch": arch, "nvidia_smi": smi, "layers": layers,
           "heads": [H, KV, D]}
    params = prompt = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(arch, shape, fl)
        ref = tflow.compile(arch, shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in (
                "attention", "decode_attention", "paged_decode_attention",
                "matmul", "glu_matmul")):
            raise AssertionError(f"{arch}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        shapes = _plan_matmuls(cm.plan)
        if want_p != {"flash_attention": layers, "decode_attention": 0,
                      "matmul_fused": 6 * layers} or \
                want_d != {"flash_attention": 0, "decode_attention": layers,
                           "matmul_fused": 6 * layers} or \
                sum(n for *_, n in shapes) != 6 * layers:
            raise AssertionError(f"{arch}: plan launches {want_p} / "
                                 f"{want_d}, shapes {shapes}")
        if prec == "bf16":
            rec["units"] = cm.describe().splitlines()[2].strip()
            rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
            t0 = time.perf_counter()
            params = cm.init_params(SEED)
            torch.cuda.synchronize()
            rec["init_params_s"] = time.perf_counter() - t0
            rec["params"] = sum(t.numel() for d in params.values()
                                for t in d.values())
            prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cm.cfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()
        else:
            params = _widened(params)
            torch.cuda.empty_cache()

        # a. generate: 32 greedy tokens a row after the 512-token prompt
        g = _lm_generate(cm, ref, params, prompt, LM_STEPS, want_p, want_d,
                         prec)
        rec[f"generate_{prec}"] = g
        log(json.dumps({"dense_generate": arch, "precision": prec, **g}))
        if prec == "bf16":
            cm_p = tflow.compile(arch, ShapeConfig("serve", "prefill", LM_S,
                                                   B), fl)
            mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": prompt[:, :1]}
            dprof = _profile(lambda: cm.decode(params, dtok, dstate, 100),
                             10)
            un = _unembed(cm, params)
            step_busy = dprof["device_busy_ms"] / dprof["iters"]
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, {"tokens": prompt}), 2),
                "decode_profile": dprof, "unembed_ms": un,
                "unembed_share_of_decode_ms":
                    un / (md["measured_step_s"] * 1e3),
                "unembed_share_of_device_ms": un / step_busy
                if step_busy else None}
            log(json.dumps({"dense_measure": arch, **rec["measure"]}))
            del cm_p, dstate

        # b. serving: workload A through Engine.run
        reqs = _serve_workloads(cm.cfg.vocab_size)["A"]
        reset_counts()
        eng, rep = _engine_run(cm, params, reqs, trace=True)
        launches = _counted(read_counts(), _serve_want(rep, want_p, want_d),
                            f"{arch} {prec} workload A")
        r = _serve_record(eng, rep)
        r.update(
            launches=launches,
            matmul_schedules=_scheduled(_serve_split(eng, rep, shapes, prec),
                                        f"{arch} {prec} workload A"),
            flash_schedules=_flash_scheduled(
                launches["flash_attention"], prec,
                f"{arch} {prec} workload A"),
            paged_schedules=_decode_scheduled(
                launches["paged_decode_attention"], prec,
                f"{arch} {prec} workload A", "paged_decode_attention"))
        elem = 2 if prec == "bf16" else 4
        pool = 2 * layers * r["pool_blocks"] * SERVE_BS * KV * D * elem
        if r["pool_blocks"] != 1 + SERVE_SLOTS * SERVE_SEQ // SERVE_BS \
                or r["pool_bytes"] != pool:
            raise AssertionError(f"{arch} {prec}: pool {r['pool_blocks']} "
                                 f"blocks, {r['pool_bytes']} bytes, want "
                                 f"{pool}")
        toks = _tokens(rep)
        del eng, rep
        if prec == "fp32":
            # the kernel engine's pool is freed before the reference's
            torch.cuda.empty_cache()
            _, rep_r = _engine_run(ref, params, reqs)
            if toks != _tokens(rep_r):
                raise AssertionError(f"{arch} fp32 workload A: greedy tokens "
                                     "differ from the reference backend's")
            r["identical_to_reference"] = True
            del rep_r
        rec[f"serve_{prec}"] = r
        log(json.dumps({"serving": "A", "arch": arch, "precision": prec,
                        **r}))
        del cm, ref
        torch.cuda.empty_cache()
    del params, prompt
    torch.cuda.empty_cache()
    g16, g32 = rec["generate_bf16"], rec["generate_fp32"]
    log(f"{arch}: bf16 logits relerr vs the reference backend: prefill "
        f"{g16['prefill_relerr']:.3e}, decode max "
        f"{g16['decode_relerr_max']:.3e}, greedy agreement "
        f"{g16['greedy_agreement_share']:.3f}; fp32 greedy tokens identical "
        f"to it (generate, workload A); fp32 logits relerr max "
        f"{max(g32['prefill_relerr'], g32['decode_relerr_max']):.3e}")
    return rec


def phase_dense_path(smi):
    """Phase 13: qwen1.5-4b, phi4-mini-3.8b and stablelm-1.6b at full width
    and depth (random weights from seed 0) through ``flow.compile`` →
    ``generate`` and ``Engine.run``, one model after the other."""
    out = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _dense_model(arch, smi)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {out[arch]['seconds']:.1f}s")
    return out


# kernels with schedules
# ---------------------------------------------------------------------------
# training: full-width llama3.2-1b and ResNet-34 on the card, then their
# trained weights served through the kernels
# ---------------------------------------------------------------------------

TRAIN_S, TRAIN_STEPS, TRAIN_CNN_STEPS = 512, 20, 10


def _train_run(cm, opt, params, batch, steps, what, kernels):
    """``steps`` train steps of ``opt`` on one fixed batch from
    ``opt.init``, the launch counts zeroed just before and read just after:
    the forward products run on the hand kernels (bf16 on the tensor-core
    schedules), so every kernel in ``kernels`` must have launched, every
    other none, and none on simt; no dispatch rejection.  Returns (losses,
    host ms a step, the optimizer state, the launches and their schedules,
    the device's peak bytes over the run)."""
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    step = cm.train_step(opt)
    state = opt.init(params)
    DISPATCH_REJECTIONS.clear()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))          # reads back: the step ends
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in read_counts().items() if v}
    if set(got) != set(kernels):
        raise AssertionError(f"{what}: launches {got}, want each of "
                             f"{sorted(kernels)} and no other")
    sched = {k: {s: n for s, n in read_schedules(k).items() if n}
             for k in kernels}
    if any("simt" in v for v in sched.values()):
        raise AssertionError(f"{what}: a launch on simt: {sched}")
    if DISPATCH_REJECTIONS:
        raise AssertionError(f"{what}: dispatch rejections "
                             f"{DISPATCH_REJECTIONS}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return losses, ms, state, {"launches": got, "schedules": sched}, peak


def _device_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v).cuda() for k, v in batch.items()}


def _tree_relerr(a, b):
    """Max over leaves of ``relerr`` (nested dicts of tensors)."""
    from repro_torch.optim.adamw import tree_leaves
    return max(relerr(x.cpu(), y.cpu()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def _serve_trained_lm(params, prompt, smi):
    """The trained llama weights through the kernels: cast to bf16 into
    ``ShapeConfig("serve", "decode", 1024, 8)``, a 32-step generate with
    the launches by schedule the plan says, the prefill's and every
    teacher-forced step's logits against the reference backend (< 5e-2);
    then the fp32 tree in an fp32 serve plan, greedy tokens identical to
    the reference backend's."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.optim.adamw import tree_map
    serve = ShapeConfig("serve", "decode", LM_C, B)
    out = {}
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(LM_ARCH, serve, fl)
        ref = tflow.compile(LM_ARCH, serve, fl, backend="reference")
        p = tree_map(lambda t: t.to(torch.bfloat16), params) \
            if prec == "bf16" else params
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        reset_counts()
        toks, _ = cm.generate(p, {"tokens": prompt}, steps=LM_STEPS)
        rec = {"launches": _counted(read_counts(), {
            k: want_p[k] + (LM_STEPS - 1) * want_d[k] for k in want_p},
            f"trained {prec} generate")}
        rec["matmul_schedules"] = _lm_scheduled(
            want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
            prec, f"trained {prec} generate")
        rec["flash_schedules"] = _flash_scheduled(
            want_p["flash_attention"], prec, f"trained {prec} generate")
        rec["decode_schedules"] = _decode_scheduled(
            (LM_STEPS - 1) * want_d["decode_attention"], prec,
            f"trained {prec} generate")
        V = cm.cfg.vocab_size
        # the synthetic stream's rule: the next token is (31 t + 7) mod V
        # three times in four; the share of generated tokens that follow it
        nxt = torch.cat([prompt[:, -1:].to(torch.int32), toks[:, :-1]], 1)
        rec["follows_rule_share"] = ((nxt * 31 + 7) % V == toks) \
            .float().mean().item()
        if prec == "bf16":
            y, st, _ = cm.prefill(p, {"tokens": prompt})
            yr, st_r, _ = ref.prefill(p, {"tokens": prompt})
            errs = [_lm_check_logits("trained prefill", y, yr,
                                     PATH_TOL["bf16"])]
            for t in range(LM_STEPS - 1):
                tok = {"tokens": toks[:, t:t + 1].long()}
                y, st, _ = cm.decode(p, tok, st, TRAIN_S + t)
                yr, st_r, _ = ref.decode(p, tok, st_r, TRAIN_S + t)
                errs.append(_lm_check_logits(f"trained decode step {t}", y,
                                             yr, PATH_TOL["bf16"]))
            rec.update({"prefill_relerr": errs[0],
                        "decode_relerr_max": max(errs[1:])})
            del st, st_r
        else:
            tr, _ = ref.generate(p, {"tokens": prompt}, steps=LM_STEPS)
            if not torch.equal(toks, tr):
                raise AssertionError("trained fp32 greedy tokens differ from "
                                     "the reference backend's")
            rec["greedy_identical_steps"] = LM_STEPS
        rec["tokens_row0"] = toks[0].tolist()
        out[prec] = rec
        del p
    return out


def _card_vs_cpu(smi):
    """One ``make_train_step`` (AdamW without the clip, its default
    ``eps``) on a 2-layer llama3.2-1b at full width (d_model, heads, d_ff
    and vocab; depth cut only to keep the CPU side short), fp32, on the
    card (the forward on the hand kernels' fp32 schedules) and on the host's
    CPU (the reference ops) from the same initial tree and a 2 x 256
    SyntheticLM batch.  The first call's rate is 0 (the schedule starts
    there), so its first moment is (1 - b1) g exactly as the step computed
    g: holding that moment holds the gradients.  Then one AdamW update of
    the card's own gradients from the card's state, on the card and on the
    CPU: at the default ``eps`` an update is about ``lr * sign(g)``, and a
    gradient at the two devices' fp32 noise would flip sign between them,
    so the update is held on the same gradients.  Limits: loss relerr <
    1e-5, every gradient and updated parameter < 1e-4."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, \
        tree_map
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    shape = ShapeConfig("train", "train", 256, 2)
    f32 = FlowConfig(mode="folded", precision="fp32")
    opt = AdamW(lr=1e-3, grad_clip=0.0, warmup_steps=1, total_steps=10)
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                 global_batch=2, seed=1)).get(0)
    runs = {}
    p0 = None
    for dev in ("cuda", "cpu"):
        cm = tflow.compile(cfg, shape, f32, device=dev)
        if p0 is None:
            p0 = cm.init_params(SEED)
        params = tree_map(lambda t: t.to(cm.device, copy=True), p0)
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(cm.device)
                 for k, v in raw.items()}
        step = cm.train_step(opt)
        state = opt.init(params)
        if dev == "cuda":
            reset_counts()
        t0 = time.perf_counter()
        params, state, m0 = step(params, state, batch)
        runs[dev] = {"loss": float(m0["loss"]), "s": time.perf_counter() - t0,
                     "grads": tree_map(lambda t: t / (1 - opt.b1), state.mu)}
        if dev == "cuda":
            runs[dev]["launches"] = {k: v for k, v in read_counts().items()
                                     if v}
            runs[dev]["schedules"] = read_schedules()
            runs[dev]["state"] = (params, state)
        del params, state
    g, c = runs["cuda"], runs["cpu"]
    if set(g["launches"]) != {"matmul_fused", "flash_attention"}:
        raise AssertionError(f"card against CPU: launches {g['launches']}")
    grads = g["grads"]
    params, state = g["state"]
    cpu = lambda t: t.cpu().clone()                         # noqa: E731
    pc, sc = tree_map(cpu, params), AdamWState(
        cpu(state.step), tree_map(cpu, state.mu), tree_map(cpu, state.nu))
    gc = tree_map(cpu, grads)
    params, _, _ = opt.update(grads, state, params)
    pc, _, _ = opt.update(gc, sc, pc)
    rec = {"n_layers": 2, "tokens": 512, "eps": opt.eps,
           "loss_card": g["loss"], "loss_cpu": c["loss"],
           "loss_relerr": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
           "grad_relerr_max": _tree_relerr(grads, c["grads"]),
           "param_relerr_max": _tree_relerr(params, pc),
           "launches": g["launches"],
           "matmul_schedules": {k: v for k, v in g["schedules"].items() if v},
           "card_s": g["s"], "cpu_s": c["s"]}
    rec["update_max_abs"] = max(
        (x - y.cpu()).abs().max().item() for x, y in
        zip(tree_leaves(pc), tree_leaves(p0)))
    if rec["loss_relerr"] >= 1e-5 or rec["grad_relerr_max"] >= 1e-4 or \
            rec["param_relerr_max"] >= 1e-4 or rec["update_max_abs"] == 0:
        raise AssertionError(f"card against CPU: {rec}")
    return rec


def _train_resnet(smi):
    """ResNet-34 at 224 px, batch 8: 10 AdamW steps on one fixed batch
    (BatchNorm on the batch's statistics), the checkpoint round trip on
    the card, one step after restore against the uninterrupted step, then
    the trained tree served through conv2d_fused and matmul_fused in bf16
    and fp32 against the reference backend."""
    import shutil
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    cm = tflow.compile("resnet34", ShapeConfig("train", "train", 64, B),
                       FlowConfig(mode="folded"))
    params = cm.init_params(SEED)
    c = cm.cfg                         # 224 px, 3 channels, 1000 classes
    batch = _device_batch(SyntheticImages(
        DataConfig(vocab_size=c.vocab_size, seq_len=0, global_batch=B),
        c.image_size, c.image_channels, c.vocab_size).get(0))
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=TRAIN_CNN_STEPS)
    losses, ms, state, kern, peak = _train_run(
        cm, opt, params, batch, TRAIN_CNN_STEPS, "resnet34 train",
        ("conv2d_fused", "matmul_fused"))
    if losses[-1] > losses[0] - 0.5:
        raise AssertionError(f"resnet34: losses {losses} fell less than 0.5")
    # the convs on the tensor-core schedules (the stem on small_ci), the
    # FC on small_m
    sched = kern["schedules"]
    if set(sched["conv2d_fused"]) != {"wgmma", "small_ci"} or \
            set(sched["matmul_fused"]) != {"small_m"}:
        raise AssertionError(f"resnet34 train: launches by schedule {sched}")
    rec = {"losses": losses, "host_ms_per_step": ms, "kernels": kern,
           "peak_bytes_train": peak}
    # the checkpoint round trip: bit-exact, then one step from each
    ckdir = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    tree = {"params": params, "opt": state}
    t0 = time.perf_counter()
    ckpt.save(ckdir, TRAIN_CNN_STEPS, tree)
    back = ckpt.restore(ckdir, TRAIN_CNN_STEPS, tree)
    rec["ckpt_s"] = time.perf_counter() - t0
    flat, flat_b = ckpt._flatten(tree), ckpt._flatten(back)
    rec["ckpt_bytes"] = sum(t.numel() * t.element_size()
                            for t in flat.values())
    if list(flat) != list(flat_b) or not all(
            torch.equal(flat[k], flat_b[k]) and
            flat[k].dtype == flat_b[k].dtype for k in flat):
        raise AssertionError("resnet34: the checkpoint did not restore "
                             "bit-exactly")
    shutil.rmtree(ckdir)
    step = cm.train_step(opt)
    pa, _, ma = step(params, state, batch)
    pb, _, mb = step(back["params"], back["opt"], batch)
    rec["resume_param_relerr_max"] = _tree_relerr(pa, pb)
    rec["resume_loss"] = [float(ma["loss"]), float(mb["loss"])]
    if rec["resume_param_relerr_max"] >= 1e-4:
        raise AssertionError(f"resnet34: the step after restore differs "
                             f"({rec['resume_param_relerr_max']})")
    del back, pb, state
    # the trained tree through the kernels, BN folded into the convs
    rec["serve_bf16"] = _forward(
        "resnet34", FlowConfig(mode="folded"), {"wgmma": 35, "small_ci": 1},
        1, {"small_m": 1}, smi, measure=False,
        params=tree_map(lambda t: t.to(torch.bfloat16), pa))
    rec["serve_fp32"] = _forward(
        "resnet34", FlowConfig(mode="folded", precision="fp32"),
        {"ffma": 35, "small_ci": 1}, 1, {"ffma_small_m": 1}, smi,
        measure=False, params=pa)
    m = cm.measure("train", iters=5, seed=SEED, params=pa)
    st = [opt.init(pa)]

    def one():
        _, st[0], _ = step(pa, st[0], batch)
    rec["profile"] = _profile(one, 3)
    rec.update({"ms_per_step": m["measured_step_s"] * 1e3,
                "mean_ms_per_step": m["mean_step_s"] * 1e3,
                "images_per_s": m["images_per_s"],
                "peak_bytes": m["peak_bytes"], "device": m["device"],
                "nvidia_smi": smi, "n_params": sum(
                    t.numel() for t in tree_leaves(pa))})
    log(json.dumps({"train_resnet34": {k: v for k, v in rec.items()
                                       if not k.startswith("serve")}}))
    return rec


def phase_train(smi):
    """Phase 14: training on the card (the forward products on the hand
    kernels, the backward through the reference ops), then the trained
    weights through the kernels."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW
    out = {}
    cm = tflow.compile(LM_ARCH, ShapeConfig("train", "train", TRAIN_S, B),
                       FlowConfig(mode="folded"))
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("attention", "matmul", "glu_matmul")):
        raise AssertionError(f"{LM_ARCH} train plan.kernels {ks}")
    t0 = time.perf_counter()
    params = cm.init_params(SEED)                     # fp32 masters
    torch.cuda.synchronize()
    raw = SyntheticLM(DataConfig(vocab_size=cm.cfg.vocab_size,
                                 seq_len=TRAIN_S, global_batch=B)).get(0)
    batch = _device_batch(raw)
    rec = {"arch": LM_ARCH, "shape": [B, TRAIN_S],
           "init_params_s": time.perf_counter() - t0,
           "remat": cm.flow.remat, "nvidia_smi": smi,
           "kernels_line": cm.describe().splitlines()[-1].strip()}
    opt = AdamW(lr=3e-4, warmup_steps=3, total_steps=TRAIN_STEPS)
    losses, ms, state, kern, peak = _train_run(
        cm, opt, params, batch, TRAIN_STEPS, f"{LM_ARCH} train",
        ("matmul_fused", "flash_attention"))
    if losses[-1] > losses[0] - 1.0:
        raise AssertionError(f"{LM_ARCH}: losses {losses} fell less than "
                             "1.0 nat")
    # each step runs every layer's forward twice (the block remat's
    # recompute), every projection on wgmma and every flash call on it
    fwd = _plan_launches(cm.plan, "prefill")
    want = {"matmul_fused": {"wgmma": 2 * TRAIN_STEPS * fwd["matmul_fused"]},
            "flash_attention": {
                "wgmma": 2 * TRAIN_STEPS * fwd["flash_attention"]}}
    if kern["schedules"] != want:
        raise AssertionError(f"{LM_ARCH} train: launches by schedule "
                             f"{kern['schedules']}, want {want}")
    rec.update({"losses": losses, "host_ms_per_step": ms,
                "kernels": kern, "peak_bytes_train": peak})
    log(f"llama train: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{TRAIN_STEPS} steps, {min(ms):.1f} ms a step (host), peak "
        f"{peak / 1e9:.2f} GB")
    del state
    torch.cuda.empty_cache()
    rec["serve"] = _serve_trained_lm(params, batch["tokens"], smi)
    m = cm.measure("train", iters=5, seed=SEED, params=params)
    rec["measure"] = {"ms_per_step": m["measured_step_s"] * 1e3,
                      "mean_ms_per_step": m["mean_step_s"] * 1e3,
                      "tokens_per_s": m["tokens_per_s"],
                      "peak_bytes": m["peak_bytes"], "device": m["device"]}
    step = cm.train_step(opt)
    st = [opt.init(params)]

    def one():
        _, st[0], _ = step(params, st[0], batch)
    rec["measure"]["profile"] = _profile(one, 2)
    log(json.dumps({"train_llama_measure": rec["measure"]}))
    del st, params, batch
    torch.cuda.empty_cache()
    out["llama"] = rec
    out["card_vs_cpu"] = _card_vs_cpu(smi)
    log(json.dumps({"train_card_vs_cpu": out["card_vs_cpu"]}))
    torch.cuda.empty_cache()
    out["resnet34"] = _train_resnet(smi)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the static verifier and the tuning stack
# ---------------------------------------------------------------------------

# a fresh tune database under build/ (deleted before the phase), the serving
# profile of llama3.2-1b's autotune, the timed runs of each measured
# candidate, bench and replay (after a warm-up; a candidate's time is the
# least of its runs, a bench's or a replay's the median) and the envelope
# of the speculation replay (at 1024 tokens each of its 16 requests would
# generate 752 tokens: 3 x 4 replays of over 10 s)
TUNE_DB = os.path.join(ROOT, "build", "tune_smoke.jsonl")
TUNE_PROFILE = dict(name="chip", batch_buckets=(4, SERVE_SLOTS),
                    max_seq_len=SERVE_SEQ, block_sizes=(16, 32))
TUNE_ITERS = 3
TUNE_SPEC_SEQ = 128
# the ops a card plan must resolve to the hand kernels, by family
CARD_OPS = {"cnn": ("conv2d", "matmul"),
            "lm": ("attention", "decode_attention", "paged_decode_attention",
                   "copy_block", "matmul", "glu_matmul")}


def _verify_card_plans():
    """``verify_plan`` on the card's plan of every ported config at its
    default shape (``flow.compile(verify=True)``: no weight is made): its
    codes, and each hand kernel's largest working set, the shared bytes a
    block of it asks for at the plan's calls: every call's mirror
    (``kernels/workingset.py``) held to the kernel library's own query."""
    from repro_torch import flow as tflow
    from repro_torch.configs import ARCHS, CNNS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels._build import LIBRARY
    from repro_torch.kernels.registry import REGISTRY
    from repro_torch.serving import EngineConfig
    lib = LIBRARY.get()
    serve_ecfg = EngineConfig(max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                              block_size=SERVE_BS, chunk_size=16,
                              chunked_prefill=True)
    out = {}
    for name in ARCHS + CNNS:
        fam = "cnn" if get_config(name).family == "cnn" else "lm"
        shape = ShapeConfig("serve", "prefill", 64, B) if fam == "cnn" \
            else ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
        cm = tflow.compile(name, shape, verify=True)
        res = cm.plan.verification
        if not res.ok or res.diagnostics:
            raise AssertionError(f"{name}: {res.describe()}")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in CARD_OPS[fam]):
            raise AssertionError(f"{name}: card plan.kernels {ks}")
        ws, n_held = {}, 0
        for op in sorted(o for o, b in ks.items() if b == "cuda"):
            contract = REGISTRY.get(op, "cuda").contract
            if contract is None or not contract.workingset:
                continue
            calls = contract.workingset(cm.plan, None)
            # the mirror against the bytes the launches ask for: the
            # library's own queries at the same calls (and the paged
            # kernel at the serving envelope's widest tick)
            for ecfg in [None] + ([serve_ecfg] if fam == "lm" else []):
                mirror = contract.workingset(cm.plan, ecfg)
                real = contract.workingset(cm.plan, ecfg, lib=lib)
                if mirror != real:
                    raise AssertionError(f"{name} {op}: working sets "
                                         f"{mirror} != the library's {real}")
                n_held += len(real)
            if calls:
                call, sched, nb = max(calls, key=lambda c: c[2])
                ws[op] = {"call": call, "schedule": sched, "bytes": nb}
        out[name] = {"summary": res.summary_line(),
                     "codes": list(res.codes()), "workingset": ws,
                     "calls_held_to_library": n_held}
        log(json.dumps({"verify": name, **out[name]}))
    return out


def _warm_survivors(cfg, shape, flow0):
    """Build and run, once and untimed, each survivor a measured search of
    ``shape`` will time (the estimator's top-k on the card), so that no
    candidate is timed on a colder card or host than another: one timed
    call after a candidate's own warm-up left the first measured survivor
    the slowest.  Banks nothing and ticks no count the phase reads."""
    from repro_torch.core import dse
    flow = dataclasses.replace(flow0, tuning=dataclasses.replace(
        flow0.tuning, tune_db=None))
    er = dse.explore(cfg, shape, flow, use_cache=False)
    warm = dse.measure_validator(cfg, shape, iters=1)
    for c in er.candidates[:max(flow.tuning.top_k, 1)]:
        warm(c.flow)
    torch.cuda.synchronize()


def _survivors(er):
    """Each measured survivor of a search: its knobs, measured ms, the
    estimator's h100 prediction and their ratio, its peak bytes."""
    est = {c.knob_str(): c.step_s for c in er.candidates}
    rows = []
    for v in er.validated:
        if "measured_step_s" not in v:
            continue
        e = est[v["knobs"]]
        rows.append({"knobs": v["knobs"], "ms": v["measured_step_s"] * 1e3,
                     "est_h100_ms": e * 1e3,
                     "measured_over_est": v["measured_step_s"] / e,
                     "peak_bytes": v["per_device_bytes"],
                     "bytes_source": v["bytes_source"]})
    return rows


def _tune_resnet(smi):
    """ResNet-34 (224 px, batch 8) through ``flow.compile(autotune=True,
    validate="measure", verify=True)`` with a fresh tune database: the
    measured survivors beside the estimator's predictions, the winner (or,
    when the reference backend wins, the fastest measured survivor on the
    hand kernels) through conv2d_fused against the reference backend at its
    own flow, and a second search served by the database."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig, TuningConfig
    from repro_torch.core import dse
    serve = ShapeConfig("serve", "prefill", 64, B)
    flow0 = FlowConfig(mode="folded", tuning=TuningConfig(tune_db=TUNE_DB))
    t0 = time.perf_counter()
    _warm_survivors(get_config("resnet34"), serve, flow0)
    warm_s = time.perf_counter() - t0
    dse.clear_explore_cache()
    reset_counts()
    t0 = time.perf_counter()
    cm = tflow.compile("resnet34", serve, flow0, autotune=True,
                       validate="measure", verify=True)
    search_s = time.perf_counter() - t0
    during = {"launches": read_counts(),
              "conv_schedules": read_schedules("conv2d_fused")}
    er = cm.explore_result
    if er.tunedb_status != "cold" or er.n_measured < 1 or \
            not cm.plan.verification.ok:
        raise AssertionError(f"resnet34 search: {er.describe()}")
    if during["conv_schedules"]["simt"]:
        raise AssertionError(f"resnet34 search: conv schedules "
                             f"{during['conv_schedules']}")
    rows = _survivors(er)
    for r in rows:
        log(json.dumps({"tune_resnet34_survivor": r}))
    flows = {c.knob_str(): c.flow for c in er.candidates}
    auto = sorted((r for r in rows
                   if flows[r["knobs"]].kernel_backend == "auto"),
                  key=lambda r: r["ms"])
    if not auto:
        raise AssertionError("resnet34: no measured survivor ran the hand "
                             "kernels")
    kflow = cm.flow if cm.flow.kernel_backend == "auto" \
        else flows[auto[0]["knobs"]]
    bf = kflow.precision == "bf16"
    fwd = _forward("resnet34", kflow,
                   {"wgmma" if bf else "ffma": 35, "small_ci": 1}, 1,
                   {"small_m" if bf else "ffma_small_m": 1}, smi,
                   measure=False)
    dse.clear_explore_cache()
    cm2 = tflow.compile("resnet34", serve, flow0, autotune=True,
                        validate="measure", verify=True)
    er2 = cm2.explore_result
    if er2.tunedb_status != "hit" or er2.n_measured != 0 or \
            cm2.flow != cm.flow:
        raise AssertionError(f"resnet34 second search: {er2.describe()}")
    # validate="compile": the first fitting survivor in the estimator's
    # order, its footprint a measured step's peak of allocated memory
    erc = dse.explore(get_config("resnet34"), serve, FlowConfig(
        mode="folded"), validator=dse.compile_validator(
            get_config("resnet34"), serve), use_cache=False)
    vc = erc.validated
    if len(vc) != 1 or vc[0]["bytes_source"] != "max_memory_allocated" \
            or erc.best is not erc.candidates[0]:
        raise AssertionError(f"resnet34 compile search: {erc.describe()}")
    rec = {"warm_s": warm_s, "search_s": search_s,
           "describe": er.describe(), "winner": er.best.knob_str(),
           "winner_backend": cm.flow.kernel_backend,
           "checked_flow": {k: v for k, v in
                            dataclasses.asdict(kflow).items()
                            if k != "tuning"},
           "survivors": rows, "during_search": during, "forward": fwd,
           "second": {"tunedb_status": er2.tunedb_status,
                      "n_measured": er2.n_measured},
           "compile_search": {"winner": erc.best.knob_str(),
                              "peak_bytes": vc[0]["per_device_bytes"]},
           "nvidia_smi": smi}
    log(json.dumps({"tune_resnet34": {k: v for k, v in rec.items()
                                      if k != "describe"}}))
    return rec


def _pinned_serve(at, cm, params, prec, works, smi):
    """Workload A through an engine pinned to ``at``'s configuration on
    ``cm`` (a flow on the hand kernels): the launches by schedule its
    prefill batches and ticks give, then the same engine on the reference
    backend: bf16 logits within the limit, fp32 tokens identical."""
    from repro_torch import flow as tflow
    from repro_torch.serving import Engine
    if any(cm.plan.kernels[o] != "cuda" for o in CARD_OPS["lm"]):
        raise AssertionError(f"pinned {prec}: plan.kernels {cm.plan.kernels}")
    ecfg = at.engine_config()
    reset_counts()
    eng = Engine(cm, params, ecfg)
    rep = eng.run(works["A"])
    torch.cuda.synchronize()
    rec = {"precision": prec, **_serve_record(eng, rep)}
    want = _serve_want(rep, _plan_launches(cm.plan, "prefill"),
                       _plan_launches(cm.plan, "decode"),
                       rep.metrics["cow_forks"])
    rec["launches"] = _counted(read_counts(), want, f"pinned {prec}")
    rec["matmul_schedules"] = _aligned_only(
        rec["launches"]["matmul_fused"], prec, f"pinned {prec}")
    rec["flash_schedules"] = _flash_scheduled(
        rec["launches"]["flash_attention"], prec, f"pinned {prec}")
    rec["paged_schedules"] = _decode_scheduled(
        rec["launches"]["paged_decode_attention"], prec, f"pinned {prec}",
        "paged_decode_attention")
    ref = tflow.compile(cm.cfg, cm.shape, cm.flow, backend="reference")
    if prec == "bf16":
        cap = Engine(cm, params, at.engine_config(capture_logits=True))
        cap_r = Engine(ref, params, at.engine_config(capture_logits=True))
        rec["logits"] = _serve_logits(cap.run(works["A"]),
                                      cap_r.run(works["A"]), prec,
                                      "pinned engine")
    else:
        rep_r = Engine(ref, params, ecfg).run(works["A"])
        if _tokens(rep) != _tokens(rep_r):
            raise AssertionError("pinned fp32 engine: greedy tokens differ "
                                 "from the reference backend's")
        rec["tokens_identical_to_reference"] = True
    # the same model on the engine's defaults (phase 8's configuration),
    # after the counted run: what the pinned knobs win or lose on A
    rec["defaults_tokens_per_s"] = _engine_run(
        cm, params, works["A"])[1].metrics["tokens_per_s"]
    log(json.dumps({"tune_llama_serve": rec}))
    return rec


def _tune_llama(smi):
    """llama3.2-1b at full width through ``autotune_decode`` (buckets 4 and
    8, 1024 tokens, blocks of 16 or 32, measured) with the same database:
    all six benches on the card, the block and chunk benches counted on
    ``paged_decode_attention``'s ``mma`` schedule, then the pinned engine on
    workload A in bf16 and, with the winner's flow in fp32, against the
    reference backend."""
    from repro_torch import flow as tflow
    from repro_torch.core import dse
    from repro_torch.serving import autotune as sat
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig
    prof = sat.ServingProfile(**TUNE_PROFILE)
    t0 = time.perf_counter()
    for b in prof.batch_buckets:
        _warm_survivors(get_config(LM_ARCH), prof.shape_for(b),
                        FlowConfig(mode="folded"))
    torch.cuda.empty_cache()
    warm_s = time.perf_counter() - t0
    dse.clear_explore_cache()
    reset_counts()
    t0 = time.perf_counter()
    at = sat.autotune_decode(LM_ARCH, profile=prof, validate="measure",
                             iters=TUNE_ITERS, db=TUNE_DB, tune_spec=False)
    # the speculation replay on the same pinned flow and weights with an
    # envelope of TUNE_SPEC_SEQ tokens (the replay's length is the
    # profile's)
    spec_at = dataclasses.replace(
        at, profile=dataclasses.replace(prof, max_seq_len=TUNE_SPEC_SEQ),
        _params=at._params)
    at.speculation, at.spec_times_s = sat.tune_speculation(
        spec_at, iters=TUNE_ITERS, db=TUNE_DB)
    search_s = time.perf_counter() - t0
    during = {"launches": read_counts(),
              "paged_schedules": read_schedules("paged_decode_attention")}
    log(at.describe())
    if during["paged_schedules"]["simt"] or \
            not during["paged_schedules"]["mma"]:
        raise AssertionError(f"autotune: paged schedules "
                             f"{during['paged_schedules']}")
    ran = {"block": at.block_times_us, "chunk": at.chunk_times_us,
           "fori": at.fori_times_s, "prefix": at.prefix_times_s,
           "spec": at.spec_times_s}
    if not all(ran.values()) or at.tile_overrides or at.tile_times_s:
        raise AssertionError(f"autotune benches {ran}, tiles "
                             f"{at.tile_overrides} {at.tile_times_s}")
    from repro_torch import tunedb
    fields = sorted(r.key["field"] for r in
                    tunedb.open_db(TUNE_DB).records("serving"))
    want = ["block_size", "chunk_size", "fori_seg", "kernel_tiles",
            "prefix_cache", "speculation"]
    if at.chunk_replay_s:             # the microbench's chunk, replayed
        want.append("chunk_replay")
    if fields != sorted(want):
        raise AssertionError(f"autotune banked {fields}")
    # the block and chunk benches alone, no store, counted: one warm-up and
    # TUNE_ITERS timed calls a candidate, all on mma
    bench = {}
    for name, fn, n in (
            ("block", lambda: sat.tune_block_size(
                at.cfg, prof, iters=TUNE_ITERS, dtype=torch.bfloat16),
             len(prof.block_sizes)),
            ("chunk", lambda: sat.tune_chunk_size(
                at.cfg, prof, block_size=at.block_size, iters=TUNE_ITERS,
                dtype=torch.bfloat16), len(prof.chunk_sizes))):
        reset_counts()
        fn()
        bench[name] = _decode_scheduled(n * (TUNE_ITERS + 1), "bf16",
                                        f"{name} bench",
                                        "paged_decode_attention")
    survivors = {b: _survivors(er) for b, er in at.per_bucket.items()}
    for b, rows in survivors.items():
        for r in rows:
            log(json.dumps({"tune_llama_survivor": {"bucket": b, **r}}))
    # the pinned engine in the winner's precision on its own weights, and
    # the winner's flow in the other precision on weights drawn for it; on
    # the hand kernels (the winner's flow with the auto backend) when the
    # reference backend won: its engine is the reference itself
    works = _serve_workloads(at.cfg.vocab_size)
    serve = {}
    kflow = dataclasses.replace(at.flow_for(), kernel_backend="auto")
    for prec in ("bf16", "fp32"):
        if kflow == at.flow_for() and prec == kflow.precision:
            cm, params = at.compile(), at.init_params(SEED)
        else:
            cm = tflow.compile(at.cfg, prof.shape_for(SERVE_SLOTS),
                               dataclasses.replace(kflow, precision=prec))
            params = cm.init_params(SEED)
        serve[prec] = _pinned_serve(at, cm, params, prec, works, smi)
        del cm, params
        at._params.clear()
        torch.cuda.empty_cache()
    rec = {"warm_s": warm_s, "search_s": search_s,
           "describe": at.describe(),
           "winner_backend": at.flow_for().kernel_backend,
           "pin": {"bucket": at.best_bucket,
                   "knobs": at.per_bucket[at.best_bucket].best.knob_str(),
                   "block_size": at.block_size, "chunk_size": at.chunk_size,
                   "fori_seg": at.fori_seg, "prefix_cache": at.prefix_cache,
                   "speculation": at.speculation},
           "times": {"block_us": at.block_times_us,
                     "chunk_us_per_token": at.chunk_times_us,
                     "chunk_replay_s": at.chunk_replay_s,
                     "fori_replay_s": at.fori_times_s,
                     "prefix_replay_s": at.prefix_times_s,
                     "spec_replay_s": at.spec_times_s},
           "tunedb": at.tunedb_statuses, "n_measured": at.n_measured,
           "survivors": survivors, "during_autotune": during,
           "benches_counted": bench, "serve": serve, "nvidia_smi": smi}
    log(json.dumps({"tune_llama": {k: v for k, v in rec.items()
                                   if k not in ("describe", "serve")}}))
    return rec


def phase_tune(smi):
    """Phase 15: the static verifier over every card plan, then ResNet-34's
    and llama3.2-1b's autotune through the hand kernels, and the tune
    database they banked shown by ``launch.tune``."""
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    if os.path.exists(TUNE_DB):
        os.remove(TUNE_DB)
    DISPATCH_REJECTIONS.clear()
    out = {"verify": _verify_card_plans(), "resnet34": _tune_resnet(smi)}
    torch.cuda.empty_cache()
    out["llama"] = _tune_llama(smi)
    if DISPATCH_REJECTIONS:
        raise AssertionError(f"phase 15: dispatch rejections "
                             f"{dict(DISPATCH_REJECTIONS)}")
    show = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "show", "--db",
         TUNE_DB], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    key = f"dev=cuda:{torch.cuda.get_device_name(0)}"
    lines = show.stdout.splitlines()
    if show.returncode != 0 or len(lines) < 2 or \
            not all(key in x for x in lines[1:]):
        raise AssertionError(f"launch.tune show: {show.stdout}"
                             f"{show.stderr}")
    out["tunedb_show"] = lines
    log(show.stdout.rstrip())
    return out


SPLIT = ("matmul_fused", "flash_attention", "conv2d_fused", "decode_attention",
         "paged_decode_attention", "lru_scan")


def _by_schedule(cases):
    """``cases`` with the kernels of ``SPLIT`` split into one list per
    schedule, ``matmul_fused[wgmma]`` and so on: each schedule is its own
    kernel."""
    out = {k: v for k, v in cases.items() if k not in SPLIT}
    for kname in SPLIT:
        for r in cases.get(kname, []):
            out.setdefault(f"{kname}[{r['schedule']}]", []).append(r)
    return out


def _sched_launches(counts, schedules, flash=None, conv=None, decode=None,
                    paged=None):
    """A path's launch counts with matmul_fused's split by schedule
    (``schedules``), flash_attention's (``flash``), conv2d_fused's
    (``conv``), decode_attention's (``decode``) and
    paged_decode_attention's (``paged``)."""
    out = dict(counts)
    for kname, by in (("matmul_fused", schedules), ("flash_attention", flash),
                      ("conv2d_fused", conv), ("decode_attention", decode),
                      ("paged_decode_attention", paged)):
        if by is not None:
            del out[kname]
            out.update({f"{kname}[{s}]": n for s, n in by.items()})
    return out


def rec_kernel_entries(cases, rg):
    """Each kernel at recurrentgemma-2b's shapes, summed over one generate
    (a prefill of 8 x 512 tokens, then 31 decode steps: flash and
    matmul_fused's 4096-row cases at the prefill, decode_attention over the
    1024-slot cache and the 8-row matmuls at each step);
    paged_decode_attention one call at workload R's shape.  ``launches``
    counts the recurrent path's runs of that dtype (generate, window run,
    workload R).  lru_scan has its own entries (:func:`lru_kernel_entries`)."""
    uses = {"flash_attention": RG_ATTN,
            "decode_attention": RG_ATTN * (RG_STEPS - 1),
            "paged_decode_attention": 1}
    cases = _by_schedule(cases)
    launches = {}
    for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
        runs = [rg[f"{run}_{prec}"] for run in ("generate", "window",
                                                 "serve")]
        counts = [_sched_launches(r["launches"], r["matmul_schedules"],
                                  r["flash_schedules"],
                                  decode=r.get("decode_schedules"),
                                  paged=r.get("paged_schedules"))
                  for r in runs]
        launches[dt] = {k: sum(c.get(k, 0) for c in counts) for k in cases}

    def use(k, r):
        if k.startswith("matmul_fused"):
            return r["uses_per_forward"] * (1 if r["rows"] == B * RG_S
                                            else RG_STEPS - 1)
        return uses[k.split("[")[0]] if r.get("rows", B) == B else 0

    def per(kname, used):
        if kname.startswith("matmul_fused"):
            return (f"one {RG_ARCH} generate: {len(used)} projection shapes "
                    f"x their uses, prefill of {B}x{RG_S} tokens then "
                    f"{RG_STEPS - 1} decode steps")
        (r, u), = used
        return (f"one call at {r['shape']}" if u == 1 else
                f"{u} calls at {r['shape']} (one {RG_ARCH} generate)")
    return summed_entries(cases, launches, f"@{RG_ARCH}", per, use)


def lru_kernel_entries(cases):
    """lru_scan, one entry a schedule, shape and dtype: one call.
    ``launches`` is the count at that shape over the recurrent path's runs
    in both precisions (generate, window run, workload R: every path launch
    is fp32); the sequential kernel (``lru_scan[seq]``) and the bf16 case
    have none."""
    out = []
    for r in _by_schedule(cases).get("lru_scan[chunked]", []):
        for kname in ("lru_scan[chunked]", "lru_scan[seq]"):
            rows = [r if kname.endswith("[chunked]") else _seq_twin(r)]
            out += summed_entries(
                {kname: rows},
                {r["dtype"]: {kname: r["path_launches"]
                              if kname.endswith("[chunked]") else 0}},
                f"@{RG_ARCH}:{r['shape']}",
                lambda k, used: f"one call at {used[0][0]['shape']}",
                lambda k, c: 1)
    return out


def mobilenet_kernel_entries(cases, path):
    """conv2d_fused at MobileNetV1's first conv (small_ci, bf16 and fp32)
    and its 32-channel pointwise conv (mid_ci, bf16), one call each, and
    the SIMT kernel at the pointwise conv (the schedule it ran on before
    mid_ci; no path launches it); the launches are the MobileNetV1
    forward's (bf16) by schedule."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "mobilenetv1":
            launches["bfloat16"].update(
                {f"conv2d_fused[{k}]": v
                 for k, v in r["conv_schedules"].items()})
    rows = [r for r in cases["conv2d_fused"] if r.get("arch") == "mobilenetv1"]
    rows += [_simt_twin(r) for r in rows if r["schedule"] == "mid_ci"]
    return summed_entries(
        _by_schedule({"conv2d_fused": rows}), launches, "@mobilenetv1",
        lambda k, used: f"one call at {used[0][0]['shape']} (batch 8)",
        lambda k, r: 1)


def lenet_kernel_entries(cases, path):
    """conv2d_fused at LeNet-5's two convs (small_ci) and matmul_fused at
    its two FC layers on simt (120 -> 84, 84 -> 10), bf16, summed over one
    LeNet-5 forward at batch 8; the launches are that forward's by
    schedule."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "lenet5":
            launches["bfloat16"].update(_sched_launches(
                r["launches"], r["matmul_schedules"],
                conv=r["conv_schedules"]))
    return summed_entries(
        _by_schedule({k: [r for r in v if r.get("arch") == "lenet5"]
                      for k, v in cases.items()}), launches, "@lenet5",
        lambda k, used: "one LeNet-5 forward at batch 8 ("
                        + ", ".join(r["shape"] for r, _ in used) + ")",
        lambda k, r: 1)


def serving_kernel_entries(cases, serve):
    """Each serving kernel: one call at the serving shape (paged: a decode
    tick, Sq = 1, split by schedule), the launches of the serving main path
    (workloads A-D)."""
    return summed_entries(
        _by_schedule(cases),
        {"bfloat16": _sched_launches(serve["launches"], None,
                                     paged=serve["paged_schedules"]),
         "float32": _sched_launches(serve["launches_fp32"], None,
                                    paged=serve["paged_schedules_fp32"])},
        "@serving", lambda k, used: f"one call at {used[0][0]['shape']}",
        lambda k, r: int(r.get("sq", 1) == 1))


def kernel_entries(cases, path):
    """Each CNN kernel, summed over its launches in one ResNet-34 forward
    (each shape times its uses)."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "resnet34":
            d = launches["bfloat16" if r["flow"] == "bf16" else "float32"]
            for k, n in _sched_launches(
                    r["launches"], r["matmul_schedules"],
                    conv=r["conv_schedules"]).items():
                d[k] = d.get(k, 0) + n
    return summed_entries(
        _by_schedule({k: [r for r in v if r.get("arch") is None]
                      for k, v in cases.items()}), launches, "",
        lambda k, used: "one ResNet-34 forward at batch 8, 224 px",
        lambda k, r: r["uses"])


def lm_kernel_entries(cases, lm):
    """Each LM kernel, summed over one ``generate`` of 32 tokens (a prefill
    of 8 x 512 tokens, then 31 decode steps), each case's time times its
    uses there (the 128- and 40-row matmul cases are on no such path)."""
    steps = LM_STEPS - 1

    def uses(kname, r):
        if kname.startswith("flash_attention"):
            return LM_LAYERS
        if kname.startswith("decode_attention"):
            return LM_LAYERS * steps
        return LM_LAYERS * {B * LM_S: 1, B: steps}.get(r["rows"], 0)
    return summed_entries(
        _by_schedule(cases),
        {"bfloat16": _sched_launches(lm["launches"], lm["matmul_schedules"],
                                     lm["flash_schedules"],
                                     decode=lm["decode_schedules"]),
         "float32": _sched_launches(lm["launches_fp32"],
                                    lm["matmul_schedules_fp32"],
                                    lm["flash_schedules_fp32"],
                                    decode=lm["decode_schedules_fp32"])},
        f"@{LM_ARCH}",
        lambda k, used: f"one {LM_ARCH} generate: prefill of {B}x{LM_S} "
                        f"tokens, then {steps} decode steps", uses)


def base_kernel_entries(cases, lm):
    """The base variant, one entry per schedule, shape and dtype: one call;
    the SIMT base kernel at each shape beside it
    (``matmul_fused_base[simt]``).  Its launches on the main path (the LM
    generate runs) are 0: no op-layer caller passes ``vmem_accum=False``."""
    split = {}
    for r in cases["matmul_fused_base"]:
        split.setdefault(f"matmul_fused_base[{r['schedule']}]", []).append(r)
        split.setdefault("matmul_fused_base[simt]", []).append(_simt_twin(r))
    out = []
    for rows, tag in ((B, "@resnet34_fc"), (B * LM_S, "@4096x2048x2048")):
        out += summed_entries(
            split,
            {"bfloat16": lm["launches"], "float32": lm["launches_fp32"]},
            tag, lambda k, used: f"one call at {used[0][0]['shape']}",
            lambda k, r, rows=rows: int(r["rows"] == rows))
    return out


def dense_kernel_entries(cases, dense):
    """Each kernel at each of qwen1.5-4b's, phi4-mini-3.8b's and
    stablelm-1.6b's shapes, summed over one generate (flash and the
    4096-row matmuls at the prefill, decode_attention and the 8-row
    matmuls at each of 31 decode steps); paged_decode_attention one call
    at a workload-A tick.  ``launches`` counts the model's runs of that
    dtype (generate and workload A)."""
    steps = LM_STEPS - 1
    out = []
    for arch in DENSE_ARCHS:
        rec = dense[arch]
        layers = rec["layers"]
        launches = {}
        for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
            g, s_ = rec[f"generate_{prec}"], rec[f"serve_{prec}"]
            counts = [_sched_launches(g["launches"], g["matmul_schedules"],
                                      g["flash_schedules"],
                                      decode=g["decode_schedules"]),
                      _sched_launches(s_["launches"], s_["matmul_schedules"],
                                      s_["flash_schedules"],
                                      paged=s_["paged_schedules"])]
            launches[dt] = {}
            for c in counts:
                for k, n in c.items():
                    launches[dt][k] = launches[dt].get(k, 0) + n

        def use(k, r):
            if k.startswith("matmul_fused"):
                return r["uses_per_forward"] * (1 if r["rows"] == B * LM_S
                                                else steps)
            return {"flash_attention": layers,
                    "decode_attention": layers * steps,
                    "paged_decode_attention": 1}[k.split("[")[0]]

        def per(kname, used):
            if kname.startswith("paged"):
                return f"one call at {used[0][0]['shape']}"
            return (f"one {arch} generate: prefill of {B}x{LM_S} tokens, "
                    f"then {steps} decode steps")
        out += summed_entries(
            _by_schedule({k: [r for r in v if r.get("arch") == arch]
                          for k, v in cases.items()}),
            launches, f"@{arch}", per, use)
    return out


KERNEL_SOURCES = {   # kernel: (its source, the TPU kernel it replaces)
    "conv2d_fused[wgmma]": ("src/repro_torch/csrc/conv2d_wgmma.cu",
                            "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[ffma]": ("src/repro_torch/csrc/conv2d_fused.cu",
                           "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[small_ci]": ("src/repro_torch/csrc/conv2d_small_ci.cu",
                               "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[mid_ci]": ("src/repro_torch/csrc/conv2d_mid_ci.cu",
                             "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[simt]": ("src/repro_torch/csrc/conv2d_fused.cu",
                           "src/repro/kernels/conv2d.py:64"),
    "matmul_fused[wgmma]": ("src/repro_torch/csrc/matmul_wgmma.cu",
                            "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                              "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[ffma]": ("src/repro_torch/csrc/matmul_fused.cu",
                           "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[ffma_small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                                   "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[simt]": ("src/repro_torch/csrc/matmul_fused.cu",
                           "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused_base[wgmma]": ("src/repro_torch/csrc/matmul_wgmma.cu",
                                 "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                                   "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[ffma]": ("src/repro_torch/csrc/matmul_fused.cu",
                                "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[ffma_small_m]": (
        "src/repro_torch/csrc/matmul_small_m.cu",
        "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[simt]": ("src/repro_torch/csrc/matmul_fused.cu",
                                "src/repro/kernels/matmul_fused.py:147"),
    "flash_attention[wgmma]": (
        "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/attention.py:93"),
    "flash_attention[ffma]": ("src/repro_torch/csrc/flash_attention_ffma.cu",
                              "src/repro/kernels/attention.py:93"),
    "flash_attention[simt]": ("src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/attention.py:93"),
    "decode_attention[mma]": ("src/repro_torch/csrc/decode_core.cuh",
                              "src/repro/kernels/decode_attention.py:61"),
    "decode_attention[ffma]": ("src/repro_torch/csrc/decode_core.cuh",
                               "src/repro/kernels/decode_attention.py:61"),
    "decode_attention[simt]": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:61"),
    "paged_decode_attention[mma]": (
        "src/repro_torch/csrc/decode_core.cuh",
        "src/repro/kernels/decode_attention.py:189"),
    "paged_decode_attention[ffma]": (
        "src/repro_torch/csrc/decode_core.cuh",
        "src/repro/kernels/decode_attention.py:189"),
    "paged_decode_attention[simt]": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:189"),
    "copy_block": ("src/repro_torch/csrc/copy_block.cu",
                   "src/repro/kernels/decode_attention.py:158"),
    "lru_scan[chunked]": ("src/repro_torch/csrc/lru_scan.cu",
                          "src/repro/kernels/lru_scan.py:33"),
    "lru_scan[seq]": ("src/repro_torch/csrc/lru_scan.cu",
                      "src/repro/kernels/lru_scan.py:33"),
}


def summed_entries(cases, launches, tag, per, uses):
    """One ``kernels``-line entry per kernel and dtype.  Each case's times
    and bound count ``uses(kernel, case)`` times (0 leaves a case out) and
    are summed; ``per(kernel, [(case, uses), ...])`` names what the sum
    covers; ``launches`` is {dtype: {kernel: count}} from that dtype's
    main-path run.  A kernel with no case of a dtype, or none used, has no
    entry for it."""
    out = []
    for kname, rows in cases.items():
        for dt in ("bfloat16", "float32"):
            rs = [r for r in rows if r["dtype"] == dt]
            used = [(r, uses(kname, r)) for r in rs if uses(kname, r)]
            if not used:
                continue

            def tot(key):
                return sum(r[key] * u for r, u in used)
            by_ops = sum(r["bound_ms"] * u for r, u in used
                         if r["bound_by"] == "operations")
            lib = all(r["library_ms"] is not None for r, _ in used)
            out.append({
                "name": f"{kname}{tag}/{dt}", "route": "cuda",
                "source": KERNEL_SOURCES[kname][0],
                "replaces": KERNEL_SOURCES[kname][1],
                "launches": launches[dt].get(kname, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                             else "bytes"),
                "library_ms": tot("library_ms") if lib else None, "ok": True,
                "per": per(kname, used)})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    walls = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        walls[phase.__name__] = time.perf_counter() - t
        log(f"{phase.__name__}: {walls[phase.__name__]:.1f}s")
        return out
    name, smi = timed(phase_device)
    build = timed(phase_build)
    cases = timed(phase_kernels)
    lm_cases, rg_mm_cases = timed(phase_lm_kernels)
    base_cases = timed(phase_base_kernels)
    serve_cases = timed(phase_serving_kernels)
    path = timed(phase_path, smi)
    lm = timed(phase_lm_path, smi)
    serve = timed(phase_serving, smi)
    rec_cases = timed(phase_rec_kernels)
    rg = timed(phase_rec_path, smi)
    lru_cases = timed(phase_lru_kernels, rg)
    dense_cases = timed(phase_dense_kernels)
    dense = timed(phase_dense_path, smi)
    train = timed(phase_train, smi)
    tune = timed(phase_tune, smi)
    entries = kernel_entries(cases, path) + \
        mobilenet_kernel_entries(cases, path) + \
        lenet_kernel_entries(cases, path) + \
        lm_kernel_entries(lm_cases, lm) + \
        base_kernel_entries(base_cases, lm) + \
        serving_kernel_entries(serve_cases, serve) + \
        rec_kernel_entries({**rec_cases, "matmul_fused": rg_mm_cases}, rg) + \
        lru_kernel_entries(lru_cases) + \
        dense_kernel_entries(dense_cases, dense)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "build": build,
                   "kernels": cases, "lm_kernels": lm_cases,
                   "rec_matmul_kernels": rg_mm_cases,
                   "base_kernels": base_cases,
                   "serving_kernels": serve_cases, "path": path,
                   "lm_path": lm, "serving": serve,
                   "rec_kernels": rec_cases, "rec_path": rg,
                   "lru_kernels": lru_cases,
                   "dense_kernels": dense_cases, "dense_path": dense,
                   "train": train, "tune": tune,
                   "entries": entries, "phase_seconds": walls,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    log(f"total: {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
