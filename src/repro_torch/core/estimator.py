"""Analytic cost model — the flow's resource estimator (paper §IV-J).

On the FPGA, DSP usage was predicted by counting MACCs × unroll factors while
logic/BRAM needed place-and-route.  Here the analytic layer predicts params,
MODEL_FLOPS, per-op FLOPs/HBM-bytes and a roofline step time, while the
"place-and-route" ground truth is a measured step on the card
(:meth:`repro_torch.flow.CompiledModel.measure`: CUDA-event time and
``torch.cuda.max_memory_allocated``).

The port's copy of the JAX package's estimator: the v5e/v5p presets stay as
they are (the CPU tests hold the DSE's rankings to JAX's under them) and an
``h100`` preset joins them for the card.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict

from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig

# Device presets for the DSE's roofline / budget rules.  The budget itself
# (rule 3) comes from FlowConfig.tuning.hbm_bytes so non-v5e devices are a
# config change, not a code change.
DEVICE_PRESETS: Dict[str, Dict[str, float]] = {
    "v5e": {"hbm_bytes": 16 * 1024 ** 3, "hbm_bw": 819e9,
            "bf16_flops": 197e12, "ici_bw": 200e9},
    "v5p": {"hbm_bytes": 95 * 1024 ** 3, "hbm_bw": 2765e9,
            "bf16_flops": 459e12, "ici_bw": 600e9},
    # NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside
    # them (the hand kernels' fp32 schedules: no TF32), HBM3 bandwidth; the
    # bounds of chip_smoke.py use the same constants.  NVLink (450 GB/s a
    # direction) stands in for ICI and goes unused on one card.  hbm_bytes
    # is the nominal 80 GiB: h100_hbm_bytes() reads the card's own.  The
    # hand kernels pick their own tiles and ignore plan.tiles: plan_tiles 0
    # keeps tile_select out of the card's byte count.
    "h100": {"hbm_bytes": 80 * 1024 ** 3, "hbm_bw": 3.35e12,
             "bf16_flops": 989e12, "fp32_flops": 67e12, "ici_bw": 450e9,
             "plan_tiles": 0.0},
}


def h100_hbm_bytes(device=None) -> int:
    """The card's memory (``total_memory`` of its properties) when CUDA is
    available, else the preset's nominal 80 GiB."""
    import torch
    if torch.cuda.is_available():
        idx = 0 if device is None or getattr(device, "index", None) is None \
            else device.index
        return int(torch.cuda.get_device_properties(idx).total_memory)
    return int(DEVICE_PRESETS["h100"]["hbm_bytes"])


@lru_cache(maxsize=64)
def _graph_for(cfg: ModelConfig):
    from repro_torch.models import build_graph
    return build_graph(cfg)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the graph (padded vocab included).  With
    ``active_only`` routed-expert params are scaled by top_k / num_experts
    (MoE active-parameter count for MODEL_FLOPS)."""
    g = _graph_for(cfg)
    total = 0
    for b in g.blocks:
        for spec in b.param_specs():
            n = 1
            for d in spec.shape:
                n *= d
            if active_only and spec.name.startswith("we_"):
                n = n * cfg.moe.top_k // cfg.moe.num_experts
            total += n
    return total


def non_embedding_params(cfg: ModelConfig, active_only: bool = False) -> int:
    g = _graph_for(cfg)
    total = 0
    for b in g.blocks:
        if b.kind in ("embed", "dec_embed", "head"):
            continue
        for spec in b.param_specs():
            n = 1
            for d in spec.shape:
                n *= d
            if active_only and spec.name.startswith("we_"):
                n = n * cfg.moe.top_k // cfg.moe.num_experts
            total += n
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6·N·D (train), 2·N·D (prefill forward),
    2·N·B (decode, one token per sequence).  N = active params for MoE."""
    n = count_params(cfg, active_only=cfg.moe is not None)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Quadratic attention term (excluded from 6·N·D), for the estimator's
    FLOPs cross-check."""
    a = cfg.attention
    if a is None:
        return 0.0
    n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
    S = shape.seq_len
    w = a.window or S
    if shape.kind == "decode":
        per = 2 * 2 * a.n_heads * a.head_dim * min(S, w)
        return per * n_attn * shape.global_batch
    # sum over query positions of visible window
    kv_per_q = min(w, S) if not a.causal else min(w, S) / 2
    per_tok = 2 * 2 * a.n_heads * a.head_dim * kv_per_q
    mult = 3 if shape.kind == "train" else 1
    return per_tok * S * shape.global_batch * n_attn * mult


def hbm_bytes_kernel_path(cfg: ModelConfig, shape: ShapeConfig,
                          dtype_bytes: int = 2) -> float:
    """Analytic HBM traffic of the *kernel* path (fused epilogues, flash
    attention: no S² intermediate, VMEM accumulation): params read once +
    activations once per layer boundary + KV cache traffic."""
    n = count_params(cfg, active_only=cfg.moe is not None)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    act = tokens * cfg.d_model * dtype_bytes
    per_layer_acts = 4 * act                     # in/out of the two sub-blocks
    total = n * dtype_bytes + cfg.n_layers * per_layer_acts
    if shape.kind == "decode" and cfg.attention:
        C = min(shape.seq_len, cfg.attention.window or shape.seq_len)
        kv = (2 * C * cfg.attention.n_kv_heads * cfg.attention.head_dim *
              dtype_bytes * shape.global_batch)
        n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
        total += kv * n_attn
    if shape.kind == "train":
        total *= 3                               # fwd + bwd re-read/write
    return total


# ---------------------------------------------------------------------------
# DSE scoring: the paper's three factor rules, applied analytically
# ---------------------------------------------------------------------------

def _act_dtype_bytes(flow: FlowConfig) -> int:
    return 2 if flow.precision == "bf16" else 4


def mesh_parallel_sizes(flow: FlowConfig) -> Dict[str, int]:
    """(dp, tp, pp) sizes implied by ``flow.mesh_split`` under the flow's
    axis-role convention (size-1 tp/pp degenerate; every other axis is data
    parallelism).  All 1 without a mesh split."""
    if not flow.mesh_split:
        return {"dp": 1, "tp": 1, "pp": 1}
    from repro_torch.core.passes.sharding import split_roles
    sizes = dict(flow.mesh_split)
    dp_axes, tp_axis, pp_axis = split_roles(flow, flow.mesh_split)
    dp = 1
    for a in dp_axes:
        dp *= sizes.get(a, 1)
    return {"dp": dp,
            "tp": sizes.get(tp_axis, 1) if tp_axis else 1,
            "pp": sizes.get(pp_axis, 1) if pp_axis else 1}


def _effective_devices(cfg: ModelConfig, flow: FlowConfig,
                       devices: int) -> int:
    """Sharding denominator for a mesh split: only the axes the model can
    actually use count (a CNN leaves the tp axis idle — its params replicate
    over it, so dividing by the raw axis product would understate the
    footprint and overstate the compute parallelism)."""
    if not flow.mesh_split:
        return devices
    par = mesh_parallel_sizes(flow)
    tp = par["tp"] if cfg.family != "cnn" else 1
    return max(1, par["dp"] * tp * par["pp"])


def estimate_comm_bytes(cfg: ModelConfig, shape: ShapeConfig,
                        flow: FlowConfig) -> Dict[str, float]:
    """Per-device collective traffic per step, from the partition decisions
    the mesh split implies — the communication analogue of the MACC count.

    * **dp (FSDP/ZeRO-3)** — every microbatch re-all-gathers the sharded
      weights at use; training reduce-scatters fp32 gradients once per step.
    * **tp (Megatron)** — two activation all-reduce rounds per layer
      (attention out + FFN out), with the backward re-reductions in train.
    * **pp (GPipe)** — per-microbatch boundary activations ppermuted
      stage -> stage (fwd, plus bwd in train).
    """
    out = {"all_gather": 0.0, "reduce_scatter": 0.0, "all_reduce": 0.0,
           "p2p": 0.0, "total": 0.0}
    if not flow.mesh_split:
        return out                       # unmeshed: skip the graph walk
    par = mesh_parallel_sizes(flow)
    dp, tp, pp = par["dp"], par["tp"], par["pp"]
    adt = _act_dtype_bytes(flow)
    n = count_params(cfg, active_only=cfg.moe is not None)
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    train = shape.kind == "train"
    if dp > 1:
        gathers = max(flow.microbatches, 1) if train else 1
        out["all_gather"] = n * adt * (dp - 1) / dp * gathers
        if train:
            out["reduce_scatter"] = 4.0 * n * (dp - 1) / dp
    if tp > 1 and cfg.family != "cnn":     # CNNs leave the tp axis unused
        act = tokens / dp * cfg.d_model * adt      # per-device activations
        rounds = 2 * cfg.n_layers * (3 if train else 1)
        out["all_reduce"] = 2.0 * act * (tp - 1) / tp * rounds
    if pp > 1:
        act = tokens / dp * cfg.d_model * adt
        out["p2p"] = act * (pp - 1) / pp * (3 if train else 1)
    out["total"] = sum(out.values())
    return out

_REMAT_FACTOR = {"none": 10.0, "block": 2.0, "nested": 1.0}


def estimate_footprint(cfg: ModelConfig, shape: ShapeConfig, flow: FlowConfig,
                       devices: int = 1) -> Dict[str, float]:
    """Per-device HBM footprint prediction (rule 3 — the resource budget).

    The MACC-count-predicts-DSP analogue: an analytic byte count good enough
    to *prune* candidates; a measured step's peak of allocated memory on
    the card is the place-and-route ground truth for the survivors.
    Weights/optimizer are FSDP-sharded over ``devices``; activation
    transients shrink with microbatching, remat strength, and bf16 storage.
    """
    devices = _effective_devices(cfg, flow, devices)
    n = count_params(cfg)
    adt = _act_dtype_bytes(flow)
    if cfg.family == "cnn":
        # early conv activations dominate: B x H x W x C at full resolution
        act_units = shape.global_batch * cfg.image_size ** 2 * max(
            cfg.image_channels, 8)
        width = 1.0
    else:
        act_units = shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1) * cfg.d_model
        width = max(1.0, cfg.d_ff / max(cfg.d_model, 1) / 4)
    out: Dict[str, float] = {}
    if shape.kind == "train":
        # fp32 master params + grads + AdamW m,v — FSDP-sharded
        out["params"] = 4.0 * n / devices
        out["grads"] = 4.0 * n / devices
        out["optimizer"] = 8.0 * n / devices
        mb = max(flow.microbatches, 1)
        per_mb = act_units / devices / mb
        remat = _REMAT_FACTOR.get(flow.remat, 2.0)
        out["activations"] = per_mb * adt * cfg.n_layers * remat * width
        # chunked-CE logits block (fp32), rematerialized per chunk
        b_loc = max(shape.global_batch // devices // mb, 1)
        chunk = min(flow.ce_chunk, shape.seq_len)
        out["logits"] = 4.0 * b_loc * chunk * cfg.padded_vocab
    else:
        out["params"] = float(adt) * n / devices
        out["activations"] = act_units / devices * adt * 4
        b_loc = max(shape.global_batch // devices, 1)
        out["logits"] = 4.0 * b_loc * cfg.padded_vocab
        if shape.kind == "decode" and cfg.attention is not None:
            a = cfg.attention
            C = min(shape.seq_len, a.window or shape.seq_len)
            n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
            out["kv_cache"] = (2.0 * C * a.n_kv_heads * a.head_dim * adt *
                               b_loc * n_attn)
    out["total"] = sum(out.values())
    return out


def estimate_step_seconds(cfg: ModelConfig, shape: ShapeConfig,
                          flow: FlowConfig, devices: int = 1,
                          device: str = "v5e") -> Dict[str, float]:
    """Roofline step-time prediction (rules 1–2 — the bandwidth roof).

    Candidates are ranked by ``max(compute, memory, comm)`` time; passes that
    are off inflate the byte side the way their FPGA counterparts did (no
    cached writes -> read-modify-write per K step; no fusion -> intermediate
    arrays round-trip HBM; fp32 -> half MXU rate, double bytes).  A mesh
    split adds the ICI roof: the all-gather/reduce-scatter/all-reduce bytes
    its partition decisions imply (:func:`estimate_comm_bytes`).  A preset
    with an ``fp32_flops`` rate (``h100``) uses it for fp32 flows; the TPU
    presets take half the bf16 rate, as in the JAX package.
    """
    if device not in DEVICE_PRESETS:
        raise ValueError(f"unknown device {device!r}; "
                         f"known: {sorted(DEVICE_PRESETS)}")
    dev = DEVICE_PRESETS[device]
    devices = _effective_devices(cfg, flow, devices)
    flops = model_flops(cfg, shape) + attention_flops(cfg, shape)
    peak = dev["bf16_flops"] if flow.precision == "bf16" else \
        dev.get("fp32_flops", 0.5 * dev["bf16_flops"])
    adt = _act_dtype_bytes(flow)
    bytes_ = hbm_bytes_kernel_path(cfg, shape, dtype_bytes=adt)
    if not flow.cached_writes:
        bytes_ *= 3.0
    if not flow.fuse_epilogues:
        bytes_ *= 1.5
    if not flow.tile_select and dev.get("plan_tiles", 1.0):
        # minimal 128-tiles re-stream weights once per output tile row
        bytes_ *= 2.0
    if shape.kind == "train":
        # memory savers are not free: each extra microbatch re-gathers the
        # sharded weights; remat recomputes (part of) the forward in backward
        n = count_params(cfg, active_only=cfg.moe is not None)
        bytes_ += (max(flow.microbatches, 1) - 1) * n * adt
        flops *= {"none": 1.0, "block": 4.0 / 3.0,
                  "nested": 1.5}.get(flow.remat, 4.0 / 3.0)
    compute_s = flops / (peak * devices)
    memory_s = bytes_ / (dev["hbm_bw"] * devices)
    comm_s = estimate_comm_bytes(cfg, shape, flow)["total"] / dev["ici_bw"]
    step_s = max(compute_s, memory_s, comm_s)
    bound = ("compute" if step_s == compute_s
             else "memory" if step_s == memory_s else "comm")
    return {"compute_s": compute_s, "memory_s": memory_s, "comm_s": comm_s,
            "step_s": step_s, "bound": bound}
