"""Configuration dataclasses for the repro_torch compilation flow.

A ``ModelConfig`` fully describes an architecture (graph construction consumes
it); a ``ShapeConfig`` describes one input-shape cell (train / prefill /
decode / long-context-decode).  ``FlowConfig`` holds the knobs of the
compilation flow itself (which passes run, execution mode, precision,
distribution) — the analogue of the paper's optimization-application table.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    num_shared: int = 0            # shared (always-on) experts
    d_shared: Optional[int] = None # hidden size of shared experts (default d_expert)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0    # leading layers that use a dense FFN instead
    first_dense_d_ff: int = 0      # hidden size of those dense FFNs

    @property
    def d_shared_eff(self) -> int:
        return self.d_shared if self.d_shared is not None else self.d_expert


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # sliding-window size (None = full)
    rope: Optional[str] = "default"       # None | default | partial
    rope_base: float = 10000.0
    rope_pct: float = 1.0                 # fraction of head_dim rotated
    qkv_bias: bool = False
    out_bias: bool = False
    logits_softcap: Optional[float] = None


@dataclass(frozen=True)
class RecurrenceConfig:
    """Config for linear-recurrence temporal mixing (RG-LRU / RWKV6)."""
    kind: str                      # "rg_lru" | "rwkv6"
    width: int                     # recurrence width (d for rg_lru)
    n_heads: int = 0               # rwkv6 heads (width // head size)
    head_dim: int = 64
    conv_width: int = 4            # temporal conv in front of RG-LRU
    lora_rank: int = 64            # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio | cnn
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    recurrence: Optional[RecurrenceConfig] = None
    # layer pattern: e.g. ("rec", "rec", "attn") repeated for recurrentgemma.
    # None => all layers identical ("attn" or "rec" depending on configs).
    layer_pattern: Optional[Tuple[str, ...]] = None
    ffn_kind: str = "swiglu"       # swiglu | geglu | gelu_mlp | rwkv_cm | moe
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # encoder-decoder (whisper):
    n_encoder_layers: int = 0
    encoder_seq: int = 0           # frames produced by the (stubbed) frontend
    cross_attention: bool = False
    # multimodal stub (llava): number of prepended patch embeddings
    n_patch_tokens: int = 0
    d_vision: int = 1024           # vision-tower output dim (stub input)
    vocab_pad_multiple: int = 32   # Megatron-style vocab padding for TP
    max_seq_len: int = 1 << 20
    # CNN-family fields (paper's own networks); vocab_size doubles as n_classes
    image_size: int = 0
    image_channels: int = 3

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer temporal-mixing kind, length n_layers."""
        if self.layer_pattern is None:
            kind = "rec" if (self.recurrence and self.attention is None) else "attn"
            return tuple([kind] * self.n_layers)
        pat = self.layer_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D).

        Not available yet: it needs the cost estimator (``core/estimator``),
        which ROADMAP Queue 1, "Estimator, a Hopper tiling target, DSE,
        tunedb and autotune", ports.  Raises NotImplementedError."""
        raise NotImplementedError(
            "param_count needs core.estimator, not ported yet "
            "(ROADMAP Queue 1, \"Estimator, a Hopper tiling target, DSE, "
            "tunedb and autotune\")")

    def active_param_count(self) -> int:
        """Not available yet, as :meth:`param_count`."""
        raise NotImplementedError(
            "active_param_count needs core.estimator, not ported yet "
            "(ROADMAP Queue 1, \"Estimator, a Hopper tiling target, DSE, "
            "tunedb and autotune\")")


# ---------------------------------------------------------------------------
# Input-shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Flow (compilation) configuration — the paper's optimization knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TuningConfig:
    """Design-space-explorer settings (paper §IV-J factor selection, grown
    into the 'future work' DSE).  ``hbm_bytes`` is the paper's rule 3 — the
    device resource budget a candidate must fit (v5e HBM by default, but a
    first-class knob: other device generations/backends set it here)."""
    hbm_bytes: int = 16 * 1024 ** 3        # per-device budget (v5e default)
    vmem_candidates: Tuple[int, ...] = (96 * 2 ** 20, 48 * 2 ** 20)
    microbatch_candidates: Tuple[int, ...] = (1, 2, 4, 8)
    scan_unroll_candidates: Tuple[int, ...] = (1, 2, 4)
    ce_chunk_candidates: Tuple[int, ...] = (128, 256, 512)
    # kernel-backend dimension the KernelSelectPass exposes to the explorer:
    # "auto" resolves per-op through the KernelRegistry (Pallas on TPU),
    # "reference" pins the pure-XLA path everywhere.
    backend_candidates: Tuple[str, ...] = ("auto", "reference")
    top_k: int = 3                         # candidates validated compile-in-loop
    max_candidates: int = 16384            # enumeration safety cap
    # device count the ShardingPass enumerates dp/tp/pp mesh factorizations
    # for (0 => mesh is not a search dimension).  ``dse.explore`` sets it
    # from its ``devices`` argument; an explicit ``FlowConfig.mesh_split``
    # pins the factorization instead.
    mesh_devices: int = 0
    # path of the persistent autotune database (repro.tunedb in the JAX
    # package, not ported yet): measured DSE
    # and serving-autotune results are written there and served back across
    # processes (exact-fingerprint hits measure nothing; neighboring batch
    # buckets warm-start).  None disables persistence; ``dse.explore(db=)``
    # and ``autotune_decode(db=)`` override per call.
    tune_db: Optional[str] = None


@dataclass(frozen=True)
class FlowConfig:
    # passes (paper Table I)
    fuse_epilogues: bool = True        # LF
    fold_layers: bool = True           # PK: scan over isomorphic groups
    cached_writes: bool = True         # CW: VMEM accumulation in kernels
    tile_select: bool = True           # LU/LT: BlockSpec tile selection
    precision: str = "bf16"            # OF: "fp32" (base) | "bf16" (optimized)
    streaming: bool = True             # CH/CE analogue: pipeline+overlap enabled
    # execution mode: "auto" picks folded for deep nets, pipelined for small
    mode: str = "auto"                 # auto | folded | pipelined
    # distribution
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    pp_axis: Optional[str] = None      # set to "pod" for cross-pod pipelining
    # the chosen mesh factorization as ordered (axis, size) pairs, e.g.
    # (("data", 2), ("model", 2)).  Set by repro_torch.flow.compile(mesh=...) from
    # the MeshSpec, or by the DSE when it searches dp/tp/pp splits; consumed
    # by the ShardingPass, which records the partitioning on the plan.
    mesh_split: Optional[Tuple[Tuple[str, int], ...]] = None
    microbatches: int = 1              # grad-accum / pipeline microbatches
    # training
    remat: str = "block"               # none | block | nested (two-level)
    grad_compression: Optional[str] = None  # None | "int8_ef"
    # kernels: "auto" resolves per op via the KernelRegistry (Pallas where an
    # implementation exists and the platform compiles it natively, reference
    # elsewhere); the explicit values pin one backend for every op.
    kernel_backend: str = "auto"       # auto | reference | pallas | pallas_interpret
    vmem_budget_bytes: int = 96 * 1024 * 1024  # v5e ~128MiB VMEM, leave headroom
    scan_unroll: int = 1
    ce_chunk: int = 256                # sequence-chunked CE logits block
    # per-kernel Pallas tile-schedule overrides as ordered (tile_key, tile)
    # pairs, e.g. (("attention", (128, 256)), ("conv2d", (16, 128))) — the
    # sub-plan-level tunables the tunedb records and the serving autotune's
    # tile microbench pins (KernelContract.tile_key names the join point).
    # Applied by the TilingPass on top of its own selection; None keeps the
    # selector's choices.
    tile_overrides: Optional[Tuple[Tuple[str, Any], ...]] = None
    # design-space exploration (repro.core.dse in the JAX package, not
    # ported yet)
    tuning: TuningConfig = TuningConfig()

    def base(self) -> "FlowConfig":
        """The paper's *base* (unoptimized) configuration — every pass off."""
        return dataclasses.replace(
            self, fuse_epilogues=False, fold_layers=False, cached_writes=False,
            tile_select=False, precision="fp32", streaming=False, mode="folded",
            remat="none",
        )


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
