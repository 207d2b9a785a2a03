"""Shared invariant rules — the single source of truth for checks that used
to be duplicated across ``EngineConfig.__post_init__``, ``ServingProfile``
and ``split_rejection_reason``.

Each rule is a pure function returning ``None`` when the invariant holds or
the exact message the legacy call site raised (error text is part of the
test surface).  Constructors keep raising ``ValueError(msg)``; the verifier
wraps the same messages in
:class:`~repro_torch.analysis.diagnostics.Diagnostic` objects, so a rule can
never drift between the two consumers.  (The port's copy of the JAX
package's ``analysis/rules.py``.)
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# serving ladders (EngineConfig.__post_init__)
# ---------------------------------------------------------------------------


def chunk_in_range(chunk_size: int, max_seq_len: int) -> Optional[str]:
    if not 1 <= chunk_size <= max_seq_len:
        return (f"chunk_size must be in [1, max_seq_len="
                f"{max_seq_len}], got {chunk_size}")
    return None


def fori_seg_valid(fori_seg: int) -> Optional[str]:
    if fori_seg == 1 or fori_seg < 0:
        return f"fori_seg must be 0 (off) or >= 2, got {fori_seg}"
    return None


def chunk_ladder(chunk_buckets: Sequence[int],
                 chunk_size: int) -> Optional[str]:
    """Rungs of the per-tick chunk ladder: positive, rung 1 first (plain
    decode ticks), final rung == chunk_size.  ``chunk_buckets`` is the
    normalized (sorted, deduped) ladder."""
    buckets = tuple(chunk_buckets)
    if any(b < 1 for b in buckets):
        return "chunk buckets must be positive"
    if not buckets or buckets[0] != 1:
        return ("chunk_buckets must include rung 1 (plain decode "
                f"ticks), got {buckets}")
    if buckets[-1] != chunk_size:
        return (f"chunk_buckets must end at chunk_size="
                f"{chunk_size}, got {buckets}")
    return None


def batch_ladder(batch_buckets: Sequence[int], max_batch: int) -> Optional[str]:
    buckets = tuple(batch_buckets)
    if any(b < 1 for b in buckets):
        return "batch buckets must be positive"
    if not buckets or buckets[-1] != max_batch:
        return (f"batch_buckets must end at max_batch={max_batch}, "
                f"got {buckets}")
    return None


def prompt_ladder(prompt_buckets: Sequence[int],
                  max_seq_len: int) -> Optional[str]:
    buckets = tuple(prompt_buckets)
    if any(b < 1 for b in buckets):
        return "prompt buckets must be positive"
    if buckets and buckets[-1] > max_seq_len:
        return f"prompt buckets exceed max_seq_len={max_seq_len}"
    return None


def block_divides_buckets(block_size: int,
                          prompt_buckets: Sequence[int]) -> Optional[str]:
    """The paged pool packs prompt K/V block-by-block and the prefix index
    hashes block-aligned runs: every prompt-bucket rung must be a whole
    number of blocks."""
    bad = [b for b in prompt_buckets if b % block_size]
    if bad:
        return (f"block_size={block_size} must divide every prompt "
                f"bucket; offending rungs {bad} (of "
                f"{list(prompt_buckets)})")
    return None


def speculation_valid(kind: str, draft_k: int, draft_cfg: Any,
                      max_seq_len: int, fori_seg: int) -> Optional[str]:
    """The EngineConfig.speculation envelope: a known drafter kind, a
    verify cell that fits the sequence envelope, a named draft config when
    the drafter is a model, and no fori segments (acceptance is decided on
    the host every tick, so a host-free segment can never carry a
    speculative slot)."""
    kinds = ("ngram", "draft", "null")
    if kind not in kinds:
        return (f"speculation drafter kind must be one of {kinds}, "
                f"got {kind!r}")
    if draft_k < 1:
        return f"speculation draft_k must be >= 1, got {draft_k}"
    if draft_k + 1 > max_seq_len:
        return (f"speculation draft_k={draft_k} needs a (B, {draft_k + 1}) "
                f"verify cell, beyond max_seq_len={max_seq_len}")
    if kind == "draft" and not draft_cfg:
        return ("speculation kind 'draft' needs a draft model config name "
                "(draft:<cfg>:<k>)")
    if fori_seg:
        return (f"speculation and fori_seg={fori_seg} are mutually "
                "exclusive: acceptance is decided on the host every tick")
    return None


def pool_admits_full_slot(num_blocks: Optional[int],
                          blocks_per_slot: int) -> Optional[str]:
    """Scalar-prefetch bounds for the paged decode kernel: the block-table
    gather indexes ``[0, num_blocks)``; a pool smaller than one slot's full
    chain plus the trash block can never admit a max-length request, and
    block 0 (trash) must always exist."""
    if num_blocks is None:               # full provisioning — always admits
        return None
    need = 1 + blocks_per_slot
    if num_blocks < need:
        return (f"num_blocks={num_blocks} cannot hold one slot's chain: "
                f"need >= {need} (blocks_per_slot={blocks_per_slot} + the "
                "trash block) for in-bounds block-table gathers")
    return None


# ---------------------------------------------------------------------------
# serving profiles (ServingProfile.__post_init__ — candidate sets)
# ---------------------------------------------------------------------------


def profile_batch_buckets(batch_buckets: Sequence[int]) -> Optional[str]:
    buckets = tuple(batch_buckets)
    if not buckets or tuple(sorted(buckets)) != buckets:
        return "batch_buckets must be ascending and non-empty"
    if any(b < 1 for b in buckets):
        return "batch_buckets must be positive"
    return None


def profile_block_sizes(block_sizes: Sequence[int],
                        max_seq_len: int) -> Optional[str]:
    sizes = tuple(block_sizes)
    if any(b < 1 or b > max_seq_len for b in sizes):
        return "block sizes must be in [1, max_seq_len]"
    if any(max_seq_len % b for b in sizes):
        return ("every candidate block size must divide max_seq_len "
                "(EngineConfig requires whole-block prompt buckets); got "
                f"{sizes} vs max_seq_len={max_seq_len}")
    return None


def profile_chunk_sizes(chunk_sizes: Sequence[int],
                        max_seq_len: int) -> Optional[str]:
    sizes = tuple(chunk_sizes)
    if not sizes or any(k < 1 or k > max_seq_len for k in sizes):
        return (f"chunk sizes must be in [1, max_seq_len]; got "
                f"{sizes}")
    return None


def profile_fori_segs(fori_segs: Sequence[int]) -> Optional[str]:
    segs = tuple(fori_segs)
    if any(s == 1 or s < 0 for s in segs):
        return (f"fori segment candidates must be 0 (off) or >= 2; got "
                f"{segs}")
    return None


def profile_spec_ks(spec_ks: Sequence[int],
                    max_seq_len: int) -> Optional[str]:
    ks = tuple(spec_ks)
    if not ks or any(k < 0 or k + 1 > max_seq_len for k in ks):
        return ("speculation draft_k candidates must be 0 (off) or fit a "
                f"(B, k+1) verify cell within max_seq_len={max_seq_len}; "
                f"got {ks}")
    return None


# ---------------------------------------------------------------------------
# mesh-split divisibility (split_rejection_reason / the DSE screen)
# ---------------------------------------------------------------------------


def mesh_split_rejection(cfg: Any, shape: Any, flow: Any,
                         split: Tuple[Tuple[str, int], ...]
                         ) -> Optional[Tuple[str, str]]:
    """The paper's even-division rule across devices, as (code, reason).

    ``M401`` — global batch vs the dp factor; ``M402`` — tp vs the
    tp-shardable dims; ``M403`` — pp applicability.  ``None`` means the
    split yields even shards everywhere."""
    from repro_torch.core.passes.sharding import split_roles
    sizes = dict(split)
    dp_axes, tp_axis, pp_axis = split_roles(flow, split)
    dp = 1
    for a in dp_axes:
        dp *= sizes.get(a, 1)
    tp = sizes.get(tp_axis, 1) if tp_axis else 1
    pp = sizes.get(pp_axis, 1) if pp_axis else 1
    if shape.global_batch % dp != 0:
        return "M401", f"batch {shape.global_batch} not divisible by dp={dp}"
    if tp > 1:
        if cfg.family == "cnn":
            return "M402", "tp axis would idle for the cnn family"
        # the solver shards the first divisible TP_ROLE dim — viable as soon
        # as any of them divides
        dims = ([cfg.moe.num_experts] if cfg.moe else []) + \
            [cfg.d_ff, cfg.padded_vocab] + \
            ([cfg.attention.n_heads] if cfg.attention else [])
        if not any(d % tp == 0 for d in dims):
            return ("M402",
                    f"tp={tp} divides none of the tp-shardable dims {dims}")
    if pp > 1:
        if shape.kind != "train" or cfg.family == "cnn":
            return "M403", "pp applies to LM train cells only"
        if cfg.n_layers % pp != 0:
            return "M403", f"{cfg.n_layers} layers not divisible by pp={pp}"
    return None


# ---------------------------------------------------------------------------
# flow-level knob screen (the DSE's pre-plan static pruner)
# ---------------------------------------------------------------------------

_PRECISIONS = ("bf16", "fp32")
_MODES = ("auto", "folded", "pipelined")


def flow_knob_rejection(flow: Any) -> Optional[str]:
    """Cheap validity screen over one ``FlowConfig`` — every violation here
    would crash or nonsense a later pass, so the explorer drops the
    candidate before building (let alone compiling) a plan."""
    from repro_torch.kernels.registry import canon_backend
    try:
        canon_backend(flow.kernel_backend)
    except ValueError as e:
        return str(e)
    if flow.precision not in _PRECISIONS:
        return (f"precision must be one of {_PRECISIONS}, "
                f"got {flow.precision!r}")
    if flow.mode not in _MODES:
        return f"mode must be one of {_MODES}, got {flow.mode!r}"
    if flow.microbatches < 1:
        return f"microbatches must be >= 1, got {flow.microbatches}"
    if flow.scan_unroll < 1:
        return f"scan_unroll must be >= 1, got {flow.scan_unroll}"
    if flow.ce_chunk < 1:
        return f"ce_chunk must be >= 1, got {flow.ce_chunk}"
    if flow.vmem_budget_bytes < 1:
        return (f"vmem_budget_bytes must be positive, got "
                f"{flow.vmem_budget_bytes}")
    if flow.tile_overrides is not None:
        from repro_torch.core.passes.tiling import TILE_KEYS
        try:
            pairs = tuple(flow.tile_overrides)
        except TypeError:
            return (f"tile_overrides must be a sequence of "
                    f"(tile_key, tile) pairs, got "
                    f"{flow.tile_overrides!r}")
        for pair in pairs:
            if not (isinstance(pair, (tuple, list)) and len(pair) == 2):
                return (f"tile_overrides entries must be (tile_key, tile) "
                        f"pairs, got {pair!r}")
            key = pair[0]
            if key not in TILE_KEYS:
                return (f"tile_overrides key {key!r} is not a known tile "
                        f"key {TILE_KEYS}")
    return None
