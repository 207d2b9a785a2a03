"""Shared invariant rules — the serving rules S301-S307 that
``EngineConfig.__post_init__`` raises.

Each rule is a pure function returning ``None`` when the invariant holds or
the exact message the legacy call site raised (error text is part of the
test surface).  Constructors keep raising ``ValueError(msg)``.

This is the port's copy of the serving rules of the JAX package's
``analysis/rules.py`` (the port imports nothing of that package); the
serving-profile, mesh and flow-knob rules, and the checkers and diagnostics
that wrap these messages, arrive with the DSE and the static verifier
(ROADMAP Queue 1, "Static verifier" and "Estimator, a Hopper tiling
target, DSE, tunedb and autotune").
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

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
