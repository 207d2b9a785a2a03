"""Paged KV-cache manager: fixed-size blocks from a device-resident pool.

The rolling per-request cache reserves ``max_seq_len x n_slots`` tokens of
K/V for every layer whether the slots are live or not.  The paged manager
replaces it for serving: K/V live in a per-layer *pool* of fixed-size blocks,
each slot owns a chain of blocks recorded in a block table, and the decode
lookup path (``kernels/decode_attention.paged_decode_attention`` on the
card, the op's reference path elsewhere) gathers through the table — device
memory scales with *live tokens*, not ``max_seq_len x batch``.

Layout notes:

* block 0 of every pool is the reserved **trash block**: freed slots park
  their block tables on it, so the decode tick's unconditional append for
  inactive slots lands in memory no live request owns;
* attention state per key becomes ``{"kp", "vp", "bt", "len"}`` — pools
  (blocks, block_size, KV, Dh), per-slot block table (slots, nblk) and
  per-slot decode position (slots,).  ``repro_torch.core.ops_impl``'s
  attention op recognizes this layout;
* folded units carry the usual leading ``reps`` (layers) dimension on every
  leaf; block tables are replicated per layer (ints, negligible);
* non-attention per-request state (the RG-LRU hybrid's conv and recurrence
  states) stays dense, one row per slot, copied in at admission and
  written in place by the decode tick; such state cannot be seeded from a
  token-prefix match, so it refuses the prefix cache.  Cross-attention
  state arrives with its family (ROADMAP Queue 1, "Other model
  families").

Prefix caching (``prefix_cache=True``) layers block *sharing* on top:
blocks are refcounted, fully-filled prompt blocks are registered in a
:class:`repro_torch.serving.prefix.PrefixIndex` keyed by chained content
hashes, and a new request whose prompt prefix matches seeds its block table
from the cached blocks and only computes the uncovered tail.  Shared blocks
are copy-on-write: decode never writes a block with ``refcount > 1`` — the
owner forks it first (``kernels/decode_attention.copy_block`` through the
registry).  Blocks whose last reference drops park on an LRU list, still
indexed, and are reclaimed only under allocation pressure.

The host/device split is explicit: :class:`BlockLedger` is the pure-host
bookkeeping (pool, chains, index, match/charge/fork decisions — no torch),
and :class:`PagedKVCache` mirrors the ledger's decisions onto the
device-resident pools and block tables.  Where the JAX package scatters
into a donated copy under ``jit``, the port writes the tensors in place.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.lowering import _mk_state, _op_state_shapes, unit_key
from repro_torch.core.plan import ExecutionPlan
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.prefix import BlockHash, PrefixIndex, block_hashes

TRASH_BLOCK = 0


# ---------------------------------------------------------------------------
# host-side block allocator
# ---------------------------------------------------------------------------

class BlockPool:
    """Refcounted free-list allocator over pool block ids.

    Block 0 is the trash block and is never handed out.  Every other block
    is in exactly one of three states:

    * **free** — on the free list, refcount 0, contents meaningless;
    * **live** — refcount >= 1 (slot chains and COW spares hold the refs);
    * **cached** — refcount 0 but still indexed by the prefix cache; parked
      on an LRU list and reclaimed (oldest first, ``on_cache_evict`` fired
      so the index can forget it) only when the free list runs dry.

    ``allocate`` + ``release`` keep their original semantics for the
    non-sharing paths: allocated blocks start at refcount 1, ``release``
    decrements, and a double release raises.
    """

    def __init__(self, num_blocks: int,
                 on_cache_evict: Optional[Callable[[int], None]] = None):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is the trash block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)    # O(1) double-free detection
        self._ref: Dict[int, int] = {}      # live blocks -> refcount
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref 0
        self._cached_tag: set = set()       # blocks the prefix index holds
        self.on_cache_evict = on_cache_evict
        self.n_cache_evictions = 0

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free + reclaimable cached."""
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        """Live (referenced) blocks."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        return len(self._lru)

    def publish_metrics(self, reg: "MetricsRegistry") -> None:
        """Publish pool occupancy + reclaim counters (``pool.blocks.*``)."""
        reg.gauge("pool.blocks.live").set(self.used_blocks)
        reg.gauge("pool.blocks.cached").set(self.cached_blocks)
        reg.gauge("pool.blocks.free").set(self.free_blocks)
        reg.counter("pool.cache_evictions").inc(self.n_cache_evictions)

    def can_allocate(self, n: int) -> bool:
        return n <= self.free_blocks

    def allocate(self, n: int) -> List[int]:
        if not self.can_allocate(n):
            raise RuntimeError(
                f"KV pool exhausted: want {n} blocks, {self.free_blocks} free")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
                self._free_set.discard(b)
            else:                            # reclaim the LRU-oldest cached
                b, _ = self._lru.popitem(last=False)
                self._cached_tag.discard(b)
                self.n_cache_evictions += 1
                if self.on_cache_evict is not None:
                    self.on_cache_evict(b)
            self._ref[b] = 1
            out.append(b)
        return out

    def refcount(self, b: int) -> int:
        return self._ref.get(b, 0)

    def incref(self, b: int) -> None:
        """Add a reference: live blocks bump the count, cached blocks are
        revived off the LRU list.  Free blocks cannot be referenced."""
        if b == TRASH_BLOCK:
            raise ValueError("trash block cannot be referenced")
        if b in self._ref:
            self._ref[b] += 1
        elif b in self._lru:
            del self._lru[b]
            self._ref[b] = 1
        else:
            raise ValueError(f"block {b} is free; cannot reference it")

    def decref(self, b: int) -> None:
        if b == TRASH_BLOCK:
            raise ValueError("trash block cannot be released")
        if b not in self._ref:
            raise ValueError(f"double free of block {b}")
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            if b in self._cached_tag:        # indexed: park, most-recent
                self._lru[b] = None
            else:
                self._free.append(b)
                self._free_set.add(b)

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            self.decref(b)

    def mark_cached(self, b: int) -> None:
        """The prefix index now points at ``b``: when its refcount drops to
        zero it parks on the LRU list instead of the free list."""
        if b == TRASH_BLOCK:
            raise ValueError("trash block cannot be cached")
        if b not in self._ref and b not in self._lru:
            raise ValueError(f"block {b} is free; cannot cache it")
        self._cached_tag.add(b)

    def is_cached(self, b: int) -> bool:
        return b in self._cached_tag

    def check_invariants(self) -> None:
        """Every block is in exactly one state; the trash block is in none;
        counts conserve.  Raises AssertionError on violation (the
        property-based suite calls this after every operation)."""
        free, lru, live = set(self._free), set(self._lru), set(self._ref)
        assert TRASH_BLOCK not in free | lru | live, "trash block leaked"
        assert free == self._free_set and len(self._free) == len(free), \
            "free list / free set diverged"
        assert not (free & lru) and not (free & live) and not (lru & live), \
            "block in two states at once"
        assert free | lru | live == set(range(1, self.num_blocks)), \
            "block count not conserved"
        assert all(c >= 1 for c in self._ref.values()), "live refcount < 1"
        assert self._cached_tag <= (lru | live), "cached tag on a free block"
        assert lru <= self._cached_tag, "parked block without a cache tag"


# ---------------------------------------------------------------------------
# prefix matching + host-side ledger
# ---------------------------------------------------------------------------

@dataclass
class PrefixMatch:
    """A locked prefix-cache hit: pool blocks (refcounts already bumped)
    holding ``covered_raw`` prompt tokens, of which the engine may skip
    ``covered`` (at least the last prompt token is always recomputed — its
    logits seed sampling)."""
    blocks: List[int]
    hashes: List[BlockHash]
    covered: int
    covered_raw: int

    @property
    def needs_cow_spare(self) -> bool:
        """True when the write at position ``covered`` lands inside a
        matched block: the admission charges one spare block so the
        copy-on-write fork can never fail on an exhausted pool."""
        return self.covered_raw > self.covered


class BlockLedger:
    """Host-side accounting for one paged cache: the pool, per-slot block
    chains, COW spares, and (optionally) the prefix index.

    Pure bookkeeping — no torch — mirroring exactly the decisions
    :class:`PagedKVCache` applies to device state, so property-based tests
    can drive millions of admit/decode/finish/evict interleavings against
    the real allocator logic.  Invariants are checked by :meth:`check`.
    """

    def __init__(self, num_blocks: int, n_slots: int, block_size: int,
                 blocks_per_slot: int, *, prefix_cache: bool = False,
                 min_match_ratio: float = 0.5):
        self.block_size = block_size
        self.blocks_per_slot = blocks_per_slot
        self.n_slots = n_slots
        self.min_match_ratio = min_match_ratio
        self.pool = BlockPool(num_blocks, on_cache_evict=self._on_reclaim)
        self.index: Optional[PrefixIndex] = \
            PrefixIndex() if prefix_cache else None
        self.chains: List[List[int]] = [[] for _ in range(n_slots)]
        self.spares: List[Optional[int]] = [None] * n_slots
        self.lens: List[int] = [0] * n_slots
        self._prompt_len: List[int] = [0] * n_slots
        self._prompt_hashes: List[List[Tuple[BlockHash, int]]] = \
            [[] for _ in range(n_slots)]
        self._registered: List[bool] = [False] * n_slots
        # counters (surfaced through Engine metrics)
        self.hits = 0
        self.misses = 0
        self.cached_tokens = 0
        self.cow_forks = 0
        self.spec_rollback_tokens = 0
        self.spec_fork_undos = 0
        # speculative windows (spec_begin .. spec_commit): per-slot base
        # length snapshot plus the COW forks performed inside the window —
        # (chain_idx, old, new, from_spare) — so a rollback can undo forks
        # that served only rejected tokens
        self._spec_base: List[Optional[int]] = [None] * n_slots
        self._spec_forks: List[List[Tuple[int, int, int, bool]]] = \
            [[] for _ in range(n_slots)]
        # one-entry hash memo: a blocked queue head is re-matched every
        # tick and a successful admission hashes right after its match —
        # both repeat the same prompt back-to-back
        self._hash_key: Optional[bytes] = None
        self._hash_val: List[Tuple[BlockHash, int]] = []

    def _hashes_for(self, toks: np.ndarray) -> List[Tuple[BlockHash, int]]:
        key = toks.tobytes()
        if key != self._hash_key:
            self._hash_key = key
            self._hash_val = block_hashes(toks, self.block_size)
        return self._hash_val

    # -- index plumbing ------------------------------------------------------
    def _on_reclaim(self, block: int) -> None:
        if self.index is not None:
            self.index.drop_block(block)

    @property
    def cache_evictions(self) -> int:
        return self.pool.n_cache_evictions

    def publish_metrics(self, reg: "MetricsRegistry") -> None:
        """Publish prefix-cache and speculation outcomes under their
        dotted names (``serving.prefix.*`` / ``serving.spec.*``)."""
        reg.counter("serving.prefix.hits").inc(self.hits)
        reg.counter("serving.prefix.misses").inc(self.misses)
        reg.counter("serving.prefix.cached_tokens").inc(self.cached_tokens)
        reg.counter("serving.prefix.evictions").inc(self.cache_evictions)
        reg.counter("serving.prefix.cow_forks").inc(self.cow_forks)
        reg.counter("serving.spec.rollback_tokens").inc(
            self.spec_rollback_tokens)
        reg.counter("serving.spec.fork_undos").inc(self.spec_fork_undos)

    # -- matching ------------------------------------------------------------
    def match_and_lock(self, prompt: np.ndarray) -> Optional[PrefixMatch]:
        """Longest indexed prefix of ``prompt`` (full blocks, then an
        exact-content partial tail).  Matched blocks are incref'd — locked
        against reclaim — before this returns; callers either hand the match
        to :meth:`admit` (which adopts the references) or :meth:`unlock` it.

        ``covered`` is capped at ``len(prompt) - 1``: the last prompt token
        is always recomputed through the decode cell so the engine has
        logits to sample the first generated token from.

        A marginal hit is a *miss*: the uncovered tail catches up one token
        per decode tick, so a match covering less than ``min_match_ratio``
        of the prompt would trade one batched prefill for a long sequential
        tail — worse than serving cold.
        """
        if self.index is None:
            return None
        toks = np.asarray(prompt, np.int32).reshape(-1)
        hashes = self._hashes_for(toks)
        blocks: List[int] = []
        hit_hashes: List[BlockHash] = []
        covered_raw = 0
        for h, end in hashes:
            b = self.index.get(h)
            if b is None:
                break
            blocks.append(b)
            hit_hashes.append(h)
            covered_raw = end
        covered = min(covered_raw, int(toks.size) - 1)
        if covered <= 0 or covered < self.min_match_ratio * int(toks.size):
            return None
        for b in blocks:
            self.pool.incref(b)
        return PrefixMatch(blocks=blocks, hashes=hit_hashes,
                           covered=covered, covered_raw=covered_raw)

    def unlock(self, match: PrefixMatch) -> None:
        """Drop the locks of a match that will not be admitted."""
        self.pool.release(match.blocks)

    def fresh_blocks_needed(self, total_budget: int,
                            match: Optional[PrefixMatch]) -> int:
        """Admission-control charge: blocks to allocate for a request with
        ``total_budget`` tokens given an (optional) locked match — the
        uncovered chain tail plus, when the first write lands inside a
        matched block, one COW spare."""
        n_total = blocks_for_tokens(total_budget, self.block_size)
        if match is None:
            return n_total
        return n_total - len(match.blocks) + int(match.needs_cow_spare)

    # -- admit / decode / release -------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray, reserve_tokens: int,
              match: Optional[PrefixMatch] = None,
              resident: Optional[int] = None) -> List[int]:
        """Build ``slot``'s block chain: matched blocks (references adopted
        from the lock) followed by freshly allocated ones, plus the COW
        spare when charged.  Returns the chain.  The caller seeds device
        block tables from it and sets the slot's decode position to
        ``match.covered`` (0-covered requests prefill the whole prompt).

        ``resident`` overrides the initial token count (chunked-prefill
        admissions start at 0: nothing is written yet — the whole prompt
        drains through chunked catch-up ticks)."""
        if self.chains[slot]:
            raise RuntimeError(f"slot {slot} is occupied")
        toks = np.asarray(prompt, np.int32).reshape(-1)
        prompt_len = int(toks.size)
        if reserve_tokens < prompt_len:
            raise ValueError("reserve_tokens must cover the prompt")
        if reserve_tokens > self.blocks_per_slot * self.block_size:
            raise ValueError(
                f"request needs {reserve_tokens} tokens; slot capacity is "
                f"{self.blocks_per_slot * self.block_size} "
                f"(blocks_per_slot x block_size)")
        matched = list(match.blocks) if match is not None else []
        # allocate exactly what admission charged (fresh_blocks_needed is
        # the single source of the charge formula)
        fresh = self.pool.allocate(
            self.fresh_blocks_needed(reserve_tokens, match))
        if match is not None and match.needs_cow_spare:
            self.spares[slot] = fresh.pop()
        self.chains[slot] = matched + fresh
        if resident is not None:
            self.lens[slot] = resident
        else:
            self.lens[slot] = match.covered if match is not None else prompt_len
        self._prompt_len[slot] = prompt_len
        self._registered[slot] = False
        if self.index is not None:
            self._prompt_hashes[slot] = list(self._hashes_for(toks))
            if match is not None:
                self.hits += 1
                self.cached_tokens += match.covered
            else:
                self.misses += 1
        return self.chains[slot]

    def needs_fork(self, slot: int) -> bool:
        """Would the next decode write for ``slot`` land in a block some
        other chain also references?  (The copy-on-write trigger.)"""
        chain = self.chains[slot]
        if not chain:
            return False
        ci = self.lens[slot] // self.block_size
        return self.pool.refcount(chain[ci]) > 1

    def fork(self, slot: int) -> Tuple[int, int, int]:
        """Copy-on-write: repoint ``slot``'s write-target chain entry at its
        pre-charged spare (or a fresh block) and drop the shared reference.
        Returns ``(chain_index, old_block, new_block)`` — the caller copies
        the device block contents and updates the block-table row."""
        ci = self.lens[slot] // self.block_size
        old = self.chains[slot][ci]
        new = self.spares[slot]
        from_spare = new is not None
        if from_spare:
            self.spares[slot] = None
        else:
            # defensive: admission charges a spare for every fork this
            # ledger can produce, but keep the fallback for direct drivers
            new = self.pool.allocate(1)[0]
        self.chains[slot][ci] = new
        self.pool.decref(old)
        self.cow_forks += 1
        if self._spec_base[slot] is not None:
            self._spec_forks[slot].append((ci, old, new, from_spare))
        return ci, old, new

    def note_write(self, slot: int, n: int = 1) -> None:
        self.lens[slot] += n

    # -- speculative windows (draft-verify-rollback) ------------------------
    def spec_begin(self, slot: int) -> None:
        """Open a speculative window on ``slot``: snapshot its committed
        length so :meth:`spec_commit` can roll back rejected writes (and
        undo COW forks that only speculative tokens needed)."""
        if self._spec_base[slot] is not None:
            raise RuntimeError(f"slot {slot} already has an open "
                               "speculative window")
        if not self.chains[slot]:
            raise RuntimeError(f"slot {slot} is empty; nothing to speculate")
        self._spec_base[slot] = self.lens[slot]
        self._spec_forks[slot] = []

    def spec_commit(self, slot: int, committed: int) -> int:
        """Close ``slot``'s speculative window, keeping the first
        ``committed`` of the tokens written inside it: the length rolls
        back to ``base + committed`` and any fork performed inside the
        window whose block ends up holding *no* committed token is undone —
        the chain is repointed back at the (still live or LRU-parked)
        shared original, and the forked copy is released, or restored as
        the slot's charged COW spare when it came from one.  This is the
        no-leak guarantee under partial acceptance.  Returns the number of
        rolled-back tokens."""
        base = self._spec_base[slot]
        if base is None:
            raise RuntimeError(f"slot {slot} has no open speculative window")
        self._spec_base[slot] = None
        written = self.lens[slot] - base
        if not 0 <= committed <= written:
            raise ValueError(
                f"slot {slot}: committed {committed} outside the window's "
                f"{written} speculative writes")
        rolled = written - committed
        self.lens[slot] = keep_end = base + committed
        for ci, old, new, from_spare in reversed(self._spec_forks[slot]):
            # the window's first write into block ci; if the commit kept
            # anything at or past it, the forked copy holds committed K/V
            # the original lacks and must stay
            first_write = max(base, ci * self.block_size)
            if keep_end > first_write:
                continue
            if self.pool.refcount(old) == 0 and old not in self.pool._lru:
                continue                 # original reclaimed: keep the fork
            self.pool.incref(old)
            self.chains[slot][ci] = old
            if from_spare and self.spares[slot] is None:
                self.spares[slot] = new  # restore the charged spare
            else:
                self.pool.decref(new)
            self.spec_fork_undos += 1
        self._spec_forks[slot] = []
        self.spec_rollback_tokens += rolled
        return rolled

    def register_prompt(self, slot: int) -> None:
        """Index ``slot``'s fully-filled prompt blocks (call once the whole
        prompt's K/V is resident: cold admits immediately after the prefill
        scatter, prefix-seeded admits when catch-up completes).  The partial
        tail block — still written by this slot's decode — is indexed later,
        at :meth:`release`."""
        if self.index is None:
            return
        self._registered[slot] = True
        n_full = self._prompt_len[slot] // self.block_size
        for i in range(n_full):
            h, _ = self._prompt_hashes[slot][i]
            if self.index.get(h) is None:
                self.index.insert(h, self.chains[slot][i])
                self.pool.mark_cached(self.chains[slot][i])

    def release(self, slot: int) -> List[int]:
        """Drop every reference ``slot`` holds (chain + unused COW spare);
        blocks the index still points at park on the LRU list, the rest go
        back to the free list.  The prompt's partial tail block is indexed
        on the way out — its owner can no longer write it, so sharing it is
        now safe.  Returns the released chain."""
        chain = self.chains[slot]
        if not chain:
            return []
        p_len = self._prompt_len[slot]
        if self.index is not None and self._registered[slot] \
                and p_len % self.block_size:
            i = p_len // self.block_size
            h, _ = self._prompt_hashes[slot][i]
            if self.index.get(h) is None:
                self.index.insert(h, chain[i])
                self.pool.mark_cached(chain[i])
        self.pool.release(chain)
        if self.spares[slot] is not None:
            self.pool.decref(self.spares[slot])
            self.spares[slot] = None
        self.chains[slot] = []
        self.lens[slot] = 0
        self._prompt_len[slot] = 0
        self._prompt_hashes[slot] = []
        self._registered[slot] = False
        self._spec_base[slot] = None
        self._spec_forks[slot] = []
        return chain

    # -- invariants ----------------------------------------------------------
    def check(self) -> None:
        """The serving-state invariants the property suite hammers on:
        pool-state conservation, refcounts == chain references, no chain or
        spare on a freed/trash block, index entries only on live-or-parked
        blocks."""
        self.pool.check_invariants()
        refs: Dict[int, int] = {}
        for chain in self.chains:
            for b in chain:
                assert b != TRASH_BLOCK, "trash block in a chain"
                refs[b] = refs.get(b, 0) + 1
        for sp in self.spares:
            if sp is not None:
                assert sp != TRASH_BLOCK, "trash block as a COW spare"
                refs[sp] = refs.get(sp, 0) + 1
        assert set(refs) == set(self.pool._ref), \
            "live blocks != blocks referenced by chains/spares"
        for b, n in refs.items():
            assert self.pool.refcount(b) == n, \
                f"block {b}: refcount {self.pool.refcount(b)} != {n} refs"
        if self.index is not None:
            for _, b in self.index.items():
                assert self.pool.refcount(b) > 0 or b in self.pool._lru, \
                    f"index entry on freed block {b}"


# ---------------------------------------------------------------------------
# paged serving state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Entry:
    """One stateful op's place in the serving-state tree."""
    ukey: str
    skey: str
    op: Any                  # MicroOp
    paged: bool              # attention (non-cross) -> paged pool layout
    nlead: int               # 0, or 1 for folded units (leading reps dim)
    reps: int


def _state_entries(plan: ExecutionPlan) -> List[_Entry]:
    graph = plan.graph
    out: List[_Entry] = []
    for unit in plan.units:
        ukey = unit_key(graph, unit)
        if unit.folded:
            protos = [graph.blocks[unit.indices[j]] for j in range(unit.period)]
            nlead, reps = 1, unit.reps
        else:
            protos = [graph.blocks[unit.indices[0]]]
            nlead, reps = 0, 1
        for blk in protos:
            for op in blk.stateful_ops():
                paged = op.op == "attention" and not op.attrs.get("cross")
                out.append(_Entry(ukey, op.attrs["state_key"], op, paged,
                                  nlead, reps))
    return out


def needs_exact_prompts(plan: ExecutionPlan) -> bool:
    """True when the plan holds per-request state that a left-padded prompt
    would corrupt: recurrent and conv state never see the positions array,
    so they would take the pad tokens as real context."""
    return any(not e.paged and e.op.op != "attention"
               for e in _state_entries(plan))


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    return max(1, math.ceil(tokens / block_size))


class PagedKVCache:
    """Device state + host allocator for one compiled plan's decode cell.

    ``state`` is the tree handed to the decode stage in place of the
    rolling cache; ``slot_axes`` mirrors it with the index of each leaf's
    slot dimension (-1 for pool leaves, which are slot-agnostic) so the
    engine can cut the tree down to a batch bucket
    (:func:`slice_state`, views: the tick's in-place writes land in these
    tensors) and check it back in (:func:`merge_state`).

    With ``prefix_cache=True`` the host side runs through a refcounting
    :class:`BlockLedger` + :class:`~repro_torch.serving.prefix.PrefixIndex`:
    :meth:`match_and_lock` finds shared prompt blocks, :meth:`admit` seeds
    from them, and :meth:`prepare_decode` performs the copy-on-write forks
    before each decode tick.
    """

    def __init__(self, plan: ExecutionPlan, n_slots: int, *,
                 block_size: int, blocks_per_slot: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 min_match_ratio: float = 0.5,
                 device: Any = "cpu"):
        if block_size < 1 or blocks_per_slot < 1 or n_slots < 1:
            raise ValueError("block_size, blocks_per_slot, n_slots must be >=1")
        self.plan = plan
        self.cfg = plan.cfg
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.block_size = block_size
        self.blocks_per_slot = blocks_per_slot    # block-table width
        # default: full provisioning (every slot can hold its whole chain)
        # plus the trash block; tighter pools exercise admission control
        self.num_blocks = num_blocks if num_blocks is not None \
            else 1 + n_slots * blocks_per_slot
        self.prefix_cache = prefix_cache
        self._entries = _state_entries(plan)
        if not any(e.paged for e in self._entries):
            raise ValueError(
                f"{plan.cfg.name} has no self-attention KV state; the paged "
                "cache applies to attention decoder models")
        if prefix_cache and any(not e.paged for e in self._entries):
            raise ValueError(
                f"{plan.cfg.name} carries non-attention per-request state "
                "(recurrences or cross-attention K/V) that a token-prefix "
                "match cannot seed; prefix_cache requires a pure attention "
                "decoder")
        self.ledger = BlockLedger(self.num_blocks, n_slots, block_size,
                                  blocks_per_slot, prefix_cache=prefix_cache,
                                  min_match_ratio=min_match_ratio)
        self.pool = self.ledger.pool
        self.state, self.slot_axes = self._build()

    # -- construction --------------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        """Per-slot token capacity (block-table width x block size)."""
        return self.blocks_per_slot * self.block_size

    @property
    def slot_blocks(self) -> List[List[int]]:
        """Per-slot block chains (host view; shared blocks included)."""
        return self.ledger.chains

    def _build(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        att = self.cfg.attention
        dt = self.plan.prec.compute_dtype
        NB, bs, nblk = self.num_blocks, self.block_size, self.blocks_per_slot
        KV, Dh = att.n_kv_heads, att.head_dim
        dev = self.device
        state: Dict[str, Any] = {}
        axes: Dict[str, Any] = {}
        for e in self._entries:
            lead = (e.reps,) if e.nlead else ()
            ust = state.setdefault(e.ukey, {})
            uax = axes.setdefault(e.ukey, {})
            if e.paged:
                ust[e.skey] = {
                    "kp": torch.zeros(lead + (NB, bs, KV, Dh), dtype=dt,
                                      device=dev),
                    "vp": torch.zeros(lead + (NB, bs, KV, Dh), dtype=dt,
                                      device=dev),
                    "bt": torch.zeros(lead + (self.n_slots, nblk),
                                      dtype=torch.int32, device=dev),
                    "len": torch.zeros(lead + (self.n_slots,),
                                       dtype=torch.int32, device=dev),
                }
                uax[e.skey] = {"kp": -1, "vp": -1, "bt": e.nlead,
                               "len": e.nlead}
            else:
                # dense per-slot state (the lowering's init_state layout)
                shapes = _op_state_shapes(e.op, self.cfg, self.n_slots,
                                          self.plan.cache_len, dt)
                for suf, v in _mk_state(shapes, lead, dev).items():
                    ust[e.skey + suf] = v
                    uax[e.skey + suf] = e.nlead
        return state, axes

    def _paged(self):
        """(entry, its state dict) for every paged attention entry."""
        return [(e, self.state[e.ukey][e.skey]) for e in self._entries
                if e.paged]

    def _dense(self):
        """(entry, leaf key, its tensor) for every dense state leaf."""
        return [(e, e.skey + suf, self.state[e.ukey][e.skey + suf])
                for e in self._entries if not e.paged
                for suf in _op_state_shapes(e.op, self.cfg, 1, 1, None)]

    # -- accounting ----------------------------------------------------------
    def live_tokens(self) -> int:
        """Tokens currently resident across live slots (host view)."""
        return int(sum(self.ledger.lens))

    def pool_bytes(self) -> int:
        """Device bytes held by the K/V pools (all layers)."""
        return sum(st[k].numel() * st[k].element_size()
                   for _, st in self._paged() for k in ("kp", "vp"))

    def dense_bytes(self) -> int:
        """Device bytes held by the dense per-slot state (all layers)."""
        return sum(t.numel() * t.element_size() for _, _, t in self._dense())

    # -- prefix matching (scheduler admission hooks) -------------------------
    def match_and_lock(self, prompt: np.ndarray) -> Optional[PrefixMatch]:
        return self.ledger.match_and_lock(prompt)

    def unlock(self, match: PrefixMatch) -> None:
        self.ledger.unlock(match)

    def fresh_blocks_needed(self, total_budget: int,
                            match: Optional[PrefixMatch]) -> int:
        return self.ledger.fresh_blocks_needed(total_budget, match)

    # -- per-slot device table plumbing --------------------------------------
    def _set_tables(self, slot: int, table_row: np.ndarray,
                    length: int) -> None:
        self._set_tables_many({slot: (table_row, length)})

    def _set_tables_many(self, updates: Dict[int, Tuple[np.ndarray,
                                                        int]]) -> None:
        """Table/len resync of every slot in ``updates`` (slot -> (table
        row, length)): one indexed write per leaf and entry, in place (the
        JAX package scatters into donated copies under ``jit``)."""
        if not updates:
            return
        slots = list(updates)
        sl = torch.as_tensor(slots, dtype=torch.long).to(self.device)
        rows = torch.from_numpy(np.stack(
            [np.asarray(updates[s][0], np.int32) for s in slots])).to(
                self.device)
        lens = torch.as_tensor([updates[s][1] for s in slots],
                               dtype=torch.int32).to(self.device)
        for e, st in self._paged():
            if e.nlead:
                st["bt"][:, sl] = rows
                st["len"][:, sl] = lens
            else:
                st["bt"][sl] = rows
                st["len"][sl] = lens

    def _table_row(self, slot: int) -> np.ndarray:
        row = np.zeros(self.blocks_per_slot, np.int32)
        chain = self.ledger.chains[slot]
        row[:len(chain)] = chain
        return row

    # -- admit / evict -------------------------------------------------------
    def admit(self, slot: int, prompt_len: int, reserve_tokens: int,
              prefill_state: Dict[str, Any], row: int, pad: int,
              prompt: Optional[np.ndarray] = None) -> List[int]:
        """Move request ``row`` of a (rolling-layout) prefill state into
        ``slot``: allocate its block chain, copy the prompt K/V into pool
        blocks, point the slot's block-table row at the chain, set its
        decode position, and copy the dense (recurrent) state into the
        slot's row.  ``pad`` is the request's left-padding inside the
        bucketed prefill batch; ``reserve_tokens`` (>= prompt_len) is the
        chain capacity to allocate up front (prompt + generation budget),
        the admission-control quantity.  ``prompt`` (token ids) feeds the
        prefix index when prefix caching is on — the cold path;
        prefix-seeded admissions go through :meth:`admit_cached` instead.
        """
        if self.prefix_cache and prompt is None:
            raise ValueError("prefix caching needs the prompt token ids")
        toks = np.asarray(prompt, np.int32).reshape(-1) \
            if prompt is not None else np.zeros(prompt_len, np.int32)
        if toks.size != prompt_len:
            raise ValueError(f"prompt has {toks.size} tokens, "
                             f"prompt_len says {prompt_len}")
        blocks = self.ledger.admit(slot, toks, reserve_tokens, match=None)
        bs = self.block_size
        nblk_used = blocks_for_tokens(prompt_len, bs)
        bidx = torch.as_tensor(blocks[:nblk_used], dtype=torch.long).to(
            self.device)
        Lb = nblk_used * bs
        for e, st in self._paged():
            pst = prefill_state[e.ukey][e.skey]
            for pool_key, cache_key in (("kp", "k"), ("vp", "v")):
                src = pst[cache_key]               # lead+(Bp, C, KV, Dh)
                rowv = src[:, row] if e.nlead else src[row]
                # room for the tail block, then the prompt's Lb slots
                rowv = F.pad(rowv, (0, 0, 0, 0, 0, bs))
                seg = rowv.narrow(e.nlead, pad, Lb)
                seg = seg.reshape(seg.shape[:e.nlead] + (nblk_used, bs)
                                  + seg.shape[e.nlead + 1:])
                pool = st[pool_key]
                if e.nlead:
                    pool[:, bidx] = seg.to(pool.dtype)
                else:
                    pool[bidx] = seg.to(pool.dtype)
        for e, key, leaf in self._dense():
            src = prefill_state[e.ukey][key]
            if e.nlead:
                leaf[:, slot].copy_(src[:, row])
            else:
                leaf[slot].copy_(src[row])
        self._set_tables(slot, self._table_row(slot), prompt_len)
        # the whole prompt's K/V is resident: index its full blocks now
        self.ledger.register_prompt(slot)
        return blocks

    def admit_cached(self, slot: int, prompt: np.ndarray,
                     reserve_tokens: int, match: PrefixMatch) -> List[int]:
        """Prefix-cache hit admission: seed ``slot``'s block table from the
        matched (locked) blocks plus a fresh tail, set its decode position
        to ``match.covered``, and write *nothing* — the engine feeds the
        uncovered prompt tail through decode ticks (mid-sequence prefill;
        positions and the pool gather make it exact), sampling the first
        generated token from the last tail token's logits."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        chain = self.ledger.admit(slot, toks, reserve_tokens, match=match)
        self._set_tables(slot, self._table_row(slot), match.covered)
        return chain

    def admit_tail(self, slot: int, prompt: np.ndarray,
                   reserve_tokens: int) -> List[int]:
        """Chunked-prefill admission: allocate the slot's whole chain, point
        its block-table row at it, and write *nothing* — resident length 0.
        The engine drains the entire prompt through chunked catch-up ticks
        (``chunk_size`` tokens per tick, interleaved with ongoing decodes),
        sampling the first generated token from the last prompt token's
        logits, exactly like an uncovered prefix-cache tail with zero
        coverage."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        chain = self.ledger.admit(slot, toks, reserve_tokens, match=None,
                                  resident=0)
        self._set_tables(slot, self._table_row(slot), 0)
        return chain

    def register_prompt(self, slot: int) -> None:
        """Index the slot's fully-filled prompt blocks (the engine calls
        this when a prefix-seeded request finishes catching up)."""
        self.ledger.register_prompt(slot)

    # -- copy-on-write -------------------------------------------------------
    def prepare_decode(self, active_slots) -> int:
        """Fork every active slot whose next write would land in a shared
        block (refcount > 1): copy the block through the registry's
        ``copy_block`` kernel and repoint the slot's table row.  Returns the
        number of forks performed.  Must run before each decode tick —
        decode never writes a block with refcount > 1."""
        forks = 0
        for s in active_slots:
            if not self.ledger.chains[s]:
                continue
            if not self.ledger.needs_fork(s):
                continue
            ci, old, new = self.ledger.fork(s)
            self._device_fork(s, ci, old, new)
            forks += 1
        return forks

    def _device_fork(self, slot: int, chain_idx: int, old: int,
                     new: int) -> None:
        from repro_torch.kernels.registry import plan_kernel
        copy = plan_kernel(self.plan, "copy_block")
        for e, st in self._paged():
            if copy is not None:        # the K and V pools in one launch
                copy((st["kp"], st["vp"]), old, new)
            else:
                _copy_block_ref(st["kp"], old, new)
                _copy_block_ref(st["vp"], old, new)
            if e.nlead:
                st["bt"][:, slot, chain_idx] = new
            else:
                st["bt"][slot, chain_idx] = new

    # -- decode progress -----------------------------------------------------
    def note_decode_tick(self, active_slots, counts=None) -> None:
        """Mirror the device-side ``len`` increment for live slots (the
        device increments every row; only live slots count as live tokens).
        ``counts`` maps slot -> tokens written this tick (chunked catch-up
        rows advance by their chunk fill; plain decode rows by 1)."""
        for s in active_slots:
            self.ledger.note_write(s, 1 if counts is None else counts[s])

    # -- speculative windows -------------------------------------------------
    def spec_begin(self, slot: int) -> None:
        """Open a speculative window on ``slot`` (see
        :meth:`BlockLedger.spec_begin`).  Call *before* ``prepare_decode``
        so a COW fork triggered by the verify tick is logged inside the
        window."""
        self.ledger.spec_begin(slot)

    def spec_commit(self, slot: int, committed: int) -> int:
        """Close the window keeping ``committed`` tokens (see
        :meth:`spec_commit_many`)."""
        return self.spec_commit_many({slot: committed})

    def spec_commit_many(self, commits: Dict[int, int]) -> int:
        """Close every window in ``commits`` (slot -> committed count).  The
        ledger rolls back first; when anything changed — rejected writes
        leave the device-side ``len`` ahead of the committed length (the
        (B, k) cell advances it by the *fed* count), and an undone fork
        leaves the device block table pointing at the released copy — the
        slot's table row and length are rewritten from the ledger, all
        dirty slots in one batched update, so the next device-length-driven
        1-token tick writes at the committed position.  Rejected K/V behind
        the new length is garbage but unreachable: the verify mask only
        admits ``kpos <= qpos`` and later writes land on it first.  Returns
        the total rolled-back token count."""
        dirty: Dict[int, Tuple[np.ndarray, int]] = {}
        total = 0
        for slot, committed in commits.items():
            undos0 = self.ledger.spec_fork_undos
            rolled = self.ledger.spec_commit(slot, committed)
            total += rolled
            if rolled or self.ledger.spec_fork_undos != undos0:
                dirty[slot] = (self._table_row(slot),
                               self.ledger.lens[slot])
        self._set_tables_many(dirty)
        return total

    def evict(self, slot: int) -> int:
        """Free ``slot``'s block chain and park it on the trash block.
        Cached (indexed) blocks stay resident on the pool's LRU list until
        allocation pressure reclaims them.  Returns the number of blocks
        the slot referenced."""
        chain = self.ledger.release(slot)
        if not chain:
            return 0
        self._set_tables(slot, np.zeros(self.blocks_per_slot, np.int32), 0)
        return len(chain)


def _copy_block_ref(pool: torch.Tensor, src: int, dst: int) -> None:
    """The reference fork (the JAX package's ``copy_block_ref``), taken
    where the plan resolves ``copy_block`` to ``ref``: block ``dst`` of the
    block axis (-4) := block ``src``, in place."""
    pool[..., dst, :, :, :] = pool[..., src, :, :, :]


# ---------------------------------------------------------------------------
# batch-bucket slicing (shape-bucketed decode ticks)
# ---------------------------------------------------------------------------

def _tree_map(f, tree, *rest):
    return {k: _tree_map(f, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else f(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _bucket(x: torch.Tensor, ax: int, n: int) -> torch.Tensor:
    return x if ax < 0 or x.shape[ax] == n else x.narrow(ax, 0, n)


def slice_state(state: Dict[str, Any], slot_axes: Dict[str, Any],
                n: int) -> Dict[str, Any]:
    """First ``n`` slot rows of every slot-indexed leaf, as views (pool
    leaves pass through whole) — the decode tick's batch bucket.  The
    tick's in-place writes land in the full state's tensors."""
    return _tree_map(lambda x, ax: _bucket(x, ax, n), state, slot_axes)


def merge_state(full: Dict[str, Any], part: Dict[str, Any],
                slot_axes: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Check a bucketed decode tick's state back in over the full slot
    range: the tick wrote through the views :func:`slice_state` made, so
    the full state already holds its writes and is returned as it is (the
    JAX package concatenates the tick's new rows over the old).  A leaf
    that is no longer such a view — an op replaced a tensor instead of
    writing into it — would leave the engine's state stale, and raises."""
    def f(xf, xp, ax):
        dst = _bucket(xf, ax, n)
        if xp.data_ptr() != dst.data_ptr() or xp.shape != dst.shape:
            raise RuntimeError("merge_state: a decode tick replaced a state "
                               "tensor instead of writing it in place")
    _tree_map(f, full, part, slot_axes)
    return full
