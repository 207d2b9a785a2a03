"""The serving-state properties of ``tests/test_kvcache_properties.py``
(hypothesis), run against the port's host-side ledger:
``repro_torch.serving.kvcache.BlockLedger`` and
``repro_torch.serving.prefix.block_hashes``.

The same harness drives the ledger through random interleavings of admit
(match -> charge -> seed), decode ticks (fork-before-write), speculative
windows (fork -> write -> partial-acceptance rollback) and finish, and
``led.check()`` holds conservation, refcounts, chain validity and the
trash block after every step.  The two headline properties also drive the
JAX package's ledger through the same script and hold the port's state
(chains, spares, lengths, counters, free list, refcounts, LRU, index) to
it after every step, and the prefix-match property compares the match.

Each property runs under two fixed profiles (``derandomize=True``, so a
failure reproduces): ``tier1``, a few dozen examples, in the default
selection, and ``ci``, JAX's 500 examples, under ``-m slow``.  The
settings are given per test, because the JAX file loads its own profile
when it is collected.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving.kvcache import (BlockLedger,  # noqa: E402
                                         TRASH_BLOCK, blocks_for_tokens)
from repro_torch.serving.prefix import block_hashes  # noqa: E402
from test_torch_kvcache import _view  # noqa: E402

PROFILES = [
    pytest.param(settings(max_examples=40, derandomize=True, deadline=None),
                 id="tier1"),
    pytest.param(settings(max_examples=500, derandomize=True, deadline=None),
                 id="ci", marks=pytest.mark.slow),
]

BS = 4                 # block size
BPS = 6                # blocks per slot -> 24-token capacity
SLOTS = 3
MAX_NEW = 3


def _prompt(seed: int, length: int) -> np.ndarray:
    # a 2-token alphabet makes identical prefixes (and hence index hits,
    # shared partial tails and COW forks) common instead of vanishing
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2, length).astype(np.int32)


class Harness:
    """Drives one ledger (``mod.BlockLedger``) through the engine's
    host-side discipline, as the JAX file's harness does."""

    def __init__(self, num_blocks: int, prefix_cache: bool, mod=tkv):
        self.led = mod.BlockLedger(num_blocks, SLOTS, BS, BPS,
                                   prefix_cache=prefix_cache)
        self.prefix_cache = prefix_cache
        # per live slot: target total tokens (prompt + generated budget)
        self.target = [0] * SLOTS
        self.prompt_len = [0] * SLOTS
        self.forks_seen = 0

    def admit(self, seed: int, length: int, max_new: int) -> bool:
        free = [s for s in range(SLOTS) if not self.led.chains[s]]
        if not free:
            return False
        slot = free[0]
        prompt = _prompt(seed, length)
        budget = length + max_new
        if budget > BPS * BS:
            return False
        match = self.led.match_and_lock(prompt) if self.prefix_cache else None
        need = self.led.fresh_blocks_needed(budget, match)
        if need > self.led.pool.free_blocks:
            if match is not None:
                self.led.unlock(match)
            return False
        self.led.admit(slot, prompt, budget, match=match)
        self.target[slot] = budget
        self.prompt_len[slot] = length
        if match is None:
            # cold path: the prefill scatter makes the whole prompt resident
            self.led.register_prompt(slot)
        return True

    def _fork(self, s: int) -> None:
        if self.led.needs_fork(s):
            ci, old, new = self.led.fork(s)
            assert old != new and new != TRASH_BLOCK
            self.forks_seen += 1

    def tick(self) -> None:
        """One decode tick over every live slot: COW forks first (decode
        never writes a block with refcount > 1), then the write."""
        for s in range(SLOTS):
            if not self.led.chains[s] or \
                    self.led.lens[s] >= self.target[s] - 1:
                continue
            self._fork(s)
            blk = self.led.chains[s][self.led.lens[s] // BS]
            assert self.led.pool.refcount(blk) == 1 or not self.prefix_cache, \
                "decode would write a shared block"
            self.led.note_write(s)
            if self.led.lens[s] == self.prompt_len[s]:
                # catch-up complete: the prompt is fully resident
                self.led.register_prompt(s)

    def spec_tick(self, j: int, commit_sel: int) -> None:
        """One speculative verify window over every live slot: open it,
        fork before each write, write up to ``j`` tokens, commit a prefix
        chosen by ``commit_sel`` and roll the rest back; the prompt is
        registered only from committed length."""
        for s in range(SLOTS):
            if not self.led.chains[s]:
                continue
            fed = min(j, self.target[s] - 1 - self.led.lens[s])
            if fed < 1:
                continue
            self.led.spec_begin(s)
            for _ in range(fed):
                self._fork(s)
                self.led.note_write(s)
            self.led.spec_commit(s, commit_sel % (fed + 1))
            if not self.led._registered[s] \
                    and self.led.lens[s] >= self.prompt_len[s]:
                self.led.register_prompt(s)

    def finish(self, which: int) -> None:
        live = [s for s in range(SLOTS) if self.led.chains[s]]
        if not live:
            return
        slot = live[which % len(live)]
        self.led.release(slot)
        self.target[slot] = self.prompt_len[slot] = 0

    def step(self, op):
        kind = op[0]
        out = None
        if kind == 0:
            out = self.admit(seed=op[1], length=op[2], max_new=op[3])
        elif kind == 1:
            self.tick()
        elif kind == 2:
            self.finish(op[1])
        else:
            self.spec_tick(op[1], op[2])
        self.led.check()
        return out


OPS = st.one_of(
    st.tuples(st.just(0), st.integers(0, 7), st.integers(1, 20),
              st.integers(1, MAX_NEW)),
    st.tuples(st.just(1)),
    st.tuples(st.just(2), st.integers(0, SLOTS - 1)),
    st.tuples(st.just(3), st.integers(1, MAX_NEW), st.integers(0, 10)),
)
SCRIPTS = st.lists(OPS, min_size=1, max_size=40)
POOLS = st.integers(8, 1 + SLOTS * BPS)


def _paired(num_blocks, prefix_cache, script, each=None):
    """The port's harness and JAX's through ``script``: the same admission
    decisions, forks and ledger state after every step."""
    hs = [Harness(num_blocks, prefix_cache, mod) for mod in (tkv, jkv)]
    for op in script:
        assert hs[0].step(op) == hs[1].step(op), op
        assert _view(hs[0].led) == _view(hs[1].led), op
        assert hs[0].forks_seen == hs[1].forks_seen
        if each is not None:
            each(hs[0])
    return hs[0]


@pytest.mark.parametrize("profile", PROFILES)
def test_interleavings_preserve_invariants_prefix_on(profile):
    """The headline property: random admit/decode/finish interleavings with
    prefix caching + COW sharing never break conservation, refcounts, chain
    validity or the trash block, and the port decides as JAX does."""
    @profile
    @given(script=SCRIPTS, num_blocks=POOLS)
    def prop(script, num_blocks):
        h = _paired(num_blocks, True, script)
        # drain: everything releases cleanly and nothing leaks
        for s in range(SLOTS):
            if h.led.chains[s]:
                h.led.release(s)
        h.led.check()
        assert h.led.pool.used_blocks == 0
    prop()


@pytest.mark.parametrize("profile", PROFILES)
def test_interleavings_preserve_invariants_prefix_off(profile):
    """Sharing disabled: the refcounting pool degrades to the plain
    free-list allocator (refcounts all 1, nothing cached, no fork)."""
    def plain(h):
        assert h.led.pool.cached_blocks == 0
        assert all(h.led.pool.refcount(b) == 1
                   for chain in h.led.chains for b in chain)

    @profile
    @given(script=SCRIPTS, num_blocks=POOLS)
    def prop(script, num_blocks):
        assert _paired(num_blocks, False, script, plain).forks_seen == 0
    prop()


@pytest.mark.parametrize("profile", PROFILES)
def test_trash_block_never_allocated_or_refcounted(profile):
    @profile
    @given(script=SCRIPTS)
    def prop(script):
        h = Harness(1 + SLOTS * BPS, prefix_cache=True)
        for op in script:
            h.step(op)
            assert h.led.pool.refcount(TRASH_BLOCK) == 0
            assert not h.led.pool.is_cached(TRASH_BLOCK)
            for chain in h.led.chains:
                assert TRASH_BLOCK not in chain
    prop()


@pytest.mark.parametrize("profile", PROFILES)
def test_lru_eviction_only_reclaims_unreferenced(profile):
    """Under a tight pool, cached blocks are reclaimed, but only blocks no
    chain or spare references, and their index entries go at reclaim time
    (``led.check()`` sees no index entry at a free block afterwards)."""
    @profile
    @given(script=SCRIPTS, num_blocks=st.integers(8, 14))
    def prop(script, num_blocks):
        h = Harness(num_blocks, prefix_cache=True)

        def hook(b):
            assert h.led.pool.refcount(b) == 0, "reclaimed a referenced block"
            assert all(b not in chain for chain in h.led.chains), \
                "reclaimed a chained block"
            assert b not in h.led.spares, "reclaimed a COW spare"
            h.led._on_reclaim(b)     # the ledger's own hook: drop the index

        h.led.pool.on_cache_evict = hook
        for op in script:
            h.step(op)
        h.led.check()
    prop()


@pytest.mark.parametrize("profile", PROFILES)
def test_match_never_covers_whole_prompt(profile):
    """After a cold request is served and evicted, re-matching its exact
    prompt hits, leaves >= 1 token to recompute and locks every matched
    block; JAX's ledger matches the same blocks."""
    @profile
    @given(seed=st.integers(0, 50), length=st.integers(2, BPS * BS - MAX_NEW))
    def prop(seed, length):
        matches = []
        for mod in (tkv, jkv):
            h = Harness(1 + SLOTS * BPS, True, mod)
            assert h.admit(seed, length, MAX_NEW)
            for _ in range(MAX_NEW + length):
                h.tick()
            h.finish(0)
            match = h.led.match_and_lock(_prompt(seed, length))
            assert match is not None, "identical prompt must hit"
            assert match.covered == length - 1
            assert match.covered_raw == length
            assert match.needs_cow_spare
            assert all(h.led.pool.refcount(b) == 1 for b in match.blocks)
            matches.append((list(match.blocks), match.covered))
            h.led.unlock(match)
            h.led.check()
        assert matches[0] == matches[1]
    prop()


@pytest.mark.parametrize("profile", PROFILES)
def test_block_hash_chain_is_prefix_sensitive(profile):
    """Chained hashes: equal digests imply equal prefixes; perturbing any
    earlier token changes every later digest."""
    @profile
    @given(seed=st.integers(0, 20), cut=st.integers(1, 15))
    def prop(seed, cut):
        prompt = _prompt(seed, 16)
        other = prompt.copy()
        other[cut % prompt.size] ^= 1
        flip_block = (cut % prompt.size) // BS
        for i, ((da, ea), (db, eb)) in enumerate(
                zip(block_hashes(prompt, BS), block_hashes(other, BS))):
            assert ea == eb
            assert (da == db) == (i < flip_block)
    prop()


def test_blocks_for_tokens_matches_charge():
    led = BlockLedger(20, 2, BS, BPS, prefix_cache=False)
    for budget in range(1, BPS * BS + 1):
        assert led.fresh_blocks_needed(budget, None) == \
            blocks_for_tokens(budget, BS)
