"""Prefix-cache index: content-hashed prompt blocks over the paged KV pool.

Shared prompt prefixes (system prompts, few-shot headers, replayed chats)
recompute and re-store identical K/V across requests.  The index maps
*chained block hashes* of prompt token ids to pool blocks so a new request
can seed its block table from blocks another request already filled — the
serving-side instance of the memory-hierarchy reuse the FPGA-CNN flows
exploit (DNNVM's inter-layer reuse, the survey's on-chip caching taxonomy).

Hash scheme: block ``i`` of a prompt hashes ``blake2b(parent_digest ||
tokens[i*bs:(i+1)*bs])`` — the chain makes a digest identify *the whole
prefix up to and including this block*, so a flat dict behaves like a radix
trie keyed by block-sized edges.  Fully-filled blocks are indexed as soon as
their K/V is resident; the partially-filled tail block is indexed only when
its owner slot is evicted (its owner keeps writing generated tokens into it
while live, and an index entry must never race those writes — see
``BlockLedger`` for the copy-on-write rule on the sharing side).

The index holds no references: entries point at blocks that are either live
(refcounted by slots) or parked on the pool's LRU list, and the pool drops
entries through ``drop_block`` when allocation pressure reclaims a parked
block.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

BlockHash = bytes


def block_hashes(prompt: np.ndarray, block_size: int
                 ) -> List[Tuple[BlockHash, int]]:
    """Chained digests of ``prompt`` split into ``block_size`` runs.

    Returns one ``(digest, end)`` pair per block — ``end`` is the number of
    prompt tokens covered once this block matches (the last pair may cover a
    partial block).  Digests chain: equal digests imply equal *prefixes*,
    not merely equal blocks.
    """
    toks = np.asarray(prompt, np.int32).reshape(-1)
    out: List[Tuple[BlockHash, int]] = []
    parent = b""
    for start in range(0, toks.size, block_size):
        seg = toks[start:start + block_size]
        d = hashlib.blake2b(parent + seg.tobytes(), digest_size=16).digest()
        out.append((d, start + int(seg.size)))
        parent = d
    return out


class PrefixIndex:
    """hash -> pool block, with a reverse map so a reclaimed block can drop
    every entry pointing at it."""

    def __init__(self):
        self._map: Dict[BlockHash, int] = {}
        self._by_block: Dict[int, List[BlockHash]] = {}

    def __len__(self) -> int:
        return len(self._map)

    def get(self, h: BlockHash) -> Optional[int]:
        return self._map.get(h)

    def insert(self, h: BlockHash, block: int) -> None:
        """First writer wins: an existing entry for ``h`` is kept (its block
        already holds identical content and may be shared)."""
        if h in self._map:
            return
        self._map[h] = block
        self._by_block.setdefault(block, []).append(h)

    def drop_block(self, block: int) -> int:
        """Forget every hash pointing at ``block`` (the pool reclaimed it).
        Returns the number of entries dropped."""
        hashes = self._by_block.pop(block, [])
        for h in hashes:
            self._map.pop(h, None)
        return len(hashes)

    def blocks(self) -> Iterable[int]:
        return self._by_block.keys()

    def items(self) -> Iterable[Tuple[BlockHash, int]]:
        return self._map.items()
