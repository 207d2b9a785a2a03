"""Deterministic synthetic data pipeline with host sharding + straggler hooks.

The JAX package's ``data/pipeline.py``, copied: it is numpy only, and the
port imports nothing of that package.  Batches stay numpy arrays; the
trainer moves them to the model's device.

Each host materializes only its shard of the global batch, derived from a
counter-based PRNG keyed on (seed, step, host) — restart-safe (resuming at
step k regenerates identical batches; no data-state checkpoint needed) and
elastic (a different host count re-partitions the same global stream).

The straggler hook models large-cluster input stalls: if a host's shard
misses its deadline the loader substitutes the previous step's shard
(bounded staleness) instead of stalling the step — mitigation is tested by
injecting artificial delays.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    deadline_s: Optional[float] = None       # straggler deadline
    # test hook: artificial per-step delay in seconds (callable of step)
    delay_fn: Optional[Callable[[int], float]] = None


class SyntheticLM:
    """Markov-ish synthetic token stream: next token depends on the previous
    one (so the loss has learnable structure for convergence tests)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._last: Optional[Dict[str, np.ndarray]] = None
        self.stale_steps = 0

    def _gen(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        B, S, V = self.local_batch, c.seq_len, c.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.integers(0, V, (B, S))
        keep = rng.random((B, S)) < 0.75
        for t in range(S):
            nxt = (toks[:, t] * 31 + 7) % V       # deterministic transition
            toks[:, t + 1] = np.where(keep[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def get(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        t0 = time.monotonic()
        if c.delay_fn:
            time.sleep(c.delay_fn(step))
        batch = self._gen(step)
        if (c.deadline_s is not None and self._last is not None
                and time.monotonic() - t0 > c.deadline_s):
            # straggler: bounded-staleness substitution
            self.stale_steps += 1
            batch = self._last
        self._last = batch
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.get(step)
            step += 1


class SyntheticImages:
    def __init__(self, cfg: DataConfig, image_size: int, channels: int,
                 n_classes: int):
        self.cfg = cfg
        self.image_size, self.channels, self.n_classes = (
            image_size, channels, n_classes)
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def get(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        B = self.local_batch
        labels = rng.integers(0, self.n_classes, B).astype(np.int32)
        # class-dependent mean so the task is learnable
        base = (labels[:, None, None, None] / self.n_classes - 0.5)
        imgs = (rng.standard_normal(
            (B, self.image_size, self.image_size, self.channels)) * 0.5
            + base).astype(np.float32)
        return {"images": imgs, "labels": labels}
