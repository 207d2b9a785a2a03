"""Continuous-batching scheduler: request queue, admission control, slots.

The scheduler is pure bookkeeping — no jax, no model.  It owns the FIFO
request queue and the slot table; each engine tick asks it which requests to
admit (``admissions``: a free slot *and* enough free KV blocks for
prompt + generation budget), tells it which tokens were decoded (``step``),
and collects finished requests (``finished`` → evict, freeing the slot and
its blocks for the next admission).  Finished sequences are evicted and new
prompts prefilled into the freed slots *between decode ticks* — continuous
batching, not static batching.

Shape bucketing lives here too (:func:`bucket_for`): prompt lengths and
batch sizes are rounded up to a fixed ladder so every tick reuses a jitted
program instead of retracing (the serving analogue of the paper's fixed
accelerator shapes).

Prefix caching hooks in at admission: when the engine hands the scheduler a
``prefix`` object (the paged cache), each queued prompt is matched against
the block index *before* the block charge is computed — a request is charged
only for its uncovered blocks (plus one copy-on-write spare when its first
write lands inside a shared block), and the matched blocks are locked
(refcounted) the moment the admission decision is made, so an eviction
racing the same tick can never reclaim them.  A prefix-seeded slot carries
``pending`` — the uncovered prompt tail the engine feeds through decode
ticks (mid-sequence prefill) before sampling begins.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.kvcache import BlockPool, blocks_for_tokens


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class Request:
    rid: Any
    prompt: np.ndarray                 # 1-D int32 token ids
    max_new_tokens: int = 16
    stop_token: Optional[int] = None
    # per-request speculative-decoding toggle: None defers to the engine
    # default (on when EngineConfig.speculation is set); False pins this
    # request to plain 1-token decode rows even in a speculating engine
    speculate: Optional[bool] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >=1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_budget(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclass
class RequestResult:
    rid: Any
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = ""            # "length" | "stop"
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    # filled only under EngineConfig.capture_logits: the logits row each
    # recorded token was sampled from (parity/debug tooling)
    logits: List[Any] = field(default_factory=list)
    # speculative decoding: drafts fed through verify ticks for this
    # request, and how many were accepted (zeros when speculation is off)
    tokens_drafted: int = 0
    tokens_accepted: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def acceptance_rate(self) -> float:
        return self.tokens_accepted / self.tokens_drafted \
            if self.tokens_drafted else 0.0

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> float:
        """Time to first token (submit -> first sampled token)."""
        return self.t_first_token - self.t_submit


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending).  Raises when n overflows
    the ladder — admission control must have rejected such a request."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


# ---------------------------------------------------------------------------
# slots
# ---------------------------------------------------------------------------

@dataclass
class Slot:
    index: int
    request: Optional[Request] = None
    result: Optional[RequestResult] = None
    pos: int = 0                       # current decode position (tokens cached)
    last_token: int = 0
    served: int = 0                    # lifetime occupants (refill counting)
    pending: List[int] = field(default_factory=list)  # uncovered prompt tail
    # submission-order serial of the occupant: the per-request rng-stream
    # index speculative sampling folds into (stable across engine configs,
    # so sampled speculative output is replay-comparable)
    serial: int = -1

    @property
    def free(self) -> bool:
        return self.request is None


@dataclass
class Admission:
    slot: int
    request: Request
    reserve_tokens: int
    covered: int = 0                   # prompt tokens seeded from the cache
    match: Any = None                  # locked PrefixMatch (engine consumes)
    chunked: bool = False              # cold prompt drains through chunk ticks


class Scheduler:
    """Slot-based continuous batching over a block-pool budget."""

    def __init__(self, n_slots: int, block_size: int, pool: BlockPool, *,
                 max_seq_len: int, clock: Callable[[], float] = time.monotonic,
                 prefix: Any = None, chunk_prefill: bool = False):
        self.n_slots = n_slots
        self.block_size = block_size
        self.pool = pool
        self.max_seq_len = max_seq_len
        self.clock = clock
        # chunked-prefill admission: cold prompts skip the monolithic
        # bucketed prefill batch and instead drain their whole prompt
        # through chunked catch-up ticks, interleaved with ongoing decodes
        # (the engine advances them chunk_size tokens per tick)
        self.chunk_prefill = chunk_prefill
        # prefix-cache hooks (duck-typed: the PagedKVCache / BlockLedger):
        # match_and_lock / unlock / fresh_blocks_needed
        self.prefix = prefix
        # queue entries carry their own submit timestamp and submission
        # serial (the same Request object may be submitted more than once)
        self.queue: Deque[Tuple[Request, float, int]] = deque()
        self.slots = [Slot(i) for i in range(n_slots)]
        self.results: List[RequestResult] = []
        # counters
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_refills = 0             # admissions into a previously-used slot

    # -- queue ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.total_budget > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={req.total_budget} "
                f"exceeds max_seq_len={self.max_seq_len}")
        self.queue.append((req, self.clock(), self.n_submitted))
        self.n_submitted += 1

    def has_work(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)

    def publish_metrics(self, reg: "MetricsRegistry") -> None:
        """Publish the scheduling counters under their dotted names."""
        reg.counter("serving.sched.submitted").inc(self.n_submitted)
        reg.counter("serving.sched.admissions").inc(self.n_admitted)
        reg.counter("serving.sched.evictions").inc(self.n_evicted)
        reg.counter("serving.sched.refills").inc(self.n_refills)

    @property
    def active_slots(self) -> List[int]:
        return [s.index for s in self.slots if not s.free]

    @property
    def high_water(self) -> int:
        """1 + highest occupied slot index (the decode batch must cover it)."""
        occ = self.active_slots
        return (occ[-1] + 1) if occ else 0

    # -- admission -----------------------------------------------------------
    def admissions(self) -> List[Admission]:
        """Pop requests into free slots while admission control passes:
        a free slot AND enough free pool blocks for the request's whole
        budget (prompt + max_new) — with prefix caching, only the blocks the
        cache doesn't already hold.  FIFO — a blocked head blocks the queue
        (no starvation of large requests).  Matched blocks are locked here,
        at decision time, so same-tick allocation pressure cannot evict
        them before the engine seeds the slot."""
        out: List[Admission] = []
        free = [s for s in self.slots if s.free]
        reserved = 0                   # blocks promised, not yet allocated
        while self.queue and free:
            req, t_submit, serial = self.queue[0]
            match = None
            if self.prefix is not None:
                match = self.prefix.match_and_lock(req.prompt)
                need = self.prefix.fresh_blocks_needed(req.total_budget,
                                                       match)
                if match is not None and \
                        need > self.pool.free_blocks - reserved:
                    # a hit must never make a request *less* admittable
                    # than cold (locking matched blocks removes them from
                    # the allocatable count and the COW spare adds a
                    # block): drop the match and retry as a cold admission
                    self.prefix.unlock(match)
                    match = None
                    need = blocks_for_tokens(req.total_budget,
                                             self.block_size)
            else:
                need = blocks_for_tokens(req.total_budget, self.block_size)
            if need > self.pool.free_blocks - reserved:
                break
            self.queue.popleft()
            reserved += need
            slot = free.pop(0)
            if slot.served > 0:
                self.n_refills += 1
            slot.served += 1
            slot.request = req
            slot.serial = serial
            covered = match.covered if match is not None else 0
            chunked = self.chunk_prefill and not covered
            if chunked:
                # cold prompt under chunked prefill: the whole prompt is the
                # pending tail, drained chunk_size tokens per decode tick
                slot.pos = 0
                slot.pending = req.prompt.tolist()
            else:
                slot.pos = covered if covered else req.prompt_len
                slot.pending = req.prompt[covered:].tolist() if covered else []
            slot.result = RequestResult(
                rid=req.rid, prompt_len=req.prompt_len,
                t_submit=t_submit, t_admit=self.clock())
            self.n_admitted += 1
            out.append(Admission(slot.index, req, req.total_budget,
                                 covered=covered, match=match,
                                 chunked=chunked))
        return out

    # -- decode progress -----------------------------------------------------
    def note_catchup(self, slot_idx: int, n: int = 1) -> None:
        """``n`` uncovered prompt-tail tokens were fed through a decode tick
        (mid-sequence prefill, chunked when n > 1): consume them and advance
        the position without recording generated tokens."""
        slot = self.slots[slot_idx]
        assert len(slot.pending) >= n, \
            f"slot {slot_idx} has {len(slot.pending)} pending, asked {n}"
        del slot.pending[:n]
        slot.pos += n

    def record_token(self, slot_idx: int, token: int, *,
                     first: bool = False) -> None:
        slot = self.slots[slot_idx]
        assert slot.request is not None and slot.result is not None
        slot.result.tokens.append(int(token))
        slot.last_token = int(token)
        if first:
            slot.result.t_first_token = self.clock()
        else:
            slot.pos += 1

    def finished(self) -> List[int]:
        """Slots whose occupant is done (budget reached or stop token)."""
        done = []
        for s in self.slots:
            if s.free:
                continue
            req, res = s.request, s.result
            if req.stop_token is not None and res.tokens and \
                    res.tokens[-1] == req.stop_token:
                res.finish_reason = "stop"
                done.append(s.index)
            elif res.n_generated >= req.max_new_tokens:
                res.finish_reason = "length"
                done.append(s.index)
        return done

    def evict(self, slot_idx: int) -> RequestResult:
        """Release the slot (the engine frees its KV blocks through the
        cache) and bank the result."""
        slot = self.slots[slot_idx]
        assert slot.result is not None
        slot.result.t_done = self.clock()
        res = slot.result
        self.results.append(res)
        slot.request = None
        slot.result = None
        slot.pos = 0
        slot.last_token = 0
        slot.pending = []
        slot.serial = -1
        self.n_evicted += 1
        return res


# ---------------------------------------------------------------------------
# request sources (CLI replay + benchmarks)
# ---------------------------------------------------------------------------

def synthetic_requests(n: int, vocab_size: int, *, prompt_len: int = 8,
                       max_new_tokens: int = 8, seed: int = 0,
                       vary_lens: bool = True) -> List[Request]:
    """Deterministic random request batch (benchmarks, tests, CI replay)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        pl = prompt_len if not vary_lens else \
            int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
        out.append(Request(
            rid=f"req{i}",
            prompt=rng.randint(0, vocab_size, pl).astype(np.int32),
            max_new_tokens=max_new_tokens))
    return out


def shared_prefix_requests(n: int, vocab_size: int, *, prefix_len: int = 24,
                           tail_len: int = 8, max_new_tokens: int = 8,
                           seed: int = 0) -> List[Request]:
    """``n`` requests sharing one random system prompt of ``prefix_len``
    tokens, each with its own random ``tail_len``-token tail — the
    prefix-cache benchmark/test workload (every request after the first can
    seed ``prefix_len`` tokens from the block index)."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab_size, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(0, vocab_size, tail_len).astype(np.int32)
        out.append(Request(rid=f"sp{i}",
                           prompt=np.concatenate([system, tail]),
                           max_new_tokens=max_new_tokens))
    return out


def load_requests_jsonl(path: str, vocab_size: int) -> List[Request]:
    """One request per line: ``{"id": ..., "prompt": [ids...]}`` or
    ``{"prompt_len": N, "seed": S}`` (synthetic prompt), plus optional
    ``max_new_tokens`` / ``stop_token``."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "prompt" in d:
                prompt = np.asarray(d["prompt"], np.int32)
                if prompt.size and (prompt.min() < 0
                                    or prompt.max() >= vocab_size):
                    raise ValueError(
                        f"{path} line {i}: prompt token ids must be in "
                        f"[0, {vocab_size}); got "
                        f"[{prompt.min()}, {prompt.max()}]")
            else:
                rng = np.random.RandomState(int(d.get("seed", i)))
                prompt = rng.randint(0, vocab_size,
                                     int(d["prompt_len"])).astype(np.int32)
            out.append(Request(
                rid=d.get("id", f"line{i}"), prompt=prompt,
                max_new_tokens=int(d.get("max_new_tokens", 16)),
                stop_token=d.get("stop_token")))
    return out
