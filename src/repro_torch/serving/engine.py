"""Serving engine: continuous batching over a paged KV-cache.

The Engine is the serving-side consumer of
:class:`repro_torch.flow.CompiledModel` (the compiled model owns the
prefill/decode stages; the paper's autorun kernels are the reason the host
does nothing between tokens beyond sampling).  This is the PyTorch port of
the JAX package's ``serving/engine.py``: the same loop, the same metrics and
the same ``host_syncs`` count (one device-to-host read per prefill sample,
per tick sample and per decode segment).  On top of it the Engine adds the production loop:

* ``run(requests)`` — continuous batching: a FIFO queue feeds ``max_batch``
  slots; finished sequences are evicted and new prompts prefilled into the
  freed slots between decode ticks (``serving/scheduler.py``), with KV state
  held in a paged block pool (``serving/kvcache.py``) so memory scales with
  live tokens;
* shape bucketing — prompt lengths and batch sizes round up to a fixed
  ladder (the JAX package's jit cache; in the port, a bounded set of
  shapes the kernels see);
* per-request latency / throughput metrics, surfaced in ``describe()``;
* ``generate`` / ``generate_fori`` — the single-batch rolling-cache paths,
  unchanged.

Bucketed prefill left-pads prompts and threads explicit per-row positions
through the model (``batch["positions"]``); padded rows carry negative
positions, which both attention paths mask out (the Pallas flash kernel's
mask is positional too, so bucketed prefill is exact on either backend;
decode is position-driven everywhere).

Two perf paths sit on top of the basic tick loop, both gated to stay
byte-identical to it:

* **chunked prefill** (``chunk_size`` / ``chunked_prefill``) — slots
  catching up on a prompt tail (prefix-cache hits, and with
  ``chunked_prefill`` every cold prompt) advance ``chunk_size`` tokens per
  tick through a ``(B, k)`` catch-up cell, interleaved with ongoing decodes
  in the same tick, instead of stalling the batch one token at a time;
* **host-free decode segments** (``fori_seg``) — steady-state stretches
  with no scheduling events (no admissions pending in a slot, no tail
  catch-up, every slot at least ``fori_seg`` tokens from its budget) run as
  one queued segment with on-device sampling
  (``CompiledModel.decode_segment``): one host round-trip per segment
  instead of per token.  The loop falls back to per-tick host
  stepping whenever admit/evict/COW/finish bookkeeping needs the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.distributed.meshspec import MeshSpec
from repro_torch.distributed.sharding import full_tensor
from repro_torch.flow import CompiledModel
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.kvcache import (PagedKVCache, blocks_for_tokens,
                                         merge_state, needs_exact_prompts,
                                         slice_state)
from repro_torch.serving.scheduler import (Request, RequestResult,
                                           Scheduler, bucket_for)
from repro_torch.serving.speculation import sample_targets


def _pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


@dataclass
class EngineConfig:
    """Serving-policy knobs: sampling, the slot/shape envelope, and the
    paged KV-pool geometry.  Validated at construction; bucket ladders
    default to powers of two capped by the envelope."""
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0
    # serving envelope
    max_batch: int = 4                # decode slots (continuous batching)
    max_seq_len: int = 128            # per-request prompt + generation cap
    batch_buckets: Optional[Tuple[int, ...]] = None
    prompt_buckets: Optional[Tuple[int, ...]] = None
    # paged KV pool
    block_size: int = 16
    num_blocks: Optional[int] = None  # pool size; None = full provisioning
    # prefix caching (shared prompt blocks, copy-on-write); a match below
    # min_ratio coverage is treated as a miss — the uncovered tail catches
    # up one token per decode tick, so marginal hits would trade one
    # batched prefill for a long sequential tail
    prefix_cache: bool = False
    prefix_cache_min_ratio: float = 0.5
    # chunked prefill: slots catching up on a prompt tail advance
    # chunk_size tokens per decode tick through a (B, k) cell; with
    # chunked_prefill on, cold prompts skip the monolithic prefill batch
    # entirely and drain the same way (vLLM-style).  chunk_buckets is the
    # per-tick chunk ladder (rung 1 = plain decode tick).
    chunk_size: int = 1
    chunked_prefill: bool = False
    chunk_buckets: Optional[Tuple[int, ...]] = None
    # host-free decode: run fori_seg decode ticks as one on-device
    # fori_loop (sampling in-loop) when no scheduling event can occur
    # within the segment; 0 disables
    fori_seg: int = 0
    # speculative decoding: a drafter proposes up to draft_k continuation
    # tokens per slot per tick; the engine verifies them in one
    # (B, draft_k+1) cell, commits the accepted prefix plus one target
    # token, and rolls the rest back through the ledger.  Exact: greedy
    # output is byte-identical to the 1-token loop, sampled output is
    # drafter-invariant (per-request rng streams).  Accepts a
    # SpeculationConfig or a spec string ("ngram:4" | "draft:<cfg>:4" |
    # "null:2" | "off"); None disables.  Mutually exclusive with fori_seg
    # (S307): acceptance is decided on the host every tick.
    speculation: Optional[Any] = None
    # debugging/parity: keep the sampled-step logits on each RequestResult
    capture_logits: bool = False
    # observability: record a per-tick span timeline (phase, batch bucket,
    # queue depth, pool occupancy, host-sync count) into the engine's
    # Tracer ring buffer — export with launch/serve.py --trace or
    # Engine.tracer.to_chrome().  Off by default; the disabled path is one
    # boolean check per span site, and outputs are byte-identical either
    # way (tracing never touches sampling, scheduling, or device state).
    trace: bool = False
    trace_max_events: int = 65536

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >=1, got {self.max_batch}")
        if self.max_seq_len < 1:
            raise ValueError(
                f"max_seq_len must be >=1, got {self.max_seq_len}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >=1, got {self.block_size}")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 <= self.prefix_cache_min_ratio <= 1.0:
            raise ValueError("prefix_cache_min_ratio must be in [0, 1]")
        # the invariants below are the serving rules S301-S307: each lives
        # once in repro_torch.analysis.rules and is raised here
        from repro_torch.analysis import rules as _rules

        def _check(msg):
            if msg is not None:
                raise ValueError(msg)

        _check(_rules.chunk_in_range(self.chunk_size, self.max_seq_len))
        _check(_rules.fori_seg_valid(self.fori_seg))
        if isinstance(self.speculation, str):
            from repro_torch.serving.speculation import SpeculationConfig
            self.speculation = SpeculationConfig.parse(self.speculation)
        if self.speculation is not None:
            sp = self.speculation
            _check(_rules.speculation_valid(sp.kind, sp.draft_k, sp.draft_cfg,
                                            self.max_seq_len, self.fori_seg))
        if self.chunk_buckets is None:
            self.chunk_buckets = (1,) if self.chunk_size == 1 \
                else (1, self.chunk_size)
        else:
            self.chunk_buckets = tuple(sorted(set(
                int(b) for b in self.chunk_buckets)))
            _check(_rules.chunk_ladder(self.chunk_buckets, self.chunk_size))
        if self.batch_buckets is None:
            self.batch_buckets = _pow2_ladder(1, self.max_batch)
        else:
            self.batch_buckets = tuple(sorted(set(int(b)
                                                  for b in self.batch_buckets)))
            _check(_rules.batch_ladder(self.batch_buckets, self.max_batch))
        if self.prompt_buckets is None:
            self.prompt_buckets = _pow2_ladder(
                min(max(8, self.block_size), self.max_seq_len),
                self.max_seq_len)
        else:
            self.prompt_buckets = tuple(sorted(set(int(b)
                                                   for b in self.prompt_buckets)))
            _check(_rules.prompt_ladder(self.prompt_buckets,
                                        self.max_seq_len))
            if self.prompt_buckets[-1] < self.max_seq_len:
                self.prompt_buckets += (self.max_seq_len,)
        # the paged pool packs prompt K/V block-by-block and the prefix
        # index hashes block-aligned runs: every prompt-bucket rung (and
        # hence max_seq_len, the final rung) must be a whole number of
        # blocks, not just the envelope
        _check(_rules.block_divides_buckets(self.block_size,
                                            self.prompt_buckets))

    @property
    def blocks_per_slot(self) -> int:
        return blocks_for_tokens(self.max_seq_len, self.block_size)

    @property
    def tick_buckets(self) -> Tuple[int, ...]:
        """Per-tick column ladder for step 2b: the chunk ladder, plus the
        ``draft_k + 1`` verify-cell rung when speculation is on (spec rows
        and catch-up rows bucket through the same jitted (B, k) cells)."""
        if self.speculation is None:
            return self.chunk_buckets
        return tuple(sorted({*self.chunk_buckets, 1,
                             self.speculation.draft_k + 1}))


@dataclass
class RunReport:
    """Engine.run outcome: per-request results plus loop-level metrics.

    ``metrics`` keeps the JAX package's flat key schema and order (pinned
    there by ``tests/test_bench_schema.py``) and is assembled from
    ``registry`` — a per-run :class:`~repro_torch.obs.MetricsRegistry`
    snapshot under stable
    dotted names (``serving.prefix.hits``, ``pool.blocks.live``, …)."""
    results: List[RequestResult]
    metrics: Dict[str, Any]
    registry: Optional[MetricsRegistry] = field(default=None, repr=False)

    @property
    def by_id(self) -> Dict[Any, RequestResult]:
        return {r.rid: r for r in self.results}

    def describe(self) -> str:
        m = self.metrics
        out = (
            f"serving[{m['n_requests']} req] "
            f"{m['generated_tokens']} tok in {m['wall_s']:.3f}s "
            f"({m['tokens_per_s']:.1f} tok/s)\n"
            f"  latency: p50={m['p50_latency_s'] * 1e3:.1f}ms "
            f"p95={m['p95_latency_s'] * 1e3:.1f}ms "
            f"ttft_p50={m['p50_ttft_s'] * 1e3:.1f}ms "
            f"ttft_p95={m['p95_ttft_s'] * 1e3:.1f}ms\n"
            f"  loop: ticks={m['decode_ticks']} "
            f"prefill_batches={m['prefill_batches']} "
            f"admissions={m['admissions']} evictions={m['evictions']} "
            f"refills={m['refills']} "
            f"fori_segments={m['fori_segments']} "
            f"host_syncs/tok={m['host_syncs_per_token']:.3f}\n"
            f"  kv-pool: {m['pool_blocks']} blocks x {m['block_size']} tok, "
            f"peak_used={m['peak_used_blocks']} "
            f"peak_live_tokens={m['peak_live_tokens']}")
        if m.get("prefix_cache"):
            out += (
                f"\n  prefix-cache: hits={m['prefix_hits']}/"
                f"{m['prefix_hits'] + m['prefix_misses']} "
                f"hit_rate={m['prefix_hit_rate'] * 100:.1f}% "
                f"(cached {m['prefix_cached_tokens']}/"
                f"{m['prompt_tokens_total']} prompt tok) "
                f"cow_forks={m['cow_forks']} "
                f"cache_evictions={m['prefix_cache_evictions']} "
                f"prefill_computed={m['prefill_tokens_computed']}")
        if m.get("speculation"):
            out += (
                f"\n  speculation: {m['spec_drafter']} "
                f"accepted={m['spec_tokens_accepted']}/"
                f"{m['spec_tokens_drafted']} "
                f"({m['spec_acceptance_rate'] * 100:.1f}%) "
                f"spec_ticks={m['spec_ticks']} "
                f"rolled_back={m['spec_rollback_tokens']} "
                f"fork_undos={m['spec_fork_undos']}")
        return out


def _whole(tree):
    """A state tree with every DTensor leaf gathered whole (a plain tree
    comes back as it is)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return full_tensor(tree)


def _on_mesh(compiled: CompiledModel, params):
    """``params`` as ``compiled``'s mesh places them: a DTensor already so
    placed passes through, anything else (a whole tensor, a DTensor of
    another mesh or placement) is cut to this rank's chunk, as ``jit``
    reshards its arguments in the JAX package."""
    from torch.distributed.tensor import DTensor
    rules = compiled.rules
    shd = rules.params_shardings(compiled.plan)

    def one(x, sh):
        if isinstance(x, DTensor) and x.device_mesh is rules.mesh and \
                tuple(x.placements) == tuple(sh.placements):
            return x
        return rules.place(full_tensor(x), sh, device=compiled.device)
    return {top: {k: one(v, shd[top][k]) for k, v in leaves.items()}
            for top, leaves in params.items()}


class Engine:
    """The serving engine over one :class:`CompiledModel`.

    On a mesh (``compiled`` built with ``mesh=``, or ``mesh=`` here, which
    builds the plan again on that mesh when it is not ``compiled``'s) every
    rank runs the same engine: the scheduler, the ledger, the prefix index
    and the drafters are host code that runs alike everywhere, and each
    rank holds the whole paged state (pools, tables, lengths, dense rows),
    as JAX keeps one logical pool outside any sharding.  A tick's forward
    runs each rank's rows of the batch on the mesh
    (``lowering._replicated_decode``: the new K/V gathered over dp so every
    rank writes every row, the state identical on every rank after every
    tick); the logits come back whole on every rank and one seed drives
    every rank's sampler, so every rank samples the same tokens."""

    def __init__(self, compiled: CompiledModel, params,
                 ecfg: Optional[EngineConfig] = None, mesh=None,
                 clock: Optional[Callable[[], float]] = None):
        if mesh is not None and (compiled.mesh is None or MeshSpec.of(
                mesh) != MeshSpec.of(compiled.mesh)):
            # honour an explicitly requested mesh: the plan is built again
            # for it (the JAX engine re-jits inside the mesh)
            compiled = CompiledModel.from_plan(compiled.plan, mesh=mesh,
                                               device=compiled.device)
        self.compiled = compiled
        self.plan = compiled.plan
        self.device = compiled.device
        self.mesh = compiled.mesh
        self.params = params if compiled.rules is None \
            else _on_mesh(compiled, params)
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        # one clock drives wall_s, latency/TTFT (through the Scheduler) and
        # the span timeline, so an injected clock makes every timing in the
        # report deterministic under test
        self.clock: Callable[[], float] = \
            clock if clock is not None else time.perf_counter
        self.tracer = Tracer(enabled=self.ecfg.trace,
                             max_events=self.ecfg.trace_max_events,
                             clock=self.clock)
        self.last_report: Optional[RunReport] = None
        self.last_cache: Optional[PagedKVCache] = None
        # speculative decoding: the drafter is built lazily on first use (a
        # draft-model drafter compiles a second model) and cached across
        # run() calls; drafter_override lets tests inject a custom Drafter
        self.drafter_override = None
        self._drafter = None
        self._drafter_key = None

    # -- single-batch generation (rolling cache) -----------------------------
    def generate(self, batch: Dict[str, Any], steps: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill on the prompt batch, then decode ``steps`` tokens."""
        return self.compiled.generate(
            self.params, batch, steps,
            temperature=self.ecfg.temperature, seed=self.ecfg.seed)

    def generate_fori(self, batch: Dict[str, Any], steps: int
                      ) -> torch.Tensor:
        """Greedy generation with the decode loop queued on the device."""
        return self.compiled.generate_fori(self.params, batch, steps)

    # -- continuous-batching serving loop ------------------------------------
    def _sample(self, logits, gen, temperature: float):
        # one sampling policy for every path: generate(), decode segments
        # and the run() loop all go through CompiledModel._sample
        return self.compiled._sample(logits, gen, temperature)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device (a host-to-device copy)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _get_drafter(self, spec):
        if self.drafter_override is not None:
            return self.drafter_override
        from repro_torch.serving.speculation import build_drafter
        key = (spec.kind, spec.draft_cfg, spec.ngram_max, spec.ngram_min)
        if self._drafter is None or self._drafter_key != key:
            self._drafter = build_drafter(
                spec, max_seq_len=self.ecfg.max_seq_len,
                target_cfg=self.plan.cfg, device=self.device)
            self._drafter_key = key
        return self._drafter

    def new_cache(self) -> PagedKVCache:
        e = self.ecfg
        return PagedKVCache(self.plan, e.max_batch, block_size=e.block_size,
                            blocks_per_slot=e.blocks_per_slot,
                            num_blocks=e.num_blocks,
                            prefix_cache=e.prefix_cache,
                            min_match_ratio=e.prefix_cache_min_ratio,
                            device=self.device)

    def run(self, requests: Sequence[Request]) -> RunReport:
        """Serve ``requests`` to completion with continuous batching over
        the paged KV pool; returns per-request results + loop metrics
        (also kept as ``self.last_report`` for ``describe()``).

        With ``prefix_cache=True`` admissions are matched against the block
        index first: a hit seeds the slot's block table from shared blocks
        and feeds only the uncovered prompt tail through decode ticks
        (mid-sequence prefill — exact, byte-identical to the cold path),
        with copy-on-write forks keeping shared blocks immutable.

        A multimodal model (patch tokens) and an encoder-decoder (audio
        frames) are refused before any tick: a request carries no patch
        embeddings and no frames (the JAX engine fails there with a
        ``KeyError``); serve them through :meth:`generate`.  A model with
        no self-attention KV state (rwkv6) is refused by the paged cache,
        as in JAX."""
        cfg = self.plan.cfg
        if cfg.n_patch_tokens:
            raise ValueError(
                f"{cfg.name}: Engine.run has no patches for the "
                f"model's {cfg.n_patch_tokens} patch tokens (a "
                "request carries only its prompt tokens); use generate() "
                "with a batch holding 'patches'")
        if cfg.n_encoder_layers:
            raise ValueError(
                f"{cfg.name}: Engine.run has no frames for the encoder's "
                f"{cfg.encoder_seq} positions (a request carries only its "
                "prompt tokens); use generate() with a batch holding "
                "'frames'")
        e = self.ecfg
        cache = self.new_cache()
        self.last_cache = cache
        sched = Scheduler(e.max_batch, e.block_size, cache.pool,
                          max_seq_len=e.max_seq_len, clock=self.clock,
                          prefix=cache if e.prefix_cache else None,
                          chunk_prefill=e.chunked_prefill)
        for r in requests:
            sched.submit(r)
        # Left-padded (bucketed) prefill is only exact when every
        # cross-position op masks by the positions array: recurrent/conv
        # temporal-mixing ops never see positions at all and would consume
        # the pad tokens as real context.  Enforce exact prompt buckets
        # there rather than silently corrupt.  (Both attention backends
        # mask positionally — the flash kernel included — so attention-only
        # models pad safely on any backend.)
        pad_unsafe = needs_exact_prompts(self.plan)
        if (e.chunk_size > 1 or e.chunked_prefill) and \
                any(not en.paged for en in cache._entries):
            raise ValueError(
                f"{self.plan.cfg.name}: chunked prefill (chunk_size > 1 or "
                "chunked_prefill) needs every per-request state entry to be "
                "paged self-attention; recurrent or cross-attention state "
                "can only advance one token per tick")
        spec = e.speculation
        spec_on = spec is not None
        if spec_on and any(not en.paged for en in cache._entries):
            raise ValueError(
                f"{self.plan.cfg.name}: speculative decoding needs every "
                "per-request state entry to be paged self-attention; "
                "rollback truncates block chains, which rolling or "
                "cross-attention state cannot express")
        drafter = self._get_drafter(spec) if spec_on else None
        vocab = self.plan.cfg.vocab_size
        tokens_drafted = tokens_accepted = spec_ticks = 0

        # one generator on the device carries the run's sampling stream
        # (the JAX loop splits one key per sample instead)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(e.seed)
        tr = self.tracer
        tr.clear()
        # per-run metrics registry: pool-occupancy gauges are set at the
        # same three sites that tracked peak_used/peak_live before (the
        # gauge keeps the peak), counters are published once after the loop
        reg = MetricsRegistry()
        g_pool_live = reg.gauge("pool.blocks.live")
        g_pool_cached = reg.gauge("pool.blocks.cached")
        g_pool_free = reg.gauge("pool.blocks.free")
        g_live_tokens = reg.gauge("pool.tokens.live")

        def note_pool():
            g_pool_live.set(cache.pool.used_blocks)
            g_pool_cached.set(cache.pool.cached_blocks)
            g_pool_free.set(cache.pool.free_blocks)
            g_live_tokens.set(cache.live_tokens())

        t0 = self.clock()
        ticks = prefill_batches = 0
        prefill_tokens = catchup_tokens = prompt_tokens_total = 0
        host_syncs = fori_segments = 0

        def evict_finished():
            sp = tr.span("evict", cat="sub")
            n = 0
            for sidx in sched.finished():
                cache.evict(sidx)
                sched.evict(sidx)
                n += 1
            sp.end(evicted=n)

        run_sp = tr.span("engine.run", cat="run", requests=len(requests),
                         max_batch=e.max_batch)
        while sched.has_work():
            # 1. admit into freed slots: prefix-cache hits seed their block
            #    tables from shared blocks (the uncovered tail catches up
            #    through decode ticks); the rest take the bucketed
            #    left-padded prefill
            sp_admit = tr.span("tick.admit", cat="phase", phase="admit",
                               queue=len(sched.queue))
            admitted = sched.admissions()
            prompt_tokens_total += sum(a.request.prompt_len for a in admitted)
            for a in admitted:
                if a.covered:
                    cache.admit_cached(a.slot, a.request.prompt,
                                       a.reserve_tokens, a.match)
                elif a.chunked:
                    cache.admit_tail(a.slot, a.request.prompt,
                                     a.reserve_tokens)
            adm = [a for a in admitted if not a.covered and not a.chunked]
            if not admitted and not sched.active_slots:
                # nothing running and the queue head still can't be admitted:
                # its block budget exceeds the whole pool — fail loudly
                # instead of spinning
                head = sched.queue[0][0]
                raise RuntimeError(
                    f"request {head.rid!r} needs "
                    f"{head.total_budget} tokens of KV but the pool can "
                    f"never free enough blocks "
                    f"({cache.pool.num_blocks - 1} x {e.block_size} tokens)")
            if adm:
                Bp = bucket_for(len(adm), e.batch_buckets)
                Sp = bucket_for(max(a.request.prompt_len for a in adm),
                                e.prompt_buckets)
                sp_prefill = tr.span("prefill", cat="sub", batch=Bp,
                                     bucket=Sp, n=len(adm))
                if Sp > self.plan.cache_len:
                    raise ValueError(
                        f"prompt bucket {Sp} exceeds the compiled cell's "
                        f"cache length {self.plan.cache_len}; compile the "
                        f"model with a decode shape covering max_seq_len")
                tokens = np.zeros((Bp, Sp), np.int32)
                positions = np.full((Bp, Sp), -1, np.int32)
                for i, a in enumerate(adm):
                    pad = Sp - a.request.prompt_len
                    if pad and pad_unsafe:
                        raise ValueError(
                            f"request {a.request.rid!r}: prompt length "
                            f"{a.request.prompt_len} needs left-padding to "
                            f"bucket {Sp}, but the model has recurrent "
                            "temporal-mixing state that consumes pad tokens "
                            "unmasked; use exact prompt_buckets matching "
                            "the prompt lengths")
                    tokens[i, pad:] = a.request.prompt
                    positions[i] = np.arange(Sp, dtype=np.int32) - pad
                logits, pstate, _ = self.compiled.prefill(
                    self.params, {"tokens": self._dev(tokens),
                                  "positions": self._dev(positions)})
                # on a mesh: the logits and the prefill state whole on every
                # rank (no-ops on one device)
                logits = full_tensor(logits)
                pstate = _whole(pstate)
                if spec_on and e.temperature > 0:
                    # per-request rng streams: the first generated token is
                    # commit index 0 of its request's stream, so prefilled
                    # and speculative ticks draw from one counter sequence
                    serials = np.full(Bp, -1, np.int32)
                    for i, a in enumerate(adm):
                        serials[i] = sched.slots[a.slot].serial
                    toks = sample_targets(
                        logits[:, -1][:, None, :], e.seed,
                        self._dev(serials), torch.zeros(Bp, dtype=torch.int32),
                        e.temperature)[:, 0].cpu().numpy()
                else:
                    toks = self._sample(logits[:, -1], rng,
                                        e.temperature).cpu().numpy()
                host_syncs += 1
                for i, a in enumerate(adm):
                    cache.admit(a.slot, a.request.prompt_len,
                                a.reserve_tokens, pstate, i,
                                Sp - a.request.prompt_len,
                                prompt=a.request.prompt)
                    if e.capture_logits:
                        sched.slots[a.slot].result.logits.append(
                            logits[i, -1].float().cpu().numpy())
                    sched.record_token(a.slot, int(toks[i]), first=True)
                # the batch's dense prefill state is in the pool now: free
                # it before the next prefill makes another
                del logits, pstate
                prefill_batches += 1
                prefill_tokens += sum(a.request.prompt_len for a in adm)
                sp_prefill.end()
                note_pool()
                evict_finished()
            if tr.enabled:
                # queue blocked with nothing admitted: name the bottleneck
                stall = None
                if sched.queue and not admitted:
                    stall = "no-free-slot" \
                        if not any(s.free for s in sched.slots) \
                        else "no-free-kv-blocks"
                sp_admit.end(admitted=len(admitted),
                             pool_live=cache.pool.used_blocks,
                             pool_free=cache.pool.free_blocks,
                             **({"stall": stall} if stall else {}))

            # 2. advance the occupied slots (batch-bucketed): a host-free
            #    fori segment when nothing can interrupt it, otherwise one
            #    (possibly chunked) decode tick.
            active = sched.active_slots
            if not active:
                continue
            B = bucket_for(sched.high_water, e.batch_buckets)

            # 2a. host-free segment: when no scheduling event can occur for
            #     the next fori_seg ticks — no slot is catching up, and every
            #     slot has at least fori_seg tokens of budget left — run the
            #     whole stretch as one queued decode segment with on-device
            #     sampling.  COW safety: refcounts only change at admission
            #     and eviction, neither of which can happen mid-segment, so
            #     a fork can never *become* needed after prepare_decode; and
            #     rem >= fori_seg keeps every row inside its reserved chain
            #     (a stop-token slot keeps ticking on device — its post-stop
            #     tokens are dropped here and the slot evicted right after).
            rem = min(s.request.max_new_tokens - s.result.n_generated
                      for s in (sched.slots[i] for i in active))
            if e.fori_seg >= 2 and not e.capture_logits and not spec_on \
                    and rem >= e.fori_seg \
                    and not any(sched.slots[i].pending for i in active):
                T = e.fori_seg
                sp_fori = tr.span("tick.fori", cat="phase",
                                  phase="decode-fori", batch=B, seg=T,
                                  queue=len(sched.queue))
                sp_cow = tr.span("cow-fork", cat="sub")
                cache.prepare_decode(active)   # COW forks before any write
                sp_cow.end()
                tok0 = np.zeros(B, np.int32)
                pos0 = np.zeros(B, np.int32)
                for i in active:
                    tok0[i] = sched.slots[i].last_token
                    pos0[i] = sched.slots[i].pos
                part = slice_state(cache.state, cache.slot_axes, B)
                seg = self.compiled.decode_segment(
                    T, temperature=e.temperature)
                toks_dev, new_part, rng = seg(
                    self.params, part, self._dev(tok0), self._dev(pos0), rng)
                cache.state = merge_state(cache.state, new_part,
                                          cache.slot_axes, B)
                cache.note_decode_tick(active, {i: T for i in active})
                toks = toks_dev.cpu().numpy()  # ONE host sync for T tokens
                host_syncs += 1
                for i in active:
                    s = sched.slots[i]
                    stop = s.request.stop_token
                    for t in range(T):
                        sched.record_token(i, int(toks[i, t]))
                        if stop is not None and int(toks[i, t]) == stop:
                            break
                ticks += T
                fori_segments += 1
                note_pool()
                evict_finished()
                if tr.enabled:
                    sp_fori.end(pool_live=cache.pool.used_blocks,
                                host_syncs=host_syncs)
                continue

            # 2b. one decode tick over the occupied slots.  Slots catching
            #     up on a prompt tail feed their next chunk_size prompt
            #     tokens (a (B, k) catch-up cell, k from the chunk ladder);
            #     caught-up slots advance one sampled token in column 0 of
            #     the same tick.  With speculation on, caught-up slots may
            #     instead carry a verify row [last_token, d_1..d_j]: every
            #     column scores in the same cell, acceptance is decided on
            #     the host, and the ledger rolls rejected columns back.
            sp_tick = tr.span("tick.decode", cat="phase", phase="decode",
                              batch=B, queue=len(sched.queue))
            proposals: Dict[int, np.ndarray] = {}
            if spec_on:
                for i in active:
                    s = sched.slots[i]
                    if s.pending or s.request.speculate is False:
                        continue
                    # cap keeps every possible commit (n_acc + 1 <= j + 1)
                    # inside the request's remaining budget and reservation
                    cap = min(spec.draft_k,
                              s.request.max_new_tokens
                              - s.result.n_generated - 1)
                    if cap < 1:
                        continue
                    hist = np.concatenate(
                        [np.asarray(s.request.prompt, np.int32),
                         np.asarray(s.result.tokens, np.int32)])
                    d = np.asarray(drafter.propose(hist, cap),
                                   np.int32).reshape(-1)[:cap]
                    bad = np.nonzero((d < 0) | (d >= vocab))[0]
                    if bad.size:          # out-of-vocab drafts never match
                        d = d[:int(bad[0])]
                    if d.size:
                        proposals[i] = d
                        cache.spec_begin(i)
            sp_cow = tr.span("cow-fork", cat="sub")
            cache.prepare_decode(active)       # COW forks before any write
            sp_cow.end()
            need = max((len(proposals[i]) + 1 if i in proposals
                        else min(len(sched.slots[i].pending), e.chunk_size)
                        for i in active), default=1)
            k_tick = bucket_for(max(need, 1), e.tick_buckets)
            if tr.enabled:
                sp_tick.set(
                    k=k_tick,
                    phase=("spec-verify" if proposals else
                           "chunked-prefill" if any(
                               sched.slots[i].pending for i in active)
                           else "decode"))
            fills: Dict[int, int] = {}
            if k_tick > 1:
                tokens = np.zeros((B, k_tick), np.int32)
                positions = np.full((B, k_tick), -1, np.int32)
                sel = np.zeros(B, np.int64)
                for s in sched.slots[:B]:
                    if s.free:
                        continue
                    if s.index in proposals:
                        d = proposals[s.index]
                        m = d.size + 1
                        tokens[s.index, 0] = s.last_token
                        tokens[s.index, 1:m] = d
                        positions[s.index, :m] = \
                            s.pos + np.arange(m, dtype=np.int32)
                        fills[s.index] = m
                        sel[s.index] = 0
                    elif s.pending:
                        m = min(len(s.pending), k_tick)
                        tokens[s.index, :m] = s.pending[:m]
                        positions[s.index, :m] = \
                            s.pos + np.arange(m, dtype=np.int32)
                        fills[s.index] = m
                        sel[s.index] = m - 1
                    else:
                        tokens[s.index, 0] = s.last_token
                        positions[s.index, 0] = s.pos
                        fills[s.index] = 1
            else:
                tokens = np.zeros((B, 1), np.int32)
                positions = np.zeros((B, 1), np.int32)
                sel = np.zeros(B, np.int64)
                for s in sched.slots[:B]:
                    if not s.free:
                        tokens[s.index, 0] = \
                            s.pending[0] if s.pending else s.last_token
                        positions[s.index, 0] = s.pos
                        fills[s.index] = 1
            part = slice_state(cache.state, cache.slot_axes, B)
            logits, new_part, _ = self.compiled.decode(
                self.params, {"tokens": self._dev(tokens),
                              "positions": self._dev(positions)},
                part, 0)
            logits = full_tensor(logits)
            cache.state = merge_state(cache.state, new_part,
                                      cache.slot_axes, B)
            cache.note_decode_tick(active, fills)
            if spec_on:
                # every column's target token at once: column c of row i is
                # the token the target model emits at commit index
                # t0s[i] + c.  At temperature 0 that's a plain argmax
                # (rng-free, byte-identical to the 1-token loop); sampled,
                # each (serial, index) pair owns one counter-mode key, so
                # the draw is independent of tick packing and drafters.
                if e.temperature > 0:
                    serials = np.full(B, -1, np.int32)
                    t0s = np.zeros(B, np.int32)
                    for i in active:
                        s = sched.slots[i]
                        serials[i] = s.serial
                        # catch-up rows: only the final column (the first
                        # generated token) can commit — index 0 there
                        t0s[i] = s.result.n_generated - (fills[i] - 1) \
                            if s.pending else s.result.n_generated
                    targets = sample_targets(
                        logits, e.seed, self._dev(serials), self._dev(t0s),
                        e.temperature).cpu().numpy()
                else:
                    targets = torch.argmax(logits, dim=-1).cpu().numpy()
                lg_np = logits.float().cpu().numpy() if e.capture_logits \
                    else None
            else:
                # each row samples from its last fed column's logits
                # (column 0 for plain decode rows, the chunk's last fill
                # for catch-up rows)
                rows = torch.arange(B, device=logits.device)
                last_lg = logits[rows, self._dev(sel)]
                toks = self._sample(last_lg, rng,
                                    e.temperature).cpu().numpy()
                lg_np = logits.float().cpu().numpy() if e.capture_logits \
                    else None
            host_syncs += 1
            spec_commits: Dict[int, int] = {}
            for sidx in active:
                s = sched.slots[sidx]
                if s.pending:
                    m = fills[sidx]
                    catchup_tokens += m
                    sched.note_catchup(sidx, m)
                    if s.pending:      # tail not done: discard sample
                        continue
                    # prompt fully resident: index its blocks, and the
                    # sample from the last tail token's logits is the
                    # first generated token
                    cache.register_prompt(sidx)
                    if e.capture_logits:
                        s.result.logits.append(lg_np[sidx, int(sel[sidx])])
                    tok = int(targets[sidx, m - 1]) if spec_on \
                        else int(toks[sidx])
                    sched.record_token(sidx, tok, first=True)
                elif sidx in proposals:
                    # acceptance walk: draft d[c] survives iff it equals
                    # the target token of its column; the committed tokens
                    # are the accepted prefix plus the first mismatch's
                    # target (the bonus token on accept-all)
                    d = proposals[sidx]
                    j = int(d.size)
                    n_acc = 0
                    while n_acc < j and \
                            int(targets[sidx, n_acc]) == int(d[n_acc]):
                        n_acc += 1
                    n_commit = n_acc + 1
                    tokens_drafted += j
                    tokens_accepted += n_acc
                    s.result.tokens_drafted += j
                    s.result.tokens_accepted += n_acc
                    spec_commits[sidx] = n_commit
                    stop = s.request.stop_token
                    for c in range(n_commit):
                        if e.capture_logits:
                            s.result.logits.append(lg_np[sidx, c])
                        tok = int(targets[sidx, c])
                        sched.record_token(sidx, tok)
                        if stop is not None and tok == stop:
                            break
                else:
                    if e.capture_logits:
                        s.result.logits.append(lg_np[sidx, int(sel[sidx])])
                    tok = int(targets[sidx, 0]) if spec_on \
                        else int(toks[sidx])
                    sched.record_token(sidx, tok)
            if spec_commits:
                # all windows close together: one batched device resync
                # for every rolled-back slot (must precede eviction — the
                # prefix index only ever sees committed tokens)
                cache.spec_commit_many(spec_commits)
            if proposals:
                spec_ticks += 1
            ticks += 1
            note_pool()
            evict_finished()
            if tr.enabled:
                sp_tick.end(pool_live=cache.pool.used_blocks,
                            host_syncs=host_syncs)

        run_sp.end(ticks=ticks, host_syncs=host_syncs)
        wall = self.clock() - t0
        results = sched.results
        gen = sum(r.n_generated for r in results)
        led = cache.ledger

        # publish every loop counter into the per-run registry; the
        # report's flat legacy keys are a view over the snapshot (the
        # dotted names are the stable schema — README "Observability")
        reg.counter("serving.requests").inc(len(results))
        reg.counter("serving.tokens.generated").inc(gen)
        reg.counter("serving.tokens.prompt").inc(prompt_tokens_total)
        reg.counter("serving.tokens.prefill_computed").inc(
            prefill_tokens + catchup_tokens)
        reg.counter("serving.tokens.catchup").inc(catchup_tokens)
        reg.counter("serving.ticks").inc(ticks)
        reg.counter("serving.prefill.batches").inc(prefill_batches)
        reg.counter("serving.fori.segments").inc(fori_segments)
        # host_syncs counts the device->host round-trips the loop performed
        # (one per prefill sample, per tick sample, per fori segment)
        reg.counter("serving.host_syncs").inc(host_syncs)
        reg.gauge("serving.wall_s").set(wall)
        reg.gauge("serving.tokens_per_s").set(
            gen / wall if wall > 0 else float("inf"))
        reg.gauge("serving.host_syncs_per_token").set(
            host_syncs / gen if gen else 0.0)
        h_lat = reg.histogram("serving.latency_s")
        h_ttft = reg.histogram("serving.ttft_s")
        for r in results:
            h_lat.observe(r.latency_s)
            h_ttft.observe(r.ttft_s)
        sched.publish_metrics(reg)
        cache.pool.publish_metrics(reg)
        led.publish_metrics(reg)
        reg.gauge("pool.blocks.total").set(cache.num_blocks)
        reg.gauge("pool.bytes").set(cache.pool_bytes())
        reg.gauge("serving.prefix.hit_rate").set(
            led.cached_tokens / prompt_tokens_total
            if prompt_tokens_total else 0.0)
        reg.counter("serving.spec.ticks").inc(spec_ticks)
        reg.counter("serving.spec.tokens_drafted").inc(tokens_drafted)
        reg.counter("serving.spec.tokens_accepted").inc(tokens_accepted)
        reg.gauge("serving.spec.acceptance_rate").set(
            tokens_accepted / tokens_drafted if tokens_drafted else 0.0)

        snap = reg.snapshot()
        report = RunReport(results=results, registry=reg, metrics={
            "n_requests": snap["serving.requests"],
            "generated_tokens": snap["serving.tokens.generated"],
            "wall_s": snap["serving.wall_s"],
            "tokens_per_s": snap["serving.tokens_per_s"],
            "p50_latency_s": snap["serving.latency_s.p50"],
            "p95_latency_s": snap["serving.latency_s.p95"],
            "p50_ttft_s": snap["serving.ttft_s.p50"],
            "p95_ttft_s": snap["serving.ttft_s.p95"],
            "decode_ticks": snap["serving.ticks"],
            "prefill_batches": snap["serving.prefill.batches"],
            # serving-policy knobs echo straight from the config
            "chunk_size": e.chunk_size,
            "chunked_prefill": e.chunked_prefill,
            "fori_seg": e.fori_seg,
            "fori_segments": snap["serving.fori.segments"],
            "host_syncs": snap["serving.host_syncs"],
            "host_syncs_per_token": snap["serving.host_syncs_per_token"],
            "admissions": snap["serving.sched.admissions"],
            "evictions": snap["serving.sched.evictions"],
            "refills": snap["serving.sched.refills"],
            "pool_blocks": snap["pool.blocks.total"],
            "block_size": e.block_size,
            "peak_used_blocks": snap["pool.blocks.live.peak"],
            "peak_live_tokens": snap["pool.tokens.live.peak"],
            "pool_bytes": snap["pool.bytes"],
            # prefix-cache outcome (zeros when the toggle is off)
            "prefix_cache": e.prefix_cache,
            "prefix_hits": snap["serving.prefix.hits"],
            "prefix_misses": snap["serving.prefix.misses"],
            "prefix_cached_tokens": snap["serving.prefix.cached_tokens"],
            "prefix_cache_evictions": snap["serving.prefix.evictions"],
            "cow_forks": snap["serving.prefix.cow_forks"],
            "prompt_tokens_total": snap["serving.tokens.prompt"],
            "prefill_tokens_computed":
                snap["serving.tokens.prefill_computed"],
            "catchup_tokens": snap["serving.tokens.catchup"],
            "prefix_hit_rate": snap["serving.prefix.hit_rate"],
            # speculative-decoding outcome (off -> False + zeros)
            "speculation": spec_on,
            "spec_drafter": spec.describe() if spec_on else "off",
            "spec_draft_k": spec.draft_k if spec_on else 0,
            "spec_ticks": snap["serving.spec.ticks"],
            "spec_tokens_drafted": snap["serving.spec.tokens_drafted"],
            "spec_tokens_accepted": snap["serving.spec.tokens_accepted"],
            "spec_acceptance_rate": snap["serving.spec.acceptance_rate"],
            "spec_rollback_tokens": snap["serving.spec.rollback_tokens"],
            "spec_fork_undos": snap["serving.spec.fork_undos"],
        })
        self.last_report = report
        return report

    # -- reporting -----------------------------------------------------------
    def describe(self, stats: bool = False) -> str:
        """Flow report + serving envelope + the last run's metrics."""
        e = self.ecfg
        lines = [self.compiled.describe(stats=stats),
                 f"  serving: slots={e.max_batch} max_seq_len={e.max_seq_len} "
                 f"block={e.block_size} "
                 f"batch_buckets={list(e.batch_buckets)} "
                 f"prompt_buckets={list(e.prompt_buckets)} "
                 f"prefix_cache={'on' if e.prefix_cache else 'off'} "
                 f"chunk={e.chunk_size}"
                 f"{'+chunked_prefill' if e.chunked_prefill else ''} "
                 f"fori_seg={e.fori_seg or 'off'} "
                 f"spec={e.speculation.describe() if e.speculation else 'off'}"]
        if self.last_report is not None:
            lines.append("  " +
                         self.last_report.describe().replace("\n", "\n  "))
        return "\n".join(lines)
