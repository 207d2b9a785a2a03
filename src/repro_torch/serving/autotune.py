"""Engine-level decode autotune: flow search over the serving decode cell.

The ROADMAP's "serving autotune" item: reuse the design-space explorer
(:mod:`repro_torch.core.dse`) on the *decode* cell the Engine actually runs
— once per batch bucket of the serving profile — and pin the winning flow.
The DSE exposes the pass knobs and the kernel backend; with
``validate="measure"`` survivors are ranked by measured step time
(:meth:`CompiledModel.measure`: CUDA events on the card), the serving
analogue of the paper's confirm-by-place-&-route step.  On top, pool
microbenchmarks of the paged decode kernel pick the KV block size and the
catch-up chunk width, and engine replays A/B the prefix cache, the decode
segment length and speculation.

Everything runs on one device type (``device=``: the card unless the
caller asks for the CPU), on one device or, with ``mesh=``, on a mesh over
the process group's ranks, where every rank runs the same search and the
engine replays serve on the mesh.  On the card the block and chunk benches
launch the hand kernel ``paged_decode_attention`` through its wrapper (the
registry's ``auto`` resolution) and time each call with CUDA events; on
the CPU they time its plain version on the wall clock.

Usage::

    at = autotune_decode("llama3.2-1b", smoke=True, device="cpu",
                         profile=ServingProfile(batch_buckets=(1, 4),
                                                max_seq_len=64))
    eng = at.engine()                                     # or, by hand:
    cm = at.compile()                                     # pinned best flow
    eng = Engine(cm, cm.init_params(0), at.engine_config())
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tunedb
from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core import dse
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TRACER


def _timed_runs(label: str, fn: Callable[[], Any], iters: int,
                warmup: int = 1, device: Optional[torch.device] = None,
                mesh: Any = None, **attrs: Any) -> List[float]:
    """Time ``fn`` ``iters`` times, one ``autotune`` span a run through the
    module tracer.  On a CUDA ``device`` each run is bracketed by CUDA
    events and waited for (its device time, the host's launch cost
    included); otherwise the span's wall clock times it.  The first
    ``warmup`` run(s) are discarded — the first call can pay a kernel build
    or a first-call set-up, and with few iters a set-up-heavy candidate
    would win or lose on it rather than steady-state time.  Callers
    aggregate the returned samples by median.  On a ``mesh`` of more than
    one rank every rank keeps the slowest rank's samples, so every rank of
    the search makes the same pick."""
    for _ in range(max(warmup, 0)):
        fn()
    on_card = device is not None and device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(max(iters, 1)):
        sp = TRACER.timed(label, cat="autotune", **attrs)
        if on_card:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            sp.end()
            ts.append(t0.elapsed_time(t1) / 1e3)
        else:
            fn()
            sp.end()
            ts.append(sp.elapsed_s)
    return _agreed(ts, mesh)


def _agreed(ts: List[float], mesh: Any) -> List[float]:
    """``ts`` all-reduced to the slowest rank's over the process group the
    ``mesh`` spans (as ``CompiledModel.measure`` does); as it is without a
    mesh or on one rank."""
    if mesh is None:
        return ts
    from repro_torch.distributed.meshspec import MeshSpec
    if MeshSpec.of(mesh).size == 1:
        return ts
    import torch.distributed as dist
    t = torch.tensor(ts, dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _mesh_key(mesh: Any) -> Dict[str, Any]:
    """The mesh part of a bench's tunedb key (empty on one device)."""
    if mesh is None:
        return {}
    from repro_torch.distributed.meshspec import MeshSpec
    return {"mesh": MeshSpec.of(mesh).describe()}


# ---------------------------------------------------------------------------
# persistent microbench records (repro_torch.tunedb, kind="serving")
# ---------------------------------------------------------------------------

def _serving_key(cfg: ModelConfig, profile: "ServingProfile", fld: str,
                 device: Optional[torch.device] = None,
                 **extra: Any) -> Dict[str, Any]:
    """The structured key one ``tune_*`` microbench persists under:
    (cfg fingerprint, ServingProfile, tuned field, platform/device kind,
    plus whatever pinned context the bench depends on)."""
    key: Dict[str, Any] = {"cfg": tunedb.config_facts(cfg),
                           "profile": dataclasses.asdict(profile),
                           "field": fld,
                           "platform": tunedb.device_key(device)}
    key.update(extra)
    return key


def _db_served(tdb: Optional[tunedb.TuneDB],
               key: Dict[str, Any]) -> Optional[Tuple[Any, Dict]]:
    """The stored ``(best, times)`` for ``key``, or None (miss / no db)."""
    if tdb is None:
        return None
    rec = tdb.lookup(key)
    if rec is None:
        return None
    v = rec.value
    return v["best"], dict(v.get("times", []))


def _db_bank(tdb: Optional[tunedb.TuneDB], key: Dict[str, Any],
             best: Any, times: Dict) -> None:
    """Persist one microbench outcome (times as pairs: int keys and tuple
    values survive the JSON round-trip exactly)."""
    if tdb is not None:
        tdb.put(tunedb.TuneRecord.make(
            "serving", key, {"best": best, "times": list(times.items())},
            device=key["platform"]))


def _pinned_facts(at: "DecodeAutotune") -> Dict[str, Any]:
    """The already-pinned autotune context an engine-replay bench depends
    on — part of its key, so re-tuning one stage after an upstream stage
    changed never serves the stale replay."""
    return {"flow": tunedb.flow_facts(at.flow_for()),
            **_mesh_key(at.mesh),
            "bucket": at.best_bucket,
            "block_size": at.block_size,
            "chunk_size": at.chunk_size,
            "fori_seg": at.fori_seg,
            "prefix_cache": at.prefix_cache}


@dataclass(frozen=True)
class ServingProfile:
    """One deployment's decode envelope: what the Engine will be asked to
    serve, hence what the autotune optimizes for."""
    name: str = "default"
    batch_buckets: Tuple[int, ...] = (1, 4, 16)
    max_seq_len: int = 256
    block_sizes: Tuple[int, ...] = (8, 16, 32)
    # chunked-prefill catch-up widths to microbench (k of the (B, k) cell)
    chunk_sizes: Tuple[int, ...] = (1, 2, 4)
    # host-free decode segment lengths to A/B (0 = per-tick host loop)
    fori_segs: Tuple[int, ...] = (0, 4, 8)
    # speculative draft_k candidates to A/B with the n-gram drafter
    # (0 = speculation off)
    spec_ks: Tuple[int, ...] = (0, 2, 4)

    def __post_init__(self):
        # frozen dataclass: normalize sequence inputs via object.__setattr__
        object.__setattr__(self, "batch_buckets", tuple(self.batch_buckets))
        object.__setattr__(self, "block_sizes", tuple(self.block_sizes))
        object.__setattr__(self, "chunk_sizes", tuple(self.chunk_sizes))
        object.__setattr__(self, "fori_segs", tuple(self.fori_segs))
        object.__setattr__(self, "spec_ks", tuple(self.spec_ks))
        # candidate-set invariants live once in repro_torch.analysis.rules
        # (shared with the static verifier); each raises with its message
        from repro_torch.analysis import rules as _rules
        msg0 = _rules.profile_batch_buckets(self.batch_buckets)
        if msg0 is not None:
            raise ValueError(msg0)
        if self.max_seq_len < 1:
            raise ValueError("max_seq_len must be >= 1")
        for msg in (_rules.profile_block_sizes(self.block_sizes,
                                               self.max_seq_len),
                    _rules.profile_chunk_sizes(self.chunk_sizes,
                                               self.max_seq_len),
                    _rules.profile_fori_segs(self.fori_segs),
                    _rules.profile_spec_ks(self.spec_ks, self.max_seq_len)):
            if msg is not None:
                raise ValueError(msg)

    def shape_for(self, bucket: int) -> ShapeConfig:
        return ShapeConfig(f"{self.name}_decode{self.max_seq_len}_b{bucket}",
                           "decode", self.max_seq_len, bucket)


@dataclass
class DecodeAutotune:
    """The autotune outcome the Engine pins: the measured-ranked flow per
    batch bucket (and overall), the chosen KV block size, and whether the
    prefix cache pays for the profile's workload."""
    cfg: ModelConfig
    profile: ServingProfile
    per_bucket: Dict[int, Any]          # bucket -> dse.ExploreResult
    block_size: int
    block_times_us: Dict[int, float] = field(default_factory=dict)
    prefix_cache: bool = False
    prefix_times_s: Dict[str, float] = field(default_factory=dict)
    chunk_size: int = 1
    chunk_times_us: Dict[int, float] = field(default_factory=dict)
    # the engine replay that confirms the microbench's chunk: "1" (chunked
    # prefill off) and the picked width, seconds
    chunk_replay_s: Dict[str, float] = field(default_factory=dict)
    fori_seg: int = 0
    fori_times_s: Dict[str, float] = field(default_factory=dict)
    speculation: Optional[str] = None    # e.g. "ngram:4"; None = off
    spec_times_s: Dict[str, float] = field(default_factory=dict)
    # per-kernel tile schedules (tune_kernel_tiles): ordered (tile_key,
    # tile) pairs folded into every pinned flow, + bench times
    tile_overrides: Tuple[Tuple[str, Any], ...] = ()
    tile_times_s: Dict[str, float] = field(default_factory=dict)
    device: torch.device = torch.device("cpu")   # where it was tuned
    mesh: Any = None                     # the DeviceMesh it was tuned on
    # the pinned flow's weights by seed, made once (init_params)
    _params: Dict[int, Any] = field(default_factory=dict, repr=False)

    @property
    def n_measured(self) -> int:
        """Validator invocations the per-bucket flow searches actually paid
        (0 everywhere when every bucket was an exact tunedb hit) — what the
        CI warm-start gate asserts shrinks."""
        return sum(er.n_measured for er in self.per_bucket.values())

    @property
    def tunedb_statuses(self) -> Dict[int, Optional[str]]:
        """Per-bucket tunedb outcome (None without a db, else
        hit/transfer/cold)."""
        return {b: er.tunedb_status for b, er in self.per_bucket.items()}

    def _measured_per_token(self, bucket: int) -> Optional[float]:
        er = self.per_bucket[bucket]
        ts = [v["measured_step_s"] for v in er.validated
              if v["knobs"] == er.best.knob_str() and "measured_step_s" in v]
        return (ts[0] / bucket) if ts else None

    @property
    def best_bucket(self) -> int:
        """The bucket whose winner delivers the best measured *per-token*
        decode time — every bucket's search informs the pin.  Falls back to
        the largest bucket when nothing was measured (validate != measure)."""
        scored = [(b, t) for b in self.profile.batch_buckets
                  if (t := self._measured_per_token(b)) is not None]
        if not scored:
            return self.profile.batch_buckets[-1]
        return min(scored, key=lambda bt: bt[1])[0]

    def flow_for(self, bucket: Optional[int] = None) -> FlowConfig:
        b = bucket if bucket is not None else self.best_bucket
        if b not in self.per_bucket:
            raise KeyError(f"bucket {b} was not tuned "
                           f"(profile buckets: {self.profile.batch_buckets})")
        f = self.per_bucket[b].best.flow
        if self.tile_overrides:
            f = dataclasses.replace(f, tile_overrides=self.tile_overrides)
        return f

    def compile(self, bucket: Optional[int] = None):
        """CompiledModel for the winning flow of ``bucket`` (default: the
        measured-best per-token bucket) on the tuned device — what the
        Engine pins.  The decode shape cell always covers the profile's full
        envelope (largest bucket) so the pinned model serves every batch
        bucket."""
        from repro_torch import flow as tflow
        b = bucket if bucket is not None else self.best_bucket
        return tflow.compile(self.cfg,
                             self.profile.shape_for(
                                 self.profile.batch_buckets[-1]),
                             self.flow_for(b), mesh=self.mesh,
                             device=self.device)

    def engine_config(self, **overrides) -> "EngineConfig":
        """EngineConfig matching the tuned profile (slots = largest bucket,
        tuned block size, the profile's bucket ladder)."""
        from repro_torch.serving.engine import EngineConfig
        kw: Dict[str, Any] = dict(
            max_batch=self.profile.batch_buckets[-1],
            max_seq_len=self.profile.max_seq_len,
            batch_buckets=tuple(self.profile.batch_buckets),
            block_size=self.block_size,
            prefix_cache=self.prefix_cache,
            chunk_size=self.chunk_size,
            chunked_prefill=self.chunk_size > 1,
            fori_seg=self.fori_seg)
        if self.speculation:
            kw["speculation"] = self.speculation
            kw["fori_seg"] = 0       # S307: the host decides acceptance
        kw.update(overrides)
        return EngineConfig(**kw)

    def init_params(self, seed: int = 0):
        """The pinned flow's weights, ``compile().init_params(seed)``, made
        once a seed and shared by the engine replays and :meth:`engine` (a
        full-width model takes seconds to draw; every pinned flow of one
        autotune has the same weights)."""
        if seed not in self._params:
            self._params[seed] = self.compile().init_params(seed)
        return self._params[seed]

    def engine(self, params=None, seed: int = 0, **overrides):
        """Compile the winning flow and build an Engine pinned to it
        (weights :meth:`init_params` of ``seed`` unless ``params`` are
        given)."""
        from repro_torch.serving.engine import Engine
        cm = self.compile()
        if params is None:
            params = self.init_params(seed)
        return Engine(cm, params, self.engine_config(**overrides))

    def describe(self) -> str:
        lines = [f"serving-autotune[{self.cfg.name} x {self.profile.name}] "
                 f"buckets={list(self.profile.batch_buckets)} "
                 f"pin=b{self.best_bucket} block_size={self.block_size} "
                 f"prefix_cache={'on' if self.prefix_cache else 'off'} "
                 f"chunk={self.chunk_size} fori_seg={self.fori_seg or 'off'} "
                 f"spec={self.speculation or 'off'}"]
        statuses = self.tunedb_statuses
        if any(s is not None for s in statuses.values()):
            lines.append("  tunedb: " + " ".join(
                f"b{b}={statuses[b]}" for b in self.profile.batch_buckets)
                + f" measured={self.n_measured}")
        if self.tile_overrides:
            lines.append("  tiles: " + " ".join(
                f"{k}={v}" for k, v in self.tile_overrides))
        for b in self.profile.batch_buckets:
            er = self.per_bucket[b]
            t = self._measured_per_token(b)
            meas = f" measured={t * b * 1e3:.3f}ms" \
                   f" per_tok={t * 1e3:.3f}ms" if t is not None else ""
            lines.append(f"  b{b}: [{er.best.knob_str()}]{meas}")
        if self.block_times_us:
            lines.append("  block_us: " + " ".join(
                f"{k}:{v:.0f}" for k, v in sorted(self.block_times_us.items())))
        if self.prefix_times_s:
            lines.append("  prefix_replay_s: " + " ".join(
                f"{k}:{v:.3f}" for k, v in sorted(self.prefix_times_s.items())))
        if self.chunk_times_us:
            lines.append("  chunk_us_per_tok: " + " ".join(
                f"k{k}:{v:.0f}" for k, v in sorted(self.chunk_times_us.items())))
        if self.chunk_replay_s:
            lines.append("  chunk_replay_s: " + " ".join(
                f"k{k}:{v:.3f}" for k, v in sorted(
                    self.chunk_replay_s.items(), key=lambda kv: int(kv[0]))))
        if self.fori_times_s:
            lines.append("  fori_replay_s: " + " ".join(
                f"{k}:{v:.3f}" for k, v in sorted(
                    self.fori_times_s.items(), key=lambda kv: int(kv[0]))))
        if self.spec_times_s:
            lines.append("  spec_replay_s: " + " ".join(
                f"{k}:{v:.3f}" for k, v in sorted(self.spec_times_s.items())))
        return "\n".join(lines)


def _paged_fn(device: torch.device) -> Callable:
    """The paged decode kernel the registry resolves on ``device`` (the
    ``auto`` policy): the hand kernel's wrapper on a Hopper card, its plain
    version elsewhere."""
    from repro_torch.kernels.registry import REGISTRY
    backend = REGISTRY.resolve("paged_decode_attention", "auto", device.type)
    return REGISTRY.get("paged_decode_attention", backend).fn


def _pool(rng: np.random.RandomState, B: int, nblk: int, bs: int, KV: int,
          D: int, dtype: torch.dtype, device: torch.device):
    """A pool of 1 + B nblk blocks (block 0 the trash block) and each row's
    table of nblk blocks, from ``rng``."""
    NB = 1 + B * nblk

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device, dtype)
    kp, vp = t(NB, bs, KV, D), t(NB, bs, KV, D)
    bt = torch.from_numpy((1 + (np.arange(B * nblk) % (NB - 1))).reshape(
        B, nblk).astype(np.int32)).to(device)
    return kp, vp, bt, t


def tune_block_size(cfg: ModelConfig, profile: ServingProfile, *,
                    iters: int = 5, seed: int = 0, db: Any = None,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None, mesh: Any = None
                    ) -> Tuple[int, Dict[int, float]]:
    """Microbenchmark the paged decode-attention lookup per candidate block
    size at the profile's largest bucket and pick the fastest (ties -> the
    larger block: fewer table entries).  Runs the registry-resolved kernel
    on ``device`` (the hand kernel on the card, its plain version on the
    CPU) at ``dtype``; ``db`` (TuneDB or path) serves a previously banked
    winner without re-benching."""
    att = cfg.attention
    if att is None:
        raise ValueError(f"{cfg.name} has no attention; nothing to tune")
    dev = resolve_device(device)
    tdb = tunedb.open_db(db)
    key = _serving_key(cfg, profile, "block_size", dev, iters=iters,
                       seed=seed, dtype=str(dtype), **_mesh_key(mesh))
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    B = profile.batch_buckets[-1]
    H, KV, D = att.n_heads, att.n_kv_heads, att.head_dim
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32)).to(
        dev, dtype)
    times: Dict[int, float] = {}
    from repro_torch.serving.kvcache import blocks_for_tokens
    fn = _paged_fn(dev)
    for bs in profile.block_sizes:
        nblk = blocks_for_tokens(profile.max_seq_len, bs)
        kp, vp, bt, _ = _pool(rng, B, nblk, bs, KV, D, dtype, dev)
        lens = torch.full((B,), profile.max_seq_len - 1, dtype=torch.int32,
                          device=dev)
        ts = _timed_runs("autotune.block_size",
                         lambda: fn(q, kp, vp, bt, lens), iters,
                         device=dev, mesh=mesh, bs=bs)
        times[bs] = float(np.median(ts) * 1e6)
    best = min(sorted(times, reverse=True), key=lambda b: times[b])
    _db_bank(tdb, key, best, times)
    return best, times


def tune_chunk_size(cfg: ModelConfig, profile: ServingProfile, *,
                    block_size: Optional[int] = None,
                    iters: int = 5, seed: int = 0, db: Any = None,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None, mesh: Any = None
                    ) -> Tuple[int, Dict[int, float]]:
    """Microbenchmark the chunked catch-up cell — a (B, k) multi-query
    lookup against the paged pool — per candidate chunk width ``k`` and
    pick the best measured *per-token* time (ties -> the larger chunk:
    fewer engine ticks, hence fewer host syncs, per caught-up prompt).
    Mirrors :func:`tune_block_size`.  A lookup's time a token cannot see
    what chunked prefill costs an engine (a prompt caught up k tokens a
    tick instead of in one prefill batch), so :func:`autotune_decode`
    adopts a width above 1 only when an engine replay confirms it
    (:func:`_confirm_chunk`)."""
    att = cfg.attention
    if att is None:
        raise ValueError(f"{cfg.name} has no attention; nothing to tune")
    dev = resolve_device(device)
    B = profile.batch_buckets[-1]
    H, KV, D = att.n_heads, att.n_kv_heads, att.head_dim
    bs = block_size if block_size is not None else profile.block_sizes[0]
    tdb = tunedb.open_db(db)
    key = _serving_key(cfg, profile, "chunk_size", dev, block_size=bs,
                       iters=iters, seed=seed, dtype=str(dtype),
                       **_mesh_key(mesh))
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    rng = np.random.RandomState(seed)
    from repro_torch.serving.kvcache import blocks_for_tokens
    nblk = blocks_for_tokens(profile.max_seq_len, bs)
    kp, vp, bt, t = _pool(rng, B, nblk, bs, KV, D, dtype, dev)
    fn = _paged_fn(dev)
    times: Dict[int, float] = {}
    for k in profile.chunk_sizes:
        resident = max(profile.max_seq_len - k, 0)
        q = t(B, k, H, D)
        lens = torch.full((B,), resident, dtype=torch.int32, device=dev)
        qpos = lens[:, None] + torch.arange(k, dtype=torch.int32,
                                            device=dev)[None, :]
        ts = _timed_runs(
            "autotune.chunk_size",
            lambda: fn(q, kp, vp, bt, lens, qpos=qpos), iters,
            device=dev, mesh=mesh, k=k)
        times[k] = float(np.median(ts) * 1e6 / k)      # per catch-up token
    best = min(sorted(times, reverse=True), key=lambda k: times[k])
    _db_bank(tdb, key, best, times)
    return best, times


def _confirm_chunk(at: DecodeAutotune, chunk: int, *, iters: int = 2,
                   seed: int = 0, db: Any = None
                   ) -> Tuple[int, Dict[str, float]]:
    """Measured A/B of the chunk width ``chunk`` the microbench picked
    against chunked prefill off (width 1) on a replay of the profile's
    envelope: twice the largest bucket's requests, prompts of half the
    envelope (block-aligned, bucket-exact), a few new tokens each, so a
    second wave is admitted while the first decodes.  Keeps ``chunk`` only
    when its replay is faster; ties keep the engine's default (off)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import synthetic_requests
    prof = at.profile
    bs = at.block_size
    tdb = tunedb.open_db(db)
    key = _serving_key(at.cfg, prof, "chunk_replay", at.device,
                       pinned=_pinned_facts(at), chunk=chunk, iters=iters,
                       seed=seed)
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    max_new = max(2, min(8, prof.max_seq_len // 8))
    prompt_len = max(bs, min(prof.max_seq_len // 2,
                             prof.max_seq_len - max_new) // bs * bs)
    n = max(4, 2 * prof.batch_buckets[-1])
    cm = at.compile()
    params = at.init_params(seed)
    reqs = synthetic_requests(n, at.cfg.vocab_size, prompt_len=prompt_len,
                              max_new_tokens=max_new, seed=seed,
                              vary_lens=False)
    buckets = tuple(sorted({prompt_len, prof.max_seq_len}))
    times: Dict[str, float] = {}
    for k in (1, chunk):
        eng = Engine(cm, params,
                     at.engine_config(chunk_size=k, chunked_prefill=k > 1,
                                      prompt_buckets=buckets))
        eng.run(reqs)                         # warm the tick programs
        ts = _timed_runs("autotune.chunk_replay", lambda: eng.run(reqs),
                         iters, warmup=0, mesh=at.mesh, k=k)
        times[str(k)] = float(np.median(ts))
    best = chunk if times[str(chunk)] < times["1"] else 1
    _db_bank(tdb, key, best, times)
    return best, times


def tune_fori_seg(at: DecodeAutotune, *, iters: int = 2, seed: int = 0,
                  db: Any = None) -> Tuple[int, Dict[str, float]]:
    """Measured A/B of the host-free decode segment length on a
    decode-heavy replay of the profile's envelope: serve the same request
    batch through a pinned Engine once per candidate ``fori_seg`` (0 = the
    per-tick host loop) and keep the fastest.  Ties break toward the
    *larger* segment — equal wall time with fewer host syncs per token is
    still a latency-variance win.  Mirrors :func:`tune_prefix_cache`."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import synthetic_requests
    prof = at.profile
    bs = at.block_size
    tdb = tunedb.open_db(db)
    key = _serving_key(at.cfg, prof, "fori_seg", at.device,
                       pinned=_pinned_facts(at), iters=iters, seed=seed)
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    cands = sorted({0, *prof.fori_segs})
    segs = [s for s in cands if s] or [0]
    # short prompts (one block, bucket-exact: no left-padding) and long
    # generations — the segment loop's home turf
    prompt_len = bs
    max_new = min(prof.max_seq_len - prompt_len,
                  max(8, 2 * max(segs)))
    if max_new < 2:
        return 0, {}                   # envelope too small for any segment
    cands = [s for s in cands if s <= max_new]
    n = max(4, 2 * prof.batch_buckets[-1])
    cm = at.compile()
    params = at.init_params(seed)
    reqs = synthetic_requests(n, at.cfg.vocab_size, prompt_len=prompt_len,
                              max_new_tokens=max_new, seed=seed,
                              vary_lens=False)
    buckets = tuple(sorted({prompt_len, prof.max_seq_len}))
    times: Dict[str, float] = {}
    for seg in cands:
        eng = Engine(cm, params,
                     at.engine_config(fori_seg=seg, prompt_buckets=buckets))
        eng.run(reqs)                         # warm the tick programs
        ts = _timed_runs("autotune.fori_seg", lambda: eng.run(reqs),
                         iters, warmup=0, mesh=at.mesh, seg=seg)
        times[str(seg)] = float(np.median(ts))
    best = min(sorted(cands, reverse=True), key=lambda s: times[str(s)])
    _db_bank(tdb, key, best, times)
    return best, times


def tune_prefix_cache(at: DecodeAutotune, *, iters: int = 2, seed: int = 0,
                      db: Any = None) -> Tuple[bool, Dict[str, float]]:
    """Measured A/B of the prefix-cache toggle on a shared-prefix replay of
    the profile's envelope (the workload the cache is built for): serve the
    same request batch with the cache on and off through a pinned Engine and
    keep the faster setting.  Ties break toward *on* — equal wall time with
    fewer prefill tokens computed is still a resource win (the paper's
    on-chip-reuse argument).  Models the cache cannot serve exactly (extra
    recurrent state) report ``off`` with no measurement."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import _state_entries
    from repro_torch.serving.scheduler import shared_prefix_requests
    prof = at.profile
    bs = at.block_size
    tdb = tunedb.open_db(db)
    key = _serving_key(at.cfg, prof, "prefix_cache", at.device,
                       pinned=_pinned_facts(at), iters=iters, seed=seed)
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    max_new = max(2, min(8, prof.max_seq_len // 8))
    # shared prefix: about half the envelope, block-aligned, plus a
    # one-block tail so the whole prompt lands exactly on a prompt bucket
    # (no left-padding — the workload must serve on pad-unsafe backends)
    prefix_len = min(prof.max_seq_len // 2,
                     prof.max_seq_len - max_new - bs) // bs * bs
    if prefix_len < bs:
        return False, {}          # envelope too small for any shared block
    tail_len = bs
    prompt_len = prefix_len + tail_len
    n = max(4, 2 * prof.batch_buckets[-1])
    cm = at.compile()
    ents = _state_entries(cm.plan)
    if any(not e.paged for e in ents):
        # recurrent / cross-attention per-request state: a token-prefix
        # match cannot seed it, the cache is off by construction
        return False, {}
    params = at.init_params(seed)
    reqs = shared_prefix_requests(n, at.cfg.vocab_size,
                                  prefix_len=prefix_len, tail_len=tail_len,
                                  max_new_tokens=max_new, seed=seed)
    buckets = tuple(sorted({prompt_len, prof.max_seq_len}))
    times: Dict[str, float] = {}
    for label, toggle in (("off", False), ("on", True)):
        eng = Engine(cm, params,
                     at.engine_config(prefix_cache=toggle,
                                      prompt_buckets=buckets))
        eng.run(reqs)                         # warm the tick programs
        ts = _timed_runs("autotune.prefix_cache", lambda: eng.run(reqs),
                         iters, warmup=0, mesh=at.mesh, toggle=toggle)
        times[label] = float(np.median(ts))
    best = bool(times["on"] <= times["off"])
    _db_bank(tdb, key, best, times)
    return best, times


def tune_speculation(at: DecodeAutotune, *, iters: int = 2, seed: int = 0,
                     db: Any = None
                     ) -> Tuple[Optional[str], Dict[str, float]]:
    """Measured A/B of speculative decoding on a decode-heavy shared-prefix
    replay (the prompt-lookup drafter's home turf: generations revisit the
    shared context): serve the same batch once per candidate ``draft_k``
    (0 = off, which keeps the already-tuned fori_seg) through a pinned
    Engine and keep the fastest.  Ties break toward the *larger* k — equal
    wall time with fewer host syncs per token.  Returns the winning
    ``"ngram:<k>"`` spec (or ``None``) plus the replay times.  Models whose
    per-request state is not fully paged report off with no measurement."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import _state_entries
    from repro_torch.serving.scheduler import shared_prefix_requests
    prof = at.profile
    bs = at.block_size
    tdb = tunedb.open_db(db)
    key = _serving_key(at.cfg, prof, "speculation", at.device,
                       pinned=_pinned_facts(at), iters=iters, seed=seed)
    hit = _db_served(tdb, key)
    if hit is not None:
        return hit
    ks = sorted({0, *prof.spec_ks})
    max_k = max(ks)
    if max_k == 0:
        return None, {}
    prefix_len = max(bs, prof.max_seq_len // 4 // bs * bs)
    tail_len = bs
    prompt_len = prefix_len + tail_len
    max_new = prof.max_seq_len - prompt_len
    if max_new < max_k + 1:
        return None, {}           # envelope too small for any verify cell
    cm = at.compile()
    if any(not e.paged for e in _state_entries(cm.plan)):
        # rollback truncates block chains; recurrent state can't express it
        return None, {}
    params = at.init_params(seed)
    n = max(4, 2 * prof.batch_buckets[-1])
    reqs = shared_prefix_requests(n, at.cfg.vocab_size,
                                  prefix_len=prefix_len, tail_len=tail_len,
                                  max_new_tokens=max_new, seed=seed)
    buckets = tuple(sorted({prompt_len, prof.max_seq_len}))

    def label(k):
        return f"ngram:{k}" if k else "off"

    times: Dict[str, float] = {}
    for k in ks:
        kw = {"speculation": f"ngram:{k}", "fori_seg": 0} if k else {}
        eng = Engine(cm, params,
                     at.engine_config(prompt_buckets=buckets, **kw))
        eng.run(reqs)                         # warm the tick programs
        ts = _timed_runs("autotune.speculation", lambda: eng.run(reqs),
                         iters, warmup=0, mesh=at.mesh, k=k)
        times[label(k)] = float(np.median(ts))
    best = min(sorted(ks, reverse=True), key=lambda k: times[label(k)])
    spec = f"ngram:{best}" if best else None
    _db_bank(tdb, key, spec, times)
    return spec, times


def tune_kernel_tiles(cfg: ModelConfig, profile: ServingProfile, *,
                      flow: Optional[FlowConfig] = None,
                      iters: int = 2, db: Any = None,
                      device: DeviceLike = None
                      ) -> Tuple[Tuple[Tuple[str, Any], ...],
                                 Dict[str, float]]:
    """Search *below* the plan level: per-kernel Hopper tiles declared via
    :attr:`KernelContract.tile_candidates` (flash attention's (bq, bk) at
    the cell's head width and the flow's precision, the conv's (bm, bn)).
    Each candidate tile is pinned through ``FlowConfig.tile_overrides``
    (the tiling pass applies it on top of its Hopper target), the cell is
    compiled for ``device`` and timed with ``cm.measure``, and the fastest
    tile per ``tile_key`` wins.

    Only ops the registry resolves to the ``cuda`` backend on ``device``
    are benched: the plain versions are tile-invariant, so on the CPU there
    is nothing to measure and the selector's tiles stand (``((), {})``, as
    the JAX package returns off the TPU).  Winners are banked and served
    again through ``db`` like every other microbench."""
    from repro_torch import flow as tflow
    from repro_torch.kernels.registry import REGISTRY
    dev = resolve_device(device)
    flow0 = flow if flow is not None else FlowConfig(mode="folded")
    tdb = tunedb.open_db(db)
    key = _serving_key(cfg, profile, "kernel_tiles", dev,
                       flow=tunedb.flow_facts(flow0), iters=iters)
    hit = _db_served(tdb, key)
    if hit is not None:
        best, times = hit
        return tuple(best), times
    B = profile.batch_buckets[-1]
    decode_shape = profile.shape_for(B)
    prefill_shape = ShapeConfig(f"{profile.name}_tiles_prefill",
                                "prefill", profile.max_seq_len, B)
    overrides: List[Tuple[str, Any]] = []
    times: Dict[str, float] = {}
    seen_keys = set()
    for op in REGISTRY.accelerated_ops():
        contract = REGISTRY.get(op, "cuda").contract
        if contract is None or contract.tile_key is None or \
                contract.tile_candidates is None:
            continue
        if contract.tile_key in seen_keys:
            continue
        if REGISTRY.resolve(op, "auto", dev.type) != "cuda":
            continue           # ref path: tile-invariant, nothing to bench
        seen_keys.add(contract.tile_key)
        shape = decode_shape if "decode" in contract.tile_key \
            else prefill_shape
        best_tile, best_t = None, float("inf")
        for tile in contract.tile_candidates(cfg, shape, flow0):
            f = dataclasses.replace(
                flow0, tile_overrides=((contract.tile_key, tile),))
            sp = TRACER.timed("autotune.kernel_tiles", cat="autotune",
                              op=op, tile=str(tile))
            cm = tflow.compile(cfg, shape, f, device=dev)
            t = float(cm.measure(iters=iters)["measured_step_s"])
            sp.end()
            times[f"{contract.tile_key}:{tile}"] = t
            if t < best_t:
                best_tile, best_t = tile, t
        if best_tile is not None:
            overrides.append((contract.tile_key, best_tile))
    best = tuple(overrides)
    _db_bank(tdb, key, best, times)
    return best, times


def autotune_decode(arch_or_cfg, *, profile: Optional[ServingProfile] = None,
                    base_flow: Optional[FlowConfig] = None,
                    mesh=None,
                    validate: str = "measure",
                    iters: int = 3,
                    smoke: bool = False,
                    tune_blocks: bool = True,
                    tune_prefix: Optional[bool] = None,
                    tune_chunks: bool = True,
                    tune_fori: Optional[bool] = None,
                    tune_spec: Optional[bool] = None,
                    tune_tiles: Optional[bool] = None,
                    use_cache: bool = True,
                    db: Any = None,
                    device: DeviceLike = None) -> DecodeAutotune:
    """Search the flow design space for each decode cell of the serving
    profile and return the pinnable result.

    ``validate``: ``"measure"`` (default) builds and times each top-k
    survivor (CUDA events on the card), ranking by measured step time;
    ``"compile"`` ranks by the deterministic estimator order and confirms
    footprints only (use for reproducible tuning decisions in CI);
    ``"none"`` skips validation (the estimator ranking alone — cheapest).
    ``mesh`` (a MeshSpec, an axis-size dict or a live DeviceMesh over the
    process group's ranks) makes the dp/tp/pp factorization part of each
    bucket's search (``dse.explore(devices=)``; under ``"measure"`` every
    survivor is timed on the mesh) and pins the result to the mesh: the
    compiled model and every engine replay run there (``Engine`` on the
    mesh), every rank running the same search.  ``tune_prefix`` A/Bs the prefix-cache toggle on a
    measured shared-prefix replay (default: only under
    ``validate="measure"`` — it times real engine runs).  ``tune_chunks``
    microbenchmarks the chunked-prefill catch-up width ``k`` (adopted only
    when the model's per-request state is fully paged — the Engine's own
    gate — and, under ``validate="measure"``, an engine replay serves it
    faster than chunked prefill off; otherwise the width stays 1);
    ``tune_fori`` A/Bs the host-free decode segment length on a
    decode-heavy replay (default: only under ``validate="measure"``, like
    ``tune_prefix``); ``tune_spec`` A/Bs speculative decoding (n-gram
    drafter, the profile's ``spec_ks``) on a shared-prefix replay under the
    same default; ``tune_tiles`` runs :func:`tune_kernel_tiles` (same
    default; no hand kernel declares tile candidates, so it finds nothing).
    The block and chunk benches run at the compute dtype of the pinned
    flow (bf16 for a bf16 flow: the kernel's ``mma`` schedule on the card).

    ``db`` (a :class:`repro_torch.tunedb.TuneDB` or a path; defaults to the
    base flow's ``tuning.tune_db``) makes the whole search persistent: each
    bucket's flow search and each microbench reads/writes the store, so a
    warm re-run with an unchanged profile measures nothing
    (``DecodeAutotune.n_measured`` reports what the flow searches paid).
    Everything runs on ``device`` (the card unless the caller asks for the
    CPU)."""
    from repro_torch.flow import _resolve_cfg
    if validate not in ("measure", "compile", "none"):
        raise ValueError(f"unknown validate mode {validate!r}")
    dev = resolve_device(device)
    cfg = _resolve_cfg(arch_or_cfg, smoke)
    profile = profile if profile is not None else ServingProfile()
    flow0 = base_flow if base_flow is not None else FlowConfig(mode="folded")
    tdb = tunedb.open_db(db if db is not None else flow0.tuning.tune_db)

    mesh_obj = None
    devices = 1
    if mesh is not None:
        from repro_torch.distributed.meshspec import MeshSpec
        spec = MeshSpec.of(mesh)
        mesh_obj = mesh if hasattr(mesh, "get_group") else spec.build(dev)
        devices = spec.size

    per_bucket: Dict[int, Any] = {}
    for bucket in profile.batch_buckets:
        shape = profile.shape_for(bucket)
        if validate == "measure":
            validator = dse.measure_validator(cfg, shape, mesh=mesh_obj,
                                              iters=iters, device=dev)
        elif validate == "compile":
            validator = dse.compile_validator(cfg, shape, device=dev)
        else:
            validator = None
        per_bucket[bucket] = dse.explore(
            cfg, shape, flow0, devices=devices, validator=validator,
            rank_measured=validate == "measure", use_cache=use_cache,
            db=tdb, device=dev)

    at = DecodeAutotune(cfg=cfg, profile=profile, per_bucket=per_bucket,
                        block_size=profile.block_sizes[0], device=dev,
                        mesh=mesh_obj)
    bench_dt = torch.bfloat16 if at.flow_for().precision == "bf16" \
        else torch.float32
    if tune_blocks:
        at.block_size, at.block_times_us = tune_block_size(
            cfg, profile, iters=iters, db=tdb, dtype=bench_dt, device=dev,
            mesh=mesh_obj)
    do_tiles = tune_tiles if tune_tiles is not None \
        else validate == "measure"
    if do_tiles:
        # below-plan tunables first: the engine replays that follow pin a
        # flow carrying the winning tile schedules
        at.tile_overrides, at.tile_times_s = tune_kernel_tiles(
            cfg, profile, flow=at.per_bucket[at.best_bucket].best.flow,
            iters=iters, db=tdb, device=dev)
    do_prefix = tune_prefix if tune_prefix is not None \
        else validate == "measure"
    if do_prefix:
        at.prefix_cache, at.prefix_times_s = tune_prefix_cache(at,
                                                               iters=iters,
                                                               db=tdb)
    if tune_chunks and cfg.attention is not None:
        chunk, chunk_times = tune_chunk_size(cfg, profile,
                                             block_size=at.block_size,
                                             iters=iters, db=tdb,
                                             dtype=bench_dt, device=dev,
                                             mesh=mesh_obj)
        at.chunk_times_us = chunk_times
        if chunk > 1 and validate == "measure":
            # the Engine's chunked paths require fully paged per-request
            # state (recurrent entries can't replay a chunk); honor its
            # gate, then let an engine replay decide
            from repro_torch.serving.kvcache import _state_entries
            if all(e.paged for e in _state_entries(at.compile().plan)):
                at.chunk_size, at.chunk_replay_s = _confirm_chunk(
                    at, chunk, iters=iters, db=tdb)
    do_fori = tune_fori if tune_fori is not None else validate == "measure"
    if do_fori:
        at.fori_seg, at.fori_times_s = tune_fori_seg(at, iters=iters, db=tdb)
    do_spec = tune_spec if tune_spec is not None else validate == "measure"
    if do_spec and cfg.attention is not None:
        at.speculation, at.spec_times_s = tune_speculation(
            at, iters=iters, db=tdb)
    return at
