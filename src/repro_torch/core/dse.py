"""Estimator-guided design-space explorer (the paper leaves DSE to future
work — built here).

The paper's §IV-J factor selection: count MACCs to predict DSP usage (cheap,
analytic), then confirm the survivors with hours of place & route.  The same
split, grown into a real explorer over the whole pass pipeline:

1. **Space** — every pass in ``PassManager.default_pipeline()`` exposes its
   tunable dimensions (fusion on/off, fold on/off, scan unroll, tile budget,
   CE chunk, microbatches, remat mode, precision, cached writes).
2. **Prune** — each candidate ``FlowConfig`` is scored with the analytic
   cost model in :mod:`repro_torch.core.estimator`: roofline step time
   (rule 1, the bandwidth roof) and per-device HBM footprint vs the budget
   (rule 3).  Tiles honour rule 2 (even division) by construction.
3. **Validate** — the top-k survivors are confirmed: our "place & route" is
   one measured step on the card (:func:`compile_candidate`: the peak of
   ``torch.cuda.max_memory_allocated``) or a timed one
   (:func:`measure_validator`: :meth:`CompiledModel.measure`, CUDA events)
   — seconds per candidate instead of hours.

**The device decides the space, the preset and the budget.**  Every
search runs for one device (``device=``; the card unless the caller asks
for the CPU, as every entry point of the port).  On the CPU the space is
the JAX package's, the estimator ranks under the ``v5e`` preset and the
budget is ``FlowConfig.tuning.hbm_bytes``, or v5e's 16 GiB when that is
``None`` (the default): the same candidates, rankings and winners as the
JAX package, which the CPU tests hold it to.  On the card the space leaves
out the knob that changes no launch there (:data:`TILE_KNOBS`), the estimator
ranks under the ``h100`` preset and a ``None`` budget is the card's own
memory (``total_memory``), so a full-width cell that fits 80 GB is not
pruned for missing 16 GiB; a budget the caller set is kept on both.  The
device's key (``"cuda:<card name>"`` or ``"cpu:cpu"``) is part of every
fingerprint, in the process cache and in the tunedb, so neither answers
for the other.

``explore()`` is deterministic: same (cfg, shape, base flow, devices,
device) in, same chosen plan out.  A validator that fails raises: a kernel
that does not build or launch is never recorded as a slow candidate.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tunedb
from repro_torch.configs.base import (FlowConfig, ModelConfig, ShapeConfig,
                                      TuningConfig)
from repro_torch.core import estimator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import METRICS, TRACER

# the CPU's default budget: v5e's memory, the JAX package's default; set
# FlowConfig.tuning.hbm_bytes to override (see :func:`budget_bytes`)
HBM_BYTES = int(estimator.DEVICE_PRESETS["v5e"]["hbm_bytes"])


def preset_for(device: torch.device) -> str:
    """The estimator's device preset for a search on ``device``: ``h100``
    on the card, ``v5e`` (the JAX package's default) on the CPU."""
    return "h100" if device.type == "cuda" else "v5e"


def budget_bytes(tuning: TuningConfig, device: torch.device) -> int:
    """Rule 3's budget for a search on ``device``: ``tuning.hbm_bytes``,
    or when that is ``None`` the device's memory: the card's own on the
    card, :data:`HBM_BYTES` (v5e's) on the CPU."""
    if tuning.hbm_bytes is not None:
        return tuning.hbm_bytes
    if device.type == "cuda":
        return estimator.h100_hbm_bytes(device)
    return HBM_BYTES


def per_device_bytes(mem: Dict[str, int]) -> int:
    """Per-device footprint of one step from its memory record (the
    dry-run's ``memory``: ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``alias_bytes``): arguments + outputs + temporaries -
    the outputs written into donated arguments, the JAX package's
    ``argument + output + temp - alias`` — the one definition the dry-run
    and its validator use."""
    return (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Candidate:
    flow: FlowConfig
    knobs: Tuple[Tuple[str, Any], ...]   # the tunables this candidate sets
    footprint_bytes: float
    step_s: float
    bound: str                           # compute | memory
    fits: bool                           # rule 3: footprint < budget

    def knob_str(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.knobs)


@dataclass
class ExploreResult:
    best: Candidate
    plan: Any                            # ExecutionPlan of the chosen flow
    candidates: List[Candidate]          # estimator-ranked (pruned) list
    n_enumerated: int
    validated: List[Dict[str, Any]]      # compile-in-the-loop measurements
    budget_bytes: int
    n_rejected: int = 0                  # uneven-shard candidates screened out
    n_static_pruned: int = 0             # statically-invalid candidates the
                                         # verifier dropped before any compile
    n_measured: int = 0                  # validator invocations this search
                                         # actually paid (0 on a tunedb hit)
    tunedb_status: Optional[str] = None  # None (no db) | "hit" | "transfer"
                                         # | "cold"

    def describe(self) -> str:
        c = self.best
        lines = [
            f"dse[{self.plan.cfg.name} x {self.plan.shape.name}] "
            f"enumerated={self.n_enumerated} rejected={self.n_rejected} "
            f"static_pruned={self.n_static_pruned} "
            f"pruned_to={len(self.candidates)} "
            f"validated={len(self.validated)}"
            + (f" tunedb={self.tunedb_status} measured={self.n_measured}"
               if self.tunedb_status else ""),
            f"  budget: {self.budget_bytes / 2 ** 30:.1f} GiB/device",
            f"  best: {c.knob_str()}",
            f"  est: footprint={c.footprint_bytes / 2 ** 30:.3f} GiB "
            f"step={c.step_s * 1e3:.3f} ms ({c.bound}-bound) fits={c.fits}",
        ]
        for v in self.validated:
            extra = (f" step={v['measured_step_s'] * 1e3:.3f}ms"
                     if "measured_step_s" in v else "")
            lines.append(
                f"  measured[{v['knobs']}]: "
                f"{v['per_device_bytes'] / 2 ** 30:.3f} GiB/device "
                f"fits={v['fits']}{extra}")
        return "\n".join(lines)


# The TilingPass's knob that changes no launch on the card.  The hand
# kernels take their blocks from ``plan.tiles`` (the tiling pass's Hopper
# target), so ``tile_select`` (selected or minimal tiles) stays in the
# card's space.  ``vmem_budget_bytes`` only bounds a kernel's shared-memory
# allowance, min(227 KiB, budget // 4): at its candidates (96 and 48 MiB,
# 24 and 12 MiB a kernel) the 227 KiB a block may opt in to binds first,
# so two candidates that differ in it run the same program there.
# Searched on the CPU, where the space is the JAX package's; fixed at the
# base flow's value on the card.
TILE_KNOBS = ("vmem_budget_bytes",)


def tunable_space(cfg: ModelConfig, flow: FlowConfig, shape: ShapeConfig,
                  device: DeviceLike = None) -> Dict[str, Tuple[Any, ...]]:
    """The joint design space all passes expose for this cell, less the
    knobs ``device`` (the card unless the caller asks for the CPU) does not
    honour: :data:`TILE_KNOBS` on the card.  The space is data, so asking
    for the card's needs no card."""
    from repro_torch.core.passmanager import PassManager
    space = PassManager.default_pipeline().tunable_space(cfg, flow, shape)
    if torch.device("cuda" if device is None else device).type == "cuda":
        for k in TILE_KNOBS:
            space.pop(k, None)
    return space


def enumerate_candidates(cfg: ModelConfig, shape: ShapeConfig,
                         base_flow: FlowConfig,
                         space: Optional[Dict[str, Sequence[Any]]] = None,
                         device: DeviceLike = None,
                         ) -> List[Tuple[FlowConfig, Tuple[Tuple[str, Any], ...]]]:
    """Cartesian product of the tunable space applied over ``base_flow``,
    in deterministic order (preferred/default value of each knob first)."""
    space = space if space is not None else \
        tunable_space(cfg, base_flow, shape, device)
    keys = sorted(space)
    out = []
    cap = base_flow.tuning.max_candidates
    for combo in itertools.islice(
            itertools.product(*(space[k] for k in keys)), cap):
        knobs = tuple(zip(keys, combo))
        out.append((dataclasses.replace(base_flow, **dict(knobs)), knobs))
    return out


# ---------------------------------------------------------------------------
# compile-in-the-loop validation ("place & route" in seconds)
# ---------------------------------------------------------------------------

def abstract_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Fake stand-ins for one cell's whole batch on ``device`` (the card
    unless told otherwise), made under the active ``FakeTensorMode`` or a
    new one: shapes and dtypes, nothing allocated (the JAX package's
    ``ShapeDtypeStruct``s).  Images (and labels) for a CNN; tokens (and
    labels) for an LM, one token a row on a decode shape; a multimodal
    model's ``patches`` and an encoder-decoder's ``frames`` off decode."""
    from repro_torch.core.lowering import fake_mode
    dev = torch.device("cuda" if device is None else device)
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    with fake_mode():
        def t(*shp, dtype=torch.int64):
            return torch.empty(shp, dtype=dtype, device=dev)
        if cfg.family == "cnn":
            out = {"images": t(B, cfg.image_size, cfg.image_size,
                               cfg.image_channels, dtype=torch.float32)}
            if shape.kind == "train":
                out["labels"] = t(B)
            return out
        out = {"tokens": t(B, S)}
        if shape.kind == "train":
            out["labels"] = t(B, S)
        if shape.kind != "decode":
            if cfg.n_patch_tokens:
                out["patches"] = t(B, cfg.n_patch_tokens, cfg.d_vision,
                                   dtype=torch.float32)
            if cfg.n_encoder_layers:
                out["frames"] = t(B, cfg.encoder_seq, cfg.d_model,
                                  dtype=torch.float32)
        return out


def _tree_bytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def compile_candidate(cfg: ModelConfig, shape: ShapeConfig,
                      flow: FlowConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Build one candidate and report its per-device footprint.  On the card
    the CompiledModel runs its shape's stage once after a warm-up call
    (:meth:`CompiledModel.measure` with one timed call) and the footprint is
    the peak of ``torch.cuda.max_memory_allocated`` over it (weights, state
    and transients) less what was allocated before the candidate was built;
    on the CPU nothing runs and the footprint is the estimator's.
    ``bytes_source`` says which."""
    from repro_torch import flow as tflow
    dev = resolve_device(device)
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        cm = tflow.compile(cfg, shape, flow, device=dev)
        rec = cm.measure(iters=1)
        return {"per_device_bytes": int(rec["peak_bytes"]) - base,
                "bytes_source": "max_memory_allocated"}
    fp = estimator.estimate_footprint(cfg, shape, flow)["total"]
    return {"per_device_bytes": int(fp), "bytes_source": "estimator"}


def compile_validator(cfg: ModelConfig, shape: ShapeConfig,
                      device: DeviceLike = None
                      ) -> Callable[[FlowConfig], Dict]:
    """Validator for :func:`explore` backed by :func:`compile_candidate`.
    Records no time, so :func:`explore` keeps the estimator's order."""
    return lambda flow: compile_candidate(cfg, shape, flow, device)


def measure_validator(cfg: ModelConfig, shape: ShapeConfig, *,
                      mesh=None, iters: int = 3, device: DeviceLike = None
                      ) -> Callable[[FlowConfig], Dict]:
    """Measured-time validator (``repro_torch.flow.compile(validate=
    "measure")``): compiles each candidate into a CompiledModel and times
    its shape-appropriate stage with :meth:`CompiledModel.measure` (CUDA
    events on the card, the wall clock on the CPU).  The returned records
    carry ``measured_step_s``, so :func:`explore` (with
    ``rank_measured=True``) ranks the fitting survivors by real step time;
    ``per_device_bytes`` is the timed calls' peak of allocated memory on the
    card less what was allocated beside the candidate, the estimator's
    footprint on the CPU.  Weights come from seed 0
    (``measure``'s default).  A candidate is timed on ``mesh`` (a live
    DeviceMesh) or, when it proposes a ``mesh_split`` of its own, on that
    mesh, built over the ranks of the process group: every rank runs the
    same search, and ``measure`` keeps the slowest rank's times, so every
    rank picks the same winner."""
    dev = resolve_device(device)
    last: Dict[Any, Any] = {}         # the weights of the last candidate

    def validate(flow: FlowConfig) -> Dict[str, Any]:
        from repro_torch import flow as tflow
        from repro_torch.distributed.meshspec import MeshSpec
        m = mesh
        if m is None and flow.mesh_split is not None:
            # mesh-search mode: each candidate is timed on the mesh it
            # proposes, not as an unsharded single-device program
            m = MeshSpec.of(flow.mesh_split).build(dev)
        cm = tflow.compile(cfg, shape, flow, mesh=m, device=dev)
        params = None
        if shape.kind != "train":
            # serving candidates with the same parameter tree (most differ
            # only in knobs that leave the weights alone) share one draw
            # from seed 0; a train step updates its weights, so each train
            # candidate draws its own
            sig = (repr(sorted(cm.param_shapes().items())),
                   cm.plan.prec.param_dtype, flow.mesh_split)
            if sig not in last:
                last.clear()
                last[sig] = cm.init_params(0)
            params = last[sig]
        # the candidate's own bytes: the peak less what else is allocated
        # (earlier work's tensors; not the shared weights, which are its)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if params is not None and dev.type == "cuda":
            base -= _tree_bytes(params)
        rec = dict(cm.measure(iters=iters, params=params))
        if rec.get("peak_bytes") is not None:
            rec["per_device_bytes"] = int(rec["peak_bytes"]) - base
            rec["bytes_source"] = "max_memory_allocated"
        else:
            rec["per_device_bytes"] = int(estimator.estimate_footprint(
                cfg, shape, flow)["total"])
            rec["bytes_source"] = "estimator"
        return rec
    return validate


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------

# Completed searches keyed by (cfg, shape, flow, devices, platform, top_k,
# space) fingerprint — ``--autotune`` across serve/train/dryrun in one
# process pays for each identical search once (ROADMAP "explorer caching
# across cells").  Bounded LRU: one entry per cfg×shape×flow×mesh×space
# searched would otherwise grow without bound in a long-lived process.
_EXPLORE_CACHE: "OrderedDict[Tuple, ExploreResult]" = OrderedDict()
_EXPLORE_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_EXPLORE_CACHE_LIMIT = 64


def set_explore_cache_limit(n: int) -> None:
    """Bound the process-level explore cache to ``n`` results (LRU
    eviction; default 64).  ``n <= 0`` disables caching entirely."""
    global _EXPLORE_CACHE_LIMIT
    _EXPLORE_CACHE_LIMIT = int(n)
    while len(_EXPLORE_CACHE) > max(_EXPLORE_CACHE_LIMIT, 0):
        _EXPLORE_CACHE.popitem(last=False)
        _EXPLORE_CACHE_STATS["evictions"] += 1
        METRICS.counter("dse.cache.evictions").inc()


def _cache_get(fp_key: Tuple) -> Optional[ExploreResult]:
    hit = _EXPLORE_CACHE.get(fp_key)
    if hit is not None:
        _EXPLORE_CACHE.move_to_end(fp_key)
        _EXPLORE_CACHE_STATS["hits"] += 1
        METRICS.counter("dse.cache.hits").inc()
    else:
        _EXPLORE_CACHE_STATS["misses"] += 1
        METRICS.counter("dse.cache.misses").inc()
    return hit


def _cache_put(fp_key: Tuple, result: ExploreResult) -> None:
    if _EXPLORE_CACHE_LIMIT <= 0:
        return
    _EXPLORE_CACHE[fp_key] = result
    _EXPLORE_CACHE.move_to_end(fp_key)
    while len(_EXPLORE_CACHE) > _EXPLORE_CACHE_LIMIT:
        _EXPLORE_CACHE.popitem(last=False)
        _EXPLORE_CACHE_STATS["evictions"] += 1
        METRICS.counter("dse.cache.evictions").inc()


def _platform_key(device: torch.device) -> str:
    """``"cuda:<card name>"`` or ``"cpu:cpu"`` for the search's device.
    Part of every fingerprint (in-process cache AND persisted tunedb
    records): a search on one device must never serve a result measured on
    the other."""
    return tunedb.device_key(device)


def _explore_fingerprint(cfg: ModelConfig, shape: ShapeConfig,
                         flow: FlowConfig, devices: int,
                         top_k: Optional[int],
                         space: Optional[Dict[str, Sequence[Any]]],
                         validate_tag: str, platform: str) -> Tuple:
    space_key = None if space is None else tuple(
        sorted((k, tuple(v)) for k, v in space.items()))
    # cfg/shape/flow are frozen dataclasses (hashable); kernel_backend AND
    # the mesh topology (flow.mesh_split + tuning.mesh_devices, normalized
    # by explore() before fingerprinting) are part of flow, so a backend or
    # mesh change in-process misses the cache as required.  ``platform``
    # carries the device's backend *and* kind (the card's name).
    # ``validate_tag`` ("none" | "compile" | "measure") keeps
    # estimator-only results from answering for validated searches and
    # compile-validated ones from answering for measured-time searches.
    return (cfg, shape, flow, devices, platform, top_k, space_key,
            validate_tag)


def explore_cache_stats() -> Dict[str, int]:
    return dict(_EXPLORE_CACHE_STATS)


def clear_explore_cache() -> None:
    _EXPLORE_CACHE.clear()
    _EXPLORE_CACHE_STATS.update(hits=0, misses=0, evictions=0)


# ---------------------------------------------------------------------------
# persistent tunedb integration (repro_torch.tunedb)
# ---------------------------------------------------------------------------

def _explore_db_key(cfg: ModelConfig, shape: ShapeConfig, flow: FlowConfig,
                    devices: int, top_k: Optional[int],
                    space: Optional[Dict[str, Sequence[Any]]],
                    validate_tag: str, platform: str) -> Dict[str, Any]:
    """The structured (JSON-safe) twin of :func:`_explore_fingerprint` for
    persisted records — same facts, same poisoning fixes (platform/device
    kind included)."""
    space_enc = None if space is None else {
        k: tuple(v) for k, v in sorted(space.items())}
    return {"cfg": tunedb.config_facts(cfg),
            "shape": tunedb.shape_facts(shape),
            "flow": tunedb.flow_facts(flow),
            "devices": devices, "platform": platform, "top_k": top_k,
            "space": space_enc, "validate": validate_tag}


def _stale_record_warning(reason: str) -> None:
    """Surface a persisted record that no longer verifies against the
    current plan as a T601 diagnostic (warning severity: the search simply
    falls back to measuring) — the analysis-layer vocabulary for it."""
    from repro_torch.analysis import Diagnostic, WARNING
    diag = Diagnostic("T601", WARNING, reason, where="tunedb")
    warnings.warn(diag.format(), stacklevel=3)


def _serve_exact_hit(rec, cfg: ModelConfig, shape: ShapeConfig,
                     flow0: FlowConfig, pool: List[Candidate],
                     platform: str
                     ) -> Optional[Tuple[Candidate, List[Dict[str, Any]]]]:
    """Reconstruct (winner, validated) from an exact-fingerprint record
    without measuring anything.  Returns None — after a T601 warning — when
    the stored winner no longer verifies against the current plan space
    (knob vanished, plan now statically invalid, candidate no longer
    enumerated), in which case the caller re-measures."""
    try:
        knobs = tuple((k, v) for k, v in
                      tunedb.decode_value(rec.value["best_knobs"]))
        best_flow = dataclasses.replace(flow0, **dict(knobs))
    except (KeyError, TypeError, ValueError) as e:
        _stale_record_warning(
            f"record {rec.fingerprint[:12]} winner knobs no longer apply "
            f"to FlowConfig ({e}); re-measuring")
        return None
    best = next((c for c in pool if c.flow == best_flow), None)
    if best is None:
        _stale_record_warning(
            f"record {rec.fingerprint[:12]} winner "
            f"[{' '.join(f'{k}={v}' for k, v in knobs)}] is no longer an "
            "enumerated candidate of the current search space; re-measuring")
        return None
    from repro_torch.analysis import verify_plan as _verify_plan
    from repro_torch.core.plan import _build_plan as _bp
    result = _verify_plan(_bp(cfg, best.flow, shape, platform=platform))
    if not result.ok:
        _stale_record_warning(
            f"record {rec.fingerprint[:12]} winner plan fails static "
            f"verification under the current code "
            f"({result.summary_line()}); re-measuring")
        return None
    validated = [dict(v) for v in tunedb.decode_value(
        rec.value.get("validated", []))]
    return best, validated


def _transfer_anchor(pool: List[Candidate], neighbor) -> Dict[str, float]:
    """Per-knob anchor ratios from a neighboring record: the neighbor's
    *measured* step time over its *estimated* step time, keyed by knob
    string.  Multiplying this cell's estimates by the ratio re-anchors the
    estimator ranking with transferred measurements — before any compile."""
    est_nb = tunedb.decode_value(neighbor.value.get("est_by_knobs", {}))
    ratios: Dict[str, float] = {}
    for v in tunedb.decode_value(neighbor.value.get("validated", [])):
        ks = v.get("knobs")
        t = v.get("measured_step_s")
        e = est_nb.get(ks)
        if ks and t and e:
            ratios[ks] = float(t) / float(e)
    return ratios


def explore(cfg: ModelConfig, shape: ShapeConfig,
            base_flow: Optional[FlowConfig] = None, *,
            devices: int = 1,
            mesh: Optional[Any] = None,
            validator: Optional[Callable[[FlowConfig], Dict]] = None,
            space: Optional[Dict[str, Sequence[Any]]] = None,
            top_k: Optional[int] = None,
            rank_measured: bool = False,
            use_cache: bool = True,
            db: Any = None,
            device: DeviceLike = None) -> ExploreResult:
    """Search the joint pass design space for the fastest candidate that
    fits the device budget.

    The mesh is a search dimension: with ``devices > 1`` (or ``mesh=``) the
    ShardingPass exposes every dp/tp/pp factorization of the device count as
    ``mesh_split`` candidates, and candidates whose splits would produce
    uneven shards are rejected before scoring (the paper's even-division
    rule, across devices).  An explicit ``mesh`` (MeshSpec / axis-size dict)
    pins the factorization instead, like a pinned kernel backend.  A
    :func:`measure_validator` times each mesh candidate on its own mesh.

    Before any scoring, the static verifier screens the space: candidates
    whose flow knobs hold values no pass or registry accepts (F501) are
    dropped, and each top-k survivor's *plan* is verified
    (:func:`repro_torch.analysis.verify_plan`, the plan ``device`` would
    run) before the validator pays a compile for it — both counted in
    ``ExploreResult.n_static_pruned``.

    Estimator scoring (roofline + footprint + the mesh's communication cost)
    prunes the full space; the top-k survivors are validated when a
    ``validator`` is given (see :func:`compile_validator` and
    :func:`measure_validator`).  With ``rank_measured=True`` every top-k
    survivor is validated and the fitting one with the smallest
    ``measured_step_s`` wins (measured-time ranking); otherwise the first
    fitting survivor wins.  Without a validator the estimator ranking
    decides alone.

    Identical searches (same cfg/shape/base-flow/devices/platform/
    mesh-topology fingerprint) are served from a bounded process-level LRU
    cache — including their recorded validations — so repeated
    ``--autotune`` invocations in one process don't redo the sweep.
    ``use_cache=False`` forces a fresh search.

    ``db`` (a :class:`repro_torch.tunedb.TuneDB` or a path; defaults to
    ``flow0.tuning.tune_db``) adds the *persistent* layer: an
    exact-fingerprint record serves the winner with **zero** measurements,
    and when only a neighboring cell was tuned (same model/flow/device,
    different batch bucket or seq rung) its measurements re-anchor the
    estimator ranking so at most half the usual top-k survivors are
    compiled (``ExploreResult.tunedb_status`` / ``n_measured`` report the
    outcome).  Every validated search is written back to the store.

    ``device`` (the card unless the caller asks for the CPU) picks the
    space, the estimator's preset and the budget (see the module's
    docstring) and keys the cache and the store.
    """
    dev = resolve_device(device)
    flow0 = base_flow if base_flow is not None else FlowConfig(mode="folded")
    if mesh is not None:
        from repro_torch.distributed.meshspec import MeshSpec
        spec = MeshSpec.of(mesh)
        devices = spec.size
        if flow0.mesh_split is None:
            flow0 = dataclasses.replace(flow0, mesh_split=spec.axes)
    if devices > 1 and flow0.tuning.mesh_devices != devices:
        # the ShardingPass reads the device count off the tuning config to
        # enumerate mesh factorizations; folding it into the flow also folds
        # the topology into the cache fingerprint
        flow0 = dataclasses.replace(
            flow0, tuning=dataclasses.replace(flow0.tuning,
                                              mesh_devices=devices))
    validate_tag = "none" if validator is None else \
        ("measure" if rank_measured else "compile")
    platform = _platform_key(dev)
    fp_key = _explore_fingerprint(cfg, shape, flow0, devices, top_k, space,
                                  validate_tag, platform)
    if use_cache:
        hit = _cache_get(fp_key)
        if hit is not None:
            return hit
    tdb = tunedb.open_db(db if db is not None else flow0.tuning.tune_db)
    db_key = db_fp = None
    if tdb is not None:
        db_key = _explore_db_key(cfg, shape, flow0, devices, top_k, space,
                                 validate_tag, platform)
        db_fp = tunedb.fingerprint(db_key)
    tuning = flow0.tuning
    budget = budget_bytes(tuning, dev)
    preset = preset_for(dev)
    k = top_k if top_k is not None else tuning.top_k

    from repro_torch.analysis.rules import flow_knob_rejection
    from repro_torch.core.passes.sharding import split_rejection_reason
    sp_enum = TRACER.timed("dse.enumerate", cat="dse", arch=cfg.name,
                           devices=devices)
    enumerated = enumerate_candidates(cfg, shape, flow0, space=space,
                                      device=dev)
    sp_enum.end(n=len(enumerated))
    # static knob screen (F501): a flow holding a value no pass or registry
    # accepts would crash the builder or the compiler — drop it before any
    # plan is built.  Unlike the mesh screen this is never readmitted.
    n_static_pruned = 0
    statically_valid = []
    for flow, knobs in enumerated:
        if flow_knob_rejection(flow) is not None:
            n_static_pruned += 1
            continue
        statically_valid.append((flow, knobs))
    if not statically_valid and enumerated:
        reasons = sorted({r for r in (flow_knob_rejection(f)
                                      for f, _ in enumerated) if r})
        raise ValueError("explore: every candidate failed the static flow "
                         "screen: " + "; ".join(reasons))
    # the divisibility screen applies to *searched* splits only: a pinned
    # mesh (compile(mesh=...)) is a given — the solver simply leaves axes it
    # cannot use unsharded, exactly as the launch wiring always did
    searching = flow0.mesh_split is None
    survivors = []
    n_rejected = 0
    for flow, knobs in statically_valid:
        if searching and flow.mesh_split is not None and \
                split_rejection_reason(cfg, shape, flow, flow.mesh_split):
            n_rejected += 1            # uneven shards never survive pruning
            continue
        survivors.append((flow, knobs))
    if not survivors and statically_valid:
        # every split was screened out (e.g. a CNN whose batch doesn't cover
        # the device count).  The screen is advisory, not fatal: the solver
        # leaves axes it cannot use unsharded, so any split still compiles —
        # readmit everything and let the estimator ranking decide.
        survivors, n_rejected = statically_valid, 0
    cands: List[Candidate] = []
    sp_est = TRACER.timed("dse.estimate", cat="dse", n=len(survivors))
    for flow, knobs in survivors:
        fp = estimator.estimate_footprint(cfg, shape, flow, devices)
        st = estimator.estimate_step_seconds(cfg, shape, flow, devices,
                                             device=preset)
        cands.append(Candidate(flow, knobs, fp["total"], st["step_s"],
                               st["bound"], fp["total"] < budget))
    sp_est.end()
    fitting = [c for c in cands if c.fits]
    # stable sorts: enumeration order (defaults first) breaks ties.  When
    # nothing fits analytically, footprint (closest to fitting) leads.
    if fitting:
        pool = sorted(fitting, key=lambda c: (c.step_s, c.footprint_bytes))
    else:
        pool = sorted(cands, key=lambda c: (c.footprint_bytes, c.step_s))
    top = pool[:max(k, 1)]

    validated: List[Dict[str, Any]] = []
    best = top[0]
    n_measured = 0
    tunedb_status: Optional[str] = None if tdb is None else "cold"
    served = None
    if tdb is not None:
        sp_db = TRACER.timed("tunedb.lookup", cat="tunedb", kind="explore")
        rec = tdb.get(db_fp)
        if rec is not None:
            served = _serve_exact_hit(rec, cfg, shape, flow0, pool,
                                      dev.type)
        sp_db.end(hit=served is not None)
        if served is not None:
            # exact-fingerprint hit: the persisted winner and its recorded
            # measurements stand in for the whole validation phase — zero
            # candidates measured
            best, validated = served
            tunedb_status = "hit"
            METRICS.counter("tunedb.hits").inc()
        else:
            METRICS.counter("tunedb.misses").inc()
    if served is None and validator is not None:
        top_v = top
        if tdb is not None:
            # warm start: the nearest record that agrees on everything but
            # the shape cell (same op shapes via cfg, different batch
            # bucket / seq rung) re-anchors the estimator ranking with its
            # measured/estimated ratios; only the anchored best half of the
            # usual top-k then pays a compile
            match = {kk: vv for kk, vv in db_key.items() if kk != "shape"}

            def _dist(r) -> float:
                s = r.key.get("shape", {})
                return (abs(math.log2(max(int(s.get("global_batch", 1)), 1))
                            - math.log2(max(shape.global_batch, 1)))
                        + abs(math.log2(max(int(s.get("seq_len", 1)), 1))
                              - math.log2(max(shape.seq_len, 1))))

            nbs = tdb.neighbors("explore", match, exclude=db_fp,
                                distance=_dist)
            if nbs:
                ratios = _transfer_anchor(pool, nbs[0])
                anchored = [c for c in top if c.knob_str() in ratios]
                if anchored:
                    anchored.sort(key=lambda c:
                                  (c.step_s * ratios[c.knob_str()],
                                   c.footprint_bytes))
                    top_v = anchored[:max(1, len(top) // 2)]
                    tunedb_status = "transfer"
                    METRICS.counter("tunedb.transfers").inc()
        from repro_torch.analysis import verify_plan as _verify_plan
        from repro_torch.core.plan import _build_plan as _bp
        chosen = None
        chosen_t = float("inf")
        for c in top_v:
            # plan-level static gate: build (cheap, milliseconds) and verify
            # before paying a compile — an invalid plan never reaches the
            # validator
            if not _verify_plan(_bp(cfg, c.flow, shape,
                                    platform=dev.type)).ok:
                n_static_pruned += 1
                continue
            sp_val = TRACER.timed("dse.validate", cat="dse",
                                  knobs=c.knob_str())
            r = dict(validator(c.flow))
            sp_val.end()
            n_measured += 1
            r["knobs"] = c.knob_str()
            r["fits"] = bool(r["per_device_bytes"] < budget)
            validated.append(r)
            if not r["fits"]:
                continue
            if rank_measured:
                t = float(r.get("measured_step_s", float("inf")))
                if t < chosen_t:
                    chosen, chosen_t = c, t
                continue           # measured ranking needs every survivor
            chosen = c
            break                  # first fitting candidate wins; don't pay
                                   # further compiles for report decoration
        best = chosen if chosen is not None else top_v[0] if top_v else top[0]
    if served is None and tdb is not None:
        # bank this search: the winner's knobs, every recorded measurement,
        # and the estimator's predictions for the validated set (the anchor
        # a neighboring bucket's warm start divides by)
        tdb.put(tunedb.TuneRecord.make(
            "explore", db_key,
            {"best_knobs": best.knobs,
             "validated": validated,
             "est_by_knobs": {c.knob_str(): c.step_s for c in top},
             "n_enumerated": len(enumerated),
             "winner_step_s": best.step_s},
            device=platform))

    from repro_torch.core.plan import _build_plan
    plan = _build_plan(cfg, best.flow, shape, platform=dev.type)
    result = ExploreResult(best=best, plan=plan, candidates=pool,
                           n_enumerated=len(enumerated), validated=validated,
                           budget_bytes=budget, n_rejected=n_rejected,
                           n_static_pruned=n_static_pruned,
                           n_measured=n_measured, tunedb_status=tunedb_status)
    if use_cache:
        _cache_put(fp_key, result)
    return result


# ---------------------------------------------------------------------------
# mesh-level train-cell autotune (the dry-run's)
# ---------------------------------------------------------------------------

def autotune_train_cell(arch: str, shape_name: str, mesh, base_flow,
                        candidates: Optional[Tuple[int, ...]] = None,
                        hbm_bytes: Optional[int] = None):
    """Returns (flow, record) for the first microbatch count whose dry-run
    per-device footprint (:func:`repro_torch.launch.dryrun.run_cell` on
    ``mesh``) fits the budget — ``hbm_bytes``, else the flow's
    (:func:`budget_bytes` for the card) — or the last one tried when none
    fits.  Runs where the dry-run runs: on its fake process group."""
    from repro_torch.launch.dryrun import run_cell
    budget = hbm_bytes if hbm_bytes is not None else \
        budget_bytes(base_flow.tuning, torch.device("cuda"))
    cands = candidates if candidates is not None else \
        base_flow.tuning.microbatch_candidates
    last = None
    for mb in cands:
        flow = dataclasses.replace(base_flow, microbatches=mb)
        r = run_cell(arch, shape_name, mesh=mesh, flow=flow)
        r["autotuned_microbatches"] = mb
        last = (flow, r)
        if r["memory"]["per_device_bytes"] < budget:
            return flow, r
    return last
