"""The declarative checker suite behind
:func:`repro_torch.analysis.verify_plan`.

Each checker is a generator ``(plan, ecfg) -> Iterator[Diagnostic]`` over one
contract family; ``verify_plan`` runs them all against a built
:class:`~repro_torch.core.plan.ExecutionPlan` *without launching anything* and
returns the collected :class:`VerificationResult`.  Heavy imports stay
inside the checker bodies so importing :mod:`repro_torch.analysis` (which
the serving constructors do) never drags in the kernel modules.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Set, Tuple

from repro_torch.analysis import rules
from repro_torch.analysis.diagnostics import (ERROR, WARNING, Diagnostic,
                                        VerificationResult)

# every key the kernel layer or a pass reads out of ``plan.tiles``
_TILE_KEYS = ("matmul", "attention", "decode_attention", "conv2d",
              "wkv_chunk", "ce_chunk")


# ---------------------------------------------------------------------------
# cross-pass contracts (X)
# ---------------------------------------------------------------------------


def check_graph(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X007 — the graph IR's SSA discipline (the assertions ``validate``
    makes fatal, surfaced as a diagnostic instead)."""
    try:
        plan.graph.validate()
    except AssertionError as e:
        yield Diagnostic("X007", ERROR, str(e), where="graph")


def check_units(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X001 — folding units must partition the graph's block indices
    exactly once (a lost or doubled block silently drops/repeats layers)."""
    seen: List[int] = []
    for u in plan.units:
        seen.extend(u.indices)
    want = list(range(len(plan.graph.blocks)))
    if sorted(seen) != want:
        missing = sorted(set(want) - set(seen))
        dup = sorted({i for i in seen if seen.count(i) > 1})
        extra = sorted(set(seen) - set(want))
        yield Diagnostic(
            "X001", ERROR,
            f"units cover blocks {sorted(set(seen))} of {len(want)}: "
            f"missing={missing} duplicated={dup} out_of_range={extra}",
            where="folding")


def _hopper_kernels():
    from repro_torch.kernels import attention, conv2d, matmul_fused
    return {"matmul": matmul_fused, "attention": attention,
            "conv2d": conv2d}


def check_tiles(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X002 — rule 2 (even division): selected tile dims divide their
    problem dims, so no prologue/epilogue grid steps exist.  On a card plan
    the hand kernels mask their edges and need no even division: there
    X002 holds the matmul, attention and conv2d tiles to those the kernels
    take (each module's ``TILES``) and a pinned decode_attention chunk to
    ``decode_attention.check_tile`` at the plan's batch and cache; whether
    a taken tile's working set fits is K202's.  X008 — the tile table only
    carries keys some kernel or pass consumes."""
    cfg, shape, tiles = plan.cfg, plan.shape, plan.tiles
    for key in tiles:
        if key not in _TILE_KEYS:
            yield Diagnostic(
                "X008", ERROR,
                f"tile entry {key!r} has no consumer (known: "
                f"{list(_TILE_KEYS)})", where="tiling", op=key)
    if plan.platform == "cuda":
        for key, mod in _hopper_kernels().items():
            tile = tiles.get(key)
            if tile is None:
                continue
            try:
                mod.check_tile(tile)
            except (TypeError, ValueError) as e:
                yield Diagnostic("X002", ERROR, f"{key} tile {tile}: {e}",
                                 where="tiling", op=key)
        from repro_torch.kernels import decode_attention as kd
        a = cfg.attention
        chunk = kd.pinned(tiles.get("decode_attention"))
        if a is not None and chunk is not None:
            try:
                kd.check_tile(chunk, shape.global_batch, plan.cache_len,
                              a.n_kv_heads, a.n_heads // a.n_kv_heads,
                              a.head_dim, plan.prec.compute_dtype)
            except ValueError as e:
                yield Diagnostic("X002", ERROR,
                                 f"decode_attention tile {chunk}: {e}",
                                 where="tiling", op="decode_attention")
        return
    if not plan.flow.tile_select:
        return          # base flow: fixed minimal tiles, kernels pad
    seq = shape.seq_len if shape.kind != "decode" else 1
    m = max(seq, 8)
    dims = {"matmul": (("m", m), ("k", cfg.d_model), ("n", cfg.d_ff))}
    if cfg.attention is not None:
        dims["attention"] = (("q", max(seq, 8)), ("kv", shape.seq_len))
    for key, named in dims.items():
        tile = tiles.get(key)
        if tile is None:
            continue
        for (dim_name, dim), t in zip(named, tile):
            if t < 1 or dim % t != 0:
                yield Diagnostic(
                    "X002", ERROR,
                    f"{key} tile {tile}: block {dim_name}={t} does not "
                    f"divide problem dim {dim_name}={dim}",
                    where="tiling", op=key)


def check_stream(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X003 — the stream plan's stage layout stays inside the graph."""
    sp = plan.stream
    n_blocks = len(plan.graph.blocks)
    if sp.mode not in ("folded", "pipelined"):
        yield Diagnostic("X003", ERROR, f"unknown mode {sp.mode!r}",
                         where="streaming")
    if sp.n_stages < 1 or sp.microbatches < 1:
        yield Diagnostic(
            "X003", ERROR,
            f"n_stages={sp.n_stages} microbatches={sp.microbatches} "
            "must both be >= 1", where="streaming")
    bounds = tuple(sp.stage_boundaries)
    if not bounds or any(b < 0 or b >= n_blocks for b in bounds) \
            or list(bounds) != sorted(bounds):
        yield Diagnostic(
            "X003", ERROR,
            f"stage_boundaries {bounds} must be non-empty, ascending and "
            f"within [0, {n_blocks})", where="streaming")


def _iter_param_shapes(plan: Any) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(param key, shape) exactly as the ShardingPass/lowering name them."""
    from repro_torch.core.lowering import unit_key
    graph = plan.graph
    for unit in plan.units:
        ukey = unit_key(graph, unit)
        if not unit.folded:
            for s in graph.blocks[unit.indices[0]].param_specs():
                yield f"{ukey}/{s.name}", tuple(s.shape)
        else:
            for j in range(unit.period):
                for s in graph.blocks[unit.indices[j]].param_specs():
                    yield f"{ukey}/{j}:{s.name}", \
                        (unit.reps,) + tuple(s.shape)


def check_sharding(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X004/X005 — every recorded PartitionSpec names mesh axes that exist
    and whose size product divides the sharded dim (uneven shards fail at
    run time; this catches them at plan time)."""
    sp = plan.sharding
    if sp is None:
        return
    axis_sizes = sp.axis_sizes
    shapes = dict(_iter_param_shapes(plan))
    for key, pspec in sp.param_specs.items():
        shape = shapes.get(key)
        for i, entry in enumerate(pspec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            unknown = [a for a in axes if a not in axis_sizes]
            if unknown:
                yield Diagnostic(
                    "X005", ERROR,
                    f"param {key!r} dim {i} names axes {unknown} missing "
                    f"from mesh {sorted(axis_sizes)}",
                    where="sharding", op=key)
                continue
            size = 1
            for a in axes:
                size *= axis_sizes[a]
            if shape is not None and i < len(shape) and shape[i] % size != 0:
                yield Diagnostic(
                    "X004", ERROR,
                    f"param {key!r} dim {i} of size {shape[i]} not "
                    f"divisible by axes {axes} (= {size})",
                    where="sharding", op=key)


def check_kernel_table(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """X006 — the plan's kernel table references ops/backends the registry
    knows.  K201 — a cuda resolution must have a registered impl (a ``ref``
    resolution always has one: ops outside the reference table carry their
    fallback inline at the call site)."""
    from repro_torch.kernels.registry import REGISTRY
    known_ops = set(REGISTRY.ops())
    for op, backend in plan.kernels.items():
        if op not in known_ops:
            yield Diagnostic(
                "X006", ERROR,
                f"kernel table references unknown op {op!r}",
                where="kernels", op=op)
            continue
        if backend not in ("ref", "cuda"):
            yield Diagnostic(
                "X006", ERROR,
                f"op {op!r} resolved to unknown backend {backend!r}",
                where="kernels", op=op)
            continue
        if backend != "ref" and not REGISTRY.has(op, backend):
            yield Diagnostic(
                "K201", ERROR,
                f"op {op!r} resolved to {backend!r} but no such impl is "
                f"registered (have: {REGISTRY.backends(op)})",
                where="kernels", op=op)


# ---------------------------------------------------------------------------
# kernel contracts (K)
# ---------------------------------------------------------------------------


def check_kernel_contracts(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """The declared :class:`~repro_torch.kernels.registry.KernelContract` of
    every cuda-resolved impl, evaluated against the plan:

    * K202 — the shared memory a block of the hand kernel asks for at the
      plan's calls (the schedule ``_schedule`` picks) fits the 227 KiB a
      block may opt in to, or ``flow.vmem_budget_bytes`` if that is smaller
      (the worst call an op, one diagnostic an op);
    * K203 — state donation only reaches donation-safe kernels,
    * K204 — capability predicates that reject on static facts (op attrs /
      cfg) mean a silent dispatch-time fall-through to ref: surfaced as a
      warning with the impl's machine-readable reason.
    """
    from repro_torch.kernels.registry import REGISTRY
    from repro_torch.kernels.workingset import BLOCK_SHARED
    budget = min(BLOCK_SHARED, plan.flow.vmem_budget_bytes)
    for op, backend in plan.kernels.items():
        if backend != "cuda" or not REGISTRY.has(op, backend):
            continue
        contract = REGISTRY.get(op, backend).contract
        if contract is None:
            continue
        if contract.workingset is not None:
            try:
                calls = contract.workingset(plan, ecfg)
            except ValueError:
                calls = []      # a tile no kernel takes: X002 reports it
            if calls:
                call, sched, ws = max(calls, key=lambda c: c[2])
                if ws > budget:
                    yield Diagnostic(
                        "K202", ERROR,
                        f"{op} [{call}] on {sched} asks for {ws} B of shared "
                        f"memory a block, over the budget of {budget} B",
                        where=op)
        if plan.cache.donate_state and not contract.donation_safe:
            yield Diagnostic(
                "K203", ERROR,
                f"{op} declares itself unsafe under donated state but the "
                "plan donates state (cache.donate_state=True)",
                where=op)
    # static capability rejection: walk the ops the model actually executes
    seen: Set[Tuple[str, str]] = set()
    for block in plan.graph.blocks:
        for mop in block.ops:
            backend = plan.kernels.get(mop.op)
            if backend != "cuda" or not REGISTRY.has(mop.op, backend):
                continue
            contract = REGISTRY.get(mop.op, backend).contract
            if contract is None or contract.static_reject is None:
                continue
            reason = contract.static_reject(mop.attrs, plan.cfg)
            if reason and (mop.op, reason) not in seen:
                seen.add((mop.op, reason))
                yield Diagnostic(
                    "K204", WARNING,
                    f"{mop.op} will fall back to ref at dispatch: {reason}",
                    where=mop.op, op=block.name)


# ---------------------------------------------------------------------------
# mesh-split divisibility (M)
# ---------------------------------------------------------------------------


def check_mesh(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """M401–M403 — the even-division screen over the flow's mesh split.
    Warnings, not errors: a pinned uneven split still compiles (the solver
    leaves axes it cannot use unsharded), but it wastes devices."""
    split = plan.flow.mesh_split
    if not split:
        return
    hit = rules.mesh_split_rejection(plan.cfg, plan.shape, plan.flow, split)
    if hit is not None:
        code, reason = hit
        yield Diagnostic(code, WARNING, reason, where="sharding")


# ---------------------------------------------------------------------------
# serving invariants (S) + pool bounds (K205)
# ---------------------------------------------------------------------------


def check_serving(plan: Any, ecfg: Any = None) -> Iterator[Diagnostic]:
    """S301–S307/K205 — the EngineConfig envelope against the shared rules
    (only when an engine config is being verified alongside the plan)."""
    if ecfg is None:
        return
    where = "serving"
    sp = getattr(ecfg, "speculation", None)
    for code, msg in (
            ("S306", rules.chunk_in_range(ecfg.chunk_size, ecfg.max_seq_len)),
            ("S303", rules.fori_seg_valid(ecfg.fori_seg)),
            ("S302", rules.chunk_ladder(ecfg.chunk_buckets, ecfg.chunk_size)),
            ("S304", rules.batch_ladder(ecfg.batch_buckets, ecfg.max_batch)),
            ("S305", rules.prompt_ladder(ecfg.prompt_buckets,
                                         ecfg.max_seq_len)),
            ("S301", rules.block_divides_buckets(ecfg.block_size,
                                                 ecfg.prompt_buckets)),
            ("S307", rules.speculation_valid(
                sp.kind, sp.draft_k, sp.draft_cfg, ecfg.max_seq_len,
                ecfg.fori_seg) if sp is not None else None),
    ):
        if msg is not None:
            yield Diagnostic(code, ERROR, msg, where=where)
    msg = rules.pool_admits_full_slot(ecfg.num_blocks, ecfg.blocks_per_slot)
    if msg is not None:
        yield Diagnostic("K205", ERROR, msg,
                         where="paged_decode_attention")


CHECKERS = (check_graph, check_units, check_tiles, check_stream,
            check_sharding, check_kernel_table, check_kernel_contracts,
            check_mesh, check_serving)


# ---------------------------------------------------------------------------
# pass-pipeline ordering (P)
# ---------------------------------------------------------------------------

_REQUIRED_ARTIFACTS = ("graph", "units", "tiles", "stream", "prec", "cache")


def verify_pipeline(manager: Any) -> VerificationResult:
    """Static ordering check over a :class:`PassManager`: every pass declares
    the plan artifacts it reads/writes; a reader scheduled before its writer
    (P101), or a pipeline that never produces a required artifact (P102), is
    flagged before the pipeline ever runs."""
    res = VerificationResult(n_checks=2)
    written: Set[str] = set()
    for p in manager.passes:
        for key in p.reads:
            if key not in written:
                res.diagnostics.append(Diagnostic(
                    "P101", ERROR,
                    f"pass {p.name!r} reads {key!r} but no earlier pass "
                    f"writes it (written so far: {sorted(written)})",
                    where=p.name, op=key))
        written |= set(p.writes)
    for key in _REQUIRED_ARTIFACTS:
        if key not in written:
            res.diagnostics.append(Diagnostic(
                "P102", ERROR,
                f"pipeline {[p.name for p in manager.passes]} never writes "
                f"required artifact {key!r}",
                where="pipeline", op=key))
    return res


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_plan(plan: Any, cfg: Any = None, shape: Any = None,
                flow: Any = None, *, ecfg: Any = None,
                pipeline: Any = None) -> VerificationResult:
    """Run every checker over ``plan`` without compiling; returns the
    structured diagnostic list.  ``cfg``/``shape``/``flow`` default to the
    plan's own (they exist as overrides so a caller can verify a plan
    against the cell it is *about* to be used for); ``ecfg`` adds the
    serving-invariant checkers; ``pipeline`` adds the pass-ordering check
    for a custom :class:`PassManager`."""
    import dataclasses as _dc
    if cfg is not None or shape is not None or flow is not None:
        plan = _dc.replace(plan) if _dc.is_dataclass(plan) else plan
        if cfg is not None:
            plan.cfg = cfg
        if shape is not None:
            plan.shape = shape
        if flow is not None:
            plan.flow = flow
    res = VerificationResult()
    for checker in CHECKERS:
        res.n_checks += 1
        res.diagnostics.extend(checker(plan, ecfg))
    if pipeline is not None:
        sub = verify_pipeline(pipeline)
        res.n_checks += sub.n_checks
        res.diagnostics.extend(sub.diagnostics)
    return res


def verify_engine_config(plan: Any, ecfg: Any) -> VerificationResult:
    """Serving-only verification: the plan's checkers plus the EngineConfig
    envelope (S-codes, pool bounds)."""
    return verify_plan(plan, ecfg=ecfg)


def static_flow_diagnostics(cfg: Any, shape: Any,
                            flow: Any) -> List[Diagnostic]:
    """The DSE's pre-plan screen: flow-knob validity (F501).  Cheap enough
    to run on every enumerated candidate — no graph build, no passes."""
    out: List[Diagnostic] = []
    msg = rules.flow_knob_rejection(flow)
    if msg is not None:
        out.append(Diagnostic("F501", ERROR, msg, where="flow"))
    return out
