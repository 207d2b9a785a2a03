"""PassManager — the compilation flow's pass pipeline as a first-class,
pluggable subsystem.

The paper's flow applies a fixed sequence of optimizations (LF fusion, PK
folding, LU/LT tiling, OF precision, CW caching, CH/CE streaming); here each
one is a :class:`Pass` with a uniform protocol:

* ``name`` / ``paper``   — identity and the paper-section tag,
* ``applies_to``         — whether the pass participates for this
  (cfg, flow, shape) cell (a skipped pass is recorded in the trace),
* ``run(ctx)``           — reads/writes the shared :class:`PlanContext`,
  reporting its stats into ``ctx.stats[name]``,
* ``tunable_space``      — the pass's contribution to the design space the
  explorer (:mod:`repro_torch.core.dse`) searches: a dict mapping ``FlowConfig``
  field names to candidate values.

:class:`PassManager` threads a :class:`PlanContext` through the registered
passes with per-pass wall-clock timing and a trace, then assembles the
:class:`~repro_torch.core.plan.ExecutionPlan`.  ``build_plan`` is a thin wrapper
over :meth:`PassManager.default_pipeline`; custom pipelines (extra passes,
replaced passes, reordered passes) are built by constructing a manager with
any sequence of passes.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core.graph import Graph
from repro_torch.obs import TRACER


@dataclass
class PlanContext:
    """Mutable state threaded between passes: the graph under rewrite plus
    the artifacts each pass deposits for the final ExecutionPlan."""
    cfg: ModelConfig
    flow: FlowConfig
    shape: ShapeConfig
    mesh_axes: Tuple[str, ...] = ()
    rules: Any = None
    # device platform the plan targets ("cpu" | "cuda"): the kernels pass
    # resolves the "auto" backend policy against it
    platform: str = "cpu"
    graph: Optional[Graph] = None          # set by GraphBuildPass
    input_graph: Optional[Graph] = None    # caller-provided graph (optional)
    artifacts: Dict[str, Any] = field(default_factory=dict)
    stats: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    timings_ms: Dict[str, float] = field(default_factory=dict)
    trace: List[str] = field(default_factory=list)


class Pass:
    """Base class of all compilation passes (the uniform pass protocol)."""

    name: str = "?"
    paper: str = ""                        # paper-section tag, e.g. "LF §IV-C"
    # dataflow contract over PlanContext artifacts ("graph" stands for
    # ctx.graph): which keys run() consumes and which it deposits.  The
    # static verifier (repro_torch.analysis.verify_pipeline) orders-checks these
    # (P101 reader-before-writer, P102 required-artifact-never-written).
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()

    def applies_to(self, cfg: ModelConfig, flow: FlowConfig,
                   shape: ShapeConfig) -> bool:
        return True

    def run(self, ctx: PlanContext) -> None:
        raise NotImplementedError

    def tunable_space(self, cfg: ModelConfig, flow: FlowConfig,
                      shape: ShapeConfig) -> Dict[str, Tuple[Any, ...]]:
        """FlowConfig field -> candidate values this pass exposes to the DSE."""
        return {}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class GraphBuildPass(Pass):
    """Materialize the layer-graph IR the rest of the pipeline rewrites.

    A caller-provided graph is deep-copied (fusion mutates in place); without
    one the graph is built from the model config."""

    name = "graph"
    paper = "IR build (Relay analogue)"
    writes = ("graph",)

    def run(self, ctx: PlanContext) -> None:
        if ctx.input_graph is not None:
            ctx.graph = copy.deepcopy(ctx.input_graph)
        else:
            from repro_torch.models import build_graph
            ctx.graph = build_graph(ctx.cfg)
        ctx.stats[self.name] = {
            "applied": True,
            "blocks": len(ctx.graph.blocks),
            "ops": sum(len(b.ops) for b in ctx.graph.blocks),
            "params": ctx.graph.param_count(),
        }


class PassManager:
    """Runs a sequence of passes over a PlanContext and assembles the plan."""

    def __init__(self, passes: Sequence[Pass]):
        names = [p.name for p in passes]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate pass names: {names}")
        self.passes: List[Pass] = list(passes)

    # -- construction -------------------------------------------------------
    @classmethod
    def default_pipeline(cls) -> "PassManager":
        """The paper's pipeline: graph -> LF fusion -> CH/CE streaming ->
        PK folding -> LU/LT tiling -> OF precision -> CW caching."""
        from repro_torch.core.passes import default_passes
        return cls(default_passes())

    def replaced(self, pass_: Pass) -> "PassManager":
        """A new manager with the same-named pass swapped out."""
        return PassManager([pass_ if p.name == pass_.name else p
                            for p in self.passes])

    # -- execution ----------------------------------------------------------
    def run_context(self, cfg: ModelConfig, flow: FlowConfig,
                    shape: ShapeConfig, mesh_axes: Tuple[str, ...] = (),
                    rules=None, graph: Optional[Graph] = None,
                    platform: str = "cpu") -> PlanContext:
        ctx = PlanContext(cfg=cfg, flow=flow, shape=shape,
                          mesh_axes=tuple(mesh_axes), rules=rules,
                          platform=platform, input_graph=graph)
        for p in self.passes:
            if not p.applies_to(cfg, flow, shape):
                ctx.stats[p.name] = {"applied": False}
                ctx.trace.append(f"skip {p.name}")
                continue
            sp = TRACER.timed(f"pass.{p.name}", cat="pass", paper=p.paper)
            p.run(ctx)
            sp.end()
            dt_ms = sp.elapsed_ms
            ctx.timings_ms[p.name] = round(dt_ms, 3)
            ctx.stats.setdefault(p.name, {}).setdefault("applied", True)
            ctx.trace.append(f"run {p.name} [{p.paper}] {dt_ms:.2f}ms")
        return ctx

    def run(self, cfg: ModelConfig, flow: FlowConfig, shape: ShapeConfig,
            mesh_axes: Tuple[str, ...] = (), rules=None,
            graph: Optional[Graph] = None, platform: str = "cpu"):
        """Run the pipeline and assemble an ExecutionPlan."""
        from repro_torch.core.plan import ExecutionPlan
        ctx = self.run_context(cfg, flow, shape, mesh_axes, rules, graph,
                               platform)
        missing = [k for k in ("units", "tiles", "stream", "prec", "cache")
                   if k not in ctx.artifacts]
        if missing:
            raise ValueError(
                f"pipeline {[p.name for p in self.passes]} did not produce "
                f"required artifacts: {missing}")
        return ExecutionPlan(
            cfg, flow, shape, ctx.graph, ctx.artifacts["units"],
            ctx.artifacts["tiles"], ctx.artifacts["stream"],
            ctx.artifacts["prec"], ctx.artifacts["cache"], rules,
            sharding=ctx.artifacts.get("sharding"),
            kernels=ctx.artifacts.get("kernels", {}),
            platform=ctx.platform,
            pass_stats=ctx.stats, pass_timings_ms=ctx.timings_ms,
            trace=ctx.trace)

    # -- design space --------------------------------------------------------
    def tunable_space(self, cfg: ModelConfig, flow: FlowConfig,
                      shape: ShapeConfig) -> Dict[str, Tuple[Any, ...]]:
        """Union of the passes' tunable spaces (explorer input).  Every pass
        contributes regardless of ``applies_to`` — the explorer must be able
        to turn a currently-off pass *on* (each pass gates its own dims on
        cfg/shape applicability instead)."""
        space: Dict[str, Tuple[Any, ...]] = {}
        for p in self.passes:
            for key, vals in p.tunable_space(cfg, flow, shape).items():
                if key in space:
                    raise ValueError(
                        f"pass {p.name!r} re-declares tunable {key!r}")
                space[key] = tuple(vals)
        return space
