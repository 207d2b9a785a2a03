"""ExecutionPlan — the product of the compilation flow's pass pipeline.

The pipeline itself lives in :mod:`repro_torch.core.passmanager`;
``_build_plan`` runs ``PassManager.default_pipeline()`` for the public facade,
:func:`repro_torch.flow.compile`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core.graph import Graph
from repro_torch.core.passes import caching, precision, streaming
from repro_torch.core.passes.folding import Unit


@dataclass
class ExecutionPlan:
    cfg: ModelConfig
    flow: FlowConfig
    shape: ShapeConfig
    graph: Graph                     # post-fusion graph
    units: List[Unit]                # folding result (scan groups)
    tiles: Dict[str, Any]
    stream: streaming.StreamPlan
    prec: precision.PrecisionPlan
    cache: caching.CachingPlan
    rules: Optional[Any] = None      # ShardingRules (distributed runtime)
    # partitioning decisions (ShardingPass): mesh factorization, per-param
    # PartitionSpecs, pipeline-stage assignment
    sharding: Optional[Any] = None   # passes.sharding.ShardingPlan
    # per-op kernel-backend resolution (KernelSelectPass / KernelRegistry)
    kernels: Dict[str, str] = field(default_factory=dict)
    # device platform the plan was resolved for ("cpu" | "cuda")
    platform: str = "cpu"
    # pass-pipeline instrumentation (PassManager)
    pass_stats: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    pass_timings_ms: Dict[str, float] = field(default_factory=dict)
    trace: List[str] = field(default_factory=list)
    # set by repro_torch.analysis.verify_plan / flow.compile(verify=True);
    # an analysis.diagnostics.VerificationResult when the plan was verified
    verification: Optional[Any] = None

    @property
    def cache_len(self) -> int:
        """KV-cache length for serving: bounded by the attention window."""
        w = self.cfg.attention.window if self.cfg.attention else None
        c = self.shape.seq_len
        if w:
            c = min(c, w)
        return c

    def _stat_line(self, name: str) -> Optional[str]:
        st = self.pass_stats.get(name)
        if st is None:
            return None
        if not st.get("applied"):
            return f"    {name}: skipped"
        parts = []
        for k, v in st.items():
            if k == "applied":
                continue
            parts.append(f"{k}={v}")
        return f"    {name}: " + " ".join(parts)

    def describe(self, stats: bool = False) -> str:
        """Human-readable plan summary.  Deterministic for fixed inputs (no
        timings), so it doubles as the golden-snapshot format; ``stats=True``
        appends each pass's reported stats."""
        folded = [u for u in self.units if u.folded]
        lines = [
            f"plan[{self.cfg.name} x {self.shape.name}] mode={self.stream.mode}",
            f"  passes: fuse={self.flow.fuse_epilogues} fold={self.flow.fold_layers}"
            f" tiles={self.flow.tile_select} cw={self.flow.cached_writes}"
            f" prec={self.flow.precision}",
            f"  units: {len(self.units)} ({len(folded)} folded: " +
            ", ".join(f"{u.reps}x{u.period}" for u in folded) + ")",
            f"  tiles: {self.tiles}",
        ]
        if self.sharding is not None:
            lines.append(self.sharding.describe_line())
        if self.kernels:
            from repro_torch.kernels.registry import REGISTRY
            accel = [op for op in REGISTRY.accelerated_ops()
                     if op in self.kernels]
            lines.append(
                f"  kernels: backend={self.flow.kernel_backend} " +
                " ".join(f"{op}={self.kernels[op]}" for op in accel))
        if self.verification is not None:
            lines.append(f"  verify: {self.verification.summary_line()}")
        if stats:
            lines.append("  pass stats:")
            for name in self.pass_stats:
                line = self._stat_line(name)
                if line:
                    lines.append(line)
        return "\n".join(lines)


def _build_plan(cfg: ModelConfig, flow: FlowConfig, shape: ShapeConfig,
                mesh_axes: Tuple[str, ...] = (), rules=None,
                graph: Optional[Graph] = None,
                platform: str = "cpu") -> ExecutionPlan:
    """Run the default pass pipeline: build graph -> LF fusion -> CH/CE
    streaming -> PK folding -> LU/LT tiling -> OF precision -> CW caching ->
    kernel-backend selection for ``platform`` (``"cpu"`` | ``"cuda"``).
    Internal entry point — the public facade is
    :func:`repro_torch.flow.compile`."""
    from repro_torch.core.passmanager import PassManager
    return PassManager.default_pipeline().run(
        cfg, flow, shape, mesh_axes=mesh_axes, rules=rules, graph=graph,
        platform=platform)
