"""CH/AR/CE — streaming / execution-mode pass (paper §IV-E/F/G).

Decides between the paper's two execution modes and the host-side (here:
launcher-side) concurrency knobs:

* **pipelined** — every layer materialized as its own program section
  (unrolled), activations streamed between them; on a multi-pod mesh the
  layers are additionally assigned to pipeline *stages* over the ``pp_axis``
  with microbatched ``ppermute`` streaming (OpenCL channels ↔ ICI links;
  channel depth ↔ in-flight microbatches).  Viable for small networks, just
  as on the FPGA.
* **folded** — isomorphic groups are scanned (PK), the default for deep nets.

AR (autorun) has no separate artifact: every step is a single jitted,
donated-state program, host-free by construction; the decode loop runs
on-device.  CE (concurrent execution) corresponds to compute/collective
overlap, which the launcher enables via XLA latency-hiding flags recorded
here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.passmanager import Pass, PlanContext


PIPELINE_PARAM_LIMIT = 100_000_000   # "fits on chip unrolled" heuristic


@dataclass(frozen=True)
class StreamPlan:
    mode: str                        # folded | pipelined
    pp_axis: Optional[str]
    n_stages: int
    microbatches: int
    stage_boundaries: Tuple[int, ...]   # block index where each stage starts
    xla_overlap_flags: Tuple[str, ...] = (
        "--xla_tpu_enable_data_parallel_all_reduce_opt=true",
        "--xla_tpu_overlap_compute_collective_tc=true",
        "--xla_enable_async_all_gather=true",
        "--xla_enable_async_collective_permute=true",
    )


def run(graph, cfg, flow, mesh_axes: Tuple[str, ...] = ()) -> StreamPlan:
    if flow.mode == "auto":
        small = graph.param_count() < PIPELINE_PARAM_LIMIT or cfg.n_layers <= 8
        mode = "pipelined" if small else "folded"
    else:
        mode = flow.mode
    split = dict(flow.mesh_split) if flow.mesh_split else {}
    known_axes = set(mesh_axes) | set(split)
    pp = flow.pp_axis if flow.pp_axis in known_axes else None
    n_stages = 1
    boundaries: Tuple[int, ...] = (0,)
    if pp is not None:
        # split layer blocks evenly over the pp axis (stage per pod); the
        # stage count comes from the flow's mesh factorization when known
        n_stages = split.get(pp, 2)
        layer_idx = [i for i, b in enumerate(graph.blocks)
                     if b.kind.endswith("layer") or b.kind == "cnn_block"]
        per = max(1, len(layer_idx) // n_stages)
        boundaries = tuple(layer_idx[min(i * per, len(layer_idx) - 1)]
                           for i in range(n_stages)) if layer_idx else (0,)
    mb = max(flow.microbatches, n_stages if pp else flow.microbatches)
    return StreamPlan(mode, pp, n_stages, mb, boundaries)


class StreamingPass(Pass):
    name = "streaming"
    paper = "CH/AR/CE §IV-E–G"
    reads = ("graph",)
    writes = ("stream",)

    def run(self, ctx: PlanContext) -> None:
        sp = run(ctx.graph, ctx.cfg, ctx.flow, ctx.mesh_axes)
        ctx.artifacts["stream"] = sp
        ctx.stats[self.name] = {"applied": True, "mode": sp.mode,
                                "n_stages": sp.n_stages,
                                "microbatches": sp.microbatches,
                                "pp_axis": sp.pp_axis}

    def tunable_space(self, cfg, flow, shape):
        if shape.kind != "train":
            return {}
        # gradient-accumulation microbatches trade activation transients
        # against one extra round of weight gathers per microbatch
        return {"microbatches": flow.tuning.microbatch_candidates}
