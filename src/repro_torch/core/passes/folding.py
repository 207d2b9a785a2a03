"""PK — parameterized-kernel / folding pass (paper §IV-H).

Groups consecutive isomorphic blocks (equal structural signatures, including
repeating super-block patterns such as RecurrentGemma's (rec, rec, attn))
into scan units: one compiled body re-used across layers — the TPU analogue
of one parameterized OpenCL kernel executing many layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.graph import Graph, iso_groups
from repro_torch.core.passmanager import Pass, PlanContext


@dataclass(frozen=True)
class Unit:
    """One execution unit: either a single block or a folded scan group."""
    indices: tuple            # block indices in graph order
    period: int = 1           # super-block size (blocks per scan step)

    @property
    def folded(self) -> bool:
        return len(self.indices) > self.period

    @property
    def reps(self) -> int:
        return len(self.indices) // self.period


def run(graph: Graph, *, enabled: bool, min_reps: int = 2) -> List[Unit]:
    foldable = [i for i, b in enumerate(graph.blocks)
                if b.kind in ("layer", "encoder_layer", "decoder_layer",
                              "cnn_block")]
    units: List[Unit] = []
    i = 0
    n = len(graph.blocks)
    while i < n:
        if not enabled or i not in foldable:
            units.append(Unit((i,)))
            i += 1
            continue
        # find the contiguous foldable run starting here
        j = i
        while j < n and j in foldable:
            j += 1
        run_blocks = graph.blocks[i:j]
        for g, period in iso_groups(run_blocks):
            idxs = tuple(i + k for k in g)
            if len(idxs) // period >= min_reps and len(idxs) % period == 0:
                units.append(Unit(idxs, period))
            else:
                for k in idxs:
                    units.append(Unit((k,)))
        i = j
    return units


class FoldingPass(Pass):
    name = "folding"
    paper = "PK §IV-H"
    reads = ("graph", "stream")
    writes = ("units",)

    def run(self, ctx: PlanContext) -> None:
        stream = ctx.artifacts["stream"]      # runs after StreamingPass
        enabled = ctx.flow.fold_layers and stream.mode == "folded"
        units = run(ctx.graph, enabled=enabled)
        ctx.artifacts["units"] = units
        folded = [u for u in units if u.folded]
        ctx.stats[self.name] = {
            "applied": True, "enabled": enabled, "n_units": len(units),
            "n_folded": len(folded),
            "folded_blocks": sum(len(u.indices) for u in folded),
            "groups": [(u.reps, u.period) for u in folded],
        }

    def tunable_space(self, cfg, flow, shape):
        space = {"fold_layers": (True, False)}
        if shape.kind == "train":
            space["scan_unroll"] = flow.tuning.scan_unroll_candidates
        return space
