"""CW — cached-writes pass (paper §IV-D).

On the FPGA, accumulations were moved from DDR read-modify-write into local
registers with a final copy-out stage.  On the TPU the kernel analogue is the
fp32 VMEM scratch accumulator in the fused matmul/conv kernels: partial sums
live in VMEM across the K grid dimension and HBM is written exactly once at
the last K step.  This pass records that policy for the kernel layer and for
the estimator's HBM-byte model; with ``cached_writes`` off the kernels use
the naive read-modify-write schedule (one HBM round-trip per K step) — the
paper's base behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.passmanager import Pass, PlanContext


@dataclass(frozen=True)
class CachingPlan:
    vmem_accumulate: bool      # accumulate in VMEM scratch (True = CW on)
    donate_state: bool = True  # donate KV/optimizer buffers (in-place update)


def run(flow) -> CachingPlan:
    return CachingPlan(vmem_accumulate=flow.cached_writes)


class CachingPass(Pass):
    name = "caching"
    paper = "CW §IV-D"
    reads = ("graph",)
    writes = ("cache",)

    def run(self, ctx: PlanContext) -> None:
        cp = run(ctx.flow)
        ctx.artifacts["cache"] = cp
        ctx.stats[self.name] = {"applied": True,
                                "vmem_accumulate": cp.vmem_accumulate,
                                "donate_state": cp.donate_state,
                                "remat": ctx.flow.remat}

    def tunable_space(self, cfg, flow, shape):
        space = {"cached_writes": (True, False)}
        if shape.kind == "train":
            # remat is the training-side memory-for-compute cache policy
            space["remat"] = ("block", "nested", "none")
        return space
