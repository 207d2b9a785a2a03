"""Kernel-backend selection pass (multi-backend lowering, DNNVM-style).

Resolves the flow's ``kernel_backend`` policy (``auto`` | ``reference`` |
``cuda``) against the :class:`KernelRegistry` for the plan's target platform
into a per-op backend table, recorded on the plan (``plan.kernels``) so lowering
dispatches through it, ``plan.describe()`` reports it, and the DSE can
search over it as a tunable dimension.
"""
from __future__ import annotations

from repro_torch.core.passmanager import Pass, PlanContext


class KernelSelectPass(Pass):
    name = "kernels"
    paper = "backend selection (multi-backend lowering)"
    writes = ("kernels",)

    def run(self, ctx: PlanContext) -> None:
        from repro_torch.kernels.registry import REGISTRY
        table = REGISTRY.resolve_all(ctx.flow.kernel_backend, ctx.platform)
        ctx.artifacts["kernels"] = table
        accel = sorted(op for op, b in table.items() if b != "ref")
        ctx.stats[self.name] = {
            "applied": True,
            "backend": ctx.flow.kernel_backend,
            "cuda_ops": accel,
            "ref_ops": sum(1 for b in table.values() if b == "ref"),
        }

    def tunable_space(self, cfg, flow, shape):
        # an explicitly pinned backend is a user constraint, not a search
        # dimension — only the default "auto" policy is explorable (so e.g.
        # compile(backend="reference", autotune=True) keeps the pin)
        if flow.kernel_backend != "auto":
            return {"kernel_backend": (flow.kernel_backend,)}
        return {"kernel_backend": flow.tuning.backend_candidates}
