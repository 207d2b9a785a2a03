"""OF — optimized float operations (paper §IV-I).

``-fp-relaxed``/``-fpc`` let the AOC compiler reassociate float ops and fuse
multiply-accumulates.  The GPU analogue: bf16 storage/compute feeding the tensor
cores with fp32 accumulation, and bf16 parameters for serving.  The base configuration is straight fp32 — the unfused, unrelaxed
float pipeline of the base kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.passmanager import Pass, PlanContext


@dataclass(frozen=True)
class PrecisionPlan:
    compute_dtype: object
    param_dtype: object
    accum_dtype: object = torch.float32


def dtype_name(dt: torch.dtype) -> str:
    """numpy-style name of a torch dtype (``torch.bfloat16`` -> ``bfloat16``),
    the spelling the plan's stat lines share with the JAX package."""
    return str(dt).rsplit(".", 1)[-1]


def run(flow, shape) -> PrecisionPlan:
    if flow.precision == "bf16":
        # serving keeps bf16 weights; training keeps fp32 masters, bf16 compute
        pdt = torch.bfloat16 if shape.kind != "train" else torch.float32
        return PrecisionPlan(torch.bfloat16, pdt)
    return PrecisionPlan(torch.float32, torch.float32)


class PrecisionPass(Pass):
    name = "precision"
    paper = "OF §IV-I"
    reads = ("graph",)
    writes = ("prec",)

    def run(self, ctx: PlanContext) -> None:
        prec = run(ctx.flow, ctx.shape)
        ctx.artifacts["prec"] = prec
        ctx.stats[self.name] = {
            "applied": True,
            "compute": dtype_name(prec.compute_dtype),
            "param": dtype_name(prec.param_dtype),
            "accum": dtype_name(prec.accum_dtype),
        }

    def tunable_space(self, cfg, flow, shape):
        return {"precision": ("bf16", "fp32")}
