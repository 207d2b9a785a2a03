"""Reference (plain-PyTorch) implementations of the CNN micro-ops.

Each op is a function ``fn(ctx, op, p, *args)`` where ``p`` maps param name →
tensor (names are the *last path component* of the ParamSpec name).  ``ctx``
carries the execution mode and the compilation plan.  The fused ops produced
by the fusion pass (epilogue attrs on ``matmul``/``conv2d``) are implemented
here too; the matmul and conv entry points dispatch through the
:mod:`repro_torch.kernels.registry` using the per-op backend table the
``kernels`` pass recorded on the plan (``plan.kernels``).

This is the CNN subset of the JAX package's ``core/ops_impl.py``; the LM ops
arrive with the LM slice.  Every dtype cast sits where the JAX op puts it,
so bf16 rounds at the same places in both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d import same_pads
from repro_torch.kernels.registry import plan_kernel


# ---------------------------------------------------------------------------
# Execution context
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """Execution context.  The CNN slice runs the stateless prefill mode;
    decode state, aux losses and sharding hooks join with later slices."""
    mode: str                        # prefill (train | decode: later slices)
    plan: Any                        # ExecutionPlan

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.plan.flow.precision == "bf16" \
            else torch.float32


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    return {
        "gelu": lambda v: F.gelu(v, approximate="tanh"),
        "silu": F.silu,
        "relu": F.relu,
        "relu2": lambda v: torch.square(F.relu(v)),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "identity": lambda v: v,
    }[kind](x)


# ---------------------------------------------------------------------------
# Dense / elementwise ops
# ---------------------------------------------------------------------------

def _matmul_backend(ctx: Ctx, x, w, *, bias=None, act=None, w2=None):
    """Single entry point for all (possibly fused) matmuls; routes to the
    CUDA kernel when the plan's backend table selects it."""
    kern = plan_kernel(ctx.plan, "glu_matmul" if w2 is not None else "matmul",
                       x=x, w=w)
    if kern is not None:
        return kern(x, w, bias=bias, act=act, w2=w2,
                    tile=ctx.plan.tiles.get("matmul"),
                    out_dtype=ctx.compute_dtype)
    dt = ctx.compute_dtype
    xf = x.to(dt).float()
    y = torch.matmul(xf, w.to(dt).float())
    if w2 is not None:  # fused GLU pair: act(x@w) * (x@w2)
        y2 = torch.matmul(xf, w2.to(dt).float())
        y = _act(y, act or "silu") * y2
        act = None
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = _act(y, act)
    return y.to(dt)


def op_matmul(ctx: Ctx, op, p, x, *extra):
    vals = list(p.values())
    w = vals[0]
    bias = vals[1] if op.attrs.get("bias") else None
    y = _matmul_backend(ctx, x, w, bias=bias, act=op.attrs.get("act"))
    if op.attrs.get("residual"):
        y = (y.float() + extra[0].float()).to(y.dtype)
    return y


def op_glu_matmul(ctx: Ctx, op, p, x):
    vals = list(p.values())
    return _matmul_backend(ctx, x, vals[0], w2=vals[1],
                           act=op.attrs.get("act", "silu"))


def op_bias_add(ctx: Ctx, op, p, x):
    (b,) = p.values()
    return (x.float() + b.float()).to(x.dtype)


def op_act(ctx: Ctx, op, p, x):
    return _act(x, op.attrs["kind"])


def op_add(ctx: Ctx, op, p, a, b):
    return (a.float() + b.float()).to(ctx.compute_dtype)


def op_identity(ctx: Ctx, op, p, x):
    return x


def op_image_in(ctx: Ctx, op, p, h):
    return h.to(ctx.compute_dtype)


# ---------------------------------------------------------------------------
# CNN ops
# ---------------------------------------------------------------------------

def _conv_ref(x, w, stride: int, padding: str, groups: int):
    """lax.conv_general_dilated in NHWC x HWIO with XLA's SAME split (the
    odd extra row/column on the high side), via an explicit pad."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        pt, pb = same_pads(x.shape[1], kh, stride)
        pl, pr = same_pads(x.shape[2], kw, stride)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _conv_backend(ctx: Ctx, x, w, *, stride, padding, groups=1,
                  bn=None, act=None):
    kern = plan_kernel(ctx.plan, "conv2d", groups=groups)
    if kern is not None:
        return kern(x, w, stride=stride, padding=padding, bn=bn, act=act,
                    tile=ctx.plan.tiles.get("conv2d"))
    dt = ctx.compute_dtype
    # the JAX reference upcasts bf16 operands and accumulates in fp32
    cdt = torch.float32 if dt == torch.bfloat16 else dt
    y = _conv_ref(x.to(cdt), w.to(cdt), stride, padding, groups).float()
    if bn is not None:
        scale, bias, mean, var = bn
        inv = torch.rsqrt(var.float() + 1e-5)
        y = (y - mean.float()) * (inv * scale.float()) + bias.float()
    if act:
        y = _act(y, act)
    return y.to(dt)


def _bn_params(p):
    def g(suf):
        return next(v for k, v in p.items() if k.endswith(suf))
    return (g("_scale"), g("_bias"), g("_mean"), g("_var"))


def op_conv2d(ctx: Ctx, op, p, x):
    w = next(v for k, v in p.items() if k.endswith("_w"))
    bn = _bn_params(p) if op.attrs.get("bn") else None
    return _conv_backend(ctx, x, w, stride=op.attrs.get("stride", 1),
                         padding=op.attrs.get("padding", "SAME"),
                         bn=bn, act=op.attrs.get("act"))


def op_depthwise_conv2d(ctx: Ctx, op, p, x):
    w = next(v for k, v in p.items() if k.endswith("_w"))
    C = x.shape[-1]
    kh, kw, _, _ = w.shape
    wg = w.reshape(kh, kw, 1, C)
    bn = _bn_params(p) if op.attrs.get("bn") else None
    return _conv_backend(ctx, x, wg, stride=op.attrs.get("stride", 1),
                         padding=op.attrs.get("padding", "SAME"), groups=C,
                         bn=bn, act=op.attrs.get("act"))


def op_batchnorm(ctx: Ctx, op, p, x):
    scale, bias, mean, var = _bn_params(p)
    inv = torch.rsqrt(var.float() + op.attrs.get("eps", 1e-5))
    y = (x.float() - mean.float()) * (inv * scale.float()) + bias.float()
    return y.to(ctx.compute_dtype)


def _pool(x, window: int, stride: int, kind: str):
    """lax.reduce_window over NHWC with SAME padding in fp32: the pad is
    -inf (max) or 0 (avg), split as XLA splits it, and the average divides
    by window² — the padding counts."""
    xf = x.float()
    pt, pb = same_pads(xf.shape[1], window, stride)
    pl, pr = same_pads(xf.shape[2], window, stride)
    xf = F.pad(xf.permute(0, 3, 1, 2), (pl, pr, pt, pb),
               value=-float("inf") if kind == "max" else 0.0)
    if kind == "max":
        y = F.max_pool2d(xf, window, stride)
    else:
        y = F.avg_pool2d(xf, window, stride)
    return y.permute(0, 2, 3, 1)


def op_maxpool2d(ctx: Ctx, op, p, x):
    return _pool(x, op.attrs["window"], op.attrs["stride"], "max").to(x.dtype)


def op_avgpool2d(ctx: Ctx, op, p, x):
    return _pool(x, op.attrs["window"], op.attrs["stride"], "avg").to(x.dtype)


def op_global_avgpool(ctx: Ctx, op, p, x):
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def op_flatten(ctx: Ctx, op, p, x):
    return x.reshape(x.shape[0], -1)


OPS: Dict[str, Callable] = {
    "matmul": op_matmul, "glu_matmul": op_glu_matmul, "bias_add": op_bias_add,
    "act": op_act, "add": op_add, "identity": op_identity,
    "image_in": op_image_in, "conv2d": op_conv2d,
    "depthwise_conv2d": op_depthwise_conv2d, "batchnorm": op_batchnorm,
    "maxpool2d": op_maxpool2d, "avgpool2d": op_avgpool2d,
    "global_avgpool": op_global_avgpool, "flatten": op_flatten,
}
