"""Reference (plain-PyTorch) implementations of the ported micro-ops.

Each op is a function ``fn(ctx, op, p, *args)`` where ``p`` maps param name →
tensor (names are the *last path component* of the ParamSpec name).  ``ctx``
carries the execution mode, the decode state and the compilation plan.  The
fused ops produced by the fusion pass (``glu_matmul``, epilogue attrs on
``matmul``/``conv2d``) are implemented here too; the matmul, attention and
conv entry points dispatch through the :mod:`repro_torch.kernels.registry`
using the per-op backend table the ``kernels`` pass recorded on the plan
(``plan.kernels``).

This is the CNN and dense-LM subset of the JAX package's
``core/ops_impl.py``; the recurrent, MoE and multimodal ops arrive with their
families.  Every dtype cast sits where the JAX op puts it, so bf16 rounds at
the same places in both, and a product JAX asks in fp32
(``preferred_element_type``) upcasts its operands here (exact for bf16).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d import same_pads
from repro_torch.kernels.registry import plan_kernel


# ---------------------------------------------------------------------------
# Execution context
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """Execution context: the mode, the plan, and the serving state of the
    block being run (``state_in`` read, ``state_out`` written)."""
    mode: str                        # prefill | decode (train: later slice)
    plan: Any                        # ExecutionPlan
    state_in: Dict[str, Any] = field(default_factory=dict)
    state_out: Dict[str, Any] = field(default_factory=dict)
    # decode position (an int, or a 0-d integer tensor)
    cache_index: Optional[Union[int, torch.Tensor]] = None
    aux: Dict[str, Any] = field(default_factory=dict)

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


def op_mul(ctx: Ctx, op, p, a, b):
    return a * b


def op_add(ctx: Ctx, op, p, a, b):
    return (a.float() + b.float()).to(ctx.compute_dtype)


def op_identity(ctx: Ctx, op, p, x):
    return x


def op_norm(ctx: Ctx, op, p, x):
    eps = op.attrs.get("eps", 1e-6)
    xf = x.float()
    scale = next(v for k, v in p.items() if k.endswith("scale")).float()
    if op.attrs["kind"] == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True)
                             + eps)
        y = y * scale
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale
        b = next((v for k, v in p.items() if k.endswith("bias")), None)
        if b is not None:
            y = y + b.float()
    return y.to(ctx.compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def op_embed(ctx: Ctx, op, p, tokens):
    table = p["table"]
    y = table[tokens.long()].to(ctx.compute_dtype)
    if op.attrs.get("scale_by_sqrt_d"):
        y = y * torch.tensor(math.sqrt(table.shape[1]), dtype=y.dtype,
                             device=y.device)
    if op.attrs.get("sinusoid_pos"):
        B, S, d = y.shape
        if ctx.mode == "decode" and ctx.cache_index is not None:
            pos = torch.full((B, S), int(ctx.cache_index), dtype=torch.int32,
                             device=y.device)
        else:
            pos = torch.arange(S, dtype=torch.int32,
                               device=y.device).expand(B, S)
        y = y + _sinusoid(pos, d).to(y.dtype)
    return y


def _sinusoid(pos, d):
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / max(half - 1, 1))
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def op_unembed(ctx: Ctx, op, p, x, *tied):
    table = tied[0] if tied else p["lm_head"]
    dt = ctx.compute_dtype
    logits = torch.matmul(x.to(dt).float(), table.to(dt).float().T)
    vocab = op.attrs.get("true_vocab")
    if vocab is not None and vocab < table.shape[0]:
        mask = torch.arange(table.shape[0], device=logits.device) < vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    return logits


# ---------------------------------------------------------------------------
# Rotary embedding
# ---------------------------------------------------------------------------

def op_rope(ctx: Ctx, op, p, x, positions):
    # x: (B, S, H, Dh); positions: (B, S) absolute token positions.
    rd = op.attrs["rot_dim"]
    base = op.attrs.get("base", 10000.0)
    half = rd // 2
    inv = torch.pow(torch.tensor(base, dtype=torch.float32, device=x.device),
                    -torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.float()[:, :, None, None] * inv      # (B,S,1,half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1 = x[..., :half].float()
    x2 = x[..., half:rd].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], -1)


def op_split_heads(ctx: Ctx, op, p, x):
    B, S, _ = x.shape
    return x.reshape(B, S, op.attrs["n"], op.attrs["dh"])


def op_merge_heads(ctx: Ctx, op, p, x):
    B, S, H, Dh = x.shape
    return x.reshape(B, S, H * Dh)


# ---------------------------------------------------------------------------
# Attention (full / causal / sliding-window), GQA, with the rolling KV cache
# ---------------------------------------------------------------------------

def _sdpa(ctx: Ctx, q, k, v, qpos, kpos, *, causal, window, softcap,
          chunk=512):
    """Masked scaled-dot-product attention, query-chunked to bound the score
    intermediate (reference analogue of the flash kernel's tiling).  q·scale,
    K, V and the probabilities round to the compute dtype, as in the JAX
    reference path; the products accumulate in fp32."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    dt = ctx.compute_dtype
    qf = (q * Dh ** -0.5).to(dt)
    kf = k.to(dt).float()
    vf = v.to(dt).float()

    def block(qc, qpc):
        # qc: (B, c, H, Dh) -> scores (B, KV, G, c, Skv) in fp32
        qg = qc.reshape(B, qc.shape[1], KV, G, Dh).float()
        s = torch.einsum("bckgd,bskd->bkgcs", qg, kf)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kp = kpos[:, None, None, None, :]
        valid = kp >= 0
        if causal:
            valid = valid & (kp <= qpc[:, None, None, :, None])
        if window:
            valid = valid & (kp > qpc[:, None, None, :, None] - window)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        pr = torch.softmax(s, dim=-1).to(dt).float()
        o = torch.einsum("bkgcs,bskd->bckgd", pr, vf)
        return o.reshape(B, qc.shape[1], H, Dh).to(dt)

    if Sq <= chunk:
        return block(qf, qpos)
    while Sq % chunk:
        chunk -= 1                       # largest divisor of Sq
    return torch.cat([block(qf[:, i:i + chunk], qpos[:, i:i + chunk])
                      for i in range(0, Sq, chunk)], dim=1)


def op_attention(ctx: Ctx, op, p, q, k, v, positions):
    attrs = op.attrs
    skey = attrs["state_key"]
    causal = attrs.get("causal", True)
    window = attrs.get("window")
    softcap = attrs.get("softcap")
    B, Sq, H, Dh = q.shape
    if attrs.get("cross", False):
        raise NotImplementedError(
            "cross-attention (encoder-decoder) is not ported yet "
            "(ROADMAP Queue 1, item 12)")

    if ctx.mode == "prefill":
        kern = plan_kernel(ctx.plan, "attention", window=window, cross=False)
        if kern is not None:
            out = kern(q, k, v, positions=positions, causal=causal,
                       window=window, softcap=softcap,
                       tile=ctx.plan.tiles.get("attention"))
        else:
            out = _sdpa(ctx, q, k, v, positions, positions, causal=causal,
                        window=window, softcap=softcap)
        if skey is not None:
            C = ctx.plan.cache_len
            if Sq >= C:
                kc, vc = k[:, Sq - C:], v[:, Sq - C:]
                pc = positions[:, Sq - C:]
            else:
                pad = C - Sq
                kc = F.pad(k, (0, 0, 0, 0, 0, pad))
                vc = F.pad(v, (0, 0, 0, 0, 0, pad))
                pc = F.pad(positions, (0, pad), value=-1)
            ctx.state_out[skey] = {"k": kc.contiguous(),
                                   "v": vc.contiguous(),
                                   "pos": pc.to(torch.int32).contiguous()}
        return out

    # -- decode over the rolling cache ----------------------------------
    st = ctx.state_in[skey]
    if "kp" in st:
        raise NotImplementedError(
            "the paged KV pool (serving engine) is not ported yet "
            "(ROADMAP Queue 1, item 7)")
    # the new K/V land in the cache tensors in place (JAX updates a donated
    # copy); the state dict handed in is the state handed out
    kc, vc, pc = st["k"], st["v"], st["pos"]
    C = kc.shape[1]
    ci = int(ctx.cache_index)
    idx = ci % C
    kc[:, idx:idx + Sq] = k.to(kc.dtype)
    vc[:, idx:idx + Sq] = v.to(vc.dtype)
    pc[:, idx:idx + Sq] = ci
    ctx.state_out[skey] = {"k": kc, "v": vc, "pos": pc}
    qpos = torch.full((B, 1), ci, dtype=torch.int32, device=q.device)
    kern = plan_kernel(ctx.plan, "decode_attention")
    if kern is not None:
        return kern(q, kc, vc, pc, qpos, window=window, softcap=softcap,
                    tile=ctx.plan.tiles.get("decode_attention"))
    return _sdpa(ctx, q, kc, vc, qpos, pc, causal=True, window=window,
                 softcap=softcap)



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
    "act": op_act, "mul": op_mul, "add": op_add, "identity": op_identity,
    "norm": op_norm, "embed": op_embed, "unembed": op_unembed,
    "rope": op_rope, "split_heads": op_split_heads,
    "merge_heads": op_merge_heads, "attention": op_attention,
    "image_in": op_image_in, "conv2d": op_conv2d,
    "depthwise_conv2d": op_depthwise_conv2d, "batchnorm": op_batchnorm,
    "maxpool2d": op_maxpool2d, "avgpool2d": op_avgpool2d,
    "global_avgpool": op_global_avgpool, "flatten": op_flatten,
}
