"""Reference (plain-PyTorch) implementations of the ported micro-ops.

Each op is a function ``fn(ctx, op, p, *args)`` where ``p`` maps param name →
tensor (names are the *last path component* of the ParamSpec name).  ``ctx``
carries the execution mode, the decode state and the compilation plan.  The
fused ops produced by the fusion pass (``glu_matmul``, epilogue attrs on
``matmul``/``conv2d``) are implemented here too; the matmul, attention and
conv entry points dispatch through the :mod:`repro_torch.kernels.registry`
using the per-op backend table the ``kernels`` pass recorded on the plan
(``plan.kernels``).

These are the ops of the JAX package's ``core/ops_impl.py``.  Every dtype
cast sits where the JAX op puts it, so bf16 rounds at the same places in
both, and a product JAX asks in fp32 (``preferred_element_type``) upcasts
its operands here (exact for bf16).

On a mesh (``ctx.plan.rules``) every op runs on the rank's local tensors in
the rules' canonical layout (the batch split over dp, whole over tp); the
ops of :data:`TP_SPLIT_OPS` compute on the tp chunks of their parameters
(``ctx.tp_dims``) with explicit collectives, the others get whole
parameters from the lowering, and ``ctx.cst`` applies the JAX package's
activation constraints (attention's query sequence and the decode caches'
length over tp).  The hand kernels launch on those local tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as col
from repro_torch.kernels.conv2d import same_pads
from repro_torch.kernels.lru_scan import lru_scan_plain
from repro_torch.kernels.registry import plan_kernel


def remat(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward pass recomputes it.  No RNG state is saved: no forward draws
    anything random, and a CUDA-graph capture of the train step cannot
    read the generator's state."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Execution context
# ---------------------------------------------------------------------------

@dataclass
class Ctx:
    """Execution context: the mode, the plan, and the serving state of the
    block being run (``state_in`` read, ``state_out`` written).  ``train``
    runs the full sequence like ``prefill`` but writes no state, records
    autograd through each kernel launch (:func:`_on_kernel`) and uses
    BatchNorm's batch statistics."""
    mode: str                        # train | prefill | decode
    plan: Any                        # ExecutionPlan
    state_in: Dict[str, Any] = field(default_factory=dict)
    state_out: Dict[str, Any] = field(default_factory=dict)
    # decode position (an int, or a 0-d integer tensor)
    cache_index: Optional[Union[int, torch.Tensor]] = None
    aux: Dict[str, Any] = field(default_factory=dict)
    # sharding-constraint hook, set by the lowering when a mesh is active:
    # the canonical layout -> this rank's chunk of the dims the roles put
    # on tp (ShardingRules.constrain_act)
    constrain: Callable[[torch.Tensor, tuple], torch.Tensor] = \
        lambda x, roles: x
    # on a mesh, the tp-split dim of each of the running op's params (only
    # the ops of TP_SPLIT_OPS see split ones; "tied" names a tied table)
    tp_dims: Dict[str, int] = field(default_factory=dict)
    # on a mesh serving a state every rank holds whole (the engine's paged
    # pool): the dp groups this rank's rows are a chunk over, or None when
    # it runs every row; a pool write gathers the rows' new K/V over them
    # first, so every rank writes every row
    row_groups: Optional[list] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.plan.flow.precision == "bf16" \
            else torch.float32

    def cst(self, x, *roles):
        if len(roles) == 1 and isinstance(roles[0], (tuple, list)):
            roles = tuple(roles[0])
        return self.constrain(x, roles)

    def add_aux(self, name: str, value) -> None:
        self.aux[name] = self.aux.get(name, 0.0) + value


#: the ops that compute on the tp chunks of their parameters on a mesh:
#: the products (column split: N over tp, the output all-gathered; row
#: split: K over tp, the partial sums all-reduced), the unembed (the
#: logits of this rank's vocabulary rows) and the MoE (expert or d_ff
#: parallel, one fp32 sum over the model axis)
TP_SPLIT_OPS = ("matmul", "glu_matmul", "unembed", "moe_ffn")


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

class _KernelForward(torch.autograd.Function):
    """A hand kernel's forward with its reference op's backward.

    ``forward`` launches ``kern(*ts)``; ``backward`` recomputes ``ref(*ts)``
    on the saved inputs with autograd and returns its vector-Jacobian
    product.  So a train step's products run on the kernels while its
    gradients are exactly the reference path's: the kernels have no
    backward of their own, nor have the JAX package's (``pallas_call`` has
    no transpose rule and the package defines no ``custom_vjp``, so JAX's
    train step differentiates its reference ops)."""

    @staticmethod
    def forward(fctx, kern, ref, *ts):
        fctx.ref = ref
        fctx.save_for_backward(*ts)
        return kern(*ts)

    @staticmethod
    def backward(fctx, gy):
        need = fctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(fctx.saved_tensors, need)]
            y = fctx.ref(*xs)
        gs = iter(torch.autograd.grad(
            y, [x for x, n in zip(xs, need) if n], gy, allow_unused=True))
        return (None, None, *(next(gs) if n else None for n in need))


def _on_kernel(ctx: Ctx, kern: Callable, ref: Callable, *ts):
    """``kern(*ts)``, the kernel launch; in a train step that autograd
    records, through :class:`_KernelForward`, whose backward is ``ref``'s
    (``ref`` computes the same function on the reference path)."""
    if ctx.mode == "train" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        return _KernelForward.apply(kern, ref, *ts)
    return kern(*ts)


def _matmul_ref(ctx: Ctx, x, w, bias=None, w2=None, *, act=None,
                out_dtype=None):
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
    return y.to(out_dtype or dt)


def _matmul_backend(ctx: Ctx, x, w, *, bias=None, act=None, w2=None,
                    out_dtype=None):
    """Single entry point for all (possibly fused) matmuls; routes to the
    CUDA kernel when the plan's backend table selects it.  A train plan's
    fp32 master weights reach the kernel rounded to the compute dtype, as
    the reference rounds them."""
    kern = plan_kernel(ctx.plan, "glu_matmul" if w2 is not None else "matmul",
                       x=x, w=w)
    if kern is None:
        return _matmul_ref(ctx, x, w, bias, w2, act=act, out_dtype=out_dtype)
    dt, tile = ctx.compute_dtype, ctx.plan.tiles.get("matmul")
    odt = out_dtype or dt

    def launch(x, w, bias, w2):
        if ctx.mode == "train":
            w = w.to(dt)
            w2 = None if w2 is None else w2.to(dt)
        return kern(x, w, bias=bias, act=act, w2=w2, tile=tile,
                    out_dtype=odt)
    return _on_kernel(ctx, launch,
                      lambda x, w, bias, w2: _matmul_ref(
                          ctx, x, w, bias, w2, act=act, out_dtype=odt),
                      x, w, bias, w2)


def _matmul_tp(ctx: Ctx, x, w, tpd: Optional[int], *, bias=None, act=None,
               w2=None, bias_tpd: Optional[int] = None):
    """A (possibly fused) product whose weight may be split over tp on a
    mesh (``tpd``: the split dim of ``w``, None when whole).

    Column split (N over tp): this rank's output columns from the kernel,
    epilogue included, then all-gathered over tp (the input's backward
    all-reduced).  Row split (K over tp): the kernel on this rank's K
    chunk of ``x`` with an fp32 output, the partial sums all-reduced over
    tp in fp32, then the bias and the activation, rounded once to the
    compute dtype, as the unsplit kernel rounds its fp32 accumulator."""
    if tpd is None:
        return _matmul_backend(ctx, x, w, bias=bias, act=act, w2=w2)
    g = ctx.plan.rules.tp_group
    if tpd == 1:
        if bias is not None and bias_tpd is None:
            bias = col.split(bias, 0, g)
        y = _matmul_backend(ctx, col.copy(x, g), w, bias=bias, act=act,
                            w2=w2)
        return col.gather(y, -1, g)
    if w2 is not None:
        raise ValueError("a GLU pair splits over its output columns only")
    y = _matmul_backend(ctx, col.split(x, -1, g), w, out_dtype=torch.float32)
    y = col.reduce(y, g)
    if bias is not None:
        if bias_tpd is not None:
            bias = col.gather(bias, 0, g)
        y = y + bias.float()
    if act is not None:
        y = _act(y, act)
    return y.to(ctx.compute_dtype)


def op_matmul(ctx: Ctx, op, p, x, *extra):
    names = list(p)
    bias = p[names[1]] if op.attrs.get("bias") else None
    y = _matmul_tp(ctx, x, p[names[0]], ctx.tp_dims.get(names[0]),
                   bias=bias, act=op.attrs.get("act"),
                   bias_tpd=ctx.tp_dims.get(names[1]) if bias is not None
                   else None)
    if op.attrs.get("residual"):
        y = (y.float() + extra[0].float()).to(y.dtype)
    return y


def op_glu_matmul(ctx: Ctx, op, p, x):
    names = list(p)
    tpd = ctx.tp_dims.get(names[0])
    if tpd != ctx.tp_dims.get(names[1]):
        raise ValueError(f"GLU pair split unlike: {ctx.tp_dims}")
    return _matmul_tp(ctx, x, p[names[0]], tpd, w2=p[names[1]],
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

def decode_positions(cache_index, B: int, S: int,
                     device: torch.device) -> torch.Tensor:
    """The (B, S) int32 positions of a decode step at ``cache_index``
    (every entry the index, as the JAX package broadcasts it): an int
    fills them, a 0-d tensor (a CUDA graph's static index) is read on the
    device."""
    if torch.is_tensor(cache_index):
        return cache_index.to(device=device, dtype=torch.int32).reshape(
            1, 1).expand(B, S).contiguous()
    return torch.full((B, S), int(cache_index), dtype=torch.int32,
                      device=device)


def op_embed(ctx: Ctx, op, p, tokens):
    table = p["table"]
    y = table[tokens.long()].to(ctx.compute_dtype)
    if op.attrs.get("scale_by_sqrt_d"):
        # the factor rounded to y's dtype on the host: a device scalar
        # would be a host-to-device copy, which a CUDA graph cannot hold
        y = y * torch.tensor(math.sqrt(table.shape[1]), dtype=y.dtype).item()
    if op.attrs.get("sinusoid_pos"):
        B, S, d = y.shape
        if ctx.mode == "decode" and ctx.cache_index is not None:
            pos = decode_positions(ctx.cache_index, B, S, y.device)
        else:
            pos = torch.arange(S, dtype=torch.int32,
                               device=y.device).expand(B, S)
        y = y + _sinusoid(pos, d).to(y.dtype)
    return ctx.cst(y, ("batch", "seq", "none"))


def _sinusoid(pos, d):
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=pos.device) / max(half - 1, 1))
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def op_unembed(ctx: Ctx, op, p, x, *tied):
    """fp32 logits of the compute-dtype operands, padded vocabulary entries
    at -1e9.  On a mesh with the table's vocabulary split over tp, the
    logits of this rank's rows: the JAX package's constraint (the vocab
    over tp) holds as they are made."""
    table = tied[0] if tied else p["lm_head"]
    tpd = ctx.tp_dims.get("tied" if tied else "lm_head")
    dt = ctx.compute_dtype
    xin = x if tpd is None else col.copy(x, ctx.plan.rules.tp_group)
    logits = torch.matmul(xin.to(dt).float(), table.to(dt).float().T)
    off = 0 if tpd is None else ctx.plan.rules.tp_rank * table.shape[0]
    vocab = op.attrs.get("true_vocab")
    if vocab is not None and vocab < off + table.shape[0]:
        mask = torch.arange(off, off + table.shape[0],
                            device=logits.device) < vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    if tpd is not None:
        return logits
    return ctx.cst(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# Rotary embedding
# ---------------------------------------------------------------------------

def op_rope(ctx: Ctx, op, p, x, positions):
    # x: (B, S, H, Dh); positions: (B, S) absolute token positions.
    rd = op.attrs["rot_dim"]
    base = op.attrs.get("base", 10000.0)
    half = rd // 2
    # the base rides as a scalar: a tensor made from it on the card would
    # be a host-to-device copy, which synchronises, in every decode tick
    inv = torch.pow(float(base), -torch.arange(0, half, dtype=torch.float32,
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
# Attention (full / causal / sliding-window / cross), GQA, with the rolling
# KV cache
# ---------------------------------------------------------------------------

def _sdpa(ctx: Ctx, q, k, v, qpos, kpos, *, causal, window, softcap,
          chunk=512):
    """Masked scaled-dot-product attention, query-chunked to bound the score
    intermediate (reference analogue of the flash kernel's tiling).  q·scale,
    K, V and the probabilities round to the compute dtype, as in the JAX
    reference path; the products accumulate in fp32.  In train mode each
    chunk is checkpointed, as JAX remats it: the backward pass recomputes
    the fp32 score block instead of saving it."""
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
    if ctx.mode == "train":
        def run(*a):
            return remat(block, *a)
    else:
        run = block
    return torch.cat([run(qf[:, i:i + chunk], qpos[:, i:i + chunk])
                      for i in range(0, Sq, chunk)], dim=1)


def op_attention(ctx: Ctx, op, p, q, k, v, positions):
    attrs = op.attrs
    skey = attrs["state_key"]
    causal = attrs.get("causal", True)
    window = attrs.get("window")
    softcap = attrs.get("softcap")
    B, Sq, H, Dh = q.shape
    if attrs.get("cross", False):
        return _cross_attention(ctx, skey, q, k, v, positions, softcap)

    if ctx.mode in ("train", "prefill"):
        kern = plan_kernel(ctx.plan, "attention", window=window, cross=False)
        rules = ctx.plan.rules
        # context parallelism (the JAX constraints): this tp rank's chunk of
        # the query sequence against the whole K / V, at its own positions
        # (``q_offset``: the chunk of an arange; explicit per-row positions
        # keep the query whole)
        qroles = ("batch", "seq_cp", "none", "none")
        cp = [] if rules is None or "positions" in ctx.aux.get(
            "__inputs__", {}) else rules.act_tp_dims(q, qroles)
        q0, off = q, 0
        if cp:
            # every query chunk reads the whole K / V: each tp rank's
            # gradient of them is a partial sum (all-reduced in backward)
            g = rules.tp_group
            q = ctx.cst(q, qroles)
            k = col.copy(ctx.cst(k, ("batch", "gather", "none", "none")), g)
            v = col.copy(ctx.cst(v, ("batch", "gather", "none", "none")), g)
            off = rules.tp_rank * q.shape[1]
        qpos = positions[:, off:off + q.shape[1]]

        def ref(q, k, v, qpos, kpos):
            return _sdpa(ctx, q, k, v, qpos, kpos, causal=causal,
                         window=window, softcap=softcap)
        if kern is not None:
            tile = ctx.plan.tiles.get("attention")
            if cp:
                def launch(q, k, v, qpos, kpos):
                    return kern(q, k, v, causal=causal, window=window,
                                softcap=softcap, q_offset=off, tile=tile)
            else:
                def launch(q, k, v, qpos, kpos):
                    return kern(q, k, v, positions=kpos, causal=causal,
                                window=window, softcap=softcap, tile=tile)
            out = _on_kernel(ctx, launch, ref, q, k, v, qpos, positions)
        else:
            out = ref(q, k, v, qpos, positions)
        if cp:
            out = rules.gather_act(out, cp)
        q = q0
        if ctx.mode == "prefill" and skey is not None:
            C = ctx.plan.cache_len
            if Sq >= C:
                kc, vc = k[:, Sq - C:], v[:, Sq - C:]
                pc = positions[:, Sq - C:]
            else:
                pad = C - Sq
                kc = F.pad(k, (0, 0, 0, 0, 0, pad))
                vc = F.pad(v, (0, 0, 0, 0, 0, pad))
                pc = F.pad(positions, (0, pad), value=-1)
            croles = ("batch", "kv_len", "none", "none")
            ctx.state_out[skey] = {
                "k": ctx.cst(kc, croles).contiguous(),
                "v": ctx.cst(vc, croles).contiguous(),
                "pos": ctx.cst(pc.to(torch.int32), croles[:2]).contiguous()}
        return out

    st = ctx.state_in[skey]
    if "kp" in st:
        return _paged_decode(ctx, st, skey, q, k, v, positions,
                             window=window, softcap=softcap)
    # -- decode over the rolling cache ----------------------------------
    # the new K/V land in the cache tensors in place (JAX updates a donated
    # copy); the state dict handed in is the state handed out.  On a mesh
    # the caches are this rank's chunk of their length: gathered over tp
    # for the kernel (which returns no log-sum-exp to merge chunks by),
    # written there, and the chunk copied back
    kc, vc, pc = st["k"], st["v"], st["pos"]
    rules = ctx.plan.rules
    cut = []
    if rules is not None and kc.shape[1] != ctx.plan.cache_len:
        cut = [1]
        kc, vc, pc = (rules.gather_act(t, cut) for t in (kc, vc, pc))
    C = kc.shape[1]
    ci = ctx.cache_index
    if torch.is_tensor(ci):
        # a device index (a CUDA graph's): slots (ci + j) % C, written with
        # index_copy_, nothing read back to the host
        slots = (ci.long() + torch.arange(Sq, device=kc.device)) % C
        kc.index_copy_(1, slots, k.to(kc.dtype))
        vc.index_copy_(1, slots, v.to(vc.dtype))
        pc.index_copy_(1, slots, decode_positions(ci, B, Sq, pc.device))
    else:
        ci = int(ci)
        idx = ci % C
        kc[:, idx:idx + Sq] = k.to(kc.dtype)
        vc[:, idx:idx + Sq] = v.to(vc.dtype)
        pc[:, idx:idx + Sq] = ci
    if cut:
        croles = ("batch", "kv_len", "none", "none")
        for whole, local, roles in ((kc, st["k"], croles),
                                    (vc, st["v"], croles),
                                    (pc, st["pos"], croles[:2])):
            local.copy_(ctx.cst(whole, roles))
        ctx.state_out[skey] = st
    else:
        ctx.state_out[skey] = {"k": kc, "v": vc, "pos": pc}
    qpos = decode_positions(ci, B, 1, q.device)
    kern = plan_kernel(ctx.plan, "decode_attention")
    if kern is not None:
        return kern(q, kc, vc, pc, qpos, window=window, softcap=softcap,
                    tile=ctx.plan.tiles.get("decode_attention"))
    return _sdpa(ctx, q, kc, vc, qpos, pc, causal=True, window=window,
                 softcap=softcap)


def _cross_attention(ctx: Ctx, skey, q, k, v, positions, softcap):
    """Cross-attention to the encoder's output on the reference path (the
    registry keeps it off the flash kernel, as JAX's does): no mask, the
    keys at ``arange(encoder_seq)``.  Prefill caches the encoder's K/V in
    the state; decode reads them back (its K/V inputs are placeholders)
    and hands the same state on."""
    if ctx.mode == "decode":
        st = ctx.state_in[skey]
        k, v = st["k"], st["v"]
        ctx.state_out[skey] = st
    elif ctx.mode == "prefill":          # cache the encoder K/V once
        ctx.state_out[skey] = {"k": k, "v": v}
    B, Skv = q.shape[0], k.shape[1]
    kpos = torch.arange(Skv, dtype=torch.int32, device=q.device).expand(B, Skv)
    return _sdpa(ctx, q, k, v, positions, kpos, causal=False, window=None,
                 softcap=softcap)


def _paged_sdpa(ctx: Ctx, q, kp, vp, bt, qpos, *, window, softcap):
    """The reference path over the paged pool (the JAX package's
    ``paged_decode_attention_ref``): gather each row's blocks through its
    table into a contiguous cache and run :func:`_sdpa` on it, with the
    compute-dtype rounding of the reference (a padding row, qpos < 0, is
    masked everywhere, as in the reference)."""
    B = q.shape[0]
    bs, KV, Dh = kp.shape[1], kp.shape[2], kp.shape[3]
    C = bt.shape[1] * bs
    idx = bt.long()
    kc = kp[idx].reshape(B, C, KV, Dh)
    vc = vp[idx].reshape(B, C, KV, Dh)
    kpos = torch.arange(C, dtype=torch.int32, device=q.device).expand(B, C)
    return _sdpa(ctx, q, kc, vc, qpos, kpos, causal=True, window=window,
                 softcap=softcap)


def _paged_decode(ctx: Ctx, st, skey, q, k, v, positions, *, window,
                  softcap):
    """Decode over the paged KV pool (the serving engine's state): per-row
    block tables ``bt`` and lengths ``len`` instead of a dense cache.

    One token a row (Sq = 1): the new K/V land at logical offset ``len[b]``
    of row b's chain and the query sits at ``len[b]``; every row's ``len``
    grows by one (free rows park on trash block 0, so their writes land in
    memory no live request owns).  Sq > 1 (chunked catch-up, speculative
    verify): row b's tokens sit at ``positions[b]``; entries < 0 are
    padding, written to block 0 and masked; ``len`` grows by the live
    entries.  The pools, tables and lengths are written in place (the JAX
    stage donates them) and the same state dict comes back.

    On a mesh whose ranks each hold the whole pool (``ctx.row_groups``:
    this rank runs its chunk of the rows, ``bt`` and ``len`` are its rows'
    views) the new tokens' K, V and pool slots are gathered over dp first,
    so every rank writes every row and the pools stay identical."""
    kp, vp, bt, ln = st["kp"], st["vp"], st["bt"], st["len"]
    B, Sq = q.shape[0], q.shape[1]
    bs, nblk = kp.shape[1], bt.shape[1]
    rows = torch.arange(B, device=q.device)
    if Sq > 1:
        pos = positions.to(torch.int32)
        act = pos >= 0
        safe = torch.where(act, pos, torch.zeros_like(pos)).long()
        blk = torch.where(act, bt[rows[:, None], (safe // bs) % nblk],
                          torch.zeros_like(pos)).long()
        off = torch.where(act, safe % bs, torch.zeros_like(safe))
        kn, vn = k, v
        qpos, grow = pos, act.sum(1).to(ln.dtype)
    else:
        lnl = ln.long()
        blk = bt[rows, (lnl // bs) % nblk].long()
        off = lnl % bs
        kn, vn = k[:, 0], v[:, 0]
        qpos, grow = ln.reshape(B, 1), 1
    if ctx.row_groups is not None:
        blk, off, kn, vn = (col.gather_over(t, 0, ctx.row_groups)
                            for t in (blk, off, kn, vn))
    kp.index_put_((blk, off), kn.to(kp.dtype))
    vp.index_put_((blk, off), vn.to(vp.dtype))
    kern = plan_kernel(ctx.plan, "paged_decode_attention")
    if kern is not None:
        out = kern(q, kp, vp, bt, ln, qpos=qpos if Sq > 1 else None,
                   window=window, softcap=softcap)
    else:
        out = _paged_sdpa(ctx, q, kp, vp, bt, qpos, window=window,
                          softcap=softcap)
    ln.add_(grow)              # after the attention, which reads the old len
    ctx.state_out[skey] = st
    return out


# ---------------------------------------------------------------------------
# Temporal conv + RG-LRU (Griffin)
# ---------------------------------------------------------------------------
#
# The state of both ops is kept in the op input's dtype (the compute dtype),
# as in the JAX package; the decode step writes it into the state tensor it
# was handed, in place, and hands that tensor back.

def op_conv1d_causal(ctx: Ctx, op, p, x):
    W = next(v for k, v in p.items() if k.endswith("_w")).float()
    b = next(v for k, v in p.items() if k.endswith("_b")).float()
    kw = op.attrs["width"]
    skey = op.attrs["state_key"]
    xf = x.float()
    if ctx.mode == "decode":
        st = ctx.state_in[skey]          # (B, kw-1, w) previous inputs
        seq = torch.cat([st.float(), xf], dim=1)   # a new tensor: no alias
        y = torch.einsum("bkw,kw->bw", seq, W)[:, None, :] + b
        st.copy_(seq[:, 1:])
        ctx.state_out[skey] = st
        return y.to(ctx.compute_dtype)
    S = x.shape[1]
    pad = F.pad(xf, (0, 0, kw - 1, 0))
    y = sum(pad[:, i:i + S, :] * W[i] for i in range(kw)) + b
    if ctx.mode == "prefill":
        tail = xf[:, max(0, S - (kw - 1)):, :]
        if S < kw - 1:
            tail = F.pad(tail, (0, 0, kw - 1 - S, 0))
        ctx.state_out[skey] = tail.to(x.dtype)
    return y.to(ctx.compute_dtype)


def _block_diag_linear(x, W, b):
    # x: (B, S, w); W: (nb, w/nb, w/nb)
    B, S, w = x.shape
    nb = W.shape[0]
    xr = x.reshape(B, S, nb, w // nb)
    y = torch.einsum("bsnk,nkj->bsnj", xr.float(), W.float())
    return y.reshape(B, S, w) + b.float()


def op_rg_lru(ctx: Ctx, op, p, x):
    c = op.attrs.get("c", 8.0)
    skey = op.attrs["state_key"]
    lam = p["lru_lambda"].float()
    xf = x.float()
    r = torch.sigmoid(_block_diag_linear(x, p["lru_wa"], p["lru_ba"]))
    i = torch.sigmoid(_block_diag_linear(x, p["lru_wx"], p["lru_bx"]))
    # softplus as jax.nn.softplus computes it, logaddexp(x, 0): F.softplus
    # turns linear above its threshold
    sp = torch.logaddexp(-lam, torch.zeros_like(lam))
    log_a = -c * r * sp                      # log of the recurrence gate
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    if ctx.mode == "decode":
        st = ctx.state_in[skey]              # (B, w)
        h = a[:, 0] * st.float() + gated[:, 0]
        st.copy_(h)
        ctx.state_out[skey] = st
        return h[:, None, :].to(ctx.compute_dtype)
    # the linear recurrence over the sequence: the hand-written scan kernel
    # where the plan resolves rg_lru to cuda, its plain version elsewhere
    kern = plan_kernel(ctx.plan, "rg_lru")
    h = (lru_scan_plain(a, gated) if kern is None else
         _on_kernel(ctx, kern, lru_scan_plain, a, gated)).float()
    if ctx.mode == "prefill":
        ctx.state_out[skey] = h[:, -1].to(x.dtype)
    return h.to(ctx.compute_dtype)


# ---------------------------------------------------------------------------
# Products outside the kernels: the JAX package's einsums on compute-dtype
# operands with fp32 output (the MoE expert products, the RWKV6 projections)
# ---------------------------------------------------------------------------

_BMM_OUT_DTYPE: Optional[bool] = None


def _bmm_out_dtype_ok() -> bool:
    """Whether this torch's ``bmm`` takes ``out_dtype`` on CUDA (bf16
    operands, an fp32 result), probed once on the card."""
    global _BMM_OUT_DTYPE
    if _BMM_OUT_DTYPE is None:
        a = torch.zeros((1, 16, 16), dtype=torch.bfloat16, device="cuda")
        try:
            _BMM_OUT_DTYPE = torch.bmm(a, a, out_dtype=torch.float32).dtype \
                == torch.float32
        except (TypeError, RuntimeError):
            _BMM_OUT_DTYPE = False
    return _BMM_OUT_DTYPE


def _lib_dot(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype
             ) -> torch.Tensor:
    """The JAX package's ``_moe_dot`` (and its RWKV6 projections, einsums
    with ``preferred_element_type=float32``): the product of ``a`` and
    ``b`` rounded to ``dt``, in fp32 (its ``_cpu_safe_dots`` computes it in
    fp32 on the same rounded values).
    A batched (E, M, K) x (E, K, N) product, or (..., K) x (K, N).  On the
    card a bf16 pair goes to ``bmm(..., out_dtype=float32)`` where torch
    offers it, outside autograd; elsewhere the operands widen to fp32
    (TF32 stays off, so the products are fp32's).  A library call, as in
    JAX, whose einsums run outside any Pallas kernel."""
    a, b = a.to(dt), b.to(dt)
    if (a.is_cuda and dt == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))
            and _bmm_out_dtype_ok()):
        if b.ndim == 2:                  # (..., K) x (K, N): one batch
            y = torch.bmm(a.reshape(1, -1, a.shape[-1]), b[None],
                          out_dtype=torch.float32)
            return y.reshape(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# RWKV6 time-mix / channel-mix
# ---------------------------------------------------------------------------
#
# The WKV recurrence runs in fp32 in every precision (r, k, v come out of
# fp32-output products); the token-shift and WKV states are kept in the op
# input's dtype, so in bf16 the WKV state rounds to bf16 at every decode
# step, as in the JAX package.  A decode step writes both states into the
# state tensors it was handed, in place.  No Pallas kernel computes any of
# this in JAX: the products are einsums and the recurrence plain jnp.

def _token_shift(ctx: Ctx, x, skey):
    """x_{t-1}: zeros at t = 0 in a full sequence, the cached last input in
    decode; the state keeps the last input."""
    if ctx.mode == "decode":
        st = ctx.state_in[skey]                    # (B, d)
        prev = st.to(x.dtype).clone()[:, None, :]  # read before the write
        st.copy_(x[:, -1])
        ctx.state_out[skey] = st
        return prev
    prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    if ctx.mode == "prefill":
        ctx.state_out[skey] = x[:, -1].contiguous()
    return prev


def _wkv_step(St, rt, kt, vt, wt, u):
    """One step of the recurrence on (..., dk) inputs and a (..., dk, dv)
    state: ``y = r . (S + (u * k) v^T)``, ``S' = w * S + k v^T``."""
    bonus = (rt * (u * kt)).sum(-1, keepdim=True) * vt
    yt = torch.matmul(rt[..., None, :], St)[..., 0, :] + bonus
    St = wt[..., None] * St + kt[..., None] * vt[..., None, :]
    return St, yt


def _wkv_chunked(r, k, v, w, u, chunk: int, parallel: bool = True,
                 boundary_dt: torch.dtype = torch.float32):
    """The RWKV6 linear recurrence over chunks of C steps (``chunk`` halved
    until it divides S), as the JAX package's ``_wkv_chunked``.

    ``parallel=True`` (prefill): each chunk's decay and summed k v^T, the
    chunk recurrence ``S_c = D_c * S_{c-1} + M_c`` as a loop over the
    chunks (JAX combines them by an associative scan in tree order, so the
    roundings differ), the state entering chunk n the inclusive result of
    chunk n - 1, then one sequential scan over the C steps of every chunk
    at once.  ``parallel=False`` (train): a loop over the chunks carrying
    only the boundary state, rounded to ``boundary_dt`` between chunks,
    each chunk's C steps in fp32 and, under autograd, recomputed in the
    backward pass (``torch.utils.checkpoint``).

    Shapes: r, k, w (B, S, H, dk), w the log-decay; v (B, S, H, dv); u
    (H, dk).  Returns y (B, S, H, dv) and the final state (B, H, dk, dv)
    in fp32."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    C = min(chunk, S)
    while S % C:
        C //= 2
    nc = S // C
    if not parallel:
        xs = [t.reshape(B, nc, C, H, -1).permute(1, 2, 0, 3, 4)
              for t in (r, k, v, torch.exp(w))]       # (nc, C, B, H, d)

        def chunk_body(S0, rc, kc, vc, wc):
            St, ys = S0.float(), []
            for t in range(C):
                St, yt = _wkv_step(St, rc[t], kc[t], vc[t], wc[t], u)
                ys.append(yt)
            return St.to(boundary_dt), torch.stack(ys)

        recompute = torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u))
        St = torch.zeros((B, H, dk, dv), dtype=boundary_dt, device=r.device)
        ys = []
        for n in range(nc):
            args = (St, *(t[n] for t in xs))
            St, yc = (remat(chunk_body, *args)
                      if recompute else chunk_body(*args))
            ys.append(yc)
        y = torch.stack(ys).permute(2, 0, 1, 3, 4).reshape(B, S, H, dv)
        return y, St.float()
    rs, ks, vs, logw = (t.reshape(B, nc, C, H, -1) for t in (r, k, v, w))
    Lc = torch.cumsum(logw, dim=2)                         # (B,nc,C,H,dk)
    chunk_decay = torch.exp(Lc[:, :, -1])                  # (B,nc,H,dk)
    # sum_s exp(L_C - L_s) k_s v_s^T (the exponent is <= 0)
    kd = ks * torch.exp(Lc[:, :, -1:] - Lc)
    chunk_kv = torch.einsum("bnchk,bnchv->bnhkv", kd, vs)
    macc = [chunk_kv[:, 0]]
    for n in range(1, nc):
        macc.append(chunk_decay[:, n][..., None] * macc[-1] + chunk_kv[:, n])
    # the state entering chunk n: the inclusive result of chunk n - 1
    St = torch.stack([torch.zeros_like(macc[0])] + macc[:-1], dim=1)
    xs = [t.permute(2, 0, 1, 3, 4) for t in (rs, ks, vs, torch.exp(logw))]
    ys = []
    for t in range(C):                     # (B, nc, H) at once
        St, yt = _wkv_step(St, xs[0][t], xs[1][t], xs[2][t], xs[3][t], u)
        ys.append(yt)
    y = torch.stack(ys, dim=2)                             # (B,nc,C,H,dv)
    return y.reshape(B, S, H, dv), macc[-1]


def op_rwkv6_timemix(ctx: Ctx, op, p, x):
    """RWKV6 time-mix: the data-dependent token-shift lerps (compute
    dtype; their LoRA in fp32), the r, k, v, g projections on
    compute-dtype operands with fp32 output (library products, as JAX's
    einsums), the data-dependent decay, the WKV recurrence (one step in
    decode, :func:`_wkv_chunked` over ``plan.tiles["wkv_chunk"]`` steps
    otherwise), the per-head group norm (eps 64e-5), the SiLU gate and the
    output projection."""
    H, dh = op.attrs["n_heads"], op.attrs["head_dim"]
    rank = op.attrs["lora_rank"]
    skey = op.attrs["state_key"]
    B, S, d = x.shape
    dt = ctx.compute_dtype
    xf = x.to(dt)
    prev = _token_shift(ctx, xf, skey + "_shift")
    dx = prev - xf
    # the data-dependent token-shift mixes of the 5 targets r, k, v, w, g
    lo = torch.tanh(torch.matmul(xf.float(), p["mu_lora_a"].float()))
    lo = lo.reshape(B, S, 5, rank)
    delta = torch.einsum("bsnr,nrd->nbsd", lo, p["mu_lora_b"].float())
    mix = p["mu_base"].float()[:, None, None, :] + delta   # (5, B, S, d)
    xr, xk, xv, xw, xg = (xf + dx * mix[j].to(dt) for j in range(5))
    r = _lib_dot(xr, p["w_r"], dt).reshape(B, S, H, dh)
    k = _lib_dot(xk, p["w_k"], dt).reshape(B, S, H, dh)
    v = _lib_dot(xv, p["w_v"], dt).reshape(B, S, H, dh)
    g = _lib_dot(xg, p["w_g"], dt)
    wraw = p["decay_base"].float() + torch.matmul(
        torch.tanh(torch.matmul(xw.float(), p["decay_lora_a"].float())),
        p["decay_lora_b"].float())
    logw = -torch.exp(torch.clamp(wraw, -20.0, 4.0)).reshape(B, S, H, dh)
    u = p["bonus"].float().reshape(H, dh)
    if ctx.mode == "decode":
        st = ctx.state_in[skey + "_s"]                     # (B, H, dk, dv)
        St, yt = _wkv_step(st.float(), r[:, 0], k[:, 0], v[:, 0],
                           torch.exp(logw[:, 0]), u)
        st.copy_(St)                  # rounds to the state's dtype
        ctx.state_out[skey + "_s"] = st
        y = yt[:, None]
    else:
        y, s_fin = _wkv_chunked(r, k, v, logw, u,
                                ctx.plan.tiles.get("wkv_chunk", 32),
                                parallel=ctx.mode != "train",
                                boundary_dt=dt)
        if ctx.mode == "prefill":
            ctx.state_out[skey + "_s"] = s_fin.to(x.dtype)
    # per-head group norm, gate, output projection
    y = y.reshape(B, S, H, dh)
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, H * dh) * p["ln_x_scale"].float() \
        + p["ln_x_bias"].float()
    y = y * F.silu(g)
    return _lib_dot(y, p["w_o"], dt).to(dt)


def op_rwkv6_channelmix(ctx: Ctx, op, p, x):
    """RWKV6 channel-mix: token-shift lerps in the compute dtype, then
    ``sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)`` on compute-dtype operands
    with fp32 products."""
    skey = op.attrs["state_key"]
    dt = ctx.compute_dtype
    xf = x.to(dt)
    prev = _token_shift(ctx, xf, skey + "_shift")
    dx = prev - xf
    mu = p["cm_mu"].to(dt)
    xr = xf + dx * mu[0]
    xk = xf + dx * mu[1]
    r = torch.sigmoid(_lib_dot(xr, p["cw_r"], dt))
    k = torch.square(F.relu(_lib_dot(xk, p["cw_k"], dt))).to(dt)
    return (r * _lib_dot(k, p["cw_v"], dt)).to(dt)


# ---------------------------------------------------------------------------
# Mixture-of-Experts FFN (capacity-based dispatch, one device)
# ---------------------------------------------------------------------------

def _top_k_stable(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, a tie broken
    toward the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pos_in_expert(fe: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, pick)'s slot within its expert, row by row: the number
    of earlier picks of the same expert in the row's flattened (S * k)
    order.  A stable argsort and a left ``searchsorted``, as in JAX."""
    B, Tk = fe.shape
    order = torch.sort(fe, dim=-1, stable=True).indices
    sorted_e = torch.gather(fe, 1, order)
    experts = torch.arange(E, dtype=fe.dtype, device=fe.device)
    starts = torch.searchsorted(sorted_e.contiguous(),
                                experts.expand(B, E).contiguous())
    pos_sorted = torch.arange(Tk, device=fe.device) \
        - torch.gather(starts, 1, sorted_e)
    return torch.zeros_like(fe).scatter_(1, order, pos_sorted)


#: an observer of each MoE layer's routing: called as ``hook(ctx, attrs,
#: probs, idx, keep)`` with the router's (B, S, E) fp32 probabilities, the
#: (B, S, k) expert ids picked and the (B, S * k) keep mask (1 kept, 0
#: dropped by capacity); ``ctx.aux["__inputs__"]`` holds the batch, its
#: ``positions`` included.  ``None`` outside instrumented runs; the op's
#: arithmetic does not depend on it.
ROUTING_HOOK: Optional[Callable] = None


def _moe_core(ctx: Ctx, attrs, x, router, wg, wu, wd, shared,
              eid0: int = 0, e_local: Optional[int] = None,
              stat_groups=None, stat_n: int = 1):
    """Dispatch -> expert FFN -> combine, the JAX package's ``_moe_core`` on
    one model shard.

    ``eid0`` / ``e_local``: the expert range this shard owns (expert
    parallel); with expert-TP every shard owns all experts on a d_ff
    slice.  Routing and the slot bookkeeping run whole on every shard;
    only this shard's experts (and its shared-expert slice) contribute to
    the output, a partial sum the caller reduces over the model axis.
    ``stat_groups`` (a dp-only mesh): the aux loss's router statistics
    are means over the global batch (sums over these groups / ``stat_n``),
    as GSPMD computes them.

    Routing in fp32: softmax over the experts, the top k (ties to the lower
    index), the gates renormalised.  Each sequence fills an expert's
    ``cap = ceil(S * k / E * capacity_factor)`` slots in token order; a
    pick past the last slot is dropped (``keep`` 0) and lands on slot
    ``cap - 1`` with a zero contribution, so the scatter adds exact zeros.
    The (B, E, cap, d) buffer runs through the experts as one ``bmm`` over
    E of (E, B * cap, d) x (E, d, f): every slot of every expert is
    computed, as in JAX.  Returns the output in the compute dtype and the
    router's auxiliary load-balancing loss (zero outside train)."""
    E, topk = attrs["num_experts"], attrs["top_k"]
    cf = attrs.get("capacity_factor", 1.25)
    B, S, d = x.shape
    dt = ctx.compute_dtype
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k_stable(probs, topk)                  # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ctx.mode == "train":
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
        if stat_groups:
            me = col.sync_sum_over(me, stat_groups) / stat_n
            ce = col.sync_sum_over(ce, stat_groups) / stat_n
        aux = attrs.get("aux_weight", 0.01) * E * torch.sum(me * ce)

    cap = max(math.ceil(S * topk / E * cf), 1)
    fe = idx.reshape(B, S * topk)
    fg = gate.reshape(B, S * topk).float()
    mypos = _pos_in_expert(fe, E)
    keep = (mypos < cap).float()
    mypos = torch.clamp(mypos, max=cap - 1)
    if ROUTING_HOOK is not None:
        ROUTING_HOOK(ctx, attrs, probs, idx, keep)
    El = e_local or E
    if El != E:                  # this shard's experts only (EP)
        fl = fe - eid0
        keep = keep * ((fl >= 0) & (fl < El)).float()
        fe = torch.clamp(fl, 0, El - 1)

    xr = torch.repeat_interleave(x, topk, dim=1) if topk > 1 else x
    contrib = (xr.float() * keep[..., None]).to(dt)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * topk)
    buf = torch.zeros((B, El, cap, d), dtype=dt, device=x.device).index_put(
        (rows, fe, mypos), contrib, accumulate=True)        # (B, E, cap, d)
    eb = buf.permute(1, 0, 2, 3).reshape(El, B * cap, d)
    hg = _lib_dot(eb, wg, dt)                               # (E, B*cap, f)
    hu = _lib_dot(eb, wu, dt)
    hmid = (_act(hg, attrs.get("act", "silu")) * hu).to(dt)
    out_buf = _lib_dot(hmid, wd, dt).to(dt)                 # (E, B*cap, d)
    out_buf = out_buf.reshape(El, B, cap, d).permute(1, 0, 2, 3)
    y = out_buf[rows, fe, mypos] * (fg * keep)[..., None].to(dt)
    y = y.reshape(B, S, topk, d).sum(2) if topk > 1 else y.reshape(B, S, d)
    if shared is not None:
        ws_g, ws_u, ws_d = shared
        sg = _lib_dot(x, ws_g, dt)
        su = _lib_dot(x, ws_u, dt)
        sh = (_act(sg, "silu") * su).to(dt)
        y = y + _lib_dot(sh, ws_d, dt).to(dt)
    return y.to(dt), aux


def _moe_shard_map(ctx: Ctx, op, p, x):
    """The MoE over the model axis, every collective explicit (the JAX
    package's ``_moe_shard_map``).

    The batch is the rank's rows; the expert weights are this rank's tp
    chunk (expert parallel when the experts split over tp, expert-TP on
    d_ff otherwise; the shared experts on d_ff), already gathered over dp
    by the lowering (the FSDP gather at the region's edge).  Each rank
    routes the whole of its rows, runs its experts and adds one fp32 sum of
    the (B, S, d) partial outputs over the model axis.  In train mode the
    router's aux loss joins ``ctx.aux`` as the rank's share of the mean
    over dp (each dp rank's own rows: GShard's per-shard means)."""
    rules, attrs = ctx.plan.rules, op.attrs
    E, tp, g = attrs["num_experts"], rules.tp_size, rules.tp_group
    ep = ctx.tp_dims.get("we_gate") == 0
    E_loc = E // tp if ep else E
    eid0 = rules.tp_rank * E_loc if ep else 0
    split = any(k in ctx.tp_dims for k in ("we_gate", "ws_gate"))
    xin = col.copy(x.to(ctx.compute_dtype), g) if split else x
    router = p["router"]             # routing runs whole on every shard
    if "router" in ctx.tp_dims:
        router = col.gather(router, ctx.tp_dims["router"], g)
    shared = ((p["ws_gate"], p["ws_up"], p["ws_down"])
              if attrs.get("num_shared") else None)
    y, aux = _moe_core(ctx, attrs, xin, router, p["we_gate"],
                       p["we_up"], p["we_down"], shared, eid0=eid0,
                       e_local=E_loc)
    if split:
        y = col.reduce(y.float(), g)
    if ctx.mode == "train":
        ctx.add_aux("moe_aux", aux / rules.dp_size)
    return y.to(ctx.compute_dtype)


def op_moe_ffn(ctx: Ctx, op, p, x):
    """Per-sequence, causal capacity dispatch (the JAX package's
    ``op_moe_ffn``): a token's slot in an expert counts only the earlier
    picks of its own sequence, so a sequence's routing does not depend on
    the rest of the batch, and appending a token never moves an earlier
    one.  A decode step (S = 1, one pick an expert at most) drops nothing.
    In train mode the router's load-balancing loss joins ``ctx.aux`` as
    ``moe_aux``.  On a mesh the experts run sharded over the model axis
    (:func:`_moe_shard_map`); over dp alone, on the rank's rows with the
    aux loss's statistics over the global batch."""
    rules = ctx.plan.rules
    if rules is not None and rules.tp:
        return _moe_shard_map(ctx, op, p, x)
    shared = ((p["ws_gate"], p["ws_up"], p["ws_down"])
              if op.attrs.get("num_shared") else None)
    dp = rules.dp_size if rules is not None else 1
    y, aux = _moe_core(ctx, op.attrs, x, p["router"], p["we_gate"],
                       p["we_up"], p["we_down"], shared,
                       stat_groups=rules.dp_groups if dp > 1 else None,
                       stat_n=dp)
    if ctx.mode == "train":
        ctx.add_aux("moe_aux", aux / dp)
    return y


# ---------------------------------------------------------------------------
# Multimodal and audio stubs
# ---------------------------------------------------------------------------

def op_patch_proj(ctx: Ctx, op, p, h):
    """Replace the first ``n_patches`` positions of the token-embedded
    sequence with the projected patch embeddings of the batch's
    ``patches`` (B, n_patches, d_vision): two products with biases around
    a tanh-GELU, each on compute-dtype operands in fp32, as in JAX."""
    patches = ctx.aux["__inputs__"]["patches"]
    dt = ctx.compute_dtype
    z = torch.matmul(patches.to(dt).float(), p["mm_w1"].to(dt).float()) \
        + p["mm_b1"].float()
    z = F.gelu(z, approximate="tanh")
    z = torch.matmul(z.to(dt).float(), p["mm_w2"].to(dt).float()) \
        + p["mm_b2"].float()
    n = op.attrs["n_patches"]
    return torch.cat([z.to(dt), h[:, n:, :]], dim=1)


def op_frames_in(ctx: Ctx, op, p, h):
    """The encoder-decoder's frontend stub: the batch's ``frames`` (B,
    encoder_seq, d_model) plus fp32 sinusoids of positions 0..S-1, in the
    compute dtype (``h``, the tokens, is not read)."""
    frames = ctx.aux["__inputs__"]["frames"]
    B, S, d = frames.shape
    pos = torch.arange(S, dtype=torch.int32, device=frames.device).expand(B, S)
    return (frames.float() + _sinusoid(pos, d)).to(ctx.compute_dtype)


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


def _conv_path(ctx: Ctx, x, w, *bn, stride, padding, groups, act):
    """The reference conv: fp32 products, then the epilogue."""
    dt = ctx.compute_dtype
    # the JAX reference upcasts bf16 operands and accumulates in fp32
    cdt = torch.float32 if dt == torch.bfloat16 else dt
    y = _conv_ref(x.to(cdt), w.to(cdt), stride, padding, groups).float()
    if bn:
        scale, bias, mean, var = bn
        inv = torch.rsqrt(var.float() + 1e-5)
        y = (y - mean.float()) * (inv * scale.float()) + bias.float()
    if act:
        y = _act(y, act)
    return y.to(dt)


def _conv_backend(ctx: Ctx, x, w, *, stride, padding, groups=1,
                  bn=None, act=None):
    """The conv entry point: the CUDA kernel where the plan selects it (a
    train plan's fp32 master weights rounded to the compute dtype), the
    reference conv elsewhere."""
    kern = plan_kernel(ctx.plan, "conv2d", groups=groups)
    geo = dict(stride=stride, padding=padding, groups=groups, act=act)
    bn = tuple(bn or ())
    if kern is None:
        return _conv_path(ctx, x, w, *bn, **geo)
    dt, tile = ctx.compute_dtype, ctx.plan.tiles.get("conv2d")

    def launch(x, w, *bn):
        if ctx.mode == "train":
            w = w.to(dt)
        return kern(x, w, stride=stride, padding=padding, bn=bn or None,
                    act=act, tile=tile)
    return _on_kernel(ctx, launch,
                      lambda x, w, *bn: _conv_path(ctx, x, w, *bn, **geo),
                      x, w, *bn)


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
    """Inference BN on the running ``mean``/``var``; in train mode on the
    batch's statistics over (N, H, W) in fp32, the population variance
    (``jnp.var``), the running ones neither read nor updated (as in JAX);
    on a mesh over the global batch (sums over the dp ranks)."""
    scale, bias, mean, var = _bn_params(p)
    rules = ctx.plan.rules
    if ctx.mode == "train" and rules is not None and rules.dp_size > 1:
        # the global batch's statistics: sums over the dp ranks' rows
        gs = rules.dp_groups
        xf = x.float()
        n = xf.shape[0] * xf.shape[1] * xf.shape[2] * rules.dp_size
        mean = col.sync_sum_over(xf.sum(dim=(0, 1, 2)), gs) / n
        var = col.sync_sum_over(
            torch.square(xf - mean).sum(dim=(0, 1, 2)), gs) / n
    elif ctx.mode == "train":
        xf = x.float()
        mean = torch.mean(xf, dim=(0, 1, 2))
        var = torch.mean(torch.square(xf - mean), dim=(0, 1, 2))
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
    "conv1d_causal": op_conv1d_causal, "rg_lru": op_rg_lru,
    "moe_ffn": op_moe_ffn, "patch_proj": op_patch_proj,
    "rwkv6_timemix": op_rwkv6_timemix,
    "rwkv6_channelmix": op_rwkv6_channelmix, "frames_in": op_frames_in,
}
