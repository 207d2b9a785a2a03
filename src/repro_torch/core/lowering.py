"""Lowering: ExecutionPlan × Graph → executable PyTorch functions.

* ``init_params``  — parameter dict (folded groups pre-stacked)
* ``param_shapes`` — the same tree as meta tensors (no allocation)
* ``init_state``   — serving state (KV caches, recurrent states), stacked
* ``_make_apply``  — apply(params, batch, state, cache_index, mode)
* ``make_loss_fn`` — the training loss, with the LM head's cross-entropy
  chunked over the sequence (the LM-head analogue of the paper's loop
  fusion: the full logits never exist)
* ``state_shardings`` — the serving state's placements on a mesh

On a mesh (``plan.rules``, set by ``repro_torch.flow.compile(mesh=...)``)
the parameters and the serving state are DTensors, each rank holding its
chunk; the functions above run on the rank's local tensors (the rules'
canonical layout: the batch split over dp, whole over tp) with explicit
collectives (:mod:`repro_torch.distributed.sharding`), and hand back
DTensors.  No kernel wrapper ever sees a DTensor.

Folded units (the paper's parameterized kernels; a ``lax.scan`` in the JAX
package) lower to a Python loop over the unit's repetitions, each step
running the unit's prototype blocks on that repetition's slice of the
stacked parameters and state; unfolded units lower to straight-line calls
(the pipelined mode's one-section-per-layer).  PyTorch runs eagerly, so
there is no jit stage.

Three modes: ``train`` (the full sequence, no state, the forward on the
plan's kernels and the backward through the reference ops, with the remat
policy of ``FlowConfig.remat`` as ``torch.utils.checkpoint``), ``prefill``
(images or tokens) and ``decode`` (one token over the rolling KV cache).
"""
from __future__ import annotations

import math
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.graph import Block, Graph, MicroOp, ParamSpec
from repro_torch.core.ops_impl import (OPS, TP_SPLIT_OPS, Ctx,
                                       decode_positions)
from repro_torch.core.ops_impl import remat as _remat
from repro_torch.core.passes.folding import Unit
from repro_torch.core.plan import ExecutionPlan
from repro_torch.distributed import collectives as col

MODES = ("train", "prefill", "decode")
AUX_KEYS = ("moe_aux",)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (1 << 31)
    return h


def _generator(seed: int, name: str) -> torch.Generator:
    """A CPU generator of its own for one parameter, seeded from
    ``(seed, _stable_hash(name))`` — the draw does not depend on the order
    of the other parameters or on the device."""
    g = torch.Generator(device="cpu")
    g.manual_seed((int(seed) << 31) | _stable_hash(name))
    return g


def _init_one(seed: int, name: str, spec: ParamSpec,
              dtype: torch.dtype) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype)
    if spec.init == "lru_lambda":
        # the RG-LRU decay: a = sigmoid(lambda)^c starts in [0.9, 0.999]^(1/8)
        u = torch.rand(shape, generator=_generator(seed, name),
                       dtype=torch.float32) * (0.999 - 0.9) + 0.9
        r = u ** (1.0 / 8.0)
        return torch.log(r / (1 - r)).to(dtype)
    if spec.init == "rwkv_mix":
        # the token-shift mixes: uniform on [0, 1)
        return torch.rand(shape, generator=_generator(seed, name),
                          dtype=torch.float32).to(dtype)
    if spec.init == "rwkv_decay":
        # the decay base and bonus: the deterministic ramp
        # -6 + 5 (i / (n - 1))^0.9 over the last axis (no draw)
        n = shape[-1]
        ramp = -6.0 + 5.0 * (torch.arange(n, dtype=torch.float32)
                             / max(n - 1, 1)) ** 0.9
        return ramp.expand(shape).to(dtype)
    if spec.init == "embed":
        scale = spec.init_scale or shape[-1] ** -0.5
    elif spec.init == "normal":
        # 1/sqrt(fan_in), fan_in = shape[-2] as in the JAX package
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = spec.init_scale or fan_in ** -0.5
    else:
        raise NotImplementedError(
            f"unknown init {spec.init!r} of {name} (the JAX package's are "
            "normal, embed, lru_lambda, rwkv_mix, rwkv_decay, zeros and "
            "ones)")
    x = torch.randn(shape, generator=_generator(seed, name),
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _fold_key(graph: Graph, unit: Unit) -> str:
    return f"fold_{graph.blocks[unit.indices[0]].name}"


def unit_key(graph: Graph, unit: Unit) -> str:
    if unit.folded:
        return _fold_key(graph, unit)
    return graph.blocks[unit.indices[0]].name


def init_params(plan: ExecutionPlan, seed: int, device: torch.device,
                workers: Optional[int] = None, rules=None) -> Dict[str, Any]:
    """Random parameters from ``seed``: each drawn on the CPU from its own
    generator, then moved to ``device``, so a seed gives the same weights
    on the CPU and on the card.  They are not the JAX package's numbers
    (``repro_torch.bridge`` carries those across).  A folded leaf is drawn
    one repetition's slice at a time (each from its own generator), and
    each slice is copied into the stacked leaf on ``device`` as it is
    drawn.  The draws run on a pool of ``workers`` host threads (the CPUs
    this process may run on by default), at most two a thread in flight, so the host holds
    a few slices at once, never a whole stacked leaf (a deepseek-moe-16b
    expert leaf is 19.9 GB in fp32): the values depend neither on the
    threads nor on the order the draws finish in.

    With ``rules`` (a mesh) each leaf becomes a DTensor under
    ``rules.params_shardings(plan)`` and the rank draws the same values,
    keeping its chunk: a leaf (a folded leaf's slice) is drawn whole on
    the host, cut there to the rank's index range, and only that chunk
    moves to ``device``; a folded leaf split over its repetitions draws
    only the rank's.  The device never holds more than the rank's shard."""
    graph, dtype = plan.graph, plan.prec.param_dtype
    workers = workers or len(os.sched_getaffinity(0)) or 1
    shd = rules.params_shardings(plan) if rules is not None else None
    params: Dict[str, Any] = {}
    draws: List[Tuple[Dict[str, Any], str, Optional[int], str, ParamSpec,
                      Tuple[slice, ...]]] = []

    def cut_of(top, key, shape):
        if shd is None:
            return (slice(None),) * len(shape)
        return rules.local_slices(shape, shd[top][key].placements)

    for unit in plan.units:
        if not unit.folded:
            b = graph.blocks[unit.indices[0]]
            bp: Dict[str, Any] = {}
            for spec in b.param_specs():
                bp[spec.name] = None
                draws.append((bp, spec.name, None, b.name + spec.name, spec,
                              cut_of(b.name, spec.name, spec.shape)))
            if bp:
                params[b.name] = bp
        else:
            period, reps = unit.period, unit.reps
            top = _fold_key(graph, unit)
            gp = {}
            for j in range(period):
                for spec in graph.blocks[unit.indices[j]].param_specs():
                    key = f"{j}:{spec.name}"
                    cut = cut_of(top, key, (reps,) + spec.shape)
                    r0, r1, _ = cut[0].indices(reps)
                    gp[key] = torch.empty(
                        (r1 - r0,) + tuple(len(range(n)[c]) for n, c in
                                           zip(spec.shape, cut[1:])),
                        dtype=dtype, device=device)
                    draws += [(gp, key, r - r0, graph.blocks[
                        unit.indices[r * period + j]].name + spec.name, spec,
                        cut[1:]) for r in range(r0, r1)]
            params[top] = gp

    def land(fut: Future) -> None:
        tree, key, r, x = fut.result()
        if r is None:
            tree[key] = x.to(device)
        else:
            tree[key][r].copy_(x)

    def one(tree, key, r, name, spec, cut):
        x = _init_one(seed, name, spec, dtype)
        y = x[cut]
        return tree, key, r, (y.contiguous().clone() if y.numel() != x.numel()
                              else y)

    window: List[Future] = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for d in draws:
            window.append(pool.submit(one, *d))
            if len(window) >= 2 * workers:
                land(window.pop(0))
        for fut in window:
            land(fut)
    if shd is None:
        return params
    shapes = param_shapes(plan)
    return {top: {k: rules.wrap(v, shd[top][k].placements,
                                shapes[top][k].shape)
                  for k, v in leaves.items()}
            for top, leaves in params.items()}


def param_shapes(plan: ExecutionPlan) -> Dict[str, Any]:
    """The parameter tree as meta tensors (shape and dtype, no storage)."""
    graph, dtype = plan.graph, plan.prec.param_dtype

    def meta(shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    for unit in plan.units:
        if not unit.folded:
            b = graph.blocks[unit.indices[0]]
            bp = {s.name: meta(s.shape) for s in b.param_specs()}
            if bp:
                out[b.name] = bp
        else:
            gp = {}
            for j in range(unit.period):
                proto = graph.blocks[unit.indices[j]]
                for s in proto.param_specs():
                    gp[f"{j}:{s.name}"] = meta((unit.reps,) + s.shape)
            out[_fold_key(graph, unit)] = gp
    return out


def param_specs_tree(plan: ExecutionPlan) -> Dict[str, Any]:
    """Same structure as params, holding (ParamSpec, stacked: bool)."""
    graph = plan.graph
    out: Dict[str, Any] = {}
    for unit in plan.units:
        if not unit.folded:
            b = graph.blocks[unit.indices[0]]
            bp = {s.name: (s, False) for s in b.param_specs()}
            if bp:
                out[b.name] = bp
        else:
            gp = {}
            for j in range(unit.period):
                proto = graph.blocks[unit.indices[j]]
                for s in proto.param_specs():
                    gp[f"{j}:{s.name}"] = (s, True)
            out[_fold_key(graph, unit)] = gp
    return out


# ---------------------------------------------------------------------------
# Serving state
# ---------------------------------------------------------------------------

def _op_state_shapes(op: MicroOp, cfg, B: int, C: int, dtype):
    """{suffix: (shape, dtype)} for one stateful op: the rolling KV cache of
    a self-attention op (``pos`` holds each slot's absolute position, -1
    for empty); the encoder's K/V of a cross-attention op (B,
    encoder_seq, KV, Dh); the last ``kw - 1`` inputs of a causal conv; the
    hidden state of an RG-LRU; an RWKV6 time-mix's last input ``_shift``
    (B, d) and WKV state ``_s`` (B, H, dh, dh), a channel-mix's ``_shift``."""
    a = op.attrs
    if op.op == "attention":
        att = cfg.attention
        KV, Dh = att.n_kv_heads, att.head_dim
        if a.get("cross"):
            S = cfg.encoder_seq
            return {"k": ((B, S, KV, Dh), dtype),
                    "v": ((B, S, KV, Dh), dtype)}
        return {"k": ((B, C, KV, Dh), dtype),
                "v": ((B, C, KV, Dh), dtype),
                "pos": ((B, C), torch.int32)}
    if op.op == "conv1d_causal":
        kw, w = op.params[0].shape
        return {"": ((B, kw - 1, w), dtype)}
    if op.op == "rg_lru":
        w = op.params[0].shape[0]
        return {"": ((B, w), dtype)}
    if op.op == "rwkv6_timemix":
        d = [s for s in op.params if s.name.endswith("w_r")][0].shape[0]
        H, dh = a["n_heads"], a["head_dim"]
        return {"_shift": ((B, d), dtype), "_s": ((B, H, dh, dh), dtype)}
    if op.op == "rwkv6_channelmix":
        d = [s for s in op.params if s.name.endswith("cw_r")][0].shape[0]
        return {"_shift": ((B, d), dtype)}
    return {}


def _mk_state(shapes: Dict[str, tuple], lead: Tuple[int, ...],
              device: torch.device):
    out = {}
    for suf, (shp, dt) in shapes.items():
        full = lead + shp
        if dt == torch.int32:
            out[suf] = torch.full(full, -1, dtype=dt, device=device)
        else:
            out[suf] = torch.zeros(full, dtype=dt, device=device)
    return out


def fake_mode():
    """The active ``FakeTensorMode``'s context, or a new mode's: tensors
    made inside have shapes, dtypes and devices but no storage (the
    dry-run's stand-ins; the JAX package's ``ShapeDtypeStruct``)."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    return FakeTensorMode(allow_non_fake_inputs=True)


def init_state(plan: ExecutionPlan, batch_size: int,
               device: torch.device, rules=None,
               abstract: bool = False) -> Dict[str, Any]:
    """Serving state, stacked to match the folded units: the JAX package's
    layout, ``{unit_key: {state_key: {"k", "v", "pos"}}}`` for attention
    and ``{unit_key: {state_key: tensor}}`` for the recurrent ops, with a
    leading ``(reps,)`` axis for folded units.  With ``rules`` (a mesh)
    each leaf is a DTensor placed by :func:`state_shardings`, the rank's
    chunk made on ``device`` (the whole state is never made).  With
    ``abstract`` the leaves are fake tensors (:func:`fake_mode`): shapes
    and placements, no storage."""
    if abstract:
        with fake_mode():
            return init_state(plan, batch_size, device, rules)
    graph, cfg = plan.graph, plan.cfg
    dtype = plan.prec.compute_dtype
    C = plan.cache_len
    state: Dict[str, Any] = {}
    made_on = "meta" if rules is not None else device
    for unit in plan.units:
        ust: Dict[str, Any] = {}
        blocks = [graph.blocks[unit.indices[j]] for j in range(unit.period)]
        lead = (unit.reps,) if unit.folded else ()
        for b in blocks:
            for op in b.stateful_ops():
                shapes = _op_state_shapes(op, cfg, batch_size, C, dtype)
                made = _mk_state(shapes, lead, made_on)
                key = op.attrs["state_key"]
                if op.op == "attention":      # attention state: a dict
                    ust[key] = made
                else:
                    for suf, v in made.items():
                        ust[key + suf] = v
        if ust:
            state[unit_key(graph, unit)] = ust
    if rules is None:
        return state

    def local(x, sh):             # the rank's chunk, made on the device
        if isinstance(x, dict):
            return {k: local(v, sh[k]) for k, v in x.items()}
        fill = -1 if x.dtype == torch.int32 else 0
        return rules.wrap(torch.full(rules.local_shape(x.shape,
                                                       sh.placements),
                                     fill, dtype=x.dtype, device=device),
                          sh.placements, x.shape)
    return local(state, state_shardings(plan, batch_size, rules))


def _op_state_roles(op: MicroOp) -> Dict[str, Tuple[str, ...]]:
    """{suffix: per-dim roles} of one stateful op's state (the JAX
    package's roles: the KV length over tp, the batch over dp, a
    recurrence's width or heads over tp)."""
    if op.op == "attention":
        if op.attrs.get("cross"):
            r = ("batch", "none", "none", "none")
            return {"k": r, "v": r}
        r = ("batch", "kv_len", "none", "none")
        return {"k": r, "v": r, "pos": ("batch", "kv_len")}
    if op.op == "conv1d_causal":
        return {"": ("batch", "none", "d_ff")}
    if op.op == "rg_lru":
        return {"": ("batch", "d_ff")}
    if op.op == "rwkv6_timemix":
        return {"_shift": ("batch", "none"),
                "_s": ("batch", "heads", "none", "none")}
    if op.op == "rwkv6_channelmix":
        return {"_shift": ("batch", "none")}
    return {}


def state_layout(plan: ExecutionPlan, batch_size: int) -> Dict[str, Any]:
    """The serving state's tree (as :func:`init_state` builds it) with
    ``(shape, roles)`` leaves; a folded unit's leaves lead with
    ``("layers",)``."""
    graph, cfg = plan.graph, plan.cfg
    out: Dict[str, Any] = {}
    for unit in plan.units:
        ust: Dict[str, Any] = {}
        lead = (unit.reps,) if unit.folded else ()
        lroles = ("layers",) * len(lead)
        for j in range(unit.period):
            for op in graph.blocks[unit.indices[j]].stateful_ops():
                shapes = _op_state_shapes(op, cfg, batch_size,
                                          plan.cache_len, None)
                roles = _op_state_roles(op)
                made = {suf: (lead + tuple(shp), lroles + roles[suf])
                        for suf, (shp, _) in shapes.items()}
                key = op.attrs["state_key"]
                if op.op == "attention":
                    ust[key] = made
                else:
                    for suf, v in made.items():
                        ust[key + suf] = v
        if ust:
            out[unit_key(graph, unit)] = ust
    return out


def state_shardings(plan: ExecutionPlan, batch_size: int, rules
                    ) -> Dict[str, Any]:
    """NamedSharding tree for the serving state (role-driven: the batch
    over dp, the KV length over tp)."""
    from repro_torch.distributed.sharding import NamedSharding

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        shape, roles = x
        return NamedSharding(rules.mesh, rules.act_pspec(roles, shape))
    return one(state_layout(plan, batch_size))


# ---------------------------------------------------------------------------
# Block interpretation (with per-mode dead-code elimination)
# ---------------------------------------------------------------------------

def _used_ins(op: MicroOp, mode: str) -> Tuple[str, ...]:
    if op.op == "attention" and op.attrs.get("cross") and mode == "decode":
        return (op.ins[0], op.ins[3])       # q, positions (K/V come from cache)
    return op.ins


def live_ops(block: Block, mode: str) -> List[MicroOp]:
    keep = [False] * len(block.ops)
    live = {"h"}
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        needed = op.out in live
        if op.attrs.get("state_key") and mode in ("prefill", "decode"):
            needed = True
        if needed:
            keep[i] = True
            live.discard(op.out)
            live.update(_used_ins(op, mode))
    return [op for i, op in enumerate(block.ops) if keep[i]]


def _param_slice(op: MicroOp, bparams: Dict[str, Any], j: Optional[int]):
    """Dict param-name → tensor for one op (handles folded 'j:' prefixes)."""
    out = {}
    for spec in op.params:
        key = spec.name if j is None else f"{j}:{spec.name}"
        out[spec.name] = bparams[key]
    return out


def _op_params(ctx: Ctx, op: MicroOp, bparams, j: Optional[int],
               bdims: Optional[Dict[str, int]]):
    """One op's params, and ``ctx.tp_dims`` set to the dims left split over
    tp: on a mesh an op of ``TP_SPLIT_OPS`` computes on its tp chunks, the
    others get each tp-split param all-gathered (backward: the chunk)."""
    p = _param_slice(op, bparams, j)
    dims = {}
    if bdims:
        for spec in op.params:
            d = bdims.get(spec.name if j is None else f"{j}:{spec.name}")
            if d is not None:
                dims[spec.name] = d
    if dims and op.op not in TP_SPLIT_OPS:
        g = ctx.plan.rules.tp_group
        p = {n: col.gather(t, dims[n], g) if n in dims else t
             for n, t in p.items()}
        dims = {}
    ctx.tp_dims = dims
    return p


def _run_block(ctx: Ctx, block: Block, bparams, env: Dict[str, Any],
               mode: str, j: Optional[int] = None,
               tied_tables: Optional[Dict[str, Any]] = None,
               bdims: Optional[Dict[str, int]] = None):
    """Run one block's live ops.  ``tied_tables`` maps ``"<block>/table"``
    to (table, its tp-split dim or None); ``bdims`` holds the tp-split dim
    of each of ``bparams``' leaves on a mesh."""
    for op in live_ops(block, mode):
        args = [env[i] for i in _used_ins(op, mode)]
        if op.op == "attention" and len(args) == 2:    # decode cross-attn
            q, pos = args
            args = [q, q, q, pos]                       # K/V placeholders
        p = _op_params(ctx, op, bparams, j, bdims)
        if op.op == "unembed" and op.attrs.get("tied"):
            table, d = tied_tables[op.attrs["tied"]]
            args.append(table)
            if d is not None:
                ctx.tp_dims["tied"] = d
        env[op.out] = OPS[op.op](ctx, op, p, *args)
    return env["h"]


class _Params:
    """The parameters as the ops see them, a unit at a time: without a mesh
    the tree itself; on a mesh (``rules``) each leaf's local chunk (a
    DTensor's, or a local tensor the train step holds) gathered over dp at
    its unit's first use (the FSDP all-gather, once a call), its tp chunk
    kept and its tp-split dim recorded."""

    def __init__(self, params, rules=None, shardings=None):
        self.params, self.rules, self.shardings = params, rules, shardings
        self._views: Dict[str, Any] = {}

    def unit(self, key: str) -> Tuple[Dict[str, Any], Dict[str, int]]:
        if self.rules is None:
            return self.params.get(key, {}), {}
        if key not in self._views:
            vals, dims = {}, {}
            for k, x in self.params.get(key, {}).items():
                vals[k], d = self.rules.materialize(
                    x, self.shardings[key][k])
                if d is not None:
                    dims[k] = d
            self._views[key] = (vals, dims)
        return self._views[key]


# ---------------------------------------------------------------------------
# apply()
# ---------------------------------------------------------------------------

def _make_apply(plan: ExecutionPlan, head: bool = True):
    """Returns apply(params, batch, state=None, cache_index=None,
    mode="prefill") -> (out, new_state, aux).

    ``batch`` holds ``images`` (B, H, W, C) or ``tokens`` (B, S) int, and
    optionally ``positions`` (B, S).  Prefill returns the logits of the last
    position only and the state it built; decode (S = 1 at position
    ``cache_index``) writes the new K/V into ``state`` in place and returns
    that same state: it consumes its argument, as the JAX stage donates it.
    Train returns every position's output and no state.  ``head=False``
    stops before the LM head block (the loss runs it, chunked).  ``aux``
    holds the auxiliary losses the ops added (``moe_aux``, the MoE
    router's load-balancing loss in train mode; empty otherwise).  The
    batch rides in ``ctx.aux["__inputs__"]`` for the ops that read more
    than the tokens (the multimodal stub's ``patches``, the
    encoder-decoder's ``frames``) and is not returned.  Decode skips the
    prompt-only ``mm`` and ``enc*`` blocks: the patches live in the KV
    cache by then, the encoder's output in the cross-attention K/V.  An
    encoder-decoder's chain restarts from the tokens at ``dec_embed``, and
    every unit after the ``captures_cross`` block sees its output as
    ``cross``."""
    graph, units = plan.graph, plan.units
    rules = plan.rules
    shardings = rules.params_shardings(plan) if rules is not None else None
    vocab = _vocab_rows(plan) if rules is not None and head and \
        plan.cfg.family != "cnn" else None

    def constrain(x, roles):
        return x if rules is None else rules.constrain_act(x, roles)

    def run(pv: _Params, batch, state, cache_index, mode, row_groups=None):
        """The program on one rank's tensors: ``pv`` the parameter views,
        ``batch`` and ``state`` local (the whole of them without a mesh;
        ``row_groups``: see :attr:`Ctx.row_groups`)."""
        ctx = Ctx(mode=mode, plan=plan, cache_index=cache_index,
                  constrain=constrain, row_groups=row_groups)
        ctx.aux["__inputs__"] = batch
        new_state: Dict[str, Any] = {}
        tokens = "tokens" in batch
        h = batch["tokens"] if tokens else batch["images"]
        B = h.shape[0]

        def pos_for(x, encoder=False):
            # positions of the current chain: explicit per-row positions
            # (left-padded prefill; decoder chains only), the decode
            # position, or an arange (an encoder chain always)
            if not tokens:
                return None
            S = x.shape[1]
            p = None if encoder else batch.get("positions")
            if p is not None and p.ndim == 2 and p.shape[1] == S:
                return p.to(torch.int32)
            if mode == "decode":
                return decode_positions(cache_index, B, S, x.device)
            return torch.arange(S, dtype=torch.int32,
                                device=x.device).expand(B, S)

        tied_tables = {}
        for unit in units:
            b0 = graph.blocks[unit.indices[0]]
            for spec in b0.param_specs():
                if spec.name == "table":
                    vals, dims = pv.unit(b0.name)
                    tied_tables[f"{b0.name}/table"] = (vals["table"],
                                                       dims.get("table"))

        cross = None
        if not tokens:                  # the CNN batch, over dp
            h = ctx.cst(h, ("batch",) + ("none",) * (h.ndim - 1))
        for unit in units:
            ukey = unit_key(graph, unit)
            b0 = graph.blocks[unit.indices[0]]
            encoder = b0.kind.startswith("enc")
            if mode == "decode" and (encoder or b0.kind == "mm"):
                continue   # prompt-only: patches and frames are in the cache
            if b0.kind == "dec_embed":
                h = batch["tokens"]
            if b0.kind == "head":
                if not head:
                    break
                if mode == "prefill":
                    h = h[:, -1:]
            env = {"h": h, "cross": cross,
                   "positions": pos_for(h, encoder=encoder)}
            uparams, udims = pv.unit(ukey)
            if not unit.folded:
                ctx.state_in = (state or {}).get(ukey, {})
                ctx.state_out = {}
                h = _run_block(ctx, b0, uparams, env, mode,
                               tied_tables=tied_tables, bdims=udims)
                if ctx.state_out:
                    new_state[ukey] = ctx.state_out
            else:
                h, st = _run_folded(ctx, plan, unit, uparams,
                                    (state or {}).get(ukey), env, mode,
                                    gdims=udims)
                if st:
                    new_state[ukey] = st
            if b0.attrs.get("captures_cross"):
                cross = h                 # the encoder's output
        aux = {k: v for k, v in ctx.aux.items() if k != "__inputs__"}
        if mode == "decode":            # the state handed in, updated
            state.update(new_state)
            return h, state, aux
        return h, new_state, aux

    def local_batch(batch):
        if rules is None:
            return batch
        return {k: rules.local_batch(v) if torch.is_tensor(v) and v.ndim
                else v for k, v in batch.items()}

    def params_view(params) -> _Params:
        return _Params(params, rules, shardings)

    def check(mode, state, cache_index):
        if mode not in MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet; the port runs {MODES} "
                "(ROADMAP Queue 1)")
        if mode == "decode" and (state is None or cache_index is None):
            raise ValueError("decode needs the serving state and cache_index")

    if rules is None:
        def apply(params, batch, state=None, cache_index=None,
                  mode="prefill"):
            check(mode, state, cache_index)
            return run(_Params(params), batch, state, cache_index, mode)
    else:
        def apply(params, batch, state=None, cache_index=None,
                  mode="prefill"):
            check(mode, state, cache_index)
            return _mesh_apply(plan, rules, run, params_view(params), batch,
                               state, cache_index, mode, head,
                               local_batch(batch), vocab)

    apply.run = run
    apply.local_batch = local_batch
    apply.params_view = params_view
    return apply


def _is_attention(tree) -> bool:
    return isinstance(tree, dict) and ("k" in tree or "pos" in tree)


def _state_locals(rules, state):
    """A mesh's DTensor state -> the rank's tensors for the ops: an
    attention op's caches as their chunks (the op gathers the length over
    tp itself), every other leaf all-gathered over tp into the canonical
    layout.  Returns the tree and [(at-rest local, canonical, tp dim)]
    for :func:`_state_writeback`."""
    from repro_torch.distributed.sharding import local_of
    back = []

    def one(x, attention):
        if isinstance(x, dict):
            return {k: one(v, attention or _is_attention(x))
                    for k, v in x.items()}
        local = local_of(x)
        d = rules.tp_dim(x.placements)
        if attention or d is None:
            return local
        whole = rules.gather_act(local, [d])
        back.append((local, whole, d))
        return whole
    return one(state, False), back


def _wrap_state(rules, tree, layout, shardings):
    """The rank's state tree after a prefill -> DTensors: attention caches
    come chunked by the op's constraint, every other leaf canonical and
    cut here."""
    def one(x, lay, sh, attention):
        if isinstance(x, dict):
            return {k: one(v, lay[k], sh[k], attention or _is_attention(x))
                    for k, v in x.items()}
        d = rules.tp_dim(sh.placements)
        if not attention and d is not None:
            x = x.chunk(rules.tp_size, dim=d)[rules.tp_rank]
        return rules.wrap(x.contiguous(), sh.placements, lay[0])
    return one(tree, layout, shardings, False)


def _mesh_apply(plan, rules, run, pv, batch, state, cache_index, mode,
                head: bool, lbatch, vocab: Optional[int]):
    """``apply`` on a mesh: the rank runs its rows of ``batch`` (a whole
    batch, replicated on every rank) on its parameter and state chunks;
    the output comes back a DTensor (an LM's logits: the batch over dp and
    the vocab over tp, as ``op_unembed`` leaves them; a CNN's: the batch
    over dp), the state a DTensor tree (a decode's in place)."""
    x0 = batch["tokens"] if "tokens" in batch else batch["images"]
    B = x0.shape[0]
    if mode == "decode" and not _is_dtensor_tree(state):
        h, aux = _replicated_decode(plan, rules, run, pv, lbatch, state,
                                    cache_index, B)
        new_state = state
    elif mode == "decode":
        local, back = _state_locals(rules, state)
        h, _, aux = run(pv, lbatch, local, cache_index, mode)
        _state_writeback(rules, back)
        new_state = state
    else:
        h, new_state, aux = run(pv, lbatch, None, cache_index, mode)
        if new_state:
            new_state = _wrap_state(rules, new_state, state_layout(plan, B),
                                    state_shardings(plan, B, rules))
    if not head:
        return h, new_state, aux
    if "tokens" in batch:
        shape = (B, h.shape[1], vocab)
        roles = ("batch", "seq", "vocab")
    else:
        shape = (B,) + tuple(h.shape[1:])
        roles = ("batch",) + ("none",) * (h.ndim - 1)
    from repro_torch.distributed.sharding import placements_of
    pl = placements_of(rules.act_pspec(roles, shape), rules.spec.names)
    return rules.wrap(h.contiguous(), pl, shape), new_state, aux


def _is_dtensor_tree(tree) -> bool:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return any(_is_dtensor_tree(v) for v in tree.values())
    return isinstance(tree, DTensor)


#: the leaves of a paged entry that hold no row of the batch (the pools)
_POOL_KEYS = ("kp", "vp")


def _replicated_decode(plan, rules, run, pv, lbatch, state, cache_index,
                       B: int):
    """A decode over a state every rank holds whole (the serving engine's
    paged pool, block tables, lengths and dense per-slot rows; JAX keeps it
    one logical array outside any sharding).  The rank runs its rows of the
    batch (its dp chunk where ``B`` splits over dp, every row where it does
    not): the ops see the pools whole and every other leaf as a view of the
    rank's rows.  The pool writes gather their rows over dp
    (``Ctx.row_groups``); after the step each row leaf the step writes
    (lengths, dense rows) is gathered over dp into the whole leaf, so the
    state is identical on every rank.  Returns (h, aux)."""
    split = rules.batch_is_split(B) and rules.dp_size > 1
    groups = rules.dp_groups if split else None
    folded = {unit_key(plan.graph, u): u.folded for u in plan.units}
    back = []

    def rows(x, ax):
        if not split:
            return x
        n = x.shape[ax] // rules.dp_size
        idx = col.split_over(torch.arange(x.shape[ax]), 0, rules.dp_groups)
        return x.narrow(ax, int(idx[0]), n)

    def local(tree, ax, key=""):
        if isinstance(tree, dict):
            return {k: local(v, ax, k) for k, v in tree.items()}
        if key in _POOL_KEYS:
            return tree
        view = rows(tree, ax)
        if split and key != "bt":
            back.append((tree, view, ax))
        return view
    lstate = {u: local(s, 1 if folded.get(u) else 0)
              for u, s in state.items()}
    h, _, aux = run(pv, lbatch, lstate, cache_index, "decode",
                    row_groups=groups)
    with torch.no_grad():
        for whole, view, ax in back:
            whole.copy_(col.gather_over(view, ax, rules.dp_groups))
    return h, aux


def _state_writeback(rules, back) -> None:
    """After a decode: each canonical state leaf's tp chunk back into the
    at-rest chunk it was gathered from."""
    with torch.no_grad():
        for local, whole, d in back:
            local.copy_(whole.chunk(rules.tp_size, dim=d)[rules.tp_rank])


def _vocab_rows(plan: ExecutionPlan) -> int:
    """The rows of the LM head's table (the padded vocabulary)."""
    un = plan.graph.blocks[-1].ops[-1]
    if un.attrs.get("tied"):
        top, leaf = un.attrs["tied"].split("/")
        return param_shapes(plan)[top][leaf].shape[0]
    return param_shapes(plan)[plan.graph.blocks[-1].name]["lm_head"].shape[0]


def _slice_tree(tree, r: int):
    return {k: _slice_tree(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _empty_stacked(tree: Dict[str, Any], reps: int) -> Dict[str, Any]:
    """An uninitialised tree shaped as ``tree`` with a leading (reps,)."""
    return {k: _empty_stacked(v, reps) if isinstance(v, dict)
            else v.new_empty((reps,) + tuple(v.shape))
            for k, v in tree.items()}


def _copy_into(stacked: Dict[str, Any], tree: Dict[str, Any], r: int):
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, r)
        else:
            stacked[k][r].copy_(v)


def _run_folded(ctx: Ctx, plan: ExecutionPlan, unit: Unit, gparams,
                gstate, env, mode: str,
                gdims: Optional[Dict[str, int]] = None):
    """A folded unit: a loop over its repetitions, each running the unit's
    ``period`` prototype blocks on slice ``r`` of the stacked params and
    state.  Prefill stacks the repetitions' new state; decode updates the
    stacked state it was given, in place, and returns it; train runs the
    remat policy (:func:`_run_folded_train`) and returns no state.  The
    repetitions' aux losses (``AUX_KEYS``) are summed into ``ctx.aux``;
    in train mode the sum rides beside ``h`` through the checkpoints, as
    JAX's scan carries it.  ``gdims`` (a mesh) holds each stacked leaf's
    tp-split dim."""
    protos = [plan.graph.blocks[unit.indices[j]] for j in range(unit.period)]
    added = set()
    step_dims = {k: d - 1 for k, d in (gdims or {}).items()}

    def rep(h, r: int):
        step_params = {k: v[r] for k, v in gparams.items()}
        c = Ctx(mode=mode, plan=plan, cache_index=ctx.cache_index,
                aux={"__inputs__": ctx.aux.get("__inputs__")},
                constrain=ctx.constrain, row_groups=ctx.row_groups)
        c.state_in = _slice_tree(gstate, r) if gstate else {}
        c.state_out = {}
        e = {"h": h, "positions": env["positions"], "cross": env["cross"]}
        for j, blk in enumerate(protos):
            e["h"] = _run_block(c, blk, step_params, e, mode, j=j,
                                bdims=step_dims)
        aux = {k: c.aux[k] for k in AUX_KEYS if k in c.aux}
        added.update(aux)
        return e["h"], c.state_out, aux

    if mode == "train":
        def one(h, acc, r: int):
            h, _, aux = rep(h, r)
            return h, tuple(a + aux[k] if k in aux else a
                            for k, a in zip(AUX_KEYS, acc))
        zero = torch.zeros((), dtype=torch.float32, device=env["h"].device)
        h, acc = _run_folded_train(one, unit.reps, plan.flow.remat,
                                   env["h"], (zero,) * len(AUX_KEYS))
        for k, a in zip(AUX_KEYS, acc):
            if k in added:
                ctx.add_aux(k, a)
        return h, {}
    h = env["h"]
    stacked: Optional[Dict[str, Any]] = None
    for r in range(unit.reps):
        h, st, aux = rep(h, r)
        for k, a in aux.items():
            ctx.add_aux(k, a)
        if not st or mode == "decode":  # decode wrote into gstate's slices
            continue
        # prefill: each repetition's state lands in its slice of the
        # stacked tree as it is made, so the unstacked copies never add up
        if stacked is None:
            stacked = _empty_stacked(st, unit.reps)
        _copy_into(stacked, st, r)
    if mode == "decode":
        return h, gstate if gstate else {}
    return h, stacked or {}


def _checkpointed(fn):
    def run(*args):
        return _remat(fn, *args)
    return run


def _run_folded_train(one, reps: int, remat: str, h, acc: tuple):
    """A folded unit in train mode, ``one(h, acc, r) -> (h, acc)`` a
    repetition (``acc`` the running aux losses), under the JAX package's
    remat policy (its ``jax.checkpoint`` placement):
    ``block`` checkpoints each repetition, so the backward pass keeps only
    the repetitions' inputs and recomputes one at a time; ``nested`` (with
    4 or more repetitions) checkpoints groups of k (the largest divisor of
    ``reps`` at or below its square root) around the checkpointed
    repetitions, keeping O(reps / k + k) inputs; ``none`` keeps every
    activation."""
    if remat == "nested" and reps >= 4:
        k = max(math.isqrt(reps), 1)
        while reps % k:
            k -= 1
        inner = _checkpointed(one)

        def group(x, a, g0: int):
            for r in range(g0, g0 + k):
                x, a = inner(x, a, r)
            return x, a
        outer = _checkpointed(group)
        for g0 in range(0, reps, k):
            h, acc = outer(h, acc, g0)
        return h, acc
    step = _checkpointed(one) if remat in ("block", "nested") else one
    for r in range(reps):
        h, acc = step(h, acc, r)
    return h, acc


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross-entropy: the logits never fully materialize)
# ---------------------------------------------------------------------------

def make_loss_fn(plan: ExecutionPlan):
    """loss_fn(params, batch) -> (loss, metrics), differentiable in
    ``params``.

    A CNN: the mean NLL of the fp32 ``log_softmax`` of the logits at
    ``batch["labels"]`` (B,); metrics ``{"loss"}``.  An LM: the trunk in
    train mode without its head block, then the head block's ops up to the
    unembed (the final norm), then :func:`_chunked_ce_sums` over the sequence
    with the tied table or ``lm_head``; ``batch["labels"]`` (B, S), entries
    < 0 ignored; metrics ``{"loss", "acc"}`` (argmax accuracy over the
    valid labels) and the aux losses the ops added (``AUX_KEYS``: a MoE
    model's ``moe_aux``), which the returned loss includes.

    On a mesh the batch is the global one and ``params`` DTensors or the
    local chunks the train step holds; each rank takes its rows, its part
    of the loss carries 1 / (the global count), and the returned loss is
    the sum of the parts over dp (backward: each rank's own part), so the
    loss and the gradients are the single-device ones over the global
    batch (a MoE's aux loss: the mean over dp of each rank's, GShard's
    per-shard means, as in JAX)."""
    cfg = plan.cfg
    rules = plan.rules
    apply = _make_apply(plan, head=cfg.family == "cnn")
    head_block = plan.graph.blocks[-1]
    if head_block.kind not in ("head", "cnn_head"):
        raise ValueError(f"the last block is {head_block.kind!r}, not a head")

    def dp_sum(x, grad=True):
        if rules is None:
            return x
        if grad:
            return col.reduce_over(x, rules.dp_groups)
        return col.all_reduce_(x.detach().clone(), rules.dp_groups)

    def loss_fn(params, batch):
        pv = apply.params_view(params)
        lb = apply.local_batch(batch)
        if cfg.family == "cnn":
            logits, _, _ = apply.run(pv, lb, None, None, "train")
            labels = lb["labels"].long()
            lp = torch.log_softmax(logits.float(), dim=-1)
            ll = lp.gather(-1, labels[:, None])[:, 0]
            if rules is None:
                loss = -torch.mean(ll)
            else:
                n = dp_sum(torch.tensor(float(labels.shape[0]),
                                        device=ll.device), grad=False)
                loss = dp_sum(-torch.sum(ll) / n)
            return loss, {"loss": loss}

        h, _, aux = apply.run(pv, lb, None, None, "train")
        ctx = Ctx(mode="train", plan=plan)
        if rules is not None:
            ctx.constrain = rules.constrain_act
        env = {"h": h}
        hp, hdims = pv.unit("head")
        ops = head_block.ops
        for op in ops:
            if op.op == "unembed":
                break
            env[op.out] = OPS[op.op](ctx, op,
                                     _op_params(ctx, op, hp, None, hdims),
                                     *[env[i] for i in op.ins])
        un = ops[-1]
        hn = env[un.ins[0]] if un.op == "unembed" else env["h"]
        if un.attrs.get("tied"):
            tp_, td = pv.unit(un.attrs["tied"].split("/")[0])
            table, tdim = tp_["table"], td.get("table")
        else:
            table, tdim = hp["lm_head"], hdims.get("lm_head")
        nll, cnt, cor = _chunked_ce_sums(ctx, hn, table, lb["labels"],
                                         cfg.vocab_size,
                                         plan.tiles.get("ce_chunk", 256),
                                         tp_dim=tdim)
        denom = torch.clamp(dp_sum(cnt, grad=False), min=1.0)
        part = nll / denom
        auxs = {k: aux[k] for k in AUX_KEYS if k in aux}
        total = dp_sum(part + sum(auxs.values()))
        if rules is None:
            return total, {"loss": part, "acc": cor / denom, **aux}
        return total, {"loss": dp_sum(part, grad=False),
                       "acc": dp_sum(cor / denom, grad=False),
                       **{k: dp_sum(v, grad=False) for k, v in aux.items()}}

    return loss_fn


def _chunked_ce_sums(ctx: Ctx, h, table, labels, true_vocab: int,
                     chunk: int, tp_dim: Optional[int] = None):
    """(the NLL's sum, the valid labels' count, the argmax hits' count) of
    ``h @ table.T`` against ``labels`` over sequence chunks (the chunk
    halved until it divides S).  Each chunk's (B, chunk, V) fp32 logits
    come from the bf16-rounded (in bf16 compute) operands multiplied in
    fp32, as ``op_unembed`` computes them, padded vocab entries at -1e9;
    the chunk is checkpointed, so the backward pass recomputes its logits
    instead of keeping them.  ``tp_dim`` (a mesh): the table is this tp
    rank's rows of the vocabulary, and each chunk's logits are
    all-gathered over tp before the softmax."""
    B, S, _ = h.shape
    Vl = table.shape[0]
    dt = ctx.compute_dtype
    while S % chunk:
        chunk //= 2
    chunk = max(chunk, 1)
    off, g = 0, None
    if tp_dim is not None:
        rules = ctx.plan.rules
        off, g = rules.tp_rank * Vl, rules.tp_group
        h = col.copy(h, g)       # each rank's vocab rows: a partial dh
    pad = torch.arange(off, off + Vl, device=h.device) >= true_vocab
    labels = labels.long()

    def one(hc, lc):
        logits = torch.matmul(hc.to(dt).float(), table.to(dt).float().T)
        logits = logits.masked_fill(pad, -1e9)
        if g is not None:
            logits = col.gather(logits, -1, g)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
        valid = (lc >= 0).float()
        correct = (torch.argmax(logits, dim=-1) == lc).float() * valid
        return ((lse - ll) * valid).sum(), valid.sum(), correct.sum()

    parts = [_remat(one, h[:, i:i + chunk], labels[:, i:i + chunk])
             for i in range(0, S, chunk)]
    return tuple(sum(p[i] for p in parts) for i in range(3))

