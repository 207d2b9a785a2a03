"""Lowering: ExecutionPlan × Graph → executable PyTorch functions.

* ``init_params``  — parameter dict (folded groups pre-stacked)
* ``param_shapes`` — the same tree as meta tensors (no allocation)
* ``init_state``   — serving state (the attention KV caches), stacked
* ``_make_apply``  — apply(params, batch, state, cache_index, mode)

Folded units (the paper's parameterized kernels; a ``lax.scan`` in the JAX
package) lower to a Python loop over the unit's repetitions, each step
running the unit's prototype blocks on that repetition's slice of the
stacked parameters and state; unfolded units lower to straight-line calls
(the pipelined mode's one-section-per-layer).  PyTorch runs eagerly, so
there is no jit stage.

The port lowers the inference path: ``prefill`` (images or tokens) and
``decode`` (one token over the rolling KV cache).  Training and the LM
head's chunked loss arrive with a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.graph import Block, Graph, MicroOp, ParamSpec
from repro_torch.core.ops_impl import OPS, Ctx
from repro_torch.core.passes.folding import Unit
from repro_torch.core.plan import ExecutionPlan

MODES = ("prefill", "decode")


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
    if spec.init == "embed":
        scale = spec.init_scale or shape[-1] ** -0.5
    elif spec.init == "normal":
        # 1/sqrt(fan_in), fan_in = shape[-2] as in the JAX package
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = spec.init_scale or fan_in ** -0.5
    else:
        raise NotImplementedError(
            f"init {spec.init!r} of {name} is not ported yet (the port uses "
            "normal, embed, zeros and ones)")
    x = torch.randn(shape, generator=_generator(seed, name),
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def _fold_key(graph: Graph, unit: Unit) -> str:
    return f"fold_{graph.blocks[unit.indices[0]].name}"


def unit_key(graph: Graph, unit: Unit) -> str:
    if unit.folded:
        return _fold_key(graph, unit)
    return graph.blocks[unit.indices[0]].name


def init_params(plan: ExecutionPlan, seed: int,
                device: torch.device) -> Dict[str, Any]:
    """Random parameters from ``seed``: each drawn on the CPU from its own
    generator, then moved to ``device``, so a seed gives the same weights
    on the CPU and on the card.  They are not the JAX package's numbers
    (``repro_torch.bridge`` carries those across)."""
    graph, dtype = plan.graph, plan.prec.param_dtype
    params: Dict[str, Any] = {}
    for unit in plan.units:
        if not unit.folded:
            b = graph.blocks[unit.indices[0]]
            bp = {spec.name: _init_one(seed, b.name + spec.name, spec,
                                       dtype).to(device)
                  for spec in b.param_specs()}
            if bp:
                params[b.name] = bp
        else:
            period, reps = unit.period, unit.reps
            gp: Dict[str, Any] = {}
            for j in range(period):
                proto = graph.blocks[unit.indices[j]]
                for spec in proto.param_specs():
                    slices = [_init_one(
                        seed, graph.blocks[unit.indices[r * period + j]].name
                        + spec.name, spec, dtype) for r in range(reps)]
                    gp[f"{j}:{spec.name}"] = torch.stack(slices).to(device)
            params[_fold_key(graph, unit)] = gp
    return params


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


# ---------------------------------------------------------------------------
# Serving state
# ---------------------------------------------------------------------------

def _op_state_shapes(op: MicroOp, cfg, B: int, C: int, dtype):
    """{suffix: (shape, dtype)} for one stateful op: the rolling KV cache of
    a self-attention op (``pos`` holds each slot's absolute position, -1
    for empty).  The recurrent families' state arrives with them."""
    if op.op == "attention" and not op.attrs.get("cross"):
        att = cfg.attention
        KV, Dh = att.n_kv_heads, att.head_dim
        return {"k": ((B, C, KV, Dh), dtype),
                "v": ((B, C, KV, Dh), dtype),
                "pos": ((B, C), torch.int32)}
    raise NotImplementedError(
        f"serving state of {op.op!r} (cross={op.attrs.get('cross', False)}) "
        "is not ported yet (ROADMAP Queue 1, item 12)")


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


def init_state(plan: ExecutionPlan, batch_size: int,
               device: torch.device) -> Dict[str, Any]:
    """Serving state, stacked to match the folded units: the JAX package's
    layout, ``{unit_key: {state_key: {"k", "v", "pos"}}}``, with a leading
    ``(reps,)`` axis for folded units."""
    graph, cfg = plan.graph, plan.cfg
    dtype = plan.prec.compute_dtype
    C = plan.cache_len
    state: Dict[str, Any] = {}
    for unit in plan.units:
        ust: Dict[str, Any] = {}
        blocks = [graph.blocks[unit.indices[j]] for j in range(unit.period)]
        lead = (unit.reps,) if unit.folded else ()
        for b in blocks:
            for op in b.stateful_ops():
                shapes = _op_state_shapes(op, cfg, batch_size, C, dtype)
                ust[op.attrs["state_key"]] = _mk_state(shapes, lead, device)
        if ust:
            state[unit_key(graph, unit)] = ust
    return state


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


def _run_block(ctx: Ctx, block: Block, bparams, env: Dict[str, Any],
               mode: str, j: Optional[int] = None,
               tied_tables: Optional[Dict[str, Any]] = None):
    for op in live_ops(block, mode):
        args = [env[i] for i in _used_ins(op, mode)]
        if op.op == "unembed" and op.attrs.get("tied"):
            args.append(tied_tables[op.attrs["tied"]])
        env[op.out] = OPS[op.op](ctx, op, _param_slice(op, bparams, j), *args)
    return env["h"]


# ---------------------------------------------------------------------------
# apply()
# ---------------------------------------------------------------------------

def _make_apply(plan: ExecutionPlan):
    """Returns apply(params, batch, state=None, cache_index=None,
    mode="prefill") -> (out, new_state, aux).

    ``batch`` holds ``images`` (B, H, W, C) or ``tokens`` (B, S) int, and
    optionally ``positions`` (B, S).  Prefill returns the logits of the last
    position only and the state it built; decode (S = 1 at position
    ``cache_index``) writes the new K/V into ``state`` in place and returns
    that same state: it consumes its argument, as the JAX stage donates it.
    There are no aux losses on the inference path (``aux`` is empty)."""
    graph, units = plan.graph, plan.units

    def apply(params, batch, state=None, cache_index=None, mode="prefill"):
        if mode not in MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet; the port runs {MODES} "
                "(ROADMAP Queue 1)")
        if mode == "decode" and (state is None or cache_index is None):
            raise ValueError("decode needs the serving state and cache_index")
        ctx = Ctx(mode=mode, plan=plan, cache_index=cache_index)
        new_state: Dict[str, Any] = {}
        tokens = "tokens" in batch
        h = batch["tokens"] if tokens else batch["images"]
        B = h.shape[0]

        def pos_for(x):
            # positions of the current chain: explicit per-row positions
            # (left-padded prefill), the decode position, or an arange
            if not tokens:
                return None
            S = x.shape[1]
            p = batch.get("positions")
            if p is not None and p.ndim == 2 and p.shape[1] == S:
                return p.to(torch.int32)
            if mode == "decode":
                return torch.full((B, S), int(cache_index), dtype=torch.int32,
                                  device=x.device)
            return torch.arange(S, dtype=torch.int32,
                                device=x.device).expand(B, S)

        tied_tables = {}
        for unit in units:
            b0 = graph.blocks[unit.indices[0]]
            for spec in b0.param_specs():
                if spec.name == "table":
                    tied_tables[f"{b0.name}/table"] = params[b0.name]["table"]

        for unit in units:
            ukey = unit_key(graph, unit)
            b0 = graph.blocks[unit.indices[0]]
            if b0.kind == "head" and mode == "prefill":
                h = h[:, -1:]
            env = {"h": h, "cross": None, "positions": pos_for(h)}
            if not unit.folded:
                ctx.state_in = (state or {}).get(ukey, {})
                ctx.state_out = {}
                h = _run_block(ctx, b0, params.get(ukey, {}), env, mode,
                               tied_tables=tied_tables)
                if ctx.state_out:
                    new_state[ukey] = ctx.state_out
            else:
                h, st = _run_folded(ctx, plan, unit, params[ukey],
                                    (state or {}).get(ukey), env, mode)
                if st:
                    new_state[ukey] = st
        if mode == "decode":            # the state handed in, updated
            state.update(new_state)
            return h, state, {}
        return h, new_state, {}

    return apply


def _slice_tree(tree, r: int):
    return {k: _slice_tree(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _stack_trees(trees: List[Dict[str, Any]]):
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees])
            for k in trees[0]}


def _run_folded(ctx: Ctx, plan: ExecutionPlan, unit: Unit, gparams,
                gstate, env, mode: str):
    """A folded unit: a loop over its repetitions, each running the unit's
    ``period`` prototype blocks on slice ``r`` of the stacked params and
    state.  Prefill stacks the repetitions' new state; decode updates the
    stacked state it was given, in place, and returns it."""
    protos = [plan.graph.blocks[unit.indices[j]] for j in range(unit.period)]
    h = env["h"]
    outs: List[Dict[str, Any]] = []
    for r in range(unit.reps):
        step_params = {k: v[r] for k, v in gparams.items()}
        c = Ctx(mode=mode, plan=plan, cache_index=ctx.cache_index,
                aux=ctx.aux)
        c.state_in = _slice_tree(gstate, r) if gstate else {}
        c.state_out = {}
        e = {"h": h, "positions": env["positions"], "cross": env["cross"]}
        for j, blk in enumerate(protos):
            e["h"] = _run_block(c, blk, step_params, e, mode, j=j)
        h = e["h"]
        outs.append(c.state_out)
    if not outs[0]:
        return h, {}
    if mode == "decode":            # the ops wrote into the slices of gstate
        return h, gstate
    return h, _stack_trees(outs)
