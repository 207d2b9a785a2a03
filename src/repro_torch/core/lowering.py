"""Lowering: ExecutionPlan × Graph → executable PyTorch functions.

* ``init_params``  — parameter dict (folded groups pre-stacked)
* ``param_shapes`` — the same tree as meta tensors (no allocation)
* ``_make_apply``  — apply(params, batch, mode="prefill") -> (out, {}, {})

Folded units (the paper's parameterized kernels; a ``lax.scan`` in the JAX
package) lower to a Python loop over the unit's repetitions, each step
running the unit's prototype blocks on that repetition's slice of the
stacked parameters; unfolded units lower to straight-line calls (the
pipelined mode's one-section-per-layer).  PyTorch runs eagerly, so there is
no jit stage.

The CNN slice lowers the inference path (``mode="prefill"``); training,
decode state and the LM head's chunked loss arrive with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.graph import Block, Graph, MicroOp, ParamSpec
from repro_torch.core.ops_impl import OPS, Ctx
from repro_torch.core.passes.folding import Unit
from repro_torch.core.plan import ExecutionPlan

MODES = ("prefill",)


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
    if spec.init != "normal":
        raise NotImplementedError(
            f"init {spec.init!r} of {name} is not ported yet (the CNN slice "
            "uses normal, zeros and ones)")
    # normal with 1/sqrt(fan_in), fan_in = shape[-2] as in the JAX package
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = spec.init_scale or fan_in ** -0.5
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
# Block interpretation (with per-mode dead-code elimination)
# ---------------------------------------------------------------------------

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
            live.update(op.ins)
    return [op for i, op in enumerate(block.ops) if keep[i]]


def _param_slice(op: MicroOp, bparams: Dict[str, Any], j: Optional[int]):
    """Dict param-name → tensor for one op (handles folded 'j:' prefixes)."""
    out = {}
    for spec in op.params:
        key = spec.name if j is None else f"{j}:{spec.name}"
        out[spec.name] = bparams[key]
    return out


def _run_block(ctx: Ctx, block: Block, bparams, env: Dict[str, Any],
               mode: str, j: Optional[int] = None):
    for op in live_ops(block, mode):
        args = [env[i] for i in op.ins]
        env[op.out] = OPS[op.op](ctx, op, _param_slice(op, bparams, j), *args)
    return env["h"]


# ---------------------------------------------------------------------------
# apply()
# ---------------------------------------------------------------------------

def _make_apply(plan: ExecutionPlan):
    """Returns apply(params, batch, state=None, cache_index=None,
    mode="prefill") -> (out, new_state, aux).  The CNN slice has no serving
    state and no aux losses: both come back empty."""
    graph, units = plan.graph, plan.units

    def apply(params, batch, state=None, cache_index=None, mode="prefill"):
        if mode not in MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet; the CNN slice runs "
                f"{MODES} (ROADMAP Queue 1)")
        if "images" not in batch:
            raise NotImplementedError(
                "token batches arrive with the LM slice; the CNN slice "
                "takes {'images': (B, H, W, C)}")
        ctx = Ctx(mode=mode, plan=plan)
        h = batch["images"]
        for unit in units:
            ukey = unit_key(graph, unit)
            b0 = graph.blocks[unit.indices[0]]
            if not unit.folded:
                h = _run_block(ctx, b0, params.get(ukey, {}), {"h": h}, mode)
            else:
                h = _run_folded(ctx, plan, unit, params[ukey], h, mode)
        return h, {}, {}

    return apply


def _run_folded(ctx: Ctx, plan: ExecutionPlan, unit: Unit, gparams,
                h, mode: str):
    """A folded unit: a loop over its repetitions, each running the unit's
    ``period`` prototype blocks on slice ``r`` of the stacked params."""
    protos = [plan.graph.blocks[unit.indices[j]] for j in range(unit.period)]
    for r in range(unit.reps):
        step_params = {k: v[r] for k, v in gparams.items()}
        for j, blk in enumerate(protos):
            h = _run_block(ctx, blk, step_params, {"h": h}, mode, j=j)
    return h
