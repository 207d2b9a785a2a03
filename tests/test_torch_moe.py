"""The MoE family in the port against the JAX package: deepseek-moe-16b (a
leading dense layer, 2 shared experts beside the routed ones) and
mixtral-8x7b (sliding-window attention, no shared experts), at smoke size
on the JAX parameters carried across by ``repro_torch.bridge``.

The op: the port's ``_moe_core`` against JAX's on the same numpy inputs,
with the smoke configs' capacity factor 4.0 (nothing drops) and the
published 1.25 (tokens drop: the clamp to slot ``cap - 1`` and its zero
contributions), a router whose probabilities tie (``lax.top_k`` takes the
lower index first, as the port's stable sort does), train mode's
``moe_aux``, and the refusal of a plan sharded over a model axis.  The
configs and plans, full and smoke; the train loss and gradients against
``jax.value_and_grad`` under each remat policy.  The models' forward,
generate and serving parity is in ``tests/torch_moe_parity.py``.

Tolerances, on ``conftest.relerr``: the op in fp32 < 1e-5 and in bf16 <
2e-2 (``_tol``, as the kernel tests hold bf16); the loss < 1e-5 and every
gradient leaf < 1e-4.
"""
import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr, smoke_batch
from repro import flow as jflow
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import ops_impl as jops
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import ops_impl as tops
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.trainer import _grads

MOE = ["deepseek-moe-16b", "mixtral-8x7b"]
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(prec):
    return 2e-2 if prec == "bf16" else 1e-5


def _ctxs(prec, mode="prefill"):
    plan = SimpleNamespace(flow=SimpleNamespace(precision=prec), rules=None)
    return jops.Ctx(mode=mode, plan=plan), tops.Ctx(mode=mode, plan=plan)


def _both(a, prec):
    jdt, tdt = DT[prec]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _core_inputs(E=8, k=2, d=32, f=48, B=2, S=24, shared=True, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, d)
    ws = [rng.randn(d, E) * d ** -0.5, rng.randn(E, d, f) * d ** -0.5,
          rng.randn(E, d, f) * d ** -0.5, rng.randn(E, f, d) * f ** -0.5]
    sh = [rng.randn(d, 2 * f) * d ** -0.5, rng.randn(d, 2 * f) * d ** -0.5,
          rng.randn(2 * f, d) * (2 * f) ** -0.5] if shared else None
    return x, ws, sh


def _run_core(prec, cf, shared=True, mode="prefill", E=8, k=2, S=24,
              inputs=None):
    x, ws, sh = inputs or _core_inputs(E=E, k=k, S=S, shared=shared)
    attrs = dict(num_experts=E, top_k=k, capacity_factor=cf, act="silu",
                 aux_weight=0.01)
    jc, tc = _ctxs(prec, mode)
    jx, tx = _both(x, prec)
    jw, tw = zip(*[_both(w, prec) for w in ws])
    js = tuple(_both(w, prec)[0] for w in sh) if sh else None
    ts = tuple(_both(w, prec)[1] for w in sh) if sh else None
    jy, jaux = jops._moe_core(jc, attrs, jx, *jw, js)
    seen = []
    tops.ROUTING_HOOK = lambda ctx, a, probs, idx, keep: seen.append(
        (idx.clone(), keep.clone()))
    try:
        ty, taux = tops._moe_core(tc, attrs, tx, *tw, ts)
    finally:
        tops.ROUTING_HOOK = None
    assert ty.dtype == DT[prec][1]
    return (np.asarray(jy, np.float32), float(jaux)), \
        (ty.float().numpy(), float(taux)), seen[0]


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "routed"])
@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_moe_core_matches_jax(prec, cf, shared):
    """Dispatch, the expert products and the combine; at 1.25 some picks
    exceed their expert's capacity and are dropped, at 4.0 none."""
    (jy, _), (ty, _), (idx, keep) = _run_core(prec, cf, shared)
    assert np.isfinite(ty).all() and ty.shape == jy.shape
    assert relerr(ty, jy) < _tol(prec)
    cap = max(math.ceil(24 * 2 / 8 * cf), 1)
    assert ((keep == 0).sum() > 0) == (cf == 1.25), cap
    # the picks' slots are unique within an expert among the kept ones
    for b in range(idx.shape[0]):
        kept = idx[b].reshape(-1)[keep[b] > 0]
        assert torch.bincount(kept, minlength=8).max() <= cap


def test_moe_core_drops_the_late_picks():
    """At capacity factor 1.25 a sequence's picks of one expert past its
    ``cap`` slots are the dropped ones, in token order."""
    _, _, (idx, keep) = _run_core("fp32", 1.25)
    cap = math.ceil(24 * 2 / 8 * 1.25)
    for b in range(idx.shape[0]):
        flat = idx[b].reshape(-1).tolist()
        for e in set(flat):
            ks = [keep[b, i].item() for i, v in enumerate(flat) if v == e]
            assert ks == [1.0] * min(cap, len(ks)) + \
                [0.0] * max(0, len(ks) - cap)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_tied_router_picks_the_lower_index(prec):
    """A router whose columns 1, 3 and 6 are equal gives every token tied
    probabilities on them; ``lax.top_k`` takes the lower indices first and
    so does the port.  The experts' weights differ, so a pick of the
    other expert would change the output."""
    x, ws, sh = _core_inputs(E=8, k=2, S=16, shared=False)
    router = np.zeros_like(ws[0])
    router[:, [1, 3, 6]] = np.abs(ws[0][:, :1])
    x = np.abs(x)                       # columns 1, 3, 6 lead every token
    (jy, _), (ty, _), (idx, _) = _run_core(
        prec, 4.0, False, E=8, S=16, inputs=(x, [router] + ws[1:], None))
    assert (idx[..., 0] == 1).all() and (idx[..., 1] == 3).all()
    assert relerr(ty, jy) < _tol(prec)
    probs = np.full((3, 5), 0.2, np.float32)
    probs[1, 2] = probs[1, 4] = 0.3
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tops._top_k_stable(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == \
        [[0, 1, 2], [2, 4, 0], [0, 1, 2]]
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_train_mode_aux_loss_matches_jax(cf):
    (jy, jaux), (ty, taux), _ = _run_core("fp32", cf, mode="train")
    assert taux > 0 and abs(taux - jaux) <= 1e-6 * abs(jaux)
    assert relerr(ty, jy) < 1e-5
    (_, jaux0), (_, taux0), _ = _run_core("fp32", cf, mode="prefill")
    assert taux0 == jaux0 == 0.0


def test_model_sharded_plan_is_refused():
    """A plan whose sharding rules carry a model axis runs the MoE through
    ``_moe_shard_map`` (the JAX package's explicit-collective region): on
    a one-rank mesh it computes JAX's single-device ``_moe_core`` (four
    ranks in ``tests/test_torch_mesh.py``), its aux loss the mean over
    the one dp rank."""
    for mode in ("prefill", "train"):
        _moe_on_a_one_rank_mesh(mode)


def _moe_on_a_one_rank_mesh(mode):
    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.distributed.sharding import ShardingRules
    x, ws, sh = _core_inputs()
    attrs = dict(num_experts=8, top_k=2, capacity_factor=4.0, act="silu",
                 aux_weight=0.01, num_shared=1)
    jc, tc = _ctxs("fp32", mode)
    mesh = MeshSpec((("data", 1), ("model", 1))).build("cpu")
    tc.plan = SimpleNamespace(flow=tc.plan.flow,
                              rules=ShardingRules(mesh, ("data",), "model"))
    names = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up",
             "ws_down")
    p = {n: torch.from_numpy(np.asarray(w, np.float32))
         for n, w in zip(names, ws + sh)}
    op = SimpleNamespace(attrs=attrs)
    ty = tops.op_moe_ffn(tc, op, p, torch.from_numpy(
        np.asarray(x, np.float32)))
    jx, _ = _both(x, "fp32")
    jy, jaux = jops._moe_core(jc, attrs, jx,
                              *[_both(w, "fp32")[0] for w in ws],
                              tuple(_both(w, "fp32")[0] for w in sh))
    assert relerr(ty.numpy(), np.asarray(jy)) < 1e-5
    if mode == "train":
        assert abs(float(tc.aux["moe_aux"]) - float(jaux)) <= \
            1e-6 * abs(float(jaux))
    else:
        assert "moe_aux" not in tc.aux


# ---------------------------------------------------------------------------
# configs and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_config_is_jaxs(arch, smoke):
    tcfg = get_smoke(arch) if smoke else get_config(arch)
    jcfg = jget_smoke(arch) if smoke else jget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "moe"


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_plan_matches_jax(arch, smoke):
    shape = ("serve", "decode", 1024, 8)
    jcm = jflow.compile(arch, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(arch, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    tl = [ln for ln in tcm.describe().splitlines() if "kernels:" not in ln]
    jl = [ln for ln in jcm.describe().splitlines() if "kernels:" not in ln]
    assert tl == jl
    assert tcm.cfg.param_count() == jcm.cfg.param_count()


def test_deepseek_leading_layer_is_dense():
    """deepseek-moe-16b's layer 0 is a GLU FFN of ``first_dense_d_ff``; the
    rest are MoE layers."""
    cfg = get_config("deepseek-moe-16b")
    g = tflow.compile(cfg, ShapeConfig("serve", "decode", 1024, 8),
                      device="cpu").plan.graph
    ops = {b.name: [op.op for op in b.ops] for b in g.blocks}
    assert "moe_ffn" not in ops["layer0"] and "moe_ffn" in ops["layer1"]
    w = [s for b in g.blocks if b.name == "layer0"
         for s in b.param_specs() if s.name.endswith("w_gate")]
    assert w and w[0].shape == (2048, 10944)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch, remat):
    shape = ("smoke", "train", 16, 2)
    kw = dict(mode="folded", precision="fp32", remat=remat)
    jcm = jflow.compile(arch, JShapeConfig(*shape), JFlowConfig(**kw),
                        smoke=True)
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(arch, ShapeConfig(*shape), FlowConfig(**kw),
                        smoke=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = smoke_batch(jcm.cfg)
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
          for k, v in jb.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(jcm.loss_fn, has_aux=True))(
        jp, jb)
    tl, tm, tg = _grads(tcm.loss_fn, tp, tb)
    return (float(jl), {k: float(v) for k, v in jm.items()}, jg), \
        (float(tl), {k: float(v) for k, v in tm.items()}, tg)


@pytest.mark.parametrize("remat", ["block", "nested", "none"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_matches_jax(arch, remat):
    """The loss (cross-entropy plus every MoE layer's ``moe_aux``) and its
    metrics; ``moe_aux`` is summed over the folded layers and the
    unfolded ones."""
    (jl, jm, _), (tl, tm, _) = _loss_and_grads(arch, remat)
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(tm) == {"loss", "acc", "moe_aux"}
    assert tm["moe_aux"] > 0
    assert abs(tm["moe_aux"] - jm["moe_aux"]) <= 1e-5 * jm["moe_aux"]
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * jm["loss"]
    assert tm["acc"] == jm["acc"]


@pytest.mark.parametrize("remat", ["block", "nested", "none"])
@pytest.mark.parametrize("arch", MOE)
def test_gradients_match_jax(arch, remat):
    (_, _, jg), (_, _, tg) = _loss_and_grads(arch, remat)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    errs = [relerr(b.detach().numpy(), np.asarray(a)) for a, b in zip(jl, tl)]
    assert max(errs) < 1e-4, errs
