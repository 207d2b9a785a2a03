"""rwkv6-7b (the RWKV6 recurrence) in the port against the JAX package, on
the same numpy inputs.

* the configuration, ``param_count`` and the plan, full and smoke;
* the ``rwkv_mix`` and ``rwkv_decay`` inits; ``init_state``'s layout;
* ``_wkv_chunked`` in both schedules (prefill's chunk summaries, train's
  chunk loop with the boundary state in fp32 or bf16) at chunks 16 and 32
  and at lengths the chunk does not divide (the halving loop);
* ``op_rwkv6_timemix`` and ``op_rwkv6_channelmix`` in prefill, decode and
  train, with the LoRA matrices nonzero;
* the smoke model (3 layers, width 64, 4 heads of 16, LoRA rank 8) through
  ``flow.compile`` on the JAX parameters carried across by
  ``repro_torch.bridge`` (the zero-initialised LoRA matrices drawn
  nonzero in both): prefill and teacher-forced decode logits, decode
  against a teacher-forced prefill, greedy ``generate``, ``Engine.run``'s
  refusal (no self-attention KV state, JAX's ``ValueError``), the train
  loss and its gradients.

Tolerances (``conftest.relerr``): fp32 < 1e-5 for the recurrence, the ops
and the prefill logits (the chunk recurrence runs as a loop here and as an
associative scan in JAX: the same sums in another order); bf16 < 2e-2 for
an op (bf16 rounds its lerps and products) and < 5e-2 for the model's
logits; decode against the prefill of the same tokens < 2e-4 (JAX's
``tests/test_models_smoke.py`` bound); the loss < 1e-5 and every gradient
< 1e-4 (``tests/torch_train_parity.py``).  Greedy tokens are compared for
identity in fp32.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro import flow as jflow
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import lowering as jlowering
from repro.core import ops_impl as jops
from repro.core.graph import ParamSpec as JParamSpec
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import lowering as tlowering
from repro_torch.core import ops_impl as tops
from repro_torch.core.graph import ParamSpec
from repro_torch.serving import Engine, EngineConfig, synthetic_requests
from torch_train_parity import check_gradients, check_loss

ARCH = "rwkv6-7b"
SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 12, 6
FLOWS = {"folded": dict(mode="folded"),
         "folded_fp32": dict(mode="folded", precision="fp32")}
TOL = {"bf16": 5e-2, "fp32": 1e-5}
PREC = {"fp32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}
LORA = ("mu_lora_b", "decay_lora_b")


def _prec(flow_name):
    return "fp32" if flow_name == "folded_fp32" else "bf16"


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _with_lora(jp, seed=5):
    """JAX's parameters with the zero-initialised LoRA matrices drawn
    nonzero, so the data-dependent mixes and decays move."""
    rng = np.random.RandomState(seed)
    out = {}
    for unit, leaves in jp.items():
        out[unit] = {}
        for k, v in leaves.items():
            if k.endswith(LORA):
                v = jnp.asarray(rng.randn(*v.shape) * 0.2, v.dtype)
            out[unit][k] = v
    return out


@functools.lru_cache(maxsize=None)
def _models(flow_name, shape=SHAPE):
    jcm = jflow.compile(jget_smoke(ARCH), JShapeConfig(*shape),
                        JFlowConfig(**FLOWS[flow_name]))
    jp = _with_lora(jcm.init_params(jax.random.key(0)))
    tcm = tflow.compile(get_smoke(ARCH), ShapeConfig(*shape),
                        FlowConfig(**FLOWS[flow_name]), device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _tokens(seed=0, n=STEPS):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (2, PROMPT)).astype(np.int32),
            rng.randint(0, 256, (2, n)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _run(flow_name):
    """The prefill, then STEPS teacher-forced decode steps, through both
    stacks (float32 numpy logits)."""
    jcm, jp, tcm, tp = _models(flow_name)
    prompt, nxt = _tokens()
    jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt)},
                           mode="prefill")
    tl, tst, taux = tcm.prefill(tp, {"tokens": _t(prompt)})
    assert taux == {}
    out = {"j": [_np(jl)], "t": [_np(tl)]}
    for i in range(STEPS):
        tok = nxt[:, i:i + 1]
        jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(tok)}, state=jst,
                               cache_index=jnp.int32(PROMPT + i),
                               mode="decode")
        tl, tst, _ = tcm.decode(tp, {"tokens": _t(tok)}, tst, PROMPT + i)
        out["j"].append(_np(jl))
        out["t"].append(_np(tl))
    return out


# ---------------------------------------------------------------------------
# config, plan, inits, state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_jaxs(smoke):
    tcfg = get_smoke(ARCH) if smoke else get_config(ARCH)
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "ssm" and tcfg.recurrence.kind == "rwkv6"
    assert ARCH in ARCHS
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("smoke", [False, True])
def test_plan_matches_jax(smoke):
    shape = ("serve", "decode", 1024, 8)
    jcm = jflow.compile(ARCH, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(ARCH, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    tl = [ln for ln in tcm.describe().splitlines() if "kernels:" not in ln]
    jl = [ln for ln in jcm.describe().splitlines() if "kernels:" not in ln]
    assert tl == jl
    assert tcm.plan.tiles["wkv_chunk"] == jcm.plan.tiles["wkv_chunk"]


@pytest.mark.parametrize("shape", [(5, 64), (64,), (3, 7)])
def test_rwkv_decay_init_is_jaxs_ramp(shape):
    """The decay base and bonus: the ramp -6 + 5 (i / (n - 1))^0.9 over the
    last axis, no draw: JAX's values to the last bits (torch's float32
    ``pow`` and XLA's differ by one ulp at a few entries, two after the
    scale and shift; one bf16 rounding in bf16)."""
    spec = ParamSpec("decay_base", shape, ("none",) * len(shape),
                     "rwkv_decay")
    jspec = JParamSpec("decay_base", shape, ("none",) * len(shape),
                       "rwkv_decay")
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        t = tlowering._init_one(0, "layer0decay_base", spec, tdt)
        j = jlowering._init_one(jax.random.key(0), jspec, jdt)
        assert t.dtype == tdt and tuple(t.shape) == shape
        if tdt == torch.float32:
            np.testing.assert_array_max_ulp(_np(t), _np(j), maxulp=2)
        else:
            np.testing.assert_allclose(_np(t), _np(j), rtol=2.0 ** -7,
                                       atol=0)
        assert torch.equal(t, tlowering._init_one(9, "x", spec, tdt))
        assert (t[..., 1:].float() >= t[..., :-1].float()).all()


def test_rwkv_mix_init_draws_uniform():
    """The token-shift mixes: uniform on [0, 1) from the parameter's own
    generator (the port's draw, not JAX's numbers): in range, spread over
    it, and following the seed and the name."""
    spec = ParamSpec("mu_base", (5, 4096), ("none", "d_model"), "rwkv_mix")
    a = tlowering._init_one(0, "layer0mu_base", spec, torch.float32)
    assert a.min() >= 0.0 and a.max() < 1.0
    assert abs(a.mean().item() - 0.5) < 0.01 and a.std().item() > 0.28
    assert torch.equal(a, tlowering._init_one(0, "layer0mu_base", spec,
                                              torch.float32))
    assert not torch.equal(a, tlowering._init_one(1, "layer0mu_base", spec,
                                                  torch.float32))
    assert not torch.equal(a, tlowering._init_one(0, "layer1mu_base", spec,
                                                  torch.float32))
    p = tflow.compile(ARCH, ShapeConfig(*SHAPE), smoke=True,
                      device="cpu").init_params(0)
    assert p["fold_layer0"]["0:mu_base"].shape == (3, 5, 64)
    assert p["fold_layer0"]["0:cm_mu"].shape == (3, 2, 64)


def _leaves(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_init_state_matches_jax_layout(flow_name):
    jcm, _, tcm, _ = _models(flow_name)
    js, ts = _leaves(jcm.init_state(3)), _leaves(tcm.init_state(3))
    assert sorted(js) == sorted(ts)
    assert ("fold_layer0", "wkv0_s") in ts and ("fold_layer0", "cm0_shift") \
        in ts
    assert tuple(ts[("fold_layer0", "wkv0_s")].shape) == (3, 3, 4, 16, 16)
    for key, jv in js.items():
        assert tuple(ts[key].shape) == jv.shape, key
        assert str(ts[key].dtype).split(".")[-1] == jv.dtype.name, key
        assert (ts[key] == 0).all(), key


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

def _wkv_inputs(S, seed=3, B=2, H=3, dk=16, dv=8):
    rng = np.random.RandomState(seed)
    r = rng.randn(B, S, H, dk).astype(np.float32)
    k = (rng.randn(B, S, H, dk) * 0.5).astype(np.float32)
    v = rng.randn(B, S, H, dv).astype(np.float32)
    w = -np.exp(rng.randn(B, S, H, dk) * 0.5 - 1.5).astype(np.float32)
    u = (rng.randn(H, dk) * 0.5).astype(np.float32)
    return r, k, v, w, u


WKV_CASES = [(S, chunk, sched) for S in (64, 40, 48) for chunk in (16, 32)
             for sched in ("parallel", "train_fp32", "train_bf16")]


@pytest.mark.parametrize("S,chunk,sched", WKV_CASES)
def test_wkv_chunked_matches_jax(S, chunk, sched):
    """Both schedules against JAX's, the output and the final state, at
    lengths 40 and 48 that the chunk does not divide (40 halves it to 8,
    48 to 16 from 32).  With the boundary state in bf16 a state that sums
    in another order may round to the next bf16 value: held at bf16's
    2e-2 (one rounding, ``tests/test_kernels.py``'s ``_tol``)."""
    ins = _wkv_inputs(S)
    parallel = sched == "parallel"
    jdt, tdt = PREC["bf16" if sched == "train_bf16" else "fp32"]
    jy, js = jops._wkv_chunked(*map(jnp.asarray, ins), chunk,
                               parallel=parallel, boundary_dt=jdt)
    ty, ts = tops._wkv_chunked(*map(torch.from_numpy, ins), chunk,
                               parallel=parallel, boundary_dt=tdt)
    assert ty.dtype == ts.dtype == torch.float32
    assert tuple(ty.shape) == (2, S, 3, 8) and tuple(ts.shape) == (2, 3, 16, 8)
    tol = 2e-2 if sched == "train_bf16" else 1e-5
    assert relerr(_np(ty), _np(jy)) < tol
    assert relerr(_np(ts), _np(js)) < tol


def test_wkv_schedules_agree_and_train_recomputes():
    """Both schedules compute the same recurrence; the train schedule's
    chunk bodies run under ``torch.utils.checkpoint`` when autograd
    records, and its gradients match the parallel schedule's."""
    ins = [torch.from_numpy(a).requires_grad_() for a in _wkv_inputs(64)]
    yp, sp = tops._wkv_chunked(*ins, 16, parallel=True)
    yt, st = tops._wkv_chunked(*ins, 16, parallel=False)
    assert relerr(_np(yt.detach()), _np(yp.detach())) < 1e-5
    assert relerr(_np(st.detach()), _np(sp.detach())) < 1e-5
    gp = torch.autograd.grad(yp.square().sum(), ins)
    gt = torch.autograd.grad(yt.square().sum(), ins)
    for a, b in zip(gt, gp):
        assert relerr(_np(a), _np(b)) < 1e-4


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

D, H, DH, RANK, DFF = 64, 4, 16, 8, 96


def _timemix_params(seed=11):
    rng = np.random.RandomState(seed)
    ramp = -6.0 + 5.0 * (np.arange(H * DH) / (H * DH - 1)) ** 0.9
    return {
        "mu_base": rng.rand(5, D), "mu_lora_a": rng.randn(D, 5 * RANK) * 0.1,
        "mu_lora_b": rng.randn(5, RANK, D) * 0.2,
        "w_r": rng.randn(D, H * DH) * D ** -0.5,
        "w_k": rng.randn(D, H * DH) * D ** -0.5,
        "w_v": rng.randn(D, H * DH) * D ** -0.5,
        "w_g": rng.randn(D, H * DH) * D ** -0.5,
        "decay_base": ramp, "decay_lora_a": rng.randn(D, RANK) * 0.1,
        "decay_lora_b": rng.randn(RANK, H * DH) * 0.2,
        "bonus": ramp + rng.randn(H * DH) * 0.5,
        "ln_x_scale": 1 + rng.randn(H * DH) * 0.1,
        "ln_x_bias": rng.randn(H * DH) * 0.1,
        "w_o": rng.randn(H * DH, D) * (H * DH) ** -0.5}


def _channelmix_params(seed=12):
    rng = np.random.RandomState(seed)
    return {"cm_mu": rng.rand(2, D), "cw_r": rng.randn(D, D) * D ** -0.5,
            "cw_k": rng.randn(D, DFF) * D ** -0.5,
            "cw_v": rng.randn(DFF, D) * DFF ** -0.5}


def _both(ps, prec):
    jdt, tdt = PREC[prec]
    return ({k: jnp.asarray(np.asarray(v, np.float32)).astype(jdt)
             for k, v in ps.items()},
            {k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)
             for k, v in ps.items()})


def _op_run(fn_name, attrs, ps, prec, mode, S, state=None, seed=13):
    """One op in ``mode`` through both packages on the same inputs: the
    outputs and the state each wrote (the port's decode writes into the
    state it was handed; here a copy of JAX's input state)."""
    jdt, tdt = PREC[prec]
    rng = np.random.RandomState(seed)
    x = rng.randn(2, S, D).astype(np.float32)
    plan = SimpleNamespace(flow=SimpleNamespace(precision=prec),
                           tiles={"wkv_chunk": 4})
    op = SimpleNamespace(attrs=attrs)
    jp_, tp_ = _both(ps, prec)
    jc = jops.Ctx(mode=mode, plan=plan)
    tc = tops.Ctx(mode=mode, plan=plan)
    if state is not None:
        jc.state_in = {k: jnp.asarray(v).astype(jdt) for k, v in state.items()}
        tc.state_in = {k: torch.from_numpy(v).to(tdt)
                       for k, v in state.items()}
    jy = getattr(jops, fn_name)(jc, op, jp_, jnp.asarray(x).astype(jdt))
    ty = getattr(tops, fn_name)(tc, op, tp_, torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt and tuple(ty.shape) == (2, S, D)
    if state is not None:               # decode: the same tensors back
        for k, v in tc.state_out.items():
            assert v is tc.state_in[k], k
    return jy, ty, jc.state_out, tc.state_out


OP_TOL = {"fp32": 1e-5, "bf16": 2e-2}
TM_ATTRS = dict(n_heads=H, head_dim=DH, lora_rank=RANK, state_key="wkv0")


def _tm_state(seed=14):
    rng = np.random.RandomState(seed)
    return {"wkv0_shift": rng.randn(2, D).astype(np.float32),
            "wkv0_s": (rng.randn(2, H, DH, DH) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_timemix_matches_jax(mode, prec):
    """In prefill (chunks of 4 over 10 steps: halved to 2) with the states
    it leaves, in a decode step from a given state with the states it
    writes (in bf16 the WKV state rounds to bf16, as JAX's), and in train
    (the chunk loop, its boundary state in the compute dtype)."""
    S = 1 if mode == "decode" else 10
    jy, ty, js, ts = _op_run("op_rwkv6_timemix", TM_ATTRS,
                             _timemix_params(), prec, mode, S,
                             _tm_state() if mode == "decode" else None)
    assert relerr(_np(ty), _np(jy)) < OP_TOL[prec]
    assert sorted(ts) == sorted(js) == (
        [] if mode == "train" else ["wkv0_s", "wkv0_shift"])
    for k in js:
        assert ts[k].dtype == PREC[prec][1], k
        assert tuple(ts[k].shape) == js[k].shape, k
        assert relerr(_np(ts[k]), _np(js[k])) < OP_TOL[prec], k


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_channelmix_matches_jax(mode, prec):
    S = 1 if mode == "decode" else 10
    state = {"cm0_shift": np.random.RandomState(15).randn(2, D).astype(
        np.float32)} if mode == "decode" else None
    jy, ty, js, ts = _op_run("op_rwkv6_channelmix", {"state_key": "cm0"},
                             _channelmix_params(), prec, mode, S, state)
    assert relerr(_np(ty), _np(jy)) < OP_TOL[prec]
    assert sorted(ts) == sorted(js) == ([] if mode == "train"
                                        else ["cm0_shift"])
    for k in js:
        assert np.array_equal(_np(ts[k]), _np(js[k])), k


def test_token_shift_decode_reads_before_it_writes():
    """The decode step's x_{t-1} is the state handed in, even though the
    same tensor takes the new input in place."""
    plan = SimpleNamespace(flow=SimpleNamespace(precision="fp32"), tiles={})
    st = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    c = tops.Ctx(mode="decode", plan=plan, state_in={"s": st})
    x = torch.full((2, 1, 3), 9.0)
    prev = tops._token_shift(c, x, "s")
    assert torch.equal(prev[:, 0], torch.arange(6.).reshape(2, 3))
    assert c.state_out["s"] is st and (st == 9).all()


# ---------------------------------------------------------------------------
# the model at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_prefill_and_decode_match_jax(flow_name):
    r = _run(flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert tl.shape == jl.shape == (2, 1, 256) and np.isfinite(tl).all()
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


def test_decode_matches_teacher_forced_prefill():
    """Each decode step's logits against a prefill of the same tokens
    (fp32): the recurrent states carried through decode are the prefill's."""
    _, _, tcm, tp = _models("folded_fp32")
    prompt, nxt = _tokens(2)
    toks = np.concatenate([prompt, nxt], 1)
    _, st, _ = tcm.prefill(tp, {"tokens": _t(prompt)})
    for i in range(STEPS):
        y, st, _ = tcm.decode(tp, {"tokens": _t(nxt[:, i:i + 1])}, st,
                              PROMPT + i)
        yr, _, _ = tcm.prefill(tp, {"tokens": _t(toks[:, :PROMPT + i + 1])})
        assert relerr(_np(y), _np(yr)) < 2e-4, i


def test_prefill_state_is_jaxs():
    """The state a prefill leaves: the token-shift inputs and the WKV
    states of every layer, stacked over the folded repetitions."""
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _ = _tokens()
    _, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt)}, mode="prefill")
    _, tst, _ = tcm.prefill(tp, {"tokens": _t(prompt)})
    js, ts = _leaves(jst), _leaves(tst)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        assert relerr(_np(ts[k]), _np(js[k])) < 1e-5, k


def test_greedy_generate_identical_fp32():
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _ = _tokens(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt)}, steps=8)
    tt, _ = tcm.generate(tp, {"tokens": _t(prompt)}, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    eng = Engine(tcm, tp, EngineConfig())
    et, _ = eng.generate({"tokens": _t(prompt)}, 8)
    assert torch.equal(et, tt)


def test_engine_run_refuses_before_any_tick():
    """No self-attention KV state: the paged cache refuses it with JAX's
    ``ValueError``, before any tick."""
    _, _, tcm, tp = _models("folded_fp32", shape=("serve", "decode", 64, 4))
    eng = Engine(tcm, tp, EngineConfig(max_batch=4, max_seq_len=64,
                                       block_size=8))
    with pytest.raises(ValueError, match="has no self-attention KV state"):
        eng.run(synthetic_requests(3, 256, prompt_len=12, max_new_tokens=4))
    assert eng.last_cache is None and eng.last_report is None


def test_train_loss_matches_jax():
    check_loss(ARCH)


def test_train_gradients_match_jax():
    check_gradients(ARCH)


def bf16_drift(depths=(3, 8, 32), S=128):
    """Each package's own bf16 prefill logits against its fp32 prefill's
    (relerr) on the smoke config cut to each depth, on the JAX weights:
    how far bf16 rounding alone carries the model as it deepens."""
    out = []
    for L in depths:
        cj = dataclasses.replace(jget_smoke(ARCH), n_layers=L)
        ct = dataclasses.replace(get_smoke(ARCH), n_layers=L)
        tok = np.random.RandomState(0).randint(0, 256, (2, S))
        ys = {}
        for prec in ("bf16", "fp32"):
            fl = dict(mode="folded", precision=prec)
            jcm = jflow.compile(cj, JShapeConfig(*SHAPE[:2], 256, 2),
                                JFlowConfig(**fl))
            if prec == "bf16":
                jp = jcm.init_params(jax.random.key(0))
            p = jax.tree.map(lambda a: a.astype(PREC[prec][0]), jp)
            tcm = tflow.compile(ct, ShapeConfig(*SHAPE[:2], 256, 2),
                                FlowConfig(**fl), device="cpu")
            tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
            ys[prec] = (_np(jcm.apply(p, {"tokens": jnp.asarray(tok)},
                                      mode="prefill")[0]),
                        _np(tcm.prefill(tp, {"tokens": _t(tok)})[0]))
        out.append((L, relerr(ys["bf16"][0], ys["fp32"][0]),
                    relerr(ys["bf16"][1], ys["fp32"][1])))
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_rwkv.py
    for row in bf16_drift():
        print("%d layers: bf16 against fp32, JAX %.3g, the port %.3g" % row)
