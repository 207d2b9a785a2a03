"""The recurrent slice: recurrentgemma-2b (the RG-LRU hybrid) in the port
against the JAX package, on the same numpy inputs.

* ``lru_scan``'s plain version against JAX's Pallas kernel (interpret mode)
  and its ``lru_scan_ref``, at ``tests/test_kernels.py``'s cases;
* the ``conv1d_causal`` and ``rg_lru`` ops in prefill and decode;
* the smoke model (6 layers: 2 x (rec, rec, attn), width 64, head_dim 32,
  window 16) through ``flow.compile`` on the JAX parameters carried across
  by ``repro_torch.bridge``: prefill and teacher-forced decode logits,
  greedy generate across the window, ``generate_fori``;
* the planner: the port's plan for recurrentgemma-2b, full and smoke,
  prints JAX's apart from the kernels line.

Tolerances (``conftest.relerr``, max |diff| over max |ref|): fp32 < 1e-5
for the scan and the ops, the same arithmetic summed in another order (the
scan's doubling against JAX's associative scan and sequential kernel);
< 1e-4 for the model's fp32 logits; bf16 < 2e-2 for a bf16 scan (one
bf16 rounding of the output, ``tests/test_kernels.py``'s ``_tol``) and
< 5e-2 for the model's bf16 logits (activations round to bf16 after every
op; one-ulp differences compound through the layers).  Greedy tokens are
compared for identity in fp32.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro import flow as jflow
from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import ops_impl as jops
from repro.kernels.lru_scan import lru_scan as jlru_scan
from repro.kernels.lru_scan import lru_scan_ref as jlru_scan_ref
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import ops_impl as tops
from repro_torch.kernels import lru_scan as tlru

ARCH = "recurrentgemma-2b"
SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 8, 24          # 8 + 24 positions cross the 16-token window
TF_STEPS = 12                  # teacher-forced: positions 8..19 wrap it too
TOL = {"fp32": 1e-4, "bf16": 5e-2}
PREC = {"fp32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}
# the port's kernel backend beside the JAX one it is held against
BACKENDS = {"auto": "auto", "cuda": "pallas_interpret"}
LRU_CASES = [(2, 16, 64), (1, 33, 130), (3, 8, 256)]


def _t(a, dt=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dt is None else t.to(dt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# lru_scan
# ---------------------------------------------------------------------------

def _scan_inputs(spec, seed=7):
    rng = np.random.RandomState(seed)
    B, S, W = spec
    return ((rng.rand(B, S, W) * 0.9).astype(np.float32),
            rng.randn(B, S, W).astype(np.float32))


@pytest.mark.parametrize("spec", LRU_CASES)
def test_lru_scan_plain_matches_jax_kernel_and_ref(spec):
    a, b = _scan_inputs(spec)
    got = tlru.lru_scan_plain(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == spec
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert relerr(_np(got), jlru_scan(ja, jb, block_w=128,
                                      interpret=True)) < 1e-5
    assert relerr(_np(got), jlru_scan_ref(ja, jb)) < 1e-5


@pytest.mark.parametrize("spec", LRU_CASES)
def test_lru_scan_plain_bf16_matches_jax_ref(spec):
    a, b = _scan_inputs(spec, seed=11)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    got = tlru.lru_scan_plain(_t(np.asarray(ja, np.float32), torch.bfloat16),
                              _t(np.asarray(jb, np.float32), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert relerr(_np(got), jlru_scan_ref(ja, jb)) < 2e-2


def test_lru_scan_wrapper_on_cpu_runs_the_plain_version():
    a, b = _scan_inputs((2, 9, 40))
    n0 = tlru.lru_scan.launches
    got = tlru.lru_scan(_t(a), _t(b))
    assert tlru.lru_scan.launches == n0          # nothing launched
    assert torch.equal(got, tlru.lru_scan_plain(_t(a), _t(b)))
    # the recurrence itself, step by step
    h, want = np.zeros((2, 40), np.float32), []
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert relerr(_np(got), np.stack(want, 1)) < 1e-5
    with pytest.raises(ValueError):
        tlru.lru_scan(_t(a), _t(b)[:, :4])


# ---------------------------------------------------------------------------
# the conv1d_causal and rg_lru ops
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _plans(prec, backend="auto"):
    """A JAX and a port plan of the smoke model: the ops read the compute
    dtype and the kernel table from them."""
    jcm = jflow.compile(ARCH, JShapeConfig(*SHAPE),
                        JFlowConfig(mode="folded", precision=prec),
                        smoke=True, backend=BACKENDS[backend])
    tcm = tflow.compile(ARCH, ShapeConfig(*SHAPE),
                        FlowConfig(mode="folded", precision=prec),
                        smoke=True, backend=backend, device="cpu")
    return jcm.plan, tcm.plan


def _op_inputs(kind, B, S, w, prec, seed=0):
    rng = np.random.RandomState(seed)
    jdt, tdt = PREC[prec]
    x = rng.randn(B, S, w).astype(np.float32)
    if kind == "conv":
        p = {"conv_w": rng.randn(4, w) * 0.5, "conv_b": rng.randn(w) * 0.1}
        st = rng.randn(B, 3, w)
        attrs = {"width": 4, "state_key": "conv0"}
    else:
        nb = 4
        p = {"lru_lambda": rng.randn(w) + 3.0,
             "lru_wa": rng.randn(nb, w // nb, w // nb) * (w // nb) ** -0.5,
             "lru_ba": rng.randn(w) * 0.1,
             "lru_wx": rng.randn(nb, w // nb, w // nb) * (w // nb) ** -0.5,
             "lru_bx": rng.randn(w) * 0.1}
        st = rng.randn(B, w)
        attrs = {"c": 8.0, "state_key": "lru0", "n_blocks": nb}
    op = types.SimpleNamespace(attrs=attrs)
    jp = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in p.items()}
    tp = {k: _t(np.asarray(jnp.asarray(v, jnp.float32).astype(jdt),
                           np.float32), tdt) for k, v in p.items()}
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx, np.float32), tdt)
    jst = jnp.asarray(st, jnp.float32).astype(jdt)
    tst = _t(np.asarray(jst, np.float32), tdt)
    return op, (jp, jx, jst), (tp, tx, tst)


OP_CASES = [(kind, mode, S, prec, backend)
            for kind in ("conv", "lru")
            for mode, S in (("prefill", 7), ("prefill", 2), ("decode", 1))
            for prec in ("fp32", "bf16")
            for backend in ("auto", "cuda")
            if not (kind == "conv" and backend == "cuda")]


@pytest.mark.parametrize("kind,mode,S,prec,backend", OP_CASES)
def test_recurrent_ops_match_jax(kind, mode, S, prec, backend):
    """The op's output and the state it leaves, prefill (S = 2 is shorter
    than the conv's 3-input tail) and decode; the decode state is written
    into the tensor handed in, in the input's dtype."""
    jplan, tplan = _plans(prec, backend)
    op, (jp, jx, jst), (tp, tx, tst) = _op_inputs(kind, 3, S, 64, prec)
    jfn = jops.op_conv1d_causal if kind == "conv" else jops.op_rg_lru
    tfn = tops.op_conv1d_causal if kind == "conv" else tops.op_rg_lru
    skey = op.attrs["state_key"]
    jctx = jops.Ctx(mode=mode, plan=jplan)
    tctx = tops.Ctx(mode=mode, plan=tplan)
    if mode == "decode":
        jctx.state_in = {skey: jst}
        tctx.state_in = {skey: tst}
    jy = jfn(jctx, op, jp, jx)
    ty = tfn(tctx, op, tp, tx)
    tol = 1e-5 if prec == "fp32" else 2e-2
    assert ty.dtype == PREC[prec][1] and tuple(ty.shape) == jy.shape
    assert relerr(_np(ty), jy) < tol
    jo, to = jctx.state_out[skey], tctx.state_out[skey]
    assert to.dtype == PREC[prec][1] and tuple(to.shape) == jo.shape
    assert relerr(_np(to), jo) < tol
    if mode == "decode":
        assert to is tst                      # written in place


def test_softplus_is_jax_logaddexp_beyond_torch_threshold():
    """A very negative lambda makes softplus(-lambda) exceed torch's
    linear threshold (20); the op follows JAX's logaddexp there too."""
    jplan, tplan = _plans("fp32")
    op, (jp, jx, _), (tp, tx, _) = _op_inputs("lru", 2, 5, 64, "fp32")
    jp["lru_lambda"] = jnp.full((64,), -25.0)
    tp["lru_lambda"] = torch.full((64,), -25.0)
    jy = jops.op_rg_lru(jops.Ctx(mode="prefill", plan=jplan), op, jp, jx)
    ty = tops.op_rg_lru(tops.Ctx(mode="prefill", plan=tplan), op, tp, tx)
    assert relerr(_np(ty), jy) < 1e-5


# ---------------------------------------------------------------------------
# the smoke model end to end
# ---------------------------------------------------------------------------

FLOWS = {"folded": dict(mode="folded"),
         "folded_fp32": dict(mode="folded", precision="fp32"),
         "base": "base"}


def _flow(F, name):
    spec = FLOWS[name]
    return F().base() if spec == "base" else F(**spec)


def _prec(flow_name):
    return "bf16" if flow_name == "folded" else "fp32"


@functools.lru_cache(maxsize=None)
def _models(flow_name, backend="auto"):
    jcm = jflow.compile(ARCH, JShapeConfig(*SHAPE), _flow(JFlowConfig,
                                                          flow_name),
                        smoke=True, backend=BACKENDS[backend])
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(ARCH, ShapeConfig(*SHAPE), _flow(FlowConfig,
                                                         flow_name),
                        smoke=True, backend=backend, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _tokens(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (2, PROMPT)).astype(np.int32),
            rng.randint(0, 256, (2, steps)).astype(np.int32))


def _leaves(state):
    out = {}
    for u, st in state.items():
        for k, v in st.items():
            if isinstance(v, dict):
                out.update({(u, k, leaf): x for leaf, x in v.items()})
            else:
                out[(u, k)] = v
    return out


@functools.lru_cache(maxsize=None)
def _run(flow_name, backend="auto", steps=TF_STEPS):
    """Prefill then ``steps`` teacher-forced decode steps through both
    stacks, as float32 numpy: the prefill logits and state, the decode
    logits."""
    jcm, jp, tcm, tp = _models(flow_name, backend)
    prompt, nxt = _tokens(steps=steps)
    jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt)},
                           mode="prefill")
    tl, tst, _ = tcm.prefill(tp, {"tokens": torch.from_numpy(
        prompt.astype(np.int64))})
    out = {"j": {"prefill": _np(jl), "decode": [],
                 "state": {k: _np(v) for k, v in _leaves(jst).items()}},
           "t": {"prefill": _np(tl), "decode": [], "dtype": tl.dtype,
                 "state": {k: _np(v).copy() for k, v in _leaves(tst).items()}}}
    for i in range(steps):
        tok = nxt[:, i:i + 1]
        jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(tok)}, state=jst,
                               cache_index=jnp.int32(PROMPT + i),
                               mode="decode")
        tl, tst2, _ = tcm.decode(tp, {"tokens": torch.from_numpy(
            tok.astype(np.int64))}, tst, PROMPT + i)
        assert tst2 is tst                   # decode consumes its state
        out["j"]["decode"].append(_np(jl))
        out["t"]["decode"].append(_np(tl))
    return out


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_prefill_logits_and_state_match_jax(flow_name):
    r = _run(flow_name)
    j, t = r["j"], r["t"]
    assert t["prefill"].shape == j["prefill"].shape == (2, 1, 256)
    assert t["dtype"] == torch.float32 and np.isfinite(t["prefill"]).all()
    assert relerr(t["prefill"], j["prefill"]) < TOL[_prec(flow_name)]
    assert sorted(t["state"]) == sorted(j["state"])
    for key, jv in j["state"].items():
        tv = t["state"][key]
        assert tv.shape == jv.shape, key
        if key[-1] == "pos":
            assert (tv == jv).all(), key
        else:
            assert relerr(tv, jv) < TOL[_prec(flow_name)], key


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_decode_logits_teacher_forced_across_the_window(flow_name):
    r = _run(flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"]["decode"], r["j"]["decode"])):
        assert tl.shape == jl.shape == (2, 1, 256)
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_cuda_backend_on_cpu_matches_pallas_interpret(prec):
    """``backend="cuda"`` on a CPU model reaches the kernel wrappers (the
    scan and the attention kernels), which run their plain versions; JAX's
    ``pallas_interpret`` runs the Pallas kernels' bodies."""
    name = "folded_fp32" if prec == "fp32" else "folded"
    n0 = tlru.lru_scan.launches
    r = _run(name, "cuda", steps=3)
    assert tlru.lru_scan.launches == n0
    assert relerr(r["t"]["prefill"], r["j"]["prefill"]) < TOL[prec]
    for tl, jl in zip(r["t"]["decode"], r["j"]["decode"]):
        assert relerr(tl, jl) < TOL[prec]


@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_generate_identical_fp32_across_the_window(seed):
    """8 prompt tokens and 24 generated: positions 0..31 over a 16-slot
    rolling cache, so the window cuts and the cache wraps."""
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _ = _tokens(seed)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt)}, steps=STEPS)
    tt, state = tcm.generate(tp, {"tokens": torch.from_numpy(
        prompt.astype(np.int64))}, steps=STEPS)
    assert tt.dtype == torch.int32 and tt.shape == (2, STEPS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    pos = state["fold_layer0"]["kv2"]["pos"]
    assert pos.shape == (2, 2, 16)           # (reps, B, the window)
    assert sorted(pos[0, 0].tolist()) == list(range(PROMPT + STEPS - 17,
                                                    PROMPT + STEPS - 1))
    fori = tcm.generate_fori(tp, {"tokens": torch.from_numpy(
        prompt.astype(np.int64))}, STEPS)
    assert torch.equal(fori, tt)


def test_init_state_matches_jax_layout():
    jcm, _, tcm, _ = _models("folded")
    js, ts = _leaves(jcm.init_state(3)), _leaves(tcm.init_state(3))
    assert sorted(js) == sorted(ts)
    assert ("fold_layer0", "conv0") in ts and ("fold_layer0", "lru1") in ts
    for key, jv in js.items():
        assert tuple(ts[key].shape) == jv.shape, key
        assert str(ts[key].dtype).split(".")[-1] == jv.dtype.name, key
        want = -1 if key[-1] == "pos" else 0
        assert (ts[key] == want).all(), key


def test_lru_lambda_init_draws_the_decay_range():
    """The port's own init (not JAX's numbers): sigmoid(lambda)^8 lies in
    [0.9, 0.999], as u ~ U(0.9, 0.999) with r = u^(1/8) gives it, and the
    draw follows the seed."""
    _, _, tcm, _ = _models("folded_fp32")
    lam = tcm.init_params(0)["fold_layer0"]["0:lru_lambda"]
    a8 = torch.sigmoid(lam) ** 8
    assert lam.shape == (2, 64)
    assert a8.min() >= 0.9 - 1e-5 and a8.max() <= 0.999 + 1e-5
    assert torch.equal(lam, tcm.init_params(0)["fold_layer0"]["0:lru_lambda"])
    assert not torch.equal(lam,
                           tcm.init_params(1)["fold_layer0"]["0:lru_lambda"])


def test_rwkv6_still_raises_naming_the_roadmap():
    """The RWKV6 recurrence, which this test once saw raise, is ported
    (``tests/test_torch_rwkv.py`` holds it to JAX): its smoke config
    compiles and runs a prefill, leaving each layer's token-shift inputs
    and WKV state."""
    tcm = tflow.compile("rwkv6-7b", ShapeConfig(*SHAPE), smoke=True,
                        device="cpu")
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (2, 8)))}
    y, st, _ = tcm.prefill(tcm.init_params(0), batch)
    assert tuple(y.shape) == (2, 1, 256) and torch.isfinite(y).all()
    s = st["fold_layer0"]
    assert sorted(s) == ["cm0_shift", "wkv0_s", "wkv0_shift"]
    assert tuple(s["wkv0_s"].shape) == (3, 2, 4, 16, 16)
    assert s["wkv0_s"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def _without_kernels(text):
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith("kernels:")]


@pytest.mark.parametrize("smoke", [False, True])
def test_plan_describe_matches_jax(smoke):
    shape = ("serve", "decode", 1024, 8)
    jcm = jflow.compile(ARCH, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(ARCH, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    assert _without_kernels(tcm.describe()) == _without_kernels(jcm.describe())
    units = "units: 3 (1 folded: 2x3)" if smoke \
        else "units: 4 (2 folded: 8x3, 2x1)"
    assert units in tcm.describe()
    folded = [(u.reps, u.period) for u in tcm.plan.units if u.folded]
    assert folded == ([(2, 3)] if smoke else [(8, 3), (2, 1)])
    assert tcm.describe().splitlines()[-1] == (
        "  kernels: backend=auto attention=ref conv2d=ref copy_block=ref "
        "decode_attention=ref glu_matmul=ref matmul=ref "
        "paged_decode_attention=ref rg_lru=ref")


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_jaxs(smoke):
    """The port's copy of the configuration holds the JAX package's
    fields and values, full and smoke."""
    from repro.configs import get_smoke as jget_smoke
    tcfg = get_smoke(ARCH) if smoke else get_config(ARCH)
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ARCH in ARCHS
