"""The LM slice as a whole: the port's ``flow.compile(...)`` prefill, decode
and generate against the JAX package's on smoke-size llama3.2-1b (3 layers,
d_model 64), on the JAX parameters carried across by ``repro_torch.bridge``
and the same tokens from numpy.  JAX runs un-jitted and eager
(``CompiledModel.apply``) except in ``generate``.

Tolerances, on ``conftest.relerr`` (max |diff| over max |ref|):
* fp32 < 1e-4 — the same arithmetic, summed in another order;
* bf16 < 5e-2 — activations round to bf16 after every op; where two fp32
  sums straddle a rounding boundary the bf16 values differ by one ulp
  (~0.4%), and such differences compound through the layers.
Greedy tokens are compared for identity in fp32 only (bf16 logits of a
random-init model can tie or swap).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, MoEConfig, ShapeConfig
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import decode_attention as tdec

ARCH = "llama3.2-1b"
SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 12, 4
FLOWS = {
    "folded": dict(mode="folded"),
    "folded_fp32": dict(mode="folded", precision="fp32"),
    "auto": dict(mode="auto"),
    "base": "base",
}
TOL = {"bf16": 5e-2, "fp32": 1e-4}
# the port's kernel backend beside the JAX one it is held against
BACKENDS = {"auto": "auto", "cuda": "pallas_interpret"}


def _flow(F, name):
    spec = FLOWS[name]
    return F().base() if spec == "base" else F(**spec)


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (2, PROMPT)).astype(np.int32),
            rng.randint(0, 256, (2, STEPS)).astype(np.int32))


def _models(flow_name, backend="auto"):
    jcm = jflow.compile(jget_smoke(ARCH), JShapeConfig(*SHAPE),
                        _flow(JFlowConfig, flow_name),
                        backend=BACKENDS[backend])
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(get_smoke(ARCH), ShapeConfig(*SHAPE),
                        _flow(FlowConfig, flow_name), backend=backend,
                        device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _leaves(state):
    return {(u, s, leaf): v for u, st in state.items()
            for s, d in st.items() for leaf, v in d.items()}


@functools.lru_cache(maxsize=None)
def _run(flow_name, backend="auto"):
    """Prefill then STEPS teacher-forced decode steps through both stacks:
    {"j": ..., "t": ...} each holding the prefill logits, the prefill
    state's leaves and the decode logits, as float32 numpy."""
    jcm, jp, tcm, tp = _models(flow_name, backend)
    prompt, nxt = _tokens()
    jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt)},
                           mode="prefill")
    tl, tst, taux = tcm.prefill(tp, {"tokens": _t(prompt)})
    assert taux == {}
    out = {"j": {"prefill": np.asarray(jl, np.float32),
                 "state": {k: np.asarray(v, np.float32)
                           for k, v in _leaves(jst).items()}, "decode": []},
           "t": {"prefill": tl.float().numpy(), "dtype": tl.dtype,
                 # copies: decode writes into the state's tensors in place
                 "state": {k: v.float().numpy().copy()
                           for k, v in _leaves(tst).items()}, "decode": []}}
    for i in range(STEPS):
        tok = nxt[:, i:i + 1]
        jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(tok)}, state=jst,
                               cache_index=jnp.int32(PROMPT + i),
                               mode="decode")
        tl, tst2, _ = tcm.decode(tp, {"tokens": _t(tok)}, tst, PROMPT + i)
        assert tst2 is tst                  # decode consumes its state
        out["j"]["decode"].append(np.asarray(jl, np.float32))
        out["t"]["decode"].append(tl.float().numpy())
    return out


def _prec(flow_name):
    return "fp32" if flow_name in ("folded_fp32", "base") else "bf16"


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_prefill_logits_and_state(flow_name):
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
def test_decode_logits_teacher_forced(flow_name):
    r = _run(flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"]["decode"], r["j"]["decode"])):
        assert tl.shape == jl.shape == (2, 1, 256)
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_cuda_backend_on_cpu_matches_pallas_interpret(prec):
    """``backend="cuda"`` on a CPU model reaches the kernel wrappers, which
    run their plain versions; JAX's ``pallas_interpret`` runs the Pallas
    kernels' bodies.  Both are the kernels' fp32 semantics."""
    name = "folded_fp32" if prec == "fp32" else "folded"
    f0, d0 = tatt.flash_attention.launches, tdec.decode_attention.launches
    r = _run(name, "cuda")
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert (tatt.flash_attention.launches,
            tdec.decode_attention.launches) == (f0, d0)
    assert relerr(r["t"]["prefill"], r["j"]["prefill"]) < TOL[prec]
    for tl, jl in zip(r["t"]["decode"], r["j"]["decode"]):
        assert relerr(tl, jl) < TOL[prec]


def test_greedy_generate_identical_fp32():
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _ = _tokens(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt)}, steps=8)
    tt, state = tcm.generate(tp, {"tokens": _t(prompt)}, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    kv = state["fold_layer0"]["kv0"]
    # prompt + 7 decoded tokens hold positions 0..18 of the 32-slot cache
    assert (kv["pos"][:, :, :PROMPT + 7] >= 0).all()
    assert (kv["pos"][:, :, PROMPT + 7:] == -1).all()


def test_sampled_generate_follows_its_seed():
    _, _, tcm, tp = _models("folded_fp32")
    prompt = _t(_tokens(2)[0])
    a, _ = tcm.generate(tp, {"tokens": prompt}, steps=6, temperature=1.0,
                        seed=3)
    b, _ = tcm.generate(tp, {"tokens": prompt}, steps=6, temperature=1.0,
                        seed=3)
    c, _ = tcm.generate(tp, {"tokens": prompt}, steps=6, temperature=1.0,
                        seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < 256)).all()


def test_init_state_matches_jax_layout():
    jcm, _, tcm, _ = _models("folded")
    js, ts = _leaves(jcm.init_state(3)), _leaves(tcm.init_state(3))
    assert sorted(js) == sorted(ts)
    for key, jv in js.items():
        assert tuple(ts[key].shape) == jv.shape, key
        assert str(ts[key].dtype).split(".")[-1] == jv.dtype.name, key
        want = -1 if key[-1] == "pos" else 0
        assert (ts[key] == want).all(), key


def test_plan_matches_jax():
    jcm, _, tcm, _ = _models("folded")
    strip = [ln for ln in tcm.describe().splitlines()
             if not ln.lstrip().startswith("kernels:")]
    assert strip == [ln for ln in jcm.describe().splitlines()
                     if not ln.lstrip().startswith("kernels:")]
    assert tcm.describe().splitlines()[-1] == (
        "  kernels: backend=auto attention=ref conv2d=ref copy_block=ref "
        "decode_attention=ref glu_matmul=ref matmul=ref "
        "paged_decode_attention=ref rg_lru=ref")


@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_measure_on_cpu_counts_tokens(stage):
    tcm = tflow.compile(get_smoke(ARCH), ShapeConfig("serve", stage, 16, 2),
                        device="cpu")
    rec = tcm.measure(stage, iters=2)
    assert rec["device"] == "cpu" and rec["timer"] == "wall_clock"
    per_call = 2 * 16 if stage == "prefill" else 2
    assert rec["tokens_per_s"] == pytest.approx(
        per_call / rec["measured_step_s"])


@pytest.mark.parametrize("change,what", [
    (dict(ffn_kind="moe"), "MoE"),
    (dict(n_encoder_layers=2), "encoder-decoder"),
    (dict(n_patch_tokens=4), "patch tokens"),
])
def test_unported_families_raise(change, what):
    """Every family this test once saw raise is ported since: MoE layers,
    the multimodal patch stub and the encoder-decoder graph
    (``tests/test_torch_{moe,vlm,whisper}.py`` hold them to JAX).  llama's
    smoke config with each change, given the config it needs (and the
    batch its stub reads), compiles and runs a prefill."""
    cfg = dataclasses.replace(get_smoke(ARCH), **change)
    if what not in PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tflow.compile(cfg, ShapeConfig(*SHAPE), device="cpu")
        return
    cfg = dataclasses.replace(cfg, **PORTED[what])
    tcm = tflow.compile(cfg, ShapeConfig(*SHAPE), device="cpu")
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (2, 8)))}
    if cfg.n_patch_tokens:
        batch["patches"] = torch.from_numpy(rng.randn(
            2, cfg.n_patch_tokens, cfg.d_vision).astype(np.float32))
    if cfg.n_encoder_layers:
        batch["frames"] = torch.from_numpy(rng.randn(
            2, cfg.encoder_seq, cfg.d_model).astype(np.float32))
    y, _, _ = tcm.prefill(tcm.init_params(0), batch)
    assert tuple(y.shape) == (2, 1, 256) and torch.isfinite(y.float()).all()


# the families ported since the test was written, with the config each
# needs on top of the change
PORTED = {
    "MoE": dict(moe=MoEConfig(num_experts=4, top_k=2, d_expert=48,
                              capacity_factor=4.0)),
    "patch tokens": dict(d_vision=32),
    "encoder-decoder": dict(encoder_seq=10, cross_attention=True),
}
