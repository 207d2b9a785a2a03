"""The parity tests of the rest of the dense family, shared by
``tests/test_torch_dense_{qwen,phi4,stablelm}.py``: each of those files
collects them for one model through its ``arch`` fixture (one file a
model, so that the test workers take them in parallel).

The port's qwen1.5-4b, phi4-mini-3.8b and stablelm-1.6b against the JAX
package's, on the JAX parameters carried across by ``repro_torch.bridge``
and the same tokens and requests from numpy (smoke size, as
``tests/test_torch_lm.py`` and ``tests/test_torch_serving.py`` hold
llama3.2-1b).

The three bring what llama does not: QKV bias (qwen, stablelm), partial
rope (phi4 rotates 0.75 of a head, stablelm 0.25), LayerNorm with a bias
(stablelm), rope base 1e6 (qwen), and groups of 1 (qwen, stablelm) and 3
(phi4) query heads a KV head.  ``test_full_head_geometry_matches_jax``
runs each full config's attention geometry (head width, heads over KV
heads, rope base and fraction) at smoke depth and width, so the branches
that only the full configs reach (head width 128 and 64, rot_dim 96 of
128) are held to JAX on the CPU too.

Tolerances, on ``conftest.relerr`` (max |diff| over max |ref|), as in
``tests/test_torch_lm.py``: fp32 < 1e-4 (the same arithmetic summed in
another order), bf16 < 5e-2 (activations round to bf16 after every op,
and one-ulp differences compound through the layers).  Greedy tokens are
compared for identity in fp32; the serving runs' captured logits within
1e-4.
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
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import matmul_fused as tmm
from repro_torch.serving import Engine, EngineConfig, synthetic_requests

SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 12, 4
FLOWS = {
    "folded": dict(mode="folded"),
    "folded_fp32": dict(mode="folded", precision="fp32"),
    "base": "base",
}
TOL = {"bf16": 5e-2, "fp32": 1e-4}
# the port's kernel backend beside the JAX one it is held against
BACKENDS = {"auto": "auto", "cuda": "pallas_interpret"}
# serving, as tests/test_torch_serving.py: fp32, 4 slots of 64 tokens
SERVE_SHAPE = ("serve", "decode", 64, 4)
SERVE = dict(max_batch=4, max_seq_len=64, block_size=8)


def _flow(F, name):
    spec = FLOWS[name]
    return F().base() if spec == "base" else F(**spec)


def _full_heads(arch):
    """The smoke config with the full config's attention geometry: head
    width, heads over KV heads, rope base and fraction, QKV bias."""
    return dataclasses.replace(get_smoke(arch),
                               attention=get_config(arch).attention)


def _jfull_heads(arch):
    return dataclasses.replace(jget_smoke(arch),
                               attention=jget_config(arch).attention)


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (2, PROMPT)).astype(np.int32),
            rng.randint(0, 256, (2, STEPS)).astype(np.int32))


def _models(arch, flow_name, backend="auto", full_heads=False,
            shape=SHAPE):
    jcfg = _jfull_heads(arch) if full_heads else jget_smoke(arch)
    tcfg = _full_heads(arch) if full_heads else get_smoke(arch)
    jcm = jflow.compile(jcfg, JShapeConfig(*shape),
                        _flow(JFlowConfig, flow_name),
                        backend=BACKENDS[backend])
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(tcfg, ShapeConfig(*shape),
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
def _run(arch, flow_name, backend="auto", full_heads=False):
    """Prefill then STEPS teacher-forced decode steps through both stacks:
    {"j": ..., "t": ...} each holding the prefill logits, the prefill
    state's leaves and the decode logits, as float32 numpy."""
    jcm, jp, tcm, tp = _models(arch, flow_name, backend, full_heads)
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
def test_prefill_logits_and_state(arch, flow_name):
    r = _run(arch, flow_name)
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
def test_decode_logits_teacher_forced(arch, flow_name):
    r = _run(arch, flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"]["decode"], r["j"]["decode"])):
        assert tl.shape == jl.shape == (2, 1, 256)
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_cuda_backend_on_cpu_matches_pallas_interpret(arch, prec):
    """``backend="cuda"`` on a CPU model reaches the kernel wrappers, which
    run their plain versions; JAX's ``pallas_interpret`` runs the Pallas
    kernels' bodies.  Both are the kernels' fp32 semantics."""
    name = "folded_fp32" if prec == "fp32" else "folded"
    counts = (tatt.flash_attention.launches, tdec.decode_attention.launches,
              tmm.matmul_fused.launches)
    r = _run(arch, name, "cuda")
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert (tatt.flash_attention.launches, tdec.decode_attention.launches,
            tmm.matmul_fused.launches) == counts
    assert relerr(r["t"]["prefill"], r["j"]["prefill"]) < TOL[prec]
    for tl, jl in zip(r["t"]["decode"], r["j"]["decode"]):
        assert relerr(tl, jl) < TOL[prec]


def test_full_head_geometry_matches_jax(arch):
    """Each full config's attention (qwen: 20 over 20 heads of 128, rope
    base 1e6; phi4: 24 over 8 of 128, rot_dim 96; stablelm: 32 over 32 of
    64, rot_dim 16), at smoke depth and width, in fp32 through the kernel
    wrappers' plain versions against JAX's Pallas kernels in interpret
    mode."""
    full = get_config(arch).attention
    jcm, _, tcm, _ = _models(arch, "folded_fp32", "cuda", full_heads=True)
    assert tcm.cfg.attention == full
    r = _run(arch, "folded_fp32", "cuda", full_heads=True)
    assert relerr(r["t"]["prefill"], r["j"]["prefill"]) < TOL["fp32"]
    for key, jv in r["j"]["state"].items():
        assert relerr(r["t"]["state"][key], jv) < TOL["fp32"], key
    for tl, jl in zip(r["t"]["decode"], r["j"]["decode"]):
        assert relerr(tl, jl) < TOL["fp32"]
    kv = _leaves(tcm.init_state(2))
    assert {tuple(v.shape[-2:]) for k, v in kv.items() if k[-1] != "pos"} \
        == {(full.n_kv_heads, full.head_dim)}


def test_greedy_generate_identical_fp32(arch):
    jcm, jp, tcm, tp = _models(arch, "folded_fp32")
    prompt, _ = _tokens(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt)}, steps=8)
    tt, state = tcm.generate(tp, {"tokens": _t(prompt)}, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    kv = state["fold_layer0"]["kv0"]
    # prompt + 7 decoded tokens hold positions 0..18 of the 32-slot cache
    assert (kv["pos"][:, :, :PROMPT + 7] >= 0).all()
    assert (kv["pos"][:, :, PROMPT + 7:] == -1).all()


def test_init_state_matches_jax_layout(arch):
    jcm, _, tcm, _ = _models(arch, "folded")
    js, ts = _leaves(jcm.init_state(3)), _leaves(tcm.init_state(3))
    assert sorted(js) == sorted(ts)
    for key, jv in js.items():
        assert tuple(ts[key].shape) == jv.shape, key
        assert str(ts[key].dtype).split(".")[-1] == jv.dtype.name, key
        want = -1 if key[-1] == "pos" else 0
        assert (ts[key] == want).all(), key


def test_engine_run_matches_jax_cold_run(arch):
    """``Engine.run`` (fp32, greedy, 7 requests of up to 30 tokens through
    4 slots: bucketed prefill, evictions and refills) gives JAX's cold-run
    tokens, and its captured logits agree within 1e-4."""
    jcm, jp, tcm, tp = _models(arch, "folded_fp32", shape=SERVE_SHAPE)
    reqs = synthetic_requests(7, 256, prompt_len=30, max_new_tokens=6,
                              seed=5)
    ref = jengine.Engine(jcm, jp, jengine.EngineConfig(
        capture_logits=True, **SERVE)).run(
        [jsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                        r.stop_token) for r in reqs])
    got = Engine(tcm, tp, EngineConfig(capture_logits=True, **SERVE)).run(
        reqs)
    assert set(ref.by_id) == set(got.by_id)
    for rid, a in ref.by_id.items():
        b = got.by_id[rid]
        assert a.tokens == b.tokens, f"request {rid} diverged"
        assert len(b.logits) == len(a.tokens)
        for la, lb in zip(a.logits, b.logits):
            np.testing.assert_allclose(lb, np.asarray(la), rtol=0,
                                       atol=TOL["fp32"])
    assert got.metrics["refills"] >= 1
