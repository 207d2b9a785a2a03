"""The multimodal patch stub (llava-next-mistral-7b) in the port against the
JAX package, at smoke size on the JAX parameters carried across by
``repro_torch.bridge``: ``op_patch_proj`` on the same numpy inputs, the
prefill with patch embeddings and teacher-forced decode steps (which skip
the prompt-only ``mm_project`` block), ``backend="cuda"`` on the CPU
against ``pallas_interpret``, the full config's head geometry (32 over 8
heads of 128) at smoke depth, greedy ``generate``, ``Engine.run``'s
refusal (a request carries no patches; JAX's engine fails there with a
``KeyError``) and ``launch.serve``'s single-batch generate.

Tolerances, on ``conftest.relerr``: the op fp32 < 1e-5 and bf16 < 2e-2;
logits fp32 < 1e-4 and bf16 < 5e-2; greedy tokens identical in fp32.
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
from repro.core import ops_impl as jops
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import ops_impl as tops
from repro_torch.serving import Engine, EngineConfig, synthetic_requests

ARCH = "llava-next-mistral-7b"
SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 12, 4
FLOWS = {"folded": dict(mode="folded"),
         "folded_fp32": dict(mode="folded", precision="fp32")}
TOL = {"bf16": 5e-2, "fp32": 1e-4}
BACKENDS = {"auto": "auto", "cuda": "pallas_interpret"}


def _prec(flow_name):
    return "fp32" if flow_name == "folded_fp32" else "bf16"


def _inputs(seed=0):
    """Prompt tokens, the next tokens, and the patch embeddings (drawn
    after the tokens)."""
    cfg = get_smoke(ARCH)
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, 256, (2, PROMPT)).astype(np.int32)
    nxt = rng.randint(0, 256, (2, STEPS)).astype(np.int32)
    patches = rng.randn(2, cfg.n_patch_tokens, cfg.d_vision).astype(
        np.float32)
    return prompt, nxt, patches


def _jcfg(full_heads):
    c = jget_smoke(ARCH)
    return dataclasses.replace(c, attention=jget_config(ARCH).attention) \
        if full_heads else c


def _tcfg(full_heads):
    c = get_smoke(ARCH)
    return dataclasses.replace(c, attention=get_config(ARCH).attention) \
        if full_heads else c


def _models(flow_name, backend="auto", full_heads=False, shape=SHAPE):
    jcm = jflow.compile(_jcfg(full_heads), JShapeConfig(*shape),
                        JFlowConfig(**FLOWS[flow_name]),
                        backend=BACKENDS[backend])
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(_tcfg(full_heads), ShapeConfig(*shape),
                        FlowConfig(**FLOWS[flow_name]), backend=backend,
                        device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _t(a):
    return torch.from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _run(flow_name, backend="auto", full_heads=False):
    """The prefill with patches, then STEPS teacher-forced decode steps of
    tokens alone, through both stacks (float32 numpy logits)."""
    jcm, jp, tcm, tp = _models(flow_name, backend, full_heads)
    prompt, nxt, patches = _inputs()
    jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt),
                                "patches": jnp.asarray(patches)},
                           mode="prefill")
    tl, tst, taux = tcm.prefill(tp, {"tokens": _t(prompt).long(),
                                     "patches": _t(patches)})
    assert taux == {}
    out = {"j": [np.asarray(jl, np.float32)], "t": [tl.float().numpy()]}
    for i in range(STEPS):
        tok = nxt[:, i:i + 1]
        jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(tok)}, state=jst,
                               cache_index=jnp.int32(PROMPT + i),
                               mode="decode")
        tl, tst, _ = tcm.decode(tp, {"tokens": _t(tok).long()}, tst,
                                PROMPT + i)
        out["j"].append(np.asarray(jl, np.float32))
        out["t"].append(tl.float().numpy())
    return out


# ---------------------------------------------------------------------------
# config, plan, op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_jaxs(smoke):
    tcfg = get_smoke(ARCH) if smoke else get_config(ARCH)
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "vlm" and tcfg.n_patch_tokens


@pytest.mark.parametrize("smoke", [False, True])
def test_plan_matches_jax(smoke):
    shape = ("serve", "decode", 2048, 8)
    jcm = jflow.compile(ARCH, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(ARCH, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    tl = [ln for ln in tcm.describe().splitlines() if "kernels:" not in ln]
    jl = [ln for ln in jcm.describe().splitlines() if "kernels:" not in ln]
    assert tl == jl
    assert tcm.cfg.param_count() == jcm.cfg.param_count()
    assert tcm.plan.graph.blocks[1].kind == "mm"


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_patch_proj_matches_jax(prec):
    """The projector (d_vision -> d_model -> d_model, tanh-GELU between)
    replaces the first n_patches positions and keeps the rest."""
    rng = np.random.RandomState(4)
    B, S, P, dv, d = 2, 10, 4, 32, 64
    h = rng.randn(B, S, d).astype(np.float32)
    patches = rng.randn(B, P, dv).astype(np.float32)
    ps = {"mm_w1": rng.randn(dv, d) * dv ** -0.5, "mm_b1": rng.randn(d) * .1,
          "mm_w2": rng.randn(d, d) * d ** -0.5, "mm_b2": rng.randn(d) * .1}
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[prec]
    plan = SimpleNamespace(flow=SimpleNamespace(precision=prec))
    op = SimpleNamespace(attrs={"n_patches": P, "d_vision": dv})
    jc = jops.Ctx(mode="prefill", plan=plan)
    jc.aux["__inputs__"] = {"patches": jnp.asarray(patches)}
    tc = tops.Ctx(mode="prefill", plan=plan)
    tc.aux["__inputs__"] = {"patches": torch.from_numpy(patches)}
    jy = jops.op_patch_proj(
        jc, op, {k: jnp.asarray(v, jnp.float32).astype(jdt)
                 for k, v in ps.items()}, jnp.asarray(h, jdt))
    ty = tops.op_patch_proj(
        tc, op, {k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)
                 for k, v in ps.items()}, torch.from_numpy(h).to(tdt))
    assert ty.dtype == tdt and tuple(ty.shape) == (B, S, d)
    assert relerr(ty.float().numpy(), np.asarray(jy, np.float32)) < \
        (2e-2 if prec == "bf16" else 1e-5)
    assert torch.equal(ty[:, P:], torch.from_numpy(h).to(tdt)[:, P:])


def test_measure_inputs_draw_patches_last():
    """A prefill- or train-kind cell's batch carries ``patches`` (B,
    n_patch_tokens, d_vision) fp32, drawn after the tokens and labels as
    the JAX package lays them out; a decode-kind cell's does not."""
    cfg = get_smoke(ARCH)
    for kind, keys in (("prefill", ["tokens", "patches"]),
                       ("train", ["tokens", "labels", "patches"]),
                       ("decode", ["tokens"])):
        cm = tflow.compile(ARCH, ShapeConfig("c", kind, 16, 2), smoke=True,
                           device="cpu")
        b = cm._measure_inputs(0)
        assert list(b) == keys
        rng = np.random.RandomState(0)
        want = [rng.randint(0, cfg.vocab_size, (2, 1 if kind == "decode"
                                                 else 16))]
        if kind == "train":
            want.append(rng.randint(0, cfg.vocab_size, (2, 16)))
        if kind != "decode":
            want.append(rng.randn(2, cfg.n_patch_tokens, cfg.d_vision))
        for k, w in zip(keys, want):
            assert np.array_equal(b[k].numpy(), w.astype(b[k].numpy().dtype))
        if kind != "decode":
            assert b["patches"].dtype == torch.float32
    rec = tflow.compile(ARCH, ShapeConfig("c", "prefill", 16, 2), smoke=True,
                        device="cpu").measure("prefill", iters=1)
    assert rec["tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# the model at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_prefill_and_decode_with_patches_match_jax(flow_name):
    r = _run(flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert tl.shape == jl.shape == (2, 1, 256) and np.isfinite(tl).all()
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_cuda_backend_on_cpu_matches_pallas_interpret(flow_name):
    r = _run(flow_name, "cuda")
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


def test_full_head_geometry_matches_jax():
    """The full config's 32 over 8 heads of 128 (groups of 4) at smoke
    depth and width, fp32, through the kernel wrappers' plain versions
    against JAX's Pallas kernels in interpret mode."""
    r = _run("folded_fp32", "cuda", full_heads=True)
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert relerr(tl, jl) < TOL["fp32"], i


def test_patches_reach_the_model_and_decode_skips_them():
    """A second draw of the patches changes the prefill's logits; decode
    runs without ``patches`` in its batch and never reads the projector
    (its weights set to NaN change nothing)."""
    _, _, tcm, tp = _models("folded_fp32")
    prompt, nxt, patches = _inputs()
    tok = _t(prompt).long()
    a, st, _ = tcm.prefill(tp, {"tokens": tok, "patches": _t(patches)})
    b, _, _ = tcm.prefill(tp, {"tokens": tok, "patches": _t(patches + 1.0)})
    assert relerr(a.numpy(), b.numpy()) > 1e-3
    st2 = {u: {k: ({n: t.clone() for n, t in v.items()}
                   if isinstance(v, dict) else v.clone())
               for k, v in d.items()} for u, d in st.items()}
    y, _, _ = tcm.decode(tp, {"tokens": _t(nxt[:, :1]).long()}, st, PROMPT)
    nan = {**tp, "mm_project": {k: torch.full_like(v, float("nan"))
                                for k, v in tp["mm_project"].items()}}
    y2, _, _ = tcm.decode(nan, {"tokens": _t(nxt[:, :1]).long()}, st2,
                          PROMPT)
    assert torch.equal(y, y2) and torch.isfinite(y).all()


def test_greedy_generate_identical_fp32():
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _, patches = _inputs(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt),
                              "patches": jnp.asarray(patches)}, steps=8)
    tt, _ = tcm.generate(tp, {"tokens": _t(prompt).long(),
                              "patches": _t(patches)}, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_engine_run_refuses_before_any_tick():
    _, _, tcm, tp = _models("folded_fp32", shape=("serve", "decode", 64, 4))
    eng = Engine(tcm, tp, EngineConfig(max_batch=4, max_seq_len=64,
                                       block_size=8))
    with pytest.raises(ValueError, match="patches"):
        eng.run(synthetic_requests(3, 256, prompt_len=12, max_new_tokens=4))
    assert eng.last_cache is None and eng.last_report is None


def test_serve_cli_generates_with_patches(capsys, monkeypatch):
    """``launch.serve`` hands ``generate`` the patches of the JAX CLI's
    layout: ``RandomState(0)`` ``randn`` of (batch, n_patch_tokens,
    d_vision), drawn after the prompt tokens."""
    from repro_torch.launch import serve
    seen = []
    gen = Engine.generate
    monkeypatch.setattr(Engine, "generate", lambda self, batch, steps: (
        seen.append(batch), gen(self, batch, steps))[1])
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--steps", "4"])
    out = capsys.readouterr().out
    assert f"plan[{ARCH} x cli]" in out and "generated (2, 4)" in out
    cfg = get_smoke(ARCH)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (2, 12))
    patches = rng.randn(2, cfg.n_patch_tokens, cfg.d_vision)
    (batch,) = seen
    assert np.array_equal(batch["tokens"].numpy(), tokens)
    assert batch["patches"].dtype == torch.float32
    assert np.array_equal(batch["patches"].numpy(),
                          patches.astype(np.float32))
