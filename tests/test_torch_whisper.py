"""whisper-small (the encoder-decoder with cross-attention) in the port
against the JAX package, on the same numpy inputs.

* the configuration, ``param_count`` and the plan, full and smoke;
  ``init_state``'s layout (the decoder's rolling K/V and the encoder's
  cross-attention K/V);
* ``op_frames_in`` and the cross branch of ``op_attention`` (prefill
  caching the encoder's K/V, decode reading them back);
* the smoke model (2 + 2 layers, width 64, 4 heads of 16, 12 frames)
  through ``flow.compile`` on the JAX parameters carried across by
  ``repro_torch.bridge``: prefill and teacher-forced decode logits (also
  with ``backend="cuda"`` on the CPU, the non-causal encoder through the
  flash wrapper's plain version, against ``pallas_interpret``), per-row
  positions that reach the decoder only, decode against a teacher-forced
  prefill, the frames reaching the prefill and decode skipping the
  encoder, greedy ``generate``, ``Engine.run``'s refusal (a request has no
  frames; JAX fails there with a ``KeyError``), the batch ``measure`` and
  ``launch.serve`` draw, the train loss and its gradients.

Tolerances (``conftest.relerr``): fp32 < 1e-5 for the ops and the logits,
bf16 < 2e-2 for an op and < 5e-2 for the model's logits; decode against
the prefill of the same tokens < 2e-4 (JAX's ``tests/test_models_smoke.py``
bound); the loss < 1e-5 and every gradient < 1e-4
(``tests/torch_train_parity.py``).  Greedy tokens are compared for identity
in fp32.
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
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import ops_impl as tops
from repro_torch.serving import Engine, EngineConfig, synthetic_requests
from torch_train_parity import check_gradients, check_loss

ARCH = "whisper-small"
SHAPE = ("serve", "decode", 32, 2)
PROMPT, STEPS = 10, 5
FLOWS = {"folded": dict(mode="folded"),
         "folded_fp32": dict(mode="folded", precision="fp32")}
TOL = {"bf16": 5e-2, "fp32": 1e-5}
BACKENDS = {"auto": "auto", "cuda": "pallas_interpret"}
PREC = {"fp32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


def _prec(flow_name):
    return "fp32" if flow_name == "folded_fp32" else "bf16"


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a.astype(np.float32))


def _inputs(seed=0):
    """Prompt tokens, the next tokens, and the frames (drawn after the
    tokens)."""
    cfg = get_smoke(ARCH)
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, 256, (2, PROMPT)).astype(np.int32)
    nxt = rng.randint(0, 256, (2, STEPS)).astype(np.int32)
    frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return prompt, nxt, frames


@functools.lru_cache(maxsize=None)
def _models(flow_name, backend="auto", shape=SHAPE):
    jcm = jflow.compile(jget_smoke(ARCH), JShapeConfig(*shape),
                        JFlowConfig(**FLOWS[flow_name]),
                        backend=BACKENDS[backend])
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(get_smoke(ARCH), ShapeConfig(*shape),
                        FlowConfig(**FLOWS[flow_name]), backend=backend,
                        device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


@functools.lru_cache(maxsize=None)
def _run(flow_name, backend="auto"):
    """The prefill with frames, then STEPS teacher-forced decode steps of
    tokens alone, through both stacks (float32 numpy logits)."""
    jcm, jp, tcm, tp = _models(flow_name, backend)
    prompt, nxt, frames = _inputs()
    jl, jst, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt),
                                "frames": jnp.asarray(frames)},
                           mode="prefill")
    tl, tst, taux = tcm.prefill(tp, {"tokens": _t(prompt),
                                     "frames": _t(frames)})
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


def _leaves(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# config, plan, state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_jaxs(smoke):
    tcfg = get_smoke(ARCH) if smoke else get_config(ARCH)
    jcfg = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "audio" and tcfg.cross_attention
    assert ARCH in ARCHS
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("smoke", [False, True])
def test_plan_matches_jax(smoke):
    """``describe()`` equal apart from the kernels line; the blocks in
    JAX's order; ``dec_embed`` carries ``learned_pos`` and no sinusoids,
    as JAX's (its embed op reads only ``sinusoid_pos``)."""
    shape = ("serve", "decode", 448, 8)
    jcm = jflow.compile(ARCH, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(ARCH, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    tl = [ln for ln in tcm.describe().splitlines() if "kernels:" not in ln]
    jl = [ln for ln in jcm.describe().splitlines() if "kernels:" not in ln]
    assert tl == jl
    kinds = [b.kind for b in tcm.plan.graph.blocks]
    n = tcm.cfg.n_layers
    assert kinds == (["enc_embed"] + ["encoder_layer"] * n + ["enc_final",
                     "dec_embed"] + ["decoder_layer"] * n + ["head"])
    emb = tcm.plan.graph.blocks[n + 2].ops[0]
    assert emb.attrs["learned_pos"] and not emb.attrs.get("sinusoid_pos")
    assert tcm.plan.graph.blocks[n + 1].attrs["captures_cross"]


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_init_state_matches_jax_layout(flow_name):
    jcm, _, tcm, _ = _models(flow_name)
    js, ts = _leaves(jcm.init_state(3)), _leaves(tcm.init_state(3))
    assert sorted(js) == sorted(ts)
    assert tuple(ts[("fold_dec0", "xdec_xkv0", "k")].shape) == (2, 3, 12, 4,
                                                                16)
    assert tuple(ts[("fold_dec0", "dec_kv0", "pos")].shape) == (2, 3, 32)
    for key, jv in js.items():
        assert tuple(ts[key].shape) == jv.shape, key
        assert str(ts[key].dtype).split(".")[-1] == jv.dtype.name, key
        want = -1 if key[-1] == "pos" else 0
        assert (ts[key] == want).all(), key


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _plan(prec):
    return SimpleNamespace(flow=SimpleNamespace(precision=prec), tiles={},
                           kernels={}, cache_len=32)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_frames_in_matches_jax(prec):
    rng = np.random.RandomState(3)
    frames = rng.randn(2, 15, 64).astype(np.float32)
    tok = np.zeros((2, 4), np.int32)
    jc = jops.Ctx(mode="prefill", plan=_plan(prec))
    jc.aux["__inputs__"] = {"frames": jnp.asarray(frames)}
    tc = tops.Ctx(mode="prefill", plan=_plan(prec))
    tc.aux["__inputs__"] = {"frames": torch.from_numpy(frames)}
    op = SimpleNamespace(attrs={"encoder_seq": 15})
    jy = jops.op_frames_in(jc, op, {}, jnp.asarray(tok))
    ty = tops.op_frames_in(tc, op, {}, _t(tok))
    assert ty.dtype == PREC[prec][1] and tuple(ty.shape) == (2, 15, 64)
    assert relerr(_np(ty), _np(jy)) < (1e-5 if prec == "fp32" else 2e-2)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_cross_attention_matches_jax(prec):
    """Prefill: unmasked attention over the encoder's K/V, which it caches;
    decode: the same K/V read from the state (its K/V inputs are
    placeholders), the state handed on as it came."""
    jdt, tdt = PREC[prec]
    rng = np.random.RandomState(4)
    B, Sq, Skv, H, Dh = 2, 6, 13, 4, 16
    q = rng.randn(B, Sq, H, Dh).astype(np.float32)
    k = rng.randn(B, Skv, H, Dh).astype(np.float32)
    v = rng.randn(B, Skv, H, Dh).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
    op = SimpleNamespace(attrs={"cross": True, "state_key": "xkv0",
                                "causal": False, "window": None,
                                "softcap": None})
    jc = jops.Ctx(mode="prefill", plan=_plan(prec))
    tc = tops.Ctx(mode="prefill", plan=_plan(prec))
    J = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    T = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    jy = jops.op_attention(jc, op, {}, *J, jnp.asarray(pos))
    ty = tops.op_attention(tc, op, {}, *T, torch.from_numpy(pos.copy()))
    tol = 1e-5 if prec == "fp32" else 2e-2
    assert tuple(ty.shape) == (B, Sq, H, Dh) and ty.dtype == tdt
    assert relerr(_np(ty), _np(jy)) < tol
    assert sorted(tc.state_out["xkv0"]) == ["k", "v"]
    assert torch.equal(tc.state_out["xkv0"]["k"], T[1])
    # decode: one query at position 20, K/V from the cached state
    q1 = rng.randn(B, 1, H, Dh).astype(np.float32)
    p1 = np.full((B, 1), 20, np.int32)
    jd = jops.Ctx(mode="decode", plan=_plan(prec),
                  state_in={"xkv0": jc.state_out["xkv0"]},
                  cache_index=jnp.int32(20))
    td = tops.Ctx(mode="decode", plan=_plan(prec),
                  state_in={"xkv0": tc.state_out["xkv0"]}, cache_index=20)
    jq, tq = jnp.asarray(q1).astype(jdt), torch.from_numpy(q1).to(tdt)
    jy = jops.op_attention(jd, op, {}, jq, jq, jq, jnp.asarray(p1))
    ty = tops.op_attention(td, op, {}, tq, tq, tq, torch.from_numpy(p1))
    assert relerr(_np(ty), _np(jy)) < tol
    assert td.state_out["xkv0"] is td.state_in["xkv0"]


# ---------------------------------------------------------------------------
# the model at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_prefill_and_decode_with_frames_match_jax(flow_name):
    r = _run(flow_name)
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert tl.shape == jl.shape == (2, 1, 256) and np.isfinite(tl).all()
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_cuda_backend_on_cpu_matches_pallas_interpret(flow_name):
    """The encoder's non-causal self-attention and the decoder's causal one
    through the flash wrapper's plain version (``backend="cuda"`` on CPU
    tensors), the projections through matmul_fused's, decode through
    decode_attention's; cross-attention stays on the reference path in
    both packages."""
    _, _, tcm, _ = _models(flow_name, "cuda")
    ks = tcm.plan.kernels
    assert ks["attention"] == ks["matmul"] == ks["decode_attention"] == "cuda"
    r = _run(flow_name, "cuda")
    for i, (tl, jl) in enumerate(zip(r["t"], r["j"])):
        assert relerr(tl, jl) < TOL[_prec(flow_name)], i


def test_row_positions_reach_the_decoder_only():
    """Per-row ``positions`` (a left-padded prompt, -1 on the padding) are
    the decoder's; the encoder keeps ``arange(encoder_seq)``, as in JAX."""
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _, frames = _inputs(3)
    pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32),
                          (2, PROMPT)).copy()
    pos[1] = np.arange(PROMPT) - 3
    pos[1, :3] = -1
    jl, _, _ = jcm.apply(jp, {"tokens": jnp.asarray(prompt),
                              "frames": jnp.asarray(frames),
                              "positions": jnp.asarray(pos)}, mode="prefill")
    tl, _, _ = tcm.prefill(tp, {"tokens": _t(prompt), "frames": _t(frames),
                                "positions": torch.from_numpy(pos)})
    assert relerr(_np(tl), _np(jl)) < TOL["fp32"]


def test_decode_matches_teacher_forced_prefill():
    _, _, tcm, tp = _models("folded_fp32")
    prompt, nxt, frames = _inputs(2)
    toks = np.concatenate([prompt, nxt], 1)
    _, st, _ = tcm.prefill(tp, {"tokens": _t(prompt), "frames": _t(frames)})
    for i in range(STEPS):
        y, st, _ = tcm.decode(tp, {"tokens": _t(nxt[:, i:i + 1])}, st,
                              PROMPT + i)
        yr, _, _ = tcm.prefill(tp, {"tokens": _t(toks[:, :PROMPT + i + 1]),
                                    "frames": _t(frames)})
        assert relerr(_np(y), _np(yr)) < 2e-4, i


def test_frames_reach_the_model_and_decode_skips_the_encoder():
    """A second draw of the frames changes the prefill's logits; decode runs
    without ``frames`` and never reads the encoder (its weights set to NaN
    change nothing): the encoder's output lives in the cross K/V."""
    _, _, tcm, tp = _models("folded_fp32")
    prompt, nxt, frames = _inputs()
    tok = _t(prompt)
    a, st, _ = tcm.prefill(tp, {"tokens": tok, "frames": _t(frames)})
    other = np.random.RandomState(1).randn(*frames.shape)
    b, _, _ = tcm.prefill(tp, {"tokens": tok, "frames": _t(other)})
    assert relerr(a.numpy(), b.numpy()) > 1e-3
    st2 = {u: {k: ({n: t.clone() for n, t in v.items()}
                   if isinstance(v, dict) else v.clone())
               for k, v in d.items()} for u, d in st.items()}
    y, _, _ = tcm.decode(tp, {"tokens": _t(nxt[:, :1])}, st, PROMPT)
    enc = [k for k in tp if k.startswith(("enc", "fold_enc"))]
    assert enc
    nan = {**tp, **{k: {n: torch.full_like(v, float("nan"))
                        for n, v in tp[k].items()} for k in enc}}
    y2, _, _ = tcm.decode(nan, {"tokens": _t(nxt[:, :1])}, st2, PROMPT)
    assert torch.equal(y, y2) and torch.isfinite(y).all()


def test_greedy_generate_identical_fp32():
    jcm, jp, tcm, tp = _models("folded_fp32")
    prompt, _, frames = _inputs(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt),
                              "frames": jnp.asarray(frames)}, steps=8)
    batch = {"tokens": _t(prompt), "frames": _t(frames)}
    tt, _ = tcm.generate(tp, batch, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    et, _ = Engine(tcm, tp, EngineConfig()).generate(batch, 8)
    assert torch.equal(et, tt)


def test_engine_run_refuses_before_any_tick():
    _, _, tcm, tp = _models("folded_fp32", shape=("serve", "decode", 64, 4))
    eng = Engine(tcm, tp, EngineConfig(max_batch=4, max_seq_len=64,
                                       block_size=8))
    with pytest.raises(ValueError, match="frames"):
        eng.run(synthetic_requests(3, 256, prompt_len=12, max_new_tokens=4))
    assert eng.last_cache is None and eng.last_report is None


def test_measure_inputs_draw_frames_last():
    """A prefill- or train-kind cell's batch carries ``frames`` (B,
    encoder_seq, d_model) fp32, drawn after the tokens and labels as the
    JAX package lays them out; a decode-kind cell's does not."""
    cfg = get_smoke(ARCH)
    for kind, keys in (("prefill", ["tokens", "frames"]),
                       ("train", ["tokens", "labels", "frames"]),
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
            want.append(rng.randn(2, cfg.encoder_seq, cfg.d_model))
        for k, w in zip(keys, want):
            assert np.array_equal(b[k].numpy(), w.astype(b[k].numpy().dtype))
    rec = tflow.compile(ARCH, ShapeConfig("c", "prefill", 16, 2), smoke=True,
                        device="cpu").measure("prefill", iters=1)
    assert rec["tokens_per_s"] > 0


def test_serve_cli_generates_with_frames(capsys, monkeypatch):
    """``launch.serve`` hands ``generate`` the frames of the JAX CLI's
    layout: ``RandomState(0)`` ``randn`` of (batch, encoder_seq, d_model),
    drawn after the prompt tokens."""
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
    frames = rng.randn(2, cfg.encoder_seq, cfg.d_model)
    (batch,) = seen
    assert np.array_equal(batch["tokens"].numpy(), tokens)
    assert batch["frames"].dtype == torch.float32
    assert np.array_equal(batch["frames"].numpy(), frames.astype(np.float32))


def test_train_loss_matches_jax():
    check_loss(ARCH)


def test_train_gradients_match_jax():
    check_gradients(ARCH)
