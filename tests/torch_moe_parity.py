"""The MoE models' parity tests, shared by
``tests/test_torch_moe_{deepseek,mixtral}.py``: each of those files
collects them for one model through its ``arch`` fixture (one file a
model, so that the test workers take them in parallel).  The op, the
configs and the training loss are in ``tests/test_torch_moe.py``.

deepseek-moe-16b and mixtral-8x7b at smoke size against the JAX package,
on the JAX parameters carried across by ``repro_torch.bridge``: prefill
logits and state, teacher-forced decode steps (the helpers of
``tests/torch_dense_parity.py``), ``backend="cuda"`` on the CPU against
``pallas_interpret`` under the routing-flip rule, each full config's head
geometry at smoke depth, greedy ``generate`` and ``Engine.run`` against
JAX's cold run.  Tolerances as in ``torch_dense_parity``: fp32 < 1e-4,
bf16 < 5e-2, greedy tokens identical in fp32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense_parity as dp
from conftest import relerr
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.core import ops_impl as tops
from repro_torch.serving import Engine, EngineConfig, synthetic_requests


@pytest.mark.parametrize("flow_name", sorted(dp.FLOWS))
def test_prefill_logits_and_state(arch, flow_name):
    dp.test_prefill_logits_and_state(arch, flow_name)


@pytest.mark.parametrize("flow_name", sorted(dp.FLOWS))
def test_decode_logits_teacher_forced(arch, flow_name):
    dp.test_decode_logits_teacher_forced(arch, flow_name)


@functools.lru_cache(maxsize=None)
def _routed_run(arch, flow_name, backend):
    """``dp._run`` with every MoE layer's routing recorded on both sides, in
    call order (the prefill's layers, then each decode step's): JAX's
    through a ``jax.debug.callback`` on ``lax.top_k``, the port's through
    ``ops_impl.ROUTING_HOOK``.  Returns the run and [(JAX's probs, JAX's
    idx, the port's idx)] a layer call."""
    jseen, tseen = [], []
    top_k = jax.lax.top_k

    def recorded(probs, k):
        v, i = top_k(probs, k)
        jax.debug.callback(lambda p, i_: jseen.append(
            (np.asarray(p), np.asarray(i_))), probs, i, ordered=True)
        return v, i
    jax.lax.top_k = recorded
    tops.ROUTING_HOOK = lambda ctx, a, probs, idx, keep: tseen.append(
        idx.numpy().copy())
    try:
        r = dp._run.__wrapped__(arch, flow_name, backend)   # not the cache's
    finally:
        jax.lax.top_k = top_k
        tops.ROUTING_HOOK = None
    assert len(jseen) == len(tseen) > 0
    return r, [(jp, ji, ti) for (jp, ji), ti in zip(jseen, tseen)]


def _flipped_rows(routing, n_layers, calls):
    """The rows whose routing differed from JAX's in any layer of the first
    ``calls`` calls, and the smallest reference margin among the flipped
    picks (the gap between JAX's k-th and (k+1)-th probability)."""
    rows, margin = set(), np.inf
    for jp, ji, ti in routing[:calls * n_layers]:
        flip = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)     # (B, S)
        for b, s in zip(*np.nonzero(flip)):
            rows.add(int(b))
            o = np.sort(jp[b, s])[::-1]
            k = ji.shape[-1]
            margin = min(margin, float(o[k - 1] - o[k]))
    return rows, margin


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_cuda_backend_on_cpu_matches_pallas_interpret(arch, prec):
    """``backend="cuda"`` on a CPU model (the kernel wrappers' plain
    versions) against JAX's ``pallas_interpret``.  A bf16 rounding can move
    a near-tie in a token's top-k (deepseek's third decode step flips one
    pick of row 1, a reference margin of 5e-4): the logits are then held
    on the rows whose routing agreed with JAX's in every layer of every
    call so far, every flip must be a near-tie (margin < 1e-2) and at least
    one row stays held.  fp32 flips nothing."""
    name = "folded_fp32" if prec == "fp32" else "folded"
    r, routing = _routed_run(arch, name, "cuda")
    n_layers = len(routing) // (1 + dp.STEPS)
    outs = [r["t"]["prefill"]] + r["t"]["decode"]
    refs = [r["j"]["prefill"]] + r["j"]["decode"]
    for c, (tl, jl) in enumerate(zip(outs, refs)):
        rows, margin = _flipped_rows(routing, n_layers, c + 1)
        if prec == "fp32":
            assert not rows
        assert margin >= 1e-2 if not rows else margin < 1e-2
        keep = [b for b in range(tl.shape[0]) if b not in rows]
        assert keep, f"call {c}: every row flipped"
        assert relerr(tl[keep], jl[keep]) < dp.TOL[prec], (c, rows)


def test_full_head_geometry_matches_jax(arch):
    """deepseek's 16 over 16 heads of 128 and mixtral's 32 over 8 of 128
    with its 4096-token window, at smoke depth and width."""
    full = get_config(arch).attention
    r = dp._run(arch, "folded_fp32", "cuda", full_heads=True)
    assert relerr(r["t"]["prefill"], r["j"]["prefill"]) < dp.TOL["fp32"]
    for tl, jl in zip(r["t"]["decode"], r["j"]["decode"]):
        assert relerr(tl, jl) < dp.TOL["fp32"]
    _, _, tcm, _ = dp._models(arch, "folded", full_heads=True)
    kv = dp._leaves(tcm.init_state(2))
    assert {tuple(v.shape[-2:]) for k, v in kv.items() if k[-1] != "pos"} \
        == {(full.n_kv_heads, full.head_dim)}


def test_greedy_generate_identical_fp32(arch):
    jcm, jp, tcm, tp = dp._models(arch, "folded_fp32")
    prompt, _ = dp._tokens(1)
    jt, _ = jcm.generate(jp, {"tokens": jnp.asarray(prompt)}, steps=8)
    tt, _ = tcm.generate(tp, {"tokens": dp._t(prompt)}, steps=8)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_init_state_matches_jax_layout(arch):
    dp.test_init_state_matches_jax_layout(arch)


# prompts a bucket the rolling cache holds: smoke mixtral's window (and so
# its cache) is 16 tokens, and its requests run on past it in the pool
ENGINE_PROMPTS = {"deepseek-moe-16b": (30, 6), "mixtral-8x7b": (16, 14)}


def test_engine_run_matches_jax_cold_run(arch):
    """``Engine.run`` (fp32, greedy, 7 requests through 4 slots: bucketed,
    left-padded prefill, evictions and refills) gives JAX's cold-run
    tokens, and its captured logits agree within 1e-4."""
    jcm, jp, tcm, tp = dp._models(arch, "folded_fp32",
                                  shape=dp.SERVE_SHAPE)
    plen, new = ENGINE_PROMPTS[arch]
    reqs = synthetic_requests(7, 256, prompt_len=plen, max_new_tokens=new,
                              seed=5)
    ref = jengine.Engine(jcm, jp, jengine.EngineConfig(
        capture_logits=True, **dp.SERVE)).run(
        [jsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                        r.stop_token) for r in reqs])
    got = Engine(tcm, tp, EngineConfig(capture_logits=True, **dp.SERVE)).run(
        reqs)
    assert set(ref.by_id) == set(got.by_id)
    for rid, a in ref.by_id.items():
        b = got.by_id[rid]
        assert a.tokens == b.tokens, f"request {rid} diverged"
        for la, lb in zip(a.logits, b.logits):
            np.testing.assert_allclose(lb, np.asarray(la), rtol=0,
                                       atol=dp.TOL["fp32"])
    assert got.metrics["refills"] >= 1
