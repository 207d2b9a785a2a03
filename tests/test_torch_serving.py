"""The serving slice as a whole: the port's ``Engine.run`` (continuous
batching over the paged KV pool) against the JAX package's on smoke-size
llama3.2-1b in fp32 (``ShapeConfig("serve", "decode", 64, 4)``, as
``tests/test_serving.py``), on the JAX parameters carried across by
``repro_torch.bridge`` and the same requests from numpy.

Every port run — cold, bucketed, chunked, prefix-cached with a COW fork,
speculative with each drafter, host-free segments — is held to the JAX
package's *cold* run (``prefix_cache=False``, no chunking, no speculation):
greedy tokens identical, captured logits within 1e-4 (fp32, the same
arithmetic summed in another order).  JAX's own prefix-hit runs are not
the oracle: its hit-vs-cold byte-identity tests are red (ROADMAP Queue 3).
Sampled streams cannot match JAX's threefry draws, so the port is held to
its own invariants there: a decode segment gives the tokens of the host
ticks it replaces, and speculative sampled output does not depend on the
drafter.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.serving import (Engine, EngineConfig, Request,
                                 sample_targets, shared_prefix_requests,
                                 synthetic_requests)
from repro_torch.serving.kvcache import merge_state, slice_state

SHAPE = ("serve", "decode", 64, 4)
BASE = dict(max_batch=4, max_seq_len=64, block_size=8)
TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    """One compiled JAX cell and one port model, on the same weights."""
    jcm = jflow.compile("llama3.2-1b", JShapeConfig(*SHAPE),
                        JFlowConfig(mode="folded", precision="fp32"),
                        smoke=True)
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile("llama3.2-1b", ShapeConfig(*SHAPE),
                        FlowConfig(mode="folded", precision="fp32"),
                        smoke=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _jax_requests(reqs):
    return [jsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                           r.stop_token) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_cold(workload):
    """JAX's cold run of a named workload (memoised: several port runs
    are held to it)."""
    jcm, jp, _, _ = _models()
    kw = dict(BASE, capture_logits=True)
    kw.update(WORKLOADS[workload][1])
    return jengine.Engine(jcm, jp, jengine.EngineConfig(**kw)).run(
        _jax_requests(_requests(workload)))


def _port(reqs, **kw):
    _, _, tcm, tp = _models()
    ekw = dict(BASE, capture_logits=True)
    ekw.update(kw)
    eng = Engine(tcm, tp, EngineConfig(**ekw))
    return eng, eng.run(reqs)


def _cow_requests():
    rng = np.random.RandomState(21)
    p = rng.randint(0, 256, 12).astype(np.int32)       # 1.5 blocks of 8
    return [Request(x, p, max_new_tokens=4) for x in "abcd"]


def _requests(workload):
    return WORKLOADS[workload][0]()


# name -> (requests, engine knobs shared by the JAX cold run)
WORKLOADS = {
    "uniform": (lambda: synthetic_requests(6, 256, prompt_len=12,
                                           max_new_tokens=8, seed=3), {}),
    "bucketed": (lambda: synthetic_requests(7, 256, prompt_len=30,
                                            max_new_tokens=6, seed=5), {}),
    "shared_prefix": (lambda: shared_prefix_requests(
        5, 256, prefix_len=20, tail_len=6, max_new_tokens=6, seed=4),
        dict(max_batch=2)),
    "cow": (_cow_requests, dict(max_batch=2, prompt_buckets=(16, 64))),
}


def _same(ref, got, logits=True):
    """Tokens identical per request; captured logits within TOL."""
    assert set(ref.by_id) == set(got.by_id)
    for rid, a in ref.by_id.items():
        b = got.by_id[rid]
        assert a.tokens == b.tokens, f"request {rid} diverged"
        if logits:
            assert len(a.logits) == len(b.logits) == len(a.tokens)
            for la, lb in zip(a.logits, b.logits):
                np.testing.assert_allclose(lb, np.asarray(la), rtol=0,
                                           atol=TOL)


# (workload, port knobs): every port variant against JAX's cold run
VARIANTS = [
    ("uniform", {}),
    ("bucketed", {}),
    ("uniform", dict(chunked_prefill=True, chunk_size=4)),
    ("bucketed", dict(chunked_prefill=True, chunk_size=8)),
    ("shared_prefix", dict(prefix_cache=True)),
    ("shared_prefix", dict(prefix_cache=True, chunk_size=4)),
    ("cow", dict(prefix_cache=True)),
    ("uniform", dict(speculation="ngram:4")),
    ("uniform", dict(speculation="null:2")),
    ("shared_prefix", dict(speculation="ngram:3", prefix_cache=True)),
    ("uniform", dict(speculation="draft:llama3.2-1b:2")),
]


@pytest.mark.parametrize("workload,kw", VARIANTS,
                         ids=[f"{w}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'cold'}"
                              for w, kw in VARIANTS])
def test_port_run_matches_jax_cold_run(workload, kw):
    ref = _jax_cold(workload)
    _, got = _port(_requests(workload), **{**WORKLOADS[workload][1], **kw})
    _same(ref, got)
    m = got.metrics
    if kw.get("prefix_cache"):
        assert m["prefix_hits"] >= 1
    if workload == "cow":
        assert m["prefix_hits"] >= 2 and m["cow_forks"] >= 1
    if str(kw.get("speculation", "")).startswith(("ngram", "draft")):
        assert m["spec_tokens_drafted"] > 0
    if kw.get("chunked_prefill"):
        assert m["prefill_batches"] == 0 and m["catchup_tokens"] > 0


def test_cold_run_counters_and_report_schema_match_jax():
    """The cold run's loop counters equal JAX's, and ``RunReport.metrics``
    has JAX's keys in JAX's order."""
    ref = _jax_cold("bucketed")
    _, got = _port(_requests("bucketed"))
    assert list(got.metrics) == list(ref.metrics)
    timed = ("wall_s", "tokens_per_s", "p50_latency_s", "p95_latency_s",
             "p50_ttft_s", "p95_ttft_s")
    for k, v in ref.metrics.items():
        if k not in timed:
            assert got.metrics[k] == v, k
    assert got.metrics["refills"] >= 2 and got.metrics["host_syncs"] > 0
    assert "serving[7 req]" in got.describe()


def test_fori_segments_match_jax_cold_run_with_fewer_syncs():
    """Host-free segments (no logits capture: segments need it off) give
    JAX's cold tokens and read back once per segment."""
    ref = _jax_cold("uniform")
    _, host = _port(_requests("uniform"), capture_logits=False)
    eng, seg = _port(_requests("uniform"), capture_logits=False, fori_seg=4)
    _same(ref, seg, logits=False)
    m = seg.metrics
    assert m["fori_segments"] > 0
    assert m["host_syncs"] < host.metrics["host_syncs"]
    assert "fori_seg=4" in eng.describe()


def test_sampled_fori_segments_repeat_the_host_loop():
    """temperature > 0: a decode segment draws the same tokens as the host
    ticks it replaces (one generator, consumed in the same order)."""
    reqs = _requests("uniform")
    _, host = _port(reqs, capture_logits=False, temperature=0.8, seed=7)
    _, seg = _port(reqs, capture_logits=False, temperature=0.8, seed=7,
                   fori_seg=4)
    assert seg.metrics["fori_segments"] > 0
    _same(host, seg, logits=False)
    _, other = _port(reqs, capture_logits=False, temperature=0.8, seed=8)
    assert any(a.tokens != b.tokens for a, b in zip(host.results,
                                                     other.results))


def test_sampled_speculation_is_drafter_invariant():
    reqs = _requests("shared_prefix")
    _, null = _port(reqs, temperature=1.0, speculation="null:3",
                    capture_logits=False)
    _, ngram = _port(reqs, temperature=1.0, speculation="ngram:3",
                     capture_logits=False)
    assert null.metrics["spec_tokens_drafted"] == 0
    assert ngram.metrics["spec_tokens_drafted"] > 0
    _same(null, ngram, logits=False)


def test_sample_targets_is_counter_mode():
    """A (serial, commit index) pair draws the same token whichever column
    of whichever tick carries it; the draw follows the seed."""
    g = np.random.RandomState(0)
    lg = torch.from_numpy(g.randn(3, 4, 50).astype(np.float32))
    ser = torch.tensor([5, 9, 2], dtype=torch.int32)
    t0 = torch.tensor([0, 3, 7], dtype=torch.int32)
    full = sample_targets(lg, 11, ser, t0, 1.0)
    assert full.shape == (3, 4) and full.dtype == torch.int32
    tail = sample_targets(lg[:, 2:], 11, ser, t0 + 2, 1.0)
    assert torch.equal(full[:, 2:], tail)
    again = sample_targets(lg, 11, ser, t0, 1.0)
    assert torch.equal(full, again)
    draws = torch.stack([sample_targets(lg, s, ser, t0, 1.0)
                         for s in range(40)])
    assert (draws != draws[0]).any()
    # greedy limit: a dominant logit always wins
    big = lg.clone()
    big[..., 17] += 1e4
    assert (sample_targets(big, 3, ser, t0, 1.0) == 17).all()


def test_generate_and_generate_fori_match_jax():
    jcm, jp, tcm, tp = _models()
    prompt = np.random.RandomState(1).randint(0, 256, (2, 10)).astype(
        np.int32)
    jeng = jengine.Engine(jcm, jp, jengine.EngineConfig())
    teng = Engine(tcm, tp, EngineConfig())
    jt, _ = jeng.generate({"tokens": jax.numpy.asarray(prompt)}, 6)
    tt, _ = teng.generate({"tokens": torch.from_numpy(prompt.astype(
        np.int64))}, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    tf = teng.generate_fori({"tokens": torch.from_numpy(prompt.astype(
        np.int64))}, 6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jt))


def test_slice_and_merge_keep_the_engine_tensors():
    """A bucket's state is views of the full state: writes through them
    land in the engine's tensors, merging returns the full state itself,
    and a replaced leaf (an op that did not write in place) raises."""
    _, _, tcm, tp = _models()
    eng = Engine(tcm, tp, EngineConfig(**BASE))
    cache = eng.new_cache()
    full, axes = cache.state, cache.slot_axes
    (ukey, ust), = full.items()
    (skey, st), = ust.items()
    part = slice_state(full, axes, 2)
    pst = part[ukey][skey]
    assert pst["kp"] is st["kp"] and pst["len"].shape == (3, 2)
    pst["len"].add_(5)
    assert st["len"][:, :2].eq(5).all() and st["len"][:, 2:].eq(0).all()
    assert merge_state(full, part, axes, 2) is full
    pst["bt"] = torch.full_like(pst["bt"], 7)
    with pytest.raises(RuntimeError, match="in place"):
        merge_state(full, part, axes, 2)


@pytest.mark.parametrize("kw", [
    dict(chunk_size=0), dict(fori_seg=1), dict(chunk_buckets=(2, 4),
                                               chunk_size=4),
    dict(batch_buckets=(1, 2)), dict(prompt_buckets=(8, 128)),
    dict(block_size=12), dict(speculation="ngram:4", fori_seg=4),
    dict(speculation="bogus:2"),
])
def test_engine_config_rules_match_jax(kw):
    """The serving rules S301-S307 raise the JAX package's messages."""
    with pytest.raises(ValueError) as want:
        jengine.EngineConfig(**{**BASE, **kw})
    with pytest.raises(ValueError) as got:
        EngineConfig(**{**BASE, **kw})
    assert str(got.value) == str(want.value)


def test_serve_cli_replay_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--requests", "synthetic:3",
                "--max-batch", "2", "--max-seq-len", "48",
                "--block-size", "8", "--prompt-len", "12", "--steps", "4",
                "--prefix-cache", "--speculation", "ngram:2"])
    out = capsys.readouterr().out
    assert "serving[3 req]" in out and "speculation [ngram:2]" in out
    # --serving-autotune pins the searched flow and serves through it
    serve.main(["--smoke", "--device", "cpu", "--requests", "synthetic:2",
                "--max-batch", "2", "--max-seq-len", "32", "--steps", "2",
                "--prompt-len", "8", "--serving-autotune", "--validate",
                "compile"])
    out = capsys.readouterr().out
    assert "serving-autotune[llama3.2-1b x cli]" in out
    assert "serving[2 req]" in out
