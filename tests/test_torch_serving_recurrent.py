"""The serving engine over the RG-LRU hybrid: the port's ``Engine.run`` on
smoke recurrentgemma-2b (fp32, ``ShapeConfig("serve", "decode", 64, 4)``,
a 16-slot attention window) against the JAX package's, on the JAX
parameters carried across by ``repro_torch.bridge`` and the same requests
from numpy.

The recurrent conv and RG-LRU state is dense, one row per slot, copied in
at admission and written in place by each tick; the attention state is the
paged pool.  Prompts fill their bucket exactly (the engine refuses padded
prompts for such state).  Held to JAX: greedy tokens identical, captured
logits within 1e-4 (fp32, the same arithmetic summed in another order),
and the four refusals with JAX's messages.
"""
import functools

import jax
import numpy as np
import pytest

from repro import flow as jflow
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.serving import Engine, EngineConfig, Request

ARCH = "recurrentgemma-2b"
SHAPE = ("serve", "decode", 64, 4)
BASE = dict(max_batch=4, max_seq_len=64, block_size=8, prompt_buckets=(16,))
TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    jcm = jflow.compile(ARCH, JShapeConfig(*SHAPE),
                        JFlowConfig(mode="folded", precision="fp32"),
                        smoke=True)
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(ARCH, ShapeConfig(*SHAPE),
                        FlowConfig(mode="folded", precision="fp32"),
                        smoke=True, device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _requests(n=7, seed=3):
    """Prompts of exactly 16 tokens; 3-30 new tokens each, so requests end
    at different ticks, slots refill, and long ones run past the window."""
    rng = np.random.RandomState(seed)
    return [Request(f"r{i}", rng.randint(0, 256, 16).astype(np.int32),
                    max_new_tokens=int(rng.randint(3, 31))) for i in range(n)]


def _jax_requests(reqs):
    return [jsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                           r.stop_token) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_run(max_batch=4):
    jcm, jp, _, _ = _models()
    kw = dict(BASE, max_batch=max_batch, capture_logits=True)
    return jengine.Engine(jcm, jp, jengine.EngineConfig(**kw)).run(
        _jax_requests(_requests()))


def _port(reqs, **kw):
    _, _, tcm, tp = _models()
    eng = Engine(tcm, tp, EngineConfig(**{**BASE, **kw}))
    return eng, eng.run(reqs)


def _same(ref, got, logits=True):
    assert set(ref.by_id) == set(got.by_id)
    for rid, a in ref.by_id.items():
        b = got.by_id[rid]
        assert a.tokens == b.tokens, f"request {rid} diverged"
        if logits:
            assert len(a.logits) == len(b.logits) == len(a.tokens)
            for la, lb in zip(a.logits, b.logits):
                np.testing.assert_allclose(lb, np.asarray(la), rtol=0,
                                           atol=TOL)


@pytest.mark.parametrize("max_batch", [4, 2])
def test_port_run_matches_jax(max_batch):
    ref = _jax_run(max_batch)
    eng, got = _port(_requests(), max_batch=max_batch, capture_logits=True)
    _same(ref, got)
    m = got.metrics
    for k in ("decode_ticks", "prefill_batches", "admissions", "refills",
              "evictions", "host_syncs"):
        assert m[k] == ref.metrics[k], k
    assert m["refills"] >= 1
    cache = eng.last_cache
    # the dense state: per-slot conv and RG-LRU rows of the folded unit
    st = cache.state["fold_layer0"]
    assert tuple(st["conv0"].shape) == (2, max_batch, 3, 64)
    assert tuple(st["lru1"].shape) == (2, max_batch, 64)
    assert cache.dense_bytes() == 2 * 2 * max_batch * (3 * 64 + 64) * 4
    assert cache.pool_bytes() == 2 * 2 * cache.num_blocks * 8 * 1 * 32 * 4


def test_fori_segments_give_the_host_ticks_tokens():
    """Decode segments (``CompiledModel.decode_segment``) write the dense
    state in place as the host ticks do: JAX's tokens, fewer syncs."""
    ref = _jax_run()
    _, host = _port(_requests())
    _, seg = _port(_requests(), fori_seg=3)
    assert seg.metrics["fori_segments"] > 0
    assert seg.metrics["host_syncs"] < host.metrics["host_syncs"]
    _same(ref, seg, logits=False)


def _refusal(run):
    with pytest.raises(ValueError) as e:
        run()
    return str(e.value)


@pytest.mark.parametrize("case", ["padded_prompt", "prefix_cache",
                                  "chunked_prefill", "speculation"])
def test_recurrent_state_refusals_match_jax(case):
    """The four refusals of ``tests/test_serving.py``'s recurrent cases:
    a prompt that needs left-padding, the prefix cache, chunked prefill and
    speculation each raise JAX's ValueError with JAX's message; an exact
    prompt serves."""
    jcm, jp, tcm, tp = _models()
    kw = dict(BASE, prompt_buckets=(8, 16))
    reqs = [Request("padded", np.arange(1, 6, dtype=np.int32),
                    max_new_tokens=2)] if case == "padded_prompt" \
        else _requests(1)
    extra = {"padded_prompt": {}, "prefix_cache": dict(prefix_cache=True),
             "chunked_prefill": dict(chunked_prefill=True, chunk_size=4),
             "speculation": dict(speculation="ngram:4")}[case]
    want = _refusal(lambda: jengine.Engine(
        jcm, jp, jengine.EngineConfig(**kw, **extra)).run(
            _jax_requests(reqs)))
    got = _refusal(lambda: Engine(tcm, tp, EngineConfig(**kw, **extra)).run(
        reqs))
    assert got == want
    rep = Engine(tcm, tp, EngineConfig(**kw)).run(
        [Request("exact", np.arange(1, 9, dtype=np.int32), max_new_tokens=2)])
    assert rep.by_id["exact"].n_generated == 2


def test_serve_cli_replay_on_cpu(capsys):
    """The documented replay command serves the smoke hybrid model: the
    synthetic prompts all take ``--prompt-len`` tokens and that length is
    the one prompt bucket, so no prompt is padded."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "synthetic:4", "--max-batch", "2",
                "--max-seq-len", "48", "--block-size", "8",
                "--prompt-len", "16", "--steps", "4"])
    out = capsys.readouterr().out
    assert "serving[4 req]" in out and "prompt_buckets=[16, 48]" in out
    shown = [ln for ln in out.splitlines() if ln.startswith("  req")]
    assert len(shown) == 4
    assert all("prompt=16 -> " in ln and "(length" in ln for ln in shown)
