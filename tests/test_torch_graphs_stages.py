"""The LM prefill and the train step as graph functions
(``repro_torch.flow.graphs``), held on the CPU under the stand-in of
``torch_cpu_graphs.py``, which keeps ``StageGraphs``' contract: the first
call of a key runs the warm-up, a later one refills the static inputs and
runs the function again, its outputs copied out as a replay's.

* ``prefill`` on its graph function equals the eager prefill bit for bit
  (logits and every state tensor) and the JAX package's jitted ``prefill``
  within ``tests/test_kernels.py``'s fp32 bound: smoke llama3.2-1b (also a
  left-padded ``positions`` batch, the engine's), recurrentgemma-2b and
  whisper-small; a second prefill leaves the first one's state as it was;
  ``generate`` replays one decode graph over three calls;
* the train step's graph function (forward, ``autograd.grad``, AdamW)
  over 3 steps equals 3 eager steps bit for bit (losses, parameters,
  moments) and JAX's jitted ``train_step`` within
  ``test_torch_train_step.py``'s bounds: smoke llama3.2-1b, LeNet-5,
  recurrentgemma-2b, deepseek-moe-16b; ResNet-34 (train-mode BatchNorm)
  against the eager steps;
* AdamW's ``step`` is advanced in place; one graph a key, and another
  params tree, another optimizer state or a ``Trainer`` restore keys
  another; ``measure("train")`` and ``Trainer.fit`` reach the graph; a
  step whose capture always fails makes ``fit`` raise after
  ``max_restarts``; a model and its train step are freed without the
  collector; ``generate``'s held states are one a layout, and
  ``flow.clear_graphs()`` drops them;
* ``Engine.run`` on workload-A-style prompts (left-padded buckets) gives
  the eager run's greedy tokens.

Tolerances (``conftest.relerr``, max |diff| over max |ref|): graph against
eager equal; against JAX fp32 prefill < 2e-5 (``test_kernels._tol``), the
train step's loss < 1e-5 relative, its parameters and first moments
< 1e-4.
"""
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
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_cpu_graphs import cpu_graphs, stage_keys  # noqa: F401
from torch_train_parity import _batch, _leaf_errs, _models

SERVE = ("serve", "decode", 32, 2)
PREFILL_TOL = 2e-5
PROMPT = {"llama3.2-1b": 12, "recurrentgemma-2b": 8, "whisper-small": 6}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a.astype(np.float32))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _serve_models(arch):
    fl = dict(mode="folded", precision="fp32")
    jcm = jflow.compile(jget_smoke(arch), JShapeConfig(*SERVE),
                        JFlowConfig(**fl))
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(get_smoke(arch), ShapeConfig(*SERVE),
                        FlowConfig(**fl), device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _prompt(arch, seed, positions=False):
    cfg = get_smoke(arch)
    rng = np.random.RandomState(seed)
    S = PROMPT[arch]
    batch = {"tokens": rng.randint(0, 256, (2, S)).astype(np.int32)}
    if positions:
        # row 0 left-padded by 5 (its first 5 tokens pads at -1), row 1 full
        pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
        pos[0] -= 5
        batch["tokens"][0, :5] = 0
        batch["positions"] = pos
    if cfg.n_encoder_layers:
        batch["frames"] = rng.randn(2, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,positions", [
    ("llama3.2-1b", False), ("llama3.2-1b", True),
    ("recurrentgemma-2b", False), ("whisper-small", False)])
def test_prefill_graph_is_the_eager_prefill_and_jaxs(cpu_graphs, arch,
                                                     positions):
    """Two prompts of one shape through the prefill's graph function (a
    warm-up, then a replay): each equals the eager prefill bit for bit and
    JAX's jitted prefill; the second leaves the first's state as it was;
    one graph for both."""
    jcm, jp, cm, params = _serve_models(arch)
    outs = []
    for seed in (0, 1):
        b = _prompt(arch, seed, positions)
        tb = {k: _t(v) for k, v in b.items()}
        yg, sg, _ = cm.prefill(params, tb)
        with tflow.disable_graphs():
            ye, se, _ = cm.prefill(params, tb)
        assert torch.equal(yg, ye) and _same(sg, se), seed
        jy, js, _ = jcm.prefill(jp, {k: jnp.asarray(v) for k, v in b.items()})
        vocab = cm.cfg.vocab_size
        assert relerr(_np(yg)[..., :vocab], _np(jy)[..., :vocab]) \
            < PREFILL_TOL, seed
        assert max(_leaf_errs(js, sg)) < PREFILL_TOL, seed
        outs.append((yg, sg, _clone(sg)))
    (y0, s0, keep0), (y1, s1, _) = outs
    assert _same(s0, keep0)                    # untouched by the replay
    assert not any(a.data_ptr() == b.data_ptr() for a, b in
                   zip(tree_leaves(s0), tree_leaves(s1)))
    assert not torch.equal(y0, y1)
    assert [cm.stage_graphs.calls[k] for k in stage_keys(cm, "prefill")] \
        == [2]


def test_full_cache_prompt_state_owns_its_positions(cpu_graphs):
    """A prompt as long as the cache on unfolded layers (``base``): a
    layer's key positions are the batch's own (no pad, no stacking), so
    the first call's state would lie on the graph's static ``positions``
    buffer; it is copied out, and the next call's refill leaves it as it
    was."""
    cm = tflow.compile("llama3.2-1b", ShapeConfig("serve", "decode", 16, 2),
                       FlowConfig(mode="base", precision="fp32"),
                       smoke=True, device="cpu")
    params = cm.init_params(0)
    rng = np.random.RandomState(2)
    states = []
    for shift in (0, 3):
        pos = torch.arange(16, dtype=torch.int32).repeat(2, 1) - shift
        tok = torch.from_numpy(rng.randint(0, 256, (2, 16)))
        _, st, _ = cm.prefill(params, {"tokens": tok, "positions": pos})
        states.append((st, _clone(st), pos))
    st0, keep0, pos0 = states[0]
    assert _same(st0, keep0)
    kpos = [t for u in st0.values() for c in u.values()
            for k, t in c.items() if k == "pos"]
    assert kpos and all(torch.equal(t, pos0) for t in kpos)


def test_generate_replays_one_decode_graph(cpu_graphs):
    """Three ``generate`` calls in a row: one prefill graph, one decode
    graph (the model's held state), the eager tokens each time, and each
    call's final state its own."""
    cm = tflow.compile("llama3.2-1b", ShapeConfig(*SERVE),
                       FlowConfig(mode="folded", precision="fp32"),
                       smoke=True, device="cpu")
    params = cm.init_params(0)
    states = []
    for seed in (0, 1, 2):
        tok = _t(_prompt("llama3.2-1b", seed)["tokens"])
        tg, sg = cm.generate(params, {"tokens": tok}, steps=5)
        with tflow.disable_graphs():
            te, se = cm.generate(params, {"tokens": tok}, steps=5)
        assert torch.equal(tg, te) and _same(sg, se), seed
        states.append((sg, _clone(sg)))
    assert all(_same(a, b) for a, b in states)
    assert len(stage_keys(cm, "decode")) == 1
    assert len(stage_keys(cm, "prefill")) == 1
    assert cm.stage_graphs.calls[stage_keys(cm, "decode")[0]] == 3 * 4


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("llama3.2-1b", "lenet5", "recurrentgemma-2b",
               "deepseek-moe-16b")
TRAIN_STEPS = 3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _owned(params, st):
    return tree_leaves(params) + tree_leaves(st.mu) + tree_leaves(st.nu) \
        + [st.step]


def _graph_and_eager_steps(tcm, tp, tb):
    """3 steps on the train step's graph function and 3 eager, each from
    a copy of ``tp``: every parameter and optimizer tensor written in
    place; the losses, parameters and moments bit for bit.  Returns the
    graph run's (losses, params, optimizer state)."""
    topt = AdamW(**TRAIN_OPT)
    runs = {}
    for way in ("graph", "eager"):
        params = _clone(tp)
        st = topt.init(params)
        step = tcm.train_step(topt)
        ptrs = [t.data_ptr() for t in _owned(params, st)]
        losses = []
        for _ in range(TRAIN_STEPS):
            if way == "graph":
                params, st, m = step(params, st, tb)
            else:
                with tflow.disable_graphs():
                    params, st, m = step(params, st, tb)
            losses.append(m["loss"])
        assert [t.data_ptr() for t in _owned(params, st)] == ptrs
        runs[way] = (losses, params, st)
    (lg, pg, sg), (le, pe, se) = runs["graph"], runs["eager"]
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert _same(pg, pe) and _same(sg.mu, se.mu) and _same(sg.nu, se.nu)
    assert int(sg.step) == TRAIN_STEPS
    keys = stage_keys(tcm, "train_step[mb=1]")
    assert [tcm.stage_graphs.calls[k] for k in keys] == [TRAIN_STEPS]
    return runs["graph"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_graph_is_the_eager_step_and_jaxs(cpu_graphs, arch):
    """3 steps of the train step's graph function from one init and batch
    against 3 eager steps bit for bit, and against JAX's jitted, donated
    ``train_step``."""
    jcm, jp, tcm, tp = _models(arch)
    jb, tb = _batch(jcm.cfg)
    lg, pg, sg = _graph_and_eager_steps(tcm, tp, tb)
    jopt = JAdamW(**TRAIN_OPT)
    jstep = jcm.train_step(jopt)
    js = jopt.init(jp)
    for i in range(TRAIN_STEPS):
        jp, js, jm = jstep(jp, js, jb)
        assert abs(float(lg[i]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"])), i
    assert max(_leaf_errs(js.mu, sg.mu)) < 1e-4
    assert max(_leaf_errs(jp, pg)) < 1e-4


def test_train_step_graph_with_batchnorm(cpu_graphs):
    """ResNet-34's train-mode BatchNorm (the batch's statistics, its
    running mean and variance leaves) on the step's graph function: the
    eager steps bit for bit."""
    tcm = tflow.compile("resnet34", ShapeConfig("smoke", "train", 16, 2),
                        FlowConfig(mode="folded", precision="fp32"),
                        smoke=True, device="cpu")
    tp = tcm.init_params(0)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in
          tcm._measure_inputs(0).items()}
    losses, _, _ = _graph_and_eager_steps(tcm, tp, tb)
    assert all(torch.isfinite(x) for x in losses)


def test_adamw_step_stays_the_same_tensor():
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    opt = AdamW(lr=1e-2, warmup_steps=0)
    st = opt.init(params)
    t0 = st.step
    grads = {"w": torch.full((3, 2), 0.5), "b": torch.ones(2)}
    for i in range(3):
        params, st, m = opt.update(grads, st, params)
        assert st.step is t0 and int(t0) == i + 1
        assert st.step.dtype == torch.int32
    # the last update's lr: the schedule at the count before it
    assert float(m["lr"]) == float(opt.schedule(torch.tensor(2)))


def _smoke_train(arch="llama3.2-1b"):
    return tflow.compile(arch, ShapeConfig("smoke", "train", 16, 2),
                         FlowConfig(mode="folded"), smoke=True, device="cpu")


def test_one_train_graph_per_key(cpu_graphs):
    """Steps on one (params, state) share a graph; another params tree,
    another optimizer state, another optimizer and another batch shape
    each key their own; ``measure("train")`` runs on the graph."""
    cm = _smoke_train()
    opt = AdamW(lr=1e-3)
    V = cm.cfg.vocab_size
    rng = np.random.RandomState(0)

    def batch(B=2):
        return {"tokens": torch.from_numpy(rng.randint(0, V, (B, 16))),
                "labels": torch.from_numpy(rng.randint(0, V, (B, 16)))}
    p1, p2 = cm.init_params(0), cm.init_params(1)
    s1 = opt.init(p1)
    step = cm.train_step(opt)
    for _ in range(3):
        step(p1, s1, batch())
    name = "train_step[mb=1]"
    assert [cm.stage_graphs.calls[k] for k in stage_keys(cm, name)] == [3]
    step(p2, opt.init(p2), batch())                    # params
    step(p1, opt.init(p1), batch())                    # optimizer state
    cm.train_step(AdamW(lr=2e-3))(p1, s1, batch())     # optimizer
    step(p1, s1, batch(4))                             # batch shape
    assert len(stage_keys(cm, name)) == 5
    assert cm.train_step(AdamW(lr=1e-3)) is step       # by value
    rec = cm.measure("train", iters=2, params=p1)
    assert len(stage_keys(cm, name)) == 6
    assert cm.stage_graphs.calls[stage_keys(cm, name)[-1]] == 3
    assert rec["iters"] == 2


def test_trainer_fit_restore_keys_a_new_graph(cpu_graphs, tmp_path):
    """``Trainer.fit`` steps on the compiled model's graph; an injected
    failure restores the last checkpoint into new tensors, which key a
    new graph (the old one is never replayed over them); the losses are
    the eager run's."""
    hist = {}
    for way in ("graph", "eager"):
        cm = _smoke_train()
        data = SyntheticLM(DataConfig(vocab_size=cm.cfg.vocab_size,
                                      seq_len=16, global_batch=2))
        tr = Trainer(cm, AdamW(lr=1e-3),
                     TrainerConfig(steps=8, ckpt_dir=str(tmp_path / way),
                                   ckpt_every=3, fail_at_step=5,
                                   log_every=1))
        assert tr.model is cm
        if way == "graph":
            _, st, hist[way] = tr.fit(data, 0)
            keys = stage_keys(cm, "train_step[mb=1]")
            assert [cm.stage_graphs.calls[k] for k in keys] == [5, 5]
        else:
            with tflow.disable_graphs():
                _, st, hist[way] = tr.fit(data, 0)
            assert cm._graphs is None
        assert tr._restarts == 1 and int(st.step) == 8
        assert ckpt_lib.latest_step(str(tmp_path / way)) == 6
    assert hist["graph"] == hist["eager"]


def test_trainer_from_a_plan_makes_its_model(cpu_graphs):
    plan = _smoke_train("lenet5").plan
    tr = Trainer(plan, AdamW(), TrainerConfig(steps=1))
    assert tr.model.plan is plan and tr.model.device.type == "cpu"
    assert tr.compile_step() is tr.model.train_step(AdamW(), 1)


def test_trainer_fit_raises_when_every_capture_fails(cpu_graphs, monkeypatch,
                                                    tmp_path):
    """A step that fails at every call (its capture raising) restores the
    checkpoint ``max_restarts`` times and then raises, instead of
    restoring for ever."""
    from torch_cpu_graphs import CpuGraphs
    tries = []

    def failing(self, key, inputs, fn, **kw):
        tries.append(key)
        raise RuntimeError("capture failed")
    monkeypatch.setattr(CpuGraphs, "run", failing)
    cm = _smoke_train()
    data = SyntheticLM(DataConfig(vocab_size=cm.cfg.vocab_size, seq_len=16,
                                  global_batch=2))
    tr = Trainer(cm, AdamW(lr=1e-3),
                 TrainerConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=1,
                               max_restarts=2))
    with pytest.raises(RuntimeError, match="capture failed"):
        tr.fit(data, 0)
    assert len(tries) == 3 and tr._restarts == 3


def test_model_with_a_train_step_is_freed_without_the_collector(cpu_graphs):
    """The model does not hold its train steps: a step kept alone keeps its
    model, and once both are dropped the model (and its graphs' pool) is
    freed at once, with the collector off (no reference cycle)."""
    import gc
    import weakref
    cm = _smoke_train()
    opt = AdamW(lr=1e-3)
    params = cm.init_params(0)
    V = cm.cfg.vocab_size
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(0, V, (2, 16))),
             "labels": torch.from_numpy(rng.randint(0, V, (2, 16)))}
    step = cm.train_step(opt)
    step(params, opt.init(params), batch)
    assert cm.train_step(opt) is step
    alive = weakref.ref(cm)
    gc.collect()
    gc.disable()
    try:
        del cm
        assert alive() is not None
        del step
        assert alive() is None
    finally:
        gc.enable()


def test_held_states_and_clear_graphs():
    """``StageGraphs.held``: one tree a layout, the argument copied in, its
    bytes counted; ``flow.clear_graphs()`` drops them."""
    from repro_torch.flow import graphs
    sg = graphs.StageGraphs(torch.device("cpu"))
    a = {"k": torch.ones(2, 3), "v": [torch.zeros(4)]}
    h = sg.held(a)
    assert torch.equal(h["k"], a["k"]) and h["k"] is not a["k"]
    b = {"k": torch.full((2, 3), 2.0), "v": [torch.ones(4)]}
    assert sg.held(b) is h and torch.equal(h["v"][0], b["v"][0])
    c = sg.held({"k": torch.ones(3, 3), "v": [torch.zeros(4)]})
    assert c is not h
    assert sg.stats["held_bytes"] == (6 + 4 + 9 + 4) * 4
    tflow.clear_graphs()
    assert sg.stats["held_bytes"] == 0
    assert sg.held(a) is not h


# ---------------------------------------------------------------------------
# the engine's bucketed prefill
# ---------------------------------------------------------------------------

def test_engine_run_prefills_on_graphs(cpu_graphs):
    """Workload-A-style prompts of 3-20 tokens into 2 slots with prompt
    buckets (8, 16, 24): left-padded prefill batches on one graph a
    (batch bucket, prompt bucket); the greedy tokens are the eager
    run's."""
    cm = tflow.compile("llama3.2-1b", ShapeConfig("serve", "decode", 48, 2),
                       FlowConfig(mode="folded", precision="fp32"),
                       smoke=True, device="cpu")
    params = cm.init_params(0)
    rng = np.random.RandomState(4)
    reqs = [Request(f"r{i}", rng.randint(0, 256, n).astype(np.int32), 6)
            for i, n in enumerate((3, 20, 9, 14, 5, 17))]
    ecfg = EngineConfig(max_batch=2, max_seq_len=48, block_size=8,
                        prompt_buckets=(8, 16, 24))
    got = {}
    for way in ("graph", "eager"):
        eng = Engine(cm, params, ecfg)
        if way == "graph":
            rep = eng.run(reqs)
        else:
            with tflow.disable_graphs():
                rep = eng.run(reqs)
        got[way] = {r.rid: list(r.tokens) for r in rep.results}
    assert got["graph"] == got["eager"]
    keys = stage_keys(cm, "prefill")
    assert len(keys) >= 2
    assert all(dict(k[1])["positions"][0][1] in (8, 16, 24) for k in keys)
    assert sum(cm.stage_graphs.calls[k] for k in keys) > len(keys)
