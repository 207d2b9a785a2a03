"""The port's stages on captured CUDA graphs (``repro_torch.flow.graphs``),
as far as the CPU can hold them: no CUDA graph is captured here, so these
tests hold what a graph relies on.

* ``decode`` with a 0-d int32 tensor ``cache_index`` (a graph's static
  index) equals its ``int`` form bit for bit, and the JAX package's jitted
  decode given a ``jnp.int32`` index on the same (bridged) weights: smoke
  llama3.2-1b, smoke recurrentgemma-2b across the wrap of its 16-slot
  window, smoke whisper-small; the sinusoid positions of ``op_embed``
  against JAX's op;
* the kernel counters' snapshot / delta / add / reset helpers
  (``kernels/registry.py``) on synthetic counts;
* ``disable_graphs()`` nests and restores; a CPU model builds no graph;
* the stages' graph functions (static inputs, keys, the in-place state
  check, the generate_fori loop on device indices, the segment) run
  eagerly under a stand-in for ``StageGraphs`` that keeps its contract on
  the CPU (``torch_cpu_graphs.py``): the first call of a key runs the
  warm-up, a later one refills the static inputs and runs the function
  again, as a replay would;
* decode_attention's ticket buffer outlives its growth.

Tolerances (``conftest.relerr``, max |diff| over max |ref|): against JAX
fp32 < 1e-5, bf16 < 5e-2 (the LM tests' bound); the int and tensor forms
and the graph functions against the eager stages: equal.
"""
import types

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
from repro.core import ops_impl as jops
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import ops_impl as tops
from repro_torch.flow import graphs
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import registry
from torch_cpu_graphs import cpu_graphs, stage_keys  # noqa: F401

SHAPE = ("serve", "decode", 32, 2)
TOL = {"fp32": 1e-5, "bf16": 5e-2}
# arch -> (prompt length, decode steps): recurrentgemma's 8 + 12 positions
# wrap its 16-slot window
RUNS = {"llama3.2-1b": (12, 4), "recurrentgemma-2b": (8, 12),
        "whisper-small": (6, 4)}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a.astype(np.float32))


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.clone()


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _inputs(arch, seed=0):
    prompt, steps = RUNS[arch]
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, 256, (2, prompt)).astype(np.int32)}
    nxt = rng.randint(0, 256, (2, steps)).astype(np.int32)
    cfg = get_smoke(arch)
    if cfg.n_encoder_layers:
        batch["frames"] = rng.randn(2, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch, nxt


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", sorted(RUNS))
def test_tensor_cache_index_is_the_int_form_and_jaxs(arch, prec):
    """Teacher-forced decode steps with ``cache_index`` a 0-d int32 tensor
    and an int: logits and state equal bit for bit; both against JAX's
    jitted decode at ``jnp.int32(i)``."""
    fl = dict(mode="folded", precision=prec)
    jcm = jflow.compile(jget_smoke(arch), JShapeConfig(*SHAPE),
                        JFlowConfig(**fl))
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(get_smoke(arch), ShapeConfig(*SHAPE),
                        FlowConfig(**fl), device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch, nxt = _inputs(arch)
    prompt = batch["tokens"].shape[1]
    _, jst, _ = jcm.prefill(jp, {k: jnp.asarray(v)
                                 for k, v in batch.items()})
    _, st, _ = tcm.prefill(tp, {k: _t(v) for k, v in batch.items()})
    st_i = _clone(st)
    for i in range(nxt.shape[1]):
        tok = nxt[:, i:i + 1]
        jl, jst, _ = jcm.decode(jp, {"tokens": jnp.asarray(tok)}, jst,
                                jnp.int32(prompt + i))
        tl, st, _ = tcm.decode(tp, {"tokens": _t(tok)}, st, torch.tensor(
            prompt + i, dtype=torch.int32))
        il, st_i, _ = tcm.decode(tp, {"tokens": _t(tok)}, st_i, prompt + i)
        assert torch.equal(tl, il), i
        assert relerr(_np(tl), _np(jl)) < TOL[prec], i
    assert all(torch.equal(a, b) for a, b in zip(_leaves(st),
                                                 _leaves(st_i)))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_sinusoid_positions_at_a_tensor_index(prec):
    """``op_embed``'s sinusoid positions in decode (smoke whisper-small's
    plans and widths): an int32 tensor index, its int form and JAX's op at
    ``jnp.int32`` agree."""
    fl = dict(mode="folded", precision=prec)
    jplan = jflow.compile(jget_smoke("whisper-small"), JShapeConfig(*SHAPE),
                          JFlowConfig(**fl)).plan
    tplan = tflow.compile(get_smoke("whisper-small"), ShapeConfig(*SHAPE),
                          FlowConfig(**fl), device="cpu").plan
    rng = np.random.RandomState(3)
    table = rng.randn(256, 64).astype(np.float32)
    tok = rng.randint(0, 256, (2, 1)).astype(np.int32)
    op = types.SimpleNamespace(attrs={"sinusoid_pos": True})
    jy = jops.op_embed(jops.Ctx(mode="decode", plan=jplan,
                                cache_index=jnp.int32(21)), op,
                       {"table": jnp.asarray(table)}, jnp.asarray(tok))
    ys = [tops.op_embed(tops.Ctx(mode="decode", plan=tplan, cache_index=ci),
                        op, {"table": torch.from_numpy(table)}, _t(tok))
          for ci in (21, torch.tensor(21, dtype=torch.int32))]
    assert torch.equal(ys[0], ys[1])
    assert relerr(_np(ys[1]), _np(jy)) < TOL[prec]


def test_decode_positions_int_and_tensor():
    want = torch.full((3, 2), 7, dtype=torch.int32)
    for ci in (7, torch.tensor(7), torch.tensor(7, dtype=torch.int32)):
        got = tops.decode_positions(ci, 3, 2, torch.device("cpu"))
        assert got.dtype == torch.int32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernel counters
# ---------------------------------------------------------------------------

@pytest.fixture
def saved_counts():
    """The wrappers' counters as they were, restored after the test."""
    keep = registry.snapshot_counts()
    yield
    fns = registry.kernel_wrappers()
    for (name, attr), v in keep.items():
        if name == "dispatch":
            registry.DISPATCH_REJECTIONS.clear()
            registry.DISPATCH_REJECTIONS.update(v)
        else:
            setattr(fns[name], attr, dict(v) if isinstance(v, dict) else v)


def test_counters_cover_every_wrapper(saved_counts):
    snap = registry.snapshot_counts()
    names = {n for n, _ in snap}
    assert names == {"conv2d_fused", "matmul_fused", "flash_attention",
                     "decode_attention", "paged_decode_attention",
                     "copy_block", "lru_scan", "dispatch"}
    attrs = {a for n, a in snap if n != "dispatch"}
    assert attrs == set(registry.COUNTER_ATTRS)
    assert ("matmul_fused", "base_schedule_launches") in snap
    assert ("lru_scan", "shapes") in snap
    assert ("copy_block", "schedules") not in snap


def test_counter_snapshot_delta_add_reset(saved_counts):
    """A synthetic capture: the counts it moved, taken back (``times=-1``)
    and added once a replay; a tile or shape key at 0 goes; a reset keeps
    the schedule keys at 0, empties the tiles and shapes and leaves the
    dispatch rejections to their readers."""
    from repro_torch.kernels import lru_scan as kl
    from repro_torch.kernels import matmul_fused as km
    registry.reset_counts()
    registry.DISPATCH_REJECTIONS.clear()
    before = registry.snapshot_counts()
    km.matmul_fused.launches += 3
    km.matmul_fused.schedule_launches["small_m"] += 3
    km.matmul_fused.tiles[("wgmma", (128, 64))] = 2
    kl.lru_scan.shapes[(1, 8, 64, "float32")] = 1
    kd.decode_attention.schedules["mma"] += 1
    registry.DISPATCH_REJECTIONS[("conv2d", "groups")] = 13
    delta = registry.count_delta(before, registry.snapshot_counts())
    assert delta == {
        ("matmul_fused", "launches"): 3,
        ("matmul_fused", "schedule_launches"): {"small_m": 3},
        ("matmul_fused", "tiles"): {("wgmma", (128, 64)): 2},
        ("lru_scan", "shapes"): {(1, 8, 64, "float32"): 1},
        ("decode_attention", "schedules"): {"mma": 1},
        ("dispatch", "rejections"): {("conv2d", "groups"): 13}}
    registry.add_counts(delta, -1)
    assert registry.snapshot_counts() == before
    assert km.matmul_fused.tiles == {} and kl.lru_scan.shapes == {}
    assert registry.DISPATCH_REJECTIONS == {}
    assert km.matmul_fused.schedule_launches["small_m"] == 0
    for _ in range(4):
        registry.add_counts(delta)
    assert km.matmul_fused.launches == 12
    assert km.matmul_fused.tiles == {("wgmma", (128, 64)): 8}
    assert kd.decode_attention.schedules["mma"] == 4
    assert registry.count_delta(before, registry.snapshot_counts()) == {
        k: ({kk: 4 * n for kk, n in v.items()} if isinstance(v, dict)
            else 4 * v) for k, v in delta.items()}
    registry.reset_counts()
    assert registry.DISPATCH_REJECTIONS == {("conv2d", "groups"): 52}
    registry.DISPATCH_REJECTIONS.clear()
    assert registry.snapshot_counts() == before
    assert set(km.matmul_fused.schedule_launches) == set(km.SCHEDULES)


# ---------------------------------------------------------------------------
# the graph runner's switches and the stages' graph functions
# ---------------------------------------------------------------------------

def test_disable_graphs_nests_and_restores():
    assert graphs.graphs_enabled()
    with tflow.disable_graphs():
        assert not graphs.graphs_enabled()
        with graphs.disable_graphs():
            assert not graphs.graphs_enabled()
        assert not graphs.graphs_enabled()
    assert graphs.graphs_enabled()
    with pytest.raises(KeyError):
        with tflow.disable_graphs():
            raise KeyError("inside")
    assert graphs.graphs_enabled()
    assert not graphs.capturing(torch.device("cpu"))


def _smoke(arch="llama3.2-1b", shape=SHAPE, prec="fp32"):
    cm = tflow.compile(arch, ShapeConfig(*shape),
                       FlowConfig(mode="folded", precision=prec),
                       smoke=True, device="cpu")
    return cm, cm.init_params(0)


def test_cpu_model_builds_no_graph(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU model built a graph")
    monkeypatch.setattr(graphs.StageGraphs, "__init__", refuse)
    cm, params = _smoke()
    batch, nxt = _inputs("llama3.2-1b")
    tok = _t(batch["tokens"])
    _, st, _ = cm.prefill(params, {"tokens": tok})
    cm.decode(params, {"tokens": _t(nxt[:, :1])}, st, 12)
    cm.generate_fori(params, {"tokens": tok}, 3)
    seg = cm.decode_segment(2, temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    z = torch.zeros(2, dtype=torch.int32)
    seg(params, cm.init_state(2), z, z + 12, gen)
    cnn = tflow.compile("lenet5", ShapeConfig("serve", "prefill", 32, 2),
                        smoke=True, device="cpu")
    cnn.prefill(cnn.init_params(0), {"images": torch.zeros(2, 32, 32, 1)})
    assert cm._graphs is None and cnn._graphs is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_graph_functions_are_the_eager_stages(cpu_graphs, arch):
    """decode (one key for the whole loop, replays on the static tensor
    index), generate_fori (the loop on device indices over the copied
    prefill state) and a sampled segment give the eager stages' results
    bit for bit; another params tree keys another graph."""
    cm, params = _smoke(arch)
    batch, nxt = _inputs(arch)
    prompt = batch["tokens"].shape[1]
    tok = _t(batch["tokens"])
    _, st, _ = cm.prefill(params, {"tokens": tok})
    st_e = _clone(st)
    for i in range(nxt.shape[1]):
        step = {"tokens": _t(nxt[:, i:i + 1])}
        yg, st2, _ = cm.decode(params, step, st, prompt + i)
        assert st2 is st
        with tflow.disable_graphs():
            ye, _, _ = cm.decode(params, step, st_e, prompt + i)
        assert torch.equal(yg, ye), i
    assert all(torch.equal(a, b) for a, b in zip(_leaves(st), _leaves(st_e)))
    keys = cm.stage_graphs.calls
    assert [keys[k] for k in stage_keys(cm, "decode")] == [nxt.shape[1]]
    fg = cm.generate_fori(params, {"tokens": tok}, 6)
    fg2 = cm.generate_fori(params, {"tokens": tok}, 6)
    with tflow.disable_graphs():
        fe = cm.generate_fori(params, {"tokens": tok}, 6)
    want, _ = cm.generate(params, {"tokens": tok}, steps=6)
    assert torch.equal(fg, fe) and torch.equal(fg2, fe)
    assert torch.equal(fe, want)
    p2 = cm.init_params(1)
    _, s2, _ = cm.prefill(p2, {"tokens": tok})
    cm.decode(p2, {"tokens": _t(nxt[:, :1])}, s2, prompt)
    # decode on st, on generate's state and on p2's; generate_fori once;
    # the prefill once a params tree
    assert [len(stage_keys(cm, k)) for k in (
        "decode", "generate_fori", "prefill")] == [3, 1, 2]
    assert len(keys) == 6
    seg = cm.decode_segment(3, temperature=1.0)
    out = {}
    for way in ("graph", "eager"):
        gen = torch.Generator().manual_seed(5)
        state = cm.init_state(2)
        cur, pos = tok[:, -1].to(torch.int32), torch.full(
            (2,), prompt, dtype=torch.int32)
        runs = []
        for _ in range(2):
            if way == "graph":
                t, _, _ = seg(params, state, cur, pos, gen)
            else:
                with tflow.disable_graphs():
                    t, _, _ = seg(params, state, cur, pos, gen)
            runs.append(t)
            cur, pos = t[:, -1].contiguous(), pos + 3
        out[way] = torch.cat(runs, 1)
    assert torch.equal(out["graph"], out["eager"])


def test_cnn_prefill_graph_function(cpu_graphs):
    cnn = tflow.compile("lenet5", ShapeConfig("serve", "prefill", 32, 2),
                        smoke=True, device="cpu")
    params = cnn.init_params(0)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 32, 32, 1).astype(np.float32))
    ys = [cnn.prefill(params, {"images": x * s})[0] for s in (1.0, 2.0)]
    with tflow.disable_graphs():
        ws = [cnn.prefill(params, {"images": x * s})[0] for s in (1.0, 2.0)]
    assert all(torch.equal(y, w) for y, w in zip(ys, ws))
    assert list(cnn.stage_graphs.calls.values()) == [2]


def test_a_state_replaced_by_the_stage_raises(cpu_graphs, monkeypatch):
    """A graph replays the writes into the state tensors it captured: a
    decode that hands back another tensor cannot go on a graph."""
    cm, params = _smoke()
    batch, nxt = _inputs("llama3.2-1b")
    _, st, _ = cm.prefill(params, {"tokens": _t(batch["tokens"])})
    apply = cm.apply

    def replacing(*a, **k):
        lg, state, aux = apply(*a, **k)
        unit = next(iter(state))
        state[unit] = _clone(state[unit])
        return lg, state, aux
    monkeypatch.setattr(tflow.CompiledModel, "apply", property(
        lambda self: replacing))
    with pytest.raises(RuntimeError, match="in place"):
        cm.decode(params, {"tokens": _t(nxt[:, :1])}, st, 12)


def test_routing_hook_refuses_a_graph(monkeypatch):
    monkeypatch.setattr(tops, "ROUTING_HOOK", lambda *a: None)
    cm, _ = _smoke()
    cm.device = torch.device("cuda")            # only asked, never used
    monkeypatch.setattr(graphs, "capturing", lambda device: False)
    with pytest.raises(RuntimeError, match="disable_graphs"):
        cm._on_graphs()
    with tflow.disable_graphs():
        assert not cm._on_graphs()


def test_ticket_buffer_outlives_its_growth():
    dev = torch.device("cpu")
    keep = dict(kd._TICKETS), list(kd._RETIRED_TICKETS)
    try:
        kd._TICKETS.pop(dev, None)
        small = kd._tickets(dev, 8)
        assert kd._tickets(dev, 8) is small
        big = kd._tickets(dev, small.numel() + 1)
        assert big is not small and big.numel() > small.numel()
        assert any(t is small for t in kd._RETIRED_TICKETS)
    finally:
        kd._TICKETS.clear()
        kd._TICKETS.update(keep[0])
        kd._RETIRED_TICKETS[:] = keep[1]
