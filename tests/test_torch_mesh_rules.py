"""The port's sharding rules against the JAX package's recorded decisions,
in one process (the rules work on a ``MeshSpec``, no ranks): every
parameter's DTensor placements are the translation of the JAX plan's
``plan.sharding.param_specs``, and ``describe()`` matches the JAX plan's
line for line, the ``kernels:`` line aside; the state's placements; and
on a one-rank mesh (a gloo group of this process) the entry points
against the unsharded ones (four ranks: ``tests/test_torch_mesh.py``)."""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.plan import _build_plan as jbuild_plan
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch import flow as tflow
from repro_torch.core.lowering import state_shardings
from repro_torch.core.plan import _build_plan
from repro_torch.distributed.meshspec import MeshSpec
from repro_torch.distributed.sharding import (P, NamedSharding,
                                              ShardingRules, placements_of)
from repro_torch.flow import _rules_for
from repro_torch.launch.mesh import MULTI_POD_SPEC, PRODUCTION_SPEC

ARCHS = ("llama3.2-1b", "mixtral-8x7b", "deepseek-moe-16b", "resnet34")
MESHES = ((("data", 2), ("model", 2)),
          (("pod", 2), ("data", 2), ("model", 2)))
SHAPE = ("s", "train", 16, 4)


def _plans(arch, split):
    kw = dict(mode="folded", mesh_split=split)
    jplan = jbuild_plan(jget_smoke(arch), JFlowConfig(**kw),
                        JShapeConfig(*SHAPE))
    tplan = _build_plan(get_smoke(arch), FlowConfig(**kw),
                        ShapeConfig(*SHAPE))
    return jplan, tplan


@pytest.mark.parametrize("split", MESHES,
                         ids=lambda s: ",".join(f"{a}:{n}" for a, n in s))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_translate_jax_specs(arch, split):
    jplan, tplan = _plans(arch, split)
    spec = MeshSpec(split)
    rules = _rules_for(spec, tplan.flow)
    shd = rules.params_shardings(tplan)
    jspecs = jplan.sharding.param_specs
    flat = {f"{t}/{k}": s for t, leaves in shd.items()
            for k, s in leaves.items()}
    assert set(flat) == set(jspecs)
    for key, js in jspecs.items():
        entries = tuple(js)
        want = []
        for name in spec.names:
            hit = [i for i, e in enumerate(entries)
                   if e == name or (isinstance(e, tuple) and name in e)]
            want.append(Shard(hit[0]) if hit else Replicate())
        assert tuple(flat[key].spec) == entries, key
        assert flat[key].placements == tuple(want), key
    # the solver's own placements agree where the plan recorded them
    from repro_torch.core.lowering import param_specs_tree
    for top, leaves in param_specs_tree(tplan).items():
        for leaf, (ps, stacked) in leaves.items():
            if stacked:
                continue
            assert rules.param_placements(ps, ps.shape, False) == \
                flat[f"{top}/{leaf}"].placements, (top, leaf)


@pytest.mark.parametrize("split", MESHES,
                         ids=lambda s: ",".join(f"{a}:{n}" for a, n in s))
@pytest.mark.parametrize("arch", ARCHS)
def test_describe_matches_jax_on_a_mesh(arch, split):
    jplan, tplan = _plans(arch, split)

    def lines(plan):
        return [ln for ln in plan.describe().splitlines()
                if not ln.startswith("  kernels:")]
    assert lines(tplan) == lines(jplan)
    if split == MESHES[0]:
        assert "sharding: mesh={data:2,model:2} dp=data:2 tp=model:2" in \
            tplan.describe()


def test_placements_of_tuple_entries_and_order():
    names = ("pod", "data", "model")
    assert placements_of(P(("pod", "data"), "model"), names) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements_of(P(None, None), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        placements_of(P(("data", "pod")), names)
    ns = NamedSharding(MeshSpec((("data", 4), ("model", 1))),
                       P(None, "data"))
    assert ns.placements == (Shard(1), Replicate())


def test_rules_sizes_and_act_specs():
    r = ShardingRules(MeshSpec((("pod", 2), ("data", 2), ("model", 2))),
                      dp=("pod", "data"), tp="model")
    assert (r.dp_size, r.tp_size) == (4, 2)
    assert r.act_pspec(("batch", "seq_cp", "none", "none"),
                       (8, 16, 4, 8)) == P(("pod", "data"), "model", None,
                                           None)
    assert r.act_pspec(("batch", "kv_len"), (6, 16)) == P(None, "model")
    bs = r.batch_sharding({"tokens": _Shaped((8, 16)),
                           "odd": _Shaped((6, 16))})
    assert bs["tokens"].spec == P(("pod", "data"))
    assert bs["odd"].spec == P(None)


class _Shaped:
    def __init__(self, shape):
        self.shape = shape


def test_production_specs():
    assert PRODUCTION_SPEC.names == ("data", "model")
    assert PRODUCTION_SPEC.size == 256
    assert MULTI_POD_SPEC.names == ("pod", "data", "model")
    assert MULTI_POD_SPEC.size == 512


def test_state_sharding_by_leaf_shapes():
    """``ShardingRules.state_sharding`` is the role-driven tree of
    ``state_shardings``, leaf by leaf: each cache leaf's batch over dp
    where dp divides it (else whole), its length over tp."""
    _, tplan = _plans("llama3.2-1b", MESHES[0])
    r = _rules_for(MeshSpec(MESHES[0]), tplan.flow)
    for B, dp in ((4, "data"), (3, None)):
        sh = r.state_sharding(tplan, B)
        want = state_shardings(tplan, B, r)
        kv = sh["fold_layer0"]["kv0"]
        assert {k: v.spec for k, v in kv.items()} == \
            {k: v.spec for k, v in want["fold_layer0"]["kv0"].items()}
        assert kv["k"].spec == P(None, dp, "model", None, None)
        assert kv["pos"].spec == P(None, dp, "model")


def test_state_placements_follow_the_roles():
    """KV caches: the batch over dp, the length over tp; a folded unit's
    leading layers dim whole."""
    _, tplan = _plans("llama3.2-1b", MESHES[0])
    rules = _rules_for(MeshSpec(MESHES[0]), tplan.flow)
    st = state_shardings(tplan, 4, rules)
    kv = st["fold_layer0"]["kv0"]
    assert kv["k"].spec == P(None, "data", "model", None, None)
    assert kv["pos"].spec == P(None, "data", "model")
    assert kv["k"].placements == (Shard(1), Shard(2))


def _one_rank(arch, kind, **kw):
    fl = FlowConfig(mode="folded", precision="fp32")
    shape = ShapeConfig("s", kind, 16, 4)
    cm0 = tflow.compile(arch, shape, fl, smoke=True, device="cpu")
    cm = tflow.compile(arch, shape, fl, smoke=True, device="cpu",
                       mesh={"data": 1, "model": 1}, **kw)
    return cm0, cm


def test_one_rank_mesh_entry_points_match_unsharded():
    """prefill / decode / generate on a one-rank mesh: DTensor weights,
    logits and state, the unsharded numbers bit for bit."""
    from repro_torch.distributed.sharding import full_tensor
    cm0, cm = _one_rank("llama3.2-1b", "decode")
    assert cm.mesh is not None and cm.rules is cm.plan.rules
    p0, p = cm0.init_params(0), cm.init_params(0)
    assert isinstance(p["embed"]["table"], DTensor)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 8)))
    y0, s0, _ = cm0.prefill(p0, {"tokens": tok})
    y1, s1, _ = cm.prefill(p, {"tokens": tok})
    assert isinstance(y1, DTensor) and torch.equal(full_tensor(y1), y0)
    assert isinstance(s1["fold_layer0"]["kv0"]["k"], DTensor)
    nxt = {"tokens": tok[:, :1]}
    d0, _, _ = cm0.decode(p0, nxt, s0, 8)
    d1, s1b, _ = cm.decode(p, nxt, s1, 8)
    assert s1b is s1 and torch.equal(full_tensor(d1), d0)
    assert torch.equal(cm.generate(p, {"tokens": tok}, 4)[0],
                       cm0.generate(p0, {"tokens": tok}, 4)[0])
    rec = cm.measure("decode", iters=1)
    assert rec["measured_step_s"] > 0


def test_one_rank_pipeline_matches_unsharded():
    """GPipe on a one-stage pod axis (``{"pod": 1, "data": 1}``, two
    microbatches): the loss and gradients of the unsharded ``loss_fn``
    on the same weights and batch."""
    import dataclasses
    from repro_torch.distributed.pipeline_parallel import make_pipeline_loss
    from repro_torch.distributed.sharding import local_of
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.trainer import _grads
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), n_layers=4)
    shape = ShapeConfig("s", "train", 16, 4)
    fl = FlowConfig(mode="folded", precision="fp32", remat="none",
                    pp_axis="pod")
    cm0 = tflow.compile(cfg, shape, fl, device="cpu")
    cm = tflow.compile(cfg, shape, fl, device="cpu",
                       mesh={"pod": 1, "data": 1})
    p0, p = cm0.init_params(0), cm.init_params(0)
    rng = np.random.RandomState(0)
    b = {k: torch.from_numpy(rng.randint(0, 256, (4, 16)))
         for k in ("tokens", "labels")}
    loss = make_pipeline_loss(cm.plan, cm.mesh, n_microbatches=2,
                              pp_axis="pod")
    l0, _, g0 = _grads(cm0.loss_fn, p0, b)
    l1, _, g1 = _grads(lambda q, bb: (loss(q, bb), {}),
                       tree_map(local_of, p), b)
    g1 = loss.reduce_grads(g1)
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, c in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.allclose(a, c, rtol=1e-4, atol=1e-6)


def test_engine_refuses_a_mesh_model():
    """The engine no longer refuses a model compiled on a mesh: on a
    one-rank mesh it serves the unsharded engine's tokens from the same
    weights (whole weights are placed on the mesh), and ``mesh=`` builds
    the plan again on the mesh asked for."""
    from repro_torch.serving import (Engine, EngineConfig,
                                     synthetic_requests)
    cm0, cm = _one_rank("llama3.2-1b", "decode")
    p0 = cm0.init_params(0)
    reqs = synthetic_requests(5, 256, prompt_len=12, max_new_tokens=4,
                              seed=3)
    ecfg = EngineConfig(max_batch=2, max_seq_len=32, block_size=8)
    want = Engine(cm0, p0, ecfg).run(reqs)
    for eng in (Engine(cm, p0, ecfg),
                Engine(cm0, p0, ecfg, mesh={"data": 1, "model": 1})):
        assert eng.mesh is not None and eng.plan.rules is not None
        got = eng.run(reqs)
        assert {r.rid: r.tokens for r in got.results} == \
            {r.rid: r.tokens for r in want.results}


def test_one_rank_collectives_are_the_identity():
    from repro_torch.distributed import collectives as col
    x = torch.arange(6.0).reshape(2, 3)
    for f in (lambda t: col.gather(t, 0, None), lambda t: col.split(t, 1,
              None), lambda t: col.reduce(t, None),
              lambda t: col.fsdp_gather(t, 0, None)):
        assert f(x) is x


def test_kernel_pointer_refuses_a_dtensor():
    """The kernels launch through ``data_ptr()``; a DTensor has no storage
    of its own, so handing one to a wrapper raises."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.kernels import _build
    mesh = MeshSpec((("data", 1), ("model", 1))).build("cpu")
    x = torch.zeros(4, 4)
    xd = ShardingRules(mesh).place(x, NamedSharding(mesh, P("data", None)))
    assert _build.ptr(xd.to_local()) == _build.ptr(x)
    with pytest.raises(TypeError, match="DTensor"):
        _build.ptr(xd)
