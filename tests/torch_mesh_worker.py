"""Rank program of ``tests/test_torch_mesh.py``: four gloo ranks on the CPU
run one case of the port's mesh runtime against the JAX package's
single-device numbers, which the test made in its own process and left in
``<dir>/ref.npz``.  No JAX is imported here.

    python tests/torch_mesh_worker.py <case> <dir>          # the launcher
    python tests/torch_mesh_worker.py <case> <dir> <rank>   # one rank

The launcher starts the four ranks, stops them all when one fails, and
exits with the first failing rank's code; once every rank has passed a
case, rank 0 prints ``<case> OK`` and its figures.  ``<a>+<b>`` runs the
cases one after the other in the same group (``train_step+compress+train_cli``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

WORLD = 4
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-9)


def _tree(ref, prefix):
    """The ``prefix|top|leaf`` arrays of the npz as a nested dict."""
    out = {}
    for k in ref.files:
        if k.startswith(prefix + "|"):
            _, top, leaf = k.split("|")
            out.setdefault(top, {})[leaf] = ref[k]
    return out


def _batch(ref):
    import torch
    return {k: torch.from_numpy(ref[k].astype(np.int64))
            for k in ("tokens", "labels") if k in ref.files}


def _compile(arch, kind, mesh, cfg=None, **flow_kw):
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    fl = FlowConfig(mode="folded", precision="fp32", **flow_kw)
    return flow.compile(cfg or arch, ShapeConfig("s", kind, 16, 4), fl,
                        smoke=cfg is None, device="cpu", mesh=mesh)


def _mesh_params(cm, ref, prefix="params"):
    from repro_torch import bridge
    return bridge.params_from_numpy(_tree(ref, prefix), "cpu",
                                    rules=cm.rules, plan=cm.plan)


def case_train_step(rank, ref):
    """The sharded llama train step: its loss against JAX's, a tp- and
    dp-sharded weight's local numel, the gradients and one AdamW step
    (taken where the learning rate is not 0) against the port's unsharded
    ones.  AdamW's first update is ``lr * m / (sqrt(v) + eps)``: where a
    gradient is near ``eps`` it turns a last-bit difference of the
    gradient into up to ``lr`` of the weight, so the step is held to 1e-5
    where |g| > 1e-6 and to ``lr`` elsewhere."""
    import torch
    from repro_torch import bridge
    from repro_torch.distributed.sharding import full_tensor, local_of
    from repro_torch.optim.adamw import AdamW, tree_map
    from repro_torch.train.trainer import _grads
    mesh = {"data": 2, "model": 2}
    cm = _compile("llama3.2-1b", "train", mesh)
    c1 = _compile("llama3.2-1b", "train", None)
    p = _mesh_params(cm, ref)
    p1 = bridge.params_from_numpy(_tree(ref, "params"), "cpu")
    b = _batch(ref)
    loss, _ = cm.loss_fn(p, b)
    err = _relerr(float(loss), ref["loss"])
    assert err < 2e-5, (float(loss), float(ref["loss"]))
    wq = p["fold_layer0"]["0:wq"]
    assert str(cm.plan.sharding.param_specs["fold_layer0/0:wq"]) == \
        "PartitionSpec(None, 'data', 'model')"
    assert wq.to_local().numel() * 4 == wq.numel()
    # init_params(rules=): each rank draws only its chunk of the same values
    drawn, whole = cm.init_params(3), c1.init_params(3)
    for t in whole:
        for k in whole[t]:
            d = drawn[t][k]
            assert torch.equal(d.to_local(), cm.rules.local_chunk(
                whole[t][k], d.placements))
    assert drawn["fold_layer0"]["0:wq"].to_local().numel() * 4 == wq.numel()
    shd = cm.rules.params_shardings(cm.plan)
    _, _, g = _grads(cm.loss_fn, tree_map(local_of, p), b)
    g = cm.rules.reduce_grads(g, shd)
    _, _, g1 = _grads(c1.loss_fn, p1, b)
    gerr = max(_relerr(full_tensor(cm.rules.wrap(
        g[t][k], shd[t][k].placements, p[t][k].shape)).numpy(),
        g1[t][k].numpy()) for t in g1 for k in g1[t])
    assert gerr < 1e-5, gerr
    lr = 1e-3
    opt = AdamW(lr=lr, warmup_steps=1)
    o, o1 = opt.init(p), opt.init(p1)
    o = o._replace(step=torch.ones((), dtype=torch.int32))
    o1 = o1._replace(step=torch.ones((), dtype=torch.int32))
    p, o, m = cm.train_step(opt)(p, o, b)
    p1, o1, m1 = c1.train_step(opt)(p1, o1, b)
    perr = loose = moved = 0.0
    for t in p1:
        for k in p1[t]:
            d = (full_tensor(p[t][k]) - p1[t][k]).abs()
            well = g1[t][k].abs() > 1e-6
            perr = max(perr, float(d[well].max()))
            loose = max(loose, float(d.max()))
            moved = max(moved, float((p1[t][k] - torch.from_numpy(
                np.array(ref[f"params|{t}|{k}"]))).abs().max()))
    assert perr < 1e-5 and loose <= lr and moved > 1e-4, \
        (perr, loose, moved)
    return f"loss relerr {err:.2e} grads relerr {gerr:.2e} step " \
        f"max|dparam| {perr:.2e} (near-eps gradients {loose:.2e})"


COMPRESS_STEPS, COMPRESS_LR = 3, 1e-3


def _codes(deq):
    """The int8 codes of a dequantized leaf: its largest |value| is 127
    scales, so ``round(deq * 127 / max|deq|)`` gives the codes back."""
    import torch
    m = deq.abs().max()
    return torch.zeros_like(deq) if m == 0 else torch.round(deq * 127 / m)


def case_compress(rank, ref):
    """``Trainer(mesh=)`` with ``AdamW(compress="int8_ef")`` on (data 2,
    model 2): 3 steps of smoke llama on one batch from the bridged weights,
    against the port's unsharded step and JAX's ``AdamW.update`` (the npz's
    ``jparams`` and ``codes<step>``).  The scale is each whole tensor's
    (the chunks' maxima all-reduced), no gradient is gathered, and the
    error buffers stay DTensors with the parameters' placements.  A
    gradient summed over dp in another order can move an element across a
    rounding boundary: its int8 code flips, and that element is held to
    2 lr a step; the flips are counted (any step, against either side) and
    must stay under 1e-3 of the elements.  Every other element: 1e-5 where
    the first step's |g| > 1e-6, ``lr`` elsewhere (the mesh train step's
    bounds); the losses within 2e-5."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import bridge
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.optim.adamw import AdamW, tree_map
    from repro_torch.train.trainer import Trainer, TrainerConfig, _grads

    @dataclasses.dataclass(frozen=True)
    class Logged(AdamW):
        log: list = dataclasses.field(default_factory=list, compare=False,
                                      hash=False)

        def compress_grads(self, grads, err):
            deq, err = super().compress_grads(grads, err)
            self.log.append(tree_map(lambda d: _codes(full_tensor(d)), deq))
            return deq, err

    class Fixed:                       # one batch at every step
        def get(self, step):
            return {k: ref[k].astype(np.int64) for k in ("tokens", "labels")}

    kw = dict(lr=COMPRESS_LR, warmup_steps=1, compress="int8_ef")
    tc = TrainerConfig(steps=COMPRESS_STEPS, log_every=1)
    cm = _compile("llama3.2-1b", "train", {"data": 2, "model": 2})
    c1 = _compile("llama3.2-1b", "train", None)
    opt, opt1 = Logged(**kw), Logged(**kw)
    tr, tr1 = Trainer(cm, opt, tc), Trainer(c1, opt1, tc)
    assert tr.rules is not None and tr1.rules is None
    p = _mesh_params(cm, ref)
    p1 = bridge.params_from_numpy(_tree(ref, "params"), "cpu")
    g1 = _grads(c1.loss_fn, p1, _batch(ref))[2]
    tr.init = lambda seed: (p, opt.init(p))
    tr1.init = lambda seed: (p1, opt1.init(p1))
    p, o, hist = tr.fit(Fixed(), 0)
    p1, _, hist1 = tr1.fit(Fixed(), 0)
    wq = o.err["fold_layer0"]["0:wq"]
    assert isinstance(wq, DTensor) and \
        wq.placements == p["fold_layer0"]["0:wq"].placements
    lerr = max(_relerr(a, b) for (_, a), (_, b) in zip(hist, hist1))
    lerr = max([lerr] + [_relerr(a, b) for (_, a), b in
                         zip(hist1, ref["jlosses"])])
    assert lerr < 2e-5, (hist, hist1, ref["jlosses"])
    flips = n = 0
    perr = loose = flipped_err = 0.0
    for t in p1:
        for k in p1[t]:
            flip = torch.zeros(p1[t][k].shape, dtype=torch.bool)
            for s in range(COMPRESS_STEPS):
                jc = torch.from_numpy(np.array(ref[f"codes{s}|{t}|{k}"]))
                mc, sc = opt.log[s][t][k], opt1.log[s][t][k]
                flip |= (mc != sc) | (sc != jc)
            well = (g1[t][k].abs() > 1e-6) & ~flip
            for other in (p1[t][k], torch.from_numpy(
                    np.array(ref[f"jparams|{t}|{k}"]))):
                d = (full_tensor(p[t][k]) - other).abs()
                if well.any():
                    perr = max(perr, float(d[well].max()))
                if (~flip).any():
                    loose = max(loose, float(d[~flip].max()))
                if flip.any():
                    flipped_err = max(flipped_err, float(d[flip].max()))
            flips += int(flip.sum())
            n += flip.numel()
    assert perr < 1e-5 and loose <= COMPRESS_LR, (perr, loose)
    assert flipped_err <= 2 * COMPRESS_LR * COMPRESS_STEPS, flipped_err
    assert flips <= 1e-3 * n, (flips, n)
    return f"{COMPRESS_STEPS} steps: losses relerr {lerr:.2e} max|dparam| " \
        f"{perr:.2e} (near-eps {loose:.2e}), {flips} of {n} elements' " \
        f"int8 codes flipped (max|dparam| {flipped_err:.2e})"


def case_train_cli(rank, ref):
    """``python -m repro_torch.launch.train --compress --mesh
    data=2,model=2`` (its ``main``) on the group that is up: the plan on
    the mesh, 3 steps of smoke llama, every loss finite."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--batch", "4", "--seq", "16", "--compress",
                    "--mesh", "data=2,model=2", "--rank", str(rank),
                    "--init-file",
                    os.path.join(os.environ["MESH_TEST_DIR"], "store")])
    text = out.getvalue()
    assert "sharding: mesh={data:2,model:2}" in text, text
    losses = [float(ln.split()[-1]) for ln in text.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 3 and np.all(np.isfinite(losses)), text
    return f"losses {losses}"


def case_compile_mesh(rank, ref, arch="llama3.2-1b"):
    """compile(mesh=): the plan's sharding line, fp32 prefill logits and
    greedy tokens against JAX's single-device ones (recurrentgemma-2b:
    its conv and RG-LRU states gathered over tp for each decode step and
    cut back after)."""
    import torch
    from repro_torch.distributed.sharding import full_tensor
    cm = _compile(arch, "prefill", {"data": 2, "model": 2})
    assert "sharding: mesh={data:2,model:2} dp=data:2 tp=model:2" in \
        cm.plan.describe()
    p = _mesh_params(cm, ref)
    b = {"tokens": _batch(ref)["tokens"]}
    logits, state, _ = cm.prefill(p, b)
    err = _relerr(full_tensor(logits).numpy(), ref["logits"])
    assert err < 1e-4, err
    toks, _ = cm.generate(p, b, 4)
    assert torch.equal(toks.long(), torch.from_numpy(
        ref["tokens_out"].astype(np.int64))), (toks, ref["tokens_out"])
    return f"logits relerr {err:.2e} tokens identical"


def case_moe(rank, ref, arch):
    """The MoE over the model axis (_moe_shard_map) on (data 2, model 2):
    its CE against JAX's single-device CE, and its total loss (CE + aux)
    against JAX's CE plus the mean over the two dp shards of JAX's aux on
    each shard's rows (JAX's _moe_shard_map: each dp shard's router
    statistics, averaged over dp)."""
    cm = _compile(arch, "train", {"data": 2, "model": 2})
    assert cm.rules.tp == "model" and cm.rules.dp == ("data",)
    p = _mesh_params(cm, ref)
    total, m = cm.loss_fn(p, _batch(ref))
    err = _relerr(float(m["loss"]), ref["loss"])
    assert err < 1e-5, (float(m["loss"]), float(ref["loss"]))
    terr = _relerr(float(total), ref["total"])
    assert terr < 1e-5, (float(total), float(ref["total"]))
    return f"{arch} CE relerr {err:.2e} total relerr {terr:.2e}"


def case_moe_dp(rank, ref, arch):
    """The MoE on (data 4, model 1): a one-rank model axis carries data
    parallelism (no model-axis region); the total loss (CE + aux, the
    router statistics over the global batch) and every gradient, the
    router's included, against JAX's single-device ones."""
    from repro_torch.distributed.sharding import full_tensor, local_of
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.trainer import _grads
    cm = _compile(arch, "train", {"data": 4, "model": 1})
    assert cm.rules.tp is None and cm.rules.dp_size == 4
    p = _mesh_params(cm, ref)
    total, _, g = _grads(cm.loss_fn, tree_map(local_of, p), _batch(ref))
    terr = _relerr(float(total), ref["total"])
    assert terr < 1e-5, (float(total), float(ref["total"]))
    shd = cm.rules.params_shardings(cm.plan)
    g = cm.rules.reduce_grads(g, shd)
    gerr, rerr = 0.0, 0.0
    for t in g:
        for k in g[t]:
            whole = full_tensor(cm.rules.wrap(g[t][k], shd[t][k].placements,
                                              p[t][k].shape))
            e = _relerr(whole.numpy(), ref[f"grads|{t}|{k}"])
            gerr = max(gerr, e)
            if k.endswith("router"):
                rerr = max(rerr, e)
    assert gerr < 1e-4, gerr
    return f"{arch} total relerr {terr:.2e} grads relerr {gerr:.2e} " \
        f"(router {rerr:.2e})"


def case_pipeline(rank, ref):
    """GPipe over pod:2 (data:2 beside it), 2 microbatches: the loss against
    JAX's folded loss, the gradients against JAX's unsharded ones."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.pipeline_parallel import make_pipeline_loss
    from repro_torch.distributed.sharding import full_tensor, local_of
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.trainer import _grads
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), n_layers=4)
    cm = _compile(None, "train", {"pod": 2, "data": 2}, cfg=cfg,
                  remat="none", pp_axis="pod")
    sp = cm.plan.sharding
    assert sp.pp_axis == "pod" and sp.stage_of_layer == (0, 0, 1, 1)
    p = _mesh_params(cm, ref)
    loss = make_pipeline_loss(cm.plan, cm.mesh, n_microbatches=2)
    lo, _, g = _grads(lambda q, b: (loss(q, b), {}), tree_map(local_of, p),
                      _batch(ref))
    err = _relerr(float(lo), ref["loss"])
    assert err < 2e-4, (float(lo), float(ref["loss"]))
    g = loss.reduce_grads(g)
    shd = cm.rules.params_shardings(cm.plan)
    gerr = 0.0
    for t in g:
        for k in g[t]:
            whole = full_tensor(cm.rules.wrap(g[t][k], shd[t][k].placements,
                                              p[t][k].shape))
            gerr = max(gerr, _relerr(whole.numpy(), ref[f"grads|{t}|{k}"]))
    assert gerr < 1e-4, gerr
    return f"loss relerr {err:.2e} grads relerr {gerr:.2e}"


def case_elastic(rank, ref):
    """A checkpoint saved on (data 2, model 2) restored onto (data 4,
    model 1) with the placements asked for; a train state too."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.distributed.sharding import (
        P, NamedSharding, ShardingRules, full_tensor)
    from repro_torch.train import checkpoint as ckpt
    m1 = MeshSpec((("data", 2), ("model", 2))).build("cpu")
    m2 = MeshSpec((("data", 4), ("model", 1))).build("cpu")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    xs = ShardingRules(m1).place(x, NamedSharding(m1, P("data", "model")))
    assert xs.to_local().shape == (4, 4)
    d = os.path.join(os.environ["MESH_TEST_DIR"], "ckpt")
    ckpt.save(d, 1, {"x": xs})
    out = ckpt.restore(d, 1, {"x": xs},
                       {"x": NamedSharding(m2, P(None, "data"))})
    assert tuple(out["x"].placements) == (Shard(1), Replicate())
    assert out["x"].to_local().shape == (8, 2)
    assert torch.equal(full_tensor(out["x"]), x)
    back = ckpt.restore(d, 1, {"x": xs})      # the like tree's placements
    assert tuple(back["x"].placements) == tuple(xs.placements)
    assert torch.equal(full_tensor(back["x"]), x)
    return "values identical, placements as asked"


def case_explore(rank, ref):
    """explore(devices=4): at least 2 mesh splits measured on their own
    meshes, and the winner compiles and runs."""
    import torch
    from repro_torch import flow
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import dse
    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.distributed.sharding import full_tensor
    cfg, shape = get_smoke("llama3.2-1b"), ShapeConfig("s", "prefill", 16, 4)
    r = dse.explore(cfg, shape, devices=4, rank_measured=True, device="cpu",
                    validator=dse.measure_validator(cfg, shape, iters=1,
                                                    device="cpu"))
    splits = {c.flow.mesh_split for c in r.candidates}
    assert len(splits) >= 2, splits
    assert r.validated and all(v["measured_step_s"] > 0
                               for v in r.validated)
    best = flow.compile(cfg, shape, r.best.flow, device="cpu",
                        mesh=MeshSpec.of(r.best.flow.mesh_split))
    lg, _, _ = best.prefill(best.init_params(0),
                            {"tokens": _batch(ref)["tokens"]})
    assert bool(torch.isfinite(full_tensor(lg)).all())
    return f"splits {sorted(splits)} best {r.best.flow.mesh_split} " \
        f"measured {len(r.validated)}"


# -- serving on a mesh ---------------------------------------------------------

SERVE_SHAPE = ("serve", "decode", 64, 4)
SERVE_BASE = dict(max_batch=4, max_seq_len=64, block_size=8)
SERVE_MESHES = ({"data": 2, "model": 2}, {"data": 4, "model": 1},
                {"data": 1, "model": 4})
HYBRID_BASE = dict(max_batch=4, max_seq_len=64, block_size=8,
                   prompt_buckets=(16,))


def serve_requests(name):
    """The requests of a serving workload: ``mixed`` (prompts of 15-30
    tokens, left-padded to their bucket, 7 requests over 4 slots: evictions
    and refills), ``cow`` (one 12-token prompt, 1.5 blocks, sent four times:
    prefix hits and a copy-on-write fork), ``exact`` (the hybrid's: prompts
    of exactly 16 tokens, 3-30 new tokens each)."""
    from repro_torch.serving import Request, synthetic_requests
    if name == "mixed":
        return synthetic_requests(7, 256, prompt_len=30, max_new_tokens=6,
                                  seed=5)
    rng = np.random.RandomState(21 if name == "cow" else 3)
    if name == "cow":
        p = rng.randint(0, 256, 12).astype(np.int32)
        return [Request(x, p, max_new_tokens=4) for x in "abcd"]
    return [Request(f"r{i}", rng.randint(0, 256, 16).astype(np.int32),
                    max_new_tokens=int(rng.randint(3, 31))) for i in range(7)]


#: workload -> (requests, the cold run's knobs, the knobs on top): A mixed
#: lengths, B a prefix hit with a fork, C chunked prefill with n-gram
#: speculation, D host-free decode segments; each held to the JAX
#: package's cold run of its requests
SERVE_RUNS = {
    "A": ("mixed", {}, {}),
    "B": ("cow", dict(max_batch=2, prompt_buckets=(16, 64)),
          dict(prefix_cache=True)),
    "C": ("mixed", {}, dict(chunked_prefill=True, chunk_size=8,
                            speculation="ngram:4")),
    "D": ("mixed", {}, dict(fori_seg=4)),
}


def _tokens(report):
    return {r.rid: list(r.tokens) for r in report.results}


def _ref_tokens(ref, name):
    return {k.split("|", 2)[2]: [int(t) for t in ref[k]] for k in ref.files
            if k.startswith(f"tok|{name}|")}


def _same_on_every_rank(tree):
    """Every leaf of ``tree`` bitwise equal on every rank of the group."""
    import torch
    import torch.distributed as dist
    n = 0
    for leaf in _leaves(tree):
        b = leaf.contiguous().view(torch.uint8).reshape(-1)
        parts = [torch.empty_like(b) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, b)
        assert all(torch.equal(p, parts[0]) for p in parts), leaf.shape
        n += 1
    return n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _serve_check(eng, report, name):
    m = report.metrics
    if name == "B":
        assert m["prefix_hits"] >= 2 and m["cow_forks"] >= 1, m
    if name == "C":
        assert m["spec_tokens_drafted"] > 0 and m["catchup_tokens"] > 0, m
    if name == "D":
        assert m["fori_segments"] > 0, m
    return _same_on_every_rank(eng.last_cache.state)


def case_serve(rank, ref):
    """``Engine`` on the three meshes over smoke llama3.2-1b (fp32, bridged
    weights): workloads A-D give the JAX package's cold greedy tokens and
    the port's unsharded engine's on every rank, and the paged state
    (pools, tables, lengths) is bitwise equal across ranks after each
    run."""
    from repro_torch import bridge
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch import flow
    fl = FlowConfig(mode="folded", precision="fp32")
    c1 = flow.compile("llama3.2-1b", ShapeConfig(*SERVE_SHAPE), fl,
                      smoke=True, device="cpu")
    p1 = bridge.params_from_numpy(_tree(ref, "params"), "cpu")
    whole = {}
    for name, (reqs, cold, on) in SERVE_RUNS.items():
        want = _ref_tokens(ref, reqs)
        got = _tokens(Engine(c1, p1, EngineConfig(
            **{**SERVE_BASE, **cold, **on})).run(serve_requests(reqs)))
        assert got == want, (name, got, want)
        whole[name] = got
    leaves = 0
    for mesh in SERVE_MESHES:
        cm = flow.compile("llama3.2-1b", ShapeConfig(*SERVE_SHAPE), fl,
                          smoke=True, device="cpu", mesh=mesh)
        p = _mesh_params(cm, ref)
        for name, (reqs, cold, on) in SERVE_RUNS.items():
            eng = Engine(cm, p, EngineConfig(**{**SERVE_BASE, **cold, **on}))
            rep = eng.run(serve_requests(reqs))
            assert _tokens(rep) == whole[name], (mesh, name)
            leaves += _serve_check(eng, rep, name)
    return f"3 meshes x workloads {''.join(SERVE_RUNS)}: JAX's cold " \
        f"tokens on every rank, {leaves} state leaves bitwise equal"


def case_serve_hybrid(rank, ref):
    """The hybrid (smoke recurrentgemma-2b: paged attention and dense conv
    and RG-LRU rows) on {data:2, model:2}: JAX's tokens, the state equal
    across ranks; then ``autotune_decode(mesh=, validate="compile")``:
    each bucket's search enumerates JAX's mesh splits for 4 devices (its
    survivors are the splits the batch bucket admits), and
    the pinned engine serves on the mesh with the state equal across
    ranks and the tokens of the unsharded engine on the same weights."""
    import torch
    from repro_torch import bridge, flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.core import dse
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.autotune import ServingProfile, autotune_decode
    fl = FlowConfig(mode="folded", precision="fp32")
    cm = flow.compile("recurrentgemma-2b", ShapeConfig(*SERVE_SHAPE), fl,
                      smoke=True, device="cpu",
                      mesh={"data": 2, "model": 2})
    eng = Engine(cm, _mesh_params(cm, ref), EngineConfig(**HYBRID_BASE))
    rep = eng.run(serve_requests("exact"))
    assert _tokens(rep) == _ref_tokens(ref, "exact")
    assert rep.metrics["refills"] >= 1
    leaves = _same_on_every_rank(eng.last_cache.state)
    prof = ServingProfile(batch_buckets=(1, 4), max_seq_len=64,
                          block_sizes=(8, 16), chunk_sizes=(1, 2))
    at = autotune_decode("llama3.2-1b", smoke=True, device="cpu",
                         profile=prof, mesh={"data": 2, "model": 2},
                         validate="compile", iters=1)
    want = {tuple(map(tuple, s)) for s in json.loads(str(ref["jax_splits"]))}
    base = FlowConfig(mode="folded")
    base = dataclasses.replace(base, tuning=dataclasses.replace(
        base.tuning, mesh_devices=4))
    for b, er in at.per_bucket.items():
        cands = dse.enumerate_candidates(at.cfg, prof.shape_for(b), base,
                                         device="cpu")
        assert {f.mesh_split for f, _ in cands} == want, b
        assert er.n_enumerated == len(cands), (b, er.n_enumerated)
        assert {c.flow.mesh_split for c in er.candidates} <= want, b
    assert at.mesh is not None and "b1" in at.describe()
    pinned = at.engine(capture_logits=False)
    assert pinned.plan.rules is not None
    reqs = serve_requests("mixed")
    rep = pinned.run(reqs)
    leaves += _same_on_every_rank(pinned.last_cache.state)
    one = flow.compile("llama3.2-1b", pinned.plan.shape,
                       dataclasses.replace(pinned.plan.flow,
                                           mesh_split=None),
                       smoke=True, device="cpu")
    p1 = tree_map(full_tensor, pinned.params)
    solo = Engine(one, p1, at.engine_config(capture_logits=False)).run(reqs)
    assert _tokens(rep) == _tokens(solo)
    assert torch.isfinite(torch.tensor(float(rep.metrics["wall_s"])))
    return f"hybrid JAX tokens, autotune splits {sorted(want)} pinned " \
        f"block {at.block_size}, {leaves} state leaves bitwise equal"


CASES = {
    "serve": case_serve,
    "serve_hybrid": case_serve_hybrid,
    "train_step": case_train_step,
    "compress": case_compress,
    "train_cli": case_train_cli,
    "compile_mesh": case_compile_mesh,
    "compile_mesh-recurrentgemma-2b": lambda r, ref: case_compile_mesh(
        r, ref, "recurrentgemma-2b"),
    "moe-mixtral-8x7b": lambda r, ref: case_moe(r, ref, "mixtral-8x7b"),
    "moe-deepseek-moe-16b": lambda r, ref: case_moe(r, ref,
                                                    "deepseek-moe-16b"),
    "moe_dp-mixtral-8x7b": lambda r, ref: case_moe_dp(r, ref,
                                                      "mixtral-8x7b"),
    "moe_dp-deepseek-moe-16b": lambda r, ref: case_moe_dp(
        r, ref, "deepseek-moe-16b"),
    "pipeline": case_pipeline,
    "elastic": case_elastic,
    "explore": case_explore,
}


def rank_main(case: str, d: str, rank: int) -> None:
    import torch
    torch.set_num_threads(1)
    from repro_torch.device import init_process_group
    init_process_group(WORLD, rank, "cpu", os.path.join(d, "store"))
    path = os.path.join(d, "ref.npz")
    ref = np.load(path) if os.path.exists(path) else None
    os.environ["MESH_TEST_DIR"] = d
    import torch.distributed as dist
    for name in case.split("+"):
        msg = CASES[name](rank, ref)
        dist.barrier()                  # every rank passed it
        if rank == 0:
            print(f"{name} OK {msg}", flush=True)


def launch(case: str, d: str, limit: float = 280.0) -> int:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               case, d, str(r)], env=env)
             for r in range(WORLD)]
    t0, code = time.time(), 0
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode]
            if bad or time.time() - t0 > limit:
                code = bad[0] if bad else 124
                break
            time.sleep(0.05)
        else:
            code = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return code


if __name__ == "__main__":
    if len(sys.argv) == 3:
        sys.exit(launch(sys.argv[1], sys.argv[2]))
    rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
