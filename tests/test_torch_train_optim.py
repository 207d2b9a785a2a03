"""The port's AdamW, synthetic data and checkpoints against the JAX
package's, on the same numpy inputs.

Tolerances: AdamW's parameters, moments and error buffers within relerr
1e-6 (``conftest.relerr``; the same fp32 arithmetic, the global norm summed
in another order); data and checkpoints byte-equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.data import pipeline as jdata
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWState as JAdamWState
from repro.train import checkpoint as jckpt
from repro_torch.data import pipeline as tdata
from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, tree_map
from repro_torch.train import checkpoint as tckpt

# a small tree in the shape of a plan's: an unfolded block, a folded unit's
# stacked leaves (a (reps, d) norm scale decays: ndim 2), a 1-D bias
SHAPES = {"embed": {"table": (32, 8)},
          "fold_layer0": {"0:attn_norm_scale": (3, 8), "0:mlp_w1": (3, 8, 16),
                          "1:bias": (3, 16)},
          "head": {"lm_head": (32, 8), "norm_bias": (8,)}}


def _tree(rng, scale=1.0, positive=False):
    def leaf(shape):
        a = rng.randn(*shape).astype(np.float32) * scale
        return np.abs(a) if positive else a
    return {k: {n: leaf(s) for n, s in v.items()} for k, v in SHAPES.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pairs(jtree, ttree):
    """(jax leaf, torch leaf) in the JAX package's leaf order."""
    return list(zip(jax.tree.leaves(jtree), tree_leaves(ttree)))


def _close(jtree, ttree, tol):
    for a, b in _pairs(jtree, ttree):
        assert relerr(b.numpy(), np.asarray(a)) < tol


KW = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
          grad_clip=1.0)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    """One update from step 5 with moments already built: the learning
    rate of step 5, bias correction at step 6, the clip (on and off) and
    weight decay on every leaf with ndim >= 2."""
    rng = np.random.RandomState(0)
    p, g = _tree(rng), _tree(rng, scale=3.0)
    mu, nu = _tree(rng, 0.1), _tree(rng, 0.01, positive=True)
    jopt = JAdamW(**{**KW, "grad_clip": clip})
    topt = AdamW(**{**KW, "grad_clip": clip})
    jp, js, jm = jopt.update(_jax(g), JAdamWState(jnp.int32(5), _jax(mu),
                                                  _jax(nu)), _jax(p))
    tp_in = _torch(p)
    ts_in = AdamWState(torch.tensor(5, dtype=torch.int32), _torch(mu),
                       _torch(nu))
    tp, ts, tm = topt.update(_torch(g), ts_in, tp_in)
    assert tp is tp_in and ts.mu is ts_in.mu       # in place
    assert int(ts.step) == int(js.step) == 6 and ts.step.dtype == torch.int32
    _close(jp, tp, 1e-6)
    _close(js.mu, ts.mu, 1e-6)
    _close(js.nu, ts.nu, 1e-6)
    assert relerr(tm["grad_norm"].numpy(), jm["grad_norm"]) < 1e-6
    assert relerr(tm["lr"].numpy(), jm["lr"]) < 1e-6


def test_adamw_int8_ef_three_steps_match_jax():
    """int8 compression with error feedback over 3 steps from init (the
    first at lr 0): parameters, moments and the error buffers."""
    rng = np.random.RandomState(1)
    p = _tree(rng)
    grads = [_tree(rng, scale=s) for s in (1.0, 0.3, 2.0)]
    jopt = JAdamW(**KW, compress="int8_ef")
    topt = AdamW(**KW, compress="int8_ef")
    jp, tp = _jax(p), _torch(p)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js, _ = jopt.update(_jax(g), js, jp)
        tp, ts, _ = topt.update(_torch(g), ts, tp)
    _close(jp, tp, 1e-6)
    _close(js.mu, ts.mu, 1e-6)
    _close(js.nu, ts.nu, 1e-6)
    _close(js.err, ts.err, 1e-6)
    assert int(ts.step) == 3


def test_compress_rounds_half_to_even_and_clips():
    opt = AdamW(compress="int8_ef")
    # max |g| = 127 sets the scale to 1: 2.5 -> 2, 3.5 -> 4, -0.5 -> -0
    g = {"w": torch.tensor([2.5, 3.5, -0.5, 127.0, -127.0])}
    e = {"w": torch.zeros(5)}
    deq, err = opt.compress_grads(g, e)
    assert deq["w"].tolist() == [2.0, 4.0, -0.0, 127.0, -127.0]
    assert err["w"].tolist() == [0.5, -0.5, -0.5, 0.0, 0.0]


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000, 12000])
def test_lr_schedule_matches_jax(step):
    """Warm-up from 0, the cosine after it, the floor after total_steps."""
    for kw in ({}, dict(warmup_steps=0, total_steps=10)):
        want = float(JAdamW(**kw).schedule(jnp.float32(step)))
        got = float(AdamW(**kw).schedule(step))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)
    assert float(AdamW().schedule(0)) == 0.0
    assert float(AdamW().schedule(100)) == pytest.approx(3e-4, rel=1e-6)
    assert float(AdamW().schedule(10000)) == pytest.approx(3e-5, rel=1e-6)


def _data_cfgs(mod, **kw):
    return mod.DataConfig(vocab_size=97, seq_len=12, global_batch=4, **kw)


@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batches_byte_equal_jax(step):
    for n_hosts, host in ((1, 0), (2, 1)):
        kw = dict(seed=3, n_hosts=n_hosts, host_id=host)
        j = jdata.SyntheticLM(_data_cfgs(jdata, **kw)).get(step)
        t = tdata.SyntheticLM(_data_cfgs(tdata, **kw)).get(step)
        assert j.keys() == t.keys()
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])
    ji = jdata.SyntheticImages(_data_cfgs(jdata), 8, 3, 10).get(step)
    ti = tdata.SyntheticImages(_data_cfgs(tdata), 8, 3, 10).get(step)
    for k in ji:
        assert ji[k].dtype == ti[k].dtype
        np.testing.assert_array_equal(ji[k], ti[k])


def test_straggler_substitution_matches_jax():
    """A host missing its deadline at step 3 serves step 2's batch in both
    packages."""
    def run(mod):
        d = mod.SyntheticLM(mod.DataConfig(
            vocab_size=97, seq_len=8, global_batch=4, deadline_s=0.01,
            delay_fn=lambda s: 0.05 if s == 3 else 0))
        return [d.get(s) for s in range(5)], d.stale_steps
    (jb, js), (tb, ts) = run(jdata), run(tdata)
    assert js == ts == 1
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(tb[3]["tokens"], tb[2]["tokens"])


def _ckpt_trees(rng, compress):
    p = _tree(rng)
    jopt = JAdamW(compress=compress)
    topt = AdamW(compress=compress)
    g = _tree(rng)
    jp, js, _ = jopt.update(_jax(g), jopt.init(_jax(p)), _jax(p))
    tp, ts, _ = topt.update(_torch(g), topt.init(_torch(p)), _torch(p))
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _same(jtree, ttree):
    assert len(jax.tree.leaves(jtree)) == len(tckpt._flatten(ttree))
    for a, (k, b) in zip(jax.tree.leaves(jtree), tckpt._flatten(ttree).items()):
        a = np.array(a)
        assert b.dtype == torch.from_numpy(a).dtype, k
        np.testing.assert_array_equal(b.numpy(), a, err_msg=k)


@pytest.mark.parametrize("compress", [None, "int8_ef"])
def test_checkpoints_cross_restore(tmp_path, compress):
    """The same keys in the same order (so the same files), and each package
    restores the other's checkpoint exactly."""
    jt, tt = _ckpt_trees(np.random.RandomState(2), compress)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jdir, 4, jt)
    tckpt.save(tdir, 4, tt)
    metas = [json.load(open(os.path.join(d, "step_00000004", "meta.json")))
             for d in (jdir, tdir)]
    assert metas[0] == metas[1]
    assert list(metas[1]["leaves"]) == list(jckpt._flatten(jt))
    assert tckpt.latest_step(jdir) == 4
    # torch restores JAX's (the step, the moments, the error buffers too)
    got = tckpt.restore(jdir, 4, tt)
    assert isinstance(got["opt"], AdamWState)
    _same(jt, got)
    # JAX restores the port's
    _same(jckpt.restore(tdir, 4, jt), tt)


def test_checkpoint_restores_onto_like_dtype_and_structure(tmp_path):
    tree = {"params": {"b": {"x": torch.arange(6.0).reshape(2, 3)},
                       "a": {"1:w": torch.ones(2)}},
            "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                              {"w": torch.full((2,), 0.5)},
                              {"w": torch.full((2,), 0.25)})}
    tckpt.save(str(tmp_path), 3, tree)
    got = tckpt.restore(str(tmp_path), 3, tree)
    assert got["opt"].err is None and int(got["opt"].step) == 3
    assert list(got["params"]) == ["b", "a"]        # like's own order
    for (k, a), b in zip(tckpt._flatten(tree).items(),
                         tckpt._flatten(got).values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
        assert a.data_ptr() != b.data_ptr()


def test_checkpoint_refuses_bfloat16(tmp_path):
    """numpy has no bfloat16: the save raises before it writes anything."""
    with pytest.raises(TypeError, match="bfloat16"):
        tckpt.save(str(tmp_path), 1, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert os.listdir(tmp_path) == []


def test_checkpoint_gc_and_async(tmp_path):
    params = {"w": torch.ones(4, 4)}
    threads = []
    for s in (1, 2, 3, 4, 5):
        t = tckpt.save(str(tmp_path), s, params, wait=(s < 5), keep=2)
        if t:
            threads.append(t)
        params["w"].add_(1.0)      # the async save copied before returning
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]
    assert tckpt.latest_step(str(tmp_path)) == 5
    got = tckpt.restore(str(tmp_path), 5, params)
    assert torch.equal(got["w"], torch.full((4, 4), 5.0))
