"""The train step on the port against the JAX package's: the remat
policies, _sdpa's checkpointed chunks, the chunked cross-entropy,
microbatches and two AdamW steps (the ROADMAP gate), on smoke configs in
fp32 (``torch_train_parity.py`` sets out the tolerances)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.configs import get_smoke as jget_smoke
from repro.optim.adamw import AdamW as JAdamW
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core.lowering import _chunked_ce_sums
from repro_torch.core.ops_impl import Ctx
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train.trainer import _grads, make_train_step
from torch_train_parity import SHAPE, _batch, _leaf_errs, _models


@pytest.mark.parametrize("remat", ["none", "block", "nested"])
def test_remat_policies_give_the_same_gradients(remat):
    """A 4-layer llama (one folded unit of 4: nested groups of 2): each remat
    policy's gradients equal the plain backward's, and JAX's."""
    cj = dataclasses.replace(jget_smoke("llama3.2-1b"), n_layers=4)
    ct = dataclasses.replace(get_smoke("llama3.2-1b"), n_layers=4)
    jcm, jp, tcm, tp = _models("llama3.2-1b", cj, ct, remat=remat)
    assert tcm.plan.units[1].reps == 4
    jb, tb = _batch(jcm.cfg)
    _, jg = jax.value_and_grad(jcm.loss_fn, has_aux=True)(jp, jb)
    _, _, tg = _grads(tcm.loss_fn, tp, tb)
    assert max(_leaf_errs(jg, tg)) < 1e-4
    plain = tflow.compile(ct, ShapeConfig(*SHAPE),
                          FlowConfig(mode="folded", precision="fp32",
                                     remat="none"), device="cpu")
    _, _, t0 = _grads(plain.loss_fn, tp, tb)
    for a, b in zip(tree_leaves(t0), tree_leaves(tg)):
        assert torch.equal(a, b)


def test_sdpa_chunks_checkpointed_in_train():
    """A 1024-token sequence crosses _sdpa's 512-query chunk: the chunked,
    checkpointed train path gives JAX's loss and gradients."""
    jcm, jp, tcm, tp = _models("llama3.2-1b",
                               shape=("smoke", "train", 1024, 1))
    rng = np.random.RandomState(5)
    toks = rng.randint(0, tcm.cfg.vocab_size, (1, 1025))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
          for k, v in jb.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jcm.loss_fn, has_aux=True))(
        jp, jb)
    tl, _, tg = _grads(tcm.loss_fn, tp, tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert max(_leaf_errs(jg, tg)) < 1e-4


def _chunked_ce(ctx, h, table, labels, true_vocab, chunk):
    """Mean cross-entropy and argmax accuracy over the valid labels."""
    nll, cnt, cor = _chunked_ce_sums(ctx, h, table, labels, true_vocab, chunk)
    denom = torch.clamp(cnt, min=1.0)
    return nll / denom, cor / denom


def test_chunked_ce_ignores_negative_labels_and_halves_the_chunk():
    """Labels < 0 count nowhere; S = 12 with ce_chunk 256 halves it to 4."""
    _, _, tcm, _ = _models("llama3.2-1b")
    ctx = Ctx(mode="train", plan=tcm.plan)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 12, 64, generator=g)
    table = torch.randn(256, 64, generator=g)
    labels = torch.randint(0, 256, (2, 12), generator=g)
    masked = labels.clone()
    masked[:, 5:] = -1
    lo, acc = _chunked_ce(ctx, h, table, masked, 256, 256)
    lo5, acc5 = _chunked_ce(ctx, h[:, :5].contiguous(), table,
                            labels[:, :5], 256, 256)
    assert torch.allclose(lo, lo5, rtol=1e-6) and torch.equal(acc, acc5)
    # the padded vocab entries (>= 200) never win and carry no probability
    lo_pad, _ = _chunked_ce(ctx, h, table, labels.clamp(max=199), 200, 256)
    ref = torch.nn.functional.cross_entropy(
        (h @ table[:200].T).reshape(-1, 200), labels.clamp(max=199).reshape(-1))
    assert torch.allclose(lo_pad, ref, rtol=1e-5)


def test_microbatches_match_one_batch():
    """JAX's test_grad_accumulation_equivalence on the port: two
    microbatches of 2 against one batch of 4, within JAX's 5e-3."""
    tcm = tflow.compile("llama3.2-1b", ShapeConfig(*SHAPE),
                        FlowConfig(mode="folded", precision="fp32"),
                        smoke=True, device="cpu")
    opt = AdamW(lr=1e-3, grad_clip=0.0, weight_decay=0.0, warmup_steps=0)
    rng = np.random.RandomState(0)
    V = tcm.cfg.vocab_size
    batch = {"tokens": torch.from_numpy(rng.randint(0, V, (4, 16))),
             "labels": torch.from_numpy(rng.randint(0, V, (4, 16)))}
    outs = []
    for mb in (1, 2):
        params = tcm.init_params(0)
        st = opt.init(params)
        step = make_train_step(tcm.plan, opt, microbatches=mb)
        params, st, m = step(params, st, batch)        # lr 0: moments only
        params, st, m = step(params, st, batch)
        outs.append((params, m))
    (p1, m1), (p2, m2) = outs
    err = max(relerr(a.numpy(), b.numpy())
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < 5e-3, (err, float(m1["loss"]), float(m2["loss"]))
    assert set(m2) == {"loss", "grad_norm", "lr"}
    assert set(m1) == {"loss", "acc", "grad_norm", "lr"}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "lenet5"])
def test_adamw_steps_match_jax(arch):
    """The ROADMAP gate: the train step's loss, moments and parameters
    against JAX's jitted step, over two steps (the first runs at lr 0, as
    the schedule starts there, so the second is the one that moves the
    parameters)."""
    jcm, jp, tcm, tp = _models(arch)
    jb, tb = _batch(jcm.cfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jstep = jax.jit(jmake_train_step(jcm.plan, jopt))
    tstep = tcm.train_step(topt)
    js, ts = jopt.init(jp), topt.init(tp)
    moved = False
    for i in range(2):
        p_before = [t.clone() for t in tree_leaves(tp)]
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        assert relerr(tm["lr"].numpy(), jm["lr"]) < 1e-6
        assert max(_leaf_errs(js.mu, ts.mu)) < 1e-4
        assert max(_leaf_errs(jp, tp)) < 1e-4
        moved = any(not torch.equal(a, b)
                    for a, b in zip(p_before, tree_leaves(tp)))
        assert moved == (i == 1)
    assert "train_step[mb=1]" in tcm.stats["stages"]
