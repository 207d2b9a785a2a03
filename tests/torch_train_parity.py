"""Shared parts of the training parity tests: the port's ``make_loss_fn`` through
autograd against ``jax.value_and_grad`` of the JAX package's, on every
ported smoke config at ``SMOKE_SHAPE`` (train, 2 x 16), fp32, on the JAX
parameters carried across by ``repro_torch.bridge`` and the same batch.
JAX's train step differentiates only its reference ops (``pallas_call``
has no transpose rule), so its ``auto`` backend on the CPU is the oracle.

Tolerances (``conftest.relerr``): the loss < 1e-5, every gradient leaf and
every updated parameter < 1e-4 (fp32 sums in another order, through the
backward pass too); ``microbatches=2`` against 1 within JAX's own 5e-3.

MobileNetV1 and ResNet-34 train BatchNorm on the statistics of 2 images,
and their fp32 gradients are ill-conditioned there: JAX's own gradients
move by up to 6e-3 (MobileNetV1) and 3e-2 (ResNet-34) of a leaf's largest
entry when the images are scaled by 1 + 1e-7, which moves JAX's logits by
2.5e-5 / 1e-5, as far as the port's are from JAX's.  A gradient leaf of
theirs is held to twice the larger of 1e-4 and JAX's own movement of that
leaf under the images scaled by 1 +- 1e-7 and 1 +- 3e-7 (the worst leaf
measured: 1.73x).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import SMOKE_SHAPE, relerr, smoke_batch
from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.trainer import _grads

TRAIN_BN = ("mobilenetv1", "resnet34")
SHAPE = (SMOKE_SHAPE.name, SMOKE_SHAPE.kind, SMOKE_SHAPE.seq_len,
         SMOKE_SHAPE.global_batch)


def _models(arch, cfg_j=None, cfg_t=None, shape=SHAPE, **flow_kw):
    kw = dict(mode="folded", precision="fp32", **flow_kw)
    jcm = jflow.compile(cfg_j or jget_smoke(arch), JShapeConfig(*shape),
                        JFlowConfig(**kw))
    jp = jcm.init_params(jax.random.key(0))
    tcm = tflow.compile(cfg_t or get_smoke(arch), ShapeConfig(*shape),
                        FlowConfig(**kw), device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcm, jp, tcm, tp


def _batch(cfg):
    jb = smoke_batch(cfg)
    return jb, {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                    if v.dtype == jnp.int32 else
                                    np.array(v)) for k, v in jb.items()}


def _leaf_errs(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [relerr(b.detach().numpy(), np.asarray(a)) for a, b in zip(jl, tl)]


@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch):
    """(JAX's loss, metrics, grads), (the port's), and for the TRAIN_BN
    configs JAX's own largest movement a leaf (relerr) under the images
    scaled by 1 +- 1e-7 and 1 +- 3e-7."""
    jcm, jp, tcm, tp = _models(arch)
    jb, tb = _batch(jcm.cfg)
    vg = jax.jit(jax.value_and_grad(jcm.loss_fn, has_aux=True))
    (jl, jm), jg = vg(jp, jb)
    tl, tm, tg = _grads(tcm.loss_fn, tp, tb)
    moved = [0.0] * len(jax.tree.leaves(jg))
    if arch in TRAIN_BN:
        for f in (1 + 1e-7, 1 - 1e-7, 1 + 3e-7, 1 - 3e-7):
            _, g = vg(jp, {**jb, "images": jb["images"] * f})
            moved = [max(m, relerr(np.asarray(a), np.asarray(b))) for m, a, b
                     in zip(moved, jax.tree.leaves(g), jax.tree.leaves(jg))]
    return (float(jl), {k: float(v) for k, v in jm.items()}, jg), \
        (float(tl), {k: float(v) for k, v in tm.items()}, tg), moved


def check_loss(arch):
    (jl, jm, _), (tl, tm, _), _ = _loss_and_grads(arch)
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl)
    lm = arch not in ("lenet5", "mobilenetv1", "resnet34")
    assert set(tm) == ({"loss", "acc"} if lm else {"loss"})
    if lm:
        assert tm["acc"] == jm["acc"]


def check_gradients(arch):
    (_, _, jg), (_, _, tg), moved = _loss_and_grads(arch)
    errs = _leaf_errs(jg, tg)
    tol = [2 * max(1e-4, m) if arch in TRAIN_BN else 1e-4 for m in moved]
    bad = [(e, t) for e, t in zip(errs, tol) if e >= t]
    assert not bad, bad


def bn_conditioning(archs=TRAIN_BN, cells=((2, 64), (8, 64), (32, 64),
                                           (4, 128), (2, 224))):
    """For each (batch, image size): the port's largest gradient relerr
    against JAX's, and JAX's own largest movement under the images scaled
    by 1 + 1e-7, over the leaves (fp32, the smoke widths)."""
    import dataclasses
    out = []
    for arch in archs:
        for B, px in cells:
            cj = dataclasses.replace(jget_smoke(arch), image_size=px)
            ct = dataclasses.replace(get_smoke(arch), image_size=px)
            jcm, jp, tcm, tp = _models(arch, cj, ct, ("smoke", "train", 16, B))
            jb = smoke_batch(jcm.cfg, B=B)
            tb = {k: torch.from_numpy(np.array(v).astype(np.int64)
                                      if v.dtype == jnp.int32 else
                                      np.array(v)) for k, v in jb.items()}
            vg = jax.jit(jax.value_and_grad(jcm.loss_fn, has_aux=True))
            _, jg = vg(jp, jb)
            _, _, tg = _grads(tcm.loss_fn, tp, tb)
            _, jg2 = vg(jp, {**jb, "images": jb["images"] * (1 + 1e-7)})
            moved = max(relerr(np.asarray(a), np.asarray(b)) for a, b in
                        zip(jax.tree.leaves(jg2), jax.tree.leaves(jg)))
            out.append((arch, B, px, max(_leaf_errs(jg, tg)), moved))
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_train_parity.py
    for row in bn_conditioning():
        print("%s batch %d, %d px: port vs JAX %.3g, JAX's own movement "
              "%.3g" % row)
