"""The port's multi-device runtime on four gloo ranks (CPU): the sharded
train step, ``compile(mesh=)``, the MoE over the model axis, GPipe over a
pod axis, the elastic checkpoint and the DSE's mesh search, each held to
the JAX package's single-device numbers on the same weights (sharding
leaves the function unchanged).

Each case makes JAX's numbers here, writes them with the weights to an
npz, and runs ``tests/torch_mesh_worker.py``, which starts the four ranks
(no JAX in them).  ``train_step``, ``compress`` (``Trainer(mesh=)`` with
``AdamW(compress="int8_ef")`` against JAX's compressed steps) and
``train_cli`` (``launch/train.py --compress --mesh``) share one group of
ranks."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.optim.adamw import AdamW as JAdamW

WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
CASES = ("train_step", "compile_mesh", "compile_mesh-recurrentgemma-2b",
         "moe-mixtral-8x7b",
         "moe-deepseek-moe-16b", "moe_dp-mixtral-8x7b",
         "moe_dp-deepseek-moe-16b", "pipeline", "elastic", "explore")


def _flat(prefix, tree):
    return {f"{prefix}|{t}|{k}": np.asarray(v, np.float32)
            for t, leaves in tree.items() for k, v in leaves.items()}


def _batch():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(0, 256, (4, 16)).astype(np.int32),
            "labels": rng.randint(0, 256, (4, 16)).astype(np.int32)}


def _jax(arch, kind, cfg=None, **flow_kw):
    jcm = jflow.compile(cfg or jget_smoke(arch),
                        JShapeConfig("s", kind, 16, 4),
                        JFlowConfig(mode="folded", precision="fp32",
                                    **flow_kw))
    params = jax.tree.map(np.asarray, jcm.init_params(jax.random.key(0)))
    return jcm, params


def _codes(deq):
    """The int8 codes of a dequantized leaf (its largest |value| is 127
    scales)."""
    m = np.max(np.abs(deq))
    return np.zeros_like(deq) if m == 0 else np.round(deq * 127 / m)


def _reference(case):
    """JAX's single-device numbers for ``case`` (and the weights)."""
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if case in ("elastic", "explore"):
        return dict(b)
    if case == "compress":
        # 3 steps of AdamW(compress="int8_ef") on the batch from init: the
        # parameters, each step's loss and each step's int8 codes
        jcm, params = _jax("llama3.2-1b", "train")
        opt = JAdamW(lr=1e-3, warmup_steps=1, compress="int8_ef")
        st, out, losses = opt.init(params), _flat("params", params), []
        for s in range(3):
            (loss, _), g = jax.value_and_grad(jcm.loss_fn, has_aux=True)(
                params, jb)
            deq, _ = opt.compress_grads(
                jax.tree.map(lambda x: x.astype(jnp.float32), g), st.err)
            out.update(_flat(f"codes{s}", jax.tree.map(
                lambda d: _codes(np.asarray(d)), deq)))
            params, st, _ = opt.update(g, st, params)
            losses.append(float(loss))
        return {**b, **out, "jlosses": np.asarray(losses, np.float64),
                **_flat("jparams", jax.tree.map(np.asarray, params))}
    if case == "train_step":
        jcm, params = _jax("llama3.2-1b", "train")
        loss, _ = jcm.loss_fn(params, jb)
        return {**b, **_flat("params", params), "loss": np.float64(loss)}
    if case.startswith("moe-"):
        # (data 2, model 2): JAX's _moe_shard_map averages each dp shard's
        # aux (its router statistics over the shard's rows) over dp
        jcm, params = _jax(case[4:], "train")
        _, m = jcm.loss_fn(params, jb)
        auxs = [float(jcm.loss_fn(params, {k: v[i:i + 2] for k, v in
                                           jb.items()})[1]["moe_aux"])
                for i in (0, 2)]
        return {**b, **_flat("params", params),
                "loss": np.float64(m["loss"]),
                "total": np.float64(m["loss"]) + np.mean(auxs)}
    if case.startswith("moe_dp-"):
        # (data 4, model 1): no model axis, the statistics over the batch
        jcm, params = _jax(case[7:], "train")
        (total, _), grads = jax.value_and_grad(jcm.loss_fn, has_aux=True)(
            params, jb)
        return {**b, **_flat("params", params),
                **_flat("grads", jax.tree.map(np.asarray, grads)),
                "total": np.float64(total)}
    if case.startswith("compile_mesh"):
        jcm, params = _jax(case[13:] or "llama3.2-1b", "prefill")
        logits, _, _ = jcm.prefill(params, {"tokens": jb["tokens"]})
        toks, _ = jcm.generate(params, {"tokens": jb["tokens"]}, 4)
        return {**b, **_flat("params", params),
                "logits": np.asarray(logits, np.float32),
                "tokens_out": np.asarray(toks)}
    assert case == "pipeline"
    cfg = dataclasses.replace(jget_smoke("llama3.2-1b"), n_layers=4)
    jcm, params = _jax(None, "train", cfg=cfg, remat="none")
    (loss, _), grads = jax.value_and_grad(jcm.loss_fn, has_aux=True)(
        params, jb)
    return {**b, **_flat("params", params),
            **_flat("grads", jax.tree.map(np.asarray, grads)),
            "loss": np.float64(loss)}


def _run(case, d, ref):
    np.savez(d / "ref.npz", **ref)
    return subprocess.run([sys.executable, WORKER, case, str(d)],
                          capture_output=True, text=True, timeout=300)


def _ok(r, case):
    assert f"{case} OK" in r.stdout, \
        r.stdout[-3000:] + "\n" + r.stderr[-4000:]


@pytest.fixture(scope="module")
def train_group(tmp_path_factory):
    """One group of four ranks runs ``train_step``, ``compress`` and
    ``train_cli``, one after the other."""
    return _run("train_step+compress+train_cli", tmp_path_factory.mktemp("train"),
                {**_reference("train_step"), **_reference("compress")})


@pytest.mark.parametrize("case", CASES)
def test_mesh_case(case, tmp_path, request):
    if case == "train_step":
        _ok(request.getfixturevalue("train_group"), case)
        return
    r = _run(case, tmp_path, _reference(case))
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-4000:]
    _ok(r, case)


def test_mesh_compress(train_group):
    """``Trainer(mesh=)`` with ``AdamW(compress="int8_ef")``: the worker's
    ``case_compress`` bounds; the group exits 0."""
    _ok(train_group, "compress")


def test_mesh_train_cli_compress(train_group):
    """``launch/train.py --compress --mesh data=2,model=2`` on the four
    ranks; the group exits 0."""
    assert train_group.returncode == 0, \
        train_group.stdout[-3000:] + "\n" + train_group.stderr[-4000:]
    _ok(train_group, "train_cli")
