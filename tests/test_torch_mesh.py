"""The port's multi-device runtime on four gloo ranks (CPU): the sharded
train step, ``compile(mesh=)``, the MoE over the model axis, GPipe over a
pod axis, the elastic checkpoint and the DSE's mesh search, each held to
the JAX package's single-device numbers on the same weights (sharding
leaves the function unchanged).

Each case makes JAX's numbers here, writes them with the weights to an
npz, and runs ``tests/torch_mesh_worker.py``, which starts the four ranks
(no JAX in them)."""
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


def _reference(case):
    """JAX's single-device numbers for ``case`` (and the weights)."""
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if case in ("elastic", "explore"):
        return dict(b)
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


@pytest.mark.parametrize("case", CASES)
def test_mesh_case(case, tmp_path):
    np.savez(tmp_path / "ref.npz", **_reference(case))
    r = subprocess.run([sys.executable, WORKER, case, str(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-4000:]
    assert f"{case} OK" in r.stdout, r.stdout[-3000:]
