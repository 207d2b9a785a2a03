"""Multi-device serving on four gloo ranks (CPU): the port's ``Engine`` on a
``DeviceMesh`` and ``autotune_decode(mesh=)``.

The oracle is the JAX package's *cold* single-device ``Engine.run``
(``prefix_cache=False``, no chunking, no speculation) on the same weights
and requests: JAX's own mesh and prefix-hit serving tests are red with the
installed jax (ROADMAP Queue 3), so neither is used.  Each case makes JAX's
numbers here, writes them with the weights to an npz and runs
``tests/torch_mesh_worker.py``, which starts the four ranks (no JAX in
them).  Every rank holds its tokens to JAX's, and the paged state to every
other rank's, bit for bit.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import dse as jdse
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched

import torch_mesh_worker as w

WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")


def _jax(arch):
    jcm = jflow.compile(arch, JShapeConfig(*w.SERVE_SHAPE),
                        JFlowConfig(mode="folded", precision="fp32"),
                        smoke=True)
    return jcm, jcm.init_params(jax.random.key(0))


def _cold(jcm, jp, reqs, **kw):
    """JAX's cold run: {rid: tokens}."""
    jr = [jsched.Request(r.rid, r.prompt.copy(), r.max_new_tokens,
                         r.stop_token) for r in reqs]
    rep = jengine.Engine(jcm, jp, jengine.EngineConfig(**kw)).run(jr)
    return {r.rid: np.asarray(r.tokens, np.int32) for r in rep.results}


def _reference(case):
    out = {}
    if case == "serve":
        jcm, jp = _jax("llama3.2-1b")
        for reqs, cold in {(r, tuple(sorted(c.items())))
                           for r, c, _ in w.SERVE_RUNS.values()}:
            for rid, t in _cold(jcm, jp, w.serve_requests(reqs),
                                **{**w.SERVE_BASE, **dict(cold)}).items():
                out[f"tok|{reqs}|{rid}"] = t
    else:
        jcm, jp = _jax("recurrentgemma-2b")
        for rid, t in _cold(jcm, jp, w.serve_requests("exact"),
                            **w.HYBRID_BASE).items():
            out[f"tok|exact|{rid}"] = t
        # the mesh splits JAX's DSE enumerates for a 4-device search
        base = JFlowConfig(mode="folded")
        import dataclasses
        base = dataclasses.replace(base, tuning=dataclasses.replace(
            base.tuning, mesh_devices=4))
        shape = JShapeConfig("s", "decode", 64, 4)
        splits = {f.mesh_split for f, _ in jdse.enumerate_candidates(
            jget_smoke("llama3.2-1b"), shape, base)}
        out["jax_splits"] = np.array(json.dumps(sorted(splits)))
    for t, leaves in jax.tree.map(np.asarray, jp).items():
        for k, v in leaves.items():
            out[f"params|{t}|{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("case", ("serve", "serve_hybrid"))
def test_serve_mesh_case(case, tmp_path):
    np.savez(tmp_path / "ref.npz", **_reference(case))
    r = subprocess.run([sys.executable, WORKER, case, str(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-4000:]
    assert f"{case} OK" in r.stdout, r.stdout[-3000:]
