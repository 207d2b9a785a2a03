"""The port's dry-run of rwkv6-7b's ``train_4k`` cell, whose WKV train
recurrence is a scan over 128 chunks of 32 steps.

On fake tensors the scan (``ops_impl._WKVTrainScan``) runs one chunk and
the dry-run's counters take its work by the trip count
(``kernels._fake.scan``), as a traced ``lax.scan`` costs its body: the
cell finishes in about a minute and a half whole.  What is checked:

- at a short sequence, the scan's counted flops and bytes on fake tensors
  equal those of the step-by-step loop the same function runs on real
  tensors, forward and backward, and the flops are one step's products
  times the steps: ``r·S`` as a (1, dk) x (dk, dv) product a head, its
  two gradient products and the backward's recompute;
- the cell's record (in a subprocess, one fake group each) has the JAX
  package's keys; ``memory.parameter_bytes`` equals the sum of the rank's
  local shards under ``repro``'s recorded ``PartitionSpec``s; the WKV
  scan's counted flops equal the count from the config's shapes: five
  step products a head a step (the forward twice under the block remat,
  the scan's recompute, two gradients) on the rank's rows at every head
  (the projections' outputs reach the recurrence whole, the batch split
  over ``data``).  Tier-1 runs the cell at 2 of its 32 layers on a
  (2, 4) mesh and on the CLI's production mesh; ``-m slow`` runs it whole
  on both.
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.core import lowering as jlowering
from repro.core.plan import _build_plan as jbuild_plan
from repro_torch.core import ops_impl
from repro_torch.kernels import _fake
from repro_torch.launch import dryrun
from test_torch_dryrun import KEYS, MEM_KEYS, _python

ARCH, SHAPE = "rwkv6-7b", "train_4k"
PASSES = 5      # step products a head a step in the train step
CUT = 2         # layers of the tier-1 cell

CELL = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
n_layers = int(sys.argv[1])
if n_layers:
    dryrun.get_config = lambda a: dataclasses.replace(get_config(a),
                                                      n_layers=n_layers)
out = {"small": dryrun.run_cell("rwkv6-7b", "train_4k", mesh=(2, 4))}
out["cli"] = dryrun.main(["--arch", "rwkv6-7b", "--shape", "train_4k"])[0]
print(json.dumps(out))
"""


def _counted(fn):
    """fn's flops and bytes under the dry-run's counters, and the part
    tallied inside scans."""
    _fake.SCAN_COST.clear()
    acct, flops = dryrun._Account(), dryrun._Flops(display=False)
    with flops, acct:
        fn()
    return flops.get_total_flops(), acct.bytes, dict(_fake.SCAN_COST)


def _wkv_train(B, S, H, d, chunk, fake):
    rng = np.random.RandomState(0)
    arrs = [rng.randn(B, S, H, d).astype(np.float32) for _ in range(4)]
    arrs.append(rng.randn(H, d).astype(np.float32))

    def run():
        r, k, v, w, u = (torch.from_numpy(a).requires_grad_() for a in arrs)
        y, _ = ops_impl._wkv_chunked(r, k, v, -torch.exp(w), u, chunk,
                                     parallel=False,
                                     boundary_dt=torch.bfloat16)
        y.sum().backward()
    if not fake:
        return _counted(run)
    with FakeTensorMode(allow_non_fake_inputs=True):
        return _counted(run)


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (8, 8)])
def test_fake_scan_counts_equal_the_loop(S, chunk):
    B, H, d = 2, 3, 8
    loop = _wkv_train(B, S, H, d, chunk, fake=False)
    scan = _wkv_train(B, S, H, d, chunk, fake=True)
    assert scan == loop
    # the forward, the backward's recompute and two gradient products
    assert loop[2]["wkv"]["flops"] == 4 * S * 2 * B * H * d * d
    assert 0 < loop[2]["wkv"]["bytes"] < loop[1]


def _local_param_bytes(axes, n_layers):
    """Rank 0's chunk of every parameter under JAX's recorded specs for
    the cell at ``n_layers`` on a mesh of ``axes``."""
    import dataclasses
    cfg = dataclasses.replace(jget_config(ARCH), n_layers=n_layers)
    plan = jbuild_plan(cfg, JFlowConfig(mode="folded", mesh_split=axes),
                       JSHAPES[SHAPE])
    sizes = dict(axes)
    total = 0
    for top, leaves in jlowering.param_shapes(plan).items():
        for k, s in leaves.items():
            spec = tuple(plan.sharding.param_specs[f"{top}/{k}"])
            n = np.dtype(s.dtype).itemsize
            for i, dim in enumerate(s.shape):
                e = spec[i] if i < len(spec) else None
                names = e if isinstance(e, tuple) else (e,) if e else ()
                n *= -(-dim // math.prod(sizes[a] for a in names))
            total += n
    return total


def _check(rec, axes, n_layers):
    assert set(KEYS) <= set(rec), set(KEYS) - set(rec)
    assert [n for _, n in axes] == rec["mesh"] and rec["mode"] == "folded"
    mem = rec["memory"]
    assert set(MEM_KEYS) <= set(mem) and mem["per_device_bytes"] > 0
    assert mem["fits_budget"] == (mem["per_device_bytes"]
                                  < mem["budget_bytes"])
    assert rec["collectives"]["collective_bytes"] > 0
    assert mem["parameter_bytes"] == _local_param_bytes(axes, n_layers)
    rc = jget_config(ARCH).recurrence
    sh = JSHAPES[SHAPE]
    rows = sh.global_batch // dict(axes)["data"]
    step = 2 * rows * rc.n_heads * rc.head_dim * rc.head_dim
    ca = rec["cost_analysis"]
    assert ca["flops_by_scan"]["wkv"] == \
        PASSES * sh.seq_len * step * n_layers
    assert 0 < ca["bytes_by_scan"]["wkv"] < ca["bytes accessed"]
    assert ca["flops"] > ca["flops_by_scan"]["wkv"]


def _cells(n_layers):
    return __import__("json").loads(
        _python(["-c", CELL, str(n_layers)], timeout=900)
        .strip().splitlines()[-1])


MESHES = {"small": (("data", 2), ("model", 4)),
          "cli": (("data", 16), ("model", 16))}


def test_rwkv_train_cell_at_a_cut_depth():
    recs = _cells(CUT)
    for name, axes in MESHES.items():
        _check(recs[name], axes, CUT)


@pytest.mark.slow
def test_rwkv_train_cell_whole():
    recs = _cells(0)
    for name, axes in MESHES.items():
        _check(recs[name], axes, 32)
