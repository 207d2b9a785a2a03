"""The port's dry-run (``repro_torch.launch.dryrun``): full-width cells on
fake tensors over a fake process group, in subprocesses (each with its own
group), held to numbers this test reckons itself.

The JAX package's own dry-run test is red with the installed jax (ROADMAP
Queue 3), so its records are no oracle.  What is checked:

- the record has the JAX package's keys, ``per_device_bytes > 0`` and
  ``collectives.collective_bytes >= 0``;
- the parameters' part of the argument bytes equals the sum of the local
  shard bytes of every parameter under ``repro``'s recorded
  ``PartitionSpec``s for the same mesh (rank 0's chunk: ``ceil`` of each
  split dim);
- the products' and attention's part of ``flops`` equals a count from the
  config's shapes within 1%: 2 M K N a product on this rank's rows (a
  weight split over the model axis does a quarter of its columns or rows
  on (2, 4)), 4 D a (query head, key) pair of attention; the train step
  runs each forward kernel twice (remat ``block`` recomputes it);
- ``dse.autotune_train_cell`` picks the first microbatch count that fits
  a forced budget, or the last one when none fits;
- the CLI's entry point (``python -m repro_torch.launch.dryrun``'s
  ``main``) prints an ``OK`` line on the 256-rank production mesh.
"""
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.core import lowering as jlowering
from repro.core.plan import _build_plan as jbuild_plan

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MESH = (("data", 2), ("model", 4))
KEYS = ("arch", "shape", "mesh", "multi_pod", "mode", "folds", "pass_stats",
        "pass_timings_ms", "memory", "cost_analysis", "model_flops",
        "est_kernel_bytes", "compile_s", "collectives")
MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "per_device_bytes", "budget_bytes", "fits_budget")

CELLS = """
import json
from repro_torch.configs.base import FlowConfig
from repro_torch.core import dse
from repro_torch.launch import dryrun
out = {s: dryrun.run_cell("llama3.2-1b", s, mesh=(2, 4))
       for s in ("decode_32k", "train_4k")}
base = FlowConfig(mode="folded")
per = {mb: dryrun.run_cell("lenet5", "train_4k", mesh=(2, 4), flow=
       FlowConfig(mode="folded", microbatches=mb))["memory"]
       ["per_device_bytes"] for mb in (1, 2, 4)}
picks = {}
for budget in sorted({1, *(v + 1 for v in per.values())}):
    fl, r = dse.autotune_train_cell("lenet5", "train_4k", (2, 4), base,
                                    candidates=(1, 2, 4), hbm_bytes=budget)
    picks[budget] = [fl.microbatches, r["autotuned_microbatches"]]
out["lenet5"] = {"per": per, "picks": picks}
# the CLI's entry point, as `python -m repro_torch.launch.dryrun` runs it,
# on the 256-rank production mesh (the fake group is resized for it)
dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"])
print(json.dumps(out))
"""


def _python(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-4000:]
    return r.stdout


@functools.lru_cache(maxsize=1)
def _run():
    """The cells' records and the lines the CLI printed, from one
    subprocess (one fake group, resized from 8 ranks to 256)."""
    lines = _python(["-c", CELLS]).strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


def _cells():
    return _run()[0]


@functools.lru_cache(maxsize=None)
def _jplan(shape):
    return jbuild_plan(jget_config("llama3.2-1b"),
                       JFlowConfig(mode="folded", mesh_split=MESH),
                       JSHAPES[shape])


def _local_param_bytes(shape):
    """Rank 0's chunk of every parameter under JAX's recorded specs."""
    plan = _jplan(shape)
    sizes = dict(MESH)
    total = 0
    for top, leaves in jlowering.param_shapes(plan).items():
        for k, s in leaves.items():
            spec = tuple(plan.sharding.param_specs[f"{top}/{k}"])
            n = np.dtype(s.dtype).itemsize
            for i, d in enumerate(s.shape):
                e = spec[i] if i < len(spec) else None
                axes = e if isinstance(e, tuple) else (e,) if e else ()
                n *= -(-d // math.prod(sizes[a] for a in axes))
            total += n
    return total


def _expected_flops(shape):
    """The products' and attention's operations on rank 0, from the
    config's shapes and JAX's recorded specs (which weights the model
    axis splits)."""
    plan, cfg = _jplan(shape), jget_config("llama3.2-1b")
    sh = JSHAPES[shape]
    dp, tp = 2, 4
    att = cfg.attention
    rows = sh.global_batch // dp
    S = 1 if sh.kind == "decode" else sh.seq_len
    layer = plan.graph.blocks[1]
    specs = plan.sharding.param_specs
    mm = 0
    for op in layer.ops:
        if op.op not in ("matmul", "glu_matmul"):
            continue
        for p in op.params:
            K, N = p.shape
            split = any("model" in (e if isinstance(e, tuple) else (e,))
                        for e in tuple(specs[f"fold_layer0/0:{p.name}"])
                        [-2:] if e)
            mm += 2 * rows * S * K * N // (tp if split else 1)
    H, D = att.n_heads, att.head_dim
    if sh.kind == "decode":
        attn = 4 * rows * H * D * plan.cache_len
        passes = 1
    else:
        c = sh.seq_len // tp        # rank 0's query chunk (context parallel)
        attn = 4 * rows * H * D * c * (c + 1) // 2
        passes = 2                  # remat "block": the forward twice
    return passes * cfg.n_layers * mm, passes * cfg.n_layers * attn


@pytest.mark.parametrize("shape", ("decode_32k", "train_4k"))
def test_dryrun_cell_on_a_fake_mesh(shape):
    r = _cells()[shape]
    assert set(KEYS) <= set(r), set(KEYS) - set(r)
    assert r["mesh"] == [2, 4] and r["mode"] == "folded"
    mem = r["memory"]
    assert set(MEM_KEYS) <= set(mem)
    assert mem["per_device_bytes"] > 0
    assert mem["fits_budget"] == (mem["per_device_bytes"]
                                  < mem["budget_bytes"])
    assert r["collectives"]["collective_bytes"] >= 0
    assert mem["parameter_bytes"] == _local_param_bytes(shape)
    mm, attn = _expected_flops(shape)
    fk = r["cost_analysis"]["flops_by_kernel"]
    got_attn = fk.get("decode_attention", 0) + fk.get("flash_attention", 0)
    assert abs(fk["matmul_fused"] - mm) <= 0.01 * mm, (fk, mm)
    assert abs(got_attn - attn) <= 0.01 * attn, (fk, attn)
    assert r["cost_analysis"]["flops"] > fk["matmul_fused"]


def test_autotune_train_cell_picks_the_first_fit():
    rec = _cells()["lenet5"]
    per = {int(k): v for k, v in rec["per"].items()}
    for budget, (mb, tagged) in rec["picks"].items():
        fits = [m for m in (1, 2, 4) if per[m] < int(budget)]
        assert mb == tagged == (fits[0] if fits else 4), (budget, per)


def test_dryrun_cli_on_the_production_mesh():
    line = [ln for ln in _run()[1] if ln.startswith("OK ")]
    assert len(line) == 1 and \
        "llama3.2-1b x decode_32k pods=1" in line[0], _run()[1]
