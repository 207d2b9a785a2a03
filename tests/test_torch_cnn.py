"""The CNN slice as a whole: the port's ``flow.compile(...).prefill`` against
the JAX package's ``flow.compile(...).apply(..., mode="prefill")`` (un-jitted,
eager), on the JAX parameters carried across by ``repro_torch.bridge`` and
the same images from numpy.

Tolerances, on ``conftest.relerr`` (max |diff| over max |ref|: the random
init makes the logits grow to ~1e10 through ResNet's 36 convs, so an
absolute tolerance means nothing):
* fp32 < 1e-4 — the same arithmetic, summed in another order through up to
  36 convolutions;
* bf16 < 5e-2 — activations round to bf16 after every op; where the two
  fp32 sums straddle a rounding boundary the bf16 values differ by one ulp
  (~0.4%), and such differences compound through the depth.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import relerr
from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import matmul_fused as tmm

SHAPE = ("serve", "prefill", 64, 8)
FLOWS = {
    "opt_bf16": dict(mode="auto"),
    "fp32": dict(mode="auto", precision="fp32"),
    "base": "base",
    "folded": dict(mode="folded"),
}
TOL = {"opt_bf16": 5e-2, "folded": 5e-2, "fp32": 1e-4, "base": 1e-4}


def _flow(F, name):
    spec = FLOWS[name]
    return F().base() if spec == "base" else F(**spec)


def _images(cfg, B=2, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, cfg.image_size, cfg.image_size,
                     cfg.image_channels).astype(np.float32)


def _pair(arch, flow_name, jbackend="auto"):
    """(JAX logits, port logits, port model) for one case."""
    jcm = jflow.compile(jget_smoke(arch), JShapeConfig(*SHAPE),
                        _flow(JFlowConfig, flow_name), backend=jbackend)
    jp = jcm.init_params(jax.random.key(0))
    x = _images(jcm.cfg)
    jy, _, _ = jcm.apply(jp, {"images": jax.numpy.asarray(x)},
                         mode="prefill")
    tcm = tflow.compile(get_smoke(arch), ShapeConfig(*SHAPE),
                        _flow(FlowConfig, flow_name), device="cpu")
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ty, state, aux = tcm.prefill(tp, {"images": torch.from_numpy(x)})
    assert state == {} and aux == {}
    return np.asarray(jy, np.float32), ty, tcm


def check_logits(arch, flow_name):
    jy, ty, tcm = _pair(arch, flow_name)
    assert tuple(ty.shape) == jy.shape == (2, tcm.cfg.vocab_size)
    assert ty.dtype == (torch.float32 if tcm.flow.precision == "fp32"
                        else torch.bfloat16)
    assert torch.isfinite(ty.float()).all()
    assert relerr(ty.float().numpy(), jy) < TOL[flow_name]


# MobileNetV1's cases live in test_torch_cnn_mobilenet.py, so that the two
# files run on two test workers
@pytest.mark.parametrize("flow_name", sorted(FLOWS))
@pytest.mark.parametrize("arch", ["lenet5", "resnet34"])
def test_logits_match_jax(arch, flow_name):
    check_logits(arch, flow_name)


@pytest.mark.parametrize("arch", ["lenet5", "resnet34"])
def test_cuda_backend_on_cpu_runs_plain_versions(arch):
    """``backend="cuda"`` on a CPU model routes conv2d/matmul through the
    kernel wrappers, which take their plain versions for CPU tensors; held
    against the reference ops (themselves held against JAX above) on the
    same weights, in fp32.  No launch is counted."""
    before = (tconv.conv2d_fused.launches, tmm.matmul_fused.launches)
    cfg = dataclasses.replace(get_smoke(arch), image_size=32)   # CPU time
    shape, fl = ShapeConfig(*SHAPE), _flow(FlowConfig, "fp32")
    plain = tflow.compile(cfg, shape, fl, backend="cuda", device="cpu")
    ref = tflow.compile(cfg, shape, fl, device="cpu")
    assert plain.plan.kernels["conv2d"] == "cuda"
    assert ref.plan.kernels["conv2d"] == "ref"
    params = plain.init_params(0)
    x = {"images": torch.from_numpy(_images(cfg, B=1))}
    y, _, _ = plain.prefill(params, x)
    yr, _, _ = ref.prefill(params, x)
    assert relerr(y.numpy(), yr.numpy()) < 1e-4
    assert (tconv.conv2d_fused.launches, tmm.matmul_fused.launches) == before


def test_lenet5_against_pallas_interpret():
    """The Pallas kernels themselves as the oracle, once: JAX runs LeNet-5
    with ``backend="pallas_interpret"`` (conv2d and matmul in interpret
    mode)."""
    jy, ty, _ = _pair("lenet5", "fp32", jbackend="pallas_interpret")
    assert relerr(ty.float().numpy(), jy) < 1e-4


def test_folded_resnet_runs_four_scan_groups():
    cm = tflow.compile("resnet34", ShapeConfig(*SHAPE), smoke=True,
                       device="cpu")
    assert [(u.reps, u.period) for u in cm.plan.units if u.folded] == \
        [(3, 1), (3, 1), (5, 1), (2, 1)]
    assert "units: 9 (4 folded: 3x1, 3x1, 5x1, 2x1)" in cm.describe()


def test_init_params_is_seeded_per_parameter():
    cm = tflow.compile("lenet5", ShapeConfig(*SHAPE), device="cpu")
    a, b, c = cm.init_params(0), cm.init_params(0), cm.init_params(1)
    assert torch.equal(a["stem"]["c1_w"], b["stem"]["c1_w"])
    assert not torch.equal(a["stem"]["c1_w"], c["stem"]["c1_w"])
    assert a["stem"]["c1_w"].dtype == torch.bfloat16


def test_measure_on_cpu_says_cpu():
    cm = tflow.compile("lenet5", ShapeConfig(*SHAPE), device="cpu")
    rec = cm.measure("prefill", iters=2)
    assert rec["device"] == "cpu" and rec["timer"] == "wall_clock"
    assert rec["iters"] == 2 and rec["images_per_s"] > 0
    with pytest.raises(NotImplementedError):
        cm.measure("train")
