"""The JAX package's parameters survive JAX -> numpy -> ``repro_torch.bridge``
exactly, in the unfolded and the folded (``fold_<block>`` / ``"{j}:{name}"``)
layouts, in fp32 and bf16, and land in the layout the port's own lowering
expects."""
import jax
import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import bridge
from repro_torch import flow as tflow
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig

# (mode, precision): "pipelined" never folds, "folded" stacks the repeated
# blocks of MobileNetV1 and ResNet-34 (LeNet-5 has none to stack)
LAYOUTS = [("pipelined", "fp32"), ("pipelined", "bf16"), ("folded", "fp32"),
           ("folded", "bf16")]
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("mode,prec", LAYOUTS)
@pytest.mark.parametrize("arch", ["lenet5", "mobilenetv1", "resnet34"])
def test_params_cross_exactly(arch, mode, prec):
    shape = ("bench", "prefill", 64, 8)
    jcm = jflow.compile(jget_smoke(arch), JShapeConfig(*shape),
                        JFlowConfig(mode=mode, precision=prec))
    jp = jcm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(tree, "cpu")

    tcm = tflow.compile(get_smoke(arch), ShapeConfig(*shape),
                        FlowConfig(mode=mode, precision=prec), device="cpu")
    want = dict(_leaves(tcm.param_shapes()))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)              # the same layout
    folded = [k for k in got if k.startswith("fold_")]
    assert bool(folded) == (mode == "folded" and arch != "lenet5")
    for key, t in got.items():
        assert t.shape == want[key].shape and t.dtype == want[key].dtype
        assert t.dtype == TDTYPE[prec]
        src = dict(_leaves(tree))[key]
        np.testing.assert_array_equal(t.float().numpy(),
                                      src.astype(np.float32))


def test_bf16_goes_through_float32_losslessly():
    import ml_dtypes
    vals = np.array([1.0, -2.5, 3.0e-39, 1.7e38, np.inf], np.float32)
    a = vals.astype(ml_dtypes.bfloat16)
    t = bridge.tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
