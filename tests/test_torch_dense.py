"""The port's registry and the dense family's configurations and plans
against the JAX package's: ``ARCHS`` and ``CNNS`` by family (the MoE,
multimodal, RWKV6 and encoder-decoder configs are checked in
``tests/test_torch_{moe,vlm,rwkv,whisper}.py``),
each of qwen1.5-4b, phi4-mini-3.8b and stablelm-1.6b field by field (full and
smoke), and ``describe()`` line for line apart from the ``kernels:`` line.
The models' numerics are held to JAX in
``tests/test_torch_dense_{qwen,phi4,stablelm}.py``."""
import dataclasses

import pytest

from repro import flow as jflow
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import flow as tflow
from repro_torch.configs import ARCHS, CNNS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig

DENSE = ["qwen1.5-4b", "phi4-mini-3.8b", "stablelm-1.6b"]


def test_registry_lists_the_lms_and_the_cnns():
    """The ten LMs and the three CNNs, in the JAX package's order."""
    from repro.configs import ARCHS as JARCHS, CNNS as JCNNS
    assert ARCHS == ["recurrentgemma-2b", "qwen1.5-4b", "phi4-mini-3.8b",
                     "stablelm-1.6b", "llama3.2-1b", "deepseek-moe-16b",
                     "mixtral-8x7b", "rwkv6-7b", "llava-next-mistral-7b",
                     "whisper-small"] == JARCHS
    assert CNNS == ["lenet5", "mobilenetv1", "resnet34"] == JCNNS
    assert all(get_config(a).family in ("dense", "hybrid", "moe", "ssm",
                                        "vlm", "audio") for a in ARCHS)
    assert all(get_config(a).family == "cnn" for a in CNNS)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_is_jaxs(arch, smoke):
    """The port's copy of each configuration holds the JAX package's
    fields and values, full and smoke."""
    tcfg = get_smoke(arch) if smoke else get_config(arch)
    jcfg = jget_smoke(arch) if smoke else jget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def _without_kernels(text):
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith("kernels:")]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_plan_matches_jax(arch, smoke):
    """``describe()`` equal line for line apart from the ``kernels:`` line,
    at smoke size and at the full config (which only plans, here)."""
    shape = ("serve", "decode", 1024, 8)
    jcm = jflow.compile(arch, JShapeConfig(*shape), JFlowConfig(mode="folded"),
                        smoke=smoke)
    tcm = tflow.compile(arch, ShapeConfig(*shape), FlowConfig(mode="folded"),
                        smoke=smoke, device="cpu")
    assert _without_kernels(tcm.describe()) == _without_kernels(jcm.describe())
    assert tcm.describe().splitlines()[-1] == (
        "  kernels: backend=auto attention=ref conv2d=ref copy_block=ref "
        "decode_attention=ref glu_matmul=ref matmul=ref "
        "paged_decode_attention=ref rg_lru=ref")
