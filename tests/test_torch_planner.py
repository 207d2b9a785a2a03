"""The port's planner against the JAX package's: the same pass pipeline must
print the same plan for the paper's CNNs and llama3.2-1b (at full width),
apart from the kernel-backend line (the port registers only the kernels it
has ported, under ``cuda``)."""
import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import pytest
import torch  # noqa: F401

from repro import flow as jflow
from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro_torch import flow as tflow
from repro_torch.configs import get_config
from repro_torch.configs.base import FlowConfig, ShapeConfig

CPU_KERNELS = ("  kernels: backend=auto attention=ref conv2d=ref "
               "copy_block=ref decode_attention=ref glu_matmul=ref "
               "matmul=ref paged_decode_attention=ref rg_lru=ref")

FLOWS = {
    "opt": (lambda F: F(mode="auto")),
    "base": (lambda F: F().base()),
    "folded": (lambda F: F(mode="folded")),
}
CASES = [(a, f) for a in ("lenet5", "mobilenetv1", "resnet34", "llama3.2-1b")
         for f in FLOWS]


def _plans(arch, variant):
    jcm = jflow.compile(jget_config(arch), JShapeConfig("bench", "prefill",
                                                        64, 8),
                        FLOWS[variant](JFlowConfig))
    tcm = tflow.compile(get_config(arch), ShapeConfig("bench", "prefill",
                                                      64, 8),
                        FLOWS[variant](FlowConfig), device="cpu")
    return jcm, tcm


def _without_kernels(text):
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith("kernels:")]


@pytest.mark.parametrize("arch,variant", CASES)
def test_plan_describe_matches_jax(arch, variant):
    jcm, tcm = _plans(arch, variant)
    assert _without_kernels(tcm.describe()) == _without_kernels(jcm.describe())
    assert tcm.describe().splitlines()[-1] == CPU_KERNELS


@pytest.mark.parametrize("arch,variant", CASES)
def test_plan_stats_match_jax(arch, variant):
    jcm, tcm = _plans(arch, variant)
    t = tcm.plan.describe(stats=True)
    j = jcm.plan.describe(stats=True)
    assert _without_kernels(t) == _without_kernels(j)
    assert "    kernels: backend=auto cuda_ops=[] ref_ops=27" in t


def test_cuda_platform_plan_differs_only_in_kernels():
    """A plan built for the card resolves ``auto`` by the card's capability;
    the rest of the plan does not depend on the platform."""
    from repro_torch.core.plan import _build_plan
    from repro_torch.device import hopper_ok
    cfg, shape = get_config("resnet34"), ShapeConfig("bench", "prefill", 64, 8)
    cpu = _build_plan(cfg, FlowConfig(mode="auto"), shape, platform="cpu")
    gpu = _build_plan(cfg, FlowConfig(mode="auto"), shape, platform="cuda")
    assert gpu.platform == "cuda" and cpu.platform == "cpu"
    assert _without_kernels(gpu.describe()) == _without_kernels(cpu.describe())
    want = "cuda" if hopper_ok() else "ref"
    assert gpu.kernels["conv2d"] == gpu.kernels["matmul"] == want
    assert gpu.kernels["depthwise_conv2d"] == "ref"


def test_explicit_cuda_backend_resolves_on_any_platform():
    cm = tflow.compile("lenet5", ShapeConfig("bench", "prefill", 64, 8),
                       backend="cuda", device="cpu")
    assert cm.describe().splitlines()[-1] == (
        "  kernels: backend=cuda attention=cuda conv2d=cuda copy_block=cuda "
        "decode_attention=cuda glu_matmul=cuda matmul=cuda "
        "paged_decode_attention=cuda rg_lru=cuda")


def test_param_count_equals_jax():
    """``param_count`` / ``active_param_count`` (the port's estimator)
    count what JAX's count, for every ported config."""
    from repro_torch.configs import ARCHS, CNNS
    for name in ARCHS + CNNS:
        cfg, jcfg = get_config(name), jget_config(name)
        assert cfg.param_count() == jcfg.param_count() > 0, name
        assert cfg.active_param_count() == jcfg.active_param_count(), name
