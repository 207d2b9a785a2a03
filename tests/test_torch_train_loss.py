"""The training loss and its gradients on LeNet-5 and the five LMs against
the JAX package's (``torch_train_parity.py`` sets out the comparison and
its tolerances; ``test_torch_train_loss_bn.py`` holds the two CNNs that
train BatchNorm)."""
import pytest

from torch_train_parity import check_gradients, check_loss

ARCHS = ("lenet5", "llama3.2-1b", "qwen1.5-4b", "phi4-mini-3.8b",
         "stablelm-1.6b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    check_gradients(arch)
