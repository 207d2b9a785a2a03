"""The training loss and its gradients on MobileNetV1 and ResNet-34, which
train BatchNorm on the batch's statistics, against the JAX package's
(``torch_train_parity.py`` sets out the comparison and its tolerances)."""
import pytest

from torch_train_parity import (TRAIN_BN, _loss_and_grads, check_gradients,
                                check_loss)


@pytest.mark.parametrize("arch", TRAIN_BN)
def test_loss_matches_jax(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRAIN_BN)
def test_gradients_match_jax(arch):
    check_gradients(arch)


def test_batchnorm_running_stats_get_zero_gradients():
    """In train mode BN reads its batch statistics: the running mean and var
    get zero gradients (JAX's), and AdamW leaves them where they were."""
    _, (_, _, tg), _ = _loss_and_grads("resnet34")
    names = [(b, n) for b, d in tg.items() for n in d
             if n.endswith("_mean") or n.endswith("_var")]
    assert len(names) >= 2
    for b, n in names:
        assert not tg[b][n].any(), (b, n)
