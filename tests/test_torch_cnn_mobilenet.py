"""MobileNetV1 (smoke) through the port against the JAX package, in the four
flows of ``test_torch_cnn.py`` (same inputs, JAX weights carried across by
``repro_torch.bridge``, same tolerances and reasons).  Its 13 depthwise
convs take the reference op in both frameworks."""
import jax  # noqa: F401  (JAX stays on the CPU)
import pytest
import torch  # noqa: F401

from test_torch_cnn import FLOWS, check_logits


@pytest.mark.parametrize("flow_name", sorted(FLOWS))
def test_mobilenetv1_logits_match_jax(flow_name):
    check_logits("mobilenetv1", flow_name)
