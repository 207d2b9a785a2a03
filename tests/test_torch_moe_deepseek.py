"""deepseek-moe-16b against the JAX package on the CPU: the tests of
``tests/torch_moe_parity.py`` for this model."""
import pytest

from torch_moe_parity import (  # noqa: F401  (collected here)
    test_cuda_backend_on_cpu_matches_pallas_interpret,
    test_decode_logits_teacher_forced, test_engine_run_matches_jax_cold_run,
    test_full_head_geometry_matches_jax, test_greedy_generate_identical_fp32,
    test_init_state_matches_jax_layout, test_prefill_logits_and_state)


@pytest.fixture(params=["deepseek-moe-16b"])
def arch(request):
    return request.param
