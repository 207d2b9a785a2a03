"""Import hygiene of the port: nothing under ``src/repro_torch`` and nothing
in ``chip_smoke.py`` imports JAX or the JAX package (``repro``); and the
entry point runs on the card unless told otherwise."""
import ast
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU)
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    """The whole first component of a dotted module name."""
    return name.split(".")[0]


def test_top_level_matching_is_whole_name():
    assert _top("repro_torch.flow") == "repro_torch"
    assert _top("repro.flow") == "repro"
    assert _top("jax.numpy") == "jax"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path) if _top(m) in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_lm_slice_modules_are_checked():
    """The LM slice's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("configs/llama32_1b.py", "models/layers.py", "models/lm.py",
                "kernels/attention.py", "kernels/decode_attention.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_compile_without_device_needs_cuda():
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    serve = ShapeConfig("serve", "prefill", 64, 8)
    if torch.cuda.is_available():
        assert flow.compile("lenet5", serve).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            flow.compile("lenet5", serve)
