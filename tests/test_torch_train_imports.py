"""The training slice's modules are among the files the import-hygiene
test checks, and the training CLI runs on the card unless told
otherwise."""
import pytest
import torch

from test_torch_imports import FILES, ROOT


def test_training_slice_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("data/pipeline.py", "optim/adamw.py", "train/checkpoint.py",
                "train/trainer.py", "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_train_cli_without_device_needs_cuda():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
