"""The port's examples (``examples/torch/*.py``, the JAX package's four
examples on ``repro_torch``) run at smoke size on the CPU, each within
60 s, and print what they promise."""
import importlib.util
import os
import time

import pytest
import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "examples", "torch")
RUNS = {
    "quickstart": ([], ("train step: loss=", "generated: ")),
    "paper_cnns": ([], ("lenet5 (batch 16", "resnet34 (batch 2",
                        "speedup:")),
    "serve_lm": (["--batch", "2", "--prompt-len", "8", "--steps", "4"],
                 ("host loop:", "serving[4 req]")),
    "train_lm": (["--steps", "4", "--batch", "2", "--seq", "16"],
                 ("step     3  loss", "checkpoints in")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_at_smoke_size(name, capsys):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv, expect = RUNS[name]
    # one intra-op thread: beside the suite's other workers, a CPU conv
    # on every core of the machine is the slow way
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        mod.main(["--device", "cpu", "--smoke", *argv])
    finally:
        took = time.perf_counter() - t0
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert took < 60, took
    for s in expect:
        assert s in out, (s, out[-2000:])
