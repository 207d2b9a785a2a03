"""Training through the port's entry points on the CPU: ``train_step``
then ``generate`` on the same ``CompiledModel`` (the JAX package's
``test_train_step_and_generate_roundtrip``), ``measure("train")``, the
training CLI, and a train step through the kernel wrappers under
``backend="cuda"``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from conftest import relerr
from repro_torch.core import ops_impl
from repro_torch.kernels.registry import DISPATCH_REJECTIONS
from repro_torch.launch import train as train_cli
from repro_torch.obs import METRICS
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train.trainer import _grads

SMOKE = ShapeConfig("smoke", "train", 16, 2)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16))),
            "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))}


def test_train_step_and_generate_roundtrip():
    cm = tflow.compile("llama3.2-1b", SMOKE, smoke=True, device="cpu")
    params = cm.init_params(0)
    opt = AdamW(lr=1e-3, warmup_steps=0)
    step = cm.train_step(opt)
    # cached per optimizer value: an equal one shares the step
    assert cm.train_step(AdamW(lr=1e-3, warmup_steps=0)) is step
    assert cm.train_step(AdamW(lr=2e-3, warmup_steps=0)) is not step
    assert cm.train_step(opt, microbatches=2) is not step
    batch = _batch(cm.cfg)
    st = opt.init(params)
    params, st, m = step(params, st, batch)
    params, st, metrics = step(params, st, batch)
    assert torch.isfinite(metrics["loss"]) and int(st.step) == 2
    assert "train_step[mb=1]" in cm.stats["stages"]
    prompt = {"tokens": batch["tokens"][:, :8]}
    toks, _ = cm.generate(params, prompt, steps=4)
    assert toks.shape == (2, 4)
    assert torch.equal(toks, cm.generate_fori(params, prompt, steps=4))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "lenet5"])
def test_measure_train_on_the_cpu(arch):
    cm = tflow.compile(arch, SMOKE, smoke=True, device="cpu")
    rec = cm.measure("train", iters=2)
    assert rec["stage"] == "train" and rec["device"] == "cpu"
    assert rec["timer"] == "wall_clock" and rec["peak_bytes"] is None
    assert rec["iters"] == 2 and rec["measured_step_s"] > 0
    rate = "images_per_s" if arch == "lenet5" else "tokens_per_s"
    want = 2 if arch == "lenet5" else 2 * 16
    assert rec[rate] == pytest.approx(want / rec["measured_step_s"])
    assert cm.measure(iters=1)["stage"] == "train"     # the shape's kind
    serve = tflow.compile(arch, ShapeConfig("s", "prefill", 16, 2),
                          smoke=True, device="cpu")
    with pytest.raises(ValueError, match="train-kind"):
        serve.measure("train")


def test_train_cli_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split()[-1]) for line in out.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "kernels: backend=auto" in out.stdout
    assert os.path.isdir(tmp_path / "step_00000003")


def test_train_cli_autotune_prints_its_dse_line(capsys):
    """``--autotune`` searches the train cell's design space and trains
    the winner: the search's report and the plan's ``dse:`` line."""
    train_cli.main(["--smoke", "--device", "cpu", "--autotune", "--steps",
                    "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "dse[llama3.2-1b x cli]" in out
    dse_line = [x for x in out.splitlines() if x.startswith("  dse: best=")]
    assert len(dse_line) == 1 and "validated=1" in dse_line[0]
    losses = [float(x.split()[-1]) for x in out.splitlines()
              if x.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def _dispatched(monkeypatch):
    """Spy on the op layer's dispatch: the ops that got a kernel wrapper."""
    got = {}
    real = ops_impl.plan_kernel

    def spy(plan, op, **facts):
        kern = real(plan, op, **facts)
        if kern is not None:
            got[op] = got.get(op, 0) + 1
        return kern
    monkeypatch.setattr(ops_impl, "plan_kernel", spy)
    return got


def test_train_step_runs_the_kernels_with_the_reference_gradients(
        monkeypatch):
    """Under backend="cuda" a CPU model's plan resolves matmul and attention
    to the kernels (whose wrappers run their plain versions on CPU
    tensors): a train step's forward calls each wrapper, with no dispatch
    rejection, and in fp32 its loss and gradients are the reference
    backend's (the backward recomputes the reference op); a prefill
    dispatches the same ops, and the ``kernels:`` line stays."""
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm = tflow.compile("llama3.2-1b", SMOKE, f32, smoke=True, device="cpu",
                       backend="cuda")
    ref = tflow.compile("llama3.2-1b", SMOKE, f32, smoke=True, device="cpu",
                        backend="reference")
    assert {cm.plan.kernels[o] for o in ("matmul", "glu_matmul",
                                         "attention")} == {"cuda"}
    line = cm.describe().splitlines()[-1]
    assert line.strip().startswith("kernels: backend=cuda")
    params = cm.init_params(0)
    batch = _batch(cm.cfg)
    DISPATCH_REJECTIONS.clear()
    n0 = METRICS.counter("kernels.dispatch.rejections").value
    got = _dispatched(monkeypatch)
    loss, _, grads = _grads(cm.loss_fn, params, batch)
    assert set(got) == {"matmul", "glu_matmul", "attention"}
    # the block remat recomputes each layer once in the backward pass
    assert got["attention"] == 2 * cm.cfg.n_layers
    assert DISPATCH_REJECTIONS == {}
    assert METRICS.counter("kernels.dispatch.rejections").value == n0
    got.clear()
    want_loss, _, want = _grads(ref.loss_fn, params, batch)
    assert got == {}
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    assert max(relerr(a, b) for a, b in
               zip(tree_leaves(grads), tree_leaves(want))) < 1e-6
    cm.prefill(params, {"tokens": batch["tokens"]})
    assert set(got) == {"matmul", "glu_matmul", "attention"}
    assert cm.describe().splitlines()[-1] == line
