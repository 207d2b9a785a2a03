"""The JAX package's training-loop integration cases
(``test_train_integration.py``) on the port, on the CPU: the loss falls (LM
and CNN), failure recovery, resume, compression trains; plus the trainer's
refusal of a mesh."""
import os
import time

import pytest

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticImages, SyntheticLM
from repro_torch.optim.adamw import AdamW
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

SMOKE = ShapeConfig("smoke", "train", 16, 2)


def _setup(arch="llama3.2-1b", plan=False, **flow_kw):
    cm = tflow.compile(arch, SMOKE, FlowConfig(mode="folded", **flow_kw),
                       smoke=True, device="cpu")
    return cm.cfg, (cm.plan if plan else cm)


def _lm_data(cfg):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=8))


def test_loss_decreases_lm():
    cfg, cm = _setup()
    tr = Trainer(cm, AdamW(lr=3e-3, warmup_steps=5, total_steps=60),
                 TrainerConfig(steps=60, log_every=5))
    _, _, hist = tr.fit(_lm_data(cfg), 0)
    first, last = hist[0][1], hist[-1][1]
    assert last < first - 0.3, hist


def test_loss_decreases_cnn():
    """LeNet-5, built from its plan (the trainer takes the plan's CPU)."""
    cfg, plan = _setup("lenet5", plan=True)
    data = SyntheticImages(DataConfig(vocab_size=10, seq_len=0,
                                      global_batch=16),
                           cfg.image_size, cfg.image_channels, 10)
    tr = Trainer(plan, AdamW(lr=1e-3, warmup_steps=5, total_steps=40),
                 TrainerConfig(steps=40, log_every=5))
    assert tr.device.type == "cpu"
    _, _, hist = tr.fit(data, 0)
    assert hist[-1][1] < hist[0][1] - 0.2, hist


def test_failure_recovery(tmp_path):
    """Inject a node failure mid-run; the trainer must restore from the last
    checkpoint and still reach the target step count."""
    cfg, cm = _setup()
    tr = Trainer(cm, AdamW(lr=1e-3),
                 TrainerConfig(steps=30, ckpt_dir=str(tmp_path),
                               ckpt_every=10, fail_at_step=17, log_every=5))
    params, _, hist = tr.fit(_lm_data(cfg), 0)
    assert tr._restarts == 1
    assert max(s for s, _ in hist) >= 25
    assert ckpt_lib.latest_step(str(tmp_path)) == 30
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000010", "step_00000020", "step_00000030"]


def test_resume_from_checkpoint(tmp_path):
    """A second fit() resumes at the saved step, not from scratch."""
    cfg, cm = _setup()
    t1 = Trainer(cm, AdamW(lr=1e-3),
                 TrainerConfig(steps=10, ckpt_dir=str(tmp_path),
                               ckpt_every=5))
    t1.fit(_lm_data(cfg), 0)
    t2 = Trainer(cm, AdamW(lr=1e-3),
                 TrainerConfig(steps=12, ckpt_dir=str(tmp_path),
                               ckpt_every=5, log_every=1))
    _, opt_state, hist = t2.fit(_lm_data(cfg), 0)
    assert [s for s, _ in hist] == [10, 11]       # resumed past step 10
    assert int(opt_state.step) == 12


def test_gradient_compression_trains():
    cfg, cm = _setup()
    tr = Trainer(cm, AdamW(lr=3e-3, compress="int8_ef", warmup_steps=5,
                           total_steps=40),
                 TrainerConfig(steps=40, log_every=5))
    _, opt_state, hist = tr.fit(_lm_data(cfg), 0)
    assert opt_state.err is not None
    assert hist[-1][1] < hist[0][1] - 0.2, hist


def test_async_checkpoints_resume(tmp_path):
    """Saves on a thread: the last checkpoint lands."""
    cfg, cm = _setup()
    Trainer(cm, AdamW(lr=1e-3),
            TrainerConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
                          async_ckpt=True)).fit(_lm_data(cfg), 0)
    for _ in range(100):
        if ckpt_lib.latest_step(str(tmp_path)) == 6:
            break
        time.sleep(0.05)
    assert ckpt_lib.latest_step(str(tmp_path)) == 6


def test_mesh_and_rules_are_not_ported():
    """``Trainer(mesh=)`` and ``Trainer(rules=)`` train on a mesh: on a
    one-rank one the parameters are DTensors and three steps give the
    unsharded trainer's losses (four ranks in ``tests/test_torch_mesh.py``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.flow import _rules_for
    cfg, cm = _setup()
    mesh = MeshSpec((("data", 1), ("model", 1))).build("cpu")
    rules = _rules_for(mesh, cm.flow)
    tcfg = TrainerConfig(steps=3, log_every=1)
    _, _, want = Trainer(cm, AdamW(lr=3e-3, warmup_steps=1), tcfg).fit(
        _lm_data(cfg), 0)
    for kw in (dict(mesh=mesh), dict(rules=rules)):
        tr = Trainer(cm, AdamW(lr=3e-3, warmup_steps=1), tcfg, **kw)
        params, _, got = tr.fit(_lm_data(cfg), 0)
        assert isinstance(params["head"]["final_norm_scale"], DTensor)
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert abs(a - b) <= 1e-5 * abs(b)