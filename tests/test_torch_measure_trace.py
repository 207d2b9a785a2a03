"""``CompiledModel.measure(..., trace_dir=)``: the timed loop under
``torch.profiler``, its Chrome trace written into ``trace_dir`` (the
counterpart of the JAX package's ``jax.profiler.trace`` around its timed
loop, ``src/repro/flow/__init__.py``).

On smoke llama3.2-1b and LeNet-5 on the CPU, ``iters=2``: exactly one trace
file, which loads as JSON and holds exactly ``iters`` ``measure.step``
annotations (the warm-up call stays outside the profiled window); the
record's keys are a plain run's plus ``trace``; without ``trace_dir`` no
file is written.  Counts only, no tolerance: a CPU run says nothing of
device time.
"""
import inspect
import json
import os

import pytest

from repro import flow as jflow
from repro_torch import flow
from repro_torch.configs.base import ShapeConfig

CELLS = [("llama3.2-1b", "prefill"), ("llama3.2-1b", "decode"),
         ("llama3.2-1b", "train"), ("lenet5", "prefill"),
         ("lenet5", "train")]


def _model(arch, stage):
    kind = "train" if stage == "train" else "decode"
    return flow.compile(arch, ShapeConfig("s", kind, 16, 2), smoke=True,
                        device="cpu")


def _steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "measure.step"
            and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("arch,stage", CELLS)
def test_measure_writes_one_trace_of_the_timed_calls(arch, stage, tmp_path):
    cm = _model(arch, stage)
    out = tmp_path / "traces"
    rec = cm.measure(stage, iters=2, trace_dir=str(out))
    assert os.listdir(out) == [f"measure_{stage}.json"]
    assert rec["trace"] == str(out / f"measure_{stage}.json")
    assert len(_steps(rec["trace"])) == 2
    plain = cm.measure(stage, iters=2)
    assert set(rec) - {"trace"} == set(plain) and "trace" not in plain
    assert rec["iters"] == plain["iters"] == 2


def test_measure_without_trace_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cm = _model("llama3.2-1b", "prefill")
    rec = cm.measure("prefill", iters=2)
    assert os.listdir(tmp_path) == [] and "trace" not in rec


def test_measure_takes_the_jax_packages_arguments():
    """The port's ``measure`` takes every argument of JAX's (``params``
    and ``iters``'s default of 10 are the port's own)."""
    want = inspect.signature(jflow.CompiledModel.measure).parameters
    got = inspect.signature(flow.CompiledModel.measure).parameters
    assert set(want) <= set(got)
    assert got["trace_dir"].default is None
    assert got["trace_dir"].kind == inspect.Parameter.KEYWORD_ONLY
