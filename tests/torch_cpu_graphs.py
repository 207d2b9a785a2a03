"""A stand-in for ``repro_torch.flow.graphs.StageGraphs`` on the CPU, where
no CUDA graph can be captured: it keeps the runner's contract, so the
stages' graph functions (static inputs, keys, in-place checks) run as they
would on the card.

The first call of a key runs ``first(fn(static))`` (its outputs on a
static buffer's storage copied, as the runner copies them; a ``pure``
stage's first result is fresh either way); a later call
refills the static inputs and runs ``fn(static)`` again, its tensors
copied out, as a replay hands them back.  ``calls`` counts each key's
calls: one key is one graph.
"""
import pytest
import torch
from torch.utils._pytree import tree_map_only

from repro_torch import flow as tflow
from repro_torch.flow import graphs


class CpuGraphs:
    def __init__(self, device):
        self.device = device
        self.static, self.calls = {}, {}
        self._held, self.stats = {}, {"held_bytes": 0}

    held = graphs.StageGraphs.held

    def run(self, key, inputs, fn, *, first=lambda f: f(), generator=None,
            pure=False):
        self.calls[key] = self.calls.get(key, 0) + 1
        if key in self.static:
            st = self.static[key]
            for name, x in inputs.items():
                graphs._fill(st[name], x)
            return tree_map_only(torch.Tensor, torch.clone, fn(st))
        st = {name: graphs._static(x, self.device)
              for name, x in inputs.items()}
        self.static[key] = st
        return graphs._unaliased(first(lambda: fn(st)), st)


def stage_keys(cm, stage):
    """The keys (graphs) of ``cm``'s stand-in for one stage."""
    return [k for k in cm.stage_graphs.calls if k[0] == stage]


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Every CPU model's stages on :class:`CpuGraphs` (outside
    ``disable_graphs()``)."""
    monkeypatch.setattr(graphs, "StageGraphs", CpuGraphs)
    monkeypatch.setattr(tflow.CompiledModel, "_on_graphs",
                        lambda self: graphs.graphs_enabled())
