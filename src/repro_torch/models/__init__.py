"""Graph construction by model family.  The port builds the paper's CNNs; the
other families arrive with their slices (ROADMAP Queue 1, items 5 and 12)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Graph


def build_graph(cfg: ModelConfig) -> Graph:
    if cfg.family == "cnn":
        from repro_torch.models.cnn import build_cnn_graph
        return build_cnn_graph(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet; the port builds "
        "the CNN family (see ROADMAP Queue 1)")
