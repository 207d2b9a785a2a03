"""Graph construction by model family: the paper's CNNs, the decoder-only
LMs and the encoder-decoder (whisper)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Graph


def build_graph(cfg: ModelConfig) -> Graph:
    if cfg.family == "cnn":
        from repro_torch.models.cnn import build_cnn_graph
        return build_cnn_graph(cfg)
    from repro_torch.models.lm import build_decoder_graph, build_encdec_graph
    if cfg.n_encoder_layers:
        return build_encdec_graph(cfg)
    return build_decoder_graph(cfg)
