"""Graph builders for the LM-family architectures.

The port builds the decoder-only dense family (llama3.2-1b): embedding,
attention + GLU-FFN layers, and the head.  Recurrent and MoE layers and the
multimodal patch stub arrive with their families; the encoder-decoder
builder (whisper) with ROADMAP Queue 1 item 12.  Each raises
NotImplementedError naming what is missing.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Block, Graph, ParamSpec as P
from repro_torch.models.layers import emit_attention, emit_glu_ffn, emit_mlp_ffn


def _embed_block(cfg: ModelConfig, scale: bool) -> Block:
    b = Block("embed", "embed")
    b.add("h", "embed", "h",
          params=[P("table", (cfg.padded_vocab, cfg.d_model), ("vocab", "d_model"),
                    "embed")],
          scale_by_sqrt_d=scale)
    return b


def _head_block(cfg: ModelConfig, tied_ref: str = "embed/table") -> Block:
    b = Block("head", "head")
    params = [P("final_norm_scale", (cfg.d_model,), ("d_model",), "ones")]
    if cfg.norm_kind == "layernorm":
        params.append(P("final_norm_bias", (cfg.d_model,), ("d_model",), "zeros"))
    b.add("hn", "norm", "h", params=params, kind=cfg.norm_kind, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        b.add("h", "unembed", "hn", tied=tied_ref,
              true_vocab=cfg.vocab_size)
    else:
        b.add("h", "unembed", "hn",
              params=[P("lm_head", (cfg.padded_vocab, cfg.d_model),
                        ("vocab", "d_model"), "embed")],
              true_vocab=cfg.vocab_size)
    return b


def _decoder_layer(cfg: ModelConfig, li: int, kind: str) -> Block:
    b = Block(f"layer{li}", "layer", attrs={"index": li, "mix": kind})
    # temporal mixing
    if kind in ("attn", "local_attn"):
        emit_attention(b, cfg, cfg.attention, li)
    elif kind == "rec":
        raise NotImplementedError(
            f"{cfg.name}: recurrent layers ({cfg.recurrence.kind}) are not "
            "ported yet (ROADMAP Queue 1, item 12)")
    else:
        raise ValueError(kind)
    # channel mixing
    if cfg.ffn_kind == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1, "
            "item 12)")
    if cfg.ffn_kind == "swiglu":
        emit_glu_ffn(b, cfg, "silu")
    elif cfg.ffn_kind == "geglu":
        emit_glu_ffn(b, cfg, "gelu")
    elif cfg.ffn_kind == "gelu_mlp":
        emit_mlp_ffn(b, cfg, "gelu", bias=cfg.family == "audio")
    else:
        raise NotImplementedError(
            f"{cfg.name}: ffn kind {cfg.ffn_kind!r} is not ported yet "
            "(ROADMAP Queue 1, item 12)")
    return b


def build_decoder_graph(cfg: ModelConfig) -> Graph:
    """Decoder-only LM (the dense family)."""
    if cfg.n_patch_tokens:
        raise NotImplementedError(
            f"{cfg.name}: multimodal patch tokens are not ported yet "
            "(ROADMAP Queue 1, item 12)")
    blocks = [_embed_block(cfg, scale=cfg.family == "hybrid")]
    for li, kind in enumerate(cfg.layer_kinds):
        blocks.append(_decoder_layer(cfg, li, kind))
    blocks.append(_head_block(cfg))
    g = Graph(cfg.name, blocks, meta={"config": cfg})
    g.validate()
    return g


def build_encdec_graph(cfg: ModelConfig) -> Graph:
    """Encoder-decoder (whisper): not ported yet."""
    raise NotImplementedError(
        f"{cfg.name}: the encoder-decoder graph (whisper) is not ported yet "
        "(ROADMAP Queue 1, item 12)")
