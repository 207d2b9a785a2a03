"""Graph builders for the LM-family architectures.

The port builds the decoder-only dense family (llama3.2-1b, qwen1.5-4b,
phi4-mini-3.8b, stablelm-1.6b), the RG-LRU hybrid (recurrentgemma-2b), the
MoE family (deepseek-moe-16b, mixtral-8x7b) and the multimodal patch stub
(llava-next-mistral-7b): embedding, the projected patch embeddings in
place of the first positions, attention or RG-LRU temporal mixing +
GLU-FFN or MoE layers, and the head.  RWKV6 layers and the
encoder-decoder builder (whisper) arrive with their families (ROADMAP
Queue 1, "Other model families").  Each raises NotImplementedError naming
what is missing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Block, Graph, ParamSpec as P
from repro_torch.models.layers import (emit_attention, emit_glu_ffn,
                                       emit_mlp_ffn, emit_moe_ffn,
                                       emit_rglru_block)


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
    elif kind == "rec" and cfg.recurrence.kind == "rg_lru":
        emit_rglru_block(b, cfg, cfg.recurrence, li)
    elif kind == "rec":
        raise NotImplementedError(
            f"{cfg.name}: recurrent layers ({cfg.recurrence.kind}) are not "
            "ported yet (ROADMAP Queue 1, \"Other model families\")")
    else:
        raise ValueError(kind)
    # channel mixing
    if cfg.ffn_kind == "moe" and li >= cfg.moe.first_dense_layers:
        emit_moe_ffn(b, cfg, cfg.moe)
    elif cfg.ffn_kind == "moe":
        # leading dense layers of a MoE model (deepseek-moe layer 0)
        emit_glu_ffn(b, _with_dff(cfg, cfg.moe.first_dense_d_ff), "silu")
    elif cfg.ffn_kind == "swiglu":
        emit_glu_ffn(b, cfg, "silu")
    elif cfg.ffn_kind == "geglu":
        emit_glu_ffn(b, cfg, "gelu")
    elif cfg.ffn_kind == "gelu_mlp":
        emit_mlp_ffn(b, cfg, "gelu", bias=cfg.family == "audio")
    else:
        raise NotImplementedError(
            f"{cfg.name}: ffn kind {cfg.ffn_kind!r} is not ported yet "
            "(ROADMAP Queue 1, \"Other model families\")")
    return b


def _with_dff(cfg: ModelConfig, d_ff: int) -> ModelConfig:
    return dataclasses.replace(cfg, d_ff=d_ff)


def build_decoder_graph(cfg: ModelConfig) -> Graph:
    """Decoder-only LM (the dense, hybrid, MoE and multimodal families)."""
    blocks = [_embed_block(cfg, scale=cfg.family == "hybrid")]
    if cfg.n_patch_tokens:
        # multimodal stub: project precomputed patch embeddings and prepend.
        b = Block("mm_project", "mm")
        d_vis = cfg.d_vision
        b.add("p1", "patch_proj", "h",
              params=[P("mm_w1", (d_vis, cfg.d_model), ("none", "d_model")),
                      P("mm_b1", (cfg.d_model,), ("d_model",), "zeros"),
                      P("mm_w2", (cfg.d_model, cfg.d_model),
                        ("d_model", "d_model")),
                      P("mm_b2", (cfg.d_model,), ("d_model",), "zeros")],
              n_patches=cfg.n_patch_tokens, d_vision=d_vis)
        b.add("h", "identity", "p1")
        blocks.append(b)
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
        "(ROADMAP Queue 1, \"Other model families\")")
