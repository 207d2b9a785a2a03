"""Graph builders for the LM-family architectures (all ten of the JAX
package's).

The decoder-only builder covers the dense family (llama3.2-1b, qwen1.5-4b,
phi4-mini-3.8b, stablelm-1.6b), the RG-LRU hybrid (recurrentgemma-2b), the
MoE family (deepseek-moe-16b, mixtral-8x7b), the RWKV6 recurrence
(rwkv6-7b) and the multimodal patch stub (llava-next-mistral-7b):
embedding, the projected patch embeddings in place of the first
positions, attention, RG-LRU or RWKV6 time-mix temporal mixing + GLU-FFN,
MoE or RWKV6 channel-mix layers, and the head.  The encoder-decoder
builder covers whisper-small: the frames stub, the non-causal encoder, and
a decoder with causal self-attention and cross-attention to the encoder's
output.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Block, Graph, ParamSpec as P
from repro_torch.models.layers import (emit_attention, emit_glu_ffn,
                                       emit_mlp_ffn, emit_moe_ffn,
                                       emit_rglru_block,
                                       emit_rwkv6_channelmix,
                                       emit_rwkv6_timemix)


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
        emit_rwkv6_timemix(b, cfg, cfg.recurrence, li)
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
    elif cfg.ffn_kind == "rwkv_cm":
        emit_rwkv6_channelmix(b, cfg, li)
    else:
        raise ValueError(cfg.ffn_kind)
    return b


def _with_dff(cfg: ModelConfig, d_ff: int) -> ModelConfig:
    return dataclasses.replace(cfg, d_ff=d_ff)


def build_decoder_graph(cfg: ModelConfig) -> Graph:
    """Decoder-only LM (the dense, hybrid, MoE, ssm and multimodal
    families)."""
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
    """Encoder-decoder (whisper).  The frontend is a stub: the batch's
    ``frames`` are the frame embeddings (B, encoder_seq, d_model).  The
    ``dec_embed`` op carries ``learned_pos`` as in the JAX package, whose
    embed op reads only ``sinusoid_pos``: the decoder sees positions
    through its causal mask alone, here as there."""
    blocks: list[Block] = []
    b = Block("enc_embed", "enc_embed")
    b.add("h", "frames_in", "h", encoder_seq=cfg.encoder_seq)  # + sinusoids
    blocks.append(b)
    enc_cfg = dataclasses.replace(cfg, norm_kind="layernorm")
    for li in range(cfg.n_encoder_layers):
        eb = Block(f"enc{li}", "encoder_layer", attrs={"index": li})
        a = dataclasses.replace(cfg.attention, causal=False, rope=None)
        emit_attention(eb, enc_cfg, a, li, prefix="enc_")
        emit_mlp_ffn(eb, enc_cfg, "gelu", bias=True, prefix="enc_")
        blocks.append(eb)
    fe = Block("enc_final", "enc_final", attrs={"captures_cross": True})
    fe.add("h", "norm", "h",
           params=[P("enc_fnorm_scale", (cfg.d_model,), ("d_model",), "ones"),
                   P("enc_fnorm_bias", (cfg.d_model,), ("d_model",), "zeros")],
           kind="layernorm", eps=cfg.norm_eps)
    blocks.append(fe)

    db = Block("dec_embed", "dec_embed")
    db.add("h", "embed", "h",
           params=[P("table", (cfg.padded_vocab, cfg.d_model),
                     ("vocab", "d_model"), "embed")],
           scale_by_sqrt_d=False, learned_pos=True, max_pos=cfg.max_seq_len)
    blocks.append(db)
    for li in range(cfg.n_layers):
        lb = Block(f"dec{li}", "decoder_layer", attrs={"index": li})
        a = dataclasses.replace(cfg.attention, rope=None)  # whisper: no rope
        emit_attention(lb, enc_cfg, a, li, prefix="dec_")
        emit_attention(lb, enc_cfg, a, li, prefix="xdec_", cross=True)
        emit_mlp_ffn(lb, enc_cfg, "gelu", bias=True, prefix="dec_")
        blocks.append(lb)
    blocks.append(_head_block(dataclasses.replace(cfg, norm_kind="layernorm",
                                                  tie_embeddings=True),
                              tied_ref="dec_embed/table"))
    g = Graph(cfg.name, blocks, meta={"config": cfg})
    g.validate()
    return g
