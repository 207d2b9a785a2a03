"""Micro-op emitters for the standard layer families.

These functions append micro-ops to a :class:`~repro.core.graph.Block`.  They
emit the *unoptimized* op-level program (separate matmul / bias / activation /
norm ops) — the paper's "base" kernels.  The fusion pass later rewrites these
into fused ops, exactly as the paper fuses activation/batch-norm loops into
convolution loops.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, RecurrenceConfig
from repro_torch.core.graph import Block, ParamSpec as P


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------

def emit_attention(b: Block, cfg: ModelConfig, a: AttentionConfig, li: int,
                   prefix: str = "", x: str = "h", cross: bool = False) -> None:
    d = cfg.d_model
    H, KV, Dh = a.n_heads, a.n_kv_heads, a.head_dim
    pn = lambda s: f"{prefix}{s}"

    b.add("an", "norm", x,
          params=[P(pn("attn_norm_scale"), (d,), ("d_model",), "ones")] +
                 ([P(pn("attn_norm_bias"), (d,), ("d_model",), "zeros")]
                  if cfg.norm_kind == "layernorm" else []),
          kind=cfg.norm_kind, eps=cfg.norm_eps)

    b.add("q", "matmul", "an", params=[P(pn("wq"), (d, H * Dh), ("d_model", "heads"))])
    kv_src = "cross" if cross else "an"
    b.add("k", "matmul", kv_src, params=[P(pn("wk"), (d, KV * Dh), ("d_model", "heads"))])
    b.add("v", "matmul", kv_src, params=[P(pn("wv"), (d, KV * Dh), ("d_model", "heads"))])
    if a.qkv_bias:
        b.add("q", "bias_add", "q", params=[P(pn("bq"), (H * Dh,), ("heads",), "zeros")])
        b.add("k", "bias_add", "k", params=[P(pn("bk"), (KV * Dh,), ("heads",), "zeros")])
        b.add("v", "bias_add", "v", params=[P(pn("bv"), (KV * Dh,), ("heads",), "zeros")])

    b.add("qh", "split_heads", "q", n=H, dh=Dh)
    b.add("kh", "split_heads", "k", n=KV, dh=Dh)
    b.add("vh", "split_heads", "v", n=KV, dh=Dh)

    if a.rope and not cross:
        rd = int(Dh * a.rope_pct)
        b.add("qh", "rope", "qh", "positions", base=a.rope_base, rot_dim=rd)
        b.add("kh", "rope", "kh", "positions", base=a.rope_base, rot_dim=rd)

    # bidirectional (encoder) self-attention has no decode step -> stateless
    skey = None
    if cross:
        skey = f"{prefix}xkv{li}"
    elif a.causal:
        skey = f"{prefix}kv{li}"
    b.add("ao", "attention", "qh", "kh", "vh", "positions",
          causal=a.causal and not cross, window=a.window,
          softcap=a.logits_softcap, state_key=skey, cross=cross)
    b.add("am", "merge_heads", "ao")
    b.add("aout", "matmul", "am",
          params=[P(pn("wo"), (H * Dh, d), ("heads_in", "d_model"))])
    if a.out_bias:
        b.add("aout", "bias_add", "aout", params=[P(pn("bo"), (d,), ("d_model",), "zeros")])
    b.add("h", "add", x, "aout")


# ---------------------------------------------------------------------------
# FFN sub-blocks
# ---------------------------------------------------------------------------

def emit_glu_ffn(b: Block, cfg: ModelConfig, act: str, prefix: str = "") -> None:
    d, f = cfg.d_model, cfg.d_ff
    pn = lambda s: f"{prefix}{s}"
    b.add("fn", "norm", "h",
          params=[P(pn("ffn_norm_scale"), (d,), ("d_model",), "ones")] +
                 ([P(pn("ffn_norm_bias"), (d,), ("d_model",), "zeros")]
                  if cfg.norm_kind == "layernorm" else []),
          kind=cfg.norm_kind, eps=cfg.norm_eps)
    b.add("g", "matmul", "fn", params=[P(pn("w_gate"), (d, f), ("d_model", "d_ff"))])
    b.add("ga", "act", "g", kind=act)
    b.add("u", "matmul", "fn", params=[P(pn("w_up"), (d, f), ("d_model", "d_ff"))])
    b.add("gu", "mul", "ga", "u")
    b.add("fo", "matmul", "gu", params=[P(pn("w_down"), (f, d), ("d_ff", "d_model"))])
    b.add("h", "add", "h", "fo")


def emit_mlp_ffn(b: Block, cfg: ModelConfig, act: str = "gelu",
                 bias: bool = False, prefix: str = "") -> None:
    d, f = cfg.d_model, cfg.d_ff
    pn = lambda s: f"{prefix}{s}"
    b.add("fn", "norm", "h",
          params=[P(pn("ffn_norm_scale"), (d,), ("d_model",), "ones")] +
                 ([P(pn("ffn_norm_bias"), (d,), ("d_model",), "zeros")]
                  if cfg.norm_kind == "layernorm" else []),
          kind=cfg.norm_kind, eps=cfg.norm_eps)
    b.add("u", "matmul", "fn", params=[P(pn("w_up"), (d, f), ("d_model", "d_ff"))])
    if bias:
        b.add("u", "bias_add", "u", params=[P(pn("b_up"), (f,), ("d_ff",), "zeros")])
    b.add("ua", "act", "u", kind=act)
    b.add("fo", "matmul", "ua", params=[P(pn("w_down"), (f, d), ("d_ff", "d_model"))])
    if bias:
        b.add("fo", "bias_add", "fo", params=[P(pn("b_down"), (d,), ("d_model",), "zeros")])
    b.add("h", "add", "h", "fo")


def emit_moe_ffn(b: Block, cfg: ModelConfig, m: MoEConfig, prefix: str = "") -> None:
    d = cfg.d_model
    E, fe = m.num_experts, m.d_expert
    pn = lambda s: f"{prefix}{s}"
    b.add("fn", "norm", "h",
          params=[P(pn("ffn_norm_scale"), (d,), ("d_model",), "ones")],
          kind=cfg.norm_kind, eps=cfg.norm_eps)
    params = [
        P(pn("router"), (d, E), ("d_model", "expert")),
        P(pn("we_gate"), (E, d, fe), ("expert", "d_model", "d_ff")),
        P(pn("we_up"), (E, d, fe), ("expert", "d_model", "d_ff")),
        P(pn("we_down"), (E, fe, d), ("expert", "d_ff", "d_model")),
    ]
    if m.num_shared:
        fs = m.d_shared_eff * m.num_shared
        params += [
            P(pn("ws_gate"), (d, fs), ("d_model", "d_ff")),
            P(pn("ws_up"), (d, fs), ("d_model", "d_ff")),
            P(pn("ws_down"), (fs, d), ("d_ff", "d_model")),
        ]
    b.add("mo", "moe_ffn", "fn", params=params,
          top_k=m.top_k, num_experts=E, num_shared=m.num_shared,
          capacity_factor=m.capacity_factor, act="silu",
          aux_weight=m.router_aux_weight)
    b.add("h", "add", "h", "mo")


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def emit_rglru_block(b: Block, cfg: ModelConfig, r: RecurrenceConfig, li: int,
                     prefix: str = "") -> None:
    d, w = cfg.d_model, r.width
    nb = max(1, cfg.attention.n_heads if cfg.attention else 1)  # gate blocks
    pn = lambda s: f"{prefix}{s}"
    b.add("rn", "norm", "h",
          params=[P(pn("rec_norm_scale"), (d,), ("d_model",), "ones")],
          kind=cfg.norm_kind, eps=cfg.norm_eps)
    # two branches: gate (GeLU) and recurrent
    b.add("gy", "matmul", "rn", params=[P(pn("w_gate_br"), (d, w), ("d_model", "d_ff"))])
    b.add("gy", "act", "gy", kind="gelu")
    b.add("rx", "matmul", "rn", params=[P(pn("w_rec_br"), (d, w), ("d_model", "d_ff"))])
    b.add("rc", "conv1d_causal", "rx",
          params=[P(pn("conv_w"), (r.conv_width, w), ("conv_k", "d_ff")),
                  P(pn("conv_b"), (w,), ("d_ff",), "zeros")],
          width=r.conv_width, state_key=f"{prefix}conv{li}")
    b.add("rl", "rg_lru", "rc",
          params=[P(pn("lru_lambda"), (w,), ("d_ff",), "lru_lambda"),
                  P(pn("lru_wa"), (nb, w // nb, w // nb), ("heads", "d_ff", "d_ff"),
                    init_scale=(w // nb) ** -0.5),
                  P(pn("lru_ba"), (w,), ("d_ff",), "zeros"),
                  P(pn("lru_wx"), (nb, w // nb, w // nb), ("heads", "d_ff", "d_ff"),
                    init_scale=(w // nb) ** -0.5),
                  P(pn("lru_bx"), (w,), ("d_ff",), "zeros")],
          n_blocks=nb, c=8.0, state_key=f"{prefix}lru{li}")
    b.add("rg", "mul", "rl", "gy")
    b.add("ro", "matmul", "rg", params=[P(pn("w_rec_out"), (w, d), ("d_ff", "d_model"))])
    b.add("h", "add", "h", "ro")


# ---------------------------------------------------------------------------
# RWKV6 (Finch) blocks
# ---------------------------------------------------------------------------

def emit_rwkv6_timemix(b: Block, cfg: ModelConfig, r: RecurrenceConfig, li: int,
                       prefix: str = "") -> None:
    d = cfg.d_model
    H, dh = r.n_heads, r.head_dim
    rank = r.lora_rank
    pn = lambda s: f"{prefix}{s}"
    b.add("tn", "norm", "h",
          params=[P(pn("tm_norm_scale"), (d,), ("d_model",), "ones"),
                  P(pn("tm_norm_bias"), (d,), ("d_model",), "zeros")],
          kind="layernorm", eps=1e-5)
    b.add("tm", "rwkv6_timemix", "tn",
          params=[
              # token-shift base mixes (one per r,k,v,w,g channel set)
              P(pn("mu_base"), (5, d), ("none", "d_model"), "rwkv_mix"),
              # data-dependent mix LoRA: d -> 5*rank -> 5*d
              P(pn("mu_lora_a"), (d, 5 * rank), ("d_model", "lora"), init_scale=1e-2),
              P(pn("mu_lora_b"), (5, rank, d), ("none", "lora", "d_model"), "zeros"),
              # projections
              P(pn("w_r"), (d, H * dh), ("d_model", "heads")),
              P(pn("w_k"), (d, H * dh), ("d_model", "heads")),
              P(pn("w_v"), (d, H * dh), ("d_model", "heads")),
              P(pn("w_g"), (d, H * dh), ("d_model", "heads")),
              # data-dependent decay: w0 + lora
              P(pn("decay_base"), (H * dh,), ("heads",), "rwkv_decay"),
              P(pn("decay_lora_a"), (d, rank), ("d_model", "lora"), init_scale=1e-2),
              P(pn("decay_lora_b"), (rank, H * dh), ("lora", "heads"), "zeros"),
              # per-channel bonus u
              P(pn("bonus"), (H * dh,), ("heads",), "rwkv_decay"),
              # per-head group-norm + output
              P(pn("ln_x_scale"), (H * dh,), ("heads",), "ones"),
              P(pn("ln_x_bias"), (H * dh,), ("heads",), "zeros"),
              P(pn("w_o"), (H * dh, d), ("heads_in", "d_model")),
          ],
          n_heads=H, head_dim=dh, lora_rank=rank,
          state_key=f"{prefix}wkv{li}")
    b.add("h", "add", "h", "tm")


def emit_rwkv6_channelmix(b: Block, cfg: ModelConfig, li: int, prefix: str = "") -> None:
    d, f = cfg.d_model, cfg.d_ff
    pn = lambda s: f"{prefix}{s}"
    b.add("cn", "norm", "h",
          params=[P(pn("cm_norm_scale"), (d,), ("d_model",), "ones"),
                  P(pn("cm_norm_bias"), (d,), ("d_model",), "zeros")],
          kind="layernorm", eps=1e-5)
    b.add("cm", "rwkv6_channelmix", "cn",
          params=[P(pn("cm_mu"), (2, d), ("none", "d_model"), "rwkv_mix"),
                  P(pn("cw_r"), (d, d), ("d_model", "d_model")),
                  P(pn("cw_k"), (d, f), ("d_model", "d_ff")),
                  P(pn("cw_v"), (f, d), ("d_ff", "d_model"))],
          state_key=f"{prefix}cm{li}")
    b.add("h", "add", "h", "cm")
