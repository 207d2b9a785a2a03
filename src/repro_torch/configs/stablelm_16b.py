"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352, LayerNorm, partial rotary 0.25, qkv bias.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, d_ff=5632, vocab_size=100352,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64,
                              causal=True, rope="partial", rope_base=10000.0,
                              rope_pct=0.25, qkv_bias=True),
    ffn_kind="swiglu", norm_kind="layernorm", norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=3, d_model=64, d_ff=176, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              causal=True, rope="partial", rope_pct=0.25,
                              qkv_bias=True),
    ffn_kind="swiglu", norm_kind="layernorm", norm_eps=1e-5,
)
