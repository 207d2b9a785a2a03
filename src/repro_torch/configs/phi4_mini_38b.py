"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE (partial 0.75) SwiGLU GQA.  [arXiv:2412.08905]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, d_ff=8192, vocab_size=200064,
    attention=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=128,
                              causal=True, rope="partial", rope_base=10000.0,
                              rope_pct=0.75),
    ffn_kind="swiglu", norm_kind="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=3, d_model=48, d_ff=128, vocab_size=256,
    attention=AttentionConfig(n_heads=3, n_kv_heads=1, head_dim=16,
                              causal=True, rope="partial", rope_pct=0.75),
    ffn_kind="swiglu", norm_kind="rmsnorm", tie_embeddings=True,
)
