"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, d_ff=8192, vocab_size=128256,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=64,
                              causal=True, rope="default", rope_base=500000.0),
    ffn_kind="swiglu", norm_kind="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=3, d_model=64, d_ff=192, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              causal=True, rope="default"),
    ffn_kind="swiglu", norm_kind="rmsnorm", tie_embeddings=True,
)
