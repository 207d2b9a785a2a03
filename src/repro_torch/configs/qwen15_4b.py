"""qwen1.5-4b [dense] — 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-4B]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, d_ff=6912, vocab_size=151936,
    attention=AttentionConfig(n_heads=20, n_kv_heads=20, head_dim=128,
                              causal=True, rope="default", rope_base=1e6,
                              qkv_bias=True),
    ffn_kind="swiglu", norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=3, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              causal=True, rope="default", qkv_bias=True),
    ffn_kind="swiglu", norm_kind="rmsnorm",
)
