"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000.
Layer pattern (rec, rec, attn) repeating — 26 = 8x(R,R,A) + (R,R).
[arXiv:2402.19427]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RecurrenceConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, d_ff=7680, vocab_size=256000,
    attention=AttentionConfig(n_heads=10, n_kv_heads=1, head_dim=256,
                              causal=True, window=2048, rope="default",
                              rope_base=10000.0),
    recurrence=RecurrenceConfig(kind="rg_lru", width=2560, conv_width=4),
    layer_pattern=("rec", "rec", "attn"),
    ffn_kind="geglu", norm_kind="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=6, d_model=64, d_ff=192, vocab_size=256,
    attention=AttentionConfig(n_heads=2, n_kv_heads=1, head_dim=32,
                              causal=True, window=16, rope="default"),
    recurrence=RecurrenceConfig(kind="rg_lru", width=64, conv_width=4),
    layer_pattern=("rec", "rec", "attn"),
    ffn_kind="geglu", norm_kind="rmsnorm", tie_embeddings=True,
)
