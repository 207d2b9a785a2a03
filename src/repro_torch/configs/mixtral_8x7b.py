"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2; sliding-window attention 4096.
[arXiv:2401.04088]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, d_ff=14336, vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              causal=True, window=4096, rope="default",
                              rope_base=1e6),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
    ffn_kind="moe", norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=3, d_model=64, d_ff=128, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              causal=True, window=16, rope="default"),
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, capacity_factor=4.0),
    ffn_kind="moe", norm_kind="rmsnorm",
)
