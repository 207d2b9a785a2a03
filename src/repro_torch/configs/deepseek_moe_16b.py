"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400; 2 shared + 64 routed experts top-6, fine-grained; first layer
dense (d_ff 10944).  [arXiv:2401.06066]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, d_ff=1408, vocab_size=102400,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                              causal=True, rope="default", rope_base=10000.0),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  first_dense_layers=1, first_dense_d_ff=10944),
    ffn_kind="moe", norm_kind="rmsnorm",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=3, d_model=64, d_ff=48, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              causal=True, rope="default"),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, num_shared=2,
                  first_dense_layers=1, first_dense_d_ff=128,
                  capacity_factor=4.0),
    ffn_kind="moe", norm_kind="rmsnorm",
)
