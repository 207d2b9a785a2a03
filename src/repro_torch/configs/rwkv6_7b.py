"""rwkv6-7b (Finch) [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536; data-dependent decay time-mix + squared-relu channel-mix.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, RecurrenceConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    recurrence=RecurrenceConfig(kind="rwkv6", width=4096, n_heads=64,
                                head_dim=64, lora_rank=64),
    layer_pattern=("rec",),
    ffn_kind="rwkv_cm", norm_kind="layernorm", norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=3, d_model=64, d_ff=224, vocab_size=256,
    recurrence=RecurrenceConfig(kind="rwkv6", width=64, n_heads=4,
                                head_dim=16, lora_rank=8),
    layer_pattern=("rec",),
    ffn_kind="rwkv_cm", norm_kind="layernorm", norm_eps=1e-5,
)
