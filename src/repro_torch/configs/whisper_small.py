"""whisper-small [audio] — enc-dec, 12L+12L d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865 (padded to 51872 for TP); conv frontend is a STUB
(input_specs provides precomputed frame embeddings, encoder_seq=1500).
Decoder positions use sinusoids (deviation: HF uses learned embeddings, but
the assigned decode shapes exceed the trained 448-position table).
[arXiv:2212.04356]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, d_ff=3072, vocab_size=51865,
    attention=AttentionConfig(n_heads=12, n_kv_heads=12, head_dim=64,
                              causal=True, rope=None),
    ffn_kind="gelu_mlp", norm_kind="layernorm", norm_eps=1e-5,
    n_encoder_layers=12, encoder_seq=1500, cross_attention=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              causal=True, rope=None),
    ffn_kind="gelu_mlp", norm_kind="layernorm", norm_eps=1e-5,
    n_encoder_layers=2, encoder_seq=12, cross_attention=True,
    tie_embeddings=True,
)
