"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; mistral-7b backbone; vision frontend is a STUB (input_specs
provides precomputed patch embeddings; anyres tiling = 576 base patches).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, d_ff=14336, vocab_size=32000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              causal=True, rope="default", rope_base=1e6),
    ffn_kind="swiglu", norm_kind="rmsnorm",
    n_patch_tokens=576, d_vision=1024,
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=3, d_model=64, d_ff=192, vocab_size=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              causal=True, rope="default"),
    ffn_kind="swiglu", norm_kind="rmsnorm",
    n_patch_tokens=4, d_vision=32,
)
