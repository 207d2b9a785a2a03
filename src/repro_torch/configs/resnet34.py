"""ResNet-34 — the paper's largest network (846x base->optimized speedup)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet34", family="cnn", n_layers=34, d_model=512, d_ff=512,
    vocab_size=1000, image_size=224, image_channels=3,
)

SMOKE = dataclasses.replace(CONFIG, image_size=64, vocab_size=16)
