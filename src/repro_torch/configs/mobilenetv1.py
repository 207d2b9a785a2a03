"""MobileNetV1 — the paper's folded-mode network (1x1 convs are 94.9% of
multiply-adds: the parameterized-kernel workhorse).  [arXiv:1704.04861]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mobilenetv1", family="cnn", n_layers=14, d_model=1024, d_ff=1024,
    vocab_size=1000, image_size=224, image_channels=3,
)

SMOKE = dataclasses.replace(CONFIG, image_size=64, vocab_size=16)
