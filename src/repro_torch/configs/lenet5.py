"""LeNet-5 — the paper's pipelined-mode network (Keras/MNIST definition)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lenet5", family="cnn", n_layers=5, d_model=120, d_ff=84,
    vocab_size=10, image_size=32, image_channels=1,
)

SMOKE = CONFIG  # already tiny
