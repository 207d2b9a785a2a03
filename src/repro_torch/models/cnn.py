"""The paper's own networks — LeNet-5, MobileNetV1, ResNet-34 — as graphs.

These run through the exact same compilation flow (fusion folds batch-norm and
ReLU into the convolutions — the paper's LF pass; folding groups the repeated
depthwise-separable / residual blocks — the paper's PK pass).  Layout is NHWC.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import Block, Graph, ParamSpec as P


def _conv(b: Block, name: str, cin: int, cout: int, k: int, stride: int = 1,
          x: str = "h", out: str = "h", padding: str = "SAME") -> str:
    b.add(out, "conv2d", x,
          params=[P(f"{name}_w", (k, k, cin, cout),
                    ("conv_k", "conv_k", "channels", "d_model"))],
          stride=stride, padding=padding)
    return out


def _dwconv(b: Block, name: str, c: int, k: int, stride: int = 1) -> None:
    b.add("h", "depthwise_conv2d", "h",
          params=[P(f"{name}_w", (k, k, c, 1),
                    ("conv_k", "conv_k", "channels", "none"))],
          stride=stride, padding="SAME")


def _bn(b: Block, name: str, c: int, x: str = "h", out: str = "h") -> None:
    b.add(out, "batchnorm", x,
          params=[P(f"{name}_scale", (c,), ("channels",), "ones"),
                  P(f"{name}_bias", (c,), ("channels",), "zeros"),
                  P(f"{name}_mean", (c,), ("channels",), "zeros"),
                  P(f"{name}_var", (c,), ("channels",), "ones")],
          eps=1e-5)


def _relu(b: Block, x: str = "h", out: str = "h") -> None:
    b.add(out, "act", x, kind="relu")


def build_lenet5(cfg: ModelConfig) -> Graph:
    blocks = []
    b = Block("stem", "cnn_stem")
    b.add("h", "image_in", "h", size=cfg.image_size, channels=cfg.image_channels)
    _conv(b, "c1", cfg.image_channels, 6, 5, padding="VALID")
    _relu(b)
    b.add("h", "avgpool2d", "h", window=2, stride=2)
    blocks.append(b)
    b = Block("c3", "cnn_block")
    _conv(b, "c3", 6, 16, 5, padding="VALID")
    _relu(b)
    b.add("h", "avgpool2d", "h", window=2, stride=2)
    blocks.append(b)
    b = Block("fc", "cnn_head")
    b.add("h", "flatten", "h")
    b.add("h", "matmul", "h", params=[P("f5_w", (400, 120), ("none", "d_model"))])
    b.add("h", "bias_add", "h", params=[P("f5_b", (120,), ("d_model",), "zeros")])
    _relu(b)
    b.add("h", "matmul", "h", params=[P("f6_w", (120, 84), ("none", "d_model"))])
    b.add("h", "bias_add", "h", params=[P("f6_b", (84,), ("d_model",), "zeros")])
    _relu(b)
    b.add("h", "matmul", "h", params=[P("out_w", (84, cfg.vocab_size),
                                        ("none", "vocab"))])
    b.add("h", "bias_add", "h", params=[P("out_b", (cfg.vocab_size,), ("vocab",),
                                          "zeros")])
    blocks.append(b)
    return Graph(cfg.name, blocks, meta={"config": cfg})


_MOBILENET_PLAN = [  # (cout, stride) for each depthwise-separable block
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]


def build_mobilenetv1(cfg: ModelConfig) -> Graph:
    blocks = []
    b = Block("stem", "cnn_stem")
    b.add("h", "image_in", "h", size=cfg.image_size, channels=cfg.image_channels)
    _conv(b, "stem", cfg.image_channels, 32, 3, stride=2)
    _bn(b, "stem_bn", 32)
    _relu(b)
    blocks.append(b)
    cin = 32
    for i, (cout, s) in enumerate(_MOBILENET_PLAN):
        b = Block(f"ds{i}", "cnn_block", attrs={"index": i})
        _dwconv(b, "dw", cin, 3, stride=s)
        _bn(b, "dw_bn", cin)
        _relu(b)
        _conv(b, "pw", cin, cout, 1)
        _bn(b, "pw_bn", cout)
        _relu(b)
        blocks.append(b)
        cin = cout
    b = Block("head", "cnn_head")
    b.add("h", "global_avgpool", "h")
    b.add("h", "matmul", "h", params=[P("fc_w", (1024, cfg.vocab_size),
                                        ("none", "vocab"))])
    b.add("h", "bias_add", "h", params=[P("fc_b", (cfg.vocab_size,), ("vocab",),
                                          "zeros")])
    blocks.append(b)
    return Graph(cfg.name, blocks, meta={"config": cfg})


_RESNET34_PLAN = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]


def build_resnet34(cfg: ModelConfig) -> Graph:
    blocks = []
    b = Block("stem", "cnn_stem")
    b.add("h", "image_in", "h", size=cfg.image_size, channels=cfg.image_channels)
    _conv(b, "stem", cfg.image_channels, 64, 7, stride=2)
    _bn(b, "stem_bn", 64)
    _relu(b)
    b.add("h", "maxpool2d", "h", window=3, stride=2)
    blocks.append(b)
    cin = 64
    bi = 0
    for cout, reps, stride in _RESNET34_PLAN:
        for r in range(reps):
            s = stride if r == 0 else 1
            b = Block(f"res{bi}", "cnn_block", attrs={"index": bi})
            b.add("sc", "identity", "h")
            if s != 1 or cin != cout:
                _conv(b, "proj", cin, cout, 1, stride=s, x="sc", out="sc")
                _bn(b, "proj_bn", cout, x="sc", out="sc")
            _conv(b, "c1", cin, cout, 3, stride=s)
            _bn(b, "bn1", cout)
            _relu(b)
            _conv(b, "c2", cout, cout, 3)
            _bn(b, "bn2", cout)
            b.add("h", "add", "h", "sc")
            _relu(b)
            blocks.append(b)
            cin = cout
            bi += 1
    b = Block("head", "cnn_head")
    b.add("h", "global_avgpool", "h")
    b.add("h", "matmul", "h", params=[P("fc_w", (512, cfg.vocab_size),
                                        ("none", "vocab"))])
    b.add("h", "bias_add", "h", params=[P("fc_b", (cfg.vocab_size,), ("vocab",),
                                          "zeros")])
    blocks.append(b)
    return Graph(cfg.name, blocks, meta={"config": cfg})


def build_cnn_graph(cfg: ModelConfig) -> Graph:
    g = {"lenet5": build_lenet5, "mobilenetv1": build_mobilenetv1,
         "resnet34": build_resnet34}[cfg.name](cfg)
    g.validate()
    return g
