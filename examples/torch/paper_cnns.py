"""The paper's own networks through the port's flow: LeNet-5 (pipelined
mode), MobileNetV1 and ResNet-34 (folded mode), base vs optimized
configuration — the Table III/IV story, timed per forward.

  PYTHONPATH=src python examples/torch/paper_cnns.py [--device cpu] [--smoke]

On the card each forward runs conv2d_fused and matmul_fused and is timed
with CUDA events; ``--smoke`` takes the reduced MobileNetV1 and ResNet-34
and small batches (CPU-runnable).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch import flow as tflow
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig


def bench(fn, device, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced CNNs and batches (CPU-runnable)")
    args = ap.parse_args(argv)
    pick = get_smoke if args.smoke else get_config
    nets = [("lenet5", get_config("lenet5"), 16),
            ("mobilenetv1", pick("mobilenetv1"), 2 if args.smoke else 8),
            ("resnet34", pick("resnet34"), 2 if args.smoke else 8)]
    for name, cfg, B in nets:
        shape = ShapeConfig("serve", "prefill", 64, B)
        rng = np.random.RandomState(0)
        x = rng.randn(B, cfg.image_size, cfg.image_size,
                      cfg.image_channels).astype(np.float32)
        rows = []
        # the optimized flow in bf16 on the card (the tensor-core
        # kernels); in fp32 on the CPU, where bf16 is emulated
        prec = "fp32" if args.device == "cpu" else "bf16"
        for label, fl in [("base", FlowConfig().base()),
                          ("optimized", FlowConfig(precision=prec))]:
            cm = tflow.compile(cfg, shape, fl, device=args.device)
            params = cm.init_params(0)
            batch = {"images": torch.from_numpy(x).to(cm.device)}
            ms = bench(lambda: cm.prefill(params, batch), cm.device,
                       reps=1 if args.smoke else 5)
            n_ops = sum(len(b.ops) for b in cm.plan.graph.blocks)
            rows.append((label, cm.plan.stream.mode, fl.precision, n_ops,
                         ms))
        print(f"\n{name} (batch {B}, {cfg.image_size}px, {cm.device}):")
        for label, mode, prec, n_ops, ms in rows:
            print(f"  {label:10s} mode={mode:9s} prec={prec} "
                  f"micro-ops={n_ops:4d}  {ms:8.2f} ms  "
                  f"({B / ms * 1e3:8.1f} fps)")
        print(f"  speedup: {rows[0][-1] / rows[1][-1]:.2f}x")


if __name__ == "__main__":
    main()
