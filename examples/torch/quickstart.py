"""Quickstart: the port's compilation flow end to end through the public API.

``repro_torch.flow.compile`` is the one front door: frozen model (config)
in, compiled model out.  The returned ``CompiledModel`` owns the
ExecutionPlan, the train/prefill/decode/generate callables and the flow
report; kernel backends resolve per op through the KernelRegistry
(``backend="auto"`` → the hand-written CUDA kernels on a Hopper card, the
reference ops elsewhere).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--smoke]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch import flow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.optim.adamw import AdamW


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-runnable)")
    args = ap.parse_args(argv)
    shape = ShapeConfig("quickstart", "train", 32, 4)

    # --- the flow: one call — graph -> passes -> plan -> compiled model ----
    cm = flow.compile("llama3.2-1b", shape, smoke=args.smoke,
                      device=args.device)
    print(cm.describe())
    n_ops = sum(len(b.ops) for b in cm.plan.graph.blocks)
    fused = [op.op for b in cm.plan.graph.blocks for op in b.ops
             if op.attrs.get("act") or op.op == "glu_matmul"]
    print(f"micro-ops after LF fusion: {n_ops}; "
          f"fused kernels: {sorted(set(fused))}")

    # --- base configuration (the paper's unoptimized kernels) --------------
    base = flow.compile("llama3.2-1b", shape, FlowConfig().base(),
                        smoke=args.smoke, device=args.device)
    print(f"base flow: mode={base.plan.stream.mode} "
          f"precision={base.flow.precision} "
          f"folded={any(u.folded for u in base.plan.units)}")

    # --- one training step --------------------------------------------------
    cfg = cm.cfg
    params = cm.init_params(0)
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32))).to(
        cm.device) for k in ("tokens", "labels")}
    opt = AdamW(lr=1e-3)
    step = cm.train_step(opt)
    params, _, metrics = step(params, opt.init(params), batch)
    print(f"train step: loss={float(metrics['loss']):.4f} "
          f"acc={float(metrics['acc']):.3f}")

    # --- batched generation (prefill -> rolling-cache decode) ---------------
    gen = flow.compile("llama3.2-1b", ShapeConfig("gen", "decode", 32, 4),
                       smoke=args.smoke, device=args.device)
    toks, _ = gen.generate(params, {"tokens": batch["tokens"][:, :16]},
                           steps=8)
    print(f"generated: {toks[0].tolist()}")
    print(cm.describe(stats=True).splitlines()[-1])   # per-stage first calls


if __name__ == "__main__":
    main()
