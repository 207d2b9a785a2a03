"""End-to-end training on the port: train a small LM with checkpointing and
(optional) fault injection, on synthetic data with learnable structure.
The loss should drop well below the unigram entropy.

  PYTHONPATH=src python examples/torch/train_lm.py --steps 300 \
      [--device cpu] [--smoke]
  PYTHONPATH=src python examples/torch/train_lm.py --steps 100 \
      --fail-at 40                                      # recovery demo
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-runnable)")
    args = ap.parse_args(argv)

    shape = ShapeConfig("example", "train", args.seq, args.batch)
    cm = tflow.compile(args.arch, shape, FlowConfig(mode="folded"),
                       smoke=args.smoke, device=args.device)
    cfg = cm.cfg
    print(cm.describe())

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tr = Trainer(
        cm,
        AdamW(lr=3e-3, warmup_steps=min(20, args.steps),
              total_steps=args.steps,
              compress="int8_ef" if args.compress else None),
        TrainerConfig(steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=50,
                      log_every=max(1, args.steps // 25),
                      fail_at_step=args.fail_at))
    _, _, hist = tr.fit(data, 0)
    for s, l in hist:
        print(f"step {s:5d}  loss {l:.4f}")
    if args.fail_at is not None:
        print(f"(recovered from the injected failure at step {args.fail_at}; "
              f"restarts={tr._restarts})")
    print(f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
