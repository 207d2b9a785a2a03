"""End-to-end training CLI (the JAX package's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

``--smoke`` selects the reduced config; without it the full config is
used.  It runs on the card unless ``--device cpu``.  ``--backend`` picks
the forward's kernels: ``auto`` (the hand kernels on a Hopper card, the
reference ops elsewhere), ``cuda`` or ``reference``; the backward always
runs through the reference ops (see ``core/ops_impl._KernelForward``).
``--autotune`` explores the pass design space for the train cell
(estimator-pruned, each top-k survivor built and its footprint confirmed)
and trains the winning flow; it prints the search and the plan's ``dse:``
line.

``--mesh data=2,model=2`` trains on a DeviceMesh (``Trainer(mesh=)``: the
parameters, moments and, with ``--compress``, the error buffers are
DTensors).  Each of the mesh's ranks runs the command with its own
``--rank`` and the same ``--init-file`` (a path every rank can reach); a
one-rank mesh needs neither::

  python -m repro_torch.launch.train --smoke --compress --mesh data=1,model=1
  # four ranks on the CPU, one command each (r = 0..3):
  python -m repro_torch.launch.train --smoke --device cpu --compress \\
      --mesh data=2,model=2 --rank $r --init-file /tmp/pg_store
"""
from __future__ import annotations

import argparse
import math

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticImages, SyntheticLM
from repro_torch.device import init_process_group
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--mode", default="folded")
    ap.add_argument("--backend", default="auto",
                    help="kernel backend policy: auto | reference | cuda")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--autotune", action="store_true",
                    help="explore the pass design space (estimator-pruned, "
                         "validated) instead of the fixed flow")
    ap.add_argument("--mesh", default=None,
                    help="train on a mesh, e.g. data=2,model=2")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank on the mesh")
    ap.add_argument("--init-file", default=None,
                    help="the file store every rank of the mesh shares")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        mesh = {k: int(v) for k, v in
                (a.split("=") for a in args.mesh.split(","))}
        init_process_group(math.prod(mesh.values()), args.rank, args.device,
                           args.init_file)

    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    cm = tflow.compile(
        args.arch, shape,
        FlowConfig(mode=args.mode, microbatches=args.microbatches),
        backend=args.backend, autotune=args.autotune, smoke=args.smoke,
        device=args.device, mesh=mesh)
    if args.autotune:
        print(cm.explore_result.describe())
    print(cm.describe(stats=True))
    cfg = cm.cfg

    if cfg.family == "cnn":
        data = SyntheticImages(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=0,
                       global_batch=args.batch),
            cfg.image_size, cfg.image_channels, cfg.vocab_size)
    else:
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    opt = AdamW(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                total_steps=args.steps,
                compress="int8_ef" if args.compress else None)
    tr = Trainer(cm, opt, TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=max(1, args.steps // 20)))
    _, _, hist = tr.fit(data, 0)
    for s, lo in hist:
        print(f"step {s:6d}  loss {lo:.4f}")


if __name__ == "__main__":
    main()
