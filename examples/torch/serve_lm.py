"""Batched serving on the port: prefill a batch of prompts, decode over the
rolling cache in a host loop and queued on the device, then serve a
request stream through the continuous-batching engine (paged KV pool,
eviction and refill between ticks).

  PYTHONPATH=src python examples/torch/serve_lm.py [--arch mixtral-8x7b] \
      [--device cpu] [--smoke]
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
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.serving import Engine, EngineConfig, synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-runnable)")
    args = ap.parse_args(argv)

    shape = ShapeConfig("serve", "decode", args.prompt_len + args.steps,
                        args.batch)
    cm = tflow.compile(args.arch, shape, FlowConfig(mode="folded"),
                       smoke=args.smoke, device=args.device)
    cfg = cm.cfg
    params = cm.init_params(0)
    eng = Engine(cm, params, EngineConfig(temperature=0.0))

    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(cm.device)}
    if cfg.n_patch_tokens:
        batch["patches"] = torch.from_numpy(rng.randn(
            args.batch, cfg.n_patch_tokens, cfg.d_vision).astype(
                np.float32)).to(cm.device)
    if cfg.n_encoder_layers:
        batch["frames"] = torch.from_numpy(rng.randn(
            args.batch, cfg.encoder_seq, cfg.d_model).astype(
                np.float32)).to(cm.device)

    t0 = time.time()
    toks, _ = eng.generate(batch, args.steps)          # host-driven loop
    toks = toks.cpu()
    t_host = time.time() - t0
    t0 = time.time()
    toks2 = eng.generate_fori(batch, args.steps).cpu()  # queued on device
    t_dev = time.time() - t0
    assert torch.equal(toks, toks2[:, :args.steps])
    tps = args.batch * args.steps
    print(f"host loop:      {tps / t_host:8.1f} tok/s")
    print(f"queued loop:    {tps / t_dev:8.1f} tok/s")
    print("sample:", toks[0].tolist())

    if cfg.attention is not None and not cfg.cross_attention \
            and not cfg.n_patch_tokens:
        # continuous batching: 2x oversubscribed request stream through the
        # paged KV pool — finished sequences evicted, the queue refills
        # slots; prompts fill their bucket exactly (a recurrent model's
        # state would take left padding as context)
        total = args.prompt_len + args.steps
        # the block size must divide every prompt-bucket rung
        block = next(b for b in (16, 8, 4, 2, 1)
                     if args.prompt_len % b == 0 and total % b == 0)
        eng2 = Engine(cm, params, EngineConfig(
            max_batch=args.batch, max_seq_len=total,
            prompt_buckets=(args.prompt_len, total), block_size=block))
        reqs = synthetic_requests(2 * args.batch, cfg.vocab_size,
                                  prompt_len=args.prompt_len,
                                  max_new_tokens=args.steps,
                                  vary_lens=False)
        report = eng2.run(reqs)
        print(report.describe())


if __name__ == "__main__":
    main()
