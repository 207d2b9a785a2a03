"""Batched serving driver for the PyTorch port (the JAX package's
``launch/serve.py``).

Single-batch generation::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 32 --steps 16

Continuous-batching replay (``Engine.run`` over the paged KV pool)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests requests.jsonl --max-batch 4 --max-seq-len 64

where ``requests.jsonl`` holds one request per line, e.g.
``{"id": "a", "prompt": [1, 2, 3], "max_new_tokens": 8}`` or
``{"prompt_len": 12, "seed": 7}`` for a synthetic prompt.  Use
``--requests synthetic:N`` to replay N generated requests without a file.
A model with recurrent state (``--arch recurrentgemma-2b``) serves only
prompts that fill their bucket exactly, so for it every synthetic prompt
is ``--prompt-len`` tokens long and the prompt buckets are the requests'
prompt lengths::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --smoke --device cpu --requests synthetic:4 --max-batch 2 \
      --max-seq-len 48 --block-size 8 --prompt-len 16 --steps 4

The model runs on the CUDA card unless ``--device cpu`` is given; the
weights are random, from seed 0.  ``--autotune`` searches the pass design
space for the decode cell (estimator-pruned, validated) before generating;
``--serving-autotune`` first searches the decode-cell design space per
batch bucket (``--validate``: measured-ranked by default) and pins the
winning flow, block size and engine knobs before the replay; ``--tune-db``
banks those searches in a persistent store (maintain it with ``python -m
repro_torch.launch.tune``)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests synthetic:8 --max-batch 8 --max-seq-len 1024 \
      --serving-autotune --tune-db build/tune.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.serving import (Engine, EngineConfig, load_requests_jsonl,
                                 synthetic_requests)
from repro_torch.serving.kvcache import needs_exact_prompts


def _run_replay(args) -> None:
    spec = None if args.speculation in (None, "off", "none", "") \
        else args.speculation
    shape = ShapeConfig("serve", "decode", args.max_seq_len, args.max_batch)
    cm = tflow.compile(args.arch, shape, FlowConfig(mode="folded"),
                       backend=args.backend, smoke=args.smoke,
                       device=args.device)
    exact = needs_exact_prompts(cm.plan)
    if args.requests.startswith("synthetic:"):
        n = int(args.requests.split(":", 1)[1])
        reqs = synthetic_requests(n, cm.cfg.vocab_size,
                                  prompt_len=args.prompt_len,
                                  max_new_tokens=args.steps,
                                  vary_lens=not exact)
    else:
        reqs = load_requests_jsonl(args.requests, cm.cfg.vocab_size)
    buckets = tuple(sorted({len(r.prompt) for r in reqs})) if exact else None
    ecfg = EngineConfig(temperature=args.temperature,
                        max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len,
                        block_size=args.block_size,
                        prefix_cache=bool(args.prefix_cache),
                        chunk_size=args.chunk_size,
                        chunked_prefill=args.chunked_prefill,
                        fori_seg=args.fori_seg,
                        prompt_buckets=buckets,
                        speculation=spec,
                        trace=args.trace is not None)
    if args.serving_autotune:
        from repro_torch.serving.autotune import (ServingProfile,
                                                  autotune_decode)
        prof = ServingProfile(name="cli",
                              batch_buckets=ecfg.batch_buckets,
                              max_seq_len=args.max_seq_len,
                              block_sizes=(8, 16, 32))
        at = autotune_decode(cm.cfg, profile=prof, validate=args.validate,
                             db=args.tune_db, device=args.device)
        print(at.describe())
        cm = at.compile()
        ecfg = at.engine_config(
            temperature=args.temperature,
            trace=args.trace is not None,
            prompt_buckets=buckets,
            # explicit --prefix-cache / --no-prefix-cache overrides the
            # tuned pick; unset defers to the measured A/B
            prefix_cache=at.prefix_cache if args.prefix_cache is None
            else args.prefix_cache,
            # explicit CLI chunk/fori knobs likewise override the tuned ones
            **({"chunk_size": args.chunk_size,
                "chunked_prefill": True} if args.chunked_prefill else {}),
            **({"fori_seg": args.fori_seg} if args.fori_seg else {}),
            **({"speculation": spec, "fori_seg": 0} if spec else {}))
    params = cm.init_params(0)
    eng = Engine(cm, params, ecfg)
    report = eng.run(reqs)
    print(eng.describe())
    if args.trace:
        eng.tracer.to_chrome(args.trace)
        print(f"wrote {len(eng.tracer)} trace events to {args.trace} "
              "(load in Perfetto / chrome://tracing)")
    if args.metrics:
        snap = report.registry.snapshot()
        with open(args.metrics, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(snap)} metrics to {args.metrics}")
    m = report.metrics
    if m["prefix_cache"]:
        print(f"prefix-cache hit rate: {m['prefix_hit_rate'] * 100:.1f}% "
              f"({m['prefix_hits']} of {m['n_requests']} requests seeded; "
              f"{m['prefill_tokens_computed']} of {m['prompt_tokens_total']} "
              f"prompt tokens computed)")
    if m["speculation"]:
        print(f"speculation [{m['spec_drafter']}]: acceptance rate "
              f"{m['spec_acceptance_rate'] * 100:.1f}% "
              f"({m['spec_tokens_accepted']} of {m['spec_tokens_drafted']} "
              f"draft tokens accepted over {m['spec_ticks']} verify ticks; "
              f"{m['spec_rollback_tokens']} rolled back)")
    for r in report.results[: args.show]:
        print(f"  {r.rid}: prompt={r.prompt_len} -> {r.tokens} "
              f"({r.finish_reason}, {r.latency_s * 1e3:.0f}ms)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--backend", default="auto",
                    help="kernel backend policy: auto | reference | cuda")
    ap.add_argument("--on-device-loop", action="store_true",
                    help="generate with the decode loop queued on the "
                         "device (generate_fori)")
    ap.add_argument("--autotune", action="store_true",
                    help="explore the pass design space (estimator-pruned, "
                         "validated) for the decode cell")
    # continuous-batching replay mode
    ap.add_argument("--requests", default=None,
                    help="jsonl file (or synthetic:N) of requests to serve "
                         "through Engine.run with continuous batching")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--chunk-size", type=int, default=1)
    ap.add_argument("--chunked-prefill", action="store_true")
    ap.add_argument("--fori-seg", type=int, default=0)
    ap.add_argument("--speculation", default="off",
                    help="ngram:<k>, draft:<cfg>:<k>, null:<k> or off")
    ap.add_argument("--serving-autotune", action="store_true",
                    help="search the decode-cell flow space per batch "
                         "bucket and pin the winner before replay")
    ap.add_argument("--validate", default="measure",
                    choices=("measure", "compile", "none"),
                    help="autotune ranking mode (--serving-autotune)")
    ap.add_argument("--tune-db", default=None, metavar="PATH",
                    help="persistent autotune store (JSONL): "
                         "--serving-autotune reads banked winners instead "
                         "of re-measuring and writes new ones back; "
                         "maintain with python -m repro_torch.launch.tune")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH")
    ap.add_argument("--show", type=int, default=4)
    args = ap.parse_args(argv)

    if args.requests is not None:
        _run_replay(args)
        return

    shape = ShapeConfig("cli", "decode", args.prompt_len + args.steps,
                        args.batch)
    cm = tflow.compile(args.arch, shape, FlowConfig(mode="folded"),
                       backend=args.backend, autotune=args.autotune,
                       smoke=args.smoke, device=args.device)
    if args.autotune:
        print(cm.explore_result.describe())
    print(cm.describe(stats=True))
    params = cm.init_params(0)
    eng = Engine(cm, params, EngineConfig(temperature=args.temperature))
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cm.cfg.vocab_size, (args.batch, args.prompt_len))).to(cm.device)}
    if cm.cfg.n_patch_tokens:            # the multimodal stub's embeddings
        batch["patches"] = torch.from_numpy(rng.randn(
            args.batch, cm.cfg.n_patch_tokens, cm.cfg.d_vision).astype(
                np.float32)).to(cm.device)
    if cm.cfg.n_encoder_layers:          # the audio stub's frame embeddings
        batch["frames"] = torch.from_numpy(rng.randn(
            args.batch, cm.cfg.encoder_seq, cm.cfg.d_model).astype(
                np.float32)).to(cm.device)
    t0 = time.perf_counter()
    if args.on_device_loop:
        toks = eng.generate_fori(batch, args.steps)
    else:
        toks, _ = eng.generate(batch, args.steps)
    toks = toks.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {toks.shape} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print(toks[:2])


if __name__ == "__main__":
    main()
