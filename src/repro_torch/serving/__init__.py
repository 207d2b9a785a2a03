"""repro_torch.serving — the serving subsystem, ported from the JAX package.

* :mod:`repro_torch.serving.engine` — the Engine: continuous-batching
  ``run`` loop, single-batch ``generate`` paths, metrics.
* :mod:`repro_torch.serving.scheduler` — request queue, admission control,
  slots.
* :mod:`repro_torch.serving.kvcache` — paged KV-cache manager (block pool,
  block tables, prefill packing, the refcounting ledger behind prefix
  caching).
* :mod:`repro_torch.serving.prefix` — content-hashed prefix index (shared
  prompt blocks, copy-on-write seeds for new requests).
* :mod:`repro_torch.serving.speculation` — speculative decoding: drafters,
  the verify cell's target sampling, draft->verify->rollback config.
* :mod:`repro_torch.serving.autotune` — engine-level decode autotune over
  the DSE.
"""
from repro_torch.serving.engine import Engine, EngineConfig, RunReport
from repro_torch.serving.kvcache import (BlockLedger, BlockPool,
                                         PagedKVCache, PrefixMatch)
from repro_torch.serving.prefix import PrefixIndex, block_hashes
from repro_torch.serving.scheduler import (Request, RequestResult,
                                           Scheduler, load_requests_jsonl,
                                           shared_prefix_requests,
                                           synthetic_requests)
from repro_torch.serving.speculation import (Drafter, DraftModelDrafter,
                                             NGramDrafter, NullDrafter,
                                             SpeculationConfig,
                                             build_drafter, sample_targets)

__all__ = ["Engine", "EngineConfig", "RunReport", "BlockLedger", "BlockPool",
           "PagedKVCache", "PrefixIndex", "PrefixMatch", "Request",
           "RequestResult", "Scheduler", "block_hashes",
           "load_requests_jsonl", "shared_prefix_requests",
           "synthetic_requests", "Drafter", "DraftModelDrafter",
           "NGramDrafter", "NullDrafter", "SpeculationConfig",
           "build_drafter", "sample_targets"]
