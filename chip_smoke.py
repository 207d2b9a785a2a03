"""Drive the PyTorch port on one CUDA card (an H100) and check it.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — the hand-written kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (wall time printed as set-up);
3. kernels — every distinct ResNet-34 conv at batch 8 and 224 px, and the
   FC head, in bf16 (the opt flow) and fp32 (the base flow), plus four fp32
   convs with the BN fold and ReLU (one a shape class, in no forward),
   MobileNetV1's first conv (both dtypes) and its 32-channel pointwise
   conv (bf16), and LeNet-5's two convs and its two FC layers that run on
   ``simt`` (120 -> 84, 84 -> 10; bf16, as its forward runs them): each
   records the schedule it took (conv2d_fused: ``wgmma`` in bf16, ``ffma``
   in fp32, ``small_ci`` for the stem, MobileNetV1's first conv and
   LeNet-5's convs, ``mid_ci`` for the pointwise conv), is held against its
   plain PyTorch version (relerr < 2e-2 in bf16, < 1e-5 in fp32) beside
   the old SIMT kernel at the same shape (held to it too), and is timed
   beside them, the PyTorch library call for the same function (for the
   convs one cuDNN conv on a pre-padded input, and the chain of pad, conv
   and the BN/ReLU ops; for the FC layers ``torch.matmul`` + bias (+ ReLU))
   and the card's bound for the work; the convs as CUDA-graph replays and
   by events.  The stem on ``small_ci`` must be no slower than cuDNN's
   conv alone in both flows, MobileNetV1's first conv in bf16 no slower
   than the SIMT kernel, its pointwise conv on ``mid_ci`` no slower than
   the SIMT kernel and within twice its bound (0.0116 ms); that conv is
   also timed at batch 4, 8, 16 and 32 beside cuDNN's;
4. LM kernels — at full-width llama3.2-1b shapes, in bf16 and fp32:
   ``flash_attention`` at the prefill (B=8, 512 tokens, 32 heads over 8 KV
   heads of 64, causal), recording its schedule (``wgmma`` in bf16,
   ``ffma`` in fp32), timed as CUDA-graph replays and by events beside
   the SIMT kernel at the same shape (held to the plain version too) and
   SDPA (with the name of the kernel it ran); ``decode_attention`` over a
   1024-slot cache half full, on its ``mma`` (bf16) or ``ffma`` (fp32)
   schedule, timed as CUDA-graph replays beside the SIMT kernel (forced,
   held to the plain version too) and SDPA, and
   ``matmul_fused`` at every projection of a llama layer and every
   distinct projection of recurrentgemma-2b (2560 -> 2560, 2560 ->
   256, the 2560 -> 7680 GLU pair, 7680 -> 2560), for the prefill's 4096
   rows and a decode step's 8 (in bf16 also llama's q at 128, 64 and 40
   rows and its GLU pair at 40 and 32, each timed on both tensor-core
   schedules: the crossover); each
   case records the schedule that ran, is held against its plain version
   and timed beside it, the old SIMT kernel at the same shape, the PyTorch
   call for the same function (``scaled_dot_product_attention``,
   ``torch.matmul``) and the bound.  The matmuls are timed as CUDA-graph
   replays (device time without the host's launch cost) and, at 64 rows or
   fewer, rotate over enough weight copies to read them cold from HBM, as
   a decode step does.  Then the base variant (``vmem_accum=False``, tile
   (256, 512, 256)) at the ResNet-34 FC shape and at 4096 x 2048 x 2048,
   in bf16 and fp32: the schedule it took (the CW cores: ``small_m`` /
   ``ffma_small_m`` at 8 rows, ``wgmma`` / ``ffma`` at 4096), against its
   plain version, the same bits twice, timed beside the old SIMT base
   kernel (which it must beat), the CW form at the same shape,
   ``torch.matmul`` where that is the same function, and its bound;
5. path — full-width ResNet-34 (224 px, batch 8, random weights from seed 0)
   through ``repro_torch.flow.compile`` in the opt, base and folded flows:
   the plan dispatches conv2d and matmul to ``cuda``, one forward launches
   36 convs and 1 matmul, the logits are (8, 1000), finite, and agree with
   the same model on the ``reference`` backend; then ``measure("prefill")``.
   Then LeNet-5 and MobileNetV1 at full config, with the same checks;
6. LM path — full-width llama3.2-1b (16 layers, random weights from seed
   0), ``ShapeConfig("serve", "decode", 1024, 8)``, a 512-token prompt per
   row from ``RandomState(0)``: in bf16 the plan dispatches attention,
   decode attention and both matmuls to ``cuda``; ``generate`` runs 32
   steps; one prefill and each decode step launch the kernels the plan
   says (16 flash / 96 matmul, 16 decode / 96 matmul); the prefill's and
   every teacher-forced decode step's logits agree with the ``reference``
   backend.  In fp32 the greedy tokens of 32 steps are identical to the
   reference backend's, and the fp32 prefill is timed with flash on its
   ``ffma`` schedule, forced onto the SIMT kernel, and on ``ffma`` again.
   Then ``measure("prefill")`` at 8 x 512 tokens,
   ``measure("decode")`` and a profile of each;
7. serving kernels — ``paged_decode_attention`` at the serving shape (8
   rows of ~520 live tokens in a 513-block pool of 16-token blocks, one
   query a row and five), on its ``mma`` or ``ffma`` schedule beside the
   SIMT kernel (forced, by graph),
   and ``copy_block`` on the folded 16-layer K and V
   pools (one launch a fork), in bf16 and fp32, each held against its plain
   version and timed beside it, the library yardstick (gather +
   ``scaled_dot_product_attention``; ``torch._foreach_copy_``) and the
   bound, as CUDA-graph replays and by events;
8. serving — full-width llama3.2-1b through ``repro_torch.serving.Engine.run``
   (``EngineConfig(max_batch=8, max_seq_len=1024, block_size=16)``):
   workloads A (16 prompts of 64-512 tokens), B (a shared 392-token prefix
   and a 200-token prompt served in two waves, prefix cache on: hits and a
   copy-on-write fork), C (A with chunked prefill of 16 and ``ngram:4``
   speculation) and D (A with decode segments of 8), 32 new tokens a
   request.  In bf16 each run's launches are those the plan and the run's
   ticks say (16 paged attention and 96 matmul launches a tick, one
   ``copy_block`` launch a fork for the K and V pools), A's logits agree with the reference
   backend's and a decode segment runs without a device-to-host read; in
   fp32 every workload's greedy tokens equal the reference backend's, C's
   and D's equal A's and B's equal its cold run.  Per workload: tokens/s,
   TTFT and latency percentiles, ms per tick, host syncs per token, pool
   bytes, and the device-busy share of one profiled run;
9. recurrent kernels — at full-width recurrentgemma-2b shapes, in bf16 and
   fp32: ``flash_attention`` with 10 heads
   over 1 KV head of 256 and the 2048-token window at 8 x 512 tokens and at
   one row of 2080 (the window cuts), ``decode_attention`` over the
   1024-slot and the wrapped 2048-slot cache, ``paged_decode_attention`` at
   workload R's shape (both beside their SIMT kernels); each held against
   its plain version and timed beside it, the library yardstick and the
   bound;
10. recurrent path — recurrentgemma-2b at full width and 8 of its 26
   layers (the script's time limit since phases 16-17 joined; random
   weights from seed 0), bf16 then fp32: ``generate`` of 32
   tokens after a 512-token prompt a row (``ShapeConfig("serve", "decode",
   1024, 8)``) with the launches the plan says (2 flash + 6 lru_scan + 42
   matmul a prefill, 2 decode + 42 matmul and no lru_scan a step), the prefill and
   every teacher-forced step's logits against the reference backend, the
   fp32 greedy tokens identical to it, in bf16 ``measure`` and
   profiles, in fp32 the prefill timed on ``ffma``, SIMT, ``ffma``; the
   window run (one row, a 2080-token prompt, 24 steps over the 2048-slot
   rolling cache) with the same checks; ``Engine.run`` on
   workload R (16 prompts of exactly 256 tokens, 16-48 new tokens each,
   exact prompt buckets) with its launches per tick and per prefill batch,
   bf16 logits against the reference backend, fp32 tokens identical to it,
   the refusals of a padded prompt, the prefix cache, chunked prefill and
   speculation, and the serving metrics with the pool's and the dense
   state's bytes and the device-busy share of one profiled run.  Every
   run's lru_scan launches are on ``chunked``, and their shapes recorded;
11. lru_scan — at every (B, S, W) shape phase 10 launched it at (fp32, as
   ``op_rg_lru`` hands it: the 8 x 512 prefill, the window run's one row of
   2080, workload R's prefill batches of 256-token prompts) and at the 8 x
   512 prefill in bf16 (a kernel case): the ``chunked`` schedule by CUDA
   graph (through the wrapper, and launched directly into one buffer) and
   by events, held against its plain version, beside the
   sequential kernel it replaced (by graph, held to the plain version too)
   and the bound (no PyTorch call computes a linear recurrence); at each
   path shape the chunked kernel must be no slower than the sequential
   one;
12. dense kernels — at the heads and projections of qwen1.5-4b (20 heads
   over 20 KV heads of 128), phi4-mini-3.8b (24 over 8 of 128: a group of
   3) and stablelm-1.6b (32 over 32 of 64), bf16 and fp32:
   ``flash_attention`` at the 8 x 512 prefill, ``decode_attention`` over
   the 1024-slot cache half full and ``paged_decode_attention`` at a
   serving tick, each beside its SIMT kernel, SDPA (gather + SDPA) and the
   plain version; ``matmul_fused`` at each of the model's projection
   shapes (from its plan) at 4096 and 8 rows;
13. dense path — the three at full width and 4 of their 40 / 32 / 24
   layers (the script's time limit; random
   weights from seed 0, drawn once in bf16; the fp32 runs take them
   widened), one after the other: ``generate`` of 32 tokens after a 512-token prompt a row
   (``ShapeConfig("serve", "decode", 1024, 8)``) with the launches the
   plan says (L flash + 6 L matmul a prefill, L decode + 6 L matmul a
   step, L layers), the prefill's and every teacher-forced step's logits
   against the reference backend (bf16 within 5e-2, fp32 within 1e-4),
   the fp32 greedy tokens identical to it; in bf16 ``measure`` of the 8 x
   512 prefill and a decode step with profiles, and the head's unembed
   timed alone; then ``Engine.run`` on workload A (llama's serving
   configuration) with its launches by schedule (each prefill batch's
   projections by its rows) and the pool's bytes, fp32 tokens identical
   to the reference backend's ``Engine.run``.  Each model's weights,
   states and pools are freed before the next;
14. train — llama3.2-1b at full width and 4 of its 16 layers (the
   script's time limit; 0.51 B parameters, fp32 masters, bf16 compute,
   block remat), ``ShapeConfig("train", "train",
   512, 8)``: 20 ``AdamW(lr=3e-4, warmup_steps=3, total_steps=20)`` steps
   on one fixed ``SyntheticLM`` batch (step 0, 8 x 512): every loss
   finite, the last at least 1.0 nat below the first; the forward
   products on the hand kernels (the backward is the reference ops'
   autograd, recomputed), each layer's projections and flash call twice
   a step (the remat's recompute) on ``wgmma``, no other kernel, no
   dispatch rejection; the trained tree cast to bf16 into
   ``ShapeConfig("serve", "decode", 1024, 8)``: a 32-step generate on the
   batch's 512 tokens with the launches by schedule of phase 6 and every
   logit held to the reference backend (< 5e-2), and in an fp32 serve
   plan greedy tokens identical to it; ``measure("train")`` (min of 5)
   and a profile of two steps.  Then a 2-layer llama3.2-1b at full width,
   fp32, one train step on the card (its forward on the kernels) and on
   the host CPU from the same tree: loss relerr < 1e-5, every gradient
   < 1e-4, and one AdamW update of the card's gradients on the card and
   on the CPU < 1e-4.  Then ResNet-34 at 224 px, batch 8: 10 steps of
   ``AdamW(lr=1e-3, warmup_steps=2, total_steps=10)`` on one fixed
   ``SyntheticImages`` batch with BatchNorm on the batch's statistics
   (the loss falls by at least 0.5; the convs on ``wgmma`` and the stem on
   ``small_ci``, the FC on ``small_m``), the checkpoint of its
   parameters and AdamW state under ``build/`` restored bit-exactly (then
   deleted) and one step after the restore within 1e-4 of the
   uninterrupted one, then the trained tree served in bf16 and fp32
   (``ShapeConfig("serve", "prefill", 64, 8)``, BN folded into the convs)
   with phase 5's launches by schedule and limits, and ``measure("train")``;
15. tune — the static verifier and the tuning stack: ``verify_plan`` on the
   card's plan of every ported config (three CNNs at batch 8, ten LMs at
   ``ShapeConfig("serve", "decode", 1024, 8)``; no weight is made), all
   ``ok`` of 9 checks with no diagnostic but whisper-small's K204 warning
   (its cross-attention stays off the flash kernel), each hand kernel's largest
   working set (the shared bytes a block asks for) printed and every
   call's working set held to the kernel library's own ``*_smem`` query;
   the survivors of each measured search built and run once, untimed,
   before the search; ResNet-34 (224
   px, batch 8) through ``flow.compile(autotune=True, validate="measure",
   verify=True)`` with a fresh tune database under ``build/``: each
   measured survivor's ms beside the estimator's h100 prediction, no conv
   on ``simt`` during the search, the winner (or, when the ``reference``
   backend wins, the fastest survivor on the hand kernels) through
   conv2d_fused with phase 5's launches by schedule and its logits within
   the limit of the ``reference`` backend at its own flow, a second
   search on the same database a hit with nothing measured, and a
   ``validate="compile"`` search whose one survivor's footprint is a
   measured step's peak of allocated memory; llama3.2-1b
   at full width and 4 of its 16 layers (the script's time limit) through
   ``autotune_decode`` (``ServingProfile(
   batch_buckets=(4, 8), max_seq_len=1024, block_sizes=(16, 32))``,
   ``validate="measure"``, three timed runs a candidate, bench and
   replay, the speculation replay on an envelope of 128 tokens): all six
   benches banked (and the engine replay that confirms a chunk width
   above 1), every paged launch on ``mma``, the block and chunk
   benches re-run and counted on ``mma``, then the pinned engine on
   workload A in the winner's precision and the winner's flow in the
   other (on the hand kernels: with the ``auto`` backend when the
   ``reference`` backend won), with launches by schedule, bf16 logits
   within the limit and fp32 tokens identical to the ``reference``
   backend's, and the engine's defaults on A beside it; no dispatch
   rejection; ``launch.tune show`` lists every record under the card's
   ``cuda:<name>`` key;
16. MoE and multimodal kernels — at the heads and projections of
   deepseek-moe-16b (16 over 16 heads of 128), mixtral-8x7b (32 over 8 of
   128: groups of 4, window 4096) and llava-next-mistral-7b (32 over 8 of
   128), bf16 and fp32: ``flash_attention`` at the prefill (8 x 512;
   llava's 8 x 1024), ``decode_attention`` over the 1024-slot cache half
   full (llava's 2048-slot cache at position 1039), ``paged_decode_attention``
   at a workload-A tick (the two MoE models), each beside its SIMT
   kernel, SDPA and the plain version; ``matmul_fused`` at each model's
   projection shapes at the prefill's rows and 8;
17. MoE and multimodal path — deepseek-moe-16b at full width and depth
   (16.4 B parameters), and at full width cut in depth for the script's
   time limit mixtral-8x7b at 4 of its 32 layers (93 GB in bf16 whole)
   and llava-next-mistral-7b at 4 of its 32 (a 1024-token prompt a
   row whose first 576 positions are patch embeddings from
   ``RandomState(0)``, ``ShapeConfig("serve", "decode", 2048, 8)``);
   random weights from seed 0, drawn once in bf16 (the fp32 runs take
   them widened, leaf by leaf), one model after the other:
   ``generate`` of 32 tokens with the launches the plan says (4 matmuls a
   MoE layer, 6 a dense one), the prefill's and the first 4 teacher-forced
   steps' logits against the reference backend (bf16 within 5e-2, fp32
   within 1e-4), the fp32 greedy tokens identical to it, both under the
   routing-flip rule (where a check fails where, and only where, a
   compared token's top-k picked other experts than the reference
   backend's, the check is held on the other rows, and the flips and their
   smallest reference margin are recorded; every call's flips are
   recorded); in bf16 ``measure`` of the prefill and a decode step with
   profiles and the expert products' ms a step; llava's logits moved by a
   second draw of the patches, its ``Engine.run`` refused (a request has no
   patches); ``Engine.run`` on workload A (deepseek bf16 and fp32, mixtral
   bf16) with its launches by schedule, the pool's bytes and the real
   prompt picks capacity dropped in the padded prefill batches, fp32
   tokens identical to the reference backend's ``Engine.run``; deepseek's
   fp32 workload A run again on the stages' graphs without the hook
   (launches and tokens equal to the eager run's), and the reference
   backend's ``Engine.run`` on graphs too, with each model's graph stats;
18. family kernels — at whisper-small's geometries (12 over 12 heads of
   64, d_model 768, d_ff 3072), bf16 and fp32: ``flash_attention``
   non-causal over the encoder's 8 x 1500 frames (1500 is no multiple of
   the kernels' 64- or 128-row tiles) and causal at the decoder's 8 x 128
   prompt, ``decode_attention`` over the 448-slot cache, each beside its
   SIMT kernel, SDPA and the plain version; ``matmul_fused`` at every
   projection (768 -> 768, 768 -> 3072 with bias and tanh-GELU, 3072 ->
   768 with bias) at the encoder's 12,000 rows, the prompt's 1024 and 8,
   beside ``torch.addmm`` (+ GELU);
19. family path — rwkv6-7b at full width and 8 of its 32 layers (the
   script's time limit; ``ShapeConfig("serve", "decode", 1024, 8)``, a
   512-token prompt a row):
   bf16 then fp32 (the bf16 draw widened), ``generate`` of 32 tokens with
   no kernel launched (its projections are library products, its WKV
   recurrence plain PyTorch, as JAX computes both outside Pallas), the
   fp32 tokens of 4 steps each the argmax of a teacher-forced prefill; at
   the first 4 layers of the same weights (the model carries a last-bit
   difference far through its layers: the 8 layers' figures, and the
   fp32 logits under a 1e-7 nudge of the embedding, are recorded beside)
   the bf16 prefill's logits within 5e-2 of the fp32 prefill's and the
   fp32 decode within 2e-4 of a teacher-forced prefill; in bf16
   ``measure`` with profiles and the WKV recurrence's ms a prefill and a
   step, ``Engine.run`` refused (no self-attention KV state); the card
   against the host CPU at 2 layers, full width (bf16 < 5e-2, fp32 <
   1e-4).  Then whisper-small at full width and depth
   (``ShapeConfig("serve", "decode", 448, 8)``: a 128-token prompt a row,
   then ``randn(8, 1500, 768)`` frames, from ``RandomState(0)``):
   ``generate`` of 32 tokens with the launches the plan says (24 flash a
   prefill, 12 non-causal and 12 causal, and 192 projections; 12
   decode_attention and 96 projections a step; cross-attention on the
   reference op), the prefill and 4 teacher-forced steps against the
   ``reference`` backend (bf16 within 5e-2, fp32 within 1e-4), fp32 tokens
   identical to it, the fp32 decode against a teacher-forced prefill, a
   second draw of the frames moving the cross-attention K/V, ``measure``
   and profiles in bf16, ``Engine.run`` refused (a request has no frames);
20. mesh — the multi-device runtime at world size 1 over NCCL, on a
   ``(("data", 1), ("model", 1))`` DeviceMesh (the card's machine has one
   card), each check against the unsharded ``CompiledModel`` on the same
   weights: full-width llama3.2-1b (16 layers) ``generate`` of 32 tokens
   from 8 x 512 prompts on DTensor weights and state, bf16 and fp32, its
   prefill logits within 5e-2 / 2e-4, fp32 tokens identical and the
   launches of matmul_fused, flash_attention and decode_attention (by
   schedule) equal to the unsharded run's; ``Trainer(mesh=)`` at full
   width and 4 of the 16 layers, 3 steps against 3 unsharded ones (losses
   within 1e-5), and again with ``AdamW(compress="int8_ef")`` (the error
   buffers DTensors; losses within 1e-5); deepseek-moe-16b at 2 layers (1 dense + 1 MoE) a bf16
   prefill on DTensor weights within 5e-2 of the unsharded one (the
   one-rank model axis carries data parallelism, as in JAX, so
   ``op_moe_ffn`` runs on the rank's rows); ``make_pipeline_loss`` on a
   ``(("pod", 1), ("data", 1))`` mesh, llama at 4 layers in fp32 with 2
   microbatches, its loss and gradients against the unsharded loss_fn
   (1e-5 / 1e-4) and twice its launches; ResNet-34 at batch 8 a bf16
   forward with conv2d_fused x 36 launched.
   One line logs the backend, the world size, each relerr, the launch
   counts and the phase's seconds. Its process group stays up for 21.
21. serve_mesh — serving on the same one-card mesh: ``Engine(mesh=)``
   over full-width llama3.2-1b at 4 of its 16 layers, the serving
   envelope of phase 9 (8 slots, 1024 tokens, blocks of 16), workloads A
   and B in bf16 and fp32, each against the unsharded engine on the same
   weights: tokens identical, the launches of matmul_fused,
   flash_attention and paged_decode_attention by schedule equal, one
   copy_block launch a fork; ``autotune_decode(mesh=, validate=
   "compile")`` on one batch bucket and its pinned engine on the mesh;
   the dry-run (``python -m repro_torch.launch.dryrun``) of llama3.2-1b
   ``decode_32k`` and ``train_4k`` and resnet34 ``train_4k`` on the
   256-rank fake production mesh, in processes started first and stopped
   before the phase returns, each cell's ``per_device_bytes`` and
   ``fits_budget`` on a line of its own.
22. tiles — the Hopper tiles the tiling pass selects and the kernels take
   (``plan.tiles``): ``flash_attention`` at llama3.2-1b's, qwen1.5-4b's
   and recurrentgemma-2b's heads (8 x 512, causal; the hybrid's 2048-token
   window) at bq 64 and 128, ``conv2d_fused`` at three of ResNet-34's
   3 x 3 convs at bn 64 and 128 and ``matmul_fused`` at llama's q
   projection (4096 rows) at bn 64 and 128, in bf16 and fp32, each held to
   its plain version and timed by CUDA graph beside it, the library call
   and the bound (the ffma flash kernel refuses bq 128 at head width 256
   before any launch); ResNet-34's base flow (phase 5's row: every conv on
   the minimal tile) beside the same flow pinned to the selected tiles,
   its convs counted by schedule and tile, its ms a forward (host clock)
   and its kernels' device ms a forward, timed in turns;
   ``tune_kernel_tiles`` on llama3.2-1b at full width and ``TUNE_DEPTH``
   layers with a fresh tune database under ``build/``: every attention
   candidate compiled, measured and counted at its tile, the winner
   banked, a second call a hit that compiles nothing, and the pinned
   flow's bf16 prefill logits within 5e-2 of the ``reference`` backend's
   and its fp32 greedy tokens (8 steps) identical to them.
23. graphs — the stages on captured CUDA graphs (``repro_torch.flow.
   graphs``), each beside its eager run under ``flow.disable_graphs()``
   in the same call, every launch count equal: full-width llama3.2-1b
   (bf16 drawn, fp32 widened): 4 teacher-forced decode steps' logits bit
   for bit, ``measure("decode")`` in turns (eager, graph, graph, eager)
   and in bf16 the graph's busy share, ``generate_fori`` (tokens equal to
   the eager run's), in bf16 ``generate`` of 32 steps (tokens identical
   to eager and to ``generate_fori``; three more calls capture nothing:
   the prefill's state is copied into the model's decode state) and
   ``decode_segment`` at temperature 1.0 on admitted chains against the
   host loop (tokens identical); ``Engine.run`` on workloads A and D in
   fp32 (tokens identical to eager and to the ``reference`` backend's,
   tokens/s and ms a tick, the prefill batches on one graph a bucket);
   ResNet-34's opt forward in bf16 and fp32 (logits bit for bit, ms in
   turns); the graphs captured, the capture seconds and the
   pool's bytes.
24. family train — ``measure("prefill", trace_dir=)`` of full-width
   llama3.2-1b's bf16 prefill (8 x 512 tokens, 5 timed calls between two
   plain ``measure`` calls): the Chrome trace under ``build/`` names
   ``matmul_wgmma_kernel`` and ``flash_wgmma_kernel``, the counters put
   every projection and flash call the plan says on ``wgmma``, and the
   trace's kernel counts (in all and a call), its device busy share and
   the host's self time by op are logged.  Then the train step, eager, of three families at full width,
   bf16 compute with fp32 masters, ``ShapeConfig("train", "train", S, 8)``
   on one fixed ``SyntheticLM`` batch: recurrentgemma-2b at 3 of its 26
   layers (rec, rec, attn; S 512), deepseek-moe-16b at 2 of 28 (1 dense +
   1 MoE, capacity 1.25; S 512) and whisper-small whole (12 + 12, S 448,
   its ``n_text_ctx``, with ``randn(8, 1500, 768)`` frames), 6
   ``AdamW(lr=1e-3, warmup_steps=1)`` steps each: the last loss below the
   first, the forward's launches by schedule as the plan says (a folded
   unit's twice a step: the block remat's recompute; every product and
   flash call on ``wgmma``, every lru_scan on ``chunked``, none on simt),
   the flash calls by ``causal`` and window (recurrentgemma's at its
   2048-token window, whisper's encoder non-causal), no dispatch
   rejection, the MoE's aux loss every step and its capacity drops; then
   one fp32 step of each at 3 / 2 / 2 + 2 layers, 2 x 256 tokens, on the
   card's kernels and through the ``reference`` backend on the host's CPU
   from the same tree (deepseek's CPU step on the card's routing,
   replayed): the loss and every gradient within 1e-4.  The 6 steps run
   under ``disable_graphs()``: the capacity drops are counted through a
   routing hook.
25. graph stages — the LM prefill and the train step on their captured
   graphs, each beside its eager run under ``disable_graphs()`` in the
   same call: the prefill (8 x 512 tokens) of llama3.2-1b at full width
   and depth in bf16 and fp32 (widened), recurrentgemma-2b and rwkv6-7b at
   8 layers in bf16: logits and every state tensor bit for bit, launches
   by schedule equal, a second call leaving the first one's state as it
   was, ms a call by events in turns, each way's busy share, the pool's
   bytes; the train step, 3 ``AdamW(lr=1e-3, warmup_steps=1)`` steps from
   one init and batch eagerly, on the graph and eagerly again, of
   llama3.2-1b at ``TRAIN_DEPTH`` layers (8 x 512), ResNet-34 (batch 8),
   recurrentgemma-2b at 3 layers, deepseek-moe-16b at 2 and whisper-small
   whole (8 x 448 with frames): launches equal, the losses and every
   parameter bit for bit where the two eager runs are (else within twice
   their gap), ms a step, peak and pool bytes; lru_scan at (8, 512, 2560)
   fp32 by CUDA graph, allocated per call and into one buffer, beside its
   device time inside recurrentgemma-2b's prefill graph.

Phases 5-24 run the stages on graphs wherever the port puts them (the
prefill, the decode stage, generate_fori, decode segments, the train
step); phases 20-21, on a mesh, run eagerly, and so do the runs that
record or force MoE routing through a Python hook (phase 17's
``_routed``, ``_forced`` and workload A's capacity drops, phase 24's
train steps), under ``disable_graphs()``; deepseek's fp32 workload A
then runs again on graphs without the hook. A replay adds the launch counts
its capture recorded, so every launch check reads as on the eager run.

The kernel phases 3, 4 and 7 run before the path phases 5, 6 and 8; phases
9, 10 and 11 come next, then 12, 13, 14 and 15, then 16 and 17, then 18
and 19, then 20, 21 and 22, then 23, then 24, then 25. Every path phase on a default flow
also holds every launch of the three tiled kernels to its default tile (the block
each took before it took a plan tile: ``retiled`` is 0); the base flow
and the tuned flows to the blocks their plan's tiles give. Every path phase also reads
matmul_fused's launches by schedule: the LM prefills on ``wgmma`` (``ffma`` in fp32) and the decode
steps on ``small_m`` (``ffma_small_m``) in the counts the plan gives, no
serving projection on ``simt`` in either precision; the CNN heads as their
shapes say; the base variant never (no op-layer caller passes
``vmem_accum=False``); and conv2d_fused's: ResNet-34 35 on ``wgmma`` (opt
and folded) or ``ffma`` (base) and the stem on ``small_ci``, MobileNetV1 12
on ``wgmma``, its first conv on ``small_ci`` and its 32-channel pointwise
conv on ``mid_ci``, LeNet-5 2 on ``small_ci``; no conv on ``simt``.
Every path phase reads flash_attention's launches by schedule too: in bf16
all on ``wgmma`` (llama's prefill, serving A-D, the hybrid's generate,
window run and workload R, the dense family's, the MoE family's,
llava's and whisper's generates and workload A), in fp32 all on ``ffma``,
none on ``simt``; and decode_attention's and paged_decode_attention's: in bf16
all on ``mma`` (llama's generate and each decode step, serving A-D, the
hybrid's generate, window run and workload R, the dense family's, the MoE
family's and llava's generates, decode steps and workload A),
in fp32 all on ``ffma``, none on ``simt``. TF32
is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``), so every fp32 reference is full
fp32. The last line is ``{"ok": true, "device": {...}}``; the line with the
``"kernels"`` list and the ``nvidia-smi`` line come just before it. Exits
non-zero, printing no result, without a CUDA card. Details go to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet, dense: bf16 tensor cores; fp32 outside the tensor
# cores (the kernels' fp32 path); HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}      # kernel vs plain
PATH_TOL = {"bf16": 5e-2, "fp32": 1e-4}                # model vs reference
SEED = 0
B = 8

# llama3.2-1b at full width (configs/llama32_1b.py): the prefill batch of
# 8 rows x 512 tokens, the 1024-slot decode cache, and the projections of
# one layer as (name, K, N, GLU pair); each runs once per layer
LM_ARCH = "llama3.2-1b"
LM_S, LM_C, LM_H, LM_KV, LM_D, LM_LAYERS = 512, 1024, 32, 8, 64, 16
LM_STEPS = 32
LM_MATMULS = [("q", 2048, 2048, False), ("k", 2048, 512, False),
              ("v", 2048, 512, False), ("o", 2048, 2048, False),
              ("glu", 2048, 8192, True), ("down", 8192, 2048, False)]

# Every distinct ResNet-34 conv at 224 px: (name, H_in, CI, CO, k, stride,
# uses per forward, act in the opt flow).  All carry the BN fold in the opt
# flow; the base flow runs them bare (BN and ReLU are separate ops there).
RESNET_CONVS = [
    ("stem7x7s2", 224, 3, 64, 7, 2, 1, "relu"),
    ("3x3s1_64@56", 56, 64, 64, 3, 1, 6, "relu"),
    ("3x3s2_64to128", 56, 64, 128, 3, 2, 1, "relu"),
    ("3x3s1_128@28", 28, 128, 128, 3, 1, 7, "relu"),
    ("1x1s2_64to128", 56, 64, 128, 1, 2, 1, None),
    ("3x3s2_128to256", 28, 128, 256, 3, 2, 1, "relu"),
    ("3x3s1_256@14", 14, 256, 256, 3, 1, 11, "relu"),
    ("1x1s2_128to256", 28, 128, 256, 1, 2, 1, None),
    ("3x3s2_256to512", 14, 256, 512, 3, 2, 1, "relu"),
    ("3x3s1_512@7", 7, 512, 512, 3, 1, 5, "relu"),
    ("1x1s2_256to512", 14, 256, 512, 1, 2, 1, None),
]
FC = (512, 1000)
# MobileNetV1 at 224 px (configs/mobilenetv1.py), BN + ReLU as the opt
# flow runs them: its first conv (3x3, stride 2, CI 3 -> 32; small_ci), in
# both dtypes, and its 32 -> 64 pointwise conv at 112 px (mid_ci in bf16)
MBV1_FIRST = ("mbv1_first3x3s2", 224, 3, 32, 3, 2, 1, "relu")
MBV1_PW32 = ("mbv1_pw1x1_32to64", 112, 32, 64, 1, 1, 1, "relu")
PW_BATCHES = (4, 8, 16, 32)     # the pointwise conv's batch sweep
# LeNet-5 at 32 px (configs/lenet5.py) as the opt flow runs it in bf16: its
# two 5x5 VALID convs with the ReLU fused, no BN (small_ci), and the FC
# layers that run on simt (N or K off the 8-grid): (name, K, N, act)
LENET_CONVS = [("lenet_c1_5x5", 32, 1, 6, 5, 1, 1, "relu"),
               ("lenet_c3_5x5", 14, 6, 16, 5, 1, 1, "relu")]
LENET_FCS = [("lenet_f6_120to84", 120, 84, "relu"),
             ("lenet_out_84to10", 84, 10, None)]


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    """The kernel wrappers by name (their launch counters are attributes:
    ``repro_torch.kernels.registry.COUNTER_ATTRS``)."""
    from repro_torch.kernels import registry
    return registry.kernel_wrappers()


def reset_counts() -> None:
    """Every launch count to 0 (``registry.reset_counts``): the seven
    wrappers', their splits by schedule, lru_scan's by shape, the base
    variant's, and the three tiled kernels' splits by (schedule, tile) and
    launches off their default tile.  A stage replayed from a CUDA graph
    adds the counts its capture recorded, so they read as the eager run's."""
    from repro_torch.kernels import registry
    torch.cuda.synchronize()
    registry.reset_counts()


# the kernels that take a Hopper tile (plan.tiles: matmul, conv2d,
# attention)
TILED = ("matmul_fused", "conv2d_fused", "flash_attention")


def _tile_label(block):
    return None if block is None else "x".join(str(v) for v in block)


def read_tiles(kernel):
    """A tiled kernel's launches since the last reset by schedule and the
    block it ran (``"wgmma@128x64"``; a schedule that takes no tile
    alone)."""
    torch.cuda.synchronize()
    return {(s if b is None else f"{s}@{_tile_label(b)}"): n
            for (s, b), n in sorted(counters()[kernel].tiles.items(),
                                    key=str)}


def _snap_tiles():
    return {k: dict(counters()[k].tiles) for k in TILED}


def _new_tile(snap):
    """The block of the one tiled launch since ``snap`` (None for a
    schedule that takes no tile or no tiled launch)."""
    torch.cuda.synchronize()
    new = [b for k in TILED for key, n in counters()[k].tiles.items()
           if n != snap[k].get(key, 0) for b in [key[1]]]
    return _tile_label(new[0]) if len(new) == 1 else None


def read_counts():
    """The launch counts; ``matmul_fused_base`` is the base variant's."""
    from repro_torch.kernels import matmul_fused as km
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counters().items()}
    got["matmul_fused_base"] = km.matmul_fused.base_launches
    return got


def read_schedules(kernel="matmul_fused"):
    """matmul_fused's (or flash_attention's, conv2d_fused's,
    decode_attention's, paged_decode_attention's or lru_scan's) launches
    since the last reset, by schedule."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import lru_scan as kl
    from repro_torch.kernels import matmul_fused as km
    torch.cuda.synchronize()
    if kernel == "lru_scan":
        return dict(kl.lru_scan.schedules)
    if kernel == "flash_attention":
        return dict(ka.flash_attention.schedules)
    if kernel in ("decode_attention", "paged_decode_attention"):
        return dict(getattr(kd, kernel).schedules)
    if kernel == "conv2d_fused":
        return dict(kc.conv2d_fused.schedule_launches)
    return dict(km.matmul_fused.schedule_launches)


def _scheduled(want, what, kernel="matmul_fused", default_tiles=True):
    """The kernel's launches by schedule must be ``want`` (a schedule left
    out must be 0); with ``default_tiles`` (every default flow) a tiled
    kernel's launches must all be at the block it took before it took a
    tile (its default: the card plan's selected tile), and
    decode_attention's at the auto split (``retiled`` 0)."""
    got = read_schedules(kernel)
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: {kernel} schedules {got}, want "
                             f"{full}")
    if default_tiles and kernel in TILED + ("decode_attention",) and \
            counters()[kernel].retiled:
        raise AssertionError(f"{what}: {kernel} launched "
                             f"{counters()[kernel].retiled} times off its "
                             f"default tile: {read_tiles(kernel)}")
    return {k: v for k, v in got.items() if v}


def _default_flow(flow):
    """Whether ``flow`` runs the selected tiles (no override)."""
    return flow.tile_select and not flow.tile_overrides


FLASH_SCHEDULES = {"bf16": "wgmma", "fp32": "ffma"}   # at head widths 64-256


def _flash_scheduled(n, prec, what, default_tiles=True):
    """All ``n`` flash_attention launches on wgmma in bf16 and on ffma in
    fp32 (every head width of the LM paths is 64 or 256), none on simt."""
    return _scheduled({FLASH_SCHEDULES[prec]: n}, what, "flash_attention",
                      default_tiles)


# decode_attention's and paged_decode_attention's schedule at head widths
# 64-256 (every LM path's), by precision
DECODE_SCHEDULES = {"bf16": "mma", "fp32": "ffma"}


def _decode_scheduled(n, prec, what, kernel="decode_attention"):
    """All ``n`` launches of decode_attention (or paged_decode_attention)
    on mma in bf16 and on ffma in fp32, none on simt."""
    return _scheduled({DECODE_SCHEDULES[prec]: n}, what, kernel)


# matmul_fused's schedules of the LM projections (every one aligned), by
# precision: the large-M one, the small-M one
LM_SCHEDULES = {"bf16": ("wgmma", "small_m"), "fp32": ("ffma", "ffma_small_m")}


def _lm_scheduled(prefill, decode, prec, what):
    """``prefill`` projections on the precision's large-M schedule,
    ``decode`` on its small-M one, none on simt or the other precision's."""
    big, small = LM_SCHEDULES[prec]
    return _scheduled({big: prefill, small: decode}, what)


def _lru_scheduled(n, what):
    """All ``n`` lru_scan launches on the chunked schedule, and lru_scan's
    launches by (B, S, W, dtype) since the last reset, as
    [[B, S, W, dtype, launches], ...]."""
    from repro_torch.kernels import lru_scan as kl
    _scheduled({"chunked": n}, what, "lru_scan")
    return [[*k, v] for k, v in sorted(kl.lru_scan.shapes.items())]


def _aligned_only(total, prec, what, default_tiles=True):
    """Every one of ``total`` projections ran on the precision's two
    schedules (tensor-core in bf16, FFMA in fp32), none on simt; with
    ``default_tiles`` all at matmul_fused's default tile."""
    got = read_schedules()
    ok = sum(got[k] for k in LM_SCHEDULES[prec])
    if ok != total or ok != sum(got.values()):
        raise AssertionError(f"{what}: matmul_fused schedules {got}, want "
                             f"{total} on {' + '.join(LM_SCHEDULES[prec])}"
                             " and none on simt")
    return _scheduled(got, what, default_tiles=default_tiles)


def _at_plan_tiles(plan, what):
    """Every tiled launch since the last reset ran the block the plan's
    tile gives its schedule (the GLU form and a 64-channel conv at bn 64;
    flash at the plan's head width and precision).  Returns the launches
    by schedule and block."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul_fused as km
    t = plan.tiles
    took = {"matmul_fused": {km.block_of(s, g, t["matmul"])
                             for s in km.SCHEDULES for g in (False, True)},
            "conv2d_fused": {kc.block_of(s, co, t["conv2d"])
                             for s in kc.SCHEDULES for co in (64, 128)}}
    a = plan.cfg.attention
    if a is not None:
        dt = plan.prec.compute_dtype
        took["flash_attention"] = {
            ka.block_of(s, a.head_dim, dt, t["attention"])
            for s in {ka._schedule(dt, a.head_dim), "simt"}}
    for k in TILED:
        bad = [b for (_, b) in counters()[k].tiles if b not in
               took.get(k, {None})]
        if bad:
            raise AssertionError(f"{what}: {k} tiles {read_tiles(k)} under "
                                 f"the plan's {t}")
    return {k: read_tiles(k) for k in TILED if counters()[k].tiles}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device ms of ``fn``: ``iters`` calls captured in one CUDA graph,
    replayed twice between CUDA events.  The replay takes the host's launch
    cost out, which at 8 rows is several times the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    graph.replay()
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1) / (2 * iters)
    del graph
    return ms


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def bound_ms(flops: float, nbytes: float, dt: torch.dtype):
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name} capability={cap} count={torch.cuda.device_count()}"
        f" torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from repro_torch.device import hopper_ok
    from repro_torch.kernels import _build
    if not hopper_ok():
        raise RuntimeError("the kernels target sm_90a; this card is "
                           f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    info = _build.LIBRARY.info
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc {info.seconds:.2f}s,"
        f" built={info.built}) -> {info.path}")
    kernel = "?"
    for line in info.log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = _short_kernel(m.group(1))
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {kernel}: {line.split(':', 1)[-1].strip()}")
    return {"seconds": time.perf_counter() - t0, "built": info.built}


def _short_kernel(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled symbol
    (``matmul_wgmma_kernelILi128ELi1ELi3ELi2E13__nv_bfloat16``)."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}\d+",
                  "", mangled)
    return re.sub(r"^_Z\d+", "", name).split("EEv")[0].split("Ev")[0][:80]


def _conv_simt(x, w, stride, bn, act, padding="SAME"):
    """The SIMT kernel on the same operands, launched directly (no wrapper
    counts it): the schedule every conv ran on before the wgmma and ffma
    kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d as kc
    N, H, W, CI = x.shape
    k, CO = w.shape[0], w.shape[3]
    (pt, _), (pl, _), ho, wo = kc.conv_geometry(H, W, k, k, stride, padding)
    out = torch.empty((N, ho, wo, CO), dtype=x.dtype, device=x.device)
    bnp = [_build.ptr(t) for t in bn] if bn is not None else [None] * 4

    def run():
        _build.call("conv2d_fused", _build.DTYPE_CODES[x.dtype],
                    x.data_ptr(), w.data_ptr(), *bnp, out.data_ptr(), N, H,
                    W, CI, CO, k, k, stride, pt, pl, ho, wo,
                    _build.ACT_CODES[act], _build.stream())
        return out
    return run


# one fp32 case per shape class with the BN fold and ReLU (the base flow
# runs its convs bare, so these count in no forward): the epilogue of the
# ffma kernel at ResNet shapes, unsplit (56 x 56) and split
FP32_EPILOGUE = ("stem7x7s2", "3x3s1_64@56", "3x3s2_128to256",
                 "1x1s2_256to512")


def _conv_case(spec, dt, gen, epilogue=False, padding="SAME", bn_on=True,
               tile=None, twin=True):
    """conv2d_fused at one ResNet-34 shape: the schedule the wrapper took,
    held against the plain version; its CUDA-graph device time (and by
    events) beside the SIMT kernel's at the same shape (held to the plain
    version too), the plain version's, the library's and the bound.  The
    library is cuDNN's conv on an input padded outside the timed region
    (``library_conv_ms``) and the whole yardstick chain of pad, conv and
    the fp32 BN/ReLU ops (``library_ms``).  The bf16 (opt flow) cases carry
    the BN fold and act, the fp32 (base flow) ones run bare, as the flows
    run them, but with ``epilogue`` (a case in no forward: uses 0).
    ``bn_on=False`` drops the BN fold (LeNet-5 has none).  ``tile``: the
    Hopper tile the wrapper is given (None: its default); the tile it ran
    at is recorded.  ``twin=False`` leaves the SIMT kernel out."""
    from repro_torch.kernels import conv2d as kc
    name, H, CI, CO, k, s, uses, act = spec
    dev = torch.device("cuda")
    x = torch.randn(B, H, H, CI, generator=gen, device=dev).to(dt)
    w = (torch.randn(k, k, CI, CO, generator=gen, device=dev)
         * (k * k * CI) ** -0.5).to(dt)
    fused = dt == torch.bfloat16 or epilogue
    bn = tuple(torch.rand(CO, generator=gen, device=dev) + 0.5
               for _ in range(4)) if fused and bn_on else None
    act = act if fused else None

    def kern():
        return kc.conv2d_fused(x, w, stride=s, padding=padding, bn=bn,
                               act=act, tile=tile)

    def plain():
        return kc.conv2d_fused_plain(x, w, stride=s, padding=padding, bn=bn,
                                     act=act)

    (pt, pb), (pl, pr), ho, wo = kc.conv_geometry(H, H, k, k, s, padding)
    xn = x.permute(0, 3, 1, 2)                  # NCHW view, channels_last
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xpad = F.pad(xn, (pl, pr, pt, pb))

    def library():                              # cuDNN, the yardstick only
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), wn, stride=s)
        if bn is not None:
            sc, bi, mu, var = bn
            y = ((y.float() - mu[:, None, None])
                 * (torch.rsqrt(var + 1e-5) * sc)[:, None, None]
                 + bi[:, None, None])
        if act:
            y = F.relu(y)
        return y.to(dt)

    def library_conv():                         # one cuDNN call
        return F.conv2d(xpad, wn, stride=s)

    c0, snap = read_schedules("conv2d_fused"), _snap_tiles()
    y = kern()
    torch.cuda.synchronize()
    sched = [k_ for k_, v in read_schedules("conv2d_fused").items()
             if v != c0[k_]]
    ran_tile = _new_tile(snap)
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    lib_err = relerr(library().permute(0, 2, 3, 1), p)
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"conv2d_fused {name} {dt}: relerr {err} "
                             f"(tol {TOL[dt]}), shape {tuple(y.shape)}, "
                             f"schedules {sched}")
    simt = (_conv_simt(x, w, s, bn, act, padding) if sched[0] != "simt"
            else kern)
    ys = simt() if twin else p
    simt_err = relerr(ys, p)
    simt_aerr = (ys.float() - p.float()).abs().max().item()
    if simt_err >= TOL[dt]:
        raise AssertionError(f"conv2d_fused {name} {dt}: the SIMT kernel's "
                             f"relerr {simt_err}")
    flops = 2.0 * B * ho * wo * k * k * CI * CO
    esz = x.element_size()
    nbytes = (x.numel() + w.numel() + B * ho * wo * CO) * esz \
        + (4 * CO * 4 if bn else 0)
    bms, by = bound_ms(flops, nbytes, dt)
    return {"shape": name + ("+bn_relu" if epilogue else ""),
            "dtype": str(dt).split(".")[-1], "uses": 0 if epilogue else uses,
            "schedule": sched[0], "tile": ran_tile,
            "x": [B, H, H, CI], "w": [k, k, CI, CO], "stride": s,
            "padding": padding, "bn": bn is not None, "act": act,
            "relerr": err, "max_abs_err": aerr, "tol": TOL[dt],
            "simt_relerr": simt_err, "simt_max_abs_err": simt_aerr,
            "library_relerr": lib_err, "flops": flops, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by, "timer": "cuda_graph",
            "ms": graph_ms(kern), "event_ms": cuda_ms(kern),
            "simt_ms": graph_ms(simt) if twin else None,
            "simt_event_ms": cuda_ms(simt) if twin else None,
            "plain_ms": graph_ms(plain), "library_ms": graph_ms(library),
            "library_event_ms": cuda_ms(library),
            "library_conv_ms": graph_ms(library_conv)}


def _simt_wrapper(x, w, **kw):
    """One call as the wrapper made it before the tensor-core schedules:
    check and allocate (``_prepare``), then the SIMT kernel.  Its event time
    beside the wrapper's own is the host cost the schedule choice, the
    split and the second launch add."""
    from repro_torch.kernels import matmul_fused as km
    c = km._prepare(x, w, **kw)
    km._launch_simt(c)
    return c.out


def _fc_case(dt, gen):
    """The ResNet-34 FC head: event-timed (the host's launch rate, as a
    forward sees it) and graph-timed (device time), in bf16 beside the SIMT
    kernel through the old wrapper's steps (``_simt_wrapper``)."""
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    K, N = FC
    x = torch.randn(B, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt)

    def simt():
        return _simt_wrapper(x, w, bias=b, out_dtype=dt)

    def kern():
        return km.matmul_fused(x, w, bias=b, out_dtype=dt)

    def plain():
        return km.matmul_fused_plain(x, w, bias=b, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        return (torch.matmul(x, w).float() + b.float()).to(dt)

    c0 = read_schedules()
    y = kern()
    torch.cuda.synchronize()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    p = plain()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == (B, N) and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"matmul_fused FC {dt}: relerr {err}, "
                             f"schedules {sched}")
    flops = 2.0 * B * K * N
    nbytes = (x.numel() + w.numel() + b.numel() + B * N) * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    old = sched[0] != "simt"
    if old and relerr(simt(), p) >= TOL[dt]:
        raise AssertionError(f"matmul_fused FC {dt}: the SIMT kernel differs "
                             "from the plain version")
    return {"shape": f"fc_{B}x{K}x{N}", "dtype": str(dt).split(".")[-1],
            "uses": 1, "schedule": sched[0], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p), "flops": flops,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": cuda_ms(kern, 100), "graph_ms": graph_ms(kern, 100),
            "simt_ms": cuda_ms(simt, 100) if old else None,
            "simt_graph_ms": graph_ms(simt, 100) if old else None,
            "plain_ms": cuda_ms(plain, 100),
            "library_ms": cuda_ms(library, 100)}


def _lenet_fc_case(spec, gen, dt=torch.bfloat16):
    """One LeNet-5 FC layer at batch 8 as its forward runs it (bias, and
    the ReLU fused where the graph has one): the schedule it took, held
    against its plain version, timed by CUDA graph (and by events) beside
    ``torch.matmul`` + bias (+ ReLU) and its bound."""
    from repro_torch.kernels import matmul_fused as km
    name, K, N, act = spec
    dev = torch.device("cuda")
    x = torch.randn(B, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt)

    def kern():
        return km.matmul_fused(x, w, bias=b, act=act, out_dtype=dt)

    def plain():
        return km.matmul_fused_plain(x, w, bias=b, act=act, out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        y = torch.matmul(x, w).float() + b.float()
        return (F.relu(y) if act else y).to(dt)

    c0 = read_schedules()
    kern()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    if len(sched) != 1:
        raise AssertionError(f"matmul_fused {name}: schedules {sched}")
    flops = 2.0 * B * K * N
    nbytes = (B * K + K * N + N + B * N) * x.element_size()
    rec = _timed_case(kern, plain, library, dt, flops, nbytes,
                      timer=lambda fn: graph_ms(fn, 100))
    return {"shape": name, "arch": "lenet5", "uses": 1, "rows": B,
            "schedule": sched[0], "timer": "cuda_graph", **rec,
            "event_ms": cuda_ms(kern, 100)}


def _pw_batches():
    """MobileNetV1's pointwise conv (BN + ReLU, bf16) on its schedule at
    batch 4-32 beside cuDNN's conv alone, graph ms: how the time grows
    with the batch, and where it starts."""
    from repro_torch.kernels import conv2d as kc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    _, H, CI, CO, _, _, _, _ = MBV1_PW32
    dev = torch.device("cuda")
    w = (torch.randn(1, 1, CI, CO, generator=gen, device=dev)
         * CI ** -0.5).bfloat16()
    bn = tuple(torch.rand(CO, generator=gen, device=dev) + 0.5
               for _ in range(4))
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = []
    for nb in PW_BATCHES:
        x = torch.randn(nb, H, H, CI, generator=gen, device=dev).bfloat16()
        xn = x.permute(0, 3, 1, 2)
        nbytes = (x.numel() + w.numel() + nb * H * H * CO) * 2 + 4 * CO * 4
        out.append({"batch": nb, "bytes": nbytes,
                    "bound_ms": nbytes / PEAK_BYTES * 1e3,
                    "ms": graph_ms(lambda: kc.conv2d_fused(
                        x, w, bn=bn, act="relu")),
                    "library_conv_ms": graph_ms(lambda: F.conv2d(xn, wn))})
    return out


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"conv2d_fused": [], "matmul_fused": []}
    for dt in (torch.bfloat16, torch.float32):
        for spec in RESNET_CONVS:
            c = _conv_case(spec, dt, gen)
            cases["conv2d_fused"].append(c)
            log(json.dumps({"kernel": "conv2d_fused", **c}))
        c = _fc_case(dt, gen)
        cases["matmul_fused"].append(c)
        log(json.dumps({"kernel": "matmul_fused", **c}))
    # drawn last, so that every other case's inputs stay as they were
    for spec in RESNET_CONVS:
        if spec[0] in FP32_EPILOGUE:
            c = _conv_case(spec, torch.float32, gen, epilogue=True)
            cases["conv2d_fused"].append(c)
            log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec, dt in ((MBV1_FIRST, torch.bfloat16), (MBV1_FIRST, torch.float32),
                     (MBV1_PW32, torch.bfloat16)):
        c = {**_conv_case(spec, dt, gen), "arch": "mobilenetv1"}
        if spec is MBV1_PW32:
            c["batch_sweep"] = _pw_batches()
        cases["conv2d_fused"].append(c)
        log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec in LENET_CONVS:
        c = {**_conv_case(spec, torch.bfloat16, gen, padding="VALID",
                          bn_on=False), "arch": "lenet5"}
        cases["conv2d_fused"].append(c)
        log(json.dumps({"kernel": "conv2d_fused", **c}))
    for spec in LENET_FCS:
        c = _lenet_fc_case(spec, gen)
        cases["matmul_fused"].append(c)
        log(json.dumps({"kernel": "matmul_fused", **c}))
    _conv_checks(cases["conv2d_fused"])
    return cases


def _conv_checks(cases):
    """By graph device time, each pair timed in this run: the small_ci
    schedule at ResNet-34's stem, as the flows run it (bf16 with BN + ReLU,
    fp32 bare), no slower than cuDNN's conv alone; MobileNetV1's first conv
    (small_ci) and its pointwise conv (mid_ci) in bf16 no slower than the
    SIMT kernel; the pointwise conv within twice its bound (at least half
    the card's byte rate: 0.0116 ms)."""
    for c in cases:
        arch, sched = c.get("arch"), c["schedule"]
        if c["uses"] == 0:
            continue
        if arch is None and sched == "small_ci":
            other = "library_conv_ms"
        elif arch == "mobilenetv1" and c["dtype"] == "bfloat16" and \
                sched in ("small_ci", "mid_ci"):
            other = "simt_ms"
        else:
            continue
        if c["ms"] > c[other]:
            raise AssertionError(f"conv2d_fused[{sched}] {c['shape']} "
                                 f"{c['dtype']}: {c['ms']:.4f} ms, slower "
                                 f"than {other} {c[other]:.4f}")
        if sched == "mid_ci" and c["ms"] > 2 * c["bound_ms"]:
            raise AssertionError(f"conv2d_fused[mid_ci] {c['shape']}: "
                                 f"{c['ms']:.4f} ms, over twice its bound "
                                 f"{c['bound_ms']:.4f}")


def _timed_case(kern, plain, library, dt, flops, nbytes, iters=20,
                timer=None):
    """Kernel vs plain version (relerr, max |diff|), then the three times
    and the bound of one call, and the tile the call ran at (None for a
    kernel or schedule that takes none).  ``library`` is None where no one
    PyTorch call computes the same function.  The times are CUDA events
    over back-to-back calls, or ``timer(fn)``."""
    snap = _snap_tiles()
    y = kern()
    torch.cuda.synchronize()
    tile = _new_tile(snap)
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt]):
        raise AssertionError(f"relerr {err} (tol {TOL[dt]}), shape "
                             f"{tuple(y.shape)}")
    bms, by = bound_ms(flops, nbytes, dt)
    warm = 1 if iters < 20 else 3
    lib = library is not None
    timer = timer or (lambda fn: cuda_ms(fn, iters, warm))
    return {"dtype": str(dt).split(".")[-1], "relerr": err, "tile": tile,
            "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": relerr(library(), p) if lib else None,
            "flops": flops, "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "ms": timer(kern), "plain_ms": timer(plain),
            "library_ms": timer(library) if lib else None}


def _flash_simt(q, k, v, window, causal=True):
    """The SIMT kernel on the same operands, launched directly (no wrapper
    counts it): the schedule bf16 and fp32 at D >= 64 ran on before the
    wgmma and ffma kernels."""
    from repro_torch.kernels import _build
    b, S, H, D = q.shape
    KV = k.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(b, S)
    pos = pos.contiguous()
    out = torch.empty_like(q)

    def run():
        _build.call("flash_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, k, v, pos, pos, out)],
                    b, S, S, H, KV, D, int(causal), int(window or 0), 0.0,
                    0, _build.stream())
        return out
    return run


def _flash_case(dt, gen, b=B, S=LM_S, H=LM_H, KV=LM_KV, D=LM_D, window=None,
                iters=20, causal=True, tile=None, twin=True):
    """flash_attention, causal, at llama3.2-1b's prefill by default; with
    ``window`` the keys older than it are masked (recurrentgemma-2b); with
    ``causal=False`` every key of the row is live (whisper's encoder).  The
    schedule the wrapper took, its CUDA-graph device time (and by events)
    beside the plain version's, SDPA's (and the name of the kernel SDPA
    ran) and the bound; the SIMT kernel's at the same shape, held to the
    plain version too (not with ``twin=False``).  ``tile``: the Hopper tile
    the wrapper is given (None: its default)."""
    from repro_torch.kernels import attention as ka
    dev = torch.device("cuda")
    q = torch.randn(b, S, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(b, S, KV, D, generator=gen, device=dev).to(dt)
    v = torch.randn(b, S, KV, D, generator=gen, device=dev).to(dt)
    # the library call takes (B, H, S, D) with the KV heads repeated
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    if window is None:
        pairs = S * (S + 1) / 2 if causal else S * S  # the live pairs only
        sdpa = dict(is_causal=causal)
    else:
        ar = torch.arange(S, device=dev)
        mask = (ar[None, :] <= ar[:, None]) & (ar[None, :] > ar[:, None]
                                               - window)
        pairs = float(mask.sum().item())             # live (q, k) pairs
        sdpa = dict(attn_mask=mask)
    flops = 4.0 * D * b * H * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()

    def kern():
        return ka.flash_attention(q, k, v, causal=causal, window=window,
                                  tile=tile)

    def plain():
        return ka.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
    s0 = read_schedules("flash_attention")
    kern()
    sched = [n for n, c in read_schedules("flash_attention").items()
             if c != s0[n]]
    want = FLASH_SCHEDULES["bf16" if dt == torch.bfloat16 else "fp32"]
    if sched != [want]:
        raise AssertionError(f"flash_attention {dt} D={D}: schedules "
                             f"{sched}, want {want}")
    def library():                              # SDPA, the yardstick only
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              **sdpa).transpose(1, 2)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=iters,
                    timer=lambda fn: graph_ms(fn, iters))
    c.update(shape=f"prefill_B{b}_S{S}_H{H}_KV{KV}_D{D}_"
                   + ("causal" if causal else "noncausal")
                   + (f"_window{window}" if window else ""), rows=b,
             schedule=sched[0], event_ms=cuda_ms(kern, iters, 1),
             timer="cuda_graph", library_kernels=_kernel_names(library))
    if not twin:
        return c
    simt = _flash_simt(q, k, v, window, causal)
    p, y = plain(), simt()
    err = relerr(y, p)
    if err >= TOL[dt]:
        raise AssertionError(f"flash_attention {c['shape']}: the SIMT "
                             f"kernel's relerr {err}")
    c.update(simt_ms=graph_ms(simt, iters), simt_relerr=err,
             simt_max_abs_err=(y.float() - p.float()).abs().max().item())
    return c


def _simt_twin(c):
    """A flash, decode or paged case as the SIMT kernel's own entry
    (``flash_attention[simt]`` and so on in the kernels line): its times
    and error from the case, its launches on the main path 0 (no path runs
    it at D >= 64)."""
    return {**c, "schedule": "simt", "ms": c["simt_ms"], "event_ms": None,
            "relerr": c["simt_relerr"], "max_abs_err": c["simt_max_abs_err"]}


def _kernel_names(fn):
    """The CUDA kernels one call of ``fn`` runs, by device time (the
    profiler's names, cut to 80 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return [k[:80] for us, k in rows if us > 0]


def _decode_simt(q, kc, vc, pos, qp, window):
    """The SIMT kernels (a split launch and a combine launch) on the same
    operands, launched directly (no wrapper counts them): the schedule bf16
    and fp32 at D >= 64 ran on before the mma and ffma kernels."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kd
    b, _, H, D = q.shape
    C, KV = kc.shape[1], kc.shape[2]
    nsplit, chunk = kd._simt_splits(b, C, KV, kd._n_sm(q.device))
    ws = torch.empty(b * KV * nsplit * (H // KV) * (D + 2),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)

    def run():
        _build.call("decode_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, kc, vc, pos, qp, out, ws)],
                    b, C, H, KV, D, int(window or 0), 0.0, nsplit, chunk,
                    _build.stream())
        return out
    return run


def _new_schedule(kernel, fn, prec):
    """Run ``fn`` once; the schedule it launched, which must be the
    precision's (mma in bf16, ffma in fp32)."""
    s0 = read_schedules(kernel)
    fn()
    sched = [n for n, c in read_schedules(kernel).items() if c != s0[n]]
    if sched != [DECODE_SCHEDULES[prec]]:
        raise AssertionError(f"{kernel} {prec}: schedules {sched}, want "
                             f"{DECODE_SCHEDULES[prec]}")
    return sched[0]


def _with_simt(c, simt, plain, dt, iters=100):
    """A case record with the SIMT kernel's graph time and error beside,
    held to the plain version too."""
    p, y = plain(), simt()
    err = relerr(y, p)
    if err >= TOL[dt]:
        raise AssertionError(f"{c['shape']}: the SIMT kernel's relerr {err}")
    c.update(simt_ms=graph_ms(simt, iters), simt_relerr=err,
             simt_max_abs_err=(y.float() - p.float()).abs().max().item())
    return c


def _decode_case(dt, gen, b=B, C=LM_C, qpos=LM_C // 2 - 1, H=LM_H, KV=LM_KV,
                 D=LM_D, window=None, tile=None, twin=True, iters=100):
    """decode_attention over a rolling cache of C slots holding positions
    max(0, qpos-C+1) .. qpos (slot c holds the position = c mod C): by
    default llama3.2-1b's 1024-slot cache, half full.  The new schedule
    (mma or ffma) by CUDA graph and by events, beside the SIMT kernel
    (forced, by graph; not with ``twin=False``), SDPA and the plain
    version; at the chunk ``tile`` pins (None: the auto split)."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    lo = max(0, qpos - C + 1)
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    slot_pos = lo + (ar - lo) % C
    pos = torch.where(slot_pos <= qpos, slot_pos, torch.full_like(ar, -1))
    pos = pos.expand(b, C).contiguous()
    qp = torch.full((b, 1), qpos, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, H, D, generator=gen, device=dev).to(dt)
    kc = torch.randn(b, C, KV, D, generator=gen, device=dev).to(dt)
    vc = torch.randn(b, C, KV, D, generator=gen, device=dev).to(dt)
    valid = (pos >= 0) & (pos <= qp)
    if window is not None:
        valid &= pos > qp - window
    live = int(valid[0].sum().item())
    qt = q.transpose(1, 2)
    kt = kc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = vc.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    flops = 4.0 * D * b * H * live
    # the live slots' K and V, every slot's position, q, qpos and out
    nbytes = (2 * b * live * KV * D + 2 * q.numel()) * q.element_size() \
        + (pos.numel() + qp.numel()) * 4

    def kern():
        return kd.decode_attention(q, kc, vc, pos, qp, window=window,
                                   tile=tile)

    def plain():
        return kd.decode_attention_plain(q, kc, vc, pos, qp, window=window)

    def library():                              # SDPA, the yardstick only
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :]).transpose(1, 2)
    prec = "bf16" if dt == torch.bfloat16 else "fp32"
    sched = _new_schedule("decode_attention", kern, prec)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=iters)
    c.update(shape=f"decode_B{b}_C{C}_qpos{qpos}_live{live}_H{H}_KV{KV}"
                   f"_D{D}", rows=b, schedule=sched,
             **_graph_times(c, kern, library, iters))
    if not twin:
        return c
    return _with_simt(c, _decode_simt(q, kc, vc, pos, qp, window), plain, dt)


def _graph_times(c, kern, library, iters=100):
    """``ms`` and ``library_ms`` of a ``_timed_case`` record as CUDA-graph
    device times, its events times beside them as ``event_ms`` and
    ``library_event_ms`` (at these sizes they carry the host's cost a
    call)."""
    return {"event_ms": c["ms"], "library_event_ms": c["library_ms"],
            "ms": graph_ms(kern, iters),
            "library_ms": graph_ms(library, iters), "timer": "cuda_graph"}


# L2 is 50 MB: at M <= 64 (decode, serving ticks) a call rotates over
# enough copies of its weights to read them cold, as a decode step finds
# them after the other layers' weights
COLD_BYTES = 100e6


def _lm_matmul_case(name, M, K, N, glu, dt, gen, uses, crossover=False,
                    bias=False, act=None, tile=None, twin=True):
    """matmul_fused at one projection shape (with ``bias`` a bias vector in
    the epilogue, then ``act``; the GLU pair's act is SiLU): the kernel the wrapper's
    schedule picks, held against the plain version; its device time beside
    the SIMT kernel's at the same shape (the old schedule, bf16 only, also
    held against the plain version), the plain version's, ``torch.matmul``'s
    and the bound.  With ``crossover`` the other tensor-core schedule too,
    forced (small_m only up to 64 rows).  Timed with CUDA graphs
    (``graph_ms``), cold weights at M <= 64; the wrapper and the old
    wrapper's steps (``_simt_wrapper``) also with events (``event_ms``,
    ``simt_event_ms``), which at few rows read the host's cost a call.
    ``tile``: the Hopper tile the wrapper is given (None: its default);
    ``twin=False`` leaves the SIMT kernel out."""
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    n_w = 2 if glu else 1
    wbytes = n_w * K * N * torch.tensor([], dtype=dt).element_size()
    copies = max(1, -(-int(COLD_BYTES) // wbytes)) if M <= 64 else 1
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    ws = [[(torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
           for _ in range(n_w)] for _ in range(copies)]
    bv = (torch.randn(N, generator=gen, device=dev) * 0.1).to(dt) \
        if bias else None
    act = "silu" if glu else act
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        w = ws[turn[0]]
        return w[0], (w[1] if glu else None)

    def kern():
        w, w2 = nxt()
        return km.matmul_fused(x, w, bias=bv, w2=w2, act=act, out_dtype=dt,
                               tile=tile)

    def plain():
        w, w2 = nxt()
        return km.matmul_fused_plain(x, w, bias=bv, w2=w2, act=act,
                                     out_dtype=dt)

    def library():                              # cuBLAS, the yardstick only
        w, w2 = nxt()
        if bias:                   # addmm (+ tanh-GELU): the bias epilogue
            y = torch.addmm(bv, x, w)
            return F.gelu(y, approximate="tanh") if act == "gelu" else y
        if not glu:
            return torch.matmul(x, w)
        return (F.silu(torch.matmul(x, w).float())
                * torch.matmul(x, w2).float()).to(dt)

    simt_calls = [km._prepare(x, w[0], bias=bv, w2=w[1] if glu else None,
                              act=act, out_dtype=dt) for w in ws]

    def simt():                                 # the old kernel, same shape
        turn[0] = (turn[0] + 1) % copies
        km._launch_simt(simt_calls[turn[0]])

    def simt_wrapper():
        w, w2 = nxt()
        return _simt_wrapper(x, w, bias=bv, w2=w2, act=act, out_dtype=dt)

    turn[0] = copies - 1
    c0, snap = read_schedules(), _snap_tiles()
    y = kern()
    torch.cuda.synchronize()
    sched = [k for k, v in read_schedules().items() if v != c0[k]]
    ran_tile = _new_tile(snap)
    turn[0] = copies - 1
    p = plain()
    torch.cuda.synchronize()
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and torch.isfinite(y.float()).all()
            and err < TOL[dt] and len(sched) == 1):
        raise AssertionError(f"matmul_fused {name} {M} rows {dt}: relerr "
                             f"{err} (tol {TOL[dt]}), schedules {sched}")
    old = sched[0] != "simt" and twin
    if old:
        turn[0] = copies - 1
        simt()
        torch.cuda.synchronize()
        if relerr(simt_calls[0].out, p) >= TOL[dt]:
            raise AssertionError(f"matmul_fused {name} {M} rows: the SIMT "
                                 "kernel differs from the plain version")
    alt = {}                   # the other tensor-core schedule, forced
    others = [o for o in ("wgmma", "small_m") if o != sched[0]
              and (o == "wgmma" or M <= 64)] if crossover else []
    for o in others:
        launch = km._LAUNCH[o]

        def forced(launch=launch):
            turn[0] = (turn[0] + 1) % copies
            launch(simt_calls[turn[0]])
        turn[0] = copies - 1
        forced()
        torch.cuda.synchronize()
        if relerr(simt_calls[0].out, p) >= TOL[dt]:
            raise AssertionError(f"matmul_fused {name} {M} rows: forced {o} "
                                 "differs from the plain version")
        alt[o] = forced
    turn[0] = copies - 1
    lib_err = relerr(library(), p)
    flops = 2.0 * M * K * N * n_w
    nbytes = (M * K + n_w * K * N + M * N + (N if bias else 0)) \
        * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    iters = copies * -(-20 // copies) if M <= 64 else 5
    ms = graph_ms(kern, iters)
    simt_ms = graph_ms(simt, iters) if old else ms
    return {"shape": f"{name}_{M}x{K}x{N}" + ("_glu" if glu else "")
                     + ("_bias" if bias else "")
                     + (f"_{act}" if act and not glu else ""),
            "dtype": str(dt).split(".")[-1], "rows": M, "schedule": sched[0],
            "tile": ran_tile,
            "relerr": err, "max_abs_err": aerr, "tol": TOL[dt],
            "library_relerr": lib_err, "flops": flops, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by, "ms": ms, "simt_ms": simt_ms,
            "event_ms": cuda_ms(kern, iters, 1),
            "simt_event_ms": cuda_ms(simt_wrapper, iters, 1) if old else None,
            "plain_ms": graph_ms(plain, iters),
            "library_ms": graph_ms(library, iters),
            "other_schedule_ms": {o: graph_ms(f, iters)
                                  for o, f in alt.items()},
            "weight_copies": copies, "timer": "cuda_graph",
            "uses_per_forward": uses}


# recurrentgemma-2b's distinct projections (d_model 2560, one KV head of
# 256, d_ff 7680, RG-LRU width 2560) as (name, K, N, GLU pair, uses per
# forward of phase 10's 8 layers): q, o and the recurrent blocks' two
# in-branches and out projection are 2560 -> 2560 (2 x 2 + 6 x 3), k and v
# 2560 -> 256 (2 x 2), every layer's GLU pair and down projection (8 each):
# 42 in all
RG_MATMUL_SHAPES = [("d2560", 2560, 2560, False, 22),
                    ("kv", 2560, 256, False, 4),
                    ("glu", 2560, 7680, True, 8),
                    ("down", 7680, 2560, False, 8)]


# rows between a decode step's 8 and a prefill's 4096 where the two
# tensor-core schedules are both timed (bf16, llama): the plain form's
# crossover at 64 rows, the GLU pair's at 32, a verify batch's 40 and a
# chunked catch-up's 128
CROSSOVER = {128: ("q",), 64: ("q",), 40: ("q", "glu"), 32: ("glu",)}


def phase_lm_kernels():
    """Phase 4: the LM kernels at llama3.2-1b's shapes, and matmul_fused at
    both LM models' projections: 4096 prefill rows and 8 decode rows, and
    in bf16 the llama rows of ``CROSSOVER`` between them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "matmul_fused": []}
    rg_cases = []
    for dt in (torch.bfloat16, torch.float32):
        for kname, c in (("flash_attention", _flash_case(dt, gen)),
                         ("decode_attention", _decode_case(dt, gen))):
            cases[kname].append(c)
            log(json.dumps({"kernel": kname, **c}))
        rows = (B * LM_S, 128, 64, 40, 32, B) if dt == torch.bfloat16 \
            else (B * LM_S, B)
        for M in rows:
            for name, K, N, glu in LM_MATMULS:
                if M in CROSSOVER and name not in CROSSOVER[M]:
                    continue
                c = _lm_matmul_case(name, M, K, N, glu, dt, gen, LM_LAYERS,
                                    crossover=M in CROSSOVER)
                cases["matmul_fused"].append(c)
                log(json.dumps({"kernel": "matmul_fused", **c}))
        for M in (B * RG_S, B):
            for name, K, N, glu, uses in RG_MATMUL_SHAPES:
                c = _lm_matmul_case(name, M, K, N, glu, dt, gen, uses)
                rg_cases.append(c)
                log(json.dumps({"kernel": "matmul_fused", "arch": RG_ARCH,
                                **c}))
    for kname in ("flash_attention", "decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases, rg_cases


BASE_TILE = (256, 512, 256)     # repro/kernels/ops.py's default tile


def _base_case(M, K, N, has_bias, dt, gen):
    """The base variant (``vmem_accum=False``, tile (256, 512, 256)) against
    its plain version, on the schedule it took, with the same bits twice;
    timed by CUDA graph beside the old SIMT base kernel (launched directly,
    held to the plain version too; the base variant must beat it), the CW
    form at the same shape and its library call, ``torch.matmul`` (+ bias)
    where that computes the same function: in fp32, where rounding a slab's
    fp32 sum to fp32 changes nothing, and in bf16 at one slab, round(x @ w)
    + bias; none where several bf16 slabs are rounded, which no one
    PyTorch call does."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul_fused as km
    dev = torch.device("cuda")
    x = torch.randn(M, K, generator=gen, device=dev).to(dt)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(dt)
    b = torch.randn(N, generator=gen, device=dev).to(dt) if has_bias else None
    kw = dict(bias=b, tile=BASE_TILE, vmem_accum=False, out_dtype=dt)
    b0 = km.matmul_fused.base_launches
    s0 = dict(km.matmul_fused.base_schedule_launches)
    y = km.matmul_fused(x, w, **kw)
    torch.cuda.synchronize()
    sched = [k for k, v in km.matmul_fused.base_schedule_launches.items()
             if v != s0[k]]
    if km.matmul_fused.base_launches != b0 + 1 or len(sched) != 1:
        raise AssertionError("the base variant did not count its launch: "
                             f"schedules {sched}")
    p = km.matmul_fused_plain(x, w, **kw)
    err, aerr = relerr(y, p), (y.float() - p.float()).abs().max().item()
    if not (y.shape == p.shape and err < TOL[dt]):
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: relerr "
                             f"{err} (tol {TOL[dt]})")
    if not torch.equal(km.matmul_fused(x, w, **kw), y):
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: the "
                             "bits differ on a repeat")
    c = km._prepare(x, w, bias=b, out_dtype=dt)

    def simt():                                 # the SIMT base kernel
        _build.call("matmul_base", *km._codes(c), _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(c.out),
                    c.M, c.K, c.N, km._slab_depth(K, BASE_TILE), 0,
                    _build.stream())
        return c.out
    ys = simt()
    simt_err = relerr(ys, p)
    if simt_err >= TOL[dt]:
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt}: the SIMT "
                             f"base kernel's relerr {simt_err}")

    def cw():
        return km.matmul_fused(x, w, bias=b, out_dtype=dt)
    c0 = read_schedules()
    cw()
    cw_sched = [k for k, v in read_schedules().items() if v != c0[k]]
    flops = 2.0 * M * K * N
    nbytes = (M * K + K * N + M * N + (N if has_bias else 0)) \
        * x.element_size()
    bms, by = bound_ms(flops, nbytes, dt)
    iters = 20 if M <= 64 else 3
    slabs = -(-K // km._slab_depth(K, BASE_TILE))

    def library():                              # cuBLAS, the yardstick only
        y = torch.matmul(x, w)
        return y if b is None else (y.float() + b.float()).to(dt)
    lib = dt == torch.float32 or slabs == 1
    ms = graph_ms(lambda: km.matmul_fused(x, w, **kw), iters)
    simt_ms = graph_ms(simt, iters)
    if ms >= simt_ms:
        raise AssertionError(f"matmul_fused base {M}x{K}x{N} {dt} on "
                             f"{sched[0]}: {ms:.4f} ms, not faster than the "
                             f"SIMT base kernel's {simt_ms:.4f}")
    return {"shape": f"base_{M}x{K}x{N}" + ("_bias" if has_bias else ""),
            "dtype": str(dt).split(".")[-1], "rows": M, "tile": BASE_TILE,
            "slabs": slabs, "schedule": sched[0], "relerr": err,
            "max_abs_err": aerr, "tol": TOL[dt], "simt_relerr": simt_err,
            "simt_max_abs_err": (ys.float() - p.float()).abs().max().item(),
            "library_relerr": relerr(library(), p) if lib else None,
            "flops": flops, "bytes": nbytes, "bound_ms": bms,
            "bound_by": by, "timer": "cuda_graph", "ms": ms,
            "simt_ms": simt_ms, "cw_schedule": cw_sched[0],
            "cw_ms": graph_ms(cw, iters),
            "plain_ms": graph_ms(lambda: km.matmul_fused_plain(x, w, **kw),
                                 iters),
            "library_ms": graph_ms(library, iters) if lib else None}


def phase_base_kernels():
    """The base variant at the ResNet-34 FC shape and a 4096-row llama
    projection, bf16 and fp32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for M, K, N, has_bias in ((B, FC[0], FC[1], True),
                                  (B * LM_S, 2048, 2048, False)):
            c = _base_case(M, K, N, has_bias, dt, gen)
            cases.append(c)
            log(json.dumps({"kernel": "matmul_fused_base", **c}))
    return {"matmul_fused_base": cases}


def _profile(fn, iters: int = 5, named=None):
    """Device busy share of ``iters`` forwards under torch.profiler: the
    summed device time of the device-side kernel events over the window's
    wall time (one stream, so kernels do not overlap), and the top kernels
    by device time; with ``named``, the device ms and launches a forward
    of the kernels whose name holds it.
    The profiler's own cost makes the window longer than an unprofiled one.
    Returns None for the share when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted(((dev_us(e), e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(us for us, _ in rows)
    out = {}
    if named is not None:
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and named in e.key]
        out["named"] = {
            "ms_per_call": sum(dev_us(e) for e in hits) / 1e3 / iters,
            "launches_per_call": sum(e.count for e in hits) / iters}
    return {**out, "iters": iters, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "top": [{"kernel": k[:80], "ms_per_forward": us / 1e3 / iters}
                    for us, k in rows[:6]]}


def _check_logits(name, y, yr, vocab, prec):
    if tuple(y.shape) != (B, vocab) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{name}: logits {tuple(y.shape)} not finite "
                             f"(8, {vocab})")
    err = relerr(y, yr)
    if err >= PATH_TOL[prec]:
        raise AssertionError(f"{name}: logits relerr {err} vs the reference "
                             f"backend (tol {PATH_TOL[prec]})")
    return err


def _forward(arch, flow, want_conv, want_mm, want_sched, smi, measure=True,
             params=None):
    """One forward through the port's entry point with the counters read
    just around it (conv2d_fused's split by schedule ``want_conv``,
    matmul_fused's ``want_sched``; on a default flow every tiled launch at
    its default tile, otherwise every conv block the plan's tile gives),
    held against the reference backend on the same weights (``params``,
    or drawn from the seed) and images."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    serve = ShapeConfig("serve", "prefill", 64, B)
    cm = tflow.compile(get_config(arch), serve, flow)
    ks = cm.plan.kernels
    if ks["conv2d"] != "cuda" or ks["matmul"] != "cuda":
        raise AssertionError(f"{arch}: plan.kernels {ks}")
    params = cm.init_params(SEED) if params is None else params
    rng = np.random.RandomState(SEED)
    cfg = cm.cfg
    x = torch.from_numpy(rng.randn(B, cfg.image_size, cfg.image_size,
                                   cfg.image_channels).astype(np.float32))
    batch = {"images": x.cuda()}
    reset_counts()
    y, _, _ = cm.prefill(params, batch)
    launches = read_counts()
    n_conv = sum(want_conv.values())
    if launches != {"conv2d_fused": n_conv, "matmul_fused": want_mm,
                    "flash_attention": 0, "decode_attention": 0,
                    "paged_decode_attention": 0, "copy_block": 0,
                    "lru_scan": 0, "matmul_fused_base": 0}:
        raise AssertionError(f"{arch}: launches {launches}, want "
                             f"{n_conv} conv / {want_mm} matmul")
    launches = {k: launches[k] for k in ("conv2d_fused", "matmul_fused")}
    dflt = _default_flow(flow)
    schedules = _scheduled(want_sched, arch, default_tiles=dflt)
    conv_schedules = _scheduled(want_conv, arch, "conv2d_fused",
                                default_tiles=dflt)
    from repro_torch.kernels import conv2d as kc
    plan_tile = cm.plan.tiles["conv2d"]
    took = {kc.block_of("wgmma", 64, plan_tile),
            kc.block_of("wgmma", 128, plan_tile), None}
    conv_tiles = read_tiles("conv2d_fused")
    if any(b not in took for (_, b) in counters()["conv2d_fused"].tiles):
        raise AssertionError(f"{arch}: conv tiles {conv_tiles} under the "
                             f"plan's {plan_tile}")
    ref = tflow.compile(get_config(arch), serve, flow, backend="reference")
    if any(b != "ref" for b in ref.plan.kernels.values()):
        raise AssertionError(f"reference plan {ref.plan.kernels}")
    yr, _, _ = ref.prefill(params, batch)
    err = _check_logits(arch, y, yr, cfg.vocab_size, flow.precision)
    rec = {"arch": arch, "flow": flow.precision, "mode": cm.plan.stream.mode,
           "units": cm.describe().splitlines()[2].strip(),
           "launches": launches, "matmul_schedules": schedules,
           "conv_schedules": conv_schedules, "conv_tiles": conv_tiles,
           "plan_tiles": {k: cm.plan.tiles[k] for k in ("matmul", "conv2d")},
           "logits_relerr_vs_reference": err,
           "logits_max_abs": y.float().abs().max().item()}
    if measure:
        m = cm.measure("prefill", iters=10, seed=SEED)
        mr = ref.measure("prefill", iters=10, seed=SEED)
        rec.update({"ms_per_forward": m["measured_step_s"] * 1e3,
                    "mean_ms_per_forward": m["mean_step_s"] * 1e3,
                    "images_per_s": m["images_per_s"],
                    "peak_bytes": m["peak_bytes"],
                    "reference_ms_per_forward": mr["measured_step_s"] * 1e3,
                    "device": m["device"], "nvidia_smi": smi,
                    "profile": _profile(lambda: cm.prefill(params, batch))})
    log(json.dumps({"path": rec}))
    return rec


def phase_path(smi):
    from repro_torch.configs.base import FlowConfig
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    out = []
    # ResNet-34's convs: the 7x7 stem (CI 3) on small_ci, the other 35 on
    # wgmma in bf16 and on ffma in fp32; the FC heads at batch 8 on small_m
    # in bf16, on ffma_small_m in fp32
    bf16_conv = {"wgmma": 35, "small_ci": 1}
    fp32_conv = {"ffma": 35, "small_ci": 1}
    flows = [("opt", FlowConfig(mode="auto"), bf16_conv, {"small_m": 1}),
             ("base", FlowConfig().base(), fp32_conv, {"ffma_small_m": 1}),
             ("folded", FlowConfig(mode="folded"), bf16_conv,
              {"small_m": 1})]
    for label, fl, conv, sched in flows:
        rec = _forward("resnet34", fl, conv, 1, sched, smi)
        rec["flow_name"] = label
        out.append(rec)
    if "4 folded: 3x1, 3x1, 5x1, 2x1" not in out[2]["units"]:
        raise AssertionError(f"folded flow units: {out[2]['units']}")
    # LeNet-5: both convs (CI 1 and 6) on small_ci; 400 -> 120 on small_m;
    # 120 -> 84 and 84 -> 10 (N or K not a multiple of 8) on simt
    out.append(_forward("lenet5", FlowConfig(mode="auto"), {"small_ci": 2},
                        3, {"small_m": 1, "simt": 2}, smi, measure=False))
    # MobileNetV1: the 12 pointwise convs from 64 channels up on wgmma, the
    # first conv (CI 3) on small_ci, the 32-channel pointwise conv on mid_ci
    DISPATCH_REJECTIONS.clear()
    out.append(_forward("mobilenetv1", FlowConfig(mode="auto"),
                        {"wgmma": 12, "small_ci": 1, "mid_ci": 1}, 1,
                        {"small_m": 1}, smi, measure=False))
    dw = sum(n for (op, _), n in DISPATCH_REJECTIONS.items()
             if op == "conv2d")
    if dw != 13:
        raise AssertionError(f"mobilenetv1: {dw} depthwise convs took the "
                             "reference op, want 13")
    return out


def _plan_launches(plan, mode):
    """Kernel launches one ``mode`` call of the model makes, derived from
    the plan: its live attention, matmul and RG-LRU ops, times each unit's
    reps (an RG-LRU scans with ``lru_scan`` in prefill; its decode step is
    plain elementwise work, so a model with one wants 0 there).
    Cross-attention runs on the reference op (the registry keeps it off
    the kernel, as JAX's does), and decode skips the prompt-only ``enc*``
    and ``mm`` blocks.  ``train`` is one train step's forward: a folded
    unit's launches twice under the ``block`` remat (each repetition is
    recomputed in the backward pass)."""
    from repro_torch.core.lowering import live_ops
    want = {"flash_attention": 0, "decode_attention": 0, "matmul_fused": 0}
    for unit in plan.units:
        b0 = plan.graph.blocks[unit.indices[0]]
        if mode == "decode" and (b0.kind.startswith("enc") or b0.kind == "mm"):
            continue
        n = unit.reps * (2 if mode == "train" and unit.folded and
                         plan.flow.remat == "block" else 1)
        for j in range(unit.period):
            blk = plan.graph.blocks[unit.indices[j]]
            for op in live_ops(blk, mode):
                if op.op == "attention" and op.attrs.get("cross"):
                    continue
                if op.op == "attention":
                    k = "decode_attention" if mode == "decode" \
                        else "flash_attention"
                    want[k] += n
                elif op.op in ("matmul", "glu_matmul"):
                    want["matmul_fused"] += n
                elif op.op == "rg_lru":
                    want["lru_scan"] = want.get("lru_scan", 0) + (
                        0 if mode == "decode" else n)
    return want


def _counted(got, want, what):
    """The counts of the kernels in ``want`` (every other kernel must not
    have launched)."""
    got = {k: v for k, v in got.items() if k in want or v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def _real_vocab(y, yr):
    """Logits ``y`` and ``yr`` without the padded vocab entries, which
    ``op_unembed`` sets to -1e9 at the end of the last axis (whisper pads
    51865 to 51872): left in, they would set the scale of ``relerr``."""
    n = int((yr.reshape(-1, yr.shape[-1])[0] > -1e8).sum())
    return y[..., :n], yr[..., :n]


def _lm_check_logits(what, y, yr, tol):
    b, V = yr.shape[0], yr.shape[-1]
    if tuple(y.shape) != (b, 1, V) or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{what}: logits {tuple(y.shape)} not finite "
                             f"({b}, 1, {V})")
    err = relerr(*_real_vocab(y, yr))
    if err >= tol:
        raise AssertionError(f"{what}: logits relerr {err} vs the reference "
                             f"backend (tol {tol})")
    return err


def _flash_ab(cm_p, params, iters):
    """The fp32 prefill (``measure``, CUDA events) with flash_attention on
    its ffma schedule, then forced onto the SIMT kernel, then on ffma again
    (A, B, A in one process): what the new schedule moves end to end."""
    from repro_torch.kernels import attention as ka
    chosen = ka._schedule

    def prefill_ms(force_simt):
        if force_simt:
            ka._schedule = lambda dtype, D: "simt"
        try:
            return cm_p.measure("prefill", iters=iters, seed=SEED,
                                params=params)["measured_step_s"] * 1e3
        finally:
            ka._schedule = chosen
    a = prefill_ms(False)
    b = prefill_ms(True)
    return {"ffma_ms": [a, prefill_ms(False)], "simt_ms": b}


def phase_lm_path(smi):
    """Full-width llama3.2-1b through the port's entry points."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    rec = {"arch": LM_ARCH, "nvidia_smi": smi}
    serve = ShapeConfig("serve", "decode", LM_C, B)
    cm = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"))
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                     "matmul", "glu_matmul")):
        raise AssertionError(f"{LM_ARCH}: plan.kernels {ks}")
    ref = tflow.compile(LM_ARCH, serve, FlowConfig(mode="folded"),
                        backend="reference")
    want_p = _plan_launches(cm.plan, "prefill")
    want_d = _plan_launches(cm.plan, "decode")
    n_mm = LM_LAYERS * len(LM_MATMULS)
    if want_p != {"flash_attention": LM_LAYERS, "decode_attention": 0,
                  "matmul_fused": n_mm} or \
            want_d != {"flash_attention": 0, "decode_attention": LM_LAYERS,
                       "matmul_fused": n_mm}:
        raise AssertionError(f"plan launches {want_p} / {want_d}")
    rec["units"] = cm.describe().splitlines()[2].strip()
    rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
    t0 = time.perf_counter()
    params = cm.init_params(SEED)
    torch.cuda.synchronize()
    rec["init_params_s"] = time.perf_counter() - t0
    V = cm.cfg.vocab_size
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, V, (B, LM_S)).astype(np.int64)).cuda()
    batch = {"tokens": prompt}

    # the main path: greedy generate, 32 tokens per row
    reset_counts()
    toks, _ = cm.generate(params, batch, steps=LM_STEPS)
    rec["launches"] = _counted(read_counts(), {
        k: want_p[k] + (LM_STEPS - 1) * want_d[k] for k in want_p},
        "generate")
    # 4096 prefill rows on wgmma, 8 decode rows on small_m
    rec["matmul_schedules"] = _lm_scheduled(
        want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
        "bf16", "generate")
    rec["flash_schedules"] = _flash_scheduled(want_p["flash_attention"],
                                              "bf16", "generate")
    rec["decode_schedules"] = _decode_scheduled(
        (LM_STEPS - 1) * want_d["decode_attention"], "bf16", "generate")
    if tuple(toks.shape) != (B, LM_STEPS) or not ((toks >= 0)
                                                  & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")

    # teacher-forced on those tokens, beside the reference backend
    reset_counts()
    y, st, _ = cm.prefill(params, batch)
    _counted(read_counts(), want_p, "one prefill")
    _scheduled({"wgmma": want_p["matmul_fused"]}, "one prefill")
    _flash_scheduled(want_p["flash_attention"], "bf16", "one prefill")
    yr, st_r, _ = ref.prefill(params, batch)
    errs = [_lm_check_logits("prefill", y, yr, PATH_TOL["bf16"])]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    same = torch.equal(y[:, -1].argmax(-1).to(torch.int32), toks[:, 0])
    for t in range(LM_STEPS - 1):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        y, st, _ = cm.decode(params, tok, st, LM_S + t)
        _counted(read_counts(), want_d, f"decode step {t}")
        _scheduled({"small_m": want_d["matmul_fused"]}, f"decode step {t}")
        _decode_scheduled(want_d["decode_attention"], "bf16",
                          f"decode step {t}")
        yr, st_r, _ = ref.decode(params, tok, st_r, LM_S + t)
        errs.append(_lm_check_logits(f"decode step {t}", y, yr,
                                     PATH_TOL["bf16"]))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
        same = same and torch.equal(y[:, -1].argmax(-1).to(torch.int32),
                                    toks[:, t + 1])
    rec["bf16"] = {"teacher_forced_repeats_generate": same,
                   "prefill_relerr": errs[0],
                   "decode_relerr_max": max(errs[1:]),
                   "decode_relerr": errs[1:],
                   "greedy_agreement_share": sum(agree) / len(agree),
                   "tokens_row0": toks[0].tolist()}
    log(f"llama bf16: prefill relerr {errs[0]:.3e}, decode relerr max "
        f"{max(errs[1:]):.3e}, greedy tokens agreeing with the reference "
        f"backend: {sum(agree) / len(agree):.3f}")

    # measurements: prefill at 8 x 512 tokens, decode steps
    pre = ShapeConfig("serve", "prefill", LM_S, B)
    cm_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"))
    ref_p = tflow.compile(LM_ARCH, pre, FlowConfig(mode="folded"),
                          backend="reference")
    mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
    mpr = ref_p.measure("prefill", iters=5, seed=SEED, params=params)
    md = cm.measure("decode", iters=20, seed=SEED, params=params)
    mdr = ref.measure("decode", iters=20, seed=SEED, params=params)
    dstate = cm.init_state(B)
    dtok = {"tokens": prompt[:, :1]}
    rec["measure"] = {
        "device": mp["device"],
        "prefill_ms": mp["measured_step_s"] * 1e3,
        "prefill_mean_ms": mp["mean_step_s"] * 1e3,
        "prefill_tokens_per_s": mp["tokens_per_s"],
        "prefill_peak_bytes": mp["peak_bytes"],
        "reference_prefill_ms": mpr["measured_step_s"] * 1e3,
        "decode_ms": md["measured_step_s"] * 1e3,
        "decode_mean_ms": md["mean_step_s"] * 1e3,
        "decode_tokens_per_s": md["tokens_per_s"],
        "reference_decode_ms": mdr["measured_step_s"] * 1e3,
        "prefill_profile": _profile(lambda: cm_p.prefill(params, batch), 2),
        "decode_profile": _profile(
            lambda: cm.decode(params, dtok, dstate, 100), 10)}
    log(json.dumps({"lm_measure": rec["measure"]}))
    del params, st, st_r, dstate

    # fp32: greedy tokens identical to the reference backend's
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = tflow.compile(LM_ARCH, serve, f32)
    ref32 = tflow.compile(LM_ARCH, serve, f32, backend="reference")
    if cm32.plan.kernels["attention"] != "cuda":
        raise AssertionError(f"fp32 plan.kernels {cm32.plan.kernels}")
    p32 = cm32.init_params(SEED)
    reset_counts()
    t32, _ = cm32.generate(p32, batch, steps=LM_STEPS)
    rec["launches_fp32"] = _counted(read_counts(), rec["launches"],
                                    "fp32 generate")
    # 4096 prefill rows on ffma, 8 decode rows on ffma_small_m
    rec["matmul_schedules_fp32"] = _lm_scheduled(
        want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
        "fp32", "fp32 generate")
    rec["flash_schedules_fp32"] = _flash_scheduled(
        rec["launches"]["flash_attention"], "fp32", "fp32 generate")
    rec["decode_schedules_fp32"] = _decode_scheduled(
        rec["launches"]["decode_attention"], "fp32", "fp32 generate")
    t32r, _ = ref32.generate(p32, batch, steps=LM_STEPS)
    if not torch.equal(t32, t32r):
        diff = (t32 != t32r).float().mean().item()
        raise AssertionError(f"fp32 greedy tokens differ from the reference "
                             f"backend's ({diff:.3f} of them)")
    rec["fp32"] = {"greedy_identical_steps": LM_STEPS,
                   "tokens_row0": t32[0].tolist()}
    rec["fp32_prefill"] = _flash_ab(tflow.compile(LM_ARCH, pre, f32), p32,
                                    5)
    log(json.dumps({"lm_fp32_prefill": rec["fp32_prefill"]}))
    log(json.dumps({"lm_path": {k: v for k, v in rec.items()
                                if k != "measure"}}))
    return rec


# ---------------------------------------------------------------------------
# serving: the engine over the paged KV pool
# ---------------------------------------------------------------------------

# the serving configuration: full-width llama3.2-1b, 8 slots of up to 1024
# tokens in blocks of 16 (a pool of 1 + 8 x 64 = 513 blocks)
SERVE_SLOTS, SERVE_SEQ, SERVE_BS, SERVE_NEW = 8, 1024, 16, 32
SERVE_LIVE = [505 + 4 * b for b in range(8)]     # kernel phase: ~520 a row


def _paged_simt(q, kp, vp, bt, qpos, window):
    """The SIMT kernels of paged_decode_attention on the same operands,
    launched directly (no wrapper counts them)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kd
    b, sq, H, D = q.shape
    NB, bs, KV = kp.shape[0], kp.shape[1], kp.shape[2]
    nblk, R = bt.shape[1], sq * (H // KV)
    n_rt = -(-R // kd.paged_rows(D))
    nsplit = kd._simt_paged_splits(b, KV, n_rt, nblk * bs, kd._n_sm(q.device))
    ws = torch.empty(b * KV * nsplit * R * (D + 2), dtype=torch.float32,
                     device=q.device)
    qp = qpos.to(torch.int32).contiguous()
    out = torch.empty_like(q)

    def run():
        _build.call("paged_decode_attention", _build.DTYPE_CODES[q.dtype],
                    *[t.data_ptr() for t in (q, kp, vp, bt, qp, out, ws)],
                    b, sq, H, KV, D, NB, bs, nblk, int(window or 0), 0.0,
                    nsplit, _build.stream())
        return out
    return run


def _paged_case(sq, dt, gen, H=LM_H, KV=LM_KV, D=LM_D, filled=SERVE_LIVE,
                window=None):
    """paged_decode_attention at the serving shape: 8 rows of ``filled``
    tokens so far (by default ~520) in a 513-block pool of 16-token blocks,
    one query a row (a decode tick) or five (a verify row of ngram:4).  The
    new schedule by CUDA graph and by events, beside the SIMT kernel
    (forced, by graph), gather + SDPA and the plain version."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    bs = SERVE_BS
    nblk = SERVE_SEQ // bs
    NB = 1 + SERVE_SLOTS * nblk
    q = torch.randn(B, sq, H, D, generator=gen, device=dev).to(dt)
    kp = torch.randn(NB, bs, KV, D, generator=gen, device=dev).to(dt)
    vp = torch.randn(NB, bs, KV, D, generator=gen, device=dev).to(dt)
    bt = (1 + torch.randperm(B * nblk, generator=gen, device=dev)
          .reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor(filled, dtype=torch.int32, device=dev)
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device=dev)[None]
    kw = dict(qpos=qpos if sq > 1 else None, window=window)
    C = nblk * bs
    kpos = torch.arange(C, device=dev)
    mask = (kpos[None, None, None, :] <= qpos[:, None, :, None])

    def library():                  # gather + SDPA, the yardstick only
        kc = kp[bt.long()].reshape(B, C, KV, D)
        vc = vp[bt.long()].reshape(B, C, KV, D)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.repeat_interleave(H // KV, 2).transpose(1, 2),
            vc.repeat_interleave(H // KV, 2).transpose(1, 2),
            attn_mask=mask).transpose(1, 2)

    live = [int(qpos[b].max().item()) + 1 for b in range(B)]
    flops = 4.0 * D * H * sum(sq * n for n in live)
    nbytes = (2 * sum(live) * KV * D + 2 * q.numel()) * q.element_size() \
        + (B * nblk + qpos.numel()) * 4

    def kern():
        return kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)

    def plain():
        return kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    prec = "bf16" if dt == torch.bfloat16 else "fp32"
    sched = _new_schedule("paged_decode_attention", kern, prec)
    c = _timed_case(kern, plain, library, dt, flops, nbytes, iters=100)
    c.update(shape=f"paged_B{B}_Sq{sq}_H{H}_KV{KV}_D{D}_bs{bs}_live"
                   f"{min(live)}-{max(live)}", sq=sq, schedule=sched,
             **_graph_times(c, kern, library))
    return _with_simt(c, _paged_simt(q, kp, vp, bt, qpos, window), plain, dt)


def _copy_case(dt, gen):
    """copy_block on the folded K and V pools of the serving configuration
    (16 layers x 513 blocks of 16 x 8 x 64 each), one fork: the kernel's
    CUDA-graph device time (and by events, the host's cost a call) beside
    the plain version's and ``torch._foreach_copy_`` on the two blocks (one
    PyTorch call for the same copies)."""
    from repro_torch.kernels import decode_attention as kd
    dev = torch.device("cuda")
    NB = 1 + SERVE_SLOTS * SERVE_SEQ // SERVE_BS
    pair = tuple(torch.randn(LM_LAYERS, NB, SERVE_BS, LM_KV, LM_D,
                             generator=gen, device=dev).to(dt)
                 for _ in range(2))
    plain_pair = tuple(p.clone() for p in pair)
    src, dst = 3, 400
    kd.copy_block(pair, src, dst)
    torch.cuda.synchronize()
    for p in plain_pair:
        kd.copy_block_plain(p, src, dst)
    if not all(torch.equal(a, b) for a, b in zip(pair, plain_pair)):
        raise AssertionError(f"copy_block {dt}: differs from its plain "
                             "version")
    # each pool's block read once and written once
    nbytes = 2.0 * 2 * LM_LAYERS * SERVE_BS * LM_KV * LM_D * \
        pair[0].element_size()
    bms, by = bound_ms(0.0, nbytes, dt)
    dsts, srcs = [p[:, dst] for p in pair], [p[:, src] for p in pair]

    def kern():
        kd.copy_block(pair, src, dst)

    def plain():
        for p in pair:
            kd.copy_block_plain(p, src, dst)

    def library():                      # one PyTorch call, the yardstick
        torch._foreach_copy_(dsts, srcs)
    return {"dtype": str(dt).split(".")[-1],
            "shape": f"pools_2x{LM_LAYERS}x{NB}x{SERVE_BS}x{LM_KV}x{LM_D}",
            "relerr": 0.0, "max_abs_err": 0.0, "tol": 0.0, "flops": 0.0,
            "bytes": nbytes, "bound_ms": bms, "bound_by": by,
            "timer": "cuda_graph", "ms": graph_ms(kern, 200),
            "plain_ms": graph_ms(plain, 200),
            "library_ms": graph_ms(library, 200),
            "event_ms": cuda_ms(kern, 200),
            "plain_event_ms": cuda_ms(plain, 200),
            "library_event_ms": cuda_ms(library, 200)}


def phase_serving_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"paged_decode_attention": [], "copy_block": []}
    for dt in (torch.bfloat16, torch.float32):
        for sq in (1, 5):
            c = _paged_case(sq, dt, gen)
            cases["paged_decode_attention"].append(c)
            log(json.dumps({"kernel": "paged_decode_attention", **c}))
        c = _copy_case(dt, gen)
        cases["copy_block"].append(c)
        log(json.dumps({"kernel": "copy_block", **c}))
    cases["paged_decode_attention"] += [
        _simt_twin(c) for c in cases["paged_decode_attention"]]
    return cases


def _serve_workloads(V):
    """The serving workloads' requests, from RandomState(0): A, 16 prompts
    of 64-512 tokens; B, 8 prompts sharing a 392-token prefix with their
    own 16-token tails and one 200-token prompt (12.5 blocks) sent twice in
    each of two waves, ordered so that the second wave hits the prefix
    index and its two copies of the 200-token prompt share, and fork, the
    released partial block.  32 new tokens a request."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED)
    a = [Request(f"a{i}", rng.randint(0, V, int(rng.randint(64, 513))),
                 max_new_tokens=SERVE_NEW) for i in range(16)]
    prefix = rng.randint(0, V, 392)
    s = [Request(f"s{i}", np.concatenate([prefix, rng.randint(0, V, 16)]),
                 max_new_tokens=SERVE_NEW) for i in range(8)]
    p200 = rng.randint(0, V, 200)
    x = [Request(f"x{i}", p200, max_new_tokens=SERVE_NEW) for i in range(4)]
    return {"A": a, "B": s[:6] + x[:2] + s[6:] + x[2:]}


# workload -> (requests, engine knobs)
SERVE_KNOBS = {"A": ("A", {}), "B": ("B", dict(prefix_cache=True)),
               "C": ("A", dict(chunked_prefill=True, chunk_size=16,
                               speculation="ngram:4")),
               "D": ("A", dict(fori_seg=8))}


def _engine_run(cm, params, reqs, **kw):
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cm, params, EngineConfig(
        max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ, block_size=SERVE_BS,
        **kw))
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, rep


def _tokens(rep):
    return {r.rid: r.tokens for r in rep.results}


def _tick_ms(eng):
    """Median host-clock ms of a decode tick (tick spans end after the
    tick's read-back) and of a tick inside a decode segment."""
    ev = eng.tracer.events()
    ticks = sorted(e["dur"] / 1e3 for e in ev if e["name"] == "tick.decode")
    seg = sorted(e["dur"] / 1e3 / e["args"]["seg"] for e in ev
                 if e["name"] == "tick.fori")
    med = (lambda v: v[len(v) // 2] if v else None)
    return med(ticks), med(seg)


def _serve_record(eng, rep):
    m = rep.metrics
    tick, seg = _tick_ms(eng)
    return {k: m[k] for k in (
        "n_requests", "generated_tokens", "wall_s", "tokens_per_s",
        "p50_ttft_s", "p95_ttft_s", "p50_latency_s", "p95_latency_s",
        "decode_ticks", "prefill_batches", "admissions", "evictions",
        "refills", "fori_segments", "host_syncs", "host_syncs_per_token",
        "pool_blocks", "pool_bytes", "peak_used_blocks", "prefix_hits",
        "cow_forks", "catchup_tokens", "spec_ticks", "spec_tokens_drafted",
        "spec_tokens_accepted")} | {"ms_per_tick": tick,
                                     "ms_per_segment_tick": seg}


def _segment_is_host_free(cm, params):
    """A decode segment at the serving shape (its 8 ticks), generate_fori
    (32 tokens after a 512-token prompt) and the decode stage of one
    engine tick (the tick's own read-back of its tokens aside) queue their
    work without a device-to-host read: each runs once (the warm-up and
    the capture of its graph), then again with PyTorch's sync debug mode
    set to raise on any synchronising call."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.kvcache import slice_state
    eng = Engine(cm, params, EngineConfig(max_batch=SERVE_SLOTS,
                                          max_seq_len=SERVE_SEQ,
                                          block_size=SERVE_BS))
    cache = eng.new_cache()
    seg = cm.decode_segment(8)
    z = torch.zeros(SERVE_SLOTS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    prompt = {"tokens": torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cm.cfg.vocab_size, (SERVE_SLOTS, LM_S)).astype(np.int64)).cuda()}
    part = slice_state(cache.state, cache.slot_axes, SERVE_SLOTS)
    tick = {"tokens": z[:, None].long(), "positions": z[:, None]}
    runs = {"segment": lambda i: seg(params, cache.state, z, z + 8 * i,
                                     gen)[0],
            "generate_fori": lambda i: cm.generate_fori(params, prompt,
                                                        LM_STEPS),
            "tick": lambda i: cm.decode(params, tick, part, 0)[0]}
    out = {}
    for name, run in runs.items():
        run(0)                                  # warm-up and capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = run(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[name] = bool(y.shape[0] == SERVE_SLOTS)
    if not all(out.values()):
        raise AssertionError(f"host-free runs {out}")
    return out


def _serve_want(rep, want_p, per_tick, n_forks=0):
    """The kernel launches of a serving run, from its prefill batches and
    decode ticks."""
    m = rep.metrics
    return {"flash_attention": want_p["flash_attention"] * m["prefill_batches"],
            "matmul_fused": want_p["matmul_fused"] * m["prefill_batches"]
            + per_tick["matmul_fused"] * m["decode_ticks"],
            "paged_decode_attention":
                per_tick["decode_attention"] * m["decode_ticks"],
            "copy_block": n_forks}


def phase_serving(smi):
    """Full-width llama3.2-1b through ``Engine.run`` over the paged pool."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    rec = {"arch": LM_ARCH, "nvidia_smi": smi, "slots": SERVE_SLOTS,
           "max_seq_len": SERVE_SEQ, "block_size": SERVE_BS}
    cm = tflow.compile(LM_ARCH, shape, FlowConfig(mode="folded"))
    ref = tflow.compile(LM_ARCH, shape, FlowConfig(mode="folded"),
                        backend="reference")
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("paged_decode_attention", "copy_block",
                                     "attention", "matmul", "glu_matmul")):
        raise AssertionError(f"serving plan.kernels {ks}")
    want_p = _plan_launches(cm.plan, "prefill")
    per_tick = _plan_launches(cm.plan, "decode")
    n_entries = 1                  # one folded unit, one attention state
    params = cm.init_params(SEED)
    works = _serve_workloads(cm.cfg.vocab_size)

    def counted(rep, what):
        return _counted(read_counts(), _serve_want(
            rep, want_p, per_tick, n_entries * rep.metrics["cow_forks"]),
            what)

    # the main path, bf16: each workload with the counts set to 0 just
    # before it and read just after
    runs, launches, scheds, fscheds = {}, {}, {}, {}
    for name, (wl, kw) in SERVE_KNOBS.items():
        reset_counts()
        eng, rep = _engine_run(cm, params, works[wl], trace=True, **kw)
        launches[name] = counted(rep, f"workload {name}")
        scheds[name] = _aligned_only(launches[name]["matmul_fused"], "bf16",
                                     f"workload {name}")
        fscheds[name] = _flash_scheduled(launches[name]["flash_attention"],
                                         "bf16", f"workload {name}")
        psched = _decode_scheduled(
            launches[name]["paged_decode_attention"], "bf16",
            f"workload {name}", "paged_decode_attention")
        runs[name] = rep
        r = _serve_record(eng, rep)
        r["launches"] = launches[name]
        r["matmul_schedules"] = scheds[name]
        r["flash_schedules"] = fscheds[name]
        r["paged_schedules"] = psched
        rec[f"bf16_{name}"] = r
        log(json.dumps({"serving": name, "precision": "bf16", **r}))
    b = runs["B"].metrics
    if b["prefix_hits"] < 1 or b["cow_forks"] < 1:
        raise AssertionError(f"workload B: prefix_hits {b['prefix_hits']}, "
                             f"cow_forks {b['cow_forks']}")
    rec["launches"] = {k: sum(launches[w][k] for w in launches)
                       for k in launches["A"]}
    rec["flash_schedules"] = {"wgmma": rec["launches"]["flash_attention"]}
    rec["paged_schedules"] = {
        "mma": rec["launches"]["paged_decode_attention"]}
    rec["segment_host_free"] = _segment_is_host_free(cm, params)

    # bf16 logits of A against the reference backend, up to each request's
    # first differing token
    _, cap = _engine_run(cm, params, works["A"], capture_logits=True)
    _, cap_r = _engine_run(ref, params, works["A"], capture_logits=True)
    errs, agree, total = [], 0, 0
    for r in cap.results:
        rr = cap_r.by_id[r.rid]
        for t, (a, b_) in enumerate(zip(r.tokens, rr.tokens)):
            la, lb = torch.from_numpy(r.logits[t]), torch.from_numpy(
                rr.logits[t])
            if not torch.isfinite(la).all():
                raise AssertionError(f"{r.rid}: logits not finite at {t}")
            errs.append(relerr(la, lb))
            if a != b_:
                break
        agree += sum(a == b_ for a, b_ in zip(r.tokens, rr.tokens))
        total += len(rr.tokens)
    if max(errs) >= PATH_TOL["bf16"]:
        raise AssertionError(f"serving bf16 logits relerr {max(errs)} vs the "
                             f"reference backend (tol {PATH_TOL['bf16']})")
    rec["bf16_logits"] = {"relerr_max": max(errs), "rows": len(errs),
                          "greedy_agreement_share": agree / total}
    log(f"serving bf16: logits relerr max {max(errs):.3e} over {len(errs)} "
        f"rows; greedy tokens agreeing with the reference backend: "
        f"{agree / total:.3f}")

    # the device-busy share of one profiled run (A's first wave)
    rec["profile"] = _profile(
        lambda: _engine_run(cm, params, works["A"][:SERVE_SLOTS]), 1)
    del params, cap, cap_r

    # fp32: every workload's greedy tokens equal the reference backend's;
    # C and D equal A, B equals its own cold run
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = tflow.compile(LM_ARCH, shape, f32)
    ref32 = tflow.compile(LM_ARCH, shape, f32, backend="reference")
    p32 = cm32.init_params(SEED)
    toks, launches32 = {}, {}
    for name, (wl, kw) in SERVE_KNOBS.items():
        reset_counts()
        eng, rep = _engine_run(cm32, p32, works[wl], **kw)
        launches32[name] = counted(rep, f"fp32 workload {name}")
        _aligned_only(launches32[name]["matmul_fused"], "fp32",
                      f"fp32 workload {name}")
        _flash_scheduled(launches32[name]["flash_attention"], "fp32",
                         f"fp32 workload {name}")
        _decode_scheduled(launches32[name]["paged_decode_attention"], "fp32",
                          f"fp32 workload {name}", "paged_decode_attention")
        _, rep_r = _engine_run(ref32, p32, works[wl], **kw)
        toks[name] = _tokens(rep)
        if toks[name] != _tokens(rep_r):
            raise AssertionError(f"fp32 workload {name}: greedy tokens "
                                 "differ from the reference backend's")
    _, cold = _engine_run(cm32, p32, works["B"])
    checks = {"C == A": toks["C"] == toks["A"], "D == A": toks["D"] == toks["A"],
              "B == B cold": toks["B"] == _tokens(cold)}
    if not all(checks.values()):
        raise AssertionError(f"fp32 serving identities {checks}")
    rec["fp32"] = {"identical_to_reference": list(SERVE_KNOBS),
                   "identities": list(checks),
                   "tokens_a0": toks["A"]["a0"]}
    rec["launches_fp32"] = {k: sum(launches32[w][k] for w in launches32)
                            for k in launches32["A"]}
    rec["paged_schedules_fp32"] = {
        "ffma": rec["launches_fp32"]["paged_decode_attention"]}
    log(json.dumps({"serving_path": {k: v for k, v in rec.items()
                                     if not k.startswith("bf16_")}}))
    return rec


# ---------------------------------------------------------------------------
# recurrent: the RG-LRU hybrid, recurrentgemma-2b
# ---------------------------------------------------------------------------

# recurrentgemma-2b at full width (configs/recurrentgemma_2b.py), cut from
# 26 layers ((rec, rec, attn) x 8 + (rec, rec)) to 8 ((rec, rec, attn) x 2
# + (rec, rec)) since phases 16-17 joined: the script's time limit; 10
# heads over 1 KV head of 256 with a 2048-token window; RG-LRU width 2560
RG_ARCH = "recurrentgemma-2b"
RG_DEPTH = 8
RG_S, RG_C, RG_H, RG_KV, RG_D, RG_W = 512, 1024, 10, 1, 256, 2560
RG_WINDOW, RG_ATTN, RG_REC = 2048, 2, 6
RG_MATMULS = 42        # a prefill or decode step: 2 attn x 6 + 6 rec x 5
RG_STEPS = 32
# the window run: one row, a 2080-token prompt (the window cuts in the
# prefill), 24 decode steps over the 2048-slot rolling cache (it wraps)
RG_LONG, RG_LONG_STEPS = 2080, 24
# workload R: 16 prompts of exactly 256 tokens (the bucket), 16-48 new
# tokens each, greedy, 8 slots of up to 1024 tokens in blocks of 16
RG_PROMPT, RG_REQS = 256, 16
# the paged kernel's case: 8 rows of 260-295 tokens so far (a 256-token
# prompt and its new tokens)
RG_FILLED = [260 + 5 * b for b in range(8)]


def _lru_case(shape, dt, gen):
    """lru_scan at one (B, S, W) shape: a in (0, 1) as the RG-LRU gate gives
    it, the kernel on its schedule by CUDA graph and by events, the
    sequential kernel it replaced at the same shape (launched directly, no
    wrapper counts it; held to the plain version too) by graph, the plain
    version by events.  The wrapper allocates h every call, so its graph
    replays write a fresh buffer each; ``direct_ms`` times the chunked
    kernel launched directly into one buffer, as the sequential kernel is.
    No single PyTorch call computes a linear recurrence, so there is no
    library time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import lru_scan as kl
    Bn, S, W = shape
    dev = torch.device("cuda")
    a = torch.rand(Bn, S, W, generator=gen, device=dev).to(dt)
    b = torch.randn(Bn, S, W, generator=gen, device=dev).to(dt)
    flops = 2.0 * a.numel()                         # one FMA an element
    nbytes = 3.0 * a.numel() * a.element_size()     # read a, b; write h
    hs = torch.empty_like(a)
    steps = kl.scan_geometry(Bn, S, W, a.element_size(),
                             torch.cuda.get_device_properties(
                                 0).multi_processor_count)[0]

    def kern():
        return kl.lru_scan(a, b)

    def seq():
        _build.call("lru_scan", _build.DTYPE_CODES[dt], a.data_ptr(),
                    b.data_ptr(), hs.data_ptr(), Bn, S, W, _build.stream())
        return hs

    def direct():      # the chunked kernel into one buffer, as seq() is
        _build.call("lru_scan_chunked", _build.DTYPE_CODES[dt],
                    a.data_ptr(), b.data_ptr(), hs.data_ptr(), Bn, S, W,
                    steps, _build.stream())
        return hs
    s0 = read_schedules("lru_scan")
    c = _timed_case(kern, lambda: kl.lru_scan_plain(a, b), None, dt, flops,
                    nbytes, iters=50)
    sched = [k for k, v in read_schedules("lru_scan").items() if v != s0[k]]
    p = kl.lru_scan_plain(a, b)
    seq_err = relerr(seq(), p)
    if seq_err >= TOL[dt]:
        raise AssertionError(f"lru_scan {shape} {dt}: the sequential "
                             f"kernel's relerr {seq_err}")
    c.update(shape=f"scan_B{Bn}_S{S}_W{W}", rows=Bn, B=Bn, S=S, W=W,
             schedule=sched[0], event_ms=c["ms"], ms=graph_ms(kern, 50),
             timer="cuda_graph", seq_ms=graph_ms(seq, 50),
             seq_relerr=seq_err,
             seq_max_abs_err=(seq().float() - p.float()).abs().max().item(),
             direct_ms=graph_ms(direct, 50), steps=steps)
    if relerr(direct(), p) >= TOL[dt]:
        raise AssertionError(f"lru_scan {shape} {dt}: the chunked kernel "
                             "launched directly differs from the plain "
                             "version")
    return c


def _seq_twin(c):
    """The sequential lru_scan kernel's record at a case's shape
    (``lru_scan[seq]`` in the kernels line)."""
    return {**c, "schedule": "seq", "ms": c["seq_ms"], "event_ms": None,
            "relerr": c["seq_relerr"], "max_abs_err": c["seq_max_abs_err"]}


def phase_lru_kernels(rg):
    """Phase 11: lru_scan at every (B, S, W) shape the recurrent path
    launched it at (fp32: ``op_rg_lru`` hands it fp32 ``a`` and ``b`` in
    both model precisions), and at the 8 x 512 prefill in bf16 (a kernel
    case no path runs).  At each path shape the chunked kernel must be no
    slower by graph device time than the sequential one."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    seen = {}
    for run in ("generate", "window", "serve"):
        for prec in ("bf16", "fp32"):
            for Bn, S, W, dt, n in rg[f"{run}_{prec}"]["lru_shapes"]:
                key = (Bn, S, W, dt)
                seen[key] = seen.get(key, 0) + n
    if any(k[3] != "float32" for k in seen):
        raise AssertionError(f"lru_scan path shapes {seen}: want fp32 only")
    cases = []
    for (Bn, S, W, dt), n in sorted(seen.items(), key=lambda kv: (
            -kv[0][0] * kv[0][1], kv[0])):
        c = {**_lru_case((Bn, S, W), torch.float32, gen), "path_launches": n}
        if c["ms"] > c["seq_ms"]:
            raise AssertionError(f"lru_scan {c['shape']}: chunked "
                                 f"{c['ms']:.4f} ms, slower than the "
                                 f"sequential kernel {c['seq_ms']:.4f}")
        cases.append(c)
        log(json.dumps({"kernel": "lru_scan", "arch": RG_ARCH, **c}))
    c = {**_lru_case((B, RG_S, RG_W), torch.bfloat16, gen),
         "path_launches": 0}
    cases.append(c)
    log(json.dumps({"kernel": "lru_scan", "arch": RG_ARCH, **c}))
    return {"lru_scan": cases}


def phase_rec_kernels():
    """Phase 9: the recurrent path's kernels at its shapes, bf16 and fp32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "paged_decode_attention": []}
    heads = dict(H=RG_H, KV=RG_KV, D=RG_D, window=RG_WINDOW)
    for dt in (torch.bfloat16, torch.float32):
        for kname, c in (
                ("flash_attention",
                 _flash_case(dt, gen, S=RG_S, iters=10, **heads)),
                ("flash_attention",
                 _flash_case(dt, gen, b=1, S=RG_LONG, iters=10, **heads)),
                ("decode_attention", _decode_case(
                    dt, gen, C=RG_C, qpos=RG_S + RG_STEPS - 2, **heads)),
                ("decode_attention", _decode_case(
                    dt, gen, b=1, C=RG_WINDOW,
                    qpos=RG_LONG + RG_LONG_STEPS - 2, **heads)),
                ("paged_decode_attention",
                 _paged_case(1, dt, gen, filled=RG_FILLED, **heads))):
            cases[kname].append(c)
            log(json.dumps({"kernel": kname, "arch": RG_ARCH, **c}))
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


def _rg_requests(V):
    """Workload R from RandomState(0): 16 prompts of exactly 256 tokens,
    16-48 new tokens each, so evictions and refills come at different
    ticks."""
    from repro_torch.serving import Request
    rng = np.random.RandomState(SEED)
    return [Request(f"r{i}", rng.randint(0, V, RG_PROMPT).astype(np.int32),
                    max_new_tokens=int(rng.randint(16, 49)))
            for i in range(RG_REQS)]


def _rg_engine(cm, params, reqs, **kw):
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(cm, params, EngineConfig(
        max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ, block_size=SERVE_BS,
        prompt_buckets=(RG_PROMPT,), **kw))
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, rep


def _serve_logits(cap, ref, prec, what="workload R"):
    """Every logits row that ``cap`` captured against ``ref``'s, up to the
    first token where a request's two streams part: finite, and relerr
    under PATH_TOL[prec]."""
    errs, agree, total = [], 0, 0
    for x in cap.results:
        xr = ref.by_id[x.rid]
        for t, (a, b_) in enumerate(zip(x.tokens, xr.tokens)):
            la = torch.from_numpy(x.logits[t])
            if not torch.isfinite(la).all():
                raise AssertionError(f"{x.rid}: logits not finite")
            errs.append(relerr(la, torch.from_numpy(xr.logits[t])))
            if a != b_:
                break
        agree += sum(a == b_ for a, b_ in zip(x.tokens, xr.tokens))
        total += len(xr.tokens)
    if max(errs) >= PATH_TOL[prec]:
        raise AssertionError(f"{what} {prec} logits relerr {max(errs)} "
                             "vs the reference backend")
    return {"relerr_max": max(errs), "rows": len(errs),
            "greedy_agreement_share": agree / total}


def _refused(what, fn, match):
    """``fn`` must raise the ValueError that refuses ``what``."""
    try:
        fn()
    except ValueError as e:
        if match not in str(e):
            raise AssertionError(f"{what}: refused with {e!r}, want "
                                 f"{match!r}") from e
        return str(e)
    raise AssertionError(f"{what} was served; it must be refused")


def _lm_generate(cm, ref, params, prompt, steps, want_p, want_d, prec):
    """One generate through the port's entry point with the counts set to
    0 just before and read just after; then the prefill and each
    teacher-forced decode step held against the reference backend (logits
    within ``PATH_TOL[prec]``), and in fp32 the greedy tokens identical to
    the reference backend's."""
    b, S = prompt.shape
    batch = {"tokens": prompt}
    reset_counts()
    toks, _ = cm.generate(params, batch, steps=steps)
    launches = _counted(read_counts(), {
        k: want_p.get(k, 0) + (steps - 1) * want_d.get(k, 0)
        for k in set(want_p) | set(want_d)}, f"{prec} generate")
    # the prefill's rows (b x S >= 512) on wgmma (ffma in fp32), decode rows
    # (b <= 8) on small_m (ffma_small_m)
    sched = _lm_scheduled(want_p["matmul_fused"],
                          (steps - 1) * want_d["matmul_fused"], prec,
                          f"{prec} generate")
    fsched = _flash_scheduled(launches["flash_attention"], prec,
                              f"{prec} generate")
    dsched = _decode_scheduled(launches["decode_attention"], prec,
                               f"{prec} generate")
    lshapes = _lru_scheduled(launches.get("lru_scan", 0),
                             f"{prec} generate")
    V = cm.cfg.vocab_size
    if tuple(toks.shape) != (b, steps) or not ((toks >= 0) & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")
    rec = {"launches": launches, "matmul_schedules": sched,
           "flash_schedules": fsched, "decode_schedules": dsched,
           "lru_shapes": lshapes, "tokens_row0": toks[0].tolist()}
    if prec == "fp32":
        tr, _ = ref.generate(params, batch, steps=steps)
        if not torch.equal(toks, tr):
            diff = (toks != tr).float().mean().item()
            raise AssertionError(f"fp32 greedy tokens differ from the "
                                 f"reference backend's ({diff:.3f} of them)")
        rec["greedy_identical_steps"] = steps
    reset_counts()
    y, st, _ = cm.prefill(params, batch)
    _counted(read_counts(), want_p, "one prefill")
    _flash_scheduled(want_p["flash_attention"], prec, "one prefill")
    yr, st_r, _ = ref.prefill(params, batch)
    errs = [_lm_check_logits("prefill", y, yr, PATH_TOL[prec])]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    for t in range(steps - 1):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        y, st, _ = cm.decode(params, tok, st, S + t)
        _counted(read_counts(), want_d, f"decode step {t}")
        _decode_scheduled(want_d["decode_attention"], prec,
                          f"decode step {t}")
        yr, st_r, _ = ref.decode(params, tok, st_r, S + t)
        errs.append(_lm_check_logits(f"decode step {t}", y, yr,
                                     PATH_TOL[prec]))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
    rec.update(prefill_relerr=errs[0], decode_relerr_max=max(errs[1:]),
               greedy_agreement_share=sum(agree) / len(agree))
    return rec


def _rg_cfg():
    """recurrentgemma-2b at full width and ``RG_DEPTH`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(RG_ARCH), n_layers=RG_DEPTH)


def phase_rec_path(smi):
    """Phase 10: recurrentgemma-2b at full width and ``RG_DEPTH`` layers
    (random weights from seed 0) through ``flow.compile`` (generate; the
    window run) and ``Engine.run`` (workload R), bf16 then fp32."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    rec = {"arch": RG_ARCH, "nvidia_smi": smi, "layers": RG_DEPTH}
    gen_shape = ShapeConfig("serve", "decode", RG_C, B)
    long_shape = ShapeConfig("serve", "decode", 4096, 1)
    srv_shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    V = None
    runs = {}
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(_rg_cfg(), gen_shape, fl)
        ref = tflow.compile(_rg_cfg(), gen_shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                         "matmul", "glu_matmul", "rg_lru")):
            raise AssertionError(f"{RG_ARCH}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        if want_p != {"flash_attention": RG_ATTN, "decode_attention": 0,
                      "matmul_fused": RG_MATMULS, "lru_scan": RG_REC} or \
                want_d != {"flash_attention": 0, "decode_attention": RG_ATTN,
                           "matmul_fused": RG_MATMULS, "lru_scan": 0}:
            raise AssertionError(f"plan launches {want_p} / {want_d}")
        rec["units"] = cm.describe().splitlines()[2].strip()
        rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
        t0 = time.perf_counter()
        params = cm.init_params(SEED)
        torch.cuda.synchronize()
        rec[f"init_params_s_{prec}"] = time.perf_counter() - t0
        V = cm.cfg.vocab_size
        rs = np.random.RandomState(SEED)
        prompt = torch.from_numpy(rs.randint(0, V, (B, RG_S))).cuda()
        long_prompt = torch.from_numpy(rs.randint(0, V, (1, RG_LONG))).cuda()

        # a. generate: 32 tokens a row after a 512-token prompt
        g = _lm_generate(cm, ref, params, prompt, RG_STEPS, want_p, want_d,
                         prec)
        rec[f"generate_{prec}"] = g
        log(json.dumps({"rec_generate": prec, **g}))
        if prec == "bf16":
            pre = ShapeConfig("serve", "prefill", RG_S, B)
            cm_p = tflow.compile(_rg_cfg(), pre, fl)
            ref_p = tflow.compile(_rg_cfg(), pre, fl, backend="reference")
            mp = cm_p.measure("prefill", iters=3, seed=SEED, params=params)
            mpr = ref_p.measure("prefill", iters=3, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            mdr = ref.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": prompt[:, :1]}
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "reference_prefill_ms": mpr["measured_step_s"] * 1e3,
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "reference_decode_ms": mdr["measured_step_s"] * 1e3,
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, {"tokens": prompt}), 2),
                "decode_profile": _profile(
                    lambda: cm.decode(params, dtok, dstate, 100), 10)}
            log(json.dumps({"rec_measure": rec["measure"]}))
            del dstate
        else:
            rec["fp32_prefill"] = _flash_ab(tflow.compile(
                _rg_cfg(), ShapeConfig("serve", "prefill", RG_S, B), fl),
                params, 3)
            log(json.dumps({"rec_fp32_prefill": rec["fp32_prefill"]}))

        # b. the window: 2080-token prompt, 24 steps over 2048 slots
        cml = tflow.compile(_rg_cfg(), long_shape, fl)
        refl = tflow.compile(_rg_cfg(), long_shape, fl, backend="reference")
        if cml.plan.cache_len != RG_WINDOW:
            raise AssertionError(f"window run: cache_len "
                                 f"{cml.plan.cache_len}")
        w = _lm_generate(cml, refl, params, long_prompt, RG_LONG_STEPS,
                         _plan_launches(cml.plan, "prefill"),
                         _plan_launches(cml.plan, "decode"), prec)
        rec[f"window_{prec}"] = w
        log(json.dumps({"rec_window": prec, **w}))

        # c. serving: workload R through Engine.run
        cms = tflow.compile(_rg_cfg(), srv_shape, fl)
        refs = tflow.compile(_rg_cfg(), srv_shape, fl, backend="reference")
        sp = _plan_launches(cms.plan, "prefill")
        st = _plan_launches(cms.plan, "decode")
        reqs = _rg_requests(V)
        reset_counts()
        eng, rep = _rg_engine(cms, params, reqs, trace=prec == "bf16")
        m = rep.metrics
        want = {"flash_attention": sp["flash_attention"] * m["prefill_batches"],
                "lru_scan": sp["lru_scan"] * m["prefill_batches"],
                "matmul_fused": sp["matmul_fused"] * m["prefill_batches"]
                + st["matmul_fused"] * m["decode_ticks"],
                "paged_decode_attention":
                    st["decode_attention"] * m["decode_ticks"]}
        s_launch = _counted(read_counts(), want, f"{prec} workload R")
        # prefill batches (>= 256 rows) on wgmma (ffma in fp32), ticks on
        # small_m (ffma_small_m)
        s_sched = _lm_scheduled(
            sp["matmul_fused"] * m["prefill_batches"],
            st["matmul_fused"] * m["decode_ticks"], prec,
            f"{prec} workload R")
        f_sched = _flash_scheduled(want["flash_attention"], prec,
                                   f"{prec} workload R")
        p_sched = _decode_scheduled(want["paged_decode_attention"], prec,
                                    f"{prec} workload R",
                                    "paged_decode_attention")
        l_shapes = _lru_scheduled(want["lru_scan"], f"{prec} workload R")
        runs[prec] = rep
        r = _serve_record(eng, rep)
        r.update(launches=s_launch, matmul_schedules=s_sched,
                 flash_schedules=f_sched, paged_schedules=p_sched,
                 lru_shapes=l_shapes,
                 dense_state_bytes=eng.last_cache.dense_bytes())
        rec[f"serve_{prec}"] = r
        log(json.dumps({"serving": "R", "arch": RG_ARCH, "precision": prec,
                        **r}))
        _, rep_r = _rg_engine(refs, params, reqs, capture_logits=True)
        _, cap = _rg_engine(cms, params, reqs, capture_logits=True)
        logits = _serve_logits(cap, rep_r, prec)
        if prec == "fp32":
            if not _tokens(rep) == _tokens(cap) == _tokens(rep_r):
                raise AssertionError("fp32 workload R: greedy tokens differ "
                                     "from the reference backend's")
            rec["serve_fp32"].update(identical_to_reference=True,
                                     logits=logits)
        else:
            rec["serve_bf16_logits"] = logits
            # the refusals, with the recurrent state's own messages
            pad = [dataclasses.replace(reqs[0], rid="pad",
                                       prompt=reqs[0].prompt[1:])]
            rec["refusals"] = {
                "padded_prompt": _refused(
                    "a padded prompt", lambda: _rg_engine(cms, params, pad),
                    "recurrent temporal-mixing"),
                "prefix_cache": _refused(
                    "prefix_cache", lambda: _rg_engine(
                        cms, params, reqs[:1], prefix_cache=True),
                    "prefix_cache requires a pure attention decoder"),
                "chunked_prefill": _refused(
                    "chunked prefill", lambda: _rg_engine(
                        cms, params, reqs[:1], chunked_prefill=True),
                    "chunked prefill"),
                "speculation": _refused(
                    "speculation", lambda: _rg_engine(
                        cms, params, reqs[:1], speculation="ngram:4"),
                    "speculative decoding needs")}
            rec["serve_profile"] = _profile(
                lambda: _rg_engine(cms, params, reqs[:SERVE_SLOTS]), 1)
            log(json.dumps({"rec_serving_checks": {
                k: rec[k] for k in ("serve_bf16_logits", "serve_profile")}}))
        del params, cm, ref, cml, refl, cms, refs
        torch.cuda.empty_cache()
    for prec in ("bf16", "fp32"):
        g, w = rec[f"generate_{prec}"], rec[f"window_{prec}"]
        log(f"{RG_ARCH} {prec}: logits relerr vs the reference backend: "
            f"generate prefill {g['prefill_relerr']:.3e}, decode max "
            f"{g['decode_relerr_max']:.3e}; window prefill "
            f"{w['prefill_relerr']:.3e}, decode max "
            f"{w['decode_relerr_max']:.3e}")
    log(f"{RG_ARCH}: workload R logits relerr vs the reference backend: bf16 "
        f"{rec['serve_bf16_logits']['relerr_max']:.3e}, fp32 "
        f"{rec['serve_fp32']['logits']['relerr_max']:.3e}")
    log(f"{RG_ARCH}: fp32 greedy tokens identical to the reference backend "
        "(generate, window, workload R)")
    return rec


# ---------------------------------------------------------------------------
# the rest of the dense family: qwen1.5-4b, phi4-mini-3.8b, stablelm-1.6b
# ---------------------------------------------------------------------------

# at full width and depth (configs/qwen15_4b.py, phi4_mini_38b.py,
# stablelm_16b.py): qwen 40 layers, 20 heads over 20 KV heads of 128, QKV
# bias, rope base 1e6; phi4 32 layers, 24 over 8 of 128, rope on 96 of 128,
# tied embeddings; stablelm 24 layers, 32 over 32 of 64, LayerNorm, rope on
# 16 of 64, QKV bias.  Each generates (a 512-token prompt a row, 32 greedy
# tokens, at llama's ShapeConfig("serve", "decode", 1024, 8)) and serves
# workload A (llama's serving configuration: 8 slots of 1024 tokens in
# blocks of 16, a pool of 513 blocks), bf16 then fp32.
DENSE_ARCHS = ("qwen1.5-4b", "phi4-mini-3.8b", "stablelm-1.6b")
# phase 13 runs each at 4 layers (of 40 / 32 / 24): the script's time
# limit, once phases 16-19 joined; widths, heads and every check as at
# full depth
DENSE_DEPTH = {"qwen1.5-4b": 4, "phi4-mini-3.8b": 4, "stablelm-1.6b": 4}


def _heads(arch):
    """(layers, heads, KV heads, head width) of a full config."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    a = cfg.attention
    return cfg.n_layers, a.n_heads, a.n_kv_heads, a.head_dim


def _plan_matmuls(plan):
    """The distinct matmul_fused shapes of one prefill (or decode step) of
    the plan, as [(name, K, N, GLU pair, launches)]: the projections as the
    fusion pass left them (a QKV bias stays its own op: the pass fuses a
    bias only into the matmul just before it, as the JAX package's does)."""
    from repro_torch.core.lowering import live_ops
    uses = {}
    for unit in plan.units:
        for j in range(unit.period):
            blk = plan.graph.blocks[unit.indices[j]]
            for op in live_ops(blk, "prefill"):
                if op.op in ("matmul", "glu_matmul"):
                    if op.attrs.get("bias"):
                        raise AssertionError(f"{op.op} with a fused bias")
                    K, N = op.params[0].shape
                    key = (K, N, op.op == "glu_matmul")
                    uses[key] = uses.get(key, 0) + unit.reps
    return [(f"{K}to{N}" + ("_glu" if glu else ""), K, N, glu, n)
            for (K, N, glu), n in uses.items()]


def phase_dense_kernels():
    """Phase 12: the kernels of qwen1.5-4b, phi4-mini-3.8b and
    stablelm-1.6b at their heads and projections, bf16 and fp32:
    flash_attention at the 8 x 512 prefill, decode_attention over the
    1024-slot cache half full, paged_decode_attention at a workload-A tick
    (Sq 1), each beside the SIMT kernel, SDPA (gather + SDPA) and the
    plain version; matmul_fused at every projection of a layer at the
    prefill's 4096 rows and a decode step's 8.  Each case carries its
    model's name."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "paged_decode_attention": [], "matmul_fused": []}
    for arch in DENSE_ARCHS:
        _, H, KV, D = _heads(arch)
        plan = tflow.compile(arch, ShapeConfig("serve", "decode", LM_C, B),
                             FlowConfig(mode="folded")).plan
        for dt in (torch.bfloat16, torch.float32):
            heads = dict(H=H, KV=KV, D=D)
            for kname, c in (
                    ("flash_attention", _flash_case(dt, gen, **heads)),
                    ("decode_attention", _decode_case(dt, gen, **heads)),
                    ("paged_decode_attention",
                     _paged_case(1, dt, gen, **heads))):
                cases[kname].append({**c, "arch": arch})
                log(json.dumps({"kernel": kname, "arch": arch, **c}))
            for M in (B * LM_S, B):
                for name, K, N, glu, uses in _plan_matmuls(plan):
                    c = _lm_matmul_case(name, M, K, N, glu, dt, gen, uses)
                    cases["matmul_fused"].append({**c, "arch": arch})
                    log(json.dumps({"kernel": "matmul_fused", "arch": arch,
                                    **c}))
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


def _widened(params):
    """The parameter tree in fp32: the fp32 runs take the bf16 draw
    widened, not a second draw."""
    return {k: {n: t.float() for n, t in d.items()}
            for k, d in params.items()}


def _unembed(cm, params):
    """CUDA-event ms of the head's ``op_unembed`` at a decode step's 8 rows
    (the whole table widened to fp32, then an fp32 GEMM), on the model's
    own table."""
    from types import SimpleNamespace
    from repro_torch.core.ops_impl import Ctx, op_unembed
    cfg = cm.cfg
    dt = cm.plan.prec.compute_dtype
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["head"]["lm_head"]
    x = torch.randn(B, 1, cfg.d_model, device=table.device).to(dt)
    ctx = Ctx(mode="decode", plan=cm.plan)
    op = SimpleNamespace(attrs={"true_vocab": cfg.vocab_size})

    def fn():
        return op_unembed(ctx, op, {"lm_head": table}, x)
    return cuda_ms(fn, 10, 2)


def _serve_split(eng, rep, shapes, prec):
    """matmul_fused's launches of a traced serving run by schedule: each
    prefill batch's projections (its rows: batch bucket x prompt bucket)
    on the precision's large-M schedule above ``SMALL_M_MAX`` rows of the
    form, small-M at or below; every decode tick's on small-M."""
    from repro_torch.kernels.matmul_fused import SMALL_M_MAX
    big, small = LM_SCHEDULES[prec]
    want = {big: 0, small: sum(n for *_, n in shapes)
            * rep.metrics["decode_ticks"]}
    batches = [e["args"] for e in eng.tracer.events()
               if e["name"] == "prefill"]
    if len(batches) != rep.metrics["prefill_batches"]:
        raise AssertionError(f"{len(batches)} prefill spans, "
                             f"{rep.metrics['prefill_batches']} batches")
    for a in batches:
        rows = a["batch"] * a["bucket"]
        for _, _, _, glu, n in shapes:
            want[small if rows <= SMALL_M_MAX[glu] else big] += n
    return want


def _dense_model(arch, smi):
    """One model of the rest of the dense family, at its ``DENSE_DEPTH``,
    through ``generate`` and ``Engine.run`` on workload A, bf16 then fp32,
    each held to the ``reference`` backend; its weights, states and pools
    freed after."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    full, H, KV, D = _heads(arch)
    layers = DENSE_DEPTH[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = ShapeConfig("serve", "decode", LM_C, B)
    rec = {"arch": arch, "nvidia_smi": smi, "layers": layers,
           "layers_full": full, "heads": [H, KV, D]}
    params = prompt = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(cfg, shape, fl)
        ref = tflow.compile(cfg, shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in (
                "attention", "decode_attention", "paged_decode_attention",
                "matmul", "glu_matmul")):
            raise AssertionError(f"{arch}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        shapes = _plan_matmuls(cm.plan)
        if want_p != {"flash_attention": layers, "decode_attention": 0,
                      "matmul_fused": 6 * layers} or \
                want_d != {"flash_attention": 0, "decode_attention": layers,
                           "matmul_fused": 6 * layers} or \
                sum(n for *_, n in shapes) != 6 * layers:
            raise AssertionError(f"{arch}: plan launches {want_p} / "
                                 f"{want_d}, shapes {shapes}")
        if prec == "bf16":
            rec["units"] = cm.describe().splitlines()[2].strip()
            rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
            t0 = time.perf_counter()
            params = cm.init_params(SEED)
            torch.cuda.synchronize()
            rec["init_params_s"] = time.perf_counter() - t0
            rec["params"] = sum(t.numel() for d in params.values()
                                for t in d.values())
            prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cm.cfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()
        else:
            params = _widened(params)
            torch.cuda.empty_cache()

        # a. generate: 32 greedy tokens a row after the 512-token prompt
        g = _lm_generate(cm, ref, params, prompt, LM_STEPS, want_p, want_d,
                         prec)
        rec[f"generate_{prec}"] = g
        log(json.dumps({"dense_generate": arch, "precision": prec, **g}))
        if prec == "bf16":
            cm_p = tflow.compile(cfg, ShapeConfig("serve", "prefill", LM_S,
                                                  B), fl)
            mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": prompt[:, :1]}
            dprof = _profile(lambda: cm.decode(params, dtok, dstate, 100),
                             10)
            un = _unembed(cm, params)
            step_busy = dprof["device_busy_ms"] / dprof["iters"]
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, {"tokens": prompt}), 2),
                "decode_profile": dprof, "unembed_ms": un,
                "unembed_share_of_decode_ms":
                    un / (md["measured_step_s"] * 1e3),
                "unembed_share_of_device_ms": un / step_busy
                if step_busy else None}
            log(json.dumps({"dense_measure": arch, **rec["measure"]}))
            del cm_p, dstate

        # b. serving: workload A through Engine.run
        reqs = _serve_workloads(cm.cfg.vocab_size)["A"]
        reset_counts()
        eng, rep = _engine_run(cm, params, reqs, trace=True)
        launches = _counted(read_counts(), _serve_want(rep, want_p, want_d),
                            f"{arch} {prec} workload A")
        r = _serve_record(eng, rep)
        r.update(
            launches=launches,
            matmul_schedules=_scheduled(_serve_split(eng, rep, shapes, prec),
                                        f"{arch} {prec} workload A"),
            flash_schedules=_flash_scheduled(
                launches["flash_attention"], prec,
                f"{arch} {prec} workload A"),
            paged_schedules=_decode_scheduled(
                launches["paged_decode_attention"], prec,
                f"{arch} {prec} workload A", "paged_decode_attention"))
        elem = 2 if prec == "bf16" else 4
        pool = 2 * layers * r["pool_blocks"] * SERVE_BS * KV * D * elem
        if r["pool_blocks"] != 1 + SERVE_SLOTS * SERVE_SEQ // SERVE_BS \
                or r["pool_bytes"] != pool:
            raise AssertionError(f"{arch} {prec}: pool {r['pool_blocks']} "
                                 f"blocks, {r['pool_bytes']} bytes, want "
                                 f"{pool}")
        toks = _tokens(rep)
        del eng, rep
        if prec == "fp32":
            # the kernel engine's pool is freed before the reference's
            torch.cuda.empty_cache()
            _, rep_r = _engine_run(ref, params, reqs)
            if toks != _tokens(rep_r):
                raise AssertionError(f"{arch} fp32 workload A: greedy tokens "
                                     "differ from the reference backend's")
            r["identical_to_reference"] = True
            del rep_r
        rec[f"serve_{prec}"] = r
        log(json.dumps({"serving": "A", "arch": arch, "precision": prec,
                        **r}))
        del cm, ref
        torch.cuda.empty_cache()
    del params, prompt
    torch.cuda.empty_cache()
    g16, g32 = rec["generate_bf16"], rec["generate_fp32"]
    log(f"{arch}: bf16 logits relerr vs the reference backend: prefill "
        f"{g16['prefill_relerr']:.3e}, decode max "
        f"{g16['decode_relerr_max']:.3e}, greedy agreement "
        f"{g16['greedy_agreement_share']:.3f}; fp32 greedy tokens identical "
        f"to it (generate, workload A); fp32 logits relerr max "
        f"{max(g32['prefill_relerr'], g32['decode_relerr_max']):.3e}")
    return rec


def phase_dense_path(smi):
    """Phase 13: qwen1.5-4b, phi4-mini-3.8b and stablelm-1.6b at full width
    and ``DENSE_DEPTH`` (random weights from seed 0) through
    ``flow.compile`` → ``generate`` and ``Engine.run``, one model after the
    other."""
    out = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _dense_model(arch, smi)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {out[arch]['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# the MoE family (deepseek-moe-16b, mixtral-8x7b) and the multimodal patch
# stub (llava-next-mistral-7b) at full width
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x7b")
VLM_ARCH = "llava-next-mistral-7b"
NEW_ARCHS = MOE_ARCHS + (VLM_ARCH,)
# phase 17 runs deepseek-moe-16b whole, mixtral-8x7b at 4 of its 32
# layers (93 GB in bf16 whole) and llava at 4 of its 32, in bf16 and in
# fp32: the script's time limit (the phase took 213 s of it with mixtral
# at 8 and llava whole); widths, heads, experts and every check as at full
# depth
DEPTH_CUT = {"mixtral-8x7b": 4, "llava-next-mistral-7b": 4}
# llava's cell: a 1024-token prompt whose first 576 positions are the patch
# embeddings, in a 2048-slot cache
VLM_S, VLM_C = 1024, 2048
# the precisions workload A runs in (llava has no Engine.run, as in JAX)
NEW_SERVE = {"deepseek-moe-16b": ("bf16", "fp32"), "mixtral-8x7b": ("bf16",)}
# the teacher-forced decode steps held to the reference backend after the
# prefill (of the 31 a generate takes): the script's time limit
NEW_CHECK_STEPS = 4


def _new_cell(arch):
    """(prompt tokens, cache slots) of a new model's serving cell."""
    return (VLM_S, VLM_C) if arch == VLM_ARCH else (LM_S, LM_C)


def _new_cfg(arch):
    """The full config, cut in depth where ``DEPTH_CUT`` says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n = DEPTH_CUT.get(arch)
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def _new_decode_qpos(arch):
    """The decode case's query position: half the 1024-slot cache, or
    llava's prompt end plus half its steps in the 2048-slot cache."""
    return VLM_S + LM_STEPS // 2 - 1 if arch == VLM_ARCH else LM_C // 2 - 1


def phase_moe_kernels():
    """Phase 16: the kernels at the heads and projections of
    deepseek-moe-16b (16 over 16 heads of 128), mixtral-8x7b (32 over 8 of
    128, a group of 4, window 4096) and llava-next-mistral-7b (32 over 8 of
    128), bf16 and fp32: flash_attention at the prefill (8 x 512; llava's
    8 x 1024), decode_attention over the 1024-slot cache half full (llava's
    2048-slot cache at position 1039), paged_decode_attention at a
    workload-A tick (the two MoE models), each beside its SIMT kernel, SDPA
    (gather + SDPA) and the plain version; matmul_fused at each of the
    model's projection shapes (its plan's) at the prefill's rows and a
    decode step's 8.  Each case carries its model's name."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = {"flash_attention": [], "decode_attention": [],
             "paged_decode_attention": [], "matmul_fused": []}
    for arch in NEW_ARCHS:
        cfg = _new_cfg(arch)
        a = cfg.attention
        S, C = _new_cell(arch)
        plan = tflow.compile(cfg, ShapeConfig("serve", "decode", C, B),
                             FlowConfig(mode="folded")).plan
        heads = dict(H=a.n_heads, KV=a.n_kv_heads, D=a.head_dim,
                     window=a.window)
        for dt in (torch.bfloat16, torch.float32):
            made = [("flash_attention", _flash_case(dt, gen, S=S, **heads)),
                    ("decode_attention", _decode_case(
                        dt, gen, C=C, qpos=_new_decode_qpos(arch), **heads))]
            if arch != VLM_ARCH:
                made.append(("paged_decode_attention",
                             _paged_case(1, dt, gen, **heads)))
            for kname, c in made:
                cases[kname].append({**c, "arch": arch})
                log(json.dumps({"kernel": kname, "arch": arch, **c}))
            for M in (B * S, B):
                for name, K, N, glu, uses in _plan_matmuls(plan):
                    c = _lm_matmul_case(name, M, K, N, glu, dt, gen, uses)
                    cases["matmul_fused"].append({**c, "arch": arch})
                    log(json.dumps({"kernel": "matmul_fused", "arch": arch,
                                    **c}))
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


class _Routes:
    """A routing hook (``ops_impl.ROUTING_HOOK``) keeping each MoE layer
    call's expert picks and its k + 1 largest router probabilities, in
    call order."""

    def __init__(self):
        self.calls = []

    def __call__(self, ctx, attrs, probs, idx, keep):
        k = idx.shape[-1]
        self.calls.append((idx.clone(), probs.topk(k + 1, dim=-1).values))


def _routed(fn):
    """``fn()`` with its MoE layers' routing recorded: (its result, the
    records)."""
    from repro_torch import flow as tflow
    from repro_torch.core import ops_impl
    r = _Routes()
    ops_impl.ROUTING_HOOK = r
    try:
        with tflow.disable_graphs():    # the hook runs in Python: eager
            out = fn()
    finally:
        ops_impl.ROUTING_HOOK = None
    return out, r.calls


def _flips(a, b):
    """The routing records of one call on the kernels (``a``) and on the
    reference backend (``b``): per row whether its last position (the one
    whose logits are compared) picked other experts in any layer, per row
    whether any position did, the picks that differ over every position,
    and the smallest reference margin among those (its k-th minus its
    (k+1)-th probability)."""
    rows = anyrow = None
    picks, margin = 0, None
    for (ia, _), (ib, vb) in zip(a, b):
        k = ia.shape[-1]
        miss = (ib[..., :, None] != ia[..., None, :]).all(-1).sum(-1)
        last, some = miss[:, -1] > 0, (miss > 0).any(-1)
        rows = last if rows is None else rows | last
        anyrow = some if anyrow is None else anyrow | some
        n = int(miss.sum())
        if n:
            picks += n
            gap = float((vb[..., k - 1] - vb[..., k])[miss > 0].min())
            margin = gap if margin is None else min(margin, gap)
    return rows, anyrow, picks, margin


def _forced(fn, calls):
    """``fn()`` with each MoE layer's top-k taken, call by call, from
    ``calls`` (the records of a run on the kernels), its gates read off
    this run's own router probabilities: the reference backend on the
    kernels' routing, so that a comparison sees the arithmetic alone."""
    from repro_torch import flow as tflow
    from repro_torch.core import ops_impl
    picks = iter(calls)
    top_k = ops_impl._top_k_stable

    def replay(probs, k):
        idx = next(picks)[0]
        return probs.gather(-1, idx), idx
    ops_impl._top_k_stable = replay
    try:
        with tflow.disable_graphs():    # a replay would bake one call's picks
            return fn()
    finally:
        ops_impl._top_k_stable = top_k


def _held_logits(what, y, yr, yf, tol, ra, rb, flips):
    """The logits ``y`` on the kernels against ``yr`` on the reference
    backend within ``tol``; for a MoE model under the routing-flip rule.
    Every call's flipped picks and their smallest reference margin are
    recorded in ``flips``, and the rows whose routing differed at any
    position of this call or an earlier one (``flips["dirty"]``: a flip
    anywhere in a row's past reaches its logits through attention).  Where
    the check fails and some picks flipped, it is held on the rows that
    routed alike throughout (where there are any), and, on every row,
    against ``yf``: the reference backend on the kernels' routing
    (:func:`_forced`), which must be within ``tol``."""
    if ra:
        _, anyrow, picks, margin = _flips(ra, rb)
        flips["dirty"] = anyrow if flips["dirty"] is None \
            else flips["dirty"] | anyrow
    else:
        picks, margin = 0, None
    flips["picks"] += picks
    flips["calls"] += 1
    flips["calls_with_flips"] += bool(picks)
    if margin is not None:
        flips["min_margin"] = margin if flips["min_margin"] is None \
            else min(flips["min_margin"], margin)
    try:
        return _lm_check_logits(what, y, yr, tol)
    except AssertionError:
        if flips["dirty"] is None or not flips["dirty"].any():
            raise                         # no flip: not the rule's case
    keep = (~flips["dirty"]).nonzero().flatten()
    held = _lm_check_logits(what, y[keep], yr[keep], tol) \
        if len(keep) else None
    err = _lm_check_logits(f"{what} (the kernels' routing)", y, yf, tol)
    flips["rule"].append({"what": what, "flipped_picks": picks,
                          "min_margin": margin, "rows_held": keep.tolist(),
                          "relerr_all": relerr(y, yr), "relerr_held": held,
                          "relerr_forced": err})
    return err


def _token_flips(ta, tb, ra, rb, steps):
    """For greedy tokens ``ta`` (kernels) and ``tb`` (reference backend)
    that differ: each differing row's first differing step, and whether its
    compared token routed otherwise in some layer at that step or before
    (the records ``ra``, ``rb``: one call a step)."""
    n = len(ra) // steps
    out = []
    for r in (ta != tb).any(1).nonzero().flatten().tolist():
        first = int((ta[r] != tb[r]).nonzero()[0])
        flipped = [c for c in range(first + 1)
                   if _flips(ra[c * n:(c + 1) * n],
                             rb[c * n:(c + 1) * n])[1][r]]
        out.append({"row": r, "first_step": first,
                    "flipped_at_steps": flipped})
    return out


class _Drops(_Routes):
    """A routing hook counting on the device the picks that capacity
    dropped (``keep`` 0) at real positions (>= 0, or every position of a
    batch without ``positions``) and at padding, and the real tokens that
    lost a pick; with ``record`` it keeps the routing too (``_Routes``)."""

    def __init__(self, record=False):
        super().__init__()
        self.record = record
        self.real, self.pad, self.tokens = (
            torch.zeros((), dtype=torch.int64, device="cuda")
            for _ in range(3))

    def __call__(self, ctx, attrs, probs, idx, keep):
        if self.record:
            super().__call__(ctx, attrs, probs, idx, keep)
        b, s, k = idx.shape
        pos = ctx.aux["__inputs__"].get("positions")
        real = torch.ones((b, s), dtype=torch.bool, device=idx.device) \
            if pos is None else pos >= 0
        drop = keep.view(b, s, k) == 0
        self.real += (drop & real[..., None]).sum()
        self.pad += (drop & ~real[..., None]).sum()
        self.tokens += (drop.any(-1) & real).sum()

    def read(self):
        return {"dropped_real_picks": int(self.real),
                "dropped_pad_picks": int(self.pad),
                "real_tokens_losing_a_pick": int(self.tokens)}


def _new_generate(cm, ref, params, batch, steps, want_p, want_d, prec):
    """``_lm_generate`` for a new model: one generate through the port's
    entry point with the counts set to 0 just before and read just after
    (launches and schedules as the plan says; a MoE model's routing
    recorded, call by call); then the prefill and each teacher-forced
    decode step (the first ``NEW_CHECK_STEPS``) held against the reference
    backend (logits within ``PATH_TOL[prec]``, :func:`_held_logits`), and
    in fp32 the greedy
    tokens identical to the reference backend's.  For a MoE model both
    checks run under the routing-flip rule: every call's flips are
    counted, and where the reference backend's own routing breaks a check
    it is held on the rows that routed alike and on every row against the
    reference backend on the kernels' routing (:func:`_forced`), which
    keeps its own state through the steps.  ``batch`` carries llava's
    patches to the prefill."""
    prompt = batch["tokens"]
    b, S = prompt.shape
    moe = cm.cfg.moe is not None
    reset_counts()
    t0 = time.perf_counter()
    (toks, _), rg = _routed(lambda: cm.generate(params, batch, steps=steps))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = _counted(read_counts(), {
        k: want_p.get(k, 0) + (steps - 1) * want_d.get(k, 0)
        for k in set(want_p) | set(want_d)}, f"{prec} generate")
    sched = _lm_scheduled(want_p["matmul_fused"],
                          (steps - 1) * want_d["matmul_fused"], prec,
                          f"{prec} generate")
    fsched = _flash_scheduled(launches["flash_attention"], prec,
                              f"{prec} generate")
    dsched = _decode_scheduled(launches["decode_attention"], prec,
                               f"{prec} generate")
    V = cm.cfg.vocab_size
    if tuple(toks.shape) != (b, steps) or not ((toks >= 0) & (toks < V)).all():
        raise AssertionError(f"generate: tokens {tuple(toks.shape)}")
    flips = {"picks": 0, "calls": 0, "calls_with_flips": 0,
             "min_margin": None, "rule": [], "dirty": None}
    rec = {"launches": launches, "matmul_schedules": sched,
           "flash_schedules": fsched, "decode_schedules": dsched,
           "generate_s": gen_s, "tokens_row0": toks[0].tolist()}
    if prec == "fp32":
        (tr, _), rr = _routed(lambda: ref.generate(params, batch,
                                                   steps=steps))
        if not torch.equal(toks, tr):
            diff = (toks != tr).float().mean().item()
            if not moe:
                raise AssertionError(f"fp32 greedy tokens differ from the "
                                     f"reference backend's ({diff:.3f})")
            tf, _ = _forced(lambda: ref.generate(params, batch, steps=steps),
                            rg)
            if not torch.equal(toks, tf):
                raise AssertionError("fp32 greedy tokens differ from the "
                                     "reference backend's on the kernels' "
                                     "routing too")
            rec["tokens_rule"] = {"differing_share": diff,
                                  "rows": _token_flips(toks, tr, rg, rr,
                                                       steps),
                                  "identical_on_kernels_routing": True}
        rec["greedy_identical_steps"] = steps
    reset_counts()
    (y, st, _), ra = _routed(lambda: cm.prefill(params, batch))
    _counted(read_counts(), want_p, "one prefill")
    _flash_scheduled(want_p["flash_attention"], prec, "one prefill")
    (yr, st_r, _), rb = _routed(lambda: ref.prefill(params, batch))
    yf, st_f, _ = _forced(lambda: ref.prefill(params, batch), ra) if moe \
        else (None, None, None)
    errs = [_held_logits("prefill", y, yr, yf, PATH_TOL[prec], ra, rb,
                         flips)]
    agree = [(yr[:, -1].argmax(-1) == toks[:, 0]).float().mean().item()]
    for t in range(min(steps - 1, NEW_CHECK_STEPS)):
        tok = {"tokens": toks[:, t:t + 1].long()}
        reset_counts()
        (y, st, _), ra = _routed(lambda: cm.decode(params, tok, st, S + t))
        _counted(read_counts(), want_d, f"decode step {t}")
        _decode_scheduled(want_d["decode_attention"], prec,
                          f"decode step {t}")
        (yr, st_r, _), rb = _routed(
            lambda: ref.decode(params, tok, st_r, S + t))
        if moe:
            yf, st_f, _ = _forced(
                lambda: ref.decode(params, tok, st_f, S + t), ra)
        errs.append(_held_logits(f"decode step {t}", y, yr, yf,
                                 PATH_TOL[prec], ra, rb, flips))
        agree.append((yr[:, -1].argmax(-1) == toks[:, t + 1])
                     .float().mean().item())
    dirty = flips.pop("dirty")
    flips["rows_flipped"] = 0 if dirty is None else int(dirty.sum())
    rec.update(prefill_relerr=errs[0], decode_relerr_max=max(errs[1:]),
               greedy_agreement_share=sum(agree) / len(agree),
               routing_flips=flips)
    return rec


def _widen(params):
    """The bf16 tree widened to fp32 leaf by leaf, the largest leaves first,
    each bf16 leaf dropped from ``params`` as its fp32 copy is made
    (deepseek's 65.5 GB of fp32 beside its 32.8 GB of bf16 would not fit
    the card); ``params`` is emptied.  Unlike ``_widened``, which keeps
    the bf16 tree, this one never holds both."""
    order = sorted(((k, n) for k, d in params.items() for n in d),
                   key=lambda kn: -params[kn[0]][kn[1]].numel())
    out = {k: {} for k in params}
    for k, n in order:
        out[k][n] = params[k].pop(n).float()
    params.clear()
    torch.cuda.empty_cache()
    return out


def _expert_ms(cm, params):
    """CUDA-event ms of one decode step's expert products: a MoE layer's
    three routed products over (E, B * cap, d) (``ops_impl._lib_dot``, cap
    1 at one token a row) and the shared experts' three, times the MoE
    layers; the step's share that runs outside any hand kernel."""
    from repro_torch.core import ops_impl
    cfg, m = cm.cfg, cm.cfg.moe
    dt = cm.plan.prec.compute_dtype
    leaves = next(d for d in params.values()
                  if any(n.endswith("we_gate") for n in d))

    def leaf(suffix):
        return next(t for n, t in leaves.items() if n.endswith(suffix))[0]
    wg, wu, wd = leaf("we_gate"), leaf("we_up"), leaf("we_down")
    E, d, _ = wg.shape
    cap = max(math.ceil(m.top_k / E * m.capacity_factor), 1)
    eb = torch.randn(E, B * cap, d, device="cuda").to(dt)
    x = torch.randn(B, 1, d, device="cuda").to(dt)
    shared = [leaf(s) for s in ("ws_gate", "ws_up", "ws_down")] \
        if m.num_shared else None

    def fn():
        h = (F.silu(ops_impl._lib_dot(eb, wg, dt))
             * ops_impl._lib_dot(eb, wu, dt)).to(dt)
        y = ops_impl._lib_dot(h, wd, dt)
        if shared:
            s = (F.silu(ops_impl._lib_dot(x, shared[0], dt))
                 * ops_impl._lib_dot(x, shared[1], dt)).to(dt)
            y = ops_impl._lib_dot(s, shared[2], dt)
        return y
    per_layer = cuda_ms(fn, 10, 2)
    return {"moe_layers": cfg.n_layers - m.first_dense_layers,
            "per_layer_ms": per_layer,
            "ms": per_layer * (cfg.n_layers - m.first_dense_layers),
            "bf16_out_dtype_bmm": bool(dt == torch.bfloat16
                                       and ops_impl._bmm_out_dtype_ok())}


def _new_serve(arch, cm, ref, params, prec, want_p, want_d, shapes):
    """Workload A through ``Engine.run`` with the launches by schedule and
    the pool's bytes, the real prompt tokens capacity dropped counted in the
    op (``_Drops``); in fp32 the run again on graphs without the hook
    (its launches and tokens the eager run's) and the greedy tokens
    identical to the reference backend's ``Engine.run`` on graphs."""
    from repro_torch import flow as tflow
    from repro_torch.core import ops_impl
    cfg = cm.cfg
    a = cfg.attention
    reqs = _serve_workloads(cfg.vocab_size)["A"]
    drops = _Drops(record=prec == "fp32")
    reset_counts()
    ops_impl.ROUTING_HOOK = drops
    try:
        with tflow.disable_graphs():    # the hook runs in Python: eager
            eng, rep = _engine_run(cm, params, reqs, trace=True)
    finally:
        ops_impl.ROUTING_HOOK = None
    launches = _counted(read_counts(), _serve_want(rep, want_p, want_d),
                        f"{arch} {prec} workload A")
    r = _serve_record(eng, rep)
    r.update(
        launches=launches, capacity_drops=drops.read(),
        matmul_schedules=_scheduled(_serve_split(eng, rep, shapes, prec),
                                    f"{arch} {prec} workload A"),
        flash_schedules=_flash_scheduled(
            launches["flash_attention"], prec, f"{arch} {prec} workload A"),
        paged_schedules=_decode_scheduled(
            launches["paged_decode_attention"], prec,
            f"{arch} {prec} workload A", "paged_decode_attention"),
        prefill_buckets=[[e["args"]["batch"], e["args"]["bucket"]]
                         for e in eng.tracer.events()
                         if e["name"] == "prefill"])
    elem = 2 if prec == "bf16" else 4
    pool = 2 * cfg.n_layers * r["pool_blocks"] * SERVE_BS * a.n_kv_heads \
        * a.head_dim * elem
    if r["pool_blocks"] != 1 + SERVE_SLOTS * SERVE_SEQ // SERVE_BS \
            or r["pool_bytes"] != pool:
        raise AssertionError(f"{arch} {prec}: pool {r['pool_blocks']} "
                             f"blocks, {r['pool_bytes']} bytes, want {pool}")
    toks = _tokens(rep)
    del eng, rep
    if prec == "fp32":
        # the kernel engine again on graphs, without the hook (a replay
        # runs no Python): the eager run's launches and tokens.  Then the
        # reference backend's engine on graphs; where its own routing
        # moves a token, it runs again (eagerly) on the kernels' routing
        # and must give every token
        torch.cuda.empty_cache()
        reset_counts()
        t = time.perf_counter()
        eng, rep_g = _engine_run(cm, params, reqs)
        graphed = {"wall_s": time.perf_counter() - t,
                   "graphs": dict(cm.stage_graphs.stats)}
        if _counted(read_counts(), _serve_want(rep_g, want_p, want_d),
                    f"{arch} fp32 workload A on graphs") != launches:
            raise AssertionError(f"{arch} fp32 workload A: launches on "
                                 "graphs differ from the eager run's")
        if _tokens(rep_g) != toks:
            raise AssertionError(f"{arch} fp32 workload A: greedy tokens "
                                 "on graphs differ from the eager run's")
        del eng, rep_g
        torch.cuda.empty_cache()
        t = time.perf_counter()
        eng, rep_r = _engine_run(ref, params, reqs)
        del eng                                     # its paged pool
        graphed["reference_wall_s"] = time.perf_counter() - t
        graphed["reference_graphs"] = dict(ref.stage_graphs.stats)
        graphed["kernel_graphs_after"] = dict(cm.stage_graphs.stats)
        r["on_graphs"] = graphed
        diff = [rid for rid, t in toks.items() if t != _tokens(rep_r)[rid]]
        del rep_r
        if diff:
            # eager beside 65.5 GB of weights: the graphs' pools go first
            tflow.clear_graphs()
            _, rep_f = _forced(lambda: _engine_run(ref, params, reqs),
                               drops.calls)
            if toks != _tokens(rep_f):
                raise AssertionError(f"{arch} fp32 workload A: greedy "
                                     f"tokens of {diff} differ from the "
                                     "reference backend's, on the kernels' "
                                     "routing too")
            r["tokens_rule"] = {"requests_differing": diff,
                                "identical_on_kernels_routing": True}
            del rep_f
        r["identical_to_reference"] = True
    log(json.dumps({"serving": "A", "arch": arch, "precision": prec, **r}))
    return r


def _new_model(arch, smi):
    """One model through ``generate`` (and, for the MoE models,
    ``Engine.run`` on workload A), bf16 then fp32, each held to the
    ``reference`` backend; its weights, states and pools freed after."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig
    S, C = _new_cell(arch)
    shape = ShapeConfig("serve", "decode", C, B)
    rec = {"arch": arch, "nvidia_smi": smi, "prompt": S, "cache": C}
    params = batch = None
    cfg = _new_cfg(arch)
    a = cfg.attention
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(cfg, shape, fl)
        ref = tflow.compile(cfg, shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in (
                "attention", "decode_attention", "paged_decode_attention",
                "matmul", "glu_matmul")):
            raise AssertionError(f"{arch}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        shapes = _plan_matmuls(cm.plan)
        L = cfg.n_layers
        dense = L if cfg.moe is None else cfg.moe.first_dense_layers
        mm = 4 * L + 2 * dense                      # q, k, v, o + GLU, down
        if want_p != {"flash_attention": L, "decode_attention": 0,
                      "matmul_fused": mm} or \
                want_d != {"flash_attention": 0, "decode_attention": L,
                           "matmul_fused": mm}:
            raise AssertionError(f"{arch}: plan launches {want_p} / {want_d}")
        rec[f"layers_{prec}"] = L
        rec["heads"] = [a.n_heads, a.n_kv_heads, a.head_dim, a.window]
        if prec == "bf16":
            rec["units"] = cm.describe().splitlines()[2].strip()
            rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
            t0 = time.perf_counter()
            params = cm.init_params(SEED)
            torch.cuda.synchronize()
            rec["init_params_s"] = time.perf_counter() - t0
            rng = np.random.RandomState(SEED)
            batch = {"tokens": torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (B, S)).astype(np.int64)).cuda()}
            if cfg.n_patch_tokens:
                batch["patches"] = torch.from_numpy(rng.randn(
                    B, cfg.n_patch_tokens, cfg.d_vision).astype(
                        np.float32)).cuda()
        else:
            t0 = time.perf_counter()
            params = _widen(params)
            torch.cuda.synchronize()
            rec["widen_s"] = time.perf_counter() - t0
        rec[f"params_{prec}"] = sum(t.numel() for d in params.values()
                                    for t in d.values())
        rec[f"weight_bytes_{prec}"] = sum(
            t.numel() * t.element_size() for d in params.values()
            for t in d.values())

        # a. generate: 32 greedy tokens a row after the prompt
        g = _new_generate(cm, ref, params, batch, LM_STEPS, want_p, want_d,
                          prec)
        rec[f"generate_{prec}"] = g
        log(json.dumps({"new_generate": arch, "precision": prec, **g}))
        if cfg.n_patch_tokens and prec == "bf16":
            # the patches reach the model: a second draw moves the logits
            other = {**batch, "patches": torch.from_numpy(
                np.random.RandomState(SEED + 1).randn(
                    B, cfg.n_patch_tokens, cfg.d_vision).astype(
                        np.float32)).cuda()}
            y1, _, _ = cm.prefill(params, batch)
            y2, _, _ = cm.prefill(params, other)
            moved = relerr(y2, y1)
            if not moved > 1e-3:
                raise AssertionError(f"{arch} {prec}: other patches moved "
                                     f"the logits by {moved}")
            rec[f"patch_moved_relerr_{prec}"] = moved
            del y1, y2, other
        if prec == "bf16":
            cm_p = tflow.compile(cfg, ShapeConfig("serve", "prefill", S, B),
                                 fl)
            mp = cm_p.measure("prefill", iters=3, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": batch["tokens"][:, :1]}
            dprof = _profile(lambda: cm.decode(params, dtok, dstate, 100), 5)
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "decode_peak_bytes": md["peak_bytes"],
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, batch), 2),
                "decode_profile": dprof}
            if cfg.moe is not None:
                ex = _expert_ms(cm, params)
                busy = dprof["device_busy_ms"] / dprof["iters"]
                ex["share_of_decode_device_ms"] = ex["ms"] / busy \
                    if busy else None
                ex["share_of_decode_ms"] = ex["ms"] / rec["measure"][
                    "decode_ms"]
                rec["measure"]["experts"] = ex
            log(json.dumps({"new_measure": arch, **rec["measure"]}))
            del cm_p, dstate

        # b. serving: workload A through Engine.run (llava: refused)
        if prec in NEW_SERVE.get(arch, ()):
            rec[f"serve_{prec}"] = _new_serve(arch, cm, ref, params, prec,
                                              want_p, want_d, shapes)
        elif cfg.n_patch_tokens and prec == "bf16":
            eng = Engine(cm, params, EngineConfig(
                max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                block_size=SERVE_BS))
            rec["engine_refusal"] = _refused(
                f"{arch} Engine.run",
                lambda: eng.run(_serve_workloads(cfg.vocab_size)["A"][:2]),
                "patches")
            if eng.last_cache is not None:
                raise AssertionError(f"{arch}: Engine.run made a pool")
            del eng
        del cm, ref
        torch.cuda.empty_cache()
    del params, batch
    torch.cuda.empty_cache()
    g16, g32 = rec["generate_bf16"], rec["generate_fp32"]
    log(f"{arch}: bf16 logits relerr vs the reference backend: prefill "
        f"{g16['prefill_relerr']:.3e}, decode max "
        f"{g16['decode_relerr_max']:.3e}, routing flips "
        f"{g16['routing_flips']['picks']} (rule applied "
        f"{len(g16['routing_flips']['rule'])}x); fp32 greedy tokens held "
        f"{g32['greedy_identical_steps']} steps, routing flips "
        f"{g32['routing_flips']['picks']}")
    return rec


def phase_moe_path(smi):
    """Phase 17: deepseek-moe-16b at full width and depth, mixtral-8x7b
    and llava-next-mistral-7b at full width and ``DEPTH_CUT`` (random
    weights from seed 0, drawn once in bf16;
    the fp32 runs take them widened) through ``flow.compile`` →
    ``generate`` and, for the MoE models, ``Engine.run``, one model after
    the other."""
    out = {}
    for arch in NEW_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _new_model(arch, smi)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {out[arch]['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# the last two families: rwkv6-7b (the WKV recurrence, no kernel on its
# path) and whisper-small (the encoder-decoder)
# ---------------------------------------------------------------------------

RWKV_ARCH, WH_ARCH = "rwkv6-7b", "whisper-small"
# whisper's decoder context (n_text_ctx of arXiv:2212.04356's model
# dimensions) and its decoder prompt
WH_C, WH_S = 448, 128
# the fp32 decode steps held to a prefill of the same tokens (and the
# generated tokens to that prefill's argmax)
TF_STEPS = 4
TF_TOL = 2e-4                      # JAX's tests/test_models_smoke.py bound
# rwkv6-7b at random weights carries a last-bit difference far through its
# 32 layers: a 1e-7 nudge of the embedding moves its fp32 logits by
# 3.7e-3, a decode step (its products summed in another order than the
# prefill's) by 4.9e-3, and bf16 sits 0.16 from fp32 (0.027 at 4
# layers; PERF.md §6).  The bounds of the teacher-forced and the
# bf16-against-fp32 checks hold at the first RWKV_HELD layers of the same
# weights and batch, and the full depth's figures are recorded beside
# them
RWKV_HELD = 4
# phase 19 runs rwkv6-7b at 8 of its 32 layers (the script's time limit:
# the phase took 129.4 s with it whole); widths, heads and every check as
# at full depth
RWKV_DEPTH = 8


def _wh_matmuls(plan, S, E):
    """whisper's matmul_fused calls as [(name, K, N, bias, act, rows,
    launches)]: a prefill's (the encoder's and the decoder's cross-attention
    K/V projections at B x E rows, the decoder's others at B x S) and a
    decode step's (B rows: the decoder's self-attention, cross-attention
    query and output, and MLP), each with its launches per prefill or per
    step, the epilogue as the fusion pass left it."""
    from repro_torch.core.lowering import live_ops
    uses = {}
    for mode in ("prefill", "decode"):
        for unit in plan.units:
            for j in range(unit.period):
                blk = plan.graph.blocks[unit.indices[j]]
                enc = blk.kind.startswith("enc")
                if mode == "decode" and enc:
                    continue
                for op in live_ops(blk, mode):
                    if op.op == "glu_matmul":
                        raise AssertionError("whisper has no GLU pair")
                    if op.op != "matmul":
                        continue
                    K, N = op.params[0].shape
                    rows = B if mode == "decode" else \
                        B * (E if enc or op.ins[0] == "cross" else S)
                    key = (K, N, bool(op.attrs.get("bias")),
                           op.attrs.get("act"), rows)
                    uses[key] = uses.get(key, 0) + unit.reps
    return [(f"{K}to{N}", K, N, b, a, rows, n)
            for (K, N, b, a, rows), n in uses.items()]


def phase_family_kernels():
    """Phase 18: the kernels at whisper-small's geometries (12 heads over
    12 of 64, d_model 768, d_ff 3072), bf16 and fp32: flash_attention
    non-causal over the encoder's 8 x 1500 frames (1500 is no multiple of
    the 64- or 128-row tiles) and causal at the decoder's 8 x 128 prompt,
    decode_attention over the 448-slot cache at position 143, each beside
    its SIMT kernel, SDPA and the plain version; matmul_fused at every
    projection of the plan (768 -> 768; 768 -> 3072 + bias + tanh-GELU;
    3072 -> 768 + bias) at the encoder's 12,000 rows, the decoder prompt's
    1024 and a decode step's 8, beside ``torch.addmm`` (+ GELU).  rwkv6-7b
    has no case: no kernel runs on its path (JAX computes its projections
    and recurrence outside Pallas)."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cfg = get_config(WH_ARCH)
    a, E = cfg.attention, cfg.encoder_seq
    heads = dict(H=a.n_heads, KV=a.n_kv_heads, D=a.head_dim)
    plan = tflow.compile(cfg, ShapeConfig("serve", "decode", WH_C, B),
                         FlowConfig(mode="folded")).plan
    cases = {"flash_attention": [], "decode_attention": [],
             "matmul_fused": []}
    for dt in (torch.bfloat16, torch.float32):
        made = [("flash_attention",
                 _flash_case(dt, gen, S=E, causal=False, **heads)),
                ("flash_attention", _flash_case(dt, gen, S=WH_S, **heads)),
                ("decode_attention", _decode_case(
                    dt, gen, C=WH_C, qpos=WH_S + LM_STEPS // 2 - 1,
                    **heads))]
        for kname, c in made:
            cases[kname].append({**c, "arch": WH_ARCH})
            log(json.dumps({"kernel": kname, "arch": WH_ARCH, **c}))
        for name, K, N, bias, act, rows, uses in _wh_matmuls(plan, WH_S, E):
            c = _lm_matmul_case(name, rows, K, N, False, dt, gen, uses,
                                bias=bias, act=act)
            cases["matmul_fused"].append({**c, "arch": WH_ARCH})
            log(json.dumps({"kernel": "matmul_fused", "arch": WH_ARCH, **c}))
    for kname in ("flash_attention", "decode_attention"):
        cases[kname] += [_simt_twin(c) for c in cases[kname]]
    return cases


def _flash_by_causal(fn):
    """``fn()`` with the op layer's flash_attention calls counted by their
    ``causal`` flag (the wrapper's own count does not split them) and, for
    a windowed call, its window: (its result, {"causal": n, "noncausal":
    n, "causal@<window>": n, ...}).  Eagerly: the count is taken in
    Python, which a graph's replay skips and its capture runs again."""
    from repro_torch import flow as tflow
    from repro_torch.core import ops_impl
    seen = {"causal": 0, "noncausal": 0}
    resolve = ops_impl.plan_kernel

    def counted_plan_kernel(plan, op, **facts):
        kern = resolve(plan, op, **facts)
        if op != "attention" or kern is None:
            return kern

        def flash(*args, causal=True, **kw):
            key = "causal" if causal else "noncausal"
            if kw.get("window"):
                key += f"@{kw['window']}"
            seen[key] = seen.get(key, 0) + 1
            return kern(*args, causal=causal, **kw)
        return flash
    ops_impl.plan_kernel = counted_plan_kernel
    try:
        with tflow.disable_graphs():
            out = fn()
    finally:
        ops_impl.plan_kernel = resolve
    return out, seen


def _teacher_forced(cm, params, batch, toks, steps=TF_STEPS, held=True):
    """The fp32 decode logits at each of the first ``steps`` steps after
    the prompt against a prefill of the prompt and the generated tokens up
    to that step (the same tokens, teacher-forced): relerr < ``TF_TOL``
    (with ``held=False`` recorded only), and each generated token the
    argmax of that prefill's logits (with the smallest top-2 gap of those
    logits recorded)."""
    prompt = batch["tokens"]
    S = prompt.shape[1]
    _, st, _ = cm.prefill(params, batch)
    errs, gap = [], None
    for t in range(steps):
        y, st, _ = cm.decode(params, {"tokens": toks[:, t:t + 1].long()}, st,
                             S + t)
        full = {**batch, "tokens": torch.cat([prompt, toks[:, :t + 1].long()],
                                             1)}
        yr, _, _ = cm.prefill(params, full)
        err = relerr(*_real_vocab(y, yr))
        top = yr[:, -1].float().topk(2, dim=-1).values
        g = float((top[:, 0] - top[:, 1]).min())
        gap = g if gap is None else min(gap, g)
        if held and err >= TF_TOL:
            raise AssertionError(f"decode step {t}: relerr {err} vs the "
                                 f"teacher-forced prefill (tol {TF_TOL})")
        if t + 1 < toks.shape[1] and not torch.equal(
                yr[:, -1].argmax(-1).to(torch.int32), toks[:, t + 1]):
            raise AssertionError(f"step {t}: generated tokens differ from "
                                 f"the teacher-forced prefill's argmax "
                                 f"(smallest top-2 gap {g})")
        errs.append(err)
    return {"teacher_forced_steps": steps,
            "teacher_forced_relerr_max": max(errs), "held": held,
            "tokens_are_prefill_argmax": True, "min_top2_gap": gap}


def _wkv_ms(cm):
    """CUDA-event ms of the WKV recurrence of one prefill (``_wkv_chunked``
    at the cell's (B, S, H, dh) and the plan's chunk) and of one decode
    step (``_wkv_step`` on the (B, H, dh, dh) state), each times the
    model's layers, on random fp32 inputs: the work outside any hand
    kernel."""
    from repro_torch.core import ops_impl
    r = cm.cfg.recurrence
    L, H, dh = cm.cfg.n_layers, r.n_heads, r.head_dim
    chunk = cm.plan.tiles.get("wkv_chunk", 32)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    rk, kk, vk = (rnd(B, LM_S, H, dh) for _ in range(3))
    w = -torch.exp(rnd(B, LM_S, H, dh, scale=0.5) - 1.5)
    u = rnd(H, dh, scale=0.5)
    pre = cuda_ms(lambda: ops_impl._wkv_chunked(rk, kk, vk, w, u, chunk),
                  3, 1)
    st = rnd(B, H, dh, dh)
    one = [t[:, 0] for t in (rk, kk, vk, torch.exp(w))]
    step = cuda_ms(lambda: ops_impl._wkv_step(st, *one, u), 20, 3)
    return {"chunk": chunk, "prefill_ms_per_layer": pre,
            "prefill_ms": pre * L, "step_ms_per_layer": step,
            "step_ms": step * L}


def _nudged(params, seed=SEED):
    """``params`` with the embedding table moved by one part in 1e7, each
    entry up or down at random: a perturbation the size of an fp32
    rounding, to read how far the model carries one."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    t = params["embed"]["table"]
    sign = torch.randint(0, 2, t.shape, generator=g, device=t.device) * 2 - 1
    return {**params, "embed": {"table": t * (1 + 1e-7 * sign)}}


def _first_layers(cm, params, n):
    """A compiled copy of ``cm`` cut to its first ``n`` layers, and the
    parameter tree's matching slice (the folded leaves' first ``n``
    repetitions)."""
    from repro_torch import flow as tflow
    cut = tflow.compile(dataclasses.replace(cm.cfg, n_layers=n), cm.shape,
                        cm.flow)
    return cut, {k: ({m: t[:n] for m, t in d.items()}
                     if k.startswith("fold_") else d)
                 for k, d in params.items()}


def _rwkv_card_vs_cpu():
    """rwkv6-7b at 2 layers and full width on the card and on the host CPU
    from the same weights (drawn in bf16, widened for fp32): a prefill of 2
    x 256 tokens and 2 decode steps, logits within ``PATH_TOL`` (fp32
    1e-4: sums in another order; bf16 5e-2: the card's bf16 products,
    ``bmm(..., out_dtype=float32)``, and the host's fp32 products of the
    same rounded operands land on either side of a bf16 rounding)."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=2)
    shape = ShapeConfig("serve", "decode", 512, 2)
    tok = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (2, 256)).astype(np.int64))
    out, ph = {"layers": 2, "tokens": [2, 256], "decode_steps": 2}, None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        host = tflow.compile(cfg, shape, fl, device="cpu")
        card = tflow.compile(cfg, shape, fl)
        ph = host.init_params(SEED) if ph is None else \
            {k: {n: t.float() for n, t in d.items()} for k, d in ph.items()}
        pc = {k: {n: t.cuda() for n, t in d.items()} for k, d in ph.items()}
        t0 = time.perf_counter()
        yh, sh, _ = host.prefill(ph, {"tokens": tok})
        host_s = time.perf_counter() - t0
        yc, sc, _ = card.prefill(pc, {"tokens": tok.cuda()})
        errs = [relerr(yc.cpu(), yh)]
        for t in range(2):
            nxt = yh[:, -1].argmax(-1)[:, None]
            yh, sh, _ = host.decode(ph, {"tokens": nxt}, sh, 256 + t)
            yc, sc, _ = card.decode(pc, {"tokens": nxt.cuda()}, sc, 256 + t)
            errs.append(relerr(yc.cpu(), yh))
        if max(errs) >= PATH_TOL[prec]:
            raise AssertionError(f"rwkv {prec} card vs CPU: logits relerr "
                                 f"{errs} (tol {PATH_TOL[prec]})")
        out[prec] = {"relerr": errs, "host_prefill_s": host_s}
        del pc, card
        torch.cuda.empty_cache()
    return out


def _rwkv_model(smi):
    """rwkv6-7b at full width and ``RWKV_DEPTH`` layers, bf16 then fp32
    (the bf16 draw widened): ``generate`` of 32 tokens after a 512-token prompt a row with
    no kernel launched (its projections are library products and its WKV
    recurrence plain PyTorch, as in JAX); the fp32 generate's tokens each
    the argmax of a teacher-forced prefill of the same tokens; at the first
    ``RWKV_HELD`` layers the bf16 prefill's logits within 5e-2 of the fp32
    prefill's and the fp32 decode within 2e-4 of the teacher-forced
    prefill, with the full depth's figures recorded beside them (and the
    fp32 prefill under a 1e-7 nudge of the embedding: how far the model
    carries a last-bit difference); in bf16 ``measure`` and profiles and the WKV's ms,
    ``Engine.run`` refused; then the card against the host CPU at 2
    layers."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_DEPTH)
    shape = ShapeConfig("serve", "decode", LM_C, B)
    rec = {"arch": RWKV_ARCH, "nvidia_smi": smi, "prompt": LM_S,
           "cache": LM_C, "layers": cfg.n_layers}
    batch = {"tokens": torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()}
    none = {"flash_attention": 0, "decode_attention": 0, "matmul_fused": 0}
    params = y16 = y16_cut = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(cfg, shape, fl)
        if _plan_launches(cm.plan, "prefill") != none or \
                _plan_launches(cm.plan, "decode") != none:
            raise AssertionError(f"{RWKV_ARCH}: a kernel op in the plan")
        t0 = time.perf_counter()
        if prec == "bf16":
            rec["units"] = cm.describe().splitlines()[2].strip()
            params = cm.init_params(SEED)
        else:
            params = _widen(params)
        torch.cuda.synchronize()
        rec[f"params_s_{prec}"] = time.perf_counter() - t0
        rec[f"params_{prec}"] = sum(t.numel() for d in params.values()
                                    for t in d.values())
        rec[f"weight_bytes_{prec}"] = sum(
            t.numel() * t.element_size() for d in params.values()
            for t in d.values())
        reset_counts()
        t0 = time.perf_counter()
        toks, _ = cm.generate(params, batch, steps=LM_STEPS)
        torch.cuda.synchronize()
        g = {"generate_s": time.perf_counter() - t0,
             "launches": _counted(read_counts(), {}, f"{prec} generate"),
             "tokens_row0": toks[0].tolist()}
        if tuple(toks.shape) != (B, LM_STEPS) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"generate: tokens {tuple(toks.shape)}")
        y, _, _ = cm.prefill(params, batch)
        if tuple(y.shape) != (B, 1, cfg.padded_vocab) or \
                not torch.isfinite(y.float()).all():
            raise AssertionError(f"{prec} prefill: logits {tuple(y.shape)}")
        if prec == "bf16":
            y16 = y.float()
            cut, pc = _first_layers(cm, params, RWKV_HELD)
            y16_cut = cut.prefill(pc, batch)[0].float()
            del cut, pc
            cm_p = tflow.compile(cfg, ShapeConfig("serve", "prefill", LM_S,
                                                  B), fl)
            mp = cm_p.measure("prefill", iters=3, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            dstate = cm.init_state(B)
            dtok = {"tokens": batch["tokens"][:, :1]}
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "decode_peak_bytes": md["peak_bytes"],
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, batch), 2),
                "decode_profile": _profile(
                    lambda: cm.decode(params, dtok, dstate, 100), 5),
                "wkv": _wkv_ms(cm)}
            log(json.dumps({"family_measure": RWKV_ARCH, **rec["measure"]}))
            eng = Engine(cm, params, EngineConfig(
                max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                block_size=SERVE_BS))
            rec["engine_refusal"] = _refused(
                f"{RWKV_ARCH} Engine.run",
                lambda: eng.run(_serve_workloads(cfg.vocab_size)["A"][:2]),
                "has no self-attention KV state")
            if eng.last_cache is not None:
                raise AssertionError(f"{RWKV_ARCH}: Engine.run made a pool")
            del cm_p, dstate, eng
        else:
            # at full depth recorded; held at the first RWKV_HELD layers
            g["bf16_prefill_relerr_vs_fp32"] = relerr(y16, y.float())
            g["nudged_prefill_relerr"] = relerr(
                cm.prefill(_nudged(params), batch)[0], y)
            g.update(_teacher_forced(cm, params, batch, toks, held=False))
            cut, pc = _first_layers(cm, params, RWKV_HELD)
            ct, _ = cut.generate(pc, batch, steps=TF_STEPS + 1)
            g[f"layers_{RWKV_HELD}"] = {
                "bf16_prefill_relerr_vs_fp32": _lm_check_logits(
                    f"{RWKV_HELD}-layer bf16 prefill vs fp32",
                    y16_cut, cut.prefill(pc, batch)[0], PATH_TOL["bf16"]),
                **_teacher_forced(cut, pc, batch, ct)}
            del cut, pc
        rec[f"generate_{prec}"] = g
        log(json.dumps({"family_generate": RWKV_ARCH, "precision": prec,
                        **g}))
        del cm, y
        torch.cuda.empty_cache()
    del params, y16, y16_cut
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = _rwkv_card_vs_cpu()
    log(json.dumps({"family_card_vs_cpu": RWKV_ARCH, **rec["card_vs_cpu"]}))
    return rec


def _whisper_model(smi):
    """whisper-small at full width and depth, ``ShapeConfig("serve",
    "decode", 448, 8)``, bf16 then fp32 (the bf16 draw widened): 8 x 128
    prompt tokens then ``randn(8, 1500, 768)`` frames from
    ``RandomState(0)``; ``generate`` of 32 tokens with the launches the plan
    says (24 flash a prefill, 12 of them non-causal, 192 projections; 12
    decode_attention and 96 projections a step; cross-attention on the
    reference op), the prefill and teacher-forced steps against the
    ``reference`` backend, fp32 tokens identical to it and the fp32 decode
    against a teacher-forced prefill; in bf16 ``measure`` and profiles;
    ``Engine.run`` refused (a request has no frames)."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig
    cfg = get_config(WH_ARCH)
    L, E = cfg.n_layers, cfg.encoder_seq
    shape = ShapeConfig("serve", "decode", WH_C, B)
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, cfg.vocab_size, (B, WH_S)).astype(np.int64)
    frames = rng.randn(B, E, cfg.d_model).astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "frames": torch.from_numpy(frames).cuda()}
    rec = {"arch": WH_ARCH, "nvidia_smi": smi, "prompt": WH_S,
           "frames": E, "cache": WH_C, "layers": [cfg.n_encoder_layers, L]}
    params = params16 = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(cfg, shape, fl)
        ref = tflow.compile(cfg, shape, fl, backend="reference")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in ("attention", "decode_attention",
                                         "matmul")):
            raise AssertionError(f"{WH_ARCH}: plan.kernels {ks}")
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        n_enc = cfg.n_encoder_layers
        if want_p != {"flash_attention": n_enc + L, "decode_attention": 0,
                      "matmul_fused": 6 * n_enc + 10 * L} or \
                want_d != {"flash_attention": 0, "decode_attention": L,
                           "matmul_fused": 8 * L}:
            raise AssertionError(f"{WH_ARCH}: plan launches {want_p} / "
                                 f"{want_d}")
        if prec == "bf16":
            rec["units"] = cm.describe().splitlines()[2].strip()
            rec["kernels_line"] = cm.describe().splitlines()[-1].strip()
            params = params16 = cm.init_params(SEED)
        else:
            params = _widened(params16)
        rec[f"params_{prec}"] = sum(t.numel() for d in params.values()
                                    for t in d.values())
        g = _new_generate(cm, ref, params, batch, LM_STEPS, want_p, want_d,
                          prec)
        del g["routing_flips"]
        reset_counts()
        _, g["flash_by_causal"] = _flash_by_causal(
            lambda: cm.prefill(params, batch))
        if g["flash_by_causal"] != {"causal": L, "noncausal": n_enc} or \
                read_counts()["flash_attention"] != n_enc + L:
            raise AssertionError(f"{WH_ARCH} prefill: flash calls "
                                 f"{g['flash_by_causal']}")
        if prec == "fp32":
            toks, _ = cm.generate(params, batch, steps=TF_STEPS + 1)
            g.update(_teacher_forced(cm, params, batch, toks))
        else:
            other = {**batch, "frames": torch.from_numpy(
                np.random.RandomState(SEED + 1).randn(
                    B, E, cfg.d_model).astype(np.float32)).cuda()}
            y1, s1, _ = cm.prefill(params, batch)
            y2, s2, _ = cm.prefill(params, other)
            xk = [st["fold_dec0"]["xdec_xkv0"]["k"] for st in (s1, s2)]
            g["frames_moved"] = {"cross_k_relerr": relerr(xk[1], xk[0]),
                                 "logits_relerr": relerr(*_real_vocab(y2,
                                                                      y1))}
            if not g["frames_moved"]["cross_k_relerr"] > 1e-2:
                raise AssertionError(f"{WH_ARCH}: other frames moved the "
                                     f"cross K/V by {g['frames_moved']}")
            del s1, s2, xk
            cm_p = tflow.compile(cfg, ShapeConfig("serve", "prefill", WH_S,
                                                  B), fl)
            mp = cm_p.measure("prefill", iters=5, seed=SEED, params=params)
            md = cm.measure("decode", iters=20, seed=SEED, params=params)
            pst = cm.prefill(params, batch)[1]
            dtok = {"tokens": batch["tokens"][:, :1]}
            rec["measure"] = {
                "device": mp["device"],
                "prefill_ms": mp["measured_step_s"] * 1e3,
                "prefill_mean_ms": mp["mean_step_s"] * 1e3,
                "prefill_tokens_per_s": mp["tokens_per_s"],
                "prefill_peak_bytes": mp["peak_bytes"],
                "decode_ms": md["measured_step_s"] * 1e3,
                "decode_mean_ms": md["mean_step_s"] * 1e3,
                "decode_tokens_per_s": md["tokens_per_s"],
                "decode_peak_bytes": md["peak_bytes"],
                "prefill_profile": _profile(
                    lambda: cm_p.prefill(params, batch), 3),
                "decode_profile": _profile(
                    lambda: cm.decode(params, dtok, pst, WH_S), 5)}
            log(json.dumps({"family_measure": WH_ARCH, **rec["measure"]}))
            eng = Engine(cm, params, EngineConfig(
                max_batch=SERVE_SLOTS, max_seq_len=WH_C, block_size=SERVE_BS))
            rec["engine_refusal"] = _refused(
                f"{WH_ARCH} Engine.run",
                lambda: eng.run(_serve_workloads(cfg.vocab_size)["A"][:2]),
                "frames")
            if eng.last_cache is not None:
                raise AssertionError(f"{WH_ARCH}: Engine.run made a pool")
            del cm_p, pst, eng, y1, y2, other
        rec[f"generate_{prec}"] = g
        log(json.dumps({"family_generate": WH_ARCH, "precision": prec, **g}))
        del cm, ref
        torch.cuda.empty_cache()
    del params, params16
    torch.cuda.empty_cache()
    return rec


def phase_family_path(smi):
    """Phase 19: rwkv6-7b (at ``RWKV_DEPTH`` layers) and whisper-small at
    full width and depth through ``flow.compile`` → ``generate``
    (:func:`_rwkv_model`, :func:`_whisper_model`), one after the other."""
    out = {}
    for arch, run in ((RWKV_ARCH, _rwkv_model), (WH_ARCH, _whisper_model)):
        t0 = time.perf_counter()
        out[arch] = run(smi)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {out[arch]['seconds']:.1f}s")
    return out


# kernels with schedules
# ---------------------------------------------------------------------------
# training: full-width llama3.2-1b and ResNet-34 on the card, then their
# trained weights served through the kernels
# ---------------------------------------------------------------------------

TRAIN_S, TRAIN_STEPS, TRAIN_CNN_STEPS = 512, 20, 10
# llama3.2-1b trains at full width and 4 of its 16 layers: the script's
# time limit (the phase took 88-104 s of it at 16 layers)
TRAIN_DEPTH = 4


def _train_run(cm, opt, params, batch, steps, what, kernels):
    """``steps`` train steps of ``opt`` on one fixed batch from
    ``opt.init``, the launch counts zeroed just before and read just after:
    the forward products run on the hand kernels (bf16 on the tensor-core
    schedules), so every kernel in ``kernels`` must have launched, every
    other none, and none on simt; no dispatch rejection.  Returns (losses,
    host ms a step, the optimizer state, the launches and their schedules
    (and a MoE model's aux loss a step), the device's peak bytes over the
    run)."""
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    step = cm.train_step(opt)
    state = opt.init(params)
    DISPATCH_REJECTIONS.clear()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, aux = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))          # reads back: the step ends
        ms.append((time.perf_counter() - t0) * 1e3)
        if "moe_aux" in m:
            aux.append(float(m["moe_aux"]))
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in read_counts().items() if v}
    if set(got) != set(kernels):
        raise AssertionError(f"{what}: launches {got}, want each of "
                             f"{sorted(kernels)} and no other")
    sched = {k: {s: n for s, n in read_schedules(k).items() if n}
             for k in kernels}
    if any("simt" in v for v in sched.values()):
        raise AssertionError(f"{what}: a launch on simt: {sched}")
    if DISPATCH_REJECTIONS:
        raise AssertionError(f"{what}: dispatch rejections "
                             f"{DISPATCH_REJECTIONS}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    kern = {"launches": got, "schedules": sched}
    if aux:
        kern["moe_aux"] = aux
    return losses, ms, state, kern, peak


def _device_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v).cuda() for k, v in batch.items()}


def _tree_relerr(a, b):
    """Max over leaves of ``relerr`` (nested dicts of tensors)."""
    from repro_torch.optim.adamw import tree_leaves
    return max(relerr(x.cpu(), y.cpu()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def _serve_trained_lm(cfg, params, prompt, smi):
    """The trained llama weights (of ``cfg``) through the kernels: cast to bf16 into
    ``ShapeConfig("serve", "decode", 1024, 8)``, a 32-step generate with
    the launches by schedule the plan says, the prefill's and every
    teacher-forced step's logits against the reference backend (< 5e-2);
    then the fp32 tree in an fp32 serve plan, greedy tokens identical to
    the reference backend's."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.optim.adamw import tree_map
    serve = ShapeConfig("serve", "decode", LM_C, B)
    out = {}
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(cfg, serve, fl)
        ref = tflow.compile(cfg, serve, fl, backend="reference")
        p = tree_map(lambda t: t.to(torch.bfloat16), params) \
            if prec == "bf16" else params
        want_p = _plan_launches(cm.plan, "prefill")
        want_d = _plan_launches(cm.plan, "decode")
        reset_counts()
        toks, _ = cm.generate(p, {"tokens": prompt}, steps=LM_STEPS)
        rec = {"launches": _counted(read_counts(), {
            k: want_p[k] + (LM_STEPS - 1) * want_d[k] for k in want_p},
            f"trained {prec} generate")}
        rec["matmul_schedules"] = _lm_scheduled(
            want_p["matmul_fused"], (LM_STEPS - 1) * want_d["matmul_fused"],
            prec, f"trained {prec} generate")
        rec["flash_schedules"] = _flash_scheduled(
            want_p["flash_attention"], prec, f"trained {prec} generate")
        rec["decode_schedules"] = _decode_scheduled(
            (LM_STEPS - 1) * want_d["decode_attention"], prec,
            f"trained {prec} generate")
        V = cm.cfg.vocab_size
        # the synthetic stream's rule: the next token is (31 t + 7) mod V
        # three times in four; the share of generated tokens that follow it
        nxt = torch.cat([prompt[:, -1:].to(torch.int32), toks[:, :-1]], 1)
        rec["follows_rule_share"] = ((nxt * 31 + 7) % V == toks) \
            .float().mean().item()
        if prec == "bf16":
            y, st, _ = cm.prefill(p, {"tokens": prompt})
            yr, st_r, _ = ref.prefill(p, {"tokens": prompt})
            errs = [_lm_check_logits("trained prefill", y, yr,
                                     PATH_TOL["bf16"])]
            for t in range(LM_STEPS - 1):
                tok = {"tokens": toks[:, t:t + 1].long()}
                y, st, _ = cm.decode(p, tok, st, TRAIN_S + t)
                yr, st_r, _ = ref.decode(p, tok, st_r, TRAIN_S + t)
                errs.append(_lm_check_logits(f"trained decode step {t}", y,
                                             yr, PATH_TOL["bf16"]))
            rec.update({"prefill_relerr": errs[0],
                        "decode_relerr_max": max(errs[1:])})
            del st, st_r
        else:
            tr, _ = ref.generate(p, {"tokens": prompt}, steps=LM_STEPS)
            if not torch.equal(toks, tr):
                raise AssertionError("trained fp32 greedy tokens differ from "
                                     "the reference backend's")
            rec["greedy_identical_steps"] = LM_STEPS
        rec["tokens_row0"] = toks[0].tolist()
        out[prec] = rec
        del p
    return out


def _card_vs_cpu(smi):
    """One ``make_train_step`` (AdamW without the clip, its default
    ``eps``) on a 2-layer llama3.2-1b at full width (d_model, heads, d_ff
    and vocab; depth cut only to keep the CPU side short), fp32, on the
    card (the forward on the hand kernels' fp32 schedules) and on the host's
    CPU (the reference ops) from the same initial tree and a 2 x 256
    SyntheticLM batch.  The first call's rate is 0 (the schedule starts
    there), so its first moment is (1 - b1) g exactly as the step computed
    g: holding that moment holds the gradients.  Then one AdamW update of
    the card's own gradients from the card's state, on the card and on the
    CPU: at the default ``eps`` an update is about ``lr * sign(g)``, and a
    gradient at the two devices' fp32 noise would flip sign between them,
    so the update is held on the same gradients.  Limits: loss relerr <
    1e-5, every gradient and updated parameter < 1e-4."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, \
        tree_map
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    shape = ShapeConfig("train", "train", 256, 2)
    f32 = FlowConfig(mode="folded", precision="fp32")
    opt = AdamW(lr=1e-3, grad_clip=0.0, warmup_steps=1, total_steps=10)
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                 global_batch=2, seed=1)).get(0)
    runs = {}
    p0 = None
    for dev in ("cuda", "cpu"):
        cm = tflow.compile(cfg, shape, f32, device=dev)
        if p0 is None:
            p0 = cm.init_params(SEED)
        params = tree_map(lambda t: t.to(cm.device, copy=True), p0)
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(cm.device)
                 for k, v in raw.items()}
        step = cm.train_step(opt)
        state = opt.init(params)
        if dev == "cuda":
            reset_counts()
        t0 = time.perf_counter()
        params, state, m0 = step(params, state, batch)
        runs[dev] = {"loss": float(m0["loss"]), "s": time.perf_counter() - t0,
                     "grads": tree_map(lambda t: t / (1 - opt.b1), state.mu)}
        if dev == "cuda":
            runs[dev]["launches"] = {k: v for k, v in read_counts().items()
                                     if v}
            runs[dev]["schedules"] = read_schedules()
            runs[dev]["state"] = (params, state)
        del params, state
    g, c = runs["cuda"], runs["cpu"]
    if set(g["launches"]) != {"matmul_fused", "flash_attention"}:
        raise AssertionError(f"card against CPU: launches {g['launches']}")
    grads = g["grads"]
    params, state = g["state"]
    cpu = lambda t: t.cpu().clone()                         # noqa: E731
    pc, sc = tree_map(cpu, params), AdamWState(
        cpu(state.step), tree_map(cpu, state.mu), tree_map(cpu, state.nu))
    gc = tree_map(cpu, grads)
    params, _, _ = opt.update(grads, state, params)
    pc, _, _ = opt.update(gc, sc, pc)
    rec = {"n_layers": 2, "tokens": 512, "eps": opt.eps,
           "loss_card": g["loss"], "loss_cpu": c["loss"],
           "loss_relerr": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
           "grad_relerr_max": _tree_relerr(grads, c["grads"]),
           "param_relerr_max": _tree_relerr(params, pc),
           "launches": g["launches"],
           "matmul_schedules": {k: v for k, v in g["schedules"].items() if v},
           "card_s": g["s"], "cpu_s": c["s"]}
    rec["update_max_abs"] = max(
        (x - y.cpu()).abs().max().item() for x, y in
        zip(tree_leaves(pc), tree_leaves(p0)))
    if rec["loss_relerr"] >= 1e-5 or rec["grad_relerr_max"] >= 1e-4 or \
            rec["param_relerr_max"] >= 1e-4 or rec["update_max_abs"] == 0:
        raise AssertionError(f"card against CPU: {rec}")
    return rec


def _train_resnet(smi):
    """ResNet-34 at 224 px, batch 8: 10 AdamW steps on one fixed batch
    (BatchNorm on the batch's statistics), the checkpoint round trip on
    the card, one step after restore against the uninterrupted step, then
    the trained tree served through conv2d_fused and matmul_fused in bf16
    and fp32 against the reference backend."""
    import shutil
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
    from repro_torch.train import checkpoint as ckpt
    cm = tflow.compile("resnet34", ShapeConfig("train", "train", 64, B),
                       FlowConfig(mode="folded"))
    params = cm.init_params(SEED)
    c = cm.cfg                         # 224 px, 3 channels, 1000 classes
    batch = _device_batch(SyntheticImages(
        DataConfig(vocab_size=c.vocab_size, seq_len=0, global_batch=B),
        c.image_size, c.image_channels, c.vocab_size).get(0))
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=TRAIN_CNN_STEPS)
    losses, ms, state, kern, peak = _train_run(
        cm, opt, params, batch, TRAIN_CNN_STEPS, "resnet34 train",
        ("conv2d_fused", "matmul_fused"))
    if losses[-1] > losses[0] - 0.5:
        raise AssertionError(f"resnet34: losses {losses} fell less than 0.5")
    # the convs on the tensor-core schedules (the stem on small_ci), the
    # FC on small_m
    sched = kern["schedules"]
    if set(sched["conv2d_fused"]) != {"wgmma", "small_ci"} or \
            set(sched["matmul_fused"]) != {"small_m"}:
        raise AssertionError(f"resnet34 train: launches by schedule {sched}")
    rec = {"losses": losses, "host_ms_per_step": ms, "kernels": kern,
           "peak_bytes_train": peak}
    # the checkpoint round trip: bit-exact, then one step from each
    ckdir = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    tree = {"params": params, "opt": state}
    t0 = time.perf_counter()
    ckpt.save(ckdir, TRAIN_CNN_STEPS, tree)
    back = ckpt.restore(ckdir, TRAIN_CNN_STEPS, tree)
    rec["ckpt_s"] = time.perf_counter() - t0
    flat, flat_b = ckpt._flatten(tree), ckpt._flatten(back)
    rec["ckpt_bytes"] = sum(t.numel() * t.element_size()
                            for t in flat.values())
    if list(flat) != list(flat_b) or not all(
            torch.equal(flat[k], flat_b[k]) and
            flat[k].dtype == flat_b[k].dtype for k in flat):
        raise AssertionError("resnet34: the checkpoint did not restore "
                             "bit-exactly")
    shutil.rmtree(ckdir)
    step = cm.train_step(opt)
    pa, _, ma = step(params, state, batch)
    pb, _, mb = step(back["params"], back["opt"], batch)
    rec["resume_param_relerr_max"] = _tree_relerr(pa, pb)
    rec["resume_loss"] = [float(ma["loss"]), float(mb["loss"])]
    if rec["resume_param_relerr_max"] >= 1e-4:
        raise AssertionError(f"resnet34: the step after restore differs "
                             f"({rec['resume_param_relerr_max']})")
    del back, pb, state
    # the trained tree through the kernels, BN folded into the convs
    rec["serve_bf16"] = _forward(
        "resnet34", FlowConfig(mode="folded"), {"wgmma": 35, "small_ci": 1},
        1, {"small_m": 1}, smi, measure=False,
        params=tree_map(lambda t: t.to(torch.bfloat16), pa))
    rec["serve_fp32"] = _forward(
        "resnet34", FlowConfig(mode="folded", precision="fp32"),
        {"ffma": 35, "small_ci": 1}, 1, {"ffma_small_m": 1}, smi,
        measure=False, params=pa)
    m = cm.measure("train", iters=5, seed=SEED, params=pa)
    st = [opt.init(pa)]

    def one():
        _, st[0], _ = step(pa, st[0], batch)
    rec["profile"] = _profile(one, 3)
    rec.update({"ms_per_step": m["measured_step_s"] * 1e3,
                "mean_ms_per_step": m["mean_step_s"] * 1e3,
                "images_per_s": m["images_per_s"],
                "peak_bytes": m["peak_bytes"], "device": m["device"],
                "nvidia_smi": smi, "n_params": sum(
                    t.numel() for t in tree_leaves(pa))})
    log(json.dumps({"train_resnet34": {k: v for k, v in rec.items()
                                       if not k.startswith("serve")}}))
    return rec


def phase_train(smi):
    """Phase 14: training on the card (the forward products on the hand
    kernels, the backward through the reference ops), then the trained
    weights through the kernels."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW
    out = {}
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_DEPTH)
    cm = tflow.compile(cfg, ShapeConfig("train", "train", TRAIN_S, B),
                       FlowConfig(mode="folded"))
    ks = cm.plan.kernels
    if any(ks[o] != "cuda" for o in ("attention", "matmul", "glu_matmul")):
        raise AssertionError(f"{LM_ARCH} train plan.kernels {ks}")
    t0 = time.perf_counter()
    params = cm.init_params(SEED)                     # fp32 masters
    torch.cuda.synchronize()
    raw = SyntheticLM(DataConfig(vocab_size=cm.cfg.vocab_size,
                                 seq_len=TRAIN_S, global_batch=B)).get(0)
    batch = _device_batch(raw)
    rec = {"arch": LM_ARCH, "layers": TRAIN_DEPTH, "shape": [B, TRAIN_S],
           "init_params_s": time.perf_counter() - t0,
           "remat": cm.flow.remat, "nvidia_smi": smi,
           "kernels_line": cm.describe().splitlines()[-1].strip()}
    opt = AdamW(lr=3e-4, warmup_steps=3, total_steps=TRAIN_STEPS)
    losses, ms, state, kern, peak = _train_run(
        cm, opt, params, batch, TRAIN_STEPS, f"{LM_ARCH} train",
        ("matmul_fused", "flash_attention"))
    if losses[-1] > losses[0] - 1.0:
        raise AssertionError(f"{LM_ARCH}: losses {losses} fell less than "
                             "1.0 nat")
    # each step runs every layer's forward twice (the block remat's
    # recompute), every projection on wgmma and every flash call on it
    fwd = _plan_launches(cm.plan, "train")
    want = {"matmul_fused": {"wgmma": TRAIN_STEPS * fwd["matmul_fused"]},
            "flash_attention": {
                "wgmma": TRAIN_STEPS * fwd["flash_attention"]}}
    if kern["schedules"] != want:
        raise AssertionError(f"{LM_ARCH} train: launches by schedule "
                             f"{kern['schedules']}, want {want}")
    rec.update({"losses": losses, "host_ms_per_step": ms,
                "kernels": kern, "peak_bytes_train": peak})
    log(f"llama train: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{TRAIN_STEPS} steps, {min(ms):.1f} ms a step (host), peak "
        f"{peak / 1e9:.2f} GB")
    del state
    torch.cuda.empty_cache()
    rec["serve"] = _serve_trained_lm(cfg, params, batch["tokens"], smi)
    m = cm.measure("train", iters=5, seed=SEED, params=params)
    rec["measure"] = {"ms_per_step": m["measured_step_s"] * 1e3,
                      "mean_ms_per_step": m["mean_step_s"] * 1e3,
                      "tokens_per_s": m["tokens_per_s"],
                      "peak_bytes": m["peak_bytes"], "device": m["device"]}
    step = cm.train_step(opt)
    st = [opt.init(params)]

    def one():
        _, st[0], _ = step(params, st[0], batch)
    rec["measure"]["profile"] = _profile(one, 2)
    log(json.dumps({"train_llama_measure": rec["measure"]}))
    del st, params, batch
    torch.cuda.empty_cache()
    out["llama"] = rec
    out["card_vs_cpu"] = _card_vs_cpu(smi)
    log(json.dumps({"train_card_vs_cpu": out["card_vs_cpu"]}))
    torch.cuda.empty_cache()
    out["resnet34"] = _train_resnet(smi)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 15: the static verifier and the tuning stack
# ---------------------------------------------------------------------------

# a fresh tune database under build/ (deleted before the phase), the serving
# profile of llama3.2-1b's autotune, the timed runs of each measured
# candidate, bench and replay (after a warm-up; a candidate's time is the
# least of its runs, a bench's or a replay's the median) and the envelope
# of the speculation replay (at 1024 tokens each of its 16 requests would
# generate 752 tokens: 3 x 4 replays of over 10 s)
TUNE_DB = os.path.join(ROOT, "build", "tune_smoke.jsonl")
TUNE_PROFILE = dict(name="chip", batch_buckets=(4, SERVE_SLOTS),
                    max_seq_len=SERVE_SEQ, block_sizes=(16, 32))
TUNE_ITERS = 3
TUNE_SPEC_SEQ = 128
# llama3.2-1b's autotune runs at full width and 4 of its 16 layers: its
# replays are host-bound engine runs whose ticks grow with the layers, and
# the script's time limit (at 16 layers the phase took 180 s of it)
TUNE_DEPTH = 4
# the ops a card plan must resolve to the hand kernels, by family
CARD_OPS = {"cnn": ("conv2d", "matmul"),
            "lm": ("attention", "decode_attention", "paged_decode_attention",
                   "copy_block", "matmul", "glu_matmul")}
# the one diagnostic a clean card plan carries: whisper's decoder
# cross-attends, which the flash kernel's contract rejects statically
CARD_WARNINGS = {"whisper-small": ("K204",)}


def _verify_card_plans():
    """``verify_plan`` on the card's plan of every ported config at its
    default shape (``flow.compile(verify=True)``: no weight is made): its
    codes, and each hand kernel's largest working set, the shared bytes a
    block of it asks for at the plan's calls: every call's mirror
    (``kernels/workingset.py``) held to the kernel library's own query."""
    from repro_torch import flow as tflow
    from repro_torch.configs import ARCHS, CNNS, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels._build import LIBRARY
    from repro_torch.kernels.registry import REGISTRY
    from repro_torch.serving import EngineConfig
    lib = LIBRARY.get()
    serve_ecfg = EngineConfig(max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                              block_size=SERVE_BS, chunk_size=16,
                              chunked_prefill=True)
    out = {}
    for name in ARCHS + CNNS:
        fam = "cnn" if get_config(name).family == "cnn" else "lm"
        shape = ShapeConfig("serve", "prefill", 64, B) if fam == "cnn" \
            else ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
        cm = tflow.compile(name, shape, verify=True)
        res = cm.plan.verification
        if not res.ok or tuple(res.codes()) != CARD_WARNINGS.get(name, ()):
            raise AssertionError(f"{name}: {res.describe()}")
        ks = cm.plan.kernels
        if any(ks[o] != "cuda" for o in CARD_OPS[fam]):
            raise AssertionError(f"{name}: card plan.kernels {ks}")
        ws, n_held = {}, 0
        for op in sorted(o for o, b in ks.items() if b == "cuda"):
            contract = REGISTRY.get(op, "cuda").contract
            if contract is None or not contract.workingset:
                continue
            calls = contract.workingset(cm.plan, None)
            # the mirror against the bytes the launches ask for: the
            # library's own queries at the same calls (and the paged
            # kernel at the serving envelope's widest tick)
            for ecfg in [None] + ([serve_ecfg] if fam == "lm" else []):
                mirror = contract.workingset(cm.plan, ecfg)
                real = contract.workingset(cm.plan, ecfg, lib=lib)
                if mirror != real:
                    raise AssertionError(f"{name} {op}: working sets "
                                         f"{mirror} != the library's {real}")
                n_held += len(real)
            if calls:
                call, sched, nb = max(calls, key=lambda c: c[2])
                ws[op] = {"call": call, "schedule": sched, "bytes": nb}
        out[name] = {"summary": res.summary_line(),
                     "codes": list(res.codes()), "workingset": ws,
                     "calls_held_to_library": n_held}
        log(json.dumps({"verify": name, **out[name]}))
    return out


def _warm_survivors(cfg, shape, flow0):
    """Build and run, once and untimed, each survivor a measured search of
    ``shape`` will time (the estimator's top-k on the card), so that no
    candidate is timed on a colder card or host than another: one timed
    call after a candidate's own warm-up left the first measured survivor
    the slowest.  Banks nothing and ticks no count the phase reads."""
    from repro_torch.core import dse
    flow = dataclasses.replace(flow0, tuning=dataclasses.replace(
        flow0.tuning, tune_db=None))
    er = dse.explore(cfg, shape, flow, use_cache=False)
    warm = dse.measure_validator(cfg, shape, iters=1)
    for c in er.candidates[:max(flow.tuning.top_k, 1)]:
        warm(c.flow)
    torch.cuda.synchronize()


def _survivors(er):
    """Each measured survivor of a search: its knobs, measured ms, the
    estimator's h100 prediction and their ratio, its peak bytes."""
    est = {c.knob_str(): c.step_s for c in er.candidates}
    rows = []
    for v in er.validated:
        if "measured_step_s" not in v:
            continue
        e = est[v["knobs"]]
        rows.append({"knobs": v["knobs"], "ms": v["measured_step_s"] * 1e3,
                     "est_h100_ms": e * 1e3,
                     "measured_over_est": v["measured_step_s"] / e,
                     "peak_bytes": v["per_device_bytes"],
                     "bytes_source": v["bytes_source"]})
    return rows


def _tune_resnet(smi):
    """ResNet-34 (224 px, batch 8) through ``flow.compile(autotune=True,
    validate="measure", verify=True)`` with a fresh tune database: the
    measured survivors beside the estimator's predictions, the winner (or,
    when the reference backend wins, the fastest measured survivor on the
    hand kernels) through conv2d_fused against the reference backend at its
    own flow, and a second search served by the database."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig, TuningConfig
    from repro_torch.core import dse
    serve = ShapeConfig("serve", "prefill", 64, B)
    flow0 = FlowConfig(mode="folded", tuning=TuningConfig(tune_db=TUNE_DB))
    t0 = time.perf_counter()
    _warm_survivors(get_config("resnet34"), serve, flow0)
    warm_s = time.perf_counter() - t0
    dse.clear_explore_cache()
    reset_counts()
    t0 = time.perf_counter()
    cm = tflow.compile("resnet34", serve, flow0, autotune=True,
                       validate="measure", verify=True)
    search_s = time.perf_counter() - t0
    during = {"launches": read_counts(),
              "conv_schedules": read_schedules("conv2d_fused")}
    er = cm.explore_result
    if er.tunedb_status != "cold" or er.n_measured < 1 or \
            not cm.plan.verification.ok:
        raise AssertionError(f"resnet34 search: {er.describe()}")
    if during["conv_schedules"]["simt"]:
        raise AssertionError(f"resnet34 search: conv schedules "
                             f"{during['conv_schedules']}")
    rows = _survivors(er)
    for r in rows:
        log(json.dumps({"tune_resnet34_survivor": r}))
    flows = {c.knob_str(): c.flow for c in er.candidates}
    auto = sorted((r for r in rows
                   if flows[r["knobs"]].kernel_backend == "auto"),
                  key=lambda r: r["ms"])
    if not auto:
        raise AssertionError("resnet34: no measured survivor ran the hand "
                             "kernels")
    kflow = cm.flow if cm.flow.kernel_backend == "auto" \
        else flows[auto[0]["knobs"]]
    bf = kflow.precision == "bf16"
    fwd = _forward("resnet34", kflow,
                   {"wgmma" if bf else "ffma": 35, "small_ci": 1}, 1,
                   {"small_m" if bf else "ffma_small_m": 1}, smi,
                   measure=False)
    dse.clear_explore_cache()
    cm2 = tflow.compile("resnet34", serve, flow0, autotune=True,
                        validate="measure", verify=True)
    er2 = cm2.explore_result
    if er2.tunedb_status != "hit" or er2.n_measured != 0 or \
            cm2.flow != cm.flow:
        raise AssertionError(f"resnet34 second search: {er2.describe()}")
    # validate="compile": the first fitting survivor in the estimator's
    # order, its footprint a measured step's peak of allocated memory
    erc = dse.explore(get_config("resnet34"), serve, FlowConfig(
        mode="folded"), validator=dse.compile_validator(
            get_config("resnet34"), serve), use_cache=False)
    vc = erc.validated
    if len(vc) != 1 or vc[0]["bytes_source"] != "max_memory_allocated" \
            or erc.best is not erc.candidates[0]:
        raise AssertionError(f"resnet34 compile search: {erc.describe()}")
    rec = {"warm_s": warm_s, "search_s": search_s,
           "describe": er.describe(), "winner": er.best.knob_str(),
           "winner_backend": cm.flow.kernel_backend,
           "checked_flow": {k: v for k, v in
                            dataclasses.asdict(kflow).items()
                            if k != "tuning"},
           "survivors": rows, "during_search": during, "forward": fwd,
           "second": {"tunedb_status": er2.tunedb_status,
                      "n_measured": er2.n_measured},
           "compile_search": {"winner": erc.best.knob_str(),
                              "peak_bytes": vc[0]["per_device_bytes"]},
           "nvidia_smi": smi}
    log(json.dumps({"tune_resnet34": {k: v for k, v in rec.items()
                                      if k != "describe"}}))
    return rec


def _pinned_serve(at, cm, params, prec, works, smi):
    """Workload A through an engine pinned to ``at``'s configuration on
    ``cm`` (a flow on the hand kernels): the launches by schedule its
    prefill batches and ticks give, then the same engine on the reference
    backend: bf16 logits within the limit, fp32 tokens identical."""
    from repro_torch import flow as tflow
    from repro_torch.serving import Engine
    if any(cm.plan.kernels[o] != "cuda" for o in CARD_OPS["lm"]):
        raise AssertionError(f"pinned {prec}: plan.kernels {cm.plan.kernels}")
    ecfg = at.engine_config()
    reset_counts()
    eng = Engine(cm, params, ecfg)
    rep = eng.run(works["A"])
    torch.cuda.synchronize()
    rec = {"precision": prec, **_serve_record(eng, rep)}
    want = _serve_want(rep, _plan_launches(cm.plan, "prefill"),
                       _plan_launches(cm.plan, "decode"),
                       rep.metrics["cow_forks"])
    rec["launches"] = _counted(read_counts(), want, f"pinned {prec}")
    dflt = _default_flow(cm.flow)
    rec["matmul_schedules"] = _aligned_only(
        rec["launches"]["matmul_fused"], prec, f"pinned {prec}", dflt)
    rec["flash_schedules"] = _flash_scheduled(
        rec["launches"]["flash_attention"], prec, f"pinned {prec}", dflt)
    rec["tiles"] = _at_plan_tiles(cm.plan, f"pinned {prec}")
    rec["paged_schedules"] = _decode_scheduled(
        rec["launches"]["paged_decode_attention"], prec, f"pinned {prec}",
        "paged_decode_attention")
    ref = tflow.compile(cm.cfg, cm.shape, cm.flow, backend="reference")
    if prec == "bf16":
        cap = Engine(cm, params, at.engine_config(capture_logits=True))
        cap_r = Engine(ref, params, at.engine_config(capture_logits=True))
        rec["logits"] = _serve_logits(cap.run(works["A"]),
                                      cap_r.run(works["A"]), prec,
                                      "pinned engine")
    else:
        rep_r = Engine(ref, params, ecfg).run(works["A"])
        if _tokens(rep) != _tokens(rep_r):
            raise AssertionError("pinned fp32 engine: greedy tokens differ "
                                 "from the reference backend's")
        rec["tokens_identical_to_reference"] = True
    # the same model on the engine's defaults (phase 8's configuration),
    # after the counted run: what the pinned knobs win or lose on A
    rec["defaults_tokens_per_s"] = _engine_run(
        cm, params, works["A"])[1].metrics["tokens_per_s"]
    log(json.dumps({"tune_llama_serve": rec}))
    return rec


def _tune_llama(smi):
    """llama3.2-1b at full width and ``TUNE_DEPTH`` layers through
    ``autotune_decode`` (buckets 4 and 8, 1024 tokens, blocks of 16 or 32,
    measured) with the same database:
    all six benches on the card, the block and chunk benches counted on
    ``paged_decode_attention``'s ``mma`` schedule, then the pinned engine on
    workload A in bf16 and, with the winner's flow in fp32, against the
    reference backend."""
    from repro_torch import flow as tflow
    from repro_torch.core import dse
    from repro_torch.serving import autotune as sat
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig
    prof = sat.ServingProfile(**TUNE_PROFILE)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TUNE_DEPTH)
    t0 = time.perf_counter()
    for b in prof.batch_buckets:
        _warm_survivors(cfg, prof.shape_for(b), FlowConfig(mode="folded"))
    torch.cuda.empty_cache()
    warm_s = time.perf_counter() - t0
    dse.clear_explore_cache()
    reset_counts()
    t0 = time.perf_counter()
    at = sat.autotune_decode(cfg, profile=prof, validate="measure",
                             iters=TUNE_ITERS, db=TUNE_DB, tune_spec=False)
    # the speculation replay on the same pinned flow and weights with an
    # envelope of TUNE_SPEC_SEQ tokens (the replay's length is the
    # profile's)
    spec_at = dataclasses.replace(
        at, profile=dataclasses.replace(prof, max_seq_len=TUNE_SPEC_SEQ),
        _params=at._params)
    at.speculation, at.spec_times_s = sat.tune_speculation(
        spec_at, iters=TUNE_ITERS, db=TUNE_DB)
    search_s = time.perf_counter() - t0
    during = {"launches": read_counts(),
              "paged_schedules": read_schedules("paged_decode_attention")}
    log(at.describe())
    if during["paged_schedules"]["simt"] or \
            not during["paged_schedules"]["mma"]:
        raise AssertionError(f"autotune: paged schedules "
                             f"{during['paged_schedules']}")
    ran = {"block": at.block_times_us, "chunk": at.chunk_times_us,
           "fori": at.fori_times_s, "prefix": at.prefix_times_s,
           "spec": at.spec_times_s}
    # the tile bench: every attention candidate of the winner's flow timed
    # (none when the reference backend won: tile-invariant), the fastest
    # pinned
    from repro_torch.kernels.registry import REGISTRY
    att = REGISTRY.get("attention", "cuda").contract
    wflow = at.per_bucket[at.best_bucket].best.flow
    cands = att.tile_candidates(cfg, None, wflow)
    want_t = {f"attention:{c}" for c in cands}
    if not all(ran.values()) or set(at.tile_times_s) != want_t or \
            [k for k, _ in at.tile_overrides] != ["attention"] * bool(cands):
        raise AssertionError(f"autotune benches {ran}, tiles "
                             f"{at.tile_overrides} {at.tile_times_s}")
    from repro_torch import tunedb
    fields = sorted(r.key["field"] for r in
                    tunedb.open_db(TUNE_DB).records("serving"))
    want = ["block_size", "chunk_size", "fori_seg", "kernel_tiles",
            "prefix_cache", "speculation"]
    if at.chunk_replay_s:             # the microbench's chunk, replayed
        want.append("chunk_replay")
    if fields != sorted(want):
        raise AssertionError(f"autotune banked {fields}")
    # the block and chunk benches alone, no store, counted: one warm-up and
    # TUNE_ITERS timed calls a candidate, all on mma
    bench = {}
    for name, fn, n in (
            ("block", lambda: sat.tune_block_size(
                at.cfg, prof, iters=TUNE_ITERS, dtype=torch.bfloat16),
             len(prof.block_sizes)),
            ("chunk", lambda: sat.tune_chunk_size(
                at.cfg, prof, block_size=at.block_size, iters=TUNE_ITERS,
                dtype=torch.bfloat16), len(prof.chunk_sizes))):
        reset_counts()
        fn()
        bench[name] = _decode_scheduled(n * (TUNE_ITERS + 1), "bf16",
                                        f"{name} bench",
                                        "paged_decode_attention")
    survivors = {b: _survivors(er) for b, er in at.per_bucket.items()}
    for b, rows in survivors.items():
        for r in rows:
            log(json.dumps({"tune_llama_survivor": {"bucket": b, **r}}))
    # the pinned engine in the winner's precision on its own weights, and
    # the winner's flow in the other precision on weights drawn for it; on
    # the hand kernels (the winner's flow with the auto backend) when the
    # reference backend won: its engine is the reference itself
    works = _serve_workloads(at.cfg.vocab_size)
    serve = {}
    kflow = dataclasses.replace(at.flow_for(), kernel_backend="auto")
    for prec in ("bf16", "fp32"):
        if kflow == at.flow_for() and prec == kflow.precision:
            cm, params = at.compile(), at.init_params(SEED)
        else:
            cm = tflow.compile(at.cfg, prof.shape_for(SERVE_SLOTS),
                               dataclasses.replace(kflow, precision=prec))
            params = cm.init_params(SEED)
        serve[prec] = _pinned_serve(at, cm, params, prec, works, smi)
        del cm, params
        at._params.clear()
        torch.cuda.empty_cache()
    rec = {"layers": TUNE_DEPTH, "warm_s": warm_s, "search_s": search_s,
           "describe": at.describe(),
           "winner_backend": at.flow_for().kernel_backend,
           "pin": {"bucket": at.best_bucket,
                   "knobs": at.per_bucket[at.best_bucket].best.knob_str(),
                   "block_size": at.block_size, "chunk_size": at.chunk_size,
                   "fori_seg": at.fori_seg, "prefix_cache": at.prefix_cache,
                   "speculation": at.speculation},
           "times": {"block_us": at.block_times_us,
                     "chunk_us_per_token": at.chunk_times_us,
                     "chunk_replay_s": at.chunk_replay_s,
                     "fori_replay_s": at.fori_times_s,
                     "prefix_replay_s": at.prefix_times_s,
                     "spec_replay_s": at.spec_times_s},
           "tunedb": at.tunedb_statuses, "n_measured": at.n_measured,
           "survivors": survivors, "during_autotune": during,
           "benches_counted": bench, "serve": serve, "nvidia_smi": smi}
    log(json.dumps({"tune_llama": {k: v for k, v in rec.items()
                                   if k not in ("describe", "serve")}}))
    return rec


def phase_tune(smi):
    """Phase 15: the static verifier over every card plan, then ResNet-34's
    and llama3.2-1b's autotune through the hand kernels, and the tune
    database they banked shown by ``launch.tune``."""
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    if os.path.exists(TUNE_DB):
        os.remove(TUNE_DB)
    DISPATCH_REJECTIONS.clear()
    out = {"verify": _verify_card_plans(), "resnet34": _tune_resnet(smi)}
    torch.cuda.empty_cache()
    out["llama"] = _tune_llama(smi)
    if DISPATCH_REJECTIONS:
        raise AssertionError(f"phase 15: dispatch rejections "
                             f"{dict(DISPATCH_REJECTIONS)}")
    show = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "show", "--db",
         TUNE_DB], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    key = f"dev=cuda:{torch.cuda.get_device_name(0)}"
    lines = show.stdout.splitlines()
    if show.returncode != 0 or len(lines) < 2 or \
            not all(key in x for x in lines[1:]):
        raise AssertionError(f"launch.tune show: {show.stdout}"
                             f"{show.stderr}")
    out["tunedb_show"] = lines
    log(show.stdout.rstrip())
    return out


SPLIT = ("matmul_fused", "flash_attention", "conv2d_fused", "decode_attention",
         "paged_decode_attention", "lru_scan")


def _by_schedule(cases):
    """``cases`` with the kernels of ``SPLIT`` split into one list per
    schedule, ``matmul_fused[wgmma]`` and so on: each schedule is its own
    kernel."""
    out = {k: v for k, v in cases.items() if k not in SPLIT}
    for kname in SPLIT:
        for r in cases.get(kname, []):
            out.setdefault(f"{kname}[{r['schedule']}]", []).append(r)
    return out


def _sched_launches(counts, schedules, flash=None, conv=None, decode=None,
                    paged=None):
    """A path's launch counts with matmul_fused's split by schedule
    (``schedules``), flash_attention's (``flash``), conv2d_fused's
    (``conv``), decode_attention's (``decode``) and
    paged_decode_attention's (``paged``)."""
    out = dict(counts)
    for kname, by in (("matmul_fused", schedules), ("flash_attention", flash),
                      ("conv2d_fused", conv), ("decode_attention", decode),
                      ("paged_decode_attention", paged)):
        if by is not None:
            del out[kname]
            out.update({f"{kname}[{s}]": n for s, n in by.items()})
    return out


def rec_kernel_entries(cases, rg):
    """Each kernel at recurrentgemma-2b's shapes, summed over one generate
    (a prefill of 8 x 512 tokens, then 31 decode steps: flash and
    matmul_fused's 4096-row cases at the prefill, decode_attention over the
    1024-slot cache and the 8-row matmuls at each step);
    paged_decode_attention one call at workload R's shape.  ``launches``
    counts the recurrent path's runs of that dtype (generate, window run,
    workload R).  lru_scan has its own entries (:func:`lru_kernel_entries`)."""
    uses = {"flash_attention": RG_ATTN,
            "decode_attention": RG_ATTN * (RG_STEPS - 1),
            "paged_decode_attention": 1}
    cases = _by_schedule(cases)
    launches = {}
    for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
        runs = [rg[f"{run}_{prec}"] for run in ("generate", "window",
                                                 "serve")]
        counts = [_sched_launches(r["launches"], r["matmul_schedules"],
                                  r["flash_schedules"],
                                  decode=r.get("decode_schedules"),
                                  paged=r.get("paged_schedules"))
                  for r in runs]
        launches[dt] = {k: sum(c.get(k, 0) for c in counts) for k in cases}

    def use(k, r):
        if k.startswith("matmul_fused"):
            return r["uses_per_forward"] * (1 if r["rows"] == B * RG_S
                                            else RG_STEPS - 1)
        return uses[k.split("[")[0]] if r.get("rows", B) == B else 0

    def per(kname, used):
        if kname.startswith("matmul_fused"):
            return (f"one {RG_ARCH} generate: {len(used)} projection shapes "
                    f"x their uses, prefill of {B}x{RG_S} tokens then "
                    f"{RG_STEPS - 1} decode steps")
        (r, u), = used
        return (f"one call at {r['shape']}" if u == 1 else
                f"{u} calls at {r['shape']} (one {RG_ARCH} generate)")
    return summed_entries(cases, launches, f"@{RG_ARCH}", per, use)


def lru_kernel_entries(cases):
    """lru_scan, one entry a schedule, shape and dtype: one call.
    ``launches`` is the count at that shape over the recurrent path's runs
    in both precisions (generate, window run, workload R: every path launch
    is fp32); the sequential kernel (``lru_scan[seq]``) and the bf16 case
    have none."""
    out = []
    for r in _by_schedule(cases).get("lru_scan[chunked]", []):
        for kname in ("lru_scan[chunked]", "lru_scan[seq]"):
            rows = [r if kname.endswith("[chunked]") else _seq_twin(r)]
            out += summed_entries(
                {kname: rows},
                {r["dtype"]: {kname: r["path_launches"]
                              if kname.endswith("[chunked]") else 0}},
                f"@{RG_ARCH}:{r['shape']}",
                lambda k, used: f"one call at {used[0][0]['shape']}",
                lambda k, c: 1)
    return out


def mobilenet_kernel_entries(cases, path):
    """conv2d_fused at MobileNetV1's first conv (small_ci, bf16 and fp32)
    and its 32-channel pointwise conv (mid_ci, bf16), one call each, and
    the SIMT kernel at the pointwise conv (the schedule it ran on before
    mid_ci; no path launches it); the launches are the MobileNetV1
    forward's (bf16) by schedule."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "mobilenetv1":
            launches["bfloat16"].update(
                {f"conv2d_fused[{k}]": v
                 for k, v in r["conv_schedules"].items()})
    rows = [r for r in cases["conv2d_fused"] if r.get("arch") == "mobilenetv1"]
    rows += [_simt_twin(r) for r in rows if r["schedule"] == "mid_ci"]
    return summed_entries(
        _by_schedule({"conv2d_fused": rows}), launches, "@mobilenetv1",
        lambda k, used: f"one call at {used[0][0]['shape']} (batch 8)",
        lambda k, r: 1)


def lenet_kernel_entries(cases, path):
    """conv2d_fused at LeNet-5's two convs (small_ci) and matmul_fused at
    its two FC layers on simt (120 -> 84, 84 -> 10), bf16, summed over one
    LeNet-5 forward at batch 8; the launches are that forward's by
    schedule."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "lenet5":
            launches["bfloat16"].update(_sched_launches(
                r["launches"], r["matmul_schedules"],
                conv=r["conv_schedules"]))
    return summed_entries(
        _by_schedule({k: [r for r in v if r.get("arch") == "lenet5"]
                      for k, v in cases.items()}), launches, "@lenet5",
        lambda k, used: "one LeNet-5 forward at batch 8 ("
                        + ", ".join(r["shape"] for r, _ in used) + ")",
        lambda k, r: 1)


def serving_kernel_entries(cases, serve):
    """Each serving kernel: one call at the serving shape (paged: a decode
    tick, Sq = 1, split by schedule), the launches of the serving main path
    (workloads A-D)."""
    return summed_entries(
        _by_schedule(cases),
        {"bfloat16": _sched_launches(serve["launches"], None,
                                     paged=serve["paged_schedules"]),
         "float32": _sched_launches(serve["launches_fp32"], None,
                                    paged=serve["paged_schedules_fp32"])},
        "@serving", lambda k, used: f"one call at {used[0][0]['shape']}",
        lambda k, r: int(r.get("sq", 1) == 1))


def kernel_entries(cases, path, tag=""):
    """Each CNN kernel, summed over its launches in one ResNet-34 forward
    (each shape times its uses)."""
    launches = {"bfloat16": {}, "float32": {}}
    for r in path:
        if r["arch"] == "resnet34":
            d = launches["bfloat16" if r["flow"] == "bf16" else "float32"]
            for k, n in _sched_launches(
                    r["launches"], r["matmul_schedules"],
                    conv=r["conv_schedules"]).items():
                d[k] = d.get(k, 0) + n
    return summed_entries(
        _by_schedule({k: [r for r in v if r.get("arch") is None]
                      for k, v in cases.items()}), launches, tag,
        lambda k, used: "one ResNet-34 forward at batch 8, 224 px",
        lambda k, r: r["uses"])


def lm_kernel_entries(cases, lm, tag=f"@{LM_ARCH}"):
    """Each LM kernel, summed over one ``generate`` of 32 tokens (a prefill
    of 8 x 512 tokens, then 31 decode steps), each case's time times its
    uses there (the 128- and 40-row matmul cases are on no such path)."""
    steps = LM_STEPS - 1

    def uses(kname, r):
        if kname.startswith("flash_attention"):
            return LM_LAYERS
        if kname.startswith("decode_attention"):
            return LM_LAYERS * steps
        return LM_LAYERS * {B * LM_S: 1, B: steps}.get(r["rows"], 0)
    return summed_entries(
        _by_schedule(cases),
        {"bfloat16": _sched_launches(lm["launches"], lm["matmul_schedules"],
                                     lm["flash_schedules"],
                                     decode=lm["decode_schedules"]),
         "float32": _sched_launches(lm["launches_fp32"],
                                    lm["matmul_schedules_fp32"],
                                    lm["flash_schedules_fp32"],
                                    decode=lm["decode_schedules_fp32"])},
        tag,
        lambda k, used: f"one {LM_ARCH} generate: prefill of {B}x{LM_S} "
                        f"tokens, then {steps} decode steps", uses)


def base_kernel_entries(cases, lm):
    """The base variant, one entry per schedule, shape and dtype: one call;
    the SIMT base kernel at each shape beside it
    (``matmul_fused_base[simt]``).  Its launches on the main path (the LM
    generate runs) are 0: no op-layer caller passes ``vmem_accum=False``."""
    split = {}
    for r in cases["matmul_fused_base"]:
        split.setdefault(f"matmul_fused_base[{r['schedule']}]", []).append(r)
        split.setdefault("matmul_fused_base[simt]", []).append(_simt_twin(r))
    out = []
    for rows, tag in ((B, "@resnet34_fc"), (B * LM_S, "@4096x2048x2048")):
        out += summed_entries(
            split,
            {"bfloat16": lm["launches"], "float32": lm["launches_fp32"]},
            tag, lambda k, used: f"one call at {used[0][0]['shape']}",
            lambda k, r, rows=rows: int(r["rows"] == rows))
    return out


def dense_kernel_entries(cases, dense):
    """Each kernel at each of qwen1.5-4b's, phi4-mini-3.8b's and
    stablelm-1.6b's shapes, summed over one generate (flash and the
    4096-row matmuls at the prefill, decode_attention and the 8-row
    matmuls at each of 31 decode steps); paged_decode_attention one call
    at a workload-A tick.  ``launches`` counts the model's runs of that
    dtype (generate and workload A)."""
    steps = LM_STEPS - 1
    out = []
    for arch in DENSE_ARCHS:
        rec = dense[arch]
        layers, full = rec["layers"], rec["layers_full"]
        launches = {}
        for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
            g, s_ = rec[f"generate_{prec}"], rec[f"serve_{prec}"]
            counts = [_sched_launches(g["launches"], g["matmul_schedules"],
                                      g["flash_schedules"],
                                      decode=g["decode_schedules"]),
                      _sched_launches(s_["launches"], s_["matmul_schedules"],
                                      s_["flash_schedules"],
                                      paged=s_["paged_schedules"])]
            launches[dt] = {}
            for c in counts:
                for k, n in c.items():
                    launches[dt][k] = launches[dt].get(k, 0) + n

        def use(k, r, layers=layers, full=full):
            if k.startswith("matmul_fused"):
                per = r["uses_per_forward"] * layers // full
                return per * (1 if r["rows"] == B * LM_S else steps)
            return {"flash_attention": layers,
                    "decode_attention": layers * steps,
                    "paged_decode_attention": 1}[k.split("[")[0]]

        def per(kname, used, arch=arch, layers=layers):
            if kname.startswith("paged"):
                return f"one call at {used[0][0]['shape']}"
            return (f"one {arch} generate ({layers} layers): prefill of "
                    f"{B}x{LM_S} tokens, then {steps} decode steps")
        out += summed_entries(
            _by_schedule({k: [r for r in v if r.get("arch") == arch]
                          for k, v in cases.items()}),
            launches, f"@{arch}", per, use)
    return out


def new_kernel_entries(cases, new):
    """Each kernel at each of deepseek-moe-16b's, mixtral-8x7b's and
    llava-next-mistral-7b's shapes, summed over one generate at the depth
    of that dtype's run (flash and the prefill's matmuls once,
    decode_attention and the 8-row matmuls at each of 31 decode steps);
    paged_decode_attention one call at a workload-A tick, where workload A
    ran in that dtype.  ``launches`` counts the model's runs of that dtype
    (generate, and workload A where it ran)."""
    steps = LM_STEPS - 1
    out = []
    for arch in NEW_ARCHS:
        rec = new[arch]
        S, _ = _new_cell(arch)
        launches = {}
        for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
            g = rec[f"generate_{prec}"]
            counts = [_sched_launches(g["launches"], g["matmul_schedules"],
                                      g["flash_schedules"],
                                      decode=g["decode_schedules"])]
            s_ = rec.get(f"serve_{prec}")
            if s_:
                counts.append(_sched_launches(
                    s_["launches"], s_["matmul_schedules"],
                    s_["flash_schedules"], paged=s_["paged_schedules"]))
            launches[dt] = {}
            for c in counts:
                for k, n in c.items():
                    launches[dt][k] = launches[dt].get(k, 0) + n

        def use(k, r, rec=rec, S=S):
            prec = "bf16" if r["dtype"] == "bfloat16" else "fp32"
            layers = rec[f"layers_{prec}"]
            if k.startswith("matmul_fused"):
                return r["uses_per_forward"] * (1 if r["rows"] == B * S
                                                else steps)
            return {"flash_attention": layers,
                    "decode_attention": layers * steps,
                    "paged_decode_attention":
                        1 if rec.get(f"serve_{prec}") else 0}[k.split("[")[0]]

        def per(kname, used, arch=arch, S=S):
            if kname.startswith("paged"):
                return f"one call at {used[0][0]['shape']}"
            return (f"one {arch} generate: prefill of {B}x{S} tokens, then "
                    f"{steps} decode steps")
        out += summed_entries(
            _by_schedule({k: [r for r in v if r.get("arch") == arch]
                          for k, v in cases.items()}),
            launches, f"@{arch}", per, use)
    return out


def family_kernel_entries(cases, fam):
    """Each kernel at whisper-small's geometries, summed over one generate
    (flash at the encoder's and the decoder's prefill, each 12 a prefill;
    the prefill's matmuls once; decode_attention and the 8-row matmuls at
    each of 31 decode steps); ``launches`` counts whisper's generate of that
    dtype.  rwkv6-7b has none: no kernel runs on its path."""
    steps = LM_STEPS - 1
    rec = fam[WH_ARCH]
    n_enc, L = rec["layers"]
    launches = {}
    for dt, prec in (("bfloat16", "bf16"), ("float32", "fp32")):
        g = rec[f"generate_{prec}"]
        launches[dt] = _sched_launches(g["launches"], g["matmul_schedules"],
                                       g["flash_schedules"],
                                       decode=g["decode_schedules"])

    def use(k, r):
        if k.startswith("matmul_fused"):
            return r["uses_per_forward"] * (steps if r["rows"] == B else 1)
        if k.startswith("flash_attention"):
            return n_enc if "noncausal" in r["shape"] else L
        return L * steps

    def per(kname, used):
        return (f"one {WH_ARCH} generate: prefill of {B}x{rec['frames']} "
                f"frames and {B}x{rec['prompt']} tokens, then {steps} "
                "decode steps")
    return summed_entries(_by_schedule(cases), launches, f"@{WH_ARCH}", per,
                          use)


KERNEL_SOURCES = {   # kernel: (its source, the TPU kernel it replaces)
    "conv2d_fused[wgmma]": ("src/repro_torch/csrc/conv2d_wgmma.cu",
                            "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[ffma]": ("src/repro_torch/csrc/conv2d_fused.cu",
                           "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[small_ci]": ("src/repro_torch/csrc/conv2d_small_ci.cu",
                               "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[mid_ci]": ("src/repro_torch/csrc/conv2d_mid_ci.cu",
                             "src/repro/kernels/conv2d.py:64"),
    "conv2d_fused[simt]": ("src/repro_torch/csrc/conv2d_fused.cu",
                           "src/repro/kernels/conv2d.py:64"),
    "matmul_fused[wgmma]": ("src/repro_torch/csrc/matmul_wgmma.cu",
                            "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                              "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[ffma]": ("src/repro_torch/csrc/matmul_fused.cu",
                           "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[ffma_small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                                   "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused[simt]": ("src/repro_torch/csrc/matmul_fused.cu",
                           "src/repro/kernels/matmul_fused.py:83"),
    "matmul_fused_base[wgmma]": ("src/repro_torch/csrc/matmul_wgmma.cu",
                                 "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[small_m]": ("src/repro_torch/csrc/matmul_small_m.cu",
                                   "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[ffma]": ("src/repro_torch/csrc/matmul_fused.cu",
                                "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[ffma_small_m]": (
        "src/repro_torch/csrc/matmul_small_m.cu",
        "src/repro/kernels/matmul_fused.py:147"),
    "matmul_fused_base[simt]": ("src/repro_torch/csrc/matmul_fused.cu",
                                "src/repro/kernels/matmul_fused.py:147"),
    "flash_attention[wgmma]": (
        "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/attention.py:93"),
    "flash_attention[ffma]": ("src/repro_torch/csrc/flash_attention_ffma.cu",
                              "src/repro/kernels/attention.py:93"),
    "flash_attention[simt]": ("src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/attention.py:93"),
    "decode_attention[mma]": ("src/repro_torch/csrc/decode_core.cuh",
                              "src/repro/kernels/decode_attention.py:61"),
    "decode_attention[ffma]": ("src/repro_torch/csrc/decode_core.cuh",
                               "src/repro/kernels/decode_attention.py:61"),
    "decode_attention[simt]": ("src/repro_torch/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:61"),
    "paged_decode_attention[mma]": (
        "src/repro_torch/csrc/decode_core.cuh",
        "src/repro/kernels/decode_attention.py:189"),
    "paged_decode_attention[ffma]": (
        "src/repro_torch/csrc/decode_core.cuh",
        "src/repro/kernels/decode_attention.py:189"),
    "paged_decode_attention[simt]": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:189"),
    "copy_block": ("src/repro_torch/csrc/copy_block.cu",
                   "src/repro/kernels/decode_attention.py:158"),
    "lru_scan[chunked]": ("src/repro_torch/csrc/lru_scan.cu",
                          "src/repro/kernels/lru_scan.py:33"),
    "lru_scan[seq]": ("src/repro_torch/csrc/lru_scan.cu",
                      "src/repro/kernels/lru_scan.py:33"),
}


# ---------------------------------------------------------------------------
# phase 20: the multi-device runtime on a one-card mesh
# ---------------------------------------------------------------------------

MESH_AXES = (("data", 1), ("model", 1))
MESH_TRAIN_STEPS = 3
MESH_MOE_ARCH, MESH_MOE_DEPTH = "deepseek-moe-16b", 2
MESH_TOL = {"bf16": 5e-2, "fp32": 2e-4}
MESH_PIPE_MB = 2


def _schedules_now():
    """The wrappers' launches by schedule since the last ``reset_counts``
    (the schedules that ran)."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import matmul_fused as km

    def ran(d):
        return {k: n for k, n in d.items() if n}
    return {"matmul_fused": ran(km.matmul_fused.schedule_launches),
            "flash_attention": ran(ka.flash_attention.schedules),
            "decode_attention": ran(kd.decode_attention.schedules),
            "paged_decode_attention": ran(
                kd.paged_decode_attention.schedules),
            "conv2d_fused": ran(kc.conv2d_fused.schedule_launches)}


def _counted_run(fn):
    """``fn()`` with the counts set to 0 just before and read just after:
    (its result, the launches, the launches by schedule)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), _schedules_now()


def _same_launches(got, want, kernels, what):
    for k in kernels:
        if got[0][k] != want[0][k] or not got[0][k] or \
                got[1].get(k) != want[1].get(k):
            raise AssertionError(f"{what}: {k} launches {got[0][k]} "
                                 f"{got[1].get(k)} on the mesh, "
                                 f"{want[0][k]} {want[1].get(k)} unsharded")


def _on_mesh(cm, params):
    """The unsharded tree as the mesh's DTensors (at world size 1 each
    rank's chunk is the whole tensor: no copy)."""
    return cm.rules.distribute(params, cm.rules.params_shardings(cm.plan))


def _mesh_pipeline(cfg):
    """``make_pipeline_loss`` on a ``(("pod", 1), ("data", 1))`` mesh
    (GPipe over a one-stage pod axis: the card's machine has one card, so
    no activation is sent) against the unsharded ``loss_fn`` on the same
    fp32 weights and batch: loss within 1e-5 and gradients within 1e-4
    (relerr; the microbatches sum the gradients in another order), the
    launches of matmul_fused and flash_attention ``MESH_PIPE_MB`` times
    the unsharded run's (one forward and backward a microbatch)."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.distributed.pipeline_parallel import make_pipeline_loss
    from repro_torch.distributed.sharding import local_of
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.trainer import _grads
    shape = ShapeConfig("train", "train", TRAIN_S, B)
    fl = FlowConfig(mode="folded", precision="fp32", remat="none",
                    pp_axis="pod")
    cm0 = tflow.compile(cfg, shape, fl)
    cm = tflow.compile(cfg, shape, fl, mesh={"pod": 1, "data": 1})
    p0 = cm0.init_params(SEED)
    p = _on_mesh(cm, p0)
    rng = np.random.RandomState(SEED)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (
        B, TRAIN_S)).astype(np.int64)).cuda() for k in ("tokens", "labels")}
    loss = make_pipeline_loss(cm.plan, cm.mesh, n_microbatches=MESH_PIPE_MB,
                              pp_axis="pod")
    (l0, _, g0), *want = _counted_run(lambda: _grads(cm0.loss_fn, p0,
                                                      batch))
    (l1, _, g1), *got = _counted_run(lambda: _grads(
        lambda q, b: (loss(q, b), {}), tree_map(local_of, p), batch))
    g1 = loss.reduce_grads(g1)
    lerr = abs(float(l1) - float(l0)) / abs(float(l0))
    gerr = max(relerr(a, b) for a, b in zip(tree_leaves(g1),
                                            tree_leaves(g0)))
    kern = ("matmul_fused", "flash_attention")
    launches = {k: got[0][k] for k in kern}
    if not lerr <= 1e-5 or not gerr <= 1e-4 or any(
            not launches[k] or launches[k] != MESH_PIPE_MB * want[0][k]
            for k in kern):
        raise AssertionError(f"mesh pipeline: loss {float(l1)} vs "
                             f"{float(l0)}, grads relerr {gerr}, launches "
                             f"{launches} vs {want[0]}")
    out = {"layers": cfg.n_layers, "microbatches": MESH_PIPE_MB,
           "loss_relerr": lerr, "grads_relerr": gerr, "launches": launches}
    del cm0, cm, p0, p, g0, g1
    torch.cuda.empty_cache()
    return out


def phase_mesh(smi):
    """Phase 20: ``compile(mesh=)``, ``Trainer(mesh=)``, the MoE, GPipe
    and a CNN on a DeviceMesh of the one card, each held to the unsharded
    ``CompiledModel``.  The process group it starts stays up for phase
    21."""
    import torch.distributed as dist
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.core import ops_impl
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import init_process_group
    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.distributed.tensor import DTensor
    t_start = time.perf_counter()
    backend = init_process_group(1, 0, "cuda")
    mesh = MeshSpec(MESH_AXES).build()
    rec = {"backend": backend, "world_size": dist.get_world_size(),
           "mesh": MeshSpec.of(mesh).describe(), "nvidia_smi": smi}
    kern3 = ("matmul_fused", "flash_attention", "decode_attention")

    # llama3.2-1b at full width and depth: generate and the prefill
    cfg = get_config(LM_ARCH)
    shape = ShapeConfig("serve", "decode", LM_C, B)
    rng = np.random.RandomState(SEED)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()}
    params16 = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm0 = tflow.compile(cfg, shape, fl)
        cm = tflow.compile(cfg, shape, fl, mesh=mesh)
        if prec == "bf16":
            rec["sharding_line"] = next(
                ln.strip() for ln in cm.describe().splitlines()
                if ln.strip().startswith("sharding:"))
            params16 = cm0.init_params(SEED)
        p0 = params16 if prec == "bf16" else _widened(params16)
        p = _on_mesh(cm, p0)
        if not isinstance(p["embed"]["table"], DTensor):
            raise AssertionError("mesh params are not DTensors")
        (t0, _), *want = _counted_run(lambda: cm0.generate(
            p0, batch, steps=LM_STEPS))
        (t1, st), *got = _counted_run(lambda: cm.generate(
            p, batch, steps=LM_STEPS))
        _same_launches(got, want, kern3, f"{prec} mesh generate")
        if not isinstance(next(iter(next(iter(st.values())).values()))["k"],
                          DTensor):
            raise AssertionError("mesh state is not DTensors")
        y0 = cm0.prefill(p0, batch)[0]
        y1 = full_tensor(cm.prefill(p, batch)[0])
        err = relerr(y1.float(), y0.float())
        if not err <= MESH_TOL[prec]:
            raise AssertionError(f"{prec} mesh prefill logits relerr {err}")
        if prec == "fp32" and not torch.equal(t0, t1):
            raise AssertionError("fp32 mesh greedy tokens differ from the "
                                 "unsharded run's")
        rec[f"llama_{prec}"] = {
            "prefill_relerr": err, "tokens_identical": torch.equal(t0, t1),
            "launches": {k: got[0][k] for k in kern3},
            "matmul_schedules": got[1]["matmul_fused"],
            "flash_schedules": got[1]["flash_attention"],
            "decode_schedules": got[1]["decode_attention"]}
        del cm0, cm, p0, p, st, y0, y1
        torch.cuda.empty_cache()
    del params16
    torch.cuda.empty_cache()

    # Trainer(mesh=) at full width, TRAIN_DEPTH layers
    tcfg_m = dataclasses.replace(cfg, n_layers=TRAIN_DEPTH)
    tshape = ShapeConfig("train", "train", TRAIN_S, B)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=B))
    opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    tc = TrainerConfig(steps=MESH_TRAIN_STEPS, log_every=1)
    cm0 = tflow.compile(tcfg_m, tshape, FlowConfig(mode="folded"))
    cm = tflow.compile(tcfg_m, tshape, FlowConfig(mode="folded"), mesh=mesh)
    (_, _, h0), *want = _counted_run(lambda: Trainer(cm0, opt, tc).fit(
        data, SEED))
    (pm, _, h1), *got = _counted_run(lambda: Trainer(cm, opt, tc).fit(
        data, SEED))
    _same_launches(got, want, ("matmul_fused", "flash_attention"),
                   "mesh train")
    terr = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(h1, h0))
    if len(h1) != MESH_TRAIN_STEPS or not terr <= 1e-5 or \
            not isinstance(pm["embed"]["table"], DTensor):
        raise AssertionError(f"mesh train losses {h1} vs {h0}")
    rec["train"] = {"layers": TRAIN_DEPTH, "losses": [a for _, a in h1],
                    "unsharded_losses": [b for _, b in h0],
                    "loss_relerr_max": terr,
                    "launches": {k: got[0][k] for k in
                                 ("matmul_fused", "flash_attention")}}
    del pm
    # the same with int8 error-feedback compression: on the mesh the
    # gradients, moments and error buffers are DTensors, the scale the
    # whole tensor's (a MAX all-reduce over the sharded dims)
    optc = dataclasses.replace(opt, compress="int8_ef")
    (_, oc0, hc0), *want = _counted_run(lambda: Trainer(cm0, optc, tc).fit(
        data, SEED))
    (_, oc1, hc1), *got = _counted_run(lambda: Trainer(cm, optc, tc).fit(
        data, SEED))
    _same_launches(got, want, ("matmul_fused", "flash_attention"),
                   "mesh compressed train")
    tcerr = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(hc1, hc0))
    eerr = max(relerr(full_tensor(a), b) for a, b in zip(
        tree_leaves(oc1.err), tree_leaves(oc0.err)))
    if len(hc1) != MESH_TRAIN_STEPS or not tcerr <= 1e-5 or \
            not isinstance(tree_leaves(oc1.err)[0], DTensor):
        raise AssertionError(f"mesh compressed train losses {hc1} vs {hc0}")
    rec["train_compressed"] = {
        "layers": TRAIN_DEPTH, "losses": [a for _, a in hc1],
        "unsharded_losses": [b for _, b in hc0], "loss_relerr_max": tcerr,
        "err_relerr_max": eerr,
        "launches": {k: got[0][k] for k in
                     ("matmul_fused", "flash_attention")}}
    del cm0, cm, oc0, oc1
    torch.cuda.empty_cache()

    # deepseek-moe-16b at 2 layers: the prefill on DTensor weights.  A
    # one-rank model axis carries data parallelism (JAX's split_roles), so
    # op_moe_ffn runs on the rank's rows, as JAX runs it on this mesh
    mcfg = dataclasses.replace(get_config(MESH_MOE_ARCH),
                               n_layers=MESH_MOE_DEPTH)
    mshape = ShapeConfig("serve", "prefill", LM_S, B)
    fl = FlowConfig(mode="folded")
    cm0 = tflow.compile(mcfg, mshape, fl)
    cm = tflow.compile(mcfg, mshape, fl, mesh=mesh)
    if cm.rules.tp is not None:
        raise AssertionError(f"one-rank model axis kept as tp: {cm.rules}")
    p0 = cm0.init_params(SEED)
    p = _on_mesh(cm, p0)
    mb = {"tokens": torch.from_numpy(np.random.RandomState(SEED).randint(
        0, mcfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()}
    moe_calls = []
    inner = ops_impl.OPS["moe_ffn"]

    def counted(ctx, op, pp, x):
        moe_calls.append(ctx.plan.rules is not None and
                         not isinstance(pp["we_gate"], DTensor))
        return inner(ctx, op, pp, x)
    y0, *want = _counted_run(lambda: cm0.prefill(p0, mb)[0])
    ops_impl.OPS["moe_ffn"] = counted
    try:
        y1, *got = _counted_run(lambda: full_tensor(cm.prefill(p, mb)[0]))
    finally:
        ops_impl.OPS["moe_ffn"] = inner
    _same_launches(got, want, ("matmul_fused", "flash_attention"),
                   "mesh MoE prefill")
    merr = relerr(y1.float(), y0.float())
    if moe_calls != [True] * (MESH_MOE_DEPTH - 1) or \
            not merr <= MESH_TOL["bf16"]:
        raise AssertionError(f"mesh MoE prefill: op_moe_ffn calls "
                             f"{moe_calls}, relerr {merr}")
    rec["moe"] = {"arch": MESH_MOE_ARCH, "layers": MESH_MOE_DEPTH,
                  "moe_calls": len(moe_calls), "prefill_relerr": merr,
                  "launches": {k: got[0][k] for k in
                               ("matmul_fused", "flash_attention")}}
    del cm0, cm, p0, p, y0, y1
    torch.cuda.empty_cache()

    # GPipe on a one-stage pod axis: llama3.2-1b at TRAIN_DEPTH layers, fp32,
    # MESH_PIPE_MB microbatches; its loss and gradients against the
    # unsharded loss_fn's (the stage's buffers and positions on the card)
    rec["pipeline"] = _mesh_pipeline(tcfg_m)

    # ResNet-34 at batch 8: a bf16 forward on the mesh
    ccfg = get_config("resnet34")
    cshape = ShapeConfig("serve", "prefill", 64, B)
    cm0 = tflow.compile(ccfg, cshape, FlowConfig(mode="folded"))
    cm = tflow.compile(ccfg, cshape, FlowConfig(mode="folded"), mesh=mesh)
    p0 = cm0.init_params(SEED)
    p = _on_mesh(cm, p0)
    x = torch.from_numpy(np.random.RandomState(SEED).randn(
        B, ccfg.image_size, ccfg.image_size,
        ccfg.image_channels).astype(np.float32)).cuda()
    y0, *want = _counted_run(lambda: cm0.prefill(p0, {"images": x})[0])
    y1, *got = _counted_run(lambda: full_tensor(cm.prefill(
        p, {"images": x})[0]))
    _same_launches(got, want, ("conv2d_fused", "matmul_fused"),
                   "mesh ResNet-34")
    cerr = relerr(y1.float(), y0.float())
    if got[0]["conv2d_fused"] != 36 or not cerr <= MESH_TOL["bf16"]:
        raise AssertionError(f"mesh ResNet-34: {got[0]} relerr {cerr}")
    rec["resnet34"] = {"arch": "resnet34", "flow": "bf16",
                       "logits_relerr": cerr,
                       "launches": {k: got[0][k] for k in
                                    ("conv2d_fused", "matmul_fused")},
                       "matmul_schedules": got[1]["matmul_fused"],
                       "conv_schedules": got[1]["conv2d_fused"]}
    del cm0, cm, p0, p
    torch.cuda.empty_cache()
    # the group stays up: phase 21 serves on it
    rec["seconds"] = time.perf_counter() - t_start
    log(json.dumps({"mesh": {
        "backend": backend, "world_size": rec["world_size"],
        "llama_prefill_relerr": {q: rec[f"llama_{q}"]["prefill_relerr"]
                                 for q in ("bf16", "fp32")},
        "llama_launches": {q: rec[f"llama_{q}"]["launches"]
                           for q in ("bf16", "fp32")},
        "fp32_tokens_identical": rec["llama_fp32"]["tokens_identical"],
        "train_loss_relerr": terr,
        "compressed_train_loss_relerr": tcerr, "moe_prefill_relerr": merr,
        "moe_calls": len(moe_calls),
        "pipeline": rec["pipeline"], "resnet34_relerr": cerr,
        "resnet34_launches": rec["resnet34"]["launches"],
        "seconds": rec["seconds"]}}))
    return rec


def mesh_kernel_entries(cases, lm_cases, mesh):
    """The kernels of the mesh phase's runs: llama's generates (summed as
    :func:`lm_kernel_entries` sums them) and ResNet-34's bf16 forward (as
    :func:`kernel_entries`), their ``launches`` counted on the mesh."""
    lm = {"launches": mesh["llama_bf16"]["launches"],
          "launches_fp32": mesh["llama_fp32"]["launches"]}
    for prec, suf in (("bf16", ""), ("fp32", "_fp32")):
        g = mesh[f"llama_{prec}"]
        lm.update({f"matmul_schedules{suf}": g["matmul_schedules"],
                   f"flash_schedules{suf}": g["flash_schedules"],
                   f"decode_schedules{suf}": g["decode_schedules"]})
    return lm_kernel_entries(lm_cases, lm, tag=f"@{LM_ARCH}/mesh") + \
        kernel_entries(cases, [mesh["resnet34"]], tag="@mesh")


# ---------------------------------------------------------------------------
# phase 21: serving on a one-card mesh, its autotune, and the dry-run
# ---------------------------------------------------------------------------

SERVE_MESH_DEPTH = 4          # llama3.2-1b's 16 layers cut: the time limit
SERVE_MESH_KERNELS = ("matmul_fused", "flash_attention",
                      "paged_decode_attention")
DRYRUN_CELLS = (("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "train_4k"),
                ("resnet34", "train_4k"))


def _dryrun_start():
    """The dry-run's cells, each ``python -m repro_torch.launch.dryrun`` in
    a process of its own (its own fake group of 256 ranks on the
    production mesh), started together: (cell, process, out path)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = []
    for arch, shape in DRYRUN_CELLS:
        path = os.path.join(ROOT, "build", f"dryrun_{arch}_{shape}.json")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", path], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        out.append(((arch, shape), proc, path))
    return out


def _dryrun_finish(started, limit=300):
    """Each dry-run cell's ``OK`` line and record (per-device bytes and
    whether they fit the budget); a cell that fails or prints no ``OK``
    line raises."""
    rows = []
    for (arch, shape), proc, path in started:
        try:
            text, _ = proc.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry-run {arch} x {shape}: past {limit} s")
        ok = [ln for ln in text.splitlines() if ln.startswith("OK ")]
        if proc.returncode or not ok:
            raise AssertionError(f"dry-run {arch} x {shape}: exit "
                                 f"{proc.returncode}\n{text[-2000:]}")
        with open(path) as f:
            r = json.load(f)[0]
        m = r["memory"]
        row = {"arch": arch, "shape": shape, "mesh": r["mesh"],
               "per_device_bytes": m["per_device_bytes"],
               "per_device_gib": m["per_device_bytes"] / 2 ** 30,
               "fits_budget": m["fits_budget"],
               "budget_bytes": m["budget_bytes"],
               "flops": r["cost_analysis"]["flops"],
               "collective_bytes": r["collectives"]["collective_bytes"],
               "fake_step_s": r["compile_s"], "ok_line": ok[0]}
        log(json.dumps({"dryrun": row}))
        rows.append(row)
    return rows


def _served_alike(got, want, forks, forks0, must_fork, prec, what):
    """A mesh serving run against the unsharded one: matmul_fused's,
    flash_attention's and paged_decode_attention's launches by schedule
    equal, paged on ``mma`` (fp32 ``ffma``) and flash on ``wgmma``
    (``ffma``), and copy_block launched once a fork in each (``must_fork``:
    at least one)."""
    _same_launches(got, want, SERVE_MESH_KERNELS, what)
    if got[0]["copy_block"] != forks or want[0]["copy_block"] != forks0 \
            or (must_fork and not forks):
        raise AssertionError(f"{what}: copy_block {got[0]['copy_block']} "
                             f"for {forks} forks")
    _decode_scheduled(got[0]["paged_decode_attention"], prec, what,
                      "paged_decode_attention")
    _flash_scheduled(got[0]["flash_attention"], prec, what)


def phase_serve_mesh(smi):
    """Phase 21: ``Engine(mesh=)`` on the one-card ``(("data", 1),
    ("model", 1))`` mesh over NCCL (phase 20's group): llama3.2-1b at full
    width and SERVE_MESH_DEPTH layers, serving workloads A and B in bf16
    and fp32, each held to the unsharded engine on the same weights
    (tokens equal; the launches of matmul_fused, flash_attention and
    paged_decode_attention by schedule equal; copy_block once a fork);
    ``autotune_decode(mesh=, validate="compile")`` on one batch bucket and
    its pinned engine on the mesh; the dry-run of ``DRYRUN_CELLS`` on the
    256-rank production mesh in processes of their own, started first and
    stopped, whatever happens, before the phase returns."""
    t_start = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    dry = _dryrun_start()                  # host CPU work, runs meanwhile
    try:
        return _serve_mesh(smi, dry, t_start)
    finally:
        for _, proc, _ in dry:             # stop every process started
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _serve_mesh(smi, dry, t_start):
    import torch.distributed as dist
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.device import init_process_group
    from repro_torch.distributed.meshspec import MeshSpec
    from repro_torch.serving.autotune import ServingProfile, autotune_decode
    from torch.distributed.tensor import DTensor
    backend = init_process_group(1, 0, "cuda")
    mesh = MeshSpec(MESH_AXES).build()
    rec = {"backend": backend, "world_size": dist.get_world_size(),
           "mesh": MeshSpec.of(mesh).describe(), "nvidia_smi": smi,
           "layers": SERVE_MESH_DEPTH, "slots": SERVE_SLOTS,
           "max_seq_len": SERVE_SEQ, "block_size": SERVE_BS}
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=SERVE_MESH_DEPTH)
    shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    works = _serve_workloads(cfg.vocab_size)
    params16 = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm0 = tflow.compile(cfg, shape, fl)
        cm = tflow.compile(cfg, shape, fl, mesh=mesh)
        if params16 is None:
            params16 = cm0.init_params(SEED)
        p0 = params16 if prec == "bf16" else _widened(params16)
        launches = {k: 0 for k in SERVE_MESH_KERNELS + ("copy_block",)}
        scheds = {k: {} for k in SERVE_MESH_KERNELS}
        for name in ("A", "B"):
            wl, kw = SERVE_KNOBS[name]
            (_, rep0), *want = _counted_run(lambda: _engine_run(
                cm0, p0, works[wl], **kw))
            (eng, rep), *got = _counted_run(lambda: _engine_run(
                cm, p0, works[wl], **kw))
            what = f"{prec} mesh serving {name}"
            if not isinstance(eng.params["embed"]["table"], DTensor) or \
                    eng.mesh is None:
                raise AssertionError(f"{what}: not served on the mesh")
            if _tokens(rep) != _tokens(rep0):
                raise AssertionError(f"{what}: tokens differ from the "
                                     "unsharded engine's")
            forks = rep.metrics["cow_forks"]
            _served_alike(got, want, forks, rep0.metrics["cow_forks"],
                          name == "B", prec, what)
            for k in launches:
                launches[k] += got[0][k]
            for k in SERVE_MESH_KERNELS:
                for s_, n in got[1][k].items():
                    scheds[k][s_] = scheds[k].get(s_, 0) + n
            rec[f"{prec}_{name}"] = {
                "tokens_identical": True, "cow_forks": forks,
                "prefix_hits": rep.metrics["prefix_hits"],
                "prefill_batches": rep.metrics["prefill_batches"],
                "decode_ticks": rep.metrics["decode_ticks"],
                "tokens_per_s": rep.metrics["tokens_per_s"],
                "unsharded_tokens_per_s": rep0.metrics["tokens_per_s"],
                "launches": {k: got[0][k] for k in launches}}
            log(json.dumps({"serve_mesh": name, "precision": prec,
                            **rec[f"{prec}_{name}"]}))
            del eng
        rec[f"launches_{prec}"] = launches
        rec[f"schedules_{prec}"] = scheds
        del cm0, cm, p0
        torch.cuda.empty_cache()
    del params16
    torch.cuda.empty_cache()

    # the serving autotune on the mesh: one batch bucket, the compile
    # validator; its pinned engine serves on the mesh
    t = time.perf_counter()
    prof = ServingProfile(name="serve_mesh", batch_buckets=(SERVE_SLOTS,),
                          max_seq_len=SERVE_SEQ, block_sizes=(SERVE_BS,),
                          chunk_sizes=(1,))
    at = autotune_decode(cfg, profile=prof, mesh={"data": 1, "model": 1},
                         validate="compile", iters=1)
    pinned = at.engine()
    reset_counts()
    rep = pinned.run(works["A"][:SERVE_SLOTS])
    got = read_counts()
    if at.mesh is None or pinned.mesh is None or \
            pinned.plan.rules is None or not got["paged_decode_attention"] \
            or rep.metrics["generated_tokens"] != SERVE_SLOTS * SERVE_NEW:
        raise AssertionError(f"mesh autotune: {at.describe()} {got}")
    rec["autotune"] = {"describe": at.describe(), "seconds":
                       time.perf_counter() - t, "validate": "compile",
                       "pinned_launches": {k: got[k] for k in
                                           SERVE_MESH_KERNELS}}
    del at, pinned
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    rec["dryrun"] = _dryrun_finish(dry)
    rec["seconds"] = time.perf_counter() - t_start
    log(json.dumps({"serve_mesh": {
        "backend": backend, "world_size": rec["world_size"],
        "layers": SERVE_MESH_DEPTH,
        "launches_bf16": rec["launches_bf16"],
        "launches_fp32": rec["launches_fp32"],
        "autotune_s": rec["autotune"]["seconds"],
        "dryrun": [(r["arch"], r["shape"], r["per_device_bytes"],
                    r["fits_budget"]) for r in rec["dryrun"]],
        "seconds": rec["seconds"]}}))
    return rec


def serve_mesh_kernel_entries(lm_cases, serve_cases, sm):
    """The kernels of the served mesh runs (workloads A and B at
    SERVE_MESH_DEPTH layers): one call of each at the serving shapes
    (matmul_fused at a decode tick's 8 rows and the prefill's 4096,
    flash_attention at 8 x 512, paged_decode_attention at a tick, a fork's
    copy_block), ``launches`` counted on the mesh."""
    cases = _by_schedule({k: v for k, v in lm_cases.items()
                          if k in ("matmul_fused", "flash_attention")})
    cases.update(_by_schedule(serve_cases))

    def uses(kname, r):
        if kname.startswith("paged_decode_attention"):
            return int(r.get("sq", 1) == 1)
        if kname.startswith("matmul_fused"):
            return int(r.get("rows") in (B, B * LM_S))
        return 1

    def per(kname, used):
        return "one call at each of " + ", ".join(
            str(r["shape"]) for r, _ in used)
    launches = {}
    for prec, dt in (("bf16", "bfloat16"), ("fp32", "float32")):
        s_ = sm[f"schedules_{prec}"]
        launches[dt] = _sched_launches(
            sm[f"launches_{prec}"],
            s_["matmul_fused"], s_["flash_attention"],
            paged=s_["paged_decode_attention"])
    return summed_entries(cases, launches, f"@{LM_ARCH}/serve_mesh", per,
                          uses)


# ---------------------------------------------------------------------------
# phase 22: the Hopper tiles
# ---------------------------------------------------------------------------

# flash_attention at each tile, 8 x 512 causal: (arch, H, KV, D, window)
TILE_FLASH = (("llama3.2-1b", LM_H, LM_KV, LM_D, None),
              ("qwen1.5-4b", 20, 20, 128, None),
              ("recurrentgemma-2b", RG_H, RG_KV, RG_D, 2048))
TILE_CONVS = ("3x3s1_128@28", "3x3s1_256@14", "3x3s1_512@7")
TILE_DB = os.path.join(ROOT, "build", "tiles_smoke.jsonl")


def _tile_kernel_cases(gen):
    """Each tiled kernel at each tile its schedule takes, held to its plain
    version, timed by CUDA graph beside its plain version, the library
    call and the bound: flash at llama's, qwen's and the hybrid's heads,
    three of ResNet-34's 3 x 3 convs, llama's q projection at 4096 rows,
    in bf16 and fp32.  The ffma flash kernel at head width 256 refuses bq
    128 before any launch."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul_fused as km
    cases = {"flash_attention": [], "conv2d_fused": [], "matmul_fused": []}

    def keep(kname, c, tile, arch):
        if c["tile"] != _tile_label(tile):
            raise AssertionError(f"{kname} {c['shape']}: ran at tile "
                                 f"{c['tile']}, given {tile}")
        c["arch"] = arch
        cases[kname].append(c)
        log(json.dumps({"tile_kernel": kname, **c}))
    for dt in (torch.bfloat16, torch.float32):
        for arch, H, KV, D, window in TILE_FLASH:
            sched = ka._schedule(dt, D)
            for tile in ka.TILES:
                if sched == "ffma" and (D, tile[0]) not in ka.FFMA_RING:
                    q = torch.zeros(1, 64, 1, D, dtype=dt, device="cuda")
                    n0 = ka.flash_attention.launches
                    try:
                        ka.flash_attention(q, q, q, tile=tile)
                    except ValueError:
                        pass
                    else:
                        raise AssertionError(f"ffma D {D} took {tile}")
                    if ka.flash_attention.launches != n0:
                        raise AssertionError("a refused tile launched")
                    continue
                keep("flash_attention",
                     _flash_case(dt, gen, H=H, KV=KV, D=D, window=window,
                                 iters=10, tile=tile, twin=False), tile, arch)
        for spec in RESNET_CONVS:
            if spec[0] in TILE_CONVS:
                for tile in kc.TILES:
                    keep("conv2d_fused", _conv_case(spec, dt, gen, tile=tile,
                                                    twin=False),
                         kc.block_of("wgmma", spec[3], tile), "resnet34")
        name, K, N, glu = LM_MATMULS[0]
        for tile in km.TILES:
            keep("matmul_fused", _lm_matmul_case(
                name, B * LM_S, K, N, glu, dt, gen, LM_LAYERS, tile=tile,
                twin=False), tile, LM_ARCH)
    return cases


# decode_attention at the auto split and at each pinned chunk: (arch, the
# _decode_case keywords of its decode shape)
TILE_DECODE = (("llama3.2-1b", dict(H=LM_H, KV=LM_KV, D=LM_D)),
               ("qwen1.5-4b", dict(H=20, KV=20, D=128)),
               ("recurrentgemma-2b", dict(C=RG_C, qpos=RG_S + RG_STEPS - 2,
                                          H=RG_H, KV=RG_KV, D=RG_D,
                                          window=RG_WINDOW)))
TILE_DECODE_CHUNKS = (128, 256, 512, 1024)   # and each shape's least
PINNED_DECODE = 256          # the chunk the llama3.2-1b flow pins


def _decode_tile_cases(gen):
    """decode_attention at llama3.2-1b's, qwen1.5-4b's and
    recurrentgemma-2b's decode shapes, bf16 and fp32, at the auto split
    and at each chunk of ``TILE_DECODE_CHUNKS`` and the least the rules
    take (``decode_attention.least_tile``): each held to the plain
    version, timed by CUDA graph beside it, SDPA and the bound, and its
    launch counted under the chunk it was given (``retiled`` off the auto
    split only).  A chunk the rules refuse raises before any launch."""
    from repro_torch.kernels import decode_attention as kd
    out = []
    for dt in (torch.bfloat16, torch.float32):
        for arch, kw in TILE_DECODE:
            C = kw.get("C", LM_C)
            G = kw["H"] // kw["KV"]
            least = kd.least_tile(C, G, kw["D"], dt)
            for chunk in [None, least] + [c for c in TILE_DECODE_CHUNKS
                                          if c > least]:
                t0 = dict(kd.decode_attention.tiles)
                r0 = kd.decode_attention.retiled
                c = _decode_case(dt, gen, tile=chunk, twin=False, iters=20,
                                 **kw)
                torch.cuda.synchronize()
                new = {k: n - t0.get(k, 0)
                       for k, n in kd.decode_attention.tiles.items()
                       if n != t0.get(k, 0)}
                ran = {k[1] for k in new}
                if len(ran) != 1 or (chunk is not None
                                     and ran != {chunk}):
                    raise AssertionError(f"decode tile {chunk} at {arch}: "
                                         f"launched at {new}")
                (ran,) = ran
                auto = ran if chunk is None else auto
                off = kd.decode_attention.retiled - r0
                if off != (sum(new.values()) if ran != auto else 0):
                    raise AssertionError(f"decode tile {chunk} at {arch}: "
                                         f"{off} retiled launches")
                c.update(arch=arch, tile="auto" if chunk is None
                         else str(chunk), chunk=ran)
                out.append(c)
                log(json.dumps({"tile_kernel": "decode_attention", **c}))
            q = torch.zeros(1, 1, kw["H"], kw["D"], dtype=dt, device="cuda")
            kc = torch.zeros(1, C, kw["KV"], kw["D"], dtype=dt,
                             device="cuda")
            pos = torch.zeros(1, C, dtype=torch.int32, device="cuda")
            n0 = kd.decode_attention.launches
            try:
                kd.decode_attention(q, kc, kc, pos, pos[:, :1],
                                    tile=least - kd.TILE)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{arch}: chunk {least - kd.TILE} "
                                     "under the least launched")
            if kd.decode_attention.launches != n0:
                raise AssertionError("a refused chunk launched")
    return out


def _pinned_decode(cfg, serve, flow, params, ref, batch, prec):
    """llama3.2-1b under ``flow`` (decode tile ``"auto"``) and pinned to
    ``PINNED_DECODE`` slots by ``tile_overrides``: every decode launch at
    the auto split (``retiled`` 0) or at the pinned chunk; bf16: the
    prefill and four teacher-forced decode steps' logits against the
    reference backend's; fp32: 8 greedy tokens identical to its.  Returns
    each flow's decode launches by schedule and tile."""
    from repro_torch import flow as tflow
    from repro_torch.kernels import decode_attention as kd
    sched = DECODE_SCHEDULES[prec]
    steps = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab_size, (B, TF_STEPS)).astype(np.int64)).cuda()
    if prec == "bf16":
        yr, st_r, _ = ref.prefill(params, batch)
        want = []
        for t in range(TF_STEPS):
            y, st_r, _ = ref.decode(params, {"tokens": steps[:, t:t + 1]},
                                    st_r, LM_S + t)
            want.append(y)
    else:
        want, _ = ref.generate(params, batch, steps=8)
    out = {}
    for name, tile in (("auto", "auto"), ("pinned", PINNED_DECODE)):
        fl = flow if tile == "auto" else dataclasses.replace(
            flow, tile_overrides=(("decode_attention", tile),))
        cm = tflow.compile(cfg, serve, fl)
        if cm.plan.tiles["decode_attention"] != tile:
            raise AssertionError(f"decode tile {tile}: plan "
                                 f"{cm.plan.tiles}")
        what = f"decode tile {tile} {prec}"
        reset_counts()
        rec = {}
        if prec == "bf16":
            y, st, _ = cm.prefill(params, batch)
            errs = []
            for t in range(TF_STEPS):
                y, st, _ = cm.decode(params, {"tokens": steps[:, t:t + 1]},
                                     st, LM_S + t)
                errs.append(_lm_check_logits(f"{what} step {t}", y,
                                             want[t], PATH_TOL["bf16"]))
            rec["decode_logits_relerr_vs_reference"] = errs
            n = TF_STEPS * TUNE_DEPTH
        else:
            toks, _ = cm.generate(params, batch, steps=8)
            if not torch.equal(toks, want):
                raise AssertionError(f"{what}: greedy tokens differ from "
                                     "the reference backend's")
            rec["tokens_identical_to_reference"] = True
            n = 7 * TUNE_DEPTH
        torch.cuda.synchronize()
        got = dict(kd.decode_attention.tiles)
        chunks = {c for (_, c) in got}
        if sum(got.values()) != n or {s for (s, _) in got} != {sched} or \
                (tile == "auto" and kd.decode_attention.retiled) or \
                (tile != "auto" and chunks != {tile}):
            raise AssertionError(f"{what}: decode launches {got}, "
                                 f"{kd.decode_attention.retiled} retiled")
        rec["launches"] = {"decode_attention": {f"{sched}@{tile}": n}}
        rec["chunks"] = sorted(chunks)
        out[name] = rec
        del cm
    log(json.dumps({"decode_tile_flow": prec, **out}))
    return out


def _tune_tiles(smi):
    """``tune_kernel_tiles`` on llama3.2-1b at full width and ``TUNE_DEPTH``
    layers with a fresh tune database: every attention candidate compiled
    and measured (its flash launches counted at its tile), the winner
    banked; a second call a hit that compiles nothing; the pinned flow's
    bf16 prefill logits against the ``reference`` backend and its fp32
    greedy tokens identical to it."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.kernels.registry import REGISTRY
    from repro_torch.serving import autotune as sat
    prof = sat.ServingProfile(**TUNE_PROFILE)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TUNE_DEPTH)
    flow0 = FlowConfig(mode="folded")
    if os.path.exists(TILE_DB):
        os.remove(TILE_DB)
    cands = REGISTRY.get("attention", "cuda").contract.tile_candidates(
        cfg, None, flow0)
    compiles, orig = [], tflow.compile

    def counted(*a, **kw):
        compiles.append(1)
        return orig(*a, **kw)
    tflow.compile = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        best, times = sat.tune_kernel_tiles(cfg, prof, flow=flow0,
                                            iters=TUNE_ITERS, db=TILE_DB)
        search_s = time.perf_counter() - t0
        measured = read_tiles("flash_attention")
        n_first = len(compiles)
        best2, times2 = sat.tune_kernel_tiles(cfg, prof, flow=flow0,
                                              iters=TUNE_ITERS, db=TILE_DB)
        n_second = len(compiles) - n_first
    finally:
        tflow.compile = orig
    norm = tuple((k, tuple(t)) for k, t in best)
    win = min(cands, key=lambda c: times[f"attention:{c}"])
    if set(times) != {f"attention:{c}" for c in cands} or \
            n_first != len(cands) or norm != (("attention", win),) or \
            any(not measured.get(f"wgmma@{_tile_label(c)}") for c in cands):
        raise AssertionError(f"tune_kernel_tiles: {best} {times}, "
                             f"{n_first} compiles, flash {measured}")
    if n_second or tuple((k, tuple(t)) for k, t in best2) != norm or \
            times2 != times:
        raise AssertionError(f"tune_kernel_tiles second call: {best2} "
                             f"{times2}, {n_second} compiles")
    rec = {"layers": TUNE_DEPTH, "candidates": [list(c) for c in cands],
           "times_s": times, "winner": list(win), "search_s": search_s,
           "flash_tiles_measured": measured, "second_compiles": n_second,
           "launches": {}}
    # the pinned flow in bf16 (prefill logits) and fp32 (greedy tokens)
    serve = ShapeConfig("serve", "decode", LM_C, B)
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, LM_S)).astype(np.int64)).cuda()
    batch = {"tokens": prompt}
    for prec in ("bf16", "fp32"):
        fl = dataclasses.replace(flow0, precision=prec, tile_overrides=norm)
        cm = tflow.compile(cfg, serve, fl)
        ref = tflow.compile(cfg, serve, fl, backend="reference")
        if cm.plan.tiles["attention"] != win:
            raise AssertionError(f"pinned plan tiles {cm.plan.tiles}")
        params = cm.init_params(SEED)
        reset_counts()
        if prec == "bf16":
            y, _, _ = cm.prefill(params, batch)
            tiles = _at_plan_tiles(cm.plan, "pinned tiles bf16")
            rec["logits_relerr_vs_reference"] = _lm_check_logits(
                "pinned tiles bf16", y, ref.prefill(params, batch)[0],
                PATH_TOL["bf16"])
        else:
            toks, _ = cm.generate(params, batch, steps=8)
            tiles = _at_plan_tiles(cm.plan, "pinned tiles fp32")
            if not torch.equal(toks, ref.generate(params, batch,
                                                  steps=8)[0]):
                raise AssertionError("pinned tiles fp32: greedy tokens "
                                     "differ from the reference backend's")
            rec["tokens_identical_to_reference"] = True
        if not tiles.get("flash_attention"):
            raise AssertionError(f"pinned tiles {prec}: no flash launch")
        rec["launches"][prec] = tiles
        rec.setdefault("decode", {})[prec] = _pinned_decode(
            cfg, serve, dataclasses.replace(flow0, precision=prec), params,
            ref, batch, prec)
        del cm, ref, params
        torch.cuda.empty_cache()
    log(json.dumps({"tune_tiles": rec}))
    return rec


def _base_tiles(smi, path):
    """ResNet-34's base flow at the minimal tiles (phase 5's row: its convs
    counted by schedule and tile) and pinned to the selected ones (counted
    too), then both timed in turns (minimal, selected, selected, minimal):
    ``measure("prefill")`` (the host's clock: the forward is host-bound)
    and the device time of a forward's kernels under the profiler."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    base = next(r for r in path if r["arch"] == "resnet34"
                and r.get("flow_name") == "base")
    if base["conv_tiles"] != {"ffma@128x64": 35, "small_ci": 1} or \
            tuple(base["plan_tiles"]["conv2d"]) != (128, 64):
        raise AssertionError(f"resnet34 base flow: conv tiles "
                             f"{base['conv_tiles']}, plan "
                             f"{base['plan_tiles']}")
    flows = {"minimal": FlowConfig().base(),
             "selected": FlowConfig(tile_overrides=(
                 ("conv2d", (128, 128)), ("matmul", (128, 64, 128)))).base()}
    sel = _forward("resnet34", flows["selected"], {"ffma": 35, "small_ci": 1},
                   1, {"ffma_small_m": 1}, smi, measure=False)
    if sel["conv_tiles"] != {"ffma@128x128": 29, "ffma@128x64": 6,
                             "small_ci": 1}:
        raise AssertionError(f"resnet34 base flow at the selected tiles: "
                             f"{sel['conv_tiles']}")
    serve = ShapeConfig("serve", "prefill", 64, B)
    cms = {k: tflow.compile("resnet34", serve, f) for k, f in flows.items()}
    params = cms["minimal"].init_params(SEED)
    x = torch.from_numpy(np.random.RandomState(SEED).randn(
        B, 224, 224, 3).astype(np.float32)).cuda()
    ms = {k: [] for k in cms}
    dev = {k: [] for k in cms}
    for k in ("minimal", "selected", "selected", "minimal"):
        ms[k].append(cms[k].measure("prefill", iters=10,
                                    seed=SEED)["measured_step_s"] * 1e3)
        p = _profile(lambda: cms[k].prefill(params, {"images": x}))
        dev[k].append(p["device_busy_ms"] / p["iters"])
    rec = {k: {"conv_tiles": r["conv_tiles"], "plan_tiles": r["plan_tiles"],
               "ms_per_forward": ms[k], "device_ms_per_forward": dev[k]}
           for k, r in (("minimal", base), ("selected", sel))}
    rec["phase5_minimal_ms_per_forward"] = base["ms_per_forward"]
    log(json.dumps({"tiles_resnet34_base": rec}))
    return rec


def phase_tiles(smi, path):
    """Phase 22: the Hopper tiles.  Each tiled kernel at each candidate
    tile, decode_attention at the auto split and at each pinned chunk;
    ResNet-34's base flow (phase 5's row, at the minimal tiles: its convs
    counted by schedule and tile) beside the same flow pinned to the
    selected tiles; ``tune_kernel_tiles`` on llama3.2-1b and its pinned
    flow against the reference backend, and llama3.2-1b's decode at the
    auto split and pinned to ``PINNED_DECODE`` slots."""
    from repro_torch.configs.base import FlowConfig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    out = {"cases": _tile_kernel_cases(gen)}
    out["cases"]["decode_attention"] = _decode_tile_cases(gen)
    out["cases_s"] = time.perf_counter() - t0
    out["resnet34_base"] = _base_tiles(smi, path)
    torch.cuda.empty_cache()
    out["tune"] = _tune_tiles(smi)
    out["nvidia_smi"] = smi
    return out


def tile_kernel_entries(tiles):
    """One entry per tiled kernel, schedule, shape, dtype and tile: one
    call.  ``launches`` counts that kernel at that schedule and tile over
    phase 22's runs of the dtype: ResNet-34's base-flow forwards (fp32, at
    the minimal and the selected tiles), the pinned llama3.2-1b flow (bf16
    prefill, fp32 generate) and its decode at the auto split and pinned to
    ``PINNED_DECODE`` (bf16 teacher-forced steps, fp32 generate)."""
    dec = tiles["tune"]["decode"]
    runs = {"bfloat16": [tiles["tune"]["launches"]["bf16"],
                         *(r["launches"] for r in dec["bf16"].values())],
            "float32": [tiles["tune"]["launches"]["fp32"],
                        *(r["launches"] for r in dec["fp32"].values()),
                        {"conv2d_fused": tiles["resnet34_base"][
                            "minimal"]["conv_tiles"]},
                        {"conv2d_fused": tiles["resnet34_base"][
                            "selected"]["conv_tiles"]}]}
    out = []
    for kname, rows in tiles["cases"].items():
        for r in rows:
            k = f"{kname}[{r['schedule']}]"
            at = f"{r['schedule']}@{r['tile']}"
            # the pinned decode flow is llama3.2-1b's
            n = 0 if kname == "decode_attention" and r["arch"] != LM_ARCH \
                else sum(run.get(kname, {}).get(at, 0)
                         for run in runs[r["dtype"]])
            out += summed_entries(
                {k: [r]}, {r["dtype"]: {k: n}},
                f"@{r['arch']}:{r['shape']}:tile{r['tile']}",
                lambda kn, used: f"one call at {used[0][0]['shape']}",
                lambda kn, c: 1)
    return out


def summed_entries(cases, launches, tag, per, uses):
    """One ``kernels``-line entry per kernel and dtype.  Each case's times
    and bound count ``uses(kernel, case)`` times (0 leaves a case out) and
    are summed; ``per(kernel, [(case, uses), ...])`` names what the sum
    covers; ``launches`` is {dtype: {kernel: count}} from that dtype's
    main-path run.  A kernel with no case of a dtype, or none used, has no
    entry for it.  ``tile`` lists the tiles its cases ran at (the Hopper
    block ``bm x bn``, the base variant's TPU slab tile; None where the
    schedule takes none)."""
    out = []
    for kname, rows in cases.items():
        for dt in ("bfloat16", "float32"):
            rs = [r for r in rows if r["dtype"] == dt]
            used = [(r, uses(kname, r)) for r in rs if uses(kname, r)]
            if not used:
                continue

            def tot(key):
                return sum(r[key] * u for r, u in used)
            by_ops = sum(r["bound_ms"] * u for r, u in used
                         if r["bound_by"] == "operations")
            lib = all(r["library_ms"] is not None for r, _ in used)
            tiles = sorted({_tile_label(r["tile"])
                            if isinstance(r.get("tile"), (list, tuple))
                            else r.get("tile") for r, _ in used} - {None})
            out.append({
                "name": f"{kname}{tag}/{dt}", "route": "cuda",
                "source": KERNEL_SOURCES[kname][0],
                "replaces": KERNEL_SOURCES[kname][1],
                "launches": launches[dt].get(kname, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": tot("ms"), "plain_ms": tot("plain_ms"),
                "bound_ms": tot("bound_ms"),
                "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                             else "bytes"),
                "library_ms": tot("library_ms") if lib else None, "ok": True,
                "tile": "/".join(tiles) or None, "per": per(kname, used)})
    return out


# ---------------------------------------------------------------------------
# phase 23: the stages on captured CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_SEG = 8        # a decode segment's ticks (workload D's fori_seg)
GRAPH_TF = 4         # teacher-forced decode steps held bit for bit


def _graphed(fn, on):
    """``fn()`` on the stages' CUDA graphs, or eagerly (``disable_graphs``)."""
    from repro_torch import flow as tflow
    if on:
        return fn()
    with tflow.disable_graphs():
        return fn()


TURNS = ("eager", "graph", "graph", "eager")


def _turns(fns, what, ways=TURNS):
    """Each way's function (``{"eager": f, "graph": g}``, or one function
    for both) run in the order of ``ways`` (eagerly, on graphs, on graphs
    and eagerly by default), each with the counts set to 0 before it and
    timed on the host clock to a synchronise: ({"eager_ms", "graph_ms"}:
    the least of each way), the graph way's last result, the eager way's.
    Both ways' launch counts must be equal."""
    from repro_torch.kernels import registry
    if callable(fns):
        fns = {"eager": fns, "graph": fns}
    ms = {"eager": [], "graph": []}
    out, counts = {}, {}
    for way in ways:
        reset_counts()
        c0 = registry.snapshot_counts()
        t = time.perf_counter()
        out[way] = _graphed(fns[way], way == "graph")
        torch.cuda.synchronize()
        ms[way].append((time.perf_counter() - t) * 1e3)
        counts[way] = registry.count_delta(c0, registry.snapshot_counts())
    if counts["graph"] != counts["eager"]:
        raise AssertionError(f"{what}: launches on graphs {counts['graph']}"
                             f", eagerly {counts['eager']}")
    return ({f"{w}_ms": min(v) for w, v in ms.items()}, out["graph"],
            out["eager"])


def _measure_turns(cm, stage, params, iters):
    """``cm.measure(stage)`` eagerly, on graphs, on graphs, eagerly: the
    least ms a step of each way (CUDA events, min over ``iters``)."""
    ms = {"eager": [], "graph": []}
    for way in TURNS:
        m = _graphed(lambda: cm.measure(stage, iters=iters, seed=SEED,
                                        params=params), way == "graph")
        ms[way].append(m["measured_step_s"] * 1e3)
    return {f"{w}_ms": min(v) for w, v in ms.items()}


def _busy(fn, ways=("graph", "eager"), iters=5):
    """The device busy share of ``iters`` calls of ``fn`` each way, and
    the seconds each profile took."""
    out = {}
    for way in ways:
        t = time.perf_counter()
        p = _graphed(lambda: _profile(fn, iters), way == "graph")
        out[f"{way}_busy_share"] = p["device_busy_share"]
        out[f"{way}_wall_ms"] = p["wall_ms"] / p["iters"]
        out[f"{way}_profile_s"] = time.perf_counter() - t
    return out


def _clone_state(t):
    return {k: _clone_state(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.clone()


def _admitted(cm, params, prompt):
    """A serving cache with row r of ``prompt``'s prefill admitted into
    slot r (its own block chain, room for 64 more tokens), as the engine
    admits a request; and each row's first sampled token (greedy)."""
    from repro_torch.serving import Engine, EngineConfig
    cache = Engine(cm, params, EngineConfig(
        max_batch=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
        block_size=SERVE_BS)).new_cache()
    y, pst, _ = cm.prefill(params, {"tokens": prompt})
    S = prompt.shape[1]
    for r in range(prompt.shape[0]):
        cache.admit(r, S, S + 64, pst, r, 0)
    return cache, y[:, -1].argmax(-1).to(torch.int32)


def _segment_way(cm, params, prompt):
    """A decode segment runner at temperature 1.0 over its own admitted
    cache (``_admitted``) and generator (seeded alike for every runner):
    each call runs the next ``GRAPH_SEG`` ticks after the last."""
    cache, tok0 = _admitted(cm, params, prompt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    seg = cm.decode_segment(GRAPH_SEG, temperature=1.0)
    at = {"tok": tok0, "pos": torch.full_like(tok0, prompt.shape[1])}

    def run():
        toks, _, _ = seg(params, cache.state, at["tok"], at["pos"], gen)
        at["tok"], at["pos"] = toks[:, -1].contiguous(), at["pos"] + GRAPH_SEG
        return toks
    return run


def _graph_lm(cm, params, prec):
    """llama3.2-1b's decode stage (timed in turns; in bf16 its busy share
    on graphs: an LM step's profile takes seconds, and PR 29's runs
    recorded the eager one) and generate_fori (two graph runs, the first
    of which captures, then an eager one), each on graphs beside its
    eager run; in bf16 also generate (a graph run, then an eager one:
    each call captures anew, a prefill makes a new state) and a sampled
    decode segment (in turns: each way's runner carries its own cache and
    generator, so both ways make the same number of calls).  fp32 leaves
    those two to the engine's runs: the time limit."""
    V = cm.cfg.vocab_size
    t0 = time.perf_counter()
    prompt = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, V, (B, LM_S)).astype(np.int64)).cuda()
    batch = {"tokens": prompt}
    rec = {}
    # teacher-forced decode steps: the graph's logits are the eager ones
    _, st, _ = cm.prefill(params, batch)
    st_e = _clone_state(st)
    toks = prompt[:, :GRAPH_TF + 1]
    for t in range(GRAPH_TF):
        tok = {"tokens": toks[:, t + 1:t + 2]}
        yg = cm.decode(params, tok, st, LM_S + t)[0]
        ye = _graphed(lambda: cm.decode(params, tok, st_e, LM_S + t)[0],
                      False)
        if not torch.equal(yg, ye):
            raise AssertionError(f"{prec} decode step {t}: graph logits "
                                 "differ from the eager step's")
    del st, st_e
    dstate = cm.init_state(B)
    dtok = {"tokens": prompt[:, :1]}
    rec["decode"] = {**_measure_turns(cm, "decode", params, 5),
                     "bitwise_steps": GRAPH_TF}
    if prec == "bf16":
        rec["decode"].update(_busy(lambda: cm.decode(params, dtok, dstate,
                                                     100), ("graph",)))
    del dstate
    rec["decode_s"] = time.perf_counter() - t0
    t, fg, fe = _turns(lambda: cm.generate_fori(params, batch, LM_STEPS),
                       f"{prec} generate_fori", ("graph", "graph", "eager"))
    if not torch.equal(fg, fe):
        raise AssertionError(f"{prec} generate_fori: tokens on graphs "
                             "differ from the eager run's")
    rec["generate_fori"] = {**t, "steps": LM_STEPS}
    if prec == "bf16":
        t, tg, te = _turns(lambda: cm.generate(params, batch,
                                               steps=LM_STEPS)[0],
                           f"{prec} generate", ("graph", "eager"))
        if not (torch.equal(tg, te) and torch.equal(tg, fg)):
            raise AssertionError(f"{prec} generate: tokens on graphs, "
                                 "eagerly and from generate_fori differ")
        rec["generate"] = {**t, "steps": LM_STEPS}
        # three more: the prefill's state is copied into the model's own
        # decode state, so no call captures decode again
        caps = []
        for _ in range(3):
            if not torch.equal(cm.generate(params, batch,
                                           steps=LM_STEPS)[0], tg):
                raise AssertionError(f"{prec} generate: a repeat call's "
                                     "tokens differ")
            caps.append(cm.stage_graphs.stats["captured"])
        if caps[0] != caps[-1]:
            raise AssertionError(f"{prec} generate: captures {caps} over "
                                 "three calls")
        rec["generate"]["captured_after_each"] = caps
        t, sg, se = _turns({"graph": _segment_way(cm, params, prompt),
                            "eager": _segment_way(cm, params, prompt)},
                           f"{prec} sampled segment")
        if not torch.equal(sg, se):
            raise AssertionError(f"{prec} decode_segment at temperature "
                                 "1.0: tokens differ from the host loop's")
        rec["segment_t1"] = {**t, "ticks": GRAPH_SEG}
    rec["seconds"] = time.perf_counter() - t0
    log(json.dumps({"graphs_lm": prec, **rec}))
    return rec


def _graph_engine(cm, ref, params, works):
    """fp32 ``Engine.run`` on workloads A and D on graphs (the bucketed
    prefill batches too: one graph a bucket) and eagerly, the tokens
    identical to each other and to the reference backend's."""
    out = {}
    for name in ("A", "D"):
        wl, kw = SERVE_KNOBS[name]
        runs = {}
        for way in ("eager", "graph"):
            reset_counts()
            eng, rep = _graphed(lambda: _engine_run(cm, params, works[wl],
                                                    trace=True, **kw),
                                way == "graph")
            r = _serve_record(eng, rep)
            runs[way] = (_tokens(rep), read_counts())
            out[f"{name}_{way}"] = {k: r[k] for k in (
                "tokens_per_s", "wall_s", "ms_per_tick",
                "ms_per_segment_tick", "decode_ticks", "fori_segments",
                "host_syncs")}
            if way == "graph":
                buckets = [k[1] for k in cm.stage_graphs._graphs
                           if k[0] == "prefill"]
                if not buckets:
                    raise AssertionError(f"fp32 workload {name}: no "
                                         "prefill graph")
                out[f"{name}_graph"]["prefill_graphs"] = len(buckets)
        if runs["graph"] != runs["eager"]:
            raise AssertionError(f"fp32 workload {name}: tokens or launches "
                                 "on graphs differ from the eager run's")
        if name == "A":
            _, rep_r = _engine_run(ref, params, works[wl], **kw)
            want = _tokens(rep_r)
        if runs["graph"][0] != want:
            raise AssertionError(f"fp32 workload {name}: tokens differ from "
                                 "the reference backend's workload A")
    return out


def _graph_cnn(prec, smi):
    """ResNet-34's opt forward on a graph beside the eager one."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    cm = tflow.compile(get_config("resnet34"),
                       ShapeConfig("serve", "prefill", 64, B),
                       FlowConfig(mode="auto", precision=prec))
    params = cm.init_params(SEED)
    cfg = cm.cfg
    x = torch.from_numpy(np.random.RandomState(SEED).randn(
        B, cfg.image_size, cfg.image_size, cfg.image_channels).astype(
        np.float32)).cuda()
    batch = {"images": x}
    _, yg, ye = _turns(lambda: cm.prefill(params, batch)[0],
                       f"resnet34 {prec} forward")
    if not torch.equal(yg, ye) or not torch.isfinite(yg.float()).all():
        raise AssertionError(f"resnet34 {prec}: graph logits differ from "
                             "the eager forward's")
    rec = {**_measure_turns(cm, "prefill", params, 10),
           **(_busy(lambda: cm.prefill(params, batch)) if prec == "bf16"
              else {}),
           "bitwise": True, "graphs": dict(cm.stage_graphs.stats),
           "nvidia_smi": smi}
    log(json.dumps({"graphs_resnet34": prec, **rec}))
    return rec


def phase_graphs(smi):
    """Phase 23: the decode stage, generate_fori, decode_segment and the
    CNN forward replayed from captured CUDA graphs, each beside its eager
    run under ``disable_graphs()`` in the same call: llama3.2-1b at full
    width and depth in bf16 and fp32 (the bf16 draw widened), ResNet-34's
    opt forward in bf16 and fp32."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    shape = ShapeConfig("serve", "decode", SERVE_SEQ, SERVE_SLOTS)
    rec = {"arch": LM_ARCH, "nvidia_smi": smi}
    params = None
    for prec in ("bf16", "fp32"):
        fl = FlowConfig(mode="folded", precision=prec)
        cm = tflow.compile(LM_ARCH, shape, fl)
        t0 = time.perf_counter()
        params = cm.init_params(SEED) if params is None \
            else _widened(params)
        torch.cuda.synchronize()
        rec[f"params_{prec}_s"] = time.perf_counter() - t0
        rec[prec] = _graph_lm(cm, params, prec)
        if prec == "fp32":
            t0 = time.perf_counter()
            ref = tflow.compile(LM_ARCH, shape, fl, backend="reference")
            rec["engine_fp32"] = _graph_engine(
                cm, ref, params, _serve_workloads(cm.cfg.vocab_size))
            rec["engine_fp32_s"] = time.perf_counter() - t0
            log(json.dumps({"graphs_engine": rec["engine_fp32"]}))
        rec[f"graphs_{prec}"] = dict(cm.stage_graphs.stats)
        del cm
    del params
    t0 = time.perf_counter()
    rec["resnet34"] = {prec: _graph_cnn(prec, smi)
                       for prec in ("bf16", "fp32")}
    rec["resnet34_s"] = time.perf_counter() - t0
    log(json.dumps({"graphs": {k: rec[k] for k in rec if k.startswith(
        ("graphs_", "params_")) or k.endswith("_s")}}))
    return rec


# ---------------------------------------------------------------------------
# phase 24: the prefill's trace, and the train step of the other families
# ---------------------------------------------------------------------------

TRACE_DIR = os.path.join(ROOT, "build", "measure_trace")
TRACE_ITERS = 5
TRACE_KERNELS = {"matmul_fused": "matmul_wgmma_kernel",
                 "flash_attention": "flash_wgmma_kernel"}
# each run: (arch, layers kept (None: all), sequence length, the kernels
# its forward launches, the layers of its card-against-CPU step); whisper's
# 448 is its n_text_ctx
FAMILY_TRAIN = (
    ("recurrentgemma-2b", 3, 512,
     ("matmul_fused", "flash_attention", "lru_scan"), 3),
    ("deepseek-moe-16b", 2, 512, ("matmul_fused", "flash_attention"), 2),
    ("whisper-small", None, 448, ("matmul_fused", "flash_attention"), 2),
)
FAMILY_TRAIN_STEPS = 6
FAMILY_CPU_S, FAMILY_CPU_B = 256, 2
FAMILY_CPU_TOL = 1e-4


def _trace_summary(path, iters):
    """The Chrome trace ``measure(trace_dir=)`` wrote: the device kernels by
    name (launches and ms a call), the device busy share (the kernels'
    summed time over the ``measure.step`` spans' summed time: one stream,
    so kernels do not overlap) and the host's split, each event's self
    time (its time less its children's on its thread) summed by name over
    the CPU ops, the CUDA runtime and driver calls and the ``measure.step``
    span itself (the Python between the ops), in ms a call."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "measure.step" and
             e.get("cat") == "user_annotation"]
    if len(steps) != iters:
        raise AssertionError(f"trace {path}: {len(steps)} measure.step "
                             f"spans, want {iters}")
    window_us = sum(e["dur"] for e in steps)
    kern = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, us = kern.get(e["name"], (0, 0.0))
            kern[e["name"]] = (n + 1, us + e["dur"])
    busy_us = sum(us for _, us in kern.values())
    host, threads = {}, {}
    for e in events:
        if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                            "user_annotation") and "dur" in e:
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    def pop(stack):
        end, name, child, dur = stack.pop()
        host[name] = host.get(name, 0.0) + dur - child
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                pop(stack)
            if stack:
                stack[-1][2] += e["dur"]
            stack.append([e["ts"] + e["dur"], e["name"], 0.0, e["dur"]])
        while stack:
            pop(stack)
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])
    # the named kernels inside each call's span on the device's timeline
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "measure.step" and
                   e.get("cat") == "gpu_user_annotation")
    per_call = [{name: sum(1 for e in events if e.get("cat") == "kernel"
                           and name in e["name"] and t0 <= e["ts"] <= t1)
                 for name in TRACE_KERNELS.values()} for t0, t1 in spans]
    return {"iters": iters, "bytes": os.path.getsize(path),
            "window_ms_per_call": window_us / 1e3 / iters,
            "device_busy_ms_per_call": busy_us / 1e3 / iters,
            "device_busy_share": busy_us / window_us,
            "kernel_launches_per_call": sum(n for n, _ in kern.values())
            / iters,
            "kernels": [{"kernel": k[:80], "launches_per_call": n / iters,
                         "ms_per_call": us / 1e3 / iters}
                        for k, (n, us) in top[:8]],
            "host_self": [{"op": k[:60], "ms_per_call": us / 1e3 / iters}
                          for k, us in sorted(host.items(),
                                              key=lambda kv: -kv[1])[:10]],
            "named": {name: sum(n for k, (n, _) in kern.items()
                                if name in k)
                      for name in TRACE_KERNELS.values()},
            "named_per_call": per_call}


def _prefill_trace(smi):
    """``measure("prefill", trace_dir=)`` of full-width llama3.2-1b's bf16
    prefill (8 x 512 tokens), between two plain ``measure`` calls (the
    profiler's cost): the trace names matmul_fused's and flash_attention's
    ``wgmma`` kernels, and the counters put every launch the plan says on
    ``wgmma``.  The trace's own counts are recorded beside the counters':
    the profiler can miss a kernel record (3 of 480 in one run), so the
    counters hold the launches."""
    import shutil
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    cm = tflow.compile(LM_ARCH, ShapeConfig("serve", "prefill", LM_S, B),
                       FlowConfig(mode="folded"))
    params = cm.init_params(SEED)
    want = _plan_launches(cm.plan, "prefill")
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    plain = [cm.measure("prefill", iters=TRACE_ITERS, seed=SEED,
                        params=params)]
    reset_counts()
    m = cm.measure("prefill", iters=TRACE_ITERS, seed=SEED, params=params,
                   trace_dir=TRACE_DIR)
    counted = {k: read_schedules(k) for k in TRACE_KERNELS}
    plain.append(cm.measure("prefill", iters=TRACE_ITERS, seed=SEED,
                            params=params))
    if m["trace"] != os.path.join(TRACE_DIR, "measure_prefill.json"):
        raise AssertionError(f"trace at {m['trace']}")
    for k in TRACE_KERNELS:
        n = (TRACE_ITERS + 1) * want[k]             # the warm-up's too
        if {s: c for s, c in counted[k].items() if c} != {"wgmma": n}:
            raise AssertionError(f"traced prefill: {k} by schedule "
                                 f"{counted[k]}, want {n} on wgmma")
    rec = _trace_summary(m["trace"], TRACE_ITERS)
    for name in TRACE_KERNELS.values():
        if not rec["named"][name]:
            raise AssertionError(f"the trace does not name {name}: "
                                 f"{rec['kernels']}")
    rec.update({"arch": LM_ARCH, "shape": [B, LM_S], "nvidia_smi": smi,
                "traced_ms": m["measured_step_s"] * 1e3,
                "traced_mean_ms": m["mean_step_s"] * 1e3,
                "plain_ms": [r["measured_step_s"] * 1e3 for r in plain],
                "plain_mean_ms": [r["mean_step_s"] * 1e3 for r in plain],
                "want_per_call": {k: want[k] for k in TRACE_KERNELS},
                "counted": {k: TRACE_ITERS * want[k] for k in TRACE_KERNELS}})
    del params
    torch.cuda.empty_cache()
    return rec


def _family_batch(cfg, S, b):
    """One fixed SyntheticLM batch (step 0) of ``b`` x ``S`` on the card;
    for an encoder-decoder also ``randn(b, encoder_seq, d_model)`` fp32
    frames from ``RandomState(SEED)``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                 global_batch=b)).get(0)
    if cfg.n_encoder_layers:
        raw["frames"] = np.random.RandomState(SEED).randn(
            b, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return _device_batch(raw)


def _family_card_vs_cpu(cfg, layers, kernels):
    """One step's loss and gradients of ``cfg`` cut to ``layers`` (an
    encoder-decoder: that many of each) at full width, fp32, on a 2 x 256
    SyntheticLM batch: on the card (the forward on the hand kernels' fp32
    schedules) and through the reference backend on the host's CPU, from
    the same tree.  A MoE model's CPU step takes the card's routing, call
    by call (``_routed`` / ``_forced``): at random weights the router's top
    k is a near-tie, so a last-bit difference may pick another expert.
    Limits: the loss and every gradient leaf relerr < 1e-4."""
    from repro_torch import flow as tflow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.trainer import _grads
    cut = {"n_layers": layers}
    if cfg.n_encoder_layers:
        cut["n_encoder_layers"] = layers
    c = dataclasses.replace(cfg, **cut)
    shape = ShapeConfig("train", "train", FAMILY_CPU_S, FAMILY_CPU_B)
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm_g = tflow.compile(c, shape, f32)
    cm_c = tflow.compile(c, shape, f32, device="cpu")
    p_g = cm_g.init_params(SEED)
    p_c = tree_map(lambda t: t.cpu(), p_g)
    b_g = _family_batch(c, FAMILY_CPU_S, FAMILY_CPU_B)
    b_c = {k: v.cpu() for k, v in b_g.items()}
    moe = c.moe is not None
    reset_counts()
    t0 = time.perf_counter()
    on_card = lambda: _grads(cm_g.loss_fn, p_g, b_g)         # noqa: E731
    if moe:
        (lg, mg, gg), calls = _routed(on_card)
    else:
        lg, mg, gg = on_card()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    sched = {k: {s: n for s, n in read_schedules(k).items() if n}
             for k in kernels}
    if set(launches) != set(kernels) or any("simt" in v
                                            for v in sched.values()):
        raise AssertionError(f"{c.name} card against CPU: launches "
                             f"{launches}, {sched}")
    t0 = time.perf_counter()
    on_cpu = lambda: _grads(cm_c.loss_fn, p_c, b_c)          # noqa: E731
    if moe:
        lc, mc, gc = _forced(on_cpu, [(i.cpu(), v.cpu()) for i, v in calls])
    else:
        lc, mc, gc = on_cpu()
    cpu_s = time.perf_counter() - t0
    errs = {f"{t}/{k}": relerr(gg[t][k].cpu(), gc[t][k])
            for t in gc for k in gc[t]}
    worst = max(errs, key=errs.get)
    rec = {"layers": layers, "tokens": FAMILY_CPU_S * FAMILY_CPU_B,
           "loss_card": float(lg), "loss_cpu": float(lc),
           "loss_relerr": abs(float(lg) - float(lc)) / abs(float(lc)),
           "grad_relerr_max": errs[worst], "grad_worst_leaf": worst,
           "n_leaves": len(errs), "launches": launches, "schedules": sched,
           "card_s": card_s, "cpu_s": cpu_s}
    if moe:
        rec["moe_aux_relerr"] = abs(float(mg["moe_aux"]) - float(
            mc["moe_aux"])) / abs(float(mc["moe_aux"]))
        rec["routing_calls"] = len(calls)
    if not rec["loss_relerr"] < FAMILY_CPU_TOL or \
            not rec["grad_relerr_max"] < FAMILY_CPU_TOL:
        raise AssertionError(f"{c.name} card against CPU: {rec}")
    del cm_g, p_g, gg, b_g
    torch.cuda.empty_cache()
    return rec


def _family_train(arch, layers, S, kernels, cpu_layers, smi):
    """``FAMILY_TRAIN_STEPS`` AdamW steps of ``arch`` at full width (cut to
    ``layers``) on one fixed batch, bf16 compute, fp32 masters, block
    remat: the loss at the last step below the first; the forward's
    launches by schedule as the plan says (a folded unit's twice a step:
    the remat's recompute), every product and flash call on ``wgmma``,
    every lru_scan on ``chunked``, none on simt, no dispatch rejection; the
    flash calls by ``causal`` and window (an encoder's non-causal, a
    windowed model's at its window); a MoE model's aux loss each step and
    the picks its capacity dropped (a MoE layer counted at each call: twice
    a step where the remat recomputes it); then the card against the CPU
    (:func:`_family_card_vs_cpu`)."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.core import ops_impl
    from repro_torch.optim.adamw import AdamW, tree_leaves
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cm = tflow.compile(cfg, ShapeConfig("train", "train", S, B),
                       FlowConfig(mode="folded"))
    ops = ("attention", "matmul", "glu_matmul") + (
        ("rg_lru",) if "lru_scan" in kernels else ())
    if any(cm.plan.kernels.get(o) != "cuda" for o in ops) or \
            cm.flow.remat != "block":
        raise AssertionError(f"{arch} train plan: kernels "
                             f"{cm.plan.kernels}, remat {cm.flow.remat}")
    t0 = time.perf_counter()
    params = cm.init_params(SEED)                     # fp32 masters
    torch.cuda.synchronize()
    rec = {"arch": arch, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers, "shape": [B, S],
           "init_params_s": time.perf_counter() - t0, "nvidia_smi": smi,
           "n_params": sum(t.numel() for t in tree_leaves(params)),
           "kernels_line": cm.describe().splitlines()[-1].strip()}
    batch = _family_batch(cfg, S, B)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=FAMILY_TRAIN_STEPS)
    drops = _Drops() if cfg.moe is not None else None
    ops_impl.ROUTING_HOOK = drops
    try:
        with tflow.disable_graphs():    # the hook runs in Python: eager
            (losses, ms, state, kern, peak), flash = _flash_by_causal(
                lambda: _train_run(cm, opt, params, batch,
                                   FAMILY_TRAIN_STEPS, f"{arch} train",
                                   kernels))
    finally:
        ops_impl.ROUTING_HOOK = None
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: losses {losses} did not fall")
    fwd = _plan_launches(cm.plan, "train")
    n = FAMILY_TRAIN_STEPS
    want = {"matmul_fused": {"wgmma": n * fwd["matmul_fused"]},
            "flash_attention": {"wgmma": n * fwd["flash_attention"]}}
    if "lru_scan" in kernels:
        want["lru_scan"] = {"chunked": n * fwd["lru_scan"]}
    if kern["schedules"] != want:
        raise AssertionError(f"{arch} train: launches by schedule "
                             f"{kern['schedules']}, want {want}")
    n_fl = n * fwd["flash_attention"]
    enc = 2 * n * cfg.n_encoder_layers
    w = cfg.attention.window
    want_fl = {"causal": 0 if w else n_fl - enc, "noncausal": enc}
    if w:
        want_fl[f"causal@{w}"] = n_fl - enc
    if flash != want_fl:
        raise AssertionError(f"{arch} train: flash calls {flash}, want "
                             f"{want_fl}")
    rec.update({"losses": losses, "host_ms_per_step": ms, "kernels": kern,
                "flash_calls": flash, "peak_bytes_train": peak,
                "train_s": sum(ms) / 1e3})
    if drops is not None:
        if not kern.get("moe_aux") or not all(
                np.isfinite(a) and a > 0 for a in kern["moe_aux"]):
            raise AssertionError(f"{arch}: aux losses {kern.get('moe_aux')}")
        rec["capacity_factor"] = cfg.moe.capacity_factor
        rec["capacity_drops"] = drops.read()
    del state, params, batch
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = _family_card_vs_cpu(cfg, cpu_layers, kernels)
    rec["seconds"] = time.perf_counter() - t_start
    log(json.dumps({"family_train": {
        k: rec[k] for k in ("arch", "layers", "losses", "flash_calls",
                            "peak_bytes_train", "seconds")},
        "launches": kern["launches"], "card_vs_cpu": {
            k: rec["card_vs_cpu"][k] for k in (
                "layers", "loss_relerr", "grad_relerr_max",
                "grad_worst_leaf", "card_s", "cpu_s")}}))
    torch.cuda.empty_cache()
    return rec


def phase_family_train(smi):
    """Phase 24: ``measure("prefill", trace_dir=)`` on full-width llama3.2-1b,
    then the train step of the recurrent, MoE and encoder-decoder
    families on the card (``FAMILY_TRAIN``)."""
    out = {"prefill_trace": _prefill_trace(smi)}
    log(json.dumps({"prefill_trace": {k: v for k, v in
                                      out["prefill_trace"].items()
                                      if k != "nvidia_smi"}}))
    for arch, layers, S, kernels, cpu_layers in FAMILY_TRAIN:
        out[arch] = _family_train(arch, layers, S, kernels, cpu_layers, smi)
    return out


# ---------------------------------------------------------------------------
# phase 25: the LM prefill and the train step on captured CUDA graphs
# ---------------------------------------------------------------------------

# each prefill run (8 x 512 tokens): (arch, layers kept (None: all), the
# precisions); the depths of the path phases 10 and 19
GRAPH_PREFILLS = ((LM_ARCH, None, ("bf16", "fp32")),
                  (RG_ARCH, RG_DEPTH, ("bf16",)),
                  (RWKV_ARCH, RWKV_DEPTH, ("bf16",)))
# each train run (8 rows): (arch, layers kept (None: all), sequence length
# (None: a CNN's images)); phases 14 and 24's cuts
GRAPH_TRAINS = ((LM_ARCH, TRAIN_DEPTH, TRAIN_S), ("resnet34", None, None),
                (RG_ARCH, 3, 512), ("deepseek-moe-16b", 2, 512),
                (WH_ARCH, None, 448))
GRAPH_TRAIN_STEPS = 3
GRAPH_ITERS = 5
LRU_GRAPH_SHAPE = (B, LM_S, 2560)      # recurrentgemma-2b's prefill scan


def _same_tree(a, b) -> bool:
    from repro_torch.optim.adamw import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _tree_gap(a, b) -> float:
    """Max over leaves of relerr, computed on the card, one read-back."""
    from repro_torch.optim.adamw import tree_leaves
    gaps = [((x.float() - y.float()).abs().max() /
             (y.float().abs().max() + 1e-9))
            for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.stack(gaps).max().item()


def _graph_prefill(arch, layers, precs, smi):
    """``prefill`` of ``arch`` at full width (cut to ``layers``) on 8 x 512
    tokens, on its graph beside the eager one in each precision: logits
    and every state tensor bit for bit, launches by schedule equal (in
    turns: eager, graph, graph, eager), ms a call by CUDA events
    (``measure``, in turns), each way's busy share, the pool's bytes; a
    second graph call leaves the first one's state as it was."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rec = {"arch": arch, "layers": cfg.n_layers, "shape": [B, LM_S],
           "nvidia_smi": smi}
    params = None
    for prec in precs:
        cm = tflow.compile(cfg, ShapeConfig("serve", "prefill", LM_S, B),
                           FlowConfig(mode="folded", precision=prec))
        params = cm.init_params(SEED) if params is None \
            else _widen(params)
        batch = cm._measure_inputs(SEED)
        what = f"{arch} {prec} prefill"
        t, (yg, sg), (ye, se) = _turns(
            lambda: cm.prefill(params, batch)[:2], what)
        launches = {k: v for k, v in read_counts().items() if v}
        if not (torch.equal(yg, ye) and _same_tree(sg, se)):
            raise AssertionError(f"{what}: graph logits or state differ "
                                 "from the eager prefill's")
        keep = _clone_state(sg)
        other = {**batch, "tokens": batch["tokens"].flip(0)}
        _graphed(lambda: cm.prefill(params, other), True)
        if not _same_tree(sg, keep):
            raise AssertionError(f"{what}: a second prefill moved the "
                                 "first one's state")
        del keep, se, ye
        r = {**t, **_measure_turns(cm, "prefill", params, GRAPH_ITERS),
             **_busy(lambda: cm.prefill(params, batch), iters=3),
             "launches": launches, "bitwise": True,
             "graphs": dict(cm.stage_graphs.stats)}
        if arch == RG_ARCH:
            r["lru_scan_in_graph"] = _profile(
                lambda: cm.prefill(params, batch), GRAPH_ITERS,
                named="lru_scan")["named"]
        rec[prec] = r
        log(json.dumps({"graph_prefill": arch, "prec": prec, **{
            k: v for k, v in r.items() if k != "graphs"},
            "pool_bytes": r["graphs"]["pool_bytes"]}))
        del cm, yg, sg
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def _graph_train(arch, layers, S, smi):
    """``GRAPH_TRAIN_STEPS`` AdamW steps of ``arch`` at full width (cut to
    ``layers``) from one init and one batch, bf16 compute with fp32
    masters: eagerly, on the step's graph (a warm-up, then replays),
    eagerly again.  Launches by schedule equal; the losses and every
    parameter bit for bit where the two eager runs are, else the graph's
    within twice their gap; ms a step (host clock to the loss's read-back),
    peak bytes, the pool's bytes."""
    from repro_torch import flow as tflow
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.kernels import registry
    from repro_torch.optim.adamw import AdamW, tree_map
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cut = {"n_layers": layers}
        if cfg.n_encoder_layers:
            cut["n_encoder_layers"] = layers
        cfg = dataclasses.replace(cfg, **cut)
    cnn = cfg.family == "cnn"
    cm = tflow.compile(cfg, ShapeConfig("train", "train", 64 if cnn else S,
                                        B), FlowConfig(mode="folded"))
    p0 = cm.init_params(SEED)
    if cnn:
        batch = _device_batch(SyntheticImages(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=0, global_batch=B),
            cfg.image_size, cfg.image_channels, cfg.vocab_size).get(0))
    else:
        batch = _family_batch(cfg, S, B)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=GRAPH_TRAIN_STEPS)
    step = cm.train_step(opt)
    rec = {"arch": arch, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers,
           "shape": [B, cfg.image_size if cnn else S], "nvidia_smi": smi}
    runs, first = {}, None
    for way in ("eager", "graph", "eager2"):
        params = tree_map(torch.clone, p0)
        st = opt.init(params)
        reset_counts()
        c0 = registry.snapshot_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, aux = [], [], []
        for _ in range(GRAPH_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, st, m = _graphed(lambda: step(params, st, batch),
                                     way == "graph")
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if "moe_aux" in m:
                aux.append(float(m["moe_aux"]))
        run = {"losses": losses, "ms": ms, "moe_aux": aux,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "counts": registry.count_delta(c0,
                                              registry.snapshot_counts())}
        if first is None:
            first = params
        else:
            run["bitwise"] = _same_tree(params, first)
            run["param_gap"] = 0.0 if run["bitwise"] \
                else _tree_gap(params, first)
            del params
        runs[way] = run
        del st
        torch.cuda.empty_cache()
    rec["pool_bytes"] = cm.stage_graphs.stats["pool_bytes"]
    rec["graphs"] = dict(cm.stage_graphs.stats)
    del first, cm, p0, step
    torch.cuda.empty_cache()
    e, g, e2 = runs["eager"], runs["graph"], runs["eager2"]
    for way in ("graph", "eager2"):
        if runs[way]["counts"] != e["counts"]:
            raise AssertionError(f"{arch} train: launches {way} "
                                 f"{runs[way]['counts']}, eagerly "
                                 f"{e['counts']}")
    eager_alike = e2["bitwise"] and e2["losses"] == e["losses"] and \
        e2["moe_aux"] == e["moe_aux"]
    if eager_alike:
        rec["rule"] = "bit for bit (two eager runs are)"
        if not (g["bitwise"] and g["losses"] == e["losses"]
                and g["moe_aux"] == e["moe_aux"]):
            raise AssertionError(f"{arch} train: graph losses {g['losses']}"
                                 f" against eager {e['losses']}, params "
                                 f"gap {g['param_gap']}")
    else:
        rec["rule"] = "within twice the eager-against-eager gap"
        lgap = max(abs(a - b) for a, b in zip(e2["losses"], e["losses"]))
        if g["param_gap"] > 2 * e2["param_gap"] or max(
                abs(a - b) for a, b in zip(g["losses"], e["losses"])) > \
                2 * lgap:
            raise AssertionError(f"{arch} train: graph {g}, eager {e}, "
                                 f"eager again {e2}")
    if not all(np.isfinite(g["losses"])):
        raise AssertionError(f"{arch} train: losses {g['losses']}")
    launches = {k[0]: v for k, v in e["counts"].items()
                if k[1] == "launches" and v}
    rec.update({
        "launches_per_run": launches,
        "losses": {w: r["losses"] for w, r in runs.items()},
        "moe_aux": g["moe_aux"] or None,
        "ms": {w: r["ms"] for w, r in runs.items()},
        "eager_ms": min(e["ms"] + e2["ms"]),
        "graph_ms": min(g["ms"][1:]),
        "graph_first_ms": g["ms"][0],
        "peak_bytes": {w: r["peak_bytes"] for w, r in runs.items()},
        "param_gap": {w: runs[w]["param_gap"] for w in ("graph", "eager2")},
        "seconds": time.perf_counter() - t_start})
    log(json.dumps({"graph_train": arch, **{
        k: rec[k] for k in ("layers", "rule", "eager_ms", "graph_ms",
                            "graph_first_ms", "pool_bytes", "param_gap",
                            "peak_bytes", "seconds")},
        "losses": rec["losses"]["graph"]}))
    return rec


def phase_graph_stages(smi):
    """Phase 25: the LM prefill (``GRAPH_PREFILLS``) and the train step
    (``GRAPH_TRAINS``) on their captured graphs, each beside its eager run
    under ``disable_graphs()`` in the same call; then lru_scan at
    recurrentgemma-2b's prefill shape by CUDA graph, allocated per call
    and into one buffer, beside its time inside the prefill's graph."""
    out = {"prefill": {}, "train": {}}
    for arch, layers, precs in GRAPH_PREFILLS:
        out["prefill"][arch] = _graph_prefill(arch, layers, precs, smi)
    for arch, layers, S in GRAPH_TRAINS:
        out["train"][arch] = _graph_train(arch, layers, S, smi)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    c = _lru_case(LRU_GRAPH_SHAPE, torch.float32, gen)
    inside = out["prefill"][RG_ARCH]["bf16"]["lru_scan_in_graph"]
    out["lru_scan"] = {
        "shape": list(LRU_GRAPH_SHAPE), "allocated_ms": c["ms"],
        "one_buffer_ms": c["direct_ms"],
        "in_prefill_graph_ms": inside["ms_per_call"] /
        max(inside["launches_per_call"], 1),
        "launches_per_prefill": inside["launches_per_call"],
        "nvidia_smi": smi}
    log(json.dumps({"graph_lru_scan": out["lru_scan"]}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    walls = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        walls[phase.__name__] = time.perf_counter() - t
        log(f"{phase.__name__}: {walls[phase.__name__]:.1f}s")
        return out
    name, smi = timed(phase_device)
    build = timed(phase_build)
    cases = timed(phase_kernels)
    lm_cases, rg_mm_cases = timed(phase_lm_kernels)
    base_cases = timed(phase_base_kernels)
    serve_cases = timed(phase_serving_kernels)
    path = timed(phase_path, smi)
    lm = timed(phase_lm_path, smi)
    serve = timed(phase_serving, smi)
    rec_cases = timed(phase_rec_kernels)
    rg = timed(phase_rec_path, smi)
    lru_cases = timed(phase_lru_kernels, rg)
    dense_cases = timed(phase_dense_kernels)
    dense = timed(phase_dense_path, smi)
    train = timed(phase_train, smi)
    tune = timed(phase_tune, smi)
    moe_cases = timed(phase_moe_kernels)
    new = timed(phase_moe_path, smi)
    fam_cases = timed(phase_family_kernels)
    fam = timed(phase_family_path, smi)
    mesh = timed(phase_mesh, smi)
    serve_mesh = timed(phase_serve_mesh, smi)
    tiles = timed(phase_tiles, smi, path)
    graphs = timed(phase_graphs, smi)
    fam_train = timed(phase_family_train, smi)
    graph_stages = timed(phase_graph_stages, smi)
    entries = kernel_entries(cases, path) + \
        mobilenet_kernel_entries(cases, path) + \
        lenet_kernel_entries(cases, path) + \
        lm_kernel_entries(lm_cases, lm) + \
        base_kernel_entries(base_cases, lm) + \
        serving_kernel_entries(serve_cases, serve) + \
        rec_kernel_entries({**rec_cases, "matmul_fused": rg_mm_cases}, rg) + \
        lru_kernel_entries(lru_cases) + \
        dense_kernel_entries(dense_cases, dense) + \
        new_kernel_entries(moe_cases, new) + \
        family_kernel_entries(fam_cases, fam) + \
        mesh_kernel_entries(cases, lm_cases, mesh) + \
        serve_mesh_kernel_entries(lm_cases, serve_cases, serve_mesh) + \
        tile_kernel_entries(tiles)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "build": build,
                   "kernels": cases, "lm_kernels": lm_cases,
                   "rec_matmul_kernels": rg_mm_cases,
                   "base_kernels": base_cases,
                   "serving_kernels": serve_cases, "path": path,
                   "lm_path": lm, "serving": serve,
                   "rec_kernels": rec_cases, "rec_path": rg,
                   "lru_kernels": lru_cases,
                   "dense_kernels": dense_cases, "dense_path": dense,
                   "train": train, "tune": tune,
                   "moe_kernels": moe_cases, "moe_path": new,
                   "family_kernels": fam_cases, "family_path": fam,
                   "mesh": mesh, "serve_mesh": serve_mesh, "tiles": tiles,
                   "graphs": graphs, "family_train": fam_train,
                   "graph_stages": graph_stages,
                   "entries": entries, "phase_seconds": walls,
                   "seconds": time.perf_counter() - t0}, f, indent=1)
    log(f"total: {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
