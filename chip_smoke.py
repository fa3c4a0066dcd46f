#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that the
port starts on the GPU and goes through its own kernels.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py                          # phases 1-17
    python3 chip_smoke.py --qwen-jit-layers 48     # phase 12's qwen2.5-14b jit step at full depth

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, then the five
   CUDA kernels built with nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc`` (the Hopper primitives of
   ``hopper.cuh`` included), one nvcc per source, all started together;
   ptxas's registers and spills per kernel.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (fused linear at M = 1 to 4096 rows and
   recurrentgemma-2b's and xlstm-350m's widths; the RG-LRU scan at the
   served prefill and forward shapes and a ragged one, a in U(0.3,
   0.999); RMSNorm at xlstm-350m's widths (rows x d: 4 x 1024, 128 x
   1024, 512 x 512, 2048 x 1024) and a ragged d; f32: rtol 2e-4, atol 2e-5; bf16: 3e-2,
   the JAX package's kernel tolerances; bf16 flash attention also within
   a bound from bf16 rounding, on inputs whose softmax is peaky;
   whole-model bf16 logits 6e-2), with its time, the plain version's
   time, one PyTorch library call's time and the card's bound.  The
   fused-linear plans of every served shape take ``gemv`` (M <= 16) or
   ``wgmma`` in bf16, with the shared memory the entry point uses; flash
   also at one query row and at more query rows than keys (rows that see
   no key write 0), and at every head dim the kernels are built for (16,
   32, 64, 96, 112, 128, 256) in f32 and bf16, with the variant each
   takes and its shared memory; flash bf16 D=128 with GQA timed.  The
   RG-LRU scan also at forced chunk lengths (1, 7, 64 steps); chained
   ``rg_lru_scan`` calls equal one scan bitwise where every call's plan
   is one chunk, else within the f32 tolerance of one scan and of the
   plain version; two calls of each redesigned kernel bitwise equal; the
   multi-chunk scan (B4 x T128, and 43 forced chunks) captured in a CUDA
   graph and replayed on new inputs, each replay within the f32
   tolerance of the plain version and bitwise equal to an eager launch.
3. Serve forge-125m at full width (12 layers, d 768, vocab 50257, bf16,
   random weights from seed 0) with the serve CLI's defaults through
   ``BatchedServer(mode="interpret")``: Forge-compiled block bodies, 36
   fused-linear launches per decode step; the prefilled caches and the
   first generated step's logits and greedy tokens against the same
   server with ``impl="ref"``; a second generation's greedy tokens
   bitwise equal to the first's.
4. The full-sequence forward ``apply`` at B=4, S=1024: 12 flash-attention
   and 36 fused-linear launches, logits against the plain path; the
   device time of one call, in all and for the two kernels.
5. Paged continuous batching at full width: ``SlotScheduler`` over
   ``BatchedServer(mode="forge", paged=True)`` with the paged-attention
   kernel (``kv_kernel="pallas"``), 12 requests with a shared prefix; the
   whole decode step and prefill are Phase 1-4 programs per bucket, on
   the ``segment_jit`` backend (each device-affine segment one CUDA
   graph; warmup captures every program, nothing is captured after it).
   Launches: paged attention = 12 x decode dispatches, fused linear = the
   programs' linear nodes x their dispatches, flash 0; no compile after
   warmup; the pool accounting clean; two served prefill programs
   (M = 32 and 256 fused-linear rows; cold, prefix-hit and masked rows)
   and one decode tick against ``impl="ref"``, each on its own copy of
   the page store; tok/s, tick p50/p99, TTFT, compile seconds per
   program.  One decode and one prefill dispatch under ``segment_jit``
   bitwise equal to the same lowered programs under ``interpret``; the
   host/device split of steady decode ticks under both backends.
6. recurrentgemma-2b at full width, depth cut to 3 of its 26 layers (2
   RG-LRU blocks and 1 local-attention block, d 2560, vocab 256000, bf16,
   random weights from seed 0) through the contiguous forge fronts,
   ``BatchedServer(mode="forge")`` on ``segment_jit`` (batch rungs 2 and
   4, one S32 grid cell): warmup of the B2/B4 decode programs and the
   B4 x S32 prefill cell, then batch 4, prompt 32, 32 new tokens with
   the chunked state-scan prefill (one dispatch: 2 RG-LRU launches) and
   again with ``prefill="sequential"`` on the same decode program (no
   RG-LRU launch); the contiguous ``SlotScheduler`` over phase 7's 8
   requests (max_slots 4: swap-ins and rung resizes; every admission
   wave through the slot-masked chunked prefill grid, the admitted rows
   reset while the others keep their state): every request ends with its
   budget, no compile, launches exact (2 RG-LRU launches a prefill
   dispatch), the dispatch counts the fronts', and the same schedule on
   the interpret twins bitwise equal; the full-sequence ``apply`` at B=2, S=1024 through
   the Forge bodies (2 launches) and its device time.  Launch counts
   exact, no compile after warmup; a continuation prefill (pos 32, ragged lengths) on copies of
   a served cache and ``apply`` against ``impl="ref"`` (relative L2
   within 0.1: elementwise bf16 bounds do not hold at depth, see
   TOL_DEEP_F32), beside the spread of two kernel-free implementations;
   greedy tokens against an ``impl="ref"`` generation (rows equal
   reported); TTFT both ways, decode p50/p99, tok/s and the device busy
   share of steady decode steps under both backends.  Then the same
   prefill program and ``apply`` in f32 against ``impl="ref"``,
   elementwise within rtol 1e-3 / atol 1e-3.  Before it, phase 10's (a)
   and (b) contract on these fronts (``async_front``): rungs 2 and 4 and
   one S16 cell, only rung 4 warm, phase 10's async workload on 4 slots
   with two compile workers and a cache directory: at least one warm
   fallback, at most 5 ms of compile wait, the service idle, the same
   workload again on the exact rungs with no fallback; every memory tier
   dropped, an inline server on the same directory warms every program
   the async one built with zero full builds and serves the workload,
   each async run's tokens equal to its, or held at the first differing
   token by the measured-slack rule; the async run's RG-LRU launches
   above 0.
7. xlstm-350m at full width, depth cut to 8 of its 24 layers (7 mLSTM
   and 1 sLSTM, d 1024, 4 heads, vocab 50304, bf16, random weights from
   seed 0) through the contiguous forge fronts (batch rungs 2 and 4, one S32
   grid cell): warmup of the B2/B4 decode programs and the B4 prefill cell,
   batch 4, prompt 32, 32 new tokens with the chunked prefill and with
   ``prefill="sequential"``, then the contiguous ``SlotScheduler`` over 8
   requests with ragged prompts (max_slots 4: swap-ins and rung resizes),
   then ``apply`` at B=2, S=1024.  Launches exact: fused linear = the
   programs' linear nodes x their dispatches, every other kernel 0 (the
   norms are plain, as in the JAX package); no compile after warmup.
   The prefill program and ``apply`` against ``impl="ref"`` in bf16
   (relative L2 within twice the spread of two kernel-free
   implementations, SPREAD_FACTOR_BF16) and in f32 (elementwise, rtol
   1e-3 / atol 1e-3); TTFT both ways, decode p50/p99, tok/s, the
   scheduler's tok/s, compile seconds per program and the device busy
   share of steady decode steps under both backends.
8. forge-125m at full width through the contiguous forge fronts on
   ``segment_jit`` (batch rungs 2 and 4; B4 cells S16, S32, S64): batch 4,
   prompt 32, 32 new tokens with the batched prefill and with
   ``prefill="sequential"``, then the contiguous ``SlotScheduler``
   (max_slots 4) over phase 5's 12 requests.  Launches exact (fused
   linear = the programs' linear nodes x their dispatches, nothing
   else); no compile or capture after warmup; the B4 x S32 prefill
   program's logits and cache within TOL_MODEL_BF16 of the eager
   ``impl="ref"`` ``prefill_step``, its and the served first tokens a
   top choice of the plain path; two kept prefill outputs intact after
   a later call.

9. qwen2.5-14b at full width, depth cut to QWEN_LAYERS of its 48 layers
   (d 5120, 40 heads of 128 with 8 KV heads, d_ff 13824, vocab 152064,
   QKV bias, rope theta 1e6, SwiGLU; 14.77 B parameters, 29.5 GB bf16 at
   full depth; random weights from seed 0), after phases 3-8 freed their models and graph pools:
   ``BatchedServer(mode="interpret")`` at the CLI defaults (Forge-compiled
   block bodies with ``forge.swiglu``: two fused-linear launches each),
   then the contiguous forge fronts on ``segment_jit`` (rung 4, the B4 x
   S32 cell only): batched prefill and 32 decode steps, every dispatch
   and served token bitwise against ``interpret``, the host/device split;
   then ``apply`` at B=1, S=1024 (flash at H=40, KVH=8, D=128) against
   ``impl="ref"`` by relative L2 beside the kernel-free spread.  Launches
   exact (fused linear = the compiled graphs' linear nodes, a
   ``forge.swiglu`` counting two, x dispatches; flash = the apply body's
   unmasked attention x the layers); each program's seven-pass table, node
   reduction and fused counts; FGR of the decode block body.  Then in
   f32 at full width, depth cut to F32_CHECK_LAYERS layers (48 layers in
   f32 are 59 GB),
   the served prefill program and ``apply`` against ``impl="ref"``
   elementwise within TOL_DEEP_F32.

10. forge-125m at full width, depth cut to COMPILE_COST_LAYERS of its 12
   layers (bf16, ``segment_jit``), through the compile-cost layer.  (a)
   The JAX package's async-compile workload (24 requests in one wave,
   prompts of 4 + i % 5 tokens, budgets of 12 + 2 (i % 8), 8 slots, pow2
   rungs, only rung 8 warm, max_len 256) through ``SlotScheduler`` inline,
   then with ``async_compile=True`` and two compile workers: the async
   run falls back to the warm rung at least once, blocks at most 5 ms
   on compiles, and its tokens equal the inline run's, a request that
   diverges held at its first differing token by the measured-slack rule
   (below); tick p50 / p99 / max of both runs, the fallback counters and
   the background builds.  (b)
   Restart replay in one process: rungs 2 and 4 warmed against a fresh
   cache directory, every in-memory tier dropped, warmed again with zero
   full builds (block bodies included), both warmups' split into
   export / Phase 2 / Phase 3 / Phase 4 / capture; then the serve CLI
   twice as subprocesses (``--sweep 1,8 --prompt-sweep 17 --gen 8
   --cache-dir D``, the second with ``--assert-no-builds`` once the
   first has exited), both exiting 0; they run beside phases 6-7, whose
   exports leave the other CPU cores idle, and are read here.  (c) ``BucketedModule.__call__`` on the block body at S=1024,
   bucketed over batch (pow2): B 1, 3 and 5 against exact-shape compiles
   within the bf16 kernel tolerance (the fused-linear ``wgmma`` split
   depends on M), exactly 3 flash and 9 fused-linear launches, and
   ``check_bucketed_fidelity``.  (d) A second ``generate`` at one batch
   takes the pooled cache and ``memory_reserved`` does not grow.  (e)
   ``evict_cold(1)`` frees the evicted programs' graph pools
   (``memory_reserved`` falls), and a later dispatch of an evicted rung
   replays it from the disk tier, bitwise equal to its first program.
   Between phases the process-global compile cache is cleared: on the
   card its executors hold their CUDA graphs and pools.
11. forge-125m at full width, depth cut to FAULT_SLO_LAYERS of its 12
   layers but in (c) (bf16, ``segment_jit``, paged attention kernel), through
   fault-tolerant and SLO-aware slot serving.  (a) The JAX package's
   ``benchmarks/fault_recovery.py`` workload (16 requests, every third
   sharing a 16-token prefix; max_len 32, pages of 8, 4 slots) served
   clean, then under ``FaultPlan(seed=11)`` (``page.alloc``
   0.15 x3, ``dispatch`` 0.08 x3, ``logits.nan`` at call 4): the faults
   fire, every failure is a typed per-request outcome, the survivors are
   bitwise the clean run's, ``pool.check()`` passes every tick and no
   page or slot leaks; faulted and clean tok/s.  One decode rung and one
   prefill cell (``ladder:4``, ``ladder:32``): on the card a row's bits
   depend on the cell's row count, and faults move requests between
   admission waves.  (b) A dispatch fault before segment k > 0 of the
   first decode dispatch: one in-tick retry, every token bitwise.  (c)
   ``benchmarks/slo_serving.py``'s wall-clock workload (4 background
   requests, 10 priority-2 Poisson bursts; max_len 64) with ``slo=False``
   and ``slo=True``: TTFT p99 of each and their ratio, preemptions >= 1,
   shed 0, every token bitwise across the runs, no compile; then the
   hopeless row (budgets 1e-4 s, priority 0) sheds.  (d) Contiguous
   preempt and resume on the contiguous fronts: tokens bitwise equal to
   the FIFO run.  (e) A ladder re-fit on a shrinking batch: refits >= 1,
   one program evicted and the memory it freed, tokens unchanged.  (f)
   The serve CLI with ``--chaos page.alloc=0.2,dispatch=0.05
   --chaos-seed 3`` exits 0 and prints its chaos line (run beside phases
   6-7, as phase 10's CLI pair).  Launches exact:
   fused linear and paged attention = each segment's kernel ops x the
   times it ran (``segment_runs``; a call cut by a fault counts the
   segments before the fault), flash and the scan 0; no compile or
   capture in any counted run.

12. The autotuner, the jit mode and qwen2.5-14b on the paged fronts.
   On phase 9's qwen2.5-14b weights (one init), before its f32 part:
   (a) ``SlotScheduler`` over ``BatchedServer(mode="forge", paged=True)``
   with the paged-attention kernel at full width, QWEN_PAGED_LAYERS of
   the 48 layers (40 query heads on 8 KV heads: groups of 5), phase 5's
   workload on segment_jit: paged launches = layers x decode dispatches,
   fused linear = the programs'
   linear nodes x dispatches, no compile or capture after warmup,
   ``pool.check()`` every tick, no page leaked, a decode and a prefill
   dispatch bitwise against interpret, the host/device split; tok/s,
   tick p50 / p99, TTFT, compile seconds per program.  (b)
   ``BatchedServer(mode="jit")`` (batch 4, prompt 32, 32 new tokens,
   depth QWEN_JIT_LAYERS): the step compiled whole with
   ``torch.compile(fullgraph=True)`` and replayed as one CUDA graph;
   one graph, launches = the graph's fused-linear nodes x steps, the
   cache in place; greedy tokens against ``mode="interpret"``'s (a row
   that parts at a near-tie is held at its first differing token by the
   measured-slack rule); every step's logits, teacher-forced on
   interpret's tokens, against the interpreted step's within
   SPREAD_FACTOR_BF16 times the run's kernel-free spread (relative L2
   over all steps) and, on forge-125m, within TOL_MODEL_BF16 at every
   step; decode p50 / p99, compile seconds, the graph's nodes.  (c)
   ``AutotuningCompiler().compile`` on the ``apply`` block body at B=1,
   S=1024: 47 candidates on copies of one capture, the winner's launches
   (one flash, its fused-linear nodes), within the bf16 kernel tolerance
   of the default pipeline's body; per-candidate and export times.  (d)
   Phase 6's async compile and restart contract on the paged fronts with
   the paged-attention kernel at QWEN_PAGED_LAYERS (paged and fused
   linear launches above 0, no page leaked).  After
   phase 11, (b) and (c) on forge-125m at full width (the CLI defaults;
   ``apply`` at B=4, S=1024).

13. The MoE and VLM families at full width, bf16, random weights from
   seed 0, each model freed before the next.  (a) phi3.5-moe-42b-a6.6b
   (d 4096, 32 heads on 8 KV heads, 16 experts of d_ff 6400, top-2,
   vocab 32064) at MOE_LAYERS of 32 layers (83.8 GB at full depth, above
   the card's 80 GB): the paged ``SlotScheduler`` with the paged kernel
   (groups of 4) over phase 5's workload, and the contiguous fronts at
   the CLI's defaults; neither has a prefill front (capacity routing
   couples the tokens of a block), so prompts replay through the decode
   program; on both a decode dispatch (and on the contiguous path the
   served tokens) bitwise against interpret, launches exact, 0 pages
   leaked; ``apply`` at B=1, S=1024 within max(REL_L2_DEEP_BF16,
   SPREAD_FACTOR_BF16 x spread) relative L2 of impl="ref" (the rule of
   a routed bf16 model: two kernel-free implementations already send
   near-tied tokens to other experts); the jit step at MOE_JIT_LAYERS
   layers held by the teacher-forced logits check (its rows share the
   experts' capacity, so a row that differs is reported, not held
   alone); in f32 at F32_CHECK_LAYERS layers the served decode program's prefill of 8
   tokens and ``apply`` at B=1, S=256 within TOL_DEEP_F32 of impl="ref".
   (b) qwen2-vl-72b (d 8192, 64 heads on 8 KV heads, d_ff 29568, vocab
   152064, QKV bias, M-RoPE sections 16/24/24) at VLM_LAYERS of 80: the
   interpret server and the contiguous fronts (the lockstep decode
   program: one shared position) at the CLI's defaults, segment_jit
   bitwise interpret; ``apply`` with 16 patch embeddings at B=1, S=1024.
   (c) kimi-k2-1t-a32b (d 7168, 64 heads of 112 on 8 KV heads, 384
   experts of d_ff 2048, top-8, one shared expert, vocab 163840) at
   KIMI_LAYERS layer (38.8 GB): ``apply`` at B=1, S=256 (flash at D=112)
   against impl="ref", ``memory_allocated`` before and after the body's
   compile; 8 greedy decode steps through the interpret server and the
   next step's logits against impl="ref".  Phase 2 times fused linear at
   the three models' layers, flash at their ``apply`` shapes and paged
   attention at phi3.5-moe's groups of 4.

14. The encoder-decoder family: seamless-m4t-large-v2 at full width and
   depth (24 encoder + 24 decoder layers, d 1024, 16 heads of 64, GELU
   d_ff 8192 with biases, LayerNorm, vocab 256206 with the head tied to
   the embedding; 1.37 B parameters, 2.74 GB bf16, random weights from
   seed 0; the audio frontend a stub, frame embeddings N(0, 1)).  (a)
   ``apply`` at B2, T1024 frames, S256 tokens through the Forge-compiled
   encoder and decoder bodies: flash 72 times (the encoder's non-causal
   Sq = Sk, the decoder's causal self-attention and non-causal
   cross-attention at Sq < Sk), fused linear 3 + 4 a layer, all
   ``wgmma`` / ``gemv``; the device time by kernel; logits within
   :func:`within_spread` of impl="ref".  (c) Greedy serving at B4 over
   T500 frames (ragged key tiles), an 8-token decoder prompt and 32
   generated tokens: ``init_cache`` (the encoder, then every layer's cross
   K/V, plain products), then ``steps.make_serve_step`` compiled whole by
   ``ForgeCompiler`` on segment_jit (the position a tensor), the prompt
   replayed through it; launches exact (flash once a decoder layer a
   step: the cross-attention at one query row against the frames), the
   same lowered program on interpret bitwise equal (tokens, every step's
   logits, the cache), every step's logits teacher-forced against the
   kernel-free eager step by :func:`within_spread` (the spread against
   the unfused kernel-free ``apply``); encode and init_cache ms, decode
   p50 / p99, tok/s against the step's byte bound, compile seconds split,
   the host/device split of a step.  (b) ``apply`` in f32 (5.5 GB) at
   B1 T256 S64 within TOL_DEEP_F32 of impl="ref".  Phase 2 holds flash
   at every shape (a) and (c) give it, in f32 and bf16, and times each
   (D64: non-causal B2 H16 S1024, Sq256 Sk1024, Sq1024 Sk300, B4 Sq1
   Sk500 and B4 S500; causal B2 H16 S256), and fused linear at its widths
   with and without biases at M 4, 512, 2000 and 2048 (timed at 4 and
   2048).

15. Training at full size: forge-125m (12 layers, d 768, vocab 50257,
   bf16, ``remat=True`` as its config says), through the step compiled
   whole and donated (``train.JitTrainStep``: the loss and its
   AOTAutograd backward, the clipping and the AdamW update, one CUDA
   graph a step).  (a) The train CLI in-process,
   ``repro_torch.launch.train.main(["--arch", "forge-125m", "--batch",
   "8", "--seq", "128", "--steps", "12", "--ckpt-every", "6",
   "--simulate-fault", "8", ...])``: one failure, one restore from the
   step-6 checkpoint copied into the step's own buffers, the replayed
   steps 6-7's losses equal to the first pass's (bitwise, or within 1e-3
   relative), the CLI's "loss diverged" check; 2 Dynamo graphs, 3
   Inductor programs and a replay for every step but the first; launches
   of the whole run exact (14 steps and the first call's eager forward).
   (b) One step's launches, one replay: the compiled forward's and
   backward's kernel nodes (the backward's: the partitioner's recompute
   of the checkpointed bodies), ``wgmma`` at M = 1024 rows; the owned
   tensors do not move.  (c) The compiled step's loss against the eager
   ``make_train_step``'s on the same state and batch, by the spread rule
   (:func:`within_spread`); one eager step against impl="ref": the loss
   and every gradient leaf within SPREAD_FACTOR_BF16 x the spread of two
   kernel-free implementations; at F32_CHECK_LAYERS layers in f32 the
   gradients elementwise within rtol 2e-4 / atol 2e-5 of impl="ref", and
   3 compiled steps' losses within the same of 3 eager steps'.  (d)
   Adafactor: 3 steps of ``make_train_step(cfg,
   Adafactor().for_config(cfg))``, finite losses, every >= 2-D leaf of
   the stacked view factored.  (e) Reported: the compiled and the eager
   step's median ms and tok/s against the step's bound (its FLOPs at the
   bf16 peak plus AdamW's bytes at the HBM rate), the compile split, the
   host/device split of a compiled step, the compiled update's ms and
   share, checkpoint save and restore seconds, and both runs'
   ``max_memory_allocated`` (the compiled run's at most 1.1x the eager
   one's).  (f) recurrentgemma-2b at full width, 3 layers (rec, rec,
   attn), B8 x S128, bf16, 4 steps through ``build_trainer``'s compiled
   step: the RG-LRU scan and flash at D = 256 (``wmma``) under a compiled
   backward, launches a replay equal to the kernel nodes, finite losses,
   the first loss within the spread rule of the eager step's.
   Phase 2 holds each path kernel's gradient through its custom op (the
   kernel forward, the registered plain backward) against autograd
   through the plain version: fused linear (GELU with a bias, SiLU
   without; f32 and bf16; M = 1024), flash (causal B8 H12 S128 D64, f32
   and bf16) and the RG-LRU scan (B2 T128 D2560 f32).

16. The distributed layer (``repro_torch.distrib``, ``launch/mesh.py``,
   ``runtime/compress.py``, ``launch/dryrun.py``).  (a) A one-rank NCCL
   group on the card and ``make_host_mesh()`` as a (1, 1) (data, model)
   mesh; forge-125m at full size (12 layers, d 768, bf16) placed by
   ``plan_for(cfg, mesh)`` as DTensors (``distribute_tree``): ``apply``
   at B4 x S1024 and one train step (B8 x S128, remat, AdamW) through the
   Forge-compiled bodies on interpret, the kernels reached through
   DTensor (their sharding strategies, ``register_kernel_shardings``):
   launches equal to the unplanned run's (12 flash + 36 fused linear;
   24 + 72), logits and loss bitwise the unplanned run's.  (b)
   ``compressed_all_reduce`` of that step's gradients (124M elements, in
   fp32) on the NCCL group: every 256-element block within its amax / 254
   of the plain ``all_reduce``; the compression ratio, quantize and
   dequantize ms.  (c) ``python -m repro_torch.launch.dryrun --arch
   qwen2.5-14b --shape train_4k``, then ``--arch deepseek-7b --shape
   prefill_32k`` (``run_cell`` on pod16x16 at full depth: a ``fake`` group
   of 256 ranks, fake tensors, the card hidden from them), one subprocess
   after the other, started beside phase 1 and read here: each cell
   ``ok`` with FLOPs above 0, its per-device bytes against 80 GB, the
   three roofline terms (H100 constants), the collectives' count and MB
   by kind, and the FLOPs a layer a device (its calibration), the train
   cell's against the JAX package's.  (d) Tensor parallelism: forge-125m at full
   size on a (1, 2) (data, model) mesh of two gloo ranks, both on this
   card (NCCL holds one rank per GPU), ``apply`` at B4 x S1024: each rank
   launches 12 flash on 6 of the 12 heads and 36 fused linear, all
   ``wgmma``, at the row-, column- and row-parallel local shapes (M, N,
   K) (4096, 768, 384), (4096, 1536, 768), (4096, 768, 1536); rank 0
   holds the logits within TOL_MODEL_BF16 of the unplanned run.  (e)
   Expert parallelism: phi3.5-moe at full width (d 4096, 16 experts of
   d_ff 6400, top-2), EP_LAYERS of its 32 layers in f32, ``apply`` at
   B2 x S512 on two gloo ranks sharing the card, on a (1, 2) mesh (8
   experts a rank; a token's output sums over the ranks holding its
   experts) and a (2, 1) one (each rank routes its own batch row and runs
   every expert on half the capacity; the buffers summed and gathered
   over ``data``): rank 0's logits within TOL_DEEP_F32 of the unplanned
   one-device run, the dropped entries by layer equal to the unplanned
   run's, each rank's expert products on its own (E / model, C / data)
   share and their device time (CUDA events), one flash and one fused
   linear (``fma``: f32) launch a layer on each rank.

   After phase 15, the train CLI on two ranks: ``launch.train.main`` in
   two spawned processes under the environment ``torchrun
   --nproc-per-node 2`` sets (``main`` opens the gloo group), both on
   this card (``--device cuda:0``), forge-125m at full size, B8 x S128,
   4 steps, a checkpoint every 2 and a fault at step 3; run beside phases
   16-17 and read after (e): each rank's step ``JitTrainStep``, the
   losses bitwise equal on both, one failure and one restore from step 2
   on each, steps 0, 2 and 4 on disk written by rank 0 alone, each rank's
   launches its steps' forward and backward kernel nodes plus the first
   call's eager forward.

17. The examples on the card: ``examples/torch_quickstart.py`` and
   ``examples/torch_serve_batch.py --arch forge-125m --full --gen 8``,
   each in a subprocess of its own started beside phase 6, each held to
   its own exit code and to what it must print.

In phases 5-9, one decode and one prefill dispatch of the served
programs under ``segment_jit`` must be bitwise equal to the same lowered
programs under ``interpret`` (built without a second ``torch.export``),
and so must the served greedy tokens; each path prints, for both
backends, the host wall per steady decode step (p50/p99), the device
time per step and the busy share (``torch.profiler``), the graph replays
per step, the capture seconds per program and ``memory_reserved`` before
and after warmup (the graph pools).

Phase 2 also holds the paged-attention kernel against its plain version
(f32 rtol 2e-4 / atol 2e-5; bf16 3e-2 and the bf16 rounding bound) on
random non-contiguous page tables with positions at -1 and page edges:
forge-125m's shapes (B 1/2/4, 12 heads, D 64, page 16, 16 pages a row,
129 pages), GQA 12/4, 32/8 and qwen2.5-14b's 40/8 (groups of 5), a
window, every head dim of 8 to 256, and forced split plans (one block a
row, one split per page, more splits than pages); it times the served
shape, a long context (128 live pages a row), GQA at D=128, and
qwen2.5-14b's shape at phase 12's positions and at pos 2047.

In phases 6 and 7 a served first token must be a top choice of the
plain path within a slack measured in the same run: the larger of twice
TOL_MODEL_BF16 and SPREAD_FACTOR_BF16 times the row's spread between two
kernel-free implementations of the prefill, which must themselves pass
the check against each other.

Each path's launch counts are zeroed just before it and read just after,
in all and, for fused linear and flash, by the kernel variant taken:
every bf16 fused-linear launch of phases 3-9 must be ``gemv`` or
``wgmma`` and every flash launch (phase 4's 12, phase 9's one a layer) the
warpgroup kernel ``wgmma``, never a ``wmma`` kernel kept for operands
TMA cannot take.  recurrentgemma-2b's ``apply`` (phase 6) runs flash in
its local-attention layers: at S = 1024 below its window the banded
mask folds to the causal pattern, as in the JAX package, and its head
dim 256 has only the ``wmma`` kernel.
The RMSNorm kernel is on no path (the JAX package's models normalise
through the plain version too): its row reports 0 launches.
The line before the last is one JSON object with a row per kernel (its
launches, by variant too, and times also split by path); the last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_F32 = dict(rtol=2e-4, atol=2e-5)
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
# whole-model bf16 logits, kernels against the plain path: each kernel
# rounds its fp32 result once where the plain path rounds the product,
# the bias add and the activation separately, and the differences
# compound through 12 residual layers (measured on the H100: 2 of 206M
# apply logits between 3e-2 and 3.4e-2), so twice the kernel bound
TOL_MODEL_BF16 = dict(rtol=6e-2, atol=6e-2)
# recurrentgemma-2b: a bf16 rounding difference between two
# implementations (a fused linear rounds once where the plain path rounds
# twice; a scan reassociates) is amplified through the layers and the
# recurrent state, so no elementwise bf16 bound holds even between two
# implementations without any kernel (phase 6 measures that spread: the
# served program with impl="ref" against the eager plain path).  The
# kernels are held elementwise in f32 at full width, where the same amplification of f32 rounding stays far below 1e-3 on
# logits of std 1 (at full depth too: 7.9e-5 on recurrentgemma-2b's and
# 8.3e-5 on xlstm-350m's logits, measured on the H100); the bf16 path is
# held by relative L2 error
TOL_DEEP_F32 = dict(rtol=1e-3, atol=1e-3)
# phases 6 and 7 serve recurrentgemma-2b and xlstm-350m at full width with
# the depth cut, in bf16 and in f32, both layer kinds of each model among
# the layers kept: recurrentgemma-2b's first block pattern (rec, rec,
# attn; 8 layers until phase 16 (e) took its time out of the cut), and
# xlstm-350m's first 8 layers (its first sLSTM layer is the eighth; at 4
# mLSTM layers its bf16 spread check fails).  The script's time limit
# binds at full depth
RG_LAYERS = 3
XLSTM_LAYERS = 8
# the f32 checks of phases 9 (qwen2.5-14b), 13 (a) (phi3.5-moe) and 15 (c)
# (forge-125m): full width at this depth (8 before phase 14 took its time
# out of the cut, 4 before phase 16 (e)); the checks are elementwise
# (TOL_DEEP_F32, TOL_F32), which depth does not ease
F32_CHECK_LAYERS = 1
# phases 10 and 11 on forge-125m: full width, the depth cut to this many
# of its 12 layers.  Their time is compiles (torch.export: a program or
# two a case), which grow with the layers; the main path runs all 12 in
# phases 3-5, 8 and 12 (b) (12 here too until phase 16 (e) took its time
# out of the cut; phase 12 (b)'s Inductor build of the 12-layer jit step
# is what phase 17's serve example finds in Inductor's caches).  Phase
# 11's wall-clock SLO case (c) keeps all 12: at 4 layers its 4 background
# requests ended before the first burst arrived (20-40 ms in), and it
# preempted none
COMPILE_COST_LAYERS = 2
FAULT_SLO_LAYERS = 4
# phase 12 (a): qwen2.5-14b through the paged SlotScheduler at full width
# and this depth.  At all 48 layers the whole script took 976.6 s on the
# H100 (phase 12 (a) 87.1 s, its five programs exported in 15 s each),
# past its 920 s budget; each layer costs it about 2 s.  24 until phase
# 15's compiled train steps took their time out of the cut
QWEN_PAGED_LAYERS = 4
# phase 9 serves qwen2.5-14b at full width and this many of its 48 layers
# (48 until phase 16 (e) took its time out of the cut; the checks there
# are bitwise or hold a fixed relative-L2 bound, which depth only eases)
QWEN_LAYERS = 4
REL_L2_DEEP_BF16 = 0.1
# xlstm-350m at full depth is more sensitive still: two bf16
# implementations without any kernel (the prefill cell compiled with
# impl="ref" against the eager plain path; apply unfused against apply
# compiled with impl="ref") already differ by 5-8% relative L2 in logits
# and states (measured on the H100), so the fixed bound above does not
# hold for them either.  The kernels change the rounding at the same
# fused-linear sites as the compiled plain path does, so phase 7 holds
# the served bf16 results leaf by leaf within twice that kernel-free
# spread, measured in the same run; the kernels are held elementwise in
# f32 at full width (TOL_DEEP_F32)
SPREAD_FACTOR_BF16 = 2.0
# bf16 flash attention, element by element, from bf16's unit roundoff
# u = 2^-8: the kernel rounds its unnormalised probabilities and the
# plain version its normalised ones, each term p_j*v_j by at most u, and
# both round the output once, so they differ by at most
# 2u*sum_j p_j|v_j| + 2u*|out|; the check allows 3u times that sum
BF16_U = 2.0 ** -8
# flash inputs: q and k with std 1.5 give scores of std 2.25 after the
# 1/sqrt(D) scale, so the softmax is peaky and each output row is O(1)
QK_STD = 1.5
# flash at every head dim: (B, H, KVH, Sq, Sk, causal) — GQA 8/2 causal
# with ragged query and key tiles, one query row, MHA with Sq < Sk
FLASH_DIM_SHAPES = ((2, 8, 2, 300, 300, True), (1, 4, 4, 1, 200, False),
                    (2, 8, 8, 100, 260, True))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
ACTS = (None, "relu", "silu", "gelu", "gelu_exact", "tanh")
# fused-linear rows M the main paths give the kernel: decode at the eager
# batch (4) and the paged rungs (1, 2, 4); the paged prefill cells B x S
# of {2, 4} x {16, 32, 64} (32 .. 256, partial row tiles included); the
# full-sequence forward (4 x 1024)
FL_ROWS = (1, 2, 4, 32, 64, 128, 256, 4096)
# recurrentgemma-2b's fused-linear nodes, (K, N, act): wy + gelu and the
# rec / attention output projections (2560 x 2560), the GeGLU gate +
# gelu (2560 x 7680) and down projection (7680 x 2560); at decode (M 4),
# the served prefill cell (4 x 32) and the full-sequence forward (2 x 1024)
RG_LINEARS = ((2560, 2560, "gelu"), (2560, 2560, None), (2560, 7680, "gelu"),
              (7680, 2560, None))
RG_FL_ROWS = (4, 128, 2048)
# the RG-LRU scan: (B, T, D, nonzero h0) — the served prefill cells
# (4 x 32, 4 x 64), the full-sequence forward (2 x 1024, h0 zero) and a
# ragged T and D
RG_SHAPES = ((4, 32, 2560, True), (4, 64, 2560, True), (2, 1024, 2560, False),
             (3, 37, 100, True))
# phase 15 (f)'s training shape (B8 x S128, h0 zero), timed beside them
RG_TRAIN = (8, 128, 2560, False)
# chunk lengths forced on every RG_SHAPES case: one step a chunk (a look-back
# as deep as T), a length that leaves a ragged last chunk, the longest
RG_FORCED_STEPS = (1, 7, 64)
# chained rg_lru_scan calls (B, T, D, cuts): the cell and calls of a
# one-chunk plan (T <= 32), and calls whose plans take several chunks
RG_CHAINS = ((4, 32, 2560, (7, 20)), (4, 128, 2560, (32, 45, 100)),
             (2, 300, 300, (70, 71, 200)))
# xlstm-350m's fused-linear nodes (K, N, act): the mLSTM output gate
# w_gate + silu (1024 x 2048) and down projection (2048 x 1024), the
# sLSTM output projection (1024 x 1024); the other widths of the model,
# 2048 x 2048 (q, k, v) and 1024 x 4096 (sLSTM w_in), are checked too
XL_LINEARS = ((1024, 2048, "silu"), (2048, 1024, None), (1024, 1024, None),
              (2048, 2048, None), (1024, 4096, None))
# decode (M 4), the served prefill cell (4 x 32) and apply (2 x 1024)
XL_FL_ROWS = (4, 128, 2048)
# qwen2.5-14b's fused-linear nodes (K, N, act): the attention output
# projection (5120 x 5120, with the residual), the SwiGLU gate + silu and
# up projection (5120 x 13824), the down projection (13824 x 5120, with
# the residual); the KV projections' width (5120 x 1024) is checked too,
# though the biased q, k, v products stay plain (as in the JAX package)
QW_LINEARS = ((5120, 5120, None), (5120, 13824, "silu"), (5120, 13824, None),
              (13824, 5120, None), (5120, 1024, None))
# decode (M 4), the served B4 x S32 prefill cell, apply at B1 x S1024
QW_FL_ROWS = (4, 128, 1024)
# phase 12's jit server on qwen2.5-14b: the depth it is compiled at (full
# width).  torch.compile's build grows with the step's nodes (400-672 s at
# 48 layers on the H100 machine, Inductor 338 s of it), so the whole
# script keeps 2 layers inside its time limit (at 1 its teacher-forced
# logits check fails: the kernel-free spread shrinks faster than the
# step's own rounding); ``--qwen-jit-layers 48`` compiles the full depth
QWEN_JIT_LAYERS = 2
# phase 13: the MoE and VLM families at full width, each model's depth
# cut to what the card holds beside the script's time limit.
# phi3.5-moe-42b-a6.6b: 32 layers are 83.8 GB in bf16, above the card's
# 80 GB; 2 layers are 5.8 GB (8 until phase 16 (e) took its time)
MOE_LAYERS = 2
# qwen2-vl-72b: 80 layers are 145 GB; 2 layers 8.5 GB (8 until phase 16 (e))
VLM_LAYERS = 2
# kimi-k2-1t-a32b: one layer's 384 experts are 34.1 GB, 38.8 GB with the
# embedding and the head
KIMI_LAYERS = 1
# phi3.5-moe's jit step (torch.compile's build grows with the layers)
MOE_JIT_LAYERS = 2
# each model's fused-linear nodes (K, N, act) and the width of its k / v
# projections, checked though they stay plain matmuls (as in the JAX
# package): phi3.5-moe's attention output projection (with the residual;
# the experts are batched products outside any kernel), kimi-k2's output
# projection and shared SwiGLU expert (7168 -> 2048, its down projection
# with the routed experts' sum as the residual), qwen2-vl-72b's output
# projection and SwiGLU (8192 -> 29568)
PHI_LINEARS = ((4096, 4096, None), (4096, 1024, None))
KIMI_LINEARS = ((7168, 7168, None), (7168, 2048, "silu"), (7168, 2048, None),
                (2048, 7168, None), (7168, 896, None))
VL_LINEARS = ((8192, 8192, None), (8192, 29568, "silu"), (8192, 29568, None),
              (29568, 8192, None), (8192, 1024, None))
# decode (M 4) and each model's apply (B1 x S1024; kimi-k2 B1 x S256)
PHI_FL_ROWS = (4, 1024)
KIMI_FL_ROWS = (4, 256)
VL_FL_ROWS = (4, 1024)
# phase 14: seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
# 1.37 B parameters, 2.74 GB in bf16).  Its fused-linear nodes (K, N,
# act): the attention output projections with the residual (1024 x 1024),
# the FFN's fc + bias + gelu (1024 x 8192) and down projection + bias +
# residual (8192 x 1024); at decode (M 4: a decoder layer's four launches)
# and in apply's encoder (B2 x T1024 = 2048 rows: an encoder layer's three)
ED_LINEARS = ((1024, 1024, None), (1024, 8192, "gelu"), (8192, 1024, None))
ED_FL_ROWS = (4, 2048)
# every M phase 14 gives these widths, checked against the plain version:
# the timed rows, apply's decoder (B2 x S256) and serving's encoder
# (B4 x T500)
ED_FL_CHECK_ROWS = (4, 512, 2000, 2048)
# flash at its shapes (B, H, Sq, Sk, causal), 16 heads of 64: the encoder
# over T1024 frames, cross-attention with fewer (S256) and more (S1024
# over T300) queries than keys, the decode step's one query row against
# T500 frames at B4, apply's causal decoder self-attention over S256 and
# serving's encoder over T500 frames (a ragged query tile)
ED_FLASH = (("enc", (2, 16, 1024, 1024, False)), ("cross", (2, 16, 256, 1024, False)),
            ("cross_long", (2, 16, 1024, 300, False)), ("decode", (4, 16, 1, 500, False)),
            ("dec_self", (2, 16, 256, 256, True)), ("enc_serve", (4, 16, 500, 500, False)))
# RMSNorm (rows, d): xlstm-350m's decode block norm, the B4 x S32
# prefill block norm, norm_h at B4 x H4 x S32 (hd 512), apply at
# B2 x S1024, and a ragged d
RMS_SHAPES = ((4, 1024), (128, 1024), (512, 512), (2048, 1024), (3, 1000))
# phase 15: forge-125m trained through the train CLI at B8 x S128 (the
# reference CLI's defaults), 12 steps with a checkpoint every 6 and one
# fault at step 8; the fused-linear rows and the flash shape it gives the
# kernels (B, H, KVH, S, D)
TRAIN_ARGS = ["--arch", "forge-125m", "--batch", "8", "--seq", "128", "--steps", "12",
              "--ckpt-every", "6", "--simulate-fault", "8"]
TRAIN_ROWS = 8 * 128
TRAIN_FLASH = (8, 12, 12, 128, 64)
# phase 2's gradient rows: fused linear at the training M (K, N, act,
# bias), flash at the training shape, the RG-LRU scan (B, T, D)
GRAD_LINEARS = ((768, 3072, "gelu", True), (768, 3072, "silu", False))
GRAD_RG = (2, 128, 2560)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def tol_for(dtype):
    import torch

    return TOL_BF16 if dtype == torch.bfloat16 else TOL_F32


def assert_close(got, want, dtype, what, tol=None):
    """Hold a result against its plain version; returns the max abs error."""
    import torch

    t = tol or tol_for(dtype)
    g, w = got.float(), want.float()
    check(torch.isfinite(g).all().item(), f"{what}: non-finite values")
    err = (g - w).abs()
    bad = err > t["atol"] + t["rtol"] * w.abs()
    check(not bad.any().item(),
          f"{what}: {int(bad.sum())} elements beyond rtol={t['rtol']} atol={t['atol']} "
          f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def assert_flash_rounding(got, want, q, k, v, scale, causal, what):
    """Hold a bf16 flash result within 3u*(sum_j p_j|v_j| + |out|) of its
    plain version; returns the largest error-to-bound ratio."""
    from repro_torch.kernels import flash_attention as FA

    mass = FA.flash_attention_plain(q, k, v.abs(), scale=scale, causal=causal).float()
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 3 * BF16_U * (mass + w.abs())
    worst = (err / bound).max().item()
    check(not (err > bound).any().item(),
          f"{what}: {int((err > bound).sum())} elements beyond 3u(sum p|v| + |out|) "
          f"(worst err/bound {worst:.3e})")
    return worst


def flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sk, D=64):
    import torch

    q = (torch.randn(B, H, Sq, D, generator=g, device=dev) * QK_STD).to(dtype)
    k = (torch.randn(B, KVH, Sk, D, generator=g, device=dev) * QK_STD).to(dtype)
    v = torch.randn(B, KVH, Sk, D, generator=g, device=dev).to(dtype)
    return q, k, v


class Timer:
    """Device time of one call's kernels with a cold L2, from
    ``torch.profiler``: every call follows a 128 MB memset (2.5x the L2),
    and the kernels the call launched are summed, the memset's fill
    kernel excluded.  Host submission time, which exceeds a decode-size
    kernel's own time in the Python wrappers, stays out.  Returns the
    mean over ``iters`` calls."""

    FLUSH_KERNEL = "FillFunctor"
    PROFILES = 3

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        # a profile now and then records no device events at all (once in
        # six whole runs on the H100): such a profile is taken again, at
        # most PROFILES times in all
        for _ in range(self.PROFILES):
            with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if "CUDA" in str(getattr(e, "device_type", ""))
                     and self.FLUSH_KERNEL not in e.key)
            if us > 0:
                break
        check(us > 0, "the profiler recorded no device time")
        return us / 1e3 / iters


def phase_build():
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    check(sorted(_build.SOURCES) == sources, f"_build.SOURCES {_build.SOURCES} != csrc {sources}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        path = _build.library_path(name)
        check(path.exists(), f"{name}: library missing after the build")
        log(f"built {path.relative_to(ROOT)}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    log(f"nvcc (sm_90a) built {len(logs)} libraries in {time.perf_counter() - t0:.1f}s")


def phase_fused_linear(dev, timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_linear as FL

    g = torch.Generator(device=dev).manual_seed(1)
    # the served shapes' plans: bf16 takes gemv at decode rows and wgmma
    # above; the shared memory the Python plan counts is what the entry
    # point launches with
    lib = FL._lib()
    served = ([(M, K, N) for M in FL_ROWS for K, N in ((768, 3072), (3072, 768), (768, 768))]
              + [(M, K, N) for M in RG_FL_ROWS for K, N, _ in RG_LINEARS]
              + [(M, K, N) for M in XL_FL_ROWS for K, N, _ in XL_LINEARS]
              + [(M, K, N) for M in QW_FL_ROWS for K, N, _ in QW_LINEARS])
    for M, K, N in served:
        for dtype in (torch.float32, torch.bfloat16):
            p = FL.plan(M, N, K, dtype, True)
            want = ("gemv" if M <= FL.GEMV_MAX_M else "wgmma") if dtype == torch.bfloat16 else p[0]
            c_smem = lib.forge_fused_linear_smem(FL.DTYPE_CODES[dtype], FL.VARIANT_CODES[p[0]],
                                                 *p[1:4])
            check(p[0] == want and FL.smem_bytes(p, dtype) == c_smem,
                  f"plan {p} of M={M} K={K} N={N} {dtype}: want {want}, shared memory "
                  f"{FL.smem_bytes(p, dtype)} (Python) vs {c_smem} (entry point)")
    log(f"fused_linear: the plans of {len(served)} served shapes take gemv / wgmma in bf16; "
        f"shared memory per CTA agrees with the entry point")
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in FL_ROWS:
            for K, N in ((768, 3072), (3072, 768), (768, 768)):
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dtype)
                for act in ACTS:
                    for bias in (b, None):
                        got = FL.fused_linear_cuda(x, w, bias, act=act)
                        want = FL.fused_linear_plain(x, w, bias, act=act)
                        assert_close(got, want, dtype,
                                     f"fused_linear {dtype} M={M} K={K} N={N} act={act} "
                                     f"bias={bias is not None}")
                        n_checks += 1
    for dtype in (torch.float32, torch.bfloat16):
        for M in RG_FL_ROWS:
            for K, N, act in RG_LINEARS:
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                assert_close(FL.fused_linear_cuda(x, w, None, act=act),
                             FL.fused_linear_plain(x, w, None, act=act), dtype,
                             f"fused_linear (recurrentgemma) {dtype} M={M} K={K} N={N} "
                             f"act={act}")
                n_checks += 1
    torch.cuda.synchronize()
    log(f"fused_linear: {n_checks} cases within tolerance of the plain version")

    # timing at the main path's shapes and dtype: one layer's three
    # launches (o-proj, FFN up + gelu, FFN down), at decode (M=4), in the
    # contiguous fronts' B4 x S32 prefill cell (M=128), in phase 15's
    # training step (B8 x S128: M=1024) and in the full-sequence forward
    # (M=4096); and a rank's three in phase 16 (d)'s tensor-parallel
    # forward (row-, column-, row-parallel shards of the same products)
    rows = {}
    whole = ((768, 768, None, False), (768, 3072, "gelu", True), (3072, 768, None, True))
    tp = ((384, 768, None, False), (768, 1536, "gelu", True), (1536, 768, None, True))
    for key, M, shapes in ((4, 4, whole), (128, 128, whole), (TRAIN_ROWS, TRAIN_ROWS, whole),
                           (4096, 4096, whole), (("tp", 4096), 4096, tp)):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)
        for K, N, act, has_b in shapes:
            dt = torch.bfloat16
            x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dt)
            w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dt)
            b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dt) if has_b else None
            err = assert_close(FL.fused_linear_cuda(x, w, b, act=act),
                               FL.fused_linear_plain(x, w, b, act=act), dt, "timing input")
            ms = timer.ms(lambda: FL.fused_linear_cuda(x, w, b, act=act))
            plain = timer.ms(lambda: FL.fused_linear_plain(x, w, b, act=act))
            if has_b and act == "gelu":
                lib_fn = lambda: F.gelu(torch.addmm(b, x, w), approximate="tanh")  # noqa: E731
            elif has_b:
                lib_fn = lambda: torch.addmm(b, x, w)  # noqa: E731
            else:
                lib_fn = lambda: torch.mm(x, w)  # noqa: E731
            lib = timer.ms(lib_fn)
            nbytes = 2 * (M * K + K * N + M * N + (N if has_b else 0))
            flops = 2.0 * M * K * N
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            log(f"fused_linear bf16 M={M} K={K} N={N} act={act} bias={has_b}: "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
                f"bound {bound:.5f} ms ({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
                f"max abs err {err:.3e}")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[key] = tot
        log(f"fused_linear one {'tensor-parallel rank' if shapes is tp else ''} layer "
            f"(3 launches) M={M}: kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.5f} ms")
    # recurrentgemma-2b: one rec layer's four launches (wy + gelu, rec
    # out-proj, GeGLU gate + gelu, down-proj), bf16, at decode (M=4), the
    # served prefill cell (M=128) and the full-sequence forward (M=2048)
    for M in RG_FL_ROWS:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)
        for K, N, act in RG_LINEARS:
            dt = torch.bfloat16
            x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dt)
            w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dt)
            err = assert_close(FL.fused_linear_cuda(x, w, None, act=act),
                               FL.fused_linear_plain(x, w, None, act=act), dt, "timing input")
            lib_fn = ((lambda: F.gelu(torch.mm(x, w), approximate="tanh")) if act  # noqa: E731
                      else (lambda: torch.mm(x, w)))  # noqa: E731
            nbytes = 2 * (M * K + K * N + M * N)
            flops = 2.0 * M * K * N
            for k, v in (("ms", timer.ms(lambda: FL.fused_linear_cuda(x, w, None, act=act))),
                         ("plain_ms", timer.ms(lambda: FL.fused_linear_plain(x, w, None,
                                                                             act=act))),
                         ("library_ms", timer.ms(lib_fn)),
                         ("bound_ms", max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3),
                         ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[("rglru", M)] = tot
        log(f"fused_linear one recurrentgemma-2b rec layer (4 launches) M={M}: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    rows.update(xlstm_fused_linear(dev, timer, g))
    rows.update(qwen_fused_linear(dev, timer, g))
    rows.update(moe_vlm_fused_linear(dev, timer, g))
    rows.update(encdec_fused_linear(dev, timer, g))
    return rows


def encdec_fused_linear(dev, timer, g):
    """fused_linear at seamless-m4t-large-v2's widths: every width of
    ED_LINEARS (and the 1024 x 1024 q, k, v products, which stay plain)
    checked in f32 and bf16, with and without a bias, at every M of
    ED_FL_CHECK_ROWS;
    then timed in bf16 as the paths run them: a decoder layer's four
    launches at decode (M 4: the self- and cross-attention output
    projections with the residual, fc + bias + gelu, down + bias +
    residual) and an encoder layer's three in apply (M 2048), beside the
    plain version and the library calls ``addmm`` (+ the residual) and
    ``gelu(addmm)``.  Returns the rows keyed ``("encdec", M)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import ops

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in ED_FL_CHECK_ROWS:
            for K, N, act in ED_LINEARS:
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dtype)
                for bias in (None, b):
                    assert_close(FL.fused_linear_cuda(x, w, bias, act=act),
                                 FL.fused_linear_plain(x, w, bias, act=act), dtype,
                                 f"fused_linear (seamless-m4t) {dtype} M={M} K={K} N={N} "
                                 f"act={act} bias={bias is not None}")
                    n += 1
    torch.cuda.synchronize()
    log(f"fused_linear: {n} seamless-m4t-large-v2 cases within tolerance of the plain version")
    dt, d, ff = torch.bfloat16, 1024, 8192

    def mat(r, c, scale):
        return (torch.randn(r, c, generator=g, device=dev) * scale).to(dt)

    rows = {}
    for M in ED_FL_ROWS:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)
        xo, x, h, res = mat(M, d, 0.5), mat(M, d, 0.5), mat(M, ff, 0.5), mat(M, d, 1.0)
        wo, wf, wd = mat(d, d, d ** -0.5), mat(d, ff, d ** -0.5), mat(ff, d, ff ** -0.5)
        bf, bd = mat(1, ff, 0.1)[0], mat(1, d, 0.1)[0]
        o_case = ("o + residual",
                  lambda impl=None: ops.fused_linear(xo, wo, residual=res, impl=impl),
                  lambda: torch.addmm(res, xo, wo), 2 * (2 * M * d + d * d + M * d),
                  2.0 * M * d * d)
        cases = [o_case] * (2 if M == 4 else 1) + [
            ("fc + bias + gelu",
             lambda impl=None: ops.fused_linear(x, wf, bf, act="gelu", impl=impl),
             lambda: F.gelu(torch.addmm(bf, x, wf), approximate="tanh"),
             2 * (M * d + d * ff + ff + M * ff), 2.0 * M * d * ff),
            ("down + bias + residual",
             lambda impl=None: ops.fused_linear(h, wd, bd, residual=res, impl=impl),
             lambda: torch.addmm(bd, h, wd).add_(res), 2 * (M * ff + ff * d + d + 2 * M * d),
             2.0 * M * ff * d)]
        for case, fn, lib_fn, nbytes, flops in cases:
            err = assert_close(fn(), fn("ref"), dt, f"seamless-m4t {case} M={M} timing input")
            for k, v in (("ms", timer.ms(fn)), ("plain_ms", timer.ms(lambda: fn("ref"))),
                         ("library_ms", timer.ms(lib_fn)),
                         ("bound_ms", max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3),
                         ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[("encdec", M)] = tot
        log(f"fused_linear one seamless-m4t-large-v2 "
            + ("decoder layer at decode (4 launches: self o + residual, cross o + residual, "
               if M == 4 else "encoder layer in apply (3 launches: o + residual, ")
            + f"fc + bias + gelu, down + bias + residual) M={M}: kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.5f} ms "
            f"({'bytes' if tot['bytes'] / HBM_BYTES_PER_S > tot['flops'] / BF16_FLOPS else 'operations'})")
    return rows


def qwen_fused_linear(dev, timer, g):
    """fused_linear at qwen2.5-14b's widths (:func:`layer_fused_linear`):
    the output projection with the residual, the SwiGLU, the down
    projection with the residual, at M 4, 128 and 1024."""
    return layer_fused_linear(dev, timer, g, "qwen", "qwen2.5-14b", QW_LINEARS, 5120, 5120,
                              13824, QW_FL_ROWS)


def moe_vlm_fused_linear(dev, timer, g):
    """fused_linear at phase 13's widths (:func:`layer_fused_linear`):
    phi3.5-moe's output projection, kimi-k2's output projection and
    shared expert, qwen2-vl-72b's output projection and SwiGLU."""
    rows = layer_fused_linear(dev, timer, g, "phi", "phi3.5-moe", PHI_LINEARS, 4096, 4096,
                              None, PHI_FL_ROWS)
    rows.update(layer_fused_linear(dev, timer, g, "kimi", "kimi-k2", KIMI_LINEARS, 7168, 7168,
                                   2048, KIMI_FL_ROWS))
    rows.update(layer_fused_linear(dev, timer, g, "vl", "qwen2-vl-72b", VL_LINEARS, 8192, 8192,
                                   29568, VL_FL_ROWS))
    return rows


def layer_fused_linear(dev, timer, g, tag, name, linears, q_width, d, ff, rows_m):
    """fused_linear at one model's widths: every width of ``linears`` checked
    in f32 and bf16 at the path's M; one layer's launches (the output
    projection q_width -> d with the residual and, with ``ff``,
    ``ops.swiglu``'s gate + silu and up projection and the down projection
    with the residual) timed in bf16 at each M of ``rows_m``, as the path
    runs them (the residual add and the gate product included), beside the
    plain version and the library calls ``addmm`` (residual as the added
    term), ``mm`` + ``silu`` + ``mm`` + ``mul`` and ``addmm``.  Returns
    the rows keyed ``(tag, M)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import ops

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in rows_m:
            for K, N, act in linears:
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                assert_close(FL.fused_linear_cuda(x, w, None, act=act),
                             FL.fused_linear_plain(x, w, None, act=act), dtype,
                             f"fused_linear ({name}) {dtype} M={M} K={K} N={N} act={act}")
                n += 1
    torch.cuda.synchronize()
    log(f"fused_linear: {n} {name} cases within tolerance of the plain version")
    rows = {}
    dt = torch.bfloat16
    for M in rows_m:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)

        def mat(r, c, scale):
            return (torch.randn(r, c, generator=g, device=dev) * scale).to(dt)

        xo, x, res = mat(M, q_width, 0.5), mat(M, d, 0.5), mat(M, d, 1.0)
        wo = mat(q_width, d, q_width ** -0.5)
        cases = [
            ("o + residual", lambda impl=None: ops.fused_linear(xo, wo, residual=res, impl=impl),
             lambda: torch.addmm(res, xo, wo), 2 * (M * q_width + q_width * d + 2 * M * d),
             2.0 * M * q_width * d)]
        if ff:
            h = mat(M, ff, 0.5)
            wg, wu, wd = mat(d, ff, d ** -0.5), mat(d, ff, d ** -0.5), mat(ff, d, ff ** -0.5)
            cases += [
                ("swiglu", lambda impl=None: ops.swiglu(x, wg, wu, impl=impl),
                 lambda: F.silu(torch.mm(x, wg)) * torch.mm(x, wu),
                 2 * (M * d + 2 * d * ff + M * ff), 4.0 * M * d * ff),
                ("down + residual", lambda impl=None: ops.fused_linear(h, wd, residual=res,
                                                                       impl=impl),
                 lambda: torch.addmm(res, h, wd), 2 * (M * ff + ff * d + 2 * M * d),
                 2.0 * M * ff * d)]
        for case, fn, lib_fn, nbytes, flops in cases:
            err = assert_close(fn(), fn("ref"), dt, f"{name} {case} timing input")
            for k, v in (("ms", timer.ms(fn)), ("plain_ms", timer.ms(lambda: fn("ref"))),
                         ("library_ms", timer.ms(lib_fn)),
                         ("bound_ms", max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3),
                         ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[(tag, M)] = tot
        log(f"fused_linear one {name} layer ("
            + ("4 launches: o + residual, swiglu gate + silu and up, down + residual"
               if ff else "1 launch: o + residual")
            + f") M={M}: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.5f} ms "
            f"({'bytes' if tot['bytes'] / HBM_BYTES_PER_S > tot['flops'] / BF16_FLOPS else 'operations'})")
    return rows


def xlstm_fused_linear(dev, timer, g):
    """fused_linear at xlstm-350m's widths: every width checked in f32 and
    bf16 at M 4 and 128; one mLSTM layer's two launches (w_gate + silu,
    w_down) timed in bf16 at the path's M."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_linear as FL

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for M in XL_FL_ROWS[:2]:
            for K, N, act in XL_LINEARS:
                x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
                w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
                assert_close(FL.fused_linear_cuda(x, w, None, act=act),
                             FL.fused_linear_plain(x, w, None, act=act), dtype,
                             f"fused_linear (xlstm) {dtype} M={M} K={K} N={N} act={act}")
                n += 1
    torch.cuda.synchronize()
    log(f"fused_linear: {n} xlstm-350m cases within tolerance of the plain version")
    rows = {}
    for M in XL_FL_ROWS:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                   err=0.0)
        for K, N, act in XL_LINEARS[:2]:
            dt = torch.bfloat16
            x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dt)
            w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dt)
            err = assert_close(FL.fused_linear_cuda(x, w, None, act=act),
                               FL.fused_linear_plain(x, w, None, act=act), dt, "timing input")
            lib_fn = ((lambda: F.silu(torch.mm(x, w))) if act  # noqa: E731
                      else (lambda: torch.mm(x, w)))  # noqa: E731
            nbytes = 2 * (M * K + K * N + M * N)
            flops = 2.0 * M * K * N
            for k, v in (("ms", timer.ms(lambda: FL.fused_linear_cuda(x, w, None, act=act))),
                         ("plain_ms", timer.ms(lambda: FL.fused_linear_plain(x, w, None,
                                                                             act=act))),
                         ("library_ms", timer.ms(lib_fn)),
                         ("bound_ms", max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3),
                         ("flops", flops), ("bytes", nbytes)):
                tot[k] += v
            tot["err"] = max(tot["err"], err)
        rows[("xlstm", M)] = tot
        log(f"fused_linear one xlstm-350m mLSTM layer (2 launches: 1024x2048+silu, "
            f"2048x1024) M={M}: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
            f"library {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    return rows


def phase_rms_norm(dev, timer):
    """The RMSNorm kernel against ``rms_norm_ref`` in f32 and bf16 at
    xLSTM's widths and a ragged d (also a misaligned input, which takes
    the one-element-a-load path), then its bf16 time beside the plain
    version, ``torch.nn.functional.rms_norm`` (w in x's dtype) and the
    bound (bytes: x read, y written, w read once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rms_norm as RN
    from repro_torch.kernels.ref import rms_norm_ref

    g = torch.Generator(device=dev).manual_seed(5)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in RMS_SHAPES:
            x = (torch.randn(rows, d, generator=g, device=dev) * 2).to(dtype)
            w = torch.rand(d, generator=g, device=dev) + 0.5
            assert_close(RN.rms_norm_cuda(x, w), rms_norm_ref(x, w), dtype,
                         f"rms_norm {dtype} rows={rows} d={d}")
            n += 1
        flat = torch.randn(4 * 1024 + 1, generator=g, device=dev).to(dtype)
        x = flat[1:].view(4, 1024)
        w = torch.rand(1024, generator=g, device=dev)
        assert_close(RN.rms_norm_cuda(x, w), rms_norm_ref(x, w), dtype,
                     f"rms_norm {dtype} misaligned rows")
        n += 1
    torch.cuda.synchronize()
    log(f"rms_norm: {n} cases within tolerance of the plain version")
    rows_out = {}
    for rows, d in RMS_SHAPES[:4]:
        dt = torch.bfloat16
        x = (torch.randn(rows, d, generator=g, device=dev) * 2).to(dt)
        w = torch.rand(d, generator=g, device=dev) + 0.5
        w_lib = w.to(dt)
        err = assert_close(RN.rms_norm_cuda(x, w), rms_norm_ref(x, w), dt, "timing input")
        nbytes = 2 * 2 * rows * d + 4 * d
        flops = 4.0 * rows * d
        t = dict(ms=timer.ms(lambda: RN.rms_norm_cuda(x, w)),
                 plain_ms=timer.ms(lambda: rms_norm_ref(x, w)),
                 library_ms=timer.ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-6)),
                 bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                 flops=flops, bytes=nbytes, err=err)
        rows_out[(rows, d)] = t
        log(f"rms_norm bf16 rows={rows} d={d}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library (F.rms_norm) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms (bytes), max abs err {err:.3e}")
    return rows_out


def phase_flash(dev, timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (256, 1024):
            for causal in (True, False):
                cases.append((dtype, 4, 12, 12, S, S, causal))
        cases.append((dtype, 4, 12, 4, 256, 256, True))  # GQA, 3 groups
        cases.append((dtype, 4, 12, 12, 256, 1024, True))  # Sq < Sk, offset Sk-Sq
    worst = 0.0
    for dtype, B, H, KVH, Sq, Sk, causal in cases:
        q, k, v = flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sk)
        scale = 1.0 / 8.0
        got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=causal)
        want = FA.flash_attention_plain(q, k, v, scale=scale, causal=causal)
        what = f"flash {dtype} B={B} H={H} KVH={KVH} Sq={Sq} Sk={Sk} causal={causal}"
        assert_close(got, want, dtype, what)
        if dtype == torch.bfloat16:
            worst = max(worst, assert_flash_rounding(got, want, q, k, v, scale, causal, what))
    # one query row; more query rows than keys, causal: rows that see no
    # key write 0 exactly, the others match the plain version
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(g, dev, dtype, 4, 12, 4, 1, 256)
        got = FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True)
        want = FA.flash_attention_plain(q, k, v, scale=0.125, causal=True)
        assert_close(got, want, dtype, f"flash {dtype} Sq=1 Sk=256")
        if dtype == torch.bfloat16:
            worst = max(worst, assert_flash_rounding(got, want, q, k, v, 0.125, True,
                                                     "flash Sq=1 Sk=256"))
        q, k, v = flash_inputs(g, dev, dtype, 2, 12, 12, 300, 100)
        got = FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True)
        want = FA.flash_attention_plain(q, k, v, scale=0.125, causal=True)
        check(bool((got[:, :, :200] == 0).all()), f"flash {dtype} Sq=300 Sk=100: a row "
              "that sees no key is not 0")
        assert_close(got[:, :, 200:], want[:, :, 200:], dtype, f"flash {dtype} Sq=300 Sk=100")
        if dtype == torch.bfloat16:
            worst = max(worst, assert_flash_rounding(
                got[:, :, 200:], want[:, :, 200:], q[:, :, 200:], k, v, 0.125, True,
                "flash Sq=300 Sk=100"))
    # a strided (transposed-view) input, as the model hands over v
    x = (torch.randn(4, 256, 12, 64, generator=g, device=dev) * QK_STD).to(torch.bfloat16)
    qs = x.transpose(1, 2)
    got = FA.flash_attention_cuda(qs, qs, qs, scale=0.125, causal=True)
    want = FA.flash_attention_plain(qs, qs, qs, scale=0.125, causal=True)
    assert_close(got, want, torch.bfloat16, "flash strided views")
    worst = max(worst, assert_flash_rounding(got, want, qs, qs, qs, 0.125, True,
                                             "flash strided views"))
    # every head dim the kernels are built for, the JAX kernel's 64, 96,
    # 112, 128 and 256 among them: bf16 takes the warpgroup kernel up to
    # 128 (96 and 112 padded to 128) and WMMA at 256, f32 the FMA kernel;
    # the shared memory the Python plan counts is what the entry point uses
    lib = FA._lib()
    n_dims = 0
    for D in FA.HEAD_DIMS:
        for dtype, kinds in ((torch.float32, ("fma",)), (torch.bfloat16, ("wgmma", "wmma"))):
            for kind in kinds:
                c_smem = lib.forge_flash_attention_smem(FA.DTYPE_CODES[dtype],
                                                        FA.VARIANT_CODES[kind], D)
                if kind == "wgmma" and D not in FA.WGMMA_HEAD_DIMS:
                    check(c_smem == -1, f"flash D={D}: the entry point has a wgmma kernel")
                else:
                    check(c_smem == FA.smem_bytes(kind, D) <= 232448,
                          f"flash {kind} D={D}: shared memory {FA.smem_bytes(kind, D)} "
                          f"(Python) vs {c_smem} (entry point)")
            for B, H, KVH, Sq, Sk, causal in FLASH_DIM_SHAPES:
                q, k, v = flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sk, D)
                scale = D ** -0.5
                FA.LAUNCHES.reset()
                got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=causal)
                kind = FA.variant(q, k, v)
                check(FA.LAUNCHES.variants == {kind: 1} and kind == (
                    "fma" if dtype == torch.float32
                    else "wgmma" if D in FA.WGMMA_HEAD_DIMS else "wmma"),
                      f"flash {dtype} D={D}: launches by variant {FA.LAUNCHES.variants}")
                want = FA.flash_attention_plain(q, k, v, scale=scale, causal=causal)
                what = (f"flash {dtype} D={D} ({kind}) B={B} H={H} KVH={KVH} Sq={Sq} Sk={Sk} "
                        f"causal={causal}")
                assert_close(got, want, dtype, what)
                if dtype == torch.bfloat16:
                    worst = max(worst, assert_flash_rounding(got, want, q, k, v, scale, causal,
                                                             what))
                n_dims += 1
    torch.cuda.synchronize()
    log(f"flash_attention: {len(cases) + 5 + n_dims} cases within tolerance of the plain "
        f"version, {n_dims} of them over head dims {FA.HEAD_DIMS} (inputs q, k std {QK_STD}, "
        f"v std 1; bf16: worst error / rounding bound {worst:.3e}, limit 1)")

    # timing at the full-sequence forward's shape: B=4, H=12, S=1024, D=64, causal, bf16
    B, H, S, D = 4, 12, 1024, 64
    dt = torch.bfloat16
    q, k, v = flash_inputs(g, dev, dt, B, H, H, S, S, D)
    got = FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True)
    want = FA.flash_attention_plain(q, k, v, scale=0.125, causal=True)
    err = assert_close(got, want, dt, "timing input")
    assert_flash_rounding(got, want, q, k, v, 0.125, True, "timing input")
    ms = timer.ms(lambda: FA.flash_attention_cuda(q, k, v, scale=0.125, causal=True))
    plain = timer.ms(lambda: FA.flash_attention_plain(q, k, v, scale=0.125, causal=True))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          scale=0.125))
    pairs = S * (S + 1) / 2  # visible (query, key) pairs of one causal head
    flops = 4.0 * B * H * D * pairs
    nbytes = 2 * 4 * B * H * S * D  # q, k, v read once, out written once
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"flash_attention bf16 B={B} H={H} S={S} D={D} causal: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    rows = {"apply": dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                          bytes=nbytes, err=err)}

    # bf16 D=128 with GQA, the width of the GQA configs still to port:
    # B=4, H=32, KVH=8, S=1024, causal, beside the library call
    B, H, KVH, S, D = 4, 32, 8, 1024, 128
    q, k, v = flash_inputs(g, dev, dt, B, H, KVH, S, S, D)
    scale = D ** -0.5
    got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=True)
    want = FA.flash_attention_plain(q, k, v, scale=scale, causal=True)
    err = assert_close(got, want, dt, "D=128 timing input")
    assert_flash_rounding(got, want, q, k, v, scale, True, "D=128 timing input")
    check(FA.variant(q, k, v) == "wgmma", "bf16 D=128 does not take the warpgroup kernel")
    ms = timer.ms(lambda: FA.flash_attention_cuda(q, k, v, scale=scale, causal=True))
    plain = timer.ms(lambda: FA.flash_attention_plain(q, k, v, scale=scale, causal=True))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                                          enable_gqa=True))
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KVH * S * D)  # q and out; k and v once
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"flash_attention bf16 B={B} H={H} KVH={KVH} S={S} D={D} causal (wgmma, padded layout "
        f"of two 64-column blocks): kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    rows["d128"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                        bytes=nbytes, err=err)

    # the served models' apply shapes, causal: qwen2.5-14b (H=40 on KVH=8,
    # 5 query heads a KV head), phi3.5-moe (32 on 8), qwen2-vl-72b (64 on
    # 8: groups of 8) at B=1, S=1024, D=128, and kimi-k2 (64 on 8, D=112,
    # padded to 128 in shared memory) at S=256
    for name, (B, H, KVH, S, D) in (("qwen", (1, 40, 8, 1024, 128)),
                                     ("phi", (1, 32, 8, 1024, 128)),
                                     ("vl", (1, 64, 8, 1024, 128)),
                                     ("kimi", (1, 64, 8, 256, 112))):
        rows[name] = gqa_flash_row(g, dev, timer, B, H, KVH, S, D, name)
    for name, shape in ED_FLASH:
        rows[f"encdec_{name}"] = encdec_flash_row(g, dev, timer, *shape, name)
    # phase 15's training forward: B8 H12 S128 D64, causal
    rows["train"] = gqa_flash_row(g, dev, timer, *TRAIN_FLASH, "forge-125m train")
    # phase 16 (d)'s tensor-parallel apply: 6 of the 12 heads a rank
    rows["tp"] = gqa_flash_row(g, dev, timer, *TP_FLASH_SHAPE[:2], TP_FLASH_SHAPE[1],
                               *TP_FLASH_SHAPE[2:], "forge-125m tensor-parallel rank")
    return rows


def encdec_flash_row(g, dev, timer, B, H, Sq, Sk, causal, name):
    """Flash at one of seamless-m4t-large-v2's shapes (D 64, H = KVH; causal
    only at Sq = Sk): checked in f32 and bf16 (the bf16 rounding bound
    too), then timed in bf16 beside the library call
    ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    D, scale = 64, 0.125
    kind = "causal" if causal else "non-causal"
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(g, dev, dtype, B, H, H, Sq, Sk, D)
        got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=causal)
        want = FA.flash_attention_plain(q, k, v, scale=scale, causal=causal)
        what = f"flash {dtype} B={B} H={H} Sq={Sq} Sk={Sk} D={D} {kind} (encdec {name})"
        err = assert_close(got, want, dtype, what)
        if dtype == torch.bfloat16:
            assert_flash_rounding(got, want, q, k, v, scale, causal, what)
            check(FA.variant(q, k, v) == "wgmma", f"{what}: not the warpgroup kernel")
    ms = timer.ms(lambda: FA.flash_attention_cuda(q, k, v, scale=scale, causal=causal))
    plain = timer.ms(lambda: FA.flash_attention_plain(q, k, v, scale=scale, causal=causal))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                          scale=scale))
    flops = 4.0 * B * H * D * (Sq * (Sq + 1) / 2 if causal else Sq * Sk)
    nbytes = 2 * (2 * B * H * Sq * D + 2 * B * H * Sk * D)  # q and out; k and v once
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"flash_attention bf16 B={B} H={H} Sq={Sq} Sk={Sk} D={D} {kind} (encdec {name}): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                bytes=nbytes, err=err)


def gqa_flash_row(g, dev, timer, B, H, KVH, S, D, name):
    """Flash at one model's ``apply`` shape, causal: checked in f32 and
    bf16 (and at a ragged S), then timed in bf16 beside the library call
    ``F.scaled_dot_product_attention`` with ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    dt = torch.bfloat16
    scale = D ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        for Sq in (S, 300):
            q, k, v = flash_inputs(g, dev, dtype, B, H, KVH, Sq, Sq, D)
            got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=True)
            want = FA.flash_attention_plain(q, k, v, scale=scale, causal=True)
            what = f"flash {dtype} B={B} H={H} KVH={KVH} S={Sq} D={D} causal ({name})"
            assert_close(got, want, dtype, what)
            if dtype == torch.bfloat16:
                assert_flash_rounding(got, want, q, k, v, scale, True, what)
    q, k, v = flash_inputs(g, dev, dt, B, H, KVH, S, S, D)
    got = FA.flash_attention_cuda(q, k, v, scale=scale, causal=True)
    err = assert_close(got, FA.flash_attention_plain(q, k, v, scale=scale, causal=True), dt,
                       f"{name} timing input")
    check(FA.variant(q, k, v) == "wgmma", f"{name} flash does not take the warpgroup kernel")
    ms = timer.ms(lambda: FA.flash_attention_cuda(q, k, v, scale=scale, causal=True))
    plain = timer.ms(lambda: FA.flash_attention_plain(q, k, v, scale=scale, causal=True))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                                          enable_gqa=True))
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KVH * S * D)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"flash_attention bf16 B={B} H={H} KVH={KVH} S={S} D={D} causal ({name} apply): "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                bytes=nbytes, err=err)


def rg_inputs(g, dev, dtype, B, T, D, with_h0):
    """x ~ N(0, 1), a ~ U(0.3, 0.999) (decays of the served range, where a
    wrong carry compounds over many steps), h0 ~ N(0, 1) or zeros."""
    import torch

    x = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    a = (0.3 + 0.699 * torch.rand(B, T, D, generator=g, device=dev)).to(dtype)
    h0 = (torch.randn(B, D, generator=g, device=dev) if with_h0
          else torch.zeros(B, D, device=dev))
    return x, a, h0


def phase_rg_lru(dev, timer):
    """The RG-LRU scan kernel against its plain version at the path's
    shapes in f32 and bf16 and at forced chunk lengths (``last`` bitwise
    ``h[:, -1]``); chained ``rg_lru_scan`` calls against one scan (bitwise
    where every call's plan is one chunk, else within the f32 tolerance);
    two calls bitwise equal; then its time at the served f32 shapes
    beside the plain version and the bound (bytes: x, a and out once
    each, plus h0).  No single PyTorch call computes a first-order linear
    recurrence, so there is no library time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as RG

    g = torch.Generator(device=dev).manual_seed(4)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, D, with_h0 in RG_SHAPES:
            x, a, h0 = rg_inputs(g, dev, dtype, B, T, D, with_h0)
            want = RG.rg_lru_plain(x, a, h0)
            what = (f"rg_lru {dtype} B={B} T={T} D={D} h0={'randn' if with_h0 else 'zeros'} "
                    f"plan {RG.plan(B, T, D)}")
            assert_close(RG.rg_lru_cuda(x, a, h0), want, dtype, what)
            h, last = RG.rg_lru_cuda(x, a, h0, last=True)
            assert_close(h, want, dtype, what + " (chunked)")
            check(torch.equal(last, h[:, -1]), f"{what}: last is not h[:, -1] bitwise")
            n += 2
            for steps in RG_FORCED_STEPS:  # plans the planner does not pick
                h, last = RG.rg_lru_cuda(x, a, h0, last=True, steps=steps)
                assert_close(h, want, dtype, f"{what} forced chunks of {steps} steps")
                check(torch.equal(last, h[:, -1]), f"{what} chunks of {steps}: last is not "
                                                   f"h[:, -1] bitwise")
                n += 1
        # chained rg_lru_scan calls carried through `last`, against one scan:
        # a one-chunk plan runs the sequential FMA chain, so where every
        # call's plan is one chunk the two are bitwise equal in f32; a
        # multi-chunk plan folds carries in another order, held by tolerance
        for B, T, D, cuts in RG_CHAINS:
            x, a, h0 = rg_inputs(g, dev, dtype, B, T, D, True)
            full = RG.rg_lru_cuda(x, a, h0)
            carry, parts = h0, []
            for lo, hi in zip((0,) + cuts, cuts + (T,)):
                h, carry = ops.rg_lru_scan(x[:, lo:hi], a[:, lo:hi], carry)
                parts.append(h)
            chained = torch.cat(parts, 1)
            plans = [RG.plan(B, hi - lo, D) for lo, hi in zip((0,) + cuts, cuts + (T,))]
            plans.append(RG.plan(B, T, D))
            what = f"rg_lru {dtype} T={T} chained at {cuts} (plans {plans})"
            if dtype == torch.float32 and all(c == 1 for c, _ in plans):
                check(torch.equal(chained, full), f"{what}: chained chunks != one scan")
            else:  # bf16 also rounds the carry between calls, as the JAX kernel's
                assert_close(chained, full, dtype, what)
                assert_close(chained, RG.rg_lru_plain(x, a, h0), dtype, what + " vs plain")
            n += 1
        check(any(c > 1 for B, T, D, cuts in RG_CHAINS for c, _ in
                  [RG.plan(B, hi - lo, D) for lo, hi in zip((0,) + cuts, cuts + (T,))]),
              "no chained call takes more than one chunk")
    # bitwise repeatable: the carries fold in chunk order however far a
    # block looks back
    reps = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, D in ((2, 1024, 2560), (4, 128, 2560), (3, 37, 100)):
            check(RG.plan(B, T, D)[0] > 1, f"rg_lru B={B} T={T}: one chunk")
            x, a, h0 = rg_inputs(g, dev, dtype, B, T, D, True)
            first = RG.rg_lru_cuda(x, a, h0)
            for _ in range(4):
                check(torch.equal(first, RG.rg_lru_cuda(x, a, h0)),
                      f"rg_lru {dtype} B={B} T={T}: two calls differ")
                reps += 1
    torch.cuda.synchronize()
    log(f"rg_lru: {n} cases within tolerance of the plain version (last bitwise h[:, -1]; "
        f"chunk lengths forced to {RG_FORCED_STEPS}; chained one-chunk calls equal one scan "
        f"bitwise, multi-chunk ones within tolerance); {reps} repeated calls bitwise equal")
    rg_graph_replays(dev, g)

    rows = {}
    for B, T, D, with_h0 in RG_SHAPES[:3] + (RG_TRAIN,):
        x, a, h0 = rg_inputs(g, dev, torch.float32, B, T, D, with_h0)
        err = assert_close(RG.rg_lru_cuda(x, a, h0), RG.rg_lru_plain(x, a, h0),
                           torch.float32, "rg_lru timing input")
        ms = timer.ms(lambda: RG.rg_lru_cuda(x, a, h0))
        plain = timer.ms(lambda: RG.rg_lru_plain(x, a, h0))
        nbytes = 4 * (3 * B * T * D + B * D)  # x, a read, out written, h0 read; f32
        flops = 2.0 * B * T * D
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        chunks, steps = RG.plan(B, T, D)
        log(f"rg_lru f32 B={B} T={T} D={D} (plan: {chunks} chunks of {steps} steps, "
            f"{chunks * B * -(-D // RG.CHANNELS)} blocks): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library none (no PyTorch call computes the recurrence), bound "
            f"{bound:.5f} ms (bytes), max abs err {err:.3e}")
        rows[(B, T)] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                            flops=flops, bytes=nbytes, err=err, plan=[chunks, steps])
    # the chunked entry point (rg_lru_chunked's port): the same launch
    # plus the (B, D) `last` store, at the first prefill shape
    B, T, D, _ = RG_SHAPES[0]
    x, a, h0 = rg_inputs(g, dev, torch.float32, B, T, D, True)
    err = assert_close(RG.rg_lru_cuda(x, a, h0, last=True)[1],
                       RG.rg_lru_chunked_plain(x, a, h0)[1], torch.float32, "rg_lru last")
    nbytes = 4 * (3 * B * T * D + 2 * B * D)
    rows["chunked"] = dict(ms=timer.ms(lambda: RG.rg_lru_cuda(x, a, h0, last=True)),
                           plain_ms=timer.ms(lambda: RG.rg_lru_chunked_plain(x, a, h0)),
                           library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           flops=2.0 * B * T * D, bytes=nbytes, err=err,
                           plan=list(RG.plan(B, T, D)))
    log(f"rg_lru chunked (h and last) f32 B={B} T={T} D={D}: kernel "
        f"{rows['chunked']['ms']:.4f} ms, plain {rows['chunked']['plain_ms']:.4f} ms, bound "
        f"{rows['chunked']['bound_ms']:.5f} ms (bytes)")
    return rows


def rg_graph_replays(dev, g):
    """The multi-chunk scan inside a CUDA graph (recurrentgemma's B4 x S128
    prefill shape, and a forced plan of 43 chunks): captured after a warm
    call on the capture stream, then replayed on new inputs; each replay
    within the f32 tolerance of the plain version and bitwise equal to an
    eager launch (its epoch advances on the device at every replay)."""
    import torch
    from repro_torch.kernels import rg_lru as RG

    for B, T, D, steps in ((4, 128, 2560, None), (2, 300, 300, 7)):
        x, a, h0 = rg_inputs(g, dev, torch.float32, B, T, D, True)
        chunks = RG.plan(B, T, D)[0] if steps is None else -(-T // steps)
        check(chunks > 1, f"rg_lru B={B} T={T}: one chunk")
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            RG.rg_lru_cuda(x, a, h0, steps=steps)  # the chunk state on the capture stream
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = RG.rg_lru_cuda(x, a, h0, steps=steps)
        errs = []
        for _ in range(3):
            nx, na, _ = rg_inputs(g, dev, torch.float32, B, T, D, True)
            x.copy_(nx)
            a.copy_(na)
            graph.replay()
            errs.append(assert_close(out, RG.rg_lru_plain(x, a, h0), torch.float32,
                                     f"rg_lru B={B} T={T} ({chunks} chunks) graph replay"))
            check(torch.equal(out, RG.rg_lru_cuda(x, a, h0, steps=steps)),
                  f"rg_lru B={B} T={T}: a graph replay differs from the eager launch")
        log(f"rg_lru B={B} T={T} D={D} ({chunks} chunks) captured in a CUDA graph: 3 replays "
            f"on new inputs within f32 tolerance of the plain version (max abs err "
            f"{max(errs):.3e}) and bitwise equal to eager launches")


def paged_inputs(seed, dev, dtype, B, H, KVH, D, ps, MP, NP, pos=None):
    """q, k, v std 1.5/1.5/1 (a peaky softmax); each row's table is a
    random non-contiguous choice of pages 1..NP-1; positions default to
    -1 (no key), page edges and the table's last slot."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((B, H, D)) * QK_STD).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((NP, ps, KVH, D)) * QK_STD).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((NP, ps, KVH, D)).astype(np.float32))
    pt = np.stack([1 + rng.choice(NP - 1, MP, replace=False) for _ in range(B)])
    if pos is None:
        edges = [-1, ps - 1, ps, MP * ps - 1, 2 * ps + 3]
        pos = [edges[(seed + b) % len(edges)] for b in range(B)]
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(pt.astype(np.int32)).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def assert_paged_rounding(got, want, q, k, v, pt, pos, window, what):
    """bf16 paged attention within 3u*(sum_j p_j|v_j| + |out|) of its plain
    version: the plain version rounds the probabilities to bf16 and both
    round the output once.  Returns the largest error-to-bound ratio."""
    from repro_torch.kernels import paged_attention as PA

    mass = PA.paged_attention_plain(q, k, v.abs(), pt, pos, window=window).float()
    err = (got.float() - want.float()).abs()
    bound = 3 * BF16_U * (mass + want.float().abs())
    worst = (err / bound.clamp_min(1e-30)).max().item()
    check(not (err > bound).any().item(),
          f"{what}: {int((err > bound).sum())} elements beyond 3u(sum p|v| + |out|) "
          f"(worst err/bound {worst:.3e})")
    return worst


def paged_timing(timer, dev, B, H, KVH, D, ps, MP, NP, pos_list, seed):
    """One bf16 timing row of the paged kernel beside its plain version,
    two library calls (gather_pages + F.scaled_dot_product_attention over
    the whole table, masked) and the bound: K and V of the live pages, q,
    out, the table and pos once; 4 x H x D operations a visible key."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import gather_pages

    dt = torch.bfloat16
    q, k, v, pt, pos = paged_inputs(seed, dev, dt, B, H, KVH, D, ps, MP, NP, pos=pos_list)
    got = PA.paged_attention_cuda(q, k, v, pt, pos)
    want = PA.paged_attention_plain(q, k, v, pt, pos)
    what = f"paged timing input B={B} H={H} KVH={KVH} D={D} MP={MP}"
    err = assert_close(got, want, dt, what)
    assert_paged_rounding(got, want, q, k, v, pt, pos, None, what)
    L = MP * ps
    keep = torch.arange(L, device=dev)[None, :] <= pos.long()[:, None]
    mask = keep[:, None, None, :]  # boolean keep-mask for F.sdpa
    ms = timer.ms(lambda: PA.paged_attention_cuda(q, k, v, pt, pos))
    plain = timer.ms(lambda: PA.paged_attention_plain(q, k, v, pt, pos))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], gather_pages(k, pt), gather_pages(v, pt), attn_mask=mask,
        **({"enable_gqa": True} if H != KVH else {})))
    live_pages = sum(p // ps + 1 for p in pos_list)
    nbytes = (live_pages * ps * KVH * D * 2 * 2  # K and V of the live pages, bf16
              + 2 * 2 * B * H * D  # q read, out written
              + 4 * (B * MP + B))  # table and pos
    flops = 4.0 * H * D * sum(p + 1 for p in pos_list)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    splits, chunk = PA.plan(B, H, KVH, D, ps, MP, None, dt)
    log(f"paged_attention bf16 B={B} H={H} KVH={KVH} D={D} ps={ps} pos={pos_list[:4]}"
        f"{'...' if len(pos_list) > 4 else ''} ({live_pages} live pages; plan: {splits} "
        f"splits, chunks of {chunk} pages, {B * KVH * splits} blocks): kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, library (2 calls: gather_pages + "
        f"F.scaled_dot_product_attention) {lib:.4f} ms, bound {bound:.5f} ms "
        f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}), "
        f"max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, flops=flops,
                bytes=nbytes, err=err, plan=[splits, chunk])


def phase_paged(dev, timer):
    """The paged-attention kernel against its plain version (every head
    dim, forced plans, bitwise repeatability), then its time at the
    served decode shape, at long context and with GQA at D=128, beside
    the plain version, two library calls and the bound."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as PA

    cases = []  # (B, H, KVH, D, ps, MP, NP, window)
    for B in (1, 2, 4):
        cases.append((B, 12, 12, 64, 16, 16, 129, None))
    cases += [(4, 12, 4, 64, 16, 16, 129, None), (4, 12, 12, 64, 16, 16, 129, 20),
              (2, 8, 8, 16, 16, 6, 20, 9), (2, 8, 4, 32, 16, 6, 20, None),
              (2, 4, 4, 128, 16, 6, 20, None), (3, 4, 2, 8, 8, 4, 13, None),
              (2, 8, 2, 96, 16, 6, 20, None), (2, 8, 2, 112, 16, 6, 20, 40),
              (3, 4, 1, 256, 16, 6, 20, None), (4, 32, 8, 128, 16, 16, 70, None),
              (4, 40, 8, 128, 16, 16, 70, None)]  # qwen2.5-14b: groups of 5 heads
    check({c[3] for c in cases} == set(PA.HEAD_DIMS), "paged cases miss a head dim")
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, H, KVH, D, ps, MP, NP, window) in enumerate(cases):
            q, k, v, pt, pos = paged_inputs(i, dev, dtype, B, H, KVH, D, ps, MP, NP)
            got = PA.paged_attention_cuda(q, k, v, pt, pos, window=window)
            want = PA.paged_attention_plain(q, k, v, pt, pos, window=window)
            what = (f"paged {dtype} B={B} H={H} KVH={KVH} D={D} ps={ps} MP={MP} "
                    f"window={window} pos={pos.tolist()} plan="
                    f"{PA.plan(B, H, KVH, D, ps, MP, window, dtype)}")
            assert_close(got, want, dtype, what)
            check(bool((got[pos < 0] == 0).all()), f"{what}: pos=-1 rows not zero")
            if dtype == torch.bfloat16:
                worst = max(worst, assert_paged_rounding(got, want, q, k, v, pt, pos, window,
                                                         what))
            n += 1
        # forced plans on the served shape with GQA 12/4: one block a row,
        # one split per page of the table, more splits than pages, chunks of
        # 1 to 8 pages; rows at pos = -1, page edges and the last table slot
        B, H, KVH, D, ps, MP, NP = 5, 12, 4, 64, 16, 16, 129
        q, k, v, pt, pos = paged_inputs(11, dev, dtype, B, H, KVH, D, ps, MP, NP)
        check(sorted(pos.tolist()) == [-1, 15, 16, 35, 255], f"forced-plan positions {pos}")
        for window in (None, 20):
            want = PA.paged_attention_plain(q, k, v, pt, pos, window=window)
            for forced in ((1, 1), (1, 8), (3, 2), (16, 1), (5, 3), (40, 1)):
                got = PA.paged_attention_cuda(q, k, v, pt, pos, window=window,
                                              plan_override=forced)
                what = f"paged {dtype} forced plan {forced} window={window}"
                assert_close(got, want, dtype, what)
                check(bool((got[pos < 0] == 0).all()), f"{what}: pos=-1 rows not zero")
                if dtype == torch.bfloat16:
                    worst = max(worst, assert_paged_rounding(got, want, q, k, v, pt, pos,
                                                             window, what))
                n += 1
    # bitwise repeatable: the partials merge in split order, whichever block
    # finishes last; the tickets are back at 0 after each call
    reps = 0
    for B, H, KVH, D, MP in ((4, 12, 12, 64, 16), (8, 12, 12, 64, 128), (4, 32, 8, 128, 128),
                             (4, 40, 8, 128, 128)):
        q, k, v, pt, pos = paged_inputs(3, dev, torch.bfloat16, B, H, KVH, D, 16, MP,
                                        1 + B * MP, pos=[MP * 16 - 1] * B)
        check(PA.plan(B, H, KVH, D, 16, MP, None, torch.bfloat16)[0] > 1,
              "the repeatability case does not split")
        first = PA.paged_attention_cuda(q, k, v, pt, pos)
        for _ in range(4):
            check(torch.equal(first, PA.paged_attention_cuda(q, k, v, pt, pos)),
                  f"paged B={B} H={H} KVH={KVH} D={D}: two calls differ")
            reps += 1
    torch.cuda.synchronize()
    tickets = [t for key, t in _build._SCRATCH.items() if key[0] == "paged_attention"]
    check(tickets and all(int(t.abs().sum()) == 0 for t in tickets),
          "paged tickets not re-armed")
    log(f"paged_attention: {n} cases within tolerance of the plain version, head dims "
        f"{PA.HEAD_DIMS} and 12 forced plans a dtype (bf16: worst error / rounding bound "
        f"{worst:.3e}, limit 1); {reps} repeated calls bitwise equal")

    # the shared memory the Python plan counts is what the entry point uses
    lib = PA._lib()
    for B, H, KVH, D, ps, MP, NP, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            chunk = PA.plan(B, H, KVH, D, ps, MP, window, dtype)[1]
            c_smem = lib.forge_paged_attention_smem(H // KVH, D, chunk * ps,
                                                    PA.DTYPE_CODES[dtype])
            check(c_smem == PA.smem_bytes(H, KVH, D, ps, chunk, dtype) <= PA.MAX_SMEM,
                  f"paged D={D} {dtype}: shared memory {PA.smem_bytes(H, KVH, D, ps, chunk, dtype)}"
                  f" (Python) vs {c_smem} (entry point)")

    rows = {}
    # the served decode shape: B=4, H=KVH=12, D=64, page 16, 16 pages a
    # row, 129 pages, positions of a mid-run tick
    rows["served"] = paged_timing(timer, dev, 4, 12, 12, 64, 16, 16, 129, [44, 52, 60, 71], 7)
    # long context: B=8, 128 live pages a row (K and V: 50.3 MB)
    rows["long"] = paged_timing(timer, dev, 8, 12, 12, 64, 16, 128, 1 + 8 * 128, [2047] * 8, 8)
    # GQA at D=128: B=4, H=32, KVH=8, 128 live pages a row (33.6 MB)
    rows["gqa128"] = paged_timing(timer, dev, 4, 32, 8, 128, 16, 128, 1 + 4 * 128, [2047] * 4, 9)
    # qwen2.5-14b's served shape, H=40 on KVH=8 (groups of 5: a quad of
    # heads and a tail of one): at the positions phase 12's scheduler
    # reaches (16 pages a row, max_len 256) and with 128 live pages a row
    rows["qwen_served"] = paged_timing(timer, dev, 4, 40, 8, 128, 16, 16, 1 + 4 * 16,
                                       [44, 52, 60, 71], 10)
    rows["qwen_pos2047"] = paged_timing(timer, dev, 4, 40, 8, 128, 16, 128, 1 + 4 * 128,
                                        [2047] * 4, 12)
    # phi3.5-moe's served shape, H=32 on KVH=8, at the same positions
    rows["phi_served"] = paged_timing(timer, dev, 4, 32, 8, 128, 16, 16, 1 + 4 * 16,
                                      [44, 52, 60, 71], 14)
    return rows


def phase_main_path(dev):
    """Serve, then ``apply``: each path's counts are zeroed just before it
    and read just after; the comparisons with the plain path come
    afterwards.  Returns the launches per path and kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import get_model

    cfg = get_config("forge-125m")  # full width: 12 layers, d 768, vocab 50257, bf16
    check(cfg.fuse == "forge" and cfg.dtype == "bfloat16", "forge-125m defaults changed")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    B, P, n_new, max_len = 4, 32, 32, 256  # the serve CLI's defaults
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    Ba, S = 4, 1024  # the full-sequence forward
    tokens = torch.randint(0, cfg.vocab, (Ba, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    server = BatchedServer(cfg, params, max_len=max_len, mode="interpret")

    reset_counts()
    res = server.generate(prompts, n_new)
    serve = counts()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits_apply = model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_first_ms = (time.perf_counter() - t0) * 1e3
    applied = counts()

    steps = P + n_new - 1
    check(res["tokens"].shape == (B, n_new), f"token shape {res['tokens'].shape}")
    check(serve["fused_linear"] == 3 * cfg.n_layers * steps,
          f"fused_linear launches {serve['fused_linear']} != 36 per decode step x {steps} steps")
    check(serve["flash_attention"] == 0 and serve["paged_attention"] == 0,
          f"masked contiguous decode attention launched flash {serve['flash_attention']} "
          f"and paged {serve['paged_attention']} times")
    check(serve["rg_lru"] == 0 and applied["rg_lru"] == 0, "a dense path launched rg_lru")
    check(applied["flash_attention"] == cfg.n_layers,
          f"apply: flash launches {applied['flash_attention']} != {cfg.n_layers}")
    check(applied["fused_linear"] == 3 * cfg.n_layers,
          f"apply: fused_linear launches {applied['fused_linear']} != {3 * cfg.n_layers}")
    check(tuple(logits_apply.shape) == (Ba, S, cfg.vocab),
          f"apply logits shape {tuple(logits_apply.shape)}")
    check(torch.isfinite(logits_apply).all().item(), "non-finite apply logits")
    log(f"serve {cfg.name} (bf16, {cfg.n_layers} layers) batch={B} prompt={P} gen={n_new}: "
        f"ttft {res['ttft_s'] * 1e3:.1f} ms (sequential prefill, first compile included), "
        f"decode p50 {res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
        f"{res['tok_per_s']:.0f} tok/s; fused_linear launches {serve['fused_linear']} = "
        f"{serve['fused_linear'] // steps} per decode step over {steps} steps, "
        f"flash {serve['flash_attention']}")
    log(f"apply B={Ba} S={S}: flash launches {applied['flash_attention']}, fused_linear "
        f"launches {applied['fused_linear']}, first call {apply_first_ms:.1f} ms "
        f"(compile included)")
    from repro_torch.models import _forge

    bodies = _forge.compiled_bodies()
    check(len(bodies) == 2, f"expected the decode and apply bodies compiled, got {len(bodies)}")
    for r in bodies:
        check(r.attention_fused == 1 and r.fused_ops == 4,
              f"a block body fused {r.fused_ops} ops ({r.attention_fused} attention)")
        s = r.executor_stats
        log(f"Forge-compiled block body: nodes {r.nodes_before} -> {r.nodes_after}, "
            f"fused ops {r.fused_ops} (1 forge.sdpa, 3 forge.linear_act), "
            f"{s.n_instructions} RGIR ops, delta {s.delta_before} -> {s.delta_after}, "
            f"{s.n_segments} segments, vregs {s.n_vregs} -> buffers {s.n_buffers}, "
            f"Phases 1-4 {r.total_ms:.0f} ms (capture {r.capture_ms:.0f} ms)")

    log_device_time(lambda: model.apply(params, tokens, cfg), f"apply B={Ba} S={S}")

    # a second generation on the same server: greedy tokens bitwise equal
    # (the split-K sums run in a fixed order, with no atomics)
    again = server.generate(prompts, n_new)["tokens"]
    check(np.array_equal(again, res["tokens"]), "two runs of the server gave other tokens")
    log(f"a second generation gave the same {again.size} greedy tokens")

    # comparisons with the plain path (their launches do not count)
    compare_served_step(model, cfg, server, prompts, BatchedServer)
    with torch.no_grad():
        t0 = time.perf_counter()
        model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        logits_apply_ref = model.apply(params, tokens, cfg, impl="ref")
        check(not any(counts().values()), "the impl='ref' apply launched a kernel")
        err = assert_close(logits_apply, logits_apply_ref, torch.bfloat16, "apply logits",
                           TOL_MODEL_BF16)
        log(f"apply logits within bf16 tolerance of the plain path (max abs err "
            f"{err:.3e}, {rel_l2(logits_apply, logits_apply_ref):.3e} relative L2); "
            f"steady call {apply_ms:.1f} ms host wall")
    busy_share(dev, server, prompts)
    return {"serve": serve, "apply": applied}


def kernel_modules():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import rg_lru as RG
    from repro_torch.kernels import rms_norm as RN

    return {"fused_linear": FL, "flash_attention": FA, "paged_attention": PA, "rg_lru": RG,
            "rms_norm": RN}


class Counts(dict):
    """Every kernel's launches (the dict), and in ``variants`` the
    fused-linear and flash launches by the kernel variant they took."""

    def __init__(self, launches, variants):
        super().__init__(launches)
        self.variants = variants


def counts():
    """Every kernel's launches since the last :func:`reset_counts`."""
    mods = kernel_modules()
    return Counts({name: mod.LAUNCHES.n for name, mod in mods.items()},
                  {name: dict(mods[name].LAUNCHES.variants)
                   for name in ("fused_linear", "flash_attention")})


def check_variants(launches):
    """Every bf16 fused-linear launch of the served paths took ``gemv``
    (decode rows) or ``wgmma``, never the ``wmma`` kernel kept for
    operands TMA cannot take; every flash launch took the warpgroup
    kernel (``wgmma``), but at recurrentgemma-2b's head dim 256, which
    only the ``wmma`` kernel serves; phase 16 (e)'s f32 launches took the
    ``fma`` kernels."""
    for path, n in launches.items():
        fl, fa = n.variants["fused_linear"], n.variants["flash_attention"]
        # phase 16 (e) runs in f32: the fma kernels
        check(sum(fl.values()) == n["fused_linear"]
              and set(fl) <= ({"fma"} if path in EP_MESHES else {"gemv", "wgmma"}),
              f"{path}: fused_linear launches by variant {fl} (of {n['fused_linear']})")
        # recurrentgemma-2b's head dim 256 has no wgmma kernel (its O
        # accumulator does not fit beside the scores): wmma is its kernel
        allowed = {"wmma"} if path in ("rglru_apply", "rglru_train") else {"wgmma"}
        if path in EP_MESHES:
            allowed = {"fma"}
        check(sum(fa.values()) == n["flash_attention"] and set(fa) <= allowed,
              f"{path}: flash launches by variant {fa} (of {n['flash_attention']})")
        log(f"variants on {path}: fused_linear {fl}, flash_attention {fa}")
    check(launches["apply"].variants["flash_attention"] == {"wgmma": 12},
          f"apply: flash launches by variant {launches['apply'].variants['flash_attention']}")


def reset_counts():
    for mod in kernel_modules().values():
        mod.LAUNCHES.reset()


def rel_l2(got, want):
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm()).item()


def compare_served_step(model, cfg, server, prompts, server_cls):
    """The kernel server against the same server with ``impl="ref"``:
    each prefills the prompts into its own cache, then both run the first
    generated step (at position P, on a filled cache) from the same token.
    The caches, the step's logits and its greedy tokens are held against
    each other."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL

    ref_server = server_cls(cfg, server.params, max_len=server.max_len, mode="interpret",
                            impl="ref")
    with torch.no_grad():
        cache, tok, pos, _, _ = server.prefill(prompts)
        reset_counts()
        cache_ref, tok_ref, _, _, _ = ref_server.prefill(prompts)
        logits_ref, _ = model.decode_step(server.params, cache_ref, tok, pos, cfg, impl="ref")
        check(FL.LAUNCHES.n == 0 and FA.LAUNCHES.n == 0,
              "the impl='ref' server launched a kernel")
        logits, _ = model.decode_step(server.params, cache, tok, pos, cfg)
    P = prompts.shape[1]
    for name in ("k", "v"):
        err = assert_close(cache[name][:, :, :, :P], cache_ref[name][:, :, :, :P],
                           torch.bfloat16, f"prefilled {name} cache", TOL_MODEL_BF16)
        log(f"prefilled {name} cache ({P} positions) within bf16 tolerance of impl='ref' "
            f"(max abs err {err:.3e}, {rel_l2(cache[name], cache_ref[name]):.3e} relative L2)")
    check(torch.isfinite(logits).all().item(), "non-finite decode logits")
    err = assert_close(logits, logits_ref, torch.bfloat16, f"decode logits at pos {pos}",
                       TOL_MODEL_BF16)
    # greedy tokens: the kernel's choice must be a top choice of the
    # plain path, within twice the elementwise tolerance of its best logit
    last, last_ref = logits[:, -1].float(), logits_ref[:, -1].float()
    pick = last.argmax(-1)
    best = last_ref.max(-1).values
    slack = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
    check(bool((last_ref.gather(-1, pick[:, None])[:, 0] >= best - slack).all()),
          "a greedy token of the kernel server is no top choice of the plain path")
    same = int((pick == last_ref.argmax(-1)).sum())
    same_prefill = int((tok == tok_ref).sum())
    log(f"served step at pos {pos} logits {tuple(logits.shape)} within bf16 tolerance of "
        f"BatchedServer(impl='ref') (max abs err {err:.3e}, "
        f"{rel_l2(logits, logits_ref):.3e} relative L2); greedy tokens equal in "
        f"{same}/{len(pick)} rows at pos {pos} and {same_prefill}/{len(pick)} after the "
        f"prefill")


def linear_nodes(mod):
    """fused-linear launches one call of a compiled program makes: its
    ``forge.linear_act`` nodes, two for each ``forge.swiglu`` (the gate and
    the up projection), plus the fused-linear kernel calls the capture met
    inside Forge-compiled block bodies."""
    return sum({"forge.linear_act": 1, "forge.swiglu": 2,
                "repro_torch.fused_linear.default": 1}.get(n.op, 0)
               for n in mod.graph.nodes.values())


def flash_nodes(mod):
    """Flash launches one call of a compiled program makes: its unmasked
    ``forge.sdpa`` nodes (``ops.sdpa`` routes them to the kernel, one
    query row included) plus the kernel calls the capture met."""
    return sum((n.op == "forge.sdpa" and not n.params["has_mask"])
               or n.op == "repro_torch.flash_attention.default"
               for n in mod.graph.nodes.values())


def paged_workload(vocab):
    """12 requests, 4 arriving per tick: prompts of 12, 24 or 40 tokens,
    the four 40-token prompts sharing their first 32 tokens (2 pages), so
    later admissions hit the prefix tree; budgets of 8 to 32 tokens."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, (32,)).astype(np.int32)
    reqs = []
    for i in range(12):
        kind = i % 3
        if kind == 0:
            prompt = np.concatenate([shared, rng.integers(0, vocab, (8,)).astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab, (12 if kind == 1 else 24,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=8 + (5 * i) % 25, arrival=i // 4))
    return reqs


def phase_paged_serve(dev):
    """Slot-level continuous batching over the paged KV pool at full width
    with the paged-attention kernel; returns this path's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import ForgeCompiler
    from repro_torch.core.paging import build_row_table
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import get_model

    cfg = get_config("forge-125m").with_(kv_kernel="pallas")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    server = BatchedServer(cfg, params, max_len=256, mode="forge", paged=True,
                           kv_page_size=16, seq_bucket_policy="ladder:16,32,64,128,256")
    sched = SlotScheduler(server, max_slots=4)
    reqs = paged_workload(cfg.vocab)
    t0 = time.perf_counter()
    # the programs the workload dispatches: decode rungs 2 and 4, the B4
    # cells of its prompt lengths, and the B2 x S16 cell check_served_prefill
    # holds (the schedule admits on rung 4 only: the B2 x S32 and B2 x S64
    # cells would never run)
    warm_s = warm_graphs("paged", lambda: server.warmup([2], [16]) + server.warmup(
        [4], sorted({len(r.prompt) for r in reqs})))
    caps = captures_now()
    for front, name in ((server.bucketed, "decode"), (server.prefill_bucketed, "prefill")):
        for key, mod in front.programs.items():
            r = mod.result
            log(f"  {name} program {key}: Phases 1-4 {r.total_ms:.0f} ms (torch.export "
                f"{r.capture_ms:.0f} ms, CUDA graphs {r.capture_s:.2f} s, "
                f"{r.executor_stats.n_segments} segments), "
                f"{front.stats.per_bucket_compile_s[str(key)]:.2f} s "
                f"in all; nodes {r.nodes_before} -> {r.nodes_after}, "
                f"{r.executor_stats.n_instructions} RGIR ops, {linear_nodes(mod)} fused-linear "
                f"and {sum(n.op == 'repro_torch.paged_attention.default' for n in mod.graph.nodes.values())} "
                f"paged-attention nodes")
    log(f"paged warmup: {len(server.bucketed.programs)} decode + "
        f"{len(server.prefill_bucketed.programs)} prefill programs in {warm_s:.1f} s "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    calls0 = {f: dict(f.stats.per_bucket_calls) for f in (server.bucketed,
                                                          server.prefill_bucketed)}
    reset_counts()
    res = sched.run(reqs)
    torch.cuda.synchronize()
    launched = counts()

    pool, tree = server.page_pool, server.prefix_tree
    for r in reqs:
        got = res["results"][r.rid]
        check("error" not in got, f"request {r.rid} failed: {got.get('error')}")
        check(len(got["tokens"]) == r.max_new,
              f"request {r.rid}: {len(got['tokens'])} tokens, budget {r.max_new}")
    check(res["swaps"] >= 1 and res["prefix_hits"] >= 1,
          f"swaps {res['swaps']}, prefix hits {res['prefix_hits']}")
    pool.check()
    check(pool.pages_in_use == 1 + tree.cached_pages,
          f"pages in use {pool.pages_in_use} != 1 + {tree.cached_pages} cached")
    check(res["compiles"] == 0 and captures_now() == caps,
          f"{res['compiles']} compiles after warmup, captures {captures_now()} after {caps}")
    check(launched["paged_attention"] == cfg.n_layers * res["decode_dispatches"],
          f"paged launches {launched['paged_attention']} != {cfg.n_layers} x "
          f"{res['decode_dispatches']} decode dispatches")
    want_fl = 0
    for front in (server.bucketed, server.prefill_bucketed):
        for key, mod in front.programs.items():
            k = str(key)
            want_fl += linear_nodes(mod) * (front.stats.per_bucket_calls.get(k, 0)
                                            - calls0[front].get(k, 0))
    check(launched["fused_linear"] == want_fl,
          f"fused_linear launches {launched['fused_linear']} != {want_fl} predicted from "
          f"the programs' linear nodes x dispatches")
    check(launched["flash_attention"] == 0 and launched["rg_lru"] == 0,
          f"flash launched {launched['flash_attention']}, rg_lru {launched['rg_lru']} times")
    log(f"paged serve {cfg.name} (bf16, kv_kernel=pallas, max_slots 4, page 16, "
        f"{pool.num_pages} pages): {len(reqs)} requests, {res['real_tokens']} tokens, "
        f"{res['tok_per_s']:.1f} tok/s, tick p50 {res['tick_ms_p50']:.2f} ms p99 "
        f"{res['tick_ms_p99']:.2f} ms, TTFT p50 {res['ttft_p50_ticks']:.1f} ticks "
        f"{res['ttft_p50_s'] * 1e3:.2f} ms; decode dispatches {res['decode_dispatches']}, "
        f"prefill dispatches {res['prefill_dispatches']}, swaps {res['swaps']}, resizes "
        f"{res['resizes']}, deferrals {res['deferrals']}, prefix hits {res['prefix_hits']} "
        f"({res['tokens_reused']} tokens reused), peak pages {res['kv_peak_pages_in_use']}, "
        f"occupancy {res['occupancy']:.3f}; launches {launched}")

    check_served_prefill(model, cfg, params, server, reqs[0].prompt, dev)

    # one decode tick from the server's page store, held against impl="ref":
    # four rows on the shared prompt prefix's cached pages plus a fresh page
    # each, writing at positions 32..35
    chain, n_tok = tree.match(reqs[0].prompt, max_tokens=32)
    check(n_tok == 32, f"the shared prefix is not cached ({n_tok} tokens)")
    B, MP = 4, server.max_pages_per_slot
    own = [pool.alloc(2) for _ in range(B)]  # positions 32..63: the steady ticks below
    pt = torch.from_numpy(np.stack([build_row_table(chain + o, MP) for o in own])).to(dev)
    pos = torch.tensor([32, 33, 34, 35], dtype=torch.int32, device=dev)
    tok = torch.tensor([[t % cfg.vocab] for t in (11, 222, 3333, 44444)], dtype=torch.int32,
                       device=dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    store = server.page_store

    def logits_step(p, st, pt_, tok_, pos_, mask_):
        cache = dict(st, page_table=pt_)
        return model.paged_decode_step(p, cache, tok_, pos_, cfg, slot_mask=mask_)[0]

    with torch.no_grad():
        logits_prog = ForgeCompiler().compile(logits_step, params, store, pt, tok, pos, mask)
        logits = logits_prog(params, store, pt, tok, pos, mask)
        reset_counts()
        logits_ref, _ = model.paged_decode_step(params, dict(store, page_table=pt), tok, pos,
                                                cfg, slot_mask=mask, impl="ref")
        check(FL.LAUNCHES.n == 0 and PA.LAUNCHES.n == 0 and FA.LAUNCHES.n == 0,
              "the impl='ref' paged step launched a kernel")
        mod = server.bucketed.lookup_program(server.bucketed.key_for_extents(B))
        served_tok, _ = mod(params, store, pt, tok, pos, mask)
    check(torch.isfinite(logits).all().item(), "non-finite paged decode logits")
    err = assert_close(logits, logits_ref, torch.bfloat16, "paged decode tick logits",
                       TOL_MODEL_BF16)
    last, last_ref = logits[:, -1].float(), logits_ref[:, -1].float()
    best = last_ref.max(-1).values
    slack = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
    for name, pick in (("compiled logits", last.argmax(-1)),
                       ("served program", served_tok[:, 0].long())):
        check(bool((last_ref.gather(-1, pick[:, None])[:, 0] >= best - slack).all()),
              f"a greedy token of the {name} is no top choice of the impl='ref' step")
    same = int((served_tok[:, 0].long() == last_ref.argmax(-1)).sum())
    log(f"paged decode tick at pos 32..35 on the cached prefix pages within bf16 tolerance "
        f"of impl='ref' (max abs err {err:.3e}, {rel_l2(logits, logits_ref):.3e} relative "
        f"L2); served greedy tokens equal to the plain path's in {same}/{B} rows")

    # segment_jit against interpret: the decode tick above and one prefill
    # dispatch of the B4 x S16 cell on the same rows (chunks at 32..47 on
    # each row's own page), then the host/device split of steady decode
    # ticks under both backends: the served program fed its own output, as
    # the scheduler's device-resident fast path does
    fronts = (server.bucketed, server.prefill_bucketed)
    twins = interpret_twins(fronts)
    ptoks = torch.randint(0, cfg.vocab, (B, 16), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(13))
    ppos = torch.full((B,), 32, dtype=torch.int32, device=dev)
    with torch.no_grad():
        hold_against_interpret("paged", [
            ("decode", server.bucketed.key_for_extents(B), 0,
             (params, store, pt, tok, pos, mask)),
            ("prefill", server.prefill_bucketed.key_for_extents((B, 16)), 1,
             (params, store, pt, ptoks, ppos, mask))], fronts, twins)

    def ticks():
        st = {"tok": tok, "pos": pos, "store": store}
        prog = server.bucketed.lookup_program(server.bucketed.key_for_extents(B))

        def one():
            st["tok"], st["store"] = prog(params, st["store"], pt, st["tok"], st["pos"], mask)
            st["pos"] = st["pos"] + 1

        return one

    backend_split("paged decode tick (B=4)", fronts, twins, ticks, mod)
    for o in own:
        pool.free(o)
    pool.check()
    return launched


def check_served_prefill(model, cfg, params, server, shared_prompt, dev):
    """One dispatch of two served prefill programs against impl="ref", each
    side on its own copy of the page store taken before it.  Rows: cold
    prompts (edge-padded and full), a row on the cached shared prefix
    (anchored at position 32) and a masked row.  The admitted rows'
    logits and the pages they wrote must agree within TOL_MODEL_BF16;
    the cached prefix pages and the masked row's pages stay bitwise
    untouched."""
    import numpy as np
    import torch
    from repro_torch.core.paging import build_row_table, pages_for
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import paged_attention as PA

    pool, tree = server.page_pool, server.prefix_tree
    ps, MP = pool.page_size, server.max_pages_per_slot
    chain, n_tok = tree.match(shared_prompt, max_tokens=32)
    check(n_tok == 32, f"the shared prefix is not cached ({n_tok} tokens)")
    rng = np.random.default_rng(5)
    # (B, S) cell -> rows (kind, real length): M = B*S is 32 (a partial
    # row tile of the fused-linear kernel) and 256
    cells = {(2, 16): [("cold", 13), ("hit", 16)],
             (4, 64): [("cold", 40), ("hit", 8), ("cold", 64), ("masked", 0)]}
    for (B, S), rows in cells.items():
        key = server.prefill_bucketed.key_for_extents((B, S))
        pmod = server.prefill_bucketed.lookup_program(key)
        check(pmod is not None, f"prefill cell {key} was not compiled in warmup")
        pt = np.zeros((B, MP), np.int32)
        tokens = np.zeros((B, S), np.int32)
        pos = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        own = []
        for i, (kind, L) in enumerate(rows):
            start = 32 if kind == "hit" else 0
            shared = list(chain) if kind == "hit" else []
            # fresh pages cover every position the row's chunk writes
            own.append(pool.alloc(pages_for(start + S, ps) - len(shared)))
            pt[i] = build_row_table(shared + own[-1], MP)
            if kind != "masked":
                suffix = rng.integers(0, cfg.vocab, (L,))
                tokens[i, :L], tokens[i, L:] = suffix, suffix[-1]
                mask[i], pos[i] = True, start
        args = [torch.from_numpy(a).to(dev) for a in (pt, tokens, pos, mask)]
        before = {k: v.clone() for k, v in server.page_store.items()}
        with torch.no_grad():
            logits, store = pmod(params, {k: v.clone() for k, v in before.items()}, *args)
            reset_counts()
            cache = dict({k: v.clone() for k, v in before.items()}, page_table=args[0])
            logits_ref, cache_ref = model.paged_prefill_step(
                params, cache, args[1], args[2], cfg, slot_mask=args[3], impl="ref")
            check(FL.LAUNCHES.n == 0 and PA.LAUNCHES.n == 0,
                  "the impl='ref' paged prefill launched a kernel")
        torch.cuda.synchronize()
        errs = {"logits": 0.0, "pages": 0.0}
        for i, (kind, L) in enumerate(rows):
            for name in ("k_pages", "v_pages"):
                keep = own[i] if kind == "masked" else list(chain) if kind == "hit" else []
                for side, got in (("served", store), ("impl='ref'", cache_ref)):
                    check(torch.equal(got[name][:, keep], before[name][:, keep]),
                          f"prefill {key} row {i} ({kind}): {side} wrote {name} it must not")
                if kind != "masked":
                    errs["pages"] = max(errs["pages"], assert_close(
                        store[name][:, own[i]], cache_ref[name][:, own[i]], torch.bfloat16,
                        f"prefill {key} row {i} ({kind}) {name}", TOL_MODEL_BF16))
            if kind == "masked":
                continue
            errs["logits"] = max(errs["logits"], assert_close(
                logits[i, :L], logits_ref[i, :L], torch.bfloat16,
                f"prefill {key} row {i} ({kind}) logits", TOL_MODEL_BF16))
            # the first token: a top choice of the plain path
            last, last_ref = logits[i, L - 1].float(), logits_ref[i, L - 1].float()
            best = last_ref.max()
            slack = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
            check(bool(last_ref[last.argmax()] >= best - slack),
                  f"prefill {key} row {i}: the served first token is no top choice of "
                  f"impl='ref'")
        for pages in own:
            pool.free(pages)
        pool.check()
        log(f"served prefill {key} (M={B * S} fused-linear rows; rows "
            f"{[k for k, _ in rows]}) within bf16 tolerance of impl='ref': logits max abs "
            f"err {errs['logits']:.3e}, written K/V pages {errs['pages']:.3e}; prefix and "
            f"masked pages untouched")


def program_log(front, name):
    """One line per program of a contiguous front: compile seconds, nodes,
    RGIR ops and the kernel, fused and opaque nodes it holds."""
    for key, mod in front.programs.items():
        r = mod.result
        ops_ = [n.op for n in mod.graph.nodes.values()
                if n.op.startswith(("forge", "repro_torch."))]
        log(f"  {name} program {key}: Phases 1-4 {front.stats.per_bucket_compile_s[str(key)]:.2f} s "
            f"(torch.export {r.capture_ms / 1e3:.2f} s, passes {r.optimize_ms / 1e3:.2f} s, "
            f"CUDA graphs {r.capture_s:.2f} s over {r.executor_stats.n_segments} segments); nodes "
            f"{r.nodes_before} -> {r.nodes_after}, {r.executor_stats.n_instructions} RGIR ops, "
            f"{linear_nodes(mod)} fused-linear; {dict(sorted((o, ops_.count(o)) for o in set(ops_)))}")


def phase_rglru(dev):
    """recurrentgemma-2b at full width, RG_LAYERS deep, through the
    contiguous forge fronts, the contiguous SlotScheduler on them, then
    ``apply``, and the async compile and restart contract of phase 10 on
    its contiguous fronts (:func:`async_front`); returns the launches of
    each path."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import _forge, get_model

    # d 2560, vocab 256000, bf16; 3 of the 26 layers
    cfg = get_config("recurrentgemma-2b").with_(n_layers=RG_LAYERS)
    check(cfg.fuse == "forge" and cfg.dtype == "bfloat16", "recurrentgemma-2b defaults changed")
    model = get_model(cfg)
    n_rec = sum(k == "rec" for k in model.module._pattern(cfg))
    check(n_rec == 2 and cfg.n_layers == 3, f"{n_rec} rec layers of {cfg.n_layers}")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in {id(t): t for t in pytree.tree_leaves(params)}.values())
    B, P, n_new, max_len = 4, 32, 32, 256
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    # batch rungs 2 and 4, one sequence cell (S32): the served cells only,
    # the scheduler's resizes included (as phase 7's)
    server = BatchedServer(cfg, params, max_len=max_len, mode="forge",
                           bucket_policy="ladder:2,4", seq_bucket_policy="ladder:32")
    warm_s = warm_graphs("recurrentgemma-2b",
                         lambda: server.warmup([2]) + server.warmup([B], [P]))
    caps = captures_now()
    program_log(server.bucketed, "decode")
    program_log(server.prefill_bucketed, "prefill")
    log(f"recurrentgemma-2b ({n_params / 1e9:.3f} B parameters, bf16) warmup: "
        f"{len(server.bucketed.programs)} decode + {len(server.prefill_bucketed.programs)} "
        f"prefill programs in {warm_s:.1f} s")
    fronts = (server.bucketed, server.prefill_bucketed)
    compiles0 = [f.stats.compiles for f in fronts]

    def run(policy):
        server.prefill_policy = policy
        calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
        reset_counts()
        res = server.generate(prompts, n_new)
        torch.cuda.synchronize()
        launched = counts()
        dispatches = [{k: f.stats.per_bucket_calls.get(k, 0) - c0.get(k, 0)
                       for k in f.stats.per_bucket_calls} for f, c0 in zip(fronts, calls0)]
        want_fl = sum(linear_nodes(mod) * d.get(str(key), 0)
                      for f, d in zip(fronts, dispatches) for key, mod in f.programs.items())
        n_prefill = sum(dispatches[1].values())
        check(res["tokens"].shape == (B, n_new), f"token shape {res['tokens'].shape}")
        check(res["compile_s"] == 0.0 and [f.stats.compiles for f in fronts] == compiles0
              and captures_now() == caps,
              f"prefill={policy}: a program compiled or captured after warmup")
        check(launched["rg_lru"] == n_rec * n_prefill,
              f"prefill={policy}: rg_lru launches {launched['rg_lru']} != {n_rec} x "
              f"{n_prefill} prefill dispatches (decode launches none)")
        check(launched["fused_linear"] == want_fl,
              f"prefill={policy}: fused_linear launches {launched['fused_linear']} != {want_fl} "
              f"predicted from the programs' linear nodes x dispatches")
        check(launched["flash_attention"] == 0 and launched["paged_attention"] == 0,
              f"prefill={policy}: flash {launched['flash_attention']}, paged "
              f"{launched['paged_attention']} launches")
        log(f"serve recurrentgemma-2b prefill={policy} ({res['prefill_mode']}) batch={B} "
            f"prompt={P} gen={n_new}: ttft {res['ttft_s'] * 1e3:.2f} ms, decode p50 "
            f"{res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
            f"{res['tok_per_s']:.1f} tok/s; {n_prefill} prefill and "
            f"{sum(dispatches[0].values())} decode dispatches; launches {launched}")
        return res, launched

    res, served = run("auto")
    check(res["prefill_mode"] == "chunked", f"prefill mode {res['prefill_mode']}")
    res_seq, sequential = run("sequential")
    check(sequential["rg_lru"] == 0, "the decode program launched rg_lru")
    server.prefill_policy = "auto"
    scheduled = rglru_scheduler(server, cfg, n_rec, compiles0, caps)

    Ba, S = 2, 1024
    tokens = torch.randint(0, cfg.vocab, (Ba, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        n_bodies = len(_forge.compiled_bodies())
        t0 = time.perf_counter()
        model.apply(params, tokens, cfg)  # compiles the two Forge bodies
        torch.cuda.synchronize()
        apply_first_s = time.perf_counter() - t0
        bodies = {k: v for k, v in _forge._CACHE.items() if "recurrentgemma-2b" in k}
        check(len(_forge.compiled_bodies()) == n_bodies + 2 and len(bodies) == 2,
              "apply did not compile one rec and one attn body")
        reset_counts()
        t0 = time.perf_counter()
        logits = model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        applied = counts()
    fl_apply = sum(linear_nodes(mod) * (n_rec if "/rec" in k else cfg.n_layers - n_rec)
                   for k, mod in bodies.items())
    check(applied["rg_lru"] == n_rec, f"apply: rg_lru launches {applied['rg_lru']} != {n_rec}")
    check(applied["fused_linear"] == fl_apply,
          f"apply: fused_linear launches {applied['fused_linear']} != {fl_apply}")
    # at S = 1024 <= window 2048 the banded mask folds to the causal
    # pattern, which attention fusion reads as the kernel's causal mode (as
    # the JAX package's constant folding does): flash, at D = 256 its wmma
    # kernel, once a local-attention layer
    fa_apply = sum(flash_nodes(mod) * (n_rec if "/rec" in k else cfg.n_layers - n_rec)
                   for k, mod in bodies.items())
    check(applied["flash_attention"] == fa_apply and applied["paged_attention"] == 0,
          f"apply: flash launches {applied['flash_attention']} != {fa_apply} predicted from "
          f"the bodies' unmasked forge.sdpa nodes, paged {applied['paged_attention']}")
    check(tuple(logits.shape) == (Ba, S, cfg.vocab) and torch.isfinite(logits).all().item(),
          f"apply logits shape {tuple(logits.shape)} or non-finite values")
    for k, mod in bodies.items():
        r = mod.result
        log(f"  apply body {'rec' if '/rec' in k else 'attn'}: nodes {r.nodes_before} -> "
            f"{r.nodes_after}, fused ops {r.fused_ops} ({r.attention_fused} attention), "
            f"{linear_nodes(mod)} fused-linear nodes, Phases 1-4 {r.total_ms / 1e3:.2f} s")
    log(f"apply B={Ba} S={S}: rg_lru launches {applied['rg_lru']}, fused_linear "
        f"{applied['fused_linear']}, flash {applied['flash_attention']}; first call "
        f"{apply_first_s:.1f} s (compile included), steady call {apply_ms:.1f} ms host wall")

    log_device_time(lambda: model.apply(params, tokens, cfg), f"apply B={Ba} S={S}")

    # comparisons with the plain path (their launches do not count)
    ref_mod = check_contiguous_prefill(model, cfg, params, server, dev)
    compare_greedy_tokens(model, cfg, params, prompts, res["tokens"], dev, server, ref_mod)
    with torch.no_grad():
        reset_counts()
        logits_ref = model.apply(params, tokens, cfg, impl="ref")
        check(not any(counts().values()), "the impl='ref' apply launched a kernel")
    check(torch.isfinite(logits).all().item(), "non-finite recurrentgemma apply logits")
    err, r = (logits - logits_ref).abs().max().item(), rel_l2(logits, logits_ref)
    check(r <= REL_L2_DEEP_BF16, f"recurrentgemma apply logits: relative L2 {r:.3e} of "
                                 f"impl='ref' above {REL_L2_DEEP_BF16}")
    log(f"apply logits against the plain path: max abs err {err:.3e}, {r:.3e} relative L2 "
        f"(bound {REL_L2_DEEP_BF16})")
    del logits, logits_ref
    log(f"recurrentgemma-2b TTFT: chunked {res['ttft_s'] * 1e3:.2f} ms, sequential "
        f"{res_seq['ttft_s'] * 1e3:.2f} ms (ratio {res['ttft_s'] / res_seq['ttft_s']:.4f}); "
        f"decode p50 {res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
        f"{res['tok_per_s']:.1f} tok/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    contiguous_backends("recurrentgemma-2b", server, prompts, n_new,
                        floor_ms=2 * n_params / HBM_BYTES_PER_S * 1e3)
    del server
    release_device_memory()
    asynced = async_front(dev, cfg, params, "recurrentgemma-2b")
    del params
    release_device_memory()
    phase_f32_deep(dev, cfg)
    return {"rglru_serve": served, "rglru_sequential": sequential, "rglru_sched": scheduled,
            "rglru_apply": applied, "rglru_async": asynced}


def rglru_scheduler(server, cfg, n_rec, compiles0, caps):
    """Phase 6's contiguous SlotScheduler: recurrentgemma-2b over the
    warmed fronts (rungs 2 and 4, the B4 x S32 cell), phase 7's workload:
    every admission wave through the slot-masked chunked prefill grid
    (the admitted rows reset, the others keep their state).  Every
    request ends with its budget, swaps and resizes happen, nothing
    compiles; launches exact (rg_lru = rec layers x prefill dispatches,
    fused linear = the programs' linear nodes x dispatches); the same
    schedule with the fronts on the interpret twins bitwise equal, token
    for token and dispatch for dispatch.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import SlotScheduler

    fronts = (server.bucketed, server.prefill_bucketed)
    calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
    reqs = contiguous_sched_workload(cfg.vocab)
    reset_counts()
    sres = SlotScheduler(server, max_slots=4).run(reqs)
    torch.cuda.synchronize()
    launched = counts()
    dispatches = [{k: f.stats.per_bucket_calls.get(k, 0) - c0.get(k, 0)
                   for k in f.stats.per_bucket_calls} for f, c0 in zip(fronts, calls0)]
    s_dec, s_pre = (sum(d.values()) for d in dispatches)
    for r in reqs:
        got = sres["results"][r.rid]
        check("error" not in got and len(got["tokens"]) == r.max_new,
              f"recurrentgemma-2b scheduler request {r.rid}: {got.get('error')} "
              f"{len(got['tokens'])} tokens, budget {r.max_new}")
    check(sres["swaps"] >= 1 and sres["resizes"] >= 1 and sres["compiles"] == 0
          and [f.stats.compiles for f in fronts] == compiles0 and captures_now() == caps,
          f"recurrentgemma-2b scheduler: swaps {sres['swaps']}, resizes {sres['resizes']}, "
          f"compiles {sres['compiles']} (a program compiled or captured after warmup?)")
    check(s_pre == sres["prefill_dispatches"] > 0 and s_dec == sres["decode_dispatches"],
          "recurrentgemma-2b scheduler dispatch counts disagree with the fronts' stats")
    want_fl = sum(linear_nodes(mod) * d.get(str(key), 0)
                  for f, d in zip(fronts, dispatches) for key, mod in f.programs.items())
    check(launched["rg_lru"] == n_rec * s_pre and launched["fused_linear"] == want_fl > 0,
          f"recurrentgemma-2b scheduler: rg_lru {launched['rg_lru']} != {n_rec} x {s_pre} "
          f"prefill dispatches, or fused_linear {launched['fused_linear']} != {want_fl}")
    check(launched["flash_attention"] == 0 and launched["paged_attention"] == 0,
          f"recurrentgemma-2b scheduler launched {launched}")
    with serving_with(fronts, interpret_twins(fronts)):
        ires = SlotScheduler(server, max_slots=4).run(contiguous_sched_workload(cfg.vocab))
    bad = [r.rid for r in reqs if not np.array_equal(sres["results"][r.rid]["tokens"],
                                                     ires["results"][r.rid]["tokens"])]
    same = ("decode_dispatches", "prefill_dispatches", "swaps", "resizes", "real_tokens")
    check(not bad and all(sres[k] == ires[k] for k in same),
          f"recurrentgemma-2b scheduler: segment_jit against interpret, requests {bad} differ; "
          f"{ {k: (sres[k], ires[k]) for k in same} }")
    log(f"contiguous SlotScheduler recurrentgemma-2b (max_slots 4, rungs 2/4, B4 x S32 cell): "
        f"{len(reqs)} requests, {sres['real_tokens']} tokens, {sres['tok_per_s']:.1f} tok/s, "
        f"tick p50 {sres['tick_ms_p50']:.2f} ms p99 {sres['tick_ms_p99']:.2f} ms, TTFT p50 "
        f"{sres['ttft_p50_ticks']:.1f} ticks {sres['ttft_p50_s'] * 1e3:.2f} ms; decode "
        f"dispatches {s_dec}, prefill dispatches {s_pre}, swaps {sres['swaps']}, resizes "
        f"{sres['resizes']}, occupancy {sres['occupancy']:.3f}; launches {launched}; the same "
        f"schedule on the interpret twins bitwise equal ({ires['tok_per_s']:.1f} tok/s)")
    return launched


def continuation(model, cfg, params, server, programs, dev, eager=True):
    """A continuation prefill on the B4 x S32 cell: the first program
    folds a first chunk into a fresh cache; then every program of
    ``programs`` and the eager ``impl="ref"`` step prefill a second chunk
    at position 32 with ragged lengths, each on its own copy of that
    cache; with ``eager``, so does the eager step with kernels by device
    (recurrentgemma's: the scan is its only kernel).  Returns ``({name:
    (logits, cache)}, lengths)``: "ref" the eager plain path, "eager" the
    eager step with kernels."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import dealias_tree as copy_cache  # a clone per leaf

    rng = np.random.default_rng(8)
    B, S = 4, 32
    first, second = (torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                                     device=dev) for _ in range(2))
    lengths = np.asarray([32, 25, 32, 17], np.int32)
    with torch.no_grad():
        _, cache = next(iter(programs.values()))(params, server._build_cache(B),
                                                 *server._prefill_args(B, first, 0))
        args = server._prefill_args(B, second, 32, lengths=lengths)
        out = {name: mod(params, copy_cache(cache), *args) for name, mod in programs.items()}
        if eager:  # eager and unfused: the scan kernel is the step's only kernel
            out["eager"] = model.prefill_step(params, copy_cache(cache), args[0], args[1], cfg,
                                              slot_mask=args[2], length=args[3])
        reset_counts()
        out["ref"] = model.prefill_step(params, copy_cache(cache), args[0], args[1], cfg,
                                        slot_mask=args[2], length=args[3], impl="ref")
        check(not any(counts().values()), "the impl='ref' prefill launched a kernel")
    torch.cuda.synchronize()
    return out, lengths


def state_leaves(layer, prefix=""):
    """A layer's state as {dotted key: tensor} (xLSTM nests its cell)."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out.update(state_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def continuation_errors(got, want, lengths):
    """{logits and every state leaf's key: (max abs err, relative L2)} over
    the real columns' logits and every layer's state leaves."""
    import torch

    pairs = {"logits": ([got[0][b, :n] for b, n in enumerate(lengths)],
                        [want[0][b, :n] for b, n in enumerate(lengths)])}
    for g, w in zip(got[1]["layers"], want[1]["layers"]):
        g, w = state_leaves(g), state_leaves(w)
        for k in g:
            pairs.setdefault(k, ([], []))
            pairs[k][0].append(g[k])
            pairs[k][1].append(w[k])
    out = {}
    for k, (gs, ws) in pairs.items():
        g = torch.cat([t.float().reshape(-1) for t in gs])
        w = torch.cat([t.float().reshape(-1) for t in ws])
        check(torch.isfinite(g).all().item(), f"continuation prefill {k}: non-finite values")
        out[k] = ((g - w).abs().max().item(), rel_l2(g, w))
    return out


def fmt_errors(errs):
    return ", ".join(f"{k} {m:.3e} ({r:.3e})" for k, (m, r) in errs.items())


def check_contiguous_prefill(model, cfg, params, server, dev, eager=True,
                             spread_factor=None):
    """The served bf16 B4 x S32 prefill program against ``impl="ref"`` on
    copies of a served cache (see :func:`continuation`), beside the
    spread between two implementations without kernels (the same cell
    compiled with ``impl="ref"``, against the eager plain path).  Logits
    and every state leaf within REL_L2_DEEP_BF16 relative L2 of the plain
    path, or with ``spread_factor`` within that factor of the leaf's
    kernel-free spread.  Returns the cell compiled with ``impl="ref"``."""
    from repro_torch.launch.serve import BatchedServer

    key = server.prefill_bucketed.key_for_extents((4, 32))
    pmod = server.prefill_bucketed.lookup_program(key)
    check(pmod is not None, "the B4 x S32 prefill cell was not compiled in warmup")
    import torch

    ref_server = BatchedServer(cfg, params, max_len=server.max_len, mode="forge", impl="ref")
    ref_server._ensure_bucketed()
    zeros = torch.zeros((4, 32), dtype=torch.int32, device=dev)
    ref_mod, _, _ = ref_server.prefill_bucketed.program_for(
        params, server._build_cache(4), *server._prefill_args(4, zeros, 0))
    out, lengths = continuation(model, cfg, params, server,
                                {"served": pmod, "plain program": ref_mod}, dev, eager=eager)
    served = continuation_errors(out["served"], out["ref"], lengths)
    spread = continuation_errors(out["plain program"], out["ref"], lengths)
    log(f"served bf16 prefill {key} at pos 32, lengths {lengths.tolist()}, against the eager "
        f"impl='ref' step on copies of a served cache, max abs err (relative L2): "
        f"{fmt_errors(served)}; two kernel-free implementations (the cell compiled with "
        f"impl='ref') differ by {fmt_errors(spread)}"
        + (f"; the eager step with the scan kernel as its only kernel differs by "
           f"{fmt_errors(continuation_errors(out['eager'], out['ref'], lengths))}"
           if eager else ""))
    for k, (_, r) in served.items():
        bound = REL_L2_DEEP_BF16 if spread_factor is None else spread_factor * spread[k][1]
        check(r <= bound, f"continuation prefill {k}: relative L2 {r:.3e} of impl='ref' "
                          f"above {bound:.3e}")
    return ref_mod


def phase_f32_deep(dev, served, eager=True):
    """The kernels of a recurrent path held elementwise in f32 at full
    width and the depth of ``served`` (its bf16 config; random weights
    from seed 0): the
    served B4 x S32 prefill program and ``apply`` (B=2, S=1024, Forge
    bodies) against ``impl="ref"``, within TOL_DEEP_F32.  Comparison
    launches: they count on no path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import get_model

    arch = served.name
    full = get_config(arch)
    cfg = served.with_(dtype="float32")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    server = BatchedServer(cfg, params, max_len=256, mode="forge")
    server._ensure_bucketed()
    t0 = time.perf_counter()
    pmod, key, _ = server.prefill_bucketed.program_for(
        params, server._build_cache(4),
        *server._prefill_args(4, torch.zeros((4, 32), dtype=torch.int32, device=dev), 0))
    compile_s = time.perf_counter() - t0
    out, lengths = continuation(model, cfg, params, server, {"served": pmod}, dev, eager=eager)
    eager_errs = continuation_errors(out["eager"], out["ref"], lengths) if eager else None
    logits, cache = out["served"]
    ref_logits, ref_cache = out["ref"]
    errs = {"logits": max(assert_close(logits[b, :n], ref_logits[b, :n], torch.float32,
                                       f"f32 continuation row {b} logits", TOL_DEEP_F32)
                          for b, n in enumerate(lengths))}
    for i, (g, w) in enumerate(zip(cache["layers"], ref_cache["layers"])):
        g, w = state_leaves(g), state_leaves(w)
        for k in g:
            errs[k] = max(errs.get(k, 0.0), assert_close(
                g[k], w[k], torch.float32, f"f32 continuation layer {i} {k}", TOL_DEEP_F32))
    del out, logits, cache, ref_logits, ref_cache
    tokens = torch.randint(0, cfg.vocab, (2, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        got = model.apply(params, tokens, cfg)
        want = model.apply(params, tokens, cfg, impl="ref")
    err_apply = assert_close(got, want, torch.float32, "f32 apply logits", TOL_DEEP_F32)
    log(f"f32 {arch} (full width, depth cut to {cfg.n_layers} of {full.n_layers} layers): "
        f"the prefill program {key} "
        f"(compiled in {compile_s:.1f} s) at pos 32 with lengths {lengths.tolist()} against "
        f"impl='ref' on copies of a served cache, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; apply B=2 S=1024 logits {err_apply:.3e} ({rel_l2(got, want):.3e} relative "
          f"L2); all within rtol {TOL_DEEP_F32['rtol']} atol {TOL_DEEP_F32['atol']}"
        + (f"; the eager step with the scan kernel as its only kernel: "
           f"{fmt_errors(eager_errs)}" if eager else ""))


def compare_greedy_tokens(model, cfg, params, prompts, tokens, dev, server, ref_mod):
    """Greedy tokens of the served generation against an ``impl="ref"``
    generation (chunked prefill and decode steps run eagerly with the
    plain versions): the first token must be a top choice of the plain
    path; the rows (and tokens) that match are reported.

    A top choice is one within a slack of the row's best plain logit.  At
    this depth no fixed bf16 slack is sound: two implementations without
    kernels already disagree on a near tie.  So the slack is measured in
    the run: a second kernel-free implementation of the same prefill (the
    served cell compiled with ``impl="ref"``, ``ref_mod``) gives each row
    a spread, its largest |difference| in the last position's logits, and
    the slack is max(2 x TOL_MODEL_BF16, SPREAD_FACTOR_BF16 x spread).
    The two kernel-free implementations must pass the check against each
    other (each one's first token a top choice of the other) before the
    served tokens are judged by it."""
    import torch

    B, P = prompts.shape
    n_new = tokens.shape[1]
    toks = torch.as_tensor(prompts, device=dev)
    with torch.no_grad():
        reset_counts()
        cache = model.init_cache(cfg, B, 256, device=dev)
        logits, cache = model.prefill_step(params, cache, toks, 0, cfg, impl="ref")
        last = logits[:, P - 1].float()
        tok = last.argmax(-1, keepdim=True)
        out = [tok]
        for i in range(n_new - 1):
            lg, cache = model.decode_step(params, cache, tok, P + i, cfg, impl="ref")
            tok = lg[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
        other = ref_mod(params, server._build_cache(B),
                        *server._prefill_args(B, toks.to(torch.int32), 0))[0][:, P - 1].float()
        check(not any(counts().values()), "the impl='ref' generation launched a kernel")
    ref = torch.cat(out, 1).cpu().numpy()

    def slack_of(best, spread):
        fixed = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
        return torch.maximum(fixed, SPREAD_FACTOR_BF16 * spread)

    def top_choice(plain, pick, slack):
        return plain.gather(-1, pick[:, None])[:, 0] >= plain.max(-1).values - slack

    spread = (other - last).abs().max(-1).values
    slack = slack_of(last.max(-1).values, spread)
    check(bool(top_choice(last, other.argmax(-1), slack).all()
               and top_choice(other, last.argmax(-1),
                              slack_of(other.max(-1).values, spread)).all()),
          "the first-token check fails between two kernel-free implementations: unsound")
    pick = torch.as_tensor(tokens[:, 0], device=dev).long()
    check(bool(top_choice(last, pick, slack).all()),
          "a served first token is no top choice of the impl='ref' prefill")
    margin = last.max(-1).values - last.gather(-1, pick[:, None])[:, 0]
    rows = int((ref == tokens).all(1).sum())
    log(f"first tokens: kernel-free spread per row {[round(x, 4) for x in spread.tolist()]}, "
        f"slack {[round(x, 4) for x in slack.tolist()]} (max of 2 x TOL_MODEL_BF16 and "
        f"{SPREAD_FACTOR_BF16} x spread); the two kernel-free implementations agree on "
        f"{int((other.argmax(-1) == last.argmax(-1)).sum())}/{B} first tokens and pass the "
        f"check against each other; the served first tokens trail the plain best by "
        f"{[round(x, 4) for x in margin.tolist()]}")
    log(f"greedy tokens against an impl='ref' generation: {rows}/{B} rows equal over "
        f"{n_new} tokens, {int((ref == tokens).sum())}/{ref.size} tokens equal "
        f"(first tokens {int((ref[:, 0] == tokens[:, 0]).sum())}/{B})")


def contiguous_sched_workload(vocab):
    """Phases 6 and 7's scheduler workload: 8 requests with ragged prompts of 17 to 32 tokens (one S32 grid
    cell): four at tick 0, then two at tick 12 and two at tick 14, after
    the early budgets (6 to 18 tokens) have left two slots active — so
    the B4 rung shrinks to B2 and grows back, and later requests swap
    into slots that finished mid-run."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(9)
    budgets = (6, 10, 14, 18, 8, 12, 6, 10)
    arrivals = (0, 0, 0, 0, 12, 12, 14, 14)
    return [Request(rid=i, prompt=rng.integers(0, vocab, (int(rng.integers(17, 33)),))
                    .astype(np.int32), max_new=b, arrival=a)
            for i, (b, a) in enumerate(zip(budgets, arrivals))]


def phase_xlstm(dev):
    """xlstm-350m at full width, XLSTM_LAYERS deep, through the
    contiguous forge fronts (chunked and sequential prefill), the contiguous SlotScheduler
    and ``apply``; returns the launches of each path."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import _forge, get_model

    # d 1024, 4 heads, vocab 50304, bf16; 8 of the 24 layers
    cfg = get_config("xlstm-350m").with_(n_layers=XLSTM_LAYERS)
    check(cfg.fuse == "forge" and cfg.dtype == "bfloat16", "xlstm-350m defaults changed")
    model = get_model(cfg)
    kinds = model.module._kinds(cfg)
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    check((n_m, n_s) == (7, 1), f"{n_m} mLSTM and {n_s} sLSTM layers")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in {id(t): t for t in pytree.tree_leaves(params)}.values())
    B, P, n_new, max_len = 4, 32, 32, 256
    prompts = np.random.default_rng(10).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    # batch rungs 2 and 4, one sequence cell (S32): the served cells only
    server = BatchedServer(cfg, params, max_len=max_len, mode="forge",
                           bucket_policy="ladder:2,4", seq_bucket_policy="ladder:32")
    sched = SlotScheduler(server, max_slots=4)
    reqs = contiguous_sched_workload(cfg.vocab)
    # decode rungs 2 and 4, and the B4 x S32 cell: the schedule admits on
    # rung 4 only, so a B2 x S32 cell would never run
    warm_s = warm_graphs("xlstm-350m", lambda: server.warmup([2]) + server.warmup([4], [P]))
    caps = captures_now()
    program_log(server.bucketed, "decode")
    program_log(server.prefill_bucketed, "prefill")
    log(f"xlstm-350m ({n_params / 1e6:.1f} M parameters, bf16) warmup: "
        f"{len(server.bucketed.programs)} decode + {len(server.prefill_bucketed.programs)} "
        f"prefill programs in {warm_s:.1f} s")
    fronts = (server.bucketed, server.prefill_bucketed)
    compiles0 = [f.stats.compiles for f in fronts]

    def counted(name, fn):
        """Run ``fn`` with the counts zeroed just before and read just
        after; fused_linear must equal the programs' linear nodes x their
        dispatches in the run, and no other kernel may launch."""
        calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = counts()
        dispatches = [{k: f.stats.per_bucket_calls.get(k, 0) - c0.get(k, 0)
                       for k in f.stats.per_bucket_calls} for f, c0 in zip(fronts, calls0)]
        want_fl = sum(linear_nodes(mod) * d.get(str(key), 0)
                      for f, d in zip(fronts, dispatches) for key, mod in f.programs.items())
        check([f.stats.compiles for f in fronts] == compiles0 and captures_now() == caps,
              f"{name}: a program compiled or captured after warmup")
        check(launched["fused_linear"] == want_fl > 0,
              f"{name}: fused_linear launches {launched['fused_linear']} != {want_fl} "
              f"predicted from the programs' linear nodes x dispatches")
        others = {k: v for k, v in launched.items() if k != "fused_linear" and v}
        check(not others, f"{name}: launched {others}")
        return out, launched, [sum(d.values()) for d in dispatches]

    def run(policy):
        server.prefill_policy = policy
        torch.cuda.reset_peak_memory_stats(dev)
        res, launched, (n_dec, n_pre) = counted(f"prefill={policy}",
                                                lambda: server.generate(prompts, n_new))
        check(res["tokens"].shape == (B, n_new) and res["compile_s"] == 0.0,
              f"prefill={policy}: token shape {res['tokens'].shape}, compile "
              f"{res['compile_s']} s")
        log(f"serve xlstm-350m prefill={policy} ({res['prefill_mode']}) batch={B} prompt={P} "
            f"gen={n_new}: ttft {res['ttft_s'] * 1e3:.2f} ms, decode p50 "
            f"{res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
            f"{res['tok_per_s']:.1f} tok/s; {n_pre} prefill and {n_dec} decode dispatches; "
            f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
            f"launches {launched}")
        return res, launched

    res, served = run("auto")
    check(res["prefill_mode"] == "chunked", f"prefill mode {res['prefill_mode']}")
    res_seq, sequential = run("sequential")
    check(res_seq["prefill_mode"] == "sequential", f"prefill mode {res_seq['prefill_mode']}")
    server.prefill_policy = "auto"

    sres, scheduled, (s_dec, s_pre) = counted("scheduler", lambda: sched.run(reqs))
    for r in reqs:
        got = sres["results"][r.rid]
        check("error" not in got and len(got["tokens"]) == r.max_new,
              f"request {r.rid}: {got.get('error')} {len(got['tokens'])} tokens, budget "
              f"{r.max_new}")
    check(sres["swaps"] >= 1 and sres["resizes"] >= 1 and sres["compiles"] == 0,
          f"swaps {sres['swaps']}, resizes {sres['resizes']}, compiles {sres['compiles']}")
    check(s_pre == sres["prefill_dispatches"] and s_dec == sres["decode_dispatches"],
          "scheduler dispatch counts disagree with the fronts' stats")
    log(f"contiguous SlotScheduler xlstm-350m (max_slots 4, rungs 2/4): {len(reqs)} requests, "
        f"{sres['real_tokens']} tokens, {sres['tok_per_s']:.1f} tok/s, tick p50 "
        f"{sres['tick_ms_p50']:.2f} ms p99 {sres['tick_ms_p99']:.2f} ms, TTFT p50 "
        f"{sres['ttft_p50_ticks']:.1f} ticks {sres['ttft_p50_s'] * 1e3:.2f} ms; decode "
        f"dispatches {s_dec}, prefill dispatches {s_pre}, swaps {sres['swaps']}, resizes "
        f"{sres['resizes']}, occupancy {sres['occupancy']:.3f}; launches {scheduled}")

    Ba, S = 2, 1024
    tokens = torch.randint(0, cfg.vocab, (Ba, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(11))
    with torch.no_grad():
        t0 = time.perf_counter()
        model.apply(params, tokens, cfg)  # compiles the two Forge bodies
        torch.cuda.synchronize()
        apply_first_s = time.perf_counter() - t0
        bodies = {k: v for k, v in _forge._CACHE.items()
                  if k.startswith(f"{cfg!r}/") and "impl=None" in k}
        check(len(bodies) == 2, f"apply compiled {len(bodies)} bodies, not one per block kind")
        reset_counts()
        t0 = time.perf_counter()
        logits = model.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        applied = counts()
    fl_apply = sum(linear_nodes(mod) * (n_s if "/slstm/" in k else n_m)
                   for k, mod in bodies.items())
    check(applied["fused_linear"] == fl_apply > 0,
          f"apply: fused_linear launches {applied['fused_linear']} != {fl_apply}")
    check(not {k: v for k, v in applied.items() if k != "fused_linear" and v},
          f"apply launched {applied}")
    check(tuple(logits.shape) == (Ba, S, cfg.vocab) and torch.isfinite(logits).all().item(),
          f"apply logits shape {tuple(logits.shape)} or non-finite values")
    for k, mod in bodies.items():
        r = mod.result
        ops_ = [n.op for n in mod.graph.nodes.values() if not n.op.startswith("aten.")]
        log(f"  apply body {'slstm' if '/slstm/' in k else 'mlstm'}: nodes {r.nodes_before} -> "
            f"{r.nodes_after}, {linear_nodes(mod)} fused-linear nodes, opaque and fused "
            f"{sorted(ops_)}, Phases 1-4 {r.total_ms / 1e3:.2f} s")
    log(f"apply B={Ba} S={S}: fused_linear launches {applied['fused_linear']}; first call "
        f"{apply_first_s:.1f} s (compile included), steady call {apply_ms:.1f} ms host wall")

    # comparisons with the plain path (their launches do not count)
    ref_mod = check_contiguous_prefill(model, cfg, params, server, dev, eager=False,
                                       spread_factor=SPREAD_FACTOR_BF16)
    compare_greedy_tokens(model, cfg, params, prompts, res["tokens"], dev, server, ref_mod)
    with torch.no_grad():
        reset_counts()
        logits_ref = model.apply(params, tokens, cfg, impl="ref")
        logits_plain = model.apply(params, tokens, cfg.with_(fuse="none"))  # eager, unfused
        check(not any(counts().values()), "a kernel-free apply launched a kernel")
    err, r = (logits - logits_ref).abs().max().item(), rel_l2(logits, logits_ref)
    spread = rel_l2(logits_plain, logits_ref)
    log(f"apply logits against the plain path: max abs err {err:.3e}, {r:.3e} relative L2; "
        f"two kernel-free implementations (unfused eager, and compiled with impl='ref') "
        f"differ by {(logits_plain - logits_ref).abs().max().item():.3e} ({spread:.3e})")
    check(r <= SPREAD_FACTOR_BF16 * spread,
          f"xlstm apply logits: relative L2 {r:.3e} of impl='ref' above "
          f"{SPREAD_FACTOR_BF16} x the kernel-free spread {spread:.3e}")
    del logits, logits_ref, logits_plain
    log(f"xlstm-350m TTFT: chunked {res['ttft_s'] * 1e3:.2f} ms, sequential "
        f"{res_seq['ttft_s'] * 1e3:.2f} ms (ratio {res['ttft_s'] / res_seq['ttft_s']:.4f}); "
        f"decode p50 {res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
        f"{res['tok_per_s']:.1f} tok/s; scheduler {sres['tok_per_s']:.1f} tok/s")
    contiguous_backends("xlstm-350m", server, prompts, n_new,
                        floor_ms=2 * n_params / HBM_BYTES_PER_S * 1e3)
    del server, sched, params
    release_device_memory()
    # f32 on a window of 4 layers ending in the sLSTM one (the published
    # stack's layers 4-7), both kinds held elementwise; the bf16 path
    # above keeps its 8 (its spread check needs the depth)
    phase_f32_deep(dev, cfg.with_(n_layers=4, slstm_every=4), eager=False)
    return {"xlstm_serve": served, "xlstm_sequential": sequential, "xlstm_sched": scheduled,
            "xlstm_apply": applied}


def phase_dense_contiguous(dev):
    """forge-125m at full width through the contiguous forge fronts
    (segment_jit): group serving with the batched and the sequential
    prefill, then the contiguous SlotScheduler over phase 5's workload;
    returns the launches of each path."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import get_model

    cfg = get_config("forge-125m")  # 12 layers, d 768, vocab 50257, bf16
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    B, P, n_new, max_len = 4, 32, 32, 256  # the serve CLI's defaults
    prompts = np.random.default_rng(12).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    # batch rungs 2 and 4 (max_slots 4); the sequence cells S16/S32/S64 of
    # the workload's prompts (12, 24 and 40 tokens) and the group's S32
    server = BatchedServer(cfg, params, max_len=max_len, mode="forge", bucket_policy="ladder:2,4")
    sched = SlotScheduler(server, max_slots=4)
    reqs = paged_workload(cfg.vocab)
    # decode rungs 2 and 4 and the B4 cells: the schedule admits on rung 4
    # only, so the B2 cells would never run
    warm_s = warm_graphs("forge-125m contiguous", lambda: server.warmup([2]) + server.warmup(
        [4], sorted({len(r.prompt) for r in reqs} | {P})))
    caps = captures_now()
    program_log(server.bucketed, "decode")
    program_log(server.prefill_bucketed, "prefill")
    log(f"forge-125m contiguous warmup: {len(server.bucketed.programs)} decode + "
        f"{len(server.prefill_bucketed.programs)} prefill programs in {warm_s:.1f} s")
    fronts = (server.bucketed, server.prefill_bucketed)
    compiles0 = [f.stats.compiles for f in fronts]

    def counted(name, fn):
        """``fn`` with the counts zeroed just before and read just after:
        fused_linear = the programs' linear nodes x their dispatches, no
        other kernel (decode and prefill attention are masked: plain)."""
        calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = counts()
        dispatches = [{k: f.stats.per_bucket_calls.get(k, 0) - c0.get(k, 0)
                       for k in f.stats.per_bucket_calls} for f, c0 in zip(fronts, calls0)]
        want_fl = sum(linear_nodes(mod) * d.get(str(key), 0)
                      for f, d in zip(fronts, dispatches) for key, mod in f.programs.items())
        check([f.stats.compiles for f in fronts] == compiles0 and captures_now() == caps,
              f"{name}: a program compiled or captured after warmup")
        check(launched["fused_linear"] == want_fl > 0,
              f"{name}: fused_linear launches {launched['fused_linear']} != {want_fl} "
              f"predicted from the programs' linear nodes x dispatches")
        others = {k: v for k, v in launched.items() if k != "fused_linear" and v}
        check(not others, f"{name}: launched {others}")
        return out, launched, [sum(d.values()) for d in dispatches]

    runs = {}
    for policy in ("auto", "sequential"):
        server.prefill_policy = policy
        res, launched, (n_dec, n_pre) = counted(f"prefill={policy}",
                                                lambda: server.generate(prompts, n_new))
        check(res["tokens"].shape == (B, n_new) and res["compile_s"] == 0.0,
              f"prefill={policy}: token shape {res['tokens'].shape}, compile {res['compile_s']}")
        check(res["prefill_mode"] == ("batched" if policy == "auto" else "sequential"),
              f"prefill={policy}: prefill mode {res['prefill_mode']}")
        log(f"serve forge-125m contiguous prefill={policy} ({res['prefill_mode']}) batch={B} "
            f"prompt={P} gen={n_new}: ttft {res['ttft_s'] * 1e3:.2f} ms, decode p50 "
            f"{res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} ms, "
            f"{res['tok_per_s']:.1f} tok/s; {n_pre} prefill and {n_dec} decode dispatches; "
            f"launches {launched}")
        runs[policy] = (res, launched)
    server.prefill_policy = "auto"
    res, served = runs["auto"]
    # the two prefill routes round differently (M = 128 against M = 4
    # fused-linear rows): reported, not required equal
    same_seq = int((res["tokens"] == runs["sequential"][0]["tokens"]).all(1).sum())

    sres, scheduled, (s_dec, s_pre) = counted("scheduler", lambda: sched.run(reqs))
    for r in reqs:
        got = sres["results"][r.rid]
        check("error" not in got and len(got["tokens"]) == r.max_new,
              f"request {r.rid}: {got.get('error')} {len(got['tokens'])} tokens, budget "
              f"{r.max_new}")
    check(sres["swaps"] >= 1 and sres["compiles"] == 0,
          f"swaps {sres['swaps']}, compiles {sres['compiles']}")
    check(s_pre == sres["prefill_dispatches"] and s_dec == sres["decode_dispatches"],
          "scheduler dispatch counts disagree with the fronts' stats")
    log(f"contiguous SlotScheduler forge-125m (max_slots 4, rungs 2/4): {len(reqs)} requests, "
        f"{sres['real_tokens']} tokens, {sres['tok_per_s']:.1f} tok/s, tick p50 "
        f"{sres['tick_ms_p50']:.2f} ms p99 {sres['tick_ms_p99']:.2f} ms, TTFT p50 "
        f"{sres['ttft_p50_ticks']:.1f} ticks {sres['ttft_p50_s'] * 1e3:.2f} ms; decode "
        f"dispatches {s_dec}, prefill dispatches {s_pre}, swaps {sres['swaps']}, resizes "
        f"{sres['resizes']}, occupancy {sres['occupancy']:.3f}; launches {scheduled}")

    # the served B4 x S32 prefill program against the eager impl="ref" step:
    # logits and written cache within TOL_MODEL_BF16; the served first
    # tokens a top choice of the plain path (phase 3's slack)
    pkey = server.prefill_bucketed.key_for_extents((B, P))
    pmod = server.prefill_bucketed.programs[pkey]
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache = pmod(params, server._build_cache(B), *server._prefill_args(B, toks, 0))
        reset_counts()
        logits_ref, cache_ref = model.prefill_step(params, server._build_cache(B), toks, 0, cfg,
                                                   impl="ref")
        check(FL.LAUNCHES.n == 0, "the impl='ref' prefill launched a kernel")
    err = assert_close(logits, logits_ref, torch.bfloat16, "forge-125m prefill logits",
                       TOL_MODEL_BF16)
    errs = {name: assert_close(cache[name][:, :, :, :P], cache_ref[name][:, :, :, :P],
                               torch.bfloat16, f"prefilled {name} cache", TOL_MODEL_BF16)
            for name in ("k", "v")}
    last, last_ref = logits[:, P - 1].float(), logits_ref[:, P - 1].float()
    best = last_ref.max(-1).values
    slack = 2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * best.abs())
    for name, pick in (("program", last.argmax(-1)),
                       ("served", torch.as_tensor(res["tokens"][:, 0], device=dev).long())):
        check(bool((last_ref.gather(-1, pick[:, None])[:, 0] >= best - slack).all()),
              f"a first token of the {name} is no top choice of the impl='ref' prefill")
    log(f"served prefill {pkey} within bf16 tolerance of the eager impl='ref' prefill_step: "
        f"logits max abs err {err:.3e} ({rel_l2(logits, logits_ref):.3e} relative L2), cache "
        f"k {errs['k']:.3e} v {errs['v']:.3e}; first tokens equal in "
        f"{int((last.argmax(-1) == last_ref.argmax(-1)).sum())}/{B} rows (served "
        f"{int((torch.as_tensor(res['tokens'][:, 0], device=dev) == last_ref.argmax(-1)).sum())}"
        f"/{B}); batched and sequential prefill served equal tokens in {same_seq}/{B} rows")

    # a caller keeping two calls' outputs sees both intact: two prefill
    # dispatches on other prompts, each held after both against the
    # interpret twin of the same lowered program
    twin = pmod.with_backend("interpret")
    other = torch.as_tensor(np.random.default_rng(14).integers(0, cfg.vocab, (B, P)),
                            dtype=torch.int32, device=dev)
    with torch.no_grad():
        args1 = (params, server._build_cache(B)) + server._prefill_args(B, toks, 0)
        args2 = (params, server._build_cache(B)) + server._prefill_args(B, other, 0)
        first, second = pmod(*args1), pmod(*args2)
        leaves_equal("the first of two kept prefill outputs", first, twin(*args1))
        leaves_equal("the second of two kept prefill outputs", second, twin(*args2))
    log("two prefill dispatches' outputs kept by the caller: both bitwise equal to the "
        "interpret program's after the second call")
    n_params = sum(t.numel() for t in {id(t): t for t in pytree.tree_leaves(params)}.values())
    contiguous_backends("forge-125m contiguous", server, prompts, n_new,
                        floor_ms=2 * n_params / HBM_BYTES_PER_S * 1e3)
    del server, sched, params
    release_device_memory()
    return {"dense_serve": served, "dense_sequential": runs["sequential"][1],
            "dense_sched": scheduled}


def log_pass_table(what, result):
    """The seven passes of one compiled program: time, node delta and
    detail counters (paper Table 10), and the node reduction."""
    log(f"{what}: nodes {result.nodes_before} -> {result.nodes_after} (node_reduction "
        f"{result.node_reduction:.4f}), passes {result.optimize_ms:.1f} ms, torch.export "
        f"{result.capture_ms / 1e3:.2f} s")
    for row in result.pass_table():
        log(f"    {row['pass']}: {row['time_ms']:.2f} ms, {row['delta_nodes']:+d} nodes over "
            f"{row['runs']} rounds, {row['detail']}")
    check([row["pass"] for row in result.pass_table()] == [
        "dce", "cse", "constant_folding", "device_constant", "attention_fusion",
        "operator_fusion", "layout_optimization"], f"{what}: not the seven passes")


def fused_counts(mod):
    ops_ = [n.op for n in mod.graph.nodes.values() if n.is_fused]
    return {op: ops_.count(op) for op in ("forge.sdpa", "forge.linear_act", "forge.swiglu")}


def phase_qwen(dev, more=None):
    """qwen2.5-14b at full width, QWEN_LAYERS of its 48 layers (d 5120, 40
    heads of 128 with 8 KV heads, d_ff 13824, vocab 152064, QKV bias, SwiGLU; bf16,
    random weights from seed 0): the interpret server, the contiguous forge
    fronts on segment_jit (rung 4, the B4 x S32 cell) held bitwise against
    interpret, and ``apply`` at B=1, S=1024; then ``more(cfg, model,
    params, prompts)`` on the same weights (phase 12's qwen paths), then
    the served prefill program and ``apply`` in f32 at F32_CHECK_LAYERS against
    ``impl="ref"``.  Returns the launches of each path."""
    import gc

    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.core.metrics import fusion_gain_ratio
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    gc.collect()
    release_device_memory()
    log(f"qwen2.5-14b: before its model, memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, memory_reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    cfg = get_config("qwen2.5-14b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
           cfg.ffn, cfg.qkv_bias, cfg.dtype) == (48, 5120, 40, 8, 13824, 152064, "swiglu",
                                                  True, "bfloat16"), f"qwen2.5-14b is {cfg}")
    cfg = cfg.with_(n_layers=QWEN_LAYERS)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in {id(t): t for t in pytree.tree_leaves(params)}.values())
    floor_ms = 2 * n_params / HBM_BYTES_PER_S * 1e3
    log(f"qwen2.5-14b: {n_params / 1e9:.3f} B parameters ({2 * n_params / 1e9:.2f} GB bf16) "
        f"made in {time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, P, n_new, max_len = 4, 32, 32, 256  # the serve CLI's defaults
    prompts = np.random.default_rng(18).integers(0, cfg.vocab, (B, P)).astype(np.int32)

    # -- the eager server: Forge-compiled block bodies --------------------
    served_eager, _ = interpret_path(dev, cfg, params, prompts, n_new, "qwen2.5-14b")
    (dbody,) = forge_bodies(cfg, "decode")
    check(fused_counts(dbody) == {"forge.sdpa": 1, "forge.linear_act": 2, "forge.swiglu": 1},
          f"decode body fused {fused_counts(dbody)}")

    # FGR on the block body (Eq. 22): two captures, alpha 0 and 1
    p0 = params["blocks"][0]
    x1 = torch.zeros((B, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)
    kc = torch.zeros((B, cfg.n_kv_heads, max_len, cfg.head_dim_), dtype=torch.bfloat16,
                     device=dev)
    pos = torch.tensor(P, device=dev)
    cos, sin = T._rope_for(cfg, L.decode_positions(pos))
    fgr = fusion_gain_ratio(lambda *a: T.block_decode(*a, cfg=cfg), p0, x1, kc, kc.clone(),
                            pos, cos, sin)
    check(fgr["fgr"] > 1, f"FGR {fgr}")
    log(f"qwen2.5-14b decode block body FGR (cost model, alpha 0 / alpha 1): "
        f"{fgr['score_alpha0']:.2f} / {fgr['score_alpha1']:.2f} = {fgr['fgr']:.3f}")
    del x1, kc

    # -- the contiguous forge fronts on segment_jit ------------------------
    server = BatchedServer(cfg, params, max_len=max_len, mode="forge", bucket_policy="ladder:4")
    warm_s = warm_graphs("qwen2.5-14b contiguous", lambda: server.warmup([B], prompt_lens=[P]))
    fronts = (server.bucketed, server.prefill_bucketed)
    check([len(f.programs) for f in fronts] == [1, 1],
          f"warmup compiled {[len(f.programs) for f in fronts]} programs, not the B4 decode "
          f"program and the B4 x S32 cell")
    program_log(server.bucketed, "decode")
    program_log(server.prefill_bucketed, "prefill")
    for f, name in zip(fronts, ("decode", "prefill")):
        for key, mod in f.programs.items():
            log_pass_table(f"qwen2.5-14b {name} program {key}", mod.result)
    log(f"qwen2.5-14b contiguous warmup: 2 programs in {warm_s:.1f} s")
    caps = captures_now()
    compiles0 = [f.stats.compiles for f in fronts]
    calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
    reset_counts()
    res = server.generate(prompts, n_new)
    torch.cuda.synchronize()
    served = counts()
    dispatches = [{k: f.stats.per_bucket_calls.get(k, 0) - c0.get(k, 0)
                   for k in f.stats.per_bucket_calls} for f, c0 in zip(fronts, calls0)]
    want_fl = sum(linear_nodes(mod) * d.get(str(key), 0)
                  for f, d in zip(fronts, dispatches) for key, mod in f.programs.items())
    check([f.stats.compiles for f in fronts] == compiles0 and captures_now() == caps,
          "qwen2.5-14b: a program compiled or captured after warmup")
    check(res["prefill_mode"] == "batched" and res["tokens"].shape == (B, n_new)
          and res["compile_s"] == 0.0, f"served {res['prefill_mode']} {res['tokens'].shape}")
    check(served["fused_linear"] == want_fl > 0,
          f"qwen2.5-14b: fused_linear launches {served['fused_linear']} != {want_fl} "
          f"predicted from the programs' linear nodes x dispatches")
    check(not any(v for k, v in served.items() if k != "fused_linear"),
          f"qwen2.5-14b: launched {served}")
    n_dec, n_pre = (sum(d.values()) for d in dispatches)
    log(f"serve qwen2.5-14b contiguous (segment_jit) batch={B} prompt={P} gen={n_new}: ttft "
        f"{res['ttft_s'] * 1e3:.2f} ms, decode p50 {res['decode_ms_p50']:.2f} ms p99 "
        f"{res['decode_ms_p99']:.2f} ms, {res['tok_per_s']:.1f} tok/s (the weights' byte "
        f"bound {floor_ms:.3f} ms a step); {n_pre} prefill and {n_dec} decode dispatches; "
        f"launches {served}, {served.variants}")
    contiguous_backends("qwen2.5-14b contiguous", server, prompts, n_new, floor_ms=floor_ms)
    del server, fronts
    gc.collect()
    release_device_memory()

    # -- apply at B=1, S=1024: flash at H=40, KVH=8, D=128 -----------------
    applied = apply_path(dev, cfg, model, params, "qwen2.5-14b", 1024, 19)
    out = {"qwen_eager": served_eager, "qwen_serve": served, "qwen_apply": applied}
    if more is not None:  # further paths on the same weights (one init)
        out.update(more(cfg, model, params, prompts))
    del params, model
    gc.collect()
    release_device_memory()
    phase_qwen_f32(dev, cfg, prompts)
    return out


def phase_qwen_f32(dev, cfg, prompts):
    """qwen2.5-14b's kernels held elementwise in f32 at full width, depth
    cut to F32_CHECK_LAYERS (48 in f32 is 59 GB): the served B4 x S32 prefill
    program (logits and written cache) and ``apply`` (B=1, S=1024) against
    ``impl="ref"`` within TOL_DEEP_F32.  Comparison launches: they count
    on no path."""
    import torch
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import get_model

    cfg = cfg.with_(dtype="float32", n_layers=F32_CHECK_LAYERS)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    server = BatchedServer(cfg, params, max_len=256, mode="forge")
    server._ensure_bucketed()
    B, P = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    pmod, key, _ = server.prefill_bucketed.program_for(
        params, server._build_cache(B), *server._prefill_args(B, toks, 0))
    compile_s = time.perf_counter() - t0
    with torch.no_grad():
        logits, cache = pmod(params, server._build_cache(B), *server._prefill_args(B, toks, 0))
        ref_logits, ref_cache = model.prefill_step(params, server._build_cache(B), toks, 0, cfg,
                                                   impl="ref")
    errs = {"logits": assert_close(logits, ref_logits, torch.float32,
                                   "qwen2.5-14b f32 prefill logits", TOL_DEEP_F32)}
    for name in ("k", "v"):
        errs[name] = assert_close(cache[name][:, :, :, :P], ref_cache[name][:, :, :, :P],
                                  torch.float32, f"qwen2.5-14b f32 prefill {name} cache",
                                  TOL_DEEP_F32)
    del server, logits, cache, ref_logits, ref_cache
    tokens = torch.randint(0, cfg.vocab, (1, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(20))
    with torch.no_grad():
        got = model.apply(params, tokens, cfg)
        want = model.apply(params, tokens, cfg, impl="ref")
    err_apply = assert_close(got, want, torch.float32, "qwen2.5-14b f32 apply logits",
                             TOL_DEEP_F32)
    log(f"f32 qwen2.5-14b (full width, depth cut to {cfg.n_layers} of 48 layers: 48 layers in f32 are "
        f"59 GB): the prefill program {key} (compiled in {compile_s:.1f} s) against "
        f"impl='ref', max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; apply B=1 S=1024 logits {err_apply:.3e} ({rel_l2(got, want):.3e} relative L2); "
          f"all within rtol {TOL_DEEP_F32['rtol']} atol {TOL_DEEP_F32['atol']}")
    del params, got, want
    release_device_memory()


def log_device_time(fn, what, top=0):
    """Device time of one call's kernels under the profiler, in all and
    for the fused-linear and flash kernels (the names they launch); with
    ``top``, the ``top`` kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total <= 0:
        log(f"{what} device time: not measured (the profiler recorded no device time)")
        return

    def part(tag):
        return sum(e.self_device_time_total for e in events if tag in e.key) / 1e3

    log(f"{what} device time {total:.3f} ms: fused_linear kernels {part('fused_linear'):.3f} ms, "
        f"flash kernels {part('flash_'):.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:.4f} ms, {e.count} launches: {e.key[:90]}")


def step_split(step, what, steps=8, floor_ms=None):
    """Where a served step's time goes: ``step()`` runs one step.  Host
    wall per step, p50 and p99 over ``steps`` steps each ended by a
    synchronize, the p50 of the part of it spent before ``step()``
    returned (enqueueing the step's work: the host's share) and of the
    device span between CUDA events recorded before and after the step
    (device time, kernels and the gaps between them); then device
    kernel time per step from ``torch.profiler`` over ``steps`` steps run
    back to back, and the busy share: kernel time over the same steps'
    host wall under the profiler (which slows the host) and over the
    unprofiled p50.  Returns the numbers (device time and busy shares
    None when the profiler recorded no device time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        walls, enqueue, spans = [], [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            step()
            e1.record()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            spans.append(e0.elapsed_time(e1))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    out = {"wall_p50": float(np.percentile(walls, 50)), "wall_p99": float(np.percentile(walls, 99)),
           "enqueue_p50": float(np.percentile(enqueue, 50)),
           "span_p50": float(np.percentile(spans, 50)),
           "device_ms": device_ms if device_ms > 0 else None, "window_ms": window_ms / steps}
    out["busy"] = device_ms * steps / window_ms if device_ms > 0 else None
    out["busy_p50"] = device_ms / out["wall_p50"] if device_ms > 0 else None
    if out["device_ms"] is None:
        log(f"{what}: host wall per step p50 {out['wall_p50']:.3f} ms p99 {out['wall_p99']:.3f} "
            f"ms (enqueue p50 {out['enqueue_p50']:.3f} ms); device time not measured (the "
            f"profiler recorded no device time)")
        return out
    log(f"{what}: host wall per step p50 {out['wall_p50']:.3f} ms p99 {out['wall_p99']:.3f} ms "
        f"(enqueue p50 {out['enqueue_p50']:.3f} ms; device span p50 {out['span_p50']:.3f} ms "
        f"between events recorded before and after the step); under the profiler, device kernels {device_ms:.3f} ms per step of "
        f"{out['window_ms']:.3f} ms host wall ({100 * out['busy']:.1f}% busy; "
        f"{100 * out['busy_p50']:.1f}% of the unprofiled p50)"
        + (f"; a step must read the weights: at least {floor_ms:.3f} ms"
           if floor_ms is not None else ""))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step, {e.count // steps} "
            f"launches/step: {e.key[:90]}")
    return out


def decode_steps(server, prompts):
    """A step function over the server's decode program from a prefill of
    ``prompts``: each call decodes one token, fed the last one."""
    cache, tok, pos, step, _ = server.prefill(prompts)
    st = {"cache": cache, "tok": tok, "i": 0}

    def one():
        st["tok"], st["cache"] = step(server.params, st["cache"], st["tok"], pos + st["i"])
        st["i"] += 1

    return one


def busy_share(dev, server, prompts, steps=8, floor_ms=None):
    """Device busy share of steady decode steps (the eager server)."""
    return step_split(decode_steps(server, prompts), "eager decode", steps, floor_ms)


def interpret_twins(fronts):
    """Every program of ``fronts`` on the interpret backend, built from the
    same lowered program (no second ``torch.export``)."""
    return [{k: m.with_backend("interpret") for k, m in f.programs.items()} for f in fronts]


@contextlib.contextmanager
def serving_with(fronts, tables):
    """Serve the fronts from other program tables (the interpret twins)
    inside a ``with`` block; the served tables come back after it."""
    saved = [f.programs for f in fronts]
    for f, t in zip(fronts, tables):
        f.programs = t
    try:
        yield
    finally:
        for f, t in zip(fronts, saved):
            f.programs = t


def leaves_equal(what, got, want):
    """Every output leaf bitwise equal; else fail naming the leaves that
    differ and by how much."""
    import torch
    from torch.utils import _pytree as pytree

    g, spec = pytree.tree_flatten_with_path(got)
    w = pytree.tree_leaves(want)
    check(len(g) == len(w), f"{what}: {len(g)} outputs against {len(w)}")
    bad = [(pytree.keystr(path), (a.float() - b.float()).abs().max().item())
           for (path, a), b in zip(g, w)
           if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]
    check(not bad, f"{what}: segment_jit differs from interpret at {bad[:6]}")
    return len(g)


def hold_against_interpret(what, dispatches, fronts, twins, generate=None):
    """segment_jit against interpret on the card: one dispatch of each
    program in ``dispatches`` ((label, key, front index, args)) under
    both backends on the same inputs, every output bitwise equal; with
    ``generate``, the served greedy tokens under both, bitwise equal."""
    import numpy as np

    for label, key, fi, args in dispatches:
        mod, twin = fronts[fi].programs[key], twins[fi][key]
        n = leaves_equal(f"{what} {label} {key}", mod(*args), twin(*args))
        log(f"{what}: {label} dispatch {key} under segment_jit bitwise equal to interpret "
            f"({n} outputs; {mod.stats.last_segments_executed} graph replays against "
            f"{twin.stats.n_instructions} per-op dispatches)")
    if generate is not None:
        got = generate()
        with serving_with(fronts, twins):
            want = generate()
        check(np.array_equal(got, want), f"{what}: served greedy tokens differ between "
                                         f"segment_jit and interpret")
        log(f"{what}: served greedy tokens {got.shape} bitwise equal under both backends")


def contiguous_backends(what, server, prompts, n_new, floor_ms=None):
    """segment_jit against interpret on a contiguous forge path: one decode
    and (where the family has a prefill front) one prefill dispatch of
    the group's cells on the same inputs, the served greedy tokens, then
    the host/device split of steady decode steps under both backends."""
    import torch

    fronts = tuple(f for f in (server.bucketed, server.prefill_bucketed) if f is not None)
    twins = interpret_twins(fronts)
    B, P = prompts.shape
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=server.device)
    with torch.no_grad():
        cache, tok, pos, _, dkey = server.prefill(prompts)
        dispatches = [("decode", dkey, 0,
                       (server.params, cache) + server._decode_args(B, tok, pos))]
        if server.prefill_bucketed is not None:
            dispatches.append(
                ("prefill", server.prefill_bucketed.key_for_extents((B, P)), 1,
                 (server.params, server._build_cache(B)) + server._prefill_args(B, toks, 0)))
        hold_against_interpret(what, dispatches, fronts, twins,
                               generate=lambda: server.generate(prompts, n_new)["tokens"])
    return backend_split(what, fronts, twins, lambda: decode_steps(server, prompts),
                         server.bucketed.lookup_program(dkey), floor_ms)


def warm_graphs(what, warm):
    """Run ``warm()`` (a front's warmup) and log the programs captured, the
    CUDA graphs, the capture seconds and the device memory it reserved
    (the graph pools with it); returns warm()'s value."""
    import torch
    from repro_torch.core.backends.segment_jit import CAPTURES

    before, mem0 = dict(CAPTURES), torch.cuda.memory_reserved()
    out = warm()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_reserved()
    log(f"{what} warmup captured {CAPTURES['programs'] - before['programs']} programs as "
        f"{CAPTURES['graphs'] - before['graphs']} CUDA graphs in "
        f"{CAPTURES['seconds'] - before['seconds']:.2f} s (warm run + capture); "
        f"memory_reserved {mem0 / 2**30:.2f} GiB before warmup, {mem1 / 2**30:.2f} GiB after")
    return out


def captures_now():
    from repro_torch.core.backends.segment_jit import CAPTURES

    return dict(CAPTURES)


def backend_split(what, fronts, twins, make_step, decode_mod, floor_ms=None):
    """Host wall per step, device time per step and busy share of steady
    decode steps under segment_jit and under interpret, replays per step
    and the capture seconds of each program."""
    split = {"segment_jit": step_split(make_step(), f"{what} [segment_jit]", floor_ms=floor_ms)}
    with serving_with(fronts, twins):
        split["interpret"] = step_split(make_step(), f"{what} [interpret]", floor_ms=floor_ms)
    s = decode_mod.stats
    caps = [round(m.result.capture_s, 3) for f in fronts for m in f.programs.values()]

    def fmt(v, scale=1.0, unit=" ms"):
        return "not measured" if v is None else f"{v * scale:.3f}{unit}"

    a, b = split["segment_jit"], split["interpret"]
    log(f"{what} host/device split: host wall per step p50 {a['wall_p50']:.3f} / p99 "
        f"{a['wall_p99']:.3f} ms (segment_jit) against {b['wall_p50']:.3f} / "
        f"{b['wall_p99']:.3f} ms (interpret); enqueue p50 {a['enqueue_p50']:.3f} against "
        f"{b['enqueue_p50']:.3f} ms; device span p50 {a['span_p50']:.3f} against "
        f"{b['span_p50']:.3f} ms; device time per step {fmt(a['device_ms'])} "
        f"against {fmt(b['device_ms'])}; busy {fmt(a['busy'], 100, '%')} against "
        f"{fmt(b['busy'], 100, '%')} under the profiler, {fmt(a['busy_p50'], 100, '%')} "
        f"against {fmt(b['busy_p50'], 100, '%')} of the unprofiled p50; replays per step {s.n_segments} (delta_after + 1 = "
        f"{s.delta_after + 1}) against {s.n_instructions} per-op dispatches; capture seconds "
        f"per program {caps}")
    return split


def async_workload(vocab):
    """The JAX package's async-compile workload (benchmarks/async_compile.py):
    24 requests in one wave, prompts of 4 + i % 5 tokens, budgets of
    12 + 2 (i % 8) tokens; with 8 slots the live count decays through the
    cold rungs 4 and 2 once the queue is empty."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, (4 + i % 5,)).astype(np.int32),
                    max_new=12 + 2 * (i % 8), arrival=0) for i in range(24)]


def first_token_slack(model, cfg, params, ctx, picks, dev, what):
    """PR 16's measured-slack rule for one context: the plain path's last
    logits (the unfused prefill) and a second kernel-free implementation
    (the unfused decode-step replay) give a spread; slack = max(2 x
    TOL_MODEL_BF16, SPREAD_FACTOR_BF16 x spread).  The two must pass the
    check against each other, then every token of ``picks`` must be a top
    choice of the plain path within the slack.  Returns (spread, slack,
    margins)."""
    import torch

    plain_cfg = cfg.with_(fuse="none")
    toks = torch.as_tensor(ctx, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        cache = model.init_cache(plain_cfg, 1, 256, device=dev)
        last = model.prefill_step(params, cache, toks, 0, plain_cfg, impl="ref")[0][0, -1].float()
        cache = model.init_cache(plain_cfg, 1, 256, device=dev)
        for i in range(toks.shape[1]):
            lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], i, plain_cfg, impl="ref")
        other = lg[0, -1].float()
    spread = (other - last).abs().max().item()

    def slack_of(best):
        return max(2 * (TOL_MODEL_BF16["atol"] + TOL_MODEL_BF16["rtol"] * abs(best)),
                   SPREAD_FACTOR_BF16 * spread)

    def top(plain, pick):
        return plain[pick].item() >= plain.max().item() - slack_of(plain.max().item())

    check(top(last, int(other.argmax())) and top(other, int(last.argmax())),
          f"{what}: the first-token check fails between two kernel-free implementations")
    margins = [last.max().item() - last[int(t)].item() for t in picks]
    check(all(top(last, int(t)) for t in picks),
          f"{what}: tokens {picks} not all top choices of the plain path within "
          f"{slack_of(last.max().item()):.4f} (margins {margins})")
    return spread, slack_of(last.max().item()), margins


def compile_split(results):
    """Seconds of export / Phase 2 / Phase 3 / Phase 4 (without capture) /
    capture summed over CompilationResults."""
    out = {"export": 0.0, "phase2": 0.0, "phase3": 0.0, "phase4": 0.0, "capture": 0.0}
    for r in results:
        out["export"] += r.capture_ms / 1e3
        out["phase2"] += r.optimize_ms / 1e3
        out["phase3"] += r.lower_ms / 1e3
        out["phase4"] += r.backend_ms / 1e3 - r.capture_s
        out["capture"] += r.capture_s
    return {k: round(v, 3) for k, v in out.items()}


def release_device_memory():
    """Drop the process-global compile cache's executors (on the card they
    hold their CUDA graphs and pools) and return the freed memory."""
    import gc

    import torch
    from repro_torch.core import get_compile_cache

    get_compile_cache().clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_compile_cost(dev, cli_runs):
    """Phase 10: forge-125m at full width and COMPILE_COST_LAYERS deep,
    bf16, segment_jit, through the compile-cost layer: (a) async serving against inline, (b) restart
    replay from a disk cache in one process and through the CLI, (c)
    ``BucketedModule.__call__`` on the block body at S=1024, (d) the
    buffer pool, (e) ``evict_cold``.  Returns the launches of (a)'s async
    run and (c)'s calls."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.metrics import bucket_report
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    release_device_memory()
    cfg = get_config("forge-125m").with_(n_layers=COMPILE_COST_LAYERS)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = async_workload(cfg.vocab)
    lens = sorted({len(r.prompt) for r in reqs})

    # -- (a) async serving against inline ------------------------------------
    runs = {}
    for name, kw in (("inline", {}), ("async", {"async_compile": True, "compile_workers": 2})):
        srv = BatchedServer(cfg, params, max_len=256, mode="forge", **kw)
        t0 = time.perf_counter()
        srv.warmup([8], prompt_lens=lens)  # only rung 8 (and its S16 cell) warm
        warm_s = time.perf_counter() - t0
        sched = SlotScheduler(srv, max_slots=8)
        bs = srv.bucketed.stats
        wait0 = bs.compile_wait_s  # the warmup's own compiles (inline) excluded
        reset_counts()
        res = sched.run(async_workload(cfg.vocab))
        torch.cuda.synchronize()
        launched = counts()
        run_wait = bs.compile_wait_s - wait0
        svc = None
        if srv.compile_service is not None:
            check(srv.compile_service.wait_idle(600.0), "the compile service did not go idle")
            svc = srv.compile_service.stats.snapshot()
        runs[name] = (srv, res, launched, run_wait)
        bad = [rid for rid, r in res["results"].items() if "error" in r]
        check(not bad and len(res["results"]) == len(reqs), f"{name}: requests failed {bad}")
        log(f"async workload [{name}]: warmup {warm_s:.1f} s; {res['real_tokens']} tokens, "
            f"{res['tok_per_s']:.1f} tok/s, tick p50 {res['tick_ms_p50']:.3f} ms p99 "
            f"{res['tick_ms_p99']:.3f} ms max {res['tick_ms_max']:.3f} ms; compile_wait_s "
            f"{run_wait:.4f} s in the run ({bs.compile_wait_s:.4f} s with the warmup), "
            f"background {bs.compile_background_s:.2f} s; "
            f"warm_fallbacks {res['warm_fallbacks']}, fallback_calls {bs.fallback_calls}, "
            f"fallback_cells_padded {bs.fallback_cells_padded}; decode dispatches "
            f"{res['decode_dispatches']}, resizes {res['resizes']}; launches {launched}"
            + (f"; background builds {svc['completed']} in {svc['busy_s']:.2f} busy s "
               f"(submitted {svc['submitted']}, promoted {svc['promoted']})" if svc else ""))
        log(f"  [{name}] decode {bucket_report(bs)}")
    srv_in, res_in, _, _ = runs["inline"]
    srv_as, res_as, served_async, async_wait = runs["async"]
    bs_as = srv_as.bucketed.stats
    check(res_as["warm_fallbacks"] >= 1, "the async run never fell back to a warm rung")
    check(async_wait <= 0.005 and bs_as.compile_wait_s <= 0.005,
          f"the async run blocked {bs_as.compile_wait_s:.4f} s on compiles")
    check(served_async["fused_linear"] > 0, "the async run launched no fused linear")
    # the background builds have landed: the same workload again switches
    # to the exact rungs (resizes, no fallback)
    res_sw = SlotScheduler(srv_as, max_slots=8).run(async_workload(cfg.vocab))
    check(res_sw["warm_fallbacks"] == 0 and res_sw["resizes"] == res_in["resizes"],
          f"after the builds landed: warm_fallbacks {res_sw['warm_fallbacks']}, resizes "
          f"{res_sw['resizes']} (inline {res_in['resizes']})")
    log(f"async server again, the background builds landed: exact rungs "
        f"{sorted(map(str, srv_as.bucketed.programs))}, {res_sw['resizes']} resizes, no "
        f"fallback; tick p50 {res_sw['tick_ms_p50']:.3f} ms p99 {res_sw['tick_ms_p99']:.3f} "
        f"ms max {res_sw['tick_ms_max']:.3f} ms")
    hold_async_tokens(model, cfg, params, reqs, res_in, (res_as, res_sw), dev, "forge-125m")

    # -- (d) the buffer pool: a second generate at one batch reuses the cache --
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (8, 8)).astype(np.int32)
    srv_in.generate(prompts, 8)
    torch.cuda.synchronize()
    hits0, reserved0 = srv_in.bucketed.stats.pool_hits, torch.cuda.memory_reserved()
    srv_in.generate(prompts, 8)
    torch.cuda.synchronize()
    hits1, reserved1 = srv_in.bucketed.stats.pool_hits, torch.cuda.memory_reserved()
    check(hits1 > hits0 and reserved1 <= reserved0,
          f"buffer pool: hits {hits0} -> {hits1}, memory_reserved {reserved0} -> {reserved1}")
    log(f"buffer pool: a second generate at B=8 took the pooled cache (pool hits {hits0} -> "
        f"{hits1}, {srv_in.bucketed.stats.pool_bytes_reused / 2**20:.1f} MiB reused); "
        f"memory_reserved {reserved0 / 2**30:.3f} -> {reserved1 / 2**30:.3f} GiB")
    srv_as.compile_service.shutdown()
    del runs, srv_in, srv_as
    release_device_memory()

    # -- (b) restart replay in one process, (c) and (e); then the CLI pair,
    # which ran as subprocesses beside phases 6-7 (start_cli_runs)
    called = compile_cost_replay(dev, cfg, params)
    runs = cli_runs["restart"].join()
    check(len(runs) == 2, f"the cold CLI run failed, so the replay did not run: {runs}")
    for (code, stdout, stderr, seconds), what in zip(runs, ("cold", "--assert-no-builds")):
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[serve]")]
        log(f"CLI {what} (beside phases 6-7): exit {code} in {seconds:.1f} s; "
            + "; ".join(ln for ln in lines if "disk cache" in ln or "programs=" in ln))
        check(code == 0, f"the serve CLI ({what}) exited {code}: {stdout[-2000:]} "
                         f"{stderr[-2000:]}")
    del params, model
    release_device_memory()
    return {"async_serve": served_async, "bucketed_call": called}


def hold_async_tokens(model, cfg, params, reqs, res_in, async_runs, dev, what):
    """Every request's tokens of each async run equal the inline run's,
    or a request that diverges is held at its first differing token by
    the measured-slack rule (:func:`first_token_slack`): a row computed
    padded into a larger warm rung may round differently at a near-tie."""
    import numpy as np

    diverged = []
    for r in reqs:
        a = res_in["results"][r.rid]["tokens"]
        for res in async_runs:
            b = res["results"][r.rid]["tokens"]
            if not np.array_equal(a, b):
                j = int(np.argmax(a != b)) if len(a) == len(b) else min(len(a), len(b))
                diverged.append((r, j, a, b))
    for r, j, a, b in diverged:
        ctx = np.concatenate([r.prompt, a[:j]])
        spread, slack, margins = first_token_slack(
            model, cfg, params, ctx, [int(a[j]), int(b[j])], dev,
            f"{what} request {r.rid} token {j}")
        log(f"  {what} request {r.rid} diverged at token {j} (inline {a[j]}, async {b[j]}): "
            f"both top choices of the plain path, margins {[round(m, 4) for m in margins]}, "
            f"kernel-free spread {spread:.4f}, slack {slack:.4f}")
    n = len(async_runs) * len(reqs)
    log(f"{what} async against inline, {len(async_runs)} async runs: {n - len(diverged)}/{n} "
        f"requests' tokens bitwise equal, {len(diverged)} diverged (each first differing "
        f"token held by the measured-slack rule)")


#: the async fronts of phases 6 and 12: rungs 2 and 4 (4 warm, 2 cold) and
#: one sequence cell, which the async workload's 4-8 token prompts fill
ASYNC_RUNGS, ASYNC_SEQ = "ladder:2,4", "ladder:16"


def async_front(dev, cfg, params, what, paged=False):
    """Phase 10's (a) and (b) contract on another front: ``cfg`` served
    through ``SlotScheduler(max_slots=4)`` on ``BatchedServer(mode="forge",
    async_compile=True, cache_dir=D)`` (the paged fronts with the
    paged-attention kernel when ``paged``), only the top rung (B4 and its
    B4 x S16 cell) warm, over phase 10's async workload, whose live count
    walks down to the cold rung 2 once the queue is empty: at least one
    warm fallback, at most 5 ms of compile wait, the service idle after
    the run, then the same workload on the exact rungs with no fallback.
    Every in-memory tier dropped, a server on D (inline) warms every
    program the async server built with zero full builds and serves the
    workload; each async run's tokens equal that inline run's, or meet
    the measured-slack rule at their first difference.  Returns the
    launches of the first async run (the workers' warm runs included)."""
    import torch
    from repro_torch.core import get_compile_cache
    from repro_torch.core.metrics import bucket_report
    from repro_torch.launch.serve import BatchedServer, SlotScheduler
    from repro_torch.models import _forge, get_model

    model = get_model(cfg)
    scfg = cfg.with_(kv_kernel="pallas") if paged else cfg
    kw = dict(max_len=256, mode="forge", bucket_policy=ASYNC_RUNGS, seq_bucket_policy=ASYNC_SEQ,
              paged=paged, kv_page_size=16)
    reqs = async_workload(cfg.vocab)
    lens = sorted({len(r.prompt) for r in reqs})
    g = get_compile_cache()
    store0 = g.store
    cache_dir = tempfile.mkdtemp(prefix="forge-async-cache-", dir=os.environ.get("TMPDIR"))

    def restart():
        _forge.clear_cache()
        g.clear()
        g.store = None

    restart()
    srv = BatchedServer(scfg, params, async_compile=True, compile_workers=2,
                        cache_dir=cache_dir, **kw)
    t0 = time.perf_counter()
    srv.warmup([4], prompt_lens=lens)
    warm_s = time.perf_counter() - t0
    bs = srv.bucketed.stats
    wait0 = bs.compile_wait_s
    reset_counts()
    res = SlotScheduler(srv, max_slots=4).run(reqs)
    torch.cuda.synchronize()
    launched = counts()
    run_wait = bs.compile_wait_s - wait0
    check(srv.compile_service.wait_idle(600.0), f"{what} async: the service did not go idle")
    svc = srv.compile_service.stats.snapshot()
    bad = [rid for rid, r in res["results"].items() if "error" in r]
    check(not bad and len(res["results"]) == len(reqs), f"{what} async: requests failed {bad}")
    check(res["warm_fallbacks"] >= 1, f"{what}: the async run never fell back to a warm rung")
    check(run_wait <= 0.005 and bs.compile_wait_s <= 0.005,
          f"{what}: the async run blocked {bs.compile_wait_s:.4f} s on compiles")
    kernel = "paged_attention" if paged else "rg_lru"
    check(launched[kernel] > 0 and launched["fused_linear"] > 0,
          f"{what} async: launches {launched} (want {kernel} and fused_linear)")
    res_sw = SlotScheduler(srv, max_slots=4).run(async_workload(cfg.vocab))
    check(res_sw["warm_fallbacks"] == 0 and res_sw["compiles"] == 0,
          f"{what} async after the builds landed: warm_fallbacks {res_sw['warm_fallbacks']}, "
          f"compiles {res_sw['compiles']}")
    decode_keys = sorted(srv.bucketed.programs, key=str)
    cells = sorted(srv.prefill_bucketed.programs, key=str)
    log(f"{what} async ({'paged, kv_kernel=pallas' if paged else 'contiguous'}, rungs 2/4, "
        f"rung 4 warm): warmup {warm_s:.1f} s; {res['real_tokens']} tokens, "
        f"{res['tok_per_s']:.1f} tok/s, tick p50 {res['tick_ms_p50']:.3f} ms p99 "
        f"{res['tick_ms_p99']:.3f} ms max {res['tick_ms_max']:.3f} ms; compile_wait_s "
        f"{run_wait:.4f} s in the run; warm_fallbacks {res['warm_fallbacks']}, fallback_calls "
        f"{bs.fallback_calls}, resizes {res['resizes']}; background builds {svc['completed']} "
        f"in {svc['busy_s']:.2f} busy s (submitted {svc['submitted']}); launches {launched}; "
        f"again on the exact rungs {sorted(map(str, decode_keys))}: {res_sw['resizes']} "
        f"resizes, no fallback, tick p50 {res_sw['tick_ms_p50']:.3f} ms")
    log(f"  [{what} async] decode {bucket_report(bs)}")
    if paged:
        srv.page_pool.check()
        check(srv.page_pool.pages_in_use == 1 + srv.prefix_tree.cached_pages,
              f"{what} async: a page leaked")
    srv.compile_service.shutdown()
    del srv
    release_device_memory()

    restart()
    srv = BatchedServer(scfg, params, cache_dir=cache_dir, **kw)
    t0 = time.perf_counter()
    srv.warmup([k.extents[0] for k in decode_keys])
    for key in cells:
        srv.warmup([key.extents[0]], prompt_lens=[key.extents[1]])
    wall = time.perf_counter() - t0
    cs = srv.compile_cache.stats
    builds = cs.misses + g.stats.misses
    n_prog = len(srv.bucketed.programs) + len(srv.prefill_bucketed.programs)
    check(builds == 0 and cs.disk_hits >= 1 and n_prog == len(decode_keys) + len(cells),
          f"{what} restart: {builds} full builds, {cs.disk_hits} disk hits, {n_prog} programs "
          f"against the async server's {len(decode_keys) + len(cells)}")
    res_in = SlotScheduler(srv, max_slots=4).run(async_workload(cfg.vocab))
    check(res_in["resizes"] == res_sw["resizes"],
          f"{what}: the inline run resized {res_in['resizes']} times, the async one "
          f"{res_sw['resizes']}")
    log(f"{what} restart on the same cache directory: {n_prog} programs warmed in {wall:.2f} s, "
        f"0 full builds, {cs.disk_hits} disk hits; inline run {res_in['tok_per_s']:.1f} tok/s, "
        f"tick p50 {res_in['tick_ms_p50']:.3f} ms, compiles {res_in['compiles']}")
    hold_async_tokens(model, cfg, params, reqs, res_in, (res, res_sw), dev, what)
    del srv
    restart()
    g.store = store0
    release_device_memory()
    return launched


# The serve CLI's subprocesses (phase 10's restart pair, phase 11's
# --chaos run) start beside phases 6-7, whose exports leave the other CPU
# cores idle, and are read where their phase checks them; run() stops
# any that is still running when the script ends.
_CHILDREN = []
_CHILDREN_LOCK = threading.Lock()
_STOPPING = threading.Event()
#: processes spawned through torch.multiprocessing (phase 16 (d)'s ranks)
_SPAWNED = []


class CliRuns:
    """Serve CLI commands run one after another in subprocesses on a
    thread of their own; a command runs only if the one before it exited
    0.  ``join`` returns ``(exit code, stdout, stderr, seconds)`` per
    command that ran."""

    def __init__(self, name, argvs, env):
        self.name, self.results, self.error = name, [], None
        self._thread = threading.Thread(target=self._run, args=(argvs, env), name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self, argvs, env):
        try:
            for argv in argvs:
                with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
                    t0 = time.perf_counter()
                    with _CHILDREN_LOCK:
                        if _STOPPING.is_set():
                            return
                        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                                stderr=err, text=True)
                        _CHILDREN.append(proc)
                    try:
                        code = proc.wait(timeout=600)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        code = proc.wait()
                    out.seek(0)
                    err.seek(0)
                    self.results.append((code, out.read(), err.read(),
                                         time.perf_counter() - t0))
                if code != 0:
                    return
        except BaseException as e:  # re-raised by join()
            self.error = e

    def join(self):
        self._thread.join(1300)
        check(not self._thread.is_alive(), f"the {self.name} CLI runs did not end")
        if self.error is not None:
            raise self.error
        return self.results


def start_cli_runs():
    """Phase 10 (b)'s CLI pair (a cold run against a fresh cache
    directory, then ``--assert-no-builds`` on it) and phase 11 (f)'s
    ``--chaos`` run, started now."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    serve = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "forge-125m",
             "--mode", "forge"]
    cli_dir = tempfile.mkdtemp(prefix="forge-cli-cache-", dir=os.environ.get("TMPDIR"))
    # two batch rungs and one prompt length (1,3,8 and 17,48 until phase 16
    # (e)): the replay is the same, with fewer programs beside phases 6-9
    pair = serve + ["--sweep", "1,8", "--prompt-sweep", "17", "--gen", "8",
                    "--cache-dir", cli_dir]
    chaos = serve + ["--continuous", "12", "--paged", "--kv-kernel", "pallas",
                     "--max-slots", "4", "--prompt-len", "8", "--gen", "4", "--max-len", "32",
                     "--kv-page-size", "8", "--chaos", "page.alloc=0.2,dispatch=0.05",
                     "--chaos-seed", "3"]
    return {"restart": CliRuns("restart", [pair, pair + ["--assert-no-builds"]], env),
            "chaos": CliRuns("chaos", [chaos], env)}


def stop_children():
    """Kill every CLI subprocess and spawned rank still running and wait
    for it."""
    with _CHILDREN_LOCK:
        _STOPPING.set()
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    for proc in _SPAWNED:
        if proc.is_alive():
            proc.kill()
        proc.join()


def compile_cost_replay(dev, cfg, params):
    """Phase 10 (b)'s restart replay in one process, (c) and (e) (see
    :func:`phase_compile_cost`); returns (c)'s launches."""
    import gc
    import os
    import tempfile

    import torch
    from repro_torch.core import (CompileCache, DiskCacheStore, ForgeCompiler, PipelineConfig,
                                  get_compile_cache)
    from repro_torch.core.metrics import check_bucketed_fidelity
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import _forge
    from repro_torch.models import transformer as T

    g = get_compile_cache()
    store0 = g.store
    cache_dir = tempfile.mkdtemp(prefix="forge-cache-", dir=os.environ.get("TMPDIR"))
    splits, builds = {}, {}
    for run in ("cold", "restart"):
        _forge.clear_cache()
        g.clear()
        g.store = None
        srv = BatchedServer(cfg, params, max_len=256, mode="forge", cache_dir=cache_dir)
        t0 = time.perf_counter()
        srv.warmup([2, 4])
        wall = time.perf_counter() - t0
        results = ([m.result for m in srv.bucketed.programs.values()]
                   + _forge.compiled_bodies())
        splits[run] = compile_split(results)
        cs, ds = srv.compile_cache.stats, srv.compile_cache.store.stats
        builds[run] = cs.misses + g.stats.misses
        log(f"restart replay [{run}]: warmup of rungs 2 and 4 {wall:.2f} s; split {splits[run]}; "
            f"full builds {builds[run]} (fronts {cs.misses}, bodies {g.stats.misses}), "
            f"disk hits {cs.disk_hits + g.stats.disk_hits}, writes {ds.writes}, "
            f"bytes_written {ds.bytes_written}")
        del srv
    check(builds["cold"] > 0 and builds["restart"] == 0,
          f"restart replay ran {builds['restart']} full builds (expected 0)")
    _forge.clear_cache()
    g.clear()
    g.store = store0
    release_device_memory()

    # -- (c) BucketedModule.__call__ on the block body at S=1024 -------------
    x_of = {B: torch.randn(B, 1024, cfg.d_model, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(B)).to(torch.bfloat16)
            for B in (1, 3, 5)}
    cos, sin = T._rope_for(cfg, torch.arange(1024, device=dev))
    layer = params["blocks"][0]

    def body(p, x, cos, sin):
        return T.block_apply(p, x, cos, sin, cfg)

    body_dir = tempfile.mkdtemp(prefix="forge-body-cache-", dir=os.environ.get("TMPDIR"))
    cache = CompileCache(store=DiskCacheStore(body_dir))
    bucketed = ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=cache).compile_bucketed(
        body, in_axes=(None, 0, None, None), policy="pow2", static_argnums=(0,))
    with torch.no_grad():
        for B, x in x_of.items():  # compiles pow2:B2, B4, B8
            bucketed(layer, x, cos, sin)
        reset_counts()
        got = {B: bucketed(layer, x, cos, sin) for B, x in x_of.items()}
        torch.cuda.synchronize()
        called = counts()
        exact = {B: ForgeCompiler(PipelineConfig(backend="segment_jit"), cache=CompileCache())
                 .compile(body, layer, x, cos, sin, static_argnums=(0,))(layer, x, cos, sin)
                 for B, x in x_of.items()}
    check(called["flash_attention"] == 3 and called["fused_linear"] == 9
          and sum(called.values()) == 12,
          f"__call__ at B 1, 3, 5: launches {called} (want 3 flash, 9 fused linear)")
    errs = {B: assert_close(got[B], exact[B], torch.bfloat16, f"__call__ B={B} against the "
                            f"exact-shape compile") for B in x_of}
    fid = check_bucketed_fidelity(body, layer, x_of[3], cos, sin, in_axes=(None, 0, None, None),
                                  backend="segment_jit")
    check(fid.max_abs_diff <= TOL_BF16["atol"] + TOL_BF16["rtol"] * max(
        got[3].float().abs().max().item(), 1.0), f"check_bucketed_fidelity: {fid}")
    log(f"BucketedModule.__call__ block body S=1024 at B 1, 3, 5 (buckets "
        f"{sorted(map(str, bucketed.programs))}): launches {called} ({called.variants}); "
        f"max abs err against exact-shape compiles {errs} (bitwise: "
        f"{ {B: bool(torch.equal(got[B], exact[B])) for B in x_of} }); "
        f"check_bucketed_fidelity at B=3: max abs {fid.max_abs_diff:.3e}, KL "
        f"{fid.kl_divergence:.3e}; pad_waste {bucketed.stats.pad_waste:.3f}")
    del exact

    # -- (e) evict_cold(1): the evicted programs' graph pools are freed ------
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    victims = bucketed.evict_cold(1)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    check(len(victims) == 2 and len(bucketed.programs) == 1 and cache.stats.coherence_drops == 2,
          f"evict_cold(1): victims {victims}, {len(bucketed.programs)} programs left")
    check(after < before, f"evict_cold freed no memory: {before} -> {after}")
    with torch.no_grad():
        again = bucketed(layer, x_of[1], cos, sin)  # pow2:B2: replayed from disk
    check(cache.stats.disk_hits == 1 and torch.equal(again, got[1]),
          f"the evicted rung's rebuild: disk hits {cache.stats.disk_hits}, bitwise "
          f"{torch.equal(again, got[1])}")
    log(f"evict_cold(1): evicted {sorted(map(str, victims))}; memory_reserved "
        f"{before / 2**30:.3f} -> {after / 2**30:.3f} GiB; the evicted pow2:B2 replayed from "
        f"disk (disk hits {cache.stats.disk_hits}) bitwise equal to its first program")
    del bucketed, got, again
    release_device_memory()
    return called


def fault_recovery_workload(vocab, n=16):
    """The JAX package's benchmarks/fault_recovery.py workload: every
    third request shares a 16-token prefix plus 4 tokens, the rest have
    3-11 tokens; budgets 3 + 3i % 6; arrivals i // 3 (ticks)."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, (16,)).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            p = np.concatenate([shared, rng.integers(0, vocab, (4,)).astype(np.int32)])
        else:
            p = rng.integers(0, vocab, (3 + 2 * (i % 5),)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=p, max_new=3 + (3 * i) % 6, arrival=i // 3))
    return reqs


def slo_workload(vocab, burst_budget_s=30.0, burst_priority=2):
    """The JAX package's benchmarks/slo_serving.py workload (wall clock):
    4 priority-0 background requests at t=0 (8-token prompts, 40 new
    tokens) and 10 bursts (4-token prompts, 3 new tokens) from t=0.02 s
    at Poisson gaps of mean 12 ms, ``default_rng(23)``."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(23)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, (8,)).astype(np.int32), max_new=40,
                    arrival_s=0.0, priority=0) for i in range(4)]
    t = 0.02
    for j in range(10):
        t += float(rng.exponential(0.012))
        reqs.append(Request(rid=100 + j, prompt=rng.integers(0, vocab, (4,)).astype(np.int32),
                            max_new=3, arrival_s=t, priority=burst_priority,
                            ttft_budget_s=burst_budget_s))
    return reqs


def segment_kernel_ops(ex):
    """Per segment of a ``segment_jit`` executor: the fused-linear and
    paged-attention launches one run of it makes, read off its RGIR ops
    (a ``forge.swiglu`` counts two)."""
    per = []
    for seg in ex.segments:
        fl = pa = 0
        for op in ex.prog.ops[seg.start:seg.stop]:
            name = op.opcode.split(".", 1)[1]
            fl += {"forge.linear_act": 1, "forge.swiglu": 2,
                   "repro_torch.fused_linear.default": 1}.get(name, 0)
            pa += name == "repro_torch.paged_attention.default"
        per.append((fl, pa))
    return per


def segment_runs(fronts):
    """Every program's executor and its per-segment run counters
    (``segment_runs``), by executor id."""
    return {id(m.executor): (m.executor, list(m.executor.segment_runs))
            for f in fronts for m in f.programs.values()}


def launches_from_segments(fronts, runs0):
    """(fused linear, paged attention) launches the segments that ran
    since ``runs0`` make: each segment's kernel ops x its runs, a call cut
    by a dispatch fault counting the segments before the fault; programs
    evicted since ``runs0`` count too."""
    fl = pa = 0
    now = segment_runs(fronts)
    for key in set(runs0) | set(now):
        ex, base = runs0.get(key, (now.get(key, (None,))[0], None))
        if base is None:
            base = [0] * len(ex.segments)
        for (f_n, p_n), r, r0 in zip(segment_kernel_ops(ex), ex.segment_runs, base):
            fl += f_n * (r - r0)
            pa += p_n * (r - r0)
    return fl, pa


def phase_faults_slo(dev, cli_runs):
    """Phase 11: fault-tolerant and SLO-aware slot serving of forge-125m at
    full width, FAULT_SLO_LAYERS deep but in (c) (bf16, segment_jit): (a)
    the fault_recovery soak, (b) a dispatch fault inside a decode program,
    (c) SLO against FIFO in wall mode and the hopeless row, (d)
    contiguous preempt and resume, (e) a ladder re-fit, (f) the CLI's
    ``--chaos``.  Returns the launches of each counted run."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.metrics import bucket_report
    from repro_torch.launch.serve import BatchedServer, Request, SlotScheduler
    from repro_torch.models import get_model
    from repro_torch.runtime import chaos

    release_device_memory()
    cfg = get_config("forge-125m").with_(kv_kernel="pallas", n_layers=FAULT_SLO_LAYERS)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {}

    def counted(name, fronts, fn):
        """``fn()`` with the counts zeroed just before and read just after;
        fused linear and paged attention must equal what the segments
        that ran make (faulted calls included), flash and the scan 0; no
        compile and no capture in the run."""
        runs0 = segment_runs(fronts)
        compiles0, caps = sum(f.stats.compiles for f in fronts), captures_now()
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        launched = counts()
        want_fl, want_pa = launches_from_segments(fronts, runs0)
        check(launched["fused_linear"] == want_fl and launched["paged_attention"] == want_pa,
              f"{name}: launches {dict(launched)} != fused_linear {want_fl}, paged "
              f"{want_pa} from the segments that ran")
        check(launched["flash_attention"] == 0 and launched["rg_lru"] == 0,
              f"{name}: flash / rg_lru launched: {dict(launched)}")
        check(sum(f.stats.compiles for f in fronts) == compiles0 and captures_now() == caps,
              f"{name}: compiled or captured after warmup")
        out[name] = launched
        return res

    def paged_server(max_len, seq_policy, bucket_policy, lens, rungs, model_cp=None):
        srv = BatchedServer(*(model_cp or (cfg, params)), max_len=max_len, mode="forge",
                            paged=True, kv_page_size=8, bucket_policy=bucket_policy,
                            seq_bucket_policy=seq_policy)
        warm_graphs(f"paged max_len {max_len} {bucket_policy} / {seq_policy}",
                    lambda: srv.warmup(rungs, lens))
        return srv

    def serve_with(srv, reqs, plan=None, **kw):
        sched = SlotScheduler(srv, max_slots=4, **kw)
        prev = chaos.install_plan(plan)
        try:
            return sched.run(reqs)
        finally:
            chaos.install_plan(prev)

    def no_leaks(srv, what, n, res):
        pool, tree = srv.page_pool, srv.prefix_tree
        check(len(res["results"]) == n, f"{what}: {len(res['results'])} of {n} requests ended")
        pool.check()
        check(pool.parked_owners == 0, f"{what}: {pool.parked_owners} parked owners left")
        tree.clear()
        pool.check()
        check(pool.pages_in_use == 1, f"{what}: {pool.pages_in_use - 1} pages leaked")

    # -- (a) the fault_recovery soak, clean then faulted ----------------------
    # one decode rung and one prefill cell: on the card a row's bits
    # depend on the cell's row count (the fused-linear and cuBLAS plans
    # change with M), and the faults move requests between admission
    # waves, so survivors are bitwise only when every wave runs one cell
    reqs = fault_recovery_workload(cfg.vocab)
    srv = paged_server(32, "ladder:32", "ladder:4", [32], [4])
    fronts = (srv.bucketed, srv.prefill_bucketed)
    clean = counted("faults_clean", fronts, lambda: serve_with(srv, reqs))
    bad = [rid for rid, r in clean["results"].items() if "error" in r]
    check(not bad, f"clean run: requests failed {bad}")
    no_leaks(srv, "clean run", len(reqs), clean)

    def soak_plan():
        return (chaos.FaultPlan(seed=11).arm(chaos.SITE_PAGE_ALLOC, rate=0.15, max_faults=3)
                .arm(chaos.SITE_DISPATCH, rate=0.08, max_faults=3)
                .arm(chaos.SITE_LOGITS_NAN, times=(4,)))

    plan = soak_plan()
    checks = {"n": 0}
    check_fn = srv.page_pool.check

    def counted_check():  # the scheduler calls pool.check() every tick
        checks["n"] += 1
        check_fn()

    srv.page_pool.check = counted_check
    try:
        faulted = counted("faults_faulted", fronts, lambda: serve_with(srv, reqs, plan))
    finally:
        del srv.page_pool.check
    failed = {rid: r for rid, r in faulted["results"].items() if "error" in r}
    check(plan.faults_injected >= 1 and faulted["faults_injected"] == plan.faults_injected,
          f"faults injected {plan.faults_injected}, run says {faulted['faults_injected']}")
    check(all(r["error_type"] in ("RequestError", "SystemError") for r in failed.values()),
          f"untyped failures {failed}")
    check(checks["n"] >= faulted["decode_dispatches"],
          f"pool.check ran {checks['n']} times over {faulted['decode_dispatches']} ticks")
    diverged = [rid for rid, r in faulted["results"].items() if rid not in failed
                and not np.array_equal(r["tokens"], clean["results"][rid]["tokens"])]
    check(not diverged, f"survivors diverged from the clean run: {diverged}")
    no_leaks(srv, "faulted run", len(reqs), faulted)
    log(f"(a) fault_recovery soak, forge-125m bf16 paged (kv_kernel=pallas, max_len 32, "
        f"pages of 8, 4 slots, rung 4, cell S32): clean {clean['tok_per_s']:.1f} tok/s "
        f"({clean['real_tokens']} tokens, wall {clean['wall_s'] * 1e3:.2f} ms, tick p50 "
        f"{clean['tick_ms_p50']:.3f} ms p99 {clean['tick_ms_p99']:.3f} ms); faulted "
        f"{faulted['tok_per_s']:.1f} tok/s ({faulted['real_tokens']} tokens, wall "
        f"{faulted['wall_s'] * 1e3:.2f} ms, ratio "
        f"{faulted['tok_per_s'] / max(clean['tok_per_s'], 1e-9):.3f}); plan log {plan.log}; "
        f"failed {sorted(failed)} ({[r['error_type'] for r in failed.values()]}), survivors "
        f"{len(reqs) - len(failed)} bitwise equal to the clean run; rows_quarantined "
        f"{faulted['rows_quarantined']}, dispatch_retries {faulted['dispatch_retries']}, "
        f"tick_failures {faulted['tick_failures']}, ticks_degraded "
        f"{faulted['ticks_degraded']}, admission_failures {faulted['admission_failures']}, "
        f"deferrals {faulted['deferrals']}; pool.check() on {checks['n']} ticks; 0 pages "
        f"and 0 slots leaked; launches clean {dict(out['faults_clean'])}, faulted "
        f"{dict(out['faults_faulted'])}")
    log(f"  faulted decode {bucket_report(srv.bucketed.stats)}")

    # -- (b) a dispatch fault inside a decode program -------------------------
    dec = srv.bucketed.programs[srv.bucketed.key_for_extents(4)]
    pre = srv.prefill_bucketed.programs[srv.prefill_bucketed.key_for_extents((4, 32))]
    n_d, n_p = len(dec.executor.segments), len(pre.executor.segments)
    k = n_d // 2
    # the first tick runs the prefill program, then the decode program:
    # ordinal n_p + k is segment k of the first decode dispatch
    mid = chaos.FaultPlan().arm(chaos.SITE_DISPATCH, times=(n_p + k,))
    retried = counted("faults_mid_graph", fronts, lambda: serve_with(srv, reqs, mid))
    check(mid.faults_injected == 1 and retried["dispatch_retries"] == 1
          and retried["tick_failures"] == 0,
          f"mid-graph fault: injected {mid.faults_injected}, retries "
          f"{retried['dispatch_retries']}, tick failures {retried['tick_failures']}")
    diverged = [rid for rid, r in retried["results"].items()
                if "error" in r or not np.array_equal(r["tokens"], clean["results"][rid]["tokens"])]
    check(not diverged, f"after the retried mid-graph fault, requests diverged: {diverged}")
    no_leaks(srv, "mid-graph fault", len(reqs), retried)
    log(f"(b) dispatch fault before segment {k} of {n_d} of the first decode dispatch "
        f"(ordinal {n_p + k}, after the {n_p}-segment prefill): retried in the tick, "
        f"{len(reqs)} requests bitwise equal to the clean run; launches "
        f"{dict(out['faults_mid_graph'])} (segments that ran, the cut call's included)")
    del srv, dec, pre, fronts
    release_device_memory()

    # -- (c) SLO against FIFO, wall clock; then the hopeless row --------------
    # all 12 layers: the bursts must meet the background requests decoding
    slo_cfg = get_config("forge-125m").with_(kv_kernel="pallas")
    slo_params = get_model(slo_cfg).init(slo_cfg, torch.Generator(device=dev).manual_seed(0),
                                         dev)
    reqs = slo_workload(cfg.vocab)
    srv = paged_server(64, "ladder:8,16,32", "ladder:4", [4, 8], [4], (slo_cfg, slo_params))
    fronts = (srv.bucketed, srv.prefill_bucketed)
    runs = {}
    for slo in (False, True):
        srv.prefix_tree.clear()
        name = "slo" if slo else "slo_fifo"
        runs[slo] = counted(name, fronts, lambda: serve_with(srv, reqs, slo=slo))
        bad = [rid for rid, r in runs[slo]["results"].items() if "error" in r]
        check(not bad, f"{name}: requests failed {bad}")
    fifo, slo_res = runs[False], runs[True]
    check(slo_res["preemptions"] >= 1 and slo_res["shed"] == 0 and fifo["preemptions"] == 0,
          f"preemptions {slo_res['preemptions']} (FIFO {fifo['preemptions']}), shed "
          f"{slo_res['shed']}")
    diverged = [rid for rid, r in slo_res["results"].items()
                if not np.array_equal(r["tokens"], fifo["results"][rid]["tokens"])]
    check(not diverged, f"SLO against FIFO: requests diverged {diverged}")
    no_leaks(srv, "SLO run", len(reqs), slo_res)
    ratio = slo_res["ttft_p99_s"] / max(fifo["ttft_p99_s"], 1e-12)
    log(f"(c) SLO against FIFO, forge-125m bf16 paged (max_len 64, pages of 8, 4 slots, wall "
        f"clock, slo_serving workload): TTFT p99 {slo_res['ttft_p99_s'] * 1e3:.3f} ms against "
        f"{fifo['ttft_p99_s'] * 1e3:.3f} ms (ratio {ratio:.4f}); TTFT p50 "
        f"{slo_res['ttft_p50_s'] * 1e3:.3f} / {fifo['ttft_p50_s'] * 1e3:.3f} ms; latency p99 "
        f"{slo_res['latency_p99_s'] * 1e3:.3f} / {fifo['latency_p99_s'] * 1e3:.3f} ms; tok/s "
        f"{slo_res['tok_per_s']:.1f} / {fifo['tok_per_s']:.1f}; preemptions "
        f"{slo_res['preemptions']}, resumes {slo_res['resumes']}, shed {slo_res['shed']}; "
        f"{len(reqs)} requests bitwise equal across the two runs; 0 compiles after warmup; "
        f"launches SLO {dict(out['slo'])}, FIFO {dict(out['slo_fifo'])}")
    hopeless = slo_workload(cfg.vocab, burst_budget_s=1e-4, burst_priority=0)
    srv.prefix_tree.clear()
    shed = counted("slo_hopeless", fronts, lambda: serve_with(srv, hopeless))
    errs = [r for r in shed["results"].values() if "error" in r]
    check(shed["shed"] >= 1 and errs and all(r["error_type"] == "RequestError" for r in errs),
          f"hopeless budgets: shed {shed['shed']}, errors {[r.get('error') for r in errs]}")
    no_leaks(srv, "hopeless run", len(hopeless), shed)
    log(f"(c) hopeless budgets (1e-4 s, priority 0): shed {shed['shed']} (shed_rate "
        f"{shed['shed_rate']:.3f}), each a typed RequestError; {shed['real_tokens']} tokens")
    del srv, fronts, slo_params
    release_device_memory()

    # -- (d) contiguous preempt and resume (phase 8's fronts) -----------------
    def bg_burst():
        rng = np.random.default_rng(31)
        r = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (8,)).astype(np.int32),
                     max_new=24) for i in range(4)]
        r += [Request(rid=100 + j, prompt=rng.integers(0, cfg.vocab, (4,)).astype(np.int32),
                      max_new=3, arrival=4 + j, priority=2) for j in range(2)]
        return r

    srv = BatchedServer(cfg, params, max_len=256, mode="forge", bucket_policy="ladder:4")
    warm_graphs("contiguous ladder:4", lambda: srv.warmup([4], [8]))
    fronts = (srv.bucketed, srv.prefill_bucketed)
    cruns = {slo: counted("contig_slo" if slo else "contig_fifo", fronts,
                          lambda: serve_with(srv, bg_burst(), slo=slo))
             for slo in (False, True)}
    check(cruns[True]["preemptions"] >= 1 and cruns[True]["resumes"] >= 1,
          f"contiguous: preemptions {cruns[True]['preemptions']}")
    diverged = [rid for rid, r in cruns[True]["results"].items()
                if "error" in r or not np.array_equal(r["tokens"],
                                                      cruns[False]["results"][rid]["tokens"])]
    check(not diverged, f"contiguous resume: requests diverged {diverged}")
    pool = srv.bucketed.pool
    check(not any(isinstance(k, tuple) and k[:1] == ("parked",) and pool.pooled(k)
                  for k in list(pool._free)), "a parked row was left in the pool")
    log(f"(d) contiguous preempt and resume (max_len 256, rung 4, cell S16): preemptions "
        f"{cruns[True]['preemptions']}, resumes {cruns[True]['resumes']}; every request "
        f"bitwise equal to the FIFO run ({[rid for rid, r in cruns[True]['results'].items() if r['preempted']]} "
        f"parked, their rows in the bucket pool across the replays in between); "
        f"launches {dict(out['contig_slo'])}")
    del srv, fronts
    release_device_memory()

    # -- (e) a ladder re-fit on a shrinking batch -----------------------------
    def shrinking():
        rng = np.random.default_rng(41)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (6,)).astype(np.int32),
                        max_new=m) for i, m in enumerate((12, 12, 3, 3))]

    srv = paged_server(32, "ladder:8", "pow2", [6], [4])
    srv.warmup([2])  # decode rung 2 only: every admission runs on rung 4
    fronts = (srv.bucketed, srv.prefill_bucketed)
    base = counted("refit_base", fronts, lambda: serve_with(srv, shrinking()))
    srv.prefix_tree.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    refit = counted("refit", fronts, lambda: serve_with(srv, shrinking(), refit_interval=4,
                                                        refit_max_programs=1))
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = torch.cuda.memory_reserved()
    check(refit["refits"] >= 1 and refit["refit_evictions"] >= 1,
          f"re-fit: refits {refit['refits']}, evictions {refit['refit_evictions']}")
    diverged = [rid for rid, r in refit["results"].items()
                if "error" in r or not np.array_equal(r["tokens"], base["results"][rid]["tokens"])]
    check(not diverged, f"re-fit changed tokens of {diverged}")
    log(f"(e) re-fit (refit_interval 4, refit_max_programs 1) on 4 requests whose batch "
        f"shrinks 4 -> 2: refits {refit['refits']}, ladder now {srv.bucketed.policy.rungs} "
        f"(name {srv.bucketed.policy.name!r}), evicted {refit['refit_evictions']} program(s), "
        f"programs left {sorted(map(str, srv.bucketed.programs))}; memory_reserved "
        f"{mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB ({(mem0 - mem1) / 2**20:.1f} MiB freed); "
        f"tokens bitwise equal to the run without re-fit")
    del srv, fronts
    release_device_memory()

    # -- (f) the CLI's --chaos, run beside phases 6-7 (start_cli_runs) --------
    (code, stdout, stderr, seconds), = cli_runs["chaos"].join()
    chaos_line = [ln for ln in stdout.splitlines() if ln.startswith("[serve] chaos:")]
    check(code == 0 and chaos_line,
          f"the --chaos CLI exited {code}: {stdout[-2000:]} {stderr[-2000:]}")
    log(f"(f) CLI --continuous 12 --paged --chaos page.alloc=0.2,dispatch=0.05 --chaos-seed 3 "
        f"(beside phases 6-7): exit 0 in {seconds:.1f} s; {chaos_line[0]}")
    del params, model
    release_device_memory()
    return out


def phase12_qwen(dev, cfg, model, params, prompts):
    """Phase 12 on qwen2.5-14b's weights (phase 9's, one init): (a) the
    paged ``SlotScheduler`` with the paged-attention kernel at G = 5
    (depth QWEN_PAGED_LAYERS), (b)
    ``mode="jit"`` (depth QWEN_JIT_LAYERS), (c) the autotuner on the
    ``apply`` block body at B=1, S=1024, (d) phase 10's async compile and
    restart contract on the paged fronts (:func:`async_front`, depth
    QWEN_PAGED_LAYERS).  Returns the paths' launches."""
    t0 = time.perf_counter()
    out = {"qwen_paged": paged_path(dev, cfg.with_(n_layers=QWEN_PAGED_LAYERS),
                                    dict(params, blocks=params["blocks"][:QWEN_PAGED_LAYERS]),
                                    "qwen2.5-14b")}
    log(f"phase 12 (a) took {time.perf_counter() - t0:.1f} s")
    release_device_memory()
    L_ = QWEN_JIT_LAYERS
    jcfg, jparams = cfg, params
    if L_ != cfg.n_layers:
        jcfg = cfg.with_(n_layers=L_)
        jparams = dict(params, blocks=params["blocks"][:L_])
    out["jit_qwen"] = jit_path(dev, jcfg, model, jparams, prompts)
    release_device_memory()
    out["autotune_qwen"] = autotune_body(dev, cfg, params, 1, 1024)
    release_device_memory()
    t1 = time.perf_counter()
    out["qwen_async"] = async_front(dev, cfg.with_(n_layers=QWEN_PAGED_LAYERS),
                                    dict(params, blocks=params["blocks"][:QWEN_PAGED_LAYERS]),
                                    "qwen2.5-14b paged", paged=True)
    log(f"phase 12 (d) took {time.perf_counter() - t1:.1f} s")
    log(f"phase 12 on qwen2.5-14b took {time.perf_counter() - t0:.1f} s")
    return out


def phase12_forge(dev):
    """Phase 12 on forge-125m at full width: (b) ``mode="jit"`` at the
    CLI defaults against ``mode="interpret"``, (c) the autotuner on the
    ``apply`` block body at B=4, S=1024."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    release_device_memory()
    cfg = get_config("forge-125m")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    out = {"jit_forge": jit_path(dev, cfg, model, params, prompts, elementwise=True)}
    release_device_memory()
    out["autotune_forge"] = autotune_body(dev, cfg, params, 4, 1024)
    return out


def paged_path(dev, cfg, params, what):
    """Phase 12a (qwen2.5-14b at full width, QWEN_PAGED_LAYERS deep) and 13a
    (phi3.5-moe): the model through ``SlotScheduler`` over
    ``BatchedServer(mode="forge", paged=True)`` with the paged-attention
    kernel (``kv_kernel="pallas"``: qwen's 40 query heads on 8 KV heads,
    groups of 5; phi3.5-moe's groups of 4) on segment_jit, phase 5's
    workload (12 requests, a shared prefix, pages of 16, pow2 rungs of 4
    slots).  Launches exact (paged = layers x decode dispatches, fused
    linear = the programs' linear nodes x dispatches, flash 0), no compile
    or capture after warmup, ``pool.check()`` every tick (the
    scheduler's), no page leaked; one decode dispatch (and a prefill
    dispatch, where the family has a prefill front) bitwise against
    interpret, and the host/device split of steady ticks.  MoE has no
    batched prefill (capacity routing couples a block's tokens): its
    slots fill through the decode program, and no prefix is reused."""
    import numpy as np
    import torch
    from repro_torch.core.paging import build_row_table
    from repro_torch.launch.serve import BatchedServer, SlotScheduler

    pcfg = cfg.with_(kv_kernel="pallas")
    server = BatchedServer(pcfg, params, max_len=256, mode="forge", paged=True,
                           kv_page_size=16, seq_bucket_policy="ladder:16,32,64,128,256")
    sched = SlotScheduler(server, max_slots=4)
    reqs = paged_workload(cfg.vocab)
    t0 = time.perf_counter()
    warm_s = warm_graphs(f"{what} paged", lambda: server.warmup([2]) + server.warmup(
        [4], sorted({len(r.prompt) for r in reqs})))
    fronts = tuple(f for f in (server.bucketed, server.prefill_bucketed) if f is not None)
    batched_prefill = server.prefill_bucketed is not None
    check(batched_prefill == (cfg.family != "moe"),
          f"{what} paged: a prefill front for family {cfg.family}")
    for f, name in zip(fronts, ("decode", "prefill")):
        program_log(f, f"{what} paged {name}")
    n_prog = sum(len(f.programs) for f in fronts)
    log(f"{what} paged warmup: {n_prog} programs in {warm_s:.1f} s (wall "
        f"{time.perf_counter() - t0:.1f} s; {warm_s / n_prog:.1f} s a program)")
    caps = captures_now()
    calls0 = [dict(f.stats.per_bucket_calls) for f in fronts]
    reset_counts()
    res = sched.run(reqs)
    torch.cuda.synchronize()
    launched = counts()

    pool, tree = server.page_pool, server.prefix_tree
    for r in reqs:
        got = res["results"][r.rid]
        check("error" not in got, f"{what} paged request {r.rid} failed: {got.get('error')}")
        check(len(got["tokens"]) == r.max_new,
              f"{what} paged request {r.rid}: {len(got['tokens'])} tokens, budget {r.max_new}")
    check(res["swaps"] >= 1 and (res["prefix_hits"] >= 1) == batched_prefill
          and (res["prefill_dispatches"] > 0) == batched_prefill,
          f"{what} paged: swaps {res['swaps']}, prefix hits {res['prefix_hits']}, prefill "
          f"dispatches {res['prefill_dispatches']}")
    pool.check()
    check(pool.pages_in_use == 1 + tree.cached_pages,
          f"{what} paged: pages in use {pool.pages_in_use} != 1 + {tree.cached_pages} cached "
          f"(a page leaked)")
    check(res["compiles"] == 0 and captures_now() == caps,
          f"{what} paged: {res['compiles']} compiles after warmup, captures {captures_now()} "
          f"after {caps}")
    check(launched["paged_attention"] == cfg.n_layers * res["decode_dispatches"] > 0,
          f"{what} paged: paged launches {launched['paged_attention']} != {cfg.n_layers} x "
          f"{res['decode_dispatches']} decode dispatches")
    want_fl = sum(linear_nodes(mod) * (f.stats.per_bucket_calls.get(str(key), 0)
                                       - c0.get(str(key), 0))
                  for f, c0 in zip(fronts, calls0) for key, mod in f.programs.items())
    check(launched["fused_linear"] == want_fl > 0,
          f"{what} paged: fused_linear launches {launched['fused_linear']} != {want_fl} "
          f"predicted from the programs' linear nodes x dispatches")
    check(launched["flash_attention"] == 0 and launched["rg_lru"] == 0,
          f"{what} paged: flash {launched['flash_attention']}, rg_lru {launched['rg_lru']}")
    per_prog = {str(k): round(v, 2) for f in fronts
                for k, v in f.stats.per_bucket_compile_s.items()}
    log(f"paged serve {what} (bf16, {cfg.n_layers} layers, kv_kernel=pallas, "
        f"G={cfg.n_heads // cfg.n_kv_heads}, max_slots 4, "
        f"page 16, {pool.num_pages} pages): {len(reqs)} requests, {res['real_tokens']} "
        f"tokens, {res['tok_per_s']:.1f} tok/s, tick p50 {res['tick_ms_p50']:.2f} ms p99 "
        f"{res['tick_ms_p99']:.2f} ms, TTFT p50 {res['ttft_p50_ticks']:.1f} ticks "
        f"{res['ttft_p50_s'] * 1e3:.2f} ms; decode dispatches {res['decode_dispatches']}, "
        f"prefill dispatches {res['prefill_dispatches']}, swaps {res['swaps']}, prefix hits "
        f"{res['prefix_hits']}, peak pages {res['kv_peak_pages_in_use']}; compile s per "
        f"program {per_prog}; 0 pages leaked, pool.check() on every tick; launches "
        f"{launched}, {launched.variants}")

    # segment_jit against interpret: a decode tick on the cached shared
    # prefix plus a fresh page a row (positions 32..35), and a B4 x S16
    # prefill dispatch on the same rows at 32; without a prefill front
    # (MoE) the rows' first two pages are fresh too
    B, MP = 4, server.max_pages_per_slot
    chain = []
    if batched_prefill:
        chain, n_tok = tree.match(reqs[0].prompt, max_tokens=32)
        check(n_tok == 32, f"{what} paged: the shared prefix is not cached ({n_tok} tokens)")
    own = [pool.alloc(2 if chain else 4) for _ in range(B)]
    pt = torch.from_numpy(np.stack([build_row_table(chain + o, MP) for o in own])).to(dev)
    pos = torch.tensor([32, 33, 34, 35], dtype=torch.int32, device=dev)
    tok = torch.tensor([[t % cfg.vocab] for t in (11, 222, 3333, 44444)], dtype=torch.int32,
                       device=dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    store = server.page_store
    twins = interpret_twins(fronts)
    ptoks = torch.randint(0, cfg.vocab, (B, 16), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(13))
    ppos = torch.full((B,), 32, dtype=torch.int32, device=dev)
    dispatches = [("decode", server.bucketed.key_for_extents(B), 0,
                   (params, store, pt, tok, pos, mask))]
    if batched_prefill:
        dispatches.append(("prefill", server.prefill_bucketed.key_for_extents((B, 16)), 1,
                           (params, store, pt, ptoks, ppos, mask)))
    with torch.no_grad():
        hold_against_interpret(f"{what} paged", dispatches, fronts, twins)
    dmod = server.bucketed.lookup_program(server.bucketed.key_for_extents(B))

    def ticks():
        st = {"tok": tok, "pos": pos, "store": store}

        def one():
            st["tok"], st["store"] = dmod(params, st["store"], pt, st["tok"], st["pos"], mask)
            st["pos"] = st["pos"] + 1

        return one

    backend_split(f"{what} paged decode tick (B=4)", fronts, twins, ticks, dmod)
    for o in own:
        pool.free(o)
    pool.check()
    return launched


def jit_path(dev, cfg, model, params, prompts, elementwise=False, rows_independent=True):
    """Phase 12b: ``BatchedServer(mode="jit")`` at batch 4, prompt 32, 32
    new tokens: the step compiled whole (``torch.compile(fullgraph=True)``,
    one CUDA graph a batch size, built in warmup), then one generation.
    Launches exact (the graph's fused-linear nodes x steps, recorded at
    capture and added per replay; nothing else), one graph, no compile in
    the generation, the cache in place.  Greedy tokens against
    ``mode="interpret"``'s: equal, or a row held at its first differing
    token by the measured-slack rule (``first_token_slack``).  Every
    step's logits, teacher-forced on interpret's tokens, against the
    interpreted step's, each path on a cache of its own: within
    SPREAD_FACTOR_BF16 times the run's spread between two kernel-free
    implementations in relative L2 over all steps, and with
    ``elementwise`` (forge-125m, phase 3's model) within TOL_MODEL_BF16
    at every step.  A MoE step couples its rows (capacity routing), so
    with ``rows_independent=False`` a differing row is only reported: the
    teacher-forced logits hold the step.  Returns the launches."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.launch.serve import BatchedServer

    B, P = prompts.shape
    n_new, max_len = 32, 256
    what = f"jit {cfg.name} ({cfg.n_layers} layers)"
    server = BatchedServer(cfg, params, max_len=max_len, mode="jit")
    warm_s = server.warmup([B])
    step = server.jit_steps[B]
    check(step.graphs == 1, f"{what}: {step.graphs} graphs compiled, not 1")
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(step.cache)]
    reset_counts()
    res = server.generate(prompts, n_new)
    torch.cuda.synchronize()
    launched = counts()
    steps = P + n_new - 1
    per_step = step.kernel_nodes.get("fused_linear", 0)
    check(res["compile_s"] == 0.0 and step.graphs == 1,
          f"{what}: compiled in the generation ({res['compile_s']} s, {step.graphs} graphs)")
    check(launched["fused_linear"] == per_step * steps > 0,
          f"{what}: fused_linear launches {launched['fused_linear']} != {per_step} graph "
          f"nodes x {steps} steps")
    check(not any(v for k, v in launched.items() if k != "fused_linear"),
          f"{what}: launched {launched}")
    check([t.data_ptr() for t in pytree.tree_leaves(step.cache)] == ptrs,
          f"{what}: the cache moved")
    interp_tokens = BatchedServer(cfg, params, max_len=max_len,
                                  mode="interpret").generate(prompts, n_new)["tokens"]
    same_rows = int((res["tokens"] == interp_tokens).all(axis=1).sum())
    same = int((res["tokens"] == interp_tokens).sum())
    diverged = hold_diverged_rows(model, cfg, params, prompts, res["tokens"], interp_tokens,
                                  dev, what, rows_independent)

    # every step's logits, teacher-forced: the prompt, then interpret's
    # tokens, fed to the jit step and, each on a cache of its own, to the
    # interpreted step and to two kernel-free implementations (impl="ref",
    # fused and unfused), whose difference is the run's spread
    feed = torch.as_tensor(np.concatenate([prompts, interp_tokens[:, :-1]], axis=1),
                           dtype=torch.int64, device=dev)
    paths = {"interp": (cfg, None), "ref": (cfg, "ref"), "raw": (cfg.with_(fuse="none"), "ref")}
    caches = {name: model.init_cache(cfg, B, max_len, device=dev) for name in paths}
    rows = {name: [] for name in ("jit", *paths)}
    jcache = step.reset()
    with torch.no_grad():
        for t in range(feed.shape[1]):
            tok_t = feed[:, t:t + 1]
            step(params, jcache, tok_t, t)
            rows["jit"].append(step.last_logits().float())
            for name, (c, impl) in paths.items():
                n0 = sum(counts().values())
                lg, caches[name] = model.decode_step(params, caches[name], tok_t, t, c, impl=impl)
                rows[name].append(lg[:, -1].float())
                check(impl is None or sum(counts().values()) == n0,
                      f"{what}: the impl='ref' step launched a kernel")
    got, interp, ref, raw = (torch.stack(rows[k]) for k in ("jit", "interp", "ref", "raw"))
    del rows, caches
    check(torch.isfinite(got).all().item(), f"{what}: non-finite logits")
    spread = rel_l2(ref, raw)
    got_r = rel_l2(got, interp)
    per_step = [rel_l2(got[t], interp[t]) for t in range(got.shape[0])]
    check(got_r <= SPREAD_FACTOR_BF16 * spread,
          f"{what}: teacher-forced logits over {got.shape[0]} steps: relative L2 {got_r:.3e} of "
          f"the interpreted step above {SPREAD_FACTOR_BF16} x the spread {spread:.3e}")
    if elementwise:
        assert_close(got, interp, torch.bfloat16,
                           f"{what}: teacher-forced logits against the interpreted step",
                           TOL_MODEL_BF16)
    split = ", ".join(f"{k} {v:.1f} s" for k, v in step.compile_split.items())
    log(f"{what} batch={B} prompt={P} gen={n_new}: warmup {warm_s:.1f} s ({split}; the rest "
        f"is Triton's kernel loads, the warm runs and the CUDA graph); {step.graphs} graph "
        f"of {step.graph_nodes} "
        f"nodes, kernel nodes {step.kernel_nodes}; ttft {res['ttft_s'] * 1e3:.2f} ms, decode "
        f"p50 {res['decode_ms_p50']:.3f} ms p99 {res['decode_ms_p99']:.3f} ms, "
        f"{res['tok_per_s']:.1f} tok/s; launches {launched}, {launched.variants}; cache in "
        f"place; greedy tokens equal to mode='interpret' in {same_rows}/{B} rows "
        f"({same}/{res['tokens'].size} tokens)"
        + (f"; diverged rows held at their first differing token: {diverged}"
           if diverged else ""))
    log(f"{what} logits at every one of {got.shape[0]} teacher-forced steps: "
        f"{got_r:.3e} relative L2 of the interpreted step (bound {SPREAD_FACTOR_BF16} x the "
        f"spread {spread:.3e} between two kernel-free implementations; per step max "
        f"{max(per_step):.3e} at step {int(np.argmax(per_step))}), {rel_l2(got, ref):.3e} of "
        f"impl='ref'; max abs {(got - interp).abs().max().item():.3e}"
        + (" within TOL_MODEL_BF16 at every step" if elementwise else "")
        + f"; argmax equal in {int((got.argmax(-1) == interp.argmax(-1)).sum())}/"
        f"{got.shape[0] * B} (step, row) pairs")
    return launched


def hold_diverged_rows(model, cfg, params, prompts, got, want, dev, what,
                       rows_independent=True):
    """Greedy tokens ``got`` (a compiled step's) against ``want``
    (``mode="interpret"``'s) on the same prompts.  Inductor's reductions
    (softmax, the norms) and its erf and exp are not the eager kernels',
    so bf16 rows can part at a near-tie: a row that differs is held at its
    first differing token, where both picks must be top choices of the
    plain path within the measured slack (:func:`first_token_slack`).  A
    MoE step couples its rows (``rows_independent=False``): a differing
    row is only reported.  Returns a line for each differing row, with
    the picks' margins below the plain path's top logit."""
    import numpy as np

    diverged = []
    for b in np.flatnonzero((got != want).any(axis=1)):
        j = int(np.flatnonzero(got[b] != want[b])[0])
        ctx = np.concatenate([prompts[b], got[b, :j]])
        picks = [int(got[b, j]), int(want[b, j])]
        if not rows_independent:
            diverged.append(f"row {b} from token {j}: picks {picks}")
            continue
        spread, slack, margins = first_token_slack(model, cfg, params, ctx, picks, dev,
                                                   f"{what} row {b} token {j}")
        diverged.append(f"row {b} from token {j}: picks {picks} margins "
                        f"{[round(m, 4) for m in margins]} within slack {slack:.4f}")
    return diverged


def autotune_body(dev, cfg, params, B, S):
    """Phase 12c: ``AutotuningCompiler().compile`` on the block body
    ``apply`` compiles (layer 0's weights, the embedded tokens, RoPE at
    S positions; unmasked causal attention, so flash launches): 47
    candidates scored on copies of one capture, the winner compiled and
    run (its launches the path's), within the bf16 kernel tolerance of
    the default pipeline's body."""
    import numpy as np
    import torch
    from repro_torch.core import AutotuningCompiler, ForgeCompiler
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    what = f"autotune {cfg.name} block body B={B} S={S}"
    p0 = params["blocks"][0]
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(23))

    def body(*a):
        return T.block_apply(*a, cfg=cfg)

    with torch.no_grad():
        x = L.embed(tokens, params["embed"])
        cos, sin = T._rope_for(cfg, torch.arange(S, device=dev))
        args = (p0, x, cos, sin)
        t0 = time.perf_counter()
        mod = AutotuningCompiler().compile(body, *args)
        total_s = time.perf_counter() - t0
        default = ForgeCompiler().compile(body, *args)
        want = default(*args)
        reset_counts()
        got = mod(*args)
        torch.cuda.synchronize()
        launched = counts()
    tr = mod.tune_result
    best = tr.best
    ms = [c.time_ms for c in tr.candidates]
    check(len(tr.candidates) == 47 and best.score <= min(c.score for c in tr.candidates),
          f"{what}: {len(tr.candidates)} candidates, best {best}")
    check(launched["flash_attention"] == flash_nodes(mod) == 1,
          f"{what}: flash launches {launched['flash_attention']}, nodes {flash_nodes(mod)}")
    check(launched["fused_linear"] == linear_nodes(mod) > 0,
          f"{what}: fused_linear launches {launched['fused_linear']} != {linear_nodes(mod)}")
    err = assert_close(got, want, torch.bfloat16, f"{what}: winner against the default body")
    log(f"{what}: winner alpha={best.alpha} layout={best.layout} precision={best.precision} "
        f"rounds={best.max_rounds} (score {best.score:.4f}, {best.nodes_after} nodes; the "
        f"default pipeline's {default.result.cost.score:.4f}, {default.result.nodes_after} "
        f"nodes); {len(tr.candidates)} candidates, passes + score per candidate mean "
        f"{np.mean(ms):.2f} ms max {max(ms):.2f} ms ({sum(ms):.1f} ms in all); the one export "
        f"{tr.capture_ms / 1e3:.2f} s; tune {tr.total_ms / 1e3:.2f} s, tune + compile "
        f"{total_s:.2f} s; winner within bf16 tolerance of the default body (max abs err "
        f"{err:.3e}); launches {launched}, {launched.variants}")
    return launched


def phase13(dev):
    """Phase 13: the MoE and VLM families at full width, each model freed
    before the next.  Returns the paths' launches."""
    out = {}
    for name, fn in (("(a) phi3.5-moe", phase13_phi), ("(b) qwen2-vl-72b", phase13_vl),
                     ("(c) kimi-k2", phase13_kimi)):
        t0 = time.perf_counter()
        out.update(fn(dev))
        release_device_memory()
        log(f"phase 13 {name} took {time.perf_counter() - t0:.1f} s")
    return out


def full_width_model(dev, arch, n_layers, widths, dtype="bfloat16"):
    """``arch`` at its published widths (``widths``, checked field by field)
    with the depth cut to ``n_layers``, random weights from seed 0."""
    import gc

    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    gc.collect()
    release_device_memory()
    full = get_config(arch)
    check({k: getattr(full, k) for k in widths} == widths, f"{arch} is {full}")
    cfg = full.with_(n_layers=n_layers, dtype=dtype)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    leaves = {id(t): t for t in pytree.tree_leaves(params)}.values()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"{arch} ({dtype}): {n_layers} of {full.n_layers} layers at full width, "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} GB; "
        f"{2 * full.param_count() / 1e9:.1f} GB in bf16 at full depth) made in "
        f"{time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, model, params, nbytes


def forge_bodies(cfg, mode, shape=None):
    """The Forge-compiled block bodies of ``cfg`` in ``mode`` (kernels on),
    with ``shape``, only those with an input of that shape."""
    from repro_torch.models import _forge

    return [m for k, m in _forge._CACHE.items()
            if k.startswith(f"{cfg!r}/{mode}/") and "impl=None" in k
            and (shape is None or str(tuple(shape)) in k)]


def within_spread(what, got, ref, raw):
    """The bf16 rule of a deep or routed model: ``got`` within max(
    REL_L2_DEEP_BF16, SPREAD_FACTOR_BF16 x the spread between two
    kernel-free implementations) relative L2 of ``ref``; a routed model
    can send a near-tied token to another expert in any two of them."""
    import torch

    got_r, spread = rel_l2(got, ref), rel_l2(ref, raw)
    bound = max(REL_L2_DEEP_BF16, SPREAD_FACTOR_BF16 * spread)
    check(bool(torch.isfinite(got).all().item()), f"{what}: non-finite values")
    check(got_r <= bound, f"{what}: relative L2 {got_r:.3e} of impl='ref' above {bound:.3e}")
    log(f"{what} against impl='ref': {got_r:.3e} relative L2 (max abs "
        f"{(got.float() - ref.float()).abs().max().item():.3e}); two kernel-free "
        f"implementations (compiled and unfused) differ by {spread:.3e}; bound {bound:.3e}"
        + (f" ({bound / got_r:.2f}x the error)" if got_r > 0 else ""))


def apply_path(dev, cfg, model, params, what, S, seed, patches=0):
    """``apply`` at B=1 over S positions through the compiler (for the VLM:
    ``patches`` patch embeddings ahead of S - patches text tokens, the
    stub frontend): flash launches = layers (``wgmma``), fused linear =
    the body's linear nodes x layers; logits finite, of shape (1, S,
    vocab), and within :func:`within_spread` of impl="ref";
    ``memory_allocated`` before and after the body's compile and the
    peak.  Returns the launches."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (1, S - patches), device=dev, generator=g)
    kw = {}
    if patches:
        kw["patch_embeds"] = (torch.randn(1, patches, cfg.d_model, generator=g, device=dev)
                              * 0.02).to(torch.bfloat16)
    with torch.no_grad():
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model.apply(params, tokens, cfg, **kw)  # compiles the apply body
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        mem1, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        logits = model.apply(params, tokens, cfg, **kw)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        applied = counts()
    (abody,) = forge_bodies(cfg, "apply")
    check(applied["flash_attention"] == flash_nodes(abody) * cfg.n_layers == cfg.n_layers,
          f"{what} apply: flash launches {applied['flash_attention']} != {cfg.n_layers}")
    check(applied["fused_linear"] == linear_nodes(abody) * cfg.n_layers > 0,
          f"{what} apply: fused_linear launches {applied['fused_linear']} != "
          f"{linear_nodes(abody) * cfg.n_layers}")
    check(applied.variants["flash_attention"] == {"wgmma": cfg.n_layers},
          f"{what} apply: flash variants {applied.variants['flash_attention']}")
    check(not applied["paged_attention"] and not applied["rg_lru"],
          f"{what} apply: launched {applied}")
    check(tuple(logits.shape) == (1, S, cfg.vocab), f"{what} apply logits {logits.shape}")
    log(f"apply {what} B=1 S={S}" + (f" ({patches} patch embeddings)" if patches else "")
        + f": flash launches {applied['flash_attention']}, fused_linear "
        f"{applied['fused_linear']} ({applied.variants}); first call {first_s:.1f} s (body "
        f"compile included), steady call {apply_ms:.1f} ms host wall; memory_allocated "
        f"{mem0 / 2**30:.2f} GiB before the compile, {mem1 / 2**30:.2f} GiB after, peak "
        f"{peak / 2**30:.2f} GiB; fused nodes of the body {fused_counts(abody)}")
    log_pass_table(f"{what} apply block body", abody.result)
    log_device_time(lambda: model.apply(params, tokens, cfg, **kw), f"{what} apply B=1 S={S}")
    with torch.no_grad():
        reset_counts()
        ref = model.apply(params, tokens, cfg, impl="ref", **kw)
        raw = model.apply(params, tokens, cfg.with_(fuse="none"), impl="ref", **kw)
        check(not any(counts().values()), f"{what}: the impl='ref' apply launched a kernel")
    within_spread(f"{what} apply logits", logits, ref, raw)
    return applied


def interpret_path(dev, cfg, params, prompts, n_new, what):
    """``BatchedServer(mode="interpret")`` (sequential prefill through the
    decode step, Forge-compiled block bodies): tokens of shape (B, n_new),
    fused linear = the decode body's linear nodes x layers x steps and no
    other launch.  Returns (launches, result)."""
    import torch
    from repro_torch.launch.serve import BatchedServer

    B, P = prompts.shape
    eager = BatchedServer(cfg, params, max_len=256, mode="interpret")
    reset_counts()
    res = eager.generate(prompts, n_new)
    torch.cuda.synchronize()
    served = counts()
    (dbody,) = forge_bodies(cfg, "decode")
    steps = P + n_new - 1
    per_step = linear_nodes(dbody) * cfg.n_layers
    check(res["tokens"].shape == (B, n_new), f"{what} eager token shape {res['tokens'].shape}")
    check(served["fused_linear"] == per_step * steps > 0,
          f"{what} eager: fused_linear launches {served['fused_linear']} != {per_step} per "
          f"step x {steps} steps")
    check(not any(v for k, v in served.items() if k != "fused_linear"),
          f"{what} eager: launched {served}")
    log(f"serve {what} interpret (bf16, {cfg.n_layers} layers) batch={B} prompt={P} "
        f"gen={n_new}: ttft {res['ttft_s'] * 1e3:.1f} ms (sequential prefill, body compile "
        f"included), decode p50 {res['decode_ms_p50']:.2f} ms p99 {res['decode_ms_p99']:.2f} "
        f"ms, {res['tok_per_s']:.1f} tok/s; fused_linear launches {served['fused_linear']} = "
        f"{per_step} per step ({served.variants}); fused nodes of the body "
        f"{fused_counts(dbody)}")
    log_pass_table(f"{what} decode block body", dbody.result)
    return served, res


def contiguous_path(dev, cfg, params, prompts, n_new, what, floor_ms):
    """The contiguous forge fronts at the CLI's defaults on segment_jit:
    one decode program (rung 4), no prefill front (MoE capacity routing
    couples a block's tokens; the VLM has none), so the prompt replays
    through the decode program; no compile or capture in the generation,
    fused linear = the program's linear nodes x dispatches; one decode
    dispatch and the served tokens bitwise against interpret, and the
    host/device split.  Returns the launches."""
    import torch
    from repro_torch.launch.serve import BatchedServer

    B, P = prompts.shape
    server = BatchedServer(cfg, params, max_len=256, mode="forge", bucket_policy="ladder:4")
    warm_s = warm_graphs(f"{what} contiguous", lambda: server.warmup([B], prompt_lens=[P]))
    front = server.bucketed
    check(server.prefill_bucketed is None and len(front.programs) == 1,
          f"{what}: warmup built {len(front.programs)} decode programs and a prefill front "
          f"{server.prefill_bucketed}")
    program_log(front, f"{what} decode")
    for key, mod in front.programs.items():
        log_pass_table(f"{what} decode program {key}", mod.result)
    caps, compiles0 = captures_now(), front.stats.compiles
    calls0 = dict(front.stats.per_bucket_calls)
    reset_counts()
    res = server.generate(prompts, n_new)
    torch.cuda.synchronize()
    served = counts()
    calls = {k: v - calls0.get(k, 0) for k, v in front.stats.per_bucket_calls.items()}
    want_fl = sum(linear_nodes(mod) * calls.get(str(key), 0) for key, mod in front.programs.items())
    check(front.stats.compiles == compiles0 and captures_now() == caps,
          f"{what}: a program compiled or captured after warmup")
    check(res["prefill_mode"] == "sequential" and res["tokens"].shape == (B, n_new)
          and res["compile_s"] == 0.0, f"{what}: served {res['prefill_mode']} "
                                       f"{res['tokens'].shape}")
    check(served["fused_linear"] == want_fl > 0,
          f"{what}: fused_linear launches {served['fused_linear']} != {want_fl} predicted "
          f"from the program's linear nodes x dispatches")
    check(not any(v for k, v in served.items() if k != "fused_linear"),
          f"{what}: launched {served}")
    log(f"serve {what} contiguous (segment_jit, bf16, {cfg.n_layers} layers) batch={B} "
        f"prompt={P} gen={n_new}: warmup {warm_s:.1f} s; ttft {res['ttft_s'] * 1e3:.2f} ms "
        f"(sequential prefill), decode p50 {res['decode_ms_p50']:.2f} ms p99 "
        f"{res['decode_ms_p99']:.2f} ms, {res['tok_per_s']:.1f} tok/s (the weights' byte "
        f"bound {floor_ms:.3f} ms a step); {sum(calls.values())} decode dispatches; launches "
        f"{served}, {served.variants}")
    contiguous_backends(f"{what} contiguous", server, prompts, n_new, floor_ms=floor_ms)
    return served


def phase13_phi(dev):
    """Phase 13 (a): phi3.5-moe-42b-a6.6b at full width (d 4096, 32 heads
    on 8 KV heads, 16 experts of d_ff 6400, top-2, vocab 32064), MOE_LAYERS
    layers: the paged ``SlotScheduler`` with the paged kernel over phase
    5's workload, the contiguous fronts at the CLI's defaults, ``apply``
    at B=1, S=1024, the jit step at MOE_JIT_LAYERS layers; then f32."""
    import numpy as np

    cfg, model, params, nbytes = full_width_model(dev, "phi3.5-moe-42b-a6.6b", MOE_LAYERS, {
        "d_model": 4096, "n_heads": 32, "n_kv_heads": 8, "n_experts": 16, "d_ff": 6400,
        "top_k": 2, "vocab": 32064, "n_layers": 32})
    prompts = np.random.default_rng(21).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    out = {"phi_paged": paged_path(dev, cfg, params, "phi3.5-moe")}
    release_device_memory()
    out["phi_serve"] = contiguous_path(dev, cfg, params, prompts, 32, "phi3.5-moe",
                                       nbytes / HBM_BYTES_PER_S * 1e3)
    release_device_memory()
    out["phi_apply"] = apply_path(dev, cfg, model, params, "phi3.5-moe", 1024, 22)
    release_device_memory()
    jcfg = cfg.with_(n_layers=MOE_JIT_LAYERS)
    out["jit_phi"] = jit_path(dev, jcfg, model, dict(params, blocks=params["blocks"][:2]),
                              prompts, rows_independent=False)
    del params
    release_device_memory()
    phase13_phi_f32(dev, prompts)
    return out


def phase13_phi_f32(dev, prompts):
    """phi3.5-moe's kernels held elementwise in f32 (F32_CHECK_LAYERS
    layers, 21.3 GB): the served decode program's sequential prefill of 8 prompt
    tokens (the written cache and the first token) against the
    ``impl="ref"`` interpret server, and ``apply`` at B=1, S=256 against
    impl="ref", within TOL_DEEP_F32.  S is 256 (the bf16 apply's 1024
    above): an f32 comparison of a routed model holds elementwise only
    where no router logit pair lies within rounding of a tie, and fewer
    tokens give fewer such chances."""
    import torch
    from repro_torch.launch.serve import BatchedServer

    cfg, model, params, _ = full_width_model(dev, "phi3.5-moe-42b-a6.6b", F32_CHECK_LAYERS, {
        "d_model": 4096, "n_experts": 16}, dtype="float32")
    short = prompts[:, :8]
    P = short.shape[1]
    server = BatchedServer(cfg, params, max_len=256, mode="forge", bucket_policy="ladder:4")
    with torch.no_grad():
        t0 = time.perf_counter()
        cache, tok, _, _, key = server.prefill(short)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ref_cache, ref_tok, _, _, _ = BatchedServer(cfg, params, max_len=256, mode="interpret",
                                                    impl="ref").prefill(short)
    check(torch.equal(tok.long().cpu(), ref_tok.long().cpu()),
          f"phi3.5-moe f32: first tokens {tok.flatten().tolist()} against impl='ref' "
          f"{ref_tok.flatten().tolist()}")
    errs = {name: assert_close(cache[name][:, :, :, :P], ref_cache[name][:, :, :, :P],
                               torch.float32, f"phi3.5-moe f32 prefilled {name} cache",
                               TOL_DEEP_F32) for name in ("k", "v")}
    del server, cache, ref_cache
    tokens = torch.randint(0, cfg.vocab, (1, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(23))
    with torch.no_grad():
        got = model.apply(params, tokens, cfg)
        want = model.apply(params, tokens, cfg, impl="ref")
    errs["apply"] = assert_close(got, want, torch.float32, "phi3.5-moe f32 apply logits",
                                 TOL_DEEP_F32)
    log(f"f32 phi3.5-moe (full width, {cfg.n_layers} of 32 layers): the served decode program "
        f"{key} (prefill of {P} tokens, compiled in {compile_s:.1f} s) against the "
        f"impl='ref' interpret server, first tokens equal, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (apply B=1 S=256, {rel_l2(got, want):.3e} relative L2); all within rtol "
          f"{TOL_DEEP_F32['rtol']} atol {TOL_DEEP_F32['atol']}")
    del params, got, want


def phase13_vl(dev):
    """Phase 13 (b): qwen2-vl-72b at full width (d 8192, 64 heads on 8 KV
    heads, d_ff 29568, vocab 152064, QKV bias, M-RoPE sections 16/24/24),
    VLM_LAYERS layers: the interpret server and the contiguous fronts at
    the CLI's defaults, ``apply`` with 16 patch embeddings at B=1,
    S=1024."""
    import numpy as np

    cfg, model, params, nbytes = full_width_model(dev, "qwen2-vl-72b", VLM_LAYERS, {
        "d_model": 8192, "n_heads": 64, "n_kv_heads": 8, "d_ff": 29568, "vocab": 152064,
        "qkv_bias": True, "mrope_sections": (16, 24, 24), "n_layers": 80})
    prompts = np.random.default_rng(24).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    out = {"vl_eager": interpret_path(dev, cfg, params, prompts, 32, "qwen2-vl-72b")[0]}
    out["vl_serve"] = contiguous_path(dev, cfg, params, prompts, 32, "qwen2-vl-72b",
                                      nbytes / HBM_BYTES_PER_S * 1e3)
    release_device_memory()
    out["vl_apply"] = apply_path(dev, cfg, model, params, "qwen2-vl-72b", 1024, 25, patches=16)
    del params
    return out


def phase13_kimi(dev):
    """Phase 13 (c): kimi-k2-1t-a32b at full width (d 7168, 64 heads of 112
    on 8 KV heads, 384 experts of d_ff 2048, top-8, one shared expert,
    vocab 163840), KIMI_LAYERS layer: ``apply`` at B=1, S=256 against
    impl="ref", and 8 greedy decode steps through the interpret server,
    whose last step's logits are held against impl="ref" by the same
    rule."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchedServer

    cfg, model, params, _ = full_width_model(dev, "kimi-k2-1t-a32b", KIMI_LAYERS, {
        "d_model": 7168, "n_heads": 64, "n_kv_heads": 8, "head_dim": 112, "n_experts": 384,
        "top_k": 8, "d_ff": 2048, "shared_experts": 1, "shared_d_ff": 2048, "vocab": 163840,
        "n_layers": 61})
    out = {"kimi_apply": apply_path(dev, cfg, model, params, "kimi-k2", 256, 26)}
    prompts = np.random.default_rng(27).integers(0, cfg.vocab, (4, 8)).astype(np.int32)
    out["kimi_eager"], res = interpret_path(dev, cfg, params, prompts, 8, "kimi-k2")
    # the next step after the served tokens, on caches of the kernel path
    # and of two kernel-free ones fed the same context
    ctx = np.concatenate([prompts, res["tokens"][:, :-1]], axis=1)
    last = torch.as_tensor(res["tokens"][:, -1:], dtype=torch.int64, device=dev)
    logits = {}
    with torch.no_grad():
        for name, c, impl in (("kernels", cfg, None), ("ref", cfg, "ref"),
                              ("raw", cfg.with_(fuse="none"), "ref")):
            srv = BatchedServer(c, params, max_len=256, mode="interpret", impl=impl)
            cache, _, pos, _, _ = srv.prefill(ctx)
            logits[name] = model.decode_step(params, cache, last, pos, c, impl=impl)[0]
    within_spread(f"kimi-k2 decode logits at pos {ctx.shape[1]}", logits["kernels"],
                  logits["ref"], logits["raw"])
    del params
    return out


ED_ARCH = "seamless-m4t-large-v2"
ED_WIDTHS = {"d_model": 1024, "n_heads": 16, "n_kv_heads": 16, "d_ff": 8192, "vocab": 256206,
             "n_enc_layers": 24, "n_dec_layers": 24, "ffn": "gelu", "ffn_bias": True,
             "tie_embeddings": True}


def phase14(dev):
    """Phase 14: seamless-m4t-large-v2 at full width and depth (24 + 24
    layers, bf16, random weights from seed 0): (a) ``apply`` at B2, T1024
    frames, S256 tokens; (c) greedy serving at B4 through the serve step
    compiled whole; then (b) ``apply`` in f32 at B1 T256 S64.  Returns the
    launches of (a) and (c)."""
    t0 = time.perf_counter()
    cfg, model, params, _ = full_width_model(dev, ED_ARCH, 24, ED_WIDTHS)
    out = {"encdec_apply": phase14_apply(dev, cfg, model, params)}
    log(f"phase 14 (a) apply took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["encdec_serve"] = phase14_serve(dev, cfg, model, params)
    log(f"phase 14 (c) serve took {time.perf_counter() - t0:.1f} s")
    del params
    release_device_memory()
    t0 = time.perf_counter()
    phase14_f32(dev)
    log(f"phase 14 (b) f32 apply took {time.perf_counter() - t0:.1f} s")
    return out


def encdec_inputs(dev, cfg, B, T, S, seed, dtype):
    """Frame embeddings (the stub audio frontend: N(0, 1) in the model's
    dtype) and decoder tokens, from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn(B, T, cfg.d_model, generator=g, device=dev).to(dtype)
    return frames, torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)


def phase14_apply(dev, cfg, model, params):
    """Phase 14 (a): ``apply`` at B2, T1024 frames, S256 tokens through the
    Forge-compiled encoder and decoder bodies: flash once an encoder layer
    (non-causal, Sq = Sk) and twice a decoder layer (causal self-attention,
    non-causal cross-attention at Sq < Sk), all ``wgmma``; fused linear =
    the bodies' linear nodes x layers; the device time by kernel; logits
    finite, (B, S, vocab), within :func:`within_spread` of impl="ref"."""
    import torch

    B, T, S = 2, 1024, 256
    frames, tokens = encdec_inputs(dev, cfg, B, T, S, 41, torch.bfloat16)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
    with torch.no_grad():
        t0 = time.perf_counter()
        model.apply(params, frames, tokens, cfg)  # compiles the two bodies
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        logits = model.apply(params, frames, tokens, cfg)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        applied = counts()
    (ebody,), (dbody,) = forge_bodies(cfg, "enc"), forge_bodies(cfg, "dec")
    want_fa = flash_nodes(ebody) * n_enc + flash_nodes(dbody) * n_dec
    want_fl = linear_nodes(ebody) * n_enc + linear_nodes(dbody) * n_dec
    check(applied["flash_attention"] == want_fa == n_enc + 2 * n_dec,
          f"seamless-m4t apply: flash launches {applied['flash_attention']} != {want_fa}")
    check(applied["fused_linear"] == want_fl == 3 * n_enc + 4 * n_dec,
          f"seamless-m4t apply: fused_linear launches {applied['fused_linear']} != {want_fl}")
    check(applied.variants["flash_attention"] == {"wgmma": want_fa},
          f"seamless-m4t apply: flash variants {applied.variants['flash_attention']}")
    check(not applied["paged_attention"] and not applied["rg_lru"] and not applied["rms_norm"],
          f"seamless-m4t apply: launched {applied}")
    check(tuple(logits.shape) == (B, S, cfg.vocab), f"seamless-m4t apply logits {logits.shape}")
    log(f"apply seamless-m4t-large-v2 B={B} T={T} S={S}: flash launches "
        f"{applied['flash_attention']}, fused_linear {applied['fused_linear']} "
        f"({applied.variants}); first call {first_s:.1f} s (two body compiles included), steady "
        f"call {apply_ms:.1f} ms host wall; fused nodes of the bodies: encoder "
        f"{fused_counts(ebody)}, decoder {fused_counts(dbody)}")
    log_pass_table("seamless-m4t-large-v2 encoder body", ebody.result)
    log_pass_table("seamless-m4t-large-v2 decoder body", dbody.result)
    log_device_time(lambda: model.apply(params, frames, tokens, cfg),
                    f"seamless-m4t-large-v2 apply B={B} T={T} S={S}", top=8)
    with torch.no_grad():
        reset_counts()
        ref = model.apply(params, frames, tokens, cfg, impl="ref")
        raw = model.apply(params, frames, tokens, cfg.with_(fuse="none"), impl="ref")
        check(not any(counts().values()), "the impl='ref' seamless-m4t apply launched a kernel")
    within_spread("seamless-m4t-large-v2 apply logits", logits, ref, raw)
    return applied


def greedy_run(step, params, cache, prompt, n_new, positions):
    """Greedy decode through a serve step that also returns its logits: the
    prompt replays through the step (the family has no prefill step), then
    ``n_new`` tokens.  Returns the tokens (B, n_new), every step's last
    logits (steps, B, vocab), each step's host wall in ms (ended by a
    synchronize) and the final cache."""
    import torch

    P = prompt.shape[1]
    tok, toks, logits, ms = prompt[:, :1], [], [], []
    for t in range(P + n_new - 1):
        t0 = time.perf_counter()
        nxt, cache, last = step(params, cache, tok, positions[t])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(last.float())
        if t + 1 < P:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = nxt.long()
            toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits), ms, cache


def phase14_serve(dev, cfg, model, params):
    """Phase 14 (c): greedy serving at B4 over T500 frames (ragged key
    tiles), an 8-token decoder prompt and 32 generated tokens: ``encode``
    and ``init_cache`` (cross K/V precomputed once), then
    ``steps.make_serve_step(cfg)`` compiled whole by ``ForgeCompiler`` on
    segment_jit (parameters static, the position a tensor), the prompt
    replayed through it.  Launches exact: the encoder body's once per
    layer, then per step flash once a decoder layer (cross-attention at
    one query row) and the program's linear nodes; no capture in the
    served run.  The same lowered program on interpret: tokens, every
    step's logits and the final cache bitwise equal.  Every step's logits,
    teacher-forced, against the kernel-free eager step within
    :func:`within_spread`, the spread taken against the unfused
    kernel-free ``apply`` over the same tokens.  Reports encode and
    init_cache ms, decode p50 / p99, tok/s against the step's byte bound,
    compile seconds split, and the host/device split of a step."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core import ForgeCompiler
    from repro_torch.launch.steps import make_serve_step

    B, T, P, N = 4, 500, 8, 32
    max_len = P + N
    what = "seamless-m4t-large-v2 serve"
    frames, prompt = encdec_inputs(dev, cfg, B, T, P, 42, torch.bfloat16)
    positions = torch.arange(max_len, device=dev)
    step = make_serve_step(cfg, logits=True)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
    with torch.no_grad():
        t0 = time.perf_counter()
        example = model.init_cache(params, frames, cfg, max_len)  # compiles the encoder body
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seg = ForgeCompiler(backend="segment_jit").compile(
            step, params, example, prompt[:, :1], positions[0], static_argnums=(0,))
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        interp = seg.with_backend("interpret")
        t0 = time.perf_counter()
        model.module.encode(params, frames, cfg)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        caps = captures_now()
        reset_counts()
        t0 = time.perf_counter()
        cache = model.init_cache(params, frames, cfg, max_len)
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        toks, logits, ms, final = greedy_run(seg, params, cache, prompt, N, positions)
        served = counts()
    steps = P + N - 1
    (ebody,) = forge_bodies(cfg, "enc", frames.shape)
    want_fa = flash_nodes(ebody) * n_enc + flash_nodes(seg) * steps
    want_fl = linear_nodes(ebody) * n_enc + linear_nodes(seg) * steps
    check(flash_nodes(seg) == n_dec and linear_nodes(seg) == 4 * n_dec,
          f"{what}: the step program has {flash_nodes(seg)} flash and {linear_nodes(seg)} "
          f"fused-linear nodes")
    check(served["flash_attention"] == want_fa and served["fused_linear"] == want_fl,
          f"{what}: launches {dict(served)} against flash {want_fa}, fused_linear {want_fl} "
          f"predicted from the programs' nodes")
    check(not served["paged_attention"] and not served["rg_lru"] and not served["rms_norm"],
          f"{what}: launched {served}")
    check(captures_now() == caps, f"{what}: a program was captured in the served run")
    check(tuple(toks.shape) == (B, N) and bool(torch.isfinite(logits).all()),
          f"{what}: tokens {tuple(toks.shape)}, finite logits {bool(torch.isfinite(logits).all())}")
    # the same lowered program on interpret: bitwise
    with torch.no_grad():
        cache_i = model.init_cache(params, frames, cfg, max_len)
        toks_i, logits_i, _, final_i = greedy_run(interp, params, cache_i, prompt, N, positions)
    check(torch.equal(toks, toks_i) and torch.equal(logits, logits_i)
          and all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(final),
                                                    pytree.tree_leaves(final_i))),
          f"{what}: segment_jit is not bitwise interpret (tokens equal "
          f"{int((toks == toks_i).sum())}/{toks.numel()})")
    # teacher-forced against the kernel-free step, and the spread against
    # the unfused kernel-free apply over the same tokens
    feed = torch.cat([prompt, toks[:, :-1]], 1)
    with torch.no_grad():
        reset_counts()
        cache_r = model.init_cache(params, frames, cfg, max_len, impl="ref")
        ref = []
        for t in range(steps):
            lg, cache_r = model.decode_step(params, cache_r, feed[:, t:t + 1], positions[t], cfg)
            ref.append(lg[:, -1].float())
        raw = model.apply(params, frames, feed, cfg.with_(fuse="none"), impl="ref")
        check(not any(counts().values()), f"{what}: a kernel-free path launched a kernel")
    within_spread(f"{what} teacher-forced logits over {steps} steps", logits, torch.stack(ref),
                  raw.transpose(0, 1))
    del ref, raw, cache_r

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # the least bytes a step moves: the weights it reads (the decoder
    # layers without the cross-attention K/V projections, which init_cache
    # applied, the final norm, the tied head), every cache input once, the
    # new self-attention K/V and the logits written once
    weights = [params["embed"], *pytree.tree_leaves(params["dec_norm"])]
    for layer in params["dec_blocks"]:
        for path, t in pytree.tree_flatten_with_path(layer)[0]:
            keys = [k.key for k in path]
            if not (keys[0] == "cross_attn" and keys[1] in ("wk", "wv")):
                weights.append(t)
    w_bytes, c_bytes = nbytes(weights), nbytes(cache.values())
    o_bytes = nbytes([cache["self_k"], cache["self_v"]]) + B * cfg.vocab * 4
    bound_ms = (w_bytes + c_bytes + o_bytes) / HBM_BYTES_PER_S * 1e3
    gen_ms = ms[P - 1:]
    split = compile_split([seg.result])
    log(f"{what} (segment_jit, bf16, {n_enc} + {n_dec} layers) batch={B} frames={T} "
        f"prompt={P} gen={N} max_len={max_len}: encode {encode_ms:.2f} ms, init_cache "
        f"{init_ms:.2f} ms (encode and the cross K/V; first call {first_s:.1f} s with the body "
        f"compile); decode p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms "
        f"over {steps} steps, {B * N / (sum(gen_ms) / 1e3):.1f} tok/s; the step's byte bound "
        f"{bound_ms:.3f} ms ({w_bytes / 1e9:.3f} GB of weights, {c_bytes / 1e9:.3f} GB of cache "
        f"inputs, {o_bytes / 1e9:.3f} GB of outputs: {B / bound_ms * 1e3:.1f} tok/s); step "
        f"compiled in {compile_s:.1f} s ({split}); launches {dict(served)}, {served.variants}; "
        f"segment_jit bitwise equal to interpret (tokens, {steps} steps' logits, the cache)")
    log(f"{what} step program: {seg.result.executor_stats.n_segments} segments, fused nodes "
        f"{fused_counts(seg)}")
    log_pass_table(f"{what} step program", seg.result)
    step_split(lambda: seg(params, final, toks[:, -1:], positions[P]), f"{what} [segment_jit]",
               floor_ms=bound_ms)
    return served


def phase14_f32(dev):
    """Phase 14 (b): the kernels held elementwise in f32 at full width and
    depth (5.5 GB): ``apply`` at B1, T256, S64 against impl="ref" within
    TOL_DEEP_F32.  Comparison launches: they count on no path."""
    import torch

    cfg, model, params, _ = full_width_model(dev, ED_ARCH, 24, ED_WIDTHS, dtype="float32")
    frames, tokens = encdec_inputs(dev, cfg, 1, 256, 64, 43, torch.float32)
    with torch.no_grad():
        got = model.apply(params, frames, tokens, cfg)
        want = model.apply(params, frames, tokens, cfg, impl="ref")
    err = assert_close(got, want, torch.float32, "seamless-m4t f32 apply logits", TOL_DEEP_F32)
    log(f"f32 seamless-m4t-large-v2 (full width and depth): apply B=1 T=256 S=64 against "
        f"impl='ref', max abs err {err:.3e} ({rel_l2(got, want):.3e} relative L2), within rtol "
        f"{TOL_DEEP_F32['rtol']} atol {TOL_DEEP_F32['atol']}")
    del params


def phase_kernel_grads(dev):
    """Phase 2's gradient rows: each path kernel's custom op under
    ``torch.autograd.grad`` (the kernel forward, the registered backward
    through the plain version) against autograd through the plain
    version on the same inputs and output gradient, within the kernel
    tolerances; each forward launches its kernel once, the backward none.
    Comparison launches: they count on no path."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.kernels import rg_lru as RG

    g = torch.Generator(device=dev).manual_seed(6)

    def grads(fn, inputs, gout):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, gout)

    def hold(mod, kernel, plain, inputs, gout, names, dtype, what):
        mod.LAUNCHES.reset()
        got = grads(kernel, inputs, gout)
        torch.cuda.synchronize()
        check(mod.LAUNCHES.n == 1, f"{what}: {mod.LAUNCHES.n} launches in forward and backward")
        want = grads(plain, inputs, gout)
        errs = [assert_close(a, b, dtype, f"{what} d{n}") for a, b, n in zip(got, want, names)]
        log(f"gradient {what} through the kernel's custom op: max abs err "
            f"{', '.join(f'd{n} {e:.3e}' for n, e in zip(names, errs))} against autograd "
            f"through the plain version")

    M = TRAIN_ROWS
    B, H, _, S, D = TRAIN_FLASH
    for dtype in (torch.float32, torch.bfloat16):
        for K, N, act, bias in GRAD_LINEARS:
            x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dtype)
            w = (torch.randn(K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
            b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dtype) if bias else None
            gy = torch.randn(M, N, generator=g, device=dev).to(dtype)
            ins = [x, w] + ([b] if bias else [])
            hold(FL, lambda x, w, *b: FL.fused_linear(x, w, *b, act=act),
                 lambda x, w, *b: FL.fused_linear_plain(x, w, *b, act=act), ins, gy,
                 ("x", "w", "b"), dtype,
                 f"fused_linear {dtype} M={M} K={K} N={N} act={act} bias={bias}")
        q, k, v = flash_inputs(g, dev, dtype, B, H, H, S, S, D)
        go = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
        hold(FA, lambda q, k, v: FA.flash_attention(q, k, v, scale=D ** -0.5, causal=True),
             lambda q, k, v: FA.flash_attention_plain(q, k, v, scale=D ** -0.5, causal=True),
             [q, k, v], go, ("q", "k", "v"), dtype,
             f"flash {dtype} B={B} H={H} S={S} D={D} causal")
    Bl, T, Dl = GRAD_RG
    x, a, h0 = rg_inputs(g, dev, torch.float32, Bl, T, Dl, True)
    gh = torch.randn(Bl, T, Dl, generator=g, device=dev)
    hold(RG, RG.rg_lru, RG.rg_lru_plain, [x, a, h0], gh, ("x", "a", "h0"), torch.float32,
         f"rg_lru float32 B={Bl} T={T} D={Dl}")


def phase15(dev):
    """Phase 15: forge-125m trained at full size (bf16, 12 layers,
    ``remat=True``) through the train CLI, whose step is the step
    compiled whole and donated (``train.JitTrainStep``, one CUDA graph a
    step), then one step's launches counted per replay from the compiled
    programs' kernel nodes, the compiled step against the eager
    ``make_train_step`` (bf16 by the spread rule; f32 at F32_CHECK_LAYERS
    layers, 3 steps elementwise), one eager step against impl="ref", 3
    Adafactor steps, the step's numbers beside its bound, and (f)
    recurrentgemma-2b at 3 full-width layers through the compiled step.
    Returns the launches of the CLI run ("train"), of one step
    ("train_step") and of (f)'s steps ("rglru_train")."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch import steps, train
    from repro_torch.models import get_model

    release_device_memory()
    cfg = get_config("forge-125m")
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.n_layers == 12 and cfg.d_model == 768
          and cfg.vocab == 50257, f"forge-125m is {cfg}")
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="forge_ckpt_") as ckpt_dir:
        base = torch.cuda.memory_allocated()  # what the earlier phases keep
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rc = train.main(TRAIN_ARGS + ["--ckpt-dir", ckpt_dir, "--device", "cuda"], out=out)
        torch.cuda.synchronize()
        cli = counts()
        peak = torch.cuda.max_memory_allocated() - base
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"train CLI returned {rc}")
    rep, ckpt, step = out["report"], out["ckpt"], out["step"]
    check(isinstance(step, train.JitTrainStep) and step.donate,
          f"the CLI's step is {type(step).__name__}")
    hist = [(h["step"], h["loss"]) for h in rep.history]
    check(rep.failures == 1 and rep.restores == 1, f"failures {rep.failures}, restores "
          f"{rep.restores}")
    check([s for s, _ in hist] == list(range(8)) + list(range(6, 12)), f"steps run {hist}")
    first, replay = [loss for _, loss in hist[6:8]], [loss for _, loss in hist[8:10]]
    rel = max(abs(a - b) / abs(a) for a, b in zip(first, replay))
    check(rel <= 1e-3, f"replayed steps 6-7 losses {replay} vs the first pass's {first}")
    losses = [loss for _, loss in hist]
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(step.graphs == 2 and step.programs == {"forward": 1, "backward": 1, "update": 1}
          and step.replays == len(hist) - 1,
          f"the compiled step: {step.graphs} graphs, programs {step.programs}, "
          f"{step.replays} replays over {len(hist)} steps")
    log(f"train CLI {' '.join(TRAIN_ARGS)} through the compiled step: {len(hist)} steps run "
        f"({rep.failures} failure, {rep.restores} restore from step 6, copied into the owned "
        f"buffers) in {cli_s:.1f} s; losses {', '.join(f'{x:.4f}' for x in losses)}; replayed "
        f"steps 6-7 {'bitwise equal to' if first == replay else f'within {rel:.2e} relative of'}"
        f" the first pass ({first}); {step.replays} CUDA graph replays (the first step "
        f"compiles, runs and captures)")

    # (b) one step's launches, counted per replay from the compiled programs
    fwd, bwd = step.kernel_nodes["forward"], step.kernel_nodes["backward"]
    per_step = {k: fwd.get(k, 0) + bwd.get(k, 0) for k in set(fwd) | set(bwd)}
    check(fwd.get("flash_attention") == cfg.n_layers
          and fwd.get("fused_linear") == 3 * cfg.n_layers,
          f"the compiled forward's kernel nodes {fwd}")
    params, opt_state = out["state"]
    check(params is step.state[0] and opt_state is step.state[1],
          "the CLI's final state is not the step's own")
    data = TokenDataset(DataConfig(seq_len=128, global_batch=8, vocab=cfg.vocab, seed=0))

    def batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}

    b = batch(12)
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(step.state)]
    replays0 = step.replays
    reset_counts()
    step(params, opt_state, b)
    torch.cuda.synchronize()
    one = counts()
    check(step.replays == replays0 + 1, f"one step replayed {step.replays - replays0} graphs")
    check(ptrs == [t.data_ptr() for t in pytree.tree_leaves(step.state)],
          "a step moved the owned parameters or state")
    for name in ("flash_attention", "fused_linear"):
        check(one[name] == per_step[name], f"one train step: {name} launches {one[name]} != "
              f"{fwd[name]} forward + {bwd.get(name, 0)} backward kernel nodes")
        # every step launches the programs' kernels once; the first call's
        # eager forward (the bodies' compile) launched the forward's again
        check(cli[name] == per_step[name] * len(hist) + fwd[name],
              f"train CLI: {name} launches {cli[name]} != {per_step[name]} a step x "
              f"{len(hist)} steps + {fwd[name]} of the eager forward")
    check(one.variants["flash_attention"] == {"wgmma": per_step["flash_attention"]}
          and one.variants["fused_linear"] == {"wgmma": per_step["fused_linear"]},
          f"one train step: launches by variant {one.variants}")
    check(not one["paged_attention"] and not one["rg_lru"] and not one["rms_norm"],
          f"one train step launched {dict(one)}")
    log(f"one compiled train step (B8 x S128, remat), one graph replay: flash "
        f"{one['flash_attention']} and fused_linear {one['fused_linear']} launches = the "
        f"forward's {fwd['flash_attention']} + {fwd['fused_linear']} kernel nodes and the "
        f"backward's {bwd.get('flash_attention', 0)} + {bwd.get('fused_linear', 0)} (the "
        f"partitioner's recompute of the checkpointed bodies); by variant {one.variants}; the "
        f"whole CLI run: {cli['flash_attention']} and {cli['fused_linear']} over {len(hist)} "
        f"steps and the eager forward")

    # (e) the step's numbers, the compiled and the eager step side by side
    walls = [t * 1e3 for t in out["step_s"][1:]]  # the first step compiles
    step_ms = float(np.median(walls))
    toks = 8 * 128
    flops = train_step_flops(cfg, params, 8, 128)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    adamw_bytes = n_params * (2 + 2 + 2 + 4 * 4)  # read p, g; write p; read/write m, v
    bound_ms = (flops / BF16_FLOPS + adamw_bytes / HBM_BYTES_PER_S) * 1e3
    split = train_split(step, params, opt_state, b)
    update_ms = compiled_update_ms(step)
    cs = step.compile_split
    optimizer = step.optimizer
    tm = ckpt.timings
    state0 = [t.clone() for t in pytree.tree_leaves(step.state)]
    ptree = pytree.tree_structure(step.state)
    eager = steps.make_train_step(cfg, optimizer)
    # the eager step from a fresh init, peak over 3 steps, as the CLI's peak
    # counts from its fresh init
    del out
    release_device_memory()
    base_eager = torch.cuda.memory_allocated()  # the compiled step's own tensors among it
    torch.cuda.reset_peak_memory_stats()
    p = get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    s = optimizer.init(p)
    eager_walls = []
    for i in range(3):
        t1 = time.perf_counter()
        p, s, m = eager(p, s, batch(i))
        float(m["loss"])
        eager_walls.append((time.perf_counter() - t1) * 1e3)
    eager_peak = torch.cuda.max_memory_allocated() - base_eager
    del p, s
    eager_ms = float(np.median(eager_walls[1:]))
    check(peak <= 1.1 * eager_peak, f"the compiled run's peak {peak / 2**30:.2f} GiB above 1.1x "
          f"the eager step's {eager_peak / 2**30:.2f} GiB")
    log(f"train step forge-125m B8 x S128 (bf16, remat, AdamW; {n_params / 1e6:.1f}M params): "
        f"compiled median {step_ms:.2f} ms host wall over steps 2-{len(hist)} "
        f"({toks / step_ms * 1e3:.0f} tok/s), eager {eager_ms:.1f} ms ({toks / eager_ms * 1e3:.0f}"
        f" tok/s; steps 2-3 of 3), {eager_ms / step_ms:.1f}x; bound {bound_ms:.3f} ms = "
        f"{flops / 1e12:.3f} TFLOP at the bf16 peak ({flops / BF16_FLOPS * 1e3:.3f} ms) + "
        f"{adamw_bytes / 1e9:.2f} GB of AdamW at the HBM rate "
        f"({adamw_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms): compiled {step_ms / bound_ms:.1f}x, "
        f"eager {eager_ms / bound_ms:.1f}x; max_memory_allocated above what was allocated before "
        f"each run {peak / 2**30:.2f} GiB over the compiled CLI run (from a fresh init), "
        f"{eager_peak / 2**30:.2f} GiB over 3 eager steps (from a fresh init), "
        f"{peak / eager_peak:.2f}x")
    log(f"compiled step build {step.compile_s:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in cs.items())
        + f"; {step.graphs} Dynamo graphs, Inductor programs {step.programs}; 1 CUDA graph "
        f"replay a step")
    log(f"AdamW update (the compiled update graph, flat layout): {update_ms:.3f} ms (CUDA events, "
        f"mean of 10) against its byte bound {adamw_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; "
        + (f"{100 * update_ms / split['device_ms']:.1f}% of the step's device time"
           if split["device_ms"] else "the step's device time not measured"))
    log(f"checkpoints of {sum(t.numel() * t.element_size() for t in state0) / 1e9:.2f} GB: "
        f"snapshot to host {', '.join(f'{x:.2f}' for x in tm['snapshot_s'])} s, write "
        f"{', '.join(f'{x:.2f}' for x in tm['write_s'])} s (its thread), restore "
        f"{', '.join(f'{x:.2f}' for x in tm['restore_s'])} s")
    log(f"compiled train step host/device split: host wall {split['wall_ms']:.2f} ms a step, of "
        f"it {split['enqueue_ms']:.2f} ms before the loss's read; under the profiler device "
        f"kernels {split['device_ms']:.2f} ms a step (flash {split['flash_ms']:.3f} ms, "
        f"fused_linear {split['fl_ms']:.3f} ms), {100 * split['busy']:.1f}% busy"
        if split["device_ms"] else f"compiled train step host wall {split['wall_ms']:.2f} ms; "
        f"device time not measured (the profiler recorded no device time)")

    # (c) the compiled step against the eager one on the same state and batch
    params, opt_state = pytree.tree_unflatten(state0, ptree)
    compiled_loss = step(params, opt_state, b)[2]["loss"]
    eager_loss = eager(params, opt_state, b)[2]["loss"]
    loss_fn = steps.make_loss_fn(cfg)
    got_loss, got = steps.loss_and_grads(loss_fn, params, b)
    check(torch.equal(got_loss, eager_loss), "the eager step's loss is not its gradient's")
    reset_counts()
    ref_loss, ref = steps.loss_and_grads(steps.make_loss_fn(cfg, impl="ref"), params, b)
    raw_loss, raw = steps.loss_and_grads(steps.make_loss_fn(cfg.with_(fuse="none"), impl="ref"),
                                         params, b)
    check(not any(counts().values()), "the impl='ref' train step launched a kernel")
    within_spread("the compiled step's loss (12 layers, bf16) against the eager step's",
                  compiled_loss[None], eager_loss[None], ref_loss[None])
    # one eager step's loss and gradients against impl="ref": the spread rule
    within_spread("train loss", got_loss[None], ref_loss[None], raw_loss[None])
    worst = (0.0, "")
    for (path, gl), rl, wl in zip(pytree.tree_flatten_with_path(got)[0], pytree.tree_leaves(ref),
                                  pytree.tree_leaves(raw)):
        key = pytree.keystr(path)
        r, spread = rel_l2(gl, rl), rel_l2(rl, wl)
        bound = max(REL_L2_DEEP_BF16, SPREAD_FACTOR_BF16 * spread)
        check(bool(torch.isfinite(gl).all()), f"grad {key}: non-finite values")
        check(r <= bound, f"grad {key}: relative L2 {r:.3e} of impl='ref' above {bound:.3e} "
              f"(spread {spread:.3e})")
        worst = max(worst, (r / bound, f"{key} ({r:.3e} against {bound:.3e}, spread "
                                        f"{spread:.3e})"))
    log(f"bf16 gradients (every one of {len(pytree.tree_leaves(got))} leaves) within "
        f"max({REL_L2_DEEP_BF16}, {SPREAD_FACTOR_BF16} x spread) relative L2 of impl='ref'; "
        f"closest to its bound: {worst[1]}")
    del got, ref, raw, params, opt_state, state0, step, eager
    release_compiled_steps()

    # (d) Adafactor: 3 steps on a model of the same widths
    phase15_adafactor(dev, cfg, batch)
    # (c) f32 at F32_CHECK_LAYERS layers: the compiled step against the eager one
    phase15_f32(dev, cfg, batch)
    # (f) recurrentgemma-2b at 3 full-width layers through the compiled step
    rglru = phase15_rglru(dev)
    return {"train": cli, "train_step": one, "rglru_train": rglru}


def compiled_update_ms(step, iters=10):
    """The compiled update graph of a flat-layout ``JitTrainStep`` alone
    (the clipping and AdamW; the gradients' gather into the flat layout
    left out), on copies of its flat trees and flat gradients (its
    parameters and state stay as they are): mean CUDA-event ms."""
    import torch
    from torch.utils import _pytree as pytree

    fp, fs = pytree.tree_map(torch.clone, step._flat_trees)
    grads = {k: torch.randn_like(p) * 1e-3 for k, p in fp.items()}
    with torch.no_grad():  # as the step runs it: no recompile
        ms = cuda_ms(lambda: step._update(grads, fp, fs), iters)
    del fp, fs, grads
    return ms


def release_compiled_steps():
    """Drop Dynamo's compiled code (it holds the train steps it traced,
    and with them their owned tensors and CUDA graphs) and free the
    memory."""
    import torch

    torch._dynamo.reset()
    release_device_memory()


def train_step_flops(cfg, params, B, S):
    """A train step's matmul and attention FLOPs: forward, backward (twice
    the forward) and the block bodies' rerun under remat.  The products
    are counted from the parameters' 2-D weights (q, k, v, o, the FFN),
    the LM head from the embedding (tied), attention over the causal
    pairs only."""
    from torch.utils import _pytree as pytree

    T = B * S
    layer = sum(w.numel() for w in pytree.tree_leaves(params["blocks"][0]) if w.ndim == 2)
    head = params["embed"].numel()
    attn = 4.0 * B * cfg.n_heads * cfg.head_dim_ * S * (S + 1) / 2
    blocks = cfg.n_layers * (2.0 * T * layer + attn)
    fwd = blocks + 2.0 * T * head
    return 3 * fwd + (blocks if cfg.remat else 0)


def cuda_ms(fn, iters=10):
    """Mean device span of ``fn`` between CUDA events, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def train_split(step_fn, params, opt_state, batch, steps=3):
    """Where a train step's time goes: host wall per step (ended by the
    loss's read, as the CLI ends it), the part before that read, and,
    under ``torch.profiler``, the device kernels' time per step (flash
    and fused linear apart) and their share of the profiled wall."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls, enqueue = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt_state, batch)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(step_fn(params, opt_state, batch)[2]["loss"])
        window = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]

    def part(tag=""):
        return sum(e.self_device_time_total for e in events if tag in e.key) / 1e3 / steps

    device = part()
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  train step: {e.self_device_time_total / 1e3 / steps:.4f} ms/step, "
            f"{e.count // steps} launches/step: {e.key[:90]}")
    return {"wall_ms": float(np.median(walls)), "enqueue_ms": float(np.median(enqueue)),
            "device_ms": device or None, "flash_ms": part("flash_"),
            "fl_ms": part("fused_linear"), "busy": device * steps / window}


def phase15_adafactor(dev, cfg, batch):
    """Phase 15 (d): 3 steps of ``make_train_step(cfg, Adafactor().for_config(cfg))`` on
    forge-125m at full size (fresh weights from seed 1): finite losses,
    and every >= 2-D leaf of the stacked view (the JAX package's layout:
    the 12 layers stacked) factored, its state vr + vc against the leaf's
    bytes."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.optim import Adafactor
    from repro_torch.optim.adafactor import stack_layers

    params = get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    opt = Adafactor().for_config(cfg)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    losses = []
    t0 = time.perf_counter()
    for i in range(3):
        params, state, m = step(params, state, batch(i))
        losses.append(float(m["loss"]))
    check(all(np.isfinite(x) for x in losses), f"Adafactor losses {losses}")
    view = pytree.tree_leaves(stack_layers(params, opt.stacked))
    n2 = 0
    fact = leaf = 0
    for p, vr, vc, v in zip(view, *(pytree.tree_leaves(t) for t in (state.vr, state.vc, state.v))):
        if p.ndim >= 2:
            check(v.numel() == 1 and vr.shape == p.shape[:-1]
                  and vc.shape == p.shape[:-2] + p.shape[-1:],
                  f"a {tuple(p.shape)} leaf's state is not factored: vr {tuple(vr.shape)}, vc "
                  f"{tuple(vc.shape)}, v {tuple(v.shape)}")
            n2 += 1
            fact += (vr.numel() + vc.numel()) * 4
            leaf += p.numel() * p.element_size()
    check(n2 == len(view) - 2, f"{n2} of {len(view)} view leaves are >= 2-D")
    log(f"Adafactor (stacked view, {opt.stacked}): 3 steps in {time.perf_counter() - t0:.1f} s, "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; all {n2} >= 2-D leaves factored: "
        f"vr + vc {fact / 1e6:.2f} MB against the leaves' {leaf / 1e9:.3f} GB")
    del params, state


def phase15_f32(dev, cfg, batch):
    """Phase 15 (c), f32: forge-125m at full width and F32_CHECK_LAYERS
    layers in f32, one step's loss and every gradient leaf with the
    kernels elementwise within rtol 2e-4 / atol 2e-5 of impl="ref"; then
    3 steps of the compiled step (``build_trainer``'s) against 3 of the
    eager ``make_train_step`` from the same state, every loss within the
    same tolerance."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.launch import steps, train
    from repro_torch.models import get_model

    cfg32 = cfg.with_(dtype="float32", n_layers=F32_CHECK_LAYERS)
    params = get_model(cfg32).init(cfg32, torch.Generator(device=dev).manual_seed(2), dev)
    b = batch(0)
    loss, got = steps.loss_and_grads(steps.make_loss_fn(cfg32), params, b)
    ref_loss, ref = steps.loss_and_grads(steps.make_loss_fn(cfg32, impl="ref"), params, b)
    assert_close(loss[None], ref_loss[None], torch.float32, "f32 train loss")
    worst = 0.0
    for (path, gl), rl in zip(pytree.tree_flatten_with_path(got)[0], pytree.tree_leaves(ref)):
        worst = max(worst, assert_close(gl, rl, torch.float32,
                                        f"f32 grad {pytree.keystr(path)}"))
    log(f"f32 forge-125m at {F32_CHECK_LAYERS} layers (full width): loss {float(loss):.6f} vs "
        f"impl='ref' {float(ref_loss):.6f}; every gradient leaf within rtol "
        f"{TOL_F32['rtol']} atol {TOL_F32['atol']} (max abs err {worst:.3e})")
    del got, ref
    _, opt, step = train.build_trainer(cfg32)
    eager = steps.make_train_step(cfg32, opt)
    runs = {}
    for name, fn in (("compiled", step), ("eager", eager)):
        p, s = params, opt.init(params)
        runs[name] = []
        for i in range(3):
            p, s, m = fn(p, s, batch(i))
            runs[name].append(float(m["loss"]))
    np.testing.assert_allclose(runs["compiled"], runs["eager"], **TOL_F32)
    log(f"f32 forge-125m at {F32_CHECK_LAYERS} layers: 3 compiled steps' losses "
        f"{runs['compiled']} against the eager step's {runs['eager']}, within rtol "
        f"{TOL_F32['rtol']} atol {TOL_F32['atol']} (max abs diff "
        f"{max(abs(x - y) for x, y in zip(runs['compiled'], runs['eager'])):.3e}); its build "
        f"{step.compile_s:.1f} s")
    del params, p, s, step, eager
    release_compiled_steps()


def phase15_rglru(dev):
    """Phase 15 (f): recurrentgemma-2b at full width (d 2560, vocab
    256000, 10 heads on 1 KV head), 3 layers (rec, rec, attn), B8 x S128,
    bf16, trained 4 steps through ``build_trainer``'s compiled step: the
    RG-LRU scan and flash at D = 256 (``wmma``) in its forward and, under
    remat, its backward's recompute; launches a replay equal to the
    compiled programs' kernel nodes, by variant; finite losses; the first
    step's loss within the bf16 spread rule of the eager step's.  Returns
    the launches of the 4 steps."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.launch import steps, train
    from repro_torch.models import get_model

    cfg = get_config("recurrentgemma-2b").with_(n_layers=3)
    check(cfg.d_model == 2560 and cfg.vocab == 256000 and cfg.n_heads == 10
          and cfg.n_kv_heads == 1 and cfg.remat and cfg.dtype == "bfloat16",
          f"recurrentgemma-2b is {cfg}")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    data = TokenDataset(DataConfig(seq_len=128, global_batch=8, vocab=cfg.vocab, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
               for i in range(4)]
    _, opt, step = train.build_trainer(cfg)
    check(isinstance(step, train.JitTrainStep), f"build_trainer gave {type(step).__name__}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    p, s = params, opt.init(params)
    losses, walls = [], []
    for bt in batches:
        t0 = time.perf_counter()
        p, s, m = step(p, s, bt)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - base
    fwd, bwd = step.kernel_nodes["forward"], step.kernel_nodes["backward"]
    per_step = {k: fwd.get(k, 0) + bwd.get(k, 0) for k in set(fwd) | set(bwd)}
    check(all(np.isfinite(losses)), f"recurrentgemma-2b losses {losses}")
    check(fwd.get("rg_lru") == 2 and fwd.get("flash_attention") == 1,
          f"the compiled forward's kernel nodes {fwd}")
    for name in ("rg_lru", "flash_attention", "fused_linear"):
        # 4 steps run the programs' kernels; the eager forward of the first
        # call launched the forward's once more
        check(launches[name] == 4 * per_step[name] + fwd[name],
              f"recurrentgemma-2b train: {name} launches {launches[name]} != 4 x "
              f"{per_step[name]} + {fwd[name]}")
    check(launches.variants["flash_attention"] == {"wmma": launches["flash_attention"]}
          and launches.variants["fused_linear"] == {"wgmma": launches["fused_linear"]},
          f"recurrentgemma-2b train: launches by variant {launches.variants}")
    build = (f"{step.compile_s:.1f} s, "
             + ", ".join(f"{k} {v:.1f}" for k, v in step.compile_split.items()))
    del p, s, step
    release_compiled_steps()
    # the first step's loss against the eager step's, from the same state
    opt_state = opt.init(params)
    eager_loss = steps.make_train_step(cfg, opt)(params, opt_state, batches[0])[2]["loss"]
    reset_counts()
    ref_loss = steps.make_loss_fn(cfg, impl="ref")(params, batches[0])
    check(not any(counts().values()), "the impl='ref' loss launched a kernel")
    within_spread("recurrentgemma-2b compiled step 1 loss against the eager step's",
                  torch.tensor([losses[0]], device=dev), eager_loss[None], ref_loss[None])
    log(f"recurrentgemma-2b (3 full-width layers: rec, rec, attn; {opt.__class__.__name__} lr "
        f"{opt.lr}) B8 x S128 bf16 through the compiled step: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; per replay rg_lru {per_step['rg_lru']} "
        f"({fwd['rg_lru']} forward + {bwd.get('rg_lru', 0)} in the backward's recompute), flash "
        f"{per_step['flash_attention']} ({launches.variants['flash_attention']} over the run, "
        f"D = 256), fused_linear {per_step['fused_linear']} ({launches.variants['fused_linear']}"
        f" over the run); steps {', '.join(f'{x:.1f}' for x in walls)} ms host wall (the first "
        f"builds: {build}); max_memory_allocated {peak / 2**30:.2f} GiB above the weights over "
        f"the compiled steps")
    del params, opt_state
    release_device_memory()
    return launches


# phase 16: the distributed layer.  (a) forge-125m under plan_for on a
# one-rank NCCL mesh; (c) two production dry-run cells, one subprocess
# after the other: a train cell and a long-prefill cell, full depth
DRYRUN_CELLS = (("qwen2.5-14b", "train_4k"), ("deepseek-7b", "prefill_32k"))
# the JAX package's FLOPs a layer a device in that cell (XLA's cost
# analysis of its 2-layer variant, FSDP off, on a CPU host: ROADMAP.md,
# queue 3), which the port's count is read against
DRYRUN_REF_LAYER_FLOPS = 1.00e13
CARD_BYTES = 80e9  # H100 80GB HBM3


def start_dryrun():
    """Phase 16 (c): ``python -m repro_torch.launch.dryrun --arch A
    --shape S`` (``run_cell`` on pod16x16 with its calibration) for each
    cell of :data:`DRYRUN_CELLS`, one subprocess after the other, started
    now: their ``fake`` groups of 256 ranks must not meet phase 16's NCCL
    group, and their work is all on the CPU (fake tensors; no card
    visible to them), so they run beside the other phases.  Returns
    ``(runs, path of their JSON records)``."""
    out = tempfile.mkdtemp(prefix="forge-dryrun-", dir=os.environ.get("TMPDIR"))
    path = os.path.join(out, "dryrun.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    argvs = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              shape, "--out", path] for arch, shape in DRYRUN_CELLS]
    return CliRuns("dryrun", argvs, env), path


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase16(dev, dryrun):
    """Phase 16: the distributed layer on the card.  (a) A one-rank NCCL
    group, ``make_host_mesh()`` as (1, 1), and forge-125m at full size
    (12 layers, d 768, bf16) placed by ``plan_for(cfg, mesh)`` as
    DTensors: ``apply`` at B4 x S1024 and one train step (B8 x S128,
    remat, AdamW) through the Forge-compiled bodies on interpret, each
    launching what the unplanned run launches (12 flash + 36 fused
    linear; 24 + 72), logits and loss bitwise the unplanned run's.  (b)
    ``compressed_all_reduce`` of that step's gradients on the NCCL group,
    within each block's amax / 254 of the plain ``all_reduce``; the
    compression ratio and the quantize / dequantize ms.  (c) The dry run
    of qwen2.5-14b train_4k and deepseek-7b prefill_32k on pod16x16
    (``start_dryrun``): each ``ok``, its per-device bytes against the
    card's 80 GB, the three roofline terms, the collectives' count and MB
    by kind, and the FLOPs a layer a device.
    (d) Tensor parallelism over two gloo ranks on the card
    (:func:`phase16_tp`).  (e) Expert parallelism over two gloo ranks on
    the card, started here and joined after phase 17 (:func:`phase16_ep`).
    Returns the launches of the planned ``apply`` and step and of (d)'s
    rank 0, and (e)'s ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenDataset
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import compressed_all_reduce, compression_ratio, quantize_int8
    from repro_torch.runtime.compress import BLOCK, dequantize_int8

    release_device_memory()
    tp, ep = start_tp(), start_ep()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh()
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
              and dist.get_backend() == "nccl", f"host mesh {mesh} on {dist.get_backend()}")
        cfg = get_config("forge-125m")
        model = get_model(cfg)
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        plan = plan_for(cfg, mesh)
        log(plan.summary())
        dparams = distribute_tree(params, plan.params_shardings(params))
        tokens = torch.randint(0, cfg.vocab, (4, 1024), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(3))
        dtokens = distribute_tree(tokens, plan.batch_shardings(tokens))
        layout = sorted({str(t.placements) for t in pytree.tree_leaves(dparams)})
        log(f"forge-125m placed by the plan: {len(pytree.tree_leaves(dparams))} DTensor "
            f"leaves, placements {layout}; tokens {dtokens.placements}")

        # (a) apply: the unplanned run (a comparison), then the planned path
        with torch.no_grad():
            ref = model.apply(params, tokens, cfg)
            torch.cuda.synchronize()
            reset_counts()
            with replicate_plain():
                t0 = time.perf_counter()
                out = model.apply(dparams, dtokens, cfg)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
            planned_apply = counts()
            with replicate_plain():
                t0 = time.perf_counter()
                model.apply(dparams, dtokens, cfg)
                torch.cuda.synchronize()
                apply_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            model.apply(params, tokens, cfg)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        check(isinstance(out, DTensor), f"planned apply returned {type(out)}")
        check(planned_apply["flash_attention"] == cfg.n_layers
              and planned_apply["fused_linear"] == 3 * cfg.n_layers,
              f"planned apply launched {dict(planned_apply)}")
        check(torch.equal(out.full_tensor(), ref), "planned apply logits differ from the "
              f"unplanned run's (max abs {float((out.full_tensor() - ref).abs().max()):.3e})")
        log(f"planned apply B4 x S1024: flash {planned_apply['flash_attention']} and "
            f"fused_linear {planned_apply['fused_linear']} launches, logits {out.placements} "
            f"bitwise the unplanned run's; first call {first_ms:.1f} ms (its body compiles), "
            f"steady {apply_ms:.1f} ms host wall against {plain_ms:.1f} ms unplanned")

        # (a) one train step
        # the eager step: plain tensors and DTensors through one step
        optimizer = AdamW()
        step_fn = steps.make_train_step(cfg, optimizer)
        opt_state = optimizer.init(params)
        dopt = distribute_tree(opt_state, plan.opt_state_shardings(opt_state, params))
        data = TokenDataset(DataConfig(seq_len=128, global_batch=8, vocab=cfg.vocab, seed=0))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
        dbatch = distribute_tree(batch, plan.batch_shardings(batch))
        p1, o1, m1 = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        reset_counts()
        with replicate_plain():
            t0 = time.perf_counter()
            p2, o2, m2 = step_fn(dparams, dopt, dbatch)
            loss = m2["loss"].full_tensor()
            torch.cuda.synchronize()
            step_first_ms = (time.perf_counter() - t0) * 1e3
        planned_step = counts()
        runs = (1 + cfg.remat) * cfg.n_layers
        check(planned_step["flash_attention"] == runs and planned_step["fused_linear"] == 3 * runs,
              f"planned train step launched {dict(planned_step)}")
        check(torch.equal(loss, m1["loss"]), f"planned loss {float(loss)!r} != unplanned "
              f"{float(m1['loss'])!r}")
        worst = max(float((a.full_tensor() - b).abs().max())
                    for a, b in zip(pytree.tree_leaves(p2), pytree.tree_leaves(p1)))
        with replicate_plain():
            t0 = time.perf_counter()
            float(step_fn(dparams, dopt, dbatch)[2]["loss"].full_tensor())
            step_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        float(step_fn(params, opt_state, batch)[2]["loss"])
        step_plain_ms = (time.perf_counter() - t0) * 1e3
        log(f"planned train step B8 x S128 (remat, AdamW): flash {planned_step['flash_attention']}"
            f" and fused_linear {planned_step['fused_linear']} launches, loss {float(loss):.6f} "
            f"bitwise the unplanned step's; new params' max abs difference {worst:.3e}; first "
            f"step {step_first_ms:.1f} ms, steady {step_ms:.1f} ms host wall against "
            f"{step_plain_ms:.1f} ms unplanned")
        del p1, o1, p2, o2, out, ref

        # (b) compressed all-reduce of the step's gradients
        _, grads = steps.loss_and_grads(steps.make_loss_fn(cfg), params, batch)
        leaves = pytree.tree_leaves(grads)
        n = sum(g.numel() for g in leaves)
        worst = 0.0
        for g in leaves:
            g32 = g.float()  # the sums in fp32, as the reference's psum of dequantized blocks
            got = compressed_all_reduce(g32)
            want = g32.clone()
            dist.all_reduce(want)
            _, scale, _ = quantize_int8(g32)
            err = (got - want).reshape(-1)
            err = torch.nn.functional.pad(err, (0, (-err.numel()) % BLOCK)).reshape(-1, BLOCK)
            # half a quantization step (amax / 127 / 2), with fp32's rounding of q and q * scale
            bound = scale * 127.0 / 254 * (1 + 2.0 ** -12)
            check(bool((err.abs() <= bound).all()), f"compressed all-reduce error "
                  f"{float(err.abs().max()):.3e} above its block's amax / 254")
            worst = max(worst, float((err.abs() / bound).max()))
        quant_ms = cuda_ms(lambda: [quantize_int8(g) for g in leaves])
        qs = [quantize_int8(g) for g in leaves]
        deq_ms = cuda_ms(lambda: [dequantize_int8(q, s, k, g.shape, g.dtype)
                                  for (q, s, k), g in zip(qs, leaves)])
        log(f"compressed_all_reduce of the step's {len(leaves)} gradient leaves ({n / 1e6:.1f}M "
            f"elements, {leaves[0].dtype}, reduced in fp32) on the NCCL group: every block within "
            f"its amax / 254 of the plain all_reduce, worst {worst:.3f} of its bound; "
            f"compression_ratio {compression_ratio(grads):.4f} of a bf16 payload; quantize "
            f"{quant_ms:.3f} ms, dequantize {deq_ms:.3f} ms (CUDA events, all leaves)")
        del grads, qs, dparams, dopt, params, opt_state
    finally:
        dist.destroy_process_group()
    release_device_memory()

    # (c) the dry run's records
    runs_, path = dryrun
    results = runs_.join()
    for (code, _, err_, _) in results:
        check(code == 0, f"dry run exited {code}: {err_[-2000:]}")
    check(len(results) == len(DRYRUN_CELLS), f"{len(results)} of {len(DRYRUN_CELLS)} dry-run "
          "cells ran")
    records = json.load(open(path))
    for (arch, shape), (_, _, _, secs) in zip(DRYRUN_CELLS, results):
        rec = records[f"{arch}|{shape}|pod16x16"]
        r = rec["roofline"]
        check(rec["status"] == "ok" and r["chips"] == 256 and r["hlo_flops"] > 0,
              f"dry run {rec}")
        detail = r["coll_detail"]
        kinds = ", ".join(f"{k} {detail['counts'][k]} ({detail[k] / 1e6:.1f} MB)"
                          for k in detail["counts"] if detail["counts"][k])
        log(f"dry run {rec['cell']} ({secs:.1f} s in its subprocess: placing {rec['lower_s']} s, "
            f"the first call {rec['compile_s']} s, the counted step {rec['step_s']} s; "
            f"fuse={rec['fuse']}, fsdp={rec['fsdp']}): "
            f"{rec['memory']['total_bytes_per_device'] / 1e9:.1f} GB a device "
            f"against the card's {CARD_BYTES / 1e9:.0f} GB (shards "
            f"{rec['memory']['args_bytes'] / 1e9:.2f} GB + the step's peak "
            f"{rec['memory']['peak_step_bytes'] / 1e9:.1f} GB); roofline "
            f"t_compute {r['t_compute']:.4f} s, t_memory {r['t_memory']:.4f} s, t_collective "
            f"{r['t_collective']:.4f} s ({r['dominant']}); {r['hlo_flops'] / 1e12:.1f} TFLOP a "
            f"device against the model's {r['model_flops'] / 1e12:.1f}; collectives: {kinds}; "
            f"calibration "
            f"{ {k: rec['calibration'].get(k) for k in ('flops', 'coll_bytes', 'error')} }")
        per_layer = rec["calibration"]["per_unit"]
        vs_ref = (f" ({per_layer['flops'] / DRYRUN_REF_LAYER_FLOPS:.2f}x the JAX package's "
                  f"{DRYRUN_REF_LAYER_FLOPS:.3g} at 2 layers, FSDP off)"
                  if (arch, shape) == DRYRUN_CELLS[0] else "")
        log(f"dry run {rec['cell']} a layer a device: {per_layer['flops']:.4g} FLOPs{vs_ref}, "
            f"{per_layer['bytes']:.4g} bytes; {r['hlo_bytes']:.4g} bytes a device in all; "
            f"FLOPs by op {rec['cost'].get('flops_by_op')}")

    # (d) tensor parallelism on the card, its ranks started with the phase;
    # (e)'s ranks, started with them, are joined after phase 17
    return {"planned_apply": planned_apply, "planned_step": planned_step,
            "tp_apply": phase16_tp(tp)}, ep


def start_tp():
    """Phase 16 (d)'s ranks (:func:`tp_rank`), spawned now: ``(context,
    output directory, start time)``."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="forge-tp-", dir=os.environ.get("TMPDIR"))
    ctx = mp.start_processes(tp_rank, args=(TP_WORLD, free_port(), out), nprocs=TP_WORLD,
                             start_method="spawn", join=False)
    _SPAWNED.extend(ctx.processes)  # stop_children ends them if the script fails first
    return ctx, out, time.perf_counter()


def phase16_tp(tp):
    """Phase 16 (d): forge-125m at full width on a (1, 2) (data, model)
    mesh of two gloo ranks, both on this card (NCCL holds one rank per
    GPU): ``apply`` at B4 x S1024 with the fused-linear launches on
    column- and row-parallel shards and flash on 6 of the 12 heads a
    rank; rank 0 holds the logits within TOL_MODEL_BF16 of the unplanned
    run.  Joins the ranks :func:`start_tp` started; returns rank 0's
    launches."""
    import torch

    ctx, out, t0 = tp
    try:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline, "the tensor-parallel ranks did not end in 300 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    secs = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"r{r}.pt")) for r in range(TP_WORLD)]
    cfg_layers = ranks[0]["n_layers"]
    for r, res in enumerate(ranks):
        fl, fa = res["variants"]["fused_linear"], res["variants"]["flash_attention"]
        check(res["launches"]["flash_attention"] == cfg_layers
              and res["launches"]["fused_linear"] == 3 * cfg_layers
              and set(fl) == {"wgmma"} and set(fa) == {"wgmma"},
              f"rank {r}: tensor-parallel apply launched {res['launches']} ({fl}, {fa})")
        # (M, N, K) of every fused-linear launch: o (row-parallel: K 384),
        # fc (column-parallel: N 1536), out (row-parallel: K 1536)
        check(set(res["linear_shapes"]) == TP_LINEAR_SHAPES,
              f"rank {r}: fused-linear shapes {sorted(set(res['linear_shapes']))}")
        check(set(res["flash_shapes"]) == {TP_FLASH_SHAPE},
              f"rank {r}: flash q shapes {sorted(set(res['flash_shapes']))}")
    r0 = ranks[0]
    log(f"tensor-parallel forge-125m on a (1, 2) gloo mesh, two ranks on one card "
        f"({secs:.1f} s with the ranks' start): attention {r0['layout']}, fallbacks "
        f"{r0['fallbacks']}; per rank {r0['launches']['fused_linear']} fused-linear launches "
        f"(`wgmma`, (M, N, K) {sorted(set(r0['linear_shapes']))}) and "
        f"{r0['launches']['flash_attention']} flash (q {TP_FLASH_SHAPE}); logits "
        f"{r0['placements']} within TOL_MODEL_BF16 of the unplanned run (max abs "
        f"{r0['max_abs']:.3e}, rel L2 {r0['rel_l2']:.3e}); planned apply {r0['first_ms']:.1f} ms "
        f"first (its body compiles), {r0['ms']:.1f} ms steady host wall against "
        f"{r0['plain_ms']:.1f} ms unplanned; {r0['collectives']}")
    return Counts(r0["launches"], r0["variants"])


#: phase 16 (d): two ranks, the (data, model) mesh (1, 2); the local
#: fused-linear (M, N, K) of forge-125m's o, fc and out products at B4 x
#: S1024, and flash's local q
TP_WORLD = 2
TP_LINEAR_SHAPES = {(4096, 768, 384), (4096, 1536, 768), (4096, 768, 1536)}
TP_FLASH_SHAPE = (4, 6, 1024, 64)


def tp_rank(rank, world, port, out):
    """Phase 16 (d)'s rank (spawned): see :func:`phase16_tp`."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_linear as FL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        cfg = get_config("forge-125m")
        model = get_model(cfg)
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        tokens = torch.randint(0, cfg.vocab, (4, 1024), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(3))
        mesh = make_host_mesh(model=world, device_type="cuda")
        plan = plan_for(cfg, mesh)
        layout = plan.attention_layout()
        dparams = distribute_tree(params, plan.params_shardings(params))
        dtokens = distribute_tree(tokens, plan.batch_shardings(tokens))
        linear, flash = [], []
        fl_forward, fa_forward = FL._forward, FA._forward

        def fl_record(x, w, b, act):
            linear.append((x.shape[0], w.shape[1], x.shape[1]))
            return fl_forward(x, w, b, act)

        def fa_record(q, *args):
            flash.append(tuple(q.shape))
            return fa_forward(q, *args)

        FL._forward, FA._forward = fl_record, fa_record
        with torch.no_grad(), replicate_plain():
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits = model.apply(dparams, dtokens, cfg)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = counts()
            FL._forward, FA._forward = fl_forward, fa_forward
            t0 = time.perf_counter()
            model.apply(dparams, dtokens, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            placements = str(logits.placements)
            full = logits.full_tensor()
        res = {"n_layers": cfg.n_layers, "launches": dict(launches),
               "variants": launches.variants, "linear_shapes": linear, "flash_shapes": flash,
               "layout": layout, "fallbacks": list(plan.fallbacks), "first_ms": first_ms,
               "ms": ms, "placements": placements,
               "collectives": f"gloo on CUDA tensors, backend {dist.get_backend()}"}
        if rank == 0:
            with torch.no_grad():
                ref = model.apply(params, tokens, cfg)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.apply(params, tokens, cfg)
                torch.cuda.synchronize()
                res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            torch.testing.assert_close(full, ref, **TOL_MODEL_BF16)
            res["max_abs"] = float((full - ref).abs().max())
            res["rel_l2"] = rel_l2(full, ref)
        torch.save(res, os.path.join(out, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


#: phase 16 (e): phi3.5-moe at full width (d 4096, 32 heads on 8 KV
#: heads, 16 experts of d_ff 6400, top-2) at EP_LAYERS of its 32 layers in
#: f32 (11.5 GB), ``apply`` at EP_BATCH, on two gloo ranks: each (data,
#: model) mesh of EP_MESHES under its path name in the kernels line
EP_WORLD = 2
EP_LAYERS = 2
EP_BATCH = (2, 512)
EP_MESHES = {"ep_model": (1, 2), "ep_data": (2, 1)}


def start_ep():
    """Phase 16 (e)'s ranks (:func:`ep_rank`), spawned now: ``(context,
    output directory, start time)``."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="forge-ep-", dir=os.environ.get("TMPDIR"))
    ctx = mp.start_processes(ep_rank, args=(EP_WORLD, free_port(), out), nprocs=EP_WORLD,
                             start_method="spawn", join=False)
    _SPAWNED.extend(ctx.processes)  # stop_children ends them if the script fails first
    return ctx, out, time.perf_counter()


def ep_local_shapes(cfg, shape):
    """A rank's expert products' first operands on a (data, model) mesh of
    ``shape``: the (E / model, C / data, D) dispatch share and the (E /
    model, C / data, d_ff) hidden one (C padded to a multiple of data)."""
    data, model = shape
    B, S = EP_BATCH
    cap = math.ceil(cfg.top_k * B * S / cfg.n_experts * cfg.capacity_factor)
    share = -(-cap // data)
    return {(cfg.n_experts // model, share, cfg.d_model), (cfg.n_experts // model, share, cfg.d_ff)}


def phase16_ep(ep):
    """Phase 16 (e): phi3.5-moe expert-parallel on two gloo ranks, both on
    this card (:func:`ep_rank`): on the (1, 2) mesh each rank holds and
    multiplies 8 of the 16 experts, and each token's output sums over the
    two ranks; on the (2, 1) mesh each rank routes its own batch row and
    runs every expert on half the capacity, the buffers summed and
    gathered over ``data``.  For each mesh: rank 0's logits within
    TOL_DEEP_F32 (the f32 bound at full width: products of d 4096 summed
    in another order, row-parallel halves and partial sums over
    ``model``, move logits by up to 3e-5, as the kernels against the
    plain path do) of the unplanned one-device run, the dropped entries equal to
    the unplanned run's layer by layer, each rank's expert products on
    its share (:func:`ep_local_shapes`) and their device time, each rank's
    flash and fused-linear launches one a layer.  Joins the ranks
    :func:`start_ep` started; returns rank 0's launches by mesh."""
    import torch
    from repro_torch.configs import get_config

    ctx, out, t0 = ep
    try:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline, "the expert-parallel ranks did not end in 300 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    secs = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"r{r}.pt")) for r in range(EP_WORLD)]
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    r0 = ranks[0]
    log(f"expert-parallel phi3.5-moe ({EP_LAYERS} of {cfg.n_layers} layers at full width, f32, "
        f"apply B{EP_BATCH[0]} x S{EP_BATCH[1]}, capacity {r0['cap']} a layer) on two gloo ranks "
        f"on one card ({secs:.1f} s with the ranks' start): the unplanned run drops "
        f"{r0['drops']} entries by layer, its apply {r0['plain_ms']:.1f} ms host wall")
    out_counts = {}
    for path, shape in EP_MESHES.items():
        runs = [res["runs"][path] for res in ranks]
        drops = [sum(d) for d in zip(*(run["drops"] for run in runs if run["rows_counted"]))]
        check(drops == r0["drops"], f"{path} {shape}: dropped entries by layer {drops}, the "
              f"unplanned run's {r0['drops']}")
        want = ep_local_shapes(cfg, shape)
        for r, run in enumerate(runs):
            n, v = run["launches"], run["variants"]
            check(n["flash_attention"] == EP_LAYERS and n["fused_linear"] == EP_LAYERS
                  and v["flash_attention"] == {"fma": EP_LAYERS}
                  and v["fused_linear"] == {"fma": EP_LAYERS},
                  f"{path} rank {r}: launched {n} ({v})")
            check({a for a, _ in run["bmm_shapes"]} == want,
                  f"{path} rank {r}: expert products on {sorted(set(run['bmm_shapes']))}, its "
                  f"share {sorted(want)}")
        log(f"{path}: mesh (data, model) {shape}, experts {runs[0]['expert_placements']}, "
            f"logits {runs[0]['placements']} within TOL_DEEP_F32 of the unplanned run (max abs "
            f"{runs[0]['max_abs']:.3e}, rel L2 {runs[0]['rel_l2']:.3e}); dropped entries by "
            f"layer {drops}, the unplanned run's; per rank: expert products on "
            f"{[sorted(set(run['bmm_shapes'])) for run in runs]}, their device time "
            f"{[round(run['bmm_ms'], 3) for run in runs]} ms (CUDA events, the apply's "
            f"{len(runs[0]['bmm_shapes'])} bmm), flash and fused-linear launches "
            f"{[(r['launches']['flash_attention'], r['launches']['fused_linear']) for r in runs]}"
            f" ({runs[0]['variants']}); planned apply {runs[0]['first_ms']:.1f} ms first (its "
            f"bodies compile), {[round(run['ms'], 1) for run in runs]} ms steady host wall; "
            f"fallbacks {runs[0]['fallbacks']}")
        out_counts[path] = Counts(runs[0]["launches"], runs[0]["variants"])
    return out_counts


def gloo_all_gather_by_all_reduce():
    """Route this process's functional all-gathers (DTensor's
    ``Shard`` -> ``Replicate``) through an all-reduce of each rank's share
    placed in zeros: the same values (x + 0 = x) for twice the bytes.
    gloo's all-gather of CUDA tensors faults in the card's torch 2.11
    (every dtype and size, two ranks on one card), where its all-reduce,
    reduce-scatter and all-to-all do not; NCCL, one rank a card, needs
    none of this."""
    import torch
    import torch.distributed._functional_collectives as funcol
    from torch.distributed import distributed_c10d as c10d

    def all_gather_single(self, gather_dim, group, tag=""):
        pg = c10d._resolve_process_group(funcol._resolve_group_name(group, tag))
        buf = self.new_zeros((pg.size(),) + tuple(self.shape))
        buf[pg.rank()] = self
        out = funcol.all_reduce(buf, "sum", group, tag)
        out = out.wait() if hasattr(out, "wait") else out
        return torch.cat(out.unbind(0), dim=gather_dim)

    funcol.all_gather_single = funcol.all_gather_tensor = all_gather_single


def ep_rank(rank, world, port, out):
    """Phase 16 (e)'s rank (spawned): see :func:`phase16_ep`.  Rank 0
    also runs the unplanned model (its logits the reference; the same
    model unfused, within TOL_DEEP_F32 of it, for the dropped entries,
    which its routing reports)."""
    import faulthandler

    faulthandler.enable()  # a fault in a rank prints its Python stack
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import distribute_tree, plan_for, replicate_plain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models import moe as M

    class Recorder(TorchDispatchMode):
        """The local expert products (shapes, CUDA events) and positions
        of the ops DTensor runs on this rank's shards."""

        def __init__(self):
            super().__init__()
            self.bmm, self.events, self.positions = [], [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            real = not any(is_fake(a) for a in args if isinstance(a, torch.Tensor))
            if func is torch.ops.aten.bmm.default and real:
                self.bmm.append((tuple(args[0].shape), tuple(args[1].shape)))
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                res = func(*args, **(kwargs or {}))
                end.record()
                self.events.append((start, end))
                return res
            res = func(*args, **(kwargs or {}))
            if func is torch.ops.repro_torch.moe_positions.default and real:
                self.positions.append(res)
            return res

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    gloo_all_gather_by_all_reduce()
    try:
        cfg = get_config("phi3.5-moe-42b-a6.6b").with_(n_layers=EP_LAYERS, dtype="float32")
        model = get_model(cfg)
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        B, S = EP_BATCH
        tokens = torch.randint(0, cfg.vocab, (B, S), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(3))
        cap = math.ceil(cfg.top_k * B * S / cfg.n_experts * cfg.capacity_factor)
        res = {"cap": cap, "runs": {}}
        ref = None
        if rank == 0:
            drops, route = [], M.route

            def counted(*args, **kwargs):
                routed = route(*args, **kwargs)
                drops.append(int((~routed[3]).sum()))
                return routed

            with torch.no_grad():
                ref = model.apply(params, tokens, cfg)
                M.route = counted
                try:
                    unfused = model.apply(params, tokens, cfg.with_(fuse="none"))
                finally:
                    M.route = route
                # the kernels against the plain path at full width
                torch.testing.assert_close(unfused, ref, **TOL_DEEP_F32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.apply(params, tokens, cfg)
                torch.cuda.synchronize()
                res["plain_ms"] = (time.perf_counter() - t0) * 1e3
            res["drops"] = drops
            del unfused
        for path, shape in EP_MESHES.items():
            mesh = make_mesh(shape, ("data", "model"), device_type="cuda")
            # no FSDP: every rank holds its experts whole, as GShard's layout does
            plan = plan_for(cfg, mesh, fsdp=False)
            dparams = distribute_tree(params, plan.params_shardings(params))
            dtokens = distribute_tree(tokens, plan.batch_shardings(tokens))
            rec = Recorder()
            with torch.no_grad(), replicate_plain():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.apply(dparams, dtokens, cfg)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                reset_counts()
                t0 = time.perf_counter()
                with rec:
                    logits = model.apply(dparams, dtokens, cfg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = counts()
                full = logits.full_tensor()
            run = {"launches": dict(launches), "variants": launches.variants, "first_ms": first_ms,
                   "ms": ms, "bmm_shapes": rec.bmm,
                   "bmm_ms": sum(a.elapsed_time(b) for a, b in rec.events),
                   "drops": [int((p >= cap).sum()) for p in rec.positions],
                   # rows replicated over model are counted on its first rank only
                   "rows_counted": mesh.get_coordinate()[1] == 0,
                   "placements": str(logits.placements),
                   "expert_placements": str(dparams["blocks"][0]["moe"]["w_gate"].placements),
                   "fallbacks": list(plan.fallbacks)}
            if rank == 0:
                torch.testing.assert_close(full, ref, **TOL_DEEP_F32)
                run["max_abs"] = float((full - ref).abs().max())
                run["rel_l2"] = rel_l2(full, ref)
            res["runs"][path] = run
            del dparams, logits, full
        torch.save(res, os.path.join(out, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


#: the train CLI on two ranks (started after phase 15, whose CLI run left
#: Inductor's caches warm for the same step, and joined after phase 17):
#: forge-125m at full size, B8 x S128, 4 steps, a checkpoint every 2 and
#: one fault at step 3
TRAIN_RANKS_WORLD = 2
TRAIN_RANKS_ARGS = ["--arch", "forge-125m", "--batch", "8", "--seq", "128", "--steps", "4",
                    "--ckpt-every", "2", "--simulate-fault", "3"]


def start_train_ranks():
    """The train CLI's ranks (:func:`train_cli_rank`), spawned now:
    ``(context, output directory, start time)``."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="forge-train-ranks-", dir=os.environ.get("TMPDIR"))
    ctx = mp.start_processes(train_cli_rank, args=(TRAIN_RANKS_WORLD, free_port(), out),
                             nprocs=TRAIN_RANKS_WORLD, start_method="spawn", join=False)
    _SPAWNED.extend(ctx.processes)  # stop_children ends them if the script fails first
    return ctx, out, time.perf_counter()


def train_cli_rank(rank, world, port, out):
    """A rank of the train CLI (spawned): ``launch.train.main`` in the
    environment ``torchrun --nproc-per-node 2`` sets, so that ``main``
    opens the group itself; both ranks on this card (``--device cuda:0``:
    ``cuda`` names ``cuda:<local rank>``, and the machine has one).
    Writes the run and the launches counted around ``main``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import train

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    run = {}
    t0 = time.perf_counter()
    reset_counts()
    code = train.main(TRAIN_RANKS_ARGS + ["--device", "cuda:0", "--ckpt-dir",
                                          os.path.join(out, "ckpt")], out=run)
    torch.cuda.synchronize()
    launched = counts()
    step, rep, ckpt = run["step"], run["report"], run["ckpt"]
    torch.save({"code": code, "seconds": time.perf_counter() - t0,
                "step_type": type(step).__name__, "device": str(step.device),
                "history": rep.history, "failures": rep.failures, "restores": rep.restores,
                "all_steps": ckpt.all_steps(), "timings": ckpt.timings,
                "launches": dict(launched), "variants": launched.variants,
                "kernel_nodes": step.kernel_nodes, "replays": step.replays,
                "compile_s": step.compile_s, "step_s": run["step_s"]},
               os.path.join(out, f"r{rank}.pt"))


def phase_train_ranks(tr):
    """The train CLI on two ranks of a gloo group it opened itself, both on
    this card: each rank's step the compiled ``JitTrainStep``, the same
    losses on both (bitwise: the same programs on the same batches), one
    failure and one restore on each from the step-2 checkpoint, steps 0,
    2 and 4 on disk written by rank 0 alone, each rank's launches the
    steps' forward and backward kernel nodes plus the first call's eager
    forward, equal on both.  Joins the ranks :func:`start_train_ranks`
    started; returns rank 0's launches."""
    import torch

    ctx, out, t0 = tr
    try:
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline, "the train CLI's ranks did not end in 600 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    secs = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
             for r in range(TRAIN_RANKS_WORLD)]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    for i, r in enumerate(ranks):
        check(r["code"] == 0 and r["step_type"] == "JitTrainStep" and r["device"] == "cuda:0",
              f"train rank {i}: exit {r['code']}, step {r['step_type']} on {r['device']}")
        check(r["failures"] == 1 and r["restores"] == 1
              and [h["step"] for h in r["history"]] == [0, 1, 2, 2, 3]
              and len(r["timings"]["restore_s"]) == 1,
              f"train rank {i}: {r['failures']} failures, {r['restores']} restores, steps "
              f"{[h['step'] for h in r['history']]}")
        check(all(math.isfinite(x) for x in losses[i]), f"train rank {i}: losses {losses[i]}")
        fwd, bwd = r["kernel_nodes"]["forward"], r["kernel_nodes"]["backward"]
        for name in ("flash_attention", "fused_linear"):
            want = (fwd.get(name, 0) + bwd.get(name, 0)) * len(r["history"]) + fwd.get(name, 0)
            check(r["launches"][name] == want > 0,
                  f"train rank {i}: {name} launches {r['launches'][name]} != {want}")
    check(losses[0] == losses[1], f"the ranks' losses differ: {losses}")
    check(ranks[0]["all_steps"] == ranks[1]["all_steps"] == [0, 2, 4]
          and len(ranks[0]["timings"]["write_s"]) == 4
          and ranks[1]["timings"]["snapshot_s"] == ranks[1]["timings"]["write_s"] == [],
          f"checkpoints {ranks[0]['all_steps']}, rank 0 wrote {len(ranks[0]['timings']['write_s'])}, "
          f"rank 1 {len(ranks[1]['timings']['write_s'])}")
    check(ranks[0]["launches"] == ranks[1]["launches"],
          f"the ranks launched {ranks[0]['launches']} and {ranks[1]['launches']}")
    r0 = ranks[0]
    log(f"train CLI on two gloo ranks, both on this card ({secs:.1f} s with the ranks' start; "
        f"rank runs {ranks[0]['seconds']:.1f} / {ranks[1]['seconds']:.1f} s, step builds "
        f"{ranks[0]['compile_s']:.1f} / {ranks[1]['compile_s']:.1f} s): {' '.join(TRAIN_RANKS_ARGS)}; "
        f"each step JitTrainStep, {r0['replays']} replays; losses "
        f"{', '.join(f'{x:.4f}' for x in losses[0])} bitwise equal on both ranks; one fault at "
        f"step 3 restored from step 2 on each (restore {r0['timings']['restore_s'][0]:.2f} / "
        f"{ranks[1]['timings']['restore_s'][0]:.2f} s); checkpoints {r0['all_steps']} written "
        f"by rank 0 alone (snapshots {[round(x, 2) for x in r0['timings']['snapshot_s']]} s); "
        f"median step {1e3 * sorted(r0['step_s'])[len(r0['step_s']) // 2]:.1f} ms; launches a "
        f"rank {r0['launches']}, {r0['variants']}")
    return Counts(r0["launches"], r0["variants"])


def load_example(name):
    """The module ``examples/torch_<name>.py``, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv, want, **kwargs):
    """``examples/torch_<name>.py``'s ``main(argv)``, called in this process
    on the card as the script calls it (``sys.exit(main())``): it must
    return 0 and print each of ``want``.  Returns its output and seconds."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = load_example(name).main(argv, **kwargs)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    check(code == 0, f"examples/torch_{name}.py returned {code}: {out[-2000:]}")
    for text in want:
        check(text in out, f"examples/torch_{name}.py printed no {text!r}: {out[-2000:]}")
    return out, secs


def phase17(dev):
    """Phase 17: the examples on the card, each ``main`` in this process.
    (a) ``examples/torch_quickstart.py``: its fused graph and fidelity;
    its ``forge.sdpa`` (head dim 8) launches the flash kernel zero-padded
    to 16, also held here against the plain version at the block's shape.
    (b) ``examples/torch_serve_batch.py --arch forge-125m --full --gen 8
    --max-len 256`` on seed-0 weights: phase 12 (b)'s jit step's shapes,
    so Inductor's caches hold its compile.  Both modes' decode times, and
    the greedy tokens of ``jit`` against ``interpret``'s: equal, or each
    differing row held at its first differing token by the measured-slack
    rule (:func:`hold_diverged_rows`), its margins logged."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import get_model

    release_device_memory()
    reset_counts()
    out, secs = run_example("quickstart", [], ("forge.sdpa", "fidelity: max-abs=",
                                               "on cuda:0 — OK"))
    launched = counts()
    check(launched["flash_attention"] >= 1 and launched["fused_linear"] >= 1,
          f"quickstart: launches {launched}")
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn(2, 8, 64, 8, generator=g, device=dev)
    k, v = (torch.randn(2, 2, 64, 8, generator=g, device=dev) for _ in range(2))
    got = FA.flash_attention_cuda(q, k, v, scale=8 ** -0.5, causal=True)
    want = FA.flash_attention_plain(q, k, v, scale=8 ** -0.5, causal=True)
    assert_close(got, want, torch.float32, "flash at head dim 8 (padded to 16)", TOL_F32)
    lines = [ln.strip() for ln in out.splitlines()
             if any(t in ln for t in ("fused ops", "forge.sdpa", "fidelity", "FGR", "OK"))]
    log(f"examples/torch_quickstart.py on the card: returned 0 in {secs:.1f} s; launches "
        f"{launched}, {launched.variants}; flash at head dim 8 padded to 16 within TOL_F32 of "
        f"the plain version (max abs {(got - want).abs().max().item():.2e}); "
        + " | ".join(lines))

    release_device_memory()
    cfg = get_config("forge-125m")
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    res = {}
    reset_counts()
    out, secs = run_example(
        "serve_batch", ["--arch", "forge-125m", "--full", "--gen", "8", "--max-len", "256"],
        ("[jit      ] decode", "[interpret] decode", "greedy tokens jit == interpret:"),
        params=params, out=res)
    launched = counts()
    check(launched["fused_linear"] > 0, f"serve example: launches {launched}")
    jit, interp = res["jit"]["tokens"], res["interpret"]["tokens"]
    check(jit.shape == interp.shape == (4, 8), f"serve example: tokens {jit.shape}")
    diverged = hold_diverged_rows(model, cfg, params, res["prompts"], jit, interp, dev,
                                  "serve example")
    lines = [ln.strip() for ln in out.splitlines() if "decode" in ln or "greedy" in ln]
    log(f"examples/torch_serve_batch.py on the card: returned 0 in {secs:.1f} s; jit compile "
        f"{res['jit']['compile_s']:.1f} s; launches {launched}, {launched.variants}; greedy "
        f"tokens equal in {int((jit == interp).all(axis=1).sum())}/4 rows"
        + (f"; diverged rows held at their first differing token: {diverged}" if diverged
           else "") + "; " + " | ".join(lines))
    del params


def main(argv=None):
    import argparse

    global QWEN_JIT_LAYERS
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port")
    ap.add_argument("--qwen-jit-layers", type=int, default=QWEN_JIT_LAYERS,
                    help="the depth phase 12 compiles qwen2.5-14b's jit step at")
    args = ap.parse_args(argv)
    QWEN_JIT_LAYERS = args.qwen_jit_layers
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("FAIL: src/repro_torch is not beside this script; run it from the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # phase 12's torch.compile writes its Inductor and Triton caches under
    # the repository's build directory, beside the kernels' libraries
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 results are compared
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t, 1)
        log(f"{name} took {took[name]:.1f} s")
        return out

    dryrun = start_dryrun()
    timed("phase 1 (build)", phase_build)
    timer = Timer(dev)
    fl_rows, fa_rows, pa_rows, rg_rows, rms_rows, _ = timed("phase 2", lambda: (
        phase_fused_linear(dev, timer), phase_flash(dev, timer), phase_paged(dev, timer),
        phase_rg_lru(dev, timer), phase_rms_norm(dev, timer), phase_kernel_grads(dev)))
    launches = timed("phases 3-4", phase_main_path, dev)
    launches["paged"] = timed("phase 5", phase_paged_serve, dev)
    release_device_memory()
    cli_runs = start_cli_runs()
    launches.update(timed("phase 6", phase_rglru, dev))
    launches.update(timed("phase 7", phase_xlstm, dev))
    launches.update(timed("phase 8", phase_dense_contiguous, dev))
    # phase 9, with phase 12's qwen2.5-14b paths on its weights
    launches.update(timed("phases 9 and 12 on qwen2.5-14b", phase_qwen, dev,
                          lambda *a: phase12_qwen(dev, *a)))
    launches.update(timed("phase 10", phase_compile_cost, dev, cli_runs))
    launches.update(timed("phase 11", phase_faults_slo, dev, cli_runs))
    launches.update(timed("phase 12 on forge-125m", phase12_forge, dev))
    launches.update(timed("phase 13", phase13, dev))
    launches.update(timed("phase 14", phase14, dev))
    launches.update(timed("phase 15", phase15, dev))
    # the train CLI's two ranks run beside phases 16-17 (phase 15 left
    # Inductor's caches warm for their step)
    train_ranks = start_train_ranks()
    planned, ep = timed("phase 16", phase16, dev, dryrun)
    launches.update(planned)
    timed("phase 17", phase17, dev)
    launches.update(timed("phase 16 (e) after phase 17", phase16_ep, ep))
    launches["train_ranks"] = timed("the train CLI's ranks after phase 17", phase_train_ranks,
                                    train_ranks)
    # no path of the JAX package reaches rms_norm_pallas, nor does one here
    check(not any(n["rms_norm"] for n in launches.values()),
          f"rms_norm launched on a served path: {launches}")
    # the kernels the rank, scheduler and async paths must launch
    for path, name in (("rglru_sched", "rg_lru"), ("rglru_async", "rg_lru"),
                       ("qwen_async", "paged_attention"), ("qwen_async", "fused_linear"),
                       ("train_ranks", "fused_linear"), ("train_ranks", "flash_attention")):
        check(launches[path][name] > 0, f"{name} launched no time on {path}")
    check_variants(launches)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s: {json.dumps(took)}")

    def timing(t):
        return {"max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes"] / HBM_BYTES_PER_S > t["flops"] / BF16_FLOPS
                else "operations",
                "library_ms": t["library_ms"], **({"plan": t["plan"]} if "plan" in t else {})}

    def row(name, replaces, head, per_path, on_path=True):
        """The kernel's row: ``launches`` sums the paths' counted runs;
        the top-level times are those of ``per_path[head]``; ``per_path``
        keeps each path's launches beside the times taken at its shapes."""
        n = {path: launches[path][name] for path in launches}
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": replaces, "launches": sum(n.values())}
        check(out["launches"] > 0 or not on_path, f"{name} launched on no path")
        out.update(timing(per_path[head]))
        by_path = {path: launches[path].variants.get(name) for path in launches}
        if any(v is not None for v in by_path.values()):
            out["variants"] = {}
            for v in by_path.values():
                for k, c in v.items():
                    out["variants"][k] = out["variants"].get(k, 0) + c
        out["per_path"] = {path: dict({"launches": n[path]},
                                      **({"variants": by_path[path]}
                                         if by_path[path] is not None else {}),
                                      **(timing(per_path[path]) if path in per_path else {}))
                           for path in n}
        return out

    # fused_linear times are one layer's launches at the path's M: three
    # for forge-125m (4 at decode, B*S = 4096 in apply; the paged path's
    # decode M is 4; 4 x 32 = 128 in the contiguous prefill cell), four for a recurrentgemma-2b rec layer (4 at decode,
    # 4 x 32 = 128 in the prefill cell, 2 x 1024 = 2048 in apply); flash
    # runs in the apply bodies and in seamless-m4t-large-v2's serving (its
    # encoder body and the decode step's cross-attention at one query
    # row), paged attention in the paged paths only, rg_lru in
    # recurrentgemma-2b's prefill and apply (f32 inputs)
    kernels = [
        row("fused_linear", "src/repro/kernels/fused_linear.py:134", "serve",
            {"serve": fl_rows[4], "apply": fl_rows[4096], "paged": fl_rows[4],
             "rglru_serve": fl_rows[("rglru", 128)],
             "rglru_sequential": fl_rows[("rglru", 4)],
             "rglru_apply": fl_rows[("rglru", 2048)],
             "rglru_sched": fl_rows[("rglru", 4)], "rglru_async": fl_rows[("rglru", 4)],
             "qwen_async": fl_rows[("qwen", 4)], "train_ranks": fl_rows[TRAIN_ROWS],
             "xlstm_serve": fl_rows[("xlstm", 128)],
             "xlstm_sequential": fl_rows[("xlstm", 4)],
             "xlstm_sched": fl_rows[("xlstm", 4)],
             "xlstm_apply": fl_rows[("xlstm", 2048)],
             "dense_serve": fl_rows[128], "dense_sequential": fl_rows[4],
             "dense_sched": fl_rows[4],
             "qwen_eager": fl_rows[("qwen", 4)], "qwen_serve": fl_rows[("qwen", 128)],
             "qwen_apply": fl_rows[("qwen", 1024)], "qwen_paged": fl_rows[("qwen", 4)],
             "jit_qwen": fl_rows[("qwen", 4)], "autotune_qwen": fl_rows[("qwen", 1024)],
             "jit_forge": fl_rows[4], "autotune_forge": fl_rows[4096],
             "phi_paged": fl_rows[("phi", 4)], "phi_serve": fl_rows[("phi", 4)],
             "phi_apply": fl_rows[("phi", 1024)], "jit_phi": fl_rows[("phi", 4)],
             "vl_eager": fl_rows[("vl", 4)], "vl_serve": fl_rows[("vl", 4)],
             "vl_apply": fl_rows[("vl", 1024)], "kimi_apply": fl_rows[("kimi", 256)],
             "kimi_eager": fl_rows[("kimi", 4)], "encdec_apply": fl_rows[("encdec", 2048)],
             "encdec_serve": fl_rows[("encdec", 4)], "train": fl_rows[TRAIN_ROWS],
             "train_step": fl_rows[TRAIN_ROWS], "planned_apply": fl_rows[4096],
             "planned_step": fl_rows[TRAIN_ROWS], "tp_apply": fl_rows[("tp", 4096)]}),
        row("flash_attention", "src/repro/kernels/flash_attention.py:167", "apply",
            {"apply": fa_rows["apply"], "qwen_apply": fa_rows["qwen"],
             "autotune_forge": fa_rows["apply"], "autotune_qwen": fa_rows["qwen"],
             "phi_apply": fa_rows["phi"], "vl_apply": fa_rows["vl"],
             "kimi_apply": fa_rows["kimi"], "encdec_apply": fa_rows["encdec_enc"],
             "encdec_serve": fa_rows["encdec_decode"], "train": fa_rows["train"],
             "train_step": fa_rows["train"], "train_ranks": fa_rows["train"],
             "planned_apply": fa_rows["apply"],
             "planned_step": fa_rows["train"], "tp_apply": fa_rows["tp"]}),
        row("paged_attention", "src/repro/kernels/paged_attention.py:190", "paged",
            {"paged": pa_rows["served"], "qwen_paged": pa_rows["qwen_served"],
             "qwen_async": pa_rows["qwen_served"],
             "phi_paged": pa_rows["phi_served"]}),
        row("rg_lru", "src/repro/kernels/rg_lru.py:130", "rglru_serve",
            {"rglru_serve": rg_rows[(4, 32)], "rglru_sched": rg_rows[(4, 32)],
             "rglru_apply": rg_rows[(2, 1024)],
             "rglru_train": rg_rows[(8, 128)]}),
    ]
    # phase 2's further shapes: flash bf16 D=128 with GQA; paged at long
    # context and with GQA at D=128 (plans: [splits, chunk pages]); rg_lru
    # at each served shape (plans: [chunks, steps])
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    kernels[1]["head_dims"] = list(FA.HEAD_DIMS)
    kernels[1]["per_shape"] = {"B4-H12-S1024-D64": timing(fa_rows["apply"]),
                               "B4-H32-KVH8-S1024-D128": timing(fa_rows["d128"]),
                               "B1-H40-KVH8-S1024-D128": timing(fa_rows["qwen"]),
                               "B1-H32-KVH8-S1024-D128": timing(fa_rows["phi"]),
                               "B1-H64-KVH8-S1024-D128": timing(fa_rows["vl"]),
                               "B1-H64-KVH8-S256-D112": timing(fa_rows["kimi"]),
                               "B8-H12-S128-D64-train": timing(fa_rows["train"]),
                               "B4-H6-S1024-D64-tensor-parallel": timing(fa_rows["tp"]),
                               **{f"B{b}-H{h}-Sq{sq}-Sk{sk}-D64-"
                                  f"{'causal' if c else 'noncausal'}": timing(
                                      fa_rows[f"encdec_{name}"])
                                  for name, (b, h, sq, sk, c) in ED_FLASH}}
    kernels[0]["per_shape"] = {f"{name}-layer-M{M}": timing(fl_rows[(tag, M)])
                               for tag, name, ms in (("qwen", "qwen2.5-14b", QW_FL_ROWS),
                                                     ("phi", "phi3.5-moe", PHI_FL_ROWS),
                                                     ("kimi", "kimi-k2", KIMI_FL_ROWS),
                                                     ("vl", "qwen2-vl-72b", VL_FL_ROWS),
                                                     ("encdec", "seamless-m4t-large-v2",
                                                      ED_FL_ROWS))
                               for M in ms}
    kernels[0]["per_shape"]["forge-125m-train-layer-M1024"] = timing(fl_rows[TRAIN_ROWS])
    kernels[0]["per_shape"]["forge-125m-tensor-parallel-rank-layer-M4096"] = timing(
        fl_rows[("tp", 4096)])
    kernels[2]["head_dims"] = list(PA.HEAD_DIMS)
    kernels[2]["per_shape"] = {"B4-H12-D64-served": timing(pa_rows["served"]),
                               "B8-H12-D64-pos2047": timing(pa_rows["long"]),
                               "B4-H32-KVH8-D128-pos2047": timing(pa_rows["gqa128"]),
                               "B4-H40-KVH8-D128-served": timing(pa_rows["qwen_served"]),
                               "B4-H40-KVH8-D128-pos2047": timing(pa_rows["qwen_pos2047"]),
                               "B4-H32-KVH8-D128-served": timing(pa_rows["phi_served"])}
    kernels[3]["per_shape"] = {f"B{b}xT{t}": timing(rg_rows[(b, t)])
                               for b, t in ((4, 32), (4, 64), (2, 1024), (8, 128))}
    # the same source serves rg_lru_chunked (its `last` output), which no
    # served path calls (only ops.rg_lru_scan); phase 2 checks it
    kernels[-1]["also_replaces"] = "src/repro/kernels/rg_lru.py:159"
    kernels[-1]["chunked"] = timing(rg_rows["chunked"])
    # rms_norm is reached only through ops.rms_norm, as in the JAX package
    # (no model calls it): 0 launches on every path; its times are phase
    # 2's at xlstm-350m's widths, the head at apply's 2048 x 1024 rows
    rms = row("rms_norm", "src/repro/kernels/rms_norm.py:54", "apply_rows", {
        "apply_rows": rms_rows[(2048, 1024)]}, on_path=False)
    rms["per_shape"] = {f"{r}x{d}": timing(t) for (r, d), t in rms_rows.items()}
    kernels.append(rms)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def run():
    """``main()``, then the CLI subprocesses that still run killed and
    Inductor's compile workers stopped (phase 12's torch.compile starts
    them)."""
    try:
        return main()
    finally:
        stop_children()
        if "torch._inductor.async_compile" in sys.modules:
            sys.modules["torch._inductor.async_compile"].shutdown_compile_workers()


if __name__ == "__main__":
    sys.exit(run())
