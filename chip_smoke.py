#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distkeras_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX is needed or imported) through
thirty-two phases, each printing JSON lines, and fails with a non-zero
exit if any phase fails:

1. device: the card's name, power limit, SM count and maximum SM clock
   (for the exponential rate of the bounds), the torch and CUDA versions,
   and the build of every kernel from the checkout's sources (``nvcc``);
2. kernel: the flash-attention forward against its plain PyTorch version
   on the card, at the serving slice's shapes and a few more (head dims
   that the kernels pad, the parallel LM's Ulysses shape: B 8, S 2048,
   8 heads, MHA, D 64, and a 16-bit D 36), in f32, bf16 and f16 (each
   served by the variant its dtype and head dim select: sm90 for 16-bit
   head dims that are multiples of 8, SIMT for f32 and D 36), each run
   twice and bit-identical, with the error beside its per-element
   tolerance, and the kernel's, plain
   version's and ``scaled_dot_product_attention``'s times (a yardstick
   only: the port never calls it) beside the card's bound (bytes,
   products or one exponential per live pair, whichever is largest; the
   products on the units that do them fastest: the dtype's peak, or the
   TF32 tensor cores in split passes for f32); at
   the slice's and the Ulysses shape in bf16 the SIMT kernel is timed too,
   through the private launcher, so the two variants are compared on one
   card;
3. slice: ``ModelPredictor`` over a full-width ``transformer_lm`` (the
   widest LM the JAX package benchmarks: vocab 512, seq 2048, d_model 256,
   8 heads, 2 kv heads, 4 layers, mlp 1024) in its ``"full"`` and
   ``"rolling_window"`` forms, in bf16 (the slice's dtype) and f32, with
   random weights from a numpy seed loaded through ``load_jax_weights``;
   the kernel route is held against the plain route
   (``attention_impl="xla"``) and must have launched the kernel once per
   layer and batch, every bf16 launch on the sm90 variant and every f32
   one on the SIMT variant;
4. blob: ``FittedModel.save`` → ``load`` → ``predict`` gives bit-identical
   logits;
5. kernel_train: the training form of the forward (out and lse) and the
   two backward kernels (dq, dk/dv) against their plain versions on the
   card, at phase 2's shapes in f32, bf16 and f16 with a random dO (the
   backward on the variant its dtype and head dim select: sm90 for
   16-bit head dims up to 128, SIMT, the split-TF32 tensor-core pair, for
   f32 and every other head dim; the forward and every pair run twice on
   the same inputs and bit-identical), with each error beside its
   per-element tolerance,
   and the kernels', plain versions' and ``scaled_dot_product_attention``
   backward's times (a yardstick only, under each SDPA backend that takes
   the case, the least kept) beside the card's bound (phase 2's rule)
   and, beside it, the bounds with the products at the f32 CUDA-core peak
   and in split-TF32 passes at the TF32 tensor-core peak; at the
   slice's and the Ulysses shape in bf16 the SIMT forward and the SIMT
   backward pair are timed too, as in phase 2;
6. memory: forward and backward (the sm90 kernels) at S 8192 allocate
   nothing of size S²;
7. train: ``SingleTrainer`` trains the full-width LM (both forms, bf16
   and f32) on the x+1 next-token task, 16 steps, on the kernel route
   and on the plain route (``attention_impl="xla"``) from the same
   weights: the kernel route must have launched the training forward,
   dq and dk/dv once per layer and step (each on the variant of the
   dtype: sm90 at bf16, SIMT at f32) and the plain route never, the
   routes must agree (first-step gradients and loss traces at f32, loss
   traces within a measured band at bf16), the loss must fall, and
   ``ModelPredictor`` must serve the trained model through the
   inference kernel;
8. kernel_ce: the fused cross-entropy kernels (forward, backward) against
   their plain versions at the parallel LM's (16384, 32768) in f32 and
   bf16, ragged (300, 1000), GPT-2's vocab (4096, 50257), (8, 16) in
   f16, +-1e4 logits, out-of-range labels and misaligned rows, each
   error beside its tolerance, and the kernels', plain versions' and
   ``cross_entropy``'s times (a yardstick only) beside the bytes bound;
9. memory_ce: loss forward + backward at (16384, 32768) f32 holds one
   (T, V) tensor above the logits on the fused route (the gradient) and
   at least one more on the plain route;
10. parallel_train: the full-width ``ParallelTransformerLM`` of
    ``scripts/bench_transformer.py`` (vocab 32768, d_model 512, 8 heads,
    8 layers, mlp 2048, RoPE, bf16, batch 8 x 2048, adam 1e-3) from one
    numpy-seeded weight set through ``load_jax_params``, 8 steps each on
    the fused-CE ring, plain-CE ring and fused-CE Ulysses routes: the
    fused CE kernels launch once per step on the fused routes and never
    on the plain one, the flash kernels once per layer and step on the
    Ulysses route (forward, dq and dk/dv on sm90 at bf16, on SIMT at f32)
    and never on the ring, the loss falls on every route,
    the routes agree within measured bf16 bands, and at f32 (2 layers)
    fused and plain CE agree in loss traces (1e-5) and first-step
    gradients, and so do Ulysses and ring (loss traces 1e-4);
11. wide: a head dim above 256 (B 2, S 1024, H 4, Hkv 2, D 320, causal,
    f32 and bf16) through ``attention`` forward, backward and inference
    form, every launch on the SIMT kernels (in 128-column chunks), each
    kernel against its plain version under phases 2 and 5's rules, both
    forward forms and the backward pair repeated bit-identically, with the
    kernels', plain versions' and SDPA's times beside the bounds;
12. views: q, k, v as ``chunk(3, dim=2)`` of one bf16 projection at the
    serving slice's widths, as contiguous views off a 16-byte boundary,
    and (T, V) logits that are a transpose, through ``attention`` and
    ``fused_softmax_cross_entropy`` forward and backward: the kernels
    launch, the results equal the same calls on contiguous copies to the
    bit, the gradients come in the views' shapes, and the plain versions
    agree under phases 5 and 8's rules;
13. zoo: the MNIST flow (MinMax → OneHot → ``SingleTrainer`` →
    ``ModelPredictor`` → LabelIndex → Accuracy) with ``mnist_convnet`` in
    bf16 on 60000 rows, batch 512, adam 1e-3, 2 epochs: accuracy >= 0.8
    on 10000 test rows, the epoch loss falls, examples/s and predict
    rows/s on the host clock; the trained model's blob round trip
    bit-identical; bf16 against f32 from the same weights on the first
    batch within measured bands; the CIFAR-10 ConvNet and the Higgs MLP
    for an epoch (the loss falls); one step of the digits models and of
    a batch-norm stack (finite, the running statistics move); and no
    attention or cross-entropy kernel launched on any of it.
14. adag: the SPMD engine and the distributed trainers.  The north-star
    workload at full size (``bench.py:1109-1170``: ``SPMDEngine`` over
    ``mnist_convnet`` in bf16, adam, algorithm adag, window 12, batch 512,
    60000 rows, one worker on the card, the epoch on the card): one
    warm-up epoch, then timed epochs with one host sync at the end, printed
    as ``examples_per_sec_per_chip_mnist_convnet_adag`` with its ``mfu``
    (the port's ``flops_per_example`` over ``peak_flops``); the verify
    recipe through ``ADAG`` (f32 ConvNet, 8 workers on the card, 6 epochs:
    accuracy >= 0.8); DOWNPOUR, DynSGD, AEASGD, EAMSGD, Averaging and
    Ensemble with 4 workers (the loss falls); ADAG over a batch-norm stack
    (the synced statistics reach the center); one f32 ADAG epoch on the
    card against the port on the CPU within measured bands, and the same
    epoch streamed onto the card round by round equal to it to the bit; a
    round-unit checkpoint resume bit-identical to the uninterrupted run; and no
    attention or cross-entropy kernel launched on any of it.
15. pack: sequence packing (``data/packing.py``) of x+1 documents of 32 to
    1024 tokens into 64 rows of 2048 (its efficiency printed); at f32 on
    a 2-layer copy of the LM with RoPE each document of a packed row
    gives its own forward's logits (1e-4; the bf16 band beside it);
    ``SingleTrainer(segment_col=)`` with the masked loss trains 16 steps
    in bf16 and the loss falls; ``ADAG(segment_col=)`` runs 2 rounds of 2
    workers on the SPMD engine; no kernel launched on either run.
16. decode: the four decode configurations of
    ``scripts/bench_kernels.py`` (full, full_int8, rolling_window,
    rolling_window_int8: batch 8, 256 greedy ``decode_step``s) with their
    tokens/s and ms per step; at f32 the cached step's logits against the
    full forward over a 1024-token prompt, ``generate`` on the card equal
    to ``generate`` on the CPU (1024 + 256 tokens, both forms), beam
    search (4 beams: one beam is greedy, the scores are the full
    forward's log-probabilities), greedy speculative decoding with a
    1-layer draft equal to ``generate``; int8 weights' bytes and greedy
    agreement; no kernel launched on any of it.
17. serve: the ``ServingEngine`` (``serving.py``) over the LM at full
    width in bf16, form full (both forms in the f32 checks), 8 slots,
    chunks of 128: a seeded trace of
    16 requests (prompts of 16, 64, 256 and 1024 tokens, 128 new tokens
    each, half greedy, half sampled at temperature 0.7 with seeds of
    their own, some with top-k 40 or top-p 0.9) through the engine with
    its decode step as a CUDA graph and through the same engine with the
    step uncaptured: tokens/s, ms per decode step, TTFT p50/p99, slot
    occupancy, graph captures and replays, uploads and readbacks per
    decode-only iteration (0 and 1), ATen calls, launches and busy time
    a step under ``torch.profiler``; the two give the same tokens, no
    request is lost and every slot is reused; at f32 on a 2-layer copy
    (TF32 off) a lone greedy and a lone sampled request equal
    ``generate`` in both prefill modes, the trace through the graph
    engine equals the eager engine (``prefill_mode="eager"``), and the
    greedy requests equal the same engine on the CPU; no kernel launched
    on any of it.
18. paged: the same engine with its paged KV pool (``paged=True``, blocks
    of 16 tokens, the default ``kv_blocks``: the dense pool's capacity)
    over phase serve's trace, bf16, form full, its decode step as a CUDA
    graph (block tables on the device) and uncaptured: tokens/s, ms per
    decode-only iteration, TTFT, ATen calls a step, uploads and readbacks
    per decode-only iteration, the arena's bytes beside the dense pool's;
    the two equal, one capture and a replay a step, no block leaked; the
    shared-prefix trace of ``bench.py:741-790`` (16 requests behind one
    240-token prefix, suffixes of 4, 6 or 8 tokens, 1 new token) through
    the paged and the dense engine: TTFT, effective prefill tokens/s, the
    prefix hit rate and ``serving_paged_capacity_slots``, at least 224 x
    15 hit tokens; at f32 on 2 layers the paged engine equals the dense
    engine and ``generate`` over both traces in both forms, and a tight
    arena (2 slots' blocks) evicts and stays exact; no kernel launched on
    any of it.
19. spec: speculation and quantization in the engine: phase serve's
    engine and trace with ``spec_len`` 4, drafted by the target and by a
    1-layer draft (both trained briefly on x+1), dense and paged, graph
    and uncaptured; ms a round, the accept rate, tokens a round a row, the
    int8 pools' bytes; at f32 speculative = plain = ``generate`` and card
    = CPU; no kernel launched on any of it.
20. qos: multi-tenant QoS and paged-KV preemption in the engine (the LM
    at full width, bf16, paged, blocks of 16, form full, 8 slots, the
    tenants of ``examples/loadgen.py:138-155 qos_policies(3)``): phase
    serve's first 8 requests each preempted once at its own decode depth
    and resumed, every row equal to the same requests unpreempted, the
    swap-out and resume ms, blocks and bytes; with tenants registered a
    decode-only iteration still uploads nothing, reads back one row and
    replays the graph once; an open-loop overload of 32 mixed-tenant
    requests at 200 requests/s on an arena of 160 blocks, with the
    policies and as plain FIFO: interactive and batch latency, completion
    rates, preemptions and resumes, no block leaked, interactive p99 <=
    batch p99 with the policies; at f32 on 2 layers a preempted greedy
    and a preempted sampled request equal their unpreempted rows and the
    CPU's; no kernel launched on any of it.
21. disagg: disaggregated prefill/decode roles and the wire front-end (the
    LM at full width, bf16, paged, blocks of 16, form full, 8 slots, one
    prefill-role and one decode-role engine on the card): phase serve's
    trace through the unified paged engine, an in-process ``DisaggPair``
    and a pair whose decode engine sits behind a ``ServingServer``, every
    row equal; the blocks and bytes shipped equal those ingested and the
    block arithmetic (16,384 B a block); the extraction and ingest ms,
    the wire hand-off of a 1024-token prompt's blocks; a decode-only
    iteration of the decode engine uploads nothing, reads back one row and
    replays its graph once, and the prefill engine captures no graph; the
    bimodal interference trace of ``bench.py:866-893`` through the unified
    engine and the pair (per-token decode p99 of the short requests, TTFT,
    ``serving_kv_transfer_bytes``); phase serve's first 8 requests from a
    ``ServingClient`` against a ``ServingServer`` on both cores, equal to
    the in-process rows, with a ``load()`` probe and a mid-stream cancel
    that frees its blocks; at f32 on 2 layers the pair equals the unified
    engine and the CPU; no block leaked and no kernel launched on any of
    it.
22. fleet: the serving router and the supervisors (``router.py``,
    ``resilience.py``; the LM at full width, bf16, paged, blocks of 16,
    form full, 8 slots a replica, N in-process replicas on the one card):
    phase serve's trace through a 1-replica and a 2-replica ``"prefix"``
    router, every row equal to the single paged engine's;
    ``serving_fleet_tokens_per_sec`` at 1, 2 and 4 replicas (closed loop
    at 4 users a replica); ``serving_fleet_prefix_hit_rate`` under
    ``"prefix"`` and ``"random"`` over phase paged's shared-prefix trace;
    ``serving_fleet_failover_lost_requests`` (0) when one of two replicas
    is killed with every request on it mid-stream, the resubmitted rows
    equal; a ``FleetSupervisor`` restarting a replica killed under
    traffic, a ``rolling_swap`` under traffic (every response attributed
    to one generation) and an ``EngineSupervisor`` restarting a
    ``ServingServer``'s crashed engine under a retrying client, each
    clone's decode graph captured while the other replicas serve: the
    recovery and capture ms, the longest scheduler iteration against the
    liveness deadline; no block leaked and no kernel launched on any of
    it.
23. host_ps: the in-process host parameter server
    (``execution="host_ps"``: every worker a thread training its own
    copy of the model on the card, a socket PS on loopback applying the
    commits on the host): the north-star ConvNet (bf16, 60000 rows, batch
    512, window 12, adam) under ADAG with 2 threads, one epoch with
    ``comm_overlap`` on and off (examples/s, round trips a window exactly
    1.0 and 2.0, first and last window losses, accuracy on 1,024
    held-out rows); DOWNPOUR, DynSGD, AEASGD and EAMSGD for 4 windows a
    worker (each loss falls, the PS clock = the workers' commits); one
    worker, serial, twice bit for bit, and with bf16 and int8 commits
    (half and a quarter of the f32 delta bytes); the LM at full width
    under ADAG from 2 threads, the sm90 forward, dq and dk/dv launched
    exactly once per layer, step and worker; the ConvNet's examples/s at
    1 and 2 threads; the ConvNet legs launch no kernel.
24. ps_sparse: sharded parameter servers, top-k and row-sparse commits
    (``ps_shards``, ``wire_dtype="topk"``, ``row_sparse``): phase
    host_ps's ConvNet under ADAG, one worker, serial, at 1 and 3 shards
    equal to the bit; 2 threads with overlap at 1 and 4 shards
    (examples/s, one ``'u'`` a window a shard, each shard's receive pool
    1 miss and a hit a commit, accuracy >= 0.9); top-k at density 0.01
    with f32, bf16 and int8 values and once at 3 shards (bytes a commit
    <= 5% of dense, the loss falls, accuracy within 0.05 of dense), one
    device selection held against the window's own dense delta; the LM
    at full width under DOWNPOUR, row-sparse against dense and at 3
    shards against 1, equal to the bit, each run launching the sm90
    forward, dq and dk/dv once per layer and step and nothing else; the
    (20000, 32) embedding model of ``bench.py:365-397``, its row-sparse
    commits <= 5% of its dense ones.
25. resilience: survivable parameter servers, elastic workers and fault
    tolerance (``recovery``, ``elastic``, ``fault_tolerance``,
    ``fault_injection``): phase host_ps's ConvNet for 2 epochs under ADAG,
    one worker with ``recovery=True`` at one shard equal to the bit to
    the run without it; 2 overlapped threads at 3 shards under recovery,
    as is and with shard 1 crash-killed at clock 5 (one respawn at
    generation 1, every worker resumed, at most 4 updates dropped,
    accuracy >= 0.9; examples/s and respawn_ms); 4 workers static and
    elastic (examples/s side by side), elastic with an ``'exit'`` and a
    ``'raise'`` death (2 respawns, every lease once, accuracy >= 0.9) and
    with a ``'hang'`` (a lease stolen, the wedged thread released);
    ``fault_tolerance`` with one death (``failed_workers == [1]``); the LM
    at full width under DOWNPOUR, 2 elastic workers over 2 recovering
    shards, one death: one respawn, the loss falls, the sm90 forward, dq
    and dk/dv each launched once per layer, step and window that ran and
    nothing else; no run logs the wait's "short of" warning.
26. process_ps: the same workers as OS processes (``execution=
    "process_ps"``): one process equal to the bit to one host_ps thread,
    the ConvNet epoch at 1, 2 and 4 processes beside the threads,
    degraded completion, the supervised engine over shard processes under
    faults fired at states of the run, the LM from two elastic worker
    processes (their sm90 launches read from their result files), and two
    processes building one kernel under one ``nvcc``.
27. online: streaming online training, hot weight reload and the online
    deployment (``stream=True``, ``attach_ps``, ``OnlineDeployment``):
    the LM at full width streams under DOWNPOUR from 2 threads over a
    drifting token stream, one worker exiting (every horizon's ledger
    complete, every row read trained), while a bf16 engine attached to
    the live PS serves phase serve's trace with a pull every decode step
    (reloads, no failure, generations never decreasing, every tensor at
    its address; pull ms and decode p50 with and without reloads; pulled
    bf16 and int8 engines equal to fresh ones over the center, token for
    token); an ``OnlineDeployment`` of the same shapes, supervised, with a
    blue/green swap and an engine kill (every request on one generation,
    none lost, freshness populated and mirrored, the kill's
    ``recovery_ms``); the sm90 training kernels launched once per layer,
    step and window of the stream runs and nothing else; then
    accuracy-tracks-drift on the reference bench's small configuration.
28. moe: ``ParallelTransformerLM`` with Switch experts and across ranks
    (``moe_layers``, ``parallel/moe.py``, ``parallel/collective.py``):
    phase parallel_train's LM (bf16, fused CE, Ulysses, batch 8 x 2048)
    with 8 experts on every other layer, top-1 and top-2, 8 Adam steps
    each (the loss falls, fractions sum to 1, the dropped share, ms a
    step, tokens/s, peak memory; B1/B2 once a step, B3-B5 once a layer
    and step); one MoE layer at f32 at that shape, the index dispatch
    against the one-hot einsums on the card and against the CPU; two
    ranks on the one card over gloo, a coordinated ``Job`` through
    ``initialize_from_env`` on mesh (1, 1, 2), full width at f32 on 2
    layers, against one rank in this process (losses, gathered parameters),
    with their start seconds, ms a step and collective bytes and seconds.
29. pipeline: ``PipelineTransformerLM`` (GPipe and 1F1B) on one rank at
    the parallel LM's widths, on two stages across ranks against one
    rank, and ZeRO-1/FSDP on two data ranks against the plain step (the
    PP_* comment).
30. spmd_ranks: the SPMD engine, ``ModelPredictor(mesh=)`` and the dry
    run across ranks on the one card over gloo (the SPMD_* comment): the
    north-star configuration under ADAG and DynSGD on two ranks equal to
    the one-process two-worker engine to the bit, the LM's rows through
    the predictor's mesh route equal to the one-device predict to the bit
    (the sm90 inference forward once a layer on each rank), and
    ``dryrun_multichip(4)``.
31. native: the port's host C++ extensions (the NATIVE_* comment): each
    built from the checkout's sources, the wire codec, the PS apply and
    ``read_csv``'s parser native against their pure-Python or numpy twins
    (the same bytes, the same bits), and one-worker host-PS runs of the
    ConvNet and the LM with both, their centers to the bit.
32. loadgen: the port's load generator (``distkeras_tpu_torch.examples.
    loadgen``, the LOADGEN_* comment): its ``main`` at the JAX script's
    defaults and with a random draft, every JSON line parsed and the
    closed loop lossless with no kernel launched; ``build_spec_engine``'s
    trained pair, the SIMT training kernels launched exactly once a
    layer and step of each model's training; and its closed, wire and
    open-loop load loops over phase serve's full-width engine: lossless,
    the greedy rows those of direct submit, a flood shed with typed
    refusals and counted.

Then it prints the north-star line again, the whole run's wall time, the
kernel summary line (each variant of each flash kernel with its source
and the runs it served, the SIMT kernels at the wide head dim, and every
kernel's launches on the packing, decode, serving, paged, speculative,
QoS, disaggregated serving, fleet, host-PS, sparse host-PS, survivable
host-PS, cross-process, online, MoE, pipeline, SPMD-ranks, native and
load-generator paths), the
``nvidia-smi`` name and power limit line, and last ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
# the serving slice: scripts/bench_kernels.py's transformer_lm widths
LM = dict(vocab_size=512, seq_len=2048, d_model=256, num_heads=8,
          num_kv_heads=2, num_layers=4, mlp_dim=1024,
          compute_dtype="bfloat16")
FORMS = {"full": dict(),
         "rolling_window": dict(positional="rope", attention_window=256)}
ROWS, BATCH = 16, 8
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s, and
# flop/s by input type: bf16 on the tensor cores, f32 on the CUDA cores,
# and the TF32 tensor cores, which take f32 products split into passes
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_UNIT = {"bfloat16": "tensor_core", "float16": "tensor_core",
             "float32": "cuda_core"}
TF32_FLOPS = 495e12
# the flash kernels' work per live (q, k) pair: products of 2 * D flops of
# two input operands (s = q.k^T, dp = dO.v^T) and of an f32 p or ds with an
# input operand (p.v, ds.k, p^T.dO, ds^T.q), and exponentials.  "bwd" is
# the backward's least work, "bwd_schedule" what the dq + dk/dv pair does
# (s and dp in both)
FLASH_WORK = {"fwd": (1, 1, 1), "dq": (2, 1, 1), "dkv": (2, 2, 1),
              "bwd": (2, 3, 2), "bwd_schedule": (4, 3, 3)}
# TF32 passes of those two kinds of product, each f32 operand split into
# hi + lo (a.b = lo.hi + hi.lo + hi.hi): two f32 operands 3; bf16 and f16
# are exact in TF32, so two 16-bit operands 1, an f32 p or ds with one 2
TF32_PASSES = {"float32": (3, 3), "bfloat16": (1, 2), "float16": (1, 2)}
# the flash kernels' third term: one exponential per live (q, k) pair on
# the MUFU units, 16 ex2 per clock per SM; phase_device sets the rate from
# the card's SM count and the SM clock that nvidia-smi reports as its
# maximum (clocks.max.sm)
EX2_PER_CLOCK_PER_SM = 16
EXP_PER_S = None
# kernel vs plain version, per element: |kernel - plain| <= rel * |plain| +
# abs.  Both compute in f32 and differ only in the order of f32 sums (abs
# 2e-5 on unit-normal inputs); in bf16 and f16 each then rounds once to
# the output dtype, so they may differ by one ulp of it, at most 2**-7
# (bf16) or 2**-10 (f16) of the value, plus the f32 noise.
KERNEL_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-5),
              "float16": (2.0 ** -10, 1e-5)}
# full-width slice, kernel route vs plain route (logits ~unit scale).  At
# f32 the two routes compute the same function and differ only in the
# order of f32 sums.  At bf16 the plain route rounds probabilities to bf16
# before P.V (the JAX XLA path's rule) where the kernel keeps them f32, and
# each route's bf16 rounding moves logits by up to ~0.05 against an f32
# model of the same weights (chip runs on this model), so at bf16 the
# argmax is compared where the plain route's top-2 margin exceeds twice
# that; the agreement over all positions is printed beside it.
LOGIT_TOL = {"bfloat16": 0.1, "float32": 1e-3}
ARGMAX_MARGIN = {"bfloat16": 0.1, "float32": 0.0}
ARGMAX_MIN = 0.99
# the raw bf16 agreement over all positions read 98.8-99.1% in probe runs
# (the plain bf16 route against an f32 model: 98.5-99.1%); a kernel that
# flipped near-ties more often than bf16 rounding does would fall below
ARGMAX_ALL_MIN = {"bfloat16": 0.98, "float32": 0.99}
# the main path: the slice's form and dtype
MAIN_PATH = ("full", "bfloat16")
# the training kernels vs their plain versions, per element: |kernel -
# plain| <= ulp * |plain| + 1e-4 * max|plain|.  Both compute in f32; the
# backward's sums run S long with cancellation in dp - Delta, so the f32
# term is relative to the tensor's largest value; bf16 and f16 outputs
# may then round one ulp apart (2**-7 and 2**-10 of the value).
TRAIN_TOL_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7,
                 "float16": 2.0 ** -10}
TRAIN_TOL_F32 = 1e-4
# the training slice: the x+1 next-token task of tests/test_attention.py
# at full width, SingleTrainer with adam 3e-3, 64 rows in batches of 8,
# 2 epochs (16 steps), from the same numpy-seeded weights on both routes
TRAIN_ROWS, TRAIN_EPOCHS = 64, 2
TRAINER = dict(loss="sparse_categorical_crossentropy_from_logits",
               worker_optimizer="adam", learning_rate=3e-3,
               batch_size=BATCH, num_epoch=TRAIN_EPOCHS)
# kernel route vs plain route.  f32: first-step gradients per parameter
# tensor, |g_kernel - g_plain| <= GRAD_RTOL * max|g_plain| over the tensor
# + GRAD_ATOL * the largest |g_plain| of any tensor (the second term
# covers tensors whose true gradient is 0, e.g. a key bias without RoPE,
# where both routes hold only f32 rounding), and the loss traces to
# LOSS_RTOL_F32 (relative).  The routes differ only in the order of f32
# sums: probe runs on the H100 read gradient differences of ~1e-6 of
# each tensor's max and loss traces within 8e-6.  bf16: the plain route
# rounds probabilities to bf16 before P.V (the JAX XLA path's rule) where
# the kernels keep f32, so the traces drift apart over 16 steps; probe
# runs read 8.9e-4 (full) and 3.1e-3 (rolling_window), and the band is
# LOSS_BAND_BF16.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL_F32 = 1e-4
LOSS_BAND_BF16 = 0.02
# the last loss of the 16 steps below this share of the first (probe
# runs: 0.22 full, 0.056 rolling_window, on both routes and dtypes)
LOSS_DROP = 0.5
# the fused cross-entropy kernels vs their plain versions, per element:
# loss and lse within CE_TOL_REL * |plain| + CE_TOL_ABS (the JAX test's
# rtol/atol, tests/test_fused_ce.py:36-38: both sum in f32, in other
# orders); dlogits within one ulp of the dtype (0 at f32) * |plain| +
# CE_GRAD_F32 * max|plain| (both compute in f32 and round once)
CE_TOL_REL, CE_TOL_ABS = 1e-5, 1e-5
CE_GRAD_F32 = 1e-6
# f32 operations per logit (max, subtract, exp, add in the forward; the
# backward's subtract, exp, compare, subtract, multiply) against the f32
# CUDA-core peak, for the bound beside the bytes
CE_OPS = {"fwd": 4, "bwd": 5}
# the parallel-LM slice: scripts/bench_transformer.py:101-104, the JAX
# package's single-chip ParallelTransformerLM configuration, at batch 8 x
# seq 2048 (the first cell of its sweep, :96-99, that reaches seq 2048),
# optax.adam(1e-3), random tokens, labels (tokens + 1) % V
PLM = dict(vocab_size=32768, seq_len=2048, d_model=512, num_heads=8,
           num_layers=8, mlp_dim=2048, positional="rope")
PLM_BATCH, PLM_STEPS, PLM_LR = 8, 8, 1e-3
PLM_ROUTES = {"fused_ring": dict(fused_ce=True),
              "plain_ring": dict(fused_ce=False),
              "fused_ulysses": dict(fused_ce=True, sp_impl="ulysses")}
# the flash kernels' shape on the Ulysses route: name, B, S, H, Hkv, D,
# causal, window
PLM_ULYSSES_CASE = ("plm_ulysses", PLM_BATCH, PLM["seq_len"],
                    PLM["num_heads"], PLM["num_heads"],
                    PLM["d_model"] // PLM["num_heads"], True, None)
# the f32 routes at cut depth: fused vs plain CE against the JAX
# package's own rtol for fused vs XLA CE (tests/test_fused_ce.py:116);
# Ulysses vs ring (flash kernels vs the ring's own f32 online softmax)
# by the training slice's rule for kernel vs plain attention at f32,
# LOSS_RTOL_F32 and GRAD_RTOL/GRAD_ATOL
PLM_F32_LAYERS = 2
PLM_LOSS_RTOL_F32 = 1e-5
# bf16 loss traces over the 8 steps, relative; the traces are the same
# to the last bit from one chip run to the next.  The fused and plain CE
# routes read the same f32 logits and their gradients differ only in f32
# rounding, but the backward then rounds through bf16 activations and 8
# Adam steps carry the odd flipped ulp forward: chip runs read 1.3e-4,
# and the band is PLM_CE_BAND_BF16.  The Ulysses route attends through
# the flash kernels where the ring runs its own f32 online softmax, each
# rounding its output to bf16 at other points: chip runs read 4.2e-3,
# against PLM_SCHEDULE_BAND_BF16.  These bands catch a gross fault only;
# the flash kernels are held per element at the route's shape (phases 2
# and 5) and the schedules' f32 gradients against each other.
PLM_CE_BAND_BF16 = 1e-3
PLM_SCHEDULE_BAND_BF16 = 0.01
# the cases at which phases kernel and kernel_train also time the SIMT
# kernels (the forward; the backward pair in kernel_train) on bf16 inputs,
# beside the sm90 kernels that serve them: the serving and training
# slices' shape, and the Ulysses route's
SIMT_TIMED = ("causal", PLM_ULYSSES_CASE[0])
# the SDPA backends under which phase kernel_train times the yardstick
# backward (those that refuse a case are left out of it)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
# phase kernel_train's cases (phase kernel's shapes): name, B, S, H, Hkv, D,
# causal, window
KERNEL_TRAIN_CASES = (
    ("causal", 8, 2048, 8, 2, 32, True, None),
    ("window256", 8, 2048, 8, 2, 32, True, 256),
    ("noncausal", 8, 2048, 8, 2, 32, False, None),
    ("d64", 8, 1024, 8, 2, 64, True, None),
    ("d128", 8, 1024, 8, 2, 128, True, None),
    ("ragged200", 8, 200, 8, 2, 32, True, None),
    # head dims the kernels pad (16 -> 32; 200 -> 256 in the SIMT forward)
    # or take in chunks (200: two of the SIMT backward's 128 columns)
    ("d16", 8, 1024, 8, 2, 16, True, None),
    ("d200", 2, 1000, 8, 2, 200, True, None),
    PLM_ULYSSES_CASE,
)
# a 16-bit head dim that is not a multiple of 8: the SIMT forward serves it
# (rows off a 16-byte boundary, staged by plain loads), in phase kernel
# beside the sm90 cases.  name, B, S, H, Hkv, D, causal, window
ODD_CASE = ("d36", 2, 1000, 8, 2, 36, True, None)
# a head dim above 256 (the reference's kernel takes any): the SIMT forward
# and backward take it in ceil(320 / 128) = 3 chunks of 128 columns.  name,
# B, S, H, Hkv, D, causal, window
WIDE_CASE = ("d320", 2, 1024, 4, 2, 320, True, None)
# strided and misaligned views at the public entry points: q, k, v as
# chunks of one (B, S, 3H, D) projection at the serving slice's widths
# (MHA: a chunk of three equal parts), q, k, v each a contiguous view one
# element off a 16-byte boundary, and (T, V) logits that are the transpose
# of a (V, T) tensor.  name, B, S, H, Hkv, D (attention); name, T, V (CE)
VIEW_QKV_CASE = ("qkv_chunk", BATCH, LM["seq_len"], LM["num_heads"],
                 LM["num_heads"], LM["d_model"] // LM["num_heads"])
VIEW_MISALIGNED_CASE = ("misaligned", 2, 1024, 8, 2, 32)
VIEW_CE_CASE = ("transposed_logits", 4096, 32768)
# the ConvNet slice: the MNIST flow of the verify recipe (MinMax → OneHot
# → SingleTrainer → ModelPredictor → LabelIndex → Accuracy) at the
# north-star configuration's full size: mnist_convnet in bf16, the 60000
# rows and 10000 test rows of MNIST (load_mnist's synthetic stand-in
# where no mnist.npz is found), batch 512 (bench.py's on-chip batch,
# bench.py:1109-1110), adam 1e-3, 2 epochs.  Pass mark: the recipe's 0.8
ZOO_ROWS, ZOO_TEST_ROWS, ZOO_BATCH, ZOO_EPOCHS = 60000, 10000, 512, 2
ZOO_TRAINER = dict(batch_size=ZOO_BATCH, worker_optimizer="adam",
                   learning_rate=1e-3, label_col="label_encoded",
                   loss="categorical_crossentropy")
ZOO_ACCURACY_MIN = 0.8
# bf16 vs f32 from the same weights on the first batch of 512: the loss
# relative and each parameter's gradient against its largest f32 value.
# The bf16 model rounds every conv and Dense operand and runs the conv
# backward in bf16 (the JAX _conv_f32_acc contract); the same computation
# on the CPU read a loss gap of 1.3e-4 to 7.0e-4 and gradient gaps of 0.4%
# to 3.1% of each tensor's largest value over three weight seeds
ZOO_BF16_LOSS_BAND, ZOO_BF16_GRAD_BAND = 5e-3, 0.1
# the other zoo models: one epoch on this many synthetic rows, batch 128
ZOO_SMALL_ROWS, ZOO_SMALL_BATCH = 4096, 128
# the north-star workload (bench.py:1109-1170): SPMDEngine over
# mnist_convnet in bf16, "categorical_crossentropy", adam, algorithm adag,
# communication_window 12, batch 512, the 60000 MNIST rows scaled by 1/255
# with one-hot labels, one worker per card (get_mesh()); the epoch lives
# on the card, one warm-up epoch, then ADAG_EPOCHS timed epochs with one
# host sync at the end
ADAG_ROWS, ADAG_BATCH, ADAG_WINDOW, ADAG_EPOCHS = 60000, 512, 12, 5
# the verify recipe (.claude/skills/verify/SKILL.md) through the trainer:
# ADAG on mnist_convnet in f32, 8 workers on the one card, batch 32,
# window 4, 6 epochs, adam 1e-3, on 4096 synthetic rows; accuracy on 256
# test rows at least the recipe's 0.8
RECIPE = dict(num_workers=8, batch_size=32, num_epoch=6,
              communication_window=4, label_col="label_encoded",
              worker_optimizer="adam", learning_rate=1e-3)
RECIPE_ROWS, RECIPE_TEST_ROWS = 4096, 256
# every other algorithm: 4 workers on the card, mnist_mlp in bf16, 2
# epochs on 4096 rows at batch 64, window 4 (1 for the 'local' trainers).
# The commits that add the workers' deltas (DOWNPOUR: the sum, DynSGD:
# 1 + 1/2 + 1/3 + 1/4 of one) take SGD, as the JAX package's tests run
# them (tests/test_trainers.py:52-58): four summed Adam windows step ~4x
# Adam's rate and the MLP's loss rose on the card (DOWNPOUR at adam 1e-3:
# 5.08 -> 12.3) and on the CPU (DynSGD: 1.54 -> 2.02)
ALGO_ROWS, ALGO_WORKERS, ALGO_EPOCHS = 4096, 4, 2
ALGO_RUNS = {
    "DOWNPOUR": dict(communication_window=4, worker_optimizer="sgd",
                     learning_rate=0.02),
    "DynSGD": dict(communication_window=4, worker_optimizer="sgd",
                   learning_rate=0.05),
    "AEASGD": dict(communication_window=4, worker_optimizer="sgd",
                   learning_rate=0.05, rho=1.0),
    "EAMSGD": dict(communication_window=4, learning_rate=0.02, rho=1.0,
                   momentum=0.9),
    "AveragingTrainer": dict(worker_optimizer="adam", learning_rate=1e-3),
    "EnsembleTrainer": dict(worker_optimizer="adam", learning_rate=1e-3),
}
# card against CPU: one f32 ADAG epoch (4 workers, mnist_mlp, batch 32,
# window 4, adam 1e-3, 2048 rows: 4 rounds) from one numpy weight set on
# the card and through the port on the CPU.  Both compute in f32 (TF32 is
# off) and differ only in the order of f32 sums: an H100 run read round
# losses 9.2e-8 apart (relative) and center tensors up to 1.9e-5 of their
# largest value (Adam's steps on near-zero gradients carry the rounding);
# the bands are about ten times those
CARD_CPU_ROWS = 2048
CARD_CPU_LOSS_BAND, CARD_CPU_PARAM_BAND = 1e-6, 2e-4
# the packing slice (ROADMAP A5c): documents of phase train's x+1 task
# (a run of consecutive token ids mod the vocab from a random start), their
# lengths drawn from the seed in PACK_DOC_LEN tokens, packed by
# pack_documents into rows of the LM's seq 2048; the first PACK_ROWS rows
# train.  RoPE, since packing refuses a learned position table
PACK_LM = dict(LM, positional="rope")
PACK_DOC_LEN, PACK_DOCS, PACK_ROWS = (32, 1024), 320, 64
PACK_LOSS = "sparse_categorical_crossentropy_masked_from_logits"
# isolation: on a PACK_ISO_LAYERS-layer copy at full width, the packed
# forward's logits (plain path) over each document of the first row
# against that document's own forward (the kernel route): at f32 both
# compute the same function in other orders of f32 sums (the kernel
# against the plain version reads ~6e-6 in phase slice); at bf16 the
# plain route rounds probabilities to bf16 where the kernel keeps f32,
# the band of phase slice's LOGIT_TOL
PACK_ISO_LAYERS = 2
PACK_ISO_TOL = {"float32": 1e-4, "bfloat16": LOGIT_TOL["bfloat16"]}
# packed ADAG on the SPMD engine: 2 workers, window 4, batch 4: the 64
# rows are exactly 2 rounds
PACK_ADAG_WORKERS, PACK_ADAG_WINDOW, PACK_ADAG_BATCH = 2, 4, 4
# the decode slice (ROADMAP A4, its dense-cache layer): the four
# configurations of scripts/bench_kernels.py:116-156 (the LM at bf16, batch
# 8, 256 greedy decode_steps through jit_decode_step; the full cache of
# seq 2048 from position 0, the rolling ring of the window 256 at position
# 2047, as that script times them; *_int8 after FittedModel.quantize()),
# one warm-up run, then DECODE_REPS timed runs, their median kept
DECODE_CONFIGS = {
    "full": (dict(), False, False),
    "full_int8": (dict(), False, True),
    "rolling_window": (dict(attention_window=256, positional="rope"), True,
                       False),
    "rolling_window_int8": (dict(attention_window=256, positional="rope"),
                            True, True)}
# (one timed run keeps the whole script under half its time limit)
DECODE_BATCH, DECODE_STEPS, DECODE_REPS = 8, 256, 1
# the untimed warm-up before each configuration's timed run (its first
# steps allocate the caches' blocks and pick the GEMMs; 32 steps keep the
# whole script under half its time limit)
DECODE_WARMUP_STEPS = 32
# the decode checks, at f32 on 2 rows: the cached steps' logits against
# the plain full forward's over a 1024-token prompt and DECODE_FORCED
# teacher-forced steps (both compute the same function in other orders of
# f32 sums: tests/test_decode.py holds 2e-5 at its CPU sizes; the card's
# GEMMs of 2 rows and of 2048 sum in other orders, so 1e-4 on logits of
# ~unit scale), and generate on the card against generate on the CPU
# (1024 + 256 tokens, both forms); beam search and speculative decoding on
# a 256-token prompt for 64 steps; beam scores against the full forward's
# summed log-probabilities (64 terms, each to ~1e-6)
DECODE_ROWS, DECODE_PROMPT, DECODE_CONT, DECODE_FORCED = 2, 1024, 256, 64
DECODE_LOGIT_TOL_F32 = 1e-4
BEAM_PROMPT, BEAM_STEPS, BEAM_WIDTH, BEAM_SCORE_TOL = 256, 64, 4, 1e-3
SPEC_DRAFT_LAYERS, SPEC_DRAFT_LEN = 1, 4
# the serving slice (ROADMAP queue A item 4, the engine core): the
# ServingEngine over the LM at full width (bf16) in both forms, SERVE_SLOTS
# slots, max_len the LM's seq, chunks of SERVE_CHUNK prompt tokens; the
# traffic is a seeded trace made like examples/loadgen.py:48 make_trace:
# SERVE_REQUESTS requests, prompt lengths drawn from SERVE_PROMPT_LENS (the
# 1024-token prompts take the chunked path), SERVE_STEPS new tokens each,
# every other request sampled at SERVE_TEMP with a seed of its own, cycling
# through no filter, top-k, top-p and both.  The checks run on a
# SERVE_CHECK_LAYERS-layer f32 copy (TF32 off): a lone greedy and a lone
# sampled request against generate in both prefill modes, the whole trace
# through the graph engine against the eager engine, and the greedy requests
# on the card against the same engine on the CPU.  SERVE_PROFILE_STEPS
# decode-only iterations of 8 running requests are traced for the host calls
# a step, and SERVE_EVENT_STEPS back-to-back steps timed with CUDA events
SERVE_FORMS = {"full": (dict(), False),
               "rolling_window": (dict(attention_window=256,
                                       positional="rope"), True)}
# the forms whose bf16 engines run the trace in phases serve and paged: the
# full form (depth cut from both forms, PERF.md section 4; the other form's
# weights are still drawn, so the f32 checks, which take both forms, see
# the same numbers)
SERVE_BF16_FORMS = ("full",)
SERVE_SLOTS, SERVE_CHUNK = 8, 128
# (16 requests keep the whole script under half its time limit; their
# prompts take all four lengths)
SERVE_REQUESTS, SERVE_STEPS = 16, 128
SERVE_PROMPT_LENS = (16, 64, 256, 1024)
SERVE_TEMP, SERVE_TOPK, SERVE_TOPP = 0.7, 40, 0.9
SERVE_CHECK_LAYERS = 2
SERVE_PROFILE_STEPS, SERVE_EVENT_STEPS = 8, 64
# the paged pool (ROADMAP queue A item 4, its block arena and prefix trie):
# phase serve's engine and trace with paged=True, PAGED_BLOCK-token blocks
# and the default kv_blocks (the dense pool's capacity), graph and
# uncaptured; then the shared-prefix trace of bench.py:741-790, drawn by
# the port's loadgen make_trace as examples/loadgen.py draws it:
# PREFIX_REQUESTS requests over one PREFIX_LEN-token prefix, each
# with its own suffix of PREFIX_SUFFIXES tokens and PREFIX_STEPS new
# token, through a paged and a dense engine of PREFIX_SLOTS slots,
# max_len PREFIX_MAX_LEN, chunks of PREFIX_CHUNK and PREFIX_PER_STEP
# prefills an iteration, the prefix warmed once, PREFIX_USERS users in a
# closed loop.  The prefix's PREFIX_LEN // PAGED_BLOCK full blocks serve
# every request after the warm one: at least PREFIX_HIT_MIN hit tokens.
# The f32 checks run on SERVE_CHECK_LAYERS layers; the tight arena holds
# PAGED_TIGHT slots' worth of blocks
PAGED_BLOCK = 16
PAGED_POOL_STATS = ("blocks_allocated", "blocks_reused", "blocks_evicted",
                    "prefix_hits", "prefix_hit_tokens", "cow_copies")
PREFIX_REQUESTS, PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_STEPS = 16, 240, \
    (4, 6, 8), 1
PREFIX_SLOTS, PREFIX_MAX_LEN, PREFIX_CHUNK, PREFIX_PER_STEP = 8, 256, 16, 4
PREFIX_USERS = 8
PREFIX_HIT_MIN = 224 * 15
PAGED_TIGHT = 2
# speculation and quantization in the engine (ROADMAP queue A item 4): phase
# serve's engine and trace (bf16, full width, the forms of SPEC_FORMS, 8
# slots, chunks of 128) with spec_len SPEC_DRAFT_LEN, drafted by the target itself and
# by a SPEC_DRAFT_LAYERS-layer draft of the same widths; the target and
# that draft are first trained on the card on phase train's x+1 task
# (SPEC_TRAIN_ROWS rows of seq 2048, batch 8, SPEC_TRAIN_EPOCHS epochs,
# adam 3e-3), examples/loadgen.py:698-740 build_spec_engine at full
# width.  Besides phase serve's trace, an x+1 "arith" greedy trace
# (examples/loadgen.py:75-77: each prompt a seeded-start x+1 run) of
# SERVE_REQUESTS requests, SERVE_PROMPT_LENS prompts and SERVE_STEPS new
# tokens reads the accept rate.  Graph = uncaptured at bf16 over the
# trace's first SPEC_UNCAPTURED requests (dense self-drafted, paged with
# the trained draft: the uncaptured round is host-bound, 44-116 ms a
# round on the H100).  The f32 checks run on
# SERVE_CHECK_LAYERS layers (TF32 off) over the first SPEC_CHECK_REQUESTS
# greedy requests of the trace cut to SPEC_CHECK_STEPS new tokens, the
# random draft SPEC_DRAFT_LAYERS layers of random weights
SPEC_TRAIN_ROWS, SPEC_TRAIN_EPOCHS = 64, 6
SPEC_UNCAPTURED = 8
SPEC_CHECK_REQUESTS, SPEC_CHECK_STEPS = 3, 32  # depth cut, PERF.md §4
# the forms whose speculative rounds are profiled (host calls and busy
# time a round): the full form (depth cut from both forms, PERF.md §4)
SPEC_PROFILE_FORMS = ("full",)
# the forms whose bf16 engines run the trace and the arith trace: the full
# form (depth cut from both forms, PERF.md §4; the f32 checks still take
# both)
SPEC_FORMS = ("full",)
# multi-tenant QoS and preemption in the engine (ROADMAP queue A item 4):
# the LM at full width, bf16, form full (a rolling pool cannot preempt),
# paged with PAGED_BLOCK-token blocks, SERVE_SLOTS slots, chunks of
# SERVE_CHUNK, max_len its seq, queue capacity QOS_QUEUE; the tenants of
# examples/loadgen.py:138-155 qos_policies(3): "interactive" (interactive
# tier, weight QOS_INTERACTIVE_WEIGHT), "batch0" and "batch1" (batch tier,
# weight 1).  (a) phase serve's first QOS_PREEMPTED requests, all of
# tenant batch0, request i preempted once when it has emitted
# QOS_DEPTH0 + i * QOS_DEPTH_STEP tokens, against the same requests
# unpreempted, and (a') the same requests starved: once each has emitted
# QOS_DEPTH0 tokens, QOS_STARVE interactive requests (each the first
# QOS_STARVE_PROMPT tokens of one of their prompts, QOS_STARVE_STEPS
# greedy tokens) arrive at the full slots, and the scheduler picks its
# own victims; (b) an overload trace made as examples/loadgen.py:48
# make_trace(tenants=3, tier_mix=QOS_TIER_MIX) makes it (QOS_REQUESTS
# requests, phase serve's prompt lengths and new tokens, half sampled),
# offered open loop at QOS_QPS requests/s (bench.py:911) to an engine of
# QOS_KV_BLOCKS blocks (a request reserves ~29 on average: slots and
# blocks both starve), with the policies and with none (plain FIFO); the
# f32 checks on SERVE_CHECK_LAYERS layers (TF32 off)
QOS_TENANTS, QOS_INTERACTIVE_WEIGHT, QOS_QUEUE = 3, 4.0, 64
QOS_PREEMPTED, QOS_DEPTH0, QOS_DEPTH_STEP = 8, 8, 15
QOS_STARVE, QOS_STARVE_PROMPT, QOS_STARVE_STEPS = 4, 16, 32
QOS_REQUESTS, QOS_QPS, QOS_TIER_MIX, QOS_KV_BLOCKS = 32, 200.0, 0.3, 160
QOS_TIMEOUT_S = 300.0
# disaggregated prefill/decode and the wire front-end (ROADMAP queue A item
# 4): the LM at full width, bf16, form full (roles refuse rolling pools),
# paged with PAGED_BLOCK-token blocks, SERVE_SLOTS slots an engine, chunks
# of SERVE_CHUNK, max_len its seq; one prefill-role and one decode-role
# engine on the card (examples/loadgen.py:607-615 build_engine(
# disaggregate=True, prefill_engines=1)).  (a) phase serve's trace through
# the unified paged engine, an in-process DisaggPair and a pair whose decode
# engine is behind a ServingServer (event core) on 127.0.0.1; (b) the
# interference trace of bench.py:866-893 at full width: make_trace's
# bimodal pattern over DISAGG_PROMPT_LENS, DISAGG_LONG_FRACTION long,
# DISAGG_REQUESTS requests of SERVE_STEPS new tokens (the long ones a
# quarter), greedy, through the unified engine and the in-process pair; (c)
# phase serve's first DISAGG_WIRE_REQUESTS requests from a ServingClient
# against a ServingServer over a unified paged engine, once per core;
# DISAGG_WIRE_REPS timed 'k' round trips of the largest block set; the f32
# checks on SERVE_CHECK_LAYERS layers (TF32 off)
DISAGG_PROMPT_LENS, DISAGG_LONG_FRACTION, DISAGG_REQUESTS = (16, 1024), \
    0.3, 32
DISAGG_WIRE_REQUESTS, DISAGG_WIRE_REPS = 8, 3
# the serving router and the supervisors (ROADMAP queue A item 4): the LM
# at full width, bf16, paged with PAGED_BLOCK-token blocks, form full,
# SERVE_SLOTS slots a replica, chunks of SERVE_CHUNK, max_len its seq; N
# in-process unified replicas of one model on the card, built by the
# phase's own engine factory (examples/loadgen.py:620 build_fleet at full
# width).  (a) phase serve's trace through a 1-replica router and a
# 2-replica "prefix" router, every row equal to the single paged engine's;
# (b) bench.py:951-968: "least-loaded", N in FLEET_SIZES, a closed loop at
# concurrency FLEET_USERS_PER_REPLICA * N over phase serve's trace:
# serving_fleet_tokens_per_sec; (c) bench.py:970-986: phase paged's
# shared-prefix trace (the prefix warmed once, PREFIX_USERS users) through
# 2 replicas under "prefix" and "random" (router seed 0):
# serving_fleet_prefix_hit_rate; (d) bench.py:988-1003: 2 replicas,
# "least-loaded", phase serve's first FLEET_FAILOVER_REQUESTS requests,
# replica 0 declared dead once every request on it has streamed a token:
# serving_fleet_failover_lost_requests; (e) a FleetSupervisor
# (FLEET_HEARTBEAT_S, FLEET_LIVENESS_S) restarts a replica killed under
# the trace, a rolling_swap runs while phase serve's first
# FLEET_SWAP_REQUESTS requests stream, and an EngineSupervisor restarts a
# ServingServer's crashed engine under a retrying ServingClient
FLEET_SIZES, FLEET_USERS_PER_REPLICA = (1, 2, 4), 4
FLEET_FAILOVER_REQUESTS, FLEET_SWAP_REQUESTS = 12, 16
FLEET_HEARTBEAT_S, FLEET_LIVENESS_S = 0.05, 5.0
# the in-process host parameter server (ROADMAP queue A item 6, its first
# part): execution="host_ps", every worker a thread training its own copy
# of the model on the card against a socket PS on loopback that applies
# the commits on the host.  (1) the north-star ConvNet (mnist_convnet
# bf16, adam, phase adag's ADAG_ROWS rows, batch ADAG_BATCH, window
# ADAG_WINDOW) under ADAG with HOST_PS_WORKERS threads, one epoch with
# comm_overlap on and off (round trips a window as bench.py:140-170
# counts them: 1.0 and 2.0), accuracy on HOST_PS_TEST_ROWS held-out rows;
# (2) DOWNPOUR, DynSGD, AEASGD and EAMSGD (phase adag's ALGO_RUNS
# optimizers) for HOST_PS_ALGO_WINDOWS windows a worker, the PS clock
# against the workers' commits; (3) one worker, serial, twice (cuDNN's
# deterministic algorithms): bit-identical centers; the same run with
# wire_dtype bfloat16 and int8 (half and a quarter of the f32 delta
# bytes); (4) the LM (transformer_lm(**LM), bf16) under ADAG with
# HOST_PS_WORKERS threads on HOST_PS_LM_ROWS rows of phase train's x+1
# task, window HOST_PS_LM_WINDOW, batch BATCH, adam 3e-3: every layer of
# every step launches the sm90 forward, dq and dk/dv once; (5) the
# ConvNet's examples/s at HOST_PS_SCALING threads (printed only)
HOST_PS_WORKERS, HOST_PS_TEST_ROWS, HOST_PS_ALGO_WINDOWS = 2, 1024, 4
HOST_PS_LM_ROWS, HOST_PS_LM_WINDOW = 128, 2
HOST_PS_SCALING = (1, 2)  # depth cut from (1, 2, 4), PERF.md section 4
# sharded parameter servers, top-k and row-sparse commits (ROADMAP queue A
# item 6, its second part): (a) phase host_ps's ConvNet (bench.py:1109-
# 1121: mnist_convnet bf16, adam, batch ADAG_BATCH, window ADAG_WINDOW)
# under ADAG, one worker, serial, on HOST_PS_ALGO_WINDOWS windows at
# ps_shards PS_SPARSE_SERIAL_SHARDS (cuDNN deterministic): equal weights
# and histories; HOST_PS_WORKERS threads with overlap on ADAG_ROWS rows at
# 1 and PS_SPARSE_SHARDS shards: examples/s (bench.py:178's observable),
# one 'u' a window a shard, each shard's receive pool 1 miss and a hit a
# commit, held-out accuracy >= PS_SPARSE_ACC_MIN; (b) the same 2-thread
# run with wire_dtype="topk" at PS_SPARSE_TOPK, values f32, bf16 and int8,
# and f32 once at PS_SPARSE_TOPK_SHARDS shards: bytes a commit <= 5% of
# the dense commit, the loss falls, accuracy within PS_SPARSE_ACC_BAND of
# the dense run; one window's device selection against the window's own
# dense delta (identity within 1e-5 max|delta|, selected magnitudes over
# the residual's); (c) the LM (transformer_lm(**LM)) under DOWNPOUR, one
# worker, serial, on phase host_ps's HOST_PS_LM_ROWS rows of x+1, window
# HOST_PS_LM_WINDOW, batch BATCH: row_sparse True against None and True at
# PS_SPARSE_SERIAL_SHARDS shards, equal weights, each run launching the
# sm90 forward, dq and dk/dv layers x steps times and nothing else; then
# bench.py:365-397's embedding model (a PS_SPARSE_EMB table, Flatten,
# Dense(4)), f32, DOWNPOUR sgd, PS_SPARSE_EMB_ROWS rows in windows of
# PS_SPARSE_EMB_WINDOW x PS_SPARSE_EMB_BATCH (<= 1% of the rows touched a
# window): the row-sparse commit <= 5% of the dense one, which exceeds
# the table's f32 bytes
PS_SPARSE_SERIAL_SHARDS, PS_SPARSE_SHARDS = (1, 3), 4
PS_SPARSE_TOPK, PS_SPARSE_TOPK_SHARDS = 0.01, 3
PS_SPARSE_ACC_MIN, PS_SPARSE_ACC_BAND = 0.9, 0.05
PS_SPARSE_EMB, PS_SPARSE_EMB_ROWS = (20000, 32), 4096
PS_SPARSE_EMB_WINDOW, PS_SPARSE_EMB_BATCH = 2, 64
# survivable parameter servers, elastic workers and fault tolerance
# (ROADMAP queue A item 6, its third part), over phase host_ps's ConvNet
# (bench.py:1109-1121: mnist_convnet bf16, adam, batch ADAG_BATCH, window
# ADAG_WINDOW, ADAG_ROWS rows) for RESILIENCE_EPOCHS epochs (one epoch is
# only ~10 windows, too few for a fault budget), mirroring bench.py:516,
# :561 and :587.  (a) survivable PS: ADAG, one worker, serial, on
# HOST_PS_ALGO_WINDOWS windows, recovery=True at ps_shards 1 against
# recovery=False (cuDNN deterministic): equal weights and histories (the
# one-shard plan is the identity); then HOST_PS_WORKERS threads with
# overlap at RESILIENCE_SHARDS shards under recovery, once as is and once
# with shard RESILIENCE_KILL_SHARD crash-killed when its clock reaches
# RESILIENCE_KILL_CLOCK: one respawn at generation 1, every worker
# resumed, at most RESILIENCE_DROPPED_MAX updates dropped, held-out
# accuracy >= RESILIENCE_ACC_MIN, examples/s and respawn_ms printed; (b)
# elastic workers: ADAG with RESILIENCE_ELASTIC_WORKERS workers, static
# and elastic=True without a fault (examples/s side by side), then with
# RESILIENCE_ELASTIC_FAULTS (two respawns, every lease once, the rows
# summing to ADAG_ROWS, accuracy >= RESILIENCE_ACC_MIN), then with
# RESILIENCE_HANG_FAULTS at lease_timeout RESILIENCE_LEASE_TIMEOUT (a
# lease stolen, the epochs complete, the wedged thread released at
# shutdown; healthy workers declared wedged as well are printed); (c) fault_tolerance without leases: ADAG, 4 threads,
# RESILIENCE_FT_FAULTS: failed_workers == [1], accuracy >=
# RESILIENCE_ACC_MIN; (d) the LM (transformer_lm(**LM), bf16) on phase
# host_ps's HOST_PS_LM_ROWS rows, window HOST_PS_LM_WINDOW, batch BATCH,
# adam 3e-3, under DOWNPOUR with 2 workers, elastic, ps_shards 2,
# recovery, RESILIENCE_LM_FAULTS: one respawn, every lease once, the loss
# falls, and the sm90 forward, dq and dk/dv each launched layers x steps x
# the windows that ran (compile_windows' windows: the one that seeds the
# ledger and each worker's warm-up in its own thread; every history entry;
# the window whose commit the fault aborted), every other kernel never.
# No run may log the wait's "short of" warning.
RESILIENCE_EPOCHS, RESILIENCE_SHARDS = 2, 3
RESILIENCE_KILL_SHARD, RESILIENCE_KILL_CLOCK = 1, 5
RESILIENCE_DROPPED_MAX, RESILIENCE_ACC_MIN = 4, 0.9
RESILIENCE_ELASTIC_WORKERS = 4
RESILIENCE_ELASTIC_FAULTS = {1: ("exit", 1), 2: ("raise", 2)}
RESILIENCE_HANG_FAULTS, RESILIENCE_LEASE_TIMEOUT = {3: ("hang", 1)}, 1.0
RESILIENCE_FT_FAULTS = {1: 2}
RESILIENCE_LM_FAULTS = {1: ("raise", 2)}
# the cross-process parameter server (ROADMAP queue A item 6, its fourth
# part): execution="process_ps", every worker its own interpreter
# (python -m distkeras_tpu_torch.ps_worker_main) with its own CUDA context
# on the one card (no MPS: the contexts time-slice it), sharing only the
# socket with the driver; at phase host_ps's widths.  (a) the static
# engine: ADAG, one worker process, serial, on HOST_PS_ALGO_WINDOWS
# windows (cuDNN deterministic) against the same run on host_ps: equal
# weights and histories; then the ConvNet for one epoch at each of
# PROCESS_PS_SCALING worker processes (none now: PRs 20-21 hold the
# numbers of 1, 2 and 4), examples/s beside phase host_ps's threads
# (every child's loss falls, held-out accuracy >= RESILIENCE_ACC_MIN);
# fault_tolerance with PROCESS_PS_FT_FAULTS:
# failed_workers == [1].  (b) the supervised engine: DOWNPOUR (adam) with
# 2 worker processes for RESILIENCE_EPOCHS epochs, elastic, recovery,
# ps_shards 2 in shard processes of their own (ps_placement="process"),
# bf16 commits, freeze_deadline PROCESS_PS_FREEZE_S; faults fired at
# states of the run through networking.ProcessChaos: worker 1 SIGKILLed
# once a lease of epoch 0 has completed, shard 0 SIGKILLed once epoch 1
# has begun, then SIGSTOPped once a lease completed after its respawn and
# SIGCONTed once the supervisor's next probe has started; every epoch's
# ledger over every row, a worker respawn, shard 0 back at its address
# with its generation bumped, held-out accuracy >= RESILIENCE_ACC_MIN.
# (c) the LM (transformer_lm(**LM), bf16) under DOWNPOUR with 2 elastic
# worker processes on HOST_PS_LM_ROWS rows, window HOST_PS_LM_WINDOW,
# batch BATCH, adam 3e-3: each child launches the sm90 forward, dq and
# dk/dv layers x steps x (its windows + its warm-up), every other kernel
# never (read from the children's result files).  (d) the build lock:
# two processes build fused_ce at once into an empty build directory with
# a logging nvcc first on PATH: one nvcc, both load the library and hold
# one launch against the plain version.  No run logs "short of".  The
# scaling runs alone (it is timed); the other legs run side by side.
PROCESS_PS_SCALING = ()  # depth cut from (1, 2, 4), PERF.md section 4
PROCESS_PS_FT_FAULTS = {1: ("exit", 1)}
PROCESS_PS_FREEZE_S = 3.0
# streaming online training, hot weight reload and the online deployment
# (ROADMAP queue A items 6 and 4, their streaming and online parts), on
# the LM (transformer_lm(**LM), bf16) at full width.  (a) DOWNPOUR with
# stream=True, 2 worker threads, window HOST_PS_LM_WINDOW, batch BATCH,
# adam 3e-3, horizon_windows ONLINE_HORIZON_WINDOWS, max_horizons
# ONLINE_HORIZONS, over a generator of ONLINE_CHUNK-row chunks of token
# rows labelled through a permutation of the vocabulary that drifts (half
# the vocabulary remapped) half-way, worker 1 exiting at its
# ONLINE_EXIT_AT-th commit: every horizon's ledger completes every lease
# once over its rows, stream_stats["rows"] equals the rows read.  (b) a
# quantize="bf16" engine (SERVE_SLOTS slots, chunks of SERVE_CHUNK) over
# the same weights, attach_ps-ed to (a)'s live PS with every=1 (in the
# trainer's _on_ps_ready), serves the first SERVE_REQUESTS requests of
# phase serve's trace while (a) trains: reloads > 0, no reload failure,
# center_generation never decreasing, every tensor the decode graph reads
# at its address; with training paused at the last horizon (its hook
# waits), the trace again with a pull every decode step and with none
# (decode p50 with and without reloads), a last pull, then the greedy
# tokens of ONLINE_PROMPTS prompts equal to a fresh bf16 engine's built
# from the PS's center, and the same for an int8 engine after one pull.
# (c) OnlineDeployment over a trainer of (a)'s configuration (no fault,
# ONLINE_DEPLOY_HORIZONS horizons) and a started bf16 engine of (b)'s,
# supervise=True: one blue/green swap and one kill_engine from the
# horizon hook, ONLINE_PROMPTS requests served each horizon: every request
# completes on exactly one generation, none failed, freshness populated
# and mirrored, the kill's recovery_ms.  Counted from 0 over (a)-(c): the
# sm90 training forward, dq and dk/dv each launched layers x steps x the
# windows that ran (the ledger's seeding window, each worker's warm-up,
# every history window, the window the exit aborted), nothing else (the
# engines launch none).  Then accuracy-tracks-drift on bench.py:442
# online_deployment_bench's own configuration (vocab 16, seq 8 + 2,
# d_model 32, 4 heads, 1 layer, mlp 64, f32; DOWNPOUR, 2 workers, batch
# 16, window 2, horizon_windows 4, max_horizons 12; a drifting stream of
# 6 chunks of 128 rows, probe feedback for 8 horizons; an inline engine of
# 4 slots): served accuracy on the drifted mapping >= ONLINE_ACC_MIN and
# freshness p50 <= p99 (its launches printed apart).
ONLINE_HORIZON_WINDOWS, ONLINE_HORIZONS, ONLINE_CHUNK = 4, 4, 32
ONLINE_EXIT_AT, ONLINE_PROMPTS, ONLINE_DEPLOY_HORIZONS = 2, 4, 3
ONLINE_ACC_MIN = 0.5
# ParallelTransformerLM across ranks with Switch MoE (ROADMAP queue A item
# 7).  (a) One rank: the PLM of phase parallel_train on its fused-CE
# Ulysses route (bf16, batch 8 x 2048) with MOE's experts on every other
# layer (the Switch layout), router top-k each of MOE_TOP_K, PLM_STEPS
# steps of adam(PLM_LR) from one numpy-seeded weight set through
# load_jax_params: finite losses that fall, every layer's first-choice
# fractions summing to 1, B1 and B2 once a step, B3-B5 (sm90) once a
# layer and step, nothing else; one MoE layer at f32 (TF32 off) at that
# shape, the index form against the one-hot einsum form on the card
# (MOE_FORM_RTOL of the output's largest element; the same routing, sums
# in other orders) and against itself on the CPU (MOE_CPU_RTOL, over the
# tokens whose expert choices agree: a near-tie in the router's f32
# logits may flip a token's expert between devices, and those are
# counted).  (b) MOE_RANKS ranks on the one card over gloo, started as a
# coordinated job_deployment.Job through initialize_from_env while (a)
# runs, on mesh (1, 1, MOE_RANKS): heads, MLP and experts split over
# them, full width at f32, cut to MOE_RANK_LAYERS layers (layer 1 MoE),
# capacity factor MOE_RANK_CAPACITY so that no token drops on either mesh
# (a shard's capacity follows its token count, as
# tests/test_parallel_transformer.py:52-58 sets it for the same reason),
# batch MOE_RANK_BATCH, MOE_RANK_STEPS steps of adam(PLM_LR, eps
# MOE_RANK_EPS: the parity epsilon of tests/test_torch_train.py, so
# that f32 noise on a near-zero gradient moves no weight by a step),
# against a one-rank run of the same weights and batch in this process:
# losses within LOSS_RTOL_F32, the gathered parameters within
# MOE_RANK_PARAM_RTOL of each tensor's largest update over the two steps.
# Adam moves an element by lr · g / (|g| + eps) a step, so f32 noise dg
# in a gradient moves it by at most lr · dg / (4 eps): with dg ~1e-6 of
# the largest gradient that is under 0.3% of lr, while a gradient of the
# wrong sign moves it by 2 lr.
MOE = dict(moe_layers=(1, 3, 5, 7), num_experts=8, capacity_factor=2.0,
           router_aux_weight=1e-2)
MOE_TOP_K = (1, 2)
MOE_FORM_RTOL, MOE_CPU_RTOL = 1e-6, 1e-5
MOE_RANKS, MOE_RANK_LAYERS, MOE_RANK_CAPACITY = 2, 2, 8.0
MOE_RANK_BATCH, MOE_RANK_STEPS, MOE_RANK_EPS = 2, 2, 1e-4
MOE_RANK_PARAM_RTOL = 1e-2
MOE_RANK_TIMEOUT_S = 300.0
# The pipeline (GPipe and 1F1B), PipelineTransformerLM and ZeRO-1/FSDP
# across ranks.  (a) One rank, mesh (1, 1) ('data', 'stage'):
# PipelineTransformerLM at the PLM's widths (vocab 32768, seq 2048,
# d_model 512, 8 heads, 8 layers, mlp 2048; learned positions, as the JAX
# class has no RoPE), bf16, batch PLM_BATCH, PLM_STEPS steps of
# adam(PLM_LR) from one numpy-seeded weight set through load_jax_params,
# for each schedule at each M of PP_MICRO: finite losses that fall, ms a
# step, tokens/s, the peak memory, and per step exactly 8 M sm90 training
# forwards, dq and dk/dv (GPipe; 0 inference forwards) or 8 M inference
# forwards beside them (1F1B: the tick's forward under no_grad, its
# recompute with grad), nothing on simt.  (b) PP_RANKS ranks on the one
# card over gloo, started as a coordinated job_deployment.Job through
# initialize_from_env while (a) runs, mesh (1, PP_RANKS): full width at
# bf16, cut to PP_RANK_LAYERS layers (one a stage), batch PP_RANK_BATCH,
# M = PP_RANK_MICRO, PP_RANK_STEPS steps of each schedule, against a
# one-rank run of the same weights and batch in this process: losses
# within PP_RANK_LOSS_RTOL, gathered parameters within MOE_RANK_PARAM_RTOL
# of each tensor's largest update (whether they agree to the bit is
# printed), each rank's launches those of its one layer.  (c) The same
# ranks on mesh (PP_RANKS, 1, 1): ParallelTransformerLM at the PLM's
# widths on the fused Ulysses route, f32, cut to ZERO_RANK_LAYERS layers,
# batch ZERO_RANK_BATCH (a row a rank), ZERO_RANK_STEPS steps of adam
# (eps MOE_RANK_EPS) each with zero=False, zero=True and fsdp=True: losses
# and gathered parameters of the three within ZERO_RTOL (JAX's own band,
# tests/test_zero.py:66), and each rank's Adam moment bytes (ZeRO, FSDP)
# and parameter bytes at rest (FSDP) equal to what the slicing rule gives
# from the shapes (computed here, not read from an allocator).
PP_LM = dict(vocab_size=32768, seq_len=2048, d_model=512, num_heads=8,
             num_layers=8, mlp_dim=2048)
PP_SCHEDULES, PP_MICRO = ("gpipe", "1f1b"), (2, 8)
PP_RANKS, PP_RANK_LAYERS, PP_RANK_BATCH, PP_RANK_MICRO = 2, 2, 4, 2
PP_RANK_STEPS, PP_RANK_LOSS_RTOL = 2, 1e-4
ZERO_RANK_LAYERS, ZERO_RANK_BATCH, ZERO_RANK_STEPS, ZERO_RTOL = 2, 2, 2, 1e-6
PP_RANK_TIMEOUT_S = 300.0
# The SPMD engine, ModelPredictor and the dry run across ranks,
# SPMD_RANKS ranks on the one card over gloo, started as a coordinated
# job_deployment.Job through initialize_from_env while this process runs
# the one-process references.  (a) The north-star
# configuration (bench.py:1109-1121: mnist_convnet, bf16, adam, batch
# ADAG_BATCH, window ADAG_WINDOW, the ADAG_ROWS rows, seeded weights) under
# each of SPMD_RANK_ALGOS, one worker a rank, SPMD_RANK_EPOCHS epochs (the
# first warms up, the last is timed), against the one-process
# SPMD_RANKS-worker engine on the card from the same weights: losses,
# center and every worker's params equal to the bit; examples/s, ms a round
# a rank, collective calls, bytes and host seconds; no kernel launched.
# (b) ModelPredictor(mesh=) over phase slice's LM ("full", bf16, random
# numpy-seeded weights) on SPMD_PREDICT_ROWS rows, batch SPMD_PREDICT_BATCH:
# every rank's gathered rows equal this process's one-device predict of the
# same rows to the bit, one flash_inference_sm90 a layer on each rank
# (num_layers a rank) and nothing else.  (c) dryrun_multichip(
# SPMD_DRYRUN_RANKS) on the card: every part's loss finite; it runs beside
# (a)'s and (b)'s one-process references (so their times carry its load;
# the ranks' timed runs start after it ends), a depth cut of ~13 s.
SPMD_RANKS, SPMD_RANK_ALGOS, SPMD_RANK_EPOCHS = 2, ("adag", "dynsgd"), 2
SPMD_PREDICT_ROWS, SPMD_PREDICT_BATCH = 16, 8
SPMD_DRYRUN_RANKS = 4
SPMD_RANK_TIMEOUT_S = 300.0
# the port's host C++ extensions (distkeras_tpu_torch/native.py: its own
# copies of csrc/wirecodec.cpp, csvloader.cpp and applykernel.cpp, built
# by the host compiler at first use).  (a) each built from the checkout's
# sources into an empty directory, one compiler run and its seconds each,
# a second build compiling none; (b) the full-width LM's weight message
# (f32 leaves, then bf16 leaves) and the north star's ConvNet delta
# (430,890 f32) through the native and the pure-Python codec: the same
# bytes, the same decoded bits, encode and decode ms each (host clock,
# median of NATIVE_REPS); (c) the PS apply, native against numpy, to the
# bit, ms each: the dense axpy of a ConvNet delta into its center (scale
# 1/HOST_PS_WORKERS), a top-k scatter-add at PS_SPARSE_TOPK, a row-sparse
# commit of PS_SPARSE_EMB_WINDOW x PS_SPARSE_EMB_BATCH rows into the
# PS_SPARSE_EMB table; (d) host-PS ADAG with one serial worker on phase
# adag's rows (the ConvNet, cuDNN deterministic) and on phase host_ps's
# LM rows (window HOST_PS_LM_WINDOW, batch BATCH), each run with the
# native codec and apply_kernel="native" and again with the pure-Python
# codec and numpy: the centers to the bit, examples/s each, the LM's sm90
# forward, dq and dk/dv launched layers x steps a run and nothing else;
# (e) a CSV of the Higgs layout (the label, then 28 features),
# NATIVE_CSV_ROWS rows drawn from the seed (the 11M rows of the UCI file
# cut to the run's budget): read_csv's native route against
# np.genfromtxt, features and labels to the bit, seconds each
NATIVE_CSV_ROWS, NATIVE_REPS = 100_000, 5
# the load generator (ROADMAP queue A item 9: the port of
# examples/loadgen.py, distkeras_tpu_torch/examples/loadgen.py).  (a) its
# main in this process on the card at the JAX script's defaults
# (LOADGEN_CLI: 24 requests, 4 slots, concurrency 8, 16 new tokens, its
# 2-layer f32 LM of width 32 from random weights), then with --spec-draft 1
# (a random 1-layer draft: no training in the JAX script's main either);
# then build_spec_engine at the JAX default of LOADGEN_SPEC_EPOCHS epochs
# (its 2-layer target and 1-layer draft trained by SingleTrainer on the
# card: f32 at head dim 8, so B3-B5's SIMT training forms once a layer and
# step) and a closed loop of an arith trace through its speculative
# engine.  (b) at full width: phase serve's engine (the LM, bf16, form
# full, SERVE_SLOTS slots, chunks of SERVE_CHUNK, warmed), the trace
# make_trace(LOADGEN_REQUESTS, vocab 512, SERVE_PROMPT_LENS, LOADGEN_STEPS
# new tokens, temperature SERVE_TEMP) driven by direct submit (the
# reference rows), by run_closed_loop (LOADGEN_USERS users), by
# run_wire_closed_loop (LOADGEN_USERS clients, event core), and by
# run_open_loop at LOADGEN_FLOOD_QPS against a queue of
# LOADGEN_FLOOD_QUEUE with the scheduler held until every submission was
# tried (so exactly the queue's capacity is admitted).  LOADGEN_STEPS is a
# depth cut from phase serve's SERVE_STEPS (PERF.md section 4)
LOADGEN_CLI = ("--requests", "24", "--slots", "4", "--concurrency", "8",
               "--steps", "16")
LOADGEN_SPEC_EPOCHS = 25
LOADGEN_REQUESTS, LOADGEN_STEPS, LOADGEN_USERS = 16, 32, 8
LOADGEN_FLOOD_QPS, LOADGEN_FLOOD_QUEUE = 1e6, 4
LOADGEN_TIMEOUT_S = 300.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, warmup: int, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings of one call each."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def live_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one head."""
    if not causal:
        return s * s
    w = window or s
    return sum(min(p + 1, w) for p in range(s))


def phase_device():
    global EXP_PER_S
    import torch
    from distkeras_tpu_torch import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = EX2_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
    t0 = time.perf_counter()
    compiled = kernels.build()
    build_s = time.perf_counter() - t0
    from distkeras_tpu_torch import native
    t0 = time.perf_counter()
    native_compiled = native.build()
    native_build_s = time.perf_counter() - t0
    # the plain reference path states its precision: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "sm_count": sms, "sm_clock_max_mhz": sm_mhz,
          "exp2_per_s": EXP_PER_S,
          "kernels_compiled": compiled, "build_s": build_s,
          "native_compiled": native_compiled,
          "native_build_s": native_build_s, "cxx": native.compiler()})
    return smi


def phase_kernel():
    import importlib
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    flash_attention = fa.flash_attention
    flash_attention_reference = fa.flash_attention_reference
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    every = (f32, bf16, f16)
    cases = [  # name, B, S, H, Hkv, D, causal, window, dtypes
        ("causal", 8, 2048, 8, 2, 32, True, None, every),
        ("window256", 8, 2048, 8, 2, 32, True, 256, every),
        ("noncausal", 8, 2048, 8, 2, 32, False, None, every),
        ("d64", 8, 1024, 8, 2, 64, True, None, every),
        ("d128", 8, 1024, 8, 2, 128, True, None, every),
        ("ragged200", 8, 200, 8, 2, 32, True, None, every),
        # head dims the kernels pad: 16 -> 32, 96 -> 128, 200 -> 256
        ("d16", 8, 1024, 8, 2, 16, True, None, every),
        ("d96", 4, 1024, 8, 2, 96, True, 128, (bf16, f16)),
        ("d200", 2, 1000, 8, 2, 200, True, None, every),
        # the parallel LM's attention on its Ulysses route (MHA, D 64)
        PLM_ULYSSES_CASE + (every,),
        ODD_CASE + ((bf16, f16),),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for name, b, s, h, hkv, d, causal, window, dtypes in cases:
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q = torch.randn(b, s, h, d, device="cuda", generator=gen)
            k = torch.randn(b, s, hkv, d, device="cuda", generator=gen)
            v = torch.randn(b, s, hkv, d, device="cuda", generator=gen)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            # both variants sum in a fixed order (no atomics)
            repeat_same = torch.equal(out, flash_attention(
                q, k, v, causal=causal, window=window))
            torch.cuda.synchronize()
            ref = flash_attention_reference(q, k, v, causal, None, window)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            rel, atol = KERNEL_TOL[dname]
            # the largest error as a share of its own element's tolerance
            err_share = (diff / (rel * ref.float().abs() + atol)).max().item()

            kernel_ms = median_ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window), 3, 20)
            plain_ms = median_ms(lambda: flash_attention_reference(
                q, k, v, causal, None, window), 2, 5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            else:
                pos = torch.arange(s, device="cuda")
                keep = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - window))
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True)
            lib_out = sdpa().transpose(1, 2)
            library_ms = median_ms(sdpa, 3, 20)

            pairs = b * h * live_pairs(s, causal, window)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
            bound = _flash_bound("fwd", d, pairs, nbytes, dname)
            row = {"phase": "kernel", "case": name, "dtype": dname,
                   "variant": fa._forward_variant(dtype, d),
                   "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                   "causal": causal, "window": window,
                   "max_abs_err": err, "tol_rel": rel, "tol_abs": atol,
                   "err_share_of_tol": err_share,
                   "repeat_bit_identical": repeat_same,
                   "library_max_abs_err": (lib_out.float()
                                           - ref.float()).abs().max().item(),
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "bound_term": bound[2],
                   "bound_ms_f32_cuda_cores": bound[3],
                   "bound_ms_split_tf32": bound[4]}
            if dname == "bfloat16" and name in SIMT_TIMED:
                row["simt_ms"] = _simt_forward_ms(q, k, v, causal, window,
                                                  lse=False)
            emit(row)
            check(err_share <= 1.0, f"flash kernel {name}/{dname}: error "
                  f"{err_share:.3g}x its tolerance ({rel} * |plain| + "
                  f"{atol}; max abs err {err})")
            check(repeat_same, f"flash kernel {name}/{dname}: two runs on "
                  f"the same inputs differ")
            results[(name, dname)] = row
            del q, k, v, out, ref, diff, lib_out
    torch.cuda.empty_cache()
    return results


def _random_jax_weights(model, rng):
    """Weights in the JAX package's layout, from a numpy seed: kernels
    ~N(0, 1/fan_in), embedding tables ~N(0, 0.02²), LayerNorm scales
    ~1 + N(0, 0.1²), biases and offsets ~N(0, 0.02²)."""
    from distkeras_tpu_torch.core.model import jax_leaves
    out = []
    for path, p in jax_leaves(model):
        shape = tuple(p.shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "embedding":
            w = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 2:
            w = rng.standard_normal(shape) / (shape[0] ** 0.5)
        elif leaf == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            w = 0.02 * rng.standard_normal(shape)
        out.append(w.astype("float32"))
    return out


def _want_variant(dtype: str, n: int) -> dict:
    """A flash kernel's launches by variant when ``n`` launches of a model
    in ``dtype`` (head dims multiples of 8, at most 128) are all served as
    the rules say: 16-bit by the sm90 kernels, f32 by the SIMT kernels."""
    return {"sm90": 0 if dtype == "float32" else n,
            "simt": n if dtype == "float32" else 0}


def _predict_route(extra, weights, data):
    """Build the LM, load ``weights``, warm up, then time one counted
    ``ModelPredictor.predict``; returns (fitted, logits, seconds,
    kernel launches during the counted run, and those by variant)."""
    from distkeras_tpu_torch import (FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    from distkeras_tpu_torch.ops.flash_attention import flash_attention
    model = transformer_lm(**{**LM, **extra})  # device=None: the card
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    predictor = ModelPredictor(fitted, batch_size=BATCH)
    predictor.predict(data)  # warm-up: cuBLAS handles, allocator
    _zero_counts()
    t0 = time.perf_counter()
    logits = predictor.predict(data)["prediction"]
    seconds = time.perf_counter() - t0
    return (fitted, logits, seconds, flash_attention.launches,
            dict(flash_attention.launches_by_variant))


def phase_slice():
    import numpy as np
    import torch
    from distkeras_tpu_torch import Dataset, transformer_lm
    rng = np.random.default_rng(SEED)
    data = Dataset({"features": rng.integers(
        0, LM["vocab_size"], (ROWS, LM["seq_len"])).astype(np.int32)})
    batches = -(-ROWS // BATCH)
    want_launches = LM["num_layers"] * batches
    shape = (ROWS, LM["seq_len"], LM["vocab_size"])
    tokens = ROWS * LM["seq_len"]
    launches, variants, kept = {}, {}, {}
    for form, extra in FORMS.items():
        # one weight set per form, from the numpy seed, in the JAX layout
        weights = _random_jax_weights(
            transformer_lm(**LM, **extra, device="meta"), rng)
        for dtype in ("bfloat16", "float32"):
            kw = {**extra, "compute_dtype": dtype}
            fitted, logits, seconds, n_kernel, by_variant = _predict_route(
                kw, weights, data)
            launches[f"{form}/{dtype}"] = n_kernel
            variants[f"{form}/{dtype}"] = by_variant
            _, want, plain_seconds, n_plain, _ = _predict_route(
                {**kw, "attention_impl": "xla"}, weights, data)
            torch.cuda.empty_cache()

            diff = float(np.abs(logits - want).max())
            same = logits.argmax(-1) == want.argmax(-1)
            top2 = np.sort(want, axis=-1)[..., -2:]
            decided = (top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN[dtype]
            agree = float(same[decided].mean())
            agree_all = float(same.mean())
            emit({"phase": "slice", "form": form, "compute_dtype": dtype,
                  "rows": ROWS, "batch_size": BATCH,
                  "logits_shape": list(logits.shape),
                  "finite": bool(np.isfinite(logits).all()),
                  "logit_abs_max": float(np.abs(want).max()),
                  "max_abs_diff_vs_plain": diff, "tol": LOGIT_TOL[dtype],
                  "argmax_agreement_all": agree_all,
                  "argmax_all_min": ARGMAX_ALL_MIN[dtype],
                  "argmax_margin": ARGMAX_MARGIN[dtype],
                  "decided_share": float(decided.mean()),
                  "argmax_agreement": agree, "argmax_min": ARGMAX_MIN,
                  "kernel_launches": n_kernel,
                  "kernel_launches_by_variant": by_variant,
                  "expected_launches": want_launches,
                  "plain_route_launches": n_plain,
                  "tokens_per_s": tokens / seconds,
                  "ms_per_batch": seconds / batches * 1e3,
                  "plain_tokens_per_s": tokens / plain_seconds,
                  "plain_ms_per_batch": plain_seconds / batches * 1e3})
            tag = f"{form}/{dtype}"
            check(logits.shape == shape and want.shape == shape,
                  f"{tag}: logits shape {logits.shape}, want {shape}")
            check(bool(np.isfinite(logits).all()), f"{tag}: non-finite")
            check(diff <= LOGIT_TOL[dtype], f"{tag}: kernel vs plain route "
                  f"max abs diff {diff} > {LOGIT_TOL[dtype]}")
            check(agree >= ARGMAX_MIN, f"{tag}: argmax agreement {agree} < "
                                       f"{ARGMAX_MIN}")
            check(agree_all >= ARGMAX_ALL_MIN[dtype], f"{tag}: argmax "
                  f"agreement over all positions {agree_all} < "
                  f"{ARGMAX_ALL_MIN[dtype]}")
            check(n_kernel == want_launches, f"{tag}: {n_kernel} kernel "
                  f"launches, want {want_launches}")
            check(by_variant == _want_variant(dtype, want_launches),
                  f"{tag}: forward launches by variant {by_variant}")
            check(n_plain == 0, f"{tag}: the plain route launched the "
                                f"kernel {n_plain} times")
            if dtype == LM["compute_dtype"]:
                kept[form] = (fitted, data, logits)
    return launches, variants, kept


def phase_blob(fitted, data, logits):
    import numpy as np
    from distkeras_tpu_torch import FittedModel
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "transformer_lm_full.npz")
    fitted.save(path)
    loaded = FittedModel.load(path)  # device=None: the card
    again = loaded.predict(data["features"], batch_size=BATCH)
    same = bool(np.array_equal(again, logits))
    emit({"phase": "blob", "path": os.path.relpath(path),
          "bytes": os.path.getsize(path), "bit_identical": same})
    check(same, "blob round trip changed the logits")

def _err_share(got, want, dname: str):
    """(max abs error, largest error as a share of its element's
    tolerance) of a kernel output against its plain version."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TRAIN_TOL_ULP[dname] * w.abs() + TRAIN_TOL_F32 * w.abs().max()
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


def _bound(flops: float, nbytes: float, peak: float, unit: str,
           exps: float = 0):
    """(bound ms, what bounds it: "bytes" or "operations", the term that
    bounds it: "bytes", ``unit`` or "exponentials"): the largest of bytes
    over the HBM rate, ``flops`` over ``peak`` flop/s (the rate of
    ``unit``) and ``exps`` exponentials over the MUFU rate (EXP_PER_S)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             unit: flops / peak * 1e3,
             "exponentials": exps / EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def _flash_bound(key: str, d: int, pairs: int, nbytes: float, dname: str):
    """(bound ms, "bytes" or "operations", its term, ms with the products
    on the f32 CUDA cores, ms with them on the TF32 tensor cores in split
    passes) of the flash work ``key`` (FLASH_WORK) over ``pairs`` live
    pairs at head dim ``d``.  The bound is the least time the card could
    take: the products at the dtype's peak or in TF32_PASSES on the TF32
    tensor cores, whichever is less (for f32 the split, for 16-bit inputs
    the dtype's peak)."""
    n_in, n_p, n_exp = FLASH_WORK[key]
    a, b = TF32_PASSES[dname]
    flops, exps = 2 * d * pairs * (n_in + n_p), n_exp * pairs
    native = _bound(flops, nbytes, PEAK_FLOPS[dname], PEAK_UNIT[dname], exps)
    split = _bound(2 * d * pairs * (a * n_in + b * n_p), nbytes, TF32_FLOPS,
                   "tf32_split", exps)
    cuda_cores = _bound(flops, nbytes, PEAK_FLOPS["float32"], "cuda_core",
                        exps)
    return (*min(native, split), cuda_cores[0], split[0])


def _simt_forward_ms(q, k, v, causal, window, lse: bool) -> float:
    """The forward's SIMT kernel timed on 16-bit inputs that the wrappers
    send to the sm90 kernel: through the private launcher, for timing
    only (these launches are not counted)."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    out = torch.empty_like(q)
    b, s, h, _ = q.shape
    res = torch.empty(b, h, s, dtype=torch.float32, device=q.device) \
        if lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if res is None else res.data_ptr())
    return median_ms(lambda: fa._launch(
        fa.FORWARD_VARIANTS["simt"], ptrs, q, k.shape[2], fa._scale(q, None),
        causal, window), 3, 20)


def _simt_backward_ms(q, k, v, out, lse, do, delta, causal, window) -> dict:
    """The backward's SIMT kernels timed on 16-bit inputs that the
    wrappers send to the sm90 kernels: through the private launcher, for
    timing only (these launches are not counted)."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta_out = torch.empty_like(delta)
    names = fa.BACKWARD_VARIANTS["simt"]
    rest = (q, k.shape[2], fa._scale(q, None), causal, window)
    dq_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta_out.data_ptr(),
               dq.data_ptr())
    dkv_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr())
    return {"dq": median_ms(lambda: fa._launch(names["dq"], dq_ptrs, *rest),
                            3, 10),
            "dkv": median_ms(lambda: fa._launch(names["dkv"], dkv_ptrs,
                                                *rest), 3, 10)}


def _sdpa_backward_ms(sdpa, outputs, cotangent) -> dict:
    """SDPA's backward alone, on a graph kept from its forward, under
    each backend of SDPA_BACKENDS that takes the case (a yardstick only:
    the port never calls it); ms by backend."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:  # a backend that refuses the case warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib_out = sdpa()
                times[name.lower()] = median_ms(lambda: torch.autograd.grad(
                    lib_out, outputs, cotangent, retain_graph=True), 3, 10)
        except RuntimeError:
            pass
        lib_out = None
    return times


def _repeat_same(fa, q, k, v, out, lse, do, args, first) -> bool:
    """Both variants of the backward sum in a fixed order (no atomics):
    dq, Delta, dk and dv of a second run on the same inputs equal
    ``first`` to the bit."""
    import torch
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, *args)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, (dq, delta, dk, dv)))


def phase_kernel_train():
    import importlib
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for name, b, s, h, hkv, d, causal, window in KERNEL_TRAIN_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                       generator=gen).to(dtype)
                           for n in (h, hkv, hkv, h))
            args = (causal, None, window)
            out, lse = fa.flash_attention_forward(q, k, v, *args)
            fwd_repeat_same = all(map(torch.equal, (out, lse),
                                      fa.flash_attention_forward(q, k, v,
                                                                 *args)))
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                  *args)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                                *args)
            torch.cuda.synchronize()
            bwd_variant = fa._backward_variant(dtype, d)
            repeat_same = _repeat_same(fa, q, k, v, out, lse, do, args,
                                       (dq, delta, dk, dv))
            # each plain version on the kernel's own inputs
            ro, rl = fa.flash_attention_reference(q, k, v, *args,
                                                  return_lse=True)
            rq, rdelta = fa.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, *args)
            rk, rv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, lse, do, delta, *args)
            errs = {"out": _err_share(out, ro, dname),
                    "lse": _err_share(lse, rl, "float32"),
                    "delta": _err_share(delta, rdelta, "float32"),
                    "dq": _err_share(dq, rq, dname),
                    "dk": _err_share(dk, rk, dname),
                    "dv": _err_share(dv, rv, dname)}
            del ro, rl, rq, rdelta, rk, rv

            ms = {
                "fwd_lse": median_ms(lambda: fa.flash_attention_forward(
                    q, k, v, *args), 3, 20),
                "dq": median_ms(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, out, lse, do, *args), 3, 10),
                "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, do, delta, *args), 3, 10)}
            plain_ms = {
                "fwd_lse": median_ms(lambda: fa.flash_attention_reference(
                    q, k, v, *args, return_lse=True), 1, 3),
                "dq": median_ms(lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, out, lse, do, *args), 1, 3),
                "dkv": median_ms(
                    lambda: fa.flash_attention_bwd_dkv_reference(
                        q, k, v, lse, do, delta, *args), 1, 3)}
            # the yardstick: SDPA forward, and its backward alone on a
            # kept graph (never on the port's path)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = {}
            if window is not None:
                pos = torch.arange(s, device="cuda")
                mask["attn_mask"] = ((pos[None, :] <= pos[:, None])
                                     & (pos[None, :] > pos[:, None] - window))
            else:
                mask["is_causal"] = causal
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **mask)
            sdpa_fwd_ms = median_ms(sdpa, 3, 10)
            sdpa_bwd = _sdpa_backward_ms(sdpa, (qt, kt, vt),
                                         do.transpose(1, 2))
            del qt, kt, vt

            # each kernel takes one exponential per live pair (the
            # backward kernels recompute p = exp(s - lse))
            pairs = b * h * live_pairs(s, causal, window)
            bounds = {
                "fwd_lse": _flash_bound("fwd", d, pairs,
                                        nbytes(q, k, v, out, lse), dname),
                "dq": _flash_bound("dq", d, pairs,
                                   nbytes(q, k, v, out, do, lse, dq, delta),
                                   dname),
                "dkv": _flash_bound("dkv", d, pairs,
                                    nbytes(q, k, v, do, lse, delta, dk, dv),
                                    dname)}
            bwd_bytes = nbytes(q, k, v, out, do, lse, dq, dk, dv)
            bwd_bound = _flash_bound("bwd", d, pairs, bwd_bytes, dname)
            schedule_bound = _flash_bound("bwd_schedule", d, pairs,
                                          bwd_bytes, dname)
            row = {"phase": "kernel_train", "case": name, "dtype": dname,
                   "variant": fa._forward_variant(dtype, d),
                   "bwd_variant": bwd_variant,
                   "fwd_repeat_bit_identical": fwd_repeat_same,
                   "bwd_repeat_bit_identical": repeat_same,
                   "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                   "causal": causal, "window": window,
                   "max_abs_err": {n: e[0] for n, e in errs.items()},
                   "err_share_of_tol": {n: e[1] for n, e in errs.items()},
                   "tol_ulp": TRAIN_TOL_ULP[dname],
                   "tol_f32_of_max": TRAIN_TOL_F32,
                   "ms": ms, "plain_ms": plain_ms,
                   "bwd_ms": ms["dq"] + ms["dkv"],
                   "bwd_plain_ms": plain_ms["dq"] + plain_ms["dkv"],
                   "library_fwd_ms": sdpa_fwd_ms,
                   "library_bwd_ms": min(sdpa_bwd.values(), default=None),
                   "library_bwd_ms_by_backend": sdpa_bwd,
                   "bound_ms": {n: bd[0] for n, bd in bounds.items()},
                   "bound_by": {n: bd[1] for n, bd in bounds.items()},
                   "bound_term": {n: bd[2] for n, bd in bounds.items()},
                   "bound_ms_f32_cuda_cores": {n: bd[3] for n, bd in
                                               bounds.items()},
                   "bound_ms_split_tf32": {n: bd[4] for n, bd in
                                           bounds.items()},
                   "bwd_bound_ms": bwd_bound[0],
                   "bwd_bound_ms_f32_cuda_cores": bwd_bound[3],
                   "bwd_schedule_bound_ms": schedule_bound[0],
                   "bwd_schedule_bound_ms_f32_cuda_cores":
                       schedule_bound[3]}
            if dname == "bfloat16" and name in SIMT_TIMED:
                row["simt_ms"] = {"fwd_lse": _simt_forward_ms(
                    q, k, v, causal, window, lse=True),
                    **_simt_backward_ms(q, k, v, out, lse, do, delta, causal,
                                        window)}
                row["simt_bwd_ms"] = row["simt_ms"]["dq"] + row["simt_ms"][
                    "dkv"]
            emit(row)
            worst = max(errs, key=lambda n: errs[n][1])
            check(errs[worst][1] <= 1.0, f"training kernels {name}/{dname}:"
                  f" {worst} error {errs[worst][1]:.3g}x its tolerance "
                  f"(max abs err {errs[worst][0]})")
            check(fwd_repeat_same, f"forward with lse {name}/{dname}: two "
                  f"runs on the same inputs differ")
            check(repeat_same, f"{bwd_variant} backward {name}/{dname}: "
                  f"two runs on the same inputs differ")
            results[(name, dname)] = row
            del q, k, v, do, out, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
    return results


def phase_memory():
    """Forward and backward through the kernels at S 8192 (bf16, B 1,
    H 8, Hkv 2, D 32): the peak allocation above the inputs stays a small
    multiple of one (S, H, D) tensor, where one f32 (H, S, S) score
    tensor alone would take 2.1 GB."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    b, s, h, hkv, d = 1, 8192, 8, 2, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (h, hkv, hkv, h))
    for t in (q, k, v):
        t.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    unit = q.numel() * q.element_size()  # one (S, H, D) bf16 tensor
    limit = 8 * unit
    scores = b * h * s * s * 4
    counts = _read_counts()
    launches = [counts[n] for n in ("flash_fwd_lse_sm90", "flash_dq_sm90",
                                    "flash_dkv_sm90")]
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    emit({"phase": "memory", "shape_bshd": [b, s, h, d], "kv_heads": hkv,
          "dtype": "bfloat16", "peak_bytes_above_inputs": peak,
          "sd_tensor_bytes": unit, "limit_bytes": limit,
          "peak_in_sd_tensors": peak / unit,
          "one_score_tensor_bytes": scores,
          "launches_fwd_dq_dkv_sm90": launches, "launches": counts,
          "grads_finite": finite})
    check(peak <= limit, f"fwd+bwd at S {s} allocated {peak} bytes above "
                         f"its inputs, over {limit}")
    check(launches == [1, 1, 1] and counts["flash_fwd_lse"]
          == counts["flash_dq"] == counts["flash_dkv"] == 1,
          f"fwd+bwd launches {counts}, want one each, all sm90")
    check(finite, "non-finite gradients at S 8192")


def _train_route(extra, weights, data, warm):
    """Build the LM with ``weights``, warm up with one short training,
    then run the counted ``SingleTrainer`` training; returns (fitted,
    history, seconds, launches of the four kernel entry points)."""
    import importlib
    import torch
    from distkeras_tpu_torch import (FittedModel, SingleTrainer,
                                     load_jax_weights, transformer_lm)
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    model = transformer_lm(**{**LM, **extra})  # device=None: the card
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    SingleTrainer(fitted, **{**TRAINER, "num_epoch": 1}).train(warm)
    torch.cuda.synchronize()
    _zero_counts()
    trainer = SingleTrainer(fitted, **TRAINER)
    t0 = time.perf_counter()
    trained = trainer.train(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd_lse": fa.flash_attention_forward.launches,
                "dq": fa.flash_attention_backward.dq_launches,
                "dkv": fa.flash_attention_backward.dkv_launches,
                "inference": fa.flash_attention.launches,
                "fwd_lse_by_variant": dict(
                    fa.flash_attention_forward.launches_by_variant),
                "dq_by_variant": dict(
                    fa.flash_attention_backward.dq_launches_by_variant),
                "dkv_by_variant": dict(
                    fa.flash_attention_backward.dkv_launches_by_variant)}
    return trained, trainer.get_history(), seconds, launches


def _first_step_grads(extra, weights, data):
    """The gradient of every parameter for the first batch, through the
    trainer's own masked loss."""
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.core.train import (make_masked_loss_fn,
                                                model_params)
    model = transformer_lm(**{**LM, **extra})
    load_jax_weights(model, weights)
    compute = make_masked_loss_fn(model, TRAINER["loss"])
    x = torch.as_tensor(data["features"][:BATCH], device="cuda")
    y = torch.as_tensor(data["label"][:BATCH], device="cuda")
    value, _ = compute(x, y, torch.ones(BATCH, device="cuda"))
    params = model_params(model)
    grads = torch.autograd.grad(value, list(params.values()))
    return dict(zip(params, grads))


def phase_train(card: str):
    import importlib
    import numpy as np
    import torch
    from distkeras_tpu_torch import Dataset, ModelPredictor, transformer_lm
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    rng = np.random.default_rng(SEED + 3)
    x = rng.integers(0, LM["vocab_size"],
                     (TRAIN_ROWS, LM["seq_len"])).astype(np.int32)
    data = Dataset({"features": x,
                    "label": ((x + 1) % LM["vocab_size"]).astype(np.int64)})
    warm = Dataset({c: data[c][:BATCH] for c in data.columns})
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // BATCH)
    want = LM["num_layers"] * steps
    runs = {}
    for form, extra in FORMS.items():
        weights = _random_jax_weights(
            transformer_lm(**LM, **extra, device="meta"), rng)
        for dtype in ("bfloat16", "float32"):
            tag = f"{form}/{dtype}"
            kw = {**extra, "compute_dtype": dtype}
            fitted, hist, seconds, launches = _train_route(
                kw, weights, data, warm)
            runs[tag] = launches
            _, plain_hist, plain_seconds, plain_launches = _train_route(
                {**kw, "attention_impl": "xla"}, weights, data, warm)
            torch.cuda.empty_cache()
            hist, plain_hist = np.asarray(hist), np.asarray(plain_hist)
            loss_rel = float(np.max(np.abs(hist - plain_hist)
                                    / np.abs(plain_hist)))
            row = {"phase": "train", "form": form, "compute_dtype": dtype,
                   "steps": steps, "rows": TRAIN_ROWS, "batch_size": BATCH,
                   "losses": hist.tolist(),
                   "plain_losses": plain_hist.tolist(),
                   "loss_max_rel_diff": loss_rel,
                   "loss_tol": (LOSS_RTOL_F32 if dtype == "float32"
                                else LOSS_BAND_BF16),
                   "last_over_first": float(hist[-1] / hist[0]),
                   "plain_last_over_first": float(plain_hist[-1]
                                                  / plain_hist[0]),
                   "launches": launches, "expected_launches": want,
                   "plain_route_launches": plain_launches,
                   "card": card, "ms_per_step": seconds / steps * 1e3,
                   "examples_per_s": TRAIN_ROWS * TRAIN_EPOCHS / seconds,
                   "plain_ms_per_step": plain_seconds / steps * 1e3,
                   "plain_examples_per_s":
                       TRAIN_ROWS * TRAIN_EPOCHS / plain_seconds}
            if dtype == "float32":
                got = _first_step_grads(kw, weights, data)
                ref = _first_step_grads({**kw, "attention_impl": "xla"},
                                        weights, data)
                gmax = max(g.abs().max().item() for g in ref.values())
                shares = {n: ((got[n] - ref[n]).abs().max().item()
                              / (GRAD_RTOL * ref[n].abs().max().item()
                                 + GRAD_ATOL * gmax)) for n in ref}
                worst = max(shares, key=shares.get)
                row.update({"grad_worst_tensor": worst,
                            "grad_worst_share_of_tol": shares[worst],
                            "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL})
                del got, ref
            emit(row)
            check(bool(np.isfinite(hist).all()), f"{tag}: non-finite loss")
            check(all(launches[n] == want for n in ("fwd_lse", "dq", "dkv"))
                  and launches["inference"] == 0,
                  f"{tag}: kernel launches {launches}, want {want} each")
            for key in ("fwd_lse_by_variant", "dq_by_variant",
                        "dkv_by_variant"):
                check(launches[key] == _want_variant(dtype, want),
                      f"{tag}: training launches {key} {launches[key]}")
            check(not any(n for n in plain_launches.values()
                          if isinstance(n, int))
                  and not any(any(n.values()) for n in plain_launches.values()
                              if isinstance(n, dict)),
                  f"{tag}: the plain route launched kernels {plain_launches}")
            check(loss_rel <= row["loss_tol"], f"{tag}: loss traces differ "
                  f"by {loss_rel} > {row['loss_tol']}")
            check(hist[-1] < LOSS_DROP * hist[0]
                  and plain_hist[-1] < LOSS_DROP * plain_hist[0],
                  f"{tag}: the loss did not fall below {LOSS_DROP} of the "
                  f"first ({hist[0]} -> {hist[-1]}, plain {plain_hist[0]} "
                  f"-> {plain_hist[-1]})")
            if dtype == "float32":
                check(row["grad_worst_share_of_tol"] <= 1.0,
                      f"{tag}: first-step gradient of {worst} differs "
                      f"{shares[worst]:.3g}x its tolerance")
            if (form, dtype) == MAIN_PATH:
                _zero_counts()
                served = ModelPredictor(fitted, batch_size=BATCH).predict(
                    Dataset({"features": x[:ROWS]}))["prediction"]
                n_serve = fa.flash_attention.launches
                serve_variant = dict(fa.flash_attention.launches_by_variant)
                emit({"phase": "train_serve", "form": form,
                      "compute_dtype": dtype, "rows": ROWS,
                      "inference_launches": n_serve,
                      "inference_launches_by_variant": serve_variant,
                      "finite": bool(np.isfinite(served).all())})
                n_want = LM["num_layers"] * -(-ROWS // BATCH)
                check(n_serve == n_want and serve_variant
                      == _want_variant(dtype, n_want),
                      f"serving the trained model launched the inference "
                      f"kernel {n_serve} times ({serve_variant})")
                check(bool(np.isfinite(served).all()),
                      "trained model served non-finite logits")
    return runs


def _ce_shares(got, want, rel: float, abs_of_max: float, atol: float = 0.0):
    """(max abs error, largest error as a share of its element's
    tolerance rel * |plain| + abs_of_max * max|plain| + atol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = rel * w.abs() + abs_of_max * w.abs().max() + atol
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


def phase_kernel_ce():
    """The fused cross-entropy kernels (B1 forward, B2 backward) against
    their plain versions on the card, with a random per-row cotangent;
    kernel, plain and library times at the timed shapes."""
    import importlib
    import torch
    import torch.nn.functional as F
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [  # name, T, V, dtype, logits kind, timed
        ("slice", 16384, 32768, f32, "normal", True),
        ("slice", 16384, 32768, bf16, "normal", True),
        ("ragged", 300, 1000, f32, "normal", False),
        ("gpt2_vocab", 4096, 50257, f32, "normal", True),
        ("tiny", 8, 16, f16, "normal", False),
        ("extreme", 64, 4096, f32, "extreme", False),
        ("out_of_range_labels", 256, 1000, f32, "out_of_range", False),
        # rows 4 bytes off a 16-byte boundary, and off their gradient's
        ("offset_view", 512, 1000, bf16, "offset", False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    results = {}
    for name, t, v, dtype, kind, timed in cases:
        dname = str(dtype).split(".")[-1]
        if kind == "offset":
            flat = torch.randn(t * v + 2, device="cuda", generator=gen)
            logits = (3.0 * flat).to(dtype)[2:].view(t, v)
        else:
            logits = (3.0 * torch.randn(t, v, device="cuda", generator=gen)
                      ).to(dtype)
        if kind == "extreme":  # the JAX test's +-1e4 rows
            logits = torch.tensor([1e4, 0.0, -1e4, 5.0], device="cuda"
                                  ).repeat(t, v // 4).to(dtype)
        labels = torch.randint(0, v, (t,), device="cuda", generator=gen,
                               dtype=torch.int32)
        if kind == "out_of_range":
            labels[:6] = torch.tensor([-1, v, v + 7, -1000, 2 ** 31 - 1,
                                       v + 1000], dtype=torch.int32)
        ct = torch.randn(t, device="cuda", generator=gen)
        loss, lse = ce.fused_ce_fwd(logits, labels)
        dlogits = ce.fused_ce_bwd(logits, labels, lse, ct)
        torch.cuda.synchronize()
        rloss, rlse = ce.fused_ce_forward_reference(logits, labels)
        rdl = ce.fused_ce_backward_reference(logits, labels, lse, ct)
        ulp = TRAIN_TOL_ULP[dname]
        errs = {"loss": _ce_shares(loss, rloss, CE_TOL_REL, 0.0, CE_TOL_ABS),
                "lse": _ce_shares(lse, rlse, CE_TOL_REL, 0.0, CE_TOL_ABS),
                "dlogits": _ce_shares(dlogits, rdl, ulp, CE_GRAD_F32)}
        finite = bool(torch.isfinite(loss).all()
                      and torch.isfinite(dlogits).all())
        del rloss, rlse, rdl
        row = {"phase": "kernel_ce", "case": name, "dtype": dname,
               "shape_tv": [t, v], "finite": finite,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()},
               "tol": {"loss_lse": [CE_TOL_REL, CE_TOL_ABS],
                       "dlogits_ulp": ulp, "dlogits_of_max": CE_GRAD_F32}}
        if kind == "out_of_range":
            bad = slice(0, 6)
            row["out_of_range_loss_minus_lse"] = (
                loss[bad] - lse[bad]).abs().max().item()
            check(row["out_of_range_loss_minus_lse"] == 0.0,
                  "out-of-range labels picked a logit")
        if timed:
            es = logits.element_size()
            fwd_bytes = t * v * es + 12 * t
            bwd_bytes = 2 * t * v * es + 12 * t
            bound = {n: _bound(CE_OPS[n] * t * v, nb, PEAK_FLOPS["float32"],
                               "cuda_core")
                     for n, nb in (("fwd", fwd_bytes), ("bwd", bwd_bytes))}
            row["ms"] = {
                "fwd": median_ms(lambda: ce.fused_ce_fwd(logits, labels),
                                 3, 20),
                "bwd": median_ms(lambda: ce.fused_ce_bwd(
                    logits, labels, lse, ct), 3, 20)}
            row["plain_ms"] = {
                "fwd": median_ms(lambda: ce.fused_ce_forward_reference(
                    logits, labels), 1, 5),
                "bwd": median_ms(lambda: ce.fused_ce_backward_reference(
                    logits, labels, lse, ct), 1, 5)}
            # the yardstick, never on the port's path: cross_entropy's
            # forward, and its backward alone on a kept graph
            x = logits.detach().requires_grad_()
            lab64 = labels.long()
            lib = lambda: F.cross_entropy(x, lab64, reduction="none")
            lib_fwd = median_ms(lib, 3, 20)
            lib_out = lib()
            lib_bwd = median_ms(lambda: torch.autograd.grad(
                lib_out, x, ct.to(lib_out.dtype), retain_graph=True), 3, 20)
            del lib_out, x
            row.update({
                "library_ms": {"fwd": lib_fwd, "bwd": lib_bwd},
                "bound_ms": {n: b[0] for n, b in bound.items()},
                "bound_by": {n: b[1] for n, b in bound.items()},
                "bytes": {"fwd": fwd_bytes, "bwd": bwd_bytes},
                "hbm_share_of_peak": {
                    n: b[0] / row["ms"][n] for n, b in bound.items()}})
        emit(row)
        check(finite, f"fused CE {name}/{dname}: non-finite output")
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"fused CE {name}/{dname}: {worst} "
              f"error {errs[worst][1]:.3g}x its tolerance (max abs err "
              f"{errs[worst][0]})")
        results[(name, dname)] = row
        del logits, labels, ct, loss, lse, dlogits
        torch.cuda.empty_cache()
    return results


def phase_memory_ce():
    """Loss forward + backward at the parallel LM's (T, V) in f32: the
    peak allocation above the logits.  The fused route holds the gradient
    and O(T) vectors; the plain route (``log_softmax`` and a gather, the
    model's ``fused_ce=False`` loss) at least one (T, V) f32 more."""
    import importlib
    import torch
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    t, v = PLM_BATCH * PLM["seq_len"], PLM["vocab_size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    logits = torch.randn(t, v, device="cuda", generator=gen)
    logits.requires_grad_(True)
    labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
    tv_bytes = t * v * 4
    fused_limit = tv_bytes + 16 * t * 4
    peaks = {}
    for route in ("fused", "plain"):
        logits.grad = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ce.fused_ce_fwd.launches = ce.fused_ce_bwd.launches = 0
        if route == "fused":
            loss = ce.fused_softmax_cross_entropy(logits, labels).mean()
        else:
            logp = torch.log_softmax(logits, dim=-1)
            loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
            del logp
        loss.backward()
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated() - base
        launches = [ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches]
        check(launches == ([1, 1] if route == "fused" else [0, 0]),
              f"memory_ce {route}: launches {launches}")
        check(bool(torch.isfinite(logits.grad).all()),
              f"memory_ce {route}: non-finite gradient")
        del loss
    emit({"phase": "memory_ce", "shape_tv": [t, v], "dtype": "float32",
          "tv_f32_bytes": tv_bytes,
          "fused_peak_bytes_above_logits": peaks["fused"],
          "fused_limit_bytes": fused_limit,
          "plain_peak_bytes_above_logits": peaks["plain"],
          "peak_in_tv_tensors": {r: p / tv_bytes for r, p in peaks.items()}})
    check(peaks["fused"] <= fused_limit, f"fused CE allocated "
          f"{peaks['fused']} bytes above the logits, over {fused_limit}")
    check(peaks["plain"] >= peaks["fused"] + tv_bytes, f"the plain CE "
          f"allocated {peaks['plain']} bytes, not a (T, V) f32 more than "
          f"the fused {peaks['fused']}")
    del logits
    torch.cuda.empty_cache()


def _draw_leaf(name: str, shape, rng):
    """A leaf drawn from a numpy seed by the JAX init's rules: LayerNorm
    scales ones, biases zeros, ``embed``/``pos`` N(0, 0.02²), the other
    matrices N(0, 1) / sqrt(fan_in)."""
    import numpy as np
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith("ln"):
        return np.ones(shape, np.float32)
    if leaf.startswith("b"):
        return np.zeros(shape, np.float32)
    if leaf in ("embed", "pos"):
        return 0.02 * rng.standard_normal(shape, dtype=np.float32)
    return (rng.standard_normal(shape, dtype=np.float32)
            / np.float32(np.sqrt(shape[-2])))


def _parallel_tree(lm, rng):
    """Weights in the JAX ``ParallelTransformerLM`` tree's layout (nested
    dicts, a list of layers), drawn by :func:`_draw_leaf`."""
    tree = {"layers": [{} for _ in range(lm.num_layers)]}
    for name, shape in lm._shapes().items():
        w = _draw_leaf(name, shape, rng)
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = w
        else:
            tree[name] = w
    return tree


def _zero_counts():
    import importlib
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ce.fused_ce_fwd.launches = ce.fused_ce_bwd.launches = 0
    fa.flash_attention.launches = fa.flash_attention_forward.launches = 0
    fa.flash_attention_backward.dq_launches = 0
    fa.flash_attention_backward.dkv_launches = 0
    for fn in (fa.flash_attention, fa.flash_attention_forward):
        fn.launches_by_variant = dict.fromkeys(fa.FORWARD_VARIANTS, 0)
    for kernel in ("dq", "dkv"):
        setattr(fa.flash_attention_backward, f"{kernel}_launches_by_variant",
                dict.fromkeys(fa.BACKWARD_VARIANTS, 0))


def _read_counts():
    from distkeras_tpu_torch.kernels import launch_counts
    return launch_counts()


def _parallel_route(cfg, tree, toks, labels, after=None, dev="cuda"):
    """Build the LM from ``tree`` on the card and train it PLM_STEPS
    steps through ``compile_train_step``, the counts set to 0 just before
    and read just after; returns (losses, step seconds, launches), and
    with ``after`` also ``after(lm, params, tokens)`` once the counts are
    read."""
    import torch
    from distkeras_tpu_torch.core.optimizers import adam
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              load_jax_params)
    lm = ParallelTransformerLM(**cfg, mesh=Mesh(device=dev))  # the card
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(adam(PLM_LR), params)
    dev = lm.batch_sharding()
    tokens = torch.as_tensor(toks, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    _sync(dev)
    _zero_counts()
    losses, seconds = [], []
    for _ in range(PLM_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = _read_counts()
    losses = [float(x) for x in losses]
    extra = None if after is None else after(lm, params, tokens)
    del params, opt_state, lm
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    if after is None:
        return losses, seconds, launches
    return losses, seconds, launches, extra


def _first_step_parallel_grads(cfg, tree, toks, labels):
    import torch
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              load_jax_params)
    lm = ParallelTransformerLM(**cfg, mesh=Mesh())
    params = load_jax_params(lm, tree)
    dev = lm.batch_sharding()
    loss = lm._loss(params, torch.as_tensor(toks, device=dev),
                    torch.as_tensor(labels, device=dev))
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def phase_parallel_train(card: str):
    """The full-width ParallelTransformerLM (bf16) from one numpy-seeded
    weight set, PLM_STEPS steps on each route, and the f32 pair (fused
    and plain CE) at PLM_F32_LAYERS layers."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
    rng = np.random.default_rng(SEED + 5)
    v, s = PLM["vocab_size"], PLM["seq_len"]
    toks = rng.integers(0, v, (PLM_BATCH, s)).astype(np.int32)
    labels = (toks + 1) % v
    tokens_per_step = PLM_BATCH * s
    bf16 = {**PLM, "compute_dtype": "bfloat16"}
    tree = _parallel_tree(ParallelTransformerLM(
        **bf16, mesh=Mesh(device="meta")), rng)
    runs = {}
    for route, extra in PLM_ROUTES.items():
        losses, seconds, launches = _parallel_route(
            {**bf16, **extra}, tree, toks, labels)
        runs[route] = (losses, launches)
        fused = extra["fused_ce"]
        ulysses = extra.get("sp_impl") == "ulysses"
        flash_want = PLM["num_layers"] * PLM_STEPS if ulysses else 0
        step_ms = statistics.median(seconds[1:]) * 1e3
        emit({"phase": "parallel_train", "route": route,
              "compute_dtype": "bfloat16", "config": PLM,
              "batch": PLM_BATCH, "steps": PLM_STEPS, "losses": losses,
              "last_over_first": losses[-1] / losses[0],
              "launches": launches, "card": card,
              "first_step_ms": seconds[0] * 1e3, "ms_per_step": step_ms,
              "tokens_per_s": tokens_per_step / (step_ms / 1e3)})
        tag = f"parallel_train {route}"
        check(all(np.isfinite(losses)), f"{tag}: non-finite loss")
        check(losses[-1] < losses[0], f"{tag}: the loss did not fall "
              f"({losses[0]} -> {losses[-1]})")
        want_ce = PLM_STEPS if fused else 0
        check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == want_ce,
              f"{tag}: fused CE launches {launches}, want {want_ce} each")
        check(all(launches[k] == flash_want for k in
                  ("flash_fwd_lse", "flash_dq", "flash_dkv",
                   "flash_fwd_lse_sm90", "flash_dq_sm90", "flash_dkv_sm90"))
              and launches["flash_inference"] == 0
              and launches["flash_fwd_lse_simt"] == 0
              and launches["flash_dq_simt"] == launches["flash_dkv_simt"] == 0,
              f"{tag}: flash launches {launches}, want {flash_want} each, "
              f"every one on the sm90 kernels")
    del tree
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                    / np.abs(np.asarray(b))))
    ce_gap = rel(runs["fused_ring"][0], runs["plain_ring"][0])
    schedule_gap = rel(runs["fused_ulysses"][0], runs["fused_ring"][0])

    # the f32 routes at cut depth: loss traces and first-step gradients,
    # fused vs plain CE (both ring) and Ulysses vs ring (both fused CE)
    f32 = {**PLM, "num_layers": PLM_F32_LAYERS, "compute_dtype": "float32"}
    tree32 = _parallel_tree(ParallelTransformerLM(
        **f32, mesh=Mesh(device="meta")), np.random.default_rng(SEED + 7))
    traces, grads = {}, {}
    for route, extra in PLM_ROUTES.items():
        losses, seconds, launches = _parallel_route(
            {**f32, **extra}, tree32, toks, labels)
        traces[route] = losses
        want_ce = PLM_STEPS if extra["fused_ce"] else 0
        want_flash = (PLM_F32_LAYERS * PLM_STEPS
                      if extra.get("sp_impl") == "ulysses" else 0)
        check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == want_ce
              and all(launches[k] == want_flash for k in
                      ("flash_fwd_lse", "flash_dq", "flash_dkv",
                       "flash_fwd_lse_simt", "flash_dq_simt",
                       "flash_dkv_simt"))
              and launches["flash_fwd_lse_sm90"] == 0
              and launches["flash_dq_sm90"] == launches["flash_dkv_sm90"] == 0,
              f"f32 {route}: launches {launches}, want fused CE {want_ce} "
              f"and flash {want_flash} each, every one on the SIMT "
              f"kernels")
        grads[route] = _first_step_parallel_grads({**f32, **extra}, tree32,
                                                  toks, labels)
    del tree32

    def grad_worst(got, ref):
        gmax = max(g.abs().max().item() for g in ref.values())
        shares = {n: ((got[n] - ref[n]).abs().max().item()
                      / (GRAD_RTOL * ref[n].abs().max().item()
                         + GRAD_ATOL * gmax)) for n in ref}
        worst = max(shares, key=shares.get)
        return worst, shares[worst]

    pairs = {  # name: (route, reference route, loss-trace rtol)
        "ce": ("fused_ring", "plain_ring", PLM_LOSS_RTOL_F32),
        "schedule": ("fused_ulysses", "fused_ring", LOSS_RTOL_F32)}
    f32_rows = {}
    for name, (route, ref, rtol) in pairs.items():
        worst, share = grad_worst(grads[route], grads[ref])
        f32_rows[name] = {"routes": [route, ref],
                          "loss_gap": rel(traces[route], traces[ref]),
                          "loss_rtol": rtol, "grad_worst_tensor": worst,
                          "grad_worst_share_of_tol": share}
    del grads
    torch.cuda.empty_cache()
    emit({"phase": "parallel_train_check",
          "bf16_ce_route_gap": ce_gap, "bf16_ce_band": PLM_CE_BAND_BF16,
          "bf16_schedule_gap": schedule_gap,
          "bf16_schedule_band": PLM_SCHEDULE_BAND_BF16,
          "f32_layers": PLM_F32_LAYERS, "f32_losses": traces,
          "f32": f32_rows, "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL})
    check(ce_gap <= PLM_CE_BAND_BF16, f"bf16 fused vs plain CE loss traces "
          f"differ by {ce_gap} > {PLM_CE_BAND_BF16}")
    check(schedule_gap <= PLM_SCHEDULE_BAND_BF16, f"bf16 Ulysses vs ring "
          f"loss traces differ by {schedule_gap} > {PLM_SCHEDULE_BAND_BF16}")
    for name, r in f32_rows.items():
        check(r["loss_gap"] <= r["loss_rtol"], f"f32 {name} pair {r['routes']}"
              f": loss traces differ by {r['loss_gap']} > {r['loss_rtol']}")
        check(r["grad_worst_share_of_tol"] <= 1.0, f"f32 {name} pair "
              f"{r['routes']}: first-step gradient of "
              f"{r['grad_worst_tensor']} differs "
              f"{r['grad_worst_share_of_tol']:.3g}x its tolerance")
    check(all(t[-1] < t[0] for t in traces.values()),
          f"f32: the loss did not fall: {traces}")
    return {route: launches for route, (_, launches) in runs.items()}


def _sdpa_forward_ms(sdpa) -> dict:
    """SDPA's forward under each backend of SDPA_BACKENDS that takes the
    case (a yardstick only); ms by backend."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:  # a backend that refuses the case warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                times[name.lower()] = median_ms(sdpa, 3, 10)
        except RuntimeError:
            pass
    return times


def phase_wide():
    """A head dim above 256 on the SIMT kernels (WIDE_CASE, f32 and bf16):
    ``attention`` forward and backward through the public entry point,
    its launches counted (the forward with lse, dq and dk/dv once each,
    every one on ``simt``); the inference form; each kernel against its
    plain version on its own inputs under the rules of phases kernel and
    kernel_train, the path's outputs bit-equal to the kernels'; and the
    kernels', plain versions' and SDPA's times (each backend that takes
    D 320) beside the bound."""
    import importlib
    import torch
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.attention import attention
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    name, b, s, h, hkv, d, causal, window = WIDE_CASE
    args = (causal, None, window)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                   generator=gen).to(dtype)
                       for n in (h, hkv, hkv, h))
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        _zero_counts()
        out_path = attention(*leaves, causal=causal, window=window)
        grads = torch.autograd.grad(out_path, leaves, do)
        with torch.no_grad():  # the inference form
            inference = attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launches = _read_counts()
        check(launches["flash_inference"] == 1
              and fa.flash_attention.launches_by_variant["simt"] == 1
              and all(launches[f"flash_{n}_simt"] == 1
                      for n in ("fwd_lse", "dq", "dkv"))
              and all(launches[f"flash_{n}_sm90"] == 0
                      for n in ("fwd_lse", "dq", "dkv")),
              f"wide {name}/{dname}: launches {launches}, want the inference "
              f"forward, the forward with lse, dq and dk/dv once each on "
              f"simt")
        launches["flash_inference_simt"] = fa.flash_attention.\
            launches_by_variant["simt"]
        out, lse = fa.flash_attention_forward(q, k, v, *args)
        fwd_repeat_same = (
            torch.equal(inference, fa.flash_attention(q, k, v, *args))
            and all(map(torch.equal, (out, lse),
                        fa.flash_attention_forward(q, k, v, *args))))
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, *args)
        torch.cuda.synchronize()
        same = (torch.equal(out_path, out)
                and all(torch.equal(g, w) for g, w in zip(grads,
                                                          (dq, dk, dv))))
        repeat_same = _repeat_same(fa, q, k, v, out, lse, do, args,
                                   (dq, delta, dk, dv))
        ref = fa.flash_attention_reference(q, k, v, *args)
        ro, rl = fa.flash_attention_reference(q, k, v, *args,
                                              return_lse=True)
        rq, rdelta = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse,
                                                         do, *args)
        rk, rv = fa.flash_attention_bwd_dkv_reference(q, k, v, lse, do,
                                                      delta, *args)
        rel, atol = KERNEL_TOL[dname]
        diff = (inference.float() - ref.float()).abs()
        errs = {"inference": (diff.max().item(), (diff / (
                    rel * ref.float().abs() + atol)).max().item()),
                "out": _err_share(out, ro, dname),
                "lse": _err_share(lse, rl, "float32"),
                "delta": _err_share(delta, rdelta, "float32"),
                "dq": _err_share(dq, rq, dname),
                "dk": _err_share(dk, rk, dname),
                "dv": _err_share(dv, rv, dname)}
        del ref, ro, rl, rq, rdelta, rk, rv, diff, grads, out_path
        ms = {"fwd": median_ms(lambda: fa.flash_attention(q, k, v, *args),
                               3, 10),
              "fwd_lse": median_ms(lambda: fa.flash_attention_forward(
                  q, k, v, *args), 3, 10),
              "dq": median_ms(lambda: fa.flash_attention_bwd_dq(
                  q, k, v, out, lse, do, *args), 3, 10),
              "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv(
                  q, k, v, lse, do, delta, *args), 3, 10)}
        plain_ms = {
            "fwd": median_ms(lambda: fa.flash_attention_reference(
                q, k, v, *args), 1, 3),
            "fwd_lse": median_ms(lambda: fa.flash_attention_reference(
                q, k, v, *args, return_lse=True), 1, 3),
            "dq": median_ms(lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, *args), 1, 3),
            "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, lse, do, delta, *args), 1, 3)}
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        sdpa_fwd = _sdpa_forward_ms(sdpa)
        sdpa_bwd = _sdpa_backward_ms(sdpa, (qt, kt, vt), do.transpose(1, 2))
        del qt, kt, vt
        pairs = b * h * live_pairs(s, causal, window)
        bounds = {
            "fwd": _flash_bound("fwd", d, pairs, nbytes(q, k, v, out),
                                dname),
            "fwd_lse": _flash_bound("fwd", d, pairs,
                                    nbytes(q, k, v, out, lse), dname),
            "dq": _flash_bound("dq", d, pairs,
                               nbytes(q, k, v, out, do, lse, dq, delta),
                               dname),
            "dkv": _flash_bound("dkv", d, pairs,
                                nbytes(q, k, v, do, lse, delta, dk, dv),
                                dname)}
        row = {"phase": "wide", "case": name, "dtype": dname,
               "shape_bshd": [b, s, h, d], "kv_heads": hkv,
               "causal": causal, "window": window,
               "head_dim_chunks": -(-d // fa.SIMT_HEAD_DIM_CHUNK),
               "variant": fa._forward_variant(dtype, d),
               "bwd_variant": fa._backward_variant(dtype, d),
               "launches": launches, "path_equals_kernels": same,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()},
               "ms": ms, "plain_ms": plain_ms,
               "library_fwd_ms": min(sdpa_fwd.values(), default=None),
               "library_fwd_ms_by_backend": sdpa_fwd,
               "library_bwd_ms": min(sdpa_bwd.values(), default=None),
               "library_bwd_ms_by_backend": sdpa_bwd,
               "bound_ms": {n: bd[0] for n, bd in bounds.items()},
               "bound_by": {n: bd[1] for n, bd in bounds.items()},
               "bound_term": {n: bd[2] for n, bd in bounds.items()},
               "bound_ms_f32_cuda_cores": {n: bd[3] for n, bd in
                                           bounds.items()},
               "bound_ms_split_tf32": {n: bd[4] for n, bd in
                                       bounds.items()},
               "fwd_repeat_bit_identical": fwd_repeat_same,
               "bwd_repeat_bit_identical": repeat_same}
        emit(row)
        check(fwd_repeat_same, f"wide {name}/{dname}: two forward runs on "
              f"the same inputs differ")
        check(repeat_same, f"wide {name}/{dname}: two backward runs on the "
              f"same inputs differ")
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"wide {name}/{dname}: {worst} error "
              f"{errs[worst][1]:.3g}x its tolerance (max abs err "
              f"{errs[worst][0]})")
        check(same, f"wide {name}/{dname}: attention's outputs or gradients "
              f"differ from the kernels' on the same inputs")
        rows[dname] = row
        del q, k, v, do, leaves, inference, out, lse, dq, delta, dk, dv
        torch.cuda.empty_cache()
    return rows


def phase_views():
    """Strided and misaligned views at the public entry points: each view
    case runs forward and backward through ``attention`` or
    ``fused_softmax_cross_entropy``, launches the kernels (counted), gives
    gradients in the views' shapes, is bit-equal to the same call on
    contiguous copies, and holds against the plain versions under the
    rules of phases kernel_train and kernel_ce."""
    import importlib
    import torch
    from distkeras_tpu_torch.ops.attention import attention
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    bf16 = torch.bfloat16
    rows = []

    def attention_case(name, leaf, views, do):
        """``views`` of ``leaf`` through attention, against contiguous
        copies of them and the plain versions."""
        torch.cuda.synchronize()
        _zero_counts()
        out = attention(*views, causal=True)
        (grad,) = torch.autograd.grad(out, leaf, do)
        torch.cuda.synchronize()
        launches = _read_counts()
        copies = tuple(t.detach().clone().requires_grad_() for t in views)
        out_c = attention(*copies, causal=True)
        grads_c = torch.autograd.grad(out_c, copies, do)
        grads_v = torch.autograd.grad(attention(*views, causal=True),
                                      views, do)
        q, k, v = copies
        args = (True, None, None)
        out_k, lse = fa.flash_attention_forward(q, k, v, *args)
        ro = fa.flash_attention_reference(q, k, v, *args)
        rq, rk, rv = fa.flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), out_k, lse, do, *args)
        errs = {"out": _err_share(out, ro, "bfloat16"),
                **{n: _err_share(g, r, "bfloat16")
                   for n, g, r in zip(("dq", "dk", "dv"), grads_v,
                                      (rq, rk, rv))}}
        same = (torch.equal(out, out_c)
                and all(torch.equal(a, c) for a, c in zip(grads_v, grads_c)))
        row = {"phase": "views", "case": name, "dtype": "bfloat16",
               "shape_bshd": list(views[0].shape),
               "kv_shape": list(views[1].shape),
               "view_strides": [list(t.stride()) for t in views],
               "view_offsets_bytes": [t.storage_offset() * t.element_size()
                                      for t in views],
               "launches": launches, "equals_contiguous": same,
               "grad_shape_is_leaf_shape": grad.shape == leaf.shape,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()}}
        emit(row)
        check(launches["flash_fwd_lse"] == launches["flash_dq"]
              == launches["flash_dkv"] == 1,
              f"views {name}: launches {launches}, want one of each")
        check(same and row["grad_shape_is_leaf_shape"], f"views {name}: "
              f"differs from the same call on contiguous copies")
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"views {name}: {worst} error "
              f"{errs[worst][1]:.3g}x its tolerance")
        rows.append(row)

    name, b, s, h, hkv, d = VIEW_QKV_CASE
    qkv = torch.randn(b, s, 3 * h, d, device="cuda", generator=gen).to(bf16)
    qkv.requires_grad_()
    do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(bf16)
    attention_case(name, qkv, qkv.chunk(3, dim=2), do)
    del qkv, do

    name, b, s, h, hkv, d = VIEW_MISALIGNED_CASE
    sizes = (b * s * h * d, b * s * hkv * d, b * s * hkv * d)
    flat = torch.randn(1 + sum(sizes), device="cuda", generator=gen).to(bf16)
    flat.requires_grad_()
    parts = flat[1:].split(sizes)  # each one bf16 element off the boundary
    views = tuple(p.view(b, s, n, d) for p, n in zip(parts, (h, hkv, hkv)))
    check(all(t.data_ptr() % 16 for t in views),
          "views misaligned: a view is not off a 16-byte boundary")
    do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(bf16)
    attention_case(name, flat, views, do)
    del flat, parts, views, do

    name, t, v = VIEW_CE_CASE
    base = 3.0 * torch.randn(v, t, device="cuda", generator=gen)
    base.requires_grad_()
    logits = base.t()  # (T, V), column-major
    labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
    torch.cuda.synchronize()
    _zero_counts()
    loss = ce.fused_softmax_cross_entropy(logits, labels)
    (dbase,) = torch.autograd.grad(loss.sum(), base)
    torch.cuda.synchronize()
    launches = _read_counts()
    copy = logits.detach().contiguous().requires_grad_()
    loss_c = ce.fused_softmax_cross_entropy(copy, labels)
    (dcopy,) = torch.autograd.grad(loss_c.sum(), copy)
    # each plain version on the kernel's own inputs (the backward's on the
    # forward kernel's lse), as in phase kernel_ce
    rloss, _ = ce.fused_ce_forward_reference(copy.detach(), labels)
    _, lse = ce.fused_ce_fwd(copy.detach(), labels)
    rgrad = ce.fused_ce_backward_reference(copy.detach(), labels, lse,
                                           torch.ones_like(rloss))
    errs = {"loss": _ce_shares(loss, rloss, CE_TOL_REL, 0.0, CE_TOL_ABS),
            "dlogits": _ce_shares(dbase.t(), rgrad, 0.0, CE_GRAD_F32)}
    same = torch.equal(loss, loss_c) and torch.equal(dbase.t(), dcopy)
    row = {"phase": "views", "case": name, "dtype": "float32",
           "shape_tv": [t, v], "view_strides": list(logits.stride()),
           "launches": {k: launches[k] for k in ("fused_ce_fwd",
                                                 "fused_ce_bwd")},
           "equals_contiguous": same,
           "grad_shape_is_leaf_shape": dbase.shape == base.shape,
           "max_abs_err": {n: e[0] for n, e in errs.items()},
           "err_share_of_tol": {n: e[1] for n, e in errs.items()}}
    emit(row)
    check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == 1,
          f"views {name}: launches {launches}, want one of each")
    check(same and row["grad_shape_is_leaf_shape"], f"views {name}: differs "
          f"from the same call on a contiguous copy")
    worst = max(errs, key=lambda n: errs[n][1])
    check(errs[worst][1] <= 1.0, f"views {name}: {worst} error "
          f"{errs[worst][1]:.3g}x its tolerance")
    rows.append(row)
    del base, logits, copy, dbase, dcopy, rgrad
    torch.cuda.empty_cache()
    return rows


def _zoo_weights(model, rng):
    """Weights in the JAX package's layout, from a numpy seed: kernels
    (Dense and Conv2D) ~N(0, 2/fan_in), biases and BatchNorm offsets 0,
    BatchNorm scales and variances 1, means 0 (the JAX init's values)."""
    import numpy as np
    from distkeras_tpu_torch.core.model import jax_leaves
    out = []
    for path, p in jax_leaves(model):
        shape = tuple(p.shape)
        if len(shape) >= 2:
            fan_in = float(np.prod(shape[:-1]))
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif path.endswith(("scale", "var")):
            w = np.ones(shape)
        else:
            w = np.zeros(shape)
        out.append(w.astype("float32"))
    return out


def _first_batch_grads(model, x, y):
    """The masked loss of one batch and every parameter's gradient
    (zeros for BatchNorm's statistics), through the trainer's own loss."""
    import torch
    from distkeras_tpu_torch.core.train import (_gradients,
                                                make_masked_loss_fn,
                                                model_params)
    value, _ = make_masked_loss_fn(model, ZOO_TRAINER["loss"])(
        x, y, torch.ones(len(x), device=x.device))
    params = model_params(model)
    return value.item(), dict(zip(params, _gradients(value,
                                                     list(params.values()))))


def _synthetic_rows(rng, rows, features, classes):
    """Rows of a learnable synthetic task: class prototypes plus noise
    in [0, 1], and one-hot labels."""
    import numpy as np
    protos = rng.uniform(0.2, 0.8, (classes, features))
    labels = rng.integers(0, classes, rows)
    x = np.clip(protos[labels] + 0.3 * rng.standard_normal(
        (rows, features)), 0.0, 1.0).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[labels]


def phase_zoo(card: str):
    """The ConvNet/MLP zoo on the card: the MNIST flow at full size
    (examples/s and predict rows/s on the host clock), bf16 against f32
    from the same weights, the blob round trip, the CIFAR-10 ConvNet and
    the Higgs MLP for an epoch, one step of the digits models and of a
    batch-norm stack; no attention or cross-entropy kernel launches on
    any of it."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (AccuracyEvaluator, FittedModel,
                                     LabelIndexTransformer,
                                     MinMaxTransformer, ModelPredictor,
                                     OneHotTransformer, Sequential,
                                     SingleTrainer, load_jax_weights)
    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.core import layers as L
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.core.train import (TrainState, make_train_step,
                                                model_params)
    from distkeras_tpu_torch.data import Dataset, has_real_data, load_mnist
    rng = np.random.default_rng(SEED + 17)

    # the MNIST flow
    train, test = load_mnist(n_train=ZOO_ROWS, n_test=ZOO_TEST_ROWS)
    scale = MinMaxTransformer(0, 1, 0, 255)
    train, test = scale.transform(train), scale.transform(test)
    train = OneHotTransformer(10).transform(train)
    weights = _zoo_weights(models.mnist_convnet("bfloat16", device="meta"),
                           rng)
    model = load_jax_weights(models.mnist_convnet("bfloat16"), weights)
    trainer = SingleTrainer(FittedModel(model), num_epoch=ZOO_EPOCHS,
                            **ZOO_TRAINER)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    fitted = trainer.train(train)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _read_counts()
    history = np.asarray(trainer.get_history())
    epochs = history.reshape(ZOO_EPOCHS, -1).mean(axis=1)
    predictor = ModelPredictor(fitted)
    predictor.predict(test.take(ZOO_BATCH))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predicted = predictor.predict(test)
    predict_s = time.perf_counter() - t0
    accuracy = AccuracyEvaluator().evaluate(
        LabelIndexTransformer().transform(predicted))
    emit({"phase": "zoo", "model": "mnist_convnet",
          "compute_dtype": "bfloat16", "rows": ZOO_ROWS,
          "test_rows": ZOO_TEST_ROWS, "epochs": ZOO_EPOCHS,
          "real_data": has_real_data("mnist"), **ZOO_TRAINER,
          "steps": len(history), "epoch_mean_loss": epochs.tolist(),
          "first_loss": float(history[0]), "last_loss": float(history[-1]),
          "accuracy": accuracy, "launches": launches, "card": card,
          "train_s": train_s,
          "examples_per_s": ZOO_ROWS * ZOO_EPOCHS / train_s,
          "predict_s": predict_s,
          "predict_rows_per_s": ZOO_TEST_ROWS / predict_s})
    check(np.isfinite(history).all(), "zoo mnist: non-finite loss")
    check(epochs[-1] < epochs[0], f"zoo mnist: the epoch mean loss did not "
          f"fall ({epochs.tolist()})")
    check(accuracy >= ZOO_ACCURACY_MIN, f"zoo mnist: accuracy {accuracy} "
          f"below {ZOO_ACCURACY_MIN}")
    check(not any(launches.values()), f"zoo mnist: attention or CE kernel "
          f"launches {launches}, want none")

    # the blob round trip of the trained model
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mnist_convnet.npz")
    fitted.save(path)
    rows = test["features"][:2048]
    same = bool(np.array_equal(FittedModel.load(path).predict(rows),
                               fitted.predict(rows)))
    emit({"phase": "zoo_blob", "path": os.path.relpath(path),
          "bytes": os.path.getsize(path), "bit_identical": same})
    check(same, "zoo blob round trip changed the predictions")

    # bf16 against f32 from the same weights, on the first batch
    x = torch.as_tensor(train["features"][:ZOO_BATCH], device="cuda")
    y = torch.as_tensor(train["label_encoded"][:ZOO_BATCH], device="cuda")
    loss16, g16 = _first_batch_grads(load_jax_weights(
        models.mnist_convnet("bfloat16"), weights), x, y)
    loss32, g32 = _first_batch_grads(load_jax_weights(
        models.mnist_convnet("float32"), weights), x, y)
    shares = {n: ((g16[n] - g32[n]).abs().max()
                  / g32[n].abs().max().clamp_min(1e-30)).item() for n in g32}
    loss_gap = abs(loss16 - loss32) / abs(loss32)
    emit({"phase": "zoo_bf16_vs_f32", "model": "mnist_convnet",
          "batch": ZOO_BATCH, "loss_bf16": loss16, "loss_f32": loss32,
          "loss_gap": loss_gap, "loss_band": ZOO_BF16_LOSS_BAND,
          "grad_gap_of_max": shares, "grad_band": ZOO_BF16_GRAD_BAND})
    check(loss_gap <= ZOO_BF16_LOSS_BAND, f"zoo bf16 vs f32: loss gap "
          f"{loss_gap} > {ZOO_BF16_LOSS_BAND}")
    worst = max(shares, key=shares.get)
    check(shares[worst] <= ZOO_BF16_GRAD_BAND, f"zoo bf16 vs f32: gradient "
          f"of {worst} off by {shares[worst]:.3g} of its max")
    del g16, g32, x, y

    # the CIFAR-10 ConvNet and the Higgs MLP: one epoch, the loss falls
    _zero_counts()
    for name, features, classes in (("cifar10_convnet", 3072, 10),
                                    ("higgs_mlp", 28, 2)):
        xs, ys = _synthetic_rows(rng, ZOO_SMALL_ROWS, features, classes)
        builder = getattr(models, name)
        small = load_jax_weights(builder("bfloat16"), _zoo_weights(
            builder("bfloat16", device="meta"), rng))
        t = SingleTrainer(FittedModel(small), num_epoch=1,
                          **{**ZOO_TRAINER, "batch_size": ZOO_SMALL_BATCH})
        t0 = time.perf_counter()
        t.train(Dataset({"features": xs, "label_encoded": ys}))
        seconds = time.perf_counter() - t0
        losses = np.asarray(t.get_history())
        quarter = len(losses) // 4
        emit({"phase": "zoo", "model": name, "compute_dtype": "bfloat16",
              "rows": ZOO_SMALL_ROWS, "batch_size": ZOO_SMALL_BATCH,
              "steps": len(losses), "first_quarter_loss":
              float(losses[:quarter].mean()), "last_quarter_loss":
              float(losses[-quarter:].mean()), "train_s": seconds,
              "card": card})
        check(np.isfinite(losses).all()
              and losses[-quarter:].mean() < losses[:quarter].mean(),
              f"zoo {name}: the loss did not fall ({losses.tolist()})")

    # one step of the digits models and of a batch-norm stack
    stacks = {
        "digits_mlp": models.digits_mlp("bfloat16"),
        "digits_convnet": models.digits_convnet("bfloat16"),
        "batchnorm_stack": Sequential(
            [L.Reshape((8, 8, 1)), L.Conv2D(16, 3, use_bias=False),
             L.BatchNormalization(), L.AveragePooling2D(2),
             L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")],
            input_shape=(64,), compute_dtype="bfloat16")}
    for name, net in stacks.items():
        load_jax_weights(net, _zoo_weights(net, rng))
        xs, ys = _synthetic_rows(rng, ZOO_SMALL_BATCH, 64, 10)
        x = torch.as_tensor(xs, device="cuda")
        y = torch.as_tensor(ys, device="cuda")
        params = model_params(net)
        tx, opt_state = optimizers.build("adam", params, learning_rate=1e-3)
        before = net.get_weights()
        _, loss = make_train_step(net, ZOO_TRAINER["loss"], tx)(
            TrainState(params, opt_state, 0), (x, y))
        with torch.no_grad():
            out = net(x)
        moved = {path: not np.array_equal(a, b) for (path, _), a, b in zip(
            model_params(net).items(), net.get_weights(), before)}
        stats_moved = [m for path, m in moved.items() if "/stats/" in path]
        emit({"phase": "zoo_step", "model": name, "loss": loss.item(),
              "outputs_finite": bool(torch.isfinite(out).all()),
              "stats_moved": stats_moved})
        check(bool(torch.isfinite(out).all()) and np.isfinite(loss.item()),
              f"zoo step {name}: non-finite outputs or loss")
        check(all(stats_moved), f"zoo step {name}: BatchNorm running "
              f"statistics did not move ({moved})")
    launches = _read_counts()
    check(not any(launches.values()), f"zoo models: attention or CE kernel "
          f"launches {launches}, want none")
    return {"train_s": train_s, "accuracy": accuracy}


def _adag_rows(rows):
    """MNIST rows as bench.py feeds them: features scaled by 1/255,
    one-hot labels (load_mnist's synthetic stand-in where no mnist.npz is
    found)."""
    import numpy as np
    from distkeras_tpu_torch.data import load_mnist
    train, _ = load_mnist(n_train=rows)
    x = np.asarray(train["features"], np.float32) / 255.0
    y = np.eye(10, dtype=np.float32)[np.asarray(train["label"])]
    return x, y


def _epoch_means(history, epochs):
    import numpy as np
    return np.asarray(history, np.float64).reshape(epochs, -1).mean(axis=1)


def _adag_north_star(card: str, dev: str):
    """examples/sec/chip of the north-star workload, bench.py's metric,
    through the port's SPMDEngine on the card."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.data import has_real_data
    from distkeras_tpu_torch.metrics import flops_per_example, peak_flops
    from distkeras_tpu_torch.parallel import (SPMDEngine, get_mesh,
                                              shape_epoch_data)
    mesh = get_mesh() if dev == "cuda" else get_mesh(devices=[dev])
    n = mesh.size
    model = models.mnist_convnet("bfloat16", device=dev)
    engine = SPMDEngine(model, "categorical_crossentropy", "adam", mesh,
                        "adag", communication_window=ADAG_WINDOW)
    x, y = _adag_rows(ADAG_ROWS)
    xb, yb, mb, rounds = shape_epoch_data(x, y, n, ADAG_WINDOW, ADAG_BATCH)
    state = engine.init_state(torch.Generator().manual_seed(SEED), (784,))
    rngs = engine.worker_rngs(SEED)
    # the whole epoch lives on the card across epochs
    xb = torch.as_tensor(xb, device=dev)
    yb = torch.as_tensor(yb, device=dev)
    state, warm = engine.run_epoch(state, xb, yb, mb, rngs)
    warm = warm.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(ADAG_EPOCHS):
        state, losses = engine.run_epoch(state, xb, yb, mb, rngs)
    losses = losses.cpu().numpy()  # the one host sync of the timed run
    seconds = time.perf_counter() - t0
    eps_per_chip = ADAG_EPOCHS * len(x) / seconds / n
    kind = torch.cuda.get_device_name(0) if dev == "cuda" else dev
    flops = flops_per_example(model, backward=True)
    peak = peak_flops(kind)
    row = {"metric": "examples_per_sec_per_chip_mnist_convnet_adag",
           "value": eps_per_chip, "unit": "examples/sec/chip",
           "mfu": eps_per_chip * flops / peak if peak else None,
           "platform": "gpu" if dev == "cuda" else dev,
           "device_kind": kind,
           "data": "real" if has_real_data("mnist") else "synthetic",
           "compute_dtype": "bfloat16", "batch": ADAG_BATCH,
           "window": ADAG_WINDOW, "rows": len(x), "workers": n,
           "rounds_per_epoch": rounds, "epochs_timed": ADAG_EPOCHS,
           "seconds": seconds, "flops_per_example": flops,
           "warmup_epoch_loss": [float(warm[0]), float(warm[-1])],
           "last_epoch_loss": [float(losses[0]), float(losses[-1])],
           "card": card}
    emit({"phase": "adag", **row})
    check(np.isfinite(warm).all() and np.isfinite(losses).all(),
          "adag north star: non-finite loss")
    check(losses.mean() < warm[0], f"adag north star: the loss did not "
          f"fall ({warm[0]} -> {losses.mean()})")
    return row


def _adag_recipe(card: str, dev: str):
    """The verify recipe through the ADAG trainer, 8 workers on the
    card: MinMax -> OneHot -> ADAG -> ModelPredictor -> LabelIndex ->
    Accuracy."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (ADAG, AccuracyEvaluator,
                                     LabelIndexTransformer,
                                     MinMaxTransformer, ModelPredictor,
                                     OneHotTransformer, models)
    from distkeras_tpu_torch.data import load_mnist
    from distkeras_tpu_torch.parallel import get_mesh
    train, test = load_mnist(n_train=RECIPE_ROWS, n_test=RECIPE_TEST_ROWS)
    scale = MinMaxTransformer(0, 1, 0, 255)
    train, test = scale.transform(train), scale.transform(test)
    train = OneHotTransformer(10).transform(train)
    t = ADAG(models.mnist_convnet("float32", device=dev),
             mesh=get_mesh(RECIPE["num_workers"], devices=[dev] * 8),
             **{k: v for k, v in RECIPE.items() if k != "num_workers"})
    t0 = time.perf_counter()
    fitted = t.train(train)
    seconds = time.perf_counter() - t0
    accuracy = AccuracyEvaluator().evaluate(LabelIndexTransformer().transform(
        ModelPredictor(fitted, device=dev).predict(test)))
    epochs = _epoch_means(t.get_history(), RECIPE["num_epoch"])
    emit({"phase": "adag_recipe", "model": "mnist_convnet",
          "compute_dtype": "float32", "rows": RECIPE_ROWS,
          "test_rows": RECIPE_TEST_ROWS, **RECIPE,
          "rounds": len(t.get_history()), "epoch_mean_loss": epochs.tolist(),
          "accuracy": accuracy, "train_s": seconds, "card": card})
    check(np.isfinite(epochs).all() and epochs[-1] < epochs[0],
          f"adag recipe: the loss did not fall ({epochs.tolist()})")
    check(accuracy >= ZOO_ACCURACY_MIN, f"adag recipe: accuracy {accuracy} "
          f"below {ZOO_ACCURACY_MIN}")
    return accuracy


def _adag_algorithms(card: str, dev: str):
    """DOWNPOUR, DynSGD, AEASGD, EAMSGD, Averaging and Ensemble, 4
    workers on the card: the loss is finite and falls; then ADAG over a
    batch-norm stack, whose statistics reach the center."""
    import numpy as np
    import torch
    import distkeras_tpu_torch as port
    from distkeras_tpu_torch import Dataset, Sequential, models
    from distkeras_tpu_torch.core import layers as L
    from distkeras_tpu_torch.parallel import get_mesh
    x, y = _adag_rows(ALGO_ROWS)
    data = Dataset({"features": x, "label_encoded": y})
    common = dict(batch_size=64, num_epoch=ALGO_EPOCHS,
                  label_col="label_encoded")
    out = {}
    for name, kw in ALGO_RUNS.items():
        t = getattr(port, name)(
            models.mnist_mlp("bfloat16", device=dev),
            mesh=get_mesh(ALGO_WORKERS, devices=[dev] * ALGO_WORKERS),
            **common, **kw)
        t0 = time.perf_counter()
        result = t.train(data)
        seconds = time.perf_counter() - t0
        epochs = _epoch_means(t.get_history(), ALGO_EPOCHS)
        members = len(result) if isinstance(result, list) else 1
        emit({"phase": "adag_algorithm", "trainer": name,
              "model": "mnist_mlp", "compute_dtype": "bfloat16",
              "workers": ALGO_WORKERS, "rows": ALGO_ROWS, **common, **kw,
              "rounds": len(t.get_history()), "members": members,
              "epoch_mean_loss": epochs.tolist(), "train_s": seconds,
              "card": card})
        check(np.isfinite(epochs).all() and epochs[-1] < epochs[0],
              f"adag {name}: the loss did not fall ({epochs.tolist()})")
        out[name] = epochs.tolist()

    net = Sequential([L.Reshape((28, 28, 1)), L.Conv2D(8, 3),
                      L.BatchNormalization(), L.MaxPooling2D(2), L.Flatten(),
                      L.Dense(10, activation="softmax")],
                     input_shape=(784,), compute_dtype="bfloat16",
                     device=dev)
    t = port.ADAG(net, mesh=get_mesh(ALGO_WORKERS,
                                     devices=[dev] * ALGO_WORKERS),
                  communication_window=4, worker_optimizer="adam",
                  learning_rate=1e-3, **{**common, "num_epoch": 1})
    t.train(data)
    center, local = t._state.center, t._state.local
    stats = [k for k in center if "/stats/" in k]
    initial = {k: (1.0 if k.endswith("var") else 0.0) for k in stats}
    moved = {k: float((center[k] - initial[k]).abs().max()) for k in stats}
    synced = all(torch.equal(w[k], center[k]) for w in local for k in stats)
    finite = all(bool(torch.isfinite(center[k]).all()) for k in stats)
    emit({"phase": "adag_batchnorm", "stats": stats,
          "moved_from_init_max": moved, "workers_equal_center": synced,
          "finite": finite, "rounds": len(t.get_history()),
          "last_loss": t.get_history()[-1], "card": card})
    check(len(stats) == 2 and finite and all(v > 0 for v in moved.values()),
          f"adag batchnorm: the center's statistics did not move ({moved})")
    check(synced, "adag batchnorm: a worker's statistics differ from the "
          "center's after the sync")
    return out


def _adag_card_vs_cpu(card: str, dev: str):
    """One f32 ADAG epoch (4 workers, mnist_mlp) from one numpy weight set,
    on the card and through the port on the CPU; on the card also streamed
    round by round (``run_epoch_streaming`` over ``round_stream``, pinned
    non-blocking copies), which must equal ``run_epoch`` to the bit."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, models
    from distkeras_tpu_torch.data.pipeline import round_stream
    from distkeras_tpu_torch.parallel import (SPMDEngine, get_mesh,
                                              shape_epoch_data)
    x, y = _adag_rows(CARD_CPU_ROWS)
    weights = _zoo_weights(models.mnist_mlp("float32", device="meta"),
                           np.random.default_rng(SEED + 23))
    xb, yb, mb, rounds = shape_epoch_data(x, y, 4, 4, 32)
    runs = {}
    for key, where in (("card", dev), ("cpu", "cpu"), ("stream", dev)):
        # a fresh model each time: a run leaves a worker's params in it
        model = load_jax_weights(models.mnist_mlp("float32", device=where),
                                 weights)
        engine = SPMDEngine(model, "categorical_crossentropy", "adam",
                            get_mesh(4, devices=[where] * 4), "adag",
                            communication_window=4, learning_rate=1e-3)
        state, rngs = engine.init_state(), engine.worker_rngs(SEED)
        if key == "stream":
            state, losses = engine.run_epoch_streaming(
                state, round_stream(x, y, 4, 4, 32), rngs)
        else:
            state, losses = engine.run_epoch(state, xb, yb, mb, rngs)
            losses = losses.cpu().numpy()
        runs[key] = (losses, {k: v.cpu().numpy()
                              for k, v in state.center.items()})
    (l_card, c_card), (l_cpu, c_cpu) = runs["card"], runs["cpu"]
    l_stream, c_stream = runs["stream"]
    stream_same = (np.array_equal(l_stream, l_card)
                   and all(np.array_equal(c_stream[k], c_card[k])
                           for k in c_card))
    loss_gap = float(np.max(np.abs(l_card - l_cpu) / np.abs(l_cpu)))
    param_gap = {k: float(np.max(np.abs(c_card[k] - c_cpu[k]))
                          / max(float(np.max(np.abs(c_cpu[k]))), 1e-30))
                 for k in c_cpu}
    worst = max(param_gap, key=param_gap.get)
    emit({"phase": "adag_card_vs_cpu", "model": "mnist_mlp",
          "compute_dtype": "float32", "rounds": rounds,
          "loss_card": l_card.tolist(), "loss_cpu": l_cpu.tolist(),
          "loss_gap": loss_gap, "loss_band": CARD_CPU_LOSS_BAND,
          "param_gap_of_max": param_gap, "param_band": CARD_CPU_PARAM_BAND,
          "streamed_equals_run_epoch": stream_same, "card": card})
    check(stream_same, "adag streaming: run_epoch_streaming differs from "
          "run_epoch on the card")
    check(loss_gap <= CARD_CPU_LOSS_BAND, f"adag card vs cpu: loss gap "
          f"{loss_gap} > {CARD_CPU_LOSS_BAND}")
    check(param_gap[worst] <= CARD_CPU_PARAM_BAND, f"adag card vs cpu: "
          f"center {worst} off by {param_gap[worst]:.3g} of its max")
    return loss_gap, param_gap[worst]


def _adag_resume(card: str, dev: str):
    """A round-unit checkpoint resume on the card: ADAG (4 workers,
    mnist_mlp f32, 8 rounds over 2 epochs) killed after round 7 and
    resumed gives the uninterrupted run's weights to the bit."""
    import shutil
    import numpy as np
    import torch
    from distkeras_tpu_torch import ADAG, Dataset, models
    from distkeras_tpu_torch.checkpoint import Checkpointer
    from distkeras_tpu_torch.parallel import get_mesh
    x, y = _adag_rows(1024)
    data = Dataset({"features": x, "label_encoded": y})
    kw = dict(batch_size=32, num_epoch=2, communication_window=2,
              label_col="label_encoded", worker_optimizer="adam",
              learning_rate=1e-3, seed=3)

    def trainer(**extra):
        return ADAG(models.mnist_mlp("float32", device=dev),
                    mesh=get_mesh(4, devices=[dev] * 4), **kw, **extra)
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke", "adag_round_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    full = trainer().train(data, shuffle=True).get_weights()
    ckpt = dict(checkpoint_dir=ck_dir, checkpoint_unit="round",
                checkpoint_every=1)
    first = trainer(**ckpt).train(data, shuffle=True).get_weights()
    ck = Checkpointer(ck_dir)
    last = ck.latest_step()
    os.unlink(ck._path(last))  # a kill after the round before the last
    resumed_trainer = trainer(**ckpt)
    resumed = resumed_trainer.train(data, shuffle=True,
                                    resume=True).get_weights()
    same_round_mode = all(np.array_equal(a, b) for a, b in zip(full, first))
    same_resumed = all(np.array_equal(a, b) for a, b in zip(full, resumed))
    emit({"phase": "adag_resume", "rounds": last,
          "resumed_rounds": len(resumed_trainer.get_history()),
          "round_unit_equals_epoch_unit": same_round_mode,
          "resume_bit_identical": same_resumed, "card": card})
    check(same_round_mode, "adag resume: the round-unit run differs from "
          "the epoch-unit run")
    check(same_resumed and len(resumed_trainer.get_history()) == 1,
          "adag resume: the resumed run is not bit-identical")
    shutil.rmtree(ck_dir, ignore_errors=True)
    return same_resumed


def phase_adag(card: str, dev: str = "cuda"):
    """The SPMD engine and the distributed trainers on the card: the
    north-star workload at full size, the verify recipe, every other
    algorithm, a batch-norm stack, card against CPU and a streamed epoch,
    a round-unit resume; no attention or cross-entropy kernel launches on
    any of it.  ``dev`` is the card; another device only rehearses the
    phase at a cut size."""
    _zero_counts()
    row = _adag_north_star(card, dev)
    _adag_recipe(card, dev)
    _adag_algorithms(card, dev)
    _adag_card_vs_cpu(card, dev)
    _adag_resume(card, dev)
    launches = _read_counts()
    emit({"phase": "adag_launches", "launches": launches})
    check(not any(launches.values()), f"adag: attention or CE kernel "
          f"launches {launches}, want none")
    return row


def _sync(dev: str) -> None:
    """Wait for the card (a rehearsal on the CPU has nothing to wait
    for)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _pack_corpus(rng):
    """PACK_DOCS documents of the x+1 task packed into rows of the LM's
    seq; the first PACK_ROWS rows, their segment ids and packed labels."""
    import numpy as np
    from distkeras_tpu_torch.data.packing import (pack_documents,
                                                  packed_lm_labels)
    v, (lo, hi) = LM["vocab_size"], PACK_DOC_LEN
    docs = [((int(rng.integers(0, v)) + np.arange(int(rng.integers(
        lo, hi + 1)))) % v).tolist() for _ in range(PACK_DOCS)]
    tokens, segs = pack_documents(docs, LM["seq_len"])
    check(len(tokens) >= PACK_ROWS, f"pack: {len(tokens)} rows packed, "
          f"want {PACK_ROWS}")
    tokens, segs = tokens[:PACK_ROWS], segs[:PACK_ROWS]
    return tokens, segs, packed_lm_labels(tokens, segs)


def _pack_isolation(card: str, dev: str, tokens, segs, rng):
    """Each document of the first packed row: its logits in the packed
    forward against its own forward, at f32 and bf16."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    cfg = dict(PACK_LM, num_layers=PACK_ISO_LAYERS)
    weights = _random_jax_weights(transformer_lm(**cfg, device="meta"), rng)
    ids = [int(i) for i in np.unique(segs[0]) if i]
    for dtype in ("float32", "bfloat16"):
        model = transformer_lm(**{**cfg, "compute_dtype": dtype}, device=dev)
        load_jax_weights(model, weights)
        row = torch.as_tensor(tokens[:1], device=dev)
        with torch.no_grad():
            packed = model(row, segment_ids=torch.as_tensor(
                segs[:1], device=dev))[0]
            worst = 0.0
            for i in ids:
                at = np.flatnonzero(segs[0] == i)
                lo, hi = int(at[0]), int(at[-1]) + 1
                solo = model(row[:, lo:hi])[0]
                worst = max(worst,
                            (packed[lo:hi] - solo).abs().max().item())
        emit({"phase": "pack_isolation", "compute_dtype": dtype,
              "layers": PACK_ISO_LAYERS, "documents": len(ids),
              "doc_lengths": [int((segs[0] == i).sum()) for i in ids],
              "max_abs_diff": worst, "tol": PACK_ISO_TOL[dtype],
              "finite": bool(torch.isfinite(packed).all()), "card": card})
        check(len(ids) >= 2, f"pack: the first row holds {len(ids)} document")
        check(worst <= PACK_ISO_TOL[dtype], f"pack {dtype}: a packed "
              f"document's logits differ from its own forward by {worst} > "
              f"{PACK_ISO_TOL[dtype]}")
        del model, packed
        torch.cuda.empty_cache()


def phase_pack(card: str, dev: str = "cuda"):
    """Sequence packing on the card: the packed corpus and its efficiency,
    document isolation of the packed forward, SingleTrainer and the packed
    SPMD engine (ADAG) with ``segment_col``, and no kernel launched by
    either run (packed batches take the plain attention path, as the
    reference's take XLA's)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (ADAG, Dataset, FittedModel,
                                     SingleTrainer, load_jax_weights,
                                     transformer_lm)
    from distkeras_tpu_torch.data.packing import packing_efficiency
    from distkeras_tpu_torch.parallel import get_mesh
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    tokens, segs, labels = _pack_corpus(rng)
    emit({"phase": "pack_corpus", "documents": PACK_DOCS,
          "doc_len_range": list(PACK_DOC_LEN), "rows": len(tokens),
          "seq_len": LM["seq_len"],
          "documents_in_rows": int(sum(len(np.unique(r[r > 0]))
                                       for r in segs)),
          "packing_efficiency": packing_efficiency(segs),
          "label_share": float((labels >= 0).mean())})
    _pack_isolation(card, dev, tokens, segs, rng)

    weights = _random_jax_weights(transformer_lm(**PACK_LM, device="meta"),
                                  rng)
    model = transformer_lm(**PACK_LM, device=dev)
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    data = Dataset({"features": tokens, "label": labels,
                    "segment_ids": segs})
    kw = dict(TRAINER, loss=PACK_LOSS, segment_col="segment_ids",
              device=dev)
    SingleTrainer(fitted, **{**kw, "num_epoch": 1}).train(
        Dataset({c: data[c][:BATCH] for c in data.columns}))  # warm-up
    _sync(dev)
    _zero_counts()
    trainer = SingleTrainer(fitted, **kw)
    t0 = time.perf_counter()
    trainer.train(data)
    _sync(dev)
    seconds = time.perf_counter() - t0
    hist = np.asarray(trainer.get_history())
    steps = len(hist)
    adag = ADAG(fitted, mesh=get_mesh(PACK_ADAG_WORKERS,
                                      devices=[dev] * PACK_ADAG_WORKERS),
                batch_size=PACK_ADAG_BATCH, num_epoch=1,
                communication_window=PACK_ADAG_WINDOW, loss=PACK_LOSS,
                worker_optimizer="adam", learning_rate=3e-3,
                segment_col="segment_ids")
    t0 = time.perf_counter()
    adag.train(data)
    _sync(dev)
    adag_seconds = time.perf_counter() - t0
    rounds = np.asarray(adag.get_history())
    launches = _read_counts()
    emit({"phase": "pack_train", "compute_dtype": LM["compute_dtype"],
          "rows": len(tokens), "batch_size": BATCH, "steps": steps,
          "losses": hist.tolist(),
          "last_over_first": float(hist[-1] / hist[0]),
          "ms_per_step": seconds / steps * 1e3,
          "tokens_per_s": float((labels >= 0).sum()) * TRAIN_EPOCHS
          / seconds,
          "adag": {"workers": PACK_ADAG_WORKERS,
                   "window": PACK_ADAG_WINDOW,
                   "batch_size": PACK_ADAG_BATCH,
                   "round_losses": rounds.tolist(),
                   "seconds": adag_seconds},
          "launches": launches, "card": card})
    check(steps == TRAIN_EPOCHS * PACK_ROWS // BATCH,
          f"pack: {steps} SingleTrainer steps")
    check(bool(np.isfinite(hist).all()) and hist[-1] < LOSS_DROP * hist[0],
          f"pack: the packed loss did not fall below {LOSS_DROP} of the "
          f"first ({hist.tolist()})")
    want_rounds = -(-len(tokens) // (PACK_ADAG_WORKERS * PACK_ADAG_WINDOW
                                     * PACK_ADAG_BATCH))
    check(len(rounds) == want_rounds and bool(np.isfinite(rounds).all()),
          f"pack: packed ADAG round losses {rounds.tolist()}, want "
          f"{want_rounds} rounds")
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"pack: attention or CE kernel launches {launches}, want none")
    emit({"phase": "pack_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return launches


def _decode_timing(card: str, dev: str):
    """The four configurations of scripts/bench_kernels.py's decode
    bench: DECODE_STEPS greedy steps at batch DECODE_BATCH."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (FittedModel, load_jax_weights,
                                     transformer_lm)
    from distkeras_tpu_torch.core.decode import init_cache, jit_decode_step
    rng = np.random.default_rng(SEED + 12)
    rows = {}
    for name, (extra, rolling, int8) in DECODE_CONFIGS.items():
        model = transformer_lm(**LM, **extra, device=dev)
        load_jax_weights(model, _random_jax_weights(model, rng))
        if int8:
            model = FittedModel(model).quantize().model
        slots = extra["attention_window"] if rolling else LM["seq_len"]
        caches = init_cache(model, DECODE_BATCH, slots, rolling=rolling)
        step = jit_decode_step(model, rolling=rolling)
        start = LM["seq_len"] - 1 if rolling else 0

        def run(steps=DECODE_STEPS):
            nonlocal caches
            tok = torch.zeros(DECODE_BATCH, dtype=torch.int32, device=dev)
            for i in range(steps):
                logits, caches = step(caches, tok,
                                      start + (0 if rolling else i))
                tok = torch.argmax(logits, -1).to(torch.int32)
            return logits

        logits = run(DECODE_WARMUP_STEPS)  # warm-up
        _sync(dev)
        times = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            logits = run()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        rows[name] = {"phase": "decode_timing", "cache": name,
                      "compute_dtype": LM["compute_dtype"],
                      "batch": DECODE_BATCH, "steps": DECODE_STEPS,
                      "cache_slots": slots, "int8_weights": int8,
                      "tokens_per_sec": DECODE_BATCH * DECODE_STEPS / t,
                      "ms_per_step": t / DECODE_STEPS * 1e3,
                      "runs_s": times,
                      "finite": bool(torch.isfinite(logits).all()),
                      "card": card}
        emit(rows[name])
        check(rows[name]["finite"], f"decode {name}: non-finite logits")
        del model, caches
    return rows


def _decode_models(extra, rng, dev: str, layers=None):
    """An f32 LM on ``dev`` with random weights, the same weights on the
    plain attention route (the full-forward reference), and on the CPU."""
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    cfg = dict(LM, compute_dtype="float32", **extra)
    if layers is not None:
        cfg["num_layers"] = layers
    weights = _random_jax_weights(transformer_lm(**cfg, device="meta"), rng)
    out = []
    for kw in (dict(device=dev), dict(device=dev, attention_impl="xla"),
               dict(device="cpu")):
        model = transformer_lm(**cfg, **kw)
        load_jax_weights(model, weights)
        out.append(model)
    return out


def _first_difference(plain, got, want, p_len: int) -> dict:
    """Where two token paths first part, and the gap of the top two
    logits of the full forward there."""
    import torch
    bad = (got != want).nonzero()
    r, c = (int(v) for v in bad[0])
    with torch.no_grad():
        logits = plain(got[r:r + 1, :c].to(plain.device))[0, -1]
    top = torch.topk(logits, 2).values
    return {"row": r, "position": c, "generated_index": c - p_len,
            "top2_logit_gap": float(top[0] - top[1])}


def _decode_checks(card: str, dev: str):
    """At f32: cached logits against the full forward, generate on the
    card against generate on the CPU (both forms), beam search,
    speculative decoding; at bf16: int8 weights."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import FittedModel
    from distkeras_tpu_torch.core import decode
    from distkeras_tpu_torch.core.quant import quantized_bytes
    rng = np.random.default_rng(SEED + 13)
    v, p_len = LM["vocab_size"], DECODE_PROMPT
    ids = rng.integers(0, v, (DECODE_ROWS, p_len + DECODE_FORCED)).astype(
        np.int32)
    toks = torch.as_tensor(ids, device=dev)
    prompt = toks[:, :p_len]
    for form, extra in FORMS.items():
        rolling = "attention_window" in extra
        model, plain, cpu = _decode_models(extra, rng, dev)
        with torch.no_grad():
            full = plain(toks)
        # the cached steps, teacher-forced: prefill, then single tokens
        caches = decode.init_cache(model, DECODE_ROWS,
                                   p_len if rolling else toks.shape[1])
        logits, caches = decode._forward(model, caches, prompt, 0)
        worst = (logits - full[:, :p_len]).abs().max().item()
        if rolling:
            w = extra["attention_window"]
            caches = [None if c is None else
                      {n: decode._to_ring(t, p_len, w) for n, t in c.items()}
                      for c in caches]
        for i in range(DECODE_FORCED - 1):
            step, caches = decode.decode_step(model, caches,
                                              toks[:, p_len + i], p_len + i,
                                              rolling)
            worst = max(worst,
                        (step - full[:, p_len + i]).abs().max().item())
        emit({"phase": "decode_cached_logits", "form": form,
              "compute_dtype": "float32", "rows": DECODE_ROWS,
              "prompt": p_len, "steps": DECODE_FORCED - 1,
              "rolling": rolling, "max_abs_diff": worst,
              "tol": DECODE_LOGIT_TOL_F32, "card": card})
        check(worst <= DECODE_LOGIT_TOL_F32, f"decode {form}: cached logits "
              f"differ from the full forward by {worst}")
        # generate on the card against generate on the CPU
        t0 = time.perf_counter()
        got = decode.generate(model, prompt, DECODE_CONT, rolling=rolling)
        _sync(dev)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = decode.generate(cpu, prompt.cpu(), DECODE_CONT,
                               rolling=rolling)
        cpu_s = time.perf_counter() - t0
        same = bool(torch.equal(got.cpu(), want))
        row = {"phase": "decode_card_vs_cpu", "form": form,
               "compute_dtype": "float32", "rows": DECODE_ROWS,
               "prompt": p_len, "steps": DECODE_CONT, "rolling": rolling,
               "identical": same, "card_s": card_s, "cpu_s": cpu_s,
               "card": card}
        if not same:
            row["first_difference"] = _first_difference(plain, got.cpu(),
                                                        want, p_len)
        emit(row)
        check(same, f"decode {form}: generate on the card differs from "
              f"the CPU: {row.get('first_difference')}")
        del model, plain, cpu, caches, full
        torch.cuda.empty_cache()

    model, plain, _ = _decode_models(FORMS["full"], rng, dev)
    short = prompt[:, :BEAM_PROMPT]
    greedy = decode.generate(model, short, BEAM_STEPS)
    one, _ = decode.beam_search(model, short, BEAM_STEPS, num_beams=1)
    beams, scores = decode.beam_search(model, short, BEAM_STEPS,
                                       num_beams=BEAM_WIDTH)
    seqs = beams.reshape(-1, beams.shape[-1]).long()
    with torch.no_grad():
        logp = torch.log_softmax(plain(seqs), dim=-1)
    want = logp[:, BEAM_PROMPT - 1:-1].gather(
        -1, seqs[:, BEAM_PROMPT:, None])[..., 0].sum(-1)
    score_diff = (scores.reshape(-1) - want).abs().max().item()
    emit({"phase": "decode_beam", "compute_dtype": "float32",
          "rows": DECODE_ROWS, "prompt": BEAM_PROMPT, "steps": BEAM_STEPS,
          "num_beams": BEAM_WIDTH, "scores": scores.tolist(),
          "beam1_equals_greedy": bool(torch.equal(one[:, 0], greedy)),
          "score_max_abs_diff": score_diff, "tol": BEAM_SCORE_TOL,
          "card": card})
    check(bool(torch.equal(one[:, 0], greedy)),
          "decode: beam search with one beam differs from greedy")
    check(score_diff <= BEAM_SCORE_TOL, f"decode: beam scores differ from "
          f"the full forward's log-probabilities by {score_diff}")

    draft, _, _ = _decode_models(FORMS["full"], rng, dev,
                                 layers=SPEC_DRAFT_LAYERS)
    t0 = time.perf_counter()
    spec, stats = decode.speculative_generate(
        model, draft, short, BEAM_STEPS, draft_len=SPEC_DRAFT_LEN,
        return_stats=True)
    _sync(dev)
    spec_s = time.perf_counter() - t0
    same = bool(torch.equal(spec, greedy))
    row = {"phase": "decode_speculative", "compute_dtype": "float32",
           "rows": DECODE_ROWS, "prompt": BEAM_PROMPT, "steps": BEAM_STEPS,
           "draft_layers": SPEC_DRAFT_LAYERS, "draft_len": SPEC_DRAFT_LEN,
           **stats, "equals_generate": same, "seconds": spec_s,
           "card": card}
    if not same:
        row["first_difference"] = _first_difference(plain, spec.cpu(),
                                                     greedy.cpu(),
                                                     BEAM_PROMPT)
    emit(row)
    check(same, "decode: greedy speculative_generate differs from "
          f"generate: {row.get('first_difference')}")
    del model, plain, draft

    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, _random_jax_weights(model, rng))
    fitted = FittedModel(model)
    quantized = fitted.quantize()
    base = fitted.generate(short, BEAM_STEPS)
    q8 = quantized.generate(short, BEAM_STEPS)
    agree = (base[:, BEAM_PROMPT:] == q8[:, BEAM_PROMPT:]).float().mean()
    emit({"phase": "decode_int8", "compute_dtype": LM["compute_dtype"],
          "rows": DECODE_ROWS, "prompt": BEAM_PROMPT, "steps": BEAM_STEPS,
          "bytes": quantized_bytes(model),
          "quantized_bytes": quantized_bytes(quantized.model),
          "greedy_agreement": agree.item(),
          "first_token_agreement":
              (base[:, BEAM_PROMPT] == q8[:, BEAM_PROMPT]).float()
              .mean().item(), "card": card})
    check(quantized_bytes(quantized.model) < quantized_bytes(model),
          "decode: int8 weights take no fewer bytes")
    check(bool(((q8 >= 0) & (q8 < v)).all()),
          "decode: int8 generate left the vocabulary")


def phase_decode(card: str, dev: str = "cuda"):
    """KV-cache decoding on the card: the decode bench's four
    configurations timed, the cached step against the full forward,
    generate on the card against the CPU, beam search, speculative
    decoding, int8 weights; no kernel launched on any of it (decode
    attends through the plain path, as the reference's does)."""
    t_start = time.perf_counter()
    _zero_counts()
    rows = _decode_timing(card, dev)
    _decode_checks(card, dev)
    launches = _read_counts()
    emit({"phase": "decode_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"decode: attention or CE kernel launches {launches}, want none")
    emit({"phase": "decode_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _serve_trace(rng):
    """SERVE_REQUESTS requests: (prompt, steps, submit keywords)."""
    import numpy as np
    filters = ({}, {"top_k": SERVE_TOPK}, {"top_p": SERVE_TOPP},
               {"top_k": SERVE_TOPK, "top_p": SERVE_TOPP})
    trace = []
    for i in range(SERVE_REQUESTS):
        p_len = int(rng.choice(SERVE_PROMPT_LENS))
        prompt = rng.integers(0, LM["vocab_size"], p_len).astype(np.int32)
        kw = {}
        if i % 2:
            kw = dict(temperature=SERVE_TEMP, seed=SEED * 1000 + i,
                      **filters[(i // 2) % len(filters)])
        trace.append((prompt, SERVE_STEPS, kw))
    return trace


def _serve_engine(model, rolling: bool, graphed: bool = True,
                  mode: str = "bucketed", **knobs):
    """A warmed-up ServingEngine of the phase's shape (``knobs`` override
    or add engine arguments, e.g. ``paged=True``).  ``graphed=False``
    builds the bucketed engine with its decode step uncaptured (the same
    function run eagerly: the graph's yardstick, made here and nowhere in
    the port)."""
    from distkeras_tpu_torch import serving
    uses = serving._uses_graph
    if not graphed:
        serving._uses_graph = lambda device: False
    kw = dict(num_slots=SERVE_SLOTS, max_len=LM["seq_len"], rolling=rolling,
              prefill_chunk=SERVE_CHUNK, prefill_mode=mode)
    kw.update(knobs)
    try:
        eng = serving.ServingEngine(model, **kw)
    finally:
        serving._uses_graph = uses
    return eng.warmup()


def _serve_run(model, trace, rolling: bool, dev: str, graphed: bool = True,
               mode: str = "bucketed", **knobs):
    """The whole trace through one engine, driven inline: the rows, the
    wall time, every decode-only iteration's host time and transfers (and,
    paged, the pool's counters and its state after the run)."""
    import numpy as np
    eng = _serve_engine(model, rolling, graphed, mode, **knobs)
    _sync(dev)
    keys = ("decode_steps", "prefills", "prefill_chunks", "h2d_transfers",
            "d2h_transfers")
    iter_ms, h2d, d2h = [], [], []
    t0 = time.perf_counter()
    handles = [eng.submit(p, n, **kw) for p, n, kw in trace]
    while True:
        before = [eng.stats[k] for k in keys]
        t1 = time.perf_counter()
        if not eng.step():
            break
        dt = time.perf_counter() - t1
        delta = [eng.stats[k] - b for k, b in zip(keys, before)]
        if delta[0] == 1 and delta[1] == 0 and delta[2] == 0:
            iter_ms.append(dt * 1e3)
            h2d.append(delta[3])
            d2h.append(delta[4])
    _sync(dev)
    wall = time.perf_counter() - t0
    ttft = np.array([h.ttft_s for h in handles]) * 1e3
    paged = {}
    if eng._draft_model is not None:
        st = eng.stats
        paged["spec"] = {k: st[k] for k in (
            "drafted", "accepted", "verify_calls", "target_calls",
            "active_slot_steps")}
        paged["spec"]["accept_rate"] = (st["accepted"] / st["drafted"]
                                        if st["drafted"] else None)
        # tokens a round commits per active row (accepted + 1 each)
        paged["spec"]["tokens_per_round_per_row"] = (
            (st["accepted"] + st["active_slot_steps"])
            / st["active_slot_steps"] if st["active_slot_steps"] else None)
    if eng.paged:
        paged.update({"pool": {k: eng.stats[k] for k in PAGED_POOL_STATS},
                 "kv_blocks": eng.kv_blocks,
                 "kv_blocks_in_use": eng.kv_blocks_in_use,
                 "conservation": eng._pool.check_conservation(),
                 "plans_left": len(eng._plans)})
    return {"rows": [h.result() for h in handles],
            "finish": [h.finish for h in handles],
            "wall_s": wall,
            "tokens_per_sec": eng.stats["tokens_generated"] / wall,
            "ms_per_decode_step": (statistics.median(iter_ms)
                                   if iter_ms else None),
            "decode_only_iterations": len(iter_ms),
            "h2d_per_decode_iteration": sorted(set(h2d)),
            "d2h_per_decode_iteration": sorted(set(d2h)),
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "slot_occupancy": eng.slot_occupancy,
            "stats": {k: eng.stats[k] for k in (
                "requests_completed", "tokens_generated", "decode_steps",
                "prefills", "prefill_batches", "prefill_chunks",
                "prefill_tokens", "h2d_transfers", "d2h_transfers",
                "graph_captures", "graph_replays", "slot_requests")},
            "free_slots": sorted(eng._free),
            "kv_pool_bytes": eng.kv_pool_bytes, **paged}


def _host_calls(prof) -> dict:
    """tools/profile_torch_slice.py's host_calls counter over a
    torch.profiler trace (ATen operator calls, kernel and graph launches,
    waits and copies) and the device's busy time (kernels and copies on
    the card)."""
    import torch
    launches = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
    out = {"aten_ops": 0, "kernel_launches": 0, "graph_launches": 0,
           "waits_and_copies": 0, "device_kernels": 0, "device_busy_us": 0.0}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out["device_kernels"] += 1
            out["device_busy_us"] += evt.time_range.elapsed_us()
            continue
        out["aten_ops"] += evt.name.startswith("aten::")
        out["kernel_launches"] += evt.name in launches
        out["graph_launches"] += evt.name in ("cudaGraphLaunch",
                                              "cuGraphLaunch")
        out["waits_and_copies"] += evt.name in waits
    return out


def _serve_profile(model, rolling: bool, graphed: bool, dev: str,
                   **knobs) -> dict:
    """SERVE_SLOTS running requests in steady decode: SERVE_PROFILE_STEPS
    engine iterations under torch.profiler (host calls and busy time a
    step), then SERVE_EVENT_STEPS decode steps back to back between two
    CUDA events (the device's time a step with the host's gaps in it).
    ``knobs`` as in _serve_engine (with ``spec_draft``, a step is a
    speculative round)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng = _serve_engine(model, rolling, graphed, **knobs)
    rng = np.random.default_rng(SEED + 16)
    for _ in range(SERVE_SLOTS):
        eng.submit(rng.integers(0, LM["vocab_size"], 64).astype(np.int32),
                   LM["seq_len"] - 64)
    while eng.queue_depth or eng._prefilling:
        eng.step()
    for _ in range(4):
        eng.step()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            eng.step()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = _host_calls(prof)
    n = SERVE_PROFILE_STEPS
    event_ms = None
    if torch.device(dev).type == "cuda":
        step = eng._graph.replay if graphed else eng._device_iteration
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SERVE_EVENT_STEPS):
            step()
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / SERVE_EVENT_STEPS
    busy_ms = calls.pop("device_busy_us") / 1e3 / n
    row = {"wall_ms_per_step": wall_ms / n,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (wall_ms / n),
           "event_ms_per_step": event_ms,
           **{f"{k}_per_step": v / n for k, v in calls.items()}}
    del eng
    return row


def _serve_mismatch(got_rows, want_rows, trace, plain=None):
    """The first request whose tokens differ, where, and (with the plain
    full forward at hand) the gap of its top two logits there."""
    import numpy as np
    import torch
    for i, (got, want) in enumerate(zip(got_rows, want_rows)):
        if not np.array_equal(got, want):
            p_len = len(trace[i][0])
            out = {"request": i, "sampled": bool(trace[i][2])}
            if plain is None:
                c = int(np.flatnonzero(got != want)[0])
                out.update(position=c, generated_index=c - p_len)
            else:
                out.update(_first_difference(
                    plain, torch.as_tensor(got[None]),
                    torch.as_tensor(want[None]), p_len))
            return out
    return None


def _serve_checks(card: str, dev: str, trace, rng) -> dict:
    """At f32 on a SERVE_CHECK_LAYERS-layer copy, TF32 off: (a) a lone
    greedy and a lone sampled request equal generate in both forms and
    both prefill modes; (b) the whole trace through the graph engine
    equals the eager engine (``prefill_mode="eager"``); (c) the greedy
    requests through the graph engine equal the same engine on the CPU."""
    import torch
    from distkeras_tpu_torch.core import decode
    greedy = [r for r in trace if not r[2]]
    lone = {"greedy": max(greedy, key=lambda r: len(r[0])),
            "sampled": next(r for r in trace
                            if "top_k" in r[2] and "top_p" in r[2])}
    out = {}
    for form, (extra, rolling) in SERVE_FORMS.items():
        model, plain, cpu = _decode_models(extra, rng, dev,
                                           layers=SERVE_CHECK_LAYERS)
        for kind, (prompt, steps, kw) in lone.items():
            gkw = dict(kw)
            if "seed" in gkw:
                gkw["rng"] = gkw.pop("seed")
            want = decode.generate(model, prompt[None], steps,
                                   max_len=LM["seq_len"], rolling=rolling,
                                   **gkw).cpu().numpy()
            for mode in ("bucketed", "eager"):
                eng = _serve_engine(model, rolling, mode=mode)
                h = eng.submit(prompt, steps, **kw)
                eng.run_until_idle()
                bad = _serve_mismatch([h.result()], want, [(prompt, steps,
                                                            kw)], plain)
                row = {"phase": "serve_lone", "form": form, "request": kind,
                       "prefill_mode": mode, "prompt": len(prompt),
                       "steps": steps, "compute_dtype": "float32",
                       "layers": SERVE_CHECK_LAYERS,
                       "graph_replays": eng.stats["graph_replays"],
                       "equals_generate": bad is None, "card": card}
                if bad is not None:
                    row["first_difference"] = bad
                emit(row)
                check(bad is None, f"serve {form}: a lone {kind} request "
                      f"({mode}) differs from generate: {bad}")
        graph = _serve_run(model, trace, rolling, dev)
        eager = _serve_run(model, trace, rolling, dev, mode="eager")
        t0 = time.perf_counter()
        on_cpu = _serve_run(cpu, greedy, rolling, "cpu")
        cpu_s = time.perf_counter() - t0
        greedy_rows = [r for r, req in zip(graph["rows"], trace)
                       if not req[2]]
        vs_eager = _serve_mismatch(graph["rows"], eager["rows"], trace,
                                   plain)
        vs_cpu = _serve_mismatch(greedy_rows, on_cpu["rows"], greedy, plain)
        row = {"phase": "serve_checks", "form": form,
               "compute_dtype": "float32", "layers": SERVE_CHECK_LAYERS,
               "requests": len(trace), "graph_equals_eager": vs_eager is None,
               "greedy_requests": len(greedy),
               "card_equals_cpu": vs_cpu is None,
               "graph_ms_per_decode_step": graph["ms_per_decode_step"],
               "eager_ms_per_decode_step": eager["ms_per_decode_step"],
               "cpu_s": cpu_s, "card": card}
        if vs_eager is not None:
            row["graph_vs_eager_first_difference"] = vs_eager
        if vs_cpu is not None:
            row["card_vs_cpu_first_difference"] = vs_cpu
        emit(row)
        check(vs_eager is None, f"serve {form}: the graph engine differs "
              f"from the eager engine over the trace: {vs_eager}")
        check(vs_cpu is None, f"serve {form}: greedy requests on the card "
              f"differ from the CPU: {vs_cpu}")
        out[form] = row
        del model, plain, cpu
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_serve(card: str, dev: str = "cuda"):
    """The serving engine on the card: the trace through the graph engine
    and through the same engine with its step uncaptured (bf16, full
    width, the forms of SERVE_BF16_FORMS), their tokens/s, ms per decode step, TTFT and slot
    occupancy; host calls a step; 0 uploads and 1 readback per
    decode-only iteration; no request lost and every slot reused; the f32
    checks of _serve_checks; no kernel launched on any of it (decode
    attends through the plain path, as the reference's does)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    t_start = time.perf_counter()
    _zero_counts()
    rng = np.random.default_rng(SEED + 15)
    trace = _serve_trace(rng)
    rows = {}
    for form, (extra, rolling) in SERVE_FORMS.items():
        model = transformer_lm(**LM, **extra, device=dev)
        load_jax_weights(model, _random_jax_weights(model, rng))
        if form not in SERVE_BF16_FORMS:
            continue
        runs = {"graph": _serve_run(model, trace, rolling, dev),
                "uncaptured": _serve_run(model, trace, rolling, dev,
                                         graphed=False)}
        prof = {route: _serve_profile(model, rolling, route == "graph", dev)
                for route in runs}
        g = runs["graph"]
        same = _serve_mismatch(g["rows"], runs["uncaptured"]["rows"], trace)
        row = {"phase": "serve", "form": form,
               "compute_dtype": LM["compute_dtype"],
               "slots": SERVE_SLOTS, "prefill_chunk": SERVE_CHUNK,
               "requests": len(trace), "steps": SERVE_STEPS,
               "prompt_lens": sorted({len(p) for p, _, _ in trace}),
               "sampled_requests": sum(bool(kw) for _, _, kw in trace),
               "graph_equals_uncaptured": same is None,
               **{f"{route}_{k}": r[k] for route, r in runs.items()
                  for k in ("tokens_per_sec", "ms_per_decode_step",
                            "ttft_ms_p50", "ttft_ms_p99", "slot_occupancy",
                            "wall_s")},
               "graph_captures": g["stats"]["graph_captures"],
               "graph_replays": g["stats"]["graph_replays"],
               "decode_steps": g["stats"]["decode_steps"],
               "decode_only_iterations": g["decode_only_iterations"],
               "h2d_per_decode_iteration": g["h2d_per_decode_iteration"],
               "d2h_per_decode_iteration": g["d2h_per_decode_iteration"],
               "stats": g["stats"],
               "profile": prof, "card": card}
        if same is not None:
            row["first_difference"] = same
        emit(row)
        check(same is None, f"serve {form}: the graph engine differs from "
              f"the uncaptured step over the trace: {same}")
        check(g["stats"]["requests_completed"] == len(trace)
              and all(f == "length" for f in g["finish"])
              and g["free_slots"] == list(range(SERVE_SLOTS)),
              f"serve {form}: requests lost or slots held: "
              f"{g['stats']['requests_completed']} of {len(trace)}")
        check(min(g["stats"]["slot_requests"]) >= 2,
              f"serve {form}: a slot was never reused: "
              f"{g['stats']['slot_requests']}")
        check(g["decode_only_iterations"] > 0
              and g["h2d_per_decode_iteration"] == [0]
              and g["d2h_per_decode_iteration"] == [1],
              f"serve {form}: a decode-only iteration moved "
              f"{g['h2d_per_decode_iteration']} uploads and "
              f"{g['d2h_per_decode_iteration']} readbacks, want [0] and [1]")
        check(g["stats"]["graph_captures"] == 1
              and g["stats"]["graph_replays"] == g["stats"]["decode_steps"],
              f"serve {form}: {g['stats']['graph_captures']} captures and "
              f"{g['stats']['graph_replays']} replays for "
              f"{g['stats']['decode_steps']} decode steps")
        rows[form] = row
        del model, runs
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    rows["checks"] = _serve_checks(card, dev, trace, rng)
    launches = _read_counts()
    emit({"phase": "serve_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"serve: attention or CE kernel launches {launches}, want none")
    emit({"phase": "serve_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _prefix_trace(vocab: int):
    """The port's loadgen make_trace(PREFIX_REQUESTS, num_steps=
    PREFIX_STEPS, prompt_lengths=PREFIX_SUFFIXES, prefix_groups=1,
    prefix_len=PREFIX_LEN) over ``vocab`` tokens, greedy, as (prompt,
    steps, submit keywords)."""
    from distkeras_tpu_torch.examples.loadgen import make_trace
    return [(r["prompt"], r["num_steps"], {}) for r in make_trace(
        PREFIX_REQUESTS, vocab=vocab, num_steps=PREFIX_STEPS,
        prompt_lengths=PREFIX_SUFFIXES, prefix_groups=1,
        prefix_len=PREFIX_LEN)]


def _prefix_engine(model, paged: bool):
    from distkeras_tpu_torch.serving import ServingEngine
    kw = dict(paged=True, block_size=PAGED_BLOCK) if paged else {}
    return ServingEngine(model, num_slots=PREFIX_SLOTS,
                         max_len=PREFIX_MAX_LEN, prefill_chunk=PREFIX_CHUNK,
                         prefills_per_step=PREFIX_PER_STEP, **kw)


def _prefix_run(model, trace, paged: bool, dev: str) -> dict:
    """The shared-prefix trace through one engine (warmed up, the prefix
    warmed once by the first request's prompt), PREFIX_USERS users in a
    closed loop driven inline: each submits its next request when its
    last one finished.  TTFT from submit to the first token; the
    effective prefill rate counts prefilled and trie-served tokens."""
    import numpy as np
    eng = _prefix_engine(model, paged).warmup()
    eng.submit(trace[0][0], 1)
    eng.run_until_idle()
    _sync(dev)
    pf0, hit0 = eng.stats["prefill_tokens"], eng.stats["prefix_hit_tokens"]
    pending = list(trace)
    live, handles = [], []
    t0 = time.perf_counter()
    while pending or live:
        while pending and len(live) < PREFIX_USERS:
            prompt, steps, kw = pending.pop(0)
            live.append(eng.submit(prompt, steps, **kw))
            handles.append(live[-1])
        eng.step()
        live = [h for h in live if not h.done]
    _sync(dev)
    wall = time.perf_counter() - t0
    prefilled = eng.stats["prefill_tokens"] - pf0
    hits = eng.stats["prefix_hit_tokens"] - hit0
    ttft = np.array([h.ttft_s for h in handles]) * 1e3
    out = {"rows": [h.result() for h in handles], "wall_s": wall,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "prefill_tokens": prefilled, "prefix_hit_tokens": hits,
           "effective_prefill_tokens_per_sec": (prefilled + hits) / wall,
           "prefix_hit_rate": (hits / (hits + prefilled)
                               if hits + prefilled else None),
           "kv_pool_bytes": eng.kv_pool_bytes,
           "stats": {k: eng.stats[k] for k in (
               "prefill_chunks", "prefill_batches", "decode_steps",
               *PAGED_POOL_STATS)}}
    if paged:
        out.update(kv_blocks=eng.kv_blocks,
                   kv_blocks_in_use=eng.kv_blocks_in_use,
                   conservation=eng._pool.check_conservation())
    return out


def _paged_capacity_slots(paged_bytes: int, kv_blocks: int,
                          dense_bytes: int, trace) -> int:
    """bench.py's serving_paged_capacity_slots: the blocks the dense
    pool's bytes buy, less the shared prefix chain (counted once), over
    the most private blocks one trace request needs."""
    blk_bytes = paged_bytes // (kv_blocks + 1)
    budget_blocks = dense_bytes // blk_bytes
    shared = PREFIX_LEN // PAGED_BLOCK
    marg = max(-(-(len(p) + n) // PAGED_BLOCK) - shared for p, n, _ in trace)
    return int((budget_blocks - shared) // max(marg, 1))


def _paged_checks(card: str, dev: str, trace, prefix_trace, rng) -> dict:
    """At f32 on a SERVE_CHECK_LAYERS-layer copy, TF32 off, both forms:
    the paged graph engine's tokens equal the dense graph engine's over
    phase serve's trace and the shared-prefix trace, and generate's (the
    greedy requests batched by prompt length, each sampled filter kind
    alone); a tight arena (PAGED_TIGHT slots' blocks) evicts and equals
    the dense engine."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.core import decode
    out = {}
    paged = dict(paged=True, block_size=PAGED_BLOCK)
    for form, (extra, rolling) in SERVE_FORMS.items():
        model, plain, _ = _decode_models(extra, rng, dev,
                                         layers=SERVE_CHECK_LAYERS)
        runs = {"dense": _serve_run(model, trace, rolling, dev),
                "paged": _serve_run(model, trace, rolling, dev, **paged)}
        if not rolling:
            blocks = -(-LM["seq_len"] // PAGED_BLOCK)
            runs["tight"] = _serve_run(model, trace, rolling, dev,
                                       kv_blocks=PAGED_TIGHT * blocks,
                                       **paged)
        want = {}
        lengths = sorted({len(p) for p, _, kw in trace if not kw})
        for p_len in lengths:
            idx = [i for i, (p, _, kw) in enumerate(trace)
                   if not kw and len(p) == p_len]
            prompts = torch.as_tensor(np.stack([trace[i][0] for i in idx]))
            rows = decode.generate(model, prompts, SERVE_STEPS,
                                   max_len=LM["seq_len"], rolling=rolling)
            want.update(zip(idx, rows.cpu().numpy()))
        kinds = {}      # the first sampled request of each filter kind
        for i, (_, _, kw) in enumerate(trace):
            if kw:
                kinds.setdefault(tuple(sorted(k for k in kw
                                              if k.startswith("top"))), i)
        for i in kinds.values():
            prompt, steps, kw = trace[i]
            gkw = dict(kw)
            gkw["rng"] = gkw.pop("seed")
            want[i] = decode.generate(model, prompt[None], steps,
                                      max_len=LM["seq_len"], rolling=rolling,
                                      **gkw).cpu().numpy()[0]
        order = sorted(want)
        sub = [trace[i] for i in order]
        row = {"phase": "paged_checks", "form": form,
               "compute_dtype": "float32", "layers": SERVE_CHECK_LAYERS,
               "requests": len(trace), "generate_requests": len(order),
               "card": card}
        for name, r in runs.items():
            if name == "dense":
                continue
            bad = _serve_mismatch(r["rows"], runs["dense"]["rows"], trace,
                                  plain)
            row[f"{name}_equals_dense"] = bad is None
            if bad is not None:
                row[f"{name}_vs_dense_first_difference"] = bad
        bad = _serve_mismatch([runs["paged"]["rows"][i] for i in order],
                              [want[i] for i in order], sub, plain)
        row["paged_equals_generate"] = bad is None
        if bad is not None:
            row["paged_vs_generate_first_difference"] = bad
        for name in ("paged", "tight"):
            if name in runs:
                row[f"{name}_pool"] = runs[name]["pool"]
                row[f"{name}_leaked_blocks"] = runs[name]["kv_blocks_in_use"]
        if not rolling:
            pre = {flag: _prefix_run(model, prefix_trace, flag, dev)
                   for flag in (True, False)}
            p_rows = [r[0] for r in prefix_trace]
            g = {}
            for p_len in sorted({len(p) for p in p_rows}):
                idx = [i for i, p in enumerate(p_rows) if len(p) == p_len]
                rows = decode.generate(
                    model, torch.as_tensor(np.stack([p_rows[i] for i in idx])),
                    PREFIX_STEPS, max_len=PREFIX_MAX_LEN)
                g.update(zip(idx, rows.cpu().numpy()))
            want_p = [g[i] for i in range(len(p_rows))]
            vs_dense = _serve_mismatch(pre[True]["rows"], pre[False]["rows"],
                                       prefix_trace, plain)
            vs_gen = _serve_mismatch(pre[True]["rows"], want_p, prefix_trace,
                                     plain)
            row.update(prefix_paged_equals_dense=vs_dense is None,
                       prefix_paged_equals_generate=vs_gen is None,
                       prefix_hit_tokens=pre[True]["prefix_hit_tokens"])
            check(vs_dense is None and vs_gen is None,
                  f"paged {form}: the shared-prefix trace differs: "
                  f"{vs_dense or vs_gen}")
        emit(row)
        for name in runs:
            if name == "dense":
                continue
            check(row[f"{name}_equals_dense"],
                  f"paged {form}: the {name} engine differs from the dense "
                  f"engine over the trace: "
                  f"{row.get(f'{name}_vs_dense_first_difference')}")
            check(runs[name]["kv_blocks_in_use"] == 0
                  and runs[name]["conservation"]
                  and not runs[name]["plans_left"],
                  f"paged {form}: {name} leaked blocks: "
                  f"{runs[name]['kv_blocks_in_use']}")
        check(row["paged_equals_generate"],
              f"paged {form}: requests differ from generate: "
              f"{row.get('paged_vs_generate_first_difference')}")
        if "tight" in runs:
            check(runs["tight"]["pool"]["blocks_evicted"] > 0,
                  f"paged {form}: the tight arena evicted nothing: "
                  f"{runs['tight']['pool']}")
        out[form] = row
        del model, plain, runs
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_paged(card: str, dev: str = "cuda"):
    """The paged pool on the card: phase serve's trace (bf16, full width,
    the forms of SERVE_BF16_FORMS) through the paged engine with its decode step as a CUDA
    graph and uncaptured (tokens/s, ms per decode-only iteration, TTFT,
    host calls a step, uploads and readbacks per decode-only iteration,
    the pool's bytes beside the dense pool's; the two equal, one capture,
    a replay a step, no block leaked); the shared-prefix trace through the
    paged and the dense engine (TTFT, effective prefill tokens/s, the hit
    rate, bench.py's capacity slots; at least PREFIX_HIT_MIN hit tokens);
    the f32 checks of _paged_checks; no kernel launched on any of it (the
    paged step attends through the plain path, as the reference's
    does)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.serving import ServingEngine
    t_start = time.perf_counter()
    _zero_counts()
    rng = np.random.default_rng(SEED + 15)    # phase serve's trace, weights
    trace = _serve_trace(rng)
    prefix_trace = _prefix_trace(LM["vocab_size"])
    paged = dict(paged=True, block_size=PAGED_BLOCK)
    rows = {}
    for form, (extra, rolling) in SERVE_FORMS.items():
        model = transformer_lm(**LM, **extra, device=dev)
        load_jax_weights(model, _random_jax_weights(model, rng))
        if form not in SERVE_BF16_FORMS:
            continue
        dense_bytes = ServingEngine(model, num_slots=SERVE_SLOTS,
                                    max_len=LM["seq_len"],
                                    rolling=rolling).kv_pool_bytes
        runs = {"graph": _serve_run(model, trace, rolling, dev, **paged),
                "uncaptured": _serve_run(model, trace, rolling, dev,
                                         graphed=False, **paged)}
        prof = _serve_profile(model, rolling, True, dev, **paged)
        g = runs["graph"]
        same = _serve_mismatch(g["rows"], runs["uncaptured"]["rows"], trace)
        row = {"phase": "paged", "form": form,
               "compute_dtype": LM["compute_dtype"], "slots": SERVE_SLOTS,
               "prefill_chunk": SERVE_CHUNK, "block_size": PAGED_BLOCK,
               "kv_blocks": g["kv_blocks"], "requests": len(trace),
               "graph_equals_uncaptured": same is None,
               **{f"{route}_{k}": r[k] for route, r in runs.items()
                  for k in ("tokens_per_sec", "ms_per_decode_step",
                            "ttft_ms_p50", "ttft_ms_p99", "slot_occupancy",
                            "wall_s")},
               "graph_captures": g["stats"]["graph_captures"],
               "graph_replays": g["stats"]["graph_replays"],
               "decode_steps": g["stats"]["decode_steps"],
               "decode_only_iterations": g["decode_only_iterations"],
               "h2d_per_decode_iteration": g["h2d_per_decode_iteration"],
               "d2h_per_decode_iteration": g["d2h_per_decode_iteration"],
               "aten_ops_per_step": prof["aten_ops_per_step"],
               "kv_pool_bytes": g["kv_pool_bytes"],
               "dense_kv_pool_bytes": dense_bytes,
               "pool": g["pool"], "kv_blocks_in_use": g["kv_blocks_in_use"],
               "conservation": g["conservation"], "stats": g["stats"],
               "profile": prof, "card": card}
        if same is not None:
            row["first_difference"] = same
        emit(row)
        check(same is None, f"paged {form}: the graph engine differs from "
              f"the uncaptured step over the trace: {same}")
        check(g["stats"]["requests_completed"] == len(trace)
              and all(f == "length" for f in g["finish"]),
              f"paged {form}: requests lost: "
              f"{g['stats']['requests_completed']} of {len(trace)}")
        check(g["decode_only_iterations"] > 0
              and g["h2d_per_decode_iteration"] == [0]
              and g["d2h_per_decode_iteration"] == [1],
              f"paged {form}: a decode-only iteration moved "
              f"{g['h2d_per_decode_iteration']} uploads and "
              f"{g['d2h_per_decode_iteration']} readbacks, want [0] and [1]")
        check(g["stats"]["graph_captures"] == 1
              and g["stats"]["graph_replays"] == g["stats"]["decode_steps"],
              f"paged {form}: {g['stats']['graph_captures']} captures and "
              f"{g['stats']['graph_replays']} replays for "
              f"{g['stats']['decode_steps']} decode steps")
        for route, r in runs.items():
            check(r["kv_blocks_in_use"] == 0 and r["conservation"]
                  and not r["plans_left"],
                  f"paged {form}: {route} leaked {r['kv_blocks_in_use']} "
                  f"blocks")
        rows[form] = row
        if not rolling:
            pre = {name: _prefix_run(model, prefix_trace, name == "paged",
                                     dev)
                   for name in ("paged", "dense")}
            p = pre["paged"]
            prow = {"phase": "paged_prefix", "form": form,
                    "compute_dtype": LM["compute_dtype"],
                    "requests": len(prefix_trace), "prefix_len": PREFIX_LEN,
                    "suffixes": list(PREFIX_SUFFIXES),
                    "block_size": PAGED_BLOCK, "slots": PREFIX_SLOTS,
                    "max_len": PREFIX_MAX_LEN, "prefill_chunk": PREFIX_CHUNK,
                    "prefills_per_step": PREFIX_PER_STEP,
                    "users": PREFIX_USERS,
                    **{f"{name}_{k}": r[k] for name, r in pre.items()
                       for k in ("ttft_ms_p50", "ttft_ms_p99",
                                 "effective_prefill_tokens_per_sec",
                                 "prefill_tokens", "wall_s")},
                    "prefix_hit_tokens": p["prefix_hit_tokens"],
                    "prefix_hit_rate": p["prefix_hit_rate"],
                    "serving_paged_capacity_slots": _paged_capacity_slots(
                        p["kv_pool_bytes"], p["kv_blocks"],
                        pre["dense"]["kv_pool_bytes"], prefix_trace),
                    "paged_stats": p["stats"],
                    "dense_stats": pre["dense"]["stats"],
                    "kv_blocks_in_use": p["kv_blocks_in_use"],
                    "card": card}
            emit(prow)
            check(p["prefix_hit_tokens"] >= PREFIX_HIT_MIN,
                  f"paged: {p['prefix_hit_tokens']} prefix hit tokens, want "
                  f">= {PREFIX_HIT_MIN}")
            check(p["kv_blocks_in_use"] == 0 and p["conservation"],
                  f"paged: the shared-prefix run leaked "
                  f"{p['kv_blocks_in_use']} blocks")
            rows["prefix"] = prow
        del model, runs
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    rows["checks"] = _paged_checks(card, dev, trace, prefix_trace, rng)
    launches = _read_counts()
    emit({"phase": "paged_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"paged: attention or CE kernel launches {launches}, want none")
    emit({"phase": "paged_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _arith_trace(rng):
    """examples/loadgen.py's make_trace(pattern="arith") at the phase's
    shape: SERVE_REQUESTS greedy requests, each prompt a seeded-start x+1
    run (mod the vocabulary) of a length drawn from SERVE_PROMPT_LENS,
    SERVE_STEPS new tokens."""
    import numpy as np
    trace = []
    for _ in range(SERVE_REQUESTS):
        p_len = int(rng.choice(SERVE_PROMPT_LENS))
        start = int(rng.integers(0, LM["vocab_size"]))
        prompt = ((start + np.arange(p_len)) % LM["vocab_size"])
        trace.append((prompt.astype(np.int32), SERVE_STEPS, {}))
    return trace


def _spec_pair(extra, rng, dev: str):
    """The target LM (bf16, full width) and a SPEC_DRAFT_LAYERS-layer
    draft of the same widths, from random weights, each trained on the
    card on the x+1 task: returns (target, draft, their loss histories,
    seconds)."""
    import numpy as np
    from distkeras_tpu_torch import (Dataset, FittedModel, SingleTrainer,
                                     load_jax_weights, transformer_lm)
    x = rng.integers(0, LM["vocab_size"],
                     (SPEC_TRAIN_ROWS, LM["seq_len"])).astype(np.int32)
    data = Dataset({"features": x,
                    "label": ((x + 1) % LM["vocab_size"]).astype(np.int64)})
    out, hist = [], []
    t0 = time.perf_counter()
    for layers in (LM["num_layers"], SPEC_DRAFT_LAYERS):
        model = transformer_lm(**{**LM, **extra, "num_layers": layers},
                               device=dev)
        load_jax_weights(model, _random_jax_weights(model, rng))
        trainer = SingleTrainer(FittedModel(model), device=dev,
                                **{**TRAINER, "num_epoch": SPEC_TRAIN_EPOCHS})
        out.append(trainer.train(data).model)
        hist.append(trainer.get_history())
    _sync(dev)
    return out[0], out[1], hist, time.perf_counter() - t0


def _greedy_share(got_rows, want_rows, trace) -> float:
    """The share of the trace's greedy requests whose rows agree."""
    import numpy as np
    same = [np.array_equal(a, b) for a, b, r in zip(got_rows, want_rows,
                                                      trace) if not r[2]]
    return sum(same) / len(same)


def _spec_checks(card: str, dev: str, trace, rng) -> dict:
    """At f32 on a SERVE_CHECK_LAYERS-layer copy, TF32 off, both forms,
    over SPEC_CHECK_REQUESTS greedy requests of the trace cut to
    SPEC_CHECK_STEPS: the speculative engine (self-draft and a random
    SPEC_DRAFT_LAYERS-layer draft, dense and paged) equals the plain
    engine and generate; on the full form the speculative, the int8-KV
    (dense, paged) and the quantized-weight (int8, bf16) engines on the
    card equal the same engines on the CPU; int8 KV codes and scales of
    the card equal the CPU's."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.core import decode, quant
    x = torch.as_tensor(rng.standard_normal((64, 2, 32)).astype(np.float32))
    codes = [quant.quantize_kv(t) for t in (x, x.to(dev))]
    same_codes = all(torch.equal(a, b.cpu()) for a, b in zip(*codes))
    emit({"phase": "spec_int8_codes", "card_equals_cpu": same_codes,
          "card": card})
    check(same_codes, "spec: int8 KV codes or scales differ card vs CPU")
    greedy = [(p, SPEC_CHECK_STEPS, kw) for p, _, kw in trace
              if not kw][:SPEC_CHECK_REQUESTS]
    paged = dict(paged=True, block_size=PAGED_BLOCK)
    out = {}
    for form, (extra, rolling) in SERVE_FORMS.items():
        model, plain, cpu = _decode_models(extra, rng, dev,
                                           layers=SERVE_CHECK_LAYERS)
        cfg = dict(LM, compute_dtype="float32", num_layers=SPEC_DRAFT_LAYERS,
                   **extra)
        weights = _random_jax_weights(transformer_lm(**cfg, device="meta"),
                                      rng)
        rdraft = transformer_lm(**cfg, device=dev)
        load_jax_weights(rdraft, weights)
        rdraft_cpu = transformer_lm(**cfg, device="cpu")
        load_jax_weights(rdraft_cpu, weights)
        want = {}
        for p_len in sorted({len(p) for p, _, _ in greedy}):
            idx = [i for i, r in enumerate(greedy) if len(r[0]) == p_len]
            rows = decode.generate(
                model, torch.as_tensor(np.stack([greedy[i][0] for i in idx])),
                SPEC_CHECK_STEPS, max_len=LM["seq_len"], rolling=rolling)
            want.update(zip(idx, rows.cpu().numpy()))
        want = [want[i] for i in range(len(greedy))]
        row = {"phase": "spec_checks", "form": form,
               "compute_dtype": "float32", "layers": SERVE_CHECK_LAYERS,
               "requests": len(greedy), "steps": SPEC_CHECK_STEPS,
               "card": card}
        bad = {}
        runs = {"plain": _serve_run(model, greedy, rolling, dev)}
        for name, knobs in (("self", dict(spec_draft=model)),
                            ("random", dict(spec_draft=rdraft)),
                            ("self_paged", dict(spec_draft=model, **paged)),
                            ("random_paged", dict(spec_draft=rdraft,
                                                  **paged))):
            r = _serve_run(model, greedy, rolling, dev,
                           spec_len=SPEC_DRAFT_LEN, **knobs)
            runs[name] = r
            if "kv_blocks_in_use" in r:
                check(r["kv_blocks_in_use"] == 0 and r["conservation"]
                      and not r["plans_left"],
                      f"spec {form}: {name} leaked "
                      f"{r['kv_blocks_in_use']} blocks")
        for name, r in runs.items():
            bad[f"{name}_vs_generate"] = _serve_mismatch(r["rows"], want,
                                                         greedy, plain)
            if name != "plain":
                bad[f"{name}_vs_plain"] = _serve_mismatch(
                    r["rows"], runs["plain"]["rows"], greedy, plain)
        row["accept_rates"] = {n: r["spec"]["accept_rate"]
                               for n, r in runs.items() if "spec" in r}
        if form == "full":
            # (name, the card's run, the CPU engine's knobs)
            cpu_runs = (
                ("spec_self", runs["self"],
                 dict(spec_draft=cpu, spec_len=SPEC_DRAFT_LEN)),
                ("spec_random_paged", runs["random_paged"],
                 dict(spec_draft=rdraft_cpu, spec_len=SPEC_DRAFT_LEN,
                      **paged)),
                *((name, _serve_run(model, greedy, rolling, dev, **knobs),
                   knobs) for name, knobs in (
                      ("kv_int8", dict(kv_dtype="int8")),
                      ("kv_int8_paged", dict(kv_dtype="int8", **paged)),
                      ("weights_int8", dict(quantize="int8")),
                      ("weights_bf16", dict(quantize="bf16")))))
            t0 = time.perf_counter()
            for name, on_card, knobs in cpu_runs:
                on_cpu = _serve_run(cpu, greedy, rolling, "cpu", **knobs)
                bad[f"{name}_card_vs_cpu"] = _serve_mismatch(
                    on_card["rows"], on_cpu["rows"], greedy, plain)
            row["cpu_s"] = time.perf_counter() - t0
        row.update({f"{k}_equal": v is None for k, v in bad.items()})
        row["first_differences"] = {k: v for k, v in bad.items()
                                    if v is not None}
        emit(row)
        check(not row["first_differences"],
              f"spec {form}: f32 checks differ: {row['first_differences']}")
        out[form] = row
        del model, plain, cpu, rdraft, rdraft_cpu, runs
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_spec(card: str, dev: str = "cuda"):
    """Speculation and quantization in the engine on the card: per form
    of SPEC_FORMS a target and a SPEC_DRAFT_LAYERS-layer draft trained on
    the x+1 task,
    then (counts from 0) phase serve's trace through the plain graph
    engine, the self-drafted and the trained-draft speculative graph
    engines, the trained-draft one twice (sampled rows repeat) and paged,
    and its first SPEC_UNCAPTURED requests through the self-drafted and
    the paged engines uncaptured (graph = uncaptured at bf16); the
    arith trace through the plain and the trained-draft engines (accept
    rate, tokens a round a row); ms a round, tokens/s against the plain
    engine, host calls a round; the pools' bytes (bf16 and int8, dense and
    paged) and bench.py's serving_quant_capacity_slots; the f32 checks of
    _spec_checks; no kernel launched on any of it (the round attends
    through the plain path, as the reference's does)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.serving import ServingEngine
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    trace = _serve_trace(np.random.default_rng(SEED + 15))
    arith = _arith_trace(rng)
    pairs = {form: _spec_pair(SERVE_FORMS[form][0], rng, dev)
             for form in SPEC_FORMS}
    for form, (_, _, hist, seconds) in pairs.items():
        emit({"phase": "spec_train", "form": form,
              "epochs": SPEC_TRAIN_EPOCHS, "rows": SPEC_TRAIN_ROWS,
              "target_losses": [hist[0][0], hist[0][-1]],
              "draft_losses": [hist[1][0], hist[1][-1]],
              "seconds": seconds, "card": card})
    _zero_counts()          # the main path starts here (training is set-up)
    spec = dict(spec_len=SPEC_DRAFT_LEN)
    paged = dict(paged=True, block_size=PAGED_BLOCK)
    rows = {}
    for form in SPEC_FORMS:
        rolling = SERVE_FORMS[form][1]
        model, draft, _, _ = pairs[form]
        runs = {
            "plain": _serve_run(model, trace, rolling, dev),
            "self": _serve_run(model, trace, rolling, dev,
                               spec_draft=model, **spec),
            "self_uncaptured": _serve_run(
                model, trace[:SPEC_UNCAPTURED], rolling, dev, graphed=False,
                spec_draft=model, **spec),
            "draft": _serve_run(model, trace, rolling, dev,
                                spec_draft=draft, **spec),
            "draft_again": _serve_run(model, trace, rolling, dev,
                                      spec_draft=draft, **spec),
            "draft_paged": _serve_run(model, trace, rolling, dev,
                                      spec_draft=draft, **spec, **paged),
            "draft_paged_uncaptured": _serve_run(
                model, trace[:SPEC_UNCAPTURED], rolling, dev,
                graphed=False, spec_draft=draft, **spec, **paged),
            "arith_plain": _serve_run(model, arith, rolling, dev),
            "arith_draft": _serve_run(model, arith, rolling, dev,
                                      spec_draft=draft, **spec)}
        prof = ({name: _serve_profile(model, rolling, True, dev, **knobs)
                 for name, knobs in (("plain", {}),
                                     ("self", dict(spec_draft=model,
                                                   **spec)),
                                     ("draft", dict(spec_draft=draft,
                                                    **spec)))}
                if form in SPEC_PROFILE_FORMS else None)
        same = _serve_mismatch(runs["self"]["rows"][:SPEC_UNCAPTURED],
                               runs["self_uncaptured"]["rows"],
                               trace[:SPEC_UNCAPTURED])
        same_paged = _serve_mismatch(
            runs["draft_paged"]["rows"][:SPEC_UNCAPTURED],
            runs["draft_paged_uncaptured"]["rows"], trace[:SPEC_UNCAPTURED])
        repeat = _serve_mismatch(runs["draft"]["rows"],
                                 runs["draft_again"]["rows"], trace)
        row = {"phase": "spec", "form": form,
               "compute_dtype": LM["compute_dtype"], "slots": SERVE_SLOTS,
               "spec_len": SPEC_DRAFT_LEN, "draft_layers": SPEC_DRAFT_LAYERS,
               "requests": len(trace), "steps": SERVE_STEPS,
               "graph_equals_uncaptured": same is None,
               "paged_graph_equals_uncaptured": same_paged is None,
               "sampled_rows_repeat": repeat is None,
               "greedy_share_spec_equals_plain": {
                   name: _greedy_share(runs[name]["rows"],
                                       runs["plain"]["rows"], trace)
                   for name in ("self", "draft")},
               **{f"{name}_{k}": runs[name][k] for name in runs
                  for k in ("tokens_per_sec", "ms_per_decode_step",
                            "ttft_ms_p50", "wall_s")},
               "spec": {name: r["spec"] for name, r in runs.items()
                        if "spec" in r},
               "decode_only_iterations": {
                   name: r["decode_only_iterations"]
                   for name, r in runs.items()},
               "h2d_per_decode_iteration": sorted({
                   v for r in runs.values()
                   for v in r["h2d_per_decode_iteration"]}),
               "d2h_per_decode_iteration": sorted({
                   v for r in runs.values()
                   for v in r["d2h_per_decode_iteration"]}),
               "graph": {name: [r["stats"]["graph_captures"],
                                r["stats"]["graph_replays"],
                                r["stats"]["decode_steps"]]
                         for name, r in runs.items()},
               "paged_kv_blocks_in_use": runs["draft_paged"]
               ["kv_blocks_in_use"],
               "profile": prof, "card": card}
        for key, bad in (("first_difference", same),
                         ("paged_first_difference", same_paged),
                         ("repeat_first_difference", repeat)):
            if bad is not None:
                row[key] = bad
        emit(row)
        check(same is None and same_paged is None,
              f"spec {form}: the graph round differs from the uncaptured "
              f"round: {same or same_paged}")
        check(repeat is None, f"spec {form}: sampled rows did not repeat: "
              f"{repeat}")
        for name, r in runs.items():
            check(r["stats"]["requests_completed"] == len(r["rows"])
                  and all(f == "length" for f in r["finish"]),
                  f"spec {form}: {name} lost requests")
            check(r["decode_only_iterations"] > 0
                  and r["h2d_per_decode_iteration"] == [0]
                  and r["d2h_per_decode_iteration"] == [1],
                  f"spec {form}: {name} moved "
                  f"{r['h2d_per_decode_iteration']} uploads and "
                  f"{r['d2h_per_decode_iteration']} readbacks a decode-only "
                  f"iteration, want [0] and [1]")
            graphed = not name.endswith("uncaptured")
            check(r["stats"]["graph_captures"] == int(graphed)
                  and r["stats"]["graph_replays"]
                  == (r["stats"]["decode_steps"] if graphed else 0),
                  f"spec {form}: {name}: {r['stats']['graph_captures']} "
                  f"captures, {r['stats']['graph_replays']} replays for "
                  f"{r['stats']['decode_steps']} steps")
            if "kv_blocks_in_use" in r:
                check(r["kv_blocks_in_use"] == 0 and r["conservation"]
                      and not r["plans_left"],
                      f"spec {form}: {name} leaked "
                      f"{r['kv_blocks_in_use']} blocks")
        rows[form] = row
        del runs
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    model = pairs["full"][0]
    pools = {}
    for name, knobs in (("bf16", {}), ("int8", dict(kv_dtype="int8")),
                        ("bf16_paged", paged),
                        ("int8_paged", dict(kv_dtype="int8", **paged))):
        eng = ServingEngine(model, num_slots=SERVE_SLOTS,
                            max_len=LM["seq_len"], **knobs)
        pools[name] = eng.kv_pool_bytes
        del eng
    capacity = int(pools["bf16"] // (pools["int8"] // SERVE_SLOTS))
    rows["pools"] = {"phase": "spec_pools", "slots": SERVE_SLOTS,
                     "kv_pool_bytes": pools,
                     "serving_quant_capacity_slots": capacity, "card": card}
    emit(rows["pools"])
    del pairs, model
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    rows["checks"] = _spec_checks(card, dev, trace, rng)
    launches = _read_counts()
    emit({"phase": "spec_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"spec: attention or CE kernel launches {launches}, want none")
    emit({"phase": "spec_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _qos_overload_trace():
    """Phase qos's overload trace: the port's loadgen make_trace(
    tenants=QOS_TENANTS, tier_mix=QOS_TIER_MIX) over phase serve's prompt
    lengths and new tokens, half sampled at SERVE_TEMP."""
    from distkeras_tpu_torch.examples.loadgen import make_trace
    return make_trace(QOS_REQUESTS, seed=SEED, vocab=LM["vocab_size"],
                      num_steps=SERVE_STEPS, temperature=SERVE_TEMP,
                      prompt_lengths=SERVE_PROMPT_LENS, tenants=QOS_TENANTS,
                      tier_mix=QOS_TIER_MIX)


def _qos_policies():
    """The port's loadgen qos_policies(QOS_TENANTS): fresh objects on
    every call (a policy belongs to one engine)."""
    from distkeras_tpu_torch.examples.loadgen import qos_policies
    return qos_policies(QOS_TENANTS, QOS_INTERACTIVE_WEIGHT)


def _mean_max(xs):
    return [sum(xs) / len(xs), max(xs)] if xs else None


def _run_overload(engine, trace, qps: float, timeout_s: float = 300.0):
    """examples/loadgen.py's run_overload in the port: the engine on its
    background thread (started here, stopped by the caller), the trace
    offered open loop at ``qps`` requests/s, refusals (QueueFull and its
    QuotaExceeded) counted as sheds of their tier, then every handle
    waited for; latencies by tier, completion rates and the engine's QoS
    counters."""
    from distkeras_tpu_torch.examples.loadgen import _percentile_ms
    from distkeras_tpu_torch.serving import QueueFull
    engine.start()
    handles = []
    shed = {"interactive": 0, "batch": 0}
    t0 = time.perf_counter()
    for i, req in enumerate(trace):
        delay = t0 + i / float(qps) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tier = ("interactive" if req.get("tenant") == "interactive"
                else "batch")
        try:
            handles.append((tier, engine.submit(block=False, **req)))
        except QueueFull:
            shed[tier] += 1
    lat = {"interactive": [], "batch": []}
    done = {"interactive": 0, "batch": 0}
    total = dict(shed)
    for tier, h in handles:
        total[tier] += 1
        h.wait(timeout=timeout_s)
        if h.finish in ("eos", "length", "empty"):
            done[tier] += 1
            lat[tier].append(h.latency_s)
    wall = time.perf_counter() - t0
    s = engine.stats
    return {
        "offered_qps": float(qps), "wall_s": wall,
        "interactive_p50_ms": _percentile_ms(lat["interactive"], 50),
        "interactive_p99_ms": _percentile_ms(lat["interactive"], 99),
        "batch_p50_ms": _percentile_ms(lat["batch"], 50),
        "batch_p99_ms": _percentile_ms(lat["batch"], 99),
        "interactive_completion_rate":
            done["interactive"] / max(total["interactive"], 1),
        "batch_completion_rate": done["batch"] / max(total["batch"], 1),
        "requests": {tier: total[tier] for tier in total},
        "shed_interactive": shed["interactive"],
        "shed_batch": shed["batch"],
        "preemptions": s["preemptions"], "resumes": s["resumes"],
        "preempt_swap_ms_mean_max": _mean_max(s["preempt_swap_ms"]),
        "preempt_resume_ms_mean_max": _mean_max(s["preempt_resume_ms"]),
        "kv_blocks_swapped_out": s["kv_blocks_swapped_out"],
        "kv_block_bytes_swapped_out": s["kv_block_bytes_swapped_out"],
        "kv_blocks_resumed": s["kv_blocks_resumed"],
        "kv_block_bytes_resumed": s["kv_block_bytes_resumed"],
        "quota_refused": s["quota_refused"],
        "tenants": {t: dict(v) for t, v in s["tenants"].items()},
    }


def _qos_engine(model, dev: str, policies: bool = True, **knobs):
    """A warmed-up paged engine of phase qos's shape (``knobs`` override
    or add engine arguments), with qos_policies(3) registered or none."""
    kw = dict(paged=True, block_size=PAGED_BLOCK, queue_capacity=QOS_QUEUE,
              tenants=_qos_policies() if policies else None)
    kw.update(knobs)
    return _serve_engine(model, False, **kw)


def _qos_explicit(model, trace, dev: str, preempt: bool, starve: int = 0,
                  **knobs) -> dict:
    """``trace`` (phase serve's (prompt, steps, keywords) form) submitted
    at once as tenant batch0 and driven inline; with ``preempt`` request
    i is marked for preemption once it has emitted QOS_DEPTH0 + i *
    QOS_DEPTH_STEP tokens; with ``starve``, once every request has
    emitted QOS_DEPTH0 tokens, ``starve`` interactive requests arrive
    (the scheduler preempts victims of its own).  The rows, the
    suspensions (tokens emitted, blocks swapped, the slot left and the
    slot resumed into), the swap samples, every decode-only iteration's
    uploads, readbacks, replays and captures, and the pool's state after
    the run."""
    eng = _qos_engine(model, dev, **knobs)
    _sync(dev)
    handles = [eng.submit(p, n, tenant="batch0", **kw) for p, n, kw in trace]
    starved = []
    depth = ({h.id: QOS_DEPTH0 + i * QOS_DEPTH_STEP
              for i, h in enumerate(handles)} if preempt else {})
    marks, swaps, last_slot = {}, {}, {}
    keys = ("decode_steps", "prefills", "prefill_chunks", "preemptions",
            "resumes", "h2d_transfers", "d2h_transfers", "graph_replays",
            "graph_captures")
    per_iter = {k: set() for k in keys[5:]}
    iters = 0
    t0 = time.perf_counter()
    while True:
        before = [eng.stats[k] for k in keys]
        if not eng.step():
            break
        delta = dict(zip(keys, (eng.stats[k] - b
                                for k, b in zip(keys, before))))
        if (delta["decode_steps"] == 1 and not delta["prefills"]
                and not delta["prefill_chunks"]
                and not delta["preemptions"] and not delta["resumes"]):
            iters += 1
            for k in per_iter:
                per_iter[k].add(delta[k])
        if (starve and not starved
                and all(len(h.tokens) >= QOS_DEPTH0 for h in handles)):
            starved = [eng.submit(p[:QOS_STARVE_PROMPT], QOS_STARVE_STEPS,
                                  tenant="interactive")
                       for p, _, _ in trace[:starve]]
        for rid, rec in list(eng._suspended.items()):
            if rid not in swaps:
                swaps[rid] = {"tokens": len(rec.handle.tokens),
                              "pos": rec.pos, "blocks": rec.n_blocks,
                              "slot_left": last_slot.get(rid)}
        for h in handles:
            if h.slot is not None:
                last_slot[h.id] = h.slot
            if (h.id in depth and h.id not in marks and h.slot is not None
                    and len(h.tokens) >= depth[h.id]):
                check(eng.preempt(h), f"qos: preempt() refused request "
                      f"{h.id}")
                marks[h.id] = len(h.tokens)
            if h.id in swaps and "slot_resumed" not in swaps[h.id] \
                    and h.slot is not None:
                swaps[h.id]["slot_resumed"] = h.slot
    _sync(dev)
    wall = time.perf_counter() - t0
    s = eng.stats
    out = {"rows": [h.result() for h in handles],
           "finish": [h.finish for h in handles], "wall_s": wall,
           "interactive_finish": [h.finish for h in starved],
           "swaps": [swaps.get(h.id) for h in handles],
           "decode_only_iterations": iters,
           **{f"{k}_per_decode_iteration": sorted(v)
              for k, v in per_iter.items()},
           "stats": {k: s[k] for k in (
               "requests_completed", "tokens_generated", "decode_steps",
               "preemptions", "resumes", "kv_blocks_swapped_out",
               "kv_block_bytes_swapped_out", "kv_blocks_resumed",
               "kv_block_bytes_resumed", "preempt_swap_ms",
               "preempt_resume_ms", "graph_captures", "graph_replays",
               "tenants")},
           "kv_blocks_in_use": eng.kv_blocks_in_use,
           "conservation": eng._pool.check_conservation(),
           "plans_left": len(eng._plans), "suspended": len(eng._suspended)}
    del eng
    return out


def _qos_leaks(r: dict) -> bool:
    return (r["kv_blocks_in_use"] == 0 and r["conservation"]
            and not r["plans_left"] and not r["suspended"])


def _qos_checks(card: str, dev: str, trace, rng) -> dict:
    """At f32 on a SERVE_CHECK_LAYERS-layer copy, TF32 off: the trace's
    first greedy and first sampled request, each preempted once and
    resumed, on the card equal the same requests unpreempted on the card
    and preempted on the CPU, token for token."""
    import torch
    reqs = [next(r for r in trace if not r[2]),
            next(r for r in trace if r[2])]
    model, plain, cpu = _decode_models({}, rng, dev,
                                       layers=SERVE_CHECK_LAYERS)
    runs = {"card_preempted": _qos_explicit(model, reqs, dev, True),
            "card_plain": _qos_explicit(model, reqs, dev, False)}
    t0 = time.perf_counter()
    runs["cpu_preempted"] = _qos_explicit(cpu, reqs, "cpu", True)
    cpu_s = time.perf_counter() - t0
    vs_plain = _serve_mismatch(runs["card_preempted"]["rows"],
                               runs["card_plain"]["rows"], reqs, plain)
    vs_cpu = _serve_mismatch(runs["card_preempted"]["rows"],
                             runs["cpu_preempted"]["rows"], reqs, plain)
    row = {"phase": "qos_checks", "compute_dtype": "float32",
           "layers": SERVE_CHECK_LAYERS,
           "requests": [{"prompt": len(p), "steps": n, "sampled": bool(kw)}
                        for p, n, kw in reqs],
           "preemptions": runs["card_preempted"]["stats"]["preemptions"],
           "resumes": runs["card_preempted"]["stats"]["resumes"],
           "cpu_preemptions": runs["cpu_preempted"]["stats"]["preemptions"],
           "preempted_equals_unpreempted": vs_plain is None,
           "card_equals_cpu": vs_cpu is None, "cpu_s": cpu_s, "card": card}
    if vs_plain is not None:
        row["vs_unpreempted_first_difference"] = vs_plain
    if vs_cpu is not None:
        row["vs_cpu_first_difference"] = vs_cpu
    emit(row)
    for name, r in runs.items():
        want = 0 if name == "card_plain" else len(reqs)
        check(r["stats"]["preemptions"] == want == r["stats"]["resumes"],
              f"qos checks: {name}: {r['stats']['preemptions']} "
              f"preemptions, {r['stats']['resumes']} resumes, want {want}")
        check(_qos_leaks(r), f"qos checks: {name} leaked blocks")
    check(vs_plain is None, f"qos: at f32 a preempted request differs from "
          f"its unpreempted row: {vs_plain}")
    check(vs_cpu is None, f"qos: at f32 a preempted request on the card "
          f"differs from the CPU: {vs_cpu}")
    del model, plain, cpu
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return row


def phase_qos(card: str, dev: str = "cuda"):
    """Multi-tenant QoS and preemption on the card (the LM at full width,
    bf16, paged, form full): phase serve's first QOS_PREEMPTED requests
    each preempted once at its own depth and resumed, every row equal to
    the unpreempted run's (the swap-out and resume ms, blocks and bytes;
    0 uploads, 1 readback and 1 replay a decode-only iteration with
    tenants registered, and its host calls); the overload trace open loop
    at QOS_QPS requests/s on QOS_KV_BLOCKS blocks, with the policies and
    as plain FIFO (latency by tier, completion, preemptions, resumes, the
    terminal balance, no leak; interactive p99 <= batch p99 with the
    policies); the f32 checks of _qos_checks; no kernel launched on any of
    it (the JAX engine's swap programs and decode run none)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    t_start = time.perf_counter()
    _zero_counts()
    rng = np.random.default_rng(SEED + 15)    # phase serve's trace, weights
    trace = _serve_trace(rng)[:QOS_PREEMPTED]
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, _random_jax_weights(model, rng))
    runs = {"plain": _qos_explicit(model, trace, dev, False),
            "preempted": _qos_explicit(model, trace, dev, True),
            "starved": _qos_explicit(model, trace, dev, False,
                                     starve=QOS_STARVE)}
    prof = _serve_profile(model, False, True, dev, paged=True,
                          block_size=PAGED_BLOCK, tenants=_qos_policies())
    pre, plain, starved = runs["preempted"], runs["plain"], runs["starved"]
    same = _serve_mismatch(pre["rows"], plain["rows"], trace)
    same_starved = _serve_mismatch(starved["rows"], plain["rows"], trace)
    ps, ss = pre["stats"], starved["stats"]
    row = {"phase": "qos_preempt", "form": "full",
           "compute_dtype": LM["compute_dtype"], "slots": SERVE_SLOTS,
           "block_size": PAGED_BLOCK, "requests": len(trace),
           "steps": SERVE_STEPS,
           "resumed_equals_unpreempted": same is None,
           "preemptions": ps["preemptions"], "resumes": ps["resumes"],
           "swaps": [dict(s, prompt=len(p)) for s, (p, _, _) in
                     zip(pre["swaps"], trace)],
           "resumed_in_another_slot": sum(
               s["slot_resumed"] != s["slot_left"] for s in pre["swaps"]),
           "preempt_swap_ms": ps["preempt_swap_ms"],
           "preempt_resume_ms": ps["preempt_resume_ms"],
           "preempt_swap_ms_mean_max": _mean_max(ps["preempt_swap_ms"]),
           "preempt_resume_ms_mean_max": _mean_max(ps["preempt_resume_ms"]),
           "kv_blocks_swapped_out": ps["kv_blocks_swapped_out"],
           "kv_block_bytes_swapped_out": ps["kv_block_bytes_swapped_out"],
           "kv_blocks_resumed": ps["kv_blocks_resumed"],
           "kv_block_bytes_resumed": ps["kv_block_bytes_resumed"],
           "kv_block_bytes": (ps["kv_block_bytes_swapped_out"]
                              // max(ps["kv_blocks_swapped_out"], 1)),
           "starved": {
               "interactive_requests": QOS_STARVE,
               "resumed_equals_unpreempted": same_starved is None,
               "interactive_finish": starved["interactive_finish"],
               "victims": [s for s in starved["swaps"] if s],
               **{k: ss[k] for k in (
                   "preemptions", "resumes", "kv_blocks_swapped_out",
                   "kv_block_bytes_swapped_out", "preempt_swap_ms",
                   "preempt_resume_ms")}},
           "wall_s": {name: r["wall_s"] for name, r in runs.items()},
           "tenants_registered_decode_only_iterations":
               plain["decode_only_iterations"],
           **{f"tenants_registered_{k}": plain[k] for k in (
               "h2d_transfers_per_decode_iteration",
               "d2h_transfers_per_decode_iteration",
               "graph_replays_per_decode_iteration",
               "graph_captures_per_decode_iteration")},
           "graph": {name: [r["stats"]["graph_captures"],
                            r["stats"]["graph_replays"],
                            r["stats"]["decode_steps"]]
                     for name, r in runs.items()},
           "tenants_registered_aten_ops_per_step": prof["aten_ops_per_step"],
           "tenants_registered_graph_launches_per_step":
               prof["graph_launches_per_step"],
           "profile": prof, "card": card}
    if same is not None:
        row["first_difference"] = same
    if same_starved is not None:
        row["starved"]["first_difference"] = same_starved
    emit(row)
    check(same is None, f"qos: a resumed row differs from its unpreempted "
          f"row at bf16: {same}")
    check(same_starved is None, f"qos: a row the scheduler preempted "
          f"differs from its unpreempted row at bf16: {same_starved}")
    check(ss["preemptions"] >= 1 and ss["resumes"] == ss["preemptions"]
          and starved["interactive_finish"] == ["length"] * QOS_STARVE,
          f"qos: starving {QOS_STARVE} interactive requests made "
          f"{ss['preemptions']} preemptions and {ss['resumes']} resumes")
    check(ps["preemptions"] == ps["resumes"] == len(trace),
          f"qos: {ps['preemptions']} preemptions and {ps['resumes']} "
          f"resumes of {len(trace)} marked requests")
    check(ps["kv_blocks_resumed"] == ps["kv_blocks_swapped_out"]
          and ps["kv_block_bytes_resumed"]
          == ps["kv_block_bytes_swapped_out"],
          "qos: resumed blocks or bytes differ from the swapped ones")
    for name, r in runs.items():
        check(r["stats"]["requests_completed"]
              == len(trace) + len(r["interactive_finish"])
              and all(f == "length" for f in r["finish"]),
              f"qos: {name} lost requests")
        check(_qos_leaks(r), f"qos: {name} leaked "
              f"{r['kv_blocks_in_use']} blocks")
        check(r["stats"]["graph_captures"] == 1
              and r["stats"]["graph_replays"] == r["stats"]["decode_steps"],
              f"qos: {name}: {r['stats']['graph_captures']} captures, "
              f"{r['stats']['graph_replays']} replays for "
              f"{r['stats']['decode_steps']} steps")
    check(plain["decode_only_iterations"] > 0
          and plain["h2d_transfers_per_decode_iteration"] == [0]
          and plain["d2h_transfers_per_decode_iteration"] == [1]
          and plain["graph_replays_per_decode_iteration"] == [1]
          and plain["graph_captures_per_decode_iteration"] == [0],
          "qos: with tenants registered a decode-only iteration moved "
          f"{plain['h2d_transfers_per_decode_iteration']} uploads, "
          f"{plain['d2h_transfers_per_decode_iteration']} readbacks, "
          f"{plain['graph_replays_per_decode_iteration']} replays, want "
          "[0], [1], [1]")
    rows = {"preempt": row}
    otrace = _qos_overload_trace()
    for arm in ("policies", "fifo"):
        eng = _qos_engine(model, dev, policies=arm == "policies",
                          kv_blocks=QOS_KV_BLOCKS)
        _sync(dev)
        try:
            point = _run_overload(eng, otrace, QOS_QPS, QOS_TIMEOUT_S)
        finally:
            eng.stop()
        s = eng.stats
        orow = {"phase": "qos_overload", "arm": arm,
                "compute_dtype": LM["compute_dtype"],
                "kv_blocks": eng.kv_blocks, "slots": SERVE_SLOTS,
                "block_size": PAGED_BLOCK, "queue_capacity": QOS_QUEUE,
                "prompt_lens": sorted({len(r["prompt"]) for r in otrace}),
                "sampled_requests": sum("temperature" in r for r in otrace),
                **point,
                "requests_submitted": s["requests_submitted"],
                "requests_completed": s["requests_completed"],
                "requests_failed": s["requests_failed"],
                "requests_rejected": s["requests_rejected"],
                "decode_steps": s["decode_steps"],
                "graph_captures": s["graph_captures"],
                "graph_replays": s["graph_replays"],
                "blocks_evicted": s["blocks_evicted"],
                "kv_blocks_in_use": eng.kv_blocks_in_use,
                "conservation": eng._pool.check_conservation(),
                "suspended": len(eng._suspended), "card": card}
        emit(orow)
        rows[arm] = orow
        check(orow["interactive_completion_rate"] == 1.0
              and orow["batch_completion_rate"] == 1.0,
              f"qos overload {arm}: not every request completed")
        check(orow["resumes"] == orow["preemptions"]
              and orow["kv_blocks_resumed"] == orow["kv_blocks_swapped_out"]
              and orow["kv_block_bytes_resumed"]
              == orow["kv_block_bytes_swapped_out"],
              f"qos overload {arm}: {orow['preemptions']} preemptions, "
              f"{orow['resumes']} resumes, blocks or bytes unbalanced")
        check(s["requests_submitted"] == s["requests_completed"]
              + s["requests_failed"] + s["requests_rejected"],
              f"qos overload {arm}: the terminal balance fails")
        check(orow["kv_blocks_in_use"] == 0 and orow["conservation"]
              and not orow["suspended"],
              f"qos overload {arm}: {orow['kv_blocks_in_use']} blocks "
              f"leaked")
        check(orow["graph_captures"] == 1
              and orow["graph_replays"] == orow["decode_steps"],
              f"qos overload {arm}: {orow['graph_captures']} captures")
        del eng
    check(rows["policies"]["interactive_p99_ms"]
          <= rows["policies"]["batch_p99_ms"],
          f"qos overload: interactive p99 "
          f"{rows['policies']['interactive_p99_ms']} ms above batch p99 "
          f"{rows['policies']['batch_p99_ms']} ms with the policies")
    del model, runs
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    rows["checks"] = _qos_checks(card, dev, _serve_trace(
        np.random.default_rng(SEED + 15)), rng)
    launches = _read_counts()
    emit({"phase": "qos_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"qos: attention or CE kernel launches {launches}, want none")
    emit({"phase": "qos_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _disagg_engines(model, **knobs):
    """A warmed-up prefill-role and decode-role engine of phase disagg's
    shape (examples/loadgen.py:607-615 build_engine(disaggregate=True,
    prefill_engines=1) at full width)."""
    kw = dict(paged=True, block_size=PAGED_BLOCK)
    kw.update(knobs)
    return (_serve_engine(model, False, role="prefill", **kw),
            _serve_engine(model, False, role="decode", **kw))


def _block_bytes() -> int:
    """One KV block's payload bytes by the LM's arithmetic: every layer's
    k and v rows of PAGED_BLOCK tokens, num_kv_heads x head dim entries of
    the compute dtype (4 x 2 x 16 x 2 x 32 x 2 B = 16,384 B)."""
    head_dim = LM["d_model"] // LM["num_heads"]
    itemsize = 2 if LM["compute_dtype"] in ("bfloat16", "float16") else 4
    return (LM["num_layers"] * 2 * PAGED_BLOCK * LM["num_kv_heads"]
            * head_dim * itemsize)


def _pair_inline(pre, dec, trace, dev: str) -> dict:
    """``trace`` (phase serve's (prompt, steps, keywords) form) through an
    in-process DisaggPair: the prefill engine on its own thread, the
    decode engine driven inline here (its step is what its own loop would
    run), each decode-only iteration's uploads, readbacks, replays and
    captures recorded; the rows, the wall time and both engines' state
    after the run."""
    from distkeras_tpu_torch.serving import DisaggPair
    pair = DisaggPair([pre], decode=dec, poll_s=0.001)
    keys = ("decode_steps", "kv_blocks_ingested", "h2d_transfers",
            "d2h_transfers", "graph_replays", "graph_captures")
    per_iter = {k: set() for k in keys[2:]}
    iters = 0
    _sync(dev)
    t0 = time.perf_counter()
    pre.start()
    try:
        handles = [pair.submit(p, n, **kw) for p, n, kw in trace]
        while not all(h.done for h in handles):
            before = [dec.stats[k] for k in keys]
            if not dec.step():
                with dec._qlock:
                    dec._have_work.wait_for(lambda: dec._qdepth > 0,
                                            timeout=0.002)
                continue
            delta = dict(zip(keys, (dec.stats[k] - b
                                    for k, b in zip(keys, before))))
            if delta["decode_steps"] == 1 and not delta[
                    "kv_blocks_ingested"]:
                iters += 1
                for k in per_iter:
                    per_iter[k].add(delta[k])
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        pair.stop()
    return {"rows": [h.result() for h in handles],
            "finish": [h.finish for h in handles], "wall_s": wall,
            "decode_only_iterations": iters,
            **{f"{k}_per_decode_iteration": sorted(v)
               for k, v in per_iter.items()},
            **_pair_state(pair, pre, dec)}


def _pair_state(pair, pre, dec) -> dict:
    """A pair's counters, its two engines' transfer and graph counters
    and their pools' state (leaks, conservation); ``dec`` may sit behind
    a server, outside the pair."""
    c = dict(pair.counters)
    return {
        "counters": c,
        "balanced": c["requests_submitted"] == sum(c[k] for k in (
            "requests_completed", "requests_failed", "requests_rejected",
            "requests_cancelled", "requests_expired")),
        "transfer": {k: e.stats[k] for e, ks in (
            (pre, ("kv_blocks_shipped", "kv_block_bytes_shipped")),
            (dec, ("kv_blocks_ingested", "kv_block_bytes_ingested")))
            for k in ks},
        "extract_ms": list(pre.stats["transfer_ms"]),
        "ingest_ms": list(dec.stats["transfer_ms"]),
        "prefill_graph_captures": pre.stats["graph_captures"],
        "prefill_decode_steps": pre.stats["decode_steps"],
        "decode_graph": [dec.stats["graph_captures"],
                         dec.stats["graph_replays"],
                         dec.stats["decode_steps"]],
        "decode_prefills": dec.stats["prefills"],
        "kv_blocks_in_use": [pre.kv_blocks_in_use, dec.kv_blocks_in_use],
        "conservation": (pre._pool.check_conservation()
                         and dec._pool.check_conservation()),
        "plans_left": len(pre._plans) + len(dec._plans)}


def _pair_clean(s: dict) -> bool:
    return (s["kv_blocks_in_use"] == [0, 0] and s["conservation"]
            and not s["plans_left"] and s["balanced"])


def _pair_wire(pre, dec, trace, dev: str) -> dict:
    """``trace`` through a DisaggPair whose decode engine sits behind a
    ServingServer (event core) on 127.0.0.1: the blocks ship over the
    wire (``'k'``) and the tokens stream back."""
    from distkeras_tpu_torch.serving import DisaggPair, ServingServer
    srv = ServingServer(dec, host="127.0.0.1", server_core="event",
                        poll_s=0.002).start()
    try:
        pair = DisaggPair([pre], decode_addr=srv.addr, poll_s=0.001)
        _sync(dev)
        t0 = time.perf_counter()
        pair.start()
        try:
            handles = [pair.submit(p, n, **kw) for p, n, kw in trace]
            for h in handles:
                h.wait(timeout=QOS_TIMEOUT_S)
            wall = time.perf_counter() - t0
        finally:
            pair.stop()
        _wait_state(lambda: dec.kv_blocks_in_use == 0)
        out = {"rows": [h.result() for h in handles],
               "finish": [h.finish for h in handles], "wall_s": wall,
               **_pair_state(pair, pre, dec)}
        out["handoff_ms"] = _wire_handoff_ms(pre, srv)
    finally:
        srv.stop()
    return out


def _wire_handoff_ms(pre, srv) -> dict:
    """The wire hand-off of the largest block set (a DISAGG_PROMPT_LENS
    maximum prompt through the prefill engine inline): its frame's bytes,
    the pure-Python encode's ms, and DISAGG_WIRE_REPS ``'k'`` round trips
    (frame out, the server's validate and copy, admission, ack back), each
    request then streamed to its end (2 tokens)."""
    import numpy as np
    from distkeras_tpu_torch import networking
    from distkeras_tpu_torch.serving import ServingClient
    p_len = max(DISAGG_PROMPT_LENS)
    prompt = np.random.default_rng(SEED + 17).integers(
        0, LM["vocab_size"], p_len).astype(np.int32)
    h = pre.submit(prompt, 2)
    pre.run_until_idle()
    kvb = h.kvblocks
    t0 = time.perf_counter()
    frame = networking.encode_message({"blocks": kvb, "prompt": prompt,
                                       "first_token": int(h.tokens[0]),
                                       "num_steps": 2})
    encode_ms = (time.perf_counter() - t0) * 1e3
    acks = []
    with ServingClient(*srv.addr) as c:
        for _ in range(DISAGG_WIRE_REPS):
            t0 = time.perf_counter()
            rid = c.submit_prefilled(kvb, prompt, int(h.tokens[0]), 2)
            acks.append((time.perf_counter() - t0) * 1e3)
            for _, done in c.stream(rid):
                if done is not None:
                    break
    return {"prompt": p_len, "blocks": kvb.num_blocks,
            "payload_bytes": kvb.nbytes, "frame_bytes": len(frame),
            "encode_ms": encode_ms, "ack_ms": acks}


def _wait_state(pred, timeout: float = 30.0) -> bool:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


def _disagg_bimodal_trace():
    """Phase disagg's interference trace: make_trace's bimodal pattern
    (the port's loadgen make_trace) over DISAGG_PROMPT_LENS,
    DISAGG_LONG_FRACTION long, greedy."""
    from distkeras_tpu_torch.examples.loadgen import make_trace
    return make_trace(DISAGG_REQUESTS, seed=SEED, vocab=LM["vocab_size"],
                      num_steps=SERVE_STEPS,
                      prompt_lengths=DISAGG_PROMPT_LENS, pattern="bimodal",
                      long_fraction=DISAGG_LONG_FRACTION)


def _interference(engine, trace, dev: str) -> dict:
    """bench.py:870-886 at full width: the engine (a unified paged engine
    or a DisaggPair) started after its warmup, the whole bimodal trace
    submitted at once, every handle waited for; the per-token decode
    latency ``(latency - ttft) / (tokens - 1)`` of the short requests
    (its p50 and p99), TTFT p50/p99 of the short and of every request."""
    from distkeras_tpu_torch.examples.loadgen import _percentile_ms
    short = min(DISAGG_PROMPT_LENS)
    _sync(dev)
    engine.start()
    try:
        t0 = time.perf_counter()
        hs = [(req, engine.submit(**req)) for req in trace]
        per_tok, ttft, ttft_short = [], [], []
        for req, h in hs:
            h.wait(timeout=QOS_TIMEOUT_S)
            ttft.append(h.ttft_s)
            if len(req["prompt"]) == short:
                ttft_short.append(h.ttft_s)
                if h.finish in ("eos", "length") and len(h.tokens) >= 2:
                    per_tok.append((h.latency_s - h.ttft_s)
                                   / (len(h.tokens) - 1))
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    return {"decode_p50_ms": _percentile_ms(per_tok, 50),
            "decode_p99_ms": _percentile_ms(per_tok, 99),
            "ttft_p50_ms": _percentile_ms(ttft, 50),
            "ttft_p99_ms": _percentile_ms(ttft, 99),
            "short_ttft_p50_ms": _percentile_ms(ttft_short, 50),
            "short_ttft_p99_ms": _percentile_ms(ttft_short, 99),
            "short_requests": len(per_tok), "wall_s": wall,
            "rows": [h.result() for _, h in hs],
            "finish": [h.finish for _, h in hs]}


def _disagg_shipped(pre, dev: str) -> dict:
    """One prompt of each of SERVE_PROMPT_LENS through the prefill engine
    inline: the blocks and bytes it ships and its extraction ms."""
    import numpy as np
    rng = np.random.default_rng(SEED + 18)
    out = {}
    for p_len in SERVE_PROMPT_LENS:
        h = pre.submit(rng.integers(0, LM["vocab_size"], p_len).astype(
            np.int32), 2)
        pre.run_until_idle()
        out[p_len] = {"blocks": h.kvblocks.num_blocks,
                      "bytes": h.kvblocks.nbytes,
                      "extract_ms": pre.stats["transfer_ms"][-1]}
    _sync(dev)
    return out


def _disagg_profile(pre, dec, dev: str) -> dict:
    """SERVE_SLOTS shipped requests in steady decode on the decode-role
    engine (64-token prompts prefilled by the prefill engine inline):
    SERVE_PROFILE_STEPS decode-only iterations under torch.profiler (ATen
    calls, graph launches and busy time an iteration), then the requests
    cancelled and the engine idle again.  The ingests' ms samples are
    kept too: taken here with no other engine thread running, beside
    the pair runs' samples, where the prefill engine's thread competes
    for the interpreter and the card."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 16)
    shipped = []
    for _ in range(SERVE_SLOTS):
        prompt = rng.integers(0, LM["vocab_size"], 64).astype(np.int32)
        h = pre.submit(prompt, 2)
        pre.run_until_idle()
        shipped.append((h.kvblocks, prompt, int(h.tokens[0])))
    hs = [dec.submit_prefilled(kvb, p, t, LM["seq_len"] - 64)
          for kvb, p, t in shipped]
    n_ingest = len(dec.stats["transfer_ms"])
    while dec.queue_depth:
        dec.step()
    ingest_ms = dec.stats["transfer_ms"][n_ingest:]
    for _ in range(4):
        dec.step()
    _sync(dev)
    before = {k: dec.stats[k] for k in ("graph_replays", "graph_captures",
                                        "h2d_transfers", "d2h_transfers")}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            dec.step()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = _host_calls(prof)
    n = SERVE_PROFILE_STEPS
    busy_ms = calls.pop("device_busy_us") / 1e3 / n
    row = {"wall_ms_per_step": wall_ms / n,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (wall_ms / n),
           **{f"{k}_per_step": v / n for k, v in calls.items()},
           **{f"{k}_per_step": (dec.stats[k] - v) / n
              for k, v in before.items()},
           "ingest_ms_alone_64_tokens": ingest_ms}
    for h in hs:
        dec.cancel(h)
    dec.run_until_idle()
    return row


def _disagg_checks(card: str, dev: str, trace, rng) -> dict:
    """At f32 on a SERVE_CHECK_LAYERS-layer copy, TF32 off: the trace's
    first greedy and first sampled request through an in-process pair on
    the card equal the unified paged engine on the card and the same pair
    on the CPU, token for token."""
    import torch
    reqs = [next(r for r in trace if not r[2]),
            next(r for r in trace if r[2])]
    model, plain, cpu = _decode_models({}, rng, dev,
                                       layers=SERVE_CHECK_LAYERS)
    unified = _serve_run(model, reqs, False, dev, paged=True,
                         block_size=PAGED_BLOCK)
    card_pair = _pair_inline(*_disagg_engines(model), reqs, dev)
    t0 = time.perf_counter()
    cpu_pair = _pair_inline(*_disagg_engines(cpu), reqs, "cpu")
    cpu_s = time.perf_counter() - t0
    vs_unified = _serve_mismatch(card_pair["rows"], unified["rows"], reqs,
                                 plain)
    vs_cpu = _serve_mismatch(card_pair["rows"], cpu_pair["rows"], reqs,
                             plain)
    row = {"phase": "disagg_checks", "compute_dtype": "float32",
           "layers": SERVE_CHECK_LAYERS,
           "requests": [{"prompt": len(p), "steps": n, "sampled": bool(kw)}
                        for p, n, kw in reqs],
           "pair_equals_unified": vs_unified is None,
           "card_equals_cpu": vs_cpu is None, "cpu_s": cpu_s,
           "clean": [_pair_clean(card_pair), _pair_clean(cpu_pair)],
           "card": card}
    if vs_unified is not None:
        row["vs_unified_first_difference"] = vs_unified
    if vs_cpu is not None:
        row["vs_cpu_first_difference"] = vs_cpu
    emit(row)
    check(vs_unified is None, f"disagg: at f32 a pair's row differs from "
          f"the unified engine's: {vs_unified}")
    check(vs_cpu is None, f"disagg: at f32 the pair on the card differs "
          f"from the CPU: {vs_cpu}")
    check(all(row["clean"]), "disagg checks: a pair leaked blocks or "
          "lost a request")
    del model, plain, cpu
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return row


def _share_equal(got_rows, want_rows) -> float:
    import numpy as np
    return (sum(np.array_equal(a, b) for a, b in zip(got_rows, want_rows))
            / max(len(want_rows), 1))


def _wire_client_run(eng, trace, core: str) -> dict:
    """(c): ``trace`` from one ServingClient against a ServingServer
    (``core``) over ``eng``, an idle unified paged engine: every request
    submitted, then each streamed to its final row; a load() probe; one
    long request cancelled mid-stream on the same socket; the pool and
    the connections after the client closes (the server stops the
    engine, which a later server may start again)."""
    import numpy as np
    from distkeras_tpu_torch.serving import ServingClient, ServingServer
    cancelled = eng.stats["requests_cancelled"]
    srv = ServingServer(eng, host="127.0.0.1", server_core=core,
                        poll_s=0.002).start()
    try:
        t0 = time.perf_counter()
        with ServingClient(*srv.addr) as c:
            rids = [c.submit(p, n, **kw) for p, n, kw in trace]
            load = c.load()
            finals = []
            for rid in rids:
                final = None
                for _, done in c.stream(rid):
                    if done is not None:
                        final = done
                finals.append(final)
            wall = time.perf_counter() - t0
            p, _, _ = max(trace, key=lambda r: len(r[0]))
            rid = c.submit(p, SERVE_STEPS)
            gen = c.stream(rid)
            first, _ = next(gen)
            c.cancel(rid, await_ack=False)
            cancel_final = None
            for _, done in gen:
                if done is not None:
                    cancel_final = done
        freed = _wait_state(lambda: eng.kv_blocks_in_use == 0)
        closed = _wait_state(lambda: srv.live_connections == 0)
        out = {"core": core, "wall_s": wall,
               "rows": [np.asarray(f["row"]) for f in finals],
               "finish": [f["finish"] for f in finals],
               "load_keys": sorted(load), "load_slots_total":
                   load.get("slots_total"),
               "cancel_first_chunk": len(first),
               "cancel_finish": cancel_final["finish"],
               "cancel_tokens": len(cancel_final["row"]) - len(p),
               "blocks_freed": freed, "connections_closed": closed,
               "kv_blocks_in_use": eng.kv_blocks_in_use,
               "conservation": eng._pool.check_conservation(),
               "requests_cancelled": (eng.stats["requests_cancelled"]
                                      - cancelled),
               "disconnects": srv.disconnects,
               "protocol_errors": srv.protocol_errors}
    finally:
        srv.stop()
    return out


def phase_disagg(card: str, dev: str = "cuda"):
    """Disaggregated prefill/decode roles and the wire front-end on the
    card (the LM at full width, bf16, paged, blocks of 16, form full, 8
    slots an engine, chunks of 128): (a) phase serve's trace through the
    unified paged engine, an in-process DisaggPair (its decode engine
    driven inline: 0 uploads, 1 readback and 1 replay a decode-only
    iteration) and a pair whose decode engine is behind a ServingServer
    (event core), every row equal; shipped = ingested blocks and bytes =
    the block arithmetic; no leak, the prefill engine captures no graph;
    the extraction and ingest ms, blocks and bytes per prompt length, the
    wire hand-off of the largest block set; the decode engine's host calls
    an iteration; (b) the bimodal interference trace through the unified
    engine and the in-process pair: per-token decode p99 of the short
    requests, TTFT, ``serving_kv_transfer_bytes``; (c) phase serve's first
    DISAGG_WIRE_REQUESTS requests from a ServingClient against a
    ServingServer over a unified paged engine, once per core, equal to
    (a)'s rows, with a load() probe and a mid-stream cancel that frees its
    blocks; the f32 checks of _disagg_checks; no kernel launched on any of
    it (the JAX engine's role programs run none)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.serving import DisaggPair, SERVING_CORES
    t_start = time.perf_counter()
    _zero_counts()
    rng = np.random.default_rng(SEED + 15)    # phase serve's trace, weights
    trace = _serve_trace(rng)
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, _random_jax_weights(model, rng))
    block_bytes = _block_bytes()
    want_blocks = sum(-(-len(p) // PAGED_BLOCK) for p, _, _ in trace)
    # (a) rows
    unified = _serve_run(model, trace, False, dev, paged=True,
                         block_size=PAGED_BLOCK)
    pre, dec = _disagg_engines(model)
    inproc = _pair_inline(pre, dec, trace, dev)
    shipped = _disagg_shipped(pre, dev)
    prof = _disagg_profile(pre, dec, dev)
    wire = _pair_wire(*_disagg_engines(model), trace, dev)
    same = {name: _serve_mismatch(r["rows"], unified["rows"], trace)
            for name, r in (("in_process", inproc), ("wire", wire))}
    row = {"phase": "disagg_rows", "form": "full",
           "compute_dtype": LM["compute_dtype"], "slots": SERVE_SLOTS,
           "block_size": PAGED_BLOCK, "prefill_chunk": SERVE_CHUNK,
           "requests": len(trace), "steps": SERVE_STEPS,
           "prompt_lens": sorted({len(p) for p, _, _ in trace}),
           "sampled_requests": sum(bool(kw) for _, _, kw in trace),
           **{f"{name}_equals_unified": m is None
              for name, m in same.items()},
           **{f"{name}_share_equal": _share_equal(r["rows"],
                                                  unified["rows"])
              for name, r in (("in_process", inproc), ("wire", wire))},
           "wall_s": {"unified": unified["wall_s"],
                      "in_process_pair": inproc["wall_s"],
                      "wire_pair": wire["wall_s"]},
           "block_bytes": block_bytes,
           "want_blocks": want_blocks,
           "want_bytes": want_blocks * block_bytes,
           "transfer": {"in_process": inproc["transfer"],
                        "wire": wire["transfer"]},
           "extract_ms_p50_max": [float(np.median(inproc["extract_ms"])),
                                  max(inproc["extract_ms"])],
           "ingest_ms_p50_max": [float(np.median(inproc["ingest_ms"])),
                                 max(inproc["ingest_ms"])],
           "shipped_per_prompt_len": shipped,
           "wire_handoff": wire["handoff_ms"],
           "decode_only_iterations": inproc["decode_only_iterations"],
           **{f"decode_{k}": inproc[k] for k in (
               "h2d_transfers_per_decode_iteration",
               "d2h_transfers_per_decode_iteration",
               "graph_replays_per_decode_iteration",
               "graph_captures_per_decode_iteration")},
           "decode_graph": {"in_process": inproc["decode_graph"],
                            "wire": wire["decode_graph"]},
           "prefill_graph_captures": [inproc["prefill_graph_captures"],
                                      wire["prefill_graph_captures"]],
           "decode_aten_ops_per_step": prof["aten_ops_per_step"],
           "decode_graph_launches_per_step": prof["graph_launches_per_step"],
           "decode_profile": prof,
           "counters": {"in_process": inproc["counters"],
                        "wire": wire["counters"]},
           "card": card}
    for name, m in same.items():
        if m is not None:
            row[f"{name}_first_difference"] = m
    emit(row)
    for name, m in same.items():
        check(m is None, f"disagg: a row through the {name} pair differs "
              f"from the unified engine's: {m}")
    for name, r in (("in_process", inproc), ("wire", wire)):
        t = r["transfer"]
        check(t["kv_blocks_shipped"] == t["kv_blocks_ingested"]
              == want_blocks
              and t["kv_block_bytes_shipped"] == t["kv_block_bytes_ingested"]
              == want_blocks * block_bytes,
              f"disagg {name}: shipped/ingested {t}, want {want_blocks} "
              f"blocks of {block_bytes} B")
        check(r["kv_blocks_in_use"] == [0, 0] and r["conservation"]
              and not r["plans_left"] and r["balanced"]
              and r["counters"]["requests_completed"] == len(trace)
              and all(f == "length" for f in r["finish"]),
              f"disagg {name}: leaked blocks or lost requests: "
              f"{r['kv_blocks_in_use']}, {r['counters']}")
        check(r["prefill_graph_captures"] == 0,
              f"disagg {name}: the prefill engine captured a graph")
        g = r["decode_graph"]
        check(g[0] == 1 and g[1] == g[2],
              f"disagg {name}: decode engine {g[0]} captures, {g[1]} "
              f"replays for {g[2]} steps")
    check(inproc["decode_only_iterations"] > 0
          and inproc["h2d_transfers_per_decode_iteration"] == [0]
          and inproc["d2h_transfers_per_decode_iteration"] == [1]
          and inproc["graph_replays_per_decode_iteration"] == [1]
          and inproc["graph_captures_per_decode_iteration"] == [0],
          "disagg: a decode-only iteration of the decode engine moved "
          f"{inproc['h2d_transfers_per_decode_iteration']} uploads, "
          f"{inproc['d2h_transfers_per_decode_iteration']} readbacks, "
          f"{inproc['graph_replays_per_decode_iteration']} replays, "
          f"{inproc['graph_captures_per_decode_iteration']} captures, "
          "want [0], [1], [1], [0]")
    for p_len, s in shipped.items():
        want = -(-p_len // PAGED_BLOCK)
        check(s["blocks"] == want and s["bytes"] == want * block_bytes,
              f"disagg: a {p_len}-token prompt shipped {s}, want {want} "
              f"blocks")
    rows = {"rows": row}
    # (b) interference: make_trace's bimodal pattern, greedy (a long
    # prompt gets SERVE_STEPS // 4 new tokens, as make_trace gives it)
    btrace = _disagg_bimodal_trace()
    ueng = _serve_engine(model, False, paged=True, block_size=PAGED_BLOCK)
    arms = {"unified": _interference(ueng, btrace, dev)}
    bpre, bdec = _disagg_engines(model)
    bpair = DisaggPair([bpre], decode=bdec, poll_s=0.001)
    arms["disagg"] = _interference(bpair, btrace, dev)
    bstate = _pair_state(bpair, bpre, bdec)
    bsame = _serve_mismatch(arms["disagg"]["rows"], arms["unified"]["rows"],
                            [(r["prompt"], r["num_steps"], {})
                             for r in btrace])
    brow = {"phase": "disagg_interference", "pattern": "bimodal",
            "requests": len(btrace),
            "long_requests": sum(len(r["prompt"]) == max(DISAGG_PROMPT_LENS)
                                 for r in btrace),
            "prompt_lens": list(DISAGG_PROMPT_LENS),
            "long_fraction": DISAGG_LONG_FRACTION,
            "serving_unified_decode_p99_ms":
                arms["unified"]["decode_p99_ms"],
            "serving_disagg_decode_p99_ms": arms["disagg"]["decode_p99_ms"],
            "serving_kv_transfer_bytes":
                bstate["transfer"]["kv_block_bytes_shipped"],
            **{f"{arm}_{k}": r[k] for arm, r in arms.items() for k in (
                "decode_p50_ms", "ttft_p50_ms", "ttft_p99_ms",
                "short_ttft_p50_ms", "short_ttft_p99_ms", "short_requests",
                "wall_s")},
            "rows_equal": bsame is None,
            "extract_ms_p50_max": [float(np.median(bstate["extract_ms"])),
                                   max(bstate["extract_ms"])],
            "ingest_ms_p50_max": [float(np.median(bstate["ingest_ms"])),
                                  max(bstate["ingest_ms"])],
            "counters": bstate["counters"], "card": card}
    if bsame is not None:
        brow["first_difference"] = bsame
    emit(brow)
    rows["interference"] = brow
    bwant = sum(-(-len(r["prompt"]) // PAGED_BLOCK) for r in btrace)
    check(bstate["transfer"]["kv_block_bytes_shipped"]
          == bstate["transfer"]["kv_block_bytes_ingested"]
          == bwant * block_bytes,
          f"disagg interference: shipped {bstate['transfer']}, want "
          f"{bwant} blocks")
    check(_pair_clean(bstate)
          and bstate["counters"]["requests_completed"] == len(btrace),
          f"disagg interference: leaked blocks or lost requests: "
          f"{bstate['kv_blocks_in_use']}, {bstate['counters']}")
    check(bsame is None, f"disagg interference: a pair row differs from "
          f"the unified engine's: {bsame}")
    del bpre, bdec, bpair, pre, dec
    # (c) the wire front-end, once per core
    wtrace = trace[:DISAGG_WIRE_REQUESTS]
    for core in SERVING_CORES:
        w = _wire_client_run(ueng, wtrace, core)
        wsame = _serve_mismatch(w.pop("rows"),
                                unified["rows"][:DISAGG_WIRE_REQUESTS],
                                wtrace)
        wrow = {"phase": "disagg_wire", **w,
                "streamed_equals_in_process": wsame is None, "card": card}
        if wsame is not None:
            wrow["first_difference"] = wsame
        emit(wrow)
        rows[f"wire_{core}"] = wrow
        check(wsame is None, f"disagg wire {core}: a streamed row differs "
              f"from the in-process row: {wsame}")
        check(all(f == "length" for f in w["finish"])
              and w["cancel_finish"] == "cancel"
              and w["requests_cancelled"] == 1
              and w["blocks_freed"] and w["conservation"],
              f"disagg wire {core}: finishes {w['finish']}, cancel "
              f"{w['cancel_finish']}, {w['kv_blocks_in_use']} blocks left")
        check(w["connections_closed"], f"disagg wire {core}: connections "
              "still open after the client closed")
        check(w["load_slots_total"] == SERVE_SLOTS,
              f"disagg wire {core}: load() probe {w['load_keys']}")
    del model, ueng
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    rows["checks"] = _disagg_checks(card, dev, trace, rng)
    launches = _read_counts()
    emit({"phase": "disagg_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"disagg: attention or CE kernel launches {launches}, want none")
    emit({"phase": "disagg_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _fleet_engine(model):
    """One replica of phase fleet's shape, unstarted and not warmed up:
    the phase's engine factory (the router's ``warmup``, a supervisor's
    restart and ``rolling_swap`` warm each replica up before it goes
    live; on the card that captures its decode graph)."""
    from distkeras_tpu_torch.serving import ServingEngine
    return ServingEngine(model, num_slots=SERVE_SLOTS,
                         max_len=LM["seq_len"], prefill_chunk=SERVE_CHUNK,
                         paged=True, block_size=PAGED_BLOCK)


class _FleetClock:
    """Phase fleet's own instrumentation (installed for the phase, the
    port untouched): every engine's scheduler iteration
    (``ServingEngine.step``, the unit ``liveness_deadline`` must cover)
    and every decode graph capture (``serving._capture_graph``) timed on
    the host clock, with the number of engine threads serving while each
    capture ran."""

    def __init__(self):
        import threading
        from distkeras_tpu_torch import serving
        self.serving = serving
        self.iter_max_s = 0.0
        self.iters = 0
        self.captures = []
        self._lock = threading.Lock()

    def __enter__(self):
        import threading
        s = self.serving
        step, capture = self._orig = (s.ServingEngine.step,
                                      s._capture_graph)
        clock = self

        def timed_step(eng):
            t0 = time.perf_counter()
            try:
                return step(eng)
            finally:
                dt = time.perf_counter() - t0
                with clock._lock:
                    clock.iters += 1
                    clock.iter_max_s = max(clock.iter_max_s, dt)

        def timed_capture(fn, device):
            serving_threads = sum(t.name == "dkt-serving-engine"
                                  for t in threading.enumerate())
            t0 = time.perf_counter()
            graph = capture(fn, device)
            clock.captures.append({"ms": (time.perf_counter() - t0) * 1e3,
                                   "engines_serving": serving_threads})
            return graph

        s.ServingEngine.step, s._capture_graph = timed_step, timed_capture
        return self

    def __exit__(self, *exc):
        self.serving.ServingEngine.step, self.serving._capture_graph = \
            self._orig


def _fleet_router(model, n: int, **kw):
    """A started router over ``n`` fresh replicas, every one warmed up."""
    from distkeras_tpu_torch.router import ServingRouter
    return ServingRouter([_fleet_engine(model) for _ in range(n)],
                         **kw).warmup().start()


def _fleet_drive(router, trace, concurrency=None, timeout: float = 600.0):
    """``trace`` through a started router, all at once or as a closed loop
    of ``concurrency`` users (each submits its next request when its last
    one has finished): the proxies, the wall time and the tokens
    streamed."""
    import queue
    import threading
    finished, seen, lock = queue.Queue(), set(), threading.Lock()

    def listener(h):
        def fire():
            if h.done:
                with lock:
                    if h.id in seen:
                        return
                    seen.add(h.id)
                finished.put(h)
        return fire

    handles, pending, live = [], list(trace), 0
    t0 = time.perf_counter()
    while pending or live:
        while pending and (concurrency is None or live < concurrency):
            prompt, steps, kw = pending.pop(0)
            h = router.submit(prompt, steps, **kw)
            handles.append(h)
            live += 1
            h.set_listener(listener(h))
        finished.get(timeout=timeout)
        live -= 1
    wall = time.perf_counter() - t0
    return {"handles": handles, "wall_s": wall,
            "tokens": sum(len(h.tokens) for h in handles),
            "lost": sum(h.error is not None for h in handles)}


def _fleet_rows(handles):
    import numpy as np
    return [h.result() if h.error is None
            else np.zeros(0, np.int32) for h in handles]


def _fleet_clean(router) -> dict:
    """The surviving replicas' pools once their requests retired: blocks
    in use (waited for), conservation, leftover plans; and the router's
    terminal balance."""
    live = [e for e in router.engines if e.dead is None]
    _wait_state(lambda: all(e.kv_blocks_in_use == 0 for e in live), 30.0)
    c = router.counters
    return {"kv_blocks_in_use": [e.kv_blocks_in_use for e in live],
            "conservation": all(e._pool.check_conservation()
                                for e in live),
            "plans_left": sum(len(e._plans) for e in live),
            "balanced": c["requests_submitted"] == sum(c[k] for k in (
                "requests_completed", "requests_failed",
                "requests_cancelled", "requests_expired"))}


def _fleet_is_clean(s: dict) -> bool:
    return (not any(s["kv_blocks_in_use"]) and s["conservation"]
            and not s["plans_left"] and s["balanced"])


def _fleet_supervised(model, trace, want, dev: str) -> dict:
    """(e), first part: a FleetSupervisor over 2 replicas; replica 0 is
    declared dead once it has streamed tokens under the trace, the
    supervisor's thread restarts it (the clone's warmup, its graph capture
    included, runs while replica 1 serves), and the clone then serves a
    request on its own."""
    from distkeras_tpu_torch.resilience import FleetSupervisor
    r = _fleet_router(model, 2, affinity="least-loaded")
    sup = FleetSupervisor(r, heartbeat_interval=FLEET_HEARTBEAT_S,
                          liveness_deadline=FLEET_LIVENESS_S).start()
    try:
        old = r.engines[0]
        hs = [r.submit(p, n, **kw) for p, n, kw in trace]
        on0 = [h for h in hs if r.generation_of(h)[0] == 0]
        check(_wait_state(lambda: any(len(h.tokens) for h in on0), 120.0),
              "fleet supervised: replica 0 streamed nothing")
        mid = sum(0 < len(h.tokens) and not h.done for h in on0)
        old.declare_dead("chip_smoke: replica 0 killed under traffic")
        for h in hs:
            h.wait(timeout=600.0)
        restarted = _wait_state(lambda: sup.restarts >= 1, 120.0)
        new = r.engines[0]
        i = next(i for i, (_, _, kw) in enumerate(trace) if kw)
        p, n, kw = trace[i]
        solo = new.submit(p, n, **kw)
        solo_row = solo.result(timeout=600.0)
        out = {"rows": _fleet_rows(hs),
               "lost": sum(h.error is not None for h in hs),
               "on_replica_0": len(on0), "killed_mid_stream": mid,
               "recoveries": list(sup.recoveries),
               "restarted": restarted and new is not old
               and new.dead is None,
               "generation": r.fleet_snapshot()[0]["generation"],
               "solo_request": i,
               "solo_equal": bool((solo_row == want[i]).all()),
               "counters": dict(r.counters)}
    finally:
        sup.stop()
    out["clean"] = _fleet_clean(r)
    r.stop()
    return out


def _fleet_swap(model, trace, dev: str) -> dict:
    """(e), second part: ``rolling_swap`` while ``trace`` streams through
    2 replicas: every response attributed to one ``(uid, generation)``,
    the swap's wall time."""
    r = _fleet_router(model, 2, affinity="least-loaded")
    hs = [r.submit(p, n, **kw) for p, n, kw in trace]
    check(_wait_state(lambda: sum(bool(h.tokens) for h in hs) >= 2,
                      120.0), "fleet rolling swap: nothing streamed")
    streaming = sum(not h.done for h in hs)
    t0 = time.perf_counter()
    swapped = r.rolling_swap(drain_timeout=600.0)
    swap_s = time.perf_counter() - t0
    for h in hs:
        h.wait(timeout=600.0)
    gens = [r.generation_of(h) for h in hs]
    out = {"rows": _fleet_rows(hs), "swapped": swapped, "swap_s": swap_s,
           "streaming_at_swap": streaming,
           "lost": sum(h.error is not None for h in hs),
           "attributions": [list(g) if g is not None else None
                            for g in gens],
           "generations": [s["generation"] for s in r.fleet_snapshot()],
           "counters": dict(r.counters)}
    out["clean"] = _fleet_clean(r)
    r.stop()
    return out


def _fleet_server(model, reqs, want, dev: str) -> dict:
    """(e), third part: an EngineSupervisor over a ServingServer whose
    engine crashes in its decode step; a ServingClient's
    ``generate(retry_policy=...)`` completes on the restarted engine."""
    from distkeras_tpu_torch.resilience import EngineSupervisor, RetryPolicy
    from distkeras_tpu_torch.serving import ServingClient, ServingServer
    eng = _fleet_engine(model).warmup()
    srv = ServingServer(eng, poll_s=0.01).start()
    sup = EngineSupervisor(srv, heartbeat_interval=FLEET_HEARTBEAT_S,
                           liveness_deadline=FLEET_LIVENESS_S).start()

    def boom():
        raise RuntimeError("chip_smoke: decode step crashed")

    try:
        with ServingClient(*srv.addr) as c:
            (p0, n0, kw0), (p1, n1, kw1) = reqs
            before = c.generate(p0, n0, **kw0)
            eng._decode_once = boom
            t0 = time.perf_counter()
            after = c.generate(p1, n1, retry_policy=RetryPolicy(
                attempts=None, backoff=0.05, deadline=300.0), **kw1)
            retry_s = time.perf_counter() - t0
        new = srv.engine
        _wait_state(lambda: new.kv_blocks_in_use == 0, 30.0)
        return {"rows_equal": [bool((before == want[0]).all()),
                               bool((after == want[1]).all())],
                "retry_s": retry_s, "recoveries": list(sup.recoveries),
                "restarted": new is not eng and new.dead is None,
                "kv_blocks_in_use": new.kv_blocks_in_use}
    finally:
        sup.stop()
        srv.stop()


def phase_fleet(card: str, dev: str = "cuda"):
    """The serving router and the supervisors on the card (the LM at full
    width, bf16, paged, blocks of 16, form full, 8 slots a replica, chunks
    of 128; N in-process unified replicas of one model on the one card):
    (a) phase serve's trace through a 1-replica and a 2-replica "prefix"
    router, every row equal to the single paged engine's; (b)
    ``serving_fleet_tokens_per_sec`` at N = 1, 2, 4 ("least-loaded",
    closed loop at 4 N users); (c) ``serving_fleet_prefix_hit_rate``
    under "prefix" and "random" over phase paged's shared-prefix trace;
    (d) ``serving_fleet_failover_lost_requests`` (replica 0 of 2 killed
    once every request on it has streamed a token; the rows equal); (e) a
    FleetSupervisor's restart of a replica killed under traffic, a
    rolling swap under traffic and an EngineSupervisor's restart behind a
    ServingServer, each clone warmed (its decode graph captured) while
    the other replicas serve; the recovery ms, the captures' ms, the
    longest scheduler iteration against the liveness deadline, no block
    leaked, no kernel launched (the JAX router and supervisors run
    none)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    t_start = time.perf_counter()
    _zero_counts()
    rng = np.random.default_rng(SEED + 15)    # phase serve's trace, weights
    trace = _serve_trace(rng)
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, _random_jax_weights(model, rng))
    cuda = torch.device(dev).type == "cuda"
    rows = {}
    with _FleetClock() as clock:
        ref = _serve_run(model, trace, False, dev, paged=True,
                         block_size=PAGED_BLOCK)
        want = ref["rows"]
        # (a) rows through 1 and 2 replicas
        arow = {"phase": "fleet_rows", "requests": len(trace),
                "steps": SERVE_STEPS,
                "sampled_requests": sum(bool(kw) for _, _, kw in trace),
                "single_engine_wall_s": ref["wall_s"], "card": card}
        for n in (1, 2):
            r = _fleet_router(model, n, affinity="prefix")
            d = _fleet_drive(r, trace)
            got = _fleet_rows(d["handles"])
            miss = _serve_mismatch(got, want, trace)
            arow[f"replicas_{n}"] = {
                "equal": miss is None, "share_equal": _share_equal(got, want),
                "first_difference": miss, "wall_s": d["wall_s"],
                "lost": d["lost"], "counters": dict(r.counters),
                "routed": [s["routed"] for s in r.fleet_snapshot()],
                "clean": _fleet_clean(r)}
            r.stop()
            del r
        emit(arow)
        rows["rows"] = arow
        for n in (1, 2):
            a = arow[f"replicas_{n}"]
            check(a["equal"], f"fleet rows: a row through {n} replica(s) "
                  f"differs from the single engine's: "
                  f"{a['first_difference']}")
            check(a["lost"] == 0 and _fleet_is_clean(a["clean"]),
                  f"fleet rows {n}: lost {a['lost']}, {a['clean']}")
        # (b) scaling: the closed loop at 4 N users
        brow = {"phase": "fleet_scaling", "affinity": "least-loaded",
                "users_per_replica": FLEET_USERS_PER_REPLICA,
                "serving_fleet_tokens_per_sec": {}, "wall_s": {},
                "decode_steps_per_sec": {}, "routed": {},
                "slot_occupancy": {},
                "switch_interval_s": sys.getswitchinterval(), "card": card}
        for n in FLEET_SIZES:
            r = _fleet_router(model, n, affinity="least-loaded")
            d = _fleet_drive(r, trace,
                             concurrency=FLEET_USERS_PER_REPLICA * n)
            brow["serving_fleet_tokens_per_sec"][str(n)] = (d["tokens"]
                                                            / d["wall_s"])
            brow["wall_s"][str(n)] = d["wall_s"]
            # every replica's decode iterations together: flat in N when
            # the schedulers' host work serializes
            brow["decode_steps_per_sec"][str(n)] = (
                r.stats["decode_steps"] / d["wall_s"])
            brow["routed"][str(n)] = [s["routed"]
                                      for s in r.fleet_snapshot()]
            brow["slot_occupancy"][str(n)] = r.slot_occupancy
            clean = _fleet_clean(r)
            r.stop()
            check(d["lost"] == 0 and _fleet_is_clean(clean),
                  f"fleet scaling {n}: lost {d['lost']}, {clean}")
        tps = brow["serving_fleet_tokens_per_sec"]
        brow["speedup_vs_1"] = {k: v / tps["1"] for k, v in tps.items()}
        emit(brow)
        rows["scaling"] = brow
        # (c) prefix affinity against the random control arm
        ptrace = _prefix_trace(LM["vocab_size"])
        crow = {"phase": "fleet_affinity", "replicas": 2,
                "requests": len(ptrace), "users": PREFIX_USERS,
                "serving_fleet_prefix_hit_rate": {}, "counters": {},
                "routed": {}, "card": card}
        for policy in ("prefix", "random"):
            r = _fleet_router(model, 2, affinity=policy, seed=0)
            r.submit(*ptrace[0][:2]).result(timeout=600.0)  # warm once
            st0 = r.stats
            d = _fleet_drive(r, ptrace, concurrency=PREFIX_USERS)
            st = r.stats
            hits = st["prefix_hit_tokens"] - st0["prefix_hit_tokens"]
            pre = st["prefill_tokens"] - st0["prefill_tokens"]
            crow["serving_fleet_prefix_hit_rate"][policy] = (
                hits / (hits + pre) if hits + pre else None)
            crow["counters"][policy] = dict(r.counters)
            crow["routed"][policy] = [s["routed"]
                                      for s in r.fleet_snapshot()]
            clean = _fleet_clean(r)
            r.stop()
            check(d["lost"] == 0 and _fleet_is_clean(clean),
                  f"fleet affinity {policy}: lost {d['lost']}, {clean}")
        emit(crow)
        rows["affinity"] = crow
        hr = crow["serving_fleet_prefix_hit_rate"]
        check(hr["prefix"] is not None and hr["random"] is not None
              and hr["prefix"] >= hr["random"],
              f"fleet affinity: prefix hit rate {hr['prefix']} below "
              f"random {hr['random']}")
        # (d) failover: replica 0 of 2 killed with every request on it
        # mid-stream
        ftrace = trace[:FLEET_FAILOVER_REQUESTS]
        r = _fleet_router(model, 2, affinity="least-loaded")
        hs = [r.submit(p, n, **kw) for p, n, kw in ftrace]
        on0 = [h for h in hs if r.generation_of(h)[0] == 0]
        check(_wait_state(lambda: all(len(h.tokens) for h in on0), 300.0),
              "fleet failover: a request on replica 0 streamed nothing")
        mid = sum(not h.done for h in on0)
        r.engines[0].declare_dead("chip_smoke: fleet failover leg")
        for h in hs:
            h.wait(timeout=600.0)
        got = _fleet_rows(hs)
        miss = _serve_mismatch(got, want[:len(ftrace)], ftrace)
        drow = {"phase": "fleet_failover", "requests": len(ftrace),
                "on_replica_0": len(on0), "mid_stream_at_kill": mid,
                "serving_fleet_failover_lost_requests":
                    sum(h.error is not None or not h.done for h in hs),
                "resubmissions": r.counters["resubmissions"],
                "equal": miss is None,
                "share_equal": _share_equal(got, want[:len(ftrace)]),
                "first_difference": miss, "counters": dict(r.counters),
                "clean": _fleet_clean(r), "card": card}
        r.stop()
        emit(drow)
        rows["failover"] = drow
        check(drow["serving_fleet_failover_lost_requests"] == 0,
              f"fleet failover: {drow['serving_fleet_failover_lost_requests']}"
              " requests lost")
        check(drow["resubmissions"] >= len(on0) > 0,
              f"fleet failover: {drow['resubmissions']} resubmissions for "
              f"{len(on0)} requests on the killed replica")
        check(miss is None, f"fleet failover: a resubmitted row differs: "
              f"{miss}")
        check(_fleet_is_clean(drow["clean"]),
              f"fleet failover: {drow['clean']}")
        # (e) supervisors and swaps under traffic
        sup = _fleet_supervised(model, trace, want, dev)
        swap = _fleet_swap(model, trace[:FLEET_SWAP_REQUESTS], dev)
        si = next(i for i, (_, _, kw) in enumerate(trace) if kw)
        server = _fleet_server(model, [trace[0], trace[si]],
                               [want[0], want[si]], dev)
    if cuda:
        torch.cuda.empty_cache()
    smiss = _serve_mismatch(sup["rows"], want, trace)
    wmiss = _serve_mismatch(swap["rows"], want[:FLEET_SWAP_REQUESTS],
                            trace[:FLEET_SWAP_REQUESTS])
    captures = clock.captures
    erow = {"phase": "fleet_supervisors",
            "liveness_deadline_s": FLEET_LIVENESS_S,
            "heartbeat_interval_s": FLEET_HEARTBEAT_S,
            "max_iteration_ms": clock.iter_max_s * 1e3,
            "iterations": clock.iters,
            "graph_captures": len(captures),
            "capture_ms": [c["ms"] for c in captures],
            "capture_ms_under_traffic": [c["ms"] for c in captures
                                         if c["engines_serving"]],
            "supervised": {k: sup[k] for k in (
                "lost", "on_replica_0", "killed_mid_stream", "recoveries",
                "restarted",
                "generation", "solo_request", "solo_equal", "counters",
                "clean")},
            "supervised_equal": smiss is None,
            "supervised_share_equal": _share_equal(sup["rows"], want),
            "recovery_ms": [rec.get("recovery_ms")
                            for rec in sup["recoveries"]],
            "swap": {k: swap[k] for k in (
                "swapped", "swap_s", "streaming_at_swap", "lost",
                "attributions", "generations", "counters", "clean")},
            "swap_equal": wmiss is None,
            "swap_share_equal": _share_equal(swap["rows"],
                                             want[:FLEET_SWAP_REQUESTS]),
            "server": server, "card": card}
    if smiss is not None:
        erow["supervised_first_difference"] = smiss
    if wmiss is not None:
        erow["swap_first_difference"] = wmiss
    emit(erow)
    rows["supervisors"] = erow
    check(sup["lost"] == 0 and sup["restarted"] and sup["solo_equal"]
          and len(sup["recoveries"]) == 1
          and sup["recoveries"][0]["restarted"] and sup["generation"] == 1,
          f"fleet supervised restart: lost {sup['lost']}, restarted "
          f"{sup['restarted']}, solo row equal {sup['solo_equal']}, "
          f"recoveries {sup['recoveries']}")
    check(smiss is None, f"fleet supervised restart: a row differs: {smiss}")
    check(_fleet_is_clean(sup["clean"]), f"fleet supervised: {sup['clean']}")
    s = swap
    check(s["swapped"] == 2 and s["counters"]["generation_swaps"] == 2
          and s["lost"] == 0 and s["generations"] == [1, 1]
          and all(a is not None and a[1] in (0, 1)
                  for a in s["attributions"]),
          f"fleet rolling swap: swapped {s['swapped']}, counters "
          f"{s['counters']}, attributions {s['attributions']}")
    check(wmiss is None, f"fleet rolling swap: a row differs: {wmiss}")
    check(_fleet_is_clean(s["clean"]), f"fleet rolling swap: {s['clean']}")
    check(server["restarted"] and all(server["rows_equal"])
          and len(server["recoveries"]) == 1
          and not server["kv_blocks_in_use"],
          f"fleet server restart: {server}")
    check(clock.iter_max_s < FLEET_LIVENESS_S,
          f"fleet: an iteration took {clock.iter_max_s:.3f} s, over the "
          f"liveness deadline {FLEET_LIVENESS_S} s")
    if cuda:  # the supervised clone and the two swapped-in clones
        check(len(erow["capture_ms_under_traffic"]) >= 3,
              f"fleet: fewer than 3 captures ran while other replicas "
              f"served: {captures}")
    launches = _read_counts()
    emit({"phase": "fleet_launches", "launches": launches})
    check(not any(n for n in launches.values() if isinstance(n, int))
          and not any(any(n.values()) for n in launches.values()
                      if isinstance(n, dict)),
          f"fleet: attention or CE kernel launches {launches}, want none")
    emit({"phase": "fleet_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def _host_ps_rows():
    """phase adag's rows (features scaled by 1/255, one-hot labels) and
    HOST_PS_TEST_ROWS held-out rows with their class ids."""
    import numpy as np
    from distkeras_tpu_torch.data import load_mnist
    train, test = load_mnist(n_train=ADAG_ROWS, n_test=HOST_PS_TEST_ROWS)
    x = np.asarray(train["features"], np.float32) / 255.0
    y = np.eye(10, dtype=np.float32)[np.asarray(train["label"])]
    return (x, y, np.asarray(test["features"], np.float32) / 255.0,
            np.asarray(test["label"]))


def _host_ps_run(trainer_cls, model, x, y, dev: str, workers: int,
                 epochs: int = 1, **kw) -> dict:
    """One host-PS training run on the card: examples/s on the host clock
    (the whole train() call: the server, the workers' models, the
    epochs), round trips a window, the window losses, the PS clock."""
    import numpy as np
    from distkeras_tpu_torch import Dataset
    kw.setdefault("batch_size", ADAG_BATCH)
    kw.setdefault("communication_window", ADAG_WINDOW)
    t = trainer_cls(model, num_workers=workers, num_epoch=epochs,
                    execution="host_ps", device=dev, seed=SEED, **kw)
    t0 = time.perf_counter()
    fitted = t.train(Dataset({"features": x, "label": y}))
    _sync(dev)
    seconds = time.perf_counter() - t0
    ws = t._ps_workers
    commits = sum(w._commits for w in ws)
    shards = t.ps_shards
    server = t._ps_server
    if hasattr(server, "snapshot"):  # a sharded group: a clock a shard
        center, clock = server.snapshot()
    else:
        center, clock = server.ps.center, server.ps.num_updates
    return {"trainer": t, "fitted": fitted, "seconds": seconds,
            "examples_per_sec": len(x) * epochs / seconds,
            "comm_overlap": t.comm_overlap,
            # bench.py:140-170: messages a window beyond each worker's
            # initial pull (per shard: every op goes to each shard)
            "rtts_per_window": (sum(w.transport_ops for w in ws) / shards
                                - len(ws)) / commits,
            "commits": commits, "clock": clock,
            "commit_bytes": sum(w.commit_bytes for w in ws),
            "windows_per_worker": [len(w.history) for w in ws],
            "first_last_loss": [[w.history[0], w.history[-1]] for w in ws],
            "loss_falls": all(w.history[-1] < w.history[0] for w in ws),
            "center_finite": all(np.isfinite(c).all() for c in center)}


def _host_ps_row(run: dict, **extra) -> dict:
    return {k: v for k, v in run.items()
            if k not in ("trainer", "fitted")} | extra


def _host_ps_convnet(card: str, dev: str, rows) -> dict:
    """Legs 1-3 and 5 of phase host_ps (the ConvNet); returns the
    examples/s of the 2-thread overlapped run for the scaling line."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD, DynSGD,
                                     models)
    x, y, xt, lt = rows
    convnet = lambda: models.mnist_convnet("bfloat16", device=dev)
    # a one-window warm-up first: a process's first convolutions (cuDNN's
    # algorithm choice, each thread's handle) would land in the first
    # timed leg (an H100 at 700 W read 16,741 examples/s there cold
    # against 54,815 for the same epoch run next)
    n = HOST_PS_WORKERS * ADAG_WINDOW * ADAG_BATCH
    warm = _host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, HOST_PS_WORKERS,
                        worker_optimizer="adam")
    emit({"phase": "host_ps_warmup", "seconds": warm["seconds"],
          "card": card})
    # (1) the north-star workload through the PS, overlap on and off
    for overlap, rtts in ((True, 1.0), (False, 2.0)):
        r = _host_ps_run(ADAG, convnet(), x, y, dev, HOST_PS_WORKERS,
                         worker_optimizer="adam", comm_overlap=overlap)
        acc = float(np.mean(np.argmax(r["fitted"].predict(xt), axis=1)
                            == lt))
        emit({"phase": "host_ps_convnet",
              **_host_ps_row(r, accuracy_held_out=acc), "card": card})
        check(r["comm_overlap"] is overlap and r["rtts_per_window"] == rtts,
              f"host_ps convnet: {r['rtts_per_window']} round trips a "
              f"window with comm_overlap={overlap}, want {rtts}")
        check(r["loss_falls"] and r["center_finite"]
              and r["clock"] == r["commits"],
              f"host_ps convnet (overlap {overlap}): losses "
              f"{r['first_last_loss']}, finite {r['center_finite']}, clock "
              f"{r['clock']} vs {r['commits']} commits")
        if overlap:
            two_threads = r["examples_per_sec"]
    # (2) every other algorithm, a few windows a worker
    n = HOST_PS_WORKERS * HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    for cls in (DOWNPOUR, DynSGD, AEASGD, EAMSGD):
        kw = dict(ALGO_RUNS[cls.__name__], communication_window=ADAG_WINDOW)
        r = _host_ps_run(cls, convnet(), x[:n], y[:n], dev,
                         HOST_PS_WORKERS, **kw)
        emit({"phase": "host_ps_algorithm", "algorithm": cls.__name__,
              **_host_ps_row(r), "card": card})
        check(r["loss_falls"] and r["center_finite"]
              and r["clock"] == r["commits"],
              f"host_ps {cls.__name__}: losses {r['first_last_loss']}, "
              f"clock {r['clock']} vs {r['commits']} commits")
    # (3) one worker, serial: twice bit for bit, then the wire codings
    n = HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    one = dict(worker_optimizer="adam", comm_overlap=False)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = [_host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, 1, **one)
                for _ in range(2)]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    same = all(np.array_equal(a, b) for a, b in zip(
        runs[0]["fitted"].get_weights(), runs[1]["fitted"].get_weights()))
    f32_bytes = runs[0]["commit_bytes"] / runs[0]["commits"]
    emit({"phase": "host_ps_repeat", "bit_identical": same,
          "histories_equal": (runs[0]["trainer"].get_history()
                              == runs[1]["trainer"].get_history()),
          "f32_bytes_per_commit": f32_bytes, "card": card})
    check(same, "host_ps: the one-worker serial repeat is not "
          "bit-identical")
    for coding, share in (("bfloat16", 0.5), ("int8", 0.25)):
        r = _host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, 1,
                         wire_dtype=coding, **one)
        per_commit = r["commit_bytes"] / r["commits"]
        emit({"phase": "host_ps_wire", "wire_dtype": coding,
              "bytes_per_commit": per_commit,
              "share_of_f32": per_commit / f32_bytes,
              "scales_per_commit": (len(r["fitted"].get_weights())
                                    if coding == "int8" else 0),
              **_host_ps_row(r), "card": card})
        check(per_commit == share * f32_bytes and r["loss_falls"]
              and r["center_finite"],
              f"host_ps wire {coding}: {per_commit} bytes a commit "
              f"(f32 {f32_bytes}), losses {r['first_last_loss']}")
    # (5) scaling: examples/s at HOST_PS_SCALING threads (printed only)
    scaling = {}
    for workers in HOST_PS_SCALING:
        r = _host_ps_run(ADAG, convnet(), x, y, dev, workers,
                         worker_optimizer="adam")
        scaling[workers] = r["examples_per_sec"]
        check(r["center_finite"], f"host_ps scaling {workers}: non-finite")
    emit({"phase": "host_ps_scaling", "examples_per_sec": scaling,
          "convnet_two_threads_leg": two_threads, "card": card})
    return scaling


def _host_ps_lm_rows():
    """HOST_PS_LM_ROWS rows of phase train's x+1 task at the LM's width."""
    import numpy as np
    rng = np.random.default_rng(SEED + 17)
    x = rng.integers(0, LM["vocab_size"],
                     (HOST_PS_LM_ROWS, LM["seq_len"])).astype(np.int32)
    return x, ((x + 1) % LM["vocab_size"]).astype(np.int64)


def _host_ps_lm(card: str, dev: str) -> dict:
    """Leg 4 of phase host_ps: the full LM under ADAG from two worker
    threads at once; the flash kernels' launches counted from 0."""
    from distkeras_tpu_torch import ADAG, Dataset, transformer_lm
    x, y = _host_ps_lm_rows()
    t = ADAG(transformer_lm(**LM, device=dev),
             num_workers=HOST_PS_WORKERS, batch_size=BATCH, num_epoch=1,
             communication_window=HOST_PS_LM_WINDOW,
             loss="sparse_categorical_crossentropy_from_logits",
             worker_optimizer="adam", learning_rate=3e-3, seed=SEED,
             execution="host_ps", device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    t.train(Dataset({"features": x, "label": y}))
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    ws = t._ps_workers
    steps = sum(len(w.history) for w in ws) * HOST_PS_LM_WINDOW
    want = LM["num_layers"] * steps
    row = {"phase": "host_ps_lm", "workers": len(ws), "steps": steps,
           "seconds": seconds,
           "tokens_per_sec": HOST_PS_LM_ROWS * LM["seq_len"] / seconds,
           "first_last_loss": [[w.history[0], w.history[-1]] for w in ws],
           "launches_sm90": {k: launches[f"flash_{k}_sm90"]
                             for k in ("fwd_lse", "dq", "dkv")},
           "want_each": want, "card": card}
    emit(row)
    check(all(w.history[-1] < w.history[0] for w in ws),
          f"host_ps lm: the loss did not fall {row['first_last_loss']}")
    if dev == "cuda":
        check(all(n == want for n in row["launches_sm90"].values()),
              f"host_ps lm: sm90 launches {row['launches_sm90']}, want "
              f"{want} each (layers x steps x workers)")
    return launches


def phase_host_ps(card: str, dev: str = "cuda"):
    """The in-process host parameter server on the card (legs 1-5 of the
    HOST_PS_* comment): the ConvNet legs launch no attention or CE
    kernel; the LM leg's two worker threads launch the sm90 training
    kernels exactly once per layer and step.  Returns (the scaling line,
    the phase's launches)."""
    t_start = time.perf_counter()
    _zero_counts()
    scaling = _host_ps_convnet(card, dev, _host_ps_rows())
    convnet_launches = _read_counts()
    check(not any(convnet_launches.values()),
          f"host_ps convnet: kernel launches {convnet_launches}, want none")
    launches = _host_ps_lm(card, dev)
    emit({"phase": "host_ps_launches", "launches": launches})
    emit({"phase": "host_ps_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return scaling, launches


def _add_counts(total: dict, more: dict) -> dict:
    """Two launch-count dicts summed key by key."""
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def _ps_sparse_shards(card: str, dev: str, rows) -> dict:
    """Leg (a) of phase ps_sparse: the ConvNet at 1 and 3 shards, one
    worker, serial, to the bit; 2 threads with overlap at 1 and
    PS_SPARSE_SHARDS shards.  Returns the 1-shard 2-thread run (the dense
    reference of leg (b))."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import ADAG, models
    x, y, xt, lt = rows
    convnet = lambda: models.mnist_convnet("bfloat16", device=dev)
    n = HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    serial = dict(worker_optimizer="adam", comm_overlap=False)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = [_host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, 1,
                             ps_shards=k, **serial)
                for k in PS_SPARSE_SERIAL_SHARDS]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    same = all(np.array_equal(a, b) for a, b in zip(
        runs[0]["fitted"].get_weights(), runs[1]["fitted"].get_weights()))
    hist = [r["trainer"].get_history() for r in runs]
    emit({"phase": "ps_sparse_serial_shards",
          "shards": list(PS_SPARSE_SERIAL_SHARDS), "bit_identical": same,
          "histories_equal": hist[0] == hist[1],
          "transport_ops": [r["trainer"]._ps_workers[0].transport_ops
                            for r in runs],
          "commits": [r["commits"] for r in runs], "card": card})
    check(same and hist[0] == hist[1],
          f"ps_sparse: one worker at {PS_SPARSE_SERIAL_SHARDS} shards is "
          "not bit-identical")
    out = {}
    for shards in (1, PS_SPARSE_SHARDS):
        r = _host_ps_run(ADAG, convnet(), x, y, dev, HOST_PS_WORKERS,
                         worker_optimizer="adam", ps_shards=shards)
        ws = r["trainer"]._ps_workers
        acc = float(np.mean(np.argmax(r["fitted"].predict(xt), axis=1)
                            == lt))
        one_u = all(w.transport_ops == shards * (1 + w._commits)
                    for w in ws)
        pools = ([[(p.misses, p.hits) for p in w._shard_client.pools]
                  for w in ws] if shards > 1 else None)
        emit({"phase": "ps_sparse_overlap", "ps_shards": shards,
              **_host_ps_row(r, accuracy_held_out=acc,
                             one_u_per_window_per_shard=one_u,
                             pool_misses_hits=pools), "card": card})
        clocks = r["clock"] if shards > 1 else [r["clock"]]
        check(r["comm_overlap"] and one_u and r["loss_falls"]
              and r["center_finite"] and acc >= PS_SPARSE_ACC_MIN
              and all(c == r["commits"] for c in clocks),
              f"ps_sparse overlap at {shards} shards: one 'u' a window a "
              f"shard {one_u}, losses {r['first_last_loss']}, accuracy "
              f"{acc}, clocks {clocks} vs {r['commits']} commits")
        if pools is not None:
            check(all(p == (1, w._commits) for w, ps in zip(ws, pools)
                      for p in ps),
                  f"ps_sparse: shard receive pools {pools}, want 1 miss "
                  "and a hit a commit")
        out[shards] = dict(r, accuracy=acc)
    emit({"phase": "ps_sparse_shard_scaling",
          "examples_per_sec": {k: v["examples_per_sec"]
                               for k, v in out.items()}, "card": card})
    return out[1]


def _ps_sparse_selection(card: str, dev: str, x, y) -> list:
    """Leg (b)'s check of one device selection a code: a worker's top-k
    window on the first window of rows against that window's own dense
    delta on the card."""
    import numpy as np
    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.core.model import serialize_model
    from distkeras_tpu_torch.device import host_to_device
    from distkeras_tpu_torch.workers import ADAGWorker
    blob = serialize_model(models.mnist_convnet("bfloat16", device=dev))
    n = ADAG_WINDOW * ADAG_BATCH
    shape = (ADAG_WINDOW, ADAG_BATCH)
    xw = host_to_device(x[:n].reshape(shape + x.shape[1:]), dev)
    yw = host_to_device(y[:n].reshape(shape + y.shape[1:]), dev)
    mw = np.ones(shape, np.float32)
    rows = []
    for code in (None, "bfloat16", "int8"):
        w = ADAGWorker(blob, "adam", "categorical_crossentropy",
                       "127.0.0.1", 1, communication_window=ADAG_WINDOW,
                       batch_size=ADAG_BATCH, wire_dtype="topk",
                       wire_topk=PS_SPARSE_TOPK, wire_topk_dtype=code,
                       device=dev)
        w._ensure_model()
        flat = lambda: np.concatenate([a.reshape(-1)
                                       for a in w._params_to_weights()])
        base = flat()
        p = w._params
        _, _, packed = w._run_topk_window(
            p, w._tx.init(list(p.values())), xw, yw, mw, w._generator(0))
        sparse, loss = w._fetch_sparse(packed)
        delta = flat() - base
        res = w._residual_dev.cpu().numpy()
        peak = float(np.max(np.abs(delta)))
        err = float(np.max(np.abs(delta - (sparse.to_dense() + res))))
        gap = (float(np.min(np.abs(sparse.f32_values())))
               - float(np.max(np.abs(res))))
        row = {"phase": "ps_sparse_selection", "code": code,
               "k": sparse.nnz, "n": int(delta.size),
               "max_abs_delta": peak, "identity_err": err,
               "min_selected_minus_max_residual": gap, "loss": loss,
               "card": card}
        emit(row)
        check(err <= 1e-5 * peak and sparse.nnz == w._wire_k,
              f"ps_sparse selection ({code}): after - base differs from "
              f"densify(selected) + residual by {err} (max |delta| {peak})")
        if code is None:  # coded values carry their coding error
            check(gap >= -1e-5,
                  f"ps_sparse selection: a residual outweighs a selected "
                  f"value by {-gap}")
        rows.append(row)
    return rows


def _ps_sparse_topk(card: str, dev: str, rows, dense: dict) -> dict:
    """Leg (b) of phase ps_sparse: top-k commits from 2 threads with
    overlap, f32, bf16 and int8 values and f32 at PS_SPARSE_TOPK_SHARDS
    shards, against the dense run of leg (a)."""
    import numpy as np
    from distkeras_tpu_torch import ADAG, models
    x, y, xt, lt = rows
    dense_bytes = dense["commit_bytes"] / dense["commits"]
    out = {}
    for code, shards in ((None, 1), ("bfloat16", 1), ("int8", 1),
                         (None, PS_SPARSE_TOPK_SHARDS)):
        r = _host_ps_run(ADAG, models.mnist_convnet("bfloat16", device=dev),
                         x, y, dev, HOST_PS_WORKERS, worker_optimizer="adam",
                         wire_dtype="topk", wire_topk=PS_SPARSE_TOPK,
                         wire_topk_dtype=code, ps_shards=shards)
        acc = float(np.mean(np.argmax(r["fitted"].predict(xt), axis=1)
                            == lt))
        per = r["commit_bytes"] / r["commits"]
        key = f"{code or 'float32'}@{shards}"
        emit({"phase": "ps_sparse_topk", "code": code, "ps_shards": shards,
              **_host_ps_row(r, accuracy_held_out=acc, bytes_per_commit=per,
                             share_of_dense=per / dense_bytes,
                             examples_per_sec_dense=dense[
                                 "examples_per_sec"]), "card": card})
        check(per <= 0.05 * dense_bytes and r["loss_falls"]
              and r["center_finite"]
              and acc >= dense["accuracy"] - PS_SPARSE_ACC_BAND,
              f"ps_sparse topk {key}: {per} bytes a commit (dense "
              f"{dense_bytes}), losses {r['first_last_loss']}, accuracy "
              f"{acc} vs dense {dense['accuracy']}")
        out[key] = r["examples_per_sec"]
    out["selection"] = _ps_sparse_selection(card, dev, x, y)
    return out


def _ps_sparse_lm(card: str, dev: str) -> dict:
    """Leg (c) of phase ps_sparse, the LM: a one-window warm-up, then
    row-sparse against dense and 3 shards against 1, each run's kernel
    launches counted from 0.  Returns the leg's launches summed (the
    warm-up's included)."""
    import numpy as np
    from distkeras_tpu_torch import DOWNPOUR, Dataset, transformer_lm
    x, y = _host_ps_lm_rows()

    def trainer(rs, shards):
        return DOWNPOUR(transformer_lm(**LM, device=dev), num_workers=1,
                        batch_size=BATCH, num_epoch=1,
                        communication_window=HOST_PS_LM_WINDOW,
                        loss="sparse_categorical_crossentropy_from_logits",
                        worker_optimizer="adam", learning_rate=3e-3,
                        seed=SEED, execution="host_ps", row_sparse=rs,
                        ps_shards=shards, device=dev)

    # one window first: the process's first LM steps (cuBLAS handles, the
    # allocator) would land in the first timed run (an H100 at 700 W
    # read 97,752 tokens/s there against 207,159 for the run after it)
    n = BATCH * HOST_PS_LM_WINDOW
    _zero_counts()
    trainer(True, 1).train(Dataset({"features": x[:n], "label": y[:n]}))
    _sync(dev)
    total, weights, hists = _read_counts(), {}, {}
    for rs, shards in ((True, 1), (None, 1),
                       (True, PS_SPARSE_SERIAL_SHARDS[1])):
        t = trainer(rs, shards)
        _zero_counts()
        t0 = time.perf_counter()
        fitted = t.train(Dataset({"features": x, "label": y}))
        _sync(dev)
        seconds = time.perf_counter() - t0
        launches = _read_counts()
        total = _add_counts(total, launches)
        w = t._ps_workers[0]
        steps = len(w.history) * HOST_PS_LM_WINDOW
        want = LM["num_layers"] * steps
        sm90 = {k: launches[f"flash_{k}_sm90"]
                for k in ("fwd_lse", "dq", "dkv")}
        trained = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
                   for v in ("", "_sm90")}
        others = {k: n for k, n in launches.items()
                  if n and k not in trained}
        key = f"{'row_sparse' if rs else 'dense'}@{shards}"
        weights[key] = fitted.get_weights()
        hists[key] = list(w.history)
        emit({"phase": "ps_sparse_lm", "run": key,
              "row_sparse_tables": list(w.row_sparse_tables),
              "steps": steps, "seconds": seconds,
              "tokens_per_sec": HOST_PS_LM_ROWS * LM["seq_len"] / seconds,
              "commit_bytes_per_commit": w.commit_bytes / w._commits,
              "first_last_loss": [w.history[0], w.history[-1]],
              "launches_sm90": sm90, "launches_other": others,
              "want_each": want, "card": card})
        check(w.history[-1] < w.history[0],
              f"ps_sparse lm {key}: the loss did not fall {w.history}")
        if dev == "cuda":
            check(all(n == want for n in sm90.values()) and not others,
                  f"ps_sparse lm {key}: sm90 launches {sm90}, others "
                  f"{others}, want {want} each and nothing else")
    runs = list(weights)
    equal = {f"{a}=={b}": (all(np.array_equal(p, q) for p, q in
                                zip(weights[a], weights[b]))
                            and hists[a] == hists[b])
             for a, b in ((runs[0], runs[1]), (runs[0], runs[2]))}
    emit({"phase": "ps_sparse_lm_equal", **equal, "card": card})
    check(all(equal.values()), f"ps_sparse lm: runs differ {equal}")
    return total


def _ps_sparse_embedding(card: str, dev: str) -> dict:
    """Leg (c) of phase ps_sparse, the embedding model: commit bytes a
    window, row-sparse against dense."""
    import numpy as np
    from distkeras_tpu_torch import DOWNPOUR, Dataset, Sequential
    from distkeras_tpu_torch.core.layers import Dense, Embedding, Flatten
    vocab, dim = PS_SPARSE_EMB
    rng = np.random.default_rng(SEED + 23)
    mapping = rng.integers(0, 4, vocab)
    items = rng.integers(0, vocab, PS_SPARSE_EMB_ROWS).astype(
        np.int32).reshape(-1, 1)
    ds = Dataset({"features": items,
                  "label": np.eye(4, dtype=np.float32)[mapping[items[:, 0]]]})
    out = {}
    for rs in (None, True):
        model = Sequential([Embedding(vocab, dim), Flatten(),
                            Dense(4, activation="softmax")],
                           input_shape=(1,), compute_dtype="float32",
                           device=dev)
        t = DOWNPOUR(model, num_workers=1, batch_size=PS_SPARSE_EMB_BATCH,
                     num_epoch=1, communication_window=PS_SPARSE_EMB_WINDOW,
                     worker_optimizer="sgd", learning_rate=0.5, seed=SEED,
                     execution="host_ps", row_sparse=rs, comm_overlap=False,
                     device=dev)
        t0 = time.perf_counter()
        t.train(ds)
        _sync(dev)
        w = t._ps_workers[0]
        out["row_sparse" if rs else "dense"] = {
            "bytes_per_commit": w.commit_bytes / w._commits,
            "commits": w._commits,
            "seconds": time.perf_counter() - t0,
            "first_last_loss": [w.history[0], w.history[-1]]}
    dense, sparse = (out[k]["bytes_per_commit"]
                     for k in ("dense", "row_sparse"))
    emit({"phase": "ps_sparse_embedding", "table": list(PS_SPARSE_EMB),
          "rows_touched_max_share": (PS_SPARSE_EMB_WINDOW
                                     * PS_SPARSE_EMB_BATCH / vocab),
          **out, "share_of_dense": sparse / dense, "card": card})
    check(sparse <= 0.05 * dense and dense > vocab * dim * 4,
          f"ps_sparse embedding: {sparse} bytes a row-sparse commit "
          f"against {dense} dense (table {vocab * dim * 4} B)")
    return out


def phase_ps_sparse(card: str, dev: str = "cuda"):
    """Sharded parameter servers, top-k and row-sparse commits on the card
    (legs (a)-(c) of the PS_SPARSE_* comment): the ConvNet and embedding
    legs launch no attention or CE kernel; the LM leg's runs launch the
    sm90 training kernels once per layer and step each.  Returns (the
    throughput lines, the phase's launches)."""
    t_start = time.perf_counter()
    _zero_counts()
    rows = _host_ps_rows()
    dense = _ps_sparse_shards(card, dev, rows)
    topk = _ps_sparse_topk(card, dev, rows, dense)
    embedding = _ps_sparse_embedding(card, dev)
    quiet = _read_counts()
    check(not any(quiet.values()),
          f"ps_sparse convnet/embedding: kernel launches {quiet}, want none")
    launches = _add_counts(quiet, _ps_sparse_lm(card, dev))
    emit({"phase": "ps_sparse_launches", "launches": launches})
    emit({"phase": "ps_sparse_wall",
          "seconds": time.perf_counter() - t_start, "card": card})
    return {"dense_examples_per_sec": dense["examples_per_sec"],
            "topk_examples_per_sec": {k: v for k, v in topk.items()
                                      if k != "selection"},
            "embedding": embedding}, launches


def _dataset(x, y):
    """Rows as the trainers' Dataset."""
    from distkeras_tpu_torch import Dataset
    return Dataset({"features": x, "label": y})


def _short_of_watch():
    """A handler on the PS module's logger that keeps every "short of"
    warning of the wait for commits that can still land; returns (the
    list it fills, a function that detaches it)."""
    import logging
    log = logging.getLogger("distkeras_tpu_torch.parameter_servers")
    seen: list = []

    class Watch(logging.Handler):
        def emit(self, record):
            if "short of" in record.getMessage():
                seen.append(record.getMessage())

    handler = Watch(logging.WARNING)
    log.addHandler(handler)
    return seen, lambda: log.removeHandler(handler)


def _held_out(fitted, xt, lt) -> float:
    import numpy as np
    return float(np.mean(np.argmax(fitted.predict(xt), axis=1) == lt))


def _kill_when(t, shard: int, clock: int):
    """A thread that crash-kills ``shard`` of ``t``'s supervised group
    once its clock reaches ``clock``; returns (the thread, a stop event,
    the dict it records the kill in)."""
    import threading
    stop, killed = threading.Event(), {}

    def watch():
        while getattr(t, "_ps_supervisor", None) is None \
                and not stop.is_set():
            time.sleep(0.001)
        sup = t._ps_supervisor
        while not stop.is_set():
            n = sup.group.servers[shard].ps.num_updates
            if n >= clock:
                sup.kill_shard(shard)
                killed.update(clock=n, at=time.perf_counter())
                return
            time.sleep(0.001)

    th = threading.Thread(target=watch, name="chip-smoke-killer")
    th.start()
    return th, stop, killed


def _resilience_ps(card: str, dev: str, rows) -> dict:
    """Leg (a) of phase resilience: recovery's one-shard identity, then a
    shard crash-killed mid-run under two overlapped workers."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import ADAG, models
    x, y, xt, lt = rows
    convnet = lambda: models.mnist_convnet("bfloat16", device=dev)
    n = HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    one = dict(worker_optimizer="adam", comm_overlap=False,
               epochs=RESILIENCE_EPOCHS)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        serial = {rec: _host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, 1,
                                    recovery=rec, **one)
                  for rec in (False, True)}
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    same = (all(np.array_equal(a, b) for a, b in zip(
        serial[False]["fitted"].get_weights(),
        serial[True]["fitted"].get_weights()))
        and serial[False]["trainer"].get_history()
        == serial[True]["trainer"].get_history())
    emit({"phase": "resilience_identity", "equal": same,
          "windows": len(serial[True]["trainer"].get_history()),
          "recoveries": serial[True]["trainer"]._ps_supervisor.recoveries,
          "card": card})
    check(same, "resilience: recovery=True at one shard differs from "
          "recovery=False")
    check(not serial[True]["trainer"]._ps_supervisor.recoveries,
          "resilience: a respawn without a kill")
    out = {}
    for kill in (False, True):
        t = ADAG(convnet(), num_workers=HOST_PS_WORKERS,
                 num_epoch=RESILIENCE_EPOCHS, batch_size=ADAG_BATCH,
                 communication_window=ADAG_WINDOW, worker_optimizer="adam",
                 execution="host_ps", ps_shards=RESILIENCE_SHARDS,
                 recovery=True, seed=SEED, device=dev)
        if kill:
            th, stop, killed = _kill_when(t, RESILIENCE_KILL_SHARD,
                                          RESILIENCE_KILL_CLOCK)
        t0 = time.perf_counter()
        try:
            fitted = t.train(_dataset(x, y))
            _sync(dev)
        finally:
            if kill:
                stop.set()
                th.join()
        seconds = time.perf_counter() - t0
        sup = t._ps_supervisor
        row = {"killed": kill, "seconds": seconds,
               "examples_per_sec": len(x) * RESILIENCE_EPOCHS / seconds,
               "recoveries": list(sup.recoveries),
               "generations": [s.generation for s in t._ps_server.servers],
               "clocks": [s.ps.num_updates for s in t._ps_server.servers],
               "commits": sum(w._commits for w in t._ps_workers),
               "resumes": [w._shard_client.resumes for w in t._ps_workers],
               "accuracy_held_out": _held_out(fitted, xt, lt)}
        if kill:
            row["killed_at_clock"] = killed.get("clock")
        emit({"phase": "resilience_ps", **row, "card": card})
        out["kill" if kill else "no_kill"] = row
        check(row["accuracy_held_out"] >= RESILIENCE_ACC_MIN,
              f"resilience ps (kill {kill}): accuracy "
              f"{row['accuracy_held_out']}")
        if not kill:
            check(not row["recoveries"] and row["generations"]
                  == [0] * RESILIENCE_SHARDS,
                  f"resilience ps: respawns without a kill {row}")
            continue
        recs = row["recoveries"]
        check(len(recs) == 1 and recs[0]["shard"] == RESILIENCE_KILL_SHARD
              and row["generations"][RESILIENCE_KILL_SHARD] == 1,
              f"resilience ps: want one respawn of shard "
              f"{RESILIENCE_KILL_SHARD} at generation 1, got {recs}, "
              f"generations {row['generations']}")
        check(all(r >= 1 for r in row["resumes"]),
              f"resilience ps: a worker never resumed {row['resumes']}")
        check(recs[0]["dropped_updates"] <= RESILIENCE_DROPPED_MAX,
              f"resilience ps: {recs[0]['dropped_updates']} updates "
              f"dropped, want <= {RESILIENCE_DROPPED_MAX}")
    emit({"phase": "resilience_ps_cost",
          "respawn_ms": out["kill"]["recoveries"][0]["respawn_ms"],
          "examples_per_sec": {k: v["examples_per_sec"]
                               for k, v in out.items()}, "card": card})
    return out


def _resilience_run(dev: str, x, y, workers: int, **kw) -> dict:
    """One ADAG run of the ConvNet with ``workers`` workers (static or
    elastic, by ``kw``) for RESILIENCE_EPOCHS epochs: the trainer, the
    fitted model and examples/s on the host clock."""
    from distkeras_tpu_torch import ADAG, models
    t = ADAG(models.mnist_convnet("bfloat16", device=dev),
             num_workers=workers, num_epoch=RESILIENCE_EPOCHS,
             batch_size=ADAG_BATCH, communication_window=ADAG_WINDOW,
             worker_optimizer="adam", execution="host_ps", seed=SEED,
             device=dev, **kw)
    t0 = time.perf_counter()
    fitted = t.train(_dataset(x, y))
    _sync(dev)
    seconds = time.perf_counter() - t0
    return {"trainer": t, "fitted": fitted, "seconds": seconds,
            "examples_per_sec": len(x) * RESILIENCE_EPOCHS / seconds}


def _lease_contract(t, rows: int) -> bool:
    """Every epoch's leases completed exactly once, their rows summing to
    the dataset."""
    reps = t.elastic_stats["lease_completions"]
    return (len(reps) == t.num_epoch
            and all(r["completed"] == r["leases"]
                    and r["rows_completed"] == rows for r in reps.values()))


def _resilience_elastic(card: str, dev: str, rows) -> dict:
    """Leg (b) of phase resilience: static against elastic without a
    fault, then deaths, then a wedge."""
    x, y, xt, lt = rows
    n = RESILIENCE_ELASTIC_WORKERS
    static = _resilience_run(dev, x, y, n)
    out = {"static": static["examples_per_sec"]}
    for name, kw in (("clean", {}),
                     ("deaths", dict(fault_injection=
                                     RESILIENCE_ELASTIC_FAULTS)),
                     ("hang", dict(fault_injection=RESILIENCE_HANG_FAULTS,
                                   lease_timeout=RESILIENCE_LEASE_TIMEOUT))):
        r = _resilience_run(dev, x, y, n, elastic=True, **kw)
        t = r["trainer"]
        st = t.elastic_stats
        sup = t._worker_supervisor
        row = {"run": name, "seconds": r["seconds"],
               "examples_per_sec": r["examples_per_sec"],
               "respawns": st["respawns"],
               "respawn_records": st["respawn_records"],
               "leases_reassigned": st["leases_reassigned"],
               "windows_per_worker": st["windows_per_worker"],
               "lease_completions": {e: {k: v for k, v in rep.items()
                                         if k != "by_worker"}
                                     for e, rep in
                                     st["lease_completions"].items()},
               "failed_workers": t.failed_workers,
               "accuracy_held_out": _held_out(r["fitted"], xt, lt)}
        emit({"phase": "resilience_elastic", **row, "card": card})
        out[name] = row
        check(_lease_contract(t, len(x)),
              f"resilience elastic {name}: leases {row['lease_completions']}")
        check(row["accuracy_held_out"] >= RESILIENCE_ACC_MIN,
              f"resilience elastic {name}: accuracy "
              f"{row['accuracy_held_out']}")
        if name == "clean":
            check(row["respawns"] == 0 and not row["failed_workers"],
                  f"resilience elastic clean: {row}")
        elif name == "deaths":
            check(row["respawns"] == 2 and row["failed_workers"]
                  == sorted(RESILIENCE_ELASTIC_FAULTS),
                  f"resilience elastic deaths: respawns {row['respawns']}, "
                  f"failed {row['failed_workers']}")
        else:
            (hung,) = RESILIENCE_HANG_FAULTS
            th = sup._threads.get(hung)
            if th is not None:
                th.join(timeout=10.0)
            released = (sup.workers[hung]._hang_released.is_set()
                        and (th is None or not th.is_alive()))
            row["hung_thread_released"] = released
            # healthy workers declared wedged too: their deadline (the
            # 1.0 s floor binds) passed while another thread stalled the
            # card or the interpreter (printed, not failed)
            row["false_wedges"] = len(set(row["failed_workers"]) - {hung})
            emit({"phase": "resilience_elastic_wedges",
                  "false_wedges": row["false_wedges"], "card": card})
            check(row["leases_reassigned"] >= 1 and released
                  and hung in row["failed_workers"],
                  f"resilience elastic hang: reassigned "
                  f"{row['leases_reassigned']}, released {released}, "
                  f"respawns {row['respawns']}, failed "
                  f"{row['failed_workers']}")
    emit({"phase": "resilience_elastic_cost",
          "examples_per_sec": {"static": out["static"],
                               "elastic": out["clean"]["examples_per_sec"]},
          "elastic_over_static": (out["clean"]["examples_per_sec"]
                                  / out["static"]), "card": card})
    return out


def _resilience_ft(card: str, dev: str, rows) -> dict:
    """Leg (c) of phase resilience: fault_tolerance without leases."""
    x, y, xt, lt = rows
    r = _resilience_run(dev, x, y, RESILIENCE_ELASTIC_WORKERS,
                     fault_tolerance=True,
                     fault_injection=RESILIENCE_FT_FAULTS)
    t = r["trainer"]
    row = {"seconds": r["seconds"], "examples_per_sec": r["examples_per_sec"],
           "failed_workers": t.failed_workers,
           "commits": [w._commits for w in t._ps_workers],
           "accuracy_held_out": _held_out(r["fitted"], xt, lt)}
    emit({"phase": "resilience_fault_tolerance", **row, "card": card})
    check(row["failed_workers"] == sorted(RESILIENCE_FT_FAULTS)
          and row["accuracy_held_out"] >= RESILIENCE_ACC_MIN,
          f"resilience fault_tolerance: {row}")
    return row


def _resilience_lm(card: str, dev: str) -> dict:
    """Leg (d) of phase resilience: the LM, elastic over recovering
    shards, one worker death; the flash kernels' launches counted from 0.
    Returns the leg's launches."""
    from distkeras_tpu_torch import DOWNPOUR, transformer_lm
    x, y = _host_ps_lm_rows()
    t = DOWNPOUR(transformer_lm(**LM, device=dev), num_workers=2,
                 batch_size=BATCH, num_epoch=1,
                 communication_window=HOST_PS_LM_WINDOW,
                 loss="sparse_categorical_crossentropy_from_logits",
                 worker_optimizer="adam", learning_rate=3e-3, seed=SEED,
                 execution="host_ps", elastic=True, ps_shards=2,
                 recovery=True, fault_injection=RESILIENCE_LM_FAULTS,
                 device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    t.train(_dataset(x, y))
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    ws = t._ps_workers
    # compile_windows' windows (the one that seeds the ledger, and each
    # worker's warm-up in its own thread), every window with a history
    # entry, and the window whose commit the injected fault aborted
    windows = (1 + len(ws) + sum(len(w.history) for w in ws)
               + len(RESILIENCE_LM_FAULTS))
    want = LM["num_layers"] * HOST_PS_LM_WINDOW * windows
    sm90 = {k: launches[f"flash_{k}_sm90"] for k in ("fwd_lse", "dq", "dkv")}
    trained = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
               for v in ("", "_sm90")}
    others = {k: n for k, n in launches.items() if n and k not in trained}
    longest = max(ws, key=lambda w: len(w.history))
    row = {"phase": "resilience_lm", "seconds": seconds,
           "tokens_per_sec": HOST_PS_LM_ROWS * LM["seq_len"] / seconds,
           "respawns": t.elastic_stats["respawns"],
           "failed_workers": t.failed_workers,
           "windows_per_worker": t.elastic_stats["windows_per_worker"],
           "windows_ran": windows,
           "first_last_loss": [longest.history[0], longest.history[-1]],
           "launches_sm90": sm90, "launches_other": others,
           "want_each": want, "card": card}
    emit(row)
    check(row["respawns"] == 1 and _lease_contract(t, len(x)),
          f"resilience lm: respawns {row['respawns']}, leases "
          f"{t.elastic_stats['lease_completions']}")
    check(longest.history[-1] < longest.history[0],
          f"resilience lm: the loss did not fall {longest.history}")
    if dev == "cuda":
        check(all(n == want for n in sm90.values()) and not others,
              f"resilience lm: sm90 launches {sm90}, others {others}, "
              f"want {want} each (layers x steps x windows) and nothing "
              "else")
    return launches


def phase_resilience(card: str, dev: str = "cuda"):
    """Survivable parameter servers, elastic workers and fault tolerance on
    the card (legs (a)-(d) of the RESILIENCE_* comment): the ConvNet legs
    launch no attention or CE kernel; the LM leg launches the sm90
    training kernels once per layer, step and window that ran; no run
    logs the wait's "short of" warning.  Returns (the leg lines, the
    phase's launches)."""
    t_start = time.perf_counter()
    shorts, detach = _short_of_watch()
    try:
        _zero_counts()
        rows = _host_ps_rows()
        ps = _resilience_ps(card, dev, rows)
        elastic = _resilience_elastic(card, dev, rows)
        ft = _resilience_ft(card, dev, rows)
        quiet = _read_counts()
        check(not any(quiet.values()),
              f"resilience convnet: kernel launches {quiet}, want none")
        launches = _add_counts(quiet, _resilience_lm(card, dev))
    finally:
        detach()
    emit({"phase": "resilience_launches", "launches": launches})
    check(not shorts, f"resilience: the wait fell short: {shorts}")
    emit({"phase": "resilience_wall",
          "seconds": time.perf_counter() - t_start, "card": card})
    return {"ps": ps, "elastic": elastic, "fault_tolerance": ft}, launches


def _process_run(trainer_cls, model, x, y, dev: str, workers: int,
                 epochs: int = 1, **kw) -> dict:
    """One process-PS training run on the card: examples/s on the host
    clock (the whole train() call: the server, the children's start, the
    epochs), every child's window losses and the PS clock."""
    import numpy as np
    kw.setdefault("batch_size", ADAG_BATCH)
    kw.setdefault("communication_window", ADAG_WINDOW)
    t = trainer_cls(model, num_workers=workers, num_epoch=epochs,
                    execution="process_ps", device=dev, seed=SEED, **kw)
    t0 = time.perf_counter()
    fitted = t.train(_dataset(x, y))
    _sync(dev)
    seconds = time.perf_counter() - t0
    kids = t._process_results
    # the children's training alone: from the first child's first pull to
    # the last one's last window (their imports and CUDA start outside)
    span = (max(r.train_span[1] for r in kids)
            - min(r.train_span[0] for r in kids))
    return {"trainer": t, "fitted": fitted, "seconds": seconds,
            "examples_per_sec": len(x) * epochs / seconds,
            "train_seconds": span,
            "examples_per_sec_training": len(x) * epochs / span,
            "windows_per_worker": [len(r.history) for r in kids],
            "first_last_loss": [[r.history[0], r.history[-1]]
                                for r in kids],
            "loss_falls": all(r.history[-1] < r.history[0] for r in kids),
            "center_finite": all(np.isfinite(w).all()
                                 for w in fitted.get_weights())}


def _beside(fn, *args):
    """Start ``fn(*args)`` on a daemon thread beside the caller's work;
    returns a function that joins it and returns its result or raises
    its exception (a failed check included)."""
    import threading
    box = {}

    def run():
        try:
            box["result"] = fn(*args)
        except BaseException as e:  # re-raised by the join below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True, name=f"chip-smoke-"
                          f"{getattr(fn, '__name__', 'leg')}")
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["result"]
    return join


def _process_ft(card: str, dev: str, rows) -> dict:
    """Leg (a)'s degraded completion: two worker processes, one exits."""
    from distkeras_tpu_torch import ADAG, models
    x, y, _, _ = rows
    n = 2 * HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    r = _process_run(ADAG, models.mnist_convnet("bfloat16", device=dev),
                     x[:n], y[:n], dev, HOST_PS_WORKERS,
                     worker_optimizer="adam", fault_tolerance=True,
                     fault_injection=PROCESS_PS_FT_FAULTS)
    t = r["trainer"]
    emit({"phase": "process_ps_fault_tolerance",
          "failed_workers": t.failed_workers,
          "worker_failures": t.worker_failures,
          "windows_per_worker": r["windows_per_worker"], "card": card})
    check(t.failed_workers == sorted(PROCESS_PS_FT_FAULTS)
          and r["center_finite"],
          f"process_ps fault_tolerance: failed {t.failed_workers}")
    return t.failed_workers


def _process_identity(card: str, dev: str, rows) -> bool:
    """Leg (a)'s identity: one worker process against one host_ps thread,
    serial, cuDNN deterministic (the switches go to the child with its
    config)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import ADAG, models
    x, y, _, _ = rows
    convnet = lambda: models.mnist_convnet("bfloat16", device=dev)
    n = HOST_PS_ALGO_WINDOWS * ADAG_WINDOW * ADAG_BATCH
    one = dict(worker_optimizer="adam", comm_overlap=False)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        thread = _host_ps_run(ADAG, convnet(), x[:n], y[:n], dev, 1, **one)
        proc = _process_run(ADAG, convnet(), x[:n], y[:n], dev, 1, **one)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    same = (all(np.array_equal(a, b) for a, b in zip(
        thread["fitted"].get_weights(), proc["fitted"].get_weights()))
        and thread["trainer"].get_history() == proc["trainer"].get_history())
    emit({"phase": "process_ps_identity", "bit_identical": same,
          "windows": proc["windows_per_worker"],
          "seconds": {"thread": thread["seconds"],
                      "process": proc["seconds"]}, "card": card})
    check(same, "process_ps: one worker process differs from one host_ps "
          "thread")
    return same


def _mps_running() -> bool:
    """Is an MPS control daemon running on this host (read from /proc)?
    Without one, each worker process's CUDA context time-slices the card
    with the others."""
    import glob
    for path in glob.glob("/proc/[0-9]*/comm"):
        try:
            with open(path) as f:
                if f.read().startswith("nvidia-cuda-mps"):
                    return True
        except OSError:
            continue
    return False


def _process_scaling(card: str, dev: str, rows, threads: dict) -> dict:
    """Leg (a)'s scaling: the ConvNet epoch at PROCESS_PS_SCALING worker
    processes, beside phase host_ps's threads (run alone: it is timed)."""
    from distkeras_tpu_torch import ADAG, models
    x, y, xt, lt = rows
    scaling, training = {}, {}
    for workers in PROCESS_PS_SCALING:
        r = _process_run(ADAG, models.mnist_convnet("bfloat16", device=dev),
                         x, y, dev, workers, worker_optimizer="adam")
        acc = _held_out(r["fitted"], xt, lt)
        scaling[workers] = r["examples_per_sec"]
        training[workers] = r["examples_per_sec_training"]
        emit({"phase": "process_ps_scaling_run", "workers": workers,
              **_host_ps_row(r), "accuracy_held_out": acc, "card": card})
        check(r["loss_falls"] and r["center_finite"]
              and acc >= RESILIENCE_ACC_MIN,
              f"process_ps {workers} processes: losses "
              f"{r['first_last_loss']}, accuracy {acc}")
    emit({"phase": "process_ps_scaling",
          # a CUDA context a worker process; without MPS they take turns
          # on the card
          "contexts_per_run": {w: w for w in scaling},
          "mps_daemon": _mps_running(),
          "examples_per_sec_processes": scaling,
          "examples_per_sec_processes_training": training,
          "examples_per_sec_threads": threads,
          "processes_over_threads": {w: scaling[w] / threads[w]
                                     for w in scaling if w in threads},
          "training_over_threads": {w: training[w] / threads[w]
                                    for w in training if w in threads},
          "card": card})
    return {"examples_per_sec": scaling, "training": training}


class _StateChaos:
    """Faults fired at states of a running process-PS trainer: each rule
    (a predicate over the supervisor, a target, an action) fires once, in
    order, through a networking.ProcessChaos with at_s 0; ``fired_at``
    keeps each one's monotonic time for a later rule's predicate."""

    def __init__(self, trainer, targets):
        import threading
        self.trainer, self.targets, self.rules = trainer, targets, []
        self.injected, self.fired, self.fired_at = [], [], {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chip-smoke-chaos")

    def _run(self):
        from distkeras_tpu_torch.networking import ProcessChaos, ProcessFault
        pending = list(self.rules)
        while pending and not self.stop.is_set():
            sup = getattr(self.trainer, "_process_supervisor", None)
            if sup is not None and sup.ledger.epoch is not None \
                    and pending[0][0](sup):
                _, target, action = pending.pop(0)
                chaos = ProcessChaos(
                    {k: (lambda f=f, s=sup: f(s))
                     for k, f in self.targets.items()},
                    faults=[ProcessFault(target, 0.0, action)])
                chaos.start()
                while not chaos.injected and not self.stop.is_set():
                    time.sleep(0.001)
                chaos.stop(thaw=False)
                self.injected += chaos.injected
                self.fired.append([target, action, sup.ledger.epoch])
                self.fired_at[(target, action)] = time.monotonic()
                continue
            time.sleep(0.001)


def _process_supervised(card: str, dev: str, rows) -> dict:
    """Leg (b) of phase process_ps: the supervised engine, shard
    processes, state-triggered worker and shard deaths and a freeze."""
    import tempfile
    from distkeras_tpu_torch import DOWNPOUR, models
    from distkeras_tpu_torch.ps_shard_main import read_addr, read_restored
    x, y, xt, lt = rows
    completed = lambda sup, e: sup.ledger.epoch_report(e)["completed"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procps_") as tmp:
        t = DOWNPOUR(models.mnist_convnet("bfloat16", device=dev),
                     num_workers=2, num_epoch=RESILIENCE_EPOCHS,
                     batch_size=ADAG_BATCH, communication_window=ADAG_WINDOW,
                     worker_optimizer="adam", seed=SEED, device=dev,
                     execution="process_ps", elastic=True, recovery=True,
                     ps_shards=2, ps_placement="process",
                     wire_dtype="bfloat16",
                     freeze_deadline=PROCESS_PS_FREEZE_S, scratch_dir=tmp)
        chaos = _StateChaos(t, {"worker1": lambda sup: sup.procs.get(1),
                                "shard0": lambda sup: sup.ps_procs[0]})
        chaos.rules = [
            (lambda sup: completed(sup, 0) >= 1, "worker1", "kill"),
            (lambda sup: sup.ledger.epoch >= 1, "shard0", "kill"),
            (lambda sup: sup.ps_restarts[0] >= 1
             and completed(sup, 1) >= 1, "shard0", "stop"),
            (lambda sup: sup._last_ps_probe
             > chaos.fired_at[("shard0", "stop")], "shard0", "cont")]
        chaos.thread.start()
        t0 = time.perf_counter()
        try:
            fitted = t.train(_dataset(x, y))
            _sync(dev)
        finally:
            chaos.stop.set()
            chaos.thread.join()
        seconds = time.perf_counter() - t0
        sup = t._process_supervisor
        addr_dir = os.path.join(tmp, "addrs")
        host, port, gen = read_addr(os.path.join(addr_dir, "shard_0.addr"))
        restored = read_restored(addr_dir, 0, gen)
    st = t.elastic_stats
    row = {"phase": "process_ps_supervised", "seconds": seconds,
           "examples_per_sec": len(x) * RESILIENCE_EPOCHS / seconds,
           "faults": chaos.fired, "respawns": st["respawns"],
           "respawn_records": st["respawn_records"],
           "ps_restarts": st["ps_restarts"],
           "ps_recoveries": st["ps_recoveries"],
           "leases_reassigned": st["leases_reassigned"],
           "events": [e["kind"] for e in st["events"]],
           "lease_completions": {e: {k: v for k, v in rep.items()
                                     if k != "by_worker"}
                                 for e, rep in
                                 st["lease_completions"].items()},
           "failed_workers": t.failed_workers,
           "shard0": {"address": [host, port],
                      "first_address": list(sup.ps_addrs[0]),
                      "generation": gen, "restored_clock": restored},
           "accuracy_held_out": _held_out(fitted, xt, lt), "card": card}
    emit(row)
    check([f[:2] for f in chaos.fired] == [
        ["worker1", "kill"], ["shard0", "kill"], ["shard0", "stop"],
        ["shard0", "cont"]], f"process_ps supervised: faults {chaos.fired}")
    check(_lease_contract(t, len(x)),
          f"process_ps supervised: leases {row['lease_completions']}")
    check(row["respawns"] >= 1 and 1 in t.failed_workers,
          f"process_ps supervised: respawns {row['respawns']}, failed "
          f"{t.failed_workers}")
    check(row["ps_restarts"][0] >= 1 and [host, port]
          == list(sup.ps_addrs[0]) and gen >= 1 and restored is not None,
          f"process_ps supervised: shard 0 {row['shard0']}, restarts "
          f"{row['ps_restarts']}")
    check(row["accuracy_held_out"] >= RESILIENCE_ACC_MIN,
          f"process_ps supervised: accuracy {row['accuracy_held_out']}")
    return row


def _process_lm(card: str, dev: str) -> dict:
    """Leg (c) of phase process_ps: the LM from two elastic worker
    processes; the children's launches read from their result files.
    Returns the children's launches summed."""
    from distkeras_tpu_torch import DOWNPOUR, transformer_lm
    x, y = _host_ps_lm_rows()
    t = DOWNPOUR(transformer_lm(**LM, device=dev), num_workers=2,
                 batch_size=BATCH, num_epoch=1,
                 communication_window=HOST_PS_LM_WINDOW,
                 loss="sparse_categorical_crossentropy_from_logits",
                 worker_optimizer="adam", learning_rate=3e-3, seed=SEED,
                 execution="process_ps", elastic=True, device=dev)
    t0 = time.perf_counter()
    t.train(_dataset(x, y))
    _sync(dev)
    seconds = time.perf_counter() - t0
    kids = t._process_results
    trained = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
               for v in ("", "_sm90")}
    per_child, ok = [], True
    for r in kids:
        # every window with a history entry and the child's warm-up
        want = LM["num_layers"] * HOST_PS_LM_WINDOW * (len(r.history) + 1)
        sm90 = {k: r.launches[f"flash_{k}_sm90"]
                for k in ("fwd_lse", "dq", "dkv")}
        others = {k: v for k, v in r.launches.items()
                  if v and k not in trained}
        per_child.append({"worker": r.worker_id, "windows": len(r.history),
                          "launches_sm90": sm90, "launches_other": others,
                          "want_each": want})
        ok = ok and all(v == want for v in sm90.values()) and not others
    longest = max(kids, key=lambda r: len(r.history))
    row = {"phase": "process_ps_lm", "seconds": seconds,
           "tokens_per_sec": HOST_PS_LM_ROWS * LM["seq_len"] / seconds,
           "children": per_child,
           "first_last_loss": [longest.history[0], longest.history[-1]],
           # host-extension compiles in each child: 0, they load the
           # driver's build of the native codec
           "children_native_compiles": [r.native_compiles for r in kids],
           "card": card}
    emit(row)
    check(t.process_native_compiles == 0
          and not any(row["children_native_compiles"]),
          f"process_ps lm: the children ran the host compiler "
          f"{row['children_native_compiles']}")
    check(_lease_contract(t, len(x)),
          f"process_ps lm: leases {t.elastic_stats['lease_completions']}")
    check(longest.history[-1] < longest.history[0],
          f"process_ps lm: the loss did not fall {longest.history}")
    if dev == "cuda":
        check(ok, f"process_ps lm: children's launches {per_child}")
    return t.process_launches


_BUILD_CHILD = """
import json, os, sys, time
import torch
from distkeras_tpu_torch import kernels
import distkeras_tpu_torch.ops.fused_ce as ce
go, ready = sys.argv[1], sys.argv[2]
open(ready, "w").close()
while not os.path.exists(go):
    time.sleep(0.001)
built = kernels.build(["fused_ce"])
torch.manual_seed(int(sys.argv[3]))
logits = torch.randn(256, 4096, device="cuda")
labels = torch.randint(0, 4096, (256,), device="cuda")
loss, lse = ce.fused_ce_fwd(logits, labels)
ref, ref_lse = ce.fused_ce_forward_reference(logits, labels)
share = max(((a - b).abs() / (1e-5 * b.abs() + 1e-5)).max().item()
            for a, b in ((loss, ref), (lse, ref_lse)))
err = max((loss - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
print(json.dumps({"built": built, "launches": ce.fused_ce_fwd.launches,
                  "max_abs_err": err, "err_share": share}))
"""


def _process_build_lock(card: str) -> dict:
    """Leg (d) of phase process_ps: two processes build fused_ce at once
    into an empty build directory; a logging nvcc wrapper counts the
    compiles."""
    import json
    import subprocess
    import tempfile
    from distkeras_tpu_torch import kernels
    real = kernels._nvcc()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_build_") as tmp:
        bindir, log = os.path.join(tmp, "bin"), os.path.join(tmp, "nvcc.log")
        os.makedirs(bindir)
        wrapper = os.path.join(bindir, "nvcc")
        with open(wrapper, "w") as f:
            f.write(f"#!/bin/sh\necho $$ >> {log}\nexec {real} \"$@\"\n")
        os.chmod(wrapper, 0o755)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PATH=f"{bindir}{os.pathsep}"
                   f"{os.environ.get('PATH', '')}",
                   DISTKERAS_TPU_TORCH_BUILD_DIR=os.path.join(tmp, "build"),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (root, os.environ.get("PYTHONPATH")) if p))
        go = os.path.join(tmp, "go")
        ready = [os.path.join(tmp, f"ready{i}") for i in range(2)]
        t0 = time.perf_counter()
        kids = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, go,
                                  r, str(i)], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for i, r in enumerate(ready)]
        try:
            while not all(os.path.exists(r) for r in ready):
                if any(k.poll() is not None for k in kids):
                    check(False, f"process_ps build: a child died "
                          f"{[k.communicate() for k in kids]}")
                time.sleep(0.005)
            open(go, "w").close()
            outs = [k.communicate(timeout=600) for k in kids]
        finally:
            for k in kids:
                if k.poll() is None:
                    k.kill()
                    k.wait()
        seconds = time.perf_counter() - t0
        with open(log) as f:
            compiles = len(f.read().split())
        files = sorted(os.listdir(os.path.join(tmp, "build")))
    results = []
    for k, (out, err) in zip(kids, outs):
        check(k.returncode == 0, f"process_ps build: a child failed {err}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    row = {"phase": "process_ps_build_lock", "nvcc_runs": compiles,
           "children": results, "build_dir": files, "seconds": seconds,
           "card": card}
    emit(row)
    check(compiles == 1 and sorted(len(r["built"]) for r in results)
          == [0, 1] and files == [".lock", "libfused_ce.so"],
          f"process_ps build: {compiles} nvcc runs, {results}, {files}")
    check(all(r["launches"] == 1 and r["err_share"] <= 1.0
              for r in results),
          f"process_ps build: launches or errors {results}")
    return row


def phase_process_ps(card: str, threads: dict = None, dev: str = "cuda"):
    """The cross-process parameter server on the card (legs (a)-(d) of
    the PROCESS_PS_* comment): the ConvNet legs launch no attention or CE
    kernel in any process; the LM leg's children launch the sm90 training
    kernels once per layer, step and window they ran, their warm-up
    included; two processes building one kernel run one nvcc.
    ``threads`` is phase host_ps's examples/s by thread count, printed
    beside the processes' (None: the processes' alone).  Returns (the
    leg lines, the children's launches on the LM leg)."""
    t_start = time.perf_counter()
    shorts, detach = _short_of_watch()
    try:
        _zero_counts()
        rows = _host_ps_rows()
        # the timed leg alone, then every other leg side by side (their
        # checks read per-process counts and states, not times)
        scaling = _process_scaling(card, dev, rows, threads or {})
        lm = _beside(_process_lm, card, dev)
        build = (_beside(_process_build_lock, card) if dev == "cuda"
                 else lambda: None)
        identity = _beside(_process_identity, card, dev, rows)
        ft = _beside(_process_ft, card, dev, rows)
        supervised = _process_supervised(card, dev, rows)
        identity, ft = identity(), ft()
        launches, build = lm(), build()
        # the driver launched only the LM leg's window that seeds the
        # ledger, once per layer and step
        driver = _read_counts()
        want = LM["num_layers"] * HOST_PS_LM_WINDOW
        sm90 = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
                for v in ("", "_sm90")}
        emit({"phase": "process_ps_driver_launches", "launches": driver,
              "want_sm90_each": want})
        if dev == "cuda":
            check(all(driver[k] == want for k in sm90)
                  and not any(v for k, v in driver.items() if k not in sm90),
                  f"process_ps: the driver's launches {driver}, want "
                  f"{want} of each sm90 training kernel and nothing else")
    finally:
        detach()
    emit({"phase": "process_ps_launches", "launches": launches})
    check(not shorts, f"process_ps: the wait fell short: {shorts}")
    emit({"phase": "process_ps_wall",
          "seconds": time.perf_counter() - t_start, "card": card})
    return {"scaling": scaling, "identity": identity, "fault_tolerance": ft,
            "supervised": supervised, "build": build}, launches


def _online_rows(mapping, drifted, chunks: int, rng):
    """ONLINE_CHUNK-row chunks of the LM's token rows labelled through
    ``mapping``, then, from half-way, through ``drifted``."""
    for i in range(chunks):
        m = drifted if i >= chunks // 2 else mapping
        x = rng.integers(0, LM["vocab_size"],
                         (ONLINE_CHUNK, LM["seq_len"])).astype("int32")
        yield x, m[x].astype("int64")


def _online_maps(rng):
    """A permutation of the LM's vocabulary and its drift: half the
    vocabulary remapped."""
    mapping = rng.permutation(LM["vocab_size"]).astype("int64")
    drifted = mapping.copy()
    flip = rng.permutation(LM["vocab_size"])[: LM["vocab_size"] // 2]
    drifted[flip] = mapping[(flip + 1) % LM["vocab_size"]]
    return mapping, drifted


def _online_trainer(model, dev: str, **kw):
    """A stream trainer of phase online's configuration."""
    from distkeras_tpu_torch import DOWNPOUR
    return DOWNPOUR(model, num_workers=2, batch_size=BATCH, num_epoch=1,
                    communication_window=HOST_PS_LM_WINDOW,
                    loss="sparse_categorical_crossentropy_from_logits",
                    worker_optimizer="adam", learning_rate=3e-3, seed=SEED,
                    execution="host_ps", stream=True,
                    horizon_windows=ONLINE_HORIZON_WINDOWS, device=dev, **kw)


def _online_windows(t, faults: int) -> int:
    """The windows a stream run ran on the card: the ledger's seeding
    window, each worker's warm-up in its thread, every history window and
    each window whose commit an injected fault aborted."""
    ws = t._ps_workers
    return 1 + len(ws) + sum(len(w.history) for w in ws) + faults


def _online_decode(eng, trace, every: int):
    """The trace through ``eng`` inline, a pull every ``every`` decode
    steps (0: none): the rows, each decode-only iteration's ms, and the
    center generation after every iteration."""
    eng._reload_every = every
    handles = [eng.submit(p, n, **kw) for p, n, kw in trace]
    iter_ms, gens = [], []
    keys = ("decode_steps", "prefills", "prefill_chunks")
    while True:
        before = [eng.stats[k] for k in keys]
        t1 = time.perf_counter()
        if not eng.step():
            break
        dt = time.perf_counter() - t1
        delta = [eng.stats[k] - b for k, b in zip(keys, before)]
        if delta == [1, 0, 0]:
            iter_ms.append(dt * 1e3)
        gens.append(eng.stats["center_generation"])
    return [h.result() for h in handles], iter_ms, gens


def _online_tensors(eng) -> list:
    """The data pointers of what the decode graph reads: the weights, the
    KV pool, the device-resident slot state."""
    def tensors(tree):
        if hasattr(tree, "data_ptr"):
            return [tree]
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            return [t for x in tree for t in tensors(x)]
        return []
    held = (*eng.model.parameters(), *eng.model.buffers(),
            *tensors(eng.caches), eng._dev_tok, eng._dev_pos, eng._dev_act,
            eng._dev_temp, eng._dev_topk, eng._dev_topp, eng._dev_keys)
    return [t.data_ptr() for t in held]


def _online_greedy(eng, prompts, steps: int = 16):
    handles = [eng.submit(p, steps) for p in prompts]
    eng.run_until_idle()
    return [h.result() for h in handles]


def _online_fresh_equal(server, eng, quantize: str, prompts, dev: str):
    """``eng``'s greedy tokens against a fresh engine's built from the
    server's center with the same quantization: equal to the bit?"""
    import numpy as np
    from distkeras_tpu_torch import serving
    fresh = serving.ServingEngine(
        server.get_model(device=dev), num_slots=SERVE_SLOTS,
        max_len=LM["seq_len"], prefill_chunk=SERVE_CHUNK, quantize=quantize)
    eng._reload_every = 0
    got, want = _online_greedy(eng, prompts), _online_greedy(fresh, prompts)
    return all(np.array_equal(a, b) for a, b in zip(got, want))


def _online_stream_serve(card: str, dev: str, weights, trace, rng) -> dict:
    """Legs (a) and (b) of phase online: the stream trains while the
    attached bf16 engine serves the trace, then, training paused at the
    last horizon's hook, the reload A/B and the fresh-engine identities.
    """
    import threading
    import numpy as np
    from distkeras_tpu_torch import (FittedModel, StreamSource,
                                     load_jax_weights, serving,
                                     transformer_lm)

    def lm():
        return load_jax_weights(transformer_lm(**LM, device=dev), weights)

    mapping, drifted = _online_maps(rng)
    chunks = ONLINE_HORIZONS * ONLINE_HORIZON_WINDOWS * HOST_PS_LM_WINDOW \
        * BATCH // ONLINE_CHUNK
    t = _online_trainer(lm(), dev, max_horizons=ONLINE_HORIZONS,
                        fault_injection={1: ("exit", ONLINE_EXIT_AT)})
    eng = _serve_engine(lm(), False, quantize="bf16")
    addresses = _online_tensors(eng)
    pull_ms = []
    pull = eng._pull_weights

    def timed_pull():
        t0 = time.perf_counter()
        pull()
        pull_ms.append((time.perf_counter() - t0) * 1e3)

    eng._pull_weights = timed_pull
    ready, served = threading.Event(), threading.Event()
    out: dict = {}

    def on_ps_ready(server, addr):
        eng.attach_ps(*addr, every=1)
        out["server"] = server
        ready.set()

    def on_horizon(h, fitted):
        if h != ONLINE_HORIZONS - 1:
            return
        served.wait(600.0)  # the PS stays live, no commit lands meanwhile
        server = out["server"]
        prompts = [p[:16] for p, _, _ in trace[:ONLINE_PROMPTS]]
        pull()  # both runs of the A/B serve this center
        with_ = _online_decode(eng, trace, 1)
        without = _online_decode(eng, trace, 0)
        out["decode_ms_p50_reloads"] = statistics.median(with_[1])
        out["decode_ms_p50_no_reloads"] = statistics.median(without[1])
        out["ab_rows_equal"] = all(np.array_equal(a, b) for a, b in
                                   zip(with_[0], without[0]))
        pull()
        out["bf16_equals_fresh"] = _online_fresh_equal(
            server, eng, "bf16", prompts, dev)
        q8 = serving.ServingEngine(FittedModel(lm()), num_slots=SERVE_SLOTS,
                                   max_len=LM["seq_len"],
                                   prefill_chunk=SERVE_CHUNK,
                                   quantize="int8")
        q8.attach_ps(*t._ps_advertise_addr, every=1)
        q8._pull_weights()
        out["int8_reloads"] = q8.stats["reloads"]
        out["int8_equals_fresh"] = _online_fresh_equal(
            server, q8, "int8", prompts, dev)

    t._on_ps_ready, t.on_horizon = on_ps_ready, on_horizon
    errors = []
    consumed = {"rows": 0}

    def counted():
        for x, y in _online_rows(mapping, drifted, chunks, rng):
            consumed["rows"] += len(x)
            yield x, y

    def train():
        try:
            t0 = time.perf_counter()
            t.train(StreamSource(generator=counted()))
            _sync(dev)
            out["train_s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised by the check below
            errors.append(repr(e))
            ready.set()

    th = threading.Thread(target=train, name="online-train")
    th.start()
    ready.wait(600.0)
    try:
        rows, iter_ms, gens = _online_decode(eng, trace, 1)
    finally:
        served.set()
        th.join()
    check(not errors, f"online (a): the stream run failed: {errors}")
    reps = t.elastic_stats["lease_completions"]
    ledger_ok = (len(reps) == t.stream_stats["horizons"] == ONLINE_HORIZONS
                 and all(r["completed"] == r["leases"] and
                         r["rows_completed"] == t.stream_stats["horizon_rows"]
                         for r in reps.values()))
    live = [g for g in gens if g is not None]
    row = {"phase": "online_stream",
           "horizons": t.stream_stats["horizons"],
           "rows": t.stream_stats["rows"], "rows_read": consumed["rows"],
           "examples_per_sec": t.stream_stats["examples_per_sec"],
           "train_s": out.get("train_s"),
           "failed_workers": t.failed_workers,
           "respawns": t.elastic_stats["respawns"],
           "windows_per_worker": t.elastic_stats["windows_per_worker"],
           "windows_ran": _online_windows(t, 1),
           "ledger_complete": ledger_ok,
           "first_last_loss": [t._ps_workers[0].history[0],
                               t._ps_workers[0].history[-1]],
           "card": card}
    emit(row)
    check(ledger_ok and t.failed_workers == [1]
          and t.stream_stats["rows"] == consumed["rows"],
          f"online (a): horizons {t.stream_stats}, leases {reps}, failed "
          f"{t.failed_workers}, rows read {consumed['rows']}")
    same_addr = _online_tensors(eng) == addresses
    row = {"phase": "online_reload",
           "requests": len(rows), "reloads": eng.stats["reloads"],
           "reload_failures": eng.stats["reload_failures"],
           "center_generations": [live[0], live[-1]] if live else None,
           "generation_monotone": live == sorted(live),
           "addresses_kept": same_addr,
           "pull_ms_p50": statistics.median(pull_ms) if pull_ms else None,
           "pull_ms_max": max(pull_ms) if pull_ms else None,
           "decode_ms_p50_under_training": (statistics.median(iter_ms)
                                            if iter_ms else None),
           **{k: out.get(k) for k in (
               "decode_ms_p50_reloads", "decode_ms_p50_no_reloads",
               "ab_rows_equal", "bf16_equals_fresh", "int8_reloads",
               "int8_equals_fresh")},
           "card": card}
    emit(row)
    check(eng.stats["reloads"] > 0 and eng.stats["reload_failures"] == 0
          and live and live == sorted(live) and live[-1] > live[0],
          f"online (b): reloads {eng.stats['reloads']}, failures "
          f"{eng.stats['reload_failures']}, generations {live[:3]}..")
    check(same_addr, "online (b): a pull moved a tensor the decode graph "
          "reads")
    check(all(len(r) == len(p) + n for r, (p, n, _) in zip(rows, trace)),
          "online (b): a request of the trace did not complete")
    check(out.get("ab_rows_equal"), "online (b): pulls of an unchanged "
          "center changed the trace's tokens")
    check(out.get("bf16_equals_fresh") and out.get("int8_equals_fresh")
          and out.get("int8_reloads") == 1,
          f"online (b): pulled engines against fresh ones from the center: "
          f"bf16 {out.get('bf16_equals_fresh')}, int8 "
          f"{out.get('int8_equals_fresh')}")
    return {"stream": t, "windows": _online_windows(t, 1),
            "pull_ms": pull_ms, **row}


def _online_deploy(card: str, dev: str, weights, trace, rng) -> dict:
    """Leg (c) of phase online: OnlineDeployment over a stream trainer
    and a started bf16 engine, supervised, with a blue/green swap and an
    engine kill from the horizon hook."""
    import numpy as np
    from distkeras_tpu_torch import (OnlineDeployment, StreamSource,
                                     load_jax_weights, transformer_lm)

    def lm():
        return load_jax_weights(transformer_lm(**LM, device=dev), weights)

    mapping, drifted = _online_maps(rng)
    chunks = ONLINE_DEPLOY_HORIZONS * ONLINE_HORIZON_WINDOWS \
        * HOST_PS_LM_WINDOW * BATCH // ONLINE_CHUNK
    t = _online_trainer(lm(), dev, max_horizons=ONLINE_DEPLOY_HORIZONS)
    eng = _serve_engine(lm(), False, quantize="bf16").start()
    dep = OnlineDeployment(t, StreamSource(generator=_online_rows(
        mapping, drifted, chunks, rng)), eng, reload_every=1,
        supervise=True, supervisor_kw={"heartbeat_interval": 0.05,
                                       "liveness_deadline": 60.0})
    prompts = [p[:16] for p, _, _ in trace[:ONLINE_PROMPTS]]
    tags, results, swaps = [], [], []

    def on_horizon(h, fitted):
        if h == 0:
            swaps.append(dep.blue_green_swap())
        if h == 1:
            dep.kill_engine()
        rows, gens = dep.serve(prompts, num_steps=16, retry_wait_s=120.0)
        tags.append(gens)
        results.extend(rows)

    t.on_horizon = on_horizon
    t0 = time.perf_counter()
    dep.start()
    dep.join(timeout=900.0)
    s = dep.stats()
    dep.stop()
    wall = time.perf_counter() - t0
    rec = [r for r in s.get("engine_recoveries", []) if r.get("restarted")]
    fresh_mirrored = (s["freshness_p50_s"] is not None
                      and t.stream_stats.get("freshness_p50_s")
                      == s["freshness_p50_s"]
                      and dep.engine.stats.get("freshness_p50_s")
                      == s["freshness_p50_s"])
    row = {"phase": "online_deploy", "wall_s": wall,
           "horizons": t.stream_stats["horizons"],
           "examples_per_sec": t.stream_stats["examples_per_sec"],
           "generation": s["generation"],
           "generation_tags": tags,
           "swaps": [{k: r.get(k) for k in ("generation", "blue_green",
                                            "pulled", "old_drained_clean",
                                            "old_dead", "drain_ms")}
                     for r in s["swaps"]],
           "recovery_ms": rec[0]["recovery_ms"] if rec else None,
           "freshness_p50_s": s["freshness_p50_s"],
           "freshness_p99_s": s["freshness_p99_s"],
           "freshness_rows": s["freshness_rows"],
           "freshness_mirrored": fresh_mirrored,
           "engine_reloads": s["engine_reloads"],
           "engine_reload_failures": s["engine_reload_failures"],
           "engine_requests_failed": s["engine_requests_failed"],
           "card": card}
    emit(row)
    check(len(tags) == ONLINE_DEPLOY_HORIZONS
          and all(len(set(g)) == 1 and None not in g for g in tags)
          and len(results) == ONLINE_PROMPTS * ONLINE_DEPLOY_HORIZONS
          and all(r is not None for r in results),
          f"online (c): requests by generation {tags}")
    check(s["generation"] == 2 and [r["generation"] for r in s["swaps"]]
          == [1, 2] and swaps and swaps[0]["blue_green"]
          and swaps[0]["pulled"] and swaps[0]["old_drained_clean"] and rec,
          f"online (c): swaps {s['swaps']}, recoveries "
          f"{s.get('engine_recoveries')}")
    check(fresh_mirrored and s["freshness_p99_s"] >= s["freshness_p50_s"]
          and s["engine_reload_failures"] == 0,
          f"online (c): freshness {s['freshness_p50_s']} / "
          f"{s['freshness_p99_s']}, mirrored {fresh_mirrored}, reload "
          f"failures {s['engine_reload_failures']}")
    return {"stream": t, "windows": _online_windows(t, 0), **row}


def _online_drift(card: str, dev: str) -> dict:
    """Accuracy tracks drift on bench.py:442 online_deployment_bench's own
    configuration: the served model learns the drifted mapping."""
    import numpy as np
    from distkeras_tpu_torch import (DOWNPOUR, FittedModel,
                                     OnlineDeployment, StreamSource,
                                     load_jax_weights, serving,
                                     transformer_lm)
    vocab, seq = 16, 8
    rng = np.random.default_rng(0)
    mapping = rng.permutation(vocab).astype(np.int32)
    drifted = mapping.copy()
    flip = rng.permutation(vocab)[: vocab // 2]
    drifted[flip] = np.roll(mapping[flip], 1)

    def gen():
        for i in range(6):
            m = drifted if i >= 3 else mapping
            x = rng.integers(0, vocab, (128, seq)).astype(np.int32)
            yield x, m[x]

    def make_model(seed):
        m = transformer_lm(vocab_size=vocab, seq_len=seq + 2, d_model=32,
                           num_heads=4, num_layers=1, mlp_dim=64,
                           compute_dtype="float32", device=dev)
        return load_jax_weights(m, _random_jax_weights(
            m, np.random.default_rng(seed)))

    trainer = DOWNPOUR(make_model(0), num_workers=2, batch_size=16,
                       num_epoch=1, communication_window=2,
                       execution="host_ps",
                       loss="sparse_categorical_crossentropy_from_logits",
                       worker_optimizer="adam", learning_rate=3e-3,
                       stream=True, horizon_windows=4, seed=0,
                       max_horizons=12, device=dev)
    engine = serving.ServingEngine(FittedModel(make_model(1)), num_slots=4,
                                   max_len=4)
    dep = OnlineDeployment(trainer, StreamSource(generator=gen()), engine,
                           reload_every=1)
    probe = np.arange(vocab, dtype=np.int32).reshape(-1, 1)
    acc = {"curve": []}

    def on_horizon(h, fitted):
        rows, _ = dep.serve(list(probe), num_steps=1)
        pred = np.array([r[1] for r in rows])
        acc["curve"].append(float(np.mean(pred == drifted[probe[:, 0]])))
        if h < 8:
            fx = np.repeat(probe, seq, axis=1)
            dep.feed(fx, (drifted if h >= 3 else mapping)[fx])

    trainer.on_horizon = on_horizon
    _zero_counts()
    t0 = time.perf_counter()
    dep.start()
    dep.join(timeout=600.0)
    dep.stop()
    s = dep.stats()
    row = {"phase": "online_drift", "wall_s": time.perf_counter() - t0,
           "horizons": s["stream_stats"]["horizons"],
           "served_accuracy_curve": acc["curve"],
           "online_served_accuracy": acc["curve"][-1],
           "freshness_p50_s": s["freshness_p50_s"],
           "freshness_p99_s": s["freshness_p99_s"],
           "launches": _read_counts(), "card": card}
    emit(row)
    check(acc["curve"][-1] >= ONLINE_ACC_MIN
          and s["freshness_p50_s"] is not None
          and s["freshness_p50_s"] <= s["freshness_p99_s"],
          f"online drift: served accuracy {acc['curve']}, freshness "
          f"{s['freshness_p50_s']} / {s['freshness_p99_s']}")
    return row


def phase_online(card: str, dev: str = "cuda"):
    """Streaming online training, hot weight reload and the online
    deployment on the card (legs (a)-(c) of the ONLINE_* comment), then
    accuracy-tracks-drift on the reference's small configuration.  The
    counts are set to 0 before (a) and read after (c): the sm90 training
    kernels once per layer, step and window the two stream runs ran,
    nothing else.  Returns (the legs' lines, those launches)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import transformer_lm
    t_start = time.perf_counter()
    shorts, detach = _short_of_watch()
    try:
        rng = np.random.default_rng(SEED + 15)
        trace = _serve_trace(rng)  # phase serve's trace, its first draws
        weights = _random_jax_weights(transformer_lm(**LM, device="cpu"),
                                      np.random.default_rng(SEED + 21))
        _zero_counts()
        ab = _online_stream_serve(card, dev, weights, trace,
                                  np.random.default_rng(SEED + 22))
        c = _online_deploy(card, dev, weights, trace,
                           np.random.default_rng(SEED + 23))
        launches = _read_counts()
        want = LM["num_layers"] * HOST_PS_LM_WINDOW * (ab["windows"]
                                                       + c["windows"])
        sm90 = {k: launches[f"flash_{k}_sm90"]
                for k in ("fwd_lse", "dq", "dkv")}
        trained = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
                   for v in ("", "_sm90")}
        others = {k: n for k, n in launches.items()
                  if k not in trained and (any(n.values())
                                           if isinstance(n, dict) else n)}
        emit({"phase": "online_launches", "launches": launches,
              "launches_sm90": sm90, "launches_other": others,
              "want_each": want})
        if dev == "cuda":
            check(all(n == want for n in sm90.values()) and not others,
                  f"online: sm90 launches {sm90}, others {others}, want "
                  f"{want} each (layers x steps x windows) and nothing "
                  "else")
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        drift = _online_drift(card, dev)
    finally:
        detach()
    check(not shorts, f"online: the wait fell short: {shorts}")
    summary = {"phase": "online",
               "examples_per_sec": ab["stream"].stream_stats[
                   "examples_per_sec"],
               "pull_ms_p50": ab["pull_ms_p50"],
               "decode_ms_p50_reloads": ab["decode_ms_p50_reloads"],
               "decode_ms_p50_no_reloads": ab["decode_ms_p50_no_reloads"],
               "freshness_p50_s": c["freshness_p50_s"],
               "freshness_p99_s": c["freshness_p99_s"],
               "recovery_ms": c["recovery_ms"],
               "online_served_accuracy": drift["online_served_accuracy"],
               "launches_online": sm90,
               "seconds": time.perf_counter() - t_start, "card": card}
    emit(summary)
    return summary, launches


_MOE_RANK = """
import json, os, sys, time
t_enter = time.time()
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from distkeras_tpu_torch.job_deployment import initialize_from_env
initialize_from_env()
import torch.distributed as dist
from distkeras_tpu_torch.core.optimizers import adam
from distkeras_tpu_torch.kernels import launch_counts
from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                          gather_params, load_jax_params)
rank = dist.get_rank()
cfg_path, out, go = sys.argv[1:4]
sync = (torch.cuda.synchronize if torch.cuda.is_available()
        else lambda: None)
spec = json.load(open(cfg_path))
joined = time.time()
blob = np.load(os.path.join(out, "weights.npz"))
# the weights by leaf name (load_jax_params takes them flat), the batch
tree = {n: blob[n] for n in blob.files if not n.startswith("__")}
deadline = time.time() + spec["timeout_s"]
while not os.path.exists(go):  # the card is this leg's once (a) is done
    if time.time() > deadline:
        raise TimeoutError("no go from the parent process")
    time.sleep(0.01)
mesh = Mesh(np.array([spec["device"]] * spec["ranks"],
                     dtype=object).reshape(1, 1, spec["ranks"]))
lm = ParallelTransformerLM(**spec["cfg"], mesh=mesh)
params = load_jax_params(lm, tree)
toks = lm.shard_batch(blob["__tokens"])
labels = lm.shard_batch(blob["__labels"])
opt_state, step = lm.compile_train_step(
    adam(spec["lr"], eps=spec["eps"]), params)
sync()
mesh.comm_stats.clear()
losses, seconds = [], []
for _ in range(spec["steps"]):
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, toks, labels)
    sync()
    seconds.append(time.perf_counter() - t0)
    losses.append(loss.item())
launches = launch_counts()
comm = {k: dict(v) for k, v in mesh.comm_stats.items()}
with torch.no_grad():
    _, stats = lm._forward(params, toks)
dropped = [s["dropped"].item() for s in stats]
full = gather_params(lm, params)
if rank == 0:
    flat = {"layers.%d.%s" % (i, k): a for i, lp in enumerate(full["layers"])
            for k, a in lp.items()}
    flat.update({k: a for k, a in full.items() if k != "layers"})
    np.savez(os.path.join(out, "gathered.npz"), **flat)
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump({"rank": rank, "joined_s": joined - float(sys.argv[4]),
               "entered_s": t_enter - float(sys.argv[4]),
               "losses": losses, "step_s": seconds, "launches": launches,
               "collectives": comm, "dropped": dropped,
               "backend": str(dist.get_backend()),
               "device": str(lm.device)}, f)
dist.destroy_process_group()
"""


def _moe_flat(tree) -> dict:
    """A JAX-layout tree as name -> array (``layers.{i}.{leaf}``)."""
    flat = {f"layers.{i}.{k}": a for i, lp in enumerate(tree["layers"])
            for k, a in lp.items()}
    flat.update({k: a for k, a in tree.items() if k != "layers"})
    return flat


def _moe_router_stats(lm, params, tokens) -> dict:
    """One forward after training: each MoE layer's first-choice fractions
    summed and its share of dropped choices."""
    import torch
    with torch.no_grad():
        _, stats = lm._forward(params, tokens)
    return {"fraction_sums": [s["fraction"].sum().item() for s in stats],
            "dropped": [s["dropped"].item() for s in stats]}


def _moe_layer_forms(card: str, dev: str) -> list:
    """One MoE layer at f32 at the main path's shape, k each of MOE_TOP_K:
    the index form against the one-hot form on ``dev`` and against
    itself on the CPU."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, moe
    rng = np.random.default_rng(SEED + 25)
    d, f, e = PLM["d_model"], PLM["mlp_dim"], MOE["num_experts"]
    w = lambda *shape: (rng.standard_normal(shape, dtype=np.float32)
                        / np.float32(np.sqrt(shape[-2])))
    host = [rng.standard_normal((PLM_BATCH, PLM["seq_len"], d),
                                dtype=np.float32), w(d, e), w(e, d, f),
            0.1 * rng.standard_normal((e, f), dtype=np.float32), w(e, f, d),
            0.1 * rng.standard_normal((e, d), dtype=np.float32)]
    rows = []
    for k in MOE_TOP_K:
        kw = dict(capacity_factor=MOE["capacity_factor"], router_top_k=k,
                  compute_dtype=torch.float32)
        on_dev = [torch.as_tensor(a, device=dev) for a in host]
        on_cpu = [torch.as_tensor(a) for a in host]
        with torch.no_grad():
            _sync(dev)
            t0 = time.perf_counter()
            y, stats = moe.moe_mlp(*on_dev, mesh=Mesh(device=dev), **kw)
            _sync(dev)
            index_ms = (time.perf_counter() - t0) * 1e3
            if torch.device(dev).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            base = (torch.cuda.memory_allocated()
                    if torch.device(dev).type == "cuda" else 0)
            y_hot, _ = moe.moe_mlp(*on_dev, mesh=Mesh(device=dev),
                                   dispatch="onehot", **kw)
            hot_peak = (torch.cuda.max_memory_allocated() - base
                        if torch.device(dev).type == "cuda" else None)
            y_cpu, _ = moe.moe_mlp(*on_cpu, mesh=Mesh(device="cpu"), **kw)
            # the routing on each device, from the same f32 logits op
            t = PLM_BATCH * PLM["seq_len"]
            cap = max(int(np.ceil(MOE["capacity_factor"] * k * t / e)), 1)
            slots = [moe.topk_slots(a[0].reshape(t, d) @ a[1], cap, k)[0]
                     .cpu() // cap for a in (on_dev, on_cpu)]
        agree = (slots[0] == slots[1]).all(dim=1)
        y_dev = y.cpu().reshape(t, d)
        form_err = ((y - y_hot).abs().max() / y_hot.abs().max()).item()
        cpu_err = ((y_dev - y_cpu.reshape(t, d))[agree].abs().max()
                   / y_cpu.abs().max()).item()
        row = {"phase": "moe_layer", "router_top_k": k, "tokens": t,
               "capacity": cap, "dropped": stats["dropped"].item(),
               "index_vs_onehot": form_err, "index_vs_onehot_rtol":
               MOE_FORM_RTOL, "card_vs_cpu": cpu_err,
               "card_vs_cpu_rtol": MOE_CPU_RTOL,
               "expert_flips_card_vs_cpu": int((~agree).sum()),
               "index_ms": index_ms, "onehot_peak_bytes": hot_peak,
               "card": card}
        emit(row)
        check(form_err <= MOE_FORM_RTOL, f"moe k={k}: the index form "
              f"differs from the one-hot form by {form_err}")
        check(cpu_err <= MOE_CPU_RTOL and (~agree).sum() <= t // 1000,
              f"moe k={k}: card vs CPU {cpu_err}, "
              f"{int((~agree).sum())} expert flips")
        rows.append(row)
        del on_dev, y, y_hot
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def _moe_start_ranks(tmp: str, dev: str):
    """(b)'s inputs written under ``tmp`` and its ranks started as a
    coordinated Job over gloo; returns (the job, the one-rank config, the
    tree, tokens, labels, the go file, the launch time)."""
    import json
    import socket
    import numpy as np
    from distkeras_tpu_torch.job_deployment import Job, LocalJobRunner
    from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
    cfg = {**PLM, **PLM_ROUTES["fused_ulysses"], **MOE,
           "num_layers": MOE_RANK_LAYERS, "moe_layers": (1,),
           "capacity_factor": MOE_RANK_CAPACITY, "compute_dtype": "float32"}
    rng = np.random.default_rng(SEED + 26)
    tree = _parallel_tree(ParallelTransformerLM(
        **cfg, mesh=Mesh(device="meta")), rng)
    toks = rng.integers(0, PLM["vocab_size"], (MOE_RANK_BATCH,
                                               PLM["seq_len"])).astype(
        np.int32)
    labels = (toks + 1) % PLM["vocab_size"]
    np.savez(os.path.join(tmp, "weights.npz"), __tokens=toks,
             __labels=labels, **_moe_flat(tree))
    spec_path, script = (os.path.join(tmp, n)
                         for n in ("spec.json", "moe_rank.py"))
    with open(spec_path, "w") as f:
        json.dump({"cfg": cfg, "ranks": MOE_RANKS, "lr": PLM_LR,
                   # every rank on the one card
                   "device": "cuda:0" if dev == "cuda" else dev,
                   "eps": MOE_RANK_EPS, "steps": MOE_RANK_STEPS,
                   "timeout_s": MOE_RANK_TIMEOUT_S}, f)
    with open(script, "w") as f:
        f.write(_MOE_RANK)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    go = os.path.join(tmp, "go")
    t_launch = time.time()
    job = Job("moe_ranks", script, args=[spec_path, tmp, go, repr(t_launch)],
              hosts=["127.0.0.1"] * MOE_RANKS, coordinator_port=port,
              backend="gloo", env={"PYTHONPATH": os.pathsep.join(
                  p for p in (root, os.environ.get("PYTHONPATH")) if p)})
    job.run(LocalJobRunner(), wait=False)
    return job, cfg, tree, toks, labels, go, t_launch


def _moe_ranks(card: str, dev: str, tmp: str, started) -> dict:
    """(b): the one-rank reference in this process, then the go to the
    ranks, their results and the comparison."""
    import json
    import numpy as np
    import torch
    from distkeras_tpu_torch.core.optimizers import adam
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              gather_params,
                                              load_jax_params)
    job, cfg, tree, toks, labels, go, t_launch = started
    lm = ParallelTransformerLM(**cfg, mesh=Mesh(device=dev))
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(
        adam(PLM_LR, eps=MOE_RANK_EPS), params)
    tokens, targets = lm.shard_batch(toks), lm.shard_batch(labels)
    ref_losses, ref_s = [], []
    for _ in range(MOE_RANK_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        _sync(dev)
        ref_s.append(time.perf_counter() - t0)
        ref_losses.append(loss.item())
    ref = _moe_flat(gather_params(lm, params))
    del lm, params, opt_state
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    open(go, "w").close()
    codes = []
    try:
        for p in job.processes:
            left = max(t_launch + MOE_RANK_TIMEOUT_S - time.time(), 1.0)
            codes.append(p.wait(timeout=left))
    finally:
        for p in job.processes:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * MOE_RANKS, f"moe ranks exited {codes}")
    ranks = []
    for r in range(MOE_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = dict(np.load(os.path.join(tmp, "gathered.npz")))
    init = _moe_flat(tree)
    shares = {n: float(np.abs(got[n] - ref[n]).max())
              / (MOE_RANK_PARAM_RTOL * float(np.abs(ref[n] - init[n]).max())
                 + 1e-12) for n in ref}
    worst = max(shares, key=shares.get)
    loss_gap = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], ref_losses))
    comm = [{op: {k: s[k] for k in ("calls", "bytes", "seconds")}
             for op, s in r["collectives"].items()} for r in ranks]
    row = {"phase": "moe_ranks", "ranks": MOE_RANKS,
           "mesh": [1, 1, MOE_RANKS], "backend": ranks[0]["backend"],
           "devices": [r["device"] for r in ranks], "config": cfg,
           "batch": MOE_RANK_BATCH, "steps": MOE_RANK_STEPS,
           "losses": [r["losses"] for r in ranks],
           "one_rank_losses": ref_losses, "loss_gap": loss_gap,
           "loss_rtol": LOSS_RTOL_F32, "param_worst_tensor": worst,
           "param_worst_share_of_tol": shares[worst],
           "child_start_s": [r["joined_s"] for r in ranks],
           "ms_per_step": [statistics.median(r["step_s"]) * 1e3
                           for r in ranks],
           "one_rank_ms_per_step": statistics.median(ref_s) * 1e3,
           # gloo through pinned host memory, not NCCL
           "collectives_per_rank": comm,
           "collective_bytes_per_rank": [sum(s["bytes"] for s in c.values())
                                         for c in comm],
           "collective_s_per_rank": [sum(s["seconds"] for s in c.values())
                                     for c in comm],
           "dropped": [r["dropped"] for r in ranks],
           "launches_per_rank": [r["launches"] for r in ranks],
           "card": card}
    emit(row)
    check(all(r["backend"] == "gloo" for r in ranks),
          f"moe ranks: backend {[r['backend'] for r in ranks]}")
    check(all(d == 0.0 for r in ranks for d in r["dropped"]),
          f"moe ranks: dropped {row['dropped']} at capacity factor "
          f"{MOE_RANK_CAPACITY}")
    check(all(np.isfinite(r["losses"]).all() for r in ranks)
          and loss_gap <= LOSS_RTOL_F32,
          f"moe ranks: losses {row['losses']} vs one rank {ref_losses}")
    check(shares[worst] <= 1.0, f"moe ranks: gathered {worst} differs "
          f"{shares[worst]:.3g}x its tolerance from the one-rank run")
    if torch.device(dev).type == "cuda":
        want = MOE_RANK_LAYERS * MOE_RANK_STEPS
        for r in ranks:
            n = r["launches"]
            check(n["fused_ce_fwd"] == n["fused_ce_bwd"] == MOE_RANK_STEPS
                  and all(n[f"flash_{k}_simt"] == want
                          for k in ("fwd_lse", "dq", "dkv")),
                  f"moe ranks: rank {r['rank']} launches {n}, want fused "
                  f"CE {MOE_RANK_STEPS} and SIMT flash {want} each")
    return row


def phase_moe(card: str, dev: str = "cuda"):
    """ParallelTransformerLM with Switch MoE (the MOE_* comment): (b)'s
    ranks start first and join while (a) runs on the card; the counts are
    set to 0 before (a)'s runs and read after them.  Returns (the lines,
    the launches of (a) with (b)'s ranks' added)."""
    import tempfile
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        started = _moe_start_ranks(tmp, dev)
        try:
            rng = np.random.default_rng(SEED + 24)
            v, s = PLM["vocab_size"], PLM["seq_len"]
            toks = rng.integers(0, v, (PLM_BATCH, s)).astype(np.int32)
            labels = (toks + 1) % v
            base = {**PLM, **PLM_ROUTES["fused_ulysses"], **MOE,
                    "compute_dtype": "bfloat16"}
            tree = _parallel_tree(ParallelTransformerLM(
                **base, mesh=Mesh(device="meta")), rng)
            runs, launches = {}, {}
            for k in MOE_TOP_K:
                if torch.device(dev).type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                losses, seconds, counts, stats = _parallel_route(
                    {**base, "router_top_k": k}, tree, toks, labels,
                    after=_moe_router_stats, dev=dev)
                peak = (torch.cuda.max_memory_allocated()
                        if torch.device(dev).type == "cuda" else None)
                launches = _add_counts(launches, counts)
                step_ms = statistics.median(seconds[1:]) * 1e3
                row = {"phase": "moe_train", "router_top_k": k,
                       "config": {**PLM, **MOE}, "compute_dtype": "bfloat16",
                       "batch": PLM_BATCH, "steps": PLM_STEPS,
                       "losses": losses,
                       "last_over_first": losses[-1] / losses[0],
                       **stats, "launches": counts,
                       "first_step_ms": seconds[0] * 1e3,
                       "ms_per_step": step_ms,
                       "tokens_per_s": PLM_BATCH * s / (step_ms / 1e3),
                       "peak_bytes": peak, "card": card}
                emit(row)
                runs[k] = row
                tag = f"moe top-{k}"
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      f"{tag}: losses {losses}")
                check(all(abs(x - 1.0) <= 1e-5
                          for x in stats["fraction_sums"]),
                      f"{tag}: fractions sum to {stats['fraction_sums']}")
                if torch.device(dev).type == "cuda":
                    flash = PLM["num_layers"] * PLM_STEPS
                    check(counts["fused_ce_fwd"] == counts["fused_ce_bwd"]
                          == PLM_STEPS
                          and all(counts[f"flash_{k_}{v_}"] == flash
                                  for k_ in ("fwd_lse", "dq", "dkv")
                                  for v_ in ("", "_sm90"))
                          and counts["flash_inference"] == 0
                          and all(counts[f"flash_{k_}_simt"] == 0
                                  for k_ in ("fwd_lse", "dq", "dkv")),
                          f"{tag}: launches {counts}, want fused CE "
                          f"{PLM_STEPS} and sm90 flash {flash} each")
            del tree
            forms = _moe_layer_forms(card, dev)
            ranks = _moe_ranks(card, dev, tmp, started)
        finally:
            for p in started[0].processes:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r in ranks["launches_per_rank"]:
        launches = _add_counts(launches, r)
    summary = {"phase": "moe", "ms_per_step": {
        k: r["ms_per_step"] for k, r in runs.items()},
        "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
        "peak_bytes": {k: r["peak_bytes"] for k, r in runs.items()},
        "dropped": {k: r["dropped"] for k, r in runs.items()},
        "ranks_ms_per_step": ranks["ms_per_step"],
        "launches_moe": launches,
        "seconds": time.perf_counter() - t_start, "card": card}
    emit(summary)
    return {"train": runs, "layer": forms, "ranks": ranks}, launches


_PP_RANK = """
import json, os, sys, time
t_enter = time.time()
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from distkeras_tpu_torch.job_deployment import initialize_from_env
initialize_from_env()
import torch.distributed as dist
from distkeras_tpu_torch.core.optimizers import adam
from distkeras_tpu_torch.kernels import launch_counts
from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                          PipelineTransformerLM,
                                          gather_params, load_jax_params)
rank = dist.get_rank()
spec_path, out, go, t0 = sys.argv[1:5]
spec = json.load(open(spec_path))
joined = time.time()
sync = (torch.cuda.synchronize if torch.cuda.is_available()
        else lambda: None)
deadline = time.time() + spec["timeout_s"]
while not os.path.exists(go):  # the card is (b)'s once (a) is done
    if time.time() > deadline:
        raise TimeoutError("no go from the parent process")
    time.sleep(0.01)
dev, n = spec["device"], spec["ranks"]


def flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({k + "." + j: a for j, a in v.items()})
        elif isinstance(v, list):
            out.update({"%s.%d.%s" % (k, i, j): a
                        for i, lp in enumerate(v) for j, a in lp.items()})
        else:
            out[k] = v
    return out


def run(lm, blob, steps, eps, **kw):
    tree = {k: blob[k] for k in blob.files if not k.startswith("__")}
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(adam(spec["lr"], eps=eps),
                                            params, **kw)
    toks = lm.shard_batch(blob["__tokens"])
    labels = lm.shard_batch(blob["__labels"])
    sync()
    lm.mesh.comm_stats.clear()
    before = launch_counts()
    losses, seconds = [], []
    for _ in range(steps):
        t = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, toks, labels)
        sync()
        seconds.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    comm = {k: dict(v) for k, v in lm.mesh.comm_stats.items()}
    return params, opt_state, {"losses": losses, "step_s": seconds,
                               "launches": launches, "collectives": comm}


def moments(state):
    if (isinstance(state, tuple) and len(state) == 3
            and isinstance(state[0], int) and isinstance(state[1], list)):
        return state[1] + state[2]
    for sub in state if isinstance(state, (tuple, list)) else ():
        found = moments(sub)
        if found is not None:
            return found
    return None


nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
runs = {}
blob = np.load(os.path.join(out, "pp_weights.npz"))
mesh = Mesh(np.array([dev] * n, dtype=object).reshape(1, n),
            ("data", "stage"))
for sched in spec["schedules"]:
    lm = PipelineTransformerLM(**spec["pp_cfg"], mesh=mesh, schedule=sched)
    params, _, row = run(lm, blob, spec["pp_steps"], 1e-8)
    full = flat(gather_params(lm, params))
    if rank == 0:
        np.savez(os.path.join(out, "pp_%s.npz" % sched), **full)
    runs["pp_" + sched] = row
blob = np.load(os.path.join(out, "zero_weights.npz"))
mesh = Mesh(np.array([dev] * n, dtype=object).reshape(n, 1, 1))
lm = ParallelTransformerLM(**spec["zero_cfg"], mesh=mesh)
for mode in ("plain", "zero", "fsdp"):
    params, opt_state, row = run(lm, blob, spec["zero_steps"], spec["eps"],
                                 zero=mode == "zero", fsdp=mode == "fsdp")
    row["moment_bytes"] = nbytes(moments(opt_state))
    row["param_bytes"] = nbytes(params.values())
    full = flat(gather_params(lm, params))
    if rank == 0:
        np.savez(os.path.join(out, "zero_%s.npz" % mode), **full)
    runs["zero_" + mode] = row
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump({"rank": rank, "joined_s": joined - float(t0),
               "entered_s": t_enter - float(t0), "runs": runs,
               "backend": str(dist.get_backend()),
               "device": str(lm.device)}, f)
dist.destroy_process_group()
"""


def _pp_tree(lm, rng) -> dict:
    """Weights for ``lm`` (a PipelineTransformerLM) by the JAX tree's flat
    leaf names, drawn by :func:`_draw_leaf`."""
    return {name: _draw_leaf(name, shape, rng)
            for name, shape in lm._shapes().items()}


def _pp_start_ranks(tmp: str, dev: str):
    """(b) and (c)'s inputs written under ``tmp`` and their ranks started
    as a coordinated Job over gloo; returns (the job, the configurations,
    the weights, the batches, the go file, the launch time)."""
    import json
    import socket
    import numpy as np
    from distkeras_tpu_torch.job_deployment import Job, LocalJobRunner
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              PipelineTransformerLM)
    rng = np.random.default_rng(SEED + 28)
    pp_cfg = {**PP_LM, "num_layers": PP_RANK_LAYERS,
              "num_microbatches": PP_RANK_MICRO,
              "compute_dtype": "bfloat16"}
    one = PipelineTransformerLM(**pp_cfg, mesh=Mesh(
        device="meta", axis_names=("data", "stage")))
    pp_tree = _pp_tree(one, rng)  # (1, layers, ...): one stage
    v, s = PP_LM["vocab_size"], PP_LM["seq_len"]
    pp_toks = rng.integers(0, v, (PP_RANK_BATCH, s)).astype(np.int32)
    # the same weights as PP_RANKS stages of one layer each
    staged = {k: (a.reshape((PP_RANKS, PP_RANK_LAYERS // PP_RANKS)
                            + a.shape[2:]) if k.startswith("layers.")
                  else a) for k, a in pp_tree.items()}
    np.savez(os.path.join(tmp, "pp_weights.npz"), __tokens=pp_toks,
             __labels=(pp_toks + 1) % v, **staged)
    zero_cfg = {**PLM, **PLM_ROUTES["fused_ulysses"],
                "num_layers": ZERO_RANK_LAYERS, "compute_dtype": "float32"}
    zero_lm = ParallelTransformerLM(**zero_cfg, mesh=Mesh(device="meta"))
    zero_tree = _moe_flat(_parallel_tree(zero_lm, rng))
    zero_toks = rng.integers(0, v, (ZERO_RANK_BATCH, s)).astype(np.int32)
    np.savez(os.path.join(tmp, "zero_weights.npz"), __tokens=zero_toks,
             __labels=(zero_toks + 1) % v, **zero_tree)
    spec_path, script = (os.path.join(tmp, n)
                         for n in ("spec.json", "pp_rank.py"))
    with open(spec_path, "w") as f:
        json.dump({"pp_cfg": pp_cfg, "zero_cfg": zero_cfg,
                   "schedules": list(PP_SCHEDULES), "ranks": PP_RANKS,
                   "lr": PLM_LR, "eps": MOE_RANK_EPS,
                   "pp_steps": PP_RANK_STEPS, "zero_steps": ZERO_RANK_STEPS,
                   # every rank on the one card
                   "device": "cuda:0" if dev == "cuda" else dev,
                   "timeout_s": PP_RANK_TIMEOUT_S}, f)
    with open(script, "w") as f:
        f.write(_PP_RANK)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    go = os.path.join(tmp, "go")
    t_launch = time.time()
    job = Job("pp_ranks", script, args=[spec_path, tmp, go, repr(t_launch)],
              hosts=["127.0.0.1"] * PP_RANKS, coordinator_port=port,
              backend="gloo", env={"PYTHONPATH": os.pathsep.join(
                  p for p in (root, os.environ.get("PYTHONPATH")) if p)})
    job.run(LocalJobRunner(), wait=False)
    return (job, pp_cfg, pp_tree, pp_toks, zero_cfg, zero_tree, go,
            t_launch)


def _pp_one_rank(card: str, dev: str, sched: str, m: int, tree, toks,
                 cfg=None, steps=PLM_STEPS, gather=False) -> dict:
    """One PipelineTransformerLM on mesh (1, 1), ``steps`` steps of
    adam(PLM_LR) from ``tree``, the counts set to 0 just before the steps
    and read just after; with ``gather`` the trained weights by flat leaf
    name too."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.core.optimizers import adam
    from distkeras_tpu_torch.parallel import (Mesh, PipelineTransformerLM,
                                              gather_params, load_jax_params)
    cfg = cfg or {**PP_LM, "compute_dtype": "bfloat16"}
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lm = PipelineTransformerLM(**{**cfg, "num_microbatches": m},
                               schedule=sched, mesh=Mesh(
                                   device=dev, axis_names=("data", "stage")))
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(adam(PLM_LR), params)
    tokens = lm.shard_batch(toks)
    labels = lm.shard_batch((toks + 1) % cfg["vocab_size"])
    _sync(dev)
    _zero_counts()
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    out = {"losses": [float(x) for x in losses], "seconds": seconds,
           "launches": launches, "peak_bytes": peak}
    if gather:
        full = gather_params(lm, params)
        out["gathered"] = {k: v for k, v in full.items() if k != "layers"}
        out["gathered"].update({f"layers.{k}": v
                                for k, v in full["layers"].items()})
    del lm, params, opt_state
    if cuda:
        torch.cuda.empty_cache()
    return out


def _zero_bytes(shapes: dict, specs: dict, dp: int) -> dict:
    """Each rank's bytes by the slicing rule, from the f32 shapes and the
    specs: a leaf is cut in dp along a dim that its spec leaves unnamed
    and that dp divides, if it has one (on mesh (dp, 1, 1) no named axis
    splits anything); Adam keeps two moments a leaf."""
    whole = sliced = 0
    for name, shape in shapes.items():
        spec = tuple(specs[name]) + (None,) * (len(shape) - len(specs[name]))
        n = 1
        for d in shape:
            n *= d
        whole += 4 * n
        cut = any(e is None and d % dp == 0 for e, d in zip(spec, shape))
        sliced += 4 * (n // dp if cut else n)
    return {"plain": {"moment_bytes": 2 * whole, "param_bytes": whole},
            "zero": {"moment_bytes": 2 * sliced, "param_bytes": whole},
            "fsdp": {"moment_bytes": 2 * sliced, "param_bytes": sliced}}


def _pp_ranks(card: str, dev: str, tmp: str, started) -> dict:
    """(b) and (c): the one-rank references of (b) in this process, then
    the go to the ranks, their results and the comparisons."""
    import json
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
    job, pp_cfg, pp_tree, pp_toks, zero_cfg, zero_tree, go, t_launch = \
        started
    refs = {sched: _pp_one_rank(card, dev, sched, PP_RANK_MICRO, pp_tree,
                                pp_toks, cfg=pp_cfg, steps=PP_RANK_STEPS,
                                gather=True)
            for sched in PP_SCHEDULES}
    open(go, "w").close()
    codes = []
    try:
        for p in job.processes:
            left = max(t_launch + PP_RANK_TIMEOUT_S - time.time(), 1.0)
            codes.append(p.wait(timeout=left))
    finally:
        for p in job.processes:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(codes == [0] * PP_RANKS, f"pipeline ranks exited {codes}")
    ranks = []
    for r in range(PP_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    comm = lambda run: [{op: {k: s[k] for k in ("calls", "bytes", "seconds")}
                         for op, s in r["runs"][run]["collectives"].items()}
                        for r in ranks]
    launches, rows = {}, {}
    for r in ranks:
        for row in r["runs"].values():
            launches = _add_counts(launches, row["launches"])
    # (b): two stages against one rank
    for sched in PP_SCHEDULES:
        got = dict(np.load(os.path.join(tmp, f"pp_{sched}.npz")))
        ref = refs[sched]["gathered"]
        shares, equal = {}, True
        for n, w in ref.items():
            g = got[n].reshape(w.shape)  # (stages, 1, ...) → (1, stages, ...)
            equal &= bool(np.array_equal(g, w))
            shares[n] = float(np.abs(g - w).max()) / (
                MOE_RANK_PARAM_RTOL * float(np.abs(w - pp_tree[n]).max())
                + 1e-12)
        worst = max(shares, key=shares.get)
        run = f"pp_{sched}"
        losses = [r["runs"][run]["losses"] for r in ranks]
        gap = max(abs(a - b) / abs(b) for ls in losses
                  for a, b in zip(ls, refs[sched]["losses"]))
        row = {"phase": "pipeline_ranks", "schedule": sched,
               "ranks": PP_RANKS, "mesh": [1, PP_RANKS],
               "backend": ranks[0]["backend"],
               "devices": [r["device"] for r in ranks],
               "config": pp_cfg, "batch": PP_RANK_BATCH,
               "microbatches": PP_RANK_MICRO, "steps": PP_RANK_STEPS,
               "losses": losses, "one_rank_losses": refs[sched]["losses"],
               "loss_gap": gap, "loss_rtol": PP_RANK_LOSS_RTOL,
               "bit_equal_to_one_rank": bool(
                   equal and all(ls == refs[sched]["losses"]
                                 for ls in losses)),
               "param_worst_tensor": worst,
               "param_worst_share_of_tol": shares[worst],
               "child_start_s": [r["joined_s"] for r in ranks],
               # the first step carries each process's first-call set-up
               "first_step_ms": [r["runs"][run]["step_s"][0] * 1e3
                                 for r in ranks],
               "ms_per_step": [statistics.median(
                   r["runs"][run]["step_s"][1:]) * 1e3 for r in ranks],
               "one_rank_ms_per_step":
                   statistics.median(refs[sched]["seconds"][1:]) * 1e3,
               "collectives_per_rank": comm(run),
               "launches_per_rank": [r["runs"][run]["launches"]
                                     for r in ranks],
               "card": card}
        emit(row)
        rows[sched] = row
        check(all(r["backend"] == "gloo" for r in ranks),
              f"pipeline ranks: backend {[r['backend'] for r in ranks]}")
        check(all(np.isfinite(ls).all() for ls in losses)
              and gap <= PP_RANK_LOSS_RTOL,
              f"pipeline ranks {sched}: losses {losses} vs one rank "
              f"{refs[sched]['losses']}")
        check(shares[worst] <= 1.0, f"pipeline ranks {sched}: gathered "
              f"{worst} differs {shares[worst]:.3g}x its tolerance")
        if torch.device(dev).type == "cuda":
            want = PP_RANK_MICRO * PP_RANK_STEPS  # one layer a rank
            for r, n in zip(ranks, row["launches_per_rank"]):
                check(all(n[f"flash_{k}_sm90"] == want
                          for k in ("fwd_lse", "dq", "dkv"))
                      and n["flash_inference_sm90"] == (
                          want if sched == "1f1b" else 0)
                      and not any(n[f"flash_{k}_simt"] for k in
                                  ("fwd_lse", "dq", "dkv", "inference")),
                      f"pipeline ranks {sched}: rank {r['rank']} launches "
                      f"{n}, want {want} sm90 each")
    # (c): ZeRO-1 and FSDP against the plain step on the same ranks
    zero_lm = ParallelTransformerLM(**zero_cfg, mesh=Mesh(device="meta"))
    want_bytes = _zero_bytes(zero_lm._shapes(), zero_lm.param_specs(),
                             PP_RANKS)
    plain = dict(np.load(os.path.join(tmp, "zero_plain.npz")))
    init = zero_tree
    zrows = {}
    for mode in ("plain", "zero", "fsdp"):
        run = f"zero_{mode}"
        got = dict(np.load(os.path.join(tmp, f"{run}.npz")))
        losses = [r["runs"][run]["losses"] for r in ranks]
        base = ranks[0]["runs"]["zero_plain"]["losses"]
        loss_gap = max(abs(a - b) / abs(b) for ls in losses
                       for a, b in zip(ls, base))
        param_gap = max(float(np.abs(got[n] - w).max())
                        / (float(np.abs(w).max()) + 1e-30)
                        for n, w in plain.items())
        moved = max(float(np.abs(plain[n] - init[n]).max()) for n in init)
        row = {"phase": "zero_fsdp_ranks", "mode": mode,
               "mesh": [PP_RANKS, 1, 1], "config": zero_cfg,
               "batch": ZERO_RANK_BATCH, "steps": ZERO_RANK_STEPS,
               "losses": losses, "loss_gap_to_plain": loss_gap,
               "param_gap_to_plain": param_gap, "rtol": ZERO_RTOL,
               "bit_equal_to_plain": bool(
                   all(np.array_equal(got[n], w) for n, w in plain.items())
                   and all(ls == base for ls in losses)),
               "largest_update": moved,
               "moment_bytes_per_rank": [r["runs"][run]["moment_bytes"]
                                         for r in ranks],
               "param_bytes_per_rank": [r["runs"][run]["param_bytes"]
                                        for r in ranks],
               "predicted_bytes_per_rank": want_bytes[mode],
               "first_step_ms": [r["runs"][run]["step_s"][0] * 1e3
                                 for r in ranks],
               "ms_per_step": [statistics.median(
                   r["runs"][run]["step_s"][1:]) * 1e3 for r in ranks],
               "collectives_per_rank": comm(run),
               "launches_per_rank": [r["runs"][run]["launches"]
                                     for r in ranks],
               "card": card}
        emit(row)
        zrows[mode] = row
        check(all(np.isfinite(ls).all() for ls in losses)
              and loss_gap <= ZERO_RTOL and param_gap <= ZERO_RTOL,
              f"zero/fsdp ranks {mode}: losses {losses} (plain {base}), "
              f"parameters {param_gap:.3g} of their largest off plain")
        check(row["moment_bytes_per_rank"] == [want_bytes[mode][
                  "moment_bytes"]] * PP_RANKS
              and row["param_bytes_per_rank"] == [want_bytes[mode][
                  "param_bytes"]] * PP_RANKS,
              f"zero/fsdp ranks {mode}: bytes a rank "
              f"{row['moment_bytes_per_rank']} / "
              f"{row['param_bytes_per_rank']}, want {want_bytes[mode]}")
        if torch.device(dev).type == "cuda":
            want = ZERO_RANK_LAYERS * ZERO_RANK_STEPS
            for r, n in zip(ranks, row["launches_per_rank"]):
                check(n["fused_ce_fwd"] == n["fused_ce_bwd"]
                      == ZERO_RANK_STEPS
                      and all(n[f"flash_{k}_simt"] == want
                              for k in ("fwd_lse", "dq", "dkv")),
                      f"zero/fsdp ranks {mode}: rank {r['rank']} launches "
                      f"{n}, want fused CE {ZERO_RANK_STEPS} and SIMT "
                      f"flash {want} each")
    return {"pipeline": rows, "zero": zrows, "launches": launches,
            "references": {k: {kk: vv for kk, vv in v.items()
                               if kk != "gathered"}
                           for k, v in refs.items()}}


def phase_pipeline(card: str, dev: str = "cuda"):
    """PipelineTransformerLM and ZeRO-1/FSDP (the PP_* comment): (b) and
    (c)'s ranks start first and join while (a) runs on the card; the
    counts are set to 0 before each of (a)'s runs and read after it.
    Returns (the lines, the launches of (a), (b)'s references and the
    ranks' runs)."""
    import tempfile
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, PipelineTransformerLM
    t_start = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pp_") as tmp:
        started = _pp_start_ranks(tmp, dev)
        try:
            rng = np.random.default_rng(SEED + 27)
            v, s = PP_LM["vocab_size"], PP_LM["seq_len"]
            toks = rng.integers(0, v, (PLM_BATCH, s)).astype(np.int32)
            tree = _pp_tree(PipelineTransformerLM(
                **PP_LM, mesh=Mesh(device="meta",
                                   axis_names=("data", "stage"))), rng)
            runs, launches = {}, {}
            for sched in PP_SCHEDULES:
                for m in PP_MICRO:
                    r = _pp_one_rank(card, dev, sched, m, tree, toks)
                    launches = _add_counts(launches, r["launches"])
                    losses, counts = r["losses"], r["launches"]
                    step_ms = statistics.median(r["seconds"][1:]) * 1e3
                    row = {"phase": "pipeline_train", "schedule": sched,
                           "microbatches": m, "config": PP_LM,
                           "compute_dtype": "bfloat16", "batch": PLM_BATCH,
                           "steps": PLM_STEPS, "losses": losses,
                           "last_over_first": losses[-1] / losses[0],
                           "launches": counts,
                           "first_step_ms": r["seconds"][0] * 1e3,
                           "ms_per_step": step_ms,
                           "tokens_per_s": PLM_BATCH * s / (step_ms / 1e3),
                           "peak_bytes": r["peak_bytes"], "card": card}
                    emit(row)
                    runs[f"{sched}_m{m}"] = row
                    tag = f"pipeline {sched} M={m}"
                    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                          f"{tag}: losses {losses}")
                    if cuda:
                        want = PP_LM["num_layers"] * m * PLM_STEPS
                        check(all(counts[f"flash_{k}_sm90"] == want
                                  for k in ("fwd_lse", "dq", "dkv"))
                              and counts["flash_inference_sm90"] == (
                                  want if sched == "1f1b" else 0)
                              and not any(counts[f"flash_{k}_simt"] for k
                                          in ("fwd_lse", "dq", "dkv",
                                              "inference"))
                              and counts["fused_ce_fwd"] == 0,
                              f"{tag}: launches {counts}, want {want} sm90 "
                              "each")
            del tree
            ranks = _pp_ranks(card, dev, tmp, started)
        finally:
            for p in started[0].processes:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for ref in ranks["references"].values():
        launches = _add_counts(launches, ref["launches"])
    launches = _add_counts(launches, ranks["launches"])
    summary = {"phase": "pipeline",
               "ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()},
               "tokens_per_s": {k: r["tokens_per_s"]
                                for k, r in runs.items()},
               "peak_bytes": {k: r["peak_bytes"] for k, r in runs.items()},
               "ranks_ms_per_step": {k: r["ms_per_step"] for k, r in
                                     ranks["pipeline"].items()},
               "zero_ms_per_step": {k: r["ms_per_step"] for k, r in
                                    ranks["zero"].items()},
               "launches_pipeline": launches,
               "seconds": time.perf_counter() - t_start, "card": card}
    emit(summary)
    return {"train": runs, "ranks": ranks}, launches


_SPMD_RANK = """
import json, os, sys, time
t_enter = time.time()
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from distkeras_tpu_torch.job_deployment import initialize_from_env
initialize_from_env()
import torch.distributed as dist
import chip_smoke as c
rank = dist.get_rank()
spec_path, out, go, t0 = sys.argv[1:5]
spec = json.load(open(spec_path))
for name, value in spec["constants"].items():  # the parent's sizes
    setattr(c, name, value)
joined = time.time()
deadline = time.time() + spec["timeout_s"]
x, y = c._adag_rows(c.ADAG_ROWS)  # while the parent's references run
while not os.path.exists(go):
    if time.time() > deadline:
        raise TimeoutError("no go from the parent process")
    time.sleep(0.01)
result = {"rank": rank, "joined_s": joined - float(t0),
          "entered_s": t_enter - float(t0),
          "backend": str(dist.get_backend()), "runs": {}}
for algo in spec["algos"]:
    run, arrays = c._spmd_north_star(spec["device"], spec["ranks"], algo,
                                     x, y)
    result["runs"][algo] = run
    np.savez(os.path.join(out, "%s_rank%d.npz" % (algo, rank)), **arrays)
    result["device"] = run.pop("device")
blob = np.load(os.path.join(out, "lm.npz"))
result["predict"] = c._spmd_predict(spec["device"], spec["ranks"], blob)
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump(result, f)
dist.destroy_process_group()
"""


def _spmd_north_star(dev: str, n: int, algo: str, x, y):
    """The north-star configuration under ``algo`` on a mesh of ``n``
    workers on ``dev`` (across ranks inside a group of ``n``, in this
    process without one): SPMD_RANK_EPOCHS epochs from the seeded weights,
    the counts and the collectives' counters set to 0 before the last
    (timed) one.  Returns (the row, the arrays: losses, center, this
    process's workers)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.parallel import (SPMDEngine, get_mesh,
                                              shape_epoch_data)
    mesh = get_mesh(n, devices=[dev] * n)
    model = models.mnist_convnet("bfloat16", device=dev)
    engine = SPMDEngine(model, "categorical_crossentropy", "adam", mesh,
                        algo, communication_window=ADAG_WINDOW)
    xb, yb, mb, rounds = shape_epoch_data(x, y, n, ADAG_WINDOW, ADAG_BATCH)
    xb, yb = engine.place_columns(xb, 2), engine.place_columns(yb, 2)
    state = engine.init_state(torch.Generator().manual_seed(SEED), (784,))
    rngs = engine.worker_rngs(SEED)
    losses, seconds = [], []
    for epoch in range(SPMD_RANK_EPOCHS):
        _sync(dev)
        if epoch == SPMD_RANK_EPOCHS - 1:
            mesh.comm_stats.clear()
            _zero_counts()
        t0 = time.perf_counter()
        state, ls = engine.run_epoch(state, xb, yb, mb, rngs)
        losses.append(ls.cpu().numpy())  # the epoch's one host sync
        seconds.append(time.perf_counter() - t0)
    launches = _read_counts()
    arrays = {"losses": np.concatenate(losses)}
    arrays.update({f"center/{k}": v.float().cpu().numpy()
                   for k, v in state.center.items()})
    for w, p in zip(engine.workers, state.local):
        arrays.update({f"worker{w}/{k}": v.float().cpu().numpy()
                       for k, v in p.items()})
    row = {"algorithm": algo, "workers": n, "ranks": engine.ranks,
           "rounds_per_epoch": rounds, "epoch_s": seconds,
           "examples_per_s": len(x) / seconds[-1],
           "ms_per_round": seconds[-1] / rounds * 1e3,
           "launches": launches, "device": str(engine.device),
           "collectives": {op: dict(v) for op, v in
                           mesh.comm_stats.items()}}
    return row, arrays


def _spmd_predict(dev: str, n: int, blob) -> dict:
    """ModelPredictor over phase slice's LM with ``mesh=`` a mesh of ``n``
    ranks on ``dev`` (SPMD_PREDICT_BATCH rows a rank a chunk), the counts
    set to 0 before the counted predict; its gathered rows against the
    one-device predict in ``blob`` (bit-equal, largest gap)."""
    import numpy as np
    from distkeras_tpu_torch import (Dataset, FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    from distkeras_tpu_torch.parallel import get_mesh
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, [blob[f"w{i}"] for i in range(int(blob["nw"]))])
    mesh = get_mesh(n, devices=[dev] * n)
    predictor = ModelPredictor(FittedModel(model), mesh=mesh,
                               batch_size=SPMD_PREDICT_BATCH)
    data = Dataset({"features": blob["tokens"]})
    predictor.predict(data)  # warm-up: cuBLAS handles, allocator
    _sync(dev)
    mesh.comm_stats.clear()
    _zero_counts()
    t0 = time.perf_counter()
    got = predictor.predict(data)["prediction"]
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    want = blob["logits"]
    return {"seconds": seconds, "launches": launches,
            "shape": list(got.shape),
            "bit_equal": bool(np.array_equal(got, want)),
            "max_abs_gap": float(np.abs(got - want).max()),
            "collectives": {op: dict(v) for op, v in
                            mesh.comm_stats.items()}}


def _spmd_start_ranks(tmp: str, dev: str):
    """The ranks started as a coordinated Job over gloo (they make the
    north-star rows themselves and wait for the go); returns (the job, the
    go file, the launch time)."""
    import json
    import socket
    from distkeras_tpu_torch.job_deployment import Job, LocalJobRunner
    spec_path, script = (os.path.join(tmp, n)
                         for n in ("spec.json", "spmd_rank.py"))
    with open(spec_path, "w") as f:
        json.dump({"ranks": SPMD_RANKS, "algos": list(SPMD_RANK_ALGOS),
                   # every rank on the one card
                   "device": "cuda:0" if dev == "cuda" else dev,
                   "timeout_s": SPMD_RANK_TIMEOUT_S,
                   "constants": {n: globals()[n] for n in (
                       "ADAG_ROWS", "ADAG_BATCH", "ADAG_WINDOW", "LM",
                       "SEED", "SPMD_RANK_EPOCHS", "SPMD_PREDICT_BATCH")}},
                  f)
    with open(script, "w") as f:
        f.write(_SPMD_RANK)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    go = os.path.join(tmp, "go")
    t_launch = time.time()
    job = Job("spmd_ranks", script, args=[spec_path, tmp, go,
                                          repr(t_launch)],
              hosts=["127.0.0.1"] * SPMD_RANKS, coordinator_port=port,
              backend="gloo", env={"PYTHONPATH": os.pathsep.join(
                  p for p in (root, os.environ.get("PYTHONPATH")) if p)})
    job.run(LocalJobRunner(), wait=False)
    return job, go, t_launch


def phase_spmd_ranks(card: str, dev: str = "cuda"):
    """The SPMD engine, ModelPredictor and the dry run across ranks (the
    SPMD_* comment): the ranks of (a) and (b) start first and join, and
    (c)'s dry run runs on a thread of its own, while this process runs
    (a)'s and (b)'s one-process references, which count as the main path
    too; the go waits for the dry run's end, so the ranks' timed runs
    share the card with nothing; then the ranks' results and the
    comparisons.  Returns (the lines, every launch: this process's, the
    ranks' and the dry run's)."""
    import tempfile
    import threading
    import numpy as np
    import torch
    from distkeras_tpu_torch import (Dataset, FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    from distkeras_tpu_torch.dryrun import dryrun_multichip
    t_start = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    launches, rows = {}, {}
    dry = {}

    def dry_run():
        t0 = time.perf_counter()
        try:
            dry["result"] = dryrun_multichip(SPMD_DRYRUN_RANKS,
                                             None if cuda else dev)
        except BaseException as e:  # re-raised on this phase's thread
            dry["error"] = e
        dry["seconds"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spmd_") as tmp:
        job, go, t_launch = _spmd_start_ranks(tmp, dev)
        dry_thread = threading.Thread(target=dry_run, name="dryrun")
        dry_thread.start()
        try:
            x, y = _adag_rows(ADAG_ROWS)
            refs = {}
            for algo in SPMD_RANK_ALGOS:
                refs[algo] = _spmd_north_star(dev, SPMD_RANKS, algo, x, y)
                launches = _add_counts(launches, refs[algo][0]["launches"])
            model = transformer_lm(**LM, device=dev)
            weights = _random_jax_weights(model, np.random.default_rng(
                SEED + 29))
            load_jax_weights(model, weights)
            toks = np.random.default_rng(SEED + 30).integers(
                0, LM["vocab_size"], (SPMD_PREDICT_ROWS, LM["seq_len"])
            ).astype(np.int32)
            one = ModelPredictor(FittedModel(model), device=dev,
                                 batch_size=SPMD_PREDICT_BATCH)
            one.predict(Dataset({"features": toks}))  # warm-up
            _zero_counts()
            t0 = time.perf_counter()
            logits = one.predict(Dataset({"features": toks}))["prediction"]
            one_s = time.perf_counter() - t0
            one_launches = _read_counts()
            launches = _add_counts(launches, one_launches)
            np.savez(os.path.join(tmp, "lm.npz"), tokens=toks,
                     logits=logits, nw=len(weights),
                     **{f"w{i}": w for i, w in enumerate(weights)})
            del model, one
            dry_thread.join()
            if "error" in dry:
                raise dry["error"]
            open(go, "w").close()
            codes = []
            for p in job.processes:
                left = max(t_launch + SPMD_RANK_TIMEOUT_S - time.time(), 1.0)
                codes.append(p.wait(timeout=left))
            check(codes == [0] * SPMD_RANKS, f"spmd ranks exited {codes}")
            ranks = []
            for r in range(SPMD_RANKS):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            # (a): the ranks against the one-process engine, to the bit
            for algo in SPMD_RANK_ALGOS:
                ref_row, ref = refs[algo]
                got = [dict(np.load(os.path.join(
                    tmp, f"{algo}_rank{r}.npz"))) for r in range(SPMD_RANKS)]
                equal = {
                    "losses": all(np.array_equal(g["losses"],
                                                 ref["losses"]) for g in got),
                    "center": all(np.array_equal(g[k], v) for g in got
                                  for k, v in ref.items()
                                  if k.startswith("center/")),
                    "workers": all(np.array_equal(
                        got[r][k], ref[k]) for r in range(SPMD_RANKS)
                        for k in ref if k.startswith(f"worker{r}/"))}
                runs = [r["runs"][algo] for r in ranks]
                for run in runs:
                    launches = _add_counts(launches, run["launches"])
                row = {"phase": "spmd_ranks_train", "algorithm": algo,
                       "ranks": SPMD_RANKS, "backend": ranks[0]["backend"],
                       "devices": [r["device"] for r in ranks],
                       "compute_dtype": "bfloat16", "batch": ADAG_BATCH,
                       "window": ADAG_WINDOW, "rows": len(x),
                       "epochs": SPMD_RANK_EPOCHS,
                       "rounds_per_epoch": ref_row["rounds_per_epoch"],
                       "bit_equal_to_one_process": equal,
                       "losses": ref["losses"].tolist(),
                       "examples_per_s": [r["examples_per_s"] for r in runs],
                       "ms_per_round_per_rank": [r["ms_per_round"]
                                                 for r in runs],
                       "epoch_s_per_rank": [r["epoch_s"] for r in runs],
                       "one_process_examples_per_s":
                           ref_row["examples_per_s"],
                       "one_process_ms_per_round": ref_row["ms_per_round"],
                       "collectives_per_rank": [r["collectives"]
                                                for r in runs],
                       "launches_per_rank": [r["launches"] for r in runs],
                       "child_start_s": [r["joined_s"] for r in ranks],
                       "card": card}
                emit(row)
                rows[algo] = row
                check(all(r["backend"] == "gloo" and r["device"] == (
                          "cuda:0" if cuda else dev) for r in ranks),
                      f"spmd ranks: {[r['backend'] for r in ranks]}, "
                      f"{[r['device'] for r in ranks]}")
                check(np.isfinite(ref["losses"]).all()
                      and all(equal.values()),
                      f"spmd ranks {algo}: not equal to one process to the "
                      f"bit: {equal}")
                check(not any(v for r in runs for v in
                              r["launches"].values())
                      and not any(ref_row["launches"].values()),
                      f"spmd ranks {algo}: kernel launches "
                      f"{[r['launches'] for r in runs]}, want none")
                check(all(r["collectives"]["all_reduce"]["calls"]
                          == ref_row["rounds_per_epoch"] for r in runs),
                      f"spmd ranks {algo}: collectives "
                      f"{[r['collectives'] for r in runs]}, want one "
                      "all_reduce a round")
            # (b): ModelPredictor(mesh=) over the LM
            preds = [r["predict"] for r in ranks]
            for pr in preds:
                launches = _add_counts(launches, pr["launches"])
            row = {"phase": "spmd_ranks_predict", "ranks": SPMD_RANKS,
                   "config": LM, "compute_dtype": "bfloat16",
                   "rows": SPMD_PREDICT_ROWS, "batch": SPMD_PREDICT_BATCH,
                   "bit_equal_to_one_device": [p["bit_equal"]
                                               for p in preds],
                   "max_abs_gap": [p["max_abs_gap"] for p in preds],
                   "shape": preds[0]["shape"],
                   "seconds_per_rank": [p["seconds"] for p in preds],
                   "one_device_seconds": one_s,
                   "one_device_launches": one_launches,
                   "launches_per_rank": [p["launches"] for p in preds],
                   "collectives_per_rank": [p["collectives"]
                                            for p in preds],
                   "card": card}
            emit(row)
            rows["predict"] = row
            check(all(p["bit_equal"] for p in preds),
                  f"spmd ranks predict: rows differ from one device by "
                  f"{row['max_abs_gap']}")
            if cuda:
                want = LM["num_layers"]  # one batch of rows a rank
                for r, n in enumerate(row["launches_per_rank"]):
                    check(n["flash_inference_sm90"] == n["flash_inference"]
                          == want and not any(
                              v for k, v in n.items() if k not in (
                                  "flash_inference", "flash_inference_sm90")),
                          f"spmd ranks predict: rank {r} launches {n}, want "
                          f"{want} flash_inference_sm90 and nothing else")
        finally:
            dry_thread.join()
            for p in job.processes:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    # (c): the dry run of the distributed surface on the card
    ranks = dry["result"]["ranks"]
    for r in ranks:
        launches = _add_counts(launches, r["launches"])
    row = {"phase": "spmd_ranks_dryrun", "ranks": SPMD_DRYRUN_RANKS,
           "seconds": dry["seconds"],
           "devices": [r["device"] for r in ranks],
           "losses": {k: ranks[0][k] for k in
                      ("adag", "transformer", "ulysses_fsdp",
                       "pipeline_gpipe", "pipeline_1f1b")},
           "factors": ranks[0]["factors"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "jax_modules": [r["modules"] for r in ranks],
           "card": card}
    emit(row)
    rows["dryrun"] = row
    check(all(not r["modules"] for r in ranks),
          "spmd ranks dryrun: a rank loaded jax")
    emit({"phase": "spmd_ranks", "launches_spmd_ranks": launches,
          "seconds": time.perf_counter() - t_start, "card": card})
    return rows, launches


def _host_ms(fn, reps: int = NATIVE_REPS) -> float:
    """Median host-clock ms of ``reps`` calls (after one untimed)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _leaf_bits(v) -> bytes:
    """A wire leaf's bytes: a numpy array's, or a bf16 tensor's."""
    import numpy as np
    import torch
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def _native_builds(card: str) -> dict:
    """Leg (a) of phase native: each host extension built from the
    checkout's sources into an empty directory beside the build
    directory, then the modules the run uses (the checkout's build,
    loaded once)."""
    import shutil
    import sysconfig
    from pathlib import Path
    from distkeras_tpu_torch import kernels, native
    include = sysconfig.get_paths()["include"]
    probe = kernels.BUILD_DIR.parent / "native_probe"
    shutil.rmtree(probe, ignore_errors=True)
    saved, seconds = kernels.BUILD_DIR, {}
    kernels.BUILD_DIR = probe
    try:
        before = native.compiles
        for name in native.MODULES:
            t0 = time.perf_counter()
            built = native.build([name])
            seconds[name] = time.perf_counter() - t0
            check(built == [name], f"native: {name} built {built}")
        compiles = native.compiles - before
        again = native.build()
    finally:
        kernels.BUILD_DIR = saved
        shutil.rmtree(probe, ignore_errors=True)
    mods = {n: native.load(n) for n in native.MODULES}
    row = {"phase": "native_build", "cxx": native.compiler(),
           "python_h": (Path(include) / "Python.h").exists(),
           "seconds": seconds, "compiles": compiles,
           "second_call_compiled": again,
           "modules": {n: m.__name__ for n, m in mods.items()},
           "card": card}
    emit(row)
    check(compiles == len(native.MODULES) and not again,
          f"native: {compiles} compiles, then {again} on a second call")
    check(all(m.__name__ == f"distkeras_tpu_torch._{n}"
              and Path(m.__file__).parent == kernels.BUILD_DIR
              for n, m in mods.items()), f"native: modules {row['modules']}")
    return mods


def _native_wire(card: str, dev: str, mods: dict) -> list:
    """Leg (b) of phase native: three messages through both codecs.
    Returns the ConvNet's leaf shapes (the apply leg's center)."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import models, networking, transformer_lm
    lm = transformer_lm(**LM, device=dev).get_weights()
    conv = [w.shape for w in models.mnist_convnet(
        "bfloat16", device=dev).get_weights()]
    rng = np.random.default_rng(SEED + 29)
    messages = {
        "lm_f32": {"weights": lm, "clock": 3},
        "lm_bf16": {"weights": [torch.from_numpy(w).to(torch.bfloat16)
                                for w in lm], "clock": 3},
        "convnet_delta": {"delta": [rng.standard_normal(s).astype(
            np.float32) for s in conv], "clock": 0, "worker_id": 0}}
    codecs = {"native": mods["wirecodec"], "python": None}
    try:
        for name, msg in messages.items():
            blobs, enc_ms, dec_ms, decoded = {}, {}, {}, {}
            for c, mod in codecs.items():
                networking._native = mod
                blobs[c] = bytes(networking.encode_message(msg))
                enc_ms[c] = _host_ms(lambda: networking.encode_message(msg))
            for c, mod in codecs.items():  # each decodes the same bytes
                networking._native = mod
                dec_ms[c] = _host_ms(
                    lambda: networking.decode_message(blobs["python"]))
                decoded[c] = networking.decode_message(blobs["python"])
            key = "weights" if "weights" in msg else "delta"
            same_decode = all(
                _leaf_bits(a) == _leaf_bits(b) == _leaf_bits(w)
                for a, b, w in zip(decoded["native"][key],
                                   decoded["python"][key], msg[key]))
            row = {"phase": "native_wire", "message": name,
                   "leaves": len(msg[key]),
                   "elements": int(sum(int(np.prod(w.shape))
                                       for w in msg[key])),
                   "bytes": len(blobs["native"]),
                   "same_bytes": blobs["native"] == blobs["python"],
                   "same_decode": same_decode, "encode_ms": enc_ms,
                   "decode_ms": dec_ms, "card": card}
            emit(row)
            check(row["same_bytes"] and same_decode,
                  f"native wire {name}: bytes equal {row['same_bytes']}, "
                  f"decodes equal {same_decode}")
    finally:
        networking._native = mods["wirecodec"]
    check(sum(int(np.prod(s)) for s in conv) == 430_890,
          f"native: the ConvNet has {conv}")
    return conv


def _native_apply(card: str, mods: dict, conv: list) -> None:
    """Leg (c) of phase native: the three PS applies, native against
    numpy, to the bit."""
    import numpy as np
    from distkeras_tpu_torch import applykernel
    kern = mods["applykernel"]
    rng = np.random.default_rng(SEED + 31)
    n = sum(int(np.prod(s)) for s in conv)
    center = rng.standard_normal(n).astype(np.float32)
    delta = rng.standard_normal(n).astype(np.float32) * np.float32(1e-2)
    k = int(PS_SPARSE_TOPK * n)
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int64)
    vals = rng.standard_normal(k).astype(np.float32)
    vocab, dim = PS_SPARSE_EMB
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    rows = np.sort(rng.choice(
        vocab, PS_SPARSE_EMB_WINDOW * PS_SPARSE_EMB_BATCH,
        replace=False)).astype(np.int32)
    row_vals = rng.standard_normal((len(rows), dim)).astype(np.float32)
    scale = 1.0 / HOST_PS_WORKERS
    cases = {
        "dense_axpy": (center, lambda kk, dst: applykernel.axpy(
            kk, dst, delta, scale)),
        "topk_scatter_add": (center, lambda kk, dst: applykernel.scatter_add(
            kk, dst, idx, vals)),
        "row_sparse": (table, lambda kk, dst: applykernel.row_scatter_add(
            kk, dst, rows, row_vals)),
    }
    for name, (base, apply) in cases.items():
        out, ms = {}, {}
        for route, kk in (("native", kern), ("numpy", None)):
            dst = base.copy()
            apply(kk, dst)
            out[route] = dst
            work = base.copy()
            ms[route] = _host_ms(lambda: apply(kk, work))
        same = np.array_equal(out["native"].view(np.uint32),
                              out["numpy"].view(np.uint32))
        emit({"phase": "native_apply", "case": name,
              "elements": int(base.size), "touched": {
                  "dense_axpy": n, "topk_scatter_add": k,
                  "row_sparse": int(row_vals.size)}[name],
              "bit_identical": same, "ms": ms, "card": card})
        check(same, f"native apply {name}: native and numpy differ")


def _native_runs(card: str, dev: str, mods: dict) -> dict:
    """Leg (d) of phase native: one-worker host-PS ADAG, native codec and
    apply against the pure-Python codec and numpy, the ConvNet and the
    LM; each run's kernel launches counted from 0.  Returns the LM runs'
    launches summed."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import ADAG, models, networking, transformer_lm
    routes = {"native": (mods["wirecodec"], "native"),
              "plain": (None, None)}
    x, y, _, _ = _host_ps_rows()
    lx, ly = _host_ps_lm_rows()
    total, centers = {}, {}
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for route, (codec, kernel) in routes.items():
            networking._native = codec
            serial = dict(worker_optimizer="adam", comm_overlap=False,
                          apply_kernel=kernel)
            r = _host_ps_run(ADAG, models.mnist_convnet("bfloat16",
                                                        device=dev),
                             x, y, dev, 1, **serial)
            centers[("convnet", route)] = r["fitted"].get_weights()
            emit({"phase": "native_convnet", "route": route,
                  **_host_ps_row(r), "card": card})
            check(r["loss_falls"] and r["center_finite"],
                  f"native convnet {route}: {r['first_last_loss']}")
            _zero_counts()
            r = _host_ps_run(ADAG, transformer_lm(**LM, device=dev), lx, ly,
                             dev, 1, batch_size=BATCH,
                             communication_window=HOST_PS_LM_WINDOW,
                             loss="sparse_categorical_crossentropy_from_"
                                  "logits", learning_rate=3e-3, **serial)
            launches = _read_counts()
            total = _add_counts(total, launches)
            centers[("lm", route)] = r["fitted"].get_weights()
            steps = r["windows_per_worker"][0] * HOST_PS_LM_WINDOW
            want = LM["num_layers"] * steps
            sm90 = {k: launches[f"flash_{k}_sm90"]
                    for k in ("fwd_lse", "dq", "dkv")}
            trained = {f"flash_{k}{v}" for k in ("fwd_lse", "dq", "dkv")
                       for v in ("", "_sm90")}
            others = {k: v for k, v in launches.items()
                      if v and k not in trained}
            emit({"phase": "native_lm", "route": route, **_host_ps_row(r),
                  "tokens_per_sec": len(lx) * LM["seq_len"] / r["seconds"],
                  "launches_sm90": sm90, "launches_other": others,
                  "want_each": want, "card": card})
            check(r["loss_falls"], f"native lm {route}: the loss did not "
                                   f"fall {r['first_last_loss']}")
            if dev == "cuda":
                check(all(v == want for v in sm90.values()) and not others,
                      f"native lm {route}: sm90 launches {sm90}, others "
                      f"{others}, want {want} each and nothing else")
    finally:
        networking._native = mods["wirecodec"]
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
    same = {m: all(np.array_equal(a, b) for a, b in zip(
        centers[(m, "native")], centers[(m, "plain")]))
        for m in ("convnet", "lm")}
    emit({"phase": "native_centers", "bit_identical": same, "card": card})
    check(all(same.values()), f"native: centers differ {same}")
    return total


def _native_csv(card: str, mods: dict) -> None:
    """Leg (e) of phase native: a Higgs-layout CSV through read_csv's
    two routes."""
    import numpy as np
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data import datasets
    rng = np.random.default_rng(SEED + 37)
    # f32 features written with 9 significant digits: the shortest text
    # that reads back to the same f32 on either route
    x = rng.standard_normal((NATIVE_CSV_ROWS, 28)).astype(np.float32)
    y = rng.integers(0, 2, NATIVE_CSV_ROWS)
    path = kernels.BUILD_DIR.parent / "native_higgs.csv"
    out, seconds = {}, {}
    try:
        t0 = time.perf_counter()
        with open(path, "w") as f:
            f.write(",".join(["label"] + [f"f{i}" for i in range(28)])
                    + "\n")
            np.savetxt(f, np.column_stack([y, x]),
                       fmt=["%d"] + ["%.9g"] * 28, delimiter=",")
        write_s = time.perf_counter() - t0
        for route, mod in (("native", mods["csvloader"]),
                           ("genfromtxt", None)):
            datasets._native_csv = mod
            t0 = time.perf_counter()
            out[route] = datasets.read_csv(str(path), "label")
            seconds[route] = time.perf_counter() - t0
    finally:
        datasets._native_csv = mods["csvloader"]
        size = path.stat().st_size if path.exists() else 0
        path.unlink(missing_ok=True)
    same = all(np.array_equal(out["native"][c].view(np.uint8),
                              out["genfromtxt"][c].view(np.uint8))
               for c in ("features", "label"))
    exact = (np.array_equal(out["native"]["features"], x)
             and np.array_equal(out["native"]["label"], y))
    emit({"phase": "native_csv", "rows": NATIVE_CSV_ROWS, "columns": 29,
          "bytes": size, "write_s": write_s, "seconds": seconds,
          "bit_equal": same, "exact": exact, "card": card})
    check(same and exact, f"native csv: routes equal {same}, values "
                          f"exact {exact}")


def phase_native(card: str, dev: str = "cuda"):
    """The port's host C++ extensions (the NATIVE_* comment): builds, the
    wire, the PS apply, the host-PS runs and the CSV, each native route
    against its pure-Python or numpy twin.  Returns (None, the LM runs'
    launches)."""
    t_start = time.perf_counter()
    mods = _native_builds(card)
    conv = _native_wire(card, dev, mods)
    _native_apply(card, mods, conv)
    launches = _native_runs(card, dev, mods)
    _native_csv(card, mods)
    emit({"phase": "native_launches", "launches": launches})
    emit({"phase": "native_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return None, launches


def _loadgen_main(argv) -> list:
    """The port's loadgen ``main(argv)`` in this process: its JSON lines,
    parsed."""
    import contextlib
    import io
    from distkeras_tpu_torch.examples import loadgen
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loadgen.main(list(argv))
    return [json.loads(line) for line in out.getvalue().splitlines()]


def _loadgen_cli(card: str, dev: str) -> dict:
    """(a): the CLI at the JAX script's defaults and with --spec-draft 1
    (no kernel launched on either), then build_spec_engine's trained pair
    behind a speculative engine (the SIMT training kernels once a layer
    and step of each model's training)."""
    from distkeras_tpu_torch.examples import loadgen
    want_modes = {(): ["closed_loop", "sequential", "speedup"],
                  ("--spec-draft", "1"): ["closed_loop", "spec",
                                          "sequential", "speedup"]}
    rows = {}
    for extra, modes in want_modes.items():
        name = "spec_draft_1" if extra else "default"
        _zero_counts()
        t0 = time.perf_counter()
        lines = _loadgen_main([*LOADGEN_CLI, *extra, "--device", dev])
        wall = time.perf_counter() - t0
        launches = _read_counts()
        closed = lines[0]
        row = {"phase": "loadgen_cli", "run": name,
               "argv": [*LOADGEN_CLI, *extra, "--device", dev],
               "modes": [ln["mode"] for ln in lines], "wall_s": wall,
               "lines": lines, "launches": launches, "card": card}
        emit(row)
        check([ln["mode"] for ln in lines] == modes,
              f"loadgen {name}: modes {row['modes']}, want {modes}")
        check(closed["completed"] == 24 and closed["shed"] == 0
              and closed["killed"] == 0 and closed["tokens"] == 24 * 16,
              f"loadgen {name}: the closed loop lost requests: {closed}")
        check(not any(v for v in launches.values()),
              f"loadgen {name}: kernel launches {launches}, want none")
        rows[name] = row
    _zero_counts()
    t0 = time.perf_counter()
    target, draft, eng = loadgen.build_spec_engine(
        num_epoch=LOADGEN_SPEC_EPOCHS, device=dev)
    train_s = time.perf_counter() - t0
    trace = loadgen.make_trace(24, num_steps=16, pattern="arith")
    try:
        closed = loadgen.run_closed_loop(eng, trace, concurrency=8,
                                         timeout_s=LOADGEN_TIMEOUT_S)
    finally:
        eng.stop()
    launches = _read_counts()
    steps = LOADGEN_SPEC_EPOCHS * -(-loadgen.SPEC_ROWS
                                    // loadgen.SPEC_BATCH)
    want = (loadgen.SPEC_TARGET_LAYERS + loadgen.SPEC_DRAFT_LAYERS) * steps
    expect = {k: 0 for k in launches}
    if dev == "cuda":  # on the CPU the wrappers run the plain versions
        for kernel in ("flash_fwd_lse", "flash_dq", "flash_dkv"):
            expect[kernel] = expect[f"{kernel}_simt"] = want
    row = {"phase": "loadgen_spec", "epochs": LOADGEN_SPEC_EPOCHS,
           "steps_per_model": steps, "train_s": train_s,
           "closed_loop": closed, "drafted": eng.stats["drafted"],
           "accepted": eng.stats["accepted"],
           "launches_loadgen": launches, "want": expect, "card": card}
    emit(row)
    check(launches == expect,
          f"loadgen spec: launches {launches}, want {expect}")
    check(closed["completed"] == len(trace) and closed["shed"] == 0,
          f"loadgen spec: the closed loop lost requests: {closed}")
    rows["spec"] = row
    return rows


def _recording(eng) -> list:
    """Keep every handle that ``eng.submit`` returns (the loop's own and
    the server's)."""
    handles, submit = [], eng.submit

    def recording_submit(*args, **kw):
        handles.append(submit(*args, **kw))
        return handles[-1]

    eng.submit = recording_submit
    return handles


def _held_flood(eng, n: int, timeout_s: float) -> list:
    """Hold ``eng``'s scheduler until ``n`` submissions were tried, so an
    open-loop flood meets a queue that nothing drains; returns the list
    that collects each ``QueueFull`` the flood's submissions raised."""
    from distkeras_tpu_torch.serving import QueueFull
    tried, refused = [0], []
    gate = threading.Event()
    submit, step = eng.submit, eng.step

    def counted_submit(*args, **kw):
        try:
            return submit(*args, **kw)
        except QueueFull as e:
            refused.append(e)
            raise
        finally:
            tried[0] += 1
            if tried[0] == n:
                gate.set()

    def held_step():
        gate.wait(timeout=timeout_s)
        return step()

    eng.submit, eng.step = counted_submit, held_step
    return refused


def _by_prompt(handles, trace) -> list:
    """The handles' rows in trace order (every prompt differs)."""
    import numpy as np
    rows = {h.prompt.tobytes(): np.asarray(h.result()) for h in handles}
    return [rows.get(np.asarray(r["prompt"], np.int32).tobytes())
            for r in trace]


def _loadgen_full(card: str, dev: str) -> dict:
    """(b): the full-width LM's engine under the three load loops."""
    import numpy as np
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.examples import loadgen
    from distkeras_tpu_torch.serving import ServingServer
    rng = np.random.default_rng(SEED + 27)
    model = transformer_lm(**LM, device=dev)
    load_jax_weights(model, _random_jax_weights(model, rng))
    trace = loadgen.make_trace(
        LOADGEN_REQUESTS, vocab=LM["vocab_size"],
        prompt_lengths=SERVE_PROMPT_LENS, num_steps=LOADGEN_STEPS,
        temperature=SERVE_TEMP)
    greedy = [i for i, r in enumerate(trace) if not r.get("temperature")]
    eng = _serve_engine(model, False)
    handles = [eng.submit(**r) for r in trace]
    eng.run_until_idle()
    want = [np.asarray(h.result()) for h in handles]

    def rows_check(name, got):
        share = _share_equal(got, want)
        greedy_equal = all(got[i] is not None
                           and np.array_equal(got[i], want[i])
                           for i in greedy)
        return {f"{name}_share_equal": share,
                f"{name}_greedy_equal": greedy_equal}

    eng = _serve_engine(model, False)
    recorded = _recording(eng)
    try:
        closed = loadgen.run_closed_loop(eng, trace,
                                         concurrency=LOADGEN_USERS,
                                         timeout_s=LOADGEN_TIMEOUT_S)
    finally:
        eng.stop()
    checks = rows_check("closed", _by_prompt(recorded, trace))
    eng = _serve_engine(model, False)
    recorded = _recording(eng)
    srv = ServingServer(eng, server_core="event", poll_s=0.002).start()
    try:
        wire = loadgen.run_wire_closed_loop(srv.addr, trace,
                                            concurrency=LOADGEN_USERS,
                                            timeout_s=LOADGEN_TIMEOUT_S)
    finally:
        srv.stop()
        eng.stop()
    checks.update(rows_check("wire", _by_prompt(recorded, trace)))
    eng = _serve_engine(model, False, queue_capacity=LOADGEN_FLOOD_QUEUE)
    refused = _held_flood(eng, len(trace), LOADGEN_TIMEOUT_S)
    try:
        flood = loadgen.run_open_loop(eng, trace, qps=LOADGEN_FLOOD_QPS,
                                      timeout_s=LOADGEN_TIMEOUT_S)
    finally:
        eng.stop()
    s = eng.stats
    counters = {k: s[k] for k in ("requests_submitted", "requests_completed",
                                  "requests_rejected", "requests_failed",
                                  "requests_cancelled", "requests_expired")}
    keys = ("completed", "shed", "tokens", "wall_s", "tokens_per_sec",
            "p50_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms",
            "slot_occupancy")
    row = {"phase": "loadgen_full", "form": "full",
           "compute_dtype": LM["compute_dtype"], "slots": SERVE_SLOTS,
           "prefill_chunk": SERVE_CHUNK, "requests": len(trace),
           "steps": LOADGEN_STEPS, "users": LOADGEN_USERS,
           "prompt_lens": sorted({len(r["prompt"]) for r in trace}),
           "sampled_requests": len(trace) - len(greedy),
           "closed_loop": {k: closed[k] for k in keys},
           "wire_closed_loop": wire,
           "open_loop_flood": {**{k: flood[k] for k in keys},
                               "offered_qps": flood["offered_qps"],
                               "queue_capacity": LOADGEN_FLOOD_QUEUE,
                               "refusals": sorted({type(e).__name__
                                                    for e in refused}),
                               "counters": counters},
           **checks, "card": card}
    emit(row)
    n = len(trace)
    check(closed["completed"] == n and closed["shed"] == 0
          and closed["tokens"] == n * LOADGEN_STEPS,
          f"loadgen full: the closed loop lost requests: {row['closed_loop']}")
    check(wire["completed"] == n and wire["tokens"] == n * LOADGEN_STEPS,
          f"loadgen full: the wire loop lost requests: {wire}")
    check(checks["closed_greedy_equal"] and checks["wire_greedy_equal"],
          f"loadgen full: greedy rows differ from direct submit: {checks}")
    check(flood["shed"] == len(refused) == n - LOADGEN_FLOOD_QUEUE
          and row["open_loop_flood"]["refusals"] == ["QueueFull"]
          and flood["completed"] == LOADGEN_FLOOD_QUEUE
          and counters["requests_rejected"] == flood["shed"]
          and counters["requests_submitted"]
          == counters["requests_completed"] + counters["requests_rejected"],
          f"loadgen full: the flood's sheds and counters do not add up: "
          f"{row['open_loop_flood']}")
    del model
    return row


def phase_loadgen(card: str, dev: str = "cuda"):
    """The port's load generator on the card (the LOADGEN_* comment): (a)
    its main at the JAX script's defaults and with a random draft (no
    launch), build_spec_engine's trained pair (the SIMT training kernels
    exactly once a layer and step); (b) its three load loops over phase
    serve's full-width engine, lossless, the greedy rows those of direct
    submit, the flood's sheds typed and counted.  Returns (the rows, the
    spec leg's launches)."""
    import torch
    t_start = time.perf_counter()
    rows = _loadgen_cli(card, dev)
    launches = rows["spec"]["launches_loadgen"]
    _zero_counts()
    rows["full"] = _loadgen_full(card, dev)
    full_launches = _read_counts()
    check(not any(full_launches.values()),
          f"loadgen full: kernel launches {full_launches}, want none")
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "loadgen_launches", "launches": launches})
    emit({"phase": "loadgen_wall", "seconds": time.perf_counter() - t_start,
          "card": card})
    return rows, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distkeras_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    smi = phase_device()
    kernel_rows = phase_kernel()
    launches, variants, kept = phase_slice()
    phase_blob(*kept["full"])

    train_rows = phase_kernel_train()
    phase_memory()
    train_runs = phase_train(smi)

    ce_rows = phase_kernel_ce()
    phase_memory_ce()
    plm_launches = phase_parallel_train(smi)

    wide_rows = phase_wide()
    phase_views()
    phase_zoo(smi)
    north_star = phase_adag(smi)
    pack_launches = phase_pack(smi)
    _, decode_launches = phase_decode(smi)
    _, serve_launches = phase_serve(smi)
    _, paged_launches = phase_paged(smi)
    _, spec_launches = phase_spec(smi)
    _, qos_launches = phase_qos(smi)
    _, disagg_launches = phase_disagg(smi)
    _, fleet_launches = phase_fleet(smi)
    host_ps_scaling, host_ps_launches = phase_host_ps(smi)
    _, ps_sparse_launches = phase_ps_sparse(smi)
    _, resilience_launches = phase_resilience(smi)
    _, process_ps_launches = phase_process_ps(smi, host_ps_scaling)
    _, online_launches = phase_online(smi)
    _, moe_launches = phase_moe(smi)
    _, pipeline_launches = phase_pipeline(smi)
    _, spmd_ranks_launches = phase_spmd_ranks(smi)
    _, native_launches = phase_native(smi)
    _, loadgen_launches = phase_loadgen(smi)

    import importlib
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    csrc = "distkeras_tpu_torch/csrc/"
    # each variant with the runs that it serves: the sm90 kernels the main
    # path (bf16), the SIMT kernels the same path in f32
    served = {"sm90": ("/".join(MAIN_PATH), "bfloat16"),
              "simt": (f"{MAIN_PATH[0]}/float32", "float32")}
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // BATCH)
    plm = PLM_ULYSSES_CASE[0]

    def forward_entry(variant):
        """The inference form at the slice's shape (phase kernel), its
        launches on the counted predict of the run it serves."""
        tag, dname = served[variant]
        r, u = kernel_rows[("causal", dname)], kernel_rows[(plm, dname)]
        return {"name": "flash_attention_fwd", "variant": variant,
                "route": "cuda",
                "source": f"{csrc}{fa.FORWARD_VARIANTS[variant]}.cu",
                "replaces": "distkeras_tpu/ops/flash_attention.py:78",
                "dtype": dname, "launches_run": tag,
                "launches": variants[tag][variant],
                "launches_by_path": {p: v[variant]
                                     for p, v in variants.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_term": r["bound_term"],
                "bound_ms_f32_cuda_cores": r["bound_ms_f32_cuda_cores"],
                "bound_ms_split_tf32": r["bound_ms_split_tf32"],
                "library_ms": r["library_ms"],
                "simt_ms": r.get("simt_ms"),
                "parallel_lm": {
                    "shape_bshd": u["shape_bshd"], "ms": u["ms"],
                    "simt_ms": u.get("simt_ms"), "plain_ms": u["plain_ms"],
                    "bound_ms": u["bound_ms"], "bound_term": u["bound_term"],
                    "library_ms": u["library_ms"],
                    "max_abs_err": u["max_abs_err"]}}
    outputs = {"fwd_lse": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    counters = {"fwd_lse": "flash_fwd_lse", "dq": "flash_dq",
                "dkv": "flash_dkv"}

    def train_entry(name, key, replaces, variant):
        """A training kernel's variant at the slice's shape (phase
        kernel_train), its launches on the counted SingleTrainer run of
        the path it serves and, at bf16, on the Ulysses route's counted
        steps.  SDPA's forward is the yardstick of the forward with lse
        (it computes out without returning the lse); no single library
        call computes dq alone or dk/dv alone, so those carry null and the
        SDPA backward (dq, dk and dv together) beside them."""
        tag, dname = served[variant]
        t, u = train_rows[("causal", dname)], train_rows[(plm, dname)]
        errs = outputs[key]
        by_variant = train_runs[tag][f"{key}_by_variant"]
        c_entry = (fa.FORWARD_VARIANTS[variant] if key == "fwd_lse"
                   else fa.BACKWARD_VARIANTS[variant][key])
        entry = {"name": name, "variant": variant, "route": "cuda",
                 "source": f"{csrc}{fa._ENTRIES[c_entry][0]}.cu",
                 "replaces": f"distkeras_tpu/ops/flash_attention.py:"
                             f"{replaces}",
                 "dtype": dname, "launches_run": tag,
                 "launches": by_variant[variant],
                 "launches_by_variant": by_variant,
                 "launches_per_step": by_variant[variant] // steps,
                 "max_abs_err": max(t["max_abs_err"][e] for e in errs),
                 "ms": t["ms"][key],
                 "plain_ms": t["plain_ms"][key],
                 "bound_ms": t["bound_ms"][key],
                 "bound_by": t["bound_by"][key],
                 "bound_term": t["bound_term"][key],
                 "library_ms": (t["library_fwd_ms"] if key == "fwd_lse"
                                else None),
                 "simt_ms": t.get("simt_ms", {}).get(key),
                 # the same kernel at the parallel LM's Ulysses shape
                 "parallel_lm": {
                     "shape_bshd": u["shape_bshd"], "kv_heads": u["kv_heads"],
                     "max_abs_err": max(u["max_abs_err"][e] for e in errs),
                     "ms": u["ms"][key], "plain_ms": u["plain_ms"][key],
                     "simt_ms": u.get("simt_ms", {}).get(key),
                     "bound_ms": u["bound_ms"][key],
                     "bound_by": u["bound_by"][key],
                     "bound_term": u["bound_term"][key],
                     "library_fwd_ms": u["library_fwd_ms"],
                     "library_bwd_ms": u["library_bwd_ms"],
                     "library_bwd_ms_by_backend":
                         u["library_bwd_ms_by_backend"]}}
        for bound in ("bound_ms_f32_cuda_cores", "bound_ms_split_tf32"):
            entry[bound] = t[bound][key]
            entry["parallel_lm"][bound] = u[bound][key]
        if key != "fwd_lse":
            entry["backward_library_ms"] = t["library_bwd_ms"]
            entry["backward_library_ms_by_backend"] = t[
                "library_bwd_ms_by_backend"]
        if dname == "bfloat16":  # its launches on the Ulysses route's steps
            entry["parallel_lm"]["launches"] = plm_launches["fused_ulysses"][
                f"{counters[key]}_{variant}"]
        return entry
    c = ce_rows[("slice", "float32")]  # the parallel LM's logits

    def ce_entry(name, key, replaces, *errs):
        return {"name": name, "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/fused_ce.cu",
                "replaces": f"distkeras_tpu/ops/fused_ce.py:{replaces}",
                # the main path's counted run: the fused ring route's
                # PLM_STEPS steps; every counted route beside it
                "launches": plm_launches["fused_ring"][name],
                "launches_per_step":
                    plm_launches["fused_ring"][name] / PLM_STEPS,
                "launches_by_route": {r: n[name] for r, n in
                                      plm_launches.items()},
                "max_abs_err": max(c["max_abs_err"][e] for e in errs),
                "ms": c["ms"][key], "plain_ms": c["plain_ms"][key],
                "bound_ms": c["bound_ms"][key],
                "bound_by": c["bound_by"][key],
                "library_ms": c["library_ms"][key],
                "bf16_ms": ce_rows[("slice", "bfloat16")]["ms"][key]}

    def wide_entry(name, key, replaces):
        """A SIMT kernel at WIDE_CASE's head dim above 256 (bf16; f32
        beside it): its launches on phase wide's counted drive of
        ``attention`` forward, backward and inference form."""
        w, w32 = wide_rows["bfloat16"], wide_rows["float32"]
        errs = {"fwd": ("inference",), **outputs}[key]
        count = {"fwd": "flash_inference"}.get(key, counters.get(key))
        c_entry = (fa.FORWARD_VARIANTS["simt"] if key in ("fwd", "fwd_lse")
                   else fa.BACKWARD_VARIANTS["simt"][key])
        return {"name": name, "variant": "simt", "route": "cuda",
                "source": f"{csrc}{fa._ENTRIES[c_entry][0]}.cu",
                "replaces": f"distkeras_tpu/ops/flash_attention.py:"
                            f"{replaces}",
                "dtype": "bfloat16", "shape_bshd": w["shape_bshd"],
                "kv_heads": w["kv_heads"],
                "head_dim_chunks": w["head_dim_chunks"],
                "launches_run": f"wide {WIDE_CASE[0]}",
                "launches": w["launches"][f"{count}_simt"],
                "max_abs_err": max(w["max_abs_err"][e] for e in errs),
                "ms": w["ms"][key], "plain_ms": w["plain_ms"][key],
                "bound_ms": w["bound_ms"][key],
                "bound_by": w["bound_by"][key],
                "library_ms": (w["library_fwd_ms"]
                               if key in ("fwd", "fwd_lse") else None),
                "backward_library_ms": w["library_bwd_ms"],
                "bound_ms_f32_cuda_cores": w["bound_ms_f32_cuda_cores"][key],
                "bound_ms_split_tf32": w["bound_ms_split_tf32"][key],
                "float32": {"launches": w32["launches"][f"{count}_simt"],
                            "max_abs_err": max(w32["max_abs_err"][e]
                                               for e in errs),
                            "ms": w32["ms"][key],
                            "plain_ms": w32["plain_ms"][key],
                            "bound_ms": w32["bound_ms"][key],
                            "bound_ms_f32_cuda_cores":
                                w32["bound_ms_f32_cuda_cores"][key],
                            "bound_ms_split_tf32":
                                w32["bound_ms_split_tf32"][key],
                            "library_fwd_ms": w32["library_fwd_ms"],
                            "library_bwd_ms": w32["library_bwd_ms"]}}
    def new_paths(entry):
        """The entry's launches on the packing, decode, serving, paged
        serving, speculative serving, QoS serving, disaggregated serving
        and fleet paths (each counted from 0 over its phase's runs; all
        must be 0), on the host-PS path (phase host_ps's LM leg: the
        sm90 training kernels, once per layer, step and worker), on the
        sparse host-PS path (phase ps_sparse's three LM runs: the sm90
        training kernels once per layer and step of each) and on the
        survivable host-PS path (phase resilience's elastic LM run: the
        sm90 training kernels once per layer, step and window that
        ran) and on the cross-process path (phase process_ps's LM leg,
        summed over its worker processes' result files: the sm90
        training kernels once per layer, step and window each child ran,
        its warm-up included) and on the online path (phase online's two
        stream runs and the engines serving beside them: the sm90
        training kernels once per layer, step and window that ran) and on
        the MoE path (phase moe: (a)'s two runs, B1/B2 once a step and the
        sm90 training kernels once a layer and step, and (b)'s ranks, read
        from their result files: B1/B2 and the SIMT training kernels) and
        on the pipeline path (phase pipeline: (a)'s four runs and (b)'s
        one-rank references, the sm90 training kernels once a layer,
        microbatch and step and under 1F1B the sm90 inference forward as
        often; (b)'s ranks, the same for their one layer; (c)'s ranks,
        B1/B2 once a step and the SIMT training kernels once a layer and
        step) and on the SPMD-ranks path (phase spmd_ranks: (a)'s engines
        none; (b)'s one-device predict and its ranks, the sm90 inference
        forward once a layer and batch of rows; (c)'s dry-run ranks, the
        SIMT kernels of their f32 LMs) and on the native path (phase
        native's two one-worker LM runs: the sm90 training kernels once a
        layer and step of each) and on the load-generator path (phase
        loadgen's build_spec_engine: the SIMT training kernels once a
        layer and step of its target's and its draft's training)."""
        key = {"flash_attention_fwd": "flash_inference",
               "flash_attention_fwd_lse": "flash_fwd_lse",
               "flash_attention_bwd_dq": "flash_dq",
               "flash_attention_bwd_dkv": "flash_dkv"}.get(entry["name"])
        key = (f"{key}_{entry['variant']}" if key is not None
               else entry["name"])
        entry["launches_pack"] = pack_launches[key]
        entry["launches_decode"] = decode_launches[key]
        entry["launches_serve"] = serve_launches[key]
        entry["launches_paged"] = paged_launches[key]
        entry["launches_spec"] = spec_launches[key]
        entry["launches_qos"] = qos_launches[key]
        entry["launches_disagg"] = disagg_launches[key]
        entry["launches_fleet"] = fleet_launches[key]
        entry["launches_host_ps"] = host_ps_launches[key]
        entry["launches_ps_sparse"] = ps_sparse_launches[key]
        entry["launches_resilience"] = resilience_launches[key]
        entry["launches_process_ps"] = process_ps_launches.get(key, 0)
        entry["launches_online"] = online_launches[key]
        entry["launches_moe"] = moe_launches.get(key, 0)
        entry["launches_pipeline"] = pipeline_launches.get(key, 0)
        entry["launches_spmd_ranks"] = spmd_ranks_launches.get(key, 0)
        entry["launches_native"] = native_launches.get(key, 0)
        entry["launches_loadgen"] = loadgen_launches.get(key, 0)
        return entry

    emit(north_star)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": [new_paths(e) for e in [
        forward_entry("sm90"),
        forward_entry("simt"),
        *(train_entry(name, key, replaces, v)
          for name, key, replaces in (
              ("flash_attention_fwd_lse", "fwd_lse", 78),
              ("flash_attention_bwd_dq", "dq", 182),
              ("flash_attention_bwd_dkv", "dkv", 221))
          for v in ("sm90", "simt")),
        ce_entry("fused_ce_fwd", "fwd", 54, "loss", "lse"),
        ce_entry("fused_ce_bwd", "bwd", 97, "dlogits"),
        *(wide_entry(name, key, replaces) for name, key, replaces in (
            ("flash_attention_fwd", "fwd", 78),
            ("flash_attention_fwd_lse", "fwd_lse", 78),
            ("flash_attention_bwd_dq", "dq", 182),
            ("flash_attention_bwd_dkv", "dkv", 221))),
    ]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
