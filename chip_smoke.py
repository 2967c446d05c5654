#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card and
hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --cards    # phase 20 (f) alone, two or more cards

Phases (any failure exits non-zero and prints no result):

1. versions, the card's name and power limit, and the kernels' build with
   ``nvcc`` from ``src/repro_torch/kernels/csrc`` (all four sources at
   once; grouped K4 is ``grouped_matmul.cu``);
2. K1 (quantize_pack) against its plain version, ``torch.equal``: at the
   CNN path's shapes (batch 32), a ragged row in float32 and bf16, and the
   grouped launch the LM makes (one activation, G = 1..4 step sizes,
   float32 and bf16) at stablelm-1.6b's activation shapes (M = 4 and 64 x
   K = 2048 and 5632) and a ragged (13, 70);
3. K2 (bitserial_conv2d) against its plain version at all eight ResNet9
   conv geometries (batch 32) in each step's output mode, a ragged case,
   wider specs and the edges of its tensor-core tiles (pixels and Co off
   the tile, Ci = 33 and 600, batch 1, stride 2, every output mode), exact
   equality (the float mode included: both compute the same FMA of the
   same accumulator);
4. the CNN slice: ``CNNServer`` compiles full-width ResNet9 W2A2 on the
   card through its ``ModelRegistry``, its ``InferenceService`` warms up
   (one CUDA graph captured per padding bucket 1..32, each counting 3 K1
   and 8 K2 launches at capture) and it answers requests of 1, 3 and 32
   images. Launch counts are reset just before and read just after: no
   wrapper runs (a replay calls none, and nothing is captured after the
   warmup), and the launches the graphs ran, the counts at capture times
   the replays, must be 3 (K1) and 8 (K2) per forward. Every answer must
   equal, bit for bit, the same Program's eager forward and its plain
   run on the answer's own micro-batch at its bucket (the micro-batches
   read from the service's trace), and a Program calibrated on a small
   batch must agree on argmax with the plain quantized reference forward;
5. CNN times at batch 32: each kernel (``kernels/timing.py``'s ``Timer``:
   CUDA events around each launch, L2 flushed before each, every
   repetition queued behind a device sleep so that the host's enqueue gap
   is not counted), its plain
   version, the PyTorch library call that does the integer-accumulate part
   where there is one, and the least time the card could take; the
   replayed forward's img/s against the eager forward in turns,
   ``classify`` of 32 images through the service five times, and a
   profiler breakdown of each (one replay of every bucket, 1 to 32, must
   run 3 K1 and 8 K2 by kernel name);
6. K3 (bitserial_matmul_v2) and 7. K4 (bitserial_matmul) against their
   plain versions, ``torch.equal``: stablelm-1.6b's three GEMM shapes at
   M = 4 (decode) and 64 (prefill), W4A8; codes and packed outputs;
   ragged M/K/N; radix 1; W8A8 with unsigned activations; W16A16 whose
   sums wrap int32; K4's requant at 8 and 12 bits; both at the edges of
   their shared tensor-core tile (M = 1, 4, 5, 17, 64 against N = 70,
   K = 100 at W4A8, radix 1, W16A16 and unsigned W8A8);
8. the LM slice: ``Server`` on full-width stablelm-1.6b (24 layers, bf16,
   W4A8, random weights from seed 0) answers four requests (prompts of 5,
   8, 11 and 16 tokens, 16 new tokens each) with counts reset just before
   and read just after: 96 K1 (one per distinct activation: q/k/v share
   one, gate/up another) and 168 K3 launches per prefill and per decode
   step. The tokens and last-step logits must equal the plain
   versions' run on the card, and the K4 path's (``pack_acts=False``,
   counted the same way); a 2-slot server answering one request (a dummy
   slot) must give a 1-slot server's tokens; the smoke config on the card
   must give the CPU's plain-version tokens;
8b. the continuous LM engine: ``ContinuousLMEngine`` on full-width
    stablelm-1.6b (batch_slots 4, max_len 64, seed 0) warms up (one prefill
    per bucket, the insert, the decode step captured once as a CUDA graph:
    96 K1 and 168 K3 counted at capture) and serves the reference CLI's
    mixed load of 16 requests (prompts of 4-16 tokens, every 4th request
    16 new tokens, the others 4), counts reset just before and read just
    after (the wrappers count its 16 prefills; a replay calls no wrapper,
    so the replays add the captured step's launches times the steps run,
    a per-replay count the profiler confirms), with nothing compiled after
    the warmup. Every request's tokens must equal those of the request
    run alone and eagerly at the engine's shapes (its prompt right-padded
    to its bucket and prefilled with ``last_pos``, then decode steps over
    a 4-row cache holding it in every row, all rows alike), and the first
    four those of the engine on the plain versions (``plain=True``, also
    captured) and of the K4 engine (``pack_acts=False``, 168 K4 at
    capture and in one replay's profile, held to its own eager run
    alone). Each request is also served by a 1-slot eager ``Server``
    (batch 1, the prompt unpadded) and the token where the two part, if
    any, is reported with the eager run's gap between its two largest
    logits there: the float parts round by shape on the card. Times: the
    load's tokens/s (a smoke reading) and host time per step; the
    replayed step against the eager ``Server``'s decode step at batch 4
    (host clock, synchronized); one replay under the profiler (wall, busy,
    and its K1/K3 launches by kernel name, which must be 96 and 168);
9. the port's copy of ``tiny_mixed_cnn`` compiled on the card: its
   ``gemm_packed`` step launches K3, and the logits equal the plain
   runner's;
10. LM times: K3 and K4 at each stablelm shape and K1 at each launch a
    layer makes (bf16; G = 3, 1, 2 at K = 2048 and G = 1 at 5632) —
    kernel, plain, bound and the library call for the same integer
    product (``torch._int_mm`` where its shape rules allow, else an fp16
    matmul of the codes) — and their sums over one decode step (M = 4)
    and one prefill (M = 64); K1 at (1, 32), one warp's work, and the
    launch floor under the same timer (``t.zero_()`` on one element); for
    each LM path (K1 + K3 and K4) the prefill, a decode step and
    ``generate``'s tokens/s at batch 4, and a profiler breakdown of one
    prefill and one decode step (device busy counts the card's own events
    only; K1's in-path ms and launches by kernel name, its launches held
    to the wrappers' count);
11. the serving runtime: phase 4's ``CNNServer`` answers 1, 3, 17 and 32
    images and a burst of 64 single-image submits from 4 threads, every
    answer equal to the eager forward and to the plain-version service's
    captured run on its micro-batch at its bucket, nothing captured after
    the warmup and 3 K1 + 8 K2 per replayed forward; a W2A2 and a W2A8
    variant registered together share every packed weight plane on the
    card (equal ``data_ptr``) and both serve exactly; the card Program's
    command stream equals the reference's (``tests/data/
    resnet9_w2a2_stream.json``) job for job, and the scheduler's virtual
    cycles, utilization and HPM counters are printed; phase 8b's engine,
    registered as a callable, serves the CLI's mixed load through
    ``InferenceService`` with the bare engine's tokens, one scheduler
    admission per decode step and nothing compiled after its warmup.
    Written down, not held: the burst's per-request p50/p99 and the LM
    load's tokens/s;
12. deepseek-v2-lite-16b at full width and depth (27 layers: one dense,
    26 MLA + MoE with 64 routed experts top-6 and 2 shared; bf16, W4A8,
    random weights from seed 0 drawn and packed one layer at a time, its
    seconds and peak memory printed): grouped K4 against its plain
    version, ``torch.equal``, at E = 64 with C = 1, 2 and 8 at (K, N) =
    (2048, 1408) and (1408, 2048), a ragged E = 3, C = 5, 100 -> 70, at
    W4A8, radix 1 and unsigned W8A8, and with rows that are all zero at
    each of those plans: the experts a seeded (4, 6) routing's
    ``moe.dispatch`` fills at C = 1 (the rest zero), C = 2 with one row of
    each expert zero, C = 8 with two experts in three zero, an all-zero
    input; ``Server`` answers the four requests
    of phase 8 (prompts from the model's vocabulary), counts reset just
    before and read just after: 108 K1, 162 K3 and 78 grouped K4 per
    prefill and per decode step (4 K1 and 6 K3 a layer, 3 grouped K4 a
    MoE layer), tokens and last-step logits equal to the plain versions'
    run on the card over ``DS_PLAIN_NEW`` (8) new tokens, the smoke
    config's tokens on the card equal to the
    CPU's; ``ContinuousLMEngine`` warms up (the decode step captured once,
    those launches counted at capture) and serves the CLI's mixed load of
    16 requests with nothing compiled after the warmup, tokens and every
    step's drop fractions equal, bit for bit, to the same engine stepping
    eagerly on the same load (the MoE capacity couples an arena's rows, so
    a request is held on its own load, not alone); the plain versions'
    engine gives the graphed engine's tokens on the first four requests
    (at most 8 new tokens each);
    one replay's K1, K3 and grouped K4 launches by kernel name equal the
    capture's; the load through ``InferenceService`` (one micro-batch)
    gives the bare engine's tokens. Written down, not held: grouped K4's
    cold time, bound and an fp16 ``bmm`` of the codes per launch and per
    decode step, with every expert's row nonzero and at the dispatch's
    occupancy (each with its own bound: the occupied experts' bytes), the
    experts a replayed step's dispatch fills per MoE layer (an eager step
    on a copy of the arena, outside the graph), grouped K4's in-path ms,
    the prefill, the eager and replayed decode step (wall,
    busy) against the step's weight-byte bound, the load's tokens/s, each
    step's drop fraction, and each request served alone in an empty arena
    against its mixed-load tokens;
13. the toolchain (full-width ResNet9, seed 0, a temporary store): (a) a
    ``ModelRegistry(store=)`` compiles W2A2 and W2A8 once, saved and
    tagged, the planes they share stored once (compile seconds and the
    store's counts printed); (b) a fresh registry and
    ``InferenceService`` on the same store ``warm_boot()``: both restored,
    0 compiles, 12 bucket graphs captured over the loaded tensors (shared
    planes one tensor on the card); ``CNNServer(store=, artifact=
    "resnet9_cifar10@W2A2")`` answers 1, 17 and 32 images and the
    warm-booted service both variants, every answer equal bit for bit to
    (a)'s Program at its bucket, launches = capture counts x replays;
    ``load_program``'s ms and the warm boot's seconds printed; (c) a
    flipped byte in a plane blob and a manifest edited and re-digested
    both raise ``ArtifactError``; (d) ``profile_program`` at batch 32 and
    1 (CUDA events around 20 calls, best of 5): each step launches once
    per call what its kind runs (K1 per ``quantize_pack``/``pack_codes``,
    K2 per ``conv_packed``, by the wrappers' counts and by kernel name),
    each step's µs, predicted cycles and H100 roofline printed, and the
    sum of the steps beside phase 5's replay (reported, not held); (e)
    the ns-per-cycle fits, the batch-1 fit saved, loaded back equal and
    attached to (b)'s scheduler, its predicted wall time for a batch-1 and
    a batch-32 request beside the measured replay; (f) the CLI's
    ``compile`` twice (compiled, then a store hit) and ``profile
    --store`` in subprocesses, the calibration persisted;
14. training (:func:`train_phase`): (a) ``Trainer`` on full-width,
    full-depth stablelm-1.6b (24 layers, bf16 compute, float32 params,
    W4A8 ``qat``, remat ``"nothing"``, batch 8, seq 64, seed 0; AdamW lr
    3e-4, warmup 2, 8 steps) without a checkpoint directory: every loss
    and grad norm finite, every float leaf of the state moved (the LSQ
    step sizes included); printed: the losses, ms per synchronized step
    from step 2, training tokens/s, peak memory, one profiled step's busy
    time, kernel count and largest kernels, one step split into its
    forward, backward and AdamW (the step's own profiler ranges,
    :func:`range_split`: host-issued against done on the card), the bf16 FLOP bound (8 N tokens at 989 TFLOP/s) and
    the optimizer's byte bound (28 B per param at 3.35 TB/s); (c) ``pack_params`` of the trained state and ``loss_fn`` on the
    held-out ``SyntheticLM.batch(10_001, 8)`` through K1 + K3 (96 and 168
    launches, counts reset just before and read just after) equal bit for
    bit to the plain versions', the fake-quant and integer CE and their
    gap printed; (d) ``Server`` on the trained weights: phase 8's four
    requests, 96 K1 + 168 K3 per step, tokens and last-step logits equal
    to the plain run's; ``Server(quantized=False)``'s token agreement
    printed; ``ContinuousLMEngine(quantized=False)`` at the smoke config,
    its float decode step a CUDA graph, gives the CPU's tokens; (b) a
    supervised 4-step run of the same config cut to 2 layers (every width
    kept; a temporary checkpoint directory, ``max_to_keep=1``, the free
    disk printed first), ``save_every=2``, a failure injected at step 3,
    equals an uninterrupted run's losses and final state bit for bit;
    printed: bytes written and the seconds in save, in waits on the
    writes and in restore;
15. the SSM and hybrid families (:func:`ssm_phase`): K1 (bf16, G as the
    layers launch it), K3 and K4 at every projection shape of
    mamba2-780m and hymba-1.5b (N = 6448 and 6482 among them) at M = 4
    and 64 against their plain versions, ``torch.equal``, K3 and K4 cold
    at M = 4 beside their bound; ``ssd_chunked`` against ``ssd_scan_ref``
    on the card at one mamba2 layer's full width (B 4, S 600, H 48, P 64,
    N 128) within ``tests/test_models_consistency.py``'s rtol 2e-4 / atol
    2e-5. Then each model at full width and a quarter of its depth
    (``SSM_DEPTH``; phase 18 serves both at full depth), bf16, W4A8,
    random weights from seed 0, through ``Server`` (batch_slots 4):
    mamba2-780m (12 of 48 SSM
    layers, tied embeddings) at max_len 1024 on four requests of 5, 8, 11
    and 16 tokens and on four of 5, 8, 11 and 600 (a 3-chunk left-padded
    scan), 16 new tokens each; hymba-1.5b (8 of 32 hybrid layers, global
    0, window 1024) at max_len 64 on four requests of 5-16 tokens, 16
    new, and at max_len 1280 on four of 1030-1100 tokens, 8 new (the
    prefill cuts the window, every decode step rolls). Counts reset just
    before and read just after each run: per prefill and per decode step
    48 K1 + 48 K3 (mamba2: in_proj and out_proj) and 96 K1 + 144 K3
    (hymba: 6 K1 a layer, q/k/v and gate/up sharing one each, and 9 K3),
    held again on one prefill and one decode step; tokens and last-step
    logits equal, exactly, the plain versions' run on the card; the K4
    path (``pack_acts=False``, 48 and 144 K4 a step) equals the
    K1 + K3 path and, in each model's first run, its own plain run; the
    smoke config on the card gives the CPU's plain-version tokens. Times per model and path
    (written down, not held): prefill, eager decode step, ``generate``'s
    tokens/s, one profiled prefill and decode step (wall, busy, K1 and K3
    or K4 in-path ms and launches by kernel name, held to the wrappers',
    and the share of busy time launched inside the ``ssm.scan`` and
    ``ssm.conv`` profiler ranges), and the decode step's weight-byte
    bound, also with the SSM state's reads and writes;
16. the reference's six remaining architectures (:func:`families_phase`):
    K1 (bf16, each (K, G) the six launch), K3 and K4 at each new (K, N)
    (qwen1.5-110b's 8192 x 49152 MLP and its q and k/v with a nonzero
    bias, command-r-plus-104b's, nemotron-4-15b's and
    seamless-m4t-large-v2's MLPs) at M = 4 and 64, and grouped K4 at
    qwen3-moe-235b-a22b's 128 experts (C = 1 with every expert's row
    nonzero and at a seeded routing's occupancy, C = 5), each against its
    plain version, ``torch.equal``, and timed cold beside its bound,
    its plain version and an fp16 matmul. Then each model, every width
    as published, bf16, W4A8, random weights from seed 0 with every bias
    set to seeded nonzero values: (a) at 2 layers (seamless: all 24 +
    24), the four requests of phase 8, 16 new tokens each, through
    ``Server`` (seamless: ``prefill`` + ``decode_step`` with seeded
    ``src_embeds`` (4, 64, 1024), which ``generate`` does not feed): the
    kernels' tokens and last-step logits equal, exactly, the plain
    versions' run on the card, the K4 path's equal K1 + K3's, and for
    internvl2-76b also with seeded ``frontend_embeds`` (4, 256, 3200);
    (b) at a quarter of the depth 80 GB holds, for the script's time
    limit (``FAMILY_DEPTH``: qwen1.5-110b and internvl2-76b 20 of 80
    layers, command-r 12 of 64, qwen3-moe 10 of 94; nemotron and seamless
    full; earlier the full depth that fits, 80, 48, 40, then half of it),
    the same requests, counts
    reset just before and read just after, each kernel's launches equal
    to :func:`family_launches`' per prefill and decode step, the K4
    path's tokens and logits equal K1 + K3's; internvl2-76b's frontend
    prefill; ``ContinuousLMEngine`` on the CLI's mixed load for
    qwen1.5-110b and qwen3-moe-235b-a22b, its decode step captured once,
    its tokens equal to the same engine stepping eagerly on the same
    load. Written down, not held: drawing and packing seconds, peak
    memory, prefill, eager decode step, one profiled decode step (busy,
    K1/K3/grouped K4 in path by kernel name, held to the wrappers'
    counts) against its weight-byte bound, tokens/s, the engine's replay
    (wall, busy).

17. the long-context cells (:func:`longctx_phase`), each through
    ``launch/dryrun.py``'s ``run_cell(..., run=True)``, every width as
    published, random weights from seed 0: (a) every (architecture x
    shape) cell of the ten accounted on the meta device (decode cells with
    a bf16 and an int8 cache), a table of bytes, bytes per row and rows
    that fit; (b) ``chunked_attention`` against ``_sdpa_full`` on the
    card at 1 x 4,096 x 32 heads x 64 in float32, within rtol 1e-4 / atol
    1e-5; (c) stablelm-1.6b ``prefill_32k`` at batch 1 (32,768 tokens,
    chunked): at 2 layers the kernels' last-position tokens and logits
    equal the plain versions', then 24 layers, 96 K1 + 168 K3 at M =
    32,768; (d) ``decode_32k``: ``Server(batch_slots=4, max_len=32768)``
    on phase 8's four requests with a bf16 and an int8 cache (96 K1 + 168
    K3 per step, one step profiled, the int8 tokens' agreement with bf16
    reported, not held), and ``ContinuousLMEngine`` on an int8 cache with
    a chunked prefill, its captured graph's tokens equal to its eager
    steps'; (e) ``train_4k``: one step at 1 x 4,096, chunked under remat,
    the loss finite and every leaf moved, peak memory; (f)
    deepseek-v2-lite-16b ``prefill_32k``: grouped K4 at C = 3,840 rows
    per expert against its plain version, ``torch.equal``, timed beside
    its bound, the kernels against the plain versions at 2 layers, then
    27 layers (108 K1, 162 K3, 78 grouped K4); (g) hymba-1.5b
    ``long_500k``: ``Server(batch_slots=1, max_len=524288)`` with a bf16
    and an int8 cache (3 global layers of 524,288 slots, 29 rolling of
    1,024), each held to the plain versions at 2 layers, then 32 layers,
    192 K1 + 288 K3 per step.
18. training every family the reference trains (:func:`train_families_phase`),
    every width as published, bf16 compute, float32 params, W4A8 ``qat``,
    random weights from seed 0, AdamW lr 3e-4, warmup 2; no training step
    launches a kernel (counts reset just before and read just after): (a)
    mamba2-780m, 48 layers: two identical forward-backward passes give
    equal losses and gradients bit for bit, then ``Trainer`` (donated
    steps, remat ``"nothing"``) at 8 x 64 for 8 steps: every loss and grad
    norm finite, every float leaf moved (the LSQ step sizes included);
    printed: ms per synchronized step from step 2, tokens/s, peak memory,
    one profiled step split into ``train_step.{forward,backward,adamw}``
    and the ``ssm.scan`` range's share (:func:`range_split`); then
    ``pack_params`` of the trained state and ``loss_fn`` on
    ``SyntheticLM.batch(10_001, 8)`` through K1 + K3 (96 + 96 launches)
    equal bit for bit to the plain versions', the CE gap printed; then
    ``Server`` on the trained weights with phase 8's four requests (from
    the model's vocabulary), tokens and last-step logits equal to the
    plain run's (96 K1 + 96 K3 per step); (b) hymba-1.5b, 32 layers, the
    same (192 K1 + 288 K3 per forward and step); (c) internvl2-76b at 2 of
    80 layers, every width kept: a donated ``make_train_step`` on 4 rows
    of 256 seeded patches (``frontend_proj`` 3,200 -> 8,192) and 64
    tokens, loss finite, every leaf moved (``frontend_proj`` included),
    the packed evaluation with the patches through K1 + K3 equal to the
    plain versions', then ``Trainer`` text-only for 2 steps; (d)
    seamless-m4t-large-v2, 24 + 24 layers: ``Trainer`` raises
    ``ValueError``; ``make_train_step`` on seeded ``src_embeds`` (8 x 64 x
    1,024) and 8 x 64 tokens, loss finite, every leaf of encoder and
    decoder moved, the packed evaluation with the source equal to the
    plain versions'; (e) ``train_4k`` through ``dryrun.run_cell(...,
    run=True)`` at 1 x 4,096, chunked: mamba2, hymba and seamless under
    ``"nothing"``, stablelm and mamba2 also under ``"dots"``, each loss
    finite and every leaf moved, step seconds and peak printed, the
    ``"dots"`` params equal to ``"nothing"``'s bit for bit; (f) mamba2 at 2
    layers of full width: a supervised 4-step run (``save_every=2``, a
    failure injected at step 3) equals an uninterrupted run's losses and
    final state bit for bit, and that run's donated steps equal the same
    steps run out of place.
19. array scaling (:func:`array_phase`): full-width ResNet9 W2A2 on four
    MVU banks of the one card, each bank a CUDA stream of ``cuda:0``: (a)
    ``ShardedProgram`` at batch 32 (8 rows a bank; 12 K1 + 32 K2), run
    twice: each bank's rows equal a single-bank forward of them at bucket
    8 and the plain versions', the two runs equal; against one forward
    of all 32 rows the rows that differ and the largest logit gap are
    reported (the float parts round by shape); (b) ``PipelinedProgram`` at
    2 and 4 stages on 4 microbatches of 8 (stages on consecutive banks,
    hops as event waits): equal to the single-bank forwards; (c)
    ``CNNServer(n_banks=4)`` under ``"banked"`` and ``"sharded"`` with a
    W2A2 and a W4A8 variant: warmup captures one graph per (bank, bucket),
    each with 3 K1 + 8 K2; two bursts of 120 requests (sizes 1 to 32,
    both variants), counts reset just before and read just after (no
    wrapper runs; the graphs' launches are capture counts times
    replays); every answer equals its micro-batch's single-bank forward
    (sharded: each shard's at the shard's batch), nothing is captured
    after warmup, every bank has requests and utilization > 0.01; (d)
    img/s at batch 32 on one bank against four, banked and sharded (8
    batches a run, in turns, inputs from pinned memory), host wall and
    the profiler's busy time, the kernels' summed time and how long
    kernels of different streams ran at once; (e) one MoE layer at
    deepseek-v2-lite's widths (64 experts top-6, 2 shared, 64 tokens,
    random weights from seed 0) with ``relu2`` and then ``gelu`` experts,
    ``n_groups`` 1 and 2: 2 grouped K4 launches a layer (with 2 K1 + 2 K3
    for the shared experts), equal to the plain versions; (f) ``gpipe``
    over 4 banks on a 24-layer float32 stack at d = 2,048 (32 rows, 4
    microbatches, TF32 off): within rtol 2e-4 / atol 2e-5 of the
    sequential stack.

20. one model's tensors on a data x model mesh (:func:`mesh_phase`;
    ``distributed/sharding.py`` on DTensor): (a) full-width stablelm-1.6b
    (24 layers, float32 compute, W4A8 ``qat``, batch 8, seq 64, seed 0;
    AdamW lr 3e-4, warmup 2) for 3 ``Trainer`` steps unsharded, then on a
    (data 1, model 1) mesh of this card (an NCCL group of one rank in
    this process, ``make_local_mesh``): every param a DTensor placed by
    ``param_pspec``; losses, CE, lr, grad norms and every final param
    equal the unsharded run's bit for bit; step ms, peak memory and one
    more mesh step profiled (busy ms, split into forward, backward and
    AdamW) and each part's seconds printed; (b) ``pack_params`` of the
    mesh run's placed params, packed once (gathered, packed, placed again
    by ``param_pspec``): the held-out batch's integer loss through K1 + K3
    on the mesh (``layers._placed_qdense``: each rank's planes, the
    row-parallel projections in K3's accumulator mode, their int32 sums
    all-reduced before one plain epilogue) equals the same planes'
    gathered loss bit for bit (96 + 168 launches each, counts reset just
    before and read just after); (d) ``Server(mesh=)`` on that (1, 1)
    mesh, full-width stablelm-1.6b (24 layers, bf16, W4A8) drawn placed
    from seed 0 (phase 8's draw), phase 8's four requests (16 new
    tokens), K1 + K3 and K4: 96 K1 + 168 K3 (168 K4) a step, tokens and
    last-step logits equal phase 8's unsharded ``Server``'s bit for bit;
    its decode steps timed beside an unsharded ``Server`` on the same
    planes; so are deepseek-v2-lite-16b (phase 12's) and the SSM, hybrid
    and encoder-decoder families (:func:`mesh_serve_families`: mamba2 at
    12 and hymba at 8 layers on phase 15's run 1, seamless FULL on phase
    16's seeded source, 8 new tokens, each equal to an unsharded
    ``Server`` drawn from seed 0, with its launches a step); and the
    continuous engine on the mesh (:func:`mesh_engine`):
    ``ContinuousLMEngine(mesh=)`` of stablelm-1.6b on phase 8b's mixed
    load and of deepseek-v2-lite-16b on phase 12's, K1 + K3 (+ grouped
    K4), its decode step captured as one CUDA graph with the mesh's
    collectives inside, the launches counted at its capture and seen in
    one profiled replay equal to the unsharded engine's, its tokens equal
    to the unsharded captured engine's bit for bit; its replay (wall,
    busy, NCCL kernels), the eager mesh step and the load's tok/s beside
    an unsharded engine on the same planes; (e) the
    split arithmetic on this card at stablelm's three projection shapes,
    M = 4 and 64: K3 and K4 in accumulator mode (``raw_acc``) equal
    their plain accumulators, K split in 2 and 4 word ranges (int32 sum,
    plain epilogue) and N split in 2 and 4 column ranges equal the fused
    whole bit for bit, and so do mamba2's and hymba's in_proj at their
    odd per-rank column counts; (d) and (e)'s seconds
    printed; the group is destroyed; (c) with two or
    more cards only: one rank a card over NCCL (``run_ranks``), the same
    3 steps on (data 2, model n/2) or (data 1, model n), each card's peak
    and state bytes printed; the losses of the config without fake
    quantization (mode ``none``) and its grad norms within rtol 1e-4 of
    an unsharded run's of it; the ``qat`` losses beside (a)'s, reported:
    LSQ's rounding flips activation codes where the mesh's sums round
    otherwise, and 24 layers amplify it. Each rank traces one more float
    step under ``launch/hlo_analysis.py``'s ``CostMode``: its collective
    counts and bytes by kind must equal those of the same step counted on
    rank 0 of a fake (data, model) mesh in this process (state and batch
    on ``meta``); (f) with two or more cards only: ``run_ranks``, one rank
    a card, ``Server(mesh=)`` on (data 1, model n) and (data 2, model
    n/2) serving (d)'s requests on stablelm-1.6b drawn placed from seed 0:
    rank 0's tokens and last logits equal (d)'s bit for bit (the kv heads
    split), 96 K1 + 168 K3 a step on each rank; on (1, n) also
    qwen1.5-110b at its full 80 layers, for ``PERF.md``: its decode
    steps' wall, one profiled step's busy ms, each card's bytes, and the
    families: mamba2 and seamless as (d) serves them, equal to the
    unsharded ``Server`` bit for bit, and hymba with one prompt of 1,030
    tokens past its 1,024-slot window (whose slots the 4 cards split,
    256 a card) within rtol 1e-5 / atol 1e-6, tokens equal. The launch
    counts are reset just before each rank's ``generate`` and read just
    after. Each rank first runs the engine on the mesh (stablelm on
    (1, n) and (2, n/2), deepseek on (1, n)) on (d)'s mixed loads: its
    decode step one CUDA graph on every rank with the NCCL collectives
    inside, the unsharded engine's launches at capture (one profiled
    replay's reported), every rank's tokens equal to the unsharded
    captured engine's. ``--cards`` runs (f) alone (:func:`cards_main`).
21. the cost analysis (:func:`cost_phase`; ``launch/hlo_analysis.py``):
    (a) full-width stablelm-1.6b (24 layers, bf16, W4A8, K1 + K3, random
    weights from seed 0) through ``Server``'s params: one eager
    ``prefill`` of 4 x 64 seeded tokens (max_len 72) and one eager
    ``decode_step`` at batch 4, and phase 4's ResNet9 W2A2 Program: one
    eager batch-32 forward (3 K1 + 8 K2), each under ``CostMode`` on the
    card, counts reset just before and read just after: its record
    (FLOPs, integer and logical FLOPs, HBM bytes, collectives, kernel
    calls, the ATen ops by name) equals the same call's on the ``meta``
    device field for field, and its kernel calls equal the wrappers'
    counts (96 K1 + 168 K3 a stablelm step) and, in a profiler window of
    the call with no mode active, the launches by kernel name; (b) that
    window's busy time against the record: ``flops_int`` over busy
    against ``obs/profiler.py``'s ``PEAK_INT8``, the float FLOPs against
    ``PEAK_BF16``, ``bytes_hbm`` against ``HBM_BW``, printed beside the
    card's name and power limit; (c) ``dryrun.cost_cell`` of stablelm-1.6b
    ``train_4k`` at 2 layers on a fake 16 x 16 mesh in this process (the
    card's torch): nonzero FLOPs, all-gathers and all-reduces; and of
    its ``decode_32k`` cell at 2 layers there: a sharded ``Server``'s
    step, ``cost_mesh`` (16, 16), K3's 14 calls on each rank's planes,
    at least 2 all-reduces a layer (the row-parallel int32 sums).
22. the tile autotuner (:func:`tuning_phase`; ``kernels/tuning.py``):
    (a) at ResNet9 W2A2's eight convs (batch 1 and 32) and stablelm-1.6b
    W4A8's distinct projections read from its config (M = 4, 256 and
    32,768; K3 and K4), every candidate tile equals the plain version
    (``torch.equal``), and the heuristic's, the analytic and the measured
    re-rank's tiles are timed cold (``Timer``), the analytic choice's
    ratio to the heuristic reported, not held; (b) phase 4's tuned
    ResNet9 Program's bucket graphs (1, 8, 32) and the same Program with
    its tiles removed each equal the plain runner, their replays timed in
    turns, and a full-width stablelm decode step at batch 4 (168 K3)
    equals the plain versions' logits; (c) a service warm-booted from a
    store the phase populated enumerates no tile (0 compiles, the
    decisions read back); (d) tiles no instantiation takes raise at
    launch.

The ``kernels`` JSON line gives, per kernel, its launches on the main
paths (the bucketed runners' forwards and the engine's loads included:
wrapper counts plus each captured graph's launches times the replays run,
captures left out)
and its times summed over one ResNet9 batch-32 forward plus one LM
decode step at batch 4; K1's entry adds its in-path profiler ms and
launches per decode step and per prefill; K1, K3 and K4 add the engine's
launches per captured decode step, as its ``stats()`` reports them. K1's
and K3's launches include deepseek-v2-lite's (phase 12: ``Server``, the
engine's load and the service's), phase 14's (the packed evaluation
and the trained weights' ``Server``), phase 15's and 16's (the
families' runs; K4's and grouped K4's too) and phase 17's (the long-context
cells; grouped K4's too) and phase 18's (the trained families' packed
evaluations and ``Server`` runs) and phase 20's (the placed packing's
evaluations on the mesh and gathered, (d)'s sharded and unsharded
``Server`` runs, K4's too, and (d)'s engines on the mesh and unsharded,
grouped K4's too) and phase 21's (its counted and
profiled calls; K2's too) and phase 22's (the tuned bucket graphs'
replays and the decode step; K2's too; K2, K3 and K4 add the tiles
phase 22 held, ``tiles_held``); K1's and K2's include phase 13's
(the warm-booted graphs' replays and the profiler's calls) and phase 19's
(the sharded and pipelined Programs and the four-bank services' bursts;
K1's, K3's and grouped K4's also its MoE layers); the grouped K4 entry
gives its launches there and its times summed over one deepseek decode
step.

Standard output ends with the ``kernels`` JSON line, the card's
``nvidia-smi`` name/power line and the ``{"ok": true, ...}`` line; the full
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks (NVIDIA data sheet, dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

B = 32  # the main path's batch for shapes and times
WINDOW_TRIES = 3   # profiler windows opened for one call, at most


# the LM slice: stablelm-1.6b at batch 4, prompts of these lengths
LM_PROMPTS = (5, 8, 11, 16)
LM_NEW = 16        # new tokens per request: one prefill + 15 decode steps
LM_MAX_LEN = 64
# new tokens over which phase 12 holds deepseek's kernels against the plain
# versions (Server and engine): a plain decode step takes about 3.7 s on
# the card (every expert's plain GEMM), and 16 tokens left the script too
# little room under its time limit on a slow host
DS_PLAIN_NEW = 8
# (K, N) of stablelm-1.6b's projections: q/k/v/o, gate/up, down, and how
# many of each a layer runs
STABLELM_GEMMS = ((2048, 2048), (2048, 5632), (5632, 2048))
GEMMS_PER_LAYER = (4, 2, 1)
# the K1 launches a layer makes, one per distinct activation: (K, G step
# sizes) for q/k/v, o, gate/up and down
K1_PER_LAYER = ((2048, 3), (2048, 1), (2048, 2), (5632, 1))

# (name, c_in, c_out, stride, H_in, output mode) of ResNet9's conv1..conv8
RESNET9_CONVS = (
    ("conv1", 64, 64, 1, 32, "packed"),
    ("conv2", 64, 64, 1, 32, "packed"),
    ("conv3", 64, 128, 2, 32, "packed"),
    ("conv4", 128, 128, 1, 16, "codes"),
    ("conv5", 128, 256, 2, 8, "packed"),
    ("conv6", 256, 256, 1, 4, "codes"),
    ("conv7", 256, 512, 2, 2, "packed"),
    ("conv8", 512, 512, 1, 1, "float"),
)


def log(*a):
    print(*a, flush=True)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def tree_to(tree, device):
    """A parameter tree (dicts, lists, tensors) with every tensor moved."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def n_alphas(tree):
    """The LSQ step-size leaves (``alpha_*``) of a parameter tree."""
    if isinstance(tree, dict):
        return sum(1 if k.startswith("alpha") else n_alphas(v)
                   for k, v in tree.items())
    return sum(n_alphas(v) for v in tree) if isinstance(tree, list) else 0


def card_records(prof):
    """``(name, duration ns)`` of every record the card itself made in a
    profiler window (kernels, copies, sets; not the ``record_function``
    ranges the trace also draws on the card's timeline), read from the
    trace's events without building ``key_averages``' event tree."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def range_split(prof, names):
    """The profiled call's named ``record_function`` ranges, ms each:
    ``issued``, the host's time inside the range; ``done``, from the
    range's start until the card ended the last kernel, copy or set
    launched from inside it (on any host thread: the backward launches
    from autograd's); ``busy``, the card's own time for those. A launch
    belongs to a range when its runtime call starts inside the range's
    host window; the card's events are matched to it by correlation id.
    A range that ran more than once (once a layer) sums its ``windows``:
    ``issued`` and ``busy`` over all of them, ``done`` from the first."""
    import bisect
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    host, launched = {}, []
    for e in evs:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in names:
            host.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        elif e.correlation_id() > 0 and e.name().startswith(("cuda", "cu")):
            launched.append((e.start_ns(), e.correlation_id()))
    on_card = {e.correlation_id(): e for e in evs
               if e.device_type() == DeviceType.CUDA
               and e.name() not in names}
    out = {}
    for name in names:
        if name not in host:
            raise AssertionError(f"the profiler recorded no range {name}")
        wins = sorted(host[name])
        starts = [a for a, _ in wins]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= wins[i][1]

        mine = [on_card[c] for t, c in launched
                if c in on_card and inside(t)]
        if not mine:
            raise AssertionError(f"no device event launched in {name}")
        out[name] = {"issued": sum(b - a for a, b in wins) / 1e6,
                     "done": (max(e.end_ns() for e in mine)
                              - wins[0][0]) / 1e6,
                     "busy": sum(e.duration_ns() for e in mine) / 1e6,
                     "events": len(mine), "windows": len(wins)}
    return out


def train_phase(dev, cfg, counts, reset_counts, device_profile, prompts):
    """Phase 14: LSQ quantization-aware training of ``cfg`` (stablelm-1.6b
    FULL) on ``dev``, then the trained weights on the packed path. Returns
    its record; raises on any failure."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.serve import GenRequest, Server
    from repro_torch.launch.train import Trainer, make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serving import ContinuousLMEngine

    t_phase = time.perf_counter()
    out = {"held_gb_at_start": torch.cuda.memory_allocated() / 1e9}
    log(f"  {out['held_gb_at_start']:.2f} GB held on the card before the "
        f"phase")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    batch, seq, steps = 8, 64, 8
    tokens = batch * seq
    if not (cfg.remat and cfg.remat_policy == "nothing"
            and cfg.policy.mode == "qat"):
        raise AssertionError(f"training config {cfg}")

    # (a) full width, full depth: 8 steps, the unsupervised path
    log(f"training: Trainer(stablelm-1.6b FULL, {cfg.n_layers} layers, bf16 "
        f"compute, float32 params, W4A8 qat, remat 'nothing', batch {batch}, "
        f"seq {seq}, seed 0), AdamW lr 3e-4, warmup 2, 8 steps")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, opt_cfg=opt, batch_size=batch, seq_len=seq,
                      seed=0, device=dev)
    t0 = time.perf_counter()
    state, losses = trainer.run(steps, log_every=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    hist = trainer.history
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    gnorms = [h["grad_norm"] for h in hist]
    if len(losses) != steps or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"training: losses {losses} grad norms {gnorms}")
    init = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    still = [i for i, (a, b) in enumerate(zip(tree_leaves(state["params"]),
                                              tree_leaves(init)))
             if torch.equal(a, b)]
    still += [f"{k}{i}" for k in ("m", "v")
              for i, t in enumerate(tree_leaves(state["opt"][k]))
              if not bool(t.any())]
    del init
    if still or int(state["opt"]["step"]) != steps:
        raise AssertionError(f"training: leaves that did not move {still}")

    step_ms = [h["seconds"] * 1e3 for h in hist[2:]]
    med_ms = statistics.median(step_ms)
    flop_bound_ms = 8 * n_params * tokens / BF16_OPS_PER_S * 1e3
    opt_bound_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    step_fn = make_train_step(cfg, opt)
    pbatch = trainer.device_batch(trainer.data.batch(steps, batch))
    parts = ("train_step.forward", "train_step.backward", "train_step.adamw")
    prof = device_profile(lambda: step_fn(state, pbatch), ranges=parts)
    split = {k.split(".")[1]: v for k, v in prof["ranges"].items()}
    out["a"] = dict(
        n_params=n_params, losses=losses, grad_norms=gnorms,
        lr=[h["lr"] for h in hist], step_ms=[h["seconds"] * 1e3 for h in hist],
        step_ms_median_from_2=med_ms, tokens_per_s=tokens / (med_ms / 1e3),
        run_s=run_s, peak_gb=peak_gb,
        flop_bound_ms=flop_bound_ms, opt_bound_ms=opt_bound_ms,
        profiled_step=prof, split_ms=split)
    log(f"  {n_params / 1e9:.4f} B params; losses "
        + " ".join(f"{l:.4f}" for l in losses))
    log(f"  grad norms " + " ".join(f"{g:.3f}" for g in gnorms)
        + f"; every float leaf moved ({n_alphas(state['params'])} LSQ "
        f"step-size leaves among them), optimizer step {int(state['opt']['step'])}")
    log(f"  step (synchronized) from step 2: median {med_ms:.1f} ms "
        f"(" + " ".join(f"{t:.1f}" for t in step_ms) + f"); "
        f"{tokens / (med_ms / 1e3):.0f} training tokens/s; peak "
        f"{peak_gb:.2f} GB above what was held before; {run_s:.1f} s for "
        f"the 8 steps with init")
    log(f"  one profiled step: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['device_ms']:.1f} ms over {prof['kernels']:.0f} kernels; "
        f"bounds: bf16 FLOPs (8 N tokens at "
        f"989 TFLOP/s) {flop_bound_ms:.2f} ms, optimizer bytes (28 B per "
        f"param at 3.35 TB/s) {opt_bound_ms:.2f} ms")
    for name, ms_ in prof["by_name_ms"].items():
        log(f"    {ms_:8.2f} ms  x{prof['launches'][name]:5.0f}  {name[:90]}")
    log("  the profiled step in its parts (ms from each part's start: "
        "issued on the host, done on the card; the card's busy ms): "
        + "; ".join(f"{k} issued {v['issued']:.1f}, done {v['done']:.1f}, "
                    f"busy {v['busy']:.1f} over {v['events']} events"
                    for k, v in split.items()))

    # (c) export and integer evaluation on a held-out batch
    scfg = transformer.serve_policy(cfg, pack_acts=True)
    t0 = time.perf_counter()
    packed = transformer.pack_params(state["params"], scfg)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    hb = trainer.device_batch(trainer.data.batch(10_001, batch))
    k1_fwd, k3_fwd = 4 * cfg.n_layers, 7 * cfg.n_layers
    with torch.no_grad():
        reset_counts()
        l_q, aux_q = transformer.loss_fn(packed, hb, scfg)
        torch.cuda.synchronize()
        c_q = counts()
        reset_counts()
        l_p, aux_p = transformer.loss_fn(
            packed, hb, transformer.serve_policy(scfg, plain=True))
        torch.cuda.synchronize()
        c_p = counts()
        l_f, aux_f = transformer.loss_fn(state["params"], hb, cfg)
    want = {"K1": k1_fwd, "K2": 0, "K3": k3_fwd, "K4": 0, "K4g": 0}
    if c_q != want or any(c_p.values()):
        raise AssertionError(f"packed eval launches {c_q} (want {want}), "
                             f"plain {c_p}")
    if not torch.equal(l_q, l_p) or not torch.equal(aux_q["ce"],
                                                    aux_p["ce"]):
        raise AssertionError(f"packed eval loss {float(l_q)!r} vs plain "
                             f"{float(l_p)!r}")
    ce_f, ce_q = float(aux_f["ce"]), float(aux_q["ce"])
    out["c"] = dict(pack_s=pack_s, launches=c_q, ce_fake_quant=ce_f,
                    ce_integer=ce_q, gap=ce_q - ce_f)
    log(f"  export: pack_params in {pack_s:.2f} s; held-out batch "
        f"(SyntheticLM.batch(10_001, 8)): integer loss through K1 + K3 "
        f"{float(l_q)!r} equals the plain versions' bit for bit, launches "
        f"{c_q}; CE fake-quant {ce_f:.4f}, integer {ce_q:.4f}, gap "
        f"{ce_q - ce_f:+.4f}")

    # (d) the trained weights served: packed (K1 + K3) against the plain
    # versions, and the float params through LSQ's forward
    def reqs():
        return [GenRequest(p.copy(), LM_NEW) for p in prompts]

    srv = Server(cfg, state["params"], batch_slots=4, max_len=LM_MAX_LEN,
                 device=dev)
    reset_counts()
    got = [r.out_tokens for r in srv.generate(reqs())]
    torch.cuda.synchronize()
    c_srv = counts()
    want = {"K1": k1_fwd * LM_NEW, "K2": 0, "K3": k3_fwd * LM_NEW, "K4": 0,
            "K4g": 0}
    if c_srv != want:
        raise AssertionError(f"trained Server launches {c_srv}, want {want}")
    plain = Server(cfg, srv.params, batch_slots=4, max_len=LM_MAX_LEN,
                   plain=True, device=dev)
    ref = [r.out_tokens for r in plain.generate(reqs())]
    if ref != got or not torch.equal(plain.last_logits, srv.last_logits):
        raise AssertionError("trained Server: tokens/logits differ from the "
                             "plain run")
    del plain
    fsrv = Server(cfg, state["params"], batch_slots=4, max_len=LM_MAX_LEN,
                  quantized=False, device=dev)
    ftoks = [r.out_tokens for r in fsrv.generate(reqs())]
    agree = float(np.mean([a == b for x, y in zip(got, ftoks)
                           for a, b in zip(x, y)]))
    del fsrv, srv
    out["d"] = dict(launches=c_srv, tokens=got, float_tokens=ftoks,
                    float_agreement=agree)
    log(f"  Server on the trained weights: tokens and last-step logits equal "
        f"the plain run's, launches {c_srv}; Server(quantized=False) agrees "
        f"on {agree:.3f} of the tokens; request 0 {got[0][:8]}...")
    smoke = get_arch("stablelm-1.6b").smoke
    eng = ContinuousLMEngine(smoke, quantized=False, batch_slots=4,
                             max_len=32, seed=0, device=dev)
    eng_cpu = ContinuousLMEngine(smoke, tree_to(eng.params, "cpu"),
                                 quantized=False, batch_slots=4, max_len=32,
                                 device="cpu")
    sm_prompts = [np.arange(n, dtype=np.int32) * 7 % smoke.vocab_size
                  for n in (3, 6, 9, 5, 12)]
    a = [r.out_tokens for r in eng.serve(
        [GenRequest(p.copy(), 6) for p in sm_prompts])]
    b = [r.out_tokens for r in eng_cpu.serve(
        [GenRequest(p.copy(), 6) for p in sm_prompts])]
    if a != b or eng.stats()["cuda_graph"] != (dev.type == "cuda"):
        raise AssertionError(f"float engine (smoke): card {a} vs CPU {b}, "
                             f"{eng.stats()}")
    out["d"]["float_engine_smoke_tokens"] = a
    log(f"  ContinuousLMEngine(quantized=False), smoke config: its decode "
        f"step one CUDA graph, tokens equal the CPU's {a[0]}")
    del packed, state, trainer, step_fn
    torch.cuda.empty_cache()

    # (b) supervised resume at full width, 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    clean = Trainer(cfg2, opt_cfg=opt, batch_size=batch, seq_len=seq, seed=0,
                    device=dev)
    state_c, losses_c = clean.run(4, log_every=100)
    n2 = sum(p.numel() for p in tree_leaves(state_c["params"]))
    ck_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state_c))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"  resume: {n2 / 1e6:.1f} M params (2 layers, full width), "
            f"{ck_bytes / 1e9:.2f} GB per checkpoint; {free / 1e9:.1f} GB "
            f"free under {os.path.dirname(tmp)}")
        if free < 2.2 * ck_bytes:
            raise AssertionError(f"resume needs {2.2 * ck_bytes / 1e9:.1f} GB "
                                 f"of disk, {free / 1e9:.1f} GB free")

        class TimedCheckpoints(CheckpointManager):
            """Seconds spent in ``save`` (the device→host snapshot), in
            ``wait`` (blocked on the background write) and in
            ``restore``."""
            secs = {"save": 0.0, "wait": 0.0, "restore": 0.0}

            def save(self, *a, **k):
                t = time.perf_counter()
                super().save(*a, **k)
                self.secs["save"] += time.perf_counter() - t

            def wait(self):
                t = time.perf_counter()
                super().wait()
                self.secs["wait"] += time.perf_counter() - t

            def restore(self, *a, **k):
                t = time.perf_counter()
                r = super().restore(*a, **k)
                self.secs["restore"] += time.perf_counter() - t
                return r

        sup = Trainer(cfg2, opt_cfg=opt, ckpt_dir=tmp, batch_size=batch,
                      seq_len=seq, seed=0, save_every=2, device=dev)
        sup.ckpt = TimedCheckpoints(tmp, max_to_keep=1)
        t0 = time.perf_counter()
        state_f, losses_f = sup.run(4, injector=FailureInjector(
            fail_at_steps=(3,)), log_every=100)
        sup_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(tmp) for f in fs)
        steps_kept = sup.ckpt.all_steps()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_losses = losses_c[:3] + losses_c[2:]
    same = [torch.equal(x, y) and x.dtype == y.dtype
            for x, y in zip(tree_leaves(state_c), tree_leaves(state_f))]
    if losses_f != want_losses or not all(same) or steps_kept != [4]:
        raise AssertionError(
            f"resume: losses {losses_f} vs {want_losses}, "
            f"{same.count(False)} leaves differ, steps kept {steps_kept}")
    out["b"] = dict(n_params=n2, checkpoint_bytes=ck_bytes, free_bytes=free,
                    bytes_written=2 * written, losses=losses_f,
                    seconds=dict(TimedCheckpoints.secs), supervised_s=sup_s)
    log(f"  supervised run, failure injected at step 3: losses "
        + " ".join(f"{l:.4f}" for l in losses_f) + " equal the "
        f"uninterrupted run's, the final state ({len(same)} leaves) bit for "
        f"bit; 2 checkpoints of {written / 1e9:.2f} GB written; seconds "
        f"in save {TimedCheckpoints.secs['save']:.2f}, blocked on writes "
        f"{TimedCheckpoints.secs['wait']:.2f}, restore "
        f"{TimedCheckpoints.secs['restore']:.2f}; {sup_s:.1f} s for the "
        f"supervised run")
    del state_c, state_f, clean, sup
    torch.cuda.empty_cache()
    out["launches"] = {"K1": k1_fwd + c_srv["K1"], "K3": k3_fwd + c_srv["K3"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 in {out['seconds']:.1f} s")
    return out


# phase 15: the SSM and hybrid families at full width through Server
SSM_PROMPTS_LONG = (5, 8, 11, 600)       # mamba2 run 2: a 3-chunk prefill
HYMBA_PROMPTS_LONG = (1030, 1050, 1075, 1100)   # past hymba's 1024 window
HYMBA_NEW_LONG = 8
SCAN_TOL = {"rtol": 2e-4, "atol": 2e-5}  # tests/test_models_consistency.py
SSM_RANGES = ("ssm.scan", "ssm.conv")
# the depth phase 15 serves each model at, every width kept (earlier the
# full depth, then half of it): phase 18 serves both at full depth on
# trained weights, and the script must end inside its time limit
SSM_DEPTH = {"mamba2-780m": 12, "hymba-1.5b": 8}
# per model: the K1 launches (K, G step sizes) and the K3/K4 GEMMs ((K,
# N), how many) one layer makes
SSM_SLICE = {
    "mamba2-780m": {"k1": ((1536, 1), (3072, 1)),
                    "gemms": (((1536, 6448), 1), ((3072, 1536), 1))},
    "hymba-1.5b": {"k1": ((1600, 3), (1600, 1), (1600, 1), (3200, 1),
                          (1600, 2), (5504, 1)),
                   "gemms": (((1600, 1600), 2), ((1600, 320), 2),
                             ((1600, 6482), 1), ((3200, 1600), 1),
                             ((1600, 5504), 2), ((5504, 1600), 1))},
}


def kernel_of(name):
    """K1, K2, K3, K4 or grouped K4 for a profiler kernel name, else None
    (K1 has a float and a codes entry; K3 and K4 are one template, told
    apart by its first argument; grouped K4 is
    ``grouped_code_gemm_kernel``)."""
    if "quantize_pack_kernel" in name or "pack_codes_kernel" in name:
        return "K1"
    if "bitserial_conv2d_kernel" in name:
        return "K2"
    if "grouped_code_gemm_kernel" in name:
        return "K4g"
    if "bitserial_gemm_kernel<false" in name:
        return "K3"
    if "bitserial_gemm_kernel<true" in name:
        return "K4"
    return None


def ssm_phase(dev, hp):
    """Phase 15: mamba2-780m and hymba-1.5b FULL through ``Server`` on
    ``dev``. ``hp`` holds main's helpers: ``counts``, ``reset_counts``,
    ``check_equal``, ``profiled``, ``is_spin``, ``walls``, ``timer``.
    Returns its record; raises on any failure."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import get_arch
    from repro_torch.core import bitops
    from repro_torch.core.bitserial import plan_spec
    from repro_torch.core.quant import QuantSpec, qrange
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.launch.serve import GenRequest, Server
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"launches": {"K1": 0, "K3": 0, "K4": 0}}
    gen = torch.Generator(device=dev).manual_seed(21)
    spec = plan_spec(get_arch("mamba2-780m").full.policy.spec())
    aspec = QuantSpec(8, True)

    # (0) K1, K3 and K4 at the slice's shapes against their plain versions
    log("SSM/hybrid slice: K1, K3 and K4 at mamba2-780m's and hymba-1.5b's "
        "shapes vs plain (torch.equal), W4A8, M = 4 and 64")
    la, ha = qrange(spec.a_bits, spec.a_signed)
    lw, hw = qrange(spec.w_bits, spec.w_signed)
    steps = [torch.tensor(a, device=dev) for a in (0.177, 0.0371, 0.5)]
    calls = []
    for arch, sl in SSM_SLICE.items():
        for k, g in sl["k1"]:
            for m in (4, 64):
                xb = (torch.randn((m, k), generator=gen, device=dev)
                      * 4).bfloat16()
                hp.check_equal("K1", f"{arch} ({m},{k}) bf16 G={g}",
                               k1.quantize_pack_multi_cuda(xb, steps[:g],
                                                           aspec),
                               k1.quantize_pack_multi_ref(xb, steps[:g],
                                                          aspec))
        for (k, n), _ in sl["gemms"]:
            wc = torch.randint(lw, hw + 1, (k, n), generator=gen, device=dev,
                               dtype=torch.int32)
            wp = bitops.pack_bitplanes(bitops.pad_to(
                bitops.to_bitplanes(wc, spec.w_bits), 32, axis=1), axis=1)
            scale = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
            for m in (4, 64):
                xc = torch.randint(la, ha + 1, (m, k), generator=gen,
                                   device=dev, dtype=torch.int32)
                xp = k1.pack_codes_ref(xc, spec.a_bits)
                kw = dict(spec=spec, k=k)
                hp.check_equal("K3", f"{arch} M{m} {k}->{n}",
                               km.bitserial_matmul_v2_cuda(xp, wp, scale,
                                                           **kw),
                               km.bitserial_matmul_v2_ref(xp, wp, scale,
                                                          **kw))
                hp.check_equal("K4", f"{arch} M{m} {k}->{n}",
                               km.bitserial_matmul_cuda(xc, wp, scale, **kw),
                               km.bitserial_matmul_ref(xc, wp, scale, **kw))
                if m == 4:
                    byt = xp.numel() * 4 + wp.numel() * 4 + n * 4 + m * n * 4
                    ops = 2 * m * k * n
                    calls.append({
                        "model": arch, "k": k, "n": n, "m": m,
                        "K3_ms": hp.timer(lambda: km.bitserial_matmul_v2_cuda(
                            xp, wp, scale, **kw), 50),
                        "K4_ms": hp.timer(lambda: km.bitserial_matmul_cuda(
                            xc, wp, scale, **kw), 50),
                        "bound_ms": max(byt / HBM_BYTES_PER_S,
                                        ops / INT8_OPS_PER_S) * 1e3,
                        "bytes": byt, "ops": ops})
    out["gemm_calls"] = calls
    for c in calls:
        log(f"  {c['model']} M4 {c['k']}->{c['n']}: K3 {c['K3_ms']:.4f} ms, "
            f"K4 {c['K4_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms (cold "
            f"Timer)")

    # the SSD scan at one mamba2 layer's full-width shapes, chunked against
    # the step oracle, float32 on the card
    mcfg = get_arch("mamba2-780m").full
    scfg = mcfg.ssm_cfg()
    srng = np.random.RandomState(3)
    bsz, s, h, p, n = 4, 600, scfg.n_heads, scfg.head_dim, scfg.d_state
    arrs = [srng.randn(bsz, s, h, p), np.abs(srng.randn(bsz, s, h)) * 0.5
            + 0.05, srng.randn(h) * 0.3, srng.randn(bsz, s, 1, n) * 0.3,
            srng.randn(bsz, s, 1, n) * 0.3, srng.randn(h)]
    x, dt, a_log, bb, cc, dd = [torch.from_numpy(a.astype(np.float32)).to(dev)
                                for a in arrs]
    t0 = time.perf_counter()
    y, hf = ssm_mod.ssd_chunked(x, dt, a_log, bb, cc, dd, scfg)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    y_ref, h_ref = ssm_mod.ssd_scan_ref(x, dt, a_log, bb, cc, dd)
    for got, ref, what in ((y, y_ref, "y"), (hf, h_ref, "h_final")):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   err_msg=f"ssd_chunked {what}", **SCAN_TOL)
    out["ssd_check"] = {
        "shape": [bsz, s, h, p, n], "chunk": scfg.chunk, "chunked_s": chunk_s,
        "max_abs_err_y": float((y - y_ref).abs().max()),
        "max_abs_err_h": float((hf - h_ref).abs().max())}
    log(f"  ssd_chunked vs ssd_scan_ref on the card at (B {bsz}, S {s}, H "
        f"{h}, P {p}, N {n}), chunk {scfg.chunk}: within rtol 2e-4 / atol "
        f"2e-5, max abs err y {out['ssd_check']['max_abs_err_y']:.2e}, h "
        f"{out['ssd_check']['max_abs_err_h']:.2e}")
    del x, dt, bb, cc, y, hf, y_ref, h_ref

    def drive(server, prompts, new):
        """Tokens, last-step logits, launches and seconds of one
        ``generate``, counts reset just before and read just after."""
        hp.reset_counts()
        t0 = time.perf_counter()
        res = server.generate([GenRequest(pr.copy(), new) for pr in prompts])
        torch.cuda.synchronize()
        return ([r.out_tokens for r in res], server.last_logits.clone(),
                hp.counts(), time.perf_counter() - t0)

    def left_padded(prompts):
        toks = np.zeros((len(prompts), max(len(pr) for pr in prompts)),
                        np.int64)
        for i, pr in enumerate(prompts):
            toks[i, -len(pr):] = pr
        return {"tokens": torch.from_numpy(toks).to(dev)}

    def step_profile(fn, want):
        """``fn`` once under the profiler: wall, busy, every K1/K3/K4's
        in-path ms and launches by kernel name (held to ``want``), the
        scan's and the conv's busy ms."""
        prof, wall = hp.profiled(fn, expect=want)
        busy, kern = 0.0, 0
        by = {k: {"ms": 0.0, "launches": 0} for k in ("K1", "K3", "K4",
                                                       "K4g")}
        for evt in prof.key_averages():
            if (evt.device_type != DeviceType.CUDA or hp.is_spin(evt.key)
                    or evt.key in SSM_RANGES):
                continue
            busy += evt.self_device_time_total / 1e3
            kern += evt.count
            kid = kernel_of(evt.key)
            if kid is not None:
                by[kid]["ms"] += evt.self_device_time_total / 1e3
                by[kid]["launches"] += evt.count
        got = {k: v["launches"] for k, v in by.items()}
        if got != want:
            raise AssertionError(f"the profiler saw {got} launches by "
                                 f"kernel name, the wrappers {want}")
        rng_ = range_split(prof, SSM_RANGES)
        return {"wall_ms": wall * 1e3, "device_ms": busy, "kernels": kern,
                "by_kernel": by,
                "ranges": {k.split(".")[1]: v for k, v in rng_.items()},
                "scan_share": rng_["ssm.scan"]["busy"] / busy,
                "conv_share": rng_["ssm.conv"]["busy"] / busy}

    def serve_model(arch, runs):
        """``runs``: (tag, prompt lengths, new tokens, max_len, timed
        paths). Every run on the K1 + K3 path, the plain versions and the
        K4 path, on one set of weights; a run that times the K4 path also
        runs the K4 path's plain versions (the other runs hold K4 to the
        K1 + K3 path, held to the plain versions)."""
        full = get_arch(arch).full
        n_l = SSM_DEPTH[arch]
        cfg = dataclasses.replace(full, n_layers=n_l, global_attn_layers=tuple(
            g for g in full.global_attn_layers if g < n_l))
        sl = SSM_SLICE[arch]
        k1_step = len(sl["k1"]) * n_l
        k3_step = sum(c for _, c in sl["gemms"]) * n_l
        rec = {"layers": n_l, "k1_per_step": k1_step, "k3_per_step": k3_step}
        prng = np.random.RandomState(0)
        base = None
        for tag, lens, new, max_len, timed in runs:
            t_run = time.perf_counter()
            prompts = [prng.randint(0, cfg.vocab_size, (ln,)).astype(np.int32)
                       for ln in lens]
            r = {"prompts": list(lens), "new": new, "max_len": max_len,
                 "rolling_groups": [g.window is not None
                                    and g.window <= max_len
                                    for g in transformer.layer_groups(cfg)]}
            t0 = time.perf_counter()
            srv = Server(cfg, base, batch_slots=4, max_len=max_len, seed=0)
            torch.cuda.synchronize()
            if base is None:
                base = srv.params
                rec["init_s"] = time.perf_counter() - t0
                rec["params_gb"] = sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves(base)) / 1e9
                log(f"{arch} ({n_l} of {full.n_layers} layers, every width, "
                    f"bf16, W4A8, seed 0): random "
                    f"weights drawn and packed in {rec['init_s']:.2f} s, "
                    f"{rec['params_gb']:.2f} GB")
            main_ = drive(srv, prompts, new)
            want = {"K1": k1_step * new, "K2": 0, "K3": k3_step * new,
                    "K4": 0, "K4g": 0}
            toks, logits = main_[0], main_[1]
            if main_[2] != want:
                raise AssertionError(f"{arch} {tag}: launches {main_[2]}, "
                                     f"want {want}")
            if (logits.shape != (4, cfg.vocab_size)
                    or not bool(torch.isfinite(logits).all())
                    or any(len(t) != new or not all(
                        0 <= v < cfg.vocab_size for v in t) for t in toks)):
                raise AssertionError(f"{arch} {tag}: bad output "
                                     f"{logits.shape} {toks}")
            t0 = time.perf_counter()
            pl = drive(Server(cfg, base, batch_slots=4, max_len=max_len,
                              plain=True), prompts, new)
            r["plain_generate_s"] = time.perf_counter() - t0
            if any(pl[2].values()):
                raise AssertionError(f"{arch} plain run launched {pl[2]}")
            if pl[0] != toks or not torch.equal(pl[1], logits):
                raise AssertionError(f"{arch} {tag}: tokens/logits differ "
                                     "from the plain versions' run")
            k4s = Server(cfg, base, batch_slots=4, max_len=max_len,
                         pack_acts=False)
            k4 = drive(k4s, prompts, new)
            want4 = {"K1": 0, "K2": 0, "K3": 0, "K4": k3_step * new,
                     "K4g": 0}
            k4p = (drive(Server(cfg, base, batch_slots=4, max_len=max_len,
                                pack_acts=False, plain=True), prompts, new)
                   if "k4" in timed else pl)
            if k4[2] != want4 or any(k4p[2].values()):
                raise AssertionError(f"{arch} {tag} K4 path: launches "
                                     f"{k4[2]} (want {want4}), plain "
                                     f"{k4p[2]}")
            if (k4[0] != k4p[0] or not torch.equal(k4[1], k4p[1])
                    or k4[0] != toks or not torch.equal(k4[1], logits)):
                raise AssertionError(f"{arch} {tag}: the K4 path's tokens/"
                                     "logits differ from its plain run's or "
                                     "the K1 + K3 path's")
            for k in out["launches"]:
                out["launches"][k] += main_[2][k] + k4[2][k]
            r.update(tokens=toks, launches=main_[2], launches_k4=k4[2])
            log(f"  {tag}: prompts {list(lens)}, {new} new, max_len "
                f"{max_len} (rolling groups {r['rolling_groups']}): launches "
                f"{main_[2]} ({k1_step} K1 + {k3_step} K3 per step); tokens "
                f"and last-step logits equal the plain versions' "
                f"({r['plain_generate_s']:.1f} s); K4 path {k4[2]} equal to "
                + ("its plain run and to " if "k4" in timed else "")
                + f"K1 + K3; request 0: {toks[0]}")
            batch = left_padded(prompts)
            s0 = batch["tokens"].shape[1]
            with torch.inference_mode():
                hp.reset_counts()
                _, caches = transformer.prefill(srv.params, batch, srv.cfg,
                                                max_len=max_len)
                c_pre = hp.counts()
                hp.reset_counts()
                transformer.decode_step(srv.params, caches,
                                        batch["tokens"][:, :1], s0, srv.cfg)
                c_dec = hp.counts()
                torch.cuda.synchronize()
            for c in (c_pre, c_dec):
                if (c["K1"], c["K3"]) != (k1_step, k3_step):
                    raise AssertionError(f"{arch} {tag}: per-step launches "
                                         f"prefill {c_pre}, decode {c_dec}")
            # the SSM state a decode step reads and writes, every layer
            state_bytes = sum(c["h"].nbytes + c["conv"].nbytes
                              for c in (g.get("ssm", g) for g in caches))
            del caches
            for path, server, run in (("k3", srv, main_), ("k4", k4s, k4)):
                if path not in timed:
                    continue
                want_p = ({"K1": k1_step, "K3": k3_step, "K4": 0, "K4g": 0}
                          if path == "k3" else
                          {"K1": 0, "K3": 0, "K4": k3_step, "K4g": 0})
                with torch.inference_mode():
                    def prefill():
                        return transformer.prefill(server.params, batch,
                                                   server.cfg,
                                                   max_len=max_len)

                    pre_ms = hp.walls(prefill, 3)
                    pre_prof = (step_profile(prefill, want_p)
                                if path == "k3" else None)
                    lg, caches = prefill()
                    tok = torch.argmax(lg, -1)[:, None]
                    pos = iter(range(s0, max_len))

                    def step():
                        transformer.decode_step(server.params, caches, tok,
                                                next(pos), server.cfg)

                    step_ms = hp.walls(step, 5)
                    prof = step_profile(step, want_p)
                    del caches
                gen_s = run[3]             # the counted run's generate
                w_bytes = sum(t.numel() * t.element_size()
                              for t in tree_leaves(server.params["groups"])
                              ) + server.params["head"]["w"].numel() * 2
                r[path] = {
                    "prefill_ms": pre_ms, "profile_prefill": pre_prof,
                    "decode_step_ms": step_ms, "profile_decode_step": prof,
                    "generate_s": gen_s, "tok_per_s": 4 * new / gen_s,
                    "step_weight_bytes": w_bytes,
                    "step_state_bytes": 2 * state_bytes,
                    "step_bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3,
                    "step_bound_with_state_ms":
                        (w_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3}
                t = r[path]
                kk = "K3" if path == "k3" else "K4"
                busy = ("" if pre_prof is None else
                        f" (busy {pre_prof['device_ms']:.3f}, scan "
                        f"{pre_prof['scan_share']:.1%}, conv "
                        f"{pre_prof['conv_share']:.1%})")
                log(f"  {tag} {path.upper()} path, batch 4: prefill "
                    f"({s0} tokens) {pre_ms:.2f} ms{busy}; eager decode "
                    f"step {step_ms:.2f} ms; generate({new} new) "
                    f"{gen_s * 1e3:.0f} ms = {t['tok_per_s']:.1f} tok/s")
                log(f"    one profiled decode step: wall "
                    f"{prof['wall_ms']:.2f} ms, busy {prof['device_ms']:.3f} "
                    f"ms over {prof['kernels']} kernels; K1 "
                    f"{prof['by_kernel']['K1']['ms']:.4f} ms in "
                    f"{prof['by_kernel']['K1']['launches']}, {kk} "
                    f"{prof['by_kernel'][kk]['ms']:.4f} ms in "
                    f"{prof['by_kernel'][kk]['launches']} (by kernel name, "
                    f"equal to the wrappers'); scan "
                    f"{prof['ranges']['scan']['busy']:.3f} ms "
                    f"({prof['scan_share']:.1%} of busy), conv "
                    f"{prof['ranges']['conv']['busy']:.3f} ms "
                    f"({prof['conv_share']:.1%}); weight-byte bound "
                    f"{t['step_bound_ms']:.3f} ms ({w_bytes / 1e9:.3f} GB), "
                    f"{t['step_bound_with_state_ms']:.3f} ms with the SSM "
                    f"state read and written ({2 * state_bytes / 1e9:.3f} GB)")
            del srv, k4s
            r["seconds"] = time.perf_counter() - t_run
            rec[tag] = r
        # the smoke config on the card gives the CPU's plain-version tokens
        smoke = get_arch(arch).smoke
        sm_gpu = Server(smoke, batch_slots=4, max_len=32, seed=0)
        sm_cpu = Server(smoke, tree_to(sm_gpu.params, "cpu"), batch_slots=4,
                        max_len=32, device="cpu")
        sm_prompts = [np.arange(ln, dtype=np.int32) * 7 % smoke.vocab_size
                      for ln in (3, 6, 9)]
        a = [q.out_tokens for q in sm_gpu.generate(
            [GenRequest(pr.copy(), 12) for pr in sm_prompts])]
        b = [q.out_tokens for q in sm_cpu.generate(
            [GenRequest(pr.copy(), 12) for pr in sm_prompts])]
        if a != b:
            raise AssertionError(f"{arch} smoke config: card {a} vs CPU {b}")
        log(f"  smoke config (window/chunk 8, 12 new tokens: past the "
            f"window): card tokens equal the CPU plain run's {a[0]}")
        del base
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    out["mamba2-780m"] = serve_model("mamba2-780m", [
        ("run1", LM_PROMPTS, LM_NEW, 1024, ("k3", "k4")),
        ("run2", SSM_PROMPTS_LONG, LM_NEW, 1024, ("k3",))])
    out["hymba-1.5b"] = serve_model("hymba-1.5b", [
        ("run1", LM_PROMPTS, LM_NEW, LM_MAX_LEN, ("k3", "k4")),
        ("run2", HYMBA_PROMPTS_LONG, HYMBA_NEW_LONG, 1280, ("k3",))])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# phase 16: the reference's six remaining architectures at full width
# the layers each runs at, and why any were cut: a quarter of the depth one
# 80 GB card holds at W4 beside the float32 embedding and head (earlier
# that depth, then half of it), so the script ends inside its time limit
_CUT = "a quarter of what the card holds, for the script's time limit"
FAMILY_DEPTH = {
    "nemotron-4-15b": (32, None),
    "qwen1.5-110b": (20, _CUT),
    "command-r-plus-104b": (12, "64 layers: 50.3 GB packed + 12.6 GB "
                                "embedding + 12.6 + 6.3 GB head, about 82 "
                                "GB, past the card; 48 fit; " + _CUT),
    "internvl2-76b": (20, _CUT),
    "qwen3-moe-235b-a22b": (10, "94 layers' packed experts alone are 117 "
                                "GB; 40 fit; " + _CUT),
    "seamless-m4t-large-v2": (24, None),
}
# the depth at which the plain versions' run is held against the kernels'
# (every width kept): the plain GEMMs unpack every weight on every call,
# about 0.1 s per billion weights a step on the card
PLAIN_DEPTH = 2
FRONT_NEW = 4            # decode steps after a frontend/source prefill
SRC_LEN = 64             # seamless: source frames per request
# K3/K4 at each model's new (K, N) (the MLP's two, qwen's biased q and k/v)
FAMILY_GEMMS = {
    "qwen1.5-110b": ((8192, 49152, False), (49152, 8192, False),
                     (8192, 8192, True), (8192, 1024, True)),
    "command-r-plus-104b": ((12288, 33792, False), (33792, 12288, False)),
    "nemotron-4-15b": ((6144, 24576, False), (24576, 6144, False)),
    "seamless-m4t-large-v2": ((1024, 8192, False), (8192, 1024, False)),
}
# K1 launches (K, G step sizes) the six make, one per distinct activation
FAMILY_K1 = ((8192, 3), (8192, 1), (8192, 2), (49152, 1), (12288, 3),
             (12288, 1), (12288, 2), (33792, 1), (6144, 3), (6144, 1),
             (24576, 1), (28672, 1), (4096, 3), (1024, 3), (1024, 1),
             (1024, 2))
# grouped K4 at qwen3-moe's experts: E, (K, N) of up/gate and down
MOE_E, MOE_GEMMS = 128, ((4096, 1536), (1536, 4096))


def family_launches(cfg, kind, pack_acts=True):
    """Kernel launches one ``prefill`` or ``decode_step`` of ``cfg`` makes:
    per decoder layer q/k/v share one K1 (3 GEMMs), o one, the MLP one per
    distinct activation (SwiGLU's gate/up share one), an MoE layer 3
    grouped K4 and no K1 for its experts; a cross-attending layer adds q
    and o, and at prefill k/v of the encoder's output (one K1, 2 GEMMs);
    an encoder layer is a dense one, at prefill only."""
    def mlp():
        return (2, 3) if cfg.act == "swiglu" else (2, 2)

    k1 = k3 = k4g = 0
    for li in range(cfg.n_layers):
        a1, a3 = 2, 4
        if cfg.n_experts and li >= cfg.n_dense_layers:
            k4g += 3
        else:
            m1, m3 = mlp()
            a1, a3 = a1 + m1, a3 + m3
        if cfg.family in ("encdec", "audio"):
            a1, a3 = a1 + 2, a3 + 2
            if kind == "prefill":
                a1, a3 = a1 + 1, a3 + 2
        k1, k3 = k1 + a1, k3 + a3
    if cfg.family in ("encdec", "audio") and kind == "prefill":
        m1, m3 = mlp()
        n_enc = cfg.n_enc_layers or cfg.n_layers
        k1, k3 = k1 + n_enc * (2 + m1), k3 + n_enc * (4 + m3)
    if pack_acts:
        return {"K1": k1, "K2": 0, "K3": k3, "K4": 0, "K4g": k4g}
    return {"K1": 0, "K2": 0, "K3": 0, "K4": k3, "K4g": k4g}


def families_phase(dev, hp):
    """Phase 16: qwen1.5-110b, command-r-plus-104b, nemotron-4-15b,
    qwen3-moe-235b-a22b, internvl2-76b and seamless-m4t-large-v2 at their
    published widths on ``dev``. ``hp`` holds main's helpers: ``counts``,
    ``reset_counts``, ``check_equal``, ``profiled``, ``is_spin``,
    ``walls``, ``timer``. Returns its record; raises on any failure."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import get_arch
    from repro_torch.core.bitserial import plan_spec
    from repro_torch.core.quant import QuantSpec, qrange
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.launch.serve import GenRequest, Server
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.layers import pack_weight_codes
    from repro_torch.serving import ContinuousLMEngine

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    t_phase = time.perf_counter()
    out = {"launches": {"K1": 0, "K3": 0, "K4": 0, "K4g": 0}}
    gen = torch.Generator(device=dev).manual_seed(23)
    spec = plan_spec(get_arch("qwen1.5-110b").full.policy.spec())
    aspec = QuantSpec(8, True)
    la, ha = qrange(spec.a_bits, spec.a_signed)
    lw, hw = qrange(spec.w_bits, spec.w_signed)

    def count(c):
        for k in out["launches"]:
            out["launches"][k] += c[k]

    # (0) K1, K3, K4 and grouped K4 at the new shapes against their plain
    # versions, exact; K3 and K4 (M = 4) and grouped K4 (C = 1) timed
    log("families: K1, K3/K4 (qwen's q/k/v with a nonzero bias) and "
        "grouped K4 (E = 128) at the six models' new shapes vs plain "
        "(torch.equal)")
    steps = [torch.tensor(a, device=dev) for a in (0.177, 0.0371, 0.5)]
    for k, g in FAMILY_K1:
        for m in (4, 64):
            xb = (torch.randn((m, k), generator=gen, device=dev)
                  * 4).bfloat16()
            hp.check_equal("K1", f"({m},{k}) bf16 G={g}",
                           k1.quantize_pack_multi_cuda(xb, steps[:g], aspec),
                           k1.quantize_pack_multi_ref(xb, steps[:g], aspec))
    gemm_calls = []
    for arch, shapes in FAMILY_GEMMS.items():
        for k, n, biased in shapes:
            wp = pack_weight_codes(torch.randint(
                lw, hw + 1, (k, n), generator=gen, device=dev,
                dtype=torch.int32), spec.w_bits)
            scale = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
            bias = (torch.randn(n, generator=gen, device=dev) * 0.1
                    if biased else None)
            for m in (4, 64):
                xc = torch.randint(la, ha + 1, (m, k), generator=gen,
                                   device=dev, dtype=torch.int32)
                xp = k1.pack_codes_ref(xc, spec.a_bits)
                kw = dict(spec=spec, k=k)
                what = f"{arch} M{m} {k}->{n}" + (" bias" if biased else "")
                hp.check_equal("K3", what,
                               km.bitserial_matmul_v2_cuda(xp, wp, scale,
                                                           bias, **kw),
                               km.bitserial_matmul_v2_ref(xp, wp, scale,
                                                          bias, **kw))
                hp.check_equal("K4", what,
                               km.bitserial_matmul_cuda(xc, wp, scale, bias,
                                                        **kw),
                               km.bitserial_matmul_ref(xc, wp, scale, bias,
                                                       **kw))
                if m != 4:
                    continue
                byt = (xp.numel() + wp.numel() + 2 * n + m * n) * 4
                xh, wh = xc.half(), torch.randn((k, n), generator=gen,
                                                device=dev).half()
                gemm_calls.append({
                    "model": arch, "k": k, "n": n, "m": m, "bias": biased,
                    "K3_ms": hp.timer(lambda: km.bitserial_matmul_v2_cuda(
                        xp, wp, scale, bias, **kw), 30),
                    "K4_ms": hp.timer(lambda: km.bitserial_matmul_cuda(
                        xc, wp, scale, bias, **kw), 30),
                    "plain_K3_ms": hp.timer(lambda: km.bitserial_matmul_v2_ref(
                        xp, wp, scale, bias, **kw), 3),
                    "library_ms": hp.timer(lambda: torch.matmul(xh, wh), 30),
                    "bound_ms": max(byt / HBM_BYTES_PER_S,
                                    2 * m * k * n / INT8_OPS_PER_S) * 1e3,
                    "bytes": byt})
                del xh, wh
            del wp
    out["gemm_calls"] = gemm_calls
    for c in gemm_calls:
        log(f"  {c['model']} M4 {c['k']}->{c['n']}"
            + (" +bias" if c["bias"] else "") + f": K3 {c['K3_ms']:.4f} ms, "
            f"K4 {c['K4_ms']:.4f} ms, plain K3 {c['plain_K3_ms']:.2f} ms, "
            f"fp16 matmul {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms (cold Timer)")
    grouped = []
    mcfg = get_arch("qwen3-moe-235b-a22b").full.moe_cfg()
    for k, n in MOE_GEMMS:
        wp = torch.stack([pack_weight_codes(torch.randint(
            lw, hw + 1, (k, n), generator=gen, device=dev, dtype=torch.int32),
            spec.w_bits) for _ in range(MOE_E)])
        # the experts a seeded routing of a batch-4 decode step fills
        idx = torch.topk(torch.rand((4, MOE_E), generator=gen, device=dev),
                         mcfg.top_k, dim=-1).indices
        keep, flat = moe_mod.dispatch(idx, MOE_E, 1)
        occupied = torch.zeros(MOE_E + 1, dtype=torch.bool, device=dev)
        occupied[flat.reshape(-1)] = True
        occupied = occupied[:MOE_E]
        for c in (1, 5):
            x = torch.randint(la, ha + 1, (MOE_E, c, k), generator=gen,
                              device=dev, dtype=torch.int32)
            cases = [("every expert", x)]
            if c == 1:
                cases.append(("dispatch", x * occupied[:, None, None]))
            for what, xx in cases:
                hp.check_equal("K4g", f"E{MOE_E} C{c} {k}->{n} {what}",
                               km.bitserial_matmul_grouped_cuda(
                                   xx, wp, spec=spec, k=k),
                               km.bitserial_matmul_grouped_ref(
                                   xx, wp, spec=spec, k=k))
                if c != 1:
                    continue
                n_occ = MOE_E if what == "every expert" else int(
                    occupied.sum())
                byt = (n_occ * wp[0].numel() + xx.numel() + xx.numel()
                       // k * n) * 4
                grouped.append({
                    "k": k, "n": n, "c": c, "experts": n_occ,
                    "ms": hp.timer(lambda: km.bitserial_matmul_grouped_cuda(
                        xx, wp, spec=spec, k=k), 30),
                    "plain_ms": hp.timer(
                        lambda: km.bitserial_matmul_grouped_ref(
                            xx, wp, spec=spec, k=k), 2),
                    "bound_ms": byt / HBM_BYTES_PER_S * 1e3})
        del wp
    out["grouped_calls"] = grouped
    for c in grouped:
        log(f"  grouped K4 E{MOE_E} C1 {c['k']}->{c['n']} at {c['experts']} "
            f"experts: {c['ms']:.4f} ms, plain {c['plain_ms']:.1f} ms, "
            f"bound {c['bound_ms']:.4f} ms (cold Timer)")
    free()

    def seed_biases(params, seed):
        """Every bias (qwen1.5's q/k/v) set to seeded nonzero values, in
        place: the reference draws them as zeros, which would hide one
        that is dropped or misplaced."""
        g = torch.Generator(device=dev).manual_seed(seed)
        stack = [params]
        n = 0
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                for key, v in t.items():
                    if key == "b" and torch.is_tensor(v):
                        v.copy_(torch.randn(v.shape, generator=g,
                                            device=dev) * 0.1)
                        n += 1
                    else:
                        stack.append(v)
            elif isinstance(t, list):
                stack.extend(t)
        return n

    def requests(cfg, lens=LM_PROMPTS, seed=0):
        prng = np.random.RandomState(seed)
        return [prng.randint(0, cfg.vocab_size, (ln,)).astype(np.int32)
                for ln in lens]

    def left_padded(prompts):
        toks = np.zeros((len(prompts), max(len(pr) for pr in prompts)),
                        np.int64)
        for i, pr in enumerate(prompts):
            toks[i, -len(pr):] = pr
        return torch.from_numpy(toks).to(dev)

    def extra_inputs(cfg, b):
        """Seeded frontend (VLM) or source (encoder-decoder) embeddings."""
        g = torch.Generator(device=dev).manual_seed(5)
        if cfg.family == "vlm":
            return {"frontend_embeds": torch.randn(
                (b, cfg.frontend_len, cfg.frontend_dim), generator=g,
                device=dev).bfloat16()}
        return {"src_embeds": torch.randn((b, SRC_LEN, cfg.frontend_dim),
                                          generator=g, device=dev).bfloat16()}

    def generate(server, prompts, new):
        """``Server.generate``: tokens, last-step logits, launches and
        seconds, counts reset just before and read just after."""
        hp.reset_counts()
        t0 = time.perf_counter()
        res = server.generate([GenRequest(pr.copy(), new) for pr in prompts])
        torch.cuda.synchronize()
        return ([r.out_tokens for r in res], server.last_logits.clone(),
                hp.counts(), time.perf_counter() - t0)

    def drive(params, cfg, batch, new, max_len):
        """What ``generate`` does, on a batch with extra inputs: prefill,
        then greedy decode steps after the whole prefix; tokens (B, new),
        last logits, launches and seconds."""
        hp.reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, caches = transformer.prefill(params, batch, cfg,
                                                 max_len=max_len)
            tok = torch.argmax(logits, -1)[:, None]
            cols = [tok]
            s0 = batch["tokens"].shape[1] + (
                cfg.frontend_len if cfg.family == "vlm" else 0)
            for t in range(1, new):
                logits, caches = transformer.decode_step(
                    params, caches, tok, s0 + t - 1, cfg)
                tok = torch.argmax(logits, -1)[:, None]
                cols.append(tok)
            toks = torch.cat(cols, 1).cpu().tolist()
        torch.cuda.synchronize()
        return toks, logits.clone(), hp.counts(), time.perf_counter() - t0

    def expect(arch, what, got, cfg, new, pack_acts=True):
        pre = family_launches(cfg, "prefill", pack_acts)
        dec = family_launches(cfg, "decode", pack_acts)
        want = {k: pre[k] + (new - 1) * dec[k] for k in pre}
        if got != want:
            raise AssertionError(f"{arch} {what}: launches {got}, want {want}")

    def check_out(arch, what, toks, logits, cfg, new):
        if (logits.shape != (4, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())
                or any(len(t) != new or not all(0 <= v < cfg.vocab_size
                                                for v in t) for t in toks)):
            raise AssertionError(f"{arch} {what}: bad output "
                                 f"{tuple(logits.shape)} {toks}")

    def same(arch, what, a, b):
        if a[0] != b[0] or not torch.equal(a[1], b[1]):
            raise AssertionError(f"{arch} {what}: tokens/last-step logits "
                                 f"differ ({a[0][0]} vs {b[0][0]})")

    def profile_step(fn, want):
        """``fn`` once under the profiler: wall, busy, kernels and K1, K3,
        K4, grouped K4 by kernel name (held to ``want``; a window short of
        them is opened again)."""
        prof, wall = hp.profiled(fn, expect={
            k: want[k] for k in ("K1", "K3", "K4", "K4g") if want.get(k)})
        busy, kern = 0.0, 0
        by = {k: {"ms": 0.0, "launches": 0} for k in ("K1", "K3", "K4",
                                                       "K4g")}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA or hp.is_spin(evt.key):
                continue
            busy += evt.self_device_time_total / 1e3
            kern += evt.count
            kid = kernel_of(evt.key)
            if kid is not None:
                by[kid]["ms"] += evt.self_device_time_total / 1e3
                by[kid]["launches"] += evt.count
        got = {k: v["launches"] for k, v in by.items()}
        if got != {k: want[k] for k in got}:
            raise AssertionError(f"the profiler saw {got} launches by "
                                 f"kernel name, the wrappers {want}")
        return {"wall_ms": wall * 1e3, "device_ms": busy, "kernels": kern,
                "by_kernel": by}

    def cli_load(vocab, n=16):
        """The reference CLI's mixed load: prompts of 4-16 tokens from
        RandomState(0), every 4th request 16 new tokens, the others 4."""
        rng = np.random.RandomState(0)
        m_long = min(LM_NEW, LM_MAX_LEN - 16)
        return [GenRequest(rng.randint(0, vocab, (int(rng.randint(4, 17)),)
                                       ).astype(np.int32),
                           m_long if i % 4 == 0 else max(1, m_long // 4))
                for i in range(n)]

    def copies(reqs):
        return [GenRequest(r.prompt.copy(), r.max_new_tokens) for r in reqs]

    def plain_check(arch, full, rec):
        """Every width, ``PLAIN_DEPTH`` layers (seamless: all): the kernels'
        run against the plain versions' on the same weights, tokens and
        last-step logits exactly; the K4 path against K1 + K3."""
        t0 = time.perf_counter()
        cfg = full
        if arch != "seamless-m4t-large-v2":
            cfg = dataclasses.replace(full, n_layers=PLAIN_DEPTH)
        prompts = requests(cfg)
        if cfg.family in ("encdec", "audio"):
            srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
            seed_biases(srv.params, 7)
            base = srv.params
            runs = {}
            for tag, kw in (("k3", {}), ("plain", {"plain": True}),
                            ("k4", {"pack_acts": False})):
                c = transformer.serve_policy(cfg, **{"pack_acts": True, **kw})
                batch = {"tokens": left_padded(prompts),
                         **extra_inputs(cfg, 4)}
                runs[tag] = drive(base, c, batch, LM_NEW, LM_MAX_LEN)
        else:
            srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
            seed_biases(srv.params, 7)
            base = srv.params
            runs = {"k3": generate(srv, prompts, LM_NEW),
                    "plain": generate(Server(cfg, base, batch_slots=4,
                                             max_len=LM_MAX_LEN, plain=True),
                                      prompts, LM_NEW),
                    "k4": generate(Server(cfg, base, batch_slots=4,
                                          max_len=LM_MAX_LEN,
                                          pack_acts=False), prompts, LM_NEW)}
        expect(arch, "depth-cut K1 + K3 run", runs["k3"][2], cfg, LM_NEW)
        expect(arch, "depth-cut K4 run", runs["k4"][2], cfg, LM_NEW, False)
        if any(runs["plain"][2][k] for k in ("K1", "K3", "K4", "K4g")):
            raise AssertionError(f"{arch} plain run launched "
                                 f"{runs['plain'][2]}")
        check_out(arch, "depth-cut run", runs["k3"][0], runs["k3"][1], cfg,
                  LM_NEW)
        same(arch, "kernels vs plain", runs["k3"], runs["plain"])
        same(arch, "K4 vs K1 + K3", runs["k4"], runs["k3"])
        count(runs["k3"][2])
        count(runs["k4"][2])
        if cfg.family == "vlm":
            # the frontend: seeded patch embeddings before the prompts
            batch = {"tokens": left_padded(prompts), **extra_inputs(cfg, 4)}
            ml = cfg.frontend_len + LM_MAX_LEN
            fk = drive(base, srv.cfg, batch, FRONT_NEW, ml)
            fp = drive(base, transformer.serve_policy(srv.cfg, plain=True),
                       batch, FRONT_NEW, ml)
            expect(arch, "depth-cut frontend run", fk[2], cfg, FRONT_NEW)
            same(arch, "frontend run, kernels vs plain", fk, fp)
            count(fk[2])
        rec["plain_check"] = {
            "layers": cfg.n_layers, "seconds": time.perf_counter() - t0,
            "plain_generate_s": runs["plain"][3]}
        log(f"  {cfg.n_layers} layers at full width: the kernels' tokens "
            f"and last-step logits equal the plain versions' "
            f"({runs['plain'][3]:.1f} s); the K4 path's equal K1 + K3's"
            + ("; also with the frontend's 256 patches" if cfg.family == "vlm"
               else "") + f"; request 0: {runs['k3'][0][0]}")
        del srv, base, runs
        free()

    def serve_full(arch, rec):
        depth, why = FAMILY_DEPTH[arch]
        full = get_arch(arch).full
        cfg = dataclasses.replace(full, n_layers=depth)
        rec.update(layers=depth, published_layers=full.n_layers,
                   depth_cut=why)
        held = torch.cuda.memory_allocated()     # by the earlier phases
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
        nb = seed_biases(srv.params, 11)
        torch.cuda.synchronize()
        base = srv.params
        rec["init_s"] = time.perf_counter() - t0
        rec["params_gb"] = sum(t.numel() * t.element_size()
                               for t in tree_leaves(base)) / 1e9
        rec["held_gb"] = held / 1e9
        rec["init_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        log(f"{arch} ({depth} of {full.n_layers} layers"
            + (f"; cut: {why}" if why else "") + f", bf16, W4A8, seed 0, "
            f"{nb} bias leaves seeded): drawn and packed in "
            f"{rec['init_s']:.1f} s, {rec['params_gb']:.2f} GB, peak "
            f"{rec['init_peak_gb']:.2f} GB above the {rec['held_gb']:.2f} GB "
            "held before")
        prompts = requests(cfg)
        pre = family_launches(cfg, "prefill")
        dec = family_launches(cfg, "decode")
        rec["launches_prefill"], rec["launches_decode"] = pre, dec
        if cfg.family in ("encdec", "audio"):
            batch = {"tokens": left_padded(prompts), **extra_inputs(cfg, 4)}
            runs = {"k3": drive(base, srv.cfg, batch, LM_NEW, LM_MAX_LEN),
                    "k4": drive(base, transformer.serve_policy(
                        srv.cfg, pack_acts=False), batch, LM_NEW,
                        LM_MAX_LEN)}
        else:
            runs = {"k3": generate(srv, prompts, LM_NEW),
                    "k4": generate(Server(cfg, base, batch_slots=4,
                                          max_len=LM_MAX_LEN,
                                          pack_acts=False), prompts, LM_NEW)}
        expect(arch, "K1 + K3 run", runs["k3"][2], cfg, LM_NEW)
        expect(arch, "K4 run", runs["k4"][2], cfg, LM_NEW, False)
        check_out(arch, "K1 + K3 run", runs["k3"][0], runs["k3"][1], cfg,
                  LM_NEW)
        same(arch, "K4 vs K1 + K3", runs["k4"], runs["k3"])
        count(runs["k3"][2])
        count(runs["k4"][2])
        rec.update(tokens=runs["k3"][0], launches=runs["k3"][2],
                   launches_k4=runs["k4"][2],
                   generate_s=runs["k3"][3], generate_k4_s=runs["k4"][3])
        src = (" with src_embeds (4, 64, 1024)" if cfg.family == "audio"
               else "")
        log(f"  4 requests {list(LM_PROMPTS)}{src}, {LM_NEW} new: launches "
            f"{runs['k3'][2]} (prefill {pre}, decode step {dec}); the K4 "
            f"path {runs['k4'][2]} gives the same tokens and last-step "
            f"logits; request 0: {runs['k3'][0][0]}")
        # times: prefill, eager decode step, one profiled decode step
        batch = {"tokens": left_padded(prompts)}
        if cfg.family in ("encdec", "audio"):
            batch.update(extra_inputs(cfg, 4))
        s0 = batch["tokens"].shape[1]
        with torch.inference_mode():
            def prefill():
                return transformer.prefill(base, batch, srv.cfg,
                                           max_len=LM_MAX_LEN)

            pre_ms = hp.walls(prefill, 2)
            lg, caches = prefill()
            tok = torch.argmax(lg, -1)[:, None]
            pos = iter(range(s0, LM_MAX_LEN))

            def step():
                transformer.decode_step(base, caches, tok, next(pos),
                                        srv.cfg)

            step_ms = hp.walls(step, 3)
            prof = profile_step(step, dec)
            del caches
        w_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(base["groups"])
                      ) + base["head"]["w"].numel() * 2
        rec.update(prefill_ms=pre_ms, decode_step_ms=step_ms,
                   profile_decode_step=prof, step_weight_bytes=w_bytes,
                   step_bound_ms=w_bytes / HBM_BYTES_PER_S * 1e3,
                   tok_per_s=4 * LM_NEW / runs["k3"][3])
        bk = prof["by_kernel"]
        log(f"  batch 4, K1 + K3: prefill ({s0} tokens) {pre_ms:.1f} ms, "
            f"eager decode step {step_ms:.1f} ms, generate({LM_NEW} new) "
            f"{runs['k3'][3] * 1e3:.0f} ms = {rec['tok_per_s']:.1f} tok/s; "
            f"one profiled decode step: wall {prof['wall_ms']:.1f} ms, busy "
            f"{prof['device_ms']:.3f} ms over {prof['kernels']} kernels; K1 "
            f"{bk['K1']['ms']:.3f} ms in {bk['K1']['launches']}, K3 "
            f"{bk['K3']['ms']:.3f} ms in {bk['K3']['launches']}"
            + (f", grouped K4 {bk['K4g']['ms']:.3f} ms in "
               f"{bk['K4g']['launches']}" if bk["K4g"]["launches"] else "")
            + f"; weight-byte bound {rec['step_bound_ms']:.3f} ms "
            f"({w_bytes / 1e9:.2f} GB)")
        if cfg.family == "vlm":
            batch = {"tokens": left_padded(prompts), **extra_inputs(cfg, 4)}
            ml = cfg.frontend_len + LM_MAX_LEN
            fk = drive(base, srv.cfg, batch, FRONT_NEW, ml)
            expect(arch, "frontend run", fk[2], cfg, FRONT_NEW)
            check_out(arch, "frontend run", fk[0], fk[1], cfg, FRONT_NEW)
            count(fk[2])
            rec.update(frontend_tokens=fk[0], frontend_launches=fk[2],
                       frontend_s=fk[3])
            log(f"  with frontend_embeds (4, 256, 3200) before the "
                f"prompts: prefill + {FRONT_NEW - 1} decode steps in "
                f"{fk[3] * 1e3:.0f} ms, launches {fk[2]}; request 0: "
                f"{fk[0][0]}")
        if arch in ("qwen1.5-110b", "qwen3-moe-235b-a22b"):
            engine_run(arch, cfg, base, dec, rec)
        rec["peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        log(f"  peak memory {rec['peak_gb']:.2f} GB above what was held "
            "before")
        del srv, base, runs
        free()

    def engine_run(arch, cfg, base, dec, rec):
        """``ContinuousLMEngine`` on the CLI's mixed load, its decode step
        one CUDA graph, held to the same engine stepping eagerly on the
        same load (16 requests fill every slot before the first step)."""
        eng = ContinuousLMEngine(cfg, base, batch_slots=4,
                                 max_len=LM_MAX_LEN)
        warm = eng.warmup()
        st = eng.stats()
        want = {k: dec[k] for k in ("K1", "K3", "K4", "K4g")}
        if (not st["cuda_graph"] or st["compiles"]["decode"] != 1
                or st["step_launches"] != want):
            raise AssertionError(f"{arch} engine capture: {st}")
        load = cli_load(cfg.vocab_size)
        hp.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.serve(copies(load))
        load_s = time.perf_counter() - t0
        c_load = hp.counts()
        em = eng.engine_metrics()
        want_load = {k: v * len(load) for k, v in dec.items()}
        st = eng.stats()
        if c_load != want_load or st["recompiles_after_warmup"] != 0:
            raise AssertionError(f"{arch} engine load: launches {c_load} "
                                 f"(want {want_load}), {st}")
        for r in got:
            if (len(r.out_tokens) != r.max_new_tokens
                    or not all(0 <= v < cfg.vocab_size
                               for v in r.out_tokens)):
                raise AssertionError(f"{arch} engine output {r.out_tokens}")
        ran = {k: c_load[k] + want[k] * em["decode_steps"] for k in want}
        count({**ran, "K2": 0})
        eager = ContinuousLMEngine(cfg, base, batch_slots=4,
                                   max_len=LM_MAX_LEN)
        eager._fresh_arena()
        eager._graph = None                 # its steps run eagerly
        e_out = eager.serve(copies(load))
        for i, (r, e) in enumerate(zip(got, e_out)):
            if r.out_tokens != e.out_tokens:
                raise AssertionError(f"{arch} engine request {i}: the "
                                     f"graphed engine parts from the eager "
                                     f"one ({r.out_tokens} vs {e.out_tokens})")
        del eager
        replay_ms = hp.walls(eng._run_step, 10)
        pr, wall = hp.profiled(eng._run_step,
                               expect={k: v for k, v in want.items() if v})
        busy, kern, by = 0.0, 0, {k: 0 for k in want}
        for evt in pr.key_averages():
            if evt.device_type != DeviceType.CUDA or hp.is_spin(evt.key):
                continue
            busy += evt.self_device_time_total / 1e3
            kern += evt.count
            kid = kernel_of(evt.key)
            if kid is not None:
                by[kid] += evt.count
        if by != want:
            raise AssertionError(f"{arch} replay: {by} launches by kernel "
                                 f"name, {want} at capture")
        n_tok = sum(len(r.out_tokens) for r in got)
        rec["engine"] = {
            "warmup_s": warm["seconds"], "capture_s": st["capture_seconds"],
            "step_launches": st["step_launches"], "load_tokens": n_tok,
            "load_s": load_s, "tok_per_s": n_tok / load_s,
            "decode_steps": em["decode_steps"], "launches_run": ran,
            "replay_ms": replay_ms, "replay_wall_ms": wall * 1e3,
            "replay_busy_ms": busy, "replay_kernels": kern}
        log(f"  ContinuousLMEngine (4 slots, max_len {LM_MAX_LEN}): warmup "
            f"{warm['seconds']:.1f} s, decode step captured with "
            f"{st['step_launches']}; the CLI's 16 requests, {n_tok} tokens "
            f"in {load_s * 1e3:.0f} ms = {n_tok / load_s:.1f} tok/s over "
            f"{em['decode_steps']} replayed steps, equal to the same engine "
            f"stepping eagerly; a replay {replay_ms:.2f} ms, profiled: wall "
            f"{wall * 1e3:.2f} ms, busy {busy:.3f} ms over {kern} kernels")
        del eng
        free()

    for arch in FAMILY_DEPTH:
        t_arch = time.perf_counter()
        rec = {}
        log(f"{arch}: the plain versions at every width, "
            f"{PLAIN_DEPTH if arch != 'seamless-m4t-large-v2' else 24} "
            f"layers")
        plain_check(arch, get_arch(arch).full, rec)
        serve_full(arch, rec)
        rec["seconds"] = time.perf_counter() - t_arch
        out[arch] = rec
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# phase 17: the long-context cells of launch/dryrun.py on the card
LONG_ARCH = "stablelm-1.6b"
CHUNK_CHECK_LEN = 4096   # tokens at which chunked is held to materialized
# tests/test_models_consistency.py's tolerance for chunked vs materialized
CHUNK_TOL = {"rtol": 1e-4, "atol": 1e-5}
LONG_NEW = 8             # new tokens of the 500k-slot runs
# kernel launches of one prefill or decode step per layer: (K1, K3, and
# grouped K4 per MoE layer)
LAYER_LAUNCHES = {"stablelm-1.6b": (4, 7, 0),
                  "deepseek-v2-lite-16b": (4, 6, 3),
                  "hymba-1.5b": (6, 9, 0)}
GROUPED_C = 3840         # ceil(32768 * 6 / 64 * 1.25): deepseek at 32k


def step_launches(cfg, steps):
    """Launches of ``steps`` prefills and decode steps of ``cfg``."""
    k1, k3, k4g = LAYER_LAUNCHES[cfg.name]
    moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    return {"K1": k1 * cfg.n_layers * steps, "K3": k3 * cfg.n_layers * steps,
            "K4": 0, "K4g": k4g * moe * steps}


def longctx_phase(dev, hp):
    """Phase 17: the reference's long-context cells through
    ``launch/dryrun.py``'s ``run_cell(..., run=True)`` on ``dev``, every
    layer at its published width, random weights from seed 0. ``hp``
    holds main's helpers (``counts``, ``reset_counts``, ``check_equal``,
    ``profiled``, ``is_spin``, ``walls``, ``timer``) and phase 8's
    ``prompts``. Returns its record; raises on any failure."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core.bitserial import plan_spec
    from repro_torch.core.quant import qrange
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import GenRequest
    from repro_torch.models import attention, transformer
    from repro_torch.models.layers import pack_weight_codes
    from repro_torch.serving import ContinuousLMEngine

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    t_phase = time.perf_counter()
    gb = 1e9
    out = {"launches": {"K1": 0, "K3": 0, "K4": 0, "K4g": 0}, "cells": {}}

    def counted(fn, want=None, what=""):
        """``fn()`` with the counts reset just before and read just after;
        the launches join the phase's, and must equal ``want`` if given."""
        hp.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        got = {k: hp.counts()[k] for k in out["launches"]}
        for k in got:
            out["launches"][k] += got[k]
        if want is not None and got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        return res, got

    def cell(arch, shape, **kw):
        kw.setdefault("batch", 1)
        return dryrun.run_cell(arch, shape, run=True, device=dev,
                               return_outputs=True, cost=False, **kw)

    def profile_busy(fn):
        prof, wall = hp.profiled(fn)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not hp.is_spin(e.key)) / 1e3
        top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not hp.is_spin(e.key)), reverse=True)[:8]
        return {"wall_ms": wall * 1e3, "busy_ms": busy,
                "top": [{"ms": ms, "count": n, "name": k[:80]}
                        for ms, n, k in top]}

    # (a) every (architecture x shape) cell accounted on the meta device
    log("long context (a): every cell's bytes from its shapes (meta device; "
        "decode cells with a bf16 and an int8 cache)")
    table = []
    for arch in list_archs():
        for shape in get_arch(arch).shapes:
            for kv in ((None, 8) if dryrun.SHAPES[shape].kind == "decode"
                       else (None,)):
                rec = dryrun.run_cell(arch, shape, kv_bits=kv, device=dev,
                                      force=True, cost=False)
                table.append({k: rec[k] for k in (
                    "arch", "shape", "kv_bits", "bytes", "cache_bytes_per_row",
                    "fits", "rows_that_fit", "global_batch")})
                by = rec["bytes"]
                log(f"  {arch:24s} {shape:12s} kv {str(kv):4s} params "
                    f"{by['params'] / gb:8.2f} GB  adamw {by['adamw'] / gb:8.2f}"
                    f"  caches {by['caches'] / gb:8.2f} "
                    f"({rec['cache_bytes_per_row'] / gb:7.3f} a row)  total "
                    f"{by['total'] / gb:8.2f}  fits {rec['fits']!s:5s} rows "
                    f"{rec['rows_that_fit']} of {rec['global_batch']}")
    out["accounting"] = table

    # (b) chunked attention against the materialized one on the card
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn((1, CHUNK_CHECK_LEN, 32, 64), generator=g,
                           device=dev) for _ in range(3))
    got = attention.chunked_attention(q, k, v, causal=True)
    ref = attention._sdpa_full(q, k, v, causal=True, q_offset=0)
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, **CHUNK_TOL):
        raise AssertionError(f"chunked attention at {CHUNK_CHECK_LEN}: max "
                             f"abs error {err}, outside {CHUNK_TOL}")
    out["chunked_check"] = {
        "tokens": CHUNK_CHECK_LEN, "max_abs_err": err, "tol": CHUNK_TOL,
        "chunked_ms": hp.walls(lambda: attention.chunked_attention(
            q, k, v, causal=True), 3),
        "materialized_ms": hp.walls(lambda: attention._sdpa_full(
            q, k, v, causal=True, q_offset=0), 3)}
    log(f"long context (b): chunked_attention vs _sdpa_full at 1 x "
        f"{CHUNK_CHECK_LEN} x 32 heads x 64, float32: max abs error "
        f"{err:.3g} (within rtol 1e-4, atol 1e-5); "
        f"{out['chunked_check']['chunked_ms']:.2f} ms chunked, "
        f"{out['chunked_check']['materialized_ms']:.2f} ms materialized")
    del q, k, v, got, ref
    free()

    def plain_check(arch, shape, what, **kw):
        """At ``PLAIN_DEPTH`` layers of full width: the kernels' run
        against the plain versions' on the same weights, tokens and logits
        exactly; returns the kernels' record and outputs."""
        cfg = dryrun.build_cell(arch, shape, n_layers=PLAIN_DEPTH,
                                kv_bits=kw.get("kv_bits")).cfg
        steps = 1 if dryrun.SHAPES[shape].kind == "prefill" else kw.get(
            "new_tokens", 8)
        (rk, ok), _ = counted(lambda: cell(arch, shape, n_layers=PLAIN_DEPTH,
                                           **kw),
                              step_launches(cfg, steps), f"{what} kernels")
        (rp, op), _ = counted(lambda: cell(arch, shape, n_layers=PLAIN_DEPTH,
                                           plain=True, **kw),
                              {k: 0 for k in out["launches"]},
                              f"{what} plain")
        if (rk["run"]["tokens"] != rp["run"]["tokens"]
                or not torch.equal(ok["logits"], op["logits"])):
            raise AssertionError(f"{what}: the kernels' tokens or logits "
                                 "differ from the plain versions'")
        log(f"  {what}, {PLAIN_DEPTH} layers of full width: kernels equal "
            f"the plain versions (tokens and logits)")
        return rk, ok

    # (c) stablelm-1.6b prefill_32k, batch 1 at 32,768 tokens
    log(f"long context (c): {LONG_ARCH} prefill_32k, batch 1, chunked "
        "attention")
    rk, ok = plain_check(LONG_ARCH, "prefill_32k", "prefill_32k")
    prof2 = profile_busy(lambda: transformer.prefill(
        ok["server"].params, {"tokens": torch.zeros(
            (1, 32768), dtype=torch.int64, device=dev)}, ok["server"].cfg,
        max_len=32776))
    del ok
    free()
    cfg = dryrun.build_cell(LONG_ARCH, "prefill_32k").cfg
    (rec, o), got = counted(lambda: cell(LONG_ARCH, "prefill_32k"),
                            step_launches(cfg, 1), "prefill_32k")
    logits = o["logits"]
    if (logits.shape != (1, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill_32k: bad logits {logits.shape}")
    out["cells"]["stablelm_prefill_32k"] = {**rec, "launches": got,
                                            "profile_2_layers": prof2}
    log(f"  {cfg.n_layers} layers: prefill {rec['run']['prefill_s']:.2f} s, "
        f"peak {rec['run']['peak_bytes'] / gb:.2f} GB, launches {got} (K1 "
        f"and K3 at M = 32768); 2 layers profiled: wall "
        f"{prof2['wall_ms']:.0f} ms, busy {prof2['busy_ms']:.0f} ms")
    del o, logits
    free()

    # (d) decode_32k: Server(batch_slots=4, max_len=32768), bf16 and int8
    log(f"long context (d): {LONG_ARCH} decode_32k, Server(batch_slots=4, "
        "max_len=32768) on phase 8's four requests, bf16 and int8 caches")
    dec, prefill_logits = {}, {}
    for kv in (None, 8):
        cfg = dryrun.build_cell(LONG_ARCH, "decode_32k", kv_bits=kv).cfg
        (rec, o), got = counted(
            lambda: cell(LONG_ARCH, "decode_32k", batch=4, kv_bits=kv,
                         prompts=hp.prompts, new_tokens=LM_NEW),
            step_launches(cfg, LM_NEW), f"decode_32k kv {kv}")
        srv = o["server"]
        toks_in = np.zeros((4, max(LM_PROMPTS)), np.int64)
        for i, pr in enumerate(hp.prompts):
            toks_in[i, -len(pr):] = pr
        with torch.inference_mode():
            lg, caches = transformer.prefill(srv.params, {
                "tokens": torch.from_numpy(toks_in).to(dev)}, srv.cfg,
                max_len=srv.max_len)
            tok = torch.argmax(lg, -1)[:, None]
            prof = profile_busy(lambda: transformer.decode_step(
                srv.params, caches, tok, max(LM_PROMPTS), srv.cfg))
        dec[kv] = {**rec, "launches": got, "profile_step": prof}
        prefill_logits[kv] = lg.float()
        log(f"  kv_bits {kv}: cache {rec['run']['cache_bytes_run'] / gb:.2f} "
            f"GB ({rec['cache_bytes_per_row'] / gb:.3f} a row), prefill "
            f"{rec['run']['prefill_s'] * 1e3:.1f} ms, decode step median "
            f"{rec['run']['decode_step_s_median'] * 1e3:.2f} ms wall, one "
            f"step profiled: wall {prof['wall_ms']:.2f} busy "
            f"{prof['busy_ms']:.2f} ms; peak "
            f"{rec['run']['peak_bytes'] / gb:.2f} GB")
        del o, srv, lg, caches, tok
        free()
    # how far int8 moves the prefill's logits, beside the bf16 logits'
    # gap between their two largest (a random model's are near ties)
    lb, l8 = prefill_logits[None], prefill_logits[8]
    top2 = torch.topk(lb, 2, dim=-1).values
    logit_shift = {
        "max_abs_diff": float((l8 - lb).abs().max()),
        "max_abs_logit": float(lb.abs().max()),
        "bf16_top2_gap": (top2[:, 0] - top2[:, 1]).tolist(),
        "argmax_equal": (lb.argmax(-1) == l8.argmax(-1)).tolist()}
    del lb, l8, prefill_logits
    t16, t8 = dec[None]["run"]["tokens"], dec[8]["run"]["tokens"]
    agree = [sum(a == b for a, b in zip(x, y)) / len(x)
             for x, y in zip(t16, t8)]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(t16, t8)]
    out["cells"]["stablelm_decode_32k"] = {
        "bf16": dec[None], "int8": dec[8], "int8_token_agreement": agree,
        "int8_first_difference": first, "int8_prefill_logits": logit_shift}
    log(f"  int8 tokens against bf16 (reported, not held: int8 is lossy): "
        f"agreement {agree}, first difference at {first}; the prefill's "
        f"logits move by at most {logit_shift['max_abs_diff']:.4f} (largest "
        f"|logit| {logit_shift['max_abs_logit']:.3f}) against bf16 top-2 "
        f"gaps {[round(x, 4) for x in logit_shift['bf16_top2_gap']]}")

    # the engine on an int8 cache, its bucketed prefill chunked
    ecfg = dataclasses.replace(
        dryrun.build_cell(LONG_ARCH, "decode_32k", kv_bits=8).cfg,
        use_chunked_attn=True)
    eng = ContinuousLMEngine(ecfg, batch_slots=4, max_len=32768, seed=0,
                             device=dev)

    def serve():
        res = eng.serve([GenRequest(p.copy(), LM_NEW) for p in hp.prompts])
        return [r.out_tokens for r in res]

    # the arena made and its step captured outside the counted runs (a
    # capture records launches that do not run); the replays then add the
    # captured step's launches each
    eng._fresh_arena()
    step = eng.stats()["step_launches"]
    if step != {"K1": 96, "K3": 168, "K4": 0, "K4g": 0}:
        raise AssertionError(f"engine int8: step launches {step}")
    graphed, _ = counted(serve, step_launches(ecfg, len(hp.prompts)),
                         "engine int8 prefills")
    em = eng.engine_metrics()
    replays = em["decode_steps"]
    for k in ("K1", "K3"):
        out["launches"][k] += step[k] * replays
    arena = eng._arena["caches"][0]
    if arena["k_q"].dtype != torch.int8:
        raise AssertionError("engine arena is not int8")
    arena_bytes = sum(t.numel() * t.element_size()
                      for c in eng._arena["caches"] for t in c.values()
                      if torch.is_tensor(t))
    del arena
    # every row has left, so a replay moves no token or position
    replay_ms = hp.walls(eng._graph.replay, 3)
    replay_prof = profile_busy(eng._graph.replay)
    eng._graph = None
    eng._arena = None
    free()
    eng._fresh_arena()
    eng._graph = None
    eager, _ = counted(serve)
    if graphed != eager:
        raise AssertionError(f"engine int8: the graph's tokens {graphed} "
                             f"differ from its eager steps' {eager}")
    out["cells"]["engine_int8_32k"] = {
        "tokens": graphed, "step_wall_ms": em["step_wall_seconds"] / replays
        * 1e3, "decode_steps": replays, "capture_s": eng.capture_seconds,
        "step_launches": step, "arena_bytes": arena_bytes,
        "replay_ms": replay_ms, "replay_profile": replay_prof}
    log(f"  ContinuousLMEngine(kv_bits=8, chunked prefill, 4 x 32768 "
        f"slots): graph tokens equal its eager steps'; a replay {replay_ms:.2f}"
        f" ms wall (synchronized), {replay_prof['busy_ms']:.2f} ms busy; "
        f"{out['cells']['engine_int8_32k']['step_wall_ms']:.2f} ms host time "
        f"per replay in serve ({replays} steps), arena "
        f"{arena_bytes / gb:.2f} GB")
    del eng
    free()

    # (e) train_4k: one step at 1 x 4096, chunked attention under remat
    log(f"long context (e): {LONG_ARCH} train_4k, one step at 1 x 4096, "
        "chunked attention under remat")
    (rec, o), got = counted(lambda: cell(LONG_ARCH, "train_4k"))
    del o
    free()
    r = rec["run"]
    if not r["loss_finite"] or r["leaves_moved"] != r["leaves"]:
        raise AssertionError(f"train_4k: loss {r['loss']}, moved "
                             f"{r['leaves_moved']} of {r['leaves']} leaves")
    out["cells"]["stablelm_train_4k"] = rec
    log(f"  loss {r['loss']:.4f}, every leaf moved ({r['leaves']}), step "
        f"{r['step_s']:.2f} s, peak {r['peak_bytes'] / gb:.2f} GB")

    # (f) deepseek-v2-lite-16b prefill_32k: MLA chunked, grouped K4 at
    # C = 3840 rows per expert
    ds = "deepseek-v2-lite-16b"
    log(f"long context (f): {ds} prefill_32k, batch 1; grouped K4 at C = "
        f"{GROUPED_C}")
    dcfg = get_arch(ds).full
    spec = plan_spec(dcfg.policy.spec())
    la, ha = qrange(spec.a_bits, spec.a_signed)
    lw, hw = qrange(spec.w_bits, spec.w_signed)
    grouped = []
    for kk, nn in ((2048, 1408), (1408, 2048)):
        wp = torch.stack([pack_weight_codes(torch.randint(
            lw, hw + 1, (kk, nn), generator=g, device=dev,
            dtype=torch.int32), spec.w_bits) for _ in range(64)])
        x = torch.randint(la, ha + 1, (64, GROUPED_C, kk), generator=g,
                          device=dev, dtype=torch.int32)
        hp.check_equal("K4g", f"E64 C{GROUPED_C} {kk}->{nn}",
                       km.bitserial_matmul_grouped_cuda(x, wp, spec=spec,
                                                        k=kk),
                       km.bitserial_matmul_grouped_ref(x, wp, spec=spec,
                                                       k=kk))
        byt = (wp.numel() + x.numel() + 64 * GROUPED_C * nn) * 4
        ops = 2 * 64 * GROUPED_C * kk * nn
        grouped.append({"k": kk, "n": nn, "c": GROUPED_C, "ms": hp.timer(
            lambda: km.bitserial_matmul_grouped_cuda(x, wp, spec=spec, k=kk),
            10), "bound_ms": max(byt / HBM_BYTES_PER_S,
                                 ops / INT8_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if byt / HBM_BYTES_PER_S
                         > ops / INT8_OPS_PER_S else "operations")})
        log(f"  grouped K4 E64 C{GROUPED_C} {kk}->{nn}: "
            f"{grouped[-1]['ms']:.3f} ms, bound {grouped[-1]['bound_ms']:.3f}"
            f" ms ({grouped[-1]['bound_by']}; cold Timer)")
        del wp, x
    free()
    rk, ok = plain_check(ds, "prefill_32k", "deepseek prefill_32k")
    del ok
    free()
    cfg = dryrun.build_cell(ds, "prefill_32k").cfg
    (rec, o), got = counted(lambda: cell(ds, "prefill_32k"),
                            step_launches(cfg, 1), "deepseek prefill_32k")
    if not bool(torch.isfinite(o["logits"]).all()):
        raise AssertionError("deepseek prefill_32k: non-finite logits")
    out["cells"]["deepseek_prefill_32k"] = {**rec, "launches": got,
                                            "grouped_calls": grouped}
    log(f"  {cfg.n_layers} layers: prefill {rec['run']['prefill_s']:.2f} s, "
        f"peak {rec['run']['peak_bytes'] / gb:.2f} GB, launches {got}")
    del o
    free()

    # (g) hymba-1.5b long_500k: Server(batch_slots=1, max_len=524288)
    hy = "hymba-1.5b"
    log(f"long context (g): {hy} long_500k, Server(batch_slots=1, "
        "max_len=524288), bf16 and int8 (3 global layers of 524,288 slots, "
        "29 rolling of 1,024)")
    hcfg = get_arch(hy).full
    prompt = [np.random.RandomState(0).randint(
        0, hcfg.vocab_size, (max(LM_PROMPTS),)).astype(np.int32)]
    lng = {}
    for kv in (None, 8):
        plain_check(hy, "long_500k", f"long_500k kv {kv}", kv_bits=kv,
                    prompts=prompt, new_tokens=LONG_NEW)
        free()
        cfg = dryrun.build_cell(hy, "long_500k", kv_bits=kv).cfg
        (rec, o), got = counted(
            lambda: cell(hy, "long_500k", kv_bits=kv, prompts=prompt,
                         new_tokens=LONG_NEW),
            step_launches(cfg, LONG_NEW), f"long_500k kv {kv}")
        srv = o["server"]
        with torch.inference_mode():
            toks_in = torch.from_numpy(prompt[0][None].astype(np.int64)).to(
                dev)
            lg, caches = transformer.prefill(srv.params, {"tokens": toks_in},
                                             srv.cfg, max_len=srv.max_len)
            tok = torch.argmax(lg, -1)[:, None]
            prof = profile_busy(lambda: transformer.decode_step(
                srv.params, caches, tok, len(prompt[0]), srv.cfg))
        lng[kv] = {**rec, "launches": got, "profile_step": prof}
        log(f"  kv_bits {kv}: cache {rec['run']['cache_bytes_run'] / gb:.2f} "
            f"GB, prefill {rec['run']['prefill_s'] * 1e3:.1f} ms, decode step "
            f"median {rec['run']['decode_step_s_median'] * 1e3:.2f} ms wall, "
            f"one step profiled: wall {prof['wall_ms']:.2f} busy "
            f"{prof['busy_ms']:.2f} ms; peak "
            f"{rec['run']['peak_bytes'] / gb:.2f} GB")
        del o, srv, lg, caches, tok
        free()
    a, b = lng[None]["run"]["tokens"][0], lng[8]["run"]["tokens"][0]
    out["cells"]["hymba_long_500k"] = {
        "bf16": lng[None], "int8": lng[8],
        "int8_token_agreement": sum(x == y for x, y in zip(a, b)) / len(a)}
    log(f"  int8 tokens against bf16 (reported): agreement "
        f"{out['cells']['hymba_long_500k']['int8_token_agreement']:.3f}")

    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# phase 18: training every family the reference trains, at full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 8
VLM_LAYERS = 2           # internvl2-76b's trained depth (of 80)
VLM_ROWS = 4             # its make_train_step batch: 256 patches + 64 tokens
#: the train_4k cells: (arch, remat policy); a "dots" cell is held to the
#: "nothing" cell of its arch run before it
TRAIN_4K = (("mamba2-780m", "nothing"), ("mamba2-780m", "dots"),
            ("hymba-1.5b", "nothing"), ("seamless-m4t-large-v2", "nothing"),
            ("stablelm-1.6b", "nothing"), ("stablelm-1.6b", "dots"))


def train_families_phase(dev, hp):
    """Phase 18: every family the reference trains, trained on ``dev`` at
    its published widths (bf16 compute, float32 params, W4A8 ``qat``,
    random weights from seed 0), then evaluated and served packed through
    K1 + K3. ``hp`` holds main's helpers (``counts``, ``reset_counts``,
    ``device_profile``). Returns its record; raises on any failure."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import GenRequest, Server
    from repro_torch.launch.train import Trainer, make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault_tolerance import FailureInjector

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    t_phase = time.perf_counter()
    gb = 1e9
    out = {"launches": {"K1": 0, "K3": 0},
           "held_gb_at_start": torch.cuda.memory_allocated() / gb}
    log(f"  {out['held_gb_at_start']:.2f} GB held on the card before the "
        f"phase")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)

    def counted(fn, want, what):
        """``fn()`` with the counts reset just before and read just after,
        held to ``want``; the launches join the phase's."""
        hp.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        got = hp.counts()
        if got != {"K2": 0, "K4": 0, "K4g": 0, **want}:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        for k in out["launches"]:
            out["launches"][k] += got[k]
        return res

    def unmoved(new, old):
        """The leaves of ``new`` equal to ``old``'s, by index."""
        return [i for i, (a, b) in enumerate(zip(tree_leaves(new),
                                                 tree_leaves(old)))
                if torch.equal(a, b)]

    def drawn(cfg):
        return transformer.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)

    def packed_eval(cfg, params, batch, want, what):
        """``loss_fn`` on the packed params through K1 + K3 against the
        plain versions on the same packed params, bit for bit; the
        fake-quant CE beside the integer CE."""
        scfg = transformer.serve_policy(cfg, pack_acts=True)
        packed = transformer.pack_params(params, scfg)
        with torch.no_grad():
            l_q, aux_q = counted(lambda: transformer.loss_fn(packed, batch,
                                                             scfg),
                                 want, what)
            hp.reset_counts()
            l_p, aux_p = transformer.loss_fn(
                packed, batch, transformer.serve_policy(scfg, plain=True))
            torch.cuda.synchronize()
            if any(hp.counts().values()):
                raise AssertionError(f"{what}: the plain run launched "
                                     f"{hp.counts()}")
            l_f, aux_f = transformer.loss_fn(params, batch, cfg)
        if (not torch.equal(l_q, l_p)
                or not torch.equal(aux_q["ce"], aux_p["ce"])):
            raise AssertionError(f"{what}: packed loss {float(l_q)!r} vs "
                                 f"plain {float(l_p)!r}")
        ce_f, ce_q = float(aux_f["ce"]), float(aux_q["ce"])
        if not (np.isfinite(ce_f) and np.isfinite(ce_q)):
            raise AssertionError(f"{what}: CE {ce_f} / {ce_q}")
        return {"launches": want, "loss_integer": float(l_q),
                "ce_fake_quant": ce_f, "ce_integer": ce_q,
                "gap": ce_q - ce_f}

    def same_grads(cfg, params, batch):
        """The gradients of two identical forward-backward passes, equal
        bit for bit (the SSD scan's group indexing sums in its backward)."""
        leaves, treedef = tree_flatten(params)
        runs = []
        for _ in range(2):
            ls = [l.detach().requires_grad_(True) for l in leaves]
            with torch.enable_grad():
                loss, _ = transformer.loss_fn(tree_unflatten(treedef, ls),
                                              batch, cfg)
                runs.append((loss.detach(), torch.autograd.grad(loss, ls)))
            del ls
        (l0, g0), (l1, g1) = runs
        diff = [i for i, (a, b) in enumerate(zip(g0, g1))
                if not torch.equal(a, b)]
        if not torch.equal(l0, l1) or diff:
            raise AssertionError(f"{cfg.name}: two identical steps differ "
                                 f"(loss {float(l0)!r} / {float(l1)!r}, "
                                 f"gradient leaves {diff})")
        return len(g0)

    # (a), (b): mamba2-780m and hymba-1.5b through Trainer at full depth
    for tag, arch in (("a", "mamba2-780m"), ("b", "hymba-1.5b")):
        cfg = get_arch(arch).full
        # one forward's launches on the packed path: phase 15's per step
        k1_fwd = len(SSM_SLICE[arch]["k1"]) * cfg.n_layers
        k3_fwd = sum(c for _, c in SSM_SLICE[arch]["gemms"]) * cfg.n_layers
        if not (cfg.remat and cfg.remat_policy == "nothing"
                and cfg.policy.mode == "qat"):
            raise AssertionError(f"training config {cfg}")
        log(f"train families ({tag}): Trainer({arch} FULL, {cfg.n_layers} "
            f"layers, bf16 compute, float32 params, W4A8 qat, remat "
            f"'nothing', batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, seed 0), "
            f"AdamW lr 3e-4, warmup 2, {TRAIN_STEPS} steps")
        trainer = Trainer(cfg, opt_cfg=opt, batch_size=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, seed=0, device=dev)
        n_leaves = same_grads(cfg, drawn(cfg), trainer.device_batch(
            trainer.data.batch(0, TRAIN_BATCH)))
        free()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, losses = counted(lambda: trainer.run(TRAIN_STEPS,
                                                    log_every=TRAIN_STEPS),
                                {"K1": 0, "K3": 0}, f"{arch} training")
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        init = drawn(cfg)
        hist = trainer.history
        gnorms = [h["grad_norm"] for h in hist]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses
                                                             + gnorms)):
            raise AssertionError(f"{arch}: losses {losses}, grad norms "
                                 f"{gnorms}")
        still = unmoved(state["params"], init)
        still += [f"{k}{i}" for k in ("m", "v")
                  for i, t in enumerate(tree_leaves(state["opt"][k]))
                  if not bool(t.any())]
        n_alpha = n_alphas(state["params"])
        del init
        if still or int(state["opt"]["step"]) != TRAIN_STEPS:
            raise AssertionError(f"{arch}: leaves that did not move {still}")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        step_ms = [h["seconds"] * 1e3 for h in hist[2:]]
        med = statistics.median(step_ms)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        step_fn = make_train_step(cfg, opt)
        pbatch = trainer.device_batch(trainer.data.batch(TRAIN_STEPS,
                                                         TRAIN_BATCH))
        parts = ("train_step.forward", "train_step.backward",
                 "train_step.adamw") + SSM_RANGES
        prof = counted(lambda: hp.device_profile(
            lambda: step_fn(state, pbatch), ranges=parts),
            {"K1": 0, "K3": 0}, f"{arch} profiled step")
        split = {k.split(".")[1]: v for k, v in prof["ranges"].items()}
        rec = dict(layers=cfg.n_layers, n_params=n_params,
                   leaves=len(tree_leaves(state["params"])),
                   alpha_leaves=n_alpha, same_grads_leaves=n_leaves,
                   losses=losses, grad_norms=gnorms,
                   step_ms=[h["seconds"] * 1e3 for h in hist],
                   step_ms_median_from_2=med,
                   tokens_per_s=tokens / (med / 1e3), run_s=run_s,
                   peak_gb=peak / gb, profiled_step=prof, split_ms=split,
                   scan_share=split["scan"]["busy"] / prof["device_ms"],
                   conv_share=split["conv"]["busy"] / prof["device_ms"])
        log(f"  two identical forward-backward passes: loss and all "
            f"{n_leaves} gradients equal bit for bit")
        log(f"  {n_params / 1e9:.4f} B params; losses "
            + " ".join(f"{l:.4f}" for l in losses) + "; grad norms "
            + " ".join(f"{g:.3f}" for g in gnorms))
        log(f"  every float leaf moved ({rec['leaves']}, {n_alpha} LSQ "
            f"step-size leaves among them); step (synchronized) from step "
            f"2: median {med:.1f} ms (" + " ".join(f"{t:.1f}"
                                                  for t in step_ms)
            + f"); {rec['tokens_per_s']:.0f} training tokens/s; peak "
            f"{peak / gb:.2f} GB above what was held; {run_s:.1f} s for "
            f"the {TRAIN_STEPS} steps with init")
        log(f"  one profiled step: wall {prof['wall_ms']:.1f} ms, device "
            f"busy {prof['device_ms']:.1f} ms over {prof['kernels']:.0f} "
            f"kernels; " + "; ".join(
                f"{k} issued {v['issued']:.1f}, done {v['done']:.1f}, busy "
                f"{v['busy']:.1f}" for k, v in split.items())
            + f"; ssm.scan {rec['scan_share']:.1%} and ssm.conv "
            f"{rec['conv_share']:.1%} of busy (forward and the backward's "
            f"recompute)")
        for name, ms_ in list(prof["by_name_ms"].items())[:6]:
            log(f"    {ms_:8.2f} ms  x{prof['launches'][name]:5.0f}  "
                f"{name[:90]}")
        del step_fn, pbatch
        free()

        # the trained weights: packed evaluation, then Server
        hb = trainer.device_batch(trainer.data.batch(10_001, TRAIN_BATCH))
        rec["eval"] = packed_eval(cfg, state["params"], hb,
                                  {"K1": k1_fwd, "K3": k3_fwd},
                                  f"{arch} packed evaluation")
        log(f"  held-out batch (SyntheticLM.batch(10_001, 8)): loss "
            f"through K1 + K3 {rec['eval']['loss_integer']!r} equals the "
            f"plain versions' bit for bit ({k1_fwd} K1 + {k3_fwd} K3); CE "
            f"fake-quant {rec['eval']['ce_fake_quant']:.4f}, integer "
            f"{rec['eval']['ce_integer']:.4f}, gap "
            f"{rec['eval']['gap']:+.4f}")
        # phase 8's four requests, from the model's vocabulary (phase 15's)
        prng = np.random.RandomState(0)
        prompts = [prng.randint(0, cfg.vocab_size, (ln,)).astype(np.int32)
                   for ln in LM_PROMPTS]
        reqs = lambda: [GenRequest(p.copy(), LM_NEW) for p in prompts]
        srv = Server(cfg, state["params"], batch_slots=4,
                     max_len=LM_MAX_LEN, device=dev)
        got = counted(lambda: [r.out_tokens for r in srv.generate(reqs())],
                      {"K1": k1_fwd * LM_NEW, "K3": k3_fwd * LM_NEW},
                      f"{arch} trained Server")
        plain = Server(cfg, srv.params, batch_slots=4, max_len=LM_MAX_LEN,
                       plain=True, device=dev)
        ref = [r.out_tokens for r in plain.generate(reqs())]
        if ref != got or not torch.equal(plain.last_logits,
                                         srv.last_logits):
            raise AssertionError(f"{arch} trained Server: tokens/logits "
                                 "differ from the plain run")
        rec["server_tokens"] = got
        log(f"  Server on the trained weights, phase 8's four requests: "
            f"tokens and last-step logits equal the plain run's "
            f"({k1_fwd * LM_NEW} K1 + {k3_fwd * LM_NEW} K3); request 0 "
            f"{got[0][:8]}...")
        out[arch] = rec
        del srv, plain, state, trainer, hb
        free()

    # (c) internvl2-76b at 2 of 80 layers, every width kept
    full = get_arch("internvl2-76b").full
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    log(f"train families (c): internvl2-76b at {VLM_LAYERS} of "
        f"{full.n_layers} layers, every width kept: make_train_step "
        f"(donated) on {VLM_ROWS} rows of {cfg.frontend_len} seeded patches "
        f"({cfg.frontend_dim} -> {cfg.d_model}) and {TRAIN_SEQ} tokens")
    free()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    params = drawn(cfg)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    rng = np.random.default_rng(18)

    def seeded(cfg, rows, extra, shape):
        """Tokens and labels (rows x 64) and the patches or the source,
        drawn from ``rng``: the step's batch, then a held-out one."""
        b = {extra: torch.from_numpy(rng.standard_normal(
            (rows,) + shape).astype(np.float32)).to(dev, torch.bfloat16)}
        for k in ("tokens", "labels"):
            b[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (rows, TRAIN_SEQ))).to(dev)
        return b

    vshape = (cfg.frontend_len, cfg.frontend_dim)
    vb = seeded(cfg, VLM_ROWS, "frontend_embeds", vshape)
    step_fn = make_train_step(cfg, opt, donate=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = counted(lambda: step_fn(state, vb), {"K1": 0, "K3": 0},
                       "internvl2 training")
    vlm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    loss = float(m["loss"])
    free()
    init = drawn(cfg)
    still = unmoved(state["params"], init)
    del init
    free()
    if not np.isfinite(loss) or still:
        raise AssertionError(f"internvl2: loss {loss}, leaves that did not "
                             f"move {still}")
    rec = {"layers": VLM_LAYERS, "loss": loss,
           "grad_norm": float(m["grad_norm"]), "step_s": vlm_s,
           "peak_gb": peak / gb,
           "n_params": sum(p.numel() for p in tree_leaves(state["params"])),
           "frontend_proj_grad_moved": True}
    log(f"  loss {loss:.4f}, grad norm {rec['grad_norm']:.3f}; every leaf "
        f"moved, frontend_proj's included; {rec['n_params'] / 1e9:.3f} B "
        f"params, the step {vlm_s:.2f} s, peak {peak / gb:.2f} GB above "
        f"what was held")
    want = {k: family_launches(cfg, "prefill")[k] for k in ("K1", "K3")}
    rec["eval"] = packed_eval(cfg, state["params"],
                              seeded(cfg, VLM_ROWS, "frontend_embeds", vshape),
                              want, "internvl2 packed evaluation")
    log(f"  packed evaluation with held-out patches and tokens: loss through "
        f"K1 + K3 "
        f"{rec['eval']['loss_integer']!r} equals the plain versions' bit "
        f"for bit ({want['K1']} K1 + {want['K3']} K3); CE fake-quant "
        f"{rec['eval']['ce_fake_quant']:.4f}, integer "
        f"{rec['eval']['ce_integer']:.4f}")
    del state, vb, step_fn
    free()
    trainer = Trainer(cfg, opt_cfg=opt, batch_size=VLM_ROWS,
                      seq_len=TRAIN_SEQ, seed=0, device=dev)
    t0 = time.perf_counter()
    state, losses = counted(lambda: trainer.run(2, log_every=100),
                            {"K1": 0, "K3": 0}, "internvl2 Trainer")
    if len(losses) != 2 or not all(np.isfinite(losses)):
        raise AssertionError(f"internvl2 Trainer: losses {losses}")
    rec["trainer_losses"] = losses
    rec["trainer_s"] = time.perf_counter() - t0
    log(f"  Trainer text-only, 2 steps: losses "
        + " ".join(f"{l:.4f}" for l in losses)
        + f" ({rec['trainer_s']:.1f} s with init)")
    out["internvl2-76b"] = rec
    del state, trainer
    free()

    # (d) seamless-m4t-large-v2, 24 + 24 layers, on a seeded source
    cfg = get_arch("seamless-m4t-large-v2").full
    log(f"train families (d): seamless-m4t-large-v2 FULL ({cfg.n_enc_layers}"
        f" + {cfg.n_layers} layers): make_train_step on seeded src_embeds "
        f"({TRAIN_BATCH} x {TRAIN_SEQ} x {cfg.frontend_dim}) and "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    try:
        Trainer(cfg, opt_cfg=opt, device=dev)
        raise AssertionError("Trainer took an encoder-decoder config")
    except ValueError as e:
        refusal = str(e)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    params = drawn(cfg)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    sshape = (TRAIN_SEQ, cfg.frontend_dim)
    sb = seeded(cfg, TRAIN_BATCH, "src_embeds", sshape)
    step_fn = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m = counted(lambda: step_fn(state, sb), {"K1": 0, "K3": 0},
                     "seamless training")
    sm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    loss = float(m["loss"])
    still = unmoved(new["params"], state["params"])
    n_enc = len(tree_leaves(new["params"]["enc"]))
    if not np.isfinite(loss) or still:
        raise AssertionError(f"seamless: loss {loss}, leaves that did not "
                             f"move {still}")
    rec = {"loss": loss, "grad_norm": float(m["grad_norm"]), "step_s": sm_s,
           "peak_gb": peak / gb, "leaves": len(tree_leaves(new["params"])),
           "encoder_leaves": n_enc, "trainer_refusal": refusal}
    log(f"  Trainer refuses it: ValueError({refusal[:80]}...); loss "
        f"{loss:.4f}, every leaf moved ({rec['leaves']}, {n_enc} of the "
        f"encoder's), the step {sm_s:.2f} s, peak {peak / gb:.2f} GB")
    del state
    want = {k: family_launches(cfg, "prefill")[k] for k in ("K1", "K3")}
    rec["eval"] = packed_eval(cfg, new["params"],
                              seeded(cfg, TRAIN_BATCH, "src_embeds", sshape),
                              want, "seamless packed evaluation")
    log(f"  packed evaluation with a held-out source and tokens: loss "
        f"through K1 + K3 "
        f"{rec['eval']['loss_integer']!r} equals the plain versions' bit "
        f"for bit ({want['K1']} K1 + {want['K3']} K3); CE fake-quant "
        f"{rec['eval']['ce_fake_quant']:.4f}, integer "
        f"{rec['eval']['ce_integer']:.4f}")
    out["seamless-m4t-large-v2"] = rec
    del new, sb, step_fn
    free()

    # (e) train_4k through dryrun.run_cell at 1 x 4096, chunked attention
    log("train families (e): train_4k cells through dryrun.run_cell at 1 x "
        "4096 (chunked attention, remat); a 'dots' cell's new params held "
        "to the 'nothing' cell's bit for bit")
    cells, kept = {}, {}
    for arch, pol in TRAIN_4K:
        free()
        (r, o) = counted(lambda: dryrun.run_cell(
            arch, "train_4k", run=True, batch=1, device=dev,
            remat_policy=pol, return_outputs=True, cost=False),
            {"K1": 0, "K3": 0}, f"{arch} train_4k {pol}")
        run = r["run"]
        if not run["loss_finite"] or run["leaves_moved"] != run["leaves"]:
            raise AssertionError(f"{arch} train_4k {pol}: loss "
                                 f"{run['loss']}, moved "
                                 f"{run['leaves_moved']} of {run['leaves']}")
        new_p = tree_leaves(o["state"]["params"])
        if pol == "nothing":
            kept[arch] = [t.cpu() for t in new_p]
        else:
            diff = [i for i, (a, b) in enumerate(zip(new_p, kept[arch]))
                    if not torch.equal(a.cpu(), b)]
            if diff:
                raise AssertionError(f"{arch} train_4k: 'dots' params differ "
                                     f"from 'nothing' at leaves {diff}")
            del kept[arch]
        del o, new_p
        cells[f"{arch}:{pol}"] = r
        log(f"  {arch} {pol}: loss {run['loss']:.4f}, every leaf moved "
            f"({run['leaves']}), step {run['step_s']:.2f} s, peak "
            f"{run['peak_bytes'] / gb:.2f} GB (rows that fit by the "
            f"accounting: {r.get('rows_that_fit')})"
            + ("; new params equal the 'nothing' run's bit for bit"
               if pol == "dots" else ""))
    out["train_4k"] = cells
    free()

    # (f) a supervised mamba2 run at 2 layers of full width, resumed
    cfg = dataclasses.replace(get_arch("mamba2-780m").full, n_layers=2)
    log("train families (f): mamba2-780m at 2 layers of full width, 4 steps "
        "supervised (save_every 2, a failure injected at step 3) against "
        "an uninterrupted run and the step run out of place")
    clean = Trainer(cfg, opt_cfg=opt, batch_size=TRAIN_BATCH,
                    seq_len=TRAIN_SEQ, seed=0, device=dev)
    state_c, losses_c = clean.run(4, log_every=100)
    step_fn = make_train_step(cfg, opt)
    st = clean.init_state()
    for s in range(4):
        st, _ = step_fn(st, clean.device_batch(clean.data.batch(
            s, TRAIN_BATCH)))
    oop = [i for i, (a, b) in enumerate(zip(tree_leaves(st),
                                            tree_leaves(state_c)))
           if not torch.equal(a, b)]
    del st, step_fn
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        sup = Trainer(cfg, opt_cfg=opt, ckpt_dir=tmp,
                      batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0,
                      save_every=2, device=dev)
        sup.ckpt = CheckpointManager(tmp, max_to_keep=1)
        t0 = time.perf_counter()
        state_f, losses_f = sup.run(4, injector=FailureInjector(
            fail_at_steps=(3,)), log_every=100)
        sup_s = time.perf_counter() - t0
        steps_kept = sup.ckpt.all_steps()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_losses = losses_c[:3] + losses_c[2:]
    same = [torch.equal(x, y) and x.dtype == y.dtype
            for x, y in zip(tree_leaves(state_c), tree_leaves(state_f))]
    if (losses_f != want_losses or not all(same) or steps_kept != [4]
            or oop):
        raise AssertionError(
            f"mamba2 resume: losses {losses_f} vs {want_losses}, "
            f"{same.count(False)} leaves differ, steps kept {steps_kept}; "
            f"out of place differs at {oop}")
    out["resume"] = {"losses": losses_f, "leaves": len(same),
                     "supervised_s": sup_s}
    log(f"  losses " + " ".join(f"{l:.4f}" for l in losses_f)
        + f" equal the uninterrupted run's, the final state ({len(same)} "
        f"leaves) bit for bit, and the donated steps equal the steps run "
        f"out of place; {sup_s:.1f} s for the supervised run")
    del state_c, state_f, clean, sup
    free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# --------------------------------------------------------------------------
# phase 19: array scaling — a compiled Program across four MVU banks, each
# bank a CUDA stream of its own on the one card
# --------------------------------------------------------------------------

N_BANKS = 4
ARRAY_BURST = 120        # requests per burst; each burst runs twice
ARRAY_SIZES = (1, 3, 17, 32, 6, 2, 11, 8)   # the burst's submits, cycled
# deepseek-v2-lite-16b's MoE widths: d_model, d_ff_expert, experts, top-k,
# shared experts
DEEPSEEK_MOE = (2048, 1408, 64, 6, 2)
GPIPE_LAYERS, GPIPE_D, GPIPE_ROWS = 24, 2048, 32


def stream_overlap(prof, is_spin):
    """The card's kernels in a profiler window: their summed ms, the ms of
    the union of their intervals (busy), the streams they ran on, and the
    ms during which kernels of two or more distinct streams ran at once
    (a sweep over the intervals with their stream ids). Raises when the
    profiler's events carry no stream id."""
    from torch.autograd import DeviceType
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or is_spin(e.name()):
            continue
        if not hasattr(e, "device_resource_id"):
            raise AssertionError("the profiler's device events carry no "
                                 "stream id")
        if e.end_ns() > e.start_ns():
            spans.append((e.start_ns(), e.end_ns(), e.device_resource_id()))
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    # at equal times an end comes before a start: touching kernels do not
    # overlap
    edges = sorted([(a, 1, s) for a, _, s in spans]
                   + [(b, -1, s) for _, b, s in spans],
                   key=lambda t: (t[0], t[1]))
    active, busy, multi, t_prev = {}, 0, 0, edges[0][0]
    for t, step, stream in edges:
        if active:
            busy += t - t_prev
        if len(active) >= 2:
            multi += t - t_prev
        t_prev = t
        active[stream] = active.get(stream, 0) + step
        if not active[stream]:
            del active[stream]
    return {"sum_ms": sum(b - a for a, b, _ in spans) / 1e6,
            "busy_ms": busy / 1e6, "multi_stream_ms": multi / 1e6,
            "streams": len({s for _, _, s in spans}),
            "kernels": len(spans)}


def array_phase(dev, hp):
    """Phase 19: full-width ResNet9 W2A2 on ``N_BANKS`` banks of one card
    (four streams of ``cuda:0``), through K1 and K2. ``hp`` carries
    ``counts``, ``reset_counts``, ``check_equal``, ``profiled`` and
    ``is_spin`` from ``main``. Returns the phase's record; its
    ``launches`` are the main paths' (the sharded and pipelined Programs,
    the two services' bursts, the MoE layers), comparisons left out."""
    import threading

    import numpy as np
    import torch

    from repro_torch.compiler import executor
    from repro_torch.core.pipeline_modules import disable_tf32
    from repro_torch.distributed import program_parallel as pp
    from repro_torch.distributed.pipeline_parallel import gpipe, stage_stack
    from repro_torch.launch.serve import CNNServer, resnet9_recipe
    from repro_torch.models import moe
    from repro_torch.models.layers import QuantPolicy
    from repro_torch.models.transformer import _pack_tree

    t_phase = time.perf_counter()
    kinds = ("K1", "K2", "K3", "K4", "K4g")
    out = {"launches": dict.fromkeys(kinds, 0)}
    want_fwd = {"K1": 3, "K2": 8, "K3": 0, "K4": 0, "K4g": 0}
    log(f"phase 19: array scaling — full-width ResNet9 W2A2 on {N_BANKS} "
        f"banks (streams of one card)")

    def counted(fn, want=None, what=""):
        """``fn()`` with the counts set to 0 just before and read just
        after; they join the phase's launches and must equal ``want``."""
        hp.reset_counts()
        res = fn()
        torch.cuda.synchronize()
        c = hp.counts()
        if want is not None and c != want:
            raise AssertionError(f"{what}: launches {c}, want {want}")
        out["launches"] = {k: out["launches"][k] + c[k] for k in kinds}
        return res, c

    times = lambda n: {k: v * n for k, v in want_fwd.items()}  # noqa: E731

    # (a) ShardedProgram at batch 32, 8 a bank
    graph, calib, _ = resnet9_recipe(0, 8)
    srv = {p: CNNServer(seed=0, calib_batch=8, max_batch=32,
                        n_banks=N_BANKS, placement=p)
           for p in ("banked", "sharded")}
    prog = srv["sharded"].program
    run = executor.make_runner(prog)
    plain = executor.make_plain_runner(prog)
    images = np.random.default_rng(19).random((32, 32, 32, 3),
                                              dtype=np.float32)
    x = torch.from_numpy(images).to(dev)
    mesh = pp.bank_mesh(N_BANKS)
    if (len(mesh) != N_BANKS or len({b.stream for b in mesh}) != N_BANKS
            or any(b.device != dev for b in mesh)):
        raise AssertionError(f"bank mesh {mesh}")
    sp = pp.ShardedProgram(prog, mesh)
    ys = [counted(lambda: sp(x), times(N_BANKS), "ShardedProgram")[0]
          for _ in range(2)]
    s = 32 // N_BANKS
    with torch.no_grad():
        singles = [run(prog.params, x[i * s:(i + 1) * s])
                   for i in range(N_BANKS)]
        for i in range(N_BANKS):
            rows = x[i * s:(i + 1) * s]
            hp.check_equal("K2", f"sharded bank {i}: rows {i * s}..."
                           f"{(i + 1) * s - 1} vs a single-bank forward at "
                           f"bucket {s}", ys[0][i * s:(i + 1) * s],
                           singles[i])
            hp.check_equal("K2", f"sharded bank {i} vs the plain versions",
                           ys[0][i * s:(i + 1) * s],
                           plain(prog.params, rows))
        hp.check_equal("K2", "the sharded burst's second run vs its first",
                       ys[1], ys[0])
        full = run(prog.params, x)
    differ = (ys[0] != full).any(-1)
    gap = float((ys[0] - full).abs().max())
    same_top = bool(torch.equal(ys[0].argmax(-1), full.argmax(-1)))
    out["sharded_vs_batch32"] = {"rows_differ": int(differ.sum()),
                                 "max_logit_gap": gap,
                                 "argmax_equal": same_top}
    log(f"  (a) ShardedProgram, batch 32 on {N_BANKS} banks (8 rows each): "
        f"every bank equals a single-bank forward of its rows at bucket 8 "
        f"and the plain versions, twice; against one forward of all 32 "
        f"rows {int(differ.sum())} rows differ, largest logit gap {gap:.3g}"
        f", argmax {'equal' if same_top else 'DIFFERS'}")

    # (b) PipelinedProgram, 2 and 4 stages, 4 microbatches of 8
    out["pipelined"] = {}
    for n_stages in (2, 4):
        pl = pp.PipelinedProgram(prog, n_stages=n_stages)
        y, _ = counted(lambda: pl(x, n_microbatches=4), times(4),
                       f"PipelinedProgram({n_stages})")
        hp.check_equal("K2", f"pipelined {n_stages} stages "
                       f"{pl.stage_bounds} vs single-bank bucket-8 "
                       f"forwards", y, torch.cat(singles))
        out["pipelined"][n_stages] = {"bounds": pl.stage_bounds}
    log(f"  (b) PipelinedProgram at 2 and 4 stages "
        f"({out['pipelined'][4]['bounds']}) on 4 microbatches: equal to the "
        f"single-bank forwards")

    # (c) CNNServer(n_banks=4), both placements, W2A2 and W4A8
    w4a8 = QuantPolicy(mode="serial", w_bits=4, a_bits=8, radix_bits=7)
    out["serving"] = {}
    burst = np.random.default_rng(20).random((ARRAY_BURST, 32, 32, 3),
                                             dtype=np.float32)
    for placement, server in srv.items():
        svc = server.service
        keys = [server.key, server.registry.register_graph(
            graph.name or "cnn", graph, calib, w4a8)]
        t0 = time.perf_counter()
        captured = svc.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        runners = [svc._runner_for(k) for k in keys]
        mult = N_BANKS if placement == "sharded" else 1
        buckets = executor.bucket_sizes(32, mult)
        graphs = N_BANKS * len(buckets)
        if (captured != len(keys) * (graphs if placement == "banked"
                                     else len(buckets))
                or any(r.stats()["cuda_graphs"] != graphs for r in runners)
                or any(c != want_fwd for r in runners
                       for c in r.capture_launches.values())):
            raise AssertionError(f"{placement} warmup: {captured} captures, "
                                 f"{[r.stats() for r in runners]}")
        compiles = [r.compiles for r in runners]
        rec = {"warmup_s": warm_s, "captures": captured,
               "graphs_per_variant": graphs, "bursts": []}
        for rep in range(2):
            replays0 = [dict(r.replays) for r in runners]
            sent = {}
            lock = threading.Lock()

            def submit_all():
                i = j = 0
                while i < ARRAY_BURST:
                    n = min(ARRAY_SIZES[j % len(ARRAY_SIZES)],
                            ARRAY_BURST - i)
                    key = keys[j % 2]
                    with lock:
                        tid0 = svc.tracer.started
                        fs = svc.submit_many(key, list(burst[i:i + n]))
                    for m, f in enumerate(fs):
                        sent[tid0 + 1 + m] = (key, i + m, f)
                    i += n
                    j += 1
                svc.drain(timeout=300)

            t0 = time.perf_counter()
            counted(submit_all, dict.fromkeys(kinds, 0),
                    f"{placement} burst (a replay calls no wrapper)")
            burst_s = time.perf_counter() - t0
            forwards = 0
            for r, r0 in zip(runners, replays0):
                for k, v in r.replays.items():
                    n = v - r0.get(k, 0)
                    forwards += n
                    for kid in kinds:
                        out["launches"][kid] += r.capture_launches[k][kid] * n
            if [r.compiles for r in runners] != compiles or any(
                    r.stats()["cuda_graphs"] != graphs for r in runners):
                raise AssertionError(f"{placement}: a capture after warmup")
            # every answer against its micro-batch's single-bank forward
            groups, sizes = {}, []
            for sp_ in svc.tracer.spans():
                if sp_.trace_id in sent and sp_.name == "execute":
                    groups.setdefault((sp_.t0_ns, sp_.t1_ns), []).append(
                        sp_.trace_id)
            if sorted(t for g in groups.values() for t in g) != sorted(sent):
                raise AssertionError(f"{placement}: the trace lost a request")
            with torch.no_grad():
                for ids in groups.values():
                    ids = sorted(ids)
                    key = sent[ids[0]][0]
                    p = server.registry.program(key)
                    n = len(ids)
                    b = executor.bucket_for(n, 32, mult)
                    xb = torch.zeros((b, 32, 32, 3), device=dev)
                    xb[:n] = torch.from_numpy(
                        burst[[sent[t][1] for t in ids]]).to(dev)
                    sh = b // mult
                    ref = torch.cat([executor.make_runner(p)(
                        p.params, xb[i * sh:(i + 1) * sh])
                        for i in range(mult)])[:n].cpu().numpy()
                    got = np.stack([sent[t][2].result() for t in ids])
                    if not np.array_equal(got, ref):
                        raise AssertionError(
                            f"{placement} {key} batch of {n}: answers differ"
                            f" from the single-bank forward at bucket {b}, "
                            f"max {np.abs(got - ref).max()}")
                    sizes.append(n)
            rec["bursts"].append({"seconds": burst_s, "forwards": forwards,
                                  "batches": len(sizes),
                                  "batch_sizes": sorted(sizes)})
        m = svc.metrics()
        sched = m["scheduler"]
        if (any(r <= 0 for r in sched["bank_requests"])
                or any(u <= 0.01 for u in sched["bank_utilization"])):
            raise AssertionError(f"{placement}: an idle bank {sched}")
        rec.update(bank_requests=m["scheduler"]["bank_requests"],
                   bank_batches=m["scheduler"]["bank_batches"],
                   bank_utilization=m["scheduler"]["bank_utilization"],
                   replica_cache=m["banks"]["replica_cache"])
        out["serving"][placement] = rec
        log(f"  (c) CNNServer(n_banks={N_BANKS}, placement={placement!r}), "
            f"W2A2 + W4A8: warmup captured {captured} keys "
            f"({graphs} graphs a variant, 3 K1 + 8 K2 each) in "
            f"{warm_s:.2f} s; two bursts of {ARRAY_BURST} requests in "
            + ", ".join(f"{b['seconds']:.3f} s ({b['batches']} batches, "
                        f"{b['forwards']} replays)" for b in rec["bursts"])
            + f", every answer equal to its micro-batch's single-bank "
            f"forward, nothing captured after warmup; bank requests "
            f"{rec['bank_requests']}, utilization {rec['bank_utilization']}"
            f", replica cache {rec['replica_cache']}")
        server.close()

    # (d) img/s at batch 32: one bank against four, banked and sharded
    reps = 8
    xp = torch.from_numpy(images).pin_memory()
    single = executor.make_bucketed_runner(prog, max_batch=32)
    banked = executor.make_bucketed_runner(prog, max_batch=32,
                                           banks=pp.bank_devices(N_BANKS))
    sharded = executor.make_bucketed_runner(prog, max_batch=32,
                                            mesh=pp.bank_mesh(N_BANKS))
    runs = {"1 bank": lambda j: single(xp),
            f"{N_BANKS} banks, banked": lambda j: banked(xp,
                                                         bank=j % N_BANKS),
            f"{N_BANKS} banks, sharded": lambda j: sharded(xp)}
    for r in (single, banked, sharded):
        r.warmup()
    torch.cuda.synchronize()
    out["throughput"] = {}

    def burst_of(fn):
        def go():
            ys = [fn(j) for j in range(reps)]
            torch.cuda.synchronize()
            return ys
        return go

    for name, fn in list(runs.items()) + list(runs.items())[::-1]:
        go = burst_of(fn)
        ys = go()
        for y in ys:
            if not torch.equal(y, ys[0]):
                raise AssertionError(f"{name}: a replay's answer changed")
        t0 = time.perf_counter()
        go()
        wall = time.perf_counter() - t0
        prof, _ = hp.profiled(go)
        ov = stream_overlap(prof, hp.is_spin)
        rec = out["throughput"].setdefault(name, {"wall_ms": [],
                                                  "img_per_s": [],
                                                  "profile": []})
        rec["wall_ms"].append(wall * 1e3)
        rec["img_per_s"].append(32 * reps / wall)
        rec["profile"].append(ov)
    for name, rec in out["throughput"].items():
        ov = rec["profile"][0]
        log(f"  (d) {name}: {reps} batches of 32 in "
            f"{', '.join(f'{w:.3f}' for w in rec['wall_ms'])} ms wall "
            f"({', '.join(f'{v:.0f}' for v in rec['img_per_s'])} img/s); "
            f"busy {ov['busy_ms']:.3f} ms, kernels sum {ov['sum_ms']:.3f} "
            f"ms on {ov['streams']} stream(s), two or more streams "
            f"running at once for {ov['multi_stream_ms']:.3f} ms")
    del single, banked, sharded

    # (e) one MoE layer at deepseek-v2-lite's widths, two-matrix experts
    d, f, e, k, n_sh = DEEPSEEK_MOE
    pol = QuantPolicy(mode="qat", w_bits=4, a_bits=8, pack_acts=True)
    pol_plain = QuantPolicy(mode="qat", w_bits=4, a_bits=8, pack_acts=True,
                            plain=True)
    xm = torch.randn((64, d), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    out["moe"] = {}
    for act in ("relu2", "gelu"):
        cfg = moe.MoEConfig(d_model=d, d_ff_expert=f, n_experts=e, top_k=k,
                            n_shared=n_sh, d_ff_shared=n_sh * f, act=act)
        p = _pack_tree(moe.moe_init(
            torch.Generator(device=dev).manual_seed(0), cfg, pol), pol)
        for g in (1, 2):
            (y, aux), c = counted(
                lambda: moe.moe_apply(p, xm, cfg, pol, n_groups=g),
                {"K1": 2, "K2": 0, "K3": 2, "K4": 0, "K4g": 2},
                f"MoE {act} n_groups={g}")
            ref, _ = moe.moe_apply(p, xm, cfg, pol_plain, n_groups=g)
            hp.check_equal("K4g", f"MoE layer {act}, n_groups={g} vs the "
                           f"plain versions", y, ref)
            out["moe"][f"{act}_g{g}"] = {
                "launches": c, "drop_frac": float(aux["drop_frac"])}
        del p
    log(f"  (e) one MoE layer at deepseek-v2-lite's widths (64 experts "
        f"top-6, 2 shared, 64 tokens), relu2 and gelu, n_groups 1 and 2: "
        f"2 grouped K4 (+ 2 K1 + 2 K3 for the shared experts) a layer, "
        f"equal to the plain versions; drop fractions "
        f"{ {k_: v['drop_frac'] for k_, v in out['moe'].items()} }")

    # (f) gpipe over 4 banks: a 24-layer float32 stack at d = 2048
    disable_tf32()
    g = torch.Generator(device=dev).manual_seed(0)
    ws = torch.randn((GPIPE_LAYERS, GPIPE_D, GPIPE_D), generator=g,
                     device=dev) / GPIPE_D ** 0.5
    h = torch.randn((GPIPE_ROWS, GPIPE_D), generator=g, device=dev)

    def stage_fn(wstage, t):
        for w in wstage:
            t = torch.tanh(t @ w)
        return t

    def sequential():
        t = h
        for w in ws:
            t = torch.tanh(t @ w)
        return t

    banks = pp.bank_devices(N_BANKS)
    stacked = stage_stack(ws, N_BANKS)
    ref = sequential()
    y = gpipe(stage_fn, stacked, h, banks=banks, n_microbatches=4)
    torch.cuda.synchronize()
    gap = float((y - ref).abs().max())
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-5)
    walls = {}
    for name, fn in (("sequential", sequential),
                     ("gpipe", lambda: gpipe(stage_fn, stacked, h,
                                             banks=banks,
                                             n_microbatches=4))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / 5 * 1e3
    out["gpipe"] = {"max_abs_diff": gap, "wall_ms": walls}
    log(f"  (f) gpipe over {N_BANKS} banks, {GPIPE_LAYERS} float32 layers "
        f"at d = {GPIPE_D}, {GPIPE_ROWS} rows in 4 microbatches, TF32 off: "
        f"within rtol 2e-4 / atol 2e-5 of the sequential stack (largest "
        f"difference {gap:.3g}); {walls['gpipe']:.3f} ms against "
        f"{walls['sequential']:.3f} ms sequential")
    del ws, stacked
    torch.cuda.empty_cache()

    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 20: one model's tensors placed over a data x model mesh (DTensor,
# NCCL), full-width stablelm-1.6b through the Trainer

MESH_STEPS = 3
MESH_BATCH, MESH_SEQ = 8, 64
MESH_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=MESH_STEPS)


def mesh_config(float_only: bool = False):
    """Phase 20's config: stablelm-1.6b FULL (24 layers, every width) with
    float32 compute, LSQ ``qat`` as the reference trains it, or with
    ``float_only`` no fake quantization (mode ``none``: no step sizes)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import QuantPolicy
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").full,
                              dtype="float32")
    if float_only:
        cfg = dataclasses.replace(cfg, policy=QuantPolicy(mode="none"))
    return cfg


def mesh_card_rank(rank, data, model):
    """One rank of phase 20 (c), started by ``run_ranks`` on its own card:
    the (data, model) mesh's ``Trainer``, ``MESH_STEPS`` steps of the
    ``qat`` config and then of the float one. Returns, for each, the
    losses, grad norms, the card's peak bytes and the state bytes it
    holds (its shards)."""
    import torch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import placed
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import AdamWConfig
    mesh = make_local_mesh(data, model)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, float_only in (("qat", False), ("float", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(mesh_config(float_only), opt_cfg=AdamWConfig(**MESH_OPT),
                     batch_size=MESH_BATCH, seq_len=MESH_SEQ, seed=0,
                     device=dev, mesh=mesh)
        state, losses = tr.run(MESH_STEPS, log_every=MESH_STEPS)
        torch.cuda.synchronize(dev)
        held = sum((t.to_local() if placed.is_placed(t) else t).numel()
                   * t.element_size() for t in tree_leaves(state))
        out[name] = {"losses": losses,
                     "grad_norms": [h["grad_norm"] for h in tr.history],
                     "step_s": [h["seconds"] for h in tr.history],
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "state_bytes": held,
                     "card": torch.cuda.get_device_name(dev)}
        if float_only:
            out[name]["cost"] = mesh_step_cost(tr, state)
        del state, tr
    return out


def mesh_step_cost(tr, state):
    """One more step of ``tr`` (a mesh ``Trainer``) under
    ``launch/hlo_analysis.py``'s ``CostMode``: this rank's collective
    counts and bytes by kind."""
    from repro_torch.launch.hlo_analysis import analyze
    batch = tr.device_batch(tr.data.batch(MESH_STEPS, MESH_BATCH))
    with tr._step_context():
        _, cost = analyze(tr._step_fn, state, batch)
    return {"counts": cost.collective_counts, "bytes": cost.collective_bytes}


def fake_mesh_step_cost(cfg, data, model, device_type="cuda"):
    """The same step as :func:`mesh_step_cost`'s counted on rank 0 of a
    fake (data, model) mesh in this process, state and batch on ``meta``
    (``launch/mesh.py``'s ``fake_mesh``)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import placed
    from repro_torch.distributed.sharding import batch_pspec, to_placements
    from repro_torch.launch.dryrun import _MetaGenerator
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.train import init_placed_params, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    with fake_mesh((data, model), device_type) as mesh:
        params = init_placed_params(_MetaGenerator(), cfg, mesh)
        state = {"params": params, "opt": adamw_init(params)}
        toks = torch.empty((MESH_BATCH, MESH_SEQ), dtype=torch.int64,
                           device="meta")
        pl = to_placements(batch_pspec(tuple(toks.shape), mesh), mesh)
        batch = {k: distribute_tensor(toks, mesh, pl, src_data_rank=None)
                 for k in ("tokens", "labels")}
        step = make_train_step(cfg, AdamWConfig(**MESH_OPT), donate=True)
        with placed.mesh_context(mesh):
            _, cost = analyze(step, state, batch)
    return {"counts": cost.collective_counts, "bytes": cost.collective_bytes}


# phase 20 (d)-(f): the packed model served sharded (Server(mesh=)):
# stablelm-1.6b FULL, bf16, W4A8, random weights from seed 0 (phase 8's
# draw), phase 8's four requests; (f) also qwen1.5-110b at full depth
MESH_QWEN_NEW = 4     # new tokens of (f)'s qwen1.5-110b run (80 layers)


def _serve_counts(srv, reqs, hp_counts, hp_reset, steps=None):
    """``srv.generate(reqs)`` with the launch counts reset just before
    and read just after: (tokens, last logits, counts)."""
    import torch
    hp_reset()
    res = srv.generate(reqs, step_seconds=steps)
    torch.cuda.synchronize()
    return [r.out_tokens for r in res], srv.last_logits, hp_counts()


def mesh_serve(dev, hp, mesh):
    """Phase 20 (d): ``Server(mesh=)`` on the (data 1, model 1) NCCL mesh
    (a) opened, full-width stablelm-1.6b drawn placed from seed 0 (phase
    8's planes), on phase 8's four requests through K1 + K3 and through
    K4: 96 K1 + 168 K3 (168 K4) a step, tokens and last-step logits equal
    phase 8's unsharded ``Server``'s bit for bit; its decode steps timed
    against an unsharded ``Server`` on the same planes (gathered)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import placed
    from repro_torch.launch.serve import GenRequest, Server
    cfg = get_arch("stablelm-1.6b").full
    per = {"K1": 4 * cfg.n_layers, "K3": 7 * cfg.n_layers}
    reqs = lambda: [GenRequest(p.copy(), LM_NEW) for p in hp.prompts]
    t0 = time.perf_counter()
    srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0, mesh=mesh,
                 device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"init_s": init_s,
           "launches": dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)}
    runs = {}
    for tag, pa in (("k3", True), ("k4", False)):
        s = srv if pa else Server(cfg, srv.params, batch_slots=4,
                                  max_len=LM_MAX_LEN, pack_acts=False,
                                  mesh=mesh, device=dev)
        steps = []
        toks, logits, c = _serve_counts(s, reqs(), hp.counts,
                                        hp.reset_counts, steps)
        kid = "K3" if pa else "K4"
        want = {"K1": per["K1"] * LM_NEW if pa else 0, "K2": 0,
                "K3": per["K3"] * LM_NEW if pa else 0,
                "K4": 0 if pa else per["K3"] * LM_NEW, "K4g": 0}
        if c != want:
            raise AssertionError(f"(d) {tag} launches {c}, want {want}")
        if toks != hp.lm_tokens or not torch.equal(logits, hp.lm_logits):
            raise AssertionError(f"(d) {tag}: the sharded Server's tokens "
                                 "or last logits differ from phase 8's "
                                 "unsharded Server's")
        for k in out["launches"]:
            out["launches"][k] += c[k]
        runs[tag] = {"launches": c, "prefill_s": steps[0],
                     "decode_step_ms": [t * 1e3 for t in steps[1:]]}
    # the unsharded Server on the same planes (the (1, 1) mesh's shards
    # are the whole tensors), timed the same way
    whole = _tree_map(placed.plain, srv.params)
    ref = Server(cfg, whole, batch_slots=4, max_len=LM_MAX_LEN, device=dev)
    steps = []
    toks, logits, c = _serve_counts(ref, reqs(), hp.counts, hp.reset_counts,
                                    steps)
    if toks != hp.lm_tokens or not torch.equal(logits, hp.lm_logits):
        raise AssertionError("(d) the unsharded Server on the gathered "
                             "planes differs from phase 8's")
    for k in out["launches"]:
        out["launches"][k] += c[k]
    runs["unsharded"] = {"launches": c, "prefill_s": steps[0],
                         "decode_step_ms": [t * 1e3 for t in steps[1:]]}
    out["runs"] = runs
    med = {k: statistics.median(v["decode_step_ms"]) for k, v in runs.items()}
    out["decode_step_ms_median"] = med
    log(f"  (d) Server(mesh=(data 1, model 1), stablelm-1.6b FULL, bf16, "
        f"seed 0; drawn placed in {init_s:.1f} s) on phase 8's four "
        f"requests: tokens and last logits equal phase 8's unsharded "
        f"Server's bit for bit through K1 + K3 ({runs['k3']['launches']}) "
        f"and K4 ({runs['k4']['launches']}): {per['K1']} K1 + "
        f"{per['K3']} K3 (K4) a step; decode step ms (median, host clock, "
        f"synchronized) K3 {med['k3']:.1f}, K4 {med['k4']:.1f}, unsharded "
        f"K3 {med['unsharded']:.1f}; prefill s K3 "
        f"{runs['k3']['prefill_s']:.2f}")
    del srv, ref, whole
    return out


def moe_prompts(cfg):
    """Phase 12's four deepseek prompts (``LM_PROMPTS`` long, from
    RandomState(0) over ``cfg``'s vocabulary)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in LM_PROMPTS]


def moe_per_step(cfg):
    """The kernel launches one prefill or decode step of the MoE model
    ``cfg`` makes with ``pack_acts`` (K1 + K3): per layer's attention 2
    K1 (q and kv-down, or q/k/v, share one; wo) and 3 K3 with MLA or 4
    with GQA, the dense layer's or the shared experts' MLP 2 K1 (gate/up
    share one; down) and 3 K3, and 3 grouped K4 per MoE layer (up, gate,
    down); K4 with ``pack_acts=False`` takes K3's count and no K1."""
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    mlp_layers = cfg.n_dense_layers + (moe_layers if cfg.n_shared_experts
                                       else 0)
    k1 = 2 * cfg.n_layers + 2 * mlp_layers
    k3 = (3 if cfg.mla else 4) * cfg.n_layers + 3 * mlp_layers
    return {"K1": k1, "K3": k3, "K4g": 3 * moe_layers}


def moe_reference(dev, cfg, prompts, new, n_groups=1):
    """The unsharded ``Server`` of ``cfg`` drawn from seed 0 on ``prompts``
    (``new`` tokens each, one slot a prompt), its MoE dispatching in
    ``n_groups`` groups: (tokens, last logits on the host)."""
    import torch
    from repro_torch.distributed.context import bind_axes
    from repro_torch.launch.serve import GenRequest, Server
    srv = Server(cfg, batch_slots=len(prompts), max_len=LM_MAX_LEN, seed=0,
                 device=dev)
    with bind_axes(dp="data", mesh={"data": n_groups}):
        res = srv.generate([GenRequest(p.copy(), new) for p in prompts])
    out = ([r.out_tokens for r in res], srv.last_logits.float().cpu())
    del srv, res
    torch.cuda.empty_cache()
    return out


def mesh_serve_moe(dev, hp, mesh):
    """Phase 20 (d), the MoE family: ``Server(mesh=)`` of
    deepseek-v2-lite-16b FULL (27 layers, MLA, 64 routed experts split
    over ``model``) on the (data 1, model 1) NCCL mesh, drawn placed from
    phase 12's seed, on phase 12's four requests over ``DS_PLAIN_NEW``
    new tokens, through K1 + K3 and through K4: phase 12's launches every
    step (108 K1 + 162 K3 + 78 grouped K4; K4 162 in K3's place), tokens
    and last-step logits equal phase 12's unsharded ``Server``'s bit for
    bit; its decode steps timed against an unsharded ``Server`` on the
    same planes (gathered). Helpers: ``counts``, ``reset_counts``,
    ``ds_prompts``, ``ds_tokens``, ``ds_logits`` (phase 12's short
    run)."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import placed
    from repro_torch.launch.serve import GenRequest, Server
    cfg = get_arch("deepseek-v2-lite-16b").full
    per = moe_per_step(cfg)
    steps_n = DS_PLAIN_NEW
    reqs = lambda: [GenRequest(p.copy(), steps_n) for p in hp.ds_prompts]
    t0 = time.perf_counter()
    srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0, mesh=mesh,
                 device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"init_s": init_s,
           "launches": dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)}
    runs = {}
    for tag, pa in (("k3", True), ("k4", False)):
        s = srv if pa else Server(cfg, srv.params, batch_slots=4,
                                  max_len=LM_MAX_LEN, pack_acts=False,
                                  mesh=mesh, device=dev)
        steps = []
        toks, logits, c = _serve_counts(s, reqs(), hp.counts,
                                        hp.reset_counts, steps)
        want = {"K1": per["K1"] * steps_n if pa else 0, "K2": 0,
                "K3": per["K3"] * steps_n if pa else 0,
                "K4": 0 if pa else per["K3"] * steps_n,
                "K4g": per["K4g"] * steps_n}
        if c != want:
            raise AssertionError(f"(d) deepseek {tag} launches {c}, want "
                                 f"{want}")
        if toks != hp.ds_tokens or not torch.equal(logits, hp.ds_logits):
            raise AssertionError(f"(d) deepseek {tag}: the sharded Server's "
                                 "tokens or last logits differ from phase "
                                 "12's unsharded Server's")
        for k in out["launches"]:
            out["launches"][k] += c[k]
        runs[tag] = {"launches": c, "prefill_s": steps[0],
                     "decode_step_ms": [t * 1e3 for t in steps[1:]]}
    whole = _tree_map(placed.plain, srv.params)
    ref = Server(cfg, whole, batch_slots=4, max_len=LM_MAX_LEN, device=dev)
    steps = []
    toks, logits, c = _serve_counts(ref, reqs(), hp.counts, hp.reset_counts,
                                    steps)
    if toks != hp.ds_tokens or not torch.equal(logits, hp.ds_logits):
        raise AssertionError("(d) deepseek: the unsharded Server on the "
                             "gathered planes differs from phase 12's")
    for k in out["launches"]:
        out["launches"][k] += c[k]
    runs["unsharded"] = {"launches": c, "prefill_s": steps[0],
                         "decode_step_ms": [t * 1e3 for t in steps[1:]]}
    out["runs"] = runs
    med = {k: statistics.median(v["decode_step_ms"]) for k, v in runs.items()}
    out["decode_step_ms_median"] = med
    log(f"  (d) Server(mesh=(data 1, model 1), deepseek-v2-lite-16b FULL, "
        f"bf16, seed 0; drawn placed in {init_s:.1f} s) on phase 12's four "
        f"requests, {steps_n} new tokens: tokens and last logits equal phase "
        f"12's unsharded Server's bit for bit through K1 + K3 "
        f"({runs['k3']['launches']}) and K4 ({runs['k4']['launches']}): "
        f"{per} a step; decode step ms (median, host clock, synchronized) "
        f"K3 {med['k3']:.1f}, K4 {med['k4']:.1f}, unsharded K3 "
        f"{med['unsharded']:.1f}; prefill s K3 {runs['k3']['prefill_s']:.2f}")
    del srv, ref, whole, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 20 (d) and (f): the SSM, hybrid and encoder-decoder families on a
# mesh, each run (arch, layers, prompt lengths, new tokens, max_len):
# mamba2 and hymba at phase 15's depths and run 1's requests (max_len 64:
# hymba's 1,024-slot window only masks), seamless FULL on phase 16's
# seeded src_embeds, 8 new tokens
MESH_FAMILY_RUNS = (
    ("mamba2-780m", SSM_DEPTH["mamba2-780m"], LM_PROMPTS, LM_NEW, 1024),
    ("hymba-1.5b", SSM_DEPTH["hymba-1.5b"], LM_PROMPTS, LM_NEW, LM_MAX_LEN),
    ("seamless-m4t-large-v2", 24, LM_PROMPTS, DS_PLAIN_NEW, LM_MAX_LEN))
# (f)'s hymba run: one prompt past its 1,024-slot window, whose slots a
# (1, 4) mesh splits (5 kv heads), 256 a card
MESH_HYMBA_LONG = ("hymba-1.5b", SSM_DEPTH["hymba-1.5b"], (1030, 5, 8, 11),
                   DS_PLAIN_NEW, 1280)


def family_config(arch, layers):
    """``arch``'s FULL config at ``layers`` layers (its global attention
    layers cut with it), every width kept."""
    import dataclasses
    from repro_torch.configs import get_arch
    full = get_arch(arch).full
    return dataclasses.replace(full, n_layers=layers, global_attn_layers=tuple(
        g for g in full.global_attn_layers if g < layers))


def family_run_launches(cfg, new, pack_acts):
    """The kernel launches a run of ``new`` tokens of a family run makes:
    phase 15's per step (an SSM's or a hybrid's prefill and decode steps
    launch alike), or phase 16's prefill and decode steps."""
    if cfg.family in ("encdec", "audio"):
        pre = family_launches(cfg, "prefill", pack_acts)
        dec = family_launches(cfg, "decode", pack_acts)
        return {k: pre[k] + (new - 1) * dec[k] for k in pre}
    sl = SSM_SLICE[cfg.name]
    k1 = len(sl["k1"]) * cfg.n_layers * new
    k3 = sum(c for _, c in sl["gemms"]) * cfg.n_layers * new
    return {"K1": k1 if pack_acts else 0, "K2": 0,
            "K3": k3 if pack_acts else 0, "K4": 0 if pack_acts else k3,
            "K4g": 0}


def family_serve(srv, run, counts, reset_counts, steps=None):
    """``srv`` (sharded or not) on a family run's requests, from
    RandomState(0) over its vocabulary: ``generate``, or for an
    encoder-decoder what ``generate`` does on phase 16's seeded
    ``src_embeds`` (4, 64, frontend_dim), bf16 (``prefill``, then greedy
    ``decode_step``s inside the server's step context). Launch counts
    reset just before and read just after; with ``steps`` each step's
    synchronized seconds are appended (the prefill's first). Returns
    (tokens, last logits on the host, launches)."""
    import numpy as np
    import torch
    from repro_torch.distributed import placed
    from repro_torch.launch.serve import GenRequest
    from repro_torch.models import transformer
    _, _, lens, new, max_len = run
    cfg, dev = srv.cfg, srv.device
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    card = dev.type == "cuda"
    if cfg.family not in ("encdec", "audio"):
        reset_counts()
        res = srv.generate([GenRequest(p.copy(), new) for p in prompts],
                           step_seconds=steps)
        torch.cuda.synchronize(dev) if card else None
        return ([r.out_tokens for r in res], srv.last_logits.float().cpu(),
                counts())
    toks = np.zeros((len(prompts), max(lens)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    g = torch.Generator(device=dev).manual_seed(5)
    src = torch.randn((len(prompts), SRC_LEN, cfg.frontend_dim), generator=g,
                      device=dev).bfloat16()
    steps = [] if steps is None else steps

    def timed(t0):
        torch.cuda.synchronize(dev) if card else None
        steps.append(time.perf_counter() - t0)

    reset_counts()
    with srv._context():
        batch = {"tokens": srv._place_batch(torch.from_numpy(toks).to(dev)),
                 "src_embeds": srv._place_batch(src)}
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(srv.params, batch, cfg,
                                             max_len=max_len)
        tok = torch.argmax(logits, -1)[:, None]
        timed(t0)
        cols = [tok]
        for t in range(1, new):
            t0 = time.perf_counter()
            logits, caches = transformer.decode_step(
                srv.params, caches, tok, toks.shape[1] + t - 1, cfg)
            tok = torch.argmax(logits, -1)[:, None]
            timed(t0)
            cols.append(tok)
        out = placed.plain(torch.cat(cols, dim=1)).cpu().tolist()
        logits = placed.plain(logits).float().cpu()
    return out, logits, counts()


def reset_kernel_counts():
    """Every kernel wrapper's launch counts set to 0 (what
    ``kernels.ops.launch_counts`` reads)."""
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    for k in (k1.KERNEL, k2.KERNEL, km.KERNEL, km.GROUPED):
        k.reset_counts()


def family_reference(dev, run, counts, reset_counts):
    """The unsharded ``Server`` of a family run, drawn from seed 0 (the
    draw a mesh's placed params equal): (tokens, last logits on the host,
    launches, step seconds)."""
    import gc
    import torch
    from repro_torch.launch.serve import Server
    srv = Server(family_config(run[0], run[1]), batch_slots=len(run[2]),
                 max_len=run[4], seed=0, device=dev)
    steps = []
    out = family_serve(srv, run, counts, reset_counts, steps)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out + (steps,)


def mesh_serve_families(dev, hp, mesh):
    """Phase 20 (d), the SSM, hybrid and encoder-decoder families
    (``MESH_FAMILY_RUNS``): mamba2-780m (its SSM state split by heads on
    a wider mesh), hymba-1.5b and seamless-m4t-large-v2 through
    ``Server(mesh=)`` on the (data 1, model 1) NCCL mesh, drawn placed
    from seed 0, K1 + K3 and K4: the unsharded step's launches every step
    (24 K1 + 24 K3, 48 + 72, seamless 144 + 192 a decode step; K4 in K3's
    place), tokens and last-step logits equal the unsharded ``Server``'s
    drawn from seed 0 bit for bit (mamba2's and hymba's tokens phase
    15's run 1's, ``hp.ssm_tokens``); decode steps timed against it.
    Returns the record; its ``launches`` are every run's."""
    import gc

    import torch
    from repro_torch.launch.serve import Server
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)}
    for run in MESH_FAMILY_RUNS:
        arch, layers, lens, new, max_len = run
        cfg = family_config(arch, layers)
        t_run = time.perf_counter()
        ref = family_reference(dev, run, hp.counts, hp.reset_counts)
        if arch in hp.ssm_tokens and ref[0] != hp.ssm_tokens[arch]:
            raise AssertionError(f"(d) {arch}: the unsharded Server's tokens "
                                 "differ from phase 15's run 1")
        t0 = time.perf_counter()
        srv = Server(cfg, batch_slots=len(lens), max_len=max_len, seed=0,
                     mesh=mesh, device=dev)
        torch.cuda.synchronize()
        rec = {"layers": layers, "new": new, "init_s":
               time.perf_counter() - t0}
        for tag, pa in (("k3", True), ("k4", False)):
            s = srv if pa else Server(cfg, srv.params, batch_slots=len(lens),
                                      max_len=max_len, pack_acts=False,
                                      mesh=mesh, device=dev)
            steps = []
            toks, logits, c = family_serve(s, run, hp.counts,
                                           hp.reset_counts, steps)
            want = family_run_launches(cfg, new, pa)
            if c != want:
                raise AssertionError(f"(d) {arch} {tag} launches {c}, want "
                                     f"{want}")
            if toks != ref[0] or not torch.equal(logits, ref[1]):
                raise AssertionError(f"(d) {arch} {tag}: the sharded "
                                     "Server's tokens or last logits differ "
                                     "from the unsharded Server's")
            for k in out["launches"]:
                out["launches"][k] += c[k]
            rec[tag] = {"launches": c, "prefill_s": steps[0],
                        "decode_step_ms": [t * 1e3 for t in steps[1:]]}
        for k in out["launches"]:
            out["launches"][k] += ref[2][k]
        rec["unsharded"] = {"launches": ref[2], "prefill_s": ref[3][0],
                            "decode_step_ms": [t * 1e3 for t in ref[3][1:]]}
        med = {k: statistics.median(rec[k]["decode_step_ms"])
               for k in ("k3", "k4", "unsharded")}
        rec["decode_step_ms_median"] = med
        rec["seconds"] = time.perf_counter() - t_run
        out[arch] = rec
        enc = (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers
               else "")
        log(f"  (d) Server(mesh=(data 1, model 1), {arch} {layers} layers"
            f"{enc}, bf16, "
            f"seed 0; drawn placed in {rec['init_s']:.1f} s), {list(lens)}, "
            f"{new} new: tokens and last logits equal the unsharded "
            f"Server's bit for bit through K1 + K3 ({rec['k3']['launches']})"
            f" and K4 ({rec['k4']['launches']}); decode step ms (median, "
            f"host clock, synchronized) K3 {med['k3']:.1f}, K4 "
            f"{med['k4']:.1f}, unsharded {med['unsharded']:.1f}; "
            f"{rec['seconds']:.1f} s")
        del srv, s
        gc.collect()
        torch.cuda.empty_cache()
    return out


def split_arithmetic(dev):
    """Phase 20 (e): the row- and column-parallel arithmetic on this card,
    at stablelm-1.6b's three projection shapes (read from its config) and
    M = 4 and 64, seeded codes and planes: K3 and K4 in accumulator mode
    (``raw_acc``) equal their plain accumulators (``torch.equal``); the
    product split over K into 2 and 4 word ranges, each range's int32
    accumulator summed and the plain epilogue run once, equals the fused
    whole K3/K4 output bit for bit; N split into 2 and 4 column ranges and
    concatenated equals it too; so does the SSMs' column-parallel
    in_proj at its odd per-rank column counts (hymba's 1,600 -> 6,482 on
    2 ranks, 3,241 a rank; mamba2's 1,536 -> 6,448 on 2 and 4, 1,612 a
    rank on 4). These launches compare kernels with plain versions and
    are not counted."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.quant import qrange
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels.epilogue import epilogue
    from repro_torch.kernels.quantize_pack import pack_codes_ref
    from repro_torch.kernels.tile_sweep import W4A8, lm_projections
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def planes(wc):
        return pack_codes_ref(wc.t().contiguous(), 4).permute(
            0, 2, 1).contiguous()

    lo, hi = qrange(8, True)
    checked = 0
    # (K, N, K splits, N splits)
    cases = [(k, n, (2, 4), (2, 4))
             for k, n in lm_projections(get_arch("stablelm-1.6b").full)]
    cases += [(1600, 6482, (), (2,)), (1536, 6448, (), (2, 4))]
    for k, n, k_parts, n_parts in cases:
        wc = cuda(rng.integers(-8, 8, (k, n)).astype(np.int32))
        scale = cuda((rng.random(n) * 1e-3).astype(np.float32))
        bias = cuda((rng.standard_normal(n) * 0.1).astype(np.float32))
        for m in (4, 64):
            xc = cuda(rng.integers(lo, hi + 1, (m, k)).astype(np.int32))
            for kid, fn, ref, x_of in (
                    ("K3", km.bitserial_matmul_v2_cuda,
                     km.bitserial_matmul_v2_ref,
                     lambda c: pack_codes_ref(c.contiguous(), 8)),
                    ("K4", km.bitserial_matmul_cuda, km.bitserial_matmul_ref,
                     lambda c: c.contiguous())):
                whole = fn(x_of(xc), planes(wc), scale, bias, spec=W4A8, k=k)
                acc = fn(x_of(xc), planes(wc), None, spec=W4A8, k=k,
                         raw_acc=True)
                want = ref(x_of(xc), planes(wc), None, spec=W4A8, k=k,
                           raw_acc=True)
                torch.cuda.synchronize()
                if acc.dtype != torch.int32 or not torch.equal(acc, want):
                    raise AssertionError(f"(e) {kid} M={m} {k}->{n}: the "
                                         "accumulator mode differs from the "
                                         "plain accumulator")
                for parts in k_parts:
                    words = -(-k // 32)
                    step = 32 * -(-words // parts)
                    tot = None
                    for a in range(0, k, step):
                        b = min(k, a + step)
                        part = fn(x_of(xc[:, a:b]), planes(wc[a:b]), None,
                                  spec=W4A8, k=b - a, raw_acc=True)
                        tot = part if tot is None else tot + part
                    fused = epilogue(tot, scale, bias, relu=False,
                                     requant=None)
                    torch.cuda.synchronize()
                    if not torch.equal(fused, whole):
                        raise AssertionError(f"(e) {kid} M={m} {k}->{n}: "
                                             f"{parts} K ranges summed in "
                                             "int32 differ from the whole")
                for parts in n_parts:
                    cols = torch.cat([fn(
                        x_of(xc), planes(wc[:, c:c + n // parts]),
                        scale[c:c + n // parts], bias[c:c + n // parts],
                        spec=W4A8, k=k) for c in range(0, n, n // parts)], -1)
                    torch.cuda.synchronize()
                    if not torch.equal(cols, whole):
                        raise AssertionError(f"(e) {kid} M={m} {k}->{n}: "
                                             f"{parts} column ranges differ "
                                             "from the whole")
                checked += 1
    sec = time.perf_counter() - t0
    log(f"  (e) split arithmetic at stablelm-1.6b's projections, M = 4 and "
        f"64, K3 and K4 ({checked} cases): accumulator mode equals the "
        f"plain accumulators; K split in 2 and 4 word ranges (int32 sum, "
        f"then the plain epilogue) and N split in 2 and 4 column ranges "
        f"equal the fused whole output bit for bit; so do hymba's in_proj "
        f"(1600 -> 6482) in 2 column ranges and mamba2's (1536 -> 6448) "
        f"in 2 and 4 ({sec:.1f} s)")
    return {"cases": checked, "seconds": sec}


# phase 20 (d) and (f): the continuous engine on a mesh
# (ContinuousLMEngine(mesh=)), its decode step one CUDA graph a rank with
# the NCCL collectives inside, on phase 8b's mixed load (stablelm) and
# phase 12's (deepseek): 16 requests of mixed_load
ENGINE_LOAD = 16
ENGINE_REPS = 15        # replays timed between synchronizes (median)
ENGINE_EAGER_REPS = 5   # eager steps on the same arena, likewise


def mixed_load(n, vocab, new_tokens=LM_NEW):
    """The reference CLI's mixed load (``launch/serve.py``): ``n``
    prompts of 4-16 tokens over ``vocab`` from RandomState(0), every 4th
    request long: ``[(prompt, max_new_tokens)]``."""
    import numpy as np
    rng = np.random.RandomState(0)
    m_long = max(1, min(new_tokens, LM_MAX_LEN - 16))
    return [(rng.randint(0, vocab, (int(rng.randint(4, 17)),)).astype(
        np.int32), m_long if i % 4 == 0 else max(1, m_long // 4))
        for i in range(n)]


def replay_profile(prof, wall):
    """One replayed step's profiler window (from ``profiled``, or
    :func:`profile_once` in a rank): host wall, the card's busy time, its
    kernels, the NCCL kernels' count and ms (waits inside them included),
    and the LM kernels by id (:func:`kernel_of`)."""
    recs = [(n, ns) for n, ns in card_records(prof)
            if "spin_kernel" not in n]
    nccl = [ns for n, ns in recs if "nccl" in n.lower()]
    by = {"K1": 0, "K3": 0, "K4": 0, "K4g": 0}
    for n, _ in recs:
        kid = kernel_of(n)
        if kid in by:
            by[kid] += 1
    return {"wall_ms": wall * 1e3, "busy_ms": sum(ns for _, ns in recs) / 1e6,
            "kernels": len(recs), "nccl_kernels": len(nccl),
            "nccl_ms": sum(nccl) / 1e6, "by_kernel": by}


def profile_once(fn, card):
    """``fn`` once in a profiler window of its own (a rank's: no spin
    kernels, no second window): (profiler, host wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if card else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize() if card else None
        wall = time.perf_counter() - t0
    return prof, wall


def engine_on(cfg, load, dev, mesh=None, params=None, profiler=None,
              reps=ENGINE_REPS, eager_reps=ENGINE_EAGER_REPS):
    """``ContinuousLMEngine`` of ``cfg`` (4 slots, ``LM_MAX_LEN``, drawn
    from seed 0 or on ``params``; sharded over ``mesh`` when given)
    warmed up (its step captured) and serving ``load``; then, on the
    arena as the load left it (every row inactive), ``reps`` replays and
    ``eager_reps`` eager steps, each between two synchronizes, and one
    replay under ``profiler(fn) -> (profiler, wall)``, then one eager
    step under ``launch/hlo_analysis.py``'s ``CostMode``. Returns the
    engine and its record: tokens, stats, load seconds and tok/s, the
    replays' and eager steps' host ms (median), the profiled replay
    (:func:`replay_profile`) and the step's collectives by kind (counts,
    bytes a rank); ``replays`` counts every replay made."""
    import statistics as stats_

    import torch
    from repro_torch.launch.serve import GenRequest
    from repro_torch.serving import ContinuousLMEngine
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    eng = ContinuousLMEngine(cfg, params, batch_slots=4, max_len=LM_MAX_LEN,
                             seed=0, device=dev, mesh=mesh)
    sync()
    rec = {"init_s": time.perf_counter() - t0}
    warm = eng.warmup()
    reqs = [GenRequest(p.copy(), m) for p, m in load]
    sync()
    t0 = time.perf_counter()
    out = eng.serve(reqs)             # ends in the host copy of the tokens
    rec["load_s"] = time.perf_counter() - t0
    st, em = eng.stats(), eng.engine_metrics()
    n_tok = sum(len(r.out_tokens) for r in out)
    replays = [st["calls"]["decode"] if st["cuda_graph"] else 0]

    def replay():
        replays[0] += 1
        eng._run_step()

    def eager():
        with eng._context():
            eng._step_fn()

    step = replay if st["cuda_graph"] else eager

    def fenced(fn, n):
        walls = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        return stats_.median(walls) * 1e3 if walls else None

    rec.update(tokens=[r.out_tokens for r in out], warmup_s=warm["seconds"],
               graph=st["cuda_graph"], step_launches=st["step_launches"],
               capture_s=st["capture_seconds"], mesh=st["mesh"],
               recompiles_after_warmup=st["recompiles_after_warmup"],
               decode_steps=em["decode_steps"], load_tokens=n_tok,
               tok_per_s=n_tok / rec["load_s"],
               replay_ms=fenced(step, reps),
               eager_step_ms=fenced(eager, eager_reps))
    if profiler is not None:
        rec["replay_profile"] = replay_profile(*profiler(step))
        # the collectives of one step (the body the graph holds), counted
        # by launch/hlo_analysis.py on one more eager step
        from repro_torch.launch.hlo_analysis import analyze
        with eng._context():
            _, cost = analyze(eng._step_fn)
        rec["step_collectives"] = {
            "counts": {k: int(v) for k, v in cost.collective_counts.items()
                       if v},
            "bytes": {k: int(v) for k, v in cost.collective_bytes.items()
                      if v}}
    rec["replays"] = replays[0]
    return eng, rec


def mesh_engine(dev, hp, mesh):
    """Phase 20 (d), the engine: ``ContinuousLMEngine(mesh=)`` on the
    (data 1, model 1) NCCL mesh (a), stablelm-1.6b FULL on phase 8b's
    mixed load and deepseek-v2-lite-16b FULL on phase 12's, each drawn
    placed from seed 0 (the unsharded engines' planes), through K1 + K3
    (+ grouped K4): its decode step captured as one CUDA graph with the
    collectives inside (``stats()["cuda_graph"]``), the per-step launches
    counted at capture equal to the unsharded engine's, and its tokens
    equal to the unsharded captured engine's on the same load bit for
    bit. The replay (host wall, busy, NCCL kernels) against an unsharded
    engine's on the same planes (gathered) and against the eager mesh
    step. Helpers: ``counts``, ``reset_counts``, ``profiled``,
    ``engine_ref`` and ``ds_engine_ref`` (phase 8b's and 12's load,
    tokens and per-step launches). Returns the record; its ``launches``
    are what the engines ran (wrapper calls, and each replay's captured
    launches)."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import placed
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)}

    for name, cfg, ref in (
            ("stablelm", get_arch("stablelm-1.6b").full, hp.engine_ref),
            ("deepseek", get_arch("deepseek-v2-lite-16b").full,
             hp.ds_engine_ref)):
        runs = {}
        # a window short of the step's kernels is opened again
        expect = {k: v for k, v in ref["step"].items() if v}

        def profiler(fn):
            return hp.profiled(fn, expect=expect)

        for tag in ("mesh", "unsharded"):
            hp.reset_counts()
            params = (None if tag == "mesh"
                      else _tree_map(placed.plain, mesh_eng.params))
            eng, rec = engine_on(cfg, ref["load"], dev,
                                 mesh=mesh if tag == "mesh" else None,
                                 params=params, profiler=profiler)
            torch.cuda.synchronize()
            c = hp.counts()
            for k in out["launches"]:
                out["launches"][k] += c[k] + rec["replays"] * rec[
                    "step_launches"].get(k, 0)
            bad = []
            if not rec["graph"] or rec["recompiles_after_warmup"] != 0:
                bad.append(f"graph {rec['graph']}, recompiles "
                           f"{rec['recompiles_after_warmup']}")
            if rec["step_launches"] != ref["step"]:
                bad.append(f"launches at capture {rec['step_launches']}, "
                           f"the unsharded engine's {ref['step']}")
            if rec["replay_profile"]["by_kernel"] != ref["step"]:
                bad.append(f"one replay ran {rec['replay_profile']}")
            if rec["tokens"] != ref["tokens"]:
                bad.append("tokens differ from the unsharded captured "
                           "engine's")
            if bad:
                raise AssertionError(f"(d) {name} engine ({tag}): "
                                     + "; ".join(bad))
            runs[tag] = rec
            if tag == "mesh":
                mesh_eng = eng
            del eng, params
        del mesh_eng
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = runs
        m, u = runs["mesh"], runs["unsharded"]
        mp, up = m["replay_profile"], u["replay_profile"]
        log(f"  (d) ContinuousLMEngine(mesh=(data 1, model 1), {cfg.name} "
            f"FULL, seed 0) on the {len(ref['load'])}-request mixed load: "
            f"its decode step one CUDA graph ({m['step_launches']} at "
            f"capture, the unsharded engine's), captured in "
            f"{m['capture_s']:.2f} s (warm-up step included); tokens "
            f"equal the unsharded captured engine's bit for bit; "
            f"{m['load_tokens']} tokens in {m['load_s']:.2f} s = "
            f"{m['tok_per_s']:.1f} tok/s (unsharded {u['tok_per_s']:.1f})")
        log(f"    one replay: host wall (median of {ENGINE_REPS}, "
            f"synchronized) {m['replay_ms']:.3f} ms against unsharded "
            f"{u['replay_ms']:.3f} ms; profiled: wall {mp['wall_ms']:.3f} "
            f"ms, busy {mp['busy_ms']:.3f} ms over {mp['kernels']} "
            f"kernels, {mp['nccl_kernels']} of them NCCL's "
            f"({mp['nccl_ms']:.3f} ms), against unsharded wall "
            f"{up['wall_ms']:.3f}, busy {up['busy_ms']:.3f} ms, "
            f"{up['kernels']} kernels; the eager mesh step "
            f"{m['eager_step_ms']:.1f} ms (unsharded eager "
            f"{u['eager_step_ms']:.1f} ms); the step's collectives "
            f"{m['step_collectives']}")
    return out


def mesh_serve_rank(rank, data, model, prompts, qwen, device=None,
                    engines=None):
    """One rank of phase 20 (f), started by ``run_ranks`` on its own card
    (``device="cpu"``: a gloo rank, for a rehearsal): ``engines`` ({name:
    (arch, load)}) each through :func:`engine_on` sharded over the mesh
    (its step one CUDA graph a rank, the NCCL collectives inside; the
    record under ``engine_<name>``, the tokens of every request), then
    ``Server(mesh=)`` on
    a (data, model) mesh, stablelm-1.6b FULL drawn placed from seed 0 on
    ``prompts`` (K1 + K3), then deepseek-v2-lite-16b FULL (its experts
    split over ``model``) on phase 12's prompts, ``DS_PLAIN_NEW`` new
    tokens; with ``qwen`` also qwen1.5-110b FULL at its 80 layers and
    qwen3-moe-235b-a22b FULL at its 94 (seed 0) on ``prompts``,
    ``MESH_QWEN_NEW`` new tokens, each with one profiled decode step, and
    the families' runs (:func:`family_serve`): (d)'s mamba2 and seamless
    and ``MESH_HYMBA_LONG``. Returns tokens, last logits (host), launches,
    step times and bytes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import GenRequest, Server
    from repro_torch.models import transformer
    mesh = make_local_mesh(data, model, device=device)
    card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if card
           else torch.device(device))
    out = {"card": torch.cuda.get_device_name(dev) if card else str(dev)}
    for name, (arch, load) in (engines or {}).items():
        eng, rec = engine_on(get_arch(arch).full, load, dev, mesh=mesh,
                             profiler=lambda fn: profile_once(fn, card))
        out["engine_" + name] = rec
        del eng
        if card:
            torch.cuda.empty_cache()
    ds_cfg = get_arch("deepseek-v2-lite-16b").full
    runs = [("stablelm", get_arch("stablelm-1.6b").full, LM_NEW),
            ("deepseek", ds_cfg, DS_PLAIN_NEW)]
    if qwen:
        runs += [("qwen", get_arch("qwen1.5-110b").full, MESH_QWEN_NEW),
                 ("qwen3", get_arch("qwen3-moe-235b-a22b").full,
                  MESH_QWEN_NEW)]
    for name, cfg, new in runs:
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        srv = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0,
                     mesh=mesh, device=dev)
        torch.cuda.synchronize(dev) if card else None
        init_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(dev) if card else None
        steps = []
        reqs = [GenRequest(p.copy(), new) for p in moe_prompts(cfg)] \
            if name == "deepseek" else [GenRequest((np.asarray(
                p) % cfg.vocab_size).astype(np.int32), new) for p in prompts]
        for k in (k1.KERNEL, k2.KERNEL, km.KERNEL, km.GROUPED):
            k.reset_counts()
        res = srv.generate(reqs, step_seconds=steps)
        launches = ops.launch_counts()
        rec = {"tokens": [r.out_tokens for r in res],
               "logits": srv.last_logits.float().cpu(),
               "launches": launches,
               "init_s": init_s, "prefill_s": steps[0],
               "decode_step_ms": [t * 1e3 for t in steps[1:]],
               "held_bytes": held,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev) if card
                              else None),
               "layers": cfg.n_layers}
        if name in ("qwen", "qwen3"):
            # one more decode step, profiled: the card's busy time
            batch = {"tokens": srv._place_batch(torch.zeros(
                (4, 16), dtype=torch.long, device=dev))}
            act = ProfilerActivity.CUDA if card else ProfilerActivity.CPU
            with srv._context():
                _, caches = transformer.prefill(srv.params, batch, srv.cfg,
                                                max_len=LM_MAX_LEN)
                tok = srv._place_batch(torch.zeros((4, 1), dtype=torch.long,
                                                   device=dev))
                torch.cuda.synchronize(dev) if card else None
                with profile(activities=[act]) as prof:
                    t0 = time.perf_counter()
                    transformer.decode_step(srv.params, caches, tok, 16,
                                            srv.cfg)
                    torch.cuda.synchronize(dev) if card else None
                    wall = time.perf_counter() - t0
            recs = card_records(prof)
            nccl = sum(ns for n, ns in recs if "nccl" in n.lower()) / 1e6
            rec.update(profiled_step_wall_ms=wall * 1e3,
                       profiled_step_busy_ms=sum(ns for _, ns in recs) / 1e6,
                       profiled_step_nccl_ms=nccl)
            del caches
        out[name] = rec
        del srv
    if not qwen:
        return out
    for run in (MESH_FAMILY_RUNS[0], MESH_HYMBA_LONG, MESH_FAMILY_RUNS[2]):
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        srv = Server(family_config(run[0], run[1]), batch_slots=len(run[2]),
                     max_len=run[4], seed=0, mesh=mesh, device=dev)
        torch.cuda.synchronize(dev) if card else None
        init_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(dev) if card else None
        steps = []
        toks, logits, launches = family_serve(srv, run, ops.launch_counts,
                                              reset_kernel_counts, steps)
        out[run[0]] = {
            "tokens": toks, "logits": logits, "launches": launches,
            "init_s": init_s, "prefill_s": steps[0],
            "decode_step_ms": [t * 1e3 for t in steps[1:]],
            "held_bytes": held,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if card
                           else None),
            "layers": run[1]}
        del srv
    return out


def mesh_serve_cards(n, hp, device=None):
    """Phase 20 (f), two or more cards: ``run_ranks`` with one rank a
    card on (data 1, model n) (with qwen1.5-110b and qwen3-moe-235b-a22b
    at full depth, for ``PERF.md``) and (data 2, model n/2); rank 0's
    stablelm tokens and last logits must equal (d)'s (phase 8's unsharded
    ``Server``'s) bit for bit (its 32 kv heads split over ``model``), and
    its deepseek ones phase 12's unsharded ``Server``'s on (1, n) and, on
    (2, n/2), where each data rank's rows are one dispatch group (the
    reference's rule), an unsharded ``Server`` on each group's rows
    (against the 4-row ``Server`` dispatching in 2 groups: reported),
    with the kernel launches of an unsharded step on every rank.
    On (1, n) also the families' runs, each rank's held to the unsharded
    ``Server`` on the same run (:func:`family_reference`, drawn here on
    this card first): mamba2-780m (its SSM heads split over ``model``)
    and seamless-m4t-large-v2 bit for bit, hymba-1.5b
    (``MESH_HYMBA_LONG``: its 5 kv heads split its caches' positions and
    its window's slots, combined by log-sum-exp) within rtol 1e-5 / atol
    1e-6 with tokens equal; each with the unsharded run's launches.
    Before the Servers each rank runs the engine on the mesh
    (:func:`engine_on`: stablelm on both meshes, deepseek on (1, n)),
    every rank's decode step one CUDA graph with the NCCL collectives
    inside, its launches at capture the unsharded engine's (one profiled
    replay's reported), its tokens the unsharded captured engine's.
    Helpers: phase 8's ``prompts``, ``lm_tokens``, ``lm_logits``, phase
    12's ``ds_tokens``, ``ds_logits``, and ``engine_ref`` and
    ``ds_engine_ref`` (the unsharded engines' loads, tokens and launches
    a step)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_ranks
    prompts = [np.asarray(p) for p in hp.prompts]
    want = hp.lm_logits.float().cpu()
    ds_cfg = get_arch("deepseek-v2-lite-16b").full
    q3_cfg = get_arch("qwen3-moe-235b-a22b").full
    out = {}
    shapes = [(1, n)] + ([(2, n // 2)] if n % 2 == 0 and n >= 4 else [])
    for data, model in shapes:
        ds_grouped = None
        if data == 1:
            ds_want = (hp.ds_tokens, hp.ds_logits.float().cpu())
        else:
            # each data rank's rows are one dispatch group: an unsharded
            # Server on those rows alone, the prompts left-padded as the
            # whole batch pads them, computes that group at the rank's row
            # count (a float GEMM's rounding on the card depends on its
            # rows); the 4-row Server dispatching in ``data`` groups is
            # the same function at other shapes: reported
            ds_p = moe_prompts(ds_cfg)
            width = max(len(p) for p in ds_p)
            padded = [np.concatenate([np.zeros(width - len(p), np.int32),
                                      p]) for p in ds_p]
            rows = len(padded) // data
            parts = [moe_reference(device, ds_cfg,
                                   padded[i * rows:(i + 1) * rows],
                                   DS_PLAIN_NEW) for i in range(data)]
            ds_want = ([t for part in parts for t in part[0]],
                       torch.cat([part[1] for part in parts]))
            ds_grouped = moe_reference(device, ds_cfg, ds_p, DS_PLAIN_NEW,
                                       n_groups=data)
            gc.collect()
        fam_runs = (MESH_FAMILY_RUNS[0], MESH_HYMBA_LONG,
                    MESH_FAMILY_RUNS[2]) if data == 1 else ()
        fam_want = {run[0]: family_reference(device, run, ops.launch_counts,
                                             reset_kernel_counts)
                    for run in fam_runs}
        engines = {"stablelm": ("stablelm-1.6b", hp.engine_ref["load"])}
        if data == 1:
            engines["deepseek"] = ("deepseek-v2-lite-16b",
                                   hp.ds_engine_ref["load"])
        t0 = time.perf_counter()
        res = run_ranks(mesh_serve_rank, n, device=device,
                        args=(data, model, prompts, (data, model) == (1, n),
                              device, engines),
                        timeout=1500)
        for name in engines:
            ref = hp.engine_ref if name == "stablelm" else hp.ds_engine_ref
            for r, rr in enumerate(res):
                e = rr["engine_" + name]
                # the profiled replay's kernels are reported, not held: a
                # rank may not open a second window (its peers would not
                # replay with it)
                if e["tokens"] != ref["tokens"] or (device is None and (
                        not e["graph"] or e["step_launches"] != ref["step"])):
                    raise AssertionError(
                        f"(f) ({data}, {model}) rank {r}'s {name} engine: "
                        f"graph {e['graph']}, launches at capture "
                        f"{e['step_launches']} (the unsharded engine's "
                        f"{ref['step']}), one replay "
                        f"{e['replay_profile']['by_kernel']}, tokens equal "
                        f"the unsharded engine's: "
                        f"{e['tokens'] == ref['tokens']}")
            e = res[0]["engine_" + name]
            rp = e["replay_profile"]
            log(f"  (f) (data {data}, model {model}) over {n} cards: the "
                f"{name} engine's decode step one CUDA graph on every rank "
                f"({e['step_launches']} at capture, the unsharded "
                f"engine's), captured in {e['capture_s']:.2f} s; every "
                f"rank's tokens equal the unsharded engine's on the "
                f"{len(e['tokens'])}-request mixed load ({e['load_tokens']} "
                f"tokens in {e['load_s']:.2f} s = {e['tok_per_s']:.1f} "
                f"tok/s); rank 0's replay {e['replay_ms']:.3f} ms (median, "
                f"synchronized; eager step {e['eager_step_ms']:.1f} ms), "
                f"profiled busy {rp['busy_ms']:.3f} ms over "
                f"{rp['kernels']} kernels, {rp['nccl_kernels']} NCCL "
                f"({rp['nccl_ms']:.3f} ms, waits included), LM kernels "
                f"{rp['by_kernel']}; the step's collectives a rank "
                f"{e['step_collectives']}")
        st, ds = res[0]["stablelm"], res[0]["deepseek"]
        if st["tokens"] != hp.lm_tokens or not torch.equal(st["logits"],
                                                           want):
            raise AssertionError(f"(f) ({data}, {model}): rank 0's tokens "
                                 "or last logits differ from (d)'s")
        if ds["tokens"] != ds_want[0] or not torch.equal(ds["logits"],
                                                         ds_want[1]):
            raise AssertionError(f"(f) ({data}, {model}): rank 0's deepseek "
                                 "tokens or last logits differ from the "
                                 f"unsharded Server's on each group's rows")
        grouped = None
        if ds_grouped is not None:
            grouped = {
                "max_abs_logit_diff": float((ds["logits"] - ds_grouped[1])
                                            .abs().max()),
                "rows_with_equal_tokens": sum(
                    a == b for a, b in zip(ds["tokens"], ds_grouped[0]))}
        per = {"stablelm": {"K1": 4 * 24 * LM_NEW, "K3": 7 * 24 * LM_NEW},
               "deepseek": {k: v * DS_PLAIN_NEW
                            for k, v in moe_per_step(ds_cfg).items()},
               "qwen3": {k: v * MESH_QWEN_NEW
                         for k, v in moe_per_step(q3_cfg).items()}}
        bad = [(r, name, rr[name]["launches"]) for r, rr in enumerate(res)
               for name, want_c in per.items() if name in rr
               and any(rr[name]["launches"][k] != v
                       for k, v in want_c.items())]
        if device is None and bad:
            raise AssertionError(f"(f) ({data}, {model}): launches {bad}, "
                                 f"want {per} on each rank")
        for r, rr in enumerate(res[1:], 1):
            for name in ("stablelm", "deepseek"):
                if rr[name]["tokens"] != res[0][name]["tokens"]:
                    raise AssertionError(f"(f) rank {r}'s {name} tokens "
                                         "differ")
        for arch, (w_toks, w_logits, w_launches, w_steps) in fam_want.items():
            for r, rr in enumerate(res):
                got = rr[arch]
                split = arch == "hymba-1.5b"
                close = (torch.allclose(got["logits"], w_logits, rtol=1e-5,
                                        atol=1e-6) if split else
                         torch.equal(got["logits"], w_logits))
                if got["tokens"] != w_toks or not close:
                    raise AssertionError(
                        f"(f) ({data}, {model}) rank {r}'s {arch} tokens or "
                        "last logits differ from the unsharded Server's"
                        + (" beyond rtol 1e-5 / atol 1e-6" if split else "")
                        + f" (tokens equal: {got['tokens'] == w_toks}; max "
                        f"abs logit difference "
                        f"{float((got['logits'] - w_logits).abs().max())!r})")
                if device is None and got["launches"] != w_launches:
                    raise AssertionError(f"(f) rank {r}'s {arch} launches "
                                         f"{got['launches']}, want "
                                         f"{w_launches}")
            r0 = res[0][arch]
            err = float((r0["logits"] - w_logits).abs().max())
            log(f"  (f) {arch} ({r0['layers']} layers) on (data 1, model "
                f"{n}): every rank's tokens and last logits equal the "
                f"unsharded Server's " + ("within rtol 1e-5 / atol 1e-6 "
                                          f"(max abs {err!r})" if arch ==
                                          "hymba-1.5b" else "bit for bit")
                + f"; launches {r0['launches']} (the unsharded run's); "
                f"decode step ms (median) "
                f"{statistics.median(r0['decode_step_ms']):.1f} against "
                f"{statistics.median([t * 1e3 for t in w_steps[1:]]):.1f} "
                f"unsharded; drawn placed in {r0['init_s']:.1f} s; held GB "
                f"per card " + " ".join(
                    f"{(rr[arch]['held_bytes'] or 0) / 1e9:.2f}"
                    for rr in res))
        tag = f"{data}x{model}"
        out[tag] = {"ranks": [{k: {kk: vv for kk, vv in v.items()
                                   if kk != "logits"}
                               if isinstance(v, dict) else v
                               for k, v in rr.items()} for rr in res],
                    "deepseek_against_grouped_4_rows": grouped,
                    "families_unsharded": {
                        arch: {"tokens": w[0], "launches": w[2],
                               "decode_step_ms": [t * 1e3 for t in w[3][1:]]}
                        for arch, w in fam_want.items()},
                    "seconds": time.perf_counter() - t0}
        if grouped is not None:
            log(f"  (f) ({data}, {model}) deepseek against the 4-row "
                f"unsharded Server dispatching in {data} groups (reported): "
                f"{grouped['rows_with_equal_tokens']} of 4 rows' tokens "
                f"equal, largest logit difference "
                f"{grouped['max_abs_logit_diff']!r}")
        for name, what in (("stablelm", "(d)'s"),
                           ("deepseek", "the unsharded Server's" + (
                               " on each data rank's rows" if data > 1
                               else ""))):
            r0 = res[0][name]
            log(f"  (f) (data {data}, model {model}) over {n} cards: {name} "
                f"rank 0's tokens and last logits equal {what} bit for "
                f"bit; launches {r0['launches']}; decode step ms (median) "
                f"{statistics.median(r0['decode_step_ms']):.1f}; drawn "
                f"placed in {r0['init_s']:.1f} s; held GB per card "
                + " ".join(f"{(rr[name]['held_bytes'] or 0) / 1e9:.2f}"
                           for rr in res))
        for name, arch in (("qwen", "qwen1.5-110b"),
                           ("qwen3", "qwen3-moe-235b-a22b")):
            if name not in res[0]:
                continue
            q = res[0][name]
            finite = bool(torch.isfinite(q["logits"]).all())
            if not finite or any(len(t) != MESH_QWEN_NEW for t in
                                 q["tokens"]):
                raise AssertionError(f"(f) {arch}: bad output")
            log(f"  (f) {arch} FULL ({q['layers']} layers) on (data 1, "
                f"model {n}): drawn placed in {q['init_s']:.1f} s; prefill "
                f"{q['prefill_s']:.2f} s; decode step ms (host clock) "
                + " ".join(f"{t:.1f}" for t in q["decode_step_ms"])
                + f"; one profiled step wall {q['profiled_step_wall_ms']:.1f}"
                f" ms, busy {q['profiled_step_busy_ms']:.1f} ms (NCCL's "
                f"kernels, waits included, "
                f"{q['profiled_step_nccl_ms']:.1f}); launches "
                f"{q['launches']}; held / peak GB per card " + " ".join(
                    f"{(rr[name]['held_bytes'] or 0) / 1e9:.2f}/"
                    f"{(rr[name]['peak_bytes'] or 0) / 1e9:.2f}"
                    for rr in res))
    return out


def mesh_phase(dev, hp):
    """Phase 20: sharding one model's tensors (``distributed/sharding.py``
    on DTensor, ``Trainer(mesh=)``). Helpers from ``main``: ``counts``,
    ``reset_counts``, ``profiled``, ``is_spin``, and phase 8's ``prompts``,
    ``lm_tokens`` and ``lm_logits``, phase 12's ``ds_prompts``,
    ``ds_tokens`` and ``ds_logits``, phase 15's run 1 ``ssm_tokens``
    (by arch). Returns the phase's record; its
    ``launches`` are the packed evaluations' K1 and K3 and (d)'s servers'
    K1, K3, K4 and grouped K4 ((e)'s comparisons with the plain versions
    are not counted); raises on any failure."""
    import gc

    import torch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import placed
    from repro_torch.launch.mesh import (close_local_mesh, make_local_mesh,
                                         run_ranks)
    from repro_torch.launch.train import Trainer, make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    cfg = mesh_config()
    opt = AdamWConfig(**MESH_OPT)
    kw = dict(opt_cfg=opt, batch_size=MESH_BATCH, seq_len=MESH_SEQ, seed=0,
              device=dev)
    out = {"launches": dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)}
    log(f"phase 20: a mesh — Trainer(stablelm-1.6b FULL, {cfg.n_layers} "
        f"layers, float32, W4A8 qat, batch {MESH_BATCH}, seq {MESH_SEQ}, "
        f"seed 0), {MESH_STEPS} steps, unsharded and on a (data 1, model 1) "
        f"NCCL mesh of this card")

    # (a) the unsharded Trainer, then the same on a mesh of one card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    plain_tr = Trainer(cfg, **kw)
    pstate, plosses = plain_tr.run(MESH_STEPS, log_every=MESH_STEPS)
    p_params = pstate["params"]
    mark("unsharded run")
    mesh = make_local_mesh(1, 1)
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"the card's mesh group is {backend}, not nccl")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh_tr = Trainer(cfg, mesh=mesh, **kw)
    t0 = time.perf_counter()
    mstate, mlosses = mesh_tr.run(MESH_STEPS, log_every=MESH_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    mark("mesh run")
    peak = torch.cuda.max_memory_allocated() - mem0
    keys = ("loss", "ce", "lr", "grad_norm")
    hist_p = [[h[k] for k in keys] for h in plain_tr.history]
    hist_m = [[h[k] for k in keys] for h in mesh_tr.history]
    if hist_m != hist_p:
        raise AssertionError(f"mesh of one: history {hist_m} against the "
                             f"unsharded {hist_p}")
    m_leaves = tree_leaves(mstate["params"])
    p_leaves = tree_leaves(p_params)
    placed_leaves = sum(placed.is_placed(t) for t in m_leaves)
    differ = [i for i, (a, b) in enumerate(zip(m_leaves, p_leaves))
              if not torch.equal(a.to_local(), b)]
    if differ or placed_leaves != len(m_leaves):
        raise AssertionError(f"mesh of one: params {differ} differ from the "
                             f"unsharded run's ({placed_leaves} of "
                             f"{len(m_leaves)} placed)")
    step_ms = [h["seconds"] * 1e3 for h in mesh_tr.history]
    plain_ms = [h["seconds"] * 1e3 for h in plain_tr.history]
    out["a"] = dict(losses=mlosses, grad_norms=[h[3] for h in hist_m],
                    step_ms=step_ms, unsharded_step_ms=plain_ms,
                    run_s=run_s, peak_gb=peak / 1e9, backend=backend,
                    leaves=len(m_leaves))
    log(f"  (a) losses " + " ".join(f"{l:.4f}" for l in mlosses)
        + f", grad norms " + " ".join(f"{h[3]:.3f}" for h in hist_m)
        + f": equal to the unsharded Trainer's bit for bit, and so are all "
        f"{len(m_leaves)} param leaves (every one a DTensor on the {backend}"
        f" mesh); step ms (synchronized) " + " ".join(
            f"{t:.1f}" for t in step_ms) + " against unsharded "
        + " ".join(f"{t:.1f}" for t in plain_ms)
        + f"; peak {peak / 1e9:.2f} GB above what was held")

    # (b) the mesh run's placed params packed once (gathered, packed,
    # placed again by param_pspec), evaluated through K1 + K3 on the mesh
    # (each rank's planes, the row-parallel int32 sums) and, gathered, as
    # plain tensors: the same planes, no second packing
    scfg = transformer.serve_policy(cfg, pack_acts=True)
    hb = mesh_tr.device_batch(mesh_tr.data.batch(10_001, MESH_BATCH))
    k1_fwd, k3_fwd = 4 * cfg.n_layers, 7 * cfg.n_layers
    want = {"K1": k1_fwd, "K2": 0, "K3": k3_fwd, "K4": 0, "K4g": 0}
    with torch.no_grad():
        t0 = time.perf_counter()
        packed_m = transformer.pack_params(mstate["params"], scfg)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        hp.reset_counts()
        with placed.mesh_context(mesh):
            l_m, _ = transformer.loss_fn(packed_m, hb, scfg)
        l_m = placed.plain(l_m)
        torch.cuda.synchronize()
        c_m = hp.counts()
        packed_p = _tree_map(placed.plain, packed_m)
        hp.reset_counts()
        l_p, _ = transformer.loss_fn(
            packed_p, {k: placed.plain(v) for k, v in hb.items()}, scfg)
        torch.cuda.synchronize()
        c_p = hp.counts()
        del packed_m, packed_p
    if c_m != want or c_p != want:
        raise AssertionError(f"packed evaluations' launches {c_m}, {c_p}; "
                             f"want {want}")
    if not torch.equal(l_m, l_p):
        raise AssertionError(f"packed loss on the mesh {float(l_m)!r} "
                             f"against the gathered planes' {float(l_p)!r}")
    for k in out["launches"]:
        out["launches"][k] += c_m[k] + c_p[k]
    out["b"] = dict(loss=float(l_m), launches=c_m, pack_s=pack_s)
    log(f"  (b) the mesh run's placed params packed once ({pack_s:.2f} s): "
        f"the held-out batch's integer loss through K1 + K3 on the mesh "
        f"(row-parallel int32 sums) {float(l_m)!r} equals the gathered "
        f"planes' bit for bit; launches {c_m} each")
    mark("packed evaluations")

    # one more mesh step, donated, profiled: the card's busy time in it
    # and in its parts, read from the trace's own events (key_averages'
    # processing of the step's 141k events took 16 s); the unsharded step
    # is not profiled
    del p_leaves, m_leaves, pstate
    parts = ("train_step.forward", "train_step.backward", "train_step.adamw")
    step_fn = make_train_step(cfg, opt, donate=True)
    mb = mesh_tr.device_batch(mesh_tr.data.batch(MESH_STEPS, MESH_BATCH))
    with placed.mesh_context(mesh):
        window, wall = hp.profiled(lambda: step_fn(mstate, mb))
    ms, launches = {}, {}
    for name, ns in card_records(window):
        if not hp.is_spin(name):
            ms[name] = ms.get(name, 0.0) + ns / 1e6
            launches[name] = launches.get(name, 0) + 1
    top = sorted(ms, key=lambda k: -ms[k])[:12]
    prof = {"wall_ms": wall * 1e3, "device_ms": sum(ms.values()),
            "kernels": sum(launches.values()),
            "ranges": range_split(window, parts),
            "by_name_ms": {k: ms[k] for k in top},
            "launches": {k: launches[k] for k in top}}
    out["profile"] = prof
    mark("profiled mesh step")
    log(f"  one profiled mesh step: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['device_ms']:.1f} ms over {prof['kernels']:.0f} "
        f"kernels; in its parts (issued on the host, done on the card, "
        f"busy ms): " + "; ".join(
            f"{k.split('.')[1]} {v['issued']:.1f}, {v['done']:.1f}, "
            f"{v['busy']:.1f}" for k, v in prof["ranges"].items()))
    for name, ms_ in list(prof["by_name_ms"].items())[:6]:
        log(f"    {ms_:8.2f} ms  x{prof['launches'][name]:5.0f}  {name[:90]}")
    del mstate, p_params, mesh_tr, plain_tr, step_fn, mb
    gc.collect()
    torch.cuda.empty_cache()
    t_de = time.perf_counter()
    out["d"] = mesh_serve(dev, hp, mesh)
    for k in out["launches"]:
        out["launches"][k] += out["d"]["launches"][k]
    mark("(d) sharded Server")
    out["d_moe"] = mesh_serve_moe(dev, hp, mesh)
    for k in out["launches"]:
        out["launches"][k] += out["d_moe"]["launches"][k]
    mark("(d) sharded MoE Server")
    out["d_families"] = mesh_serve_families(dev, hp, mesh)
    for k in out["launches"]:
        out["launches"][k] += out["d_families"]["launches"][k]
    mark("(d) sharded SSM, hybrid and encoder-decoder Servers")
    out["d_engine"] = mesh_engine(dev, hp, mesh)
    for k in out["launches"]:
        out["launches"][k] += out["d_engine"]["launches"][k]
    mark("(d) the engine on the mesh")
    out["e"] = split_arithmetic(dev)
    mark("(e) split arithmetic")
    out["de_s"] = time.perf_counter() - t_de
    log(f"  (d) + (e) in {out['de_s']:.1f} s")
    close_local_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    mark("cleanup")
    out["part_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    log("  phase 20's parts, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["part_s"].items()))

    # (c) more than one card: one rank a card over NCCL. LSQ's rounding is
    # discontinuous: the mesh's reordered sums flip activation codes, which
    # 24 layers amplify, so the qat losses are reported and the float
    # config's are held, against an unsharded float run on this card
    n = torch.cuda.device_count()
    out["c_ran"] = n >= 2
    if n >= 2:
        data = 2 if n % 2 == 0 and n >= 4 else 1
        model = n // data
        t0 = time.perf_counter()
        ftr = Trainer(mesh_config(float_only=True), **kw)
        _, flosses = ftr.run(MESH_STEPS, log_every=MESH_STEPS)
        fgn = [h["grad_norm"] for h in ftr.history]
        del ftr, _
        gc.collect()
        torch.cuda.empty_cache()
        res = run_ranks(mesh_card_rank, n, args=(data, model), timeout=900)
        got = res[0]["float"]
        for name, a, b in (("losses", got["losses"], flosses),
                           ("grad norms", got["grad_norms"], fgn)):
            if any(abs(x - y) > 1e-4 * abs(y) for x, y in zip(a, b)):
                raise AssertionError(f"(c) float {name} {a} against the "
                                     f"unsharded run's {b} (rtol 1e-4)")
        qat = res[0]["qat"]["losses"]
        # each rank's traced step against the same step on a fake mesh
        fake = fake_mesh_step_cost(mesh_config(float_only=True), data, model)
        for r, rr in enumerate(res):
            if rr["float"]["cost"] != fake:
                raise AssertionError(f"(c) rank {r}'s collectives "
                                     f"{rr['float']['cost']} against a "
                                     f"fake mesh's {fake}")
        out["c"] = dict(mesh=[data, model], ranks=res,
                        unsharded_float=dict(losses=flosses, grad_norms=fgn),
                        fake_mesh_cost=fake,
                        seconds=time.perf_counter() - t0)
        log(f"  (c) (data {data}, model {model}) over {n} cards: float "
            f"losses " + " ".join(f"{l:.5f}" for l in got["losses"])
            + " within rtol 1e-4 of the unsharded float run's; qat losses "
            + " ".join(f"{l:.4f}" for l in qat) + " against (a)'s "
            + " ".join(f"{l:.4f}" for l in mlosses) + " (reported); per "
            "card peak GB (qat) " + " ".join(
                f"{r['qat']['peak_bytes'] / 1e9:.2f}" for r in res)
            + ", state GB per card " + " ".join(
                f"{r['qat']['state_bytes'] / 1e9:.2f}" for r in res)
            + "; each rank's traced step's collectives equal a fake "
            f"({data}, {model}) mesh's: "
            f"{ {k: int(v) for k, v in fake['counts'].items() if v} }, "
            f"{sum(fake['bytes'].values()) / 1e9:.3f} GB")
        out["f"] = mesh_serve_cards(n, hp)
    else:
        log(f"  (c), (f) not run: {n} card visible (they need two or more)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20 in {out['seconds']:.1f} s; ran (c): {out['c_ran']}; "
        f"launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 21: the cost analysis (launch/hlo_analysis.py) on the card

COST_ROWS, COST_PROMPT = 4, 64    # the counted prefill, and its decode step
COST_MAX_LEN = COST_PROMPT + 8
KIDS = ("K1", "K2", "K3", "K4", "K4g")


def cost_phase(dev, hp):
    """Phase 21: ``launch/hlo_analysis.py`` on the card. Helpers from
    ``main``: ``counts``, ``reset_counts``, ``profiled``, ``is_spin``,
    ``program`` and ``images`` (phase 4's ResNet9 Program and its batch of
    32 on the card), ``smi``. Returns the phase's record (its
    ``launches``: every kernel launch the phase made); raises on any
    failure."""
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from repro_torch.compiler import executor
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer
    from repro_torch.obs.profiler import HBM_BW, PEAK_BF16, PEAK_INT8

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    hp.reset_counts()
    out = {}
    log(f"phase 21: the cost analysis on the card ({hp.smi}): one call's "
        "record under CostMode on the card against the same call's on the "
        "meta device, field for field; kernel calls against the wrappers' "
        "counts and the profiler's launches by name")

    # (a) stablelm-1.6b FULL (24 layers, W4A8, K1 + K3) and ResNet9 W2A2
    cfg = get_arch("stablelm-1.6b").full
    t0 = time.perf_counter()
    srv = Server(cfg, batch_slots=COST_ROWS, max_len=COST_MAX_LEN, seed=0,
                 device=dev)
    msrv = Server(cfg, transformer.init_params(dryrun._MetaGenerator(), cfg,
                                               packed=True),
                  batch_slots=COST_ROWS, max_len=COST_MAX_LEN, device="meta")
    out["draw_s"] = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (COST_ROWS, COST_PROMPT))).to(dev)
    with torch.inference_mode():
        logits, caches = transformer.prefill(
            srv.params, {"tokens": toks}, srv.cfg, max_len=COST_MAX_LEN)
        nxt = torch.argmax(logits, -1)[:, None]
        _, mcaches = transformer.prefill(
            msrv.params, {"tokens": toks.to("meta")}, msrv.cfg,
            max_len=COST_MAX_LEN)
    torch.cuda.synchronize()

    def lm_prefill(s, t):
        return lambda: transformer.prefill(s.params, {"tokens": t}, s.cfg,
                                           max_len=COST_MAX_LEN)

    def lm_decode(s, c, t):
        # writes slot COST_PROMPT of the prefill's caches: the same each call
        return lambda: transformer.decode_step(s.params, c, t, COST_PROMPT,
                                               s.cfg)

    prog, x32 = hp.program, hp.images
    mparams = _tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t,
                        prog.params)
    mx32 = x32.to("meta")
    run = executor.make_runner(prog)
    lm_step = {"K1": 4 * cfg.n_layers, "K3": 7 * cfg.n_layers}
    calls = (
        ("stablelm_prefill", lm_prefill(srv, toks),
         lm_prefill(msrv, toks.to("meta")), lm_step),
        ("stablelm_decode", lm_decode(srv, caches, nxt),
         lm_decode(msrv, mcaches, nxt.to("meta")), lm_step),
        ("resnet9_forward", lambda: run(prog.params, x32),
         lambda: run(mparams, mx32), {"K1": 3, "K2": 8}))

    for tag, on_card, on_meta, want in calls:
        want = dict(dict.fromkeys(KIDS, 0), **want)
        before = hp.counts()
        with torch.inference_mode():
            _, card = analyze(on_card)
            torch.cuda.synchronize()
            got = {k: hp.counts()[k] - before[k] for k in KIDS}
            _, meta = analyze(on_meta)
        cd, md = card.as_dict(), meta.as_dict()
        if cd != md:
            diff = {k: (cd[k], md[k]) for k in cd if cd[k] != md[k]}
            raise AssertionError(f"(a) {tag}: the card's record differs "
                                 f"from the meta device's: {diff}")
        if card.kernel_calls != got or got != want:
            raise AssertionError(f"(a) {tag}: kernel calls "
                                 f"{card.kernel_calls}, wrappers' counts "
                                 f"{got}, want {want}")
        # (b) the same call with no mode: launches by kernel name, busy
        with torch.inference_mode():
            prof, wall = hp.profiled(on_card, expect=want)
        busy, by = 0.0, dict.fromkeys(KIDS, 0)
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA or hp.is_spin(evt.key):
                continue
            busy += evt.self_device_time_total / 1e3
            kid = kernel_of(evt.key)
            if kid is not None:
                by[kid] += evt.count
        if by != want:
            raise AssertionError(f"(a) {tag}: the profiler saw {by} "
                                 f"launches by kernel name, want {want}")
        fl = cd["flops"] - cd["flops_int"]
        shares = {"int8": cd["flops_int"] / (busy * 1e-3) / PEAK_INT8,
                  "bf16": fl / (busy * 1e-3) / PEAK_BF16,
                  "hbm": cd["bytes_hbm"] / (busy * 1e-3) / HBM_BW}
        out[tag] = {"cost": {k: v for k, v in cd.items() if k != "ops"},
                    "ops": sum(cd["ops"].values()),
                    "busy_ms": busy, "wall_ms": wall * 1e3,
                    "shares_of_peak": shares}
        log(f"  (a) {tag}: card == meta, field for field ({out[tag]['ops']} "
            f"ops); kernel calls {dict((k, v) for k, v in got.items() if v)}"
            f" = the wrappers' counts = the profiler's launches by name; "
            f"flops {cd['flops']:.6g} (int {cd['flops_int']:.6g}, float "
            f"{fl:.6g}), HBM bytes {cd['bytes_hbm']:.6g}")
        log(f"  (b) {tag}: busy {busy:.3f} ms (wall {wall * 1e3:.3f}): "
            f"int8 {shares['int8']:.4%} of {PEAK_INT8 / 1e12:.0f} TOP/s, "
            f"float {shares['bf16']:.4%} of {PEAK_BF16 / 1e12:.0f} TFLOP/s "
            f"(bf16), HBM {shares['hbm']:.4%} of {HBM_BW / 1e12:.2f} TB/s "
            f"on {hp.smi}")
    del srv, msrv, caches, mcaches, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a train_4k cell on the fake 16 x 16 mesh, in this process
    t0 = time.perf_counter()
    rec = dryrun.cost_cell(dryrun.build_cell("stablelm-1.6b", "train_4k",
                                             n_layers=2), "single")
    col = rec["collectives"]
    if (not rec["flops"] > 0 or col["counts"]["all-gather"] <= 0
            or col["counts"]["all-reduce"] <= 0
            or rec["cost_mesh"] != {"data": 16, "model": 16}):
        raise AssertionError(f"(c) train_4k on the fake mesh: {rec}")
    out["train_4k_fake_mesh"] = {k: v for k, v in rec.items() if k != "ops"}
    log(f"  (c) stablelm-1.6b train_4k at 2 layers, a step on one device of "
        f"a fake 16x16 mesh under torch {torch.__version__}: "
        f"{rec['flops'] / 1e12:.4f} TFLOP, HBM {rec['bytes_hbm'] / 1e9:.2f}"
        f" GB, collectives {col['total_bytes'] / 1e9:.4f} GB "
        f"{ {k: int(v) for k, v in col['counts'].items() if v} } "
        f"({time.perf_counter() - t0:.1f} s)")
    # ... and a decode_32k serve cell there: the sharded Server's step,
    # K3 on each rank's planes, the row-parallel int32 sums all-reduced
    t0 = time.perf_counter()
    rec = dryrun.cost_cell(dryrun.build_cell("stablelm-1.6b", "decode_32k",
                                             n_layers=2), "single")
    col = rec["collectives"]
    if (rec["cost_mesh"] != {"data": 16, "model": 16}
            or col["counts"]["all-reduce"] < 2 * 2
            or rec["kernel_calls"]["K3"] != 7 * 2):
        raise AssertionError(f"(c) decode_32k on the fake mesh: {rec}")
    out["decode_32k_fake_mesh"] = {k: v for k, v in rec.items()
                                   if k != "ops"}
    log(f"  (c) stablelm-1.6b decode_32k at 2 layers, a sharded Server's "
        f"step on one device of a fake 16x16 mesh: "
        f"{rec['flops'] / 1e9:.4f} GFLOP (int {rec['flops_int'] / 1e9:.4f}),"
        f" HBM {rec['bytes_hbm'] / 1e9:.2f} GB, collectives "
        f"{col['total_bytes'] / 1e6:.4f} MB "
        f"{ {k: int(v) for k, v in col['counts'].items() if v} }, kernels "
        f"{ {k: v for k, v in rec['kernel_calls'].items() if v} } "
        f"({time.perf_counter() - t0:.1f} s)")
    out["launches"] = {k: hp.counts()[k] for k in KIDS}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 22: the tile autotuner (kernels/tuning.py) on the card

TUNE_REPS = 10          # cold Timer repetitions a tile
TUNE_TOP_K = 4          # the measured re-rank's analytic shortlist
TUNE_BUCKETS = (1, 8, 32)
TUNE_WALLS = 15         # replays of each bucket graph, tiled and untiled
TUNE_PROMPT = 16        # the stablelm decode step's prefill, 4 rows


def tuning_phase(dev, hp):
    """Phase 22: ``kernels/tuning.py`` on the card. Helpers from ``main``:
    ``counts``, ``reset_counts``, ``timer``, ``program`` and ``images``
    (phase 4's tuned ResNet9 Program and its 32 images on the card),
    ``smi``. Returns the phase's record: ``launches`` holds the main-path
    launches of (b) (the bucket graphs' replays, the decode steps), not
    the checks' of (a); ``tiles_held`` the tiles (a) held per kernel.
    Raises on any failure."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.compiler import executor
    from repro_torch.configs import get_arch
    from repro_torch.core.bitserial import plan_spec
    from repro_torch.kernels import tile_sweep, tuning
    from repro_torch.launch.serve import Server, resnet9_recipe
    from repro_torch.models import transformer
    from repro_torch.serving import InferenceService, ModelRegistry

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"shapes": []}
    old_store = tuning.set_persistent_store(None)
    tuning.clear_cache()
    lm_cfg = get_arch("stablelm-1.6b").full
    log(f"phase 22: the tile autotuner on the card ({hp.smi}): every "
        "candidate tile of K2, K3 and K4 against its plain version at the "
        "main paths' shapes; the heuristic's, the analytic and the measured "
        "choice's cold times")

    # (a) every candidate tile against the plain version; three times
    held = dict.fromkeys(("K2", "K3", "K4"), 0)
    t0 = time.perf_counter()
    for kid, label, fn, ref, args, kw, cands, shape in tile_sweep.cases(
            dev, np.random.default_rng(22), lm_cfg):
        tile_sweep.check_tiles(kid, fn, ref, args, kw, cands)
        held[kid] += len(cands)
        ms = {}

        def measure(c, fn=fn, args=args, kw=kw, ms=ms):
            point = tuple(c.kernel_kwargs().values())
            if point not in ms:
                ms[point] = hp.timer(lambda: fn(*args, tile=c, **kw),
                                     TUNE_REPS)
            return ms[point]
        heur = tile_sweep.heuristic_point(kid, shape)
        enum0 = tuning.cache_info()["enumerations"]
        if kid == "K2":
            analytic = tuning.choose_conv_tile(**shape)
            measured = tuning.choose_conv_tile_measured(
                **shape, measure=measure, top_k=TUNE_TOP_K)
        else:
            key = dict(shape)
            m, k, n, spec = (key.pop(x) for x in ("m", "k", "n", "spec"))
            analytic = tuning.choose_tile(m, k, n, spec, **key)
            measured = tuning.choose_tile_measured(
                m, k, n, spec, measure=measure, top_k=TUNE_TOP_K, **key)
        if analytic != cands[0]:
            raise AssertionError(f"(a) {kid} {label}: the tuner chose "
                                 f"{analytic}, its ranking {cands[0]}")
        # the re-rank timed its shortlist here unless an identical shape
        # came before (conv1 and conv2): then it is the L1's decision
        reranked = tuning.cache_info()["enumerations"] > enum0
        t_h = measure(tile_sweep.tile_of(kid, *heur))
        t_a, t_m = measure(analytic), measure(measured)
        if reranked and t_m > t_a:
            raise AssertionError(f"(a) {kid} {label}: the measured re-rank "
                                 f"({t_m} ms) is slower than the analytic "
                                 f"choice ({t_a} ms)")
        rec = {"kernel": kid, "shape": label, "tiles": len(cands),
               "heuristic": list(heur),
               "analytic": list(analytic.kernel_kwargs().values()),
               "measured": list(measured.kernel_kwargs().values()),
               "heuristic_ms": t_h, "analytic_ms": t_a, "measured_ms": t_m,
               "reranked_here": reranked,
               "analytic_over_heuristic": t_a / t_h,
               "measured_over_heuristic": t_m / t_h}
        out["shapes"].append(rec)
        log(f"  (a) {kid} {label}: {len(cands)} tiles equal the plain "
            f"version; heuristic {tuple(heur)} {t_h:.4f} ms, analytic "
            f"{tuple(rec['analytic'])} {t_a:.4f} ms "
            f"({rec['analytic_over_heuristic']:.3f}x), measured "
            f"{tuple(rec['measured'])} {t_m:.4f} ms "
            f"({rec['measured_over_heuristic']:.3f}x"
            + ("" if reranked else ", an earlier identical shape's") + ")")
        del args, kw
    out["a_seconds"] = time.perf_counter() - t0
    out["tiles_held"] = held
    worst = max(out["shapes"], key=lambda r: r["analytic_over_heuristic"])
    log(f"  (a) {sum(held.values())} tiles held ({held}) in "
        f"{out['a_seconds']:.1f} s; the analytic choice's largest ratio to "
        f"the heuristic {worst['analytic_over_heuristic']:.3f}x "
        f"({worst['kernel']} {worst['shape']}), reported, not held")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the tuned ResNet9 Program's bucket graphs and a stablelm decode
    # step against the plain path; the same Program launched untiled
    prog = hp.program
    packed = [st for st in prog.steps if st.kind == "conv_packed"]
    if not all(isinstance(st.attrs.get("tile"), tuning.ConvTileConfig)
               for st in packed):
        raise AssertionError("(b) phase 4's Program carries no tiles")
    untiled = dataclasses.replace(prog, steps=tuple(
        dataclasses.replace(st, attrs={k: v for k, v in st.attrs.items()
                                       if k != "tile"})
        for st in prog.steps))
    plain = executor.make_plain_runner(prog)
    runners = {"tiled": executor.BucketedRunner(prog, max_batch=32),
               "untiled": executor.BucketedRunner(untiled, max_batch=32)}
    ran = dict.fromkeys(KIDS, 0)
    out["buckets"] = {}
    for b in TUNE_BUCKETS:
        x = hp.images[:b]
        with torch.no_grad():
            want = plain(prog.params, x)
        walls = {"tiled": [], "untiled": []}
        for name, r in runners.items():
            got = r(x)                      # captures the bucket's graph
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"(b) bucket {b}, {name}: the replay "
                                     "differs from the plain path")
        for i in range(TUNE_WALLS):
            order = ("tiled", "untiled") if i % 2 == 0 else ("untiled",
                                                              "tiled")
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = runners[name](x)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
                if not torch.equal(got, want):
                    raise AssertionError(f"(b) bucket {b}, {name}: a "
                                         "replay differs")
        cap = runners["tiled"].capture_launches[(0, b)]
        for kid in ran:
            ran[kid] += cap[kid] * (TUNE_WALLS + 1)
        tiles = {st.name: list(tuning.choose_conv_tile(
            b, c.h, c.w, c.c_in, c.c_out, fh=c.fh, fw=c.fw,
            stride=c.stride, padding=c.padding, spec=st.attrs["spec"],
            out_bits=(st.attrs["requant_bits"] if st.attrs["out"] == "packed"
                      else None)).kernel_kwargs().values())
            for st in packed
            for c in prog.cost_nodes if c.name == st.name}
        rec = {"tiled_ms": statistics.median(walls["tiled"]),
               "untiled_ms": statistics.median(walls["untiled"]),
               "tiled_ms_runs": walls["tiled"],
               "untiled_ms_runs": walls["untiled"], "tiles": tiles,
               "launches_per_replay": cap}
        out["buckets"][b] = rec
        log(f"  (b) ResNet9 bucket {b}: the tuned and the untiled graphs' "
            f"replays equal the plain path; replay {rec['tiled_ms']:.4f} ms "
            f"tuned vs {rec['untiled_ms']:.4f} ms untiled (median of "
            f"{TUNE_WALLS}, host clock); tiles (nt, warps) {tiles}")
    del runners
    srv = Server(lm_cfg, batch_slots=4, max_len=TUNE_PROMPT + 4, seed=0,
                 device=dev)
    toks = torch.from_numpy(np.random.default_rng(29).integers(
        0, lm_cfg.vocab_size, (4, TUNE_PROMPT))).to(dev)
    plain_cfg = transformer.serve_policy(srv.cfg, plain=True)
    with torch.inference_mode():
        logits, caches = transformer.prefill(
            srv.params, {"tokens": toks}, srv.cfg,
            max_len=TUNE_PROMPT + 4)
        nxt = torch.argmax(logits, -1)[:, None]
        steps = {}
        for name, cfg in (("tuned", srv.cfg), ("plain", plain_cfg)):
            before = hp.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = transformer.decode_step(srv.params, caches, nxt,
                                            TUNE_PROMPT, cfg)
            torch.cuda.synchronize()
            steps[name] = (lg, (time.perf_counter() - t0) * 1e3,
                           {k: hp.counts()[k] - before[k] for k in KIDS})
    if not torch.equal(steps["tuned"][0], steps["plain"][0]):
        raise AssertionError("(b) the stablelm decode step's logits differ "
                             "from the plain path's")
    if (steps["tuned"][2]["K3"] != 7 * lm_cfg.n_layers
            or any(steps["plain"][2].values())):
        raise AssertionError(f"(b) decode step launches {steps}")
    for kid in ran:
        ran[kid] += steps["tuned"][2][kid]
    lm_spec = plan_spec(srv.cfg.policy.spec())
    lm_tiles = {f"{k}->{n}": list(tuning.choose_tile(
        4, k, n, lm_spec).kernel_kwargs().values())
        for k, n in tile_sweep.lm_projections(lm_cfg)}
    out["lm_decode"] = {"tuned_ms": steps["tuned"][1],
                        "plain_ms": steps["plain"][1],
                        "launches": steps["tuned"][2], "tiles": lm_tiles}
    log(f"  (b) stablelm-1.6b ({lm_cfg.n_layers} layers, W4A8) decode step "
        f"at batch 4: logits equal the plain path's; "
        f"{steps['tuned'][1]:.1f} ms eager "
        f"({steps['tuned'][2]['K3']} K3), plain {steps['plain'][1]:.1f} ms;"
        f" K3 tiles at M = 4 {lm_tiles}")
    del srv, caches, logits, steps
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a warm boot from a store the phase populates enumerates nothing
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    try:
        boots = []
        for restart in (False, True):
            tuning.clear_cache()
            graph, calib, pol = resnet9_recipe(0, 8)
            reg = ModelRegistry(device=dev, store=store_dir)
            reg.register_graph(graph.name, graph, calib, pol)
            with InferenceService(reg, max_batch=32) as svc:
                report = svc.warm_boot()
            torch.cuda.synchronize()
            boots.append((report, dict(tuning.cache_info())))
        (cold, cold_info), (warm, warm_info) = boots
        if (warm["compiled"] or not warm["restored"]
                or warm["bucket_compiles"] != cold["bucket_compiles"]
                or warm_info["enumerations"] != 0
                or warm_info["persist_hits"] < 1):
            raise AssertionError(f"(c) warm boot: {boots}")
        out["warm_boot"] = {"cold": cold, "cold_tuner": cold_info,
                            "warm": warm, "warm_tuner": warm_info}
        log(f"  (c) cold boot: {cold['compiled']} compiled, "
            f"{cold_info['enumerations']} tiles enumerated, "
            f"{cold['bucket_compiles']} buckets captured; warm boot from "
            f"the store: {warm['restored']} restored, 0 compiles, "
            f"{warm_info['enumerations']} enumerations, "
            f"{warm_info['persist_hits']} decisions read back, "
            f"{warm['bucket_compiles']} buckets captured")
    finally:
        tuning.set_persistent_store(old_store)
        shutil.rmtree(store_dir, ignore_errors=True)

    # (d) tiles no instantiation takes raise at launch
    out["bad_tiles"] = tile_sweep.bad_tiles_raise(dev)
    log(f"  (d) {len(out['bad_tiles'])} tiles no instantiation takes each "
        "raised at launch: " + "; ".join(
            s.split(":")[0] for s in out["bad_tiles"]))
    out["launches"] = ran
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 22 in {out['seconds']:.1f} s; main-path launches {ran}")
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.compiler import bench_graphs, executor
    from repro_torch.compiler.lower import compile_graph
    from repro_torch.configs import get_arch
    from repro_torch.core import bitops, pipeline_modules
    from repro_torch.core.bitserial import SerialSpec, conv_out_hw, plan_spec
    from repro_torch.core.quant import QuantSpec, init_alpha, qrange
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.kernels.timing import Timer
    from repro_torch.launch.serve import CNNServer, GenRequest, Server
    from repro_torch.models import moe, resnet, transformer
    from repro_torch.models.layers import QuantPolicy

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pipeline_modules.disable_tf32()
    torch.backends.cudnn.deterministic = True
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {}

    # ---------------------------------------------------------- 1. setup
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    nvcc_ver = sh([_build.nvcc_path(), "--version"]).splitlines()[-1]
    import importlib.util
    has_triton = importlib.util.find_spec("triton") is not None
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {'yes' if has_triton else 'no'}")
    log(f"nvcc: {nvcc_ver}")
    log(f"card: {smi}")
    record["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvcc": nvcc_ver, "triton": has_triton, "card": smi,
                     "python": sys.version.split()[0]}
    t0 = time.perf_counter()
    kernels = _build.build_all([k1.KERNEL, k2.KERNEL, km.KERNEL, km.GROUPED])
    record["build_s"] = time.perf_counter() - t0
    log(f"built {[k.name for k in kernels]} in {record['build_s']:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k.name}: {line.strip()}")

    rng = np.random.default_rng(0)
    max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K4g": 0.0}

    def cuda(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    def check_equal(kid, what, got, ref):
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{kid} {what}: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
        err = float((got.double() - ref.double()).abs().max()) if got.numel() else 0.0
        max_err[kid] = max(max_err[kid], err)
        if not torch.equal(got, ref):
            n = int((got != ref).sum())
            raise AssertionError(f"{kid} {what}: {n} elements differ "
                                 f"(max abs {err})")
        log(f"  {kid} {what}: equal {tuple(got.shape)}")

    # ------------------------------------------------------ 2. K1 checks
    log("K1 quantize_pack vs plain")
    k1_shapes = []
    x = np.maximum(rng.standard_normal((B * 32 * 32, 64)), 0).astype(np.float32)
    alpha = init_alpha(cuda(x), QuantSpec(2, True))
    xq = cuda(x)
    # plant exact .5 boundaries: round half to even must agree
    xq[:64, 0] = (torch.arange(64, device=dev, dtype=torch.float32) * 0.5
                  - 4.0) * alpha
    k1_shapes.append(("conv1.in_q", "f32", xq, alpha, QuantSpec(2, True)))
    for rows, l in ((B * 8 * 8, 128), (B * 2 * 2, 256)):
        codes = cuda(rng.integers(-2, 2, (rows, l)).astype(np.int32))
        k1_shapes.append((f"pack_codes ({rows},{l})", "codes", codes, None, 2))
    for name, kind, t, a, spec in k1_shapes:
        if kind == "f32":
            check_equal("K1", name, k1.quantize_pack_cuda(t, a, spec),
                        k1.quantize_pack_ref(t, a, spec))
        else:
            check_equal("K1", name, k1.pack_codes_cuda(t, spec),
                        k1.pack_codes_ref(t, spec))
    for bits, signed in ((4, True), (3, False), (8, True), (16, True)):
        t = cuda((rng.standard_normal((13, 70)) * 4).astype(np.float32))
        a = torch.tensor(0.37, device=dev)
        spec = QuantSpec(bits, signed)
        check_equal("K1", f"ragged (13,70) {bits}b {'s' if signed else 'u'}",
                    k1.quantize_pack_cuda(t, a, spec),
                    k1.quantize_pack_ref(t, a, spec))
        check_equal("K1", f"ragged bf16 (13,70) {bits}b "
                    f"{'s' if signed else 'u'}",
                    k1.quantize_pack_cuda(t.bfloat16(), a, spec),
                    k1.quantize_pack_ref(t.bfloat16(), a, spec))
        c = cuda(rng.integers(*qrange(bits, signed), (13, 70)).astype(np.int32))
        check_equal("K1", f"ragged codes (13,70) {bits}b",
                    k1.pack_codes_cuda(c, bits), k1.pack_codes_ref(c, bits))
    # the grouped launch the LM makes: one activation, G = 1..4 step sizes,
    # float32 and bf16, at the LM's shapes and a ragged one
    lm_steps = [torch.tensor(a, device=dev) for a in (0.177, 0.0371, 0.5,
                                                      0.0098)]
    lm_aspec = QuantSpec(8, True)
    for m, k in ((4, 2048), (64, 2048), (4, 5632), (64, 5632), (13, 70)):
        xf = cuda((rng.standard_normal((m, k)) * 4).astype(np.float32))
        for xt in (xf, xf.bfloat16()):
            for g in range(1, 5):
                check_equal("K1", f"({m},{k}) {xt.dtype} G={g}",
                            k1.quantize_pack_multi_cuda(xt, lm_steps[:g],
                                                        lm_aspec),
                            k1.quantize_pack_multi_ref(xt, lm_steps[:g],
                                                       lm_aspec))

    # ------------------------------------------------------ 3. K2 checks
    log("K2 bitserial_conv2d vs plain")

    def conv_case(n, h, ci, co, stride, spec, mode, fs=3, pad=1):
        la, ha = qrange(spec.a_bits, spec.a_signed)
        lw, hw = qrange(spec.w_bits, spec.w_signed)
        xc = cuda(rng.integers(la, ha + 1, (n * h * h, ci)).astype(np.int32))
        wc = cuda(rng.integers(lw, hw + 1, (fs * fs * co, ci)).astype(np.int32))
        xp = k1.pack_codes_ref(xc, spec.a_bits).reshape(
            spec.a_bits, n, h, h, -1).contiguous()
        wp = k1.pack_codes_ref(wc, spec.w_bits).reshape(
            spec.w_bits, fs, fs, co, -1).permute(0, 1, 2, 4, 3).contiguous()
        scale = cuda((rng.random(co) * 0.02 + 0.005).astype(np.float32))
        bias = cuda((rng.standard_normal(co) * 0.1).astype(np.float32))
        kw = dict(spec=spec, ci=ci, stride=stride, padding=pad, relu=True)
        if mode != "float":
            rq = QuantSpec(12 if mode == "codes32" else 2, True)
            kw.update(requant=rq, requant_scale=torch.tensor(0.25, device=dev),
                      emit_packed=mode == "packed")
        return xp, wp, scale, bias, kw

    w2a2 = SerialSpec(2, 2, True, True, 7)
    k2_cases = []
    for name, ci, co, stride, h, mode in RESNET9_CONVS:
        k2_cases.append((name, conv_case(B, h, ci, co, stride, w2a2, mode)))
    for mode in ("float", "codes", "packed"):
        k2_cases.append((f"ragged ci48 co40 s2 {mode}",
                         conv_case(3, 9, 48, 40, 2, w2a2, mode)))
    for spec, tag in ((SerialSpec(8, 4, True, True, 8), "W4A8"),
                      (SerialSpec(8, 8, True, True, 8), "W8A8"),
                      (SerialSpec(5, 3, False, True, 7), "W3A5 unsigned acts"),
                      (SerialSpec(16, 16, True, True, 7), "W16A16 (int32 wrap)")):
        for mode in ("float", "packed"):
            k2_cases.append((f"{tag} {mode}",
                             conv_case(2, 7, 96, 72, 1, spec, mode)))
    k2_cases.append(("1x1 s2 pad0 W4A4 codes",
                     conv_case(2, 8, 33, 17, 2, SerialSpec(4, 4, True, True, 8),
                               "codes", fs=1, pad=0)))
    k2_cases.append(("5x5 pad2 W2A2 float",
                     conv_case(2, 6, 32, 16, 1, w2a2, "float", fs=5, pad=2)))
    # the edges of the tensor-core tiles: pixels and Co off the 32 x 8 NT
    # tile, Ci = 33 and 600 (19 words per tap), batch 1, stride 2
    for n, h, ci, co, stride in ((1, 9, 33, 40, 2), (1, 5, 600, 70, 1),
                                 (3, 5, 33, 100, 2)):
        for spec, tag in ((w2a2, "W2A2"),
                          (SerialSpec(16, 16, True, True, 7), "W16A16")):
            for mode in ("float", "codes", "codes32", "packed"):
                k2_cases.append((f"edge n{n} h{h} ci{ci} co{co} s{stride} "
                                 f"{tag} {mode}",
                                 conv_case(n, h, ci, co, stride, spec, mode)))
    for name, (xp, wp, scale, bias, kw) in k2_cases:
        check_equal("K2", name,
                    k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw),
                    k2.bitserial_conv2d_ref(xp, wp, scale, bias, **kw))

    # ------------------------------------------------- 4. the server slice
    log("server slice: CNNServer(seed=0, calib_batch=8) on the card, "
        "through the serving runtime")
    t0 = time.perf_counter()
    server = CNNServer(seed=0, calib_batch=8, max_batch=32)
    prog = server.program            # the registry compiles at first use
    torch.cuda.synchronize()
    record["compile_s"] = time.perf_counter() - t0
    log(f"  compiled full-width ResNet9 W2A2 in {record['compile_s']:.2f} s")

    def counts():
        return {"K1": k1.KERNEL.launches, "K2": k2.KERNEL.launches,
                "K3": km.KERNEL.entry_launches["bitserial_matmul_v2"],
                "K4": km.KERNEL.entry_launches["bitserial_matmul_v1"],
                "K4g": km.GROUPED.entry_launches[
                    "bitserial_matmul_v1_grouped"]}

    def reset_counts():
        for k in kernels:
            k.reset_counts()

    def graph_launches(run, replays0):
        """What a bucketed runner's graphs ran since ``replays0``: the
        launches counted at each (bank, bucket)'s capture times its
        replays (a replay calls no wrapper), and the forwards (replays)
        run."""
        ran = dict.fromkeys(("K1", "K2", "K3", "K4", "K4g"), 0)
        forwards = 0
        for key, n in run.replays.items():
            n -= replays0.get(key, 0)
            forwards += n
            for k, v in run.capture_launches[key].items():
                ran[k] += v * n
        return ran, forwards

    def served_batches(svc, ids):
        """The micro-batches the service ran for trace ids ``ids``: the ids
        that share one execute span, in submission (FIFO) order, with the
        variant each was booked under."""
        groups, key_of = {}, {}
        for sp in svc.tracer.spans():
            if sp.trace_id in ids and sp.name == "execute":
                groups.setdefault((sp.t0_ns, sp.t1_ns), []).append(
                    sp.trace_id)
            if sp.trace_id in ids and sp.name == "queue":
                key_of[sp.trace_id] = sp.args["key"]
        out = [sorted(g) for _, g in sorted(groups.items())]
        if sorted(i for g in out for i in g) != sorted(ids):
            raise AssertionError("the trace lost a request")
        return [(key_of[g[0]], g) for g in out]

    def check_served(svc, sent, refs):
        """Every answer equals, bit for bit, each reference in ``refs``
        ({variant: {name: fn(padded batch) -> logits}}) run on the
        answer's own micro-batch padded with zeros to its bucket. ``sent``
        maps a trace id to (image, answer). Returns the batch sizes."""
        sizes = []
        for key, ids in served_batches(svc, set(sent)):
            n = len(ids)
            xb = torch.zeros((executor.bucket_for(n, 32), 32, 32, 3),
                             device=dev)
            xb[:n] = torch.from_numpy(np.stack([sent[i][0] for i in ids]))
            got = np.stack([sent[i][1] for i in ids])
            if got.shape != (n, 10) or not np.all(np.isfinite(got)):
                raise AssertionError(f"bad logits {got.shape}")
            for name, fn in refs[key].items():
                ref = fn(xb)[:n].cpu().numpy()
                if not np.array_equal(got, ref):
                    raise AssertionError(
                        f"{key} batch of {n}: answers differ from the {name}"
                        f" at bucket {len(xb)}, max "
                        f"{np.abs(got - ref).max()}")
            sizes.append(n)
        return sizes

    def classify_traced(srv, imgs, sent):
        """``srv.classify`` (one submitter thread: trace ids follow the
        images), recording each image and its answer by trace id."""
        tid0 = srv.service.tracer.started
        out = srv.classify(imgs)
        for i in range(len(imgs)):
            sent[tid0 + 1 + i] = (imgs[i], out[i])
        return out

    t0 = time.perf_counter()
    captured = server.service.warmup()
    torch.cuda.synchronize()
    record["capture_s"] = time.perf_counter() - t0
    runner = server.service._runner_for(server.key)
    want_fwd = {"K1": 3, "K2": 8, "K3": 0, "K4": 0, "K4g": 0}
    if (captured != 6 or runner.stats()["cuda_graphs"] != 6
            or any(runner.capture_launches[(0, b)] != want_fwd
                   for b in executor.bucket_sizes(32))):
        raise AssertionError(f"warmup captured {captured}: "
                             f"{runner.capture_launches}")
    log(f"  warmup captured one CUDA graph per bucket "
        f"{executor.bucket_sizes(32)} in {record['capture_s']:.2f} s, each "
        f"with {want_fwd}")
    plain = executor.make_plain_runner(prog)
    images = np.random.default_rng(7).random((32, 32, 32, 3), dtype=np.float32)
    reset_counts()
    replays0 = dict(runner.replays)
    sent = {}
    answers = {n: classify_traced(server, images[:n], sent) for n in (1, 3, 32)}
    if any(counts().values()) or runner.compiles != 6:
        raise AssertionError(f"a wrapper ran after warmup: {counts()}, "
                             f"compiles {runner.compiles}")
    launches, forwards = graph_launches(runner, replays0)
    if launches != {k: v * forwards for k, v in want_fwd.items()}:
        raise AssertionError(f"main path launches {launches} over "
                             f"{forwards} replays")
    log(f"  main path: {forwards} replayed forwards, launches run {launches}"
        " (captured counts x replays; no wrapper ran)")
    record["launches_cnn"] = launches
    sizes = check_served(server.service, sent, {str(server.key): {
        "eager forward": prog, "plain run": lambda x: plain(prog.params, x)}})
    log(f"  micro-batches {sizes}: each answer equals the eager forward and "
        f"the plain run at its bucket; first {answers[3][0, :4]}")
    record["logits_b3"] = answers[3].tolist()

    # a Program calibrated on the batch it classifies agrees on argmax
    # with the plain quantized reference forward (batch-own step sizes)
    params = resnet.resnet9_init(0)
    small = np.random.default_rng(3).random((4, 32, 32, 3), dtype=np.float32)
    sprog = resnet.resnet9_compile(params, small, device=dev)
    out = sprog(torch.from_numpy(small).to(dev)).cpu().numpy()
    refq = resnet.resnet9_forward(params, torch.from_numpy(small).to(dev)
                                  ).cpu().numpy()
    if not (np.all(np.isfinite(out)) and
            np.array_equal(out.argmax(-1), refq.argmax(-1))):
        raise AssertionError(f"argmax {out.argmax(-1)} vs reference "
                             f"{refq.argmax(-1)}")
    log(f"  calibrated-on-batch argmax {out.argmax(-1).tolist()} equals the "
        "reference forward's")

    # ---------------------------------------------------------- 5. times
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def open_window():
        """Spin kernels, run to completion, that open a profiler window and
        are left out of every number: in one process the profiler lost the
        first 17 device records of a window that a deepseek replay opened
        (5,028 of its 5,045 kernels, the first K1 and two K3 among them;
        chip run, PR 18); opened this way it saw all 5,045."""
        for _ in range(200):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def is_spin(name):
        return "spin_kernel" in name

    def profiled(fn, reps=1, expect=None):
        """``fn`` run ``reps`` times in one profiler window opened by
        :func:`open_window`: the profiler and the host wall in seconds.
        Now and then a window comes back with no device record of ``fn``
        at all (a per-step window in phase 13, chip run PR 19; a bucket
        replay in phase 5, chip run PR 20), or short of some of them (47
        of 48 K1 and 69 of 72 K3 records of a hymba prefill in phase 15,
        chip run PR 27), while the same call in the next window is seen
        whole. With ``expect`` ({kernel id: launches} over the ``reps``
        runs, by :func:`kernel_of`) a window holding fewer of any is
        short. An empty or short window is logged, kept in
        ``record["profiler_empty_windows"]`` and opened again, at most
        ``WINDOW_TRIES`` times in all; every check reads the first window
        that holds the call (a caller still holds the counts exactly)."""
        for attempt in range(1, WINDOW_TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                open_window()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            # the card's records read from the trace itself: building
            # key_averages' event tree takes 16 s for a mesh step's 141k
            # events on the card's host
            seen = card_records(prof)
            got = None
            if expect is not None:
                got = dict.fromkeys(expect, 0)
                for name, _ in seen:
                    kid = kernel_of(name)
                    if kid in got:
                        got[kid] += 1
            if (any(not is_spin(name) for name, _ in seen)
                    and (got is None
                         or all(got[k] >= v for k, v in expect.items()))):
                return prof, wall
            empty = {"attempt": attempt,
                     "device_rows": len({name for name, _ in seen}),
                     "spin_records": sum(is_spin(n) for n, _ in seen),
                     "launches": got, "expected": expect}
            record.setdefault("profiler_empty_windows", []).append(empty)
            log(f"  the profiler window held {'too few' if got else 'no'} "
                f"device records of the call (attempt {attempt} of "
                f"{WINDOW_TRIES}: {empty})")
        return prof, wall

    def device_profile(fn, reps=1, ranges=()):
        """``fn`` run ``reps`` times under the profiler; per run: the host
        wall, the card's busy time (its own events: kernels, copies, sets),
        and the 12 largest kernels' ms and launches by name, K1's apart.
        ``all_rows_ms`` sums self device time over every row, the CPU ops
        included, so it counts each torch op's kernels twice: it is the
        figure reported as device busy before this field existed. With
        ``ranges`` (``record_function`` names inside ``fn``, ``reps`` 1),
        ``ranges`` holds :func:`range_split`'s figures for each; the
        ranges' own rows count in no sum."""
        prof, wall = profiled(fn, reps)
        ms, launches, all_rows = {}, {}, 0.0
        for evt in prof.key_averages():
            if is_spin(evt.key) or evt.key in ranges:
                continue
            dt = evt.self_device_time_total / 1e3 / reps
            all_rows += dt
            if evt.device_type == DeviceType.CUDA and dt > 0:
                ms[evt.key] = dt
                launches[evt.key] = evt.count / reps
        if not ms:
            raise AssertionError("the profiler recorded no device event")
        top = sorted(ms, key=lambda k: -ms[k])[:12]
        k1_names = [k for k in ms if "quantize_pack" in k]
        out = {"ranges": range_split(prof, ranges)} if ranges else {}
        return {**out, "wall_ms": wall / reps * 1e3,
                "device_ms": sum(ms.values()),
                "kernels": sum(launches.values()),
                "all_rows_ms": all_rows,
                "by_name_ms": {k: ms[k] for k in top},
                "launches": {k: launches[k] for k in top},
                "K1_ms": sum(ms[k] for k in k1_names),
                "K1_launches": sum(launches[k] for k in k1_names)}

    def profile_counts(fn, expect=None):
        """``fn`` once under the profiler: host wall, the card's busy time
        (its own events) and every device kernel's launches and ms by
        name."""
        prof, wall = profiled(fn, expect=expect)
        busy, names, ms = 0.0, {}, {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and not is_spin(evt.key):
                busy += evt.self_device_time_total / 1e3
                names[evt.key] = names.get(evt.key, 0) + evt.count
                ms[evt.key] = (ms.get(evt.key, 0.0)
                               + evt.self_device_time_total / 1e3)
        if not names:
            raise AssertionError("the profiler recorded no device event")
        return {"wall_ms": wall * 1e3, "device_ms": busy, "launches": names,
                "ms": ms}

    def cnn_kernels(launches):
        """K1 (its float and codes entries) and K2 launches among the
        profiler's kernel names."""
        out = {"K1": 0, "K2": 0}
        for name, n in launches.items():
            if "quantize_pack_kernel" in name or "pack_codes_kernel" in name:
                out["K1"] += n
            elif "bitserial_conv2d_kernel" in name:
                out["K2"] += n
        return out

    log(f"times at batch {B} (ms, median, L2 flushed before each launch)")
    timer = Timer(dev)
    rows = []

    def k1_bound(r, l, bits, in_bytes, groups=1):
        """K1's least time: x read once, G steps, G planes sets written;
        a divide, a round and a clip (counted as 4 float32 ops) per element
        and step."""
        byt = r * l * in_bytes + groups * (bits * r * (-(-l // 32)) * 4 + 4)
        ops = 4 * r * l * groups
        return byt, ops, max(byt / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3

    for name, kind, t, a, spec in k1_shapes:
        r, l = t.shape
        if kind == "f32":
            fk = lambda: k1.quantize_pack_cuda(t, a, spec)
            fp = lambda: k1.quantize_pack_ref(t, a, spec)
            bits = spec.bits
        else:
            fk = lambda: k1.pack_codes_cuda(t, spec)
            fp = lambda: k1.pack_codes_ref(t, spec)
            bits = spec
        byt, ops, bound = k1_bound(r, l, bits, 4)
        rows.append({"kernel": "K1", "call": name, "ms": timer(fk, 50),
                     "plain_ms": timer(fp, 10), "library_ms": None,
                     "bound_ms": bound, "bytes": byt, "ops": ops,
                     "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
                     ops / FP32_OPS_PER_S else "operations"})
    for (name, (xp, wp, scale, bias, kw)), (_, ci, co, stride, h, mode) in zip(
            k2_cases[:8], RESNET9_CONVS):
        ho, wo = conv_out_hw(h, h, 3, 3, stride, 1)
        macs = B * ho * wo * co * 9 * ci
        out_bytes = {"packed": 2 * B * ho * wo * (-(-co // 32)) * 4,
                     "codes": B * ho * wo * co, "float": B * ho * wo * co * 4}
        byt = (xp.numel() + wp.numel()) * 4 + 8 * co + 4 + out_bytes[mode]
        ops = 2 * macs
        bound = max(byt / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        xa = torch.from_numpy(rng.integers(-2, 2, (B, ci, h, h)).astype(
            np.float16)).to(dev).contiguous(memory_format=torch.channels_last)
        wa = torch.from_numpy(rng.integers(-2, 2, (co, ci, 3, 3)).astype(
            np.float16)).to(dev).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.nn.functional.conv2d(xa, wa, stride=stride,
                                                 padding=1)
        fk = lambda: k2.bitserial_conv2d_cuda(xp, wp, scale, bias, **kw)
        rows.append({
            "kernel": "K2", "call": name, "ms": timer(fk, 50),
            "plain_ms": timer(
                lambda: k2.bitserial_conv2d_ref(xp, wp, scale, bias, **kw), 10),
            "library_ms": timer(lib, 50), "bound_ms": bound, "bytes": byt,
            "ops": ops, "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
            ops / INT8_OPS_PER_S else "operations"})
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['kernel']} {r['call']:<22} kernel {r['ms']:.4f}  plain "
            f"{r['plain_ms']:.4f}  library {lib}  bound {r['bound_ms']:.5f} "
            f"({r['bound_by']})")
    record["calls"] = rows
    for kid in ("K1", "K2"):
        sums = {key: sum(r[key] for r in rows if r["kernel"] == kid)
                for key in ("ms", "bound_ms", "plain_ms")}
        lib = [r["library_ms"] for r in rows if r["kernel"] == kid]
        sums["library_ms"] = None if None in lib else sum(lib)
        record[f"{kid}_forward_sums"] = sums
        log(f"  {kid} summed over one batch-{B} forward: {sums['ms']:.4f} "
            f"ms, bound {sums['bound_ms']:.5f}, library {sums['library_ms']}, plain "
            f"{sums['plain_ms']:.3f}")

    # the forward at batch 32: img/s on the host clock (the runner's replay
    # and the eager forward, in turns), device time by kernel from the
    # profiler
    x32 = torch.from_numpy(images).to(dev)
    run = runner

    def forward_s(fn, x, reps=20):
        fn(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    record["forward_b1_ms"] = forward_s(run, x32[:1]) * 1e3
    fwd_s = forward_s(run, x32)
    eager_s = forward_s(prog, x32)
    fwd_s2 = forward_s(run, x32)
    eager_s2 = forward_s(prog, x32)
    classify_runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.classify(images)
        classify_runs.append(time.perf_counter() - t0)
    classify_s = classify_runs[0]
    record["forward_b32_ms"] = fwd_s * 1e3
    record["forward_b32_ms_runs"] = [fwd_s * 1e3, fwd_s2 * 1e3]
    record["forward_b32_eager_ms_runs"] = [eager_s * 1e3, eager_s2 * 1e3]
    record["img_per_s_b32"] = 32 / fwd_s
    record["classify_b32_ms"] = classify_s * 1e3
    record["classify_b32_ms_runs"] = [t * 1e3 for t in classify_runs]
    log(f"forward batch 32, one graph replay: {fwd_s * 1e3:.3f} / "
        f"{fwd_s2 * 1e3:.3f} ms ({32 / fwd_s:.1f} img/s); eager forward in "
        f"turns: {eager_s * 1e3:.3f} / {eager_s2 * 1e3:.3f} ms; classify() "
        f"through the service {classify_s * 1e3:.3f} ms (5 calls: "
        f"{', '.join(f'{t * 1e3:.3f}' for t in classify_runs)}); forward "
        f"batch 1 (replay): {record['forward_b1_ms']:.3f} ms")
    prof = device_profile(lambda: run(x32), 5)
    record["profile_b32"] = prof
    eprof = device_profile(lambda: prog(x32), 5)
    record["profile_b32_eager"] = {k: eprof[k] for k in (
        "wall_ms", "device_ms", "all_rows_ms")}
    # one replay of every bucket under the profiler: each graph runs 3 K1
    # and 8 K2, as its capture counted
    record["profile_replay_by_bucket"] = {}
    for b in executor.bucket_sizes(32):
        one = profile_counts(lambda: run(x32[:b]))
        got = cnn_kernels(one["launches"])
        record["profile_replay_by_bucket"][b] = {
            "wall_ms": one["wall_ms"], "device_ms": one["device_ms"],
            "kernels": sum(one["launches"].values()),
            "launches_by_kernel": got}
        if got != {"K1": 3, "K2": 8}:
            raise AssertionError(f"the profiler saw {got} in one replay of "
                                 f"bucket {b}, want 3 K1 and 8 K2")
    record["profile_b32_replay"] = record["profile_replay_by_bucket"][32]
    log(f"profile batch 32 per forward: replay wall {prof['wall_ms']:.3f} ms,"
        f" device busy {prof['device_ms']:.3f} ms (all profiler rows "
        f"{prof['all_rows_ms']:.3f}); eager wall {eprof['wall_ms']:.3f} ms, "
        f"busy {eprof['device_ms']:.3f} ms; one replay: "
        f"{record['profile_b32_replay']['kernels']} kernels, of them "
        f"{record['profile_b32_replay']['launches_by_kernel']}; one replay "
        f"of each bucket {executor.bucket_sizes(32)} ran 3 K1 and 8 K2 "
        f"(busy ms " + ", ".join(
            f"{b}: {v['device_ms']:.4f}" for b, v in
            record["profile_replay_by_bucket"].items()) + ")")
    for k, v in prof["by_name_ms"].items():
        log(f"  {v:9.4f} ms  {k[:90]}")

    # ------------------------------------------- 6./7. K3 and K4 vs plain
    log("K3 bitserial_matmul_v2 and K4 bitserial_matmul vs plain")
    lm_cfg = get_arch("stablelm-1.6b").full
    w4a8 = plan_spec(lm_cfg.policy.spec())

    def gemm_case(spec, m, k, n, bias=True, scale_mul=1.0):
        la, ha = qrange(spec.a_bits, spec.a_signed)
        lw, hw = qrange(spec.w_bits, spec.w_signed)
        xc = cuda(rng.integers(la, ha + 1, (m, k)).astype(np.int32))
        wc = cuda(rng.integers(lw, hw + 1, (k, n)).astype(np.int32))
        wp = bitops.pack_bitplanes(bitops.pad_to(
            bitops.to_bitplanes(wc, spec.w_bits), 32, axis=1), axis=1)
        scale = cuda((rng.random(n) * 2e-3 * scale_mul + 1e-4).astype(
            np.float32))
        return {"xc": xc, "wc": wc, "xp": k1.pack_codes_ref(xc, spec.a_bits),
                "wp": wp, "scale": scale, "spec": spec, "k": k,
                "bias": cuda(rng.standard_normal(n).astype(np.float32))
                if bias else None}

    rs = torch.tensor(0.37, device=dev)
    # (name, case, K3 modes, K4 modes); a mode is (output, requant)
    gemm_cases = []
    for k, n in STABLELM_GEMMS:
        for m in (4, 4 * 16):
            gemm_cases.append((f"W4A8 M{m} {k}->{n}",
                               gemm_case(w4a8, m, k, n, bias=False),
                               [("float", None)], [("float", None)]))
    rq_modes = [("codes", QuantSpec(8, True)), ("packed", QuantSpec(4, True))]
    k4_rq = [("codes", QuantSpec(8, True)), ("codes", QuantSpec(12, True))]
    gemm_cases += [
        ("W4A8 M64 2048->2048 requant", gemm_case(w4a8, 64, 2048, 2048,
                                                  scale_mul=40),
         rq_modes, k4_rq),
        ("ragged 5x100->70", gemm_case(w4a8, 5, 100, 70, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W2A2 radix 1", gemm_case(SerialSpec(2, 2, True, True, 1), 9, 65,
                                   40, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W8A8 unsigned acts", gemm_case(SerialSpec(8, 8, False, True, 7),
                                         7, 96, 64, scale_mul=40),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq),
        ("W16A16 (int32 wrap)", gemm_case(SerialSpec(16, 16, True, True, 7),
                                          3, 700, 64),
         [("float", None)] + rq_modes, [("float", None)] + k4_rq)]
    # the edges of the tensor-core tile K3 and K4 share: M = 1..64 rows
    # against 8 NT-row tiles, N = 70 and K = 100 off the 32-column tile and
    # the K word
    for m in (1, 4, 5, 17, 64):
        for spec, tag in ((w4a8, "W4A8"), (SerialSpec(2, 2, True, True, 1),
                                           "W2A2 radix 1"),
                          (SerialSpec(16, 16, True, True, 7), "W16A16"),
                          (SerialSpec(8, 8, False, True, 7), "W8A8 unsigned")):
            gemm_cases.append((f"edge M{m} 100->70 {tag}",
                               gemm_case(spec, m, 100, 70, scale_mul=40),
                               [("float", None)] + rq_modes,
                               [("float", None)] + k4_rq))
    for name, c, k3_modes, k4_modes in gemm_cases:
        for out, rq in k3_modes:
            kw = dict(spec=c["spec"], k=c["k"], relu=rq is not None,
                      requant=rq, requant_scale=None if rq is None else rs,
                      emit_packed=out == "packed")
            check_equal("K3", f"{name} {out}",
                        km.bitserial_matmul_v2_cuda(c["xp"], c["wp"],
                                                    c["scale"], c["bias"],
                                                    **kw),
                        km.bitserial_matmul_v2_ref(c["xp"], c["wp"],
                                                   c["scale"], c["bias"],
                                                   **kw))
        for out, rq in k4_modes:
            kw = dict(spec=c["spec"], k=c["k"], relu=False, requant=rq,
                      out_dtype=torch.bfloat16 if rq else torch.float32)
            tag = "" if rq is None else f" {rq.bits}b"
            check_equal("K4", f"{name} {out}{tag}",
                        km.bitserial_matmul_cuda(c["xc"], c["wp"],
                                                 c["scale"], c["bias"], **kw),
                        km.bitserial_matmul_ref(c["xc"], c["wp"], c["scale"],
                                                c["bias"], **kw))

    # ---------------------------------------------------- 8. the LM slice
    log("LM slice: Server(stablelm-1.6b FULL, batch_slots=4, max_len=64, "
        "seed=0) on the card, W4A8, bf16")
    t0 = time.perf_counter()
    lm = Server(lm_cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
    torch.cuda.synchronize()
    record["lm_init_s"] = time.perf_counter() - t0
    log(f"  {lm_cfg.n_layers} layers, random weights packed in "
        f"{record['lm_init_s']:.2f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompt_rng = np.random.RandomState(0)
    prompts = [prompt_rng.randint(0, lm_cfg.vocab_size, (n,)).astype(np.int32)
               for n in LM_PROMPTS]

    def lm_requests(idx=range(len(LM_PROMPTS))):
        return [GenRequest(prompts[i].copy(), LM_NEW) for i in idx]

    def lm_drive(server, requests):
        reset_counts()
        out = server.generate(requests)
        torch.cuda.synchronize()
        return [r.out_tokens for r in out], server.last_logits.clone(), counts()

    # per step: 7 projections a layer (K3 or K4), 4 distinct activations
    # (K1: q/k/v share one launch, gate/up another)
    per_step = 7 * lm_cfg.n_layers
    k1_per_step = len(K1_PER_LAYER) * lm_cfg.n_layers
    lm_k3 = lm_drive(lm, lm_requests())
    want = {"K1": k1_per_step * LM_NEW, "K2": 0, "K3": per_step * LM_NEW,
            "K4": 0, "K4g": 0}
    if lm_k3[2] != want:
        raise AssertionError(f"LM launches {lm_k3[2]}, want {want}")
    record["launches_lm_k3"] = lm_k3[2]
    log(f"  main path (K1 + K3): prefill + {LM_NEW - 1} decode steps, "
        f"launches {lm_k3[2]} = {k1_per_step} K1 and {per_step} K3 per step")
    toks, logits = lm_k3[0], lm_k3[1]
    if (logits.shape != (4, lm_cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or any(len(t) != LM_NEW or not all(0 <= v < lm_cfg.vocab_size
                                               for v in t) for t in toks)):
        raise AssertionError(f"bad LM output {logits.shape} {toks}")
    with torch.inference_mode():
        batch = {"tokens": torch.zeros((4, max(LM_PROMPTS)), dtype=torch.long,
                                       device=dev)}
        reset_counts()
        _, caches = transformer.prefill(lm.params, batch, lm.cfg,
                                        max_len=LM_MAX_LEN)
        c_pre = counts()
        reset_counts()
        transformer.decode_step(lm.params, caches, batch["tokens"][:, :1],
                                max(LM_PROMPTS), lm.cfg)
        c_dec = counts()
        torch.cuda.synchronize()
    if not (c_pre["K3"] == c_dec["K3"] == per_step
            and c_pre["K1"] == c_dec["K1"] == k1_per_step):
        raise AssertionError(f"per-step launches prefill {c_pre} decode "
                             f"{c_dec}, want {k1_per_step} K1 and {per_step} "
                             "K3")
    log(f"  one prefill: {c_pre}; one decode step: {c_dec}")
    plain_lm = Server(lm_cfg, lm.params, batch_slots=4, max_len=LM_MAX_LEN,
                      plain=True)
    t0 = time.perf_counter()
    lm_plain = lm_drive(plain_lm, lm_requests())
    record["lm_plain_generate_s"] = time.perf_counter() - t0
    if any(lm_plain[2].values()):
        raise AssertionError(f"plain run launched kernels: {lm_plain[2]}")
    if lm_plain[0] != toks or not torch.equal(lm_plain[1], logits):
        raise AssertionError("LM tokens/logits differ from the plain run")
    log(f"  tokens and last-step logits equal the plain run's "
        f"({record['lm_plain_generate_s']:.1f} s); request 0: {toks[0]}")
    k4_lm = Server(lm_cfg, lm.params, batch_slots=4, max_len=LM_MAX_LEN,
                   pack_acts=False)
    lm_k4 = lm_drive(k4_lm, lm_requests())
    want4 = {"K1": 0, "K2": 0, "K3": 0, "K4": per_step * LM_NEW, "K4g": 0}
    if lm_k4[2] != want4:
        raise AssertionError(f"K4 path launches {lm_k4[2]}, want {want4}")
    if lm_k4[0] != toks or not torch.equal(lm_k4[1], logits):
        raise AssertionError("pack_acts=False (K4) tokens/logits differ")
    record["launches_lm_k4"] = lm_k4[2]
    log(f"  pack_acts=False (K4): identical tokens and logits, launches "
        f"{lm_k4[2]}")
    two = Server(lm_cfg, lm.params, batch_slots=2, max_len=LM_MAX_LEN)
    one = Server(lm_cfg, lm.params, batch_slots=1, max_len=LM_MAX_LEN)
    t_two = two.generate(lm_requests([1]))[0].out_tokens
    t_one = one.generate(lm_requests([1]))[0].out_tokens
    if two.last_stats["padded_slots"] != 1 or t_two != t_one:
        raise AssertionError(f"dummy slot: {two.last_stats} {t_two} {t_one}")
    log(f"  batch_slots=2, one request (one dummy slot): tokens equal a "
        f"1-slot server's {t_two[:6]}...")
    record["lm_tokens"] = toks
    # the smoke config on the card agrees with the CPU's plain run, which
    # the CPU tests hold against the reference
    smoke = get_arch("stablelm-1.6b").smoke
    sm_gpu = Server(smoke, batch_slots=4, max_len=32, seed=0)
    sm_cpu = Server(smoke, tree_to(sm_gpu.params, "cpu"), batch_slots=4,
                    max_len=32, device="cpu")
    sm_prompts = [np.arange(n, dtype=np.int32) * 7 % smoke.vocab_size
                  for n in (3, 6, 9)]
    a = [r.out_tokens for r in sm_gpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    b = [r.out_tokens for r in sm_cpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    if a != b:
        raise AssertionError(f"smoke config: card {a} vs CPU {b}")
    log(f"  smoke config: card tokens equal the CPU plain run's {a[0]}")

    # ------------------------------------- 8b. the continuous LM engine
    log("LM engine: ContinuousLMEngine(stablelm-1.6b FULL, batch_slots=4, "
        "max_len=64, seed=0) on the card, its decode step one CUDA graph")
    from repro_torch.obs import Tracer
    from repro_torch.serving import ContinuousLMEngine

    def fenced_ms(fn, reps):
        """Median host wall of ``fn`` between two synchronizes."""
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def by_kernel(launches):
        """K1, K3, K4 and grouped K4 launches among the profiler's kernel
        names (:func:`kernel_of`)."""
        out = {"K1": 0, "K3": 0, "K4": 0, "K4g": 0}
        for name, n in launches.items():
            kid = kernel_of(name)
            if kid is not None:
                out[kid] += n
        return out

    def cli_load(n, new_tokens=LM_NEW, vocab=lm_cfg.vocab_size):
        """:func:`mixed_load` as requests."""
        return [GenRequest(p, m) for p, m in mixed_load(n, vocab, new_tokens)]

    def first_difference(got, want):
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                return f"token {t}: {a} vs {b}"
        return f"lengths {len(got)} vs {len(want)}"

    def parting_token(got, want):
        """The index of the first token where two runs part, or None."""
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                return t
        return None if len(got) == len(want) else min(len(got), len(want))

    def eager_alone(e, r):
        """Request ``r`` alone, eagerly, at engine ``e``'s shapes: its
        prompt right-padded to its bucket and prefilled with ``last_pos``,
        then decode steps over a ``batch_slots``-row cache that holds it in
        every row. Returns row 0's tokens, after checking that every row
        gave them, and per token the gap between the two largest logits it
        was chosen from."""
        n, b = len(r.prompt), e.batch_slots
        padded = np.zeros((1, executor.bucket_for(n, e.max_len)), np.int64)
        padded[0, :n] = r.prompt
        with torch.inference_mode():
            logits, pref = transformer.prefill(
                e.params, {"tokens": torch.from_numpy(padded).to(dev)},
                e.cfg, max_len=e.max_len,
                last_pos=torch.full((1,), n - 1, device=dev))
            caches = transformer.init_caches(e.cfg, b, e.max_len, device=dev)
            for c, p in zip(caches, pref):
                for name, buf in c.items():
                    if name != "len":
                        buf.copy_(p[name].expand_as(buf))
            logits = logits.expand(b, -1)
            pos = torch.full((b,), n, dtype=torch.int32, device=dev)
            cols, gaps = [], []
            for t in range(r.max_new_tokens):
                top = torch.topk(logits[0].float(), 2).values
                gaps.append(top[0] - top[1])
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
                cols.append(tok[:, 0])
                if t + 1 < r.max_new_tokens:
                    logits, _ = transformer.decode_step(e.params, caches,
                                                        tok, pos, e.cfg)
                    pos = pos + 1
            rows = torch.stack(cols, 1).cpu().tolist()
            gaps = torch.stack(gaps).cpu().tolist()
        if any(row != rows[0] for row in rows):
            raise AssertionError(f"the eager run's rows disagree: {rows}")
        return rows[0], gaps

    rec = {}
    t0 = time.perf_counter()
    eng = ContinuousLMEngine(lm_cfg, batch_slots=4, max_len=LM_MAX_LEN,
                             seed=0)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    warm = eng.warmup()
    st = eng.stats()
    rec.update(warmup_s=warm["seconds"], warmup_buckets=warm["buckets"],
               capture_s=st["capture_seconds"],
               step_launches=st["step_launches"])
    want_step = {"K1": k1_per_step, "K3": per_step, "K4": 0, "K4g": 0}
    if (not st["cuda_graph"] or st["compiles"]["decode"] != 1
            or st["step_launches"] != want_step):
        raise AssertionError(f"engine capture: graph {st['cuda_graph']}, "
                             f"compiles {st['compiles']}, launches at "
                             f"capture {st['step_launches']}, want "
                             f"{want_step}")
    log(f"  warmup {warm['seconds']:.2f} s (buckets {warm['buckets']}, "
        f"{warm['compiles']} compiles); decode step captured once in "
        f"{st['capture_seconds']:.3f} s with {st['step_launches']}")
    tracer = Tracer()
    eng.bind_runtime(None, None, tracer=tracer)   # one span per step
    load = cli_load(16)
    calls0 = st["calls"].get("decode", 0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(load)             # ends in the host copy of the tokens
    load_s = time.perf_counter() - t0
    c_load = counts()
    em = eng.engine_metrics()
    total_toks = sum(len(r.out_tokens) for r in out)
    # a replay calls no wrapper: the wrappers counted the 16 prefills
    want_load = {"K1": k1_per_step * len(load), "K2": 0,
                 "K3": per_step * len(load), "K4": 0, "K4g": 0}
    if c_load != want_load:
        raise AssertionError(f"engine load prefill launches {c_load}, want "
                             f"{want_load}")
    # what ran: the prefills, and the captured step once per replay
    ran_load = {k: c_load[k] + st["step_launches"][k] * em["decode_steps"]
                for k in ("K1", "K3")}
    st = eng.stats()
    if (st["recompiles_after_warmup"] != 0
            or st["calls"]["decode"] - calls0 != em["decode_steps"]):
        raise AssertionError(f"engine recompiled or skipped steps: {st}")
    steps_wall = sorted(sp.wall_us for sp in tracer.spans()
                        if sp.track == "lm-decode")
    if len(steps_wall) != em["decode_steps"]:
        raise AssertionError(f"{len(steps_wall)} step spans, "
                             f"{em['decode_steps']} steps")
    rec.update(load_requests=len(load), load_tokens=total_toks,
               load_s=load_s, tok_per_s=total_toks / load_s,
               decode_steps=em["decode_steps"],
               slot_occupancy=em["slot_occupancy"],
               launches_load_prefills=c_load, launches_load_run=ran_load,
               step_enqueue_ms_median=statistics.median(steps_wall) / 1e3,
               recompiles_after_warmup=st["recompiles_after_warmup"])
    log(f"  mixed load: {len(load)} requests, {total_toks} tokens in "
        f"{load_s * 1e3:.1f} ms = {rec['tok_per_s']:.1f} tok/s; "
        f"{em['decode_steps']} replayed steps (occupancy "
        f"{em['slot_occupancy']}), host time per step (enqueue, median) "
        f"{rec['step_enqueue_ms_median']:.3f} ms; launches run {ran_load} "
        f"(prefills {c_load}); recompiles_after_warmup 0")
    for r in out:
        if (len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= v < lm_cfg.vocab_size for v in r.out_tokens)):
            raise AssertionError(f"bad engine output {r.out_tokens}")
    # every request equals its eager run alone at the engine's shapes
    alone = []
    for i, r in enumerate(out):
        ref, gaps = eager_alone(eng, r)
        alone.append((ref, gaps))
        if r.out_tokens != ref:
            raise AssertionError(
                f"engine request {i} (prompt {len(r.prompt)}, "
                f"{r.max_new_tokens} new) parts from its eager run alone at "
                f"{first_difference(r.out_tokens, ref)}")
    log(f"  every request's tokens equal its eager run alone at the "
        f"engine's shapes; request 0: {out[0].out_tokens}")
    # what phase 20 (d) holds the engine on a mesh to
    engine_ref = {"load": [(r.prompt.copy(), r.max_new_tokens) for r in load],
                  "tokens": [list(r.out_tokens) for r in out],
                  "step": dict(st["step_launches"])}
    # against a 1-slot eager Server (batch 1, the prompt unpadded): other
    # shapes, so the float parts may round otherwise; reported, with the
    # eager run's top-2 logit gap at the token where they part
    solo = Server(lm_cfg, eng.params, batch_slots=1, max_len=LM_MAX_LEN)
    parted = []
    for i, r in enumerate(out):
        ref = solo.generate([GenRequest(r.prompt.copy(),
                                        r.max_new_tokens)])[0].out_tokens
        t = parting_token(r.out_tokens, ref)
        if t is not None:
            parted.append({"request": i, "prompt": len(r.prompt),
                           "new": r.max_new_tokens, "token": t,
                           "engine": r.out_tokens[t],
                           "server": ref[t] if t < len(ref) else None,
                           "top2_logit_gap": alone[i][1][t]})
    rec["server_1slot"] = {"requests": len(out),
                           "equal": len(out) - len(parted),
                           "parted": parted}
    log(f"  against a 1-slot eager Server: {len(out) - len(parted)} of "
        f"{len(out)} requests equal; parted: {parted}")
    # the plain versions' engine (also captured) and the K4 path's, on the
    # first four requests
    four = [GenRequest(r.prompt.copy(), r.max_new_tokens) for r in out[:4]]
    plain_eng = ContinuousLMEngine(lm_cfg, eng.params, batch_slots=4,
                                   max_len=LM_MAX_LEN, plain=True)
    reset_counts()
    t0 = time.perf_counter()
    p_out = plain_eng.serve([GenRequest(r.prompt.copy(), r.max_new_tokens)
                             for r in four])
    rec["plain_serve_s"] = time.perf_counter() - t0
    if any(counts().values()) or not plain_eng.stats()["cuda_graph"]:
        raise AssertionError(f"plain engine: launches {counts()}, "
                             f"{plain_eng.stats()}")
    for i, r in enumerate(p_out):
        if r.out_tokens != out[i].out_tokens:
            raise AssertionError(
                f"plain engine request {i} parts at "
                f"{first_difference(out[i].out_tokens, r.out_tokens)}")
    del plain_eng
    k4_eng = ContinuousLMEngine(lm_cfg, eng.params, batch_slots=4,
                                max_len=LM_MAX_LEN, pack_acts=False)
    k4_eng.warmup()                   # the capture falls outside the count
    k4_step = k4_eng.stats()["step_launches"]
    reset_counts()
    k4_out = k4_eng.serve([GenRequest(r.prompt.copy(), r.max_new_tokens)
                           for r in four])
    c_k4 = counts()
    want_k4 = {"K1": 0, "K3": 0, "K4": per_step, "K4g": 0}
    if (k4_step != want_k4
            or c_k4 != {"K1": 0, "K2": 0, "K3": 0,
                        "K4": per_step * len(four), "K4g": 0}):
        raise AssertionError(f"K4 engine: launches at capture {k4_step}, "
                             f"prefill launches in the serve {c_k4}")
    k4_prof = by_kernel(profile_counts(k4_eng._run_step, expect={
        k: v for k, v in want_k4.items() if v})["launches"])
    if k4_prof != want_k4:
        raise AssertionError(f"the profiler saw {k4_prof} in one K4 replay, "
                             f"want {want_k4}")
    for i, r in enumerate(k4_out):
        ref = eager_alone(k4_eng, r)[0]
        if r.out_tokens != ref:
            raise AssertionError(
                f"K4 engine request {i} parts from its eager run alone at "
                f"{first_difference(r.out_tokens, ref)}")
    k4_run = c_k4["K4"] + k4_step["K4"] * k4_eng.decode_steps
    rec.update(k4_step_launches=k4_step, k4_replay_profile=k4_prof,
               launches_k4_serve_prefills=c_k4, launches_k4_serve_run=k4_run)
    log(f"  plain engine ({rec['plain_serve_s']:.1f} s) gives the engine's "
        f"tokens on the first four requests, and the K4 engine ({k4_step} "
        f"per captured step and per replay) its own eager run's")
    # the replayed step against the eager Server's decode step at batch 4,
    # host clock around synchronized work, then one replay under the
    # profiler
    toks_in = np.zeros((4, max(LM_PROMPTS)), np.int64)
    for i, pr in enumerate(prompts):
        toks_in[i, -len(pr):] = pr
    with torch.inference_mode():
        lg, caches = transformer.prefill(
            lm.params, {"tokens": torch.from_numpy(toks_in).to(dev)},
            lm.cfg, max_len=LM_MAX_LEN)
        tok = torch.argmax(lg, -1)[:, None]
        pos = iter(range(max(LM_PROMPTS), LM_MAX_LEN))
        def eager_step():
            transformer.decode_step(lm.params, caches, tok, next(pos),
                                    lm.cfg)

        rec["eager_step_ms"] = fenced_ms(eager_step, 15)
        eprof = profile_counts(eager_step)
    rec["profile_eager_step"] = {"wall_ms": eprof["wall_ms"],
                                 "device_ms": eprof["device_ms"],
                                 "kernels": sum(eprof["launches"].values())}
    # the arena as the load left it; its inactive rows stay frozen
    rec["replay_step_ms"] = fenced_ms(eng._run_step, 15)
    eng._run_step()
    prof = profile_counts(eng._run_step,
                          expect={k: v for k, v in want_step.items() if v})
    rec["profile_replay"] = {"wall_ms": prof["wall_ms"],
                             "device_ms": prof["device_ms"],
                             "launches_by_kernel": by_kernel(
                                 prof["launches"]),
                             "kernels": sum(prof["launches"].values())}
    if by_kernel(prof["launches"]) != want_step:
        raise AssertionError(f"the profiler saw {by_kernel(prof['launches'])}"
                             f" in one replay, want {want_step}")
    ep = rec["profile_eager_step"]
    log(f"  decode step at batch 4 (median of 15, synchronized): replayed "
        f"graph {rec['replay_step_ms']:.3f} ms, eager Server "
        f"{rec['eager_step_ms']:.3f} ms; under the profiler, one replay: "
        f"wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms, {rec['profile_replay']['kernels']} "
        f"kernels, of them {rec['profile_replay']['launches_by_kernel']}; "
        f"one eager step: wall {ep['wall_ms']:.3f} ms, busy "
        f"{ep['device_ms']:.3f} ms, {ep['kernels']} kernels")
    record["engine"] = rec

    # ------------------------------------------ 9. compiled gemm_packed
    g, calib = bench_graphs.tiny_mixed_cnn()
    tprog = compile_graph(g, calib, policy=QuantPolicy(
        mode="serial", w_bits=2, a_bits=2), device=dev)
    kinds = [st.kind for st in tprog.steps]
    xt = torch.from_numpy(np.random.RandomState(1).rand(3, 8, 8, 8).astype(
        np.float32)).to(dev)
    reset_counts()
    yt = tprog(xt)
    torch.cuda.synchronize()
    c_tiny = counts()
    if kinds[-1] != "gemm_packed" or c_tiny != {"K1": 2, "K2": 2, "K3": 1,
                                                "K4": 0, "K4g": 0}:
        raise AssertionError(f"tiny_mixed_cnn steps {kinds}, launches "
                             f"{c_tiny}")
    yp = executor.make_plain_runner(tprog)(tprog.params, xt)
    if yt.shape != (3, 10) or not torch.equal(yt, yp):
        raise AssertionError("tiny_mixed_cnn logits differ from the plain "
                             "runner")
    record["launches_tiny"] = c_tiny
    log(f"compiled tiny_mixed_cnn ({', '.join(kinds)}): launches {c_tiny}, "
        "logits equal the plain runner")

    # ------------------------------------------------------ 10. LM times
    log("LM GEMM times, W4A8 (ms, median, L2 flushed before each launch)")
    lm_rows = []
    for k, n in STABLELM_GEMMS:
        for m in (4, 4 * 16):
            c = gemm_case(w4a8, m, k, n, bias=False)
            ops = 2 * m * k * n
            wbytes = c["wp"].numel() * 4 + n * 4 + m * n * 4
            if m > 16:   # torch._int_mm's shape rule
                a8, b8 = c["xc"].to(torch.int8), c["wc"].to(torch.int8)
                lib, lib_name = (lambda: torch._int_mm(a8, b8)), "_int_mm"
            else:
                a16, b16 = c["xc"].half(), c["wc"].half()
                lib, lib_name = (lambda: torch.matmul(a16, b16)), "fp16 mm"
            lib_ms = timer(lib, 50)
            kw = dict(spec=w4a8, k=k)
            for kid, x, fk, fp in (
                    ("K3", c["xp"], km.bitserial_matmul_v2_cuda,
                     km.bitserial_matmul_v2_ref),
                    ("K4", c["xc"], km.bitserial_matmul_cuda,
                     km.bitserial_matmul_ref)):
                byt = x.numel() * 4 + wbytes
                call = lambda: fk(x, c["wp"], c["scale"], **kw)
                lm_rows.append({
                    "kernel": kid, "m": m, "k": k, "n": n,
                    "ms": timer(call, 50),
                    "plain_ms": timer(lambda: fp(x, c["wp"], c["scale"], **kw),
                                      5),
                    "library_ms": lib_ms, "library": lib_name,
                    "bound_ms": max(byt / HBM_BYTES_PER_S,
                                    ops / INT8_OPS_PER_S) * 1e3,
                    "bytes": byt, "ops": ops,
                    "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
                    ops / INT8_OPS_PER_S else "operations"})
    # K1 at the launches a layer makes (bf16, K1_PER_LAYER), at decode and
    # prefill rows, and at (1, 32), one warp's work: what any K1 call costs
    # whatever its size
    for m, k, g in [(m, k, g) for k, g in K1_PER_LAYER for m in (4, 4 * 16)
                    ] + [(1, 32, 1)]:
        xb = cuda(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
        steps = lm_steps[:g]
        byt, ops, bound = k1_bound(m, k, 8, 2, g)
        call = lambda: k1.quantize_pack_multi_cuda(xb, steps, lm_aspec)
        lm_rows.append({
            "kernel": "K1", "m": m, "k": k, "n": None, "g": g,
            "ms": timer(call, 50),
            "plain_ms": timer(lambda: k1.quantize_pack_multi_ref(
                xb, steps, lm_aspec), 10),
            "library_ms": None, "bound_ms": bound, "bytes": byt,
            "ops": ops, "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
            ops / FP32_OPS_PER_S else "operations"})
    for r in lm_rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        what = f" G={r['g']}" if r["kernel"] == "K1" else f"->{r['n']}"
        log(f"  {r['kernel']} M{r['m']} {r['k']}{what}: kernel "
            f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  library {lib}  bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']})")
    record["lm_calls"] = lm_rows
    # the least time of any launch under the same timer: one element zeroed
    elem = torch.zeros(1, device=dev)
    record["launch_floor_ms"] = timer(lambda: elem.zero_(), 50)
    log(f"  launch floor (t.zero_() on one element): "
        f"{record['launch_floor_ms']:.4f} ms")

    def lm_step(kid, key, m):
        """Sum over one LM step (24 layers) of a kernel's per-call number at
        M rows: K3 and K4 over the 7 projections of a layer, K1 over its 4
        launches (K1_PER_LAYER)."""
        if kid == "K1":
            calls = [(1, {"k": k, "g": g}) for k, g in K1_PER_LAYER]
        else:
            calls = [(c, {"k": k, "n": n}) for (k, n), c in
                     zip(STABLELM_GEMMS, GEMMS_PER_LAYER)]
        total_ = 0.0
        for c, want in calls:
            (row,) = [r for r in lm_rows if r["kernel"] == kid and
                      r["m"] == m and all(r[f] == v for f, v in want.items())]
            if row[key] is None:
                return None
            total_ += c * row[key]
        return lm_cfg.n_layers * total_

    # each GEMM kernel's sum over one decode step (M = 4) and one prefill
    # (M = 64), beside its bound and the library call's sum
    record["lm_step_sums"] = {}
    for kid in ("K1", "K3", "K4"):
        n_calls = k1_per_step if kid == "K1" else per_step
        for m, what in ((4, "decode step"), (64, "prefill")):
            sums = {key: lm_step(kid, key, m) for key in
                    ("ms", "bound_ms", "library_ms", "plain_ms")}
            record["lm_step_sums"][f"{kid} M{m}"] = sums
            lib = ("-" if sums["library_ms"] is None
                   else f"{sums['library_ms']:.4f}")
            log(f"  {kid} summed over one {what} ({n_calls} calls at M = "
                f"{m}): {sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f}, "
                f"library {lib}, plain {sums['plain_ms']:.3f}")

    # the step and the end-to-end numbers of each LM path (K1 + K3, and K4
    # with pack_acts=False), host clock around synced work
    toks_in = np.zeros((4, max(LM_PROMPTS)), np.int64)
    for i, pr in enumerate(prompts):
        toks_in[i, -len(pr):] = pr
    batch = {"tokens": torch.from_numpy(toks_in).to(dev)}

    def walls(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def lm_path_times(server, tag):
        """Prefill, decode step (median), generate's tokens/s (best of 2)
        and a profiler breakdown of one prefill and one decode step, into
        record."""
        def prefill():
            return transformer.prefill(server.params, batch, server.cfg,
                                       max_len=LM_MAX_LEN)

        with torch.inference_mode():
            record[f"{tag}_prefill_ms"] = walls(prefill, 5)
            record[f"{tag}_profile_prefill"] = device_profile(prefill)
            lg, caches = prefill()
            tok = torch.argmax(lg, -1)[:, None]
            pos = iter(range(max(LM_PROMPTS), LM_MAX_LEN))

            def step():
                transformer.decode_step(server.params, caches, tok, next(pos),
                                        server.cfg)

            record[f"{tag}_decode_step_ms"] = walls(step, 15)
            prof = device_profile(step)
        record[f"{tag}_profile_decode_step"] = prof
        gen_walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            server.generate(lm_requests())
            gen_walls.append(time.perf_counter() - t0)
        record[f"{tag}_generate_s"] = min(gen_walls)
        record[f"{tag}_tok_per_s"] = 4 * LM_NEW / record[f"{tag}_generate_s"]
        log(f"{tag} batch 4: prefill ({max(LM_PROMPTS)} tokens) "
            f"{record[f'{tag}_prefill_ms']:.3f} ms, decode step "
            f"{record[f'{tag}_decode_step_ms']:.3f} ms, generate({LM_NEW} "
            f"new) {record[f'{tag}_generate_s'] * 1e3:.1f} ms = "
            f"{record[f'{tag}_tok_per_s']:.1f} tok/s")
        for what in ("prefill", "decode_step"):
            pr = record[f"{tag}_profile_{what}"]
            log(f"  profile of one {what}: wall {pr['wall_ms']:.3f} ms, "
                f"device busy {pr['device_ms']:.3f} ms (all profiler rows "
                f"{pr['all_rows_ms']:.3f}); K1 {pr['K1_ms']:.4f} ms in "
                f"{pr['K1_launches']:.0f} launches")
        for k, v in prof["by_name_ms"].items():
            log(f"  {v:9.4f} ms  {prof['launches'][k]:5.0f}x  {k[:80]}")

    lm_path_times(lm, "lm")       # K1 + K3 (pack_acts, the default)
    lm_path_times(k4_lm, "lm_k4")  # K4 (pack_acts=False)
    # the profiler counts the launches the wrappers counted
    for tag, k1_want in (("lm", k1_per_step), ("lm_k4", 0)):
        for what in ("prefill", "decode_step"):
            got = record[f"{tag}_profile_{what}"]["K1_launches"]
            if got != k1_want:
                raise AssertionError(f"{tag} {what}: the profiler saw {got} "
                                     f"K1 launches, want {k1_want}")

    # ------------------------------------------ 11. the serving runtime
    log("serving runtime: ModelRegistry -> DynamicBatcher -> SlotScheduler "
        "(barrel controller) -> InferenceService on the card")
    import dataclasses
    import threading
    from repro_torch.serving import InferenceService, ModelRegistry
    srv = {}
    svc = server.service
    # (a) CNNServer (phase 4's, warmed: its 6 graphs): requests of 1, 3, 17
    # and 32 images, then 64 single-image submits from 4 threads
    plain_svc = InferenceService(server.registry, max_batch=32, plain=True)
    plain_svc.warmup()
    plain_run = plain_svc._runner_for(server.key)
    if plain_run.stats()["cuda_graphs"] != 6 or any(
            any(c.values()) for c in plain_run.capture_launches.values()):
        raise AssertionError(f"plain captures: {plain_run.stats()}")
    reset_counts()
    replays0 = dict(runner.replays)
    sent = {}
    for n in (1, 3, 17, 32):
        classify_traced(server, images[:n], sent)
    burst = np.random.default_rng(11).random((64, 32, 32, 3),
                                             dtype=np.float32)
    lock = threading.Lock()
    futs, errors = {}, []

    def producer(k):
        try:
            for j in range(16):
                i = 4 * j + k
                with lock:      # the trace id just started is this one's
                    f = svc.submit(server.key, burst[i])
                    futs[svc.tracer.started] = (i, f)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.drain(timeout=120)
    burst_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or len(futs) != 64:
        raise AssertionError(f"burst producers: {errors}")
    burst_ids = set(futs)
    for tid, (i, f) in futs.items():
        sent[tid] = (burst[i], f.result())
    ran, forwards = graph_launches(runner, replays0)
    if (any(counts().values()) or runner.compiles != 6
            or runner.stats()["cuda_graphs"] != 6
            or ran != {k: v * forwards for k, v in want_fwd.items()}):
        raise AssertionError(f"after warmup: wrappers {counts()}, compiles "
                             f"{runner.compiles}, launches {ran} over "
                             f"{forwards} replays")
    sizes = check_served(svc, sent, {str(server.key): {
        "eager forward": prog, "plain registry's runner": plain_run}})
    lat = {}
    for sp in svc.tracer.spans():
        if sp.trace_id in burst_ids and sp.name in ("queue", "finalize"):
            lat.setdefault(sp.trace_id, {})[sp.name] = sp
    lat = sorted((v["finalize"].t1_ns - v["queue"].t0_ns) / 1e6
                 for v in lat.values())
    srv.update(cnn_requests=len(sent), cnn_batches=len(sizes),
               cnn_batch_sizes=sizes, cnn_launches_run=ran,
               cnn_forwards=forwards, burst_s=burst_s,
               burst_p50_ms=lat[len(lat) // 2],
               burst_p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               plain_capture_s={b: t for (_, b), t in
                                plain_run.capture_seconds.items()})
    log(f"  {len(sent)} requests (1, 3, 17, 32 and a burst of 64 from 4 "
        f"threads) in {len(sizes)} micro-batches {sizes}: each equals the "
        f"eager forward and the plain registry's captured run at its bucket;"
        f" {forwards} replays ran {ran}; nothing captured after warmup; "
        f"burst {burst_s * 1e3:.1f} ms, per request p50 "
        f"{srv['burst_p50_ms']:.3f} ms, p99 {srv['burst_p99_ms']:.3f} ms")
    cnn_ran = {k: launches[k] + ran[k] for k in launches}

    # (b) W2A2 and W2A8 of one graph in one registry: shared planes
    entry = server.registry.entry(server.key)
    reg2 = ModelRegistry(device=dev)
    k22 = reg2.register_graph("resnet9", entry.graph, entry.calib,
                              entry.policy)
    k28 = reg2.register_graph("resnet9", entry.graph, entry.calib,
                              dataclasses.replace(entry.policy, a_bits=8),
                              precision="W2A8")
    p22, p28 = reg2.program(k22), reg2.program(k28)
    convs = [st.name for st in p22.steps if st.kind == "conv_packed"]
    rs = reg2.stats()
    if (rs["shared_arrays"] != len(convs) or rs["shared_bytes"] <= 0
            or any(p22.params[c]["w_packed"].data_ptr()
                   != p28.params[c]["w_packed"].data_ptr() for c in convs)):
        raise AssertionError(f"W2A2/W2A8 planes not shared: {rs}")
    sent2 = {}
    var_rng = np.random.default_rng(12)
    with InferenceService(reg2, max_batch=32, max_wait_s=0.002) as svc2:
        if svc2.warmup() != 12:
            raise AssertionError("W2A2 + W2A8 warmup")
        runners2 = [svc2._runner_for(k) for k in (k22, k28)]
        reps2 = [dict(r2.replays) for r2 in runners2]
        reset_counts()
        for key, n in ((k22, 5), (k28, 5), (k22, 17), (k28, 3), (k28, 32)):
            xs = var_rng.random((n, 32, 32, 3), dtype=np.float32)
            tid0 = svc2.tracer.started
            fs = svc2.submit_many(key, list(xs))
            for i, f in enumerate(fs):
                sent2[tid0 + 1 + i] = (xs[i], f)
            svc2.drain(timeout=120)
        sent2 = {t: (x, f.result()) for t, (x, f) in sent2.items()}
        if any(counts().values()) or any(r2.compiles != 6
                                         for r2 in runners2):
            raise AssertionError(f"a wrapper ran after warmup: {counts()}")
        ran2 = dict.fromkeys(want_fwd, 0)
        for r2, r0 in zip(runners2, reps2):
            got, fwd2 = graph_launches(r2, r0)
            if got != {k: v * fwd2 for k, v in want_fwd.items()}:
                raise AssertionError(f"variant launches {got} over {fwd2}")
            ran2 = {k: ran2[k] + got[k] for k in ran2}
        sizes2 = check_served(svc2, sent2, {str(k22): {"eager forward": p22},
                                            str(k28): {"eager forward": p28}})
        m2 = svc2.metrics()
    srv.update(variants_shared_bytes=rs["shared_bytes"],
               variants_batch_sizes=sizes2, variants_launches_run=ran2,
               variants_scheduler=m2["scheduler"]["admitted_batches"])
    log(f"  W2A2 + W2A8 share {rs['shared_arrays']} packed planes "
        f"({rs['shared_bytes']} bytes, equal data_ptr); micro-batches "
        f"{sizes2} each equal their variant's eager forward; launches run "
        f"{ran2}")

    # (c) the cycle report: the card's Program lowers to the reference's
    # stream, job for job; the scheduler's booking
    def job_record(j):
        def agu(a):
            return None if a is None else {
                "base": int(a.base),
                "loops": [[int(l.length), int(l.jump)] for l in a.loops]}
        return {"op": j.op.value, "mvu": j.mvu, "a_bits": j.a_bits,
                "w_bits": j.w_bits, "a_signed": j.a_signed,
                "w_signed": j.w_signed, "out_bits": j.out_bits,
                "m_tiles": j.m_tiles, "k_tiles": j.k_tiles,
                "n_outputs": j.n_outputs, "agu_act": agu(j.agu_act),
                "agu_wgt": agu(j.agu_wgt), "use_scaler": j.use_scaler,
                "use_pool": j.use_pool, "use_relu": j.use_relu,
                "dest_mvu": j.dest_mvu, "tag": j.tag,
                "depends_on": list(j.depends_on), "tile_ops": j.tile_ops,
                "cycles": j.cycles}

    with open(os.path.join(ROOT, "tests", "data",
                           "resnet9_w2a2_stream.json")) as f:
        ref_stream = json.load(f)
    cs = prog.to_command_stream()
    if ([job_record(j) for j in cs.jobs] != ref_stream["jobs"]
            or server.cycle_report() != ref_stream["summary"]):
        raise AssertionError("the card Program's stream differs from the "
                             "reference's")
    sched = svc.metrics()["scheduler"]
    srv.update(virtual_cycles=sched["virtual_cycles"],
               slot_utilization=sched["slot_utilization"],
               mean_busy_utilization=sched["mean_busy_utilization"],
               admitted_batches=sched["admitted_batches"],
               hpm=sched["hpm"][0])
    log(f"  cycle report: {len(cs.jobs)} jobs equal the reference's stream; "
        f"scheduler: {sched['admitted_batches']} batches, virtual_cycles "
        f"{sched['virtual_cycles']}, slot utilization "
        f"{sched['slot_utilization']}, hpm busy {sched['hpm'][0]['busy']} "
        f"per_precision {sched['hpm'][0]['per_precision']}")

    # (d) the LM: phase 8b's engine as a callable, the CLI's mixed load
    lm_reg = ModelRegistry(device=dev)
    lkey = lm_reg.register_callable("stablelm-1.6b", eng)
    steps0 = eng.decode_steps
    load = cli_load(16)
    reset_counts()
    with InferenceService(lm_reg, max_wait_s=0.0) as lsvc:
        t0 = time.perf_counter()
        lfuts = lsvc.submit_many(lkey, load)
        lsvc.drain(timeout=600)
        lm_s = time.perf_counter() - t0
        lout = [f.result() for f in lfuts]
        lm_m = lsvc.metrics()
    c_lm = counts()
    lm_steps = eng.decode_steps - steps0
    lm_tokens = sum(len(r.out_tokens) for r in lout)
    for i, r in enumerate(lout):
        if r.out_tokens != out[i].out_tokens:
            raise AssertionError(
                f"service request {i} parts from the bare engine's at "
                f"{first_difference(r.out_tokens, out[i].out_tokens)}")
    if (lm_m["scheduler"]["admitted_batches"] != lm_steps
            or eng.stats()["recompiles_after_warmup"] != 0
            or c_lm != {"K1": k1_per_step * 16, "K2": 0,
                        "K3": per_step * 16, "K4": 0, "K4g": 0}):
        raise AssertionError(f"LM through the service: admissions "
                             f"{lm_m['scheduler']['admitted_batches']}, steps"
                             f" {lm_steps}, {eng.stats()}, prefills {c_lm}")
    lm_ran = {k: c_lm[k] + rec["step_launches"][k] * lm_steps
              for k in ("K1", "K3")}
    srv.update(lm_requests=len(lout), lm_tokens=lm_tokens, lm_s=lm_s,
               lm_tok_per_s=lm_tokens / lm_s, lm_decode_steps=lm_steps,
               lm_batches=lm_m["batches"], lm_launches_run=lm_ran,
               lm_scheduler_cycles=lm_m["scheduler"]["virtual_cycles"])
    log(f"  LM: 16 requests through the service in {lm_m['batches']} "
        f"micro-batches, tokens equal the bare engine's; {lm_tokens} tokens "
        f"in {lm_s * 1e3:.1f} ms = {lm_tokens / lm_s:.1f} tok/s; one "
        f"admission per decode step ({lm_steps}); launches run {lm_ran}")
    plain_svc.stop()
    server.close()
    record["serving"] = srv

    # ----------------------- 12. deepseek-v2-lite-16b: MLA + 64-expert MoE
    log("deepseek-v2-lite-16b FULL (27 layers: 1 dense + 26 MLA + MoE, 64 "
        "routed experts top-6 + 2 shared, bf16, W4A8, seed 0) on the card")
    del lm, k4_lm, plain_lm, two, one, solo, k4_eng, sm_gpu, sm_cpu
    torch.cuda.empty_cache()
    ds = {}
    ds_cfg = get_arch("deepseek-v2-lite-16b").full
    ds_spec = plan_spec(ds_cfg.policy.spec())
    n_layers = ds_cfg.n_layers
    n_moe = n_layers - ds_cfg.n_dense_layers
    n_exp, d_exp, d_mod = ds_cfg.n_experts, ds_cfg.d_ff_expert, ds_cfg.d_model
    # (a) grouped K4 against its plain version: the routed experts' shapes
    # (C = 1 at a batch-4 decode step, 2 at a 16-token prefill bucket, 8 at
    # the Server's 4 x 16 prefill), a ragged case, W4A8 (the model's plan),
    # radix 1 and unsigned W8A8; then rows and experts that are all zero,
    # as the dispatch leaves them (the kernel reads no weight for those)
    g_dev = torch.Generator(device=dev).manual_seed(18)

    def grouped_operands(spec, e, c, k, n):
        """Random codes (E, C, K), weight codes (E, K, N) and their packed
        planes (E, w_bits, ceil(K/32), N), made on the card."""
        la, ha = qrange(spec.a_bits, spec.a_signed)
        lw, hw = qrange(spec.w_bits, spec.w_signed)
        xc = torch.randint(la, ha + 1, (e, c, k), generator=g_dev,
                           device=dev, dtype=torch.int32)
        wc = torch.randint(lw, hw + 1, (e, k, n), generator=g_dev,
                           device=dev, dtype=torch.int32)
        wp = torch.stack([bitops.pack_bitplanes(bitops.pad_to(
            bitops.to_bitplanes(wc[i], spec.w_bits), 32, axis=1), axis=1)
            for i in range(e)])
        return xc, wc, wp

    up_w = grouped_operands(ds_spec, n_exp, 8, d_mod, d_exp)
    down_w = grouped_operands(ds_spec, n_exp, 8, d_exp, d_mod)
    g_cases = []
    for (x8, _, wp), (k, n) in ((up_w, (d_mod, d_exp)),
                                (down_w, (d_exp, d_mod))):
        for c in (1, 2, 8):
            g_cases.append((f"W4A8 E{n_exp} C{c} {k}->{n}", ds_spec,
                            x8[:, :c].contiguous(), wp, k))
    radix1 = SerialSpec(8, 4, True, True, 1)
    w8a8u = SerialSpec(8, 8, False, True, 7)
    for spec, tag in ((ds_spec, "W4A8"), (radix1, "W4A8 radix 1"),
                      (w8a8u, "W8A8 unsigned")):
        xr, _, wr = grouped_operands(spec, 3, 5, 100, 70)
        g_cases.append((f"ragged E3 C5 100->70 {tag}", spec, xr, wr, 100))
    u8_w = grouped_operands(w8a8u, n_exp, 8, d_mod, d_exp)
    for spec, tag, (x8, _, wr) in ((radix1, "W4A8 radix 1", up_w),
                                   (w8a8u, "W8A8 unsigned", u8_w)):
        g_cases.append((f"{tag} E{n_exp} C1 {d_mod}->{d_exp}", spec,
                        x8[:, :1].contiguous(), wr, d_mod))
    # the rows a batch-4 decode step's dispatch fills (C = 1): a seeded
    # (4, top_k) routing through moe.dispatch
    moe_cfg = ds_cfg.moe_cfg()
    cap1 = moe.capacity_for(4, moe_cfg)
    routed = torch.topk(torch.randn((4, n_exp), generator=g_dev, device=dev),
                        moe_cfg.top_k, dim=-1).indices
    keep1, flat1 = moe.dispatch(routed, n_exp, cap1)
    filled = torch.zeros(n_exp * cap1 + 1, dtype=torch.bool, device=dev)
    filled[flat1[keep1]] = True
    live1 = filled[:-1].reshape(n_exp, cap1)
    occupied = int(live1.any(1).sum())
    live2 = torch.ones((n_exp, 2), dtype=torch.bool, device=dev)
    live2[torch.arange(n_exp, device=dev), torch.arange(n_exp, device=dev)
          % 2] = False                       # one row of each expert zero
    live8 = (torch.arange(n_exp, device=dev) % 3 == 1)[:, None].expand(
        n_exp, 8)                            # whole experts zero

    def zeroed(x, live):
        return (x * live[:, :, None].to(x.dtype)).contiguous()

    for spec, tag, (x8, _, wr) in ((ds_spec, "W4A8", up_w),
                                   (radix1, "W4A8 radix 1", up_w),
                                   (w8a8u, "W8A8 unsigned", u8_w)):
        g_cases += [
            (f"{tag} E{n_exp} C1 {d_mod}->{d_exp}, the dispatch's "
             f"{occupied} experts", spec, zeroed(x8[:, :1], live1), wr,
             d_mod),
            (f"{tag} E{n_exp} C2 one row of each expert zero", spec,
             zeroed(x8[:, :2], live2), wr, d_mod),
            (f"{tag} E{n_exp} C8 experts 0, 2, 3, 5, ... zero", spec,
             zeroed(x8, live8), wr, d_mod),
            (f"{tag} E{n_exp} C1 all zero", spec,
             torch.zeros_like(x8[:, :1]), wr, d_mod)]
    g_cases.append((f"W4A8 E{n_exp} C1 {d_exp}->{d_mod}, the dispatch's "
                    f"{occupied} experts", ds_spec,
                    zeroed(down_w[0][:, :1], live1), down_w[2], d_exp))
    for name, spec, x, wp, k in g_cases:
        check_equal("K4g", name,
                    km.bitserial_matmul_grouped_cuda(x, wp, spec=spec, k=k),
                    km.bitserial_matmul_grouped_ref(x, wp, spec=spec, k=k))
    log(f"  grouped K4 equals its plain version (torch.equal) in "
        f"{len(g_cases)} cases: " + "; ".join(c[0] for c in g_cases))
    del u8_w

    # times of one grouped launch at the model's shapes, cold, against its
    # bound and an fp16 bmm of the codes (timed only, never on the path):
    # every expert's row nonzero (C = 1 and 8) and the dispatch's rows
    # (C = 1, `occupied` experts)
    g_rows = []
    for (x8, wc, wp), (k, n) in ((up_w, (d_mod, d_exp)),
                                 (down_w, (d_exp, d_mod))):
        w16 = wc.half()
        for c, case in ((1, "full"), (1, "dispatch"), (8, "full")):
            x = x8[:, :c].contiguous()
            if case == "dispatch":
                x = zeroed(x, live1)
            x16 = x.half()
            n_occ = n_exp if case == "full" else occupied
            byt = x.numel() * 4 + wp.numel() * 4 * n_occ // n_exp \
                + n_exp * c * n * 4
            ops = 2 * n_occ * c * k * n
            g_rows.append({
                "c": c, "k": k, "n": n, "case": case, "experts": n_occ,
                "bytes": byt, "ops": ops,
                "ms": timer(lambda: km.bitserial_matmul_grouped_cuda(
                    x, wp, spec=ds_spec, k=k), 50),
                "plain_ms": timer(lambda: km.bitserial_matmul_grouped_ref(
                    x, wp, spec=ds_spec, k=k), 3),
                "library_ms": timer(lambda: torch.bmm(x16, w16), 50),
                "bound_ms": max(byt / HBM_BYTES_PER_S,
                                ops / INT8_OPS_PER_S) * 1e3,
                "bound_by": "bytes" if byt / HBM_BYTES_PER_S >=
                ops / INT8_OPS_PER_S else "operations"})
    del up_w, down_w, g_cases
    for r in g_rows:
        log(f"  K4g E{n_exp} C{r['c']} {r['k']}->{r['n']} {r['case']} "
            f"({r['experts']} experts): kernel {r['ms']:.4f}  plain "
            f"{r['plain_ms']:.3f}  fp16 bmm {r['library_ms']:.4f}  bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}, "
            f"{r['bytes'] / 1e6:.1f} MB)")

    def g_step(key, case="full"):
        """A decode step's sum (C = 1): up and gate (d_model -> d_ff_expert)
        and down per MoE layer."""
        (a,) = [r for r in g_rows if r["c"] == 1 and r["k"] == d_mod
                and r["case"] == case]
        (b,) = [r for r in g_rows if r["c"] == 1 and r["k"] == d_exp
                and r["case"] == case]
        return n_moe * (2 * a[key] + b[key])

    step_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")
    ds["grouped_calls"] = g_rows
    ds["grouped_dispatch_experts"] = occupied
    ds["grouped_step_sums"] = {key: g_step(key) for key in step_keys}
    ds["grouped_step_sums_dispatch"] = {key: g_step(key, "dispatch")
                                        for key in step_keys}
    for tag, sums in (("every expert", ds["grouped_step_sums"]),
                      (f"the dispatch's {occupied} experts",
                       ds["grouped_step_sums_dispatch"])):
        log(f"  K4g summed over one decode step ({3 * n_moe} launches at "
            f"C = 1, {tag}): {sums['ms']:.4f} ms, bound "
            f"{sums['bound_ms']:.4f}, fp16 bmm {sums['library_ms']:.4f}, "
            f"plain {sums['plain_ms']:.2f}")

    # (b) the weights, drawn and packed one layer at a time on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds_params = transformer.init_params(
        torch.Generator(device=dev).manual_seed(0), ds_cfg, packed=True)
    torch.cuda.synchronize()
    ds.update(init_s=time.perf_counter() - t0,
              init_peak_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9,
              params_gb=(torch.cuda.memory_allocated() - mem0) / 1e9)
    log(f"  random weights from seed 0 drawn and packed one layer at a time "
        f"in {ds['init_s']:.2f} s: {ds['params_gb']:.2f} GB on the card, "
        f"peak {ds['init_peak_gb']:.2f} GB above what was held before")

    # (c) Server: 4 requests, 16 new tokens each
    ds_k1, ds_k3, ds_k4g = 4 * n_layers, 6 * n_layers, 3 * n_moe
    ds_want_step = {"K1": ds_k1, "K3": ds_k3, "K4": 0, "K4g": ds_k4g}
    ds_srv = Server(ds_cfg, ds_params, batch_slots=4, max_len=LM_MAX_LEN)
    prompt_rng = np.random.RandomState(0)
    ds_prompts = [prompt_rng.randint(0, ds_cfg.vocab_size, (n,)).astype(
        np.int32) for n in LM_PROMPTS]

    def ds_requests(new=LM_NEW):
        return [GenRequest(p.copy(), new) for p in ds_prompts]

    ds_main = lm_drive(ds_srv, ds_requests())
    want = {"K1": ds_k1 * LM_NEW, "K2": 0, "K3": ds_k3 * LM_NEW, "K4": 0,
            "K4g": ds_k4g * LM_NEW}
    if ds_main[2] != want:
        raise AssertionError(f"deepseek Server launches {ds_main[2]}, want "
                             f"{want}")
    toks, logits = ds_main[0], ds_main[1]
    if (logits.shape != (4, ds_cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())
            or any(len(t) != LM_NEW or not all(0 <= v < ds_cfg.vocab_size
                                               for v in t) for t in toks)):
        raise AssertionError(f"bad deepseek output {logits.shape} {toks}")
    ds_batch = np.zeros((4, max(LM_PROMPTS)), np.int64)
    for i, pr in enumerate(ds_prompts):
        ds_batch[i, -len(pr):] = pr
    ds_batch = {"tokens": torch.from_numpy(ds_batch).to(dev)}
    with torch.inference_mode():
        reset_counts()
        _, caches = transformer.prefill(ds_srv.params, ds_batch, ds_srv.cfg,
                                        max_len=LM_MAX_LEN)
        c_pre = counts()
        reset_counts()
        transformer.decode_step(ds_srv.params, caches,
                                ds_batch["tokens"][:, :1], max(LM_PROMPTS),
                                ds_srv.cfg)
        c_dec = counts()
        torch.cuda.synchronize()
    for c in (c_pre, c_dec):
        if {k: c[k] for k in ds_want_step} != ds_want_step:
            raise AssertionError(f"deepseek per-step launches prefill "
                                 f"{c_pre}, decode {c_dec}, want "
                                 f"{ds_want_step}")
    log(f"  Server: 4 requests x {LM_NEW} tokens, launches {ds_main[2]}; "
        f"one prefill and one decode step each run {ds_want_step} (4 K1, 6 "
        f"K3 a layer: q + kv-down share one K1, then wo, the gate/up pair "
        f"and down; 3 grouped K4 a MoE layer: up, gate, down)")
    ds_plain = Server(ds_cfg, ds_params, batch_slots=4, max_len=LM_MAX_LEN,
                      plain=True)
    ds_short = lm_drive(ds_srv, ds_requests(DS_PLAIN_NEW))
    if ds_short[0] != [t[:DS_PLAIN_NEW] for t in toks]:
        raise AssertionError("deepseek: a shorter run's tokens differ")
    t0 = time.perf_counter()
    ds_p = lm_drive(ds_plain, ds_requests(DS_PLAIN_NEW))
    ds["plain_generate_s"] = time.perf_counter() - t0
    ds["plain_new_tokens"] = DS_PLAIN_NEW
    if any(ds_p[2].values()):
        raise AssertionError(f"plain run launched kernels: {ds_p[2]}")
    if ds_p[0] != ds_short[0] or not torch.equal(ds_p[1], ds_short[1]):
        raise AssertionError("deepseek tokens/logits differ from the plain "
                             "run")
    del ds_plain
    log(f"  over {DS_PLAIN_NEW} new tokens, tokens and last-step logits "
        f"equal the plain versions' run ({ds['plain_generate_s']:.1f} s); "
        f"request 0: {toks[0]}")
    ds_smoke = get_arch("deepseek-v2-lite-16b").smoke
    sm_gpu = Server(ds_smoke, batch_slots=4, max_len=32, seed=0)
    sm_cpu = Server(ds_smoke, tree_to(sm_gpu.params, "cpu"), batch_slots=4,
                    max_len=32, device="cpu")
    sm_prompts = [np.arange(n, dtype=np.int32) * 7 % ds_smoke.vocab_size
                  for n in (3, 6, 9)]
    a = [r.out_tokens for r in sm_gpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    b = [r.out_tokens for r in sm_cpu.generate(
        [GenRequest(p.copy(), 8) for p in sm_prompts])]
    if a != b:
        raise AssertionError(f"deepseek smoke config: card {a} vs CPU {b}")
    log(f"  smoke config: card tokens equal the CPU plain run's {a[0]}")
    with torch.inference_mode():
        def ds_prefill():
            return transformer.prefill(ds_srv.params, ds_batch, ds_srv.cfg,
                                       max_len=LM_MAX_LEN)

        ds["prefill_ms"] = walls(ds_prefill, 3)
        ds["profile_prefill"] = device_profile(ds_prefill)
        lg, caches = ds_prefill()
        tok = torch.argmax(lg, -1)[:, None]
        pos = iter(range(max(LM_PROMPTS), LM_MAX_LEN))

        def ds_step():
            transformer.decode_step(ds_srv.params, caches, tok, next(pos),
                                    ds_srv.cfg)

        ds["eager_step_ms"] = walls(ds_step, 5)
        ds["profile_eager_step"] = device_profile(ds_step)
        del caches
    t0 = time.perf_counter()
    ds_srv.generate(ds_requests())
    ds["generate_s"] = time.perf_counter() - t0
    log(f"  Server batch 4: prefill (16 tokens) {ds['prefill_ms']:.2f} ms "
        f"(busy {ds['profile_prefill']['device_ms']:.3f}), eager decode step "
        f"{ds['eager_step_ms']:.2f} ms (busy "
        f"{ds['profile_eager_step']['device_ms']:.3f}), generate "
        f"{ds['generate_s'] * 1e3:.0f} ms = "
        f"{4 * LM_NEW / ds['generate_s']:.1f} tok/s")

    # (d) the continuous engine on the CLI's mixed load
    t0 = time.perf_counter()
    ds_eng = ContinuousLMEngine(ds_cfg, ds_params, batch_slots=4,
                                max_len=LM_MAX_LEN)
    warm = ds_eng.warmup()
    st = ds_eng.stats()
    if (not st["cuda_graph"] or st["compiles"]["decode"] != 1
            or st["step_launches"] != ds_want_step):
        raise AssertionError(f"deepseek engine capture: {st}")
    ds.update(engine_warmup_s=warm["seconds"], capture_s=st[
        "capture_seconds"], step_launches=st["step_launches"])
    log(f"  engine warmup {warm['seconds']:.2f} s (buckets "
        f"{warm['buckets']}); decode step captured once in "
        f"{st['capture_seconds']:.3f} s with {st['step_launches']}")
    ds_load = cli_load(16, vocab=ds_cfg.vocab_size)

    def copies(reqs):
        return [GenRequest(r.prompt.copy(), r.max_new_tokens) for r in reqs]

    calls0 = st["calls"].get("decode", 0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds_out = ds_eng.serve(copies(ds_load))
    ds_load_s = time.perf_counter() - t0
    c_load = counts()
    em = ds_eng.engine_metrics()
    n_tok = sum(len(r.out_tokens) for r in ds_out)
    want_load = {k: v * len(ds_load) for k, v in ds_want_step.items()}
    want_load["K2"] = 0
    st = ds_eng.stats()
    if (c_load != want_load or st["recompiles_after_warmup"] != 0
            or st["calls"]["decode"] - calls0 != em["decode_steps"]):
        raise AssertionError(f"deepseek engine load: prefill launches "
                             f"{c_load} (want {want_load}), {st}")
    for r in ds_out:
        if (len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= v < ds_cfg.vocab_size for v in r.out_tokens)):
            raise AssertionError(f"bad deepseek engine output {r.out_tokens}")
    ds_ran = {k: c_load[k] + ds_want_step[k] * em["decode_steps"]
              for k in ("K1", "K3", "K4g")}
    drops = ds_eng.drop_fractions()
    ds.update(load_tokens=n_tok, load_s=ds_load_s,
              tok_per_s=n_tok / ds_load_s, decode_steps=em["decode_steps"],
              slot_occupancy=em["slot_occupancy"],
              launches_load_prefills=c_load, launches_load_run=ds_ran,
              drop_frac_per_step=drops.mean(axis=1).tolist(),
              drop_frac_max_layer=float(drops.max()))
    log(f"  mixed load: 16 requests, {n_tok} tokens in "
        f"{ds_load_s * 1e3:.0f} ms = {ds['tok_per_s']:.1f} tok/s (a smoke "
        f"reading); {em['decode_steps']} replayed steps (occupancy "
        f"{em['slot_occupancy']}); launches run {ds_ran}; "
        "recompiles_after_warmup 0")
    log("  drop_frac per step (mean over the 26 MoE layers): "
        + " ".join(f"{v:.3f}" for v in ds["drop_frac_per_step"]))
    # the same engine with an eager step on the same load: 16 requests
    # fill every slot before the first step, so the arena's history does
    # not enter; bit for bit
    ds_eager = ContinuousLMEngine(ds_cfg, ds_params, batch_slots=4,
                                  max_len=LM_MAX_LEN)
    ds_eager._fresh_arena()
    ds_eager._graph = None                  # its steps run eagerly
    e_out = ds_eager.serve(copies(ds_load))
    for i, (r, e) in enumerate(zip(ds_out, e_out)):
        if r.out_tokens != e.out_tokens:
            raise AssertionError(
                f"deepseek request {i}: the graphed engine parts from the "
                f"eager one at {first_difference(r.out_tokens, e.out_tokens)}")
    if not np.array_equal(drops, ds_eager.drop_fractions()):
        raise AssertionError("graphed and eager drop fractions differ")
    log("  the graphed engine equals the same engine stepping eagerly on "
        "the same load, tokens and drop fractions bit for bit")
    ds_engine_ref = {"load": [(r.prompt.copy(), r.max_new_tokens)
                              for r in ds_load],
                     "tokens": [list(r.out_tokens) for r in ds_out],
                     "step": dict(ds_want_step)}
    # the plain versions' engine (captured too) on the first four requests,
    # against the graphed engine on the same four (four fill every slot)
    four = [GenRequest(r.prompt.copy(), min(r.max_new_tokens,
                                            DS_PLAIN_NEW))
            for r in ds_load[:4]]
    g4 = ds_eng.serve(copies(four))
    ds_plain_eng = ContinuousLMEngine(ds_cfg, ds_params, batch_slots=4,
                                      max_len=LM_MAX_LEN, plain=True)
    reset_counts()
    t0 = time.perf_counter()
    p4 = ds_plain_eng.serve(copies(four))
    ds["plain_serve_s"] = time.perf_counter() - t0
    if any(counts().values()) or not ds_plain_eng.stats()["cuda_graph"]:
        raise AssertionError(f"deepseek plain engine: {counts()}")
    for i, (r, p) in enumerate(zip(g4, p4)):
        if r.out_tokens != p.out_tokens:
            raise AssertionError(
                f"deepseek plain engine request {i} parts at "
                f"{first_difference(r.out_tokens, p.out_tokens)}")
    del ds_plain_eng
    log(f"  the plain versions' engine ({ds['plain_serve_s']:.1f} s) gives "
        f"the graphed engine's tokens on the first four requests")
    # reported, not held: each request alone in an empty arena (eagerly),
    # against its tokens in the mixed load; the capacity couples rows
    alone = []
    for i, r in enumerate(ds_load):
        a_ = ds_eager._arena
        for g in a_["caches"]:
            for name, buf in g.items():
                if name != "len":
                    buf.zero_()
        a_["tok"].zero_()
        a_["pos"].zero_()
        ds_eager._reset_serving_metrics()
        ref = ds_eager.serve(copies([r]))[0].out_tokens
        t = parting_token(ds_out[i].out_tokens, ref)
        alone.append({"request": i, "prompt": len(r.prompt),
                      "new": r.max_new_tokens, "parts_at": t,
                      "alone_drop_frac": ds_eager.drop_fractions().mean(
                          axis=1).tolist()})
    ds["alone"] = alone
    log(f"  each request alone in an empty arena (reported): "
        f"{sum(a['parts_at'] is None for a in alone)} of 16 equal their "
        f"mixed-load tokens; parted at "
        f"{[(a['request'], a['parts_at']) for a in alone if a['parts_at'] is not None]}")
    del ds_eager
    # the replayed step: wall (synchronized) and the card's busy time, its
    # kernels by name against the wrappers' count at capture
    ds["replay_step_ms"] = fenced_ms(ds_eng._run_step, 15)
    ds_eng._run_step()
    prof = profile_counts(ds_eng._run_step, expect={
        k: v for k, v in ds_want_step.items() if v})
    in_path = {}
    for name, v in prof["ms"].items():
        kid = kernel_of(name)
        if kid is not None:
            in_path[kid] = in_path.get(kid, 0.0) + v
    ds["profile_replay"] = {"wall_ms": prof["wall_ms"],
                            "device_ms": prof["device_ms"],
                            "launches_by_kernel": by_kernel(prof["launches"]),
                            "ms_by_kernel": in_path,
                            "kernels": sum(prof["launches"].values())}
    if by_kernel(prof["launches"]) != ds_want_step:
        raise AssertionError(f"the profiler saw {by_kernel(prof['launches'])}"
                             f" in one deepseek replay, want {ds_want_step}")
    # the experts each MoE layer's dispatch fills in that step: the step run
    # eagerly on a copy of the arena (restored after), outside the graph,
    # its dispatch's keep/flat read on the same inputs
    a_ = ds_eng._arena
    saved = [(t, t.clone()) for t in (a_["tok"], a_["pos"], a_["drop_frac"])]
    saved += [(buf, buf.clone()) for g in a_["caches"]
              for name, buf in g.items() if torch.is_tensor(buf)]
    filled_per_layer = []
    inner_dispatch = moe.dispatch

    def recording_dispatch(expert_idx, n_experts, capacity):
        keep_, flat_ = inner_dispatch(expert_idx, n_experts, capacity)
        filled_per_layer.append(int(torch.unique(
            torch.div(flat_[keep_], capacity, rounding_mode="floor")).numel()))
        return keep_, flat_

    moe.dispatch = recording_dispatch
    try:
        with torch.inference_mode():
            ds_eng._step_fn()
    finally:
        moe.dispatch = inner_dispatch
        with torch.inference_mode():
            for t, c in saved:
                t.copy_(c)
    del saved
    if len(filled_per_layer) != n_moe:
        raise AssertionError(f"{len(filled_per_layer)} dispatches in one "
                             f"deepseek step, want {n_moe}")
    ds["occupied_experts_per_layer"] = filled_per_layer
    ds["occupied_experts_per_step"] = sum(filled_per_layer) / n_moe
    log(f"  replayed decode step at batch 4 (median of 15, synchronized): "
        f"{ds['replay_step_ms']:.3f} ms; one replay under the profiler: wall "
        f"{prof['wall_ms']:.3f} ms, busy {prof['device_ms']:.3f} ms, "
        f"{ds['profile_replay']['kernels']} kernels, of them "
        f"{ds['profile_replay']['launches_by_kernel']}; grouped K4 in path "
        f"{in_path.get('K4g', 0.0):.4f} ms; the dispatch fills "
        f"{ds['occupied_experts_per_step']:.2f} of {n_exp} experts a MoE "
        f"layer ({filled_per_layer})")

    # (e) through InferenceService: one micro-batch of the 16 requests (a
    # batching window long enough to gather them) gives the bare engine's
    # tokens
    ds_reg = ModelRegistry(device=dev)
    ds_key = ds_reg.register_callable("deepseek-v2-lite-16b", ds_eng)
    steps0 = ds_eng.decode_steps
    reset_counts()
    with InferenceService(ds_reg, max_batch=16, max_wait_s=30.0) as ds_svc:
        t0 = time.perf_counter()
        futs = ds_svc.submit_many(ds_key, copies(ds_load))
        ds_svc.drain(timeout=600)
        svc_s = time.perf_counter() - t0
        s_out = [f.result() for f in futs]
        sm = ds_svc.metrics()
    c_svc = counts()
    svc_steps = ds_eng.decode_steps - steps0
    for i, (r, s_) in enumerate(zip(ds_out, s_out)):
        if r.out_tokens != s_.out_tokens:
            raise AssertionError(
                f"deepseek service request {i} parts from the bare engine's "
                f"at {first_difference(r.out_tokens, s_.out_tokens)}")
    if (sm["batches"] != 1 or sm["scheduler"]["admitted_batches"] != svc_steps
            or c_svc != want_load):
        raise AssertionError(f"deepseek through the service: "
                             f"{sm['batches']} micro-batches, admissions "
                             f"{sm['scheduler']['admitted_batches']}, steps "
                             f"{svc_steps}, prefill launches {c_svc}")
    ds_svc_ran = {k: c_svc[k] + ds_want_step[k] * svc_steps
                  for k in ("K1", "K3", "K4g")}
    ds.update(service_s=svc_s, service_steps=svc_steps,
              service_launches_run=ds_svc_ran)
    log(f"  through InferenceService: one micro-batch, the bare engine's "
        f"tokens; {svc_steps} admissions = decode steps; launches run "
        f"{ds_svc_ran}")
    # the step's least time: every weight byte a decode step reads (packed
    # planes, MLA's float w_uk/w_uv, the router, the bf16 head) over the
    # card's memory rate
    w_bytes = sum(t.numel() * t.element_size()
                  for g in ds_eng.params["groups"]
                  for t in tree_leaves(g)) + ds_eng.params["head"][
                      "w"].numel() * 2
    ds["step_weight_bytes"] = w_bytes
    ds["step_bound_ms"] = w_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  a decode step reads {w_bytes / 1e9:.2f} GB of weights: bound "
        f"{ds['step_bound_ms']:.3f} ms against the replay's "
        f"{ds['profile_replay']['device_ms']:.3f} ms busy")
    ds_launches = {k: ds_main[2][k] + ds_ran[k] + ds_svc_ran[k]
                   for k in ("K1", "K3", "K4g")}
    ds["launches"] = ds_launches
    record["deepseek"] = ds

    # -------------------------------------------------- 13. the toolchain
    log("toolchain: compile once into an ArtifactStore, warm boot, serve, "
        "profile step by step, fit ns per cycle (full-width ResNet9, seed 0)")
    import shutil
    import tempfile
    from repro_torch.compiler import (ArtifactError, ArtifactStore,
                                      load_program)
    from repro_torch.launch.serve import resnet9_recipe
    from repro_torch.obs import calibrate
    from repro_torch.obs.profiler import (CALLS_PER_RUN, format_profile,
                                          profile_program)
    tc = {}
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    cli_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_store_")
    try:
        # (a) cold compile of W2A2 and W2A8 into the store
        graph, calib, pol = resnet9_recipe(0, 8)
        reg_a = ModelRegistry(device=dev, store=store_dir)
        ka22 = reg_a.register_graph(graph.name, graph, calib, pol)
        ka28 = reg_a.register_graph(graph.name, graph, calib,
                                    dataclasses.replace(pol, a_bits=8))
        compile_s = {}
        for k in (ka22, ka28):
            t0 = time.perf_counter()
            reg_a.program(k)
            torch.cuda.synchronize()
            compile_s[str(k)] = time.perf_counter() - t0
        pa22, pa28 = reg_a.program(ka22), reg_a.program(ka28)
        st_a = reg_a.store.stats()
        mans = [reg_a.store.get_program(reg_a.store.resolve(str(k)))
                for k in (ka22, ka28)]
        convs13 = [s.name for s in pa22.steps if s.kind == "conv_packed"]
        blobs = {r["blob"] for m in mans for p in m["params"].values()
                 for r in p.values()}
        if (reg_a.compiles != 2 or reg_a.artifact_saves != 2
                or st_a["programs"] != 2 or st_a["blobs"] != len(blobs)
                or any(mans[0]["params"][c]["w_packed"]
                       != mans[1]["params"][c]["w_packed"] for c in convs13)
                or st_a["blob_dedups"] < len(convs13)):
            raise AssertionError(f"cold compile into the store: {st_a}")
        tc.update(compile_s=compile_s, store_cold=st_a,
                  logical_bytes=reg_a.store.logical_bytes)
        log(f"  (a) compiled {ka22} in {compile_s[str(ka22)]:.3f} s and "
            f"{ka28} in {compile_s[str(ka28)]:.3f} s into the store: "
            f"{st_a['programs']} programs, {st_a['blob_writes']} blob writes,"
            f" {st_a['blob_dedups']} dedups (the {len(convs13)} shared "
            f"planes stored once), {reg_a.store.logical_bytes} logical "
            f"bytes, "
            f"{st_a['bytes_on_disk']} bytes on disk")

        # (b) warm boot: a fresh registry and service on the same store
        reg_b = ModelRegistry(device=dev, store=store_dir)
        kb22 = reg_b.register_artifact(graph.name, precision="W2A2")
        kb28 = reg_b.register_artifact(graph.name, precision="W2A8")
        svc_b = InferenceService(reg_b, max_batch=32, max_wait_s=0.002)
        svc_b.start()
        t0 = time.perf_counter()
        boot = svc_b.warm_boot()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        pb22, pb28 = reg_b.program(kb22), reg_b.program(kb28)
        load_ms = list(reg_b.store._load_ms)
        if (boot["compiled"] or sorted(boot["restored"])
                != sorted([str(kb22), str(kb28)]) or reg_b.compiles != 0
                or boot["bucket_compiles"] != 12
                or pb22.device != dev
                or any(pb22.params[c]["w_packed"] is not
                       pb28.params[c]["w_packed"] for c in convs13)):
            raise AssertionError(f"warm boot: {boot}, compiles "
                                 f"{reg_b.compiles}")
        fleet = CNNServer(store=store_dir, artifact=f"{graph.name}@W2A2",
                          max_batch=32)
        t0 = time.perf_counter()
        fleet_boot = fleet.warm_boot()
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
        if (fleet_boot["restored"] != [str(fleet.key)]
                or fleet.registry.compiles != 0
                or fleet_boot["bucket_compiles"] != 6):
            raise AssertionError(f"CNNServer(artifact=) boot: {fleet_boot}")
        fleet_run = fleet.service._runner_for(fleet.key)
        runs_b = [svc_b._runner_for(k) for k in (kb22, kb28)]
        reps_b = [dict(r.replays) for r in [fleet_run] + runs_b]
        reset_counts()
        sent = {}
        for n in (1, 17, 32):
            classify_traced(fleet, images[:n], sent)
        sent_b = {}
        for key, n in ((kb22, 5), (kb28, 5)):
            tid0 = svc_b.tracer.started
            fs = svc_b.submit_many(key, list(images[:n]))
            svc_b.drain(timeout=120)
            for i, f in enumerate(fs):
                sent_b[tid0 + 1 + i] = (images[i], f.result())
        if any(counts().values()):
            raise AssertionError(f"a wrapper ran after the warm boots: "
                                 f"{counts()}")
        ran13 = dict.fromkeys(want_fwd, 0)
        for r, r0 in zip([fleet_run] + runs_b, reps_b):
            got, fwd = graph_launches(r, r0)
            if got != {k: v * fwd for k, v in want_fwd.items()}:
                raise AssertionError(f"warm-booted launches {got} over {fwd}")
            ran13 = {k: ran13[k] + got[k] for k in ran13}
        # the comparisons' eager forwards are left out of the counts above
        sizes13 = check_served(fleet.service, sent, {str(fleet.key): {
            "Program compiled in (a)": pa22}})
        check_served(svc_b, sent_b, {str(kb22): {"(a)'s W2A2": pa22},
                                     str(kb28): {"(a)'s W2A8": pa28}})
        tc.update(warm_boot_s=warm_s, load_ms=load_ms, fleet_boot_s=fleet_s,
                  fleet_load_ms=list(fleet.registry.store._load_ms),
                  served_batch_sizes=sizes13, served_launches=ran13)
        log(f"  (b) warm boot of a fresh registry + service: restored "
            f"{boot['restored']}, 0 compiles, {boot['bucket_compiles']} "
            f"bucket graphs captured, in {warm_s:.3f} s (load_program "
            f"{', '.join(f'{v:.1f}' for v in load_ms)} ms; the cold "
            f"compiles took {sum(compile_s.values()):.3f} s); shared planes "
            f"one tensor on the card; CNNServer(artifact=) booted in "
            f"{fleet_s:.3f} s (load "
            f"{fleet.registry.store._load_ms[0]:.1f} ms) and answered 1, 17 "
            f"and 32 images in micro-batches {sizes13}, each equal bit for "
            f"bit to (a)'s Program at its bucket; W2A2 and W2A8 through the "
            f"warm-booted service equal (a)'s; replays ran {ran13}")
        fleet.close()

        # (c) integrity on the card
        store_c = ArtifactStore(store_dir)
        man = mans[0]
        blob_path = store_c._blob_path(man["params"]["conv1"]["w_packed"]
                                       ["blob"])
        with open(blob_path, "rb") as f:
            payload = f.read()
        flipped = bytearray(payload)
        flipped[-1] ^= 0x01
        try:
            with open(blob_path, "wb") as f:
                f.write(bytes(flipped))
            try:
                load_program(str(ka22), store_c, device=dev)
                raise AssertionError("a flipped plane byte loaded")
            except ArtifactError as e:
                flip_msg = str(e)
        finally:
            with open(blob_path, "wb") as f:
                f.write(payload)
        bad = store_c.get_program(store_c.resolve(str(ka22)))
        bad["steps"][3]["inputs"] = ["ghost"]
        bad_ref = store_c.put_program(bad)
        try:
            load_program(bad_ref, store_c, device=dev)
            raise AssertionError("a re-digested tampered manifest loaded")
        except ArtifactError as e:
            tamper_msg = str(e)
            if "step-dangling-input" not in tamper_msg:
                raise
        load_program(str(ka22), store_c, device=dev)   # restored: loads
        tc.update(flip_error=flip_msg, tamper_error=tamper_msg)
        log(f"  (c) a flipped byte in conv1's plane blob: ArtifactError "
            f"({flip_msg[:60]}…); a manifest edited and re-digested: "
            f"ArtifactError ({tamper_msg[:70]}…)")

        # (d) the profile, step by step, at batch 32 and batch 1
        x13 = torch.from_numpy(images).to(dev)
        c_served = counts()
        prof_kw = dict(warmup=3, repeats=5)
        per_step = 1 + (prof_kw["warmup"] - 1) + (prof_kw["repeats"]
                                                  * CALLS_PER_RUN)
        t0 = time.perf_counter()
        prof32 = profile_program(pb22, x13, **prof_kw)
        prof1 = profile_program(pb22, x13[:1], **prof_kw)
        prof_s = time.perf_counter() - t0
        c_prof = {k: v - c_served[k] for k, v in counts().items()}
        want_step = {"quantize_pack": {"K1": 1}, "pack_codes": {"K1": 1},
                     "conv_packed": {"K2": 1}}
        for prof in (prof32, prof1):
            for s in prof.steps:
                if (s.launches != want_step.get(s.kind, {})
                        or not (s.wall_ns > 0 and np.isfinite(s.wall_ns))):
                    raise AssertionError(f"profile step {s.name}: "
                                         f"{s.launches}, {s.wall_ns} ns")
        want_prof = {"K1": 2 * 3 * per_step, "K2": 2 * 8 * per_step,
                     "K3": 0, "K4": 0, "K4g": 0}
        if c_prof != want_prof:
            raise AssertionError(f"profiler launches {c_prof}, want "
                                 f"{want_prof}")
        # by kernel name: one call of every step, in order, in one profiler
        # window (a window per step lost its records now and then): one K1
        # per K1 step and one K2 per conv step, as the counts held above
        env13 = {pb22.input_name: x13}
        runners13 = [(st, executor.make_step_runner(pb22, st))
                     for st in pb22.steps]

        def one_pass():
            for st, fn in runners13:
                env13[st.output] = fn(pb22.params,
                                      *[env13[i] for i in st.inputs])

        by_name = cnn_kernels(profile_counts(one_pass)["launches"])
        want_name = {"K1": 0, "K2": 0}
        for st in pb22.steps:
            for k, n in want_step.get(st.kind, {}).items():
                want_name[k] += n
        if by_name != want_name:
            raise AssertionError(f"one pass of the steps: the profiler saw "
                                 f"{by_name}, want {want_name}")
        for prof, fwd_ms, b in ((prof32, record["forward_b32_ms"], 32),
                                (prof1, record["forward_b1_ms"], 1)):
            log(f"  (d) profile at batch {b} (mean per call of "
                f"{CALLS_PER_RUN} calls, best of {prof_kw['repeats']}; "
                f"CUDA events):")
            for line in format_profile(prof).splitlines():
                log(f"      {line}")
            log(f"      sum of the steps {prof.total_wall_ns / 1e6:.4f} ms "
                f"against phase 5's bucket-graph replay {fwd_ms:.4f} ms "
                f"(the sum includes each step's own launch gaps)")
        tc.update(
            profile_s=prof_s, profile_launches=c_prof,
            profile_by_name=by_name,
            profile={b: {"total_ms": p.total_wall_ns / 1e6,
                         "summary": p.summary(),
                         "steps": [{"name": s.name, "kind": s.kind,
                                    "us": s.wall_us,
                                    "pred_cycles": s.pred_cycles,
                                    "roofline_us": s.roofline_s * 1e6,
                                    "bound": s.bound,
                                    "launches": s.launches}
                                   for s in p.steps]}
                     for b, p in ((32, prof32), (1, prof1))})

        # (e) ns per virtual cycle, persisted and attached to (b)'s service
        cal32, cal1 = calibrate.fit(prof32), calibrate.fit(prof1)
        for b, cal in ((32, cal32), (1, cal1)):
            for line in calibrate.format_calibration(cal).splitlines():
                log(f"  (e) batch {b}: {line.strip()}")
        ckey = calibrate.save(reg_b.store, cal1, str(kb22))
        back = calibrate.load(ArtifactStore(store_dir), "cuda", str(kb22))
        if back != cal1 or calibrate.load(reg_b.store, "cpu",
                                          str(kb22)) is not None:
            raise AssertionError("the calibration did not round-trip")
        svc_b.set_calibration(back)
        run22 = runs_b[0]
        pred = {}
        for b in (1, 32):
            adm = svc_b.scheduler.admit(kb22, b, program=pb22)
            replay_s = []
            for _ in range(10):
                t0 = time.perf_counter()
                run22(x13[:b])
                torch.cuda.synchronize()
                replay_s.append(time.perf_counter() - t0)
            meas = statistics.median(replay_s)
            svc_b.scheduler.complete(adm, meas)
            pred[b] = {"est_cycles": adm.est_cycles,
                       "predicted_ms": adm.est_seconds * 1e3,
                       "replay_ms": meas * 1e3}
        sched_cal = svc_b.metrics()["scheduler"]["calibration"]
        svc_b.stop()
        tc.update(calibration_b32=cal32.to_payload(),
                  calibration_b1=cal1.to_payload(), calibration_key=ckey,
                  scheduler_prediction=pred, scheduler_calibration=sched_cal)
        log(f"  (e) the batch-1 fit saved under {ckey}, loaded back equal, "
            f"absent under 'cpu'; on (b)'s scheduler ({sched_cal['source']}"
            f", {sched_cal['ns_per_cycle']} ns/cycle): " + "; ".join(
                f"batch {b}: {v['est_cycles']} cycles -> predicted "
                f"{v['predicted_ms']:.4f} ms against the replay's "
                f"{v['replay_ms']:.4f} ms" for b, v in pred.items()))

        # (f) the CLI: compile twice, then profile, in subprocesses
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
        compile_cmd = serve_cmd + ["compile", "--arch", "resnet9-cifar10",
                                   "--store", cli_dir]
        t0 = time.perf_counter()
        first = subprocess.run(compile_cmd, capture_output=True, text=True,
                               env=env, timeout=300)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for cmd in (compile_cmd, serve_cmd + [
                     "profile", "--store", cli_dir, "--batch", "32"])]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            finally:
                p.kill()
        cli_s = time.perf_counter() - t0
        cli_cal = calibrate.load(ArtifactStore(cli_dir), "cuda",
                                 f"{graph.name}@W2A2")
        if (first.returncode != 0 or "(compiled)" not in first.stdout
                or procs[0].returncode != 0 or "(store hit)" not in outs[0]
                or procs[1].returncode != 0
                or "calibration persisted" not in outs[1]
                or cli_cal is None):
            raise AssertionError(
                f"CLI: {first.stdout}{first.stderr}\n{outs}")
        tc.update(cli_s=cli_s, cli_compile=[first.stdout, outs[0]],
                  cli_profile=outs[1])
        log(f"  (f) `compile` in a subprocess: {first.stdout.splitlines()[0]}"
            f"; again: {outs[0].splitlines()[0]}; `profile --store` exited 0"
            f" and persisted a calibration ({cli_cal.ns_for():.3f} ns/cycle "
            f"at batch 32); {cli_s:.1f} s for the three")
    finally:
        # the registries routed the tile tuner's decisions into store_dir
        from repro_torch.kernels import tuning
        tuning.set_persistent_store(None)
        shutil.rmtree(store_dir, ignore_errors=True)
        shutil.rmtree(cli_dir, ignore_errors=True)
    tc_launches = {k: ran13[k] + c_prof[k] for k in ("K1", "K2")}
    tc["launches"] = tc_launches
    record["toolchain"] = tc

    # ---------------------------------------------- 14. training on the card
    del ds_srv, ds_eng, ds_params, ds_reg, ds_svc
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    tr = train_phase(dev, lm_cfg, counts, reset_counts, device_profile,
                     prompts)
    record["train"] = tr

    # ------------------------- 15. the SSM and hybrid families at full width
    ssm_rec = ssm_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, check_equal=check_equal,
        profiled=profiled, is_spin=is_spin, walls=walls, timer=timer))
    record["ssm_hybrid"] = ssm_rec

    # ------------- 16. the reference's six remaining architectures, full width
    fam_rec = families_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, check_equal=check_equal,
        profiled=profiled, is_spin=is_spin, walls=walls, timer=timer))
    record["families"] = fam_rec
    fam_ran = fam_rec["launches"]

    # ---------- 17. the long-context cells of launch/dryrun.py, full width
    long_rec = longctx_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, check_equal=check_equal,
        profiled=profiled, is_spin=is_spin, walls=walls, timer=timer,
        prompts=prompts))
    record["long_context"] = long_rec
    long_ran = long_rec["launches"]

    # ------------ 18. training every family the reference trains, full width
    trf_rec = train_families_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts,
        device_profile=device_profile))
    record["train_families"] = trf_rec
    trf_ran = trf_rec["launches"]

    # ------ 19. array scaling: ResNet9 W2A2 on four banks (streams) of one card
    del trf_rec
    gc.collect()
    torch.cuda.empty_cache()
    arr_rec = array_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, check_equal=check_equal,
        profiled=profiled, is_spin=is_spin))
    record["array_scaling"] = arr_rec
    arr_ran = arr_rec["launches"]

    # ---- 20. one model's tensors on a data x model mesh (DTensor, NCCL)
    del arr_rec
    gc.collect()
    torch.cuda.empty_cache()
    mesh_rec = mesh_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, profiled=profiled,
        is_spin=is_spin, prompts=prompts, lm_tokens=lm_k3[0],
        lm_logits=lm_k3[1], ds_prompts=ds_prompts, ds_tokens=ds_short[0],
        ds_logits=ds_short[1], ssm_tokens={
            arch: ssm_rec[arch]["run1"]["tokens"]
            for arch in ("mamba2-780m", "hymba-1.5b")},
        engine_ref=engine_ref, ds_engine_ref=ds_engine_ref))
    record["mesh"] = mesh_rec
    mesh_ran = mesh_rec["launches"]

    # ------------ 21. the cost analysis (launch/hlo_analysis.py) on the card
    cost_rec = cost_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, profiled=profiled,
        is_spin=is_spin, program=prog, images=x32, smi=smi))
    record["cost"] = cost_rec
    cost_ran = cost_rec["launches"]

    # ------------- 22. the tile autotuner (kernels/tuning.py) on the card
    tune_rec = tuning_phase(dev, types.SimpleNamespace(
        counts=counts, reset_counts=reset_counts, timer=timer, program=prog,
        images=x32, smi=smi))
    record["tuning"] = tune_rec
    tune_ran, held = tune_rec["launches"], tune_rec["tiles_held"]

    def total(kid, key):
        vals = [r[key] for r in rows if r["kernel"] == kid]
        return None if any(v is None for v in vals) else sum(vals)

    def lm_bound_by(kid):
        byt, ops = lm_step(kid, "bytes", 4), lm_step(kid, "ops", 4)
        return ("bytes" if byt / HBM_BYTES_PER_S >= ops / INT8_OPS_PER_S
                else "operations")

    # ms, plain_ms, bound_ms, library_ms: the sum over one ResNet9 batch-32
    # forward (K1, K2) plus one LM decode step at batch 4 (K1, K3, K4); K1's
    # in_path_* are the profiler's, in one LM decode step and one prefill
    dec, pre = record["lm_profile_decode_step"], record["lm_profile_prefill"]
    line = {"kernels": [
        {"name": "quantize_pack (K1: ResNet9 quantize_pack + 2x pack_codes, "
                 "LM 4 per layer: one per distinct activation)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize_pack.cu",
         "replaces": "src/repro/kernels/quantize_pack.py:53",
         "launches": (cnn_ran["K1"] + ran2["K1"] + lm_k3[2]["K1"]
                      + c_tiny["K1"] + ran_load["K1"] + lm_ran["K1"]
                      + ds_launches["K1"] + tc_launches["K1"]
                      + tr["launches"]["K1"] + ssm_rec["launches"]["K1"]
                      + fam_ran["K1"] + long_ran["K1"] + trf_ran["K1"]
                      + arr_ran["K1"] + mesh_ran["K1"] + cost_ran["K1"]
                      + tune_ran["K1"]),
         "engine_launches_per_captured_step": rec["step_launches"]["K1"],
         "max_abs_err": max_err["K1"],
         "ms": total("K1", "ms") + lm_step("K1", "ms", 4),
         "plain_ms": total("K1", "plain_ms") + lm_step("K1", "plain_ms", 4),
         "bound_ms": total("K1", "bound_ms") + lm_step("K1", "bound_ms", 4),
         "bound_by": "bytes", "library_ms": None,
         "in_path_ms_decode_step": dec["K1_ms"],
         "in_path_launches_decode_step": dec["K1_launches"],
         "in_path_ms_prefill": pre["K1_ms"],
         "in_path_launches_prefill": pre["K1_launches"]},
        {"name": "bitserial_conv2d (K2: ResNet9 conv1..conv8)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_conv.cu",
         "replaces": "src/repro/kernels/bitserial_conv.py:153",
         "launches": (cnn_ran["K2"] + ran2["K2"] + c_tiny["K2"]
                      + tc_launches["K2"] + arr_ran["K2"] + cost_ran["K2"]
                      + tune_ran["K2"]),
         "tiles_held": held["K2"],
         "max_abs_err": max_err["K2"],
         "ms": total("K2", "ms"), "plain_ms": total("K2", "plain_ms"),
         "bound_ms": total("K2", "bound_ms"), "bound_by": "operations",
         "library_ms": total("K2", "library_ms")},
        {"name": "bitserial_matmul_v2 (K3: one LM decode step's packed GEMMs)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
         "replaces": "src/repro/kernels/bitserial_matmul.py:380",
         "launches": (lm_k3[2]["K3"] + c_tiny["K3"] + ran_load["K3"]
                      + lm_ran["K3"] + ds_launches["K3"]
                      + tr["launches"]["K3"] + ssm_rec["launches"]["K3"]
                      + fam_ran["K3"] + long_ran["K3"] + trf_ran["K3"]
                      + arr_ran["K3"] + mesh_ran["K3"] + cost_ran["K3"]
                      + tune_ran["K3"]),
         "tiles_held": held["K3"],
         "engine_launches_per_captured_step": rec["step_launches"]["K3"],
         "max_abs_err": max_err["K3"],
         "ms": lm_step("K3", "ms", 4), "plain_ms": lm_step("K3", "plain_ms", 4),
         "bound_ms": lm_step("K3", "bound_ms", 4), "bound_by": lm_bound_by("K3"),
         "library_ms": lm_step("K3", "library_ms", 4)},
        {"name": "bitserial_matmul (K4: one LM decode step's code GEMMs)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
         "replaces": "src/repro/kernels/bitserial_matmul.py:171",
         "launches": (lm_k4[2]["K4"] + k4_run + ssm_rec["launches"]["K4"]
                      + fam_ran["K4"] + long_ran["K4"] + mesh_ran["K4"]),
         "tiles_held": held["K4"],
         "engine_launches_per_captured_step": k4_step["K4"],
         "max_abs_err": max_err["K4"],
         "ms": lm_step("K4", "ms", 4), "plain_ms": lm_step("K4", "plain_ms", 4),
         "bound_ms": lm_step("K4", "bound_ms", 4), "bound_by": lm_bound_by("K4"),
         "library_ms": lm_step("K4", "library_ms", 4)},
        {"name": "bitserial_matmul_v1_grouped (grouped K4: one "
                 "deepseek-v2-lite decode step's routed experts, 3 per MoE "
                 "layer, all 64 experts in one launch)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
         "replaces": "src/repro/models/moe.py:75 (_expert_matmul, XLA "
                     "serial_matmul_packed; no Pallas kernel)",
         "launches": (ds_launches["K4g"] + fam_ran["K4g"] + long_ran["K4g"]
                      + arr_ran["K4g"] + mesh_ran["K4g"]),
         "engine_launches_per_captured_step": ds["step_launches"]["K4g"],
         "max_abs_err": max_err["K4g"],
         "ms": ds["grouped_step_sums"]["ms"],
         "plain_ms": ds["grouped_step_sums"]["plain_ms"],
         "bound_ms": ds["grouped_step_sums"]["bound_ms"],
         "bound_by": "bytes",
         "library_ms": ds["grouped_step_sums"]["library_ms"],
         "dispatch_experts": ds["grouped_dispatch_experts"],
         "ms_at_dispatch": ds["grouped_step_sums_dispatch"]["ms"],
         "bound_ms_at_dispatch":
             ds["grouped_step_sums_dispatch"]["bound_ms"],
         "in_path_ms_decode_step":
             ds["profile_replay"]["ms_by_kernel"].get("K4g", 0.0),
         "occupied_experts_per_step": ds["occupied_experts_per_step"],
         "long_context_calls": long_rec["cells"]["deepseek_prefill_32k"][
             "grouped_calls"]},
    ]}
    record["kernels"] = line["kernels"]
    record["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"profiler windows that held no device record of their call and "
        f"were opened again: "
        f"{len(record.get('profiler_empty_windows', []))}")
    log(f"done in {record['total_s']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cards_main() -> int:
    """``python3 chip_smoke.py --cards``: phase 20 (f) alone, on every
    card of a machine with two or more (the whole script runs it too,
    after phases 1-19): the kernels built, phase 8's unsharded ``Server``
    on its four requests and phase 12's deepseek one on its four, and the
    unsharded captured engines on the mixed loads of phases 8b and 12,
    for the records (f) holds each mesh to, then
    :func:`mesh_serve_cards`. The
    record goes to ``chiprun_out/chip_smoke_cards.json``."""
    import gc
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two or more cards", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core import pipeline_modules
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_conv as k2
    from repro_torch.kernels import bitserial_matmul as km
    from repro_torch.kernels import quantize_pack as k1
    from repro_torch.launch.serve import GenRequest, Server

    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    pipeline_modules.disable_tf32()
    torch.backends.cudnn.deterministic = True
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()
    log(f"cards: {smi}")
    _build.build_all([k1.KERNEL, k2.KERNEL, km.KERNEL, km.GROUPED])
    cfg = get_arch("stablelm-1.6b").full
    lm = Server(cfg, batch_slots=4, max_len=LM_MAX_LEN, seed=0)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in LM_PROMPTS]
    res = lm.generate([GenRequest(p.copy(), LM_NEW) for p in prompts])
    hp = types.SimpleNamespace(prompts=prompts,
                               lm_tokens=[r.out_tokens for r in res],
                               lm_logits=lm.last_logits.clone())
    del lm, res
    gc.collect()
    torch.cuda.empty_cache()
    # phase 12's unsharded deepseek Server, over DS_PLAIN_NEW new tokens
    ds_cfg = get_arch("deepseek-v2-lite-16b").full
    hp.ds_tokens, hp.ds_logits = moe_reference(
        None, ds_cfg, moe_prompts(ds_cfg), DS_PLAIN_NEW)
    gc.collect()
    # the unsharded captured engines on phase 8b's and 12's mixed loads:
    # what (f)'s engines on the meshes are held to
    dev = torch.device("cuda", 0)
    for attr, c in (("engine_ref", cfg), ("ds_engine_ref", ds_cfg)):
        load = mixed_load(ENGINE_LOAD, c.vocab_size)
        eng, rec = engine_on(c, load, dev, reps=0, eager_reps=0)
        setattr(hp, attr, {"load": load, "tokens": rec["tokens"],
                           "step": rec["step_launches"]})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    record = {"cards": smi,
              "f": mesh_serve_cards(torch.cuda.device_count(), hp),
              "total_s": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "chip_smoke_cards.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"done in {record['total_s']:.1f} s")
    print(smi[0])
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--cards"]):
        print("usage: chip_smoke.py [--cards]", file=sys.stderr)
        sys.exit(2)
    sys.exit(cards_main() if sys.argv[1:] == ["--cards"] else main())
