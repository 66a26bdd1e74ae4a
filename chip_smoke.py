#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Drives the port's main paths through the kernels written for Hopper and
checks every answer. The Elastic Node's bit-exact integer emulator on the
paper's Table-I design ``elastic-lstm`` (and on ``elastic-conv1d``), with
kernels B1 and B2:

1. build every kernel from ``src/repro_torch/csrc/`` (``nvcc``, sm_90a, one
   process per source, all at once);
2. hold B1 and B2 against their plain PyTorch versions on the card, exact
   integer equality, at the test shapes and at the serving shapes (B1
   through its wrapper and with each of its ``mma`` and ``simt`` variants
   launched directly, in Table I's formats, in 12-bit activations, which
   route to ``simt``, and with every code at the end of its format); hold B5
   against its plain version at the reference's test shapes and at every
   Yi-9B prefill shape (2e-5 in f32, 0.03 for bf16 against f32, and bf16
   also within ``BF16_REL_RMS_BAR`` of each 128-row block's rms), its
   ``sm90`` variant (wgmma, TMA) at head dims 64/80/112/128 and S around
   its 128-row tiles, and its ``simt`` variant in bf16 at the shapes
   above; show that planted faults (a stale K/V stage, a lost last key
   tile) at a Yi-9B layer of 2,048 tokens fail the block bar;
3. replay both checked-in golden vector sets in the three emulator modes;
4. serve ragged requests through ``RTLEmulator.run_many`` in ``fused`` mode,
   one design at a time (kernel launch counts are set to 0 just before each
   design's ``run_many`` and read just after it, and must equal one launch
   per node the kernel serves; B1's must all be ``mma`` for
   ``elastic-lstm`` and all ``simt`` for its 12-bit twin), each answer held
   against its solo run, the plain path and the float oracle;
5. time B1 (both variants, and ``mma`` again with zero weights, where no
   ROM gather can conflict on a bank) and B2 and their plain versions at
   the serving shape (CUDA events around CUDA-graph replays) beside B1's
   three bounds (bytes, int32 multiply-adds, elementwise work), the
   emulator's windows/s and host ms per run on a warm program (each run
   one CUDA Graph replay of the walk) beside the same walk run eagerly,
   and the device busy share of one replay and B1's part of it
   (``torch.profiler``).

The dense-LM server on full-width ``yi-9b`` (all 48 layers, seeded random
bf16 weights drawn on the card), with kernel B5 (flash attention) for
every prefill layer:

6. serve 8 requests (prompts of 16 ... 4,000 tokens, 16 new tokens each)
   through ``Server`` with ``attn_impl="flash"`` on 4 slots of 4,096
   positions; B5's and the decode kernel's launch counts are set to 0
   just before and read just after: B5 must launch 48 times per admitted
   request, all ``sm90``, and the decode kernel 48 times per decode tick,
   all ``mma``; prints tokens/s, the TTFT and latency summaries and the prefill ms at
   each length;
7. prefill the same prompts with ``attn_impl="ref"`` (plain einsum
   attention) and hold the last-position logits to the flash path's: in
   bf16 at full depth within the bound stated below, and in f32 at full
   width and 4 layers within 1e-3 relative with identical greedy tokens;
8. time B5 (the variant its wrapper launches there, and the ``simt``
   variant at 2,048 for the record), its plain version and
   ``scaled_dot_product_attention`` at Yi-9B prefill layers of 1,024, 2,048
   and 4,000 tokens, and profile one 2,048-token prefill and one 4-slot
   decode tick over 8 Yi-9B layers.

The four templates the reference reaches only through their public
wrappers, each driven through its wrapper at the widths of a model the
repo's configs give it (every launch count set to 0 just before and read
just after: that kernel must have launched and no other), held against its
plain version there and at the reference test's shapes within the
reference test's bar, then timed beside its bound, its plain version and,
where one exists, the PyTorch call that computes the same function:

9. B3, the float LSTM window, at ``elastic-lstm`` over 65,536 windows
   (1e-5; yardstick cuDNN's LSTM): the wrapper must route it to the
   ``mma`` variant (split TF32 on ``mma.sync``); ``mma`` and ``simt`` are
   also launched directly there and at the reference's test shapes (and at
   the widest ``mma`` cell with x × 30 against the f64 plain version,
   2e-5; and with one window's x holding an Inf and a NaN, whose row of h
   must be NaN), ``mma``'s MUFU activations are swept against the accurate
   ones (1e-6), both variants are timed, and the SASS of ``mma``'s step
   loop is counted per (window, step, unit);
10. B4, the int8 matmul, at Yi-9B's MLP, 4096 <-> 11008, with weights
    quantized on the card by ``quantize_params_int8`` (stored K-major)
    and 2,048 or 4 rows of bf16 activations: the wrapper must route the
    prefills to the ``sm90`` variant and the decode ticks to ``gemv``;
    both are also launched directly there and at the reference's test
    shapes (on the zero-padded K-major copy the wrapper makes where K %
    16 != 0), all bit for bit; each variant, the whole wrapper call (also
    on row-major codes, which it copies K-major first), the plain version
    and the yardstick ``torch._int_mm`` plus the same epilogue (on K-major
    and row-major codes) are timed, reading one of three copies of the
    weights in turn so each call finds them outside L2, and gemv against
    sm90 at 8 to 64 rows;
11. B6, the Mamba-2 SSD scan, at Zamba2-7B's 112 heads of P = N = 64 over
    4,096 steps, chunks 128 and 256, with and without h0 (1e-4 on y and
    the state, against the per-step oracle and ``ssd_chunked`` in f64),
    and at the decay extremes A = -20 and -1e-4 over 256 steps (against
    both in f64); its three passes timed
    one by one (``torch.profiler``) beside the blocks each launches, the
    scratch, and its bound both in f32 FMAs and in split TF32;
12. B7, the RWKV-6 WKV recurrence, at RWKV6-7B's 64 heads of N = 64 over
    4,096 steps, with and without h0 (1e-4, per-step oracle and
    ``wkv6_chunked`` in f64), and at the decay extremes w_log = -30 and
    -1e-4 (both in f64); its passes as for B6;

The Elastic Node's toolchain and verification half on both canonical
designs, through the entry points a user calls, on the card:

13. static analysis (no error diagnostic; each report's SHA-256), the
    cost model (Table I: 5,237 cycles), emission (``manifest.json`` equal
    to the checked-in golden manifest byte for byte, every artifact
    written to a temporary directory and its SHA-256 printed), then
    ``run_conformance(..., device="cuda")`` over the golden set plus
    65,536 seeded windows in the three emulator modes and the float
    oracle: modes bit-exact, oracle 0 LSB, golden match, host ms per mode
    read from the ``verify.*`` spans, and B1/B2 launches by variant
    counted around the call (set to 0 just before, read just after); one
    more such call under ``torch.profiler`` (device busy, B1, B2, copies);
    every traced edge of those windows inside the static intervals;
    ``fuzz_template`` for every registered kind at four seeds; and
    ``canary_check`` on a deployment holding a CUDA ``RTLEmulator``;

The paper's loop, closed on the card (Stage-1 QAT training, the target
registry, ``RTLTarget``, ``Creator``, ``Workflow``):

14. ``Workflow.run`` of ``repro_torch.launch.elastic_workflow`` for both
    canonical designs on the card on the RTL target (``build_workflow(...,
    target="rtl")``), with the example's settings (120 AdamW
    steps of batch 256 an iteration, knobs from Q4.2, 4 iterations,
    ``verify=True``, ``analyze="error"``) under a requirement no design
    meets, so the widening runs Q4 -> Q8 -> Q12 -> Q16 and the 12- and
    16-bit designs send B1 to ``simt``: every iteration prints its
    formats, losses, cycles, estimated and measured latency, conformance,
    B1 (by variant) and B2 launches in stage 3 and in verify, and host ms
    per stage from the spans; it fails if a Stage-1 parameter or batch is
    not on the card, an iteration's conformance fails, stage 3 launches no
    B1 (``elastic-lstm``) or no B2, or ``elastic-lstm``'s run leaves a B1
    variant unlaunched. Then 20 float and 10 QAT training steps on the card
    and on the CPU from one init (float params within 1e-5; QAT's
    difference and its lowered integer weights that differ printed), and
    one QAT step at batch 256 and 65,536 timed (host clock around a
    synchronised step) and profiled (device busy, device activities);

The host target (``TorchTarget``, the reference's ``"xla"``: the step's
torch program counted by ``energy/cost.py`` on ``meta``, reported through
the roofline and the 8-channel meter, timed on the card):

15. run in two parts. While phase 6's Yi-9B weights are on the card (after
    phase 7): ``Creator().translate(..., target="xla")`` of a 2,048-token
    prefill (B5) and of a decode tick of 4 slots over 4,096 positions,
    half filled; each step is counted again on the card's tensors and the
    counts must equal the ``meta`` ones op for op; one deployed call must
    launch B5 ``sm90`` 48 times (the prefill) or not at all (the decode);
    then ``measure`` (2 warmup, 20 synchronised runs) prints the roofline
    row, p50/p99, the whole-step share of peak (``model_flops / (989e12 x
    p50)``) and the peak device memory beside the counted bytes, and one
    more call under ``torch.profiler`` its device busy time. After
    phase 14: ``python -m repro_torch.launch.elastic_workflow --verify``
    (the host target, the example's settings) for both designs, each
    iteration's host deployment counted, timed on the card and verified,
    the final RTL translate's conformance passing, B1/B2 counted around
    the run;
16. the accelerator farm: ``python -m repro_torch.serving.loadgen --arch
    lstm,conv1d --requests 4096 --wave 128 --replicas 2 --warm`` in
    process (``loadgen.run``), both designs at two window lengths each,
    two replicas each, every dispatch a CUDA Graph replay of a replica's
    program: no request failed, ``admitted == done + expired``, B1 (by
    variant) and B2 launched once a dispatch for each node they serve
    (counted against the members' dispatch counts), 64 sampled answers
    equal to per-request ``jnp`` runs bit for bit; windows/s and p50/p99;
17. multi-design emulation: K = 8 isomorphic candidates of each canonical
    design (``canonical_graph(arch, seed=k)``) at 65,536 windows through
    ``MultiDesignEmulator``, one CUDA Graph of the 8 ``fused`` walks:
    equal to ``run_int_sequential`` and to every design's ``jnp`` walk,
    one replay launching B1 and B2 8 times per node; the replay timed
    against 8 sequential runs on warm programs; captures and the shared
    LRU's stats; ``run_conformance_batch`` passing every design;

The resilience layer (``repro_torch.resilience``: SEU bit-flips in the
emulator's memories, guarded deployments, chaos scenarios), on the card:

18. (a) an SEU sweep of ``elastic-lstm`` (B1 ``mma``), its 12-bit twin (B1
    ``simt``) and ``elastic-conv1d``: every entry of ``memories()``, bits
    0/7/15/30/31 of a seeded word, then 65,536 windows: ``fused`` (a
    capture, then a replay) = the card's ``jnp`` walk = a CPU emulator
    flipped the same way on the first 1,024 windows, 0 mismatches; B1
    launches ``simt`` while a flipped W is outside ``w_fmt`` and ``mma``
    again once the second flip restores it, whose answer is the unflipped
    one; a clean ``torch.cuda.synchronize()`` at the end (no trap); the
    host ms of the run that builds after a flip beside a warm replay.
    (b) the acceptance scenario (``examples/chaos_plan.json``, 24
    requests, seed 7, the reference test's guard policy, the float-oracle
    ``"xla"`` fallback on the card): detected, recovered, 0 corrupted
    after detection, 0 lost, one breaker trip, every later answer the
    fallback's and correct; its ``to_json()`` equal to the same scenario
    on the CPU; B1/B2 launches; host ms of a bare call, a guarded call, a
    canary probe and the first guarded call after a flip. (c) a guarded
    farm of both designs, two replicas each with a canary, 1,024 requests
    in waves of 128: the busier ``elastic-lstm`` replica is flipped
    mid-pass, its canary quarantines it, the router sends it nothing
    after, no request fails, ``admitted == done + expired``, and 64
    answers after the detection equal per-request ``jnp`` runs;
LM training (the LM loss, the train step through B5 with its gradient,
checkpoints, the fault-tolerant ``Trainer`` and ``launch/train.py``):

19. (a) B5's gradient at a StableLM-3B layer (4, 2,048, 32, 80) and a
    Yi-9B layer (1, 2,048, 32, 128; K/V GQA-repeated), bf16, causal: dq,
    dk, dv through ``flash_attention`` equal those through
    ``attention_ref`` bit for bit (its backward is the plain VJP), the
    forward launched on ``sm90``; forward + backward timed beside the
    plain version and ``scaled_dot_product_attention``. (b) StableLM-3B at
    full width and depth (2,795,443,200 parameters, f32 master params,
    bf16 compute, ``attn_impl="flash"``, seq 2,048, batch 4): the first
    step's loss and gradient norm from one set of params against
    ``attn_impl="ref"`` (within sqrt(32) x 2^-7, phase 7's bar), and in
    f32 at full width and 4 layers (loss within 1e-5, every gradient leaf
    within 1e-3 relative rms); then ``Trainer`` for 8 steps with every
    launch count set to 0 just before and read just after: B5 ``sm90``
    2 x 32 x 8 = 512 times (a forward and a remat recompute a layer a
    step) and no other kernel; per step the loss, gnorm, lr and host ms;
    tokens/s, the peak device memory, the whole-step share of peak (6 N D
    / (989e12 x median step)); one more step under ``torch.profiler``
    (device busy, B5, the GEMMs, the attention VJP). Then phase 15's
    third cell: the host target's report of the train step at full width
    and 4 layers (counts on the card equal to ``meta``'s op for op, B5
    launched 8 times a call, ``measure``). (c) the reference's recovery
    scenario on the card (``yi-9b`` smoke, failures at steps 13 and 21:
    2 recoveries, logged losses equal to a clean run's within 1e-4),
    ``resume_elastic``, and a bf16 training state written on the card and
    on the CPU restored onto the card bit for bit. (d)
    ``launch.train.main(["--arch", "yi-9b", "--steps", "40", "--device",
    "cuda", ...])`` in process: exit 0, the loss falls;
The LM families (the MoE FFN, the vision and audio frontends, the
encoder-decoder), B5 on every causal prefill layer:

20. (a) DeepSeek-MoE-16B at full width and depth (16,375,728,128
    parameters, random bf16 weights drawn on the card, the router f32;
    the MoE FFN the reference's one-device dense oracle) serves phase 6's
    8 requests through ``Server`` with ``attn_impl="flash"`` on 4 slots
    of 4,096 positions, every launch count set to 0 just before and read
    just after: every request served, B5 28 times a request (224), all
    ``sm90``, no other kernel; tokens/s, TTFT, ms a prefill and a decode
    tick, peak device memory; flash vs plain attention on the 2,048-token
    prefill in bf16 within phase 7's bar (sqrt(28) x 2^-7) and the served
    first token the flash prefill's; in f32 at full width and 4 layers on
    all 8 prompts within 1e-3 with identical greedy tokens; one prefill
    and one decode tick profiled, device ms split into routed experts,
    shared experts, router/top-k/combine, B5 and the rest. (b)
    Qwen3-MoE-30B-A3B at full width and 8 of its 48 layers: a 2,048-token
    prefill of 2 sequences and 16 decode steps, bf16 flash vs plain
    within sqrt(8) x 2^-7 (B5 8 ``sm90`` a prefill), f32 flash vs plain on
    the card within 1e-3 with identical greedy tokens; ms a prefill and a
    decode step. (c) InternVL2-1B (256 patch embeddings + 1,792 tokens)
    and whisper-tiny (1,500 frames through the 4-layer encoder, a 64-token
    decoder prefill) at their published sizes, 16 decode steps each
    (whisper's through the cached cross K/V): bf16 flash vs plain within
    the bar (B5 24 and 4 a prefill, the encoder none), f32 on the card
    (B5) against the CPU within 1e-4 with identical greedy tokens. In
    bf16 the greedy tokens' agreement is printed, not required: the two
    attentions round the softmax weights at different points (phase 7);
The hybrid and RWKV families, B6 and B7 on every prefill layer:

21. Zamba2-7B (81 Mamba-2 layers and a shared attention block after every
    6th, 6,981,758,032 parameters) and then RWKV6-7B (32 layers,
    7,577,026,560 parameters), each at full width and depth with random
    bf16 weights drawn on the card, serve phase 6's 8 requests through
    ``Server`` with ``attn_impl="flash"`` on 4 slots of 4,096 positions,
    every launch count set to 0 just before and read just after: every
    request served; Zamba2 launches B6 81 times a request (648) and B5
    ``sm90`` 13 times (104), RWKV6 B7 32 times a request (256), and no
    other kernel; tokens/s, TTFT, ms a prefill (2,048 and 4,000 tokens)
    and a decode tick, peak device memory. The 2,048-token prefill's
    last-position logits in bf16 against the same prefill with the scan
    seams on the chunked forms (``ssd_chunked``, ``wkv6_chunked``) and
    ``attn_impl="ref"``, within phase 7's bar sqrt(L) x 2^-7 (RWKV6-7B's
    miss, ROADMAP §C8, is printed, not raised), and both read against the
    f32 run of the same weights; the served first token is the kernel
    run's. In f32 at full width and 4 layers (Zamba2 6, so that its first
    shared block runs), all 8 prompts with 2 decode steps: the kernel path
    against the chunked path on the card within 1e-4 of the largest logit
    and the card against the CPU within 1e-4 (max abs, as phase 20), with
    identical greedy tokens; a card-vs-CPU miss stands as the CPU's f32
    drift (ROADMAP §C11) only where a float64 run on the card lies no
    farther from the card than from the CPU. One prefill and one decode tick
    profiled per model: device ms split into the scan kernel, B5, the
    GEMMs and the rest. Then B2 timed again as in phase 5;
Scan-over-layers (``ParallelismConfig.scan_layers``: each group's stacked
layers as one scan, the serving cache stacked by group) and ROADMAP §C10:

22. Yi-9B, Zamba2-7B and RWKV6-7B, each at full width and depth with
    random bf16 weights drawn on the card: one 2,048-token prefill through
    ``make_prefill_step`` (``attn_impl="flash"``) and 16 greedy decode
    ticks on 4 slots of 4,096 positions, once unrolled and once scanned
    (Zamba2 as 13 units of 6 Mamba-2 layers and the shared block, then 3
    layers), from the same weights: the logits of the prefill and of every
    tick equal bit for bit, the tokens equal; every launch count set to 0
    just before each prefill and read just after: B5 ``sm90`` 48 (Yi-9B),
    B6 81 and B5 13 (Zamba2), B7 32 (RWKV6) in both forms, and no kernel in
    the ticks; each form's prefill and tick ms, and a tick's device memory
    peak above what was allocated before it, the scanned one within 5% of
    the unrolled one (so no tick copies a layer's cache whole). Then
    ``launch.train.run(parse_args(["--arch", "stablelm-3b", "--full",
    "--seq", "2048", "--batch", "4", "--steps", "2", "--scan", ...]))``
    and the same run without ``--scan``: equal losses bit for bit, B5
    ``sm90`` 2 x 32 a step in both. Then C7's scenario (six threads
    replaying an emulator's program while another flips a W bit 40 times)
    100 times in one process with no ``torch.cuda.empty_cache()`` of the
    loop's own: every run passes, and ``memory_reserved()`` after run 100
    lies within 2 GB of its reading after run 10 (the next capture returns
    the dropped CUDA Graph pools).

The collectives on one card (a ``torch.distributed`` NCCL group of world
size 1, started and destroyed by the phase; it runs inside phase 20, on
phase 20's DeepSeek-MoE-16B weights, before they are freed):

23. (a) ``Server(mesh=)`` on the (1, 1) mesh with each of
    ``impl="psum"``, ``"a2a"`` and ``"dense"``: 4 requests of 2,048 prompt
    tokens and 16 new ones, B5 ``sm90`` 28 a request and no other kernel;
    prefill ms, median tick ms, tokens/s and the assignments the capacity
    dropped (the config's 1.25: dropping is the reference's semantics);
    (b) full width, 4 layers, f32, ``capacity_factor = n_experts /
    top_k``: ``psum`` and ``a2a`` logits within 1e-4 of the largest of
    ``dense``'s, greedy tokens identical; (c) StableLM-3B at full width
    and 8 of 32 layers (phase 19's shape, ``grad_compression=True``): 2
    ``Trainer`` steps on the mesh equal the meshless ``Stepper``'s losses
    bit for bit, ``resume_elastic`` with the mesh's shardings restores
    every leaf bit for bit, and the next step's loss equals the meshless
    resume's;

The ``"model"`` split at tp = 2 on the one card (two processes in a
gloo group; NCCL puts no two ranks on one card):

24. Yi-9B at full width and 4 of 48 layers, Zamba2-7B at full width and
    6 of 81 layers (six Mamba-2 layers and one shared-block invocation),
    and RWKV6-7B at full width and 4 of 32 layers (about 5.6 GB of f32
    weights), in f32, random weights from one seed drawn on the card:
    first with no mesh, ``Server``'s greedy tokens for 2 prompts of 256
    tokens and 8 new ones, one bf16 prefill, and one train step (2 x 512
    tokens); then the two processes pass CUDA tensors to all-reduce,
    all-gather, reduce-scatter and the functional all-reduce ``DTensor``
    uses, printing each outcome, and if the ones the split steps call
    run, each takes its 16 q heads, half of ``d_ff``, half of each
    Mamba-2 mixer's ``d_inner`` and 56 of its 112 heads, 32 of each
    RWKV-6 time-mix's 64 heads, and half of the vocabulary on the (1, 2)
    mesh: ``Server(mesh=)``'s tokens identical, the loss within 1e-5
    (relative), B5 on 16 q heads a launch (``simt`` in f32, ``sm90`` in
    the bf16 prefill), B6 on 56 heads a launch (once a Mamba-2 layer of
    each prefill) and B7 on 32 heads a launch (64 with no mesh; 8 times
    serving, 4 in the bf16 prefill, never in training), each as often as
    with no mesh; each rank's peak memory and a step's host seconds
    beside the one process's. If one of them raises, the phase names it
    and runs the split steps on a world of one instead. Then the data
    split: two processes of a gloo group on the card, each one data rank
    of the (2, 1) mesh, serve the same 2 prompts on 2 slots through
    ``Server(mesh=)`` for each arch (no train step): each rank's tokens
    identical to tp = 1's, each leaf of its pool cache 1 row (tp = 1's:
    2), and its serving B5 (by variant), B6 and B7 launches half of tp =
    1's on the same heads (each data rank prefills only its own
    request); each rank's serving peak memory and host seconds beside tp
    = 1's.

The multi-pod dry-run (``repro_torch.launch.dryrun``: a step of one rank
of the production mesh counted on ``meta`` tensors in a fake process
group; no card):

25. ``python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape
    train_4k`` and ``--arch yi-9b --shape decode_32k`` on the 16 x 16
    mesh, two subprocesses started together after phase 24 (so that
    phase 24's host seconds are taken alone) with no card visible, under
    a timeout: exit 0, each cell's report row printed with its memory and
    collective lines, FLOPs, bytes and wire bytes a device above 0. The
    row's times are modelled from the counts and the H100 SXM's peak and
    rates, not measured on the card.

The decode-attention kernel (``kernels/decode_attention``; no TPU
counterpart), which phase 6's ticks run:

26. at yi-9b.long_decode's pool (32 slots of 4,096, KV 4, G 8, hd 128,
    lengths drawn in 297-2,160), long_prompt's (16 slots, 512-4,032) and
    Zamba2-7B's shared block (4 slots, 32 kv heads, G 1, hd 112, a free
    slot past S_max): the bf16 kernel (``mma``) against the f32 plain
    version on the same inputs (0.03, and ``BF16_REL_RMS_BAR`` of each
    (row, head)'s rms), the f32 kernel (``simt``) within 2e-5, each launch
    counted on its variant; then the kernel (CUDA events around graph
    replays over three copies of the cache in turn, so the valid rows come
    from HBM), its bound (the valid K/V rows, q and o at 3.35 TB/s), its
    plain version, the path it replaced (K/V repeated to every q head,
    cast to f32, an einsum over every position) and
    ``scaled_dot_product_attention`` with ``enable_gqa`` and the length
    mask (a yardstick the port never calls); and the host time of one
    call of the kernel's wrapper and of the replaced path, not waiting for
    the card.

Then print the kernels line (B1's and B2's rows also carry the loop's
    launches, ``workflow_launches``, the farm's, ``farm_launches``, one
    multi-design replay's of each design, ``multi_launches``, and phase
    18's, ``resilience_launches``; B5's the host target's,
    ``host_target_launches`` and ``host_target_train_launches``, the
    8 training steps', ``train_launches``, and phases 20's and 21's by
    arch, ``families_launches``, and phase 23's by impl,
    ``collectives_launches``; B6's and B7's phase 21's,
    ``families_launches``; B5's, B6's and B7's one scanned prefill's by
    arch and B5's two scanned training steps', ``scan_launches``; B5's
    phase 24 runs' by arch and variant and B6's and B7's by arch, with
    the (2, 1) run's serving launches of data rank 0, ``tp_launches``;
    the decode kernel's phase 6's launches and ticks and phase 26's
    cells) and the card's name and power limit.

Usage, from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card and ``nvcc``; exits non-zero, printing no result, without them. The
last line of output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "vectors")
SEED = 0
B_SERVE = 65536                        # windows per serving batch
LSTM_REQUESTS = (1, 3, 7, 64, 255, 1024, 4096, 65536)
CONV_REQUESTS = (1, 5, 33, 1000, 8192)
# Peaks of one H100 SXM (NVIDIA's data sheet, full 700 W power limit):
# HBM3 at 3.35 TB/s; int32 multiply-add at 64 IMAD per clock per SM (half
# the FFMA rate behind the 67 TFLOP/s float32 figure: 132 SMs x 128 FFMA x
# 2 flops x 1.98 GHz), i.e. 132 x 64 x 1.98e9 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
INT32_MAC_PER_S = 132 * 64 * 1.98e9
# Any mix of int32 instructions: an SM issues at most 4 warp-instructions a
# clock (one per scheduler), 128 lanes, whichever pipes they go to (the
# integer ALU pipe takes 64 lanes a clock, IMAD on the FMA pipe 64 more),
# so no mix of int32 ops runs faster than 132 x 128 x 1.98e9 a second.
INT32_ISSUE_PER_S = 132 * 128 * 1.98e9
# The special-function unit (MUFU: ex2, rcp, ...) takes 16 lanes a clock an
# SM, a quarter of a warp-instruction.
MUFU_PER_S = 132 * 16 * 1.98e9
# B1's elementwise work per (window, step, unit): the int32 operations the
# cell's function needs (csrc/lstm_cell_int.cu's unit_update and gate
# requants), none of a kernel's own data movement: four gate
# pre-activations, each a bias add and a requant (shift, mask, parity, add,
# compare, add, min, max: 8), 36; five ROM addresses, 5; c = requant(sf*c
# + (si*tg) << align), 12; requant(c) to A, 8; h = requant(so * tanh(.)),
# 9: 70. Over INT32_ISSUE_PER_S that is a floor where each of them takes an
# instruction; a fused form (IADD3, LEA) could merge two.
B1_EW_OPS = 70
BF16_FLOP_PER_S = 989e12              # dense tensor-core peak
F32_FLOP_PER_S = 67e12                # f32 FMA on the CUDA cores, 2 flops
TF32_FLOP_PER_S = 495e12              # dense TF32 tensor-core peak
INT8_OP_PER_S = 1979e12               # dense int8 tensor-core peak
# the Yi-9B serving run
PROMPT_LENS = (16, 17, 128, 333, 1024, 2048, 3000, 4000)
SLOTS, MAX_LEN, MAX_NEW = 4, 4096, 16
B5_F32_TOL, B5_BF16_TOL = 2e-5, 0.03   # the reference's bars for B5
# B5's sm90 variant: every head dim of the zoo up to 128, S around the
# 128-row tiles and a Yi-9B prefill length; (2, S, 3, hd), bf16
SM90_HDS = (64, 80, 112, 128)
SM90_SEQS = (1, 17, 127, 128, 129, 255, 2048)
# flash vs plain attention through the whole model, last-position logits.
# Both paths round every attention output to bf16, after rounding the
# softmax weights to bf16 at different points (before vs after the
# normalisation), so one layer's attention outputs differ by up to about
# 2^-8 relative. Summed with random signs over L pre-norm residual layers
# whose Jacobians are near identity, that gives about sqrt(L) * 2^-8
# relative at the final hidden state and so in the logits; the bound takes
# twice that: sqrt(L) * 2^-7 (0.054 at L = 48), on the relative rms
# difference.
F32_LOGIT_REL_TOL = 1e-3              # f32, full width, 4 layers (max abs)
# the wrapper-only templates B3, B4, B6, B7 at the widths of the models the
# repo's configs give them, and the reference tests' bars
# (tests/test_kernels.py:88, :35, :165-166, :147-148)
B3_WINDOWS = 65536                     # B1's serving batch of windows
B4_ROWS = (2048, 4)                    # a prefill, a 4-slot decode tick
B4_CROSS_ROWS = (8, 16, 17, 32, 64)    # around gemv's 16-row threshold
SEQ = 4096                             # B6/B7 sequence length
# Zamba2-7B's SSD (src/repro/configs/zamba2_7b.py: d_model 3584, expand 2,
# headdim 64, d_state 64, one group): 112 heads of P = 64, N = 64
SSD_H, SSD_P, SSD_N = 2 * 3584 // 64, 64, 64
# RWKV6-7B's WKV (src/repro/configs/rwkv6_7b.py: d_model 4096, head_size
# 64, chunk 128): 64 heads of N = 64
WKV_H, WKV_N, WKV_CHUNK = 4096 // 64, 64, 128
B3_TOL, B4_TOL, B6_TOL, B7_TOL = 1e-5, 1e-3, 1e-4, 1e-4
# the reference test's B3 shapes (tests/test_kernels.py:78), (B, S, d_in, H)
B3_REF_SHAPES = ((64, 6, 1, 20), (128, 6, 1, 20), (32, 12, 4, 32),
                 (200, 6, 1, 20))
# B3 mma's activations against the accurate ones: points of [-30, 30]
# (a step of 5e-6) and the bar on their difference
B3_SWEEP, B3_ACT_TOL = 12_000_001, 1e-6
# B3's MUFU work per (window, step, unit): the operations the cell's
# function needs. Three sigmoids (i, f, o) and two tanh (g, c) take five
# exponentials, e_z = exp(-z) for i, f, o and exp(-2z) for g, c (MUFU.EX2
# after a multiply by log2 e). Over common denominators they take two
# reciprocals (MUFU.RCP), not five:
#   c' = sig(f) c + sig(i) tanh(g)
#      = [c (1 + e_i)(1 + e_g) + (1 - e_g)(1 + e_f)]
#        / [(1 + e_f)(1 + e_i)(1 + e_g)],
#   h  = sig(o) tanh(c') = (1 - e_c) / [(1 + e_o)(1 + e_c)],
# with each exponent clamped to 2^42 so that the product of three
# denominators stays finite (the clamp moves a gate by under 2^-41). That
# is 7. Both kernels issue 10, one reciprocal an activation; phase 9
# prints the count in mma's SASS beside this one. An exponential computed
# on the FMA pipe instead would trade MUFU work for issue slots, which
# this bound does not count.
B3_MUFU_OPS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got, want) -> int:
    """Exact check: raises on any mismatch; returns the max |error| (0)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"kernel != plain version, max |err| {err}")
    return err


def kernel_name(mangled: str) -> str:
    """A kernel's name without its parameters, demangled by ``c++filt``
    where the host has it."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except OSError:
        return mangled[:60]
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ") or mangled[:60]


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: CUDA events around replays of a CUDA
    graph holding ``reps`` calls (no host launch gaps), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # warm the allocator's pool
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def events_ms(fn, reps: int = 1, warm: bool = True) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` eager calls
    (after a warm-up call, if ``warm``). For a call that does not go into a
    CUDA graph (cuDNN's LSTM) or that is thousands of small launches (the
    per-step plain versions of B6 and B7), so its host launch gaps count."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def drive(ops_by_name: dict, name: str, fn):
    """Run ``fn`` (one kernel's entry-point calls) with every kernel's
    launch count set to 0 just before and read just after: the named
    kernel must have launched and no other; returns (fn(), its count)."""
    import torch

    for mod in ops_by_name.values():
        mod.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {key: mod.launches for key, mod in ops_by_name.items()}
    if counts[name] <= 0 or any(n for key, n in counts.items()
                                if key != name):
        raise AssertionError(f"{name}: launches {counts}")
    return out, counts[name]


def sass_iteration(lib_path, function_key: str, anchor: str = "IMMA",
                   loop: bool = False):
    """Opcode counts of one loop iteration of a compiled kernel, in the
    function whose mangled name holds ``function_key`` (``cuobjdump
    -sass``, beside ``nvcc``): the instructions from one ``anchor`` to the
    next (an unrolled loop with one ``anchor`` an iteration) or, with
    ``loop``, the body of the innermost loop (a backward branch's range)
    that holds an ``anchor``; None where the tool, the function or the
    loop is missing."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for func in sass.split("Function : ")[1:]:
        if function_key not in func.splitlines()[0]:
            continue
        code = [(int(addr, 16), op, rest) for addr, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
            r"([^;]*);", func)]
        ops = [op for _, op, _ in code]
        if not loop:
            marks = [i for i, op in enumerate(ops) if op == anchor]
            if len(marks) >= 2:
                return collections.Counter(ops[marks[0]:marks[1]])
            continue
        bodies = []
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in code
                        if int(target.group(1), 16) <= a <= addr]
                if anchor in body:
                    bodies.append(body)
        if bodies:
            return collections.Counter(min(bodies, key=len))
    return None


def host_ms(fn, reps: int = 10) -> float:
    """Host ms of one synchronised ``fn()``, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_ms(fn):
    """One ``fn()`` under ``torch.profiler``: host-clock ms of the run
    (profiler on), and the device time of each GPU activity (kernels,
    copies) by name, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return wall * 1e3, device


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = INT32_MAC_PER_S):
    """Least time on the card: bytes over HBM rate vs operations over their
    peak rate (default: int32 MACs over the IMAD rate), whichever is
    larger, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rand_codes(rng, fmt, shape):
    import torch

    return torch.as_tensor(rng.integers(fmt.lo, fmt.hi + 1, shape),
                           dtype=torch.int32, device="cuda")


def randn(gen, *shape, scale: float = 1.0):
    import torch

    return torch.randn(shape, generator=gen, device="cuda") * scale


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def card_name_and_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def sha256(data) -> str:
    import hashlib

    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha256(data).hexdigest()


def phase_toolchain(ops_by_name: dict, card: str) -> None:
    """Phase 13: analysis, cost model, emission, conformance with the
    kernels' launches counted, analysis soundness, fuzzing and the canary,
    on both canonical designs."""
    import tempfile
    import types

    import numpy as np
    import torch

    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.rtl.analyze import analyze_graph
    from repro_torch.rtl.emit import emit_graph, write_artifacts
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.rtl.oplib import list_templates
    from repro_torch.rtl.resources import synthesize
    from repro_torch.verify.conformance import (canary_check,
                                                fuzz_template,
                                                run_conformance)
    from repro_torch.verify.vectors import (canonical_graph, golden_dir,
                                            load_vectors)

    lstm_ops, mac_ops = ops_by_name["lstm_cell_int"], ops_by_name["mac_int"]
    rng = np.random.default_rng(SEED + 13)
    want_cycles = {"elastic-lstm": 5237, "elastic-conv1d": 156}
    for arch in ("elastic-lstm", "elastic-conv1d"):
        graph, _, _ = canonical_graph(arch)
        # -- static analysis and the cost model
        t0 = time.perf_counter()
        analysis = analyze_graph(graph)
        analysis_ms = (time.perf_counter() - t0) * 1e3
        if analysis.errors:
            raise AssertionError(f"{arch}: analysis errors\n"
                                 + analysis.format())
        syn = synthesize(graph)
        if syn.resources["cycles"] != want_cycles[arch] or not syn.fits:
            raise AssertionError(f"{arch}: cost model {syn.resources}")
        log(f"phase 13 {arch} analysis: {analysis.summary()}, "
            f"{len(analysis.warnings)} warnings, {analysis_ms:.2f} ms host "
            f"({card}); report sha256 {sha256(analysis.to_json())}; "
            f"cost model {syn.resources['cycles']} cycles, "
            f"{syn.est_latency_s * 1e6:.2f} us at 100 MHz, dsp "
            f"{syn.resources['dsp']}, bram36 {syn.resources['bram36']}, "
            f"lut {syn.resources['lut']}")
        # -- emission
        arts = emit_graph(graph)
        golden = os.path.join(ROOT, "tests", "golden",
                              arch.replace("-", "_") + "_manifest.json")
        with open(golden) as f:
            if arts["manifest.json"] != f.read():
                raise AssertionError(f"{arch}: manifest.json != {golden}")
        with tempfile.TemporaryDirectory() as tmp:
            write_artifacts(arts, tmp)
            for name in sorted(arts):
                with open(os.path.join(tmp, name), "rb") as f:
                    log(f"phase 13 {arch} artifact {name} "
                        f"{sha256(f.read())}")
        # -- conformance: golden set + 65,536 seeded windows on the card
        vs = load_vectors(golden_dir(GOLDEN, arch))
        e = graph.edges[graph.inputs[0]]
        extra = rng.integers(e.fmt.lo, e.fmt.hi + 1,
                             (B_SERVE, *e.shape)).astype(np.int32)
        cells = [n for n in graph.nodes if n.op == "lstm_cell"]
        n_mac = sum(n.op in ("linear", "conv1d") for n in graph.nodes)
        # fused: B1 once a cell, B2 once a linear/conv1d node; pallas: B2
        # once a step of each cell and once a linear/conv1d node
        want = {"lstm_cell_int": len(cells),
                "mac_int": 2 * n_mac + sum(n.seq_len for n in cells)}
        want_routes = {"mma": len(cells), "simt": 0}
        # a warm-up over the golden set alone, so the timed run below pays
        # no first-call costs
        run_conformance(graph, vs, device="cuda")
        trc = Tracer()
        for mod in ops_by_name.values():
            mod.launches = 0
        lstm_ops.launches_by_variant = dict.fromkeys(
            lstm_ops.launches_by_variant, 0)
        prev = set_tracer(trc)
        try:
            rep = run_conformance(graph, vs, extra_stimulus=extra,
                                  device="cuda")
            torch.cuda.synchronize()
        finally:
            set_tracer(prev)
        counts = {key: mod.launches for key, mod in ops_by_name.items()}
        launched = {k: n for k, n in counts.items() if n}
        if launched != {k: n for k, n in want.items() if n} or \
                lstm_ops.launches_by_variant != want_routes:
            raise AssertionError(
                f"{arch} conformance: launches {counts}, B1 by variant "
                f"{lstm_ops.launches_by_variant}; expected {want}, "
                f"{want_routes}")
        if not (rep.passed and rep.modes_bit_exact
                and rep.oracle_max_lsb == 0 and rep.golden_match is True
                and rep.n_vectors == vs.n_vectors + B_SERVE):
            raise AssertionError(f"{arch} conformance:\n{rep.to_json()}")
        spans = {s.attrs["mode"]: s.duration * 1e3
                 for s in find_spans(trc.spans, "verify.mode")}
        for name in ("verify.oracle", "verify.golden_replay",
                     "verify.conformance"):
            (s,) = find_spans(trc.spans, name)
            spans[name.split(".")[1]] = s.duration * 1e3
        log(f"phase 13 {arch} conformance: {rep.summary()}; launches "
            f"{json.dumps(launched)}, B1 by variant "
            f"{json.dumps(lstm_ops.launches_by_variant)}; host ms from the "
            f"spans at {rep.n_vectors} windows ({card}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
        # -- where one such call spends its time on the card
        wall, device = profile_ms(functools.partial(
            run_conformance, graph, vs, extra_stimulus=extra,
            device="cuda"))
        busy = sum(device.values())
        if busy == 0:
            log(f"phase 13 {arch} profile: device time not measured (the "
                "profiler saw no GPU activity)")
        else:
            b1 = sum(ms for name, ms in device.items() if "lstm_" in name)
            b2 = sum(ms for name, ms in device.items()
                     if "mac_int_kernel" in name)
            copies = sum(ms for name, ms in device.items()
                         if "Memcpy" in name)
            log(f"phase 13 {arch} profile, one conformance call: device "
                f"busy {busy:.4f} ms = "
                f"{100 * busy / spans['conformance']:.1f}% of the "
                f"unprofiled call's {spans['conformance']:.3f} ms "
                f"({wall:.3f} ms with the profiler on); B1 {b1:.4f} ms, B2 "
                f"{b2:.4f} ms, copies {copies:.4f} ms ({card})")
        # -- analysis soundness over the same windows, every mode
        stim = np.concatenate([vs.stimulus, extra])
        for mode in RTLEmulator.MODES:
            trace = RTLEmulator(graph, mode=mode, device="cuda") \
                .run_int(stim).trace
            for edge, (lo, hi) in analysis.intervals.items():
                v_lo, v_hi = int(trace[edge].min()), int(trace[edge].max())
                if not lo <= v_lo <= v_hi <= hi:
                    raise AssertionError(
                        f"{arch} {mode}: edge {edge} observed [{v_lo}, "
                        f"{v_hi}] escapes the static [{lo}, {hi}]")
        log(f"phase 13 {arch} analysis sound: every edge of "
            f"{stim.shape[0]} windows in all three modes inside "
            + ", ".join(f"{k} {list(v)}"
                        for k, v in sorted(analysis.intervals.items())))
        # -- the canary on a live CUDA deployment
        dep = types.SimpleNamespace(emulator=RTLEmulator(graph,
                                                         device="cuda"))
        canary = canary_check(dep, vs, n=vs.n_vectors)
        if not canary.passed:
            raise AssertionError(f"{arch} canary: {canary.to_dict()}")
        log(f"phase 13 {arch} canary: {json.dumps(canary.to_dict())}")
    # -- every registered kind, fuzzed on the card
    fuzzed = []
    t0 = time.perf_counter()
    for kind in list_templates():
        for seed in range(4):
            rep = fuzz_template(kind, seed=seed, device="cuda")
            if rep is None:
                if kind != "act_lut":
                    raise AssertionError(f"fuzz {kind}: no probe graph")
                continue
            if not rep.passed:
                raise AssertionError(f"fuzz {kind} seed {seed}:\n"
                                     + rep.to_json())
            fuzzed.append(f"{kind}/{seed}")
    log(f"phase 13 fuzz_template on the card: {len(fuzzed)} reports pass "
        f"({', '.join(fuzzed)}; act_lut has no standalone compute) in "
        f"{time.perf_counter() - t0:.2f} s host ({card})")


def phase_b3(ops_by_name: dict) -> dict:
    """B3, the float LSTM window, at ``elastic-lstm`` (Table I: H = 20,
    S = 6, d_in = 1) over 65,536 windows, and at the reference test's
    shapes. The wrapper must route Table I to ``mma``; both variants are
    also launched directly there, ``mma``'s MUFU activations are swept
    against the accurate ones, and both variants are timed beside the
    plain version and cuDNN's LSTM."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.lstm_cell import (lstm_window, lstm_window_cuda,
                                               lstm_window_ref)
    from repro_torch.kernels.lstm_cell import ops as lstm_f_ops
    from repro_torch.kernels.lstm_cell.kernel import activation_sweep

    c = get_config("elastic-lstm").lstm
    B, S, din, H = B3_WINDOWS, c.seq_len, c.in_features, c.hidden
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x, w, b = (randn(gen, B, S, din), randn(gen, din + H, 4 * H, scale=0.3),
               randn(gen, 4 * H, scale=0.1))
    lstm_f_ops.launches_by_variant = dict.fromkeys(
        lstm_f_ops.launches_by_variant, 0)
    got, n = drive(ops_by_name, "lstm_cell", lambda: lstm_window(x, w, b))
    by_variant = dict(lstm_f_ops.launches_by_variant)
    routed = lstm_f_ops.variant(x, w)
    if routed != "mma" or by_variant != {"mma": n, "simt": 0}:
        raise AssertionError(f"B3 at Table I routed {routed}, launches by "
                             f"variant {by_variant}: want mma only")

    def direct(args, name):
        out = torch.full((args[0].shape[0], args[1].shape[1] // 4),
                         float("nan"), device="cuda")
        lstm_window_cuda(*args, out, block_b=128, variant=name)
        return out

    # Table I, then the reference test's shapes (test_kernels.py:78)
    cases = [(x, w, b)] + [
        (randn(gen, Bt, St, dt), randn(gen, dt + Ht, 4 * Ht, scale=0.3),
         randn(gen, 4 * Ht, scale=0.1))
        for Bt, St, dt, Ht in B3_REF_SHAPES]
    errs = {"wrapper": 0.0, "mma": 0.0, "simt": 0.0}
    for k, args in enumerate(cases):
        want = lstm_window_ref(*args)
        errs["wrapper"] = max(errs["wrapper"], max_err(
            got if k == 0 else lstm_window(*args), want))
        for name in ("mma", "simt"):
            errs[name] = max(errs[name], max_err(direct(args, name), want))
    err = max(errs.values())
    if err > B3_TOL:
        raise AssertionError(f"B3 != plain version: max |err| {errs} > "
                             f"{B3_TOL}")
    # the widest mma cell with saturated gates: |z| reaches about 100,
    # where f32 rounding alone moves h by about the bar, so the f32 plain
    # version and both kernels are held to the f64 plain version
    wide = (randn(gen, 100, 6, 64, scale=30.0),
            randn(gen, 128, 256, scale=0.3), randn(gen, 256, scale=0.1))
    want64 = lstm_window_ref(*(t.double() for t in wide))
    wide_err = {name: (got64.double() - want64).abs().max().item()
                for name, got64 in (("plain f32", lstm_window_ref(*wide)),
                                    ("mma", direct(wide, "mma")),
                                    ("simt", direct(wide, "simt")))}
    if max(wide_err["mma"], wide_err["simt"]) > 2 * B3_TOL:
        raise AssertionError(f"B3 at (64, 64), x x 30, against f64: "
                             f"{wide_err} > {2 * B3_TOL}")
    # a window whose x holds an Inf, then a NaN: NaN in its row of h in
    # both variants, as in the plain version; the other rows unmoved
    bad = [t.clone() for t in cases[3]]
    bad[0][5, 1, 0], bad[0][5, 4, -1] = float("inf"), float("nan")
    want = lstm_window_ref(*bad)
    for name in ("mma", "simt"):
        got_bad = direct(bad, name)
        rest = torch.arange(len(got_bad), device="cuda") != 5
        if not (torch.isnan(got_bad[5]).all() and torch.isnan(want[5]).all()
                and max_err(got_bad[rest], want[rest]) <= B3_TOL):
            raise AssertionError(f"B3 {name}: a NaN window's row is "
                                 f"{got_bad[5].tolist()}")
    log(f"phase 9 B3 = plain version at (B, S, d_in, H) = ({B}, {S}, {din}, "
        f"{H}) and the reference's {B3_REF_SHAPES}: max |err| through the "
        f"wrapper {errs['wrapper']:.3g}, mma launched directly "
        f"{errs['mma']:.3g}, simt {errs['simt']:.3g} (bar {B3_TOL}); a "
        f"window holding an Inf and a NaN gives a NaN row in both; wrapper "
        f"launches {n}, by variant {json.dumps(by_variant)}")
    log("phase 9 B3 widest mma cell (d_in, H) = (64, 64), x x 30, against "
        "the f64 plain version: " + ", ".join(
            f"{k} {v:.3g}" for k, v in wide_err.items())
        + f" (bar for the kernels {2 * B3_TOL})")
    z = torch.linspace(-30, 30, B3_SWEEP, device="cuda")
    act = activation_sweep(z)
    sweep = {"sigmoid": max_err(act[:, 0], act[:, 1]),
             "tanh": max_err(act[:, 2], act[:, 3])}
    if max(sweep.values()) > B3_ACT_TOL:
        raise AssertionError(f"B3 mma activations != accurate forms: "
                             f"{sweep} > {B3_ACT_TOL}")
    log(f"phase 9 B3 mma's MUFU activations against expf/IEEE reciprocal/"
        f"tanhf over {B3_SWEEP:,} points of [-30, 30]: max |diff| sigmoid "
        f"{sweep['sigmoid']:.3g}, tanh {sweep['tanh']:.3g} (bar "
        f"{B3_ACT_TOL})")

    out = torch.empty((B, H), device="cuda")
    ms = {name: time_ms(functools.partial(
        lstm_window_cuda, x, w, b, out, block_b=128, variant=name))
        for name in ("mma", "simt")}
    plain = time_ms(functools.partial(lstm_window_ref, x, w, b), reps=5)
    # the library call: cuDNN's LSTM (gate order i, f, g, o, as B3's)
    lstm = torch.nn.LSTM(din, H, batch_first=True).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w[:din].T)
        lstm.weight_hh_l0.copy_(w[din:].T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lib_err = max_err(lstm(x)[1][0][0], got)
        lib = events_ms(lambda: lstm(x), reps=20)
    # the bounds: bytes; the gate product's multiply-adds as f32 FMAs
    # (simt) or as three TF32 products (mma); the MUFU work the cell's
    # activations need (B3_MUFU_OPS)
    macs = B * S * (din + H) * 4 * H
    bounds = {
        "bytes": bound_ms(4 * (B * S * din + (din + H) * 4 * H + 4 * H
                               + B * H), 0)[0],
        "f32 FMAs": bound_ms(0, 2 * macs, F32_FLOP_PER_S)[0],
        "split TF32": bound_ms(0, 3 * 2 * macs, TF32_FLOP_PER_S)[0],
        "MUFU": bound_ms(0, B * S * H * B3_MUFU_OPS, MUFU_PER_S)[0]}
    applicable = {"mma": ("bytes", "split TF32", "MUFU"),
                  "simt": ("bytes", "f32 FMAs", "MUFU")}[routed]
    by_term = max(applicable, key=bounds.get)
    bnd = bounds[by_term]
    log(f"phase 9 B3 timing at {B} windows: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in ms.items()) + f"; plain {plain:.4f} "
        f"ms, cuDNN LSTM {lib:.4f} ms (max |cuDNN - kernel| {lib_err:.3g}); "
        "bounds " + ", ".join(f"{k} {t:.4f}" for k, t in bounds.items())
        + f" ms; routed {routed}, bound {bnd:.4f} ms ({by_term})")
    # what the compiler made of one (window, step, unit) of Table I's mma
    # instance (10 n8 tiles, 3 k8 steps, two tiles a warp): its step loop
    # holds, for each lane, 10 units of each of its 2 tiles
    ops = sass_iteration(build.library_path("lstm_cell"),
                         "lstm_mma_kernelILi10ELi3ELi2E", anchor="HMMA",
                         loop=True)
    if ops is None:
        log("phase 9 B3 mma SASS: not measured (no cuobjdump)")
    else:
        per = 10 * 2
        n_instr = sum(ops.values()) / per
        mufu = ops["MUFU"] / per
        log(f"phase 9 B3 mma<10, 3, 2> SASS: {n_instr:g} instructions a "
            f"lane per (window, step, unit), "
            f"{bound_ms(0, B * S * H * n_instr, INT32_ISSUE_PER_S)[0]:.4f} "
            f"ms to issue at 128 a clock an SM; MUFU {mufu:g} (the "
            f"function needs B3_MUFU_OPS = {B3_MUFU_OPS}): " + ", ".join(
                f"{op} {k / per:g}" for op, k in ops.most_common()))
    return {"name": "lstm_cell", "route": "cuda", "variant": routed,
            "source": "src/repro_torch/csrc/lstm_cell.cu",
            "replaces": "src/repro/kernels/lstm_cell/kernel.py:23",
            "launches": n, "max_abs_err": err, "ms": ms[routed],
            "plain_ms": plain, "bound_ms": bnd, "bound_by": "bytes"
            if by_term == "bytes" else "operations", "library_ms": lib}


def rotating(fn, *arg_lists):
    """``fn`` over the argument tuples in turn, one call each: weights that
    a call reads come back to L2 only after the others' (each copy 45 MB
    at Yi-9B's MLP, L2 50 MB), as each layer's weights do in a model."""
    it = itertools.cycle(arg_lists)
    return lambda: fn(*next(it))


def phase_b4(ops_by_name: dict) -> dict:
    """B4, the int8 matmul, at Yi-9B's MLP: up (4096 -> 11008) and down
    (11008 -> 4096) weights drawn and quantized on the card (stored
    K-major), bf16 activations of 2,048 rows (a prefill) and 4 rows (a
    decode tick). The wrapper routes the prefills to ``sm90`` and the
    ticks to ``gemv``; every variant is also launched directly."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_cuda,
                                                  quant_matmul_ref,
                                                  quantize_act)
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.quant.ptq import quantize_params_int8

    yi = get_config("yi-9b")
    D, F = yi.d_model, yi.d_ff
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    ip = quantize_params_int8({"up": randn(gen, D, F, scale=D ** -0.5),
                               "down": randn(gen, F, D, scale=F ** -0.5)})
    for proj in ("up", "down"):
        K = ip.q[proj].shape[0]
        if ip.q[proj].stride() != (1, K):
            raise AssertionError(f"B4 {proj} codes are not K-major: "
                                 f"strides {ip.q[proj].stride()}")
    cases = {(proj, m): randn(gen, m, D if proj == "up" else F)
             .to(torch.bfloat16) for m in B4_ROWS for proj in ("up", "down")}
    for key in qmm_ops.launches_by_variant:
        qmm_ops.launches_by_variant[key] = 0
    outs, n = drive(ops_by_name, "quant_matmul", lambda: {
        key: quant_matmul(x, ip.q[key[0]], ip.scale[key[0]])
        for key, x in cases.items()})
    by_variant = dict(qmm_ops.launches_by_variant)
    if by_variant != {"sm90": 2, "gemv": 2}:
        raise AssertionError(f"B4 launches by variant {by_variant}, want 2 "
                             "sm90 (2,048 rows) and 2 gemv (4 rows)")

    def variants_equal_plain(xq, xs, wq, ws, what):
        """Both variants launched directly, on the codes the wrapper hands
        them (a zero-padded K-major copy where TMA cannot read these),
        equal the plain version on the codes as given bit for bit."""
        want = quant_matmul_ref(xq, wq, xs, ws)
        cx, cw = qmm_ops.tma_codes(xq, wq)
        for name in ("sm90", "gemv"):
            out = torch.full_like(want, float("nan"))
            quant_matmul_cuda(cx, cw, xs.reshape(1), ws, out, variant=name)
            if not torch.equal(out, want):
                raise AssertionError(f"B4 {name} {what} != plain version: "
                                     f"max |err| {max_err(out, want):.3g}")
        return "copied" if cw is not wq else "as stored"

    err = 0.0
    for key, x in cases.items():
        want = quant_matmul(x, ip.q[key[0]], ip.scale[key[0]], use_ref=True)
        err = max(err, max_err(outs[key], want))
        if not torch.equal(outs[key], want):
            raise AssertionError(f"B4 {key} != plain version bit for bit: "
                                 f"max |err| {err:.3g}")
        xq, xs = quantize_act(x)
        variants_equal_plain(xq, xs, ip.q[key[0]],
                             ip.scale[key[0]].reshape(-1), key)
    held = []
    for M, K, N in ((128, 128, 128), (64, 200, 96), (256, 512, 384),
                    (32, 96, 640)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, M, K).to(dtype)
            t = quantize_params_int8({"w": randn(gen, K, N)})
            got = quant_matmul(x, t.q["w"], t.scale["w"])
            want = quant_matmul(x, t.q["w"], t.scale["w"], use_ref=True)
            err = max(err, max_err(got, want))
            xq, xs = quantize_act(x)
            codes = variants_equal_plain(xq, xs, t.q["w"],
                                         t.scale["w"].reshape(-1), (M, K, N))
        held.append(f"({M}, {K}, {N}) codes {codes}")
    if err > B4_TOL:
        raise AssertionError(f"B4 != plain version: max |err| {err:.3g}")
    log(f"phase 10 B4 = plain version bit for bit at Yi-9B's MLP "
        f"({D} <-> {F}) x {B4_ROWS} rows (launches by variant "
        f"{json.dumps(by_variant)}; sm90 and gemv each launched directly "
        f"there too), and within {err:.3g} (bar {B4_TOL}) through the "
        f"wrapper at the reference's 4 test shapes in f32 and bf16, sm90 "
        f"and gemv bit for bit there: {', '.join(held)}; launches {n}")

    # timings: each call reads one of 3 copies of the weights in turn
    copies = {proj: [ip.q[proj]] + [ip.q[proj].clone() for _ in range(2)]
              for proj in ("up", "down")}
    rows_major = {proj: [w.contiguous() for w in ws]
                  for proj, ws in copies.items()}
    rows = {}
    for (proj, M), x in cases.items():
        ws = ip.scale[proj].reshape(-1).contiguous()
        xq, xs = quantize_act(x)
        K, N = ip.q[proj].shape
        out = torch.empty((M, N), device="cuda")

        def kernel(name, w, xq=xq, xs=xs, ws=ws, out=out):
            quant_matmul_cuda(xq, w, xs.reshape(1), ws, out, variant=name)

        ms = {name: time_ms(rotating(functools.partial(kernel, name),
                                     *[(w,) for w in copies[proj]]))
              for name in ("sm90", "gemv")}
        plain = time_ms(rotating(
            functools.partial(quant_matmul_ref, xq, x_scale=xs, w_scale=ws),
            *[(w,) for w in copies[proj]]), reps=3)
        wrapper = {layout: time_ms(rotating(
            functools.partial(quant_matmul, x, w_scale=ip.scale[proj]),
            *[(w,) for w in ws_list]))
            for layout, ws_list in (("K-major", copies[proj]),
                                    ("row-major", rows_major[proj]))}
        # cuBLASLt's int8 GEMM plus the same epilogue on the codes as the
        # port stores them (K-major, the layout cuBLASLt prefers) and on a
        # row-major copy; torch._int_mm takes only M > 16
        lib = {}
        for layout, ws_list in (("column-major", copies[proj]),
                                ("row-major", rows_major[proj])):
            try:
                def library(w, xq=xq, xs=xs, ws=ws):
                    return torch._int_mm(xq, w).float() * xs * ws

                lib[layout] = time_ms(rotating(library,
                                               *[(w,) for w in ws_list]))
            except RuntimeError as exc:
                lib[layout] = None
                lib_why = str(exc).splitlines()[0][:90]
        lib_note = ", ".join(
            f"{v:.4f} ms {k}" for k, v in lib.items() if v is not None) \
            or f"none ({lib_why})"
        bnd, by = bound_ms(M * K + K * N + 4 + 4 * N + 4 * M * N,
                           2 * M * N * K, INT8_OP_PER_S)
        rows[(proj, M)] = (ms, plain, lib["column-major"], bnd, by)
        routed = qmm_ops.variant(xq, ip.q[proj])
        log(f"phase 10 B4 {proj} ({M}, {K}) @ ({K}, {N}): " + ", ".join(
            f"{name}{' (routed)' if name == routed else ''} {t:.4f} ms "
            f"({2 * M * N * K / t / 1e9:.1f} TOP/s)"
            for name, t in ms.items()) + "; wrapper call with quantize_act "
            f"{wrapper['K-major']:.4f} ms (on row-major codes, copied K-major "
            f"first: {wrapper['row-major']:.4f} ms); plain "
            f"{plain:.4f} ms; torch._int_mm + epilogue {lib_note}; bound "
            f"{bnd:.4f} ms ({by})")
    # the gemv/sm90 crossing, for the 16-row threshold
    cross = []
    for M in B4_CROSS_ROWS:
        for proj in ("up", "down"):
            K, N = ip.q[proj].shape
            xq, xs = quantize_act(randn(gen, M, K).to(torch.bfloat16))
            ws = ip.scale[proj].reshape(-1).contiguous()
            out = torch.empty((M, N), device="cuda")
            t = {name: time_ms(rotating(
                lambda w, name=name, xq=xq, xs=xs, ws=ws, out=out:
                quant_matmul_cuda(xq, w, xs.reshape(1), ws, out,
                                  variant=name),
                *[(w,) for w in copies[proj]])) for name in ("gemv", "sm90")}
            cross.append(f"{proj} M={M} gemv {t['gemv']:.4f} sm90 "
                         f"{t['sm90']:.4f}")
    log("phase 10 B4 gemv vs sm90 by rows (ms): " + "; ".join(cross))
    ms, plain, lib, bnd, by = rows[("up", B4_ROWS[0])]
    return {"name": "quant_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul/kernel.py:23",
            "launches": n, "max_abs_err": err, "ms": ms["sm90"],
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib}


def pass_times(fn, reps: int = 5) -> str:
    """Device ms of each pass of a chunk-parallel scan (B6, B7), averaged
    over ``reps`` calls of ``fn`` under ``torch.profiler``."""
    from repro_torch.kernels.mamba2.kernel import PASSES

    _, device = profile_ms(lambda: [fn() for _ in range(reps)])
    by_pass = {name: sum(t for k, t in device.items()
                         if f"{name}_kernel" in k) / reps for name in PASSES}
    if not any(by_pass.values()):
        return "not measured (the profiler saw no GPU activity)"
    return ", ".join(f"{name} {t:.4f} ms" for name, t in by_pass.items())


def held_to(got, wants: dict) -> dict:
    """max |got - want| over (y, state), for each named want."""
    return {name: max(max_err(g, w) for g, w in zip(got, want))
            for name, want in wants.items()}


def phase_b6(ops_by_name: dict) -> dict:
    """B6, the Mamba-2 SSD chunk scan, at Zamba2-7B's widths over 4,096
    steps, chunks 128 and 256, with and without h0 (against the per-step
    plain version, and ``ssd_chunked`` in f64: in f32 its running sums
    drift, as the kernel's note says); at the decay extremes A = -20 and
    -1e-4 over 256 steps (both in f64: the per-step f32 run drifts at the
    long memory); and at the reference test's shapes (chunk 16)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mamba2 import ssd, ssd_cuda, ssd_reference
    from repro_torch.kernels.mamba2.kernel import plan
    from repro_torch.model.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def inputs(B, S, H, P, N, A_value=None):
        """tests/test_kernels.py::test_mamba2_kernel's distributions; A_value
        sets every head's A."""
        A = -torch.exp(randn(gen, H, scale=0.3))
        return (randn(gen, B, S, H, P, scale=0.5),
                F.softplus(randn(gen, B, S, H)),
                A if A_value is None else torch.full_like(A, A_value),
                randn(gen, B, S, 1, N, scale=0.5),
                randn(gen, B, S, 1, N, scale=0.5),
                randn(gen, B, H, P, N, scale=0.1))

    x, dt, A, Bm, Cm, h0 = inputs(1, SEQ, SSD_H, SSD_P, SSD_N)
    runs = [(chunk, h) for chunk in (128, 256) for h in (None, h0)]
    outs, n = drive(ops_by_name, "ssd", lambda: [
        ssd(x, dt, A, Bm, Cm, h, chunk=chunk) for chunk, h in runs])
    refs = {id(h): ssd_reference(x, dt, A, Bm, Cm, h0=h) for h in (None, h0)}
    err = 0.0
    for (chunk, h), got in zip(runs, outs):
        f64 = [a.double() for a in (x, dt, A, Bm, Cm)]
        e = held_to(got, {"plain": refs[id(h)],
                          "ssd_chunked f64": ssd_chunked(
                              *f64, chunk, h0=None if h is None
                              else h.double())})
        err = max(err, *e.values())
        # the chunked form in f32 drifts by its own f32 running sums (the
        # precision the kernel keeps in f64): for the record, not held
        f32 = held_to(got, {"f32": ssd_chunked(x, dt, A, Bm, Cm, chunk,
                                               h0=h)})["f32"]
        log(f"phase 11 B6 (1, {SEQ}, {SSD_H}, {SSD_P}), N {SSD_N}, chunk "
            f"{chunk}, h0 {h is not None}: max |err| (y, state) plain "
            f"{e['plain']:.3g}, ssd_chunked in f64 {e['ssd_chunked f64']:.3g}"
            f" (in f32 {f32:.3g}; max |y| "
            f"{refs[id(h)][0].abs().max().item():.3g})")
    extremes = []
    for A_value in (-20.0, -1e-4):
        *args, hs = inputs(1, 256, SSD_H, SSD_P, SSD_N, A_value)
        for h in (None, hs):
            got = ssd(*args, h, chunk=128)
            f64 = [a.double() for a in args]
            h64 = None if h is None else h.double()
            truth = ssd_reference(*f64, h0=h64)
            e = held_to(got, {
                "plain f64": truth,
                "ssd_chunked f64": ssd_chunked(*f64, 128, h0=h64)})
            err = max(err, *e.values())
            # for the record, not held: the f32 yardsticks' own drift
            drift = held_to(ssd_reference(*args, h0=h), {"f64": truth})
            extremes.append(f"A {A_value:g} h0 {h is not None}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in e.items())
                + f" (plain f32 itself {drift['f64']:.3g} from f64)")
    log(f"phase 11 B6 decay extremes (1, 256, {SSD_H}, {SSD_P}), N "
        f"{SSD_N}: " + "; ".join(extremes))
    small = 0.0
    for shape in ((2, 64, 4, 16, 16), (1, 128, 2, 32, 16)):
        *args, hs = inputs(*shape)
        for h in (None, hs):
            got = ssd(*args, h, chunk=16)
            want = ssd_reference(*args, h0=h)
            small = max(small, *(max_err(g, r) for g, r in zip(got, want)))
    err = max(err, small)
    if err > B6_TOL:
        raise AssertionError(f"B6 != plain version: max |err| {err:.3g} > "
                             f"{B6_TOL}")
    log(f"phase 11 B6 = plain version and ssd_chunked within {err:.3g} (bar "
        f"{B6_TOL}; {small:.3g} at the reference's test shapes); launches "
        f"{n}")
    y = torch.empty_like(x)
    hf = torch.empty((1, SSD_H, SSD_P, SSD_N), device="cuda")
    args = (x, dt, A, Bm[:, :, 0].contiguous(), Cm[:, :, 0].contiguous())
    kernel = functools.partial(ssd_cuda, *args, None, y, hf)
    ms = time_ms(kernel, reps=5)
    ms_h0 = time_ms(functools.partial(ssd_cuda, *args, h0, y, hf), reps=5)
    passes = pass_times(kernel)
    pl = plan(1, SEQ, SSD_H, SSD_P, SSD_N)
    plain = events_ms(lambda: ssd_reference(x, dt, A, Bm, Cm), warm=False)
    S, H, P, N = SEQ, SSD_H, SSD_P, SSD_N
    # the function's least work, whatever the chunking: each step and head
    # reads the (P, N) state into y and folds x, B into it; the kernel runs
    # its products on the tensor cores in split TF32, three TF32 products
    # for each f32 one
    fma = 2 * N * P * H * S
    n_bytes = 4 * (2 * S * H * P + S * H + H + 2 * S * N + H * P * N)
    b_f32, by_f32 = bound_ms(n_bytes, 2 * fma, F32_FLOP_PER_S)
    bnd, by = bound_ms(n_bytes, 3 * 2 * fma, TF32_FLOP_PER_S)
    log(f"phase 11 B6 plan at (1, {S}, {H}, {P}), N {N}: kernel chunk "
        f"{pl['chunk']}, {pl['chunks']} chunks; blocks state "
        f"{pl['blocks_state']}, carry {pl['blocks_carry']}, output "
        f"{pl['blocks_output']}; scratch {pl['scratch_bytes'] / 1e6:.1f} MB")
    log(f"phase 11 B6 timing: kernel {ms:.4f} ms (any caller chunk: the "
        f"kernel takes its own), {ms_h0:.4f} ms with h0; by pass: {passes}; "
        f"plain (per-step, {S} steps, one run) {plain:.4f} ms; bound "
        f"{bnd:.4f} ms ({by}; operations in split TF32 {3 * 2 * fma / 1e9:.2f}"
        f" GFLOP at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s "
        f"{3 * 2 * fma / TF32_FLOP_PER_S * 1e3:.4f} ms; bytes "
        f"{n_bytes / 1e6:.1f} MB {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        f"in f32 FMAs {b_f32:.4f} ms ({by_f32}, {2 * fma / 1e9:.2f} GFLOP for "
        "the state read and update); library: none, no PyTorch call "
        "computes the SSD scan")
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/mamba2/kernel.py:24",
            "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def phase_b7(ops_by_name: dict) -> dict:
    """B7, the RWKV-6 WKV recurrence, at RWKV6-7B's widths over 4,096
    steps, with and without h0 (against the per-step plain version and
    ``wkv6_chunked`` in f64); at the decay extremes w_log = -30 and -1e-4
    over 256 steps (both in f64); and at the reference test's shapes."""
    import torch

    from repro_torch.kernels.rwkv6 import wkv6, wkv6_cuda, wkv6_reference
    from repro_torch.kernels.rwkv6.kernel import plan
    from repro_torch.model.rwkv import wkv6_chunked

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def inputs(B, S, H, N, w_value=None):
        """tests/test_kernels.py::test_wkv6_kernel's distributions; w_value
        sets every log-decay."""
        r, k, v = (randn(gen, B, S, H, N, scale=0.5) for _ in range(3))
        w_log = -torch.exp(randn(gen, B, S, H, N, scale=0.5))
        return (r, k, v,
                w_log if w_value is None else torch.full_like(w_log, w_value),
                randn(gen, H, N, scale=0.5),
                randn(gen, B, H, N, N, scale=0.1))

    r, k, v, w_log, u, h0 = inputs(1, SEQ, WKV_H, WKV_N)
    outs, n = drive(ops_by_name, "wkv6", lambda: [
        wkv6(r, k, v, w_log, u, h, chunk=WKV_CHUNK) for h in (None, h0)])
    err = 0.0
    for h, got in zip((None, h0), outs):
        want = wkv6_reference(r, k, v, w_log, u, h0=h)
        f64 = [a.double() for a in (r, k, v, w_log, u)]
        e = held_to(got, {"plain": want, "wkv6_chunked f64": wkv6_chunked(
            *f64, h0=None if h is None else h.double(), chunk=WKV_CHUNK)})
        err = max(err, *e.values())
        f32 = held_to(got, {"f32": wkv6_chunked(
            r, k, v, w_log, u, h0=h, chunk=WKV_CHUNK)})["f32"]
        log(f"phase 12 B7 (1, {SEQ}, {WKV_H}, {WKV_N}), chunk {WKV_CHUNK}, "
            f"h0 {h is not None}: max |err| (y, state) plain "
            f"{e['plain']:.3g}, wkv6_chunked in f64 "
            f"{e['wkv6_chunked f64']:.3g} (in f32 {f32:.3g}; max |y| "
            f"{want[0].abs().max().item():.3g})")
    extremes = []
    for w_value in (-30.0, -1e-4):
        *args, hs = inputs(1, 256, WKV_H, WKV_N, w_value)
        for h in (None, hs):
            got = wkv6(*args, h, chunk=WKV_CHUNK)
            f64 = [a.double() for a in args]
            h64 = None if h is None else h.double()
            truth = wkv6_reference(*f64, h0=h64)
            e = held_to(got, {
                "plain f64": truth,
                "wkv6_chunked f64": wkv6_chunked(*f64, h0=h64,
                                                 chunk=WKV_CHUNK)})
            err = max(err, *e.values())
            drift = held_to(wkv6_reference(*args, h0=h), {"f64": truth})
            extremes.append(f"w_log {w_value:g} h0 {h is not None}: "
                            + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                            + f" (plain f32 itself {drift['f64']:.3g} from "
                            "f64)")
    log(f"phase 12 B7 decay extremes (1, 256, {WKV_H}, {WKV_N}): "
        + "; ".join(extremes))
    small = 0.0
    for shape in ((2, 64, 3, 16), (1, 128, 2, 32), (2, 32, 4, 16)):
        *args, hs = inputs(*shape)
        for h in (None, hs):
            got = wkv6(*args, h, chunk=32)
            want = wkv6_reference(*args, h0=h)
            small = max(small, *(max_err(g, w) for g, w in zip(got, want)))
    err = max(err, small)
    if err > B7_TOL:
        raise AssertionError(f"B7 != plain version: max |err| {err:.3g} > "
                             f"{B7_TOL}")
    log(f"phase 12 B7 = plain version and wkv6_chunked within {err:.3g} "
        f"(bar {B7_TOL}; {small:.3g} at the reference's test shapes); "
        f"launches {n}")
    y = torch.empty_like(r)
    hf = torch.empty((1, WKV_H, WKV_N, WKV_N), device="cuda")
    kernel = functools.partial(wkv6_cuda, r, k, v, w_log, u, None, y, hf)
    ms = time_ms(kernel, reps=5)
    ms_h0 = time_ms(functools.partial(wkv6_cuda, r, k, v, w_log, u, h0, y,
                                      hf), reps=5)
    passes = pass_times(kernel)
    pl = plan(1, SEQ, WKV_H, WKV_N)
    plain = events_ms(lambda: wkv6_reference(r, k, v, w_log, u), warm=False)
    S, H, N = SEQ, WKV_H, WKV_N
    # the function's least work, whatever the chunking: each step and head
    # reads the (N, N) state into y and folds k, v into it
    fma = 2 * N * N * H * S
    bnd, by = bound_ms(4 * (5 * S * H * N + H * N + H * N * N), 2 * fma,
                       F32_FLOP_PER_S)
    log(f"phase 12 B7 plan at (1, {S}, {H}, {N}): kernel chunk "
        f"{pl['chunk']}, {pl['chunks']} chunks; blocks state "
        f"{pl['blocks_state']}, carry {pl['blocks_carry']}, output "
        f"{pl['blocks_output']}; scratch {pl['scratch_bytes'] / 1e6:.1f} MB")
    log(f"phase 12 B7 timing: kernel {ms:.4f} ms, {ms_h0:.4f} ms with h0; "
        f"by pass: {passes}; plain (per-step, {S} steps, one run) "
        f"{plain:.4f} ms; bound {bnd:.4f} ms ({by}, {2 * fma / 1e9:.2f} "
        "GFLOP for the state read and update); library: none, no PyTorch "
        "call computes the WKV recurrence")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:21",
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


# the paper's loop (phase 14): a requirement no design meets, so the
# example's widening runs its whole sweep, Q4 -> Q8 -> Q12 -> Q16, and one
# run drives both of B1's variants (its 12- and 16-bit designs take 9-bit
# activations, which only simt holds). The example's own requirement (eval
# loss <= 0.01) is met at Q8.5 for elastic-lstm and at Q4.2 for
# elastic-conv1d, so its loop would stop before simt; each iteration prints
# whether it was met.
LOOP_ITERS = 4
LOOP_KNOBS = {"bits": 4, "frac": 2}
QAT_TIMED_BATCHES = (256, B_SERVE)
CARD_VS_CPU_TOL = 1e-5                 # float params after 20 AdamW steps


def stage_launch_tracer(lstm_ops, mac_ops):
    """A tracer that also reads B1's launches by variant and B2's launches
    at the start and end of every ``workflow.stage3`` and
    ``workflow.verify`` span (host-side counters, so no synchronise), to
    split a loop's launches by stage."""
    import contextlib

    from repro_torch.obs import Tracer

    class StageLaunches(Tracer):
        STAGES = ("workflow.stage3", "workflow.verify")

        def __init__(self):
            super().__init__()
            self.by_stage = []         # (span name, launches in it)

        @staticmethod
        def read():
            return {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}

        def span(self, name, **attrs):
            inner = super().span(name, **attrs)
            return self._counted(name, inner) if name in self.STAGES \
                else inner

        @contextlib.contextmanager
        def _counted(self, name, inner):
            before = self.read()
            with inner as s:
                yield s
            after = self.read()
            self.by_stage.append(
                (name, {k: after[k] - before[k] for k in after}))

    return StageLaunches()


def qat_step_fn(batch_size: int, device):
    """One Stage-1 QAT step of elastic-lstm at Q8.6 (the example's loss,
    gradient and AdamW update) on ``batch_size`` traffic windows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.data.pipeline import TrafficConfig, traffic_flow_batch
    from repro_torch.launch import elastic_workflow as ew
    from repro_torch.model.layers import value_and_grad
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    from repro_torch.quant.fixedpoint import FxpFormat
    from repro_torch.quant.qat import QATConfig, make_qat_loss
    from repro_torch.verify.vectors import canonical_params, schema_for

    cfg = get_config("elastic-lstm")
    loss = make_qat_loss(cfg, QATConfig(weight_fmt=FxpFormat(8, 6),
                                        act_fmt=FxpFormat(8, 4)))
    grad_fn = value_and_grad(lambda p, b: loss(p, b)[0])
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             traffic_flow_batch(TrafficConfig(batch=batch_size), 0).items()}
    state = {"p": to_torch(canonical_params(schema_for(cfg)), device)}
    state["o"] = init_opt_state(state["p"])

    def step():
        _, g = grad_fn(state["p"], batch)
        state["p"], state["o"], _ = adamw_update(g, state["o"], state["p"],
                                                 ew.OPT)

    return step


def profile_kernels(fn):
    """One ``fn()`` under ``torch.profiler``: host-clock ms (profiler on),
    device busy ms and the count of device activities (kernels, copies,
    fills) it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return wall * 1e3, busy, len(dev)


def phase_loop(ops_by_name: dict, card: str) -> dict:
    """Phase 14: the paper's loop on the card — ``Workflow.run`` of the
    launcher for both canonical designs, B1/B2 counted by stage; Stage 1 on
    the card against the CPU; one QAT step timed and profiled. Returns the
    loop's launches of B1 and B2."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import to_torch
    from repro_torch.core.types import (SHAPES_LSTM, SMOKE_MESH,
                                        ParallelismConfig)
    from repro_torch.core.workflow import Requirement
    from repro_torch.data.pipeline import TrafficConfig, traffic_flow_batch
    from repro_torch.launch import elastic_workflow as ew
    from repro_torch.model.layers import tree_leaves, tree_map
    from repro_torch.model.lm import Stepper
    from repro_torch.obs import find_spans, set_tracer
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.rtl.backend import RTL_TARGET
    from repro_torch.rtl.ir import lower_model
    from repro_torch.verify.vectors import canonical_params, schema_for

    lstm_ops, mac_ops = ops_by_name["lstm_cell_int"], ops_by_name["mac_int"]
    never = Requirement(max_eval_loss=-1.0)        # a loss is never < 0
    train = ew.train
    seen = {"tensors": 0}

    def train_on_card(loss_fn, params, batch, steps):
        """``ew.train`` that first checks every parameter and batch tensor
        of Stage 1 is on the card."""
        for t in tree_leaves(params) + tree_leaves(batch):
            if not t.is_cuda:
                raise AssertionError(f"stage 1: a tensor of shape "
                                     f"{tuple(t.shape)} is on {t.device}")
            seen["tensors"] += 1
        return train(loss_fn, params, batch, steps)

    loop_launches = {}
    for arch in ("elastic-lstm", "elastic-conv1d"):
        wf = ew.build_workflow(arch, device="cuda", verify=True,
                               target="rtl")
        trc = stage_launch_tracer(lstm_ops, mac_ops)
        seen["tensors"] = 0
        for mod in ops_by_name.values():
            mod.launches = 0
        lstm_ops.launches_by_variant = dict.fromkeys(
            lstm_ops.launches_by_variant, 0)
        prev = set_tracer(trc)
        ew.train = train_on_card
        t0 = time.perf_counter()
        try:
            hist = wf.run(never, ew.optimizer, dict(LOOP_KNOBS),
                          max_iters=LOOP_ITERS)
            torch.cuda.synchronize()
        finally:
            ew.train = train
            set_tracer(prev)
        wall = time.perf_counter() - t0
        counts = {key: mod.launches for key, mod in ops_by_name.items()}
        variants = dict(lstm_ops.launches_by_variant)
        loop_launches[arch] = {"B1": counts["lstm_cell_int"],
                               "B2": counts["mac_int"], **variants}
        others = {k: n for k, n in counts.items()
                  if n and k not in ("lstm_cell_int", "mac_int")}
        if len(hist) != LOOP_ITERS or others:
            raise AssertionError(f"{arch} loop: {len(hist)} iterations, "
                                 f"other kernels launched {others}")
        stage = {name: [] for name in trc.STAGES}
        for name, n in trc.by_stage:
            stage[name].append(n)
        spans = {name: [s.duration * 1e3 for s in find_spans(trc.spans,
                                                              name)]
                 for name in ("workflow.run_once", "workflow.stage1",
                              "workflow.stage2", "workflow.stage3",
                              "workflow.verify", "workflow.analyze")}
        for rec in hist:
            it = rec.iteration
            s3, sv = stage["workflow.stage3"][it], stage["workflow.verify"][it]
            opts = RTL_TARGET.options_from_knobs(rec.knobs)
            conf = rec.conformance
            if not (conf is not None and conf.passed):
                raise AssertionError(f"{arch} iteration {it}: conformance "
                                     f"{conf and conf.to_json()}")
            b1_s3 = s3["mma"] + s3["simt"]
            if s3["B2"] == 0 or (arch == "elastic-lstm" and b1_s3 == 0):
                raise AssertionError(f"{arch} iteration {it}: stage 3 "
                                     f"launched {s3}")
            log(f"phase 14 {arch} iteration {it}: design "
                f"{rec.design.weight_fmt}/{rec.design.act_fmt}, RTL "
                f"w {opts.w_fmt} act {opts.act_fmt} state {opts.state_fmt}; "
                f"train loss {rec.design.train_loss:.6f}, eval loss "
                f"{rec.design.eval_loss:.6f} (the example's requirement "
                f"{'met' if ew.REQUIREMENT.satisfied(rec.design, rec.measurement) else 'not met'}); "
                f"{rec.synthesis.resources['cycles']} cycles, latency "
                f"estimated {rec.synthesis.est_latency_s * 1e6:.2f} us vs "
                f"measured {rec.measurement.latency_s * 1e6:.2f} us "
                f"(est_vs_meas {json.dumps(rec.est_vs_meas)}); emulator "
                f"run p50 {rec.measurement.latency_p50_s * 1e3:.3f} ms "
                f"host; conformance: {conf.summary()}; launches stage 3 "
                f"{json.dumps(s3)}, verify {json.dumps(sv)}; host ms "
                + ", ".join(f"{name.split('.')[1]} {v[it]:.1f}"
                            for name, v in spans.items()) + f" ({card})")
        if arch == "elastic-lstm" and not (variants["mma"] and
                                           variants["simt"]):
            raise AssertionError(f"{arch} loop: B1 by variant {variants}")
        stage1 = sum(spans["workflow.stage1"])
        total = sum(spans["workflow.run_once"])
        log(f"phase 14 {arch} Workflow.run: {LOOP_ITERS} iterations in "
            f"{wall:.2f} s host, stage 1 {100 * stage1 / total:.1f}% of "
            f"run_once's {total:.1f} ms; launches B1 "
            f"{counts['lstm_cell_int']} ({json.dumps(variants)}), B2 "
            f"{counts['mac_int']}; {seen['tensors']} stage-1 tensors "
            "checked on the card")

    # -- Stage 1 on the card against the CPU, from one init
    cfg = get_config("elastic-lstm")
    init = canonical_params(schema_for(cfg), seed=SEED + 14)
    out = {}
    for dev in ("cuda", "cpu"):
        st = Stepper(cfg, SHAPES_LSTM["train_batch"], SMOKE_MESH,
                     ParallelismConfig(), opt_cfg=ew.OPT)
        step = st.train_fn()
        p = to_torch(init, dev)
        o = init_opt_state(p)
        for s in range(20):
            b = {k: torch.as_tensor(v, device=dev) for k, v in
                 traffic_flow_batch(TrafficConfig(batch=256), s).items()}
            p, o, _ = step(p, o, b)
        q, _, _ = ew.lstm_train_fn({"bits": 8, "frac": 6}, device=dev,
                                   steps=10, params=to_torch(init, dev))
        out[dev] = (p, q)
    float_err = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])))
    qat_err = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])))
    opts = RTL_TARGET.options_from_knobs({"bits": 8, "frac": 6})
    graphs = [lower_model(cfg, tree_map(lambda t: t.cpu().numpy(),
                                        out[dev][1]),
                          w_fmt=opts.w_fmt, act_fmt=opts.act_fmt,
                          state_fmt=opts.state_fmt)
              for dev in ("cuda", "cpu")]
    differ = total = 0
    for a, b in zip(*(g.nodes for g in graphs)):
        for what in ("weight_int", "bias_int"):
            if hasattr(a, what):
                wa, wb = getattr(a, what)(), getattr(b, what)()
                differ += int(np.count_nonzero(wa != wb))
                total += wa.size
    log(f"phase 14 Stage 1 card vs CPU from one init: 20 float AdamW steps "
        f"max |param diff| {float_err:.3g} (bar {CARD_VS_CPU_TOL}); 10 QAT "
        f"steps (Q8.6) max |param diff| {qat_err:.3g}, lowered integer "
        f"weights differing {differ} of {total}; iso_key equal "
        f"{graphs[0].iso_key() == graphs[1].iso_key()}")
    if float_err > CARD_VS_CPU_TOL:
        raise AssertionError(f"float training card vs CPU {float_err:.3g} "
                             f"> {CARD_VS_CPU_TOL}")

    # -- one QAT train step, timed and profiled
    for batch in QAT_TIMED_BATCHES:
        step = qat_step_fn(batch, "cuda")
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        samples = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        wall, busy, n_kernels = profile_kernels(step)
        log(f"phase 14 QAT train step (elastic-lstm, Q8.6, loss + grad + "
            f"AdamW) at batch {batch}: host ms median "
            f"{sorted(samples)[len(samples) // 2]:.3f} (min {min(samples):.3f}, "
            f"max {max(samples):.3f}, 10 synchronised steps); profiled step: "
            f"device busy {busy:.3f} ms of {wall:.3f} ms host (profiler on), "
            f"{n_kernels} device activities ({card})")
    return loop_launches


# the host target's Yi-9B cells (phase 15): one 2,048-token prefill (the
# reference's prefill_32k x 32 would need about 103 GB of K/V cache alone)
# and one decode tick of the serving run's 4 slots over 4,096 positions,
# half of them filled
HOST_PREFILL = ("prefill_2k", "prefill", 2048, 1)
HOST_DECODE = ("decode_4k", "decode", MAX_LEN, SLOTS)
HOST_RUNS, HOST_WARMUP = 20, 2


def host_deploy(cfg, params, shape, args_fn, flash_ops, card: str) -> dict:
    """Phase 15, one cell through the host target: translate (the
    step counted on ``meta``), the same step counted again on the card's
    tensors (equal counts asserted), one deployed call (B5 launches
    counted), then ``measure`` and one profiled call; prints the report's
    roofline row, p50/p99, the whole-step share of the card's peak, the
    peak device memory beside the counted bytes and the device busy time.
    Returns B5's launches, the p50 and the share."""
    import torch

    from repro_torch.core.creator import Creator
    from repro_torch.core.target import model_flops_estimate
    from repro_torch.core.types import ParallelismConfig, ShapeConfig
    from repro_torch.energy.cost import count_step
    from repro_torch.energy.roofline import HEADER, roofline

    cr = Creator()
    st = cr.build(cfg, ShapeConfig(*shape), par=ParallelismConfig(
        compute_dtype="bfloat16", attn_impl="flash"))
    syn, dep = cr.translate(st, target="xla", params=params)
    args = args_fn(st)
    with torch.inference_mode(shape[1] != "train"):
        on_card = count_step(dep.fn, args)
    keys = ("flops", "bytes_accessed", "argument_bytes", "output_bytes",
            "temp_bytes")
    counted = {k: getattr(syn, k) for k in keys}
    got = {k: getattr(on_card, k) for k in keys}
    if got != counted or on_card.as_text() != dep.ops_text:
        raise AssertionError(f"{cfg.name} {shape[0]}: counts on the card "
                             f"{got} != counts on meta {counted}")
    torch.cuda.synchronize()
    flash_ops.launches = 0
    flash_ops.launches_by_variant = dict.fromkeys(
        flash_ops.launches_by_variant, 0)
    out = dep(*args)
    torch.cuda.synchronize()
    per_call = flash_ops.launches
    if shape[1] == "train":              # (params', opt_state', metrics)
        if not torch.isfinite(out[2]["loss"]):
            raise AssertionError(f"{cfg.name} {shape[0]}: loss "
                                 f"{float(out[2]['loss'])}")
    else:
        logits = out[0]
        if not torch.isfinite(logits).all() or tuple(logits.shape) != (
                shape[3], cfg.padded_vocab):
            raise AssertionError(f"{cfg.name} {shape[0]}: logits "
                                 f"{tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
    # a train step runs each layer's attention forward twice: the forward
    # and its remat recompute in the backward
    want = {"prefill": cfg.n_layers, "decode": 0,
            "train": 2 * cfg.n_layers}[shape[1]]
    if per_call != want or flash_ops.launches_by_variant["simt"]:
        raise AssertionError(f"{cfg.name} {shape[0]}: B5 launched "
                             f"{per_call} times a call "
                             f"({flash_ops.launches_by_variant}), expected "
                             f"{want}, all sm90")
    del out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mf = model_flops_estimate(cfg, st.shape)
    meas = dep.measure(args, model=cfg.name, model_flops=mf,
                       n_runs=HOST_RUNS, warmup=HOST_WARMUP)
    peak = torch.cuda.max_memory_allocated() - base
    wall, device = profile_ms(lambda: dep(*args))
    busy = sum(device.values())
    b5_dev = sum(t for name, t in device.items() if "flash_fwd" in name)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
    rep = roofline(arch=cfg.name, shape=shape[0], mesh="1dev", n_devices=1,
                   cost={"flops": syn.flops,
                         "bytes accessed": syn.bytes_accessed},
                   hlo_text=dep.ops_text, model_flops=mf, hw=dep.hw)
    share = mf / (dep.hw.peak_flops * meas.latency_p50_s)
    log(f"phase 15 {cfg.name} {shape[0]} host target, roofline:\n"
        f"  {HEADER}\n  {rep.row()}")
    log(f"phase 15 {cfg.name} {shape[0]}: counted {syn.flops:.6e} FLOP "
        f"(model_flops_estimate {mf:.6e}, useful_ratio "
        f"{rep.useful_ratio:.4f}), {syn.bytes_accessed:.6e} bytes accessed "
        f"(eager), bottleneck {syn.bottleneck}, estimate "
        f"{syn.est_latency_s * 1e3:.4f} ms; counts on the card equal counts "
        f"on meta ({len(dep.ops_text.splitlines())} ops); B5 launches a "
        f"call {per_call}; measured p50 {meas.latency_p50_s * 1e3:.4f} ms, "
        f"p99 {meas.latency_p99_s * 1e3:.4f} ms, mean "
        f"{meas.latency_s * 1e3:.4f} ms ({HOST_RUNS} synchronised runs after "
        f"{HOST_WARMUP} warmup); whole-step share of peak "
        f"{share:.4f} (model_flops / (989e12 x p50)); peak device memory "
        f"above the inputs {peak / 2**30:.3f} GiB beside counted temp "
        f"{syn.temp_bytes / 2**30:.3f} GiB + output "
        f"{syn.output_bytes / 2**30:.3f} GiB (inputs "
        f"{syn.argument_bytes / 2**30:.3f} GiB); translate "
        f"{syn.compile_seconds:.2f} s ({card})")
    log(f"phase 15 {cfg.name} {shape[0]} profile, one deployed call: "
        + (f"device busy {busy:.3f} ms of {wall:.3f} ms host clock "
           f"(profiler on), B5 {b5_dev:.3f} ms; " + "; ".join(
               f"{name[:60]} {ms:.3f} ms" for name, ms in top)
           if busy else "device time not measured (the profiler saw no "
           "GPU activity)"))
    return {"b5_launches": flash_ops.launches, "per_call": per_call,
            "p50_ms": meas.latency_p50_s * 1e3, "share": share}


def phase_host_loop(ops_by_name: dict, card: str) -> None:
    """Phase 15, the paper's default loop: ``python -m
    repro_torch.launch.elastic_workflow --verify`` (the host target) for
    both canonical designs on the card, with the example's settings. Each
    iteration's host deployment is counted in stage 2, timed in stage 3 and
    verified; the final RTL translate and its conformance launch B1 and
    B2, counted around the run."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import elastic_workflow as ew

    built = []
    build = ew.build_workflow

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    for arch in ("lstm", "conv1d"):
        for mod in ops_by_name.values():
            mod.launches = 0
        built.clear()
        ew.build_workflow = keep
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = ew.main(["--verify", "--arch", arch])
            torch.cuda.synchronize()
        finally:
            ew.build_workflow = build
        wall = time.perf_counter() - t0
        counts = {key: mod.launches for key, mod in ops_by_name.items()}
        (wf,) = built
        text = out.getvalue()
        if rc != 0 or wf.target != "xla" or "conformance: " not in text \
                or " PASS " not in text.split("conformance: ")[-1]:
            raise AssertionError(f"{arch} host loop: rc {rc}, target "
                                 f"{wf.target}:\n{text[-2000:]}")
        if counts["mac_int"] == 0 or (arch == "lstm"
                                      and counts["lstm_cell_int"] == 0):
            raise AssertionError(f"{arch} host loop: launches {counts}")
        for rec in wf.history:
            conf, syn, meas = rec.conformance, rec.synthesis, rec.measurement
            if not (conf is not None and conf.passed and conf.target
                    == "xla" and meas.platform == torch.cuda
                    .get_device_name(0)):
                raise AssertionError(f"{arch} iteration {rec.iteration}: "
                                     f"{conf and conf.to_json()} on "
                                     f"{meas.platform}")
            log(f"phase 15 elastic-{arch} host iteration {rec.iteration}: "
                f"{rec.design.weight_fmt}, eval loss "
                f"{rec.design.eval_loss:.6f}; counted {syn.flops:.0f} FLOP, "
                f"{syn.bytes_accessed:.0f} bytes, bottleneck "
                f"{syn.bottleneck}, estimate {syn.est_latency_s * 1e9:.2f} "
                f"ns; measured p50 {meas.latency_p50_s * 1e3:.4f} ms, p99 "
                f"{meas.latency_p99_s * 1e3:.4f} ms on {meas.platform}; "
                f"verify {conf.summary()}")
        log(f"phase 15 elastic-{arch} launcher --verify (host target): "
            f"{len(wf.history)} iterations, final RTL translate and "
            f"conformance pass, {wall:.2f} s host; launches "
            + json.dumps({k: n for k, n in counts.items() if n})
            + f" ({card})")


# the farm (phase 16): the loadgen CLI's flags, in process
FARM_ARGV = ("--arch", "lstm,conv1d", "--requests", "4096", "--wave", "128",
             "--replicas", "2", "--warm")
FARM_SAMPLES = 64
# multi-design emulation (phase 17): K isomorphic candidates of each design
MULTI_K = 8


def phase_farm(lstm_ops, mac_ops, card: str) -> dict:
    """Phase 16: ``python -m repro_torch.serving.loadgen`` (FARM_ARGV) in
    process on the card; every admitted request done or expired, none
    failed; B1 and B2 launched once per dispatch of each node they serve;
    64 sampled answers equal per-request ``jnp`` runs bit for bit. Returns
    the launches of B1 (by variant) and B2 over the CLI's run."""
    import numpy as np
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.serving import loadgen, pad_window

    args = loadgen.parse_args(list(FARM_ARGV))
    lstm_ops.launches = 0
    lstm_ops.launches_by_variant = dict.fromkeys(
        lstm_ops.launches_by_variant, 0)
    mac_ops.launches = 0
    t0 = time.perf_counter()
    report, farm = loadgen.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}
    for line in loadgen.summary(report):
        log(f"phase 16 {line.strip()}")
    bad = loadgen.failures(report)
    st = farm.stats()
    if bad or st.failed or st.admitted != st.done + st.expired:
        raise AssertionError(f"farm: {bad}; stats {st.to_dict()}")
    # each member's emulator counts its dispatches: B1 once per lstm_cell
    # and B2 once per linear/conv1d node in each
    want = {"mma": 0, "simt": 0, "B2": 0}
    dispatches = {}
    for family, pool in farm.pools.items():
        for reps in pool.members.values():
            for exe in reps:
                n = exe.emulator.dispatch_counts.get("fused", 0)
                dispatches[family] = dispatches.get(family, 0) + n
                for node in exe.graph.nodes:
                    if node.op == "lstm_cell":
                        spec = exe.emulator.prepared(node.name)["spec"]
                        want[lstm_ops.variant(spec)] += n
                    elif node.op in ("linear", "conv1d"):
                        want["B2"] += n
    if launched != want or launched["mma"] == 0 or launched["B2"] == 0:
        raise AssertionError(f"farm launches {launched}, expected {want}")
    captures = sum(exe.emulator.trace_count for pool in farm.pools.values()
                   for reps in pool.members.values() for exe in reps)
    log(f"phase 16 farm launches over the CLI's two passes: B1 by variant "
        f"{json.dumps({k: launched[k] for k in ('mma', 'simt')})}, B2 "
        f"{launched['B2']}, in {sum(dispatches.values())} dispatches "
        f"({json.dumps(dispatches)}): B1 1 a lstm dispatch, B2 1 a lstm "
        f"and 3 a conv1d dispatch; {captures} CUDA Graph captures; "
        f"{wall:.2f} s host for both passes ({card})")
    # 64 sampled answers against per-request runs of the plain path
    rng = np.random.default_rng(SEED + 16)
    done = [r for r in farm.requests.values() if r.status == "done"]
    plain = {}
    for i in rng.choice(len(done), FARM_SAMPLES, replace=False):
        req = done[int(i)]
        exe = farm.pools[req.design].members[req.bucket_len][req.member]
        em = plain.setdefault(id(exe), RTLEmulator(exe.graph, mode="jnp"))
        solo = em.run(pad_window(req.window, req.bucket_len)[None])
        if not np.array_equal(req.result, solo.outputs_f.cpu().numpy()[0]):
            raise AssertionError(f"farm request {req.rid} != its solo run")
    # where a dispatch's time goes: one more pass of 1,024 requests on the
    # warm farm under the tracer (host clock by span), then one under the
    # profiler's CUDA activities only (device busy)
    spec = loadgen.TrafficSpec(archs=("lstm", "conv1d"), n_requests=1024,
                               wave=128, seed=SEED + 1)
    pools = list(farm.pools.values())
    trc = Tracer()
    prev = set_tracer(trc)
    try:
        t0 = time.perf_counter()
        loadgen.run_loadgen(farm, pools, spec)
        traced = time.perf_counter() - t0
    finally:
        set_tracer(prev)
    by_span = {name: sum(sp.duration for sp in find_spans(trc.spans, name))
               for name in ("serving.tick", "serving.dispatch",
                            "rtl.emulator.dispatch")}
    n_disp = len(find_spans(trc.spans, "serving.dispatch"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loadgen.run_loadgen(farm, pools, spec)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    ms = {k: v * 1e3 / n_disp for k, v in by_span.items()}
    log(f"phase 16 farm, where a dispatch's host time goes ({spec.n_requests}"
        f" requests, {n_disp} dispatches, traced pass {traced * 1e3:.1f} ms):"
        f" per dispatch {ms['serving.tick']:.3f} ms of ticks"
        f" = member call {ms['serving.dispatch']:.3f} ms (of it the "
        f"emulator's run {ms['rtl.emulator.dispatch']:.3f} ms) + the rest "
        f"of the tick (queue, batcher, routing, the answer's copy to the "
        f"host, accounting) "
        f"{ms['serving.tick'] - ms['serving.dispatch']:.3f} ms; submitting "
        f"and the report {(traced - by_span['serving.tick']) * 1e3:.1f} ms "
        f"of the pass; device busy {busy:.3f} ms of a {profiled * 1e3:.1f} "
        f"ms pass under the profiler ({100 * busy / (profiled * 1e3):.1f}%)"
        f" ({card})")
    lat = report["stats"]["latency_s"]
    log(f"phase 16 farm: {FARM_SAMPLES} sampled answers = per-request jnp "
        f"runs bit for bit; reported pass {report['submitted']} requests, "
        f"{report['throughput_windows_per_s']:.0f} windows/s, latency p50 "
        f"{report['latency_p50_s'] * 1e3:.3f} ms, p99 "
        f"{report['latency_p99_s'] * 1e3:.3f} ms (host clock; both passes' "
        f"histogram: p50 {lat.get('p50', 0) * 1e3:.3f}, p99 "
        f"{lat.get('p99', 0) * 1e3:.3f} ms), batch fill "
        f"{json.dumps(report['stats']['batch_fill'])} ({card})")
    return launched


def phase_multi(lstm_ops, mac_ops, card: str) -> dict:
    """Phase 17: K = MULTI_K isomorphic candidates of each canonical
    design at B_SERVE windows through ``MultiDesignEmulator`` (one CUDA
    Graph of the K ``fused`` walks): equal to ``run_int_sequential`` and
    to each design's ``jnp`` walk; ``run_conformance_batch`` passes every
    design; one replay timed against K sequential runs on warm programs.
    Returns the launches one replay of each design's program made."""
    import numpy as np
    import torch

    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.rtl.multi import MultiDesignEmulator
    from repro_torch.verify.conformance import run_conformance_batch
    from repro_torch.verify.vectors import canonical_graph

    def host_ms(fn, reps: int = 5) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    rng = np.random.default_rng(SEED + 17)
    replay = {"mma": 0, "simt": 0, "B2": 0}
    for arch in ("elastic-lstm", "elastic-conv1d"):
        graphs = [canonical_graph(arch, seed=s)[0] for s in range(MULTI_K)]
        multi = MultiDesignEmulator(graphs)
        edge = graphs[0].edges[graphs[0].inputs[0]]
        x = rng.integers(edge.fmt.lo, edge.fmt.hi + 1,
                         (B_SERVE, *edge.shape)).astype(np.int32)
        got = multi.run_int(x)                   # builds: capture
        torch.cuda.synchronize()
        seq = multi.run_int_sequential(x)        # the K fused programs
        if not np.array_equal(got.outputs.cpu().numpy(), seq):
            raise AssertionError(f"{arch}: multi != run_int_sequential")
        for k, g in enumerate(graphs):
            want = RTLEmulator(g, mode="jnp").run_int_per_step(x).outputs
            if not torch.equal(got.outputs[k], want):
                raise AssertionError(f"{arch}: multi design {k} != jnp")
        lstm_ops.launches_by_variant = dict.fromkeys(
            lstm_ops.launches_by_variant, 0)
        mac_ops.launches = 0
        again = multi.run_int(x)                 # one replay
        torch.cuda.synchronize()
        one = {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}
        cells = sum(n.op == "lstm_cell" for n in graphs[0].nodes)
        macs = sum(n.op in ("linear", "conv1d") for n in graphs[0].nodes)
        if one != {"mma": MULTI_K * cells, "simt": 0,
                   "B2": MULTI_K * macs} or \
                not torch.equal(again.outputs, got.outputs):
            raise AssertionError(f"{arch}: one replay launched {one}")
        for k in replay:
            replay[k] += one[k]
        xs = torch.as_tensor(x, device="cuda")
        t_multi = host_ms(lambda: multi.run_int(xs))
        t_seq = host_ms(lambda: [em.run_int(xs) for em in multi.emulators])
        log(f"phase 17 {arch} K={MULTI_K} x {B_SERVE} windows: = "
            f"run_int_sequential and every design's jnp walk; one replay "
            f"launches {json.dumps(one)}; one replay {t_multi:.3f} ms against "
            f"{MULTI_K} sequential warm runs {t_seq:.3f} ms "
            f"({t_seq / t_multi:.2f}x; host clock, int codes on the card); "
            f"captures: multi {multi.trace_count}, per-design "
            f"{sum(em.trace_count for em in multi.emulators)}; shared LRU "
            f"{json.dumps(multi.programs.stats())} ({card})")
        t0 = time.perf_counter()
        reps = run_conformance_batch(graphs)
        dt = time.perf_counter() - t0
        if not all(r.passed and r.modes[0] == "vmap-jnp" for r in reps):
            raise AssertionError(f"{arch} run_conformance_batch: "
                                 + "; ".join(r.summary() for r in reps))
        log(f"phase 17 {arch} run_conformance_batch: {len(reps)} designs "
            f"pass over {reps[0].n_vectors} vectors (vmap-jnp vs "
            f"{', '.join(reps[0].modes[1:])}: "
            f"{json.dumps(reps[0].mode_max_diff)}) in {dt * 1e3:.1f} ms host "
            f"({card})")
        del multi, got, again
        torch.cuda.empty_cache()
    return replay


# the resilience layer (phase 18): the SEU sweep's bits, the windows held
# against a CPU emulator, and the acceptance scenario's settings (the
# reference's tests/test_resilience.py:447-452)
SEU_BITS = (0, 7, 15, 30, 31)
SEU_HOST_WINDOWS = 1024
CHAOS_PLAN = os.path.join(ROOT, "examples", "chaos_plan.json")
GUARDED_REQUESTS = 1024
GUARDED_SAMPLES = 64
FLIP_WAVE = 2                          # of the 8 waves of 128 requests


def resilience_designs():
    """The sweep's designs: Table I (B1 mma), its 12-bit twin (B1 simt from
    the start) and the conv1d stack (B2 only)."""
    from repro_torch.quant.fixedpoint import FxpFormat
    from repro_torch.verify.vectors import canonical_graph

    return {"elastic-lstm": canonical_graph("elastic-lstm")[0],
            "elastic-lstm-q12": canonical_graph(
                "elastic-lstm", act_fmt=FxpFormat(12, 6),
                state_fmt=FxpFormat(12, 8))[0],
            "elastic-conv1d": canonical_graph("elastic-conv1d")[0]}


def seu_sweep(lstm_ops, arch, graph, card: str) -> dict:
    """Phase 18(a) for one design: every memory, bits SEU_BITS of one
    seeded word, B_SERVE windows after each flip. ``fused`` (B1 and B2, a
    capture then a replay) is held against the card's ``jnp`` walk and,
    on SEU_HOST_WINDOWS windows, against a CPU emulator flipped the same
    way: 0 mismatches. The second flip restores the word, and the answer
    must be the unflipped one again. Returns the host ms of the runs that
    build after a flip and of the warm replays."""
    import numpy as np
    import torch

    from repro_torch.rtl.emulator import RTLEmulator

    fused = RTLEmulator(graph)
    plain = RTLEmulator(graph, mode="jnp")
    host = RTLEmulator(graph, device="cpu")
    edge = graph.edges[graph.inputs[0]]
    rng = np.random.default_rng(SEED + 18)
    x = torch.as_tensor(rng.integers(edge.fmt.lo, edge.fmt.hi + 1,
                                     (B_SERVE, *edge.shape)),
                        dtype=torch.int32, device="cuda")
    x_host = x[:SEU_HOST_WINDOWS].cpu()
    base = fused.run_int(x).outputs.clone()
    cell = {n.name: fused.prepared(n.name)["spec"] for n in graph.nodes
            if n.op == "lstm_cell"}
    # B1's launches a run makes with every W in its format
    rest = {"mma": 0, "simt": 0}
    for spec in cell.values():
        rest[lstm_ops.variant(spec)] += 1

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    build_ms, warm_ms, flips = [], [], 0
    for node, key in fused.memories():
        word = int(rng.integers(fused.prepared(node)[key].numel()))
        routes = []
        for bit in SEU_BITS:
            new = {em.flip_bit(node, key, word, bit)
                   for em in (fused, plain, host)}
            if len(new) != 1:
                raise AssertionError(f"{arch} {node}.{key}: flipped words "
                                     f"{new}")
            flips += 1
            caps = fused.trace_count
            before = dict(lstm_ops.launches_by_variant)
            got, ms = timed(lambda: fused.run_int(x).outputs)
            build_ms.append(ms)
            again, ms = timed(lambda: fused.run_int(x).outputs)
            warm_ms.append(ms)
            ran = {k: lstm_ops.launches_by_variant[k] - before[k]
                   for k in before}
            want = plain.run_int(x).outputs
            bad = int((got != want).sum()) + int((again != got).sum()) + \
                int((got[:SEU_HOST_WINDOWS].cpu()
                     != host.run_int(x_host).outputs).sum())
            if bad:
                raise AssertionError(f"{arch} {node}.{key} bit {bit}: {bad} "
                                     "mismatches")
            # two runs; a W word outside w_fmt moves its cell to simt
            want_ran = {k: 2 * n for k, n in rest.items()}
            if node in cell and key == "w" and \
                    lstm_ops.variant(cell[node]) == "mma" and not \
                    cell[node].w_fmt.lo <= next(iter(new)) <= \
                    cell[node].w_fmt.hi:
                want_ran = {"mma": want_ran["mma"] - 2,
                            "simt": want_ran["simt"] + 2}
            if ran != want_ran:
                raise AssertionError(f"{arch} {node}.{key} bit {bit}: B1 "
                                     f"launched {ran}, want {want_ran}")
            routes.append(f"{bit}:{next(iter(new))}:"
                          f"{'+'.join(k for k, n in ran.items() if n) or '-'}"
                          f":{fused.trace_count - caps}")
            for em in (fused, plain, host):
                em.flip_bit(node, key, word, bit)
            before = dict(lstm_ops.launches_by_variant)
            restored = fused.run_int(x).outputs
            back = {k: lstm_ops.launches_by_variant[k] - before[k]
                    for k in before}
            if not torch.equal(restored, base):
                raise AssertionError(f"{arch} {node}.{key} bit {bit}: the "
                                     "restored word gives another answer")
            if back != rest:
                raise AssertionError(f"{arch} {node}.{key} bit {bit}: B1 "
                                     f"after the restore {back}")
        log(f"phase 18 SEU {arch} {node}.{key} word {word}, bit:new word:B1 "
            f"variant:captures per flip: {' '.join(routes)}; = jnp on the "
            f"card and the CPU emulator, restored = unflipped")
    return {"flips": flips, "build_ms": build_ms, "warm_ms": warm_ms}


def phase_resilience(lstm_ops, mac_ops, card: str) -> dict:
    """Phase 18: (a) the SEU sweep over every memory of three designs; (b)
    the acceptance chaos scenario on the card, its JSON equal to the CPU's;
    (c) a guarded farm of both designs, two replicas each, one flipped
    mid-pass and quarantined by its canary. Returns the B1 (by variant)
    and B2 launches of the phase."""
    import numpy as np
    import torch

    from repro_torch.core.workflow import chaos_fallback
    from repro_torch.energy.hw import XC7S15
    from repro_torch.obs import (MetricsRegistry, Tracer, find_spans,
                                 set_tracer)
    from repro_torch.resilience import (ChaosSpec, FaultPlan, GuardPolicy,
                                        run_chaos)
    from repro_torch.rtl.backend import RTLExecutable
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.serving import (AcceleratorFarm, DesignPool, FarmConfig,
                                     loadgen, pad_window)
    from repro_torch.verify.vectors import generate_vectors

    lstm_ops.launches = 0
    lstm_ops.launches_by_variant = dict.fromkeys(
        lstm_ops.launches_by_variant, 0)
    mac_ops.launches = 0
    # ---- (a) the SEU sweep ----
    designs = resilience_designs()
    t0 = time.perf_counter()
    flips, build_ms, warm_ms = 0, [], []
    for arch, graph in designs.items():
        got = seu_sweep(lstm_ops, arch, graph, card)
        flips += got["flips"]
        build_ms += got["build_ms"]
        warm_ms += got["warm_ms"]
    torch.cuda.synchronize()                     # no trap: the card is fine
    log(f"phase 18(a) SEU sweep: {flips} flips over every memory of "
        f"{len(designs)} designs x bits {SEU_BITS}, {B_SERVE} windows each, "
        f"0 mismatches; the run after a flip (a capture) median "
        f"{np.median(build_ms):.3f} ms (max {np.max(build_ms):.3f}, the "
        f"first flip's {build_ms[0]:.3f}), a warm replay median "
        f"{np.median(warm_ms):.3f} ms (host clock, int codes on the card); "
        f"{time.perf_counter() - t0:.1f} s in all; torch.cuda.synchronize() "
        f"clean ({card})")
    # ---- (b) the acceptance scenario ----
    graph = designs["elastic-lstm"]

    def scenario(device):
        dep = RTLExecutable(graph=graph, artifacts={}, hw=XC7S15,
                            device=device)
        spec = ChaosSpec(plan=FaultPlan.load(CHAOS_PLAN), n_requests=24,
                         seed=7, policy=GuardPolicy(
                             timeout_s=0.25, max_retries=2,
                             breaker_threshold=3, canary_every=4))
        return run_chaos(dep, spec, fallback=chaos_fallback(dep, XC7S15))

    before = {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}
    trc = Tracer()
    prev = set_tracer(trc)
    try:
        t0 = time.perf_counter()
        rep = scenario("cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        set_tracer(prev)
    # where the scenario's host time goes, by span (ms)
    spent = {name: 1e3 * sum(sp.duration for sp in find_spans(trc.spans,
                                                                 name))
             for name in ("resilience.chaos", "resilience.canary",
                          "resilience.fallback")}
    rest = spent["resilience.chaos"] - spent["resilience.fallback"] - \
        spent["resilience.canary"]
    ran = {k: {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}[k]
           - before[k] for k in before}
    cpu_rep = scenario("cpu")
    post = [r for r in rep.requests
            if r["request"] > rep.faults_detected[0]["request"]] \
        if rep.faults_detected else []
    if not (rep.passed and rep.requests_lost == 0
            and rep.corrupted_after_detection == 0
            and rep.breaker_trips == 1 and post
            and all(r["source"] == "xla" and r["correct"] for r in post)):
        raise AssertionError(f"acceptance scenario on the card: "
                             f"{rep.summary()}")
    if rep.to_json() != cpu_rep.to_json():
        raise AssertionError("acceptance scenario: the card's report != the "
                             "CPU's")
    log(f"phase 18(b) acceptance scenario on the card: {rep.summary()}; "
        f"to_json() = the CPU's byte for byte (sha256 "
        f"{sha256(rep.to_json().encode())[:16]}); launches B1 by variant "
        f"{json.dumps({k: ran[k] for k in ('mma', 'simt')})}, B2 "
        f"{ran['B2']}; {wall:.1f} ms host, of it the request loop "
        f"{spent['resilience.chaos']:.1f} ms = the fallback's "
        f"{rep.requests_degraded} answers "
        f"{spent['resilience.fallback']:.1f} + the canary probes "
        f"{spent['resilience.canary']:.1f} + the rest (primary calls with "
        f"their program builds, retries, scoring) {rest:.1f} (spans) "
        f"({card})")
    # host ms per guarded call, per canary probe, and for the re-capture
    # after a flip, on a warm guard of its own
    dep = RTLExecutable(graph=graph, artifacts={}, hw=XC7S15)
    vectors = generate_vectors(graph)
    guard = dep.guarded(canary=vectors, policy=GuardPolicy(canary_every=0),
                        metrics=MetricsRegistry())
    x1 = vectors.stimulus_f()[:1]

    def host_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    bare = host_ms(lambda: dep(x1))
    call = host_ms(lambda: guard.call(x1))
    probe = host_ms(guard.probe)
    recapture = []
    for _ in range(2):                           # flip, then restore
        dep.emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        guard.call(x1)
        recapture.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 18(b) host ms on the card, batch-1 elastic-lstm: the bare "
        f"deployment call {bare:.3f}, a guarded call {call:.3f}, a canary "
        f"probe ({guard.policy.canary_slice} golden rows) {probe:.3f}, the "
        f"first guarded call after a flip (W leaves Q8.6: a capture of the "
        f"simt walk) {recapture[0]:.3f}, after the restoring flip (mma) "
        f"{recapture[1]:.3f} ({card})")
    # ---- (c) a guarded farm ----
    buckets = {"lstm": (6,), "conv1d": (16,)}
    fams = {"lstm": designs["elastic-lstm"],
            "conv1d": designs["elastic-conv1d"]}
    members = {fam: [RTLExecutable(graph=g, artifacts={}, hw=XC7S15)
                     .guarded(canary=generate_vectors(g),
                              policy=GuardPolicy(canary_every=4,
                                                 max_retries=0),
                              rng=np.random.default_rng(i),
                              metrics=MetricsRegistry(),
                              name=f"{fam}{i}") for i in range(2)]
               for fam, g in fams.items()}
    farm = AcceleratorFarm([DesignPool(family=fam, members={
        buckets[fam][0]: reps}) for fam, reps in members.items()],
        FarmConfig(max_batch=8), metrics=MetricsRegistry())
    tape = loadgen.generate_requests(loadgen.TrafficSpec(
        archs=("lstm", "conv1d"), n_requests=GUARDED_REQUESTS, wave=128,
        seed=SEED + 18), buckets)
    waves = [tape[i:i + 128] for i in range(0, len(tape), 128)]
    rids, flipped, det_wave = [], None, None
    t0 = time.perf_counter()
    for w, wave in enumerate(waves):
        rids.append([farm.submit(design, win) for design, win in wave])
        if w == FLIP_WAVE:
            lstm = members["lstm"]
            flipped = max(range(2), key=lambda i: lstm[i].calls)
            lstm[flipped].emulator.flip_bit("lstm_cell_l0", "w", 0, 7)
        farm.tick(flush=True)
        if flipped is not None and det_wave is None and \
                members["lstm"][flipped].quarantined:
            det_wave = w
    st = farm.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sick = members["lstm"][flipped]
    if st.failed or st.admitted != st.done + st.expired or \
            det_wave is None or sick.calls != sick.detections[0]["call"]:
        raise AssertionError(f"guarded farm: stats {st.to_dict()}, "
                             f"detected in wave {det_wave}, health "
                             f"{sick.health()}")
    late = [farm.result(r) for wave in rids[det_wave + 1:] for r in wave]
    if any(r.design == "lstm" and r.member == flipped for r in late):
        raise AssertionError("guarded farm: the quarantined replica served "
                             "after its detection")
    plain = {fam: RTLEmulator(g, mode="jnp") for fam, g in fams.items()}
    rng = np.random.default_rng(SEED + 18)
    for i in rng.choice(len(late), GUARDED_SAMPLES, replace=False):
        req = late[int(i)]
        solo = plain[req.design].run(pad_window(
            req.window, req.bucket_len)[None]).outputs_f.cpu().numpy()[0]
        if not np.array_equal(req.result, solo):
            raise AssertionError(f"guarded farm request {req.rid} != its "
                                 "jnp run")
    health = {m.name: (m.calls, m.health()["state"], len(m.detections))
              for reps in members.values() for m in reps}
    log(f"phase 18(c) guarded farm: {st.submitted} requests, {st.done} done,"
        f" {st.failed} failed, {st.redispatches} redispatched; lstm replica "
        f"{flipped} flipped in wave {FLIP_WAVE}, quarantined by its "
        f"canary in wave {det_wave} and sent nothing after; replicas (calls, "
        f"breaker, detections) {json.dumps(health)}; {GUARDED_SAMPLES} "
        f"answers after detection = per-request jnp runs; {wall:.2f} s host "
        f"({card})")
    torch.cuda.synchronize()
    return {**lstm_ops.launches_by_variant, "B2": mac_ops.launches}


# LM training (phase 19): StableLM-3B at its published widths and depth,
# f32 master parameters, bf16 compute, B5 for every attention forward
TRAIN_ARCH = "stablelm-3b"
TRAIN_SHAPE = ("train_2k", "train", 2048, 4)
TRAIN_STEPS = 8
TRAIN_REF_LAYERS = 4                  # the f32 check's depth
F32_TRAIN_LOSS_TOL = 1e-5             # relative, f32, full width, 4 layers
F32_TRAIN_GRAD_TOL = 1e-3             # relative rms of each gradient leaf
# B5's gradient at a layer of each dense model: (B, S, H, hd, kv heads),
# K/V GQA-repeated to H heads
B5_GRAD_CASES = {"stablelm-3b": (4, 2048, 32, 80, 32),
                 "yi-9b": (1, 2048, 32, 128, 4)}
# recovery (the reference's tests/test_runtime.py scenario)
RECOVERY_STEPS, RECOVERY_FAILS = 25, (13, 21)
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass|wgmma", re.I)


def rel_rms(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def phase_train(ops_by_name: dict, card: str) -> dict:
    """Phase 19, LM training on the card. (a) B5's gradient at a
    StableLM-3B and a Yi-9B layer, bit for bit the plain version's, its
    forward on ``sm90``; (b) the ``Trainer`` on StableLM-3B at full width
    and depth for 8 steps (after the first step's loss and gradients from
    one set of params held against ``attn_impl="ref"``), B5's launches
    counted, then one step profiled, and the host target's report of the
    train step at 4 layers (phase 15's third cell); (c) the reference's
    recovery scenario and checkpoints restored bit for bit; (d) the
    launcher in process. Returns B5's launches over the 8 steps."""
    import contextlib
    import io
    import statistics
    import tempfile

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ref import (BF16_REL_RMS_BAR,
                                                         rel_rms_by_block)
    from repro_torch.launch import train as launch_train
    from repro_torch.model.layers import (param_count, tree_leaves,
                                          tree_map, value_and_grad)
    from repro_torch.model.lm import Stepper, make_loss_fn
    from repro_torch.optim.adamw import global_norm, init_opt_state, schedule
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    flash_ops = ops_by_name["flash_attention"]
    bf16 = torch.bfloat16
    torch.cuda.empty_cache()
    log(f"phase 19 start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated on the card by the earlier phases")

    def zero_counts():
        for mod in ops_by_name.values():
            mod.launches = 0
            if hasattr(mod, "launches_by_variant"):
                mod.launches_by_variant = dict.fromkeys(
                    mod.launches_by_variant, 0)

    # ---- (a) B5's gradient ------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    grad_times = {}
    for arch, (Bq, Sq, H, hd, KV) in B5_GRAD_CASES.items():
        q = randn(gen, Bq, Sq, H, hd, scale=0.5).to(bf16)
        k, v = (randn(gen, Bq, Sq, KV, hd, scale=0.5).to(bf16)
                .repeat_interleave(H // KV, dim=2) for _ in range(2))
        dout = randn(gen, Bq, Sq, H, hd).to(bf16)

        def fwd_bwd(fn):
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*qkv, True)
            return (out, *torch.autograd.grad(out, qkv, dout))

        zero_counts()
        got = fwd_bwd(flash_attention)
        torch.cuda.synchronize()
        if flash_ops.launches_by_variant != {"sm90": 1, "simt": 0}:
            raise AssertionError(f"B5 grad {arch}: forward launched "
                                 f"{flash_ops.launches_by_variant}")
        want = fwd_bwd(attention_ref)
        unequal = [name for name, g, w in zip("qkv", got[1:], want[1:])
                   if not torch.equal(g, w)]
        if unequal:
            raise AssertionError(f"B5 grad {arch}: d{unequal} differ from "
                                 "the plain version's")
        fwd_rel = rel_rms_by_block(got[0], attention_ref(
            q.float(), k.float(), v.float(), True))
        if fwd_rel > BF16_REL_RMS_BAR:
            raise AssertionError(f"B5 grad {arch}: forward block rel rms "
                                 f"{fwd_rel} > {BF16_REL_RMS_BAR}")
        del got, want
        times = {"flash": events_ms(lambda: fwd_bwd(flash_attention), 3),
                 "plain": events_ms(lambda: fwd_bwd(attention_ref), 3)}

        def sdpa():
            qkv = [t.detach().transpose(1, 2).requires_grad_(True)
                   for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*qkv, is_causal=True)
            return torch.autograd.grad(out, qkv, dout.transpose(1, 2))

        times["sdpa"] = events_ms(sdpa, 3)
        grad_times[arch] = times
        log(f"phase 19a B5 gradient at a {arch} layer ({Bq}, {Sq}, {H}, "
            f"{hd}) bf16 causal: dq, dk, dv = the plain version's bit for "
            f"bit; forward on sm90, block rel rms {fwd_rel:.5f} (bar "
            f"{BF16_REL_RMS_BAR}); forward + backward (CUDA events, eager): "
            f"B5 + plain VJP {times['flash']:.3f} ms, plain "
            f"{times['plain']:.3f} ms, scaled_dot_product_attention "
            f"{times['sdpa']:.3f} ms ({card})")
        del q, k, v, dout
        torch.cuda.empty_cache()

    # ---- (b) the slice: StableLM-3B at full width and depth ----------------
    cfg = get_config(TRAIN_ARCH)
    par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    shape = ShapeConfig(*TRAIN_SHAPE)
    st = Stepper(cfg, shape, SMOKE_MESH, par)
    n_params = param_count(st.schema)
    model_flops = 6.0 * n_params * shape.tokens
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                        global_batch=shape.global_batch, seed=SEED)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch_for_step(dcfg, 0).items()}

    def loss_and_grads(c, params, impl, dtype):
        fn = make_loss_fn(c, SMOKE_MESH, ParallelismConfig(
            compute_dtype=dtype, attn_impl=impl))
        (loss, _), grads = value_and_grad(fn, has_aux=True)(params, batch)
        if not torch.isfinite(loss):
            raise AssertionError(f"{c.name} {impl} {dtype}: loss {loss}")
        return loss.item(), grads

    t0 = time.perf_counter()
    params = st.init(seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 19b {TRAIN_ARCH}: {n_params:,} parameters ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of hd "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) drawn on the "
        f"card in f32 in {time.perf_counter() - t0:.2f} s")
    first = {}
    for impl in ("flash", "ref"):
        loss, grads = loss_and_grads(cfg, params, impl, "bfloat16")
        first[impl] = (loss, global_norm(grads).item())
        del grads
        torch.cuda.empty_cache()
    bar = cfg.n_layers ** 0.5 * 2.0 ** -7
    rel = {key: abs(first["flash"][i] - first["ref"][i]) / abs(
        first["ref"][i]) for i, key in enumerate(("loss", "gnorm"))}
    if max(rel.values()) > bar:
        raise AssertionError(f"{TRAIN_ARCH} bf16 first step, flash vs ref: "
                             f"{first}, rel {rel} > {bar}")
    log(f"phase 19b first step bf16, {cfg.n_layers} layers, flash vs ref "
        f"attention from one set of params: loss {first['flash'][0]:.6f} "
        f"vs {first['ref'][0]:.6f}, gnorm {first['flash'][1]:.6f} vs "
        f"{first['ref'][1]:.6f}; rel {rel['loss']:.3e}, {rel['gnorm']:.3e}"
        f" <= sqrt({cfg.n_layers}) * 2^-7 = {bar:.3e}")
    del params
    torch.cuda.empty_cache()
    cfg4 = cfg.with_(n_layers=TRAIN_REF_LAYERS)
    params4 = Stepper(cfg4, shape, SMOKE_MESH, par).init(seed=SEED + 1,
                                                         device="cuda")
    loss_f, grads_f = loss_and_grads(cfg4, params4, "flash", "float32")
    loss_r, grads_r = loss_and_grads(cfg4, params4, "ref", "float32")
    loss_rel = abs(loss_f - loss_r) / abs(loss_r)
    grad_rel = max(rel_rms(a, b) for a, b in zip(tree_leaves(grads_f),
                                                 tree_leaves(grads_r)))
    if loss_rel > F32_TRAIN_LOSS_TOL or grad_rel > F32_TRAIN_GRAD_TOL:
        raise AssertionError(f"{TRAIN_ARCH} f32 {TRAIN_REF_LAYERS} layers, "
                             f"flash vs ref: loss rel {loss_rel}, worst "
                             f"gradient leaf rel rms {grad_rel}")
    del grads_f, grads_r
    log(f"phase 19b first step f32, full width, {TRAIN_REF_LAYERS} layers, "
        f"flash vs ref: loss {loss_f:.7f} vs {loss_r:.7f} (rel "
        f"{loss_rel:.3e} <= {F32_TRAIN_LOSS_TOL}), worst gradient leaf rel "
        f"rms {grad_rel:.3e} <= {F32_TRAIN_GRAD_TOL}")

    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(st, dcfg, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
            ckpt_dir=td, log_every=1), device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {key: mod.launches for key, mod in ops_by_name.items()}
        variants = dict(flash_ops.launches_by_variant)
        peak = torch.cuda.max_memory_allocated()
    want = 2 * cfg.n_layers * TRAIN_STEPS
    if counts["flash_attention"] != want or variants != {
            "sm90": want, "simt": 0} or any(
            n for key, n in counts.items() if key != "flash_attention"):
        raise AssertionError(f"{TRAIN_ARCH} training: launches {counts}, "
                             f"B5 by variant {variants}, expected {want} "
                             "B5 sm90 and no other kernel")
    steps = out["metrics"]
    if out["steps"] != TRAIN_STEPS or len(steps) != TRAIN_STEPS or any(
            not math.isfinite(m["loss"]) for m in steps):
        raise AssertionError(f"{TRAIN_ARCH} training: {out['steps']} steps,"
                             f" metrics {steps}")
    for m in steps:
        lr = schedule(st.opt_cfg, torch.tensor(m["step"] + 1)).item()
        log(f"phase 19b step {m['step']}: loss {m['loss']:.6f}, gnorm "
            f"{m['gnorm']:.6f}, lr {lr:.6e}, {m['sec'] * 1e3:.1f} ms host "
            "clock (synchronised)")
    step_s = statistics.median(m["sec"] for m in steps[1:])
    share = model_flops / (BF16_FLOP_PER_S * step_s)
    state_bytes = 4 * 4 * n_params        # f32 params, grads, mu, nu
    log(f"phase 19b {TRAIN_ARCH} Trainer, {TRAIN_STEPS} steps of batch "
        f"{shape.global_batch} x {shape.seq_len} in {wall:.2f} s: median "
        f"step (steps 1-{TRAIN_STEPS - 1}) {step_s * 1e3:.1f} ms = "
        f"{shape.tokens / step_s:.0f} tokens/s; whole-step share of peak "
        f"{share:.4f} (6*N*D = {model_flops:.4e} FLOP / (989e12 x median "
        f"step)); peak device memory {peak / 1e9:.2f} GB beside the state's "
        f"{state_bytes / 1e9:.2f} GB (f32 params, grads, mu, nu); B5 "
        f"launches {counts['flash_attention']} = 2 x {cfg.n_layers} x "
        f"{TRAIN_STEPS}, by variant {json.dumps(variants)}; no other kernel "
        f"launched ({card})")
    # one more step under the profiler
    state, b = out["state"], tr._batch(TRAIN_STEPS)
    del out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._step_fn(state["params"], state["opt"], b)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    device: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(device.values())
    if busy == 0:
        log("phase 19b profile: device time not measured (the profiler saw "
            "no GPU activity)")
    else:
        b5 = sum(t for name, t in device.items() if "flash_fwd" in name)
        gemm = sum(t for name, t in device.items()
                   if GEMM_KERNEL.search(name) and "flash" not in name)
        # the backward node's range holds the plain VJP's kernels; its
        # evaluate_function range and the node's own name nest, so the
        # largest of them, not their sum
        vjp = max([getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0) for e in prof.key_averages()
            if "_FlashBackward" in e.key] or [0.0])
        vjp_ms = f"{vjp / 1e3:.1f} ms" if vjp else "not measured"
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 19b profile, one step: device busy {busy:.1f} ms of "
            f"{prof_wall:.1f} ms host clock (profiler on) = "
            f"{100 * busy / prof_wall:.1f}%; B5 {b5:.2f} ms, GEMMs "
            f"{gemm:.1f} ms, the attention VJP (under _FlashBackward) "
            f"{vjp_ms}; " + "; ".join(f"{name[:60]} {ms:.2f} ms"
                                      for name, ms in top))
    del state, b, tr
    torch.cuda.empty_cache()

    # phase 15's third cell: the train step through the host target
    host_batch = {k: torch.as_tensor(v, device="cuda")
                  for k, v in lm_batch_for_step(dcfg, 1).items()}
    host = host_deploy(
        cfg4, params4, TRAIN_SHAPE,
        lambda s: (params4, init_opt_state(params4), host_batch),
        flash_ops, card)
    del params4
    torch.cuda.empty_cache()

    # ---- (c) recovery on the card ------------------------------------------
    small = get_config("yi-9b", smoke=True)
    f32_flash = ParallelismConfig(compute_dtype="float32", attn_impl="flash")

    def mk(td, inj=None):
        s = Stepper(small, ShapeConfig("t", "train", 32, 8), SMOKE_MESH,
                    f32_flash)
        return Trainer(s, LMDataConfig(vocab_size=small.vocab_size,
                                       seq_len=32, global_batch=8, seed=7),
                       TrainerConfig(total_steps=RECOVERY_STEPS,
                                     ckpt_every=10, ckpt_dir=td,
                                     log_every=5),
                       injector=inj, device="cuda")

    with tempfile.TemporaryDirectory() as td:
        tr_a = mk(os.path.join(td, "a"),
                  FailureInjector(fail_at_steps=set(RECOVERY_FAILS)))
        hit = tr_a.train()
        clean = mk(os.path.join(td, "b")).train()
        if hit["recoveries"] != len(RECOVERY_FAILS) or hit["steps"] != \
                RECOVERY_STEPS:
            raise AssertionError(f"recovery: {hit['recoveries']} "
                                 f"recoveries, {hit['steps']} steps")
        l1 = {m["step"]: m["loss"] for m in hit["metrics"]}
        l2 = {m["step"]: m["loss"] for m in clean["metrics"]}
        worst = max(abs(l1[s] - l2[s]) for s in l1)
        if set(l1) != set(l2) or worst >= 1e-4:
            raise AssertionError(f"recovery: losses {l1} vs clean {l2}")
        final = max(max_err(a, b) for a, b in zip(
            tree_leaves(hit["state"]), tree_leaves(clean["state"])))
        step, state = tr_a.resume_elastic(Stepper(
            small, ShapeConfig("t2", "train", 64, 4), SMOKE_MESH, f32_flash))
        if step != 21 or any(t.device.type != "cuda"
                             for t in tree_leaves(state)):
            raise AssertionError(f"resume_elastic: step {step}")
        # a bf16 training state, written from the card and from the CPU,
        # restored onto the card bit for bit
        prm = Stepper(small, ShapeConfig("t", "train", 32, 8), SMOKE_MESH,
                      f32_flash).init(seed=3, device="cuda",
                                      dtype_override=bf16)
        saved = {"params": prm, "opt": init_opt_state(prm)}
        like = tree_map(torch.zeros_like, saved)
        for where, tree in (("card", saved), ("cpu", tree_map(
                lambda t: t.cpu(), saved))):
            path = os.path.join(td, f"bf16_{where}")
            save_checkpoint(path, 1, tree)
            back = load_checkpoint(path, 1, like)
            if any(a.device.type != "cuda" or a.dtype != b.dtype
                   or not torch.equal(a, b) for a, b in zip(
                       tree_leaves(back), tree_leaves(saved))):
                raise AssertionError(f"bf16 state written on the {where} "
                                     "does not restore bit for bit")
    log(f"phase 19c recovery on the card (yi-9b smoke, S 32, B 8, f32, "
        f"flash, {RECOVERY_STEPS} steps, failures at {RECOVERY_FAILS}): "
        f"{hit['recoveries']} recoveries, logged losses = the clean run's "
        f"within {worst:.3g} (bar 1e-4), final params max |diff| "
        f"{final:.3g}; resume_elastic onto another stepper at step {step}; "
        "a bf16 state written on the card and on the CPU restored onto the "
        "card bit for bit")

    # ---- (d) the launcher, in process --------------------------------------
    with tempfile.TemporaryDirectory() as td:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main(["--arch", "yi-9b", "--steps", "40",
                                    "--device", "cuda", "--ckpt-dir", td])
    lines = buf.getvalue().splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step")]
    if rc != 0 or len(losses) < 2 or not losses[-1] < losses[0]:
        raise AssertionError(f"launch.train: rc {rc}, output {lines}")
    log(f"phase 19d python -m repro_torch.launch.train --arch yi-9b --steps "
        f"40 --device cuda: rc 0, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        + " | ".join(lines))
    return {"train_launches": counts["flash_attention"],
            "host_train_launches": host["per_call"]}


# the LM families (phase 20): DeepSeek-MoE-16B served at full width and
# depth on phase 6's traffic; Qwen3-MoE-30B-A3B at full width and 8 of its
# 48 layers (its 48 layers hold 61 GB of bf16 weights); InternVL2-1B and
# whisper-tiny at their published sizes
MOE_SERVE_ARCH = "deepseek-moe-16b"
MOE_SERVE_PARAMS = 16_375_728_128
MOE_CUT_ARCH, MOE_CUT_LAYERS = "qwen3-moe-30b-a3b", 8
MOE_CUT_BATCH, MOE_CUT_SEQ = 2, 2048
VLM_ARCH, VLM_TEXT = "internvl2-1b", 1792   # + 256 patch embeddings
AUDIO_ARCH, AUDIO_PROMPT = "whisper-tiny", 64
FAMILY_DECODE_STEPS = 16
FAMILY_F32_LAYERS = 4                 # DeepSeek's f32 check, as phase 7's
F32_CARD_CPU_TOL = 1e-4               # f32 logits, card vs CPU (max abs)


@contextlib.contextmanager
def moe_ranges(moe_mod):
    """The MoE layer, its routed experts' FFN and its shared experts, each
    under a ``record_function`` range for the profiler (the port's own
    functions, wrapped for the scope)."""
    from torch.profiler import record_function

    saved = (moe_mod._expert_ffn, moe_mod._shared_ffn, dict(moe_mod.IMPLS))

    def labelled(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    moe_mod._expert_ffn = labelled("moe.experts", saved[0])
    moe_mod._shared_ffn = labelled("moe.shared", saved[1])
    for key, fn in saved[2].items():
        moe_mod.IMPLS[key] = labelled("moe.layer", fn)
    try:
        yield
    finally:
        moe_mod._expert_ffn, moe_mod._shared_ffn = saved[:2]
        moe_mod.IMPLS.update(saved[2])


MOE_RANGES = ("moe.layer", "moe.experts", "moe.shared")


def profile_moe_step(moe_mod, fn, label: str, card: str) -> None:
    """One ``fn()`` under ``torch.profiler`` with the MoE ranges on: device
    ms split into routed experts, shared experts, router/top-k/combine
    (the MoE layer's rest), B5 and everything else, and the busy share.
    A range's time is that of the kernels inside its device spans (the
    profiler's ``gpu_user_annotation`` events), not the spans'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with moe_ranges(moe_mod):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    spans: dict = {name: [] for name in MOE_RANGES}
    kernels = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name in spans:
            spans[e.name].append((start, end))
        else:
            kernels.append((e.name, start, end))
    busy = sum(end - start for _, start, end in kernels) / 1e3
    if busy == 0:
        log(f"phase 20 profile, {label}: device time not measured (the "
            "profiler saw no GPU activity)")
        return

    def inside(name):
        return sum(end - start for _, start, end in kernels if any(
            lo <= start and end <= hi for lo, hi in spans[name])) / 1e3

    b5 = sum(end - start for name, start, end in kernels
             if "flash_fwd" in name) / 1e3
    layer, experts, shared = (inside(name) for name in MOE_RANGES)
    if not spans["moe.layer"]:
        split = "MoE split not measured (no device spans for the ranges)"
    else:
        split = (f"routed experts {experts:.3f} ms, shared experts "
                 f"{shared:.3f} ms, router/top-k/combine "
                 f"{layer - experts - shared:.3f} ms")
    by_name: dict = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"phase 20 profile, {label}: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms host clock (profiler on) = {100 * busy / wall:.1f}%; "
        f"{split}; B5 {b5:.3f} ms; the rest {busy - layer - b5:.3f} ms; "
        + "; ".join(f"{name[:50]} {ms:.3f} ms" for name, ms in top)
        + f" ({card})")


def greedy_run(cfg, params, batch, par, steps: int, forced=None, mesh=None):
    """Prefill ``batch`` then ``steps`` greedy decode steps (fed
    ``forced`` (B, steps + 1) tokens instead of its own where given):
    (the last-position logits of each of the steps + 1 positions, f32 on
    the host, and the greedy tokens (B, steps + 1))."""
    import torch

    from repro_torch.core.types import SMOKE_MESH
    from repro_torch.model.lm import make_decode_step, make_prefill_step
    from repro_torch.model.transformer import pad_cache

    S = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, SMOKE_MESH, par, mesh)
    decode = make_decode_step(cfg, SMOKE_MESH, par, mesh)
    with torch.no_grad():
        logits, cache = prefill(params, batch)
        cache = pad_cache(cache, S + steps)
        outs = [logits.float().cpu()]
        for i in range(steps):
            tok = (forced[:, i] if forced is not None
                   else outs[-1].argmax(-1))
            logits, cache = decode(params, tok.reshape(-1, 1).to(
                batch["tokens"].device), cache)
            outs.append(logits.float().cpu())
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return outs, torch.stack([o.argmax(-1) for o in outs], dim=1)


@contextlib.contextmanager
def routes(moe_mod, record=None, replay=None):
    """The MoE router's expert choices: appended to the list ``record``,
    call by call, or taken from ``replay`` in the same order (the
    probabilities at those experts, so the combine weights follow)."""
    real = moe_mod.top_k
    it = iter(replay or ())

    def top_k(probs, k):
        if replay is None:
            vals, idx = real(probs, k)
            record.append(idx)
            return vals, idx
        idx = next(it)
        return probs.gather(-1, idx), idx

    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = real


def held_flash_vs_plain(cfg, params, batch, layers: int, steps: int,
                        flash_ops, card: str) -> dict:
    """The bf16 run with B5 against plain attention from one set of
    params, the plain run fed the flash run's greedy tokens. An MoE
    model's router turns bf16 noise into other experts at near-ties, a
    jump the bar's derivation (phase 7) does not cover; so the plain run
    is made twice, once routing on its own (its distance and the routing
    decisions that differ are printed) and once on the flash run's
    routes, which isolates the attention: every position's logits of that
    run within sqrt(layers) x 2^-7 relative rms (phase 7's bar). The
    greedy tokens' agreement is printed. Returns B5's launches in the
    flash run's prefill."""
    import torch

    from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
    from repro_torch.model import moe as moe_mod
    from repro_torch.model.lm import make_prefill_step

    def par(impl):
        return ParallelismConfig(compute_dtype="bfloat16", attn_impl=impl)

    bar = layers ** 0.5 * 2.0 ** -7
    flash_ops.launches = 0
    flash_ops.launches_by_variant = dict.fromkeys(
        flash_ops.launches_by_variant, 0)
    with torch.no_grad():
        make_prefill_step(cfg, SMOKE_MESH, par("flash"))(params, batch)
    torch.cuda.synchronize()
    b5 = dict(flash_ops.launches_by_variant)
    route_f, route_r = [], []
    with routes(moe_mod, record=route_f):
        lf, tf = greedy_run(cfg, params, batch, par("flash"), steps)
    with routes(moe_mod, record=route_r):
        lr, _ = greedy_run(cfg, params, batch, par("ref"), steps, forced=tf)

    def rels(lo):
        return [((a - b).norm() / b.norm()).item() for a, b in zip(lf, lo)]

    rel_free = rels(lr)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(lf, lr))
    n, shape = tf.numel(), tuple(batch["tokens"].shape)
    if route_f:
        with routes(moe_mod, replay=route_f):
            lp, _ = greedy_run(cfg, params, batch, par("ref"), steps,
                               forced=tf)
        rel = rels(lp)
        differ = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                     for a, b in zip(route_f, route_r))
        decisions = sum(a.shape[0] for a in route_f)
        routed = (f"routing on its own: worst rel rms {max(rel_free):.3e}, "
                  f"the experts of {differ} of {decisions} (token, layer) "
                  "routings differ; on the flash run's routes: ")
    else:
        rel, routed = rel_free, ""
    if max(rel) > bar:
        raise AssertionError(f"{cfg.name} bf16: flash vs plain logits rel "
                             f"rms {max(rel):.3e} > sqrt({layers}) * 2^-7 "
                             f"= {bar:.3e} ({rel})")
    log(f"phase 20 {cfg.name} bf16, {layers} layers, tokens {shape}: "
        "flash vs plain attention, the plain run fed the flash run's "
        f"tokens, over {len(rel)} positions' logits: {routed}worst rel rms "
        f"{max(rel):.3e} (prefill {rel[0]:.3e}) <= sqrt({layers}) * 2^-7 = "
        f"{bar:.3e}; greedy tokens agree on {agree}/{n}; B5 in the prefill "
        f"{json.dumps(b5)} ({card})")
    return {"b5": b5, "agree": agree, "n": n, "rel": max(rel)}


def held_f32(cfg, params, batch, steps: int, card: str, label: str,
             phase: str = "20", scans: bool = False) -> None:
    """The f32 run with B5 (``simt``) on the card, in IEEE f32 matmuls,
    against the same run on the CPU (plain attention) where ``params`` lie
    on the CPU (max abs within ``F32_CARD_CPU_TOL``), else against plain
    attention on the card (``F32_LOGIT_REL_TOL`` of the largest logit, as
    phase 7): identical greedy tokens (the other run fed the card's) and
    every position's logits within the bar.

    With ``scans`` (the hybrid and RWKV families) the card run goes
    through B6/B7, and it is also held against the same run on the card
    with the scan seams on the chunked forms and plain attention: within
    ``SCAN_F32_TOL`` of the largest logit (B6/B7's own bar), identical
    greedy tokens. A card-vs-CPU miss then calls a witness, the same run
    in float64 compute on the card (chunked forms, plain attention): the
    miss is the CPU's own f32 drift, printed as ROADMAP §C11's finding,
    only where the card lies no farther from the witness than the CPU
    does; otherwise it raises."""
    import torch

    from repro_torch.core.types import ParallelismConfig
    from repro_torch.model.layers import tree_leaves, tree_map
    from repro_torch.verify.conformance import exact_f32_matmul

    def par(impl, dtype="float32"):
        return ParallelismConfig(compute_dtype=dtype, attn_impl=impl)

    def max_abs(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    on_cpu = tree_leaves(params)[0].device.type == "cpu"
    card_params = tree_map(lambda t: t.to("cuda"), params)
    card_batch = {k: v.cuda() for k, v in batch.items()}
    with exact_f32_matmul():
        lg, tg = greedy_run(cfg, card_params, card_batch, par("flash"), steps)
        if scans:
            with chunked_scans():
                lc, tc = greedy_run(cfg, card_params, card_batch, par("ref"),
                                    steps, forced=tg)
            kc = max(((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(lg, lc))
            if kc > SCAN_F32_TOL or not torch.equal(tg, tc):
                raise AssertionError(
                    f"{cfg.name} f32 {label}: the kernels vs the chunked "
                    f"forms on the card, max|a-b|/max|b| {kc:.3e} "
                    f"(bar {SCAN_F32_TOL}), greedy tokens equal: "
                    f"{torch.equal(tg, tc)} ({card})")
        if on_cpu:
            lo, _ = greedy_run(cfg, params, batch, par("flash"), steps,
                               forced=tg)
        else:
            lo, _ = greedy_run(cfg, params, batch, par("ref"), steps,
                               forced=tg)
    if on_cpu:
        err = max_abs(lg, lo)
        bar, what = F32_CARD_CPU_TOL, "the card vs the CPU, max abs"
    else:
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(lg, lo))
        bar, what = F32_LOGIT_REL_TOL, ("flash vs plain on the card, "
                                        "max|flash-ref|/max|ref|")
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(lg, lo))
    cpu_drift, finding = False, ""
    if err > bar and same and scans and on_cpu:
        p64 = tree_map(lambda t: t.double(), card_params)
        with torch.no_grad(), chunked_scans():
            l64, _ = greedy_run(cfg, p64, card_batch, par("ref", "float64"),
                                steps, forced=tg)
        del p64
        card_f64, cpu_f64 = max_abs(lg, l64), max_abs(lo, l64)
        cpu_drift = card_f64 <= cpu_f64
        finding = (f" MISSES {bar}: the float64 witness lies "
                   f"{card_f64:.3e} from the card and {cpu_f64:.3e} from "
                   "the CPU"
                   + (", so the miss is the CPU's own f32 drift (ROADMAP "
                      "§C11), printed, not raised" if cpu_drift else ""))
    del card_params
    if (err > bar and not cpu_drift) or not same:
        raise AssertionError(f"{cfg.name} f32 {label}: {what} {err:.3e} "
                             f"(bar {bar}){finding}; greedy tokens equal: "
                             f"{same} ({card})")
    log(f"phase {phase} {cfg.name} f32 {label}: "
        + (f"the kernels vs the chunked forms on the card, max|a-b|/max|b| "
           f"{kc:.3e} <= {SCAN_F32_TOL}; " if scans else "")
        + f"{what} {err:.3e}" + (finding or f" <= {bar}") + f"; over "
        f"{steps + 1} positions greedy tokens identical ({tg.numel()}) "
        f"({card})")


def phase_families(ops_by_name: dict, card: str) -> dict:
    """Phase 20, the LM families on the card. (a) DeepSeek-MoE-16B at full
    width and depth (16,375,728,128 parameters, random bf16 weights drawn
    on the card, the router f32) serves phase 6's 8 requests through
    ``Server`` with B5 on 4 slots of 4,096 positions, every launch count
    set to 0 just before and read just after: B5 28 times a request, all
    ``sm90``, no other kernel; tokens/s, TTFT, ms a prefill and a decode
    tick, peak device memory; flash vs plain on one full-depth prefill in
    bf16 within phase 7's bar, and at full width and 4 layers in f32 with
    identical greedy tokens; one prefill and one decode tick profiled.
    (b) Qwen3-MoE-30B-A3B at full width and 8 layers: a 2,048-token
    prefill of 2 sequences and 16 decode steps, bf16 flash vs plain within
    sqrt(8) x 2^-7, and in f32 the card's tokens and logits against the
    CPU's; B5 8 times a prefill; ms a prefill and a decode step. (c)
    InternVL2-1B (256 patch embeddings + 1,792 tokens) and whisper-tiny
    (1,500 frames through the encoder, a 64-token decoder prefill) with 16
    decode steps each: bf16 flash vs plain within the bar, f32 card vs CPU
    within 1e-4 with identical greedy tokens; B5 24 and 4 times a prefill.
    Returns B5's launches by arch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.model import moe as moe_mod
    from repro_torch.model.layers import param_count, tree_map
    from repro_torch.model.lm import (Stepper, make_decode_step,
                                      make_prefill_step)
    from repro_torch.model.transformer import pad_cache
    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.runtime.server import Server, ServerConfig

    flash_ops = ops_by_name["flash_attention"]
    bf16 = torch.bfloat16
    torch.cuda.empty_cache()
    log(f"phase 20 start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated on the card by the earlier phases")

    def zero_counts():
        for mod in ops_by_name.values():
            mod.launches = 0
            if hasattr(mod, "launches_by_variant"):
                mod.launches_by_variant = dict.fromkeys(
                    mod.launches_by_variant, 0)

    launches = {}
    flash = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")

    # ---- (a) DeepSeek-MoE-16B served at full width and depth ---------------
    cfg = get_config(MOE_SERVE_ARCH)
    st = Stepper(cfg, ShapeConfig("serve", "prefill", MAX_LEN, SLOTS),
                 SMOKE_MESH, flash)
    n_params = param_count(st.schema)
    if n_params != MOE_SERVE_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} parameters")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = st.init(seed=SEED, device="cuda", dtype_override=bf16)
    torch.cuda.synchronize()
    router = params["g1"]["moe"]["router"]
    if router.dtype != torch.float32 or params["g1"]["moe"][
            "w_gate"].dtype != bf16:
        raise AssertionError(f"{cfg.name}: router {router.dtype}")
    m = cfg.moe
    log(f"phase 20a {cfg.name}: {n_params:,} parameters ({cfg.n_layers} "
        f"layers, the first dense with d_ff {m.d_ff_dense}; {m.n_experts} "
        f"routed experts top {m.top_k} of d_expert {m.d_expert}, "
        f"{m.n_shared} shared; d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of hd {cfg.hd}, vocab {cfg.vocab_size}) drawn on the card in bf16 "
        f"(router f32) in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak at "
        f"init {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    warm = Server(cfg, params, ServerConfig(batch_slots=1, max_len=64,
                                            eos_token=-1), SMOKE_MESH, flash)
    warm.submit(prompts[0], max_new_tokens=2)        # cuBLAS/allocator warm-up
    warm.run_until_drained()
    del warm
    srv = Server(cfg, params, ServerConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                           eos_token=-1), SMOKE_MESH, flash)
    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for prompt in prompts:
        srv.submit(prompt, max_new_tokens=MAX_NEW)
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {key: mod.launches for key, mod in ops_by_name.items()}
    variants = dict(flash_ops.launches_by_variant)
    set_tracer(prev_tracer)
    peak = torch.cuda.max_memory_allocated()
    stats = done.stats
    if not done.drained or stats.admitted != len(prompts) or \
            stats.retired != len(prompts):
        raise AssertionError(f"{cfg.name}: server did not serve every "
                             f"request: {stats}")
    for req in done:
        if len(req.out_tokens) != MAX_NEW or not all(
                0 <= t < cfg.padded_vocab for t in req.out_tokens):
            raise AssertionError(f"{cfg.name}: request {req.rid} "
                                 f"out_tokens {req.out_tokens}")
    want = cfg.n_layers * len(prompts)
    if counts["flash_attention"] != want or variants != {
            "sm90": want, "simt": 0} or any(
            n for key, n in counts.items() if key != "flash_attention"):
        raise AssertionError(f"{cfg.name}: launches {counts}, B5 by "
                             f"variant {variants}, expected {want} B5 sm90 "
                             "and no other kernel")
    launches[cfg.name] = counts["flash_attention"]
    n_tok = sum(len(r.out_tokens) for r in done)
    prefill_ms = {sp.attrs["prompt_len"]: sp.duration * 1e3
                  for sp in find_spans(tracer.spans, "server.prefill")}
    tick_ms = sorted(sp.duration * 1e3
                     for sp in find_spans(tracer.spans, "server.decode"))
    log(f"phase 20a served {cfg.name}: {len(done)} requests, {n_tok} tokens "
        f"in {wall:.3f} s = {n_tok / wall:.2f} tokens/s ({SLOTS} slots, "
        f"max_len {MAX_LEN}, {stats.ticks} ticks); B5 launches "
        f"{counts['flash_attention']} = {cfg.n_layers} per request, by "
        f"variant {json.dumps(variants)}; no other kernel launched; peak "
        f"device memory {peak / 1e9:.2f} GB ({card})")
    log("phase 20a ttft_s " + json.dumps(stats.ttft_s))
    log("phase 20a latency_s " + json.dumps(stats.latency_s))
    log("phase 20a prefill ms by prompt length (host clock, ends in the "
        "first token's copy to the host): " + ", ".join(
            f"{n}: {prefill_ms[n]:.1f}" for n in PROMPT_LENS)
        + f"; decode tick ms (host clock, {len(tick_ms)} ticks): median "
        f"{tick_ms[len(tick_ms) // 2]:.2f}, min {tick_ms[0]:.2f}, max "
        f"{tick_ms[-1]:.2f}")
    del srv
    # flash vs plain at full depth on one prefill (bf16), then the served
    # first token against the flash prefill's
    i2k = PROMPT_LENS.index(2048)
    one = {"tokens": torch.tensor([prompts[i2k]], dtype=torch.int64,
                                  device="cuda")}
    held = held_flash_vs_plain(cfg, params, one, cfg.n_layers, 0, flash_ops,
                               card)
    with torch.no_grad():
        first = int(make_prefill_step(cfg, SMOKE_MESH, flash)(
            params, one)[0].argmax())
    if first != done[i2k].out_tokens[0]:
        raise AssertionError(f"{cfg.name}: served first token "
                             f"{done[i2k].out_tokens[0]} != the flash "
                             f"prefill's {first}")
    # one 2,048-token prefill and one decode tick of 4 slots over 4,096
    # positions, half filled, profiled
    prefill = make_prefill_step(cfg, SMOKE_MESH, flash)
    decode = make_decode_step(cfg, SMOKE_MESH, flash)
    with torch.no_grad():
        _, cache = prefill(params, one)
        pool = {"layers": tuple(
            {key: torch.cat([buf] * SLOTS) for key, buf in c.items()}
            for c in pad_cache(cache, MAX_LEN)["layers"])}
        del cache
        last = torch.zeros((SLOTS, 1), dtype=torch.int64, device="cuda")
        profile_moe_step(moe_mod, lambda: prefill(params, one),
                         f"one 2048-token prefill, {cfg.n_layers} layers",
                         card)
        profile_moe_step(moe_mod, lambda: decode(params, last, pool),
                         f"one decode tick of {SLOTS} slots over a "
                         f"{MAX_LEN}-position cache, {cfg.n_layers} layers",
                         card)
    del pool, prefill, decode
    torch.cuda.empty_cache()
    # phase 23 on these weights (before they are freed)
    launches["collectives"] = phase_collectives(ops_by_name, card, cfg,
                                                params)
    del params
    torch.cuda.empty_cache()
    # f32 at full width and 4 layers: identical greedy tokens
    cfg4 = cfg.with_(n_layers=FAMILY_F32_LAYERS)
    p4 = Stepper(cfg4, ShapeConfig("check", "prefill", MAX_LEN, 1),
                 SMOKE_MESH, flash).init(seed=SEED + 1, device="cuda")
    for prompt in prompts:
        held_f32(cfg4, p4, {"tokens": torch.tensor(
            [prompt], dtype=torch.int64, device="cuda")}, 0, card,
            f"full width, {FAMILY_F32_LAYERS} layers, S={len(prompt)}")
    del p4
    torch.cuda.empty_cache()

    # ---- (b) Qwen3-MoE-30B-A3B at full width, 8 layers ---------------------
    cfg = get_config(MOE_CUT_ARCH).with_(n_layers=MOE_CUT_LAYERS)
    st = Stepper(cfg, ShapeConfig("p", "prefill", MOE_CUT_SEQ,
                                  MOE_CUT_BATCH), SMOKE_MESH, flash)
    t0 = time.perf_counter()
    params = st.init(seed=SEED, device="cuda", dtype_override=bf16)
    torch.cuda.synchronize()
    log(f"phase 20b {cfg.name} at {MOE_CUT_LAYERS} of 48 layers: "
        f"{param_count(st.schema):,} parameters ({cfg.moe.n_experts} "
        f"experts top {cfg.moe.top_k} of d_expert {cfg.moe.d_expert}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, qk-norm, hd {cfg.hd}) drawn in "
        f"bf16 in {time.perf_counter() - t0:.2f} s")
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (
        MOE_CUT_BATCH, MOE_CUT_SEQ)), device="cuda")
    held = held_flash_vs_plain(cfg, params, {"tokens": toks}, cfg.n_layers,
                               FAMILY_DECODE_STEPS, flash_ops, card)
    if held["b5"] != {"sm90": cfg.n_layers, "simt": 0}:
        raise AssertionError(f"{cfg.name}: B5 per prefill {held['b5']}")
    launches[cfg.name] = held["b5"]["sm90"]
    prefill = make_prefill_step(cfg, SMOKE_MESH, flash)
    decode = make_decode_step(cfg, SMOKE_MESH, flash)
    with torch.no_grad():
        _, cache = prefill(params, {"tokens": toks})
        cache = pad_cache(cache, MOE_CUT_SEQ + FAMILY_DECODE_STEPS)
        nxt = toks[:, -1:]
        ms_p = host_ms(lambda: prefill(params, {"tokens": toks}), 3)
        ms_d = host_ms(lambda: decode(params, nxt, cache), 5)
    log(f"phase 20b {cfg.name} {MOE_CUT_LAYERS} layers bf16 flash: one "
        f"prefill of {MOE_CUT_BATCH} x {MOE_CUT_SEQ} tokens {ms_p:.2f} ms, "
        f"one decode step of {MOE_CUT_BATCH} sequences {ms_d:.2f} ms (host "
        f"clock, synchronised; the dense oracle runs all "
        f"{cfg.moe.n_experts} experts on every token) ({card})")
    del params, cache, prefill, decode
    torch.cuda.empty_cache()
    p32 = st.init(seed=SEED + 2, device="cuda")
    held_f32(cfg, p32, {"tokens": toks}, FAMILY_DECODE_STEPS, card,
             f"{MOE_CUT_LAYERS} layers, {MOE_CUT_BATCH} x {MOE_CUT_SEQ} + "
             f"{FAMILY_DECODE_STEPS} steps")
    del p32
    torch.cuda.empty_cache()

    # ---- (c) InternVL2-1B and whisper-tiny at their published sizes --------
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = get_config(arch)
        if arch == VLM_ARCH:
            batch = {"tokens": torch.as_tensor(rng.integers(
                2, cfg.vocab_size, (1, cfg.n_frontend_tokens + VLM_TEXT))),
                "patches": torch.as_tensor(rng.standard_normal(
                    (1, cfg.n_frontend_tokens, cfg.frontend_dim)),
                    dtype=torch.float32)}
        else:
            batch = {"tokens": torch.as_tensor(rng.integers(
                2, cfg.vocab_size, (1, AUDIO_PROMPT))),
                "frames": torch.as_tensor(rng.standard_normal(
                    (1, cfg.encoder.n_positions, cfg.frontend_dim)),
                    dtype=torch.float32)}
        st = Stepper(cfg, ShapeConfig("p", "prefill", 2048, 1), SMOKE_MESH,
                     flash)
        p32 = st.init(seed=SEED + 3, device="cpu")
        params = tree_map(lambda t: t.to("cuda", bf16), p32)
        cuda_batch = {k: v.cuda() for k, v in batch.items()}
        held = held_flash_vs_plain(cfg, params, cuda_batch, cfg.n_layers,
                                   FAMILY_DECODE_STEPS, flash_ops, card)
        if held["b5"] != {"sm90": cfg.n_layers, "simt": 0}:
            raise AssertionError(f"{cfg.name}: B5 per prefill {held['b5']}")
        launches[cfg.name] = held["b5"]["sm90"]
        with torch.no_grad():
            ms_p = host_ms(lambda: make_prefill_step(
                cfg, SMOKE_MESH, flash)(params, cuda_batch), 3)
        log(f"phase 20c {cfg.name} ({param_count(st.schema):,} parameters, "
            f"batch {json.dumps({k: list(v.shape) for k, v in batch.items()})}"
            f"): one bf16 flash prefill {ms_p:.2f} ms (host clock, "
            f"synchronised) ({card})")
        del params
        torch.cuda.empty_cache()
        held_f32(cfg, p32, batch, FAMILY_DECODE_STEPS, card,
                 f"prefill + {FAMILY_DECODE_STEPS} steps")
        del p32
    return launches


# the collectives on one card (phase 23): the EP impls' serving run, their
# f32 parity (full width, 4 layers) and the mesh trainer (StableLM-3B at 8
# of its 32 layers, phase 19's shape)
EP_IMPLS = ("psum", "a2a", "dense")
EP_PROMPT, EP_REQUESTS = 2048, 4
EP_F32_LAYERS, EP_F32_STEPS, EP_F32_TOL = 4, 4, 1e-4
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 8, 2


@contextlib.contextmanager
def world_of_one():
    """A ``torch.distributed`` NCCL group of one rank (the card) and the
    (1, 1) ("data", "model") mesh on it; the group is destroyed on the way
    out, so that no later phase sees it."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as td:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            td, "store"), rank=0, world_size=1)
        try:
            yield make_smoke_mesh((1, 1))
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def routed(moe_mod, record: list):
    """Every router call's (tokens, expert ids), appended to ``record``."""
    real = moe_mod._router

    def router(p, x, m, *args, **kw):
        out = real(p, x, m, *args, **kw)
        record.append((x.shape[0], out[1].detach()))
        return out

    moe_mod._router = router
    try:
        yield
    finally:
        moe_mod._router = real


def dropped(moe_mod, record: list, m, impl: str) -> tuple:
    """(assignments the capacity dropped, assignments routed) over the
    router calls in ``record`` on a model axis of 1: ``moe_psum`` keeps
    each expert's ``_capacity(T)`` heaviest tokens, ``moe_a2a`` its one
    destination's ``_capacity(T) * top_k`` heaviest assignments."""
    import torch

    drop = total = 0
    for t, ids in record:
        total += ids.numel()
        if impl == "psum":
            cap = min(moe_mod._capacity(t, m), t)
            per = torch.bincount(ids.reshape(-1), minlength=m.n_experts)
            drop += int(torch.clamp(per - cap, min=0).sum())
        elif impl == "a2a":
            drop += max(0, ids.numel() - min(
                moe_mod._capacity(t, m) * m.top_k, t * m.top_k))
    return drop, total


def phase_collectives(ops_by_name: dict, card: str, cfg, params) -> dict:
    """Phase 23, the collectives on one card: a ``torch.distributed`` NCCL
    group of world size 1 and the (1, 1) mesh on it, started here and
    destroyed at the end. It runs inside phase 20, on phase 20's
    DeepSeek-MoE-16B weights (full width and depth, bf16), before they are
    freed. (a) ``Server(mesh=)`` with each of ``impl="psum"``, ``"a2a"``
    and ``"dense"``: 4 requests of 2,048 prompt tokens and 16 new ones;
    prefill ms, median tick ms, tokens/s, the assignments the capacity
    dropped (at the config's 1.25 the EP impls drop, as the reference's),
    B5 launches (28 a request, all ``sm90``). (b) full width, 4 layers,
    f32, ``capacity_factor = n_experts / top_k`` (nothing dropped): a
    2,048-token prefill and 4 greedy steps through each impl, the logits
    within 1e-4 of the largest of ``dense``'s, greedy tokens identical.
    (c) StableLM-3B at full width and 8 of 32 layers, phase 19's shape,
    ``grad_compression=True``: 2 ``Trainer`` steps on the mesh give the
    meshless ``Stepper``'s losses bit for bit (compression needs more than
    one rank); the mesh trainer's checkpoint restored by
    ``resume_elastic`` with the mesh's shardings equals the trained state
    bit for bit, and the next step's loss on it equals the meshless
    resume's. Returns B5's launches in (a) by impl."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model import moe as moe_mod
    from repro_torch.model.layers import tree_leaves
    from repro_torch.model.lm import Stepper
    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.verify.conformance import exact_f32_matmul

    flash_ops = ops_by_name["flash_attention"]
    flash = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(2, cfg.vocab_size, EP_PROMPT).tolist()
               for _ in range(EP_REQUESTS)]
    launches = {}

    def zero_counts():
        for mod in ops_by_name.values():
            mod.launches = 0
            if hasattr(mod, "launches_by_variant"):
                mod.launches_by_variant = dict.fromkeys(
                    mod.launches_by_variant, 0)

    with world_of_one() as mesh:
        log(f"phase 23 NCCL process group of world size 1, mesh "
            f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names} on "
            f"{torch.cuda.get_device_name(0)}")
        # ---- (a) EP serving at full width and depth ----------------------
        for impl in EP_IMPLS:
            c = cfg.with_(moe=dataclasses.replace(cfg.moe, impl=impl))
            srv = Server(c, params, ServerConfig(
                batch_slots=EP_REQUESTS, max_len=EP_PROMPT + MAX_NEW,
                eos_token=-1), SMOKE_MESH, flash, mesh=mesh)
            warm = Server(c, params, ServerConfig(batch_slots=1, max_len=64,
                                                  eos_token=-1), SMOKE_MESH,
                          flash, mesh=mesh)
            warm.submit(prompts[0][:32], max_new_tokens=2)
            warm.run_until_drained()
            del warm
            tracer, record = Tracer(), []
            prev = set_tracer(tracer)
            zero_counts()
            t0 = time.perf_counter()
            with routed(moe_mod, record):
                for prompt in prompts:
                    srv.submit(prompt, max_new_tokens=MAX_NEW)
                done = srv.run_until_drained()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            set_tracer(prev)
            counts = {key: mod.launches for key, mod in ops_by_name.items()}
            variants = dict(flash_ops.launches_by_variant)
            want = cfg.n_layers * EP_REQUESTS
            if not done.drained or len(done) != EP_REQUESTS or any(
                    len(r.out_tokens) != MAX_NEW for r in done):
                raise AssertionError(f"phase 23a {impl}: not every request "
                                     f"served: {done.stats}")
            if variants != {"sm90": want, "simt": 0} or any(
                    n for key, n in counts.items()
                    if key != "flash_attention"):
                raise AssertionError(f"phase 23a {impl}: launches {counts}, "
                                     f"B5 {variants}, expected {want} sm90")
            launches[impl] = counts["flash_attention"]
            drop, total = dropped(moe_mod, record, cfg.moe, impl)
            pre = [sp.duration * 1e3
                   for sp in find_spans(tracer.spans, "server.prefill")]
            ticks = sorted(sp.duration * 1e3
                           for sp in find_spans(tracer.spans,
                                                "server.decode"))
            n_tok = sum(len(r.out_tokens) for r in done)
            log(f"phase 23a {cfg.name} impl={impl} on the (1, 1) mesh: "
                f"{EP_REQUESTS} requests of {EP_PROMPT} + {MAX_NEW} tokens "
                f"in {wall:.3f} s = {n_tok / wall:.2f} tokens/s; prefill ms "
                f"(host clock) median {sorted(pre)[len(pre) // 2]:.1f} "
                f"({', '.join(f'{v:.1f}' for v in pre)}); decode tick ms "
                f"median {ticks[len(ticks) // 2]:.2f} ({len(ticks)} ticks); "
                f"assignments dropped by capacity {drop} of {total} "
                f"(capacity_factor {cfg.moe.capacity_factor}); B5 launches "
                f"{json.dumps(variants)} = {cfg.n_layers} a request ({card})")
            del srv, done, record
            torch.cuda.empty_cache()

        # ---- (b) EP parity: full width, 4 layers, f32, nothing dropped ---
        m = cfg.moe
        c4 = cfg.with_(n_layers=EP_F32_LAYERS, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        p4 = Stepper(c4, ShapeConfig("check", "prefill", EP_PROMPT, 1),
                     SMOKE_MESH, flash).init(seed=SEED + 23, device="cuda")
        one = {"tokens": torch.tensor([prompts[0]], dtype=torch.int64,
                                      device="cuda")}
        f32 = ParallelismConfig(compute_dtype="float32", attn_impl="flash")
        runs = {}
        with exact_f32_matmul():
            for impl in ("dense", "psum", "a2a"):
                ci = c4.with_(moe=dataclasses.replace(c4.moe, impl=impl))
                record = []
                t0 = time.perf_counter()
                with routed(moe_mod, record):
                    runs[impl] = greedy_run(ci, p4, one, f32, EP_F32_STEPS,
                                            mesh=mesh)
                torch.cuda.synchronize()
                d, total = dropped(moe_mod, record, ci.moe, impl)
                if d:
                    raise AssertionError(f"phase 23b {impl}: {d} of {total} "
                                         "assignments dropped")
                runs[impl] += (time.perf_counter() - t0,)
        want_logits, want_tok, _ = runs["dense"]
        scale = max(o.abs().max().item() for o in want_logits)
        for impl in ("psum", "a2a"):
            logits, tok, sec = runs[impl]
            err = max((a - b).abs().max().item()
                      for a, b in zip(logits, want_logits))
            if err > EP_F32_TOL * scale or not torch.equal(tok, want_tok):
                raise AssertionError(
                    f"phase 23b {impl}: logits max abs {err} (bar "
                    f"{EP_F32_TOL} x {scale}), tokens {tok.tolist()} vs "
                    f"dense {want_tok.tolist()}")
            log(f"phase 23b {c4.name} full width, {EP_F32_LAYERS} layers, "
                f"f32, capacity_factor {c4.moe.capacity_factor:.4f} (no "
                f"assignment dropped): impl={impl} vs dense on a "
                f"{EP_PROMPT}-token prefill + {EP_F32_STEPS} greedy steps: "
                f"logits max abs {err:.3e} <= {EP_F32_TOL} x {scale:.3f}, "
                f"greedy tokens identical {tok.tolist()}; {sec:.2f} s "
                f"(dense {runs['dense'][2]:.2f} s, host clock) ({card})")
        del p4, runs
        torch.cuda.empty_cache()

        # ---- (c) the mesh trainer and the reshard ------------------------
        tcfg = get_config(TRAIN_ARCH).with_(n_layers=MESH_TRAIN_LAYERS)
        par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash",
                                grad_compression=True)
        shape = ShapeConfig(*TRAIN_SHAPE)
        dcfg = LMDataConfig(vocab_size=tcfg.vocab_size,
                            seq_len=shape.seq_len,
                            global_batch=shape.global_batch, seed=SEED)
        st0 = Stepper(tcfg, shape, SMOKE_MESH, par)
        st1 = Stepper(tcfg, shape, SMOKE_MESH, par, mesh=mesh)
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            tr0 = Trainer(st0, dcfg, TrainerConfig(
                total_steps=MESH_TRAIN_STEPS, ckpt_every=MESH_TRAIN_STEPS + 1,
                ckpt_dir=td, log_every=1), device="cuda")
            loss0 = [r["loss"] for r in tr0.train()["metrics"]]
            t_meshless = time.perf_counter() - t0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            tr1 = Trainer(st1, dcfg, TrainerConfig(
                total_steps=MESH_TRAIN_STEPS, ckpt_every=1, ckpt_dir=td,
                log_every=1), device="cuda")
            out1 = tr1.train()
            loss1 = [r["loss"] for r in out1["metrics"]]
            t_mesh = time.perf_counter() - t0
            if loss1 != loss0:
                raise AssertionError(f"phase 23c: mesh losses {loss1} != "
                                     f"meshless {loss0}")
            trained = out1["state"]
            t0 = time.perf_counter()
            step, restored = tr1.resume_elastic(
                st1, shardings=st1.state_shardings())
            t_restore = time.perf_counter() - t0
            unequal = sum(not torch.equal(a, b) for a, b in zip(
                tree_leaves(restored), tree_leaves(trained)))
            n_leaves = len(tree_leaves(trained))
            del trained, out1
            if step != MESH_TRAIN_STEPS or unequal:
                raise AssertionError(f"phase 23c: resumed at {step}, "
                                     f"{unequal} of {n_leaves} leaves differ")
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in lm_batch_for_step(dcfg, step).items()}
            _, _, m1 = st1.train_fn(donate=True)(
                restored["params"], restored["opt"], batch)
            next1 = m1["loss"].item()
            del restored, m1
            torch.cuda.empty_cache()
            step0, restored0 = tr0.resume_elastic(st0)
            _, _, m0 = st0.train_fn(donate=True)(
                restored0["params"], restored0["opt"], batch)
            next0 = m0["loss"].item()
            del restored0, m0
            if step0 != step or next1 != next0:
                raise AssertionError(f"phase 23c: next loss on the mesh "
                                     f"{next1} != meshless resume's {next0}")
        log(f"phase 23c {TRAIN_ARCH} full width, {MESH_TRAIN_LAYERS} of 32 "
            f"layers, {shape.global_batch} x {shape.seq_len}, bf16, "
            f"grad_compression=True: {MESH_TRAIN_STEPS} steps on the (1, 1) "
            f"mesh, losses {loss1} = the meshless Stepper's bit for bit "
            f"({t_mesh:.2f} s vs {t_meshless:.2f} s with the checkpoint, "
            f"host clock); resume_elastic with the mesh's shardings at step "
            f"{step}: {n_leaves} leaves equal the trained state bit for bit "
            f"({t_restore:.2f} s); next loss {next1!r} = the meshless "
            f"resume's ({card})")
    log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s; the process "
        f"group is destroyed ({card})")
    return launches


# the hybrid and RWKV families (phase 21), served at full width and depth
SCAN_FAMILIES = {"zamba2-7b": ("ssd", 6_981_758_032),
                 "rwkv6-7b": ("wkv6", 7_577_026_560)}
# the f32 check's depth: Zamba2's first shared block follows its 6th layer
SCAN_F32_LAYERS = {"zamba2-7b": 6, "rwkv6-7b": 4}
SCAN_F32_TOL = 1e-4                  # B6/B7's own bar (tests/test_kernels.py)
SCAN_F32_STEPS = 2
# a bar whose miss is a recorded finding (ROADMAP §C), by (arch, check):
# printed beside the bar, not raised; every other miss raises
RECORDED_MISSES = {("rwkv6-7b", "bf16"): "§C8"}
SCAN_KERNEL = re.compile(r"ssd_|wkv6_|carry_kernel")


@contextlib.contextmanager
def chunked_scans():
    """The Mamba-2 and RWKV-6 blocks' scan seams (``model/ssm.py::
    _ssd_scan``, ``model/rwkv.py::_wkv_scan``) pointed at the chunked
    forms, the kernels' plain mirrors, on every device."""
    from repro_torch.model import rwkv, ssm

    saved = ssm._ssd_scan, rwkv._wkv_scan
    ssm._ssd_scan = lambda x, dt, A, Bm, Cm, chunk, h0, mode: \
        ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    rwkv._wkv_scan = lambda r, k, v, w, u, h0, chunk, mode: \
        rwkv.wkv6_chunked(r, k, v, w, u, h0=h0, chunk=chunk)
    try:
        yield
    finally:
        ssm._ssd_scan, rwkv._wkv_scan = saved


def profile_scan_step(fn, label: str, card: str) -> None:
    """One ``fn()`` under ``torch.profiler``: device ms split into the
    scan kernel's passes (B6 or B7), B5, the GEMMs and the rest, and the
    busy share of the host clock."""
    fn()
    wall, device = profile_ms(fn)
    busy = sum(device.values())
    if busy == 0:
        log(f"phase 21 profile, {label}: device time not measured (the "
            "profiler saw no GPU activity)")
        return
    scan = sum(t for name, t in device.items() if SCAN_KERNEL.search(name))
    b5 = sum(t for name, t in device.items() if "flash_fwd" in name)
    gemm = sum(t for name, t in device.items()
               if GEMM_KERNEL.search(name) and "flash" not in name)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:5]
    log(f"phase 21 profile, {label}: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms host clock (profiler on) = {100 * busy / wall:.1f}%;"
        f" scan kernel {scan:.3f} ms, B5 {b5:.3f} ms, GEMMs {gemm:.3f} ms, "
        f"the rest {busy - scan - b5 - gemm:.3f} ms; " + "; ".join(
            f"{name[:50]} {ms:.3f} ms" for name, ms in top) + f" ({card})")


def bf16_vs_f32(cfg, params, batch, bf16_read: dict, kernels: dict,
                card: str) -> None:
    """The bf16 prefill's last-position logits through the kernels
    (``bf16_read["kernels"]``, B6/B7 and B5) against those through the
    chunked forms with plain attention (``bf16_read["chunked"]``, the
    reference's bf16 semantics), held to phase 7's bar sqrt(L) x 2^-7;
    only a miss listed in ``RECORDED_MISSES`` is printed and not raised.
    Each is also read against the f32 run of the same bf16 weights
    (chunked forms, plain attention, IEEE f32 matmuls): how far bf16
    itself takes this model, the card's side of ROADMAP §C8."""
    import torch

    from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
    from repro_torch.model.layers import tree_map
    from repro_torch.model.lm import make_prefill_step
    from repro_torch.verify.conformance import exact_f32_matmul

    p32 = tree_map(lambda t: t.float(), params)
    with exact_f32_matmul(), torch.no_grad(), chunked_scans():
        lf = make_prefill_step(cfg, SMOKE_MESH, ParallelismConfig(
            compute_dtype="float32", attn_impl="ref"))(p32, batch)[0]
    lf = lf.float().cpu()
    del p32
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    lk, lc = bf16_read["kernels"], bf16_read["chunked"]
    bar = cfg.n_layers ** 0.5 * 2.0 ** -7
    kc, kf, cf = rel(lk, lc), rel(lk, lf), rel(lc, lf)
    recorded = RECORDED_MISSES.get((cfg.name, "bf16"))
    if kc > bar and recorded is None:
        raise AssertionError(
            f"{cfg.name} bf16: the kernels' last-position logits are "
            f"{kc:.3e} (rel rms) from the chunked forms' > sqrt("
            f"{cfg.n_layers}) * 2^-7 = {bar:.3e}; from the f32 run: the "
            f"kernels {kf:.3e}, the chunked forms {cf:.3e} ({card})")
    verdict = (f"<= sqrt({cfg.n_layers}) * 2^-7 = {bar:.3e}" if kc <= bar
               else f"MISSES sqrt({cfg.n_layers}) * 2^-7 = {bar:.3e} "
               f"(recorded: ROADMAP {recorded})")
    log(f"phase 21 {cfg.name} bf16, {cfg.n_layers} layers, one "
        f"{batch['tokens'].shape[1]}-token prefill: last-position logits "
        f"rel rms of the kernels ({json.dumps(kernels)}) vs the chunked "
        f"forms with plain attention {kc:.3e} {verdict}; from the f32 run "
        f"of the same weights: the kernels {kf:.3e}, the chunked forms "
        f"{cf:.3e}; first tokens {int(lk.argmax())}, {int(lc.argmax())}, "
        f"f32 {int(lf.argmax())}; the served first token is the kernel "
        f"prefill's ({card})")


def phase_scan_families(ops_by_name: dict, card: str) -> dict:
    """Phase 21, the hybrid and RWKV families on the card (see the module
    docstring). Returns each model's launches of its scan kernel and, for
    Zamba2, of B5."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.model.layers import param_count
    from repro_torch.model.lm import (Stepper, make_decode_step,
                                      make_prefill_step)
    from repro_torch.model.transformer import pad_cache
    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.runtime.server import Server, ServerConfig

    flash_ops = ops_by_name["flash_attention"]
    bf16 = torch.bfloat16
    flash = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    plain = ParallelismConfig(compute_dtype="bfloat16", attn_impl="ref")
    torch.cuda.empty_cache()
    log(f"phase 21 start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated on the card by the earlier phases")

    def zero_counts():
        for mod in ops_by_name.values():
            mod.launches = 0
            if hasattr(mod, "launches_by_variant"):
                mod.launches_by_variant = dict.fromkeys(
                    mod.launches_by_variant, 0)

    launches: dict = {}
    for arch, (kernel, want_params) in SCAN_FAMILIES.items():
        cfg = get_config(arch)
        st = Stepper(cfg, ShapeConfig("serve", "prefill", MAX_LEN, SLOTS),
                     SMOKE_MESH, flash)
        n_params = param_count(st.schema)
        if n_params != want_params:
            raise AssertionError(f"{arch}: {n_params} parameters")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = st.init(seed=SEED, device="cuda", dtype_override=bf16)
        torch.cuda.synchronize()
        n_shared = len(cfg.shared_attn_points())
        log(f"phase 21 {arch}: {n_params:,} parameters ({cfg.n_layers} "
            f"{'Mamba-2' if kernel == 'ssd' else 'RWKV-6'} layers"
            + (f", a shared attention block after {n_shared} of them "
               f"({cfg.n_heads} heads of hd {cfg.hd} at width "
               f"{2 * cfg.d_model})" if n_shared else "")
            + f"; d_model {cfg.d_model}, vocab {cfg.vocab_size}) drawn on "
            f"the card in bf16 in {time.perf_counter() - t0:.2f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
            f"at init {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        rng = np.random.default_rng(SEED + 21)
        prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS]
        warm = Server(cfg, params, ServerConfig(batch_slots=1, max_len=64,
                                                eos_token=-1), SMOKE_MESH,
                      flash)
        warm.submit(prompts[0], max_new_tokens=2)    # cuBLAS/allocator warm-up
        warm.run_until_drained()
        del warm
        srv = Server(cfg, params, ServerConfig(
            batch_slots=SLOTS, max_len=MAX_LEN, eos_token=-1), SMOKE_MESH,
            flash)
        tracer = Tracer()
        prev_tracer = set_tracer(tracer)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        for prompt in prompts:
            srv.submit(prompt, max_new_tokens=MAX_NEW)
        done = srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {key: mod.launches for key, mod in ops_by_name.items()}
        variants = dict(flash_ops.launches_by_variant)
        set_tracer(prev_tracer)
        peak = torch.cuda.max_memory_allocated()
        stats = done.stats
        if not done.drained or stats.admitted != len(prompts) or \
                stats.retired != len(prompts):
            raise AssertionError(f"{arch}: server did not serve every "
                                 f"request: {stats}")
        for req in done:
            if len(req.out_tokens) != MAX_NEW or not all(
                    0 <= t < cfg.padded_vocab for t in req.out_tokens):
                raise AssertionError(f"{arch}: request {req.rid} "
                                     f"out_tokens {req.out_tokens}")
        want = {key: 0 for key in counts}
        want[kernel] = cfg.n_layers * len(prompts)
        want["flash_attention"] = n_shared * len(prompts)
        want_variants = {"sm90": want["flash_attention"], "simt": 0}
        if counts != want or variants != want_variants:
            raise AssertionError(f"{arch}: launches {counts}, B5 by "
                                 f"variant {variants}; expected {want}")
        launches[arch] = {k: n for k, n in counts.items() if n}
        n_tok = sum(len(r.out_tokens) for r in done)
        prefill_ms = {sp.attrs["prompt_len"]: sp.duration * 1e3
                      for sp in find_spans(tracer.spans, "server.prefill")}
        tick_ms = sorted(sp.duration * 1e3
                         for sp in find_spans(tracer.spans, "server.decode"))
        log(f"phase 21 served {arch}: {len(done)} requests, {n_tok} tokens "
            f"in {wall:.3f} s = {n_tok / wall:.2f} tokens/s ({SLOTS} slots, "
            f"max_len {MAX_LEN}, {stats.ticks} ticks); launches "
            f"{json.dumps(launches[arch])} = {cfg.n_layers} {kernel}"
            + (f" and {n_shared} B5" if n_shared else "")
            + f" per request, B5 by variant {json.dumps(variants)}; no "
            f"other kernel launched; peak device memory {peak / 1e9:.2f} GB "
            f"({card})")
        log(f"phase 21 {arch} ttft_s " + json.dumps(stats.ttft_s))
        log(f"phase 21 {arch} latency_s " + json.dumps(stats.latency_s))
        log(f"phase 21 {arch} prefill ms by prompt length (host clock, ends "
            "in the first token's copy to the host): " + ", ".join(
                f"{n}: {prefill_ms[n]:.1f}" for n in PROMPT_LENS)
            + f"; at 2048 {prefill_ms[2048]:.1f}, at 4000 "
            f"{prefill_ms[4000]:.1f}; decode tick ms (host clock, "
            f"{len(tick_ms)} ticks): median {tick_ms[len(tick_ms) // 2]:.2f},"
            f" min {tick_ms[0]:.2f}, max {tick_ms[-1]:.2f} ({card})")
        del srv
        # bf16 at full depth on the 2,048-token prompt: the kernels against
        # the chunked forms with plain attention, and each against the f32
        # run of the same bf16 weights; the served first token is the
        # kernel run's
        i2k = PROMPT_LENS.index(2048)
        one = {"tokens": torch.tensor([prompts[i2k]], dtype=torch.int64,
                                      device="cuda")}
        with torch.no_grad():
            zero_counts()
            lk = make_prefill_step(cfg, SMOKE_MESH, flash)(params, one)[0]
            torch.cuda.synchronize()
            per = {key: mod.launches for key, mod in ops_by_name.items()
                   if mod.launches}
            with chunked_scans():
                lc = make_prefill_step(cfg, SMOKE_MESH, plain)(params,
                                                               one)[0]
        lk, lc = lk.float().cpu(), lc.float().cpu()
        bf16_read = {"kernels": lk, "chunked": lc}
        first = int(lk.argmax())
        if first != done[i2k].out_tokens[0]:
            raise AssertionError(
                f"{arch}: served first token {done[i2k].out_tokens[0]}, the "
                f"kernel prefill's {first}")
        # one 2,048-token prefill and one decode tick of 4 slots over 4,096
        # positions, half filled, profiled
        prefill = make_prefill_step(cfg, SMOKE_MESH, flash)
        decode = make_decode_step(cfg, SMOKE_MESH, flash)
        with torch.no_grad():
            _, cache = prefill(params, one)
            pool = pad_cache(cache, MAX_LEN)
            pool = {key: tuple(
                {k: torch.cat([buf] * SLOTS) for k, buf in c.items()}
                for c in pool[key]) for key in pool}
            del cache
            last = torch.zeros((SLOTS, 1), dtype=torch.int64, device="cuda")
            profile_scan_step(lambda: prefill(params, one),
                              f"{arch}, one 2048-token prefill", card)
            profile_scan_step(lambda: decode(params, last, pool),
                              f"{arch}, one decode tick of {SLOTS} slots "
                              f"(a {MAX_LEN}-position cache)", card)
        del pool, prefill, decode
        bf16_vs_f32(cfg, params, one, bf16_read, per, card)
        del params
        torch.cuda.empty_cache()
        # f32 at full width: kernels vs the chunked forms on the card, the
        # card vs the CPU, all 8 prompts
        cfg_f = cfg.with_(n_layers=SCAN_F32_LAYERS[arch])
        p32 = Stepper(cfg_f, ShapeConfig("check", "prefill", MAX_LEN, 1),
                      SMOKE_MESH, flash).init(seed=SEED + 1, device="cpu")
        for p in prompts:
            held_f32(cfg_f, p32, {"tokens": torch.tensor(
                [p], dtype=torch.int64)}, SCAN_F32_STEPS, card,
                f"full width, {cfg_f.n_layers} layers, S={len(p)}",
                phase="21", scans=True)
        del p32
    return launches


# scan-over-layers (phase 22): each model at full width, the scan form
# (ParallelismConfig.scan_layers) against the unrolled form on the same
# weights; the launches a prefill must make, by kernel
SCAN_LAYER_ARCHS = {"yi-9b": {"flash_attention": 48},
                    "zamba2-7b": {"ssd": 81, "flash_attention": 13},
                    "rwkv6-7b": {"wkv6": 32}}
SCAN_PROMPT, SCAN_TICKS = 2048, 16
SCAN_TICK_MEM_RATIO = 1.05           # a scanned tick's peak over the unrolled
TRAIN_SCAN_STEPS = 2
C10_RUNS, C10_GROWTH_BAR = 100, 2e9  # ROADMAP §C10: reserved bytes


def slots_cache(cache, stacked: bool):
    """One prefilled sequence's cache padded to ``MAX_LEN`` positions and
    repeated over ``SLOTS`` slots: the unrolled layout through
    ``pad_cache``, the stacked one with K/V padded on axis 2 and the batch
    on axis 1 (the reference's ``tests/test_scan_unroll.py::
    _pad_stacked``)."""
    import torch

    from repro_torch.model.transformer import pad_cache

    if not stacked:
        pool = pad_cache(cache, MAX_LEN)
        return {key: tuple(None if c is None else {
            k: torch.cat([buf] * SLOTS) for k, buf in c.items()}
            for c in pool[key]) for key in pool}
    out = {}
    for key, group in cache.items():
        out[key] = None if group is None else {}
        for k, buf in (group or {}).items():
            if k in ("k", "v") and buf.shape[2] < MAX_LEN:
                buf = torch.nn.functional.pad(
                    buf, (0, 0, 0, 0, 0, MAX_LEN - buf.shape[2]))
            out[key][k] = torch.cat([buf] * SLOTS, dim=1)
    return out


def scan_form_run(cfg, params, one, par, ops_by_name, zero_counts) -> dict:
    """A warm-up prefill, then one counted ``SCAN_PROMPT``-token prefill
    through ``make_prefill_step`` and ``SCAN_TICKS`` greedy ticks through
    ``make_decode_step`` on ``SLOTS`` slots over ``MAX_LEN`` positions:
    the logits of the prefill and of every tick, the tokens, the launches
    of the prefill and of the ticks, host ms, and each tick's device memory
    peak above what was allocated before it."""
    import torch

    from repro_torch.core.types import SMOKE_MESH
    from repro_torch.model.lm import make_decode_step, make_prefill_step

    prefill = make_prefill_step(cfg, SMOKE_MESH, par)
    decode = make_decode_step(cfg, SMOKE_MESH, par)
    with torch.no_grad():
        prefill(params, one)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, one)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: m.launches for k, m in ops_by_name.items() if m.launches}
        variants = dict(ops_by_name["flash_attention"].launches_by_variant)
        cache = slots_cache(cache, par.scan_layers)
        tok = logits.argmax(-1).reshape(1, 1).expand(SLOTS, 1).contiguous()
        rows, tokens, tick_ms, extra = [logits.float().cpu()], [], [], []
        zero_counts()
        for _ in range(SCAN_TICKS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out, cache = decode(params, tok, cache)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            extra.append(torch.cuda.max_memory_allocated() - base)
            rows.append(out.float().cpu())
            tok = out.argmax(-1, keepdim=True)
            tokens.append(tok[:, 0].tolist())
        tick_counts = {k: m.launches for k, m in ops_by_name.items()
                       if m.launches}
        resident = torch.cuda.memory_allocated()
        del cache
    torch.cuda.empty_cache()
    return {"rows": rows, "tokens": tokens, "counts": counts,
            "variants": variants, "tick_counts": tick_counts,
            "prefill_ms": prefill_ms, "tick_ms": sorted(tick_ms),
            "extra": max(extra), "resident": resident}


def flips_under_replays() -> None:
    """ROADMAP §C7's scenario (``tests/test_torch_gpu.py::
    test_flips_under_concurrent_replays_on_card``): six threads replay one
    ``elastic-lstm`` emulator's program at 4,096 windows while another
    flips W's bit 7 forty times (mma <-> simt); every answer must be the
    unflipped or the flipped design's, and nothing may raise."""
    import threading

    import numpy as np
    import torch

    from repro_torch.quant.fixedpoint import FxpFormat
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.verify.vectors import canonical_graph

    graph, _, _ = canonical_graph("elastic-lstm")
    em = RTLEmulator(graph, device="cuda")
    x = rand_codes(np.random.default_rng(17), FxpFormat(8, 4), (4096, 6, 1))
    want = [em.run_int(x).outputs.clone()]
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    want.append(em.run_int(x).outputs.clone())
    em.flip_bit("lstm_cell_l0", "w", 0, 7)
    bad, errors, stop = [], [], threading.Event()

    def run():
        try:
            while not stop.is_set():
                got = em.run_int(x).outputs
                if not any(torch.equal(got, w) for w in want):
                    bad.append(got.cpu())
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    def flip():
        try:
            for _ in range(40):
                em.flip_bit("lstm_cell_l0", "w", 0, 7)
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runners = [threading.Thread(target=run) for _ in range(6)]
        flipper = threading.Thread(target=flip)
        for t in runners + [flipper]:
            t.start()
        flipper.join(timeout=120)
        stop.set()
        for t in runners:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    torch.cuda.synchronize()
    if flipper.is_alive() or any(t.is_alive() for t in runners) or \
            errors or bad or not torch.equal(em.run_int(x).outputs, want[0]):
        raise AssertionError(f"C7's scenario: errors {errors!r}, "
                             f"{len(bad)} wrong answers")


def phase_scan_layers(ops_by_name: dict, card: str) -> dict:
    """Phase 22, scan-over-layers and ROADMAP §C10 on the card (see the
    module docstring). Returns the launches of a scanned prefill by arch
    and of the scanned training run."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.launch import train as launch_train
    from repro_torch.model.lm import Stepper

    torch.cuda.empty_cache()

    def zero_counts():
        for mod in ops_by_name.values():
            mod.launches = 0
            if hasattr(mod, "launches_by_variant"):
                mod.launches_by_variant = dict.fromkeys(
                    mod.launches_by_variant, 0)

    launches: dict = {}
    for arch, want in SCAN_LAYER_ARCHS.items():
        cfg = get_config(arch)
        params = Stepper(cfg, ShapeConfig("serve", "prefill", MAX_LEN,
                                          SLOTS), SMOKE_MESH,
                         ParallelismConfig()).init(
            seed=SEED, device="cuda", dtype_override=torch.bfloat16)
        prompt = np.random.default_rng(SEED + 22).integers(
            2, cfg.vocab_size, SCAN_PROMPT)
        one = {"tokens": torch.tensor([prompt.tolist()], dtype=torch.int64,
                                      device="cuda")}
        runs = {}
        for scan in (False, True):
            par = ParallelismConfig(compute_dtype="bfloat16",
                                    scan_layers=scan, attn_impl="flash")
            runs[scan] = scan_form_run(cfg, params, one, par, ops_by_name,
                                       zero_counts)
        del params
        torch.cuda.empty_cache()
        u, s = runs[False], runs[True]
        want_variants = {"sm90": want.get("flash_attention", 0), "simt": 0}
        for r in (u, s):
            if r["counts"] != want or r["variants"] != want_variants or \
                    r["tick_counts"]:
                raise AssertionError(
                    f"{arch}: a prefill launched {r['counts']} (B5 by "
                    f"variant {r['variants']}), {SCAN_TICKS} ticks "
                    f"{r['tick_counts']}; expected {want} and none")
        unequal = {("prefill" if i == 0 else f"tick {i}"): max_err(a, b)
                   for i, (a, b) in enumerate(zip(u["rows"], s["rows"]))
                   if not torch.equal(a, b)}
        if unequal or u["tokens"] != s["tokens"]:
            raise AssertionError(
                f"{arch}: scan vs unrolled logits differ (max |diff| by "
                f"step: {unequal}); tokens equal: "
                f"{u['tokens'] == s['tokens']}")
        if s["extra"] > SCAN_TICK_MEM_RATIO * u["extra"]:
            raise AssertionError(
                f"{arch}: a scanned tick's peak {s['extra'] / 1e9:.3f} GB "
                f"over its resident memory > {SCAN_TICK_MEM_RATIO} x the "
                f"unrolled tick's {u['extra'] / 1e9:.3f} GB")
        launches[arch] = s["counts"]
        log(f"phase 22 {arch} ({cfg.n_layers} layers, full width, bf16, "
            f"flash): one {SCAN_PROMPT}-token prefill and {SCAN_TICKS} "
            f"greedy ticks on {SLOTS} slots of {MAX_LEN} positions, scan "
            f"vs unrolled: logits of the prefill and of every tick equal "
            f"bit for bit, tokens equal ({u['tokens'][0][0]}, ..., "
            f"{u['tokens'][-1][0]}); launches a prefill "
            f"{json.dumps(s['counts'])} in both forms (B5 by variant "
            f"{json.dumps(s['variants'])}), none in the ticks; prefill ms "
            f"{u['prefill_ms']:.1f} unrolled, {s['prefill_ms']:.1f} scan; "
            f"tick ms median {u['tick_ms'][SCAN_TICKS // 2]:.2f} unrolled, "
            f"{s['tick_ms'][SCAN_TICKS // 2]:.2f} scan; a tick's peak "
            f"above its resident memory {u['extra'] / 1e9:.3f} GB unrolled,"
            f" {s['extra'] / 1e9:.3f} GB scan (ratio "
            f"{s['extra'] / u['extra']:.3f} <= {SCAN_TICK_MEM_RATIO}); "
            f"resident {u['resident'] / 1e9:.2f} / {s['resident'] / 1e9:.2f}"
            f" GB ({card})")

    # launch/train.py --scan against the same run unrolled
    _, _, seq, batch = TRAIN_SHAPE
    n_layers = get_config(TRAIN_ARCH).n_layers
    losses, steps_ms = {}, {}
    for scan in (True, False):
        with tempfile.TemporaryDirectory() as td:
            args = launch_train.parse_args(
                ["--arch", TRAIN_ARCH, "--full", "--seq", str(seq),
                 "--batch", str(batch), "--steps", str(TRAIN_SCAN_STEPS),
                 "--device", "cuda", "--ckpt-dir", td]
                + (["--scan"] if scan else []))
            zero_counts()
            out = launch_train.run(args)
            counts = {k: m.launches for k, m in ops_by_name.items()
                      if m.launches}
            variants = dict(ops_by_name["flash_attention"].launches_by_variant)
        losses[scan] = [m["loss"] for m in out["metrics"]]
        steps_ms[scan] = [round(m["sec"] * 1e3, 1) for m in out["metrics"]]
        del out
        gc.collect()
        torch.cuda.empty_cache()
        n = 2 * n_layers * TRAIN_SCAN_STEPS
        if counts != {"flash_attention": n} or variants != {"sm90": n,
                                                             "simt": 0}:
            raise AssertionError(f"train --scan={scan}: launches {counts}, "
                                 f"B5 by variant {variants}; expected {n}")
        if scan:
            launches["train"] = counts
    if losses[True] != losses[False] or len(losses[True]) != \
            TRAIN_SCAN_STEPS:
        raise AssertionError(f"train: losses {losses[True]} with --scan, "
                             f"{losses[False]} without")
    log(f"phase 22 python -m repro_torch.launch.train --arch {TRAIN_ARCH} "
        f"--full --seq {seq} --batch {batch} --steps {TRAIN_SCAN_STEPS} "
        f"--scan: losses {losses[True]} equal to the unrolled run's bit for "
        f"bit; B5 sm90 2 x {n_layers} a step in both; host ms a step "
        f"{steps_ms[True]} scan, {steps_ms[False]} unrolled ({card})")

    # ROADMAP §C10: dropped CUDA Graph pools are returned by the next
    # capture; no torch.cuda.empty_cache() of this loop's own
    gc.collect()
    reserved = {0: torch.cuda.memory_reserved()}
    t0 = time.perf_counter()
    for run in range(1, C10_RUNS + 1):
        flips_under_replays()
        gc.collect()
        if run in (10, C10_RUNS):
            reserved[run] = torch.cuda.memory_reserved()
    growth = reserved[C10_RUNS] - reserved[10]
    log(f"phase 22 C10: {C10_RUNS} runs of C7's scenario in "
        f"{time.perf_counter() - t0:.1f} s, all passed; memory_reserved "
        + ", ".join(f"after run {k}: {v / 1e9:.3f} GB" if k else
                    f"before: {v / 1e9:.3f} GB" for k, v in reserved.items())
        + f"; growth from run 10 {growth / 1e9:.3f} GB (bar "
        f"{C10_GROWTH_BAR / 1e9:.0f} GB; before the repair about 0.35 GB a "
        f"run) ({card})")
    if growth > C10_GROWTH_BAR:
        raise AssertionError(f"C10: reserved memory grew {growth / 1e9:.3f}"
                             f" GB from run 10 to run {C10_RUNS}")
    return launches


# The "model" split at tp = 2 (phase 24): two processes on the one card in
# a gloo process group (NCCL puts no two ranks on one card). Each arch at
# full width and a few of its layers: Yi-9B's 4 of 48, Zamba2-7B's 6 of 81
# (six Mamba-2 layers and one shared-block invocation, one unit),
# RWKV6-7B's 4 of 32
TP_ARCHS = (("yi-9b", 4), ("zamba2-7b", 6), ("rwkv6-7b", 4))
TP_SHAPE = ("tp_train", "train", 512, 2)
TP_PROMPT, TP_REQUESTS, TP_NEW = 256, 2, 8
TP_LOSS_TOL = 1e-5                       # relative, f32
TP_WORLD = 2
# what the split steps call (collectives, and their DTensor form)
TP_NEEDED = ("all-reduce", "all-gather", "all-reduce (functional)")


def tp_probe() -> dict:
    """Each collective the split steps may call, on CUDA tensors in this
    rank's gloo group: "ok", or the error it raised (the rank's index
    plus one summed, so a wrong answer shows too)."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    r, n = dist.get_rank(), dist.get_world_size()
    want = float(n * (n + 1) // 2)
    x = torch.full((2 * n, 8), float(r + 1), device="cuda")

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.stack(parts).sum(0)

    def reduce_scatter():
        out = torch.empty((2, 8), device="cuda")
        dist.reduce_scatter_tensor(out, x)
        return out

    def functional():
        return funcol.all_reduce(x, "sum", dist.group.WORLD).wait()

    out = {}
    for name, fn in (("all-reduce", all_reduce), ("all-gather", all_gather),
                     ("reduce-scatter", reduce_scatter),
                     ("all-reduce (functional)", functional)):
        try:
            y = fn()
            torch.cuda.synchronize()
            ok = bool((y == want).all())
            out[name] = "ok" if ok else f"wrong sum {y.flatten()[0].item()}"
        except Exception as e:                      # noqa: BLE001
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def tp_run(mesh, flash_ops, ssd_ops, wkv_ops, arch: str, layers: int,
           serve_only: bool = False) -> dict:
    """One rank's (or, with no mesh, the one process's) phase 24 work on
    ``arch`` at full width and ``layers`` layers in f32, from weights
    drawn on the card from one seed: ``Server`` (with ``mesh``,
    ``Server(mesh=)``) serving ``TP_REQUESTS`` prompts of ``TP_PROMPT``
    tokens and ``TP_NEW`` new ones (and the batch rows of its pool
    cache's leaves), then, unless ``serve_only``, one bf16 prefill and
    one train step; in each, B5 by variant and the q heads of each
    launch, B6's and B7's launches and the heads of each, peak device
    memory, host seconds."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, MeshConfig,
                                        ParallelismConfig, ShapeConfig)
    from repro_torch.data.pipeline import LMDataConfig, lm_batch_for_step
    from repro_torch.model.layers import local_blocks, tree_leaves
    from repro_torch.model.lm import Stepper
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.verify.conformance import exact_f32_matmul

    cfg = get_config(arch).with_(n_layers=layers)
    par = ParallelismConfig(compute_dtype="float32", attn_impl="flash")
    mcfg = (SMOKE_MESH if mesh is None
            else MeshConfig(tuple(mesh.mesh.shape), ("data", "model")))
    shape = ShapeConfig(*TP_SHAPE)
    st = Stepper(cfg, shape, mcfg, par, mesh=mesh)
    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(2, cfg.vocab_size, TP_PROMPT).tolist()
               for _ in range(TP_REQUESTS)]
    heads = {"b5": [], "b6": [], "b7": []}
    real_b5, real_b6 = flash_ops.flash_attention_cuda, ssd_ops.ssd_cuda
    real_b7 = wkv_ops.wkv6_cuda

    def counted_b5(q, *a, **kw):
        heads["b5"].append(q.shape[2])
        return real_b5(q, *a, **kw)

    def counted_b6(x, *a, **kw):
        heads["b6"].append(x.shape[2])
        return real_b6(x, *a, **kw)

    def counted_b7(r, *a, **kw):
        heads["b7"].append(r.shape[2])
        return real_b7(r, *a, **kw)

    def counts():
        flash_ops.launches_by_variant = dict.fromkeys(
            flash_ops.launches_by_variant, 0)
        ssd_ops.launches = 0
        wkv_ops.launches = 0
        for v in heads.values():
            v.clear()

    def read(run: str) -> None:
        out[f"{run}_b5"] = dict(flash_ops.launches_by_variant)
        out[f"{run}_heads"] = sorted(set(heads["b5"]))
        out[f"{run}_b6"] = ssd_ops.launches
        out[f"{run}_b6_heads"] = sorted(set(heads["b6"]))
        out[f"{run}_b7"] = wkv_ops.launches
        out[f"{run}_b7_heads"] = sorted(set(heads["b7"]))

    out = {}
    flash_ops.flash_attention_cuda = counted_b5
    ssd_ops.ssd_cuda = counted_b6
    wkv_ops.wkv6_cuda = counted_b7
    try:
        with exact_f32_matmul():
            params = st.init(seed=SEED + 24, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts()
            t0 = time.perf_counter()
            srv = Server(cfg, params, ServerConfig(
                batch_slots=TP_REQUESTS, max_len=TP_PROMPT + TP_NEW,
                eos_token=-1), mcfg, par, device="cuda", mesh=mesh)
            for p in prompts:
                srv.submit(p, max_new_tokens=TP_NEW)
            done = srv.run_until_drained()
            torch.cuda.synchronize()
            out["serve_s"] = time.perf_counter() - t0
            out["tokens"] = [list(r.out_tokens) for r in done]
            out["serve_rows"] = sorted({t.shape[0] for t in
                                        tree_leaves(srv._cache)})
            read("serve")
            out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del srv, done
            if serve_only:
                return out
            # one bf16 prefill: B5 sm90 on the same heads
            counts()
            srv = Server(cfg, params, ServerConfig(
                batch_slots=1, max_len=TP_PROMPT + 1, eos_token=-1), mcfg,
                dataclasses.replace(par, compute_dtype="bfloat16"),
                device="cuda", mesh=mesh)
            srv.submit(prompts[0], max_new_tokens=1)
            srv.run_until_drained()
            read("bf16")
            del srv
            state = {"params": params, "opt": init_opt_state(params)}
            if mesh is not None:
                state = local_blocks(state, st.state_shardings())
            del params
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                     lm_batch_for_step(LMDataConfig(
                         vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                         global_batch=shape.global_batch, seed=SEED),
                         0).items()}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counts()
            t0 = time.perf_counter()
            _, _, m = st.train_fn(donate=True)(state["params"],
                                               state["opt"], batch)
            out["loss"] = m["loss"].item()
            out["train_s"] = time.perf_counter() - t0
            read("train")
            out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del state, m
            torch.cuda.empty_cache()
    finally:
        flash_ops.flash_attention_cuda = real_b5
        ssd_ops.ssd_cuda = real_b6
        wkv_ops.wkv6_cuda = real_b7
    return out


def tp_rank(rank: int, world: int, store: str, out_dir: str,
            shape: tuple) -> None:
    """Phase 24's rank ``rank`` (a process ``torch.multiprocessing``
    started): a gloo group of ``world`` processes on card 0, the probe of
    the collectives, then :func:`tp_run` of each of ``TP_ARCHS`` on the
    ``shape`` mesh of ("data", "model") if the ones the split steps call
    ran (serving alone where the mesh has more than one data rank); its
    results pickled to ``out_dir``."""
    import datetime
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res["collectives"] = tp_probe()
        if all(res["collectives"][c] == "ok" for c in TP_NEEDED):
            from repro_torch.kernels.flash_attention import ops as flash_ops
            from repro_torch.kernels.mamba2 import ops as ssd_ops
            from repro_torch.kernels.rwkv6 import ops as wkv_ops
            from repro_torch.launch.mesh import make_smoke_mesh

            mesh = make_smoke_mesh(shape)
            for arch, layers in TP_ARCHS:
                res[arch] = tp_run(mesh, flash_ops, ssd_ops, wkv_ops, arch,
                                   layers, serve_only=shape[0] > 1)
    except Exception:                                  # noqa: BLE001
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()


def tp_summary(res: dict) -> str:
    """B5 by variant on its q heads, B6's and B7's launches on their
    heads, in each of a :func:`tp_run`'s three runs."""
    return "; ".join(
        f"{run} B5 {json.dumps(res[f'{run}_b5'])} on {res[f'{run}_heads']}"
        f" q heads, B6 {res[f'{run}_b6']} on {res[f'{run}_b6_heads']} heads"
        f", B7 {res[f'{run}_b7']} on {res[f'{run}_b7_heads']} heads"
        for run in ("serve", "bf16", "train"))


def phase_tp(ops_by_name: dict, card: str) -> dict:
    """Phase 24, the ``"model"`` split at tp = 2 on the one card, for each
    of ``TP_ARCHS`` at full width and a few layers in f32 (random weights
    from one seed, drawn on the card). First the one process computes
    each with no mesh (:func:`tp_run`): ``Server``'s greedy tokens for
    ``TP_REQUESTS`` prompts, one bf16 prefill, one train step's loss, B5
    by variant and B6's launches. Then two processes on the card in a
    gloo group pass CUDA tensors to each collective (:func:`tp_probe`);
    if the ones the split steps call run, each takes its half of the
    heads, ``d_ff`` columns, Mamba-2 ``d_inner`` and heads, RWKV-6
    time-mix heads and vocabulary on the (1, 2) mesh: ``Server(mesh=)``'s
    greedy tokens identical, the loss within ``TP_LOSS_TOL`` (relative),
    B5 on 16 q heads a launch, B6 on half the Mamba-2 heads and B7 on
    half the RWKV-6 heads, each as often as with no mesh (B7 once a layer
    of each prefill, never in training); each rank's peak memory beside
    the one process's. If one of those collectives raises, the phase
    names it and runs the split steps on a world of one (NCCL, the (1, 1)
    mesh) instead. Then the data split on the (2, 1) mesh
    (:func:`tp_data_split`). Returns B5's, B6's and B7's launches by arch
    and run."""
    import pickle
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.model.rwkv import rwkv_dims
    from repro_torch.model.ssm import mamba_dims

    flash_ops, ssd_ops = ops_by_name["flash_attention"], ops_by_name["ssd"]
    wkv_ops = ops_by_name["wkv6"]
    t_phase = time.perf_counter()
    one = {}
    for arch, layers in TP_ARCHS:
        torch.cuda.empty_cache()
        one[arch] = r1 = tp_run(None, flash_ops, ssd_ops, wkv_ops, arch,
                                layers)
        log(f"phase 24 tp = 1: {arch} full width, {layers} layers, f32, no "
            f"mesh: tokens {r1['tokens']}; loss {r1['loss']!r}; "
            f"{tp_summary(r1)}; peak GB serve {r1['serve_peak_gb']:.2f}, "
            f"train {r1['train_peak_gb']:.2f}; host s serve "
            f"{r1['serve_s']:.2f}, train step {r1['train_s']:.2f} ({card})")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(TP_WORLD, os.path.join(td, "store"), td,
                                (1, TP_WORLD)), nprocs=TP_WORLD)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(td, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            raise AssertionError(f"phase 24 rank {r}: {res['error']}")
    probe = ranks[0]["collectives"]
    log(f"phase 24 gloo group of {TP_WORLD} processes on card 0, CUDA "
        f"tensors: {json.dumps(probe)}")
    raised = [c for c in TP_NEEDED if probe[c] != "ok"]
    if raised:
        log(f"phase 24: {raised} raised on CUDA tensors in a gloo group; "
            "the split steps run on a world of one instead")
        with world_of_one() as mesh:
            ranks = [{arch: tp_run(mesh, flash_ops, ssd_ops, wkv_ops, arch,
                                   layers)
                      for arch, layers in TP_ARCHS}]
    tp = len(ranks)
    for arch, layers in TP_ARCHS:
        cfg = get_config(arch)
        r1 = one[arch]
        b5_heads = [] if cfg.rwkv else [cfg.n_heads // tp]
        b6_heads = [mamba_dims(cfg)[1] // tp] if cfg.ssm else []
        b7_heads = [rwkv_dims(cfg)[0] // tp] if cfg.rwkv else []
        # B5 sm90 in the bf16 prefill: once a layer, or once a shared
        # block's invocation, or never (RWKV-6 has no attention)
        bf16_sm90 = (len(cfg.with_(n_layers=layers).shared_attn_points())
                     if cfg.ssm else 0 if cfg.rwkv else layers)
        # B7 once a layer of each prefill (2 served, 1 in bf16), never in
        # training
        b7_want = ({"serve": TP_REQUESTS * layers, "bf16": layers,
                    "train": 0} if cfg.rwkv
                   else {"serve": 0, "bf16": 0, "train": 0})
        for r, rr in enumerate(ranks):
            res = rr[arch]
            rel = abs(res["loss"] - r1["loss"]) / abs(r1["loss"])
            runs = ("serve", "bf16", "train")
            if (res["tokens"] != r1["tokens"] or rel > TP_LOSS_TOL
                    or any(res[f"{k}_heads"] != b5_heads for k in runs)
                    or any(res[f"{k}_b5"] != r1[f"{k}_b5"] for k in runs)
                    or any(res[f"{k}_b6"] != r1[f"{k}_b6"] for k in runs)
                    or any(res[f"{k}_b6_heads"] != (b6_heads
                                                    if res[f"{k}_b6"] else [])
                           for k in runs)
                    or any(res[f"{k}_b7"] != b7_want[k]
                           or r1[f"{k}_b7"] != b7_want[k] for k in runs)
                    or any(res[f"{k}_b7_heads"] != (b7_heads
                                                    if res[f"{k}_b7"] else [])
                           or r1[f"{k}_b7_heads"] != ([rwkv_dims(cfg)[0]]
                                                      if r1[f"{k}_b7"]
                                                      else [])
                           for k in runs)
                    or (cfg.ssm and res["serve_b6"]
                        != TP_REQUESTS * layers)
                    or [res["serve_rows"], r1["serve_rows"]]
                    != [[TP_REQUESTS]] * 2
                    or r1["bf16_b5"] != {"sm90": bf16_sm90, "simt": 0}):
                raise AssertionError(
                    f"phase 24 {arch} rank {r} of {tp}: tokens "
                    f"{res['tokens']} (tp = 1: {r1['tokens']}), loss "
                    f"{res['loss']!r} (tp = 1: {r1['loss']!r}, rel "
                    f"{rel:.3g}); {tp_summary(res)} (tp = 1: "
                    f"{tp_summary(r1)})")
            log(f"phase 24 {arch} tp = {tp} rank {r}: tokens identical, "
                f"loss {res['loss']!r} (rel {rel:.3g} <= {TP_LOSS_TOL}); "
                f"{tp_summary(res)}; peak GB serve {res['serve_peak_gb']:.2f}"
                f" (tp = 1 {r1['serve_peak_gb']:.2f}), train "
                f"{res['train_peak_gb']:.2f} (tp = 1 "
                f"{r1['train_peak_gb']:.2f}); host s serve "
                f"{res['serve_s']:.2f}, train step {res['train_s']:.2f} "
                f"({card})")
    data = tp_data_split(one, card)
    log(f"phase 24 took {time.perf_counter() - t_phase:.1f} s (the "
        f"{TP_WORLD} processes {spawn_s:.1f} s on (1, {TP_WORLD}), "
        f"{data.pop('spawn_s'):.1f} s on ({TP_WORLD}, 1)) ({card})")

    def total(res, kernel):
        if kernel in ("ssd", "wkv6"):
            key = "b6" if kernel == "ssd" else "b7"
            return sum(res[f"{k}_{key}"] for k in ("serve", "bf16", "train"))
        return {v: sum(res[f"{k}_b5"][v] for k in ("serve", "bf16", "train"))
                for v in res["serve_b5"]}

    out = {"flash_attention": {}, "ssd": {}, "wkv6": {}}
    for arch, _ in TP_ARCHS:
        cfg = get_config(arch)
        for kernel in out:
            if {"flash_attention": not cfg.rwkv, "ssd": cfg.ssm,
                    "wkv6": cfg.rwkv}[kernel]:
                out[kernel][arch] = {
                    "tp1": total(one[arch], kernel),
                    f"tp{tp}_rank0": total(ranks[0][arch], kernel),
                    f"dp{TP_WORLD}_rank0_serve": data[arch][kernel]}
    return out


def tp_data_split(one: dict, card: str) -> dict:
    """Phase 24's run on the (``TP_WORLD``, 1) mesh: two processes of a
    gloo group on card 0, each one data rank, serve the phase's prompts on
    ``TP_REQUESTS`` slots through ``Server(mesh=)`` for each of
    ``TP_ARCHS`` (:func:`tp_run`, serving alone). Raises unless each
    rank's tokens are tp = 1's (``one``, :func:`tp_run` with no mesh),
    each leaf of its pool cache holds ``TP_REQUESTS / TP_WORLD`` rows,
    and its B5 (by variant), B6 and B7 serving launches are tp = 1's
    over ``TP_WORLD`` on the same heads, each data rank prefilling only
    its own requests. Returns rank 0's serving launches by arch and
    kernel, and the processes' seconds as ``spawn_s``."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(TP_WORLD, os.path.join(td, "store"), td,
                                (TP_WORLD, 1)), nprocs=TP_WORLD)
        out = {"spawn_s": time.perf_counter() - t0}
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(td, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, res in enumerate(ranks):
        if "error" in res or not all(arch in res for arch, _ in TP_ARCHS):
            raise AssertionError(f"phase 24 ({TP_WORLD}, 1) rank {r}: "
                                 f"{res.get('error', res['collectives'])}")
    rows = TP_REQUESTS // TP_WORLD
    for arch, _ in TP_ARCHS:
        r1 = one[arch]
        for r, rr in enumerate(ranks):
            res = rr[arch]
            b5 = {v: n * TP_WORLD for v, n in res["serve_b5"].items()}
            if (res["tokens"] != r1["tokens"] or res["serve_rows"] != [rows]
                    or b5 != r1["serve_b5"]
                    or res["serve_b6"] * TP_WORLD != r1["serve_b6"]
                    or res["serve_b7"] * TP_WORLD != r1["serve_b7"]
                    or any(res[f"serve_{k}"] != r1[f"serve_{k}"]
                           for k in ("heads", "b6_heads", "b7_heads"))):
                raise AssertionError(
                    f"phase 24 {arch} ({TP_WORLD}, 1) rank {r}: tokens "
                    f"{res['tokens']} (tp = 1: {r1['tokens']}), pool rows "
                    f"{res['serve_rows']} (want [{rows}]), serving B5 "
                    f"{json.dumps(res['serve_b5'])} on {res['serve_heads']} "
                    f"q heads, B6 {res['serve_b6']} on "
                    f"{res['serve_b6_heads']}, B7 {res['serve_b7']} on "
                    f"{res['serve_b7_heads']} (tp = 1: "
                    f"{json.dumps(r1['serve_b5'])} on {r1['serve_heads']}, "
                    f"{r1['serve_b6']} on {r1['serve_b6_heads']}, "
                    f"{r1['serve_b7']} on {r1['serve_b7_heads']})")
            log(f"phase 24 {arch} ({TP_WORLD}, 1) data rank {r}: tokens "
                f"identical to tp = 1's; pool rows {res['serve_rows']} of "
                f"every leaf (tp = 1: {r1['serve_rows']}); serving B5 "
                f"{json.dumps(res['serve_b5'])}, B6 {res['serve_b6']}, B7 "
                f"{res['serve_b7']} (tp = 1: {json.dumps(r1['serve_b5'])}, "
                f"{r1['serve_b6']}, {r1['serve_b7']}), on "
                f"{res['serve_heads']}, {res['serve_b6_heads']} and "
                f"{res['serve_b7_heads']} heads a launch; peak GB serve "
                f"{res['serve_peak_gb']:.2f} (tp = 1 "
                f"{r1['serve_peak_gb']:.2f}); host s serve "
                f"{res['serve_s']:.2f} (tp = 1 {r1['serve_s']:.2f}) ({card})")
        out[arch] = {"flash_attention": sum(ranks[0][arch]["serve_b5"]
                                            .values()),
                     "ssd": ranks[0][arch]["serve_b6"],
                     "wkv6": ranks[0][arch]["serve_b7"]}
    return out


# The multi-pod dry-run (phase 25): two cells of ``python -m
# repro_torch.launch.dryrun`` on the 16 x 16 mesh, each in a subprocess of
# its own (a fake process group of 256 ranks, ``meta`` tensors: no card),
# both started after phase 24
DRYRUN_CELLS = (("rwkv6-7b", "train_4k"), ("yi-9b", "decode_32k"))
DRYRUN_TIMEOUT = 300                     # seconds, from the start


def dryrun_start(out_dir: str) -> list:
    """Start the dry-run CLI for each of ``DRYRUN_CELLS``, its report's
    JSON to ``out_dir``; no card is visible to it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--json", out_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for arch, shape in DRYRUN_CELLS]


def phase_dryrun(procs: list, out_dir: str, t_start: float,
                 card: str) -> None:
    """Phase 25: wait for :func:`dryrun_start`'s processes (until
    ``DRYRUN_TIMEOUT`` after ``t_start``), and print each cell's report
    row and its memory and collective lines; fails if one exits non-zero
    or reports no FLOPs, no bytes, no wire bytes, or another mesh."""
    from repro_torch.energy.roofline import HEADER

    for (arch, shape), p in zip(DRYRUN_CELLS, procs):
        left = DRYRUN_TIMEOUT - (time.perf_counter() - t_start)
        try:
            out, err = p.communicate(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise AssertionError(f"phase 25 dry-run {arch} x {shape}: not "
                                 f"done {DRYRUN_TIMEOUT} s after its start")
        if p.returncode != 0:
            raise AssertionError(f"phase 25 dry-run {arch} x {shape}: exit "
                                 f"{p.returncode}: {err[-3000:]}")
        with open(os.path.join(out_dir,
                               f"{arch}__{shape}__16x16.json")) as f:
            rep = json.load(f)
        if not (rep["mesh"] == "16x16" and rep["n_devices"] == 256
                and rep["flops_per_device"] > 0
                and rep["bytes_per_device"] > 0
                and rep["wire_bytes_per_device"] > 0):
            raise AssertionError(f"phase 25 dry-run {arch} x {shape}: "
                                 f"{json.dumps(rep)}")
        lines = out.splitlines()
        row = next(ln for ln in lines if ln.strip().startswith(arch + " "))
        detail = [ln.strip() for ln in lines
                  if ln.strip().startswith(("memory_analysis", "flops/",
                                            "collectives"))]
        log(f"phase 25 dry-run {arch} x {shape} x 16x16 (meta tensors, a "
            f"fake group of 256 ranks): counted in "
            f"{rep['compile_seconds']:.1f} s of host time ({card}); the "
            f"row's ms and MFU are MODELLED from the counts and the H100 "
            f"SXM's peak and rates, not measured on the card:\n{HEADER}\n"
            f"{row}\n  " + "\n  ".join(detail))


# decode attention's cells: (B, S_max, KV, G, hd, kv_len drawn in [lo, hi])
# -- yi-9b.long_decode's and long_prompt's pools, Zamba2-7B's shared block
# over 4 slots (a free slot's position past S_max included)
DECODE_CELLS = {"long_decode": (32, 4096, 4, 8, 128, (297, 2160)),
                "long_prompt": (16, 4096, 4, 8, 128, (512, 4032)),
                "zamba2_shared": (4, 4096, 32, 1, 112, (1, 4101))}


def phase_decode_attention(card: str, served: dict) -> dict:
    """Phase 26 (module doc); ``served``: phase 6's decode launches and
    ticks. Returns the kernel's row of the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention.ref import (BF16_REL_RMS_BAR,
                                                         rel_rms_by_block)
    from repro_torch.model.attention import _attn_block, _repeat_kv

    def replaced(q, k, v, kv_len):
        G = q.shape[2] // k.shape[2]
        return _attn_block(q, _repeat_kv(k, G), _repeat_kv(v, G),
                           q.shape[-1] ** -0.5, False, 0, kv_len)

    def sdpa(q, k, v, kv_len):
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < kv_len[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    def enqueue_ms(fn, *args, reps=20):
        """Host ms of one call, not waiting for the card (what a tick pays
        where the host paces it)."""
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        t = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return t

    rng = np.random.default_rng(SEED + 26)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, (B, S, KV, G, hd, (lo, hi)) in DECODE_CELLS.items():
        lens = rng.integers(lo, hi + 1, B)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        copies = [tuple(torch.randn(shape, device="cuda", generator=gen,
                                    dtype=torch.bfloat16)
                        for shape in ((B, 1, KV * G, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))) + (kv_len,)
                  for _ in range(3)]
        q, k, v, _ = copies[0]
        want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len)
        before = dict(dec_ops.launches_by_variant)
        got = decode_attention(q, k, v, kv_len)
        got32 = decode_attention(q.float(), k.float(), v.float(), kv_len)
        torch.cuda.synchronize()
        moved = {n: dec_ops.launches_by_variant[n] - before[n]
                 for n in before}
        err = (got.float() - want).abs().max().item()
        rr = rel_rms_by_block(got, want)
        err32 = (got32 - want).abs().max().item()
        if (moved != {"mma": 1, "simt": 1} or err >= 0.03
                or rr >= BF16_REL_RMS_BAR or err32 >= 2e-5):
            raise AssertionError(
                f"decode attention {label}: launches {moved}, bf16 max abs "
                f"{err:.3e}, rel rms {rr:.3e} (bar {BF16_REL_RMS_BAR}), f32 "
                f"max abs {err32:.3e} (bar 2e-5)")
        del got32
        valid = int(np.minimum(lens, S).sum())
        n_bytes = valid * KV * hd * 2 * 2 + 2 * q.numel() * 2
        bnd, by = bound_ms(n_bytes, 4 * valid * KV * G * hd,
                           BF16_FLOP_PER_S)
        k_ms = time_ms(rotating(decode_attention, *copies))
        p_ms = events_ms(rotating(decode_attention_ref, *copies), reps=6)
        r_ms = events_ms(rotating(replaced, *copies), reps=3)
        l_ms = events_ms(rotating(sdpa, *copies), reps=6)
        enqueue = {name: enqueue_ms(fn, q, k, v, kv_len)
                   for name, fn in (("kernel", decode_attention),
                                    ("replaced", replaced))}
        splits, chunk = dec_ops.split_plan(B * KV, S, n_sm)
        rows[label] = {"ms": k_ms, "bound_ms": bnd, "bound_by": by,
                       "plain_ms": p_ms, "replaced_ms": r_ms,
                       "library_ms": l_ms, "max_abs_err": err,
                       "rel_rms": rr, "f32_max_abs_err": err32,
                       "host_ms": enqueue}
        log(f"phase 26 decode attention {label} (B {B}, S_max {S}, KV {KV}, "
            f"G {G}, hd {hd}, kv_len {lo}-{hi}: {valid} keys, "
            f"{n_bytes / 1e6:.1f} MB; {splits} splits of {chunk}): bf16 "
            f"max abs {err:.3e}, rel rms {rr:.3e}; f32 max abs "
            f"{err32:.3e}; kernel {k_ms:.4f} ms = {bnd / k_ms:.1%} of its "
            f"bound {bnd:.4f} ms ({by}; {k_ms / bnd:.2f}x), plain "
            f"{p_ms:.4f} ms, the replaced path {r_ms:.4f} ms, "
            f"scaled_dot_product_attention {l_ms:.4f} ms; host ms a call "
            f"(enqueue) kernel {enqueue['kernel']:.4f}, the replaced path "
            f"{enqueue['replaced']:.4f} ({card})")
        del copies, q, k, v, want, got
        torch.cuda.empty_cache()
    row = rows["long_decode"]
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "none (XLA's einsum over the repeated cache, "
                        "src/repro/model/attention.py)",
            "launches": served["launches"], "decode_ticks": served["ticks"],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "replaced_ms")},
            "cells": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.types import (SMOKE_MESH, ParallelismConfig,
                                        ShapeConfig)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda)
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (BF16_REL_RMS_BAR,
                                                         rel_rms_by_block)
    from repro_torch.kernels.lstm_cell_int import (CellSpec, lstm_window_int,
                                                   lstm_window_int_cuda,
                                                   lstm_window_int_ref,
                                                   mma_takes)
    from repro_torch.kernels.lstm_cell_int import ops as lstm_ops
    from repro_torch.kernels.mac_int import (mac_int_cuda, mac_int_op,
                                             mac_int_ref)
    from repro_torch.kernels.mac_int import ops as mac_ops
    from repro_torch.model.conv1d import conv1d_frames
    from repro_torch.model.layers import is_pspec, param_count, tree_map
    from repro_torch.model.lm import (Stepper, make_decode_step,
                                      make_prefill_step)
    from repro_torch.model.transformer import pad_cache
    from repro_torch.obs import Tracer, find_spans, set_tracer
    from repro_torch.quant.fixedpoint import FxpFormat
    from repro_torch.rtl.emulator import RTLEmulator, assert_bit_exact
    from repro_torch.rtl.oplib import requant_shift
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.verify.vectors import (canonical_graph, golden_dir,
                                            load_vectors)

    torch.backends.cuda.matmul.allow_tf32 = False   # float oracle in f32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    A, W, C = FxpFormat(8, 4), FxpFormat(8, 6), FxpFormat(16, 8)
    # B1's simt variant takes what mma cannot: 12-bit activation codes
    B1_WIDE_ACT, B1_WIDE_STATE = FxpFormat(12, 6), FxpFormat(12, 8)

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build()
    log(f"phase 1 build: {len(libs)} kernels from src/repro_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in sorted(libs.items()):
        # one line per kernel: its name, registers and spills
        entry, spill = "?", ""
        for line in open(f"{path}.log").read().splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"  ptxas {name} {entry}: {line.split(':', 1)[1].strip()};"
                    f" {spill}")

    # ---- 2. kernels against their plain versions ---------------------------
    errs = {"lstm_cell_int": 0, "mac_int": 0}
    lstm_ops.launches_by_variant = dict.fromkeys(
        lstm_ops.launches_by_variant, 0)

    def b1_variants_equal_plain(args, spec):
        """B1 through its wrapper (the routed variant) and each variant
        launched directly, all against the plain version."""
        want = lstm_window_int_ref(*args, spec=spec)
        errs["lstm_cell_int"] = max(errs["lstm_cell_int"], max_abs_err(
            lstm_window_int(*args, spec=spec), want))
        for name in ("mma", "simt"):
            if name == "mma" and not mma_takes(spec):
                continue
            got = torch.full_like(want, -7)
            lstm_window_int_cuda(*args, got, spec=spec, variant=name)
            errs["lstm_cell_int"] = max(errs["lstm_cell_int"],
                                        max_abs_err(got, want))
        return want

    # the test shapes and hidden widths that are not multiples of 4 (mma's
    # int32 store path, padded units in its last n8 tile), in Table I's
    # formats and in 12-bit activations (routed to simt)
    for act in (A, B1_WIDE_ACT):
        for B, S, din, hid in ((1, 6, 1, 20), (7, 6, 3, 16), (64, 4, 2, 8),
                               (200, 6, 1, 20), (33, 6, 2, 5), (17, 6, 1, 13),
                               (65, 5, 3, 30)):
            spec = CellSpec(seq_len=S, d_in=din, hidden=hid, act_fmt=act,
                            state_fmt=C, w_fmt=W, sig_lo=act.lo,
                            tanh_lo=act.lo)
            b1_variants_equal_plain(
                (rand_codes(rng, act, (B, S, din)),
                 rand_codes(rng, W, (din + hid, 4 * hid)),
                 rand_codes(rng, FxpFormat(11, 0), (4 * hid,)),
                 rand_codes(rng, act, (2 ** act.total_bits,)),
                 rand_codes(rng, act, (2 ** act.total_bits,))), spec)
    # codes at the ends of their formats, biases at int32's: at K = 128 the
    # sums reach 2^21, the top of the mma kernel's exactness envelope
    for (din, hid), x_end, w_end, rom_end in itertools.product(
            ((1, 20), (64, 64)), (A.lo, A.hi), (W.lo, W.hi), (A.lo, A.hi)):
        spec = CellSpec(seq_len=6, d_in=din, hidden=hid, act_fmt=A,
                        state_fmt=C, w_fmt=W, sig_lo=A.lo, tanh_lo=A.lo)
        full = functools.partial(torch.full, dtype=torch.int32,
                                 device="cuda")
        bias = torch.where(torch.arange(4 * hid, device="cuda") % 2 == 0,
                           full((), 2 ** 31 - 1), full((), -2 ** 31))
        b1_variants_equal_plain(
            (full((33, 6, din), x_end), full((din + hid, 4 * hid), w_end),
             bias, full((256,), rom_end), full((256,), rom_end)), spec)
    for shift in (-2, 0, 2, 6):
        for rows, K, N in ((7, 20, 1), (49, 9, 3), (21, 9, 3), (7, 9, 1),
                           (7, 21, 80), (300, 33, 17)):
            out = C if shift <= 2 else A
            args = (rand_codes(rng, A, (rows, K)), rand_codes(rng, W, (K, N)),
                    rand_codes(rng, FxpFormat(11, 0), (N,)))
            errs["mac_int"] = max(errs["mac_int"], max_abs_err(
                mac_int_op(*args, shift=shift, lo=out.lo, hi=out.hi),
                mac_int_ref(*args, shift=shift, lo=out.lo, hi=out.hi)))
    log(f"phase 2a kernels = plain versions at the test shapes (exact); B1 "
        f"in {A} and {B1_WIDE_ACT} activations and at extreme codes, each "
        f"variant also launched directly; B1 routed "
        f"{json.dumps(lstm_ops.launches_by_variant)}")

    lstm_g, _, _ = canonical_graph("elastic-lstm")
    conv_g, _, _ = canonical_graph("elastic-conv1d")
    lstm_em = RTLEmulator(lstm_g, mode="fused")
    conv_em = RTLEmulator(conv_g, mode="fused")
    cell, head = lstm_g.node("lstm_cell_l0"), lstm_g.node("linear_head")
    p_cell = lstm_em.prepared(cell.name)
    cell_args = (rand_codes(rng, A, (B_SERVE, cell.seq_len, cell.d_in)),
                 p_cell["w"], p_cell["b"],
                 lstm_em.prepared(cell.sigmoid_lut)["table"],
                 lstm_em.prepared(cell.tanh_lut)["table"])
    seq = b1_variants_equal_plain(cell_args, p_cell["spec"])
    # every MAC call shape of the main path at the serving batch
    p_head = lstm_em.prepared(head.name)
    mac_cases = {
        "lstm_head": ((seq[:, -1].contiguous(), p_head["w"], p_head["b"]),
                      requant_shift(head.in_fmt, head.w_fmt, head.out_fmt),
                      head.out_fmt),
        "lstm_gate_per_step": ((torch.cat(
            [cell_args[0][:, 0], rand_codes(rng, A, (B_SERVE, cell.hidden))],
            dim=-1), p_cell["w"], p_cell["b"]), cell.mac_shift, A),
    }
    for name in ("conv1d_0", "conv1d_1", "linear_head"):
        n = conv_g.node(name)
        p = conv_em.prepared(name)
        if n.op == "conv1d":
            x = rand_codes(rng, A, (B_SERVE, n.seq_len, n.channels))
            xh = conv1d_frames(x, n.kernel, n.stride).reshape(
                B_SERVE * n.out_len, n.kernel * n.channels).contiguous()
            args = (xh, p["w_mat"], p["b"])
        else:
            args = (rand_codes(rng, A, (B_SERVE, n.weight.shape[0])),
                    p["w"], p["b"])
        mac_cases[f"conv_{name}"] = (
            args, requant_shift(n.in_fmt, n.w_fmt, n.out_fmt), n.out_fmt)
    for name, (args, shift, fmt) in mac_cases.items():
        errs["mac_int"] = max(errs["mac_int"], max_abs_err(
            mac_int_op(*args, shift=shift, lo=fmt.lo, hi=fmt.hi),
            mac_int_ref(*args, shift=shift, lo=fmt.lo, hi=fmt.hi)))
    log(f"phase 2b kernels = plain versions at the serving shapes, "
        f"B={B_SERVE} windows (exact): B1 mma and simt at elastic-lstm's "
        f"cell; mac_int {sorted(mac_cases)}")

    yi = get_config("yi-9b")
    b5_cases = ([(s, c) for s in ((2, 256, 4, 64), (1, 512, 2, 128),
                                  (2, 256, 3, 96), (1, 384, 2, 160))
                 for c in (True, False)]
                + [((1, n, yi.n_heads, yi.hd), True) for n in PROMPT_LENS])
    b5_err = {"float32": 0.0, "bfloat16": 0.0}
    # bf16 against f32, the largest rms(err) / rms(want) of a 128-row block
    b5_rel = {"sm90": 0.0, "simt": 0.0}

    def hold_bf16(got, want, name):
        b5_err["bfloat16"] = max(b5_err["bfloat16"],
                                 (got.float() - want).abs().max().item())
        b5_rel[name] = max(b5_rel[name], rel_rms_by_block(got, want))

    b5_rng = np.random.default_rng(SEED + 5)     # phases 3-5 keep ``rng``
    flash_ops.launches_by_variant = dict.fromkeys(
        flash_ops.launches_by_variant, 0)
    for shape, causal in b5_cases:
        q, k, v = (torch.as_tensor(b5_rng.standard_normal(shape) * 0.5,
                                   dtype=torch.float32, device="cuda")
                   for _ in range(3))
        want = attention_ref(q, k, v, causal)
        got = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        b5_err["float32"] = max(b5_err["float32"],
                                (got - want).abs().max().item())
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        want = attention_ref(qb.float(), kb.float(), vb.float(), causal)
        hold_bf16(flash_attention(qb, kb, vb, causal), want,
                  flash_ops.variant(qb, kb, vb))
        # the simt variant's bf16 instances, which the routing reaches
        # only off this path (hd > 128, hd % 8, strides TMA cannot read)
        got = torch.empty_like(qb)
        flash_attention_cuda(qb, kb, vb, got, causal=causal, variant="simt")
        hold_bf16(got, want, "simt")
        torch.cuda.synchronize()
        del q, k, v, qb, kb, vb, want, got
    ref_launches = dict(flash_ops.launches_by_variant)
    flash_ops.launches_by_variant = dict.fromkeys(
        flash_ops.launches_by_variant, 0)
    sm90_cases = [((2, n, 3, hd), c) for hd in SM90_HDS for n in SM90_SEQS
                  for c in (True, False)]
    for shape, causal in sm90_cases:
        qb, kb, vb = (torch.as_tensor(b5_rng.standard_normal(shape) * 0.5,
                                      dtype=torch.float32, device="cuda")
                      .to(torch.bfloat16) for _ in range(3))
        want = attention_ref(qb.float(), kb.float(), vb.float(), causal)
        hold_bf16(flash_attention(qb, kb, vb, causal), want, "sm90")
        torch.cuda.synchronize()
    if flash_ops.launches_by_variant != {"sm90": len(sm90_cases), "simt": 0}:
        raise AssertionError(f"B5 sm90 shapes launched "
                             f"{flash_ops.launches_by_variant}")
    if b5_err["float32"] > B5_F32_TOL or b5_err["bfloat16"] > B5_BF16_TOL \
            or max(b5_rel.values()) > BF16_REL_RMS_BAR:
        raise AssertionError(f"B5 != plain version: max |err| {b5_err}, "
                             f"bars {B5_F32_TOL} (f32), {B5_BF16_TOL} "
                             f"(bf16 vs f32); block rel rms {b5_rel}, bar "
                             f"{BF16_REL_RMS_BAR}")
    # planted faults of the sm90 K/V ring at a Yi-9B layer of 2,048 tokens:
    # keys 256-383 read from the stage keys 0-127 left, and the last key
    # tile lost; each must fail the block bar
    qb, kb, vb = (torch.as_tensor(b5_rng.standard_normal(
        (1, 2048, yi.n_heads, yi.hd)) * 0.5, dtype=torch.float32,
        device="cuda").to(torch.bfloat16) for _ in range(3))
    want = attention_ref(qb.float(), kb.float(), vb.float(), True)
    ks, vs = kb.clone(), vb.clone()
    ks[:, 256:384], vs[:, 256:384] = kb[:, :128], vb[:, :128]
    faults = {"stale_stage": attention_ref(qb, ks, vs, True),
              "lost_last_tile": attention_ref(qb, kb[:, :1920], vb[:, :1920],
                                              True)}
    faults = {n: ((f.float() - want).abs().max().item(),
                  rel_rms_by_block(f, want)) for n, f in faults.items()}
    if min(rel for _, rel in faults.values()) <= BF16_REL_RMS_BAR:
        raise AssertionError(f"B5 block bar passes a planted fault: {faults}")
    del qb, kb, vb, ks, vs, want
    log(f"phase 2c B5 = plain version at the reference's 4 test shapes x "
        f"causal/not, at the {len(PROMPT_LENS)} Yi-9B prefill shapes "
        f"(1, S, 32, 128) (routed {ref_launches}; simt bf16 also launched "
        f"directly at each) and at {len(sm90_cases)} sm90 shapes (2, S, 3, "
        f"hd), hd {SM90_HDS}, S {SM90_SEQS}, causal/not, each on sm90: "
        f"max |err| f32 {b5_err['float32']:.3g} (bar {B5_F32_TOL}), bf16 vs "
        f"f32 {b5_err['bfloat16']:.3g} (bar {B5_BF16_TOL}); bf16 block rel "
        f"rms sm90 {b5_rel['sm90']:.5f}, simt {b5_rel['simt']:.5f} (bar "
        f"{BF16_REL_RMS_BAR}); planted faults at (1, 2048, 32, 128) causal "
        "(max |err|, block rel rms): " + ", ".join(
            f"{n} ({a:.4f}, {r:.4f})" for n, (a, r) in faults.items()))

    # ---- 3. golden replay --------------------------------------------------
    for arch, graph in (("elastic-lstm", lstm_g), ("elastic-conv1d", conv_g)):
        vs = load_vectors(golden_dir(GOLDEN, arch))
        for mode in RTLEmulator.MODES:
            got = RTLEmulator(graph, mode=mode).run_int(vs.stimulus).outputs
            if not np.array_equal(got.cpu().numpy(), vs.response):
                raise AssertionError(f"golden replay {arch} {mode} differs")
    log("phase 3 golden sets replay exactly: elastic-lstm, elastic-conv1d x "
        f"{', '.join(RTLEmulator.MODES)}")

    # ---- 4. serve ragged requests (the main path) --------------------------
    def requests(graph, sizes):
        fmt = graph.edges["x"].fmt
        return [(rng.integers(fmt.lo, fmt.hi + 1,
                              (s, *graph.edges["x"].shape)) / fmt.scale)
                .astype(np.float32) for s in sizes]

    # elastic-lstm in 12-bit activations: its cells route to B1's simt
    wide_g, _, _ = canonical_graph("elastic-lstm", act_fmt=B1_WIDE_ACT,
                                   state_fmt=B1_WIDE_STATE)
    served = {"elastic-lstm": (lstm_g, lstm_em, requests(lstm_g,
                                                         LSTM_REQUESTS)),
              "elastic-conv1d": (conv_g, conv_em, requests(conv_g,
                                                           CONV_REQUESTS)),
              "elastic-lstm-q12": (wide_g, RTLEmulator(wide_g, mode="fused"),
                                   requests(wide_g, LSTM_REQUESTS[:6]))}
    b1_route = {"elastic-lstm": "mma", "elastic-conv1d": None,
                "elastic-lstm-q12": "simt"}
    path_launches = {}
    for arch, (graph, em, reqs) in served.items():
        # one dispatch: B1 once per lstm_cell, B2 once per linear/conv1d
        cells = [n for n in graph.nodes if n.op == "lstm_cell"]
        expected = {"lstm_cell_int": len(cells),
                    "mac_int": sum(n.op in ("linear", "conv1d")
                                   for n in graph.nodes)}
        routes = [lstm_ops.variant(em.prepared(n.name)["spec"])
                  for n in cells]
        if any(r != b1_route[arch] for r in routes):
            raise AssertionError(f"{arch}: B1 routes {routes}")
        want_routes = dict.fromkeys(lstm_ops.launches_by_variant, 0)
        if cells:
            want_routes[b1_route[arch]] = len(cells)
        lstm_ops.launches = 0
        lstm_ops.launches_by_variant = dict.fromkeys(
            lstm_ops.launches_by_variant, 0)
        mac_ops.launches = 0
        answers = em.run_many(reqs)
        torch.cuda.synchronize()
        launches = {"lstm_cell_int": lstm_ops.launches,
                    "mac_int": mac_ops.launches}
        if launches != expected or \
                lstm_ops.launches_by_variant != want_routes:
            raise AssertionError(
                f"{arch}: kernel launches {launches}, B1 by variant "
                f"{lstm_ops.launches_by_variant}, expected {expected}, "
                f"{want_routes}")
        path_launches[arch] = launches
        log(f"phase 4 {arch} launches: {json.dumps(launches)}; B1 by "
            f"variant {json.dumps(lstm_ops.launches_by_variant)}")
        plain = RTLEmulator(graph, mode="jnp").run_many(reqs)
        out_shape = graph.edges[graph.outputs[0]].shape
        for req, ans, ref in zip(reqs, answers, plain):
            y = ans.outputs
            if tuple(y.shape) != (len(req), *out_shape) or \
                    not torch.isfinite(ans.outputs_f).all():
                raise AssertionError(f"{arch}: bad answer shape/values")
            if not torch.equal(y, em.run(req).outputs):
                raise AssertionError(f"{arch}: batched != solo run")
            if not torch.equal(y, ref.outputs):
                raise AssertionError(f"{arch}: fused != plain path")
        for mode in RTLEmulator.MODES:
            assert_bit_exact(graph, reqs[4], mode=mode)  # vs float oracle
        log(f"phase 4 served {arch}: {len(reqs)} requests, "
            f"{sum(map(len, reqs))} windows; = solo runs, plain path and "
            "float oracle")
    # the kernels line reports the main path's own run: elastic-lstm
    launches = path_launches["elastic-lstm"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")

    # ---- 5. timing ---------------------------------------------------------
    spec = p_cell["spec"]
    out = torch.empty_like(seq)
    kernel_rows = []
    B, S, din, H = B_SERVE, spec.seq_len, spec.d_in, spec.hidden
    depth = cell_args[3].numel() + cell_args[4].numel()
    b1_ms = {name: time_ms(functools.partial(
        lstm_window_int_cuda, *cell_args, out, spec=spec, variant=name))
        for name in ("mma", "simt")}
    # the same mma launches with zero weights and biases: every gate code,
    # and so every ROM address, is then one value across a warp, so the
    # gathers cannot conflict on a bank; the difference is what conflicts
    # cost at the real weights
    zero_args = (cell_args[0], torch.zeros_like(cell_args[1]),
                 torch.zeros_like(cell_args[2]), *cell_args[3:])
    mma_zero = time_ms(functools.partial(
        lstm_window_int_cuda, *zero_args, out, spec=spec, variant="mma"))
    plain = time_ms(functools.partial(lstm_window_int_ref, *cell_args,
                                      spec=spec), reps=3)
    # three bounds: the bytes (each input read once, the sequence written
    # once), the gate product as int32 multiply-adds (what simt issues; mma
    # puts it on the tensor cores), and the elementwise work both do
    io_bytes = 4 * (B * S * din + (din + H) * 4 * H + 4 * H + depth
                    + B * S * H)
    bnd_bytes = bound_ms(io_bytes, 0)[0]
    bnd_imad = bound_ms(0, B * S * (din + H) * 4 * H)[0]
    bnd_ew = bound_ms(0, B * S * H * B1_EW_OPS, INT32_ISSUE_PER_S)[0]
    routed = lstm_ops.variant(spec)
    applicable = {"mma": (bnd_bytes, bnd_ew),
                  "simt": (bnd_bytes, bnd_imad, bnd_ew)}[routed]
    bnd = max(applicable)
    kernel_rows.append({
        "name": "lstm_cell_int", "route": "cuda",
        "source": "src/repro_torch/csrc/lstm_cell_int.cu",
        "replaces": "src/repro/kernels/lstm_cell_int/kernel.py:52",
        "launches": launches["lstm_cell_int"],
        "max_abs_err": errs["lstm_cell_int"], "ms": b1_ms[routed],
        "plain_ms": plain, "bound_ms": bnd,
        "bound_by": "bytes" if bnd == bnd_bytes else "operations",
        "library_ms": None})
    log(f"phase 5 lstm_cell_int B={B} S={S} d_in={din} H={H}: kernel mma "
        f"{b1_ms['mma']:.4f} ms (zero weights, no bank conflicts: "
        f"{mma_zero:.4f} ms), simt {b1_ms['simt']:.4f} ms, plain "
        f"{plain:.4f} ms; bounds: bytes {bnd_bytes:.4f} ms ({io_bytes} B), "
        f"IMAD {bnd_imad:.4f} ms, elementwise {bnd_ew:.4f} ms "
        f"({B1_EW_OPS} int32 ops per window, step and unit at 128 a clock "
        f"an SM); routed "
        f"{routed}, bound {bnd:.4f} ms")
    # what the compiler made of one (window, step, unit) of Table I's mma
    # instance: its unrolled n8-tile loop holds one IMMA an iteration, and
    # an iteration is one lane's (window, unit) of a step
    ops = sass_iteration(build.library_path("lstm_cell_int"),
                         "lstm_mma_kernelILi10ELi1E")
    if ops is None:
        log("phase 5 lstm_cell_int mma SASS: not measured (no cuobjdump)")
    else:
        n_instr = sum(ops.values())
        log(f"phase 5 lstm_cell_int mma<10, 1> SASS: {n_instr} "
            "instructions a lane per (window, step, unit), "
            f"{bound_ms(0, B * S * H * n_instr, INT32_ISSUE_PER_S)[0]:.4f} "
            "ms to issue at 128 a clock an SM: " + ", ".join(
                f"{op} {n}" for op, n in ops.most_common()))
    mac_rows = {}
    for name, (args, shift, fmt) in mac_cases.items():
        xh, w, b = args
        o = torch.empty((xh.shape[0], w.shape[1]), dtype=torch.int32,
                        device="cuda")
        k_ms = time_ms(functools.partial(mac_int_cuda, xh, w, b, o,
                                         shift=shift, lo=fmt.lo, hi=fmt.hi))
        p_ms = time_ms(functools.partial(mac_int_ref, xh, w, b, shift=shift,
                                         lo=fmt.lo, hi=fmt.hi), reps=5)
        rows, K = xh.shape
        N = w.shape[1]
        bnd, by = bound_ms(4 * (rows * K + K * N + N + rows * N),
                           rows * K * N)
        mac_rows[name] = (k_ms, p_ms, bnd, by)
        log(f"phase 5 mac_int {name} ({rows},{K})@({K},{N}) shift {shift}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bnd:.5f} ms "
            f"({by})")
    k_ms, p_ms, bnd, by = mac_rows["lstm_head"]
    kernel_rows.append({
        "name": "mac_int", "route": "cuda",
        "source": "src/repro_torch/csrc/mac_int.cu",
        "replaces": "src/repro/rtl/oplib.py:56",
        "launches": launches["mac_int"], "max_abs_err": errs["mac_int"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None})
    for arch, (graph, _, _) in served.items():
        x = requests(graph, (B_SERVE,))[0]
        run_ms = {}
        for mode in ("fused", "jnp"):
            em = RTLEmulator(graph, mode=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            em.run(x)                            # builds: warm-up + capture
            torch.cuda.synchronize()
            build = (time.perf_counter() - t0) * 1e3
            # a warm program: each run is one CUDA Graph replay; beside it
            # the same walk run eagerly, a launch at a time, as the
            # emulator ran before it had programs
            run_ms[mode] = host_ms(functools.partial(em.run, x))
            eager = host_ms(lambda: em._result(em._execute(em._quantize(x),
                                                           em.mode)))
            log(f"phase 5 emulator {arch} {mode}: "
                f"{B_SERVE / run_ms[mode] * 1e3:.0f} windows/s "
                f"({run_ms[mode]:.3f} ms per {B_SERVE}-window run on a warm "
                f"program, {em.trace_count} capture; the eager walk "
                f"{eager:.3f} ms; the first run, which builds the program, "
                f"{build:.3f} ms; host clock, float windows in)")
        em = RTLEmulator(graph, mode="fused")
        em.run(x)                                # build: capture outside
        wall, device = profile_ms(functools.partial(em.run, x))
        busy = sum(device.values())
        if busy == 0:
            log(f"phase 5 profile {arch} fused: device time not measured "
                "(the profiler saw no GPU activity)")
            continue
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        b1_dev = sum(t for name, t in device.items() if "lstm_" in name)
        log(f"phase 5 profile {arch} fused, one {B_SERVE}-window run "
            "(a replay): "
            f"device busy {busy:.4f} ms = {100 * busy / run_ms['fused']:.1f}% "
            f"of the unprofiled run ({wall:.3f} ms with the profiler on); "
            f"B1 {b1_dev:.4f} ms = {100 * b1_dev / busy:.1f}% of busy; "
            + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top))

    # ---- 6. serve Yi-9B (the LM main path) ---------------------------------
    t0 = time.perf_counter()
    par = ParallelismConfig(compute_dtype="bfloat16", attn_impl="flash")
    st = Stepper(yi, ShapeConfig("serve", "prefill", MAX_LEN, SLOTS),
                 SMOKE_MESH, par)
    params = st.init(seed=SEED, dtype_override=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"phase 6 yi-9b: {param_count(st.schema) / 1e9:.3f} B parameters "
        f"drawn on the card in bf16 in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    lm_rng = np.random.default_rng(SEED + 6)
    prompts = [lm_rng.integers(2, yi.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    warm = Server(yi, params, ServerConfig(batch_slots=1, max_len=64,
                                           eos_token=-1), SMOKE_MESH, par)
    warm.submit(prompts[0], max_new_tokens=2)       # cuBLAS/allocator warm-up
    warm.run_until_drained()
    del warm
    srv = Server(yi, params, ServerConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                          eos_token=-1), SMOKE_MESH, par)
    tracer = Tracer()
    prev_tracer = set_tracer(tracer)
    for mod in (flash_ops, dec_ops):
        mod.launches = 0
        mod.launches_by_variant = dict.fromkeys(mod.launches_by_variant, 0)
    t0 = time.perf_counter()
    for prompt in prompts:
        srv.submit(prompt, max_new_tokens=MAX_NEW)
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    yi_launches = flash_ops.launches
    yi_variants = dict(flash_ops.launches_by_variant)
    yi_decode = {"launches": dec_ops.launches,
                 "ticks": len(find_spans(tracer.spans, "server.decode"))}
    set_tracer(prev_tracer)
    stats = done.stats
    if not done.drained or stats.admitted != len(prompts) or \
            stats.retired != len(prompts):
        raise AssertionError(f"yi-9b: server did not serve every request: "
                             f"{stats}")
    for req in done:
        if len(req.out_tokens) != MAX_NEW or not all(
                0 <= t < yi.padded_vocab for t in req.out_tokens):
            raise AssertionError(f"yi-9b: request {req.rid} out_tokens "
                                 f"{req.out_tokens}")
    if yi_launches != yi.n_layers * stats.admitted or yi_variants != {
            "sm90": yi_launches, "simt": 0}:
        raise AssertionError(f"yi-9b: B5 launched {yi_launches} times "
                             f"({yi_variants}) for {stats.admitted} "
                             f"requests, expected {yi.n_layers} per request,"
                             " all sm90")
    if yi_decode["launches"] != yi.n_layers * yi_decode["ticks"] or \
            dec_ops.launches_by_variant["mma"] != yi_decode["launches"]:
        raise AssertionError(
            f"yi-9b: the decode kernel launched {yi_decode['launches']} "
            f"times ({dec_ops.launches_by_variant}) in "
            f"{yi_decode['ticks']} decode ticks, expected {yi.n_layers} a "
            "tick, all mma")
    n_tok = sum(len(r.out_tokens) for r in done)
    prefill_ms = {sp.attrs["prompt_len"]: sp.duration * 1e3
                  for sp in find_spans(tracer.spans, "server.prefill")}
    log(f"phase 6 served yi-9b: {len(done)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.2f} tokens/s ({SLOTS} slots, "
        f"max_len {MAX_LEN}, {stats.ticks} ticks); B5 launches "
        f"{yi_launches} = {yi.n_layers} per request, by variant "
        f"{yi_variants}; decode kernel launches {yi_decode['launches']} = "
        f"{yi.n_layers} per decode tick over {yi_decode['ticks']} ticks, "
        "all mma")
    log("phase 6 ttft_s " + json.dumps(stats.ttft_s))
    log("phase 6 latency_s " + json.dumps(stats.latency_s))
    log("phase 6 prefill ms by prompt length (host clock, ends in the "
        "first token's copy to the host): " + ", ".join(
            f"{n}: {prefill_ms[n]:.1f}" for n in PROMPT_LENS))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 6 peak device memory {peak:.2f} GiB")
    del srv

    # ---- 7. flash vs ref through the whole model ----------------------------
    def last_logits(cfg, prm, impl, dtype, prompt):
        step = make_prefill_step(cfg, SMOKE_MESH, ParallelismConfig(
            compute_dtype=dtype, attn_impl=impl))
        with torch.no_grad():
            logits, _ = step(prm, {"tokens": torch.tensor(
                [prompt], dtype=torch.int64, device="cuda")})
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {impl} {dtype}: non-finite "
                                 "logits")
        return logits[0]

    bf16_bound = yi.n_layers ** 0.5 * 2.0 ** -7
    worst_rel, agree = 0.0, 0
    for req, prompt in zip(done, prompts):
        lf = last_logits(yi, params, "flash", "bfloat16", prompt)
        lr = last_logits(yi, params, "ref", "bfloat16", prompt)
        if int(lf.argmax()) != req.out_tokens[0]:
            raise AssertionError(f"yi-9b: served first token "
                                 f"{req.out_tokens[0]} != flash prefill's "
                                 f"{int(lf.argmax())}")
        rel = ((lf - lr).norm() / lr.norm()).item()
        worst_rel = max(worst_rel, rel)
        agree += int(lf.argmax()) == int(lr.argmax())
        log(f"phase 7 bf16 48 layers S={len(prompt)}: rel rms |flash-ref| "
            f"{rel:.3e}, max abs {(lf - lr).abs().max().item():.3e} "
            f"(logits max abs {lr.abs().max().item():.3f}), first token "
            f"flash {int(lf.argmax())} ref {int(lr.argmax())}")
    if worst_rel > bf16_bound:
        raise AssertionError(f"yi-9b bf16: flash vs ref logits rel rms "
                             f"{worst_rel:.3e} > bound {bf16_bound:.3e}")
    log(f"phase 7 bf16 full depth: worst rel rms {worst_rel:.3e} <= bound "
        f"sqrt(48) * 2^-7 = {bf16_bound:.3e}; first tokens agree on "
        f"{agree}/{len(prompts)}")

    # ---- 15, first part. the host target: Yi-9B deployed ------------------
    smi = card_name_and_limit()

    def decode_args(st):
        cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                               device="cuda"),
                         st.cache_schema(), is_leaf=is_pspec)
        for layer in cache["layers"]:          # half of every slot filled
            layer["pos"].fill_(MAX_LEN // 2)
        last = torch.tensor([[p[-1]] for p in prompts[:SLOTS]],
                            dtype=torch.int32, device="cuda")
        return params, last, cache

    host = {"prefill": host_deploy(
        yi, params, HOST_PREFILL, lambda st: (params, {"tokens": torch.tensor(
            [prompts[5]], dtype=torch.int32, device="cuda")}), flash_ops,
        smi)}
    host["decode"] = host_deploy(yi, params, HOST_DECODE, decode_args,
                                 flash_ops, smi)
    torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    yi4 = yi.with_(n_layers=4)
    params4 = Stepper(yi4, ShapeConfig("check", "prefill", MAX_LEN, 1),
                      SMOKE_MESH, ParallelismConfig(compute_dtype="float32")
                      ).init(seed=SEED + 1)
    worst_rel = 0.0
    for prompt in prompts:
        lf = last_logits(yi4, params4, "flash", "float32", prompt)
        lr = last_logits(yi4, params4, "ref", "float32", prompt)
        rel = ((lf - lr).abs().max() / lr.abs().max()).item()
        worst_rel = max(worst_rel, rel)
        if rel > F32_LOGIT_REL_TOL or int(lf.argmax()) != int(lr.argmax()):
            raise AssertionError(
                f"yi-9b f32 4 layers S={len(prompt)}: rel {rel:.3e} (bar "
                f"{F32_LOGIT_REL_TOL}), tokens {int(lf.argmax())} vs "
                f"{int(lr.argmax())}")
    log(f"phase 7 f32 full width, 4 layers: worst max|flash-ref|/max|ref| "
        f"{worst_rel:.3e} <= {F32_LOGIT_REL_TOL}; greedy tokens identical "
        f"on {len(prompts)}/{len(prompts)}")
    del params4
    torch.cuda.empty_cache()

    # ---- 8. B5 timing --------------------------------------------------------
    b5_rows = {}
    for n in (1024, 2048, 4000):
        shape = (1, n, yi.n_heads, yi.hd)
        q, k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16)
                   * 0.5 for _ in range(3))
        out = torch.empty_like(q)
        flops = 4 * (n * (n + 1) // 2) * yi.hd * yi.n_heads
        name = flash_ops.variant(q, k, v)         # what the wrapper launches
        times = {name: time_ms(functools.partial(
            flash_attention_cuda, q, k, v, out, causal=True, variant=name))}
        if n == 2048:
            times["simt"] = time_ms(functools.partial(
                flash_attention_cuda, q, k, v, out, causal=True,
                variant="simt"))
        p_ms = time_ms(functools.partial(attention_ref, q, k, v, True),
                       reps=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = time_ms(functools.partial(
            F.scaled_dot_product_attention, qt, kt, vt, is_causal=True))
        bnd, by = bound_ms(4 * q.numel() * q.element_size(), flops,
                           BF16_FLOP_PER_S)
        b5_rows[n] = (times[name], p_ms, l_ms, bnd, by)
        log(f"phase 8 B5 (1, {n}, 32, 128) bf16 causal: " + ", ".join(
            f"kernel {var} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
            for var, ms in times.items())
            + f", plain {p_ms:.4f} ms, scaled_dot_product_attention "
            f"{l_ms:.4f} ms ({flops / l_ms / 1e9:.1f} TFLOP/s), bound "
            f"{bnd:.4f} ms ({by})")
    yi8 = yi.with_(n_layers=8)
    params2 = Stepper(yi8, ShapeConfig("p", "prefill", 2048, 1), SMOKE_MESH,
                      par).init(seed=SEED, dtype_override=torch.bfloat16)
    prefill = make_prefill_step(yi8, SMOKE_MESH, par)
    decode = make_decode_step(yi8, SMOKE_MESH, par)
    toks = torch.tensor([prompts[5]], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        _, cache = prefill(params2, {"tokens": toks})
        pool = {"layers": tuple(      # 4 slots at 2,048 of 4,096 positions
            {key: torch.cat([buf] * SLOTS) for key, buf in c.items()}
            for c in pad_cache(cache, MAX_LEN)["layers"])}
        last = torch.zeros((SLOTS, 1), dtype=torch.int64, device="cuda")
        _, pool = decode(params2, last, pool)
        for label, fn in (
                ("one 2048-token prefill", lambda: prefill(
                    params2, {"tokens": toks})),
                (f"one decode tick of {SLOTS} slots over a {MAX_LEN}-"
                 "position cache", lambda: decode(params2, last, pool))):
            fn()
            wall, device = profile_ms(fn)
            busy = sum(device.values())
            if busy == 0:
                log(f"phase 8 profile, {label}: device time not measured "
                    "(the profiler saw no GPU activity)")
                continue
            b5_dev = sum(t for name, t in device.items()
                         if "flash_fwd" in name)
            top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
            log(f"phase 8 profile, {label} of 8 Yi-9B layers: device busy "
                f"{busy:.3f} ms of {wall:.3f} ms host clock (profiler on); "
                f"B5 {b5_dev:.3f} ms = {100 * b5_dev / busy:.1f}% of device "
                "time; " + "; ".join(f"{name[:60]} {ms:.3f} ms"
                                     for name, ms in top))
    del params2, cache, pool
    k_ms, p_ms, l_ms, bnd, by = b5_rows[2048]
    kernel_rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "launches": yi_launches,
        "host_target_launches": host["prefill"]["b5_launches"],
        "max_abs_err": max(b5_err.values()), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bnd, "bound_by": by, "library_ms": l_ms})

    # ---- 9-12. the wrapper-only templates at full width --------------------
    from repro_torch.kernels.lstm_cell import ops as lstm_f_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.quant_matmul import ops as qmm_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    ops_by_name = {"lstm_cell_int": lstm_ops, "mac_int": mac_ops,
                   "flash_attention": flash_ops, "lstm_cell": lstm_f_ops,
                   "quant_matmul": qmm_ops, "ssd": ssd_ops, "wkv6": wkv_ops}
    for phase in (phase_b3, phase_b4, phase_b6, phase_b7):
        kernel_rows.append(phase(ops_by_name))
        torch.cuda.empty_cache()

    # ---- 13. toolchain and conformance -------------------------------------
    phase_toolchain(ops_by_name, smi)

    # ---- 14. the paper's loop ----------------------------------------------
    loop = phase_loop(ops_by_name, smi)
    for row in kernel_rows:
        key = {"lstm_cell_int": "B1", "mac_int": "B2"}.get(row["name"])
        if key is not None:
            row["workflow_launches"] = sum(n[key] for n in loop.values())

    # ---- 15, second part. the paper's default loop on the host target ------
    phase_host_loop(ops_by_name, smi)

    # ---- 16. the accelerator farm ------------------------------------------
    farm = phase_farm(lstm_ops, mac_ops, smi)

    # ---- 17. multi-design emulation ----------------------------------------
    multi = phase_multi(lstm_ops, mac_ops, smi)
    for row in kernel_rows:
        if row["name"] == "lstm_cell_int":
            row["farm_launches"] = farm["mma"] + farm["simt"]
            row["multi_launches"] = multi["mma"] + multi["simt"]
        elif row["name"] == "mac_int":
            row["farm_launches"] = farm["B2"]
            row["multi_launches"] = multi["B2"]

    # ---- 18. the resilience layer -----------------------------------------
    resil = phase_resilience(lstm_ops, mac_ops, smi)
    for row in kernel_rows:
        if row["name"] == "lstm_cell_int":
            row["resilience_launches"] = resil["mma"] + resil["simt"]
            row["resilience_launches_by_variant"] = {
                k: resil[k] for k in ("mma", "simt")}
        elif row["name"] == "mac_int":
            row["resilience_launches"] = resil["B2"]

    # ---- 19. LM training ---------------------------------------------------
    train = phase_train(ops_by_name, smi)
    for row in kernel_rows:
        if row["name"] == "flash_attention":
            row["train_launches"] = train["train_launches"]
            row["host_target_train_launches"] = train["host_train_launches"]

    # ---- 20. the LM families ----------------------------------------------
    # (phase 23, the collectives, runs inside it on its DeepSeek weights)
    families = phase_families(ops_by_name, smi)
    collectives = families.pop("collectives")
    for row in kernel_rows:
        if row["name"] == "flash_attention":
            row["families_launches"] = families
            row["collectives_launches"] = collectives

    # ---- 21. the hybrid and RWKV families ----------------------------------
    scans = phase_scan_families(ops_by_name, smi)
    for row in kernel_rows:
        if row["name"] == "flash_attention":
            row["families_launches"].update(
                {arch: n["flash_attention"] for arch, n in scans.items()
                 if "flash_attention" in n})
        elif row["name"] in ("ssd", "wkv6"):
            row["families_launches"] = {
                arch: n[row["name"]] for arch, n in scans.items()
                if row["name"] in n}
    # B2 again, as in phase 5, after the families' runs
    xh, w, b = mac_cases["lstm_head"][0]
    shift, fmt = mac_cases["lstm_head"][1:]
    o = torch.empty((xh.shape[0], w.shape[1]), dtype=torch.int32,
                    device="cuda")
    b2_again = time_ms(functools.partial(mac_int_cuda, xh, w, b, o,
                                         shift=shift, lo=fmt.lo, hi=fmt.hi))
    log(f"phase 21 B2 mac_int lstm_head timed again after phase 21: "
        f"{b2_again:.4f} ms (phase 5: {mac_rows['lstm_head'][0]:.4f} ms) "
        f"({smi})")

    # ---- 22. scan-over-layers and C10 --------------------------------------
    scan_layers = phase_scan_layers(ops_by_name, smi)
    for row in kernel_rows:
        if row["name"] in ("flash_attention", "ssd", "wkv6"):
            row["scan_launches"] = {
                arch: n[row["name"]] for arch, n in scan_layers.items()
                if row["name"] in n}

    # ---- 24. the "model" split at tp = 2, 25. the dry-run ------------------
    import tempfile

    tp = phase_tp(ops_by_name, smi)
    for row in kernel_rows:
        if row["name"] in tp:
            row["tp_launches"] = tp[row["name"]]
    with tempfile.TemporaryDirectory() as dry_dir:
        t_dry = time.perf_counter()
        dry = dryrun_start(dry_dir)
        try:
            phase_dryrun(dry, dry_dir, t_dry, smi)
        finally:
            for p in dry:
                if p.poll() is None:
                    p.kill()
                    p.communicate()

    # ---- 26. the decode-attention kernel ----------------------------------
    kernel_rows.append(phase_decode_attention(smi, yi_decode))

    # ---- report -------------------------------------------------------------
    log(smi)                     # the card's name and power limit
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
