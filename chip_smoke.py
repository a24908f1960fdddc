#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gigapath_tpu_torch``) on one GPU.

    python3 chip_smoke.py

It takes no arguments and always runs every phase, one JSON line each on
stdout:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. build: compile the CUDA kernels of ``gigapath_tpu_torch/csrc`` (one nvcc
   per library, all in parallel); ptxas' register report goes to stderr.
3. kernels: the ``cuobjdump -sass`` HMMA counts of the forwards'
   libraries on the shared tile steps (rows 1 and 6, and the segment-flash
   forward of rows 11 and 13) at Dh = 48, checked non-zero (bf16 runs on
   the tensor cores, fp32 on the FMA kernels), with ptxas' registers and
   spills of their tensor-core kernels, and the 128-bit global loads and
   stores (``LDG.E.128``, ``STG.E.128``) of the pack and unpack (rows 2,
   3), checked non-zero; for each branch of the flagship schedule at L =
   10241 (10240 tiles + cls), E = 768, H = 16, in fp32 and bf16 with a
   ragged real length, pack -> branch attention -> unpack against their
   plain PyTorch versions on the card (the copies bit-exact); times beside
   each kernel's bound and a library call's time (SDPA for the attention,
   ``torch.take`` with a precomputed index for the pack, ``index_copy_``
   for the unpack): each kernel's device time from a CUDA graph beside its
   wrapper's CUDA-event time, the exp2 floor of the branch kernel's
   admitted pairs, the copies' library calls by both clocks. Then the
   branch kernel once more at a batch of more than 65535 (batch, segment,
   head) cells, bf16, with per-row valid lengths and one row with none (out
   exactly 0, lse at most -1e19); bf16 inputs the tensor-core forwards
   cannot take (Dh = 20, a misaligned q6) refused by both wrappers; and
   the pack and unpack on their tilings' edges (``COPY_EDGES``: g % r != 0,
   a ragged last segment, B = 2, Dh = 20, a one-element shift, two
   flagship branches), fp32 and bf16, bit-exact through the wrappers and
   as a canary (the C entries into NaN-filled outputs one tile past the
   tensor: every slot inside written, the tail still NaN), and a shape
   their entries refuse (Mp * r < g) raising in both wrappers.
4. slide_forward: the flagship ``gigapath_slide_enc12l768d`` with seeded
   random weights through ``create_model`` and
   ``run_inference_with_slide_encoder`` on 10240 tiles, in fp32 and bf16,
   each layer's embedding against the port's plain path on the card, and
   the kernels' launch counts of one forward.
5. ragged_batch: B = 2 with a pad mask; each row against its slide alone.
6. bwd_kernels: the ``cuobjdump -sass`` HMMA counts of the dq and dkv
   libraries, serial and pipelined (rows 7 and 8), at Dh = 48, checked
   non-zero (bf16 runs on the tensor cores, fp32 on the FMA kernels), with
   ptxas' registers and spills of their tensor-core kernels; the two kernels against their plain version
   at each flagship branch shape (L = 10241, ragged real length), fp32 and
   bf16: each kernel's device time from a CUDA graph, its wrapper's
   CUDA-event time, the exp2 floor of its admitted pairs, its bound, the
   plain version's time and the backward of one library attention call;
   then bf16 past 65535 cells with per-row valid lengths, one row with none
   (kvlen = 0: its gradients exactly 0), the causal forward and backward at
   one branch shape, fp32 and bf16, and bf16 inputs the tensor-core dq and
   dkv cannot take (Dh = 20, a misaligned dO) refused by the four
   wrappers, serial and pipelined.
7. head_widths: the forward, dq and dkv kernels (and the three
   segment-flash kernels, and the streaming pair's dq and dkv) at the
   registry's other head widths (16, 24, 32, 64, 96) against their plain
   versions, fp32 and bf16, with ptxas' spill
   stores of each and the registers and spills of the branch kernels'
   tensor-core kernels, serial and pipelined (the build phase builds every
   width).
8. finetune_step: the flagship ``ClassificationHead`` (``feat_layer`` 11, 6
   classes as PANDA) built by ``get_model`` and trained by
   ``finetune/training.py``'s ``train_step`` on a synthetic 10240-tile
   slide: one fp32 step's gradients against the plain path (and bf16 by
   cosine), the kernels' launch counts of one bf16 step (the main path the
   final ``kernels`` line reports), ms per step and peak memory in bf16
   and fp32; the synced step (``scalars`` with numerics, the loop's
   20-iteration echo) timed beside the step without them, and at gc = 2
   its gradients and update bit-equal to theirs with finite norms; and six
   optimizer steps on one batch, whose loss must fall.
9. q_kernels: the quantized tile tier's kernels against their plain
   versions: ``q_matmul`` (int8 and fp8-e4m3) at the flagship tile
   encoder's four (K, N) with M = 128 tiles x 197 tokens, and at ragged
   shapes (K = 100 zero-padded), its fused epilogue (scale, bias, bf16
   cast) bit-equal to the unfused three steps on the same product, and
   ``tflops`` with the share of the bound; ``q_flash_attention`` at B =
   128, H = 24, L = 197, D = 64 and at L = 1 and 65, bf16 v (tensor cores)
   and fp32 v (FMA pipes); CUDA-event times beside the bound, the plain
   version and a library call (cuBLAS bf16 ``torch.matmul``; SDPA); the
   ``cuobjdump -sass`` counts of tensor-core instructions in both
   libraries (HGMMA in q_matmul, IMMA and HMMA in q_flash_attention).
10. tile_forward: the flagship ``gigapath_tile_enc`` (40 blocks, E =
    1536, bf16 compute) with seeded random weights, its LayerScales drawn
    at O(0.1-1), through ``run_inference_with_tile_encoder`` on 160
    synthetic PNG tiles (one full 128-tile batch and a padded partial
    one) in three tiers: bf16 (no kernel), ``int8+attn`` (both kernels)
    and ``fp8_e4m3`` (``q_matmul`` only); each against the same tier on
    the plain path, the launches of one 128-tile batch (exactly 160
    ``q_matmul`` and 40 ``q_flash_attention`` in ``int8+attn``, 160 and
    0 in ``fp8_e4m3``), ms per batch through the entry and for the
    forward alone, a profiler breakdown of one forward, peak memory, and
    each quantized tier's mean cosine against bf16.
11. two_stage: the 160 ``int8+attn`` tile embeddings and their coords
    through ``run_inference_with_slide_encoder`` on the flagship slide
    encoder (bf16), against the plain path.
12. stream_kernels: the ``cuobjdump -sass`` HMMA counts of the dq and dkv
    libraries at Dh = 48 (row 16: bf16 on the tensor cores, fp32 on the
    FMA kernels), checked non-zero, with their tensor-core kernels' ptxas
    registers and spills (no spill store); the streaming chunk-pair
    kernels (forward, dq, dkv) against their plain versions at flagship
    chunk pairs (2048-row blocks at the token offsets of a 10240-tile
    slide, H = 16, Dh = 48) for each of the 5 branch geometries (g = 1024,
    5792 and three clamped to L = 10241), fp32 and bf16: pairs across
    segment boundaries, the 1-row cls block as queries and as keys, a
    ragged valid bound, a pair whose rows are all masked (out and gradients
    exactly 0), a nonzero lse cotangent, q, k, v strided views of packed
    [B, c, 3, H, Dh] blocks; the kernels' device times (a CUDA graph of 20
    calls) and one wrapper call's CUDA-event time beside the bound, the
    plain version and one SDPA call with the boolean mask (and its
    backward) by device time (``queued_ms``: calls queued behind a spin
    kernel) and by CUDA events around one call; ptxas' registers and
    spills. Then a stray-write canary (the bf16
    dq and dkv C entries called directly into NaN-filled dq, dk, dv one row
    past the tensor at ``STREAM_CANARY``: a step-8 lattice with a ragged
    valid bound and a g % r != 0 pair across segment boundaries, lattice
    step 1; rows off the lattice, keys past valid and the extra row stay
    NaN, the rows written bit-equal to the wrappers') and bf16 blocks the
    tensor-core dq and dkv cannot take (a misaligned q, a k head stride of
    104 bytes) refused by both wrappers.
13. stream_forward: ``create_streaming_session`` and
    ``run_inference_with_slide_encoder_streaming`` on one 10240-tile slide
    (chunks of 2048): fp32 against the dense kernel path (two independent
    kernel paths), bf16 against the streaming plain path; the launches of
    one forward (exactly the session's 1776 folds of ``stream_pair_fwd``,
    no other kernel); out-of-order delivery with duplicates and an
    export/restore halfway, both bit-exact; ``peek()`` after every chunk;
    ms per slide, tiles/s and peak memory beside the dense entry's, and a
    profiler breakdown of one bf16 forward. Then the gradients of one
    layer's streaming attention (``streaming_dilated_attention``) against
    the dense kernel path's, fp32 (rel) and bf16 (1 - cosine, also against
    the streaming plain path), with the backward kernels' launches (148 dq
    and 148 dkv each).
14. stream_serve: ``StreamingSubmitter.stream_slide`` answers 3 requests
    (10240, 4097 and 2048 tiles, chunks in reverse order), each against the
    dense entry; ``head_streaming_submitter`` and ``streaming_head_logits``
    on a flagship ``ClassificationHead`` (4097 tiles) against its dense
    logits.
14b. serve: the serving stack (``gigapath_tpu_torch/serve``). First one
    masked bf16 forward of the flagship slide encoder at [4, 2048] under
    ``torch.cuda.set_sync_debug_mode("error")`` on the per-row path a
    capture takes (no host sync). Then the CLI's default path,
    ``inference.run_inference(use_buckets=True, batch_size=4)`` on the
    flagship head (``load_model``: bf16, random weights from seed 0) over
    feature files of 10240, 9000, 6000, 3000, 2048 and 1 tiles and a copy
    of the first: five buckets, so five CUDA-graph captures (compile events
    of ``serve.forward``, none unexpected), five dispatches, the copy one
    ``cache_hit`` event (it joins its twin, still waiting in its bucket),
    every label equal to the ``--no-buckets`` path's, the run log's event
    counts and the ledger's per-capture seconds, pool bytes and launches,
    and the same run with ``--prefetch 2`` (a loader thread through the
    dist boundary's memory channel) giving the same CSV bit for bit;
    the launches of the run (every count set to 0 just before it) include
    the pack, branch forward and unpack. Then a ``SlideService`` whose
    forward gives the slide encoder's final embedding, fp32 and bf16, on
    the same slides: each row against the slide's exact-shape eager
    forward (fp32 rel <= 1e-5, bf16 1 - cosine <= 5e-4), the copy
    submitted after the drain a true cache hit, every captured bucket's
    dummy rows finite, a second pass over new content at the same lengths
    capturing nothing (``unexpected_retraces`` empty, ``compiled_count``
    unchanged), ``torch.cuda.memory_reserved()`` after the captures. Last,
    a 10240-tile bf16 slide on a ladder whose lowest rung is 10240 with
    capacity 1 (the default forward at L = 10241 in one graph): in turns,
    the graph replay alone, the same forward eager under
    ``inference_mode``, the pipeline entry as ``default_route_times``
    times it, and the service's whole dispatch (batch assembly, input
    copy, replay, copy to the host), each by host clock (median of 5) and
    by ``torch.profiler`` (device busy, idle share), with the capture's
    seconds; each line with the card's name and power limit. At the end,
    with the models gone and no garbage collection, the reserved memory is
    back within SERVE_MEMORY_SLACK of the phase's start (a closed service
    hands its graphs' memory back at once; a graph cache that waited for
    the collector once left the large keys' pool held into the next
    phases), and ``torch.profiler`` still records device activity.
14c. dist: the disaggregated two-stage pipeline at full width. The plan:
    2048 synthetic 224 x 224 tiles in 16 chunks of 128, two ViT-G/14
    ``int8+attn`` worker processes (``python -m
    gigapath_tpu_torch.dist.worker --device cuda``, both on the one card)
    into the flagship head of ``inference.load_model`` (bf16) in this
    process. First the workers' encoder in process: its q_matmul and
    q_flash_attention launches, its seconds beside those of making the
    synthetic tiles alone, every chunk's embeddings kept. Then three runs,
    each with its wall time, the workers' start (spawn to the first
    encode), each worker's encode seconds, each chunk's transit (send end
    to deliver start) and the merged fleet timeline's critical path
    (``obs/fleet.py``), on the links' clock estimates and on the host's
    shared monotonic clock: (1) over the ``dir`` transport: every
    assembled row equal to the in-process encoder's, the result (the
    last-layer embedding and the logits) equal to one forward of the same
    rows in this process, with the same launches (every count set to 0
    just before each), and within 1 - cos 5e-4 of
    ``run_inference_with_slide_encoder``; (2) over ``tcp`` with
    ``kill_worker@4`` on w1: exit codes 0 and -9, ``worker_lost`` and
    ``recovery action="reassign"`` events, assembled rows and result
    bit-equal to run 1's; (3) chunked prefill: within 1 - cos 5e-4 of run
    1, equal to one streaming session's result in this process, with the
    same ``stream_pair_fwd`` launches. The phase's seconds last.
14d. train_wsi: the whole-slide training entry at full width.
    ``train_gigapath.main`` on two synthetic 8192 x 8192 px PNG slides (a
    ``?download=1`` suffix on one, so the rename runs): tiling
    (``tile_one_slide``: Otsu, the host C++ occupancy, 256 px PNG tiles),
    the flagship tile encoder built by the factory with no tier given, so a
    ``tile_encoder.gigapath_tile_enc`` plan blessed in a temporary registry
    picks ``int8+attn`` (the plan seam), its features cached, then 3 epochs
    (6 steps) of the flagship head (``feat_layer`` 11, bf16, the encoder
    frozen at the optimizer) with a checkpoint a step. Checked: tiles kept
    per slide and tiling seconds; features ``[N, 1536]`` bit-equal to
    ``run_inference_with_tile_encoder`` on the same tile files in this
    process; ``q_matmul`` / ``q_flash_attention`` launches of the tile
    stage exactly 160 / 40 a 128-tile batch, and the dilated rows' exactly
    ``STEP_LAUNCHES`` a training step; finite losses; the frozen encoder
    bit-equal to its initial weights; one step's gradients on the first
    slide's features (its own length, every branch clamped to one short
    segment) through the kernels against their plain versions, 1 - cosine
    within ``GRAD_BF16_MAX_ONE_MINUS_COS``; ms per step, tiles/s at the
    entry, peak memory. Then on the same cached features: ``GIGAPATH_CHAOS=
    nan_loss@2`` skips step 2 (its checkpoint's parameters and AdamW state
    bit-equal to step 1's, a ``recovery action="skip_step"`` event); two
    NaN steps under ``GIGAPATH_GUARD_ROLLBACK_AFTER=2`` write a rollback;
    2 epochs then ``resume="auto"`` to 3 end bit-equal to the uninterrupted
    run (parameters, AdamW state, the dropout generator). The phase's
    seconds last.
14e. harness: the three harness entries. ``harness_parity``:
    ``quant.parity.parity_report`` on the committed fixture
    (``vit_tile_enc_test``: E = 32, 4 heads of 8, 5 tokens) in bf16,
    int8, fp8_e4m3 and int8+attn through the kernels (the launches of
    rows 17 and 18 exact), each variant's embeddings against the same
    variant on the plain path (1 - cosine within
    ``TILE_MAX_ONE_MINUS_COS``), each quantized variant's cosine against
    the fp32 oracle at least ``COSINE_BAR``; the probe deltas and the
    ``adopt_quant_tile`` row (``decision_table`` with the bf16 and
    int8+attn forward ms of a 128-tile batch that tile_forward measured)
    printed, not gated. ``harness_probe``: 4096 synthetic 224 px PNG tiles
    of two stain classes embedded by the flagship tile encoder in
    int8+attn (random weights), a PCam-shaped zip of per-tile ``.pt``
    tensors and csv (2048 / 1024 / 1024), then
    ``linear_probe.main`` at batch 512 for 1000 iterations with evals at
    500 and 1000: ``results.txt`` and the run log's ``eval`` and
    ``run_end`` events, test AUROC at least ``HARNESS_PROBE_AUROC``, the
    final parameters within ``HARNESS_PROBE_RTOL`` of a CPU ``train`` from
    the same initial parameters and embeddings; ms per iteration, encode
    tiles/s, peak memory. ``harness_pretrain``:
    ``pretrain_gigapath.main`` on two synthetic 4096 px slides with the
    full-width tile encoder (bf16 compute, fp32 master weights), 2 tile
    epochs at batch 16 and 5 slide epochs: every loss finite, the restored
    best encoder's features on one batch bit-equal to the live encoder's
    when that checkpoint was written, and one MAE step of a 2-block
    full-width copy in fp32 on the card against the same step on the CPU
    (loss, gradients and parameters, ``MAE_STEP_TOL``); ms per MAE step
    (median and first), tiles/s, peak memory, checkpoint seconds and bytes,
    the stage-2 loss per epoch. The phase's seconds last.

15. fusion_kernels: the stream-fusion route's four kernels against their
    plain versions at the flagship's branch shapes (L = 10241), fp32 and
    bf16, with a ragged real length (timed) and a B = 2 batch with per-row
    valid lengths: ``pack_phases_direct`` (q, k and v in one launch) and
    ``unpack_phases_direct`` on the three single-segment branches (r = 4,
    8, 16), bit-exact and bit-equal to ``pack_phases``/``unpack_phases``;
    ``fusion_epilogue_fwd`` over the five branches' packed results, also
    against the default route's dense fusion; ``fusion_epilogue_bwd`` over
    the five branches in one launch, exact zeros off the extent; each
    kernel's device time (from a
    CUDA graph of 20 calls; one call's CUDA-event time, mostly the
    wrapper's host work, beside it) against the bound, the plain version
    and a library call (``torch.take``, ``index_copy_``, by the same two
    clocks; none for the epilogue, whose line carries the device time of
    the default route's fusion of the same packed results instead). Then
    the same checks on ``STRADDLE_SCHEDULE`` (g = 40: segment ends inside
    the epilogue's 16-token tiles) at B = 1 and 2; per dtype a
    ``fusion_layer_ms`` line (the direct pack per branch, one tensor and
    q, k, v in one launch, the epilogue forward and backward, each beside
    its bound, and the launch floor: ``graph_ms`` of
    ``torch.cuda._sleep(1)``); the direct pack's canary (its C entry on q,
    k, v into NaN-filled destinations: one shifted by one element,
    bit-exact with nothing outside written; one off the element size,
    refused with nothing written); and the epilogue backward's canary (its
    outputs on blocks the caching allocator last held filled with NaN:
    every slot written).
16. fusion_forward: the flagship forward with ``GIGAPATH_STREAM_FUSION=1
    GIGAPATH_PACK_DIRECT=1`` against the default route, fp32 (rel) and
    bf16 (cosine), with its exact launches; ms per slide and peak memory
    of both routes on 10240 tiles and (bf16) on one 102400-tile slide, with
    the peak of one attention call alone there and rows 4 and 9 of one
    layer by device time; a profiler breakdown of one bf16 forward on each
    route.
17. fusion_step: the flagship fine-tune step on that route: fp32
    gradients against the default route, the exact launches of one bf16
    step, ms per step and peak memory of both routes (bf16).

18. ffn_gelu: the feed-forward GELU of a bf16 [10241, 3072] fc1 output in
    its own dtype against the explicit fp32 round trip, in bf16 ulps (at
    most one).
19. flash_kernels: the ``cuobjdump -sass`` counts of the three
    segment-flash libraries at D = 48 (HMMA > 0: bf16 runs on the tensor
    cores, fp32 on the FMA kernels) with their tensor-core kernels' ptxas
    registers and spills; a row-bound canary (``gp_flash_fwd`` called
    directly in bf16 on the flat r = 1 branch, whose last segment holds one
    row, and the segmented r = 12 one, m = 854, into NaN-filled out and lse
    buffers one tile longer than the tensor: nothing written past it, the
    rows inside bit-equal to the wrapper's); bf16 inputs the tensor-core
    forward cannot take (D = 20, a misaligned q) refused by flash_fwd and
    flat_fwd; the segment-flash kernels (rows 11-14: flash_fwd,
    flash_bwd_dq, flash_bwd_dkv on the segmented layout, flat_fwd,
    flat_bwd_dq, flat_bwd_dkv on the flat one) against their plain versions
    at the five head-major branches of one flagship layer with ratios [1,
    2, 4, 6, 12] (L = 10241; the r = 1 branch flat), fp32 and bf16, full
    length (timed: each kernel's device time from a CUDA graph of 20 calls
    and one call's CUDA-event time through its wrapper, beside the bound,
    the exp2 floor of one exp2 per admitted pair on the MUFU pipes, the
    plain version and SDPA with a boolean key mask and its backward) and
    with a ragged real length; the B = 2 ragged batch's counts formed on
    the card (every branch segmented); every masked key's dk and dv
    exactly 0, and flat rows at or past real_len adding nothing to them
    (bit-equal under noise); a causal case of each layout in fp32 and
    bf16; flash_attention and partial_attention on [1, 10241, 16, 48] with
    [B, H] valid counts against attention_with_lse.
20. bhld_forward: the flagship with ``dilated_ratio="[1, 2, 4, 6, 12]"``
    (6 and 12 do not divide H = 16: the head-major route, warned once)
    through ``run_inference_with_slide_encoder`` on 10240 tiles, fp32 and
    bf16: exact launches (48 flash_fwd, 12 flat_fwd), each layer's
    embedding against the plain versions on the card, ms per slide, peak
    memory above the model, a profiler breakdown and the allocations live
    at the peak (bf16); a B = 2 ragged batch (60 flash_fwd), each row
    against its slide alone.
21. bhld_vs_fused: the flagship's own schedule through the public
    ``dilated_attention_bhld`` against the default phase-major route (two
    kernel families), fp32 and bf16, stacked and streaming fusion, with
    both routes' ms.
22. bhld_step: the fine-tune step at those ratios: fp32 gradients against
    the plain versions, the exact launches of one bf16 step (48/44/44 on
    the segmented kernels, 12/11/11 on the flat ones), ms per step and
    peak memory, and a profiler breakdown of one bf16 step (device busy
    and idle share, the kernels with the most device time).

23. pipe_kernels: the pipelined branch kernels (rows 6 and 8:
    dilated_branch_fwd_pipe, dilated_branch_bwd_dq_pipe,
    dilated_branch_bwd_dkv_pipe) against their plain versions at the five
    branches of one flagship layer (L = 10241), fp32 and bf16, at full
    length (timed: device time from a CUDA graph and the wrapper's CUDA
    events beside the bound, the exp2 floor, the plain version, the serial
    twin's device time and SDPA with the key mask and its backward), at a ragged
    real length and in a B = 2 batch whose counts are formed on the card;
    each against its serial twin on the same inputs (fp32 within
    KERNEL_TOL; bf16 1 - cosine within the route limit, the roundings
    differing on purpose); dk's relative error against the plain version
    beside its limit (dK takes the plain q, the logits the rounded one);
    past 65535 cells. The build phase builds them at
    every head width, and head_widths checks them there.
24. pipe_forward: the flagship with ``GIGAPATH_PIPELINED_ATTN=1`` on 10240
    tiles, fp32 and bf16, on the default route (60 pipelined forwards, 0
    serial) and the stream-fusion route (60 and 12 epilogues); then no flag
    and a plan blessed by the port's ``bless_plan`` into a temporary
    registry that pipelines only the r = 1 branch (12 + 48 serial); each
    layer's embedding against the serial route; ms per slide and peak
    memory of both in turns; (bf16) a profiler breakdown of each with the
    idle share.
25. pipe_step: the fine-tune step with ``GIGAPATH_PIPELINED_ATTN=1
    GIGAPATH_PIPELINED_BWD=1``: fp32 gradients against the serial route,
    the exact launches of one bf16 step (60/55/55 pipelined, 0 serial), ms
    per step and peak memory beside the serial step.
26. seq_parallel: sequence parallelism, ``SEQ_WORLD`` = 4 rank processes
    sharing ``cuda:0`` over a gloo group (NCCL refuses two ranks on one
    device; every collective crosses the host), spawned after the build so
    that no rank builds a kernel, their seq group the ``seq`` dim of a
    ``parallel.mesh.make_mesh`` mesh. (a) one layer's op in fp32 at H = 16,
    Dh = 48, L = 16384, ``[1024, 4096, 8192, 16384] / [1, 2, 4, 8]``,
    gathered and ringed, against the single-device op on the card (rel <=
    1e-5 forward, <= 1e-4 gradients); (c) one flagship-width layer's bf16
    gradients at L = 32768, every parameter's gradient summed over the ranks
    against the single-device layer's and the ring's against the gather's (1
    - cosine <= 5e-4); (b) the flagship-width encoder
    ``LongNet_12_layers_768_dim`` in bf16 at L = 131072 (32768 a rank),
    ``[1024, 32768, 65536, 131072] / [1, 2, 4, 8]`` (the JAX package's
    power-of-two recipe: the flagship schedule cannot be sharded), gathered
    and ringed, dense and with 100000 valid tokens, each rank's slice
    against the single-device forward of the same weights (1 - cosine <=
    5e-4); (d) every rank's exact launches of rows 1-3, 7, 11 and 12 on
    each route (``_seq_launches``); (e) per-rank host ms and device busy of
    the encoder forward, gathered and ringed, beside the single-device
    forward, labelled as time-shared. A failed rank fails the phase, and
    every rank still running is killed.
27. tensor_parallel: tensor parallelism over a model group of T = 2 and
    4 of ``TP_RANKS`` = 4 rank processes sharing ``cuda:0`` over gloo
    (forked like phase 26's): (a) one flagship layer's fp32 op at L =
    10241 on each rank's H/T heads (the tensor-parallel route: head-major
    at the global phases) against the single-device op, forward rel <=
    1e-5 and gradients <= 1e-4; (b) the flagship slide encoder in bf16 at
    10240 tiles on ``shard_state_dict`` parts, every layer's embedding
    against the single-device model's (1 - cosine <= 5e-4); (c) one
    flagship-width layer's bf16 parameter gradients gathered over the
    group against the single-device layer's; (d) each rank's exact
    launches (``_tp_launches``); (e) a rank's host ms, device busy, idle
    share and peak memory beside the single-device forward, labelled as
    time-shared, and each rank's step times. The same ranks then run
    phase 28's expert parallelism.
28. moe: the flagship encoder's MoE variant (``moe_freq=2,
    moe_expert_count=8``), top-1 and top-2: in fp32 at L = 2049 against
    the plain CPU run of the same weights (rel <= 1e-4, ``l_aux`` rel <=
    1e-5, exact launches of rows 1-3), and in bf16 at L = 10241 (finite,
    exact launches, the gating telemetry's keys, host ms, a profile, peak
    memory); expert parallelism over 4 ranks in both variants (gathered
    experts against one device; per-shard gating with the all-to-all
    against one device on each rank's tokens), fp32 forward, ``l_aux``
    and gradients; ``dryrun.dryrun_multichip(4)`` and ``(8)`` at once,
    each stage's loss finite.
29. longnet_decoder: the causal ``LongNetDecoder`` at the flagship slide
    encoder's width (E = 768, 16 heads, FFN 3072, 12 layers, sub-LN, the
    flagship schedule), token embeddings fed, no output layer, bf16, at L
    = 10240 (three of the five branches clamp their segment to L): the
    forward on the kernels (rows 1-3, exact launches, counts set to 0 just
    before) against the same forward on their plain versions (1 - cosine
    and max |err|), ms per forward (median of 3), peak memory, a profile of
    one forward (device busy, idle share).
30. longnet_decode: the same model prefills 10176 rows (rows 1-3) and
    decodes 64 rows one step at a time through ``incremental_state``
    (each step's 5 branches a layer on row 11, 60 launches a step, counts
    set to 0 before the steps); the stepped rows against the whole
    forward's last 64 (1 - cosine), ms per step (the last step profiled
    instead: device busy, idle share), peak memory over the steps
    (bounded: the cache grows one row a step).
31. retnet: ``RetNetConfig``'s defaults (768 / 3 heads / FFN 1280 / 12
    layers) with the value width 1296 (``RETNET_CFG``: the default 1280
    does not split into 3 heads) at L = 2048 in bf16, token embeddings fed: the
    parallel form against the chunkwise form (chunks of 512) and against
    the recurrent form over the first ``RETNET_RECURRENT_STEPS`` positions
    (1 - cosine, max |err|), ms of each; plain PyTorch (no Pallas kernel in
    the JAX package).
32. beit3: BEiT-3 at ``EncoderConfig``'s defaults with ``multiway``,
    ``vocab_size`` 64010, 224 px images in 16 px patches, a fused
    vision-language forward of batch 8 (197 vision tokens and 64 text
    tokens, the last 16 of half the rows padded) in bf16 (finite, the
    shape, ms, peak memory), and in fp32 against the same weights' fp32
    forward on the CPU for 2 of the rows (rel <= 1e-4).
33. obs_compile: the ledger's compile-side profiles on the card
    (``obs/ledger.py``). (a) The bf16 flagship forward's full profile
    through ``PerfLedger.capture_full``: its ``kernels`` column exactly
    180 / 60 / 60 (rows 2 / 1 / 3) and equal to LAUNCHES, flops at least
    the dense products' closed form, bytes accessed, and the peak above
    the arguments within 5 % of the forward's peak above the model
    measured as ``slide_forward`` measures it. (b) A 2-layer fp32 encoder
    at L = 2049 profiled on the CPU and on the card: the same fingerprint
    and flops, the last embedding within 1e-4. (c) Three bf16 fine-tune
    steps through ``train_one_epoch``'s watchdog with the ledger on and
    under ``GIGAPATH_OBS=0``: parameters bit-equal, rows 7a / 7b 55 / 55
    launches a step (nothing run twice), one full entry. (d)
    ``utils/profiling.py:op_totals`` of a trace of the forward: 180 / 60 /
    60 kernel records. (e) ``utils/timing.py:chained_seconds_per_iter`` of
    the forward within a factor of 2 of ``time_ms``. (f) One streamed
    flagship layer at 2048-tile chunks: ``full_length_avals`` lists no
    tensor of the slide's length in the folds and some in the dense
    forward; every fold's allocator peak under ``_fold_bound_bytes``.

``default_route_times`` (not part of the run) times the default route's
bf16 forward per slide and bf16 step alone (or, with ``dilated_ratio``,
the head-major route's; under ``env_flags``, the route the flags select),
and profiles one forward and one step (device busy, idle share), for
comparing two trees of the port in turns in one call;
``copy_kernel_times`` (not part of the run) times the pack and unpack per
flagship layer by device time beside their library calls, for the same
use; ``fusion_kernel_times`` (not part of the run) times rows 4 and 9 per
flagship layer (10241 and 102401 tokens) with the launch floor, for the
same use; ``stream_backward_times`` (not part of the run) times
one flagship layer's bf16 streaming attention backward (host clock,
device busy, idle share, the two kernels' device time), for the same use;
``sass_digests`` (not part of the run either) digests each kernel
function's SASS of the tensor-core libraries (the forwards', the
segment-flash, the branch and the stream backward's) at Dh = 48 and 64
and of the pack and unpack, for showing that a change left a kernel's
instructions as they were.

Phase 16 also replays a ``torch.cuda.memory`` allocation history of one
bf16 forward per route (10240 and 102400 tiles) to its peak and reports the
allocations live there by the port's source line.

Then a ``{"kernels": [...]}`` line (each kernel's ``decoder_forward_launches``
and ``decoder_decode_launches``: its launches in phase 29's forward and
phase 30's decode steps; the launches of the dilated kernels
are those of one training step, of the quantized ones those of one
``int8+attn`` 128-tile batch, of ``stream_pair_fwd`` those of one
streaming forward, of the stream backward kernels those of the backward
through one layer's streaming attention, of the four stream-fusion
kernels those of one bf16 training step on their route, of the six
segment-flash kernels those of one bf16 step of ``bhld_step``, of the
three pipelined kernels those of one bf16 step of ``pipe_step``), the
``nvidia-smi`` name/power line, and
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero before those lines. Exits non-zero, printing no result, when
no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_TILES = 10240
E, H = 768, 16
SCHEDULE = ([1024, 5792, 32768, 185363, 1048576], [1, 2, 4, 8, 16])
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# torch.profiler: the host region whose span is a profile's window, and
# the spin kernels a session launches before it, whose records CUPTI may
# drop in the work's place (on an H100 it dropped the first 3 of each
# session, and 16 spins kept the work's: scripts/
# torch_serve_memory_probe.py --scenario skew and --large-only)
PROFILE_WINDOW = "chip_smoke.window"
PROFILE_LEAD_IN = 64
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 FMA pipes; bf16 tensor cores
# Kernel vs plain version on the card. Both compute in fp32 from the same
# inputs and differ only in the order of sums (fp32 out error read 7.7e-7),
# so a bf16 output differs by at most about one bf16 ulp of its value (read
# 9.8e-4 = one ulp in [0.125, 0.25)): the bf16 limit allows a few ulps.
KERNEL_TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(atol=4e-3, rtol=1e-2)}
LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=1e-5)}
# Slide embeddings, kernel path vs plain path on the card (read: fp32 max
# relative error 1.9e-6; bf16 1 - cosine 5e-5 at worst).
F32_REL_TOL = 1e-4
BF16_MAX_ONE_MINUS_COS = 5e-4

KERNELS = {
    "pack_phases": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/pack_phases.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1190 (_pack_kernel, via _pack_phases:1254)",
    ),
    "dilated_branch_fwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_fwd.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:70 (_fwd_kernel, via _fwd_impl:350)",
    ),
    "unpack_phases": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/unpack_phases.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1196 (_unpack_kernel, via _unpack_phases:1305)",
    ),
    "dilated_branch_bwd_dq": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_bwd_dq.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:406 (_dq_kernel, via _bwd_impl:994, pallas_call :1016)",
    ),
    "dilated_branch_bwd_dkv": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_bwd_dkv.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:462 (_dkv_kernel, via _bwd_impl:994, pallas_call :1044)",
    ),
    "q_matmul": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/q_matmul.cu",
        replaces="gigapath_tpu/quant/qmatmul.py:71 (_q_matmul_kernel, via q_matmul_pallas:101, pallas_call :125)",
    ),
    "q_flash_attention": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/q_flash_attention.cu",
        replaces="gigapath_tpu/quant/qflash.py:95 (_qflash_kernel, via q_flash_attention_pallas:135, "
                 "pallas_call :163)",
    ),
    "stream_pair_fwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/stream_pair_fwd.cu",
        replaces="gigapath_tpu/ops/pallas_streaming.py:125 (_fwd_kernel, via _fwd_impl:306, pallas_call :326)",
    ),
    "stream_pair_bwd_dq": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/stream_pair_bwd_dq.cu",
        replaces="gigapath_tpu/ops/pallas_streaming.py:195 (_dq_kernel, via _bwd_impl:349, pallas_call :380)",
    ),
    "stream_pair_bwd_dkv": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/stream_pair_bwd_dkv.cu",
        replaces="gigapath_tpu/ops/pallas_streaming.py:242 (_dkv_kernel, via _bwd_impl:349, pallas_call :403)",
    ),
    "pack_phases_direct": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/pack_phases_direct.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1203 (_pack_kernel_direct, via _pack_phases:1254, "
                 "pallas_call :1266)",
    ),
    "unpack_phases_direct": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/unpack_phases_direct.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1230 (_unpack_kernel_direct, via _unpack_phases:1305, "
                 "pallas_call :1321)",
    ),
    "fusion_epilogue_fwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/fusion_epilogue_fwd.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1849 (_epilogue_fwd_kernel, via _epilogue_pass_call:1895, "
                 "pallas_call :1948)",
    ),
    "fusion_epilogue_bwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/fusion_epilogue_bwd.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:1958 (_epilogue_bwd_kernel, via _epilogue_bwd_call:1985, "
                 "pallas_call :2016)",
    ),
    "flash_fwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_fwd.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:97 (_fwd_kernel, via _fwd_impl:344, pallas_call :367)",
    ),
    "flash_bwd_dq": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_bwd_dq.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:200 (_dq_kernel, via _bwd_impl:389, pallas_call :415)",
    ),
    "flash_bwd_dkv": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_bwd_dkv.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:259 (_dkv_kernel, via _bwd_impl:389, pallas_call :432)",
    ),
    "flat_fwd": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_fwd.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:97 (_fwd_kernel, via _flat_fwd_impl:480, pallas_call :494)",
    ),
    "flat_bwd_dq": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_bwd_dq.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:200 (_dq_kernel flat=True, via _flat_bwd_impl:513, "
                 "pallas_call :555)",
    ),
    "flat_bwd_dkv": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/flash_bwd_dkv.cu",
        replaces="gigapath_tpu/ops/pallas_flash.py:259 (_dkv_kernel flat=True, via _flat_bwd_impl:513, "
                 "pallas_call :568)",
    ),
    "dilated_branch_fwd_pipe": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_fwd_pipe.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:166 (_fwd_kernel_pipe, via _fwd_impl_pipe:267, "
                 "pallas_call :330)",
    ),
    "dilated_branch_bwd_dq_pipe": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_bwd_dq_pipe.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:521 (_dq_kernel_pipe, via _bwd_impl_pipe:679, "
                 "pallas_call :738)",
    ),
    "dilated_branch_bwd_dkv_pipe": dict(
        route="cuda", source="gigapath_tpu_torch/csrc/dilated_branch_bwd_dkv_pipe.cu",
        replaces="gigapath_tpu/ops/pallas_dilated.py:590 (_dkv_kernel_pipe, via _bwd_impl_pipe:679, "
                 "pallas_call :798)",
    ),
}
FWD_KERNELS = ("pack_phases", "dilated_branch_fwd", "unpack_phases")
# the phase pack and unpack (rows 2, 3): tiled copies in 16-byte units
COPY_SOURCES = ("pack_phases", "unpack_phases")
COPY_KERNEL_NAMES = ("::pack_phases_kernel<", "::unpack_phases_kernel<")  # their names in a trace
# their tilings' edges, each in fp32 and bf16 at H = 16: (B, L, sl, r, Dh,
# elements the tensors are shifted by, what the case covers)
COPY_EDGES = [
    (1, 100, 30, 4, 48, 0, "a segment not divisible by r"),
    (1, 300, 64, 2, 48, 0, "S > 1, a ragged last segment"),
    (2, 300, 128, 4, 48, 0, "B = 2"),
    (2, 300, 64, 2, 20, 0, "Dh = 20: 40 bytes in bf16 deny 16-byte units"),
    (1, 300, 64, 2, 48, 1, "tensors shifted by one element: a narrower unit"),
    (1, N_TILES + 1, 5792, 2, 48, 0, "flagship r = 2: S = 2, the last segment 4449 rows"),
    (1, N_TILES + 1, 1048576, 16, 48, 0, "flagship r = 16: m = 641 rows of Mp = 704"),
]
BWD_KERNELS = ("dilated_branch_bwd_dq", "dilated_branch_bwd_dkv")
# the pipelined twins of the branch kernels (rows 6 and 8) of rows 1, 7a, 7b
PIPE_KERNELS = ("dilated_branch_fwd_pipe", "dilated_branch_bwd_dq_pipe", "dilated_branch_bwd_dkv_pipe")
NO_PIPE = dict.fromkeys(PIPE_KERNELS, 0)
# launches of one flagship training step with feat_layer 11: the forward
# runs 12 layers x 5 branches (packing q, k, v, unpacking out); the
# classifier reads the 11th layer's output, so the backward runs through 11
# layers x 5 branches (packing dout, q, k, v, unpacking dq, dk, dv)
STEP_LAUNCHES = {"pack_phases": 60 * 3 + 55 * 4, "dilated_branch_fwd": 60,
                 "unpack_phases": 60 + 55 * 3, "dilated_branch_bwd_dq": 55,
                 "dilated_branch_bwd_dkv": 55, "pack_phases_direct": 0,
                 "unpack_phases_direct": 0, "fusion_epilogue_fwd": 0, "fusion_epilogue_bwd": 0, **NO_PIPE}
# Backward kernels vs their plain version on the card, as max |err| over
# max |ref| of each gradient. Both compute in fp32 and differ in the order of
# sums (fp32 read 2.7e-6 at worst); a bf16 gradient is rounded once, so it
# differs by about one bf16 ulp of its largest values (read 2.8e-3).
BWD_REL_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# Training-step gradients, kernel path vs plain path on the card: rel error
# per parameter (fp32), 1 - cosine per parameter (bf16).
GRAD_F32_REL_TOL = 1e-4
GRAD_BF16_MAX_ONE_MINUS_COS = 1e-2
# the fine-tune loop's synced step against the step without scalars, in turns
SYNCED_STEP_PAIRS = 6
# head widths (E / H) of the registry's other LongNet configs; the branch
# kernels are built once per width
OTHER_HEAD_DIMS = (16, 24, 32, 64, 96)
BRANCH_SOURCES = ("dilated_branch_fwd", "dilated_branch_bwd_dq", "dilated_branch_bwd_dkv")
# the forwards whose bf16 tensors run on the tensor cores, on the tile steps
# of csrc/branch_mma.cuh: the branch forwards (rows 1, 6) and the
# segment-flash forward (rows 11, 13)
FWD_MMA_SOURCES = ("dilated_branch_fwd", "dilated_branch_fwd_pipe", "flash_fwd")
# the branch backwards whose bf16 tensors run on the tensor cores (rows 7, 8)
BWD_MMA_SOURCES = BWD_KERNELS + ("dilated_branch_bwd_dq_pipe", "dilated_branch_bwd_dkv_pipe")
# the flagship tile encoder gigapath_tile_enc: 224 px tiles in 16 px
# patches (196 + cls = 197 tokens), E = 1536, 24 heads of 64, 40 blocks
TILE_E, TILE_H, TILE_L, TILE_DEPTH = 1536, 24, 197, 40
TILE_BATCH, TILE_COUNT = 128, 160  # one full batch and one padded partial batch
# (K, N) of each block's four quantized matmuls, at M = 128 tiles x 197 tokens
Q_SHAPES = {"qkv": (1536, 4608), "proj": (1536, 1536), "fc1": (1536, 8192), "fc2": (4096, 1536)}
# q_matmul vs its plain version: both sum the same exact fp32 products, the
# kernel on the tensor cores in another order, so each output may differ
# by c * K * 2^-24 * (|x| . |w|) * scale, elementwise: c = 2 bounds any two
# orders of round-to-nearest sums (3 if the tensor cores truncate); read c =
# 0.0036 at worst at the flagship shapes and 0.0175 at K = 96, and the limit
# is about ten times that
Q_MATMUL_C = 0.2
Q_MATMUL_TOL = f"|y - ref| <= {Q_MATMUL_C} * K * 2^-24 * (|x| . |w|) * scale"
# q_flash_attention vs its plain version: bf16 out within a few bf16 ulps
# (the kernel rounds its unnormalized probabilities to bf16, the plain
# version its normalized ones; read one ulp, 7.8e-3 at |out| in [1, 2)),
# fp32 out (read 7.2e-7) and the lse (read 9.5e-7) to fp32 rounding
Q_FLASH_TOL = {"bfloat16": dict(atol=4e-3, rtol=1e-2), "float32": dict(atol=1e-5, rtol=1e-4)}
Q_FLASH_LSE_TOL = dict(atol=1e-5, rtol=1e-5)
# tile embeddings, kernel path vs the plain path on the card, 1 - cosine
# per tile (read 1.4e-4 for int8+attn, where q_flash's bf16 probabilities
# round differently; 0 for fp8_e4m3 and bf16)
TILE_MAX_ONE_MINUS_COS = 1.5e-3
TILE_LAUNCHES = {"": (0, 0), "int8+attn": (160, 40), "fp8_e4m3": (160, 0)}  # per 128-tile batch
# the streaming chunked prefill of the flagship slide: 10240 tiles in
# chunks of 2048 behind the cls token, so token blocks (0, 1), (1, 2049),
# ... (8193, 10241); the branches' segments clamp to L = 10241
STREAM_CHUNK = 2048
STREAM_BLOCKS = [(0, 1)] + [(1 + i * STREAM_CHUNK, 1 + (i + 1) * STREAM_CHUNK) for i in range(5)]
STREAM_L = STREAM_BLOCKS[-1][1]
STREAM_FOLDS = 1776  # 148 folds per layer (fold_plan at these bounds) x 12 layers
# chunk pairs (g, r, query block, key block, valid bound): per branch one
# timed pair (the first of each (g, r)) and the edge cases
STREAM_CASES = [
    (1024, 1, 1, 1, STREAM_L, "segment boundaries inside the block"),
    (1024, 1, 1, 3, STREAM_L, "disjoint segments: every row masked"),
    (5792, 2, 3, 3, STREAM_L, "across the 5792 boundary"),
    (5792, 2, 0, 1, STREAM_L, "the 1-row cls block as queries"),
    (STREAM_L, 4, 2, 4, STREAM_L, "one clamped segment"),
    (STREAM_L, 8, 5, 5, STREAM_L - 37, "a ragged valid bound"),
    (STREAM_L, 16, 4, 5, STREAM_L, "one clamped segment"),
    (STREAM_L, 16, 5, 0, STREAM_L, "the 1-row cls block as keys"),
]
# the pair's three kernels, each bf16 on the tensor cores (rows 15 and 16)
STREAM_KERNELS = ("stream_pair_fwd", "stream_pair_bwd_dq", "stream_pair_bwd_dkv")
STREAM_BWD_SOURCES = STREAM_KERNELS[1:]  # the pair's backward (row 16)
# the stray-write canary's pairs (g, r, query block, key block, valid): a
# lattice of step 8 with a ragged valid bound, and a g % r != 0 branch
# whose blocks cross segment boundaries (lattice step 1, every row)
STREAM_CANARY = [(STREAM_L, 8, 5, 5, STREAM_L - 37), (1000, 3, 1, 1, STREAM_L)]
STREAM_REQUESTS = (N_TILES, 4097, 2048)  # tiles of the three served slides; the head takes the second
# a stream kernel vs its plain version on the card: out as the branch
# kernels (both compute one function in fp32 from the same inputs, q and p
# rounded alike, and differ in the order of sums and the kernel's
# ex2.approx, so a bf16 out moves by a few ulps where p's rounding flips),
# lse on covered rows, gradients as BWD_REL_TOL
STREAM_LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=1e-5)}
# the serving stack (phase 14b): the CLI's bucketed default path and a
# SlideService on the default ladder (1024 x 2^k), batches of 4. Five
# buckets: 16384 (10240, 9000), 8192 (6000), 4096 (3000), 2048 (2048, on a
# rung) and 1024 (1), so five captures; a duplicate of the first slide is
# served from the cache
SERVE_SLIDES = (N_TILES, 9000, 6000, 3000, 2048, 1)
SERVE_BATCH = 4
SERVE_BUCKETS = (16384, 8192, 4096, 2048, 1024)
SERVE_F32_REL_TOL = 1e-5  # each served row vs the slide's exact-shape forward, fp32
SERVE_REPS = 10
# the CLI at its default batch size (16) on two slides whose buckets are
# both at the batch_tokens bound: 131072 x 8 and 65536 x 16 = 2^20 padded
# tiles a dispatch, the largest keys the default config makes
SERVE_LARGE_SLIDES = (100000, 40000)
SERVE_LARGE_TOKENS = 1 << 20
# the second large key's capture may grow the cache's one pool by at most
# this share of the first's (each key's own pool would double it)
SERVE_SHARED_POOL_GROWTH = 0.25
# the device memory the serve phase may leave reserved at its end, the
# models deleted and no garbage collection run: kernels' plans and
# cuBLAS's workspaces, not a graph pool or the static inputs
SERVE_MEMORY_SLACK = 1 << 30
# the disaggregated pipeline (phase 14c): two ViT-G/14 int8+attn tile
# worker processes on the one card feed the flagship head's consumer, 2048
# tiles of 224 x 224 in 16 chunks of 128. A lease must outlast a chunk's
# encode on a card that two workers and the consumer share (a worker renews
# between chunks), so the plan's lease is 30 s where the CPU tests keep
# 1.5 s; a killed worker is seen at once from its exit code all the same.
DIST_TILES = 2048
DIST_CHUNK = 128
DIST_LEASE_S = 30.0
DIST_RETRANSMIT_S = 10.0
DIST_DEADLINE_S = 300.0
DIST_KILL = "kill_worker@4"
# the whole-slide training entry (phase 14d): two synthetic slides of 8192 x
# 8192 px (32 x 32 tiles of 256 px, tissue-like dark blobs over about half
# the area; cut from a cohort's ~10^4 tiles a slide to keep the phase near
# two minutes), tiled, embedded by the full-width tile encoder in the tier a
# blessed plan picks, and trained into the flagship head at full width
WSI_PX, WSI_TILE, WSI_SLIDES, WSI_EPOCHS = 8192, 256, 2, 3
WSI_TIER = "int8+attn"
WSI_TRAIN = dict(model_arch="gigapath_slide_enc12l768d", latent_dim=768, feat_layer="11",
                 freeze_pretrained=True, checkpoint_every=1)
# the harnesses (phase 14e): the parity fixture's four variants; the probe
# on 4096 tiles of two stain classes (the reference's 12500 iterations cut
# to 1000 for the phase's time); the pretraining driver at full width on two
# 4096 px slides (about 128 tiles each) at batch 16, where the reference's
# 64 would not fit ViT-G's saved activations and AdamW state in 80 GB
HARNESS_VARIANTS = ("bf16", "int8", "fp8_e4m3", "int8+attn")
HARNESS_FIXTURE_DH = 8  # vit_tile_enc_test: E = 32, 4 heads
HARNESS_PARITY_LAUNCHES = {"q_matmul": 3 * 8, "q_flash_attention": 2}  # 2 blocks, one forward a variant
HARNESS_PROBE_TILES, HARNESS_PROBE_SPLITS = 4096, (("train", 2048), ("val", 1024), ("test", 1024))
HARNESS_PROBE_ARGS = ["--batch_size", "512", "--train_iters", "1000", "--eval_interval", "500"]
HARNESS_STAINS = {"eosin": (232, 150, 190), "hematoxylin": (110, 90, 170)}  # the probe's two classes, RGB
HARNESS_PROBE_AUROC = 0.9  # a signal check on separable classes, not a quality claim
HARNESS_PROBE_RTOL = 1e-4  # ||card - CPU|| / ||CPU|| of each final parameter
HARNESS_WSI_PX = 4096
HARNESS_PRETRAIN = dict(tile_epochs=2, slide_epochs=5, batch_size=16)
MAE_STEP_DEPTH, MAE_STEP_TILES, MAE_STEP_LR = 2, 4, 1e-4
MAE_STEP_TOL = 1e-4
# the stream-fusion route with direct packs (GIGAPATH_STREAM_FUSION=1,
# GIGAPATH_PACK_DIRECT=1): the flagship's three branches clamped to one
# segment (r = 4, 8, 16) take the direct pack (q, k and v in one launch,
# forward and again backward) and unpack, the r = 1 and 2 branches the
# row-2/3 kernels (one launch a tensor); one epilogue launch per layer
# forward and one per layer backward (11 layers with feat_layer 11)
FUSION_KERNELS = ("pack_phases_direct", "unpack_phases_direct", "fusion_epilogue_fwd", "fusion_epilogue_bwd")
FUSION_ENV = {"GIGAPATH_STREAM_FUSION": "1", "GIGAPATH_PACK_DIRECT": "1"}
FUSION_FWD_LAUNCHES = {"pack_phases": 12 * 2 * 3, "dilated_branch_fwd": 60, "unpack_phases": 0,
                       "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0,
                       "pack_phases_direct": 12 * 3, "unpack_phases_direct": 0,
                       "fusion_epilogue_fwd": 12, "fusion_epilogue_bwd": 0, **NO_PIPE}
FUSION_STEP_LAUNCHES = {"pack_phases": 72 + 11 * 2 * 3, "dilated_branch_fwd": 60,
                        "unpack_phases": 11 * 2 * 3, "dilated_branch_bwd_dq": 55,
                        "dilated_branch_bwd_dkv": 55, "pack_phases_direct": 36 + 11 * 3,
                        "unpack_phases_direct": 11 * 3 * 3, "fusion_epilogue_fwd": 12,
                        "fusion_epilogue_bwd": 11, **NO_PIPE}
# a schedule whose segment ends fall inside the epilogue's 16-token tiles
# (g = 40; the flagship's 1024 and 5792 are multiples of 16), at the
# flagship width
STRADDLE_SCHEDULE = ([40, 96, 512], [1, 2, 4])
# the kernel names of rows 4, 9 and 10 in a profiler trace
FUSION_KERNEL_NAMES = ("::pack_direct_kernel<", "::epilogue_fwd_kernel<", "::epilogue_bwd_kernel<")
CUDA_ERROR_MISALIGNED_ADDRESS = 716  # cudaErrorMisalignedAddress
# the epilogue kernels vs their plain versions (and the forward vs the
# default route's dense fusion): the same fp32 arithmetic in another order
# (expf against torch.exp, fused multiply-adds): fp32 out read 4.5e-8 at
# worst, bf16 out one bf16 rounding (read 4.9e-4), fused_lse 9.5e-7, the
# backward 0 in both
EPILOGUE_TOL = {"float32": dict(atol=5e-7, rtol=1e-6), "bfloat16": dict(atol=5e-3, rtol=1e-2)}
EPILOGUE_BWD_TOL = {"float32": dict(atol=1e-6, rtol=1e-6), "bfloat16": dict(atol=4e-3, rtol=1e-2)}
FUSED_LSE_TOL = dict(atol=1e-5, rtol=1e-6)
# the slide forward on the stream-fusion route vs the default route, both
# on their kernels: fp32 sums in another order (read 1.4e-6)
FUSION_F32_REL_TOL = 1e-5
LONG_TILES = 102400  # one 320 x 320-tile slide, L = 102401 with cls
# the head-major route: the flagship at the LongNet paper's ratios
# (6 and 12 do not divide H = 16, so every layer takes the route); its r = 1
# branch (g = 1024) takes the flat kernel, the other four the segmented one;
# a forward launches 12 x 4 flash_fwd and 12 flat_fwd, a ragged B = 2
# batch (per-row valid lengths) 12 x 5 flash_fwd; a step with feat_layer 11
# runs the backward through 11 layers
BHLD_RATIOS = "[1, 2, 4, 6, 12]"
BHLD_SCHEDULE = (SCHEDULE[0], [1, 2, 4, 6, 12])
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flat_fwd", "flat_bwd_dq", "flat_bwd_dkv")
FLASH_SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BHLD_FWD_LAUNCHES = {"flash_fwd": 48, "flat_fwd": 12}
BHLD_RAGGED_LAUNCHES = {"flash_fwd": 60}
BHLD_STEP_LAUNCHES = {"flash_fwd": 48, "flat_fwd": 12, "flash_bwd_dq": 44, "flash_bwd_dkv": 44,
                      "flat_bwd_dq": 11, "flat_bwd_dkv": 11}
# the head-major route vs its plain versions, and vs the phase-major route
# on the flagship's own schedule: fp32 sums in another order
BHLD_F32_REL_TOL = 1e-5
# the pipelined route: GIGAPATH_PIPELINED_ATTN=1 swaps each of a forward's
# 60 branch forwards for the pipelined kernel (packs and unpacks as on the
# serial route); with GIGAPATH_PIPELINED_BWD=1 a step's 55 dq and 55 dkv go
# pipelined too; a blessed plan that marks only the r = 1 branch
# (1024, 1, "pipelined", 0) pipelines 12 of the 60 forwards
SLIDE_FWD_LAUNCHES = {"pack_phases": 180, "dilated_branch_fwd": 60, "unpack_phases": 60,
                      "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0, "pack_phases_direct": 0,
                      "unpack_phases_direct": 0, "fusion_epilogue_fwd": 0, "fusion_epilogue_bwd": 0, **NO_PIPE}
PIPE_FWD_ENV = {"GIGAPATH_PIPELINED_ATTN": "1"}
PIPE_STEP_ENV = {"GIGAPATH_PIPELINED_ATTN": "1", "GIGAPATH_PIPELINED_BWD": "1"}
PIPE_FWD_LAUNCHES = {**SLIDE_FWD_LAUNCHES, "dilated_branch_fwd": 0, "dilated_branch_fwd_pipe": 60}
PIPE_FUSION_FWD_LAUNCHES = {**FUSION_FWD_LAUNCHES, "dilated_branch_fwd": 0, "dilated_branch_fwd_pipe": 60}
PIPE_PLAN_BRANCH = (1024, 1, "pipelined", 0)
PIPE_PLAN_LAUNCHES = {**SLIDE_FWD_LAUNCHES, "dilated_branch_fwd": 48, "dilated_branch_fwd_pipe": 12}
PIPE_STEP_LAUNCHES = {**STEP_LAUNCHES, "dilated_branch_fwd": 0, "dilated_branch_bwd_dq": 0,
                      "dilated_branch_bwd_dkv": 0, "dilated_branch_fwd_pipe": 60,
                      "dilated_branch_bwd_dq_pipe": 55, "dilated_branch_bwd_dkv_pipe": 55}
PANDA = {"name": "panda", "setting": "multi_class", "label_dict": {i: i for i in range(6)},
         "max_tiles": 1000000, "shuffle_tiles": True, "add_metrics": ["qwk"]}  # panda.yaml


_T0 = time.perf_counter()  # t_s of every line: seconds since the script started


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one ``fn()`` call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time (ms) of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, its replay timed with CUDA events (median of 5) over ``reps``.
    For kernels of a few microseconds, where one call's CUDA-event time is
    the wrapper's host work and the profiler drops records."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=5, warmup=1) / reps
    del graph
    return ms


def queued_ms(fn, reps: int = 20, spin_cycles: int = 100_000_000) -> float:
    """Device time (ms) of one ``fn()`` for calls a CUDA graph cannot
    capture (an autograd backward, whose engine touches the legacy stream):
    ``reps`` calls queued behind a spin kernel (``torch.cuda._sleep``, about
    50 ms) that outlasts their enqueue, so the CUDA events around them time
    the device running them back to back, not the host's launches. Median of
    3; fails if a start event had completed before the last call was
    queued (the device would have waited on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        check(not start.query(), "queued_ms: the spin ended before the calls were queued")
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Run the branch op with the kernels' plain PyTorch versions on CUDA
    tensors (the port's plain path on the card)."""
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    names = ("pack_phases", "dilated_branch_fwd", "unpack_phases",
             "dilated_branch_bwd_dq", "dilated_branch_bwd_dkv", *FUSION_KERNELS, *PIPE_KERNELS)
    saved = {name: getattr(dk, name) for name in names}
    for name in ("pack_phases", "dilated_branch_fwd", "unpack_phases", *FUSION_KERNELS, "dilated_branch_fwd_pipe"):
        setattr(dk, name, getattr(dk, name + "_reference"))
    # the direct pack takes a sequence of tensors, its plain version one
    dk.pack_phases_direct = lambda xs, *a: tuple(dk.pack_phases_direct_reference(x, *a) for x in xs)
    dk.dilated_branch_bwd_dq = lambda *a: dk.dilated_branch_bwd_reference(*a, dkv=False)[0]
    dk.dilated_branch_bwd_dkv = lambda *a: dk.dilated_branch_bwd_reference(*a, dq=False)[1:]
    dk.dilated_branch_bwd_dq_pipe = lambda *a: dk.dilated_branch_bwd_pipe_reference(*a, dkv=False)[0]
    dk.dilated_branch_bwd_dkv_pipe = lambda *a: dk.dilated_branch_bwd_pipe_reference(*a, dq=False)[1:]
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dk, name, fn)


def _reset_peak() -> None:
    """Open a peak window on the card (``obs/ledger.py:reset_peaks``): a
    full profile taken inside the window resets the allocator's counters
    but does not lower the window's peak."""
    from gigapath_tpu_torch.obs.ledger import reset_peaks

    reset_peaks()


def _peak(kind: str = "allocated") -> int:
    """The card's peak bytes (``allocated`` or ``reserved``) in the window
    :func:`_reset_peak` opened."""
    from gigapath_tpu_torch.obs.ledger import peak_bytes

    return peak_bytes()[kind]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)
    return smi[0]


def phase_build():
    """Every library at once: the flagship slide encoder's (dense,
    streaming and head-major), the flagship tile encoder's, and the branch
    and segment-flash kernels at the registry's other head widths."""
    from gigapath_tpu_torch.ops import _build

    specs = _build.FLAGSHIP + _build.TILE_FLAGSHIP + _build.STREAM_FLAGSHIP + _build.FLASH_FLAGSHIP + tuple(
        (name, (("GP_HEAD_DIM", dh),)) for dh in OTHER_HEAD_DIMS
        for name in BRANCH_SOURCES + PIPE_KERNELS + FLASH_SOURCES + STREAM_KERNELS
    ) + (("q_flash_attention", (("GP_HEAD_DIM", HARNESS_FIXTURE_DH),)),)
    t0 = time.perf_counter()
    _build.build_all(specs)
    seconds = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        print(f"--- ptxas {name} ---\n{log}", file=sys.stderr)
    # the SASS the phases count, read here all at once (one cuobjdump a
    # library, ~2 s each when run one after another)
    t0 = time.perf_counter()
    flagship = (("GP_HEAD_DIM", E // H),)
    _read_sass([(name, flagship) for name in FWD_MMA_SOURCES + BWD_MMA_SOURCES + STREAM_KERNELS + FLASH_SOURCES]
               + [(name, ()) for name in COPY_SOURCES + ("q_matmul",)]
               + [("q_flash_attention", (("GP_HEAD_DIM", TILE_E // TILE_H),))])
    emit("build", seconds=seconds, sass_seconds=time.perf_counter() - t0, built=sorted(_build.build_log),
         libraries=[_build._label(name, defines) for name, defines in specs])


def _declared_bound(wrapper, dtype_name, *args, **kwargs):
    """Least card time (ms) of one kernel call's work, what bounds it, and
    its operations: the wrapper's declared (operations, bytes)
    (``ops/common.py:kernel_wrapper``, the count the compile-side profile
    adds up), operations over the dtype's peak or bytes over the HBM rate,
    whichever is larger. A query row counts where its cell has the key of
    that row: rows past a cell's valid keys (the padding of a ragged call)
    are computed by the kernels but are work the data does not need."""
    flops, nbytes = wrapper.declared_work(*args, **kwargs)
    return max((flops / PEAK_FLOPS[dtype_name] * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")), flops


def _branch_bounds(x, q6, out6, kvlen, L, g, S, r, Mp, dtype_name):
    """Least card time (ms) of each forward kernel's work at this branch,
    and what bounds it (:func:`_declared_bound`); and the (query, key)
    pairs the masks admit."""
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    fwd, flops = _declared_bound(dk.dilated_branch_fwd, dtype_name, q6, q6, q6, kvlen)
    return {
        "pack_phases": _declared_bound(dk.pack_phases, dtype_name, x, g, S, r, Mp, H)[0],
        "dilated_branch_fwd": fwd,
        "unpack_phases": _declared_bound(dk.unpack_phases, dtype_name, out6, L, E, g, S, r)[0],
    }, flops / (4 * (E // H))


def phase_kernels():
    """Each kernel vs its plain version at the flagship's branch shapes."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    _fwd_sass()
    _copy_sass()
    L, B = N_TILES + 1, 1
    real_len = L - 37  # a ragged tail: keys past it are masked
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
        totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, err=0.0,
                             by={}) for name in FWD_KERNELS}
        totals["dilated_branch_fwd"].update(wrapper_ms=0.0, exp2_floor_ms=0.0)
        for name in ("pack_phases", "unpack_phases"):
            totals[name].update(wrapper_ms=0.0, library_event_ms=0.0)
        for sl, r in zip(*SCHEDULE):
            g, S, m, Mp = dk._branch_geometry(L, sl, r)
            kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, None, q.device)
            # pack: exact copy of the plain version (pad slots exact 0)
            q6, k6, v6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v))
            refs6 = [dk.pack_phases_reference(x, g, S, r, Mp, H) for x in (q, k, v)]
            err_pack = max_err(q6, refs6[0])
            for x6, ref6 in zip((q6, k6, v6), refs6):
                check(torch.equal(_bits(x6), _bits(ref6)),
                      f"pack_phases {dname} sl={sl} r={r}: not bit-equal to its plain version")
            # branch attention against the plain version on the same packed inputs
            out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
            out_ref, lse_ref = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out6).all()), f"dilated_branch_fwd {dname} r={r}: non-finite out")
            err_out = max_err(out6[..., :m, :], out_ref[..., :m, :])
            covered = lse_ref > -1e19
            err_lse = max_err(lse5[covered], lse_ref[covered])
            torch.testing.assert_close(out6[..., :m, :], out_ref[..., :m, :], **KERNEL_TOL[dname])
            torch.testing.assert_close(lse5[covered], lse_ref[covered], **LSE_TOL[dname])
            check(bool((lse5[~covered] <= -1e19).all()), f"dilated_branch_fwd r={r}: uncovered lse above -1e19")
            # unpack: exact copy, off-band lanes exact 0
            dense = dk.unpack_phases(out6, L, E, g, S, r)
            dense_ref = dk.unpack_phases_reference(out6, L, E, g, S, r)
            err_unpack = max_err(dense, dense_ref)
            check(torch.equal(_bits(dense), _bits(dense_ref)),
                  f"unpack_phases {dname} r={r}: not bit-equal to its plain version")
            phase = (torch.arange(L, device="cuda") % g) % r
            band = torch.arange(E, device="cuda") // (E // H) // (H // r)
            off_band = phase[:, None] != band[None, :]
            check(not bool(dense[0][off_band].any()), f"unpack_phases r={r}: off-band lanes not 0")
            lse_dense = dk._scatter_lse(lse5, L, H, g, r, m)
            head_band = torch.arange(H, device="cuda") // (H // r)
            uncovered = head_band[:, None] != phase[None, :]
            check(bool((lse_dense[0][uncovered] <= -1e19).all()), f"r={r}: uncovered lse above -1e19")

            # times: each kernel's device time from a CUDA graph, its
            # wrapper's CUDA-event time beside it; plain versions; one library
            # call for each kernel's function (SDPA; torch.take and
            # index_copy_ by device time too, their event times beside)
            copies = _copy_times(dk, q, out6, q6, dense, g, S, r, Mp)
            t = {
                "pack_phases": copies["pack_ms"],
                "dilated_branch_fwd": graph_ms(lambda: dk.dilated_branch_fwd(q6, k6, v6, kvlen)),
                "unpack_phases": copies["unpack_ms"],
            }
            wrapper = time_ms(lambda: dk.dilated_branch_fwd(q6, k6, v6, kvlen))
            plain = {
                "pack_phases": time_ms(lambda: dk.pack_phases_reference(q, g, S, r, Mp, H), reps=5),
                "dilated_branch_fwd": time_ms(
                    lambda: dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen), reps=3, warmup=1),
                "unpack_phases": time_ms(lambda: dk.unpack_phases_reference(out6, L, E, g, S, r), reps=5),
            }
            hb = H // r
            qs, ks, vs = (x.reshape(B * S * r, hb, Mp, E // H) for x in (q6, k6, v6))
            key_ok = (torch.arange(Mp, device="cuda")[None] < kvlen.reshape(-1, 1))[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok), reps=5)
            lib_pack, lib_unpack = copies["take_ms"], copies["index_copy_ms"]
            bounds, pairs = _branch_bounds(q, q6, out6, kvlen, L, g, S, r, Mp, dname)
            exp2_floor = _exp2_floor_ms(pairs)
            totals["dilated_branch_fwd"]["wrapper_ms"] += wrapper
            totals["dilated_branch_fwd"]["exp2_floor_ms"] += exp2_floor
            for name, n, key, lib_key in (("pack_phases", 3, "wrapper_ms_pack", "take_event_ms"),
                                          ("unpack_phases", 1, "wrapper_ms_unpack", "index_copy_event_ms")):
                totals[name]["wrapper_ms"] += n * copies[key]
                totals[name]["library_event_ms"] += n * copies[lib_key]
            errs = {"pack_phases": err_pack, "dilated_branch_fwd": err_out, "unpack_phases": err_unpack}
            per_layer = {"pack_phases": 3, "dilated_branch_fwd": 1, "unpack_phases": 1}  # q, k, v packs
            for name in FWD_KERNELS:
                n = per_layer[name]
                tot = totals[name]
                tot["ms"] += n * t[name]
                tot["plain_ms"] += n * plain[name]
                tot["bound_ms"] += n * bounds[name][0]
                tot["err"] = max(tot["err"], errs[name])
                tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + n * bounds[name][0]
            for name, ms in (("dilated_branch_fwd", lib), ("pack_phases", 3 * lib_pack),
                             ("unpack_phases", lib_unpack)):
                totals[name]["library_ms"] = (totals[name]["library_ms"] or 0.0) + ms
            emit("kernels", dtype=dname, sl=sl, r=r, g=g, S=S, m=m, Mp=Mp, real_len=real_len,
                 max_abs_err={"pack": err_pack, "out": err_out, "lse_covered": err_lse, "unpack": err_unpack},
                 ms=t, wrapper_ms_fwd=wrapper, wrapper_ms_pack=copies["wrapper_ms_pack"],
                 wrapper_ms_unpack=copies["wrapper_ms_unpack"], plain_ms=plain, library_ms_sdpa=lib,
                 library_ms_take=lib_pack, library_ms_index_copy=lib_unpack,
                 library_event_ms={"take": copies["take_event_ms"], "index_copy": copies["index_copy_event_ms"]},
                 admitted_pairs=pairs, exp2_floor_ms=exp2_floor,
                 bound_ms={n: b[0] for n, b in bounds.items()}, bound_by={n: b[1] for n, b in bounds.items()})
            del q6, k6, v6, refs6, out6, lse5, out_ref, lse_ref, dense, dense_ref, qs, ks, vs
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
        summary[dname] = totals
        emit("kernels_per_layer", dtype=dname,
             note="sum over the 5 branches of one layer; pack counts its 3 launches (q, k, v); each "
                  "kernel's ms is its device time from a CUDA graph of 20 calls, wrapper_ms one call's "
                  "CUDA-event time; library_ms: SDPA's CUDA-event time, torch.take's and index_copy_'s "
                  "device time from a CUDA graph (library_event_ms their event time); exp2_floor_ms: one "
                  "exp2 per admitted pair at 16 a clock per SM",
             sm_clock_mhz=_MUFU.get("sm_clock_mhz"), kernels=totals)
    _many_cells(dk)
    _refused_inputs(dk)
    _copy_edges(dk)
    return summary


def _fwd_sass():
    """The SASS of the forwards' libraries at Dh = 48 (rows 1, 6, and 11/13):
    HMMA > 0 (bf16 tensors run on the tensor cores; fp32 on the FMA
    kernels)."""
    sass = {name: _sass_counts(name, GP_HEAD_DIM=E // H) for name in FWD_MMA_SOURCES}
    emit("kernels", sass=sass, note="cuobjdump -sass at Dh = 48: HMMA is mma.sync (the bf16 forwards)",
         tensor_core_ptxas={name: _mma_ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in FWD_MMA_SOURCES})
    for name, counts in sass.items():
        check(counts["HMMA"] > 0, f"{name}: no HMMA in its SASS {counts}")


def _copy_sass():
    """The SASS of the pack and unpack (rows 2, 3): 128-bit global loads
    and stores > 0, the 16-byte unit the flagship's Dh = 48 takes."""
    sass = {name: _sass_vector_counts(name) for name in COPY_SOURCES}
    emit("kernels", sass=sass, note="cuobjdump -sass of the pack and unpack (rows 2, 3): 128-bit global "
                                    "loads and stores, the 16-byte unit the flagship's Dh = 48 takes")
    for name, counts in sass.items():
        check(counts["LDG.E.128"] > 0 and counts["STG.E.128"] > 0, f"{name}: no 128-bit global copy {counts}")


def _refused_inputs(dk):
    """bf16 tensors the tensor-core forwards cannot take raise in the
    wrappers: a head width that is no multiple of 8, a q6 that is not
    16-byte aligned; no plain version runs on the card."""
    import torch

    kvlen = torch.full((1, 1, 1), 64, dtype=torch.int32, device="cuda")
    narrow = torch.zeros(1, 1, 1, 1, 64, 20, dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(64 * 48 + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(1, 1, 1, 1, 64, 48)
    ok = shifted.clone()
    refused = []
    for fn in (dk.dilated_branch_fwd, dk.dilated_branch_fwd_pipe):
        for label, args in (("Dh=20", (narrow, narrow, narrow)), ("misaligned q6", (shifted, ok, ok))):
            try:
                fn(*args, kvlen)
            except ValueError:
                refused.append(f"{fn.__name__} {label}")
                continue
            raise AssertionError(f"{fn.__name__} took bf16 tensors with {label}")
    emit("kernels_refused_inputs", refused=refused)


def _copy_yardsticks(dk, x, out6, packed, dense, g, S, r, Mp) -> dict:
    """One PyTorch indexing call for the pack's function and one for the
    unpack's, each by device time (``graph_ms``) and one call's CUDA-event
    time: ``torch.take`` with a precomputed index into the dense input
    with one zero appended (the pad slots), and the inverse scatter,
    ``index_copy_`` of the packed elements into zeros (pad slots to one
    spare element). Both are checked exact against ``packed`` and
    ``dense``."""
    import torch

    B, L, E = x.shape
    n = B * L * E
    # element i + 1 of the dense input at its packed slots, 0 at the pads
    slot = dk.pack_phases_reference(
        torch.arange(1, n + 1, dtype=torch.float64, device=x.device).reshape(B, L, E), g, S, r, Mp, H
    ).reshape(-1).to(torch.int64)
    src = torch.where(slot > 0, slot - 1, n)
    x_pad = torch.cat([x.reshape(-1), x.new_zeros(1)])
    check(torch.equal(torch.take(x_pad, src).reshape(packed.shape), packed), "take yardstick != pack")
    flat6 = out6.reshape(-1)
    check(torch.equal(torch.zeros(n + 1, dtype=out6.dtype, device=x.device).index_copy_(0, src, flat6)[:n]
                      .reshape(B, L, E), dense), "index_copy yardstick != unpack")
    take = lambda: torch.take(x_pad, src)  # noqa: E731
    index_copy = lambda: torch.zeros(n + 1, dtype=out6.dtype, device=x.device).index_copy_(0, src, flat6)  # noqa: E731
    return {"take_ms": graph_ms(take), "take_event_ms": time_ms(take),
            "index_copy_ms": graph_ms(index_copy), "index_copy_event_ms": time_ms(index_copy)}


def _copy_times(dk, x, out6, packed, dense, g, S, r, Mp) -> dict:
    """The pack of ``x`` and the unpack of ``out6`` (rows 2, 3) by device
    time (``graph_ms``) and one wrapper call's CUDA-event time, beside
    their yardsticks (:func:`_copy_yardsticks`). Only entry points every
    tree of the port has, so it times another tree's kernels too
    (:func:`copy_kernel_times`)."""
    L, E = x.shape[1:]
    pack = lambda: dk.pack_phases(x, g, S, r, Mp, H)  # noqa: E731
    unpack = lambda: dk.unpack_phases(out6, L, E, g, S, r)  # noqa: E731
    return {"pack_ms": graph_ms(pack), "wrapper_ms_pack": time_ms(pack),
            "unpack_ms": graph_ms(unpack), "wrapper_ms_unpack": time_ms(unpack),
            **_copy_yardsticks(dk, x, out6, packed, dense, g, S, r, Mp)}


def _bits(t):
    """``t``'s elements as integers of their width: equal bits, not equal
    values (a NaN equals itself, -0 differs from 0)."""
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _unit_bytes(es: int, Dh: int, *ptrs: int) -> int:
    """The copy unit rows 2-5 take: the widest of 16, 8, 4 bytes that
    divides a head's Dh run and every pointer, else the element."""
    return next((u for u in (16, 8, 4) if u > es and (Dh * es) % u == 0 and all(p % u == 0 for p in ptrs)), es)


def _copy_edges(dk):
    """The pack and unpack (rows 2, 3) on the tilings' edges, fp32 and
    bf16, bit-exact against their plain versions through the wrappers and
    as a canary: ``gp_pack_phases`` / ``gp_unpack_phases`` called directly
    into NaN-filled outputs one tile longer than the tensor (16 packed rows
    of every phase; 16·r dense rows) must write every slot inside, pads and
    off-band lanes exact 0 (+0 bits), and leave the tail NaN. Then a shape
    the entries cannot take (Mp·r < g) returns cudaErrorInvalidValue and
    the wrapper raises."""
    import torch

    from gigapath_tpu_torch.ops import _build

    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    for B, L, sl, r, Dh, shift, what in COPY_EDGES:
        E_ = H * Dh
        g, S, m, Mp = dk._branch_geometry(L, sl, r)
        hb = H // r
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dtype).element_size()
            flat = torch.empty(B * L * E_ + shift, dtype=dtype, device="cuda")
            x = flat[shift:].view(B, L, E_)
            x.copy_(torch.randn(B, L, E_, device="cuda", generator=gen))
            want6 = dk.pack_phases_reference(x, g, S, r, Mp, H)
            flat6 = torch.empty(want6.numel() + shift, dtype=dtype, device="cuda")
            p6 = flat6[shift:].view(want6.shape)
            p6.copy_(want6)
            want = dk.unpack_phases_reference(p6, L, E_, g, S, r)
            check(torch.equal(_bits(dk.pack_phases(x, g, S, r, Mp, H)), _bits(want6)),
                  f"pack_phases {what} {dtype}: differs from its plain version")
            check(torch.equal(_bits(dk.unpack_phases(p6, L, E_, g, S, r)), _bits(want)),
                  f"unpack_phases {what} {dtype}: differs from its plain version")
            # the canary: the C entries into NaN-filled outputs with a tail
            args = (es, B, L, E_, g, S, r, hb, Dh, Mp, torch.cuda.current_stream().cuda_stream)
            out6 = torch.full((want6.numel() + 16 * E_,), float("nan"), dtype=dtype, device="cuda")
            dense = torch.full((want.numel() + 16 * r * E_,), float("nan"), dtype=dtype, device="cuda")
            rc_pack = _build.library("pack_phases").gp_pack_phases(x.data_ptr(), out6.data_ptr(), *args)
            rc_unpack = _build.library("unpack_phases").gp_unpack_phases(p6.data_ptr(), dense.data_ptr(), *args)
            torch.cuda.synchronize()
            check(rc_pack == 0 and rc_unpack == 0, f"canary {what} {dtype}: rc {rc_pack}, {rc_unpack}")
            for label, buf, ref in (("pack", out6, want6), ("unpack", dense, want)):
                inside, tail = buf[:ref.numel()], buf[ref.numel():]
                check(torch.equal(_bits(inside), _bits(ref.reshape(-1))),
                      f"canary {label} {what} {dtype}: a slot inside unwritten or wrong")
                check(bool(torch.isnan(tail).all()), f"canary {label} {what} {dtype}: wrote past the tensor")
            zeros = int((_bits(want6) == 0).sum()) + int((_bits(want) == 0).sum())
            cases.append({"what": what, "dtype": str(dtype).replace("torch.", ""), "B": B, "L": L, "g": g,
                          "S": S, "r": r, "Dh": Dh, "Mp": Mp, "last_segment": L - (S - 1) * g,
                          "unit_bytes": {"pack": _unit_bytes(es, Dh, x.data_ptr(), out6.data_ptr()),
                                         "unpack": _unit_bytes(es, Dh, p6.data_ptr(), dense.data_ptr())},
                          "exact_zero_slots": zeros})
    # a shape the entries cannot take: too few packed rows for the segment
    x = torch.zeros(1, 300, E, device="cuda")
    g, S, m, Mp = dk._branch_geometry(300, 64, 2)
    refused = []
    for label, fn in (("pack_phases", lambda: dk.pack_phases(x, g, S, 2, 16, H)),
                      ("unpack_phases", lambda: dk.unpack_phases(
                          torch.zeros(1, S, 2, H // 2, 16, E // H, device="cuda"), 300, E, g, S, 2))):
        try:
            fn()
        except RuntimeError:
            refused.append(f"{label} Mp*r < g")
            continue
        raise AssertionError(f"{label} took Mp = 16 for g = {g}, r = 2")
    emit("copy_edges", cases=cases, refused=refused, tail={"pack": "16 packed rows of every phase",
                                                           "unpack": "16*r dense rows"},
         note="wrapper and direct C entry bit-exact to the plain versions; canary tails stayed NaN")


def _many_cells(dk):
    """The branch kernel past the 65535 cells one grid dimension could hold:
    64 slides of 8192 tokens in 64-token segments, r = 1, each row with its
    own valid length and row 0 with none (every cell masked: out exactly 0,
    lse at most -1e19), bf16 (the tensor-core kernel)."""
    import torch

    B, L, sl, r = 64, 8192, 64, 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    cells = B * S * r * (H // r)
    check(cells > 65535, f"many-cells check has only {cells} cells")
    q6, k6, v6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen)
                  .to(torch.bfloat16) for _ in range(3))
    valid = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    valid[0] = 0
    kvlen = dk._branch_kvlen(B, S, g, r, m, L, valid, q6.device)
    out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    out_ref, lse_ref = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen)
    torch.testing.assert_close(out6, out_ref, **KERNEL_TOL["bfloat16"])
    covered = lse_ref > -1e19
    torch.testing.assert_close(lse5[covered], lse_ref[covered], **LSE_TOL["bfloat16"])
    check(bool((lse5[~covered] <= -1e19).all()), "many cells: uncovered lse above -1e19")
    check(not bool(out6[~covered].any()), "many cells: fully masked rows not 0")
    check(not bool(out6[0].any()) and bool((lse5[0] <= -1e19).all()), "many cells: the masked row's cells")
    emit("kernels_many_cells", dtype="bfloat16", B=B, L=L, sl=sl, r=r, cells=cells, empty_rows=1,
         masked_rows=int((~covered).sum()), max_abs_err={
             "out": max_err(out6, out_ref), "lse_covered": max_err(lse5[covered], lse_ref[covered])})


def _flagship_inputs(B: int, gen):
    import torch

    x = torch.randn(B, N_TILES, 1536, device="cuda", generator=gen)
    idx = torch.arange(N_TILES, device="cuda")
    grid = torch.stack([idx // 128, idx % 128], dim=-1).float() * 256.0  # 80 x 128 tile grid
    return x, grid[None].expand(B, N_TILES, 2).contiguous()


def _embeds(out: dict):
    return [out[f"layer_{i}_embed"] for i in range(13)]


def phase_slide_forward():
    """The flagship forward through the entry points, fp32 and bf16."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    gen = torch.Generator(device="cuda").manual_seed(1)
    x, coords = _flagship_inputs(1, gen)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        model = create_model("", "gigapath_slide_enc12l768d", dtype=dtype, seed=0)
        run_inference_with_slide_encoder(x, coords, model)  # warm-up
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        out = run_inference_with_slide_encoder(x, coords, model)
        counts = dict(dk.LAUNCHES)
        expected = SLIDE_FWD_LAUNCHES
        check(counts == expected, f"{dname} forward launches {counts} != {expected}")
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_inference_with_slide_encoder(x, coords, model)  # ends in a device->host copy
            secs.append(time.perf_counter() - t0)
        with plain_kernels():
            ref = run_inference_with_slide_encoder(x, coords, model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_inference_with_slide_encoder(x, coords, model)
            plain_s = time.perf_counter() - t0
        per_layer = []
        for a, b in zip(_embeds(out), _embeds(ref)):
            check(a.shape == (1, E) and np.isfinite(a).all(), f"{dname}: bad embedding {a.shape}")
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
            per_layer.append({"rel": rel, "cos": cos})
            if dname == "float32":
                check(rel <= F32_REL_TOL, f"fp32 layer embedding rel err {rel} > {F32_REL_TOL}")
            else:
                check(1.0 - cos <= BF16_MAX_ONE_MINUS_COS,
                      f"bf16 layer embedding 1 - cosine {1.0 - cos} > {BF16_MAX_ONE_MINUS_COS}")
        ms = statistics.median(secs) * 1e3
        emit("slide_forward", dtype=dname, tiles=N_TILES, launches=counts,
             ms_per_slide=ms, runs_ms=[s * 1e3 for s in secs], tokens_per_s=N_TILES / (ms / 1e3),
             plain_path_ms=plain_s * 1e3, peak_mem_gb=_peak() / 2**30,
             vs_plain=per_layer,
             tolerance={"float32": f"rel <= {F32_REL_TOL}",
                        "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname])
        del model
        torch.cuda.empty_cache()


def phase_ragged_batch():
    """B = 2 with a pad mask (per-row valid counts): each row equals that
    slide run alone."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    gen = torch.Generator(device="cuda").manual_seed(2)
    x, coords = _flagship_inputs(2, gen)
    n_valid = [N_TILES, 7001]
    pad_mask = torch.arange(N_TILES, device="cuda")[None] < torch.tensor(n_valid, device="cuda")[:, None]
    model = create_model("", "gigapath_slide_enc12l768d", seed=0)
    batch = run_inference_with_slide_encoder(x, coords, model, pad_mask=pad_mask)
    worst = 0.0
    for row, n in enumerate(n_valid):
        alone = run_inference_with_slide_encoder(x[row, :n], coords[row, :n], model)
        for a, b in zip(_embeds(batch), _embeds(alone)):
            rel = float(np.abs(a[row] - b[0]).max() / max(np.abs(b[0]).max(), 1e-12))
            worst = max(worst, rel)
    check(worst <= F32_REL_TOL, f"ragged batch row vs alone rel err {worst} > {F32_REL_TOL}")
    emit("ragged_batch", dtype="float32", n_valid=n_valid, max_rel_err=worst, tolerance=F32_REL_TOL)


# ---------------------------------------------------------------------------
# the backward kernels and the fine-tuning step
# ---------------------------------------------------------------------------


def _bwd_bounds(args, dtype_name):
    """Least card time (ms) of the dq and the dkv kernel's work at this
    branch (:func:`_declared_bound`: 6 Dh operations per admitted pair for
    dq, 8 Dh for dkv, or each input read once and each output written
    once); and the (query, key) pairs the masks admit."""
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    dq, flops = _declared_bound(dk.dilated_branch_bwd_dq, dtype_name, *args)
    return {"dilated_branch_bwd_dq": dq,
            "dilated_branch_bwd_dkv": _declared_bound(dk.dilated_branch_bwd_dkv, dtype_name, *args)[0]
            }, flops / (6 * (E // H))


def _grad_rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30))


def phase_bwd_kernels():
    """dq and dkv vs their plain version at the flagship's branch shapes."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    _bwd_sass()
    L, B = N_TILES + 1, 1
    real_len = L - 37
    gen = torch.Generator(device="cuda").manual_seed(4)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(4))
        totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={},
                             wrapper_ms=0.0, exp2_floor_ms=0.0) for name in BWD_KERNELS}
        for sl, r in zip(*SCHEDULE):
            g, S, m, Mp = dk._branch_geometry(L, sl, r)
            kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, None, q.device)
            q6, k6, v6, do6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v, do))
            out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
            delta = (do6.float() * out6.float()).sum(-1)
            args = (q6, k6, v6, do6, lse5, delta, kvlen)
            dq6 = dk.dilated_branch_bwd_dq(*args)
            dk6, dv6 = dk.dilated_branch_bwd_dkv(*args)
            ref = dk.dilated_branch_bwd_reference(*args)
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for gname, ours, want in zip(("dq", "dk", "dv"), (dq6, dk6, dv6), ref):
                check(bool(torch.isfinite(ours).all()), f"bwd {dname} r={r}: non-finite {gname}")
                errs[gname] = _grad_rel_err(ours[..., :m, :], want[..., :m, :])
                abs_errs[gname] = max_err(ours[..., :m, :], want[..., :m, :])
                check(errs[gname] <= BWD_REL_TOL[dname],
                      f"bwd {dname} sl={sl} r={r}: {gname} rel err {errs[gname]} > {BWD_REL_TOL[dname]}")
            # keys past kvlen (and pad rows) get exact-zero dk and dv
            key_pad = torch.arange(Mp, device="cuda")[None, None, None, None, :] >= kvlen[..., None, None]
            check(not bool(dk6[key_pad.expand_as(dk6[..., 0])].any()), f"bwd r={r}: dk past kvlen not 0")
            check(not bool(dv6[key_pad.expand_as(dv6[..., 0])].any()), f"bwd r={r}: dv past kvlen not 0")

            # times: each kernel's device time from a CUDA graph, its
            # wrapper's CUDA-event time beside it
            t = {"dilated_branch_bwd_dq": graph_ms(lambda: dk.dilated_branch_bwd_dq(*args)),
                 "dilated_branch_bwd_dkv": graph_ms(lambda: dk.dilated_branch_bwd_dkv(*args))}
            wrapper = {"dilated_branch_bwd_dq": time_ms(lambda: dk.dilated_branch_bwd_dq(*args)),
                       "dilated_branch_bwd_dkv": time_ms(lambda: dk.dilated_branch_bwd_dkv(*args))}
            plain = {
                "dilated_branch_bwd_dq": time_ms(
                    lambda: dk.dilated_branch_bwd_reference(*args, dkv=False), reps=3, warmup=1),
                "dilated_branch_bwd_dkv": time_ms(
                    lambda: dk.dilated_branch_bwd_reference(*args, dq=False), reps=3, warmup=1),
            }
            # library yardstick: the backward of one SDPA call with the
            # valid-key mask on the packed shapes, through autograd
            hb = H // r
            qs, ks, vs = (x.reshape(B * S * r, hb, Mp, E // H).detach().requires_grad_() for x in (q6, k6, v6))
            key_ok = (torch.arange(Mp, device="cuda")[None] < kvlen.reshape(-1, 1))[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok)
            lib_do = do6.reshape(lib_out.shape)
            lib = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), lib_do, retain_graph=True), reps=5)
            bounds, pairs = _bwd_bounds(args, dname)
            exp2_floor = _exp2_floor_ms(pairs)
            for name in BWD_KERNELS:
                tot = totals[name]
                tot["ms"] += t[name]
                tot["wrapper_ms"] += wrapper[name]
                tot["exp2_floor_ms"] += exp2_floor
                tot["plain_ms"] += plain[name]
                tot["bound_ms"] += bounds[name][0]
                tot["library_ms"] += lib  # one library call covers dq, dk and dv
                grads = ("dq",) if name.endswith("dq") else ("dk", "dv")
                tot["err"] = max(tot["err"], *(abs_errs[x] for x in grads))
                tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + bounds[name][0]
            emit("bwd_kernels", dtype=dname, sl=sl, r=r, S=S, m=m, Mp=Mp, real_len=real_len,
                 max_rel_err=errs, max_abs_err=abs_errs, tolerance=BWD_REL_TOL[dname], ms=t, wrapper_ms=wrapper,
                 plain_ms=plain, library_ms_sdpa_bwd=lib, admitted_pairs=pairs, exp2_floor_ms=exp2_floor,
                 bound_ms={n: b[0] for n, b in bounds.items()}, bound_by={n: b[1] for n, b in bounds.items()})
            del q6, k6, v6, do6, out6, lse5, delta, args, dq6, dk6, dv6, ref, qs, ks, vs, lib_out, lib_do
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
        summary[dname] = totals
        emit("bwd_kernels_per_layer", dtype=dname,
             note="sum over the 5 branches of one layer; ms is each kernel's device time from a CUDA graph of 20 "
                  "calls, wrapper_ms one call's CUDA-event time; library_ms is one SDPA backward (dq, dk, dv) "
                  "per branch; exp2_floor_ms: one exp2 per admitted pair at 16 a clock per SM",
             sm_clock_mhz=_MUFU.get("sm_clock_mhz"), kernels=totals)
    _many_cells_bwd(dk)
    _causal_branch(dk)
    _refused_bwd_inputs(dk)
    return summary


def _bwd_sass():
    """The SASS of the branch backward's four libraries (rows 7 and 8,
    serial and pipelined) at Dh = 48: HMMA > 0 (bf16 tensors run on the
    tensor cores; fp32 on the FMA kernels), with ptxas' registers and
    spills of their tensor-core kernels."""
    sass = {name: _sass_counts(name, GP_HEAD_DIM=E // H) for name in BWD_MMA_SOURCES}
    emit("bwd_kernels", sass=sass, note="cuobjdump -sass at Dh = 48: HMMA is mma.sync (the bf16 dq and dkv)",
         tensor_core_ptxas={name: _mma_ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in BWD_MMA_SOURCES})
    for name, counts in sass.items():
        check(counts["HMMA"] > 0, f"{name}: no HMMA in its SASS {counts}")


def _refused_bwd_inputs(dk):
    """bf16 tensors the tensor-core dq and dkv, serial and pipelined, cannot
    take raise in the wrappers: a head width that is no multiple of 8, a dO
    that is not 16-byte aligned; no plain version runs on the card."""
    import torch

    kvlen = torch.full((1, 1, 1), 64, dtype=torch.int32, device="cuda")
    rows = torch.zeros(1, 1, 1, 1, 64, dtype=torch.float32, device="cuda")
    narrow = torch.zeros(1, 1, 1, 1, 64, 20, dtype=torch.bfloat16, device="cuda")
    shifted = torch.zeros(64 * 48 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, 1, 1, 1, 64, 48)
    ok = shifted.clone()
    refused = []
    for fn in (dk.dilated_branch_bwd_dq, dk.dilated_branch_bwd_dkv, dk.dilated_branch_bwd_dq_pipe,
               dk.dilated_branch_bwd_dkv_pipe):
        for label, args in (("Dh=20", (narrow,) * 4), ("misaligned do6", (ok, ok, ok, shifted))):
            try:
                fn(*args, rows, rows, kvlen)
            except ValueError:
                refused.append(f"{fn.__name__} {label}")
                continue
            raise AssertionError(f"{fn.__name__} took bf16 tensors with {label}")
    emit("bwd_kernels_refused_inputs", refused=refused)


def _causal_branch(dk):
    """The causal path of the forward and both backward kernels at one
    flagship branch shape (sl = 5792, r = 2), fp32 and bf16 (the forward on
    the tensor cores), against their plain versions: out and lse within
    KERNEL_TOL / LSE_TOL, the gradients within BWD_REL_TOL."""
    import torch

    L, B, sl, r = N_TILES + 1, 1, 5792, 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q6, k6, v6, do6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen).to(dtype)
                           for _ in range(4))
        kvlen = dk._branch_kvlen(B, S, g, r, m, L - 37, None, q6.device)
        out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen, True)
        out_ref, lse_ref = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen, True)
        torch.testing.assert_close(out6, out_ref, **KERNEL_TOL[dname])
        torch.testing.assert_close(lse5, lse_ref, **LSE_TOL[dname])
        errs[dname] = {"out": _grad_rel_err(out6, out_ref), "lse": max_err(lse5, lse_ref)}
        delta = (do6.float() * out6.float()).sum(-1)
        args = (q6, k6, v6, do6, lse5, delta, kvlen, True)
        grads = (dk.dilated_branch_bwd_dq(*args), *dk.dilated_branch_bwd_dkv(*args))
        for gname, ours, want in zip(("dq", "dk", "dv"), grads, dk.dilated_branch_bwd_reference(*args)):
            errs[dname][gname] = err = _grad_rel_err(ours, want)
            check(err <= BWD_REL_TOL[dname], f"causal {dname} {gname} rel err {err} > {BWD_REL_TOL[dname]}")
    emit("causal_branch", sl=sl, r=r, max_err=errs,
         tolerance={"out": KERNEL_TOL, "lse": LSE_TOL, "grads_rel": BWD_REL_TOL})


def _many_cells_bwd(dk):
    """dq and dkv past 65535 cells: 64 slides of 8192 tokens in 64-token
    segments, r = 1, bf16, each row with its own valid length and row 0
    with none (its gradients exactly 0)."""
    import torch

    B, L, sl, r = 64, 8192, 64, 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    cells = B * S * r * (H // r)
    check(cells > 65535, f"many-cells check has only {cells} cells")
    q6, k6, v6, do6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
    valid = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    valid[0] = 0
    kvlen = dk._branch_kvlen(B, S, g, r, m, L, valid, q6.device)
    out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    delta = (do6.float() * out6.float()).sum(-1)
    args = (q6, k6, v6, do6, lse5, delta, kvlen)
    grads = (dk.dilated_branch_bwd_dq(*args), *dk.dilated_branch_bwd_dkv(*args))
    ref = dk.dilated_branch_bwd_reference(*args)
    errs = {}
    for gname, ours, want in zip(("dq", "dk", "dv"), grads, ref):
        errs[gname] = _grad_rel_err(ours, want)
        check(errs[gname] <= BWD_REL_TOL["bfloat16"], f"bwd many cells: {gname} rel err {errs[gname]}")
        check(bool(torch.isfinite(ours).all()), f"bwd many cells: non-finite {gname}")
        check(not bool(ours[0].any()), f"bwd many cells: {gname} of the row with no valid key not 0")
    emit("bwd_kernels_many_cells", dtype="bfloat16", B=B, L=L, sl=sl, r=r, cells=cells,
         empty_rows=1, empty_row_grads="exactly 0 (kvlen = 0 in every cell of row 0)",
         max_rel_err=errs, tolerance=BWD_REL_TOL["bfloat16"])


def _spill_bytes(label: str) -> int:
    """Largest spill-store count ptxas reported for a library this process
    built (0 if none)."""
    import re

    from gigapath_tpu_torch.ops import _build

    found = re.findall(r"(\d+) bytes spill stores", _build.build_log.get(label, ""))
    return max(map(int, found), default=0)


def _mma_ptxas(label: str) -> dict:
    """Most registers and spill-store bytes ptxas reported for the
    tensor-core kernels (entry functions named ``*_mma_kernel``) of a
    library this process built."""
    from gigapath_tpu_torch.ops import _build

    regs, spills = [], []
    for chunk in _build.build_log.get(label, "").split("Compiling entry function")[1:]:
        if "mma_kernel" in chunk.split("'")[1]:
            regs += re.findall(r"Used (\d+) registers", chunk)
            spills += re.findall(r"(\d+) bytes spill stores", chunk)
    return {"registers": max(map(int, regs), default=None), "spill_store_bytes": max(map(int, spills), default=0)}


def phase_head_widths():
    """The three branch kernels and their three pipelined twins at the
    registry's other head widths (H = 16, E = 16 * Dh, one r = 2 branch on
    2049 tokens with a ragged real length), and the three segment-flash
    kernels there (a head-major r = 3 branch and
    a flat r = 1 one), and the streaming pair's forward, dq and dkv (a
    300-row pair across a segment boundary, r = 2, a ragged valid bound;
    the forward's out within KERNEL_TOL, lse on covered rows within
    STREAM_LSE_TOL, the gradients' relative error within BWD_REL_TOL), fp32
    and bf16, against their plain versions; ptxas' spill stores of each."""
    import torch

    from gigapath_tpu_torch.ops import dilated_attention as pda
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.ops import flash_kernels as fk
    from gigapath_tpu_torch.ops import streaming_kernels as sk

    L, B, sl, r = 2049, 1, 1024, 2
    gen = torch.Generator(device="cuda").manual_seed(8)
    for dh in OTHER_HEAD_DIMS:
        Eh = H * dh
        g, S, m, Mp = dk._branch_geometry(L, sl, r)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            q, k, v, do = (torch.randn(B, L, Eh, device="cuda", generator=gen).to(dtype) for _ in range(4))
            kvlen = dk._branch_kvlen(B, S, g, r, m, L - 37, None, q.device)
            q6, k6, v6, do6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v, do))
            out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
            out_ref, _ = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen)
            delta = (do6.float() * out6.float()).sum(-1)
            args = (q6, k6, v6, do6, lse5, delta, kvlen)
            ours = (out6, dk.dilated_branch_bwd_dq(*args), *dk.dilated_branch_bwd_dkv(*args))
            refs = (out_ref, *dk.dilated_branch_bwd_reference(*args))
            # the pipelined kernels at this width (their ring takes 32-key
            # stages above a head width of 64)
            out_p, lse_p = dk.dilated_branch_fwd_pipe(q6, k6, v6, kvlen)
            args_p = (q6, k6, v6, do6, lse_p, (do6.float() * out_p.float()).sum(-1), kvlen)
            ours += (out_p, dk.dilated_branch_bwd_dq_pipe(*args_p), *dk.dilated_branch_bwd_dkv_pipe(*args_p))
            refs += (dk.dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen)[0],
                     *dk.dilated_branch_bwd_pipe_reference(*args_p))
            errs[dname] = {}
            for name, a, b in zip(("out", "dq", "dk", "dv", "pipe_out", "pipe_dq", "pipe_dk", "pipe_dv"), ours, refs):
                err = _grad_rel_err(a[..., :m, :], b[..., :m, :])
                check(err <= BWD_REL_TOL[dname], f"Dh={dh} {dname} {name} rel err {err} > {BWD_REL_TOL[dname]}")
                errs[dname][name] = err
        # the segment-flash kernels at this width: one dilated head-major
        # branch (segmented) and one flat r = 1 branch, ragged real length
        flash_errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            qh, kh, vh, do = (torch.randn(B, H, L, dh, device="cuda", generator=gen).to(dtype) for _ in range(4))
            for sl_, r_ in ((1024, 3), (256, 1)):
                flat, fargs, _ = _flash_branch(fk, pda, qh, kh, vh, do, sl_, r_, L - 37, None)
                flash_errs[f"{dname} r={r_}"] = _check_flash(
                    f"Dh={dh} r={r_}", dname, flat, _flash_fwd_bwd(fk, flat, fargs),
                    _flash_fwd_bwd(fk, flat, fargs, plain=True), dq_rows=L - 37 if flat else None, args=fargs)
        # the streaming pair at this width: 300-row blocks, the query block
        # across the g = 256 boundary (lattice step 2, 150 rows a head: three
        # 64-row tiles), keys past valid; the forward against its plain
        # version, the backward's lse and delta from the plain forward
        stream_errs = {}
        g_s, r_s, q0_s, k0_s, c_s, valid_s = 256, 2, 100, 0, 300, 290
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            q, k, v, do = (torch.randn(1, c_s, H, dh, device="cuda", generator=gen).to(dtype) for _ in range(4))
            geo = (q0_s, k0_s, g_s, r_s, valid_s)
            out, lse = sk.stream_pair_fwd_reference(q, k, v, *geo)
            out_k, lse_k = sk.stream_pair_fwd(q, k, v, *geo)
            covered = lse > -5e7
            check(bool(torch.equal(lse_k > -5e7, covered)), f"Dh={dh} {dname} stream fwd: covered rows differ")
            torch.testing.assert_close(out_k, out, **KERNEL_TOL[dname])
            torch.testing.assert_close(lse_k[covered], lse[covered], **STREAM_LSE_TOL[dname])
            stream_errs[f"{dname} out"] = max_err(out_k, out)
            stream_errs[f"{dname} lse_covered"] = max_err(lse_k[covered], lse[covered])
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, do, lse, delta, *geo)
            ours = (sk.stream_pair_bwd_dq(*args), *sk.stream_pair_bwd_dkv(*args))
            for name, a, b in zip(("dq", "dk", "dv"), ours, sk.stream_pair_bwd_reference(*args)):
                err = _grad_rel_err(a, b)
                check(err <= BWD_REL_TOL[dname], f"Dh={dh} {dname} stream {name} rel err {err} > {BWD_REL_TOL[dname]}")
                stream_errs[f"{dname} {name}"] = err
        emit("head_widths", Dh=dh, E=Eh, L=L, sl=sl, r=r, max_rel_err=errs, tolerance=BWD_REL_TOL,
             flash_max_err=flash_errs, stream_max_err=stream_errs,
             stream_geometry=dict(g=g_s, r=r_s, q0=q0_s, k0=k0_s, c=c_s, valid=valid_s),
             spill_store_bytes={name: _spill_bytes(f"{name}-GP_HEAD_DIM={dh}")
                                for name in BRANCH_SOURCES + PIPE_KERNELS + FLASH_SOURCES + STREAM_KERNELS},
             tensor_core_ptxas={name: _mma_ptxas(f"{name}-GP_HEAD_DIM={dh}")
                                for name in FWD_MMA_SOURCES + BWD_MMA_SOURCES + STREAM_KERNELS})


def _head_and_steps(torch, lr=5e-5, scheduler="fixed", gc=1, **slide_kwargs):
    """The flagship ClassificationHead (seed 0) with the fine-tuning
    recipe's optimizer, ``gc`` micro-steps an update; ``slide_kwargs`` go to
    the slide encoder."""
    from gigapath_tpu_torch.finetune import utils as ft
    from gigapath_tpu_torch.models.classification_head import get_model

    model = get_model(input_dim=1536, latent_dim=768, feat_layer="11", n_classes=6,
                      model_arch="gigapath_slide_enc12l768d", seed=0, dropout=0.0, drop_path_rate=0.0,
                      **slide_kwargs)
    optimizer = ft.build_optimizer(model, lr=lr, weight_decay=0.05, layer_decay=0.95,
                                   num_layers=len(model.slide_encoder.encoder.layers) + 1)
    sched = ft.make_lr_scheduler(optimizer, lr=lr, min_lr=1e-6, warmup_epochs=0, epochs=1,
                                 steps_per_epoch=100, scheduler=scheduler)
    return model, ft.MultiSteps(optimizer, sched, gc=gc), ft.get_loss_function(PANDA)


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def _worst_grad_err(g_k, g_p, bf16: bool, what: str):
    """(parameter, error) of the worst gradient of the kernel path (g_k)
    against the plain path's (g_p): 1 - cosine in bf16, max |err| over
    max(max |ref|, 1e-2 * the largest gradient) in fp32; a gradient under
    1e-2 of the largest counts 0 in bf16. Fails on a non-finite gradient or
    an error over GRAD_BF16_MAX_ONE_MINUS_COS / GRAD_F32_REL_TOL."""
    import torch

    check(set(g_k) == set(g_p), f"{what}: the two paths reach different parameters")
    floor = 1e-2 * max(float(g.abs().max()) for g in g_p.values())
    errs = {}
    for name, gp in g_p.items():
        gk = g_k[name].float()
        gp = gp.float()
        check(bool(torch.isfinite(gk).all()), f"{what}: non-finite gradient {name}")
        if bf16:
            cos = float((gk * gp).sum() / (gk.norm() * gp.norm() + 1e-30))
            errs[name] = 1.0 - cos if float(gp.abs().max()) > floor else 0.0
        else:
            errs[name] = float((gk - gp).abs().max()) / max(float(gp.abs().max()), floor)
    name, err = max(errs.items(), key=lambda kv: kv[1])
    tol = GRAD_BF16_MAX_ONE_MINUS_COS if bf16 else GRAD_F32_REL_TOL
    check(err <= tol, f"{what} gradient {name}: {err} > {tol}")
    return name, err, tol


def phase_finetune_step():
    """The flagship fine-tune step through finetune/training.py."""
    import torch

    from gigapath_tpu_torch.finetune.training import forward_backward, train_step
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(6)
    x, coords = _flagship_inputs(1, gen)
    labels = torch.tensor([[3]], device="cuda")
    pad_mask = torch.ones(1, N_TILES, dtype=torch.bool, device="cuda")
    batch = (x, coords, labels, pad_mask)
    model, steps, loss_fn = _head_and_steps(torch)

    # gradients of one step, kernels vs the plain path on the card
    worst = {}
    for dname, bf16 in (("float32", False), ("bfloat16", True)):
        runs = []
        for plain in (False, True):
            model.zero_grad(set_to_none=True)
            with plain_kernels() if plain else contextlib.nullcontext():
                loss = forward_backward(model, loss_fn, *batch, multi_label=False, bf16=bf16)
            runs.append((float(loss), _grads(model)))
        (loss_k, g_k), (loss_p, g_p) = runs
        name, err, tol = _worst_grad_err(g_k, g_p, bf16, f"{dname} step")
        worst[dname] = {"param": name, "err": err, "tolerance": tol,
                        "metric": "1 - cosine" if bf16 else "max |err| / max(max |ref|, 1e-2 * largest)",
                        "loss_kernels": loss_k, "loss_plain": loss_p}
    model.zero_grad(set_to_none=True)
    emit("finetune_grads", n_params=len(g_p), worst=worst)

    # launch counts of one bf16 training step (the main path)
    train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)  # warm-up
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)
    torch.cuda.synchronize()
    launches = dict(dk.LAUNCHES)
    check(launches == STEP_LAUNCHES, f"training-step launches {launches} != {STEP_LAUNCHES}")

    # ms per training step, bf16 and fp32
    timing = {}
    for dname, bf16 in (("bfloat16", True), ("float32", False)):
        _reset_peak()
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=bf16)
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=bf16)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ms = statistics.median(secs) * 1e3
        timing[dname] = {"ms_per_step": ms, "runs_ms": [s_ * 1e3 for s_ in secs],
                         "tiles_per_s": N_TILES / (ms / 1e3),
                         "peak_mem_gb": _peak() / 2**30}
    emit("finetune_step", tiles=N_TILES, gc=1, launches=launches, **timing)

    # the synced step (the loop's 20-iteration echo): grad_norm, param_norm
    # and the num.* summaries queued on the device, read in one copy; its
    # ms beside the step without them, in turns
    def synced_step():
        tel = {}
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True, scalars=tel, numerics=True)
        return dict(zip(tel, torch.stack(list(tel.values())).tolist()))

    def plain_step():
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)

    synced_step()  # warm-up
    secs = {"plain": [], "synced": []}
    for _ in range(SYNCED_STEP_PAIRS):
        for k, fn in (("plain", plain_step), ("synced", synced_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
    del model, steps
    torch.cuda.empty_cache()

    # gc = 2 from one seed, with and without the scalars: the gradients each
    # micro-step hands the optimizer (the second parks the first's and adds
    # them back after its backward) and the updated parameters bit-equal
    runs = []
    for with_scalars in (False, True):
        model, steps, loss_fn = _head_and_steps(torch, gc=2)
        seen, update = [], steps.step
        steps.step = lambda update=update, model=model, seen=seen: (seen.append(_grads(model)), update())[1]
        tel = {} if with_scalars else None
        for _ in range(2):
            train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True, scalars=tel,
                       numerics=with_scalars)
        runs.append((seen, {n: p.detach().clone() for n, p in model.named_parameters()},
                     dict(zip(tel, torch.stack(list(tel.values())).tolist())) if tel else None))
        del steps.step  # the recorder holds the model: no cycle left for the collector
        del model, steps
    (seen_p, params_p, _), (seen_s, params_s, values) = runs
    grads_equal = len(seen_p) == len(seen_s) == 2 and all(
        set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a) for a, b in zip(seen_p, seen_s))
    check(grads_equal, "finetune: the synced step's gradients differ from the step without scalars")
    params_equal = all(torch.equal(params_p[n], params_s[n]) for n in params_p)
    check(params_equal, "finetune: the synced step's update differs from the step without scalars")
    check(all(math.isfinite(values[k]) and values[k] > 0 for k in ("grad_norm", "param_norm")),
          f"finetune: synced-step norms {values}")
    numerics_keys = sorted(k for k in values if k.startswith("num."))
    check(numerics_keys and all(math.isfinite(values[k]) for k in numerics_keys),
          f"finetune: synced-step numerics {numerics_keys}")
    del runs, seen_p, seen_s, params_p, params_s
    torch.cuda.empty_cache()
    emit("finetune_synced_step", tiles=N_TILES, dtype="bfloat16",
         ms_plain=statistics.median(secs["plain"]) * 1e3, ms_synced=statistics.median(secs["synced"]) * 1e3,
         runs_ms={k: [x_ * 1e3 for x_ in v] for k, v in secs.items()},
         gc2_grads_bit_equal=grads_equal, gc2_params_bit_equal=params_equal,
         grad_norm=values["grad_norm"], param_norm=values["param_norm"], numerics_keys=numerics_keys)

    # six optimizer steps on one fixed batch: the loss falls
    model, steps, loss_fn = _head_and_steps(torch)
    losses = [float(train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True))
              for _ in range(6)]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0] and min(losses[1:]) < losses[0],
          f"the loss did not fall over six steps on one batch: {losses}")
    emit("finetune_learning", lr=5e-5, losses=losses)
    del model, steps
    torch.cuda.empty_cache()
    return launches, timing


# ---------------------------------------------------------------------------
# the quantized tile kernels, the tile encoder and the two-stage pipeline
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_tile_kernels():
    """Run the quantized tile tier with the kernels' plain PyTorch versions
    on CUDA tensors (the port's plain path on the card)."""
    from gigapath_tpu_torch.models import tile_encoder as te
    from gigapath_tpu_torch.quant import qflash, qmatmul

    saved = qmatmul.q_matmul, te.q_flash_attention
    qmatmul.q_matmul = qmatmul.q_matmul_reference
    te.q_flash_attention = qflash.q_flash_attention_reference
    try:
        yield
    finally:
        qmatmul.q_matmul, te.q_flash_attention = saved


def reset_all_launch_counts():
    from gigapath_tpu_torch.ops import reset_all_launch_counts as reset

    reset()


def all_launch_counts() -> dict:
    from gigapath_tpu_torch.ops import all_launch_counts as counts

    return counts()


def _q_matmul_check(qm, qt_mod, x, N, mode, gen, timed: bool):
    """q_matmul vs its plain version on x [M, K] bf16 and a random [N, K]
    weight quantized to ``mode``, and its fused epilogue (scale, bias, bf16
    cast) against the unfused three steps on the same product; returns
    errors, and times when asked."""
    import torch

    M, K = x.shape
    w = torch.randn(N, K, device="cuda", generator=gen) * K**-0.5
    bias = torch.randn(N, device="cuda", generator=gen)
    qt = qt_mod.quantize_per_channel(w, mode, axis=0)
    y = qm.q_matmul(x, qt)
    ref = qm.q_matmul_reference(x, qt)
    fused = qm.q_matmul(x, qt, bias, torch.bfloat16)
    unfused = (y + bias.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    name = f"q_matmul {mode} {M}x{K}x{N}"
    check(bool(torch.isfinite(y).all()) and y.shape == (M, N), f"{name}: bad output")
    check(torch.equal(fused, unfused), f"{name}: the fused epilogue != (q_matmul + bias).to(bf16)")
    err = max_err(y, ref)
    rel = err / max(float(ref.abs().max()), 1e-30)
    # the written bound (Q_MATMUL_C), read as c in c * K * 2^-24 * (|x| . |w|) * s
    mag = (x.float().abs() @ qt.data.float().abs().t()) * qt.scale.reshape(-1)
    c_read = float(((y - ref).abs() / (K * 2.0**-24 * mag).clamp_min(1e-30)).max())
    check(c_read <= Q_MATMUL_C, f"{name}: |y - ref| reads {c_read} x K 2^-24 (|x|.|w|) s > {Q_MATMUL_C} x")
    out = {"M": M, "K": K, "N": N, "mode": mode, "max_abs_err": err, "max_rel_err": rel, "c_read": c_read,
           "epilogue_equal": True}
    if timed:
        # library yardstick: one cuBLAS bf16 product with the weight's
        # int8 / e4m3 values in bf16 (exact), the scale and bias left out
        w_bf16 = qt.data.to(torch.bfloat16).t()
        flops = 2.0 * M * N * K
        nbytes = M * K * 2 + N * K * 1 + N * 4 * 2 + M * N * 2
        out.update(
            ms=time_ms(lambda: qm.q_matmul(x, qt, bias, torch.bfloat16)),
            fp32_out_ms=time_ms(lambda: qm.q_matmul(x, qt)),
            unfused_ms=time_ms(lambda: (qm.q_matmul(x, qt) + bias.float()).to(torch.bfloat16)),
            plain_ms=time_ms(lambda: qm.q_matmul_reference(x, qt, bias, torch.bfloat16), reps=5),
            library_ms=time_ms(lambda: torch.matmul(x, w_bf16)),
            bound_ms=max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / PEAK_FLOPS["bfloat16"] > nbytes / HBM_BYTES_PER_S else "bytes",
        )
        out["tflops"] = flops / (out["ms"] * 1e-3) / 1e12
        out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


_SASS_TEXT: dict = {}  # (name, defines) -> the library's SASS, read once a process


def _read_sass(specs) -> None:
    """The SASS (``cuobjdump -sass``) of every built library of ``specs``
    (``(name, defines)`` pairs) not read yet, one ``cuobjdump`` each, all
    running at once."""
    from gigapath_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    procs = {spec: subprocess.Popen([tool, "-sass", str(_build._target(*spec))], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for spec in dict.fromkeys(specs) if spec not in _SASS_TEXT}
    for spec, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
        _SASS_TEXT[spec] = out


def _sass(name: str, defines) -> str:
    """The built library's SASS (``cuobjdump -sass``)."""
    spec = (name, tuple(defines))
    _read_sass((spec,))
    return _SASS_TEXT[spec]


def _sass_counts(name: str, **defines) -> dict:
    """Tensor-core instructions in the built library's SASS: HGMMA (wgmma),
    HMMA (mma.sync, fp16/bf16), IMMA (int8)."""
    sass = _sass(name, tuple(sorted(defines.items())))
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA", "IMMA")}


def _sass_vector_counts(name: str, **defines) -> dict:
    """128-bit global loads and stores in the built library's SASS
    (``LDG.E.128``, also as ``LDG.E.128.CONSTANT``; ``STG.E.128``)."""
    sass = _sass(name, tuple(sorted(defines.items())))
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass)) for op in ("LDG.E.128", "STG.E.128")}


def _q_flash_case(qf, qt_mod, B, L, dtype, gen, timed: bool):
    """q_flash_attention vs its plain version on strided q/k/v views of one
    packed [B, L, 3, H, D] qkv, as the tile encoder hands them over."""
    import torch
    import torch.nn.functional as F

    D = TILE_E // TILE_H
    qkv = torch.randn(B, L, 3, TILE_H, D, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.unbind(2)
    out, lse = qf.q_flash_attention(q, k, v)
    ref, lse_ref = qf.q_flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    check(bool(torch.isfinite(out).all()) and out.shape == (B, L, TILE_H, D), f"q_flash {dname} L={L}: bad out")
    torch.testing.assert_close(out, ref, **Q_FLASH_TOL[dname])
    torch.testing.assert_close(lse, lse_ref, **Q_FLASH_LSE_TOL)
    res = {"B": B, "L": L, "H": TILE_H, "D": D, "dtype": dname,
           "max_abs_err": {"out": max_err(out, ref), "lse": max_err(lse, lse_ref)}}
    if timed:
        qq = qt_mod.quantize_dynamic(q.transpose(1, 2))
        kq = qt_mod.quantize_dynamic(k.transpose(1, 2))
        combined = (qq.scale * kq.scale * (D**-0.5 * qf.LOG2E)).reshape(B * TILE_H).contiguous()
        vh = v.transpose(1, 2)
        out_k = torch.empty((B, L, TILE_H, D), dtype=dtype, device="cuda")
        lse_k = torch.empty((B, TILE_H, L), dtype=torch.float32, device="cuda")
        # library: SDPA on the bf16 Q (the int8 data times sq*sk, folded)
        # and K (the int8 data, exact in bf16), the same function
        q_lib = (qq.data.float() * (qq.scale * kq.scale)).to(dtype).contiguous()
        k_lib, v_lib = kq.data.to(dtype).contiguous(), vh.contiguous()
        nbytes = 2 * B * TILE_H * L * D + 2 * B * TILE_H * L * D * qkv.element_size() + 4 * B * TILE_H * L
        flops = 4.0 * B * TILE_H * L * L * D
        res.update(
            ms=time_ms(lambda: qf.q_flash_kernel(qq.data, kq.data, vh, combined, out_k.transpose(1, 2), lse_k)),
            wrapper_ms=time_ms(lambda: qf.q_flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: qf.q_flash_attention_reference(q, k, v), reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q_lib, k_lib, v_lib)),
            bound_ms=max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / PEAK_FLOPS["bfloat16"] > nbytes / HBM_BYTES_PER_S else "bytes",
        )
        res["wrapper_minus_kernel_ms"] = res["wrapper_ms"] - res["ms"]  # Q and K's int8 quantization in torch
        check(torch.equal(out_k, out), "q_flash_kernel alone != the wrapper's output")
    return res


def phase_q_kernels():
    """q_matmul (int8 and fp8) at the flagship block's four (K, N) with M =
    128 tiles x 197 tokens, plus ragged shapes, with its fused epilogue;
    q_flash_attention at the flagship's B = 128, H = 24, L = 197, D = 64,
    plus L = 1 and L = 65 (bf16 and fp32 v); the tensor-core instructions
    in both libraries."""
    import torch

    from gigapath_tpu_torch.quant import qflash as qf
    from gigapath_tpu_torch.quant import qmatmul as qm
    from gigapath_tpu_torch.quant import qtensor as qt_mod

    sass = {"q_matmul": _sass_counts("q_matmul"),
            "q_flash_attention": _sass_counts("q_flash_attention", GP_HEAD_DIM=TILE_E // TILE_H)}
    emit("q_kernels", sass=sass)
    check(sass["q_matmul"]["HGMMA"] > 0, f"q_matmul: no HGMMA in its SASS {sass['q_matmul']}")
    check(sass["q_flash_attention"]["IMMA"] > 0 and sass["q_flash_attention"]["HMMA"] > 0,
          f"q_flash_attention: no IMMA or HMMA in its SASS {sass['q_flash_attention']}")

    gen = torch.Generator(device="cuda").manual_seed(9)
    M = TILE_BATCH * TILE_L
    x_full = torch.randn(M, max(k for k, _ in Q_SHAPES.values()), device="cuda", generator=gen).bfloat16()
    summary = {"q_matmul": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={})}
    block = {}
    for mode in ("int8", "fp8_e4m3"):
        for name, (K, N) in Q_SHAPES.items():
            res = _q_matmul_check(qm, qt_mod, x_full[:, :K].contiguous(), N, mode, gen, timed=True)
            emit("q_kernels", kernel="q_matmul", matmul=name, tolerance=Q_MATMUL_TOL, **res)
            for key in ("ms", "fp32_out_ms", "unfused_ms", "library_ms", "bound_ms"):
                block.setdefault(mode, {}).setdefault(key, 0.0)
                block[mode][key] += res[key]
            if mode == "int8":  # the main path's tier; the block's four matmuls summed
                tot = summary["q_matmul"]
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    tot[key] += res[key]
                tot["err"] = max(tot["err"], res["max_abs_err"])
                tot["by"][res["bound_by"]] = tot["by"].get(res["bound_by"], 0.0) + res["bound_ms"]
        for M_, K, N in ((197, 96, 80), (65, 100, 77), (1, 1536, 4608)):  # ragged edges, K padded, one row
            x = torch.randn(M_, K, device="cuda", generator=gen).bfloat16()
            emit("q_kernels", kernel="q_matmul", matmul="ragged", tolerance=Q_MATMUL_TOL,
                 **_q_matmul_check(qm, qt_mod, x, N, mode, gen, timed=False))
    for mode, tot in block.items():
        emit("q_kernels", kernel="q_matmul", matmul="block", mode=mode,
             note="the block's four matmuls summed: ms fused (bf16 out, bias), fp32_out_ms the product "
                  "alone, unfused_ms the product then the bias add and the cast in torch",
             tflops=2.0 * M * sum(k * n for k, n in Q_SHAPES.values()) / (tot["ms"] * 1e-3) / 1e12,
             bound_share=tot["bound_ms"] / tot["ms"], **tot)
    tot = summary["q_matmul"]
    tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
    del x_full

    flag = _q_flash_case(qf, qt_mod, TILE_BATCH, TILE_L, torch.bfloat16, gen, timed=True)
    emit("q_kernels", kernel="q_flash_attention", tolerance={"out": Q_FLASH_TOL, "lse": Q_FLASH_LSE_TOL},
         note="ms: the kernel on quantized inputs; wrapper_ms adds the int8 quantization in torch",
         **flag)
    summary["q_flash_attention"] = {
        "ms": flag["ms"], "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "library_ms": flag["library_ms"], "err": flag["max_abs_err"]["out"], "bound_by": flag["bound_by"]}
    for L, dtype in ((1, torch.bfloat16), (65, torch.bfloat16), (65, torch.float32), (TILE_L, torch.float32)):
        emit("q_kernels", kernel="q_flash_attention", **_q_flash_case(qf, qt_mod, 2, L, dtype, gen, timed=False))
    return summary


def _write_tiles(directory: str, n: int, seed: int):
    """``n`` synthetic 256 x 256 PNG tiles named ``{x:05d}x_{y:05d}y.png`` on
    a 16-column grid of 256 px steps; returns their paths."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        base = rng.integers(120, 230, size=3)
        arr = np.clip(base + rng.normal(0, 40, size=(256, 256, 3)), 0, 255).astype(np.uint8)
        path = os.path.join(directory, f"{256 * (i % 16):05d}x_{256 * (i // 16):05d}y.png")
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


def _tile_encoder(tier: str):
    """The flagship tile encoder in ``tier``, bf16 compute, seeded random
    weights on the card; its LayerScales drawn at O(0.1-1) (at the init
    value 1e-5 every block would be nearly the identity)."""
    import torch

    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder

    model = create_tile_encoder("", "gigapath_tile_enc", quant=tier, dtype=torch.bfloat16,
                                generator=torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for block in model.blocks:
            for ls in (block.ls1, block.ls2):
                ls.gamma.uniform_(0.1, 1.0, generator=gen)
    return model


def _profile(fn, top: int = 8, watch=()) -> dict:
    """One ``fn()`` under ``torch.profiler``: the device's busy time (the
    union of the device activities' intervals) against the profiled window
    (``fn()`` and the synchronize after it), its idle share, the kernels
    with the most device time, and the device time and calls of the
    kernels whose names contain one of ``watch``, ranked or not.

    The session opens with PROFILE_LEAD_IN spin kernels before the window:
    once the card has gone a while with no session, CUPTI drops (or hands
    over seconds late) the first few kernel records of each session, and a
    short session lost all of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with record_function(PROFILE_WINDOW):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    # neither the lead-in nor the window's own range on the device (a user
    # annotation) is the work's
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CUDA and e.name != PROFILE_WINDOW
                    and "spin_kernel" not in e.name)
    if not device:
        return {"device_time": "not measured (the profiler recorded no device activity)"}
    (window,) = [e for e in events if e.name == PROFILE_WINDOW and e.device_type == DeviceType.CPU]
    window_us = window.time_range.end - window.time_range.start
    busy_us, cursor = 0.0, float("-inf")
    by_name: dict = {}
    for start, end, name in device:
        busy_us += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / window_us,
           "top_device_ms": [{"kernel": k[:120], "ms": ms, "calls": n} for k, (ms, n) in ranked]}
    if watch:
        out["watched_device_ms"] = {
            w: {"ms": sum(ms for k, (ms, n) in by_name.items() if w in k),
                "calls": sum(n for k, (ms, n) in by_name.items() if w in k)} for w in watch}
    return out


def _cosines(a, b):
    import numpy as np

    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_tile_forward(tile_dir: str):
    """The flagship tile encoder through run_inference_with_tile_encoder on
    160 PNG tiles in three tiers: bf16 (no kernel), int8+attn (both
    kernels), fp8_e4m3 (q_matmul only); each against its plain path on the
    card, with launch counts, ms per 128-tile batch and peak memory."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.pipeline import run_inference_with_tile_encoder

    paths = _write_tiles(tile_dir, TILE_COUNT, seed=10)
    results, timing, launches = {}, {}, {}
    for tier in ("", "int8+attn", "fp8_e4m3"):
        name = tier or "bf16"
        model = _tile_encoder(tier)
        out = run_inference_with_tile_encoder(paths, model)
        emb, coords = out["tile_embeds"], out["coords"]
        check(emb.shape == (TILE_COUNT, TILE_E) and np.isfinite(emb).all(), f"{name}: bad tile embeddings")
        with plain_tile_kernels():
            ref = run_inference_with_tile_encoder(paths, model)["tile_embeds"]
        one_minus_cos = 1.0 - _cosines(emb, ref)
        worst = float(one_minus_cos.max())
        check(worst <= TILE_MAX_ONE_MINUS_COS, f"{name}: 1 - cosine vs plain {worst} > {TILE_MAX_ONE_MINUS_COS}")

        # ms per 128-tile batch through the entry (PNG decode and transform
        # on the host included), and the launch counts of its first run (the
        # main path)
        secs = []
        for run in range(3):
            torch.cuda.synchronize()
            reset_all_launch_counts()
            t0 = time.perf_counter()
            run_inference_with_tile_encoder(paths[:TILE_BATCH], model)  # ends in a device->host copy
            secs.append(time.perf_counter() - t0)
            if run == 0:
                counts = all_launch_counts()
        want = dict.fromkeys(counts, 0)
        want["q_matmul"], want["q_flash_attention"] = TILE_LAUNCHES[tier]
        check(counts == want, f"{name}: launches of one batch {counts} != {want}")
        launches[name] = counts

        # the model's forward alone on a batch held on the card (warm: the
        # runs above compiled nothing new and quantized every weight)
        gen = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn(TILE_BATCH, 224, 224, 3, device="cuda", generator=gen).bfloat16()
        _reset_peak()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(x), reps=3, warmup=0)
            with plain_tile_kernels():
                plain_fwd_ms = time_ms(lambda: model(x), reps=1, warmup=0)
            trace = _profile(lambda: model(x))
        peak = _peak() / 2**30
        ms = statistics.median(secs) * 1e3
        timing[name] = {"ms_per_batch": ms, "tiles_per_s": TILE_BATCH / (ms / 1e3),
                        "forward_ms_per_batch": fwd_ms, "forward_tiles_per_s": TILE_BATCH / (fwd_ms / 1e3),
                        "plain_forward_ms_per_batch": plain_fwd_ms, "peak_mem_gb": peak}
        results[name] = emb
        emit("tile_forward", tier=name, tiles=TILE_COUNT, batch=TILE_BATCH, launches_per_batch=counts,
             vs_plain={"max_one_minus_cos": worst, "mean_one_minus_cos": float(one_minus_cos.mean()),
                       "max_abs_err": float(np.abs(emb - ref).max())},
             tolerance=f"1 - cosine per tile <= {TILE_MAX_ONE_MINUS_COS}", runs_ms=[t * 1e3 for t in secs],
             forward_trace=trace, **timing[name])
        del model, x
        torch.cuda.empty_cache()
        if tier == "int8+attn":
            stage_two = (emb, coords)
    emit("tile_tiers", note="mean per-tile cosine of each quantized tier against the bf16 tier "
                            "(a reading on random weights; the JAX int8 parity bar is 0.999 on its fixture)",
         mean_cosine_vs_bf16={name: float(_cosines(results[name], results["bf16"]).mean())
                              for name in ("int8+attn", "fp8_e4m3")})
    return launches, timing, stage_two


def phase_two_stage(tile_embeds, coords):
    """The int8+attn tile embeddings and their coords through
    run_inference_with_slide_encoder on the flagship slide encoder (bf16,
    as load_tile_slide_encoder builds it), against the plain path."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    model = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0)
    reset_all_launch_counts()
    out = run_inference_with_slide_encoder(tile_embeds, coords, model)
    counts = all_launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(pack_phases=180, dilated_branch_fwd=60, unpack_phases=60)
    check(counts == want, f"two-stage slide launches {counts} != {want}")
    with plain_kernels():
        ref = run_inference_with_slide_encoder(tile_embeds, coords, model)
    worst = 0.0
    for a, b in zip(_embeds(out), _embeds(ref)):
        check(a.shape == (1, E) and np.isfinite(a).all(), f"two-stage: bad slide embedding {a.shape}")
        worst = max(worst, float(1.0 - _cosines(a, b).min()))
    check(worst <= BF16_MAX_ONE_MINUS_COS, f"two-stage 1 - cosine {worst} > {BF16_MAX_ONE_MINUS_COS}")
    emit("two_stage", tiles=len(tile_embeds), tier="int8+attn", slide_dtype="bfloat16", launches=counts,
         max_one_minus_cos_vs_plain=worst, tolerance=BF16_MAX_ONE_MINUS_COS,
         last_layer_norm=float(np.linalg.norm(out["last_layer_embed"])))
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# streaming chunked prefill: the chunk-pair kernels, the streaming forward
# and the streaming serve path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_stream_kernels():
    """Run the chunk-pair op with the kernels' plain PyTorch versions on
    CUDA tensors (the streaming plain path on the card)."""
    from gigapath_tpu_torch.ops import streaming_kernels as sk

    saved = sk.stream_pair_fwd, sk.stream_pair_bwd_dq, sk.stream_pair_bwd_dkv
    sk.stream_pair_fwd = sk.stream_pair_fwd_reference
    sk.stream_pair_bwd_dq = lambda *a: sk.stream_pair_bwd_reference(*a, dkv=False)[0]
    sk.stream_pair_bwd_dkv = lambda *a: sk.stream_pair_bwd_reference(*a, dq=False)[1:]
    try:
        yield
    finally:
        sk.stream_pair_fwd, sk.stream_pair_bwd_dq, sk.stream_pair_bwd_dkv = saved


def _ptxas(label: str) -> dict:
    """Most registers and spill-store bytes ptxas reported for a library
    this process built (over its fp32 and bf16 instantiations)."""
    import re

    from gigapath_tpu_torch.ops import _build

    log = _build.build_log.get(label, "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    return {"registers": max(regs, default=None), "spill_store_bytes": _spill_bytes(label)}


def _stream_bounds(calls, dtype_name: str) -> dict:
    """Least card time (ms) of each stream kernel's work on one pair
    (:func:`_declared_bound`); ``calls`` maps each kernel to its wrapper
    and arguments."""
    return {name: _declared_bound(fn, dtype_name, *args)[0] for name, (fn, args) in calls.items()}


def phase_stream_kernels():
    """The three chunk-pair kernels against their plain versions at the
    flagship's chunk pairs (STREAM_CASES), fp32 and bf16, on strided q, k, v
    (views of packed [B, c, 3, H, Dh] blocks); times of each branch's first
    pair."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import streaming_kernels as sk

    D = E // H
    _stream_sass()
    gen = torch.Generator(device="cuda").manual_seed(12)
    summary = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, library_event_ms=0.0, err=0.0, by={},
                          exp2_floor_ms=0.0) for name in STREAM_KERNELS}
    timed_branches = set()
    for g, r, qi, ki, valid, note in STREAM_CASES:
        (q0, q1), (k0, k1) = STREAM_BLOCKS[qi], STREAM_BLOCKS[ki]
        cq, ck = q1 - q0, k1 - k0
        timed = (g, r) not in timed_branches
        timed_branches.add((g, r))
        mask = sk.pair_mask(q0, cq, k0, ck, g, r, valid, H, "cuda")
        pairs = int(mask.sum())
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            q = torch.randn(1, cq, 3, H, D, device="cuda", generator=gen).to(dtype)[:, :, 0]
            kv = torch.randn(1, ck, 3, H, D, device="cuda", generator=gen).to(dtype)
            k, v = kv[:, :, 1], kv[:, :, 2]
            do = torch.randn(1, cq, H, D, device="cuda", generator=gen).to(dtype)
            dlse = torch.randn(1, H, cq, device="cuda", generator=gen)
            geo = (q0, k0, g, r, valid)
            out, lse = sk.stream_pair_fwd(q, k, v, *geo)
            out_ref, lse_ref = sk.stream_pair_fwd_reference(q, k, v, *geo)
            torch.cuda.synchronize()
            covered = lse_ref > -5e7
            check(bool(torch.equal(lse > -1e7, covered)), f"stream fwd {dname} g={g} r={r}: covered rows differ")
            check(bool((lse[~covered] <= -1e19).all()), f"stream fwd g={g} r={r}: masked-row lse above -1e19")
            check(bool(torch.isfinite(out).all()), f"stream fwd {dname} g={g} r={r}: non-finite out")
            check(not bool(out.transpose(1, 2)[~covered].any()), f"stream fwd g={g} r={r}: masked rows not 0")
            torch.testing.assert_close(out, out_ref, **KERNEL_TOL[dname])
            torch.testing.assert_close(lse[covered], lse_ref[covered], **STREAM_LSE_TOL[dname])
            errs = {"out": max_err(out, out_ref),
                    "lse_covered": max_err(lse[covered], lse_ref[covered]) if pairs else 0.0}

            # the backward with a nonzero lse cotangent folded into delta
            delta = ((do.float() * out.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
            args = (q, k, v, do, lse, delta, *geo)
            dq = sk.stream_pair_bwd_dq(*args)
            dk, dv = sk.stream_pair_bwd_dkv(*args)
            ref = sk.stream_pair_bwd_reference(*args)
            torch.cuda.synchronize()
            rel = {}
            for gname, ours, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                check(bool(torch.isfinite(ours).all()), f"stream bwd {dname} g={g} r={r}: non-finite {gname}")
                errs[gname] = max_err(ours, want)
                if pairs == 0:
                    check(not bool(ours.any()), f"stream bwd g={g} r={r}: {gname} of a masked pair not 0")
                    rel[gname] = 0.0
                else:
                    rel[gname] = _grad_rel_err(ours, want)
                    check(rel[gname] <= BWD_REL_TOL[dname],
                          f"stream bwd {dname} g={g} r={r}: {gname} rel err {rel[gname]} > {BWD_REL_TOL[dname]}")
            record = dict(dtype=dname, g=g, r=r, q_block=[q0, q1], k_block=[k0, k1], valid=valid, note=note,
                          visible_pairs=pairs, max_abs_err=errs, max_rel_err_grads=rel)
            if timed:
                calls = {"stream_pair_fwd": lambda: sk.stream_pair_fwd(q, k, v, *geo),
                         "stream_pair_bwd_dq": lambda: sk.stream_pair_bwd_dq(*args),
                         "stream_pair_bwd_dkv": lambda: sk.stream_pair_bwd_dkv(*args)}
                # the kernel's device time (a CUDA graph of 20 calls), and one
                # wrapper call's (its host work, the output fills and the
                # launch) by CUDA events
                t = {name: graph_ms(fn) for name, fn in calls.items()}
                record["ms"] = t
                record["wrapper_ms"] = {name: time_ms(fn) for name, fn in calls.items()}
                bounds = _stream_bounds({"stream_pair_fwd": (sk.stream_pair_fwd, (q, k, v, *geo)),
                                         "stream_pair_bwd_dq": (sk.stream_pair_bwd_dq, args),
                                         "stream_pair_bwd_dkv": (sk.stream_pair_bwd_dkv, args)}, dname)
                record["bound_ms"] = {n: b[0] for n, b in bounds.items()}
                record["bound_by"] = {n: b[1] for n, b in bounds.items()}
                record["exp2_floor_ms"] = _exp2_floor_ms(pairs)  # one exp2 per visible pair, each kernel
            if timed and dname == "bfloat16":
                plain = {
                    "stream_pair_fwd": time_ms(lambda: sk.stream_pair_fwd_reference(q, k, v, *geo), reps=3, warmup=1),
                    "stream_pair_bwd_dq": time_ms(lambda: sk.stream_pair_bwd_reference(*args, dkv=False), reps=3,
                                                  warmup=1),
                    "stream_pair_bwd_dkv": time_ms(lambda: sk.stream_pair_bwd_reference(*args, dq=False), reps=3,
                                                   warmup=1),
                }
                # library yardstick: one SDPA call with the boolean [H, cq, ck]
                # mask (and the backward of one, for dq, dk and dv at once), by
                # device time (queued_ms: the profiler's busy time of one call
                # dropped most of the backward's device records in a card run,
                # 0.0047 ms against 0.34 by events, and a captured backward
                # fails) and by CUDA events around one call
                qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                lib_fwd_fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask[None])  # noqa: E731
                lib_out = lib_fwd_fn()
                do_h = do.transpose(1, 2)
                lib_bwd_fn = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), do_h, retain_graph=True)  # noqa: E731
                lib_fwd, lib_bwd = queued_ms(lib_fwd_fn), queued_ms(lib_bwd_fn)
                library = {"stream_pair_fwd": lib_fwd, "stream_pair_bwd_dq": lib_bwd, "stream_pair_bwd_dkv": lib_bwd}
                lib_fwd_ev, lib_bwd_ev = time_ms(lib_fwd_fn, reps=5), time_ms(lib_bwd_fn, reps=5)
                library_event = {"stream_pair_fwd": lib_fwd_ev, "stream_pair_bwd_dq": lib_bwd_ev,
                                 "stream_pair_bwd_dkv": lib_bwd_ev}
                record.update(plain_ms=plain, library_ms=library, library_event_ms=library_event)
                for name in STREAM_KERNELS:
                    tot = summary[name]
                    tot["ms"] += t[name]
                    tot["plain_ms"] += plain[name]
                    tot["library_ms"] += library[name]
                    tot["library_event_ms"] += library_event[name]
                    tot["bound_ms"] += bounds[name][0]
                    tot["exp2_floor_ms"] += record["exp2_floor_ms"]
                    tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + bounds[name][0]
                del qh, kh, vh, lib_out
            for name, keys in (("stream_pair_fwd", ("out",)), ("stream_pair_bwd_dq", ("dq",)),
                               ("stream_pair_bwd_dkv", ("dk", "dv"))):
                if dname == "bfloat16":
                    summary[name]["err"] = max(summary[name]["err"], *(errs[x] for x in keys))
            emit("stream_kernels", **record)
            del q, kv, k, v, do, out, lse, out_ref, lse_ref, dq, dk, dv, ref
        del mask
    for tot in summary.values():
        tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
    _stream_canary(sk, gen)
    _refused_stream_inputs(sk)
    emit("stream_kernels_per_branch", dtype="bfloat16",
         note="sum over one chunk pair per branch (the timed pairs); ms is the kernel's device time (a CUDA graph "
              "of 20 calls), library_ms one SDPA call's device time (20 calls queued behind a spin kernel, CUDA "
              "events around them), library_event_ms its CUDA-event time alone, plain_ms CUDA events around one "
              "call; the library of dq and dkv is one SDPA backward (dq, dk and dv) per pair; exp2_floor_ms: one "
              "exp2 per visible pair at 16 a clock per SM",
         kernels=summary,
         ptxas={name: _ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in STREAM_KERNELS},
         tolerance={"out": KERNEL_TOL, "lse_covered": STREAM_LSE_TOL, "grads_rel": BWD_REL_TOL})
    return summary


def _stream_sass():
    """The SASS of the three stream libraries at Dh = 48: HMMA > 0 (bf16
    tensors run on the tensor cores; fp32 on the FMA kernels), and no spill
    store in their tensor-core kernels."""
    sass = {name: _sass_counts(name, GP_HEAD_DIM=E // H) for name in STREAM_KERNELS}
    ptxas = {name: _mma_ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in STREAM_KERNELS}
    emit("stream_kernels_sass", sass=sass, tensor_core_ptxas=ptxas,
         note="cuobjdump -sass at Dh = 48: HMMA is mma.sync (the bf16 forward, dq and dkv)")
    for name in STREAM_KERNELS:
        check(sass[name]["HMMA"] > 0, f"{name}: no HMMA in its SASS {sass[name]}")
        check(ptxas[name]["registers"] is not None and ptxas[name]["spill_store_bytes"] == 0,
              f"{name}: the tensor-core kernel spills or was not built here: {ptxas[name]}")


def _stream_lattice_rows(off: int, c: int, g: int, r: int, H: int, valid=None):
    """[c, H] bool: the rows (or keys, cut at ``valid``) of a c-row block at
    global offset ``off`` on each head's phase lattice, the rows a kernel
    enumerates and writes."""
    import torch

    from gigapath_tpu_torch.ops import streaming_kernels as sk

    step, shift = sk.lattice(off, c, g, r)
    rows = torch.arange(c)
    phases = torch.arange(H) // -(-H // r)
    on = ((off + rows[:, None] - phases[None, :] - shift) % step) == 0
    if valid is not None:
        on &= (off + rows < valid)[:, None]
    return on.cuda()


def _stream_canary(sk, gen):
    """The bf16 forward, dq and dkv write the lattice rows and keys below
    valid and nothing else: the C entries called directly into NaN-filled
    out and lse, dq, dk and dv one row longer than the tensors, at the
    STREAM_CANARY pairs. The rows off the lattice, the keys past valid and
    the extra row stay NaN, and the rows written equal the wrappers' output
    bit for bit."""
    import torch

    from gigapath_tpu_torch.ops import _build

    D = E // H
    lib_fwd = _build.library("stream_pair_fwd", GP_HEAD_DIM=D)
    lib_dq = _build.library("stream_pair_bwd_dq", GP_HEAD_DIM=D)
    lib_dkv = _build.library("stream_pair_bwd_dkv", GP_HEAD_DIM=D)
    results = []
    for g, r, qi, ki, valid in STREAM_CANARY:
        (q0, q1), (k0, k1) = STREAM_BLOCKS[qi], STREAM_BLOCKS[ki]
        cq, ck = q1 - q0, k1 - k0
        q, k, v, do = (torch.randn(1, c, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                       for c in (cq, ck, ck, cq))
        out, lse = sk.stream_pair_fwd(q, k, v, q0, k0, g, r, valid)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, q0, k0, g, r, valid)
        want_dq = sk.stream_pair_bwd_dq(*args)
        want_dk, want_dv = sk.stream_pair_bwd_dkv(*args)
        rel = {name: _grad_rel_err(a, b) for name, a, b in zip(
            ("dq", "dk", "dv"), (want_dq, want_dk, want_dv), sk.stream_pair_bwd_reference(*args))}
        check(max(rel.values()) <= BWD_REL_TOL["bfloat16"], f"canary g={g} r={r}: vs the plain version {rel}")
        geo, q_rows, k_rows = sk._geometry(H, q0, cq, k0, ck, g, r, valid)
        bufs = {name: torch.full(((c + 1) * H * D,), float("nan"), dtype=torch.bfloat16, device="cuda")
                for name, c in (("out", cq), ("dq", cq), ("dk", ck), ("dv", ck))}
        views = {name: buf[:-H * D].view(1, -1, H, D) for name, buf in bufs.items()}
        lse_buf = torch.full(((cq + 1) * H,), float("nan"), device="cuda")  # [B, H, cq] and one row more
        lse_view = lse_buf[:-H].view(1, H, cq)
        scales = (D**-0.5 * sk.LOG2E, D**-0.5)
        with torch.cuda.device(q.device):
            rc_fwd = lib_fwd.gp_stream_pair_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), views["out"].data_ptr(), lse_view.data_ptr(), 1, 1, D,
                geo, -(-q_rows // sk.ROW_TILE), sk._strides(q, k, v, views["out"]), scales[0], sk.cuda_stream(q))
            rc_dq = lib_dq.gp_stream_pair_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                views["dq"].data_ptr(), 1, 1, D, geo, -(-q_rows // sk.ROW_TILE),
                sk._strides(q, k, v, do, views["dq"]), *scales, sk.cuda_stream(q))
            rc_dkv = lib_dkv.gp_stream_pair_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                views["dk"].data_ptr(), views["dv"].data_ptr(), 1, 1, D, geo, -(-k_rows // sk.KEY_ROWS_DKV_BF16),
                sk._strides(q, k, v, do, views["dk"], views["dv"]), *scales, sk.cuda_stream(q))
        check(rc_fwd == rc_dq == rc_dkv == 0, f"canary g={g} r={r}: the entries returned {rc_fwd}, {rc_dq}, {rc_dkv}")
        torch.cuda.synchronize()
        written = {"dq": _stream_lattice_rows(q0, cq, g, r, H),
                   "dk": _stream_lattice_rows(k0, ck, g, r, H, valid)}
        written["out"], written["dv"] = written["dq"], written["dk"]
        counts = {}
        got, on = lse_view[0].t(), written["dq"]  # [cq, H]
        check(bool(torch.isnan(lse_buf[-H:]).all()), f"canary g={g} r={r}: lse wrote past the tensor")
        check(bool(torch.isnan(got[~on]).all()), f"canary g={g} r={r}: lse wrote a row off the lattice")
        check(torch.equal(got[on], lse[0].t()[on]), f"canary g={g} r={r}: lse's rows differ from the wrapper's")
        for name, want in (("out", out), ("dq", want_dq), ("dk", want_dk), ("dv", want_dv)):
            got, on = views[name][0], written[name]  # [c, H, D], [c, H]
            check(bool(torch.isnan(bufs[name][-H * D:]).all()), f"canary g={g} r={r}: {name} wrote past the tensor")
            check(bool(torch.isnan(got[~on]).all()), f"canary g={g} r={r}: {name} wrote a row off the lattice")
            check(torch.equal(got[on], want[0][on]), f"canary g={g} r={r}: {name}'s rows differ from the wrapper's")
            counts[name] = {"written_rows": int(on.sum()), "untouched_rows": int((~on).sum())}
        results.append({"g": g, "r": r, "q_block": [q0, q1], "k_block": [k0, k1], "valid": valid,
                        "lattice_steps": [int(geo[6]), int(geo[10])], "rows": counts, "max_rel_err_vs_plain": rel})
    emit("stream_kernels_canary", dtype="bfloat16", pairs=results, tolerance=BWD_REL_TOL["bfloat16"],
         note="out/lse/dq/dk/dv one row past the tensor, NaN-filled: the rows off the lattice, the keys past valid "
              "and the extra row stayed NaN; the rows written bit-equal to the wrappers', which are held to the "
              "plain version")


def _refused_stream_inputs(sk):
    """bf16 blocks the tensor-core forward, dq and dkv cannot take raise in
    the three wrappers: a q that is not 16-byte aligned, and a k whose head
    stride is no whole number of 16 bytes; no plain version runs on the
    card."""
    import torch

    D, c = E // H, 64
    shifted = torch.zeros(c * H * D + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, c, H, D)
    wide = torch.zeros(1, c, H, D + 4, dtype=torch.bfloat16, device="cuda")[..., :D]
    ok = torch.zeros(1, c, H, D, dtype=torch.bfloat16, device="cuda")
    vec = torch.zeros(1, H, c, device="cuda")
    refused = []
    calls = {"stream_pair_fwd": lambda q, k: sk.stream_pair_fwd(q, k, ok, 0, 0, 64, 1),
             "stream_pair_bwd_dq": lambda q, k: sk.stream_pair_bwd_dq(q, k, ok, ok, vec, vec, 0, 0, 64, 1),
             "stream_pair_bwd_dkv": lambda q, k: sk.stream_pair_bwd_dkv(q, k, ok, ok, vec, vec, 0, 0, 64, 1)}
    for name, call in calls.items():
        for label, (q, k) in (("misaligned q", (shifted, ok)), ("k head stride of 104 bytes", (ok, wide))):
            try:
                call(q, k)
            except ValueError:
                refused.append(f"{name} {label}")
                continue
            raise AssertionError(f"{name} took bf16 blocks with {label}")
    emit("stream_kernels_refused_inputs", refused=refused)


def _slide_chunks(x, coords, order):
    """(idx, embeds, coords) host chunks of one slide in ``order``."""
    xs, cs = x[0].cpu().numpy(), coords[0].cpu().numpy()
    bounds = [(a - 1, b - 1) for a, b in STREAM_BLOCKS[1:]]
    return [(i, xs[bounds[i][0]:bounds[i][1]], cs[bounds[i][0]:bounds[i][1]]) for i in order]


def _run_session(model, chunks, peek=False):
    """A streaming session over the flagship slide's ``chunks`` (already
    bf16-rounded); the last-layer embedding of a peek after every feed
    when ``peek``."""
    from gigapath_tpu_torch.models.slide_encoder import create_streaming_session

    session = create_streaming_session(model, N_TILES, chunk_tiles=STREAM_CHUNK, all_layer_embed=True)
    peeks = []
    for idx, embeds, coords in chunks:
        session.feed(idx, embeds, coords)
        if peek:
            peeks.append(session.peek()[-1].float().cpu().numpy())
    return session, session.finalize(), peeks


def phase_stream_forward():
    """The streaming forward of the flagship slide through its entries."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.models.streaming_encoder import embeds_to_outputs
    from gigapath_tpu_torch.pipeline import (
        run_inference_with_slide_encoder,
        run_inference_with_slide_encoder_streaming,
    )
    from gigapath_tpu_torch.quant.qtensor import bf16_round_trip

    gen = torch.Generator(device="cuda").manual_seed(13)
    x, coords = _flagship_inputs(1, gen)
    in_order = _slide_chunks(x, coords, range(5))
    rounded = [(i, bf16_round_trip(e), c) for i, e, c in in_order]
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        model = create_model("", "gigapath_slide_enc12l768d", dtype=dtype, seed=0)
        run_inference_with_slide_encoder_streaming(in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK)  # warm-up
        torch.cuda.synchronize()
        reset_all_launch_counts()
        stream = run_inference_with_slide_encoder_streaming(in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK)
        counts = all_launch_counts()
        want = dict.fromkeys(counts, 0)
        want["stream_pair_fwd"] = STREAM_FOLDS
        check(counts == want, f"{dname} streaming forward launches {counts} != {want}")
        reset_all_launch_counts()
        session, embeds, _ = _run_session(model, rounded)
        check(session.folds == STREAM_FOLDS == all_launch_counts()["stream_pair_fwd"],
              f"{dname}: session folds {session.folds}, launches {all_launch_counts()['stream_pair_fwd']}")
        by_session = embeds_to_outputs(embeds)
        check(all(np.array_equal(by_session[key], stream[key]) for key in stream),
              f"{dname}: create_streaming_session and the pipeline entry differ")
        dense = run_inference_with_slide_encoder(x, coords, model)
        per_layer = []
        if dname == "float32":
            ref = dense  # the dense kernel path (pack / branch / unpack kernels)
        else:
            with plain_stream_kernels():
                ref = run_inference_with_slide_encoder_streaming(in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK)
        for a, b in zip(_embeds(stream), _embeds(ref)):
            check(a.shape == (1, E) and np.isfinite(a).all(), f"{dname}: bad streaming embedding {a.shape}")
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            cos = float(_cosines(a, b)[0])
            per_layer.append({"rel": rel, "one_minus_cos": 1.0 - cos})
            if dname == "float32":
                check(rel <= F32_REL_TOL, f"fp32 streaming vs dense kernel path rel err {rel} > {F32_REL_TOL}")
            else:
                check(1.0 - cos <= BF16_MAX_ONE_MINUS_COS,
                      f"bf16 streaming vs plain path 1 - cosine {1.0 - cos} > {BF16_MAX_ONE_MINUS_COS}")

        # ms per slide through the streaming and the dense entry, peak memory
        timing = {}
        for name, fn in (("stream", lambda: run_inference_with_slide_encoder_streaming(
                in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK)),
                         ("dense", lambda: run_inference_with_slide_encoder(x, coords, model))):
            torch.cuda.synchronize()
            _reset_peak()
            base = torch.cuda.memory_allocated()
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()  # ends in a device->host copy
                secs.append(time.perf_counter() - t0)
            ms = statistics.median(secs) * 1e3
            timing[name] = {"ms_per_slide": ms, "runs_ms": [t_ * 1e3 for t_ in secs],
                            "tiles_per_s": N_TILES / (ms / 1e3),
                            "peak_mem_gb_above_model": (_peak() - base) / 2**30}
        record = dict(dtype=dname, tiles=N_TILES, chunk_tiles=STREAM_CHUNK, launches=counts,
                      session_folds=session.folds, vs=("dense kernel path" if dname == "float32"
                                                       else "streaming plain path"),
                      per_layer=per_layer, vs_dense_entry_rel=float(max(
                          np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
                          for a, b in zip(_embeds(stream), _embeds(dense)))), **timing,
                      tolerance={"float32": f"rel <= {F32_REL_TOL}",
                                 "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname])
        if dname == "bfloat16":
            record.update(_stream_session_checks(model, rounded, stream))
            with torch.inference_mode():
                record["forward_trace"] = _profile(lambda: run_inference_with_slide_encoder_streaming(
                    in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK), watch=STREAM_KERNELS[:1])
        emit("stream_forward", **record)
        result[dname] = timing
        result["launches"] = counts
        del model
        torch.cuda.empty_cache()
    result["backward"] = _stream_backward()
    return result


def _stream_session_checks(model, rounded, stream):
    """Out-of-order delivery with duplicates and an export/restore halfway,
    both bit-exact against in-order; a peek after every chunk."""
    import numpy as np

    from gigapath_tpu_torch.models.slide_encoder import create_streaming_session
    from gigapath_tpu_torch.models.streaming_encoder import embeds_to_outputs

    def same(embeds):
        out = embeds_to_outputs(embeds)
        return all(np.array_equal(out[key], stream[key]) for key in stream)

    order = [3, 1, 4, 0, 2, 2, 0]
    _, shuffled, _ = _run_session(model, [rounded[i] for i in order])
    check(same(shuffled), "out-of-order delivery with duplicates is not bit-exact")

    first = create_streaming_session(model, N_TILES, chunk_tiles=STREAM_CHUNK, all_layer_embed=True)
    for i in (0, 3, 1):  # chunk 3 held ahead of the frontier
        first.feed(*rounded[i])
    state = first.export_state()
    resumed = create_streaming_session(model, N_TILES, chunk_tiles=STREAM_CHUNK, all_layer_embed=True)
    resumed.restore_state(state)
    for i in (2, 4):
        resumed.feed(*rounded[i])
    check(same(resumed.finalize()), "export/restore halfway is not bit-exact")

    _, final, peeks = _run_session(model, rounded, peek=True)
    last = final[-1].float().cpu().numpy()
    cosines = [float(_cosines(p, last)[0]) for p in peeks]
    check(np.array_equal(peeks[-1], last), "the peek after the last chunk differs from finalize()")
    check(cosines[-1] >= cosines[0] and cosines[0] < 1.0, f"peek cosines do not rise: {cosines}")
    return {"out_of_order": {"order": order, "bit_exact": True},
            "export_restore": {"exported_after": [0, 3, 1], "arrays": len(state), "bit_exact": True},
            "peek_cosine_to_final": cosines,
            "peek_rises_at_every_chunk": all(b >= a for a, b in zip(cosines, cosines[1:]))}


def _stream_backward():
    """Gradients of one flagship layer's streaming attention
    (``streaming_dilated_attention`` over the slide's token blocks) against
    the dense kernel path's (``dilated_attention``): fp32 within
    GRAD_F32_REL_TOL; bf16 (the tensor-core dq and dkv) within
    GRAD_BF16_MAX_ONE_MINUS_COS of the dense kernel path's and of the
    streaming plain path's; the launches of each streaming backward
    (148 dq, 148 dkv). Returns the bf16 launches."""
    import torch

    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.streaming_prefill import streaming_dilated_attention

    gen = torch.Generator(device="cuda").manual_seed(14)
    D = E // H
    base = [torch.randn(1, STREAM_L, H, D, device="cuda", generator=gen) for _ in range(4)]  # q, k, v, w
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v, w = (t.to(dtype) for t in base)
        grads = {}
        for name in ("stream", "dense") if dname == "float32" else ("stream", "stream_plain", "dense"):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            if name == "dense":
                (dilated_attention(*leaves, *SCHEDULE).float() * w.float()).sum().backward()
            else:
                with plain_stream_kernels() if name == "stream_plain" else contextlib.nullcontext():
                    blocks = streaming_dilated_attention(
                        *([t[:, a:b] for a, b in STREAM_BLOCKS] for t in leaves), STREAM_BLOCKS, *SCHEDULE)
                    loss = sum((blk.float() * w[:, a:b].float()).sum() for blk, (a, b) in zip(blocks, STREAM_BLOCKS))
                    torch.cuda.synchronize()
                    reset_all_launch_counts()
                    loss.backward()
                    torch.cuda.synchronize()
                    counts = all_launch_counts()
                if name == "stream":
                    launches[dname] = counts
            grads[name] = [t.grad for t in leaves]
        want = dict.fromkeys(launches[dname], 0)
        want.update(stream_pair_bwd_dq=STREAM_FOLDS // 12, stream_pair_bwd_dkv=STREAM_FOLDS // 12)
        check(launches[dname] == want, f"{dname} streaming backward launches {launches[dname]} != {want}")
        errs = {}
        for vs in grads:
            if vs == "stream":
                continue
            for gname, a, b in zip(("dq", "dk", "dv"), grads["stream"], grads[vs]):
                check(bool(torch.isfinite(a).all()), f"{dname} streaming backward: non-finite {gname}")
                if dname == "float32":
                    err = _grad_rel_err(a, b)
                    check(err <= GRAD_F32_REL_TOL, f"streaming backward {gname} rel err vs {vs} {err}")
                else:
                    err = _one_minus_cos(a, b)
                    check(err <= GRAD_BF16_MAX_ONE_MINUS_COS,
                          f"bf16 streaming backward {gname} 1 - cos vs {vs} {err} > {GRAD_BF16_MAX_ONE_MINUS_COS}")
                errs[f"{gname} vs {vs}"] = err
        emit("stream_backward", dtype=dname, L=STREAM_L, launches=launches[dname],
             **({"max_rel_err": errs, "tolerance": GRAD_F32_REL_TOL} if dname == "float32"
                else {"one_minus_cos": errs, "tolerance": GRAD_BF16_MAX_ONE_MINUS_COS}))
        del q, k, v, w, grads
    return launches["bfloat16"]


def phase_stream_serve():
    """Three slides of different lengths through the streaming submitter,
    each against the dense entry; the head path against the dense head."""
    import types

    import numpy as np
    import torch

    from gigapath_tpu_torch.models.classification_head import get_model
    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder
    from gigapath_tpu_torch.serve.streaming import (
        StreamingSubmitter,
        head_streaming_submitter,
        streaming_head_logits,
    )

    from gigapath_tpu_torch.quant.qtensor import bf16_round_trip

    gen = torch.Generator(device="cuda").manual_seed(15)
    x, coords = _flagship_inputs(1, gen)
    # the dense entry rounds its input through bf16; the submitter takes
    # what it is given, so it is given the rounded embeddings
    xs, cs = bf16_round_trip(x[0].cpu().numpy()), coords[0].cpu().numpy()

    def chunks(n):
        starts = range(0, n, STREAM_CHUNK)
        return [types.SimpleNamespace(chunk_id=i, payload=xs[a:min(a + STREAM_CHUNK, n)],
                                      coords=cs[a:min(a + STREAM_CHUNK, n)])
                for i, a in reversed(list(enumerate(starts)))]

    model = create_model("", "gigapath_slide_enc12l768d", seed=0)
    submitter = StreamingSubmitter(model, chunk_tiles=STREAM_CHUNK)
    requests = []
    for n in STREAM_REQUESTS:
        t0 = time.perf_counter()
        out = submitter.stream_slide(f"slide-{n}", chunks(n), n)
        wall = time.perf_counter() - t0
        dense = run_inference_with_slide_encoder(xs[:n], cs[:n], model)
        rel = max(float(np.abs(out[key] - dense[key]).max() / max(np.abs(dense[key]).max(), 1e-12))
                  for key in dense)
        check(out.keys() == dense.keys() and rel <= F32_REL_TOL, f"served slide of {n} tiles: rel err {rel}")
        requests.append({"tiles": n, "ms": wall * 1e3, "max_rel_err_vs_dense": rel})
    check(submitter.served == 3, f"served {submitter.served} != 3")
    del model
    torch.cuda.empty_cache()

    n = STREAM_REQUESTS[1]
    head = get_model(input_dim=1536, latent_dim=768, feat_layer="11", n_classes=6,
                     model_arch="gigapath_slide_enc12l768d", seed=0).eval()
    head_sub = head_streaming_submitter(head, chunk_tiles=STREAM_CHUNK)
    logits = streaming_head_logits(head, head_sub.stream_slide("head", chunks(n), n))
    with torch.no_grad():
        dense_logits = head(torch.from_numpy(xs[None, :n]).cuda(), coords[:, :n]).float().cpu().numpy()
    rel = float(np.abs(logits - dense_logits).max() / max(np.abs(dense_logits).max(), 1e-12))
    check(logits.shape == (1, 6) and rel <= F32_REL_TOL, f"streaming head logits rel err {rel}")
    emit("stream_serve", dtype="float32", requests=requests, served=submitter.served,
         head={"tiles": n, "logits": logits.tolist(), "max_rel_err_vs_dense_head": rel},
         tolerance=F32_REL_TOL)
    del head
    torch.cuda.empty_cache()


def _serve_slides(slides, seed: int, prefix: str = "s"):
    """(name, features, coords) of ``slides`` tile counts: fp32 features
    from a seeded numpy generator, coords on a 128-wide tile grid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(slides):
        idx = np.arange(n)
        out.append((f"{prefix}{i}_{n}", rng.standard_normal((n, 1536), dtype=np.float32),
                    (np.stack([idx // 128, idx % 128], axis=-1) * 256.0).astype(np.float32)))
    return out


def _serve_files(directory: str, slides, seed: int) -> list:
    """``*_features.pt`` files of :func:`_serve_slides` plus a copy of the
    first slide's content under a name that sorts last; returns the
    triples in file order."""
    import os

    import torch

    out = _serve_slides(slides, seed)
    out.append(("s9_dup", out[0][1], out[0][2]))
    for name, feats, coords in out:
        torch.save({"features": torch.from_numpy(feats), "coords": torch.from_numpy(coords)},
                   os.path.join(directory, f"{name}_features.pt"))
    return out


def _serve_sync_check(model) -> None:
    """One masked forward at a padded shape with no host sync allowed
    (``torch.cuda.set_sync_debug_mode("error")``), under the per-row path a
    capture takes: a sync there would be an error inside a capture."""
    import torch

    from gigapath_tpu_torch.ops.dilated_attention import per_row_valid_len

    x = torch.zeros(SERVE_BATCH, 2048, 1536, device="cuda")
    coords = torch.zeros(SERVE_BATCH, 2048, 2, device="cuda")
    mask = torch.arange(2048, device="cuda")[None, :] < torch.tensor([[2048], [7], [1], [0]], device="cuda")
    torch.cuda.synchronize()
    with torch.inference_mode(), per_row_valid_len():
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(x.to(torch.bfloat16), coords, pad_mask=mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _check_confidences(what: str, bucketed, exact) -> float:
    """The bucketed CSV's confidences against the exact path's, bf16 head:
    ``|b - e| <= atol + rtol * |e|`` at ``KERNEL_TOL["bfloat16"]``; returns
    the largest difference."""
    import numpy as np

    b, e = bucketed["confidence"].to_numpy(), exact["confidence"].to_numpy()
    tol = KERNEL_TOL["bfloat16"]
    check(np.allclose(b, e, **tol), f"{what}: confidences {list(b)} vs exact {list(e)} beyond {tol}")
    return float(np.abs(b - e).max())


def _serve_large_buckets(head, tmp: str) -> dict:
    """The CLI's bucketed path at its default batch size on two slides whose
    keys are both ``SERVE_LARGE_TOKENS`` padded tiles: both captures come
    from the cache's one pool, so the second grows it by little (checked),
    and the run's peak reserved memory follows one key. Labels and
    confidences agree with ``--no-buckets``."""
    import glob
    import json as _json
    import os

    import torch

    from gigapath_tpu_torch import inference

    feat_dir = os.path.join(tmp, "large")
    os.makedirs(feat_dir)
    slides = _serve_slides(SERVE_LARGE_SLIDES, seed=22)
    for name, feats, coords in slides:
        torch.save({"features": torch.from_numpy(feats), "coords": torch.from_numpy(coords)},
                   os.path.join(feat_dir, f"{name}_features.pt"))
    del slides
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    _reset_peak()
    t0 = time.perf_counter()
    bucketed = inference.run_inference(head, feat_dir, os.path.join(tmp, "large_bucketed.csv"))
    seconds = time.perf_counter() - t0
    peak = _peak("reserved")
    after = torch.cuda.memory_reserved()
    exact = inference.run_inference(head, feat_dir, os.path.join(tmp, "large_exact.csv"), use_buckets=False)
    check(list(bucketed["predicted_label"]) == list(exact["predicted_label"]),
          f"serve large: labels {list(bucketed['predicted_label'])} != exact {list(exact['predicted_label'])}")
    conf_err = _check_confidences("serve large", bucketed, exact)
    (log_path,) = [p for p in glob.glob(os.path.join(tmp, "obs", "*.jsonl"))
                   if "large_bucketed.csv" in open(p).readline()]
    events = [_json.loads(line) for line in open(log_path)]
    order = [ev["key"] for ev in events if ev["kind"] == "compile" and ev["fn"] == "serve.forward"]
    (end,) = [ev for ev in events if ev["kind"] == "run_end"]
    with open(end["ledger_path"]) as fh:
        graphs = {e["key"]: e["graph"] for e in _json.load(fh)["entries"].values()}
    want = sorted(str((SERVE_LARGE_TOKENS // b, b)) for b in (131072, 65536))
    check(sorted(order) == want and sorted(graphs) == want, f"serve large: captures {order}, ledger {sorted(graphs)}")
    first, second = (graphs[k]["pool_bytes"] for k in order)
    check(second <= SERVE_SHARED_POOL_GROWTH * first,
          f"serve large: the second capture grew the pool by {second} B, the first by {first} B")
    return {"slides": list(SERVE_LARGE_SLIDES), "batch_size": "CLI default", "keys_in_capture_order": order,
            "pool_growth_bytes": {k: graphs[k]["pool_bytes"] for k in order},
            "capture_s": {k: graphs[k]["capture_s"] for k in order},
            "memory_reserved_before": reserved0, "max_memory_reserved_during_run": peak,
            "memory_reserved_after_run": after, "seconds": seconds,
            "labels": list(map(int, bucketed["predicted_label"])), "max_confidence_diff_vs_exact": conf_err,
            "unexpected_retraces": end["unexpected_retraces"]}


def phase_serve():
    """The serving stack on the card (14b): the CLI's bucketed default path
    through ``inference.run_inference``, and again at its default batch size
    on two keys of 2^20 padded tiles (the cache's one pool); a
    ``SlideService`` on the slide
    encoder held against each slide's exact-shape forward (fp32 and bf16),
    its dummy rows finite and a second pass making no capture; and one
    graph replay against the eager forward at L = 10241."""
    import glob
    import json as _json
    import os

    import numpy as np
    import torch

    from gigapath_tpu_torch import inference
    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.serve import ServeConfig, SlideService
    from gigapath_tpu_torch.serve.buckets import assemble_batch
    from gigapath_tpu_torch.serve.service import _tree_np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_start = torch.cuda.memory_reserved()
    bf16 = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0)
    _serve_sync_check(bf16)
    emit("serve_sync_check", ok=True, note="masked bf16 forward at [4, 2048] under set_sync_debug_mode('error')")

    # -- the CLI's default path (every run log of the phase goes to tmp) ---
    with tempfile.TemporaryDirectory() as tmp, env_flags({"GIGAPATH_OBS_DIR": tmp}):
        feat_dir = os.path.join(tmp, "feats")
        os.makedirs(feat_dir)
        slides = _serve_files(feat_dir, SERVE_SLIDES, seed=19)
        head = inference.load_model("", n_classes=2, feat_layer="11", seed=0)
        reset_all_launch_counts()
        t0 = time.perf_counter()
        bucketed = inference.run_inference(head, feat_dir, os.path.join(tmp, "bucketed.csv"),
                                           use_buckets=True, batch_size=SERVE_BATCH)
        cli_s = time.perf_counter() - t0
        launches = {k: v for k, v in all_launch_counts().items() if v}
        for name in FWD_KERNELS:
            check(launches.get(name, 0) > 0, f"serve CLI: {name} was launched no time")
        exact = inference.run_inference(head, feat_dir, os.path.join(tmp, "exact.csv"), use_buckets=False)
        check(list(bucketed["slide_id"]) == list(exact["slide_id"]), "serve CLI: slide order differs")
        check(list(bucketed["predicted_label"]) == list(exact["predicted_label"]),
              f"serve CLI labels {list(bucketed['predicted_label'])} != exact {list(exact['predicted_label'])}")
        conf_err = _check_confidences("serve CLI", bucketed, exact)
        # --prefetch 2: a loader thread two slides ahead through the dist
        # boundary's memory channel; the same verdicts, bit for bit
        os.makedirs(os.path.join(tmp, "prefetch"))
        t0 = time.perf_counter()
        prefetched = inference.run_inference(head, feat_dir, os.path.join(tmp, "prefetch", "bucketed.csv"),
                                             use_buckets=True, batch_size=SERVE_BATCH, prefetch=2)
        prefetch_s = time.perf_counter() - t0
        check(prefetched.equals(bucketed), "serve CLI: --prefetch 2 verdicts differ from --prefetch 0's")
        (log_path,) = [p for p in glob.glob(os.path.join(tmp, "obs", "*.jsonl"))
                       if '"buckets": true' in open(p).readline()]
        events = [_json.loads(line) for line in open(log_path)]
        counts: dict = {}
        for ev in events:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        (end,) = [ev for ev in events if ev["kind"] == "run_end"]
        captures = [ev for ev in events if ev["kind"] == "compile" and ev["fn"] == "serve.forward"]
        check(len(captures) == len(SERVE_BUCKETS) and not any(ev["unexpected"] for ev in captures),
              f"serve CLI: captures {[ev['key'] for ev in captures]}")
        # the duplicate arrives while the first slide waits in its bucket
        # (batches flush at the end), so it joins that request: one
        # cache_hit event (inflight), no forward of its own
        hits = [ev for ev in events if ev["kind"] == "cache_hit"]
        check(len(hits) == 1 and hits[0]["slide_id"] == "s9_dup", f"serve CLI cache_hit events {hits}")
        check(end["buckets_used"] == len(SERVE_BUCKETS) and end["unexpected_retraces"] == 0
              and end["dispatches"] == len(SERVE_BUCKETS), f"serve CLI run_end {end}")
        with open(end["ledger_path"]) as fh:
            ledger = _json.load(fh)["entries"]
        graphs = {e["key"]: e["graph"] for e in ledger.values()}
        check(sorted(graphs) == sorted(str((SERVE_BATCH, b)) for b in SERVE_BUCKETS), f"ledger keys {sorted(graphs)}")
        emit("serve_cli", dtype="bfloat16", slides=[len(f) for _, f, _ in slides], batch_size=SERVE_BATCH,
             seconds=cli_s, labels=list(map(int, bucketed["predicted_label"])),
             max_confidence_diff_vs_exact=conf_err, confidence_tolerance=KERNEL_TOL["bfloat16"],
             run_log_events=counts,
             run_end={k: end[k] for k in ("dispatches", "buckets_used", "cache_hits", "unexpected_retraces",
                                          "compile_seconds_total")}, cache_hit_events=hits,
             captures={e["key"]: e["seconds"] for e in captures},
             graphs=graphs, launches_of_the_run=launches, prefetch_2_seconds=prefetch_s,
             prefetch_2_bit_equal=True, nvidia_smi=smi)
        emit("serve_large_buckets", **_serve_large_buckets(head, tmp), nvidia_smi=smi)
        del head
        torch.cuda.empty_cache()

        # -- a SlideService against each slide's exact-shape forward -----------
        rows = {}
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            model = bf16 if dtype == torch.bfloat16 else create_model("", "gigapath_slide_enc12l768d",
                                                                       dtype=dtype, seed=0)

            def forward(m, embeds, coords, pad_mask, _dt=dtype):
                return m(embeds.to(_dt), coords, pad_mask=pad_mask)[0]  # the final embedding [B, E]

            config = ServeConfig(max_batch=SERVE_BATCH, max_wait_s=float("inf"), artifact_dir=None)
            service = SlideService(forward, model, config=config, identity=f"enc|{dname}")
            reserved0 = torch.cuda.memory_reserved()
            futs = [service.submit(name, f, c) for name, f, c in slides[:-1]]
            service.drain()
            futs.append(service.submit(*slides[-1]))  # the duplicate, after its twin was served: a cache hit
            service.drain()
            got = [np.asarray(fu.result()) for fu in futs]
            reserved = torch.cuda.memory_reserved()
            worst = 0.0
            with torch.inference_mode():
                for (name, f, c), out in zip(slides, got):
                    want = forward(model, torch.from_numpy(f[None]).cuda(), torch.from_numpy(c[None]).cuda(),
                                   None).float().cpu().numpy()[0]
                    check(out.shape == (E,) and np.isfinite(out).all(), f"serve {dname} {name}: bad row {out.shape}")
                    if dtype == torch.float32:
                        err = float(np.abs(out - want).max() / max(np.abs(want).max(), 1e-12))
                        check(err <= SERVE_F32_REL_TOL, f"serve fp32 {name}: rel err {err} > {SERVE_F32_REL_TOL}")
                    else:
                        err = 1.0 - float((out * want).sum() / (np.linalg.norm(out) * np.linalg.norm(want)))
                        check(err <= BF16_MAX_ONE_MINUS_COS,
                              f"serve bf16 {name}: 1 - cosine {err} > {BF16_MAX_ONE_MINUS_COS}")
                    worst = max(worst, err)
            st = service.stats()
            check(st["cache"]["hits"] == 1 and st["compiled_executables"] == len(SERVE_BUCKETS),
                  f"serve {dname} stats {st}")
            # every dummy row of every captured bucket finite: one real slide a batch
            dummy_finite = {}
            for (cap, bucket), exe in sorted(service.aot._executables.items()):
                (name, f, c) = next(s for s in slides if service.ladder.bucket_for(len(s[1])) == bucket)
                full = _tree_np(exe(*assemble_batch([(f, c)], bucket, cap, feature_dim=1536)))
                dummy_finite[bucket] = bool(np.isfinite(full[1:]).all())
                check(dummy_finite[bucket], f"serve {dname}: a dummy row of bucket {bucket} is not finite")
            del exe  # a replay closure holds its graph and outputs
            # a second pass over new content at the same lengths: no capture
            compiled = service.aot.compiled_count
            again = _serve_slides(SERVE_SLIDES, seed=20, prefix="r")
            futs = [service.submit(name, f, c) for name, f, c in again]
            service.drain()
            for fu in futs:
                check(np.isfinite(np.asarray(fu.result())).all(), f"serve {dname}: second pass not finite")
            check(service.aot.compiled_count == compiled and not service.watchdog.unexpected_retraces,
                  f"serve {dname}: second pass captured ({service.aot.compiled_count} != {compiled})")
            rows[dname] = {"worst": worst, "dummy_rows_finite": dummy_finite,
                           "capture_s": {str(k): v for k, v in service.aot.compile_seconds.items()},
                           "pool_bytes": {str(k): v for k, v in service.aot.pool_bytes.items()},
                           "capture_launches": {str(k): v for k, v in service.aot.capture_launches.items()},
                           "memory_reserved_after_captures": reserved, "reserved_before": reserved0,
                           "stats": {k: st[k] for k in ("dispatches", "compiled_executables", "unexpected_retraces")}}
            service.close()
            del service, model
            torch.cuda.empty_cache()
        emit("serve_vs_exact", slides=list(SERVE_SLIDES), batch=SERVE_BATCH, rows=rows,
             tolerance={"float32": f"rel <= {SERVE_F32_REL_TOL}", "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"},
             nvidia_smi=smi)

        emit("serve_replay", **_serve_replay_times(bf16), nvidia_smi=smi)
    del bf16
    _serve_memory_released(reserved_start)
    return launches


def _dist_plan(**kw) -> dict:
    """The full-width plan: ``default_plan`` at ViT-G/14 int8+attn on 224 x
    224 tiles into the flagship's 1536-wide input, plus the tile arch and
    its compute dtype (the card's quantized kernels take bf16)."""
    from gigapath_tpu_torch.dist.pipeline import default_plan

    plan = default_plan(n_tiles=DIST_TILES, chunk_tiles=DIST_CHUNK, dim_in=1536, dim_out=1536,
                        workers=["w0", "w1"], encoder="quant_vit", quant="int8+attn", img_size=224,
                        lease_s=DIST_LEASE_S, retransmit_s=DIST_RETRANSMIT_S, **kw)
    plan.update(tile_arch="gigapath_tile_enc", tile_dtype="bfloat16")
    return plan


def _dist_out(head, embeds):
    """The consumer's result: the slide encoder's last-layer embedding
    [768] and the head's logits [2], fp32, from the per-layer embeddings
    (a dense forward's or a streaming session's)."""
    import numpy as np

    from gigapath_tpu_torch.serve.streaming import streaming_head_logits

    last = embeds[-1].float().reshape(-1).cpu().numpy()
    return np.concatenate([last, streaming_head_logits(head, embeds).reshape(-1)])


def _dist_builders(head):
    """The consumer's dense and streaming slide stage on ``head`` (the
    flagship as ``inference.load_model`` builds it: bf16, on the card)."""
    import torch

    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession

    @torch.inference_mode()
    def forward(model, embeds, coords):
        x = torch.from_numpy(embeds).cuda().to(torch.bfloat16)
        c = torch.from_numpy(coords).cuda()
        return _dist_out(model, model.slide_encoder(x, c, all_layer_embed=True))[None]  # [1, E + 2]

    def streaming(dim_in):
        def open_session(n_tiles, chunk_tiles, runlog=None):
            return StreamingEncoderSession(head.slide_encoder, n_tiles, chunk_tiles=chunk_tiles,
                                           all_layer_embed=True)

        return open_session, lambda embeds: _dist_out(head, embeds)

    return (lambda dim_in: (forward, head)), streaming, forward


def _dist_run(root: str, plan: dict, **kw) -> dict:
    """One slide through the fleet (a shared obs run id, so the processes'
    trace exports merge), timed, with the consumer's launches (every count
    set to 0 just before), the run's events and the merged timeline's
    critical path."""
    import glob
    import json as _json
    import os

    from gigapath_tpu_torch.dist.pipeline import run_disaggregated
    from gigapath_tpu_torch.obs.fleet import FleetTimeline

    run_id = f"dist-{os.path.basename(root)}"
    with env_flags({"GIGAPATH_OBS_RUN_ID": run_id}):
        reset_all_launch_counts()
        t_wall0 = time.time()
        t0 = time.perf_counter()
        result = run_disaggregated(root, plan=plan, deadline_s=DIST_DEADLINE_S, run_id=run_id, device="cuda", **kw)
        result["wall_s"] = time.perf_counter() - t0
        result["launches"] = {k: v for k, v in all_launch_counts().items() if v}
    events = []
    for path in glob.glob(os.path.join(root, "obs", "*.jsonl")):
        for line in open(path):
            try:
                events.append(_json.loads(line))
            except ValueError:
                continue  # a SIGKILLed worker can die mid-line
    result["events"] = events
    # the merged timeline twice: on the links' clock estimates (what
    # scripts/fleet_report.py shows), and on the one host's monotonic
    # clock, which every process here shares (offset 0): a handshake's
    # estimate carries the producer's first encode in its round trip
    fleet = FleetTimeline.from_dir(os.path.join(root, "obs"), run_id)
    one_host = FleetTimeline.from_parts([{"label": p.label, "doc": p.doc, "events": p.events, "offset_s": 0.0,
                                          "uncertainty_s": 0.0} for p in fleet.processes], run_id=run_id)
    (result["critical_path"],) = fleet.critical_path().values()
    (result["critical_path_one_host"],) = one_host.critical_path().values()
    result["fleet_invariants"] = fleet.invariants() + one_host.invariants()
    result["clock_offsets_s"] = {p.label: [p.offset_s, p.uncertainty_s] for p in fleet.processes}
    # the workers' start (spawn to the first encode), each worker's encode
    # seconds, and each chunk's transit from its send's end to its deliver
    encodes = [e for e in events if e["kind"] == "span" and e.get("name") == "dist.encode"]
    result["first_encode_s"] = min(e["t"] - e["dur_s"] for e in encodes) - t_wall0
    result["encode_s"] = {w: sum(e["dur_s"] for e in encodes if e.get("worker") == w) for w in plan["workers"]}
    wires = sorted(t1 - t0 for _, _, t0, t1 in one_host.wire_intervals())
    result["wire_transit_s"] = {"median": statistics.median(wires), "max": wires[-1], "chunks": len(wires)}
    return result


def _dist_line(name: str, run: dict, smi: str, **extra) -> None:
    emit(name, wall_s=run["wall_s"], first_encode_s=run["first_encode_s"], worker_encode_s=run["encode_s"],
         wire_transit_s=run["wire_transit_s"], slide_wall_s=run["critical_path"]["wall_s"],
         critical_path_s=run["critical_path"]["seconds"], critical_path_shares=run["critical_path"]["shares"],
         one_host_critical_path_s=run["critical_path_one_host"]["seconds"],
         one_host_critical_path_shares=run["critical_path_one_host"]["shares"],
         clock_offsets_s=run["clock_offsets_s"],
         straggler=run["critical_path"]["straggler"], recovery_gaps=run["critical_path"]["recovery_gaps"],
         worker_exit_codes=run["worker_exit_codes"], lost=run["lost"], reassignments=run["reassignments"],
         channel=run["stats"], consumer_launches=run["launches"], fleet_invariants=run["fleet_invariants"],
         nvidia_smi=smi, **extra)


def phase_dist():
    """The disaggregated two-stage pipeline (14c) at full width: two ViT-G/14
    int8+attn worker processes (``python -m gigapath_tpu_torch.dist.worker``
    on the one card) stream 2048 tiles of 224 x 224 in chunks of 128 to the
    flagship head in this process. First the worker's encoder in process
    (its launches of q_matmul and q_flash_attention, every chunk's bits).
    Then three runs: over the ``dir`` transport; over ``tcp`` with
    ``kill_worker@4`` on w1 (bit-equal to the first: embedding and every
    assembled row; ``worker_lost`` and ``recovery action="reassign"``;
    exit codes 0 and -9); chunked prefill (1 - cosine against the first
    within the bf16 route limit). The first run's tiles equal the in-process
    encoder's bit for bit, its result agrees with the one-process
    ``run_inference_with_slide_encoder``, and the consumer's launches of
    each run equal a one-process forward's (dense) and session's (chunked
    prefill) at the same length."""
    import os

    import numpy as np
    import torch

    from gigapath_tpu_torch.dist.boundary import plan_chunks
    from gigapath_tpu_torch.dist.worker import chunk_images, make_encoder
    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    plan = _dist_plan()
    chunks = plan_chunks(DIST_TILES, DIST_CHUNK)

    # -- the worker's encoder in this process: the reference bits ----------
    cudnn = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    t0 = time.perf_counter()
    encode = make_encoder(plan, device="cuda")
    build_s = time.perf_counter() - t0
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiles = [encode(a, b) for _, a, b in chunks]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, a, b in chunks:  # the synthetic tiles alone (numpy, on the host)
        chunk_images(plan, a, b)
    images_s = time.perf_counter() - t0
    tile_launches = {k: v for k, v in all_launch_counts().items() if v}
    check(tile_launches.get("q_matmul", 0) > 0 and tile_launches.get("q_flash_attention", 0) > 0,
          f"dist: the in-process tile encoder launched {tile_launches}")
    expected = np.concatenate([t[0] for t in tiles])
    coords = np.concatenate([t[1] for t in tiles])
    del encode, tiles
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = cudnn
    torch.cuda.empty_cache()
    emit("dist_tile_encoder", tiles=DIST_TILES, chunk_tiles=DIST_CHUNK, build_s=build_s,
         encode_s=encode_s, images_s=images_s, tiles_per_s=DIST_TILES / encode_s, launches=tile_launches,
         finite=bool(np.isfinite(expected).all()), nvidia_smi=smi)
    check(np.isfinite(expected).all(), "dist: the tile encoder's embeddings are not finite")

    from gigapath_tpu_torch import inference

    head = inference.load_model("", n_classes=2, feat_layer="11", seed=0)
    dense, streaming, forward = _dist_builders(head)
    with tempfile.TemporaryDirectory() as tmp:
        # -- run 1: the dir transport -------------------------------------
        clean = _dist_run(os.path.join(tmp, "clean"), plan, forward_builder=dense)
        check(clean["worker_exit_codes"] == {"w0": 0, "w1": 0} and clean["lost"] == [],
              f"dist clean: exit codes {clean['worker_exit_codes']}, lost {clean['lost']}")
        check(np.array_equal(clean["assembled"], expected),
              "dist clean: the workers' tile embeddings differ from the in-process encoder's")
        check(np.array_equal(clean["coords"], coords), "dist clean: coords differ")
        emb = clean["embedding"]
        check(emb.shape == (E + 2,) and np.isfinite(emb).all(), f"dist clean: bad result {emb.shape}")
        # the consumer's forward against the same forward in one process:
        # the same launches and the same bits
        reset_all_launch_counts()
        t0 = time.perf_counter()
        one = forward(head, clean["assembled"][None], clean["coords"][None])
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        one_launches = {k: v for k, v in all_launch_counts().items() if v}
        check(clean["launches"] == one_launches and all(one_launches.get(k, 0) > 0 for k in FWD_KERNELS),
              f"dist clean: consumer launches {clean['launches']} != one forward's {one_launches}")
        check(np.array_equal(one[0], emb), "dist clean: the consumer's result differs from one forward's")
        ref = run_inference_with_slide_encoder(clean["assembled"], clean["coords"], head.slide_encoder)
        vs_pipeline = _one_minus_cos(torch.from_numpy(emb[:E]), torch.from_numpy(ref["last_layer_embed"]))
        check(vs_pipeline <= BF16_MAX_ONE_MINUS_COS,
              f"dist clean: 1 - cos vs run_inference_with_slide_encoder {vs_pipeline}")
        _dist_line("dist_clean", clean, smi, transport="dir", one_process_forward_s=forward_s,
                   one_process_tile_encode_s=encode_s, one_minus_cos_vs_pipeline=vs_pipeline)

        # -- run 2: tcp, one worker killed mid-slide ----------------------
        killed = _dist_run(os.path.join(tmp, "killed"), dict(plan, transport="tcp"),
                           worker_chaos={"w1": DIST_KILL}, forward_builder=dense)
        check(killed["worker_exit_codes"] == {"w0": 0, "w1": -9},
              f"dist killed: exit codes {killed['worker_exit_codes']}")
        check(killed["lost"] == ["w1"] and killed["reassignments"] >= 1,
              f"dist killed: lost {killed['lost']}, reassignments {killed['reassignments']}")
        check(np.array_equal(killed["assembled"], clean["assembled"]), "dist killed: assembled rows differ")
        check(np.array_equal(killed["embedding"], emb), "dist killed: the embedding is not bit-equal")
        lost_events = [e for e in killed["events"] if e["kind"] == "worker_lost" and e.get("worker") == "w1"]
        reassign = [e for e in killed["events"] if e["kind"] == "recovery" and e.get("action") == "reassign"]
        check(lost_events and reassign and reassign[0]["worker"] == "w1",
              f"dist killed: worker_lost {lost_events}, reassign {reassign}")
        check(killed["launches"] == one_launches, f"dist killed: consumer launches {killed['launches']}")
        _dist_line("dist_killed", killed, smi, transport="tcp", chaos={"w1": DIST_KILL},
                   worker_lost=lost_events[0], reassign={k: reassign[0][k] for k in ("worker", "chunks", "survivors")},
                   bit_equal=True)

        # -- run 3: chunked prefill -----------------------------------------
        stream = _dist_run(os.path.join(tmp, "stream"), dict(plan, chunked_prefill=True),
                           streaming_builder=streaming)
        check(stream["streaming"] and stream["worker_exit_codes"] == {"w0": 0, "w1": 0},
              f"dist stream: {stream['streaming']}, exit codes {stream['worker_exit_codes']}")
        vs_dense = _one_minus_cos(torch.from_numpy(stream["embedding"]), torch.from_numpy(emb))
        check(vs_dense <= BF16_MAX_ONE_MINUS_COS, f"dist stream: 1 - cos vs the dense run {vs_dense}")
        reset_all_launch_counts()
        session = StreamingEncoderSession(head.slide_encoder, DIST_TILES, chunk_tiles=DIST_CHUNK,
                                          all_layer_embed=True)
        for cid, a, b in chunks:
            session.feed(cid, expected[a:b], coords[a:b])
        one_stream = _dist_out(head, session.finalize())
        stream_launches = {k: v for k, v in all_launch_counts().items() if v}
        check(stream["launches"] == stream_launches and stream_launches.get("stream_pair_fwd", 0) > 0,
              f"dist stream: consumer launches {stream['launches']} != one session's {stream_launches}")
        check(np.array_equal(one_stream, stream["embedding"]),
              "dist stream: the consumer's result differs from one session's")
        _dist_line("dist_stream", stream, smi, transport="dir", one_minus_cos_vs_dense=vs_dense,
                   logits=stream["embedding"][E:].tolist(), dense_logits=emb[E:].tolist())
    del head, session
    torch.cuda.empty_cache()
    emit("dist", seconds=time.perf_counter() - t_phase, runs_wall_s={
        "clean": clean["wall_s"], "killed": killed["wall_s"], "stream": stream["wall_s"]}, nvidia_smi=smi)


def _write_wsi(path: str, seed: int, px: int = WSI_PX) -> None:
    """A synthetic px x px RGB slide as PNG: a near-white background and
    tissue-like dark blobs (a blurred random field thresholded at its
    median: about half the area) stained with a texture that varies over
    ~8 px, as cells do."""
    import numpy as np
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(seed)
    field = Image.fromarray((rng.random((64, 64)) * 255).astype(np.uint8))
    field = np.asarray(field.filter(ImageFilter.GaussianBlur(2)).resize((px, px), Image.BILINEAR))
    tissue = field < np.median(field)
    texture = Image.fromarray(rng.integers(60, 196, (px // 8, px // 8, 3), dtype=np.uint8))
    stain = np.asarray(texture.resize((px, px), Image.BILINEAR)) // 2 + np.array([86, 16, 76], np.uint8)
    img = np.where(tissue[..., None], stain, np.uint8(241))
    Image.fromarray(img).save(path, format="PNG", compress_level=1)


@contextlib.contextmanager
def _timed_calls(module, name: str, seconds: list):
    """Time every call of ``module.name`` for the body (host clock; the
    calls end in host work or a device->host copy)."""
    real = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, real)


def _wsi_events(out_dir: str) -> list:
    import glob
    import os

    (path,) = [p for p in glob.glob(os.path.join(out_dir, "obs", "*.jsonl"))
               if not os.path.basename(p).startswith("flight-")]
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _wsi_ckpt(out_dir: str, step: int) -> dict:
    import os

    from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint

    return restore_checkpoint(os.path.join(out_dir, "ckpts", f"ckpt-{step:08d}", "state.pt"))


def _tree_diffs(a, b, prefix: str = "") -> dict:
    """Leaf path -> max |a - b| (or a description) where two checkpoint
    trees are not bit-equal; empty when they are."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return {prefix or ".": f"keys {sorted(map(str, set(a) ^ set(b)))}"}
        out = {}
        for key in a:
            out.update(_tree_diffs(a[key], b[key], f"{prefix}.{key}" if prefix else str(key)))
        return out
    if isinstance(a, torch.Tensor):
        if a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b):
            return {}
        if a.shape != b.shape or not a.is_floating_point():
            return {prefix: "differs"}
        return {prefix: float((a.double() - b.double()).abs().max())}
    return {} if a == b else {prefix: f"{a!r} != {b!r}"}


def _wsi_grads_vs_plain(feature_dir: str, n_classes: int) -> dict:
    """One step of train_gigapath's (bf16 autocast, cross-entropy, no pad
    mask) on the first slide's cached features, through the kernels and
    again through their plain versions, from the head's seed-0 weights with
    dropout off: rows 1-3 and 7a/7b at the slide's own length, every
    gradient (the frozen encoder's too) held to GRAD_BF16_MAX_ONE_MINUS_COS."""
    import os

    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch import train_gigapath
    from gigapath_tpu_torch.models.classification_head import get_model
    from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint

    cached = restore_checkpoint(os.path.join(feature_dir, "wsi_0" + train_gigapath.FEATURES_SUFFIX))
    x = cached["features"].float()[None].cuda()
    c = cached["coords"].float()[None].cuda()
    y = torch.tensor([1], device="cuda")
    model = get_model(input_dim=TILE_E, latent_dim=E, feat_layer=WSI_TRAIN["feat_layer"], n_classes=n_classes,
                      model_arch=WSI_TRAIN["model_arch"], freeze=True, seed=0, dropout=0.0, drop_path_rate=0.0)
    model.train()
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with plain_kernels() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                logits = model(x, c)
            loss = F.cross_entropy(logits.float(), y)
            loss.backward()
            torch.cuda.synchronize()
            runs.append((float(loss.detach()), _grads(model), time.perf_counter() - t0))
    (loss_k, g_k, s_k), (loss_p, g_p, s_p) = runs
    name, err, tol = _worst_grad_err(g_k, g_p, True, "train_wsi step")
    n_params = len(g_p)
    del model, runs, g_k, g_p
    torch.cuda.empty_cache()
    return {"tiles": int(x.shape[1]), "n_params": n_params, "param": name, "one_minus_cos": err,
            "tolerance": tol, "loss_kernels": loss_k, "loss_plain": loss_p,
            "ms_kernels": s_k * 1e3, "ms_plain": s_p * 1e3}


def phase_train_wsi():
    """The whole-slide training entry (14d) at full width: train_gigapath.main
    from two synthetic PNG slides through tiling, the int8+attn tile encoder
    (its tier from a blessed plan) and 6 steps of the flagship head; then the
    non-finite guard (a skipped NaN step, a rollback) and a bit-exact resume
    on the same cached features."""
    import glob
    import math
    import os

    import numpy as np
    import torch

    from gigapath_tpu_torch import pipeline, train_gigapath
    from gigapath_tpu_torch.models.classification_head import get_model
    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder
    from gigapath_tpu_torch.plan import ExecutionPlan, bless_plan, geometry_key, reset_plan_state
    from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, out = os.path.join(tmp, "slides"), os.path.join(tmp, "run")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(WSI_SLIDES) as pool:  # numpy and PNG deflate drop the GIL
            list(pool.map(lambda i: _write_wsi(os.path.join(
                data_dir, f"wsi_{i}.png" + ("?download=1" if i == 0 else "")), seed=40 + i), range(WSI_SLIDES)))
        write_s = time.perf_counter() - t0

        # the tile encoder from the factory with no tier: the blessed plan
        # picks it (GIGAPATH_QUANT_TILE empty counts as unset)
        registry = os.path.join(tmp, "PLAN_REGISTRY.json")
        key = geometry_key("tile_encoder.gigapath_tile_enc", (torch.empty((1, 224, 224, 3), device="meta"),))
        bless_plan(key, ExecutionPlan(quant_tile=WSI_TIER).as_dict(), path=registry)
        with env_flags({"GIGAPATH_PLAN_REGISTRY": registry, "GIGAPATH_QUANT_TILE": "", "GIGAPATH_PLAN": "on"}):
            reset_plan_state()
            t0 = time.perf_counter()
            encoder = create_tile_encoder("", "gigapath_tile_enc", dtype=torch.bfloat16,
                                          generator=torch.Generator(device="cuda").manual_seed(0))
            build_s = time.perf_counter() - t0
        reset_plan_state()
        check(encoder.quant == WSI_TIER, f"train_wsi: the plan seam picked tier {encoder.quant!r}")
        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():  # LayerScales at O(0.1-1), as _tile_encoder draws them
            for block in encoder.blocks:
                for ls in (block.ls1, block.ls2):
                    ls.gamma.uniform_(0.1, 1.0, generator=gen)

        # -- the entry: rename -> tile -> extract -> labels -> train -------
        tile_s, encode_s = [], []
        torch.cuda.synchronize()
        _reset_peak()
        with _timed_calls(pipeline, "tile_one_slide", tile_s), \
                _timed_calls(pipeline, "run_inference_with_tile_encoder", encode_s):
            reset_all_launch_counts()
            t0 = time.perf_counter()
            result = train_gigapath.main(data_dir, out, tile_encoder=encoder, num_classes=2,
                                         num_epochs=WSI_EPOCHS, **WSI_TRAIN)
            main_s = time.perf_counter() - t0
            counts = all_launch_counts()
        peak_gb = _peak() / 2**30
        check(sorted(os.listdir(data_dir)) == [f"wsi_{i}.png" for i in range(WSI_SLIDES)],
              f"train_wsi: rename left {sorted(os.listdir(data_dir))}")

        feature_dir = os.path.join(out, "features")
        kept, batches, n_total = {}, 0, 0
        for i in range(WSI_SLIDES):
            slide = f"wsi_{i}"
            tiles = sorted(glob.glob(os.path.join(feature_dir, "tiles", "output", slide + ".png", "*.png")))
            feats = restore_checkpoint(os.path.join(feature_dir, slide + train_gigapath.FEATURES_SUFFIX))
            n = len(tiles)
            check(0 < n <= (WSI_PX // WSI_TILE) ** 2, f"train_wsi: {n} tiles kept for {slide}")
            check(tuple(feats["features"].shape) == (n, TILE_E) and bool(torch.isfinite(feats["features"]).all()),
                  f"train_wsi: {slide} features {tuple(feats['features'].shape)}")
            ref = pipeline.run_inference_with_tile_encoder(tiles, encoder)
            check(np.array_equal(ref["tile_embeds"], feats["features"].numpy())
                  and np.array_equal(ref["coords"], feats["coords"].numpy()),
                  f"train_wsi: {slide}'s cached features differ from run_inference_with_tile_encoder's")
            kept[slide], batches, n_total = n, batches + math.ceil(n / 128), n_total + n
        want = dict.fromkeys(counts, 0)
        want.update({name: WSI_EPOCHS * WSI_SLIDES * STEP_LAUNCHES[name] for name in FWD_KERNELS + BWD_KERNELS})
        want["q_matmul"], want["q_flash_attention"] = (batches * k for k in TILE_LAUNCHES[WSI_TIER])
        check(counts == want, f"train_wsi: launches {counts} != {want}")
        emit("train_wsi_tiles", slides=WSI_SLIDES, slide_px=WSI_PX, tile_px=WSI_TILE, tiles_kept=kept,
             tiling_s=tile_s, encode_s=encode_s, write_slides_s=write_s, tile_encoder_build_s=build_s,
             tier=encoder.quant, features_bit_equal_to_entry=True, feature_shape=[n_total, TILE_E],
             tiles_per_s_encode=n_total / sum(encode_s),
             tiles_per_s_entry=n_total / (sum(tile_s) + sum(encode_s)),
             tile_stage_launches={"q_matmul": counts["q_matmul"], "q_flash_attention": counts["q_flash_attention"],
                                  "batches": batches}, nvidia_smi=smi)
        del encoder
        torch.cuda.empty_cache()

        events = _wsi_events(os.path.join(out, "model"))
        steps = [e for e in events if e["kind"] == "step"]
        losses = [e["loss"] for e in steps]
        check(len(steps) == WSI_EPOCHS * WSI_SLIDES and all(math.isfinite(v) for v in losses)
              and all(math.isfinite(v) for v in result["loss_history"]), f"train_wsi: losses {losses}")
        final = restore_checkpoint(os.path.join(out, "model", "model.pt"))["params"]
        initial = get_model(input_dim=TILE_E, latent_dim=E, feat_layer="11", n_classes=result["n_classes"],
                            seed=0).state_dict()
        frozen_equal = all(torch.equal(final[k], v.cpu()) for k, v in initial.items() if k.startswith("slide_encoder."))
        check(frozen_equal, "train_wsi: the frozen encoder moved")
        check(not torch.equal(final["classifier.weight"], initial["classifier.weight"].cpu()),
              "train_wsi: the classifier did not move")
        del initial
        grad_check = _wsi_grads_vs_plain(feature_dir, result["n_classes"])
        walls = [e["wall_s"] for e in steps]
        emit("train_wsi_train", steps=len(steps), epochs=WSI_EPOCHS, n_classes=result["n_classes"],
             losses=losses, loss_history=result["loss_history"], step_ms=[w * 1e3 for w in walls],
             median_step_ms=statistics.median(walls) * 1e3,
             launches_per_step={k: counts[k] // (WSI_EPOCHS * WSI_SLIDES) for k in FWD_KERNELS + BWD_KERNELS},
             frozen_encoder_bit_equal=frozen_equal, peak_mem_gb=peak_gb, entry_s=main_s,
             grads_vs_plain=grad_check,
             checkpoints=sorted(os.listdir(os.path.join(out, "model", "ckpts"))), nvidia_smi=smi)

        # -- the non-finite guard on the same cached features ---------------
        labels = os.path.join(out, "labels.csv")
        kw = dict(WSI_TRAIN, keep_checkpoints=10)
        guard_out, rollback_out, split_out = (os.path.join(tmp, name) for name in ("guard", "rollback", "split"))
        with env_flags({"GIGAPATH_CHAOS": "nan_loss@2"}):
            guarded = train_gigapath.train_model(feature_dir, labels, guard_out, num_epochs=2, **kw)
        before, after = _wsi_ckpt(guard_out, 2), _wsi_ckpt(guard_out, 3)
        skip_diffs = {**_tree_diffs(after["params"], before["params"], "params"),
                      **_tree_diffs(after["opt_state"], before["opt_state"], "opt_state")}
        check(not skip_diffs, f"train_wsi: the skipped step changed {skip_diffs}")
        del before, after
        recovery = [(e["action"], e["step"]) for e in _wsi_events(guard_out) if e["kind"] == "recovery"]
        check(recovery == [("skip_step", 2)], f"train_wsi: guard recovery events {recovery}")
        with env_flags({"GIGAPATH_CHAOS": "nan_loss@2,nan_loss@3", "GIGAPATH_GUARD_ROLLBACK_AFTER": "2"}):
            train_gigapath.train_model(feature_dir, labels, rollback_out, num_epochs=2, **kw)
        rolled = [(e["action"], e["step"], e.get("to_step"))
                  for e in _wsi_events(rollback_out) if e["kind"] == "recovery"]
        check(rolled == [("skip_step", 2, None), ("skip_step", 3, None), ("rollback", 3, 3)],
              f"train_wsi: rollback recovery events {rolled}")
        emit("train_wsi_guard", chaos="nan_loss@2", skipped_step=2, state_bit_equal=True,
             loss_history=guarded["loss_history"], recovery=recovery,
             rollback={"chaos": "nan_loss@2,nan_loss@3", "rollback_after": 2, "recovery": rolled})

        # -- resume: 2 epochs, then to 3, against the uninterrupted run -----
        train_gigapath.train_model(feature_dir, labels, split_out, num_epochs=2, **WSI_TRAIN)
        resumed = train_gigapath.train_model(feature_dir, labels, split_out, num_epochs=WSI_EPOCHS,
                                             resume="auto", **WSI_TRAIN)
        last = WSI_EPOCHS * WSI_SLIDES
        resume_diffs = _tree_diffs(_wsi_ckpt(split_out, last), _wsi_ckpt(os.path.join(out, "model"), last))
        check(not resume_diffs, f"train_wsi: the resumed run differs from the uninterrupted one: {resume_diffs}")
        check(resumed["loss_history"][-1] == result["loss_history"][-1],
              f"train_wsi: resumed last-epoch loss {resumed['loss_history'][-1]} != {result['loss_history'][-1]}")
        emit("train_wsi_resume", resumed_from_step=(WSI_EPOCHS - 1) * WSI_SLIDES, final_step=last,
             bit_equal=True, compared=["params", "opt_state", "rng", "step"])
    torch.cuda.empty_cache()
    emit("train_wsi", seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _harness_parity(tile_timing: dict, smi: str) -> None:
    """parity_report on the committed fixture through rows 17 and 18, each
    variant against its plain path, and the adopt_quant_tile row with the
    card's forward ms of a 128-tile batch."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.quant import parity

    t0 = time.perf_counter()
    params, images, labels = parity.load_fixture()
    reset_all_launch_counts()
    report = parity.parity_report(params, images, labels, variants=HARNESS_VARIANTS)
    counts = all_launch_counts()
    report_s = time.perf_counter() - t0
    want = dict.fromkeys(counts, 0)
    want.update(HARNESS_PARITY_LAUNCHES)
    check(counts == want, f"harness_parity: launches {counts} != {want}")

    vs_plain = {}
    for name in HARNESS_VARIANTS:
        model = parity.build_variant(parity.FIXTURE_ARCH, quant="" if name == "bf16" else name)
        emb = parity.encode(model, params, images)
        with plain_tile_kernels():
            ref = parity.encode(model, None, images)
        worst = float((1.0 - _cosines(emb, ref)).max())
        check(np.isfinite(emb).all() and worst <= TILE_MAX_ONE_MINUS_COS,
              f"harness_parity: {name} 1 - cosine vs plain {worst} > {TILE_MAX_ONE_MINUS_COS}")
        vs_plain[name] = {"max_one_minus_cos": worst, "max_abs_err": float(np.abs(emb - ref).max())}
    for name in HARNESS_VARIANTS[1:]:
        cosine = report["variants"][name]["cosine"]
        check(cosine >= parity.COSINE_BAR, f"harness_parity: {name} cosine vs the fp32 oracle {cosine} "
                                           f"< {parity.COSINE_BAR}")
    timings = {"bf16": tile_timing["bf16"]["forward_ms_per_batch"] / 1e3,
               "int8+attn": tile_timing["int8+attn"]["forward_ms_per_batch"] / 1e3}
    decision = parity.decision_table(report, timings, candidate="int8+attn")
    emit("harness_parity", fixture=os.path.relpath(parity.DEFAULT_FIXTURE, os.path.dirname(os.path.abspath(__file__))), arch=parity.FIXTURE_ARCH,
         images=int(images.shape[0]), report=report, launches=counts, vs_plain=vs_plain,
         tolerance=f"1 - cosine per image <= {TILE_MAX_ONE_MINUS_COS} vs plain; cosine vs the fp32 oracle "
                   f">= {parity.COSINE_BAR} (gated); probe deltas against {parity.PROBE_DELTA_BAR_PT} pt "
                   "printed, not gated",
         adopt_quant_tile=decision,
         timings_note=f"forward ms of one {TILE_BATCH}-tile batch of the flagship tile encoder from "
                      "tile_forward in this run", report_s=report_s, nvidia_smi=smi)
    torch.cuda.empty_cache()


def _write_stain_tile(path: str, stain: str, seed: int) -> None:
    """A 224 px tile of one stain: the stain's colour shifted per tile, a
    texture varying over ~8 px, pixel noise."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = np.asarray(HARNESS_STAINS[stain], np.float64) + rng.normal(0, 12, 3)
    texture = Image.fromarray(rng.integers(0, 256, (28, 28), dtype=np.uint8)).resize((224, 224), Image.BILINEAR)
    arr = base + (np.asarray(texture, np.float64)[..., None] - 128.0) * 0.4 + rng.normal(0, 6, (224, 224, 3))
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path, compress_level=1)


def _harness_probe(tmp: str, smi: str) -> None:
    """The PCam linear probe at full width: int8+attn embeddings of 4096
    synthetic tiles, a PCam-shaped zip, linear_probe.main on the card and
    the same training on the CPU."""
    import io
    import zipfile

    import numpy as np
    import torch

    from gigapath_tpu_torch.data.pcam import EmbeddingDataset
    from gigapath_tpu_torch.linear_probe import main as probe
    from gigapath_tpu_torch.pipeline import run_inference_with_tile_encoder
    from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    tile_dir = os.path.join(tmp, "probe_tiles")
    os.makedirs(tile_dir)
    stains = sorted(HARNESS_STAINS)
    paths = [os.path.join(tile_dir, f"{224 * (i % 64):05d}x_{224 * (i // 64):05d}y.png")
             for i in range(HARNESS_PROBE_TILES)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # PNG deflate drops the GIL
        list(pool.map(lambda i: _write_stain_tile(paths[i], stains[i % 2], 1000 + i), range(len(paths))))
    write_s = time.perf_counter() - t0

    encoder = _tile_encoder("int8+attn")
    torch.cuda.synchronize()
    _reset_peak()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    embeds = run_inference_with_tile_encoder(paths, encoder)["tile_embeds"]
    encode_s = time.perf_counter() - t0
    counts = all_launch_counts()
    encode_peak_gb = _peak() / 2**30
    batches = math.ceil(HARNESS_PROBE_TILES / TILE_BATCH)
    want = dict.fromkeys(counts, 0)
    want["q_matmul"], want["q_flash_attention"] = (batches * k for k in TILE_LAUNCHES["int8+attn"])
    check(counts == want, f"harness_probe: encode launches {counts} != {want}")
    check(embeds.shape == (HARNESS_PROBE_TILES, TILE_E) and np.isfinite(embeds).all(),
          f"harness_probe: embeddings {embeds.shape}")
    del encoder
    torch.cuda.empty_cache()

    zpath, csv = os.path.join(tmp, "pcam_embeds.zip"), os.path.join(tmp, "pcam.csv")
    rows, start = ["input,label,split"], 0
    with zipfile.ZipFile(zpath, "w") as z:
        for split, n in HARNESS_PROBE_SPLITS:
            for i in range(start, start + n):
                buf = io.BytesIO()
                torch.save(torch.from_numpy(embeds[i].copy()), buf)
                z.writestr(f"embeds/{split}_{i}.pt", buf.getvalue())
                rows.append(f"{split}_{i},{stains[i % 2]},{split}")
            start += n
    with open(csv, "w") as fh:
        fh.write("\n".join(rows) + "\n")

    out = os.path.join(tmp, "probe_card")
    argv = ["--dataset_csv", csv, "--input_path", zpath, "--embed_dim", str(TILE_E), "--report_to", "jsonl",
            *HARNESS_PROBE_ARGS]
    t0 = time.perf_counter()
    result = probe.main(argv + ["--output_dir", out])
    main_s = time.perf_counter() - t0
    events = _wsi_events(out)
    evals = [e for e in events if e["kind"] == "eval"]
    ends = [e for e in events if e["kind"] == "run_end"]
    check(os.path.exists(os.path.join(out, "results.txt")), "harness_probe: no results.txt")
    check(len(evals) == 2 and [e["status"] for e in ends] == ["ok"],
          f"harness_probe: {len(evals)} eval events, run_end {[e.get('status') for e in ends]}")
    check(result["test_auroc"] >= HARNESS_PROBE_AUROC,
          f"harness_probe: test AUROC {result['test_auroc']} < {HARNESS_PROBE_AUROC}")
    walls = [e["wall_s"] for e in events if e["kind"] == "step"]  # each spans 10 iterations

    # the same training on the CPU from the same initial parameters
    args = probe.build_argparser().parse_args(argv + ["--output_dir", os.path.join(tmp, "probe_cpu")])
    datasets = [EmbeddingDataset(csv, zpath, split=split) for split, _ in HARNESS_PROBE_SPLITS]
    t0 = time.perf_counter()
    probe.train(probe.init_linear_probe(TILE_E, len(stains), args.seed), *datasets,
                **{**vars(args), "device": "cpu"})
    cpu_s = time.perf_counter() - t0
    card = restore_checkpoint(os.path.join(out, "model.pt"))
    cpu = restore_checkpoint(os.path.join(args.output_dir, "model.pt"))
    rel = {k: float((card[k].double() - cpu[k].double()).norm() / cpu[k].double().norm()) for k in cpu}
    check(max(rel.values()) <= HARNESS_PROBE_RTOL, f"harness_probe: final parameters vs the CPU run {rel}")
    emit("harness_probe", tiles=HARNESS_PROBE_TILES, splits=dict(HARNESS_PROBE_SPLITS), tier="int8+attn",
         encode_launches=counts, encode_s=encode_s, encode_tiles_per_s=HARNESS_PROBE_TILES / encode_s,
         encode_peak_mem_gb=encode_peak_gb, write_tiles_s=write_s, args=HARNESS_PROBE_ARGS,
         reduced="train_iters 12500 -> 1000 for the phase's time",
         results=result, val_evals=[{k: e[k] for k in ("step", "f1", "auroc")} for e in evals],
         ms_per_iteration=statistics.median(walls) / 10 * 1e3,
         ms_per_iteration_note="the run log's 10-iteration walls (host batch assembly included) / 10, median",
         main_s=main_s, cpu_train_s=cpu_s, vs_cpu_rel=rel, tolerance=f"||card - CPU|| / ||CPU|| <= "
         f"{HARNESS_PROBE_RTOL} per final parameter; test AUROC >= {HARNESS_PROBE_AUROC}",
         seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


def _mae_step_vs_cpu(tile_paths) -> dict:
    """One stage-1 update (pretrain_gigapath.mae_step) of a MAE_STEP_DEPTH
    block, full-width tile encoder with its MAE decoder, fp32 on the card
    and on the CPU from the same weights, tiles and mask noise."""
    import copy

    import torch

    from gigapath_tpu_torch.models.tile_encoder import create_tile_encoder
    from gigapath_tpu_torch.pretrain import pretrain_gigapath as ppt

    encoder = create_tile_encoder("", "gigapath_tile_enc", quant="", depth=MAE_STEP_DEPTH,
                                  generator=torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():  # LayerScales at O(0.1-1), so both blocks matter
        for block in encoder.blocks:
            for ls in (block.ls1, block.ls2):
                ls.gamma.uniform_(0.1, 1.0, generator=gen)
    with torch.device("cuda"):
        mae = ppt.MaskedAutoencoder(encoder)
    mae.init_decoder(gen)
    mae.train()
    twin = copy.deepcopy(mae).cpu()
    imgs = torch.from_numpy(ppt._load_tile_batch(tile_paths[:MAE_STEP_TILES], encoder.img_size))
    noise = ppt.masking_noise(gen, MAE_STEP_TILES, encoder.img_size**2, "cuda")
    runs = {}
    for name, model, dev in (("card", mae, "cuda"), ("cpu", twin, "cpu")):
        optimizer = ppt.make_adamw(model.parameters(), MAE_STEP_LR)
        t0 = time.perf_counter()
        loss = float(ppt.mae_step(model, optimizer, imgs.to(dev), noise.to(dev), MAE_STEP_LR))
        seconds = time.perf_counter() - t0
        runs[name] = (loss, {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                      {n: p.detach().cpu().double() for n, p in model.named_parameters()}, seconds)
    (loss_k, g_k, p_k, s_k), (loss_c, g_c, p_c, s_c) = runs["card"], runs["cpu"]
    grad_rel = {n: float((g_k[n] - g).norm() / g.norm()) for n, g in g_c.items() if float(g.norm()) > 0}
    # an element whose two gradients differ in sign lies within the fp32
    # noise of its sum around 0, and one AdamW step moves it by +-lr on
    # each side: those are counted, every other element is held to the
    # tolerance
    flips, beyond, worst, n_elems = 0, 0, 0.0, 0
    for n, p in p_c.items():
        diff = (p_k[n] - p).abs()
        flip = torch.sign(g_k[n]) != torch.sign(g_c[n])
        bad = (diff > MAE_STEP_TOL * (1.0 + p.abs())) & ~flip
        flips += int(flip.sum())
        beyond += int(bad.sum())
        n_elems += p.numel()
        worst = max(worst, float(diff[~flip].max()) if bool((~flip).any()) else 0.0)
    out = {"depth": MAE_STEP_DEPTH, "tiles": MAE_STEP_TILES, "lr": MAE_STEP_LR, "params": n_elems,
           "loss_card": loss_k, "loss_cpu": loss_c, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
           "worst_grad_rel": max(grad_rel.values()), "worst_grad": max(grad_rel, key=grad_rel.get),
           "param_max_abs_err": worst, "params_beyond_tol": beyond, "gradient_sign_flips": flips,
           "card_s": s_k, "cpu_s": s_c,
           "tolerance": f"loss and each gradient (norm) relative {MAE_STEP_TOL}; each parameter after the "
                        f"update |card - cpu| <= {MAE_STEP_TOL} * (1 + |p|) where the gradients agree in sign"}
    check(out["loss_rel"] <= MAE_STEP_TOL and out["worst_grad_rel"] <= MAE_STEP_TOL and beyond == 0,
          f"harness_pretrain: the MAE step on the card differs from the CPU's: {out}")
    return out


def _harness_pretrain(tmp: str, smi: str) -> None:
    """pretrain_gigapath.main at full width on two synthetic slides, the
    best encoder's restore, and the 2-block MAE step against the CPU."""
    import glob

    import numpy as np
    import torch

    from gigapath_tpu_torch.pretrain import pretrain_gigapath as ppt

    t_phase = time.perf_counter()
    free_gb = shutil.disk_usage(tmp).free / 2**30
    slides = [os.path.join(tmp, f"pre_{i}.png") for i in range(2)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda i: _write_wsi(slides[i], seed=60 + i, px=HARNESS_WSI_PX), range(2)))
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "pretrain")
    encoder = ppt._default_encoder(torch.device("cuda"), 0)
    tile_dirs = [os.path.join(out, "output", os.path.basename(p)) for p in slides]

    # time every checkpoint write; at each best stage-1 write, the live
    # encoder's features on one fixed batch (the restore is checked
    # against the last of them)
    saves, live, fixed = [], {}, {}
    real_save = ppt.save_checkpoint

    def save(path, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(path, state)
        saves.append({"file": os.path.basename(path), "s": time.perf_counter() - t0,
                      "bytes": os.path.getsize(path)})
        if os.path.basename(path) == "best_tile_encoder.pt":
            if "x" not in fixed:
                first = sorted(glob.glob(os.path.join(tile_dirs[0], "*.png")))[:HARNESS_PRETRAIN["batch_size"]]
                fixed["x"] = torch.from_numpy(ppt._load_tile_batch(first, encoder.img_size)).cuda()
            with torch.inference_mode():
                live["features"] = encoder(fixed["x"]).float().cpu()

    tile_s = []
    torch.cuda.synchronize()
    _reset_peak()
    reset_all_launch_counts()
    ppt.save_checkpoint = save
    try:
        from gigapath_tpu_torch import pipeline

        with _timed_calls(pipeline, "tile_one_slide", tile_s):
            t0 = time.perf_counter()
            best_tile, best_slide = ppt.main(slides, out, encoder=encoder, tile_size=WSI_TILE, **HARNESS_PRETRAIN)
            main_s = time.perf_counter() - t0
    finally:
        ppt.save_checkpoint = real_save
    counts = all_launch_counts()
    peak_gb = _peak() / 2**30

    tiles = {os.path.basename(d): len(glob.glob(os.path.join(d, "*.png"))) for d in tile_dirs}
    stage1 = [e for e in _wsi_events(os.path.join(out, "tile_pretrain")) if e["kind"] == "step"]
    stage2 = [e for e in _wsi_events(os.path.join(out, "slide_pretrain")) if e["kind"] == "step"]
    n_tiles = sum(tiles.values())
    steps_per_epoch = max(n_tiles // HARNESS_PRETRAIN["batch_size"], 1)
    check(len(stage1) == HARNESS_PRETRAIN["tile_epochs"] * steps_per_epoch
          and all(math.isfinite(e["loss"]) for e in stage1), f"harness_pretrain: stage-1 steps {stage1[:3]}...")
    check(len(stage2) == HARNESS_PRETRAIN["slide_epochs"] and all(math.isfinite(e["loss"]) for e in stage2),
          f"harness_pretrain: stage-2 losses {[e['loss'] for e in stage2]}")
    with torch.inference_mode():
        restored = encoder(fixed["x"]).float().cpu()
    check(torch.equal(restored, live["features"]),
          "harness_pretrain: the restored best encoder's features differ from the live encoder's at its save")
    best = torch.load(best_tile, map_location="cpu", weights_only=True)
    best_epoch, best_loss = best["epoch"], best["loss"]
    del best
    slide_best = torch.load(best_slide, map_location="cpu", weights_only=True)["loss"]
    del encoder
    torch.cuda.empty_cache()

    paths = sorted(glob.glob(os.path.join(tile_dirs[0], "*.png")))
    mae_check = _mae_step_vs_cpu(paths)
    walls = [e["wall_s"] for e in stage1]
    emit("harness_pretrain", slides=len(slides), slide_px=HARNESS_WSI_PX, tile_px=WSI_TILE, tiles=tiles,
         arch="gigapath_tile_enc", compute="bf16, fp32 master weights", **HARNESS_PRETRAIN,
         reduced="batch 64 -> 16 (ViT-G's saved activations and AdamW state), epochs 100/50 -> 2/5, "
                 "two 4096 px slides",
         stage1_steps=len(stage1), stage1_losses=[e["loss"] for e in stage1],
         mae_step_ms_median=statistics.median(walls) * 1e3, mae_step_ms_first=walls[0] * 1e3,
         tiles_per_s=HARNESS_PRETRAIN["batch_size"] / statistics.median(walls), peak_mem_gb=peak_gb,
         checkpoints=saves, best_tile={"epoch": best_epoch, "loss": best_loss},
         stage2_loss_per_epoch=[e["loss"] for e in stage2], best_slide_loss=slide_best,
         restored_features_bit_equal=True, launches=counts, mae_step_vs_cpu=mae_check,
         tiling_s=tile_s, write_slides_s=write_s, main_s=main_s, disk_free_gb_at_start=free_gb,
         seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


def phase_harness(tile_timing: dict) -> None:
    """The harness entries (14e): the quantized tier's parity harness, the
    PCam linear probe and the two-stage pretraining driver; the temporary
    directory (the ~5 GB stage-1 checkpoints among it) goes at the end."""
    import torch

    t_phase = time.perf_counter()
    smi = _smi()
    _harness_parity(tile_timing, smi)
    with tempfile.TemporaryDirectory() as tmp:
        _harness_probe(tmp, smi)
        _harness_pretrain(tmp, smi)
    torch.cuda.empty_cache()
    emit("harness", seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


def _serve_memory_released(reserved_start: int) -> None:
    """The serve phase's end: its services closed and its models deleted,
    the reserved memory is back within SERVE_MEMORY_SLACK of the phase's
    start with no garbage collection run, and ``torch.profiler`` records
    device activity (a device kept nearly full leaves it none)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_end = torch.cuda.memory_reserved()
    free, total = torch.cuda.mem_get_info()
    a = torch.ones(4096, 4096, device="cuda")
    busy = _profile(lambda: a @ a).get("device_busy_ms")
    del a
    emit("serve_memory", reserved_at_start=reserved_start, reserved_at_end=reserved_end,
         grown_bytes=reserved_end - reserved_start, slack_bytes=SERVE_MEMORY_SLACK,
         device_free_bytes=free, device_total_bytes=total, profiler_device_busy_ms=busy)
    check(reserved_end - reserved_start <= SERVE_MEMORY_SLACK,
          f"serve: {reserved_end - reserved_start} B more reserved at the phase's end than at its start")
    check(busy is not None, "serve: after the phase the profiler recorded no device activity")


def _serve_replay_times(model) -> dict:
    """One 10240-tile bf16 slide on a ladder whose lowest rung is 10240 with
    capacity 1, so the graph holds the default forward at L = 10241 (all
    layers' embeddings): in turns, the graph replay alone (host clock to a
    synchronize); the same masked forward eager under ``inference_mode``,
    once under ``per_row_valid_len`` as the graph runs it (no host sync) and
    once as a caller gets it (equal counts: the int arm, two syncs a layer);
    the unmasked pipeline entry as ``default_route_times`` times it; and the
    service's whole dispatch (batch assembly, the input copy, the replay,
    the copy to the host); then the device busy time and idle share of each
    by ``torch.profiler``, and the capture's seconds. The replay's ratios
    are taken against the two eager arms that make no host sync."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.ops.dilated_attention import per_row_valid_len
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder
    from gigapath_tpu_torch.serve import ServeConfig, SlideService
    from gigapath_tpu_torch.serve.buckets import assemble_batch
    from gigapath_tpu_torch.serve.service import _tree_np

    def forward(m, embeds, coords, pad_mask):
        return m(embeds.to(torch.bfloat16), coords, all_layer_embed=True, pad_mask=pad_mask)

    ((name, f, c),) = _serve_slides((N_TILES,), seed=21)
    config = ServeConfig(max_batch=1, max_wait_s=float("inf"), bucket_min=N_TILES, artifact_dir=None)
    service = SlideService(forward, model, config=config, identity="replay")
    fut = service.submit(name, f, c)
    service.drain()
    first = fut.result()
    key = (1, N_TILES)
    check(service.aot.sources == {key: "captured"}, f"replay: sources {service.aot.sources}")
    graph, aot = service.aot.graphs[key], service.aot
    inputs = assemble_batch([(f, c)], N_TILES, 1, feature_dim=1536)
    static = [torch.from_numpy(a).cuda() for a in inputs]
    x, coords = static[0][0], static[1][0]

    def replay():
        graph.replay()

    def eager_per_row():
        with torch.inference_mode(), per_row_valid_len():
            forward(model, *static)

    def eager_masked():
        with torch.inference_mode():
            forward(model, *static)

    def entry():
        run_inference_with_slide_encoder(x, coords, model)

    parts = {"assemble": [], "copy_and_replay": [], "to_host": []}

    def dispatch():
        t0 = time.perf_counter()
        batch = assemble_batch([(f, c)], N_TILES, 1, feature_dim=1536)
        t1 = time.perf_counter()
        out = aot(*batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = _tree_np(out)
        for k, dt in zip(parts, (t1 - t0, t2 - t1, time.perf_counter() - t2)):
            parts[k].append(dt)
        return host

    out = dispatch()
    for a, b in zip(out, first):
        check(np.array_equal(a[0], b), "replay: a second dispatch differs from the first")
    clocks = {"replay": replay, "eager_per_row": eager_per_row, "eager_masked_int_arm": eager_masked,
              "eager_entry": entry, "dispatch": dispatch}
    secs = {k: [] for k in clocks}
    for fn in clocks.values():
        fn()
    torch.cuda.synchronize()
    for k in parts:
        parts[k].clear()
    for _ in range(SERVE_REPS):
        for k, fn in clocks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
    profiles = {}
    for k, fn in clocks.items():
        with torch.inference_mode():
            profiles[k] = _profile(fn)
        profiles[k].pop("top_device_ms", None)
    host = {k: statistics.median(v) * 1e3 for k, v in secs.items()}
    result = {"tiles": N_TILES, "L": N_TILES + 1, "dtype": "bfloat16",
              "host_ms": host, "runs_ms": {k: [x_ * 1e3 for x_ in v] for k, v in secs.items()},
              "dispatch_parts_ms": {k: statistics.median(v[:SERVE_REPS]) * 1e3 for k, v in parts.items()},
              "profile": profiles, "capture_s": aot.compile_seconds[key], "pool_bytes": aot.pool_bytes[key],
              "capture_launches": aot.capture_launches[key],
              "replay_host_over_busy": host["replay"] / profiles["replay"].get("device_busy_ms", float("nan")),
              "replay_over_eager_per_row": host["replay"] / host["eager_per_row"],
              "replay_over_eager_entry": host["replay"] / host["eager_entry"]}
    service.close()
    return result


# ---------------------------------------------------------------------------
# the stream-fusion route: direct pack/unpack and the fusion epilogue
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def env_flags(values: dict):
    """Set environment variables for the body, then restore them."""
    import os

    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _device_busy_ms(fn) -> float:
    """Device busy time (ms) of one ``fn()`` under ``torch.profiler``."""
    fn()
    busy = _profile(fn).get("device_busy_ms")
    check(busy is not None, "the profiler recorded no device activity")
    return busy


def _fusion_bounds(B, L, plan, dtype):
    """Least card time (ms) of each new kernel's work in one flagship layer
    (:func:`_declared_bound` on tensors of the layer's shapes; they do a
    few operations per element, so bytes bound them): the direct pack's
    three tensors and one unpack in each clamped branch, the epilogue
    forward and its backward over the five branches. The wrappers are this
    tree's, whatever tree's kernels are timed."""
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    def meta(*shape, dtype=dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    outs = [meta(B, S, r, H // r, Mp, E // H) for g, S, r, m, Mp in plan.branches]
    lses = [meta(B, S, r, H // r, Mp, dtype=torch.float32) for g, S, r, m, Mp in plan.branches]
    dy = meta(B, L, E)
    ms = {"pack_phases_direct": 0.0, "unpack_phases_direct": 0.0,
          "fusion_epilogue_fwd": _declared_bound(dk.fusion_epilogue_fwd, name, outs, lses, plan)[0][0],
          "fusion_epilogue_bwd": _declared_bound(dk.fusion_epilogue_bwd, name, dy, meta(B, L, H, dtype=torch.float32),
                                                 lses, plan)[0][0]}
    for (g, S, r, m, Mp), out6 in zip(plan.branches, outs):
        if S == 1 and r > 1:
            ms["pack_phases_direct"] += _declared_bound(dk.pack_phases_direct, name, (dy, dy, dy),
                                                        g, S, r, Mp, H)[0][0]
            ms["unpack_phases_direct"] += _declared_bound(dk.unpack_phases_direct, name, out6, L, E, g, S, r)[0][0]
    return ms


def _check_epilogue_bwd(dk, d6s, refs, plan, label) -> float:
    """Row 10's outputs against its plain version's under
    ``EPILOGUE_BWD_TOL``: one tensor per branch, finite, exact 0 at every
    slot off the segment or the sequence; returns the largest error."""
    import torch

    check(len(d6s) == len(plan.branches), f"fusion_epilogue_bwd {label}: {len(d6s)} tensors for "
          f"{len(plan.branches)} branches")
    err = 0.0
    for d6, ref, (g, S, r, m, Mp) in zip(d6s, refs, plan.branches):
        check(bool(torch.isfinite(d6).all()), f"fusion_epilogue_bwd {label} r={r}: non-finite")
        torch.testing.assert_close(d6, ref, **EPILOGUE_BWD_TOL[str(d6.dtype).replace("torch.", "")])
        err = max(err, max_err(d6, ref))
        inside = dk.pack_phases_reference(torch.ones(1, plan.L, E, device="cuda"), g, S, r, Mp, H) > 0
        check(not bool(d6[:, ~inside[0]].any()), f"fusion_epilogue_bwd {label} r={r}: slots off the extent not 0")
    return err


def _epilogue_bwd_canary(dk, gen):
    """Row 10 (bf16, B = 2, the flagship's five branches at L = 10241) with
    its outputs on memory the caching allocator last held filled with NaN:
    blocks of the outputs' sizes are filled and freed first, the call is
    checked to land on them, and every slot then holds its plain version's
    value (an unwritten one would stay NaN), exact 0 off the extent."""
    import torch

    L, B = N_TILES + 1, 2
    plan = dk.plan_stream_fusion(L, E, H, *SCHEDULE)
    dy = torch.randn(B, L, E, device="cuda", generator=gen).to(torch.bfloat16)
    fused = torch.randn(B, L, H, device="cuda", generator=gen)
    lses = [fused.new_empty(B, S, r, H // r, Mp).normal_(generator=gen) for g, S, r, m, Mp in plan.branches]
    refs = dk.fusion_epilogue_bwd_reference(dy, fused, lses, plan)
    torch.cuda.synchronize()
    nans = [torch.full((B, S, r, H // r, Mp, E // H), float("nan"), dtype=dy.dtype, device="cuda")
            for g, S, r, m, Mp in plan.branches]
    held = {t.data_ptr() for t in nans}
    del nans
    d6s = dk.fusion_epilogue_bwd(dy, fused, lses, plan)
    landed = sum(d6.data_ptr() in held for d6 in d6s)
    check(landed == len(d6s), f"fusion_epilogue_bwd canary: {landed} of {len(d6s)} outputs on the NaN blocks")
    err = _check_epilogue_bwd(dk, d6s, refs, plan, "canary")
    emit("epilogue_bwd_canary", B=B, L=L, dtype="bfloat16", outputs_on_nan_blocks=landed, max_abs_err=err,
         unwritten_slots=0)


def _dense_fusion(dk, outs, lses, plan):
    """The default route's fusion of the same packed results: five unpacks,
    the lse scatter, the softmax and the weighted sum."""
    import torch

    L, B = plan.L, outs[0].shape[0]
    dense = [dk.unpack_phases(o6, L, E, g, S, r) for o6, (g, S, r, m, Mp) in zip(outs, plan.branches)]
    lse = torch.stack([dk._scatter_lse(l5, L, H, g, r, m) for l5, (g, S, r, m, Mp) in zip(lses, plan.branches)])
    acc = None
    for o, w in zip(dense, torch.softmax(lse, dim=0)):
        term = o.reshape(B, L, H, E // H).float() * w.transpose(1, 2)[..., None]
        acc = term if acc is None else acc + term
    return acc.to(outs[0].dtype)


def _dense_fusion_bwd(dk, dy, weights, plan):
    """The default route's backward of the same fusion: each branch's dense
    cotangent (dY times its weight) packed for its backward kernels."""
    B, L = dy.shape[:2]
    return [dk.pack_phases((dy.reshape(B, L, H, E // H).float() * w.transpose(1, 2)[..., None])
                           .reshape(B, L, E).to(dy.dtype), g, S, r, Mp, H)
            for w, (g, S, r, m, Mp) in zip(weights, plan.branches)]


def _fusion_case(dk, B, dtype, gen, real_len, valid, timed: bool, schedule=SCHEDULE):
    """The four kernels vs their plain versions on one flagship layer's
    branches (q, k, v at L = 10241) of ``schedule``; returns the per-layer
    summary."""
    import torch

    L = N_TILES + 1
    dname = str(dtype).replace("torch.", "")
    q, k, v = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
    plan = dk.plan_stream_fusion(L, E, H, *schedule)
    tot = {name: dict(ms=0.0, plain_ms=0.0, err=0.0, library_ms=None) for name in FUSION_KERNELS}
    outs, lses = [], []
    for (g, S, r, m, Mp), sl in zip(plan.branches, schedule[0]):
        kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, valid, q.device)
        if S == 1 and r > 1:
            # direct pack, q, k and v in one launch: each an exact copy of its
            # plain version and of the row-2 pack, and of a one-tensor call
            q6, k6, v6 = dk.pack_phases_direct((q, k, v), g, S, r, Mp, H)
            for x, x6 in ((q, q6), (k, k6), (v, v6)):
                check(torch.equal(x6, dk.pack_phases_direct_reference(x, g, S, r, Mp, H)),
                      f"pack_phases_direct {dname} B={B} r={r}: differs from its plain version")
                check(torch.equal(x6, dk.pack_phases(x, g, S, r, Mp, H)),
                      f"pack_phases_direct {dname} B={B} r={r}: differs from pack_phases")
            check(torch.equal(dk.pack_phases_direct((k,), g, S, r, Mp, H)[0], k6),
                  f"pack_phases_direct {dname} B={B} r={r}: a one-tensor call differs")
        else:
            q6, k6, v6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v))
        out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
        outs.append(out6)
        lses.append(lse5)
        if not (S == 1 and r > 1):
            continue
        dense = dk.unpack_phases_direct(out6, L, E, g, S, r)
        check(torch.equal(dense, dk.unpack_phases_direct_reference(out6, L, E, g, S, r)),
              f"unpack_phases_direct {dname} B={B} r={r}: differs from its plain version")
        check(torch.equal(dense, dk.unpack_phases(out6, L, E, g, S, r)),
              f"unpack_phases_direct {dname} B={B} r={r}: differs from unpack_phases")
        if timed:
            # a layer packs q, k, v of each direct branch in one launch
            pack = lambda: dk.pack_phases_direct((q, k, v), g, S, r, Mp, H)  # noqa: E731
            unpack = lambda: dk.unpack_phases_direct(out6, L, E, g, S, r)  # noqa: E731
            lib = _copy_yardsticks(dk, q, out6, q6, dense, g, S, r, Mp)
            for name, fn, plain, n, key in (
                ("pack_phases_direct", pack, lambda: dk.pack_phases_direct_reference(q, g, S, r, Mp, H), 3, "take"),
                ("unpack_phases_direct", unpack, lambda: dk.unpack_phases_direct_reference(out6, L, E, g, S, r),
                 1, "index_copy"),
            ):
                t = tot[name]
                t["ms"] += graph_ms(fn)
                t["event_ms"] = t.get("event_ms", 0.0) + time_ms(fn)
                t["plain_ms"] += n * time_ms(plain, reps=5)
                t["library_ms"] = (t["library_ms"] or 0.0) + n * lib[f"{key}_ms"]
                t["library_event_ms"] = t.get("library_event_ms", 0.0) + n * lib[f"{key}_event_ms"]
        del q6, k6, v6, dense

    # the epilogue forward against its plain version
    out, fused = dk.fusion_epilogue_fwd(outs, lses, plan)
    out_ref, fused_ref = dk.fusion_epilogue_fwd_reference(outs, lses, plan)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"fusion_epilogue_fwd {dname} B={B}: non-finite out")
    torch.testing.assert_close(out, out_ref, **EPILOGUE_TOL[dname])
    covered = fused_ref > -1e19
    torch.testing.assert_close(fused[covered], fused_ref[covered], **FUSED_LSE_TOL)
    check(bool((fused[~covered] <= -1e19).all()), f"fusion_epilogue_fwd {dname}: uncovered fused_lse above -1e19")
    tot["fusion_epilogue_fwd"]["err"] = max_err(out, out_ref)
    # against the default route's fusion of the same packed results
    dense_out = _dense_fusion(dk, outs, lses, plan).reshape(B, L, E)
    torch.testing.assert_close(out, dense_out, **EPILOGUE_TOL[dname])

    # the epilogue backward, one launch for the five branches: packed
    # cotangents, exact 0 off the segment and the sequence
    dy = torch.randn(B, L, E, device="cuda", generator=gen).to(dtype)
    err_bwd = _check_epilogue_bwd(dk, dk.fusion_epilogue_bwd(dy, fused, lses, plan),
                                  dk.fusion_epilogue_bwd_reference(dy, fused, lses, plan), plan, dname)
    tot["fusion_epilogue_bwd"]["err"] = err_bwd
    for name in ("pack_phases_direct", "unpack_phases_direct"):
        tot[name]["err"] = 0.0  # checked bit-exact above
    record = {"dtype": dname, "B": B, "real_len": real_len, "schedule": schedule,
              "valid": None if valid is None else valid.tolist(),
              "max_abs_err": {"epilogue_out": tot["fusion_epilogue_fwd"]["err"],
                              "epilogue_vs_dense_fusion": max_err(out, dense_out),
                              "fused_lse_covered": max_err(fused[covered], fused_ref[covered]),
                              "epilogue_bwd": err_bwd, "pack_direct": 0.0, "unpack_direct": 0.0},
              "uncovered_pairs": int((~covered).sum())}
    if timed:
        weights = torch.softmax(torch.stack([dk._scatter_lse(l5, L, H, g, r, m)
                                             for l5, (g, S, r, m, Mp) in zip(lses, plan.branches)]), dim=0)
        fwd = lambda: dk.fusion_epilogue_fwd(outs, lses, plan)  # noqa: E731
        t = tot["fusion_epilogue_fwd"]
        t["ms"] = graph_ms(fwd)
        t["event_ms"] = time_ms(fwd)
        t["plain_ms"] = time_ms(lambda: dk.fusion_epilogue_fwd_reference(outs, lses, plan), reps=3, warmup=1)
        t["dense_route_ms"] = _device_busy_ms(lambda: _dense_fusion(dk, outs, lses, plan))
        bwd = lambda: dk.fusion_epilogue_bwd(dy, fused, lses, plan)  # noqa: E731
        t = tot["fusion_epilogue_bwd"]
        t["ms"] = graph_ms(bwd)
        t["event_ms"] = time_ms(bwd)
        t["plain_ms"] = time_ms(lambda: dk.fusion_epilogue_bwd_reference(dy, fused, lses, plan), reps=3, warmup=1)
        t["dense_route_ms"] = _device_busy_ms(lambda: _dense_fusion_bwd(dk, dy, weights, plan))
        bounds = _fusion_bounds(B, L, plan, q.dtype)
        for name in FUSION_KERNELS:
            tot[name].update(bound_ms=bounds[name], bound_by="bytes")
        record["per_layer"] = tot
    emit("fusion_kernels", **record)
    return tot


def _fusion_layer_ms(dk, L: int, dtype, gen) -> dict:
    """Rows 4, 9 and 10 on one flagship layer of L tokens (B = 1) by device
    time (``graph_ms``): the direct pack of each single-segment branch, one
    tensor alone and q, k, v as the tree's route packs them (one launch
    where the wrapper takes several tensors, else one a tensor), the
    epilogue forward over the five branches' packed results and its
    backward as the tree's route calls it (one launch where the wrapper
    takes every branch, else one a branch), each beside its bound; and the
    launch floor, ``graph_ms`` of ``torch.cuda._sleep(1)``, a kernel that
    does almost nothing. Only entry points every tree of the port has, so
    it times another tree's kernels too (:func:`fusion_kernel_times`)."""
    import inspect

    import torch

    q, k, v = (torch.randn(1, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
    plan = dk.plan_stream_fusion(L, E, H, *SCHEDULE)
    es = q.element_size()
    merged = hasattr(dk, "PACK_DIRECT_MAX_TENSORS")
    per_r, pack_ms, outs, lses = {}, 0.0, [], []
    for g, S, r, m, Mp in plan.branches:
        kvlen = dk._branch_kvlen(1, S, g, r, m, L, None, q.device)
        q6, k6, v6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v))
        out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
        outs.append(out6)
        lses.append(lse5)
        del q6, k6, v6
        if not (S == 1 and r > 1):
            continue
        if merged:
            one = lambda: dk.pack_phases_direct((q,), g, S, r, Mp, H)  # noqa: E731
            layer = lambda: dk.pack_phases_direct((q, k, v), g, S, r, Mp, H)  # noqa: E731
        else:  # a tree whose wrapper takes one tensor
            one = lambda: dk.pack_phases_direct(q, g, S, r, Mp, H)  # noqa: E731
            layer = lambda: [dk.pack_phases_direct(x, g, S, r, Mp, H) for x in (q, k, v)]  # noqa: E731
        one_bytes = (L * E // r + Mp * E) * es
        per_r[r] = {"one_tensor_ms": graph_ms(one),
                    "one_tensor_bound_ms": one_bytes / HBM_BYTES_PER_S * 1e3,
                    "qkv_ms": graph_ms(layer), "qkv_launches": 1 if merged else 3,
                    "qkv_bound_ms": 3 * one_bytes / HBM_BYTES_PER_S * 1e3}
        pack_ms += per_r[r]["qkv_ms"]
    bounds = _fusion_bounds(1, L, plan, dtype)
    _, fused = dk.fusion_epilogue_fwd(outs, lses, plan)
    dy = torch.randn(1, L, E, device="cuda", generator=gen).to(dtype)
    bwd_merged = "plan" in inspect.signature(dk.fusion_epilogue_bwd).parameters
    if bwd_merged:
        bwd = lambda: dk.fusion_epilogue_bwd(dy, fused, lses, plan)  # noqa: E731
    else:  # a tree whose wrapper takes one branch
        bwd = lambda: [dk.fusion_epilogue_bwd(dy, fused, l5, br, H)  # noqa: E731
                       for l5, br in zip(lses, plan.branches)]
    torch.cuda.synchronize()
    return {"L": L, "dtype": str(dtype).replace("torch.", ""), "pack_merged": merged,
            "launch_floor_ms": graph_ms(lambda: torch.cuda._sleep(1)),
            "pack_per_r": per_r, "pack_layer_ms": pack_ms, "pack_layer_bound_ms": bounds["pack_phases_direct"],
            "epilogue_fwd_ms": graph_ms(lambda: dk.fusion_epilogue_fwd(outs, lses, plan)),
            "epilogue_fwd_bound_ms": bounds["fusion_epilogue_fwd"],
            "epilogue_bwd_ms": graph_ms(bwd), "epilogue_bwd_launches": 1 if bwd_merged else len(lses),
            "epilogue_bwd_bound_ms": bounds["fusion_epilogue_bwd"]}


def _pack_direct_canary(dk, gen):
    """The direct pack's C entry called directly on q, k, v (bf16, the
    flagship r = 4 branch at L = 10241) into NaN-filled destinations one
    unit longer than the packed tensor: with one destination shifted by
    one element (the launch falls to a narrower unit) every packed slot
    bit-equal to the plain version and nothing outside written; with one
    destination off the element size the call is refused
    (``cudaErrorMisalignedAddress``) and nothing is written."""
    import ctypes

    import torch

    from gigapath_tpu_torch.ops import _build

    L = N_TILES + 1
    r = SCHEDULE[1][2]
    g, S, _, Mp = dk._branch_geometry(L, SCHEDULE[0][2], r)
    xs = [torch.randn(1, L, E, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3)]
    n6 = Mp * E
    lib = _build.library("pack_phases_direct")
    arr = lambda ptrs: (ctypes.c_longlong * 3)(*ptrs)  # noqa: E731
    for shift_bytes, want in ((2, 0), (1, CUDA_ERROR_MISALIGNED_ADDRESS)):
        bufs = [torch.full((n6 + 8,), float("nan"), device="cuda", dtype=torch.bfloat16) for _ in range(3)]
        ptrs = [bufs[0].data_ptr(), bufs[1].data_ptr() + shift_bytes, bufs[2].data_ptr()]
        rc = lib.gp_pack_phases_direct(arr([x.data_ptr() for x in xs]), arr(ptrs), 3, 2, 1, L, E, r, H // r,
                                       E // H, Mp, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        check(rc == want, f"pack_phases_direct canary: rc {rc} with a destination shifted {shift_bytes} bytes")
        for i, (x, buf) in enumerate(zip(xs, bufs)):
            if want:
                check(bool(torch.isnan(buf).all()), "pack_phases_direct canary: a refused call wrote")
                continue
            off = shift_bytes // 2 if i == 1 else 0
            ref = dk.pack_phases_direct_reference(x, g, S, r, Mp, H).reshape(-1)
            check(torch.equal(_bits(buf[off:off + n6]), _bits(ref)), f"pack_phases_direct canary: tensor {i} differs")
            rest = torch.cat([buf[:off], buf[off + n6:]])
            check(bool(torch.isnan(rest).all()), f"pack_phases_direct canary: tensor {i} written outside")
    # the wrapper refuses tensors of one call that differ in dtype
    try:
        dk.pack_phases_direct((xs[0], xs[1].float()), g, S, r, Mp, H)
    except ValueError:
        pass
    else:
        raise AssertionError("pack_phases_direct took tensors of two dtypes in one call")
    emit("pack_direct_canary", r=r, L=L, shifted_destination="bit-exact, nothing outside written",
         destination_off_the_element=f"refused ({CUDA_ERROR_MISALIGNED_ADDRESS}), nothing written",
         mixed_dtypes="refused")


def phase_fusion_kernels():
    """The four kernels vs their plain versions at the flagship's branch
    shapes: fp32 and bf16 with a ragged real length (timed), a B = 2
    batch with per-row valid lengths, and the epilogue on a schedule whose
    segment ends fall inside its token tiles (B = 1 and 2); the direct
    pack's canary and the epilogue backward's; rows 4, 9 and 10 per layer
    with the launch floor."""
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(21)
    L = N_TILES + 1
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        summary[str(dtype).replace("torch.", "")] = _fusion_case(dk, 1, dtype, gen, L - 37, None, timed=True)
        _fusion_case(dk, 2, dtype, gen, L, torch.tensor([L, 7002], device="cuda"), timed=False)
        _fusion_case(dk, 1, dtype, gen, L - 37, None, timed=False, schedule=STRADDLE_SCHEDULE)
        _fusion_case(dk, 2, dtype, gen, L, torch.tensor([L, 7002], device="cuda"), timed=False,
                     schedule=STRADDLE_SCHEDULE)
        emit("fusion_layer_ms", **_fusion_layer_ms(dk, L, dtype, gen))
    _pack_direct_canary(dk, gen)
    _epilogue_bwd_canary(dk, gen)
    return summary


def _route_embeds(model, x, coords, flags_on: bool):
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    with env_flags(FUSION_ENV) if flags_on else contextlib.nullcontext():
        return run_inference_with_slide_encoder(x, coords, model)


def _timed_env_routes(model, x, coords, routes: dict, reps: int = 3) -> dict:
    """ms per slide (host clock to the device->host copy, median) and peak
    memory above the model of each route (name -> environment) in turns."""
    import torch

    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    out = {}
    for route, env in routes.items():
        with env_flags(env):
            run_inference_with_slide_encoder(x, coords, model)  # warm-up
            torch.cuda.synchronize()
            _reset_peak()
            base = torch.cuda.memory_allocated()
            secs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_inference_with_slide_encoder(x, coords, model)
                secs.append(time.perf_counter() - t0)
        ms = statistics.median(secs) * 1e3
        out[route] = {"ms_per_slide": ms, "runs_ms": [s_ * 1e3 for s_ in secs],
                      "tiles_per_s": x.shape[1] / (ms / 1e3),
                      "peak_mem_gb_above_model": (_peak() - base) / 2**30}
    return out


def _timed_routes(model, x, coords, reps: int = 3) -> dict:
    """ms per slide and peak memory above the model of the default and the
    stream-fusion route."""
    return _timed_env_routes(model, x, coords, {"default": {}, "stream_fusion": FUSION_ENV}, reps)


def phase_fusion_forward():
    """The flagship forward on the stream-fusion route against the default
    route, fp32 and bf16: exact launches, per-layer agreement, ms per slide
    and peak memory of both routes at 10240 and 102400 tiles, and a
    profiler breakdown of one bf16 forward on each route."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    x, coords = _flagship_inputs(1, gen)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        model = create_model("", "gigapath_slide_enc12l768d", dtype=dtype, seed=0)
        default = _route_embeds(model, x, coords, False)
        _route_embeds(model, x, coords, True)  # warm-up
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        fused = _route_embeds(model, x, coords, True)
        counts = dict(dk.LAUNCHES)
        check(counts == FUSION_FWD_LAUNCHES, f"{dname} stream-fusion forward launches {counts} != {FUSION_FWD_LAUNCHES}")
        per_layer = []
        for a, b in zip(_embeds(fused), _embeds(default)):
            check(a.shape == (1, E) and np.isfinite(a).all(), f"{dname}: bad embedding {a.shape}")
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            one_minus_cos = 1.0 - float(_cosines(a, b)[0])
            per_layer.append({"rel": rel, "one_minus_cos": one_minus_cos})
            if dname == "float32":
                check(rel <= FUSION_F32_REL_TOL, f"fp32 stream-fusion vs default route rel err {rel}")
            else:
                check(one_minus_cos <= BF16_MAX_ONE_MINUS_COS,
                      f"bf16 stream-fusion vs default route 1 - cosine {one_minus_cos}")
        record = dict(dtype=dname, tiles=N_TILES, launches=counts, vs="the default route (kernels)",
                      per_layer=per_layer, **_timed_routes(model, x, coords),
                      tolerance={"float32": f"rel <= {FUSION_F32_REL_TOL}",
                                 "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname])
        if dname == "bfloat16":
            with torch.inference_mode():
                record["forward_trace"] = {route: _profile(lambda: _route_embeds(model, x, coords, on))
                                           for route, on in (("default", False), ("stream_fusion", True))}
            record["peak_breakdown"] = {route: _peak_breakdown(lambda: _route_embeds(model, x, coords, on))
                                        for route, on in (("default", False), ("stream_fusion", True))}
        emit("fusion_forward", **record)
        result[dname] = record
        del model
        torch.cuda.empty_cache()

    # one 102400-tile slide, bf16, both routes
    del x, coords
    idx = torch.arange(LONG_TILES, device="cuda")
    coords = (torch.stack([idx // 320, idx % 320], dim=-1).float() * 256.0)[None]
    x = torch.randn(1, LONG_TILES, 1536, device="cuda", generator=gen)
    model = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0)
    timing = _timed_routes(model, x, coords, reps=2)
    a, b = (_embeds(_route_embeds(model, x, coords, on))[-1] for on in (True, False))
    one_minus_cos = 1.0 - float(_cosines(a, b)[0])
    check(np.isfinite(a).all() and one_minus_cos <= BF16_MAX_ONE_MINUS_COS,
          f"102400 tiles: stream-fusion vs default 1 - cosine {one_minus_cos}")
    for route, on in (("default", False), ("stream_fusion", True)):
        timing[route]["peak_breakdown"] = _peak_breakdown(lambda: _route_embeds(model, x, coords, on))
    del model, x
    torch.cuda.empty_cache()
    # the attention alone: one dilated_attention call's peak memory above
    # its q/k/v on each route (the whole forward's peak lies elsewhere)
    q, k, v = (torch.randn(1, LONG_TILES + 1, H, E // H, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    for route, on in (("default", False), ("stream_fusion", True)):
        with env_flags(FUSION_ENV) if on else contextlib.nullcontext(), torch.inference_mode():
            dilated_attention(q, k, v, *SCHEDULE)
            torch.cuda.synchronize()
            _reset_peak()
            base = torch.cuda.memory_allocated()
            dilated_attention(q, k, v, *SCHEDULE)
            timing[route]["attention_peak_gb_above_qkv"] = (_peak() - base) / 2**30
    # rows 4 and 9 of one layer at this length, by device time
    timing["rows_4_9"] = _fusion_layer_ms(dk, LONG_TILES + 1, torch.bfloat16, gen)
    emit("fusion_forward_long", dtype="bfloat16", tiles=LONG_TILES, last_layer_one_minus_cos=one_minus_cos, **timing)
    result["long"] = timing
    del q, k, v
    torch.cuda.empty_cache()
    return result


def _route_step(seed: int, label: int, env: dict, want: dict, timing_routes: dict):
    """The flagship fine-tune step (finetune_step's head and settings) on
    the route ``env`` selects: fp32 gradients against the default route
    (the worst per parameter within GRAD_F32_REL_TOL), the exact launches
    of one bf16 step (``want``), and ms per step and peak memory of each of
    ``timing_routes`` (name -> environment) in turn, bf16. Returns
    ``(launches, grads record, timing)``."""
    import torch

    from gigapath_tpu_torch.finetune.training import forward_backward, train_step
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, coords = _flagship_inputs(1, gen)
    labels = torch.tensor([[label]], device="cuda")
    pad_mask = torch.ones(1, N_TILES, dtype=torch.bool, device="cuda")
    batch = (x, coords, labels, pad_mask)
    model, steps, loss_fn = _head_and_steps(torch)

    runs = []
    for route_env in ({}, env):
        model.zero_grad(set_to_none=True)
        with env_flags(route_env):
            loss = forward_backward(model, loss_fn, *batch, multi_label=False, bf16=False)
        runs.append((float(loss), _grads(model)))
    (loss_d, g_d), (loss_r, g_r) = runs
    check(set(g_d) == set(g_r), f"{env}: the two routes reach different parameters")
    floor = 1e-2 * max(float(g.abs().max()) for g in g_d.values())
    errs = {}
    for name, gd in g_d.items():
        gr = g_r[name].float()
        check(bool(torch.isfinite(gr).all()), f"{env}: non-finite gradient {name}")
        errs[name] = float((gr - gd.float()).abs().max()) / max(float(gd.abs().max()), floor)
    worst_name, worst = max(errs.items(), key=lambda kv: kv[1])
    check(worst <= GRAD_F32_REL_TOL, f"{env}: fp32 step gradient {worst_name} vs the default route {worst}")
    model.zero_grad(set_to_none=True)

    with env_flags(env):
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)  # warm-up
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)
        torch.cuda.synchronize()
    launches = dict(dk.LAUNCHES)
    check(launches == want, f"{env}: step launches {launches} != {want}")

    timing = {}
    for route, route_env in timing_routes.items():
        with env_flags(route_env):
            _reset_peak()
            train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        ms = statistics.median(secs) * 1e3
        timing[route] = {"ms_per_step": ms, "runs_ms": [s_ * 1e3 for s_ in secs],
                         "peak_mem_gb": _peak() / 2**30}
    del model, steps
    torch.cuda.empty_cache()
    grads = {"param": worst_name, "err": worst, "tolerance": GRAD_F32_REL_TOL,
             "loss_default": loss_d, "loss_route": loss_r}
    return launches, grads, timing


def phase_fusion_step():
    """The flagship fine-tune step on the stream-fusion route: fp32
    gradients against the default route, the exact launches of one bf16
    step, ms per step and peak memory of both routes in bf16."""
    launches, grads, timing = _route_step(23, 2, FUSION_ENV, FUSION_STEP_LAUNCHES,
                                          {"default": {}, "stream_fusion": FUSION_ENV})
    emit("fusion_step", tiles=N_TILES, launches=launches, grads_fp32=grads, bfloat16=timing)
    return launches


# ---------------------------------------------------------------------------
# the head-major dilated route: the segment-flash kernels, the forward and
# step with ratios that do not divide the heads, the flash entry points
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_flash_kernels():
    """Run the head-major route and the flash entry points with the
    segment-flash kernels' plain PyTorch versions on CUDA tensors."""
    from gigapath_tpu_torch.ops import flash_kernels as fk

    saved = {name: getattr(fk, name) for name in FLASH_KERNELS}
    fk.flash_fwd, fk.flat_fwd = fk.flash_fwd_reference, fk.flat_fwd_reference
    fk.flash_bwd_dq = lambda *a: fk.flash_bwd_reference(*a, dkv=False)[0]
    fk.flash_bwd_dkv = lambda *a: fk.flash_bwd_reference(*a, dq=False)[1:]
    fk.flat_bwd_dq = lambda *a: fk.flat_bwd_reference(*a, dkv=False)[0]
    fk.flat_bwd_dkv = lambda *a: fk.flat_bwd_reference(*a, dq=False)[1:]
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fk, name, fn)


_MUFU = {}


def _exp2_floor_ms(pairs: float) -> float:
    """Least time (ms) of one exp2 per admitted pair, which each
    segment-flash kernel evaluates to recompute its probabilities, on the
    MUFU pipes: 16 a clock per SM at the card's maximum SM clock
    (``nvidia-smi`` clocks.max.sm). Reported beside the bound, not in it."""
    import torch

    if not _MUFU:
        mhz = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.split()[0]
        _MUFU["per_s"] = 16 * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6
        _MUFU["sm_clock_mhz"] = float(mhz)
    return pairs / _MUFU["per_s"] * 1e3


def _flash_branch(fk, pda, qh, kh, vh, do, sl, r, real_len, valid):
    """One head-major branch's kernel inputs, as the route forms them:
    ``(flat, args)`` where args are ``(q, k, v, do, kvlen or (g,
    real_len))`` in the kernels' layout."""
    B, _, L, _ = qh.shape
    g, Lp, n, gp, m = pda._bhld_geom(L, sl, r)
    if valid is None and pda._flat_eligible(g, r):
        return True, (qh, kh, vh, do, (g, real_len)), (g, Lp, n, gp, m)
    kvlen = pda._bhld_kvlen(B, H, n, g, r, m, real_len, valid, qh.device)
    x5 = [pda._seg_dilate(x, g, Lp, n, gp, r) for x in (qh, kh, vh, do)]
    return False, (*x5, kvlen), (g, Lp, n, gp, m)


def _flash_fwd_bwd(fk, flat, args, causal=False, plain=False):
    """The forward and both backward kernels (or their plain versions) on
    one branch: ``(out, lse, dq, dk, dv)``."""
    q, k, v, do, extra = args
    if flat:
        g, rl = extra
        fwd = fk.flat_fwd_reference if plain else fk.flat_fwd
        out, lse = fwd(q, k, v, g, rl, causal)
        delta = (do.float() * out.float()).sum(-1)
        a = (q, k, v, do, lse, delta, g, rl, causal)
        if plain:
            return (out, lse, *fk.flat_bwd_reference(*a))
        return (out, lse, fk.flat_bwd_dq(*a), *fk.flat_bwd_dkv(*a))
    fwd = fk.flash_fwd_reference if plain else fk.flash_fwd
    out, lse = fwd(q, k, v, extra, causal)
    delta = (do.float() * out.float()).sum(-1)
    a = (q, k, v, do, lse, delta, extra, causal)
    if plain:
        return (out, lse, *fk.flash_bwd_reference(*a))
    return (out, lse, fk.flash_bwd_dq(*a), *fk.flash_bwd_dkv(*a))


def _check_flash(label, dname, flat, ours, ref, dq_rows=None, args=None):
    """A branch's kernels against their plain versions: out and the covered
    lse by KERNEL_TOL / LSE_TOL, uncovered rows' lse at the sentinel, the
    gradients by BWD_REL_TOL (dq on the rows where it is specified); with
    the branch's ``args``, every masked key's dk and dv exactly 0 (keys at
    or past a segment's count, or a flat layout's real_len)."""
    import torch

    out, lse, dq, dk, dv = ours
    r_out, r_lse, r_dq, r_dk, r_dv = ref
    torch.cuda.synchronize()
    for name, t in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv)):
        check(bool(torch.isfinite(t).all()), f"{label} {dname}: non-finite {name}")
    torch.testing.assert_close(out, r_out, **KERNEL_TOL[dname])
    covered = r_lse > -1e19
    torch.testing.assert_close(lse[covered], r_lse[covered], **LSE_TOL[dname])
    check(bool((lse[~covered] <= -1e19).all()), f"{label} {dname}: uncovered lse above -1e19")
    if args is not None and (flat or args[4] is not None):
        if flat:
            masked = (torch.arange(dk.shape[2], device=dk.device) >= args[4][1])[None, None, :].expand(dk.shape[:3])
        else:
            masked = torch.arange(dk.shape[3], device=dk.device) >= args[4][..., None]
        check(not bool(dk[masked].any()) and not bool(dv[masked].any()),
              f"{label} {dname}: a masked key's dk or dv is not exactly 0")
    if dq_rows is not None:
        dq, r_dq = dq[:, :, :dq_rows], r_dq[:, :, :dq_rows]
    errs = {"out": max_err(out, r_out), "lse_covered": max_err(lse[covered], r_lse[covered])}
    for name, a, b in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv)):
        errs[name] = _grad_rel_err(a, b)
        check(errs[name] <= BWD_REL_TOL[dname], f"{label} {dname} {name}: rel err {errs[name]} > {BWD_REL_TOL[dname]}")
    return errs


def _flat_rows_add_nothing(fk, label, args, ours, causal=False):
    """Flat query rows at or past real_len add nothing to dk/dv: with their
    q, dO, lse and delta replaced by other values (3 sigma noise), dk and dv
    stay bit-equal (the kernels use no atomics)."""
    import torch

    q, k, v, do, (g, rl) = args
    delta = (do.float() * ours[0].float()).sum(-1)
    moved = []
    for t in (q, do, ours[1], delta):
        t = t.clone()
        t[:, :, rl:] = (3 * torch.randn(t[:, :, rl:].shape, device=t.device)).to(t.dtype)
        moved.append(t)
    dk, dv = fk.flat_bwd_dkv(moved[0], k, v, moved[1], moved[2], moved[3], g, rl, causal)
    check(torch.equal(dk, ours[3]) and torch.equal(dv, ours[4]),
          f"{label}: flat rows at or past real_len changed dk/dv")


def _sdpa_yardstick(flat, args, pda, geom):
    """CUDA-event ms of one SDPA call with a boolean key mask on the same
    segment tensors, and of its backward: [B*H*S, 1, M, D]."""
    import torch
    import torch.nn.functional as F

    q, k, v, do, extra = args
    if flat:
        g, rl = extra
        q, k, v, do = (pda._seg_dilate(x, g, geom[1], geom[2], g, 1) for x in (q, k, v, do))
        S = q.shape[2]
        counts = torch.tensor([max(0, min(g, rl - s * g)) for s in range(S)], device=q.device)
        kvlen = counts.expand(q.shape[0], q.shape[1], S)
    else:
        kvlen = extra if extra is not None else torch.full(q.shape[:3], k.shape[3], device=q.device)
    M, D = q.shape[3], q.shape[4]
    qs, ks, vs = (x.reshape(-1, 1, M, D).detach().requires_grad_() for x in (q, k, v))
    key_ok = (torch.arange(M, device=q.device)[None] < kvlen.reshape(-1, 1))[:, None, None, :]
    fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok), reps=5)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok)
    dout = do.reshape(out.shape)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True), reps=5)
    return fwd_ms, bwd_ms


def _flash_layer(fk, pda, B, dtype, gen, real_len, valid, timed: bool):
    """The six kernels vs their plain versions on one layer of the §1
    configuration (the five head-major branches at L = 10241); returns the
    per-layer totals of each kernel when ``timed``."""
    import torch

    L = N_TILES + 1
    dname = str(dtype).replace("torch.", "")
    qh, kh, vh, do = (torch.randn(B, H, L, E // H, device="cuda", generator=gen).to(dtype) for _ in range(4))
    totals = {name: dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0, exp2_floor_ms=0.0, library_ms=0.0,
                         err=0.0, by={})
              for name in FLASH_KERNELS}
    records = []
    for sl, r in zip(*BHLD_SCHEDULE):
        flat, args, geom = _flash_branch(fk, pda, qh, kh, vh, do, sl, r, real_len, valid)
        g, Lp, n, gp, m = geom
        if not flat:
            check(args[4] is None or args[4].device.type == "cuda", "the count table is not on the card")
        ours = _flash_fwd_bwd(fk, flat, args)
        ref = _flash_fwd_bwd(fk, flat, args, plain=True)
        errs = _check_flash(f"flash r={r}", dname, flat, ours, ref, dq_rows=real_len if flat else None,
                            args=args)
        if flat and real_len < L:
            _flat_rows_add_nothing(fk, f"flash r={r} {dname}", args, ours)
        record = {"sl": sl, "r": r, "g": g, "S": n, "m": m, "kernel": "flat" if flat else "segmented",
                  "max_err": errs}
        if timed:
            prefix = "flat" if flat else "flash"
            q, k, v, dout, extra = args
            out, lse = ours[0], ours[1]
            delta = (dout.float() * out.float()).sum(-1)
            if flat:
                fwd = lambda: fk.flat_fwd(q, k, v, *extra)  # noqa: E731
                bargs = (q, k, v, dout, lse, delta, *extra)
                dq_fn, dkv_fn = (lambda: fk.flat_bwd_dq(*bargs)), (lambda: fk.flat_bwd_dkv(*bargs))
                p_fwd = lambda: fk.flat_fwd_reference(q, k, v, *extra)  # noqa: E731
                p_dq = lambda: fk.flat_bwd_reference(*bargs, dkv=False)  # noqa: E731
                p_dkv = lambda: fk.flat_bwd_reference(*bargs, dq=False)  # noqa: E731
                wrappers = (fk.flat_fwd, fk.flat_bwd_dq, fk.flat_bwd_dkv)
                fwd_args = (q, k, v, *extra)
            else:
                fwd = lambda: fk.flash_fwd(q, k, v, extra)  # noqa: E731
                bargs = (q, k, v, dout, lse, delta, extra)
                dq_fn, dkv_fn = (lambda: fk.flash_bwd_dq(*bargs)), (lambda: fk.flash_bwd_dkv(*bargs))
                p_fwd = lambda: fk.flash_fwd_reference(q, k, v, extra)  # noqa: E731
                p_dq = lambda: fk.flash_bwd_reference(*bargs, dkv=False)  # noqa: E731
                p_dkv = lambda: fk.flash_bwd_reference(*bargs, dq=False)  # noqa: E731
                wrappers = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
                fwd_args = (q, k, v, extra)
            # each kernel's declared work (:func:`_declared_bound`)
            bounds = {}
            for name, fn, a in zip((f"{prefix}_fwd", f"{prefix}_bwd_dq", f"{prefix}_bwd_dkv"), wrappers,
                                   (fwd_args, bargs, bargs)):
                bounds[name], flops = _declared_bound(fn, dname, *a)
                if name.endswith("_fwd"):
                    pairs = flops / (4 * (E // H))
            exp2_floor = _exp2_floor_ms(pairs)
            lib_fwd, lib_bwd = _sdpa_yardstick(flat, args, pda, geom)
            fns = {f"{prefix}_fwd": fwd, f"{prefix}_bwd_dq": dq_fn, f"{prefix}_bwd_dkv": dkv_fn}
            t = {name: graph_ms(fn) for name, fn in fns.items()}  # device time
            wrapper = {name: time_ms(fn) for name, fn in fns.items()}  # one call, host work included
            plain = {f"{prefix}_fwd": time_ms(p_fwd, reps=2, warmup=1),
                     f"{prefix}_bwd_dq": time_ms(p_dq, reps=2, warmup=1),
                     f"{prefix}_bwd_dkv": time_ms(p_dkv, reps=2, warmup=1)}
            lib = {f"{prefix}_fwd": lib_fwd, f"{prefix}_bwd_dq": lib_bwd, f"{prefix}_bwd_dkv": lib_bwd}
            err_of = {f"{prefix}_fwd": errs["out"], f"{prefix}_bwd_dq": max_err(ours[2], ref[2]) if not flat
                      else max_err(ours[2][:, :, :real_len], ref[2][:, :, :real_len]),
                      f"{prefix}_bwd_dkv": max(max_err(ours[3], ref[3]), max_err(ours[4], ref[4]))}
            for name in t:
                tot = totals[name]
                tot["ms"] += t[name]
                tot["wrapper_ms"] += wrapper[name]
                tot["plain_ms"] += plain[name]
                tot["library_ms"] += lib[name]
                tot["bound_ms"] += bounds[name][0]
                tot["exp2_floor_ms"] += exp2_floor
                tot["err"] = max(tot["err"], err_of[name])
                tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + bounds[name][0]
            record.update(ms=t, wrapper_ms=wrapper, plain_ms=plain,
                          library_ms_sdpa={"fwd": lib_fwd, "bwd": lib_bwd},
                          bound_ms={k_: b[0] for k_, b in bounds.items()}, admitted_pairs=pairs,
                          exp2_floor_ms=exp2_floor,
                          bound_by={k_: b[1] for k_, b in bounds.items()})
        records.append(record)
        del ours, ref, args
    for tot in totals.values():
        tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0] if tot["by"] else "operations"
    emit("flash_kernels", dtype=dname, B=B, real_len=real_len, valid=None if valid is None else valid.tolist(),
         schedule=BHLD_SCHEDULE, branches=records, tolerance={"out": KERNEL_TOL[dname], "lse": LSE_TOL[dname],
                                                               "grads_rel": BWD_REL_TOL[dname]},
         **({"per_layer": totals, "note": "sums over the layer's branches (flat: r = 1; segmented: r = 2, 4, 6, "
             "12); library_ms is one SDPA call with the boolean key mask per branch (its backward for dq and "
             "dkv, CUDA events); ms: the kernel's device time, from a CUDA graph of 20 calls; wrapper_ms: one "
             "call's CUDA-event time, the wrapper's host work included; exp2_floor_ms: one exp2 per admitted "
             "pair at 16 a clock per SM",
             "sm_clock_mhz": _MUFU.get("sm_clock_mhz")} if timed else {}))
    return totals


def phase_flash_kernels():
    """Rows 11-14 against their plain versions on the card: the five
    head-major branches of one flagship layer at ratios [1, 2, 4, 6, 12],
    fp32 and bf16, full length (timed) and with a ragged real length; the
    B = 2 ragged batch's runtime counts (the r = 1 branch on the segmented
    kernel); a causal case of each layout; flash_attention and
    partial_attention on [1, 10241, 16, 48] with [B, H] valid counts
    against attention_with_lse."""
    import torch

    from gigapath_tpu_torch.ops import dilated_attention as pda
    from gigapath_tpu_torch.ops import flash_kernels as fk

    # bf16 tensors take the tensor-core kernels, fp32 the FMA ones
    sass = {name: _sass_counts(name, GP_HEAD_DIM=E // H) for name in FLASH_SOURCES}
    emit("flash_kernels", sass=sass, note="cuobjdump -sass at D = 48: HMMA is mma.sync (the bf16 kernels)",
         tensor_core_ptxas={name: _mma_ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in FLASH_SOURCES})
    for name, counts in sass.items():
        check(counts["HMMA"] > 0, f"{name}: no HMMA in its SASS {counts}")
    gen = torch.Generator(device="cuda").manual_seed(31)
    _row_bound_canary(fk, pda, gen)
    _refused_flash_inputs(fk)
    L = N_TILES + 1
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        summary[dname] = _flash_layer(fk, pda, 1, dtype, gen, L, None, timed=True)
        _flash_layer(fk, pda, 1, dtype, gen, L - 37, None, timed=False)
        _flash_layer(fk, pda, 2, dtype, gen, L, torch.tensor([L, 7002], device="cuda"), timed=False)

    # causal, both layouts, at flagship-width shapes: fp32 on the FMA
    # kernels, bf16 on the backward's tensor-core kernels
    causal_errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        errs = causal_errs[dname] = {}
        q5, k5, v5, d5 = (torch.randn(1, H, 2, 700, E // H, device="cuda", generator=gen).to(dtype) for _ in range(4))
        kvlen = torch.tensor([[[700, 513]] * H], dtype=torch.int32, device="cuda")
        args = (q5, k5, v5, d5, kvlen)
        errs["segmented"] = _check_flash("causal segmented", dname, False,
                                         _flash_fwd_bwd(fk, False, args, causal=True),
                                         _flash_fwd_bwd(fk, False, args, causal=True, plain=True), args=args)
        qf, kf, vf, df = (torch.randn(1, H, 2500, E // H, device="cuda", generator=gen).to(dtype) for _ in range(4))
        args = (qf, kf, vf, df, (1024, 2400))
        ours = _flash_fwd_bwd(fk, True, args, causal=True)
        errs["flat"] = _check_flash("causal flat", dname, True, ours,
                                    _flash_fwd_bwd(fk, True, args, causal=True, plain=True), dq_rows=2400,
                                    args=args)
        _flat_rows_add_nothing(fk, f"causal flat {dname}", args, ours, causal=True)
    emit("flash_causal", max_err=causal_errs, tolerance={d: BWD_REL_TOL[d] for d in causal_errs})
    _flash_entry_points(fk, gen)
    return summary


def _row_bound_canary(fk, pda, gen):
    """The bf16 forward writes its segments' own rows and no others:
    ``gp_flash_fwd`` called directly on the flagship layer's flat r = 1
    branch (L = 10241 in segments of 1024, the last one of one row) and
    segmented r = 12 branch (segments of m = 854 rows, 13 query tiles and
    22 rows), into out and lse buffers one 64-row tile longer than the
    tensor and filled with NaN: every element past the tensor stays NaN,
    and the rows inside equal the wrapper's output bit for bit."""
    import torch

    from gigapath_tpu_torch.ops import _build

    L, D = N_TILES + 1, E // H
    qh, kh, vh = (torch.randn(1, H, L, D, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    lib = _build.library("flash_fwd", GP_HEAD_DIM=D)
    results = {}
    for sl, r in ((1024, 1), (1048576, 12)):
        flat, (q, k, v, _, extra), geom = _flash_branch(fk, pda, qh, kh, vh, qh, sl, r, L, None)
        if flat:
            want_out, want_lse = fk.flat_fwd(q, k, v, *extra)
            layout, kv_ptr = fk._flat_layout("canary", q, *extra), 0
        else:
            want_out, want_lse = fk.flash_fwd(q, k, v, extra)
            layout, kv_ptr = fk._segmented_layout(q, k), 0 if extra is None else extra.data_ptr()
        n_out, n_rows = q.numel(), q.numel() // D
        out = torch.full((n_out + 64 * D,), float("nan"), dtype=torch.bfloat16, device="cuda")
        lse = torch.full((n_rows + 64,), float("nan"), dtype=torch.float32, device="cuda")
        with torch.cuda.device(q.device):
            rc = lib.gp_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr, out.data_ptr(), lse.data_ptr(),
                                  1, *layout, 0, D**-0.5 * fk.LOG2E, fk.cuda_stream(q))
        check(rc == 0, f"canary r={r}: gp_flash_fwd returned {rc}")
        torch.cuda.synchronize()
        label = "flat" if flat else "segmented"
        check(bool(torch.isnan(out[n_out:]).all()) and bool(torch.isnan(lse[n_rows:]).all()),
              f"canary {label} r={r}: the bf16 forward wrote past the tensor's last row")
        check(torch.equal(out[:n_out].view_as(want_out), want_out) and
              torch.equal(lse[:n_rows].view_as(want_lse), want_lse),
              f"canary {label} r={r}: the rows inside differ from the wrapper's")
        last_segment = L - (layout[1] - 1) * geom[0] if flat else geom[4]  # rows
        results[f"{label} r={r}"] = {"shape": list(q.shape), "rows_in_last_query_tile": last_segment % 64}
    emit("flash_row_bound_canary", dtype="bfloat16", tail_rows=64, branches=results,
         note="out/lse one 64-row tile past the tensor, NaN-filled, stayed NaN; rows inside bit-equal to the wrapper")


def _refused_flash_inputs(fk):
    """bf16 tensors the tensor-core segment-flash forward cannot take raise
    in both wrappers: a head width that is no multiple of 8, a q that is
    not 16-byte aligned; no plain version runs on the card."""
    import torch

    narrow = torch.zeros(1, 1, 1, 64, 20, dtype=torch.bfloat16, device="cuda")
    shifted = torch.zeros(64 * 48 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, 1, 1, 64, 48)
    ok = shifted.clone()
    flat = lambda x: x.view(1, 1, 64, x.shape[-1])  # noqa: E731
    refused = []
    for label, q, kv in (("D=20", narrow, narrow), ("misaligned q", shifted, ok)):
        for name, call in (("flash_fwd", lambda: fk.flash_fwd(q, kv, kv)),
                           ("flat_fwd", lambda: fk.flat_fwd(flat(q), flat(kv), flat(kv), 64, 64))):
            try:
                call()
            except ValueError:
                refused.append(f"{name} {label}")
                continue
            raise AssertionError(f"{name} took bf16 tensors with {label}")
    emit("flash_kernels_refused_inputs", refused=refused)


def _flash_entry_points(fk, gen):
    """flash_attention and partial_attention (kernel) against
    attention_with_lse (plain) on [1, 10241, 16, 48] with [B, H] valid
    counts on the card, fp32; each one flash_fwd launch."""
    import torch

    from gigapath_tpu_torch.ops.attention import attention_with_lse
    from gigapath_tpu_torch.ops.flash_attention import flash_attention, partial_attention

    L = N_TILES + 1
    q, k, v = (torch.randn(1, L, H, E // H, device="cuda", generator=gen) for _ in range(3))
    counts = torch.randint(1, L + 1, (1, H), device="cuda", generator=gen).to(torch.int32)
    counts[0, 0] = L
    results = {}
    for name, fn, kk, vv, cnt in (
        ("flash_attention", flash_attention, k, v, counts),
        ("partial_attention", partial_attention, k[:, : L // 2], v[:, : L // 2], (counts // 2).clamp_min(1)),
    ):
        fk.reset_launch_counts()
        out, lse = fn(q, kk, vv, kv_valid_len=cnt)
        torch.cuda.synchronize()
        launches = dict(fk.LAUNCHES)
        check(launches["flash_fwd"] == 1 and sum(launches.values()) == 1, f"{name} launches {launches}")
        ref_out, ref_lse = attention_with_lse(q, kk, vv, kv_valid_len=cnt)
        torch.testing.assert_close(out, ref_out, **KERNEL_TOL["float32"])
        torch.testing.assert_close(lse, ref_lse, **LSE_TOL["float32"])
        results[name] = {"Lk": kk.shape[1], "max_abs_err": {"out": max_err(out, ref_out), "lse": max_err(lse, ref_lse)},
                         "ms": time_ms(lambda: fn(q, kk, vv, kv_valid_len=cnt), reps=5)}
        del out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    emit("flash_entry_points", dtype="float32", shape=[1, L, H, E // H], vs="attention_with_lse",
         tolerance={"out": KERNEL_TOL["float32"], "lse": LSE_TOL["float32"]}, **results)


def _bhld_model(dtype):
    from gigapath_tpu_torch.models.slide_encoder import create_model

    return create_model("", "gigapath_slide_enc12l768d", dtype=dtype, seed=0, dilated_ratio=BHLD_RATIOS)


def phase_bhld_forward():
    """The flagship with ratios [1, 2, 4, 6, 12] through
    run_inference_with_slide_encoder on 10240 tiles, fp32 and bf16: the
    head-major route's exact launches (the warning given once), each layer's
    embedding against the same model on the plain versions, ms per slide,
    peak memory above the model and a profiler breakdown (bf16); then a B =
    2 ragged batch, each row against its slide alone."""
    import warnings

    import numpy as np
    import torch

    from gigapath_tpu_torch.ops import dilated_attention as pda
    from gigapath_tpu_torch.ops import flash_kernels as fk
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    gen = torch.Generator(device="cuda").manual_seed(32)
    x, coords = _flagship_inputs(1, gen)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        model = _bhld_model(dtype)
        pda._WARNED.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_inference_with_slide_encoder(x, coords, model)  # warm-up
            torch.cuda.synchronize()
            reset_all_launch_counts()
            out = run_inference_with_slide_encoder(x, coords, model)
        counts = all_launch_counts()
        n_warn = sum("head-major" in str(w.message) for w in caught)
        check(n_warn == 1, f"{dname}: {n_warn} head-major warnings in two forwards, not 1")
        want = {**dict.fromkeys(counts, 0), **BHLD_FWD_LAUNCHES}
        check(counts == want, f"{dname} head-major forward launches {counts} != {want}")
        torch.cuda.synchronize()
        _reset_peak()
        base = torch.cuda.memory_allocated()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_inference_with_slide_encoder(x, coords, model)  # ends in a device->host copy
            secs.append(time.perf_counter() - t0)
        peak = (_peak() - base) / 2**30
        with plain_flash_kernels():
            ref = run_inference_with_slide_encoder(x, coords, model)
        per_layer = []
        for a, b in zip(_embeds(out), _embeds(ref)):
            check(a.shape == (1, E) and np.isfinite(a).all(), f"{dname}: bad embedding {a.shape}")
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            one_minus_cos = 1.0 - float(_cosines(a, b)[0])
            per_layer.append({"rel": rel, "one_minus_cos": one_minus_cos})
            if dname == "float32":
                check(rel <= BHLD_F32_REL_TOL, f"fp32 head-major embedding rel err {rel} > {BHLD_F32_REL_TOL}")
            else:
                check(one_minus_cos <= BF16_MAX_ONE_MINUS_COS,
                      f"bf16 head-major embedding 1 - cosine {one_minus_cos} > {BF16_MAX_ONE_MINUS_COS}")
        ms = statistics.median(secs) * 1e3
        record = dict(dtype=dname, tiles=N_TILES, ratios=BHLD_RATIOS, launches=counts, warnings=n_warn,
                      ms_per_slide=ms, runs_ms=[s_ * 1e3 for s_ in secs], tiles_per_s=N_TILES / (ms / 1e3),
                      peak_mem_gb_above_model=peak, vs_plain=per_layer,
                      tolerance={"float32": f"rel <= {BHLD_F32_REL_TOL}",
                                 "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname])
        if dname == "bfloat16":
            with torch.inference_mode():
                record["forward_trace"] = _profile(lambda: run_inference_with_slide_encoder(x, coords, model))
            record["peak_breakdown"] = _peak_breakdown(lambda: run_inference_with_slide_encoder(x, coords, model))
        emit("bhld_forward", **record)
        result[dname] = record
        del model
        torch.cuda.empty_cache()

    # a B = 2 ragged batch: per-row valid lengths put the r = 1 branch on the
    # segmented kernel with counts formed on the card
    x2, coords2 = _flagship_inputs(2, gen)
    n_valid = [N_TILES, 7001]
    pad_mask = torch.arange(N_TILES, device="cuda")[None] < torch.tensor(n_valid, device="cuda")[:, None]
    model = _bhld_model(torch.float32)
    reset_all_launch_counts()
    batch = run_inference_with_slide_encoder(x2, coords2, model, pad_mask=pad_mask)
    counts = all_launch_counts()
    want = {**dict.fromkeys(counts, 0), **BHLD_RAGGED_LAUNCHES}
    check(counts == want, f"head-major ragged batch launches {counts} != {want}")
    worst = 0.0
    for row, n in enumerate(n_valid):
        alone = run_inference_with_slide_encoder(x2[row, :n], coords2[row, :n], model)
        for a, b in zip(_embeds(batch), _embeds(alone)):
            worst = max(worst, float(np.abs(a[row] - b[0]).max() / max(np.abs(b[0]).max(), 1e-12)))
    check(worst <= F32_REL_TOL, f"head-major ragged batch row vs alone rel err {worst} > {F32_REL_TOL}")
    emit("bhld_ragged_batch", dtype="float32", n_valid=n_valid, launches=counts, max_rel_err=worst,
         tolerance=F32_REL_TOL)
    del model
    torch.cuda.empty_cache()
    return result


def phase_bhld_vs_fused():
    """The flagship's own schedule through the public
    dilated_attention_bhld (segment-flash kernels) against the default
    phase-major route (dilated_attention: the branch kernels), fp32 and
    bf16, stacked and streaming fusion, at L = 10241: two independent kernel
    families; both routes' ms."""
    import torch

    from gigapath_tpu_torch.ops import flash_kernels as fk
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention, dilated_attention_bhld

    gen = torch.Generator(device="cuda").manual_seed(33)
    L = N_TILES + 1
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(1, L, H, E // H, device="cuda", generator=gen).to(dtype) for _ in range(3))
        fused = dilated_attention(q, k, v, *SCHEDULE)
        record = {"dtype": dname, "L": L, "schedule": SCHEDULE}
        for streaming in (False, True):
            fk.reset_launch_counts()
            bhld = dilated_attention_bhld(q, k, v, *SCHEDULE, streaming_fusion=streaming)
            torch.cuda.synchronize()
            launches = dict(fk.LAUNCHES)
            check(launches == {**dict.fromkeys(launches, 0), "flash_fwd": 4, "flat_fwd": 1},
                  f"bhld launches {launches}")
            a, b = bhld.float().reshape(-1), fused.float().reshape(-1)
            rel = float((a - b).abs().max() / b.abs().max())
            one_minus_cos = 1.0 - float(a @ b / (a.norm() * b.norm()))
            if dname == "float32":
                check(rel <= BHLD_F32_REL_TOL, f"bhld vs fused fp32 rel err {rel} > {BHLD_F32_REL_TOL}")
            else:
                check(one_minus_cos <= BF16_MAX_ONE_MINUS_COS, f"bhld vs fused bf16 1 - cos {one_minus_cos}")
            record["streaming" if streaming else "stacked"] = {"rel": rel, "one_minus_cos": one_minus_cos}
        record["ms"] = {"bhld": time_ms(lambda: dilated_attention_bhld(q, k, v, *SCHEDULE), reps=5),
                        "fused_default": time_ms(lambda: dilated_attention(q, k, v, *SCHEDULE), reps=5)}
        emit("bhld_vs_fused", tolerance={"float32": f"rel <= {BHLD_F32_REL_TOL}",
                                         "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname], **record)
        del q, k, v, fused, bhld
        torch.cuda.empty_cache()


def phase_bhld_step():
    """The fine-tune step at ratios [1, 2, 4, 6, 12] through
    finetune/training.py (the head and settings of finetune_step): fp32
    gradients against the plain-version step, the exact launches of one
    bf16 step, ms per step and peak memory in bf16 and fp32."""
    import torch

    from gigapath_tpu_torch.finetune.training import forward_backward, train_step

    gen = torch.Generator(device="cuda").manual_seed(34)
    x, coords = _flagship_inputs(1, gen)
    labels = torch.tensor([[4]], device="cuda")
    pad_mask = torch.ones(1, N_TILES, dtype=torch.bool, device="cuda")
    batch = (x, coords, labels, pad_mask)
    model, steps, loss_fn = _head_and_steps(torch, dilated_ratio=BHLD_RATIOS)

    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with plain_flash_kernels() if plain else contextlib.nullcontext():
            loss = forward_backward(model, loss_fn, *batch, multi_label=False, bf16=False)
        runs.append((float(loss), _grads(model)))
    (loss_k, g_k), (loss_p, g_p) = runs
    check(set(g_k) == set(g_p), "the two paths reach different parameters")
    floor = 1e-2 * max(float(g.abs().max()) for g in g_p.values())
    errs = {}
    for name, gp in g_p.items():
        gk = g_k[name].float()
        check(bool(torch.isfinite(gk).all()), f"head-major step: non-finite gradient {name}")
        errs[name] = float((gk - gp.float()).abs().max()) / max(float(gp.abs().max()), floor)
    worst_name, worst = max(errs.items(), key=lambda kv: kv[1])
    check(worst <= GRAD_F32_REL_TOL, f"head-major fp32 step gradient {worst_name}: {worst} > {GRAD_F32_REL_TOL}")
    model.zero_grad(set_to_none=True)

    train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)  # warm-up
    torch.cuda.synchronize()
    reset_all_launch_counts()
    train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    want = {**dict.fromkeys(counts, 0), **BHLD_STEP_LAUNCHES}
    check(counts == want, f"head-major step launches {counts} != {want}")

    timing = {}
    for dname, bf16 in (("bfloat16", True), ("float32", False)):
        _reset_peak()
        train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=bf16)
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=bf16)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ms = statistics.median(secs) * 1e3
        timing[dname] = {"ms_per_step": ms, "runs_ms": [s_ * 1e3 for s_ in secs],
                         "peak_mem_gb": _peak() / 2**30}
    # where a bf16 step's time goes: device busy against the window, the
    # kernels with the most device time
    timing["bfloat16"]["profile"] = _profile(
        lambda: train_step(model, loss_fn, steps, *batch, multi_label=False, bf16=True), top=10)
    emit("bhld_step", tiles=N_TILES, ratios=BHLD_RATIOS, launches=counts,
         grads_fp32={"param": worst_name, "err": worst, "tolerance": GRAD_F32_REL_TOL,
                     "loss_kernels": loss_k, "loss_plain": loss_p}, **timing)
    del model, steps
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the pipelined branch kernels (rows 6 and 8): the kernels, the forward on
# both phase-major routes and through a blessed plan, the fine-tune step
# ---------------------------------------------------------------------------


def _one_minus_cos(a, b) -> float:
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return 1.0 - float(a @ b / (a.norm() * b.norm() + 1e-30))


def _pipe_branch(dk, q, k, v, do, sl, r, real_len, valid, timed: bool):
    """The three pipelined kernels on one flagship branch of dense q, k, v,
    do [B, L, E] against their plain versions (forward KERNEL_TOL and
    LSE_TOL, gradients BWD_REL_TOL, as rows 1 and 7) and against their
    serial twins on the same inputs (fp32: KERNEL_TOL; bf16: 1 - cosine
    within the route limit, since the roundings differ on purpose);
    returns the record and, when ``timed``, each kernel's numbers."""
    import torch
    import torch.nn.functional as F

    B, L, _ = q.shape
    dname = str(q.dtype).replace("torch.", "")
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, valid, q.device)
    check(kvlen.device.type == "cuda", "the count table is not on the card")
    q6, k6, v6, do6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v, do))
    out6, lse5 = dk.dilated_branch_fwd_pipe(q6, k6, v6, kvlen)
    out_ref, lse_ref = dk.dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out6).all()), f"fwd_pipe {dname} r={r}: non-finite out")
    torch.testing.assert_close(out6[..., :m, :], out_ref[..., :m, :], **KERNEL_TOL[dname])
    covered = lse_ref > -1e19
    torch.testing.assert_close(lse5[covered], lse_ref[covered], **LSE_TOL[dname])
    check(bool((lse5[~covered] <= -1e19).all()), f"fwd_pipe {dname} r={r}: uncovered lse above -1e19")
    errs = {"out": max_err(out6[..., :m, :], out_ref[..., :m, :]),
            "lse_covered": max_err(lse5[covered], lse_ref[covered])}
    delta = (do6.float() * out6.float()).sum(-1)
    args = (q6, k6, v6, do6, lse5, delta, kvlen)
    grads = (dk.dilated_branch_bwd_dq_pipe(*args), *dk.dilated_branch_bwd_dkv_pipe(*args))
    for gname, ours, want in zip(("dq", "dk", "dv"), grads, dk.dilated_branch_bwd_pipe_reference(*args)):
        check(bool(torch.isfinite(ours).all()), f"bwd_pipe {dname} r={r}: non-finite {gname}")
        err = _grad_rel_err(ours[..., :m, :], want[..., :m, :])
        check(err <= BWD_REL_TOL[dname], f"bwd_pipe {dname} sl={sl} r={r}: {gname} rel err {err}")
        errs[gname] = max_err(ours[..., :m, :], want[..., :m, :])
        errs[gname + "_rel"] = err
    key_pad = torch.arange(Mp, device="cuda")[None, None, None, None, :] >= kvlen[..., None, None]
    for gname, x6 in (("dk", grads[1]), ("dv", grads[2])):
        check(not bool(x6[key_pad.expand_as(x6[..., 0])].any()), f"bwd_pipe r={r}: {gname} past kvlen not 0")

    # the serial twins on the same inputs
    out_s, lse_s = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    args_s = (q6, k6, v6, do6, lse_s, (do6.float() * out_s.float()).sum(-1), kvlen)
    serial = (out_s, dk.dilated_branch_bwd_dq(*args_s), *dk.dilated_branch_bwd_dkv(*args_s))
    vs_serial = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out6, *grads), serial):
        a, b = a[..., :m, :], b[..., :m, :]
        if dname == "float32":
            torch.testing.assert_close(a, b, **KERNEL_TOL[dname])
            vs_serial[name] = max_err(a, b)
        else:
            vs_serial[name] = _one_minus_cos(a, b)
            check(vs_serial[name] <= BF16_MAX_ONE_MINUS_COS,
                  f"bf16 pipelined vs serial r={r} {name}: 1 - cosine {vs_serial[name]}")
    if dname == "float32":
        torch.testing.assert_close(lse5[covered], lse_s[covered], **LSE_TOL[dname])
    record = {"dtype": dname, "B": B, "sl": sl, "r": r, "S": S, "m": m, "Mp": Mp, "real_len": real_len,
              "valid": None if valid is None else valid.tolist(), "max_err_vs_plain": errs,
              # dK takes the plain q and S^T the rounded one: a wrong q in
              # either shows first in dk's error against the plain version
              "dk_rel_vs_plain": {"value": errs["dk_rel"], "limit": BWD_REL_TOL[dname]},
              "vs_serial": vs_serial, "vs_serial_metric": "max |err|" if dname == "float32" else "1 - cosine"}
    if not timed:
        return record, None
    fns = {"dilated_branch_fwd_pipe": lambda: dk.dilated_branch_fwd_pipe(q6, k6, v6, kvlen),
           "dilated_branch_bwd_dq_pipe": lambda: dk.dilated_branch_bwd_dq_pipe(*args),
           "dilated_branch_bwd_dkv_pipe": lambda: dk.dilated_branch_bwd_dkv_pipe(*args)}
    twins = {"dilated_branch_fwd_pipe": lambda: dk.dilated_branch_fwd(q6, k6, v6, kvlen),
             "dilated_branch_bwd_dq_pipe": lambda: dk.dilated_branch_bwd_dq(*args),
             "dilated_branch_bwd_dkv_pipe": lambda: dk.dilated_branch_bwd_dkv(*args)}
    plains = {"dilated_branch_fwd_pipe": lambda: dk.dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen),
              "dilated_branch_bwd_dq_pipe": lambda: dk.dilated_branch_bwd_pipe_reference(*args, dkv=False),
              "dilated_branch_bwd_dkv_pipe": lambda: dk.dilated_branch_bwd_pipe_reference(*args, dq=False)}
    hb = H // r
    qs, ks, vs = (x.reshape(B * S * r, hb, Mp, E // H).detach().requires_grad_() for x in (q6, k6, v6))
    key_ok = (torch.arange(Mp, device="cuda")[None] < kvlen.reshape(-1, 1))[:, None, None, :]
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok), reps=5)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=key_ok)
    lib_do = do6.reshape(lib_out.shape)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), lib_do, retain_graph=True), reps=5)
    fwd_bound, flops = _declared_bound(dk.dilated_branch_fwd_pipe, dname, q6, k6, v6, kvlen)
    pairs = flops / (4 * (E // H))
    bounds = {"dilated_branch_fwd_pipe": fwd_bound,
              "dilated_branch_bwd_dq_pipe": _declared_bound(dk.dilated_branch_bwd_dq_pipe, dname, *args)[0],
              "dilated_branch_bwd_dkv_pipe": _declared_bound(dk.dilated_branch_bwd_dkv_pipe, dname, *args)[0]}
    numbers = {}
    for name in PIPE_KERNELS:  # device times from CUDA graphs, the wrapper's CUDA-event time beside
        numbers[name] = {
            "ms": graph_ms(fns[name]), "wrapper_ms": time_ms(fns[name]), "serial_ms": graph_ms(twins[name]),
            "exp2_floor_ms": _exp2_floor_ms(pairs), "plain_ms": time_ms(plains[name], reps=2, warmup=1),
            "library_ms": lib_fwd if name == "dilated_branch_fwd_pipe" else lib_bwd,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "err": errs["out"] if name == "dilated_branch_fwd_pipe" else (
                errs["dq"] if name == "dilated_branch_bwd_dq_pipe" else max(errs["dk"], errs["dv"])),
        }
    record["per_kernel"] = numbers
    return record, numbers


def _many_cells_pipe(dk):
    """The three pipelined kernels past 65535 cells (64 slides of 8192
    tokens in 64-token segments, r = 1, bf16, per-row valid lengths, row 0
    with none: out and gradients exactly 0 there) against their plain
    versions."""
    import torch

    B, L, sl, r = 64, 8192, 64, 1
    gen = torch.Generator(device="cuda").manual_seed(44)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    cells = B * S * r * (H // r)
    check(cells > 65535, f"many-cells check has only {cells} cells")
    q6, k6, v6, do6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
    valid = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    valid[0] = 0
    kvlen = dk._branch_kvlen(B, S, g, r, m, L, valid, q6.device)
    out6, lse5 = dk.dilated_branch_fwd_pipe(q6, k6, v6, kvlen)
    out_ref, lse_ref = dk.dilated_branch_fwd_pipe_reference(q6, k6, v6, kvlen)
    torch.testing.assert_close(out6, out_ref, **KERNEL_TOL["bfloat16"])
    covered = lse_ref > -1e19
    torch.testing.assert_close(lse5[covered], lse_ref[covered], **LSE_TOL["bfloat16"])
    check(not bool(out6[~covered].any()), "pipe many cells: fully masked rows not 0")
    delta = (do6.float() * out6.float()).sum(-1)
    args = (q6, k6, v6, do6, lse5, delta, kvlen)
    grads = (dk.dilated_branch_bwd_dq_pipe(*args), *dk.dilated_branch_bwd_dkv_pipe(*args))
    errs = {"out": max_err(out6, out_ref)}
    for gname, ours, want in zip(("dq", "dk", "dv"), grads, dk.dilated_branch_bwd_pipe_reference(*args)):
        errs[gname] = _grad_rel_err(ours, want)
        check(errs[gname] <= BWD_REL_TOL["bfloat16"], f"pipe many cells: {gname} rel err {errs[gname]}")
        check(bool(torch.isfinite(ours).all()), f"pipe many cells: non-finite {gname}")
        check(not bool(ours[0].any()), f"pipe many cells: {gname} of the row with no valid key not 0")
    emit("pipe_kernels_many_cells", dtype="bfloat16", B=B, L=L, sl=sl, r=r, cells=cells, empty_rows=1,
         max_err=errs, tolerance={"out": KERNEL_TOL["bfloat16"], "grads_rel": BWD_REL_TOL["bfloat16"]})


def phase_pipe_kernels():
    """Rows 6 and 8 on the card: the five branches of one flagship layer
    (L = 10241), fp32 and bf16, at full length (timed: per-layer sums of the
    kernel's device time, its wrapper's, its serial twin's, its plain
    version and SDPA with the key mask, and its backward, beside the bound
    and the exp2 floor) and at a ragged real length; a B = 2 batch with
    per-row valid counts formed on the card; past 65535 cells."""
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    _fwd_sass()

    L = N_TILES + 1
    gen = torch.Generator(device="cuda").manual_seed(41)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        totals = {name: dict(ms=0.0, wrapper_ms=0.0, serial_ms=0.0, plain_ms=0.0, bound_ms=0.0, exp2_floor_ms=0.0,
                             library_ms=0.0, err=0.0, by={})
                  for name in PIPE_KERNELS}
        dk_rel = 0.0  # dk's largest relative error against the plain version, every case
        for B, real_len, valid, timed in ((1, L, None, True), (1, L - 37, None, False),
                                          (2, L, torch.tensor([L, 7002], device="cuda"), False)):
            q, k, v, do = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(4))
            for sl, r in zip(*SCHEDULE):
                record, numbers = _pipe_branch(dk, q, k, v, do, sl, r, real_len, valid, timed)
                emit("pipe_kernels", **record)
                dk_rel = max(dk_rel, record["dk_rel_vs_plain"]["value"])
                for name, num in (numbers or {}).items():
                    tot = totals[name]
                    for key in ("ms", "wrapper_ms", "serial_ms", "plain_ms", "bound_ms", "exp2_floor_ms", "library_ms"):
                        tot[key] += num[key]
                    tot["err"] = max(tot["err"], num["err"])
                    tot["by"][num["bound_by"]] = tot["by"].get(num["bound_by"], 0.0) + num["bound_ms"]
            del q, k, v, do
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
            tot["vs_serial"] = tot["ms"] / tot["serial_ms"]
        summary[dname] = totals
        emit("pipe_kernels_per_layer", dtype=dname, kernels=totals,
             dk_rel_vs_plain={"max": dk_rel, "limit": BWD_REL_TOL[dname]},
             note="sum over the 5 branches of one layer at full length; ms is the kernel's device time from a "
                  "CUDA graph of 20 calls, wrapper_ms one call's CUDA-event time; serial_ms is the serial twin "
                  "(rows 1, 7a, 7b) on the same inputs, device time; exp2_floor_ms: one exp2 per admitted pair "
                  "at 16 a clock per SM; library_ms is SDPA with the key mask, and its backward (dq, dk, dv) "
                  "for dq and dkv")
    _many_cells_pipe(dk)
    return summary


def _vs_serial(dname, got, want, what: str) -> list:
    """Each layer's embedding against the serial route's: fp32 rel within
    F32_REL_TOL, bf16 1 - cosine within BF16_MAX_ONE_MINUS_COS."""
    import numpy as np

    per_layer = []
    for a, b in zip(_embeds(got), _embeds(want)):
        check(a.shape == (1, E) and np.isfinite(a).all(), f"{what} {dname}: bad embedding {a.shape}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
        one_minus_cos = 1.0 - float(_cosines(a, b)[0])
        per_layer.append({"rel": rel, "one_minus_cos": one_minus_cos})
        if dname == "float32":
            check(rel <= F32_REL_TOL, f"{what} fp32 vs the serial route: rel err {rel} > {F32_REL_TOL}")
        else:
            check(one_minus_cos <= BF16_MAX_ONE_MINUS_COS,
                  f"{what} bf16 vs the serial route: 1 - cosine {one_minus_cos} > {BF16_MAX_ONE_MINUS_COS}")
    return per_layer


def phase_pipe_forward():
    """The flagship through run_inference_with_slide_encoder on 10240 tiles,
    fp32 and bf16, with GIGAPATH_PIPELINED_ATTN=1 on the default route
    (exactly 60 pipelined forwards, 0 serial) and on the stream-fusion route
    (60 and 12 epilogues), then with no flag and a plan blessed by the
    port's bless_plan that pipelines only the r = 1 branch (12 + 48); each
    layer's embedding against the serial default route; ms per slide, peak
    memory above the model and (bf16) a profiler breakdown of the serial
    and the pipelined forward, with the card's idle share."""
    import torch

    from gigapath_tpu_torch import plan as tplan
    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    gen = torch.Generator(device="cuda").manual_seed(42)
    x, coords = _flagship_inputs(1, gen)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        model = create_model("", "gigapath_slide_enc12l768d", dtype=dtype, seed=0)
        serial = run_inference_with_slide_encoder(x, coords, model)
        record = {"dtype": dname, "tiles": N_TILES}
        for route, env, want in (("pipelined", PIPE_FWD_ENV, PIPE_FWD_LAUNCHES),
                                 ("pipelined_stream_fusion", {**PIPE_FWD_ENV, **FUSION_ENV},
                                  PIPE_FUSION_FWD_LAUNCHES)):
            with env_flags(env):
                run_inference_with_slide_encoder(x, coords, model)  # warm-up
                torch.cuda.synchronize()
                dk.reset_launch_counts()
                out = run_inference_with_slide_encoder(x, coords, model)
                counts = dict(dk.LAUNCHES)
            check(counts == want, f"{dname} {route} forward launches {counts} != {want}")
            record[route] = {"launches": counts, "vs_serial": _vs_serial(dname, out, serial, route)}
        # a plan blessed with the port's own writer, no flag set: only the
        # r = 1 branch's forward goes pipelined
        with tempfile.TemporaryDirectory() as reg_dir:
            path = f"{reg_dir}/PLAN_REGISTRY.json"
            with env_flags({"GIGAPATH_PLAN_REGISTRY": path}):
                tplan.reset_plan_state()
                qkv = torch.empty(1, N_TILES + 1, H, E // H, dtype=dtype, device="meta")
                key = tplan.geometry_key("dilated_attention", (qkv, qkv, qkv))
                tplan.bless_plan(key, tplan.ExecutionPlan(branches=(PIPE_PLAN_BRANCH,)).as_dict(),
                                 provenance={"by": "chip_smoke"})
                run_inference_with_slide_encoder(x, coords, model)  # warm-up
                torch.cuda.synchronize()
                dk.reset_launch_counts()
                tplan.reset_plan_state()
                out = run_inference_with_slide_encoder(x, coords, model)
                counts, stats = dict(dk.LAUNCHES), tplan.plan_stats()
            tplan.reset_plan_state()
        check(counts == PIPE_PLAN_LAUNCHES, f"{dname} planned forward launches {counts} != {PIPE_PLAN_LAUNCHES}")
        check(stats["hits"] == 12, f"{dname} planned forward: plan hits {stats} (one per layer expected)")
        record["plan"] = {"key": key, "branch": PIPE_PLAN_BRANCH, "launches": counts, "plan_stats": stats,
                          "vs_serial": _vs_serial(dname, out, serial, "plan")}
        record["timing"] = _timed_env_routes(model, x, coords, {
            "serial": {}, "pipelined": PIPE_FWD_ENV, "pipelined_again": PIPE_FWD_ENV, "serial_again": {}})
        if dname == "bfloat16":
            with torch.inference_mode():
                record["forward_trace"] = {}
                for route, env in (("serial", {}), ("pipelined", PIPE_FWD_ENV)):
                    with env_flags(env):
                        record["forward_trace"][route] = _profile(
                            lambda: run_inference_with_slide_encoder(x, coords, model))
        record["tolerance"] = {"float32": f"rel <= {F32_REL_TOL}",
                               "bfloat16": f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}"}[dname]
        emit("pipe_forward", **record)
        result[dname] = record
        del model
        torch.cuda.empty_cache()
    return result


def phase_pipe_step():
    """The flagship fine-tune step (feat_layer 11) with
    GIGAPATH_PIPELINED_ATTN=1 and GIGAPATH_PIPELINED_BWD=1: fp32 gradients
    against the serial route, the exact launches of one bf16 step (60 / 55
    / 55 pipelined, 0 serial forward, dq and dkv), ms per step and peak
    memory beside the serial step in the same run, in turns."""
    launches, grads, timing = _route_step(43, 5, PIPE_STEP_ENV, PIPE_STEP_LAUNCHES, {
        "serial": {}, "pipelined": PIPE_STEP_ENV, "pipelined_again": PIPE_STEP_ENV, "serial_again": {}})
    emit("pipe_step", tiles=N_TILES, launches=launches, grads_fp32=grads, bfloat16=timing)
    return launches


def phase_ffn_gelu():
    """The feed-forward GELU on the card: the activation of a bf16 fc1
    output in its own dtype against the explicit fp32 round trip, in bf16
    ulps of the larger value, at the flagship's [10241, 3072] with values
    out to +-8; fails above one ulp."""
    import torch

    from gigapath_tpu_torch.ops.feedforward import FeedForwardNetwork

    gen = torch.Generator(device="cuda").manual_seed(35)
    ffn = FeedForwardNetwork(E, 4 * E).cuda().to(torch.bfloat16)
    h = (torch.randn(N_TILES + 1, 4 * E, device="cuda", generator=gen) * 2.5).clamp(-8, 8).to(torch.bfloat16)
    a = ffn.act(h).float()
    b = ffn.act(h.float()).to(torch.bfloat16).float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    ulps = float(((a - b).abs() / ulp).max())
    differ = int((a != b).sum())
    check(ulps <= 1.0, f"bf16 GELU in its dtype differs from the fp32 round trip by {ulps} ulps")
    emit("ffn_gelu", shape=list(h.shape), dtype="bfloat16", max_ulps=ulps, elements_differing=differ,
         elements=h.numel(), tolerance="<= 1 bf16 ulp")


def _peak_breakdown(fn, top: int = 6) -> dict:
    """One ``fn()`` under ``torch.cuda.memory``'s allocation history: the
    peak of live allocations above the start, and the bytes live at that
    peak grouped by the innermost frame in ``gigapath_tpu_torch`` that
    allocated them (the snapshot's device trace replayed to its peak)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=1_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = [e for dev in snap.get("device_traces", []) for e in dev]
    if not trace:
        return {"peak": "not measured (the snapshot holds no device trace)"}

    def where(entry):
        for frame in entry.get("frames", []):
            name = frame.get("filename", "")
            if "gigapath_tpu_torch" in name:
                return f"{name.split('gigapath_tpu_torch/')[-1]}:{frame.get('line')} ({frame.get('name')})"
        return "other"

    live, total, peak, peak_at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > peak:
                peak, peak_at = total, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])
    held, by_site = {}, {}
    for e in trace[: peak_at + 1]:
        if e["action"] == "alloc":
            held[e["addr"]] = e
        elif e["action"] == "free_completed":
            held.pop(e["addr"], None)
    for e in held.values():
        site = where(e)
        by_site[site] = by_site.get(site, 0) + e["size"]
    ranked = sorted(by_site.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_gb_above_start": peak / 2**30,
            "live_at_peak_gb": [{"site": site, "gb": b / 2**30} for site, b in ranked]}


def default_route_times(reps: int = 3, dilated_ratio=None):
    """The default route's bf16 forward per 10240-tile slide and bf16
    fine-tune step alone, as slide_forward and finetune_step time them
    (median of ``reps`` host-clock runs, each ending in a synchronize), a
    profile of one forward and one step (device busy time, idle share),
    with the card's name and power limit: a line for comparing two trees in
    turns in one call. With ``dilated_ratio`` (e.g. ``BHLD_RATIOS``) the
    same model and head at those ratios, so the head-major route; called
    under ``env_flags(FUSION_ENV)``, the stream-fusion route. Not part of
    the smoke run; it uses only entry points every tree of the port has,
    so it can time another tree's package from that tree's root:

        python3 -c "import runpy; runpy.run_path('<this file>')['default_route_times']()"
    """
    import torch

    from gigapath_tpu_torch.finetune.training import train_step
    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    def median_ms(fn):
        fn()  # warm-up
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs) * 1e3, [x * 1e3 for x in secs]

    gen = torch.Generator(device="cuda").manual_seed(1)
    x, coords = _flagship_inputs(1, gen)
    ratio = {} if dilated_ratio is None else {"dilated_ratio": dilated_ratio}
    model = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0, **ratio)
    forward = lambda: run_inference_with_slide_encoder(x, coords, model)  # noqa: E731
    fwd_ms, fwd_runs = median_ms(forward)
    watch = COPY_KERNEL_NAMES + FUSION_KERNEL_NAMES
    with torch.inference_mode():
        fwd_profile = _profile(forward, watch=watch)
    del model, forward
    labels = torch.tensor([[3]], device="cuda")
    pad_mask = torch.ones(1, N_TILES, dtype=torch.bool, device="cuda")
    model, steps, loss_fn = _head_and_steps(torch, **ratio)
    step = lambda: train_step(model, loss_fn, steps, x, coords, labels, pad_mask,  # noqa: E731
                              multi_label=False, bf16=True)
    step_ms, step_runs = median_ms(step)
    step_profile = _profile(step, watch=watch)  # device busy, idle share, costliest kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("default_route_times", dtype="bfloat16", tiles=N_TILES, dilated_ratio=dilated_ratio,
         forward_ms_per_slide=fwd_ms, forward_runs_ms=fwd_runs, forward_profile=fwd_profile, step_ms=step_ms,
         step_runs_ms=step_runs, step_profile=step_profile, nvidia_smi=smi)


def copy_kernel_times():
    """The pack and unpack (rows 2, 3) per flagship layer (the five
    branches at L = 10241; the pack counts its q, k, v launches), fp32 and
    bf16: each kernel's device time (``graph_ms``) and one wrapper call's
    CUDA-event time, beside ``torch.take`` and ``index_copy_`` by the same
    two clocks, with the card's name and power limit. Not part of the
    smoke run; it uses only entry points every tree of the port has, so it
    times another tree's kernels from that tree's root, in turns with this
    one in one call:

        python3 -c "import runpy; runpy.run_path('<this file>')['copy_kernel_times']()"
    """
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    L = N_TILES + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_layer = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, L, E, device="cuda", generator=gen).to(dtype)
        tot, branches = {}, []
        for sl, r in zip(*SCHEDULE):
            g, S, m, Mp = dk._branch_geometry(L, sl, r)
            x6 = dk.pack_phases(x, g, S, r, Mp, H)
            dense = dk.unpack_phases(x6, L, E, g, S, r)
            times = _copy_times(dk, x, x6, x6, dense, g, S, r, Mp)
            branches.append({"r": r, **times})
            for key, ms in times.items():
                n = 3 if key in ("pack_ms", "wrapper_ms_pack", "take_ms", "take_event_ms") else 1
                tot[key] = tot.get(key, 0.0) + n * ms
        per_layer[str(dtype).replace("torch.", "")] = {"per_layer": tot, "branches": branches}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("copy_kernel_times", tiles=N_TILES, times=per_layer, nvidia_smi=smi,
         note="ms per flagship layer: pack x3 (q, k, v) + unpack x1; *_ms device time from a CUDA graph of "
              "20 calls, wrapper_ms_* and *_event_ms one call's CUDA-event time")


def fusion_kernel_times():
    """Rows 4, 9 and 10 (the direct pack and the fusion epilogue forward
    and backward) of one flagship layer by device time, bf16 and fp32 at
    10241 tokens and bf16 at 102401 (:func:`_fusion_layer_ms`: the pack
    per single-segment branch, one tensor alone and q, k, v as the tree's
    route packs them, the epilogue forward, its backward as the tree's
    route calls it, each beside its bound, and the launch floor), with the
    card's name and power limit. Not part of the smoke run; it uses only
    entry points every tree of the port has, so it times another tree's
    kernels from that tree's root, in turns with this one in one call:

        python3 -c "import runpy; runpy.run_path('<this file>')['fusion_kernel_times']()"
    """
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(23)
    layers = [_fusion_layer_ms(dk, L, dtype, gen) for L, dtype in (
        (N_TILES + 1, torch.bfloat16), (N_TILES + 1, torch.float32), (LONG_TILES + 1, torch.bfloat16))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("fusion_kernel_times", layers=layers, nvidia_smi=smi)


def epilogue_bwd_block_sizes(tokens=(16, 8, 4, 32)):
    """Row 10 built with each of ``tokens`` dense tokens a block (the
    source's ``kTokens``; the first is the source's own), each held against
    the plain version, then timed by ``graph_ms`` on the flagship layer
    (bf16 and fp32 at 10241 tokens, bf16 at 102401) in turns, ``tokens``
    then the same reversed, with the card's name and power limit. Not part
    of the smoke run:

        python3 -c "import runpy; runpy.run_path('chip_smoke.py')['epilogue_bwd_block_sizes']()"
    """
    import ctypes

    import torch

    from gigapath_tpu_torch.ops import _build
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    src = (_build.CSRC / "fusion_epilogue_bwd.cu").read_text()
    own = f"constexpr int kTokens = {tokens[0]};"
    check(own in src, f"fusion_epilogue_bwd.cu does not hold {own!r}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = []
    for n in tokens:
        path = _build.BUILD_DIR / f"fusion_epilogue_bwd_tokens{n}.cu"
        path.write_text(src.replace(own, f"constexpr int kTokens = {n};"))
        lib = path.with_suffix(".so")
        builds.append((n, lib, subprocess.Popen([_build._nvcc(), *_build._flags(()), "-o", str(lib), str(path)],
                                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    _build.build_all((("pack_phases", ()), ("dilated_branch_fwd", (("GP_HEAD_DIM", E // H),)),
                      ("fusion_epilogue_fwd", ()), ("fusion_epilogue_bwd", ())))
    symbol, argtypes = _build._SIGNATURES["fusion_epilogue_bwd"]
    libs = {}
    for n, lib, proc in builds:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"kTokens = {n}: nvcc failed\n{log}")
        libs[n] = ctypes.CDLL(str(lib))
        getattr(libs[n], symbol).argtypes = argtypes
        getattr(libs[n], symbol).restype = ctypes.c_int
    _build.library("fusion_epilogue_bwd")  # registered, then swapped below
    gen = torch.Generator(device="cuda").manual_seed(31)
    layers = []
    for L, dtype in ((N_TILES + 1, torch.bfloat16), (N_TILES + 1, torch.float32), (LONG_TILES + 1, torch.bfloat16)):
        dname = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(1, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
        plan = dk.plan_stream_fusion(L, E, H, *SCHEDULE)
        outs, lses = [], []
        for g, S, r, m, Mp in plan.branches:
            kvlen = dk._branch_kvlen(1, S, g, r, m, L, None, q.device)
            out6, lse5 = dk.dilated_branch_fwd(*(dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v)), kvlen)
            outs.append(out6)
            lses.append(lse5)
        _, fused = dk.fusion_epilogue_fwd(outs, lses, plan)
        dy = torch.randn(1, L, E, device="cuda", generator=gen).to(dtype)
        refs = dk.fusion_epilogue_bwd_reference(dy, fused, lses, plan)
        for n in tokens:
            _build._loaded["fusion_epilogue_bwd"] = libs[n]
            _check_epilogue_bwd(dk, dk.fusion_epilogue_bwd(dy, fused, lses, plan), refs, plan, f"kTokens = {n}")
        layers.append((f"{L}-{dname}", dy, fused, lses, plan))
    ms = {}
    for n in tokens + tokens[::-1]:
        _build._loaded["fusion_epilogue_bwd"] = libs[n]
        for key, dy, fused, lses, plan in layers:
            ms.setdefault(key, {}).setdefault(n, []).append(
                graph_ms(lambda: dk.fusion_epilogue_bwd(dy, fused, lses, plan)))
    _build._loaded["fusion_epilogue_bwd"] = libs[tokens[0]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("epilogue_bwd_block_sizes", ms=ms, nvidia_smi=smi,
         note="device ms of one flagship layer's row 10 (graph_ms), per kTokens, in turns")


def stream_backward_times(reps: int = 5):
    """One flagship layer's bf16 streaming attention backward alone (the
    gradients of ``streaming_dilated_attention`` over the slide's token
    blocks: 148 dq and 148 dkv launches and the folds' own work): the host
    clock of ``loss.backward()`` (median of ``reps`` runs, each after a
    fresh forward, ending in a synchronize), and the device busy time and
    idle share of one backward under ``torch.profiler`` with the device
    time of the two kernels, with the card's name and power limit. Not part
    of the smoke run; it uses only entry points every tree of the port has,
    so it times another tree's kernels from that tree's root, in turns with
    this one in one call:

        python3 -c "import runpy; runpy.run_path('<this file>')['stream_backward_times']()"
    """
    import torch

    from gigapath_tpu_torch.ops.streaming_prefill import streaming_dilated_attention

    gen = torch.Generator(device="cuda").manual_seed(14)
    D = E // H
    q, k, v, w = (torch.randn(1, STREAM_L, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(4))

    def forward():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        blocks = streaming_dilated_attention(
            *([t[:, a:b] for a, b in STREAM_BLOCKS] for t in leaves), STREAM_BLOCKS, *SCHEDULE)
        loss = sum((blk.float() * w[:, a:b].float()).sum() for blk, (a, b) in zip(blocks, STREAM_BLOCKS))
        torch.cuda.synchronize()
        return loss

    forward().backward()  # warm-up
    secs = []
    for _ in range(reps):
        loss = forward()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    profile = _profile(forward().backward, watch=STREAM_BWD_SOURCES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("stream_backward_times", dtype="bfloat16", L=STREAM_L, chunk=STREAM_CHUNK,
         backward_ms=statistics.median(secs) * 1e3, runs_ms=[x * 1e3 for x in secs], profile=profile,
         nvidia_smi=smi)


def stream_forward_times(reps: int = 5):
    """The flagship slide's bf16 streamed forward alone (10240 tiles in
    chunks of 2048 through ``run_inference_with_slide_encoder_streaming``,
    1776 ``stream_pair_fwd`` launches): the host clock of one slide (median
    of ``reps`` runs, each ending in the device->host copy), and the device
    busy time and idle share of one slide under ``torch.profiler`` with the
    device time of the pair forward (per slide; a layer is a twelfth), with
    the card's name and power limit. Not part of the smoke run; it uses only
    entry points every tree of the port has, so it times another tree's
    kernels from that tree's root, in turns with this one in one call:

        python3 -c "import runpy; runpy.run_path('<this file>')['stream_forward_times']()"
    """
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder_streaming

    gen = torch.Generator(device="cuda").manual_seed(13)
    x, coords = _flagship_inputs(1, gen)
    chunks = _slide_chunks(x, coords, range(5))
    model = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0)

    def slide():
        return run_inference_with_slide_encoder_streaming(chunks, N_TILES, model, chunk_tiles=STREAM_CHUNK)

    slide()  # warm-up
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slide()
        secs.append(time.perf_counter() - t0)
    with torch.inference_mode():
        profile = _profile(slide, watch=STREAM_KERNELS[:1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("stream_forward_times", dtype="bfloat16", tiles=N_TILES, chunk_tiles=STREAM_CHUNK,
         ms_per_slide=statistics.median(secs) * 1e3, runs_ms=[x_ * 1e3 for x_ in secs], profile=profile,
         nvidia_smi=smi)


def sass_digests(names=FWD_MMA_SOURCES + FLASH_SOURCES[1:] + BWD_MMA_SOURCES + STREAM_KERNELS,
                 head_dims=(48, 64), plain=COPY_SOURCES + FUSION_KERNELS):
    """Each kernel function's SASS in the libraries of ``names`` at
    ``head_dims`` and of ``plain`` (built without defines: the pack and
    unpack, the direct pack and unpack, the fusion epilogue forward and
    backward) (``cuobjdump -sass``), as an instruction count and a digest of
    its text: two trees' lines agree on a function exactly when its
    instructions do. Not part of the smoke run; it builds with the package
    of the directory it runs from, so it reads another tree's kernels from
    that tree's root:

        python3 -c "import runpy; runpy.run_path('<this file>')['sass_digests']()"
    """
    import hashlib

    from gigapath_tpu_torch.ops import _build

    specs = tuple((name, (("GP_HEAD_DIM", dh),)) for name in names for dh in head_dims)
    specs += tuple((name, ()) for name in plain)
    _build.build_all(specs)
    libraries = {}
    for name, defines in specs:
        # an anonymous namespace's mangled name carries a hash of its file,
        # which differs between trees: keep the name, drop the hash
        sass = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", _sass(name, defines))
        functions = {}
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            function, _, body = block.partition("\n")
            lines = [" ".join(line.split()) for line in body.splitlines() if line.strip()]
            functions[function.strip()] = {
                "instructions": sum(bool(re.match(r"/\*[0-9a-f]{4,}\*/", line)) for line in lines),
                "sha256": hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]}
        libraries[_build._label(name, defines)] = functions
    emit("sass_digests", libraries=libraries)


# ---------------------------------------------------------------------------
# 26. seq_parallel
# ---------------------------------------------------------------------------

SEQ_WORLD = 4
SEQ_LABEL = "4 ranks time-sharing one H100, collectives through gloo on the host"
# (a) one layer's op in fp32 at the flagship's heads
SEQ_OP_L = 16384
SEQ_OP_SCHEDULE = ([1024, 4096, 8192, 16384], [1, 2, 4, 8])
# (b) the flagship-width encoder in bf16, on the power-of-two schedule of
# the JAX package's recipe ([1024, 32768, 2 * local, n], scripts/
# long_context_smoke.py:run_sharded): the flagship's own schedule cannot be
# sharded (185363 and 5792 divide into no shard length)
SEQ_ENCODER_ARCH = "LongNet_12_layers_768_dim"
SEQ_ENCODER_L = 131072
SEQ_ENCODER_SCHEDULE = ([1024, 32768, 65536, 131072], [1, 2, 4, 8])
SEQ_ENCODER_VALID = 100000  # the ragged cut falls inside rank 3
SEQ_ENCODER_RUNS = tuple((mask, route) for mask in ("dense", "ragged") for route in ("gather", "ring"))
# (c) one flagship-width layer's gradients in bf16; the ring backward is
# plain torch, whose fp32 probabilities grow with the square of the local
# chunk
SEQ_GRAD_ARCH = "LongNet_1_layers_768_dim"
SEQ_GRAD_L = 32768
SEQ_GRAD_SCHEDULE = ([1024, 8192, 16384, 32768], [1, 2, 4, 8])
# the sharded op against the single-device op: fp32 max |err| / max |ref|,
# the JAX package's tier (forward 1e-5, gradients 1e-4); bf16 1 - cosine of
# each rank's output slice and of each parameter's summed gradient
SEQ_FWD_REL_TOL, SEQ_GRAD_REL_TOL = 1e-5, 1e-4
SEQ_BF16_MAX_ONE_MINUS_COS = 5e-4
SEQ_TIMED_REPS = 2
SEQ_RANK_TIMEOUT_S = 600
SEQ_COUNTED = ("pack_phases", "dilated_branch_fwd", "unpack_phases", "dilated_branch_bwd_dq",
               "dilated_branch_bwd_dkv", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _seq_launches(schedule, L: int, layers: int, ring: bool, backward: bool) -> dict:
    """Exact kernel launches of one rank's sharded call over ``layers``
    layers: a branch inside the shard runs rows 1-3 (q, k, v packed, out
    unpacked; the backward packs dout, q, k, v, runs row 7's dq and dkv
    and unpacks dq, dk, dv); a sharded branch runs row 11 once gathered,
    once per ring step ringed, and row 12's dq and dkv in a gathered
    backward (the ring's backward is plain torch). Every other kernel 0."""
    from gigapath_tpu_torch.ops import all_launch_counts

    sls, _ = schedule
    fused = sum(1 for sl in sls if sl <= L)
    rps = [sl // L for sl in sls if sl > L]
    n = dict.fromkeys(all_launch_counts(), 0)
    n.update(pack_phases=3 * fused, dilated_branch_fwd=fused, unpack_phases=fused,
             flash_fwd=sum(rps) if ring else len(rps))
    if backward:
        n.update(pack_phases=7 * fused, unpack_phases=4 * fused, dilated_branch_bwd_dq=fused,
                 dilated_branch_bwd_dkv=fused)
        if not ring:
            n.update(flash_bwd_dq=len(rps), flash_bwd_dkv=len(rps))
    return {k: v * layers for k, v in n.items()}


def _seq_counts() -> dict:
    import torch

    from gigapath_tpu_torch.ops import all_launch_counts

    torch.cuda.synchronize()
    return dict(all_launch_counts())


def _seq_ring_env(ring: bool):
    return env_flags({"GIGAPATH_RING_ATTN": "1" if ring else "0"})


def _seq_op(rank: int, group) -> dict:
    """(a) One layer's op in fp32, gathered and ringed, against the
    single-device op on the card (every rank computes it and holds its own
    slice), forward and the gradients of a seeded cotangent."""
    import torch

    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.dilated_kernels import PipelineFlags

    sls, drs = SEQ_OP_SCHEDULE
    loc = SEQ_OP_L // SEQ_WORLD
    mine = slice(rank * loc, (rank + 1) * loc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, SEQ_OP_L, H, E // H, generator=gen, device="cuda") for _ in range(4))
    full = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = dilated_attention(*full, sls, drs, flags=PipelineFlags())
    ref.backward(do)
    out = {}
    for route, ring in (("gather", False), ("ring", True)):
        local = [x[:, mine].clone().requires_grad_(True) for x in (q, k, v)]
        reset_all_launch_counts()
        o = dilated_attention(*local, sls, drs, flags=PipelineFlags(ring_attn=ring), seq_group=group)
        o.backward(do[:, mine])
        launches = _seq_counts()
        want = _seq_launches(SEQ_OP_SCHEDULE, loc, 1, ring, backward=True)
        check(launches == want, f"seq op {route} rank {rank}: launches {launches} != {want}")
        fwd = _grad_rel_err(o.detach(), ref.detach()[:, mine])
        grads = {g: _grad_rel_err(x.grad, f.grad[:, mine]) for g, x, f in zip(("dq", "dk", "dv"), local, full)}
        check(fwd <= SEQ_FWD_REL_TOL, f"seq op {route} rank {rank}: forward rel {fwd} > {SEQ_FWD_REL_TOL}")
        for g, err in grads.items():
            check(err <= SEQ_GRAD_REL_TOL, f"seq op {route} rank {rank}: {g} rel {err} > {SEQ_GRAD_REL_TOL}")
        out[route] = {"fwd_rel": fwd, "grad_rel": grads,
                      "launches": {name: launches[name] for name in SEQ_COUNTED}}
    return out


def _seq_model(arch: str, schedule, group):
    """The LongNet encoder at ``arch``'s width in bf16 on the card, its
    weights from torch's seed 0 (the same on every rank); sequence-parallel
    over ``group`` unless it is None."""
    import torch

    from gigapath_tpu_torch.models.longnet import make_longnet_from_name

    sls, drs = schedule
    torch.manual_seed(0)
    model, _ = make_longnet_from_name(arch, dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0,
                                      dropout=0.0, seq_parallel=group is not None, seq_group=group)
    return model.to("cuda", torch.bfloat16).eval()


def _seq_grads(rank: int, group) -> dict:
    """(c) One flagship-width layer in bf16: every parameter's gradient,
    summed over the ranks (in fp32), against the single-device layer's
    (rank 0), gathered and ringed, and the ring's against the gather's, by
    1 - cosine; a gradient under 1e-2 of the largest counts as held (the
    rule of ``_worst_grad_err``) and is listed."""
    import torch
    import torch.distributed as dist

    from gigapath_tpu_torch.ops import reset_all_launch_counts

    loc = SEQ_GRAD_L // SEQ_WORLD
    mine = slice(rank * loc, (rank + 1) * loc)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, dy = (torch.randn(1, SEQ_GRAD_L, E, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    model = _seq_model(SEQ_GRAD_ARCH, SEQ_GRAD_SCHEDULE, group)
    names = [n for n, _ in model.named_parameters()]
    single = None
    if rank == 0:
        ref = _seq_model(SEQ_GRAD_ARCH, SEQ_GRAD_SCHEDULE, None)
        ref.load_state_dict(model.state_dict())
        ref(x)["encoder_out"].backward(dy)
        single = {n: p.grad.float() for n, p in ref.named_parameters()}
        del ref
    summed, out = {}, {}
    for route, ring in (("gather", False), ("ring", True)):
        model.zero_grad(set_to_none=True)
        reset_all_launch_counts()
        with _seq_ring_env(ring):
            model(x[:, mine])["encoder_out"].backward(dy[:, mine])
        launches = _seq_counts()
        want = _seq_launches(SEQ_GRAD_SCHEDULE, loc, 1, ring, backward=True)
        check(launches == want, f"seq grads {route} rank {rank}: launches {launches} != {want}")
        params = dict(model.named_parameters())
        flat = torch.cat([params[n].grad.float().reshape(-1) for n in names])
        dist.all_reduce(flat, group=group)
        summed[route] = dict(zip(names, flat.split([params[n].numel() for n in names])))
        out[route] = {"launches": {name: launches[name] for name in SEQ_COUNTED}}
    if rank == 0:
        # as _worst_grad_err: a gradient under 1e-2 of the largest has no
        # direction to hold (k_proj.bias's is 0 up to rounding: a constant
        # shift of a softmax row's logits)
        floor = 1e-2 * max(float(g.abs().max()) for g in single.values())
        held = [n for n in names if float(single[n].abs().max()) > floor]
        for route in ("gather", "ring"):
            errs = {n: _one_minus_cos(summed[route][n], single[n]) for n in held}
            worst = max(errs, key=errs.get)
            check(errs[worst] <= SEQ_BF16_MAX_ONE_MINUS_COS,
                  f"seq grads {route}: {worst} 1 - cos {errs[worst]} > {SEQ_BF16_MAX_ONE_MINUS_COS}")
            out[route].update(worst_param=worst, worst_one_minus_cos=errs[worst], n_held=len(errs),
                              under_floor=sorted(set(names) - set(held)))
        ring_vs_gather = max(_one_minus_cos(summed["ring"][n], summed["gather"][n]) for n in held)
        check(ring_vs_gather <= SEQ_BF16_MAX_ONE_MINUS_COS,
              f"seq grads ring vs gather 1 - cos {ring_vs_gather} > {SEQ_BF16_MAX_ONE_MINUS_COS}")
        out["ring_vs_gather_worst_one_minus_cos"] = ring_vs_gather
    return out


def _seq_forward_ms(fn, group) -> list:
    """Host ms of ``SEQ_TIMED_REPS`` calls of ``fn()``, each started
    together on every rank (a barrier) and ended by a synchronize."""
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(SEQ_TIMED_REPS):
        torch.cuda.synchronize()
        if group is not None:
            dist.barrier(group=group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _seq_encoder(rank: int, group) -> dict:
    """(b) The flagship-width encoder in bf16, dense and with
    ``SEQ_ENCODER_VALID`` valid tokens, gathered and ringed: every rank's
    output slice against the single-device forward of the same weights
    (rank 0), the exact launches, and (e) the timings."""
    import torch
    import torch.distributed as dist

    from gigapath_tpu_torch.ops import reset_all_launch_counts

    loc = SEQ_ENCODER_L // SEQ_WORLD
    mine = slice(rank * loc, (rank + 1) * loc)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, SEQ_ENCODER_L, E, generator=gen, device="cuda").to(torch.bfloat16)
    pad = torch.zeros(1, SEQ_ENCODER_L, dtype=torch.bool, device="cuda")
    pad[:, SEQ_ENCODER_VALID:] = True
    model = _seq_model(SEQ_ENCODER_ARCH, SEQ_ENCODER_SCHEDULE, group)
    single, timing = {}, {}
    if rank == 0:
        ref = _seq_model(SEQ_ENCODER_ARCH, SEQ_ENCODER_SCHEDULE, None)
        ref.load_state_dict(model.state_dict())
        with torch.no_grad():
            for mask in ("dense", "ragged"):
                single[mask] = ref(x, encoder_padding_mask=pad if mask == "ragged" else None)["encoder_out"]
    out = {}
    for mask, route in SEQ_ENCODER_RUNS:
        ring = route == "ring"
        reset_all_launch_counts()
        with torch.no_grad(), _seq_ring_env(ring):
            o = model(x[:, mine], encoder_padding_mask=pad[:, mine] if mask == "ragged" else None)["encoder_out"]
        launches = _seq_counts()
        want = _seq_launches(SEQ_ENCODER_SCHEDULE, loc, len(model.layers), ring, backward=False)
        check(launches == want, f"seq encoder {mask} {route} rank {rank}: launches {launches} != {want}")
        check(bool(torch.isfinite(o).all()), f"seq encoder {mask} {route} rank {rank}: non-finite output")
        parts = [torch.empty_like(o) for _ in range(SEQ_WORLD)]
        dist.all_gather(parts, o.contiguous(), group=group)
        entry = {"launches": {name: launches[name] for name in SEQ_COUNTED}}
        if rank == 0:
            ref_slices = single[mask].split(loc, dim=1)
            entry["rank_one_minus_cos"] = [_one_minus_cos(p, r) for p, r in zip(parts, ref_slices)]
            worst = max(entry["rank_one_minus_cos"])
            check(worst <= SEQ_BF16_MAX_ONE_MINUS_COS,
                  f"seq encoder {mask} {route}: 1 - cos {worst} > {SEQ_BF16_MAX_ONE_MINUS_COS}")
        out[f"{mask}_{route}"] = entry
        del o, parts
    for route, ring in (("gather", False), ("ring", True)):
        def forward(ring=ring):
            with torch.no_grad(), _seq_ring_env(ring):
                model(x[:, mine])["encoder_out"]

        timing[route] = {"host_ms": _seq_forward_ms(forward, group)}
        dist.barrier(group=group)
        timing[route].update(_profile(forward, top=4))
    dist.barrier(group=group)
    if rank == 0:
        def single_forward():
            with torch.no_grad():
                ref(x)["encoder_out"]

        timing["single_device"] = {"host_ms": _seq_forward_ms(single_forward, None)}
        timing["single_device"].update(_profile(single_forward, top=4))
        del ref, single
    dist.barrier(group=group)
    out["timing"] = timing
    out["peak_memory_gb"] = _peak() / 1e9
    return out


def _seq_rank(rank: int, workdir: str) -> None:
    """One rank of ``phase_seq_parallel`` (a spawned process on ``cuda:0``):
    a gloo group over a ``FileStore`` in ``workdir``, the ``seq`` dim of a
    one-dim mesh, then (a), (c) and (b) with (e); its results go to
    ``rank{rank}.json``, a traceback to ``rank{rank}.err``."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from gigapath_tpu_torch.parallel.mesh import make_mesh

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), SEQ_WORLD),
                                rank=rank, world_size=SEQ_WORLD,
                                timeout=datetime.timedelta(seconds=SEQ_RANK_TIMEOUT_S))
        group = make_mesh(axis_sizes={"seq": SEQ_WORLD}).get_group("seq")
        out = {"backend": dist.get_backend(group), "op": _seq_op(rank, group)}
        out["grads"] = _seq_grads(rank, group)
        out["encoder"] = _seq_encoder(rank, group)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn_ranks(target, world: int, phase: str) -> list:
    """``world`` processes of ``target(rank, workdir)`` on the card, forked
    from the port's rank forkserver (never from this process, which holds
    a CUDA context; ``dryrun.run_ranks``, which raises with the ranks'
    tracebacks if one fails); each rank's ``rank{r}.json``, in rank
    order."""
    import torch

    from gigapath_tpu_torch.dryrun import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix=f"{phase}_") as work:
        run_ranks(target, world, work, timeout=SEQ_RANK_TIMEOUT_S, what=phase)
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def phase_seq_parallel() -> None:
    """Sequence parallelism (26): SEQ_WORLD rank processes on ``cuda:0``
    over a gloo group (NCCL refuses two ranks on one device), spawned after
    the build phase so that no rank builds a kernel. (a) one layer's op in
    fp32 and (c) one layer's bf16 gradients against the single-device op
    and layer, (b) the flagship-width encoder in bf16 against its
    single-device forward, (d) every rank's exact launches on each route,
    (e) the timings, labelled ``SEQ_LABEL``."""
    t_phase = time.perf_counter()
    smi = _smi()
    ranks = _spawn_ranks(_seq_rank, SEQ_WORLD, "seq_parallel")
    check(all(r["backend"] == "gloo" for r in ranks), "seq_parallel: the seq group is not gloo")
    emit("seq_parallel_op", dtype="float32", L=SEQ_OP_L, H=H, Dh=E // H, schedule=SEQ_OP_SCHEDULE,
         fwd_rel_tol=SEQ_FWD_REL_TOL, grad_rel_tol=SEQ_GRAD_REL_TOL, ranks=[r["op"] for r in ranks])
    emit("seq_parallel_grads", dtype="bfloat16", arch=SEQ_GRAD_ARCH, L=SEQ_GRAD_L, schedule=SEQ_GRAD_SCHEDULE,
         tol=SEQ_BF16_MAX_ONE_MINUS_COS, summary=ranks[0]["grads"],
         launches=[r["grads"]["gather"]["launches"] for r in ranks])
    enc = [r["encoder"] for r in ranks]
    emit("seq_parallel_encoder", dtype="bfloat16", arch=SEQ_ENCODER_ARCH, L=SEQ_ENCODER_L,
         valid=SEQ_ENCODER_VALID, schedule=SEQ_ENCODER_SCHEDULE, tol=SEQ_BF16_MAX_ONE_MINUS_COS,
         one_minus_cos={f"{m}_{r}": enc[0][f"{m}_{r}"]["rank_one_minus_cos"] for m, r in SEQ_ENCODER_RUNS},
         launches=[{f"{m}_{r}": e[f"{m}_{r}"]["launches"] for m, r in SEQ_ENCODER_RUNS} for e in enc])
    emit("seq_parallel_times", label=SEQ_LABEL, nvidia_smi=smi,
         ranks=[e["timing"] for e in enc], peak_memory_gb=[e["peak_memory_gb"] for e in enc])
    emit("seq_parallel", seconds=time.perf_counter() - t_phase, world=SEQ_WORLD, backend="gloo",
         collectives=["all_gather", "reduce_scatter", "all_to_all_single"], nvidia_smi=smi)


# ---------------------------------------------------------------------------
# 27. tensor_parallel
# ---------------------------------------------------------------------------

TP_RANKS = 4  # processes; a T = 2 run uses ranks 0 and 1 while 2 and 3 wait
TP_WORLDS = (2, 4)
TP_LABEL = "{} ranks time-sharing one H100, collectives through gloo on the host"
TP_L = N_TILES + 1
TP_ARCH = "gigapath_slide_enc12l768d"
TP_GRAD_ARCH = "LongNet_1_layers_768_dim"
TP_COUNTED = FLASH_KERNELS + ("pack_phases", "dilated_branch_fwd", "unpack_phases")


def _tp_launches(L: int, layers: int, backward: bool) -> dict:
    """Exact launches of one tensor-parallel rank's call over ``layers``
    flagship layers: the tensor-parallel route (head-major, the rank's
    heads at their global phases) runs a flat forward for each undilated
    branch the flat kernel takes and a segment-flash forward for every
    other branch, and in the backward the matching dq and dkv. Every other
    kernel 0."""
    from gigapath_tpu_torch.ops import all_launch_counts
    from gigapath_tpu_torch.ops.dilated_attention import _flat_eligible

    sls, drs = SCHEDULE
    flat = sum(1 for sl, r in zip(sls, drs) if _flat_eligible(min(sl, L), r))
    seg = len(sls) - flat
    n = dict.fromkeys(all_launch_counts(), 0)
    n.update(flat_fwd=flat, flash_fwd=seg)
    if backward:
        n.update(flat_bwd_dq=flat, flat_bwd_dkv=flat, flash_bwd_dq=seg, flash_bwd_dkv=seg)
    return {k: v * layers for k, v in n.items()}


def _tp_op(rank: int, T: int) -> dict:
    """(a) One flagship layer's op in fp32 on this rank's H/T heads (the
    tensor-parallel route) against the single-device op's slice, forward
    and the gradients of a seeded cotangent; exact launches."""
    import torch

    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.dilated_kernels import PipelineFlags

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, TP_L, H, E // H, generator=gen, device="cuda") for _ in range(4))
    full = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = dilated_attention(*full, *SCHEDULE, flags=PipelineFlags())
    ref.backward(do)
    per = H // T
    heads = slice(rank * per, (rank + 1) * per)
    local = [x[:, :, heads].contiguous().requires_grad_(True) for x in (q, k, v)]
    reset_all_launch_counts()
    o = dilated_attention(*local, *SCHEDULE, head_offset=rank * per, num_heads=H)
    o.backward(do[:, :, heads].contiguous())
    launches = _seq_counts()
    want = _tp_launches(TP_L, 1, backward=True)
    check(launches == want, f"tp op T={T} rank {rank}: launches {launches} != {want}")
    fwd = _grad_rel_err(o.detach(), ref.detach()[:, :, heads])
    grads = {g: _grad_rel_err(x.grad, f.grad[:, :, heads]) for g, x, f in zip(("dq", "dk", "dv"), local, full)}
    check(fwd <= SEQ_FWD_REL_TOL, f"tp op T={T} rank {rank}: forward rel {fwd} > {SEQ_FWD_REL_TOL}")
    for g, err in grads.items():
        check(err <= SEQ_GRAD_REL_TOL, f"tp op T={T} rank {rank}: {g} rel {err} > {SEQ_GRAD_REL_TOL}")
    return {"fwd_rel": fwd, "grad_rel": grads, "launches": {n: launches[n] for n in TP_COUNTED}}


def _tp_slide(rank: int, T: int, group, state, single) -> dict:
    """(b) The flagship slide encoder in bf16 on 10240 tiles, its encoder
    tensor-parallel over ``group`` (this rank's part of ``state``), every
    layer's embedding against ``single``'s (the single-device model on the
    same weights), by 1 - cosine; exact launches; (e) host ms of the
    forward (a barrier before each), peak memory, and on rank 0 a profile
    and the single-device forward's."""
    import torch

    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict
    from gigapath_tpu_torch.utils.registry import create_model_from_registry

    with torch.device("meta"):
        model = create_model_from_registry(TP_ARCH, in_chans=1536, model_group=group)
    model.load_state_dict(shard_state_dict(state, rank, T), strict=True, assign=True)
    model = model.to("cuda", torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, N_TILES, 1536, generator=gen, device="cuda").to(torch.bfloat16)
    coords = torch.rand(1, N_TILES, 2, generator=gen, device="cuda") * 100000
    with torch.no_grad():
        want = torch.stack(single(x, coords, all_layer_embed=True))
        reset_all_launch_counts()
        got = torch.stack(model(x, coords, all_layer_embed=True))
    launches = _seq_counts()
    expect = _tp_launches(TP_L, len(model.encoder.layers), backward=False)
    check(launches == expect, f"tp slide T={T} rank {rank}: launches {launches} != {expect}")
    check(bool(torch.isfinite(got).all()), f"tp slide T={T} rank {rank}: non-finite embeddings")
    per_layer = [_one_minus_cos(a, b) for a, b in zip(got, want)]
    check(max(per_layer) <= SEQ_BF16_MAX_ONE_MINUS_COS,
          f"tp slide T={T} rank {rank}: 1 - cos {max(per_layer)} > {SEQ_BF16_MAX_ONE_MINUS_COS}")

    def forward():
        with torch.no_grad():
            model(x, coords)

    def single_forward():
        with torch.no_grad():
            single(x, coords)

    _reset_peak()
    timing = {"host_ms": _seq_forward_ms(forward, group)}
    timing["peak_memory_gb"] = _peak() / 1e9
    if rank == 0:  # one rank's profile (the others run the same forward with it)
        timing.update(_profile(forward, top=4))
        timing["single_device"] = {"host_ms": _seq_forward_ms(single_forward, None)}
        timing["single_device"].update(_profile(single_forward, top=4))
    else:
        forward()
    return {"one_minus_cos_by_layer": per_layer, "launches": {n: launches[n] for n in TP_COUNTED},
            "timing": timing}


def _tp_grads(rank: int, T: int, group) -> dict:
    """(c) One flagship-width LongNet layer in bf16 at L = 10241, its
    parameter gradients gathered over ``group`` against the single-device
    layer's, by 1 - cosine (a gradient under 1e-2 of the largest counts as
    held, the rule of ``_worst_grad_err``); exact launches."""
    import torch

    from gigapath_tpu_torch.models.longnet import make_longnet_from_name
    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict

    sls, drs = SCHEDULE
    kw = dict(dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0)
    torch.manual_seed(1)
    single, _ = make_longnet_from_name(TP_GRAD_ARCH, **kw)
    with torch.device("meta"):
        model, _ = make_longnet_from_name(TP_GRAD_ARCH, model_group=group, **kw)
    model.load_state_dict(shard_state_dict(single.state_dict(), rank, T), strict=True, assign=True)
    model, single = (m.to("cuda", torch.bfloat16) for m in (model, single))
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, dy = (torch.randn(1, TP_L, E, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    single(x)["encoder_out"].backward(dy)
    want = {n: p.grad.float() for n, p in single.named_parameters()}
    reset_all_launch_counts()
    model(x)["encoder_out"].backward(dy)
    launches = _seq_counts()
    expect = _tp_launches(TP_L, 1, backward=True)
    check(launches == expect, f"tp grads T={T} rank {rank}: launches {launches} != {expect}")
    got = gather_state_dict({n: p.grad.float() for n, p in model.named_parameters()}, group=group)
    floor = 1e-2 * max(float(g.abs().max()) for g in want.values())
    held = [n for n in want if float(want[n].abs().max()) > floor]
    errs = {n: _one_minus_cos(got[n], want[n]) for n in held}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= SEQ_BF16_MAX_ONE_MINUS_COS,
          f"tp grads T={T} rank {rank}: {worst} 1 - cos {errs[worst]} > {SEQ_BF16_MAX_ONE_MINUS_COS}")
    return {"worst_param": worst, "worst_one_minus_cos": errs[worst], "n_held": len(held),
            "under_floor": sorted(set(want) - set(held)), "launches": {n: launches[n] for n in TP_COUNTED}}


def _tp_rank(rank: int, workdir: str) -> None:
    """One rank of ``phase_tensor_parallel`` (a spawned process on
    ``cuda:0``): a gloo group of TP_RANKS over a ``FileStore``; the
    flagship slide encoder's weights built once; then for each T of
    TP_WORLDS, on ranks below T, (a), (b) with (e), and (c); last, on every
    rank, ``phase_moe``'s expert parallelism (``_ep_rank_work``, EP_WORLD =
    TP_RANKS: one start of the rank processes serves both phases), each
    step's end in seconds from the rank's start (``steps_s``). The results
    go to ``rank{rank}.json``, a traceback to ``rank{rank}.err``."""
    import datetime
    import traceback

    t_start = time.perf_counter()
    try:
        import torch
        import torch.distributed as dist

        from gigapath_tpu_torch.models import slide_encoder  # noqa: F401  (registers the archs)
        from gigapath_tpu_torch.utils.registry import create_model_from_registry

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), TP_RANKS),
                                rank=rank, world_size=TP_RANKS,
                                timeout=datetime.timedelta(seconds=SEQ_RANK_TIMEOUT_S))
        groups = {T: dist.new_group(list(range(T))) for T in TP_WORLDS}
        steps = {"start": time.perf_counter() - t_start}
        single = create_model_from_registry(TP_ARCH, in_chans=1536)
        single.init_weights(torch.Generator().manual_seed(0))
        state = single.state_dict()
        single = single.to("cuda", torch.bfloat16).eval()
        steps["weights"] = time.perf_counter() - t_start
        out = {"backend": dist.get_backend(), "steps_s": steps}
        for T in TP_WORLDS:
            if rank < T:
                out[str(T)] = {"op": _tp_op(rank, T)}
                steps[f"op_{T}"] = time.perf_counter() - t_start
                out[str(T)]["slide"] = _tp_slide(rank, T, groups[T], state, single)
                steps[f"slide_{T}"] = time.perf_counter() - t_start
                out[str(T)]["grads"] = _tp_grads(rank, T, groups[T])
                steps[f"grads_{T}"] = time.perf_counter() - t_start
                torch.cuda.empty_cache()
            dist.barrier()
        del single
        torch.cuda.empty_cache()
        _reset_peak()
        out["ep"] = _ep_rank_work(rank, dist.group.WORLD)
        steps["ep"] = time.perf_counter() - t_start
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_tensor_parallel() -> list:
    """Tensor parallelism (27): TP_RANKS rank processes on ``cuda:0`` over
    gloo, spawned after the build; for T = 2 and 4 model ranks, (a) one
    flagship layer's fp32 op on each rank's heads against the single-device
    op, (b) the flagship slide encoder in bf16 at 10240 tiles against the
    single-device model, (c) one layer's bf16 parameter gradients gathered
    over the group, (d) every rank's exact launches, (e) host time, device
    busy and peak memory a rank, labelled TP_LABEL. The same ranks then
    run ``phase_moe``'s expert parallelism; returns its per-rank results."""
    t_phase = time.perf_counter()
    smi = _smi()
    ranks = _spawn_ranks(_tp_rank, TP_RANKS, "tensor_parallel")
    check(all(r["backend"] == "gloo" for r in ranks), "tensor_parallel: the model group is not gloo")
    for T in TP_WORLDS:
        runs = [r[str(T)] for r in ranks[:T]]
        emit("tensor_parallel_op", T=T, dtype="float32", L=TP_L, H=H, Dh=E // H, schedule=SCHEDULE,
             fwd_rel_tol=SEQ_FWD_REL_TOL, grad_rel_tol=SEQ_GRAD_REL_TOL, ranks=[r["op"] for r in runs])
        emit("tensor_parallel_slide", T=T, dtype="bfloat16", arch=TP_ARCH, tiles=N_TILES,
             tol=SEQ_BF16_MAX_ONE_MINUS_COS, worst_one_minus_cos=max(max(r["slide"]["one_minus_cos_by_layer"])
                                                                    for r in runs),
             one_minus_cos_by_layer=[r["slide"]["one_minus_cos_by_layer"] for r in runs],
             launches=[r["slide"]["launches"] for r in runs])
        emit("tensor_parallel_grads", T=T, dtype="bfloat16", arch=TP_GRAD_ARCH, L=TP_L,
             tol=SEQ_BF16_MAX_ONE_MINUS_COS, ranks=[r["grads"] for r in runs])
        emit("tensor_parallel_times", T=T, label=TP_LABEL.format(T), nvidia_smi=smi,
             ranks=[r["slide"]["timing"] for r in runs])
    emit("tensor_parallel", seconds=time.perf_counter() - t_phase, worlds=TP_WORLDS, backend="gloo",
         rank_steps_s=[r["steps_s"] for r in ranks],
         route="tensor-parallel (head-major at the global phases)", collectives=["all_reduce", "all_gather"],
         nvidia_smi=smi, includes="the ranks' start and phase_moe's expert parallelism")
    return [r["ep"] for r in ranks]


# ---------------------------------------------------------------------------
# 28. moe
# ---------------------------------------------------------------------------

MOE_ARCH = "LongNet_12_layers_768_dim"
MOE_KW = dict(moe_freq=2, moe_expert_count=8)
# the plain CPU run holds the card's: 12 layers (6 MoE) at L = 2049 (cut
# from 10241 for the CPU's time; the schedule's first branch runs in two
# segments)
MOE_CPU_L = 2049
MOE_L_AUX_REL_TOL = 1e-5
MOE_TIMED_REPS = 3
EP_WORLD = 4
EP_LABEL = "4 ranks time-sharing one H100, collectives through gloo on the host"
EP_L = N_TILES  # tokens a layer's input: a multiple of EP_WORLD for per-shard gating
EP_AUX_WEIGHT = 0.1


def _dense_launches(layers: int) -> dict:
    """Exact launches of a single-device forward over ``layers`` flagship
    layers on the default route: per branch, q, k and v packed (row 2),
    the branch forward (row 1), the output unpacked (row 3). An MoE
    layer's attention is a dense layer's; its FFN is torch."""
    from gigapath_tpu_torch.ops import all_launch_counts

    branches = len(SCHEDULE[0])
    n = dict.fromkeys(all_launch_counts(), 0)
    n.update(pack_phases=3 * branches * layers, dilated_branch_fwd=branches * layers,
             unpack_phases=branches * layers)
    return n


def _moe_encoder(top1: bool):
    """The MoE variant of ``MOE_ARCH`` (``MOE_KW``) on the flagship schedule,
    weights from torch's seed 4, in eval mode (the eval capacity, no
    second-expert noise), on the CPU."""
    import torch

    from gigapath_tpu_torch.models.longnet import make_longnet_from_name

    sls, drs = SCHEDULE
    torch.manual_seed(4)
    model, _ = make_longnet_from_name(MOE_ARCH, dilated_ratio=drs, segment_length=sls, drop_path_rate=0.0, dropout=0.0,
                                      moe_top1_expert=top1, **MOE_KW)
    return model.eval()


def _moe_vs_cpu(top1: bool) -> dict:
    """The card's fp32 MoE encoder against the same weights' plain run on
    the CPU: the output (max rel) and the summed ``l_aux``; exact launches
    (rows 1-3 on every layer, the MoE layers' FFN being torch)."""
    import torch

    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.parallel.spmd import collect_moe_l_aux

    model = _moe_encoder(top1)
    x = torch.randn(1, MOE_CPU_L, E, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ref = model(x)["encoder_out"]
        ref_aux = float(collect_moe_l_aux(model))
        model.to("cuda")
        reset_all_launch_counts()
        out = model(x.to("cuda"))["encoder_out"]
        aux = float(collect_moe_l_aux(model))
    launches = _seq_counts()
    want = _dense_launches(len(model.layers))
    check(launches == want, f"moe vs cpu top1={top1}: launches {launches} != {want}")
    rel = _grad_rel_err(out.cpu(), ref)
    aux_rel = abs(aux - ref_aux) / abs(ref_aux)
    check(rel <= F32_REL_TOL, f"moe vs cpu top1={top1}: output rel {rel} > {F32_REL_TOL}")
    check(aux_rel <= MOE_L_AUX_REL_TOL, f"moe vs cpu top1={top1}: l_aux rel {aux_rel} > {MOE_L_AUX_REL_TOL}")
    return {"out_rel": rel, "l_aux": aux, "l_aux_cpu": ref_aux, "l_aux_rel": aux_rel,
            "launches": {n: launches[n] for n in SEQ_COUNTED[:3]}}


def _moe_flagship(top1: bool) -> dict:
    """The 12-layer flagship-width MoE encoder in bf16 at L = 10241 on the
    card: finite output and ``l_aux``, exact launches, the gating
    telemetry's keys, host ms (median of MOE_TIMED_REPS), a profile and
    peak memory."""
    import torch

    from gigapath_tpu_torch.obs.telemetry import moe_scalars
    from gigapath_tpu_torch.ops import reset_all_launch_counts
    from gigapath_tpu_torch.parallel.spmd import collect_moe_l_aux

    model = _moe_encoder(top1).to("cuda", torch.bfloat16)
    x = torch.randn(1, TP_L, E, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    x = x.to(torch.bfloat16)

    def forward():
        with torch.no_grad():
            return model(x)["encoder_out"]

    _reset_peak()
    reset_all_launch_counts()
    out = forward()
    aux = collect_moe_l_aux(model)
    launches = _seq_counts()
    want = _dense_launches(len(model.layers))
    check(launches == want, f"moe flagship top1={top1}: launches {launches} != {want}")
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux)), f"moe flagship top1={top1}: non-finite")
    telemetry = moe_scalars(model)
    check(len(telemetry) > 0, f"moe flagship top1={top1}: no gating telemetry")
    host = []
    for _ in range(MOE_TIMED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    res = {"l_aux": float(aux), "launches": {n: launches[n] for n in SEQ_COUNTED[:3]},
           "telemetry_keys": len(telemetry), "entropy_gating": {k: float(v) for k, v in telemetry.items()
                                                                if k.endswith("entropy_gating")},
           "host_ms": host, "peak_memory_gb": _peak() / 1e9}
    res.update(_profile(forward, top=4))
    del model
    torch.cuda.empty_cache()
    return res


def _ep_layer(group=None, mode: str = "gather"):
    """The flagship-width MoE layer (8 experts, top-1), fp32, eval mode;
    weights from torch's seed 7; over ``group``'s experts when given."""
    import torch

    from gigapath_tpu_torch.ops.moe import MOELayer
    from gigapath_tpu_torch.parallel.tensor import shard_state_dict

    torch.manual_seed(7)
    whole = MOELayer(E, 4 * E, MOE_KW["moe_expert_count"], top1=True)
    if group is None:
        return whole.to("cuda").eval()
    import torch.distributed as dist

    layer = MOELayer(E, 4 * E, MOE_KW["moe_expert_count"], top1=True, expert_group=group, expert_parallel=mode)
    layer.load_state_dict(shard_state_dict(whole.state_dict(), dist.get_rank(group), dist.get_world_size(group),
                                           axis="expert"), strict=True)
    return layer.to("cuda").eval()


def _ep_run(layer, x, ct):
    """``layer(x)``'s output and ``l_aux`` and the gradients of ``sum(out *
    ct) + EP_AUX_WEIGHT * l_aux`` (x's and every parameter's)."""
    x = x.clone().requires_grad_(True)
    out, l_aux = layer(x)
    ((out * ct).sum() + EP_AUX_WEIGHT * l_aux).backward()
    return out.detach(), l_aux.detach(), x.grad, {n: p.grad for n, p in layer.named_parameters()}


def _ep_rank_work(rank: int, group) -> dict:
    """``phase_moe``'s expert parallelism on one rank of ``group`` (run by
    ``_tp_rank``): variant (a) on every token against the single-device
    layer, variant (b) on this rank's quarter against the single-device
    layer on that quarter (the per-shard function, its balance loss
    averaged over the ranks), forward and gradients (fp32), and the host
    ms of each (a barrier before each)."""
    import torch
    import torch.distributed as dist

    from gigapath_tpu_torch.parallel.tensor import gather_state_dict

    gen = torch.Generator(device="cuda").manual_seed(8)
    x, ct = (torch.randn(1, EP_L, E, generator=gen, device="cuda") for _ in range(2))
    out = {}
    # (a): every rank on every token
    single = _ep_layer()
    s_out, s_aux, s_dx, s_grads = _ep_run(single, x, ct)
    layer = _ep_layer(group, "gather")
    g_out, g_aux, g_dx, g_grads = _ep_run(layer, x, ct)
    g_grads = gather_state_dict(g_grads, group=group, axis="expert")
    grad_rel = {n: _grad_rel_err(g_grads[n], s_grads[n]) for n in s_grads}
    out["gathered"] = {"fwd_rel": _grad_rel_err(g_out, s_out), "l_aux_rel": _grad_rel_err(g_aux, s_aux),
                       "dx_rel": _grad_rel_err(g_dx, s_dx), "worst_grad_rel": max(grad_rel.values())}
    # (b): each rank gates its own quarter; the reference is the
    # single-device layer on that quarter, its l_aux weighted 1/D
    q = EP_L // EP_WORLD
    mine = slice(rank * q, (rank + 1) * q)
    single.zero_grad(set_to_none=True)
    xs = x[:, mine].clone().requires_grad_(True)
    r_out, r_aux = single(xs)
    ((r_out * ct[:, mine]).sum() + EP_AUX_WEIGHT / EP_WORLD * r_aux).backward()
    r_grads = torch.cat([p.grad.reshape(-1) for p in single.parameters()])
    dist.all_reduce(r_grads, group=group)
    auxes = [torch.empty_like(r_aux) for _ in range(EP_WORLD)]
    dist.all_gather(auxes, r_aux.detach().contiguous(), group=group)
    a2a = _ep_layer(group, "all_to_all")
    b_out, b_aux, b_dx, b_grads = _ep_run(a2a, x[:, mine], ct[:, mine])
    b_grads = gather_state_dict(b_grads, group=group, axis="expert")
    dist.all_reduce(b_grads["gate.wg.weight"], group=group)  # replicated: each rank's covers its own tokens
    r_split = dict(zip([n for n, _ in single.named_parameters()],
                       r_grads.split([p.numel() for p in single.parameters()])))
    b_rel = {n: _grad_rel_err(b_grads[n].reshape(-1), r_split[n]) for n in r_split}
    out["all_to_all"] = {"fwd_rel": _grad_rel_err(b_out, r_out.detach()),
                         "l_aux_rel": _grad_rel_err(b_aux, torch.stack(auxes).mean()),
                         "dx_rel": _grad_rel_err(b_dx, xs.grad), "worst_grad_rel": max(b_rel.values())}
    for variant, res in out.items():
        check(res["fwd_rel"] <= SEQ_FWD_REL_TOL and res["l_aux_rel"] <= SEQ_FWD_REL_TOL,
              f"ep {variant} rank {rank}: forward {res}")
        check(res["dx_rel"] <= SEQ_GRAD_REL_TOL and res["worst_grad_rel"] <= SEQ_GRAD_REL_TOL,
              f"ep {variant} rank {rank}: gradients {res}")
    timing = {}
    for name, fn in (("single_device", lambda: _ep_run(single, x, ct)), ("gathered", lambda: _ep_run(layer, x, ct)),
                     ("all_to_all", lambda: _ep_run(a2a, x[:, mine], ct[:, mine]))):
        timing[name] = {"host_ms": _seq_forward_ms(fn, group)}
    out["timing"] = timing
    out["peak_memory_gb"] = _peak() / 1e9
    return out


def phase_moe(ep_ranks: list) -> None:
    """Mixture of experts (28): the flagship config's MoE variant
    (``moe_freq=2, moe_expert_count=8``), top-1 and top-2, on the card
    in fp32 against the plain CPU run of the same weights at L = 2049,
    and in bf16 at 10240 tiles (launches, telemetry, timing);
    expert parallelism over EP_WORLD ranks in both variants against the
    single-device layer (``ep_ranks``: run by ``phase_tensor_parallel``'s
    ranks); and ``dryrun.dryrun_multichip(4)`` and ``(8)``."""
    from gigapath_tpu_torch.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    smi = _smi()
    for top1 in (True, False):
        emit("moe_vs_cpu", top1=top1, arch=MOE_ARCH, **MOE_KW, L=MOE_CPU_L, dtype="float32",
             out_rel_tol=F32_REL_TOL, l_aux_rel_tol=MOE_L_AUX_REL_TOL, **_moe_vs_cpu(top1))
        emit("moe_flagship", top1=top1, arch=MOE_ARCH, **MOE_KW, L=TP_L, dtype="bfloat16", nvidia_smi=smi,
             **_moe_flagship(top1))
    emit("moe_expert_parallel", world=EP_WORLD, L=EP_L, experts=MOE_KW["moe_expert_count"], dtype="float32",
         fwd_rel_tol=SEQ_FWD_REL_TOL, grad_rel_tol=SEQ_GRAD_REL_TOL, label=EP_LABEL, nvidia_smi=smi,
         ranks=ep_ranks)

    def dryrun(n):
        t0 = time.perf_counter()
        return dryrun_multichip(n), time.perf_counter() - t0

    # both dry runs at once: most of each is its ranks' start
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(dryrun, n) for n in (4, 8)}
        for n, run in runs.items():
            lines, seconds = run.result()
            losses = [float(line.rsplit("loss=", 1)[1]) for line in lines]
            check(len(lines) == 2 and all(math.isfinite(v) for v in losses), f"dryrun_multichip({n}): {lines}")
            emit("moe_dryrun", n=n, lines=lines, seconds=seconds)
    emit("moe", seconds=time.perf_counter() - t_phase, nvidia_smi=smi)


# ---------------------------------------------------------------------------
# the torchscale family: the LongNet decoder, RetNet, BEiT-3
# ---------------------------------------------------------------------------

DEC_L = N_TILES
DEC_STEPS = 64
DEC_PREFILL = DEC_L - DEC_STEPS
DEC_CFG = dict(decoder_embed_dim=E, decoder_attention_heads=H, decoder_ffn_embed_dim=4 * E, decoder_layers=12,
               segment_length=SCHEDULE[0], dilated_ratio=SCHEDULE[1], no_output_layer=True, dropout=0.0,
               drop_path_rate=0.0)
# a causal forward: the encoder's 12 layers x 5 branches (3 packs, the
# branch forward, 1 unpack each); a decode step: each layer's 5 branches
# on the segment-flash forward (row 11)
DEC_FWD_LAUNCHES = {"pack_phases": 180, "dilated_branch_fwd": 60, "unpack_phases": 60}
DEC_STEP_LAUNCHES = {"flash_fwd": 60}
# the stepped rows against the whole forward: another kernel (row 11 on the
# cut cache against row 1 on the packed phases) rounds otherwise in bf16;
# 3.1x the 3.23e-5 read on an H100 (PERF.md section 6, PR 25). The first
# DEC_REPLAY_STEPS steps against their own plain replay are held to
# BF16_MAX_ONE_MINUS_COS, and each of the replay's row-11 launches to
# KERNEL_TOL / LSE_TOL.
DEC_STEP_MAX_ONE_MINUS_COS = 1e-4
# the replay's steps: row 11's plain version takes ~0.8 s a decode step on
# an H100 (51 s for all 64)
DEC_REPLAY_STEPS = 16
RETNET_L = 2048
# RetNetConfig's defaults but a value width of 1296 = 3 heads x 432: the
# default 1280 does not split into its 3 heads (neither package runs it);
# 432 is torchscale's retnet_base head width, 1296 = 1.6875 x 768 its ratio
RETNET_CFG = dict(decoder_value_embed_dim=1296)
RETNET_RECURRENT_STEPS = 512  # of the 2048 positions: 12 layers' eager steps (the smoke's time)
# the forms differ by the order of their sums and by bf16 roundings; 4x the
# 2.50e-5 / 2.54e-5 read on an H100 (PERF.md section 6, PR 25)
RETNET_MAX_ONE_MINUS_COS = 1e-4
BEIT3_BATCH, BEIT3_TEXT, BEIT3_VOCAB = 8, 64, 64010
BEIT3_CPU_ROWS = 2


def _launch_delta(want: dict) -> dict:
    """Every kernel's launch count since the last reset: those of ``want``
    by name, the rest summed as ``other``."""
    counts = all_launch_counts()
    return {**{k: counts.get(k, 0) for k in want}, "other": sum(v for k, v in counts.items() if k not in want)}


def _rows_one_minus_cos(a, b) -> dict:
    """1 - cosine of the whole tensors (flattened) and of the worst row."""
    import torch

    rows = 1.0 - torch.nn.functional.cosine_similarity(a.float().flatten(0, -2), b.float().flatten(0, -2), dim=-1)
    return {"one_minus_cos": _one_minus_cos(a, b), "worst_row_one_minus_cos": float(rows.max()),
            "max_abs_err": max_err(a, b)}


@contextlib.contextmanager
def _flash_fwd_held_to_plain(held_errs: list):
    """Within: the segment-flash kernels run their plain versions, and each
    ``flash_fwd`` call also launches the kernel on the same inputs, its out
    held to KERNEL_TOL and its lse to LSE_TOL on the covered rows, the
    uncovered at the sentinel. Each call appends to ``held_errs``, on the
    card (no sync a call), [out max |err|, covered lse max |err|, 1 if out
    of tolerance, Mq, 1 if with key counts]; :func:`_held_summary` reads
    them."""
    import torch

    from gigapath_tpu_torch.ops import flash_kernels as fk

    kernel = fk.flash_fwd
    tol, lse_tol = KERNEL_TOL["bfloat16"], LSE_TOL["bfloat16"]

    def held(q, k, v, kvlen=None, is_causal=False):
        ref, r_lse = fk.flash_fwd_reference(q, k, v, kvlen, is_causal)
        out, lse = kernel(q, k, v, kvlen, is_causal)
        err = (out.float() - ref.float()).abs()
        covered = r_lse > -1e19
        lse_err = torch.where(covered, (lse - r_lse).abs(), 0.0)
        bad = ((err > tol["atol"] + tol["rtol"] * ref.float().abs()).any()
               | (lse_err > lse_tol["atol"] + lse_tol["rtol"] * r_lse.abs()).any()
               | (~covered & (lse > -1e19)).any() | (q.dtype != torch.bfloat16))
        held_errs.append(torch.stack([err.max(), lse_err.max(), bad.float(),
                                      torch.tensor(float(q.shape[3]), device=q.device),
                                      torch.tensor(float(kvlen is not None), device=q.device)]))
        return ref, r_lse

    with plain_flash_kernels():
        fk.flash_fwd = held
        yield


def _held_summary(held_errs: list) -> dict:
    """The launches :func:`_flash_fwd_held_to_plain` held; fails if one
    was out of tolerance."""
    import torch

    t = torch.stack(held_errs).cpu()
    check(not bool(t[:, 2].any()), f"decode replay: {int(t[:, 2].sum())} flash_fwd launches disagree with the plain "
                                   f"version (KERNEL_TOL / LSE_TOL)")
    return {"launches": len(held_errs), "max_abs_err": float(t[:, 0].max()),
            "lse_covered_max_abs_err": float(t[:, 1].max()), "q_rows_min_max": [int(t[:, 3].min()), int(t[:, 3].max())],
            "with_key_counts": int(t[:, 4].sum()), "causal": True,
            "tolerance": {"out": KERNEL_TOL["bfloat16"], "lse": LSE_TOL["bfloat16"]}}


def _decoder_model():
    import torch

    from gigapath_tpu_torch.architecture.config import DecoderConfig
    from gigapath_tpu_torch.models.longnet import LongNetDecoder

    torch.manual_seed(25)
    with torch.device("cuda"):
        model = LongNetDecoder(DecoderConfig(**DEC_CFG))
    return model.to(torch.bfloat16).eval()


def phase_longnet_decoder():
    """29: the causal flagship-width LongNet decoder on the kernels against
    their plain versions; returns the model, its input and its output."""
    import torch

    smi = _smi()
    model = _decoder_model()
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn(1, DEC_L, E, device="cuda", generator=gen).to(torch.bfloat16)

    def forward():
        with torch.no_grad():
            return model(token_embeddings=x)["decoder_out"]

    forward()  # warm-up
    torch.cuda.synchronize()
    _reset_peak()
    base = torch.cuda.memory_allocated()
    reset_all_launch_counts()
    out = forward()
    torch.cuda.synchronize()
    launches = _launch_delta(DEC_FWD_LAUNCHES)
    peak = (_peak() - base) / 1e9
    check(launches == {**DEC_FWD_LAUNCHES, "other": 0}, f"decoder forward launches {launches}")
    check(out.shape == (1, DEC_L, E) and bool(torch.isfinite(out).all()), f"decoder forward: bad output {out.shape}")
    ms = time_ms(forward, reps=3, warmup=0)
    with plain_kernels():
        ref = forward()
        plain = time_ms(forward, reps=1, warmup=0)
    agree = _rows_one_minus_cos(out, ref)
    check(agree["one_minus_cos"] <= BF16_MAX_ONE_MINUS_COS,
          f"decoder forward vs plain: 1 - cosine {agree['one_minus_cos']} > {BF16_MAX_ONE_MINUS_COS}")
    emit("longnet_decoder", L=DEC_L, dtype="bfloat16", config=DEC_CFG, launches=launches, vs_plain=agree,
         tolerance=f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}", ms_per_forward=ms, plain_path_ms=plain,
         peak_memory_above_model_gb=peak, profile=_profile(forward, top=4), nvidia_smi=smi)
    return model, x, out, launches


def phase_longnet_decode(model, x, full):
    """30: prefill, then DEC_STEPS eager decode steps, against the whole
    forward's rows; then the first DEC_REPLAY_STEPS steps again from the
    same prefill with the segment-flash kernels' plain versions, each
    row-11 launch of that replay held against the kernel on its inputs."""
    import torch

    smi = _smi()
    state = {}
    with torch.no_grad():
        reset_all_launch_counts()
        pre = model(token_embeddings=x[:, :DEC_PREFILL], incremental_state=state)["decoder_out"]
        torch.cuda.synchronize()
        prefill_launches = _launch_delta(DEC_FWD_LAUNCHES)
        check(prefill_launches == {**DEC_FWD_LAUNCHES, "other": 0}, f"prefill launches {prefill_launches}")
        # the prefill cache for the replay, in host memory: a copy on the
        # card would stay beside the steps' caches and raise their peak
        saved = {i: {k: v.cpu() if torch.is_tensor(v) else v for k, v in s.items()} for i, s in state.items()}
        _reset_peak()
        base = torch.cuda.memory_allocated()
        rows, step_ms, per_step, peaks = [], [], [], []

        def step(t, cache, out_rows):
            out_rows.append(model(token_embeddings=x[:, t:t + 1], incremental_state=cache)["decoder_out"])

        reset_all_launch_counts()
        for t in range(DEC_PREFILL, DEC_L):
            before = all_launch_counts().get("flash_fwd", 0)
            if t == DEC_L - 1:  # the last step under the profiler
                profile = _profile(lambda: step(t, state, rows), top=4, watch=("flash_fwd",))
            else:
                step_ms.append(time_ms(lambda: step(t, state, rows), reps=1, warmup=0))
            per_step.append(all_launch_counts().get("flash_fwd", 0) - before)
            peaks.append((_peak() - base) / 1e9)
        launches = _launch_delta(DEC_STEP_LAUNCHES)
        cache_gb = sum(v.numel() * v.element_size() for s in state.values() for k, v in s.items()
                       if k in ("prev_key", "prev_value")) / 1e9
        check(state[0]["index"] == DEC_L and tuple(state[0]["prev_key"].shape) == (1, DEC_L, H, E // H),
              f"decode cache {state[0]['index']}")
        state.clear()
        replay = {i: {k: v.to(x.device) if torch.is_tensor(v) else v for k, v in s.items()} for i, s in saved.items()}
        plain_rows, held_errs = [], []
        t0 = time.perf_counter()
        with _flash_fwd_held_to_plain(held_errs):
            for t in range(DEC_PREFILL, DEC_PREFILL + DEC_REPLAY_STEPS):
                step(t, replay, plain_rows)
        held = _held_summary(held_errs)
        replay_s = time.perf_counter() - t0
    stepped, stepped_plain = torch.cat(rows, dim=1), torch.cat(plain_rows, dim=1)
    want = {k: v * DEC_STEPS for k, v in DEC_STEP_LAUNCHES.items()}
    check(launches == {**want, "other": 0}, f"decode launches {launches} != {want}")
    check(all(n == DEC_STEP_LAUNCHES["flash_fwd"] for n in per_step), f"decode launches a step {per_step}")
    replay_want = DEC_STEP_LAUNCHES["flash_fwd"] * DEC_REPLAY_STEPS
    check(held["launches"] == replay_want, f"decode replay held {held['launches']} launches, not {replay_want}")
    agree = _rows_one_minus_cos(stepped, full[:, DEC_PREFILL:])
    plain_agree = _rows_one_minus_cos(stepped[:, :DEC_REPLAY_STEPS], stepped_plain)
    prefill_agree = _rows_one_minus_cos(pre, full[:, :DEC_PREFILL])
    check(bool(torch.isfinite(stepped).all()), "decode: non-finite rows")
    check(agree["one_minus_cos"] <= DEC_STEP_MAX_ONE_MINUS_COS,
          f"decode vs forward: 1 - cosine {agree['one_minus_cos']} > {DEC_STEP_MAX_ONE_MINUS_COS}")
    check(plain_agree["one_minus_cos"] <= BF16_MAX_ONE_MINUS_COS,
          f"decode vs its plain replay: 1 - cosine {plain_agree['one_minus_cos']} > {BF16_MAX_ONE_MINUS_COS}")
    emit("longnet_decode", prefill=DEC_PREFILL, steps=DEC_STEPS, dtype="bfloat16", prefill_launches=prefill_launches,
         launches=launches, launches_per_step=sorted(set(per_step)), vs_forward=agree, prefill_vs_forward=prefill_agree,
         tolerance=f"1 - cosine <= {DEC_STEP_MAX_ONE_MINUS_COS}", replay_steps=DEC_REPLAY_STEPS,
         vs_plain_replay=plain_agree, plain_replay_tolerance=f"1 - cosine <= {BF16_MAX_ONE_MINUS_COS}",
         replay_flash_fwd_vs_plain=held, plain_replay_s=replay_s, ms_per_step=statistics.median(step_ms),
         step_ms_first_last=[step_ms[0], step_ms[-1]], step_peak_memory_gb_first_last=[peaks[0], peaks[-1]],
         last_step_profile=profile, cache_gb=cache_gb, nvidia_smi=smi)
    return launches


def phase_retnet():
    """31: RetNet's three forms against each other at L = 2048, bf16."""
    import torch

    from gigapath_tpu_torch.architecture.config import RetNetConfig
    from gigapath_tpu_torch.architecture.retnet import RetNetDecoder

    smi = _smi()
    torch.manual_seed(27)
    with torch.device("cuda"):
        parallel = RetNetDecoder(RetNetConfig(**RETNET_CFG))
        chunkwise = RetNetDecoder(RetNetConfig(**RETNET_CFG, chunkwise_recurrent=True))
    parallel = parallel.to(torch.bfloat16).eval()
    chunkwise = chunkwise.to(torch.bfloat16).eval()
    chunkwise.load_state_dict(parallel.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(28)
    x = torch.randn(1, RETNET_L, E, device="cuda", generator=gen).to(torch.bfloat16)
    reset_all_launch_counts()
    with torch.no_grad():
        out_p = parallel(token_embeddings=x)["decoder_out"]
        out_c = chunkwise(token_embeddings=x)["decoder_out"]
        ms_p = time_ms(lambda: parallel(token_embeddings=x), reps=3, warmup=0)
        ms_c = time_ms(lambda: chunkwise(token_embeddings=x), reps=3, warmup=0)
        state, rows = {}, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(RETNET_RECURRENT_STEPS):
            rows.append(parallel(token_embeddings=x[:, t:t + 1], incremental_state=state)["decoder_out"])
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / RETNET_RECURRENT_STEPS
    recurrent = torch.cat(rows, dim=1)
    launches = _launch_delta({})
    check(launches == {"other": 0}, f"retnet launched kernels {launches}")
    chunk_agree = _rows_one_minus_cos(out_c, out_p)
    rec_agree = _rows_one_minus_cos(recurrent, out_p[:, :RETNET_RECURRENT_STEPS])
    for what, agree in (("chunkwise", chunk_agree), ("recurrent", rec_agree)):
        check(agree["one_minus_cos"] <= RETNET_MAX_ONE_MINUS_COS,
              f"retnet {what} vs parallel: 1 - cosine {agree['one_minus_cos']} > {RETNET_MAX_ONE_MINUS_COS}")
    for out in (out_p, out_c, recurrent):
        check(bool(torch.isfinite(out).all()), "retnet: non-finite output")
    emit("retnet", L=RETNET_L, dtype="bfloat16", config=RETNET_CFG, chunk=512,
         recurrent_steps=RETNET_RECURRENT_STEPS, chunkwise_vs_parallel=chunk_agree, recurrent_vs_parallel=rec_agree,
         tolerance=f"1 - cosine <= {RETNET_MAX_ONE_MINUS_COS}", parallel_ms=ms_p, chunkwise_ms=ms_c,
         recurrent_ms_per_step=ms_step, nvidia_smi=smi)


def phase_beit3():
    """32: BEiT-3 base's fused vision-language forward, bf16 at batch 8,
    and fp32 against the CPU."""
    import torch

    from gigapath_tpu_torch.architecture.config import EncoderConfig
    from gigapath_tpu_torch.models.beit3 import BEiT3

    smi = _smi()
    torch.manual_seed(29)
    cfg = EncoderConfig(multiway=True, vocab_size=BEIT3_VOCAB)
    cpu = BEiT3(cfg).eval()
    gen = torch.Generator().manual_seed(30)
    image = torch.randn(BEIT3_BATCH, 3, cfg.img_size, cfg.img_size, generator=gen)
    text = torch.randint(0, BEIT3_VOCAB, (BEIT3_BATCH, BEIT3_TEXT), generator=gen)
    pad = torch.zeros(BEIT3_BATCH, BEIT3_TEXT, dtype=torch.bool)
    pad[::2, -16:] = True
    n_vis = (cfg.img_size // cfg.patch_size) ** 2 + 1
    with torch.no_grad():
        want = cpu(text[:BEIT3_CPU_ROWS], image[:BEIT3_CPU_ROWS], pad[:BEIT3_CPU_ROWS])["encoder_out"]
        card = cpu.to("cuda")
        args = [t.to("cuda") for t in (text, image, pad)]
        got = card(*(a[:BEIT3_CPU_ROWS] for a in args))["encoder_out"].cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= F32_REL_TOL, f"beit3 fp32 card vs CPU rel {rel} > {F32_REL_TOL}")
        card = card.to(torch.bfloat16)
        args[1] = args[1].to(torch.bfloat16)
        torch.cuda.synchronize()
        _reset_peak()
        base = torch.cuda.memory_allocated()
        reset_all_launch_counts()
        out = card(*args)
        enc = out["encoder_out"]
        peak = (_peak() - base) / 1e9
        ms = time_ms(lambda: card(*args), reps=3, warmup=0)
    check(tuple(enc.shape) == (BEIT3_BATCH, n_vis + BEIT3_TEXT, E) and out["multiway_split_position"] == n_vis,
          f"beit3 output {tuple(enc.shape)}, split {out['multiway_split_position']}")
    check(bool(torch.isfinite(enc).all()), "beit3: non-finite output")
    bf16_agree = _rows_one_minus_cos(enc[:BEIT3_CPU_ROWS].cpu(), want)
    emit("beit3", batch=BEIT3_BATCH, vision_tokens=n_vis, text_tokens=BEIT3_TEXT, vocab_size=BEIT3_VOCAB,
         dtype="bfloat16", fp32_card_vs_cpu_rel=rel, tolerance=f"rel <= {F32_REL_TOL}",
         bf16_vs_cpu_fp32=bf16_agree, launches=_launch_delta({}), ms_per_forward=ms,
         peak_memory_above_model_gb=peak, nvidia_smi=smi)


def phase_torchscale() -> dict:
    """Phases 29-32; returns the decoder path's launches (the forward's and
    the decode steps')."""
    import torch

    model, x, full, fwd_launches = phase_longnet_decoder()
    decode_launches = phase_longnet_decode(model, x, full)
    del model, x, full
    torch.cuda.empty_cache()
    phase_retnet()
    phase_beit3()
    torch.cuda.empty_cache()
    return {"decoder_forward_launches": fwd_launches, "decoder_decode_launches": decode_launches}


# ---------------------------------------------------------------------------
# 33. compile-side obs: the ledger's profiles, op_totals, the chained
# timing and the streaming guard on the card
# ---------------------------------------------------------------------------

OBS_FWD_KERNELS = {"pack_phases": 180, "dilated_branch_fwd": 60, "unpack_phases": 60}  # rows 2, 1, 3
# the three kernels' names in a profiler trace (the bf16 forward's kernel)
OBS_TRACE_NAMES = {"pack_phases": "::pack_phases_kernel<", "dilated_branch_fwd": "dilated_branch_fwd_mma_kernel",
                   "unpack_phases": "::unpack_phases_kernel<"}
OBS_PEAK_REL_TOL = 0.05  # the profile's peak above the arguments against the smoke's peak above the model
OBS_DEVICE_TILES = 2048  # the 2-layer fp32 encoder profiled on the CPU and the card: L = 2049
OBS_DEVICE_DEPTH = 2
OBS_TRAIN_STEPS = 3
OBS_STEP_LAUNCHES = {"dilated_branch_bwd_dq": 55, "dilated_branch_bwd_dkv": 55}  # rows 7a, 7b a step
OBS_CHAIN = dict(iters_low=2, iters_high=6, repeats=2)
OBS_CHAIN_FACTOR = 2.0  # chained ms per forward within this factor of time_ms's
OBS_EXACT_SLIDES = (N_TILES, 9000, 8000, 7000, 6000)  # the --no-buckets path: a new key a slide


def _dense_flops(n_tiles: int, depth: int) -> float:
    """The slide encoder's dense products in closed form: the tile
    embedding (1536 -> E on each tile) and, per layer and token (the tiles
    and cls), q, k, v and out (4 E^2) and the FFN (8 E^2) multiply-adds."""
    return 2.0 * n_tiles * 1536 * E + depth * 2.0 * (n_tiles + 1) * 12 * E * E


def _fold_bound_bytes(cq: int, es: int) -> int:
    """The written bound on one streaming fold's allocations above the state
    it starts from, from one query chunk's block bytes: the pair kernel's
    partial (a block in the inputs' dtype and an fp32 lse vector), the
    stored-lse combine's three fp32 blocks (the two weighted terms and
    their sum) and three lse vectors, and one fp32 block more for the
    caching allocator, which may hand a large request a cached block up to
    1 MB longer."""
    block = cq * H * (E // H)
    return block * es + 4 * block * 4 + 4 * cq * H * 4


def _obs_forward(smi: str):
    """(a) the bf16 flagship forward through PerfLedger.capture_full."""
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.obs.ledger import PerfLedger
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder

    gen = torch.Generator(device="cuda").manual_seed(33)
    x, coords = _flagship_inputs(1, gen)
    model = create_model("", "gigapath_slide_enc12l768d", dtype=torch.bfloat16, seed=0)
    run_inference_with_slide_encoder(x, coords, model)  # warm-up
    torch.cuda.synchronize()
    ledger = PerfLedger()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    entry = ledger.capture_full("slide_forward", run_inference_with_slide_encoder, x, coords, model)
    profile_s = time.perf_counter() - t0
    launches = {k: v for k, v in dk.LAUNCHES.items() if v}
    fp, cost, mem = entry["jaxpr"], entry["cost"], entry["memory"]
    check(fp["kernels"] == launches == OBS_FWD_KERNELS,
          f"obs (a): kernels column {fp['kernels']}, LAUNCHES {launches}, expected {OBS_FWD_KERNELS}")
    dense = _dense_flops(N_TILES, 12)
    check(cost["flops"] is not None and cost["flops"] >= dense, f"obs (a): flops {cost['flops']} < dense {dense}")
    # the forward's peak above the model, measured as the smoke measures it
    torch.cuda.synchronize()
    _reset_peak()
    base = torch.cuda.memory_allocated()
    run_inference_with_slide_encoder(x, coords, model)
    smoke_peak = _peak() - base
    above = mem["peak_bytes"] - mem["argument_bytes"]
    check(abs(above - smoke_peak) <= OBS_PEAK_REL_TOL * smoke_peak,
          f"obs (a): profile peak above the arguments {above} B vs the smoke's {smoke_peak} B")
    emit("obs_compile_forward", dtype="bfloat16", tiles=N_TILES, kernels=fp["kernels"], launches=launches,
         eqns_total=fp["eqns_total"], flops=cost["flops"], dense_flops=dense, bytes_accessed=cost["bytes_accessed"],
         argument_bytes=mem["argument_bytes"], temp_bytes=mem["temp_bytes"], peak_bytes=mem["peak_bytes"],
         peak_above_arguments=above, smoke_peak_above_model=smoke_peak,
         peak_rel_diff=abs(above - smoke_peak) / smoke_peak, profiled_call_s=profile_s,
         top_ops=sorted(fp["primitives"].items(), key=lambda kv: -kv[1])[:8], card=smi)
    return model, x, coords


def _obs_devices(smi: str) -> None:
    """(b) the 2-layer fp32 encoder's profile on the CPU and on the card."""
    import numpy as np
    import torch

    from gigapath_tpu_torch.models.slide_encoder import create_model
    from gigapath_tpu_torch.obs.ledger import profile_call

    gen = torch.Generator().manual_seed(34)
    x = torch.randn(1, OBS_DEVICE_TILES, 1536, generator=gen)
    idx = torch.arange(OBS_DEVICE_TILES)
    coords = (torch.stack([idx // 64, idx % 64], dim=-1).float() * 256.0)[None]
    profiles, outs, seconds = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = create_model("", "gigapath_slide_enc12l768d", device=dev, seed=0, depth=OBS_DEVICE_DEPTH)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out, profiles[dev] = profile_call(model.forward, x.to(dev), coords.to(dev), all_layer_embed=True)
        seconds[dev] = time.perf_counter() - t0
        outs[dev] = out[-1].float().cpu().numpy()
        del model
    cpu, card = profiles["cpu"], profiles["cuda"]
    diff = {k: (cpu["jaxpr"]["primitives"].get(k), card["jaxpr"]["primitives"].get(k))
            for k in set(cpu["jaxpr"]["primitives"]) | set(card["jaxpr"]["primitives"])
            if cpu["jaxpr"]["primitives"].get(k) != card["jaxpr"]["primitives"].get(k)}
    rel = float(np.abs(outs["cuda"] - outs["cpu"]).max() / max(np.abs(outs["cpu"]).max(), 1e-12))
    emit("obs_compile_devices", dtype="float32", tiles=OBS_DEVICE_TILES, depth=OBS_DEVICE_DEPTH,
         fingerprint_equal=cpu["jaxpr"] == card["jaxpr"], primitives_diff=diff,
         kernels={"cpu": cpu["jaxpr"]["kernels"], "cuda": card["jaxpr"]["kernels"]},
         eqns_total={"cpu": cpu["jaxpr"]["eqns_total"], "cuda": card["jaxpr"]["eqns_total"]},
         flops={"cpu": cpu["cost"]["flops"], "cuda": card["cost"]["flops"]},
         bytes_accessed={"cpu": cpu["cost"]["bytes_accessed"], "cuda": card["cost"]["bytes_accessed"]},
         memory={"cpu": cpu["memory"], "cuda": card["memory"]}, last_embed_rel_err=rel,
         profiled_call_s=seconds, card=smi)
    check(cpu["jaxpr"] == card["jaxpr"], f"obs (b): the fingerprint differs between the CPU and the card: {diff}")
    check(cpu["cost"]["flops"] == card["cost"]["flops"],
          f"obs (b): flops {cpu['cost']['flops']} on the CPU, {card['cost']['flops']} on the card")
    check(rel <= F32_REL_TOL, f"obs (b): the card's last embedding vs the CPU's rel err {rel} > {F32_REL_TOL}")


def _obs_no_double_run(smi: str) -> None:
    """(c) three bf16 fine-tune steps through the loop's watchdog, the
    ledger on and under GIGAPATH_OBS=0: the same parameters, bit for bit,
    and rows 7a/7b launched 55 / 55 a step."""
    import types

    import numpy as np
    import torch

    from gigapath_tpu_torch.finetune.training import train_one_epoch
    from gigapath_tpu_torch.obs import CompileWatchdog, get_ledger, get_run_log
    from gigapath_tpu_torch.ops import dilated_kernels as dk

    rng = np.random.default_rng(35)
    idx = np.arange(N_TILES)
    grid = (np.stack([idx // 128, idx % 128], axis=-1) * 256.0).astype(np.float32)[None]
    batches = [{"imgs": rng.normal(size=(1, N_TILES, 1536)).astype(np.float32), "coords": grid,
                "labels": np.array([[i % 6]], np.int64), "slide_id": [f"s{i}"]} for i in range(OBS_TRAIN_STEPS)]
    args = types.SimpleNamespace(n_classes=6, bf16=True, task_config=PANDA)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, obs in (("ledger", "1"), ("obs_off", "0")):
            with env_flags({"GIGAPATH_OBS": obs}):
                runlog = get_run_log("finetune", out_dir=os.path.join(tmp, label), echo=False, probe_devices=False)
            ledger = get_ledger(runlog)
            watchdog = CompileWatchdog("train_step", runlog, ledger=ledger)
            model, steps, loss_fn = _head_and_steps(torch)
            torch.cuda.synchronize()
            dk.reset_launch_counts()
            train_one_epoch(batches, model, loss_fn, steps, 0, args, compile_log=watchdog, runlog=runlog)
            torch.cuda.synchronize()
            runlog.close()
            entries = list(ledger.entries.values())
            runs[label] = {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                           "launches": {k: dk.LAUNCHES[k] for k in OBS_STEP_LAUNCHES},
                           "first_step_s": list(watchdog.first_call_sec.values()),
                           "entries": [{"sig": e["sig"], "full": "cost" in e, "kernels": e["jaxpr"]["kernels"],
                                        "flops": (e.get("cost") or {}).get("flops"),
                                        "peak_bytes": (e.get("memory") or {}).get("peak_bytes")}
                                       for e in entries]}
            del model, steps
            torch.cuda.empty_cache()
    on, off = runs["ledger"], runs["obs_off"]
    equal = set(on["params"]) == set(off["params"]) and all(
        torch.equal(on["params"][n], off["params"][n]) for n in off["params"])
    want = {k: v * OBS_TRAIN_STEPS for k, v in OBS_STEP_LAUNCHES.items()}
    emit("obs_compile_no_double_run", dtype="bfloat16", tiles=N_TILES, steps=OBS_TRAIN_STEPS,
         params_bit_equal=equal, launches={k: r["launches"] for k, r in runs.items()},
         first_step_s={k: r["first_step_s"] for k, r in runs.items()}, ledger_entries=on["entries"],
         obs_off_entries=len(off["entries"]), card=smi)
    check(equal, "obs (c): the parameters differ between the ledger run and the GIGAPATH_OBS=0 run")
    check(on["launches"] == off["launches"] == want,
          f"obs (c): rows 7a/7b launches {on['launches']} / {off['launches']}, expected {want}")
    check(len(on["entries"]) == 1 and on["entries"][0]["full"] and not off["entries"],
          f"obs (c): ledger entries {on['entries']} and {off['entries']}")


def _obs_op_totals(model, x, coords, smi: str) -> None:
    """(d) op_totals of a profiler trace of the forward."""
    import torch

    from gigapath_tpu_torch.obs.spans import trace
    from gigapath_tpu_torch.pipeline import run_inference_with_slide_encoder
    from gigapath_tpu_torch.utils.profiling import op_totals

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with trace(tmp):
            for _ in range(PROFILE_LEAD_IN):  # CUPTI may drop a session's first records
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            run_inference_with_slide_encoder(x, coords, model)
            torch.cuda.synchronize()
        totals = op_totals(tmp)
    seen = {name: sum(n for k, n in totals["counts"].items() if pat in k) for name, pat in OBS_TRACE_NAMES.items()}
    device_us = {name: sum(us for k, us in totals["ops"].items() if pat in k)
                 for name, pat in OBS_TRACE_NAMES.items()}
    emit("obs_compile_op_totals", counts=seen, device_us=device_us, kernels_in_trace=len(totals["ops"]),
         device_us_total=sum(totals["ops"].values()), async_us_total=sum(totals["async"].values()), card=smi)
    check(seen == OBS_FWD_KERNELS, f"obs (d): op_totals counts {seen}, expected {OBS_FWD_KERNELS}")


def _obs_chained(model, x, coords, smi: str) -> None:
    """(e) chained_seconds_per_iter of the bf16 forward against time_ms."""
    import torch

    from gigapath_tpu_torch.utils.timing import chained_seconds_per_iter

    xb = x.to(torch.bfloat16)

    def step(carry, coords):  # the next forward reads this one's output
        return carry + (model(carry, coords)[-1].sum() * 0).to(carry.dtype)

    with torch.inference_mode():
        ms = time_ms(lambda: model(xb, coords))
        per_iter, overhead = chained_seconds_per_iter(step, xb, args=(coords,), **OBS_CHAIN)
    ratio = per_iter * 1e3 / ms
    emit("obs_compile_chained", dtype="bfloat16", tiles=N_TILES, chained_ms=per_iter * 1e3, time_ms=ms,
         ratio=ratio, overhead_ms=overhead * 1e3, **OBS_CHAIN, card=smi)
    check(1.0 / OBS_CHAIN_FACTOR <= ratio <= OBS_CHAIN_FACTOR,
          f"obs (e): chained {per_iter * 1e3} ms per forward vs time_ms {ms} ms")


def _obs_streaming(smi: str) -> None:
    """(f) one streamed flagship layer at 2048-tile chunks: the guard lists
    no full-length tensor of the fold and many of the dense forward; each
    fold's allocator peak stays under the written bound."""
    import torch

    from gigapath_tpu_torch.ops import streaming_prefill as psp
    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention

    gen = torch.Generator(device="cuda").manual_seed(36)
    Dh = E // H
    q, k, v = (torch.randn(1, STREAM_L, H, Dh, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    blocks = [[t[:, a:b].contiguous() for a, b in STREAM_BLOCKS] for t in (q, k, v)]
    with torch.inference_mode():
        fold_lines = psp.full_length_avals(psp.streaming_dilated_attention, *blocks, STREAM_BLOCKS, *SCHEDULE,
                                           full_len=STREAM_L)
        dense_lines = psp.full_length_avals(lambda q, k, v: dilated_attention(q, k, v, *SCHEDULE), q, k, v,
                                            full_len=STREAM_L)
        folds = []

        def measured_fold(*a, **kw):
            torch.cuda.synchronize()
            _reset_peak()
            base = torch.cuda.memory_allocated()
            out = psp.fold_pair(*a, **kw)
            torch.cuda.synchronize()
            folds.append((_peak() - base, a[2].shape[1]))
            return out

        state = psp.StreamingPrefillState(STREAM_BLOCKS, *SCHEDULE, fold_fn=measured_fold)
        for i, (qb, kb, vb) in enumerate(zip(*blocks)):
            state.ingest(i, qb, kb, vb)
        state.finalize()
    bound = _fold_bound_bytes(STREAM_CHUNK, q.element_size())
    over = [f for f in folds if f[0] > bound]
    emit("obs_compile_streaming", dtype="bfloat16", tokens=STREAM_L, chunk=STREAM_CHUNK, folds=len(folds),
         fold_full_length=fold_lines, dense_full_length=len(dense_lines), dense_examples=dense_lines[:3],
         fold_peak_max_bytes=max(f[0] for f in folds), bound_bytes=bound,
         fold_peak_by_query_rows={c: max(f[0] for f in folds if f[1] == c) for c in sorted({f[1] for f in folds})},
         folds_over_bound=len(over), card=smi)
    check(fold_lines == [], f"obs (f): the fold holds full-length tensors: {fold_lines[:5]}")
    check(len(dense_lines) > 0, "obs (f): the guard found no full-length tensor in the dense forward")
    check(len(folds) == STREAM_FOLDS // 12 and not over,
          f"obs (f): {len(folds)} folds, {len(over)} over the bound: {over[:3]}")


def _obs_exact_path(smi: str) -> None:
    """(g) the ``--no-buckets`` path (a new key nearly every slide) with
    the ledger on and under GIGAPATH_OBS=0, in turns off, on, off: the
    seconds a slide, and the ledger's entries (the first slide's forward
    fully profiled, the later ones by signature alone); beside them one
    slide's forward with and without the op counter, the cost each later
    key would pay if it were fingerprinted."""
    import glob

    import numpy as np
    import torch

    from gigapath_tpu_torch import inference
    from gigapath_tpu_torch.obs.ledger import op_fingerprint

    with tempfile.TemporaryDirectory() as tmp, env_flags({"GIGAPATH_OBS_DIR": tmp}):
        feat_dir = os.path.join(tmp, "feats")
        os.makedirs(feat_dir)
        slides = _serve_files(feat_dir, OBS_EXACT_SLIDES, seed=37)  # and a repeat of the first slide
        head = inference.load_model("", n_classes=2, feat_layer="11", seed=0)
        seconds, labels = {"obs_off": [], "ledger": []}, []
        for i, obs in enumerate(("0", "1", "0")):
            with env_flags({"GIGAPATH_OBS": obs}):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inference.run_inference(head, feat_dir, os.path.join(tmp, f"exact{i}.csv"), use_buckets=False)
                seconds["ledger" if obs == "1" else "obs_off"].append(time.perf_counter() - t0)
            labels.append(list(out["predicted_label"]))
        (log_path,) = [p for p in glob.glob(os.path.join(tmp, "obs", "*.jsonl")) if "exact1.csv" in open(p).readline()]
        events = [json.loads(line) for line in open(log_path)]
        (end,) = [ev for ev in events if ev["kind"] == "run_end"]
        walls = [ev["wall_s"] for ev in events if ev["kind"] == "step"]
        with open(end["ledger_path"]) as fh:
            entries = list(json.load(fh)["entries"].values())
        _, feats, coords = slides[0]
        plain = [time.perf_counter()]
        for _ in range(3):
            inference._exact_logits(head, feats, coords)
            plain.append(time.perf_counter())
        t0 = time.perf_counter()
        fp = op_fingerprint(inference._exact_logits, head, feats, coords)
        fingerprint_s = time.perf_counter() - t0
    full = [e for e in entries if "cost" in e]
    signed = [e for e in entries if set(e) == {"name", "key", "sig"}]
    n = len(slides)
    emit("obs_compile_exact_path", slides=[len(f) for _, f, _ in slides], seconds=seconds,
         seconds_per_slide={k: [t / n for t in v] for k, v in seconds.items()}, ledger_step_wall_s=walls,
         entries={"full": len(full), "signature_only": len(signed), "total": len(entries)},
         forward_s=float(np.mean(np.diff(plain))), fingerprinted_forward_s=fingerprint_s,
         fingerprint_ops=fp["eqns_total"], card=smi)
    check(labels[0] == labels[1] == labels[2], f"obs (g): labels {labels}")
    check(len(full) == 1 and len(signed) == len(OBS_EXACT_SLIDES) - 1 == len(entries) - 1,
          f"obs (g): {len(full)} full and {len(signed)} signature-only entries of {len(entries)}")


def phase_obs_compile() -> None:
    """Phase 33: compile-side obs on the card, (a)-(g)."""
    import torch

    t0 = time.perf_counter()
    smi = _smi()
    model, x, coords = _obs_forward(smi)
    _obs_op_totals(model, x, coords, smi)
    _obs_chained(model, x, coords, smi)
    del model, x, coords
    torch.cuda.empty_cache()
    _obs_devices(smi)
    _obs_no_double_run(smi)
    _obs_streaming(smi)
    torch.cuda.empty_cache()
    _obs_exact_path(smi)
    torch.cuda.empty_cache()
    emit("obs_compile", seconds=time.perf_counter() - t0, card=smi)


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import gigapath_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    summary = phase_kernels()["bfloat16"]
    phase_slide_forward()
    phase_ragged_batch()
    summary.update(phase_bwd_kernels()["bfloat16"])
    phase_head_widths()
    launches, _ = phase_finetune_step()
    summary.update(phase_q_kernels())
    with tempfile.TemporaryDirectory() as tile_dir:
        tile_launches, tile_timing, (tile_embeds, coords) = phase_tile_forward(tile_dir)
    launches.update({name: tile_launches["int8+attn"][name] for name in ("q_matmul", "q_flash_attention")})
    phase_two_stage(tile_embeds, coords)
    summary.update(phase_stream_kernels())
    stream = phase_stream_forward()
    phase_stream_serve()
    phase_serve()
    phase_dist()
    phase_train_wsi()
    phase_harness(tile_timing)
    launches["stream_pair_fwd"] = stream["launches"]["stream_pair_fwd"]
    launches.update({name: stream["backward"][name] for name in ("stream_pair_bwd_dq", "stream_pair_bwd_dkv")})
    summary.update(phase_fusion_kernels()["bfloat16"])
    phase_fusion_forward()
    fusion_launches = phase_fusion_step()
    launches.update({name: fusion_launches[name] for name in FUSION_KERNELS})
    phase_ffn_gelu()
    summary.update(phase_flash_kernels()["bfloat16"])
    phase_bhld_forward()
    phase_bhld_vs_fused()
    bhld_launches = phase_bhld_step()
    launches.update({name: bhld_launches[name] for name in FLASH_KERNELS})
    summary.update(phase_pipe_kernels()["bfloat16"])
    phase_pipe_forward()
    pipe_launches = phase_pipe_step()
    launches.update({name: pipe_launches[name] for name in PIPE_KERNELS})
    phase_seq_parallel()
    phase_moe(phase_tensor_parallel())
    decoder = phase_torchscale()
    phase_obs_compile()
    print(json.dumps({"kernels": [
        {"name": name, **meta, "launches": launches[name],
         "max_abs_err": summary[name]["err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"], "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"], "library_ms": summary[name]["library_ms"],
         **{key: counts.get(name, 0) for key, counts in decoder.items()}}
        for name, meta in KERNELS.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
