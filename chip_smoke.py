#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gigapath_tpu_torch``) on one GPU.

    python3 chip_smoke.py

It takes no arguments and always runs every phase, one JSON line each on
stdout:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. build: compile the CUDA kernels of ``gigapath_tpu_torch/csrc`` (one nvcc
   per library, all in parallel); ptxas' register report goes to stderr.
3. kernels: for each branch of the flagship schedule at L = 10241 (10240
   tiles + cls), E = 768, H = 16, in fp32 and bf16 with a ragged real
   length, pack -> branch attention -> unpack against their plain PyTorch
   versions on the card; CUDA-event times beside each kernel's bound and a
   library call's time (SDPA for the attention, ``torch.take`` with a
   precomputed index for the pack, ``index_copy_`` for the unpack). Then
   the branch kernel once more at a batch of more than 65535 (batch,
   segment, head) cells, bf16, with per-row valid lengths.
4. slide_forward: the flagship ``gigapath_slide_enc12l768d`` with seeded
   random weights through ``create_model`` and
   ``run_inference_with_slide_encoder`` on 10240 tiles, in fp32 and bf16,
   each layer's embedding against the port's plain path on the card, and
   the kernels' launch counts of one forward.
5. ragged_batch: B = 2 with a pad mask; each row against its slide alone.
6. bwd_kernels: the backward's dq and dkv kernels against their plain
   version at each flagship branch shape (L = 10241, ragged real length),
   fp32 and bf16, with CUDA-event times beside each kernel's bound, the
   plain version's time and the backward of one library attention call;
   then bf16 past 65535 cells with per-row valid lengths, one row with none
   (its gradients exactly 0), and the causal forward and backward at one
   branch shape.
7. head_widths: the forward, dq and dkv kernels (and the three
   segment-flash kernels) at the registry's other head widths (16, 24, 32,
   64, 96) against their plain versions, with ptxas' spill stores of each
   (the build phase builds every width).
8. finetune_step: the flagship ``ClassificationHead`` (``feat_layer`` 11, 6
   classes as PANDA) built by ``get_model`` and trained by
   ``finetune/training.py``'s ``train_step`` on a synthetic 10240-tile
   slide: one fp32 step's gradients against the plain path (and bf16 by
   cosine), the kernels' launch counts of one bf16 step (the main path the
   final ``kernels`` line reports), ms per step and peak memory in bf16
   and fp32, and six optimizer steps on one batch, whose loss must fall.
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
12. stream_kernels: the streaming chunk-pair kernels (forward, dq, dkv)
    against their plain versions at flagship chunk pairs (2048-row blocks
    at the token offsets of a 10240-tile slide, H = 16, Dh = 48) for each
    of the 5 branch geometries (g = 1024, 5792 and three clamped to L =
    10241), fp32 and bf16: pairs across segment boundaries, the 1-row cls
    block as queries and as keys, a ragged valid bound, a pair whose rows
    are all masked (out and gradients exactly 0), a nonzero lse cotangent;
    the kernels' device times (``torch.profiler``; a small pair's CUDA-event
    time is the wrapper's host work) beside the bound, the plain version
    and one SDPA call with the boolean mask (and its backward); ptxas'
    registers and spills.
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
    the dense kernel path's, with the backward kernels' launches.
14. stream_serve: ``StreamingSubmitter.stream_slide`` answers 3 requests
    (10240, 4097 and 2048 tiles, chunks in reverse order), each against the
    dense entry; ``head_streaming_submitter`` and ``streaming_head_logits``
    on a flagship ``ClassificationHead`` (4097 tiles) against its dense
    logits.

15. fusion_kernels: the stream-fusion route's four kernels against their
    plain versions at the flagship's branch shapes (L = 10241), fp32 and
    bf16, with a ragged real length (timed) and a B = 2 batch with per-row
    valid lengths: ``pack_phases_direct`` and ``unpack_phases_direct`` on the
    three single-segment branches (r = 4, 8, 16), bit-exact and bit-equal
    to ``pack_phases``/``unpack_phases``; ``fusion_epilogue_fwd`` over the
    five branches' packed results, also against the default route's dense
    fusion; ``fusion_epilogue_bwd`` per branch, exact zeros off the
    extent; each kernel's device time (from a CUDA graph of 20 calls; one
    call's CUDA-event time, mostly the wrapper's host work, beside it)
    against the bound, the plain version and a library call
    (``torch.take``, ``index_copy_``; none for the epilogue, whose line
    carries the device time of the default route's fusion of the same
    packed results instead).
16. fusion_forward: the flagship forward with ``GIGAPATH_STREAM_FUSION=1
    GIGAPATH_PACK_DIRECT=1`` against the default route, fp32 (rel) and
    bf16 (cosine), with its exact launches; ms per slide and peak memory
    of both routes on 10240 tiles and (bf16) on one 102400-tile slide, with
    the peak of one attention call alone there; a profiler breakdown of
    one bf16 forward on each route.
17. fusion_step: the flagship fine-tune step on that route: fp32
    gradients against the default route, the exact launches of one bf16
    step, ms per step and peak memory of both routes (bf16).

18. ffn_gelu: the feed-forward GELU of a bf16 [10241, 3072] fc1 output in
    its own dtype against the explicit fp32 round trip, in bf16 ulps (at
    most one).
19. flash_kernels: the segment-flash kernels (rows 11-14: flash_fwd,
    flash_bwd_dq, flash_bwd_dkv on the segmented layout, flat_fwd,
    flat_bwd_dq, flat_bwd_dkv on the flat one) against their plain versions
    at the five head-major branches of one flagship layer with ratios [1,
    2, 4, 6, 12] (L = 10241; the r = 1 branch flat), fp32 and bf16, full
    length (timed: CUDA events beside the bound, the plain version and SDPA
    with a boolean key mask and its backward) and with a ragged real
    length; the B = 2 ragged batch's counts formed on the card (every
    branch segmented); a causal case of each layout; flash_attention and
    partial_attention on [1, 10241, 16, 48] with [B, H] valid counts
    against attention_with_lse.
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
    peak memory.

23. pipe_kernels: the pipelined branch kernels (rows 6 and 8:
    dilated_branch_fwd_pipe, dilated_branch_bwd_dq_pipe,
    dilated_branch_bwd_dkv_pipe) against their plain versions at the five
    branches of one flagship layer (L = 10241), fp32 and bf16, at full
    length (timed: CUDA events beside the bound, the plain version, the
    serial twin and SDPA with the key mask and its backward), at a ragged
    real length and in a B = 2 batch whose counts are formed on the card;
    each against its serial twin on the same inputs (fp32 within
    KERNEL_TOL; bf16 1 - cosine within the route limit, the roundings
    differing on purpose); past 65535 cells. The build phase builds them at
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

Phase 16 also replays a ``torch.cuda.memory`` allocation history of one
bf16 forward per route (10240 and 102400 tiles) to its peak and reports the
allocations live there by the port's source line.

Then a ``{"kernels": [...]}`` line (the launches of the dilated kernels
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

import contextlib
import json
import math
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 FMA pipes; bf16 tensor cores
PROFILE_PAUSE_S = 0.02  # idle host time at each edge of a device_ms profiler window
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
# head widths (E / H) of the registry's other LongNet configs; the branch
# kernels are built once per width
OTHER_HEAD_DIMS = (16, 24, 32, 64, 96)
BRANCH_SOURCES = ("dilated_branch_fwd", "dilated_branch_bwd_dq", "dilated_branch_bwd_dkv")
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
STREAM_KERNELS = ("stream_pair_fwd", "stream_pair_bwd_dq", "stream_pair_bwd_dkv")
STREAM_REQUESTS = (N_TILES, 4097, 2048)  # tiles of the three served slides; the head takes the second
# a stream kernel vs its plain version on the card: out as the branch
# kernels (the plain version rounds its probabilities to bf16 before PV,
# the kernel keeps them fp32), lse on covered rows, gradients as
# BWD_REL_TOL
STREAM_LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-3, rtol=1e-5)}
# the stream-fusion route with direct packs (GIGAPATH_STREAM_FUSION=1,
# GIGAPATH_PACK_DIRECT=1): the flagship's three branches clamped to one
# segment (r = 4, 8, 16) take the direct pack and unpack, the r = 1 and 2
# branches the row-2/3 kernels; one epilogue launch per layer forward, one
# per branch and layer backward (11 layers with feat_layer 11)
FUSION_KERNELS = ("pack_phases_direct", "unpack_phases_direct", "fusion_epilogue_fwd", "fusion_epilogue_bwd")
FUSION_ENV = {"GIGAPATH_STREAM_FUSION": "1", "GIGAPATH_PACK_DIRECT": "1"}
FUSION_FWD_LAUNCHES = {"pack_phases": 12 * 2 * 3, "dilated_branch_fwd": 60, "unpack_phases": 0,
                       "dilated_branch_bwd_dq": 0, "dilated_branch_bwd_dkv": 0,
                       "pack_phases_direct": 12 * 3 * 3, "unpack_phases_direct": 0,
                       "fusion_epilogue_fwd": 12, "fusion_epilogue_bwd": 0, **NO_PIPE}
FUSION_STEP_LAUNCHES = {"pack_phases": 72 + 11 * 2 * 3, "dilated_branch_fwd": 60,
                        "unpack_phases": 11 * 2 * 3, "dilated_branch_bwd_dq": 55,
                        "dilated_branch_bwd_dkv": 55, "pack_phases_direct": 108 + 11 * 3 * 3,
                        "unpack_phases_direct": 11 * 3 * 3, "fusion_epilogue_fwd": 12,
                        "fusion_epilogue_bwd": 55, **NO_PIPE}
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def device_ms(fn, kernel: str, reps: int = 10, attempts: int = 3) -> float:
    """Median device time (ms) of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``'s
    device activity. Unlike :func:`time_ms` it leaves out the wrapper's host
    work, which is most of one call's time on a small chunk pair.

    The profiler can drop device records near the edges of its window (a
    card run saw 3 of 10 launches), so the launches sit between two idle
    pauses, and a window that records fewer than half of them is measured
    again, at most ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAUSE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
        durations = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.device_type == DeviceType.CUDA and kernel in e.name]
        check(len(durations) <= reps, f"the profiler saw {len(durations)} launches of {kernel} in {reps}")
        if len(durations) >= reps // 2:
            return statistics.median(durations) / 1e3
        seen.append(len(durations))
    raise AssertionError(f"the profiler saw {seen} launches of {kernel} in {attempts} windows of {reps}")


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
    dk.dilated_branch_bwd_dq = lambda *a: dk.dilated_branch_bwd_reference(*a, dkv=False)[0]
    dk.dilated_branch_bwd_dkv = lambda *a: dk.dilated_branch_bwd_reference(*a, dq=False)[1:]
    dk.dilated_branch_bwd_dq_pipe = lambda *a: dk.dilated_branch_bwd_pipe_reference(*a, dkv=False)[0]
    dk.dilated_branch_bwd_dkv_pipe = lambda *a: dk.dilated_branch_bwd_pipe_reference(*a, dq=False)[1:]
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dk, name, fn)


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
        for name in BRANCH_SOURCES + PIPE_KERNELS + FLASH_SOURCES
    )
    t0 = time.perf_counter()
    _build.build_all(specs)
    seconds = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        print(f"--- ptxas {name} ---\n{log}", file=sys.stderr)
    emit("build", seconds=seconds, built=sorted(_build.build_log),
         libraries=[_build._label(name, defines) for name, defines in specs])


def _branch_bounds(dk, B, L, sl, r, real_len, kvlen, itemsize, dtype_name):
    """Least card time (ms) of each kernel's work at this branch, and what
    bounds it: bytes each kernel must move over the HBM rate, operations over
    the peak rate of the dtype."""
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    Dh = E // H
    hb = H // r
    band = B * L * E // r  # band elements the sequence's tokens hold
    packed = B * S * Mp * E  # elements of one packed tensor
    q_rows = dk._phase_kvlen(S, g, r, m, L).astype("int64")  # [S, r] real query rows
    kv = kvlen.cpu().numpy().astype("int64")  # [B, S, r] valid keys
    flops = 4 * Dh * hb * float((q_rows[None] * kv).sum())
    rows = float(q_rows.sum()) * B
    fwd_bytes = (rows * 2 + float(kv.sum()) * 2) * hb * Dh * itemsize + rows * hb * 4
    return {
        "pack_phases": ((band + packed) * itemsize / HBM_BYTES_PER_S * 1e3, "bytes"),
        "unpack_phases": ((band + B * L * E) * itemsize / HBM_BYTES_PER_S * 1e3, "bytes"),
        "dilated_branch_fwd": max(
            (flops / PEAK_FLOPS[dtype_name] * 1e3, "operations"),
            (fwd_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        ),
    }


def phase_kernels():
    """Each kernel vs its plain version at the flagship's branch shapes."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    L, B = N_TILES + 1, 1
    real_len = L - 37  # a ragged tail: keys past it are masked
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
        totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, err=0.0,
                             by={}) for name in FWD_KERNELS}
        for sl, r in zip(*SCHEDULE):
            g, S, m, Mp = dk._branch_geometry(L, sl, r)
            kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, None, q.device)
            # pack: exact copy of the plain version (pad slots exact 0)
            q6, k6, v6 = (dk.pack_phases(x, g, S, r, Mp, H) for x in (q, k, v))
            q6_ref = dk.pack_phases_reference(q, g, S, r, Mp, H)
            err_pack = max_err(q6, q6_ref)
            check(err_pack == 0.0, f"pack_phases {dname} sl={sl} r={r}: max err {err_pack}")
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
            err_unpack = max_err(dense, dk.unpack_phases_reference(out6, L, E, g, S, r))
            check(err_unpack == 0.0, f"unpack_phases {dname} r={r}: max err {err_unpack}")
            phase = (torch.arange(L, device="cuda") % g) % r
            band = torch.arange(E, device="cuda") // (E // H) // (H // r)
            off_band = phase[:, None] != band[None, :]
            check(not bool(dense[0][off_band].any()), f"unpack_phases r={r}: off-band lanes not 0")
            lse_dense = dk._scatter_lse(lse5, L, H, g, r, m)
            head_band = torch.arange(H, device="cuda") // (H // r)
            uncovered = head_band[:, None] != phase[None, :]
            check(bool((lse_dense[0][uncovered] <= -1e19).all()), f"r={r}: uncovered lse above -1e19")

            # times: kernels, plain versions, and one library call for the attention
            t = {
                "pack_phases": time_ms(lambda: dk.pack_phases(q, g, S, r, Mp, H)),
                "dilated_branch_fwd": time_ms(lambda: dk.dilated_branch_fwd(q6, k6, v6, kvlen)),
                "unpack_phases": time_ms(lambda: dk.unpack_phases(out6, L, E, g, S, r)),
            }
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
            lib_pack, lib_unpack = _copy_yardsticks(dk, q, out6, q6, dense, g, S, r, Mp)
            bounds = _branch_bounds(dk, B, L, sl, r, real_len, kvlen, q.element_size(), dname)
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
                 ms=t, plain_ms=plain, library_ms_sdpa=lib, library_ms_take=lib_pack,
                 library_ms_index_copy=lib_unpack,
                 bound_ms={n: b[0] for n, b in bounds.items()}, bound_by={n: b[1] for n, b in bounds.items()})
            del q6, k6, v6, out6, lse5, out_ref, lse_ref, dense, qs, ks, vs
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
        summary[dname] = totals
        emit("kernels_per_layer", dtype=dname,
             note="sum over the 5 branches of one layer; pack counts its 3 launches (q, k, v)",
             kernels=totals)
    _many_cells(dk)
    return summary


def _copy_yardsticks(dk, x, out6, packed, dense, g, S, r, Mp):
    """CUDA-event ms of one PyTorch indexing call computing the same copy
    as the pack kernel (``torch.take`` with a precomputed index into the
    dense input with one zero appended, for the pad slots) and of the
    unpack's inverse scatter (``index_copy_`` of the packed elements into
    zeros, pad slots to one spare element). Both are checked exact."""
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
    lib_pack = time_ms(lambda: torch.take(x_pad, src))
    lib_unpack = time_ms(lambda: torch.zeros(n + 1, dtype=out6.dtype, device=x.device).index_copy_(0, src, flat6))
    return lib_pack, lib_unpack


def _many_cells(dk):
    """The branch kernel past the 65535 cells one grid dimension could hold:
    64 slides of 8192 tokens in 64-token segments, r = 1, each row with its
    own valid length, bf16."""
    import torch

    B, L, sl, r = 64, 8192, 64, 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    cells = B * S * r * (H // r)
    check(cells > 65535, f"many-cells check has only {cells} cells")
    q6, k6, v6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen)
                  .to(torch.bfloat16) for _ in range(3))
    valid = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    kvlen = dk._branch_kvlen(B, S, g, r, m, L, valid, q6.device)
    out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen)
    out_ref, lse_ref = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen)
    torch.testing.assert_close(out6, out_ref, **KERNEL_TOL["bfloat16"])
    covered = lse_ref > -1e19
    torch.testing.assert_close(lse5[covered], lse_ref[covered], **LSE_TOL["bfloat16"])
    check(bool((lse5[~covered] <= -1e19).all()), "many cells: uncovered lse above -1e19")
    check(not bool(out6[~covered].any()), "many cells: fully masked rows not 0")
    emit("kernels_many_cells", dtype="bfloat16", B=B, L=L, sl=sl, r=r, cells=cells,
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
             plain_path_ms=plain_s * 1e3, peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
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


def _bwd_bounds(dk, B, L, sl, r, kvlen, itemsize, dtype_name):
    """Least card time (ms) of the dq and the dkv kernel's work at this
    branch: operations over the dtype's peak (6*Dh per valid (query, key)
    pair for dq: q.k, dout.v, ds*k; 8*Dh for dkv: q.k, dout.v, p*dout,
    ds*q) or bytes over the HBM rate, whichever is larger. Query rows are
    the sequence's tokens in the cell, keys its valid keys."""
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    Dh, hb = E // H, H // r
    q_rows = dk._phase_kvlen(S, g, r, m, L).astype("int64")  # [S, r]
    kv = kvlen.cpu().numpy().astype("int64")  # [B, S, r]
    pairs = hb * float((q_rows[None] * kv).sum())
    rows = float(q_rows.sum()) * B * hb
    keys = float(kv.sum()) * hb
    # dq reads q, dout (rows), k, v (keys), lse, delta; writes dq (rows)
    dq_bytes = (3 * rows + 2 * keys) * Dh * itemsize + 2 * rows * 4
    # dkv reads q, dout (rows), k, v (keys), lse, delta; writes dk, dv (keys)
    dkv_bytes = (2 * rows + 4 * keys) * Dh * itemsize + 2 * rows * 4
    out = {}
    for name, per_pair, nbytes in (("dilated_branch_bwd_dq", 6, dq_bytes),
                                   ("dilated_branch_bwd_dkv", 8, dkv_bytes)):
        out[name] = max((per_pair * Dh * pairs / PEAK_FLOPS[dtype_name] * 1e3, "operations"),
                        (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    return out


def _grad_rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30))


def phase_bwd_kernels():
    """dq and dkv vs their plain version at the flagship's branch shapes."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    L, B = N_TILES + 1, 1
    real_len = L - 37
    gen = torch.Generator(device="cuda").manual_seed(4)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(4))
        totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={})
                  for name in BWD_KERNELS}
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

            t = {"dilated_branch_bwd_dq": time_ms(lambda: dk.dilated_branch_bwd_dq(*args)),
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
            bounds = _bwd_bounds(dk, B, L, sl, r, kvlen, q.element_size(), dname)
            for name in BWD_KERNELS:
                tot = totals[name]
                tot["ms"] += t[name]
                tot["plain_ms"] += plain[name]
                tot["bound_ms"] += bounds[name][0]
                tot["library_ms"] += lib  # one library call covers dq, dk and dv
                grads = ("dq",) if name.endswith("dq") else ("dk", "dv")
                tot["err"] = max(tot["err"], *(abs_errs[x] for x in grads))
                tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + bounds[name][0]
            emit("bwd_kernels", dtype=dname, sl=sl, r=r, S=S, m=m, Mp=Mp, real_len=real_len,
                 max_rel_err=errs, max_abs_err=abs_errs, tolerance=BWD_REL_TOL[dname], ms=t, plain_ms=plain,
                 library_ms_sdpa_bwd=lib, bound_ms={n: b[0] for n, b in bounds.items()},
                 bound_by={n: b[1] for n, b in bounds.items()})
            del q6, k6, v6, do6, out6, lse5, delta, args, dq6, dk6, dv6, ref, qs, ks, vs, lib_out, lib_do
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
        summary[dname] = totals
        emit("bwd_kernels_per_layer", dtype=dname,
             note="sum over the 5 branches of one layer; library_ms is one SDPA backward (dq, dk, dv) per branch",
             kernels=totals)
    _many_cells_bwd(dk)
    _causal_branch(dk)
    return summary


def _causal_branch(dk):
    """The causal path of the forward and both backward kernels at one
    flagship branch shape (sl = 5792, r = 2), fp32, against their plain
    versions."""
    import torch

    L, B, sl, r = N_TILES + 1, 1, 5792, 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    g, S, m, Mp = dk._branch_geometry(L, sl, r)
    q6, k6, v6, do6 = (torch.randn(B, S, r, H // r, Mp, E // H, device="cuda", generator=gen)
                       for _ in range(4))
    kvlen = dk._branch_kvlen(B, S, g, r, m, L - 37, None, q6.device)
    out6, lse5 = dk.dilated_branch_fwd(q6, k6, v6, kvlen, True)
    out_ref, lse_ref = dk.dilated_branch_fwd_reference(q6, k6, v6, kvlen, True)
    errs = {"out": _grad_rel_err(out6, out_ref)}
    delta = (do6 * out6).sum(-1)
    args = (q6, k6, v6, do6, lse5, delta, kvlen, True)
    grads = (dk.dilated_branch_bwd_dq(*args), *dk.dilated_branch_bwd_dkv(*args))
    for gname, ours, want in zip(("dq", "dk", "dv"), grads, dk.dilated_branch_bwd_reference(*args)):
        errs[gname] = _grad_rel_err(ours, want)
    for name, err in errs.items():
        check(err <= BWD_REL_TOL["float32"], f"causal {name} rel err {err} > {BWD_REL_TOL['float32']}")
    emit("causal_branch", dtype="float32", sl=sl, r=r, max_rel_err=errs, tolerance=BWD_REL_TOL["float32"])


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
         empty_rows=1, max_rel_err=errs, tolerance=BWD_REL_TOL["bfloat16"])


def _spill_bytes(label: str) -> int:
    """Largest spill-store count ptxas reported for a library this process
    built (0 if none)."""
    import re

    from gigapath_tpu_torch.ops import _build

    found = re.findall(r"(\d+) bytes spill stores", _build.build_log.get(label, ""))
    return max(map(int, found), default=0)


def phase_head_widths():
    """The three branch kernels and their three pipelined twins at the
    registry's other head widths (H = 16, E = 16 * Dh, one r = 2 branch on
    2049 tokens with a ragged real length), and the three segment-flash
    kernels there (a head-major r = 3 branch and
    a flat r = 1 one), fp32 and bf16, against their plain versions; ptxas'
    spill stores of each."""
    import torch

    from gigapath_tpu_torch.ops import dilated_attention as pda
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.ops import flash_kernels as fk

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
                    _flash_fwd_bwd(fk, flat, fargs, plain=True), dq_rows=L - 37 if flat else None)
        emit("head_widths", Dh=dh, E=Eh, L=L, sl=sl, r=r, max_rel_err=errs, tolerance=BWD_REL_TOL,
             flash_max_err=flash_errs,
             spill_store_bytes={name: _spill_bytes(f"{name}-GP_HEAD_DIM={dh}")
                                for name in BRANCH_SOURCES + PIPE_KERNELS + FLASH_SOURCES})


def _head_and_steps(torch, lr=5e-5, scheduler="fixed", **slide_kwargs):
    """The flagship ClassificationHead (seed 0) with the fine-tuning
    recipe's optimizer, gc = 1; ``slide_kwargs`` go to the slide encoder."""
    from gigapath_tpu_torch.finetune import utils as ft
    from gigapath_tpu_torch.models.classification_head import get_model

    model = get_model(input_dim=1536, latent_dim=768, feat_layer="11", n_classes=6,
                      model_arch="gigapath_slide_enc12l768d", seed=0, dropout=0.0, drop_path_rate=0.0,
                      **slide_kwargs)
    optimizer = ft.build_optimizer(model, lr=lr, weight_decay=0.05, layer_decay=0.95,
                                   num_layers=len(model.slide_encoder.encoder.layers) + 1)
    sched = ft.make_lr_scheduler(optimizer, lr=lr, min_lr=1e-6, warmup_epochs=0, epochs=1,
                                 steps_per_epoch=100, scheduler=scheduler)
    return model, ft.MultiSteps(optimizer, sched, gc=1), ft.get_loss_function(PANDA)


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


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
        check(set(g_k) == set(g_p), f"{dname}: the two paths reach different parameters")
        floor = 1e-2 * max(float(g.abs().max()) for g in g_p.values())
        errs = {}
        for name, gp in g_p.items():
            gk = g_k[name].float()
            gp = gp.float()
            check(bool(torch.isfinite(gk).all()), f"{dname}: non-finite gradient {name}")
            if bf16:
                cos = float((gk * gp).sum() / (gk.norm() * gp.norm() + 1e-30))
                errs[name] = 1.0 - cos if float(gp.abs().max()) > floor else 0.0
            else:
                errs[name] = float((gk - gp).abs().max()) / max(float(gp.abs().max()), floor)
        name, err = max(errs.items(), key=lambda kv: kv[1])
        tol = GRAD_BF16_MAX_ONE_MINUS_COS if bf16 else GRAD_F32_REL_TOL
        check(err <= tol, f"{dname} step gradient {name}: {err} > {tol}")
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
        torch.cuda.reset_peak_memory_stats()
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
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit("finetune_step", tiles=N_TILES, gc=1, launches=launches, **timing)
    del model, steps
    torch.cuda.empty_cache()

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
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.ops import flash_kernels as fk
    from gigapath_tpu_torch.ops import streaming_kernels as sk
    from gigapath_tpu_torch.quant import qflash, qmatmul

    for mod in (dk, qmatmul, qflash, sk, fk):
        mod.reset_launch_counts()


def all_launch_counts() -> dict:
    from gigapath_tpu_torch.ops import dilated_kernels as dk
    from gigapath_tpu_torch.ops import flash_kernels as fk
    from gigapath_tpu_torch.ops import streaming_kernels as sk
    from gigapath_tpu_torch.quant import qflash, qmatmul

    return {**dk.LAUNCHES, **qmatmul.LAUNCHES, **qflash.LAUNCHES, **sk.LAUNCHES, **fk.LAUNCHES}


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


def _sass_counts(name: str, **defines) -> dict:
    """Tensor-core instructions in the built library's SASS (``cuobjdump
    -sass``): HGMMA (wgmma), HMMA (mma.sync, fp16/bf16), IMMA (int8)."""
    from gigapath_tpu_torch.ops import _build

    lib = _build._target(name, tuple(sorted(defines.items())))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA", "IMMA")}


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


def _profile(fn, top: int = 8) -> dict:
    """One ``fn()`` under ``torch.profiler``: the device's busy time (the
    union of the device activities' intervals) against the profiled window
    (first to last event), its idle share, and the kernels with the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CUDA)
    if not device:
        return {"device_time": "not measured (the profiler recorded no device activity)"}
    window_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy_us, cursor = 0.0, float("-inf")
    by_name: dict = {}
    for start, end, name in device:
        busy_us += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / window_us,
            "top_device_ms": [{"kernel": k[:120], "ms": ms, "calls": n} for k, (ms, n) in ranked]}


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
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(x), reps=3, warmup=0)
            with plain_tile_kernels():
                plain_fwd_ms = time_ms(lambda: model(x), reps=1, warmup=0)
            trace = _profile(lambda: model(x))
        peak = torch.cuda.max_memory_allocated() / 2**30
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


def _stream_bounds(pairs: int, cq: int, ck: int, itemsize: int, dtype_name: str) -> dict:
    """Least card time (ms) of each stream kernel's work on one pair: the
    (query, key) pairs the masks admit times 4, 6 or 8 Dh operations over
    the dtype's peak, or each input read once and each output written once
    over the HBM rate, whichever is larger."""
    D = E // H
    vec = cq * H * 4  # one fp32 [B, H, cq] vector
    rows, keys = cq * H * D * itemsize, ck * H * D * itemsize
    work = {
        "stream_pair_fwd": (4, 2 * rows + 2 * keys + vec),  # q, k, v in; out, lse out
        "stream_pair_bwd_dq": (6, 3 * rows + 2 * keys + 2 * vec),  # q, dout, k, v, lse, delta in; dq out
        "stream_pair_bwd_dkv": (8, 2 * rows + 4 * keys + 2 * vec),  # q, dout, k, v, lse, delta in; dk, dv out
    }
    out = {}
    for name, (per_pair, nbytes) in work.items():
        out[name] = max((per_pair * D * pairs / PEAK_FLOPS[dtype_name] * 1e3, "operations"),
                        (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    return out


def phase_stream_kernels():
    """The three chunk-pair kernels against their plain versions at the
    flagship's chunk pairs (STREAM_CASES), fp32 and bf16, on strided q, k, v
    (views of packed [B, c, 3, H, Dh] blocks); times of each branch's first
    pair."""
    import torch
    import torch.nn.functional as F

    from gigapath_tpu_torch.ops import streaming_kernels as sk

    D = E // H
    gen = torch.Generator(device="cuda").manual_seed(12)
    summary = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={})
               for name in STREAM_KERNELS}
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
                # the kernel's device time, and one wrapper call's (its host
                # work, the output fills and the launch) by CUDA events
                t = {name: device_ms(fn, f"{name}_kernel") for name, fn in calls.items()}
                record["ms"] = t
                record["wrapper_ms"] = {name: time_ms(fn) for name, fn in calls.items()}
                bounds = _stream_bounds(pairs, cq, ck, q.element_size(), dname)
                record["bound_ms"] = {n: b[0] for n, b in bounds.items()}
                record["bound_by"] = {n: b[1] for n, b in bounds.items()}
            if timed and dname == "bfloat16":
                plain = {
                    "stream_pair_fwd": time_ms(lambda: sk.stream_pair_fwd_reference(q, k, v, *geo), reps=3, warmup=1),
                    "stream_pair_bwd_dq": time_ms(lambda: sk.stream_pair_bwd_reference(*args, dkv=False), reps=3,
                                                  warmup=1),
                    "stream_pair_bwd_dkv": time_ms(lambda: sk.stream_pair_bwd_reference(*args, dq=False), reps=3,
                                                   warmup=1),
                }
                # library yardstick: one SDPA call with the boolean [H, cq, ck]
                # mask (and the backward of one, for dq, dk and dv at once)
                qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask[None]), reps=5)
                lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask[None])
                do_h = do.transpose(1, 2)
                lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qh, kh, vh), do_h, retain_graph=True), reps=5)
                library = {"stream_pair_fwd": lib_fwd, "stream_pair_bwd_dq": lib_bwd, "stream_pair_bwd_dkv": lib_bwd}
                record.update(plain_ms=plain, library_ms=library)
                for name in STREAM_KERNELS:
                    tot = summary[name]
                    tot["ms"] += t[name]
                    tot["plain_ms"] += plain[name]
                    tot["library_ms"] += library[name]
                    tot["bound_ms"] += bounds[name][0]
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
    emit("stream_kernels_per_branch", dtype="bfloat16",
         note="sum over one chunk pair per branch (the timed pairs); ms is the kernel's device time (torch.profiler), "
              "plain_ms and library_ms CUDA events around one call; library_ms of dq and dkv is one SDPA backward "
              "(dq, dk and dv) per pair",
         kernels=summary,
         ptxas={name: _ptxas(f"{name}-GP_HEAD_DIM={E // H}") for name in STREAM_KERNELS},
         tolerance={"out": KERNEL_TOL, "lse_covered": STREAM_LSE_TOL, "grads_rel": BWD_REL_TOL})
    return summary


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
            torch.cuda.reset_peak_memory_stats()
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
                            "peak_mem_gb_above_model": (torch.cuda.max_memory_allocated() - base) / 2**30}
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
                    in_order, N_TILES, model, chunk_tiles=STREAM_CHUNK))
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
    the dense kernel path's (``dilated_attention``), fp32, with the launches
    of the streaming backward."""
    import torch

    from gigapath_tpu_torch.ops.dilated_attention import dilated_attention
    from gigapath_tpu_torch.ops.streaming_prefill import streaming_dilated_attention

    gen = torch.Generator(device="cuda").manual_seed(14)
    D = E // H
    q, k, v = (torch.randn(1, STREAM_L, H, D, device="cuda", generator=gen) for _ in range(3))
    w = torch.randn(1, STREAM_L, H, D, device="cuda", generator=gen)
    grads = {}
    for name in ("stream", "dense"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if name == "stream":
            blocks = streaming_dilated_attention(
                *([t[:, a:b] for a, b in STREAM_BLOCKS] for t in leaves), STREAM_BLOCKS, *SCHEDULE)
            loss = sum((blk * w[:, a:b]).sum() for blk, (a, b) in zip(blocks, STREAM_BLOCKS))
            torch.cuda.synchronize()
            reset_all_launch_counts()
            loss.backward()
            torch.cuda.synchronize()
            launches = all_launch_counts()
        else:
            (dilated_attention(*leaves, *SCHEDULE).float() * w).sum().backward()
        grads[name] = [t.grad for t in leaves]
    want = dict.fromkeys(launches, 0)
    want.update(stream_pair_bwd_dq=STREAM_FOLDS // 12, stream_pair_bwd_dkv=STREAM_FOLDS // 12)
    check(launches == want, f"streaming backward launches {launches} != {want}")
    rel = {}
    for gname, a, b in zip(("dq", "dk", "dv"), grads["stream"], grads["dense"]):
        rel[gname] = _grad_rel_err(a, b)
        check(rel[gname] <= GRAD_F32_REL_TOL, f"streaming backward {gname} rel err vs dense {rel[gname]}")
    emit("stream_backward", dtype="float32", L=STREAM_L, launches=launches, max_rel_err_vs_dense=rel,
         tolerance=GRAD_F32_REL_TOL)
    return launches


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


def _fusion_bounds(B, L, plan, itemsize):
    """Least card time (ms) of each new kernel's work in one flagship layer
    (bytes over the HBM rate; they do a few operations per element): the
    direct pack's three tensors and one unpack in each clamped branch, the
    epilogue forward over the five branches (covered packed elements, one
    lse per covered (token, head), out and fused_lse written), and its
    backward over the five branches (covered dY lanes, lse and fused_lse,
    the whole packed cotangent written)."""
    pack = unpack = bwd = 0.0
    fwd = B * L * E * itemsize + B * L * H * 4  # out, fused_lse
    for g, S, r, m, Mp in plan.branches:
        band = B * L * E // r
        fwd += band * itemsize + B * L * H // r * 4
        bwd += band * itemsize + 2 * (B * L * H // r) * 4 + B * S * Mp * E * itemsize
        if S == 1 and r > 1:
            pack += 3 * (band + B * Mp * E) * itemsize
            unpack += (band + B * L * E) * itemsize
    return {name: b / HBM_BYTES_PER_S * 1e3 for name, b in (
        ("pack_phases_direct", pack), ("unpack_phases_direct", unpack),
        ("fusion_epilogue_fwd", fwd), ("fusion_epilogue_bwd", bwd))}


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


def _fusion_case(dk, B, dtype, gen, real_len, valid, timed: bool):
    """The four kernels vs their plain versions on one flagship layer's
    branches (q, k, v at L = 10241); returns the per-layer summary."""
    import torch

    L = N_TILES + 1
    dname = str(dtype).replace("torch.", "")
    q, k, v = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(3))
    plan = dk.plan_stream_fusion(L, E, H, *SCHEDULE)
    tot = {name: dict(ms=0.0, plain_ms=0.0, err=0.0, library_ms=None) for name in FUSION_KERNELS}
    outs, lses = [], []
    for (g, S, r, m, Mp), sl in zip(plan.branches, SCHEDULE[0]):
        kvlen = dk._branch_kvlen(B, S, g, r, m, real_len, valid, q.device)
        if S == 1 and r > 1:
            # direct pack: exact copy of its plain version and of the row-2 pack
            q6, k6, v6 = (dk.pack_phases_direct(x, g, S, r, Mp, H) for x in (q, k, v))
            for x, x6 in ((q, q6), (k, k6), (v, v6)):
                check(torch.equal(x6, dk.pack_phases_direct_reference(x, g, S, r, Mp, H)),
                      f"pack_phases_direct {dname} B={B} r={r}: differs from its plain version")
                check(torch.equal(x6, dk.pack_phases(x, g, S, r, Mp, H)),
                      f"pack_phases_direct {dname} B={B} r={r}: differs from pack_phases")
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
            pack = lambda: dk.pack_phases_direct(q, g, S, r, Mp, H)  # noqa: E731
            unpack = lambda: dk.unpack_phases_direct(out6, L, E, g, S, r)  # noqa: E731
            lib_pack, lib_unpack = _copy_yardsticks(dk, q, out6, q6, dense, g, S, r, Mp)
            for name, fn, plain, n, lib in (
                ("pack_phases_direct", pack, lambda: dk.pack_phases_direct_reference(q, g, S, r, Mp, H), 3, lib_pack),
                ("unpack_phases_direct", unpack, lambda: dk.unpack_phases_direct_reference(out6, L, E, g, S, r),
                 1, lib_unpack),
            ):
                t = tot[name]
                t["ms"] += n * graph_ms(fn)
                t["event_ms"] = t.get("event_ms", 0.0) + n * time_ms(fn)
                t["plain_ms"] += n * time_ms(plain, reps=5)
                t["library_ms"] = (t["library_ms"] or 0.0) + n * lib
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

    # the epilogue backward, one launch per branch: packed cotangents, exact 0
    # off the segment and the sequence
    dy = torch.randn(B, L, E, device="cuda", generator=gen).to(dtype)
    err_bwd = 0.0
    for l5, branch in zip(lses, plan.branches):
        g, S, r, m, Mp = branch
        d6 = dk.fusion_epilogue_bwd(dy, fused, l5, branch, H)
        d6_ref = dk.fusion_epilogue_bwd_reference(dy, fused, l5, branch, H)
        torch.testing.assert_close(d6, d6_ref, **EPILOGUE_BWD_TOL[dname])
        err_bwd = max(err_bwd, max_err(d6, d6_ref))
        inside = dk.pack_phases_reference(torch.ones(1, L, E, device="cuda"), g, S, r, Mp, H) > 0
        check(not bool(d6[:, ~inside[0]].any()), f"fusion_epilogue_bwd {dname} r={r}: slots off the extent not 0")
        check(bool(torch.isfinite(d6).all()), f"fusion_epilogue_bwd {dname} r={r}: non-finite")
    tot["fusion_epilogue_bwd"]["err"] = err_bwd
    for name in ("pack_phases_direct", "unpack_phases_direct"):
        tot[name]["err"] = 0.0  # checked bit-exact above
    record = {"dtype": dname, "B": B, "real_len": real_len,
              "valid": None if valid is None else valid.tolist(),
              "max_abs_err": {"epilogue_out": tot["fusion_epilogue_fwd"]["err"],
                              "epilogue_vs_dense_fusion": max_err(out, dense_out),
                              "fused_lse_covered": max_err(fused[covered], fused_ref[covered]),
                              "epilogue_bwd": err_bwd, "pack_direct": 0.0, "unpack_direct": 0.0}}
    if timed:
        weights = torch.softmax(torch.stack([dk._scatter_lse(l5, L, H, g, r, m)
                                             for l5, (g, S, r, m, Mp) in zip(lses, plan.branches)]), dim=0)
        fwd = lambda: dk.fusion_epilogue_fwd(outs, lses, plan)  # noqa: E731
        t = tot["fusion_epilogue_fwd"]
        t["ms"] = graph_ms(fwd)
        t["event_ms"] = time_ms(fwd)
        t["plain_ms"] = time_ms(lambda: dk.fusion_epilogue_fwd_reference(outs, lses, plan), reps=3, warmup=1)
        t["dense_route_ms"] = _device_busy_ms(lambda: _dense_fusion(dk, outs, lses, plan))
        t = tot["fusion_epilogue_bwd"]
        for l5, br in zip(lses, plan.branches):
            bwd = lambda: dk.fusion_epilogue_bwd(dy, fused, l5, br, H)  # noqa: E731
            t["ms"] += graph_ms(bwd)
            t["event_ms"] = t.get("event_ms", 0.0) + time_ms(bwd)
            t["plain_ms"] += time_ms(lambda: dk.fusion_epilogue_bwd_reference(dy, fused, l5, br, H), reps=3, warmup=1)
        t["dense_route_ms"] = _device_busy_ms(lambda: _dense_fusion_bwd(dk, dy, weights, plan))
        bounds = _fusion_bounds(B, L, plan, q.element_size())
        for name in FUSION_KERNELS:
            tot[name].update(bound_ms=bounds[name], bound_by="bytes")
        record["per_layer"] = tot
    emit("fusion_kernels", **record)
    return tot


def phase_fusion_kernels():
    """The four kernels vs their plain versions at the flagship's branch
    shapes: fp32 and bf16 with a ragged real length (timed), and a B = 2
    batch with per-row valid lengths."""
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(21)
    L = N_TILES + 1
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        summary[str(dtype).replace("torch.", "")] = _fusion_case(dk, 1, dtype, gen, L - 37, None, timed=True)
        _fusion_case(dk, 2, dtype, gen, L, torch.tensor([L, 7002], device="cuda"), timed=False)
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
            torch.cuda.reset_peak_memory_stats()
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
                      "peak_mem_gb_above_model": (torch.cuda.max_memory_allocated() - base) / 2**30}
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
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            dilated_attention(q, k, v, *SCHEDULE)
            timing[route]["attention_peak_gb_above_qkv"] = (torch.cuda.max_memory_allocated() - base) / 2**30
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
            torch.cuda.reset_peak_memory_stats()
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
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
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


def _flash_bounds(rows_per_cell, kv_per_cell, B, itemsize, dtype_name, flat: bool):
    """Least card time (ms) of each segment-flash kernel's work on one
    branch: the (query, key) pairs the masks admit (each cell's real query
    rows times its valid keys) times 4, 6 or 8 D operations over the
    dtype's peak, or each input read once and each output written once
    over the HBM rate, whichever is larger. ``rows_per_cell`` /
    ``kv_per_cell``: [H, S] (or [B, H, S]) counts."""
    import numpy as np

    D = E // H
    rows_c = np.broadcast_to(np.asarray(rows_per_cell, np.int64), np.shape(kv_per_cell))
    kv_c = np.asarray(kv_per_cell, np.int64)
    if kv_c.ndim == 2:
        rows_c, kv_c = rows_c[None].repeat(B, 0), kv_c[None].repeat(B, 0)
    pairs = float((rows_c * kv_c).sum())
    rows, keys = float(rows_c.sum()), float(kv_c.sum())
    prefix = "flat" if flat else "flash"
    work = {
        f"{prefix}_fwd": (4, (2 * rows + 2 * keys) * D * itemsize + rows * 4),
        f"{prefix}_bwd_dq": (6, (3 * rows + 2 * keys) * D * itemsize + 2 * rows * 4),
        f"{prefix}_bwd_dkv": (8, (2 * rows + 4 * keys) * D * itemsize + 2 * rows * 4),
    }
    return {name: max((per_pair * D * pairs / PEAK_FLOPS[dtype_name] * 1e3, "operations"),
                      (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
            for name, (per_pair, nbytes) in work.items()}


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


def _check_flash(label, dname, flat, ours, ref, dq_rows=None):
    """A branch's kernels against their plain versions: out and the covered
    lse by KERNEL_TOL / LSE_TOL, uncovered rows' lse at the sentinel, the
    gradients by BWD_REL_TOL (dq on the rows where it is specified)."""
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
    if dq_rows is not None:
        dq, r_dq = dq[:, :, :dq_rows], r_dq[:, :, :dq_rows]
    errs = {"out": max_err(out, r_out), "lse_covered": max_err(lse[covered], r_lse[covered])}
    for name, a, b in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv)):
        errs[name] = _grad_rel_err(a, b)
        check(errs[name] <= BWD_REL_TOL[dname], f"{label} {dname} {name}: rel err {errs[name]} > {BWD_REL_TOL[dname]}")
    return errs


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
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={})
              for name in FLASH_KERNELS}
    records = []
    for sl, r in zip(*BHLD_SCHEDULE):
        flat, args, geom = _flash_branch(fk, pda, qh, kh, vh, do, sl, r, real_len, valid)
        g, Lp, n, gp, m = geom
        if not flat:
            check(args[4] is None or args[4].device.type == "cuda", "the count table is not on the card")
        ours = _flash_fwd_bwd(fk, flat, args)
        ref = _flash_fwd_bwd(fk, flat, args, plain=True)
        errs = _check_flash(f"flash r={r}", dname, flat, ours, ref, dq_rows=real_len if flat else None)
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
                rows = fk.flat_kvlen(n, g, L)
                kv_cells = [fk.flat_kvlen(n, g, real_len)] * H
            else:
                fwd = lambda: fk.flash_fwd(q, k, v, extra)  # noqa: E731
                bargs = (q, k, v, dout, lse, delta, extra)
                dq_fn, dkv_fn = (lambda: fk.flash_bwd_dq(*bargs)), (lambda: fk.flash_bwd_dkv(*bargs))
                p_fwd = lambda: fk.flash_fwd_reference(q, k, v, extra)  # noqa: E731
                p_dq = lambda: fk.flash_bwd_reference(*bargs, dkv=False)  # noqa: E731
                p_dkv = lambda: fk.flash_bwd_reference(*bargs, dq=False)  # noqa: E731
                full = pda._branch_kvlen_bhld(H, n, g, r, m, L)
                rows = full if full is not None else [[m] * n] * H
                kv_cells = extra.cpu().numpy() if extra is not None else rows
            bounds = _flash_bounds(rows, kv_cells, B, q.element_size(), dname, flat)
            lib_fwd, lib_bwd = _sdpa_yardstick(flat, args, pda, geom)
            t = {f"{prefix}_fwd": time_ms(fwd), f"{prefix}_bwd_dq": time_ms(dq_fn),
                 f"{prefix}_bwd_dkv": time_ms(dkv_fn)}
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
                tot["plain_ms"] += plain[name]
                tot["library_ms"] += lib[name]
                tot["bound_ms"] += bounds[name][0]
                tot["err"] = max(tot["err"], err_of[name])
                tot["by"][bounds[name][1]] = tot["by"].get(bounds[name][1], 0.0) + bounds[name][0]
            record.update(ms=t, plain_ms=plain, library_ms_sdpa={"fwd": lib_fwd, "bwd": lib_bwd},
                          bound_ms={k_: b[0] for k_, b in bounds.items()},
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
             "dkv)"} if timed else {}))
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

    gen = torch.Generator(device="cuda").manual_seed(31)
    L = N_TILES + 1
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        summary[dname] = _flash_layer(fk, pda, 1, dtype, gen, L, None, timed=True)
        _flash_layer(fk, pda, 1, dtype, gen, L - 37, None, timed=False)
        _flash_layer(fk, pda, 2, dtype, gen, L, torch.tensor([L, 7002], device="cuda"), timed=False)

    # causal, both layouts, fp32, at flagship-width shapes
    errs = {}
    q5, k5, v5, d5 = (torch.randn(1, H, 2, 700, E // H, device="cuda", generator=gen) for _ in range(4))
    kvlen = torch.tensor([[[700, 513]] * H], dtype=torch.int32, device="cuda")
    args = (q5, k5, v5, d5, kvlen)
    errs["segmented"] = _check_flash("causal segmented", "float32", False,
                                     _flash_fwd_bwd(fk, False, args, causal=True),
                                     _flash_fwd_bwd(fk, False, args, causal=True, plain=True))
    qf, kf, vf, df = (torch.randn(1, H, 2500, E // H, device="cuda", generator=gen) for _ in range(4))
    args = (qf, kf, vf, df, (1024, 2400))
    errs["flat"] = _check_flash("causal flat", "float32", True, _flash_fwd_bwd(fk, True, args, causal=True),
                                _flash_fwd_bwd(fk, True, args, causal=True, plain=True), dq_rows=2400)
    emit("flash_causal", dtype="float32", max_err=errs, tolerance=BWD_REL_TOL["float32"])
    _flash_entry_points(fk, gen)
    return summary


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
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_inference_with_slide_encoder(x, coords, model)  # ends in a device->host copy
            secs.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
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
        torch.cuda.reset_peak_memory_stats()
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
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
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
    bounds = {"dilated_branch_fwd_pipe": _branch_bounds(dk, B, L, sl, r, real_len, kvlen, q.element_size(),
                                                        dname)["dilated_branch_fwd"]}
    bwd = _bwd_bounds(dk, B, L, sl, r, kvlen, q.element_size(), dname)
    bounds["dilated_branch_bwd_dq_pipe"] = bwd["dilated_branch_bwd_dq"]
    bounds["dilated_branch_bwd_dkv_pipe"] = bwd["dilated_branch_bwd_dkv"]
    numbers = {}
    for name in PIPE_KERNELS:
        numbers[name] = {
            "ms": time_ms(fns[name]), "serial_ms": time_ms(twins[name]),
            "plain_ms": time_ms(plains[name], reps=2, warmup=1),
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
    kernel, its serial twin, its plain version and SDPA with the key mask,
    and its backward, beside the bound) and at a ragged real length; a B = 2
    batch with per-row valid counts formed on the card; past 65535 cells."""
    import torch

    from gigapath_tpu_torch.ops import dilated_kernels as dk

    L = N_TILES + 1
    gen = torch.Generator(device="cuda").manual_seed(41)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        totals = {name: dict(ms=0.0, serial_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, by={})
                  for name in PIPE_KERNELS}
        for B, real_len, valid, timed in ((1, L, None, True), (1, L - 37, None, False),
                                          (2, L, torch.tensor([L, 7002], device="cuda"), False)):
            q, k, v, do = (torch.randn(B, L, E, device="cuda", generator=gen).to(dtype) for _ in range(4))
            for sl, r in zip(*SCHEDULE):
                record, numbers = _pipe_branch(dk, q, k, v, do, sl, r, real_len, valid, timed)
                emit("pipe_kernels", **record)
                for name, num in (numbers or {}).items():
                    tot = totals[name]
                    for key in ("ms", "serial_ms", "plain_ms", "bound_ms", "library_ms"):
                        tot[key] += num[key]
                    tot["err"] = max(tot["err"], num["err"])
                    tot["by"][num["bound_by"]] = tot["by"].get(num["bound_by"], 0.0) + num["bound_ms"]
            del q, k, v, do
        for tot in totals.values():
            tot["bound_by"] = max(tot.pop("by").items(), key=lambda kv: kv[1])[0]
            tot["vs_serial"] = tot["ms"] / tot["serial_ms"]
        summary[dname] = totals
        emit("pipe_kernels_per_layer", dtype=dname, kernels=totals,
             note="sum over the 5 branches of one layer at full length; serial_ms is the serial twin "
                  "(rows 1, 7a, 7b) on the same inputs; library_ms is SDPA with the key mask, and its "
                  "backward (dq, dk, dv) for dq and dkv")
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
        tile_launches, _, (tile_embeds, coords) = phase_tile_forward(tile_dir)
    launches.update({name: tile_launches["int8+attn"][name] for name in ("q_matmul", "q_flash_attention")})
    phase_two_stage(tile_embeds, coords)
    summary.update(phase_stream_kernels())
    stream = phase_stream_forward()
    phase_stream_serve()
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
    print(json.dumps({"kernels": [
        {"name": name, **meta, "launches": launches[name],
         "max_abs_err": summary[name]["err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"], "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"], "library_ms": summary[name]["library_ms"]}
        for name, meta in KERNELS.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
