"""The tile-encoder worker process of the disaggregated pipeline
(counterpart of ``gigapath_tpu/dist/worker.py``).

One worker = one OS process (``python -m gigapath_tpu_torch.dist.worker``)
holding a lease, producing its assigned chunks of one slide's tile
embeddings through the boundary channel, and polling for ranges
re-assigned to it when a peer dies. The loop per iteration:

1. renew the lease (a dead worker is one that stops doing this);
2. produce the next pending chunk: load the chunk's tiles (a deterministic
   synthetic loader — any worker can load any tile range, like the
   production feature store), encode, ``send`` (which blocks on credits —
   backpressure propagates into this loop, never into unbounded memory);
3. pump retransmits for unacked chunks older than the timer;
4. pick up chunks re-assigned to this worker by the coordinator;
5. exit when the consumer publishes DONE (or the deadline passes).

Chaos (``GIGAPATH_CHAOS``, parsed ONCE host-side at worker start):
``kill_worker@K`` hard-kills THIS worker (SIGKILL — no goodbye, the lease
just stops renewing) after K produced chunks; ``slow_worker@K[:S]`` sleeps
S seconds before producing chunk K (``K='*'`` = every chunk);
``drop_chunk@K`` / ``dup_chunk@K`` act inside the channel's send.

Chunk production order matters to nobody downstream: the consumer either
assembles by tile range (dense mode) or folds at the deterministic chunk-id
frontier (``plan.chunked_prefill`` streaming mode) — so retransmits,
reassignment and interleaved production from a multi-worker fleet all
yield the identical slide embedding, bit-exact.

The ``dryrun`` encoder is numpy (a fixed seeded projection + tanh), bit for
bit the JAX package's: deterministic across processes, and it touches no
device. The quantized ViT tile encoder drops in behind the
same ``encode`` seam when the plan says ``encoder: "quant_vit"`` — see
:func:`make_encoder`: the registry tile arch with the plan's quantized
tier (``q_matmul`` and, with ``+attn``, ``q_flash_attention`` on the card),
weights deterministic from the plan's ``encoder_seed``, placed through the
``tile_encoder`` entry of :mod:`gigapath_tpu_torch.dist.stagemesh` on the
worker's ``--device`` (``cuda`` unless given). The kill/recover
bit-exactness contract is unchanged: re-encoding a chunk is the same
kernels on the same inputs on the same card (cuDNN is pinned to its
deterministic algorithms in the worker).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from gigapath_tpu_torch.dist.boundary import (
    BoundaryConfig,
    EmbeddingChunk,
    assign_chunks,
    plan_chunks,
)
from gigapath_tpu_torch.dist.membership import (
    WorkerLease,
    atomic_write_json,
    reassignments_for,
)
from gigapath_tpu_torch.dist.transport import make_producer
from gigapath_tpu_torch.resilience.chaos import get_chaos

DONE_MARKER = "DONE"


def load_plan(root: str) -> dict:
    with open(os.path.join(root, "plan.json"), encoding="utf-8") as fh:
        return json.load(fh)


def write_plan(root: str, plan: dict) -> str:
    os.makedirs(root, exist_ok=True)
    return atomic_write_json(os.path.join(root, "plan.json"), plan,
                             indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# the dryrun's deterministic tile loader + encoder
# ---------------------------------------------------------------------------

def chunk_tiles(plan: dict, start: int, stop: int):
    """Synthetic tile features + coords for one tile range, a pure
    function of (tile_seed, tile index) — the dryrun twin of a feature
    store any worker can read any range from."""
    rng = np.random.default_rng([int(plan["tile_seed"]), int(start)])
    n = stop - start
    feats = rng.standard_normal((n, int(plan["dim_in"])),
                                dtype=np.float32)
    coords = rng.uniform(0, 25000, (n, 2)).astype(np.float32)
    return feats, coords


def encoder_weights(plan: dict) -> np.ndarray:
    rng = np.random.default_rng(int(plan["encoder_seed"]))
    w = rng.standard_normal((int(plan["dim_in"]), int(plan["dim_out"])),
                            dtype=np.float32)
    return w / np.sqrt(np.float32(plan["dim_in"]))


def encode_chunk(plan: dict, weights: np.ndarray, start: int, stop: int):
    """feats [n, Din] -> embeds [n, Dout], bitwise-deterministic given
    the plan (same numpy, same machine — the dryrun's parity anchor)."""
    feats, coords = chunk_tiles(plan, start, stop)
    return np.tanh(feats @ weights, dtype=np.float32), coords


def chunk_images(plan: dict, start: int, stop: int):
    """Synthetic tile IMAGES + coords for one tile range — the real-
    encoder twin of :func:`chunk_tiles`, a pure function of
    (tile_seed, tile index) so retransmits, reassignment and interleaved
    multi-worker production stay bit-exact."""
    rng = np.random.default_rng([int(plan["tile_seed"]), int(start)])
    n = stop - start
    img = int(plan.get("img_size", 32))
    imgs = rng.standard_normal((n, img, img, 3)).astype(np.float32)
    coords = rng.uniform(0, 25000, (n, 2)).astype(np.float32)
    return imgs, coords


def make_encoder(plan: dict, *, device=None, state_dict=None):
    """The ``encode(start, stop) -> (embeds, coords)`` seam.

    ``plan["encoder"]`` selects the implementation behind the UNCHANGED
    surface: ``"dryrun"`` (default) is the seeded numpy projection;
    ``"quant_vit"`` is the quantized ViT tile encoder — the registry tile
    arch (``plan["tile_arch"]``, default ``vit_tile_enc_test``) with
    ``plan["quant"]``'s quantized tier, computing in ``plan["tile_dtype"]``
    (fp32 when absent, as the JAX worker; the card's quantized kernels take
    ``"bfloat16"``), weights from a ``torch.Generator`` seeded with
    ``encoder_seed`` on ``device`` (``cuda`` unless given), placed through
    the ``tile_encoder`` entry of the stage registry. ``state_dict``
    (optional) replaces the seeded weights — how a test hands the JAX
    package's weights over. Every chunk shape is run once before this
    returns, so the kernel builds never land inside a lease window.
    Produced embeddings round through the shared bf16 helper so every
    producer of tile embeddings feeds the slide stage bit-identical
    inputs."""
    encoder = plan.get("encoder", "dryrun")
    if encoder == "dryrun":
        weights = encoder_weights(plan)
        return lambda start, stop: encode_chunk(plan, weights, start, stop)
    if encoder != "quant_vit":
        # a typo'd encoder name must never silently run the dryrun
        # projection and look healthy
        raise ValueError(
            f"unknown plan encoder '{encoder}' (known: dryrun, quant_vit)"
        )

    import torch

    import gigapath_tpu_torch.models.tile_encoder  # noqa: F401  (registers the tile archs)
    from gigapath_tpu_torch.dist.stagemesh import place_stage
    from gigapath_tpu_torch.quant.qtensor import bf16_round_trip, normalize_mode
    from gigapath_tpu_torch.utils.device import resolve_device
    from gigapath_tpu_torch.utils.registry import create_model_from_registry

    dev = resolve_device(device)
    if dev.type == "cuda":
        # re-encoding a chunk in another process must give the same bits:
        # no benchmark-picked, possibly nondeterministic cuDNN algorithms
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
    mode = normalize_mode(plan.get("quant", "int8"))
    tile_dtype = plan.get("tile_dtype")
    with torch.device("meta"):
        model = create_model_from_registry(
            plan.get("tile_arch", "vit_tile_enc_test"),
            img_size=int(plan.get("img_size", 32)),
            embed_dim=int(plan["dim_out"]),
            quant=mode,
            dtype=getattr(torch, tile_dtype) if tile_dtype else None,
        )
    model = model.to_empty(device=dev)
    if state_dict is None:
        model.init_weights(
            torch.Generator(device=dev).manual_seed(int(plan["encoder_seed"])))
    else:
        model.load_state_dict(state_dict)
    model = place_stage("tile_encoder", model.eval(), [dev])

    @torch.no_grad()
    def forward(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(imgs).to(dev)
        return model(x).float().cpu().numpy()

    # run EVERY chunk shape NOW, before the caller registers its lease: the
    # kernel builds and first launches must never land inside the lease
    # window (a worker paying them mid-slide would look exactly like a dead
    # worker to the membership layer). plan_chunks emits at most two
    # shapes — the full chunk and a ragged tail.
    chunk = int(plan.get("chunk_tiles", 8))
    img = int(plan.get("img_size", 32))
    tail = int(plan["n_tiles"]) % chunk if plan.get("n_tiles") else 0
    for n in {chunk} | ({tail} if tail else set()):
        forward(np.zeros((n, img, img, 3), np.float32))

    def encode(start: int, stop: int):
        imgs, coords = chunk_images(plan, start, stop)
        return bf16_round_trip(forward(imgs)), coords

    return encode


# ---------------------------------------------------------------------------
# the worker loop
# ---------------------------------------------------------------------------

def run_tile_worker(root: str, worker_id: str, *,
                    deadline_s: float = 120.0, runlog=None,
                    device=None) -> dict:
    """Produce this worker's share (initial assignment + anything
    re-assigned to it) until the consumer publishes DONE. Returns the
    channel stats (also folded into the worker's ``run_end``). ``device``
    is where a ``quant_vit`` encoder runs (``cuda`` unless given)."""
    plan = load_plan(root)
    cfg = BoundaryConfig.from_env(
        capacity=plan.get("credits"), chunk_tiles=plan.get("chunk_tiles"),
        retransmit_s=plan.get("retransmit_s"), poll_s=plan.get("poll_s"),
    )
    own_log = runlog is None
    if own_log:
        from gigapath_tpu_torch.obs.runlog import get_run_log

        # run_start=False: the manifest's device probe would initialise
        # CUDA in a dryrun worker that never touches a device; a worker
        # emits its own minimal manifest instead
        runlog = get_run_log(f"dist-{worker_id}", out_dir=root,
                             echo=False, run_start=False)
        runlog.event("run_start", driver=f"dist-{worker_id}",
                     pid=os.getpid(), worker=worker_id,
                     slide=plan.get("slide_id"))
    # chaos parses AFTER the log exists: a typo'd spec is an error event
    # + raise, never a silently clean chaos run
    chaos = get_chaos(runlog)
    workers = sorted(plan["workers"])
    rank = workers.index(worker_id) if worker_id in workers else -1
    chunks = plan_chunks(int(plan["n_tiles"]), cfg.chunk_tiles)
    by_id = {cid: (start, stop) for cid, start, stop in chunks}
    mine: List[int] = assign_chunks(
        [c[0] for c in chunks], workers,
    ).get(worker_id, [])

    # build (and, for the quant_vit encoder, warm) the encoder BEFORE
    # registering the lease: the expensive one-time setup must not eat
    # into the first lease window — a worker building kernels is not a
    # dead worker
    encode = make_encoder(plan, device=device)
    lease = WorkerLease(root, worker_id, stage="tile",
                        lease_s=plan.get("lease_s"))
    lease.register()
    # the transport seam: dir (the dryrun stand-in) or tcp (the real
    # wire), chosen by the plan / GIGAPATH_DIST_TRANSPORT — nothing
    # below this line changes with the transport
    producer = make_producer(root, cfg, producer=worker_id,
                             runlog=runlog, chaos=chaos,
                             transport=plan.get("transport"),
                             run_id=getattr(runlog, "run_id", ""))
    from gigapath_tpu_torch.obs.reqtrace import get_tracer
    from gigapath_tpu_torch.obs.spans import span

    # the fleet trace context: the slide's trace id was minted at PLAN
    # time, so this worker's encode/send/backpressure spans land in the
    # same causal tree as the consumer's fold spans with no coordination
    ctx = get_tracer(runlog).context(
        str(plan.get("trace_id", "")), actor=worker_id,
        name=str(plan.get("slide_id", "")),
    )

    pending: List[int] = list(mine)
    seen_reassign: set = set()
    produced = 0
    done_path = os.path.join(root, DONE_MARKER)
    t_deadline = time.monotonic() + deadline_s
    status = "ok"
    try:
        while time.monotonic() < t_deadline:
            lease.renew()
            if pending:
                cid = pending.pop(0)
                start, stop = by_id[cid]
                sent = False
                # the per-chunk span carries the WORKER index as its
                # rank (every worker process is rank 0 of its own):
                # obs_report's per-rank straggler table keys on exactly
                # this tag
                with span("dist.chunk", runlog, rank=rank, chunk=cid,
                          tiles=stop - start, worker=worker_id,
                          trace=ctx):
                    with span("dist.encode", runlog, rank=rank, chunk=cid,
                              worker=worker_id, trace=ctx):
                        if chaos:
                            # inside the span: injected slowness models
                            # slow COMPUTE, and the straggler table (and
                            # the fleet critical path) must see it
                            slow = chaos.slow_worker(cid)
                            if slow:
                                time.sleep(slow)
                        embeds, coords = encode(start, stop)
                    chunk = EmbeddingChunk.build(
                        plan["slide_id"], cid, start, stop, embeds,
                        coords=coords, producer=worker_id,
                        trace_id=ctx.trace_id,
                        # the producer's send-span id is STRUCTURAL, so
                        # it can ride the header before the span closes:
                        # the consumer's deliver span parents on it
                        parent_span_id=ctx.span_id_for("send", chunk=cid),
                    )
                    # a credit-blocked send must not starve the lease:
                    # bound each wait well under the lease window and
                    # renew between attempts — backpressure is healthy,
                    # being declared dead because of it is not. Pump
                    # retransmits between attempts too: at low credit a
                    # DROPPED earlier write can be the very thing
                    # holding every credit, and only a re-send frees it
                    blocked0 = producer.stats.blocked_s
                    t_send0 = time.monotonic()
                    while True:
                        lease.renew()
                        try:
                            producer.send(chunk,
                                          timeout=lease.lease_s / 4.0)
                            sent = True
                            break
                        except TimeoutError:
                            if os.path.exists(done_path):
                                # the run is over (consumer finished or
                                # failed): nobody will ack this credit
                                # back — drain out instead of spinning
                                # to our own deadline
                                break
                            if time.monotonic() >= t_deadline:
                                raise
                            producer.pump_retransmits()
                    if sent:
                        # split the send wall into credit-blocked wait
                        # vs the actual transmit: two adjacent trace
                        # spans, so the fleet critical path can tell
                        # backpressure from wire time. Manual add_span
                        # (not span()): the split is known only after
                        # the fact, from the producer's blocked_s delta
                        t_send1 = time.monotonic()
                        blocked = max(
                            producer.stats.blocked_s - blocked0, 0.0)
                        blocked = min(blocked, t_send1 - t_send0)
                        if blocked > 0:
                            ctx.add_span("backpressure_wait", t_send0,
                                         t_send0 + blocked, chunk=cid)
                        ctx.add_span("send", t_send0 + blocked, t_send1,
                                     chunk=cid)
                if not sent:
                    break  # DONE appeared while credit-blocked
                produced += 1
                if chaos:
                    chaos.maybe_kill_worker(produced)
                continue
            if os.path.exists(done_path):
                break
            producer.pump_retransmits()
            for cid in reassignments_for(root, worker_id, seen_reassign):
                if cid in by_id and cid not in pending:
                    pending.append(cid)
            time.sleep(cfg.poll_s)
        else:
            status = "deadline"
    except BaseException:
        status = "error"
        raise
    finally:
        # retire ONLY on a clean exit: a worker dying on an exception
        # (or its deadline) must leave its lease to EXPIRE, so the
        # coordinator counts it lost and reassigns its chunks — deleting
        # the lease here would dress every crash up as an orderly
        # shutdown and strand the slide
        if status == "ok":
            lease.retire()
        if own_log:
            runlog.event("run_end", status=status, worker=worker_id,
                         produced=produced, **producer.stats.as_dict())
            runlog.close()
    return {**producer.stats.as_dict(), "status": status}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dist tile worker (module docstring)"
    )
    ap.add_argument("--root", required=True, help="shared pipeline workdir")
    ap.add_argument("--worker", required=True, help="worker id (e.g. w0)")
    ap.add_argument("--deadline-s", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="torch device of a quant_vit encoder (cuda unless "
                         "given; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    stats = run_tile_worker(args.root, args.worker,
                            deadline_s=args.deadline_s, device=args.device)
    # a deadlined worker did NOT complete its share: exit nonzero so the
    # orchestrator's process-exit probe (and any supervisor) sees a
    # failure, not a clean drain
    return 0 if stats.get("status") == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
