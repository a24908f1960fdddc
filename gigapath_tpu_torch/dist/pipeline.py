"""The slide-stage consumer and the two-process-group orchestrator
(counterpart of ``gigapath_tpu/dist/pipeline.py``).

:func:`run_slide_consumer` is the receiving fleet's loop: drain the
boundary channel, ack + assemble each chunk, poll worker leases, and on a
loss re-assign the dead worker's unacked chunk ids across survivors (the
elastic-degradation half of the recovery contract). When the plan's every
chunk is assembled it runs the slide-encoder forward over the dense
``[n_tiles, D]`` sequence — under a ``CompileWatchdog``, so a recovery can
never hide as a re-capture or a kernel rebuild — and publishes DONE so the
workers drain out. In chunked-prefill mode the chunks fold into a
:class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`
on arrival instead.

:func:`run_disaggregated` is the one-call run: write the plan, spawn one
OS process per tile worker (``python -m gigapath_tpu_torch.dist.worker``,
optionally with per-worker ``GIGAPATH_CHAOS`` — that is how a test kills
exactly one), run the consumer in the calling process (or in its own
``python -m gigapath_tpu_torch.dist.pipeline`` process), join the fleet.
All processes share a ``GIGAPATH_OBS_RUN_ID`` so their per-process JSONL
files merge in ``scripts/obs_report.py``. Every encoder runs on an explicit
device: ``cuda`` unless the caller passes one (``device="cpu"`` runs the
kernels' plain versions).

Bit-parity invariant: the assembled sequence is a pure function of the
plan — chunk ids, tile ranges and the deterministic encoder never depend
on which worker produced what — so a run that loses a worker mid-slide
yields the clean run's slide embedding BIT-exact, with the recovery
visible as ``worker_lost`` + ``recovery action="reassign"`` events rather
than as different numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from gigapath_tpu_torch.dist.boundary import (
    BoundaryConfig,
    ChunkTracker,
    SlideAssembler,
    assign_chunks,
    atomic_touch,
    plan_chunks,
)
from gigapath_tpu_torch.dist.membership import (
    Membership,
    WorkerLease,
    read_lease,
    write_reassignment,
)
from gigapath_tpu_torch.dist.transport import make_consumer
from gigapath_tpu_torch.dist.worker import DONE_MARKER, load_plan, write_plan
from gigapath_tpu_torch.resilience.chaos import get_chaos

RESULT_FILE = "result.npz"
CONSUMER_CKPT_DIR = "consumer-ckpt"

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_plan(*, slide_id: str = "slide0", n_tiles: int = 64,
                 dim_in: int = 16, dim_out: int = 8, chunk_tiles: int = 8,
                 workers: Optional[List[str]] = None, tile_seed: int = 0,
                 encoder_seed: int = 7, lease_s: float = 1.0,
                 credits: int = 4, retransmit_s: float = 0.5,
                 poll_s: float = 0.02,
                 chunked_prefill: bool = False,
                 transport: Optional[str] = None,
                 consumer_ckpt_every: Optional[int] = None,
                 encoder: Optional[str] = None,
                 quant: Optional[str] = None,
                 img_size: Optional[int] = None) -> dict:
    """The dryrun's plan document (written to ``<root>/plan.json``,
    read by every process — the shared deterministic truth).
    ``chunked_prefill`` puts the consumer in streaming mode: chunks fold
    into the slide encoder on arrival instead of assembling the dense
    sequence (the plan carries the mode so every process agrees).
    ``transport`` picks the boundary transport (``dir``/``tcp``; None =
    the ``GIGAPATH_DIST_TRANSPORT`` snapshot) and
    ``consumer_ckpt_every`` the consumer's checkpoint cadence in
    delivered chunks (None = the ``GIGAPATH_DIST_CONSUMER_CKPT_EVERY``
    snapshot; 0 = off) — in the plan so every process, restarted
    consumers included, agrees."""
    plan = dict(
        slide_id=slide_id, n_tiles=int(n_tiles), dim_in=int(dim_in),
        dim_out=int(dim_out), chunk_tiles=int(chunk_tiles),
        workers=sorted(workers or ["w0", "w1"]), tile_seed=int(tile_seed),
        encoder_seed=int(encoder_seed), lease_s=float(lease_s),
        credits=int(credits), retransmit_s=float(retransmit_s),
        poll_s=float(poll_s), chunked_prefill=bool(chunked_prefill),
        # the fleet-wide trace id, minted HERE at plan time: every
        # process reads it from plan.json, so producer and consumer
        # spans join one causal tree with zero coordination
        # (obs/reqtrace.py TraceContext)
        trace_id=f"tr-{slide_id}-{os.urandom(4).hex()}",
    )
    if transport is not None:
        plan["transport"] = str(transport)
    if consumer_ckpt_every is not None:
        plan["consumer_ckpt_every"] = int(consumer_ckpt_every)
    if encoder is not None:
        # "dryrun" (numpy projection) or "quant_vit" (the REAL quantized
        # tile encoder behind worker.make_encoder's seam); in the plan so
        # every worker — restarted or reassigned — builds the same one
        plan["encoder"] = str(encoder)
    if quant is not None:
        plan["quant"] = str(quant)
    if img_size is not None:
        plan["img_size"] = int(img_size)
    return plan


def _stage_head(dim_in: int, device):
    """The tiny slide encoder + classifier head of the default slide stage
    (the arch the chaos/serve smokes pin), fp32 and in eval mode, placed
    through the ``slide_encoder`` entry of the stage registry."""
    from gigapath_tpu_torch.dist.stagemesh import place_stage
    from gigapath_tpu_torch.models.classification_head import get_model
    from gigapath_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = get_model(
        input_dim=dim_in, latent_dim=32, feat_layer="1", n_classes=2,
        model_arch="gigapath_slide_enc_tiny", device=dev,
    )
    return place_stage("slide_encoder", model.eval(), [dev])


def _default_streaming_forward(device=None):
    """The default slide stage in CHUNKED-PREFILL form: the same head as
    :func:`_default_forward`, consumed through a
    :class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`
    so the consumer folds ``EmbeddingChunk``s on arrival instead of
    assembling the dense ``[n_tiles, D]`` sequence first. Returns
    ``build(dim_in) -> (open_session(n_tiles, chunk_tiles, runlog=None),
    head_fn)``; ``head_fn`` maps the session's per-layer embeds to the same
    logits the dense forward emits (the parity surface)."""
    from gigapath_tpu_torch.models.streaming_encoder import StreamingEncoderSession
    from gigapath_tpu_torch.serve.streaming import streaming_head_logits

    def build(dim_in: int):
        model = _stage_head(dim_in, device)

        def open_session(n_tiles: int, chunk_tiles: int, runlog=None):
            return StreamingEncoderSession(
                model.slide_encoder, n_tiles, chunk_tiles=chunk_tiles,
                all_layer_embed=True,
            )

        def head(embeds):
            # the ONE classifier-tail implementation (serve/streaming.py)
            # keeps the dist parity surface and the serving path in
            # lockstep
            return streaming_head_logits(model, embeds)[0]

        return open_session, head

    return build


def _default_forward(device=None):
    """The default slide stage: the tiny slide encoder + classifier head.
    Returns ``build(dim_in) -> (forward, model)``;
    ``forward(model, embeds [1, N, D], coords [1, N, 2])`` takes host
    arrays and returns the logits."""
    import torch

    def build(dim_in: int):
        model = _stage_head(dim_in, device)

        @torch.no_grad()
        def forward(m, embeds, coords):
            param = next(m.parameters())
            x = torch.as_tensor(embeds, device=param.device).to(param.dtype)
            c = torch.as_tensor(coords, device=param.device)
            return m(x, c)

        return forward, model

    return build


def _host(x) -> np.ndarray:
    """A forward's output (a tensor on any device, or an array) as fp32
    numpy."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _export_consumer_state(assembler, session) -> dict:
    """The consumer's durable fold state: the delivered-chunk watermark
    plus either the streaming session's frontier/partials or the dense
    assembly buffers — exactly what a restarted consumer needs for a
    BIT-exact resume."""
    state: dict = {
        "received": np.array(sorted(assembler.received), np.int64),
    }
    if session is not None:
        state["session"] = session.export_state()
    else:
        state["embeds"] = np.asarray(assembler.embeds)
        state["coords"] = np.asarray(assembler.coords)
    return state


def _restore_consumer_state(state: dict, assembler, session) -> List[int]:
    """Inverse of :func:`_export_consumer_state`; returns the restored
    watermark (sorted delivered chunk ids)."""
    received = [int(c) for c in np.asarray(state["received"]).tolist()]
    assembler.seed_received(received)
    if session is not None:
        session.restore_state(state["session"])
    else:
        assembler.embeds[...] = np.asarray(state["embeds"], np.float32)
        assembler.coords[...] = np.asarray(state["coords"], np.float32)
    return received


def run_slide_consumer(root: str, *, runlog=None,
                       forward_builder: Optional[Callable] = None,
                       streaming: Optional[bool] = None,
                       streaming_builder: Optional[Callable] = None,
                       deadline_s: float = 120.0,
                       worker_probe: Optional[Callable] = None,
                       ckpt_every: Optional[int] = None,
                       transport: Optional[str] = None,
                       device=None) -> dict:
    """Assemble one slide from the channel, recovering from worker loss.

    ``streaming`` (default: the plan's ``chunked_prefill`` field, else
    the ``GIGAPATH_CHUNKED_PREFILL`` snapshot) switches the consumer to
    chunked prefill: each acked ``EmbeddingChunk`` folds into a
    :class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`
    the moment the fold frontier reaches it — arrival order, retransmits
    and reassignment all tolerated, with the fold sequence (and so the
    embedding, BIT-exact) a pure function of the deterministic chunk
    plan. The dense ``[n_tiles, D]`` sequence is never assembled in this
    mode (``assembled``/``coords`` come back None).

    ``worker_probe`` (optional): zero-arg callable returning
    ``{worker_id: exit_code_or_None}`` for workers whose OS processes
    this host can see — direct evidence of death that beats waiting out
    the lease, and the ONLY detection for a worker that died before its
    first lease registration (no lease file ever existed for the expiry
    path to notice). Cross-host consumers pass nothing and rely on
    leases alone.

    ``ckpt_every`` (plan ``consumer_ckpt_every`` /
    ``GIGAPATH_DIST_CONSUMER_CKPT_EVERY``; 0 = off): checkpoint the
    fold state every N delivered chunks through
    :class:`~gigapath_tpu_torch.resilience.checkpoint.ResilientCheckpointer`'s
    atomic manifest discipline, and DEFER acks until the covering
    checkpoint commits — the ack watermark is the durable watermark, so
    a producer (or the reconnect handshake) replays exactly what a
    SIGKILLed consumer actually lost. A restart finds the checkpoint,
    emits ``consumer_lost`` + ``recovery action="consumer_resume"``,
    reloads the watermark, re-handshakes, receives only post-watermark
    chunks, and produces a BIT-exact slide embedding.

    ``forward_builder`` / ``streaming_builder`` replace the default slide
    stage (:func:`_default_forward` / :func:`_default_streaming_forward`,
    built on ``device``: ``cuda`` unless given).

    Returns ``{"embedding", "assembled", "coords", "stats", "lost",
    "reassignments"}``; raises TimeoutError when the slide cannot
    complete within ``deadline_s`` (no silent partial slides)."""
    from gigapath_tpu_torch.obs.runlog import env_number, get_run_log
    from gigapath_tpu_torch.obs.watchdog import CompileWatchdog
    from gigapath_tpu_torch.resilience.checkpoint import ResilientCheckpointer

    plan = load_plan(root)
    cfg = BoundaryConfig.from_env(
        capacity=plan.get("credits"), chunk_tiles=plan.get("chunk_tiles"),
        retransmit_s=plan.get("retransmit_s"), poll_s=plan.get("poll_s"),
    )
    own_log = runlog is None
    if own_log:
        runlog = get_run_log(
            "dist-consumer", out_dir=root,
            config={"slide": plan["slide_id"], "n_tiles": plan["n_tiles"],
                    "workers": plan["workers"],
                    "chunk_tiles": cfg.chunk_tiles},
        )
    chaos = get_chaos(runlog)
    if streaming is None:
        # one host-side read, the PipelineFlags convention: the plan
        # document wins (every process sees the same mode), the env
        # snapshot is the single-process default
        if "chunked_prefill" in plan:
            streaming = bool(plan["chunked_prefill"])
        else:
            from gigapath_tpu_torch.ops.dilated_kernels import snapshot_flags

            streaming = snapshot_flags().chunked_prefill
    if ckpt_every is None:
        ckpt_every = plan.get("consumer_ckpt_every")
    if ckpt_every is None:
        ckpt_every = env_number("GIGAPATH_DIST_CONSUMER_CKPT_EVERY", 0)
    ckpt_every = int(ckpt_every)
    if ckpt_every > cfg.capacity:
        # acks are deferred to the checkpoint cadence: a cadence past
        # the credit window would park every producer at 0 credits while
        # the consumer waits for chunks that can no longer arrive
        raise ValueError(
            f"consumer_ckpt_every={ckpt_every} exceeds the credit "
            f"capacity {cfg.capacity}: the deferred-ack discipline "
            "would deadlock — lower the cadence or raise "
            "GIGAPATH_DIST_CREDITS"
        )
    checkpointer = (
        ResilientCheckpointer(os.path.join(root, CONSUMER_CKPT_DIR),
                              keep=2, runlog=runlog)
        if ckpt_every > 0 else None
    )
    restored_state = None
    prior = read_lease(root, "consumer")
    if checkpointer is not None and checkpointer.checkpoints():
        # a checkpoint exists before this consumer delivered anything:
        # a predecessor died mid-slide. The worker_lost-style event
        # first (with the stale lease as post-mortem context), then the
        # verified restore.
        prior = prior or {}
        runlog.event(
            "consumer_lost", stage="slide", reason="checkpoint_found",
            pid=prior.get("pid"), last_renew=prior.get("renewed"),
        )
        runlog.echo(
            "[dist] consumer_lost: predecessor left a mid-slide "
            f"checkpoint (pid {prior.get('pid')}); resuming"
        )
        restored_state = checkpointer.restore_latest(emit_resume=False)
    elif prior and prior.get("pid") != os.getpid():
        # no checkpoint, but a stale consumer lease: the predecessor
        # died before its first checkpoint ever committed (leases only
        # outlive a CRASH — clean exits retire them). Nothing to
        # restore — every chunk is still unacked at the producers — but
        # the death itself must not be invisible on the bus.
        runlog.event(
            "consumer_lost", stage="slide", reason="stale_lease",
            pid=prior.get("pid"), last_renew=prior.get("renewed"),
        )
        runlog.echo(
            "[dist] consumer_lost: predecessor died before its first "
            f"checkpoint (pid {prior.get('pid')}); starting fresh"
        )
    membership = Membership(root, runlog=runlog)
    lease = WorkerLease(root, "consumer", stage="slide",
                        lease_s=plan.get("lease_s"))
    lease.register()
    chunks = plan_chunks(int(plan["n_tiles"]), cfg.chunk_tiles)
    session = None
    head_fn = None
    if streaming:
        build = streaming_builder or _default_streaming_forward(device)
        open_session, head_fn = build(int(plan["dim_out"]))
        session = open_session(int(plan["n_tiles"]), cfg.chunk_tiles,
                               runlog=runlog)
        runlog.event("stream_open", slide=plan["slide_id"],
                     n_chunks=session.n_chunks,
                     chunk_tiles=cfg.chunk_tiles)
        # received-chunk bookkeeping only (recovery needs the set of
        # delivered chunk ids) — the dense buffers are exactly what
        # streaming mode exists to not allocate
        assembler = ChunkTracker()
    else:
        assembler = SlideAssembler(int(plan["n_tiles"]), int(plan["dim_out"]))
    # anytime-peek cadence: GIGAPATH_DRIFT_PEEK_EVERY read ONCE here —
    # the consumer loop never touches the environment
    from gigapath_tpu_torch.obs.drift import cosine, stream_peek_every

    peek_every = stream_peek_every() if session is not None else 0
    last_peek = 0
    prev_peek: Optional[np.ndarray] = None
    assembler.expect([c[0] for c in chunks])
    watermark: List[int] = []
    if restored_state is not None:
        state, ckpt_step = restored_state
        watermark = _restore_consumer_state(state, assembler, session)
        runlog.recovery(
            action="consumer_resume", step=ckpt_step,
            chunks=len(watermark),
            missing=len(assembler.missing()),
        )
        runlog.echo(
            f"[dist] consumer_resume: watermark {len(watermark)} "
            f"chunk(s), {len(assembler.missing())} still missing"
        )
    # the transport seam (dir / tcp, one protocol): a restarted
    # consumer seeds its dedup + ack watermark from the checkpoint, so
    # the reconnect handshake replays only post-watermark chunks
    consumer = make_consumer(root, cfg, runlog=runlog,
                             transport=transport or plan.get("transport"),
                             delivered=watermark,
                             run_id=getattr(runlog, "run_id", ""))
    from gigapath_tpu_torch.obs.reqtrace import get_tracer
    from gigapath_tpu_torch.obs.spans import span

    # the consumer's half of the fleet trace (same plan-minted trace id
    # as every worker): deliver/fold/checkpoint/finalize spans, plus the
    # recovery gap as an EXPLICIT annotated span — detection to first
    # replayed chunk readable straight off the merged timeline
    ctx = get_tracer(runlog).context(
        str(plan.get("trace_id", "")), actor="consumer",
        name=str(plan.get("slide_id", "")),
    )
    # open recovery gap: (t_detect, action, who, closing chunk-id set —
    # None = the next delivered chunk closes it)
    gap_open: Optional[tuple] = None
    if restored_state is not None:
        gap_open = (time.monotonic(), "consumer_resume", "consumer", None)

    # who currently owns which chunk (updated by reassignments): the
    # coordinator's view of the SAME deterministic assignment the
    # workers computed for themselves
    owners: Dict[str, set] = {
        w: set(cids)
        for w, cids in assign_chunks([c[0] for c in chunks],
                                     plan["workers"]).items()
    }
    reassignments = 0
    pending_acks: List[int] = []
    delivered_here = 0  # chunks THIS process delivered (chaos cadence)
    deadline = time.monotonic() + deadline_s
    status = "ok"

    def _commit(final: bool = False) -> None:
        """Checkpoint the fold state, THEN flush the deferred acks: an
        ack is a promise the chunk is durable, so it must never precede
        the checkpoint that makes it so. With checkpointing off, acks
        are immediate and this only flushes."""
        if checkpointer is not None and (pending_acks or final):
            # chunk= the covered watermark: discriminates the structural
            # span id per commit (checkpoints repeat; spans must not
            # dedup into one)
            with span("dist.checkpoint", runlog, trace=ctx,
                      chunk=len(assembler.received)):
                checkpointer.save(
                    len(assembler.received),
                    _export_consumer_state(assembler, session),
                )
        while pending_acks:
            consumer.ack(pending_acks.pop(0))

    try:
        while not assembler.complete():
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"slide '{plan['slide_id']}' incomplete after "
                    f"{deadline_s}s: missing chunks {assembler.missing()}"
                )
            lease.renew()
            # the lease directory also carries the consumer's OWN lease
            # (and a crashed predecessor's stale one): only tile workers
            # of the plan are reassignment subjects
            newly_lost = [w for w in membership.poll_lost()
                          if w in plan["workers"]]
            if worker_probe is not None:
                for w, rc in worker_probe().items():
                    if rc is None or rc == 0:
                        continue  # still running / clean exit
                    if membership.report_lost(
                        w, reason="process_exit", stage="tile",
                        exit_code=rc,
                    ):
                        newly_lost.append(w)
            for lost in newly_lost:
                pending = sorted(
                    owners.get(lost, set()) - assembler.received
                )
                owners.pop(lost, None)
                survivors = [w for w in plan["workers"]
                             if w not in membership.lost()]
                if not pending:
                    continue
                if not survivors:
                    raise RuntimeError(
                        f"worker {lost} died holding chunks {pending} "
                        "and no survivors remain"
                    )
                new_owners = assign_chunks(pending, survivors)
                for w, cids in new_owners.items():
                    owners.setdefault(w, set()).update(cids)
                write_reassignment(root, lost_worker=lost,
                                   assignments=new_owners, runlog=runlog)
                reassignments += 1
                # the recovery gap opens at DETECTION and closes at the
                # first replayed chunk of the reassigned set — see the
                # delivery path below
                gap_open = (time.monotonic(), "reassign", lost,
                            set(pending))
            chunk = consumer.recv(timeout=cfg.poll_s * 5)
            if chunk is None:
                continue
            t_arrived = time.monotonic()
            if not assembler.add(chunk):
                # belt under the transport's dedup suspenders: already
                # held (and, with a checkpoint, already durable) — ack
                # so the producer's credit comes home
                consumer.ack(chunk.seq)
                continue
            # the cross-process causal link: the chunk header carries the
            # producer's structural send-span id, so this deliver span
            # parents on it and the fleet merger draws the flow arrow
            ctx.add_span("deliver", t_arrived, time.monotonic(),
                         chunk=chunk.chunk_id,
                         parent=chunk.parent_span_id or None,
                         producer=chunk.producer)
            if gap_open is not None and (gap_open[3] is None
                                         or chunk.chunk_id in gap_open[3]):
                # first replayed chunk after a recovery: close the gap
                # as one explicit annotated span on the timeline
                ctx.add_span("recovery_gap", gap_open[0], t_arrived,
                             chunk=chunk.chunk_id, action=gap_open[1],
                             worker=gap_open[2])
                gap_open = None
            if session is not None:
                # fold on arrival: the session frontier-buffers
                # out-of-order deliveries, so the executed fold order —
                # and the embedding, bit-exact — is the plan's, not the
                # network's. This overlaps stage-1 production with
                # stage-2 folding; by completion only the final layers
                # remain.
                with span("dist.fold", runlog, trace=ctx,
                          chunk=chunk.chunk_id):
                    frontier = session.feed(chunk.chunk_id, chunk.payload,
                                            chunk.coords)
                if (peek_every > 0 and frontier > last_peek
                        and frontier < session.n_chunks
                        and frontier % peek_every == 0
                        and hasattr(session, "peek")):
                    # provisional embedding off the running partials —
                    # same anytime surface serve/streaming.py exposes,
                    # here mid-recovery-capable: the peek reads only
                    # folded state, so replayed chunks never skew it
                    with span("dist.peek", runlog, trace=ctx,
                              fence=True, chunk=chunk.chunk_id) as sp:
                        emb_dev = session.peek()[-1]
                        sp.fence(emb_dev)
                    emb = _host(emb_dev).reshape(-1)
                    cos_prev = (cosine(emb, prev_peek)
                                if prev_peek is not None else None)
                    prev_peek = emb
                    last_peek = frontier
                    runlog.event(
                        "stream_peek", slide=plan["slide_id"],
                        frontier=frontier, n_chunks=session.n_chunks,
                        frac=round(frontier / session.n_chunks, 4),
                        cos_prev=(round(cos_prev, 6)
                                  if cos_prev is not None else None),
                        lse_spread=(round(session.lse_spread(), 4)
                                    if hasattr(session, "lse_spread")
                                    else None),
                        wall_s=(round(sp.dur_s, 4)
                                if sp.dur_s is not None else None),
                    )
            delivered_here += 1
            if chaos:
                # the consumer-crash injection point: AFTER the fold,
                # BEFORE any checkpoint/ack — what dies here is exactly
                # the state only a checkpoint brings back
                chaos.maybe_kill_consumer(delivered_here)
            if checkpointer is None:
                consumer.ack(chunk.seq)
            else:
                pending_acks.append(chunk.seq)
                if len(pending_acks) >= ckpt_every:
                    _commit()

        _commit(final=True)
        with span("dist.finalize", runlog, trace=ctx):
            if session is not None:
                embedding = head_fn(session.finalize())
                runlog.event("stream_finalize", slide=plan["slide_id"],
                             n_chunks=session.n_chunks)
            else:
                # the dense slide forward, watched — recovery must never
                # show up as a re-capture or a kernel rebuild
                build = forward_builder or _default_forward(device)
                forward, params = build(int(plan["dim_out"]))
                watchdog = CompileWatchdog("dist.slide_forward", runlog)
                instrumented = watchdog.wrap(forward)
                embedding = _host(
                    instrumented(params, assembler.embeds[None],
                                 assembler.coords[None]),
                )[0]
    except BaseException:
        status = "error"
        raise
    finally:
        # DONE even on failure: stranded workers must drain, not spin
        # out their whole deadline. (A SIGKILLed consumer never reaches
        # here — no DONE — so the fleet keeps producing for the
        # restarted consumer.)
        atomic_touch(os.path.join(root, DONE_MARKER))
        if status == "ok":
            lease.retire()
        close = getattr(consumer, "close", None)
        if close is not None:
            close()
        if own_log:
            runlog.run_end(
                status=status, slide=plan["slide_id"],
                lost=membership.lost(), reassignments=reassignments,
                **consumer.stats.as_dict(),
            )
    return {
        "embedding": embedding,
        "assembled": None if session is not None else assembler.embeds,
        "coords": None if session is not None else assembler.coords,
        "stats": consumer.stats.as_dict(),
        "lost": membership.lost(),
        "reassignments": reassignments,
        "streaming": session is not None,
    }


def _device_args(device) -> List[str]:
    return [] if device is None else ["--device", str(device)]


def spawn_worker(root: str, worker_id: str, *,
                 chaos: Optional[str] = None, run_id: Optional[str] = None,
                 deadline_s: float = 120.0, device=None) -> subprocess.Popen:
    """One tile-worker OS process. ``chaos`` lands in THAT worker's
    ``GIGAPATH_CHAOS`` only — how a test kills or slows exactly one member
    of the fleet. ``device`` is the worker's ``--device`` (``cuda`` unless
    given)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GIGAPATH_CHAOS", None)
    if chaos:
        env["GIGAPATH_CHAOS"] = chaos
    if run_id:
        env["GIGAPATH_OBS_RUN_ID"] = run_id
    return subprocess.Popen(
        [sys.executable, "-m", "gigapath_tpu_torch.dist.worker",
         "--root", root, "--worker", worker_id,
         "--deadline-s", str(deadline_s)] + _device_args(device),
        env=env, cwd=REPO_ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def spawn_consumer(root: str, *, chaos: Optional[str] = None,
                   run_id: Optional[str] = None,
                   deadline_s: float = 120.0, device=None) -> subprocess.Popen:
    """The slide consumer as ITS OWN OS process (``python -m
    gigapath_tpu_torch.dist.pipeline``) — the shape the consumer-crash
    recovery path needs: SIGKILLable, restartable, resuming from its
    checkpoint. ``chaos`` lands in that process's ``GIGAPATH_CHAOS``
    only (``kill_consumer@K``); ``device`` is its ``--device``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("GIGAPATH_CHAOS", None)
    if chaos:
        env["GIGAPATH_CHAOS"] = chaos
    if run_id:
        env["GIGAPATH_OBS_RUN_ID"] = run_id
    return subprocess.Popen(
        [sys.executable, "-m", "gigapath_tpu_torch.dist.pipeline",
         "--root", root, "--deadline-s", str(deadline_s)]
        + _device_args(device),
        env=env, cwd=REPO_ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )


def load_result(root: str) -> dict:
    """The subprocess consumer's published result
    (``<root>/result.npz``, atomic write)."""
    with np.load(os.path.join(root, RESULT_FILE),
                 allow_pickle=False) as z:
        return {"embedding": np.asarray(z["embedding"]),
                "streaming": bool(z["streaming"])}


def run_disaggregated(root: str, *, plan: Optional[dict] = None,
                      worker_chaos: Optional[Dict[str, str]] = None,
                      runlog=None, deadline_s: float = 120.0,
                      run_id: Optional[str] = None,
                      consumer_chaos: Optional[str] = None,
                      consumer_restarts: int = 1,
                      device=None,
                      forward_builder: Optional[Callable] = None,
                      streaming_builder: Optional[Callable] = None) -> dict:
    """One slide through the fleet: plan -> worker fleet (real processes)
    -> consumer.

    ``worker_chaos`` maps worker id -> ``GIGAPATH_CHAOS`` spec for that
    worker's process. Returns the consumer result plus worker exit
    codes.

    ``consumer_chaos`` (e.g. ``"kill_consumer@5"``) moves the consumer
    into its OWN process too; when that process dies nonzero the
    orchestrator restarts it (chaos-free) up to ``consumer_restarts``
    times — the restarted consumer resumes from its checkpoint
    watermark. The result then carries ``consumer_exit_codes``.

    ``device`` is every process's encoder device (``cuda`` unless given);
    ``forward_builder`` / ``streaming_builder`` replace the in-process
    consumer's default slide stage. Every worker is killed on the way out
    if it has not exited by then."""
    plan = plan or default_plan()
    write_plan(root, plan)
    worker_chaos = worker_chaos or {}
    procs = {
        w: spawn_worker(root, w, chaos=worker_chaos.get(w), run_id=run_id,
                        deadline_s=deadline_s, device=device)
        for w in plan["workers"]
    }
    consumer_exits: List[int] = []
    try:
        if consumer_chaos is None:
            result = run_slide_consumer(
                root, runlog=runlog, deadline_s=deadline_s, device=device,
                forward_builder=forward_builder,
                streaming_builder=streaming_builder,
                # the orchestrator holds the process handles: report a
                # nonzero exit the moment it happens instead of waiting
                # out the lease (and catch workers that died before
                # their first lease registration)
                worker_probe=lambda: {w: p.poll() for w, p in procs.items()},
            )
        else:
            proc = spawn_consumer(root, chaos=consumer_chaos,
                                  run_id=run_id, deadline_s=deadline_s,
                                  device=device)
            consumer_exits.append(proc.wait())
            while consumer_exits[-1] != 0 and \
                    len(consumer_exits) <= consumer_restarts:
                proc = spawn_consumer(root, run_id=run_id,
                                      deadline_s=deadline_s, device=device)
                consumer_exits.append(proc.wait())
            if consumer_exits[-1] != 0:
                raise RuntimeError(
                    f"consumer never completed: exit codes "
                    f"{consumer_exits}"
                )
            result = load_result(root)
            result.update(assembled=None, coords=None, stats=None,
                          lost=None, reassignments=None)
    finally:
        exit_codes: Dict[str, Optional[int]] = {}
        for w, proc in procs.items():
            try:
                exit_codes[w] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                exit_codes[w] = proc.wait()
    result["worker_exit_codes"] = exit_codes
    if consumer_exits:
        result["consumer_exit_codes"] = consumer_exits
    return result


def main(argv=None) -> int:
    """``python -m gigapath_tpu_torch.dist.pipeline`` — the slide consumer
    as a standalone process (SIGKILLable and restartable: the consumer-crash
    recovery path). Publishes its result atomically to
    ``<root>/result.npz`` so the orchestrator reads it across the
    process boundary."""
    ap = argparse.ArgumentParser(
        description="dist slide-stage consumer (module docstring)"
    )
    ap.add_argument("--root", required=True, help="shared pipeline workdir")
    ap.add_argument("--deadline-s", type=float, default=120.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the slide stage (cuda unless "
                         "given; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    result = run_slide_consumer(args.root, deadline_s=args.deadline_s,
                                device=args.device)
    tmp = os.path.join(args.root, f"{RESULT_FILE}.tmp-{os.getpid()}")
    with open(tmp, "wb") as fh:
        np.savez(fh, embedding=np.asarray(result["embedding"], np.float32),
                 streaming=np.bool_(result["streaming"]))
    os.replace(tmp, os.path.join(args.root, RESULT_FILE))
    return 0


if __name__ == "__main__":
    sys.exit(main())
