"""Batch inference over cached slide-feature files (counterpart of
``gigapath_tpu/inference.py``).

It loads a trained classification checkpoint, classifies every
``*_features.pt`` of a directory by softmax, writes a CSV of ``slide_id`` /
``predicted_label`` / ``confidence`` and reports the label distribution and
the mean confidence.

    python -m gigapath_tpu_torch.inference --model_path ckpt.pt \\
        --feature_dir feats/ [--device cpu]

Three paths:

- **bucketed** (the default): slides go through the serving stack
  (:mod:`gigapath_tpu_torch.serve`): the shape-bucket ladder, the request
  coalescer, one captured CUDA graph per ``(batch_size, bucket)`` key (on
  the CPU: the eager forward) and the content-hash cache, so a repeated
  slide costs no forward. A slide above the ladder's top rung is served on
  the exact-shape path;
- ``--stream``: streaming chunked prefill, every slide folded chunk by chunk
  through :mod:`gigapath_tpu_torch.serve.streaming` (attention temporaries
  O(chunk) whatever the tile count). ``GIGAPATH_CHUNKED_PREFILL`` makes it
  the default;
- ``--no-buckets``: the exact-shape path, one slide at a time at its own
  length.

Every path writes the JAX module's run log (``GIGAPATH_OBS`` /
``GIGAPATH_OBS_DIR``; by default ``<output dir>/obs/``), with a heartbeat,
and ends it with ``run_end`` (``fail_run`` on an error). ``--prefetch N``
(N > 0) runs a loader thread up to N slides ahead through the dist
boundary's bounded :class:`~gigapath_tpu_torch.dist.boundary.MemoryChannel`
on the bucketed and ``--stream`` paths, as the JAX module's does (the
exact-shape path loads inside its timed slide span). The model computes in
bf16, as the JAX module's does.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional

import numpy as np
import torch

from gigapath_tpu_torch.obs import (
    CompileWatchdog,
    Heartbeat,
    console,
    get_ledger,
    get_metrics,
    get_run_log,
    span,
)
from gigapath_tpu_torch.obs.runlog import fail_run
from gigapath_tpu_torch.ops.common import env_flag


def load_model(
    model_path: str,
    input_dim: int = 1536,
    latent_dim: int = 768,
    feat_layer: str = "11",
    n_classes: int = 2,
    model_arch: str = "gigapath_slide_enc12l768d",
    *,
    device=None,
    **kwargs,
):
    """The classification head with ``model_path`` loaded (a port
    checkpoint, or a reference ``.pt`` non-strictly), in bf16 and eval mode
    on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    from gigapath_tpu_torch.finetune.predict import _load_params_into_model
    from gigapath_tpu_torch.models.classification_head import get_model

    model = get_model(
        input_dim=input_dim, latent_dim=latent_dim, feat_layer=feat_layer,
        n_classes=n_classes, model_arch=model_arch, device=device, **kwargs,
    )
    if model_path:
        model = _load_params_into_model(model_path, model)
    return model.to(torch.bfloat16).eval()


def _load_features(path: str):
    """A ``.pt`` feature file -> ``(features [N, D], coords [N, 2] or
    None)``: a tensor, or a dict with ``features`` (or ``tile_embeds``) and
    optional ``coords``."""
    if not path.endswith(".pt"):
        raise ValueError(f"{path}: only .pt feature files are read (Orbax feature directories are not ported)")

    def to_np(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)

    t = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(t, dict):
        feats = t.get("features", t.get("tile_embeds"))
        if feats is None:
            raise ValueError(f"{path}: no 'features'/'tile_embeds' key")
        coords = t.get("coords")
        return to_np(feats), None if coords is None else to_np(coords)
    return to_np(t), None


def _feature_stream(feature_files, prefetch: int, runlog):
    """Yield ``(idx, path, feats, coords)`` for every feature file.

    ``prefetch == 0``: plain synchronous loads. ``prefetch > 0``: a loader
    thread runs ahead through the dist boundary's bounded
    :class:`~gigapath_tpu_torch.dist.boundary.MemoryChannel` — at most
    ``prefetch`` slides in flight (credit-based, so a slow device
    backpressures the loader onto the obs bus instead of into unbounded
    host memory), IO overlapped with dispatch.
    """
    if prefetch <= 0:
        for idx, path in enumerate(feature_files):
            feats, coords = _load_features(path)
            yield idx, path, feats, coords
        return

    import threading

    from gigapath_tpu_torch.dist.boundary import BoundaryConfig, EmbeddingChunk, MemoryChannel

    channel = MemoryChannel(BoundaryConfig(capacity=int(prefetch)), runlog=runlog,
                            name="inference.prefetch")
    failure: list = []

    def load():
        try:
            for idx, path in enumerate(feature_files):
                feats, coords = _load_features(path)
                feats = np.asarray(feats, np.float32)
                # digest=False: an intra-process handoff cannot corrupt, and
                # sha256 over a 10^5-tile slide would tax the hot path the
                # prefetch exists to speed up
                channel.send(EmbeddingChunk.build(
                    os.path.basename(path), idx, 0, feats.shape[0], feats,
                    coords=None if coords is None else np.asarray(coords, np.float32),
                    producer="loader", digest=False,
                ))
        except BaseException as e:  # surfaced on the consuming thread
            failure.append(e)
        finally:
            channel.close()

    loader = threading.Thread(target=load, name="inference-prefetch", daemon=True)
    loader.start()
    served = 0
    try:
        while served < len(feature_files):
            chunk = channel.recv(timeout=1.0)
            if chunk is None:
                if failure:
                    raise failure[0]
                continue
            yield chunk.chunk_id, feature_files[chunk.chunk_id], chunk.payload, chunk.coords
            channel.ack(chunk.seq)
            served += 1
        if failure:
            raise failure[0]
    finally:
        channel.close()
        loader.join(timeout=10)


def _coords_or_zeros(feats, coords, runlog, warned: list):
    """None coords become zeros (the positional signal collapses to one grid
    cell), with one warning per run (``warned`` is the shared flag)."""
    if coords is None:
        if not warned:
            runlog.echo("Warning: feature files carry no coords; using zeros "
                        "(positional signal collapses to one grid cell)")
            warned.append(True)
        coords = np.zeros((feats.shape[0], 2), np.float32)
    return np.asarray(coords, np.float32)


def _results_df(results, output_file: str, runlog, **run_end_fields):
    """The CSV and summary tail of every path; a write failure ends the run
    log with ``fail_run``, a success with ``run_end``."""
    import pandas as pd

    results_df = pd.DataFrame(results)
    try:
        results_df.to_csv(output_file, index=False)
    except Exception as e:
        fail_run(runlog, "inference.results", e)
        raise
    label_counts = {str(k): int(v) for k, v in results_df["predicted_label"].value_counts().items()}
    runlog.echo(f"Inference results saved to {output_file}")
    runlog.echo(f"Label distribution: {label_counts}")
    runlog.echo(f"Mean confidence: {results_df['confidence'].mean():.4f}")
    runlog.run_end(
        status="ok", n_slides=len(results), label_distribution=str(label_counts),
        mean_confidence=float(results_df["confidence"].mean()), **run_end_fields,
    )
    return results_df


def _result_row(slide_id: str, logits) -> dict:
    probs = torch.softmax(torch.from_numpy(np.array(logits, np.float32)), dim=-1).numpy().reshape(-1)
    pred = int(probs.argmax())
    return {"slide_id": slide_id, "predicted_label": pred, "confidence": float(probs[pred])}


def _slide_id(path: str) -> str:
    return os.path.basename(path).replace("_features.pt", "")


def _exact_logits(model, feats, coords) -> np.ndarray:
    """One slide's logits [n_classes] at its own length."""
    param = next(model.parameters())
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(feats, np.float32)[None], device=param.device).to(param.dtype)
        c = torch.as_tensor(np.asarray(coords, np.float32)[None], device=param.device)
        return model(x, c).float().cpu().numpy()[0]


def _run_inference_bucketed(model, feature_files, output_file: str, runlog, batch_size: int,
                            prefetch: int = 0):
    """The bucketed path: the serving stack's ladder, coalescer, per-bucket
    CUDA graphs and content-hash cache, driven synchronously. Submits
    stream one file at a time and full buckets dispatch at once (``step()``
    after every submit), so at most ``batch_size`` slides per bucket are
    resident (plus ``prefetch`` slides loaded ahead)."""
    from concurrent.futures import Future

    from gigapath_tpu_torch.serve import ServeConfig, SlideService

    dtype = next(model.parameters()).dtype

    def forward(m, embeds, coords, pad_mask):
        return m(embeds.to(dtype), coords, pad_mask=pad_mask)

    config = ServeConfig.from_env(
        max_batch=int(batch_size),
        # an offline batch driver has no latency bound: full buckets still
        # dispatch at once, partial ones flush in the final drain
        max_wait_s=float("inf"),
        feature_dim=int(model.input_dim),
    )
    identity = (f"{model.model_arch}|feat{'-'.join(map(str, model.feat_layer))}"
                f"|cls{model.n_classes}")
    service = SlideService(forward, model, config=config, runlog=runlog,
                           identity=identity, name="serve")
    results, warned = [], []
    try:
        with Heartbeat(runlog, name="inference") as heartbeat:
            futures = []
            for idx, path, feats, coords in _feature_stream(feature_files, prefetch, runlog):
                slide_id = _slide_id(path)
                feats = np.asarray(feats, np.float32)
                coords = _coords_or_zeros(feats, coords, runlog, warned)
                if feats.shape[0] > service.ladder.rungs[-1]:
                    # above the ladder's top rung: submit() would refuse it,
                    # so this slide takes the exact-shape path
                    runlog.echo(
                        f"Warning: {slide_id} has {feats.shape[0]} tiles, above the ladder's "
                        f"top rung {service.ladder.rungs[-1]}; serving it on the exact-shape "
                        "path (raise GIGAPATH_SERVE_BUCKET_MAX to bucket it)")
                    fut: Future = Future()
                    fut.set_result(_exact_logits(model, feats, coords))
                    futures.append((slide_id, fut))
                else:
                    futures.append((slide_id, service.submit(slide_id, feats, coords)))
                while service.step():  # dispatch any filled buckets now
                    pass
                heartbeat.beat(idx)
            # flush the partial batches, one step() per beat: each can pay
            # a capture plus a padded forward
            drained = len(feature_files)
            while True:
                n = service.step(drain=True)
                if n == 0 and service.queue.pending() == 0:
                    break
                drained += 1
                heartbeat.beat(drained)
            for slide_id, fut in futures:
                results.append(_result_row(slide_id, fut.result()))
    except Exception as e:
        fail_run(runlog, "inference.run_inference", e)
        raise
    finally:
        service.close()
    stats = service.stats()
    return _results_df(
        results, output_file, runlog,
        compile_seconds_total=stats["compile_seconds_total"],
        dispatches=stats["dispatches"],
        buckets_used=stats["buckets_used"],
        cache_hits=stats["cache"]["hits"],
        unexpected_retraces=stats["unexpected_retraces"],
        ledger_path=service.ledger.path,
    )


def _run_inference_streaming(model, feature_files, output_file: str, runlog, chunk_tiles: int,
                             prefetch: int = 0):
    """The ``--stream`` path: every slide folds through the streaming
    submitter, chunk by chunk (``prefetch`` slides loaded ahead)."""
    from gigapath_tpu_torch.serve.streaming import head_streaming_submitter, streaming_head_logits

    submitter = head_streaming_submitter(model, chunk_tiles=chunk_tiles or None, runlog=runlog)
    metrics = get_metrics(runlog)
    slide_walls = metrics.histogram("inference.slide_wall_s")
    results, warned = [], []
    try:
        with Heartbeat(runlog, name="inference") as heartbeat:
            for idx, path, feats, coords in _feature_stream(feature_files, prefetch, runlog):
                feats = np.asarray(feats, np.float32)
                coords = _coords_or_zeros(feats, coords, runlog, warned)
                with span("slide", runlog, fence=True) as sp:
                    session = submitter.open(_slide_id(path), feats.shape[0])
                    for i, (a, b) in enumerate(session.session.tile_bounds):
                        session.feed(i, feats[a:b], coords[a:b])
                    row = _result_row(_slide_id(path), streaming_head_logits(model, session.result()))
                results.append(row)
                runlog.step(idx, wall_s=sp.dur_s, synced=True, n_tiles=int(feats.shape[0]),
                            n_chunks=session.session.n_chunks,
                            predicted_label=row["predicted_label"], confidence=row["confidence"])
                if sp.dur_s is not None:
                    slide_walls.observe(sp.dur_s)
                metrics.maybe_flush()
                heartbeat.beat(idx)
    except Exception as e:
        fail_run(runlog, "inference.run_inference", e)
        raise
    return _results_df(results, output_file, runlog, streamed_slides=submitter.served,
                       chunk_tiles=submitter.chunk_tiles)


def _run_inference_exact(model, feature_files, output_file: str, runlog):
    """The ``--no-buckets`` path: one forward per slide at its own length
    (the oracle the bucketed path is held against)."""
    ledger = get_ledger(runlog)
    # nearly every slide is a new key here: the first gets the full profile,
    # the later ones their signature alone (counting each forward's ops
    # would cost every slide)
    watchdog = CompileWatchdog("inference.forward", runlog, ledger=ledger, fingerprint_later=False)
    metrics = get_metrics(runlog)
    slide_walls = metrics.histogram("inference.slide_wall_s")
    results, warned = [], []
    try:
        with Heartbeat(runlog, name="inference") as heartbeat:
            for idx, path in enumerate(feature_files):
                with span("slide", runlog, fence=True) as sp:
                    feats, coords = _load_features(path)
                    coords = _coords_or_zeros(feats, coords, runlog, warned)
                    key = (1, int(feats.shape[0]))
                    new = watchdog.is_new(key)
                    t0 = time.time()
                    if new:  # the key's first forward, profiled into the ledger
                        logits = watchdog.profile(key, _exact_logits, model, feats, coords)
                    else:
                        logits = _exact_logits(model, feats, coords)
                    row = _result_row(_slide_id(path), logits)
                    watchdog.record(key, time.time() - t0 if new else None)
                results.append(row)
                runlog.step(idx, wall_s=sp.dur_s, synced=True, n_tiles=int(feats.shape[0]),
                            predicted_label=row["predicted_label"], confidence=row["confidence"])
                if sp.dur_s is not None:
                    slide_walls.observe(sp.dur_s)
                metrics.maybe_flush()
                heartbeat.beat(idx)
    except Exception as e:
        fail_run(runlog, "inference.run_inference", e)
        raise
    return _results_df(results, output_file, runlog,
                       compile_seconds_total=watchdog.compile_seconds_total(),
                       ledger_path=ledger.path)


def run_inference(
    model,
    feature_dir: str,
    output_file: str,
    *,
    use_buckets: bool = True,
    batch_size: int = 16,
    prefetch: int = 0,
    stream: bool = False,
    stream_chunk: int = 0,
):
    """Classify every ``*_features.pt`` in ``feature_dir``; returns the
    results DataFrame (None when there is no feature file).
    ``use_buckets`` routes through the serving stack; False is the
    exact-shape path. ``prefetch > 0`` overlaps feature IO with dispatch
    through the dist boundary's bounded channel (at most that many slides
    in flight) on the bucketed and streaming paths."""
    feature_files = sorted(glob.glob(os.path.join(feature_dir, "*_features.pt")))
    if not feature_files:
        console(f"No feature files found in {feature_dir}")
        return None
    runlog = get_run_log(
        "inference", out_dir=os.path.dirname(os.path.abspath(output_file)),
        config={"feature_dir": feature_dir, "output_file": output_file,
                "n_slides": len(feature_files), "buckets": bool(use_buckets),
                "batch_size": int(batch_size), "prefetch": int(prefetch),
                "stream": bool(stream)},
    )
    if stream:
        return _run_inference_streaming(model, feature_files, output_file, runlog, int(stream_chunk),
                                        prefetch=prefetch)
    if use_buckets:
        return _run_inference_bucketed(model, feature_files, output_file, runlog, batch_size,
                                       prefetch=prefetch)
    return _run_inference_exact(model, feature_files, output_file, runlog)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="GigaPath model inference")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--feature_dir", type=str, required=True)
    parser.add_argument("--output_file", type=str, default="predictions.csv")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Slides coalesced per padded bucket batch (the serving stack's "
                             "max_batch; ignored under --no-buckets)")
    parser.add_argument("--no-buckets", dest="no_buckets", action="store_true",
                        help="Exact-shape path: one slide at a time at its own length")
    parser.add_argument("--stream", action="store_true",
                        help="Streaming chunked prefill (on by default when GIGAPATH_CHUNKED_PREFILL is set)")
    parser.add_argument("--stream-chunk", type=int, default=0,
                        help="Tiles per streaming-prefill chunk (0 = GIGAPATH_PREFILL_CHUNK, default 2048)")
    parser.add_argument("--prefetch", type=int, default=0,
                        help="Slides a loader thread runs ahead through the dist boundary's "
                             "bounded channel (0 = synchronous loads)")
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--model_arch", type=str, default="gigapath_slide_enc12l768d")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device; cuda unless given (cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)
    model = load_model(args.model_path, n_classes=args.num_classes, model_arch=args.model_arch,
                       device=args.device)
    return run_inference(
        model, args.feature_dir, args.output_file,
        use_buckets=not args.no_buckets, batch_size=args.batch_size, prefetch=args.prefetch,
        stream=bool(args.stream or env_flag("GIGAPATH_CHUNKED_PREFILL")),
        stream_chunk=args.stream_chunk,
    )


if __name__ == "__main__":
    main()
