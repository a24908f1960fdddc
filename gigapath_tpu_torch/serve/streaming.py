"""Serving-side streaming chunked prefill: a submit path that folds
(counterpart of ``gigapath_tpu/serve/streaming.py``).

A slide opens a
:class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`,
and its tile-embedding chunks (``EmbeddingChunk``s from the dist boundary, a
prefetch loader, or the tile-encoder fleet) fold into the encoder as they
arrive, in any order (duplicates are dropped), so producing chunks overlaps
with folding them. The dense entry stays the fallback and the oracle.

Obs wiring, as the JAX submitter's: one ``stream_open`` / ``stream_result``
event pair per slide (chunk counts, peeks, wall) on the submitter's run log.
``open(..., trace=ctx)`` threads a
:class:`~gigapath_tpu_torch.obs.reqtrace.TraceContext` so each fold and the
finalize land as ``fold`` / ``finalize`` spans in the slide's cross-process
causal tree.

With ``peek_every = N`` (or ``GIGAPATH_DRIFT_PEEK_EVERY=N``) a session takes a
provisional embedding off the running partials every N folded chunks
(``StreamingEncoderSession.peek()``) and emits one ``stream_peek`` event per
peek (frontier, cosine to the previous peek, layer 0's branch lse spread);
``result()`` scores every peek against the final embedding (``confidence``),
observes each cosine into the ``serve.stream_confidence`` histogram of the
submitter's metrics registry, and folds the final embedding into its
:class:`~gigapath_tpu_torch.obs.drift.DriftSentinel` when one is attached.
The records also stay on the session (:attr:`StreamingSlideSession.peeks`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gigapath_tpu_torch.models.streaming_encoder import (
    StreamingEncoderSession,
    embeds_to_outputs,
    prefill_chunk_tiles,
)
from gigapath_tpu_torch.obs.drift import cosine, stream_peek_every

# cosine-confidence ladder: 0.05-wide linear rungs over (0, 1] — the
# default exponential latency ladder would dump every confidence into two
# buckets
CONFIDENCE_BOUNDS = [i / 20 for i in range(1, 21)]


class StreamingSlideSession:
    """One slide's streaming serve: ``feed`` chunks, then ``result()``.

    ``feed`` takes objects with ``chunk_id``, ``payload`` and ``coords``, or
    an explicit ``(idx, embeds, coords)``; ``result()`` returns the
    ``layer_{i}_embed`` / ``last_layer_embed`` dict of
    ``pipeline.run_inference_with_slide_encoder``."""

    def __init__(self, submitter: "StreamingSubmitter", slide_id: str, n_tiles: int,
                 trace=None):
        self.submitter = submitter
        self.slide_id = slide_id
        self.trace = trace
        self.session = StreamingEncoderSession(
            submitter.model, int(n_tiles), chunk_tiles=submitter.chunk_tiles, all_layer_embed=True,
        )
        self._t_open = time.monotonic()
        self._outputs: Optional[Dict[str, np.ndarray]] = None
        # one record per peek: frontier, cos_prev, lse_spread, and after
        # result() its confidence (cosine to the final embedding)
        self.peeks: List[dict] = []
        self._peek_embeds: List[np.ndarray] = []
        if submitter.runlog is not None:
            submitter.runlog.event(
                "stream_open", slide=slide_id, n_tiles=int(n_tiles),
                n_chunks=self.session.n_chunks, chunk_tiles=submitter.chunk_tiles,
            )

    def feed(self, chunk, embeds=None, coords=None) -> int:
        """Fold one chunk (any arrival order); returns the fold frontier,
        how many chunks are folded so far."""
        if embeds is None:
            cid, embeds, coords = chunk.chunk_id, chunk.payload, chunk.coords
            parent = getattr(chunk, "parent_span_id", "") or None
        else:
            cid, parent = int(chunk), None
        t0 = time.monotonic()
        frontier = self.session.feed(cid, embeds, coords)
        if self.trace is not None:
            self.trace.add_span("fold", t0, time.monotonic(), chunk=cid, parent=parent)
        every = self.submitter.peek_every
        last = self.peeks[-1]["frontier"] if self.peeks else 0
        if every > 0 and last < frontier < self.session.n_chunks and frontier % every == 0:
            self._peek(frontier)
        return frontier

    def _peek(self, frontier: int) -> None:
        """One anytime read: the provisional last-layer embedding off the
        running partials, its cosine to the previous peek and layer 0's
        branch lse spread, as a record and a ``stream_peek`` event."""
        t0 = time.monotonic()
        emb = self.session.peek()[-1].float().cpu().numpy().reshape(-1)
        cos_prev = cosine(emb, self._peek_embeds[-1]) if self._peek_embeds else None
        self._peek_embeds.append(emb)
        record = {"frontier": frontier, "cos_prev": cos_prev,
                  "lse_spread": self.session.lse_spread()}
        self.peeks.append(record)
        if self.submitter.runlog is not None:
            self.submitter.runlog.event(
                "stream_peek", slide=self.slide_id, frontier=frontier,
                n_chunks=self.session.n_chunks,
                frac=round(frontier / self.session.n_chunks, 4),
                cos_prev=round(cos_prev, 6) if cos_prev is not None else None,
                lse_spread=round(record["lse_spread"], 4),
                wall_s=round(time.monotonic() - t0, 4),
            )

    def pending(self) -> List[int]:
        return self.session.pending()

    def result(self) -> Dict[str, np.ndarray]:
        if self._outputs is None:
            t0 = time.monotonic()
            self._outputs = embeds_to_outputs(self.session.finalize())
            if self.trace is not None:
                self.trace.add_span("finalize", t0, time.monotonic())
            self.submitter.served += 1
            final = np.asarray(self._outputs["last_layer_embed"], np.float32).reshape(-1)
            # provisional-vs-final convergence: each peek's cosine to the
            # final embedding, observed into the shared histogram
            confidences = []
            for record, emb in zip(self.peeks, self._peek_embeds):
                record["confidence"] = cosine(emb, final)
                confidences.append(round(record["confidence"], 6))
            hist = self.submitter.confidence_hist
            if hist is not None:
                for c in confidences:
                    hist.observe(c)
            if self.submitter.runlog is not None:
                self.submitter.runlog.event(
                    "stream_result", slide=self.slide_id, n_chunks=self.session.n_chunks,
                    peeks=len(confidences),
                    confidence_first=confidences[0] if confidences else None,
                    confidence_last=confidences[-1] if confidences else None,
                    wall_s=round(time.monotonic() - self._t_open, 4),
                )
            # the served embedding feeds the drift sentinel LAST: an
            # alarming transition's flight dump then carries this slide's
            # stream_peek/stream_result context
            if self.submitter.drift is not None:
                self.submitter.drift.observe(final)
        return self._outputs


class StreamingSubmitter:
    """Streaming-prefill front end over one slide encoder. ``open(slide_id,
    n_tiles)`` starts a slide; slides of any length share the model.
    ``chunk_tiles`` defaults to ``GIGAPATH_PREFILL_CHUNK``, ``peek_every``
    to ``GIGAPATH_DRIFT_PEEK_EVERY`` (0 = no peeks), both read here.
    ``runlog`` receives the per-slide events, ``drift`` (a
    :class:`~gigapath_tpu_torch.obs.drift.DriftSentinel`) every final
    embedding, ``metrics`` (a registry) the ``serve.stream_confidence``
    histogram."""

    def __init__(self, model, *, chunk_tiles: Optional[int] = None,
                 runlog=None, name: str = "serve.stream", drift=None,
                 peek_every: Optional[int] = None, metrics=None):
        self.model = model
        self.chunk_tiles = int(chunk_tiles or prefill_chunk_tiles())
        self.runlog = runlog
        self.name = name
        self.served = 0
        self.drift = drift
        self.peek_every = int(peek_every if peek_every is not None else stream_peek_every())
        self.confidence_hist = None
        if metrics is not None:
            self.confidence_hist = metrics.histogram("serve.stream_confidence",
                                                     bounds=CONFIDENCE_BOUNDS)

    def open(self, slide_id: str, n_tiles: int, trace=None) -> StreamingSlideSession:
        return StreamingSlideSession(self, slide_id, n_tiles, trace=trace)

    def stream_slide(self, slide_id: str, chunks, n_tiles: int, trace=None) -> Dict[str, np.ndarray]:
        """Open, feed every chunk of ``chunks`` (objects with ``chunk_id``,
        ``payload`` and ``coords``) as the iterable yields it, and return
        the result."""
        session = self.open(slide_id, n_tiles, trace=trace)
        for chunk in chunks:
            session.feed(chunk)
        return session.result()


@torch.no_grad()
def streaming_head_logits(head_model, embeds) -> np.ndarray:
    """The classifier of a ``ClassificationHead`` over a streaming session's
    per-layer embeddings (its selected layers concatenated on the feature
    axis, then the linear classifier) -> fp32 logits [1, n_classes].
    ``embeds``: the session's embedding list or its ``result()`` dict."""
    if isinstance(embeds, dict):
        n = sum(1 for key in embeds if key.startswith("layer_"))
        embeds = [embeds[f"layer_{i}_embed"] for i in range(n)]
    clf = head_model.classifier
    h = torch.cat([torch.as_tensor(embeds[i]).to(clf.weight.device) for i in head_model.feat_layer], dim=-1)
    # in the embeddings' dtype (fp32 from result()), as the JAX head applies
    # its classifier
    logits = torch.nn.functional.linear(
        h.reshape(-1, h.shape[-1]), clf.weight.to(h.dtype), clf.bias.to(h.dtype))
    return logits.float().cpu().numpy()


def head_streaming_submitter(head_model, *, chunk_tiles: Optional[int] = None,
                             runlog=None) -> StreamingSubmitter:
    """A :class:`StreamingSubmitter` over a ``ClassificationHead``'s slide
    encoder; apply :func:`streaming_head_logits` to each session's
    result."""
    return StreamingSubmitter(head_model.slide_encoder, chunk_tiles=chunk_tiles, runlog=runlog)
