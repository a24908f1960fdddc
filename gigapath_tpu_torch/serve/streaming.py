"""Serving-side streaming chunked prefill: a submit path that folds
(counterpart of ``gigapath_tpu/serve/streaming.py``).

A slide opens a
:class:`~gigapath_tpu_torch.models.streaming_encoder.StreamingEncoderSession`,
and its tile-embedding chunks fold into the encoder as they arrive, in any
order (duplicates are dropped), so producing chunks overlaps with folding
them. The dense entry stays the fallback and the oracle.

With ``peek_every = N`` (or ``GIGAPATH_DRIFT_PEEK_EVERY=N``) a session takes a
provisional embedding off the running partials every N folded chunks
(``StreamingEncoderSession.peek()``), with its cosine to the previous peek and
layer 0's branch lse spread; ``result()`` scores every peek against the final
embedding (``confidence``). Those records stay on the session
(:attr:`StreamingSlideSession.peeks`): the run-log events, trace spans, drift
sentinel and metrics histogram of the JAX submitter are not ported yet
(``ROADMAP.md`` Queue A item 15).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gigapath_tpu_torch.models.streaming_encoder import (
    StreamingEncoderSession,
    embeds_to_outputs,
    prefill_chunk_tiles,
)
from gigapath_tpu_torch.obs.drift import cosine, stream_peek_every


class StreamingSlideSession:
    """One slide's streaming serve: ``feed`` chunks, then ``result()``.

    ``feed`` takes objects with ``chunk_id``, ``payload`` and ``coords``, or
    an explicit ``(idx, embeds, coords)``; ``result()`` returns the
    ``layer_{i}_embed`` / ``last_layer_embed`` dict of
    ``pipeline.run_inference_with_slide_encoder``."""

    def __init__(self, submitter: "StreamingSubmitter", slide_id: str, n_tiles: int):
        self.submitter = submitter
        self.slide_id = slide_id
        self.session = StreamingEncoderSession(
            submitter.model, int(n_tiles), chunk_tiles=submitter.chunk_tiles, all_layer_embed=True,
        )
        self._outputs: Optional[Dict[str, np.ndarray]] = None
        # one record per peek: frontier, cos_prev, lse_spread, and after
        # result() its confidence (cosine to the final embedding)
        self.peeks: List[dict] = []
        self._peek_embeds: List[np.ndarray] = []

    def feed(self, chunk, embeds=None, coords=None) -> int:
        """Fold one chunk (any arrival order); returns the fold frontier,
        how many chunks are folded so far."""
        if embeds is None:
            cid, embeds, coords = chunk.chunk_id, chunk.payload, chunk.coords
        else:
            cid = int(chunk)
        frontier = self.session.feed(cid, embeds, coords)
        every = self.submitter.peek_every
        last = self.peeks[-1]["frontier"] if self.peeks else 0
        if every > 0 and last < frontier < self.session.n_chunks and frontier % every == 0:
            self._peek(frontier)
        return frontier

    def _peek(self, frontier: int) -> None:
        """One anytime read: the provisional last-layer embedding off the
        running partials, its cosine to the previous peek and layer 0's
        branch lse spread."""
        emb = self.session.peek()[-1].float().cpu().numpy().reshape(-1)
        cos_prev = cosine(emb, self._peek_embeds[-1]) if self._peek_embeds else None
        self._peek_embeds.append(emb)
        self.peeks.append({"frontier": frontier, "cos_prev": cos_prev,
                           "lse_spread": self.session.lse_spread()})

    def result(self) -> Dict[str, np.ndarray]:
        if self._outputs is None:
            self._outputs = embeds_to_outputs(self.session.finalize())
            self.submitter.served += 1
            final = self._outputs["last_layer_embed"].reshape(-1)
            for record, emb in zip(self.peeks, self._peek_embeds):
                record["confidence"] = cosine(emb, final)
        return self._outputs


class StreamingSubmitter:
    """Streaming-prefill front end over one slide encoder. ``open(slide_id,
    n_tiles)`` starts a slide; slides of any length share the model.
    ``chunk_tiles`` defaults to ``GIGAPATH_PREFILL_CHUNK``, ``peek_every``
    to ``GIGAPATH_DRIFT_PEEK_EVERY`` (0 = no peeks), both read here."""

    def __init__(self, model, *, chunk_tiles: Optional[int] = None,
                 peek_every: Optional[int] = None):
        self.model = model
        self.chunk_tiles = int(chunk_tiles or prefill_chunk_tiles())
        self.peek_every = int(peek_every if peek_every is not None else stream_peek_every())
        self.served = 0

    def open(self, slide_id: str, n_tiles: int) -> StreamingSlideSession:
        return StreamingSlideSession(self, slide_id, n_tiles)

    def stream_slide(self, slide_id: str, chunks, n_tiles: int) -> Dict[str, np.ndarray]:
        """Open, feed every chunk of ``chunks`` (objects with ``chunk_id``,
        ``payload`` and ``coords``) as the iterable yields it, and return
        the result."""
        session = self.open(slide_id, n_tiles)
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


def head_streaming_submitter(head_model, *, chunk_tiles: Optional[int] = None) -> StreamingSubmitter:
    """A :class:`StreamingSubmitter` over a ``ClassificationHead``'s slide
    encoder; apply :func:`streaming_head_logits` to each session's
    result."""
    return StreamingSubmitter(head_model.slide_encoder, chunk_tiles=chunk_tiles)
