"""Batch inference over cached slide-feature files (counterpart of
``gigapath_tpu/inference.py``).

It loads a trained classification checkpoint, classifies every
``*_features.pt`` of a directory by softmax, writes a CSV of ``slide_id`` /
``predicted_label`` / ``confidence`` and logs the label distribution and
the mean confidence.

    python -m gigapath_tpu_torch.inference --model_path ckpt.pt \\
        --feature_dir feats/ --stream [--device cpu]

Two paths run here:

- ``--stream``: streaming chunked prefill, every slide folded chunk by chunk
  through :mod:`gigapath_tpu_torch.serve.streaming` (attention temporaries
  O(chunk) whatever the tile count). ``GIGAPATH_CHUNKED_PREFILL`` makes it
  the default;
- ``--no-buckets``: the exact-shape path, one slide at a time at its own
  length.

Two are not ported yet and raise ``NotImplementedError``: the bucketed
default, which needs the serving stack's ``serve/service.py``, and
``--prefetch > 0``, which needs the dist boundary's ``dist/boundary.py``
(both ``ROADMAP.md`` Queue A item 11). The JAX module's run log, heartbeat
and metrics become ``logging``. The model computes in bf16, as the JAX
module's does.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Optional

import numpy as np
import torch

from gigapath_tpu_torch.ops.common import env_flag

logger = logging.getLogger(__name__)


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


def _coords_or_zeros(feats, coords, warned: list):
    """None coords become zeros (the positional signal collapses to one grid
    cell), with one warning per run (``warned`` is the shared flag)."""
    if coords is None:
        if not warned:
            logger.warning("feature files carry no coords; using zeros (positional signal "
                           "collapses to one grid cell)")
            warned.append(True)
        coords = np.zeros((feats.shape[0], 2), np.float32)
    return np.asarray(coords, np.float32)


def _results_df(results, output_file: str, **fields):
    """The CSV and summary tail of every path."""
    import pandas as pd

    results_df = pd.DataFrame(results)
    results_df.to_csv(output_file, index=False)
    label_counts = {str(k): int(v) for k, v in results_df["predicted_label"].value_counts().items()}
    logger.info("Inference results saved to %s", output_file)
    logger.info("Label distribution: %s", label_counts)
    logger.info("Mean confidence: %.4f", results_df["confidence"].mean())
    if fields:
        logger.info("Run: %s", fields)
    return results_df


def _result_row(slide_id: str, logits) -> dict:
    probs = torch.softmax(torch.as_tensor(np.asarray(logits, np.float32)), dim=-1).numpy().reshape(-1)
    pred = int(probs.argmax())
    return {"slide_id": slide_id, "predicted_label": pred, "confidence": float(probs[pred])}


def _slide_id(path: str) -> str:
    return os.path.basename(path).replace("_features.pt", "")


def _run_inference_streaming(model, feature_files, output_file: str, chunk_tiles: int,
                             prefetch: int = 0):
    """The ``--stream`` path: every slide folds through the streaming
    submitter, chunk by chunk."""
    if prefetch > 0:
        raise NotImplementedError(
            "inference --prefetch > 0 needs the dist boundary (dist/boundary.py), not ported "
            "yet (ROADMAP.md Queue A item 11)")
    from gigapath_tpu_torch.serve.streaming import head_streaming_submitter, streaming_head_logits

    submitter = head_streaming_submitter(model, chunk_tiles=chunk_tiles or None)
    results, warned = [], []
    for path in feature_files:
        feats, coords = _load_features(path)
        feats = np.asarray(feats, np.float32)
        coords = _coords_or_zeros(feats, coords, warned)
        session = submitter.open(_slide_id(path), feats.shape[0])
        for i, (a, b) in enumerate(session.session.tile_bounds):
            session.feed(i, feats[a:b], coords[a:b])
        results.append(_result_row(_slide_id(path), streaming_head_logits(model, session.result())))
    return _results_df(results, output_file, streamed_slides=submitter.served,
                       chunk_tiles=submitter.chunk_tiles)


def _run_inference_exact(model, feature_files, output_file: str):
    """The ``--no-buckets`` path: one forward per slide at its own length."""
    param = next(model.parameters())
    results, warned = [], []
    with torch.no_grad():
        for path in feature_files:
            feats, coords = _load_features(path)
            coords = _coords_or_zeros(feats, coords, warned)
            x = torch.as_tensor(np.asarray(feats, np.float32)[None], device=param.device).to(param.dtype)
            c = torch.as_tensor(coords[None], device=param.device)
            results.append(_result_row(_slide_id(path), model(x, c).float().cpu().numpy()))
    return _results_df(results, output_file)


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
    results DataFrame (None when there is no feature file)."""
    feature_files = sorted(glob.glob(os.path.join(feature_dir, "*_features.pt")))
    if not feature_files:
        logger.warning("No feature files found in %s", feature_dir)
        return None
    if stream:
        return _run_inference_streaming(model, feature_files, output_file, int(stream_chunk), prefetch)
    if use_buckets:
        raise NotImplementedError(
            "the bucketed inference path needs the serving stack (serve/service.py), not ported "
            "yet (ROADMAP.md Queue A item 11); pass --stream or --no-buckets")
    return _run_inference_exact(model, feature_files, output_file)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="GigaPath model inference")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--feature_dir", type=str, required=True)
    parser.add_argument("--output_file", type=str, default="predictions.csv")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Slides per padded bucket batch (the bucketed path, not ported yet)")
    parser.add_argument("--no-buckets", dest="no_buckets", action="store_true",
                        help="Exact-shape path: one slide at a time at its own length")
    parser.add_argument("--stream", action="store_true",
                        help="Streaming chunked prefill (on by default when GIGAPATH_CHUNKED_PREFILL is set)")
    parser.add_argument("--stream-chunk", type=int, default=0,
                        help="Tiles per streaming-prefill chunk (0 = GIGAPATH_PREFILL_CHUNK, default 2048)")
    parser.add_argument("--prefetch", type=int, default=0,
                        help="Slides a loader thread runs ahead (not ported yet: 0 only)")
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
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
