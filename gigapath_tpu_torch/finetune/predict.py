"""Prediction CLI: run a fine-tuned checkpoint over a dataset (counterpart
of ``gigapath_tpu/finetune/predict.py``).

It loads a fine-tuned checkpoint (a port checkpoint from
:mod:`gigapath_tpu_torch.utils.checkpoint`, or a reference ``.pt`` whose
``slide_encoder.*`` / ``classifier.*`` keys load non-strictly), predicts
probabilities per slide, and writes ``predictions.csv`` with ``slide_id`` /
``label`` / ``probabilities`` columns and the wall-clock time. ``max_batches``
caps the batches (None = all). pandas is imported inside :func:`predict`;
echo goes through ``logging``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _load_subtree(module: torch.nn.Module, state: dict, name: str) -> None:
    """Non-strict load of ``state`` into ``module``: keys the module lacks,
    or whose shapes differ, are left out and reported."""
    own = module.state_dict()
    keep = {k: v for k, v in state.items() if k in own and tuple(own[k].shape) == tuple(v.shape)}
    unexpected = sorted(set(state) - set(keep))
    missing = sorted(set(own) - set(keep))
    module.load_state_dict(keep, strict=False)
    logger.info("%s loaded (%d missing, %d unexpected)", name, len(missing), len(unexpected))


def _load_params_into_model(checkpoint_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``checkpoint_path`` into the ``ClassificationHead`` ``model``: a
    port checkpoint (a dict with ``params``, as fine-tuning saves it) loads
    strictly; a reference ``.pt`` loads its ``slide_encoder.*`` and
    ``classifier.*`` keys non-strictly. Returns the model."""
    from gigapath_tpu_torch.utils.convert import load_torch_state_dict

    state = load_torch_state_dict(checkpoint_path)
    if isinstance(state, dict) and isinstance(state.get("params"), dict):
        model.load_state_dict(state["params"])
        return model
    for prefix in ("slide_encoder", "classifier"):
        sub = {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}
        if sub:
            sub = {k.replace("_checkpoint_wrapped_module.", ""): v for k, v in sub.items()}
            _load_subtree(getattr(model, prefix), sub, prefix)
    return model


def predict(
    checkpoint_path: str,
    dataset_csv: str,
    root_path: str,
    task_cfg_path: str,
    save_dir: str,
    exp_name: str,
    max_batches: Optional[int] = None,
    argv: Optional[list] = None,
):
    """Predict on every slide of ``dataset_csv``; writes predictions.csv
    under ``save_dir/<task>/<exp_name>/predictions`` and returns the
    results as a DataFrame. ``argv`` takes the fine-tuning flags (model,
    ``--device``, ``--bf16`` ...)."""
    import pandas as pd

    from gigapath_tpu_torch.data.loader import DataLoader
    from gigapath_tpu_torch.data.slide_dataset import SlideDataset
    from gigapath_tpu_torch.finetune.params import get_finetune_params
    from gigapath_tpu_torch.finetune.task_configs.utils import load_task_config
    from gigapath_tpu_torch.finetune.utils import seed_everything
    from gigapath_tpu_torch.models.classification_head import get_model

    start_time = time.time()
    args = get_finetune_params(argv or [])
    args.checkpoint_path = checkpoint_path
    args.dataset_csv = dataset_csv
    args.root_path = root_path
    args.task_cfg_path = task_cfg_path
    args.save_dir = save_dir
    args.exp_name = exp_name
    logger.info("Prediction arguments: %s", args)

    seed_everything(args.seed)
    args.task_config = load_task_config(args.task_cfg_path)
    args.task = args.task_config.get("name", "task")
    args.model_arch = args.task_config.get("model_arch", args.model_arch)
    args.save_dir = os.path.join(args.save_dir, args.task, args.exp_name, "predictions")
    os.makedirs(args.save_dir, exist_ok=True)

    dataset = pd.read_csv(args.dataset_csv)
    predict_data = SlideDataset(
        dataset, args.root_path, dataset["slide_id"].tolist(), args.task_config,
        split_key="slide_id",
    )
    args.n_classes = predict_data.n_classes
    predict_loader = DataLoader(predict_data, batch_size=args.batch_size)  # in order

    model = get_model(
        input_dim=args.input_dim, latent_dim=args.latent_dim, feat_layer=args.feat_layer,
        n_classes=args.n_classes, model_arch=args.model_arch, global_pool=args.global_pool,
        device=args.device, seed=args.seed, dropout=args.dropout, drop_path_rate=args.drop_path_rate,
    )
    logger.info("Loading checkpoint from: %s", checkpoint_path)
    model = _load_params_into_model(checkpoint_path, model).eval()
    device = next(model.parameters()).device

    multi_label = args.task_config.get("setting", "multi_class") == "multi_label"
    results = []
    with torch.no_grad():
        for batch_idx, batch in enumerate(predict_loader):
            if max_batches is not None and batch_idx >= max_batches:
                logger.info("Stopping after %d batches as requested", max_batches)
                break
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=args.bf16):
                logits = model(
                    torch.as_tensor(batch["imgs"], device=device),
                    torch.as_tensor(batch["coords"], device=device),
                    pad_mask=torch.as_tensor(batch["pad_mask"], device=device),
                )
            logits = logits.float()
            probs = (torch.sigmoid(logits) if multi_label else torch.softmax(logits, dim=-1)).cpu().numpy()
            labels = np.asarray(batch["labels"])
            for i, slide_id in enumerate(batch["slide_id"]):
                results.append({
                    "slide_id": slide_id,
                    "label": labels[i].tolist() if labels.ndim > 1 else labels[i],
                    "probabilities": probs[i].tolist(),
                })
            logger.info("Batch %d/%d processed.", batch_idx + 1, len(predict_loader))

    results_df = pd.DataFrame(results)
    output_csv_path = os.path.join(args.save_dir, "predictions.csv")
    results_df.to_csv(output_csv_path, index=False)
    logger.info("Predictions saved in: %s", output_csv_path)
    # every batch's probabilities were copied to the host above, so the
    # clock covers the finished work
    logger.info("Elapsed: %.4f s", time.time() - start_time)
    return results_df
