"""Slide-level fine-tuning loop (counterpart of
``gigapath_tpu/finetune/training.py``), with the same control flow: per-fold
training with layer-decay AdamW, a per-step warmup + cosine schedule,
gradient accumulation over ``gc`` micro-steps, per-epoch validation, model
selection by the best validation macro AUROC (``val``) or the last epoch,
a checkpoint reload, and the test pass. The running loss, sec/it and mean
sequence length are echoed every 20 iterations.

A micro-step (:func:`train_step`) is forward, loss and backward, and every
``gc``-th one an optimizer step. ``bf16`` runs the forward under
``torch.autocast(bfloat16)``: parameters, gradients and optimizer state
stay fp32, activations are bf16, as in the JAX package. Echo goes through
``logging``; the JAX package's observability stack (run log, heartbeat,
compile watchdog, ledger, numerics) is not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from gigapath_tpu_torch.data.loader import DevicePrefetcher
from gigapath_tpu_torch.finetune.metrics import calculate_metrics_with_task_cfg
from gigapath_tpu_torch.finetune.utils import (
    MultiSteps,
    build_optimizer,
    get_loss_function,
    get_records_array,
    log_writer,
    make_lr_scheduler,
    make_writer,
)
from gigapath_tpu_torch.models.classification_head import get_model
from gigapath_tpu_torch.utils.checkpoint import MonitorScore, restore_checkpoint, save_checkpoint
from gigapath_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def count_model_statistics(model: torch.nn.Module) -> Dict[str, Any]:
    """Parameter counts by top-level module, and in total."""
    by_top: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        by_top[top] = by_top.get(top, 0) + p.numel()
    return {"total_params": sum(by_top.values()), "params_by_module": by_top}


def _unpack(batch: dict):
    return batch["imgs"], batch["coords"], batch["labels"], batch.get("pad_mask")


def _prefetched(loader, device: torch.device, bf16: bool) -> DevicePrefetcher:
    # the embeddings cross to the device in bf16 exactly when the forward
    # runs in bf16
    return DevicePrefetcher(loader, device, depth=2, bf16_keys=("imgs",) if bf16 else ())


def forward_backward(
    model: torch.nn.Module, loss_fn, images, coords, labels, pad_mask, *,
    multi_label: bool, bf16: bool,
) -> torch.Tensor:
    """Forward (under bf16 autocast when ``bf16``), loss, backward; the
    gradients add into ``.grad``. Returns the detached loss."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=bf16):
        logits = model(images, coords, pad_mask=pad_mask)
    loss = loss_fn(logits, labels if multi_label else labels[:, 0])
    loss.backward()
    return loss.detach()


def train_step(
    model: torch.nn.Module, loss_fn, steps: MultiSteps, images, coords, labels, pad_mask, *,
    multi_label: bool, bf16: bool,
) -> torch.Tensor:
    """One micro-step: :func:`forward_backward`, then ``steps.step()``,
    which steps the optimizer every ``gc``-th call. Returns the detached
    loss, not synchronised."""
    loss = forward_backward(
        model, loss_fn, images, coords, labels, pad_mask, multi_label=multi_label, bf16=bf16
    )
    steps.step()
    return loss


def train(dataloader, fold: int, args):
    """Train one fold; returns ``(val_records, test_records)``."""
    train_loader, val_loader, test_loader = dataloader
    device = resolve_device(getattr(args, "device", None))
    writer_dir = os.path.join(args.save_dir, f"fold_{fold}", "tensorboard")
    writer, report_to = make_writer(args.report_to, writer_dir, args)
    fold_dir = os.path.join(args.save_dir, f"fold_{fold}")

    model = get_model(
        input_dim=args.input_dim,
        latent_dim=args.latent_dim,
        feat_layer=args.feat_layer,
        n_classes=args.n_classes,
        model_arch=args.model_arch,
        pretrained=args.pretrained,
        freeze=args.freeze,
        global_pool=args.global_pool,
        device=device,
        seed=args.seed,
        dropout=args.dropout,
        drop_path_rate=args.drop_path_rate,
        max_wsi_size=args.max_wsi_size,
        tile_size=args.tile_size,
        checkpoint_activations=getattr(args, "checkpoint_activations", False),
    )
    stats = count_model_statistics(model)
    logger.info(f"Model statistics: {stats['total_params']:,} params")
    for mod, n in stats["params_by_module"].items():
        logger.info(f"  - {mod}: {n:,}")

    num_layers = len(model.slide_encoder.encoder.layers) + 1
    steps_per_epoch = max(len(train_loader) / args.gc, 1e-9)
    optimizer = build_optimizer(
        model,
        lr=args.lr,
        weight_decay=args.optim_wd,
        layer_decay=args.layer_decay,
        num_layers=num_layers,
        optim=args.optim,
        freeze_prefix="slide_encoder" if args.freeze else None,
    )
    scheduler = make_lr_scheduler(
        optimizer,
        lr=args.lr,
        min_lr=args.min_lr,
        warmup_epochs=args.warmup_epochs,
        epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        scheduler=args.lr_scheduler,
    )
    steps = MultiSteps(optimizer, scheduler, args.gc)  # one count for the whole fold
    loss_fn = get_loss_function(args.task_config)
    ckpt_path = os.path.join(fold_dir, "checkpoint.pt")
    # a resumed fold re-arms the monitor from the persisted best score, so
    # its first (possibly worse) epoch cannot overwrite the best checkpoint
    if getattr(args, "model_select", "val") == "val":
        monitor = MonitorScore.from_checkpoint(ckpt_path)
        if monitor.best_score is not None:
            logger.info(f"[resume] best-checkpoint monitor re-armed at {monitor.best_score:.4f}")
    else:
        monitor = MonitorScore()

    logger.info(f"Training on {len(train_loader.dataset)} samples")
    if val_loader is not None:
        logger.info(f"Validating on {len(val_loader.dataset)} samples")
    if test_loader is not None:
        logger.info(f"Testing on {len(test_loader.dataset)} samples")
    logger.info("Training starts!")

    val_records, test_records = None, None
    for epoch in range(args.epochs):
        logger.info(f"Epoch: {epoch}")
        train_records = train_one_epoch(train_loader, model, loss_fn, steps, epoch, args)

        if val_loader is not None:
            val_records = evaluate(val_loader, model, loss_fn, epoch, args)
            log_dict = {"train_" + k: v for k, v in train_records.items() if "prob" not in k and "label" not in k}
            log_dict.update({"val_" + k: v for k, v in val_records.items() if "prob" not in k and "label" not in k})
            log_writer(log_dict, epoch, report_to, writer)
            score = val_records["macro_auroc"]

        if args.model_select == "val" and val_loader is not None:
            monitor(score, {"params": model.state_dict()}, ckpt_path)
        elif args.model_select == "last_epoch" and epoch == args.epochs - 1:
            save_checkpoint(ckpt_path, {"params": model.state_dict()})

    model.load_state_dict(restore_checkpoint(ckpt_path)["params"])
    test_records = evaluate(test_loader, model, loss_fn, args.epochs, args)

    log_dict = {"test_" + k: v for k, v in test_records.items() if "prob" not in k and "label" not in k}
    log_writer(log_dict, fold, report_to, writer)
    if report_to == "wandb":
        writer.finish()
    else:
        writer.close()
    return val_records, test_records


def train_one_epoch(train_loader, model, loss_fn, steps: MultiSteps, epoch: int, args):
    """One epoch of micro-steps; the loss is read back to the host only at
    the 20-iteration echoes and at the end."""
    model.train()
    device = next(model.parameters()).device
    bf16 = getattr(args, "bf16", True)
    multi_label = args.task_config.get("setting", "multi_class") == "multi_label"
    start_time = time.time()
    seq_len = 0
    records = get_records_array(len(train_loader), args.n_classes)
    loss_sum: Optional[torch.Tensor] = None
    n_batches = 0

    for batch_idx, batch in enumerate(_prefetched(train_loader, device, bf16)):
        images, coords, labels, pad_mask = _unpack(batch)
        seq_len += images.shape[1]
        loss = train_step(
            model, loss_fn, steps, images, coords, labels, pad_mask,
            multi_label=multi_label, bf16=bf16,
        )
        loss_sum = loss if loss_sum is None else loss_sum + loss
        n_batches += 1

        if (batch_idx + 1) % 20 == 0:
            running_loss = float(loss_sum)  # the sync point
            time_per_it = (time.time() - start_time) / (batch_idx + 1)
            logger.info(
                "Epoch: {}, Batch: {}, Loss: {:.4f}, Time: {:.4f} sec/it, "
                "Seq len: {:.1f}, Slide ID: {}".format(
                    epoch, batch_idx, running_loss / (batch_idx + 1), time_per_it,
                    seq_len / (batch_idx + 1),
                    batch["slide_id"][-1] if "slide_id" in batch else "None",
                )
            )

    records["loss"] = (float(loss_sum) if loss_sum is not None else 0.0) / max(n_batches, 1)
    epoch_sec = time.time() - start_time
    logger.info(
        "Epoch: {}, Loss: {:.4f}, Epoch time: {:.1f}s ({:.3f} sec/it)".format(
            epoch, records["loss"], epoch_sec, epoch_sec / max(n_batches, 1)
        )
    )
    return records


@torch.no_grad()
def evaluate(loader, model, loss_fn, epoch: int, args):
    """Eval pass collecting probabilities, one-hot labels and the task's
    metrics. Samples skipped by the loader leave no rows behind."""
    model.eval()
    device = next(model.parameters()).device
    bf16 = getattr(args, "bf16", True)
    probs, onehots = [], []
    total_loss, n = 0.0, 0
    task_setting = args.task_config.get("setting", "multi_class")
    for batch in _prefetched(loader, device, bf16):
        images, coords, labels, pad_mask = _unpack(batch)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(images, coords, pad_mask=pad_mask)
        logits = logits.float()
        if task_setting == "multi_label":
            loss = loss_fn(logits, labels)
            probs.append(torch.sigmoid(logits)[0].cpu().numpy())
            onehots.append(labels[0].float().cpu().numpy())
        else:
            loss = loss_fn(logits, labels[:, 0])
            probs.append(torch.softmax(logits, dim=-1)[0].cpu().numpy())
            one_hot = np.zeros(args.n_classes, np.float32)
            one_hot[int(labels[0, 0])] = 1.0
            onehots.append(one_hot)
        total_loss += float(loss)
        n += 1

    records = get_records_array(n, args.n_classes)
    records["prob"] = np.stack(probs) if probs else records["prob"]
    records["label"] = np.stack(onehots) if onehots else records["label"]
    records.update(calculate_metrics_with_task_cfg(records["prob"], records["label"], args.task_config))
    records["loss"] = total_loss / max(n, 1)

    if task_setting == "multi_label":
        logger.info(
            "Epoch: {}, Loss: {:.4f}, Micro AUROC: {:.4f}, Macro AUROC: {:.4f}, "
            "Micro AUPRC: {:.4f}, Macro AUPRC: {:.4f}".format(
                epoch, records["loss"], records["micro_auroc"], records["macro_auroc"],
                records["micro_auprc"], records["macro_auprc"],
            )
        )
    else:
        info = "Epoch: {}, Loss: {:.4f}, AUROC: {:.4f}, ACC: {:.4f}, BACC: {:.4f}".format(
            epoch, records["loss"], records["macro_auroc"], records["acc"], records["bacc"]
        )
        for metric in args.task_config.get("add_metrics", []):
            info += ", {}: {:.4f}".format(metric, records[metric])
        logger.info(info)
    return records
