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
stay fp32, activations are bf16, as in the JAX package.

Observability, as the JAX loop's: every fold appends schema-versioned JSONL
events under ``<save_dir>/fold_k/obs/`` (``GIGAPATH_OBS=0`` disables the
stream but keeps the echo): ``step`` events (synced at the 20-iteration
echoes, with the loss), a ``CompileWatchdog`` over the step's
``(batch, tiles)`` buckets (a bucket's first step, synchronised and timed,
and the kernel builds it triggers; that step profiled, as it runs, into
the run's perf ledger), ``eval`` events, ``epoch`` / ``eval`` / ``test`` spans, the
``finetune.step_wall_s`` histogram, and heartbeat/stall liveness
(``GIGAPATH_OBS_HEARTBEAT_S`` / ``GIGAPATH_OBS_STALL_S``, 60/600 s by
default). A failure runs ``fail_run`` with an emergency checkpoint. Console
output goes through the run log's echo. The synced step events carry the
step's scalars (``grad_norm``, ``param_norm``; :mod:`..obs.telemetry`) and,
with ``GIGAPATH_NUMERICS`` (read once at driver start), a ``numerics``
event of per-layer summaries (:mod:`..obs.numerics`): reductions queued on
the device in the synced step only and read at its sync.
"""

from __future__ import annotations

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
from gigapath_tpu_torch.obs import (
    CompileWatchdog,
    Heartbeat,
    NullRunLog,
    get_ledger,
    get_metrics,
    get_run_log,
    span,
)
from gigapath_tpu_torch.obs.heartbeat import env_seconds
from gigapath_tpu_torch.obs.numerics import (
    NumericsMonitor,
    numerics_enabled,
    numerics_scalars,
    split_numerics,
)
from gigapath_tpu_torch.obs.runlog import fail_run
from gigapath_tpu_torch.obs.spans import fence_devices
from gigapath_tpu_torch.obs.telemetry import step_scalars, tree_norm
from gigapath_tpu_torch.utils.checkpoint import MonitorScore, restore_checkpoint, save_checkpoint
from gigapath_tpu_torch.utils.device import resolve_device


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
    multi_label: bool, bf16: bool, scalars: Optional[Dict[str, torch.Tensor]] = None,
    numerics: bool = False,
) -> torch.Tensor:
    """One micro-step: :func:`forward_backward`, then ``steps.step()``,
    which steps the optimizer every ``gc``-th call. Returns the detached
    loss, not synchronised.

    When ``scalars`` is a dict, the step also fills it with the JAX step's
    telemetry: ``grad_norm`` over this micro-step's gradients (every
    parameter, the frozen group's too; one the loss never reached counts as
    zero), ``param_norm`` after the update and, with ``numerics``, the
    ``num.grad.*`` summaries; 0-d tensors on the device, not synchronised.
    The gradients earlier micro-steps summed are parked for the backward
    and added back after it, which sums the same two values as the
    backward's own accumulation."""
    if scalars is None:
        loss = forward_backward(
            model, loss_fn, images, coords, labels, pad_mask, multi_label=multi_label, bf16=bf16
        )
        steps.step()
        return loss
    params = dict(model.named_parameters())
    parked = {name: p.grad for name, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    loss = forward_backward(
        model, loss_fn, images, coords, labels, pad_mask, multi_label=multi_label, bf16=bf16
    )
    grads = {name: torch.zeros_like(p) if p.grad is None else p.grad for name, p in params.items()}
    scalars.update(step_scalars(grads=grads))
    if numerics:
        scalars.update(numerics_scalars(grads=grads))
    for name, g in parked.items():
        p = params[name]
        p.grad = g if p.grad is None else p.grad.add_(g)
    steps.step()
    scalars["param_norm"] = tree_norm(params)
    return loss


def _obs_config(args) -> dict:
    """JSON-safe slice of the run config for the run_start manifest."""
    return {
        k: v
        for k, v in sorted(vars(args).items())
        if isinstance(v, (str, int, float, bool)) or v is None
    }


def train(dataloader, fold: int, args):
    """Train one fold; returns ``(val_records, test_records)``."""
    train_loader, val_loader, test_loader = dataloader
    device = resolve_device(getattr(args, "device", None))
    writer_dir = os.path.join(args.save_dir, f"fold_{fold}", "tensorboard")
    writer, report_to = make_writer(args.report_to, writer_dir, args)
    fold_dir = os.path.join(args.save_dir, f"fold_{fold}")
    # GIGAPATH_OBS is read here, once, at driver start: the event stream
    # lands under fold_dir/obs/
    runlog = get_run_log("finetune", out_dir=fold_dir, config=_obs_config(args))
    # a sample the loader skips after its retries lands as a `recovery`
    # event (action="data_retry") on this run's log
    for loader in (train_loader, val_loader, test_loader):
        dataset = getattr(loader, "dataset", None)
        if hasattr(dataset, "set_runlog"):
            dataset.set_runlog(runlog)

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
    runlog.echo(f"Model statistics: {stats['total_params']:,} params")
    for mod, n in stats["params_by_module"].items():
        runlog.echo(f"  - {mod}: {n:,}")

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
            runlog.echo(f"[resume] best-checkpoint monitor re-armed at {monitor.best_score:.4f}")
    else:
        monitor = MonitorScore()

    runlog.echo(f"Training on {len(train_loader.dataset)} samples")
    if val_loader is not None:
        runlog.echo(f"Validating on {len(val_loader.dataset)} samples")
    if test_loader is not None:
        runlog.echo(f"Testing on {len(test_loader.dataset)} samples")
    runlog.echo("Training starts!")

    # perf ledger: each new bucket's step lands its shape signature in
    # <fold_dir>/obs/*.ledger.json
    ledger = get_ledger(runlog)
    compile_log = CompileWatchdog("train_step", runlog, ledger=ledger)
    # deadline precedence: an explicit args attribute (programmatic
    # callers) wins; else the env knobs; else finetune's 60/600 — a large
    # bucket legitimately takes minutes per step
    hb_interval = getattr(args, "obs_heartbeat_s", None)
    hb_stall = getattr(args, "obs_stall_s", None)
    heartbeat = Heartbeat(
        runlog,
        interval_s=(float(hb_interval) if hb_interval is not None
                    else env_seconds("GIGAPATH_OBS_HEARTBEAT_S", 60.0)),
        stall_after_s=(float(hb_stall) if hb_stall is not None
                       else env_seconds("GIGAPATH_OBS_STALL_S", 600.0)),
        name="finetune",
    )
    # GIGAPATH_NUMERICS is read here, once, at driver start: off, the
    # step queues none of the per-layer reductions
    numerics_on = numerics_enabled()
    val_records, test_records = None, None
    try:
        with heartbeat:
            for epoch in range(args.epochs):
                runlog.echo(f"Epoch: {epoch}")
                with span("epoch", runlog, epoch=epoch):
                    train_records = train_one_epoch(
                        train_loader, model, loss_fn, steps, epoch, args,
                        compile_log=compile_log, runlog=runlog, heartbeat=heartbeat,
                        numerics=numerics_on,
                    )

                if val_loader is not None:
                    with span("eval", runlog, epoch=epoch):
                        val_records = evaluate(val_loader, model, loss_fn, epoch, args,
                                               runlog=runlog, heartbeat=heartbeat)
                    log_dict = {"train_" + k: v for k, v in train_records.items()
                                if "prob" not in k and "label" not in k}
                    log_dict.update({"val_" + k: v for k, v in val_records.items()
                                     if "prob" not in k and "label" not in k})
                    log_writer(log_dict, epoch, report_to, writer)
                    score = val_records["macro_auroc"]

                if args.model_select == "val" and val_loader is not None:
                    monitor(score, {"params": model.state_dict()}, ckpt_path)
                elif args.model_select == "last_epoch" and epoch == args.epochs - 1:
                    save_checkpoint(ckpt_path, {"params": model.state_dict()})

            # still inside the heartbeat scope: the test pass blocks on the
            # device too and must not be a stall-monitoring blind spot
            model.load_state_dict(restore_checkpoint(ckpt_path)["params"])
            with span("test", runlog):
                test_records = evaluate(test_loader, model, loss_fn, args.epochs, args,
                                        runlog=runlog, heartbeat=heartbeat)

        log_dict = {"test_" + k: v for k, v in test_records.items() if "prob" not in k and "label" not in k}
        log_writer(log_dict, fold, report_to, writer)
        if report_to == "wandb":
            writer.finish()
        else:
            writer.close()
    except Exception as e:
        # the shared failure tail (error event -> flight dump -> emergency
        # checkpoint -> terminal run_end)
        emergency = os.path.join(fold_dir, "emergency_checkpoint.pt")
        fail_run(
            runlog, "finetune.train", e,
            emergency=lambda: save_checkpoint(emergency, {"params": model.state_dict()}) or emergency,
        )
        raise

    runlog.run_end(
        status="ok",
        fold=fold,
        test_macro_auroc=float(test_records.get("macro_auroc", float("nan"))),
        compile_seconds_total=compile_log.compile_seconds_total(),
        stalls=heartbeat.stall_count,
        ledger_path=ledger.path,
    )
    return val_records, test_records


def train_one_epoch(train_loader, model, loss_fn, steps: MultiSteps, epoch: int, args, *,
                    compile_log: Optional[CompileWatchdog] = None, runlog=None,
                    heartbeat: Optional[Heartbeat] = None, numerics: bool = False):
    """One epoch of micro-steps; the loss is read back to the host only at
    the 20-iteration echoes and at the end (and a new bucket's first step
    is synchronised to time it). The step before each echo also computes
    its scalars (:func:`train_step`, with the per-layer numerics when
    ``numerics``), read at the echo's sync."""
    runlog = runlog if runlog is not None else NullRunLog(driver="finetune")
    # typed metrics (one registry per run across epochs; the final snapshot
    # flushes inside run_end). Only the synced 20-iteration walls are
    # observed — they are the device-truth numbers
    metrics = get_metrics(runlog)
    step_walls = metrics.histogram("finetune.step_wall_s")
    numerics_monitor = NumericsMonitor(runlog, name="finetune")
    model.train()
    device = next(model.parameters()).device
    bf16 = getattr(args, "bf16", True)
    multi_label = args.task_config.get("setting", "multi_class") == "multi_label"
    start_time = time.time()
    seq_len = 0
    records = get_records_array(len(train_loader), args.n_classes)
    loss_sum: Optional[torch.Tensor] = None
    n_batches = 0
    steps_per_epoch = len(train_loader)
    t_prev = start_time
    tel: Optional[Dict[str, torch.Tensor]] = None

    def step(images, coords, labels, pad_mask):  # this micro-step, with the batch's scalars dict
        return train_step(
            model, loss_fn, steps, images, coords, labels, pad_mask,
            multi_label=multi_label, bf16=bf16, scalars=tel, numerics=numerics,
        )

    for batch_idx, batch in enumerate(_prefetched(train_loader, device, bf16)):
        images, coords, labels, pad_mask = _unpack(batch)
        seq_len += images.shape[1]
        bucket = tuple(images.shape[:2])
        global_step = epoch * steps_per_epoch + batch_idx
        new_bucket = compile_log is not None and compile_log.is_new(bucket)
        if new_bucket and loss_sum is not None:
            # drain the queue first, or every pending step's runtime gets
            # billed to this bucket's first call
            fence_devices([loss_sum])
        synced = (batch_idx + 1) % 20 == 0
        tel = {} if synced else None
        t0 = time.time()
        if new_bucket:
            # the bucket's first step runs once, profiled into the ledger
            loss = compile_log.profile(bucket, step, images, coords, labels, pad_mask)
            fence_devices([loss])  # isolate the first call's cost
            compile_log.record(bucket, time.time() - t0)
        else:
            loss = step(images, coords, labels, pad_mask)
            if compile_log is not None:
                compile_log.record(bucket, None)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        n_batches += 1
        if heartbeat is not None:
            heartbeat.beat(global_step)

        if synced:
            running_loss = float(loss_sum)  # the sync point
            # timestamp AFTER the drain: the synced step's wall_s carries
            # the queued device work it just waited for
            t_now = time.time()
            time_per_it = (t_now - start_time) / (batch_idx + 1)
            # the step's scalars are done by now: one copy to the host
            scalars = dict(zip(tel, torch.stack(list(tel.values())).tolist()))
            scalars, num_scalars = split_numerics(scalars)
            runlog.step(
                global_step, wall_s=round(t_now - t_prev, 6), synced=True, epoch=epoch,
                bucket=str(bucket), loss=running_loss / (batch_idx + 1),
                sec_per_it=time_per_it, seq_len=seq_len / (batch_idx + 1), **scalars,
            )
            if num_scalars:
                numerics_monitor.emit(global_step, num_scalars)
            step_walls.observe(round(t_now - t_prev, 6))
            metrics.maybe_flush()
            runlog.echo(
                "Epoch: {}, Batch: {}, Loss: {:.4f}, Time: {:.4f} sec/it, "
                "Seq len: {:.1f}, Slide ID: {}".format(
                    epoch, batch_idx, running_loss / (batch_idx + 1), time_per_it,
                    seq_len / (batch_idx + 1),
                    batch["slide_id"][-1] if "slide_id" in batch else "None",
                ),
                step=global_step,
            )
        else:
            # unsynced: wall_s is host launch time; the report reads
            # `synced` and treats these accordingly
            t_now = time.time()
            runlog.step(global_step, wall_s=round(t_now - t_prev, 6), synced=bool(new_bucket),
                        epoch=epoch, bucket=str(bucket))
        t_prev = t_now

    records["loss"] = (float(loss_sum) if loss_sum is not None else 0.0) / max(n_batches, 1)
    epoch_sec = time.time() - start_time
    runlog.echo(
        "Epoch: {}, Loss: {:.4f}, Epoch time: {:.1f}s ({:.3f} sec/it)".format(
            epoch, records["loss"], epoch_sec, epoch_sec / max(n_batches, 1)
        ),
        step=epoch * steps_per_epoch + max(n_batches - 1, 0),
    )
    if compile_log is not None and compile_log.first_call_sec:
        runlog.echo(compile_log.summary())
    return records


@torch.no_grad()
def evaluate(loader, model, loss_fn, epoch: int, args, *, runlog=None,
             heartbeat: Optional[Heartbeat] = None):
    """Eval pass collecting probabilities, one-hot labels and the task's
    metrics. Samples skipped by the loader leave no rows behind. Each batch
    beats the heartbeat (step number untouched): a long healthy eval stays
    distinguishable from a hung one."""
    runlog = runlog if runlog is not None else NullRunLog(driver="finetune")
    model.eval()
    device = next(model.parameters()).device
    bf16 = getattr(args, "bf16", True)
    probs, onehots = [], []
    total_loss, n = 0.0, 0
    task_setting = args.task_config.get("setting", "multi_class")
    for batch in _prefetched(loader, device, bf16):
        if heartbeat is not None:
            heartbeat.beat()
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

    runlog.eval_event(
        epoch, **{k: float(v) for k, v in records.items() if isinstance(v, (int, float, np.floating))},
    )
    if task_setting == "multi_label":
        runlog.echo(
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
        runlog.echo(info)
    return records
