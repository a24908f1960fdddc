"""Tile-level linear probe, the PCam recipe (counterpart of
``gigapath_tpu/linear_probe/main.py``).

A single linear classifier on frozen 1536-d tile embeddings, SGD (or
AdamW) with cosine annealing over ``train_iters`` iterations of an
infinitely-cycled loader, eval every ``eval_interval`` (accuracy /
weighted-f1 / macro precision+recall / macro AUROC+AUPRC), best-f1 model
selection and a ``results.txt`` artifact.

The step (forward, cross-entropy, update) runs on ``device`` (``cuda``
unless the caller passes ``cpu``); its loss reaches the host only at the
10-iteration echo. Batches are assembled on the host from numpy, as in the
JAX package, whose index stream (``numpy.random.default_rng(seed)``,
drawn with replacement) they follow bit for bit. The optimizers are
optax's: ``sgd`` is ``add_decayed_weights`` then ``sgd`` (momentum 0 keeps
no trace), which ``torch.optim.SGD`` computes; ``adam`` is
``optax.adamw``, whose decay is scaled by the learning rate as
``torch.optim.AdamW``'s; the learning rate of update ``t`` is set before
it from :func:`~gigapath_tpu_torch.finetune.utils.cosine_decay_schedule`.
Evaluation runs on the host in numpy and scipy (scikit-learn's
definitions).

    python -m gigapath_tpu_torch.linear_probe.main --dataset_csv ds.csv \
        --input_path embeds.zip [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigapath_tpu_torch.data.pcam import EmbeddingDataset, Processor
from gigapath_tpu_torch.finetune.metrics import binary_average_precision, binary_roc_auc
from gigapath_tpu_torch.finetune.utils import (
    cosine_decay_schedule,
    log_writer,
    make_writer,
    seed_everything,
    set_lr,
)
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
from gigapath_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from gigapath_tpu_torch.utils.device import resolve_device

Params = Union[nn.Linear, Mapping[str, torch.Tensor]]


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Linear Probe")
    # Dataset
    parser.add_argument("--dataset_csv", type=str, default="", help="csv with input samples and labels")
    parser.add_argument("--input_path", type=str, default="", help="The input embedding zip")
    parser.add_argument("--embed_dim", type=int, default=1536, help="The dimension of the embeddings")
    # Training
    parser.add_argument("--batch_size", type=int, default=512, help="Batch size")
    parser.add_argument("--train_iters", type=int, default=12500, help="Number of iterations")
    parser.add_argument("--lr", type=float, default=0.01, help="Learning rate")
    parser.add_argument("--min_lr", type=float, default=0.0, help="Minimum learning rate")
    parser.add_argument("--optim", type=str, default="sgd", help="Optimizer")
    parser.add_argument("--momentum", type=float, default=0.0, help="Momentum")
    parser.add_argument("--weight_decay", type=float, default=0.0, help="Weight decay")
    parser.add_argument("--eval_interval", type=int, default=10000, help="Evaluation interval")
    parser.add_argument("--model_select", type=str, default="best", help="Model selection")
    parser.add_argument("--num_workers", type=int, default=10, help="Accepted for compatibility (unused)")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--z_score", action="store_true", default=False, help="Use z-score normalization")
    parser.add_argument("--report_to", type=str, default="tensorboard", choices=["tensorboard", "jsonl"])
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device; cuda unless given (cpu runs on the host)")
    # Output
    parser.add_argument("--output_dir", type=str, default="outputs", help="Output directory")
    return parser


def to_onehot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    onehot = np.zeros((labels.shape[0], num_classes))
    onehot[np.arange(labels.shape[0]), labels] = 1
    return onehot


def _batches(
    dataset, batch_size: int, rng: np.random.Generator, infinite: bool
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    n = len(dataset)

    def epoch_indices():
        if infinite:
            while True:
                yield rng.integers(0, n, size=batch_size)  # with replacement
        else:
            order = np.arange(n)
            for start in range(0, n, batch_size):
                yield order[start : start + batch_size]

    for idx in epoch_indices():
        embeds, targets = zip(*(dataset[int(i)] for i in idx))
        yield np.stack(embeds).astype(np.float32), np.asarray(targets, np.int64)


def init_linear_probe(embed_dim: int, num_classes: int, seed: int = 0) -> nn.Linear:
    """The single ``nn.Linear`` on the CPU, weight [C, D] then bias drawn
    U(-1/sqrt(D), 1/sqrt(D)) from a ``torch.Generator`` seeded with
    ``seed`` (so every device starts from the same numbers)."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(embed_dim)
    probe = nn.Linear(embed_dim, num_classes)
    with torch.no_grad():
        probe.weight.uniform_(-bound, bound, generator=gen)
        probe.bias.uniform_(-bound, bound, generator=gen)
    return probe


def _state(params: Params) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, nn.Module) else params


def _host_params(params: Params) -> Tuple[np.ndarray, np.ndarray]:
    """(kernel [D, C], bias [C]) fp32 numpy of a probe or its state dict."""
    state = _state(params)
    weight = torch.as_tensor(state["weight"]).detach().float().cpu().numpy()
    return weight.T, torch.as_tensor(state["bias"]).detach().float().cpu().numpy()


def _f1_precision_recall(target: np.ndarray, pred: np.ndarray) -> Tuple[float, float, float]:
    """Weighted F1, macro precision and macro recall over the labels that
    occur in ``target`` or ``pred`` (scikit-learn's ``f1_score(average=
    "weighted")`` and ``precision_recall_fscore_support(average="macro",
    zero_division=0)``)."""
    labels = np.unique(np.concatenate([target, pred]))
    tp = np.array([np.sum((pred == c) & (target == c)) for c in labels], np.float64)
    n_pred = np.array([np.sum(pred == c) for c in labels], np.float64)
    n_true = np.array([np.sum(target == c) for c in labels], np.float64)
    precision = np.where(n_pred > 0, tp / np.maximum(n_pred, 1.0), 0.0)
    recall = np.where(n_true > 0, tp / np.maximum(n_true, 1.0), 0.0)
    f1 = 2.0 * tp / (n_pred + n_true)  # 2tp / (2tp + fp + fn); every label occurs somewhere
    weighted_f1 = float(np.sum(f1 * n_true) / np.sum(n_true)) if np.sum(n_true) else 0.0
    return weighted_f1, float(np.mean(precision)), float(np.mean(recall))


def _macro(metric, onehot: np.ndarray, scores: np.ndarray) -> float:
    """A binary score averaged over the one-hot columns; as scikit-learn,
    a column with one class only is an error."""
    values = []
    for c in range(onehot.shape[1]):
        if metric is binary_roc_auc and len(np.unique(onehot[:, c])) < 2:
            raise ValueError("Only one class present in y_true. ROC AUC score is not defined in that case.")
        values.append(metric(onehot[:, c], scores[:, c]))
    return float(np.mean(values))


def evaluate(params: Params, loader_fn) -> Tuple[float, float, float, float, float, float]:
    """(accuracy, weighted-f1, macro precision, macro recall, macro auroc,
    macro auprc) of the probe's logits ``embed @ kernel + bias``, computed
    on the host."""
    kernel, bias = _host_params(params)
    preds, targets = [], []
    for embed, target in loader_fn():
        preds.append(embed @ kernel + bias)
        targets.append(target)
    pred = np.concatenate(preds)
    target = np.concatenate(targets)
    hard = pred.argmax(1)
    accuracy = float((hard == target).mean())
    f1, precision, recall = _f1_precision_recall(target, hard)
    onehot = to_onehot(target, pred.shape[1])
    auroc = _macro(binary_roc_auc, onehot, pred)
    auprc = _macro(binary_average_precision, onehot, pred)
    return accuracy, f1, precision, recall, auroc, auprc


def _optimizer(probe: nn.Linear, optim: str, lr: float, weight_decay: float, momentum: float):
    if optim == "sgd":
        return torch.optim.SGD(probe.parameters(), lr=lr, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay, nesterov=False)
    if optim == "adam":
        return torch.optim.AdamW(probe.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    raise ValueError("Invalid optimizer")


def train(
    params: Params,
    train_dataset,
    val_dataset,
    test_dataset,
    *,
    train_iters: int,
    batch_size: int = 512,
    lr: float = 0.01,
    min_lr: float = 0.0,
    optim: str = "sgd",
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    output_dir: str = "outputs",
    eval_interval: int = 10000,
    model_select: str = "best",
    seed: int = 42,
    report_to: str = "jsonl",
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
):
    """Train the probe from ``params`` (an ``nn.Linear`` or its state dict
    ``{"weight" [C, D], "bias" [C]}``) on ``device``; writes the best and
    last state dicts (``best_model.pt``, ``model.pt``) and ``results.txt``
    under ``output_dir``."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    state = _state(params)
    num_classes, embed_dim = state["weight"].shape
    probe = nn.Linear(embed_dim, num_classes)
    probe.load_state_dict({k: torch.as_tensor(v).float() for k, v in state.items()})
    probe.to(dev)

    class _Args:
        exp_code = "linear_probe"

    writer, report_to = make_writer(report_to, os.path.join(output_dir, "tensorboard"), _Args)
    runlog = get_run_log(
        "linear_probe", out_dir=output_dir,
        config={"train_iters": train_iters, "batch_size": batch_size,
                "lr": lr, "min_lr": min_lr, "optim": optim,
                "weight_decay": weight_decay, "momentum": momentum,
                "eval_interval": eval_interval, "seed": seed, "device": str(dev)},
    )

    schedule = cosine_decay_schedule(lr, train_iters, alpha=min_lr / max(lr, 1e-12))
    optimizer = _optimizer(probe, optim, lr, weight_decay, momentum)
    runlog.echo(f"Set the optimizer as {optim}")

    def step(embed: torch.Tensor, target: torch.Tensor, step_lr: float) -> torch.Tensor:
        set_lr(optimizer, step_lr)
        loss = F.cross_entropy(probe(embed), target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    rng = np.random.default_rng(seed)
    train_stream = _batches(train_dataset, batch_size, rng, infinite=True)
    val_loader = lambda: _batches(val_dataset, batch_size, rng, infinite=False)  # noqa: E731
    test_loader = lambda: _batches(test_dataset, batch_size, rng, infinite=False)  # noqa: E731

    ledger = get_ledger(runlog)
    watchdog = CompileWatchdog("linear_probe.step", runlog, ledger=ledger)
    instrumented_step = watchdog.wrap(step)
    runlog.echo("Start training")
    try:
        best_f1, f1 = _train_loop(
            probe, instrumented_step, train_stream, train_iters, schedule, eval_interval,
            val_loader, output_dir, report_to, writer, runlog, dev,
        )

        if model_select == "best" and best_f1 > 0:
            val_f1 = best_f1
            params = restore_checkpoint(os.path.join(output_dir, "best_model.pt"))
        else:
            val_f1 = f1
            params = restore_checkpoint(os.path.join(output_dir, "model.pt"))

        accuracy, f1, precision, recall, auroc, auprc = evaluate(params, test_loader)
        runlog.echo(
            f"Test Accuracy: {accuracy} f1: {f1} Precision: {precision} Recall: "
            f"{recall} AUROC: {auroc} AUPRC: {auprc}"
        )
        with open(os.path.join(output_dir, "results.txt"), "w") as f:
            f.write(f"Val f1: {val_f1}\n")
            f.write(f"Test f1: {f1} Test AUROC: {auroc} Test AUPRC: {auprc}\n")
    except Exception as e:
        # a crashed run still leaves a terminal event in its artifact
        fail_run(runlog, "linear_probe.train", e)
        raise
    runlog.run_end(
        status="ok", val_f1=val_f1, test_f1=f1, test_auroc=auroc,
        test_auprc=auprc,
        compile_seconds_total=watchdog.compile_seconds_total(),
        ledger_path=ledger.path,
    )
    return {"val_f1": val_f1, "test_f1": f1, "test_auroc": auroc, "test_auprc": auprc}


def _train_loop(
    probe, instrumented_step, train_stream, train_iters, schedule, eval_interval,
    val_loader, output_dir, report_to, writer, runlog, dev,
):
    """The heartbeat-monitored iteration loop; returns ``(best_f1,
    last_f1)`` with ``probe`` holding the last parameters."""
    best_f1, f1 = 0.0, 0.0
    metrics = get_metrics(runlog)
    step_walls = metrics.histogram("linear_probe.step_wall_s")
    with Heartbeat(runlog, name="linear_probe") as heartbeat:
        t_prev = time.time()
        for i, (embed, target) in enumerate(itertools.islice(train_stream, train_iters)):
            loss = instrumented_step(
                torch.from_numpy(embed).to(dev), torch.from_numpy(target).to(dev), schedule(i)
            )
            heartbeat.beat(i)
            if (i + 1) % 10 == 0:
                cur_lr = schedule(i)
                loss_f = float(loss)  # the loop's one device sync
                t_now = time.time()
                runlog.step(i, wall_s=round(t_now - t_prev, 6), synced=True, loss=loss_f, lr=cur_lr)
                step_walls.observe(round(t_now - t_prev, 6))
                metrics.maybe_flush()
                t_prev = t_now
                runlog.echo(f"Iteration [{i}/{train_iters}]\tLoss: {loss_f}\tLR: {cur_lr}", step=i)
                log_writer({"Train Loss": loss_f, "Learning Rate": cur_lr}, i, report_to, writer)
            if (i + 1) % eval_interval == 0 or (i + 1) == train_iters:
                runlog.echo("Start evaluating ...")
                with span("eval", runlog, iteration=i):
                    accuracy, f1, precision, recall, auroc, auprc = evaluate(probe, val_loader)
                runlog.eval_event(
                    i, accuracy=accuracy, f1=f1, precision=precision,
                    recall=recall, auroc=auroc, auprc=auprc,
                )
                runlog.echo(
                    f"Val [{i}/{train_iters}] Accuracy: {accuracy} f1: {f1} Precision: "
                    f"{precision} Recall: {recall} AUROC: {auroc} AUPRC: {auprc}",
                    step=i,
                )
                log_writer(
                    {
                        "Val Accuracy": accuracy,
                        "Val f1": f1,
                        "Val AUROC": auroc,
                        "Val AUPRC": auprc,
                        "Val Precision": precision,
                        "Val Recall": recall,
                        "Best f1": best_f1,
                    },
                    i,
                    report_to,
                    writer,
                )
                if f1 > best_f1:
                    runlog.echo(f"Best f1 increase from {best_f1} to {f1}")
                    best_f1 = f1
                    save_checkpoint(os.path.join(output_dir, "best_model.pt"), probe.state_dict())

    save_checkpoint(os.path.join(output_dir, "model.pt"), probe.state_dict())
    return best_f1, f1


def main(argv=None):
    args = build_argparser().parse_args(argv)
    console(str(args))
    seed_everything(args.seed)
    processor = Processor()
    splits = ["train", "val", "test"]
    train_dataset, val_dataset, test_dataset = [
        EmbeddingDataset(
            args.dataset_csv, args.input_path, split=split,
            z_score=args.z_score, processor=processor,
        )
        for split in splits
    ]
    args.num_classes = len(train_dataset.label_dict)
    console(f"Train: {len(train_dataset)}\tVal: {len(val_dataset)}\tTest: {len(test_dataset)}")
    params = init_linear_probe(args.embed_dim, args.num_classes, args.seed)
    return train(params, train_dataset, val_dataset, test_dataset, **vars(args))


if __name__ == "__main__":
    main()
