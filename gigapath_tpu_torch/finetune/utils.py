"""Fine-tuning utilities (counterpart of ``gigapath_tpu/finetune/utils.py``):
layer-decay AdamW, the warmup + half-cosine LR schedule, gradient
accumulation, losses, records and the scalar writer.

- :func:`build_optimizer`: one AdamW parameter group per (layer id, decay)
  label, lr scaled by ``layer_decay ** (num_layers - id)``; ``ndim != 1``
  parameters decay (so ``cls_token`` does), biases and norms do not. A
  frozen encoder is one more group with lr 0 and no decay: its parameters
  never move, as under the JAX package's ``optax.set_to_zero``.
- :func:`make_lr_scheduler`: a ``LambdaLR`` of the JAX schedule, counted in
  optimizer steps.
- :class:`MultiSteps`: accumulation over ``gc`` micro-steps, as
  ``optax.MultiSteps``: the optimizer steps with the mean of the micro-step
  gradients, and the count runs on across epochs.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)


def seed_everything(seed: int = 7) -> None:
    """Seed Python, numpy and torch (CPU and every CUDA device)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_exp_code(args) -> Tuple[str, str, str]:
    model_code = "eval"
    if len(args.pretrained) > 0:
        model_code += "_pretrained"
    if args.freeze:
        model_code += "_freeze"
    task_code = args.task
    if args.pat_strat:
        task_code += "_pat_strat"
    return model_code, task_code, f"{model_code}_{task_code}"


# --------------------------------------------------------------------------
# layer-wise LR decay


def get_layer_id(name: str, num_layers: int) -> int:
    """Port parameter name -> BEiT layer id: the patch embed and cls token
    0, encoder layer ``i`` ``i + 1``, everything else ``num_layers``."""
    parts = name.split(".")
    if any(p in ("cls_token", "pos_embed", "patch_embed") for p in parts):
        return 0
    for p, nxt in zip(parts, parts[1:]):
        if p == "layers" and nxt.isdigit():
            return int(nxt) + 1
    return num_layers


def param_labels_lrd(
    named_params: Iterable[Tuple[str, torch.Tensor]],
    num_layers: int,
    frozen_prefix: Optional[str] = None,
) -> Tuple[Dict[str, str], Dict[str, Tuple[int, bool]]]:
    """``(labels, groups)``: name -> ``layer{id}_{decay|no_decay}`` (or
    ``frozen`` under ``frozen_prefix``), and label -> (layer id, decay)."""
    labels: Dict[str, str] = {}
    groups: Dict[str, Tuple[int, bool]] = {}
    for name, param in named_params:
        if frozen_prefix and name.split(".")[0] == frozen_prefix:
            labels[name] = "frozen"
            continue
        layer_id = get_layer_id(name, num_layers)
        use_decay = param.ndim != 1
        label = f"layer{layer_id}_{'decay' if use_decay else 'no_decay'}"
        labels[name] = label
        groups[label] = (layer_id, use_decay)
    return labels, groups


def make_lr_schedule(
    lr: float,
    min_lr: float,
    warmup_epochs: float,
    epochs: float,
    steps_per_epoch: float,
    scheduler: str = "cosine",
) -> Callable[[int], float]:
    """Learning rate at optimizer step ``step``: linear warmup, then a
    half-cosine from ``lr`` to ``min_lr``."""

    def schedule(step: int) -> float:
        if scheduler == "fixed":
            return lr
        epoch = step / max(steps_per_epoch, 1e-9)
        if epoch < warmup_epochs:
            return lr * epoch / max(warmup_epochs, 1e-9)
        return min_lr + (lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / max(epochs - warmup_epochs, 1e-9))
        )

    return schedule


def build_optimizer(
    model: nn.Module,
    *,
    lr: float,
    weight_decay: float = 0.05,
    layer_decay: float = 0.95,
    num_layers: int,
    optim: str = "adamw",
    freeze_prefix: Optional[str] = None,
) -> torch.optim.AdamW:
    """AdamW with one parameter group per (layer, decay) label, each at
    ``lr * layer_decay ** (num_layers - id)`` (``optim="adam"``: no weight
    decay anywhere); the parameters under ``freeze_prefix`` go to a group
    named ``frozen`` with lr 0. Each group carries its ``name`` and
    ``lr_scale``."""
    named = list(model.named_parameters())
    labels, groups = param_labels_lrd(named, num_layers, freeze_prefix)
    by_label: Dict[str, list] = {}
    for name, param in named:
        by_label.setdefault(labels[name], []).append(param)
    param_groups = []
    for label, params in by_label.items():
        if label == "frozen":
            param_groups.append(dict(params=params, name=label, lr=0.0, lr_scale=0.0, weight_decay=0.0))
            continue
        layer_id, use_decay = groups[label]
        scale = layer_decay ** (num_layers - layer_id)
        wd = weight_decay if use_decay and optim == "adamw" else 0.0
        param_groups.append(dict(params=params, name=label, lr=lr * scale, lr_scale=scale, weight_decay=wd))
    return torch.optim.AdamW(param_groups, lr=lr)


def make_lr_scheduler(
    optimizer: torch.optim.Optimizer,
    *,
    lr: float,
    min_lr: float = 1e-6,
    warmup_epochs: float = 1,
    epochs: float = 5,
    steps_per_epoch: float = 1,
    scheduler: str = "cosine",
) -> torch.optim.lr_scheduler.LambdaLR:
    """``LambdaLR`` stepping each group's lr along :func:`make_lr_schedule`
    (scaled by the group's layer decay), once per optimizer step."""
    schedule = make_lr_schedule(lr, min_lr, warmup_epochs, epochs, steps_per_epoch, scheduler)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / lr if lr else 0.0
    )


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: the learning rate of update ``t``
    (counted from 0), ``init_value * ((1 - alpha) * (1 + cos(pi * min(t, T)
    / T)) / 2 + alpha)``. The linear probe and the pretraining driver set it
    on the optimizer before each step (:func:`set_lr`)."""

    def schedule(step: int) -> float:
        count = min(step, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class MultiSteps:
    """Gradient accumulation over ``gc`` micro-steps (counterpart of
    ``optax.MultiSteps``). Call :meth:`step` after each micro-step's
    backward, which sums into ``.grad``: every ``gc``-th call divides the
    sums by ``gc``, steps the optimizer and the scheduler and clears the
    gradients. A parameter the loss never reached steps with a zero
    gradient, as under optax, so its weight decay still applies. The count
    is not reset between epochs."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler, gc: int = 1):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.gc = max(int(gc), 1)
        self.mini_step = 0

    def step(self) -> bool:
        """Returns whether the optimizer stepped."""
        self.mini_step += 1
        if self.mini_step < self.gc:
            return False
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif self.gc > 1:
                    p.grad.div_(self.gc)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.scheduler.step()
        self.mini_step = 0
        return True


# --------------------------------------------------------------------------
# losses / records / logging


def get_loss_function(task_config: dict) -> Callable:
    """(logits, labels) -> scalar mean loss in fp32: BCE with logits for
    multi_label, cross-entropy on integer labels otherwise."""
    setting = task_config.get("setting", "multi_class")
    if setting == "multi_label":
        return lambda logits, labels: F.binary_cross_entropy_with_logits(
            logits.float(), labels.float()
        )
    if setting in ("multi_class", "binary"):
        return lambda logits, labels: F.cross_entropy(logits.float(), labels.long())
    raise NotImplementedError(setting)


def get_records_array(record_len: int, n_classes: int) -> dict:
    return {
        "prob": np.zeros((record_len, n_classes), np.float32),
        "label": np.zeros((record_len, n_classes), np.float32),
        "loss": 0.0,
    }


def log_writer(log_dict: dict, step: int, report_to: str = "tensorboard", writer=None):
    """Scalar logging switch: tensorboard, wandb or a jsonl file."""
    if report_to == "tensorboard":
        for k, v in log_dict.items():
            writer.add_scalar(k, v, step)
    elif report_to == "wandb":
        writer.log(log_dict, step=step)
    elif report_to == "jsonl":
        writer.write(json.dumps({"step": step, **{k: float(v) for k, v in log_dict.items()}}) + "\n")
        writer.flush()
    else:
        raise NotImplementedError(report_to)


def make_writer(report_to: str, writer_dir: str, args=None):
    """``(writer, report_to)`` for ``report_to``; falls back to a jsonl file
    (``metrics.jsonl``) when tensorboard is not installed."""
    os.makedirs(writer_dir, exist_ok=True)
    if report_to == "wandb":
        import wandb

        wandb.init(project=args.exp_code, config=vars(args))
        return wandb, "wandb"
    if report_to == "tensorboard":
        try:
            from torch.utils import tensorboard

            return tensorboard.SummaryWriter(writer_dir, flush_secs=15), "tensorboard"
        except ImportError:
            logger.info("tensorboard unavailable; logging scalars to metrics.jsonl")
    return open(os.path.join(writer_dir, "metrics.jsonl"), "a"), "jsonl"
