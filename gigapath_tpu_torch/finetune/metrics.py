"""Classification metrics of the fine-tuning harness (counterpart of
``gigapath_tpu/finetune/metrics.py``), in numpy and scipy.

The same metric names and dispatch: auroc and auprc in micro, macro and
per-class form, bacc, acc and quadratic-weighted kappa (qwk), chosen by the
task config's ``setting``. The functions follow scikit-learn's definitions:

- ROC AUC is the tie-aware Mann-Whitney statistic (average ranks), nan
  when a column holds one class only;
- average precision is ``sum_n (R_n - R_{n-1}) P_n`` over the distinct
  score thresholds, 0 for a column without positives;
- balanced accuracy averages the recall of the classes present in the
  labels; kappa's quadratic weights count class indices, and it is nan
  when the expected disagreement is 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy.stats import rankdata

# Metrics computed on hard argmax predictions rather than probabilities.
_ARGMAX_METRICS = ("bacc", "acc", "qwk")


def binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true).ravel() > 0
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(y_score, np.float64).ravel())  # ties share the mean rank
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true).ravel() > 0
    y_score = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    # the last index of each distinct score, in descending score order
    thresholds = np.r_[np.where(np.diff(y_score))[0], y_score.size - 1]
    tps = np.cumsum(y_true)[thresholds]
    fps = 1 + thresholds - tps
    precision = tps / (tps + fps)
    if tps[-1] == 0:  # no positives: recall is 1 at every threshold
        recall = np.ones_like(precision)
    else:
        recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _per_column(metric, labels: np.ndarray, probs: np.ndarray, average: Optional[str]):
    if average == "micro":
        return metric(labels.ravel(), probs.ravel())
    scores = np.array([metric(labels[:, c], probs[:, c]) for c in range(labels.shape[1])])
    return float(np.mean(scores)) if average == "macro" else scores


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    classes = np.unique(y_true)
    recalls = [np.mean(y_pred[y_true == c] == c) for c in classes]
    return float(np.mean(recalls))


def quadratic_weighted_kappa(y1: np.ndarray, y2: np.ndarray) -> float:
    labels = np.unique(np.concatenate([y1, y2]))
    n = labels.size
    confusion = np.zeros((n, n), np.float64)
    np.add.at(confusion, (np.searchsorted(labels, y1), np.searchsorted(labels, y2)), 1.0)
    sum0, sum1 = confusion.sum(axis=0), confusion.sum(axis=1)
    expected = np.outer(sum0, sum1) / sum0.sum()
    idx = np.arange(n)
    weights = (idx[:, None] - idx[None, :]) ** 2.0
    denom = np.sum(weights * expected)
    if denom == 0:
        return float("nan")
    return float(1.0 - np.sum(weights * confusion) / denom)


class MakeMetrics:
    """A single named metric with an averaging strategy.

    ``metric`` is one of auroc / auprc / bacc / acc / qwk; ``average`` is
    'micro', 'macro', or ``None`` for per-class scores (keyed by label name
    from ``label_dict``).
    """

    def __init__(self, metric: str = "auroc", average: Optional[str] = "micro",
                 label_dict: Optional[dict] = None):
        self.metric = metric
        self.average = average
        self.label_dict = label_dict

    def get_metric(self, labels: np.ndarray, probs: np.ndarray):
        if self.metric == "auroc":
            return _per_column(binary_roc_auc, labels, probs, self.average)
        if self.metric == "auprc":
            return _per_column(binary_average_precision, labels, probs, self.average)
        if self.metric == "bacc":
            return balanced_accuracy(labels, probs)
        if self.metric == "acc":
            return float(np.mean(labels == probs))
        if self.metric == "qwk":
            return quadratic_weighted_kappa(labels, probs)
        raise ValueError(f"Invalid metric: {self.metric}")

    def process_preds(self, labels: np.ndarray, probs: np.ndarray):
        if self.metric in _ARGMAX_METRICS:
            return np.argmax(labels, axis=1), np.argmax(probs, axis=1)
        return labels, probs

    @property
    def get_metric_name(self):
        if self.metric in ("auroc", "auprc"):
            if self.average is not None:
                return f"{self.average}_{self.metric}"
            keys = sorted(self.label_dict.keys(), key=lambda k: self.label_dict[k])
            return [f"{key}_{self.metric}" for key in keys]
        return self.metric

    def __call__(self, labels: np.ndarray, probs: np.ndarray) -> Dict[str, float]:
        labels, probs = self.process_preds(np.asarray(labels), np.asarray(probs))
        name = self.get_metric_name
        score = self.get_metric(labels, probs)
        if isinstance(name, list):
            return dict(zip(name, score))
        return {name: score}


def calculate_multilabel_metrics(
    probs: np.ndarray, labels: np.ndarray, label_dict, add_metrics: Optional[List[str]] = None
) -> Dict[str, float]:
    metrics = ["auroc", "auprc"] + (add_metrics or [])
    results: Dict[str, float] = {}
    for average in ["micro", "macro", None]:
        for metric in metrics:
            results.update(MakeMetrics(metric, average, label_dict)(labels, probs))
    return results


def calculate_multiclass_or_binary_metrics(
    probs: np.ndarray, labels: np.ndarray, label_dict, add_metrics: Optional[List[str]] = None
) -> Dict[str, float]:
    metrics = ["bacc", "acc", "auroc", "auprc"] + (add_metrics or [])
    results: Dict[str, float] = {}
    # argmax metrics ignore `average`: computed once
    for metric in metrics:
        if metric in _ARGMAX_METRICS:
            results.update(MakeMetrics(metric, None, label_dict)(labels, probs))
    for average in ["macro", None]:
        for metric in metrics:
            if metric not in _ARGMAX_METRICS:
                results.update(MakeMetrics(metric, average, label_dict)(labels, probs))
    return results


def calculate_metrics_with_task_cfg(
    probs: np.ndarray, labels: np.ndarray, task_cfg: dict
) -> Dict[str, float]:
    """Dispatch on the task config's ``setting`` (multi_label vs multi_class)."""
    if task_cfg.get("setting", "multi_class") == "multi_label":
        return calculate_multilabel_metrics(
            probs, labels, task_cfg["label_dict"], task_cfg.get("add_metrics")
        )
    return calculate_multiclass_or_binary_metrics(
        probs, labels, task_cfg["label_dict"], task_cfg.get("add_metrics")
    )
