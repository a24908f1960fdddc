"""Host-side data loaders of the fine-tuning loop (counterpart of
``gigapath_tpu/data/loader.py``): class-weighted random sampling for
imbalanced multi-class training, seeded shuffling, sequential eval loaders,
slide collate, and :class:`DevicePrefetcher`, which reads and collates the
next batches on a background thread into pinned host memory and copies
each to the device with ``non_blocking=True``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from gigapath_tpu_torch.data.collate import slide_collate_fn


def class_balance_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample inverse-frequency weights from integer labels [N, 1]."""
    labels = np.asarray(labels)[:, 0].astype(int)
    n = len(labels)
    counts = {}
    for label in labels:
        counts[label] = counts.get(label, 0) + 1.0 / n
    return np.asarray([1.0 / counts[label] for label in labels])


class DataLoader:
    """Minimal seeded loader: sampler + batcher + collate.

    ``shuffle``: uniform random sampling without replacement per epoch;
    ``weights``: sample WITH replacement proportional to weights. Iterating
    yields collated batch dicts of numpy arrays.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        weights: Optional[Sequence[float]] = None,
        collate_fn: Callable = slide_collate_fn,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weights = None if weights is None else np.asarray(weights, np.float64)
        self.collate_fn = collate_fn
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weights is not None:
            p = self.weights / self.weights.sum()
            return self.rng.choice(n, size=n, replace=True, p=p)
        if self.shuffle:
            return self.rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            batch = self.collate_fn([self.dataset[int(i)] for i in chunk])
            if batch is not None:
                yield batch


class DevicePrefetcher:
    """Batches of ``loader`` as tensors on ``device``.

    A background thread reads and collates up to ``depth`` batches ahead and
    turns their arrays into host tensors (the ``bf16_keys`` fp32 arrays cast
    to bf16, halving the copy when the model computes in bf16), pinned when
    the device is a GPU; the consumer copies each with ``non_blocking=True``.
    Non-array entries (slide ids, lists) stay on the host. An exception in
    the producer re-raises in the consumer.
    """

    _SENTINEL = object()

    def __init__(self, loader, device, depth: int = 2, bf16_keys: Sequence[str] = ()):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.bf16_keys = tuple(bf16_keys)

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def _to_host_tensors(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                if k in self.bf16_keys and t.dtype == torch.float32:
                    t = t.to(torch.bfloat16)
                out[k] = t.pin_memory() if self.device.type == "cuda" else t
            else:
                out[k] = v
        return out

    def _to_device(self, batch: dict) -> dict:
        return {
            k: v.to(self.device, non_blocking=True) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()
        }

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        # set when the consumer stops early, so the producer never blocks
        # forever on a full queue
        done = threading.Event()

        def _put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if not _put(self._to_host_tensors(batch) if batch is not None else None):
                        return
                _put(self._SENTINEL)
            except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
                _put(("__error__", e))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                    raise item[1]
                if item is not None:
                    yield self._to_device(item)
        finally:
            done.set()
            while True:  # drain, so a producer mid-put unblocks at once
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)


def get_loader(
    train_dataset,
    val_dataset,
    test_dataset,
    task_config: dict,
    weighted_sample: bool = False,
    batch_size: int = 1,
    seed: int = 0,
    **kwargs,
):
    """(train, val, test) host loaders: weighted sampling only for
    non-multi-label tasks; eval loaders batch size 1, sequential."""
    weights = None
    if weighted_sample and task_config.get("setting", "multi_class") != "multi_label":
        weights = class_balance_weights(train_dataset.labels)

    train_loader = DataLoader(
        train_dataset,
        batch_size=batch_size,
        shuffle=weights is None,
        weights=weights,
        seed=seed,
    )
    val_loader = DataLoader(val_dataset, batch_size=1, seed=seed) if val_dataset is not None else None
    test_loader = DataLoader(test_dataset, batch_size=1, seed=seed) if test_dataset is not None else None
    return train_loader, val_loader, test_loader
