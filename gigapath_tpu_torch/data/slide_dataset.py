"""Slide-level tile-embedding dataset, ``.h5`` and ``.pt`` (counterpart of
``gigapath_tpu/data/slide_dataset.py``).

It keeps the slides whose tile encodings exist, maps labels per task
setting (multi_class / binary / multi_label through the task config's
``label_dict``), reads ``features``/``coords`` from h5 (or a bare tensor
from ``.pt``), optionally shuffles the tiles, truncates to ``max_tiles``,
and retries a failing read of the same sample with exponential backoff
before skipping it (the collate drops the ``None``). ``GIGAPATH_CHAOS``
is read once, at construction: a ``fail_loader@I`` / ``slow_loader@I:S``
spec acts on every attempt at sample ``I``, and a skip lands as a
``recovery`` event (``action="data_retry"``) on the run log attached by
:meth:`SlideDataset.set_runlog`. h5py is imported only by the h5 reader.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def read_assets_from_h5(h5_path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read every dataset (and its attrs) from an h5 file."""
    import h5py

    assets, attrs = {}, {}
    with h5py.File(h5_path, "r") as f:
        for key in f.keys():
            assets[key] = f[key][:]
            if f[key].attrs is not None:
                attrs[key] = dict(f[key].attrs)
    return assets, attrs


def _load_pt(path: str) -> np.ndarray:
    t = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


class SlideDatasetForTasks:
    """Task setup: label mapping + split filtering."""

    def __init__(
        self,
        data_df,
        root_path: str,
        splits: List[str],
        task_config: dict,
        slide_key: str = "slide_id",
        split_key: str = "pat_id",
        **kwargs,
    ):
        self.root_path = root_path
        self.split_key = split_key
        self.slide_key = slide_key
        self.task_cfg = task_config

        valid_slides = self.get_valid_slides(root_path, data_df[slide_key].values)
        data_df = data_df[data_df[slide_key].isin(valid_slides)]
        self.setup_data(data_df, splits, task_config.get("setting", "multi_class"))
        self.max_tiles = task_config.get("max_tiles", 1000)
        self.shuffle_tiles = task_config.get("shuffle_tiles", False)
        logger.info("Dataset has been initialized!")

    def _slide_filename(self, slide_id: str) -> str:
        ext = ".pt" if "pt_files" in self.root_path.split("/")[-1] else ".h5"
        return slide_id.replace(".svs", "") + ext

    def get_valid_slides(self, root_path: str, slides) -> List[str]:
        valid = []
        for slide_id in slides:
            ext = ".pt" if "pt_files" in root_path.split("/")[-1] else ".h5"
            path = os.path.join(root_path, slide_id.replace(".svs", "") + ext)
            if not os.path.exists(path):
                logger.info("Missing:  %s", path)
            else:
                valid.append(slide_id)
        return valid

    def setup_data(self, df, splits: List[str], task: str = "multi_class"):
        if task in ("multi_class", "binary"):
            prepare = self.prepare_multi_class_or_binary_data
        elif task == "multi_label":
            prepare = self.prepare_multi_label_data
        else:
            raise ValueError(f"Invalid task: {task}")
        self.slide_data, self.images, self.labels, self.n_classes = prepare(df, splits)

    def prepare_multi_class_or_binary_data(self, df, splits: List[str]):
        label_dict = self.task_cfg.get("label_dict", {})
        if not label_dict:
            raise ValueError("No label_dict found in the task configuration")
        if "label" not in df.columns:
            raise ValueError("No label column found in the dataframe")
        df = df.copy()
        df["label"] = df["label"].map(label_dict)
        n_classes = len(label_dict)
        if self.split_key not in df.columns:
            raise ValueError(f"No {self.split_key} column found")
        df = df[df[self.split_key].isin(splits)]
        images = df[self.slide_key].to_list()
        labels = df[["label"]].to_numpy().astype(int)
        return df, images, labels, n_classes

    def prepare_multi_label_data(self, df, splits: List[str]):
        label_dict = self.task_cfg.get("label_dict", {})
        if not label_dict:
            raise ValueError("No label_dict found in the task configuration")
        label_keys = sorted(label_dict.keys(), key=lambda x: label_dict[x])
        n_classes = len(label_dict)
        if self.split_key not in df.columns:
            raise ValueError(f"No {self.split_key} column found")
        df = df[df[self.split_key].isin(splits)]
        images = df[self.slide_key].to_list()
        labels = df[label_keys].to_numpy().astype(int)
        return df, images, labels, n_classes


class SlideDataset(SlideDatasetForTasks):
    """Sample access with shuffle/truncate/retry; ``retry`` and
    ``retry_backoff_s`` bound the per-sample retry loop, ``set_runlog``
    attaches the run log that a skip is reported on."""

    def __init__(self, *args, seed: int = 0, retry: int = 3,
                 retry_backoff_s: float = 0.05, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = np.random.default_rng(seed)
        self.retry = max(int(retry), 1)
        self.retry_backoff_s = float(retry_backoff_s)
        self._runlog = None
        from gigapath_tpu_torch.resilience.chaos import get_chaos

        self._chaos = get_chaos()  # GIGAPATH_CHAOS, read once, at construction

    def set_runlog(self, runlog) -> None:
        """Attach the training run's log, so a skipped sample lands on it as a
        ``recovery`` event."""
        self._runlog = runlog

    def shuffle_data(self, images: np.ndarray, coords: np.ndarray):
        indices = self._rng.permutation(len(images))
        return images[indices], coords[indices]

    def get_images_from_path(self, img_path: str) -> dict:
        if img_path.endswith(".pt"):
            images = _load_pt(img_path)
            coords = np.zeros((len(images), 2), np.float32)
        else:
            assets, _ = read_assets_from_h5(img_path)
            images = np.asarray(assets["features"])
            coords = np.asarray(assets["coords"])
            if self.shuffle_tiles:
                images, coords = self.shuffle_data(images, coords)
            images, coords = images[: self.max_tiles], coords[: self.max_tiles]
        return {"imgs": images, "img_lens": images.shape[0], "pad_mask": 0, "coords": coords}

    def get_one_sample(self, idx: int) -> dict:
        slide_id = self.images[idx]
        data = self.get_images_from_path(os.path.join(self.root_path, self._slide_filename(slide_id)))
        return {**data, "slide_id": slide_id, "labels": np.asarray(self.labels[idx])}

    def get_sample_with_try(self, idx: int, n_try: Optional[int] = None) -> Optional[dict]:
        """Bounded same-sample retry with exponential backoff; after the
        last failure the sample is skipped (None), never raised."""
        n_try = self.retry if n_try is None else max(int(n_try), 1)
        last_err: Optional[BaseException] = None
        for attempt in range(n_try):
            try:
                if self._chaos:
                    self._chaos.loader_fault(idx)
                return self.get_one_sample(idx)
            except Exception as e:  # noqa: BLE001 (a bad slide costs one sample, not the epoch)
                last_err = e
                logger.warning("Error reading sample %d (attempt %d/%d): %s: %s",
                               idx, attempt + 1, n_try, type(e).__name__, e)
                if attempt + 1 < n_try and self.retry_backoff_s > 0:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        if self._runlog is not None:
            self._runlog.event(
                "recovery", action="data_retry", index=int(idx),
                slide_id=self.images[idx] if 0 <= idx < len(self.images) else None,
                attempts=n_try, error=f"{type(last_err).__name__}: {last_err}",
            )
        logger.warning("Sample %d failed %d attempt(s); skipping it", idx, n_try)
        return None

    def __len__(self) -> int:
        return len(self.slide_data)

    def __getitem__(self, idx: int) -> Optional[dict]:
        return self.get_sample_with_try(idx)
