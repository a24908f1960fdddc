"""PCam tile-embedding dataset for the linear probe (counterpart of
``gigapath_tpu/data/pcam.py``).

Embeddings live as ``.pt`` tensors inside a zip, selected by split-substring
match on the member filename; labels come from a csv with
``input``/``label``/``split`` columns; optional per-sample z-score
normalization; labels are indexed through a sorted label set. pandas is
imported inside :class:`EmbeddingDataset`.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Dict

import numpy as np

from gigapath_tpu_torch.obs import console


class Processor:
    """Zip reader: ``{sample name: embedding}`` of one split."""

    def get_sample_name(self, path: str) -> str:
        return os.path.basename(path).replace(".pt", "")

    def load_embeddings_from_zip(self, zip_path: str, split: str) -> Dict[str, np.ndarray]:
        import torch

        loaded = {}
        with zipfile.ZipFile(zip_path, "r") as zip_ref:
            console(str(len(zip_ref.infolist())))
            for file_info in zip_ref.infolist():
                name = file_info.filename
                if name.endswith(".pt") and split in name:
                    tensor = torch.load(io.BytesIO(zip_ref.read(name)), weights_only=False)
                    arr = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else np.asarray(tensor)
                    loaded[self.get_sample_name(name)] = arr
        return loaded


class EmbeddingDataset:
    """(embedding [D] fp32, class index) samples of one split."""

    def __init__(
        self,
        dataset_csv: str,
        zip_path: str,
        split: str = "train",
        z_score: bool = False,
        processor: Processor | None = None,
    ):
        import pandas as pd

        df = pd.read_csv(dataset_csv)
        split_df = df[df["split"] == split]
        self.samples = split_df["input"].tolist()
        self.labels = split_df["label"].tolist()
        self.processor = processor or Processor()
        self.embeds = self.processor.load_embeddings_from_zip(zip_path, split)
        label_set = sorted(set(self.labels))
        self.label_dict = {label: i for i, label in enumerate(label_set)}
        self.z_score = z_score

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        sample, target = self.samples[index], self.labels[index]
        embed = np.asarray(self.embeds[sample], np.float32)
        if self.z_score:
            embed = (embed - embed.mean()) / embed.std()
        return embed, self.label_dict[target]
