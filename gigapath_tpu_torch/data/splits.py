"""Train/val/test split management (counterpart of
``gigapath_tpu/data/splits.py``).

Per-fold ``{train,val,test}_{fold}.csv`` files are read from ``split_dir``
when present, else made and written there. The split is scikit-learn's
``train_test_split(samples, test_size, random_state=fold)``, written out in
numpy (:func:`train_test_split`): the same permutation, so both packages
cut a dataset into the same folds.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple


def train_test_split(samples: Sequence, test_size: float, random_state: int) -> Tuple[list, list]:
    """``(train, test)`` as scikit-learn's shuffled ``train_test_split``
    with a float ``test_size``: one ``RandomState(random_state)``
    permutation, the first ``ceil(test_size * n)`` entries for test, the
    next ``floor((1 - test_size) * n)`` for train."""
    import numpy as np

    n = len(samples)
    n_test = math.ceil(test_size * n)
    n_train = math.floor((1.0 - test_size) * n)
    if n_train == 0 or n_test == 0:
        raise ValueError(f"test_size={test_size} on {n} samples leaves an empty split")
    perm = np.random.RandomState(random_state).permutation(n)
    return [samples[i] for i in perm[n_test : n_test + n_train]], [samples[i] for i in perm[:n_test]]


def get_splits(
    df,
    val_r: float = 0.1,
    test_r: float = 0.2,
    fold: int = 0,
    split_dir: str = "",
    fetch_splits: bool = True,
    prop: float = 1,
    split_key: str = "slide_id",
    **kwargs,
) -> Tuple[List[str], List[str], List[str]]:
    """70/10/20 default split; returns lists of ``split_key`` values."""
    import pandas as pd

    os.makedirs(split_dir, exist_ok=True)
    files = os.listdir(split_dir)
    train_name, val_name, test_name = f"train_{fold}.csv", f"val_{fold}.csv", f"test_{fold}.csv"
    if split_key not in df.columns:
        raise ValueError(f"{split_key} not in the columns of the dataframe")

    missing = train_name not in files or val_name not in files or test_name not in files
    if missing or not fetch_splits:
        samples = df.drop_duplicates(split_key)[split_key].to_list()
        train_samples, temp_samples = train_test_split(samples, val_r + test_r, fold)
        if val_r > 0:
            val_samples, test_samples = train_test_split(temp_samples, test_r / (val_r + test_r), fold)
        else:
            val_samples, test_samples = [], temp_samples
        train_data = df[df[split_key].isin(train_samples)]
        val_data = df[df[split_key].isin(val_samples)]
        test_data = df[df[split_key].isin(test_samples)]
        if prop > 0:
            train_data = train_data.sample(frac=prop, random_state=fold).reset_index(drop=True)
        train_data.to_csv(os.path.join(split_dir, train_name))
        val_data.to_csv(os.path.join(split_dir, val_name))
        test_data.to_csv(os.path.join(split_dir, test_name))

    train_splits = pd.read_csv(os.path.join(split_dir, train_name))[split_key].to_list()
    val_splits = pd.read_csv(os.path.join(split_dir, val_name))[split_key].to_list()
    test_splits = pd.read_csv(os.path.join(split_dir, test_name))[split_key].to_list()
    return train_splits, val_splits, test_splits
