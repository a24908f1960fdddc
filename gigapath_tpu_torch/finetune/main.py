"""Fine-tuning CLI with k-fold cross-validation (counterpart of
``gigapath_tpu/finetune/main.py``): task-config load, effective LR (``lr =
blr * batch_size * gc / 256``), patient-stratified split key, per-fold
dataset/loader/train, and ``summary.csv`` with a mean +- std printout.
pandas is imported inside :func:`main`.

    python -m gigapath_tpu_torch.finetune.main --task_cfg_path ... \
        --dataset_csv ... --root_path ... [--device cpu]
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def main(argv: Optional[list] = None) -> dict:
    import pandas as pd

    from gigapath_tpu_torch.data.loader import get_loader
    from gigapath_tpu_torch.data.slide_dataset import SlideDataset
    from gigapath_tpu_torch.data.splits import get_splits
    from gigapath_tpu_torch.finetune.params import get_finetune_params
    from gigapath_tpu_torch.finetune.task_configs.utils import load_task_config
    from gigapath_tpu_torch.finetune.training import train
    from gigapath_tpu_torch.finetune.utils import get_exp_code, seed_everything

    args = get_finetune_params(argv)
    logger.info(str(args))

    seed_everything(args.seed)

    logger.info("Loading task configuration from: {}".format(args.task_cfg_path))
    args.task_config = load_task_config(args.task_cfg_path)
    logger.info(str(args.task_config))
    args.task = args.task_config.get("name", "task")

    args.save_dir = os.path.join(args.save_dir, args.task, args.exp_name)
    args.model_code, args.task_code, args.exp_code = get_exp_code(args)
    args.save_dir = os.path.join(args.save_dir, args.exp_code)
    os.makedirs(args.save_dir, exist_ok=True)
    logger.info("Experiment code: {}".format(args.exp_code))
    logger.info("Setting save directory: {}".format(args.save_dir))

    eff_batch_size = args.batch_size * args.gc
    if args.lr is None or args.lr < 0:
        args.lr = args.blr * eff_batch_size / 256
    logger.info("base lr: %.2e" % (args.lr * 256 / eff_batch_size))
    logger.info("actual lr: %.2e" % args.lr)
    logger.info("accumulate grad iterations: %d" % args.gc)
    logger.info("effective batch size: %d" % eff_batch_size)

    args.split_key = "pat_id" if args.pat_strat else "slide_id"

    args.split_dir = (
        os.path.join(args.split_dir, args.task_code)
        if not args.pre_split_dir
        else args.pre_split_dir
    )
    os.makedirs(args.split_dir, exist_ok=True)
    logger.info("Setting split directory: {}".format(args.split_dir))
    dataset = pd.read_csv(args.dataset_csv)

    results: dict = {}
    for fold in range(args.folds):
        fold_dir = os.path.join(args.save_dir, f"fold_{fold}")
        os.makedirs(fold_dir, exist_ok=True)
        train_splits, val_splits, test_splits = get_splits(
            dataset, fold=fold, **vars(args)
        )
        train_data = SlideDataset(
            dataset, args.root_path, train_splits, args.task_config,
            split_key=args.split_key, seed=args.seed,
        )
        val_data = (
            SlideDataset(
                dataset, args.root_path, val_splits, args.task_config,
                split_key=args.split_key, seed=args.seed,
            )
            if len(val_splits) > 0
            else None
        )
        test_data = (
            SlideDataset(
                dataset, args.root_path, test_splits, args.task_config,
                split_key=args.split_key, seed=args.seed,
            )
            if len(test_splits) > 0
            else None
        )
        args.n_classes = train_data.n_classes
        loaders = get_loader(train_data, val_data, test_data, **vars(args))
        val_records, test_records = train(loaders, fold, args)

        records = {"val": val_records, "test": test_records}
        for record_ in records:
            if records[record_] is None:
                continue
            for key in records[record_]:
                if "prob" in key or "label" in key:
                    continue
                key_ = record_ + "_" + key
                results.setdefault(key_, []).append(records[record_][key])

    results_df = pd.DataFrame(results)
    results_df.to_csv(os.path.join(args.save_dir, "summary.csv"), index=False)
    for key in results_df.columns:
        logger.info(
            "{}: {:.4f} +- {:.4f}".format(
                key, np.mean(results_df[key]), np.std(results_df[key])
            )
        )
    logger.info("Results saved in: {}".format(os.path.join(args.save_dir, "summary.csv")))
    logger.info("Done!")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
