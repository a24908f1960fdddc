"""YAML task-config loader (counterpart of
``gigapath_tpu/finetune/task_configs/utils.py``); PyYAML is imported only
here, when a file is read."""

from __future__ import annotations


def load_task_config(config_path: str) -> dict:
    import yaml

    with open(config_path, "r") as f:
        return yaml.safe_load(f)
