"""PyTorch/CUDA port of gigapath_tpu for NVIDIA Hopper (H100).

The JAX package ``gigapath_tpu`` stays the reference; this package imports
``torch`` and never ``jax``, ``flax`` or anything of ``gigapath_tpu``. Its
layout mirrors the JAX package (``ops/``, ``architecture/``, ``models/``,
``utils/``, ``pipeline.py``) so a reader finds each counterpart by name.

The two-stage pipeline (tile encoder, bf16 or quantized, then the slide
encoder) and slide-level fine-tuning run end to end. Every Pallas kernel on
those paths is a hand-written CUDA C++ kernel under ``csrc/``, built at
first use by :mod:`gigapath_tpu_torch.ops._build`. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
"""

from gigapath_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
