"""The quantized tile tier (counterpart of ``gigapath_tpu/quant/``).

- :mod:`.qtensor`: the quantize/dequantize helpers (per-channel absmax
  int8 and fp8-e4m3 weights, per-(batch, head) int8 activations).
- :mod:`.qmatmul`: ``q_matmul`` (``csrc/q_matmul.cu`` on the card) and
  ``QuantLinear``, the ``nn.Linear`` twin the tile encoder builds when its
  ``quant`` mode is set.
- :mod:`.qflash`: ``q_flash_attention`` with int8 Q/K logits
  (``csrc/q_flash_attention.cu`` on the card), the ``+attn`` rider.
- :mod:`.convert`: the on-disk quantized artifact, the same format as the
  JAX package's, so an artifact written by either loads in the other.
- :mod:`.parity`: the drift-vs-oracle harness behind the
  ``adopt_quant_tile`` decision row (``parity_report``, ``decision_table``).
"""

from gigapath_tpu_torch.quant import parity  # noqa: F401

