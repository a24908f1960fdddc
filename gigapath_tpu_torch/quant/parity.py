"""Drift-vs-oracle parity harness for the quantized tile tier (counterpart
of ``gigapath_tpu/quant/parity.py``).

The adoption evidence for the quantized tile tier is two numbers per
variant, both computed against the fp32 oracle forward on the committed
fixture weights (``tests/fixtures/quant_tile_fixture.npz``):

- **embedding cosine**: the mean per-tile cosine between the variant's
  embeddings and the fp32 oracle's (the acceptance bar: >= 0.999);
- **downstream linear-probe delta**: the PCam-recipe linear probe (full
  batch SGD at lr 0.02) trained on each variant's embeddings; the
  variant's held-out accuracy minus the oracle's, in points (bar: |delta|
  <= 0.5 pt).

Variants are built through the port's registry on ``device`` (``cuda``
unless the caller passes ``cpu``), and the fixture's flax-layout
parameters reach them through
:func:`~gigapath_tpu_torch.utils.convert.state_dict_from_flax_params`. On
the card the quantized variants run ``csrc/q_matmul.cu`` and, with
``+attn``, ``csrc/q_flash_attention.cu``; ``quant_pallas`` is accepted for
the JAX signature and carries nothing (the kernels always run there).

:func:`decision_table` renders the ``adopt_quant_tile`` row: the parity
gates always apply; the speed gate (the candidate at least 3% faster than
bf16) only when walltime was measured, so a run without timings emits the
full row with ``adopt_quant_tile`` false.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DEFAULT_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "fixtures", "quant_tile_fixture.npz",
)
FIXTURE_ARCH = "vit_tile_enc_test"

COSINE_BAR = 0.999
PROBE_DELTA_BAR_PT = 0.5
SPEEDUP_BAR = 1.03


def load_fixture(path: Optional[str] = None) -> Tuple[Dict[str, Any], np.ndarray, np.ndarray]:
    """(flax-layout params, images fp32 [N, H, W, 3] in [-1, 1], labels
    [N]) from the committed fixture npz."""
    path = path or DEFAULT_FIXTURE
    params: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("param/"):
                continue
            node = params
            parts = key[len("param/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
        images = z["images"].astype(np.float32) / 127.5 - 1.0
        labels = z["labels"].astype(np.int64)
    return params, images, labels


def build_variant(arch: str, *, quant: str = "", quant_pallas: bool = False,
                  dtype_name: str = "bfloat16", device: Optional[Union[str, torch.device]] = None,
                  **kwargs) -> torch.nn.Module:
    """One tile-encoder variant in eval mode on ``device``: ``''`` with
    dtype ``float32`` is the oracle, ``''`` with bf16 the production
    baseline, ``int8`` / ``fp8_e4m3`` (+attn) the quantized tiers (fp32
    parameters, ``dtype_name`` the compute dtype)."""
    import gigapath_tpu_torch.models.tile_encoder  # noqa: F401  (registry entries)
    from gigapath_tpu_torch.utils.device import resolve_device
    from gigapath_tpu_torch.utils.registry import create_model_from_registry

    del quant_pallas  # the kernels always run on the card
    dtype = None if dtype_name in ("", "float32") else getattr(torch, dtype_name)
    with torch.device(resolve_device(device)):
        model = create_model_from_registry(arch, dtype=dtype, quant=quant, **kwargs)
    return model.eval()


def encode(model: torch.nn.Module, params: Optional[Mapping[str, Any]], images: np.ndarray) -> np.ndarray:
    """Variant embeddings [N, D] fp32: ``params`` (a flax-layout tree, or
    None for the model's own weights) loaded strictly, then one forward
    under ``inference_mode`` on the model's device."""
    from gigapath_tpu_torch.utils.convert import state_dict_from_flax_params

    if params is not None:
        model.load_state_dict(state_dict_from_flax_params(params), strict=True)
    device = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device))
    return out.float().cpu().numpy()


def mean_cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-row cosine similarity."""
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return float(np.mean(np.sum(a * b, axis=-1)))


def fit_probe(embeds: np.ndarray, labels: np.ndarray, *, iters: int = 400, lr: float = 0.02, seed: int = 42,
              params: Optional[Mapping[str, torch.Tensor]] = None,
              device: Optional[Union[str, torch.device]] = None,
              return_params: bool = False):
    """The PCam-recipe linear probe on frozen embeddings, scaled to the
    fixture: full-batch SGD at lr 0.02 on ``device``, trained on the
    indices with ``idx % 4 < 2`` and scored on the rest (the fixture's
    labels alternate, so an even/odd split would put one class in each
    half). Starts from ``linear_probe.init_linear_probe(D, C, seed)``, or
    from ``params`` (``{"weight" [C, D], "bias" [C]}``) when given. Returns
    the held-out accuracy in [0, 1], and the final state dict too with
    ``return_params``."""
    import torch.nn.functional as F

    from gigapath_tpu_torch.linear_probe.main import init_linear_probe
    from gigapath_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    idx = np.arange(len(labels))
    train = idx % 4 < 2
    test_x, test_y = embeds[~train], labels[~train]
    n_classes = int(labels.max()) + 1
    probe = init_linear_probe(embeds.shape[-1], n_classes, seed)
    if params is not None:
        probe.load_state_dict({k: torch.as_tensor(v).float() for k, v in params.items()})
    probe.to(dev)
    optimizer = torch.optim.SGD(probe.parameters(), lr=lr)
    x = torch.from_numpy(np.ascontiguousarray(embeds[train], np.float32)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(labels[train], np.int64)).to(dev)
    for _ in range(iters):
        loss = F.cross_entropy(probe(x), y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    state = {k: v.detach().cpu() for k, v in probe.state_dict().items()}
    logits = test_x @ state["weight"].numpy().T + state["bias"].numpy()
    acc = float((logits.argmax(-1) == test_y).mean())
    return (acc, state) if return_params else acc


def parity_report(
    params: Dict[str, Any], images: np.ndarray, labels: np.ndarray, *,
    arch: str = FIXTURE_ARCH,
    variants: Sequence[str] = ("bf16", "int8"),
    quant_pallas: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """Per-variant drift vs the fp32 oracle and probe deltas.

    Variant names: ``bf16`` (production baseline, no quant), ``int8``,
    ``fp8_e4m3``, and their ``+attn`` riders. The fp32 oracle is always
    computed (it is the reference, not a variant)."""
    oracle = encode(build_variant(arch, dtype_name="float32", device=device), params, images)
    oracle_acc = fit_probe(oracle, labels, device=device)
    report: Dict[str, Any] = {
        "oracle": {"probe_acc": oracle_acc},
        "variants": {},
    }
    for name in variants:
        quant = "" if name == "bf16" else name
        model = build_variant(arch, quant=quant, quant_pallas=quant_pallas, dtype_name="bfloat16", device=device)
        embeds = encode(model, params, images)
        acc = fit_probe(embeds, labels, device=device)
        report["variants"][name] = {
            "cosine": round(mean_cosine(embeds, oracle), 6),
            "probe_acc": round(acc, 4),
            "probe_delta_pt": round((acc - oracle_acc) * 100.0, 3),
        }
    return report


def decision_table(report: Dict[str, Any],
                   timings: Optional[Dict[str, float]] = None,
                   *, candidate: str = "int8",
                   baseline: str = "bf16") -> Dict[str, Any]:
    """The ``adopt_quant_tile`` decision row: parity gates always, the
    speed gate only when measured (``timings`` in seconds)."""
    cand = report["variants"].get(candidate, {})
    cosine = float(cand.get("cosine", 0.0))
    delta = float(cand.get("probe_delta_pt", 100.0))
    parity_ok = cosine >= COSINE_BAR and abs(delta) <= PROBE_DELTA_BAR_PT
    decision: Dict[str, Any] = {
        "candidate": candidate,
        "cosine": cosine,
        "cosine_drift": round(1.0 - cosine, 6),
        "probe_delta_pt": delta,
        "parity_ok": bool(parity_ok),
    }
    speedup_ok = None
    if timings and candidate in timings and baseline in timings:
        base_s = timings[baseline]
        cand_s = timings[candidate]
        decision[f"{baseline}_ms"] = round(base_s * 1e3, 3)
        decision[f"{candidate}_ms"] = round(cand_s * 1e3, 3)
        decision[f"{candidate}_over_{baseline}"] = round(cand_s / base_s, 4)
        speedup_ok = cand_s <= base_s / SPEEDUP_BAR
        decision["speedup_ok"] = bool(speedup_ok)
    decision["adopt_quant_tile"] = bool(parity_ok and speedup_ok)
    return decision
