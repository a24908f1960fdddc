"""Named LongNet config registry (the port's copy of
``gigapath_tpu/models/longnet_config.py``).

Parity with reference ``torchscale/model/LongNetConfig.py`` — the same 22
named configurations (hyperparameter data, not code), expressed through a
generator instead of 330 lines of copy-pasted dicts. ``block_shift`` is kept
for name/key parity but is dead in the reference too (EncoderConfig never
consumes it, ``architecture/config.py:5-61``).

The "Vanilla" variants (dilated ratio [1], one 10^7-token segment) are the
reference's own statement that dilated attention with ratio 1 and an
unsegmented sequence equals full attention — our equivalence tests rely on
the same property.
"""

from __future__ import annotations

import re
from typing import Dict, List

SHORT_SCHEDULE = {"dilated_ratio": "[1, 2, 4]", "segment_length": "[512, 1024, 2048]"}
FULL_SCHEDULE = {
    "dilated_ratio": "[1, 2, 4, 8, 16]",
    "segment_length": "[1024, 2048, 4096, 8192, 16384]",
}
VANILLA_SCHEDULE = {"dilated_ratio": "[1]", "segment_length": "[10000000]"}


def _config(layers, dim, ffn, heads, schedule, block_shift=True):
    return {
        "encoder_layers": layers,
        "encoder_embed_dim": dim,
        "encoder_ffn_embed_dim": ffn,
        "encoder_attention_heads": heads,
        "flash_attention": True,
        "block_shift": block_shift,
        "use_xmoe": False,
        "moe_top1_expert": False,
        "moe_freq": 0,
        "moe_expert_count": 0,
        **schedule,
    }


REGISTRY: Dict[str, dict] = {
    "LongNet_8_layers_256_dim_mlp2": _config(8, 256, 512, 16, SHORT_SCHEDULE),
    "LongNet_12_layers_256_dim_mlp2": _config(12, 256, 512, 16, SHORT_SCHEDULE),
    "LongNet_8_layers_256_dim": _config(8, 256, 1024, 16, FULL_SCHEDULE),
    "LongNet_12_layers_256_dim": _config(12, 256, 1024, 16, FULL_SCHEDULE),
    "LongNet_3_layers_384_dim": _config(3, 384, 1536, 16, FULL_SCHEDULE),
    "LongNet_6_layers_384_dim": _config(6, 384, 1536, 16, FULL_SCHEDULE),
    "LongNet_12_layers_384_dim": _config(12, 384, 1536, 16, FULL_SCHEDULE),
    "LongNet_12_layers_512_dim": _config(12, 512, 1024, 8, SHORT_SCHEDULE),
    "LongNet_3_layers_768_dim": _config(3, 768, 3072, 16, FULL_SCHEDULE),
    "LongNet_6_layers_768_dim": _config(
        6, 768, 3072, 16,
        {"dilated_ratio": "[1, 2, 4, 8, 16]",
         "segment_length": "[1024, 4096, 8192, 16384, 65536]"},
    ),
    "LongNet_8_layers_768_dim": _config(8, 768, 3072, 16, FULL_SCHEDULE),
    "LongNet_12_layers_768_dim": _config(12, 768, 3072, 16, FULL_SCHEDULE),
    "LongNet_8_layers_1024_dim": _config(8, 1024, 4096, 16, FULL_SCHEDULE),
    "LongNet_24_layers_1024_dim": _config(24, 1024, 4096, 16, FULL_SCHEDULE),
    "LongNet_3_layers_1536_dim": _config(3, 1536, 6144, 16, FULL_SCHEDULE),
    "LongNet_6_layers_1536_dim": _config(6, 1536, 6144, 16, FULL_SCHEDULE),
    "LongNet_8_layers_1536_dim": _config(8, 1536, 6144, 16, FULL_SCHEDULE),
    "LongNet_12_layers_1536_dim": _config(12, 1536, 6144, 16, FULL_SCHEDULE),
    "LongNet_Vanilla_12_layers_256_dim": _config(12, 256, 512, 8, VANILLA_SCHEDULE, block_shift=False),
    "LongNet_Vanilla_6_layers_768_dim": _config(6, 768, 3072, 16, VANILLA_SCHEDULE, block_shift=False),
    "LongNet_Vanilla_6_layers_1536_dim": _config(6, 1536, 6144, 16, VANILLA_SCHEDULE, block_shift=False),
    "LongNet_test": _config(1, 192, 192, 8, SHORT_SCHEDULE),
}


_NAME_PATTERN = re.compile(
    r"^LongNet_(?P<layers>\d+)_layers_(?P<dim>\d+)_dim(?:_mlp(?P<mlp>[\d.]+))?$"
)


def get_config(name: str) -> dict:
    if name in REGISTRY:
        return dict(REGISTRY[name])
    # Synthesize configs for names following the reference naming scheme
    # (slide_encoder.py:106-108 generates names this way) that were never
    # added to the registry — e.g. custom depths/dims for ablations.
    m = _NAME_PATTERN.match(name)
    if m:
        dim = int(m.group("dim"))
        mlp = float(m.group("mlp")) if m.group("mlp") else 4.0
        return _config(int(m.group("layers")), dim, int(dim * mlp), 16, FULL_SCHEDULE)
    raise KeyError(f"unknown LongNet config: {name!r}; known: {sorted(REGISTRY)}")


def list_configs() -> List[str]:
    return sorted(REGISTRY)


def flagship_geometry() -> dict:
    """Single source of truth for the flagship slide encoder's geometry
    (gigapath_slide_enc12l768d): scripts derive shapes from here instead of
    re-hardcoding them (chip_smoke.py)."""
    from gigapath_tpu_torch.models.slide_encoder import get_optimal_segment_length

    cfg = get_config("LongNet_12_layers_768_dim")
    heads = cfg["encoder_attention_heads"]
    dim = cfg["encoder_embed_dim"]
    return {
        "depth": cfg["encoder_layers"],
        "embed_dim": dim,
        "heads": heads,
        "head_dim": dim // heads,
        "ffn_dim": cfg["encoder_ffn_embed_dim"],
        "in_chans": 1536,
        "segment_lengths": get_optimal_segment_length(),
        "dilated_ratios": [1, 2, 4, 8, 16],
    }
