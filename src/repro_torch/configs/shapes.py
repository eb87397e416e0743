# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The input-shape suite (the same four cells for every LM config).

``decode_*`` / ``long_*`` run a serving step (one new token against a
``seq_len``-deep KV or SSM cache), ``prefill_*`` a prefill and
``train_*`` a training step.  Sequences of 4096 and more attend through
``models.layers.chunked_attention``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a cell runs, and the reason when it does not: ``long_500k``
    needs sub-quadratic attention, so it runs for the SSM and hybrid
    configs only (the encoder-decoder's decoder serves the decode
    cells)."""
    if shape.name == "long_500k" and not model.is_subquadratic:
        return False, ("full-attention arch: 524k context infeasible "
                       "(noted in DESIGN.md)")
    return True, ""


def cells(models: dict[str, ModelConfig]):
    """All (arch, shape) cells: (model name, shape name, runs, reason)."""
    out = []
    for mname, mcfg in models.items():
        for sname, scfg in SHAPES.items():
            ok, why = applicable(mcfg, scfg)
            out.append((mname, sname, ok, why))
    return out
