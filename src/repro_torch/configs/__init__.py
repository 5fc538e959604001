"""Architecture registry (port of ``repro.configs``): ``get_arch(name)``.

Each LM config module exports ``CONFIG`` (an ``ArchConfig`` with the
published hyperparameters) and ``SMOKE`` (a reduced same-family config for
CPU tests). The CF-KAN configs (``cf_kan_1``, ``cf_kan_2``) export
``MODEL`` and ``SMOKE_MODEL`` as well.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.transformer import ModelConfig

ARCH_IDS = [
    "whisper_base", "recurrentgemma_2b", "kimi_k2_1t_a32b", "mixtral_8x7b",
    "mistral_nemo_12b", "phi3_medium_14b", "qwen2_72b", "nemotron_4_340b",
    "mamba2_1p3b", "internvl2_76b",
    # the paper's own architectures
    "cf_kan_1", "cf_kan_2",
]
AUX_ARCH_IDS = ["kan_llm", "kan_llm_int8"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    optimizer: str = "adamw"          # adamw | adamw8 | adafactor
    learning_rate: float = 3e-4
    accum_steps: int = 1              # for train_4k
    grad_dtype: Any = torch.float32
    # long_500k applicability: sub-quadratic sequence mixing only
    subquadratic: bool = False
    notes: str = ""

    @property
    def name(self) -> str:
        return self.model.name

    def shapes(self) -> Tuple[str, ...]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.subquadratic:
            out.append("long_500k")
        return tuple(out)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "p")
    if name not in ARCH_IDS and name not in AUX_ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{ARCH_IDS + AUX_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.CONFIG


def lm_cells():
    """All (arch, shape, applicable) dry-run cells for the 10 assigned LM
    archs."""
    cells = []
    for a in ARCH_IDS:
        if a.startswith("cf_kan"):
            continue
        cfg = get_arch(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            applicable = s in cfg.shapes()
            cells.append((a, s, applicable))
    return cells
