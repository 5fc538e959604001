"""KAN-FFN LLM on the ``lut_int8`` backend: the same serving vehicle as
``kan_llm``, but the expanded-basis contraction stays integer end to end —
int8 basis codes x int8 coefficient codes with int32 accumulation
(``torch._int_mm``), one f32 scale multiply after the contraction.
"""
import dataclasses

from repro_torch.configs import ArchConfig
from repro_torch.configs.kan_llm import CONFIG as _LUT_CONFIG
from repro_torch.configs.kan_llm import SMOKE as _LUT_SMOKE


def _int8(model, name):
    return dataclasses.replace(model, name=name, kan_backend="lut_int8")


CONFIG = ArchConfig(
    model=_int8(_LUT_CONFIG.model, "kan-llm-30m-int8"),
    optimizer="adamw", learning_rate=3e-4,
    notes="kan_llm served on the lut_int8 (int8-MXU) backend: int8 E x "
          "int8 C with int32 accumulation, no f32 dequant before the "
          "contraction")

SMOKE = ArchConfig(
    model=_int8(_LUT_SMOKE.model, "kan-llm-smoke-int8"),
    optimizer="adamw", learning_rate=3e-4)
