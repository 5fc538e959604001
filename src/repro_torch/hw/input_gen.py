"""TM-DV-IG: N:1 Time-Modulated Dynamic-Voltage input generator (paper §3.2;
a copy of ``repro.hw.input_gen``: pure Python).

The circuit itself (delay chain, PM-TCM, N-bit DAC, TG-MUX, buffer array) has
no analogue on a GPU, which has no word lines. What transfers is:

1. the *accuracy* effect: a 2N-bit WL input is encoded as two N-bit
   pulse/voltage products, so the effective input resolution and noise margin
   depend on the mode — TD-P (N=4: 8-bit input, 64 dense voltage states,
   throughput-optimized) vs TD-A (N=3: 6-bit input, finer charge resolution,
   accuracy-optimized). Modeled here as WL DAC quantization + a mode noise
   factor, consumed by hw.cim.CIMConfig.

2. the *cost* effect (Figs. 14-17): area/power/latency of the three WL input
   schemes (pure voltage, pure PWM, TM-DV) vs N. Reproduced with a
   component-calibrated table (see INPUT_SCHEME_COSTS below).

Cost-model calibration (22 nm, unit-normalized):
  latency units:  voltage = 1 pulse; PWM = 2^(2N) unit pulses; TM-DV = 2^N
    (ratioed pulses W_P1 : W_PN : W_P(N+1) = 1 : 2^N : 2^N+1 overlap into a
    single cycle whose length is dominated by the 2^N term).
  area: voltage needs a 2N-bit DAC (∝ 2^2N); PWM a 2^(2N)-stage delay chain;
    TM-DV an N-bit DAC + short delay chain + PM-TCM/TG-MUX fixed block.
  power: voltage DAC static power grows super-exponentially with resolution
    (shrinking noise margins force bias current up); PWM is switching-limited
    (lowest power); TM-DV sits between, with a fixed PM-TCM floor.

Constants are calibrated to the paper's N=3 anchors: voltage = 1.96× area,
11.9× power vs TM-DV; PWM = 8× latency, 1.07× area; FOM(TM-DV) = 3× voltage,
4.1× PWM; and to the qualitative N=1 ordering (voltage best FOM, PWM best
power, TM-DV worst FOM). Held to the reference's values in
tests/test_torch_chip.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# ---- calibrated component constants (dimensionless 22nm-normalized units) --
_A_DELAY_PER_STAGE = 0.4     # delay-chain area per unit pulse stage
_A_TMDV_FIXED = 21.45        # PM-TCM + TG-MUX + buffer array
_A_PWM_FIXED = 9.3           # PWM pulse generator
_P_TMDV_FIXED = 35.0         # PM-TCM + buffer static power
_P_VOLT = {1: 40.0, 2: 280.0, 3: 512.0, 4: 4096.0}   # 2N-bit DAC bias power
_P_PWM = {1: 8.0, 2: 17.5, 3: 20.6, 4: 30.0}          # switching-limited


@dataclasses.dataclass(frozen=True)
class SchemeCost:
    area: float
    power: float
    latency: float

    @property
    def fom(self) -> float:
        """Joint figure of merit: 1 / (area * power * latency)."""
        return 1.0 / (self.area * self.power * self.latency)


def input_scheme_cost(scheme: str, n: int) -> SchemeCost:
    """Area/power/latency of one WL input scheme at parameter N (1..4).

    N:1 time modulation encodes a 2N-bit input vector per WL per cycle.
    """
    if not 1 <= n <= 4:
        raise ValueError("paper evaluates N = 1..4 (2..8-bit input vectors)")
    if scheme == "voltage":
        return SchemeCost(area=float(2 ** (2 * n)), power=_P_VOLT[n],
                          latency=1.0)
    if scheme == "pwm":
        return SchemeCost(
            area=_A_DELAY_PER_STAGE * 2 ** (2 * n) + _A_PWM_FIXED,
            power=_P_PWM[n], latency=float(2 ** (2 * n)))
    if scheme == "tmdv":
        return SchemeCost(
            area=(2 ** n + _A_DELAY_PER_STAGE * 2 ** n + _A_TMDV_FIXED),
            power=2.0 ** n + _P_TMDV_FIXED, latency=float(2 ** n))
    raise ValueError(f"unknown scheme {scheme!r}")


def scheme_table(n: int) -> Dict[str, SchemeCost]:
    return {s: input_scheme_cost(s, n) for s in ("voltage", "pwm", "tmdv")}


# ---- operating modes (paper §3.2 / §4.D) ----------------------------------

@dataclasses.dataclass(frozen=True)
class TMDVMode:
    name: str
    n: int                 # modulation parameter
    input_bits: int        # effective WL input resolution (2N)
    noise_factor: float    # relative partial-sum noise multiplier

TD_P = TMDVMode(name="TD-P", n=4, input_bits=8, noise_factor=1.6)
TD_A = TMDVMode(name="TD-A", n=3, input_bits=6, noise_factor=1.0)

MODES = {"TD-P": TD_P, "TD-A": TD_A}
