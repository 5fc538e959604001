"""Process-variation sampling + Monte-Carlo harness (paper §4.C, Fig. 18;
port of ``repro.hw.variation``).

Every programmed RRAM cell's conductance deviates from its target by a
relative dispersion, and the evaluation repeats over chip instances:

* ``VariationConfig`` — relative per-cell conductance sigma (0 = ideal
  chip) with tail truncation.
* ``tile_gain`` / ``grid_gain`` — DETERMINISTIC per-cell multipliers drawn
  per ``(seed, layer, tile)``. Each tile has its own CPU ``torch.Generator``
  seeded by a fixed 64-bit mix (a splitmix64 chain) of those ids, so a
  tile's draw is the same whatever the order tiles are drawn in, and the
  same on every device (the gains are made on the CPU and then moved).
  The reference keys ``jax.random`` by ``fold_in`` over the same ids; the
  two give different numbers, so parity tests carry the reference's gains
  across instead.
* ``monte_carlo`` / ``sweep_array_size`` — the Fig.-18 harness: a metric
  over chip seeds, reported as mean / std / 95% CI per array size.
* ``DriftConfig`` / ``drift_gain`` — temporal conductance drift
  ``G(t) = G0 (1 + t/tau) ** (-nu)`` with a per-cell exponent ``nu`` drawn
  from the same scheme after one extra salt, so drift draws never alias the
  process-variation draws: identity at age 0, monotone in age.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

# Relative conductance dispersion of a programmed cell — the order of the
# measured TSMC-22nm device-to-device statistics the paper cites [13][14].
DEFAULT_SIGMA = 0.05

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _mix_ids(*ids: int) -> int:
    """A 64-bit generator seed that is a fixed function of the id chain
    (each id folded in after the previous ones, as ``fold_in`` does)."""
    h = 0
    for i in ids:
        h = _splitmix64(h ^ (int(i) & _MASK64))
    return h


def _tile_normal(ids: Sequence[int], shape, clip: float) -> torch.Tensor:
    gen = torch.Generator().manual_seed(_mix_ids(*ids))
    return torch.clamp(torch.randn(tuple(shape), generator=gen,
                                   dtype=torch.float32), -clip, clip)


@dataclasses.dataclass(frozen=True)
class VariationConfig:
    sigma: float = 0.0     # relative per-cell conductance std; 0 = ideal
    clip: float = 3.0      # truncate draws at +/- clip sigmas
    seed: int = 0          # chip-lot seed; one seed = one chip instance

    def with_seed(self, seed: int) -> "VariationConfig":
        return dataclasses.replace(self, seed=seed)


def tile_gain(cfg: VariationConfig, layer_uid: int, tr: int, tc: int,
              shape: Tuple[int, int]) -> torch.Tensor:
    """Per-cell conductance multipliers for ONE tile, [As, Cc] f32 on the
    CPU: ``max(1 + sigma * clip(eps), 0)`` with ``eps`` from the generator
    seeded by ``_mix_ids(seed, layer_uid, tr, tc)``."""
    eps = _tile_normal((cfg.seed, layer_uid, tr, tc), shape, cfg.clip)
    return torch.clamp(1.0 + cfg.sigma * eps, min=0.0)


def grid_gain(cfg: VariationConfig, layer_uid: int, n_tr: int, n_tc: int,
              array_size: int, tile_cols: int) -> torch.Tensor:
    """All tiles of one layer's grid: [Tr, Tc, As, Cc] multipliers on the
    CPU, equal to calling ``tile_gain`` per tile in any order."""
    return torch.stack([
        torch.stack([tile_gain(cfg, layer_uid, a, b, (array_size, tile_cols))
                     for b in range(n_tc)]) for a in range(n_tr)])


# ---------------------------------------------------------------------------
# Temporal drift (retention loss)
# ---------------------------------------------------------------------------

#: salt separating drift draws from process-variation draws: the same
#: (seed, layer, tile) yields INDEPENDENT static and temporal non-idealities
_DRIFT_SALT = 0x0D21F7


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Temporal conductance-drift schedule (power-law retention loss).

    ``rate`` is the mean per-cell drift exponent ``nu`` (0 = no drift);
    ``dispersion`` the relative cell-to-cell spread of ``nu``; ``tau``
    normalises age so the schedule is dimensionless in ticks; ``seed`` picks
    the chip instance."""
    rate: float = 0.0
    dispersion: float = 0.5
    tau: float = 64.0
    clip: float = 3.0
    seed: int = 0

    def with_seed(self, seed: int) -> "DriftConfig":
        """Same drift law, fresh chip instance."""
        return dataclasses.replace(self, seed=seed)


def drift_gain(cfg: DriftConfig, age: float, layer_uid: int, tr: int,
               tc: int, shape: Tuple[int, int]) -> torch.Tensor:
    """Per-cell temporal drift multipliers for ONE tile at ``age`` ticks:
    ``(1 + age/tau) ** (-nu)`` with ``nu = rate * (1 + dispersion * eps)``,
    ``eps`` truncated at ``+/- clip`` and drawn from the generator seeded
    by ``_mix_ids(seed, SALT, layer_uid, tr, tc)``. Identity at age 0.
    Multiply with ``tile_gain`` to compose the static corner with the
    temporal schedule."""
    if cfg.rate == 0.0:
        return torch.ones(tuple(shape), dtype=torch.float32)
    eps = _tile_normal((cfg.seed, _DRIFT_SALT, layer_uid, tr, tc), shape,
                       cfg.clip)
    nu = cfg.rate * (1.0 + cfg.dispersion * eps)
    base = torch.tensor(1.0 + np.float32(age) / cfg.tau, dtype=torch.float32)
    return torch.pow(base, -nu)


# ---------------------------------------------------------------------------
# Monte-Carlo harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MCStats:
    """Sample statistics of one Monte-Carlo cell."""
    values: tuple
    mean: float
    std: float
    ci95: float          # 1.96 * std / sqrt(n) — normal-approx half-width
    n: int


def monte_carlo(eval_fn: Callable[[int], float],
                seeds: Sequence[int]) -> MCStats:
    """Evaluate ``eval_fn(seed)`` per chip instance and summarise."""
    vals = [float(eval_fn(int(s))) for s in seeds]
    n = len(vals)
    mean = float(np.mean(vals))
    std = float(np.std(vals, ddof=1)) if n > 1 else 0.0
    return MCStats(values=tuple(vals), mean=mean, std=std,
                   ci95=1.96 * std / math.sqrt(n) if n > 1 else 0.0, n=n)


def sweep_array_size(make_eval: Callable[[int], Callable[[int], float]],
                     array_sizes: Sequence[int],
                     seeds: Sequence[int]) -> List[Dict]:
    """Fig.-18 x-axis: ``make_eval(As)`` returns the per-seed metric fn;
    one row of {As, mean, std, ci95, n, values} per array size."""
    rows = []
    for a in array_sizes:
        st = monte_carlo(make_eval(int(a)), seeds)
        rows.append({"As": int(a), "mean": st.mean, "std": st.std,
                     "ci95": st.ci95, "n": st.n, "values": list(st.values)})
    return rows
