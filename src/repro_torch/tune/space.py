"""Operating-point lattice: the per-layer search space of the autotuner
(port of ``repro.tune.space``).

One *operating point* freezes a single KAN layer's hardware configuration:

* ``grid_size`` (G) — spline expressiveness and crossbar rows (I*(G+K));
* ``ld`` — PowerGap levels-per-interval exponent: input resolution inside a
  knot interval AND the SH-LUT depth (2^(LD-1) stored rows);
* ``coeff_bits`` — coefficient bit-width in {8, 4, 2}: how many bit-slice
  columns the chip programs per coefficient.

Feasibility is the paper's Eq. (4)/(5) pair: ``G * 2^LD <= 2^n`` with
``L = 2^LD`` an integer power of two (>= 2, so the PowerGap shift/mask
decode has at least one local bit). Everything here is host-side and
static — points are applied to ``ASPConfig``/``KANSpec`` once, before
``core.kan.deploy`` freezes the artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import grid_extension, kan
from repro_torch.core.quant import ASPConfig
from repro_torch.hw import cost_model

COEFF_BITS = (8, 4, 2)
DEFAULT_GRIDS = (2, 4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True, order=True)
class OperatingPoint:
    """One layer's frozen hardware configuration: (G, LD, coeff_bits)."""
    grid_size: int
    ld: int
    coeff_bits: int

    @property
    def sub8(self) -> bool:
        """True when the point programs fewer than 8 bit-slices."""
        return self.coeff_bits < 8

    def as_dict(self) -> Dict[str, int]:
        """JSON-friendly view (bench_pareto record rows)."""
        return {"G": self.grid_size, "LD": self.ld,
                "coeff_bits": self.coeff_bits}


def is_feasible(pt: OperatingPoint, *, n_bits: int = 8,
                bits: Sequence[int] = COEFF_BITS) -> bool:
    """Eq. (4)/(5) + carrier feasibility of one operating point.

    Alignment (Eq. 4): an integer number of quantization levels per knot
    interval, ``G * L <= 2^n``. PowerGap (Eq. 5): ``L = 2^LD`` with
    ``LD >= 1`` (at least one local bit for the shift/mask decode).
    ``coeff_bits`` must be one of the supported bit-slice widths.
    """
    return (pt.grid_size >= 2
            and pt.ld >= 1
            and pt.grid_size * (1 << pt.ld) <= (1 << n_bits)
            and pt.coeff_bits in tuple(bits))


def lattice(base: ASPConfig, *, grids: Sequence[int] = DEFAULT_GRIDS,
            lds: Optional[Sequence[int]] = None,
            bits: Sequence[int] = COEFF_BITS) -> Tuple[OperatingPoint, ...]:
    """All feasible operating points for a spline family.

    ``base`` fixes the family constants (n, K, knot range); ``grids`` /
    ``lds`` / ``bits`` enumerate the candidate coordinates (``lds=None``
    means every LD in [1, Eq.-6 maximum] per G). Infeasible combinations
    are filtered by ``is_feasible`` — the emitted tuple is the exact search
    space, sorted for determinism.
    """
    pts = []
    for g in grids:
        if g > 2 ** base.n_bits:
            continue
        ld_max = dataclasses.replace(base, grid_size=g, ld_cap=None).ld_max
        cand_lds = range(1, ld_max + 1) if lds is None else lds
        for ld in cand_lds:
            for b in bits:
                pt = OperatingPoint(g, ld, b)
                if is_feasible(pt, n_bits=base.n_bits, bits=bits):
                    pts.append(pt)
    return tuple(sorted(set(pts)))


def apply_point(asp: ASPConfig, pt: OperatingPoint) -> ASPConfig:
    """Freeze one layer's ASPConfig at an operating point."""
    return dataclasses.replace(asp, grid_size=pt.grid_size, ld_cap=pt.ld,
                               coeff_bits=pt.coeff_bits)


def point_of(asp: ASPConfig) -> OperatingPoint:
    """The operating point a config currently sits at (effective LD)."""
    return OperatingPoint(asp.grid_size, asp.ld, asp.coeff_bits)


def assignment_spec(spec: kan.KANSpec,
                    points: Sequence[OperatingPoint]) -> kan.KANSpec:
    """A KANSpec with every layer frozen at its own operating point."""
    if len(points) != spec.n_layers:
        raise ValueError(f"{len(points)} operating points for "
                         f"{spec.n_layers} layers")
    asp = tuple(apply_point(spec.asp[i], points[i])
                for i in range(spec.n_layers))
    return dataclasses.replace(spec, asp=asp)


def refit_params(params, spec: kan.KANSpec, new_spec: kan.KANSpec):
    """Refit trained params from ``spec`` onto ``new_spec``'s grids.

    Layers whose G changed get the least-squares coefficient refit
    (``core.grid_extension`` — the same matrix works for extension and
    reduction); LD/coeff_bits changes need no refit (they only change how
    ``deploy`` quantizes). Returns a params tree shaped for ``new_spec``.
    """
    names = spec.names
    if names is None:
        if spec.asp[0].grid_size == new_spec.asp[0].grid_size:
            return params
        return grid_extension.extend_layer_params(params, spec.asp[0],
                                                  new_spec.asp[0])
    out = {}
    for i, name in enumerate(names):
        lp = params[name]
        if spec.asp[i].grid_size != new_spec.asp[i].grid_size:
            lp = grid_extension.extend_layer_params(lp, spec.asp[i],
                                                    new_spec.asp[i])
        out[name] = lp
    return out


def assignment_cost(spec: kan.KANSpec) -> cost_model.AcceleratorCost:
    """Hardware cost of a per-layer assignment via the calibrated mixed
    cost model: spline coefficients at each layer's ``coeff_bits``, base
    (residual-branch) weights at the full 8 bits, B(X) units per input
    channel at each layer's (G, LD, coeff_bits)."""
    layers = []
    for i in range(spec.n_layers):
        ls = spec.layer(i)
        layers.append((ls.in_dim * ls.asp.n_basis * ls.out_dim, ls.in_dim,
                       ls.asp))
        if spec.base_activation:
            # digital residual branch: 8-bit weights, no B(X) units
            layers.append((ls.in_dim * ls.out_dim, 0,
                           dataclasses.replace(ls.asp, coeff_bits=8,
                                               ld_cap=None)))
    return cost_model.mixed_kan_cost(layers)
