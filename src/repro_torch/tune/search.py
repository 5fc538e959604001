"""Sensitivity-seeded per-layer operating-point search, the co-design loop
(port of ``repro.tune.search``).

The paper profiles per-layer sensitivity (Algorithm 2) and *reports* chip
cost; this module closes the loop: Algorithm-2 tiers seed one operating
point per layer, then an evolutionary loop with successive halving mutates
single-layer points, scoring every candidate by

* **accuracy** — the deployed integer forward (``core.kan.deploy`` →
  caller-supplied ``score_fn``), so what is scored is exactly what serves;
* **area / power / latency** — the calibrated mixed-precision cost model
  (``space.assignment_cost`` → ``hw.cost_model.mixed_kan_cost``).

Candidates live or die on the ``pareto.ParetoFrontier``. The whole search
is deterministic under a fixed ``TuneConfig.seed`` (host-side
``numpy.random.Generator`` drives every stochastic choice). The port keeps
that generator and the order of its draws, so for the same scores it
proposes, evaluates and keeps the same candidates as the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import kan, sensitivity
from repro_torch.tune import space
from repro_torch.tune.pareto import Candidate, ParetoFrontier

Assignment = Tuple[space.OperatingPoint, ...]


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Search knobs. ``budget`` counts FULL candidate evaluations (deploy +
    ``score_fn``); quick-score screening under successive halving is not
    charged against it. ``seed`` fixes every stochastic choice."""
    budget: int = 24
    proposals_per_round: int = 6
    seed: int = 0
    grids: Sequence[int] = space.DEFAULT_GRIDS
    bits: Sequence[int] = space.COEFF_BITS


@dataclasses.dataclass
class TuneResult:
    """Search output: the frontier, the uniform-8-bit baseline candidate,
    every evaluated candidate (in evaluation order), and a per-round log."""
    frontier: ParetoFrontier
    baseline: Candidate
    evaluated: List[Candidate]
    history: List[Dict]

    def best_sub8(self) -> Optional[Candidate]:
        """Highest-accuracy frontier point with any sub-8-bit layer."""
        for c in self.frontier.points():
            if c.sub8:
                return c
        return None


def _sens_per_layer(spec: kan.KANSpec,
                    sens: Union[Dict[str, float], Sequence[float]]
                    ) -> List[float]:
    """Normalize a sensitivity mapping to one float per layer index.

    Accepts either a plain per-layer sequence or the dict that
    ``core.sensitivity.layer_sensitivities`` returns (keyed by pytree
    paths like ``"enc/coeffs"`` — matched per layer name).
    """
    if not isinstance(sens, dict):
        vals = [float(v) for v in sens]
        if len(vals) != spec.n_layers:
            raise ValueError(f"{len(vals)} sensitivities for "
                             f"{spec.n_layers} layers")
        return vals
    names = spec.names or ("l0",)
    out = []
    for name in names:
        match = [v for k, v in sens.items()
                 if k == name or k.startswith(f"{name}/")]
        if len(match) != 1:
            raise ValueError(f"sensitivity for layer {name!r} not found "
                             f"uniquely in {sorted(sens)}")
        out.append(float(match[0]))
    return out


def seed_assignment(spec: kan.KANSpec,
                    sens: Union[Dict[str, float], Sequence[float]],
                    lat: Sequence[space.OperatingPoint]) -> Assignment:
    """Algorithm-2 tiers → one seed operating point per layer.

    HIGH-sensitivity layers keep their full-precision base point (8 bits),
    MEDIUM layers drop to 4-bit coefficients at the base grid, LOW layers
    drop to 4 bits on the largest lattice grid <= half the base G — the
    direction KANtize establishes (insensitive layers tolerate sub-8-bit
    mixed precision).
    """
    vals = _sens_per_layer(spec, sens)
    ga = sensitivity.assign_grids(
        {f"l{i}": v for i, v in enumerate(vals)}, g_high=3, g_med=2, g_low=1)
    grids_avail = sorted({p.grid_size for p in lat})
    points = []
    for i in range(spec.n_layers):
        base = space.point_of(spec.asp[i])
        tier = ga.classes[f"l{i}"]
        if tier == "HIGH":
            pt = space.OperatingPoint(base.grid_size, base.ld, 8)
        elif tier == "MEDIUM":
            pt = space.OperatingPoint(base.grid_size, base.ld, 4)
        else:
            half = [g for g in grids_avail if g <= max(base.grid_size // 2, 2)]
            g = half[-1] if half else base.grid_size
            ld_max = dataclasses.replace(spec.asp[i], grid_size=g,
                                         ld_cap=None).ld_max
            pt = space.OperatingPoint(g, min(base.ld, ld_max), 4)
        points.append(_snap(pt, spec.asp[i].n_bits, lat))
    return tuple(points)


def _snap(pt: space.OperatingPoint, n_bits: int,
          lat: Sequence[space.OperatingPoint]) -> space.OperatingPoint:
    """Snap a point into the lattice (nearest feasible LD below, then the
    closest lattice point) so seeds/mutations always emit members of the
    declared search space."""
    if pt in lat:
        return pt
    for ld in range(pt.ld, 0, -1):
        cand = space.OperatingPoint(pt.grid_size, ld, pt.coeff_bits)
        if cand in lat:
            return cand
    # fall back to the closest lattice point (deterministic tie-break)
    return min(lat, key=lambda q: (abs(q.grid_size - pt.grid_size),
                                   abs(q.ld - pt.ld),
                                   abs(q.coeff_bits - pt.coeff_bits), q))


def _mutate(rng: np.random.Generator, assignment: Assignment,
            lat: Sequence[space.OperatingPoint],
            n_bits: int) -> Optional[Assignment]:
    """One single-layer, single-knob lattice step (rejection-sampled until
    feasible); None when no feasible move was found."""
    lat_set = set(lat)
    grids_avail = sorted({p.grid_size for p in lat})
    bits_avail = sorted({p.coeff_bits for p in lat})
    for _ in range(32):
        i = int(rng.integers(len(assignment)))
        pt = assignment[i]
        knob = int(rng.integers(3))
        step = int(rng.choice((-1, 1)))
        if knob == 0:
            gi = grids_avail.index(pt.grid_size) + step
            if not 0 <= gi < len(grids_avail):
                continue
            new = space.OperatingPoint(grids_avail[gi], pt.ld, pt.coeff_bits)
            new = _snap(new, n_bits, lat)
        elif knob == 1:
            new = space.OperatingPoint(pt.grid_size, pt.ld + step,
                                       pt.coeff_bits)
        else:
            bi = bits_avail.index(pt.coeff_bits) + step
            if not 0 <= bi < len(bits_avail):
                continue
            new = space.OperatingPoint(pt.grid_size, pt.ld, bits_avail[bi])
        if new == pt or new not in lat_set:
            continue
        out = list(assignment)
        out[i] = new
        return tuple(out)
    return None


def search(params, spec: kan.KANSpec,
           score_fn: Callable[[kan.DeployedKAN], float], *,
           sens: Union[Dict[str, float], Sequence[float], None] = None,
           cfg: TuneConfig = TuneConfig(),
           quick_fn: Optional[Callable[[kan.DeployedKAN], float]] = None,
           stats=None) -> TuneResult:
    """Run the co-design search and return the Pareto frontier.

    ``params`` are trained float params for ``spec`` (the base operating
    point); every candidate refits them onto its grids
    (``space.refit_params``), deploys through the real backend
    (``spec.backend``), and is scored by ``score_fn(deployed)`` (higher is
    better — e.g. validation Recall@20). ``sens`` (Algorithm-2
    sensitivities) seeds the initial assignment; without it the search
    seeds from the uniform base point. ``quick_fn``, when given, screens
    each round's proposals on a cheap score and only the top half get full
    evaluations (successive halving). ``stats`` is forwarded to
    ``kan.deploy`` for stats-needing backends (KAN-SAM).
    """
    rng = np.random.default_rng(cfg.seed)
    lat = space.lattice(spec.asp[0], grids=tuple(cfg.grids),
                        bits=tuple(cfg.bits))
    if not lat:
        raise ValueError("empty operating-point lattice")
    n_bits = spec.asp[0].n_bits

    evaluated: Dict[Assignment, Candidate] = {}
    order: List[Candidate] = []
    frontier = ParetoFrontier()
    history: List[Dict] = []

    def evaluate(assignment: Assignment, origin: str) -> Candidate:
        if assignment in evaluated:
            return evaluated[assignment]
        new_spec = space.assignment_spec(spec, assignment)
        dep = kan.deploy(space.refit_params(params, spec, new_spec),
                         new_spec, stats=stats)
        cost = space.assignment_cost(new_spec)
        cand = Candidate(assignment, float(score_fn(dep)), cost.area_mm2,
                         cost.power_w, cost.latency_ns,
                         meta={"origin": origin})
        evaluated[assignment] = cand
        order.append(cand)
        frontier.add(cand)
        return cand

    # uniform full-precision baseline: every layer at its base (G, LD), 8 bit
    base_assignment = tuple(
        _snap(space.OperatingPoint(p.grid_size, p.ld, 8), n_bits, lat)
        for p in map(space.point_of, spec.asp))
    baseline = evaluate(base_assignment, "baseline")

    if sens is not None:
        evaluate(seed_assignment(spec, sens, lat), "sensitivity-seed")

    round_idx = 0
    while len(order) < cfg.budget:
        parents = frontier.points()
        proposals: List[Assignment] = []
        attempts = 0
        while (len(proposals) < cfg.proposals_per_round
               and attempts < 16 * cfg.proposals_per_round):
            attempts += 1
            parent = parents[int(rng.integers(len(parents)))]
            child = _mutate(rng, parent.assignment, lat, n_bits)
            if (child is not None and child not in evaluated
                    and child not in proposals):
                proposals.append(child)
        if not proposals:
            break
        if quick_fn is not None and len(proposals) > 1:
            quick = []
            for a in proposals:
                ns = space.assignment_spec(spec, a)
                dep = kan.deploy(space.refit_params(params, spec, ns), ns,
                                 stats=stats)
                quick.append(float(quick_fn(dep)))
            keep = max(1, len(proposals) // 2)
            ranked = sorted(range(len(proposals)),
                            key=lambda j: (-quick[j], proposals[j]))
            proposals = [proposals[j] for j in ranked[:keep]]
        survivors = proposals[:max(cfg.budget - len(order), 0)]
        for a in survivors:
            evaluate(a, f"round{round_idx}")
        history.append({
            "round": round_idx,
            "proposals": len(proposals),
            "evaluated": len(order),
            "frontier_size": len(frontier),
            "best_accuracy": max(c.accuracy for c in frontier.points()),
        })
        round_idx += 1

    return TuneResult(frontier=frontier, baseline=baseline,
                      evaluated=order, history=history)
