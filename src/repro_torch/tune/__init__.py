"""repro_torch.tune — per-layer operating-point autotuner for deployed KANs
(port of ``repro.tune``).

Closes the paper's algorithm–hardware co-design loop: ``space`` defines the
per-layer (G, LD, coeff_bits) lattice with Eq. (4)/(5) feasibility,
``pareto`` keeps the accuracy-vs-area/power/latency frontier, and ``search``
runs the sensitivity-seeded evolutionary loop that scores every candidate
through the real ``core.kan.deploy()``/``apply()`` contract — what is scored
is exactly what serves.
"""
from repro_torch.tune.pareto import Candidate, ParetoFrontier, dominates  # noqa: F401
from repro_torch.tune.search import TuneConfig, TuneResult, search, seed_assignment  # noqa: F401
from repro_torch.tune.space import (  # noqa: F401
    OperatingPoint, apply_point, assignment_cost, assignment_spec,
    is_feasible, lattice, point_of, refit_params)
