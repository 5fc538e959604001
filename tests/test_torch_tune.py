"""Port parity for the per-layer co-design tuner (``repro_torch.tune``)
against ``repro.tune``, and the cases of ``tests/test_tune.py`` run on the
port.

* ``space`` and ``pareto`` are host-side Python: lattices are equal as
  sets, ``assignment_cost`` equal to JAX's float for float at every lattice
  point, ``seed_assignment``, ``_snap`` and ``_mutate``'s proposals equal
  (``search`` keeps the reference's ``numpy.random.Generator`` and the
  order of its draws).
* ``refit_params`` solves f32 normal equations with a 1e-8 ridge in both
  packages (through two LAPACK paths). Against a float64 solve each refit
  matrix M is off by at most 9e-5 on the moves below, within the f32
  solve's forward-error bound ``cond(A^T A) * eps_f32 * max|M|`` (cond
  1300-2300 at K 3). The two packages are held to twice that bound, and
  the refit coefficients to it times ``max_{i,o} sum_s |C_old|``.
* A whole ``search`` with a shared score (a fixed Python function of each
  candidate's operating points, so both packages see identical numbers)
  gives JAX's evaluated assignments, scores, costs, frontier and history
  exactly, with and without a quick screen, for seeds 0-2.
* A whole ``search`` with the reference's own fidelity score (``_tiny``,
  the deployed forward against the float forward on JAX's weights) gives
  the same assignments and frontier, and each candidate's deployed
  forward within ``test_kan_backends.py``'s ``atol 2e-5, rtol 1e-5`` of
  JAX's. The score is a mean squared error s (of a small difference, so
  a relative f32 tolerance on it means little); forwards within
  ``FWD_ATOL`` move it by at most ``2 * sqrt(|s|) * FWD_ATOL +
  FWD_ATOL**2``, and the scores are held to that.
* JAX's sub-8 requant pin (``kan.trace_requantizes``) fails on jax 0.9.0
  in the reference; the port pins the same contract with
  ``quant.quantize_coeffs`` poisoned during ``apply``.
"""
import dataclasses
import importlib
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tune  # noqa: E402
from repro_torch.core import grid_extension as tge  # noqa: E402
from repro_torch.core import kan, quant, sensitivity, splines  # noqa: E402
from repro_torch.core.quant import ASPConfig  # noqa: E402
from repro_torch.tune import pareto, space  # noqa: E402

# the module (``repro_torch.tune.search`` the attribute is the function)
tsearch = importlib.import_module("repro_torch.tune.search")
EPS_F32 = float(np.finfo(np.float32).eps)
FWD_ATOL = 2e-5           # test_kan_backends.py's deployed-forward bar


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import tune as jtune
    from repro.core import kan as jkan, sensitivity as jsens
    from repro.core.quant import ASPConfig as JASP
    from repro.core import grid_extension as jge
    from repro.tune import space as jspace
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, tune=jtune, kan=jkan, sens=jsens, ASP=JASP, ge=jge,
        search=importlib.import_module("repro.tune.search"), space=jspace)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cand(objs, assignment=None):
    """Candidate from a uniformly-minimized objective 4-vector."""
    acc, area, power, lat = objs
    if assignment is None:
        assignment = (space.OperatingPoint(8, 4, 8),)
    return pareto.Candidate(assignment, -acc, area, power, lat)


def _random_vecs(rng, n):
    """Random objective vectors on a small integer grid so dominance
    relations (including exact ties) actually occur in the sample."""
    return [tuple(float(v) for v in rng.integers(0, 4, size=4))
            for _ in range(n)]


def _pts(points):
    return [(p.grid_size, p.ld, p.coeff_bits) for p in points]


def _jasp(jx, asp: ASPConfig):
    return jx.ASP(**dataclasses.asdict(asp))


# --- the cases of tests/test_tune.py, on the port ----------------------------

def test_lattice_points_all_feasible():
    """Every emitted lattice point satisfies Alignment + PowerGap."""
    base = ASPConfig(grid_size=8)
    lat = space.lattice(base)
    assert lat, "lattice must be non-empty"
    assert len(set(lat)) == len(lat)
    for pt in lat:
        assert space.is_feasible(pt, n_bits=base.n_bits)
        assert pt.grid_size * (1 << pt.ld) <= 2 ** base.n_bits   # Eq. 4
        assert pt.ld >= 1                                        # Eq. 5
        assert pt.coeff_bits in space.COEFF_BITS
    assert lat == space.lattice(base)


def test_lattice_infeasible_combinations_filtered():
    """G=64 at n=8 leaves only LD in {1, 2}; G=256 leaves nothing (LD=0)."""
    base = ASPConfig(grid_size=8)
    lds = {pt.ld for pt in space.lattice(base, grids=(64,))}
    assert lds == {1, 2}
    assert space.lattice(base, grids=(256,)) == ()


def test_apply_point_roundtrip():
    asp = ASPConfig(grid_size=8)
    pt = space.OperatingPoint(16, 2, 4)
    asp2 = space.apply_point(asp, pt)
    assert (asp2.grid_size, asp2.ld, asp2.coeff_bits) == (16, 2, 4)
    assert space.point_of(asp2) == pt


def test_sub8_assignment_costs_less():
    """Dropping one layer to 4-bit coefficients strictly shrinks area AND
    power in the mixed cost model."""
    asp = ASPConfig(grid_size=8)
    spec = kan.KANSpec(dims=(8, 6, 8), asp=(asp, asp),
                       layer_names=("enc", "dec"))
    base = space.assignment_cost(spec)
    pts = (space.OperatingPoint(8, asp.ld, 4),
           space.OperatingPoint(8, asp.ld, 8))
    mixed = space.assignment_cost(space.assignment_spec(spec, pts))
    assert mixed.area_mm2 < base.area_mm2
    assert mixed.power_w < base.power_w


def test_dominance_irreflexive():
    rng = np.random.default_rng(0)
    for v in _random_vecs(rng, 200):
        assert not pareto.dominates(_cand(v), _cand(v))


def test_dominance_antisymmetric():
    rng = np.random.default_rng(1)
    for u, v in zip(_random_vecs(rng, 200), _random_vecs(rng, 200)):
        a, b = _cand(u), _cand(v)
        assert not (pareto.dominates(a, b) and pareto.dominates(b, a))


def test_dominance_transitive():
    rng = np.random.default_rng(2)
    triggered = 0
    for _ in range(2000):
        a, b, c = (_cand(tuple(float(v) for v in rng.integers(0, 3, size=4)))
                   for _ in range(3))
        if pareto.dominates(a, b) and pareto.dominates(b, c):
            triggered += 1
            assert pareto.dominates(a, c)
    assert triggered > 10


def test_frontier_is_mutually_non_dominated():
    rng = np.random.default_rng(3)
    for _ in range(50):
        cands = [_cand(v) for v in
                 _random_vecs(rng, int(rng.integers(1, 20)))]
        f = pareto.ParetoFrontier()
        for c in cands:
            f.add(c)
        pts = f.points()
        assert pts
        for p in pts:
            for q in pts:
                assert not pareto.dominates(p, q)
        for c in cands:
            assert c.objectives() in {p.objectives() for p in pts} or \
                any(pareto._weakly_dominates(p, c) for p in pts)


def test_dominated_candidate_never_survives():
    good = _cand((1.0, 1.0, 1.0, 1.0))
    worse = _cand((2.0, 2.0, 2.0, 2.0))
    f = pareto.ParetoFrontier()
    assert f.add(good)
    assert not f.add(worse)
    assert worse not in f.points()
    f2 = pareto.ParetoFrontier()
    assert f2.add(worse)
    assert f2.add(good)
    assert f2.points() == (good,)


def test_candidate_sub8_flag_and_row():
    c = pareto.Candidate((space.OperatingPoint(8, 4, 8),
                          space.OperatingPoint(4, 3, 2)),
                         0.5, 1.0, 2.0, 3.0, meta={"origin": "t"})
    assert c.sub8
    row = c.as_dict()
    assert row["assignment"][1] == {"G": 4, "LD": 3, "coeff_bits": 2}
    assert row["sub8"] and row["origin"] == "t"


def _tiny():
    """2-layer named KAN + a deterministic fidelity score (negative MSE of
    the deployed forward against the float reference), on the port."""
    asp = ASPConfig(grid_size=8)
    spec = kan.KANSpec(dims=(8, 6, 8), asp=(asp, asp), backend="lut",
                       layer_names=("enc", "dec"))
    params = kan.init(0, spec, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = 2 * torch.rand((16, 8), generator=gen) - 1
    ref = kan.train_apply(params, x, spec)

    def score(dep):
        return -float(torch.mean((kan.apply(dep, x) - ref) ** 2))

    return spec, params, x, score


def test_search_deterministic_and_emits_feasible_points():
    spec, params, x, score = _tiny()
    cfg = tune.TuneConfig(budget=6, proposals_per_round=4, seed=0)
    r1 = tune.search(params, spec, score, cfg=cfg)
    r2 = tune.search(params, spec, score, cfg=cfg)
    key = lambda r: [(c.assignment, c.accuracy, c.area_mm2, c.power_w)
                     for c in r.frontier.points()]
    assert key(r1) == key(r2)
    assert [c.assignment for c in r1.evaluated] == \
           [c.assignment for c in r2.evaluated]
    lat = set(space.lattice(spec.asp[0]))
    for c in r1.evaluated:
        assert len(c.assignment) == spec.n_layers
        for pt in c.assignment:
            assert pt in lat
            assert space.is_feasible(pt, n_bits=spec.asp[0].n_bits)
    assert r1.baseline.meta["origin"] == "baseline"
    assert not r1.baseline.sub8
    assert len(r1.evaluated) <= cfg.budget


def test_search_frontier_holds_no_dominated_candidate():
    spec, params, x, score = _tiny()
    r = tune.search(params, spec, score,
                    cfg=tune.TuneConfig(budget=6, seed=1))
    pts = r.frontier.points()
    for c in r.evaluated:
        if c not in pts:
            assert any(pareto._weakly_dominates(p, c) for p in pts)


def test_seed_assignment_follows_sensitivity_tiers():
    """HIGH-sensitivity layer keeps 8 bits, LOW drops grid AND bits."""
    asp = ASPConfig(grid_size=8)
    spec = kan.KANSpec(dims=(8, 6, 8), asp=(asp, asp),
                       layer_names=("enc", "dec"))
    lat = space.lattice(asp)
    seed = tune.seed_assignment(spec, {"enc/coeffs": 10.0,
                                       "dec/coeffs": 0.1}, lat)
    assert seed[0].coeff_bits == 8 and seed[0].grid_size == 8
    assert seed[1].coeff_bits < 8 and seed[1].grid_size <= 4
    for pt in seed:
        assert pt in lat


def test_refit_params_changes_grid_shapes():
    spec, params, x, _ = _tiny()
    pts = (space.OperatingPoint(4, 5, 8), space.OperatingPoint(8, 4, 4))
    new_spec = tune.assignment_spec(spec, pts)
    refit = tune.refit_params(params, spec, new_spec)
    assert refit["enc"]["coeffs"].shape[1] == new_spec.asp[0].n_basis
    assert refit["dec"]["coeffs"].shape == params["dec"]["coeffs"].shape
    assert refit["dec"]["coeffs"] is params["dec"]["coeffs"]
    dep = kan.deploy(refit, new_spec)
    assert kan.apply(dep, x).shape == (16, 8)


def test_sub8_deployed_forward_requant_free(monkeypatch):
    """A mixed sub-8-bit artifact's forward mints no int8 codes from
    floats: ``quant.quantize_coeffs`` raises while it runs (the reference
    pins this through ``kan.trace_requantizes``, which fails on jax
    0.9.0)."""
    spec, params, x, _ = _tiny()
    pts = (space.OperatingPoint(8, 4, 4), space.OperatingPoint(4, 5, 2))
    new_spec = tune.assignment_spec(spec, pts)
    dep = kan.deploy(tune.refit_params(params, spec, new_spec), new_spec)
    for layer, b in zip(dep.layers, (4, 2)):
        assert int(layer.codes.abs().max()) <= 2 ** (b - 1) - 1
    before = kan.apply(dep, x)

    def boom(*a, **k):
        raise AssertionError("quantize_coeffs called during apply")
    monkeypatch.setattr(quant, "quantize_coeffs", boom)
    for backend in ("lut", "fused", "ref"):
        y = kan.apply(dataclasses.replace(dep, spec=new_spec.with_backend(
            backend)), x)
        assert y.shape == (16, 8) and bool(torch.isfinite(y).all())
    assert torch.equal(kan.apply(dep, x), before)
    with pytest.raises(AssertionError, match="quantize_coeffs"):
        kan.deploy(params, spec)                   # the poison is live


def _sens_case(jx):
    """The reference's profiling setup on JAX's weights, in both packages."""
    asp = ASPConfig(grid_size=4)
    tspec = kan.KANSpec(dims=(4, 3, 4), asp=(asp, asp), backend="ref",
                        layer_names=("enc", "dec"))
    jspec = jx.kan.KANSpec(dims=(4, 3, 4), asp=(_jasp(jx, asp),) * 2,
                           backend="ref", layer_names=("enc", "dec"))
    jp = jx.kan.init(jx.jax.random.PRNGKey(0), jspec)
    tp = kan.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    xs = [np.asarray(jx.jax.random.uniform(jx.jax.random.PRNGKey(i), (4, 4),
                                           minval=-1.0, maxval=1.0))
          for i in range(3)]
    return tspec, jspec, tp, jp, xs


def test_layer_sensitivities_accepts_jitted_loss_and_caches_grad(jx):
    """The intent of the reference's case (its jit-tracing count has no
    twin): profiling twice with the same loss gives the same numbers,
    positive, and they equal JAX's within f32 tolerance on shared
    params."""
    tspec, jspec, tp, jp, xs = _sens_case(jx)

    def loss(p, xb):
        return torch.mean(kan.train_apply(p, xb, tspec, qat=True) ** 2)

    def jloss(p, xb):
        return jx.jnp.mean(jx.kan.train_apply(p, xb, jspec, qat=True) ** 2)

    paths = ["enc/coeffs", "dec/coeffs"]
    batches = [(torch.tensor(x),) for x in xs]
    s1 = sensitivity.layer_sensitivities(loss, tp, batches, paths)
    s2 = sensitivity.layer_sensitivities(loss, tp, batches, paths)
    assert s1 == s2 and set(s1) == set(paths)
    want = jx.sens.layer_sensitivities(
        jx.jax.jit(jloss), jp, [(jx.jnp.asarray(x),) for x in xs], paths)
    for p in paths:
        assert s1[p] > 0
        assert s1[p] == pytest.approx(float(want[p]), rel=1e-5, abs=1e-12)


# --- host-side parity --------------------------------------------------------

@pytest.mark.parametrize("n_bits,order", [(6, 2), (6, 3), (8, 2), (8, 3)])
@pytest.mark.parametrize("grids", [(2, 4, 8, 16, 32, 64),
                                   (2, 4, 7, 8, 16, 32, 64)])
def test_lattice_equals_jax(jx, n_bits, order, grids):
    asp = ASPConfig(grid_size=4, order=order, n_bits=n_bits)
    got = space.lattice(asp, grids=grids)
    want = jx.space.lattice(_jasp(jx, asp), grids=grids)
    assert set(_pts(got)) == set(_pts(want)) and _pts(got) == _pts(want)
    for lds in ((1, 3), (2,)):
        assert _pts(space.lattice(asp, grids=grids, lds=lds)) == _pts(
            jx.space.lattice(_jasp(jx, asp), grids=grids, lds=lds))


def _two_layer(jx, base_activation):
    asp = ASPConfig(grid_size=7)
    kw = dict(dims=(40, 12, 40), layer_names=("enc", "dec"),
              base_activation=base_activation)
    return (kan.KANSpec(asp=(asp, asp), **kw),
            jx.kan.KANSpec(asp=(_jasp(jx, asp),) * 2, **kw))


@pytest.mark.parametrize("base_activation", ["relu", ""])
def test_assignment_cost_equals_jax_at_every_lattice_point(jx,
                                                           base_activation):
    tspec, jspec = _two_layer(jx, base_activation)
    lat = space.lattice(tspec.asp[0], grids=(2, 4, 7, 8, 16, 32, 64))
    jlat = jx.space.lattice(jspec.asp[0], grids=(2, 4, 7, 8, 16, 32, 64))
    assert _pts(lat) == _pts(jlat)
    n = len(lat)
    for i in range(n):
        for j in (i, (7 * i + 3) % n):
            got = space.assignment_cost(space.assignment_spec(
                tspec, (lat[i], lat[j])))
            want = jx.space.assignment_cost(jx.space.assignment_spec(
                jspec, (jlat[i], jlat[j])))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                lat[i], lat[j])


def test_seed_assignment_and_snap_equal_jax(jx):
    asp = ASPConfig(grid_size=7)
    grids = (2, 4, 8, 16, 32, 64)           # 7 is off the lattice: snapped
    tspec, jspec = _two_layer(jx, "relu")
    lat = space.lattice(asp, grids=grids)
    jlat = jx.space.lattice(_jasp(jx, asp), grids=grids)
    for sens in ({"enc/coeffs": 10.0, "dec/coeffs": 0.1}, (0.1, 10.0),
                 (1.0, 1.0), {"enc": 3.0, "dec/coeffs": 3.5}):
        got = tsearch.seed_assignment(tspec, sens, lat)
        want = jx.search.seed_assignment(jspec, sens, jlat)
        assert _pts(got) == _pts(want), sens
    for g, ld, b in itertools.product((1, 2, 3, 7, 8, 9, 64, 100),
                                      (0, 1, 3, 5, 7, 9), (2, 3, 4, 8)):
        got = tsearch._snap(space.OperatingPoint(g, ld, b), 8, lat)
        want = jx.search._snap(jx.space.OperatingPoint(g, ld, b), 8, jlat)
        assert _pts([got]) == _pts([want]), (g, ld, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutate_sequence_equals_jax(jx, seed):
    """A chain of 300 mutations from one generator seed: the same proposal
    (or None) at every step, and the generators in the same state after."""
    asp = ASPConfig(grid_size=7)
    grids = (2, 4, 7, 8, 16, 32, 64)
    lat = space.lattice(asp, grids=grids)
    jlat = jx.space.lattice(_jasp(jx, asp), grids=grids)
    trng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    ta = (space.OperatingPoint(7, 5, 8), space.OperatingPoint(7, 5, 8))
    ja = (jx.space.OperatingPoint(7, 5, 8),) * 2
    for step in range(300):
        t = tsearch._mutate(trng, ta, lat, 8)
        j = jx.search._mutate(jrng, ja, jlat, 8)
        assert (t is None) == (j is None), step
        if t is not None:
            assert _pts(t) == _pts(j), step
            ta, ja = t, j
    assert trng.integers(1 << 30) == jrng.integers(1 << 30)


@pytest.mark.parametrize("g_old,g_new", [(7, 2), (7, 4), (7, 8), (7, 64),
                                         (8, 16), (2, 64), (64, 2)])
def test_refit_params_within_the_f32_solve_bound(jx, g_old, g_new):
    """The refit matrix and the refit coefficients against JAX's, at twice
    the f32 solve's forward-error bound (module docstring)."""
    x = torch.linspace(-1 + 1e-4, 1 - 1e-4, 2048, dtype=torch.float64)
    a_new = splines.bspline_basis_uniform(x, -1.0, 1.0, g_new, 3).numpy()
    cond = np.linalg.cond(a_new.T @ a_new + 1e-8 * np.eye(a_new.shape[1]))
    m_t = tge._refit_matrix(g_old, g_new, 3, -1.0, 1.0,
                            torch.device("cpu")).numpy()
    m_j = np.asarray(jx.ge._refit_matrix(g_old, g_new, 3, -1.0, 1.0))
    bar = 2 * cond * EPS_F32 * float(np.abs(m_j).max())
    assert float(np.abs(m_t - m_j).max()) <= bar, (cond, bar)
    asp_o, asp_n = ASPConfig(grid_size=g_old), ASPConfig(grid_size=g_new)
    spec = kan.KANSpec(dims=(6, 5, 6), asp=(asp_o, asp_o),
                       layer_names=("enc", "dec"))
    new_spec = space.assignment_spec(spec, (space.point_of(asp_n),
                                            space.point_of(asp_o)))
    jspec = jx.kan.KANSpec(dims=(6, 5, 6), asp=(_jasp(jx, asp_o),) * 2,
                           layer_names=("enc", "dec"))
    jnew = jx.space.assignment_spec(jspec, (
        jx.space.point_of(_jasp(jx, asp_n)),
        jx.space.point_of(_jasp(jx, asp_o))))
    jp = jx.kan.init(jx.jax.random.PRNGKey(g_old + g_new), jspec)
    tp = kan.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    got = space.refit_params(tp, spec, new_spec)
    want = jx.space.refit_params(jp, jspec, jnew)
    c_old = np.asarray(jp["enc"]["coeffs"])
    mass = float(np.abs(c_old).sum(1).max())
    np.testing.assert_array_less(
        np.abs(got["enc"]["coeffs"].numpy() - np.asarray(
            want["enc"]["coeffs"])), bar * mass + 1e-12)
    assert torch.equal(got["dec"]["coeffs"], tp["dec"]["coeffs"])


# --- whole searches against JAX ----------------------------------------------

def _shared_score(points):
    """A fixed function of the operating points (both packages compute it
    from the same integers): coarser, fewer-bit layers score lower, with
    ties between some assignments, so the frontier's tie-breaks run."""
    s = 0.0
    for i, (g, ld, b) in enumerate(points):
        s += (0.25 * min(g, 16) + 0.5 * ld + b) / (i + 2)
    return round(s, 3) / 100.0


def _quick_score(points):
    return _shared_score(points[::-1]) + 0.001 * sum(p[0] for p in points)


def _spec_points(spec):
    return [(a.grid_size, a.ld, a.coeff_bits) for a in spec.asp]


def _search_both(jx, seed, quick, budget=14):
    tspec, jspec = _two_layer(jx, "relu")
    tspec = tspec.with_backend("lut")
    jspec = dataclasses.replace(jspec, backend="lut")
    jp = jx.kan.init(jx.jax.random.PRNGKey(seed), jspec)
    tp = kan.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    grids = (2, 4, 7, 8, 16, 32, 64)
    sens = {"enc/coeffs": 0.3, "dec/coeffs": 0.1 * (seed + 1)}

    def run(tn, params, spec, cfg_cls):
        score = lambda dep: _shared_score(_spec_points(dep.spec))
        qf = ((lambda dep: _quick_score(_spec_points(dep.spec)))
              if quick else None)
        return tn.search(params, spec, score, sens=sens, quick_fn=qf,
                         cfg=cfg_cls(budget=budget, seed=seed, grids=grids))
    return (run(tune, tp, tspec, tune.TuneConfig),
            run(jx.tune, jp, jspec, jx.tune.TuneConfig))


def _rows(res):
    return [(_pts(c.assignment), c.accuracy, c.area_mm2, c.power_w,
             c.latency_ns, c.meta) for c in res]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quick", [False, True])
def test_search_with_a_shared_score_equals_jax(jx, seed, quick):
    got, want = _search_both(jx, seed, quick)
    assert len(got.evaluated) == len(want.evaluated) > 2
    assert _rows(got.evaluated) == _rows(want.evaluated)
    assert _rows(got.frontier.points()) == _rows(want.frontier.points())
    assert _rows([got.baseline]) == _rows([want.baseline])
    assert got.history == want.history
    best, jbest = got.best_sub8(), want.best_sub8()
    assert (best is None) == (jbest is None)
    if best is not None:
        assert _rows([best]) == _rows([jbest])


def _jtiny(jx):
    """The reference's ``_tiny`` in both packages, on JAX's weights and
    input."""
    asp = ASPConfig(grid_size=8)
    kw = dict(dims=(8, 6, 8), backend="lut", layer_names=("enc", "dec"))
    jspec = jx.kan.KANSpec(asp=(_jasp(jx, asp),) * 2, **kw)
    tspec = kan.KANSpec(asp=(asp, asp), **kw)
    jp = jx.kan.init(jx.jax.random.PRNGKey(0), jspec)
    jxin = jx.jax.random.uniform(jx.jax.random.PRNGKey(1), (16, 8),
                                 minval=-1.0, maxval=1.0)
    jref = jx.kan.train_apply(jp, jxin, jspec)
    tp = kan.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    txin = torch.from_numpy(np.asarray(jxin))
    tref = kan.train_apply(tp, txin, tspec)

    outs = {"port": {}, "jax": {}}     # each candidate's deployed forward

    def jscore(dep):
        y = jx.kan.apply(dep, jxin)
        outs["jax"][tuple(_spec_points(dep.spec))] = np.asarray(y)
        return -float(jx.jnp.mean((y - jref) ** 2))

    def tscore(dep):
        y = kan.apply(dep, txin)
        outs["port"][tuple(_spec_points(dep.spec))] = y.numpy()
        return -float(torch.mean((y - tref) ** 2))
    return (tspec, tp, tscore), (jspec, jp, jscore), outs


@pytest.mark.parametrize("seed", [0, 1])
def test_search_with_the_reference_fidelity_score_matches_jax(jx, seed):
    (tspec, tp, tscore), (jspec, jp, jscore), outs = _jtiny(jx)
    cfg = dict(budget=6, proposals_per_round=4, seed=seed)
    got = tune.search(tp, tspec, tscore, cfg=tune.TuneConfig(**cfg))
    want = jx.tune.search(jp, jspec, jscore, cfg=jx.tune.TuneConfig(**cfg))
    assert [_pts(c.assignment) for c in got.evaluated] == [
        _pts(c.assignment) for c in want.evaluated]
    assert [_pts(c.assignment) for c in got.frontier.points()] == [
        _pts(c.assignment) for c in want.frontier.points()]
    assert set(outs["port"]) == set(outs["jax"])
    for key, y in outs["port"].items():       # the deployed forwards
        np.testing.assert_allclose(y, outs["jax"][key], atol=FWD_ATOL,
                                   rtol=1e-5, err_msg=str(key))
    for g, w in zip(got.evaluated, want.evaluated):
        bar = 2 * np.sqrt(abs(w.accuracy)) * FWD_ATOL + FWD_ATOL ** 2
        assert abs(g.accuracy - w.accuracy) <= bar, (g.assignment, bar)
        assert (g.area_mm2, g.power_w, g.latency_ns) == (
            w.area_mm2, w.power_w, w.latency_ns)
    assert [h["round"] for h in got.history] == [
        h["round"] for h in want.history]


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("g,ld,bits", [(2, 7, 2), (64, 2, 4), (16, 4, 8),
                                       (7, 5, 4), (4, 6, 2)])
def test_fused_on_the_card_at_tuner_points(cuda, g, ld, bits):
    """A layer deployed at an operating point of the tuner's lattice (G
    from 2 to 64, L from 4 to 128, 2-, 4- and 8-bit codes) through
    ``kan_fused`` on the card, against ``lut`` on the CPU from the same
    artifact and inputs (inputs in the knot range, unbounded, so both
    devices quantise them alike), at ``test_kernels.py``'s ``atol 2e-5,
    rtol 1e-5``."""
    asp = space.apply_point(ASPConfig(grid_size=7),
                            space.OperatingPoint(g, ld, bits))
    spec = kan.KANSpec.single(300, 40, asp, backend="lut", bound_input=False)
    dep = kan.deploy(kan.init(g + ld, spec, device="cpu"), spec)
    gen = torch.Generator().manual_seed(bits)
    x = 1.98 * torch.rand((70, 300), generator=gen) - 0.99
    want = kan.apply(dep, x)
    card = dataclasses.replace(
        dep, spec=spec.with_backend("fused"),
        layers=tuple(dataclasses.replace(
            layer, codes=layer.codes.to(cuda), scale=layer.scale.to(cuda),
            hemi=layer.hemi.to(cuda), w_base=layer.w_base.to(cuda))
            for layer in dep.layers))
    got = kan.apply(card, x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-5)
