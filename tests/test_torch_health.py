"""Port parity for chip-health telemetry (``repro_torch.hw.health``) and the
temporal drift model it reads (``repro_torch.hw.variation``).

* ``tests/test_health.py``'s cases run against the port.
* ``canary_readout`` gives the reference's int codes and saturation
  counts exactly, without a gain and with the same gain array.
* Probes under drift or variation draw their gains from the port's
  splitmix64-seeded generators, not the reference's threefry, so they are
  held to the reference by statistics: zero deviation on an ideal chip,
  growth with age, determinism per seed, the mean deviation over seeds at
  a few ages within 5% of the reference's, and the tick at which the
  launcher's drift (rate 0.05, tau 4, polled every 2 ticks) crosses the
  0.05 threshold within one poll of the reference's, seed by seed.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.hw import health as th  # noqa: E402
from repro_torch.hw import tiles as ttiles  # noqa: E402
from repro_torch.hw import variation as tvar  # noqa: E402
from repro_torch.hw.health import (ChipHealth, ProbeGeometry,  # noqa: E402
                                   canary_readout)
from repro_torch.hw.tiles import TileConfig  # noqa: E402
from repro_torch.hw.variation import (DriftConfig,  # noqa: E402
                                      VariationConfig, drift_gain)
from repro_torch.obs import MetricsRegistry  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

TILE = TileConfig(array_size=64, tile_cols=16)
SHAPE = (8, 4)
POLL = 2                 # the launcher's --health-poll
THRESHOLD = 0.05         # its --health-threshold


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.hw import health, tiles, variation
    return types.SimpleNamespace(health=health, tiles=tiles,
                                 var=variation)


def _g(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- drift model -------------------------------------------------------------

def test_drift_gain_identity_when_off_or_fresh():
    on = DriftConfig(rate=0.05, seed=3)
    assert np.allclose(_g(drift_gain(on, 0.0, 0, 0, 0, SHAPE)), 1.0)
    off = DriftConfig(rate=0.0)
    assert np.array_equal(_g(drift_gain(off, 100.0, 0, 0, 0, SHAPE)),
                          np.ones(SHAPE))


def test_drift_gain_deterministic_and_keyed():
    cfg = DriftConfig(rate=0.05, seed=7)
    a = _g(drift_gain(cfg, 10.0, 2, 1, 0, SHAPE))
    assert np.array_equal(a, _g(drift_gain(cfg, 10.0, 2, 1, 0, SHAPE)))
    assert not np.array_equal(a, _g(drift_gain(cfg, 10.0, 2, 0, 0, SHAPE)))
    assert not np.array_equal(a, _g(drift_gain(cfg.with_seed(8), 10.0, 2, 1,
                                               0, SHAPE)))


def test_drift_gain_power_law_shape():
    cfg = DriftConfig(rate=0.05, dispersion=0.5, tau=4.0, seed=1)
    means = [float(np.mean(_g(drift_gain(cfg, a, 0, 0, 0, SHAPE))))
             for a in (1.0, 4.0, 16.0, 64.0)]
    assert all(m2 < m1 for m1, m2 in zip(means, means[1:]))
    assert all(0.0 < m < 1.0 for m in means)
    g = _g(drift_gain(cfg, 64.0, 0, 0, 0, (64, 64)))
    assert np.mean(g < 1.0) > 0.9
    assert np.any(g > 1.0)


# --- canary readout ----------------------------------------------------------

def test_canary_readout_ideal_is_uniform_and_unsaturated():
    codes, sat = canary_readout(TILE, None, headroom=0.7)
    assert codes.shape == (TILE.tile_cols,) and sat == 0
    assert len(set(codes.tolist())) == 1 and codes[0] > 0


def test_canary_readout_saturates_past_full_scale():
    _, sat = canary_readout(TILE, None, headroom=1.5)
    assert sat == 8 * TILE.tile_cols
    hot = np.full((TILE.array_size, TILE.tile_cols), 1.6)
    _, sat = canary_readout(TILE, hot, headroom=0.7)
    assert sat == 8 * TILE.tile_cols


def test_canary_readout_sees_conductance_loss():
    faded = np.full((TILE.array_size, TILE.tile_cols), 0.8)
    ideal, _ = canary_readout(TILE, None, headroom=0.7)
    codes, sat = canary_readout(TILE, faded, headroom=0.7)
    assert sat == 0 and np.all(codes < ideal)
    rel = float(np.abs(codes - ideal).mean() / np.abs(ideal).mean())
    assert rel == pytest.approx(0.2, rel=0.05)


@pytest.mark.parametrize("geom", [(64, 16), (128, 32), (256, 64)])
@pytest.mark.parametrize("headroom", [0.7, 1.0, 1.5])
@pytest.mark.parametrize("gain", ["none", "faded", "random"])
def test_canary_readout_equals_the_reference(jx, geom, headroom, gain):
    """Codes and saturation counts bit for bit, with no gain and with one
    gain array given to both."""
    jt = jx.tiles.TileConfig(array_size=geom[0], tile_cols=geom[1])
    tt = TileConfig(array_size=geom[0], tile_cols=geom[1])
    g = {"none": None, "faded": np.full(geom, 0.8),
         "random": np.random.default_rng(sum(geom)).uniform(0.5, 1.7,
                                                            geom)}[gain]
    want = jx.health.canary_readout(jt, g, headroom)
    got = canary_readout(tt, g, headroom)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[0].dtype == want[0].dtype


# --- ChipHealth probes -------------------------------------------------------

def _chip(**kw):
    kw.setdefault("tile", TILE)
    kw.setdefault("geometry", ProbeGeometry(layer_uids=(0, 1),
                                            tiles_per_layer=2))
    return ChipHealth(**kw)


def test_probe_ideal_chip_reads_zero_deviation():
    hp = _chip()
    out = hp.probe(age=100.0)
    assert out["max_rel_dev"] == 0.0 and out["adc_saturation"] == 0
    assert {(t["layer"], t["tile"]) for t in out["tiles"]} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}
    assert hp.last is out


def test_probe_deviation_grows_with_age_and_is_deterministic():
    def fresh():
        return _chip(drift=DriftConfig(rate=0.05, tau=4.0, seed=0))

    hp = fresh()
    assert hp.probe(0.0)["max_rel_dev"] == 0.0
    devs = [hp.probe(a)["max_rel_dev"] for a in (2.0, 8.0, 32.0)]
    assert devs[0] > 0.0 and devs == sorted(devs)
    assert fresh().probe(32.0)["max_rel_dev"] == devs[-1]


def test_probe_static_variation_differs_per_tile():
    out = _chip(variation=VariationConfig(sigma=0.1, seed=2)).probe(0.0)
    assert out["max_rel_dev"] > 0.0
    assert len({t["rel_dev"] for t in out["tiles"]}) > 1


def test_probe_counts_saturation_cumulatively():
    hp = _chip(headroom=1.5, geometry=ProbeGeometry())
    per_probe = 8 * TILE.tile_cols
    assert hp.probe(0.0)["adc_saturation"] == per_probe
    out = hp.probe(1.0)
    assert out["adc_saturation"] == per_probe
    assert out["adc_saturation_total"] == 2 * per_probe


def test_probe_publishes_gauges_with_labels():
    reg = MetricsRegistry()
    hp = _chip(drift=DriftConfig(rate=0.05, tau=4.0, seed=0),
               registry=reg, labels={"replica": "1"})
    out = hp.probe(8.0)
    snap = reg.snapshot()["metrics"]
    key = 'chip_canary_rel_dev{layer="0",replica="1",tile="0"}'
    t00 = next(t for t in out["tiles"]
               if t["layer"] == 0 and t["tile"] == 0)
    assert snap[key]["value"] == pytest.approx(t00["rel_dev"])
    assert 'chip_adc_saturation{layer="1",replica="1",tile="1"}' in snap
    assert 'chip_adc_saturation_total{layer="0",replica="1",tile="0"}' \
        in snap


def test_probe_gains_come_from_the_ports_draws():
    """The static and drift gains a probe applies are ``tile_gain`` and
    ``drift_gain`` of (layer, row tile, column tile 0), in float64."""
    var = VariationConfig(sigma=0.1, seed=4)
    drift = DriftConfig(rate=0.05, tau=4.0, seed=4)
    hp = _chip(variation=var, drift=drift)
    shape = (TILE.array_size, TILE.tile_cols)
    for uid, tr in ((0, 0), (1, 1)):
        want = (tvar.tile_gain(var, uid, tr, 0, shape).double()
                * tvar.drift_gain(drift, 6.0, uid, tr, 0, shape).double())
        got = hp._tile_gain_at(uid, tr, 6.0)
        assert got.dtype == np.float64
        assert np.array_equal(got, want.numpy())
    assert th.canary_readout is canary_readout
    assert ttiles.slot_attenuation(4, TILE, "cpu").dtype == torch.float32


# --- drift against the reference, by statistics ------------------------------

def _devs(mod, tile, var_mod, seed, ages, sigma=0.0):
    hp = mod.ChipHealth(
        tile=tile, geometry=mod.ProbeGeometry(layer_uids=(0, 1),
                                              tiles_per_layer=2),
        variation=var_mod.VariationConfig(sigma=sigma, seed=seed),
        drift=var_mod.DriftConfig(rate=0.05, tau=4.0, seed=seed))
    return [hp.probe(float(a))["max_rel_dev"] for a in ages]


def test_ideal_chip_reads_zero_like_the_reference(jx):
    jt = jx.tiles.TileConfig(array_size=64, tile_cols=16)
    for mod, tile, var in ((jx.health, jt, jx.var), (th, TILE, tvar)):
        hp = mod.ChipHealth(tile=tile)
        assert hp.probe(50.0)["max_rel_dev"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_threshold_crossing_within_one_poll_of_the_reference(jx, seed):
    """The launcher's drift (rate 0.05, tau 4) polled every 2 ticks crosses
    the 0.05 threshold at a poll within one poll of the reference's; both
    trajectories grow with age."""
    jt = jx.tiles.TileConfig(array_size=64, tile_cols=16)
    ages = list(range(0, 41, POLL))
    want = _devs(jx.health, jt, jx.var, seed, ages)
    got = _devs(th, TILE, tvar, seed, ages)
    for devs in (want, got):
        assert devs[0] == 0.0 and devs == sorted(devs)
    cross_w = next(a for a, d in zip(ages, want) if d > THRESHOLD)
    cross_g = next(a for a, d in zip(ages, got) if d > THRESHOLD)
    assert abs(cross_g - cross_w) <= POLL, (cross_g, cross_w)


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_mean_deviation_over_seeds_matches_the_reference(jx, sigma):
    """Over 8 chip seeds, the mean canary deviation at ages 2, 8 and 32
    (drift, and drift over a static corner) is within 5% of the
    reference's."""
    jt = jx.tiles.TileConfig(array_size=64, tile_cols=16)
    ages = (2, 8, 32)
    want = np.mean([_devs(jx.health, jt, jx.var, s, ages, sigma)
                    for s in range(8)], axis=0)
    got = np.mean([_devs(th, TILE, tvar, s, ages, sigma)
                   for s in range(8)], axis=0)
    np.testing.assert_allclose(got, want, rtol=0.05)
    assert np.all(np.diff(got) > 0)
