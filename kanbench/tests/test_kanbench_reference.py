"""The frozen reference in ``kanbench/reference`` against the port's
plain backends at the SMOKE widths on the CPU, and what it imports."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from kbtiny import REPO
from kanbench import generator, system
from kanbench import run as bench
from kanbench.reference import cf_kan as ref_cf_kan

TRAFFIC = {"lut": "score.fused.b2048", "ref": "score.fused.b2048",
           "fused": "score.fused.b2048", "cim": "chipeval.cim.b256",
           "cim_tiled": "chipeval.cim_tiled.b256"}


def _case(backend, config="cf-kan-1", seed=5):
    model = json.loads((REPO / "kanbench" / "configs"
                        / f"{config}.json").read_text())
    model.update(n_items=256, hidden=16)
    t = json.loads((REPO / "kanbench" / "traffic"
                    / f"{TRAFFIC[backend]}.json").read_text())
    gen = torch.Generator().manual_seed(seed)
    params = generator.make_params(model, gen)
    x = generator.make_pool(48, model["n_items"], gen)
    sample = [x[:16], x[16:32]] if t["sam"] else []
    t = dict(t, backend=backend)
    dep = system.deploy(params, model, t, seed, sample)
    got = system.apply(dep, x).to(torch.float64)
    hw = bench.reference_hardware(t, seed)
    ref, _ = ref_cf_kan.forward(ref_cf_kan.build(params, model, hw, sample),
                                hw, x)
    return got, ref


def _gap(got, ref):
    return float(((got - ref).abs().amax(1)
                  / ref.abs().amax(1)).max())


@pytest.mark.parametrize("config", ["cf-kan-1", "cf-kan-2"])
@pytest.mark.parametrize("backend", ["lut", "fused", "cim", "cim_tiled"])
def test_reference_equals_the_ports_quantised_backends(backend, config):
    """The same integer arithmetic on both sides (input codes, coefficient
    codes, every ADC readout): the scores differ by f32 rounding alone."""
    got, ref = _case(backend, config)
    assert _gap(got, ref) < 1e-5


def test_reference_against_the_ports_float_oracle():
    """The port's ``ref`` backend reads the float basis at unquantised
    inputs: it differs from the quantised reference by the input
    quantisation (one code is 2/224 of the knot range), well above f32
    rounding and well below the scores' own size."""
    got, ref = _case("ref")
    assert 1e-4 < _gap(got, ref) < 0.05


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import kanbench.reference.cf_kan, "
            "kanbench.reference.crossbar, kanbench.reference.asp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
