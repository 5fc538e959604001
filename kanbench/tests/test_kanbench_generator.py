"""The traffic generator: deterministic by seed, different across seeds,
cf_synth's number of observed items for every user and seed."""
from __future__ import annotations

import json

import torch

from kbtiny import REPO
from kanbench import generator


def _pool(seed, n_users=64, n_items=256):
    gen = torch.Generator().manual_seed(seed)
    return generator.make_pool(n_users, n_items, gen)


def test_same_seed_same_pool_other_seed_other_pool():
    a, b, c = _pool(2 ** 33 + 5), _pool(2 ** 33 + 5), _pool(7)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_every_user_has_the_same_length():
    for seed in (1, 2, 3):
        pool = _pool(seed)
        assert set(pool.unique().tolist()) <= {0.0, 1.0}
        assert torch.equal(pool.sum(dim=1),
                           torch.full((64,), float(generator.OBSERVED)))


def test_params_are_deterministic_and_shaped():
    model = json.loads((REPO / "kanbench" / "configs"
                        / "cf-kan-2.json").read_text())
    model.update(n_items=32, hidden=4)
    p = generator.make_params(model, torch.Generator().manual_seed(3))
    q = generator.make_params(model, torch.Generator().manual_seed(3))
    assert p["enc"]["coeffs"].shape == (32, 18, 4)
    assert p["dec"]["w_base"].shape == (4, 32)
    assert all(torch.equal(p[k][n], q[k][n]) for k in p for n in p[k])
