"""The benchmark's inputs, made on the device from the seed: the model's
float weights, and the one generator of its traffic, a pool of distinct
users' interaction vectors.

It is the latent-factor model of the program's synthetic recommendation
data (``data/cf_synth.py``) with that generator's defaults, rewritten in
torch so that a pool of tens of thousands of users over 16384 items takes
well under a second on the card: user and item factors ~ N(0, 1) of width
``LATENT``; item popularity ``-POPULARITY_SKEW * log(rank)`` over a random
ranking; a user's items are drawn without replacement with p(item) ∝
softmax(U·V / TAU + popularity), by the Gumbel top-k trick. Every user
has cf_synth's 40 interactions, of which the model sees the 80% that
cf_synth keeps as observed: ``OBSERVED`` ones in each input vector, for
every seed.
"""
from __future__ import annotations

from typing import Dict

import torch

# data/cf_synth.generate's defaults
LATENT = 16
TAU = 0.7
POPULARITY_SKEW = 1.2
OBSERVED = 32           # 40 interactions less the 20% held out
# users whose scores are drawn in one block (bounds the memory of set-up)
_BLOCK = 2048


def make_params(model: Dict, gen: torch.Generator) -> Dict:
    """CF-KAN's float weights ``{"enc": {"coeffs", "w_base"}, "dec": ...}``
    in f32 on the generator's device, as the program initialises a KAN
    layer: coefficients ~ N(0, 0.01 / I) of shape [I, G+K, O], base weights
    ~ N(0, 1 / I) of shape [I, O]."""
    dev = gen.device
    dims = (model["n_items"], model["hidden"], model["n_items"])
    params = {}
    for i, name in enumerate(("enc", "dec")):
        n_in, n_out = dims[i], dims[i + 1]
        n_basis = model[f"grid_size_{name}"] + model["order"]
        coeffs = torch.randn((n_in, n_basis, n_out), generator=gen,
                             device=dev) * (0.1 / n_in ** 0.5)
        w_base = torch.randn((n_in, n_out), generator=gen,
                             device=dev) / n_in ** 0.5
        params[name] = {"coeffs": coeffs, "w_base": w_base}
    return params


def make_pool(n_users: int, n_items: int, gen: torch.Generator
              ) -> torch.Tensor:
    """[n_users, n_items] float32 0/1 interaction vectors with ``OBSERVED``
    ones each, on the generator's device."""
    dev = gen.device
    v = torch.randn((n_items, LATENT), generator=gen, device=dev)
    pop = -POPULARITY_SKEW * torch.log(
        torch.arange(1, n_items + 1, dtype=torch.float32, device=dev))
    pop = pop[torch.randperm(n_items, generator=gen, device=dev)]
    pool = torch.zeros((n_users, n_items), dtype=torch.float32, device=dev)
    for s in range(0, n_users, _BLOCK):
        n = min(_BLOCK, n_users - s)
        u = torch.randn((n, LATENT), generator=gen, device=dev)
        logits = (u @ v.T) / TAU + pop
        unif = torch.rand((n, n_items), generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(unif.clamp(1e-20, 1.0 - 1e-7)))
        items = torch.topk(logits + gumbel, OBSERVED, dim=1).indices
        pool[s:s + n].scatter_(1, items, 1.0)
    return pool
