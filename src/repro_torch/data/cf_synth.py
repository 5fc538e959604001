"""Synthetic recommendation dataset (Anime-like) for CF-KAN experiments
(a line-for-line numpy copy of ``repro.data.cf_synth``: the same seed gives
the same data in both packages).

The paper's Anime dataset is not shipped, so it is replaced by a
deterministic latent-factor generator with popularity skew: interactions are
sampled from p(item | user) ∝ softmax(U_u · V_i / τ + b_i), with Zipf-like
item popularity bias b. This matches the properties KAN-SAM exploits
(non-uniform activation distributions over the input domain).

Protocol (Mult-VAE / CF-KAN standard): per user, a random 80% of interactions
form the observed input vector and 20% are held out for Recall/NDCG.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CFDataset:
    observed: np.ndarray   # [n_users, n_items] float32 0/1 (model input)
    held_out: np.ndarray   # [n_users, n_items] float32 0/1 (eval targets)

    @property
    def n_users(self) -> int:
        return self.observed.shape[0]

    @property
    def n_items(self) -> int:
        return self.observed.shape[1]


def generate(n_users: int = 512, n_items: int = 256, latent: int = 16,
             interactions_per_user: int = 40, tau: float = 0.7,
             popularity_skew: float = 1.2, seed: int = 0) -> CFDataset:
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_users, latent)).astype(np.float32)
    v = rng.normal(size=(n_items, latent)).astype(np.float32)
    b = -popularity_skew * np.log(np.arange(1, n_items + 1, dtype=np.float32))
    b = b[rng.permutation(n_items)]
    logits = u @ v.T / tau + b[None, :]
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(axis=1, keepdims=True)

    observed = np.zeros((n_users, n_items), dtype=np.float32)
    held = np.zeros((n_users, n_items), dtype=np.float32)
    for i in range(n_users):
        items = rng.choice(n_items, size=min(interactions_per_user, n_items),
                           replace=False, p=p[i])
        n_held = max(1, len(items) // 5)
        held_items = items[:n_held]
        obs_items = items[n_held:]
        observed[i, obs_items] = 1.0
        held[i, held_items] = 1.0
    return CFDataset(observed=observed, held_out=held)


def split(ds: CFDataset, train_frac: float = 0.8
          ) -> Tuple[CFDataset, CFDataset]:
    n_train = int(ds.n_users * train_frac)
    return (CFDataset(ds.observed[:n_train], ds.held_out[:n_train]),
            CFDataset(ds.observed[n_train:], ds.held_out[n_train:]))


def batches(ds: CFDataset, batch_size: int, seed: int = 0,
            shuffle: bool = True) -> Iterator[np.ndarray]:
    idx = np.arange(ds.n_users)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        yield ds.observed[idx[i:i + batch_size]]
