"""Synthetic LM token pipeline (a line-for-line numpy copy of
``repro.data.lm_synth``: the same config and index give the same tokens in
both packages, bit for bit).

Deterministic, restart-safe stream: batch ``i`` depends only on (seed, i).
Tokens follow a Zipf-ish marginal with a first-order Markov structure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2


def _probs(cfg: LMDataConfig) -> np.ndarray:
    p = 1.0 / np.arange(1, cfg.vocab + 1) ** cfg.zipf_a
    return p / p.sum()


def batch_at(cfg: LMDataConfig, index: int) -> Dict[str, np.ndarray]:
    """Deterministic batch #index: {tokens, labels} (labels = next token)."""
    rng = np.random.default_rng((cfg.seed, index))
    p = _probs(cfg)
    base = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len + 1), p=p)
    # Markov-ify: token t+1 correlates with t (signal for the model)
    shift = np.roll(base, 1, axis=1)
    mix = rng.random((cfg.batch, cfg.seq_len + 1)) < 0.5
    toks = np.where(mix, (shift * 31 + 7) % cfg.vocab, base)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def stream(cfg: LMDataConfig, start_index: int = 0
           ) -> Iterator[Dict[str, np.ndarray]]:
    i = start_index
    while True:
        yield batch_at(cfg, i)
        i += 1
