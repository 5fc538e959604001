"""The one generator of the LM cells' traffic: an endless stream of
requests (prompt token ids and an output budget) read from a traffic
file's parameters and the seed.

Prompt and output lengths are log-normal (``median``, ``sigma``), clipped
to ``[min, max]``. So that every seed serves the same work in another
order, the stream comes in blocks of ``block`` requests whose lengths are
the same stratified quantiles of each law (the ``(i + 0.5) / block``
quantiles), paired and ordered by a permutation drawn from the seed for
each block. Token ids are uniform over the vocabulary, drawn from the
seed: no two prompts share a prefix.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterator, List, Tuple

import numpy as np


def quantile_lengths(law: Dict, n: int) -> List[int]:
    """The ``(i + 0.5) / n`` quantiles of the clipped log-normal ``law``
    (``median``, ``sigma``, ``min``, ``max``), rounded to whole tokens."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        v = law["median"] * np.exp(law["sigma"] * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(v), law["min"]), law["max"])))
    return out


def stream(traffic: Dict, vocab: int, seed: int
           ) -> Iterator[Tuple[np.ndarray, int]]:
    """Requests ``(prompt ids [s] int64, max_new)`` without end."""
    rng = np.random.default_rng(seed)
    n = traffic["block"]
    prompts = np.array(quantile_lengths(traffic["prompt"], n))
    outputs = np.array(quantile_lengths(traffic["output"], n))
    while True:
        for s, m in zip(prompts[rng.permutation(n)],
                        outputs[rng.permutation(n)]):
            yield rng.integers(0, vocab, size=int(s), dtype=np.int64), int(m)
