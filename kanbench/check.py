"""What decides ``correct``: the scores and top-k ids that the timed path
produced for a checked batch, against the plain reference's scores of the
same users.

Three numbers, each the worst over the checked users:

* ``score_gap``: the largest |program score - reference score| of a user,
  over the largest |reference score| of that user.
* ``rank_gap``: for each served id, how far its reference score lies below
  the reference's k-th best unobserved score (0 inside the reference's top
  k), over the same norm.
* ``bad_ids``: served ids out of range, repeated within a user, or of items
  the user has already seen (exact: its limit is 0).

and one over all of them:

* ``off_share``: the share of checked users whose ``score_gap`` passes
  ``OFF``. A sound run is off the float64 reference by f32 rounding (under
  5e-7) save for the few users with a hidden input within rounding of a
  code boundary, whose gap is then a tap step; a contraction that rounds
  every tap (bf16 taps: ~1e-3) puts every user off.
"""
from __future__ import annotations

from typing import Dict

import torch

PER_USER = ("score_gap", "rank_gap", "bad_ids")
NUMBERS = PER_USER + ("off_share",)
# a user's score_gap past this is more than f32 rounding
OFF = 1e-5


def compare(ref: torch.Tensor, scores: torch.Tensor, ids: torch.Tensor,
            observed: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Per user of one batch: each number of ``PER_USER`` [B] (float64).

    ref: [B, N] float64 reference scores; scores: the program's [B, N];
    ids: the program's [B, k] ids (any device); observed: [B, N] 0/1."""
    b, n = ref.shape
    dev = ref.device
    if tuple(scores.shape) != (b, n) or tuple(ids.shape) != (b, k):
        inf = torch.full((b,), float("inf"), dtype=torch.float64, device=dev)
        return {"score_gap": inf, "rank_gap": inf,
                "bad_ids": torch.full((b,), float(k), dtype=torch.float64,
                                      device=dev)}
    norm = ref.abs().amax(dim=1).clamp(min=1e-30)
    score_gap = (scores.to(dev, torch.float64) - ref).abs().amax(dim=1) / norm
    ids = ids.to(dev, torch.int64)
    inside = (ids >= 0) & (ids < n)
    safe = ids.clamp(0, n - 1)
    seen = observed.gather(1, safe) > 0
    ordered = torch.sort(safe, dim=1).values
    repeated = torch.zeros_like(inside)
    repeated[:, 1:] = ordered[:, 1:] == ordered[:, :-1]
    bad = (~inside | seen).sum(dim=1) + repeated.sum(dim=1)
    masked = torch.where(observed > 0, -torch.inf, ref)
    kth = torch.topk(masked, k, dim=1).values[:, -1]
    below = torch.where(inside & ~seen, kth[:, None] - ref.gather(1, safe),
                        0.0).clamp(min=0.0)
    return {"score_gap": score_gap,
            "rank_gap": below.amax(dim=1) / norm,
            "bad_ids": bad.to(torch.float64)}


class Tally:
    """The worst of each per-user number over every checked user, the share
    of them off, and how many users broke a limit (with ``off_share`` over
    its limit, every user off)."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.worst = {name: 0.0 for name in PER_USER}
        self.users = self.off = self.over = 0

    def add(self, rows: Dict[str, torch.Tensor]) -> None:
        over = torch.zeros_like(rows["bad_ids"], dtype=torch.bool)
        for name in PER_USER:
            self.worst[name] = max(self.worst[name], float(rows[name].max()))
            over |= rows[name] > self.limits[name]
        off = rows["score_gap"] > OFF
        self.users += int(rows["bad_ids"].numel())
        self.off += int(off.sum())
        self.over += int((over | off).sum()) - int(off.sum())

    @property
    def values(self) -> Dict[str, float]:
        return {**self.worst, "off_share": self.off / max(self.users, 1)}

    @property
    def failed(self) -> int:
        off_failed = self.values["off_share"] > self.limits["off_share"]
        return self.over + (self.off if off_failed else 0)

    @property
    def correct(self) -> bool:
        v = self.values
        return self.users > 0 and all(v[name] <= self.limits[name]
                                      for name in NUMBERS)

    def lines(self) -> Dict[str, Dict[str, float]]:
        """Each number beside its limit, for the result's last key."""
        v = self.values
        return {name: {"value": v[name], "limit": self.limits[name]}
                for name in NUMBERS}
