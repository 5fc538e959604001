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

from typing import Dict, List

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
    its limit, every user off too)."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.worst = {name: 0.0 for name in PER_USER}
        self.users = self.off = self.over = self.over_off = 0

    def add(self, rows: Dict[str, torch.Tensor]) -> None:
        over = torch.zeros_like(rows["bad_ids"], dtype=torch.bool)
        for name in PER_USER:
            self.worst[name] = max(self.worst[name], float(rows[name].max()))
            over |= rows[name] > self.limits[name]
        off = rows["score_gap"] > OFF
        self.users += int(rows["bad_ids"].numel())
        self.off += int(off.sum())
        self.over += int(over.sum())
        self.over_off += int((over & off).sum())

    @property
    def values(self) -> Dict[str, float]:
        return {**self.worst, "off_share": self.off / max(self.users, 1)}

    @property
    def failed(self) -> int:
        """Users past a per-user limit, and, where ``off_share`` passes its
        limit, every user off besides."""
        off_failed = self.values["off_share"] > self.limits["off_share"]
        return self.over + (self.off - self.over_off if off_failed else 0)

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


# --- LM cells -------------------------------------------------------------
#
# For each checked request the reference runs teacher-forced over its prompt
# and the engine's output tokens; at each output step it gives float32
# logits, and the engine's token there is judged by them:
#
# * ``token_gap``: the worst, over the checked steps, of (the reference's
#   top logit - its logit of the engine's token) / the std of the
#   reference's logits at that step (0 where the engine took the top-1);
# * ``lead_miss_share``: of the checked steps whose reference top-1 leads
#   its top-2 by more than ``LEAD`` (in that std), the share where the
#   engine emitted another token;
# * ``incomplete``: requests not finished with their ``max_new`` tokens,
#   with ids out of the vocabulary, or never finished (exact: limit 0).
#
# Random weights make many steps near-ties, where any rounding may pick
# either token; the gap in units of the step's spread says how far from
# the reference's choice a token lies whatever the logits' scale.

LM_NUMBERS = ("token_gap", "lead_miss_share", "incomplete")
#: a reference lead (top-1 - top-2, in logit std) that a sound run's
#: rounding does not reverse: no bf16 run missed one in 13 seeds (~61,000
#: steps), where 8-11% of the steps past 0.1 were missed (PERF.md §2)
LEAD = 0.5


def compare_lm(ref: torch.Tensor, tokens: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """Per step of one request: ``gap`` and ``lead`` (in the step's logit
    std) and ``miss`` (the engine's token is not the reference's top-1).

    ref: [n, V] reference logits predicting the n output tokens; tokens:
    the engine's [n] ids, each inside the vocabulary."""
    ref = ref.to(torch.float64)
    std = ref.std(dim=1).clamp(min=1e-30)
    top2 = torch.topk(ref, 2, dim=1).values
    tok = tokens.to(ref.device, torch.int64)
    chosen = ref.gather(1, tok[:, None])[:, 0]
    return {"gap": (top2[:, 0] - chosen) / std,
            "lead": (top2[:, 0] - top2[:, 1]) / std,
            "miss": chosen < top2[:, 0]}


class LMTally:
    """The worst gap over every checked step, the share of clear steps
    missed, and the requests that did not complete as asked."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.worst = 0.0
        self.steps = self.over = self.incomplete = 0
        self.leads: List[float] = []            # each step's lead
        self.missed_leads: List[float] = []     # the lead of each miss

    def add(self, steps: Dict[str, torch.Tensor]) -> None:
        self.worst = max(self.worst, float(steps["gap"].max()))
        self.leads += steps["lead"].tolist()
        self.missed_leads += steps["lead"][steps["miss"]].tolist()
        self.steps += int(steps["gap"].numel())
        self.over += int(bool((steps["gap"] > self.limits["token_gap"])
                              .any()))

    def add_incomplete(self, n: int) -> None:
        self.incomplete += n

    def share_past(self, margin: float) -> float:
        """The share of the steps whose lead passes ``margin`` that were
        missed: ``lead_miss_share`` at ``LEAD``, and at other margins the
        readings that set it."""
        clear = sum(1 for v in self.leads if v > margin)
        return sum(1 for v in self.missed_leads if v > margin) / max(clear,
                                                                      1)

    @property
    def values(self) -> Dict[str, float]:
        return {"token_gap": self.worst,
                "lead_miss_share": self.share_past(LEAD),
                "incomplete": float(self.incomplete)}

    @property
    def failed(self) -> int:
        """Checked requests with a step past ``token_gap``'s limit, and
        requests incomplete."""
        return self.over + self.incomplete

    @property
    def correct(self) -> bool:
        v = self.values
        return self.steps > 0 and all(v[name] <= self.limits[name]
                                      for name in LM_NUMBERS)

    def lines(self) -> Dict[str, Dict[str, float]]:
        v = self.values
        return {name: {"value": v[name], "limit": self.limits[name]}
                for name in LM_NUMBERS}
