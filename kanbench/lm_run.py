"""One run of an LM cell (a configuration of kind ``lm``): the program's
serving engine under a closed loop of ``sessions`` clients, each sending
its next request as soon as its last one completes.

Set-up makes the weights on the card from the seed (the reference module
that the configuration names makes them, in the program's parameter
tree), builds the engine (``lm_system``) and runs the loop until every
slot has completed a request: every chunk shape of the traffic and the
fused tick have then run (the stream's first block holds every length it
will ever send), and the window does not open on the synchronised prefill
of an empty engine. The window then steps the engine for ``--seconds``:
tokens are counted exactly from the engine's counters at its two ends;
time to first token and time per output token are taken on the host's
clock at the end of each step (the step of a request's first token is its
admission tick plus its prompt's chunks, less one). Requests drawn from
the seed, and the longest, keep their prompt and tokens; once the window
has closed and the engine is freed, the plain reference runs over each
(teacher-forced, weights made again from the seed) and decides
``correct``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import math
import random
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from kanbench import (check, forbidden_modules, lm_system, lm_traffic,
                      resolve, trace)

ROOT = Path(__file__).resolve().parent.parent
FILL_STEPS = 100_000    # a fill that never completes every slot is a fault


@dataclasses.dataclass
class Context:
    """What an LM per-layer reader reads: the trace of the traced steps;
    per traced step the work it did (``chunks``: prefill chunk lengths,
    ``tokens``: output tokens emitted, ``decode``: slots live in its fused
    tick); the engine's counters over the whole window (``engine``, the
    differences of ``lm_system.counters``); the cell's files; the window's
    peak memory."""
    trace: trace.Trace
    counts: List[Dict]
    model: Dict
    traffic: Dict
    window_peak_bytes: int
    engine: Dict[str, int]


@dataclasses.dataclass
class Done:
    """A completed request, on the host's clock."""
    rid: int
    prompt: np.ndarray
    max_new: int
    tokens: np.ndarray
    reason: str
    submitted: float
    first: float            # end of the step of its first token
    finished: float         # end of the step that completed it


def reference_module(model: Dict):
    """The configuration's plain reference (its ``reference`` file, a path
    from the checkout's root)."""
    path = ROOT / model["reference"]
    spec = importlib.util.spec_from_file_location(
        "kanbench_reference_" + path.stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fp8_rounded(tree):
    """Every float leaf rounded to fp8 e4m3 and back, each matrix (each
    layer's, of a stacked leaf) scaled so that its largest magnitude maps
    to e4m3's largest, 448: a per-tensor fp8 deployment of the weights."""
    if isinstance(tree, dict):
        return {k: fp8_rounded(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_rounded(v) for v in tree]
    dims = tuple(range(1, tree.ndim)) if tree.ndim == 3 else None
    amax = (tree.abs().amax(dim=dims, keepdim=True) if dims
            else tree.abs().max()).clamp(min=1e-30)
    scale = 448.0 / amax
    return (tree * scale).to(torch.float8_e4m3fn).to(tree.dtype) / scale


class ClosedLoop:
    """``sessions`` clients on one engine; every step's end on the host's
    clock, every completed request."""

    def __init__(self, eng, requests: Iterator[Tuple[np.ndarray, int]],
                 sessions: int):
        self.eng, self.requests, self.sessions = eng, requests, sessions
        self.step_end: List[float] = []       # by tick
        self.live: Dict[int, Tuple[np.ndarray, int, float, int]] = {}
        self.done: List[Done] = []
        self.rid = 0

    def submit(self) -> None:
        prompt, max_new = next(self.requests)
        self.live[self.rid] = (prompt, max_new, time.perf_counter(),
                               lm_system.tick(self.eng))
        lm_system.submit(self.eng, self.rid, prompt, max_new)
        self.rid += 1

    def start(self) -> None:
        for _ in range(self.sessions):
            self.submit()

    def step(self, spans: bool) -> list:
        rng = (torch.profiler.record_function(trace.ENGINE_STEP) if spans
               else contextlib.nullcontext())
        with rng:
            comps = lm_system.step(self.eng)
        t = time.perf_counter()
        self.step_end.append(t)
        for c in comps:
            prompt, max_new, sub, _ = self.live.pop(c.rid)
            first = c.admitted_tick + lm_system.chunks(self.eng,
                                                       len(prompt)) - 1
            self.done.append(Done(c.rid, prompt, max_new,
                                  np.asarray(c.tokens), c.reason, sub,
                                  self.step_end[first], t))
            self.submit()
        return comps

    def fill(self) -> None:
        """Step until every slot has completed a request."""
        slots = set()
        for _ in range(FILL_STEPS):
            slots.update(c.slot for c in self.step(False))
            if len(slots) == self.eng.n_slots:
                return
        raise RuntimeError(f"after {FILL_STEPS} steps only {len(slots)} "
                           f"of {self.eng.n_slots} slots completed")

    def stuck(self) -> int:
        """Requests outstanding for longer than a request admitted at once
        takes: their prefill chunks and their budget (the loop keeps a
        slot free for every session, so nothing waits to be admitted)."""
        now = lm_system.tick(self.eng)
        return sum(1 for prompt, m, _, at in self.live.values()
                   if now - at > lm_system.chunks(self.eng, len(prompt)) + m)


def _sample(window: List[Done], seed: int, every: int) -> List[Done]:
    """Every ``every``-th completed request from an offset drawn from the
    seed, and the one with the most output tokens."""
    off = random.Random(seed).randrange(every)
    picked = [d for i, d in enumerate(window) if (i + off) % every == 0]
    if window:
        longest = max(window, key=lambda d: (len(d.tokens), len(d.prompt)))
        if all(d is not longest for d in picked):
            picked.append(longest)
    return picked


def run(cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t0: Optional[float] = None,
        control: Optional[str] = None, root: Path = ROOT,
        check_every: Optional[int] = None,
        t_imported: Optional[float] = None) -> Dict:
    """One run of the LM ``cell``; returns the result line's object.
    ``control="fp8"`` serves the weights rounded to fp8 e4m3 (one
    precision below the configuration's bf16) and holds the tokens to the
    reference on the weights as made. ``check_every`` replaces the
    traffic's."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = [("start", t0)] + ([("import", t_imported)]
                                 if t_imported and t0 < t_imported else [])
    t, model = cell.traffic, cell.model
    cuda = device == "cuda"
    ref = reference_module(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = ref.make_weights(model, gen)
    if control == "fp8":
        weights = fp8_rounded(weights)
    elif control is not None:
        raise ValueError(f"no LM control {control!r}")
    if cuda:
        torch.cuda.synchronize()
    phases.append(("weights", time.perf_counter()))
    eng = lm_system.engine(weights, model, t, device)
    del weights
    loop = ClosedLoop(eng, lm_traffic.stream(t, model["vocab"], seed),
                      t["sessions"])
    loop.start()
    loop.fill()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts):        # the tracer's own set-up
            loop.step(True)
        prof = profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("engine and fill", time.perf_counter()))
    setup_s = phases[-1][1] - t0

    lead, n_traced = t["trace_lead"], t["trace_steps"]
    counts: List[Dict] = []
    gc.collect()
    gc.freeze()
    before = lm_system.counters(eng)
    n_done = len(loop.done)
    start = time.perf_counter()
    j = 0
    while (time.perf_counter() - start < seconds
           or (traced and j < lead + n_traced)):
        tracing = traced and lead <= j < lead + n_traced
        if tracing:
            if j == lead:
                prof.start()
            pos, c0 = (lm_system.prefill_positions(eng),
                       lm_system.counters(eng))
        loop.step(tracing)
        if tracing:
            c1 = lm_system.counters(eng)
            counts.append({
                "chunks": lm_system.chunk_lengths(
                    pos, lm_system.prefill_positions(eng)),
                "tokens": (c1["decode_tokens"] - c0["decode_tokens"]
                           + c1["prefills"] - c0["prefills"]),
                "decode": c1["decode_tokens"] - c0["decode_tokens"]})
            if j == lead + n_traced - 1:
                prof.stop()
        j += 1
    end = loop.step_end[-1]
    window_s = end - start
    gc.unfreeze()
    after = lm_system.counters(eng)
    stats = {k: after[k] - before[k] for k in after}
    stats["n_slots"] = after["n_slots"]
    window = loop.done[n_done:]
    stuck = loop.stuck()

    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak) if cuda else 0
    loaded = forbidden_modules()
    trc = (trace.read(prof, trace.ENGINE_STEP, ()) if traced else None)
    del eng, loop.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    tally = check.LMTally(cell.limits)
    vocab = model["vocab"]
    tally.add_incomplete(stuck + sum(
        1 for d in window
        if d.reason != "length" or len(d.tokens) != d.max_new
        or d.tokens.min() < 0 or d.tokens.max() >= vocab))
    checked = _sample(window, seed, check_every or t["check_every"])
    weights = ref.make_weights(model, torch.Generator(
        device=device).manual_seed(seed))
    for d in checked:
        toks = d.tokens
        if len(toks) == 0 or toks.min() < 0 or toks.max() >= vocab:
            continue
        seq = torch.from_numpy(np.concatenate([d.prompt, toks[:-1]])
                               ).to(device)
        s = len(d.prompt)
        with torch.profiler.record_function(trace.LM_REFERENCE):
            logits = ref.logits(weights, model, seq,
                                range(s - 1, s - 1 + len(toks)))
        tally.add(check.compare_lm(logits, torch.from_numpy(toks)))
        del logits
    del weights

    n_tok = stats["decode_tokens"] + stats["prefills"]
    ttft = [1e3 * (d.first - d.submitted) for d in window]
    tpot = [1e3 * (d.finished - d.first) / (len(d.tokens) - 1)
            for d in window if len(d.tokens) > 1]
    result = {"correct": tally.correct and not loaded,
              "attempted": len(window) + stuck, "failed": tally.failed}
    metrics = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        ctx = Context(trc, counts, model, t, int(window_peak), stats)
        for m in cell.per_layer:
            v = resolve.reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info["busy_s"] = trc.busy_s()
        dev_info["window_s"] = trc.window_s
    else:
        e2e = {"tokens_per_s": (n_tok / window_s, "tokens/s"),
               "ttft_p95_ms": (_p95(ttft), "ms"),
               "tpot_p95_ms": (_p95(tpot), "ms"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    result["metrics"] = metrics
    result["device"] = dev_info
    if traced:
        result["breakdown"] = {"device_ops": trc.top_ops(),
                               "idle_gaps": trc.idle_gaps()}
    result["checks"] = {k: {"value": v["value"] if math.isfinite(
        v["value"]) else 1e300, "limit": v["limit"]}
        for k, v in tally.lines().items()}
    result["_loaded"] = loaded
    result["_batches"] = {
        "window": j, "checked": len(checked), "window_s": window_s,
        "completed": len(window), "steps_checked": tally.steps,
        "share_past": {m: tally.share_past(m)
                        for m in (0.1, 0.25, 0.5, 1.0, 2.0)},
        "setup": {name: round(t1 - t_0, 3) for (_, t_0), (name, t1)
                  in zip(phases, phases[1:])}}
    return result


def _p95(values: List[float]) -> float:
    return float(np.percentile(values, 95)) if values else 1e300
