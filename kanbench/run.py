"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m kanbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The configuration's ``kind`` picks the
system: ``cf_kan`` (the default) runs here; ``lm`` runs the program's
serving engine (``kanbench/lm_run.py``).

CF-KAN: set-up makes the weights and a pool of users on the card from the
seed, deploys the program's artifact on the cell's backend and warms up
the cell's shapes. The window then scores batches of users for
``--seconds``, one batch in flight: the program's ``kan.apply`` on the
artifact, its ranking to the top k unseen items, the ids copied to the
host. Under a closed loop (the default) batches of the traffic's size run
back to back; under an open loop (``"loop": "open"``) users fall due on a
Poisson schedule drawn from the seed, and each batch takes every user
already due, up to ``max_batch``. Batches drawn from the seed keep what
the program produced; once the window has closed and the program's
artifact is freed, the plain reference in ``kanbench/reference`` scores
the same users and decides ``correct``. ``--trace 1`` traces a few
batches of the window with ``torch.profiler`` and reports the per-layer
metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOP_K = 20              # ids a user gets, as the program's Recall@20 ranks
POOL_BATCHES = 8        # distinct batches of users the window cycles over
WARMUP_BATCHES = 3
CHECK_ROWS = 256        # users of a checked batch compared with the reference
OPEN_SLACK_S = 30.0     # an open loop's schedule runs this far past the window
BACKLOG_EVERY_S = 1.0   # an open loop reads its backlog this often


def _setup_paths() -> None:
    """The program's package from the checkout's ``src``; every cache kept
    inside the checkout, at a fixed path."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / ".kanbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))


_setup_paths()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kanbench import (check, forbidden_modules, generator,  # noqa: E402
                      resolve, system, trace)
from kanbench.reference import cf_kan as ref_cf_kan  # noqa: E402
from kanbench.reference import crossbar as ref_crossbar  # noqa: E402

_T_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the trace of the traced batches, the
    counts of their work (per batch, per layer), the cell's files and the
    window's peak memory."""
    trace: trace.Trace
    counts: List[List[Dict[str, int]]]
    model: Dict
    traffic: Dict
    window_peak_bytes: int


def reference_hardware(traffic: Dict, seed: int) -> ref_cf_kan.Hardware:
    hw = traffic["hardware"]
    if hw is None:
        return ref_cf_kan.Hardware("digital")
    xbar = ref_crossbar.Crossbar(
        array_size=hw["array_size"], gamma0=hw["gamma0"],
        adc_bits=hw["adc_bits"], input_bits=hw["input_bits"],
        adc_in_scale=hw["adc_in_scale"], tile_cols=hw.get("tile_cols", 0),
        variation_sigma=hw.get("variation_sigma", 0.0),
        variation_clip=hw.get("variation_clip", 3.0))
    return ref_cf_kan.Hardware(hw["kind"], xbar, traffic["sam"], seed)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Window:
    """The measured window's loop and what it keeps."""

    def __init__(self, deployed, apply, batches: torch.Tensor, seed: int,
                 check_every: int, check_rows: int):
        self.deployed, self.apply, self.batches = deployed, apply, batches
        self.k = TOP_K
        self.every = check_every
        self.offset = random.Random(seed).randrange(self.every)
        self.kept: Dict[int, tuple] = {}
        self.events: List[tuple] = []
        self.n = 0
        dev = batches.device
        # the users of a checked batch whose answers are kept: a sample of
        # ``check_rows`` drawn from the seed
        b = batches.shape[1]
        gen = torch.Generator().manual_seed(seed)
        rows = torch.sort(torch.randperm(b, generator=gen)[
            :min(check_rows, b)]).values
        self.rows_host, self.rows = rows, rows.to(dev)
        self.host_ids = torch.empty((batches.shape[1], self.k),
                                    dtype=torch.int64,
                                    pin_memory=dev.type == "cuda")

    def x(self, j: int) -> torch.Tensor:
        return self.batches[j % self.batches.shape[0]]

    def score(self, x: torch.Tensor, spans: bool) -> torch.Tensor:
        """One batch through the timed path: scores, ranking, the ids on
        the host (``host_ids``' first rows) when it returns; its scores."""
        cuda = x.device.type == "cuda"
        rng = (torch.profiler.record_function if spans
               else lambda _: contextlib.nullcontext())
        with rng(trace.BATCH):
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            else:
                t0 = time.perf_counter()
            with rng(trace.SPANS[0]):
                scores = self.apply(self.deployed, x)
            with rng(trace.SPANS[1]):
                ids = system.rank(scores, x, self.k)
            self.host_ids[:x.shape[0]].copy_(ids, non_blocking=cuda)
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                self.events.append(ev)
            else:
                self.events.append(time.perf_counter() - t0)
        return scores

    def step(self, j: int, spans: bool) -> None:
        """One batch of the pool, kept where it is checked."""
        scores = self.score(self.x(j), spans)
        if (j + self.offset) % self.every == 0:
            self.kept[j] = (scores.index_select(0, self.rows),
                            self.host_ids[self.rows_host])

    def latencies_ms(self) -> List[float]:
        return [e[0].elapsed_time(e[1]) if isinstance(e, tuple)
                else 1e3 * e for e in self.events]

    def warm_up(self, spans: bool = False) -> None:
        """The cell's shapes, once (with ``spans``: one batch, for the
        tracer's own set-up)."""
        for j in range(1 if spans else WARMUP_BATCHES):
            self.step(-1 - j, spans=spans)

    def checked_input(self, j: int) -> torch.Tensor:
        """The inputs of batch ``j``'s kept users."""
        return self.x(j).index_select(0, self.rows)

    def traced_input(self, j: int):
        """Batch ``j``'s inputs and a key shared by batches of the same
        inputs (the pool's batch)."""
        return j % self.batches.shape[0], self.x(j)


class OpenWindow(Window):
    """The open loop: users fall due on a Poisson schedule at ``rate``
    users a second, drawn from the seed (user u is the pool's row u modulo
    its size). When the previous batch's ids are on the host, the server
    takes every user already due, up to ``max_batch``, and scores them as
    the closed loop does; where none is due it waits for the next. A user's
    latency runs from when it was due to when its ids are on the host. A
    checked batch keeps all its users. Every ``BACKLOG_EVERY_S`` of the
    window it reads the backlog (users due, not yet taken) as it takes a
    batch; the slope fitted to those readings says whether it grows."""

    def __init__(self, deployed, apply, pool: torch.Tensor, seed: int,
                 check_every: int, rate: float, max_batch: int,
                 horizon_s: float):
        self.deployed, self.apply, self.pool = deployed, apply, pool
        self.k, self.every, self.max_batch = TOP_K, check_every, max_batch
        self.offset = random.Random(seed).randrange(self.every)
        self.kept: Dict[int, tuple] = {}
        self.events: List = []
        self.n = 0
        n = int(rate * horizon_s * 1.25) + 1000
        gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
        self.due = np.cumsum(gaps)             # s after the window opens
        self.done = np.full(n, np.nan)         # due to ids on the host
        self.dequeued = np.full(n, np.nan)     # due to taken by the server
        self.next = 0                          # first user not yet taken
        self.limit = n                         # users that may be taken
        self.t0 = 0.0
        self.users: List[tuple] = []           # (first user, n) by batch
        self.backlog: List[tuple] = []         # (s, users waiting)
        self.next_read = BACKLOG_EVERY_S
        dev = pool.device
        self.host_ids = torch.empty((max_batch, self.k), dtype=torch.int64,
                                    pin_memory=dev.type == "cuda")

    def rows(self, first: int, n: int) -> torch.Tensor:
        p = self.pool.shape[0]
        lo = first % p
        if lo + n <= p:
            return self.pool[lo:lo + n]
        return torch.cat([self.pool[lo:], self.pool[:lo + n - p]])

    def warm_up(self, spans: bool = False) -> None:
        """Every batch size the loop can take, once (with ``spans``: a full
        batch, for the tracer's own set-up)."""
        for n in ([self.max_batch] if spans
                  else range(1, self.max_batch + 1)):
            self.score(self.rows(0, n), spans)

    def open(self, t0: float) -> None:
        self.t0 = t0

    def step(self, j: int, spans: bool) -> None:
        i = self.next
        if i >= self.limit:
            raise RuntimeError("the open loop's schedule ran out")
        now = time.perf_counter()
        while now - self.t0 < self.due[i]:
            now = time.perf_counter()
        rel = now - self.t0
        n = min(int(np.searchsorted(self.due, rel, side="right")),
                self.limit) - i
        if rel >= self.next_read:
            self.backlog.append((rel, n))
            self.next_read += BACKLOG_EVERY_S
        n = min(n, self.max_batch)
        scores = self.score(self.rows(i, n), spans)
        done = time.perf_counter() - self.t0
        self.dequeued[i:i + n] = rel - self.due[i:i + n]
        self.done[i:i + n] = done - self.due[i:i + n]
        self.next = i + n
        self.users.append((i, n))
        if (j + self.offset) % self.every == 0:
            self.kept[j] = (scores, self.host_ids[:n].clone())

    def close(self, window_s: float, j: int) -> Dict[str, float]:
        """End the window at ``window_s``: no user due later is taken.
        Serve the backlog (users due but not yet taken) and return what
        the window's users saw."""
        served, n_events = self.next, len(self.events)
        self.limit = int(np.searchsorted(self.due, window_s, side="right"))
        self.next_read = math.inf
        while self.next < self.limit:
            self.step(j, spans=False)
            j += 1
        due = self.limit
        return {"served": served, "backlog": due - served, "due": due,
                "n_events": n_events, "user_ms": 1e3 * self.done[:due],
                "dequeue_ms": 1e3 * self.dequeued[:due],
                "backlog_slope": self.backlog_slope()}

    def backlog_slope(self) -> float:
        """Users a second by which the backlog read in the window grew: the
        least-squares slope of its readings (0 with fewer than two)."""
        if len(self.backlog) < 2:
            return 0.0
        t, n = np.asarray(self.backlog, dtype=np.float64).T
        return float(np.polyfit(t, n, 1)[0])

    def checked_input(self, j: int) -> torch.Tensor:
        return self.rows(*self.users[j])

    def traced_input(self, j: int):
        return j, self.rows(*self.users[j])


def run(cell: resolve.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t0: Optional[float] = None,
        coeff_bits: Optional[int] = None, taps: Optional[torch.dtype] = None,
        root: Path = ROOT, check_every: Optional[int] = None,
        check_rows: int = CHECK_ROWS) -> Dict:
    """One run of ``cell``; returns the result line's object. The controls,
    each held to the reference at the configuration's precision:
    ``coeff_bits`` deploys the program at that coefficient precision;
    ``taps`` puts the reference in the program's place, its taps rounded
    to that dtype (``fused`` cells). ``check_every`` and ``check_rows``
    replace the traffic's and the harness's, to check more of a run."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = [("start", t0)] + ([("import", _T_IMPORTED)]
                                 if t0 < _T_IMPORTED else [])
    t, model = cell.traffic, cell.model
    cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    phases.append(("device", time.perf_counter()))
    params = generator.make_params(model, gen)
    open_loop = t.get("loop", "closed") == "open"
    b = t["max_batch"] if open_loop else t["batch"]
    pool = generator.make_pool(t.get("pool_users", POOL_BATCHES * b),
                               model["n_items"], gen)
    sample = [pool[:b], pool[b:2 * b]] if t["sam"] else []
    if cuda:
        torch.cuda.synchronize()
    phases.append(("inputs", time.perf_counter()))
    if taps is None:
        deployed = system.deploy(params, model, t, seed, sample, coeff_bits)
        apply = system.apply
    else:
        deployed = ref_cf_kan.round_taps(ref_cf_kan.build(
            params, model, ref_cf_kan.Hardware("digital")), taps)

        def apply(layers, x):
            return ref_cf_kan.forward(layers, ref_cf_kan.Hardware("digital"),
                                      x)[0].to(torch.float32)
    if cuda:
        torch.cuda.synchronize()
    phases.append(("deploy", time.perf_counter()))
    every = check_every or t["check_every"]
    if open_loop:
        win = OpenWindow(deployed, apply, pool, seed, every, t["rate"], b,
                         seconds + OPEN_SLACK_S)
    else:
        win = Window(deployed, apply,
                     pool.view(POOL_BATCHES, b, model["n_items"]), seed,
                     every, check_rows)
    win.warm_up()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts):        # the tracer's own set-up
            win.warm_up(spans=True)
        prof = profile(activities=acts)
    win.kept.clear()
    win.events.clear()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("warm-up", time.perf_counter()))
    setup_s = phases[-1][1] - t0

    lead, n_traced = t["trace_lead"], t["trace_batches"]
    # set-up's objects leave the collector's scans: a full collection in
    # the window would stall one batch by the time it takes to walk them
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    if open_loop:
        win.open(start)
    j = 0
    while (time.perf_counter() - start < seconds
           or (traced and j < lead + n_traced)):
        tracing = traced and lead <= j < lead + n_traced
        if tracing and j == lead:
            prof.start()
        win.step(j, spans=tracing)
        if tracing and j == lead + n_traced - 1:
            prof.stop()
        j += 1
    window_s = time.perf_counter() - start
    users = win.close(window_s, j) if open_loop else None
    gc.unfreeze()
    win.n = j

    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak) if cuda else 0
    loaded = forbidden_modules()
    trc = trace.read(prof) if traced else None
    lat = win.latencies_ms()[:users["n_events"] if users else None]
    del deployed, win.deployed
    if cuda:
        torch.cuda.empty_cache()

    tally = check.Tally(cell.limits)
    hw = reference_hardware(t, seed)
    ref_layers = ref_cf_kan.build(params, model, hw, sample)
    n_checked = len(win.kept)
    for jj in sorted(win.kept):
        scores, ids = win.kept.pop(jj)
        x = win.checked_input(jj)
        ref, _ = ref_cf_kan.forward(ref_layers, hw, x)
        tally.add(check.compare(ref, scores, ids, x, win.k))
        del ref, scores
    # the work of the traced batches, counted from their inputs: once for
    # each of the pool's batches that they cycle over
    by_batch: Dict[int, List[Dict[str, int]]] = {}
    traced_counts = []
    for jj in range(lead, lead + n_traced) if traced else ():
        key, x = win.traced_input(jj)
        if key not in by_batch:
            by_batch[key] = ref_cf_kan.forward(ref_layers, hw, x)[1]
        traced_counts.append(by_batch[key])

    served = users["served"] if users else win.n * b
    result = {"correct": tally.correct and not loaded,
              "attempted": users["due"] if users else served,
              "failed": tally.failed}
    metrics = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        ctx = Context(trc, traced_counts, model, t, int(window_peak))
        for m in cell.per_layer:
            v = resolve.reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info["busy_s"] = trc.busy_s()
        dev_info["window_s"] = trc.window_s
    else:
        e2e = {"users_per_s": (served / window_s, "users/s"),
               "batch_p95_ms": (float(np.percentile(lat, 95)), "ms"),
               "setup_s": (setup_s, "s")}
        if users:
            e2e["user_p50_ms"] = (float(np.median(users["user_ms"])), "ms")
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    result["metrics"] = metrics
    result["device"] = dev_info
    if traced:
        result["breakdown"] = {"device_ops": trc.top_ops(),
                               "idle_gaps": trc.idle_gaps()}
    if users:
        # the users' latency (due to ids on the host; only the median is a
        # metric: the tail spreads between runs with the host, PERF.md §2),
        # how late the server took them, what was still waiting when the
        # window closed and how the backlog moved inside it
        u = users["user_ms"]
        result["generator"] = {
            "user_p50_ms": float(np.median(u)),
            "user_mean_ms": float(np.mean(u)),
            "user_p95_ms": float(np.percentile(u, 95)),
            "dequeue_p95_ms": float(np.percentile(users["dequeue_ms"], 95)),
            "backlog": users["backlog"],
            "backlog_slope": users["backlog_slope"], "rate": t["rate"],
            "users_per_s": served / window_s,
            "users_per_batch": served / max(users["n_events"], 1)}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in tally.lines().items()}
    result["_loaded"] = loaded
    result["_batches"] = {"window": win.n, "checked": n_checked,
                          "window_s": window_s,
                          "setup": {name: round(t1 - t_0, 3) for (_, t_0),
                                    (name, t1) in zip(phases, phases[1:])}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve.cell(ROOT, args.workload)
    lm = cell.model.get("kind", "cf_kan") == "lm"
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"kanbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if lm:
        from kanbench import lm_run
        result = lm_run.run(cell, args.seed, args.seconds, bool(args.trace),
                            t0=_T0, t_imported=_T_IMPORTED)
    else:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     t0=_T0)
    loaded = result.pop("_loaded")
    info = result.pop("_batches")
    if loaded:
        print(f"kanbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    unit = "steps" if lm else "batches"
    extra = (f", {info['completed']} requests completed, "
             f"{info['steps_checked']} tokens checked" if lm else "")
    print(f"kanbench: {args.workload} seed {args.seed}: {info['window']} "
          f"{unit} in {info['window_s']:.3f} s, {info['checked']} checked"
          f"{extra}; set-up s {info['setup']}; card {_power_limit()}",
          file=sys.stderr)
    print(json.dumps(result))
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
