"""Serving launcher (port of ``repro.launch.serve``): a thin driver over the
continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_1p3b \
        --smoke --requests 8 [--device cpu]

It builds params from ``--seed``, synthesizes a staggered-arrival trace,
runs ``repro_torch.serve.engine.Engine`` and prints the EngineStats report.
Without ``--device`` it runs on the card and raises if there is none.

``--check`` is the smoke gate: it plants an EOS on request 0 (probed from
an identical engine, so the request genuinely stops early), then asserts
slot reuse, at least one EOS eviction and that every request completed;
any violation exits non-zero.

Observability: ``--trace-out FILE`` / ``--metrics-out FILE`` run the engine
with a recording ``repro_torch.obs.EngineRecorder`` and write a Chrome
``trace_event`` JSON and an ``obs/v1`` snapshot. ``--metrics-port P``
serves the live registry over HTTP during the run (``P=0``: an ephemeral
port, self-scraped at the end; under ``--check`` the scrape must equal
``exposition()``); ``--snapshot-out FILE`` writes periodic snapshots.

The router's flags (``--replicas``, ``--drain-*``, ``--drift-*``,
``--health-*``) and ``--mesh-model`` are accepted for the reference's
command lines and raise, naming the ROADMAP slice that brings them.
"""
import argparse
import dataclasses
import json
import sys

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ROUTER_SLICE, Engine, synth_trace
from repro_torch.serve.scheduler import AdmissionQueue, Request

MESH_SLICE = "ROADMAP Slice F (distribution)"


def _not_ported(args) -> None:
    """Raise for a flag of a later slice that was given a value."""
    later = [("--replicas", args.replicas != 1, ROUTER_SLICE),
             ("--drain-tick", args.drain_tick != 0, ROUTER_SLICE),
             ("--drift-replica", args.drift_replica != -1, ROUTER_SLICE),
             ("--health-threshold", args.health_threshold is not None,
              ROUTER_SLICE),
             ("--health-poll", args.health_poll is not None, ROUTER_SLICE),
             ("--mesh-model", args.mesh_model != 0, MESH_SLICE)]
    for flag, given, where in later:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet: {where}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length in the synthetic trace")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="max per-request generation budget")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=2,
                    help="ticks between request arrivals")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens (0 = engine default)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool capacity incl. the garbage page (0 = "
                         "engine default: every slot's worst case fits)")
    ap.add_argument("--common-prefix", type=int, default=0,
                    help="shared prompt-prefix tokens in the synthetic "
                         "trace (prefix-page sharing on pure attention)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bounded admission queue (0 = unbounded)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kan-backend", default="",
                    help="override ModelConfig.kan_backend for KAN-FFN "
                         "archs (serving deploys its artifact once)")
    ap.add_argument("--check", action="store_true",
                    help="assert slot reuse + EOS eviction + full "
                         "completion")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace_event JSON of the run; "
                         "enables recording")
    ap.add_argument("--metrics-out", default="",
                    help="write the obs/v1 metrics snapshot JSON; enables "
                         "recording")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve live /metrics + /metrics.json over HTTP "
                         "during the run (0 = ephemeral port; -1 = off); "
                         "enables recording")
    ap.add_argument("--snapshot-out", default="",
                    help="write periodic JSON metric snapshots to this "
                         "path during the run; enables recording")
    ap.add_argument("--snapshot-every", type=float, default=1.0,
                    help="seconds between periodic snapshots")
    # the reference's router and mesh flags: a later slice each
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--drain-tick", type=int, default=0)
    ap.add_argument("--drain-replica", type=int, default=1)
    ap.add_argument("--drift-replica", type=int, default=-1)
    ap.add_argument("--drift-rate", type=float, default=0.05)
    ap.add_argument("--health-threshold", type=float, default=None)
    ap.add_argument("--health-poll", type=int, default=None)
    ap.add_argument("--mesh-model", type=int, default=0)
    args = ap.parse_args(argv)
    _not_ported(args)
    device = resolve_device(args.device)

    m = get_arch(args.arch, smoke=args.smoke).model
    if args.kan_backend:
        m = dataclasses.replace(m, kan_backend=args.kan_backend)
    params = tfm.init_model(args.seed, m, device=device)

    reqs = synth_trace(
        m.vocab, args.requests,
        max_prompt=args.prompt_len, min_prompt=max(2, args.prompt_len // 2),
        max_new=args.new_tokens, min_new=max(2, args.new_tokens // 2),
        stagger=args.stagger, common_prefix=args.common_prefix,
        seed=args.seed)
    max_len = args.common_prefix + args.prompt_len + args.new_tokens
    eng_kw = dict(n_slots=args.slots, max_len=max_len,
                  page_size=args.page_size or None,
                  n_pages=args.n_pages or None, device=device)

    recorder = None
    if (args.trace_out or args.metrics_out or args.snapshot_out
            or args.metrics_port >= 0):
        from repro_torch.obs import EngineRecorder
        recorder = EngineRecorder()
    server = writer = None
    if args.metrics_port >= 0:
        from repro_torch.obs import MetricsHTTPServer
        server = MetricsHTTPServer(recorder, port=args.metrics_port).start()
        print(f"metrics endpoint -> {server.url}")
    if args.snapshot_out:
        from repro_torch.obs import PeriodicSnapshotWriter
        writer = PeriodicSnapshotWriter(
            recorder, args.snapshot_out,
            interval_s=args.snapshot_every).start()

    eng = Engine(params, m, queue=AdmissionQueue(args.queue_cap or None),
                 recorder=recorder, **eng_kw)
    eos_planted = args.check and args.new_tokens >= 3
    if eos_planted:
        # a genuine early stop: request 0's EOS is its own 2nd token, probed
        # through an identical engine (the same fused-tick shapes) on the
        # deployed params
        probe = Engine(eng.params, m, **eng_kw).run(
            [Request(rid="probe", tokens=reqs[0].tokens, max_new=2)])
        reqs[0].eos_id = int(probe[0].tokens[1])
    comps = eng.run(reqs)

    if recorder is not None:
        if eng.kan_deployed and m.kan_backend == "cim_tiled":
            print("note: chip telemetry (hw.chip.publish_report) is not "
                  f"ported yet: {ROUTER_SLICE}")
        if args.trace_out:
            print(f"trace  -> {recorder.export_trace(args.trace_out)}")
        if args.metrics_out:
            print(f"metrics -> {recorder.export_metrics(args.metrics_out)}")
    if writer is not None:
        print(f"snapshots -> {writer.stop()} ({writer.writes} writes)")
    scrape = live_snap = None
    if server is not None:
        # self-scrape the live endpoint after all telemetry has landed
        import urllib.request
        with urllib.request.urlopen(server.url) as resp:
            scrape = resp.read().decode()
        with urllib.request.urlopen(server.url + ".json") as resp:
            live_snap = json.loads(resp.read().decode())
        print(f"scraped {server.url}: {len(scrape)} bytes "
              f"({server.scrapes} scrapes served)")
        server.stop()

    rep = eng.stats.report()
    kan_note = (f" kan_backend={m.kan_backend} (deployed once)"
                if eng.kan_deployed else "")
    print(f"arch={m.name} slots={args.slots} requests={args.requests} "
          f"stagger={args.stagger} device={device}{kan_note}")
    print(json.dumps(rep, indent=1))
    for c in comps[:4]:
        print(f"  rid={c.rid} reason={c.reason} slot={c.slot} "
              f"ticks={c.admitted_tick}->{c.finished_tick} "
              f"tokens={list(c.tokens)[:8]}")

    if args.check and scrape is not None:
        if scrape != recorder.metrics.exposition():
            raise SystemExit("metrics check FAILED: live /metrics scrape "
                             "does not match registry exposition")
        if live_snap.get("schema") != "obs/v1":
            raise SystemExit("metrics check FAILED: /metrics.json schema "
                             f"is {live_snap.get('schema')!r}, want obs/v1")
        print("metrics endpoint check OK: scrape matches exposition, "
              "snapshot schema obs/v1")
    if args.check:
        problems = []
        if rep["completed"] != args.requests:
            problems.append(f"completed {rep['completed']} != "
                            f"{args.requests} submitted")
        if rep["slot_reuse"] <= 1:
            problems.append(f"no slot reuse: slot_served={rep['slot_served']}")
        if eos_planted and rep["evicted_eos"] < 1:
            problems.append("no EOS eviction observed")
        if rep["evicted_eos"] + rep["evicted_length"] != rep["completed"]:
            problems.append("eviction accounting does not add up")
        if problems:
            raise SystemExit("engine check FAILED: " + "; ".join(problems))
        print("engine check OK: slot reuse, EOS eviction, full completion")
    return rep


if __name__ == "__main__":
    main(sys.argv[1:])
