"""Serving launcher (port of ``repro.launch.serve``): a thin driver over the
continuous-batching engine and the multi-replica router.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_1p3b \
        --smoke --requests 8 [--device cpu]

It builds params from ``--seed``, synthesizes a staggered-arrival trace,
runs ``repro_torch.serve.engine.Engine`` and prints the EngineStats report.
Without ``--device`` it runs on the card and raises if there is none.

``--replicas N`` serves the trace through ``repro_torch.serve.router``
instead: N engines on the one device share replica 0's deployed params (a
KAN deploy runs once) and ``adopt_compiled`` its profiler state; the router
owns the global queue, scores load and prefix affinity per dispatch, and
prints the RouterStats aggregate (its ``agg_tokens_per_s`` is the
reference's modeled-concurrent throughput: the replicas are stepped one
after the other). ``--drain-tick T`` schedules a drain of
``--drain-replica`` at tick T: its in-flight requests requeue onto the
others, and ``--check`` still requires every request to complete.
``--drift-replica I --drift-rate R`` attaches a ``hw.health.ChipHealth``
canary probe to every replica, with conductance drift in replica I only;
the router's HealthMonitor polls canary deviation and SLO burn every
``--health-poll`` ticks and drains the degraded replica once the deviation
crosses ``--health-threshold``. Under ``--check`` that run must show a
health drain, no lost request and the completion tokens of a healthy
single engine on the same trace.

``--check`` is the smoke gate: it plants an EOS on request 0 (probed from
an identical engine, so the request genuinely stops early), then asserts
slot reuse, at least one EOS eviction and that every request completed;
any violation exits non-zero.

Observability: ``--trace-out FILE`` / ``--metrics-out FILE`` run the engine
with a recording ``repro_torch.obs.EngineRecorder`` and write a Chrome
``trace_event`` JSON and an ``obs/v1`` snapshot (with chip placement
gauges from ``hw.chip.publish_report`` for ``cim_tiled``).
``--metrics-port P`` serves the live registry over HTTP during the run
(``P=0``: an ephemeral port, self-scraped at the end; under ``--check``
the scrape must equal ``exposition()``); ``--snapshot-out FILE`` writes
periodic snapshots.

``--mesh-model M`` serves under a (data = world // M, model = M) mesh of
processes, one rank each (``launch.mesh``: ``RANK``/``WORLD_SIZE`` and
``REPRO_TORCH_STORE`` or torchrun's variables; a process started without
them is a world of one). Every rank builds the same params and trace; the
engine replicates the params (a KAN artifact whole on every rank), places
its paged cache by ``decode.paged_cache_spec`` and runs each tick as
DTensors, so every rank takes the same greedy tokens and the same host
decisions. Rank 0 prints; ``--check`` holds on every rank, and a failing
rank exits non-zero. On the CPU:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch mamba2_1p3b --smoke --check \
        --slots 2 --requests 6 --mesh-model 2 --device cpu

The backend is ``launch.mesh.default_backend``'s: gloo on the CPU or for
ranks sharing one card (NCCL refuses two ranks on one GPU), NCCL with one
rank per card.
"""
import argparse
import dataclasses
import json
import os
import sys

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as shlib
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Engine, synth_trace
from repro_torch.serve.scheduler import AdmissionQueue, Request

def _check_flags(args) -> None:
    """The reference's argument errors."""
    if args.replicas > 1 and args.mesh_model:
        raise SystemExit("--replicas and --mesh-model are mutually "
                         "exclusive: a router replica holds the whole "
                         "model on its own device(s)")
    if args.drift_replica >= 0 and not (0 <= args.drift_replica
                                        < args.replicas and
                                        args.replicas > 1):
        raise SystemExit("--drift-replica needs the router path: require "
                         "--replicas > 1 and 0 <= drift-replica < replicas")


def lenient_slos():
    """The SLOs of a health run: latency bars no host-clock TTFT or TPOT of
    a smoke or host-bound run reaches, so that only drift drains a replica
    (a healthy replica drained for jitter would make the token check
    meaningless)."""
    from repro_torch.obs.slo import default_serving_slos
    return default_serving_slos(ttft_s=120.0, tpot_s=60.0,
                                queue_wait_ticks=1e9)


def _publish_chip(params, registry) -> None:
    """Chip placement gauges for every ``cim_tiled`` artifact in
    ``params``, in the registry that holds the serving metrics: one
    snapshot for the whole stack (``chip_*``, or ``chip{i}_*`` when the
    model holds several artifacts)."""
    from repro_torch.core import kan as kanlib
    from repro_torch.hw import chip as chip_lib
    deployed = []

    def walk(tree):
        if isinstance(tree, kanlib.DeployedKAN):
            deployed.append(tree)
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    walk(params)
    for i, d in enumerate(deployed):
        prefix = "chip" if len(deployed) == 1 else f"chip{i}"
        chip_lib.publish_report(chip_lib.chip_report(d), registry,
                                prefix=prefix)


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
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="serve under a (world // M, M) host mesh of "
                         "ranks (0 = no mesh)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through the multi-replica router with this "
                         "many engines (1 = a single engine; incompatible "
                         "with --mesh-model)")
    ap.add_argument("--drain-tick", type=int, default=0,
                    help="router path only: schedule a drain of "
                         "--drain-replica at this tick (0 = no drain)")
    ap.add_argument("--drain-replica", type=int, default=1,
                    help="replica index --drain-tick evacuates")
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
    ap.add_argument("--drift-replica", type=int, default=-1,
                    help="router path only: inject temporal conductance "
                         "drift into this replica's chip-health canary "
                         "(-1 = no drift / no health monitor)")
    ap.add_argument("--drift-rate", type=float, default=0.05,
                    help="mean drift exponent nu for the degraded replica "
                         "(hw.variation.DriftConfig.rate)")
    ap.add_argument("--health-threshold", type=float, default=0.05,
                    help="canary relative-deviation threshold above which "
                         "the HealthMonitor drains a replica")
    ap.add_argument("--health-poll", type=int, default=2,
                    help="router ticks between HealthMonitor polls")
    args = ap.parse_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    if not args.mesh_model:
        return _serve(args, device, None)
    joined = not torch.distributed.is_initialized()
    meshlib.init_process_group(meshlib.default_backend(device),
                               cuda_gloo=device.type == "cuda")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    try:
        mesh = meshlib.make_host_mesh(args.mesh_model, device)
        with shlib.use_mesh(mesh):
            return _serve(args, device, mesh)
    finally:
        if joined:      # leave only a group this call joined
            meshlib.destroy()


def _serve(args, device, mesh) -> dict:
    """The launcher's run on ``device``, under ``mesh`` if not None (the
    engines then take the rank's device from the mesh; rank 0 prints)."""
    lead = meshlib.rank() == 0
    say = print if lead else (lambda *a, **k: None)

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
                  n_pages=args.n_pages or None,
                  device=None if mesh is not None else device)

    recorder = None
    if (args.trace_out or args.metrics_out or args.snapshot_out
            or args.metrics_port >= 0):
        from repro_torch.obs import EngineRecorder
        recorder = EngineRecorder()
    server = writer = None
    if args.metrics_port >= 0:
        from repro_torch.obs import MetricsHTTPServer
        server = MetricsHTTPServer(recorder, port=args.metrics_port).start()
        say(f"metrics endpoint -> {server.url}")
    if args.snapshot_out:
        from repro_torch.obs import PeriodicSnapshotWriter
        writer = PeriodicSnapshotWriter(
            recorder, args.snapshot_out,
            interval_s=args.snapshot_every).start()

    queue = AdmissionQueue(args.queue_cap or None)
    eos_planted = args.check and args.new_tokens >= 3
    router = ref_comps = None
    if args.replicas > 1:
        from repro_torch.serve.router import Router

        def rec_for(i):
            return recorder.for_replica(i) if recorder else None

        eng = Engine(params, m, recorder=rec_for(0), **eng_kw)
        if eos_planted:
            # the single-engine path's planted-EOS probe, through an
            # identical engine whose profiler state replica 0 adopts
            probe_eng = Engine(eng.params, m, recorder=rec_for(0), **eng_kw)
            probe = probe_eng.run([Request(rid="probe", tokens=reqs[0].tokens,
                                           max_new=2)])
            reqs[0].eos_id = int(probe[0].tokens[1])
            eng.adopt_compiled(probe_eng)
        # replicas 1..N-1 share replica 0's deployed params (one frozen
        # artifact serves the fleet); each holds its own page pool
        replicas = [eng] + [
            Engine(eng.params, m, recorder=rec_for(i), **eng_kw)
            .adopt_compiled(eng) for i in range(1, args.replicas)]
        router = Router(replicas, queue=queue, recorder=recorder)
        if args.drain_tick:
            router.schedule_drain(args.drain_replica, args.drain_tick)
        if args.drift_replica >= 0:
            from repro_torch.hw.health import ChipHealth, ProbeGeometry
            from repro_torch.hw.tiles import TileConfig
            from repro_torch.hw.variation import DriftConfig
            mon = router.enable_health(
                poll_every=args.health_poll,
                drift_threshold=args.health_threshold, slos=lenient_slos)
            for i in range(args.replicas):
                # every replica carries a canary probe; only the degraded
                # one drifts (tau 4: the deviation crosses the default
                # threshold within about a dozen ticks)
                drifting = i == args.drift_replica
                mon.attach_chip(i, ChipHealth(
                    tile=TileConfig(array_size=64, tile_cols=16),
                    drift=DriftConfig(
                        rate=args.drift_rate if drifting else 0.0,
                        tau=4.0, seed=args.seed),
                    geometry=ProbeGeometry(layer_uids=(0, 1),
                                           tiles_per_layer=2),
                    registry=(recorder.metrics if recorder else None),
                    labels={"replica": str(i)}))
        comps = router.run(reqs)
        if args.check and args.drift_replica >= 0:
            # a healthy single engine on the same trace and deployed params:
            # greedy decoding is deterministic, so the auto-drained fleet
            # must emit the same completion tokens
            ref_comps = Engine(eng.params, m, **eng_kw).adopt_compiled(
                eng).run(list(reqs))
    else:
        eng = Engine(params, m, queue=queue, recorder=recorder, **eng_kw)
        if eos_planted:
            # a genuine early stop: request 0's EOS is its own 2nd token,
            # probed through an identical engine (the same fused-tick
            # shapes) on the deployed params
            probe = Engine(eng.params, m, **eng_kw).run(
                [Request(rid="probe", tokens=reqs[0].tokens, max_new=2)])
            reqs[0].eos_id = int(probe[0].tokens[1])
        comps = eng.run(reqs)

    if recorder is not None and lead:
        if eng.kan_deployed and m.kan_backend == "cim_tiled":
            _publish_chip(eng.params, recorder.metrics)
        if args.trace_out:
            say(f"trace  -> {recorder.export_trace(args.trace_out)}")
        if args.metrics_out:
            say(f"metrics -> {recorder.export_metrics(args.metrics_out)}")
    if writer is not None:
        say(f"snapshots -> {writer.stop()} ({writer.writes} writes)")
    scrape = live_snap = None
    if server is not None:
        # self-scrape the live endpoint after all telemetry has landed
        import urllib.request
        with urllib.request.urlopen(server.url) as resp:
            scrape = resp.read().decode()
        with urllib.request.urlopen(server.url + ".json") as resp:
            live_snap = json.loads(resp.read().decode())
        say(f"scraped {server.url}: {len(scrape)} bytes "
            f"({server.scrapes} scrapes served)")
        server.stop()

    rep = router.report() if router is not None else eng.stats.report()
    kan_note = (f" kan_backend={m.kan_backend} (deployed once)"
                if eng.kan_deployed else "")
    mesh_note = (f" mesh={shlib.mesh_sizes(mesh)} ranks={mesh.size()}"
                 if mesh is not None else "")
    say(f"arch={m.name} slots={args.slots} requests={args.requests} "
        f"stagger={args.stagger} device={device} "
        f"replicas={args.replicas}{kan_note}{mesh_note}")
    say(json.dumps(rep, indent=1))
    for c in comps[:4]:
        say(f"  rid={c.rid} reason={c.reason} slot={c.slot} "
            f"ticks={c.admitted_tick}->{c.finished_tick} "
            f"tokens={list(c.tokens)[:8]}")

    if args.check and scrape is not None:
        if scrape != recorder.metrics.exposition():
            raise SystemExit("metrics check FAILED: live /metrics scrape "
                             "does not match registry exposition")
        if live_snap.get("schema") != "obs/v1":
            raise SystemExit("metrics check FAILED: /metrics.json schema "
                             f"is {live_snap.get('schema')!r}, want obs/v1")
        say("metrics endpoint check OK: scrape matches exposition, "
            "snapshot schema obs/v1")
    if args.check and router is not None:
        _check_router(args, rep, router, comps, ref_comps, eos_planted)
    elif args.check:
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
        say("engine check OK: slot reuse, EOS eviction, full completion")
    return rep


def _check_router(args, rep, router, comps, ref_comps, eos_planted) -> None:
    """The router path's ``--check``: no lost request, dispatch accounting,
    slot reuse, EOS eviction, the scheduled drain, and with drift the
    health drain and the healthy single engine's completion tokens."""
    problems = []
    per = rep["per_replica"]
    if rep["completed"] != args.requests:
        problems.append(f"lost requests: completed {rep['completed']} != "
                        f"{args.requests} submitted")
    if sum(rep["routed"]) != args.requests + rep["requeued"]:
        problems.append(f"dispatch accounting does not add up: routed "
                        f"{rep['routed']} vs {args.requests} requests + "
                        f"{rep['requeued']} requeued")
    if max(r["slot_reuse"] for r in per) <= 1:
        problems.append("no slot reuse on any replica")
    if eos_planted and sum(r["evicted_eos"] for r in per) < 1:
        problems.append("no EOS eviction observed")
    if args.drain_tick and rep["drains"] < 1:
        problems.append("scheduled drain never fired")
    if args.drift_replica >= 0:
        if rep["drained_for_health"] < 1:
            problems.append("health monitor never drained the degraded "
                            "replica")
        if not router.draining[args.drift_replica]:
            problems.append(f"degraded replica {args.drift_replica} is not "
                            "draining")
        if ref_comps is not None:
            def toks(cs):
                return sorted((c.rid, tuple(int(t) for t in c.tokens))
                              for c in cs)
            if toks(comps) != toks(ref_comps):
                problems.append("auto-drained fleet tokens differ from the "
                                "healthy single-engine reference")
    if problems:
        raise SystemExit("router check FAILED: " + "; ".join(problems))
    print(f"router check OK: zero lost requests ({rep['completed']}/"
          f"{args.requests} completed, {rep['requeued']} requeued), slot "
          "reuse, EOS eviction")
    if args.drift_replica >= 0:
        print(f"health check OK: replica {args.drift_replica} auto-drained "
              f"({rep['drained_for_health']} health drains), tokens "
              "identical to healthy reference")


if __name__ == "__main__":
    main(sys.argv[1:])
