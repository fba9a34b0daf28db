"""The artifact and live-service commands of the CLI: ``stats``,
``trace analyze`` and ``trace diff`` over the files the observability
layer writes (``.semmerge-trace.json``, ``.semmerge-events.jsonl``, a
``SEMMERGE_METRICS`` dump, postmortem bundles), and ``profile``,
``perf`` and ``top``. A copy of the JAX CLI's forms, printing the same
bytes for the same input; the file forms read only the file, so they
work on artifacts of processes long gone.

``stats --daemon`` renders the live status of the port's merge service
daemon (``service/``) as the JAX CLI renders its daemon's; ``top`` is
the JAX CLI's one-screen dashboard of it (``--once`` or a stdout that
is not a TTY prints one frame); ``profile --daemon`` asks the running
daemon for a bounded profiler capture; ``perf record|compare`` is the
perf sentinel (:mod:`.perf`) over bench snapshots or the daemon's
latency window. ``perf`` writes its baseline where ``--baseline`` says,
else ``PERF_BASELINE.json`` in the request root: the checkout's own
file of that name holds the TPU's numbers, so point it elsewhere.

``stats --daemon --fleet`` renders a fleet router's aggregated status
(one ``member_status`` round trip; ``--prometheus`` its federated
``/metrics``), ``trace analyze --fleet`` the router-hop breakdown of a
stitched fleet trace, and a ``tcp://`` ``--socket`` reaches a daemon or
router over the fleet transport. Stdlib only.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List

from . import anomaly as obs_anomaly
from .metrics import render_prometheus_from_dict


def add_parsers(sub) -> None:
    """The ``stats``, ``trace``, ``top``, ``profile`` and ``perf``
    subcommands, with the JAX CLI's arguments."""
    p_stats = sub.add_parser("stats",
                             help="Pretty-print a semmerge trace/metrics "
                                  "artifact (.semmerge-trace.json, "
                                  ".semmerge-events.jsonl, or a "
                                  "SEMMERGE_METRICS dump)")
    p_stats.add_argument("artifact", nargs="?", default=".semmerge-trace.json",
                         help="Artifact path (default .semmerge-trace.json)")
    p_stats.add_argument("--json", action="store_true",
                         help="Emit the artifact back as JSON instead of "
                              "the pretty rendering")
    p_stats.add_argument("--prometheus", action="store_true",
                         help="Render the artifact's metrics as Prometheus "
                              "text exposition")
    p_stats.add_argument("--daemon", action="store_true",
                         help="Render the live status of the running merge "
                              "service daemon (SEMMERGE_SERVICE_SOCKET or the "
                              "default socket) instead of an artifact")
    p_stats.add_argument("--fleet", action="store_true",
                         help="With --daemon against a fleet router: the router "
                              "status plus every member's block (one member_status "
                              "round trip); with --prometheus the federated /metrics")
    p_trace = sub.add_parser("trace", help="Trace-artifact tooling")
    trace_sub = p_trace.add_subparsers(dest="trace_command", required=True)
    p_analyze = trace_sub.add_parser(
        "analyze",
        help="Per-request critical-path latency attribution from a "
             ".semmerge-trace.json or postmortem bundle (p50/p99 over a "
             "directory of them)")
    p_analyze.add_argument("artifact",
                           help="Trace or postmortem artifact, or a "
                                "directory of them")
    p_analyze.add_argument("--json", action="store_true",
                           help="Emit the breakdown as JSON")
    p_analyze.add_argument("--fleet", action="store_true",
                           help="Router-hop attribution for stitched fleet traces "
                                "(route / wal_fsync / relay / hedge_wait / "
                                "member_execute)")
    p_analyze.add_argument("--since", default=None, metavar="DURATION",
                           help="Directory mode: only artifacts modified "
                                "within DURATION (e.g. 90s, 15m, 2h, 1d)")
    p_tdiff = trace_sub.add_parser(
        "diff",
        help="Phase-aligned diff of two trace artifacts (A = offender, "
             "B = baseline): per-phase ms delta/ratio, top contributor "
             "named suspect_phase")
    p_tdiff.add_argument("a", help="Offender artifact (trace or postmortem bundle)")
    p_tdiff.add_argument("b", help="Baseline artifact")
    p_tdiff.add_argument("--json", action="store_true",
                         help="Emit the diff as JSON")
    p_top = sub.add_parser(
        "top",
        help="Live one-screen dashboard of the merge service daemon: QPS, "
             "windowed p50/p99, queue depth, breaker states, residency hit "
             "rate, mesh occupancy — polled from the daemon status "
             "(keys: q quit, p pause)")
    p_top.add_argument("--socket", default=None,
                       help="Daemon socket (default: the serve socket "
                            "resolution chain)")
    p_top.add_argument("--interval", type=float, default=2.0,
                       help="Poll interval seconds (default 2.0)")
    p_top.add_argument("--once", action="store_true",
                       help="Print a single frame and exit (scripts/CI; "
                            "also the non-TTY behavior)")
    p_top.add_argument("--json", action="store_true",
                       help="With --once: emit the frame's source data "
                            "as JSON instead of the rendering")

    p_profile = sub.add_parser(
        "profile",
        help="Capture a bounded torch.profiler trace + metrics delta from "
             "a RUNNING merge service daemon")
    p_profile.add_argument("--daemon", action="store_true", required=True,
                           help="Required: captures come from the live "
                                "daemon (one-shot runs use --profile DIR "
                                "on the merge verbs instead)")
    p_profile.add_argument("--seconds", type=float, default=1.0,
                           help="Capture window length (clamped to "
                                "[0.1, 60]; default 1.0)")
    p_profile.add_argument("--out", default=None,
                           help="Bundle parent directory (default: "
                                "SEMMERGE_PROFILE_DIR, else a "
                                "semmerge-profiles dir under the system "
                                "temp dir)")
    p_profile.add_argument("--socket", default=None,
                           help="Daemon socket path (default: the serve "
                                "socket resolution chain)")
    p_profile.add_argument("--json", action="store_true",
                           help="Emit the capture result as JSON")

    p_perf = sub.add_parser(
        "perf",
        help="Perf-regression sentinel: record bench snapshots into a "
             "baseline and compare new runs against it")
    perf_sub = p_perf.add_subparsers(dest="perf_command", required=True)
    p_rec = perf_sub.add_parser(
        "record", help="Normalize bench JSON snapshots (or a live "
                       "daemon latency window) into the baseline")
    p_rec.add_argument("snapshots", nargs="*",
                       help="BENCH_*.json files to record (key = file "
                            "stem minus the BENCH_ prefix)")
    p_rec.add_argument("--baseline", default=None,
                       help="Baseline path (default ./PERF_BASELINE.json)")
    p_rec.add_argument("--key", default=None,
                       help="Override the baseline key (single snapshot "
                            "or --daemon only)")
    p_rec.add_argument("--daemon", action="store_true",
                       help="Record the live daemon's request-latency "
                            "window instead of files (key 'daemon')")
    p_rec.add_argument("--socket", default=None)
    p_cmp = perf_sub.add_parser(
        "compare", help="Compare snapshots against the baseline; exit 1 "
                        "on regression")
    p_cmp.add_argument("snapshots", nargs="*",
                       help="BENCH_*.json files to compare")
    p_cmp.add_argument("--baseline", default=None,
                       help="Baseline path (default ./PERF_BASELINE.json)")
    p_cmp.add_argument("--tolerance-pct", type=float, default=None,
                       help="Headline-value tolerance (default 10)")
    p_cmp.add_argument("--phase-tolerance-pct", type=float, default=None,
                       help="Per-phase wall tolerance (default 25)")
    p_cmp.add_argument("--daemon", action="store_true",
                       help="Compare the live daemon's latency window "
                            "against its recorded baseline entry")
    p_cmp.add_argument("--socket", default=None)
    p_cmp.add_argument("--json", action="store_true",
                       help="Emit findings as JSON")


def run(args: argparse.Namespace) -> int:
    """Run one of the artifact or live-service commands for parsed
    ``args``."""
    if args.command == "profile":
        return cmd_profile(args)
    if args.command == "perf":
        return cmd_perf(args)
    if args.command == "top":
        return cmd_top(args)
    if args.command == "stats":
        if args.daemon:
            if args.fleet:
                return cmd_stats_fleet(args)
            return cmd_stats_daemon(args)
        return cmd_stats(args)
    if args.trace_command == "analyze":
        return cmd_trace_analyze(args)
    return cmd_trace_diff(args)


def cmd_stats_fleet(args: argparse.Namespace) -> int:
    """``stats --daemon --fleet``: one router round-trip
    (``member_status`` / federated ``metrics``) instead of N per-member
    socket addresses."""
    from ..service import client as service_client
    if getattr(args, "prometheus", False):
        try:
            result = service_client.call_control("metrics")
        except service_client.DaemonUnavailable as exc:
            print(f"error: no fleet router reachable ({exc})",
                  file=sys.stderr)
            return 1
        print(result.get("prometheus", ""), end="")
        return 0
    try:
        agg = service_client.call_control("member_status")
    except service_client.DaemonUnavailable as exc:
        print(f"error: no fleet router reachable ({exc})", file=sys.stderr)
        return 1
    if not isinstance(agg, dict) or "router" not in agg:
        print("error: peer is not a fleet router (plain daemon? drop "
              "--fleet)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(agg, indent=2, default=str))
        return 0
    router = agg.get("router") or {}
    members = agg.get("members") or {}
    up = router.get("members_up", 0)
    print(f"fleet pid={router.get('pid')} "
          f"uptime={router.get('uptime_s', 0.0):.1f}s "
          f"socket={router.get('socket')} "
          f"members_up={up}/{len(members)}")
    wal = router.get("wal") or {}
    print(f"requests: served={router.get('served_total', 0)} "
          f"in_flight={router.get('in_flight', 0)} "
          f"wal_open={wal.get('open', 0)} "
          f"wal_replayed={wal.get('replayed', 0)}")
    slo = router.get("slo")
    if slo:
        print(f"slo: {'healthy' if slo.get('healthy') else 'BURNING'}")
        for row in slo.get("objectives", ()):
            mark = "TRIPPED" if row.get("tripped") else "ok"
            print(f"  {mark:8s} {row.get('objective')}: "
                  f"burn fast={row.get('burn_fast', 0.0):.2f}x "
                  f"slow={row.get('burn_slow', 0.0):.2f}x")
    for member_id in sorted(members):
        st = members[member_id]
        if not isinstance(st, dict):
            print(f"member {member_id}: unreachable")
            continue
        state = st.get("state")
        if not st.get("ok"):
            # draining is a deliberate departure; dead is a failure —
            # the rollup keeps them distinct.
            print(f"member {member_id}: {state or 'unreachable'}")
            continue
        decl_rate = st.get("declcache_hit_rate", 0.0) or 0.0
        res_rate = (st.get("residency") or {}).get("hit_rate", 0.0) or 0.0
        print(f"member {member_id}: "
              f"{state or 'ready'} pid={st.get('pid')} "
              f"served={st.get('served_total', 0)} "
              f"queue_depth={st.get('queue_depth', 0)} "
              f"in_flight={st.get('in_flight', 0)} "
              f"rss_mb={st.get('rss_mb', 0.0):.1f} "
              f"declcache_hit_rate={decl_rate:.3f} "
              f"residency_hit_rate={res_rate:.3f}")
    return 0


def cmd_stats_daemon(args: argparse.Namespace) -> int:
    """``stats --daemon``: the running daemon's status (``--json``), its
    registry (``--prometheus``) or the JAX CLI's one-screen rendering."""
    from ..service import client as service_client
    try:
        status = service_client.call_control("status")
    except service_client.DaemonUnavailable as exc:
        print(f"error: no merge service daemon reachable ({exc})", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(status, indent=2, default=str))
        return 0
    if args.prometheus:
        print(render_prometheus_from_dict(status.get("metrics", {})), end="")
        return 0
    decl = status.get("declcache") or {}
    print(f"daemon pid={status.get('pid')} "
          f"uptime={status.get('uptime_s', 0.0):.1f}s "
          f"socket={status.get('socket')}")
    print(f"requests: served={status.get('served_total', 0)} "
          f"queue_depth={status.get('queue_depth', 0)} "
          f"in_flight={status.get('in_flight', 0)} "
          f"workers={status.get('workers', 0)}")
    print(f"declcache: hit_rate={status.get('declcache_hit_rate', 0.0):.3f} "
          f"hits={decl.get('hits', 0)} misses={decl.get('misses', 0)} "
          f"evictions={decl.get('evictions', 0)} "
          f"entries={decl.get('entries', 0)}")
    res = status.get("residency")
    if res:
        ev = res.get("evictions") or {}
        print(f"residency: {'on' if res.get('enabled') else 'off'} "
              f"hit_rate={res.get('hit_rate', 0.0):.3f} "
              f"entries={res.get('entries', 0)} "
              f"bytes={res.get('bytes', 0)}/{res.get('budget_bytes', 0)} "
              f"evictions={sum(ev.values())}"
              + ("".join(f" {k}={v}" for k, v in sorted(ev.items())) if ev else ""))
    print(f"memory: rss_mb={status.get('rss_mb', 0.0):.1f} "
          f"repos_tracked={status.get('repos_tracked', 0)}")
    port = status.get("metrics_port")
    if port is not None:
        print(f"telemetry: http://127.0.0.1:{port} (/metrics, /healthz)")
    slo = status.get("slo")
    if slo:
        print(f"slo: {'healthy' if slo.get('healthy') else 'BURNING'} "
              f"(fast {slo.get('windows', {}).get('fast_s', 0):g}s / "
              f"slow {slo.get('windows', {}).get('slow_s', 0):g}s)")
        for row in slo.get("objectives", ()):
            mark = "TRIPPED" if row.get("tripped") else "ok"
            print(f"  {mark:8s} {row.get('objective')}: "
                  f"burn fast={row.get('burn_fast', 0.0):.2f}x "
                  f"slow={row.get('burn_slow', 0.0):.2f}x "
                  f"(n={row.get('samples_fast', 0)})")
        for verb, q in (slo.get("window_quantiles") or {}).items():
            print(f"  window {verb}: p50={q.get('p50_ms', 0.0):.1f}ms "
                  f"p99={q.get('p99_ms', 0.0):.1f}ms "
                  f"n={q.get('count', 0)} errors={q.get('errors', 0)}")
    batch = status.get("batch")
    if batch:
        cache = batch.get("program_cache") or {}
        print(f"batch: queue_depth={batch.get('queue_depth', 0)} "
              f"batches={batch.get('batches_total', 0)} "
              f"mean_batch_size={batch.get('mean_batch_size', 0.0):.2f} "
              f"padding_waste={batch.get('padding_waste_ratio', 0.0):.3f} "
              f"program_cache_hit_rate={cache.get('hit_rate', 0.0):.3f}")
    for line in _render_stats({"counters": status.get("metrics", {}).get("counters", {})}):
        print(line)
    return 0


def cmd_stats(args: argparse.Namespace) -> int:
    """Pretty-print an observability artifact: a ``.semmerge-trace.json``
    trace, a ``.semmerge-events.jsonl`` span/event stream, or a metrics
    registry dump (``SEMMERGE_METRICS=path``)."""
    path = pathlib.Path(args.artifact)
    if not path.is_file():
        print(f"error: no artifact at {path} (run `semmerge ... --trace` "
              f"or set SEMMERGE_METRICS=path first)", file=sys.stderr)
        return 1
    text = path.read_text(encoding="utf-8")
    if path.suffix == ".jsonl":
        rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        data = {"events_jsonl": rows}
    else:
        data = json.loads(text)
    if args.json:
        print(json.dumps(data, indent=2))
        return 0
    if args.prometheus:
        metrics = data.get("metrics") if "metrics" in data else data
        if not isinstance(metrics, dict) or not any(
                k in metrics for k in ("counters", "gauges", "histograms")):
            print("error: artifact carries no metrics section", file=sys.stderr)
            return 1
        print(render_prometheus_from_dict(metrics), end="")
        return 0
    try:
        for line in _render_stats(data):
            print(line)
    except BrokenPipeError:  # stats | head is a normal way to read it
        try:
            sys.stdout.close()
        except OSError:
            pass
    return 0


def _render_stats(data: dict) -> List[str]:
    out: List[str] = []

    def _spans_table(rows) -> None:
        agg: dict = {}
        for r in rows:
            key = (r.get("layer") or "-", r["name"])
            n, total = agg.get(key, (0, 0.0))
            agg[key] = (n + 1, total + float(r.get("seconds", 0.0)))
        out.append(f"{'layer':<10} {'span':<24} {'count':>5} {'total ms':>10}")
        for (layer, name), (n, total) in sorted(
                agg.items(), key=lambda kv: -kv[1][1]):
            out.append(f"{layer:<10} {name:<24} {n:>5} {total * 1e3:>10.1f}")

    if "events_jsonl" in data:  # .semmerge-events.jsonl
        rows = data["events_jsonl"]
        spans = [r for r in rows if r.get("type") == "span"]
        events = [r for r in rows if r.get("type") == "event"]
        out.append(f"events stream: {len(spans)} spans, {len(events)} events")
        _spans_table(spans)
        for e in events:
            out.append(f"event {e.get('name')} @{e.get('t_start')}s "
                       f"{e.get('fields', {})}")
        return out

    if "phases" in data:  # .semmerge-trace.json
        out.append(f"trace (schema {data.get('schema', 0)}): "
                   f"total {data.get('total_seconds', 0.0) * 1e3:.1f} ms")
        out.append(f"{'phase':<24} {'ms':>10}  meta")
        for p in data["phases"]:
            out.append(f"{p['name']:<24} {p['seconds'] * 1e3:>10.1f}  "
                       f"{p.get('meta', '')}")
        counters = data.get("counters", {})
        if counters:
            out.append("counters: " + "  ".join(
                f"{k}={v}" for k, v in sorted(counters.items())))
        spans = data.get("spans")
        if spans:
            out.append(f"spans ({len(spans)}):")
            _spans_table(spans)
        device = data.get("device")
        if isinstance(device, dict):
            out.append("device: " + "  ".join(
                f"{k}={device[k]}" for k in sorted(device)
                if not isinstance(device[k], (dict, list))))
            for k in ("transfer_bytes", "transfer_count",
                      "compile_cache_events"):
                if device.get(k):
                    out.append(f"device.{k}: " + "  ".join(
                        f"{kk}={vv}" for kk, vv in sorted(device[k].items())))
        return out

    if any(k in data for k in ("counters", "gauges", "histograms")):
        # SEMMERGE_METRICS registry dump.
        for kind in ("counters", "gauges"):
            for name, m in sorted(data.get(kind, {}).items()):
                for s in m.get("series", []):
                    labels = ",".join(f"{k}={v}" for k, v in
                                      sorted(s.get("labels", {}).items()))
                    out.append(f"{name}{{{labels}}} {s['value']}")
        for name, m in sorted(data.get("histograms", {}).items()):
            for s in m.get("series", []):
                labels = ",".join(f"{k}={v}" for k, v in
                                  sorted(s.get("labels", {}).items()))
                out.append(f"{name}{{{labels}}} count={s['count']} "
                           f"sum={s['sum']:.6f}")
        return out

    out.append("unrecognized artifact shape; try --json")
    return out


#: Critical-path buckets of ``semmerge trace analyze`` — where one
#: request's wall time went, in pipeline order.
#: Router-hop buckets of ``trace analyze --fleet`` — where one routed
#: request's wall time went across the fleet, in hop order.
FLEET_PATH_BUCKETS = ("route", "wal_fsync", "relay", "hedge_wait",
                      "member_execute")

CRITICAL_PATH_BUCKETS = ("queue_wait", "batch_window", "pack", "kernel",
                         "host_tail", "apply")

def _bucket_span(name: str, layer) -> str | None:
    """Map one span to its critical-path bucket (None = unattributed).
    Nested double counting is avoided by bucketing only the leaf phase
    splits (fused-engine records, batch spans, the CLI apply phase),
    never the wrapper spans that contain them."""
    if name == "service.queue_wait":
        return "queue_wait"
    if name == "batch.window":
        return "batch_window"
    if name == "batch.pack":
        return "pack"
    if name in ("kernel", "batch.dispatch", "h2d"):
        return "kernel"
    if name in ("fetch", "compose_decode", "chain_decode",
                "materialize_overlap", "batch.scatter") or \
            (name == "materialize" and layer != "cli"):
        return "host_tail"
    if name == "materialize" and layer == "cli":
        return "apply"
    return None


def _load_span_artifact(path: pathlib.Path) -> tuple[dict | None, int]:
    """Load one span-shaped artifact: ``(data, corrupt_lines)``.

    ``.jsonl`` artifacts (``.semmerge-events.jsonl`` and other span
    logs) are salvaged line by line — a truncated tail or a corrupt row
    skips that row and counts it instead of sinking the whole file, so
    ``trace analyze`` keeps working on exactly the artifacts written
    while something was going wrong."""
    if path.suffix == ".jsonl":
        try:
            text = path.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError):
            return None, 0
        rows, bad = [], 0
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(row, dict):
                rows.append(row)
        if not rows:
            return None, bad
        return {"spans": rows, "trace_id": None}, bad
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None, 0
    return data, 0


def _parse_duration(raw: str) -> float:
    """``90s`` / ``15m`` / ``2h`` / ``1d`` (bare numbers = seconds) →
    seconds. Raises ValueError on nonsense."""
    text = str(raw).strip().lower()
    scale = 1.0
    if text and text[-1] in "smhd":
        scale = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[text[-1]]
        text = text[:-1]
    value = float(text)
    if value < 0:
        raise ValueError(f"negative duration {raw!r}")
    return value * scale


def _analyze_artifact(path: pathlib.Path) -> dict | None:
    """One artifact's critical-path breakdown, or None when the file is
    not span-shaped (trace artifact or postmortem bundle)."""
    data, corrupt = _load_span_artifact(path)
    if not isinstance(data, dict) or not isinstance(data.get("spans"), list):
        return None
    buckets = {b: 0.0 for b in CRITICAL_PATH_BUCKETS}
    cli_total = 0.0
    for row in data["spans"]:
        if not isinstance(row, dict):
            continue
        name = row.get("name") or ""
        layer = row.get("layer")
        try:
            secs = float(row.get("seconds") or 0.0)
        except (TypeError, ValueError):
            continue
        if layer == "cli":
            cli_total += secs
        b = _bucket_span(name, layer)
        if b is not None:
            buckets[b] += secs
    # Wall estimate: the CLI phases cover the merge itself; queue wait
    # and the batch window happen before/around them. Engine-level
    # buckets (pack/kernel/host_tail) nest INSIDE the CLI merge phase,
    # so they attribute rather than extend the total.
    total = cli_total + buckets["queue_wait"] + buckets["batch_window"]
    accounted = sum(buckets.values())
    result = {
        "artifact": str(path),
        "trace_id": data.get("trace_id"),
        "reason": data.get("reason"),
        "total_seconds": round(total, 6),
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "other_seconds": round(max(total - accounted, 0.0), 6),
    }
    if corrupt:
        result["corrupt_lines"] = corrupt
    return result


def _analyze_fleet_artifact(path: pathlib.Path) -> dict | None:
    """One *stitched* fleet-trace artifact's router-hop breakdown, or
    None when the file is not span-shaped. Buckets are non-overlapping:
    member execute time is carved out of the relay legs that carried
    it, relay out of the route spans that contain them — so the shares
    attribute rather than double count."""
    data, corrupt = _load_span_artifact(path)
    if not isinstance(data, dict) or not isinstance(data.get("spans"), list):
        return None
    wal = hedge_wait = relay_ok = route_like = 0.0
    member_exec = member_queue = 0.0
    for row in data["spans"]:
        if not isinstance(row, dict):
            continue
        name = row.get("name") or ""
        meta = row.get("meta") if isinstance(row.get("meta"), dict) else {}
        try:
            secs = float(row.get("seconds") or 0.0)
        except (TypeError, ValueError):
            continue
        if name == "fleet.wal_fsync":
            wal += secs
        elif name == "fleet.hedge_wait":
            hedge_wait += secs
        elif name == "fleet.relay" and meta.get("outcome") == "ok":
            relay_ok += secs
        elif name in ("fleet.route", "fleet.failover"):
            route_like += secs
        elif name == "service.execute" and "member" in meta:
            member_exec += secs
        elif name == "service.queue_wait" and "member" in meta:
            member_queue += secs
    buckets = {
        # Router-side routing overhead: the route/failover windows
        # minus the relay legs and hedge wait nested inside them.
        "route": max(route_like - relay_ok - hedge_wait, 0.0),
        "wal_fsync": wal,
        # Wire + framing overhead of the winning legs, net of the
        # member-side work the legs carried.
        "relay": max(relay_ok - member_exec - member_queue, 0.0),
        "hedge_wait": hedge_wait,
        "member_execute": member_exec,
    }
    total = wal + route_like
    accounted = sum(buckets.values())
    result = {
        "artifact": str(path),
        "trace_id": data.get("trace_id"),
        "reason": data.get("reason"),
        "total_seconds": round(total, 6),
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "other_seconds": round(max(total - accounted, 0.0), 6),
    }
    if corrupt:
        result["corrupt_lines"] = corrupt
    return result


def _pctl(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def cmd_trace_analyze(args: argparse.Namespace) -> int:
    """Per-request latency attribution from trace/postmortem artifacts:
    one file → its critical-path breakdown; a directory → p50/p99 per
    bucket over every span-shaped artifact in it."""
    fleet = bool(getattr(args, "fleet", False))
    analyze = _analyze_fleet_artifact if fleet else _analyze_artifact
    order = FLEET_PATH_BUCKETS if fleet else CRITICAL_PATH_BUCKETS
    path = pathlib.Path(args.artifact)
    since_s = None
    if getattr(args, "since", None):
        try:
            since_s = _parse_duration(args.since)
        except (ValueError, KeyError):
            print(f"error: bad --since duration {args.since!r} "
                  f"(want e.g. 90s, 15m, 2h, 1d)", file=sys.stderr)
            return 2
    if path.is_dir():
        candidates = sorted(list(path.glob("*.json"))
                            + list(path.glob("*.jsonl")))
        if since_s is not None:
            cutoff = time.time() - since_s
            aged = len(candidates)
            candidates = [p for p in candidates
                          if p.stat().st_mtime >= cutoff]
            aged -= len(candidates)
        else:
            aged = 0
        results, skipped, corrupt_lines = [], 0, 0
        for p in candidates:
            r = analyze(p)
            if r is None:
                skipped += 1
                continue
            corrupt_lines += int(r.pop("corrupt_lines", 0) or 0)
            results.append(r)
        if skipped or corrupt_lines:
            # Rotated/chaos-era dirs legitimately hold truncated or
            # corrupt artifacts; report what was passed over instead
            # of crashing on it or hiding it.
            parts = []
            if skipped:
                parts.append(f"{skipped} corrupt/non-span artifact(s)")
            if corrupt_lines:
                parts.append(f"{corrupt_lines} corrupt JSONL line(s)")
            print(f"note: skipped {', '.join(parts)} under {path}",
                  file=sys.stderr)
        if not results:
            print(f"error: no span-shaped artifacts under {path}"
                  + (f" within the last {args.since}" if since_s is not None
                     and aged else ""),
                  file=sys.stderr)
            return 1
        summary = {
            "requests": len(results),
            "skipped": skipped,
            "corrupt_lines": corrupt_lines,
            "p50": {}, "p99": {},
            "results": results,
        }
        for bucket in order + ("other_seconds", "total_seconds"):
            vals = [r["buckets"].get(bucket, r.get(bucket, 0.0))
                    if bucket in order else r.get(bucket, 0.0)
                    for r in results]
            summary["p50"][bucket] = round(_pctl(vals, 0.50), 6)
            summary["p99"][bucket] = round(_pctl(vals, 0.99), 6)
        if args.json:
            print(json.dumps(summary, indent=2))
            return 0
        what = "router-hop path" if fleet else "critical path"
        print(f"{what} over {len(results)} request artifact(s):")
        print(f"{'bucket':<14} {'p50 ms':>10} {'p99 ms':>10}")
        for bucket in order + ("other_seconds", "total_seconds"):
            label = bucket.replace("_seconds", "")
            print(f"{label:<14} {summary['p50'][bucket] * 1e3:>10.1f} "
                  f"{summary['p99'][bucket] * 1e3:>10.1f}")
        return 0
    if not path.is_file():
        print(f"error: no artifact at {path}", file=sys.stderr)
        return 1
    result = analyze(path)
    if result is None:
        print(f"error: {path} is not a span-shaped trace or postmortem "
              f"artifact", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, indent=2))
        return 0
    tid = result.get("trace_id") or "-"
    print(f"trace {tid}: total {result['total_seconds'] * 1e3:.1f} ms")
    print(f"{'bucket':<14} {'ms':>10} {'share':>7}")
    total = result["total_seconds"] or 1.0
    for bucket in order:
        v = result["buckets"][bucket]
        print(f"{bucket:<14} {v * 1e3:>10.1f} {v / total:>6.1%}")
    v = result["other_seconds"]
    print(f"{'other':<14} {v * 1e3:>10.1f} {v / total:>6.1%}")
    return 0


def _artifact_phases(path: pathlib.Path) -> tuple[dict | None, str]:
    """Per-phase wall seconds of one artifact, plus its display id.
    Accepts span-shaped artifacts (traces, postmortem bundles) and
    the JAX package's triage bundles (whose ``offender.phases_ms`` is
    already a phase map)."""
    data, _corrupt = _load_span_artifact(path)
    if not isinstance(data, dict):
        return None, "-"
    tid = str(data.get("trace_id") or "-")
    triage = data.get("triage")
    if isinstance(triage, dict) and isinstance(
            triage.get("offender"), dict):
        phases_ms = triage["offender"].get("phases_ms") or {}
        return ({str(k): float(v) / 1000.0 for k, v in phases_ms.items()},
                str(triage["offender"].get("trace_id") or tid))
    spans = data.get("spans")
    if not isinstance(spans, list):
        return None, tid
    phases: dict = {}
    for row in spans:
        if not isinstance(row, dict):
            continue
        name = str(row.get("name") or "?")
        try:
            phases[name] = phases.get(name, 0.0) + \
                float(row.get("seconds") or 0.0)
        except (TypeError, ValueError):
            continue
    return phases, tid


def cmd_trace_diff(args: argparse.Namespace) -> int:
    """Phase-aligned diff of two artifacts (same diff rows and
    suspect_phase semantics as the JAX CLI, via
    :func:`obs.anomaly.phase_diff`)."""
    path_a, path_b = pathlib.Path(args.a), pathlib.Path(args.b)
    for path in (path_a, path_b):
        if not path.is_file():
            print(f"error: no artifact at {path}", file=sys.stderr)
            return 1
    a_phases, a_id = _artifact_phases(path_a)
    b_phases, b_id = _artifact_phases(path_b)
    if a_phases is None or b_phases is None:
        bad = path_a if a_phases is None else path_b
        print(f"error: {bad} is not a span-shaped trace artifact",
              file=sys.stderr)
        return 1
    diff = obs_anomaly.phase_diff(a_phases, b_phases)
    result = {"a": {"artifact": str(path_a), "trace_id": a_id},
              "b": {"artifact": str(path_b), "trace_id": b_id},
              "suspect_phase": diff["suspect_phase"],
              "phases": diff["phases"]}
    if args.json:
        print(json.dumps(result, indent=2))
        return 0
    print(f"trace diff  A={a_id}  B={b_id}")
    print(f"{'phase':<24} {'A ms':>10} {'B ms':>10} {'delta':>10} "
          f"{'ratio':>7}")
    for row in diff["phases"]:
        ratio = f"{row['ratio']:.2f}x" if row["ratio"] is not None else "-"
        print(f"{row['phase']:<24} {row['a_ms']:>10.1f} "
              f"{row['b_ms']:>10.1f} {row['delta_ms']:>+10.1f} "
              f"{ratio:>7}")
    if diff["suspect_phase"]:
        print(f"suspect phase: {diff['suspect_phase']}")
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    """On-demand profile capture from the live daemon (the ``profile``
    wire verb). The daemon holds a single-capture lock; a concurrent
    capture answers ``ok=False`` without disturbing the running one."""
    from ..service import client as service_client
    try:
        result = service_client.capture_profile(
            args.seconds, out_dir=args.out, path=args.socket)
    except service_client.DaemonUnavailable as exc:
        print(f"error: no merge service daemon reachable ({exc})",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, indent=2, default=str))
        return 0 if result.get("ok") else 1
    if not result.get("ok"):
        print(f"error: profile capture failed: "
              f"{result.get('error', 'unknown')}", file=sys.stderr)
        return 1
    print(f"profile bundle: {result.get('dir')}")
    print(f"  window: {result.get('seconds', 0.0):g}s  "
          f"profiler_started={result.get('profiler_started')}")
    for name in result.get("files", ()):
        print(f"  {name}")
    return 0


def cmd_perf(args: argparse.Namespace) -> int:
    """Perf-regression sentinel (``perf record|compare``): thin CLI over
    :mod:`semantic_merge_tpu_torch.obs.perf`."""
    from . import perf as obs_perf
    from ..utils import workdir
    baseline_path = pathlib.Path(args.baseline) if args.baseline \
        else workdir.root() / obs_perf.BASELINE_NAME

    def _daemon_entry() -> dict | None:
        from ..service import client as service_client
        try:
            status = service_client.call_control("status",
                                                 path=args.socket)
        except service_client.DaemonUnavailable as exc:
            print(f"error: no merge service daemon reachable ({exc})",
                  file=sys.stderr)
            return None
        return obs_perf.daemon_entry(status)

    def _load_entries() -> dict | None:
        entries: dict = {}
        if args.daemon:
            entry = _daemon_entry()
            if entry is None:
                return None
            entries[getattr(args, "key", None) or "daemon"] = entry
        for raw in args.snapshots:
            path = pathlib.Path(raw)
            try:
                record = json.loads(path.read_text(encoding="utf-8"))
            except (OSError, ValueError) as exc:
                print(f"error: cannot read snapshot {path}: {exc}",
                      file=sys.stderr)
                return None
            key = args.key if getattr(args, "key", None) \
                and len(args.snapshots) == 1 and not args.daemon \
                else obs_perf.record_key(path)
            entries[key] = obs_perf.normalize_record(record,
                                                     source=str(path))
        if not entries:
            print("error: nothing to process (pass snapshot files or "
                  "--daemon)", file=sys.stderr)
            return None
        return entries

    if args.perf_command == "record":
        entries = _load_entries()
        if entries is None:
            return 2
        existing: dict = {}
        if baseline_path.is_file():
            try:
                existing = obs_perf.load_baseline(baseline_path)["entries"]
            except (OSError, ValueError) as exc:
                print(f"error: unreadable baseline {baseline_path}: {exc}",
                      file=sys.stderr)
                return 2
        existing.update(entries)
        obs_perf.save_baseline(baseline_path, existing)
        print(f"recorded {len(entries)} entr"
              f"{'y' if len(entries) == 1 else 'ies'} into "
              f"{baseline_path}: {', '.join(sorted(entries))}")
        return 0

    # compare
    if not baseline_path.is_file():
        print(f"error: no baseline at {baseline_path} (record one with "
              f"'semmerge perf record')", file=sys.stderr)
        return 2
    try:
        baseline = obs_perf.load_baseline(baseline_path)
    except (OSError, ValueError) as exc:
        print(f"error: unreadable baseline {baseline_path}: {exc}",
              file=sys.stderr)
        return 2
    entries = _load_entries()
    if entries is None:
        return 2
    tol = args.tolerance_pct if args.tolerance_pct is not None \
        else obs_perf.DEFAULT_TOLERANCE_PCT
    ptol = args.phase_tolerance_pct \
        if args.phase_tolerance_pct is not None \
        else obs_perf.DEFAULT_PHASE_TOLERANCE_PCT
    ok, findings = obs_perf.compare_many(
        entries, baseline, tolerance_pct=tol, phase_tolerance_pct=ptol)
    if getattr(args, "json", False):
        print(json.dumps({"ok": ok, "findings": findings}, indent=2))
    else:
        print(f"perf compare vs {baseline_path}: "
              f"{'OK' if ok else 'REGRESSION'}")
        print(obs_perf.format_findings(findings))
    return 0 if ok else 1


def _top_fetch(socket_path: str | None) -> dict:
    """One poll of the dashboard's data: the daemon's status, plus the
    member statuses when the status says ``fleet`` (a port daemon never
    does; the renderer takes both shapes as data)."""
    from ..service.client import call_control
    status = call_control("status", path=socket_path)
    members = None
    if status.get("fleet"):
        try:
            members = call_control("member_status",
                                   path=socket_path).get("members")
        except Exception:
            members = None
    return {"status": status, "members": members}


def _render_top_frame(snap: dict) -> str:
    """One dashboard screen from a :func:`_top_fetch` snapshot (the JAX
    CLI's frame, character for character)."""
    status = snap["status"]
    lines: List[str] = []
    fleet = bool(status.get("fleet"))
    window = status.get("window") or {}
    w1s, w1m = window.get("1s") or {}, window.get("1m") or {}
    head = "fleet router" if fleet else "merge daemon"
    lines.append(
        f"semmerge top — {head} pid {status.get('pid')}  "
        f"uptime {status.get('uptime_s', 0):.0f}s  "
        f"socket {status.get('socket')}")
    lines.append(
        f"  qps {w1s.get('qps', 0):>7.1f}/s (1s) {w1m.get('qps', 0):>7.2f}/s (1m)   "
        f"p50 {w1m.get('p50_ms', 0):>8.1f} ms   "
        f"p99 {w1m.get('p99_ms', 0):>8.1f} ms   "
        f"err {w1m.get('error_rate', 0):>6.2%}")
    res = status.get("resilience") or {}
    breakers = res.get("breakers") or {}
    tripped = sorted(n for n, s in breakers.items() if s != "closed")
    lines.append(
        f"  queue {status.get('queue_depth', 0):>3}  "
        f"in-flight {status.get('in_flight', 0):>3}  "
        f"served {status.get('served_total', 0):>6}  "
        f"pressure {res.get('pressure', '-')}  "
        f"breakers {('OPEN:' + ','.join(tripped)) if tripped else 'closed'}")
    residency = status.get("residency") or {}
    r_hit = (f"{residency.get('hit_rate', 0.0):.1%}"
             if residency.get("lookups") else "-")
    batch = status.get("batch") or {}
    mesh = batch.get("mesh") or {}
    mesh_occ = mesh.get("last_rows_per_chip")
    sampling = status.get("sampling") or {}
    store = status.get("trace_store") or {}
    lines.append(
        f"  residency hit {r_hit}  "
        f"mesh occupancy {mesh_occ if mesh_occ is not None else '-'}  "
        f"sampling {'on' if sampling.get('enabled') else 'keep-all'}  "
        f"trace store {store.get('count', '-')} files"
        + (f" ({store.get('bytes', 0) / 1048576.0:.1f}/"
           f"{store.get('budget_bytes', 0) / 1048576.0:.0f} MB)"
           if store else ""))
    anomaly = status.get("anomaly") or {}
    if anomaly.get("latched"):
        lines.append(f"  ANOMALY latched: {', '.join(anomaly['latched'])}"
                     f"  (bundles fired: {anomaly.get('fired', 0)})")
    slo = status.get("slo")
    if isinstance(slo, dict):
        lines.append(f"  slo {'HEALTHY' if slo.get('healthy', True) else 'BURNING'}")
    members = snap.get("members")
    if fleet:
        lines.append("")
        lines.append(f"  {'member':<8} {'state':<10} {'qps(1m)':>8} "
                     f"{'p99 ms':>8} {'queue':>6} {'in-fl':>6} "
                     f"{'served':>7}")
        rows = status.get("members") or []
        by_id = {}
        if isinstance(members, dict):
            by_id = {mid: m for mid, m in members.items()
                     if isinstance(m, dict)}
        for view in rows:
            if not isinstance(view, dict):
                continue
            mid = str(view.get("id") or "?")
            mstat = by_id.get(mid) or {}
            mwin = (mstat.get("window") or {}).get("1m") or {}
            lines.append(
                f"  {mid:<8} {str(view.get('state', '?')):<10} "
                f"{mwin.get('qps', 0):>8.2f} "
                f"{mwin.get('p99_ms', 0):>8.1f} "
                f"{mstat.get('queue_depth', 0):>6} "
                f"{mstat.get('in_flight', 0):>6} "
                f"{mstat.get('served_total', 0):>7}")
    return "\n".join(lines)


def cmd_top(args: argparse.Namespace) -> int:
    """Live one-screen dashboard. Interactive on a TTY (q quits,
    p pauses); ``--once`` (or a non-TTY stdout) prints one frame and
    exits, so scripts and tests get a stable surface."""
    from ..service.client import DaemonUnavailable
    interactive = (not args.once and sys.stdout.isatty()
                   and sys.stdin.isatty())
    try:
        snap = _top_fetch(args.socket)
    except DaemonUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    if not interactive:
        if args.json:
            print(json.dumps(snap, indent=2, default=str))
        else:
            print(_render_top_frame(snap))
        return 0
    import os
    import select
    import termios
    import tty
    fd = sys.stdin.fileno()
    old_attrs = termios.tcgetattr(fd)
    paused = False
    try:
        tty.setcbreak(fd)
        while True:
            if not paused:
                try:
                    snap = _top_fetch(args.socket)
                    frame = _render_top_frame(snap)
                except DaemonUnavailable as exc:
                    frame = f"daemon unreachable: {exc}"
                sys.stdout.write("\x1b[2J\x1b[H" + frame
                                 + "\n\n  q quit · p pause\n")
                sys.stdout.flush()
            ready, _, _ = select.select([fd], [], [],
                                        max(0.2, args.interval))
            if ready:
                key = os.read(fd, 1).decode("utf-8", "replace").lower()
                if key == "q":
                    return 0
                if key == "p":
                    paused = not paused
    except KeyboardInterrupt:
        return 0
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old_attrs)
        sys.stdout.write("\n")
