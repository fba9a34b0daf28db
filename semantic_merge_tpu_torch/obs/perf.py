"""Perf-regression sentinel — normalize bench snapshots, keep a
machine-readable trajectory, compare against a baseline (the port of
the JAX package's ``obs/perf.py``, the core behind ``perf
record|compare``; the same entry shapes, tolerances, findings and file
formats):

- :func:`normalize_record` reduces a bench record (or a live daemon
  window snapshot, :func:`daemon_entry`) to the comparable surface:
  headline ``value`` + ``unit``, the ``phases_ms`` split, the guarded
  fields and the metric description;
- a baseline file (:func:`load_baseline`/:func:`save_baseline`) maps
  snapshot keys (``r05``, ``tpu_rung5``, ``daemon`` …) to normalized
  entries;
- :func:`compare_entry` applies unit-aware direction (``*/sec`` is
  higher-better; ``ms``/``s``/``pct`` lower-better; phase walls always
  lower-better) with separate headline and per-phase tolerance bands;
- :func:`append_trajectory` appends a record to a JSONL trajectory
  (override: ``SEMMERGE_BENCH_TRAJECTORY``).

The default file names (:data:`BASELINE_NAME`, :data:`TRAJECTORY_NAME`)
are the JAX package's, and the checkout's own ``PERF_BASELINE.json``
and ``BENCH_trajectory.jsonl`` hold the TPU's numbers: point
``--baseline`` and ``SEMMERGE_BENCH_TRAJECTORY`` elsewhere, or run from
a working directory outside the checkout. Stdlib-only, like the rest of
:mod:`semantic_merge_tpu_torch.obs`.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Dict, List, Optional, Tuple

BASELINE_SCHEMA = 1
#: Default artifact names, resolved against the repo root by callers.
BASELINE_NAME = "PERF_BASELINE.json"
TRAJECTORY_NAME = "BENCH_trajectory.jsonl"
ENV_TRAJECTORY = "SEMMERGE_BENCH_TRAJECTORY"

DEFAULT_TOLERANCE_PCT = 10.0
DEFAULT_PHASE_TOLERANCE_PCT = 25.0
#: Phases faster than this in the baseline are noise, not signal.
MIN_PHASE_MS = 5.0

#: Units where a larger number is better.
_HIGHER_BETTER_SUFFIXES = ("/sec", "/s")

#: Bench-record fields (beyond the headline ``value``) carried into
#: baseline entries and compared with the headline tolerance. The
#: direction is explicit because these are unitless ratios, not
#: suffix-typed rates: the batchserve chips axis must not silently
#: lose mesh scaling efficiency or per-chip throughput.
GUARDED_FIELDS = {
    "scaling_efficiency": "higher",
    "merges_per_sec_per_chip": "higher",
    # Fleet preset: the single-member floor and the 3-member headline
    # must not regress, and the rendezvous rehash quality (fraction of
    # keys that move owners on a single-member loss; lower-better) must
    # stay near 1/N rather than drifting toward a mod-N ring's ~1.0.
    "fleet_merges_per_sec_m1": "higher",
    "fleet_merges_per_sec_m3": "higher",
    "fleet_rehash_miss_rate": "lower",
    # Fleetwan preset (cross-host fleet over TCP with injected dial
    # latency): the post-churn rehash miss rate — cold dispatches after
    # one elastic join + one drain, with the incremental handoff
    # prewarming moved keys — must stay under the 0.15 gate instead of
    # drifting back toward the unassisted ~1/N rendezvous rehash.
    "fleetwan_rehash_miss_rate": "lower",
    # Tracecost preset, fleet leg: what the stitched observability
    # plane (member span shipping + router grafting + artifact/OTLP
    # sealing) costs a routed merge, as a percent of the dark fleet's
    # median latency. The baseline entry anchors this at the 2%
    # budget rather than a (noise-floor) measurement, so the guard
    # trips exactly when the budget does.
    "fleet_trace_overhead_pct": "lower",
    # Telcost preset: the full per-request telemetry pipeline
    # (sampling verdict + window rollup + anomaly observation + trace
    # store write) as a percent of dark merge latency. Like the fleet
    # trace leg, the baseline anchors the documented 2% budget so the
    # guard trips exactly when the budget does.
    "telemetry_overhead_pct": "lower",
    # Devtail preset: the post-kernel host tail
    # (compose_materialize + serialize, disjoint accounting) must not
    # creep back up once the device-render path owns serialization, and
    # the repeat-base leg's residency hit rate must stay warm — a cold
    # cache means scan_encode+h2d are back on the critical path.
    "host_tail_ms": "lower",
    "residency_hit_rate": "higher",
}


def higher_is_better(unit: str) -> bool:
    return str(unit).endswith(_HIGHER_BETTER_SUFFIXES)


def record_key(path: pathlib.Path | str) -> str:
    """Baseline key for a snapshot file: the stem minus the ``BENCH_``
    prefix (``BENCH_r05.json`` → ``r05``)."""
    stem = pathlib.Path(path).stem
    return stem[6:] if stem.startswith("BENCH_") else stem


def normalize_record(record: dict, *, source: Optional[str] = None
                     ) -> dict:
    """Reduce one bench record to the comparable entry shape."""
    entry = {
        "metric": str(record.get("metric", "")),
        "value": float(record.get("value", 0.0)),
        "unit": str(record.get("unit", "")),
        "recorded_at": round(time.time(), 3),
    }
    phases = record.get("phases_ms")
    if isinstance(phases, dict) and phases:
        entry["phases_ms"] = {str(k): float(v)
                              for k, v in sorted(phases.items())}
    guarded = {name: float(record[name]) for name in sorted(GUARDED_FIELDS)
               if isinstance(record.get(name), (int, float))}
    if guarded:
        entry["guarded"] = guarded
    if record.get("error"):
        entry["error"] = str(record["error"])
    if source:
        entry["source"] = str(source)
    return entry


def daemon_entry(status: dict) -> dict:
    """Normalize a live daemon ``status`` payload into a baseline
    entry: overall request p99 as the headline (lower-better), per-verb
    p50/p99 as the phase split. Prefers the SLO engine's sliding-window
    quantiles when present (current traffic), falling back to the
    cumulative ``service_request_seconds`` histogram."""
    phases: Dict[str, float] = {}
    worst_p99 = 0.0
    slo = status.get("slo") or {}
    quantiles = slo.get("window_quantiles") or {}
    if quantiles:
        for verb, row in quantiles.items():
            phases[f"{verb}_p50"] = float(row.get("p50_ms", 0.0))
            phases[f"{verb}_p99"] = float(row.get("p99_ms", 0.0))
            worst_p99 = max(worst_p99, float(row.get("p99_ms", 0.0)))
        source = "slo-window"
    else:
        from . import metrics as obs_metrics
        hists = (status.get("metrics") or {}).get("histograms") or {}
        hist = hists.get("service_request_seconds") or {}
        buckets = hist.get("buckets") or list(obs_metrics.PHASE_BUCKETS)
        for series in hist.get("series", ()):
            verb = series.get("labels", {}).get("verb", "?")
            counts = series.get("counts", ())
            p50 = obs_metrics.histogram_quantile(buckets, counts, 0.50)
            p99 = obs_metrics.histogram_quantile(buckets, counts, 0.99)
            phases[f"{verb}_p50"] = round(p50 * 1e3, 3)
            phases[f"{verb}_p99"] = round(p99 * 1e3, 3)
            worst_p99 = max(worst_p99, p99 * 1e3)
        source = "cumulative-histogram"
    return normalize_record({
        "metric": "live daemon per-verb request latency (worst p99)",
        "value": round(worst_p99, 3),
        "unit": "ms",
        "phases_ms": phases,
    }, source=source)


# ---------------------------------------------------------------------------
# Baseline IO

def load_baseline(path: pathlib.Path | str) -> dict:
    data = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(f"{path}: not a perf baseline (no 'entries')")
    return data


def save_baseline(path: pathlib.Path | str, entries: Dict[str, dict]
                  ) -> None:
    payload = {"schema": BASELINE_SCHEMA,
               "entries": {k: entries[k] for k in sorted(entries)}}
    pathlib.Path(path).write_text(
        json.dumps(payload, indent=2, sort_keys=True) + "\n",
        encoding="utf-8")


# ---------------------------------------------------------------------------
# Comparison

def _delta_pct(current: float, baseline: float) -> float:
    if baseline == 0.0:
        return 0.0
    return (current - baseline) / abs(baseline) * 100.0


def compare_entry(key: str, current: dict, baseline: dict, *,
                  tolerance_pct: float = DEFAULT_TOLERANCE_PCT,
                  phase_tolerance_pct: float = DEFAULT_PHASE_TOLERANCE_PCT,
                  min_phase_ms: float = MIN_PHASE_MS) -> List[dict]:
    """Compare one normalized entry against its baseline entry.
    Returns one finding per compared field; a finding with
    ``regression=True`` means the field moved past its tolerance in
    the bad direction."""
    findings: List[dict] = []
    cur_v = float(current.get("value", 0.0))
    base_v = float(baseline.get("value", 0.0))
    unit = str(baseline.get("unit", current.get("unit", "")))
    delta = _delta_pct(cur_v, base_v)
    bad = -delta if higher_is_better(unit) else delta
    findings.append({
        "key": key, "field": "value", "unit": unit,
        "current": cur_v, "baseline": base_v,
        "delta_pct": round(delta, 2),
        "tolerance_pct": tolerance_pct,
        "regression": bad > tolerance_pct,
    })
    base_guarded = baseline.get("guarded") or {}
    cur_guarded = current.get("guarded") or {}
    for name in sorted(set(base_guarded) & set(cur_guarded)):
        bg, cg = float(base_guarded[name]), float(cur_guarded[name])
        gdelta = _delta_pct(cg, bg)
        gbad = -gdelta if GUARDED_FIELDS.get(name) == "higher" else gdelta
        findings.append({
            "key": key, "field": f"guarded.{name}", "unit": "ratio",
            "current": cg, "baseline": bg,
            "delta_pct": round(gdelta, 2),
            "tolerance_pct": tolerance_pct,
            "regression": gbad > tolerance_pct,
        })
    base_phases = baseline.get("phases_ms") or {}
    cur_phases = current.get("phases_ms") or {}
    for phase in sorted(set(base_phases) & set(cur_phases)):
        bp, cp = float(base_phases[phase]), float(cur_phases[phase])
        if bp < min_phase_ms:
            continue
        pdelta = _delta_pct(cp, bp)
        findings.append({
            "key": key, "field": f"phases_ms.{phase}", "unit": "ms",
            "current": cp, "baseline": bp,
            "delta_pct": round(pdelta, 2),
            "tolerance_pct": phase_tolerance_pct,
            "regression": pdelta > phase_tolerance_pct,
        })
    return findings


def compare_many(entries: Dict[str, dict], baseline: dict, *,
                 tolerance_pct: float = DEFAULT_TOLERANCE_PCT,
                 phase_tolerance_pct: float = DEFAULT_PHASE_TOLERANCE_PCT
                 ) -> Tuple[bool, List[dict]]:
    """Compare every entry that has a baseline counterpart. Returns
    ``(ok, findings)``; entries missing from the baseline produce a
    non-regression ``missing-baseline`` finding (new presets must not
    fail the gate)."""
    findings: List[dict] = []
    base_entries = baseline.get("entries", {})
    for key in sorted(entries):
        if key not in base_entries:
            findings.append({"key": key, "field": "value",
                             "regression": False,
                             "note": "missing-baseline"})
            continue
        findings.extend(compare_entry(
            key, entries[key], base_entries[key],
            tolerance_pct=tolerance_pct,
            phase_tolerance_pct=phase_tolerance_pct))
    ok = not any(f["regression"] for f in findings)
    return ok, findings


def format_findings(findings: List[dict]) -> str:
    lines = []
    for f in findings:
        if f.get("note") == "missing-baseline":
            lines.append(f"  new   {f['key']}: no baseline entry "
                         f"(record one with 'semmerge perf record')")
            continue
        mark = "REGRESSION" if f["regression"] else "ok"
        lines.append(
            f"  {mark:10s} {f['key']}.{f['field']}: "
            f"{f['current']:g} vs {f['baseline']:g} {f.get('unit', '')} "
            f"({f['delta_pct']:+.1f}%, tol {f['tolerance_pct']:g}%)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Trajectory

def trajectory_path(root: pathlib.Path | str = ".") -> pathlib.Path:
    override = os.environ.get(ENV_TRAJECTORY, "").strip()
    if override:
        return pathlib.Path(override)
    return pathlib.Path(root) / TRAJECTORY_NAME


def append_trajectory(record: dict, *, preset: Optional[str] = None,
                      root: pathlib.Path | str = ".") -> Optional[pathlib.Path]:
    """Append one bench record to the trajectory file; returns the
    path, or ``None`` on write failure (the trajectory is a courtesy —
    it must never fail a bench run)."""
    row = dict(record)
    row.setdefault("ts", round(time.time(), 3))
    if preset:
        row.setdefault("preset", preset)
    try:
        path = trajectory_path(root)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(row, sort_keys=True) + "\n")
        return path
    except OSError:
        return None
