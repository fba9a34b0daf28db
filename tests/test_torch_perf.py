"""The port's perf sentinel, ``top`` frame and GC posture against the JAX
package's.

- ``obs/perf.py``: ``normalize_record``, ``record_key``,
  ``compare_many`` and ``format_findings`` over every committed
  ``BENCH_*.json`` against the committed ``PERF_BASELINE.json`` (read
  only), ``daemon_entry`` over both status shapes, and the trajectory
  (under ``tmp_path``), equal to the JAX module's (``recorded_at``, a
  clock reading, masked);
- ``perf record`` then ``perf compare`` in ``tmp_path``, in process:
  the JAX CLI's stdout, stderr and exit codes, a regression included
  (exit 1), a missing baseline (exit 2), and the baseline file's bytes;
- ``top``: ``_render_top_frame`` is the JAX frame character for
  character on the daemon-shaped and the fleet-shaped snapshots of
  ``tests/test_telemetry_pipeline.py``;
- the GC posture (``utils/gctune.py``): the JAX posture as shipped,
  skipped with ``SEMMERGE_GC_TUNE=0``, never from a request's overlay;
  the CLI runs it for ``semdiff``, ``semmerge`` and ``semrebase`` only,
  and the daemon turns it off for itself. Each test restores
  ``gc.get_threshold()`` and unfreezes the heap.

The daemon forms (``perf --daemon``, ``top`` against a live daemon) are
in ``tests/test_torch_service.py``.
"""
from __future__ import annotations

import gc
import json
import os
import pathlib

import pytest

from semantic_merge_tpu import cli as jax_cli
from semantic_merge_tpu.obs import perf as jax_perf
from semantic_merge_tpu.utils import gctune as jax_gctune
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.obs import perf, report
from semantic_merge_tpu_torch.utils import gctune, reqenv

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SNAPSHOTS = sorted(REPO_ROOT.glob("BENCH_*.json"))
BASELINE = REPO_ROOT / "PERF_BASELINE.json"


def _unclocked(obj):
    """``obj`` without its ``recorded_at`` clock readings."""
    if isinstance(obj, dict):
        return {k: _unclocked(v) for k, v in obj.items() if k != "recorded_at"}
    if isinstance(obj, list):
        return [_unclocked(v) for v in obj]
    return obj


# --- obs/perf.py ------------------------------------------------------------------------------

@pytest.mark.parametrize("path", SNAPSHOTS, ids=lambda p: p.name)
def test_normalize_and_compare_equal_the_jax_modules(path):
    record = json.loads(path.read_text())
    key = perf.record_key(path)
    assert key == jax_perf.record_key(path)
    entry = perf.normalize_record(record, source=str(path))
    assert _unclocked(entry) == _unclocked(jax_perf.normalize_record(record, source=str(path)))
    baseline = perf.load_baseline(BASELINE)
    assert baseline == jax_perf.load_baseline(BASELINE)
    for tol in ((10.0, 25.0), (0.0, 0.0)):
        port = perf.compare_many({key: entry}, baseline, tolerance_pct=tol[0],
                                 phase_tolerance_pct=tol[1])
        jax = jax_perf.compare_many({key: entry}, baseline, tolerance_pct=tol[0],
                                    phase_tolerance_pct=tol[1])
        assert port == jax
        assert perf.format_findings(port[1]) == jax_perf.format_findings(jax[1])


def test_every_baseline_entry_compares_as_in_the_jax_module():
    baseline = perf.load_baseline(BASELINE)
    entries = dict(baseline["entries"])
    entries["new_preset"] = {"value": 1.0, "unit": "ms"}
    slower = {k: dict(v, value=float(v.get("value", 0.0)) * 1.5) for k, v in entries.items()}
    for current in (entries, slower):
        port, jax = perf.compare_many(current, baseline), jax_perf.compare_many(current, baseline)
        assert port == jax
        assert perf.format_findings(port[1]) == jax_perf.format_findings(jax[1])
    assert perf.compare_many(slower, baseline)[0] is False
    assert perf.GUARDED_FIELDS == jax_perf.GUARDED_FIELDS
    for unit in ("merges/sec", "files/s", "ms", "s", "pct", ""):
        assert perf.higher_is_better(unit) == jax_perf.higher_is_better(unit)


_HIST = {"buckets": [0.01, 0.1, 1.0],
         "series": [{"labels": {"verb": "semdiff"}, "counts": [1, 5, 2, 0]},
                    {"labels": {"verb": "semmerge"}, "counts": [0, 1, 1, 1]}]}
STATUSES = {
    "slo-window": {"slo": {"window_quantiles": {
        "semdiff": {"p50_ms": 12.5, "p99_ms": 80.0},
        "semmerge": {"p50_ms": 40.0, "p99_ms": 300.25}}}},
    "cumulative-histogram": {"slo": None,
                             "metrics": {"histograms": {"service_request_seconds": _HIST}}},
}


@pytest.mark.parametrize("shape", sorted(STATUSES))
def test_daemon_entry_equals_the_jax_modules(shape):
    port = perf.daemon_entry(STATUSES[shape])
    assert _unclocked(port) == _unclocked(jax_perf.daemon_entry(STATUSES[shape]))
    assert port["source"] == shape and port["value"] > 0


def test_trajectory_and_baseline_files_equal_the_jax_modules(tmp_path, monkeypatch):
    record = json.loads(SNAPSHOTS[0].read_text())
    monkeypatch.setenv(perf.ENV_TRAJECTORY, str(tmp_path / "traj" / "port.jsonl"))
    assert perf.trajectory_path() == tmp_path / "traj" / "port.jsonl"
    perf.append_trajectory(dict(record, ts=1.0), preset="r01")
    monkeypatch.setenv(perf.ENV_TRAJECTORY, str(tmp_path / "traj" / "jax.jsonl"))
    jax_perf.append_trajectory(dict(record, ts=1.0), preset="r01")
    assert (tmp_path / "traj" / "port.jsonl").read_bytes() == \
        (tmp_path / "traj" / "jax.jsonl").read_bytes()
    monkeypatch.delenv(perf.ENV_TRAJECTORY)
    assert perf.trajectory_path(tmp_path) == tmp_path / "BENCH_trajectory.jsonl"
    entries = {"r01": {"value": 2.0, "unit": "ms", "recorded_at": 1.0}}
    perf.save_baseline(tmp_path / "port.json", entries)
    jax_perf.save_baseline(tmp_path / "jax.json", entries)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError):
        perf.load_baseline(tmp_path / "bad.json")


# --- perf record|compare, in process -----------------------------------------------------------

def _snapshot(tmp_path, name, scale=1.0, phase_scale=1.0):
    """``BENCH_devtail.json`` (ms, with phases) under ``tmp_path/name``,
    its headline and phases scaled."""
    record = json.loads((REPO_ROOT / "BENCH_devtail.json").read_text())
    record["value"] = float(record["value"]) * scale
    record["phases_ms"] = {k: float(v) * phase_scale for k, v in record["phases_ms"].items()}
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record))
    return str(path)


def _perf_cases(tmp_path):
    """name → [argv, ...], run in order against one baseline."""
    base = str(tmp_path / "base.json")
    same = _snapshot(tmp_path, "BENCH_devtail.json")
    slower = _snapshot(tmp_path, "slower/BENCH_devtail.json", scale=2.0)
    slow_phases = _snapshot(tmp_path, "phases/BENCH_devtail.json", phase_scale=2.0)
    other = _snapshot(tmp_path, "BENCH_other.json", scale=0.5)
    record = ["perf", "record", same, "--baseline", base]
    return {
        "record-then-compare": [record, ["perf", "compare", same, "--baseline", base]],
        "regression": [record, ["perf", "record", other, "--key", "renamed", "--baseline",
                                base],
                       ["perf", "compare", slower, other, "--baseline", base]],
        "json-and-tolerances": [record, ["perf", "compare", slower, "--baseline", base,
                                         "--tolerance-pct", "150",
                                         "--phase-tolerance-pct", "0", "--json"]],
        "json-regression": [record, ["perf", "compare", slow_phases, "--baseline", base,
                                     "--json"]],
        "missing-baseline": [["perf", "compare", same, "--baseline", base]],
        "default-baseline": [["perf", "record", same], ["perf", "compare", same]],
        "nothing-to-process": [["perf", "record", "--baseline", base]],
        "unreadable-snapshot": [["perf", "record", str(tmp_path / "none.json"),
                                 "--baseline", base]],
    }


EXPECTED_CODES = {"record-then-compare": [0, 0], "regression": [0, 0, 1],
                  "json-and-tolerances": [0, 0], "json-regression": [0, 1],
                  "missing-baseline": [2], "default-baseline": [0, 0],
                  "nothing-to-process": [2], "unreadable-snapshot": [2]}


@pytest.mark.parametrize("case", sorted(EXPECTED_CODES))
def test_perf_cli_equals_the_jax_clis(case, tmp_path, monkeypatch, capsys):
    """The same argv in the same working directory (``tmp_path``, outside
    the checkout), once per package: the same stdout, stderr, exit codes
    and baseline bytes (``recorded_at`` masked); the checkout's
    ``PERF_BASELINE.json`` untouched."""
    guarded = BASELINE.read_bytes()
    monkeypatch.chdir(tmp_path)
    argvs = _perf_cases(tmp_path)[case]
    results, files = {}, {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        for leftover in ("base.json", "PERF_BASELINE.json"):
            (tmp_path / leftover).unlink(missing_ok=True)
        runs = []
        for argv in argvs:
            capsys.readouterr()
            code = main(argv)
            out, err = capsys.readouterr()
            runs.append((code, out, err))
        results[name] = runs
        files[name] = {p.name: _unclocked(json.loads(p.read_text()))
                       for p in tmp_path.glob("*.json") if not p.name.startswith("BENCH_")}
    assert results["port"] == results["jax"]
    assert files["port"] == files["jax"]
    assert [run[0] for run in results["port"]] == EXPECTED_CODES[case]
    assert BASELINE.read_bytes() == guarded


# --- top ---------------------------------------------------------------------------------------

_TOP_STATUS = {"pid": 1, "uptime_s": 5.0, "socket": "/tmp/x.sock",
               "queue_depth": 2, "in_flight": 1, "served_total": 9,
               "window": {"1s": {"qps": 3.0, "p50_ms": 4.0, "p99_ms": 9.0, "error_rate": 0.0},
                          "1m": {"qps": 0.5, "p50_ms": 4.5, "p99_ms": 11.0,
                                 "error_rate": 0.1}},
               "resilience": {"pressure": 0, "breakers": {"kernel": "open", "host": "closed"}},
               "residency": {"lookups": 10, "hit_rate": 0.8},
               "batch": {"mesh": {"last_rows_per_chip": 128}},
               "sampling": {"enabled": True},
               "trace_store": {"count": 3, "bytes": 1 << 20, "budget_bytes": 16 << 20},
               "anomaly": {"latched": ["kernel"], "fired": 2},
               "slo": {"healthy": False}}
TOP_SNAPSHOTS = {
    "daemon": {"status": _TOP_STATUS, "members": None},
    "daemon-quiet": {"status": {"pid": 7, "uptime_s": 0.4, "socket": "/s.sock",
                                "slo": None, "trace_store": None}, "members": None},
    "fleet": {"status": {"fleet": True, "pid": 2, "uptime_s": 1.0, "socket": "tcp://0:1",
                         "in_flight": 0, "served_total": 4, "window": {},
                         "members": [{"id": "m0", "state": "up"}, "junk",
                                     {"id": "m1", "state": "draining"}]},
              "members": {"m0": {"window": {"1m": {"qps": 1.5, "p99_ms": 7.0}},
                                 "queue_depth": 1, "in_flight": 0, "served_total": 4},
                          "m1": "junk"}},
}


@pytest.mark.parametrize("shape", sorted(TOP_SNAPSHOTS))
def test_top_frame_equals_the_jax_frame(shape):
    frame = report._render_top_frame(TOP_SNAPSHOTS[shape])
    assert frame == jax_cli._render_top_frame(TOP_SNAPSHOTS[shape])
    head = "fleet router" if shape == "fleet" else "merge daemon"
    assert frame.startswith(f"semmerge top — {head} pid ")


# --- the GC posture ---------------------------------------------------------------------------

@pytest.fixture
def gc_state():
    """Restores the collector's thresholds and unfreezes the heap."""
    threshold = gc.get_threshold()
    gc.unfreeze()
    yield
    gc.unfreeze()
    gc.set_threshold(*threshold)


@pytest.mark.parametrize("setting", ["unset", "0", "1"])
def test_gc_posture_equals_the_jax_one(setting, gc_state, monkeypatch):
    if setting == "unset":
        monkeypatch.delenv("SEMMERGE_GC_TUNE", raising=False)
    else:
        monkeypatch.setenv("SEMMERGE_GC_TUNE", setting)
    after = {}
    for name, tune in (("port", gctune.tune_for_merge), ("jax", jax_gctune.tune_for_merge)):
        gc.unfreeze()
        gc.set_threshold(700, 10, 10)
        tune()
        after[name] = (gc.get_threshold(), gc.get_freeze_count() > 0)
    assert after["port"] == after["jax"]
    assert after["port"] == (((700, 10, 10), False) if setting == "0"
                             else ((100_000, 50, 50), True))


def test_a_shipped_setting_never_reaches_the_daemons_posture(gc_state, monkeypatch):
    monkeypatch.setenv("SEMMERGE_GC_TUNE", "0")  # the daemon's own posture
    gc.set_threshold(700, 10, 10)
    with reqenv.overlay({"SEMMERGE_GC_TUNE": "1"}):
        assert reqenv.get("SEMMERGE_GC_TUNE") == "1"
        gctune.tune_for_merge()
    assert gc.get_threshold() == (700, 10, 10) and gc.get_freeze_count() == 0


def test_the_daemon_turns_the_posture_off(monkeypatch):
    from semantic_merge_tpu_torch.service.daemon import Daemon
    for key in ("SEMMERGE_GC_TUNE", "SEMMERGE_DAEMON", "_SEMMERGE_IN_DAEMON"):
        monkeypatch.setenv(key, "unset")  # recorded, so the posture is undone after
        monkeypatch.delenv(key)
    daemon = Daemon.__new__(Daemon)  # only its process posture, nothing bound
    daemon._configure_process_env()
    assert os.environ["SEMMERGE_GC_TUNE"] == "0" and os.environ["SEMMERGE_DAEMON"] == "off"


#: A command line per CLI command, each of which ends without a daemon,
#: a card or a repository in an empty directory.
COMMANDS = {
    "semdiff": ["semdiff", "basebr", "brA", "--device", "cpu"],
    "semmerge": ["semmerge", "basebr", "brA", "brB", "--device", "cpu"],
    "semrebase": ["semrebase", "brA", "brB", "--device", "cpu"],
    "train-matcher": ["train-matcher", "--steps", "1"],
    "serve": ["serve", "--status"],
    "stats": ["stats"],
    "trace": ["trace", "analyze", "nowhere"],
    "profile": ["profile", "--daemon"],
    "perf": ["perf", "compare", "BENCH_r01.json"],
    "top": ["top", "--once"],
}


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_the_cli_runs_the_posture_for_the_merge_verbs_only(command, tmp_path, monkeypatch,
                                                           capsys):
    monkeypatch.chdir(tmp_path)
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(tmp_path / "none.sock"))
    calls = []
    monkeypatch.setattr(gctune, "tune_for_merge", lambda: calls.append(command))
    code = cli.main(COMMANDS[command])
    capsys.readouterr()
    assert code != 0  # nothing there to work on
    assert calls == ([command] if command in ("semdiff", "semmerge", "semrebase") else [])
