"""The port's observability layer against the JAX package's, unit by unit.

Seeded inputs (``numpy.random.default_rng``) drive both packages' copies
of each module, and the results must be equal exactly, after masking
what is time, process or thread:

- ``obs/metrics.py``: the same sequence of counter, gauge and histogram
  operations gives the same ``to_dict``, the same Prometheus text (and
  ``render_prometheus_from_dict`` of either dict), the same quantiles,
  and the same overflow at the series budget
  (``SEMMERGE_METRICS_MAX_SERIES``: the overflow series and
  ``metrics_series_dropped_total``); ``SEMMERGE_METRICS=path`` dumps
  the same JSON and Prometheus text.
- ``obs/spans.py``: the same nested spans, records, errors and events
  give the same ``span_dicts`` and JSONL rows (times and thread
  masked); the phase histogram and flight ring are fed without a
  recorder; request scopes carry the trace id; a stale ``deactivate``
  is a no-op.
- ``obs/flight.py``: the same ring gives the same postmortem bundle
  (times, the bundle's metrics block and trace ids of the rows
  masked), which passes ``scripts/check_trace_schema.py
  validate_postmortem``; the retention caps prune the same bundles.
- ``obs/anomaly.py``: ``phase_diff`` is equal on seeded phase maps.
- ``obs/device.py``: the block has every key of the JAX block; the
  transfer counters and the build metrics (the port's names:
  ``semmerge_kernel_build_*``); nothing imports CUDA.
- ``utils/loggingx.py`` and ``utils/workdir.py``: the same level parsing
  and the same request-root scoping.
"""
import importlib
import json
import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from semantic_merge_tpu.obs import anomaly as jax_anomaly
from semantic_merge_tpu.obs import device as jax_device
from semantic_merge_tpu.obs import flight as jax_flight
from semantic_merge_tpu.obs import metrics as jax_metrics
from semantic_merge_tpu.obs import spans as jax_spans
from semantic_merge_tpu.utils import workdir as jax_workdir
from semantic_merge_tpu_torch.obs import anomaly, device, flight, metrics, spans
from semantic_merge_tpu_torch.utils import workdir

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "scripts"))
import check_trace_schema  # noqa: E402


# --- metrics -----------------------------------------------------------------

def _metric_ops(seed, n=300):
    """A seeded sequence of registry operations: (kind, name, value, labels)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = ("counter", "gauge", "gauge_max", "hist")[int(rng.integers(4))]
        name = f"m_{kind}_{int(rng.integers(3))}"
        labels = {k: str(int(rng.integers(4))) for k in ("side", "phase")[:int(rng.integers(3))]}
        value = float(np.round(rng.exponential(0.5), 4))
        ops.append((kind, name, value, labels))
    return ops


def _apply(registry, ops, exemplars=False):
    for i, (kind, name, value, labels) in enumerate(ops):
        if kind == "counter":
            registry.counter(name, f"help {name}").inc(value, **labels)
        elif kind == "gauge":
            registry.gauge(name, f"help {name}").set(value, **labels)
        elif kind == "gauge_max":
            registry.gauge(name, f"help {name}").max(value, **labels)
        else:
            registry.histogram(name, f"help {name}").observe(
                value, exemplar=f"t{i}" if exemplars else None, **labels)
    return registry


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exemplars", [False, True], ids=["plain", "exemplars"])
def test_registry_to_dict_and_prometheus_equal(seed, exemplars):
    ops = _metric_ops(seed)
    ours = _apply(metrics.Registry(), ops, exemplars)
    theirs = _apply(jax_metrics.Registry(), ops, exemplars)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.render_prometheus() == theirs.render_prometheus()
    data = ours.to_dict()
    assert metrics.render_prometheus_from_dict(data) == \
        jax_metrics.render_prometheus_from_dict(data)
    assert check_trace_schema.validate_metrics(data) == []


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_equal(q):
    rng = np.random.default_rng(7)
    values = rng.exponential(0.3, size=500).round(5).tolist()
    ours, theirs = metrics.Registry(), jax_metrics.Registry()
    for v in values:
        ours.histogram("h").observe(v, phase="x")
        theirs.histogram("h").observe(v, phase="x")
    assert ours.histogram("h").quantile(q, phase="x") == \
        theirs.histogram("h").quantile(q, phase="x")
    counts = ours.histogram("h").snapshot(phase="x")["counts"]
    assert metrics.histogram_quantile(metrics.PHASE_BUCKETS, counts, q) == \
        jax_metrics.histogram_quantile(jax_metrics.PHASE_BUCKETS, counts, q)


def test_kind_mismatch_raises_in_both():
    for module in (metrics, jax_metrics):
        reg = module.Registry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")


@pytest.mark.parametrize("budget", ["3", "1", "0"])
def test_series_budget_overflow_equal(monkeypatch, budget):
    monkeypatch.setenv("SEMMERGE_METRICS_MAX_SERIES", budget)
    dropped = []
    out = []
    for module in (metrics, jax_metrics):
        counter = module.REGISTRY.counter(module.SERIES_DROPPED)
        before = counter.value(metric="budgeted")
        reg = module.Registry()
        for i in range(8):
            reg.counter("budgeted").inc(1, key=str(i))
            reg.gauge("budgeted_g").set(i, key=str(i))
            reg.histogram("budgeted_h").observe(i / 10, key=str(i))
        reg.counter("budgeted").inc(5, key="0")  # an existing series still records
        out.append(reg.to_dict())
        dropped.append(counter.value(metric="budgeted") - before)
    assert out[0] == out[1]
    assert dropped[0] == dropped[1]
    if budget != "0":
        series = out[0]["counters"]["budgeted"]["series"]
        assert {"overflow": "true"} in [s["labels"] for s in series]


@pytest.mark.parametrize("suffix", [".json", ".prom"])
def test_metrics_exit_dump_equal(tmp_path, suffix):
    # SEMMERGE_METRICS=path dumps the registry at exit, JSON or .prom.
    code = ("import sys\nfrom {pkg}.obs import metrics\n"
            "metrics.REGISTRY.counter('dumped_total', 'help').inc(3, side='left')\n"
            "metrics.REGISTRY.histogram('dumped_seconds').observe(0.02, phase='scan')\n")
    dumps = []
    for pkg in ("semantic_merge_tpu_torch", "semantic_merge_tpu"):
        path = tmp_path / f"{pkg}{suffix}"
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), SEMMERGE_METRICS=str(path))
        subprocess.run([sys.executable, "-c", code.format(pkg=pkg)], env=env, check=True,
                       timeout=120, cwd=REPO_ROOT)
        dumps.append(path.read_text())
    assert dumps[0] == dumps[1] and "dumped_total" in dumps[0]


# --- spans -------------------------------------------------------------------

def _span_program(module, seed):
    """Seeded nested spans, records, an error span and events under a
    fresh recorder; returns the recorder."""
    rng = np.random.default_rng(seed)
    rec = module.SpanRecorder()

    def nest(depth):
        for i in range(int(rng.integers(1, 3))):
            name = f"s{depth}_{i}"
            with module.span(name, layer=("cli", "ops", None)[int(rng.integers(3))],
                             depth_meta=depth, i=i):
                if depth < 3 and rng.random() < 0.7:
                    nest(depth + 1)
                if rng.random() < 0.3:
                    module.record("rec", float(rng.random()), layer="ops", rows=i)
                if rng.random() < 0.3:
                    module.event("ev", depth=depth)

    with module.activated(rec):
        nest(0)
        with pytest.raises(ValueError):
            with module.span("boom", layer="cli"):
                raise ValueError("x")
    return rec


def _masked_span(row):
    return dict(row, t_start=None, seconds=None if row.get("name") != "rec" else row["seconds"],
                thread=None)


@pytest.mark.parametrize("seed", range(4))
def test_span_dicts_equal(seed):
    ours, theirs = _span_program(spans, seed), _span_program(jax_spans, seed)
    a, b = ours.span_dicts(), theirs.span_dicts()
    assert len(a) == len(b) > 0
    by_id = lambda rows: sorted((_masked_span(r) for r in rows), key=lambda r: r["span_id"])
    assert by_id(a) == by_id(b)
    assert ours.layers() == theirs.layers()
    assert {k: None for k in ours.phase_totals()} == {k: None for k in theirs.phase_totals()}


def test_events_jsonl_equal_and_valid(tmp_path):
    ours, theirs = _span_program(spans, 11), _span_program(jax_spans, 11)
    rows = []
    for rec, name in ((ours, "port.jsonl"), (theirs, "jax.jsonl")):
        rec.write_jsonl(tmp_path / name)
        lines = (tmp_path / name).read_text().splitlines()
        assert check_trace_schema.validate_events(lines) == []
        rows.append(sorted(json.dumps(dict(json.loads(line), t_start=None, thread=None,
                                           seconds=None), sort_keys=True) for line in lines))
    assert rows[0] == rows[1]


def test_spans_without_recorder_feed_histogram_and_ring(monkeypatch):
    monkeypatch.setenv("SEMMERGE_FLIGHT_SPANS", "4")
    out = []
    for module, fl, mt in ((spans, flight, metrics), (jax_spans, jax_flight, jax_metrics)):
        fl.reset()
        before = mt.phase_totals().get("dark_phase", 0.0)
        count0 = mt.REGISTRY.histogram(mt.PHASE_HISTOGRAM).snapshot(phase="dark_phase")["count"]
        assert not module.active()
        for i in range(6):
            with module.span("dark_phase", layer="ops", i=i):
                pass
        module.record("dark_phase", 0.5, layer="ops")
        ring = fl.snapshot()
        count = mt.REGISTRY.histogram(mt.PHASE_HISTOGRAM).snapshot(phase="dark_phase")["count"]
        out.append(([dict(r, t=None, seconds=None, thread=None) for r in ring],
                    count - count0, mt.phase_totals()["dark_phase"] >= before + 0.5))
        fl.reset()
    monkeypatch.delenv("SEMMERGE_FLIGHT_SPANS")
    assert out[0] == out[1]
    assert len(out[0][0]) == 4 and out[0][1] == 7 and out[0][2]


def test_request_scope_trace_id_and_stale_deactivate():
    for module in (spans, jax_spans):
        assert module.trace_id() is None
        outer, inner = module.SpanRecorder(), module.SpanRecorder()
        module.activate(outer)
        module.deactivate(inner)  # stale handle: no-op
        assert module.current() is outer
        with module.request_scope("req-1", inner):
            assert module.trace_id() == "req-1" and module.current() is inner
            with module.span("scoped"):
                pass
        module.deactivate(outer)
        assert module.current() is None and module.trace_id() is None
        assert [s.name for s in inner.spans] == ["scoped"] and outer.spans == []


# --- flight recorder -----------------------------------------------------------

class _Fault(RuntimeError):
    exit_code = 13
    stage = "apply"
    cause = "injected"


def _bundle(module, fl, tmp_path, reason, extra):
    fl.reset()
    for i in range(5):
        with module.span(f"ring{i}", layer="runtime", i=i):
            pass
    try:
        try:
            raise OSError("disk full")
        except OSError as exc:
            raise _Fault("apply failed") from exc
    except _Fault as fault:
        path = fl.dump("trace-abc", reason, fault=fault, breakers={}, root=tmp_path,
                       extra=extra)
    fl.reset()
    return json.loads(path.read_text()), path


@pytest.mark.parametrize("reason,extra", [
    ("fault-escape", None), ("degradation", {"degradation": {"from": "torch", "to": "text"}}),
    ("resolver-fault", None)])
def test_postmortem_bundle_equal_and_valid(tmp_path, reason, extra):
    ours, our_path = _bundle(spans, flight, tmp_path / "port", reason, extra)
    theirs, their_path = _bundle(jax_spans, jax_flight, tmp_path / "jax", reason, extra)
    assert check_trace_schema.validate_postmortem(ours) == []
    assert our_path.name == their_path.name == "trace-abc.json"
    assert our_path.parent.name == ".semmerge-postmortem"

    def masked(bundle):
        return dict(bundle, ts=None, metrics=sorted(bundle["metrics"]),
                    spans=[dict(r, t=None, seconds=None) for r in bundle["spans"]])

    assert masked(ours) == masked(theirs)
    assert ours["fault_chain"] == ["_Fault: apply failed", "OSError: disk full"]


def test_postmortem_dir_override_and_default_id(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMMERGE_POSTMORTEM_DIR", str(tmp_path / "pm"))
    path = flight.dump(None, "fault-escape", root=tmp_path / "ignored")
    assert path.parent == tmp_path / "pm" and path.name.startswith("local-")
    assert jax_flight.default_trace_id().split("-")[1] == \
        flight.default_trace_id().split("-")[1]  # both: local-<pid hex>-<random>


@pytest.mark.parametrize("keep,budget_mb,left", [("2", "0", 2), ("0", "0", 5), ("3", "0.0001", 0)])
def test_postmortem_retention_equal(tmp_path, monkeypatch, keep, budget_mb, left):
    monkeypatch.setenv("SEMMERGE_POSTMORTEM_KEEP", keep)
    monkeypatch.setenv("SEMMERGE_POSTMORTEM_BUDGET_MB", budget_mb)
    kept, pruned = [], []
    for name, fl, mt in (("port", flight, metrics), ("jax", jax_flight, jax_metrics)):
        root = tmp_path / name
        counter = mt.REGISTRY.counter("postmortem_pruned_total")
        before = counter.value(dir=".semmerge-postmortem")
        for i in range(5):
            fl.dump(f"t{i}", "fault-escape", root=root)
        kept.append(sorted(p.name for p in (root / ".semmerge-postmortem").glob("*.json")))
        pruned.append(counter.value(dir=".semmerge-postmortem") - before)
    assert kept[0] == kept[1] and pruned[0] == pruned[1]
    assert len(kept[0]) == left and pruned[0] == 5 - left


# --- phase_diff ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_phase_diff_equal(seed):
    rng = np.random.default_rng(seed)
    names = [f"p{i}" for i in range(8)]
    a = {n: float(rng.exponential()) for n in names if rng.random() < 0.8}
    b = {n: float(rng.exponential()) for n in names if rng.random() < 0.8}
    b.update({n: 0.0 for n in names[:1]})
    assert anomaly.phase_diff(a, b) == jax_anomaly.phase_diff(a, b)
    assert anomaly.phase_diff({}, {}) == jax_anomaly.phase_diff({}, {})


# --- device block ------------------------------------------------------------------

def test_device_block_keys_and_cpu_values():
    import torch
    ours, theirs = device.snapshot(), jax_device.snapshot()
    assert set(ours) == set(theirs)
    assert set(check_trace_schema.DEVICE_REQUIRED) <= set(ours)
    assert ours["jax_imported"] is False
    device.note_device(torch.device("cpu"))
    try:
        block = device.snapshot()
        assert (block["platform"], block["device_count"], block["device_kinds"]) == \
            ("cpu", 1, ["cpu"])
        assert block["live_buffer_bytes"] is None  # no allocator to ask on the CPU
    finally:
        device.note_device(None)


def test_transfer_and_build_metrics():
    before = device.snapshot()
    device.record_transfer("h2d", 1000)
    device.record_transfer("d2h", 24, count=2)
    device.record_build("sha256", True, 1.5)
    device.record_build("sha256", False)
    after = device.snapshot()

    def delta(key, sub):
        return after[key].get(sub, 0.0) - before[key].get(sub, 0.0)

    assert (delta("transfer_bytes", "h2d"), delta("transfer_bytes", "d2h")) == (1000, 24)
    assert (delta("transfer_count", "h2d"), delta("transfer_count", "d2h")) == (1, 2)
    assert (delta("compile_cache_events", "miss"), delta("compile_cache_events", "hit")) == (1, 1)
    assert delta("compile_seconds", "sha256") == 1.5
    names = metrics.REGISTRY.to_dict()["counters"]
    assert {"semmerge_kernel_build_events_total", "semmerge_kernel_build_seconds_total",
            "semmerge_device_transfer_bytes_total", "semmerge_device_transfers_total"} <= set(names)


def test_obs_imports_no_torch():
    code = ("import sys\nimport semantic_merge_tpu_torch.obs, semantic_merge_tpu_torch.obs.report\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
                         stdout=subprocess.PIPE, text=True, check=True)
    assert out.stdout.strip() == "False"


# --- logging and the request root -------------------------------------------------

@pytest.mark.parametrize("raw", ["", "debug", "WARNING", "10", "verbose"])
def test_logger_level_parsing_equal(raw):
    code = ("import logging\nfrom {pkg}.utils.loggingx import logger\n"
            "print(logger.name, logger.level, logger.handlers[0].formatter._fmt)\n")
    outs = []
    for pkg in ("semantic_merge_tpu_torch", "semantic_merge_tpu"):
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), SEMMERGE_LOG=raw)
        if not raw:
            env.pop("SEMMERGE_LOG")
        out = subprocess.run([sys.executable, "-c", code.format(pkg=pkg)], env=env,
                             cwd=REPO_ROOT, timeout=120, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, check=True)
        name, rest = out.stdout.split(" ", 1)
        outs.append((rest, out.stderr.replace("semantic_merge_tpu_torch", "semantic_merge_tpu")))
        assert name == pkg
    assert outs[0] == outs[1]


def test_port_modules_log_through_the_package_logger():
    importlib.import_module("semantic_merge_tpu_torch.utils.loggingx")
    child = logging.getLogger("semantic_merge_tpu_torch.cli")
    assert child.parent.name == "semantic_merge_tpu_torch"
    assert child.getEffectiveLevel() == logging.getLogger("semantic_merge_tpu_torch").level


def test_workdir_scoping_equal(tmp_path):
    for module in (workdir, jax_workdir):
        assert module.current() is None and module.root() == pathlib.Path.cwd()
        with module.scoped(tmp_path) as root:
            assert root == tmp_path.resolve() == module.root()
            assert module.path(".semmerge-trace.json") == root / ".semmerge-trace.json"
        assert module.current() is None


def test_snapshot_tree_equal(tmp_path):
    from semantic_merge_tpu.frontend.snapshot import snapshot_tree as jax_snapshot_tree
    from semantic_merge_tpu_torch.frontend.snapshot import snapshot_tree
    for rel, text in (("src/a.ts", "export const a = 1;\n"), ("b.tsx", "x"),
                      ("notes.txt", "skip"), ("lib/c.java", "class C {}")):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    rec = spans.SpanRecorder()
    with spans.activated(rec):
        ours = snapshot_tree(tmp_path)
    assert ours.files == jax_snapshot_tree(tmp_path).files
    assert [(s.name, s.layer) for s in rec.spans] == [("snapshot_tree", "frontend")]
