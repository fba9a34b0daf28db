"""The port's OTLP exporter (``obs/export.py``) against the JAX package's.

- ``spans_to_otlp`` of span rows from a port ``SpanRecorder`` (nested
  spans, an error, typed meta) and ``metrics_to_otlp`` of a registry
  with counters, gauges and histograms (exemplars included) equal the
  JAX functions' under a fixed epoch, in one process (one pid), with
  only ``scope.name`` masked; both pass
  ``scripts/check_trace_schema.py::validate_export``;
- the id and attribute encoders equal the JAX ones;
- the ``Exporter`` against a loopback ``http.server`` collector: a
  delivery counts in ``otlp_exported_total``, a full queue drops and
  counts, a dead endpoint counts ``otlp_errors_total``, and ``close()``
  returns behind a collector that never answers;
- ``maybe_exporter`` follows ``SEMMERGE_OTLP_ENDPOINT`` as the JAX one;
- a one-shot ``semdiff`` and ``semmerge --inplace`` with
  ``SEMMERGE_OTLP`` or ``SEMMERGE_OTLP_ENDPOINT`` set give the JAX
  CLI's exit codes, stdout, tree and notes, and ship nothing.

The daemon's export (one trace per served request) is in
``tests/test_torch_service.py``.
"""
from __future__ import annotations

import copy
import importlib.util
import pathlib
import shutil
import socket
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from semantic_merge_tpu.obs import export as jax_export
from semantic_merge_tpu_torch.obs import export, metrics, spans

from test_torch_service import Collector, REPOS, make_repo, notes, run_cli, tree_bytes

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
EPOCH = 1_700_000_000_123_456_789


def _schema():
    spec = importlib.util.spec_from_file_location(
        "check_trace_schema", REPO_ROOT / "scripts" / "check_trace_schema.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span_rows():
    recorder = spans.SpanRecorder()
    spans.activate(recorder)
    try:
        with spans.span("semmerge", layer="cli", files=3, ratio=0.5, strict=True,
                        label="x", none=None):
            with spans.span("scan", layer="frontend", scanner="native"):
                time.sleep(0.001)
            try:
                with spans.span("apply", layer="runtime"):
                    raise ValueError("boom")
            except ValueError:
                pass
            spans.record("service.queue_wait", 0.25, layer="service", verb="semmerge")
    finally:
        spans.deactivate(recorder)
    rows = recorder.span_dicts()
    assert {r["name"] for r in rows} >= {"semmerge", "scan", "apply"}
    assert any(r.get("status") == "error" for r in rows)
    return rows


def _registry_dict():
    reg = metrics.Registry()
    reg.counter("merges_total", "Merges, by outcome").inc(3, outcome="ok")
    reg.counter("merges_total").inc(1, outcome="conflicts")
    reg.gauge("queue_depth", "Queued requests").set(2)
    hist = reg.histogram("request_seconds", "Request seconds", buckets=(0.01, 0.1, 1.0))
    hist.observe(0.05, exemplar="00000000deadbeef", verb="semmerge")
    hist.observe(0.5, exemplar="0123456789abcdef", verb="semmerge")
    hist.observe(2.0, verb="semdiff")
    return reg.to_dict()


def _masked(payload, kind):
    out = copy.deepcopy(payload)
    resource = "resourceSpans" if kind == "traces" else "resourceMetrics"
    scope = "scopeSpans" if kind == "traces" else "scopeMetrics"
    for block in out[resource]:
        for sc in block[scope]:
            assert sc["scope"]["name"] == "semantic_merge_tpu_torch"
            sc["scope"]["name"] = "semantic_merge_tpu"
    return out


@pytest.mark.parametrize("kind", ["traces", "metrics"])
def test_payloads_equal_the_jax_functions(kind):
    if kind == "traces":
        rows = _span_rows()
        port = export.spans_to_otlp("9f2ab34cc01d77e6", rows, epoch_unix_nano=EPOCH)
        jax = jax_export.spans_to_otlp("9f2ab34cc01d77e6", rows, epoch_unix_nano=EPOCH)
        assert {sp["traceId"] for sp in port["resourceSpans"][0]["scopeSpans"][0]["spans"]} \
            == {"9f2ab34cc01d77e6".rjust(32, "0")}
    else:
        data = _registry_dict()
        port = export.metrics_to_otlp(data, time_unix_nano=EPOCH)
        jax = jax_export.metrics_to_otlp(data, time_unix_nano=EPOCH)
    assert _masked(port, kind) == jax
    schema = _schema()
    assert schema.validate_export(port) == [] and schema.validate_export(jax) == []


@pytest.mark.parametrize("value", [True, 0, -7, 2**70, 1.5, "text", None, ["a"]],
                         ids=repr)
def test_encoders_equal_the_jax_ones(value):
    assert export._attr_value(value) == jax_export._attr_value(value)
    assert export._attrs({"k": value}) == jax_export._attrs({"k": value})
    for raw in (value, "9F2ab3-4c", "", "0123456789abcdef0123456789abcdef01"):
        assert export._hex_trace_id(raw) == jax_export._hex_trace_id(raw)
    if isinstance(value, int):
        assert export._hex_span_id(value) == jax_export._hex_span_id(value)


# --- the Exporter against a loopback collector ----------------------------------------------

def _dead_endpoint():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _counts():
    reg = metrics.REGISTRY
    return {"traces": reg.counter("otlp_exported_total").value(kind="traces"),
            "metrics": reg.counter("otlp_exported_total").value(kind="metrics"),
            "dropped": reg.counter("otlp_dropped_total").value(kind="traces"),
            "errors": reg.counter("otlp_errors_total").value()}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("case", ["delivered", "queue-full", "dead-endpoint",
                                  "close-behind-dead-collector"])
def test_exporter_counts_every_outcome(case):
    rows = _span_rows()
    collector = Collector(hold=case in ("queue-full", "close-behind-dead-collector"))
    before = _counts()
    try:
        if case == "delivered":
            exp = export.Exporter(collector.endpoint)
            exp.export_trace("abc", rows, epoch_unix_nano=EPOCH)
            exp.export_metrics(_registry_dict(), time_unix_nano=EPOCH)
            exp.close()
            assert [path for path, _ in collector.received] == ["/v1/traces", "/v1/metrics"]
            assert collector.received[0][1] == export.spans_to_otlp(
                "abc", rows, epoch_unix_nano=EPOCH)
            assert _delta(before) == {"traces": 1, "metrics": 1, "dropped": 0, "errors": 0}
        elif case == "queue-full":
            exp = export.Exporter(collector.endpoint, queue_size=1)
            exp.export_trace("a", rows)
            assert collector.entered.wait(30)  # the worker holds the first payload
            exp.export_trace("b", rows)  # fills the queue
            exp.export_trace("c", rows)  # dropped
            assert _delta(before)["dropped"] == 1
            collector.release.set()
            t0 = time.monotonic()
            while _delta(before)["traces"] < 2 and time.monotonic() - t0 < 30:
                time.sleep(0.01)  # close() would drop a payload still queued
            exp.close()
            assert _delta(before) == {"traces": 2, "metrics": 0, "dropped": 1, "errors": 0}
        elif case == "dead-endpoint":
            exp = export.Exporter(_dead_endpoint(), timeout_s=2.0)
            exp.export_trace("a", rows)
            exp.close()
            assert _delta(before) == {"traces": 0, "metrics": 0, "dropped": 0, "errors": 1}
        else:
            exp = export.Exporter(collector.endpoint, queue_size=1, timeout_s=0.5)
            exp.export_trace("a", rows)
            assert collector.entered.wait(30)
            exp.export_trace("b", rows)
            t0 = time.monotonic()
            exp.close(timeout_s=1.0)
            assert time.monotonic() - t0 < 5.0
            collector.release.set()
    finally:
        collector.close()


def test_maybe_exporter_follows_the_endpoint(monkeypatch):
    made = []
    monkeypatch.setattr(export, "_singleton", None)
    monkeypatch.setattr(export, "_singleton_endpoint", None)
    monkeypatch.delenv(export.ENV_ENDPOINT, raising=False)
    monkeypatch.delenv(export.ENV_TIMEOUT, raising=False)
    assert export.maybe_exporter() is None and jax_export.ENV_ENDPOINT == export.ENV_ENDPOINT
    try:
        for endpoint in (_dead_endpoint(), _dead_endpoint()):
            monkeypatch.setenv(export.ENV_ENDPOINT, endpoint + "/")
            monkeypatch.setenv(export.ENV_QUEUE, "not-a-number")
            first = export.maybe_exporter()
            made.append(first)
            assert export.maybe_exporter() is first
            assert first.endpoint == endpoint and first._q.maxsize == export.DEFAULT_QUEUE
            assert first.timeout_s == export.DEFAULT_TIMEOUT_S
        assert made[0] is not made[1]
    finally:
        for exp in made:
            exp.close(timeout_s=1.0)


# --- one-shot runs export nothing ----------------------------------------------------------

@pytest.mark.parametrize("var", ["SEMMERGE_OTLP", "SEMMERGE_OTLP_ENDPOINT"])
def test_one_shot_runs_ship_nothing_and_match_the_jax_cli(var, tmp_path):
    collector = Collector()
    origin = make_repo(tmp_path / "origin", *REPOS["rename"])
    roots = {side: tmp_path / side for side in ("jax", "port")}
    for root in roots.values():
        shutil.copytree(origin, root)
    argvs = [["semdiff", "basebr", "brA", "--json-out"],
             ["semmerge", "basebr", "brA", "brB", "--inplace"]]
    package = {"jax": "semantic_merge_tpu", "port": "semantic_merge_tpu_torch"}
    try:
        def chain(side):
            return [run_cli(package[side], argv, roots[side], **{var: collector.endpoint})
                    for argv in argvs]

        with ThreadPoolExecutor(2) as pool:
            port, jax = pool.map(chain, ("port", "jax"))
        for (pc, pout, perr), (jc, jout, jerr) in zip(port, jax):
            assert (pc, pout) == (jc, jout) and pc == 0, (perr, jerr)
        assert "renameSymbol" in port[0][1]
        assert tree_bytes(roots["port"]) == tree_bytes(roots["jax"])
        assert notes(roots["port"]) == notes(roots["jax"])
        time.sleep(0.5)  # anything shipped would have arrived
        assert collector.received == []
    finally:
        collector.close()
