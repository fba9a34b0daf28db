"""``--trace`` / ``--profile`` and the artifact commands of the port's CLI
against the JAX CLI's, on the CPU.

Each case runs ``python -m semantic_merge_tpu ... --backend tpu --trace``
(``JAX_PLATFORMS=cpu``, a subprocess) and the port's ``cli.main([...,
"--device", "cpu"])`` in this process, with and without ``--trace``,
each in a fresh copy of a small repository (the ladder repository of
``tests/test_torch_ladder.py``, the DivergentRename one of
``tests/test_resolve.py``) whose untracked ``.semmerge.toml`` sets
``[engine] incremental = false`` (the JAX CLI then scans the whole tree
inside its merge phase, as the port always does; with its incremental
scope it also scans in its snapshot phase) and a formatter that does
nothing. Each in-process run starts from a fresh metrics registry,
flight ring and decl cache, as a new process does.

Compared, exactly after masking times, ids and threads:

- output bytes: exit code, stdout, the work tree (the conflicts
  artifact with its gates' ``ms`` masked), ``git status``, both notes —
  the port's with ``--trace`` equal to its bytes without it and to the
  JAX CLI's;
- the artifacts pass ``scripts/check_trace_schema.py`` (trace, events,
  degradations; postmortem bundles);
- the phase names, the span-name tree (name, layer, status, error and
  meta of every span, children in any order), the trace's counters and
  every registry counter (names, labels, values; histograms by series
  count, their sums being times), the gauges' names.

Masked, each for a stated reason: the backend's name (``tpu`` in the JAX
CLI, ``torch`` here); ``device_crdt`` of the ``apply_ops`` span (the
JAX TPU backend orders ``reorderImports`` lists on the device, the port
on the host); the build metrics (``semmerge_jax_compile_*`` against the
port's ``semmerge_kernel_build_*``); the trace counters
``decl_cache_hits``/``decl_cache_misses`` and the value of the
``semmerge_decl_cache_entries`` gauge (cumulative lookups of the decl
cache, which in the JAX backend also serves its keyed encode cache, not
ported yet); the device block's memory numbers (the CPU has no
allocator statistics).

Two cases need a stated mapping. ``apply_fault`` (``SEMMERGE_FAULT=
apply:fault``): the JAX CLI steps tpu → host → text, the port torch →
text (it has no host rung), so the JAX trace is compared with its host
rung cut out (the spans between its two degradations) and its first
transition's ``to`` read as ``text``; its first degradation bundle
against the port's bundle; and the counters the text rung adds after
each side's last bundle. ``scan_raise_no_degrade`` runs the default
configuration: the JAX CLI's incremental scope raises the injected
fault in its snapshot stage, the port's at the scan of its merge stage
(with the scope off the JAX CLI classifies it as a ``KernelFault``, exit
11, against the port's ``ParseFault``, exit 10); both exit 10 with a
``fault-escape`` bundle and ``merge_faults_total{fault="ParseFault"}``.
``scan_fault_no_degrade`` (a typed fault at the same scan) gives the
full comparison. Every fused merge needs a third: the JAX engine
fetches its split outputs one by one (head, then mid, then the chains:
a second ``fetch`` span and three d2h transfers), the port its
one-buffer row at once (one ``fetch``, one d2h), so each JAX fused
merge's later ``fetch`` span, its ``fetch`` phase observation and the
d2h transfers of that fetch and of the chains are taken off before the
comparison (:func:`_one_fetch`).

Also: ``stats`` (plain, ``--json``, ``--prometheus``), ``trace
analyze`` (one file, a directory, ``--json``) and ``trace diff`` print
the JAX CLI's bytes for the same artifacts; ``stats --daemon``,
``profile --daemon``, ``perf`` and the fleet forms without a daemon, an
artifact or a baseline answer as the JAX CLI does (the fleet forms on
live artifacts: ``tests/test_torch_fleet_obs.py``);
``--profile DIR`` writes
``DIR/semmerge-trace.json`` and a torch profiler trace holding a
``semmerge/<phase>`` range per phase, twice in one process; without the
flags nothing is written and no profiler runs.
"""
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from semantic_merge_tpu.cli import main as jax_main
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.frontend import declcache
from semantic_merge_tpu_torch.obs import flight, metrics, spans
from semantic_merge_tpu_torch.runtime import trace as port_trace
from semantic_merge_tpu_torch.utils import faults

from test_resolve import UTIL_A_BAR, UTIL_B_BAZ, UTIL_BASE
from test_resolve import make_repo as make_trees_repo
from test_torch_ladder import make_repo as make_ladder_repo

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "scripts"))
import check_trace_schema  # noqa: E402

TRACE = ".semmerge-trace.json"
EVENTS = ".semmerge-events.jsonl"
CONFLICTS = ".semmerge-conflicts.json"
POSTMORTEM = ".semmerge-postmortem"
#: Files the runs write beside the tree that the output comparison skips.
TELEMETRY = {TRACE, EVENTS, POSTMORTEM}
CONFIG = ('[engine]\nincremental = false\n'
          '[languages.typescript]\nformatter_cmd = ["true"]\n')
MERGE = ["semmerge", "basebr", "brA", "brB", "--inplace"]

#: name → (repository, argv, SEMMERGE_FAULT, with CONFIG)
CASES = {
    "fused_merge": ("ladder", MERGE, None, True),
    "fused_diff": ("ladder", ["semdiff", "basebr", "brA", "--json-out"], None, True),
    "strict_conflict": ("rename", MERGE + ["--strict-conflicts"], None, True),
    "resolve_auto": ("rename", MERGE + ["--resolve", "auto"], None, True),
    "apply_fault": ("ladder", MERGE, "apply:fault", True),
    "scan_fault_no_degrade": ("ladder", MERGE + ["--no-degrade"], "scan:fault", True),
    "scan_raise_no_degrade": ("ladder", MERGE + ["--no-degrade"], "scan:raise", False),
}
#: Cases whose traces compare in full.
FULL = sorted(set(CASES) - {"apply_fault", "scan_raise_no_degrade"})
EXIT = {"fused_merge": 0, "fused_diff": 0, "strict_conflict": 1, "resolve_auto": 0,
        "apply_fault": 0, "scan_fault_no_degrade": 10, "scan_raise_no_degrade": 10}
#: Build metrics: the one naming difference between the registries.
BUILD_METRICS = {"semmerge_jax_compile_cache_events_total", "semmerge_jax_compile_seconds_total",
                 "semmerge_kernel_build_events_total", "semmerge_kernel_build_seconds_total"}
#: Trace counters read from the decl cache's cumulative lookups.
DECL_CACHE_COUNTERS = {"decl_cache_hits", "decl_cache_misses"}


def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        parts = p.relative_to(root).parts
        if not p.is_file() or ".git" in parts or TELEMETRY & set(parts):
            continue
        data = p.read_bytes()
        if p.name == CONFLICTS:
            payload = json.loads(data)
            for rec in (payload.get("resolutions") or []) if isinstance(payload, dict) else []:
                for gate in rec.get("gates", []):
                    gate["ms"] = None
            data = json.dumps(payload, sort_keys=True).encode()
        out[p.relative_to(root).as_posix()] = data
    return out


def _outputs(root, code, stdout):
    status = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                            cwd=root, check=True, stdout=subprocess.PIPE, text=True,
                            timeout=60).stdout
    notes = [subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            timeout=60).stdout
             for rev in ("brA", "brB")]
    return {"code": code, "stdout": stdout, "tree": _tree(root), "notes": notes,
            "status": [line for line in status.splitlines()
                       if not any(t in line for t in TELEMETRY)]}


def _artifacts(root):
    out = {"bundles": {}}
    if (root / TRACE).is_file():
        out["trace"] = json.loads((root / TRACE).read_text())
        out["events"] = (root / EVENTS).read_text().splitlines()
    for path in sorted((root / POSTMORTEM).glob("*.json")):
        out["bundles"][path.stem] = json.loads(path.read_text())
    return out


def _fresh_process_state(monkeypatch):
    """What a new process starts from: an empty registry, flight ring
    and decl cache, no injected-fault hits, no active recorder."""
    metrics.REGISTRY.reset()
    flight.reset()
    faults.reset()
    monkeypatch.setattr(declcache, "_GLOBAL", None)
    monkeypatch.setattr(declcache, "_PUBLISHED", {"hits": 0, "misses": 0, "evictions": 0})
    assert spans.current() is None


def _run_port(root, argv, fault, capsys):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
            mp.delenv(key)
        mp.setenv("SEMMERGE_DAEMON", "off")
        if fault:
            mp.setenv("SEMMERGE_FAULT", fault)
        _fresh_process_state(mp)
        capsys.readouterr()
        code = cli.main([*argv, "--device", "cpu"])
        out, err = capsys.readouterr()
        faults.reset()
    return code, out, err


def _jax_env(fault):
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    if fault:
        env["SEMMERGE_FAULT"] = fault
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("trace")
    origins = {"ladder": make_ladder_repo(work / "ladder"),
               "rename": make_trees_repo(work / "rename", {"src/util.ts": UTIL_BASE},
                                         {"src/util.ts": UTIL_A_BAR},
                                         {"src/util.ts": UTIL_B_BAZ})}
    copies, procs = {}, {}
    for name, (repo, argv, fault, configured) in CASES.items():
        for side in ("jax", "port", "port_plain"):
            root = work / f"{name}-{side}"
            shutil.copytree(origins[repo], root)
            if configured:
                (root / ".semmerge.toml").write_text(CONFIG)
            copies[name, side] = root
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu", *argv, "--backend", "tpu", "--trace"],
            cwd=copies[name, "jax"], env=_jax_env(fault), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        if len(procs) % 4 == 0:  # at most four JAX processes at once
            for proc in procs.values():
                proc.wait(timeout=300)
    capsys = _Capture()
    out = {}
    try:
        for name, (repo, argv, fault, configured) in CASES.items():
            for side, extra in (("port", ["--trace"]), ("port_plain", [])):
                with capsys:
                    code, stdout, stderr = _run_port(copies[name, side], [*argv, *extra],
                                                     fault, capsys)
                out[name, side] = dict(_outputs(copies[name, side], code, stdout),
                                       stderr=stderr, **_artifacts(copies[name, side]))
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[name, "jax"] = dict(_outputs(copies[name, "jax"], proc.returncode, stdout),
                                    stderr=stderr, **_artifacts(copies[name, "jax"]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["roots"] = copies
    return out


class _Capture:
    """A stand-in for pytest's ``capsys`` in a module-scoped fixture:
    redirects ``sys.stdout``/``sys.stderr`` to buffers."""

    def __enter__(self):
        import io
        self._saved = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = io.StringIO(), io.StringIO()
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved
        return False

    def readouterr(self):
        out, err = sys.stdout.getvalue(), sys.stderr.getvalue()
        for stream in (sys.stdout, sys.stderr):
            stream.seek(0)
            stream.truncate()
        return out, err


# --- normalization --------------------------------------------------------------

def _meta(meta):
    return {k: ("torch" if v == "tpu" else v) for k, v in meta.items() if k != "device_crdt"}


def _span_tree(rows):
    kids = {}
    for row in rows:
        kids.setdefault(row["parent_id"], []).append(row)

    def node(row):
        return (row["name"], row["layer"], row["status"], row["error"],
                json.dumps(_meta(row["meta"]), sort_keys=True),
                tuple(sorted(node(c) for c in kids.get(row["span_id"], []))))

    return tuple(sorted(node(r) for r in kids.get(-1, [])))


def _counters(registry):
    """{(metric, labels): value} of every counter but the build metrics;
    histograms by series count."""
    out = {}
    for name, m in registry["counters"].items():
        if name in BUILD_METRICS:
            continue
        for s in m["series"]:
            labels = {k: ("torch" if v == "tpu" else v) for k, v in s["labels"].items()}
            out[name, json.dumps(labels, sort_keys=True)] = s["value"]
    for name, m in registry["histograms"].items():
        for s in m["series"]:
            out[name + ":count", json.dumps(s["labels"], sort_keys=True)] = s["count"]
    return out


def _cut_host_rung(trace):
    """The JAX trace of an ``apply_fault`` run as the port's ladder would
    have left it: the spans between its two degradations (the host
    rung) removed, its first transition read as ``torch -> text``."""
    trace = copy.deepcopy(trace)
    rows = sorted(trace["spans"], key=lambda r: r["t_start"])
    first, second = [r for r in rows if r["name"] == "degradation"]
    assert (first["meta"]["to"], second["meta"]["from"]) == ("host", "host")
    first["meta"]["to"] = "text"
    cut = {r["span_id"] for r in rows if r["parent_id"] == -1
           and first["t_start"] < r["t_start"] <= second["t_start"] and r is not first}
    changed = True
    while changed:
        more = {r["span_id"] for r in rows if r["parent_id"] in cut} - cut
        changed = bool(more)
        cut |= more
    # The CLI phases are the layer-cli root spans other than the
    # degradation records, in order.
    phase_rows = [r for r in rows if r["layer"] == "cli" and r["parent_id"] == -1
                  and r["name"] != "degradation"]
    assert [r["name"] for r in phase_rows] == [p["name"] for p in trace["phases"]]
    trace["phases"] = [p for p, r in zip(trace["phases"], phase_rows)
                       if r["span_id"] not in cut]
    trace["spans"] = [r for r in rows if r["span_id"] not in cut]
    return trace


def _one_fetch(trace):
    """A JAX trace or postmortem bundle as the port's fused merge records
    its fetch: under each ``fused_merge`` span the JAX engine has two
    ``fetch`` spans (head, then mid) and one d2h transfer each, and one
    more transfer for the chains, just before its ``chain_decode`` span;
    the port has one ``fetch`` and one transfer. The later ``fetch`` goes,
    with its observation of ``semmerge_phase_seconds{phase="fetch"}``, and
    a transfer per removed ``fetch`` and per ``chain_decode`` comes off
    ``semmerge_device_transfers_total{direction="d2h"}``."""
    trace = copy.deepcopy(trace)
    spans = trace["spans"]
    cut = set()
    if spans and "parent_id" in spans[0]:  # a trace's span tree
        for merge in (r for r in spans if r["name"] == "fused_merge"):
            fetches = sorted((r for r in spans if r["parent_id"] == merge["span_id"]
                              and r["name"] == "fetch"), key=lambda r: r["t_start"])
            assert len(fetches) == 2, fetches
            cut.add(id(fetches[1]))
    else:  # a bundle's flight rows, each noted when it ends: a merge's after its steps
        fetches = []
        for r in sorted(spans, key=lambda r: r["t"]):
            if r["name"] == "fetch":
                fetches.append(r)
            elif r["name"] == "fused_merge":
                assert len(fetches) == 2, fetches
                cut.add(id(fetches[1]))
                fetches = []
    trace["spans"] = [r for r in spans if id(r) not in cut]
    chain_fetches = sum(r["name"] == "chain_decode" for r in spans)
    if cut:
        metrics = trace["metrics"]
        (phase,) = [s for s in metrics["histograms"]["semmerge_phase_seconds"]["series"]
                    if s["labels"] == {"phase": "fetch"}]
        phase["count"] -= len(cut)
        (d2h,) = [s for s in metrics["counters"]["semmerge_device_transfers_total"]["series"]
                  if s["labels"] == {"direction": "d2h"}]
        d2h["value"] -= len(cut) + chain_fetches
    return trace


def _comparable_trace(runs, name):
    jax_trace = _one_fetch(runs[name, "jax"]["trace"])
    if name == "apply_fault":
        jax_trace = _cut_host_rung(jax_trace)
    return jax_trace, runs[name, "port"]["trace"]


# --- output bytes -----------------------------------------------------------------

OUTPUT_KEYS = ("code", "stdout", "tree", "notes", "status")


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_changes_no_output_byte(runs, name):
    traced, plain = runs[name, "port"], runs[name, "port_plain"]
    assert traced["code"] == EXIT[name], traced["stderr"]
    assert {k: traced[k] for k in OUTPUT_KEYS} == {k: plain[k] for k in OUTPUT_KEYS}
    assert "trace" not in plain and "trace" in traced


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_bytes_equal_the_jax_clis(runs, name):
    port, jax = runs[name, "port"], runs[name, "jax"]
    assert jax["code"] == EXIT[name], jax["stderr"]
    assert {k: port[k] for k in OUTPUT_KEYS} == {k: jax[k] for k in OUTPUT_KEYS}


# --- the artifacts ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_artifacts_pass_the_schema_script(runs, name, capsys):
    root = runs["roots"][name, "port"]
    assert check_trace_schema.main([str(root / TRACE), str(root / EVENTS)]) == 0, \
        capsys.readouterr()
    trace = runs[name, "port"]["trace"]
    assert trace["schema"] == 1 and trace["trace_id"] is None
    assert set(trace) == set(runs[name, "jax"]["trace"])
    assert check_trace_schema.validate_degradations(trace) == []
    for bundle in runs[name, "port"]["bundles"].values():
        assert check_trace_schema.validate_postmortem(bundle) == []
    device = trace["device"]
    assert (device["jax_imported"], device["platform"], device["device_kinds"]) == \
        (False, "cpu", ["cpu"])
    assert set(device) == set(runs[name, "jax"]["trace"]["device"])


@pytest.mark.parametrize("name", FULL + ["apply_fault"])
def test_phase_names_equal(runs, name):
    jax_trace, port_trace_ = _comparable_trace(runs, name)
    assert [p["name"] for p in port_trace_["phases"]] == \
        [p["name"] for p in jax_trace["phases"]]
    assert [p.get("meta") for p in port_trace_["phases"] if p.get("meta")] == \
        [{"backend": "torch"} for p in jax_trace["phases"] if p.get("meta")]


@pytest.mark.parametrize("name", FULL + ["apply_fault"])
def test_span_tree_equal(runs, name):
    jax_trace, port_trace_ = _comparable_trace(runs, name)
    assert _span_tree(port_trace_["spans"]) == _span_tree(jax_trace["spans"])


@pytest.mark.parametrize("name", FULL + ["apply_fault"])
def test_trace_counters_equal(runs, name):
    jax_trace, port_trace_ = _comparable_trace(runs, name)
    want = {k: v for k, v in jax_trace["counters"].items() if k not in DECL_CACHE_COUNTERS}
    got = {k: v for k, v in port_trace_["counters"].items() if k not in DECL_CACHE_COUNTERS}
    if name == "apply_fault":
        want["degradations"] = 1  # the port's one transition for the JAX CLI's two
    assert got == want
    assert set(port_trace_["counters"]) == set(jax_trace["counters"])


@pytest.mark.parametrize("name", FULL)
def test_registry_counters_equal(runs, name):
    jax_metrics = _one_fetch(runs[name, "jax"]["trace"])["metrics"]
    port_metrics = runs[name, "port"]["trace"]["metrics"]
    assert _counters(port_metrics) == _counters(jax_metrics)
    assert sorted(port_metrics["gauges"]) == sorted(jax_metrics["gauges"])


def test_resolution_counters(runs):
    series = runs["resolve_auto", "port"]["trace"]["metrics"]["counters"]["resolutions_total"]
    assert series["series"] == [{"labels": {"category": "DivergentRename",
                                            "outcome": "accepted"}, "value": 1.0}]


def _masked_bundle(bundle):
    return dict(bundle, ts=None, trace_id=None, metrics=_counters(bundle["metrics"]),
                env=dict(bundle["env"], pid=None, argv=None),
                spans=sorted(json.dumps(dict(r, t=None, seconds=None, thread=None,
                                             meta=_meta(r["meta"])), sort_keys=True)
                             for r in bundle["spans"]))


@pytest.mark.parametrize("name", ["scan_fault_no_degrade"])
def test_fault_escape_bundle_equal(runs, name):
    (port,), (jax,) = (runs[name, side]["bundles"].values() for side in ("port", "jax"))
    assert port["reason"] == jax["reason"] == "fault-escape"
    assert _masked_bundle(port) == _masked_bundle(jax)


def test_degradation_bundle_and_text_rung_counters_equal(runs):
    port, jax = runs["apply_fault", "port"], runs["apply_fault", "jax"]
    (port_bundle,) = port["bundles"].values()
    jax_bundles = sorted(jax["bundles"].values(), key=lambda b: b["ts"])
    first = _one_fetch(jax_bundles[0])
    assert first["degradation"] == {"from": "tpu", "to": "host"}
    first["degradation"] = {"from": "torch", "to": "text"}
    first["metrics"]["counters"]["merge_degradations_total"]["series"][0]["labels"]["to"] = "text"
    (row,) = [r for r in first["spans"] if r["name"] == "degradation"]
    row["meta"]["to"] = "text"
    assert port_bundle["degradation"] == {"from": "torch", "to": "text"}
    assert _masked_bundle(port_bundle) == _masked_bundle(first)

    def after(trace, bundle):
        final, at = _counters(trace["metrics"]), _counters(bundle["metrics"])
        return {k: v - at.get(k, 0) for k, v in final.items() if v != at.get(k, 0)}

    assert after(port["trace"], port_bundle) == after(jax["trace"], jax_bundles[-1])


def test_scan_raise_escapes_as_a_parse_fault_in_both(runs):
    for side in ("port", "jax"):
        run = runs["scan_raise_no_degrade", side]
        (tid, bundle), = run["bundles"].items()
        assert check_trace_schema.validate_postmortem(bundle) == []
        assert (bundle["reason"], bundle["fault"]["type"], bundle["fault"]["exit_code"]) == \
            ("fault-escape", "ParseFault", 10)
        assert run["stderr"].rstrip().endswith(f"(exit 10) [trace {tid}]")
        series = run["trace"]["metrics"]["counters"]["merge_faults_total"]["series"]
        assert [s["labels"]["fault"] for s in series] == ["ParseFault"]
    # Where: the JAX CLI's incremental scope scans in its snapshot stage.
    stages = {side: runs["scan_raise_no_degrade", side]["trace"]["metrics"]["counters"]
              ["merge_faults_total"]["series"][0]["labels"]["stage"] for side in ("port", "jax")}
    assert stages == {"port": "scan", "jax": "snapshot"}


# --- the artifact commands ---------------------------------------------------------

def _artifact_paths(runs):
    paths = {}
    for side in ("port", "jax"):
        root = runs["roots"]["fused_merge", side]
        paths[f"{side}-trace"] = root / TRACE
        paths[f"{side}-events"] = root / EVENTS
        fault_root = runs["roots"]["apply_fault", side]
        paths[f"{side}-bundle"] = sorted((fault_root / POSTMORTEM).glob("*.json"))[0]
        paths[f"{side}-fault-trace"] = fault_root / TRACE
    return paths


ARTIFACTS = ("port-trace", "jax-trace", "port-events", "port-bundle", "jax-bundle",
             "port-fault-trace")
COMMANDS = {"stats": ["stats"], "stats_json": ["stats", "--json"],
            "stats_prometheus": ["stats", "--prometheus"],
            "analyze": ["trace", "analyze"], "analyze_json": ["trace", "analyze", "--json"]}


def _both(capsys, argv):
    outs = []
    for main in (cli.main, jax_main):
        capsys.readouterr()
        code = main(argv)
        out, err = capsys.readouterr()
        outs.append((code, out, err))
    return outs


@pytest.mark.parametrize("artifact", ARTIFACTS)
@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_artifact_commands_print_the_jax_clis_bytes(runs, capsys, artifact, command):
    path = _artifact_paths(runs)[artifact]
    port, jax = _both(capsys, [*COMMANDS[command], str(path)])
    assert port == jax
    if artifact.endswith("trace") and command != "stats_json":
        assert port[0] == 0 and port[1]


def test_metrics_dump_stats_equal(runs, capsys, tmp_path):
    dump = tmp_path / "metrics.json"
    dump.write_text(json.dumps(runs["fused_merge", "port"]["trace"]["metrics"]))
    for argv in (["stats", str(dump)], ["stats", "--prometheus", str(dump)]):
        port, jax = _both(capsys, argv)
        assert port == jax and port[0] == 0


@pytest.mark.parametrize("pair", [("port-trace", "jax-trace"), ("jax-trace", "port-trace"),
                                  ("port-fault-trace", "port-trace"),
                                  ("port-bundle", "jax-bundle")])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_trace_diff_prints_the_jax_clis_bytes(runs, capsys, pair, as_json):
    paths = _artifact_paths(runs)
    argv = ["trace", "diff", str(paths[pair[0]]), str(paths[pair[1]])]
    port, jax = _both(capsys, argv + (["--json"] if as_json else []))
    assert port == jax and port[0] == 0


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_trace_analyze_directory_equal(runs, capsys, tmp_path, as_json):
    paths = _artifact_paths(runs)
    for key in ("port-trace", "jax-trace", "port-bundle", "port-events"):
        shutil.copy(paths[key], tmp_path / f"{key}{paths[key].suffix}")
    (tmp_path / "broken.json").write_text("{not json")
    port, jax = _both(capsys, ["trace", "analyze", str(tmp_path)]
                      + (["--json"] if as_json else []))
    assert port == jax and port[0] == 0


@pytest.mark.parametrize("argv", [["stats", "--daemon"], ["stats", "--fleet", "x.json"],
                                  ["trace", "analyze", "--fleet", "nowhere"],
                                  ["profile", "--daemon", "--seconds", "1"],
                                  ["perf", "compare", "BENCH_r01.json"]],
                         ids=lambda a: "_".join(a[:2]))
def test_unported_forms_exit_70_before_reading(capsys, tmp_path, monkeypatch, argv):
    """``stats --daemon`` (the merge service), ``profile --daemon`` and
    ``perf`` (the live tools) and the fleet forms (``stats --fleet``
    reads a trace artifact, ``trace analyze --fleet`` a stitched one)
    are ported: with no daemon on the socket, no artifact and no
    baseline in the working directory, they answer as the JAX CLI does
    (1, 1, 2, 1 and 1, its stderr) and read nothing."""
    monkeypatch.chdir(tmp_path)  # nothing there to read
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(tmp_path / "none.sock"))
    capsys.readouterr()
    port, jax = _both(capsys, argv)
    assert port == jax and port[0] == (2 if argv[0] == "perf" else 1)
    assert port[1] == "" and port[2].startswith("error: no ")
    assert list(tmp_path.iterdir()) == []


# --- --profile and the untraced path ----------------------------------------------------

def test_profile_writes_trace_and_phase_ranges_twice_in_one_process(runs, capsys, tmp_path):
    root = runs["roots"]["fused_diff", "port_plain"]
    dirs = [tmp_path / "p1", tmp_path / "p2"]
    for d in dirs:
        code, out, _ = _run_port(root, ["semdiff", "basebr", "brA", "--json-out",
                                        "--profile", str(d)], None, capsys)
        assert code == 0 and out == runs["fused_diff", "port"]["stdout"]
    for d in dirs:
        phases = json.loads((d / "semmerge-trace.json").read_text())
        assert check_trace_schema.validate_trace(phases) == []
        assert [p["name"] for p in phases["phases"]] == ["snapshot", "diff"]
        assert {s["name"] for s in phases["spans"]} >= {"snapshot", "diff", "scan"}
        (torch_trace,) = d.glob("*.pt.trace.json")
        names = {e.get("name") for e in json.loads(torch_trace.read_text())["traceEvents"]}
        assert {"semmerge/snapshot", "semmerge/diff"} <= names
    assert not (root / TRACE).exists()  # --profile alone writes no .semmerge-trace.json
    assert port_trace._open_session is None
    failures = metrics.REGISTRY.counter(port_trace.PROFILER_FAILURES)
    assert failures._labelled() == []


def test_untraced_run_records_no_spans_and_starts_no_profiler(runs, capsys, monkeypatch):
    import torch
    root = runs["roots"]["fused_diff", "port_plain"]
    started = []
    monkeypatch.setattr(port_trace, "start_profiler_session",
                        lambda cuda: started.append(cuda))
    code, _, _ = _run_port(root, ["semdiff", "basebr", "brA"], None, capsys)
    assert code == 0 and started == []
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not (root / TRACE).exists() and not (root / EVENTS).exists()
    assert spans.current() is None
    # The always-on layer still saw the phases (histogram and ring).
    assert {"snapshot", "diff", "scan"} <= set(metrics.phase_totals())
    assert {"snapshot", "diff", "scan"} <= {r["name"] for r in flight.snapshot()}


@pytest.mark.parametrize("holder", ["live-thread", "ended-thread"])
def test_a_session_of_another_thread_is_never_cancelled(tmp_path, holder):
    """One profiler session per process: while the thread that started
    the open session runs, a start from another thread is refused
    (``busy``) and the holder's capture stays whole; once that thread has
    ended, its session is stale and the next start replaces it."""
    import threading
    started, release, box = threading.Event(), threading.Event(), {}

    def hold():
        box["session"] = port_trace.start_profiler_session(False)
        started.set()
        if holder == "live-thread":
            release.wait(60)
            box["stopped"] = port_trace.stop_profiler_session(box["session"],
                                                              str(tmp_path / "holder"))

    thread = threading.Thread(target=hold)
    thread.start()
    assert started.wait(60) and box["session"] is not None
    if holder == "ended-thread":
        thread.join(60)
    failures = metrics.REGISTRY.counter(port_trace.PROFILER_FAILURES)
    busy = failures.value(reason="busy")
    tracer = port_trace.Tracer(profile_dir=str(tmp_path / "second"), cuda=False)
    with tracer.phase("second"):
        sum(range(1000))
    tracer.write()
    second_traced = bool(list((tmp_path / "second").glob("*.pt.trace.json")))
    if holder == "live-thread":
        assert not second_traced and failures.value(reason="busy") == busy + 1
        release.set()
        thread.join(60)
        assert box["stopped"] and list((tmp_path / "holder").glob("*.pt.trace.json"))
    else:
        assert second_traced and failures.value(reason="busy") == busy
    assert port_trace._open_session is None


def test_a_session_left_open_does_not_block_the_next_capture(tmp_path):
    # An aborted capture in a warm process: started, never stopped.
    stale = port_trace.start_profiler_session(False)
    assert stale is not None and port_trace._open_session is stale
    tracer = port_trace.Tracer(profile_dir=str(tmp_path), cuda=False)
    with tracer.phase("after_stale"):
        sum(range(1000))
    tracer.write()
    assert port_trace._open_session is None
    (torch_trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(torch_trace.read_text())["traceEvents"]}
    assert "semmerge/after_stale" in names
    phases = json.loads((tmp_path / "semmerge-trace.json").read_text())["phases"]
    assert [p["name"] for p in phases] == ["after_stale"]
