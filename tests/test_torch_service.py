"""The port's merge service against the JAX package's one-shot CLI.

A port daemon (``python -m semantic_merge_tpu_torch serve --device cpu``
on a socket under ``tmp_path``, short ``--idle-exit``, killed in
teardown) serves ``semdiff``, ``semmerge --inplace`` and ``semrebase``
from client processes (``SEMMERGE_DAEMON=require``); the JAX CLI runs the
same commands one-shot (``--backend tpu``, ``JAX_PLATFORMS=cpu``) in
copies of the same repositories. Stdout, exit code, work tree, notes and
``.semmerge-conflicts.json`` must be equal. Also:

- ``require`` without a daemon exits 12; ``auto`` spawns ``python -m
  semantic_merge_tpu_torch serve``;
- a full queue exits 12, an expired request deadline 15, and SIGTERM
  drains the daemon to exit 0;
- same-repo ``--inplace`` requests never execute at once;
- warm residency: a hit through the daemon, and in-process each stale
  outcome (interner reset, a tree gone from the repository, an epoch
  bump);
- a circuit breaker opens after repeated faults, skips the semantic
  rung, and closes again through a half-open probe;
- ``/metrics`` and ``/healthz``; ``stats --daemon``;
- the ``status`` keys equal the JAX daemon's (values masked), plus
  ``package`` and ``device``;
- a JAX daemon on the socket is never used (``require`` exits 12,
  ``auto`` runs one-shot, ``serve`` exits 12);
- the live tools: each served request's trace reaches an OTLP collector
  (``SEMMERGE_OTLP_ENDPOINT``), ``profile --daemon`` captures (back to
  back, ``busy`` while one runs, a bundle with the JAX daemon's bundle
  keys, the SLO autoprofile once), a capture beside a ``--profile``
  request leaves the request's bytes the one-shot bytes, ``top`` and
  ``perf --daemon``;
- the settings still refused exit 70, the forms ported since give the
  JAX CLI's answer, and ``serve`` without a card exits 11 before it
  binds.

Every wait has a timeout; no daemon outlives its test module.
"""
from __future__ import annotations

import gc
import http.server
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from semantic_merge_tpu import cli as jax_cli
from semantic_merge_tpu.service import client as jax_client
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.backends import ts_torch
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot, annotate_residency
from semantic_merge_tpu_torch.obs import metrics
from semantic_merge_tpu_torch.service import client, protocol, residency, resilience
from semantic_merge_tpu_torch.utils import faults

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
WAIT = 90  # seconds: the bound on every subprocess and socket wait

_FOO = "export function foo(n: number): number {\n  return n;\n}\n"
_BAZ = "export function baz(): void {}\n"
#: name → (base, A, B)
REPOS = {
    "rename": ({"src/util.ts": _FOO + _BAZ},
               {"src/util.ts": _FOO.replace("foo", "bar") + _BAZ},
               {"lib/util.ts": _FOO + _BAZ, "src/util.ts": None}),
    "conflict": ({"src/util.ts": _FOO},
                 {"src/util.ts": _FOO.replace("foo", "bar")},
                 {"src/util.ts": _FOO.replace("foo", "qux")}),
}
#: A merge whose text rung is clean too (the breaker tests).
TEXT_CLEAN = ({"a.ts": _FOO, "b.ts": _BAZ}, {"a.ts": _FOO.replace("foo", "bar"), "b.ts": _BAZ},
              {"a.ts": _FOO, "b.ts": _BAZ.replace("baz", "qux")})
#: The commands run in each repository, in order, by both packages.
COMMANDS = {
    "rename": [["semdiff", "basebr", "brA", "--json-out"],
               ["semmerge", "basebr", "brA", "brB", "--inplace"],
               ["semrebase", "brA", "brB", "--inplace"]],
    "conflict": [["semmerge", "basebr", "brA", "brB", "--inplace"]],
}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")
    env.update(extra)
    return env


def git(args, cwd, **kw):
    return subprocess.run(["git", *args], cwd=cwd, check=True, env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                          timeout=WAIT, **kw).stdout


def make_repo(root, base, a, b):
    root.mkdir(parents=True)
    git(["init", "-q", "-b", "main"], root)
    git(["config", "user.email", "t@example.com"], root)
    git(["config", "user.name", "t"], root)

    def commit(files, msg):
        for rel, text in files.items():
            path = root / rel
            if text is None:
                path.unlink()
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
        git(["add", "-A"], root)
        git(["commit", "-q", "--allow-empty", "-m", msg], root)

    commit(base, "base")
    git(["branch", "basebr"], root)
    git(["checkout", "-qb", "brA"], root)
    commit(a, "A")
    git(["checkout", "-q", "main"], root)
    git(["checkout", "-qb", "brB"], root)
    commit(b, "B")
    git(["checkout", "-q", "main"], root)
    return root


def tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and ".git" not in p.relative_to(root).parts
            and ".semmerge-postmortem" not in p.relative_to(root).parts}


def notes(root):
    out = {}
    for rev in ("brA", "brB"):
        proc = subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                              timeout=WAIT)
        out[rev] = proc.stdout if proc.returncode == 0 else None
    return out


def run_cli(package, argv, cwd, **env):
    flags = ["--device", "cpu"] if package == "semantic_merge_tpu_torch" else (
        ["--backend", "tpu"] if argv[0] != "semrebase" else [])
    proc = subprocess.run([sys.executable, "-m", package, *argv, *flags], cwd=cwd,
                          env=_env(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=WAIT)
    return proc.returncode, proc.stdout, proc.stderr


def wait_for_hello(sock, proc=None, timeout=WAIT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        answer = client.hello(str(sock), timeout=1.0)
        if answer is not None:
            return answer
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"daemon exited {proc.returncode}: "
                                 f"{pathlib.Path(str(sock) + '.out').read_text()}")
        time.sleep(0.1)
    raise AssertionError(f"no daemon on {sock} after {timeout}s")


def start_daemon(sock, *extra, package="semantic_merge_tpu_torch", **env):
    argv = [sys.executable, "-m", package, "serve", "--socket", str(sock),
            "--idle-exit", "120", *extra]
    if package == "semantic_merge_tpu_torch":
        argv += ["--device", "cpu"]
    with open(str(sock) + ".out", "wb") as log:  # the daemon's stdio, never a full pipe
        return subprocess.Popen(argv, env=_env(**env), stdout=log, stderr=subprocess.STDOUT)


def stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode


def status(sock):
    return client.call_control("status", path=str(sock))


class Collector:
    """A loopback OTLP/HTTP collector on a thread: every POST's path and
    JSON body; ``hold`` makes every POST wait on ``release``."""

    def __init__(self, hold=False):
        self.received, self.entered = [], threading.Event()
        self.release = threading.Event()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                outer.entered.set()
                if hold:
                    outer.release.wait(30)
                outer.received.append((self.path, json.loads(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.release.set()
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The repositories (a ``jax`` and a ``port`` copy of each), the JAX
    CLI's one-shot results, a port daemon (with ``/metrics``, exporting
    to ``world["collector"]``) and a JAX daemon, each on its own
    socket."""
    work = tmp_path_factory.mktemp("svc")
    origins = {name: make_repo(work / f"origin-{name}", *trees)
               for name, trees in REPOS.items()}
    roots = {}
    for name, origin in origins.items():
        for side in ("jax", "port", "lock"):
            roots[name, side] = work / f"{name}-{side}"
            shutil.copytree(origin, roots[name, side])
    for side in ("jax", "port"):
        # The whole tree: a resident base is keyed by its incremental
        # scope too, and the semdiff's scope is not the semmerge's.
        (roots["rename", side] / ".semmerge.toml").write_text(
            "[engine]\nincremental = false\n")
    collector = Collector()
    world = {"work": work, "roots": roots, "sock": work / "port.sock",
             "jax_sock": work / "jax.sock", "collector": collector}
    daemons = [start_daemon(world["sock"], SEMMERGE_METRICS_PORT="0",
                            SEMMERGE_OTLP_ENDPOINT=collector.endpoint),
               start_daemon(world["jax_sock"], package="semantic_merge_tpu")]
    try:
        def jax_chain(name):
            return [run_cli("semantic_merge_tpu", argv, roots[name, "jax"])
                    for argv in COMMANDS[name]]

        with ThreadPoolExecutor(2) as pool:
            jax_runs = dict(zip(COMMANDS, pool.map(jax_chain, COMMANDS)))
        world["jax"] = jax_runs
        world["port_daemon"], world["jax_daemon"] = daemons
        wait_for_hello(world["sock"], daemons[0])
        t0 = time.monotonic()
        while time.monotonic() - t0 < WAIT and \
                jax_client._try_connect(str(world["jax_sock"]), timeout=1.0) is None:
            time.sleep(0.2)
        yield world
    finally:
        for proc in daemons:
            stop(proc)
        collector.close()


def _port_via_daemon(world, name):
    return [run_cli("semantic_merge_tpu_torch", argv, world["roots"][name, "port"],
                    SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(world["sock"]))
            for argv in COMMANDS[name]]


@pytest.fixture(scope="module")
def served(world):
    before = status(world["sock"])["served_total"]
    runs = {name: _port_via_daemon(world, name) for name in COMMANDS}
    return {"runs": runs, "before": before, "after": status(world["sock"])}


# --- parity with the JAX one-shot CLI -------------------------------------------------

@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_daemon_serves_the_jax_clis_bytes(world, served, name):
    port, jax = served["runs"][name], world["jax"][name]
    for argv, (pc, pout, perr), (jc, jout, jerr) in zip(COMMANDS[name], port, jax):
        assert pc == jc, (argv, perr, jerr)
        if argv[0] != "semrebase":
            assert pout == jout, argv
    port_root, jax_root = world["roots"][name, "port"], world["roots"][name, "jax"]
    assert tree_bytes(port_root) == tree_bytes(jax_root)
    assert notes(port_root) == notes(jax_root)
    if name == "conflict":
        assert port[0][0] == 1
        conflicts = json.loads((port_root / ".semmerge-conflicts.json").read_text())
        assert conflicts[0]["category"] == "DivergentRename"
    else:
        assert [run[0] for run in port] == [0, 0, 0]
        assert '"type": "renameSymbol"' in port[0][1]


def test_daemon_counts_requests_and_a_residency_hit(world, served):
    after = served["after"]
    assert after["served_total"] - served["before"] == sum(map(len, COMMANDS.values()))
    assert after["package"] == protocol.PACKAGE and after["device"]["platform"] == "cpu"
    # The rename repo's semmerge hits the base its semdiff made resident.
    assert after["residency"]["hits"] >= 1 and after["residency"]["enabled"]
    assert after["batch"]["requests_batched"] >= 2 and after["batch"]["device"] == "cpu"
    assert after["declcache"]["hits"] > 0


def test_status_keys_equal_the_jax_daemons(world):
    port = status(world["sock"])
    jax = jax_client.call_control("status", path=str(world["jax_sock"]))
    assert set(port) == set(jax) | {"package", "device"}
    assert "package" not in jax
    for block in ("resilience", "residency", "sampling", "window"):
        assert set(port[block]) == set(jax[block]), block
    assert set(port["batch"]) == set(jax["batch"]) | {"device"}
    for block in ("mesh", "program_cache"):
        assert set(port["batch"][block]) == set(jax["batch"][block]), block


def test_stats_daemon_renders_the_live_status(world, capsys, monkeypatch):
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(world["sock"]))
    capsys.readouterr()
    assert cli.main(["stats", "--daemon"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("daemon pid=") and "residency: on" in out and "batch:" in out
    assert cli.main(["stats", "--daemon", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["package"] == protocol.PACKAGE


def test_metrics_and_healthz(world, served):
    port = status(world["sock"])["metrics_port"]
    assert isinstance(port, int) and port > 0
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
        text = resp.read().decode()
    assert resp.status == 200 and "service_requests_total" in text
    assert "service_request_seconds_bucket" in text
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
        health = json.loads(resp.read())
    assert resp.status == 200 and health["ok"] and health["degraded"] is False


# --- the live tools ---------------------------------------------------------------------

def _counter(st, name, **labels):
    series = st["metrics"]["counters"].get(name, {}).get("series", [])
    return sum(x["value"] for x in series
               if all(x["labels"].get(k) == v for k, v in labels.items()))


def test_daemon_ships_one_trace_per_served_request(world, served):
    """With ``SEMMERGE_OTLP_ENDPOINT`` every executed request's span tree
    reaches the collector once, under its trace id (left-padded to 32
    hex digits), and passes ``validate_export``."""
    from test_torch_export import _schema
    root = world["roots"]["rename", "lock"]
    resp = client.call_verb("semdiff", {"argv": ["basebr", "brA", "--device", "cpu"],
                                        "cwd": str(root), "env": {},
                                        "trace_id": "00c0ffee00c0ffee"},
                            path=str(world["sock"]), timeout=WAIT)
    assert resp["result"]["exit_code"] == 0
    t0 = time.monotonic()
    while True:
        st = status(world["sock"])
        exported = _counter(st, "otlp_exported_total", kind="traces")
        if exported >= st["served_total"] or time.monotonic() - t0 > WAIT:
            break
        time.sleep(0.1)
    traces = [body for path, body in world["collector"].received if path == "/v1/traces"]
    assert exported == st["served_total"] == len(traces) >= 5
    assert _counter(st, "otlp_errors_total") == 0
    schema, ids = _schema(), []
    for body in traces:
        assert schema.validate_export(body) == []
        (scope,) = body["resourceSpans"][0]["scopeSpans"]
        assert scope["scope"]["name"] == protocol.PACKAGE
        (tid,) = {sp["traceId"] for sp in scope["spans"]}
        ids.append(tid)
    assert len(set(ids)) == len(ids) and "0" * 16 + "00c0ffee00c0ffee" in ids
    names = {sp["name"] for body in traces
             for sp in body["resourceSpans"][0]["scopeSpans"][0]["spans"]}
    assert {"service.queue_wait", "service.execute"} <= names


def _capture(world, out_dir, seconds=0.2):
    return client.capture_profile(seconds, out_dir=str(out_dir), path=str(world["sock"]))


def _bundle(result):
    return json.loads((pathlib.Path(result["dir"]) / "bundle.json").read_text())


def test_back_to_back_captures_each_give_a_bundle(world, tmp_path):
    before = _counter(status(world["sock"]), "profile_captures_total", result="ok")
    dirs = []
    for _ in range(2):
        result = _capture(world, tmp_path)
        assert result["ok"] and result["profiler_started"] and result["seconds"] == 0.2
        assert "bundle.json" in result["files"] and \
            any(f.endswith(".pt.trace.json") for f in result["files"])
        bundle = _bundle(result)
        assert bundle["schema"] == 1 and bundle["metrics_after"]["counters"]
        assert bundle["pid"] == status(world["sock"])["pid"]
        dirs.append(pathlib.Path(result["dir"]).name)
    assert len(set(dirs)) == 2 and all(d.startswith("profile-") for d in dirs)
    after = _counter(status(world["sock"]), "profile_captures_total", result="ok")
    assert after == before + 2


def test_a_second_capture_answers_busy(world, tmp_path):
    box = {}
    thread = threading.Thread(target=lambda: box.update(r=_capture(world, tmp_path, 0.3)))
    before = _counter(status(world["sock"]), "profile_captures_total", result="busy")
    thread.start()
    t0 = time.monotonic()
    while not list(tmp_path.glob("profile-*")) and time.monotonic() - t0 < WAIT:
        time.sleep(0.01)
    t1 = time.monotonic()
    busy = _capture(world, tmp_path / "second", 5.0)
    assert time.monotonic() - t1 < 5.0  # answered at once, not after its window
    thread.join(timeout=WAIT)
    assert busy == {"ok": False, "error": "a profile capture is already in progress"}
    assert box["r"]["ok"] and not (tmp_path / "second").exists()
    assert _counter(status(world["sock"]), "profile_captures_total",
                    result="busy") == before + 1


def test_the_bundle_keys_equal_the_jax_daemons(world, tmp_path):
    port = _bundle(_capture(world, tmp_path / "port"))
    jax_result = jax_client.capture_profile(0.2, out_dir=str(tmp_path / "jax"),
                                            path=str(world["jax_sock"]))
    jax = json.loads((pathlib.Path(jax_result["dir"]) / "bundle.json").read_text())
    assert set(port) == set(jax)
    assert set(_capture(world, tmp_path / "again")) == set(jax_result)


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_profile_cli_against_the_daemon(world, tmp_path, capsys, as_json):
    capsys.readouterr()
    code = cli.main(["profile", "--daemon", "--seconds", "0.2", "--out", str(tmp_path),
                     "--socket", str(world["sock"])] + (["--json"] if as_json else []))
    out = capsys.readouterr().out
    assert code == 0
    (bundle_dir,) = tmp_path.glob("profile-*")
    if as_json:
        result = json.loads(out)
        assert result["ok"] and result["dir"] == str(bundle_dir)
    else:
        lines = out.splitlines()
        assert lines[0] == f"profile bundle: {bundle_dir}"
        assert lines[1] == "  window: 0.2s  profiler_started=True"
        assert "  bundle.json" in lines[2:]


@pytest.mark.parametrize("first", ["capture", "request"])
def test_a_capture_beside_a_profiled_request_keeps_its_bytes(world, tmp_path, first):
    """The process holds one profiler session: whichever of a daemon
    capture and a ``--profile DIR`` request comes second runs without
    it (counted as ``busy``). The request's answer is the one-shot
    bytes either way. ``request`` first is made certain by a 1 s hang
    inside its scan, with the capture started 0.3 s into it."""
    root, sock = world["roots"]["rename", "lock"], str(world["sock"])
    env = {"SEMMERGE_FAULT": "scan:hang=1"} if first == "request" else {}
    params = {"argv": ["basebr", "brA", "--json-out", "--device", "cpu", "--profile",
                       str(tmp_path / "request")], "cwd": str(root), "env": env}
    busy_before = _counter(status(sock), "profiler_capture_failures_total", reason="busy")
    box = {}
    request = threading.Thread(target=lambda: box.update(
        resp=client.call_verb("semdiff", params, path=sock, timeout=WAIT)))
    capture = threading.Thread(target=lambda: box.update(
        cap=_capture(world, tmp_path / "capture", 0.3)))
    t0 = time.monotonic()
    if first == "capture":
        capture.start()
        while not list((tmp_path / "capture").glob("profile-*")) and \
                time.monotonic() - t0 < WAIT:
            time.sleep(0.005)
        request.start()
    else:
        request.start()
        while status(sock)["in_flight"] < 1 and time.monotonic() - t0 < WAIT:
            time.sleep(0.01)
        time.sleep(0.3)
        capture.start()
    for thread in (request, capture):
        thread.join(timeout=WAIT)
    result, cap = box["resp"]["result"], box["cap"]
    assert (result["exit_code"], result["stdout"]) == world["jax"]["rename"][0][:2]
    assert cap["ok"]
    request_traced = bool(list((tmp_path / "request").glob("*.pt.trace.json")))
    assert (tmp_path / "request" / "semmerge-trace.json").is_file()
    busy = _counter(status(sock), "profiler_capture_failures_total", reason="busy") \
        - busy_before
    if first == "request":
        assert request_traced and not cap["profiler_started"] and busy == 1
    else:
        # The capture held the session; the request lost it unless it
        # only started after the window closed.
        assert cap["profiler_started"] and busy == (0 if request_traced else 1)


def test_slo_autoprofile_captures_once(world, tmp_path):
    """``SEMMERGE_SLO_AUTOPROFILE``: the first SLO trip of the daemon's
    life starts one capture into ``SEMMERGE_PROFILE_DIR``; later
    evaluations of the burning objective start none."""
    sock, profiles = tmp_path / "slo.sock", tmp_path / "profiles"
    proc = start_daemon(sock, SEMMERGE_SLO="diff:p50<1ms", SEMMERGE_SLO_EVAL_INTERVAL="0.1",
                        SEMMERGE_SLO_AUTOPROFILE="1", SEMMERGE_PROFILE_DIR=str(profiles),
                        SEMMERGE_POSTMORTEM_DIR=str(tmp_path / "pm"))
    try:
        wait_for_hello(sock, proc)
        root = world["roots"]["rename", "lock"]
        for _ in range(2):
            resp = client.call_verb("semdiff", {"argv": ["basebr", "brA", "--device", "cpu"],
                                                "cwd": str(root), "env": {}},
                                    path=str(sock), timeout=WAIT)
            assert resp["result"]["exit_code"] == 0
        t0 = time.monotonic()
        while not list(profiles.glob("profile-*/bundle.json")) and \
                time.monotonic() - t0 < WAIT:
            time.sleep(0.1)
        time.sleep(1.0)  # ten more evaluations of the burning objective
        (bundle,) = profiles.glob("profile-*/bundle.json")
        assert json.loads(bundle.read_text())["seconds"] == 1.0
        st = status(sock)
        assert st["slo"]["healthy"] is False
        assert _counter(st, "profile_captures_total", result="ok") == 1
    finally:
        stop(proc)


@pytest.mark.parametrize("tool", ["top-json", "top", "perf"])
def test_top_and_perf_against_the_daemon(world, tmp_path, monkeypatch, capsys, tool):
    monkeypatch.chdir(tmp_path)  # outside the checkout
    sock = str(world["sock"])
    capsys.readouterr()
    if tool == "perf":
        base = str(tmp_path / "base.json")
        assert cli.main(["perf", "record", "--daemon", "--socket", sock, "--baseline",
                         base]) == 0
        assert capsys.readouterr().out == f"recorded 1 entry into {base}: daemon\n"
        entry = json.loads(pathlib.Path(base).read_text())["entries"]["daemon"]
        assert entry["source"] == "cumulative-histogram" and entry["unit"] == "ms"
        assert cli.main(["perf", "compare", "--daemon", "--socket", sock, "--baseline",
                         base]) == 0
        assert capsys.readouterr().out.startswith(f"perf compare vs {base}: OK\n")
        return
    st = status(world["sock"])
    assert cli.main(["top", "--once", "--socket", sock]
                    + (["--json"] if tool == "top-json" else [])) == 0
    out = capsys.readouterr().out
    if tool == "top-json":
        snap = json.loads(out)
        assert snap["members"] is None and snap["status"]["package"] == protocol.PACKAGE
        assert snap["status"]["served_total"] == st["served_total"]
        # Every block the frame reads is in the port daemon's status.
        frame_reads = snap["status"]
        assert {"1s", "1m"} <= set(frame_reads["window"])
        assert "breakers" in frame_reads["resilience"]
        assert {"lookups", "hit_rate"} <= set(frame_reads["residency"])
        assert "last_rows_per_chip" in frame_reads["batch"]["mesh"]
        assert "enabled" in frame_reads["sampling"] and "latched" in frame_reads["anomaly"]
        assert {"trace_store", "slo"} <= set(frame_reads)
    else:
        assert out.startswith(f"semmerge top — merge daemon pid {st['pid']}  uptime ")
        assert f"served {st['served_total']:>6}" in out


# --- the same-repo lock ----------------------------------------------------------------

def test_same_repo_inplace_requests_never_overlap(world):
    root = world["roots"]["rename", "lock"]
    params = {"argv": ["basebr", "brA", "brB", "--inplace", "--device", "cpu"],
              "cwd": str(root), "env": {"SEMMERGE_FAULT": "service:execute:hang=1"}}
    results = [None, None]

    def one(i):
        results[i] = client.call_verb("semmerge", dict(params), path=str(world["sock"]),
                                      timeout=WAIT)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    metas = sorted((r["result"]["meta"] for r in results), key=lambda m: m["t_execute_start"])
    assert all(r["result"]["exit_code"] == 0 for r in results)
    assert metas[0]["t_execute_end"] <= metas[1]["t_execute_start"]
    assert metas[1]["t_execute_start"] - metas[0]["t_execute_start"] >= 1.0


# --- a JAX daemon on the socket --------------------------------------------------------

def test_a_jax_daemon_is_never_used(world, tmp_path):
    """The client spawns a port daemon on the JAX daemon's socket, which
    finds the socket held by another package and exits 12."""
    jsock = str(world["jax_sock"])
    root = tmp_path / "r"
    shutil.copytree(world["roots"]["conflict", "jax"].parent / "origin-rename", root)
    before = jax_client.call_control("status", path=jsock)["served_total"]
    code, out, err = run_cli("semantic_merge_tpu_torch", ["semdiff", "basebr", "brA"], root,
                             SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=jsock,
                             SEMMERGE_SERVICE_RETRIES="0", SEMMERGE_SERVICE_RECONNECT="0.2")
    assert code == 12 and "daemon required but unavailable" in err and out == ""
    code, out, _ = run_cli("semantic_merge_tpu_torch", ["semdiff", "basebr", "brA", "--json-out"],
                           root, SEMMERGE_DAEMON="auto", SEMMERGE_SERVICE_SOCKET=jsock,
                           SEMMERGE_SERVICE_RETRIES="0", SEMMERGE_SERVICE_RECONNECT="0.2")
    assert code == 0 and out == world["jax"]["rename"][0][1]  # one-shot, on this process
    assert jax_client.call_control("status", path=jsock)["served_total"] == before
    proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", "serve",
                           "--device", "cpu", "--socket", jsock], env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=WAIT)
    assert proc.returncode == 12 and "another package" in proc.stderr
    assert client.hello(jsock).get("package") != protocol.PACKAGE  # still the JAX daemon


def test_a_daemon_of_another_checkout_is_never_used(tmp_path):
    """A port daemon whose ``hello`` names another checkout of the
    package is no daemon to this checkout's client, nor to a daemon that
    would bind its socket."""
    path = str(tmp_path / "other.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(4)
    listener.settimeout(WAIT)

    def answer_hellos(n):
        for _ in range(n):
            conn, _ = listener.accept()
            with conn, conn.makefile("r", encoding="utf-8") as rf, \
                    conn.makefile("w", encoding="utf-8") as wf:
                msg = protocol.read_message(rf)
                protocol.write_message(wf, {"id": msg["id"], "result": {
                    "ok": True, "pid": 1, "version": protocol.PROTOCOL_VERSION,
                    "draining": False, "package": protocol.PACKAGE,
                    "checkout": str(tmp_path / "another-checkout")}})

    server = threading.Thread(target=answer_hellos, args=(2,), daemon=True)
    server.start()
    try:
        answer = client.hello(path)
        assert answer["package"] == protocol.PACKAGE and not protocol.is_ours(answer)
        assert client._try_connect(path) is None
        server.join(timeout=WAIT)
        assert not server.is_alive()
    finally:
        listener.close()
    assert protocol.is_ours({"package": protocol.PACKAGE, "checkout": protocol.CHECKOUT})
    assert protocol.CHECKOUT == str(pathlib.Path(cli.__file__).resolve().parent)


# --- the client's postures ---------------------------------------------------------------

def test_require_without_a_daemon_exits_12(world, tmp_path):
    """No daemon, and the one the client spawns cannot bind (a socket
    path past the unix limit of 108 bytes): ``require`` exits 12."""
    root = world["roots"]["rename", "lock"]
    far = tmp_path / ("d" * 110)
    far.mkdir()
    code, out, err = run_cli("semantic_merge_tpu_torch", ["semdiff", "basebr", "brA"], root,
                             SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_RETRIES="0",
                             SEMMERGE_SERVICE_SOCKET=str(far / "none.sock"))
    assert code == 12 and out == "" and "daemon required but unavailable" in err


def test_auto_spawns_the_ports_daemon(world, tmp_path):
    sock = tmp_path / "auto.sock"
    root = world["roots"]["rename", "lock"]
    try:
        code, out, _ = run_cli("semantic_merge_tpu_torch",
                               ["semdiff", "basebr", "brA", "--json-out"], root,
                               SEMMERGE_DAEMON="auto", SEMMERGE_SERVICE_SOCKET=str(sock),
                               SEMMERGE_SERVICE_IDLE_EXIT="60")
        assert code == 0 and out == world["jax"]["rename"][0][1]
        answer = client.hello(str(sock))
        assert answer is not None and answer["package"] == protocol.PACKAGE
        st = status(sock)
        assert st["served_total"] == 1 and st["device"]["platform"] == "cpu"
        cmdline = pathlib.Path(f"/proc/{answer['pid']}/cmdline").read_bytes().split(b"\0")
        # A --device cpu request spawns its daemon on the CPU.
        assert cmdline[1:] == [b"-m", b"semantic_merge_tpu_torch", b"serve", b"--socket",
                               str(sock).encode(), b"--device", b"cpu", b""]
    finally:
        answer = client.hello(str(sock))
        if answer is not None:
            client.call_control("shutdown", path=str(sock))
            t0 = time.monotonic()
            while time.monotonic() - t0 < WAIT and client.hello(str(sock)) is not None:
                time.sleep(0.1)


def test_queue_full_12_deadline_15_and_sigterm_drains(world, tmp_path):
    sock = tmp_path / "q.sock"
    root = world["roots"]["rename", "lock"]
    proc = start_daemon(sock, "--workers", "1", "--queue", "1")
    try:
        wait_for_hello(sock, proc)
        base = [sys.executable, "-m", "semantic_merge_tpu_torch", "semdiff", "basebr", "brA",
                "--device", "cpu"]
        common = dict(SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(sock),
                      SEMMERGE_SERVICE_RETRIES="0")
        busy = subprocess.Popen(base, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_env(SEMMERGE_FAULT="service:execute:hang=8", **common))
        t0 = time.monotonic()
        while status(sock)["in_flight"] < 1 and time.monotonic() - t0 < WAIT:
            time.sleep(0.05)
        late = subprocess.Popen(base, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_env(SEMMERGE_SERVICE_DEADLINE="1", **common))
        while status(sock)["queue_depth"] < 1 and time.monotonic() - t0 < WAIT:
            time.sleep(0.05)
        full = run_cli("semantic_merge_tpu_torch", ["semdiff", "basebr", "brA"], root, **common)
        assert full[0] == 12 and "queue full" in full[2]
        assert late.wait(timeout=WAIT) == 15
        assert "DeadlineFault" in late.stderr.read()
        assert busy.wait(timeout=WAIT) == 0
        assert stop(proc) == 0  # SIGTERM: drain, then exit 0
        assert not sock.exists()
    finally:
        stop(proc)


# --- residency, in-process -----------------------------------------------------------------

@pytest.fixture
def residency_on(monkeypatch):
    monkeypatch.setenv("SEMMERGE_RESIDENCY_CACHE", "on")
    residency.cache().reset()
    ts_torch.reset_shared_interner()
    yield residency.cache()
    residency.cache().reset()


def _snaps(trees):
    return [Snapshot(files=[{"path": p, "content": c} for p, c in sorted(t.items()) if c])
            for t in trees]


def _outcome(name):
    return metrics.REGISTRY.counter("snapshot_residency_hits_total").value(outcome=name)


def test_residency_hit_then_each_stale_outcome(residency_on, world):
    trees = REPOS["rename"]
    repo = world["roots"]["rename", "lock"]
    oid = git(["rev-parse", "basebr^{tree}"], repo, text=True).strip()
    kw = dict(seed="s", base_rev="r", timestamp="2026-01-02T03:04:05Z")

    def merge(key=(str(repo), oid)):
        snaps = _snaps(trees)
        annotate_residency(snaps[0], *key)
        be = ts_torch.TorchTSBackend(device="cpu")
        result, composed, _ = be.merge(*snaps, **kw)
        return [o.to_dict() for o in composed], be.phases["residency_hits"]

    cold, hits = merge()
    assert hits == 0 and residency_on.stats()["entries"] == 1
    before = {k: _outcome(k) for k in ("hit", "stale-interner", "stale-epoch", "stale-tree")}
    warm, hits = merge()
    assert (warm, hits) == (cold, 1) and _outcome("hit") == before["hit"] + 1
    ts_torch.reset_shared_interner()
    assert merge() == (cold, 0)
    assert _outcome("stale-interner") == before["stale-interner"] + 1
    residency_on.bump_epoch()
    assert merge() == (cold, 0)
    assert _outcome("stale-epoch") == before["stale-epoch"] + 1
    gone = (str(repo), "0" * 40)  # a tree the repository does not hold
    assert merge(gone) == (cold, 0)
    assert merge(gone) == (cold, 0)
    assert _outcome("stale-tree") == before["stale-tree"] + 1
    assert residency_on.stats()["evictions"]["stale"] == 3


def test_residency_is_off_in_one_shot_processes(monkeypatch):
    monkeypatch.delenv("SEMMERGE_RESIDENCY_CACHE", raising=False)
    monkeypatch.delenv("_SEMMERGE_IN_DAEMON", raising=False)
    assert not residency.residency_enabled()
    assert not ts_torch.TorchTSBackend(device="cpu")._interner.shared


# --- circuit breakers ------------------------------------------------------------------------

def test_breaker_opens_skips_the_rung_then_half_open_closes(world, tmp_path, monkeypatch,
                                                             capsys):
    root = make_repo(tmp_path / "b", *TEXT_CLEAN)
    monkeypatch.chdir(root)
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("SEMMERGE_BREAKER", "on")
    monkeypatch.setenv("SEMMERGE_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("SEMMERGE_BREAKER_COOLDOWN", "0.5")
    board = resilience.breakers()
    board.reset()
    argv = ["semmerge", "basebr", "brA", "brB", "--device", "cpu"]
    transitions = metrics.REGISTRY.counter("breaker_transitions_total")
    opened = transitions.value(rung="torch", to="open")
    try:
        monkeypatch.setenv("SEMMERGE_FAULT", "apply:fault")
        for _ in range(2):
            faults.reset()
            assert cli.main(argv) == 0  # degraded to the text rung
        assert board.snapshot() == {"torch": "open"}
        assert transitions.value(rung="torch", to="open") == opened + 1
        monkeypatch.delenv("SEMMERGE_FAULT")
        skips = metrics.REGISTRY.counter("merge_degradations_total")
        skipped = skips.value(**{"from": "torch", "to": "text", "fault": "WorkerFault"})
        assert cli.main(argv) == 0  # skipped: no attempt while open
        assert skips.value(**{"from": "torch", "to": "text", "fault": "WorkerFault"}) \
            == skipped + 1
        capsys.readouterr()
        assert cli.main([*argv, "--no-degrade"]) == 12  # strict: the breaker's exit
        assert "circuit breaker open for rung 'torch'" in capsys.readouterr().err
        time.sleep(0.6)
        assert cli.main(argv) == 0  # the half-open probe succeeds
        assert board.snapshot() == {"torch": "closed"}
        assert transitions.value(rung="torch", to="half-open") >= 1
    finally:
        board.reset()
        faults.reset()


def test_device_faults_never_feed_the_breaker(world, tmp_path, monkeypatch):
    root = tmp_path / "k"
    shutil.copytree(world["roots"]["rename", "lock"].parent / "origin-rename", root)
    monkeypatch.chdir(root)
    monkeypatch.setenv("SEMMERGE_BREAKER", "on")
    monkeypatch.setenv("SEMMERGE_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("SEMMERGE_FAULT", "kernel:fault")
    board = resilience.breakers()
    board.reset()
    try:
        for _ in range(2):
            faults.reset()
            assert cli.main(["semmerge", "basebr", "brA", "brB", "--device", "cpu"]) == 11
        assert board.snapshot().get("torch", "closed") == "closed"
    finally:
        board.reset()
        faults.reset()


# --- refusals and the device contract --------------------------------------------------------

REFUSED = {
    "mesh_require": (["semdiff", "basebr", "brA"], {"SEMMERGE_MESH": "require"}),
}
#: Forms refused until the port had the live tools and the fleet: each
#: now gives the JAX CLI's answer for the same argv and environment
#: (``off``: the JAX client would spawn a daemon of its own under
#: ``require``). The ``serve`` fleet flags ask for ``--status``, which
#: reads nothing and starts nothing (without it both CLIs would serve);
#: ``fleet_require`` runs both packages' entry points, where the client
#: reads the posture before the CLI.
PORTED = {
    "otlp": (["semdiff", "basebr", "brA"], {"SEMMERGE_OTLP": "http://127.0.0.1:4318",
                                            "SEMMERGE_DAEMON": "off"}),
    "top": (["top", "--once"], {}),
    "profile": (["profile", "--daemon"], {}),
    "serve_tcp": (["serve", "--status", "--socket", "tcp://127.0.0.1:1"], {}),
    "serve_join": (["serve", "--status", "--join", "x.sock"], {}),
    "serve_advertise": (["serve", "--status", "--advertise", "a"], {}),
    "serve_capacity": (["serve", "--status", "--capacity", "2"], {}),
    "serve_member_id": (["serve", "--status", "--member-id", "m"], {}),
    "serve_fleet": (["serve", "--status", "--fleet"], {}),
    "fleet_require": (["semmerge", "basebr", "brA", "brB"], {"SEMMERGE_FLEET": "require"}),
    "stats_fleet": (["stats", "--fleet"], {}),
    "stats_daemon_fleet": (["stats", "--daemon", "--fleet"], {}),
    "top_tcp": (["top", "--once", "--socket", "tcp://127.0.0.1:1"], {}),
    "profile_tcp": (["profile", "--daemon", "--socket", "tcp://127.0.0.1:1"], {}),
}
#: The exit each ported form gives with nothing to read (both CLIs).
PORTED_CODES = {"otlp": 3, "fleet_require": 19}


@pytest.fixture
def gc_state():
    """The JAX CLI's merge verbs freeze the heap and raise the collector's
    thresholds (its one-shot GC posture): undone after the test."""
    threshold = gc.get_threshold()
    yield
    gc.unfreeze()
    gc.set_threshold(*threshold)


@pytest.mark.parametrize("name", sorted(REFUSED) + sorted(PORTED))
def test_refused_settings_exit_70_before_reading(name, tmp_path, monkeypatch, capsys,
                                                 gc_state):
    """The refused settings exit 70 before anything is read. The forms
    of ``PORTED`` exit as the JAX CLI does for the same argv and
    environment, with its stdout, reading nothing: ``top``, ``profile``,
    ``serve --status`` (the fleet flags too), ``stats --fleet`` (no
    trace artifact) and ``stats --daemon --fleet`` with no daemon exit 1
    with its stderr, ``SEMMERGE_FLEET=require`` with no router 19 with
    its stderr, ``semdiff`` with ``SEMMERGE_OTLP`` outside a repository
    exits 3 (inside one, its bytes are the JAX CLI's:
    ``tests/test_torch_export.py``)."""
    argv, env = REFUSED.get(name) or PORTED[name]
    monkeypatch.chdir(tmp_path)  # nothing there to read
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("SEMMERGE_DAEMON", "require")  # refused before any delegation
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(tmp_path / "none.sock"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    capsys.readouterr()
    device = ["--device", "cpu"] if argv[0] in protocol.VERBS else []
    code = cli.main([*argv, *device])
    out, err = capsys.readouterr()
    if name in REFUSED:
        assert code == 70 and "not implemented by this port" in err
    else:
        # The JAX package's entry point: its client reads SEMMERGE_FLEET
        # before its CLI (the port's main delegates the same way).
        from semantic_merge_tpu import __main__ as jax_main
        jax_code = jax_main._main(argv)
        jax_out, jax_err = capsys.readouterr()
        assert (code, out) == (jax_code, jax_out) and code == PORTED_CODES.get(name, 1)
        if name == "otlp":
            assert err.splitlines()[-1] == jax_err.splitlines()[-1]
        else:
            assert err == jax_err and err.startswith(
                "semmerge" if name.startswith(("serve", "fleet")) else "error: ")
    assert list(tmp_path.iterdir()) == []


def test_serve_without_a_card_exits_11_before_binding(tmp_path, monkeypatch, capsys):
    sock = tmp_path / "nocard.sock"
    assert cli.main(["serve", "--socket", str(sock)]) == 11
    assert "no CUDA device" in capsys.readouterr().err
    assert not sock.exists()
    assert cli.main(["serve", "--supervise", "--socket", str(sock)]) == 11
    assert not sock.exists()


def test_supervisor_spawns_the_ports_daemon():
    from semantic_merge_tpu_torch.service.supervisor import serve_argv
    args = cli.build_parser().parse_args(["serve", "--socket", "s", "--workers", "2",
                                          "--supervise", "--device", "cpu"])
    assert serve_argv(args)[1:] == ["-m", "semantic_merge_tpu_torch", "serve", "--socket",
                                    "s", "--workers", "2", "--device", "cpu"]


def test_default_socket_is_not_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.delenv("SEMMERGE_SERVICE_SOCKET", raising=False)
    monkeypatch.delenv("XDG_RUNTIME_DIR", raising=False)
    assert protocol.socket_path() == os.path.join(tempfile.gettempdir(),
                                                  f"semmerge-torch-{os.getuid()}.sock")
    from semantic_merge_tpu.service import protocol as jax_protocol
    assert protocol.socket_path() != jax_protocol.socket_path()
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    assert protocol.socket_path() == str(tmp_path / "semmerge-torch.sock")
