"""The port's out-of-process worker seam against the JAX package's.

Every case of ``tests/test_worker_seam.py`` on the port's client
(``backends/subproc.py::SubprocessBackend``) and worker (``python -m
semantic_merge_tpu_torch.runtime.worker --device cpu``): full-merge
parity through the worker (against the port's in-process engine and the
JAX host backend), a killed worker respawned transparently, a worker
dying mid-call raising ``WorkerError``, a failed request leaving the
worker alive, an external program serving the protocol, the deadline's
process-group kill and the bounded resend, a worker speaking garbage,
respawn-and-resend, ``WorkerError`` in the fault taxonomy, and ``[engine]
worker_cmd``. Then:

- the ladder: ``semmerge --backend subprocess`` with the worker dying
  (``SEMMERGE_FAULT=worker-serve:exit``) degrades to the ``host`` rung
  (the port's engine, ``merge_degradations_total{from="subprocess",
  to="host"}``) and gives the JAX CLI's exit code, tree and notes; an
  ``apply`` fault walks subprocess -> host -> text in both;
- the merge service keeps one worker alive across requests and stops it
  when it drains, each served merge giving the one-shot JAX CLI's bytes;
- a worker started without ``--device cpu`` on a host without a card
  exits 11 with the device error, which the client surfaces as a
  ``WorkerError``: it never carries on on the CPU.
"""
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from semantic_merge_tpu.backends.base import get_backend as jax_get_backend
from semantic_merge_tpu.backends.base import run_merge as jax_run_merge
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.backends.base import get_backend, run_merge
from semantic_merge_tpu_torch.backends.subproc import (SubprocessBackend, WorkerError,
                                                       default_worker_cmd)
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.obs import metrics as obs_metrics
from semantic_merge_tpu_torch.utils import faults

from test_torch_service import (REPOS, TEXT_CLEAN, WAIT, _env, make_repo, notes, start_daemon,
                                status, stop, tree_bytes, wait_for_hello)
from test_torch_strict import _run_all
from test_worker_seam import BASE as JAX_BASE
from test_worker_seam import LEFT as JAX_LEFT
from test_worker_seam import RIGHT as JAX_RIGHT

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port(snap):
    return Snapshot(files=[dict(f) for f in snap.files])


BASE, LEFT, RIGHT = _port(JAX_BASE), _port(JAX_LEFT), _port(JAX_RIGHT)
WORKER = [sys.executable, "-m", "semantic_merge_tpu_torch.runtime.worker"]


def _dicts(ops):
    return [o.to_dict() for o in ops]


@pytest.fixture(scope="module")
def backend():
    b = SubprocessBackend(device="cpu")
    yield b
    b.close()


def test_full_merge_parity_through_worker(backend):
    res_w, comp_w, conf_w = run_merge(backend, BASE, LEFT, RIGHT, base_rev="r", seed="s")
    res_h, comp_h, conf_h = run_merge(get_backend("host", device="cpu"), BASE, LEFT, RIGHT,
                                      base_rev="r", seed="s")
    res_j, comp_j, conf_j = jax_run_merge(jax_get_backend("host"), JAX_BASE, JAX_LEFT,
                                          JAX_RIGHT, base_rev="r", seed="s")
    for res in (res_h, res_j):
        assert _dicts(res_w.op_log_left) == _dicts(res.op_log_left)
        assert _dicts(res_w.op_log_right) == _dicts(res.op_log_right)
    assert _dicts(comp_w) == _dicts(comp_h) == _dicts(comp_j)
    assert [c.to_dict() for c in conf_w] == [c.to_dict() for c in conf_j]
    # The worker's timing block came back as phases.
    assert {"worker.buildAndDiff", "worker.compose", "worker.scan"} <= set(backend.phases)


def test_worker_crash_recovers_transparently(backend):
    ops = backend.diff(BASE, LEFT, base_rev="r", seed="s")
    assert ops
    proc = backend._proc
    assert proc is not None
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    ops2 = backend.diff(BASE, LEFT, base_rev="r", seed="s")
    assert _dicts(ops2) == _dicts(ops)
    want = jax_get_backend("host").diff(JAX_BASE, JAX_LEFT, base_rev="r", seed="s")
    assert _dicts(ops) == _dicts(want)


def test_midcall_death_raises_cleanly(tmp_path):
    script = tmp_path / "dying_worker.py"
    script.write_text("import sys\nsys.stdin.readline()\n")
    b = SubprocessBackend(worker_cmd=[sys.executable, str(script)], device="cpu")
    try:
        with pytest.raises(WorkerError):
            b.diff(BASE, LEFT, base_rev="r", seed="s")
    finally:
        b.close()


def test_request_error_does_not_kill_worker():
    proc = subprocess.Popen([*WORKER, "--device", "cpu"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, bufsize=1,
                            env=_env(PYTHONPATH=str(REPO_ROOT)))
    try:
        proc.stdin.write(json.dumps({"id": 1, "method": "nope"}) + "\n")
        proc.stdin.flush()
        reply = json.loads(proc.stdout.readline())
        assert reply["id"] == 1 and "error" in reply
        proc.stdin.write(json.dumps({"id": 2, "method": "ping"}) + "\n")
        proc.stdin.flush()
        reply2 = json.loads(proc.stdout.readline())
        assert reply2["result"]["pong"] is True
        assert reply2["result"]["backend"] == "torch"
    finally:
        proc.kill()
        proc.wait()


def test_external_program_can_implement_the_protocol(tmp_path):
    script = tmp_path / "toy_worker.py"
    script.write_text(textwrap.dedent("""
        import json, sys
        OP = {"id": "x"*8, "schemaVersion": 1, "type": "addDecl",
              "target": {"symbolId": "toy", "addressId": "toy::a::0"},
              "params": {"file": "toy.ts"}, "guards": {},
              "effects": {"summary": "add decl"}, "provenance": {}}
        for line in sys.stdin:
            req = json.loads(line)
            if req["method"] == "shutdown":
                print(json.dumps({"id": req["id"], "result": {}})); break
            print(json.dumps({"id": req["id"], "result": {
                "opLogLeft": [OP], "opLogRight": [], "symbolMaps": {}}}))
            sys.stdout.flush()
    """))
    b = SubprocessBackend(worker_cmd=[sys.executable, str(script)], device="cpu")
    try:
        result = b.build_and_diff(BASE, LEFT, RIGHT)
        assert len(result.op_log_left) == 1
        assert result.op_log_left[0].target.symbolId == "toy"
    finally:
        b.close()


def counter_total(name, **labels):
    metric = obs_metrics.REGISTRY.to_dict().get("counters", {}).get(name, {})
    return sum(s["value"] for s in metric.get("series", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def test_wedged_worker_hits_deadline_not_a_hang(monkeypatch):
    from semantic_merge_tpu_torch.errors import WorkerFault
    monkeypatch.setenv("SEMMERGE_FAULT", "worker-serve:hang=60")
    faults.reset()
    kills0 = counter_total("subprocess_deadline_kills_total")
    retries0 = counter_total("subprocess_retries_total")
    b = SubprocessBackend(device="cpu", deadline=1.0, max_retries=1)
    t0 = time.monotonic()
    try:
        with pytest.raises(WorkerError) as exc_info:
            b.diff(BASE, LEFT, base_rev="r", seed="s")
    finally:
        b.close()
    elapsed = time.monotonic() - t0
    assert elapsed < 40, f"wedged worker must be bounded, took {elapsed:.1f}s"
    assert isinstance(exc_info.value, WorkerFault)
    assert exc_info.value.cause == "deadline"
    assert counter_total("subprocess_deadline_kills_total") >= kills0 + 2
    assert counter_total("subprocess_retries_total") == retries0 + 1


def test_garbage_speaking_worker_faults_cleanly(monkeypatch):
    from semantic_merge_tpu_torch.errors import WorkerFault
    monkeypatch.setenv("SEMMERGE_FAULT", "worker-serve:garbage")
    faults.reset()
    b = SubprocessBackend(device="cpu", max_retries=1)
    try:
        with pytest.raises(WorkerError) as exc_info:
            b.diff(BASE, LEFT, base_rev="r", seed="s")
    finally:
        b.close()
    assert isinstance(exc_info.value, WorkerFault)
    assert exc_info.value.cause == "protocol"


def test_respawn_and_resend_recovers_transparently(tmp_path):
    flag = tmp_path / "died-once"
    wrapper = tmp_path / "flaky_worker.py"
    wrapper.write_text(textwrap.dedent(f"""
        import os, runpy, sys
        flag = {str(flag)!r}
        if not os.path.exists(flag):
            open(flag, "w").close()
            sys.stdin.readline()  # swallow the request, die unanswered
            sys.exit(9)
        sys.argv = ["worker", "--backend", "host", "--device", "cpu"]
        runpy.run_module("semantic_merge_tpu_torch.runtime.worker", run_name="__main__")
    """))
    retries0 = counter_total("subprocess_retries_total")
    respawns0 = counter_total("subprocess_respawns_total", reason="worker-exit")
    b = SubprocessBackend(worker_cmd=[sys.executable, str(wrapper)], device="cpu",
                          max_retries=1)
    try:
        ops = b.diff(BASE, LEFT, base_rev="r", seed="s")
    finally:
        b.close()
    expected = jax_get_backend("host").diff(JAX_BASE, JAX_LEFT, base_rev="r", seed="s")
    assert _dicts(ops) == _dicts(expected)
    assert flag.exists(), "the first worker must really have died"
    assert counter_total("subprocess_retries_total") == retries0 + 1
    assert counter_total("subprocess_respawns_total", reason="worker-exit") == respawns0 + 1


def test_worker_error_is_a_merge_fault():
    from semantic_merge_tpu_torch.errors import MergeFault, WorkerFault
    assert issubclass(WorkerError, WorkerFault)
    assert issubclass(WorkerError, MergeFault)
    assert WorkerError("x").exit_code == 12


def test_config_selects_worker_cmd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".semmerge.toml").write_text(
        '[engine]\nbackend = "subprocess"\n'
        f'worker_cmd = ["{sys.executable}", "-m", '
        '"semantic_merge_tpu_torch.runtime.worker", "--backend", "host", "--device", "cpu"]\n')
    from semantic_merge_tpu_torch.config import load_config
    config = load_config()
    assert config.engine.worker_cmd[-2:] == ["--device", "cpu"]
    b = get_backend("subprocess", device="cpu")
    b.configure(config)
    try:
        assert b._cmd == config.engine.worker_cmd
        ops = b.diff(BASE, LEFT, base_rev="r", seed="s")
        assert ops
    finally:
        b.close()


def test_default_worker_is_the_ports_own_on_the_callers_device():
    assert default_worker_cmd("cpu") == [*WORKER, "--backend", "host", "--device", "cpu"]
    assert default_worker_cmd("cuda") == [*WORKER, "--backend", "host"]
    b = SubprocessBackend(device="cpu")
    assert b._cmd == default_worker_cmd("cpu") and b.extensions == frozenset(
        {".ts", ".tsx", ".js", ".jsx"})


def test_build_and_diff_refuses_a_matcher_as_jax_does(backend):
    with pytest.raises(WorkerError):
        backend.build_and_diff(BASE, LEFT, RIGHT, signature_matcher=object())
    # diff takes one (and the worker runs without it), as in the JAX package.
    assert _dicts(backend.diff(BASE, LEFT, signature_matcher=object())) == \
        _dicts(backend.diff(BASE, LEFT))


def test_worker_without_a_card_exits_with_the_device_error():
    if torch.cuda.is_available():
        pytest.skip("checks the worker without a CUDA device")
    proc = subprocess.run(WORKER, input="", capture_output=True, text=True, timeout=WAIT,
                          env=_env(PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode == 11 and "no CUDA device" in proc.stderr
    b = SubprocessBackend(worker_cmd=list(WORKER), device="cpu", max_retries=0)
    try:
        with pytest.raises(WorkerError) as exc_info:
            b.diff(BASE, LEFT)
        assert "rc=11" in str(exc_info.value)
    finally:
        b.close()


# --- the ladder's host rung ---------------------------------------------------

LADDER = {"worker_exit": "worker-serve:exit", "apply_fault": "apply:fault"}
#: The degradations each case logs, in order, in both packages.
LADDER_STEPS = {"worker_exit": ["subprocess -> host"],
                "apply_fault": ["subprocess -> host", "host -> text"]}


@pytest.fixture(scope="module")
def ladder_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("worker_ladder")
    # A renames a function, B edits another file: the text rung is clean.
    origin = make_repo(work / "origin", *TEXT_CLEAN)
    jobs = {}
    for case, spec in LADDER.items():
        for side, module, flags in (("jax", "semantic_merge_tpu", []),
                                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            root = work / f"{case}-{side}"
            shutil.copytree(origin, root)
            jobs[case, side] = (root, [module, "semmerge", "basebr", "brA", "brB", "--inplace",
                                       "--backend", "subprocess", *flags])
    out = {}
    for case, spec in LADDER.items():
        pair = {k: v for k, v in jobs.items() if k[0] == case}
        for key, (code, stdout, stderr) in _run_all(pair, _env(SEMMERGE_FAULT=spec)).items():
            root = jobs[key][0]
            out[key] = {"code": code, "stdout": stdout, "stderr": stderr,
                        "tree": tree_bytes(root), "notes": notes(root)}
    return out


@pytest.mark.parametrize("case", sorted(LADDER))
def test_worker_ladder_degrades_to_host_as_jax_does(ladder_runs, case):
    want, got = ladder_runs[case, "jax"], ladder_runs[case, "port"]
    assert want["code"] == 0, want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    for run in (want, got):
        steps = [line.split("merge degrading ", 1)[1].split(" after")[0]
                 for line in run["stderr"].splitlines() if "merge degrading " in line]
        assert steps == LADDER_STEPS[case], run["stderr"]


def test_host_rung_records_its_jax_labels(tmp_path, monkeypatch):
    repo = make_repo(tmp_path / "repo", *REPOS["rename"])
    monkeypatch.chdir(repo)
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("SEMMERGE_FAULT", "worker-serve:exit")
    faults.reset()
    before = counter_total("merge_degradations_total", **{"from": "subprocess", "to": "host"})
    text0 = counter_total("merge_degradations_total", **{"from": "host", "to": "text"})
    code = cli.main(["semmerge", "basebr", "brA", "brB", "--inplace", "--backend",
                     "subprocess", "--device", "cpu"], delegate=False)
    assert code == 0
    assert counter_total("merge_degradations_total",
                         **{"from": "subprocess", "to": "host",
                            "fault": "WorkerError"}) == before + 1
    assert counter_total("merge_degradations_total", **{"from": "host", "to": "text"}) == text0
    assert b"function bar" in (repo / "lib/util.ts").read_bytes()  # the host rung merged it
    # Strict mode: the worker's fault exits with its code, the tree untouched.
    repo2 = make_repo(tmp_path / "repo2", *REPOS["rename"])
    monkeypatch.chdir(repo2)
    snapshot = tree_bytes(repo2)
    faults.reset()
    assert cli.main(["semmerge", "basebr", "brA", "brB", "--inplace", "--backend",
                     "subprocess", "--device", "cpu", "--no-degrade"], delegate=False) == 12
    assert tree_bytes(repo2) == snapshot


# --- the merge service's kept-alive worker --------------------------------------

def _workers_of(pid):
    """Pids of the port's worker processes whose parent is ``pid``."""
    found = []
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            argv = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        if ppid == pid and b"semantic_merge_tpu_torch.runtime.worker" in argv:
            found.append(int(entry.name))
    return sorted(found)


@pytest.fixture(scope="module")
def kept_alive(tmp_path_factory):
    work = tmp_path_factory.mktemp("worker_keepalive")
    origin = make_repo(work / "origin", *REPOS["rename"])
    sock = work / "port.sock"
    proc = start_daemon(sock)
    runs, workers = [], []
    try:
        wait_for_hello(sock, proc)
        for i in range(2):
            roots = {side: work / f"{side}{i}" for side in ("jax", "port")}
            for root in roots.values():
                shutil.copytree(origin, root)
            argv = ["semmerge", "basebr", "brA", "brB", "--inplace", "--backend", "subprocess"]
            jax_out = subprocess.run([sys.executable, "-m", "semantic_merge_tpu", *argv],
                                     cwd=roots["jax"], env=_env(), capture_output=True,
                                     text=True, timeout=WAIT)
            port_out = subprocess.run(
                [sys.executable, "-m", "semantic_merge_tpu_torch", *argv, "--device", "cpu"],
                cwd=roots["port"], capture_output=True, text=True, timeout=WAIT,
                env=_env(SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(sock)))
            runs.append({side: {"code": out.returncode, "stderr": out.stderr,
                                "tree": tree_bytes(roots[side]), "notes": notes(roots[side])}
                         for side, out in (("jax", jax_out), ("port", port_out))})
            workers.append(_workers_of(proc.pid))
        served = status(sock)["served_total"]
    finally:
        code = stop(proc)
    time.sleep(0.5)
    return runs, workers, served, code, _workers_of(proc.pid)


def test_daemon_keeps_one_worker_alive_and_stops_it_on_drain(kept_alive):
    runs, workers, served, code, after = kept_alive
    for run in runs:
        assert run["jax"]["code"] == 0, run["jax"]["stderr"]
        assert run["port"]["code"] == run["jax"]["code"], run["port"]["stderr"]
        assert run["port"]["tree"] == run["jax"]["tree"]
        assert run["port"]["notes"] == run["jax"]["notes"]
    assert served == 2
    # One worker, the same one for both requests; none after the drain.
    assert len(workers[0]) == 1 and workers[1] == workers[0], workers
    assert code == 0 and after == []
