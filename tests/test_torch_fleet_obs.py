"""The fleet half of the port's observability plane, against the JAX
package's (``tests/test_fleet_obs.py``'s fleet cases): stitched traces
across processes and the fleet's report commands.

- A daemon in fleet-member posture (``SEMMERGE_FLEET_MEMBER``) returns
  its request's span tree in the response ``meta`` (worker-process spans
  included under ``--backend subprocess``); grafting the rows keeps each
  span's seconds. A plain daemon ships none.
- One merge through a live 2-member port fleet leaves one stitched
  artifact spanning the router, the member daemon and its worker, which
  ``validate_fleet_trace`` accepts; a member SIGKILLed mid-request
  leaves ONE tree with the failed attempt and the failover retry; a
  hedged request's loser is annotated ``outcome=lost``.
- ``trace analyze --fleet`` (a file and a directory, text and
  ``--json``) and ``stats --daemon --fleet`` (text, ``--json`` and
  ``--prometheus``, on one captured router answer) print the JAX CLI's
  bytes; the federated ``metrics`` verb labels every sample by origin.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

import pytest

from semantic_merge_tpu import cli as jax_cli
from semantic_merge_tpu.service import client as jax_client
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.fleet import hashring
from semantic_merge_tpu_torch.obs import spans as obs_spans
from semantic_merge_tpu_torch.service import client, protocol

from test_torch_fleet import (REPO_ROOT, WAIT, build_repo, control, env_for, raw_close,
                              raw_conn, send_verb, spawn_router, stop_router,
                              wait_members_up)


@pytest.fixture(scope="module")
def schema():
    spec = importlib.util.spec_from_file_location(
        "check_trace_schema", REPO_ROOT / "scripts" / "check_trace_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_daemon(sock, **env):
    with open(str(sock) + ".log", "wb") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "serve", "--socket", str(sock),
             "--idle-exit", "120", "--device", "cpu"],
            env=env_for(**env), stdout=log, stderr=subprocess.STDOUT)


def _served(sock, cwd, **kw):
    conn = raw_conn(sock)
    try:
        send_verb(conn, cwd, **kw)
        return protocol.read_message(conn[1])
    finally:
        raw_close(conn)


def test_member_ships_its_span_tree_and_a_plain_daemon_none(tmp_path, schema):
    origin = build_repo(tmp_path / "origin")
    member_sock, plain_sock = tmp_path / "member.sock", tmp_path / "plain.sock"
    daemons = [_start_daemon(member_sock, SEMMERGE_FLEET_MEMBER="m9"),
               _start_daemon(plain_sock)]
    try:
        for sock, proc in zip((member_sock, plain_sock), daemons):
            deadline = time.monotonic() + WAIT
            while client.hello(str(sock), timeout=1.0) is None:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        assert client.hello(str(member_sock))["fleet_member"] == "m9"
        assert "fleet_member" not in client.hello(str(plain_sock))
        resp = _served(member_sock, origin, idem_key="ship-1",
                       argv=["basebr", "brA", "brB", "--backend", "subprocess"])
        assert resp["result"]["exit_code"] == 0, resp
        shipped = resp["result"]["meta"]["spans"]
        assert "service.execute" in {r["name"] for r in shipped}
        assert any(r.get("layer") == "worker" for r in shipped)
        for row in shipped:
            assert not schema.validate_span(row, row["name"])
        rec = obs_spans.SpanRecorder(detailed=False)
        rec.absorb_dicts(shipped, t_base=1.0, member="m9", attempt=1)
        assert sorted((r["name"], r["seconds"]) for r in rec.span_dicts()) == \
            sorted((r["name"], r["seconds"]) for r in shipped)
        assert all(r["meta"]["member"] == "m9" for r in rec.span_dicts())
        resp = _served(plain_sock, origin, idem_key="noship-1")
        assert resp["result"]["exit_code"] == 0, resp
        assert "spans" not in resp["result"]["meta"]
    finally:
        for proc in daemons:
            proc.terminate()
            proc.wait(timeout=60)


# --- a live fleet ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A 2-member router with one worker per member, a 50 ms hedge and a
    trace directory."""
    work = tmp_path_factory.mktemp("fleetobs")
    origin = build_repo(work / "origin")
    sock, traces = work / "fleet.sock", work / "traces"
    proc = spawn_router(sock, SEMMERGE_FLEET_HEDGE_MS="50", SEMMERGE_SERVICE_WORKERS="1",
                        SEMMERGE_FLEET_TRACE_DIR=str(traces))
    try:
        yield {"work": work, "origin": origin, "sock": sock, "traces": traces}
    finally:
        stop_router(proc)


def _copy(fleet, name):
    dst = fleet["work"] / name
    shutil.copytree(fleet["origin"], dst)
    return dst


def _artifact(fleet, trace_id, timeout=30.0):
    path = fleet["traces"] / f"{trace_id}.json"
    deadline = time.monotonic() + timeout
    while not path.is_file():
        assert time.monotonic() < deadline, f"no stitched artifact at {path}"
        time.sleep(0.1)
    return path, json.loads(path.read_text())


def _owner(repo):
    return hashring.owner(hashring.repo_key(str(repo)), ["m0", "m1"])


def _both(capsys, argv):
    capsys.readouterr()
    port = cli.main(argv)
    port_out, port_err = capsys.readouterr()
    jax = jax_cli.main(argv)
    jax_out, jax_err = capsys.readouterr()
    return (port, port_out, port_err), (jax, jax_out, jax_err)


def test_stitched_trace_and_the_fleet_reports(fleet, schema, capsys, monkeypatch, tmp_path):
    repo = _copy(fleet, "stitch")
    resp = _served(fleet["sock"], repo, idem_key="stitch-1",
                   argv=["basebr", "brA", "brB", "--inplace", "--backend", "subprocess"])
    assert resp["result"]["exit_code"] == 0, resp
    trace_id = resp["result"]["meta"]["trace_id"]
    path, artifact = _artifact(fleet, trace_id)
    assert schema.validate_fleet_trace(artifact) == []
    rows = artifact["spans"]
    assert {"fleet", "service", "worker"} <= {r.get("layer") for r in rows}
    assert {"fleet.wal_fsync", "fleet.route", "fleet.relay", "service.execute"} <= \
        {r["name"] for r in rows}
    owner = _owner(repo)
    relays = [r for r in rows if r["name"] == "fleet.relay"]
    assert [r["meta"]["outcome"] for r in relays] == ["ok"]
    assert relays[0]["meta"]["member"] == owner
    assert all(r["meta"]["member"] == owner and r["meta"]["attempt"] == 1
               for r in rows if r.get("layer") != "fleet")

    # trace analyze --fleet: the JAX CLI's bytes, on the file and a directory.
    analyze_dir = tmp_path / "analyze"
    analyze_dir.mkdir()
    shutil.copy(path, analyze_dir / path.name)
    (analyze_dir / "broken.json").write_text("{not json")
    for target in (path, analyze_dir):
        for extra in ([], ["--json"]):
            port, jax = _both(capsys, ["trace", "analyze", "--fleet", str(target), *extra])
            assert port == jax and port[0] == 0
    port, _ = _both(capsys, ["trace", "analyze", "--fleet", "--json", str(path)])
    analysis = json.loads(port[1])
    assert analysis["trace_id"] == trace_id and analysis["buckets"]["member_execute"] > 0

    # The federated metrics verb: every sample labelled by origin.
    metrics = control(fleet["sock"], "metrics")
    assert metrics["federated"] is True and "fleet_member_up" in metrics["prometheus"]
    for member in ("router", "m0", "m1"):
        assert f'member="{member}"' in metrics["prometheus"], member

    # stats --daemon --fleet from a process, and serve --status --fleet.
    env = env_for(SEMMERGE_SERVICE_SOCKET=str(fleet["sock"]))
    proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", "stats",
                           "--daemon", "--fleet", "--json"], capture_output=True, text=True,
                          env=env, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr
    agg = json.loads(proc.stdout)
    assert agg["router"]["fleet"] is True and set(agg["members"]) == {"m0", "m1"}
    assert all(m["fleet_member"] == mid for mid, m in agg["members"].items())
    proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", "serve",
                           "--status", "--fleet", "--socket", str(fleet["sock"])],
                          capture_output=True, text=True, env=env, timeout=WAIT)
    assert proc.returncode == 0 and set(json.loads(proc.stdout)["members"]) == {"m0", "m1"}

    # ... and the JAX CLI's bytes on the same router answers.
    answers = {"member_status": agg, "metrics": metrics}
    for mod in (client, jax_client):
        monkeypatch.setattr(mod, "call_control",
                            lambda method, params=None, path=None, timeout=10.0:
                            answers[method])
    for extra in ([], ["--json"], ["--prometheus"]):
        port, jax = _both(capsys, ["stats", "--daemon", "--fleet", *extra])
        assert port == jax and port[0] == 0 and port[1]
    assert "members_up=2/2" in _both(capsys, ["stats", "--daemon", "--fleet"])[0][1]


def test_stitched_trace_through_a_failover(fleet, schema):
    repo = _copy(fleet, "failover")
    owner = _owner(repo)
    other = "m1" if owner == "m0" else "m0"
    pids = {m["id"]: m["pid"] for m in control(fleet["sock"], "status")["members"]}
    conn = raw_conn(fleet["sock"])
    try:
        send_verb(conn, repo, argv=["basebr", "brA", "brB", "--inplace"], idem_key="kill-1",
                  env={"SEMMERGE_FAULT": "service:execute:hang=2"})
        time.sleep(0.8)
        os.kill(pids[owner], signal.SIGKILL)
        resp = protocol.read_message(conn[1])
    finally:
        raw_close(conn)
    assert resp["result"]["exit_code"] == 0, resp
    _path, artifact = _artifact(fleet, resp["result"]["meta"]["trace_id"])
    assert schema.validate_fleet_trace(artifact) == []
    rows = artifact["spans"]
    dead = [r for r in rows if r["name"] == "fleet.relay"
            and r["meta"]["outcome"] == "transport"]
    assert dead and dead[0]["meta"]["member"] == owner and dead[0]["meta"]["attempt"] == 1
    assert any(r["name"] == "fleet.failover" and r["meta"].get("reason") == "transport"
               for r in rows)
    winners = [r for r in rows if r["name"] == "fleet.relay" and r["meta"]["outcome"] == "ok"]
    assert winners and winners[0]["meta"]["member"] == other
    assert winners[0]["meta"]["attempt"] >= 2
    grafted = [r for r in rows if r.get("layer") != "fleet"]
    assert grafted and all(r["meta"]["member"] == other and r["meta"]["attempt"] >= 2
                           for r in grafted)
    # The supervisor brings the killed member back for the next test.
    wait_members_up(fleet["sock"], 2)


def test_hedged_loser_is_annotated_in_the_stitched_trace(fleet, schema):
    repo = _copy(fleet, "hedge")
    owner = _owner(repo)
    other = "m1" if owner == "m0" else "m0"
    wedge = raw_conn(fleet["sock"])
    try:
        # The owner's one worker is wedged (--inplace never hedges).
        send_verb(wedge, repo, argv=["basebr", "brA", "brB", "--inplace"], idem_key="wedge",
                  env={"SEMMERGE_FAULT": "service:execute:hang=6"})
        time.sleep(0.8)
        resp = _served(fleet["sock"], repo, req_id=2, idem_key="hedged")
        assert resp["result"]["exit_code"] == 0, resp
        _path, artifact = _artifact(fleet, resp["result"]["meta"]["trace_id"])
        assert schema.validate_fleet_trace(artifact) == []
        rows = artifact["spans"]
        hedges = {r["meta"]["member"]: r["meta"] for r in rows if r["name"] == "fleet.hedge"}
        assert hedges[owner] == dict(hedges[owner], won=False, outcome="lost")
        assert hedges[other] == dict(hedges[other], won=True, outcome="won")
        assert any(r["name"] == "fleet.hedge_wait" for r in rows)
        winners = [r for r in rows
                   if r["name"] == "fleet.relay" and r["meta"]["outcome"] == "ok"]
        assert winners and winners[0]["meta"]["member"] == other
        grafted = [r for r in rows if r.get("layer") != "fleet"]
        assert grafted and all(r["meta"]["member"] == other for r in grafted)
        assert protocol.read_message(wedge[1])["result"]["exit_code"] == 0
    finally:
        raw_close(wedge)
