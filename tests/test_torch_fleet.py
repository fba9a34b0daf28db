"""The port's merge fleet against the JAX package's (``fleet/``).

- Rendezvous hashing gives the JAX ``hashring``'s owners, rankings and
  moved keys over 300 keys and several member sets, and the same repo
  keys.
- Each package's WAL reads the other's records (``read_records`` and the
  replay set of ``WriteAheadLog.open``), a torn tail included.
- ``SEMMERGE_FLEET`` parses as in the JAX package; ``require`` with no
  router exits 19 and an injected transport fault 21, each with the JAX
  CLI's stderr; ``fleet --status|--drain|--leave`` with no router answer
  as the JAX CLI does; a plain daemon never satisfies a fleet connect;
  ``fleet`` without a card exits 11 before it binds or spawns anything;
  the router's status has the JAX router's keys (plus ``package`` and
  ``device``); its members are the port's daemon on the fleet's device.
- Live 2-member routers of CPU members (``fleet --device cpu``): a
  routed ``semmerge --inplace`` (and ``semdiff``) give the JAX CLI's
  one-shot tree, notes, op logs and stdout; a repo's requests pin to
  its rendezvous owner, and a drained member leaves the ring while its
  peer serves; a slow member's read is hedged to the other member (the
  JAX test's fault overlay); a request journaled when the router is
  SIGKILLed is replayed once by the restarted router.

Every wait has a deadline; every router is stopped (its process group
killed if it does not drain) before its test ends.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import time

import pytest

from semantic_merge_tpu import __main__ as jax_main
from semantic_merge_tpu import cli as jax_cli
from semantic_merge_tpu.fleet import hashring as jax_hashring
from semantic_merge_tpu.fleet import mode as jax_mode
from semantic_merge_tpu.fleet import router as jax_router
from semantic_merge_tpu.fleet import wal as jax_wal
from semantic_merge_tpu.service import client as jax_client
from semantic_merge_tpu_torch import __main__ as port_main
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.fleet import FLEET_EXIT, hashring, mode
from semantic_merge_tpu_torch.fleet import router as port_router
from semantic_merge_tpu_torch.fleet import wal as fleet_wal
from semantic_merge_tpu_torch.service import client, protocol

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
WAIT = 120  # seconds: the bound on every router start and request


# --- helpers (the other fleet test files import these) ----------------------------------

def env_for(**extra):
    """A child's environment: no inherited SEMMERGE_* setting, the
    checkout on the path, JAX on the CPU, fixed git dates."""
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")
    env.update(extra)
    return env


def git(args, cwd):
    subprocess.run(["git", *args], cwd=cwd, check=True, env=env_for(),
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, timeout=WAIT)


def build_repo(root: pathlib.Path) -> pathlib.Path:
    """The JAX fleet tests' repository: basebr, brA renames foo to bar,
    brB adds a file and edits a text file."""
    root.mkdir(parents=True)
    git(["init", "-q", "-b", "main"], root)
    git(["config", "user.email", "t@example.com"], root)
    git(["config", "user.name", "t"], root)
    (root / "src").mkdir()
    (root / "src/util.ts").write_text("export function foo(n: number): number {\n"
                                      "  return n;\n}\n")
    (root / "notes.txt").write_text("hello\n")
    for args in (["add", "-A"], ["commit", "-qm", "base"], ["branch", "basebr"],
                 ["checkout", "-qb", "brA"]):
        git(args, root)
    (root / "src/util.ts").write_text("export function bar(n: number): number {\n"
                                      "  return n;\n}\n")
    for args in (["commit", "-qam", "rename"], ["checkout", "-q", "main"],
                 ["checkout", "-qb", "brB"]):
        git(args, root)
    (root / "extra.ts").write_text("export function extra(s: string): string { return s; }\n")
    (root / "notes.txt").write_text("hello\nworld\n")
    for args in (["add", "-A"], ["commit", "-qm", "extra"], ["checkout", "-q", "main"]):
        git(args, root)
    return root


def tree_bytes(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and ".git" not in p.relative_to(root).parts
            and ".semmerge-postmortem" not in p.relative_to(root).parts}


def notes(root: pathlib.Path) -> dict:
    out = {}
    for rev in ("brA", "brB"):
        proc = subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, timeout=WAIT)
        out[rev] = proc.stdout if proc.returncode == 0 else None
    return out


def control(sock, method, params=None):
    """One control round trip to the router; ``None`` when nothing
    answers."""
    try:
        return client.call_control(method, params=params, path=str(sock), timeout=30)
    except client.DaemonUnavailable:
        return None


def counter_total(status, name, **labels):
    series = ((status.get("metrics") or {}).get("counters") or {}).get(name, {}).get(
        "series", [])
    return sum(s["value"] for s in series
               if all((s.get("labels") or {}).get(k) == v for k, v in labels.items()))


def spawn_router(sock, *, members=2, timeout=WAIT, **env):
    """``fleet --members N --device cpu`` in its own session, waited
    until ``members`` are in the ring."""
    env = env_for(**{"SEMMERGE_FLEET_HEALTH_INTERVAL": "0.2",
                     "SEMMERGE_SUPERVISE_BACKOFF": "0.1",
                     "SEMMERGE_SERVICE_DRAIN_TIMEOUT": "2", **env})
    with open(str(sock) + ".log", "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "fleet", "--socket", str(sock),
             "--members", str(members), "--device", "cpu"],
            stdin=subprocess.DEVNULL, stdout=log, stderr=log, cwd="/", env=env,
            start_new_session=True)
    try:
        wait_members_up(sock, members, proc, timeout)
    except BaseException:
        stop_router(proc)
        raise
    return proc


def wait_members_up(sock, want, proc=None, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"router exited {proc.returncode}: "
                                 f"{pathlib.Path(str(sock) + '.log').read_text()[-3000:]}")
        status = control(sock, "status")
        if status and status.get("fleet") and status.get("members_up", 0) >= want:
            return status
        time.sleep(0.2)
    raise AssertionError(f"{want} members not up within {timeout}s: "
                         f"{pathlib.Path(str(sock) + '.log').read_text()[-3000:]}")


def stop_router(proc):
    """SIGTERM (a drain), then the whole process group if it hangs."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
    with contextlib.suppress(OSError):
        os.killpg(proc.pid, signal.SIGKILL)
    with contextlib.suppress(subprocess.TimeoutExpired):
        proc.wait(timeout=10)
    return proc.returncode


def raw_conn(sock, timeout=WAIT):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(str(sock))
    return s, s.makefile("r", encoding="utf-8"), s.makefile("w", encoding="utf-8")


def raw_close(conn):
    for h in reversed(conn):
        with contextlib.suppress(OSError):
            h.close()


def send_verb(conn, cwd, *, verb="semmerge", argv=None, env=None, req_id=1, idem_key=None):
    params = {"argv": (argv or ["basebr", "brA", "brB"]) + ["--device", "cpu"],
              "cwd": str(cwd), "env": env or {}}
    if idem_key:
        params["idempotency_key"] = idem_key
    protocol.write_message(conn[2], {"id": req_id, "method": verb, "params": params})


def roundtrip(sock, cwd, **kw):
    conn = raw_conn(sock)
    try:
        send_verb(conn, cwd, **kw)
        return protocol.read_message(conn[1])
    finally:
        raw_close(conn)


def run_cli(package, argv, cwd, **env):
    flags = ["--device", "cpu"] if package == "semantic_merge_tpu_torch" else ["--backend", "tpu"]
    proc = subprocess.run([sys.executable, "-m", package, *argv, *flags], cwd=cwd,
                          env=env_for(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=WAIT)
    return proc.returncode, proc.stdout, proc.stderr


# --- rendezvous hashing -----------------------------------------------------------------

KEYS = [f"/repos/project-{i}" for i in range(300)]
MEMBER_SETS = [["m0", "m1"], ["m0", "m1", "m2"], ["m0", "m1", "r1", "t0"],
               [f"m{i}" for i in range(7)]]


@pytest.mark.parametrize("members", MEMBER_SETS, ids=lambda m: f"{len(m)}members")
def test_hashring_gives_the_jax_owners(members):
    for key in KEYS:
        assert hashring.owner(key, members) == jax_hashring.owner(key, members)
        assert hashring.owner(key, members[::-1]) == hashring.owner(key, members)
        assert hashring.rank(key, members) == jax_hashring.rank(key, members)
    for gone in members:
        after = [m for m in members if m != gone]
        assert hashring.moved_keys(KEYS, members, after) == \
            jax_hashring.moved_keys(KEYS, members, after)
        assert hashring.moved_keys(KEYS, after, members) == \
            jax_hashring.moved_keys(KEYS, after, members)
    assert hashring.moved_keys(KEYS, [], members) == jax_hashring.moved_keys(KEYS, [], members)
    assert hashring.moved_keys(KEYS, [], []) == []
    with pytest.raises(ValueError):
        hashring.owner("/k", [])


def test_repo_key_is_the_jax_packages(tmp_path):
    repo = tmp_path / "repo"
    repo.mkdir()
    (tmp_path / "link").symlink_to(repo)
    for spelling in (str(repo), str(tmp_path / "link"), str(repo) + "/./", "", "/"):
        assert hashring.repo_key(spelling) == jax_hashring.repo_key(spelling)
    assert hashring.repo_key(str(tmp_path / "link")) == hashring.repo_key(str(repo))


# --- the WAL, across packages -----------------------------------------------------------

def _journal(pkg_wal, directory):
    """k1 acked, k2 open, then a torn ack for k2 at the tail."""
    w = pkg_wal.WriteAheadLog(str(directory))
    assert w.open() == []
    w.record_request("k1", "semmerge", {"argv": ["a"], "cwd": "/r"}, "t1")
    w.record_request("k2", "semdiff", {"argv": ["b"]}, None)
    w.record_dispatch("k1", "m0")
    w.ack("k1")
    w.record_request("k2", "semdiff", {"argv": ["DIFFERENT"]}, None)  # no-op: open
    w.close()
    with open(os.path.join(str(directory), pkg_wal.WAL_FILE), "a", encoding="utf-8") as fh:
        fh.write('{"kind": "ack", "key"')


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_packages_wal_reads_the_others(tmp_path, writer, reader):
    pkgs = {"port": fleet_wal, "jax": jax_wal}
    d = tmp_path / "wal"
    _journal(pkgs[writer], d)
    assert pkgs[reader].read_records(str(d)) == pkgs[writer].read_records(str(d))
    assert [r["kind"] for r in pkgs[reader].read_records(str(d))] == \
        ["request", "request", "dispatch", "ack"]
    w = pkgs[reader].WriteAheadLog(str(d))
    pending = w.open()  # the torn ack settles nothing
    assert [(r["key"], r["verb"], r["params"]) for r in pending] == \
        [("k2", "semdiff", {"argv": ["b"]})]
    w.ack("k2")
    w.close()
    # The archived segment and the compacted file: both packages read
    # the same history, and the entry is settled for either.
    assert pkgs[writer].read_records(str(d)) == pkgs[reader].read_records(str(d))
    assert sorted(os.listdir(d)) == ["wal.1.jsonl", "wal.jsonl"]
    for pkg in pkgs.values():
        w = pkg.WriteAheadLog(str(d))
        assert w.open() == []
        w.close()


def test_wal_request_is_durable_before_dispatch(tmp_path):
    w = fleet_wal.WriteAheadLog(str(tmp_path / "wal"))
    w.open()
    w.record_request("k", "semmerge", {"argv": ["x"]}, "t")
    rows = [json.loads(line) for line in (tmp_path / "wal" / fleet_wal.WAL_FILE).read_text()
            .splitlines()]
    assert rows == [{"kind": "request", "key": "k", "verb": "semmerge",
                     "params": {"argv": ["x"]}, "trace_id": "t", "t": rows[0]["t"]}]
    w.close()
    assert fleet_wal.default_dir("/s/x.sock") == jax_wal.default_dir("/s/x.sock")


# --- posture, exits without a router, device --------------------------------------------

@pytest.mark.parametrize("raw", ["", "auto", "require", "off", "1", "on", "0", "bogus",
                                 "REQUIRE", " yes "])
def test_fleet_posture_parses_as_in_jax(monkeypatch, raw):
    monkeypatch.setenv("SEMMERGE_FLEET", raw)
    assert mode() == jax_mode()
    assert client.fleet_mode() == jax_client.fleet_mode()
    assert FLEET_EXIT == 19


@pytest.mark.parametrize("fault,code", [(None, 19), ("net:connect:fault", 21),
                                        ("net:partition:raise", 21)])
def test_require_without_a_router_exits_as_the_jax_cli(tmp_path, monkeypatch, capsys,
                                                       fault, code):
    monkeypatch.chdir(tmp_path)
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.delenv("_SEMMERGE_IN_DAEMON", raising=False)
    monkeypatch.setenv("SEMMERGE_FLEET", "require")
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(tmp_path / "none.sock"))
    if fault:
        monkeypatch.setenv("SEMMERGE_FAULT", fault)
    capsys.readouterr()
    argv = ["semmerge", "basebr", "brA", "brB", "--inplace"]
    port = port_main._main([*argv, "--device", "cpu"])
    port_out, port_err = capsys.readouterr()
    jax = jax_main._main(argv)
    jax_out, jax_err = capsys.readouterr()
    assert (port, port_out, port_err) == (jax, jax_out, jax_err)
    assert port == code and port_out == ""
    assert ("fleet required but unavailable" if code == 19 else "fleet transport failed") \
        in port_err
    assert list(tmp_path.iterdir()) == []


def test_require_without_a_router_exits_19_from_a_process(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge", "a", "b", "c"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=WAIT,
        env=env_for(SEMMERGE_FLEET="require",
                    SEMMERGE_SERVICE_SOCKET=str(tmp_path / "none.sock")))
    assert proc.returncode == 19, proc.stderr
    assert "fleet required but unavailable" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("argv", [["fleet", "--status"], ["fleet", "--drain", "m1"],
                                  ["fleet", "--drain", "all"], ["fleet", "--leave", "r1"],
                                  ["serve", "--status", "--fleet"]],
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_control_forms_without_a_router_answer_as_the_jax_cli(tmp_path, monkeypatch,
                                                              capsys, argv):
    monkeypatch.chdir(tmp_path)
    sock = str(tmp_path / "none.sock")
    capsys.readouterr()
    port = cli.main([*argv, "--socket", sock])
    port_out, port_err = capsys.readouterr()
    jax = jax_cli.main([*argv, "--socket", sock])
    jax_out, jax_err = capsys.readouterr()
    assert (port, port_out, port_err) == (jax, jax_out, jax_err) and port == 1
    assert list(tmp_path.iterdir()) == []


def test_fleet_without_a_card_exits_11_before_binding(tmp_path, monkeypatch, capsys):
    sock = tmp_path / "f.sock"
    spawned = []
    monkeypatch.setattr(port_router, "MemberSupervisor",
                        lambda *a, **k: spawned.append(a))
    assert cli.main(["fleet", "--socket", str(sock), "--members", "2"]) == 11
    assert "no CUDA device" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == [] and spawned == []


def test_members_are_the_ports_daemon_on_the_fleets_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMMERGE_FLEET_STITCH", "off")  # no sealer thread here
    monkeypatch.setenv("SEMMERGE_FAULT", "scan:raise")
    router = port_router.FleetRouter(socket_path=str(tmp_path / "f.sock"), members=2,
                                     workers=2, device="cpu")
    argv = router.member_argv("/s.m0")
    assert argv[1:] == ["-m", "semantic_merge_tpu_torch", "serve", "--socket", "/s.m0",
                        "--idle-exit", "0", "--workers", "2", "--device", "cpu"]
    assert argv[0] == sys.executable
    env = router._member_env("m0")
    jax_env = jax_router.FleetRouter(socket_path=str(tmp_path / "j.sock"),
                                     members=2)._member_env("m0")
    assert env == dict(jax_env, SEMMERGE_GC_TUNE="0")
    assert "SEMMERGE_FAULT" not in env and env["SEMMERGE_FLEET"] == "off"
    assert port_router.FleetRouter(socket_path="s").member_argv("p")[-2:] == \
        ["--device", "cuda"]


def test_a_member_without_a_card_stays_out_of_the_ring(tmp_path):
    """A router whose member runs on ``cuda`` on a machine without a
    card: the member exits 11 and is respawned, never replaced by a CPU
    member, and a routed request gets the typed FleetFault (no member),
    never a merge in another process."""
    sock = tmp_path / "f.sock"
    code = ("import sys\nfrom semantic_merge_tpu_torch.fleet.router import FleetRouter\n"
            f"sys.exit(FleetRouter(socket_path={str(sock)!r}, members=1, "
            "device='cuda').serve_forever())\n")
    with open(str(sock) + ".log", "ab") as log:
        router = subprocess.Popen(
            [sys.executable, "-c", code], stdout=log, stderr=log, cwd="/",
            env=env_for(SEMMERGE_FLEET_READY_TIMEOUT="1", SEMMERGE_SUPERVISE_BACKOFF="0.1",
                        SEMMERGE_FLEET_HEALTH_INTERVAL="0.2"),
            start_new_session=True)
    try:
        deadline = time.monotonic() + WAIT
        while True:
            status = control(sock, "status")
            view = (status or {}).get("members", [{}])[0]
            if view.get("last_rc") == 11:
                break
            assert router.poll() is None and time.monotonic() < deadline, status
            time.sleep(0.2)
        assert status["members_up"] == 0 and not view["in_ring"]
        assert view["state"] in ("dead", "starting")
        repo = build_repo(tmp_path / "repo")
        resp = roundtrip(sock, repo, argv=["basebr", "brA", "brB", "--inplace"])
        assert resp["error"]["exit_code"] == 19 and resp["error"]["fault"] == "FleetFault"
        assert "no fleet member available" in resp["error"]["message"]
        assert notes(repo) == {"brA": None, "brB": None}
    finally:
        stop_router(router)


def test_router_status_has_the_jax_routers_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMMERGE_FLEET_STITCH", "off")
    port = port_router.FleetRouter(socket_path=str(tmp_path / "p.sock"), members=0,
                                   device="cpu").status()
    jax = jax_router.FleetRouter(socket_path=str(tmp_path / "j.sock"), members=0).status()
    assert set(port) == set(jax) | {"package", "device"}
    for block in ("transport", "wal", "hedge", "sampling", "window"):
        assert set(port[block]) == set(jax[block]), block
    assert port["package"] == protocol.PACKAGE and port["device"] == "cpu"


def test_plain_daemon_does_not_satisfy_a_fleet_connect(tmp_path):
    sock = tmp_path / "plain.sock"
    with open(str(sock) + ".log", "wb") as log:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "serve", "--socket", str(sock),
             "--idle-exit", "60", "--device", "cpu"],
            env=env_for(), stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + WAIT
        while client.hello(str(sock), timeout=1.0) is None:
            assert daemon.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        conn = client._try_connect(str(sock))
        assert conn is not None
        client._close(*conn)
        assert client._try_connect(str(sock), require_fleet=True) is None
    finally:
        daemon.terminate()
        daemon.wait(timeout=60)


# --- a live router ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A 2-member router (hedging off) and the repositories: an origin
    and copies for the JAX CLI and the routed runs."""
    work = tmp_path_factory.mktemp("fleet")
    origin = build_repo(work / "origin")
    sock = work / "fleet.sock"
    proc = spawn_router(sock, SEMMERGE_FLEET_HEDGE="off")
    try:
        yield {"work": work, "origin": origin, "sock": sock, "proc": proc}
    finally:
        stop_router(proc)


def _copy(fleet, name):
    dst = fleet["work"] / name
    shutil.copytree(fleet["origin"], dst)
    return dst


def test_routed_merge_gives_the_jax_clis_one_shot_bytes(fleet):
    routed, jax_root = _copy(fleet, "routed"), _copy(fleet, "jax")
    hello = control(fleet["sock"], "hello")
    assert hello["fleet"] is True and hello["members_up"] == 2
    assert hello["package"] == protocol.PACKAGE
    for argv in (["semdiff", "basebr", "brA", "--json-out"],
                 ["semmerge", "basebr", "brA", "brB", "--inplace"]):
        port = run_cli("semantic_merge_tpu_torch", argv, routed, SEMMERGE_FLEET="require",
                       SEMMERGE_SERVICE_SOCKET=str(fleet["sock"]))
        jax = run_cli("semantic_merge_tpu", argv, jax_root)
        assert port[:2] == jax[:2] and port[0] == 0, (argv, port[2], jax[2])
    assert tree_bytes(routed) == tree_bytes(jax_root)
    assert notes(routed) == notes(jax_root) and notes(routed)["brA"]
    status = control(fleet["sock"], "status")
    assert status["served_total"] >= 2 and status["wal"]["open"] == 0
    proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", "fleet",
                           "--socket", str(fleet["sock"]), "--status"],
                          capture_output=True, text=True, env=env_for(), timeout=WAIT)
    assert proc.returncode == 0 and json.loads(proc.stdout)["fleet"] is True


def test_router_affinity_and_drain(fleet):
    """The last test on the module's router: it drains a member."""
    repo = _copy(fleet, "affinity")
    owner = hashring.owner(hashring.repo_key(str(repo)), ["m0", "m1"])
    other = "m1" if owner == "m0" else "m0"
    before = {m["id"]: m["dispatches"] for m in control(fleet["sock"], "status")["members"]}
    for i in range(3):
        resp = roundtrip(fleet["sock"], repo, req_id=i, idem_key=f"aff-{i}")
        assert resp["result"]["exit_code"] == 0, resp
    status = control(fleet["sock"], "status")
    after = {m["id"]: m["dispatches"] for m in status["members"]}
    assert after[owner] - before[owner] == 3 and after[other] == before[other]
    ack = control(fleet["sock"], "drain", {"member": owner})
    assert ack["ok"] and ack["member_ack"]["draining"] is True
    status = control(fleet["sock"], "status")
    assert status["members_up"] == 1
    assert counter_total(status, "fleet_failovers_total", reason="drain") >= 1
    resp = roundtrip(fleet["sock"], repo, req_id=9, idem_key="aff-post")
    assert resp["result"]["exit_code"] == 0, resp
    status = control(fleet["sock"], "status")
    assert {m["id"]: m["dispatches"] for m in status["members"]}[other] == after[other] + 1


def test_router_hedges_a_slow_member_and_replays_its_wal(tmp_path):
    """Hedged reads (the JAX test's fault overlay): the owner's one
    worker is wedged by an ``--inplace`` merge, so a read for the same
    repo is hedged to the other member, which answers. Then the WAL:
    with both members drained, a request is journaled; the router is
    SIGKILLed and restarted, and the replay runs it once."""
    origin = build_repo(tmp_path / "origin")
    repo, replay_root, jax_root = (tmp_path / "repo", tmp_path / "replay", tmp_path / "jax")
    for root in (repo, replay_root, jax_root):
        shutil.copytree(origin, root)
    sock = tmp_path / "fleet.sock"
    router = spawn_router(sock, SEMMERGE_FLEET_HEDGE_MS="50", SEMMERGE_SERVICE_WORKERS="1")
    wedge = None
    try:
        owner = hashring.owner(hashring.repo_key(str(repo)), ["m0", "m1"])
        other = "m1" if owner == "m0" else "m0"
        wedge = raw_conn(sock)
        send_verb(wedge, repo, env={"SEMMERGE_FAULT": "service:execute:hang=6"},
                  argv=["basebr", "brA", "brB", "--inplace"], idem_key="wedge")
        time.sleep(1.0)
        resp = roundtrip(sock, repo, req_id=2, idem_key="hedged")
        assert resp["result"]["exit_code"] == 0, resp
        status = control(sock, "status")
        assert counter_total(status, "fleet_hedges_total") >= 1
        assert counter_total(status, "fleet_hedge_wins_total") >= 1
        assert {m["id"]: m["dispatches"] for m in status["members"]}[other] >= 1
        assert protocol.read_message(wedge[1])["result"]["exit_code"] == 0
        raw_close(wedge)
        wedge = None

        # The WAL: an empty ring, a journaled request, a SIGKILL.
        for mid in ("m0", "m1"):
            assert control(sock, "drain", {"member": mid})["ok"]
        assert control(sock, "status")["members_up"] == 0
        before = tree_bytes(replay_root)
        conn = raw_conn(sock)
        send_verb(conn, replay_root, argv=["basebr", "brA", "brB", "--inplace"],
                  idem_key="wal-1")
        wal_dir = fleet_wal.default_dir(str(sock))
        deadline = time.monotonic() + WAIT
        while not any(r.get("key") == "wal-1" for r in fleet_wal.read_records(wal_dir)):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert control(sock, "status")["wal"]["open"] == 1
        router.send_signal(signal.SIGKILL)
        router.wait(timeout=30)
        assert protocol.read_message(conn[1]) is None  # the client saw the router die
        raw_close(conn)
        assert tree_bytes(replay_root) == before
        router = spawn_router(sock, SEMMERGE_FLEET_HEDGE_MS="50", SEMMERGE_SERVICE_WORKERS="1")
        deadline = time.monotonic() + WAIT
        while (control(sock, "status") or {}).get("wal", {}).get("replayed") != 1:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        status = control(sock, "status")
        assert status["wal"]["open"] == 0
        assert counter_total(status, "fleet_wal_replayed_total") == 1
        kinds = [r["kind"] for r in fleet_wal.read_records(wal_dir) if r["key"] == "wal-1"]
        assert kinds == ["request", "request", "dispatch", "ack"]
        served = {mid: b.get("served_total")
                  for mid, b in control(sock, "member_status")["members"].items()}
        assert sum(served.values()) == 1, served
        assert run_cli("semantic_merge_tpu", ["semmerge", "basebr", "brA", "brB", "--inplace"],
                       jax_root)[0] == 0
        assert tree_bytes(replay_root) == tree_bytes(jax_root)
        assert notes(replay_root) == notes(jax_root)
    finally:
        if wedge is not None:
            raw_close(wedge)
        stop_router(router)
