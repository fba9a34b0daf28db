"""Chaos/soak harness for the port's supervised merge service and fleet.

The port of the JAX package's ``scripts/chaos_soak.py``: the same
traffic, schedules and invariants, against ``python -m
semantic_merge_tpu_torch serve --supervise --device D`` and ``python -m
semantic_merge_tpu_torch fleet --device D`` (``D`` is ``cuda`` on the
card, ``cpu`` in the tests).

Drives a supervised daemon with concurrent mixed traffic — clean
``--inplace`` merges, fault-injected merges that must degrade to the
byte-exact textual rung, strict-mode requests that must surface
documented typed exits, and resolver-enabled merges of genuinely
conflicting repos that must land on the search resolver's verified
suggestion — while SIGKILLing the daemon at randomized points mid-soak.
The supervisor must bring it back on the same socket; harness workers
ride through the outage with bounded idempotent retries (one
idempotency key pinned across a request's attempts), exactly like the
real client.

Invariants checked:

- **No corrupted or duplicated commits**: after the soak (plus one
  clean settling merge per repo), every repo's work tree is byte-exact
  against the known merge result, with no journal/stage/lock debris.
- **Byte-identical responses or documented typed exits**: every
  response is a result with exit 0 (clean / degraded) or the request
  shape's documented typed exit; nothing else.
- **Self-healing observable**: daemon pid changes across kills;
  restarts appear in the supervisor's metrics dump.
- **Bounded memory**: final daemon RSS stays under the hard watermark.

The port's ladder has no CPU rung: its TypeScript engine (``--backend
host`` runs it, on the request's device) sits on the rung ``torch``
right above the text rung. So the breaker the fault traffic trips is
the ``torch`` rung's where the JAX soak trips its ``host`` rung's; the
report lists the rungs with a breaker (``breaker_rungs``).

Run on the CPU, or on the card without ``--device``::

    python -m semantic_merge_tpu_torch.scripts.chaos_soak --device cpu \
        --requests 200 --repos 8 --concurrency 8 --kills 2 --seed 1 --json

Exit 0 when every invariant holds, 1 otherwise. The tier-1 smoke
(``tests/test_torch_chaos.py``) imports :func:`run_soak` directly.

``--fleet`` switches to the kill-drill: a fleet router fronting N
member daemons takes the same byte-exact traffic while random members
— and, separately, the router itself — are SIGKILLed mid-stream. The
replacement router reclaims the orphaned members and replays its
dispatch WAL; :func:`audit_wal` then walks the full retained journal
history to prove every effect was accounted for exactly once (no
duplicate ``--inplace`` effect from a replay or a failover
re-dispatch). The cross-host legs ride on it:

- ``--tcp-members N`` adds N *standalone* daemons that join the router
  over real TCP (``serve --join``); a router SIGKILL also proves remote
  members re-announce themselves to the replacement.
- ``--partitions K`` SIGSTOPs a TCP member K times: the connection
  stays up but reads never complete (true half-open), so only the
  application-level heartbeat can eject it — counted as a
  ``reason="partition"`` failover. SIGCONT heals the member and it
  rejoins.
- ``--churn`` performs one elastic join and one drain mid-load.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import random
import signal
import socket as socketlib
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..fleet import wal as fleet_wal
from ..service import protocol

#: The checkout holding the package: the spawned daemons import it from
#: here.
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
PACKAGE = "semantic_merge_tpu_torch"

#: The merged tree every soak repo must converge on (A renames foo->bar
#: in util.ts, B adds extra.ts and appends to notes.txt — disjoint
#: edits, so semantic and textual rungs agree byte-for-byte).
EXPECTED_TREE = {
    "src/util.ts": "export function bar(n: number): number {\n"
                   "  return n;\n}\n",
    "notes.txt": "hello\nworld\n",
    "extra.ts": "export function extra(s: string): string { return s; }\n",
}

#: Engine artifacts excluded from tree comparison. Postmortem bundles
#: are expected debris of fault-injected traffic: every degradation and
#: fault escape dumps one (see "Flight recorder", runbook).
ARTIFACTS = {".semmerge-conflicts.json", ".semmerge-trace.json",
             ".semmerge-events.jsonl", ".semmerge-journal.json",
             ".semmerge-postmortem"}

#: The tree the *conflict* repos must converge on once the resolver
#: tier picks the evidence-backed rename (A renamed foo->bar and
#: rewrote the call site; B renamed the declaration only, so keepA
#: wins 2:1 on whole-word reference counts).
RESOLVED_TREE = {
    "src/util.ts": "export function bar(n: number): number {\n"
                   "  return n;\n}\n"
                   "export function use(s: string): number {\n"
                   "  return bar(s.length);\n}\n",
}

#: Request shapes: (name, request env overlay, documented exit codes).
#: Fault-injected non-strict merges must land on the textual rung
#: (exit 0); strict ones surface the scan's ParseFault (10) — or, once
#: the chaos traffic has tripped the host-rung circuit breaker, the
#: breaker-open WorkerFault (12). The ``resolve`` shape runs against
#: the conflict-repo pool with the resolution tier enabled and must
#: merge clean (exit 0) on the resolver's verified suggestion — or,
#: while the host-rung breaker is open, degrade to the textual rung
#: where the rename genuinely conflicts (documented exit 1,
#: conflict-as-result). Anything else fails the soak.
RESOLVE_ENV = {"SEMMERGE_RESOLVE": "auto"}
SHAPES = [
    ("clean", {}, {0}),
    ("degrade-scan", {"SEMMERGE_FAULT": "scan:raise"}, {0}),
    ("degrade-apply", {"SEMMERGE_FAULT": "apply:fault"}, {0}),
    ("strict-scan", {"SEMMERGE_FAULT": "scan:fault",
                     "SEMMERGE_STRICT": "1"}, {10, 12}),
    ("resolve", dict(RESOLVE_ENV), {0, 1}),
]


def _git(args, cwd):
    subprocess.run(["git", *args], cwd=cwd, check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def build_repo(root: pathlib.Path) -> pathlib.Path:
    root.mkdir(parents=True)
    _git(["init", "-q", "-b", "main"], root)
    _git(["config", "user.email", "t@example.com"], root)
    _git(["config", "user.name", "t"], root)
    env = dict(os.environ,
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")

    def commit(msg):
        subprocess.run(["git", "add", "-A"], cwd=root, check=True,
                       stdout=subprocess.DEVNULL)
        subprocess.run(["git", "commit", "-q", "-m", msg], cwd=root,
                       check=True, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)

    (root / "src").mkdir()
    (root / "src/util.ts").write_text(
        "export function foo(n: number): number {\n  return n;\n}\n")
    (root / "notes.txt").write_text("hello\n")
    commit("base")
    _git(["branch", "basebr"], root)
    _git(["checkout", "-qb", "brA"], root)
    (root / "src/util.ts").write_text(EXPECTED_TREE["src/util.ts"])
    commit("rename foo->bar")
    _git(["checkout", "-q", "main"], root)
    _git(["checkout", "-qb", "brB"], root)
    (root / "extra.ts").write_text(EXPECTED_TREE["extra.ts"])
    (root / "notes.txt").write_text(EXPECTED_TREE["notes.txt"])
    commit("add extra + edit notes")
    _git(["checkout", "-q", "main"], root)
    return root


def build_conflict_repo(root: pathlib.Path) -> pathlib.Path:
    """A repo whose merge genuinely conflicts (DivergentRename) but
    carries asymmetric reference evidence, so the search resolver
    settles it deterministically onto :data:`RESOLVED_TREE`."""
    root.mkdir(parents=True)
    _git(["init", "-q", "-b", "main"], root)
    _git(["config", "user.email", "t@example.com"], root)
    _git(["config", "user.name", "t"], root)
    env = dict(os.environ,
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")

    def commit(msg):
        subprocess.run(["git", "add", "-A"], cwd=root, check=True,
                       stdout=subprocess.DEVNULL)
        subprocess.run(["git", "commit", "-q", "-m", msg], cwd=root,
                       check=True, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)

    (root / "src").mkdir()
    (root / "src/util.ts").write_text(
        "export function foo(n: number): number {\n"
        "  return n;\n}\n"
        "export function use(s: string): number {\n"
        "  return foo(s.length);\n}\n")
    commit("base")
    _git(["branch", "basebr"], root)
    _git(["checkout", "-qb", "brA"], root)
    (root / "src/util.ts").write_text(RESOLVED_TREE["src/util.ts"])
    commit("rename foo->bar, rewrite call site")
    _git(["checkout", "-q", "main"], root)
    _git(["checkout", "-qb", "brB"], root)
    (root / "src/util.ts").write_text(
        "export function baz(n: number): number {\n"
        "  return n;\n}\n"
        "export function use(s: string): number {\n"
        "  return foo(s.length);\n}\n")
    commit("rename foo->baz declaration only")
    _git(["checkout", "-q", "main"], root)
    return root


def tree_errors(root: pathlib.Path,
                expected: Optional[Dict[str, str]] = None) -> List[str]:
    """Byte-exactness + debris check for one settled repo."""
    errors = []
    if expected is None:
        expected = EXPECTED_TREE
    for rel, want in expected.items():
        p = root / rel
        if not p.is_file():
            errors.append(f"{root.name}: missing {rel}")
        elif p.read_text() != want:
            errors.append(f"{root.name}: {rel} bytes differ")
    for debris in (".semmerge-journal.json", ".semmerge-stage",
                   ".semmerge-inplace.lock",
                   ".semmerge-inplace.lock.breaker"):
        if (root / debris).exists():
            errors.append(f"{root.name}: leftover {debris}")
    extra = hashlib.sha256()  # unexpected tracked-tree files
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root).as_posix()
        if rel.startswith(".git/") or rel.split("/")[0] in ARTIFACTS:
            continue
        if rel not in expected:
            errors.append(f"{root.name}: unexpected file {rel}")
        extra.update(rel.encode())
    return errors


# ---------------------------------------------------------------------------
# Wire plumbing (the harness IS a client: idempotent bounded retries)
# ---------------------------------------------------------------------------

class Transport(Exception):
    """Connection-level failure: daemon dead/respawning. Retryable."""


def _request_once(sock_path: str, params: Dict[str, Any],
                  timeout: float = 120.0) -> Dict[str, Any]:
    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(sock_path)
        rfile = s.makefile("r", encoding="utf-8")
        wfile = s.makefile("w", encoding="utf-8")
        protocol.write_message(wfile, {"id": 1, "method": "semmerge",
                                       "params": params})
        resp = protocol.read_message(rfile)
    except (OSError, protocol.ProtocolError) as exc:
        raise Transport(str(exc)) from exc
    finally:
        try:
            s.close()
        except OSError:
            pass
    if resp is None:
        raise Transport("connection closed before a response (daemon "
                        "killed mid-request)")
    return resp


def request(sock_path: str, repo: pathlib.Path, shape_env: Dict[str, str],
            stats: Dict[str, Any], deadline_s: float = 180.0,
            device: str = "cuda") -> Dict:
    """One merge request with the real client's resilience posture:
    an idempotency key pinned across attempts, transport failures
    retried until the supervisor brings the daemon back, typed
    ``retry_after_ms`` rejections honored. A request runs on the device
    its argv names, so a CPU soak names ``--device cpu``."""
    params = {
        "argv": ["basebr", "brA", "brB", "--inplace", "--backend", "host",
                 *(["--device", "cpu"] if device == "cpu" else [])],
        "cwd": str(repo),
        "env": shape_env,
        "idempotency_key": f"{os.getpid():x}-{os.urandom(8).hex()}",
    }
    deadline = time.monotonic() + deadline_s
    attempt = 0
    while True:
        try:
            resp = _request_once(sock_path, params)
        except Transport as exc:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"daemon never came back within {deadline_s:g}s: "
                    f"{exc}") from exc
            attempt += 1
            with stats["lock"]:
                stats["transport_retries"] += 1
            time.sleep(min(0.2 * (2 ** min(attempt, 4)), 2.0))
            continue
        err = resp.get("error")
        if err and isinstance(err.get("retry_after_ms"), int) \
                and "exit_code" in err:
            if time.monotonic() > deadline:
                return resp
            with stats["lock"]:
                stats["shed_retries"] += 1
            time.sleep(err["retry_after_ms"] / 1000.0)
            continue
        return resp


# ---------------------------------------------------------------------------
# Supervised daemon lifecycle
# ---------------------------------------------------------------------------

def spawn_supervised(sock_path: str, dump_path: pathlib.Path,
                     extra_env: Optional[Dict[str, str]] = None,
                     workers: int = 8, device: str = "cuda") -> subprocess.Popen:
    """Start ``serve --supervise --device DEVICE`` on ``sock_path``."""
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO_ROOT),
        "SEMMERGE_DAEMON": "off",
        "SEMMERGE_METRICS": str(dump_path),
        "SEMMERGE_SUPERVISE_BACKOFF": "0.1",
        "SEMMERGE_SERVICE_WORKERS": str(workers),
    })
    env.pop("SEMMERGE_FAULT", None)
    env.pop("SEMMERGE_STRICT", None)
    env.pop("SEMMERGE_RESOLVE", None)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # the request threads share the cores
    if extra_env:
        env.update(extra_env)
    log = open(sock_path + ".log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", PACKAGE, "serve",
         "--supervise", "--socket", sock_path, "--device", device],
        stdin=subprocess.DEVNULL, stdout=log, stderr=log,
        cwd="/", env=env, start_new_session=True)
    log.close()
    return proc


def control(sock_path: str, method: str,
            params: Optional[Dict[str, Any]] = None,
            timeout: float = 5.0) -> Optional[dict]:
    """One control-verb round trip (status/drain/leave/...); ``None``
    on any transport failure — callers poll."""
    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(sock_path)
        rfile = s.makefile("r", encoding="utf-8")
        wfile = s.makefile("w", encoding="utf-8")
        protocol.write_message(wfile, {"id": 1, "method": method,
                                       "params": params or {}})
        resp = protocol.read_message(rfile)
        return (resp or {}).get("result")
    except (OSError, protocol.ProtocolError):
        return None
    finally:
        try:
            s.close()
        except OSError:
            pass


def daemon_status(sock_path: str, timeout: float = 5.0) -> Optional[dict]:
    return control(sock_path, "status", timeout=timeout)


def wait_daemon(sock_path: str, sup: subprocess.Popen,
                timeout: float = 180.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sup.poll() is not None:
            raise RuntimeError(f"supervisor exited rc={sup.returncode} "
                               f"(log: {sock_path}.log)")
        status = daemon_status(sock_path)
        if status:
            return status
        time.sleep(0.2)
    raise RuntimeError(f"daemon not up within {timeout:g}s "
                       f"(log: {sock_path}.log)")


# ---------------------------------------------------------------------------
# The soak
# ---------------------------------------------------------------------------

def run_soak(workdir: pathlib.Path, *, requests: int = 200, repos: int = 8,
             concurrency: int = 8, kills: int = 2, seed: int = 1,
             hard_mb: float = 4096.0,
             extra_env: Optional[Dict[str, str]] = None,
             device: str = "cuda") -> Dict[str, Any]:
    """Run the full scenario against a daemon on ``device``; returns the
    report (see module doc)."""
    rng = random.Random(seed)
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    repo_paths = [build_repo(workdir / f"repo{i}") for i in range(repos)]
    # A smaller pool of genuinely-conflicting repos serviced only by
    # the resolver-enabled shape (resolver-off traffic against them
    # would exit 1 and break the byte-exact settling invariant).
    conflict_paths = [build_conflict_repo(workdir / f"crepo{i}")
                      for i in range(max(1, repos // 4))]
    sock = str(workdir / "chaos.sock")
    dump = workdir / "supervisor-metrics.json"
    env = {"SEMMERGE_RSS_HARD_MB": str(hard_mb)}
    env.update(extra_env or {})
    sup = spawn_supervised(sock, dump, extra_env=env, device=device)

    stats: Dict[str, Any] = {
        "lock": threading.Lock(), "transport_retries": 0,
        "shed_retries": 0, "outcomes": {}, "bad_responses": [],
        "kills": 0, "pids_seen": set(),
    }
    report: Dict[str, Any] = {"requests": requests, "errors": []}
    t0 = time.monotonic()
    try:
        status = wait_daemon(sock, sup)
        stats["pids_seen"].add(status["pid"])

        # The request schedule: shapes spread over repos (the resolve
        # shape over the conflict-repo pool), kill points scattered
        # through the middle of the run.
        schedule = []
        for _ in range(requests):
            shape = SHAPES[rng.randrange(len(SHAPES))]
            pool = conflict_paths if shape[0] == "resolve" else repo_paths
            schedule.append((pool[rng.randrange(len(pool))], shape))
        kill_points = sorted(rng.sample(
            range(requests // 4, max(requests // 4 + kills, 3 * requests // 4)),
            kills)) if kills else []
        done = {"n": 0}
        sem = threading.Semaphore(concurrency)
        threads: List[threading.Thread] = []

        def fire(repo: pathlib.Path, shape) -> None:
            name, shape_env, allowed = shape
            try:
                resp = request(sock, repo, dict(shape_env), stats, device=device)
            except RuntimeError as exc:
                with stats["lock"]:
                    stats["bad_responses"].append(f"{name}: {exc}")
                return
            finally:
                sem.release()
            code = None
            if "result" in resp:
                code = resp["result"].get("exit_code")
            elif "error" in resp:
                code = resp["error"].get("exit_code")
            with stats["lock"]:
                stats["outcomes"].setdefault(name, {}).setdefault(
                    str(code), 0)
                stats["outcomes"][name][str(code)] += 1
                if code not in allowed:
                    stats["bad_responses"].append(
                        f"{name}: exit {code!r} not in documented {allowed} "
                        f"({resp.get('error') or ''})")

        for i, (repo, shape) in enumerate(schedule):
            if kill_points and i == kill_points[0]:
                kill_points.pop(0)
                status = daemon_status(sock)
                if status:
                    try:
                        os.kill(status["pid"], signal.SIGKILL)
                        with stats["lock"]:
                            stats["kills"] += 1
                    except OSError:
                        pass
            sem.acquire()
            t = threading.Thread(target=fire, args=(repo, shape))
            t.start()
            threads.append(t)
            done["n"] = i + 1
        for t in threads:
            t.join(timeout=300)

        # Settle: one clean merge per repo resolves any journal left by
        # a SIGKILL mid-commit, then the tree must be byte-exact.
        # Conflict repos settle with the resolution tier enabled and
        # must land on the resolver's verified suggestion.
        final = wait_daemon(sock, sup)
        stats["pids_seen"].add(final["pid"])
        for repo in repo_paths + conflict_paths:
            is_conflict = repo in conflict_paths
            settle_env = dict(RESOLVE_ENV) if is_conflict else {}
            settle_by = time.monotonic() + 60.0
            while True:
                resp = request(sock, repo, dict(settle_env), stats, device=device)
                code = (resp.get("result") or resp.get("error") or {}) \
                    .get("exit_code")
                if code == 0:
                    break
                # A conflict repo's settle can land while the fault
                # traffic's host-rung breaker is still open (textual
                # rung, where the rename genuinely conflicts: exit 1).
                # Wait out the breaker cooldown and retry.
                if not (is_conflict and code == 1
                        and time.monotonic() < settle_by):
                    report["errors"].append(
                        f"{repo.name}: settling merge exited {code!r}")
                    break
                time.sleep(1.0)
        for repo in repo_paths:
            report["errors"].extend(tree_errors(repo))
        for repo in conflict_paths:
            report["errors"].extend(tree_errors(repo, RESOLVED_TREE))

        final = daemon_status(sock) or final
        counters = (final.get("metrics") or {}).get("counters", {})

        def _counter_total(name):
            series = counters.get(name, {}).get("series")
            if series is None:
                return None
            return sum(s["value"] for s in series)

        # Breaker/shedding state of the (possibly respawned) daemon —
        # proves the resilience machinery was live during the chaos.
        report["breaker_transitions"] = _counter_total(
            "breaker_transitions_total")
        report["shed_total"] = _counter_total("service_shed_total")
        # Resolver activity in the surviving daemon's lifetime; the
        # resolver-settled merges above guarantee at least one
        # accepted resolution even right after a respawn.
        report["resolutions_total"] = _counter_total("resolutions_total")
        report["breakers"] = (final.get("resilience") or {}).get("breakers")
        # The port's rung labels: ``torch`` where the JAX soak's breaker
        # is the ``host`` rung's.
        report["breaker_rungs"] = sorted(report["breakers"] or {})
        report["final_rss_mb"] = final.get("rss_mb")
        if report["final_rss_mb"] is None \
                or report["final_rss_mb"] >= hard_mb:
            report["errors"].append(
                f"final RSS {report['final_rss_mb']} outside the "
                f"{hard_mb:g} MiB hard watermark")
        report["served_total"] = final.get("served_total")
    finally:
        # Orderly shutdown so the supervisor's metrics dump lands.
        if sup.poll() is None:
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=60)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait(timeout=10)

    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    report["outcomes"] = stats["outcomes"]
    report["transport_retries"] = stats["transport_retries"]
    report["shed_retries"] = stats["shed_retries"]
    report["kills"] = stats["kills"]
    report["daemon_pids_seen"] = len(stats["pids_seen"])
    report["errors"].extend(stats["bad_responses"])
    if stats["kills"] and report["daemon_pids_seen"] < 2:
        report["errors"].append(
            "daemon was SIGKILLed but no respawned pid was ever observed")
    try:
        metrics = json.loads(dump.read_text())
        series = metrics.get("counters", {}).get(
            "supervisor_restarts_total", {}).get("series", [])
        report["supervisor_restarts"] = sum(s["value"] for s in series)
    except (OSError, ValueError):
        report["supervisor_restarts"] = None
    if stats["kills"] and not report["supervisor_restarts"]:
        report["errors"].append(
            "supervisor restarts not observable in the metrics dump")
    report["ok"] = not report["errors"]
    return report


# ---------------------------------------------------------------------------
# Fleet soak: member + router SIGKILLs, WAL replay audit
# ---------------------------------------------------------------------------

#: Fleet-soak request shapes: only exit-0 traffic, because the fleet
#: invariant under test is exactly-once *effects* — every settled tree
#: byte-exact, no duplicate inplace effect from a WAL replay or a
#: failover re-dispatch.
FLEET_SHAPES = [
    ("clean", {}, {0}),
    ("degrade-scan", {"SEMMERGE_FAULT": "scan:raise"}, {0}),
]


def spawn_fleet_router(sock_path: str, *, members: int = 3,
                       extra_env: Optional[Dict[str, str]] = None,
                       device: str = "cuda") -> subprocess.Popen:
    """Start a ``fleet --device DEVICE`` router fronting ``members``
    supervised member daemons."""
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO_ROOT),
        "SEMMERGE_DAEMON": "off",
        "SEMMERGE_FLEET_HEALTH_INTERVAL": "0.2",
        "SEMMERGE_SUPERVISE_BACKOFF": "0.1",
    })
    for key in ("SEMMERGE_FAULT", "SEMMERGE_STRICT", "SEMMERGE_RESOLVE",
                "SEMMERGE_METRICS", "SEMMERGE_SERVICE_SOCKET"):
        env.pop(key, None)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # the request threads share the cores
    if extra_env:
        env.update(extra_env)
    log = open(sock_path + ".log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", PACKAGE, "fleet",
         "--socket", sock_path, "--members", str(members), "--device", device],
        stdin=subprocess.DEVNULL, stdout=log, stderr=log,
        cwd="/", env=env, start_new_session=True)
    log.close()
    return proc


def wait_fleet(sock_path: str, router: subprocess.Popen,
               min_members: int, timeout: float = 240.0) -> dict:
    """Wait until the router answers ``status`` with ``fleet: true``
    and at least ``min_members`` ring members."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if router.poll() is not None:
            raise RuntimeError(f"fleet router exited rc="
                               f"{router.returncode} "
                               f"(log: {sock_path}.log)")
        status = daemon_status(sock_path)
        if status and status.get("fleet") \
                and status.get("members_up", 0) >= min_members:
            return status
        time.sleep(0.2)
    raise RuntimeError(f"fleet not up within {timeout:g}s "
                       f"(log: {sock_path}.log)")


def spawn_tcp_member(router_sock: str, workdir: pathlib.Path,
                     member_id: str,
                     extra_env: Optional[Dict[str, str]] = None,
                     device: str = "cuda") -> subprocess.Popen:
    """Start a *standalone* member daemon on an ephemeral TCP port that
    announces itself to the router (``serve --join``) — the two-host-
    simulated shape: the router reaches it only over the TCP member
    transport, and it re-announces itself after router restarts or
    healed partitions."""
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO_ROOT),
        "SEMMERGE_DAEMON": "off",
        "SEMMERGE_FLEET_JOIN_INTERVAL": "0.5",
    })
    for key in ("SEMMERGE_FAULT", "SEMMERGE_STRICT", "SEMMERGE_RESOLVE",
                "SEMMERGE_METRICS", "SEMMERGE_SERVICE_SOCKET"):
        env.pop(key, None)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # the request threads share the cores
    if extra_env:
        env.update(extra_env)
    log_path = pathlib.Path(workdir) / f"member-{member_id}.log"
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", PACKAGE, "serve",
         "--socket", "tcp://127.0.0.1:0", "--join", router_sock,
         "--member-id", member_id, "--device", device],
        stdin=subprocess.DEVNULL, stdout=log, stderr=log,
        cwd="/", env=env, start_new_session=True)
    log.close()
    return proc


def wait_member(sock_path: str, member_id: str, *, in_ring: bool,
                timeout: float = 120.0) -> dict:
    """Wait until the router's view of ``member_id`` reaches (or, for
    ``in_ring=False``, leaves) the ring."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = daemon_status(sock_path)
        view = next((m for m in (status or {}).get("members", [])
                     if m.get("id") == member_id), None)
        if in_ring and view is not None and view.get("in_ring"):
            return view
        if not in_ring and (view is None or not view.get("in_ring")):
            return view or {}
        time.sleep(0.2)
    raise RuntimeError(
        f"member {member_id} never became "
        f"{'ring member' if in_ring else 'ejected'} within {timeout:g}s")


#: The one field a resend may change between a key's journaled
#: payloads (see :func:`audit_wal`).
TRACE_ONLY_FIELD = "params.trace_id"


def payload_diff(a: Any, b: Any, prefix: str = "") -> List[str]:
    """The dotted paths of the fields in which two JSON values differ
    (a dict's missing key counts as a difference at that key)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out: List[str] = []
        for key in sorted(set(a) | set(b), key=str):
            path = f"{prefix}.{key}" if prefix else str(key)
            if key not in a or key not in b:
                out.append(path)
            else:
                out.extend(payload_diff(a[key], b[key], path))
        return out
    return [] if a == b else [prefix or "<root>"]


def audit_wal(wal_dir: str) -> Tuple[List[str], List[str]]:
    """Exactly-once accounting over the full retained WAL history;
    returns ``(errors, trace-only keys)``.

    Invariants, those of the JAX audit: only documented record kinds;
    every ``dispatch`` and ``ack`` names a journaled request; acks never
    outnumber the journaled incarnations of their key; retries and
    carried-forward replays of one key journal the *same* request (same
    verb + params: two different requests under one idempotency key
    would be a duplicate-effect hazard).

    The last one has one stated exception. A resend that reaches a
    restarted router carries no trace id of its own (the soak's client,
    like the JAX soak's, sends none), so the new router mints a fresh
    one into ``params.trace_id`` (``fleet/router.py::_dispatch``) and
    the key's second incarnation differs from its first in that field
    alone. That is no duplicate effect: a member's idempotency cache is
    keyed on ``idempotency_key`` (``service/daemon.py::_idem_lookup``),
    never on the trace id, and the ``--inplace`` journal and the
    repository lock collapse a re-execution. So the audit reports which
    fields differ, fails on any difference but ``params.trace_id``, and
    returns the keys whose payloads differ in it alone, which the soak
    counts in its report (``wal_trace_only_keys``)."""
    errors: List[str] = []
    trace_only: List[str] = []
    records = fleet_wal.read_records(wal_dir)
    if not records:
        return [f"wal: no records found under {wal_dir}"], trace_only
    requests: Dict[str, List[dict]] = {}
    dispatches: Dict[str, int] = {}
    acks: Dict[str, int] = {}
    for rec in records:
        kind, key = rec.get("kind"), rec.get("key")
        if kind not in fleet_wal.RECORD_KINDS:
            errors.append(f"wal: undocumented record kind {kind!r}")
            continue
        if not isinstance(key, str) or not key:
            errors.append(f"wal: {kind} record without a key")
            continue
        if kind == "request":
            requests.setdefault(key, []).append(rec)
        elif kind == "dispatch":
            dispatches[key] = dispatches.get(key, 0) + 1
        else:
            acks[key] = acks.get(key, 0) + 1
    for key in set(dispatches) | set(acks):
        if key not in requests:
            errors.append(f"wal: key {key} dispatched/acked but never "
                          f"journaled")
    for key, recs in requests.items():
        payloads = [{"verb": r.get("verb"), "params": r.get("params")} for r in recs]
        fields = sorted({f for other in payloads[1:] for f in payload_diff(payloads[0], other)})
        if fields and fields != [TRACE_ONLY_FIELD]:
            shapes = {json.dumps(p, sort_keys=True) for p in payloads}
            errors.append(f"wal: key {key} journaled with "
                          f"{len(shapes)} different payloads (fields "
                          f"{', '.join(fields)}) — duplicate-effect hazard")
        elif fields:
            trace_only.append(key)
        if acks.get(key, 0) > len(recs):
            errors.append(f"wal: key {key} acked {acks[key]}x for "
                          f"{len(recs)} journaled incarnation(s)")
    return errors, trace_only


#: Requests carved out of the budget for each special (churn /
#: partition) phase so ``requests`` stays the total fired.
_PHASE_BURST = 4


def run_fleet_soak(workdir: pathlib.Path, *, requests: int = 40,
                   repos: int = 6, concurrency: int = 6,
                   members: int = 3, member_kills: int = 2,
                   router_kills: int = 1, seed: int = 1,
                   tcp_members: int = 0, partitions: int = 0,
                   churn: bool = False, device: str = "cuda") -> Dict[str, Any]:
    """Fleet kill-drill: randomized member SIGKILLs plus a router
    SIGKILL mid-stream (the replacement router reclaims the orphaned
    members, replays the WAL, and keeps serving). Every request must
    settle byte-exact with documented exits only; the WAL history must
    account for every effect exactly once.

    ``tcp_members`` adds standalone daemons joined over real TCP;
    ``partitions`` SIGSTOPs one of them (half-open link: the heartbeat,
    not the dial, must eject it — a ``reason="partition"`` failover)
    while traffic keeps settling on the survivors, then SIGCONTs it and
    waits for the rejoin; ``churn`` performs one elastic TCP join and
    one drain mid-load."""
    if partitions and tcp_members < 1:
        raise ValueError("--partitions needs at least one --tcp-members "
                         "(the half-open victim is a TCP member)")
    special_phases = partitions + (1 if churn else 0)
    main_requests = requests - _PHASE_BURST * special_phases
    kill_events = (["member"] * member_kills + ["router"] * router_kills)
    if main_requests < len(kill_events) + 2:
        raise ValueError(f"requests={requests} too small for "
                         f"{special_phases} special phase(s) plus "
                         f"{len(kill_events)} kill(s)")
    rng = random.Random(seed)
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    repo_paths = [build_repo(workdir / f"repo{i}") for i in range(repos)]
    sock = str(workdir / "fleet.sock")
    wal_dir = sock + ".semmerge-fleet-wal"
    router_env: Dict[str, str] = {}
    if partitions:
        # Partition ejection is heartbeat-paced: tighten the deadline so
        # the half-open victim is detected in ~3 probes, not ~3×2s.
        router_env["SEMMERGE_FLEET_HEARTBEAT_TIMEOUT"] = "0.75"
    router = spawn_fleet_router(sock, members=members,
                                extra_env=router_env, device=device)
    tcp_procs: Dict[str, subprocess.Popen] = {}
    stopped: Dict[str, subprocess.Popen] = {}

    stats: Dict[str, Any] = {
        "lock": threading.Lock(), "transport_retries": 0,
        "shed_retries": 0, "outcomes": {}, "bad_responses": [],
        "member_kills": 0, "router_kills": 0,
        "partitions": 0, "joins": 0, "drains": 0,
        "router_pids_seen": set(), "member_pids_seen": set(),
    }
    report: Dict[str, Any] = {"requests": requests, "errors": []}
    t0 = time.monotonic()
    try:
        status = wait_fleet(sock, router, min_members=members)
        stats["router_pids_seen"].add(status["pid"])
        for i in range(tcp_members):
            mid = f"t{i}"
            tcp_procs[mid] = spawn_tcp_member(sock, workdir, mid, device=device)
            wait_member(sock, mid, in_ring=True)
        status = daemon_status(sock) or status
        for m in status.get("members", []):
            if m.get("pid"):
                stats["member_pids_seen"].add(m["pid"])

        schedule = []
        for _ in range(main_requests):
            shape = FLEET_SHAPES[rng.randrange(len(FLEET_SHAPES))]
            schedule.append((repo_paths[rng.randrange(repos)], shape))
        lo = main_requests // 4
        hi = max(lo + len(kill_events), 3 * main_requests // 4)
        kill_points = sorted(
            zip(rng.sample(range(lo, hi), len(kill_events)),
                rng.sample(kill_events, len(kill_events))))
        sem = threading.Semaphore(concurrency)
        threads: List[threading.Thread] = []

        def fire(repo: pathlib.Path, shape) -> None:
            name, shape_env, allowed = shape
            try:
                resp = request(sock, repo, dict(shape_env), stats, device=device)
            except RuntimeError as exc:
                with stats["lock"]:
                    stats["bad_responses"].append(f"{name}: {exc}")
                return
            finally:
                sem.release()
            code = None
            if "result" in resp:
                code = resp["result"].get("exit_code")
            elif "error" in resp:
                code = resp["error"].get("exit_code")
            with stats["lock"]:
                stats["outcomes"].setdefault(name, {}).setdefault(
                    str(code), 0)
                stats["outcomes"][name][str(code)] += 1
                if code not in allowed:
                    stats["bad_responses"].append(
                        f"{name}: exit {code!r} not in documented "
                        f"{allowed} ({resp.get('error') or ''})")

        def launch(repo: pathlib.Path, shape) -> None:
            sem.acquire()
            t = threading.Thread(target=fire, args=(repo, shape))
            t.start()
            threads.append(t)

        def drain_inflight() -> None:
            for t in threads:
                t.join(timeout=300)
            del threads[:]

        def burst(n: int) -> None:
            for _ in range(n):
                shape = FLEET_SHAPES[rng.randrange(len(FLEET_SHAPES))]
                launch(repo_paths[rng.randrange(repos)], shape)
            drain_inflight()

        for i, (repo, shape) in enumerate(schedule):
            while kill_points and i == kill_points[0][0]:
                _, what = kill_points.pop(0)
                if what == "member":
                    # Only supervised members are SIGKILL fodder — a
                    # killed remote has no supervisor to bring it back.
                    # Poll briefly: the kill point may land right after
                    # a router respawn, before any child is back up.
                    victim_deadline = time.monotonic() + 60.0
                    while time.monotonic() < victim_deadline:
                        status = daemon_status(sock)
                        live = [m for m in
                                (status or {}).get("members", [])
                                if m.get("pid") and m.get("in_ring")
                                and not m.get("remote")]
                        if not live:
                            time.sleep(0.2)
                            continue
                        victim = live[rng.randrange(len(live))]
                        try:
                            os.kill(victim["pid"], signal.SIGKILL)
                        except OSError:
                            time.sleep(0.2)
                            continue
                        with stats["lock"]:
                            stats["member_kills"] += 1
                        break
                else:
                    try:
                        os.kill(router.pid, signal.SIGKILL)
                        router.wait(timeout=10)
                        with stats["lock"]:
                            stats["router_kills"] += 1
                    except OSError:
                        pass
                    router = spawn_fleet_router(sock, members=members,
                                                extra_env=router_env,
                                                device=device)
            launch(repo, shape)
        drain_inflight()

        if churn:
            # One elastic join + one drain mid-load: the newcomer
            # announces itself into a warm ring (moved keys handed
            # off), serves a burst, then is drained — a deliberate
            # leave, never a failure eject.
            cj = spawn_tcp_member(sock, workdir, "cj0", device=device)
            tcp_procs["cj0"] = cj
            wait_member(sock, "cj0", in_ring=True)
            stats["joins"] += 1
            burst(_PHASE_BURST // 2)
            ack = control(sock, "drain", {"member": "cj0"}, timeout=10.0)
            if not (ack or {}).get("ok"):
                report["errors"].append(
                    f"drain of churn member not acked: {ack!r}")
            wait_member(sock, "cj0", in_ring=False)
            stats["drains"] += 1
            burst(_PHASE_BURST - _PHASE_BURST // 2)

        for p in range(partitions):
            # Half-open partition: SIGSTOP keeps the victim's sockets
            # accepting (kernel backlog) while reads never complete, so
            # only the application-level heartbeat can detect it. Drain
            # in-flight work first — the drill measures detection and
            # failover, not a 600s dispatch stall.
            victim_id = f"t{p % tcp_members}"
            victim = tcp_procs[victim_id]
            try:
                os.kill(victim.pid, signal.SIGSTOP)
            except OSError:
                continue
            stopped[victim_id] = victim
            stats["partitions"] += 1
            try:
                wait_member(sock, victim_id, in_ring=False)
                burst(_PHASE_BURST)
            finally:
                try:
                    os.kill(victim.pid, signal.SIGCONT)
                except OSError:
                    pass
                stopped.pop(victim_id, None)
            wait_member(sock, victim_id, in_ring=True)

        expected_up = members + tcp_members
        final = wait_fleet(sock, router, min_members=expected_up)
        stats["router_pids_seen"].add(final["pid"])
        for m in final.get("members", []):
            if m.get("pid"):
                stats["member_pids_seen"].add(m["pid"])
        for repo in repo_paths:
            resp = request(sock, repo, {}, stats, device=device)
            code = (resp.get("result") or resp.get("error") or {}) \
                .get("exit_code")
            if code != 0:
                report["errors"].append(
                    f"{repo.name}: settling merge exited {code!r}")
        for repo in repo_paths:
            report["errors"].extend(tree_errors(repo))

        final = daemon_status(sock) or final
        counters = (final.get("metrics") or {}).get("counters", {})

        def _counter_total(name, **labels):
            series = counters.get(name, {}).get("series")
            if series is None:
                return None
            return sum(s["value"] for s in series
                       if all((s.get("labels") or {}).get(k) == v
                              for k, v in labels.items()))

        report["failovers_total"] = _counter_total("fleet_failovers_total")
        report["partition_failovers"] = _counter_total(
            "fleet_failovers_total", reason="partition")
        report["drain_failovers"] = _counter_total(
            "fleet_failovers_total", reason="drain")
        report["joins_total"] = _counter_total("fleet_joins_total")
        report["handoffs_total"] = _counter_total("fleet_handoffs_total")
        report["rehash_moves_total"] = _counter_total(
            "fleet_rehash_moves_total")
        report["wal_replayed_total"] = _counter_total(
            "fleet_wal_replayed_total")
        report["members_up"] = final.get("members_up")
        report["wal_open"] = (final.get("wal") or {}).get("open")
        if report["wal_open"] != 0:
            report["errors"].append(
                f"{report['wal_open']} WAL entries still open after "
                f"settling — journaled effects unaccounted for")
    finally:
        for proc in stopped.values():
            try:
                os.kill(proc.pid, signal.SIGCONT)
            except OSError:
                pass
        for proc in tcp_procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in tcp_procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if router.poll() is None:
            router.send_signal(signal.SIGTERM)
            try:
                router.wait(timeout=60)
            except subprocess.TimeoutExpired:
                router.kill()
                router.wait(timeout=10)

    wal_errors, trace_only = audit_wal(wal_dir)
    report["errors"].extend(wal_errors)
    report["wal_trace_only_keys"] = len(trace_only)
    report["elapsed_s"] = round(time.monotonic() - t0, 3)
    report["outcomes"] = stats["outcomes"]
    report["transport_retries"] = stats["transport_retries"]
    report["shed_retries"] = stats["shed_retries"]
    report["member_kills"] = stats["member_kills"]
    report["router_kills"] = stats["router_kills"]
    report["tcp_members"] = tcp_members
    report["partitions"] = stats["partitions"]
    report["churn_joins"] = stats["joins"]
    report["churn_drains"] = stats["drains"]
    report["router_pids_seen"] = len(stats["router_pids_seen"])
    report["member_pids_seen"] = len(stats["member_pids_seen"])
    report["errors"].extend(stats["bad_responses"])
    if stats["member_kills"] and not report.get("failovers_total"):
        report["errors"].append(
            "members were SIGKILLed but no fleet failover was counted")
    if stats["router_kills"] and report["router_pids_seen"] < 2:
        report["errors"].append(
            "router was SIGKILLed but no replacement pid was observed")
    if stats["partitions"] and not report.get("partition_failovers"):
        report["errors"].append(
            "a member was partitioned (SIGSTOP) but no "
            'reason="partition" failover was counted')
    if stats["drains"] and not report.get("drain_failovers"):
        report["errors"].append(
            'a member was drained but no reason="drain" failover was '
            "counted")
    if (tcp_members or stats["joins"]) and not report.get("joins_total"):
        report["errors"].append(
            "TCP members joined but fleet_joins_total stayed zero")
    report["ok"] = not report["errors"]
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Chaos/soak the port's supervised merge service")
    parser.add_argument("--requests", type=int, default=200)
    parser.add_argument("--repos", type=int, default=8)
    parser.add_argument("--concurrency", type=int, default=8)
    parser.add_argument("--kills", type=int, default=2)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--hard-mb", type=float, default=4096.0)
    parser.add_argument("--fleet", action="store_true",
                        help="Run the fleet kill-drill shape instead "
                             "(router + N members, member/router "
                             "SIGKILLs, WAL replay audit)")
    parser.add_argument("--members", type=int, default=3,
                        help="Fleet members (with --fleet)")
    parser.add_argument("--router-kills", type=int, default=1,
                        help="Router SIGKILLs mid-stream (with --fleet)")
    parser.add_argument("--tcp-members", type=int, default=0,
                        help="Standalone members joined over TCP "
                             "(with --fleet)")
    parser.add_argument("--partitions", type=int, default=0,
                        help="SIGSTOP partitions of a TCP member "
                             "(with --fleet; needs --tcp-members)")
    parser.add_argument("--churn", action="store_true",
                        help="One elastic TCP join + one drain "
                             "mid-load (with --fleet)")
    parser.add_argument("--workdir", default=None,
                        help="Scratch dir (default: a fresh temp dir)")
    parser.add_argument("--json", action="store_true",
                        help="Emit the full report as JSON")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="The daemons' and the requests' device (default: "
                             "the card)")
    args = parser.parse_args(argv)
    if args.workdir:
        workdir = pathlib.Path(args.workdir)
    else:
        import tempfile
        workdir = pathlib.Path(tempfile.mkdtemp(prefix="semmerge-chaos-"))
    if args.fleet:
        report = run_fleet_soak(
            workdir, requests=args.requests, repos=args.repos,
            concurrency=args.concurrency, members=args.members,
            member_kills=args.kills, router_kills=args.router_kills,
            seed=args.seed, tcp_members=args.tcp_members,
            partitions=args.partitions, churn=args.churn, device=args.device)
    else:
        report = run_soak(workdir, requests=args.requests,
                          repos=args.repos,
                          concurrency=args.concurrency, kills=args.kills,
                          seed=args.seed, hard_mb=args.hard_mb,
                          device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    elif args.fleet:
        print(f"fleet soak: {report['requests']} requests, "
              f"{report['member_kills']} member kills, "
              f"{report['router_kills']} router kills, "
              f"{report['partitions']} partitions, "
              f"{report['churn_joins']} joins, "
              f"{report['churn_drains']} drains, "
              f"{report['transport_retries']} transport retries, "
              f"{report['wal_trace_only_keys']} trace-id-only WAL keys, "
              f"{report['elapsed_s']}s -> "
              f"{'OK' if report['ok'] else 'FAIL'}")
        for err in report["errors"]:
            print(f"  {err}", file=sys.stderr)
    else:
        print(f"soak: {report['requests']} requests, "
              f"{report['kills']} kills, "
              f"{report['transport_retries']} transport retries, "
              f"rss {report.get('final_rss_mb')} MiB, "
              f"{report['elapsed_s']}s -> "
              f"{'OK' if report['ok'] else 'FAIL'}")
        for err in report["errors"]:
            print(f"  {err}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
