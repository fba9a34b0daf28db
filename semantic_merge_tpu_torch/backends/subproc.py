"""Subprocess backend — the client half of the worker seam (the port's
copy of the JAX package's ``backends/subproc.py``).

Speaks the newline JSON-RPC protocol of
:mod:`semantic_merge_tpu_torch.runtime.worker` to a child process
(reference ``semmerge/lang/ts/bridge.py:21-47`` spawns its Node worker
the same way). Crash isolation is the point: a dying worker raises a
clean :class:`WorkerError` here, which the CLI's degradation ladder
turns into a retry on the in-process engine (the ``host`` rung) instead
of a corrupted merge.

Supervision (the fault-containment layer):

- every request carries a **deadline** (``SEMMERGE_WORKER_TIMEOUT``
  seconds, default 120; constructor override for tests). The response
  read happens on a reader thread; on expiry the worker's whole
  process group is SIGKILLed — a wedged worker can never hang the
  merge, and killing the group unblocks the reader;
- **bounded respawn-and-resend**: idempotent methods (every protocol
  method is a pure function of its params) retry once by default
  (``SEMMERGE_WORKER_RETRIES``) against a freshly spawned worker, with
  exponential backoff. Retries land in the
  ``subprocess_retries_total{method}`` counter, respawns in
  ``subprocess_respawns_total{reason}``;
- the worker runs in its own session (``start_new_session``) so the
  group kill cannot take the CLI down with it.

The worker command is configurable (``[engine] worker_cmd`` in
``.semmerge.toml``), so any program that speaks the protocol can serve.
Default: the port's own worker over its engine (``python -m
semantic_merge_tpu_torch.runtime.worker --backend host``), with
``--device cpu`` when this backend is on the CPU; on the card the worker
starts on the card and pays its own CUDA start (the merge service keeps
it alive across requests). ``extensions`` stays TypeScript's, as in the
JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..core.conflict import Conflict
from ..core.ops import Op
from ..device import resolve_device
from ..errors import WorkerFault
from ..frontend.snapshot import TS_EXTENSIONS, Snapshot
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..utils import faults
from ..utils.loggingx import logger
from ..utils.procs import env_seconds, kill_process_group
from .base import BuildAndDiffResult, register_backend


class WorkerError(WorkerFault):
    """The worker died, wedged past its deadline, or answered with a
    protocol error. Subclasses :class:`~semantic_merge_tpu_torch.errors.
    WorkerFault`, so the CLI's degradation ladder catches it natively."""


#: Protocol methods that are pure functions of their params — safe to
#: resend against a respawned worker.
IDEMPOTENT_METHODS = frozenset({"buildAndDiff", "diff", "compose", "ping"})


# --- keep-alive worker sharing (daemon warm state) -------------------------
#
# The CLI builds a fresh backend per merge rung and closes it at rung
# end, so a one-shot process pays one worker spawn per merge. The merge
# service daemon (service/daemon.py) sets SEMMERGE_WORKER_KEEPALIVE=1 in
# its own environment: backend instances then check a process-global
# worker out of this registry (keyed by the worker command line) instead
# of spawning, and close() leaves it running — the supervised child
# stays warm across requests. Requests sharing a worker serialize their
# write+read round-trips on the registry lock entry; supervision
# (deadline group-kill, respawn-and-resend) is unchanged and a killed
# shared worker is dropped from the registry so the next request
# respawns it.

_SHARED_LOCK = threading.Lock()
_SHARED: Dict[tuple, "tuple[subprocess.Popen, threading.Lock]"] = {}


def _keepalive_enabled() -> bool:
    import os
    return os.environ.get("SEMMERGE_WORKER_KEEPALIVE", "").strip() == "1"


def shutdown_shared() -> None:
    """Close every keep-alive worker (daemon shutdown path)."""
    with _SHARED_LOCK:
        procs = [proc for proc, _ in _SHARED.values()]
        _SHARED.clear()
    for proc in procs:
        if proc.poll() is None:
            try:
                proc.stdin.close()
                proc.wait(timeout=5)
            except Exception:
                kill_process_group(proc)


def default_worker_cmd(device_type: str = "cuda") -> List[str]:
    """The port's own worker over its engine, on the caller's device."""
    cmd = [sys.executable, "-m", "semantic_merge_tpu_torch.runtime.worker",
           "--backend", "host"]
    return cmd + ["--device", "cpu"] if device_type == "cpu" else cmd


class SubprocessBackend:
    """``device``: the caller's device (``None``/``"cuda"`` or
    ``"cpu"``); ``host_workers`` is accepted for the registry and unused.
    ``phases`` sums the worker's ``_worker`` blocks since the last
    ``build_and_diff`` or ``diff``: ``worker.<method>`` for each
    request's wall, ``worker.<phase>`` for its phases."""

    name = "subprocess"
    extensions = frozenset(TS_EXTENSIONS)

    def __init__(self, worker_cmd: Optional[List[str]] = None, *,
                 device: str | None = None,
                 host_workers: int | None = None,
                 deadline: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 retry_backoff: float = 0.05,
                 retry_backoff_cap: Optional[float] = None) -> None:
        #: The caller's device: the default worker runs there too.
        self.device = resolve_device(device)
        self.phases: Dict[str, float] = {}
        self._cmd = worker_cmd or default_worker_cmd(self.device.type)
        self._proc: Optional[subprocess.Popen] = None
        self._io_lock = threading.Lock()
        self._next_id = 0
        self._deadline = (deadline if deadline is not None
                          else env_seconds("SEMMERGE_WORKER_TIMEOUT", 120.0))
        self._max_retries = (max_retries if max_retries is not None
                             else int(env_seconds("SEMMERGE_WORKER_RETRIES", 1)))
        self._retry_backoff = retry_backoff
        self._retry_backoff_cap = (
            retry_backoff_cap if retry_backoff_cap is not None
            else env_seconds("SEMMERGE_WORKER_BACKOFF_CAP", 2.0))
        #: Why the last worker went down — labels the respawn counter.
        self._down_reason: Optional[str] = None

    def configure(self, config) -> None:
        cmd = getattr(config.engine, "worker_cmd", None)
        if cmd:
            self._cmd = list(cmd)
            self._shutdown()

    # --- protocol plumbing -------------------------------------------------

    def _spawn(self) -> subprocess.Popen:
        # The default worker imports this package; make that work
        # from any cwd (the CLI usually runs inside a user repo).
        import os
        import pathlib
        env = dict(os.environ)
        pkg_root = str(pathlib.Path(__file__).resolve().parents[2])
        parts = [pkg_root, env.get("PYTHONPATH", "")]
        env["PYTHONPATH"] = os.pathsep.join(p for p in parts if p)
        # Own session: deadline expiry kills the worker's whole
        # process group without touching the CLI's.
        return subprocess.Popen(
            self._cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=env, start_new_session=True)

    def _note_respawn(self, reason: str) -> None:
        obs_metrics.REGISTRY.counter(
            "subprocess_respawns_total",
            "Workers respawned after a previous one went down, by reason",
        ).inc(1, reason=reason)

    def _ensure_proc(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            # A recorded teardown reason, or the worker died under us
            # without one (crash between requests). First-ever spawns
            # carry neither and are not respawns.
            reason = self._down_reason
            if reason is None and self._proc is not None:
                reason = "worker-exit"
            if _keepalive_enabled():
                key = tuple(self._cmd)
                with _SHARED_LOCK:
                    entry = _SHARED.get(key)
                    if entry is None or entry[0].poll() is not None:
                        if reason is None and entry is not None:
                            reason = "worker-exit"
                        entry = (self._spawn(), threading.Lock())
                        _SHARED[key] = entry
                        if reason:
                            self._note_respawn(reason)
                self._proc, self._io_lock = entry
            else:
                self._proc = self._spawn()
                if reason:
                    self._note_respawn(reason)
            self._down_reason = None
        return self._proc

    def _call(self, method: str, params: Dict) -> Dict:
        faults.check("worker")
        attempts = 1
        if method in IDEMPOTENT_METHODS and self._max_retries > 0:
            attempts += self._max_retries
        for attempt in range(attempts):
            try:
                return self._call_once(method, params)
            except WorkerError as exc:
                if attempt + 1 >= attempts:
                    raise
                obs_metrics.REGISTRY.counter(
                    "subprocess_retries_total",
                    "Worker requests resent after respawn, by method",
                ).inc(1, method=method)
                obs_spans.event("worker_retry", method=method,
                                attempt=attempt + 1, error=str(exc))
                logger.warning("worker %s failed (%s); respawning and "
                               "resending (attempt %d/%d)", method, exc,
                               attempt + 2, attempts)
                # Exponential with a cap: repeated deaths back off hard
                # enough to stop thrashing spawn/die loops, but a
                # bounded retry never sleeps unboundedly long.
                time.sleep(min(self._retry_backoff * (2 ** attempt),
                               self._retry_backoff_cap))
        raise AssertionError("unreachable")

    def _call_once(self, method: str, params: Dict) -> Dict:
        proc = self._ensure_proc()
        # One request/response round-trip at a time per worker process:
        # a keep-alive worker is shared by concurrent daemon requests,
        # and interleaved writes on one pipe would corrupt the framing.
        with self._io_lock:
            return self._roundtrip(proc, method, params)

    def _roundtrip(self, proc: subprocess.Popen, method: str,
                   params: Dict) -> Dict:
        self._next_id += 1
        request = {"id": self._next_id, "method": method, "params": params}
        tid = obs_spans.trace_id()
        if tid:
            request["trace_id"] = tid
        t_sent = time.perf_counter()
        try:
            proc.stdin.write(json.dumps(request) + "\n")
            proc.stdin.flush()
        except (BrokenPipeError, OSError) as exc:
            self._shutdown(reason="pipe-broken")
            raise WorkerError(f"worker pipe broke during {method}: {exc}",
                              cause=type(exc).__name__) from exc
        line = self._read_response_line(proc, method)
        if not line:
            # End of its output: the worker is exiting. Its pipe can close
            # before the process is reaped, so wait a moment for the code.
            try:
                code = proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                code = None
            self._shutdown(reason="worker-exit")
            raise WorkerError(
                f"worker exited (rc={code}) without answering {method}",
                cause="worker-exit")
        try:
            response = json.loads(line)
        except json.JSONDecodeError as exc:
            self._shutdown(reason="protocol")
            raise WorkerError(f"worker spoke non-JSON: {line[:200]!r}",
                              cause="protocol") from exc
        if response.get("id") != request["id"]:
            self._shutdown(reason="protocol")
            raise WorkerError(
                f"worker answered id {response.get('id')} to {request['id']}",
                cause="protocol")
        if "error" in response:
            # The worker survived — only this request failed.
            raise WorkerError(str(response["error"].get("message", "unknown")),
                              cause="request-error")
        result = response.get("result", {})
        for name, secs in self._graft_worker_spans(result, method, t_sent).items():
            self.phases[name] = self.phases.get(name, 0.0) + secs
        return result

    @staticmethod
    def _graft_worker_spans(result: Dict, method: str,
                            t_sent: float) -> Dict[str, float]:
        """Pull the worker-side ``_worker`` timing block out of the
        result and record it as ``worker.*`` spans in the caller's
        trace — the only window the client has into time spent on the
        far side of the pipe. Start times are approximated by the
        client-side send instant (wire latency shifts them slightly
        but preserves ordering). Returns the block as phases:
        ``worker.<method>`` and ``worker.<phase>``."""
        block = result.pop("_worker", None)
        if not isinstance(block, dict):
            return {}
        out: Dict[str, float] = {}
        seconds = block.get("seconds")
        if isinstance(seconds, (int, float)):
            obs_spans.record(f"worker.{method}", float(seconds),
                             layer="worker", t_start=t_sent)
            out[f"worker.{method}"] = float(seconds)
        phases = block.get("phases")
        if isinstance(phases, dict):
            for name, secs in phases.items():
                if isinstance(secs, (int, float)):
                    obs_spans.record(f"worker.{name}", float(secs),
                                     layer="worker", t_start=t_sent)
                    out[f"worker.{name}"] = float(secs)
        return out

    def _read_response_line(self, proc: subprocess.Popen, method: str) -> str:
        """One response line, bounded by the per-request deadline.

        ``readline`` blocks forever on a wedged worker, so it runs on a
        daemon reader thread; on expiry the worker's process group is
        killed (which also unblocks the reader via EOF) and a deadline
        WorkerError raised."""
        if not self._deadline or self._deadline <= 0:
            return proc.stdout.readline()
        box: list = []
        done = threading.Event()

        def read() -> None:
            try:
                box.append(proc.stdout.readline())
            except Exception as exc:  # pipe torn down under the reader
                box.append(exc)
            finally:
                done.set()

        reader = threading.Thread(target=read, daemon=True,
                                  name="semmerge-worker-read")
        reader.start()
        if not done.wait(self._deadline):
            kill_process_group(proc)
            done.wait(5.0)
            self._shutdown(reason="deadline")
            obs_metrics.REGISTRY.counter(
                "subprocess_deadline_kills_total",
                "Workers killed for exceeding the request deadline",
            ).inc(1, method=method)
            raise WorkerError(
                f"worker exceeded its {self._deadline:g}s deadline on "
                f"{method}; process group killed", cause="deadline")
        result = box[0] if box else ""
        if isinstance(result, Exception):
            self._shutdown(reason="pipe-broken")
            raise WorkerError(f"worker pipe broke during {method}: {result}",
                              cause=type(result).__name__) from result
        return result

    def _shutdown(self, reason: Optional[str] = None) -> None:
        self._down_reason = reason
        proc, self._proc = self._proc, None
        if proc is not None:
            with _SHARED_LOCK:
                # A torn-down worker must not be handed to the next
                # keep-alive checkout.
                for key, (shared, _) in list(_SHARED.items()):
                    if shared is proc:
                        del _SHARED[key]
            try:
                if proc.poll() is None:
                    proc.stdin.close()
                    proc.wait(timeout=5)
            except Exception:
                kill_process_group(proc)

    # --- Backend protocol --------------------------------------------------

    @staticmethod
    def _files(snap: Snapshot):
        return [{"path": f["path"], "content": f["content"]}
                for f in snap.files]

    def build_and_diff(self, base: Snapshot, left: Snapshot, right: Snapshot,
                       *, base_rev: str = "base", seed: str = "0",
                       timestamp: str | None = None,
                       change_signature: bool = False,
                       structured_apply: bool = False,
                       signature_matcher=None,
                       statement_ops: bool = False) -> BuildAndDiffResult:
        self.phases = {}
        if signature_matcher is not None:
            raise WorkerError(
                "signature_matcher is in-process only; the subprocess "
                "backend's worker owns its own matcher configuration")
        result = self._call("buildAndDiff", {
            "base": self._files(base), "left": self._files(left),
            "right": self._files(right), "baseRev": base_rev, "seed": seed,
            "timestamp": timestamp, "changeSignature": change_signature,
            "structuredApply": structured_apply,
            "statementOps": statement_ops,
        })
        return BuildAndDiffResult(
            op_log_left=[Op.from_dict(o) for o in result["opLogLeft"]],
            op_log_right=[Op.from_dict(o) for o in result["opLogRight"]],
            symbol_maps=result.get("symbolMaps", {}),
            diagnostics=result.get("diagnostics", []),
        )

    def diff(self, base: Snapshot, right: Snapshot,
             *, base_rev: str = "base", seed: str = "0",
             timestamp: str | None = None,
             change_signature: bool = False,
             structured_apply: bool = False,
             signature_matcher=None,
             statement_ops: bool = False) -> List[Op]:
        self.phases = {}
        result = self._call("diff", {
            "base": self._files(base), "right": self._files(right),
            "baseRev": base_rev, "seed": seed, "timestamp": timestamp,
            "changeSignature": change_signature,
            "structuredApply": structured_apply,
            "statementOps": statement_ops,
        })
        return [Op.from_dict(o) for o in result["opLog"]]

    def compose(self, delta_a: List[Op], delta_b: List[Op]):
        result = self._call("compose", {
            "deltaA": [op.to_dict() for op in delta_a],
            "deltaB": [op.to_dict() for op in delta_b],
        })
        composed = [Op.from_dict(o) for o in result["composed"]]
        conflicts = [Conflict(**c) for c in result["conflicts"]]
        return composed, conflicts

    def close(self) -> None:
        if self._proc is not None and _keepalive_enabled():
            # Keep-alive mode: the worker outlives this backend instance
            # (the daemon owns its lifetime via shutdown_shared()).
            self._proc = None
            return
        if self._proc is not None and self._proc.poll() is not None:
            self._proc = None  # already dead: nothing to hand shutdown to
        if self._proc is not None:
            # Shutdown is best-effort and must not inherit a long
            # request deadline: give a wedged worker 5 s, then kill.
            deadline, self._deadline = self._deadline, min(
                self._deadline or 5.0, 5.0)
            try:
                self._call_once("shutdown", {})
            except WorkerError:
                pass
            finally:
                self._deadline = deadline
            self._shutdown()


register_backend("subprocess", SubprocessBackend)
register_backend("worker", SubprocessBackend)
