"""Supervised daemon lifecycle: ``serve --supervise`` (the port of the
JAX package's ``service/supervisor.py``).

The daemon is warm state — decl caches, loaded kernels, the shared
interner and its device tables, the live batch scheduler — and warm
state dies with the process. A daemon lost
to an OOM kill, a fault-injection exit, or a plain crash turns every
subsequent client into a cold one-shot run until somebody restarts it.
The supervisor closes that gap: a deliberately *boring* parent process
(no torch, no engine imports — nothing in it can fail the way the child
does, and no CUDA context to inherit) that respawns the daemon with
capped exponential backoff as a fresh ``subprocess`` (never a ``fork``)
and hands the socket over.

Handoff works without fd passing because of ordering on both sides:

- the daemon's teardown closes and unlinks its socket *before* the
  drain loop, so a replacement can bind while stragglers finish;
- the daemon's bind probe-replaces a dead socket path, so a SIGKILLed
  child's stale socket never wedges the replacement.

Clients connecting in the respawn window see connection-refused, which
the client layer already treats as daemon-unavailable: ``auto`` posture
falls back in-process or retries with jittered backoff, ``require``
surfaces exit 12. No request is silently dropped.

Exit contract: a child that exits 0 (idle-exit, ``shutdown`` verb, or
a drained SIGTERM) ends supervision — that exit was *asked for*. Any
other exit respawns, counted in ``supervisor_restarts_total{reason}``
(``reason="signal"`` for signal deaths, ``"crash"`` for nonzero exits)
and recorded as a ``supervisor.restart`` span. SIGTERM/SIGINT to the
supervisor forwards to the child (which drains) and ends supervision
once the child is gone.

The supervisor keeps ``SEMMERGE_METRICS`` for itself and strips it
from the child's environment: parent and child exiting would otherwise
race their atexit dumps onto one path. The supervisor's dump carries
the restart counters; daemon-side metrics are served live over the
``status`` verb, which is where they are useful anyway.
"""
from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..utils.loggingx import logger

_RESTARTS_HELP = "Daemon children respawned by the supervisor, by reason"

#: A child that stayed up this long earned a fresh backoff ladder.
STABLE_SECONDS = 30.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def serve_argv(args) -> List[str]:
    """The child's command line: this interpreter, this package, the
    same ``serve`` flags — minus ``--supervise`` (the child must be a
    daemon, not another supervisor)."""
    argv = [sys.executable, "-m", "semantic_merge_tpu_torch", "serve"]
    if getattr(args, "socket", None):
        argv += ["--socket", str(args.socket)]
    if getattr(args, "workers", None) is not None:
        argv += ["--workers", str(args.workers)]
    if getattr(args, "queue", None) is not None:
        argv += ["--queue", str(args.queue)]
    if getattr(args, "idle_exit", None) is not None:
        argv += ["--idle-exit", str(args.idle_exit)]
    if getattr(args, "events", None):
        argv += ["--events", str(args.events)]
    if getattr(args, "join", None):
        argv += ["--join", str(args.join)]
    if getattr(args, "advertise", None):
        argv += ["--advertise", str(args.advertise)]
    if getattr(args, "capacity", None) is not None:
        argv += ["--capacity", str(args.capacity)]
    if getattr(args, "member_id", None):
        argv += ["--member-id", str(args.member_id)]
    if getattr(args, "device", None):
        argv += ["--device", str(args.device)]
    return argv


class MemberSupervisor:
    """Per-child respawn policy for the fleet router (``fleet/``), as
    in the JAX package. Each child is a fresh ``subprocess`` (never a
    ``fork``) of the port's daemon: the router holds no CUDA context
    for it to inherit.

    :class:`Supervisor` is a blocking run loop around one child; the
    fleet router supervises N member daemons from a single health
    thread, so this is the same policy — exponential backoff from
    ``SEMMERGE_SUPERVISE_BACKOFF`` capped at
    ``SEMMERGE_SUPERVISE_BACKOFF_CAP``, ladder reset after
    :data:`STABLE_SECONDS` of uptime — as a poll-style state machine.
    :meth:`ensure` is called periodically; it reaps a dead child,
    schedules the respawn, and spawns when the backoff elapses. Each
    member carries its own ladder: one crash-looping member settles at
    the cap without delaying its siblings' respawns.
    """

    def __init__(self, member_id: str, argv: Sequence[str], *,
                 env: Optional[dict] = None,
                 backoff: Optional[float] = None,
                 backoff_cap: Optional[float] = None) -> None:
        self.member_id = member_id
        self._argv = list(argv)
        self._env = dict(env) if env is not None else None
        self._backoff = backoff if backoff is not None else _env_float(
            "SEMMERGE_SUPERVISE_BACKOFF", 0.2)
        self._cap = backoff_cap if backoff_cap is not None else _env_float(
            "SEMMERGE_SUPERVISE_BACKOFF_CAP", 5.0)
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.last_rc: Optional[int] = None
        self._attempt = 0
        self._started_at = 0.0
        self._respawn_at: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ensure(self) -> Optional[str]:
        """Advance the state machine one tick.

        Returns ``"spawned"`` when this tick (re)spawned the child,
        ``"died"`` on the tick that reaped a death (the respawn is
        scheduled, not taken, so the caller can eject the member from
        the ring immediately), ``None`` otherwise.
        """
        now = time.monotonic()
        if self.proc is not None:
            rc = self.proc.poll()
            if rc is None:
                return None
            self.last_rc = rc
            self.proc = None
            if now - self._started_at >= STABLE_SECONDS:
                self._attempt = 0
            self._attempt += 1
            delay = min(self._backoff * (2 ** (self._attempt - 1)),
                        self._cap)
            self._respawn_at = now + delay
            logger.warning(
                "fleet member %s died (rc=%s); respawn in %.2fs "
                "(attempt %d)", self.member_id, rc, delay, self._attempt)
            return "died"
        if self._respawn_at is not None and now < self._respawn_at:
            return None
        self._respawn_at = None
        env = self._env if self._env is not None else dict(os.environ)
        env = dict(env)
        env.pop("SEMMERGE_METRICS", None)
        try:
            self.proc = subprocess.Popen(self._argv, env=env)
        except OSError as exc:
            logger.error("could not spawn fleet member %s: %s",
                         self.member_id, exc)
            self._respawn_at = now + self._cap
            return None
        self._started_at = now
        if self.last_rc is not None:
            self.restarts += 1
        logger.info("fleet member %s pid=%d up", self.member_id,
                    self.proc.pid)
        return "spawned"

    def terminate(self) -> None:
        if self.running():
            with contextlib.suppress(OSError):
                self.proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        if self.proc is not None:
            with contextlib.suppress(OSError):
                self.proc.kill()


class Supervisor:
    """Respawn loop around one daemon child.

    Backoff is exponential from ``SEMMERGE_SUPERVISE_BACKOFF`` (default
    0.2s) capped at ``SEMMERGE_SUPERVISE_BACKOFF_CAP`` (default 5s); a
    child that survives :data:`STABLE_SECONDS` resets the ladder, so a
    daemon that crashes once a day restarts in 0.2s, while a
    crash-looping one settles at the cap instead of spinning.
    ``SEMMERGE_SUPERVISE_MAX_RESTARTS`` (default 0 = unlimited) bounds
    consecutive *unstable* restarts for harness use."""

    def __init__(self, child_argv: Sequence[str], *,
                 backoff: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 max_restarts: Optional[int] = None) -> None:
        self._argv = list(child_argv)
        self._backoff = backoff if backoff is not None else _env_float(
            "SEMMERGE_SUPERVISE_BACKOFF", 0.2)
        self._cap = backoff_cap if backoff_cap is not None else _env_float(
            "SEMMERGE_SUPERVISE_BACKOFF_CAP", 5.0)
        if max_restarts is None:
            max_restarts = int(_env_float("SEMMERGE_SUPERVISE_MAX_RESTARTS",
                                          0))
        self._max_restarts = max(0, max_restarts)
        self._child: Optional[subprocess.Popen] = None
        self._stop_sig: Optional[int] = None

    # -- signals ----------------------------------------------------------

    def _on_signal(self, signum, frame) -> None:
        self._stop_sig = signum
        child = self._child
        if child is not None and child.poll() is None:
            with contextlib.suppress(OSError):
                child.send_signal(signum)

    # -- run loop ---------------------------------------------------------

    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        # Parent and child atexit dumps would race onto one path; the
        # supervisor keeps the dump (restart counters live here).
        env.pop("SEMMERGE_METRICS", None)
        return subprocess.Popen(self._argv, env=env)

    def _sleep_interruptible(self, seconds: float) -> bool:
        """Backoff nap; returns ``True`` if a stop signal cut it short."""
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if self._stop_sig is not None:
                return True
            time.sleep(min(0.05, seconds))
        return self._stop_sig is not None

    def run(self) -> int:
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, self._on_signal)
        attempt = 0
        try:
            while True:
                started = time.monotonic()
                try:
                    self._child = self._spawn()
                except OSError as exc:
                    logger.error("supervisor could not spawn daemon: %s", exc)
                    return 12
                logger.info("supervising daemon pid=%d argv=%r",
                            self._child.pid, self._argv)
                rc = self._child.wait()
                uptime = time.monotonic() - started
                self._child = None
                if self._stop_sig is not None:
                    # The stop was ours (forwarded); the child drained.
                    return 0 if rc == 0 else rc
                if rc == 0:
                    # Idle-exit or shutdown verb: the exit was asked for.
                    logger.info("daemon exited cleanly; supervision ends")
                    return 0
                if uptime >= STABLE_SECONDS:
                    attempt = 0
                attempt += 1
                reason = "signal" if rc < 0 else "crash"
                if self._max_restarts and attempt > self._max_restarts:
                    logger.error(
                        "daemon died %d times without stabilizing (last "
                        "rc=%d); giving up", attempt, rc)
                    return rc if rc > 0 else 12
                obs_metrics.REGISTRY.counter(
                    "supervisor_restarts_total",
                    _RESTARTS_HELP).inc(1, reason=reason)
                delay = min(self._backoff * (2 ** (attempt - 1)), self._cap)
                obs_spans.record("supervisor.restart", delay, layer="service",
                                 reason=reason, attempt=attempt, rc=rc)
                obs_flight.dump(
                    None, "supervisor-restart",
                    extra={"restart": {"reason": reason, "rc": rc,
                                       "attempt": attempt,
                                       "uptime_s": round(uptime, 3),
                                       "delay_s": round(delay, 3)}})
                logger.warning(
                    "daemon died (%s, rc=%d, uptime %.1fs); respawning in "
                    "%.2fs (attempt %d)", reason, rc, uptime, delay, attempt)
                if self._sleep_interruptible(delay):
                    return 0
        finally:
            for sig, handler in previous.items():
                with contextlib.suppress((ValueError, OSError)):
                    signal.signal(sig, handler)
