"""Deadline-supervised subprocess execution (the port's copy of the JAX
package's ``utils/procs.py``).

``subprocess.run(timeout=...)`` kills only the direct child on expiry;
``npx``-style launchers leave grandchildren holding the pipe, so the
follow-up ``communicate()`` wedges exactly when the deadline mattered.
:func:`run_with_deadline` runs the child in its own session and
SIGKILLs the whole process group on timeout, then raises a
:class:`~semantic_merge_tpu_torch.errors.DeadlineFault` carrying the
stage. Used by ``runtime/verify.py`` (tsc) and ``runtime/emitter.py``
(prettier).
"""
from __future__ import annotations

import os
import signal
import subprocess
from typing import Optional, Sequence

from ..errors import DeadlineFault


def env_seconds(name: str, default: float) -> float:
    """A non-negative float from the environment; 0 disables the
    deadline; unparseable values fall back to ``default``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return max(value, 0.0)


def kill_process_group(proc: subprocess.Popen) -> None:
    """SIGKILL ``proc``'s whole process group (falling back to the
    process itself when it leads no group we can signal)."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass


def run_with_deadline(cmd: Sequence[str], *, timeout: Optional[float],
                      stage: str, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run`` with process-group deadline semantics.

    ``timeout`` of ``None``/``0`` runs unbounded. On expiry the group is
    SIGKILLed and a :class:`DeadlineFault` (stage + cause="deadline")
    raised. ``FileNotFoundError`` (missing tool) propagates unchanged so
    callers keep their vacuous-pass contracts.
    """
    cmd = list(cmd)
    if not timeout or timeout <= 0:
        return subprocess.run(cmd, **kwargs)
    kwargs.setdefault("start_new_session", True)
    check = kwargs.pop("check", False)
    proc = subprocess.Popen(cmd, **kwargs)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_process_group(proc)
        try:
            proc.communicate(timeout=5)
        except Exception:
            pass
        raise DeadlineFault(
            f"{cmd[0]} exceeded its {timeout:g}s deadline",
            stage=stage, cause="deadline") from None
    completed = subprocess.CompletedProcess(cmd, proc.returncode, out, err)
    if check and proc.returncode != 0:
        raise subprocess.CalledProcessError(
            proc.returncode, cmd, output=out, stderr=err)
    return completed
