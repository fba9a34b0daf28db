"""Typed merge faults, their exit codes and the stage → class table.

The port's part of the JAX package's ``errors.py``: the faults the
merge's own layers raise, with the same documented exit codes, and
:class:`fault_boundary`, which wraps a stage's unexpected exceptions
into the stage's class (:data:`STAGE_FAULTS`). The CLI's degradation
ladder (``cli.py``) reads the class: a device fault
(:func:`is_device_fault`) ends the command with its code under every
posture; any other fault moves the merge to the whole-tree textual rung
unless strict mode (``--no-degrade`` / ``SEMMERGE_STRICT=1``) is on.

====  =============================================================
code  meaning
====  =============================================================
10    ``ParseFault`` — snapshot or scan failure; the native scanner
      could not be built or loaded (:class:`NativeBuildFault`)
11    ``KernelFault`` — the device engine failed, a kernel did not
      build, or there is no CUDA device
12    ``WorkerFault`` — the merge service refused or could not serve
      the request (queue full, draining, overload, an open circuit
      breaker, ``SEMMERGE_DAEMON=require`` with no daemon)
13    ``ApplyFault`` — tree materialization or in-place commit failure
14    ``FormatFault`` — formatter failure escalated by fault injection
15    ``DeadlineFault`` — a subprocess or request deadline expired
16    ``BatchFault`` — the batched dispatch failed under
      ``SEMMERGE_BATCH=require``, or that posture could not be met
17    ``ResolveFault`` — the conflict-resolution tier failed under
      ``--resolve require``
70    ``UnsupportedSetting`` — a setting the port does not implement
====  =============================================================
"""
from __future__ import annotations

import subprocess


class MergeFault(RuntimeError):
    """A merge stage failed; ``exit_code`` is what the CLI exits with.

    ``stage`` names the pipeline stage it arose in (``scan``, ``merge``,
    ``apply``, …); ``cause`` is a short machine-readable reason
    (``"injected"``, an exception class name)."""

    exit_code = 70
    default_stage = "merge"

    def __init__(self, message: str = "", *, stage: str | None = None,
                 cause: str | None = None) -> None:
        super().__init__(message)
        self.stage = stage or self.default_stage
        self.cause = cause

    def describe(self) -> str:
        cause = f", cause={self.cause}" if self.cause else ""
        return f"{type(self).__name__}[stage={self.stage}{cause}]: {self}"


class UnsupportedSetting(MergeFault):
    """A setting that would change the JAX package's output and that the
    port does not implement: refused before any revision is read."""

    exit_code = 70
    default_stage = "config"


class ParseFault(MergeFault):
    """The snapshot scan failed."""

    exit_code = 10
    default_stage = "scan"


class NativeBuildFault(ParseFault):
    """The port's C++ scanner could not be built (no ``g++``, or it
    failed) or loaded. A build of the port's own sources, so it never
    degrades, whatever the posture."""


class KernelFault(MergeFault):
    """The device engine failed, a kernel did not build, or there is no
    device to run it on."""

    exit_code = 11
    default_stage = "kernel"


class WorkerFault(MergeFault):
    """The merge service could not take or serve a request (admission
    closed, queue full, memory pressure, an injected ``service:*``
    fault), or a ladder rung's circuit breaker is open."""

    exit_code = 12
    default_stage = "worker"


class ApplyFault(MergeFault):
    """Tree materialization / in-place commit failure."""

    exit_code = 13
    default_stage = "apply"


class FormatFault(MergeFault):
    """Formatter/emitter failure escalated past the best-effort posture
    (only by fault injection: a failing formatter is logged)."""

    exit_code = 14
    default_stage = "format"


class DeadlineFault(MergeFault):
    """A deadline expired: a subprocess's (typecheck, formatter) or a
    service request's (``SEMMERGE_SERVICE_DEADLINE``)."""

    exit_code = 15
    default_stage = "deadline"


class BatchFault(MergeFault):
    """The batched fused dispatch failed, or ``SEMMERGE_BATCH=require``
    could not be met (``batch/``). Under ``auto`` the affected request
    degrades to the inline dispatch on the same device and this never
    escapes; under ``require`` it is a device fault."""

    exit_code = 16
    default_stage = "batch"


class ResolveFault(MergeFault):
    """The conflict-resolution tier failed. Under ``--resolve auto`` the
    CLI contains it (conflict-as-result, the bytes of the tier being
    off); it exits only under ``--resolve require``."""

    exit_code = 17
    default_stage = "resolve"


#: The class each stage of the port wraps its *unexpected* exceptions
#: into (the JAX package's table, for the stages the port has).
STAGE_FAULTS = {
    "snapshot": ParseFault,
    "scan": ParseFault,
    "merge": KernelFault,
    "kernel": KernelFault,
    "chain": KernelFault,
    "resolve": ResolveFault,
    "resolver:propose": ResolveFault,
    "resolver:verify": ResolveFault,
    "materialize": ApplyFault,
    "apply": ApplyFault,
    "commit": ApplyFault,
    "format": FormatFault,
    "emit": FormatFault,
    "verify": DeadlineFault,
    "worker": WorkerFault,
    "worker-serve": WorkerFault,
    "service:accept": WorkerFault,
    "service:dispatch": WorkerFault,
    "service:execute": WorkerFault,
    "batch": BatchFault,
    "batch:pack": BatchFault,
    "batch:mesh": BatchFault,
    "batch:dispatch": BatchFault,
    "batch:scatter": BatchFault,
}

#: The documented fault exit codes of the port's classes, by class name
#: (each equal to the JAX package's).
EXIT_CODES = {cls.__name__: cls.exit_code for cls in
              (ParseFault, KernelFault, WorkerFault, ApplyFault, FormatFault,
               DeadlineFault, BatchFault, ResolveFault)}

#: Stages whose :class:`KernelFault` is the device's.
DEVICE_STAGES = frozenset(("merge", "kernel", "chain"))


def fault_for_stage(stage: str) -> type:
    """The fault class a stage's unexpected exceptions classify into."""
    return STAGE_FAULTS.get(stage, MergeFault)


def is_device_fault(fault: BaseException) -> bool:
    """A fault the degradation ladder must never hide: the device engine
    failed (a :class:`KernelFault` of the ``merge``, ``kernel`` or
    ``chain`` stage, an ``nvcc`` build included), a build of the
    port's own C++ failed (:class:`NativeBuildFault`), or the batched
    dispatch failed where it was required (:class:`BatchFault`)."""
    return ((isinstance(fault, KernelFault) and fault.stage in DEVICE_STAGES)
            or isinstance(fault, (NativeBuildFault, BatchFault)))


class fault_boundary:
    """Context manager classifying a stage's unexpected exceptions.

    A :class:`MergeFault` (raised by a deeper, better-informed layer)
    passes through unchanged, as does ``subprocess.CalledProcessError``
    (a git plumbing failure keeps its exit 3). Everything else derived
    from ``Exception`` is wrapped into the stage's fault class, the
    original chained as ``__cause__``."""

    def __init__(self, stage: str) -> None:
        self.stage = stage

    def __enter__(self) -> "fault_boundary":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is None or not isinstance(exc, Exception):
            return False
        if isinstance(exc, (MergeFault, subprocess.CalledProcessError)):
            return False
        raise fault_for_stage(self.stage)(
            str(exc), stage=self.stage, cause=type(exc).__name__) from exc
