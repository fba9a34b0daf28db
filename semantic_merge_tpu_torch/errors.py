"""Typed merge faults and their exit codes.

The port's part of the JAX package's ``errors.py``: the faults the
merge's own layers raise, with the same documented exit codes. The port
has no degradation ladder, so a fault ends the command with its code.
"""
from __future__ import annotations


class MergeFault(RuntimeError):
    """A merge stage failed; ``exit_code`` is what the CLI exits with."""

    exit_code = 70

    def __init__(self, message: str, *, stage: str, cause: str | None = None) -> None:
        super().__init__(message)
        self.stage = stage
        self.cause = cause

    def describe(self) -> str:
        cause = f", cause={self.cause}" if self.cause else ""
        return f"{type(self).__name__}[stage={self.stage}{cause}]: {self}"


class KernelFault(MergeFault):
    """The device engine failed, or there is no device to run it on."""

    exit_code = 11


class ApplyFault(MergeFault):
    """Tree materialization / in-place commit failure."""

    exit_code = 13


class DeadlineFault(MergeFault):
    """A subprocess deadline expired (typecheck, formatter)."""

    exit_code = 15
