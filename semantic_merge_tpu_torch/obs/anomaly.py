"""Phase-aligned trace diffs: the part of the JAX package's
``obs/anomaly.py`` that ``trace diff`` reads.

:func:`phase_diff` compares two per-phase wall-second maps (A = the
offender, B = the baseline) and names the phase that grew most
``suspect_phase``. The JAX package's online detectors and triage
bundles run in its merge service and come with it. Stdlib only.
"""
from __future__ import annotations

from typing import Any, Dict


def phase_diff(a_phases: Dict[str, float],
               b_phases: Dict[str, float]) -> Dict[str, Any]:
    """Phase-aligned diff of two per-phase wall-second maps (A =
    offender, B = baseline). Rows are sorted by descending delta so the
    first row — ``suspect_phase`` — names the regression's top
    contributor."""
    rows = []
    for phase in sorted(set(a_phases) | set(b_phases)):
        a_ms = 1000.0 * float(a_phases.get(phase, 0.0))
        b_ms = 1000.0 * float(b_phases.get(phase, 0.0))
        rows.append({
            "phase": phase,
            "a_ms": round(a_ms, 3),
            "b_ms": round(b_ms, 3),
            "delta_ms": round(a_ms - b_ms, 3),
            "ratio": round(a_ms / b_ms, 3) if b_ms > 0 else None,
        })
    rows.sort(key=lambda r: -r["delta_ms"])
    return {"phases": rows,
            "suspect_phase": rows[0]["phase"]
            if rows and rows[0]["delta_ms"] > 0 else None}
