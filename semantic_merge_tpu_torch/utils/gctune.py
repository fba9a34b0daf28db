"""GC posture for a one-shot merge (the port's copy of the JAX package's
``utils/gctune.py``).

A merge materializes on the order of 10^5 retained record objects
(decl nodes, ops, dicts); CPython's default gen-0 threshold (700
allocations) makes the collector re-scan the growing object graph many
times during one merge. A process that performs one merge and exits
freezes its startup objects out of the young generations and raises
the thresholds. What that saves on this port's host is measured by
``chip_smoke.py``'s service phase (both ways, byte-identical outputs)
and recorded in ``PERF.md``; no figure is claimed here.

Called explicitly by the CLI for ``semdiff``, ``semmerge`` and
``semrebase`` only, never on import: a host application embedding the
package owns its own GC policy.
"""
from __future__ import annotations

import gc
import os


def tune_for_merge() -> None:
    """Freeze everything allocated so far into the permanent generation
    and raise collection thresholds. Idempotent; cheap to call again.

    ``SEMMERGE_GC_TUNE=0`` disables the tuning: long-running processes
    (the merge service daemon sets it for itself) must keep normal
    collection cadence — freezing per-request garbage into the
    permanent generation would leak it for the process lifetime. It is
    read from ``os.environ``, never from a request's overlay
    (:mod:`.reqenv`): a client's shipped environment must not make a
    daemon freeze its heap."""
    if os.environ.get("SEMMERGE_GC_TUNE", "").strip() == "0":
        return
    gc.collect()
    gc.freeze()
    gc.set_threshold(100_000, 50, 50)
