"""Fault injection — ``SEMMERGE_FAULT=stage:kind[:nth]``.

The port's copy of the JAX package's ``utils/faults.py``, for the stages
the port has. Deterministic fault injection for exercising the
degradation ladder, the resolution tier and the crash-safe in-place
commit without contriving real failures. The variable names ONE spec::

    SEMMERGE_FAULT=scan:raise          # RuntimeError on every scan hit
    SEMMERGE_FAULT=apply:fault:2       # ApplyFault on the 2nd hit only
    SEMMERGE_FAULT=commit:kill         # SIGKILL self mid-commit
    SEMMERGE_FAULT=worker-serve:hang=30   # the worker wedges for 30 s
    SEMMERGE_FAULT=resolver:propose:fault

=================  ===================================================
stage              call site
=================  ===================================================
scan               ``frontend.scanner.scan_snapshot_keyed``
worker             ``backends.subproc.SubprocessBackend._call`` (client)
worker-serve       ``runtime.worker.serve`` request loop (the worker
                   process; kinds ``hang``, ``exit``, ``kill`` and
                   ``garbage``, which answers a line that is not JSON)
kernel             ``ops.fused.FusedMergeEngine.merge`` (dispatch)
apply              ``runtime.applier.apply_ops``
emit               ``runtime.emitter.emit_files``
commit             ``runtime.inplace.commit_tree_inplace`` (after the
                   journal is written)
resolver:propose   ``resolve.engine.resolve_conflicts`` (propose)
resolver:verify    ``resolve.engine.resolve_conflicts`` (before the
                   gates)
net:connect        ``fleet.transport.dial``, before the connect
net:read           ``fleet.transport`` and the router's member relay,
                   before each reply read
net:partition      both of those seams (half-open: the dial succeeds
                   upstream, every read fails)
net:slow           ``fleet.transport.dial``: the verbatim kind (e.g.
                   ``net:slow:lag``) sleeps ``SEMMERGE_FAULT_NET_SLOW_S``
                   (default 0.2 s) per dial, then proceeds
=================  ===================================================

The ``net:*`` stages classify as
:class:`~semantic_merge_tpu_torch.errors.TransportFault` (exit 21 under
``SEMMERGE_FLEET=require``; the ladder falls through under ``auto``).

Kinds:

- ``raise`` — a plain ``RuntimeError`` (exercises the stage
  classification boundaries);
- ``fault`` — the stage's typed :class:`~semantic_merge_tpu_torch.
  errors.MergeFault` subclass, ``cause="injected"``;
- ``hang[=secs]`` — sleep (default 3600 s);
- ``exit[=code]`` — ``os._exit`` (default 70);
- ``kill`` — SIGKILL the current process;
- any other token is returned to the call site verbatim.

``nth`` is 1-based and counts hits of that stage within one process;
omitted means *every* hit, so a rung that meets the stage again faults
again. The counters are process-local (:func:`reset` clears them).
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

from ..errors import fault_for_stage
from . import reqenv

ENV_VAR = "SEMMERGE_FAULT"

#: Stage-name prefixes that contain a colon themselves: the parser joins
#: the first two segments for these (as the JAX package parses them, so
#: a spec names the same stage in both packages).
COMPOUND_STAGE_PREFIXES = ("service", "batch", "resolver", "net")

_counters: Dict[str, int] = {}


def reset() -> None:
    """Forget hit counters (test isolation)."""
    _counters.clear()


def _parse(env: str):
    """``(stage, kind, nth)`` or ``None`` for an unparseable spec."""
    parts = env.strip().split(":")
    if not parts or not parts[0]:
        return None
    if parts[0] in COMPOUND_STAGE_PREFIXES and len(parts) > 1 and parts[1]:
        parts = [f"{parts[0]}:{parts[1]}"] + parts[2:]
    stage = parts[0]
    kind = parts[1] if len(parts) > 1 and parts[1] else "raise"
    nth = None
    if len(parts) > 2 and parts[2]:
        try:
            nth = int(parts[2])
        except ValueError:
            return None
    return stage, kind, nth


def _arg(kind: str, default: float) -> float:
    if "=" in kind:
        try:
            return float(kind.split("=", 1)[1])
        except ValueError:
            pass
    return default


def check(stage: str) -> Optional[str]:
    """Injection point: fire the configured fault when ``stage``
    matches. Returns ``None`` (no spec / not this stage / not this
    hit), or the kind token for site-specific kinds."""
    env = reqenv.get(ENV_VAR)
    if not env:
        return None
    spec = _parse(env)
    if spec is None or spec[0] != stage:
        return None
    _, kind, nth = spec
    # A daemon request counts its hits afresh, as a one-shot run would.
    ov = reqenv.active()
    counters = _counters if ov is None else ov.setdefault("__fault_counters__", {})
    count = counters[stage] = counters.get(stage, 0) + 1
    if nth is not None and count != nth:
        return None
    if kind == "raise":
        raise RuntimeError(f"SEMMERGE_FAULT injected failure at {stage}")
    if kind == "fault":
        raise fault_for_stage(stage)(
            f"SEMMERGE_FAULT injected fault at {stage}",
            stage=stage, cause="injected")
    if kind.startswith("hang"):
        time.sleep(_arg(kind, 3600.0))
        return None
    if kind.startswith("exit"):
        os._exit(int(_arg(kind, 70)))
    if kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    return kind
