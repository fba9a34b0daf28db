"""The resolution engine: propose → verify → accept (the port's copy of
the JAX package's ``resolve/engine.py``).

Flow per merge (called from the CLI when the compose yields conflicts
and the posture enables the tier):

1. **Propose** — the ``resolver:propose`` fault-injection stage fires,
   then the resolver proposes. A unique top-scoring candidate wins; a
   tie or an empty proposal list marks the conflict unresolvable.
2. **Verify** — all-or-nothing: only when *every* conflict has a
   winner. The gates run in order: ``recompose`` (the rewritten streams
   re-compose on the device with no residual conflict), ``parity`` (the
   resolved tree equals the conflict-free merge's byte for byte outside
   the resolution's footprint), ``typecheck`` (vacuous without the
   toolchain, as in the main pipeline), ``format`` (the footprint
   formats). Any gate failure rejects the whole set.
3. **Accept / fall back** — acceptance hands the re-composed stream
   back to the CLI, which materializes it through the normal pipeline;
   every other outcome falls back to conflict-as-result. Every outcome
   lands in the artifact's ``resolutions`` audit block.

A resolver *fault* escapes as
:class:`~semantic_merge_tpu_torch.errors.ResolveFault` (or the class of
the stage that failed inside a gate); the CLI contains it under posture
``auto`` and exits 17 under ``require``. A device fault of the
re-compose is a :class:`~semantic_merge_tpu_torch.errors.KernelFault`,
which the CLI never contains.

Telemetry as in the JAX package: the ``resolution.propose`` (per
conflict) and ``resolution.verify`` spans and the ``resolution.accept``
record (layer ``resolve``); ``resolutions_total{category,outcome}`` with
outcomes ``no-candidates``, ``tie``, ``rejected``, ``accepted`` and
(category ``all``) ``fault``; a ``resolver-fault`` postmortem bundle for
an absorbed fault.

Each category is a circuit-breaker rung, ``resolve:<Category>``
(:mod:`semantic_merge_tpu_torch.service.resilience`; a no-op outside
the merge service unless ``SEMMERGE_BREAKER=on``): an open breaker
skips the category's proposals (``cause = "breaker-open"``), a fault or
a failed gate counts against it, an accepted resolution closes it.
"""
from __future__ import annotations

import logging
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.ops import Op
from ..errors import MergeFault, fault_boundary
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..service.resilience import breakers
from ..utils import faults, workdir
from .base import Candidate, ResolveContext, Resolver
from .search import SearchResolver

logger = logging.getLogger(__name__)

_METRIC_HELP = "Conflict-resolution proposals, by category and outcome"

#: Verify gates, in the order they run.
GATES = ("recompose", "parity", "typecheck", "format")


@dataclass
class ResolutionOutcome:
    """What the tier produced: the audit records always; a re-composed
    op stream only when every gate passed."""

    accepted: bool
    composed: Optional[List[Op]]
    records: List[dict] = field(default_factory=list)


def _count(category: str, outcome: str) -> None:
    obs_metrics.REGISTRY.counter("resolutions_total", _METRIC_HELP).inc(
        1, category=category, outcome=outcome)


def record_resolver_fault(fault: MergeFault) -> None:
    """Containment bookkeeping for a resolver fault the CLI absorbed
    (posture ``auto``): a log line, ``resolutions_total{category="all",
    outcome="fault"}`` and a ``resolver-fault`` postmortem bundle with
    the breakers' states."""
    logger.warning("conflict resolution fell back after %s", fault.describe())
    _count("all", "fault")
    obs_flight.dump(obs_spans.trace_id() or obs_flight.default_trace_id(),
                    "resolver-fault", fault=fault, breakers=breakers().snapshot(),
                    root=workdir.root())


def resolve_conflicts(conflicts: Sequence, log_a: List[Op], log_b: List[Op],
                      *, composed, base_tar: bytes, left_tar: bytes,
                      right_tar: bytes, strict_detect: bool, config, device,
                      resolver: Optional[Resolver] = None,
                      ) -> ResolutionOutcome:
    """Attempt to resolve ``conflicts`` by rewriting the raw op streams
    and re-running the pipeline's own compose (on ``device``) and apply.
    Never mutates its inputs; the only success path returns a freshly
    composed stream that passed every gate."""
    resolver = resolver or SearchResolver()
    ctx = ResolveContext(log_a, log_b, base_tar=base_tar,
                         left_tar=left_tar, right_tar=right_tar)
    board = breakers()

    records: List[dict] = []
    winners: List[Tuple[dict, Candidate]] = []
    for conflict in conflicts:
        cd = conflict.to_dict() if hasattr(conflict, "to_dict") else dict(conflict)
        category = str(cd.get("category", "unknown"))
        rec = {
            "conflict_id": cd.get("id"),
            "category": category,
            "resolver": resolver.name,
            "status": "rejected",
            "cause": None,
            "candidate": None,
            "candidates": 0,
            "scores": {},
            "gates": [],
        }
        records.append(rec)
        rung = f"resolve:{category}"
        if not board.allow(rung):
            rec["cause"] = "breaker-open"
            _count(category, "breaker-open")
            continue
        try:
            with obs_spans.span("resolution.propose", layer="resolve", category=category), \
                    fault_boundary("resolver:propose"):
                faults.check("resolver:propose")
                cands = list(resolver.propose(cd, ctx))
        except MergeFault:
            board.record_failure(rung)
            raise
        rec["candidates"] = len(cands)
        rec["scores"] = {c.id: c.score for c in cands}
        if not cands:
            rec["cause"] = "no-candidates"
            _count(category, "no-candidates")
            continue
        best = max(c.score for c in cands)
        top = [c for c in cands if c.score == best]
        if len(top) > 1 or best <= 0:
            # Equal evidence (or none): choosing would be a guess.
            rec["cause"] = "tie"
            _count(category, "tie")
            continue
        rec["candidate"] = top[0].audit()
        winners.append((rec, top[0]))

    if len(winners) < len(records):
        # All-or-nothing: a partially resolved merge is still a
        # conflicted merge.
        for rec, _ in winners:
            rec["cause"] = "peer-unresolved"
            _count(rec["category"], "rejected")
        return ResolutionOutcome(False, None, records)

    gates: List[dict] = []
    for rec in records:
        rec["gates"] = gates  # one shared verify run covers the set
    try:
        with obs_spans.span("resolution.verify", layer="resolve", n=len(winners)), \
                fault_boundary("resolver:verify"):
            faults.check("resolver:verify")
            composed2, failed = _verify(
                [c for _, c in winners], log_a, log_b, gates,
                composed=composed, base_tar=base_tar,
                strict_detect=strict_detect, config=config, device=device)
    except MergeFault:
        for rec, _ in winners:
            board.record_failure(f"resolve:{rec['category']}")
        raise
    if failed is not None:
        for rec, _ in winners:
            rec["cause"] = f"gate:{failed}"
            _count(rec["category"], "rejected")
            board.record_failure(f"resolve:{rec['category']}")
        return ResolutionOutcome(False, None, records)
    for rec, _ in winners:
        rec["status"] = "accepted"
        _count(rec["category"], "accepted")
        board.record_success(f"resolve:{rec['category']}")
    obs_spans.record("resolution.accept", 0.0, layer="resolve", n=len(winners))
    return ResolutionOutcome(True, composed2, records)


def _gate_row(name: str, ok: bool, t0: float,
              detail: Optional[str] = None) -> dict:
    row = {"gate": name, "ok": ok,
           "ms": round((time.perf_counter() - t0) * 1000.0, 3)}
    if detail:
        row["detail"] = detail
    return row


def _first_by_id(stream) -> Dict[str, Op]:
    """Op id → the first op of ``stream`` with that id."""
    out: Dict[str, Op] = {}
    for op in stream:
        out.setdefault(op.id, op)
    return out


def _verify(cands: List[Candidate], log_a: List[Op], log_b: List[Op],
            gates: List[dict], *, composed, base_tar: bytes,
            strict_detect: bool, config, device,
            ) -> Tuple[Optional[List[Op]], Optional[str]]:
    """Run the gate ladder over the united candidate set. Returns
    ``(composed_stream, None)`` on full success or ``(None,
    failed_gate_name)``; each gate appends its audit row either way.
    Only unexpected exceptions escape to the caller's fault boundary."""
    from ..core.strict_conflicts import detect_conflicts_strict
    from ..ops.compose import recompose_resolved
    from ..runtime.applier import apply_ops, touched_paths
    from ..runtime.emitter import emit_files
    from ..runtime.git import temp_tree
    from ..runtime.verify import typecheck_ts, untouched_parity

    # -- gate: recompose ----------------------------------------------------
    t0 = time.perf_counter()
    drops: set = set()
    replaces: Dict[str, Op] = {}
    for cand in cands:
        drops.update(cand.drops)
        for op_id, op in cand.replaces.items():
            if op_id in replaces and replaces[op_id].to_dict() != op.to_dict():
                gates.append(_gate_row("recompose", False, t0,
                                       "candidate-overlap"))
                return None, "recompose"
            replaces[op_id] = op
    if drops & set(replaces):
        gates.append(_gate_row("recompose", False, t0, "candidate-overlap"))
        return None, "recompose"
    ta = [replaces.get(op.id, op) for op in log_a if op.id not in drops]
    tb = [replaces.get(op.id, op) for op in log_b if op.id not in drops]
    residual: list = []
    if strict_detect:
        ta, tb, residual = detect_conflicts_strict(ta, tb)
    # The re-compose is the device's work: its failure is a KernelFault.
    with fault_boundary("kernel"):
        composed2, walk = recompose_resolved(ta, tb, device)
    residual = list(residual) + list(walk)
    if residual:
        gates.append(_gate_row(
            "recompose", False, t0,
            f"{len(residual)} residual conflict(s) after rewrite"))
        return None, "recompose"
    gates.append(_gate_row("recompose", True, t0))

    # -- gate: parity -------------------------------------------------------
    # The footprint is every file an op that *changed* between the
    # conflict-free stream and the resolved stream can write (chain
    # propagation may rewrite params of a surviving op, so compare
    # materialized records, not just ids). Outside it the two applied
    # trees must match byte for byte.
    t0 = time.perf_counter()
    orig_ops, new_ops = _first_by_id(composed), _first_by_id(composed2)
    orig = {oid: op.to_dict() for oid, op in orig_ops.items()}
    new = {oid: op.to_dict() for oid, op in new_ops.items()}
    changed = [oid for oid in set(orig) | set(new)
               if orig.get(oid) != new.get(oid)]
    footprint: set = set()
    for oid in changed:
        for by_id in (orig_ops, new_ops):
            if oid in by_id:
                footprint |= touched_paths([by_id[oid]])
    tree_orig = tree_new = None
    try:
        with temp_tree(base_tar) as base_tree:
            tree_orig = apply_ops(base_tree, list(composed))
        with temp_tree(base_tar) as base_tree:
            tree_new = apply_ops(base_tree, composed2)
        mismatches = untouched_parity(tree_orig, tree_new,
                                      exclude=footprint)
        if mismatches:
            gates.append(_gate_row(
                "parity", False, t0,
                "outside-footprint drift: " + ", ".join(mismatches[:5])))
            return None, "parity"
        gates.append(_gate_row("parity", True, t0))

        # -- gate: typecheck ------------------------------------------------
        t0 = time.perf_counter()
        if getattr(getattr(config, "ci", None), "require_typecheck", False):
            ok, diagnostics = typecheck_ts(tree_new)
            if not ok:
                gates.append(_gate_row(
                    "typecheck", False, t0,
                    "; ".join(diagnostics[:3]) or "type errors"))
                return None, "typecheck"
        gates.append(_gate_row("typecheck", True, t0))

        # -- gate: format ---------------------------------------------------
        t0 = time.perf_counter()
        formatter = None
        languages = getattr(config, "languages", None) or {}
        ts_cfg = languages.get("typescript") if hasattr(languages, "get") \
            else None
        if ts_cfg is not None and getattr(ts_cfg, "formatter_cmd", None):
            formatter = list(ts_cfg.formatter_cmd)
        try:
            emit_files(tree_new, formatter, paths=sorted(footprint))
        except Exception as exc:  # formatter blew past its own guards
            gates.append(_gate_row("format", False, t0,
                                   f"{type(exc).__name__}: {exc}"))
            return None, "format"
        gates.append(_gate_row("format", True, t0))
    finally:
        for tree in (tree_orig, tree_new):
            if tree is not None:
                shutil.rmtree(tree, ignore_errors=True)

    return composed2, None
