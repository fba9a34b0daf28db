"""Resolver contracts: candidates, the per-merge context, and the
``Resolver`` base class (the port's copy of the JAX package's
``resolve/base.py``).

A candidate is an *op-stream rewrite* — drop these op ids, replace
those ops — never direct text output. The engine re-composes and
re-materializes the rewritten streams through the pipeline a
conflict-free merge takes, which is what makes the verify gates
meaningful.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.ops import Op
from ..runtime.textmerge import tar_file_map


@dataclass(frozen=True)
class Candidate:
    """One proposed resolution of one conflict.

    ``drops`` are op ids removed from whichever side's stream holds
    them; ``replaces`` maps an op id to the op that takes its place
    in-stream. ``score`` is the resolver's evidence weight: the engine
    picks the unique maximum and treats ties as unresolvable."""

    id: str
    label: str
    rationale: str
    drops: Tuple[str, ...] = ()
    replaces: Dict[str, Op] = field(default_factory=dict)
    score: int = 0

    def audit(self) -> dict:
        """The artifact-facing shape (op ids only)."""
        return {
            "id": self.id,
            "label": self.label,
            "rationale": self.rationale,
            "drop": sorted(self.drops),
            "replace": sorted(self.replaces),
        }


class ResolveContext:
    """What a resolver may look at: the two raw op streams and the
    three tree snapshots, with lazy, cached path→bytes maps. Read-only
    evidence — mutation happens only through a candidate's
    drops/replaces, verified by the engine."""

    def __init__(self, log_a: List[Op], log_b: List[Op], *,
                 base_tar: bytes, left_tar: bytes, right_tar: bytes) -> None:
        self.log_a = list(log_a)
        self.log_b = list(log_b)
        self._tars = {"base": base_tar, "left": left_tar, "right": right_tar}
        self._maps: Dict[str, Dict[str, bytes]] = {}
        self._index: Dict[str, Tuple[str, Op]] = {}
        for op in self.log_a:
            self._index.setdefault(op.id, ("A", op))
        for op in self.log_b:
            self._index.setdefault(op.id, ("B", op))

    def tree_map(self, which: str) -> Dict[str, bytes]:
        """Path → bytes of the ``base``/``left``/``right`` snapshot."""
        cached = self._maps.get(which)
        if cached is None:
            cached = self._maps[which] = tar_file_map(self._tars[which])
        return cached

    def side_map(self, side: str) -> Dict[str, bytes]:
        """The snapshot of branch ``"A"`` (left) or ``"B"`` (right)."""
        return self.tree_map("left" if side == "A" else "right")

    def op(self, op_id: str) -> Optional[Op]:
        hit = self._index.get(op_id)
        return hit[1] if hit else None

    def side_of(self, op_id: str) -> Optional[str]:
        hit = self._index.get(op_id)
        return hit[0] if hit else None

    def side_log(self, side: str) -> List[Op]:
        return self.log_a if side == "A" else self.log_b


class Resolver(abc.ABC):
    """A conflict-resolution strategy: a pure function of (conflict
    record, context), with no filesystem writes and no randomness."""

    name = "resolver"

    @abc.abstractmethod
    def propose(self, conflict: dict, ctx: ResolveContext) -> List[Candidate]:
        """Candidates for one conflict record (``Conflict.to_dict()``
        shape). An empty list means "no grounds to resolve"."""
