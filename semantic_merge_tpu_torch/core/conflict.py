"""Conflict data model.

The port's copy of the JAX package's ``core/conflict.py`` (the records a
parity-mode merge can produce). JSON-shape parity with the reference
conflict record (reference ``semmerge/conflict.py:10-49``), which the CLI
persists as ``.semmerge-conflicts.json``: id ``conf-<a8>-<b8>``, empty
minimal slice, keepA/keepB suggestions. The text layer's per-file
conflict record lives here too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

from .ids import stable_hash_hex
from .ops import Op


def conflicts_payload(conflicts: Sequence) -> List[Dict[str, Any]]:
    """The JSON payload of ``.semmerge-conflicts.json``: the bare array
    of conflict records (the JAX package's form when its resolution
    tier did not run, byte-identical to the reference's)."""
    return [c.to_dict() if hasattr(c, "to_dict") else c for c in conflicts]


@dataclass
class Conflict:
    id: str
    category: str
    symbolId: str
    addressIds: Dict[str, Any]
    opA: Dict[str, Any]
    opB: Dict[str, Any]
    minimalSlice: Dict[str, Any]
    suggestions: List[Dict[str, Any]]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "category": self.category,
            "symbolId": self.symbolId,
            "addressIds": self.addressIds,
            "opA": self.opA,
            "opB": self.opB,
            "minimalSlice": self.minimalSlice,
            "suggestions": self.suggestions,
        }


def divergent_rename_conflict(op_a: Op, op_b: Op) -> Conflict:
    """Two sides renamed the same symbol to different names
    (reference ``semmerge/conflict.py:34-49``)."""
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="DivergentRename",
        symbolId=op_a.target.symbolId,
        addressIds={"A": op_a.target.addressId, "B": op_b.target.addressId, "base": None},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": "", "start": 0, "end": 0, "code": ""},
        suggestions=[
            {"id": "keepA", "label": f"Rename to {op_a.params.get('newName')}", "ops": [op_a.id]},
            {"id": "keepB", "label": f"Rename to {op_b.params.get('newName')}", "ops": [op_b.id]},
        ],
    )


def text_merge_conflict(path: str, reason: str) -> Conflict:
    """A file outside the semantic pipeline that the text layer could
    not merge (both sides changed it incompatibly); the file itself is
    the minimal slice."""
    return Conflict(
        id=f"conf-{stable_hash_hex('text', path, n_hex=8)}-textmerg",
        category="TextMergeConflict",
        symbolId="",
        addressIds={"A": path, "B": path, "base": path},
        opA={}, opB={},
        minimalSlice={"path": path, "start": 0, "end": 0, "code": reason},
        suggestions=[],
    )
