"""Conflict data model.

The port's copy of the JAX package's ``core/conflict.py``: the records a
parity-mode merge can produce, and those of strict mode's statement
categories (:mod:`semantic_merge_tpu_torch.core.strict_conflicts`). JSON-shape parity with the reference
conflict record (reference ``semmerge/conflict.py:10-49``), which the CLI
persists as ``.semmerge-conflicts.json``: id ``conf-<a8>-<b8>``, empty
minimal slice, keepA/keepB suggestions. The text layer's per-file
conflict record lives here too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .ids import stable_hash_hex
from .ops import Op


#: Version of the structured ``.semmerge-conflicts.json`` shape (the
#: object form carrying a ``resolutions`` audit block). The bare array,
#: written whenever the resolution tier did not run, is implicitly
#: version 1 and stays byte-identical to the reference's.
CONFLICTS_SCHEMA_VERSION = 2


def conflicts_payload(conflicts: Sequence,
                      resolutions: Optional[Sequence[dict]] = None):
    """The JSON payload of ``.semmerge-conflicts.json``.

    ``resolutions=None`` (the tier never ran) keeps the bare array of
    conflict records; when the tier ran, the versioned object form with
    the audit trail, rejected proposals included (the JAX package's
    ``core/conflict.py::conflicts_payload``)."""
    rows = [c.to_dict() if hasattr(c, "to_dict") else c for c in conflicts]
    if resolutions is None:
        return rows
    return {
        "schema_version": CONFLICTS_SCHEMA_VERSION,
        "conflicts": rows,
        "resolutions": list(resolutions),
    }


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


def delete_vs_edit_conflict(op_del: Op, op_edit: Op, delete_side: str) -> Conflict:
    """One side deleted a declaration the other side edited.

    This conflict category is specified but unimplemented in the reference
    (reference ``requirements.md:93-99``); the record shape follows the
    reference's Conflict schema so tooling reads both categories uniformly.
    ``delete_side`` is ``"A"`` or ``"B"`` — which branch performed the delete.
    """
    op_a, op_b = (op_del, op_edit) if delete_side == "A" else (op_edit, op_del)
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="DeleteVsEdit",
        symbolId=op_del.target.symbolId,
        addressIds={"A": op_a.target.addressId, "B": op_b.target.addressId, "base": None},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": "", "start": 0, "end": 0, "code": ""},
        suggestions=[
            {"id": "keepDelete", "label": "Keep the deletion", "ops": [op_del.id]},
            {"id": "keepEdit", "label": "Keep the edit", "ops": [op_edit.id]},
        ],
    )


def concurrent_stmt_edit_conflict(op_a: Op, op_b: Op) -> Conflict:
    """Both sides edited the same declaration's statement body to
    different results ([CFR-002] "Concurrent edits to the same
    statement with overlapping token ranges", reference
    ``requirements.md:97``). Granularity is the per-decl body block —
    the unit ``editStmtBlock`` records; identical edits (equal
    ``newBodyHash``) agree and do not conflict. The minimal slice is
    the edited body itself, satisfying [CFR-003]'s minimal-code-slice
    requirement."""
    file = str(op_a.params.get("file", ""))
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="ConcurrentStmtEdit",
        symbolId=op_a.target.symbolId,
        addressIds={"A": op_a.target.addressId, "B": op_b.target.addressId,
                    "base": op_a.target.addressId},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": file, "start": 0, "end": 0,
                      "code": str(op_a.params.get("oldBody", ""))},
        suggestions=[
            {"id": "keepA", "label": "Keep branch A's body edit",
             "ops": [op_a.id]},
            {"id": "keepB", "label": "Keep branch B's body edit",
             "ops": [op_b.id]},
        ],
    )


def extract_vs_inline_conflict(op_extract: Op, op_inline: Op,
                               extract_side: str) -> Conflict:
    """One branch extracted a statement block into a new declaration
    while the other inlined a declaration with that same block
    ([CFR-002] "Extract vs inline on the same body", reference
    ``requirements.md:98``). The join key is ``blockHash`` — the
    content identity of the moved statements — so the motions conflict
    wherever the block lives. ``extract_side`` is ``"A"`` or ``"B"`` —
    which branch performed the extract."""
    op_a, op_b = ((op_extract, op_inline) if extract_side == "A"
                  else (op_inline, op_extract))
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="ExtractVsInline",
        symbolId=op_extract.target.symbolId,
        addressIds={"A": op_a.target.addressId, "B": op_b.target.addressId,
                    "base": None},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": str(op_extract.params.get("file", "")),
                      "start": 0, "end": 0,
                      "code": str(op_extract.params.get("blockHash", ""))},
        suggestions=[
            {"id": "keepExtract",
             "label": f"Keep the extracted {op_extract.params.get('newName')}",
             "ops": [op_extract.id]},
            {"id": "keepInline",
             "label": f"Keep {op_inline.params.get('methodName')} inlined",
             "ops": [op_inline.id]},
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
