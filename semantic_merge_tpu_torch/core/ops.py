"""Operation data contracts.

This is the parity surface with the reference engine: the wire/JSON shape
of an operation record must round-trip with the reference's op schema
(reference ``semmerge/ops.py:31-121`` and ``workers/ts/src/protocol.ts:4-13``):

    {"id", "schemaVersion", "type",
     "target": {"symbolId", "addressId"},
     "params", "guards", "effects", "provenance"}

The port's copy of the JAX package's ``core/ops.py``: the records a
diff produces, the composition precedence and sort key, and the op-log
serialization the notes store writes.

Differences from the reference, by design:

- Serialization uses canonical compact JSON (stdlib ``json`` with
  ``separators=(",", ":")``), byte-compatible with the reference's
  ``orjson.dumps`` output for the same dict.
- ``Op.new`` takes an optional deterministic id. The reference mints
  ``uuid4()`` ids and wall-clock timestamps (reference
  ``workers/ts/src/lift.ts:5-9``), which violates its own determinism
  requirement (reference ``requirements.md:163`` [NFR-DET-001]); here the
  id scheme lives in :mod:`semantic_merge_tpu_torch.core.ids` and is seeded.
"""
from __future__ import annotations

import copy
import json
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Literal, Mapping

OpType = Literal[
    "renameSymbol",
    "moveDecl",
    "addDecl",
    "deleteDecl",
    "changeSignature",
    "reorderParams",
    "addParam",
    "removeParam",
    "extractMethod",
    "inlineMethod",
    "updateCall",
    "editStmtBlock",
    "modifyImport",
    "reorderImports",
    "moveFile",
    "renameFile",
    "modifyNamespace",
]

#: The 17 operation kinds, in schema order (reference ``semmerge/ops.py:10-28``).
OP_TYPES: tuple[str, ...] = OpType.__args__  # type: ignore[attr-defined]

#: Composition precedence — lower composes earlier
#: (reference ``semmerge/compose.py:130-149``).
OP_PRECEDENCE: Dict[str, int] = {
    "moveDecl": 10,
    "renameSymbol": 11,
    "modifyImport": 12,
    "reorderImports": 13,
    "changeSignature": 20,
    "updateCall": 21,
    "addDecl": 30,
    "deleteDecl": 31,
    "extractMethod": 40,
    "inlineMethod": 41,
    "editStmtBlock": 50,
    "reorderParams": 51,
    "addParam": 52,
    "removeParam": 53,
    "moveFile": 60,
    "renameFile": 61,
    "modifyNamespace": 70,
}

#: Precedence assigned to unknown op types by the composer's sort
#: (reference ``semmerge/compose.py:18``).
UNKNOWN_PRECEDENCE = 99


def dumps_canonical(obj: Any) -> str:
    """Compact JSON, byte-compatible with the reference's orjson output."""
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False)


@dataclass(slots=True)
class Target:
    """The declaration an op acts on (reference ``semmerge/ops.py:31-39``)."""

    symbolId: str
    addressId: str | None = None

    def to_dict(self) -> Dict[str, Any]:
        return {"symbolId": self.symbolId, "addressId": self.addressId}


@dataclass(slots=True)
class Op:
    """One semantic change record (reference ``semmerge/ops.py:42-103``).

    ``slots=True``: a 10k-file merge materializes ~90k of these straight
    off the device fetch — slotted construction measured ~25% cheaper,
    and materialize is the largest host phase of the fused path."""

    id: str
    schemaVersion: int
    type: str
    target: Target
    params: Dict[str, Any]
    guards: Dict[str, Any]
    effects: Dict[str, Any]
    provenance: Dict[str, Any]

    @staticmethod
    def new(
        op_type: str,
        target: Target,
        params: Dict[str, Any] | None = None,
        guards: Dict[str, Any] | None = None,
        effects: Dict[str, Any] | None = None,
        provenance: Dict[str, Any] | None = None,
        op_id: str | None = None,
    ) -> "Op":
        return Op(
            id=op_id if op_id is not None else str(uuid.uuid4()),
            schemaVersion=1,
            type=op_type,
            target=target,
            params=params or {},
            guards=guards or {},
            effects=effects or {},
            provenance=provenance or {},
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "schemaVersion": self.schemaVersion,
            "type": self.type,
            "target": self.target.to_dict(),
            "params": self.params,
            "guards": self.guards,
            "effects": self.effects,
            "provenance": self.provenance,
        }

    @staticmethod
    def from_dict(data: Mapping[str, Any]) -> "Op":
        return Op(
            id=str(data["id"]),
            schemaVersion=int(data.get("schemaVersion", 1)),
            type=data["type"],
            target=Target(**data["target"]),
            params=dict(data.get("params", {})),
            guards=dict(data.get("guards", {})),
            effects=dict(data.get("effects", {})),
            provenance=dict(data.get("provenance", {})),
        )

    def pretty(self) -> str:
        return f"{self.type} {self.target.symbolId} {self.params}"

    def clone(self) -> "Op":
        """An independent deep copy, safe to mutate (the resolution
        tier's rewritten ops)."""
        return copy.deepcopy(self)

    def sort_key(self) -> tuple[int, str, str]:
        """The canonical composition sort key
        (reference ``semmerge/compose.py:16-18``)."""
        timestamp = str(self.provenance.get("timestamp", "1970-01-01T00:00:00Z"))
        return (OP_PRECEDENCE.get(self.type, UNKNOWN_PRECEDENCE), timestamp, self.id)


@dataclass
class OpLog:
    """An ordered collection of ops (reference ``semmerge/ops.py:106-121``)."""

    ops: List[Op] = field(default_factory=list)

    def to_json(self) -> str:
        return dumps_canonical([o.to_dict() for o in self.ops])

    def to_json_bytes(self) -> bytes:
        """UTF-8 bytes of :meth:`to_json` (the notes payload); a
        columnar op-log view (``ops/oplog_view.py``) serializes straight
        from its columns, or hands its device-rendered bytes through."""
        fast = getattr(self.ops, "to_json_bytes", None)
        if fast is not None:
            return fast()
        return self.to_json().encode("utf-8")

    @staticmethod
    def from_json(data: str) -> "OpLog":
        return OpLog([Op.from_dict(item) for item in json.loads(data)])

    def extend(self, ops: Iterable[Op]) -> None:
        self.ops.extend(ops)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)
