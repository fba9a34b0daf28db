"""RGA-style ordered-list CRDT, on the host.

The port's copy of the JAX package's ``core/crdt.py``: deterministic
ordering for reorderable lists (imports, params, statement blocks). The
reference implements this CRDT but never wires it in (reference
``semmerge/crdt.py:23-57`` is dead code; its intended plug-in points are
specified at reference ``requirements.md:71-75`` [CRD-001..004] and
``architecture.md:173-178``). Here the applier's ``reorderImports``
handler resolves order through it.

Ordering semantics (identical to the reference's observable behavior):
an insert lands *before* the first element whose key tuple
``(anchor, t, author, opid)`` compares strictly greater — i.e. stable
insertion order among equal keys; ``delete`` tombstones every element
with the value; ``move`` drops the first live element with the value
and reinserts it under the new key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class Key:
    anchor: str
    t: int
    author: str
    opid: str

    def as_tuple(self) -> tuple:
        return (self.anchor, self.t, self.author, self.opid)


@dataclass
class Elem:
    key: Key
    value: str
    tombstone: bool = False


class RGA:
    def __init__(self) -> None:
        self.elems: List[Elem] = []

    def insert(self, key: Key, value: str) -> None:
        idx = len(self.elems)
        for i, elem in enumerate(self.elems):
            if key.as_tuple() < elem.key.as_tuple():
                idx = i
                break
        self.elems.insert(idx, Elem(key, value))

    def move(self, value: str, key: Key) -> None:
        for i, elem in enumerate(self.elems):
            if not elem.tombstone and elem.value == value:
                self.elems.pop(i)
                break
        self.insert(key, value)

    def delete(self, value: str) -> None:
        for elem in self.elems:
            if elem.value == value:
                elem.tombstone = True

    def materialize(self) -> List[str]:
        return [e.value for e in self.elems if not e.tombstone]
