"""String interning and tensor encoding for the device pipeline.

The slice's part of the JAX package's ``core/encode.py``: every device
operation of the diff only needs *equality* or *order* on the strings
(symbol ids, addresses, names, file paths), so the host interns them to
dense int32 ids once per diff and ships struct-of-arrays int32 columns
to the device; results decode back through the same table.

Sentinel ``NULL_ID = -1`` encodes absent values (e.g. a
VariableStatement's null name); ``PAD_ID`` pads decl columns so padded
slots sort to the end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

NULL_ID = -1
#: int32 sentinel greater than any interned id — used as padding so
#: padded slots sort to the end.
PAD_ID = np.int32(2**31 - 1)


class Interner:
    """Insertion-ordered string→int32 interner."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self.strings: List[str] = []

    def intern(self, s: str | None) -> int:
        if s is None:
            return NULL_ID
        got = self._ids.get(s)
        if got is not None:
            return got
        new_id = len(self.strings)
        self.strings.append(s)
        self._ids[s] = new_id
        return new_id

    def lookup(self, idx: int) -> str | None:
        if idx == NULL_ID:
            return None
        return self.strings[idx]

    def __len__(self) -> int:
        return len(self.strings)


@dataclass
class DeclTensor:
    """A scanned snapshot as device-ready arrays (one row per decl,
    document order — the order the differ's map semantics key off)."""

    sym: np.ndarray    # int32 interned symbolId
    addr: np.ndarray   # int32 interned addressId
    name: np.ndarray   # int32 interned name, NULL_ID when anonymous
    file: np.ndarray   # int32 interned file path
    n: int

    @staticmethod
    def empty() -> "DeclTensor":
        z = np.zeros((0,), dtype=np.int32)
        return DeclTensor(z, z, z, z, 0)


def encode_decls(nodes, interner: Interner) -> DeclTensor:
    """Encode scanner output (``DeclNode`` list) with a shared interner."""
    n = len(nodes)
    sym = np.empty(n, dtype=np.int32)
    addr = np.empty(n, dtype=np.int32)
    name = np.empty(n, dtype=np.int32)
    file_ = np.empty(n, dtype=np.int32)
    for i, node in enumerate(nodes):
        sym[i] = interner.intern(node.symbolId)
        addr[i] = interner.intern(node.addressId)
        name[i] = interner.intern(node.name)
        file_[i] = interner.intern(node.file)
    return DeclTensor(sym=sym, addr=addr, name=name, file=file_, n=n)


def pad_to(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full((size,), fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def bucket_size(n: int, minimum: int = 8) -> int:
    """Smallest of ``{2^k, 3·2^(k-1)}`` ≥ ``n`` (and ≥ ``minimum``).

    Logarithmically many padded shapes, with padding waste capped at
    1/3 instead of 1/2 by the half-step ladder."""
    size = minimum
    while size < n:
        half = size + size // 2
        if half >= n and size % 2 == 0:
            return half
        size *= 2
    return size
