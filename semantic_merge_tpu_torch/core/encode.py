"""String interning and tensor encoding for the device pipeline.

The port's part of the JAX package's ``core/encode.py``: every device
operation of the diff and the compose only needs *equality* or *order*
on the strings (symbol ids, addresses, names, file paths, timestamps,
op ids), so the host interns them to dense int32 ids once per diff or
compose and ships struct-of-arrays int32 columns to the device; results
decode back through the same table.

Sentinel ``NULL_ID = -1`` encodes absent values (e.g. a
VariableStatement's null name); ``PAD_ID`` pads decl columns so padded
slots sort to the end.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

NULL_ID = -1
#: int32 sentinel greater than any interned id — used as padding so
#: padded slots sort to the end.
PAD_ID = np.int32(2**31 - 1)


class Interner:
    """Insertion-ordered string→int32 interner.

    ``token`` is a process-unique id for *this* instance: cache keys
    that embed encoded ids include it, since ids mean something only
    relative to one interner's history. Interning is thread-safe: a hit
    is a lock-free dict read, a miss takes the lock with a re-check, and
    the append happens before the id becomes visible. ``shared = True``
    marks the process-shared instance of the merge service
    (``backends/ts_torch.py::shared_interner``): :meth:`object_table`
    then returns a copy, since another thread's later call may re-sync
    the cached buffer under a view."""

    _token_counter = itertools.count()

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self.strings: List[str] = []
        self._obj: np.ndarray | None = None
        self._obj_n = 0
        self.token = next(Interner._token_counter)
        self.shared = False
        self._lock = threading.Lock()
        self._intern_lock = threading.Lock()

    def intern(self, s: str | None) -> int:
        if s is None:
            return NULL_ID
        got = self._ids.get(s)
        if got is not None:
            return got
        with self._intern_lock:
            got = self._ids.get(s)
            if got is not None:
                return got
            new_id = len(self.strings)
            self.strings.append(s)
            self._ids[s] = new_id
            return new_id

    def object_table(self) -> np.ndarray:
        """Read-only numpy object mirror ``[*strings, None]`` (grown
        geometrically): fancy-indexing an int32 id column against it
        decodes the whole column in one gather, ``NULL_ID`` (-1) wrapping
        to the trailing ``None``. Gather from it at once; a later
        :meth:`intern` may overwrite the trailing slot. The lock lets the
        fused path's tail workers call it alongside each other."""
        with self._lock:
            n = len(self.strings)
            if self._obj is None or n + 1 > len(self._obj):
                grown = np.empty((max(64, 2 * (n + 1)),), dtype=object)
                grown[:n] = self.strings
                self._obj = grown
                self._obj_n = n
            elif n > self._obj_n:
                self._obj[self._obj_n:n] = self.strings[self._obj_n:n]
                self._obj_n = n
            self._obj[n] = None
            view = self._obj[:n + 1]
            if self.shared:
                return self._obj[:n + 1].copy()
            view.flags.writeable = False
            return view

    def lookup(self, idx: int) -> str | None:
        if idx == NULL_ID:
            return None
        return self.strings[idx]

    def __len__(self) -> int:
        return len(self.strings)


def equality_key(value) -> str | None:
    """A string key whose equality matches Python ``==`` on op-param
    values. The host conflict check compares raw ``params.get("newName")``
    values (reference ``semmerge/compose.py:66``), where ``1 == 1.0 ==
    True`` but ``1 != "1"`` — plain ``str()`` interning would merge the
    latter. Numbers map to their exact rational value, strings are
    tagged, everything else falls back to a type-tagged canonical repr.
    """
    if value is None:
        return None
    if isinstance(value, (bool, int, float)):
        import fractions
        import math
        if isinstance(value, float) and not math.isfinite(value):
            return f"float:{value!r}:{id(value)}"  # NaN != NaN → never equal
        return f"num:{fractions.Fraction(value)}"
    if isinstance(value, str):
        return f"str:{value}"
    try:
        import json
        return f"obj:{json.dumps(value, sort_keys=True, separators=(',', ':'))}"
    except (TypeError, ValueError):
        return f"repr:{type(value).__name__}:{value!r}"


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


def shard_ranges(n: int, rows_per_shard: int) -> list[tuple[int, int]]:
    """Split ``n`` rows into contiguous ``(lo, hi)`` ranges of at most
    ``rows_per_shard`` rows — the host-tail pipeline's shard plan, a pure
    function of its arguments so every consumer agrees on the shard
    boundaries. ``n = 0`` yields no shards."""
    if n <= 0:
        return []
    rows = max(1, int(rows_per_shard))
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def shard_bucket(n: int, k: int = 1) -> int:
    """Bucket that divides evenly into ``k`` shards: ``k`` × a ladder
    value ≥ ceil(n/k), at least 8 rows total. For ``k = 1`` this equals
    :func:`bucket_size`."""
    per = bucket_size(max((n + k - 1) // k, (8 + k - 1) // k), minimum=1)
    return k * per


# --- op-tensor encoding (compose input) --------------------------------------

#: The compose's int32 op columns, in :class:`OpTensor` field order.
OP_COLUMNS = ("prec", "ts_rank", "id_rank", "is_rename", "is_move", "sym",
              "new_name", "chain_name", "new_addr", "chain_file", "op_index")


@dataclass
class OpTensor:
    """An op log as struct-of-arrays int32 columns.

    ``prec``/``ts_rank``/``id_rank`` are the compose sort key; the
    param columns cover the fields compose reads or rewrites
    (reference ``semmerge/compose.py:30-49,71-82``). ``op_index``
    points back into the source ``List[Op]`` for decode.
    """

    prec: np.ndarray       # precedence of op type
    ts_rank: np.ndarray    # order-interned provenance.timestamp
    id_rank: np.ndarray    # order-interned op id
    is_rename: np.ndarray  # int32 0/1
    is_move: np.ndarray    # int32 0/1
    sym: np.ndarray        # interned target.symbolId
    new_name: np.ndarray   # interned equality_key(params.newName) or NULL —
    #   the DivergentRename comparison value (Python == semantics)
    chain_name: np.ndarray  # interned str(params.newName) for renames —
    #   the rename-chain value; distinct from new_name because the
    #   reference stores str(None) == "None" in the chain while the
    #   conflict check compares the raw None (semmerge/compose.py:66,72)
    new_addr: np.ndarray   # interned str(params.newAddress) or NULL
    chain_file: np.ndarray  # interned str(params.newFile or params.file) —
    #   the move-chain file contribution with host truthiness semantics
    #   (semmerge/compose.py:76: falsy newFile falls back to file)
    op_index: np.ndarray   # row → index in the source op list
    n: int


def encode_oplog(ops, interner: Interner, ts_table: Dict[str, int],
                 id_table: Dict[str, int]) -> OpTensor:
    """Encode a ``List[Op]``. ``ts_table``/``id_table`` are
    order-preserving rank maps built over *both* logs being composed."""
    from .ops import OP_PRECEDENCE, UNKNOWN_PRECEDENCE

    n = len(ops)
    cols = {k: np.empty(n, dtype=np.int32) for k in OP_COLUMNS}
    for i, op in enumerate(ops):
        ts = str(op.provenance.get("timestamp", "1970-01-01T00:00:00Z"))
        cols["prec"][i] = OP_PRECEDENCE.get(op.type, UNKNOWN_PRECEDENCE)
        cols["ts_rank"][i] = ts_table[ts]
        cols["id_rank"][i] = id_table[op.id]
        cols["is_rename"][i] = 1 if op.type == "renameSymbol" else 0
        cols["is_move"][i] = 1 if op.type == "moveDecl" else 0
        cols["sym"][i] = interner.intern(op.target.symbolId)
        p = op.params
        new_name = p.get("newName")
        cols["new_name"][i] = interner.intern(equality_key(new_name))
        cols["chain_name"][i] = (interner.intern(str(new_name))
                                 if op.type == "renameSymbol" else NULL_ID)
        new_addr = p.get("newAddress")
        cols["new_addr"][i] = interner.intern(str(new_addr)) if new_addr is not None else NULL_ID
        file_contrib = p.get("newFile") or p.get("file")
        cols["chain_file"][i] = (interner.intern(str(file_contrib))
                                 if file_contrib is not None else NULL_ID)
        cols["op_index"][i] = i
    return OpTensor(n=n, **cols)


def build_rank_tables(ops_a, ops_b) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Order-preserving rank maps for (timestamp, id) across both logs."""
    timestamps = set()
    ids = set()
    for op in [*ops_a, *ops_b]:
        timestamps.add(str(op.provenance.get("timestamp", "1970-01-01T00:00:00Z")))
        ids.add(op.id)
    ts_table = {s: i for i, s in enumerate(sorted(timestamps))}
    id_table = {s: i for i, s in enumerate(sorted(ids))}
    return ts_table, id_table
