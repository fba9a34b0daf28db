"""Columnar op-log views — op logs without ``Op`` objects.

The port of the JAX package's ``ops/oplog_view.py``. The fused merge
(:mod:`semantic_merge_tpu_torch.ops.fused`) fetches int32 columns —
``(kind, base slot, side slot, digest words)`` per op — and these views
keep them as the source of truth, materializing lazily:

- ``to_json_bytes()`` — the notes payload: the device-rendered bytes
  (:mod:`semantic_merge_tpu_torch.ops.render`) when the engine attached
  a render, else :meth:`OpStreamView._json_rows`, a vectorized Python
  serializer. Both are byte-identical to
  ``dumps_canonical([op.to_dict() for op in view])``, the reference's
  op-log JSON (reference ``semmerge/ops.py:106-121``).
- ``view[i]`` — one op, built on demand and cached (conflict
  constructors touch a handful of ops).
- ``iter(view)`` — every op, built in per-kind Python loops.

The JAX package's native C serializer and C op factory are not ported.

The DivergentRename cursor walk gets a columnar twin here too: the
reference's head-vs-head walk (reference ``semmerge/compose.py:51-112``)
only reads ``(precedence, is-rename, symbolId, newName)``, and the
interner makes string equality int equality, so the walk runs on int
rows and materializes nothing.
"""
from __future__ import annotations

import re
from bisect import bisect_left, bisect_right
from collections import OrderedDict
from json.encoder import encode_basestring
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.ops import Op, Target, dumps_canonical

#: Device diff kinds (ops/diff.py), re-declared so that this host module
#: imports no torch; pinned by the tests against the real values.
KIND_RENAME, KIND_MOVE, KIND_ADD, KIND_DELETE = 0, 1, 2, 3

#: Characters canonical JSON must escape with ensure_ascii=False
#: (json.encoder.ESCAPE): quote, backslash, C0 controls.
_ESC_RE = re.compile(r'["\\\x00-\x1f]')


def _esc_body(s: str) -> str:
    """The escaped *body* of a JSON string token (no quotes). Escaping
    is per character, so concatenating bodies with literal ASCII equals
    the body of the concatenation."""
    if _ESC_RE.search(s) is None:
        return s
    return encode_basestring(s)[1:-1]


def format_ids(words: np.ndarray) -> List[str]:
    """int32-bitcast digest words ``[n, 4]`` → UUID-shaped id strings:
    one bulk hex conversion, then the dashes placed by a byte scatter."""
    hx = np.ascontiguousarray(words).view(np.uint32).astype(">u4").tobytes().hex()
    b = np.frombuffer(hx.encode(), np.uint8).reshape(-1, 32)
    out = np.empty((b.shape[0], 36), np.uint8)
    out[:, [8, 13, 18, 23]] = ord("-")
    out[:, 0:8] = b[:, 0:8]
    out[:, 9:13] = b[:, 8:12]
    out[:, 14:18] = b[:, 12:16]
    out[:, 19:23] = b[:, 16:20]
    out[:, 24:36] = b[:, 20:32]
    flat = out.tobytes().decode("ascii")
    return [flat[36 * i:36 * i + 36] for i in range(b.shape[0])]


def _node_fields(nodes) -> Tuple[list, list, list, list]:
    """Per-node field columns as four string lists (symbolId, addressId,
    name, file): serializers gather from them by slot index."""
    return ([nd.symbolId for nd in nodes], [nd.addressId for nd in nodes],
            [nd.name for nd in nodes], [nd.file for nd in nodes])


def _get_fields(cache: Optional["OrderedDict"], nodes) -> Tuple[list, list, list, list]:
    """Field columns through ``cache`` (the fused engine's per-snapshot
    table, keyed by the node list's identity; each entry holds its list,
    so the key cannot be reused while the entry lives), else built
    fresh."""
    if cache is None:
        return _node_fields(nodes)
    hit = cache.get(id(nodes))
    if hit is not None and hit[1] is nodes:
        cache.move_to_end(id(nodes))
        return hit[0]
    fields = _node_fields(nodes)
    cache[id(nodes)] = (fields, nodes)
    while len(cache) > 16:
        cache.popitem(last=False)
    return fields


#: Row templates of the vectorized serializer, one per kind. ``%s``
#: slots receive escaped string BODIES (ids are hex, never escaped); the
#: provenance literal is spliced in by :func:`_kind_templates`.
_TMPL_RENAME = (
    '{"id":"%s","schemaVersion":1,"type":"renameSymbol","target":'
    '{"symbolId":"%s","addressId":"%s"},"params":{"oldName":"%s",'
    '"newName":"%s","file":"%s"},"guards":{"exists":true,'
    '"addressMatch":"%s"},"effects":{"summary":"rename %s→%s"},'
    '"provenance":')
_TMPL_MOVE = (
    '{"id":"%s","schemaVersion":1,"type":"moveDecl","target":'
    '{"symbolId":"%s","addressId":"%s"},"params":{"oldAddress":"%s",'
    '"newAddress":"%s","oldFile":"%s","newFile":"%s"},"guards":'
    '{"exists":true,"addressMatch":"%s"},"effects":{"summary":'
    '"move %s→%s"},"provenance":')
_TMPL_ADD = (
    '{"id":"%s","schemaVersion":1,"type":"addDecl","target":'
    '{"symbolId":"%s","addressId":"%s"},"params":{"file":"%s"},'
    '"guards":{},"effects":{"summary":"add decl"},"provenance":')
_TMPL_DELETE = (
    '{"id":"%s","schemaVersion":1,"type":"deleteDecl","target":'
    '{"symbolId":"%s","addressId":"%s"},"params":{"file":"%s"},'
    '"guards":{},"effects":{"summary":"delete decl"},"provenance":')


def _kind_templates(prov_json: str) -> Tuple[str, str, str, str]:
    suffix = prov_json.replace("%", "%%") + "}"
    return (_TMPL_RENAME + suffix, _TMPL_MOVE + suffix,
            _TMPL_ADD + suffix, _TMPL_DELETE + suffix)


class OpStreamView(Sequence):
    """One side's op log as fetched columns; a lazy ``Sequence[Op]``.

    Rows are ``(kind, a_slot, b_slot, digest words)``, where the slots
    index the scanned decl node lists. Construction does no per-row
    work. ``field_cache`` is the engine's per-snapshot field-list cache
    (or ``None``); ``render`` a
    :class:`~semantic_merge_tpu_torch.ops.render.RenderedStream` the
    engine attaches when the device renders this stream's JSON."""

    __slots__ = ("kind", "a_slot", "b_slot", "words", "base_nodes",
                 "side_nodes", "prov", "field_cache", "render", "_ids",
                 "_ops", "_all_done")

    def __init__(self, kind: np.ndarray, a_slot: np.ndarray,
                 b_slot: np.ndarray, words: np.ndarray,
                 base_nodes, side_nodes, prov: Dict,
                 field_cache: Optional["OrderedDict"] = None) -> None:
        self.kind = kind
        self.a_slot = a_slot
        self.b_slot = b_slot
        self.words = words
        self.base_nodes = base_nodes
        self.side_nodes = side_nodes
        self.prov = prov
        self.field_cache = field_cache
        self.render = None
        self._ids: Optional[List[str]] = None
        self._ops: Optional[List[Optional[Op]]] = None
        self._all_done = False

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def base_fields(self) -> Tuple[list, list, list, list]:
        """The base snapshot's field columns ``(symbolId, addressId,
        name, file)``: the columnar applier reads op params through
        these instead of materializing ``Op`` objects."""
        return _get_fields(self.field_cache, self.base_nodes)

    def side_fields(self) -> Tuple[list, list, list, list]:
        """The side snapshot's field columns; see :meth:`base_fields`."""
        return _get_fields(self.field_cache, self.side_nodes)

    def ids(self) -> List[str]:
        if self._ids is None:
            self._ids = format_ids(self.words)
        return self._ids

    def _build_one(self, i: int) -> Op:
        k = int(self.kind[i])
        op_id = self.ids()[i]
        prov = self.prov
        if k == KIND_RENAME:
            a = self.base_nodes[int(self.a_slot[i])]
            b = self.side_nodes[int(self.b_slot[i])]
            return Op(op_id, 1, "renameSymbol", Target(a.symbolId, a.addressId),
                      {"oldName": a.name, "newName": b.name, "file": b.file},
                      {"exists": True, "addressMatch": a.addressId},
                      {"summary": f"rename {a.name}→{b.name}"}, prov)
        if k == KIND_MOVE:
            a = self.base_nodes[int(self.a_slot[i])]
            b = self.side_nodes[int(self.b_slot[i])]
            return Op(op_id, 1, "moveDecl", Target(a.symbolId, a.addressId),
                      {"oldAddress": a.addressId, "newAddress": b.addressId,
                       "oldFile": a.file, "newFile": b.file},
                      {"exists": True, "addressMatch": a.addressId},
                      {"summary": f"move {a.addressId}→{b.addressId}"}, prov)
        if k == KIND_ADD:
            b = self.side_nodes[int(self.b_slot[i])]
            return Op(op_id, 1, "addDecl", Target(b.symbolId, b.addressId),
                      {"file": b.file}, {}, {"summary": "add decl"}, prov)
        a = self.base_nodes[int(self.a_slot[i])]
        return Op(op_id, 1, "deleteDecl", Target(a.symbolId, a.addressId),
                  {"file": a.file}, {}, {"summary": "delete decl"}, prov)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self._ops is None:
            self._ops = [None] * n
        op = self._ops[i]
        if op is None:
            op = self._ops[i] = self._build_one(i)
        return op

    def materialize(self) -> List[Op]:
        """Every op as an object (ops already built are reused)."""
        if self._all_done:
            return self._ops  # type: ignore[return-value]
        if self._ops is None:
            self._ops = [None] * len(self)
        ops = self._ops
        for i in range(len(self)):
            if ops[i] is None:
                ops[i] = self._build_one(i)
        self._all_done = True
        return ops  # type: ignore[return-value]

    def __iter__(self):
        return iter(self.materialize())

    def to_json_bytes(self) -> bytes:
        """The canonical op-log JSON bytes, straight from the columns:
        the device-rendered payload when one is attached (a render that
        fails raises; it is never re-done on the host), else the
        vectorized serializer. Byte-identical to
        ``dumps_canonical([op.to_dict() for op in self])``."""
        if len(self) == 0:
            return b"[]"
        if self.render is not None:
            return self.render.json_bytes()
        return ("[" + ",".join(self._json_rows(0, len(self))) + "]").encode("utf-8")

    def _json_rows(self, lo: int, hi: int) -> List[str]:
        """Rows ``lo:hi`` as JSON object strings — the vectorized
        serializer: per-kind numpy row selection, field gathers from the
        cached per-node string lists, each string escaped at most once
        per call, one ``%`` format per row, rows scattered back into
        stream order."""
        ids = self.ids()
        kinds = self.kind[lo:hi]
        rows = np.empty(hi - lo, dtype=object)
        bsym, baddr, bname, bfile = self.base_fields()
        ssym, saddr, sname, sfile = self.side_fields()
        tmpl = _kind_templates(dumps_canonical(self.prov))
        cache: Dict[str, str] = {}
        cache_get = cache.get

        def body(s: str) -> str:
            r = cache_get(s)
            if r is None:
                r = cache[s] = _esc_body(s)
            return r

        for k in (KIND_RENAME, KIND_MOVE, KIND_ADD, KIND_DELETE):
            where = np.nonzero(kinds == k)[0]
            if not len(where):
                continue
            ai = self.a_slot[lo:hi][where].tolist()
            bi = self.b_slot[lo:hi][where].tolist()
            rid = [ids[lo + i] for i in where.tolist()]
            if k == KIND_RENAME:
                sym = [body(bsym[x]) for x in ai]
                ea = [body(baddr[x]) for x in ai]
                an = [body(bname[x]) for x in ai]
                bn = [body(sname[y]) for y in bi]
                fl = [body(sfile[y]) for y in bi]
                rows[where] = list(map(tmpl[0].__mod__, zip(
                    rid, sym, ea, an, bn, fl, ea, an, bn)))
            elif k == KIND_MOVE:
                sym = [body(bsym[x]) for x in ai]
                ea = [body(baddr[x]) for x in ai]
                eb = [body(saddr[y]) for y in bi]
                af = [body(bfile[x]) for x in ai]
                bf = [body(sfile[y]) for y in bi]
                rows[where] = list(map(tmpl[1].__mod__, zip(
                    rid, sym, ea, ea, eb, af, bf, ea, ea, eb)))
            elif k == KIND_ADD:
                sym = [body(ssym[y]) for y in bi]
                eb = [body(saddr[y]) for y in bi]
                fl = [body(sfile[y]) for y in bi]
                rows[where] = list(map(tmpl[2].__mod__, zip(rid, sym, eb, fl)))
            else:
                sym = [body(bsym[x]) for x in ai]
                ea = [body(baddr[x]) for x in ai]
                fl = [body(bfile[x]) for x in ai]
                rows[where] = list(map(tmpl[3].__mod__, zip(rid, sym, ea, fl)))
        return rows.tolist()


class ComposedOpView(Sequence):
    """The composed stream as references into the two side views plus
    per-row chain overrides — a lazy ``Sequence[Op]``.

    ``sides``/``idxs`` index raw stream positions; the chain-override
    strings (``None`` = no override) are decoded per row-range shard by
    a :class:`~semantic_merge_tpu_torch.ops.fused.TailPlan` (see
    :meth:`pipelined`), or given whole as ``addr_s``/``file_s``/
    ``name_s``. ``left``/``right`` are :class:`OpStreamView` columns on
    the fused path, but any indexable ``Sequence[Op]`` works; column
    consumers gate on :attr:`supports_columns`."""

    __slots__ = ("sides", "idxs", "addr_s", "file_s", "name_s",
                 "left", "right", "_all", "_plan")

    def __init__(self, sides, idxs,
                 addr_s: Optional[List[Optional[str]]],
                 file_s: Optional[List[Optional[str]]],
                 name_s: Optional[List[Optional[str]]],
                 left, right) -> None:
        self.sides = sides
        self.idxs = idxs
        self.addr_s = addr_s
        self.file_s = file_s
        self.name_s = name_s
        self.left = left
        self.right = right
        self._all: Optional[List[Op]] = None
        self._plan = None

    @classmethod
    def pipelined(cls, sides, idxs, plan, left, right) -> "ComposedOpView":
        """A view whose chain decode and op materialization run as
        row-range shards over the host-tail worker pool (``plan`` is a
        :class:`~semantic_merge_tpu_torch.ops.fused.TailPlan`); shard
        results join in shard order, so the output does not depend on
        the worker count."""
        view = cls(sides, idxs, None, None, None, left, right)
        view._plan = plan
        return view

    def _force_chains(self) -> None:
        if self.addr_s is None:
            self.addr_s, self.file_s, self.name_s = self._plan.decode_all()

    def __len__(self) -> int:
        return len(self.sides)

    @property
    def supports_columns(self) -> bool:
        """Whether both sources are columnar :class:`OpStreamView`
        streams — the gate for the columnar applier."""
        return (isinstance(self.left, OpStreamView)
                and isinstance(self.right, OpStreamView))

    def apply_shard_ranges(self) -> List[Tuple[int, int]]:
        """Contiguous ascending ``(lo, hi)`` row ranges for a shard-wise
        consumer: the tail plan's shards when the view is pipelined (so
        decodes already in the worker pool are consumed as they land),
        else one full range."""
        if self._plan is not None:
            return list(self._plan.ranges)
        n = len(self)
        return [(0, n)] if n else []

    def override_rows(self, lo: int, hi: int) -> Tuple[list, list, list]:
        """The decoded chain overrides ``(addr, file, name)`` of rows
        ``lo:hi`` (local indexing). On a pipelined view ``(lo, hi)`` must
        be one of :meth:`apply_shard_ranges`."""
        if self.addr_s is not None:
            return self.addr_s[lo:hi], self.file_s[lo:hi], self.name_s[lo:hi]
        return self._plan.shard_overrides(lo, hi)

    def row_slices(self, lo: int, hi: int) -> Tuple[object, object]:
        """``(sides, idxs)`` row slices for ``lo:hi``."""
        return self.sides[lo:hi], self.idxs[lo:hi]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self._all is not None:
            return self._all[i]
        self._force_chains()
        src = self.left if self.sides[i] == 0 else self.right
        return _materialize_decoded(src[int(self.idxs[i])], self.addr_s[i],
                                    self.file_s[i], self.name_s[i])

    def _shard_ops(self, lo: int, hi: int,
                   overrides: Tuple[list, list, list]) -> List[Op]:
        """Composed rows ``lo:hi`` as ops (one pipeline shard)."""
        addr_s, file_s, name_s = overrides
        streams = (self.left, self.right)
        return [_materialize_decoded(streams[side][i], na, nf, nn)
                for side, i, na, nf, nn in zip(
                    np.asarray(self.sides[lo:hi]).tolist(),
                    np.asarray(self.idxs[lo:hi]).tolist(), addr_s, file_s, name_s)]

    def materialize(self) -> List[Op]:
        if self._all is not None:
            return self._all
        plan = self._plan
        if plan is not None:
            futs = [plan.submit_materialize(lo, hi, self._shard_ops)
                    for lo, hi in plan.ranges]
            out: List[Op] = []
            for f in futs:
                out.extend(f.result())
        else:
            out = self._shard_ops(0, len(self), (self.addr_s, self.file_s, self.name_s))
        self._all = out
        return out

    def __iter__(self):
        return iter(self.materialize())

    def to_json_bytes(self) -> bytes:
        """The composed op log as canonical JSON bytes, identical to
        ``dumps_canonical([op.to_dict() for op in self])``. When both
        source streams carry a device render, the rendered row bytes are
        spliced in composed order and only rows with chain overrides are
        re-serialized on the host."""
        if len(self) == 0:
            return b"[]"
        if self.supports_columns:
            raw = self._rendered_bytes()
            if raw is not None:
                return raw
        return dumps_canonical([op.to_dict() for op in self.materialize()]).encode("utf-8")

    def _rendered_bytes(self) -> Optional[bytes]:
        lh, rh = self.left.render, self.right.render
        if lh is None or rh is None:
            return None
        rows = (lh.row_bytes(), rh.row_bytes())
        kinds = (self.left.kind, self.right.kind)
        streams = (self.left, self.right)
        self._force_chains()
        parts: List[bytes] = []
        for i, (side, idx) in enumerate(zip(np.asarray(self.sides).tolist(),
                                            np.asarray(self.idxs).tolist())):
            na, nf, nn = self.addr_s[i], self.file_s[i], self.name_s[i]
            if na is None and nf is None and (
                    nn is None or int(kinds[side][idx]) == KIND_RENAME):
                parts.append(rows[side][idx])
            else:
                op = _materialize_decoded(streams[side][idx], na, nf, nn)
                parts.append(dumps_canonical(op.to_dict()).encode("utf-8"))
        return b"[" + b",".join(parts) + b"]"


def _materialize_decoded(op: Op, new_addr: Optional[str],
                         new_file: Optional[str],
                         rename_ctx: Optional[str]) -> Op:
    """Apply a row's decoded chain overrides to its stream op
    (observable output identical to the host composer's deep clone). A
    row without overrides passes the stream op through unchanged:
    composed ops are treated as immutable downstream."""
    if new_addr is None and new_file is None and (
            rename_ctx is None or op.type == "renameSymbol"):
        return op
    cloned = Op(id=op.id, schemaVersion=op.schemaVersion, type=op.type,
                target=op.target, params=dict(op.params),
                guards=op.guards, effects=op.effects,
                provenance=op.provenance)
    if new_addr is not None or new_file is not None:
        if cloned.type == "moveDecl":
            if new_addr is not None:
                cloned.params["newAddress"] = new_addr
            if new_file is not None:
                cloned.params["newFile"] = new_file
        if new_addr is not None:
            cloned.target = Target(symbolId=cloned.target.symbolId,
                                   addressId=new_addr)
        if cloned.type == "renameSymbol" and new_file is not None:
            cloned.params["newFile"] = new_file
            cloned.params["file"] = new_file
    if rename_ctx is not None and cloned.type != "renameSymbol":
        cloned.params["renameContext"] = rename_ctx
    return cloned


def cursor_walk_conflicts_columnar(
        key_a: Sequence[int], ren_a: Sequence[bool], sym_a: Sequence[int],
        name_a: Sequence[int],
        key_b: Sequence[int], ren_b: Sequence[bool], sym_b: Sequence[int],
        name_b: Sequence[int]) -> Tuple[List[Tuple[int, int]], Set[int], Set[int]]:
    """The reference's head-vs-head DivergentRename walk on int rows of
    the two canonically sorted streams.

    ``key_*`` is the cross-stream comparison key, ordered as
    ``(precedence, timestamp)``; type, symbol and newName come as ints:
    the interner is injective, so int equality IS string equality. Runs
    of takes against a non-rename head cannot conflict and advance by
    bisection. Returns ``(pairs, dropped_a, dropped_b)``: the
    ``(ia, ib)`` sorted-stream positions of each conflict in the walk's
    emission order, and the positions each side drops."""
    pairs: List[Tuple[int, int]] = []
    dropped_a: Set[int] = set()
    dropped_b: Set[int] = set()
    na, nb = len(key_a), len(key_b)
    ia = ib = 0
    while ia < na or ib < nb:
        if ib >= nb or not ren_b[ib]:
            if ia >= na:
                ib = nb
            elif ib >= nb:
                ia = na
            else:
                nxt = bisect_right(key_a, key_b[ib], ia, na)
                if nxt == ia:
                    ib += 1
                else:
                    ia = nxt
            continue
        if ia >= na or not ren_a[ia]:
            if ia >= na:
                ib = nb
            else:
                nxt = bisect_left(key_b, key_a[ia], ib, nb)
                if nxt == ib:
                    ia += 1
                else:
                    ib = nxt
            continue
        take_a = key_a[ia] <= key_b[ib]
        if sym_a[ia] == sym_b[ib] and name_a[ia] != name_b[ib]:
            pairs.append((ia, ib))
            dropped_a.add(ia)
            dropped_b.add(ib)
            ia += 1
            ib += 1
            continue
        if take_a:
            ia += 1
        else:
            ib += 1
    return pairs, dropped_a, dropped_b


def cursor_walk_conflicts_renames_only(
        ren_pos_a: np.ndarray, sym_a: np.ndarray, name_a: np.ndarray,
        ren_pos_b: np.ndarray, sym_b: np.ndarray, name_b: np.ndarray,
        prec_rename: int = 11) -> Tuple[List[Tuple[int, int]], Set[int], Set[int]]:
    """The cursor walk restricted to each stream's RENAME substream.

    For canonically sorted streams over the fused path's four kinds
    (move=10 < rename=11 < add=30 < delete=31, one shared timestamp) the
    full walk can only emit conflicts at rename-vs-rename head pairs,
    and its bisect advances never let a non-rename reorder which rename
    pairs meet — so walking the rename substreams yields the full walk's
    pairs at a cost proportional to the rename count. ``ren_pos_*`` are
    the rename rows' positions in the sorted streams; the pairs and drop
    sets come back as full-stream positions."""
    k_a, k_b = len(ren_pos_a), len(ren_pos_b)
    sub_pairs, sub_da, sub_db = cursor_walk_conflicts_columnar(
        [prec_rename] * k_a, [True] * k_a, sym_a.tolist(), name_a.tolist(),
        [prec_rename] * k_b, [True] * k_b, sym_b.tolist(), name_b.tolist())
    pairs = [(int(ren_pos_a[x]), int(ren_pos_b[y])) for x, y in sub_pairs]
    return (pairs, {int(ren_pos_a[x]) for x in sub_da},
            {int(ren_pos_b[y]) for y in sub_db})
