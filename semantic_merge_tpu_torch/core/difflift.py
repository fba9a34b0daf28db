"""Diff records, changeSignature refinement and op lifting.

A copy of the JAX package's ``core/difflift.py`` (the slice's part of
it: the join itself runs on the device, :mod:`semantic_merge_tpu_torch.ops.diff`).
Together with the device join it reproduces the reference worker's
diff/lift stage exactly
(reference ``workers/ts/src/diff.ts:5-31`` and
``workers/ts/src/lift.ts:11-66``), with the nondeterministic identity
fields (uuid4 ids, wall-clock timestamps) replaced by the seeded scheme
from :mod:`semantic_merge_tpu_torch.core.ids`.

Diff semantics (parity-critical quirks included):

- Both node lists collapse into symbolId-keyed maps with JS ``Map``
  semantics: iteration follows *first* insertion order, but a duplicate
  symbolId keeps the *last* node (coarse signatures like ``class{2}``
  collide by design; reference ``implementation.md:1309`` acknowledges
  last-wins).
- Per base symbol, in map order: absent on the side → ``delete``;
  differing addressId → ``move``; differing non-null names → ``rename``
  (a symbol can emit both move and rename).
- Per side *list* entry (not map — duplicates emit repeatedly): symbolId
  absent in base → ``add``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..frontend.scanner import DeclNode
from .ids import EPOCH_ISO, deterministic_op_id
from .ops import Op, Target


@dataclass
class Diff:
    kind: str  # "rename" | "move" | "add" | "delete" | "changeSig"
    a: DeclNode | None = None
    b: DeclNode | None = None


def refine_signature_changes(diffs: List[Diff], sources=None,
                             matcher=None) -> List[Diff]:
    """Fold residual ``delete``+``add`` pairs into ``changeSig`` diffs.

    Editing a function's parameter or return types changes its
    structural symbolId, so the exact-key join reports the decl as
    deleted-and-re-added; the ``changeSig`` diff kind exists so such
    edits can merge as one signature change instead. This pass produces
    it: a deleted base decl and an added side decl that share
    ``(file, name, kind)`` (names non-null) are the same declaration
    with a changed signature.

    With ``matcher`` (an
    :class:`semantic_merge_tpu_torch.models.signature.EmbeddingSignatureMatcher`)
    and ``sources`` (a :func:`source_maps` pair), a second pass scores
    the *residual* deletes/adds — declarations that were renamed AND
    retyped, which no key can pair — by embedding similarity.

    Deterministic pairing: the k-th delete with a given key pairs with
    the k-th add with that key; model pairs break ties by score then
    stream position. The ``changeSig`` takes the delete's position in
    the stream; the paired add is dropped (later op ids re-index, which
    is why this pass must run identically in every backend — it is
    opt-in precisely because parity-with-reference mode must keep the
    delete+add shape).
    """
    # Pass 1: pair each eligible delete (stream order) with the next
    # unconsumed eligible add sharing its key.
    pending_adds: Dict[tuple, List[int]] = {}
    for idx, d in enumerate(diffs):
        if d.kind == "add" and d.b is not None and d.b.name:
            pending_adds.setdefault((d.b.file, d.b.name, d.b.kind), []).append(idx)
    paired: Dict[int, int] = {}  # delete idx -> add idx
    consumed: set = set()
    for idx, d in enumerate(diffs):
        if d.kind == "delete" and d.a is not None and d.a.name:
            queue = pending_adds.get((d.a.file, d.a.name, d.a.kind))
            if queue:
                add_idx = queue.pop(0)
                paired[idx] = add_idx
                consumed.add(add_idx)

    # Pass 1b: model-scored pairing of the residuals.
    if matcher is not None and sources is not None:
        base_map, side_map = sources
        # Candidates are keyed by (kind, file): a changeSignature op's
        # structured-apply spans are base offsets in the delete's file,
        # so a cross-file pair could never materialize correctly — a
        # decl moved AND retyped stays delete+add.
        res_del: List[int] = []
        del_items: List[tuple] = []
        for idx, d in enumerate(diffs):
            if (d.kind == "delete" and idx not in paired
                    and d.a is not None and d.a.name):
                src = base_map.get(d.a.file)
                if src is not None:
                    res_del.append(idx)
                    del_items.append(((d.a.kind, d.a.file),
                                      src[d.a.pos:d.a.end]))
        res_add: List[int] = []
        add_items: List[tuple] = []
        for idx, d in enumerate(diffs):
            if (d.kind == "add" and idx not in consumed
                    and d.b is not None and d.b.name):
                src = side_map.get(d.b.file)
                if src is not None:
                    res_add.append(idx)
                    add_items.append(((d.b.kind, d.b.file),
                                      src[d.b.pos:d.b.end]))
        for di, aj in matcher.pair(del_items, add_items):
            paired[res_del[di]] = res_add[aj]
            consumed.add(res_add[aj])

    # Pass 2: rebuild the stream.
    out: List[Diff] = []
    for idx, d in enumerate(diffs):
        if idx in paired:
            out.append(Diff("changeSig", a=d.a, b=diffs[paired[idx]].b))
        elif idx not in consumed:
            out.append(d)
    return out


def source_maps(base_files, side_files) -> tuple:
    """(base, side) path→content maps for structured-apply payloads."""
    from ..frontend.scanner import normalize_path
    return ({normalize_path(f["path"]): f["content"] for f in base_files},
            {normalize_path(f["path"]): f["content"] for f in side_files})


def _decl_payload(d: Diff, sources) -> Dict | None:
    """Structured-apply payload for an op's ``effects``.

    Spans are *base-content* offsets (``pos`` is the decl's full start,
    ``end`` its last token), texts are side-content slices — exactly
    what the applier needs to splice without re-parsing. This is the
    designed-but-unbuilt worker ``applyOps`` stage (reference
    ``implementation.md:1258,1339``), opt-in because it extends the
    reference's op JSON shape.
    """
    if sources is None:
        return None
    base_map, side_map = sources
    if d.kind == "add" and d.b is not None:
        src = side_map.get(d.b.file)
        if src is not None:
            return {"text": src[d.b.pos:d.b.end]}
    elif d.kind == "delete" and d.a is not None:
        return {"start": d.a.pos, "end": d.a.end}
    elif d.kind == "changeSig" and d.a is not None and d.b is not None:
        src = side_map.get(d.b.file)
        if src is not None:
            return {"start": d.a.pos, "end": d.a.end,
                    "text": src[d.b.pos:d.b.end]}
    return None


def lift(base_rev: str, diffs: List[Diff], *, seed: str = "0",
         timestamp: str = EPOCH_ISO, sources=None) -> List[Op]:
    """Diff records → Op records.

    Op ids are deterministic: a function of the seed, the diff content,
    and the diff's position in the stream — the same inputs yield
    bit-identical op logs from any backend. With ``sources`` (a
    :func:`source_maps` pair), add/delete/changeSig ops carry
    structured-apply payloads in ``effects["decl"]``.
    """
    ops: List[Op] = []
    for idx, d in enumerate(diffs):
        prov = {"rev": base_rev, "timestamp": timestamp}
        payload = _decl_payload(d, sources)
        if d.kind == "rename" and d.a and d.b:
            ops.append(Op.new(
                "renameSymbol",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={"oldName": d.a.name, "newName": d.b.name, "file": d.b.file},
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects={"summary": f"rename {d.a.name}→{d.b.name}"},
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "renameSymbol", d),
            ))
        elif d.kind == "move" and d.a and d.b:
            ops.append(Op.new(
                "moveDecl",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={
                    "oldAddress": d.a.addressId,
                    "newAddress": d.b.addressId,
                    "oldFile": d.a.file,
                    "newFile": d.b.file,
                },
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects={"summary": f"move {d.a.addressId}→{d.b.addressId}"},
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "moveDecl", d),
            ))
        elif d.kind == "changeSig" and d.a and d.b:
            effects = {"summary":
                       f"changeSignature {d.a.name}: {d.a.signature}→{d.b.signature}"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "changeSignature",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={
                    "name": d.a.name,
                    "file": d.b.file,
                    "oldSignature": d.a.signature,
                    "newSignature": d.b.signature,
                    "oldAddress": d.a.addressId,
                    "newAddress": d.b.addressId,
                    "newSymbolId": d.b.symbolId,
                },
                guards={"exists": True, "addressMatch": d.a.addressId},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "changeSignature", d),
            ))
        elif d.kind == "add" and d.b:
            effects = {"summary": "add decl"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "addDecl",
                Target(symbolId=d.b.symbolId, addressId=d.b.addressId),
                params={"file": d.b.file},
                guards={},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "addDecl", d),
            ))
        elif d.kind == "delete" and d.a:
            effects = {"summary": "delete decl"}
            if payload is not None:
                effects["decl"] = payload
            ops.append(Op.new(
                "deleteDecl",
                Target(symbolId=d.a.symbolId, addressId=d.a.addressId),
                params={"file": d.a.file},
                guards={},
                effects=effects,
                provenance=prov,
                op_id=_op_id(seed, base_rev, idx, "deleteDecl", d),
            ))
    return ops


def _op_id(seed: str, rev: str, idx: int, op_type: str, d: Diff) -> str:
    a_addr = d.a.addressId if d.a else ""
    b_addr = d.b.addressId if d.b else ""
    sym = (d.a or d.b).symbolId  # type: ignore[union-attr]
    return deterministic_op_id(seed, rev, idx, op_type, sym, a_addr, b_addr)
