"""Strict conflict detection — the [CFR-002] categories.

The reference *requires* six conflict categories (reference
``requirements.md:93-99`` [CFR-002]) but implements exactly one,
DivergentRename, and only when the two renames surface simultaneously
at both compose cursors (reference ``semmerge/compose.py:60-70`` —
interleaved ops can mask it). This module implements the categories
expressible over the implemented op vocabulary as a full symbol-level
join, immune to interleaving:

- **DivergentRename** — both sides rename one symbol to different names.
- **DivergentMove** — both sides move one symbol to different addresses.
- **IncompatibleSignatureChange** — both sides change one symbol's
  signature differently (requires ``changeSignature`` extraction).
- **DeleteVsEdit** — one side deletes a declaration the other side
  renames / moves / re-signs / body-edits.
- **ConcurrentStmtEdit** — both sides edited one declaration's body
  to different results (requires ``editStmtBlock`` extraction —
  ``core.difflift.statement_edits``, enabled automatically in strict
  mode).
- **ExtractVsInline** — one side extracted a statement block into a
  new declaration while the other inlined a declaration with that same
  block (requires ``extractMethod``/``inlineMethod`` extraction —
  ``core.difflift.body_motions``, enabled automatically in strict
  mode). Joined on ``blockHash``, the content identity of the moved
  statements. All six [CFR-002] categories are now implemented; the
  reference names this one (reference ``requirements.md:98``) but its
  worker has no extractor. The same pass applies [RES-004]: both sides
  extracting the same block with identical bodies deduplicate to one
  declaration (A's kept) instead of conflicting.

Semantics: conflicting ops drop from both streams (the reference's
DivergentRename drop semantics, generalized), the pre-pass runs before
composition, and the composer then finds no residual head-vs-head
conflicts. Selected via ``[engine] conflict_mode = "strict"`` or
``--strict-conflicts``; the default ``"parity"`` keeps the reference's
observable behavior bit-for-bit.

The port's copy of the JAX package's ``core/strict_conflicts.py``:
host Python there as here. The residual streams then compose on the
device (:mod:`semantic_merge_tpu_torch.ops.compose`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .conflict import (Conflict, concurrent_stmt_edit_conflict,
                       delete_vs_edit_conflict, divergent_rename_conflict,
                       extract_vs_inline_conflict)
from .ops import Op

_EDIT_TYPES = ("renameSymbol", "moveDecl", "changeSignature",
               "editStmtBlock")


def detect_conflicts_strict(delta_a: List[Op], delta_b: List[Op],
                            ) -> Tuple[List[Op], List[Op], List[Conflict]]:
    """Full-stream conflict join; returns the two streams with
    conflicting ops dropped plus the conflict records (stable order:
    by first involved A-op's stream position; detection-order ties keep
    emission order). Every conflict records which A-stream op it
    involves at emission time, and the final list sorts on that
    position — so the documented ordering holds even though the
    motion pass runs before the per-symbol loops."""
    by_sym_a = _group(delta_a)
    by_sym_b = _group(delta_b)

    drop_a: set = set()
    drop_b: set = set()
    # (A-op stream position, conflict) pairs; sorted (stably) at the
    # end so the motion-pass-first detection schedule does not leak
    # into the output order.
    pos_a = {id(op): i for i, op in enumerate(delta_a)}
    keyed: List[Tuple[int, Conflict]] = []

    def emit(a_op: Op, conflict: Conflict) -> None:
        keyed.append((pos_a.get(id(a_op), len(delta_a)), conflict))

    # Body-motion pass first (cross-symbol join on blockHash): an
    # ExtractVsInline conflict consumes the motion's companion
    # editStmtBlock/addDecl/deleteDecl ops too, so the per-symbol
    # loops below must not re-report the same disagreement as
    # ConcurrentStmtEdit or DeleteVsEdit. Consumption is tracked apart
    # from the plain drop sets: ops dropped *within* a later loop keep
    # their established pairing behavior.
    consumed_a: set = set()
    consumed_b: set = set()
    _motion_pass(delta_a, delta_b, consumed_a, consumed_b, emit)
    drop_a |= consumed_a
    drop_b |= consumed_b

    for sym, ops_a in by_sym_a.items():
        ops_b = by_sym_b.get(sym)
        if not ops_b:
            continue

        ren_a = [op for op in ops_a if op.type == "renameSymbol"]
        ren_b = [op for op in ops_b if op.type == "renameSymbol"]
        for op_a in ren_a:
            for op_b in ren_b:
                if op_a.params.get("newName") != op_b.params.get("newName"):
                    emit(op_a, divergent_rename_conflict(op_a, op_b))
                    drop_a.add(id(op_a))
                    drop_b.add(id(op_b))

        mov_a = [op for op in ops_a if op.type == "moveDecl"]
        mov_b = [op for op in ops_b if op.type == "moveDecl"]
        for op_a in mov_a:
            for op_b in mov_b:
                if op_a.params.get("newAddress") != op_b.params.get("newAddress"):
                    emit(op_a, divergent_move_conflict(op_a, op_b))
                    drop_a.add(id(op_a))
                    drop_b.add(id(op_b))

        sig_a = [op for op in ops_a if op.type == "changeSignature"]
        sig_b = [op for op in ops_b if op.type == "changeSignature"]
        for op_a in sig_a:
            for op_b in sig_b:
                if op_a.params.get("newSignature") != op_b.params.get("newSignature"):
                    emit(op_a, incompatible_signature_conflict(op_a, op_b))
                    drop_a.add(id(op_a))
                    drop_b.add(id(op_b))

        stm_a = [op for op in ops_a if op.type == "editStmtBlock"]
        stm_b = [op for op in ops_b if op.type == "editStmtBlock"]
        for op_a in stm_a:
            for op_b in stm_b:
                # Skip only when the motion pass consumed BOTH sides —
                # that pair IS the disagreement the motion conflict
                # reported. One-sided consumption means the other
                # side's differing edit is its own disagreement.
                if id(op_a) in consumed_a and id(op_b) in consumed_b:
                    continue
                # Same decl (same address), bodies edited to different
                # results; identical edits agree and pass through.
                if (op_a.target.addressId == op_b.target.addressId
                        and op_a.params.get("newBodyHash")
                        != op_b.params.get("newBodyHash")):
                    emit(op_a, concurrent_stmt_edit_conflict(op_a, op_b))
                    drop_a.add(id(op_a))
                    drop_b.add(id(op_b))

        del_a = [op for op in ops_a if op.type == "deleteDecl"]
        del_b = [op for op in ops_b if op.type == "deleteDecl"]
        edit_a = [op for op in ops_a if op.type in _EDIT_TYPES]
        edit_b = [op for op in ops_b if op.type in _EDIT_TYPES]
        for op_del in del_a:
            for op_edit in edit_b:
                if id(op_del) in consumed_a and id(op_edit) in consumed_b:
                    continue
                emit(op_del, delete_vs_edit_conflict(op_del, op_edit, "A"))
                drop_a.add(id(op_del))
                drop_b.add(id(op_edit))
        for op_del in del_b:
            for op_edit in edit_a:
                if id(op_del) in consumed_b and id(op_edit) in consumed_a:
                    continue
                emit(op_edit, delete_vs_edit_conflict(op_del, op_edit, "B"))
                drop_b.add(id(op_del))
                drop_a.add(id(op_edit))

    kept_a = [op for op in delta_a if id(op) not in drop_a]
    kept_b = [op for op in delta_b if id(op) not in drop_b]
    keyed.sort(key=lambda t: t[0])  # stable: ties keep emission order
    return kept_a, kept_b, [c for _, c in keyed]


def _motion_pass(delta_a: List[Op], delta_b: List[Op],
                 consumed_a: set, consumed_b: set,
                 emit) -> None:
    """ExtractVsInline detection plus the [RES-004] extract dedup.

    Both rules join ``extractMethod``/``inlineMethod`` markers on
    ``blockHash`` (the content identity of the moved statements), so
    the pass is a cross-symbol join and runs before the per-symbol
    loops. A firing rule consumes the marker AND its companion
    text-level ops — the ``editStmtBlock`` on the source/host decl and
    the ``addDecl``/``deleteDecl`` of the moved declaration — so the
    disagreement surfaces exactly once, as the motion-level category."""
    def motions(stream, kind):
        return [op for op in stream if op.type == kind]

    def companions(stream, motion):
        out = [motion]
        if motion.type == "extractMethod":
            addr, decl_t = motion.params.get("newAddress"), "addDecl"
        else:
            addr, decl_t = motion.params.get("oldAddress"), "deleteDecl"
        for op in stream:
            # The motion op copied its Target verbatim from the source
            # edit, so match on BOTH ids: structural symbolIds collide
            # for same-shaped decls, and symbolId alone would swallow
            # an unrelated decl's body edit.
            if (op.type == "editStmtBlock"
                    and op.target.symbolId == motion.target.symbolId
                    and op.target.addressId == motion.target.addressId):
                out.append(op)
            elif op.type == decl_t and op.target.addressId == addr:
                out.append(op)
        return out

    # ExtractVsInline: opposite motions of the same block across sides.
    pairs = ([(e, i, "A") for e in motions(delta_a, "extractMethod")
              for i in motions(delta_b, "inlineMethod")]
             + [(e, i, "B") for e in motions(delta_b, "extractMethod")
                for i in motions(delta_a, "inlineMethod")])
    for ext, inl, side in pairs:
        if (id(ext) in (consumed_a if side == "A" else consumed_b)
                or id(inl) in (consumed_b if side == "A" else consumed_a)):
            continue
        if (not ext.params.get("blockHash")
                or ext.params.get("blockHash") != inl.params.get("blockHash")):
            continue
        # The A-stream op of the pair keys the output ordering: the
        # extract marker when A extracted ("A" side), else A's inline.
        emit(ext if side == "A" else inl,
             extract_vs_inline_conflict(ext, inl, side))
        ext_stream, ext_set = ((delta_a, consumed_a) if side == "A"
                               else (delta_b, consumed_b))
        inl_stream, inl_set = ((delta_b, consumed_b) if side == "A"
                               else (delta_a, consumed_a))
        for op in companions(ext_stream, ext):
            ext_set.add(id(op))
        for op in companions(inl_stream, inl):
            inl_set.add(id(op))

    # [RES-004]: both sides extracted the same block with identical
    # bodies (blockHash equality IS body identity — the detector only
    # fires on verbatim block membership) from the same source decl
    # INTO the same name — keep A's new declaration, drop B's
    # duplicate. Differently-named extracts are not duplicates (the
    # residual bodies call different helpers; dropping B's declaration
    # would orphan its callsite), and different bodies hash
    # differently — both keep both declarations, per the rule.
    for ea in motions(delta_a, "extractMethod"):
        if id(ea) in consumed_a:
            continue
        for eb in motions(delta_b, "extractMethod"):
            if id(eb) in consumed_b:
                continue
            if (ea.params.get("blockHash")
                    and ea.params.get("blockHash") == eb.params.get("blockHash")
                    and ea.target.symbolId == eb.target.symbolId
                    # addressId too: structural symbolIds collide for
                    # same-shaped decls, and "same source decl" must
                    # mean the same base declaration, not a shape twin.
                    and ea.target.addressId == eb.target.addressId
                    and ea.params.get("newName") == eb.params.get("newName")):
                consumed_b.add(id(eb))
                addr = eb.params.get("newAddress")
                for op in delta_b:
                    if op.type == "addDecl" and op.target.addressId == addr:
                        consumed_b.add(id(op))


def _group(ops: List[Op]) -> Dict[str, List[Op]]:
    groups: Dict[str, List[Op]] = {}
    for op in ops:
        groups.setdefault(op.target.symbolId, []).append(op)
    return groups


def divergent_move_conflict(op_a: Op, op_b: Op) -> Conflict:
    """Both sides moved the same symbol to different destinations
    ([CFR-002] "Move to different destinations")."""
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="DivergentMove",
        symbolId=op_a.target.symbolId,
        addressIds={"A": op_a.params.get("newAddress"),
                    "B": op_b.params.get("newAddress"),
                    "base": op_a.params.get("oldAddress")},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": "", "start": 0, "end": 0, "code": ""},
        suggestions=[
            {"id": "keepA", "label": f"Move to {op_a.params.get('newAddress')}",
             "ops": [op_a.id]},
            {"id": "keepB", "label": f"Move to {op_b.params.get('newAddress')}",
             "ops": [op_b.id]},
        ],
    )


def incompatible_signature_conflict(op_a: Op, op_b: Op) -> Conflict:
    """Both sides changed the same symbol's signature incompatibly
    ([CFR-002] "Incompatible signature changes")."""
    return Conflict(
        id=f"conf-{op_a.id[:8]}-{op_b.id[:8]}",
        category="IncompatibleSignatureChange",
        symbolId=op_a.target.symbolId,
        addressIds={"A": op_a.target.addressId, "B": op_b.target.addressId,
                    "base": None},
        opA=op_a.to_dict(),
        opB=op_b.to_dict(),
        minimalSlice={"path": "", "start": 0, "end": 0, "code": ""},
        suggestions=[
            {"id": "keepA", "label": f"Signature {op_a.params.get('newSignature')}",
             "ops": [op_a.id]},
            {"id": "keepB", "label": f"Signature {op_b.params.get('newSignature')}",
             "ops": [op_b.id]},
        ],
    )
