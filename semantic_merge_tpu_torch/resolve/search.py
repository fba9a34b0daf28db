"""Deterministic search-based baseline resolver (the port's copy of the
JAX package's ``resolve/search.py``).

Per conflict category, enumerate candidate op-stream rewrites from the
conflict's ``opA``/``opB`` and score them on evidence found in the three
tree snapshots:

- **DivergentRename** — prefer the rename whose side carries a
  reference rewrite: the winning new name is the one actually *used*
  beyond its declaration. Symmetric bare renames score equal → tie →
  fallback.
- **DeleteVsEdit** — keep the delete when the deleting side also removed
  the symbol's references; keep the edit when the editing side added
  new usages.
- **ConcurrentStmtEdit** — line-level 3-way on the statement slice.
  Disjoint edits merge into one body; overlapping edits yield no
  candidate.
- **ExtractVsInline** — keep the motion whose side shows the stronger
  reference evidence; the losing motion's companion ops drop with it,
  as ``core.strict_conflicts`` consumes them.

Scores are small integers from whole-word reference counts.
Categories without a strategy (``DivergentMove``,
``IncompatibleSignatureChange``) propose nothing and fall back.
"""
from __future__ import annotations

import difflib
import re
from typing import Dict, List, Optional, Tuple

from ..core.ids import stable_hash_hex
from .base import Candidate, ResolveContext, Resolver


def _refs(name: str, file_map: Dict[str, bytes]) -> int:
    """Whole-word occurrences of ``name`` across a snapshot's decodable
    files. Identifier boundaries are the TS identifier alphabet, so
    ``foo`` does not count inside ``fooBar`` or ``my_foo``."""
    if not name:
        return 0
    pat = re.compile(r"(?<![A-Za-z0-9_$])" + re.escape(name)
                     + r"(?![A-Za-z0-9_$])")
    total = 0
    for data in file_map.values():
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            continue
        total += len(pat.findall(text))
    return total


def _addr_symbol(address_id: Optional[str]) -> str:
    """The symbol *name* embedded in a ``path::name::n`` address id."""
    parts = (address_id or "").split("::")
    return parts[1] if len(parts) >= 2 else ""


class SearchResolver(Resolver):
    """The deterministic baseline. ``propose`` dispatches on the
    conflict's ``category``; every branch is a pure function of the
    record and the snapshots."""

    name = "search"

    def propose(self, conflict: dict, ctx: ResolveContext) -> List[Candidate]:
        handler = {
            "DivergentRename": self._divergent_rename,
            "DeleteVsEdit": self._delete_vs_edit,
            "ConcurrentStmtEdit": self._concurrent_stmt_edit,
            "ExtractVsInline": self._extract_vs_inline,
        }.get(str(conflict.get("category", "")))
        if handler is None:
            return []
        return handler(conflict, ctx)

    def _divergent_rename(self, conflict: dict,
                          ctx: ResolveContext) -> List[Candidate]:
        op_a, op_b = conflict.get("opA", {}), conflict.get("opB", {})
        name_a = str(op_a.get("params", {}).get("newName") or "")
        name_b = str(op_b.get("params", {}).get("newName") or "")
        out = []
        for keep, drop, name, side in (("keepA", op_b, name_a, "A"),
                                       ("keepB", op_a, name_b, "B")):
            drop_id = str(drop.get("id") or "")
            if not drop_id or not name:
                continue
            refs = _refs(name, ctx.side_map(side))
            out.append(Candidate(
                id=keep, label=f"Rename to {name}",
                rationale=f"{refs} whole-word "
                          f"references to {name!r} on side {side} — the "
                          "rewritten references are the winning rename's "
                          "evidence",
                drops=(drop_id,),
                score=refs))
        return out

    def _delete_vs_edit(self, conflict: dict,
                        ctx: ResolveContext) -> List[Candidate]:
        op_a, op_b = conflict.get("opA", {}), conflict.get("opB", {})
        if op_a.get("type") == "deleteDecl":
            op_del, op_edit = op_a, op_b
        elif op_b.get("type") == "deleteDecl":
            op_del, op_edit = op_b, op_a
        else:
            return []
        del_id = str(op_del.get("id") or "")
        edit_id = str(op_edit.get("id") or "")
        if not del_id or not edit_id:
            return []
        name = _addr_symbol(op_del.get("target", {}).get("addressId"))
        del_side = ctx.side_of(del_id)
        edit_side = ctx.side_of(edit_id)
        if del_side is None or edit_side is None:
            return []
        base_refs = _refs(name, ctx.tree_map("base"))
        del_refs = _refs(name, ctx.side_map(del_side))
        edit_refs = _refs(name, ctx.side_map(edit_side))
        # Cleanup evidence: references removed beyond the declaration
        # itself (the -1). Usage evidence: references the edit added.
        keep_delete = max(0, base_refs - del_refs - 1)
        keep_edit = max(0, edit_refs - base_refs)
        return [
            Candidate(
                id="keepDelete", label="Keep the deletion",
                rationale=f"deleting side removed {keep_delete} "
                          f"reference(s) to {name!r} beyond the "
                          "declaration — apply-edit-then-delete ordering",
                drops=(edit_id,), score=keep_delete),
            Candidate(
                id="keepEdit", label="Keep the edit",
                rationale=f"editing side added {keep_edit} new "
                          f"reference(s) to {name!r} — the symbol grew "
                          "more load-bearing",
                drops=(del_id,), score=keep_edit),
        ]

    def _concurrent_stmt_edit(self, conflict: dict,
                              ctx: ResolveContext) -> List[Candidate]:
        op_a, op_b = conflict.get("opA", {}), conflict.get("opB", {})
        id_a, id_b = str(op_a.get("id") or ""), str(op_b.get("id") or "")
        live_a = ctx.op(id_a)
        if live_a is None or not id_b:
            return []
        old = str(op_a.get("params", {}).get("oldBody") or "")
        new_a = str(op_a.get("params", {}).get("newBody") or "")
        new_b = str(op_b.get("params", {}).get("newBody") or "")
        merged = merge3_lines(old, new_a, new_b)
        if merged is None:
            return []
        rep = live_a.clone()
        rep.params["newBody"] = merged
        rep.params["newBodyHash"] = stable_hash_hex(merged, n_hex=16)
        return [Candidate(
            id="merged3way", label="Merge both body edits",
            rationale="the two body edits touch disjoint statement "
                      "lines — token-level 3-way on the minimal slice "
                      "composes them",
            drops=(id_b,), replaces={id_a: rep}, score=1)]

    def _extract_vs_inline(self, conflict: dict,
                           ctx: ResolveContext) -> List[Candidate]:
        op_a, op_b = conflict.get("opA", {}), conflict.get("opB", {})
        if op_a.get("type") == "extractMethod":
            op_ext, op_inl = op_a, op_b
        elif op_b.get("type") == "extractMethod":
            op_ext, op_inl = op_b, op_a
        else:
            return []
        ext_id, inl_id = str(op_ext.get("id") or ""), str(op_inl.get("id") or "")
        ext_side, inl_side = ctx.side_of(ext_id), ctx.side_of(inl_id)
        if ext_side is None or inl_side is None:
            return []
        new_name = str(op_ext.get("params", {}).get("newName") or "")
        method = str(op_inl.get("params", {}).get("methodName") or "")
        # Keeping one motion drops the other motion AND its companion
        # ops — the body edit on the host decl and the add/delete of the
        # moved declaration — the set strict detection consumes.
        ext_drops = _companion_ids(ctx, ext_id, ext_side)
        inl_drops = _companion_ids(ctx, inl_id, inl_side)
        base_refs = _refs(method, ctx.tree_map("base"))
        inl_refs = _refs(method, ctx.side_map(inl_side))
        ext_refs = _refs(new_name, ctx.side_map(ext_side))
        return [
            Candidate(
                id="keepExtract", label=f"Keep the extracted {new_name}",
                rationale=f"{ext_refs} "
                          f"reference(s) to the extracted {new_name!r} "
                          "on the extracting side",
                drops=inl_drops,
                score=ext_refs),
            Candidate(
                id="keepInline", label=f"Keep {method} inlined",
                rationale=f"inlining side removed "
                          f"{max(0, base_refs - inl_refs - 1)} call "
                          f"site(s) of {method!r}",
                drops=ext_drops,
                score=max(0, base_refs - inl_refs - 1)),
        ]


def _companion_ids(ctx: ResolveContext, motion_id: str,
                   side: str) -> Tuple[str, ...]:
    """The motion op's id plus its companions' ids in its own stream —
    the mirror of ``core.strict_conflicts``'s ``companions`` rule."""
    motion = ctx.op(motion_id)
    if motion is None:
        return (motion_id,)
    if motion.type == "extractMethod":
        addr, decl_t = motion.params.get("newAddress"), "addDecl"
    else:
        addr, decl_t = motion.params.get("oldAddress"), "deleteDecl"
    out = [motion_id]
    for op in ctx.side_log(side):
        if (op.type == "editStmtBlock"
                and op.target.symbolId == motion.target.symbolId
                and op.target.addressId == motion.target.addressId):
            out.append(op.id)
        elif op.type == decl_t and op.target.addressId == addr:
            out.append(op.id)
    return tuple(out)


def merge3_lines(base: str, a: str, b: str) -> Optional[str]:
    """Line-level 3-way merge of one statement body; ``None`` when the
    two sides' edits overlap (including both inserting different text
    at the same point — ordering would be a guess)."""
    base_lines = base.splitlines(keepends=True)
    edits: List[Tuple[int, int, List[str], str]] = []
    for side, text in (("A", a), ("B", b)):
        lines = text.splitlines(keepends=True)
        sm = difflib.SequenceMatcher(a=base_lines, b=lines, autojunk=False)
        for tag, lo, hi, blo, bhi in sm.get_opcodes():
            if tag != "equal":
                edits.append((lo, hi, lines[blo:bhi], side))
    for i, (lo_a, hi_a, rep_a, s_a) in enumerate(edits):
        for lo_b, hi_b, rep_b, s_b in edits[i + 1:]:
            if s_a == s_b:
                continue
            if (lo_a, hi_a, rep_a) == (lo_b, hi_b, rep_b):
                continue  # both sides made the identical edit
            if max(lo_a, lo_b) < min(hi_a, hi_b):
                return None
            if lo_a == hi_a == lo_b == hi_b and rep_a != rep_b:
                return None
    # Deduplicate identical edits (both sides made the same change),
    # then splice sorted-by-position into the base.
    uniq: List[Tuple[int, int, Tuple[str, ...]]] = []
    for lo, hi, rep, _ in edits:
        key = (lo, hi, tuple(rep))
        if key not in uniq:
            uniq.append(key)
    uniq.sort()
    out: List[str] = []
    cursor = 0
    for lo, hi, rep in uniq:
        out.extend(base_lines[cursor:lo])
        out.extend(rep)
        cursor = hi
    out.extend(base_lines[cursor:])
    return "".join(out)
