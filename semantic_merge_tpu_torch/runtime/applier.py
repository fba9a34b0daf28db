"""Materialize composed ops onto a tree (reference ``semmerge/applier.py``).

The port of the JAX package's ``runtime/applier.py``: applies a composed
op stream to a copy of the base tree. Implemented handlers (the
reference's set): ``moveDecl`` moves the *whole file* old→new;
``renameSymbol`` rewrites word-boundary occurrences across the file;
``modifyImport`` is a literal replace; ``moveFile`` moves by old/new
path. Everything else is logged and skipped (reference
``semmerge/applier.py:30-31``). Additionally ``reorderImports`` is
applied via the RGA CRDT ordering
(:mod:`semantic_merge_tpu_torch.core.crdt`, resolved on the host), and
``editStmtBlock`` splices a body edit. Ops carrying structured decl
payloads (``effects["decl"]``) splice spans and append decls.

Two dispatch paths, one contract:

- **Columnar** (the fused engine's output): a
  :class:`~semantic_merge_tpu_torch.ops.oplog_view.ComposedOpView`
  backed by op-stream columns is consumed directly — dispatch on the
  int kind column, params read through the cached per-snapshot field
  lists, chain-file overrides applied where ``_materialize_decoded``
  would put them. No ``Op`` materializes; the walk goes shard by shard
  over the view's tail plan.
- **Object** (the two-program path, and the parity oracle behind
  ``SEMMERGE_OBJECT_APPLY=1``): the per-op handler loop.

Both call the same file-edit primitives, so the trees are identical.
"""
from __future__ import annotations

import logging
import os
import pathlib
import re
import shutil
import tempfile
from typing import Iterable, Set

import numpy as np

from ..core.ops import Op

logger = logging.getLogger(__name__)


def apply_ops(base_tree: pathlib.Path, ops: Iterable[Op]) -> pathlib.Path:
    """Apply composed ops to a copy of ``base_tree``; returns the copy
    (a new temporary directory the caller removes). A column-backed
    composed view takes the columnar loop, anything else (and anything
    under ``SEMMERGE_OBJECT_APPLY=1``) the object loop."""
    view = _columnar_view(ops)
    if view is not None and not _object_apply_forced():
        return _apply_columnar(pathlib.Path(base_tree), view)
    return _apply_objects(pathlib.Path(base_tree), list(ops))


def _object_apply_forced() -> bool:
    """``SEMMERGE_OBJECT_APPLY=1`` keeps the object applier as the
    parity oracle: composed views then materialize their ``Op``s."""
    return os.environ.get("SEMMERGE_OBJECT_APPLY", "").strip() == "1"


def _columnar_view(ops):
    """``ops`` as a column-backed ComposedOpView, or ``None``."""
    from ..ops.oplog_view import ComposedOpView
    if isinstance(ops, ComposedOpView) and ops.supports_columns:
        return ops
    return None


# --------------------------------------------------------------------------
# Columnar dispatch
# --------------------------------------------------------------------------

#: OP_PRECEDENCE of the four diff kinds, indexed by KIND_* code (rename,
#: move, add, delete): the composed stream's order.
_PREC_OF_KIND = np.asarray([11, 10, 30, 31], dtype=np.int32)


def iter_columnar_actions(view):
    """Per-shard apply actions straight off a composed view's columns.

    Yields, per tail-plan shard, a list of action groups:
    ``("move", old_files, new_files)`` or ``("rename", files, old_names,
    new_names)`` — parallel lists, overrides applied and invalid rows
    filtered. Rows with no tree effect (``addDecl`` without decl text,
    ``deleteDecl``, rows missing a required param) are absent.

    The chain-file override lands where ``_materialize_decoded`` puts
    it: the ``file`` param of a RENAME row. On a MOVE row it is a proven
    no-op (the inclusive chain scan makes a live move's chain file its
    own ``newFile``) and is skipped; the addr/name overrides touch
    fields the applier never reads.

    Assembly is bulk per kind, relying on the composed stream's
    canonical order: within a shard every moveDecl precedes every
    renameSymbol, so moves-then-renames IS row order. Each shard checks
    that order; a shard that breaks it is assembled row by row (a
    ``("rows", actions)`` group)."""
    from ..ops.oplog_view import KIND_MOVE, KIND_RENAME
    left, right = view.left, view.right
    b_name, b_file = left.base_fields()[2:4]
    l_name, l_file = left.side_fields()[2:4]
    r_name, r_file = right.side_fields()[2:4]
    kL, kR = left.kind, right.kind

    def merged(col_l, col_r, is_l, rows):
        """Per-row gather from a per-stream int column pair, clamped so
        the other side's (never selected) lane stays in bounds."""
        li = col_l[np.minimum(rows, max(col_l.shape[0] - 1, 0))] if col_l.shape[0] else rows
        ri = col_r[np.minimum(rows, max(col_r.shape[0] - 1, 0))] if col_r.shape[0] else rows
        return np.where(is_l, li, ri)

    def gather_side(fields_l, fields_r, is_l, slot):
        out = np.empty(len(slot), dtype=object)
        wl, wr = np.nonzero(is_l)[0], np.nonzero(~is_l)[0]
        if len(wl):
            out[wl] = list(map(fields_l.__getitem__, slot[wl].tolist()))
        if len(wr):
            out[wr] = list(map(fields_r.__getitem__, slot[wr].tolist()))
        return out

    def with_override(vals, file_o, rows) -> list:
        ov = list(map(file_o.__getitem__, rows.tolist()))
        if any(o is not None for o in ov):
            return [v if o is None else o for o, v in zip(ov, vals)]
        return vals

    for lo, hi in view.apply_shard_ranges():
        sides, idxs = view.row_slices(lo, hi)
        _, file_o, _ = view.override_rows(lo, hi)
        sides = np.asarray(sides, dtype=np.int32)
        idxs = np.asarray(idxs, dtype=np.int32)
        is_l = sides == 0
        kind_row = merged(kL, kR, is_l, idxs)
        prec = _PREC_OF_KIND[kind_row]
        if hi - lo > 1 and not bool((prec[1:] >= prec[:-1]).all()):
            yield [("rows", _row_order_actions(view, kind_row, is_l, idxs, file_o))]
            continue
        groups: list = []
        mv = np.nonzero(kind_row == KIND_MOVE)[0]
        if len(mv):
            is_l_k = is_l[mv]
            a_row = merged(left.a_slot, right.a_slot, is_l_k, idxs[mv])
            b_row = merged(left.b_slot, right.b_slot, is_l_k, idxs[mv])
            # Move params are decl file fields, never empty: the object
            # handler's falsy-param skip cannot fire here.
            groups.append(("move", list(map(b_file.__getitem__, a_row.tolist())),
                           gather_side(l_file, r_file, is_l_k, b_row)))
        ren = np.nonzero(kind_row == KIND_RENAME)[0]
        if len(ren):
            is_l_k = is_l[ren]
            a_row = merged(left.a_slot, right.a_slot, is_l_k, idxs[ren])
            b_row = merged(left.b_slot, right.b_slot, is_l_k, idxs[ren])
            olds = list(map(b_name.__getitem__, a_row.tolist()))
            news = gather_side(l_name, r_name, is_l_k, b_row)
            files = with_override(gather_side(l_file, r_file, is_l_k, b_row), file_o, ren)
            kept = [(f, o, nw) for f, o, nw in zip(files, olds, news) if f and o and nw]
            groups.append(("rename", [f for f, _, _ in kept], [o for _, o, _ in kept],
                           [nw for _, _, nw in kept]))
        yield groups


def _row_order_actions(view, kind_row, is_l, idxs, file_o) -> list:
    """Exact row-order assembly for a shard that is not precedence
    sorted (no producer emits one; this keeps the bulk path honest)."""
    from ..ops.oplog_view import KIND_MOVE, KIND_RENAME
    left, right = view.left, view.right
    b_name, b_file = left.base_fields()[2:4]
    cols = ((left.a_slot, left.b_slot) + left.side_fields()[2:4],
            (right.a_slot, right.b_slot) + right.side_fields()[2:4])
    acts: list = []
    for w, (k, s, i) in enumerate(zip(kind_row.tolist(), is_l.tolist(), idxs.tolist())):
        a_c, b_c, s_name, s_file = cols[0 if s else 1]
        if k == KIND_RENAME:
            f = file_o[w] if file_o[w] is not None else s_file[int(b_c[i])]
            old, new = b_name[int(a_c[i])], s_name[int(b_c[i])]
            if f and old and new:
                acts.append(("rename", f, old, new))
        elif k == KIND_MOVE:
            nf = file_o[w] if file_o[w] is not None else s_file[int(b_c[i])]
            of = b_file[int(a_c[i])]
            if of and nf:
                acts.append(("move", of, nf))
    return acts


def _apply_columnar(base_tree: pathlib.Path, view) -> pathlib.Path:
    out = pathlib.Path(tempfile.mkdtemp(prefix="semmerge_merged_"))
    shutil.copytree(base_tree, out, dirs_exist_ok=True)
    for groups in iter_columnar_actions(view):
        for g in groups:
            if g[0] == "rename":
                for f, old, new in zip(g[1], g[2], g[3]):
                    _rename_symbol_in_file(out, f, old, new)
            elif g[0] == "move":
                for old, new in zip(g[1], g[2]):
                    _move_decl_path(out, old, new)
            else:  # ("rows", [...]): the exact row-order assembly
                for act in g[1]:
                    if act[0] == "rename":
                        _rename_symbol_in_file(out, *act[1:])
                    else:
                        _move_decl_path(out, *act[1:])
    return out


# --------------------------------------------------------------------------
# Object dispatch (the oracle)
# --------------------------------------------------------------------------

def _apply_objects(base_tree: pathlib.Path, ops: list) -> pathlib.Path:
    out = pathlib.Path(tempfile.mkdtemp(prefix="semmerge_merged_"))
    shutil.copytree(base_tree, out, dirs_exist_ok=True)
    resolved_orders = _resolve_reorder_orders(ops)

    # Structured-apply span edits (delete/changeSignature carrying
    # effects["decl"] payloads) run FIRST: their spans are base-content
    # offsets, so they must land before moves/renames rewrite paths and
    # text. Per file, descending start order keeps earlier spans valid.
    span_ops = [op for op in ops
                if op.type in ("deleteDecl", "changeSignature")
                and isinstance(op.effects.get("decl"), dict)
                and "start" in op.effects["decl"]]
    _apply_span_edits(out, span_ops)
    structured = set(map(id, span_ops))

    add_ops = []
    for op in ops:
        if id(op) in structured:
            continue
        if (op.type == "addDecl"
                and isinstance(op.effects.get("decl"), dict)
                and "text" in op.effects["decl"]):
            add_ops.append(op)  # appends run after path-shaping ops
            continue
        if op.type == "reorderImports":
            _apply_reorder_imports(out, op, resolved_orders.get(id(op)))
            continue
        handler = _HANDLERS.get(op.type)
        if handler is None:
            logger.debug("No applier hook for op %s", op.type)
            continue
        handler(out, op)
    for op in add_ops:
        _apply_add_decl(out, op)
    return out


def touched_paths(ops: Iterable[Op]) -> Set[str]:
    """Normalized tree-relative paths of every file the composed stream
    can write — the ``[engine] formatter_scope = "touched"`` scope (the
    path-bearing params: ``file``/``oldFile``/``newFile``/``oldPath``/
    ``newPath``). A columnar view computes the set from its columns;
    the object comprehension is the oracle."""
    view = _columnar_view(ops)
    if view is not None and not _object_apply_forced():
        return _touched_paths_columnar(view)
    return {str(_normalize_relpath(v))
            for op in ops
            for k in ("file", "oldFile", "newFile", "oldPath", "newPath")
            if isinstance((v := op.params.get(k)), str) and v}


def _touched_paths_columnar(view) -> Set[str]:
    from ..ops.oplog_view import KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME
    left, right = view.left, view.right
    b_file = left.base_fields()[3]
    sources = ((left.kind, left.a_slot, left.b_slot, left.side_fields()[3]),
               (right.kind, right.a_slot, right.b_slot, right.side_fields()[3]))
    raw: Set[str] = set()
    for lo, hi in view.apply_shard_ranges():
        sides, idxs = view.row_slices(lo, hi)
        _, file_o, _ = view.override_rows(lo, hi)
        sides = np.asarray(sides, dtype=np.int32)
        idxs = np.asarray(idxs, dtype=np.int32)
        for s, (kind_c, a_c, b_c, s_file) in enumerate(sources):
            on_side = np.nonzero(sides == s)[0]
            if not len(on_side):
                continue
            kind = kind_c[idxs[on_side]]
            # Rename `file` / move `newFile`: the side file, with the
            # chain-file override where _materialize_decoded puts it.
            ren_mv = on_side[(kind == KIND_RENAME) | (kind == KIND_MOVE)]
            for w, y in zip(ren_mv.tolist(), b_c[idxs[ren_mv]].tolist()):
                f = file_o[w] if file_o[w] is not None else s_file[y]
                if f:
                    raw.add(f)
            # Add `file`: the raw side file.
            for y in b_c[idxs[on_side[kind == KIND_ADD]]].tolist():
                if s_file[y]:
                    raw.add(s_file[y])
            # Move `oldFile` / delete `file`: the base file.
            base_rows = on_side[(kind == KIND_MOVE) | (kind == KIND_DELETE)]
            for x in a_c[idxs[base_rows]].tolist():
                if b_file[x]:
                    raw.add(b_file[x])
    return {str(_normalize_relpath(p)) for p in raw}


def _apply_span_edits(root: pathlib.Path, span_ops) -> None:
    by_file: dict = {}
    for op in span_ops:
        file_path = op.params.get("file")
        if file_path:
            by_file.setdefault(str(file_path), []).append(op)
    for file_path, file_ops in by_file.items():
        path = root / _normalize_relpath(file_path)
        if not path.exists():
            logger.debug("span-edit target missing: %s", path)
            continue
        code = path.read_text(encoding="utf-8")
        for op in sorted(file_ops,
                         key=lambda o: -int(o.effects["decl"]["start"])):
            decl = op.effects["decl"]
            start = max(0, int(decl["start"]))
            end = min(len(code), int(decl["end"]))
            if start > end:
                continue
            replacement = str(decl.get("text", ""))
            code = code[:start] + replacement + code[end:]
        path.write_text(code, encoding="utf-8")


def _apply_add_decl(root: pathlib.Path, op: Op) -> None:
    file_path = op.params.get("file")
    text = op.effects.get("decl", {}).get("text")
    if not file_path or text is None:
        return
    path = root / _normalize_relpath(file_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    existing = path.read_text(encoding="utf-8") if path.exists() else ""
    if existing and not existing.endswith("\n"):
        existing += "\n"
    snippet = str(text)
    if not snippet.endswith("\n"):
        snippet += "\n"
    path.write_text(existing + snippet.lstrip("\n"), encoding="utf-8")


def _apply_move_decl(root: pathlib.Path, op: Op) -> None:
    old_file = op.params.get("oldFile") or op.params.get("file")
    new_file = op.params.get("newFile") or op.params.get("file")
    if not old_file or not new_file:
        return
    _move_decl_path(root, old_file, new_file)


def _move_decl_path(root: pathlib.Path, old_file, new_file) -> None:
    """The moveDecl edit primitive, shared by both dispatch paths."""
    src = root / _normalize_relpath(old_file)
    dst = root / _normalize_relpath(new_file)
    if src == dst:
        return
    if not src.exists():
        logger.debug("moveDecl source missing: %s", src)
        return
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(src, dst)


def _apply_move_file(root: pathlib.Path, op: Op) -> None:
    old_path = op.params.get("oldPath")
    new_path = op.params.get("newPath")
    if not old_path or not new_path:
        return
    src = root / _normalize_relpath(old_path)
    dst = root / _normalize_relpath(new_path)
    if not src.exists():
        logger.debug("moveFile source missing: %s", src)
        return
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(src, dst)


def _apply_rename_symbol(root: pathlib.Path, op: Op) -> None:
    file_path = op.params.get("file") or op.params.get("newFile")
    old_name = op.params.get("oldName")
    new_name = op.params.get("newName")
    if not file_path or not old_name or not new_name:
        return
    _rename_symbol_in_file(root, file_path, str(old_name), str(new_name))


def _rename_symbol_in_file(root: pathlib.Path, file_path, old_name: str,
                           new_name: str) -> None:
    """The renameSymbol edit primitive, shared by both dispatch paths."""
    path = root / _normalize_relpath(file_path)
    if not path.exists():
        logger.debug("renameSymbol target missing: %s", path)
        return
    code = path.read_text(encoding="utf-8")
    code = re.sub(rf"\b{re.escape(old_name)}\b", new_name, code)
    path.write_text(code, encoding="utf-8")


def _apply_edit_stmt_block(root: pathlib.Path, op: Op) -> None:
    """Splice an ``editStmtBlock``'s new body over its old one: a single
    exact replacement, position-independent. A missing old body (the
    other side rewrote the decl some other way) is a logged skip."""
    file_path = op.params.get("file")
    old_body = op.params.get("oldBody")
    new_body = op.params.get("newBody")
    if not file_path or old_body is None or new_body is None:
        return
    path = root / _normalize_relpath(file_path)
    if not path.exists():
        logger.debug("editStmtBlock target missing: %s", path)
        return
    code = path.read_text(encoding="utf-8")
    if str(old_body) not in code:
        logger.debug("editStmtBlock old body not found in %s; skipping", path)
        return
    path.write_text(code.replace(str(old_body), str(new_body), 1),
                    encoding="utf-8")


def _apply_modify_import(root: pathlib.Path, op: Op) -> None:
    file_path = op.params.get("file")
    old_import = op.params.get("oldImport")
    new_import = op.params.get("newImport")
    if not file_path or old_import is None or new_import is None:
        return
    path = root / _normalize_relpath(file_path)
    if not path.exists():
        logger.debug("modifyImport target missing: %s", path)
        return
    code = path.read_text(encoding="utf-8")
    path.write_text(code.replace(str(old_import), str(new_import)), encoding="utf-8")


def _build_rga(order):
    from ..core.crdt import RGA, Key
    rga = RGA()
    for entry in order:
        rga.insert(Key(str(entry.get("anchor", "")), int(entry.get("t", 0)),
                       str(entry.get("author", "")), str(entry.get("opid", ""))),
                   str(entry.get("value", "")))
    return rga


def _resolve_reorder_orders(ops) -> dict:
    """Every reorderImports op's RGA ordering, resolved up front."""
    return {id(op): list(_build_rga(op.params["order"]).materialize())
            for op in ops
            if op.type == "reorderImports" and op.params.get("order")}


def _apply_reorder_imports(root: pathlib.Path, op: Op, ordered=None) -> None:
    """Reorder a file's leading import block per the op's CRDT keys.

    The op's ``params["order"]`` is a list of ``{value, anchor, t,
    author, opid}`` records; ordering is resolved by the RGA CRDT
    (specified at reference ``requirements.md:71-75`` [CRD-001..004] and
    ``architecture.md:173-178`` but left dead in the reference)."""
    file_path = op.params.get("file")
    order = op.params.get("order")
    if not file_path or not order:
        return
    path = root / _normalize_relpath(file_path)
    if not path.exists():
        return
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    import_idx = [i for i, ln in enumerate(lines) if ln.lstrip().startswith("import ")]
    if not import_idx:
        return
    if ordered is None:  # direct handler call outside apply_ops
        ordered = list(_build_rga(order).materialize())
    by_text = {lines[i].strip(): i for i in import_idx}
    new_imports = [lines[by_text[v]] for v in ordered if v in by_text]
    remaining = [lines[i] for i in import_idx if lines[i].strip() not in set(ordered)]
    block = new_imports + remaining
    first = import_idx[0]
    kept = [ln for i, ln in enumerate(lines) if i not in set(import_idx)]
    kept[first:first] = block
    path.write_text("".join(kept), encoding="utf-8")


def _normalize_relpath(value: str) -> pathlib.Path:
    """Normalize an op-supplied path to a tree-relative path.

    Strips absolute anchors (reference ``semmerge/applier.py:97-104``)
    and rejects ``..`` traversal segments — op logs can arrive from
    fetched git notes, so a hostile note must not be able to address
    files outside the merge tree.
    """
    path = pathlib.Path(value)
    if path.is_absolute():
        try:
            path = path.relative_to(path.anchor)
        except ValueError:
            path = pathlib.Path(path.name)
    parts = [p for p in path.parts if p not in ("..", ".")]
    return pathlib.Path(*parts) if parts else pathlib.Path(path.name)


_HANDLERS = {
    "moveDecl": _apply_move_decl,
    "moveFile": _apply_move_file,
    "renameSymbol": _apply_rename_symbol,
    "modifyImport": _apply_modify_import,
    "reorderImports": _apply_reorder_imports,
    "editStmtBlock": _apply_edit_stmt_block,
}
