"""Materialize composed ops onto a tree (reference ``semmerge/applier.py``).

The port's copy of the object path of the JAX package's
``runtime/applier.py``: applies a composed op stream to a copy of the
base tree, one handler per op. Implemented handlers (the reference's
set): ``moveDecl`` moves the *whole file* old→new; ``renameSymbol``
rewrites word-boundary occurrences across the file; ``modifyImport`` is
a literal replace; ``moveFile`` moves by old/new path. Everything else
is logged and skipped (reference ``semmerge/applier.py:30-31``).
Additionally ``reorderImports`` is applied via the RGA CRDT ordering
(:mod:`semantic_merge_tpu_torch.core.crdt`, resolved on the host), and
``editStmtBlock`` splices a body edit. Ops carrying structured decl
payloads (``effects["decl"]``) splice spans and append decls.

The JAX package's columnar dispatch, which reads the fused engine's
op-stream columns, gives byte-identical trees; it comes with the fused
engine.
"""
from __future__ import annotations

import logging
import pathlib
import re
import shutil
import tempfile
from typing import Iterable, Set

from ..core.ops import Op

logger = logging.getLogger(__name__)


def apply_ops(base_tree: pathlib.Path, ops: Iterable[Op]) -> pathlib.Path:
    """Apply composed ops to a copy of ``base_tree``; returns the copy
    (a new temporary directory the caller removes)."""
    ops = list(ops)
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
    ``newPath``)."""
    return {str(_normalize_relpath(v))
            for op in ops
            for k in ("file", "oldFile", "newFile", "oldPath", "newPath")
            if isinstance((v := op.params.get(k)), str) and v}


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
    path = root / _normalize_relpath(file_path)
    if not path.exists():
        logger.debug("renameSymbol target missing: %s", path)
        return
    code = path.read_text(encoding="utf-8")
    code = re.sub(rf"\b{re.escape(str(old_name))}\b", str(new_name), code)
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
