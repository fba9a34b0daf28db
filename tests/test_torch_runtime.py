"""The port's merge runtime layers against the JAX package's.

- Applier: the same op list through JAX's object applier and the port's
  ``apply_ops``, on copies of one base tree, for every handler
  (moveDecl, moveFile, renameSymbol, modifyImport, reorderImports with
  its RGA ordering, editStmtBlock, structured span edits and addDecl,
  hostile paths): the resulting trees must be byte-identical, and so
  must ``touched_paths``.
- Text layer: ``apply_text_fallback`` on the same archives (one-sided
  edits, adds, deletes, clean and conflicting both-sided edits, binary
  files): the same conflicts, deletions, writes and tree.
- In-place commit: ``commit_tree_inplace`` and ``recover`` after an
  interrupted commit (stage only, or journal written) leave the same
  tree as the JAX package's.
"""
import io
import pathlib
import shutil
import tarfile

import pytest

from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.core.ops import Target as JaxTarget
from semantic_merge_tpu.runtime import inplace as jax_inplace
from semantic_merge_tpu.runtime.applier import apply_ops as jax_apply_ops
from semantic_merge_tpu.runtime.applier import touched_paths as jax_touched_paths
from semantic_merge_tpu.runtime.textmerge import apply_text_fallback as jax_text_fallback
from semantic_merge_tpu_torch.core.ops import Op
from semantic_merge_tpu_torch.frontend.snapshot import TS_EXTENSIONS
from semantic_merge_tpu_torch.runtime import inplace
from semantic_merge_tpu_torch.runtime.applier import apply_ops, touched_paths
from semantic_merge_tpu_torch.runtime.textmerge import apply_text_fallback


def _write(root, files):
    for path, data in files.items():
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).write_bytes(data if isinstance(data, bytes) else data.encode())


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


def mk(op_type, sym, params=None, effects=None):
    return JaxOp.new(op_type, JaxTarget(symbolId=sym, addressId=None), params=params or {},
                     effects=effects or {}, op_id=f"{sym:0>32}")


_IMPORTS = ('import { a } from "./a";\nimport { b } from "./b";\nimport { c } from "./c";\n'
            "export function foo(): number {\n  return 1;\n}\n")
BASE_TREE = {
    "src/util.ts": "export function foo(n: number): number {\n  return foo(n);\n}\n",
    "src/imports.ts": _IMPORTS,
    "src/body.ts": "export function g(): number {\n  return 1;\n}\n",
    "src/span.ts": "export function dead(): void {}\nexport function live(): void {}\n",
    "docs/old.md": "moved whole\n",
}
_ORDER = [{"value": 'import { c } from "./c";', "anchor": "", "t": 1, "author": "A", "opid": "1"},
          {"value": 'import { a } from "./a";', "anchor": "", "t": 2, "author": "A", "opid": "2"},
          {"value": 'import { b } from "./b";', "anchor": "", "t": 2, "author": "B", "opid": "3"}]

APPLY_CASES = {
    "move_then_rename_in_moved_file": [
        mk("moveDecl", "1", {"oldFile": "src/util.ts", "newFile": "lib/util.ts"}),
        mk("renameSymbol", "2", {"oldName": "foo", "newName": "bar", "file": "lib/util.ts"})],
    "move_source_missing_and_same_file": [
        mk("moveDecl", "1", {"oldFile": "src/none.ts", "newFile": "lib/none.ts"}),
        mk("moveDecl", "2", {"file": "src/util.ts"})],
    "move_file_and_modify_import": [
        mk("moveFile", "1", {"oldPath": "docs/old.md", "newPath": "docs/new/old.md"}),
        mk("modifyImport", "2", {"file": "src/imports.ts", "oldImport": './b"',
                                 "newImport": './bb"'})],
    "reorder_imports_by_rga": [
        mk("reorderImports", "1", {"file": "src/imports.ts", "order": _ORDER})],
    "edit_stmt_block": [
        mk("editStmtBlock", "1", {"file": "src/body.ts", "oldBody": "return 1;",
                                  "newBody": "return 2;"}),
        mk("editStmtBlock", "2", {"file": "src/body.ts", "oldBody": "absent",
                                  "newBody": "never"})],
    "structured_span_edits_and_adds": [
        mk("deleteDecl", "1", {"file": "src/span.ts"}, {"decl": {"start": 0, "end": 31}}),
        mk("addDecl", "2", {"file": "src/span.ts"}, {"decl": {"text": "export const k = 1;"}}),
        mk("addDecl", "3", {"file": "src/fresh.ts"}, {"decl": {"text": "\nlet z = 0"}})],
    "hostile_paths_stay_inside": [
        mk("renameSymbol", "1", {"oldName": "foo", "newName": "qux",
                                 "file": "/../../src/util.ts"}),
        mk("moveDecl", "2", {"oldFile": "../src/body.ts", "newFile": "/abs/../body.ts"})],
    "unknown_and_unhandled_types": [
        mk("changeSignature", "1", {"file": "src/util.ts"}), mk("futureOp", "2", {})],
}


#: Cases whose ops leave the tree as it was (skips, by design).
NO_OP_CASES = {"move_source_missing_and_same_file", "unknown_and_unhandled_types"}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_applier_matches_jax(tmp_path, case):
    ops = APPLY_CASES[case]
    base = tmp_path / "base"
    _write(base, BASE_TREE)
    want = jax_apply_ops(base, list(ops))
    got = apply_ops(base, [Op.from_dict(o.to_dict()) for o in ops])
    try:
        assert _tree(got) == _tree(want)
        assert (_tree(got) == _tree(base)) == (case in NO_OP_CASES)
    finally:
        shutil.rmtree(got)
        shutil.rmtree(want)
    assert touched_paths([Op.from_dict(o.to_dict()) for o in ops]) == jax_touched_paths(ops)


def _tar(files):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for path, data in sorted(files.items()):
            data = data if isinstance(data, bytes) else data.encode()
            info = tarfile.TarInfo(path)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


_LINES = "".join(f"line {i}\n" for i in range(10))
TEXT_BASE = {"README.md": _LINES, "same.txt": "s\n", "gone.txt": "g\n", "src/a.ts": "let a;\n",
             "blob.bin": b"\x00\x01", "clash.md": _LINES, "del_vs_edit.txt": "d\n"}
TEXT_A = {**TEXT_BASE, "README.md": _LINES.replace("line 1\n", "LINE 1\n"),
          "gone.txt": None, "added.css": "a {}\n", "blob.bin": b"\x00\x02",
          "clash.md": _LINES.replace("line 5", "A5"), "del_vs_edit.txt": None,
          "src/new.ts": "let n;\n"}
TEXT_B = {**TEXT_BASE, "README.md": _LINES.replace("line 8\n", "LINE 8\n"),
          "both.json": "{}\n", "blob.bin": b"\x00\x03",
          "clash.md": _LINES.replace("line 5", "B5"), "del_vs_edit.txt": "edited\n"}


@pytest.mark.parametrize("indexed", [frozenset(TS_EXTENSIONS), None], ids=["ts", "default"])
def test_text_layer_matches_jax(tmp_path, indexed):
    trees = [{k: v for k, v in t.items() if v is not None} for t in (TEXT_BASE, TEXT_A, TEXT_B)]
    tars = [_tar(t) for t in trees]
    results = []
    for name, fn in (("jax", jax_text_fallback), ("port", apply_text_fallback)):
        merged = tmp_path / name
        _write(merged, {k: v for k, v in trees[0].items() if not k.endswith(".ts")})
        conflicts, deleted, written = fn(merged, *tars, indexed_extensions=indexed)
        results.append(([c.to_dict() for c in conflicts], deleted, written, _tree(merged)))
    assert results[1] == results[0]
    conflicts = results[1][0]
    assert sorted(c["minimalSlice"]["path"] for c in conflicts) == [
        "blob.bin", "clash.md", "del_vs_edit.txt"]


@pytest.mark.parametrize("interrupted", ["none", "stage_only", "journal_written"])
def test_inplace_commit_and_recovery_match_jax(tmp_path, interrupted):
    merged = tmp_path / "merged"
    _write(merged, {"src/a.ts": "new a\n", "lib/b.ts": "b\n"})
    trees = []
    for name, mod in (("jax", jax_inplace), ("port", inplace)):
        root = tmp_path / name
        _write(root, {"src/a.ts": "old a\n", "gone.txt": "x\n", "keep.txt": "k\n"})
        if interrupted == "none":
            with mod.repo_lock(root):
                mod.commit_tree_inplace(merged, deletes=["gone.txt"], root=root)
            action = ("none", 0)
        else:
            stage = root / mod.STAGE_DIR
            _write(stage, _tree(merged))
            if interrupted == "journal_written":
                mod._write_journal(root, {"schema": 1, "state": "committing",
                                          "writes": sorted(_tree(merged)),
                                          "deletes": ["gone.txt"]})
                (root / "src/a.ts").write_text("new a\n")  # one write already done
                (stage / "src/a.ts").unlink()
            with mod.repo_lock(root):
                action = mod.recover(root)
        assert not (root / mod.LOCKFILE).exists()
        trees.append((action, _tree(root)))
    assert trees[1] == trees[0]
    action, tree = trees[1]
    assert action[0] == {"none": "none", "stage_only": "rolled-back",
                         "journal_written": "rolled-forward"}[interrupted]
    assert ("lib/b.ts" in tree) == (interrupted != "stage_only")


@pytest.mark.parametrize("age_s,content", [(60.0, ""), (60.0, "garbage"), (0.0, "")],
                         ids=["empty-old", "unreadable-old", "empty-fresh"])
def test_repo_lock_reclaims_a_lock_its_dead_writer_left_without_a_pid(tmp_path, age_s, content):
    """A writer SIGKILLed between creating the lock and writing its pid
    leaves a lock without one. Past ``EMPTY_LOCK_SECONDS`` the port
    reclaims it (the JAX package would wait for the hour-old cutoff); a
    fresh one may belong to a live writer about to write, so it holds."""
    import os
    import time

    lock = tmp_path / inplace.LOCKFILE
    lock.write_text(content)
    stamp = time.time() - age_s
    os.utime(lock, (stamp, stamp))
    if age_s > inplace.EMPTY_LOCK_SECONDS:
        with inplace.repo_lock(tmp_path, timeout=5.0):
            assert lock.read_text().split()[0] == str(os.getpid())
        assert not lock.exists()
    else:
        from semantic_merge_tpu_torch.errors import ApplyFault
        with pytest.raises(ApplyFault):
            with inplace.repo_lock(tmp_path, timeout=0.2):
                pass
        assert lock.read_text() == content
