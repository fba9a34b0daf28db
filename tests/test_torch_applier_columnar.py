"""The port's columnar applier against its object applier and JAX's.

The fused merge hands its composed stream to the applier as a
column-backed ``ComposedOpView``; ``runtime/applier.py`` then applies it
straight from the columns (``iter_columnar_actions``). On the CPU, for
the same three snapshots: the tree the columnar path writes equals the
tree of the object path (forced by ``SEMMERGE_OBJECT_APPLY=1``, the
parity oracle) and the tree of the JAX package's applier on the JAX
fused merge, byte for byte; ``touched_paths`` gives the same set on all
three; the notes payloads (``OpLog(...).to_json_bytes()``) equal the
JAX package's. Shard sizes and worker counts vary, so the shard-wise
walk and the pool are covered too.
"""
from __future__ import annotations

import pathlib
import shutil

import pytest

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.core.ops import OpLog as JaxOpLog
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.runtime.applier import apply_ops as jax_apply_ops
from semantic_merge_tpu.runtime.applier import touched_paths as jax_touched_paths
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.core.ops import OpLog
from semantic_merge_tpu_torch.ops.fused import TailPipeline
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.ops.oplog_view import ComposedOpView
from semantic_merge_tpu_torch.runtime import applier

KW = dict(seed="s", base_rev="r", timestamp="2026-01-02T03:04:05Z")
_TYPES = ("number", "string", "boolean", "bigint", "object", "unknown")


def _fn(name, k):
    params = ", ".join(f"p{i}: {_TYPES[(k // 6 ** i) % 6]}" for i in range(2))
    return f"export function {name}({params}): void {{ {name}; }}\n"


#: name → (base, A, B) path→content, each snapshot at most 8 decls.
CASES = {
    # A renames in files B moves: renames land in the moved files
    # through the chain-file override; deletes and adds ride along.
    "rename_into_moved_files": (
        {"a.ts": _fn("fa", 0) + _fn("ga", 1), "b.ts": _fn("fb", 2) + _fn("gb", 3),
         "c.ts": _fn("fc", 4), "d.ts": _fn("fd", 5) + _fn("gd", 6), "README.md": "r\n"},
        {"a.ts": _fn("ra", 0) + _fn("ga", 1), "b.ts": _fn("rb", 2) + _fn("gb", 3),
         "c.ts": _fn("fc", 4), "e.ts": _fn("fe", 7), "README.md": "r\n"},
        {"lib/a.ts": _fn("fa", 0) + _fn("ga", 1), "lib/b.ts": _fn("fb", 2) + _fn("gb", 3),
         "c.ts": _fn("fc", 4), "lib/d.ts": _fn("fd", 5) + _fn("gd", 6), "README.md": "r\n"}),
    # Both sides rename different symbols of one file, one side moves it.
    "both_sides_rename": (
        {"x/m.ts": _fn("one", 8) + _fn("two", 9) + _fn("three", 10)},
        {"x/m.ts": _fn("uno", 8) + _fn("two", 9) + _fn("three", 10)},
        {"y/m.ts": _fn("one", 8) + _fn("dos", 9) + _fn("three", 10)}),
}


def _tree(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _snaps(trees, cls):
    return [cls(files=[{"path": p, "content": c} for p, c in sorted(t.items())])
            for t in trees]


@pytest.mark.parametrize("shard_rows,workers", [(8192, 1), (2, 1), (3, 4)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_columnar_tree_equals_object_and_jax(tmp_path, monkeypatch, case, shard_rows, workers):
    monkeypatch.delenv("SEMMERGE_OBJECT_APPLY", raising=False)
    trees = CASES[case]
    base_dir = tmp_path / "base"
    for path, text in trees[0].items():
        (base_dir / path).parent.mkdir(parents=True, exist_ok=True)
        (base_dir / path).write_text(text)

    backend = TorchTSBackend(device="cpu", host_workers=workers)
    backend._fused_engine()._tail = TailPipeline(workers, shard_rows)
    res, composed, conflicts = backend.merge(*_snaps(trees, Snapshot), **KW)
    assert backend.path == "fused" and not conflicts
    assert isinstance(composed, ComposedOpView) and composed.supports_columns
    if workers == 4:
        composed._plan.pipeline.eager_overlap = True  # the concurrent schedule
        composed._plan.prefetch()
    actions = [g for groups in applier.iter_columnar_actions(composed) for g in groups]
    assert {g[0] for g in actions} <= {"move", "rename"}
    touched_columnar = applier.touched_paths(composed)
    columnar = applier.apply_ops(base_dir, composed)

    monkeypatch.setenv("SEMMERGE_OBJECT_APPLY", "1")
    objects = applier.apply_ops(base_dir, composed)
    touched_objects = applier.touched_paths(composed)
    monkeypatch.delenv("SEMMERGE_OBJECT_APPLY")

    res_j, comp_j, _ = TpuTSBackend(mesh=False).merge(*_snaps(trees, JaxSnapshot), **KW)
    jax_tree = jax_apply_ops(base_dir, comp_j)
    try:
        assert _tree(columnar) == _tree(objects) == _tree(jax_tree)
        assert _tree(columnar) != _tree(base_dir)
    finally:
        for d in (columnar, objects, jax_tree):
            shutil.rmtree(d, ignore_errors=True)
    assert touched_columnar == touched_objects == jax_touched_paths(comp_j)
    assert OpLog(res.op_log_left).to_json_bytes() == JaxOpLog(res_j.op_log_left).to_json_bytes()
    assert OpLog(res.op_log_right).to_json_bytes() == JaxOpLog(res_j.op_log_right).to_json_bytes()
    assert composed.to_json_bytes() == comp_j.to_json_bytes()


def test_rename_lands_in_the_moved_file(tmp_path):
    trees = CASES["rename_into_moved_files"]
    for path, text in trees[0].items():
        (tmp_path / path).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / path).write_text(text)
    _, composed, _ = TorchTSBackend(device="cpu").merge(*_snaps(trees, Snapshot), **KW)
    out = applier.apply_ops(tmp_path, composed)
    try:
        merged = _tree(out)
        assert "a.ts" not in merged and b"function ra(" in merged["lib/a.ts"]
        assert b"function rb(" in merged["lib/b.ts"] and "lib/d.ts" in merged
    finally:
        shutil.rmtree(out, ignore_errors=True)
