"""Snapshot construction: a checked-out tree → in-memory file list.

Mirrors the reference bridge's snapshot semantics (reference
``semmerge/lang/ts/bridge.py:66-78``): every ``.ts/.tsx/.js/.jsx`` file
under the tree, path as POSIX-relative, full contents in memory. File
order is sorted for determinism (the reference relies on ``rglob``
order, which is OS-dependent — a determinism bug this framework fixes;
reference ``requirements.md:163`` [NFR-DET-001]).
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import Dict, List

from ..obs import spans as obs_spans

TS_EXTENSIONS = {".ts", ".tsx", ".js", ".jsx"}
# Everything any registered language backend can index. Snapshots carry
# the union; each backend filters to its own extensions (the TS backends
# keep reference-parity by seeing exactly the TS/JS set).
SOURCE_EXTENSIONS = TS_EXTENSIONS | {".java", ".cs"}


@dataclass
class Snapshot:
    files: List[Dict[str, str]] = field(default_factory=list)
    project: str | None = None


def annotate_residency(snap: Snapshot, repo_root: str, tree_oid: str,
                       scope=None) -> Snapshot:
    """Mark a snapshot as addressable in the warm residency cache
    (``service/residency.py``) under ``(repo_root, tree_oid, scope)``.
    A backend seeing the annotation may serve the encoded form from
    residency — skipping scan, encode and the decl columns' h2d copy —
    instead of re-encoding; byte-identical either way. Returns ``snap``
    for chaining. ``repo_root`` may be ``""`` for synthetic snapshots."""
    from ..service import residency
    residency.annotate(snap, repo_root, tree_oid, scope=scope)
    return snap


def filter_files(snap: Snapshot, extensions) -> List[Dict[str, str]]:
    """The subset of a snapshot's files a backend can index.

    ``str.endswith`` takes the whole suffix tuple in C — this runs per
    file per scan (30k×/snapshot at the 10k-file bench rung), where a
    Python-level ``any(...)`` generator showed up in profiles. Suffix
    *match* semantics (not exact-extension): ``foo.d.ts`` matches
    ``.ts``, as in the reference bridge's filter."""
    suffixes = tuple(extensions)
    return [f for f in snap.files if f["path"].endswith(suffixes)]



def snapshot_tree(root: pathlib.Path) -> Snapshot:
    """The snapshot of a checked-out tree: every file of
    :data:`SOURCE_EXTENSIONS` under ``root``, sorted, as the JAX
    package's ``snapshot_tree`` reads it (the ``snapshot_tree`` span,
    layer ``frontend``)."""
    root = pathlib.Path(root)
    files = []
    with obs_spans.span("snapshot_tree", layer="frontend"):
        for path in sorted(root.rglob("*")):
            if path.is_file() and path.suffix in SOURCE_EXTENSIONS:
                files.append({
                    "path": path.relative_to(root).as_posix(),
                    "content": path.read_text(encoding="utf-8"),
                })
    return Snapshot(files=files)
