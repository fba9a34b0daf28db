"""Snapshot construction: a checked-out tree → in-memory file list.

Mirrors the reference bridge's snapshot semantics (reference
``semmerge/lang/ts/bridge.py:66-78``): every ``.ts/.tsx/.js/.jsx`` file
under the tree, path as POSIX-relative, full contents in memory. File
order is sorted for determinism (the reference relies on ``rglob``
order, which is OS-dependent — a determinism bug this framework fixes;
reference ``requirements.md:163`` [NFR-DET-001]).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

TS_EXTENSIONS = {".ts", ".tsx", ".js", ".jsx"}
# Everything any registered language backend can index. Snapshots carry
# the union; each backend filters to its own extensions (the TS backends
# keep reference-parity by seeing exactly the TS/JS set).
SOURCE_EXTENSIONS = TS_EXTENSIONS | {".java", ".cs"}


@dataclass
class Snapshot:
    files: List[Dict[str, str]] = field(default_factory=list)
    project: str | None = None


def filter_files(snap: Snapshot, extensions) -> List[Dict[str, str]]:
    """The subset of a snapshot's files a backend can index.

    ``str.endswith`` takes the whole suffix tuple in C — this runs per
    file per scan (30k×/snapshot at the 10k-file bench rung), where a
    Python-level ``any(...)`` generator showed up in profiles. Suffix
    *match* semantics (not exact-extension): ``foo.d.ts`` matches
    ``.ts``, as in the reference bridge's filter."""
    suffixes = tuple(extensions)
    return [f for f in snap.files if f["path"].endswith(suffixes)]

