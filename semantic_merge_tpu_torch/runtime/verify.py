"""Post-merge verification (reference ``semmerge/verify.py``).

The port's copy of the JAX package's ``runtime/verify.py``:
``typecheck_ts`` and the resolution tier's parity audit
``untouched_parity``.

Type-checks the merged tree with ``tsc --noEmit``. A missing toolchain
passes vacuously — the documented graceful-degradation contract
(reference ``semmerge/verify.py:28-30``; ``requirements.md:107``
[FBK-003]; ``runbook.md:57``). "Missing toolchain" includes the
half-installed case: ``npx`` present but ``tsc`` not installed makes
``npx`` print its *own* error and exit nonzero — that must be the
vacuous pass, not a failed merge. Real type failures are recognized by
``tsc``'s diagnostic format (``error TS####``), which every tsc
diagnostic carries; launcher noise never does.

The invocation runs under a process-group deadline
(``SEMMERGE_TYPECHECK_TIMEOUT`` seconds, default 300): a wedged npx/tsc
raises :class:`~semantic_merge_tpu_torch.errors.DeadlineFault`, which
ends the merge with its exit code instead of hanging the merge driver
forever.
"""
from __future__ import annotations

import logging
import pathlib
import re
import subprocess
from typing import FrozenSet, List, Optional, Set, Tuple

from ..utils.procs import env_seconds, run_with_deadline

logger = logging.getLogger(__name__)

#: Every real tsc diagnostic line carries an ``error TS####`` code;
#: npx/npm launcher failures (tsc uninstalled, registry errors) do not.
_TSC_DIAGNOSTIC = re.compile(r"\berror TS\d+")


def typecheck_ts(tree_path: pathlib.Path, *,
                 deadline: Optional[float] = None) -> Tuple[bool, List[str]]:
    tree_path = pathlib.Path(tree_path)
    if deadline is None:
        deadline = env_seconds("SEMMERGE_TYPECHECK_TIMEOUT", 300.0)
    try:
        proc = run_with_deadline(
            ["npx", "tsc", "-p", ".", "--noEmit"],
            timeout=deadline, stage="verify",
            cwd=tree_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
    except FileNotFoundError:
        logger.debug("TypeScript compiler not available; skipping type-check")
        return True, []
    if proc.returncode == 0:
        return True, []
    lines = (proc.stdout or "").splitlines()
    if not any(_TSC_DIAGNOSTIC.search(line) for line in lines):
        # Nonzero exit without a single tsc diagnostic: the launcher
        # failed (npx present, tsc uninstalled / npm error) — the
        # documented vacuous pass, not a type failure.
        logger.debug("tsc launcher failed without diagnostics "
                     "(toolchain incomplete); skipping type-check")
        return True, []
    return False, lines


def _file_set(tree: pathlib.Path) -> Set[str]:
    return {p.relative_to(tree).as_posix()
            for p in tree.rglob("*") if p.is_file()}


def untouched_parity(tree_a: pathlib.Path, tree_b: pathlib.Path, *,
                     exclude: FrozenSet[str] | Set[str] = frozenset(),
                     ) -> List[str]:
    """Byte-parity audit of two trees outside an excluded footprint —
    the resolution tier's never-worse gate: everything a resolution did
    *not* claim to touch must be identical to the conflict-free merge.

    Returns the sorted tree-relative (posix) paths that differ —
    present on one side only, or byte-unequal — excluding ``exclude``;
    an empty list means parity holds."""
    tree_a, tree_b = pathlib.Path(tree_a), pathlib.Path(tree_b)
    excluded = set(exclude)
    mismatched: List[str] = []
    for rel in sorted(_file_set(tree_a) | _file_set(tree_b)):
        if rel in excluded:
            continue
        fa, fb = tree_a / rel, tree_b / rel
        if not (fa.is_file() and fb.is_file()):
            mismatched.append(rel)
        elif fa.read_bytes() != fb.read_bytes():
            mismatched.append(rel)
    return mismatched
