"""Formatter hook (reference ``semmerge/emitter.py``).

The port's copy of the JAX package's ``runtime/emitter.py``.

Best-effort formatting of the merged tree. The formatter command comes
from config (``[core] formatter`` / per-language ``formatter_cmd``),
defaulting to Prettier via npx. A missing toolchain downgrades to a
debug log; a failing run to a warning — formatting never fails a merge
(reference ``semmerge/emitter.py:22-25``; ``requirements.md:107``
[FBK-003]).
"""
from __future__ import annotations

import logging
import pathlib
import re
import subprocess
from typing import Sequence

from ..errors import DeadlineFault
from ..obs import spans as obs_spans
from ..utils import faults
from ..utils.procs import env_seconds, run_with_deadline

logger = logging.getLogger(__name__)

#: Target-free: emit_files appends "." (tree mode) or the touched paths.
DEFAULT_FORMATTER = ("npx", "prettier", "--write")

#: fast-glob metacharacters prettier would interpret in an explicit
#: path argument (e.g. Next.js route files like ``pages/[id].ts``).
_GLOB_CHARS = re.compile(r"[*?\[\]{}()!]")

#: Suffixes prettier can parse out of the box (its built-in language
#: set) — the touched-scope filter: a text-merged ``notes.txt`` or a
#: binary must never reach prettier as an explicit path argument.
PRETTIER_EXTENSIONS = frozenset((
    ".js", ".jsx", ".mjs", ".cjs", ".ts", ".tsx", ".mts", ".cts",
    ".json", ".json5", ".jsonc", ".css", ".scss", ".less", ".html",
    ".htm", ".vue", ".md", ".markdown", ".mdx", ".yaml", ".yml",
    ".graphql", ".gql", ".handlebars", ".hbs"))


def _escape_glob(path: str) -> str:
    """Backslash-escape fast-glob metacharacters so an explicit path
    argument (``pages/[id].ts``, ``app/(marketing)/page.tsx``) reaches
    prettier as a literal file, not a pattern. fast-glob honors
    ``\\``-escaping on every platform prettier runs it."""
    return _GLOB_CHARS.sub(lambda m: "\\" + m.group(0), path)


def emit_files(tree_path: pathlib.Path,
               formatter_cmd: Sequence[str] | None = None,
               paths: Sequence[str] | None = None) -> None:
    """Format the merged tree. ``formatter_cmd`` is target-free (no
    trailing ``.``). ``paths=None`` formats the whole tree (the
    reference's behavior); a list formats only those files —
    touched-scope mode (``[engine] formatter_scope = "touched"``), which
    leaves every unvisited file byte-identical. An empty list skips the
    formatter entirely. Touched paths containing glob metacharacters
    are backslash-escaped (fast-glob's literal-path escape), so
    Next.js-style routes format in place instead of degrading the whole
    merge to tree-wide formatting.

    The formatter runs under a process-group deadline
    (``SEMMERGE_FORMAT_TIMEOUT`` seconds, default 300): a wedged
    prettier is killed — whole process group, npx children included —
    and logged; per [FBK-003] even a deadline never fails the merge. The
    ``emit`` fault-injection stage fires first."""
    faults.check("emit")
    tree_path = pathlib.Path(tree_path)
    base_cmd = list(formatter_cmd) if formatter_cmd else list(DEFAULT_FORMATTER)
    if paths is not None:
        existing = sorted(p for p in paths if (tree_path / p).is_file())
        if not existing:
            return
        cmd = base_cmd + [_escape_glob(p) for p in existing]
        scope = len(existing)
    else:
        cmd = base_cmd + ["."]
        scope = -1  # whole tree
    deadline = env_seconds("SEMMERGE_FORMAT_TIMEOUT", 300.0)
    with obs_spans.span("emit_files", layer="runtime", files=scope):
        try:
            run_with_deadline(cmd, timeout=deadline, stage="format",
                              cwd=tree_path, check=True,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
        except FileNotFoundError:
            logger.debug("Formatter %s not available; skipping", cmd[0])
        except subprocess.CalledProcessError as exc:
            logger.warning("Formatter exited with code %s", exc.returncode)
        except DeadlineFault as exc:
            logger.warning("Formatter killed: %s", exc.describe())
        except OSError as exc:
            # E2BIG on huge touched lists and friends — formatting never
            # fails a merge ([FBK-003] posture).
            logger.warning("Formatter could not run: %s", exc)
