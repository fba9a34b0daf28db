"""Op-log persistence as git notes (reference ``semmerge/notes.py``).

The port's copy of the JAX package's ``runtime/notes.py``; commands run
in ``cwd`` (when ``None``, the scoped request root inside a merge
service request, else the process's working directory).

Op logs are attached to the merged commits under the ``semmerge`` notes
ref after every successful merge, for traceability and rebase replay.
Failures are swallowed — notes are best-effort metadata, never a reason
to fail a merge (reference ``semmerge/notes.py:34-36``). Unlike the
reference, the logs can also be read back (``notes_get``), which powers
``semrebase`` replay.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import tempfile

from ..core.ops import OpLog
from ..utils import workdir

NOTES_REF = "semmerge"


def notes_put(commit: str, oplog: OpLog, namespace: str = NOTES_REF,
              cwd: pathlib.Path | None = None) -> None:
    fd, tmp_path = tempfile.mkstemp(prefix="semmerge_notes_")
    os.close(fd)
    tmp_file = pathlib.Path(tmp_path)
    try:
        tmp_file.write_bytes(oplog.to_json_bytes())
        subprocess.run(
            ["git", "notes", "--ref", namespace, "add", "-f", "-F", str(tmp_file), commit],
            check=True, cwd=cwd if cwd is not None else workdir.current(),
        )
    except subprocess.CalledProcessError:
        pass  # Notes are optional; never fail the merge over them.
    finally:
        tmp_file.unlink(missing_ok=True)


def notes_get(commit: str, namespace: str = NOTES_REF,
              cwd: pathlib.Path | None = None) -> OpLog | None:
    try:
        proc = subprocess.run(
            ["git", "notes", "--ref", namespace, "show", commit],
            check=True, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=cwd if cwd is not None else workdir.current(),
        )
    except subprocess.CalledProcessError:
        return None
    try:
        return OpLog.from_json(proc.stdout)
    except Exception:
        return None
