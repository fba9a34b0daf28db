"""Git merge driver of the port (the JAX package's
``scripts/semmerge-driver.py``).

Git starts it once per conflicted file. Register it with the ``%P``
placeholder (the file's real path; ``%O``/``%A``/``%B`` are temporary
files git materializes)::

    git config merge.semmerge.driver \\
        "python3 -m semantic_merge_tpu_torch.driver %O %A %B %P"
    echo '*.ts merge=semmerge' >> .gitattributes   # or .git/info/attributes

Arguments after ``%P`` are forwarded to the CLI (``--device cpu`` runs
the merge on the CPU). The engine merges at repository scope, so the
first start runs ``python -m semantic_merge_tpu_torch semmerge BASE HEAD
MERGE_HEAD --inplace --git`` and records the merge in a latch file,
``.git/.semmerge.lock``; later starts for the same merge copy the
engine's result for their path back onto ``%A``. The latch lives until
it is older than :data:`STALE_LOCK_SECONDS` or names another merge. On
a failure exit the latch is cleared and ``%A`` is left as git
materialized it, so git's own conflict handling wins and the next start
retries.

This module imports the standard library only: git starts it for every
conflicted file, and every start after the first is a copy.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import time

STALE_LOCK_SECONDS = 3600


def run(cmd: list[str], cwd: str | None = None) -> str:
    proc = subprocess.run(cmd, cwd=cwd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    if proc.returncode != 0:
        if proc.stderr:
            sys.stderr.write(proc.stderr)
        sys.exit(proc.returncode)
    return proc.stdout.strip()


def incoming_head(repo_root: pathlib.Path, head: str) -> str | None:
    """The revision being merged in.

    While ``git merge`` runs its strategies ``MERGE_HEAD`` does not
    exist yet; git gives merge drivers a ``GITHEAD_<sha>`` environment
    variable per head. A single non-HEAD ``GITHEAD_*`` sha wins (the
    two-head merge); otherwise the on-disk refs (``MERGE_HEAD``,
    ``REBASE_HEAD``, ``CHERRY_PICK_HEAD``) cover rebase, cherry-pick and
    ``git merge --continue``. Octopus merges (several incoming heads)
    give ``None``: the driver leaves those files conflicted."""
    githeads = [key[len("GITHEAD_"):] for key in os.environ
                if key.startswith("GITHEAD_")]
    others = sorted({sha for sha in githeads if sha != head})
    if len(others) == 1:
        return others[0]
    if len(others) > 1:
        return None
    for ref in ("MERGE_HEAD", "REBASE_HEAD", "CHERRY_PICK_HEAD"):
        proc = subprocess.run(["git", "rev-parse", "--verify", "--quiet", ref],
                              cwd=repo_root, stdout=subprocess.PIPE, text=True)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip()
    return None


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 4:
        sys.exit(
            "semmerge driver requires %O %A %B %P arguments — configure "
            "merge.semmerge.driver with the %P placeholder"
        )
    _base_file, ours_file, _theirs_file, pathname = argv[:4]
    cli_args = argv[4:]

    repo_root = pathlib.Path(run(["git", "rev-parse", "--show-toplevel"]))
    head = run(["git", "rev-parse", "HEAD"])
    merge_head = incoming_head(repo_root, head)
    if merge_head is None:
        # No merge in progress that we understand: leave the file
        # conflicted rather than guessing.
        sys.exit(1)
    base_commit = run(["git", "merge-base", "HEAD", merge_head])

    lock = repo_root / ".git" / ".semmerge.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    stale = lock.exists() and time.time() - lock.stat().st_mtime > STALE_LOCK_SECONDS
    same_merge = (
        lock.exists() and not stale
        and lock.read_text().strip() == f"{head} {merge_head}"
    )
    if not same_merge:
        lock.write_text(f"{head} {merge_head}")
        # As the JAX driver: the daemon posture defaults to auto, which
        # this port's CLI runs one-shot; an explicit value is respected.
        env = dict(os.environ)
        env.setdefault("SEMMERGE_DAEMON", "auto")
        try:
            code = subprocess.run(
                [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge",
                 base_commit, head, merge_head, "--inplace", "--git", *cli_args],
                cwd=repo_root, env=env,
            ).returncode
        except BaseException:
            # A crashed run must not latch; the next start retries.
            lock.unlink(missing_ok=True)
            raise
        if code != 0:
            # Clear the latch so the next start retries the full merge
            # instead of copying back a stale resolution, and leave %A
            # exactly as git materialized it. (The crash-safe --inplace
            # commit leaves the work tree untouched on every failure.)
            lock.unlink(missing_ok=True)
            sys.exit(code)

    resolved = repo_root / pathname
    if resolved.exists():
        shutil.copyfile(resolved, ours_file)
        sys.exit(0)
    # The engine deleted or moved the file away: report a conflict so
    # git keeps the user in the loop rather than silently taking "ours".
    sys.exit(1)


if __name__ == "__main__":
    main()
