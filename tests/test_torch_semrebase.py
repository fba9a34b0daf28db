"""The port's ``semrebase`` against the JAX package's.

The counterparts of ``tests/test_cli_e2e.py``'s ``semrebase`` tests, in
fresh copies of one repository per case: a ``semmerge`` stores A's op
log in the ``semmerge`` notes, then ``semrebase brA brB --inplace``
replays it onto B's revision. Each side runs its own package's CLI
(``python -m semantic_merge_tpu_torch ... --device cpu``, ``python -m
semantic_merge_tpu ... --backend tpu`` with ``JAX_PLATFORMS=cpu``); the
exit codes, the work tree's bytes and ``git status --porcelain`` must be
equal. Also: the port replaying the note the JAX CLI stored, and a
commit without a note (exit 1).
"""
import os
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ONLY = ".semmerge-postmortem"
CLI = {"jax": ("semantic_merge_tpu", ["--backend", "tpu"]),
       "port": ("semantic_merge_tpu_torch", ["--device", "cpu"])}


def _env():
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")
    return env


def git(args, cwd):
    subprocess.run(["git", *args], cwd=cwd, check=True, env=_env(),
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def make_repo(root, base, a, b):
    """basebr/brA/brB from {path: content} trees, ``main`` checked out at
    base."""
    root.mkdir(parents=True)
    git(["init", "-q", "-b", "main"], root)
    git(["config", "user.email", "t@example.com"], root)
    git(["config", "user.name", "t"], root)

    def commit(files, msg):
        for rel, text in files.items():
            (root / rel).write_text(text)
        git(["add", "-A"], root)
        git(["commit", "-q", "--allow-empty", "-m", msg], root)

    commit(base, "base")
    git(["branch", "basebr"], root)
    git(["checkout", "-qb", "brA"], root)
    commit(a, "A")
    git(["checkout", "-q", "main"], root)
    git(["checkout", "-qb", "brB"], root)
    commit(b, "B")
    git(["checkout", "-q", "main"], root)
    return root


_FOO = "export function foo(n: number): number {\n  return n;\n}\n"
_BIG = "export function big(s: string): string { return s.trim() + '!'; }\n"
#: name → (base, A, B, semmerge flags)
CASES = {
    "replays_stored_oplog": ({"a.ts": _FOO}, {"a.ts": _FOO.replace("foo", "bar")},
                             {"b.ts": "export function other(): void {}\n"}, []),
    "replays_statement_ops_with_motion_markers": (
        {"big.ts": _BIG},
        {"big.ts": "export function big(s: string): string { return helper(s, 0); }\n",
         "helper.ts": "export function helper(s: string, pad: number): string"
                      " { return s.trim() + '!'; }\n"},
        {"other.ts": "export function other(): void {}\n"},
        ["--statement-ops", "--structured-apply"]),
}


def _run(argv, cwd):
    return subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          timeout=300)


def _observe(root, codes, stderr):
    tree = {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and not {".git", JAX_ONLY} & set(p.relative_to(root).parts)}
    status = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                            cwd=root, check=True, stdout=subprocess.PIPE, text=True).stdout
    return {"codes": codes, "tree": tree, "stderr": stderr,
            "status": [line for line in status.splitlines() if JAX_ONLY not in line]}


def _merge_then_rebase(root, merge_side, rebase_side, flags):
    module, extra = CLI[merge_side]
    merged = _run([module, "semmerge", "basebr", "brA", "brB", *flags, *extra], root)
    module, extra = CLI[rebase_side]
    rebased = _run([module, "semrebase", "brA", "brB", "--inplace",
                    *(["--device", "cpu"] if rebase_side == "port" else [])], root)
    return _observe(root, (merged.returncode, rebased.returncode),
                    merged.stderr + rebased.stderr)


@pytest.fixture(scope="module")
def rebase_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("semrebase")
    jobs = {}
    for case, (base, a, b, flags) in CASES.items():
        origin = make_repo(work / case / "origin", base, a, b)
        for merge_side, rebase_side in (("jax", "jax"), ("port", "port"), ("jax", "port")):
            copy = work / case / f"{merge_side}-{rebase_side}"
            shutil.copytree(origin, copy)
            jobs[case, merge_side, rebase_side] = (copy, merge_side, rebase_side, flags)
    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = {key: pool.submit(_merge_then_rebase, *job) for key, job in jobs.items()}
        return {key: future.result() for key, future in futures.items()}


@pytest.mark.parametrize("rebase", [("port", "port"), ("jax", "port")],
                         ids=["own-note", "jax-note"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_semrebase_matches_jax_cli(rebase_runs, case, rebase):
    want, got = rebase_runs[case, "jax", "jax"], rebase_runs[(case, *rebase)]
    assert want["codes"] == (0, 0), want["stderr"]
    assert got["codes"] == want["codes"], got["stderr"]
    assert got["tree"] == want["tree"]
    assert got["status"] == want["status"]


def test_semrebase_cases_show_what_they_are_named_for(rebase_runs):
    tree = rebase_runs["replays_stored_oplog", "port", "port"]["tree"]
    assert b"bar" in tree["a.ts"] and b"foo" not in tree["a.ts"]
    assert "b.ts" in tree, "brB's own file must survive the replay"
    tree = rebase_runs["replays_statement_ops_with_motion_markers", "port", "port"]["tree"]
    assert b"helper(s, 0)" in tree["big.ts"] and "helper.ts" in tree


@pytest.mark.parametrize("side", sorted(CLI))
def test_semrebase_without_note_fails_cleanly(tmp_path, side):
    root = make_repo(tmp_path / "repo", {"a.ts": _FOO}, {}, {})
    module, extra = CLI[side]
    out = _run([module, "semrebase", "HEAD", "HEAD",
                *(["--device", "cpu"] if side == "port" else [])], root)
    assert out.returncode == 1
    assert "No semmerge op log stored for HEAD" in out.stderr
