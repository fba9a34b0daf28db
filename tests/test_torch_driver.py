"""The port's git merge driver against the JAX package's.

Each scenario of ``tests/test_merge_driver.py`` runs twice, in two
repositories built the same way (fixed commit dates, so equal content
gives equal commits): once with ``scripts/semmerge-driver.py`` (the JAX
CLI, ``JAX_PLATFORMS=cpu``) registered as ``merge.semmerge.driver``,
once with ``python -m semantic_merge_tpu_torch.driver ... --device
cpu``. Real ``git merge`` calls start the driver; the exit code of git,
the work tree's bytes, ``git status --porcelain``, the merge commit, the
semmerge notes and ``.semmerge-conflicts.json`` must be equal, and the
latch must behave as the JAX driver's does:

- a clean merge through the driver (the latch stays, notes on both
  heads);
- a stale latch for the same heads is refreshed, not trusted;
- an engine failure (``apply:fault`` under ``SEMMERGE_STRICT=1``) leaves
  ``%A`` as git materialized it, the file unmerged and the latch
  cleared, and the retry merges;
- a DivergentRename conflict fails the merge with the artifact;
- the default engine settings (no statement ops, no structured apply):
  one branch renames a function and adds one to another file, the other
  edits a body. Both drivers commit the rename without the body edit
  (a body edit is no op unless statement ops are on), and leave the
  work tree's copy of the other file without the added function (the
  engine writes its whole tree in place and, in parity mode, does not
  write an added function; git commits its own merge of that file).

Added: a device fault (``kernel:fault``) through the port's driver fails
the merge the same way (the JAX CLI would merge it on its host rung),
and the driver's copy-back path imports neither ``torch`` nor the JAX
package.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_DRIVER = REPO_ROOT / "scripts" / "semmerge-driver.py"
DRIVERS = {"jax": f"{sys.executable} {JAX_DRIVER} %O %A %B %P",
           "port": f"{sys.executable} -m semantic_merge_tpu_torch.driver %O %A %B %P "
                   "--device cpu"}
JAX_ONLY = ".semmerge-postmortem"

BASE_TS = (
    "export function greet(name: string): string {\n"
    "  return name;\n"
    "}\n"
    "export function count(xs: number[]): number {\n"
    "  return xs.length;\n"
    "}\n"
)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-02T00:00:00Z")
    env.update(extra)
    return env


def git(args, cwd, env=None, check=True):
    proc = subprocess.run(["git", *args], cwd=cwd, capture_output=True, text=True,
                          env=env or _env())
    if check and proc.returncode != 0:
        raise AssertionError(f"git {args} failed: {proc.stderr}")
    return proc


def driver_repo(root, side):
    root.mkdir(parents=True)
    git(["init", "-q", "-b", "main"], root)
    git(["config", "user.email", "d@e"], root)
    git(["config", "user.name", "d"], root)
    git(["config", "merge.semmerge.driver", DRIVERS[side]], root)
    (root / ".gitattributes").write_text("*.ts merge=semmerge\n")
    (root / ".semmerge.toml").write_text(
        '[engine]\nbackend = "host"\nstructured_apply = true\n')
    (root / "a.ts").write_text(BASE_TS)
    git(["add", "-A"], root)
    git(["commit", "-qm", "base"], root)
    return root


def make_branches(repo):
    git(["checkout", "-qb", "branch-a"], repo)
    (repo / "a.ts").write_text(BASE_TS.replace("greet", "salute"))
    git(["commit", "-qam", "rename"], repo)
    git(["checkout", "-q", "main"], repo)
    git(["checkout", "-qb", "branch-b"], repo)
    (repo / "a.ts").write_text(
        BASE_TS + "export function added(flag: boolean): boolean {\n"
                  "  return !flag;\n}\n")
    git(["commit", "-qam", "add-decl"], repo)
    git(["checkout", "-q", "main"], repo)
    git(["merge", "-q", "--no-ff", "branch-a", "-m", "take-a"], repo)


def observe(repo, merge):
    """What a merge left behind."""
    tree = {p.relative_to(repo).as_posix(): p.read_bytes()
            for p in sorted(repo.rglob("*"))
            if p.is_file() and not {".git", JAX_ONLY} & set(p.relative_to(repo).parts)}
    status = [line for line in git(["status", "--porcelain"], repo).stdout.splitlines()
              if JAX_ONLY not in line]
    notes = git(["notes", "--ref", "semmerge", "list"], repo, check=False).stdout
    return {"code": merge.returncode, "tree": tree, "status": status,
            "head": git(["rev-parse", "HEAD"], repo).stdout.strip(),
            "notes": notes, "latch": (repo / ".git" / ".semmerge.lock").exists(),
            "stderr": merge.stderr}


def real_merge(repo):
    make_branches(repo)
    return {"merge": observe(repo, git(["merge", "--no-ff", "branch-b", "-m", "semantic"],
                                       repo, check=False))}


def stale_lock(repo):
    make_branches(repo)
    head = git(["rev-parse", "HEAD"], repo).stdout.strip()
    merge_head = git(["rev-parse", "branch-b"], repo).stdout.strip()
    lock = repo / ".git" / ".semmerge.lock"
    lock.write_text(f"{head} {merge_head}")
    old = time.time() - 7200
    os.utime(lock, (old, old))
    out = observe(repo, git(["merge", "--no-ff", "branch-b", "-m", "semantic"], repo,
                            check=False))
    return {"merge": out, "refreshed": lock.stat().st_mtime > old + 3600}


def _failing_merge(repo, **env):
    ours = (repo / "a.ts").read_bytes()
    failed = observe(repo, git(["merge", "--no-ff", "branch-b", "-m", "x"], repo,
                               env=_env(**env), check=False))
    return {"failed": failed, "ours_kept": (repo / "a.ts").read_bytes() == ours}


def engine_failure(repo):
    make_branches(repo)
    out = _failing_merge(repo, SEMMERGE_FAULT="apply:fault", SEMMERGE_STRICT="1")
    git(["merge", "--abort"], repo)
    out["retry"] = observe(repo, git(["merge", "--no-ff", "branch-b", "-m", "retry"], repo,
                                     check=False))
    return out


def device_fault(repo):
    """A device fault in the default posture: no rung hides it. Without
    structured apply, so that the merge takes the fused engine."""
    (repo / ".semmerge.toml").write_text('[engine]\nbackend = "host"\n')
    git(["commit", "-qam", "fused"], repo)
    make_branches(repo)
    return _failing_merge(repo, SEMMERGE_FAULT="kernel:fault")


B_TS = "export function keep(flag: boolean): boolean {\n  return flag;\n}\n"


def default_config(repo):
    (repo / ".semmerge.toml").write_text('[engine]\nbackend = "host"\n')
    (repo / "b.ts").write_text(B_TS)
    git(["add", "-A"], repo)
    git(["commit", "-qm", "default"], repo)
    git(["checkout", "-qb", "branch-a"], repo)
    (repo / "a.ts").write_text(BASE_TS.replace("greet", "salute"))
    (repo / "b.ts").write_text(
        B_TS + "export function more(n: number): number {\n  return n;\n}\n")
    git(["commit", "-qam", "rename-and-add"], repo)
    git(["checkout", "-q", "main"], repo)
    git(["checkout", "-qb", "branch-b"], repo)
    (repo / "a.ts").write_text(BASE_TS.replace("return xs.length;", "return xs.length + 1;"))
    git(["commit", "-qam", "body-edit"], repo)
    git(["checkout", "-q", "branch-a"], repo)
    out = observe(repo, git(["merge", "--no-ff", "branch-b", "-m", "semantic"], repo,
                            check=False))
    return {"merge": out,
            "committed": tuple(git(["show", f"HEAD:{p}"], repo).stdout for p in ("a.ts", "b.ts"))}


def divergent_rename(repo):
    git(["checkout", "-qb", "conf-a"], repo)
    (repo / "a.ts").write_text(BASE_TS.replace("greet", "left"))
    git(["commit", "-qam", "ca"], repo)
    git(["checkout", "-q", "main"], repo)
    git(["checkout", "-qb", "conf-b"], repo)
    (repo / "a.ts").write_text(BASE_TS.replace("greet", "right"))
    git(["commit", "-qam", "cb"], repo)
    git(["checkout", "-q", "conf-a"], repo)
    return {"merge": observe(repo, git(["merge", "--no-ff", "conf-b", "-m", "boom"], repo,
                                       check=False))}


SCENARIOS = {"real_merge": real_merge, "stale_lock": stale_lock,
             "engine_failure": engine_failure, "divergent_rename": divergent_rename,
             "default_config": default_config}


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("driver")
    jobs = {(name, side): (fn, work / f"{name}-{side}")
            for name, fn in SCENARIOS.items() for side in DRIVERS}
    jobs["device_fault", "port"] = (device_fault, work / "device_fault-port")
    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = {key: pool.submit(fn, driver_repo(root, key[1]))
                   for key, (fn, root) in jobs.items()}
        return {key: future.result() for key, future in futures.items()}


def _same(got, want):
    for key in ("code", "tree", "status", "head", "notes", "latch"):
        assert got[key] == want[key], (key, got["stderr"], want["stderr"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_matches_jax_driver(driver_runs, name):
    want, got = driver_runs[name, "jax"], driver_runs[name, "port"]
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, dict):
            _same(got[key], value)
        else:
            assert got[key] == value, key


def test_real_git_merge_through_driver(driver_runs):
    out = driver_runs["real_merge", "port"]["merge"]
    assert out["code"] == 0, out["stderr"]
    merged = out["tree"]["a.ts"].decode()
    assert "salute" in merged and "added" in merged and "greet" not in merged
    assert out["latch"] and out["notes"].strip()
    assert out["status"] == []


def test_stale_lock_recovery(driver_runs):
    run = driver_runs["stale_lock", "port"]
    assert run["merge"]["code"] == 0 and run["refreshed"]
    assert b"added" in run["merge"]["tree"]["a.ts"]


@pytest.mark.parametrize("scenario", ["engine_failure", "device_fault"])
def test_engine_failure_leaves_file_as_git_materialized_it(driver_runs, scenario):
    run = driver_runs[scenario, "port"]
    failed = run["failed"]
    assert failed["code"] != 0 and run["ours_kept"]
    assert any(line.startswith(("UU", "AA")) for line in failed["status"])
    assert not failed["latch"]
    assert "degrading" not in failed["stderr"]
    if scenario == "engine_failure":
        assert run["retry"]["code"] == 0, run["retry"]["stderr"]
        merged = run["retry"]["tree"]["a.ts"]
        assert b"salute" in merged and b"added" in merged


def test_device_fault_exits_with_the_kernel_code(driver_runs):
    assert "KernelFault" in driver_runs["device_fault", "port"]["failed"]["stderr"]


def test_divergent_rename_surfaces_conflict(driver_runs):
    out = driver_runs["divergent_rename", "port"]["merge"]
    assert out["code"] != 0
    report = json.loads(out["tree"][".semmerge-conflicts.json"])
    assert any(c["category"] == "DivergentRename" for c in report)
    assert not out["latch"]


def test_default_config_drops_the_body_edit_as_the_jax_driver_does(driver_runs):
    run = driver_runs["default_config", "port"]
    out, (a_ts, b_ts) = run["merge"], run["committed"]
    assert out["code"] == 0, out["stderr"]
    assert "salute" in a_ts and "greet" not in a_ts
    assert "xs.length + 1" not in a_ts and "xs.length;" in a_ts
    assert "function more" in b_ts
    assert out["status"] == [" M b.ts"]
    assert b"function more" not in out["tree"]["b.ts"]


def test_copy_back_imports_neither_torch_nor_jax(tmp_path):
    """A start after the first (the latch names this merge) copies the
    engine's file back onto %A with the standard library alone."""
    repo = driver_repo(tmp_path / "repo", "port")
    make_branches(repo)
    head = git(["rev-parse", "HEAD"], repo).stdout.strip()
    merge_head = git(["rev-parse", "branch-b"], repo).stdout.strip()
    (repo / ".git" / ".semmerge.lock").write_text(f"{head} {merge_head}")
    (repo / "a.ts").write_text("merged by the engine\n")
    ours = tmp_path / "ours"
    ours.write_text("git's ours\n")
    code = ("import runpy, sys\n"
            f"sys.argv = ['driver', 'base', {str(ours)!r}, 'theirs', 'a.ts']\n"
            "try:\n"
            "    runpy.run_module('semantic_merge_tpu_torch.driver', run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    code = exc.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'numpy', 'semantic_merge_tpu'))\n"
            "print(code, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=_env(**{f"GITHEAD_{merge_head}": "branch-b"}),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"
    assert ours.read_text() == "merged by the engine\n"
