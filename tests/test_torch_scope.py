"""The TypeScript engine's incremental scope: the port's CLI against the
JAX CLI.

Both CLIs scope a TypeScript ``semdiff`` / ``semmerge`` scan to the
files either side touched under ``[engine] incremental`` (the default),
and fall back to the full tree when a scoped symbolId has an
out-of-scope twin (the collision guard, with its log line). Three
repositories: ``scoped`` (A renames a function in one of 12 files and
edits a text file, B moves another file), ``twin`` (the same, plus a
function in A's renamed file whose structural signature a function in
an untouched file shares: the guard falls back), ``conflict`` (both
sides rename one function: exit 1 and ``.semmerge-conflicts.json``).
Each runs ``semdiff basebr brA --json-out --trace`` and ``semmerge basebr
brA brB --inplace --trace``, with the scope on and off
(``incremental = false``), through ``python -m semantic_merge_tpu_torch
... --device cpu`` and ``python -m semantic_merge_tpu ... --backend tpu``
(``JAX_PLATFORMS=cpu``). Equal: exit code, stdout, the work tree (the
conflicts artifact included, the trace files left out), both notes,
the trace's ``scope_files`` counter (absent with the scope off or after
the fallback), and the fallback's log line.

A warm port daemon then serves one repository a scoped ``semdiff``, the
same ``semdiff`` unscoped, and an unscoped ``semmerge --inplace``: each
answer equals the JAX CLI's one-shot run of the same sequence, and the
residency cache keeps the scoped and the full base apart (two entries;
the merge's full base hit the second diff's).
"""
import json
import shutil
import subprocess
import sys

import pytest

from test_torch_service import (WAIT, _env, make_repo, notes, start_daemon, status, stop,
                                tree_bytes, wait_for_hello)
from test_torch_strict import _run_all


def _decl(i, name):
    # A parameter count of its own per function: a symbolId hashes the
    # structural signature only.
    params = ", ".join(f"p{k}: number" for k in range(i + 1))
    return f"export function {name}({params}): number {{\n  return {i};\n}}\n"


_DUP = "export function %s(a: string, b: string, c: string): string { return a; }\n"
_BASE = {**{f"src/m{i}.ts": _decl(i, f"fn{i}") for i in range(12)},
         "notes.txt": "one\ntwo\n"}
_MOVE = {"lib/m3.ts": _decl(3, "fn3"), "src/m3.ts": None}
#: name → (base, A, B)
REPOS = {
    "scoped": (_BASE, {"src/m0.ts": _decl(0, "renamed0"), "notes.txt": "one\ntwo\nthree\n"},
               _MOVE),
    "twin": ({**_BASE, "src/m0.ts": _decl(0, "fn0") + _DUP % "dupScoped",
              "src/zzz_twin.ts": _DUP % "dupTwin"},
             {"src/m0.ts": _decl(0, "renamed0") + _DUP % "dupRenamed"}, _MOVE),
    "conflict": (_BASE, {"src/m0.ts": _decl(0, "left0")}, {"src/m0.ts": _decl(0, "right0")}),
}
COMMANDS = {"semdiff": ["semdiff", "basebr", "brA", "--json-out", "--trace"],
            "semmerge": ["semmerge", "basebr", "brA", "brB", "--inplace", "--trace"]}
CONFIGS = {"on": None, "off": "[engine]\nincremental = false\n"}
FALLBACK = "incremental scope disabled: a scoped symbolId has an out-of-scope twin"
TRACE_FILES = {".semmerge-trace.json", ".semmerge-events.jsonl"}
SIDES = (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
         ("port", "semantic_merge_tpu_torch", ["--device", "cpu"]))


def _scope_files(root):
    trace = json.loads((root / ".semmerge-trace.json").read_text())
    return trace.get("counters", {}).get("scope_files")


def _outcome(root, code, stdout, stderr):
    tree = {k: v for k, v in tree_bytes(root).items() if k not in TRACE_FILES}
    return {"code": code, "stdout": stdout, "stderr": stderr, "tree": tree,
            "notes": notes(root), "scope_files": _scope_files(root)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("scope")
    origins = {name: make_repo(work / f"origin-{name}", *trees)
               for name, trees in REPOS.items()}
    jobs = {}
    for repo in REPOS:
        for command in COMMANDS:
            for config, toml in CONFIGS.items():
                for side, module, flags in SIDES:
                    root = work / f"{repo}-{command}-{config}-{side}"
                    shutil.copytree(origins[repo], root)
                    if toml is not None:
                        (root / ".semmerge.toml").write_text(toml)
                    jobs[repo, command, config, side] = (
                        root, [module, *COMMANDS[command], *flags])
    return {key: _outcome(jobs[key][0], *done)
            for key, done in _run_all(jobs, _env(), limit=4).items()}


CASES = [(r, c, k) for r in REPOS for c in COMMANDS for k in CONFIGS]


@pytest.mark.parametrize("repo,command,config", CASES)
def test_scope_matches_the_jax_cli(runs, repo, command, config):
    want, got = runs[repo, command, config, "jax"], runs[repo, command, config, "port"]
    assert want["code"] == (1 if (repo, command) == ("conflict", "semmerge") else 0), \
        want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    assert got["scope_files"] == want["scope_files"]
    for run in (want, got):
        assert (FALLBACK in run["stderr"]) == (repo == "twin" and config == "on"), run["stderr"]


def test_cases_show_what_they_are_named_for(runs):
    # The scope is on where it should be, off with the key, gone after
    # the fallback: scope_files counts the touched paths of a merge.
    assert runs["scoped", "semmerge", "on", "port"]["scope_files"] == 4
    assert runs["scoped", "semmerge", "off", "port"]["scope_files"] is None
    assert runs["twin", "semmerge", "on", "port"]["scope_files"] is None
    assert runs["conflict", "semmerge", "on", "port"]["scope_files"] == 1
    merged = runs["scoped", "semmerge", "on", "port"]["tree"]
    assert b"renamed0" in merged["src/m0.ts"] and "lib/m3.ts" in merged
    assert merged["notes.txt"] == b"one\ntwo\nthree\n"
    assert ".semmerge-conflicts.json" in runs["conflict", "semmerge", "on", "port"]["tree"]
    # Scoped or not, the op logs are the same.
    for repo in REPOS:
        diffs = {runs[repo, "semdiff", config, "port"]["stdout"] for config in CONFIGS}
        assert len(diffs) == 1


#: The daemon's sequence in one repository: (argv, .semmerge.toml or None).
SERVED = [(["semdiff", "basebr", "brA", "--json-out"], None),
          (["semdiff", "basebr", "brA", "--json-out"], CONFIGS["off"]),
          (["semmerge", "basebr", "brA", "brB", "--inplace"], CONFIGS["off"])]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    work = tmp_path_factory.mktemp("scope_svc")
    origin = make_repo(work / "origin", *REPOS["scoped"])
    roots = {side: work / side for side in ("jax", "port")}
    for root in roots.values():
        shutil.copytree(origin, root)
    sock = work / "port.sock"
    proc = start_daemon(sock)
    steps = []
    try:
        wait_for_hello(sock, proc)
        before = status(sock)
        for argv, toml in SERVED:
            runs = {}
            for side, module, flags in SIDES:
                root = roots[side]
                config = root / ".semmerge.toml"
                if toml is None:
                    config.unlink(missing_ok=True)
                else:
                    config.write_text(toml)
                env = (_env() if side == "jax" else
                       _env(SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(sock)))
                out = subprocess.run([sys.executable, "-m", module, *argv, *flags], cwd=root,
                                     env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, timeout=WAIT)
                runs[side] = {"code": out.returncode, "stdout": out.stdout,
                              "stderr": out.stderr, "tree": tree_bytes(root),
                              "notes": notes(root)}
            steps.append(runs)
        after = status(sock)
    finally:
        stop(proc)
    return steps, before, after


@pytest.mark.parametrize("step", range(len(SERVED)))
def test_daemon_serves_scoped_then_unscoped_with_the_jax_bytes(served, step):
    steps, before, after = served
    want, got = steps[step]["jax"], steps[step]["port"]
    assert want["code"] == 0, want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    assert after["served_total"] - before["served_total"] == len(SERVED)


def test_daemon_keeps_a_scoped_and_a_full_base_apart(served):
    _steps, before, after = served
    res0, res1 = before["residency"], after["residency"]
    # The scoped base and the full base: two entries of one tree; the
    # merge's full base is the unscoped semdiff's.
    assert res1["entries"] - res0["entries"] == 2, res1
    assert res1["hits"] - res0["hits"] >= 1, res1
