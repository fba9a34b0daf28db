"""``--backend`` and ``[engine] backend``: the port against the JAX CLI.

- CLI, in a scratch git repository (A renames a function, B moves its
  file): ``python -m semantic_merge_tpu_torch ... --device cpu`` against
  ``python -m semantic_merge_tpu ...`` (``JAX_PLATFORMS=cpu``), ``semdiff
  --json-out`` and ``semmerge --inplace``, with ``--backend`` each of
  ``tpu``, ``ts_tpu``, ``host``, ``ts_host`` and a name neither package
  knows, and with that unknown name as ``[engine] backend`` in
  ``.semmerge.toml``: exit code, stdout, work tree and notes
  byte-identical, and for the unknown name both log the JAX CLI's
  fallback warning.
- A daemon-served ``semmerge --inplace --backend tpu`` (a port daemon on
  the CPU, ``SEMMERGE_DAEMON=require``) gives the one-shot JAX CLI's
  bytes: the flag survives the wire.
- The names of the other engines (``java``, ``cs``, ``csharp``,
  ``subprocess``, ``worker``), by flag or by key, in the same repository
  with an interrupted commit's journal left in it: the JAX CLI's exit
  code, stdout, work tree, ``git status`` and notes for ``semdiff`` and
  ``semmerge --inplace`` (the port refused these names before it had
  those engines).
- Without a card and without ``--device cpu`` a name that runs the port's
  engine still exits 2 (``semdiff``) or 11 (``semmerge``): ``host`` does
  not mean the CPU.
- ``config.resolve_backend`` and ``config.refused_settings`` directly.
"""
import shutil
import subprocess
import sys

import pytest
import torch

from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.config import load_config, refused_settings, resolve_backend

from test_torch_service import (REPOS, WAIT, _env, make_repo, notes, start_daemon, status,
                                stop, tree_bytes, wait_for_hello)
from test_torch_strict import _git_status, _run_all

#: The names of the port's TypeScript engine, and of the other engines.
PORTED_BACKENDS = ("tpu", "ts_tpu", "host", "ts_host")
OTHER_BACKENDS = ("java", "cs", "csharp", "subprocess", "worker")
UNKNOWN = "bogus"
WARNING = f"Backend '{UNKNOWN}' unavailable"
COMMANDS = {"semdiff": ["semdiff", "basebr", "brA", "--json-out"],
            "semmerge": ["semmerge", "basebr", "brA", "brB", "--inplace"]}
#: case → (command, --backend value or None, .semmerge.toml text or None)
CASES = {f"{command}-flag-{name}": (command, name, None)
         for command in COMMANDS for name in PORTED_BACKENDS + (UNKNOWN,)}
CASES.update({f"{command}-key-{UNKNOWN}": (command, None, f'[engine]\nbackend = "{UNKNOWN}"\n')
              for command in COMMANDS})


def _repo(root, toml=None):
    """The rename/move repository of the service tests, at main."""
    make_repo(root, *REPOS["rename"])
    if toml is not None:
        (root / ".semmerge.toml").write_text(toml)
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both CLIs, all processes started together."""
    work = tmp_path_factory.mktemp("backend")
    origin = _repo(work / "origin")
    jobs = {}
    for case, (command, name, toml) in CASES.items():
        for side, module, extra in (("jax", "semantic_merge_tpu", []),
                                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            root = work / f"{case}-{side}"
            shutil.copytree(origin, root)
            if toml is not None:
                (root / ".semmerge.toml").write_text(toml)
            flag = ["--backend", name] if name else []
            jobs[case, side] = (root, [module, *COMMANDS[command], *flag, *extra])
    out = {"origin": origin}
    for key, (code, stdout, stderr) in _run_all(jobs, _env()).items():
        root = jobs[key][0]
        out[key] = {"code": code, "stdout": stdout, "stderr": stderr,
                    "tree": tree_bytes(root), "notes": notes(root)}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_backend_matches_the_jax_cli(runs, case):
    want, got = runs[case, "jax"], runs[case, "port"]
    assert want["code"] == 0, want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    unknown = UNKNOWN in case
    for run in (want, got):
        said = WARNING in run["stderr"] and "falling back to host" in run["stderr"]
        assert said == unknown, run["stderr"]


def test_backend_cases_show_what_they_are_named_for(runs):
    # Every name gives the same bytes: one op log, one merged file.
    diffs = {runs[case, "port"]["stdout"] for case in CASES if case.startswith("semdiff")}
    assert len(diffs) == 1 and '"type": "renameSymbol"' in diffs.pop()
    merged = {runs[case, "port"]["tree"]["lib/util.ts"]
              for case in CASES if case.startswith("semmerge")}
    assert len(merged) == 1 and b"function bar" in merged.pop()
    assert all(runs[case, "port"]["notes"]["brA"] for case in CASES
               if case.startswith("semmerge"))


@pytest.fixture(scope="module")
def served(runs, tmp_path_factory):
    """``semmerge --inplace --backend tpu`` from a client process through
    a port daemon on the CPU."""
    work = tmp_path_factory.mktemp("backend_svc")
    sock = work / "port.sock"
    proc = start_daemon(sock)
    try:
        wait_for_hello(sock, proc)
        root = work / "repo"
        shutil.copytree(runs["origin"], root)
        before = status(sock)["served_total"]
        out = subprocess.run(
            [sys.executable, "-m", "semantic_merge_tpu_torch", *COMMANDS["semmerge"],
             "--backend", "tpu", "--device", "cpu"], cwd=root,
            env=_env(SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(sock)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=WAIT)
        return {"code": out.returncode, "stdout": out.stdout, "stderr": out.stderr,
                "tree": tree_bytes(root), "notes": notes(root),
                "served": status(sock)["served_total"] - before}
    finally:
        stop(proc)


def test_daemon_serves_the_backend_flag_with_the_one_shot_bytes(runs, served):
    want = runs["semmerge-flag-tpu", "jax"]
    assert served["served"] == 1, served["stderr"]
    assert served["code"] == want["code"], served["stderr"]
    assert served["stdout"] == want["stdout"]
    assert served["tree"] == want["tree"]
    assert served["notes"] == want["notes"]


#: An interrupted ``--inplace`` commit's journal and stage: each merge
#: rolls it forward before anything else.
JOURNAL = '{"schema": 1, "state": "committing", "writes": ["src/util.ts"], "deletes": []}'


@pytest.fixture(scope="module")
def other_runs(runs, tmp_path_factory):
    """Each other engine's name, by flag and by key, through both CLIs
    (``semmerge --inplace`` then ``semdiff`` in one copy per package)."""
    work = tmp_path_factory.mktemp("backend_other")
    jobs, roots = {}, {}
    for name in OTHER_BACKENDS:
        for via in ("flag", "key"):
            for side, module, extra in (("jax", "semantic_merge_tpu", []),
                                        ("port", "semantic_merge_tpu_torch",
                                         ["--device", "cpu"])):
                root = roots[name, via, side] = work / f"{name}-{via}-{side}"
                shutil.copytree(runs["origin"], root)
                if via == "key":
                    (root / ".semmerge.toml").write_text(f'[engine]\nbackend = "{name}"\n')
                (root / ".semmerge-journal.json").write_text(JOURNAL)
                (root / ".semmerge-stage" / "src").mkdir(parents=True)
                (root / ".semmerge-stage" / "src" / "util.ts").write_text("staged\n")
                flag = ["--backend", name] if via == "flag" else []
                jobs[name, via, side] = (root, [module, *COMMANDS["semmerge"], *flag, *extra])
    out = {key: {"merge": (code, stdout)} for key, (code, stdout, _)
           in _run_all(jobs, _env()).items()}
    for key in jobs:
        root, argv = jobs[key]
        jobs[key] = (root, [argv[0], *COMMANDS["semdiff"], *argv[len(COMMANDS["semmerge"]) + 1:]])
    for key, (code, stdout, _) in _run_all(jobs, _env()).items():
        root = roots[key]
        out[key].update(diff=(code, stdout), tree=tree_bytes(root), notes=notes(root),
                        status=_git_status(root))
    return out


@pytest.mark.parametrize("via", ["flag", "key"])
@pytest.mark.parametrize("name", OTHER_BACKENDS)
def test_other_engines_exit_70_before_touching_the_tree(other_runs, name, via):
    """Named for when the port refused these engines (exit 70, the tree
    untouched): they run now, and give the JAX CLI's answer."""
    want, got = other_runs[name, via, "jax"], other_runs[name, via, "port"]
    assert want["merge"][0] in (0, 1)
    assert got == want
    # The journal was rolled forward, then the merge ran.
    assert not (set(got["tree"]) & {".semmerge-journal.json"})


@pytest.mark.parametrize("command,code", [("semdiff", 2), ("semmerge", 11)])
@pytest.mark.parametrize("name", ["tpu", "host", UNKNOWN])
def test_without_a_card_the_backend_keeps_the_device_exit(tmp_path, monkeypatch, capsys, name,
                                                          command, code):
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a CUDA device")
    repo = _repo(tmp_path / "repo")
    before = tree_bytes(repo)
    monkeypatch.setenv("SEMMERGE_DAEMON", "off")
    monkeypatch.chdir(repo)
    assert cli.main([*COMMANDS[command], "--backend", name]) == code
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err
    assert tree_bytes(repo) == before


@pytest.mark.parametrize("key,flag,want", [
    ("tpu", None, "tpu"), ("host", "ts_tpu", "ts_tpu"), ("ts_host", "", "ts_host"),
    (UNKNOWN, "host", "host"), ("tpu", UNKNOWN, "host"), (UNKNOWN, None, "host"),
    ("subprocess", None, "subprocess"), ("tpu", "java", "java")])
def test_resolve_backend_puts_the_flag_over_the_key(tmp_path, monkeypatch, caplog, key, flag,
                                                    want):
    for name in ("SEMMERGE_MESH", "SEMMERGE_FLEET", "SEMMERGE_OTLP"):
        monkeypatch.delenv(name, raising=False)
    (tmp_path / ".semmerge.toml").write_text(f'[engine]\nbackend = "{key}"\n')
    config = load_config(tmp_path)
    with caplog.at_level("WARNING", logger="semantic_merge_tpu_torch"):
        assert resolve_backend(config, flag) == want
    warned = [r.getMessage() for r in caplog.records if "falling back to host" in r.getMessage()]
    assert bool(warned) == ((flag or key) == UNKNOWN)
    # No engine name is refused: every one runs.
    assert refused_settings(config, "semmerge") == []
