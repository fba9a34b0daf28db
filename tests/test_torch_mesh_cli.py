"""The mesh through the port's CLI against the JAX CLI.

- ``semmerge --inplace --device cpu`` at world size 2: two rank
  processes over gloo with the ``SEMMERGE_COORDINATOR`` /
  ``SEMMERGE_NUM_PROCESSES`` / ``SEMMERGE_PROCESS_ID`` contract, each in
  its own copy of the repository (the same commits). Rank 0's copy ends
  with the JAX CLI's exit code, stdout, work tree, ``git status``, notes
  and ``.semmerge-conflicts.json`` (a clean merge and a divergent-rename
  conflict); rank 1 exits with rank 0's code, prints nothing and leaves
  its copy as it was (no lock, no trace, no notes, no artifact), though
  both ran with ``--trace``. Rank 0's trace shows the two-rank mesh.
- ``[engine] mesh_shape = "dp=1"`` at world size 1: the sharded programs
  on one device, the JAX CLI's bytes.
- The posture matrix at world size 1 (``off``/``auto``/``require`` in
  ``SEMMERGE_MESH`` and in ``[engine] mesh``) against JAX CLI processes
  on one CPU device: the environment's ``require`` merges on the host
  engine (exit 0), the config's exits 18 with ``MeshFault``; nothing
  exits 70.
- Port-only two-rank runs: ``semdiff`` without ``--device cpu`` and with
  no card visible exits 2 on both ranks before the group comes up (never
  a quiet CPU diff); when rank 0 raises after rank 1 has finished (its
  clean merge cannot remove a directory standing where the conflicts
  artifact goes), rank 1 leaves at once with rank 0's code, not after
  the group's timeout.
"""
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest

from semantic_merge_tpu_torch import cli

from test_torch_merge import REPO_ROOT, _make_repo, _notes, _tree_bytes

FOO = "export function foo(n: number): number {\n  return n;\n}\n"
MATH = ("export function add(a: number, b: number): number { return a + b; }\n"
        "export function mul(a: number, b: number): number { return a * b; }\n")
HELP = "export function help(s: string): string { return s; }\n"
BASE = {"src/util.ts": FOO, "src/math.ts": MATH, "src/help.ts": HELP, "README.md": "hi\n"}
REPOS = {
    "clean": (BASE,
              {"src/util.ts": FOO.replace("foo", "bar"), "README.md": "hi\nthere\n"},
              {"src/math.ts": None, "lib/math.ts": MATH,
               "src/extra.ts": "export function extra(x: number): number { return x; }\n"}),
    "conflict": (BASE, {"src/util.ts": FOO.replace("foo", "bar")},
                 {"src/util.ts": FOO.replace("foo", "baz")}),
}
MERGE = ["semmerge", "basebr", "branch-a", "branch-b", "--inplace"]
TELEMETRY = (".semmerge-trace.json", ".semmerge-events.jsonl")

#: name → (repository, world size, .semmerge.toml, environment)
CASES = {
    "world2_clean": ("clean", 2, None, {}),
    "world2_conflict": ("conflict", 2, None, {}),
    "mesh_shape_dp1": ("clean", 1, '[engine]\nmesh_shape = "dp=1"\n', {}),
    "env_off": ("clean", 1, None, {"SEMMERGE_MESH": "off"}),
    "env_auto": ("clean", 1, None, {"SEMMERGE_MESH": "auto"}),
    "env_require": ("clean", 1, None, {"SEMMERGE_MESH": "require"}),
    "config_off": ("clean", 1, '[engine]\nmesh = "off"\n', {}),
    "config_auto": ("clean", 1, '[engine]\nmesh = "auto"\n', {}),
    "config_require": ("clean", 1, '[engine]\nmesh = "require"\n', {}),
}
EXIT = {"world2_conflict": 1, "config_require": 18}
#: name → (argv, environment, a directory made in rank 0's copy): two
#: ranks of the port alone, on the clean repository.
RANK_CASES = {
    "world2_semdiff_no_card": (["semdiff", "basebr", "branch-a"], {"CUDA_VISIBLE_DEVICES": ""},
                               None),
    "world2_rank0_raises": ([*MERGE, "--device", "cpu"], {}, ".semmerge-conflicts.json"),
}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith(("SEMMERGE_", "JAX_"))}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               OMP_NUM_THREADS="1", **extra)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _status(root):
    out = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                         cwd=root, check=True, stdout=subprocess.PIPE, text=True).stdout
    return [line.split("/")[0] if ".semmerge-postmortem/" in line else line
            for line in out.splitlines() if not line.endswith(TELEMETRY)]


def _outputs(root, code, stdout):
    """What a run leaves: exit code, stdout, the tree (postmortem
    bundles as their reasons, telemetry apart), status and notes."""
    tree = {k: v for k, v in _tree_bytes(root).items() if not k.endswith(TELEMETRY)}
    bundles = sorted(json.loads(tree.pop(k))["reason"] for k in list(tree)
                     if k.startswith(".semmerge-postmortem/"))
    return {"code": code, "stdout": stdout, "tree": tree, "bundles": bundles,
            "status": _status(root), "notes": [_notes(root, r) for r in ("branch-a", "branch-b")]}


def _run_in_process(root, env, capsys):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
            mp.delenv(key)
        mp.setenv("SEMMERGE_DAEMON", "off")
        for key, value in env.items():
            mp.setenv(key, value)
        capsys.readouterr()
        code = cli.main([*MERGE, "--device", "cpu"])
        out, _err = capsys.readouterr()
    return code, out


class _Capture:
    """``capsys`` for a module-scoped fixture."""

    def __enter__(self):
        import io
        self._saved = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = io.StringIO(), io.StringIO()
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved

    def readouterr(self):
        out, err = sys.stdout.getvalue(), sys.stderr.getvalue()
        sys.stdout.seek(0)
        sys.stdout.truncate()
        sys.stderr.seek(0)
        sys.stderr.truncate()
        return out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_cli")
    origins = {}
    for name, (base, a, b) in REPOS.items():
        origins[name] = work / f"origin-{name}"
        _make_repo(origins[name], base, a, b)
    copies, procs = {}, {}
    for case, (repo, world, toml, env) in CASES.items():
        sides = ["jax", "port"] + (["rank1"] if world == 2 else [])
        for side in sides:
            copies[case, side] = work / f"{case}-{side}"
            shutil.copytree(origins[repo], copies[case, side])
            if toml:
                (copies[case, side] / ".semmerge.toml").write_text(toml)
        procs[case, "jax"] = subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu", *MERGE], cwd=copies[case, "jax"],
            env=_env(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if world == 2:
            contract = dict(SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}",
                            SEMMERGE_NUM_PROCESSES="2")
            for rank, side in enumerate(("port", "rank1")):
                procs[case, side] = subprocess.Popen(
                    [sys.executable, "-m", "semantic_merge_tpu_torch", *MERGE, "--device",
                     "cpu", "--trace"], cwd=copies[case, side],
                    env=_env(**contract, SEMMERGE_PROCESS_ID=str(rank)),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t_launch = time.monotonic()
    for case, (argv, env, blocker) in RANK_CASES.items():
        contract = dict(SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}",
                        SEMMERGE_NUM_PROCESSES="2", **env)
        for rank, side in enumerate(("port", "rank1")):
            copies[case, side] = work / f"{case}-{side}"
            shutil.copytree(origins["clean"], copies[case, side])
            if blocker and rank == 0:
                (copies[case, side] / blocker).mkdir()
                (copies[case, side] / blocker / "keep").write_text("")
            procs[case, side] = subprocess.Popen(
                [sys.executable, "-m", "semantic_merge_tpu_torch", *argv],
                cwd=copies[case, side], env=_env(**contract, SEMMERGE_PROCESS_ID=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rank1_before = {case: _outputs(copies[case, "rank1"], None, "")
                    for case, (_r, world, _t, _e) in CASES.items() if world == 2}
    out = {"rank1_before": rank1_before, "copies": copies}
    threshold = gc.get_threshold()
    try:
        with _Capture() as capsys:
            for case, (_repo, world, _toml, env) in CASES.items():
                if world == 1:
                    out[case, "port"] = _outputs(copies[case, "port"],
                                                 *_run_in_process(copies[case, "port"], env,
                                                                  capsys))
        for (case, side), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[case, side] = dict(_outputs(copies[case, side], proc.returncode, stdout),
                                   stderr=stderr, seconds=time.monotonic() - t_launch)
    finally:
        gc.unfreeze()
        gc.set_threshold(*threshold)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _bytes(run):
    return {k: run[k] for k in ("code", "stdout", "tree", "bundles", "status", "notes")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_gives_the_jax_clis_bytes(runs, case):
    port, jax_run = runs[case, "port"], runs[case, "jax"]
    assert _bytes(port) == _bytes(jax_run), (port.get("stderr"), jax_run["stderr"])
    assert port["code"] == EXIT.get(case, 0)


@pytest.mark.parametrize("case", ["world2_clean", "world2_conflict"])
def test_rank1_writes_nothing_and_takes_rank0s_code(runs, case):
    rank1, rank0 = runs[case, "rank1"], runs[case, "port"]
    assert rank1["code"] == rank0["code"] == EXIT.get(case, 0)
    assert rank1["stdout"] == ""
    assert _bytes(rank1) == dict(_bytes(runs["rank1_before"][case]), code=rank1["code"])
    root = runs["copies"][case, "rank1"]
    assert not any((root / name).exists() for name in
                   (*TELEMETRY, ".semmerge-inplace.lock", ".semmerge-conflicts.json",
                    ".semmerge-postmortem"))
    assert "process 1/2" in rank1["stderr"] and "process 0/2" in rank0["stderr"]


def test_rank0s_trace_shows_the_two_rank_mesh(runs):
    trace = json.loads((runs["copies"]["world2_clean", "port"] / TELEMETRY[0]).read_text())
    gauges = trace["metrics"]["gauges"]

    def gauge(name, **labels):
        (value,) = [s["value"] for s in gauges[name]["series"] if s["labels"] == labels]
        return value

    assert gauge("semmerge_distributed_processes") == 2
    assert gauge("semmerge_mesh_devices") == 2 and gauge("semmerge_mesh_axis_size", axis="dp") == 2


def test_config_require_is_a_mesh_fault_and_env_require_falls_back(runs):
    assert runs["config_require", "port"]["bundles"] == ["fault-escape"]
    assert "MeshFault" in runs["config_require", "jax"]["stderr"]
    for side in ("port", "jax"):
        assert runs["env_require", side]["code"] == 0
    assert "falling back to host" in runs["env_require", "jax"]["stderr"]


def test_semdiff_ranks_without_a_card_exit_2_before_the_group(runs):
    for side in ("port", "rank1"):
        run = runs["world2_semdiff_no_card", side]
        assert run["code"] == 2, run["stderr"]
        assert run["stdout"] == ""
        assert "no CUDA device" in run["stderr"]
        assert "torch.distributed up" not in run["stderr"]


def test_rank1_leaves_with_rank0s_code_when_rank0_raises(runs):
    rank0, rank1 = runs["world2_rank0_raises", "port"], runs["world2_rank0_raises", "rank1"]
    assert "IsADirectoryError" in rank0["stderr"]
    assert rank0["code"] == rank1["code"] == 1
    assert "Traceback" not in rank1["stderr"] and rank1["stdout"] == ""
    # Well inside the group's 600 s timeout: rank 1 left with the broadcast.
    assert rank1["seconds"] < 120
