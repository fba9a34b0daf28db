"""The port's three-way merge against the JAX package's.

- ``diff_lift_device_pair``: the same seeded ``DeclTensor`` columns
  through JAX's and the port's pair diff; every column byte-equal.
- Backend level: ``TorchTSBackend(device="cpu").merge`` with the
  changeSignature matcher (its checkpoint converted from the JAX
  ``PRNGKey(0)`` parameters) against ``TpuTSBackend(mesh=False).merge``
  with the JAX matcher (``allow_untrained=True, seed=0``): both op logs,
  the composed stream and the conflicts equal as ``to_dict()``.
- CLI level, in scratch git repositories: ``python -m
  semantic_merge_tpu_torch semmerge ... --device cpu`` against ``python
  -m semantic_merge_tpu semmerge ... --backend tpu``, each in its own
  fresh copy of the repository (so the notes do not collide): the exit
  code, every work-tree file's bytes, ``.semmerge-conflicts.json``'s
  bytes and ``git notes --ref semmerge show`` of A and B must be equal.
  Without ``--change-signature`` both take their fused path. The same
  for ``semdiff`` (pretty and ``--json-out``), and for a ``semmerge
  --inplace`` whose notes are rendered on the device in both packages
  (``SEMMERGE_RENDER_MIN_ROWS=1``).
"""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.core.encode import DeclTensor as JaxDeclTensor
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.encoder import init_encoder
from semantic_merge_tpu.models.signature import EmbeddingSignatureMatcher as JaxMatcher
from semantic_merge_tpu.ops.diff import diff_lift_device_pair as jax_diff_pair
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.core.encode import DeclTensor
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.models.matcher import params_from_jax, save_matcher_checkpoint
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher
from semantic_merge_tpu_torch.ops.diff import diff_lift_device_pair

from test_signature_matcher import BASE, SIDE

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
COLUMNS = ("kind", "sym", "a_addr", "a_name", "a_file", "b_addr", "b_name", "b_file")


# --- the pair diff -------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_diff_pair_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n_sym = rs.randint(2, 30)

    def cols(n):
        return tuple(np.asarray(c, dtype=np.int32) for c in (
            rs.randint(0, n_sym, n), rs.randint(0, 60, n), rs.randint(-1, 8, n),
            rs.randint(0, 5, n)))

    # Seed 0 pads 0-8 rows to 8, the others 33-48 rows to 48: two padded
    # shapes, so the JAX program compiles twice.
    sizes = (33, 49) if seed else (0, 9)
    sides = [cols(rs.randint(*sizes)) for _ in range(3)]
    want = jax_diff_pair(*(JaxDeclTensor(*c, len(c[0])) for c in sides))
    got = diff_lift_device_pair(*(DeclTensor(*c, len(c[0])) for c in sides),
                                torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.n_ops == w.n_ops
        for col in COLUMNS:
            a, b = getattr(g, col), getattr(w, col)
            assert a.dtype == b.dtype == np.int32, col
            assert a.tobytes() == b.tobytes(), col


# --- the backend's merge with the matcher ----------------------------------------

@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    params = init_encoder(jax.random.PRNGKey(0), JaxEncoderConfig())
    ckpt = tmp_path_factory.mktemp("matcher")
    save_matcher_checkpoint(ckpt, params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return ckpt


_SHARED = ("export function shared(x: number): number {\n  return x;\n}\n"
           "export function keepMe(s: string[]): boolean {\n  return !s;\n}\n")

#: (base, left, right) path→content. Left renames AND retypes
#: computeTotal (the matcher's pair) and renames ``shared``; right moves
#: a.ts to lib/ and, in the conflict case, renames ``shared`` too.
MERGES = {
    "clean": ({"a.ts": BASE, "b.ts": _SHARED},
              {"a.ts": SIDE, "b.ts": _SHARED.replace("shared", "sharedLeft")},
              {"lib/a.ts": BASE, "b.ts": _SHARED}),
    "divergent_rename": ({"a.ts": BASE, "b.ts": _SHARED},
                         {"a.ts": SIDE, "b.ts": _SHARED.replace("shared", "sharedLeft")},
                         {"lib/a.ts": BASE, "b.ts": _SHARED.replace("shared", "sharedRight")}),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_backend_merge_with_matcher_matches_jax(port_ckpt, case):
    trees = MERGES[case]
    kw = dict(base_rev="r0", seed="s", timestamp="2024-01-01T00:00:00Z",
              change_signature=True)

    def snaps(cls):
        return [cls(files=[{"path": p, "content": c} for p, c in sorted(t.items())])
                for t in trees]

    want = TpuTSBackend(mesh=False).merge(
        *snaps(JaxSnapshot), **kw,
        signature_matcher=JaxMatcher(threshold=0.85, allow_untrained=True, seed=0))
    matcher = EmbeddingSignatureMatcher(threshold=0.85, ckpt_dir=str(port_ckpt), device="cpu")
    backend = TorchTSBackend(device="cpu")
    got = backend.merge(*snaps(Snapshot), **kw, signature_matcher=matcher)
    assert matcher.encoder is not None  # the matcher scored the residuals

    def dicts(res):
        result, composed, conflicts = res
        return ([o.to_dict() for o in result.op_log_left],
                [o.to_dict() for o in result.op_log_right],
                [o.to_dict() for o in composed], [c.to_dict() for c in conflicts])

    assert dicts(got) == dicts(want)
    left, _, composed, conflicts = dicts(got)
    assert "changeSignature" in [o["type"] for o in left]
    assert len(conflicts) == (case == "divergent_rename")
    assert {"scan", "encode", "device_diff", "decode", "refine", "lift",
            "compose"} <= set(backend.phases)


# --- CLI parity in scratch git repositories ------------------------------------

_UTIL = "export function foo(n: number): number {\n  return n;\n}\n"
_README = "".join(f"line{i}\n" for i in range(1, 9))

#: Records its arguments (the touched-scope paths) into the merged tree.
_ARG_RECORDER = 'formatter_cmd = ["sh", "-c", "printf \'%s\\\\n\' \\"$@\\" > formatted.txt", "fmt"]'
_JOURNAL = '{"schema": 1, "state": "committing", "writes": ["src/util.ts", "lib/x.ts"], "deletes": []}'

#: name → (base files, A's edits, B's edits, CLI flags, untracked files
#: written into the work tree before the run); an edit maps a path to
#: new content, or to None to delete it.
CLI_CASES = {
    "rename_vs_move": (
        {"src/util.ts": _UTIL}, {"src/util.ts": _UTIL.replace("foo", "bar")},
        {"src/util.ts": None, "lib/util.ts": _UTIL}, [], {}),
    "divergent_rename_with_seed": (
        {"src/util.ts": _UTIL}, {"src/util.ts": _UTIL.replace("foo", "bar")},
        {"src/util.ts": _UTIL.replace("foo", "baz")}, ["--seed", "s1"], {}),
    "text_layer_touched_formatter": (
        {"src/util.ts": _UTIL, "README.md": _README, "notes.txt": "a\nb\n"},
        {"src/util.ts": _UTIL.replace("foo", "bar"),
         "README.md": _README.replace("line1\n", "LINE1\n"), "notes.txt": None},
        {"README.md": _README.replace("line8\n", "LINE8\n"), "data.json": "{}\n",
         "src/util.ts": None, "lib/util.ts": _UTIL},
        ["--inplace"],
        {".semmerge.toml": f'[engine]\nformatter_scope = "touched"\n'
                           f'[languages.typescript]\n{_ARG_RECORDER}\n'
                           '[ci]\nrequire_typecheck = false\n'}),
    "text_conflict": (
        {"README.md": _README}, {"README.md": _README.replace("line4", "A4")},
        {"README.md": _README.replace("line4", "B4")}, [], {}),
    "inplace": (
        {"src/util.ts": _UTIL, "src/other.ts": "export class P {\n  x = 1;\n}\n",
         "README.md": _README},
        {"src/util.ts": _UTIL.replace("foo", "bar"),
         "README.md": _README.replace("line2\n", "LINE2\n")},
        {"src/util.ts": None, "lib/util.ts": _UTIL,
         "src/other.ts": "export class P {\n  x = 1;\n}\nexport enum E { A, B }\n",
         "README.md": _README.replace("line7\n", "LINE7\n")},
        ["--inplace", "--change-signature", "--signature-matcher"], {}),
    "resume_rolls_forward": (
        {"src/util.ts": _UTIL}, {}, {}, ["--resume"],
        {".semmerge-journal.json": _JOURNAL, ".semmerge-stage/src/util.ts": "staged\n",
         ".semmerge-stage/lib/x.ts": "x\n"}),
}
#: (exit code, notes written) each case must give (both CLIs).
CLI_EXPECT = {"rename_vs_move": (0, True), "divergent_rename_with_seed": (1, False),
              "text_layer_touched_formatter": (0, True), "text_conflict": (1, False),
              "inplace": (0, True), "resume_rolls_forward": (0, False)}


def _git(args, cwd):
    env = dict(os.environ, GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-02T03:04:05Z")
    subprocess.run(["git", *args], cwd=cwd, check=True, env=env,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _commit_on(root, branch, edits, start="basebr"):
    _git(["checkout", "-q", "-b", branch, start], root)
    for path, text in edits.items():
        if text is None:
            (root / path).unlink()
        else:
            (root / path).parent.mkdir(parents=True, exist_ok=True)
            (root / path).write_text(text)
    _git(["add", "-A"], root)
    _git(["commit", "-q", "--allow-empty", "-m", branch], root)


def _make_repo(root, base, a, b):
    root.mkdir(parents=True)
    _git(["init", "-q", "-b", "main"], root)
    _git(["config", "user.email", "t@example.com"], root)
    _git(["config", "user.name", "t"], root)
    for path, text in base.items():
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).write_text(text)
    _git(["add", "-A"], root)
    _git(["commit", "-q", "-m", "base"], root)
    _git(["branch", "basebr"], root)
    _commit_on(root, "branch-a", a)
    _commit_on(root, "branch-b", b)
    _git(["checkout", "-q", "branch-a"], root)


def _tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and ".git" not in p.relative_to(root).parts}


def _notes(root, rev):
    out = subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    return out.returncode, out.stdout


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every case through both CLIs, all processes started together."""
    work = tmp_path_factory.mktemp("cli")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    procs = {}
    for case, (base, a, b, flags, untracked) in CLI_CASES.items():
        origin = work / case / "origin"
        _make_repo(origin, base, a, b)
        for path, text in untracked.items():
            (origin / path).parent.mkdir(parents=True, exist_ok=True)
            (origin / path).write_text(text)
        for side, module, extra in (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
                                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            copy = work / case / side
            shutil.copytree(origin, copy)
            procs[case, side] = (copy, subprocess.Popen(
                [sys.executable, "-m", module, "semmerge", "basebr", "branch-a",
                 "branch-b", *flags, *extra], cwd=copy, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    runs = {}
    try:
        for key, (copy, proc) in procs.items():
            out, err = proc.communicate(timeout=300)
            runs[key] = {"code": proc.returncode, "stdout": out, "stderr": err,
                         "tree": _tree_bytes(copy),
                         "notes": [_notes(copy, rev) for rev in ("branch-a", "branch-b")]}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_semmerge_matches_jax_cli(cli_runs, case):
    want, got = cli_runs[case, "jax"], cli_runs[case, "port"]
    code, notes_written = CLI_EXPECT[case]
    assert want["code"] == code, want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    artifact = ".semmerge-conflicts.json"
    assert (artifact in got["tree"]) == (code == 1)
    assert got["tree"].get(artifact) == want["tree"].get(artifact)
    assert got["notes"] == want["notes"]
    assert all((rc == 0) == notes_written for rc, _ in got["notes"])


def test_cli_cases_show_what_they_are_named_for(cli_runs):
    tree = cli_runs["text_layer_touched_formatter", "port"]["tree"]
    # The text-merged files of formatter suffixes and the op paths that
    # still exist (src/util.ts moved away), sorted.
    assert tree["formatted.txt"] == b"README.md\ndata.json\nlib/util.ts\n"
    assert b"function bar" in tree["lib/util.ts"]
    assert tree["README.md"] == _README.replace("line1", "LINE1").replace("line8", "LINE8").encode()
    resumed = cli_runs["resume_rolls_forward", "port"]
    assert resumed["stdout"] == "inplace recovery: rolled-forward (2 writes)\n"
    assert resumed["tree"]["src/util.ts"] == b"staged\n" and "lib/x.ts" in resumed["tree"]


# --- the fused path through the CLI ---------------------------------------------

_FUSED_BASE = {f"src/m{i}.ts": f"export function f{i}(a{i}: number, b: {t}): void {{ f{i}; }}\n"
               for i, t in enumerate(("string", "boolean", "bigint", "object"))}
_FUSED_BASE["README.md"] = _README
_FUSED_A = {"src/m0.ts": _FUSED_BASE["src/m0.ts"].replace("f0", "g0"),
            "src/m1.ts": _FUSED_BASE["src/m1.ts"].replace("f1", "g1"),
            "src/new.ts": "export function added(q: string): string { return q; }\n",
            "README.md": _README.replace("line1\n", "A1\n")}
_FUSED_B = {"src/m0.ts": None, "lib/m0.ts": _FUSED_BASE["src/m0.ts"],
            "src/m3.ts": None, "README.md": _README.replace("line8\n", "B8\n")}

#: name → (argv after the module, extra environment)
FUSED_RUNS = {
    "semdiff_json": (["semdiff", "basebr", "branch-a", "--json-out"], {}),
    "semdiff_pretty": (["semdiff", "basebr", "branch-b"], {}),
    "semmerge_rendered_notes": (["semmerge", "basebr", "branch-a", "branch-b", "--inplace"],
                                {"SEMMERGE_RENDER_MIN_ROWS": "1"}),
}


@pytest.fixture(scope="module")
def fused_cli_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("fused_cli")
    origin = work / "origin"
    _make_repo(origin, _FUSED_BASE, _FUSED_A, _FUSED_B)
    base_env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    base_env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    procs = {}
    for name, (argv, extra) in FUSED_RUNS.items():
        for side, module, flag in (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
                                   ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            copy = work / name / side
            shutil.copytree(origin, copy)
            procs[name, side] = (copy, subprocess.Popen(
                [sys.executable, "-m", module, *argv, *flag], cwd=copy,
                env=dict(base_env, **extra), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    runs = {}
    try:
        for key, (copy, proc) in procs.items():
            out, err = proc.communicate(timeout=300)
            runs[key] = {"code": proc.returncode, "stdout": out, "stderr": err,
                         "tree": _tree_bytes(copy),
                         "notes": [_notes(copy, rev) for rev in ("branch-a", "branch-b")]}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


@pytest.mark.parametrize("name", sorted(FUSED_RUNS))
def test_cli_fused_path_matches_jax_cli(fused_cli_runs, name):
    want, got = fused_cli_runs[name, "jax"], fused_cli_runs[name, "port"]
    assert want["code"] == 0, want["stderr"]
    assert got["code"] == 0, got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    if name.startswith("semdiff"):
        assert got["stdout"].strip()
    else:
        assert all(rc == 0 and out.startswith(b"[{") for rc, out in got["notes"])
        assert b"function g0" in got["tree"]["lib/m0.ts"]
