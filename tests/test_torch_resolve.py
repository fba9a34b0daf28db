"""The port's conflict-resolution tier against the JAX package's.

CLI level: each case of ``tests/test_resolve.py`` runs ``python -m
semantic_merge_tpu_torch semmerge basebr brA brB --inplace ...
--device cpu`` and ``python -m semantic_merge_tpu semmerge ...
--backend tpu`` (``JAX_PLATFORMS=cpu``) in fresh copies of its
repository; the exit code, every work-tree file's bytes, ``git status
--porcelain`` and both notes must be equal, and so must
``.semmerge-conflicts.json`` once every gate's ``"ms"`` is masked (the
gates' wall times). Added: a resolver fault under ``--resolve require``
(exit 17 with the artifact written, for ``resolver:propose`` and
``resolver:verify``), the same fault contained under ``auto`` (exit 1),
and ``--resolve off``. ``test_breaker_open_skips_propose`` has no
counterpart: the circuit breakers are not ported (they are a no-op
outside the JAX package's daemon unless ``SEMMERGE_BREAKER=on``).

In process: the gate rejection of a resolver that drops nothing, in
both packages; the port's ``recompose_resolved`` (the device compose, on
the CPU) against the JAX package's (its host composer) on every pair of
rewritten streams the resolver produces in the cases that reach the
gates; the search resolver's candidates, its line-level three-way merge
and its reference counts against the JAX package's; the posture.
"""
import io
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys
import tarfile

import pytest

from semantic_merge_tpu.cli import main as jax_main
from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.ops.compose import recompose_resolved as jax_recompose
from semantic_merge_tpu.resolve import posture as jax_posture
from semantic_merge_tpu.resolve.base import Candidate as JaxCandidate
from semantic_merge_tpu.resolve.base import ResolveContext as JaxContext
from semantic_merge_tpu.resolve.base import Resolver as JaxResolver
from semantic_merge_tpu.resolve.search import SearchResolver as JaxSearch
from semantic_merge_tpu.resolve.search import _merge3_lines as jax_merge3
from semantic_merge_tpu.resolve.search import _refs as jax_refs
from semantic_merge_tpu.service.resilience import breakers as jax_breakers
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.core.ops import Op, Target
from semantic_merge_tpu_torch.ops import compose as port_compose
from semantic_merge_tpu_torch.resolve import posture
from semantic_merge_tpu_torch.resolve.base import Candidate, ResolveContext, Resolver
from semantic_merge_tpu_torch.resolve.search import SearchResolver, _refs, merge3_lines
from semantic_merge_tpu_torch.utils import faults

from test_resolve import UTIL_A_BAR, UTIL_B_BAZ, UTIL_BASE, make_repo

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACT = ".semmerge-conflicts.json"
#: Flight-recorder bundles (times and pids; compared in tests/test_torch_trace.py).
JAX_ONLY = ".semmerge-postmortem"

_FOO = "export function foo(n: number): number {\n  return n;\n}\n"
_USE = ("import { foo } from './foo';\n"
        "export function use(s: string): number {\n"
        "  return foo(s.length);\n}\n")
_CALC = ("export function calc(n: number): number {\n"
         "  n = n + 1;\n"
         "  n = n * 2;\n"
         "  return n;\n"
         "}\n")

#: Files in the many-renames repository: each renames its function to
#: ``left<i>`` on brA (and adds a caller of it) and to ``right<i>`` on brB.
N_RENAMES = 24


def _fn(i, name):
    return f"export function {name}(n: number): number {{\n  return n + {i};\n}}\n"


def _many_renames():
    paths = [f"src/mod{i:03d}.ts" for i in range(N_RENAMES)]
    return ({p: _fn(i, f"fn{i}") for i, p in enumerate(paths)},
            {p: _fn(i, f"left{i}") + f"export function use{i}(s: string): number {{\n"
                f"  return left{i}(s.length);\n}}\n" for i, p in enumerate(paths)},
            {p: _fn(i, f"right{i}") for i, p in enumerate(paths)})


#: name → (base, brA, brB) trees
TREES = {
    "rename": ({"src/util.ts": UTIL_BASE}, {"src/util.ts": UTIL_A_BAR},
               {"src/util.ts": UTIL_B_BAZ}),
    "delete_vs_edit": (
        {"src/foo.ts": _FOO, "src/use.ts": _USE},
        {"src/foo.ts": _FOO.replace("return n;", "return n + 1;"), "src/use.ts": _USE},
        {"src/foo.ts": "",
         "src/use.ts": "export function use(s: string): number {\n  return s.length;\n}\n"}),
    "calc": ({"src/calc.ts": _CALC},
             {"src/calc.ts": _CALC.replace("n = n + 1;", "n = n + 3;")},
             {"src/calc.ts": _CALC.replace("n = n * 2;", "n = n * 4;")}),
    "overlap": ({"a.ts": "export function foo(n: number): number { return 0; }\n"},
                {"a.ts": "export function foo(n: number): number { return 1; }\n"},
                {"a.ts": "export function foo(n: number): number { return 2; }\n"}),
    "tie": ({"src/util.ts": _FOO}, {"src/util.ts": _FOO.replace("foo", "bar")},
            {"src/util.ts": _FOO.replace("foo", "baz")}),
    "many_renames": _many_renames(),
}

#: name → (trees, flags, environment, exit code)
CASES = {
    "divergent_rename_resolved": ("rename", ["--resolve"], {}, 0),
    "delete_vs_edit_resolved": ("delete_vs_edit", ["--resolve", "auto", "--strict-conflicts",
                                                   "--structured-apply"], {}, 0),
    "concurrent_stmt_edit_resolved": ("calc", ["--resolve", "auto", "--strict-conflicts"],
                                      {}, 0),
    "overlapping_stmt_edits_fall_back": ("overlap", ["--resolve", "auto",
                                                     "--strict-conflicts"], {}, 1),
    "symmetric_renames_tie": ("tie", [], {"SEMMERGE_RESOLVE": "auto"}, 1),
    "strict_env_keeps_resolver_inert": ("rename", [], {"SEMMERGE_RESOLVE": "auto",
                                                       "SEMMERGE_STRICT": "1"}, 1),
    "no_degrade_keeps_resolver_inert": ("rename", ["--no-degrade"],
                                        {"SEMMERGE_RESOLVE": "auto"}, 1),
    "require_tie_is_conflict_as_result": ("tie", ["--resolve", "require"], {}, 1),
    "require_propose_fault_exits_17": ("rename", ["--resolve", "require"],
                                       {"SEMMERGE_FAULT": "resolver:propose:fault"}, 17),
    "require_verify_fault_exits_17": ("rename", ["--resolve", "require"],
                                      {"SEMMERGE_FAULT": "resolver:verify:fault"}, 17),
    "auto_propose_fault_is_contained": ("rename", ["--resolve", "auto"],
                                        {"SEMMERGE_FAULT": "resolver:propose:fault"}, 1),
    "resolve_off": ("rename", ["--resolve", "off"], {"SEMMERGE_RESOLVE": "auto"}, 1),
    "many_divergent_renames": ("many_renames", ["--resolve", "auto"], {}, 0),
    "many_divergent_renames_strict": ("many_renames", ["--resolve", "auto",
                                                       "--strict-conflicts"], {}, 1),
}


def _tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and not {".git", JAX_ONLY} & set(p.relative_to(root).parts)}


def _status(root):
    out = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                         cwd=root, check=True, stdout=subprocess.PIPE, text=True).stdout
    return [line for line in out.splitlines() if JAX_ONLY not in line]


def _notes(root):
    return [subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL).stdout
            for rev in ("brA", "brB")]


def masked(payload):
    """The artifact with every gate's wall time set to 0."""
    if isinstance(payload, dict):
        for rec in payload.get("resolutions", []):
            for gate in rec.get("gates", []):
                gate["ms"] = 0
    return payload


def _run_all(jobs, limit=8):
    """Runs ``jobs`` ({key: (cwd, argv, env)}), at most ``limit`` at
    once; returns {key: (exit code, stdout, stderr)}."""
    pending, running, done = list(jobs.items()), {}, {}
    try:
        while pending or running:
            while pending and len(running) < limit:
                key, (cwd, argv, env) = pending.pop(0)
                running[key] = subprocess.Popen(
                    [sys.executable, "-m", *argv], cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            key = next(iter(running))
            proc = running.pop(key)
            out, err = proc.communicate(timeout=300)
            done[key] = (proc.returncode, out, err)
    finally:
        for proc in running.values():
            proc.kill()
            proc.wait()
    return done


@pytest.fixture(scope="module")
def origins(tmp_path_factory):
    work = tmp_path_factory.mktemp("resolve_origins")
    return {name: make_repo(work / name, *trees) for name, trees in TREES.items()}


@pytest.fixture(scope="module")
def resolve_runs(tmp_path_factory, origins):
    work = tmp_path_factory.mktemp("resolve_cli")
    base_env = {k: v for k, v in os.environ.items()
                if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    base_env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    jobs, copies = {}, {}
    for case, (trees, flags, env, _) in CASES.items():
        for side, module, extra in (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
                                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            copy = work / f"{case}-{side}"
            shutil.copytree(origins[trees], copy)
            copies[case, side] = copy
            jobs[case, side] = (copy, [module, "semmerge", "basebr", "brA", "brB",
                                       "--inplace", *flags, *extra], dict(base_env, **env))
    runs = {}
    for key, (code, out, err) in _run_all(jobs).items():
        copy = copies[key]
        tree = _tree_bytes(copy)
        artifact = tree.pop(ARTIFACT, None)
        runs[key] = {"code": code, "stdout": out, "stderr": err, "tree": tree,
                     "artifact": None if artifact is None else json.loads(artifact),
                     "status": _status(copy), "notes": _notes(copy)}
    return runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_resolve_matches_jax_cli(resolve_runs, case):
    want, got = resolve_runs[case, "jax"], resolve_runs[case, "port"]
    assert want["code"] == CASES[case][-1], want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["status"] == want["status"]
    assert got["notes"] == want["notes"]
    assert got["artifact"] is not None
    assert masked(got["artifact"]) == masked(want["artifact"])


def test_cli_resolve_cases_show_what_they_are_named_for(resolve_runs):
    def port(case):
        return resolve_runs[case, "port"]

    got = port("divergent_rename_resolved")
    text = got["tree"]["src/util.ts"].decode()
    assert "return bar(s.length)" in text and "baz" not in text
    (rec,) = got["artifact"]["resolutions"]
    assert rec["status"] == "accepted" and rec["candidate"]["id"] == "keepA"
    assert rec["scores"] == {"keepA": 2, "keepB": 1}
    assert [g["gate"] for g in rec["gates"]] == ["recompose", "parity", "typecheck", "format"]
    assert all(g["ok"] for g in rec["gates"])
    assert got["artifact"]["schema_version"] == 2
    recs = {r["category"]: r for r in port("delete_vs_edit_resolved")["artifact"]["resolutions"]}
    assert recs["DeleteVsEdit"]["candidate"]["id"] == "keepDelete"
    calc = port("concurrent_stmt_edit_resolved")["tree"]["src/calc.ts"].decode()
    assert "n = n + 3;" in calc and "n = n * 4;" in calc
    (rec,) = [r for r in port("overlapping_stmt_edits_fall_back")["artifact"]["resolutions"]
              if r["category"] == "ConcurrentStmtEdit"]
    assert rec["cause"] == "no-candidates"
    (rec,) = port("symmetric_renames_tie")["artifact"]["resolutions"]
    assert rec["cause"] == "tie" and rec["scores"] == {"keepA": 1, "keepB": 1}
    for case in ("strict_env_keeps_resolver_inert", "no_degrade_keeps_resolver_inert",
                 "require_propose_fault_exits_17", "require_verify_fault_exits_17",
                 "auto_propose_fault_is_contained", "resolve_off"):
        assert isinstance(port(case)["artifact"], list), case  # the tier's audit is absent
    assert "ResolveFault" in port("require_propose_fault_exits_17")["stderr"]


def test_divergent_renames_surface_only_where_cursor_heads_meet(resolve_runs):
    """The parity compose reports a DivergentRename only when the two
    streams' cursor heads are renames of one symbol (``core/compose.py``
    of the JAX package). With many divergent renames in one merge, the
    op ids order each side's renames differently, so the walk meets the
    heads for a few pairs: those are reported, and resolved for brA (two
    references against one); every other pair is composed with no
    conflict, and its function keeps its base name. Under
    ``--strict-conflicts`` the reported pair also brings a DivergentMove
    (the address holds the name), which no strategy resolves, so its
    rename is rejected with it and the merge exits 1. The JAX CLI gives
    the same conflicts, exit code, gates and tree
    (``test_cli_resolve_matches_jax_cli``)."""
    got = resolve_runs["many_divergent_renames", "port"]
    conflicts = got["artifact"]["conflicts"]
    assert 1 <= len(conflicts) < N_RENAMES
    assert {c["category"] for c in conflicts} == {"DivergentRename"}
    recs = got["artifact"]["resolutions"]
    assert len(recs) == len(conflicts)
    assert {(r["status"], r["candidate"]["id"]) for r in recs} == {("accepted", "keepA")}
    reported = {c["addressIds"]["A"].split("::")[0] for c in conflicts}
    for i in range(N_RENAMES):
        path = f"src/mod{i:03d}.ts"
        name = f"left{i}" if path in reported else f"fn{i}"
        assert f"function {name}(" in got["tree"][path].decode(), path
        assert f"function right{i}(" not in got["tree"][path].decode()
    strict = resolve_runs["many_divergent_renames_strict", "port"]["artifact"]
    assert len(strict["conflicts"]) < N_RENAMES
    assert ({(r["category"], r["status"], r["cause"]) for r in strict["resolutions"]}
            == {("DivergentMove", "rejected", "no-candidates"),
                ("DivergentRename", "rejected", "peer-unresolved")})


# --- in process ------------------------------------------------------------------

def _in_process(tmp_path, monkeypatch, origin, name):
    copy = tmp_path / name
    shutil.copytree(origin, copy)
    monkeypatch.chdir(copy)
    return copy


@pytest.fixture
def clean_env(monkeypatch):
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    faults.reset()
    jax_breakers().reset()
    yield
    faults.reset()
    jax_breakers().reset()


def test_gate_rejection_falls_back_as_in_jax(tmp_path, monkeypatch, origins, clean_env):
    """A candidate that drops nothing fails the recompose gate in both
    packages: exit 1, the tree of a resolver-off run, the same audit."""

    class JaxNoop(JaxResolver):
        name = "noop"

        def propose(self, conflict, ctx):
            return [JaxCandidate(id="noop", label="change nothing", rationale="test",
                                 score=1)]

    class PortNoop(Resolver):
        name = "noop"

        def propose(self, conflict, ctx):
            return [Candidate(id="noop", label="change nothing", rationale="test", score=1)]

    monkeypatch.setattr("semantic_merge_tpu.resolve.engine.SearchResolver", JaxNoop)
    monkeypatch.setattr("semantic_merge_tpu_torch.resolve.engine.SearchResolver", PortNoop)
    monkeypatch.setenv("SEMMERGE_RESOLVE", "auto")
    out = {}
    for side, run in (("jax", lambda: jax_main(["semmerge", "basebr", "brA", "brB",
                                                "--inplace", "--backend", "tpu"])),
                      ("port", lambda: cli.main(["semmerge", "basebr", "brA", "brB",
                                                 "--inplace", "--device", "cpu"]))):
        copy = _in_process(tmp_path, monkeypatch, origins["rename"], side)
        code = run()
        tree = _tree_bytes(copy)
        out[side] = (code, masked(json.loads(tree.pop(ARTIFACT))), tree)
    assert out["port"] == out["jax"]
    code, payload, _ = out["port"]
    (rec,) = payload["resolutions"]
    assert code == 1 and rec["cause"] == "gate:recompose"
    assert "residual" in rec["gates"][0]["detail"]


#: Cases whose tier reaches the recompose gate.
RECOMPOSED = ("divergent_rename_resolved", "delete_vs_edit_resolved",
              "concurrent_stmt_edit_resolved")


@pytest.mark.parametrize("case", RECOMPOSED)
def test_recompose_resolved_matches_jax(tmp_path, monkeypatch, origins, clean_env, case):
    trees, flags, env, code = CASES[case]
    calls = []
    real = port_compose.recompose_resolved

    def capture(delta_a, delta_b, device=None):
        out = real(delta_a, delta_b, device)
        calls.append((list(delta_a), list(delta_b), out))
        return out

    monkeypatch.setattr(port_compose, "recompose_resolved", capture)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _in_process(tmp_path, monkeypatch, origins[trees], "port")
    assert cli.main(["semmerge", "basebr", "brA", "brB", "--inplace", *flags,
                     "--device", "cpu"]) == code
    assert calls, "the tier did not reach the recompose gate"
    for delta_a, delta_b, (composed, conflicts) in calls:
        want, want_conflicts = jax_recompose(
            [JaxOp.from_dict(o.to_dict()) for o in delta_a],
            [JaxOp.from_dict(o.to_dict()) for o in delta_b])
        assert [o.to_dict() for o in composed] == [o.to_dict() for o in want]
        assert ([c.to_dict() for c in conflicts]
                == [c.to_dict() for c in want_conflicts])
        assert composed  # the rewritten streams compose to something


def test_posture_matches_jax(monkeypatch):
    for raw in (None, "auto", "REQUIRE", "off", "bogus", " auto "):
        if raw is None:
            monkeypatch.delenv("SEMMERGE_RESOLVE", raising=False)
        else:
            monkeypatch.setenv("SEMMERGE_RESOLVE", raw)
        assert posture() == jax_posture()
    monkeypatch.setenv("SEMMERGE_RESOLVE", "auto")
    flag = type("Args", (), {"resolve": "require"})()
    assert posture(flag) == jax_posture(flag) == "require"


MERGE3 = [("a\nb\nc\n", "A\nb\nc\n", "a\nb\nC\n"), ("a\nb\nc\n", "A\nb\nc\n", "X\nb\nc\n"),
          ("a\nb\nc\n", "a\nnew1\nb\nc\n", "a\nnew2\nb\nc\n"),
          ("a\nb\nc\n", "A\nb\nc\n", "A\nb\nc\n"), ("", "x\n", ""), ("a\n", "", "a\nb\n")]


@pytest.mark.parametrize("base,a,b", MERGE3)
def test_merge3_lines_matches_jax(base, a, b):
    assert merge3_lines(base, a, b) == jax_merge3(base, a, b)


def _tar(files):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for rel, content in files.items():
            data = content if isinstance(content, bytes) else content.encode()
            info = tarfile.TarInfo(rel)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _op(op_type, sym, params, op_id, addr=None):
    return Op.new(op_type, Target(symbolId=sym, addressId=addr or f"f.ts::{sym}::0"),
                  params=params, op_id=op_id)


def _extract_vs_inline():
    ext = _op("extractMethod", "host", {"file": "f.ts", "newName": "helper", "blockHash": "h",
                                        "newAddress": "f.ts::helper::0"}, "a-ext",
              addr="f.ts::host::0")
    edit = _op("editStmtBlock", "host", {"file": "f.ts", "oldBodyHash": "x",
                                         "newBodyHash": "y", "oldBody": "body",
                                         "newBody": "helper();"}, "a-edit",
               addr="f.ts::host::0")
    add = _op("addDecl", "helper", {"file": "f.ts"}, "a-add", addr="f.ts::helper::0")
    inl = _op("inlineMethod", "host", {"file": "f.ts", "methodName": "callee",
                                       "blockHash": "h", "oldAddress": "f.ts::callee::0"},
              "b-inl", addr="f.ts::host::0")
    dele = _op("deleteDecl", "callee", {"file": "f.ts"}, "b-del", addr="f.ts::callee::0")
    tars = dict(base_tar=_tar({"f.ts": "function host() { callee(); }\n"
                                       "function callee() {}\n"}),
                left_tar=_tar({"f.ts": "function host() { helper(); }\n"
                                       "function helper() {}\nfunction callee() {}\n"}),
                right_tar=_tar({"f.ts": "function host() { /* inlined */ }\n"}))
    return [ext, edit, add], [inl, dele], tars, {"category": "ExtractVsInline",
                                                 "opA": ext.to_dict(), "opB": inl.to_dict()}


def _delete_vs_edit():
    op_del = _op("deleteDecl", "sym", {"file": "f.ts"}, "a1")
    op_edit = _op("renameSymbol", "sym", {"oldName": "foo", "newName": "goo",
                                          "file": "f.ts"}, "b1")
    src = "export function foo(): void {}\n"
    tars = dict(base_tar=_tar({"f.ts": src}), left_tar=_tar({"f.ts": ""}),
                right_tar=_tar({"f.ts": src.replace("foo", "goo")}))
    return [op_del], [op_edit], tars, {"category": "DeleteVsEdit",
                                       "opA": op_del.to_dict(), "opB": op_edit.to_dict()}


def _concurrent_stmt_edit():
    a = _op("editStmtBlock", "s", {"file": "f.ts", "oldBody": "x = 1;\ny = 2;\n",
                                   "newBody": "x = 3;\ny = 2;\n"}, "a1")
    b = _op("editStmtBlock", "s", {"file": "f.ts", "oldBody": "x = 1;\ny = 2;\n",
                                   "newBody": "x = 1;\ny = 4;\n"}, "b1")
    tars = dict(base_tar=_tar({}), left_tar=_tar({}), right_tar=_tar({}))
    return [a], [b], tars, {"category": "ConcurrentStmtEdit", "opA": a.to_dict(),
                            "opB": b.to_dict()}


def _unknown():
    tars = dict(base_tar=_tar({}), left_tar=_tar({}), right_tar=_tar({}))
    return [], [], tars, {"category": "DivergentMove"}


PROPOSALS = {"extract_vs_inline": _extract_vs_inline, "delete_vs_edit_tie": _delete_vs_edit,
             "concurrent_stmt_edit": _concurrent_stmt_edit, "unknown_category": _unknown}


def _shape(cands):
    return [(c.audit(), c.score, sorted(c.drops),
             {k: v.to_dict() for k, v in c.replaces.items()}) for c in cands]


@pytest.mark.parametrize("name", sorted(PROPOSALS))
def test_search_resolver_proposes_as_jax(name):
    log_a, log_b, tars, conflict = PROPOSALS[name]()
    got = SearchResolver().propose(conflict, ResolveContext(log_a, log_b, **tars))
    want = JaxSearch().propose(conflict, JaxContext(
        [JaxOp.from_dict(o.to_dict()) for o in log_a],
        [JaxOp.from_dict(o.to_dict()) for o in log_b], **tars))
    assert _shape(got) == _shape(want)
    if name == "extract_vs_inline":
        assert {c.id: c.score for c in got} == {"keepExtract": 2, "keepInline": 1}
    if name == "delete_vs_edit_tie":
        assert {c.id: c.score for c in got} == {"keepDelete": 0, "keepEdit": 0}
    if name == "concurrent_stmt_edit":
        assert got[0].replaces["a1"].params["newBody"] == "x = 3;\ny = 4;\n"
        assert log_a[0].params["newBody"] == "x = 3;\ny = 2;\n"  # the op is not mutated


@pytest.mark.parametrize("seed", range(6))
def test_reference_counts_match_jax(seed):
    """Whole-word reference counts, identifiers or not, as the JAX
    package's, with a file that is not UTF-8 skipped by both."""
    rs = random.Random(seed)
    alphabet = "ab_$1 .(){};\n\t-é"
    files = {f"f{i}.ts": "".join(rs.choice(alphabet) for _ in range(rs.randint(0, 300)))
             for i in range(5)}
    files["g.ts"] = "ab ab$ $ab a_b ab1 1ab ab"
    fmap = {p: c.encode() for p, c in files.items()}
    fmap["bin.dat"] = b"\xff\xfe ab"
    names = ["ab", "a", "b", "ab$", "$", "_", "a_b", "1ab", "", "a.b", "ab ab", "(", "é",
             "".join(rs.choice("ab_$") for _ in range(3))]
    for name in names:
        assert _refs(name, fmap) == jax_refs(name, fmap), name
