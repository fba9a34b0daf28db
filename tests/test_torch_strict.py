"""Statement ops, strict conflicts and structured apply: the port against
the JAX package.

- Functions: the port's ``statement_edits``, ``body_motions`` and
  ``lift_statements`` on seeded snapshots (body edits, extracts,
  inlines, renames) against the JAX package's, on the same decl nodes
  and diffs: equal op dicts, ids included.
- ``detect_conflicts_strict`` on the six [CFR-002] categories, with the
  op streams of ``tests/test_strict_conflicts.py`` and the snapshots of
  ``tests/test_motions.py`` through both packages: equal kept streams
  and conflict records.
- Backends: ``TorchTSBackend(device="cpu")`` against
  ``TpuTSBackend(mesh=False)`` with ``statement_ops`` and
  ``structured_apply``: ``diff``, ``build_and_diff`` and ``merge`` give
  equal op logs, composed streams and conflicts.
- CLI, in scratch git repositories: ``python -m semantic_merge_tpu_torch
  ... --device cpu`` against ``python -m semantic_merge_tpu ...
  --backend tpu`` for ``semdiff --statement-ops``, strict merges with
  DeleteVsEdit, ConcurrentStmtEdit and ExtractVsInline conflicts, and a
  ``--structured-apply`` merge, each once with the flag and once through
  ``.semmerge.toml``: exit code, stdout, work tree (with
  ``.semmerge-conflicts.json``) and notes byte-identical.
- Refused settings: each exits 70 before it reads a revision, leaving
  the work tree and ``git status`` as they were. The other languages and
  the worker seam, refused before the port had them
  (``[languages.java|csharp|cs] enabled``, ``[engine] backend =
  "subprocess"``), now run: in the same repository (an interrupted
  commit's journal and all) the port's exit code, stdout, work tree,
  ``git status`` and notes equal the JAX CLI's.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.core import difflift as jax_difflift
from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.core.strict_conflicts import (
    detect_conflicts_strict as jax_detect)
from semantic_merge_tpu.frontend.scanner import scan_snapshot_py as jax_scan
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.service import client as service_client
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.core import difflift
from semantic_merge_tpu_torch.core.ops import Op
from semantic_merge_tpu_torch.core.strict_conflicts import detect_conflicts_strict
from semantic_merge_tpu_torch.frontend.declcache import DeclCache
from semantic_merge_tpu_torch.frontend.scanner import scan_snapshot_py
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot

from test_motions import (BASE_EXTRACT, BASE_INLINE, CVI_A, CVI_B, CVI_BASE,
                          SIDE_EXTRACT, SIDE_INLINE)
from test_strict_conflicts import _op
from test_torch_merge import _make_repo, _notes, _tree_bytes

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(base_rev="r0", seed="s", timestamp="2024-01-01T00:00:00Z")
TYPES = ("string", "number", "boolean", "bigint", "object", "unknown")
STMTS = ("return s.trim();", "x = x + 1;", "log(x, s);", "y = f(x, 2);",
         "if (x) { return s; }", "total += x * 3;", "s = s.concat('!');")


# --- seeded snapshots ------------------------------------------------------------

def _fn(name, params, body):
    return f"export function {name}({params}): string {{ {body} }}\n"


def seeded_trees(seed):
    """(base, A, B) path→content maps: A and B each edit bodies, extract a
    body into a new function of a new file, inline one function into
    another's body, rename and leave alone, drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    base, funcs = {}, []
    for i in range(rs.randint(3, 6)):
        names = []
        for j in range(rs.randint(1, 4)):
            params = f"s: string, x: {TYPES[(i * 3 + j) % len(TYPES)]}" + ", z: number" * j
            body = " ".join(rs.choice(STMTS, rs.randint(2, 4), replace=False))
            names.append((f"f{i}_{j}", params, body))
        funcs.append((f"src/m{i}.ts", names))
        base[f"src/m{i}.ts"] = "".join(_fn(*f) for f in names)

    def side(tag):
        files, extra = {}, {}
        inlined = None
        if rs.rand() < 0.7:  # one function's body lands in another's
            path, names = funcs[rs.randint(len(funcs))]
            inlined = names[rs.randint(len(names))][0]
        for path, names in funcs:
            out = []
            for name, params, body in names:
                if name == inlined:
                    continue
                r = rs.rand()
                if r < 0.25:
                    body = body + " x = x - 1;"
                elif r < 0.4:
                    helper = f"ex{tag}_{name}"
                    extra[f"src/{helper}.ts"] = _fn(helper, "s: string, q: boolean, w: boolean",
                                                    body)
                    body = f"return {helper}(s, true, false);"
                elif r < 0.5:
                    name = f"{name}_{tag}"
                out.append((name, params, body))
            files[path] = out
        if inlined is not None:
            donor = next(b for _, ns in funcs for n, _, b in ns if n == inlined)
            for path, out in files.items():
                if out:
                    name, params, body = out[0]
                    out[0] = (name, params, body + " " + donor)
                    break
        tree = {path: "".join(_fn(*f) for f in out) for path, out in files.items()}
        tree.update(extra)
        return tree

    return base, side("A"), side("B")


def _files(tree):
    return [{"path": p, "content": c} for p, c in sorted(tree.items())]


def _dicts(ops):
    return [o.to_dict() for o in ops]


def _port_diffs(jax_diffs, base_nodes, side_nodes):
    """The JAX package's diff records over the port's equal decl nodes."""
    by_base = {n.addressId: n for n in base_nodes}
    by_side = {n.addressId: n for n in side_nodes}
    return [difflift.Diff(d.kind, a=by_base[d.a.addressId] if d.a else None,
                          b=by_side[d.b.addressId] if d.b else None)
            for d in jax_diffs]


@pytest.mark.parametrize("seed", range(8))
def test_statement_functions_match_jax(seed):
    base, side, _ = seeded_trees(seed)
    bf, sf = _files(base), _files(side)
    jb, js = jax_scan(bf), jax_scan(sf)
    pb, ps = scan_snapshot_py(bf), scan_snapshot_py(sf)
    assert [n.to_dict() for n in pb] == [n.to_dict() for n in jb]
    jdiffs = jax_difflift.diff_nodes(jb, js)
    pdiffs = _port_diffs(jdiffs, pb, ps)
    jsrc, psrc = jax_difflift.source_maps(bf, sf), difflift.source_maps(bf, sf)
    kw = dict(base_rev="r0", seed="s/R", timestamp=KW["timestamp"], start_idx=len(jdiffs))
    want_stmt = jax_difflift.statement_edits(jb, js, jsrc, **kw)
    got_stmt = difflift.statement_edits(pb, ps, psrc, **kw)
    assert _dicts(got_stmt) == _dicts(want_stmt)
    kw["start_idx"] += len(want_stmt)
    want_mot = jax_difflift.body_motions(jdiffs, want_stmt, jsrc, **kw)
    got_mot = difflift.body_motions(pdiffs, got_stmt, psrc, **kw)
    assert _dicts(got_mot) == _dicts(want_mot)
    for sources in (None, psrc):  # built lazily, or reused
        got = difflift.lift_statements(pdiffs, pb, ps, sources, (bf, sf), base_rev="r0",
                                       seed="s", side="R", timestamp=KW["timestamp"])
        assert _dicts(got) == _dicts(want_stmt + want_mot)
    assert want_stmt  # every seed edits some body


def test_seeded_trees_reach_every_statement_op():
    types = set()
    for seed in range(8):
        base, side, _ = seeded_trees(seed)
        backend = TorchTSBackend(device="cpu", native_scan=False, decl_cache=DeclCache())
        ops = backend.diff(
            Snapshot(files=_files(base)), Snapshot(files=_files(side)), **KW,
            statement_ops=True)
        types.update(o.type for o in ops)
    assert {"editStmtBlock", "extractMethod", "inlineMethod"} <= types


# --- strict detection -------------------------------------------------------------

def _rename(sym, new, op_id):
    return _op("renameSymbol", sym, {"oldName": "f", "newName": new, "file": "f.ts"}, op_id)


def _move(sym, new, op_id):
    return _op("moveDecl", sym, {"oldAddress": "f.ts::s::0", "newAddress": new,
                                 "oldFile": "f.ts", "newFile": new.split("::")[0]}, op_id)


def _stmt(sym, new_hash, op_id):
    return _op("editStmtBlock", sym, {"file": "f.ts", "oldBodyHash": "h0",
                                      "newBodyHash": new_hash, "oldBody": "x",
                                      "newBody": "y" + new_hash}, op_id)


#: The op-stream cases of tests/test_strict_conflicts.py: name → (A, B).
STREAMS = {
    "divergent_rename_interleaved": (
        [_move("other1", "y.ts::o::0", "a1"), _rename("sym", "g", "a2")],
        [_rename("sym", "h", "b1")]),
    "divergent_move": ([_move("sym", "a.ts::s::0", "a1")], [_move("sym", "b.ts::s::0", "b1")]),
    "same_destination_move": ([_move("sym", "n.ts::s::0", "a1")],
                              [_move("sym", "n.ts::s::0", "b1")]),
    "incompatible_signature": (
        [_op("changeSignature", "sym", {"oldSignature": "fn(int)->int",
                                        "newSignature": "fn(long)->int"}, "a1")],
        [_op("changeSignature", "sym", {"oldSignature": "fn(int)->int",
                                        "newSignature": "fn(str)->int"}, "b1")]),
    "delete_vs_rename": ([_op("deleteDecl", "sym", {"file": "f.ts"}, "a1")],
                         [_rename("sym", "g", "b1")]),
    "rename_vs_delete": ([_rename("sym", "g", "a1")],
                         [_op("deleteDecl", "sym", {"file": "f.ts"}, "b1")]),
    "delete_vs_stmt_edit": ([_op("deleteDecl", "sym", {"file": "f.ts"}, "a1")],
                            [_stmt("sym", "hB", "b1")]),
    "concurrent_stmt_edit": ([_stmt("sym", "hA", "a1")], [_stmt("sym", "hB", "b1")]),
    "identical_stmt_edits": ([_stmt("sym", "hS", "a1")], [_stmt("sym", "hS", "b1")]),
    "unrelated": ([_rename("s1", "b", "a1")], [_op("deleteDecl", "s2", {"file": "g.ts"}, "b1")]),
    "order_by_a_position": (
        [_rename("s2", "g", "a1"),
         _op("extractMethod", "host", {"file": "f.ts", "newName": "helper",
                                       "newAddress": "na", "newSymbol": "hsym",
                                       "fromFile": "f.ts", "blockHash": "bh"}, "a2")],
        [_op("inlineMethod", "hostB", {"file": "g.ts", "methodName": "helper",
                                       "oldAddress": "oa", "oldSymbol": "hsym",
                                       "blockHash": "bh"}, "b2"),
         _rename("s2", "h", "b1")]),
}

#: The snapshot cases of tests/test_motions.py: name → (base, A, B).
MOTIONS = {
    "extract_vs_inline": (CVI_BASE, CVI_A, CVI_B),
    "res004_identical_extracts": (BASE_EXTRACT, SIDE_EXTRACT, SIDE_EXTRACT),
    "extract_and_inline_apart": (BASE_INLINE, SIDE_INLINE, BASE_INLINE),
}


def _check_strict(jax_a, jax_b):
    want = jax_detect(jax_a, jax_b)
    got = detect_conflicts_strict([Op.from_dict(o.to_dict()) for o in jax_a],
                                  [Op.from_dict(o.to_dict()) for o in jax_b])
    assert _dicts(got[0]) == _dicts(want[0]) and _dicts(got[1]) == _dicts(want[1])
    assert _dicts(got[2]) == _dicts(want[2])
    return [c.category for c in got[2]]


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_strict_detection_on_streams_matches_jax(case):
    a, b = STREAMS[case]
    categories = _check_strict(a, b)
    assert bool(categories) == (case not in ("same_destination_move",
                                             "identical_stmt_edits", "unrelated"))


@pytest.mark.parametrize("case", sorted(MOTIONS))
def test_strict_detection_on_motions_matches_jax(case):
    snaps = MOTIONS[case]
    kw = dict(KW, statement_ops=True)
    want = TpuTSBackend(mesh=False).build_and_diff(*snaps, **kw)
    got = TorchTSBackend(device="cpu").build_and_diff(
        *(Snapshot(files=s.files) for s in snaps), **kw)
    assert _dicts(got.op_log_left) == _dicts(want.op_log_left)
    assert _dicts(got.op_log_right) == _dicts(want.op_log_right)
    categories = _check_strict(want.op_log_left, want.op_log_right)
    assert categories == (["ExtractVsInline"] if case == "extract_vs_inline" else [])


def test_strict_detection_covers_six_categories():
    seen = set()
    for a, b in STREAMS.values():
        seen.update(c.category for c in detect_conflicts_strict(
            [Op.from_dict(o.to_dict()) for o in a], [Op.from_dict(o.to_dict()) for o in b])[2])
    assert seen == {"DivergentRename", "DivergentMove", "IncompatibleSignatureChange",
                    "DeleteVsEdit", "ConcurrentStmtEdit", "ExtractVsInline"}


# --- backends --------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("structured", [False, True], ids=["stmt", "stmt+structured"])
def test_backend_statement_ops_match_jax(seed, structured):
    trees = seeded_trees(seed)
    jsnaps = [JaxSnapshot(files=_files(t)) for t in trees]
    psnaps = [Snapshot(files=_files(t)) for t in trees]
    kw = dict(KW, statement_ops=True, structured_apply=structured)
    jax_backend, port = TpuTSBackend(mesh=False), TorchTSBackend(device="cpu")
    assert (_dicts(port.diff(psnaps[0], psnaps[1], **kw))
            == _dicts(jax_backend.diff(jsnaps[0], jsnaps[1], **kw)))
    assert port.path == "two-program" and "statements" in port.phases
    want = jax_backend.merge(*jsnaps, **kw)
    got = port.merge(*psnaps, **kw)
    assert "fused" not in port.phases and port.path == "two-program"
    assert _dicts(got[0].op_log_left) == _dicts(want[0].op_log_left)
    assert _dicts(got[0].op_log_right) == _dicts(want[0].op_log_right)
    assert _dicts(got[1]) == _dicts(want[1]) and _dicts(got[2]) == _dicts(want[2])
    if structured:
        assert any("decl" in o.effects for o in got[0].op_log_left + got[0].op_log_right)


def test_structured_apply_without_statement_ops_skips_fused():
    trees = seeded_trees(1)
    psnaps = [Snapshot(files=_files(t)) for t in trees]
    port = TorchTSBackend(device="cpu")
    got = port.merge(*psnaps, **KW, structured_apply=True)
    want = TpuTSBackend(mesh=False).merge(*(JaxSnapshot(files=_files(t)) for t in trees),
                                          **KW, structured_apply=True)
    assert "fused" not in port.phases
    assert _dicts(got[1]) == _dicts(want[1])
    assert not any(o.type == "editStmtBlock" for o in got[0].op_log_left)


# --- CLI parity in scratch git repositories ------------------------------------

def _body_fn(name, body):
    return f"export function {name}(n: number): number {{\n  {body}\n}}\n"


_F = _body_fn("f", "return n;")
_G = "export function g(s: string): string {\n  return s;\n}\n"
_K = "export function k(b: boolean): boolean {\n  return !b;\n}\n"
_CVI = {s: {f["path"]: f["content"] for f in snap.files}
        for s, snap in (("base", CVI_BASE), ("a", CVI_A), ("b", CVI_B))}

#: name → (base files, A's edits, B's edits, argv after the module, the
#: .semmerge.toml lines that stand for the flags, expected exit code).
STRICT_CLI = {
    "semdiff_statement_ops": (
        {"src/f.ts": _F, "src/g.ts": _G},
        {"src/f.ts": _body_fn("f", "const k = n * 2;\n  return k;"),
         "src/g.ts": _G.replace("return s;", "return s + s;")}, {},
        ["semdiff", "basebr", "branch-a", "--json-out"], ["--statement-ops"],
        "[engine]\nstatement_ops = true\n", 0),
    "delete_vs_edit": (
        {"src/f.ts": _F + _G}, {"src/f.ts": _G},
        {"src/f.ts": _body_fn("f", "return n + 1;") + _G},
        ["semmerge", "basebr", "branch-a", "branch-b"], ["--strict-conflicts"],
        '[engine]\nconflict_mode = "strict"\n', 1),
    "concurrent_stmt_edit": (
        {"src/f.ts": _F, "src/g.ts": _G},
        {"src/f.ts": _body_fn("f", "return n + 1;")},
        {"src/f.ts": _body_fn("f", "return n + 2;"),
         "src/g.ts": _G.replace("g(", "g2(")},
        ["semmerge", "basebr", "branch-a", "branch-b"], ["--strict-conflicts"],
        '[engine]\nconflict_mode = "strict"\n', 1),
    "extract_vs_inline": (
        _CVI["base"], _CVI["a"], _CVI["b"],
        ["semmerge", "basebr", "branch-a", "branch-b"], ["--strict-conflicts"],
        '[engine]\nconflict_mode = "strict"\n', 1),
    "strict_clean_inplace": (
        {"src/f.ts": _F, "src/g.ts": _G},
        {"src/f.ts": _body_fn("f", "return n * 3;")},
        {"src/g.ts": _G.replace("g(", "g2("), "src/h.ts": _body_fn("h", "return 7;")},
        ["semmerge", "basebr", "branch-a", "branch-b", "--inplace"], ["--strict-conflicts"],
        '[engine]\nconflict_mode = "strict"\n', 0),
    "structured_apply": (
        {"src/f.ts": _F + _G, "src/k.ts": _K},
        {"src/f.ts": _G, "src/new.ts": _K.replace("k(b: boolean)", "added(q: bigint)")},
        {"src/f.ts": _F + _G.replace("g(", "g2("), "src/k.ts": _K.replace("!b", "b")},
        ["semmerge", "basebr", "branch-a", "branch-b", "--inplace"],
        ["--structured-apply", "--statement-ops"],
        "[engine]\nstructured_apply = true\nstatement_ops = true\n", 0),
}
#: Every case runs with the flags and with the .semmerge.toml lines.
VARIANTS = ("flag", "toml")


def _run_all(jobs, env, limit=8):
    """Runs ``jobs`` ({key: (cwd, argv)}), at most ``limit`` at once;
    returns {key: (exit code, stdout, stderr)}."""
    pending, running, done = list(jobs.items()), {}, {}
    try:
        while pending or running:
            while pending and len(running) < limit:
                key, (cwd, argv) = pending.pop(0)
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
def strict_cli_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("strict_cli")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    jobs, copies = {}, {}
    for case, (base, a, b, argv, flags, toml, _) in STRICT_CLI.items():
        origin = work / case / "origin"
        _make_repo(origin, base, a, b)
        for variant in VARIANTS:
            for side, module, extra in (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
                                        ("port", "semantic_merge_tpu_torch",
                                         ["--device", "cpu"])):
                copy = work / case / f"{variant}-{side}"
                shutil.copytree(origin, copy)
                (copy / ".semmerge.toml").write_text(
                    "[ci]\nrequire_typecheck = false\n"
                    + (toml if variant == "toml" else ""))
                key = (case, variant, side)
                copies[key] = copy
                jobs[key] = (copy, [module, *argv, *(flags if variant == "flag" else []),
                                    *extra])
    runs = {}
    for key, (code, out, err) in _run_all(jobs, env).items():
        copy = copies[key]
        runs[key] = {"code": code, "stdout": out, "stderr": err, "tree": _tree_bytes(copy),
                     "notes": [_notes(copy, rev) for rev in ("branch-a", "branch-b")]}
    return runs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(STRICT_CLI))
def test_cli_strict_matches_jax_cli(strict_cli_runs, case, variant):
    want, got = strict_cli_runs[case, variant, "jax"], strict_cli_runs[case, variant, "port"]
    code = STRICT_CLI[case][-1]
    assert want["code"] == code, want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    artifact = ".semmerge-conflicts.json"
    assert (artifact in got["tree"]) == (code == 1)


def test_cli_strict_cases_show_what_they_are_named_for(strict_cli_runs):
    import json
    runs = {case: strict_cli_runs[case, "toml", "port"] for case in STRICT_CLI}
    ops = json.loads(runs["semdiff_statement_ops"]["stdout"])
    assert [o["type"] for o in ops].count("editStmtBlock") == 2
    for case, category in (("delete_vs_edit", "DeleteVsEdit"),
                           ("concurrent_stmt_edit", "ConcurrentStmtEdit"),
                           ("extract_vs_inline", "ExtractVsInline")):
        payload = json.loads(runs[case]["tree"][".semmerge-conflicts.json"])
        assert category in [c["category"] for c in payload], case
    tree = runs["strict_clean_inplace"]["tree"]
    assert b"return n * 3;" in tree["src/f.ts"] and b"function g2(" in tree["src/g.ts"]
    tree = runs["structured_apply"]["tree"]
    assert b"function f(" not in tree["src/f.ts"] and b"function g2(" in tree["src/f.ts"]
    assert b"return b;" in tree["src/k.ts"] and b"function added(" in tree["src/new.ts"]
    notes = runs["structured_apply"]["notes"][0][1]
    assert b'"decl"' in notes


# --- refused settings ------------------------------------------------------------

#: name → (.semmerge.toml text, environment, what the message names)
REFUSED = {
    "java_enabled": ("[languages.java]\nenabled = true\n", {}, "[languages.java] enabled"),
    "csharp_enabled": ("[languages.csharp]\nenabled = true\n", {},
                       "[languages.csharp] enabled"),
    "cs_enabled": ("[languages.cs]\nenabled = true\n", {}, "[languages.cs] enabled"),
    "subprocess_backend": ('[engine]\nbackend = "subprocess"\n', {},
                           "[engine] backend = 'subprocess'"),
    "mesh_require": ('[engine]\nmesh = "require"\n', {}, '[engine] mesh = "require"'),
    "env_mesh_require": ("", {"SEMMERGE_MESH": "require"}, "SEMMERGE_MESH=require"),
    "daemon_require": ("", {"SEMMERGE_DAEMON": "require"}, "SEMMERGE_DAEMON=require"),
    "daemon_require_with_resolve": ("", {"SEMMERGE_DAEMON": "require",
                                         "SEMMERGE_RESOLVE": "auto"},
                                    "SEMMERGE_DAEMON=require"),
    "batch_require": ("", {"SEMMERGE_BATCH": "require"}, "SEMMERGE_BATCH=require"),
}
#: Settings the port now runs, as the JAX CLI does (they were refused
#: before it had the C-family engines and the worker seam, and the mesh:
#: ``require`` with one process gives the JAX CLI's answers on one
#: device — the environment's merges on the host engine, the config's
#: exits 18 with MeshFault).
NOW_RUN = frozenset({"java_enabled", "csharp_enabled", "cs_enabled", "subprocess_backend",
                     "mesh_require", "env_mesh_require"})
#: Postures the merge service now serves: outside it they still fail
#: before the tree is touched, with their own codes — ``require`` with
#: no daemon on the socket exits 12 (WorkerFault), ``SEMMERGE_BATCH=
#: require`` with no batch scheduler 16 (BatchFault).
SERVED = {"daemon_require": (12, "daemon required but unavailable"),
          "daemon_require_with_resolve": (12, "daemon required but unavailable"),
          "batch_require": (16, "BatchFault")}


class _DeadProc:
    """A spawned daemon that exited at once."""

    returncode = 1

    def poll(self):
        return self.returncode


def _git_status(root):
    return subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                          cwd=root, check=True, stdout=subprocess.PIPE).stdout


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_setting_exits_before_touching_the_tree(tmp_path, monkeypatch, capsys, name):
    toml, env, named = REFUSED[name]
    repo = tmp_path / "repo"
    _make_repo(repo, {"src/f.ts": _F}, {"src/f.ts": _F.replace("f(", "f2(")},
               {"src/f.ts": None, "lib/f.ts": _F})
    if toml:
        (repo / ".semmerge.toml").write_text(toml)
    # A journal an interrupted --inplace commit left: the merge would
    # roll it forward before anything else, were the setting not refused.
    (repo / ".semmerge-journal.json").write_text(
        '{"schema": 1, "state": "committing", "writes": ["src/f.ts"], "deletes": []}')
    (repo / ".semmerge-stage" / "src").mkdir(parents=True)
    (repo / ".semmerge-stage" / "src" / "f.ts").write_text("staged\n")
    before, status = _tree_bytes(repo), _git_status(repo)
    for key in ("SEMMERGE_MESH", "SEMMERGE_RESOLVE", "SEMMERGE_BATCH", "SEMMERGE_DAEMON"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    # No daemon answers here, and none can be spawned.
    monkeypatch.setenv("SEMMERGE_SERVICE_SOCKET", str(tmp_path / "no-daemon.sock"))
    monkeypatch.setenv("SEMMERGE_SERVICE_RETRIES", "0")
    monkeypatch.setattr(service_client, "_spawn_daemon", lambda path, device=None: _DeadProc())
    if name in NOW_RUN:
        _matches_the_jax_cli(tmp_path, repo, monkeypatch, capsys, env)
        return
    monkeypatch.chdir(repo)
    code = cli.main(["semmerge", "basebr", "branch-a", "branch-b", "--inplace",
                     "--device", "cpu"])
    err = capsys.readouterr().err
    want_code, want_text = SERVED[name]
    assert code == want_code and want_text in err
    if name == "batch_require":  # a typed fault's escape leaves its postmortem bundle
        (bundle,) = (repo / ".semmerge-postmortem").glob("*.json")
        assert json.loads(bundle.read_text())["reason"] == "fault-escape"
        shutil.rmtree(repo / ".semmerge-postmortem")
    assert _tree_bytes(repo) == before and _git_status(repo) == status
    if not name.startswith("batch"):  # semdiff refuses them too
        assert cli.main(["semdiff", "basebr", "branch-a", "--device", "cpu"]) == want_code


def _matches_the_jax_cli(tmp_path, repo, monkeypatch, capsys, extra_env=()):
    """``semmerge --inplace`` then ``semdiff`` in ``repo`` (in process)
    and in a copy of it through the JAX CLI (on one CPU device, with the
    case's ``extra_env``): the same exit codes, stdout, work trees,
    ``git status`` and notes after each."""
    jax_repo = tmp_path / "jax"
    shutil.copytree(repo, jax_repo)
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off",
               **dict(extra_env))
    monkeypatch.chdir(repo)
    for argv in (["semmerge", "basebr", "branch-a", "branch-b", "--inplace"],
                 ["semdiff", "basebr", "branch-a"]):
        want = subprocess.run([sys.executable, "-m", "semantic_merge_tpu", *argv], cwd=jax_repo,
                              env=env, capture_output=True, text=True, timeout=300)
        capsys.readouterr()
        code = cli.main([*argv, "--device", "cpu"])
        out = capsys.readouterr().out
        assert (code, out) == (want.returncode, want.stdout), want.stderr
        assert _outcome_tree(repo) == _outcome_tree(jax_repo)
        assert _outcome_status(repo) == _outcome_status(jax_repo)
        assert [_notes(repo, r) for r in ("branch-a", "branch-b")] == \
            [_notes(jax_repo, r) for r in ("branch-a", "branch-b")]


def _outcome_tree(root):
    """The work tree's bytes, each postmortem bundle (named by its run's
    trace id) read as its ``reason`` alone."""
    tree = _tree_bytes(root)
    bundles = sorted(json.loads(tree.pop(k))["reason"] for k in list(tree)
                     if k.startswith(".semmerge-postmortem/"))
    return tree, bundles


def _outcome_status(root):
    """``git status``, a postmortem bundle's line without its trace id."""
    return [line.split(b"/")[0] if b".semmerge-postmortem/" in line else line
            for line in _git_status(root).splitlines()]


@pytest.mark.parametrize("backend", ["host", "bogus"])
def test_unrefused_settings_keep_their_meaning(tmp_path, monkeypatch, backend):
    """Values that select what the port does are not refused; a backend
    name the JAX package does not know falls back to host there, and runs
    as host here."""
    from semantic_merge_tpu_torch.config import load_config, resolve_backend
    (tmp_path / ".semmerge.toml").write_text(
        f'[engine]\nbackend = "{backend}"\nmesh = "off"\n[languages.typescript]\n'
        "enabled = true\n[languages.java]\nenabled = false\n")
    config = load_config(tmp_path)
    monkeypatch.delenv("SEMMERGE_BATCH", raising=False)
    monkeypatch.setenv("SEMMERGE_RESOLVE", "off")
    monkeypatch.setenv("SEMMERGE_MESH", "auto")
    assert config.engine.mesh == "off" and config.engine.mesh_shape == "auto"
    monkeypatch.setenv("SEMMERGE_RESOLVE", "auto")
    assert resolve_backend(config) == "host"
