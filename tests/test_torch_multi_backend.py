"""Per-language routing in the port against the JAX package.

- ``MultiBackend`` over the TypeScript engine and the Java engine (CPU)
  merges a ``.ts`` + ``.java`` snapshot as the JAX ``MultiBackend`` does:
  op logs, symbol maps, composed stream and conflicts identical.
- ``route_backends`` from ``.semmerge.toml``: the same backends in the
  same order (the primary, then the extra languages by config key, with
  ``csharp``/``cs`` once), the same extension union, ``None`` without
  an extra language.
- CLI, in a mixed TypeScript + Java + C# repository whose Java and C#
  files share signatures (fields, constructors, properties, methods):
  ``python -m semantic_merge_tpu_torch semdiff --json-out`` and
  ``semmerge --inplace`` with ``--device cpu`` against ``python -m
  semantic_merge_tpu ... --backend tpu`` (``JAX_PLATFORMS=cpu``), with
  ``[languages.java|csharp|cs] enabled``, with ``change_signature``,
  ``--strict-conflicts`` and with ``--backend java|cs``: exit code,
  stdout, work tree (``.semmerge-conflicts.json`` included) and notes
  byte-identical; a C# divergent rename exits 1 in both.
- A port daemon on the CPU serves a TypeScript merge and then a Java
  merge and diff of one repository: each equal to the one-shot JAX
  CLI's, though the TypeScript base is resident when the Java request
  comes (the C-family engine never reads the residency cache).
"""
import json
import shutil
import subprocess
import sys

import pytest

from semantic_merge_tpu.backends.base import get_backend as jax_get_backend
from semantic_merge_tpu.backends.base import run_merge as jax_run_merge
from semantic_merge_tpu.backends.multi import MultiBackend as JaxMultiBackend
from semantic_merge_tpu.backends.multi import route_backends as jax_route_backends
from semantic_merge_tpu.config import load_config as jax_load_config
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu_torch.backends.base import get_backend, run_merge
from semantic_merge_tpu_torch.backends.multi import MultiBackend, route_backends
from semantic_merge_tpu_torch.config import load_config
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot

from test_multi_backend import JAVA_BASE, TS_BASE
from test_torch_service import (WAIT, _env, make_repo, notes, start_daemon, status, stop,
                                tree_bytes, wait_for_hello)
from test_torch_strict import _run_all


def _snaps(cls):
    base = [{"path": "a.ts", "content": TS_BASE}, {"path": "Box.java", "content": JAVA_BASE}]
    left = [{"path": "a.ts", "content": TS_BASE.replace("tsThing", "tsRenamed")},
            {"path": "Box.java", "content": JAVA_BASE}]
    right = [{"path": "a.ts", "content": TS_BASE},
             {"path": "Box.java", "content": JAVA_BASE.replace("measure", "gauge")}]
    return [cls(files=files) for files in (base, left, right)]


def _dicts(ops):
    return [op.to_dict() for op in ops]


def test_multi_backend_merges_both_languages_as_jax():
    want = jax_run_merge(JaxMultiBackend([jax_get_backend("tpu"), jax_get_backend("java")]),
                         *_snaps(JaxSnapshot), base_rev="r", seed="s")
    multi = MultiBackend([get_backend("tpu", device="cpu"), get_backend("java", device="cpu")])
    got = run_merge(multi, *_snaps(Snapshot), base_rev="r", seed="s")
    assert _dicts(got[0].op_log_left) == _dicts(want[0].op_log_left)
    assert _dicts(got[0].op_log_right) == _dicts(want[0].op_log_right)
    assert got[0].symbol_maps == want[0].symbol_maps
    assert _dicts(got[1]) == _dicts(want[1])
    assert got[2] == want[2] == []
    renamed = {op.params.get("newName") for op in got[1] if op.type == "renameSymbol"}
    assert {"tsRenamed", "gauge"} <= renamed
    # No fused engine on a routed merge: the TS half took the two-program path.
    assert multi.backends[0].path == "two-program"
    assert {"scan", "device_diff", "java.scan", "java.device_diff"} <= set(multi.phases)


ROUTES = {
    "java": "[languages.java]\nenabled = true\n",
    "csharp": "[languages.csharp]\nenabled = true\n",
    "cs": "[languages.cs]\nenabled = true\n",
    "csharp_and_cs": "[languages.csharp]\nenabled = true\n[languages.cs]\nenabled = true\n",
    "all": "[languages.java]\nenabled = true\n[languages.csharp]\nenabled = true\n"
           "[languages.cs]\nenabled = true\n",
    "disabled": "[languages.java]\nenabled = false\n[languages.typescript]\nenabled = true\n",
    "none": "",
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_backends_from_config_matches_jax(tmp_path, route):
    (tmp_path / ".semmerge.toml").write_text('[engine]\nbackend = "host"\n' + ROUTES[route])
    want = jax_route_backends(jax_get_backend("host"), jax_load_config(tmp_path))
    got = route_backends(get_backend("host", device="cpu"), load_config(tmp_path),
                         device="cpu")
    if want is None:
        assert got is None
        return
    assert [type(b).__name__ for b in got.backends][1:] == \
        [type(b).__name__ for b in want.backends][1:]
    assert [b.name for b in got.backends][1:] == [b.name for b in want.backends][1:]
    assert got.extensions == want.extensions
    assert all(b.device.type == "cpu" for b in got.backends)


# --- CLI parity in a mixed repository -----------------------------------------

def _java(k, method="measure", extra=""):
    """Java file ``k``: ``x``, ``run()`` and ``twice(int)`` collide with
    every other file's; ``method`` (``k + 1`` long parameters) does not."""
    longs = ", ".join(f"long a{n}" for n in range(k + 1))
    return (f"public class Box{k} {{\n  private int x;\n  public Box{k}(int x) {{ this.x = x; }}\n"
            f"  void run() {{}}\n  int twice(int v) {{\n    int t = v;\n    return t * 2;\n  }}\n"
            f"  public long {method}({longs}) {{ return 0; }}\n{extra}}}\n")


def _cs(k, prop="Count", method="Only"):
    """C# file ``k``: ``Count`` and ``G(string)`` collide across files;
    ``method`` (``k + 3`` long parameters) does not."""
    longs = ", ".join(f"long a{n}" for n in range(k + 3))
    return (f"namespace Mixed;\n\npublic class Svc{k}\n{{\n    public int {prop} {{ get; set; }}\n"
            f"    string G(string s) => s;\n    public long {method}({longs}) => 0;\n}}\n")


_TS_UTIL = "export function foo(n: number): number {\n  return n;\n}\n"
_TS_KEEP = "export function keep(s: string): string {\n  return s;\n}\n"
_BASE = {"src/util.ts": _TS_UTIL, "src/keep.ts": _TS_KEEP, "notes.txt": "one\ntwo\nthree\n",
         **{f"java/Box{k}.java": _java(k) for k in range(4)},
         **{f"cs/Svc{k}.cs": _cs(k) for k in range(4)}}
#: A renames foo, Box0's own method, Box1's colliding twice (unseen by
#: the last-wins map) and Svc2's Count, and retypes Box3's method; B
#: moves util.ts, Box2 and Svc1, edits notes.txt and Box0's body.
MIXED = (
    _BASE,
    {"src/util.ts": _TS_UTIL.replace("foo", "bar"), "java/Box0.java": _java(0, "gauge"),
     "java/Box1.java": _java(1).replace("twice(", "double("), "cs/Svc2.cs": _cs(2, "Total"),
     "java/Box3.java": _java(3).replace("public long measure(", "public int sized(")},
    {"src/util.ts": None, "lib/util.ts": _TS_UTIL, "notes.txt": "one\ntwo\nthree (B)\n",
     "java/Box2.java": None, "javalib/Box2.java": _java(2), "cs/Svc1.cs": None,
     "cslib/Svc1.cs": _cs(1), "java/Box0.java": _java(0).replace("t * 2", "t * 3")},
)
#: A and B rename Svc3's own method apart: a DivergentRename.
CONFLICT = (_BASE, {"cs/Svc3.cs": _cs(3, method="Left")},
            {"cs/Svc3.cs": _cs(3, method="Right")})
ALL = "[languages.java]\nenabled = true\n[languages.csharp]\nenabled = true\n"
#: case → (repository, command, extra argv, .semmerge.toml lines)
CLI_CASES = {
    "java_enabled": ("mixed", ("semdiff", "semmerge"), [], "[languages.java]\nenabled = true\n"),
    "csharp_enabled": ("mixed", ("semdiff", "semmerge"), [],
                       "[languages.csharp]\nenabled = true\n"),
    "cs_enabled": ("mixed", ("semdiff", "semmerge"), [], "[languages.cs]\nenabled = true\n"),
    "all_enabled": ("mixed", ("semdiff", "semmerge"), [], ALL + "[languages.cs]\nenabled = true\n"),
    "change_signature": ("mixed", ("semdiff", "semmerge"), ["--change-signature"], ALL),
    "strict": ("mixed", ("semmerge",), ["--strict-conflicts"], ALL),
    "backend_java": ("mixed", ("semdiff", "semmerge"), ["--backend", "java"], ""),
    "backend_cs_routed": ("mixed", ("semdiff", "semmerge"), ["--backend", "cs"], ALL),
    "divergent_rename": ("conflict", ("semmerge",), [], ALL),
}
ARGV = {"semdiff": ["semdiff", "basebr", "brA", "--json-out"],
        "semmerge": ["semmerge", "basebr", "brA", "brB", "--inplace"]}
JOBS = [(case, command) for case, (_, commands, _, _) in CLI_CASES.items()
        for command in commands]


@pytest.fixture(scope="module")
def mixed_origins(tmp_path_factory):
    work = tmp_path_factory.mktemp("mixed")
    return {"mixed": make_repo(work / "mixed", *MIXED),
            "conflict": make_repo(work / "conflict", *CONFLICT)}


@pytest.fixture(scope="module")
def cli_runs(mixed_origins, tmp_path_factory):
    """Every case through both CLIs, all processes started together."""
    work = tmp_path_factory.mktemp("mixed_cli")
    jobs = {}
    for case, command in JOBS:
        repo, _, extra, toml = CLI_CASES[case]
        for side, module, flags in (("jax", "semantic_merge_tpu", ["--backend", "tpu"]),
                                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"])):
            root = work / f"{case}-{command}-{side}"
            shutil.copytree(mixed_origins[repo], root)
            (root / ".semmerge.toml").write_text("[ci]\nrequire_typecheck = false\n" + toml)
            if "--backend" in extra:
                flags = [f for f in flags if f not in ("--backend", "tpu")]
            jobs[case, command, side] = (root, [module, *ARGV[command], *extra, *flags])
    out = {}
    for key, (code, stdout, stderr) in _run_all(jobs, _env()).items():
        root = jobs[key][0]
        out[key] = {"code": code, "stdout": stdout, "stderr": stderr,
                    "tree": tree_bytes(root), "notes": notes(root)}
    return out


@pytest.mark.parametrize("case,command", JOBS, ids=[f"{c}-{m}" for c, m in JOBS])
def test_cli_matches_the_jax_cli_in_a_mixed_repository(cli_runs, case, command):
    want, got = cli_runs[case, command, "jax"], cli_runs[case, command, "port"]
    assert want["code"] in (0, 1), want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]


def test_cli_cases_show_what_they_are_named_for(cli_runs):
    def langs(case):
        ops = json.loads(cli_runs[case, "semdiff", "port"]["stdout"])
        return {op["params"].get("file", op["params"].get("newFile", "")).rsplit(".", 1)[-1]
                for op in ops}
    assert langs("all_enabled") == {"ts", "java", "cs"}
    assert langs("java_enabled") == {"ts", "java"}
    assert langs("csharp_enabled") == langs("cs_enabled") == {"ts", "cs"}
    assert langs("backend_java") == {"java"}
    tree = cli_runs["all_enabled", "semmerge", "port"]["tree"]
    # (B's body edit of Box0 is no op without statement ops, as for TS.)
    assert b"gauge(" in tree["java/Box0.java"] and b"t * 3" not in tree["java/Box0.java"]
    assert b"function bar" in tree["lib/util.ts"]
    # Svc2's Count -> Total is seen in the incremental scope (whose
    # collision guard indexes TS files only), then lost to the colliding
    # Count of B's moved Svc1 in the compose: the JAX CLI's tree too.
    assert '"newName": "Total"' in cli_runs["all_enabled", "semdiff", "port"]["stdout"]
    assert tree["notes.txt"] == b"one\ntwo\nthree (B)\n"
    # Without routing the Java files merge as text (Box2 moved, Box0 edited).
    assert "javalib/Box2.java" in cli_runs["csharp_enabled", "semmerge", "port"]["tree"]
    run = cli_runs["divergent_rename", "semmerge", "port"]
    assert run["code"] == 1
    conflicts = json.loads(run["tree"][".semmerge-conflicts.json"])
    assert [c["category"] for c in conflicts] == ["DivergentRename"]


# --- the daemon: a TypeScript merge, then a Java one, in one repository ---------

SERVED = [["semmerge", "basebr", "brA", "brB"],
          ["semdiff", "basebr", "brA", "--json-out", "--backend", "java"],
          ["semmerge", "basebr", "brA", "brB", "--inplace", "--backend", "java"],
          ["semdiff", "basebr", "brA", "--json-out"]]


@pytest.fixture(scope="module")
def served_languages(mixed_origins, tmp_path_factory):
    work = tmp_path_factory.mktemp("lang_svc")
    roots = {}
    for side in ("jax", "port"):
        roots[side] = work / side
        shutil.copytree(mixed_origins["mixed"], roots[side])
        # The whole tree, not the incremental scope: a resident base is
        # keyed by its scope too, and the merge's scope is not the diff's.
        (roots[side] / ".semmerge.toml").write_text(
            "[engine]\nincremental = false\n[ci]\nrequire_typecheck = false\n")
    sock = work / "port.sock"
    proc = start_daemon(sock)
    steps = []
    try:
        wait_for_hello(sock, proc)
        before = status(sock)
        for argv in SERVED:
            runs = {}
            for side, module, flags, env in (
                    ("jax", "semantic_merge_tpu", [] if "--backend" in argv else
                     ["--backend", "tpu"], _env()),
                    ("port", "semantic_merge_tpu_torch", ["--device", "cpu"],
                     _env(SEMMERGE_DAEMON="require", SEMMERGE_SERVICE_SOCKET=str(sock)))):
                out = subprocess.run([sys.executable, "-m", module, *argv, *flags],
                                     cwd=roots[side], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, timeout=WAIT)
                runs[side] = {"code": out.returncode, "stdout": out.stdout, "stderr": out.stderr,
                              "tree": tree_bytes(roots[side]), "notes": notes(roots[side])}
            steps.append(runs)
        after = status(sock)
    finally:
        stop(proc)
    return steps, before, after


@pytest.mark.parametrize("step", range(len(SERVED)))
def test_daemon_serves_a_java_merge_after_a_ts_merge_of_one_repository(served_languages, step):
    steps, before, after = served_languages
    want, got = steps[step]["jax"], steps[step]["port"]
    # --backend java merges the TS files as text: A's rename against B's
    # move of util.ts is a text conflict (exit 1).
    assert want["code"] == (1 if step == 2 else 0), want["stderr"]
    assert got["code"] == want["code"], got["stderr"]
    assert got["stdout"] == want["stdout"]
    assert got["tree"] == want["tree"]
    assert got["notes"] == want["notes"]
    assert after["served_total"] - before["served_total"] == len(SERVED)


def test_daemon_kept_the_ts_base_resident_across_the_java_requests(served_languages):
    steps, before, after = served_languages
    ops = json.loads(steps[1]["port"]["stdout"])
    assert ops and all(op["params"].get("file", op["params"].get("newFile", "")).endswith(
        ".java") for op in ops)
    # The last (TypeScript) request found the base the first one left.
    assert after["residency"]["hits"] - before["residency"]["hits"] >= 1, after["residency"]
