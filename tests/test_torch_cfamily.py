"""The port's C-family (Java and C#) scanner and backends against the JAX
package's.

- Scanner: ``frontend/cfamily.py::scan_file_cfamily`` gives the JAX
  scanner's ``DeclNode`` list, field by field, on the sources of
  ``tests/test_cfamily.py`` and on 50 generated Java and C# files
  (seeded with numpy) whose fields, constructors, properties and
  methods share signatures across files and within a file.
- Backends: ``run_merge`` through the port's ``java`` and ``cs``
  backends on the CPU (device diff, device compose) against the JAX
  ``JavaBackend`` / ``CSharpBackend`` (host diff, host compose), on the
  snapshot triples of ``tests/test_cfamily.py`` and on generated
  triples with renames, retypes, body edits, adds, deletes, moves and
  divergent renames over colliding signatures: both op logs as JSON
  bytes, the composed stream and the conflicts identical, plain and
  with ``statement_ops``, ``structured_apply`` and ``change_signature``
  (without the matcher and with it: the JAX matcher's seeded weights
  carried into the port's checkpoint with ``params_from_jax``, the
  port's plain attention on the CPU). No float is compared: the
  matcher's pairing decides bytes of the op logs, which must be equal.
- ``diff`` alone, and the JAX tests' single-backend cases.
"""
import json
import textwrap

import numpy as np
import pytest

import jax

from semantic_merge_tpu.backends.base import get_backend as jax_get_backend
from semantic_merge_tpu.backends.base import run_merge as jax_run_merge
from semantic_merge_tpu.frontend import cfamily as jax_cfamily
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.encoder import init_encoder
from semantic_merge_tpu.models.signature import EmbeddingSignatureMatcher as JaxMatcher
from semantic_merge_tpu_torch.backends.base import get_backend, run_merge
from semantic_merge_tpu_torch.frontend import cfamily
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.models.matcher import params_from_jax, save_matcher_checkpoint
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher

from test_cfamily import CS_SRC, JAVA_SRC

SEED = 1234
TS = "2026-01-01T00:00:00Z"

#: (path, source) of every file the JAX tests scan (tests/test_cfamily.py).
FIXED_SOURCES = [
    ("src/Greeter.java", JAVA_SRC),
    ("src/Counter.cs", CS_SRC),
    ("Outer.java", textwrap.dedent("""\
        @Deprecated
        @SuppressWarnings("all")
        public final class Outer {
            static class Inner {
                void run() {}
            }
            @interface Marker { }
        }
        """)),
    ("S.java", "sealed class A permits B {}\n"
               "non-sealed class B extends A { int f(int x) { return x; } }\n"),
    ("C.cs", "class C { public int X => 42; public int Y { get; set; } }\n"),
    ("R.cs", "record struct P(int A, int B);\nrecord class Q(int C);\n"),
    ("C.java", "class C {\n  Map<String,Integer> m = new HashMap<String,Integer>();\n"
               "  int a = f(1, 2), b;\n}\n"),
    ("A.java", "class A { int a[]; int b; }"),
    ("X.java", "class A {}\n@interface"),
    ("A.java", "class D { int a[]; }\nclass X { { arr[idx] = val; } }\n"),
    ("A.java", "enum E { A; }\nclass C { void f() {} }\n"),
]

_JAVA_TYPES = ("int", "long", "String", "boolean", "List<String>", "Map<String,Integer>",
               "int[]")
_CS_TYPES = ("int", "long", "string", "bool", "List<int>", "Dictionary<string,int>", "int[]")


def _params(rng, types, n_max=2):
    return ", ".join(f"{types[rng.integers(len(types))]} a{k}"
                     for k in range(rng.integers(n_max + 1)))


def gen_java(rng, k: int) -> str:
    """A Java file whose members draw their types from a small set, so
    signatures collide across files and within one."""
    out = [f"package gen.p{k};", "", "import java.util.*;", ""]
    if rng.random() < 0.4:
        out.append("@Deprecated")
    out.append(f"public class G{k} {{")
    for f in range(rng.integers(1, 4)):
        decl = f"    private {_JAVA_TYPES[rng.integers(3)]} f{f}"
        out.append(decl + (f" = {f}, g{f};" if rng.random() < 0.3 else ";"))
    if rng.random() < 0.6:
        out.append(f"    public G{k}(int a) {{ this.f0 = a; }}")
    for m in range(rng.integers(2, 6)):
        ret = _JAVA_TYPES[rng.integers(4)] if rng.random() < 0.7 else "void"
        body = ("{ return; }" if ret == "void" else
                "{\n        int t = 1;\n        t = t + 2;\n        return null;\n    }")
        out.append(f"    public {ret} m{m}({_params(rng, _JAVA_TYPES)}) {body}")
    if rng.random() < 0.4:
        out.append(f"    enum Mood{k} {{ HAPPY, SAD }}")
    if rng.random() < 0.3:
        out.append(f"    static class Inner{k} {{ void run() {{}} }}")
    out.append("}")
    if rng.random() < 0.3:
        out.append(f"interface Speaker{k} {{ String speak(int volume); }}")
    if rng.random() < 0.3:
        out.append(f"record Point{k}(int x, int y) {{}}")
    return "\n".join(out) + "\n"


def gen_cs(rng, k: int) -> str:
    """A C# file in a block or file-scoped namespace, with properties of
    a small type set (colliding ``prop:`` signatures), attributes and
    expression bodies."""
    scoped = rng.random() < 0.5
    out = ["using System;", ""]
    out.append(f"namespace Gen.N{k};" if scoped else f"namespace Gen.N{k}\n{{")
    if rng.random() < 0.4:
        out.append("[Serializable]")
    out.append(f"public class S{k}\n{{")
    for p in range(rng.integers(1, 3)):
        out.append(f"    public {_CS_TYPES[rng.integers(3)]} P{p} {{ get; set; }}")
    if rng.random() < 0.5:
        out.append(f"    private int _f{k};")
    if rng.random() < 0.6:
        out.append(f"    public S{k}(int start) {{ _f{k} = start; }}")
    for m in range(rng.integers(2, 5)):
        ret = _CS_TYPES[rng.integers(4)]
        if rng.random() < 0.5:
            out.append(f"    public {ret} M{m}({_params(rng, _CS_TYPES)}) => default;")
        else:
            out.append(f"    public {ret} M{m}({_params(rng, _CS_TYPES)})\n    {{\n"
                       "        var t = 1;\n        t = t + 2;\n        return default;\n    }")
    out.append("}")
    if rng.random() < 0.4:
        out.append(f"public record struct R{k}(int A, int B);")
    if rng.random() < 0.3:
        out.append(f"public enum Color{k} {{ Red, Green = 5, Blue }}")
    if not scoped:
        out.append("}")
    return "\n".join(out) + "\n"


def _generated_files(n=50, seed=SEED):
    rng = np.random.default_rng(seed)
    files = []
    for k in range(n):
        if k % 2 == 0:
            files.append((f"gen/java/G{k:03d}.java", gen_java(rng, k)))
        else:
            files.append((f"gen/cs/S{k:03d}.cs", gen_cs(rng, k)))
    return files


def _spec(path, module):
    return module.CSHARP if path.endswith(".cs") else module.JAVA


def _fields(nodes):
    return [(n.symbolId, n.addressId, n.kind, n.name, n.file, n.pos, n.end, n.signature)
            for n in nodes]


@pytest.mark.parametrize("index", range(len(FIXED_SOURCES)))
def test_scanner_matches_jax_on_the_jax_cases(index):
    path, src = FIXED_SOURCES[index]
    want = jax_cfamily.scan_file_cfamily(path, src, _spec(path, jax_cfamily))
    got = cfamily.scan_file_cfamily(path, src, _spec(path, cfamily))
    assert _fields(got) == _fields(want)
    assert got, "every JAX case indexes something"


def test_scanner_matches_jax_on_generated_files():
    files = _generated_files()
    signatures = []
    for path, src in files:
        want = jax_cfamily.scan_file_cfamily(path, src, _spec(path, jax_cfamily))
        got = cfamily.scan_file_cfamily(path, src, _spec(path, cfamily))
        assert _fields(got) == _fields(want), path
        signatures += [n.symbolId for n in got]
    # The generated files collide as real trees do.
    assert len(signatures) > 2 * len(set(signatures))


def test_snapshot_scan_matches_jax():
    files = [{"path": p, "content": c} for p, c in _generated_files(20)]
    for spec_name in ("JAVA", "CSHARP"):
        spec_j, spec_p = getattr(jax_cfamily, spec_name), getattr(cfamily, spec_name)
        subset = [f for f in files if any(f["path"].endswith(e) for e in spec_p.extensions)]
        assert _fields(cfamily.scan_snapshot_cfamily(subset, spec_p)) == \
            _fields(jax_cfamily.scan_snapshot_cfamily(subset, spec_j))


# --- backends -----------------------------------------------------------------

def _mutate(rng, path, src, side):
    """One side's version of a generated file (None: deleted)."""
    roll = rng.random()
    if roll < 0.15:
        return path, None
    if roll < 0.3:
        return path.replace("/java/", "/javalib/").replace("/cs/", "/cslib/"), src
    if roll < 0.5:  # rename a method (its signature may collide)
        for m in range(5):
            for mark in (f" m{m}(", f" M{m}("):
                if mark in src:
                    return path, src.replace(mark, f" {mark.strip()[:-1]}{side}(", 1)
    if roll < 0.65:  # retype the first method
        for old, new in (("public int m", "public long m"), ("public int M", "public long M"),
                         ("public String m", "public Object m"),
                         ("public string M", "public object M")):
            if old in src:
                return path, src.replace(old, new, 1)
    if roll < 0.8:  # a body edit
        return path, src.replace("t = t + 2;", f"t = t + {3 if side == 'L' else 4};", 1)
    if roll < 0.9:  # an added method
        extra = ("    public int added{0}(int z) {{ return z; }}\n}}\n" if path.endswith(".java")
                 else "    public int Added{0}(int z) => z;\n}}\n").format(side)
        head, _, tail = src.rpartition("}\n")
        return path, head + extra + tail if tail == "" else src
    return path, src


def generated_triple(seed, n=16):
    rng = np.random.default_rng(seed)
    base = _generated_files(n, seed)
    left, right = [], []
    for side, out in (("L", left), ("R", right)):
        for path, src in base:
            new_path, new_src = _mutate(rng, path, src, side)
            if new_src is not None:
                out.append((new_path, new_src))
    # A divergent rename of one unique method in the first Java file.
    path, src = base[0]
    unique = "    public int only(long a, long b, long c, long d) { return 0; }\n}\n"
    head = src.rpartition("}\n")[0]
    base[0] = (path, head + unique)
    for out, name in ((left, "onlyLeft"), (right, "onlyRight")):
        out[:] = [(p, s) for p, s in out if p != path] + [
            (path, head + unique.replace(" only(", f" {name}("))]
    return base, sorted(left), sorted(right)


_SIMPLE = {
    "java_rename_and_move": (
        [("src/A.java", "class A { int f(int x) { return x; } }\n")],
        [("src/A.java", "class A { int g(int x) { return x; } }\n")],
        [("lib/A.java", "class A { int f(int x) { return x; } }\n")]),
    "java_change_signature": (
        [("A.java", "class A { int f(int x) { return x; } }\n")],
        [("A.java", "class A { int f(long x) { return 1; } }\n")],
        [("A.java", "class A { int f(int x) { return x; } }\n")]),
    "cs_divergent_rename": (
        [("A.cs", "class A { int F(int x) => x; }\n")],
        [("A.cs", "class A { int G(int x) => x; }\n")],
        [("A.cs", "class A { int H(int x) => x; }\n")]),
    "java_extract": (
        [("src/A.java", "class A { int work(int x) { return x * 2 + 1; } }\n")],
        [("src/A.java", "class A { int work(int x) { return help(x, 0); } }\n"),
         ("src/B.java", "class B { int help(int x, int pad) { return x * 2 + 1; } }\n")],
        [("src/A.java", "class A { int work(int x) { return x * 2 + 1; } }\n")]),
    "foreign_extensions": (
        [("a.ts", "export function f(): void {}"), ("A.java", "class A { }"),
         ("B.cs", "class B { }")],
        [], [("a.ts", "export function f(): void {}")]),
}
TRIPLES = dict(_SIMPLE, **{f"generated_{seed}": generated_triple(seed) for seed in (1, 2, 3)})
FLAGS = {
    "plain": {},
    "statement_ops": {"statement_ops": True},
    "structured_apply": {"structured_apply": True},
    "change_signature": {"change_signature": True},
    "change_signature_matcher": {"change_signature": True, "matcher": True},
}


@pytest.fixture(scope="module")
def matchers(tmp_path_factory):
    """The JAX matcher with its seeded weights, and the port's matcher
    on a checkpoint of the same weights."""
    params = init_encoder(jax.random.PRNGKey(0), JaxEncoderConfig())
    ckpt = tmp_path_factory.mktemp("matcher")
    save_matcher_checkpoint(ckpt, params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return (JaxMatcher(threshold=0.85, allow_untrained=True, seed=0),
            EmbeddingSignatureMatcher(threshold=0.85, ckpt_dir=str(ckpt), device="cpu"))


def _snaps(triple, cls):
    return [cls(files=[{"path": p, "content": c} for p, c in files]) for files in triple]


def _bytes(ops):
    return json.dumps([op.to_dict() for op in ops], sort_keys=True).encode()


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("name", ["java", "cs"])
@pytest.mark.parametrize("triple", sorted(TRIPLES))
def test_backend_merge_matches_jax(matchers, triple, name, flags):
    kw = dict(FLAGS[flags])
    jax_matcher = port_matcher = None
    if kw.pop("matcher", False):
        jax_matcher, port_matcher = matchers
    common = dict(base_rev="b0", seed="s", timestamp=TS, **kw)
    want = jax_run_merge(jax_get_backend(name), *_snaps(TRIPLES[triple], JaxSnapshot),
                         signature_matcher=jax_matcher, **common)
    got = run_merge(get_backend(name, device="cpu"), *_snaps(TRIPLES[triple], Snapshot),
                    signature_matcher=port_matcher, **common)
    assert _bytes(got[0].op_log_left) == _bytes(want[0].op_log_left)
    assert _bytes(got[0].op_log_right) == _bytes(want[0].op_log_right)
    assert got[0].symbol_maps == want[0].symbol_maps
    assert _bytes(got[1]) == _bytes(want[1])
    assert [c.to_dict() for c in got[2]] == [c.to_dict() for c in want[2]]


def test_backend_cases_show_what_they_are_named_for(matchers):
    """The triples exercise what their names say, in the port."""
    java, cs = get_backend("java", device="cpu"), get_backend("cs", device="cpu")
    result, composed, conflicts = run_merge(cs, *_snaps(TRIPLES["cs_divergent_rename"], Snapshot))
    assert [c.category for c in conflicts] == ["DivergentRename"]
    ops = java.diff(*_snaps(TRIPLES["java_change_signature"], Snapshot)[:2],
                    change_signature=True)
    assert [o.type for o in ops].count("changeSignature") == 1
    ops = java.diff(*_snaps(TRIPLES["java_extract"], Snapshot)[:2], base_rev="b", seed="s",
                    timestamp=TS, statement_ops=True)
    assert [o.type for o in ops].count("extractMethod") == 1
    ops = java.diff(*_snaps(TRIPLES["foreign_extensions"], Snapshot)[::2])
    assert [(o.type, o.params["file"]) for o in ops] == [("deleteDecl", "A.java")]
    types = set()
    for triple in TRIPLES:
        if triple.startswith("generated"):
            for backend in (java, cs):
                result, composed, conflicts = run_merge(
                    backend, *_snaps(TRIPLES[triple], Snapshot), change_signature=True,
                    signature_matcher=matchers[1])
                types |= {o.type for o in result.op_log_left + result.op_log_right}
                types |= {c.category for c in conflicts}
    assert {"renameSymbol", "moveDecl", "addDecl", "deleteDecl", "DivergentRename"} <= types
    assert java.path == cs.path == "two-program"


@pytest.mark.parametrize("name", ["java", "cs"])
def test_diff_matches_jax(matchers, name):
    for triple in sorted(TRIPLES):
        base, side = _snaps(TRIPLES[triple], JaxSnapshot)[:2]
        want = jax_get_backend(name).diff(base, side, base_rev="b", seed="s", timestamp=TS,
                                          change_signature=True,
                                          signature_matcher=matchers[0])
        base, side = _snaps(TRIPLES[triple], Snapshot)[:2]
        got = get_backend(name, device="cpu").diff(base, side, base_rev="b", seed="s",
                                                   timestamp=TS, change_signature=True,
                                                   signature_matcher=matchers[1])
        assert _bytes(got) == _bytes(want), triple


def test_backends_register_under_the_jax_names():
    from semantic_merge_tpu_torch.backends.cs import CSharpBackend
    from semantic_merge_tpu_torch.backends.java import JavaBackend
    assert isinstance(get_backend("java", device="cpu"), JavaBackend)
    for name in ("cs", "csharp"):
        backend = get_backend(name, device="cpu")
        assert isinstance(backend, CSharpBackend) and backend.name == "cs"
        assert backend.extensions == frozenset({".cs"})
        # No fused engine and no merge method: run_merge takes the JAX
        # two-step branch.
        assert not hasattr(backend, "merge")
    with pytest.raises(KeyError):
        get_backend("cobol", device="cpu")
