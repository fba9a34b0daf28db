"""The port's device RGA materialization against the JAX package's.

- ``ops/crdt.py::materialize_batch``: every case of
  ``tests/test_device_crdt.py`` (empty batch, one list, a seeded fuzz
  batch) on the port's tensor code (``device="cpu"``), the JAX
  ``materialize_batch`` and the host RGA, which must all give the same
  lists; a hypothesis case with keys across the int32 range up to
  ``_PAD - 1``; the program alone on raw int32 columns over the whole
  int32 range against the JAX program (``_batched_kernel``), which
  checks the packed sort keys are exact.
- ``core/encode.py::rank_intern`` against the JAX function.
- The applier: ``reorderImports`` ops through the port's object applier
  with and without ``device_crdt`` against the JAX applier's tree, the
  ``apply_ops`` span's ``device_crdt`` on both applier loops, and the
  engines' flags (the TypeScript engine and a routed set holding it on,
  Java and C# off, as in the JAX package).
- On a CUDA device a failure raises ``KernelFault`` (no host fallback);
  here, where CUDA is absent, the copy to the card is what fails.
"""
import pathlib
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from semantic_merge_tpu.core.crdt import RGA as JaxRGA
from semantic_merge_tpu.core.crdt import Key as JaxKey
from semantic_merge_tpu.core.encode import rank_intern as jax_rank_intern
from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.core.ops import Target as JaxTarget
from semantic_merge_tpu.ops import crdt as jax_crdt
from semantic_merge_tpu.runtime.applier import apply_ops as jax_apply_ops
from semantic_merge_tpu_torch.core.crdt import RGA, Key
from semantic_merge_tpu_torch.core.encode import rank_intern
from semantic_merge_tpu_torch.errors import KernelFault, is_device_fault
from semantic_merge_tpu_torch.obs import spans as obs_spans
from semantic_merge_tpu_torch.ops import crdt
from semantic_merge_tpu_torch.runtime.applier import apply_ops

torch = pytest.importorskip("torch")

INT32_MIN, PAD = -(2**31), int(crdt._PAD)


def _pair(actions):
    """The same action list on a port RGA and a JAX RGA."""
    port, jax = RGA(), JaxRGA()
    for act, key, value in actions:
        for rga, make in ((port, Key), (jax, JaxKey)):
            if act == "insert":
                rga.insert(make(*key), value)
            elif act == "move":
                rga.move(value, make(*key))
            else:
                rga.delete(value)
    return port, jax


def _check(action_lists):
    pairs = [_pair(a) for a in action_lists]
    ports, jaxes = [p for p, _ in pairs], [j for _, j in pairs]
    got = crdt.materialize_batch(ports, "cpu")
    assert got == [list(r.materialize()) for r in ports]
    assert got == jax_crdt.materialize_batch(jaxes)
    return got


def test_empty_batch():
    assert crdt.materialize_batch([], "cpu") == [] == jax_crdt.materialize_batch([])


def test_single_list_matches_host():
    got = _check([[("insert", ("a", 2, "u1", "op2"), "second"),
                   ("insert", ("a", 1, "u1", "op1"), "first"),
                   ("delete", None, "second")]])
    assert got == [["first"]]


def _fuzz_actions(rng):
    actions = []
    for _ in range(rng.randint(0, 9)):
        key = (rng.choice("abc"), rng.randint(0, 3), rng.choice("uv"), f"op{rng.randint(0, 20)}")
        value = f"val{rng.randint(0, 5)}"
        roll = rng.random()
        if roll < 0.6:
            actions.append(("insert", key, value))
        elif roll < 0.8:
            actions.append(("move", key, value))
        else:
            actions.append(("insert", key, value))
            actions.append(("delete", None, f"val{rng.randint(0, 5)}"))
    return actions


@pytest.mark.parametrize("seed", [3, 11])
def test_fuzz_batch_matches_host(seed):
    rng = random.Random(seed)
    _check([_fuzz_actions(rng) for _ in range(25)])


def test_long_lists_with_tombstones_and_moves():
    """Lists past one bucket (up to 64 elements), many moves and deletes."""
    rng = random.Random(5)
    lists = []
    for _ in range(40):
        acts = []
        for j in range(rng.randint(1, 64)):
            key = (rng.choice("pqrs"), rng.randint(0, 50), rng.choice("uvw"), f"op{j}")
            acts.append(("insert", key, f"import v{j};"))
            if rng.random() < 0.2:
                acts.append(("move", (rng.choice("pqrs"), rng.randint(0, 50), "m", f"mv{j}"),
                             f"import v{rng.randint(0, j)};"))
            if rng.random() < 0.15:
                acts.append(("delete", None, f"import v{rng.randint(0, j)};"))
        lists.append(acts)
    _check(lists)


_text = st.text(alphabet="abéz", max_size=3)
_actions = st.lists(st.tuples(
    st.sampled_from(["insert", "insert", "move", "delete"]),
    st.tuples(_text, st.integers(INT32_MIN, PAD - 1), _text, _text),
    st.sampled_from(["x", "y", "z", "w"])), max_size=12)


@settings(max_examples=60, deadline=None)
@given(st.lists(_actions, min_size=1, max_size=6))
def test_hypothesis_keys_across_the_int32_range(action_lists):
    _check(action_lists)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(1, 9), st.integers(0, 2**31))
def test_program_on_raw_int32_columns(b, n, seed):
    """The program alone, every key column drawn over the whole int32
    range (few distinct values, so ties reach the later keys), against
    the JAX program: the packed int64 keys order as the pairs do."""
    rs = np.random.RandomState(seed % (2**32))
    pool = np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1, PAD - 1, PAD], np.int64)
    cols = [pool[rs.randint(0, len(pool), (b, n))].astype(np.int32) for _ in range(5)]
    tomb = rs.rand(b, n) < 0.3
    perm, count = jax_crdt._batched_kernel(*cols, tomb, n)
    packed = crdt._materialize_program(*(torch.from_numpy(c) for c in cols),
                                       torch.from_numpy(tomb)).numpy()
    assert packed[:, n].tolist() == np.asarray(count).tolist()
    assert packed[:, :n].tolist() == np.asarray(perm).tolist()


def test_rank_intern_matches_the_jax_function():
    values = ["b", None, "a", "b", "é", "", None, "a"]
    got, table = rank_intern(values)
    want, want_table = jax_rank_intern(values)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    assert table == want_table
    assert rank_intern([])[0].tolist() == jax_rank_intern([])[0].tolist()


def test_a_cuda_failure_raises_a_device_fault():
    port, _ = _pair([("insert", ("a", 1, "u", "o"), "x")])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the program would run")
    with pytest.raises(KernelFault) as info:
        crdt.materialize_batch([port], torch.device("cuda"))
    assert is_device_fault(info.value) and info.value.exit_code == 11


# --- the applier ------------------------------------------------------------------

_IMPORTS = ('import { a } from "./a";\nimport { b } from "./b";\nimport { c } from "./c";\n'
            'import { d } from "./d";\nexport function foo(): number {\n  return 1;\n}\n')


def _order(values, rng):
    return [{"value": v, "anchor": rng.choice("xy"), "t": rng.randint(0, 3),
             "author": rng.choice("uv"), "opid": f"o{i}"} for i, v in enumerate(values)]


def _reorder_ops(n_files=6, seed=0):
    rng = random.Random(seed)
    lines = [ln for ln in _IMPORTS.splitlines() if ln.startswith("import")]
    ops = []
    for i in range(n_files):
        ops.append(JaxOp.new("reorderImports", JaxTarget(symbolId=f"imp{i}", addressId=None),
                             params={"file": f"src/m{i}.ts",
                                     "order": _order(rng.sample(lines, len(lines)), rng)},
                             op_id=f"{i:0>32}"))
    return ops


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


@pytest.fixture
def base(tmp_path):
    root = tmp_path / "base"
    (root / "src").mkdir(parents=True)
    for i in range(6):
        (root / f"src/m{i}.ts").write_text(_IMPORTS)
    return root


@pytest.mark.parametrize("device_crdt", [True, False])
def test_object_applier_orders_reorder_imports_as_the_jax_applier(base, device_crdt):
    from semantic_merge_tpu_torch.core.ops import Op
    jax_ops = _reorder_ops()
    port_ops = [Op.from_dict(op.to_dict()) for op in jax_ops]
    want = jax_apply_ops(base, jax_ops, device_crdt=True)
    rec = obs_spans.SpanRecorder()
    with obs_spans.activated(rec):
        got = apply_ops(base, port_ops, device_crdt=device_crdt, device="cpu")
    assert _tree(got) == _tree(want)
    assert _tree(got) != _tree(base)
    span, = [r for r in rec.span_dicts() if r["name"] == "apply_ops"]
    assert span["meta"]["device_crdt"] is device_crdt
    assert "columnar" not in span["meta"]


def test_columnar_applier_span_carries_device_crdt(tmp_path):
    """The fused engine's composed view takes the columnar loop; its
    span carries the engine's flag as the JAX span does."""
    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
    base_files = [{"path": "src/u.ts", "content": "export function foo(): number { return 1; }\n"}]
    side = [{"path": "src/u.ts", "content": "export function bar(): number { return 1; }\n"}]
    backend = TorchTSBackend(device="cpu")
    _res, composed, _conf = backend.merge(Snapshot(files=base_files), Snapshot(files=side),
                                          Snapshot(files=base_files))
    root = tmp_path / "tree"
    (root / "src").mkdir(parents=True)
    (root / "src/u.ts").write_text(base_files[0]["content"])
    rec = obs_spans.SpanRecorder()
    with obs_spans.activated(rec):
        out = apply_ops(root, composed, device_crdt=backend.device_crdt, device="cpu")
    span, = [r for r in rec.span_dicts() if r["name"] == "apply_ops"]
    assert span["meta"]["device_crdt"] is True and span["meta"]["columnar"] is True
    assert "function bar" in (out / "src/u.ts").read_text()


def test_engine_flags_follow_the_jax_package():
    from semantic_merge_tpu_torch.backends.cs import CSharpBackend
    from semantic_merge_tpu_torch.backends.java import JavaBackend
    from semantic_merge_tpu_torch.backends.multi import MultiBackend
    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    ts, java, cs = (TorchTSBackend(device="cpu"), JavaBackend(device="cpu"),
                    CSharpBackend(device="cpu"))
    assert ts.device_crdt is True
    assert getattr(java, "device_crdt", False) is False
    assert getattr(cs, "device_crdt", False) is False
    assert MultiBackend([ts, java]).device_crdt is True
    assert MultiBackend([java, cs]).device_crdt is False
