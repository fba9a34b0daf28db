"""The port's native op-log serializer and C op factory against the JAX
package's, on the same columns.

- ``frontend/native.py::try_oplog_json_bytes`` (``smn_oplog_json`` of
  the port's library) against the JAX function on identical arrays, and
  the port's views' bytes (native, then ``SEMMERGE_NATIVE=0``'s Python
  serializer) against the JAX views' and ``dumps_canonical`` of the
  ops, on seeded streams whose fields hold quotes, backslashes, control
  characters and non-ASCII text.
- ``load_opfactory``: ``stream_ops`` and ``composed_ops`` (through
  ``OpStreamView.materialize`` and ``ComposedOpView.materialize``, the
  latter also shard by shard) against the JAX factory's and the Python
  builders' ops, by ``to_dict``.
- ``SEMMERGE_NATIVE=0`` selects the Python serializer and builders; a
  factory that cannot be built raises ``NativeBuildFault``, now and on
  the next call; the factory loads from the port's ``frontend/_build/``
  and never from the JAX package's ``native/``.
"""
import pathlib

import numpy as np
import pytest

from semantic_merge_tpu.frontend import native as jax_native
from semantic_merge_tpu.ops import oplog_view as jax_view
from semantic_merge_tpu_torch.core.ops import dumps_canonical
from semantic_merge_tpu_torch.errors import NativeBuildFault
from semantic_merge_tpu_torch.frontend import native
from semantic_merge_tpu_torch.frontend.scanner import DeclNode
from semantic_merge_tpu_torch.ops import oplog_view

REPO = pathlib.Path(__file__).resolve().parent.parent
PROV = {"author": "a\"b", "timestamp": "2024-01-01T00:00:00Z", "rev": "é"}
_ODD = ["plain", 'q"uote', "back\\slash", "tab\there", "nl\nx", "ünï", "\x01ctl", "", "日本"]


def _nodes(rs, m, tag):
    def pick(i):
        return _ODD[rs.randint(len(_ODD))] + f"{tag}{i}"
    return [DeclNode(symbolId=f"sym:{pick(i)}", addressId=f"addr/{pick(i)}", kind="function",
                     name=pick(i), file=f"src/{pick(i)}.ts", pos=0, end=1, signature="()")
            for i in range(m)]


def _stream(seed, n=300, m=60):
    rs = np.random.RandomState(seed)
    base, side = _nodes(rs, m, "b"), _nodes(rs, m, "s")
    cols = (rs.randint(0, 4, n).astype(np.int32), rs.randint(0, m, n).astype(np.int32),
            rs.randint(0, m, n).astype(np.int32),
            rs.randint(-2**31, 2**31 - 1, (n, 4), dtype=np.int64).astype(np.int32))
    return cols, base, side


def _port_view(seed, prov=PROV):
    cols, base, side = _stream(seed)
    return oplog_view.OpStreamView(*cols, base, side, dict(prov))


def _jax_view(seed, prov=PROV):
    cols, base, side = _stream(seed)
    return jax_view.OpStreamView(*cols, base, side, dict(prov))


def _dicts(ops):
    return [op.to_dict() for op in ops]


@pytest.fixture
def python_ops(monkeypatch):
    monkeypatch.setenv("SEMMERGE_NATIVE", "0")


@pytest.mark.parametrize("seed", range(3))
def test_serializer_matches_the_jax_one_on_the_same_columns(seed):
    cols, base, side = _stream(seed)
    kind, a, b, words = cols
    args = []
    for mod in (oplog_view, jax_view):
        bb, bo = mod._node_table(base)
        sb, so = mod._node_table(side)
        args.append((len(kind), kind, a, b, words, bb, bo, sb, so, dumps_canonical(PROV)))
    assert args[0][5] == args[1][5] and args[0][6].tolist() == args[1][6].tolist()
    got = native.try_oplog_json_bytes(*args[0])
    want = jax_native.try_oplog_json_bytes(*args[1])
    assert want is not None and got == want


@pytest.mark.parametrize("seed", range(3))
def test_view_bytes_native_python_and_jax_agree(seed, monkeypatch):
    view = _port_view(seed)
    raw = view.to_json_bytes()
    assert view.serializer == "native"
    want = dumps_canonical(_dicts(_port_view(seed))).encode("utf-8")
    assert raw == want == _jax_view(seed).to_json_bytes()
    monkeypatch.setenv("SEMMERGE_NATIVE", "0")
    again = _port_view(seed)
    assert again.to_json_bytes() == raw and again.serializer == "python"


def test_empty_view_and_device_render_come_first():
    empty = oplog_view.OpStreamView(*(np.zeros((0,), np.int32),) * 3,
                                    np.zeros((0, 4), np.int32), [], [], dict(PROV))
    assert empty.to_json_bytes() == b"[]"

    class Rendered:
        def json_bytes(self):
            return b"[rendered]"

    view = _port_view(0)
    view.render = Rendered()
    assert view.to_json_bytes() == b"[rendered]" and view.serializer == "device"


@pytest.mark.parametrize("seed", range(3))
def test_stream_ops_match_the_jax_factory_and_python(seed, monkeypatch):
    got = _port_view(seed).materialize()
    assert type(got[0]).__module__ == "semantic_merge_tpu_torch.core.ops"
    want = _jax_view(seed).materialize()
    assert _dicts(got) == _dicts(want)
    monkeypatch.setenv("SEMMERGE_NATIVE", "0")
    assert _dicts(_port_view(seed).materialize()) == _dicts(got)


def _composed(mod, seed, rows=200):
    left = (oplog_view if mod is oplog_view else jax_view).OpStreamView(
        *_stream(seed)[0], *_stream(seed)[1:], dict(PROV))
    right = (oplog_view if mod is oplog_view else jax_view).OpStreamView(
        *_stream(seed + 100)[0], *_stream(seed + 100)[1:], dict(PROV, rev="r"))
    rs = np.random.RandomState(seed)
    sides = rs.randint(0, 2, rows).astype(np.int32)
    idxs = rs.randint(0, 300, rows).astype(np.int32)
    pick = lambda vals: [vals[rs.randint(len(vals))] for _ in range(rows)]  # noqa: E731
    addr = pick([None, None, "new/addr", 'we"ird'])
    file_ = pick([None, None, "lib/moved.ts", "ü.ts"])
    name = pick([None, None, "renamed", "ctx"])
    return mod.ComposedOpView(sides, idxs, addr, file_, name, left, right)


@pytest.mark.parametrize("seed", range(2))
def test_composed_ops_match_the_jax_factory_and_python(seed, monkeypatch):
    port = _composed(oplog_view, seed)
    got = port.materialize()
    assert _dicts(got) == _dicts(_composed(jax_view, seed).materialize())
    # Shard by shard, as the tail pipeline materializes.
    fresh = _composed(oplog_view, seed)
    shards = [fresh._shard_ops(lo, hi, (fresh.addr_s[lo:hi], fresh.file_s[lo:hi],
                                        fresh.name_s[lo:hi]))
              for lo, hi in ((0, 70), (70, 71), (71, 200))]
    assert _dicts([op for shard in shards for op in shard]) == _dicts(got)
    monkeypatch.setenv("SEMMERGE_NATIVE", "0")
    assert _dicts(_composed(oplog_view, seed).materialize()) == _dicts(got)
    assert _composed(oplog_view, seed).to_json_bytes() == \
        dumps_canonical(_dicts(got)).encode("utf-8")


def test_native_off_selects_python(python_ops):
    assert native.load_opfactory() is None
    cols, base, side = _stream(0)
    bb, bo = oplog_view._node_table(base)
    assert native.try_oplog_json_bytes(len(cols[0]), *cols, bb, bo, bb, bo, "{}") is None


def test_factory_loads_from_the_ports_build_dir():
    fac = native.load_opfactory()
    path = pathlib.Path(fac.__file__).resolve()
    assert path.parent == (REPO / "semantic_merge_tpu_torch" / "frontend" / "_build").resolve()
    assert path == native.opfactory_path().resolve()
    assert (REPO / "native") not in path.parents


def test_a_failed_build_raises_native_build_fault(tmp_path, monkeypatch):
    broken = tmp_path / "opfactory.c"
    broken.write_text("#include <Python.h>\nthis is not C;\n")
    monkeypatch.setattr(native, "OPFACTORY_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_opfactory", None)
    monkeypatch.setattr(native, "_opfactory_error", None)
    with pytest.raises(NativeBuildFault) as first:
        native.load_opfactory()
    assert first.value.exit_code == 10 and "g++ exit" in str(first.value)
    with pytest.raises(NativeBuildFault):
        native.load_opfactory()  # the failure is remembered
    assert not list((tmp_path / "_build").glob("*.so"))
    monkeypatch.setattr(native, "_opfactory_error", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(NativeBuildFault, match="no C\\+\\+ compiler"):
        native.load_opfactory()
