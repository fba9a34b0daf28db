"""The port's device op-log render against the host serializer and JAX.

``semantic_merge_tpu_torch/ops/render.py`` renders an op log as a
fixed-width byte buffer with one gather per chunk of rows. On the CPU
(the plain torch program, no kernel of its own) the rendered bytes must
equal the port's host serializer (``OpStreamView._json_rows``) and the
JAX package's ``DeviceRenderer`` on the same op rows, byte for byte:
escapes (quotes, backslashes, control characters, non-ASCII), more than
one 4,096-row chunk, the width guard and the min-rows gate. Inputs are
seeded numpy draws.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.core.encode import Interner as JaxInterner
from semantic_merge_tpu.core.encode import encode_decls as jax_encode
from semantic_merge_tpu.core.ops import OpLog as JaxOpLog
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.ops.render import DeviceRenderer as JaxRenderer
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.core.ops import OpLog
from semantic_merge_tpu_torch.errors import KernelFault
from semantic_merge_tpu_torch.frontend.scanner import DeclNode
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.ops import render
from semantic_merge_tpu_torch.ops.diff import KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME
from semantic_merge_tpu_torch.ops.oplog_view import OpStreamView

TS = "2026-01-01T00:00:00Z"
CPU = torch.device("cpu")
#: Strings with every JSON-escaping hazard, and a long one.
NASTY = ['q"uote', "back\\slash", "tab\there", "nl\nline", "bell\x07", "emojié€",
         "del\x7f", "ctl\x1f\x00end", "x" * 300, "plain"]


def test_kind_codes_pinned():
    from semantic_merge_tpu_torch.ops import oplog_view
    assert (oplog_view.KIND_RENAME, oplog_view.KIND_MOVE, oplog_view.KIND_ADD,
            oplog_view.KIND_DELETE) == (KIND_RENAME, KIND_MOVE, KIND_ADD, KIND_DELETE)


def _nodes(rs, n, tag):
    out = []
    for i in range(n):
        name = None if rs.rand() < 0.05 else f"{NASTY[rs.randint(len(NASTY))]}{i}"
        path = f"src/{NASTY[rs.randint(len(NASTY))][:12]}/{tag}{i % 7}.ts"
        out.append(DeclNode(symbolId=f"s{rs.randint(n)}{tag}", addressId=f"{path}::{name}::{i}",
                            kind="FunctionDeclaration", name=name, file=path, pos=i, end=i + 1,
                            signature=""))
    return out


def _view(seed: int, n_rows: int, n_nodes: int = 64):
    """A seeded op stream over nodes with nasty strings: renames only
    between named nodes, as the diff emits them."""
    rs = np.random.RandomState(seed)
    base, side = _nodes(rs, n_nodes, "b"), _nodes(rs, n_nodes, "s")
    kind = rs.randint(0, 4, n_rows).astype(np.int32)
    a = rs.randint(0, n_nodes, n_rows).astype(np.int32)
    b = rs.randint(0, n_nodes, n_rows).astype(np.int32)
    for i in np.nonzero(kind == KIND_RENAME)[0]:
        if base[a[i]].name is None or side[b[i]].name is None:
            kind[i] = KIND_MOVE
    a[kind == KIND_ADD] = -1
    b[kind == KIND_DELETE] = -1
    words = rs.randint(-2**31, 2**31, (n_rows, 4)).astype(np.int32)
    prov = {"rev": f"r{seed}\"\\é", "timestamp": TS}
    return OpStreamView(kind, a, b, words, base, side, prov)


def _jax_bytes(view) -> bytes:
    """The JAX package's DeviceRenderer on the same rows."""
    import jax.numpy as jnp
    from semantic_merge_tpu.core.encode import pad_to as jax_pad_to
    from semantic_merge_tpu.core.encode import bucket_size
    from semantic_merge_tpu.core.ops import dumps_canonical as jax_dumps

    interner = JaxInterner()
    base_t = jax_encode(view.base_nodes, interner)
    side_t = jax_encode(view.side_nodes, interner)

    def table(t):
        bucket = bucket_size(max(t.n, 1))
        return jnp.asarray(np.stack([jax_pad_to(c, bucket, np.int32(-1))
                                     for c in (t.sym, t.addr, t.name, t.file)]))

    handle = JaxRenderer(interner).dispatch(
        view.kind, view.a_slot, view.b_slot, view.words, table(base_t), table(side_t),
        base_t, side_t, jax_dumps(view.prov), require=True)
    return handle.json_bytes()


def _host_bytes(view) -> bytes:
    return ("[" + ",".join(view._json_rows(0, len(view))) + "]").encode()


@pytest.mark.parametrize("seed,n_rows", [(0, 1), (1, 37), (2, 300), (3, 4097)])
def test_render_matches_host_serializer_and_jax(seed, n_rows):
    view = _view(seed, n_rows)
    got = render.render_view(view, CPU).json_bytes()
    assert got == _host_bytes(view)
    assert got == _jax_bytes(view)
    # The host serializer is the reference op-log JSON.
    import json
    assert json.loads(got) == [op.to_dict() for op in view]


def test_render_rows_split_without_separators():
    view = _view(5, 50)
    rows = render.render_view(view, CPU).row_bytes()
    assert rows == [r.encode() for r in view._json_rows(0, len(view))]


def test_view_to_json_bytes_takes_the_render():
    view = _view(6, 20)
    handle = render.render_view(view, CPU)
    view.render = handle
    assert OpLog(view).to_json_bytes() == _host_bytes(view)
    assert handle._buf is not None  # the bytes came from the render


def test_render_width_guard(monkeypatch):
    view = _view(7, 16)
    renderer = render.DeviceRenderer(_interner_of(view), CPU)
    args = _dispatch_args(view, renderer)
    monkeypatch.setenv(render.ENV_MAX_WIDTH, "64")
    assert renderer.dispatch(*args, require=False) is None  # not eligible
    with pytest.raises(KernelFault):
        renderer.dispatch(*args, require=True)


def test_render_failure_raises_not_falls_back():
    view = _view(8, 16)
    handle = render.render_view(view, CPU)

    class Broken:
        def cpu(self):
            raise RuntimeError("device lost")

    handle._buf_dev = Broken()
    view.render = handle
    with pytest.raises(KernelFault):
        view.to_json_bytes()


def test_min_rows_gate(monkeypatch):
    renderer = render.DeviceRenderer(render.Interner(), CPU)
    monkeypatch.delenv(render.ENV_MIN_ROWS, raising=False)
    monkeypatch.delenv(render.ENV_POSTURE, raising=False)
    assert not renderer.eligible(4095) and renderer.eligible(4096)
    assert renderer.eligible(1, posture="require") and not renderer.eligible(0, posture="require")
    assert not renderer.eligible(10**6, posture="off")
    monkeypatch.setenv(render.ENV_MIN_ROWS, "10")
    assert renderer.eligible(10) and not renderer.eligible(9)


def _interner_of(view):
    interner = render.Interner()
    render.encode_decls(view.base_nodes, interner)
    render.encode_decls(view.side_nodes, interner)
    return interner


def _dispatch_args(view, renderer):
    interner = renderer.interner
    base_t = render.encode_decls(view.base_nodes, interner)
    side_t = render.encode_decls(view.side_nodes, interner)

    def table(t):
        bucket = render.bucket_size(max(t.n, 1))
        return torch.tensor(np.stack([render.pad_to(c, bucket, np.int32(-1))
                                      for c in (t.sym, t.addr, t.name, t.file)]))

    return (view.kind, view.a_slot, view.b_slot, view.words, table(base_t), table(side_t),
            base_t, side_t, render.dumps_canonical(view.prov))


# --- through the merge -----------------------------------------------------------

def _nasty_workload():
    base, left, right = [], [], []
    for i, s in enumerate(NASTY[:8]):
        path = f"src/ü{i}.ts"
        content = f"export function fn{i}(x: number): number {{ return {i}; }}\n"
        base.append((path, content))
        left.append((path, content.replace(f"fn{i}(", f"n{i}_{s}(")))
        right.append((f"lib/é{i}.ts", content))
    return base, left, right


def _fn(name, k):
    params = ", ".join(f"p{i}: {t}" for i, t in enumerate(("number", "string", "boolean")[k:]))
    return f"export function {name}({params}): void {{}}\n"


def _workload(name):
    """Three snapshots of at most 8 decls (one compiled JAX shape)."""
    if name == "nasty":
        return _nasty_workload()
    base = [("a.ts", _fn("f", 0) + _fn("g", 1)), ("b.ts", _fn("h", 2))]
    left = [("a.ts", _fn("f2", 0) + _fn("g", 1)), ("b.ts", _fn("h", 2)),
            ("c.ts", "export class K { m(): void {} }\n")]
    other = "f3" if name == "divergent" else "f"
    right = [("lib/a.ts", _fn(other, 0) + _fn("g", 1))]
    return base, left, right


@pytest.mark.parametrize("workload", ["clean", "divergent", "nasty"])
def test_rendered_merge_payloads_match_jax(monkeypatch, workload):
    """Both CLIs' merges with the render forced on every stream: the
    op-log payloads and the composed payload byte-identical to the JAX
    package's, and to the port's own host serializer."""
    monkeypatch.setenv(render.ENV_POSTURE, "require")
    monkeypatch.setenv(render.ENV_MIN_ROWS, "0")
    trees = _workload(workload)
    kw = dict(base_rev="bench", seed="bench", timestamp=TS)
    res_j, comp_j, conf_j = TpuTSBackend(mesh=False).merge(
        *(JaxSnapshot(files=[{"path": p, "content": c} for p, c in t]) for t in trees), **kw)
    backend = TorchTSBackend(device="cpu")
    res_p, comp_p, conf_p = backend.merge(
        *(Snapshot(files=[{"path": p, "content": c} for p, c in t]) for t in trees), **kw)
    assert backend.path == "fused"
    assert res_p.op_log_left.render is not None and res_p.op_log_right.render is not None
    for got, want in ((res_p.op_log_left, res_j.op_log_left),
                      (res_p.op_log_right, res_j.op_log_right)):
        assert OpLog(got).to_json_bytes() == JaxOpLog(want).to_json_bytes()
        assert OpLog(got).to_json_bytes() == _host_bytes(got)
    assert comp_p.to_json_bytes() == comp_j.to_json_bytes()
    assert [c.to_dict() for c in conf_p] == [c.to_dict() for c in conf_j]
    assert bool(conf_p) == (workload == "divergent")
    assert os.environ[render.ENV_POSTURE] == "require"
