"""The port's sharded merge programs against the JAX package's.

The JAX side runs ``ops/sharded.py`` (and the fused merge's
``_sharded_fn``) on the virtual 8-device CPU mesh of ``conftest.py``, as
``tests/test_sharded_merge.py`` does (the dp = 6 cases on a 6-device
mesh). The port's side runs ``semantic_merge_tpu_torch/ops/sharded.py``
and ``ops/fused.py::_fused_merge_sharded`` in one gloo process group per
world size (8, 6 and 2 ranks on the CPU, ``torch_mesh_worker.py``),
started once for the module; every case runs inside it as its own test.
Each case holds every rank's bytes against both the JAX sharded
function's and the port's single-device program's:

- the diff sort-join: a fuzz of up to 1,100 decls a side, heavy symbol
  collisions (first occurrence emits, last occurrence's data wins across
  shard edges), the pair program, empty and one-decl sides, dp = 6;
- the compose: a fuzz of up to 1,000 ops a side, a divergent rename whose
  two ops land on different shards, a move chain spanning several shard
  edges, dp = 6;
- the fused merge's packed one-buffer rows (diff slots, SHA-256 op ids
  hashed per rank with their global op indices, compose);
- the distributed segmented scan against the one-device scan at the
  int32 extremes.
"""
import random

import numpy as np
import pytest
import torch

import jax

from semantic_merge_tpu.core.encode import DeclTensor as JaxDecls
from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.core.ops import Target as JaxTarget
from semantic_merge_tpu.ops.fused import _sharded_fn as jax_fused_sharded_fn
from semantic_merge_tpu.ops.sharded import compose_oplogs_device_sharded as jax_compose
from semantic_merge_tpu.ops.sharded import diff_lift_device_pair_sharded as jax_diff_pair
from semantic_merge_tpu.ops.sharded import diff_lift_device_sharded as jax_diff
from semantic_merge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from semantic_merge_tpu_torch.core.encode import NULL_ID, PAD_ID, DeclTensor
from semantic_merge_tpu_torch.core.ops import Op
from semantic_merge_tpu_torch.ops.compose import _seg_last_valid, compose_oplogs_device
from semantic_merge_tpu_torch.ops.diff import _padded_cols, diff_lift_device
from semantic_merge_tpu_torch.ops.diff import diff_lift_device_pair
from semantic_merge_tpu_torch.ops.fused import _fused_merge_program

from torch_mesh_worker import GlooGroup

FIELDS = ("kind", "sym", "a_addr", "a_name", "a_file", "b_addr", "b_name", "b_file")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=[8, 6, 2], ids=lambda w: f"world{w}")
def group(request):
    g = GlooGroup(request.param)
    yield g
    g.close()


@pytest.fixture(scope="module")
def mesh8():
    return jax_build_mesh(jax.devices(), dp=8, pp=1, sp=1, tp=1, ep=1).mesh


@pytest.fixture(scope="module")
def mesh6():
    return jax_build_mesh(jax.devices()[:6], dp=6, pp=1, sp=1, tp=1, ep=1).mesh


#: The JAX results of each case, computed once for all world sizes.
_JAX: dict = {}


def _jax_once(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


# --- inputs ---------------------------------------------------------------------

def rand_decls(rng, n: int, n_syms: int):
    sym = rng.integers(0, n_syms, n).astype(np.int32)
    addr = rng.integers(100, 100 + 3 * max(n, 1), n).astype(np.int32)
    name = rng.integers(0, max(n_syms // 2, 2), n).astype(np.int32)
    name[rng.random(n) < 0.1] = -1  # anonymous decls
    file = rng.integers(500, 530, n).astype(np.int32)
    return DeclTensor(sym=sym, addr=addr, name=name, file=file, n=n)


def _jax_decls(t: DeclTensor):
    return JaxDecls(sym=t.sym, addr=t.addr, name=t.name, file=t.file, n=t.n)


def _trim(t):
    return t.n_ops, {f: np.asarray(getattr(t, f))[:t.n_ops].tolist() for f in FIELDS}


def _check_diff(group, key, base, side, mesh):
    want = _jax_once(key, lambda: _trim(jax_diff(_jax_decls(base), _jax_decls(side), mesh)))
    assert _trim(diff_lift_device(base, side, CPU)) == want
    assert group.run("diff", base, side) == [want] * group.world


def mk(op_type, sym, params=None, ts="2024-01-01T00:00:00Z", op_id=None, addr=None):
    return JaxOp.new(op_type, JaxTarget(symbolId=sym, addressId=addr), params=params or {},
                     provenance={"timestamp": ts}, op_id=op_id)


def rand_ops(rng: random.Random, n: int, side: str, n_syms: int = 40):
    types = ["renameSymbol", "moveDecl", "addDecl", "deleteDecl", "editStmtBlock",
             "modifyImport"]
    out = []
    for i in range(n):
        t = rng.choice(types)
        params = {}
        if t == "renameSymbol":
            params = {"oldName": "o", "newName": rng.choice(["p", "q", "r"]),
                      "file": f"f{rng.randint(0, 3)}.ts"}
        elif t == "moveDecl":
            if rng.random() < 0.8:
                params["newAddress"] = f"addr-{rng.randint(0, 9)}"
            if rng.random() < 0.5:
                params["newFile"] = f"g{rng.randint(0, 3)}.ts"
            elif rng.random() < 0.5:
                params["file"] = f"h{rng.randint(0, 3)}.ts"
        ts = rng.choice(["2024-01-01T00:00:00Z", "2024-06-01T00:00:00Z"])
        out.append(mk(t, f"sym-{rng.randint(0, n_syms)}", params, ts=ts,
                      op_id=f"{side}{i:04d}" + "0" * 27, addr=f"ba-{i}"))
    return out


def _dicts(seq):
    return [x.to_dict() for x in seq]


def _check_compose(group, key, a, b, mesh):
    def jax_side():
        ops, conflicts = jax_compose(a, b, mesh)
        return _dicts(ops), _dicts(conflicts)

    want = _jax_once(key, jax_side)
    pa = [Op.from_dict(o.to_dict()) for o in a]
    pb = [Op.from_dict(o.to_dict()) for o in b]
    ops, conflicts = compose_oplogs_device(pa, pb, CPU)
    assert (_dicts(ops), _dicts(conflicts)) == want
    assert group.run("compose", pa, pb) == [want] * group.world
    return want


# --- the diff sort-join ---------------------------------------------------------------

def test_diff_fuzz_1k_decls(group, mesh8):
    rng = np.random.default_rng(42)
    for trial in range(2):
        nb, ns = int(rng.integers(1, 1100)), int(rng.integers(1, 1100))
        base = rand_decls(rng, nb, max(nb // 2, 4))
        side = rand_decls(rng, ns, max(nb // 2, 4))
        _check_diff(group, ("fuzz", trial), base, side, mesh8)


def test_diff_duplicate_symbols_collide_last_wins(group, mesh8):
    rng = np.random.default_rng(7)
    _check_diff(group, "dups", rand_decls(rng, 700, 5), rand_decls(rng, 650, 5), mesh8)


def test_diff_pair_program(group, mesh8):
    rng = np.random.default_rng(3)
    base, left, right = (rand_decls(rng, n, 400) for n in (900, 930, 880))

    def jax_side():
        return [_trim(t) for t in jax_diff_pair(*map(_jax_decls, (base, left, right)), mesh8)]

    want = _jax_once("pair", jax_side)
    assert [_trim(t) for t in diff_lift_device_pair(base, left, right, CPU)] == want
    assert group.run("diff_pair", base, left, right) == [want] * group.world


@pytest.mark.parametrize("case", ["empty_one", "one_empty", "empty_empty", "one_one"])
def test_diff_empty_and_tiny(group, mesh8, case):
    rng = np.random.default_rng(5)
    one = rand_decls(rng, 1, 1)
    empty = DeclTensor.empty()
    b, s = {"empty_one": (empty, one), "one_empty": (one, empty),
            "empty_empty": (empty, empty), "one_one": (one, one)}[case]
    _check_diff(group, ("tiny", case), b, s, mesh8)


def test_diff_dp6(group, mesh6):
    rng = np.random.default_rng(17)
    _check_diff(group, "dp6", rand_decls(rng, 333, 100), rand_decls(rng, 200, 100), mesh6)


# --- the compose ---------------------------------------------------------------------

def test_compose_fuzz_1k_ops(group, mesh8):
    rng = random.Random(11)
    walked = 0
    for trial in range(2):
        a = rand_ops(rng, rng.randint(0, 1000), "a")
        b = rand_ops(rng, rng.randint(0, 1000), "b")
        walked += bool(_check_compose(group, ("compose", trial), a, b, mesh8)[1])
    assert walked  # the conflict walk ran in at least one trial


def test_compose_divergent_rename_across_shards(group, mesh8):
    ra = mk("renameSymbol", "s", {"newName": "x"}, op_id="1" * 32)
    rb = mk("renameSymbol", "s", {"newName": "y"}, op_id="2" * 32)
    a = [ra] + rand_ops(random.Random(1), 500, "a", n_syms=500)
    b = rand_ops(random.Random(2), 500, "b", n_syms=500) + [rb]
    _, conflicts = _check_compose(group, "divergent", a, b, mesh8)
    assert conflicts


def test_compose_chain_spans_shard_boundaries(group, mesh8):
    ops_a = [mk("moveDecl", "sym-x", {"newAddress": f"A{i}", "newFile": f"m{i}.ts"},
                ts=f"2024-01-0{i + 1}T00:00:00Z", op_id=f"a{i:03d}" + "0" * 28, addr="ba")
             for i in range(4)]
    ops_b = [mk("editStmtBlock", "sym-x", {}, ts="2024-06-01T00:00:00Z",
                op_id=f"b{i:03d}" + "0" * 28, addr="ba") for i in range(600)]
    ops, conflicts = _check_compose(group, "chain", ops_a, ops_b, mesh8)
    assert not conflicts


def test_compose_dp6(group, mesh6):
    rng = random.Random(23)
    _check_compose(group, "compose_dp6", rand_ops(rng, 250, "a"), rand_ops(rng, 190, "b"), mesh6)


def test_compose_empty(group):
    assert group.run("compose", [], []) == [([], [])] * group.world


# --- the fused merge ---------------------------------------------------------------------

def test_fused_sharded_rows(group, mesh8):
    """Decl buckets and a capacity divisible by 24 split over 2, 6 and 8
    ranks."""
    rng = np.random.default_rng(768)
    size = C = 768
    b, l, r = (_padded_cols(rand_decls(rng, n, 300), size).astype(np.int32)
               for n in (600, 590, 610))
    hash_tab = rng.integers(0, 256, (1024, 10)).astype(np.uint8)
    dig_l, dig_r = (rng.integers(0, 256, 16).astype(np.uint8) for _ in range(2))
    args = (b, l, r, hash_tab, dig_l, dig_r)

    def jax_side():
        fn = jax_fused_sharded_fn(mesh8, size, size, size, C, 8)
        return np.asarray(fn(*args))

    want = _jax_once("fused", jax_side)
    single = _fused_merge_program(*(torch.from_numpy(a) for a in args), C).numpy()
    np.testing.assert_array_equal(single, want)
    assert not want[4] and want[0] > 100 and want[1] > 100  # no overflow, many ops
    for row in group.run("fused", *args, C):
        np.testing.assert_array_equal(row, want)


# --- the distributed scan ------------------------------------------------------------------

def test_dist_seg_scan_int32_extremes(group):
    """Symbols and values at the int32 ends (``PAD_ID`` segments, the
    largest ids), long segments over several shards and short ones on
    shard edges: the distributed scan equals the one-device scan."""
    rng = np.random.default_rng(99)
    n = 24 * 40
    syms = np.sort(rng.choice(np.array([-2**31, -1, 0, 1, 7, 2**31 - 2, int(PAD_ID)],
                                       dtype=np.int64), n))
    vals = rng.choice(np.array([NULL_ID, 0, 1, 2**31 - 2, 2**31 - 1], dtype=np.int64),
                      (3, n), p=[0.7, 0.1, 0.1, 0.05, 0.05])
    vals[:, :100] = NULL_ID  # leading shards carry nothing in
    want = _seg_last_valid(torch.from_numpy(syms), torch.from_numpy(vals)).numpy()
    for got in group.run("scan", syms, vals):
        np.testing.assert_array_equal(got, want)


def test_rank_layout(group):
    """Every rank sits at its own ``dp`` coordinate of a ``dp = world``
    mesh."""
    got = group.run("rank")
    assert [(r, i) for r, i, _ in got] == [(r, r) for r in range(group.world)]
    assert all(sizes == {"dp": group.world, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
               for _, _, sizes in got)
