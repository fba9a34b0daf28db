"""The port's device compose against the JAX package's.

The same op logs (built as JAX ``Op`` records and copied into the
port's through ``to_dict``) go through the port's
``compose_oplogs_device(..., device="cpu")``, the JAX package's device
compose (``ops/compose.py``, its lazy view materialized with ``list()``)
and its host composer (``core/compose.py::compose_oplogs``). The
composed streams and the conflicts must be equal as ``to_dict()``,
exactly, on:

- the composer cases of ``tests/test_compose.py``;
- the compose cases of ``tests/test_device_parity.py`` (divergent
  rename, masked quirk, newName type sensitivity, empty newFile);
- a seeded numpy fuzz of up to 256 ops a side over shared symbols and
  timestamps, with every op type the diff emits plus ``editStmtBlock``
  and ``modifyImport`` (compose orders any type by its precedence), in
  which the DivergentRename walk fires in some seeds and not in others.

The segmented last-valid scan is also held against a plain loop, and
the op encoding against the JAX package's.
"""
import numpy as np
import pytest
import torch

from semantic_merge_tpu.core.compose import compose_oplogs
from semantic_merge_tpu.core.encode import Interner as JaxInterner
from semantic_merge_tpu.core.encode import build_rank_tables as jax_rank_tables
from semantic_merge_tpu.core.encode import encode_oplog as jax_encode_oplog
from semantic_merge_tpu.core.ops import Op as JaxOp
from semantic_merge_tpu.core.ops import Target as JaxTarget
from semantic_merge_tpu.ops.compose import compose_oplogs_device as jax_compose_device
from semantic_merge_tpu_torch.core.encode import (NULL_ID, OP_COLUMNS, Interner,
                                                  build_rank_tables, encode_oplog)
from semantic_merge_tpu_torch.core.ops import Op
from semantic_merge_tpu_torch.ops.compose import _seg_last_valid, compose_oplogs_device

TS = "2024-01-01T00:00:00Z"


def mk(op_type, sym, params=None, ts=TS, op_id=None, addr=None):
    return JaxOp.new(op_type, JaxTarget(symbolId=sym, addressId=addr),
                     params=params or {}, provenance={"timestamp": ts}, op_id=op_id)


def _port(ops):
    return [Op.from_dict(o.to_dict()) for o in ops]


def _dicts(seq):
    return [x.to_dict() for x in seq]


def _compose_all(a, b):
    """(host, JAX device, port) results as to_dict lists; the inputs of
    the port are copies, which the port must not mutate."""
    host = compose_oplogs(a, b)
    jax_dev = jax_compose_device(a, b)
    pa, pb = _port(a), _port(b)
    before = (_dicts(pa), _dicts(pb))
    port = compose_oplogs_device(pa, pb, device="cpu")
    assert (_dicts(pa), _dicts(pb)) == before
    return [(_dicts(ops), _dicts(conf)) for ops, conf in (host, (list(jax_dev[0]), jax_dev[1]),
                                                           port)]


def _assert_same(a, b):
    host, jax_dev, port = _compose_all(a, b)
    assert port == jax_dev == host
    return port


# --- the composer cases of tests/test_compose.py ------------------------------

def _rename_foo_bar():
    return mk("renameSymbol", "sym-1", {"oldName": "foo", "newName": "bar",
                                        "file": "src/util.ts"}, op_id="a" * 32)


def _move_util_to_lib():
    return mk("moveDecl", "sym-1", {"oldFile": "src/util.ts", "newFile": "lib/util.ts",
                                    "oldAddress": "src/util.ts::foo::0",
                                    "newAddress": "lib/util.ts::foo::0"}, op_id="b" * 32)


def _rename(sym, name, op_id, ts=TS):
    return mk("renameSymbol", sym, {"newName": name}, ts=ts, op_id=op_id * 32)


CASES = {
    "move_rewrites_own_target": lambda: (
        [mk("moveDecl", "sym-1", {"newAddress": "new-addr"}, addr="old-addr")], []),
    "rename_from_a_move_from_b": lambda: ([_rename_foo_bar()], [_move_util_to_lib()]),
    "divergent_rename_head_vs_head": lambda: (
        [_rename("s", "x", "1")], [_rename("s", "y", "2")]),
    "divergent_rename_b_sorts_first": lambda: (
        [_rename("s", "x", "9")], [_rename("s", "y", "1")]),
    "same_rename_both_sides": lambda: ([_rename("s", "x", "1")], [_rename("s", "x", "2")]),
    "interleaved_op_masks_conflict": lambda: (
        [_rename("s", "x", "1")], [_rename("unrelated", "n", "2"), _rename("s", "y", "3")]),
    "id_never_decides_cross_stream_order": lambda: (
        [_rename("s", "x", "2")], [_rename("unrelated", "n", "1"), _rename("s", "y", "3")]),
    "earlier_timestamped_b_op_then_conflict": lambda: (
        [_rename("s", "x", "2")],
        [_rename("unrelated", "n", "1", ts="2023-01-01T00:00:00Z"), _rename("s", "y", "3")]),
    "rename_context_on_other_ops": lambda: (
        [_rename("s", "bar", "1"), mk("editStmtBlock", "s", {}, op_id="2" * 32)], []),
    "move_chain_merges_address_and_file": lambda: (
        [mk("moveDecl", "s", {"newAddress": "addr1"}, op_id="1" * 32),
         mk("moveDecl", "s", {"newFile": "f2.ts"}, op_id="2" * 32)], []),
    "ties_prefer_side_a": lambda: (
        [mk("addDecl", "s1", {"file": "a.ts"}, op_id="5" * 32)],
        [mk("addDecl", "s2", {"file": "b.ts"}, op_id="5" * 32)]),
    "precedence_before_timestamp": lambda: (
        [mk("addDecl", "a", {"file": "f.ts"}, ts="2020-01-01T00:00:00Z"),
         mk("moveDecl", "m", {"newAddress": "x"}, ts="2025-01-01T00:00:00Z")], []),
    "one_side_empty": lambda: ([], [_rename_foo_bar(), _move_util_to_lib()]),
    "both_sides_empty": lambda: ([], []),
    # the compose cases of tests/test_device_parity.py
    "parity_rename_vs_move_chain": lambda: ([_rename_foo_bar()], [_move_util_to_lib()]),
    "parity_newname_int_vs_str_conflicts": lambda: (
        [mk("renameSymbol", "s", {"newName": 1}, op_id="1" * 32)],
        [mk("renameSymbol", "s", {"newName": "1"}, op_id="2" * 32)]),
    "parity_newname_int_vs_float_agree": lambda: (
        [mk("renameSymbol", "s", {"newName": 1}, op_id="1" * 32)],
        [mk("renameSymbol", "s", {"newName": 1.0}, op_id="3" * 32)]),
    "parity_newname_none_vs_str": lambda: (
        [mk("renameSymbol", "s", {}, op_id="1" * 32), mk("addDecl", "s", {}, op_id="4" * 32)],
        [mk("renameSymbol", "s", {"newName": "None"}, op_id="2" * 32)]),
    "parity_empty_newfile_falls_back_to_file": lambda: (
        [mk("moveDecl", "s", {"newAddress": "A2", "newFile": "", "file": "x.ts"},
            op_id="3" * 32),
         mk("editStmtBlock", "s", {}, op_id="4" * 32)], []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compose_case_matches_jax(case):
    a, b = CASES[case]()
    _assert_same(a, b)


def test_cases_cover_conflicts_and_masking():
    # The cases exercise what they are named for (read off the port's result).
    def n_conflicts(case):
        return len(_assert_same(*CASES[case]())[1])
    assert n_conflicts("divergent_rename_head_vs_head") == 1
    assert n_conflicts("earlier_timestamped_b_op_then_conflict") == 1
    assert n_conflicts("interleaved_op_masks_conflict") == 0
    assert n_conflicts("parity_newname_int_vs_str_conflicts") == 1
    assert n_conflicts("parity_newname_int_vs_float_agree") == 0


# --- seeded fuzz ---------------------------------------------------------------

FUZZ_TYPES = ("renameSymbol", "moveDecl", "addDecl", "deleteDecl",
              "editStmtBlock", "modifyImport")
FUZZ_STAMPS = ("2024-01-01T00:00:00Z", "2024-06-01T00:00:00Z", "2025-01-01T00:00:00Z")


def _fuzz_logs(seed):
    """Two logs of up to 256 ops over a few shared symbols, names, files
    and timestamps, so renames collide across the sides."""
    rs = np.random.RandomState(seed)
    n_sym = rs.randint(3, 40)

    def log(side, n):
        ops = []
        for i in range(n):
            t = FUZZ_TYPES[rs.randint(len(FUZZ_TYPES))]
            sym = f"sym-{rs.randint(n_sym)}"
            params = {}
            if t == "renameSymbol":
                params = {"oldName": "o", "newName": "pqr"[rs.randint(3)],
                          "file": f"f{rs.randint(4)}.ts"}
            elif t == "moveDecl":
                if rs.rand() < 0.8:
                    params["newAddress"] = f"addr-{rs.randint(10)}"
                if rs.rand() < 0.5:
                    params["newFile"] = f"g{rs.randint(4)}.ts"
                elif rs.rand() < 0.5:
                    params["file"] = f"h{rs.randint(4)}.ts"
            elif t == "modifyImport":
                params = {"file": f"f{rs.randint(4)}.ts", "oldImport": "a", "newImport": "b"}
            ops.append(mk(t, sym, params, ts=FUZZ_STAMPS[rs.randint(len(FUZZ_STAMPS))],
                          op_id=f"{side}{rs.randint(10**6):06d}{i:04d}" + "0" * 22,
                          addr=f"base-addr-{i}"))
        return ops

    # Most seeds fill the 256-row bucket, every fourth stays under 8
    # rows: two padded shapes, so the JAX program compiles twice.
    sizes = (193, 257) if seed % 4 else (0, 9)
    return log("a", rs.randint(*sizes)), log("b", rs.randint(*sizes))


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_matches_jax(seed):
    _assert_same(*_fuzz_logs(seed))


def test_fuzz_walk_fires_in_some_seeds_only():
    fired = [bool(compose_oplogs(*_fuzz_logs(seed))[1]) for seed in range(24)]
    assert 0 < sum(fired) < len(fired)


# --- pieces ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_segmented_last_valid_scan_matches_loop(seed):
    rs = np.random.RandomState(seed)
    n = rs.randint(1, 200)
    seg_sym = np.sort(rs.randint(0, rs.randint(1, 12), n))
    vals = np.where(rs.rand(3, n) < 0.3, rs.randint(0, 50, (3, n)), NULL_ID)
    got = _seg_last_valid(torch.from_numpy(seg_sym), torch.from_numpy(vals)).numpy()
    want = np.full_like(vals, NULL_ID)
    for k in range(3):
        last = NULL_ID
        for i in range(n):
            if i and seg_sym[i] != seg_sym[i - 1]:
                last = NULL_ID
            if vals[k, i] != NULL_ID:
                last = vals[k, i]
            want[k, i] = last
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_op_encoding_matches_jax(seed):
    a, b = _fuzz_logs(seed)
    jt, jid = jax_rank_tables(a, b)
    pt, pid = build_rank_tables(_port(a), _port(b))
    assert (pt, pid) == (jt, jid)
    ji, pi = JaxInterner(), Interner()
    for ops in (a, b):
        want = jax_encode_oplog(ops, ji, jt, jid)
        got = encode_oplog(_port(ops), pi, pt, pid)
        assert got.n == want.n
        for col in OP_COLUMNS:
            assert getattr(got, col).tobytes() == getattr(want, col).tobytes(), col
    assert pi.strings == ji.strings
