"""The port's device diff join against the JAX package's.

Same ``DeclTensor`` columns through JAX ``diff_lift_device`` and the
port's ``diff_lift_device`` on the CPU: every output column must be
byte-equal (dtype included), across duplicate symbols (JS-Map
first-emits / last-wins / repeated adds), null names, padding to the
bucket size, empty sides, and a seeded fuzz.
"""
import numpy as np
import pytest
import torch

from semantic_merge_tpu.core.encode import DeclTensor as JaxDeclTensor
from semantic_merge_tpu.ops.diff import diff_lift_device as jax_diff
from semantic_merge_tpu_torch.core.encode import DeclTensor
from semantic_merge_tpu_torch.ops.diff import diff_lift_device

COLUMNS = ("kind", "sym", "a_addr", "a_name", "a_file",
           "b_addr", "b_name", "b_file")


def _assert_same(base_cols, side_cols):
    jb = JaxDeclTensor(*base_cols, len(base_cols[0]))
    js = JaxDeclTensor(*side_cols, len(side_cols[0]))
    want = jax_diff(jb, js)
    got = diff_lift_device(DeclTensor(*base_cols, len(base_cols[0])),
                           DeclTensor(*side_cols, len(side_cols[0])),
                           torch.device("cpu"))
    assert got.n_ops == want.n_ops
    for col in COLUMNS:
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype == np.int32, col
        assert a.tobytes() == b.tobytes(), (col, a, b)
    return got


def _cols(*rows):
    return tuple(np.asarray(r, dtype=np.int32) for r in rows)


def test_duplicate_symbols_follow_js_map_semantics():
    # base: symbol 5 twice (first emits, last's data wins); side: symbol
    # 9 twice and absent from base (both adds emit); symbol 7 moved and
    # renamed; symbol 6 deleted; null names never rename.
    base = _cols([5, 7, 5, 6, 8], [10, 11, 12, 13, 14], [1, 2, 3, -1, -1], [0, 0, 0, 0, 1])
    side = _cols([7, 9, 5, 9, 8], [21, 22, 12, 23, 24], [4, 1, 3, 1, 2], [1, 1, 0, 1, 1])
    got = _assert_same(base, side)
    kinds = got.kind[:got.n_ops].tolist()
    assert kinds.count(2) == 2  # both raw side slots of symbol 9 add


def test_padding_and_empty_sides():
    one = _cols([3], [4], [5], [6])
    empty = _cols([], [], [], [])
    _assert_same(one, empty)
    _assert_same(empty, one)
    _assert_same(empty, empty)
    # n = 9 pads to the bucket of 12 on both sides.
    nine = _cols(range(9), range(100, 109), range(200, 209), [0] * 9)
    _assert_same(nine, _cols(range(4, 13), range(104, 113), range(200, 209), [1] * 9))


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_parity(seed):
    rs = np.random.RandomState(seed)
    n_sym = rs.randint(2, 20)

    def rand_cols(n):
        return _cols(rs.randint(0, n_sym, n), rs.randint(0, 40, n),
                     rs.randint(-1, 6, n), rs.randint(0, 4, n))

    _assert_same(rand_cols(rs.randint(0, 60)), rand_cols(rs.randint(0, 60)))
