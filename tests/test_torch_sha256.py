"""The port's batched SHA-256 (plain PyTorch version) against hashlib and JAX.

``semantic_merge_tpu_torch/ops/sha256.py::sha256_device`` runs the CUDA
kernel on a card and :func:`sha256_device_plain` on the CPU; the kernel
itself is held against the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``). Here, on seeded
numpy messages: every row's digest words equal ``hashlib``'s and the
JAX package's ``_sha256_jit`` on the same rows, bit for bit, at fuzzed
lengths and capacities of 1-3 blocks and at the padding edges (lengths
0, 1, 55, 56, 63, 64, 119, 120). Bytes past a row's length are filled
with junk, which must be ignored.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from semantic_merge_tpu.ops.sha256 import _sha256_jit
from semantic_merge_tpu_torch.ops.sha256 import as_int32_bits, sha256_device, sha256_device_plain

EDGES = [0, 1, 55, 56, 63, 64, 119, 120]


def _rows(rs, lens, blocks):
    msg = rs.randint(0, 256, (len(lens), blocks * 64)).astype(np.uint8)  # junk past len
    return msg, np.asarray(lens, np.int32)


def _hex(words_row) -> str:
    return "".join(f"{int(w):08x}" for w in np.asarray(words_row).view(np.uint32))


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_plain_matches_hashlib_and_jax(blocks):
    rs = np.random.RandomState(blocks)
    cap = blocks * 64 - 9
    lens = [n for n in EDGES if n <= cap] + list(rs.randint(0, cap + 1, 41))
    msg, ln = _rows(rs, lens, blocks)
    got = sha256_device(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    assert got.dtype == np.int32 and got.shape == (len(lens), 8)
    want = np.asarray(_sha256_jit(msg, ln, n_words=8)).view(np.int32)
    assert got.tobytes() == want.tobytes()
    for i, n in enumerate(lens):
        assert _hex(got[i]) == hashlib.sha256(msg[i, :n].tobytes()).hexdigest(), n


@pytest.mark.parametrize("n_words", [1, 4, 8])
def test_leading_words(n_words):
    rs = np.random.RandomState(7)
    msg, ln = _rows(rs, [51] * 5 + EDGES[:6], 1)
    got = sha256_device_plain(torch.from_numpy(msg), torch.from_numpy(ln), n_words).numpy()
    full = sha256_device_plain(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    assert got.shape == (11, n_words)
    assert got.tobytes() == np.ascontiguousarray(full[:, :n_words]).tobytes()
    if n_words == 4:  # the op ids' width, as the fused path asks for it
        want = np.asarray(_sha256_jit(msg, ln, n_words=4)).view(np.int32)
        assert got.tobytes() == want.tobytes()


def test_one_row_and_no_rows():
    msg = np.zeros((1, 64), np.uint8)
    msg[0, :3] = np.frombuffer(b"abc", np.uint8)
    got = sha256_device(torch.from_numpy(msg), torch.tensor([3], dtype=torch.int32)).numpy()
    assert _hex(got[0]) == hashlib.sha256(b"abc").hexdigest()
    empty = sha256_device(torch.zeros((0, 64), dtype=torch.uint8),
                          torch.zeros(0, dtype=torch.int32), n_words=4)
    assert tuple(empty.shape) == (0, 4)


def test_int32_bits_are_a_bitcast():
    words = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.long)
    got = as_int32_bits(words).numpy()
    assert got.view(np.uint32).tolist() == words.tolist()


def test_wrapper_refuses_other_devices():
    msg = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        sha256_device(msg, torch.zeros(2, dtype=torch.int32, device="meta"))
