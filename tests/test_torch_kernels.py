"""The port's CUDA kernels against their plain versions, on the card,
and the device compose, the fused merge program and the op-log render
on the card against the CPU.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels)
and are marked ``cuda``; without a card they skip. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

They import no JAX (``--noconftest`` skips the suite's JAX set-up), so
they run where only PyTorch is installed. On the CPU, the wrapper's
plain path and the launch counter are tested.
"""
import hashlib

import numpy as np
import pytest
import torch

from semantic_merge_tpu_torch import kernels
from semantic_merge_tpu_torch.core.ops import Op, Target
from semantic_merge_tpu_torch.ops import fused
from semantic_merge_tpu_torch.ops.compose import compose_oplogs_device
from semantic_merge_tpu_torch.ops.sha256 import sha256_device, sha256_device_plain
from semantic_merge_tpu_torch.parallel.flash import (flash_chunk_attention,
                                                     flash_chunk_attention_plain)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(b, lq, lk, h, dh, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, h, dh, generator=g).to(torch.bfloat16)
               for n in (lq, lk, lk))
    mask = torch.rand(b, lk, generator=g) < 0.7
    mask[:, 0] = True
    mask[-1] = False
    return [t.to(device) for t in (q, k, v, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,dh", [
    (16, 64, 64, 8, 32), (2, 300, 257, 4, 32), (3, 40, 70, 2, 64), (2, 33, 65, 2, 128),
    # edges of the kernel's 64-row / 64-key tiles: one query and one key,
    # ragged query and key tiles, two query blocks, Dh=128 over 16 key tiles
    (4, 1, 1, 8, 32), (6, 17, 65, 8, 32), (6, 65, 64, 8, 32), (3, 130, 1000, 2, 128)])
def test_flash_chunk_kernel_matches_plain(card, b, lq, lk, h, dh):
    inputs = _inputs(b, lq, lk, h, dh, card)
    before = kernels.LAUNCHES["flash_chunk"]
    pv_k, m_k, l_k = flash_chunk_attention(*inputs)
    pv_p, m_p, l_p = flash_chunk_attention_plain(*inputs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_chunk"] == before + 1
    assert kernels.LAUNCH_SHAPES["flash_chunk"][(b, lq, lk, h, dh)] >= 1
    # bf16 inputs, f32 sums in another order: atol/rtol 2e-3.
    torch.testing.assert_close(pv_k / l_k.transpose(1, 2)[..., None],
                               pv_p / l_p.transpose(1, 2)[..., None],
                               atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(l_k * torch.exp(m_k - m_p), l_p, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("lk", [1, 65, 1000])
def test_flash_chunk_kernel_all_masked_row_sums_to_lk(card, lk):
    # Keys past Lk do not exist: a row whose keys are all masked weighs
    # each of its Lk keys by exp(0) = 1, and nothing pads that count.
    inputs = _inputs(3, 20, lk, 2, 32, card, seed=lk)
    pv, m, l = flash_chunk_attention(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(l[-1], torch.full_like(l[-1], float(lk)))
    assert torch.equal(m[-1], torch.full_like(m[-1], -1e30))
    torch.testing.assert_close(pv[-1], inputs[2][-1].float().sum(0, keepdim=True)
                               .expand_as(pv[-1]), atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_flash_chunk_kernel_rejects_what_it_cannot_take(card):
    q, k, v, mask = _inputs(2, 8, 8, 2, 32, card)
    with pytest.raises(ValueError):
        flash_chunk_attention(q.float(), k, v, mask)
    with pytest.raises(ValueError):
        flash_chunk_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)


def test_cpu_tensors_take_the_plain_version_without_counting():
    inputs = _inputs(2, 8, 8, 2, 32, torch.device("cpu"))
    before = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
    got = flash_chunk_attention(*inputs)
    want = flash_chunk_attention_plain(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES == before
    assert kernels.LAUNCH_SHAPES == shapes


def test_reset_launches():
    kernels.LAUNCHES["flash_chunk"] += 3
    kernels.LAUNCH_SHAPES["flash_chunk"][(2, 8, 8, 2, 32)] = 3
    kernels.reset_launches()
    assert kernels.LAUNCHES == {"flash_chunk": 0, "sha256": 0}
    assert kernels.LAUNCH_SHAPES == {"flash_chunk": {}, "sha256": {}}


def _fuzz_oplog(rs, side, n, n_sym):
    types = ("renameSymbol", "moveDecl", "addDecl", "deleteDecl", "editStmtBlock")
    ops = []
    for i in range(n):
        t = types[rs.randint(len(types))]
        params = {}
        if t == "renameSymbol":
            params = {"oldName": "o", "newName": "pqr"[rs.randint(3)], "file": f"f{rs.randint(4)}.ts"}
        elif t == "moveDecl":
            params = {"newAddress": f"addr-{rs.randint(10)}", "newFile": f"g{rs.randint(4)}.ts"}
        ops.append(Op.new(t, Target(f"sym-{rs.randint(n_sym)}", f"base-addr-{i}"), params,
                          provenance={"timestamp": f"2024-0{1 + rs.randint(3)}-01T00:00:00Z"},
                          op_id=f"{side}{i:05d}" + "0" * 26))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_device_compose_on_card_matches_cpu(card, seed):
    # Seeds 0-2 compose thousands of ops over many symbols (no walk, or
    # a rare one), 3-5 a few hundred over few symbols (the walk fires).
    rs = np.random.RandomState(seed)
    n, n_sym = (3000, 2000) if seed < 3 else (300, 6)
    a, b = (_fuzz_oplog(rs, side, rs.randint(n // 2, n), n_sym) for side in "ab")
    got = compose_oplogs_device(a, b, device=card)
    want = compose_oplogs_device(a, b, device="cpu")
    assert [o.to_dict() for o in got[0]] == [o.to_dict() for o in want[0]]
    assert [c.to_dict() for c in got[1]] == [c.to_dict() for c in want[1]]


# --- SHA-256 ----------------------------------------------------------------------

SHA_EDGES = [0, 1, 55, 56, 63, 64, 119, 120]


def _sha_rows(n, blocks, seed):
    rs = np.random.RandomState(seed)
    cap = blocks * 64 - 9
    lens = ([x for x in SHA_EDGES if x <= cap] + list(rs.randint(0, cap + 1, n)))[:n]
    msg = rs.randint(0, 256, (n, blocks * 64)).astype(np.uint8)  # junk past each length
    return msg, np.asarray(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,blocks,n_words", [
    (1, 1, 8), (8, 1, 8), (1000, 1, 4), (129, 2, 8), (300, 3, 8), (32768, 1, 4)])
def test_sha256_kernel_matches_plain_and_hashlib(card, n, blocks, n_words):
    msg, lens = _sha_rows(n, blocks, seed=n + blocks)
    before = kernels.LAUNCHES["sha256"]
    got = sha256_device(torch.from_numpy(msg).to(card), torch.from_numpy(lens).to(card), n_words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sha256"] == before + 1
    assert kernels.LAUNCH_SHAPES["sha256"][(n, blocks, n_words)] >= 1
    want = sha256_device_plain(torch.from_numpy(msg), torch.from_numpy(lens), n_words)
    assert torch.equal(got.cpu(), want)
    words = got.cpu().numpy().view(np.uint32)
    for i in range(min(n, 64)):
        digest = hashlib.sha256(msg[i, :lens[i]].tobytes()).hexdigest()
        assert "".join(f"{int(w):08x}" for w in words[i]) == digest[:8 * n_words]


@pytest.mark.cuda
def test_sha256_kernel_rejects_what_it_cannot_take(card):
    msg = torch.zeros((4, 65), dtype=torch.uint8, device=card)
    lens = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        sha256_device(msg, lens)                              # not whole blocks
    with pytest.raises(ValueError):
        sha256_device(msg[:, :64].contiguous(), lens.long())  # lengths not int32
    with pytest.raises(ValueError):
        sha256_device(torch.zeros(4 * 64 + 1, dtype=torch.uint8, device=card)[1:]
                      .view(4, 64), lens)                     # not 16-byte aligned
    before = kernels.LAUNCHES["sha256"]
    empty = sha256_device(torch.zeros((0, 64), dtype=torch.uint8, device=card),
                          torch.zeros(0, dtype=torch.int32, device=card))
    assert tuple(empty.shape) == (0, 8) and kernels.LAUNCHES["sha256"] == before


def test_sha256_cpu_tensors_take_the_plain_version_without_counting():
    msg, lens = _sha_rows(5, 1, seed=0)
    before = dict(kernels.LAUNCHES)
    got = sha256_device(torch.from_numpy(msg), torch.from_numpy(lens))
    assert torch.equal(got, sha256_device_plain(torch.from_numpy(msg), torch.from_numpy(lens)))
    assert kernels.LAUNCHES == before


# --- the fused merge program and the render ------------------------------------------

def _program_inputs(seed, n=48):
    rs = np.random.RandomState(seed)
    n_sym = rs.randint(4, 4 * n)
    cols = []
    for _ in range(3):
        c = np.full((4, n), -1, np.int32)
        c[0] = 2**31 - 1
        k = rs.randint(n // 2, n + 1)
        c[:, :k] = np.stack([rs.randint(0, n_sym, k), rs.randint(0, 900, k),
                             rs.randint(-1, 40, k), rs.randint(0, 30, k)])
        cols.append(c)
    tab = rs.randint(0, 256, (1024, 10)).astype(np.uint8)
    digs = [rs.randint(0, 256, 16).astype(np.uint8) for _ in range(2)]
    return [torch.from_numpy(x) for x in (*cols, tab, *digs)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,C", [(0, 48, 128), (1, 48, 16), (2, 768, 2048)])
def test_fused_merge_program_on_card_matches_cpu(card, seed, n, C):
    inputs = _program_inputs(seed, n)
    before = kernels.LAUNCHES["sha256"]
    got = fused._fused_merge_program(*(t.to(card) for t in inputs), C)
    want = fused._fused_merge_program(*inputs, C)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sha256"] == before + 2  # one per side
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(card):
    from semantic_merge_tpu_torch.frontend.scanner import DeclNode
    from semantic_merge_tpu_torch.ops.oplog_view import OpStreamView
    from semantic_merge_tpu_torch.ops.render import render_view

    rs = np.random.RandomState(0)
    names = ['q"uote', "back\\slash", "nl\nline", "é€", "x" * 200, "plain"]
    nodes = [DeclNode(symbolId=f"s{i}", addressId=f"f{i % 9}.ts::{names[i % 6]}::{i}",
                      kind="FunctionDeclaration", name=f"{names[i % 6]}{i}",
                      file=f"src/{names[i % 6][:5]}/f{i % 9}.ts", pos=i, end=i + 1, signature="")
             for i in range(200)]
    n = 5000
    view = OpStreamView(rs.randint(0, 4, n).astype(np.int32), rs.randint(0, 200, n).astype(np.int32),
                        rs.randint(0, 200, n).astype(np.int32),
                        rs.randint(-2**31, 2**31, (n, 4)).astype(np.int32),
                        nodes, nodes[::-1], {"rev": "r", "timestamp": "t"})
    got = render_view(view, card).json_bytes()
    assert got == render_view(view, "cpu").json_bytes()
    assert got == ("[" + ",".join(view._json_rows(0, n)) + "]").encode()
