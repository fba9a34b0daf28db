"""The port's CUDA kernels against their plain versions, on the card,
and the device compose, the fused merge program and the op-log render
on the card against the CPU.

These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels)
and are marked ``cuda``; without a card they skip. On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

They import no JAX (``--noconftest`` skips the suite's JAX set-up), so
they run where only PyTorch is installed. On the CPU, the wrapper's
plain path and the launch counter are tested, and the ring of two steps
(its ranks as threads of one process, the shifts done locally) against
the one-device attention of the whole sequence.
"""
import hashlib
import threading

import numpy as np
import pytest
import torch

from semantic_merge_tpu_torch import kernels
from semantic_merge_tpu_torch.core.ops import Op, Target
from semantic_merge_tpu_torch.ops import fused
from semantic_merge_tpu_torch.ops.compose import compose_oplogs_device
from semantic_merge_tpu_torch.ops.sha256 import sha256_device, sha256_device_plain
from semantic_merge_tpu_torch.parallel.flash import (flash_attention_backward_plain,
                                                     flash_chunk_attention,
                                                     flash_chunk_attention_plain,
                                                     flash_chunk_backward)
from semantic_merge_tpu_torch.parallel.ring import ring_attention, ring_backward, ring_forward


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


def _bwd_inputs(b, lq, lk, h, dh, device, seed=0):
    """The forward's inputs, its saved m, l and f32 output, and a bf16
    output gradient."""
    q, k, v, mask = _inputs(b, lq, lk, h, dh, device, seed)
    pv, m, l = flash_chunk_attention_plain(q, k, v, mask)
    o = (pv / l.transpose(1, 2)[..., None]).contiguous()
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(b, lq, h, dh, generator=g).to(torch.bfloat16).to(device)
    return q, k, v, mask, m, l, o, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,dh", [
    # the training shape and the matcher's inference shapes
    (32, 64, 64, 8, 32), (256, 64, 64, 8, 32), (384, 64, 64, 8, 32),
    # several query tiles, several key tiles (dq summed in f32 scratch),
    # ragged tiles, one query and one key, Dh=64 and 128
    (2, 130, 64, 2, 32), (2, 40, 200, 2, 32), (6, 17, 65, 8, 32), (4, 1, 1, 8, 32),
    (3, 40, 70, 2, 64), (2, 33, 130, 2, 128)])
def test_flash_chunk_bwd_kernel_matches_plain(card, b, lq, lk, h, dh):
    inputs = _bwd_inputs(b, lq, lk, h, dh, card)
    before = kernels.LAUNCHES["flash_chunk_bwd"]
    got = flash_chunk_backward(*inputs)
    want = flash_attention_backward_plain(*inputs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_chunk_bwd"] == before + 1
    assert kernels.LAUNCH_SHAPES["flash_chunk_bwd"][(b, lq, lk, h, dh)] >= 1
    # bf16 outputs of f32 sums taken in another order: atol/rtol 1e-2.
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.bfloat16, name
        torch.testing.assert_close(g_.float(), w_, atol=1e-2, rtol=1e-2, msg=name)
    # The all-masked last row sends no gradient to its q and its keys.
    assert not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,dh", [(32, 64, 64, 8, 32), (2, 130, 200, 2, 64)])
def test_flash_chunk_bwd_kernel_is_deterministic(card, b, lq, lk, h, dh):
    # No atomics: dq over several key tiles sums in an f32 row that one
    # CTA owns, so two launches on the same inputs give the same bits.
    inputs = _bwd_inputs(b, lq, lk, h, dh, card, seed=7)
    first = flash_chunk_backward(*inputs)
    second = flash_chunk_backward(*inputs)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16)), name


@pytest.mark.cuda
def test_ring_attention_backward_launches_the_kernel(card):
    q, k, v, mask = (t.requires_grad_() if t.dtype == torch.bfloat16 else t
                     for t in _inputs(4, 64, 64, 8, 32, card, seed=3))
    before = dict(kernels.LAUNCHES)
    out = ring_attention(q, k, v, mask)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_chunk"] == before["flash_chunk"] + 1
    assert kernels.LAUNCHES["flash_chunk_bwd"] == before["flash_chunk_bwd"] + 1
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


class _LocalRing:
    """``n`` ranks of a ring as threads of one process: a shift hands each
    rank's tensors to the next, with no process group."""

    def __init__(self, n):
        self.n, self.slots, self.barrier = n, [None] * n, threading.Barrier(n)

    def shifter(self, pos):
        def shift(tensors):
            self.slots[pos] = [t.clone() for t in tensors]
            self.barrier.wait()
            got = self.slots[(pos - 1) % self.n]
            self.barrier.wait()
            return got
        return shift

    def run(self, fn):
        """``fn(pos, shift)`` on every rank at once; the results in rank order."""
        out, errors = [None] * self.n, []

        def body(pos):
            try:
                out[pos] = fn(pos, self.shifter(pos))
            except BaseException as exc:  # noqa: BLE001 (re-raised below)
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(pos,)) for pos in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _ring_inputs(device, b=4, l=128, h=8, dh=32, seed=5):
    """bf16 q, k, v, dO and a mask with a row whose second half (on two
    ranks, a whole chunk) is padding and a row with every key masked."""
    q, k, v, mask = _inputs(b, l, l, h, dh, device, seed)
    mask[0, l // 2:] = False
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(b, l, h, dh, generator=g).to(torch.bfloat16).to(device)
    return q, k, v, mask, do


def _two_step_ring(q, k, v, mask, do, chunk, chunk_bwd):
    """The ring over two ranks: every rank's (o, dq, dk, dv), f32,
    concatenated back along the sequence."""
    n, l = 2, q.shape[1] // 2
    blocks = [[t[:, i * l:(i + 1) * l].contiguous() for t in (q, k, v, mask, do)]
              for i in range(n)]
    ring = _LocalRing(n)

    def rank(pos, shift):
        q_, k_, v_, m_, do_ = blocks[pos]
        o, mx, lx = ring_forward(q_, k_, v_, m_, n, shift, chunk)
        return (o, *ring_backward(q_, k_, v_, m_, mx, lx, o, do_, n, shift, chunk_bwd))

    parts = ring.run(rank)
    return [torch.cat([p[i].float() for p in parts], dim=1) for i in range(4)]


@pytest.mark.cuda
def test_two_step_ring_on_the_card_matches_its_plain_version(card):
    inputs = _ring_inputs(card)
    before = dict(kernels.LAUNCHES)
    got = _two_step_ring(*inputs, flash_chunk_attention, flash_chunk_backward)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_chunk"] == before["flash_chunk"] + 4  # 2 ranks x 2 steps
    assert kernels.LAUNCHES["flash_chunk_bwd"] == before["flash_chunk_bwd"] + 4
    want = _two_step_ring(*inputs, flash_chunk_attention_plain, flash_attention_backward_plain)
    mags = _two_step_ring(*inputs, flash_chunk_attention_plain, lambda *args: tuple(
        t.abs() for t in flash_attention_backward_plain(*args)))[1:]
    # o: f32 from the kernel's partials (atol/rtol 1e-3); dq, dk, dv: each
    # element sums two launches' bf16 results, each held at atol/rtol 1e-2
    # (the backward's test), so within 2 * 1e-2 + 1e-2 * sum |plain step|.
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=1e-3, msg="o")
    for name, g_, w_, mag in zip(("dq", "dk", "dv"), got[1:], want[1:], mags):
        assert bool(((g_ - w_).abs() <= 2e-2 + 1e-2 * mag).all()), name


def test_two_step_ring_matches_the_one_device_attention():
    q, k, v, mask, do = _ring_inputs(torch.device("cpu"))
    o, dq, dk, dv = _two_step_ring(q, k, v, mask, do, flash_chunk_attention_plain,
                                   flash_attention_backward_plain)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = ring_attention(*leaves, mask)
    want.backward(do.float())
    torch.testing.assert_close(o, want.detach(), atol=1e-5, rtol=1e-5)
    for name, got, leaf in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.cuda
def test_flash_chunk_bwd_kernel_rejects_what_it_cannot_take(card):
    q, k, v, mask, m, l, o, do = _bwd_inputs(2, 8, 8, 2, 32, card)
    with pytest.raises(ValueError):
        flash_chunk_backward(q, k, v, mask, m, l, o.bfloat16(), do)
    with pytest.raises(ValueError):
        flash_chunk_backward(q, k, v, mask, m, l, o, do.float())
    with pytest.raises(ValueError):
        flash_chunk_backward(q[:, :4], k, v, mask, m, l, o, do)


def test_bwd_cpu_tensors_take_the_plain_version_without_counting():
    inputs = _bwd_inputs(2, 8, 8, 2, 32, torch.device("cpu"))
    before = dict(kernels.LAUNCHES)
    got = flash_chunk_backward(*inputs)
    want = flash_attention_backward_plain(*inputs)
    assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(got, want))
    assert kernels.LAUNCHES == before


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
    assert kernels.LAUNCHES == {"flash_chunk": 0, "flash_chunk_bwd": 0, "sha256": 0}
    assert kernels.LAUNCH_SHAPES == {"flash_chunk": {}, "flash_chunk_bwd": {}, "sha256": {}}


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
    assert torch.equal(got.cpu(), want)


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
