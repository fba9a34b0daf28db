"""The port's flash-chunk attention against the JAX package's.

On the CPU the port's ``flash_chunk_attention`` runs its plain PyTorch
version; it must give the partial softmax statistics of the JAX Pallas
kernel (in interpret mode) and of the JAX einsum path. Tolerance 1e-5
on the normalised output in float32: the two compute the same sums in
another order. The single-device ``ring_attention`` of the port must
match the JAX ring over a (dp=2, sp=2, tp=2) CPU mesh, whose
chunk-by-chunk online softmax is exact up to float association.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semantic_merge_tpu.parallel.flash import flash_chunk_attention as jax_flash
from semantic_merge_tpu.parallel.mesh import build_mesh
from semantic_merge_tpu.parallel.ring import _chunk_stats_einsum
from semantic_merge_tpu.parallel.ring import ring_attention as jax_ring
from semantic_merge_tpu_torch.parallel.flash import (flash_chunk_attention,
                                                     flash_chunk_attention_plain)
from semantic_merge_tpu_torch.parallel.ring import ring_attention


def _inputs(b, lq, lk, h, dh, seed, *, p_keep=0.7, dead_row=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, lq, h, dh).astype(np.float32)
    k = rs.randn(b, lk, h, dh).astype(np.float32)
    v = rs.randn(b, lk, h, dh).astype(np.float32)
    mask = rs.rand(b, lk) < p_keep
    mask[:, 0] = True
    if dead_row is not None:
        mask[dead_row] = False  # every key of this batch row is masked
    return q, k, v, mask


def _normalised(pv, l):
    return np.asarray(pv) / np.asarray(l).transpose(0, 2, 1)[..., None]


def _port(q, k, v, mask):
    pv, m, l = flash_chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(mask))
    return pv.numpy(), m.numpy(), l.numpy()


SHAPES = [
    # (b, lq, lk, h, dh, seed, dead_row): tests/test_flash.py's shapes,
    # one with a batch row whose keys are all masked (its scores are all
    # -1e30, so the row averages every value and stays finite).
    (2, 16, 24, 3, 8, 0, None),
    (2, 16, 24, 3, 8, 20, 1),
    (1, 13, 27, 2, 16, 4, None),
    (3, 64, 64, 8, 32, 30, 2),
]


@pytest.mark.parametrize("b,lq,lk,h,dh,seed,dead_row", SHAPES)
def test_plain_matches_jax_einsum_stats(b, lq, lk, h, dh, seed, dead_row):
    q, k, v, mask = _inputs(b, lq, lk, h, dh, seed, dead_row=dead_row)
    pv_t, m_t, l_t = _port(q, k, v, mask)
    pv_e, m_e, l_e = _chunk_stats_einsum(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask),
                                         dh ** -0.5)
    assert np.isfinite(pv_t).all() and np.isfinite(l_t).all()
    np.testing.assert_allclose(_normalised(pv_t, l_t), _normalised(pv_e, l_e),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_t, np.asarray(m_e), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l_t, np.asarray(l_e), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,lq,lk,h,dh,seed,dead_row", SHAPES)
def test_plain_matches_jax_pallas_interpret(b, lq, lk, h, dh, seed, dead_row):
    # The Pallas kernel pads keys to its block as masked keys: they add
    # nothing to a row with a live key. (A dead row would count them, so
    # the shapes with one have Lk a multiple of the block.)
    q, k, v, mask = _inputs(b, lq, lk, h, dh, seed, dead_row=dead_row)
    pv_t, m_t, l_t = _port(q, k, v, mask)
    pv_p, m_p, l_p = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), block_q=8, block_k=8,
                               interpret=True)
    np.testing.assert_allclose(_normalised(pv_t, l_t), _normalised(pv_p, l_p),
                               rtol=1e-5, atol=1e-5)
    # The kernel's row max is blockwise; rebased to a common max the
    # row sums must agree.
    scale = np.exp(np.asarray(m_p) - m_t)
    np.testing.assert_allclose(np.asarray(l_p) * scale, l_t, rtol=1e-5, atol=1e-5)


def _kernel_rounding(q, k, v, mask):
    """Normalised output of the CUDA kernel's arithmetic in plain PyTorch:
    f32 scores, max and p; l summed from the f32 p; P·V as two products
    of bf16 v with p_hi = bf16(p) and p_lo = bf16(p - p_hi), with f32
    sums. Also returns the output with p rounded once to bf16."""
    q, k, v, mask = (torch.from_numpy(a) for a in (q, k, v, mask))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()

    def pv(weights):
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)

    return ((pv(p_hi) + pv(p_lo)) / l).numpy(), (pv(p_hi) / l).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_p_keeps_kernel_rounding_within_1e4_of_jax(seed):
    # The kernel multiplies P by V on the tensor cores, whose inputs are
    # bf16. At the matcher's shape with bf16 q/k/v and |v| of a few units,
    # p split into bf16 hi + lo stays within 1e-4 of the JAX reference's
    # f32 p; p rounded once to bf16 (2^-9) misses the kernel's 2e-3.
    b, l, h, dh = 8, 64, 8, 32
    q, k, v, mask = _inputs(b, l, l, h, dh, seed, dead_row=b - 1)
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, 4 * v))
    pv_e, _, l_e = _chunk_stats_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), dh ** -0.5)
    want = _normalised(pv_e, l_e)
    pv_t, _, l_t = _port(q, k, v, mask)
    np.testing.assert_allclose(_normalised(pv_t, l_t), want, rtol=1e-5, atol=1e-5)
    split, rounded = _kernel_rounding(q, k, v, mask)
    err_split = np.abs(split - want).max()
    err_rounded = np.abs(rounded - want).max()
    assert err_split <= 1e-4
    assert err_rounded > 2e-3 and err_rounded > 50 * err_split


def test_wrapper_uses_plain_version_on_cpu():
    q, k, v, mask = _inputs(2, 8, 8, 2, 32, 5)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    for got, want in zip(flash_chunk_attention(*args),
                         flash_chunk_attention_plain(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [7, 8])
def test_ring_attention_matches_jax_ring(seed):
    b, l, h, dh = 4, 16, 4, 8
    q, k, v, mask = _inputs(b, l, l, h, dh, seed, p_keep=0.8)
    mesh = build_mesh(dp=2, pp=1, sp=2, tp=2, ep=1)
    want = jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), mesh.mesh, pallas=None)
    got = ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
