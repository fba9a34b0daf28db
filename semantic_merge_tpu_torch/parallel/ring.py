"""Ring attention: sequence-parallel attention over the ``sp`` mesh axis.

The port of the JAX package's ``parallel/ring.py``. Keys and values
stay sharded along the sequence: each rank computes the partial softmax
statistics of its queries over its resident K/V chunk
(:func:`semantic_merge_tpu_torch.parallel.flash.flash_chunk_attention`,
the hand-written kernel on the card) while the chunks and their key
masks rotate around the ``sp`` ring, position j to j + 1
(:meth:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh.ring_shift`).
Each chunk's ``(pv, m, l)`` merges into the carry as in JAX's
``_ring_attention_local`` (``o`` (B, Lq, H, Dh) f32, ``m`` and ``l``
(B, H, Lq) f32, starting at 0, -1e30 and 0); a chunk whose keys are all
padding gives ``m = -1e30`` and ``l = Lk`` and weighs nothing beside a
real one, and a row with no real key anywhere averages every value, as
there. The result is ``o / max(l, 1e-30)`` in q's dtype.

The backward is one ``torch.autograd.Function`` over the whole ring:
at each step the backward kernel
(:func:`~semantic_merge_tpu_torch.parallel.flash.flash_chunk_backward`)
runs on the resident chunk with the **final** global ``m``, ``l`` and
normalised ``o`` (it recomputes P from the ``m`` and ``l`` it is given,
so its P is the global softmax's); ``dq`` sums on the rank, ``dk`` and
``dv`` travel with their chunk and reach their owner after k shifts. The
per-step bf16 results accumulate in f32 and are cast once at the end.
The JAX package differentiates the einsum path, which gives the same
gradient.

Without a mesh, or with ``sp`` of size 1, the ring has one step whose
only chunk is the whole sequence; the carry then adds nothing, and
:class:`_ChunkAttention` runs that step alone (one kernel launch each
way, the merge paths' counts). Without a gradient to take
(``torch.inference_mode``) only the forward runs.
"""
from __future__ import annotations

import torch

from .flash import NEG_INF, flash_chunk_attention, flash_chunk_backward


class _ChunkAttention(torch.autograd.Function):
    """Forward: the flash-chunk kernel and the normalisation; backward:
    the backward kernel, from the saved q, k, v, mask, m, l and the f32
    output."""

    @staticmethod
    def forward(ctx, q, k, v, kmask):
        pv, m, l = flash_chunk_attention(q, k, v, kmask)
        # (B, Lq, H, Dh) f32, in that layout whatever the division picks.
        o = (pv / l.transpose(1, 2)[..., None].clamp_min(1e-30)).contiguous()
        ctx.save_for_backward(q, k, v, kmask, m, l, o)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, m, l, o = ctx.saved_tensors
        dq, dk, dv = flash_chunk_backward(q, k, v, kmask, m, l, o, do.contiguous())
        return dq, dk, dv, None


def ring_forward(q, k, v, kmask, steps: int, shift, chunk=flash_chunk_attention):
    """The ring's forward on one rank: ``steps`` chunk steps, ``shift``
    moving ``(k, v, kmask)`` to the next rank between two of them.
    Returns the normalised ``o`` (B, Lq, H, Dh) f32 and the global row
    max and sum ``m``, ``l`` (B, H, Lq)."""
    b, lq, h, dh = q.shape
    o = torch.zeros((b, lq, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    k_cur, v_cur, mask_cur = k, v, kmask
    for step in range(steps):
        pv, m_c, l_c = chunk(q, k_cur, v_cur, mask_cur)
        m_new = torch.maximum(m, m_c)
        corr, corr_c = torch.exp(m - m_new), torch.exp(m_c - m_new)
        l = l * corr + l_c * corr_c
        o = o * corr.transpose(1, 2)[..., None] + pv * corr_c.transpose(1, 2)[..., None]
        m = m_new
        if step < steps - 1:
            k_cur, v_cur, mask_cur = shift((k_cur, v_cur, mask_cur))
    o = (o / l.transpose(1, 2)[..., None].clamp_min(1e-30)).contiguous()
    return o, m, l


def ring_backward(q, k, v, kmask, m, l, o, do, steps: int, shift, chunk_bwd=flash_chunk_backward):
    """The ring's backward on one rank, from :func:`ring_forward`'s
    ``m``, ``l`` and ``o``: ``(dq, dk, dv)`` f32, ``dk`` and ``dv`` of
    this rank's own chunk. ``shift`` moves ``(k, v, kmask, dk, dv)``
    after every step but the last, which moves ``(dk, dv)`` alone."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur, mask_cur = k, v, kmask
    for step in range(steps):
        dq_c, dk_c, dv_c = chunk_bwd(q, k_cur, v_cur, mask_cur, m, l, o, do)
        dq += dq_c
        dk += dk_c
        dv += dv_c
        if step < steps - 1:
            k_cur, v_cur, mask_cur, dk, dv = shift((k_cur, v_cur, mask_cur, dk, dv))
        elif steps > 1:
            dk, dv = shift((dk, dv))
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring over ``axis`` of ``mesh``, the kernels at every step."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, mesh, axis):
        steps = mesh.axis_size(axis)
        ctx.ring = (mesh, axis, steps)
        o, m, l = ring_forward(q, k, v, kmask, steps, _shifter(mesh, axis))
        ctx.save_for_backward(q, k, v, kmask, m, l, o)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, m, l, o = ctx.saved_tensors
        mesh, axis, steps = ctx.ring
        dq, dk, dv = ring_backward(q, k, v, kmask, m, l, o, do.contiguous(), steps,
                                   _shifter(mesh, axis))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _shifter(mesh, axis):
    return lambda tensors: mesh.ring_shift(tensors, axis)


def ring_attention(q, k, v, kmask, mesh=None, axis_name: str = "sp"):
    """Non-causal attention with a key padding mask, the sequence sharded
    over ``axis_name`` of ``mesh``.

    q, k, v: this rank's (B, L_loc, H_loc, Dh) block (rows over ``dp``,
    positions over ``axis_name``, heads over ``tp``); kmask: its
    (B, L_loc) block, True on real tokens. Returns the (B, L_loc, H_loc,
    Dh) block of the output in q's dtype, differentiable in q, k and v.
    Without a mesh or at ``sp = 1``, the one-device step
    (:class:`_ChunkAttention`).
    """
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return _ChunkAttention.apply(q, k, v, kmask)
    return _RingAttention.apply(q, k, v, kmask, mesh, axis_name)
