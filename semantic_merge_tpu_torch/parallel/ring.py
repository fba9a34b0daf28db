"""Encoder attention on one device: one chunk step of ring attention.

The single-device counterpart of the JAX package's
``_ring_attention_local`` (``parallel/ring.py``): with one device the
ring has one step, whose only K/V chunk is the whole sequence. That
step's partial statistics come from
:func:`semantic_merge_tpu_torch.parallel.flash.flash_chunk_attention`
(the plain counterpart of ``_chunk_stats_einsum`` is its
``flash_chunk_attention_plain``). Merging them into the empty carry
(``o = 0``, ``m = -1e30``, ``l = 0``) multiplies by ``exp(0) = 1`` and
adds zeros, so the carry is left out and only the final normalisation
``o / max(l, 1e-30)`` and the cast to q's dtype remain. The ring over
several GPUs is not part of this port yet.

The gradient is :func:`semantic_merge_tpu_torch.parallel.flash.flash_chunk_backward`
(the hand-written backward kernel on the card), through a
``torch.autograd.Function``; the JAX package differentiates the einsum
path, and both give the same gradient. Without a gradient to take
(``torch.inference_mode``, the merge paths) only the forward runs.
"""
from __future__ import annotations

import torch

from .flash import flash_chunk_attention, flash_chunk_backward


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


def ring_attention(q, k, v, kmask):
    """Non-causal attention with a key padding mask.

    q, k, v: (B, L, H, Dh); kmask: (B, L) True on real tokens.
    Returns (B, L, H, Dh) in q's dtype, differentiable in q, k and v.
    """
    return _ChunkAttention.apply(q, k, v, kmask)
