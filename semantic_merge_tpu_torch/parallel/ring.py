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
"""
from __future__ import annotations

from .flash import flash_chunk_attention


def ring_attention(q, k, v, kmask):
    """Non-causal attention with a key padding mask.

    q, k, v: (B, L, H, Dh); kmask: (B, L) True on real tokens.
    Returns (B, L, H, Dh) in q's dtype.
    """
    pv, _, l = flash_chunk_attention(q, k, v, kmask)
    l = l.transpose(1, 2)[..., None]  # (B, Lq, H, 1)
    return (pv / l.clamp_min(1e-30)).to(q.dtype)
