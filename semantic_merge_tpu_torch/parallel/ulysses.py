"""Ulysses-style sequence parallelism: the all-to-all head/sequence exchange.

The port of the JAX package's ``parallel/ulysses.py``, the second
sequence-parallel strategy beside the ring
(:mod:`semantic_merge_tpu_torch.parallel.ring`): one all-to-all over the
``sp`` axis turns the sequence sharding into a head sharding, so each
rank holds the full sequence for ``H_loc / n`` heads; attention then
runs locally with no communication inside it, and a second all-to-all
restores the sequence sharding. Both exchanges are differentiable
(:meth:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh.all_to_all`,
whose backward is the inverse exchange).

The JAX package's local attention is an f32 einsum and softmax; the
port's is the one-device attention step
(:class:`~semantic_merge_tpu_torch.parallel.ring._ChunkAttention`): on
the card the ``flash_chunk`` kernel and its backward kernel, on the CPU
their plain versions, which compute that einsum in f32. Heads per shard
must divide by the ``sp`` size, with the JAX package's error otherwise.
"""
from __future__ import annotations

from .ring import _ChunkAttention


def ulysses_attention(q, k, v, kmask, mesh=None, axis_name: str = "sp"):
    """Exact attention with the sequence axis sharded over ``axis_name``
    of ``mesh``: the arguments and result of
    :func:`semantic_merge_tpu_torch.parallel.ring.ring_attention`."""
    n = 1 if mesh is None else mesh.axis_size(axis_name)
    h_loc = q.shape[2]
    if h_loc % n != 0:
        raise ValueError(
            f"Ulysses needs heads-per-shard ({h_loc}) divisible by the "
            f"{axis_name!r} axis size ({n}); use ring attention instead")
    if n == 1:
        return _ChunkAttention.apply(q, k, v, kmask)

    def seq_to_head(x):
        # (B, L_loc, H_loc, Dh) -> (B, L, H_loc / n, Dh)
        return mesh.all_to_all(x, axis_name, split_dim=2, concat_dim=1)

    mask_g = mesh.gather(kmask, axis_name, dim=1)  # (B, L)
    out = _ChunkAttention.apply(seq_to_head(q), seq_to_head(k), seq_to_head(v), mask_g)
    return mesh.all_to_all(out, axis_name, split_dim=1, concat_dim=2)
