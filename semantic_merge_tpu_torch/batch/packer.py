"""Packer: stack co-batched merges' decl columns along a new leading
merge axis.

Each request arrives with its decl columns already padded up the
``core/encode`` bucket ladder (``ops/fused.py::device_decl_columns``),
its op capacity ``C`` bucketed, and its string digest table grown in
power-of-two steps, so the co-batch **bucket key** ``(nb, nl, nr, C,
hash_cap)`` takes few distinct values and equal keys stack without
reshaping. The merge axis is padded up its own power-of-two ladder
(:func:`batch_bucket`), so the batched-program cache stays small.

With a batch mesh of k devices the dispatcher packs with ``shards =
k``: the merge axis pads to a multiple of k and :func:`placement_for`
spreads the requests round-robin over the k lane blocks.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


class BatchRequest:
    """One merge's program inputs at the fused engine's dispatch seam:
    the three bucket-padded ``[4, n]`` decl-column tensors, the string
    digest table, the two (seed, rev) prefix digests, and the geometry
    the program is specialized on."""

    __slots__ = ("dev_b", "dev_l", "dev_r", "hash_tab", "dig_l", "dig_r",
                 "nb", "nl", "nr", "C", "recorder", "trace_id")

    def __init__(self, dev_b, dev_l, dev_r, hash_tab, dig_l, dig_r,
                 *, nb: int, nl: int, nr: int, C: int) -> None:
        self.dev_b = dev_b
        self.dev_l = dev_l
        self.dev_r = dev_r
        self.hash_tab = hash_tab
        self.dig_l = dig_l
        self.dig_r = dig_r
        self.nb = nb
        self.nl = nl
        self.nr = nr
        self.C = C
        # Captured by the submitting request thread (``submit_request``)
        # so the leader can graft its batch spans into each member's
        # request-scoped trace; the bucket key ignores both.
        self.recorder = None
        self.trace_id = None

    @property
    def key(self) -> Tuple[int, int, int, int, int]:
        """The shape bucket this request can co-batch in; the digest
        table's capacity is part of it (a dimension of the stack)."""
        return (self.nb, self.nl, self.nr, self.C, int(self.hash_tab.shape[0]))


def batch_bucket(n: int, multiple: int = 1) -> int:
    """Merge-axis ladder: the next ``multiple × 2^k`` ≥ ``n`` (``multiple``
    is a mesh's batch-axis size; 1 on one device: powers of two)."""
    multiple = max(1, int(multiple))
    bucket = multiple
    while bucket < n:
        bucket *= 2
    return bucket


def placement_for(valid: int, padded: int, shards: int = 1) -> List[int]:
    """Row index for each of the ``valid`` requests in a ``padded``-row
    batch split into ``shards`` contiguous blocks, round-robin across
    the blocks; with one shard, the identity layout."""
    block = padded // max(1, shards)
    return [(i % shards) * block + (i // shards) for i in range(valid)]


def pack_group(reqs: List[BatchRequest], shards: int = 1):
    """Stack one co-batch group's inputs along a new leading merge
    axis, padded up :func:`batch_bucket` by replicating request 0 into
    every unplaced row — padding rows are inert (lanes are independent
    and a padding lane's row is never scattered back).

    Returns ``((b, l, r, hash_tabs, digs_l, digs_r), padded_size,
    placement)``: tensors on the requests' device, ``placement[i]`` the
    packed row carrying request ``i``."""
    valid = len(reqs)
    padded = batch_bucket(valid, shards)
    placement = placement_for(valid, padded, shards)
    order = [0] * padded
    for i, row in enumerate(placement):
        order[row] = i

    def stack(field: str):
        return torch.stack([getattr(reqs[i], field) for i in order])

    return ((stack("dev_b"), stack("dev_l"), stack("dev_r"), stack("hash_tab"),
             stack("dig_l"), stack("dig_r")), padded, placement)
