"""Batched RGA materialization on the device.

The port of the JAX package's ``ops/crdt.py``. The host RGA
(:mod:`semantic_merge_tpu_torch.core.crdt`) resolves one list's order
by O(n) insert scans. A converged RGA's materialized order is a pure
function of its elements: a stable sort by the key tuple ``(anchor, t,
author, opid)`` with the insertion sequence as the tiebreaker, the
tombstones dropped. So every ``reorderImports`` list of a merge is one
batched sort on the device (:func:`_materialize_program`):

- the keys are a ``(B, n)`` int32 batch, padded with :data:`_PAD`
  (padding is tombstoned);
- the lexicographic order by ``(anchor, t, author, opid, seq)`` is three
  stable sorts, from the last key pair to the first, each over two int32
  keys packed into one int64 (:func:`_pack`: exact and order-preserving
  for every pair of int32 values, so the passes reproduce
  ``jnp.lexsort`` for every key range);
- the kept rows are compacted through a cumulative sum, and ``(perm,
  count)`` come back in one fetch.

String key components are order-rank interned
(:func:`semantic_merge_tpu_torch.core.encode.rank_intern`), so integer
order reproduces string order exactly.

There is no host fallback on the card: a failure of the program on a
CUDA device raises :class:`~semantic_merge_tpu_torch.errors.KernelFault`
(the CLI's exit 11, as for every device program of the port), where the
JAX applier logs a warning and materializes on the host. On the CPU (the
caller asked for ``device="cpu"``) the same tensor code runs there.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.crdt import RGA
from ..core.encode import bucket_size, rank_intern
from ..device import resolve_device
from ..errors import KernelFault

#: Padding rank: sorts after every real element, and is tombstoned.
_PAD = np.int32(2**31 - 1)


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 keys as one int64 key ordered as the pair ``(hi, lo)``:
    ``hi * 2**32`` spans ``[-2**63, 2**63 - 2**32]`` and ``lo + 2**31``
    lies in ``[0, 2**32)``, so the sum never overflows."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def _materialize_program(anchor, t, author, opid, seq, tombstone):
    """The order of ``B`` lists of ``n`` slots (int32 ``(B, n)`` keys,
    bool ``(B, n)`` tombstones), as one int32 ``(B, n + 1)`` tensor: row
    ``i`` holds the kept slots in output order, then ``n`` (dropped) to
    column ``n - 1``, and the kept count in column ``n``."""
    b, n = anchor.shape
    order = torch.arange(n, device=anchor.device).expand(b, n)
    for key in (_pack(opid, seq), _pack(t, author), anchor.to(torch.int64)):
        _, idx = torch.sort(key.gather(1, order), dim=1, stable=True)
        order = order.gather(1, idx)
    keep = ~tombstone.gather(1, order)
    out_pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    packed = torch.full((b, n + 2), n, dtype=torch.int32, device=anchor.device)
    # Dropped slots land in the scratch column n + 1.
    packed.scatter_(1, torch.where(keep, out_pos, n + 1).to(torch.int64),
                    order.to(torch.int32))
    packed[:, n] = keep.sum(dim=1, dtype=torch.int32)
    return packed[:, :n + 1]


def _int_ranks(values) -> np.ndarray:
    """Order-preserving int32 ranks of Python ints."""
    ranks = {v: i for i, v in enumerate(sorted(set(values)))}
    return np.asarray([ranks[v] for v in values], dtype=np.int32)


def _batch_columns(rgas: Sequence[RGA]):
    """The program's inputs for ``rgas`` as numpy arrays: ``(anchor, t,
    author, opid, seq, tombstone)``, each ``(B, n)`` with ``n`` the
    bucketed longest list (the JAX package's layout). ``t`` is ranked
    like the strings: the order is the same, and a ``t`` past int32
    (which the JAX program cannot take: its applier then falls back to
    the host) still orders exactly."""
    all_elems = [r.elems for r in rgas]
    n = bucket_size(max((len(e) for e in all_elems), default=1))
    b = len(all_elems)
    flat = [e for elems in all_elems for e in elems]
    anchors = rank_intern([e.key.anchor for e in flat])[0]
    authors = rank_intern([e.key.author for e in flat])[0]
    opids = rank_intern([e.key.opid for e in flat])[0]
    a = np.full((b, n), _PAD, np.int32)
    t = np.full((b, n), _PAD, np.int32)
    u = np.full((b, n), _PAD, np.int32)
    o = np.full((b, n), _PAD, np.int32)
    s = np.full((b, n), _PAD, np.int32)
    tb = np.ones((b, n), bool)  # padding is tombstoned
    row = np.repeat(np.arange(b), [len(e) for e in all_elems])
    col = np.concatenate([np.arange(len(e)) for e in all_elems]) if flat else row
    a[row, col] = anchors
    u[row, col] = authors
    o[row, col] = opids
    t[row, col] = _int_ranks([e.key.t for e in flat])
    s[row, col] = col  # the elems list order is the converged insert order
    tb[row, col] = [e.tombstone for e in flat]
    return a, t, u, o, s, tb


def materialize_batch(rgas: Sequence[RGA], device=None) -> List[List[str]]:
    """Materialize many RGA lists in one device program on ``device``
    (``None`` or ``"cuda"``: the card; ``"cpu"`` only when asked for).
    The output equals ``[list(r.materialize()) for r in rgas]``. On a
    CUDA device a failure raises :class:`KernelFault`."""
    if not rgas:
        return []
    dev = resolve_device(device) if not isinstance(device, torch.device) else device
    cols = _batch_columns(rgas)
    try:
        inputs = [torch.from_numpy(c).to(dev, non_blocking=True) for c in cols]
        packed = _materialize_program(*inputs).cpu().numpy()
    except Exception as exc:
        if dev.type == "cuda":
            raise KernelFault(f"device CRDT materialization failed: {exc}",
                              stage="kernel", cause=type(exc).__name__) from exc
        raise
    n = packed.shape[1] - 1
    out: List[List[str]] = []
    for r, row in zip(rgas, packed.tolist()):
        elems = r.elems
        out.append([elems[k].value for k in row[:row[n]]])
    return out
