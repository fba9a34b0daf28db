"""Op-log composition on the device, in PyTorch.

The port of the JAX package's ``ops/compose.py``: the reference's
sequential two-pointer composer (reference ``semmerge/compose.py:51-112``)
as tensor code with three stages.

1. **Canonical order.** Each encoded log sorts by ``(precedence,
   timestamp rank, id rank)``; the merged order is one stable sort of
   the concatenation by ``(precedence, timestamp, side, id rank)``.
   Cross-stream order compares ``(precedence, timestamp)`` only, with A
   before B on ties, as the host composer's two-pointer pick does. torch
   has no multi-key sort, so each key tuple packs into one int64
   (precedence ranked first: the padding precedence ``2**30`` would not
   fit beside two row ranks) and one ``torch.sort(stable=True)`` orders
   it. Ties keep index order everywhere.
2. **Conflict detection.** DivergentRename pairs. A parallel sorted
   self-join (``torch.searchsorted`` over A's renames sorted by (symbol,
   name)) finds whether any *candidate* exists: the same symbol renamed
   to different names on both sides. The head-vs-head cursor walk that
   decides the real conflicts is sequential, so it does not run as a
   loop of device steps (each would be a sync): the composition first
   runs speculatively with no drops, and its single fetch carries the
   candidate flag. Only when the flag is set does the host fetch the
   sorted int columns once, replay the walk
   (:func:`cursor_walk_conflicts_columnar`, with the reference's quirks:
   conflicts only when both heads surface together, both ops dropped,
   interleaved ops can mask one), send the drop masks back and compose
   again. Without candidates the merge makes no host round trip for the
   walk.
3. **Chain propagation.** Rename and move chains are per-symbol
   last-valid-wins prefix state, a segmented inclusive scan: rows sort
   by ``(symbol, merged position)``, and the last valid value at row
   ``i`` is the value at ``j = cummax(where(valid, arange, -1))[i]``
   when ``j >= 0`` and row ``j`` has ``i``'s symbol (one
   ``torch.cummax`` for the three chains), else ``NULL_ID``.

Where JAX scatters with ``mode="drop"``, this module scatters into a
buffer with one extra sink column, as :mod:`.diff` does. The result is
one stacked int32 matrix and one device→host fetch; the host decodes it
into a plain ``List[Op]``, bit-identical to the host composer
(reference ``semmerge/compose.py``; the JAX package's
``core/compose.py::compose_oplogs``).
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.conflict import Conflict, divergent_rename_conflict
from ..core.encode import (NULL_ID, OP_COLUMNS, PAD_ID, Interner, OpTensor,
                           build_rank_tables, encode_oplog, pad_to,
                           shard_bucket)
from ..core.ops import UNKNOWN_PRECEDENCE, Op
from ..device import resolve_device
from ..obs import spans as obs_spans
from .oplog_view import _materialize_decoded, cursor_walk_conflicts_columnar

_PAD_PREC = 2**30  # sorts after every real precedence
#: Precedence rank of padded rows in the packed sort keys: every real
#: precedence is at most UNKNOWN_PRECEDENCE.
_PAD_PREC_RANK = UNKNOWN_PRECEDENCE + 1

(_PREC, _TS, _ID, _IS_RENAME, _IS_MOVE, _SYM, _NEW_NAME, _CHAIN_NAME,
 _NEW_ADDR, _CHAIN_FILE, _OP_INDEX) = range(len(OP_COLUMNS))

#: Rows of the fetched result matrix.
(OUT_SIDE, OUT_ROW, OUT_CHAIN_ADDR, OUT_CHAIN_FILE, OUT_CHAIN_NAME, OUT_N,
 OUT_CANDIDATES, OUT_A_INDEX, OUT_B_INDEX) = range(9)


def _pad_op_tensor(t: OpTensor, size: int) -> np.ndarray:
    """(11, size) int32: the op columns padded to ``size`` rows (padded
    rows sort last in every order)."""
    rows = []
    for name in OP_COLUMNS:
        fill = _PAD_PREC if name == "prec" else (PAD_ID if name == "sym" else NULL_ID)
        rows.append(pad_to(getattr(t, name), size, np.int32(fill)))
    return np.stack(rows)


def _sort_key(cols: torch.Tensor, n_ts: int, n_id: int,
              side: torch.Tensor | None = None) -> torch.Tensor:
    """int64 key ordering rows by (precedence, timestamp rank[, side],
    id rank). Ranks shift by one so that padding's ``NULL_ID`` is 0."""
    prec = cols[_PREC].long().clamp(max=_PAD_PREC_RANK)
    key = prec * (n_ts + 1) + (cols[_TS].long() + 1)
    if side is not None:
        key = key * 2 + side
    return key * (n_id + 1) + (cols[_ID].long() + 1)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    """The permutation sorting ``key``; ties keep index order."""
    return torch.sort(key, stable=True).indices


def _sort_stream(cols: torch.Tensor, n_ts: int, n_id: int) -> torch.Tensor:
    """Stage 1: canonical per-stream sort by (prec, ts rank, id rank),
    every column carried along."""
    return cols[:, _stable_order(_sort_key(cols, n_ts, n_id))]


def _rename_pairs(is_rename: torch.Tensor, sym: torch.Tensor,
                  new_name: torch.Tensor, n_real):
    """(symbol, newName key) of a stream's rename rows among its first
    ``n_real``, ``PAD_ID`` symbols elsewhere. Along the last axis:
    leading batch dimensions take an ``n_real`` of their shape."""
    idx = torch.arange(sym.shape[-1], device=sym.device)
    if isinstance(n_real, torch.Tensor):
        n_real = n_real.unsqueeze(-1)
    is_r = (is_rename == 1) & (idx < n_real)
    return torch.where(is_r, sym, int(PAD_ID)).long(), new_name.long()


def _rename_candidate_table(a, n_a):
    """A's renames among its first ``n_a`` rows as ``(symbol, name)``
    columns sorted by (symbol, name); ``a`` is the stream's canonical
    ``(is_rename, sym, new_name)`` columns."""
    a_sym, a_name = _rename_pairs(*a, n_a)
    srt = torch.sort((a_sym << 32) | (a_name + 1), dim=-1).values
    return srt >> 32, (srt & 0xFFFFFFFF) - 1


def _rename_candidate_query(table, b_sym, b_name) -> torch.Tensor:
    """Per query rename ``(b_sym, b_name)``: does A rename that symbol to
    another name? A query reads its symbol run's min and max name in the
    sorted ``table`` (its two ends alone would miss a run with mixed
    names). The queries may be any slice of B's rename pairs (the
    sharded compose splits them over the mesh)."""
    nm_sym, nm_name = table
    na = nm_sym.shape[-1]
    lo = torch.searchsorted(nm_sym, b_sym).clamp(0, na - 1)
    hi = (torch.searchsorted(nm_sym, b_sym, right=True) - 1).clamp(0, na - 1)
    return ((nm_sym.gather(-1, lo) == b_sym) & (b_sym != int(PAD_ID))
            & ((nm_name.gather(-1, lo) != b_name) | (nm_name.gather(-1, hi) != b_name)))


def _rename_candidates_cols(a, n_a, b, n_b) -> torch.Tensor:
    """Stage 2a, the parallel precheck: does any B rename share its
    symbol with an A rename of another name? ``a``/``b`` are the
    streams' canonical ``(is_rename, sym, new_name)`` columns. Along the
    last axis: with leading batch dimensions the answer has their
    shape."""
    b_sym, b_name = _rename_pairs(*b, n_b)
    return _rename_candidate_query(_rename_candidate_table(a, n_a), b_sym, b_name).any(-1)


def _rename_candidates(a: torch.Tensor, n_a: int,
                       b: torch.Tensor, n_b: int) -> torch.Tensor:
    """:func:`_rename_candidates_cols` over two sorted op matrices."""
    return _rename_candidates_cols((a[_IS_RENAME], a[_SYM], a[_NEW_NAME]), n_a,
                                   (b[_IS_RENAME], b[_SYM], b[_NEW_NAME]), n_b)


def _seg_last_valid(seg_sym: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive last-valid scan, rows of ``vals`` (k, ..., n)
    in (symbol, merged position) order along the last axis: the value at
    the last row ``j <= i`` holding a valid value, if ``j`` lies in
    ``i``'s symbol segment, else ``NULL_ID``. ``seg_sym`` is (..., n)."""
    idx = torch.arange(vals.shape[-1], device=vals.device).expand_as(vals)
    last = torch.cummax(torch.where(vals != NULL_ID, idx, -1), dim=-1).values
    j = last.clamp(min=0)
    same = (last >= 0) & (seg_sym.expand_as(j).gather(-1, j) == seg_sym)
    return torch.where(same, vals.gather(-1, j), NULL_ID)


def _merge_and_scan(a: torch.Tensor, b: torch.Tensor, n_a: int, n_b: int,
                    drop_a: torch.Tensor, drop_b: torch.Tensor,
                    candidates: torch.Tensor, n_ts: int, n_id: int,
                    seg_scan=_seg_last_valid) -> torch.Tensor:
    """Stage 3: merged order, segmented chain scans and output assembly.
    Returns the (9, na + nb) int32 matrix the host fetches (rows
    ``OUT_*``; scalars broadcast across their row, short rows padded
    with ``NULL_ID``). ``seg_scan(seg_sym, vals)`` is the segmented scan
    (:func:`_seg_last_valid`; the sharded compose passes its
    distributed twin)."""
    na, nb = a.shape[1], b.shape[1]
    total = na + nb
    dev = a.device
    cols = torch.cat([a, b], dim=1).long()
    side = torch.cat([torch.zeros(na, dtype=torch.long, device=dev),
                      torch.ones(nb, dtype=torch.long, device=dev)])
    within = torch.cat([torch.arange(na, device=dev), torch.arange(nb, device=dev)])
    valid = torch.cat([torch.arange(na, device=dev) < n_a,
                       torch.arange(nb, device=dev) < n_b])
    live = valid & ~torch.cat([drop_a, drop_b])

    # (prec, ts, side, id): id orders rows only *within* a stream, side
    # breaks cross-stream ties — the merged order of the two-pointer walk.
    merged_order = _stable_order(_sort_key(cols, n_ts, n_id, side))

    # Chain contributions (dropped and padded rows contribute nothing).
    move_live = (cols[_IS_MOVE] == 1) & live
    new_addr, chain_file = cols[_NEW_ADDR], cols[_CHAIN_FILE]
    contrib = torch.stack([
        torch.where(move_live & (new_addr != NULL_ID), new_addr, NULL_ID),
        torch.where(move_live & (chain_file != NULL_ID), chain_file, NULL_ID),
        torch.where((cols[_IS_RENAME] == 1) & live, cols[_CHAIN_NAME], NULL_ID),
    ])

    # (sym, merged position) order: a stable sort by symbol of the rows
    # in merged order.
    sym = cols[_SYM]
    sym_m = sym[merged_order]
    by_sym = _stable_order(sym_m)
    seg_order = merged_order[by_sym]
    chains_seg = seg_scan(sym_m[by_sym], contrib[:, seg_order])
    chains = torch.empty_like(chains_seg)
    chains[:, seg_order] = chains_seg

    # Output assembly: live rows in merged order, compacted; column
    # `total` is the sink for every other row.
    live_m = live[merged_order]
    out_pos = torch.cumsum(live_m.long(), 0) - 1
    n_out = live_m.sum()
    pos = torch.where(live_m, out_pos, total)
    out = torch.full((5, total + 1), NULL_ID, dtype=torch.long, device=dev)
    out[:, pos] = torch.cat([torch.stack([side[merged_order], within[merged_order]]),
                             chains[:, merged_order]])

    def row(x):
        return F.pad(x.long(), (0, total - x.shape[0]), value=NULL_ID)[None]

    return torch.cat([
        out[:, :total], n_out.expand(1, total), candidates.long().expand(1, total),
        row(a[_OP_INDEX]), row(b[_OP_INDEX]),
    ]).to(torch.int32)


def _walk_on_host(a: torch.Tensor, n_a: int, b: torch.Tensor, n_b: int,
                  n_ts: int) -> Tuple[List[Tuple[int, int]], Set[int], Set[int]]:
    """Fetch the sorted streams' walk columns once and replay the walk."""
    picks = [_PREC, _TS, _IS_RENAME, _SYM, _NEW_NAME]
    host = torch.cat([a[picks, :n_a], b[picks, :n_b]], dim=1).cpu().numpy().astype(np.int64)
    prec, ts, ren, sym, name = host
    key = (prec * (n_ts + 1) + ts).tolist()
    ren = (ren == 1).tolist()
    sym, name = sym.tolist(), name.tolist()
    return cursor_walk_conflicts_columnar(
        key[:n_a], ren[:n_a], sym[:n_a], name[:n_a],
        key[n_a:], ren[n_a:], sym[n_a:], name[n_a:])


def decode_compose_output(out: np.ndarray, delta_a: List[Op], delta_b: List[Op],
                          interner: Interner,
                          pairs: Sequence[Tuple[int, int]]
                          ) -> Tuple[List[Op], List[Conflict]]:
    """The fetched matrix → the composed ``List[Op]`` and the conflicts
    (``pairs``: sorted-stream positions from the walk)."""
    n_out = int(out[OUT_N, 0])
    sorted_a = [delta_a[i] for i in out[OUT_A_INDEX, :len(delta_a)].tolist()]
    sorted_b = [delta_b[i] for i in out[OUT_B_INDEX, :len(delta_b)].tolist()]
    conflicts = [divergent_rename_conflict(sorted_a[ia], sorted_b[ib])
                 for ia, ib in pairs]
    lookup = interner.lookup
    streams = (sorted_a, sorted_b)
    composed = []
    for s, r, ca, cf, cn in zip(*(out[k, :n_out].tolist() for k in (
            OUT_SIDE, OUT_ROW, OUT_CHAIN_ADDR, OUT_CHAIN_FILE, OUT_CHAIN_NAME))):
        op = streams[s][r]
        if ca == NULL_ID and cf == NULL_ID and cn == NULL_ID:
            composed.append(op)
        else:
            composed.append(_materialize_decoded(op, lookup(ca), lookup(cf), lookup(cn)))
    return composed, conflicts


def compose_oplogs_device(delta_a: List[Op], delta_b: List[Op],
                          device: str | torch.device | None = None
                          ) -> Tuple[List[Op], List[Conflict]]:
    """Compose two op logs on ``device`` (CUDA unless ``"cpu"`` is asked
    for). Returns ``(composed, conflicts)``, equal to the host
    composer's. Recorded as the ``compose_device`` span (layer ``ops``)
    unless both logs are empty."""
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    if not delta_a and not delta_b:
        return [], []
    with obs_spans.span("compose_device", layer="ops", n_a=len(delta_a), n_b=len(delta_b)):
        return _compose_on(delta_a, delta_b, device)


def encode_compose_inputs(delta_a: List[Op], delta_b: List[Op], shard_multiple: int = 1):
    """The host encoding both compose paths share: intern both logs into
    their op tensors, and pad buckets divisible by ``shard_multiple``
    (the mesh's ``dp`` size), so the sharded compose's row axis splits
    evenly over any rank count. Returns ``(interner, ta, tb, na, nb,
    n_ts, n_id)``: the padded sizes and the rank tables' lengths."""
    interner = Interner()
    ts_table, id_table = build_rank_tables(delta_a, delta_b)
    ta = encode_oplog(delta_a, interner, ts_table, id_table)
    tb = encode_oplog(delta_b, interner, ts_table, id_table)
    return (interner, ta, tb, shard_bucket(ta.n, shard_multiple),
            shard_bucket(tb.n, shard_multiple), len(ts_table), len(id_table))


def _compose_on(delta_a: List[Op], delta_b: List[Op], device: torch.device
                ) -> Tuple[List[Op], List[Conflict]]:
    if not delta_a and not delta_b:
        return [], []
    interner, ta, tb, na, nb, n_ts, n_id = encode_compose_inputs(delta_a, delta_b)
    both = torch.from_numpy(np.concatenate(
        [_pad_op_tensor(ta, na), _pad_op_tensor(tb, nb)], axis=1)).to(device)
    a = _sort_stream(both[:, :na], n_ts, n_id)
    b = _sort_stream(both[:, na:], n_ts, n_id)
    candidates = _rename_candidates(a, ta.n, b, tb.n)
    out, pairs = _compose_streams(a, ta.n, b, tb.n, candidates, n_ts, n_id)
    return decode_compose_output(out, delta_a, delta_b, interner, pairs)


def _compose_streams(a: torch.Tensor, n_a: int, b: torch.Tensor, n_b: int,
                     candidates: torch.Tensor, n_ts: int, n_id: int,
                     seg_scan=_seg_last_valid):
    """Stages 2b and 3 over the canonical streams: the speculative
    composition, and when its candidate flag is set the host's walk and
    the composition again with the dropped rows. Returns the fetched
    matrix and the walk's conflict pairs."""
    na, nb = a.shape[1], b.shape[1]
    device = a.device
    no_drop = torch.zeros(na + nb, dtype=torch.bool, device=device)
    out = _merge_and_scan(a, b, n_a, n_b, no_drop[:na], no_drop[na:],
                          candidates, n_ts, n_id, seg_scan).cpu().numpy()
    pairs: List[Tuple[int, int]] = []
    if out[OUT_CANDIDATES, 0]:
        pairs, dropped_a, dropped_b = _walk_on_host(a, n_a, b, n_b, n_ts)
        if pairs:
            drop = np.zeros(na + nb, dtype=np.bool_)
            drop[list(dropped_a)] = True
            drop[[na + i for i in dropped_b]] = True
            drop_t = torch.from_numpy(drop).to(device)
            out = _merge_and_scan(a, b, n_a, n_b, drop_t[:na], drop_t[na:],
                                  candidates, n_ts, n_id, seg_scan).cpu().numpy()
    return out, pairs


def recompose_resolved(delta_a: List[Op], delta_b: List[Op],
                       device: str | torch.device | None = None
                       ) -> Tuple[List[Op], List[Conflict]]:
    """Re-compose entry of the conflict-resolution tier
    (:mod:`semantic_merge_tpu_torch.resolve.engine`): compose the two
    op streams a resolution rewrote (conflicting ops dropped or
    replaced). The JAX package composes them with its host composer;
    this runs the device compose on ``device``, with the same bytes. The
    streams are plain object lists at this point. Spans as in the JAX
    package: ``recompose_resolved`` around ``compose_oplogs`` (the name
    of the composer it stands in for; layer ``ops``)."""
    if not isinstance(device, torch.device):
        device = resolve_device(device)
    n = dict(n_a=len(delta_a), n_b=len(delta_b))
    with obs_spans.span("recompose_resolved", layer="ops", **n), \
            obs_spans.span("compose_oplogs", layer="ops", **n):
        return _compose_on(list(delta_a), list(delta_b), device)
