"""The merge programs with the decl/op axis sharded over a mesh's ``dp``.

The port of the JAX package's ``ops/sharded.py``. ``dp`` is the merge
programs' one parallel axis: their work is integer sort, join and scan
over decl and op rows. JAX runs these bodies under ``shard_map``; here
every rank of the engine mesh
(:class:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh`) runs them
at once on its own block of rows, and the mesh's collectives stand in
for JAX's. Each body returns the full result, the same on every rank,
and equal to the single-device program's
(:mod:`.diff`, :mod:`.compose`):

- **Diff sort-join**: decl slots shard contiguously; each shard sorts
  its block stably (the distributed sort), all-gathers the shards'
  sorted runs, orders and data columns in one collective, and answers
  its own slots' join queries against all ``k`` runs (first and last
  occurrence = min and max over shards, presence = any). Emission
  offsets are global prefixes: a local cumsum plus the earlier shards'
  totals (one gather of both counts). Each shard scatters its rows into
  the full output (JAX's ``mode="drop"`` is a sink column here) and an
  elementwise ``pmax`` unites the shards: every position is written by
  exactly one shard, and the fill ``NULL_ID = -1`` is the identity.
- **Compose**: op rows shard over ``dp``. The streams' columns are
  all-gathered, the canonical sorts run on every rank, the
  DivergentRename candidate join splits its query axis over the shards
  (``pmax`` of the flags), and the segmented chain scan runs per shard
  with a carry across shards (:func:`_dist_seg_scan`). The cursor walk
  runs on the host of every rank, on the gathered streams.

Index arithmetic is int64 (torch's index type); symbol columns stay
int32 on the wire and are compared as int64, so a gathered ``PAD_ID =
2**31 - 1`` never wraps.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np
import torch

from ..core.conflict import Conflict
from ..core.encode import NULL_ID, PAD_ID, DeclTensor, shard_bucket
from ..core.ops import Op
from ..obs import spans as obs_spans
from .compose import (_IS_RENAME, _NEW_NAME, _SYM, _compose_streams, _pad_op_tensor,
                      _rename_candidate_query, _rename_candidate_table, _rename_pairs,
                      _sort_stream, decode_compose_output, encode_compose_inputs)
from .diff import (KIND_ADD, KIND_DELETE, KIND_MOVE, KIND_RENAME, DiffOpsTensor,
                   _decode_stacked, _padded_cols)

AXIS = "dp"

_INT_MAX = 2**31 - 1


# --------------------------------------------------------------------------
# sharded diff sort-join
# --------------------------------------------------------------------------

def _local_sorted_run(sym: torch.Tensor):
    """Stable local sort of this shard's block by symbol: one run of the
    distributed sort, ``(sorted symbols, sorted position → local slot)``."""
    srt = torch.sort(sym, stable=True)
    return srt.values, srt.indices


def _run_query(tables, orders, offs, S: int, queries):
    """Join ``queries`` against all ``k`` gathered sorted runs
    (``tables``/``orders`` ``[k, S]``, ``offs`` each run's first global
    slot). Per query: present in any run, global first slot, global last
    slot. Stable sorting makes each run's ends the smallest and largest
    local slot of the symbol, so min and max over shards give the global
    occurrence bounds the single-device join reads off its one sorted
    array."""
    q = queries.long().expand(tables.shape[0], queries.shape[-1]).contiguous()
    lo = torch.searchsorted(tables, q).clamp(0, S - 1)
    hi = (torch.searchsorted(tables, q, right=True) - 1).clamp(0, S - 1)
    present = tables.gather(1, lo) == q
    first = orders.gather(1, lo) + offs[:, None]
    last = orders.gather(1, hi) + offs[:, None]
    g_first = torch.where(present, first, _INT_MAX).min(0).values
    g_last = torch.where(present, last, -1).max(0).values
    return present.any(0), g_first, g_last


def _gather_runs(mesh, sym, *cols):
    """This shard's sorted run, then one all-gather of every shard's
    ``[run, order, *cols]``: the runs ``[k, S]``, their orders, and each
    column over all shards (tiled, ``[k * S]``)."""
    srt, order = _local_sorted_run(sym)
    g = mesh.all_gather(torch.stack([srt.long(), order, *(c.long() for c in cols)]), AXIS)
    return (g[:, 0].contiguous(), g[:, 1].contiguous(),
            [g[:, 2 + i].reshape(-1) for i in range(len(cols))])


def _sharded_plan(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb: int, ns: int, mesh,
                  b_extra=(), s_extra=()):
    """The join of one (base, side) pair on this shard's blocks: which
    of its slots emit which kinds at which global positions, with node
    data from which global slots. ``b_extra``/``s_extra`` are further
    columns gathered with the runs (the stacked variant's files)."""
    k, j = mesh.axis_size(AXIS), mesh.axis_index(AXIS)
    Sb, Ss = nb // k, ns // k
    dev = b_sym.device
    my_b_idx = j * Sb + torch.arange(Sb, device=dev)
    b_valid = b_sym != int(PAD_ID)
    s_valid = s_sym != int(PAD_ID)

    # Distributed sort: local runs, then the symbol-table all-gather
    # with the data columns the cross-shard lookups read.
    b_tab, b_tord, b_g = _gather_runs(mesh, b_sym, b_addr, b_name, *b_extra)
    s_tab, s_tord, s_g = _gather_runs(mesh, s_sym, s_addr, s_name, *s_extra)
    off_b = torch.arange(k, device=dev) * Sb
    off_s = torch.arange(k, device=dev) * Ss

    # First occurrence emits, the last occurrence's data wins (JS Map).
    _, bg_first, bg_last = _run_query(b_tab, b_tord, off_b, Sb, b_sym)
    emits = b_valid & (bg_first == my_b_idx)
    bl = bg_last.clamp(0, nb - 1)
    b_addr_l, b_name_l = b_g[0][bl], b_g[1][bl]

    # Side representative (Map last-wins) for my base symbols.
    s_found, _, sg_last = _run_query(s_tab, s_tord, off_s, Ss, b_sym)
    found = s_found & b_valid
    sr = sg_last.clamp(0, ns - 1)
    s_addr_r, s_name_r = s_g[0][sr], s_g[1][sr]

    is_delete = emits & ~found
    is_move = emits & found & (b_addr_l != s_addr_r)
    is_rename = (emits & found & (b_name_l != NULL_ID) & (s_name_r != NULL_ID)
                 & (b_name_l != s_name_r))
    # Adds: my side slots whose symbol is absent from the whole base.
    in_base, _, _ = _run_query(b_tab, b_tord, off_b, Sb, s_sym)
    is_add = s_valid & ~in_base

    # Global emission offsets: local cumsums plus the earlier shards'
    # totals, both counts in one gather.
    base_count = torch.where(is_delete, 1, is_move.long() + is_rename.long())
    add_count = is_add.long()
    cum_b, cum_a = torch.cumsum(base_count, 0), torch.cumsum(add_count, 0)
    totals = mesh.all_gather(torch.stack([cum_b[-1], cum_a[-1]]), AXIS)  # [k, 2]
    before = totals[:j].sum(0)
    total_base = totals[:, 0].sum()
    return {
        "is_delete": is_delete, "is_move": is_move, "is_rename": is_rename,
        "is_add": is_add, "bl": bl, "sr": sr,
        "base_off": before[0] + cum_b - base_count,
        "add_off": total_base + before[1] + cum_a - add_count,
        "n_ops": total_base + totals[:, 1].sum(),
        "b_addr_l": b_addr_l, "b_name_l": b_name_l,
        "s_addr_r": s_addr_r, "s_name_r": s_name_r,
        "b_extra": [g[bl] for g in b_g[2:]], "s_extra": [g[sr] for g in s_g[2:]],
        "my_s_idx": j * Ss + torch.arange(Ss, device=dev),
    }


def _scatter_rows(width: int, plan, base_vals, add_vals, mesh) -> torch.Tensor:
    """The plan's rows scattered into ``len(base_vals)`` int64 columns of
    ``width`` (rows at or past ``width`` fall into the sink column), then
    united over the shards by ``pmax``. ``base_vals(kind)`` gives a base
    slot's column values for ``kind``; ``add_vals`` an add's."""
    n_cols = len(add_vals)
    dev = plan["bl"].device
    out = torch.full((n_cols, width + 1), NULL_ID, dtype=torch.long, device=dev)

    def scatter(posn, mask, values):
        posn = torch.where(mask & (posn < width), posn, width)
        out[:, posn] = torch.stack([v.long().expand_as(posn) for v in values])

    scatter(plan["base_off"], plan["is_delete"], base_vals(KIND_DELETE))
    scatter(plan["base_off"], plan["is_move"], base_vals(KIND_MOVE))
    scatter(plan["base_off"] + plan["is_move"].long(), plan["is_rename"],
            base_vals(KIND_RENAME))
    scatter(plan["add_off"], plan["is_add"], add_vals)
    return mesh.pmax(out[:, :width], AXIS)


def _sharded_diff_core(b_cols, s_cols, nb: int, ns: int, mesh) -> torch.Tensor:
    """Per-shard body: this shard's ``[4, nb/k]`` / ``[4, ns/k]`` blocks
    of (sym, addr, name, file) in, the full ``(9, 2·nb + ns)`` int32
    stacked op stream of :func:`.diff._diff_lift_core` out."""
    b_sym, b_addr, b_name, b_file = b_cols
    s_sym, s_addr, s_name, s_file = s_cols
    plan = _sharded_plan(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb, ns, mesh,
                         b_extra=(b_file,), s_extra=(s_file,))
    m = 2 * nb + ns
    null = torch.tensor(NULL_ID, device=b_sym.device)
    b_data = (b_sym, plan["b_addr_l"], plan["b_name_l"], plan["b_extra"][0])
    s_data = (plan["s_addr_r"], plan["s_name_r"], plan["s_extra"][0])

    def base_vals(kind):
        side = (null, null, null) if kind == KIND_DELETE else s_data
        return [torch.tensor(kind, device=b_sym.device), *b_data, *side]

    out = _scatter_rows(m, plan, base_vals,
                        [torch.tensor(KIND_ADD, device=b_sym.device), s_sym, null, null, null,
                         s_addr, s_name, s_file], mesh)
    return torch.cat([out, plan["n_ops"].expand(1, m)]).to(torch.int32)


def _sharded_diff_slots(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb: int, ns: int,
                        C: int, mesh):
    """Per-shard diff join emitting compact ``(kind, base slot, side
    slot)`` rows of capacity ``C``, the sharded twin of the fused
    program's emitter (:func:`.fused._emit_slots`). Slots are global
    decl indices; the three int32 ``[C]`` columns and the op count are
    the same on every rank. Rows past ``C`` drop (the caller sees
    ``n_ops > C`` and retries bigger)."""
    plan = _sharded_plan(b_sym, b_addr, b_name, s_sym, s_addr, s_name, nb, ns, mesh)
    dev = b_sym.device
    null = torch.tensor(NULL_ID, device=dev)

    def base_vals(kind):
        return [torch.tensor(kind, device=dev), plan["bl"],
                null if kind == KIND_DELETE else plan["sr"]]

    out = _scatter_rows(C, plan, base_vals,
                        [torch.tensor(KIND_ADD, device=dev), null, plan["my_s_idx"]], mesh)
    out = out.to(torch.int32)
    return out[0], out[1], out[2], plan["n_ops"]


def _block(t: DeclTensor, size: int, mesh, device) -> torch.Tensor:
    """This rank's ``[4, size / k]`` block of ``t``'s padded columns."""
    k, j = mesh.axis_size(AXIS), mesh.axis_index(AXIS)
    S = size // k
    return torch.from_numpy(np.ascontiguousarray(
        _padded_cols(t, size)[:, j * S:(j + 1) * S])).to(device)


def diff_lift_device_sharded(base: DeclTensor, side: DeclTensor, mesh) -> DiffOpsTensor:
    """The mesh twin of :func:`.diff.diff_lift_device` (span
    ``diff_sharded``, ``shards=k``); every rank gets the result."""
    k = mesh.axis_size(AXIS)
    nb, ns = shard_bucket(base.n, k), shard_bucket(side.n, k)
    with obs_spans.span("diff_sharded", layer="ops", shards=k):
        out = _sharded_diff_core(_block(base, nb, mesh, mesh.device),
                                 _block(side, ns, mesh, mesh.device), nb, ns, mesh)
        return _decode_stacked(out.cpu().numpy())


def diff_lift_device_pair_sharded(base: DeclTensor, left: DeclTensor, right: DeclTensor,
                                  mesh) -> tuple[DiffOpsTensor, DiffOpsTensor]:
    """The mesh twin of :func:`.diff.diff_lift_device_pair` (span
    ``diff_pair_sharded``, ``shards=k``)."""
    k = mesh.axis_size(AXIS)
    nb, nl, nr = (shard_bucket(t.n, k) for t in (base, left, right))
    with obs_spans.span("diff_pair_sharded", layer="ops", shards=k):
        b = _block(base, nb, mesh, mesh.device)
        out_l = _sharded_diff_core(b, _block(left, nl, mesh, mesh.device), nb, nl, mesh)
        out_r = _sharded_diff_core(b, _block(right, nr, mesh, mesh.device), nb, nr, mesh)
        m = max(out_l.shape[1], out_r.shape[1])

        def pad(a):
            return torch.nn.functional.pad(a, (0, m - a.shape[1]), value=NULL_ID)

        out = torch.stack([pad(out_l), pad(out_r)]).cpu().numpy()
        return _decode_stacked(out[0]), _decode_stacked(out[1])


# --------------------------------------------------------------------------
# sharded compose
# --------------------------------------------------------------------------

def _dist_seg_scan(mesh, seg_sym: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The distributed :func:`.compose._seg_last_valid`: ``vals`` ``[c,
    n]`` and ``seg_sym`` ``[n]`` in (symbol, merged position) order,
    ``n`` a multiple of the ``dp`` size.

    Each shard scans its block of rows with ``torch.cummax`` over global
    row indices. Its carry is, per value row, the last valid row of the
    block with that row's symbol and value; the carries are all-gathered
    and a row with no valid row of its own before it in the block takes
    the last valid row of the earlier shards (global indices grow with
    the shard, so that is their maximum). The symbol check then runs as
    in the one-device scan, so the result is equal to it bit for bit,
    also for segments that span several shards. Every rank gets the
    whole result."""
    k, j = mesh.axis_size(AXIS), mesh.axis_index(AXIS)
    T = seg_sym.shape[-1] // k
    lo = j * T
    dev = vals.device
    my_sym = seg_sym[lo:lo + T].long()
    my_v = vals[:, lo:lo + T].long()
    rows = torch.arange(my_v.shape[0], device=dev)
    gidx = torch.arange(lo, lo + T, device=dev).expand_as(my_v)
    last = torch.cummax(torch.where(my_v != NULL_ID, gidx, -1), dim=-1).values
    c_last = last[:, -1]
    c_loc = (c_last - lo).clamp(min=0)
    carry = torch.stack([c_last, my_sym[c_loc], my_v[rows, c_loc]])  # [3, c]
    allc = mesh.all_gather(carry, AXIS)  # [k, 3, c]
    earlier = torch.arange(k, device=dev)[:, None] < j
    inc_last, src = torch.where(earlier, allc[:, 0], -1).max(0)
    inc_sym, inc_val = allc[src, 1, rows], allc[src, 2, rows]
    local = last >= 0
    loc = (last - lo).clamp(min=0)
    src_sym = torch.where(local, my_sym[loc], inc_sym[:, None])
    src_val = torch.where(local, my_v.gather(-1, loc), inc_val[:, None])
    ok = (local | (inc_last[:, None] >= 0)) & (src_sym == my_sym)
    out = torch.where(ok, src_val, NULL_ID)
    return mesh.all_gather(out, AXIS, tiled=True, dim=-1)


def compose_oplogs_device_sharded(delta_a: List[Op], delta_b: List[Op], mesh
                                  ) -> Tuple[List[Op], List[Conflict]]:
    """The mesh twin of :func:`.compose.compose_oplogs_device` (span
    ``compose_device_sharded``, ``shards=k``): the same composed stream
    and conflicts, on every rank."""
    if not delta_a and not delta_b:
        return [], []
    k = mesh.axis_size(AXIS)
    with obs_spans.span("compose_device_sharded", layer="ops", shards=k,
                        n_a=len(delta_a), n_b=len(delta_b)):
        return _compose_sharded(delta_a, delta_b, mesh)


def _compose_sharded(delta_a: List[Op], delta_b: List[Op], mesh):
    k, j = mesh.axis_size(AXIS), mesh.axis_index(AXIS)
    dev = mesh.device
    interner, ta, tb, na, nb, n_ts, n_id = encode_compose_inputs(delta_a, delta_b,
                                                                 shard_multiple=k)
    Ta, Tb = na // k, nb // k
    a_blk = torch.from_numpy(np.ascontiguousarray(
        _pad_op_tensor(ta, na)[:, j * Ta:(j + 1) * Ta])).to(dev)
    b_blk = torch.from_numpy(np.ascontiguousarray(
        _pad_op_tensor(tb, nb)[:, j * Tb:(j + 1) * Tb])).to(dev)
    # Op-table exchange: both streams' columns, gathered.
    a = _sort_stream(mesh.all_gather(a_blk, AXIS, tiled=True, dim=1), n_ts, n_id)
    b = _sort_stream(mesh.all_gather(b_blk, AXIS, tiled=True, dim=1), n_ts, n_id)
    # The candidate join with B's query axis split over the shards.
    table = _rename_candidate_table((a[_IS_RENAME], a[_SYM], a[_NEW_NAME]), ta.n)
    b_sym, b_name = _rename_pairs(b[_IS_RENAME], b[_SYM], b[_NEW_NAME], tb.n)
    mine = slice(j * Tb, (j + 1) * Tb)
    differing = _rename_candidate_query(table, b_sym[mine].contiguous(), b_name[mine])
    candidates = mesh.pmax(differing.any().long()[None], AXIS)[0] > 0
    out, pairs = _compose_streams(a, ta.n, b, tb.n, candidates, n_ts, n_id,
                                  seg_scan=partial(_dist_seg_scan, mesh))
    return decode_compose_output(out, delta_a, delta_b, interner, pairs)
