"""The port's fused merge engine against the JAX package's.

``semantic_merge_tpu_torch/ops/fused.py`` runs the diff join, the op ids
(SHA-256) and the compose in one device pass. On the CPU (the plain
SHA-256, no kernel):

- **Programs**: the same seeded decl columns, digest table and prefix
  digests through JAX's ``_fused_merge_kernel(split=True)`` and
  ``_fused_diff_kernel`` and the port's ``_fused_merge_program`` and
  ``_fused_diff_program``: the packed head (scalars, kinds, slots,
  digest words), the canonical permutations, the composed references
  and the chain columns byte-equal.
- **The seven-key canonical sort** against JAX's ``_sort_perm`` on
  fuzzed columns (ties in the leading keys, unsigned words of 2**31 and
  above, invalid rows).
- **Backends**: ``TorchTSBackend(device="cpu")`` merge and diff without
  changeSignature against ``TpuTSBackend(mesh=False)`` (the JAX fused
  path) and against the port's own two-program path: op logs, composed
  stream, conflicts and symbol maps equal as dicts. Cases: rename, move,
  add and delete; a DivergentRename conflict; rename-chain context;
  empty and identical snapshots; a warm repeat with capacity growth;
  a seeded fuzz. The fused path is shown to be the one taken.

Snapshots are kept under 9 decls so that the JAX programs compile once.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.ops.compose import _sort_perm as jax_sort_perm
from semantic_merge_tpu.ops.fused import _fused_diff_kernel, _fused_merge_kernel
from semantic_merge_tpu_torch.backends import ts_torch
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.ops import fused
from semantic_merge_tpu_torch.ops.oplog_view import ComposedOpView, OpStreamView

KW = dict(seed="s", base_rev="r", timestamp="2026-01-02T03:04:05Z")
PAD = 2**31 - 1


# --- the device programs ------------------------------------------------------------

def _decl_cols(rs, n, pad, n_sym):
    cols = np.full((4, pad), -1, np.int32)
    cols[0] = PAD
    cols[:, :n] = np.stack([rs.randint(0, n_sym, n), rs.randint(0, 900, n),
                            rs.randint(-1, 40, n), rs.randint(0, 30, n)])
    return cols


def _program_inputs(seed):
    rs = np.random.RandomState(seed)
    n_sym = rs.randint(4, 40)
    cols = [_decl_cols(rs, rs.randint(33, 49), 48, n_sym) for _ in range(3)]
    tab = rs.randint(0, 256, (1024, 10)).astype(np.uint8)
    digs = [rs.randint(0, 256, 16).astype(np.uint8) for _ in range(2)]
    return cols, tab, digs


@pytest.mark.parametrize("seed", range(6))
def test_merge_program_matches_jax(seed):
    cols, tab, (dl, dr) = _program_inputs(seed)
    want = _fused_merge_kernel(*cols, tab, dl, dr, nb=48, nl=48, nr=48, C=128, split=True)
    t = [torch.from_numpy(c) for c in cols]
    got = fused._fused_merge_program(*t, torch.from_numpy(tab), torch.from_numpy(dl),
                                     torch.from_numpy(dr), C=128)
    for name, g, w in zip(("head", "mid", "chains"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32, name
        assert g.numpy().tobytes() == w.tobytes(), name
    head = got[0].numpy()
    assert head[4] == 0 and 0 < head[0] <= 128 and 0 < head[1] <= 128  # no overflow


@pytest.mark.parametrize("seed", range(3))
def test_diff_program_matches_jax(seed):
    cols, tab, (dig, _) = _program_inputs(seed)
    want = np.asarray(_fused_diff_kernel(cols[0], cols[1], tab, dig, nb=48, ns=48, C=128))
    got = fused._fused_diff_program(torch.from_numpy(cols[0]), torch.from_numpy(cols[1]),
                                    torch.from_numpy(tab), torch.from_numpy(dig), C=128)
    assert got.numpy().tobytes() == want.tobytes()
    small = fused._fused_diff_program(torch.from_numpy(cols[0]), torch.from_numpy(cols[1]),
                                      torch.from_numpy(tab), torch.from_numpy(dig), C=8).numpy()
    assert small[0] == want[0] and small[1] == (want[0] > 8)  # the overflow flag


@pytest.mark.parametrize("seed", range(4))
def test_canonical_order_matches_jax_sort_perm(seed):
    rs = np.random.RandomState(seed)
    n = 300
    prec = rs.choice([10, 11, 30, 31], n).astype(np.int32)
    ts = rs.randint(-1, 3, n).astype(np.int32)
    side = rs.randint(0, 2, n).astype(np.int32)
    words = rs.randint(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    words[: n // 3, :2] = words[0, :2]               # ties in the leading words
    words[n // 3: n // 2, :3] = words[n // 3, :3]
    words[rs.rand(n) < 0.3, 0] |= np.uint32(2**31)    # high words past 2**31
    invalid = rs.rand(n) < 0.15                        # padding rows: max words
    prec[invalid], ts[invalid], words[invalid] = 2**30, -1, 0xFFFFFFFF
    want, _ = jax_sort_perm(prec, ts, side, *(words[:, k] for k in range(4)))
    got = fused._canonical_order(torch.from_numpy(prec), torch.from_numpy(ts),
                                 torch.from_numpy(side),
                                 torch.from_numpy(words.astype(np.int64)))
    keys = np.stack([prec, ts, side, *(words[:, k].astype(np.int64) for k in range(4))], 1)
    assert keys[got.numpy()].tolist() == keys[np.asarray(want)].tolist()
    assert got.numpy().tolist() == np.asarray(want).tolist()


# --- through the backends -----------------------------------------------------------

def _dicts(ops):
    return [o.to_dict() for o in ops]


def _snaps(trees, cls):
    return [cls(files=[{"path": p, "content": c} for p, c in sorted(t.items())])
            for t in trees]


def _jax_merge(trees):
    return TpuTSBackend(mesh=False).merge(*_snaps(trees, JaxSnapshot), **KW)


def _assert_same(got, want):
    (res_g, comp_g, conf_g), (res_w, comp_w, conf_w) = got, want
    assert _dicts(res_g.op_log_left) == _dicts(res_w.op_log_left)
    assert _dicts(res_g.op_log_right) == _dicts(res_w.op_log_right)
    assert _dicts(comp_g) == _dicts(comp_w)
    assert [c.to_dict() for c in conf_g] == [c.to_dict() for c in conf_w]


def _check(trees, backend=None):
    """Port fused merge vs JAX fused merge vs the port's two-program path."""
    backend = backend or TorchTSBackend(device="cpu")
    got = backend.merge(*_snaps(trees, Snapshot), **KW)
    assert backend.path == "fused"
    res, composed, _ = got
    assert isinstance(res.op_log_left, OpStreamView) and isinstance(composed, ComposedOpView)
    want = _jax_merge(trees)
    _assert_same(got, want)
    assert res.symbol_maps == want[0].symbol_maps
    two = TorchTSBackend(device="cpu")
    result = two.build_and_diff(*_snaps(trees, Snapshot), **KW)
    _assert_same(got, (result, *two.compose(result.op_log_left, result.op_log_right)))
    return got


_TYPES = ("number", "string", "boolean", "bigint", "object", "unknown")


def _fn(name, k=0, t=None):
    """A function whose structural signature (hence symbolId) is the
    ``k``-th of a family of distinct ones, or returns type ``t``."""
    params = ", ".join(f"p{i}: {_TYPES[(k // 6 ** i) % 6]}" for i in range(2))
    return f"export function {name}({params}): {t or 'void'} {{}}\n"


def test_rename_move_add_delete():
    base = {"a.ts": _fn("f", 0) + _fn("g", 1),
            "b.ts": "export class C { m(): void {} }\n", "c.ts": _fn("gone", 2)}
    left = dict(base, **{"a.ts": _fn("renamed", 0) + _fn("g", 1), "d.ts": _fn("fresh", 3)})
    right = {"a.ts": base["a.ts"], "lib/b.ts": base["b.ts"]}
    _, composed, conflicts = _check((base, left, right))
    assert not conflicts
    assert {"moveDecl", "renameSymbol", "addDecl", "deleteDecl"} <= {o.type for o in composed}


def test_divergent_rename_conflict():
    base = {"a.ts": _fn("f", 0) + _fn("h", 1)}
    left = {"a.ts": _fn("lname", 0) + _fn("h", 1)}
    right = {"a.ts": _fn("rname", 0) + _fn("h", 1)}
    _, _, conflicts = _check((base, left, right))
    assert [c.to_dict()["category"] for c in conflicts] == ["DivergentRename"]


def test_rename_chain_context():
    base = {"a.ts": _fn("f"), "b.ts": _fn("g", 1)}
    left = {"a.ts": _fn("newf"), "b.ts": _fn("g", 1)}
    _, composed, _ = _check((base, left, {"lib/a.ts": _fn("f"), "b.ts": _fn("g", 1)}))
    assert {"renameSymbol", "moveDecl"} <= {o.type for o in composed}
    # B deletes the symbol A renamed: the delete composes after the
    # rename and carries its context.
    _, composed, _ = _check((base, left, {"b.ts": _fn("g", 1)}))
    assert [o.params.get("renameContext") for o in composed
            if o.type == "deleteDecl"] == ["newf"]


def test_empty_and_identical_snapshots():
    _check(({}, {}, {}))
    same = {"a.ts": _fn("f")}
    _, composed, _ = _check((same, same, same))
    assert len(composed) == 0


def test_warm_repeat_and_capacity_growth(monkeypatch):
    """One backend for three merges; its engine starts at a capacity of
    8 rows, so the third merge overflows and retries at a larger one."""
    backend = TorchTSBackend(device="cpu")
    engine = backend._fused_engine()
    engine._cap_hint = 8
    small = ({"a.ts": _fn("f")}, {"a.ts": _fn("g")}, {"lib/a.ts": _fn("f")})
    base = {f"m{i}.ts": _fn(f"f{i}", i) for i in range(8)}
    grown = (base, {f"n{i}.ts": _fn(f"r{i}", i) for i in range(8)},
             {f"lib/m{i}.ts": _fn(f"f{i}", i) for i in range(8)})
    capacities = []
    program = fused._fused_merge_program

    def counting(*args):
        capacities.append(args[-1])
        return program(*args)

    monkeypatch.setattr(fused, "_fused_merge_program", counting)
    for trees in (small, small, grown):
        _check(trees, backend)
    assert capacities[:3] == [8, 8, 8] and capacities[3] > 8
    assert engine._cap_hint > 8


def test_fuzz():
    rng = random.Random(3)
    kinds = ["number", "string", "boolean"]
    for trial in range(6):
        files = {f"m{i}.ts": "".join(_fn(f"fn{i}_{d}", rng.randrange(4), kinds[rng.randrange(3)])
                                     for d in range(rng.randrange(1, 3)))
                 for i in range(rng.randrange(1, 4))}

        def mutate():
            out = {}
            for p, c in files.items():
                roll = rng.random()
                if roll < 0.2:
                    out["moved/" + p] = c
                elif roll < 0.45:
                    out[p] = c.replace("fn", f"rn{rng.randrange(3)}_", 1)
                elif roll < 0.55:
                    continue
                else:
                    out[p] = c
            if rng.random() < 0.4:
                out[f"new{rng.randrange(9)}.ts"] = _fn("added", 5)
            return out

        global KW
        saved = KW
        KW = dict(saved, seed=f"t{trial}")
        try:
            _check((files, mutate(), mutate()))
        finally:
            KW = saved


def test_diff_matches_jax_and_two_program():
    base = {"a.ts": _fn("f", 0) + _fn("g", 1), "b.ts": _fn("h", 2)}
    side = {"a.ts": _fn("f2", 0) + _fn("g", 1), "lib/b.ts": _fn("h", 2), "c.ts": _fn("k", 3)}
    backend = TorchTSBackend(device="cpu")
    for _ in range(2):  # warm repeat
        got = backend.diff(*_snaps((base, side), Snapshot), **KW)
        assert backend.path == "fused" and isinstance(got, OpStreamView)
        assert {"scan", "encode", "fused", "materialize"} <= set(backend.phases)
        want = TpuTSBackend(mesh=False).diff(*_snaps((base, side), JaxSnapshot), **KW)
        assert _dicts(got) == _dicts(want)
        # The two-program path: the same ops, lifted on the host.
        two = backend.diff(*_snaps((base, side), Snapshot), change_signature=True, **KW)
        assert backend.path == "two-program" and _dicts(two) == _dicts(got)


def test_fused_path_is_taken(monkeypatch):
    """The default merge runs FusedMergeEngine.merge and never the
    two-program branch's diff or compose."""
    def refuse(*_a, **_k):
        raise AssertionError("the two-program branch ran")

    monkeypatch.setattr(ts_torch, "diff_lift_device_pair", refuse)
    monkeypatch.setattr(ts_torch, "compose_oplogs_device", refuse)
    ran = []
    merge = fused.FusedMergeEngine.merge
    monkeypatch.setattr(fused.FusedMergeEngine, "merge",
                        lambda self, *a, **k: ran.append(1) or merge(self, *a, **k))
    backend = TorchTSBackend(device="cpu")
    trees = ({"a.ts": _fn("f")}, {"a.ts": _fn("g")}, {"lib/a.ts": _fn("f")})
    backend.merge(*_snaps(trees, Snapshot), **KW)
    assert ran == [1] and backend.path == "fused"
    assert {"fused", "render", "materialize"} <= set(backend.phases)
    assert "compose" not in backend.phases


def test_changesig_candidate_takes_two_program_path():
    """changeSignature with a foldable delete+add pair (same file, name,
    kind): the refinement would rewrite the stream, so the merge leaves
    the fused result for the two-program path, as the JAX package does."""
    base = {"a.ts": _fn("f")}
    left = {"a.ts": _fn("f", 4)}
    right = {"lib/a.ts": _fn("f")}
    kw = dict(KW, change_signature=True)
    backend = TorchTSBackend(device="cpu")
    got = backend.merge(*_snaps((base, left, right), Snapshot), **kw)
    want = TpuTSBackend(mesh=False).merge(*_snaps((base, left, right), JaxSnapshot), **kw)
    # The fused attempt ran, then the two-program path on the same scan.
    assert backend.path == "two-program" and {"fused", "compose"} <= set(backend.phases)
    _assert_same(got, want)
    assert "changeSignature" in [o.type for o in got[0].op_log_left]


def test_tail_plan_concurrent_consumers_agree():
    """The host-tail plan under contention: decodes prefetched into a
    pool of more workers than cores, claimed (or cancelled and computed
    inline) by eight consumer threads at once with a short switch
    interval, give every consumer the serial result, in shard order."""
    import os
    import sys
    import threading

    def decode(lo, hi):
        return (list(range(lo, hi)), [None] * (hi - lo), [str(i) for i in range(lo, hi)])

    pipe = fused.TailPipeline(workers=4 * (os.cpu_count() or 1), shard_rows=3)
    pipe.eager_overlap = True
    want = decode(0, 300)
    results = [None] * 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        plan = fused.TailPlan(pipe, 300, decode)
        plan.prefetch()
        threads = [threading.Thread(target=lambda k=k: results.__setitem__(k, plan.decode_all()))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        shards = [plan.submit_materialize(lo, hi, lambda lo, hi, ov: ov[2])
                  for lo, hi in plan.ranges]
        assert [x for f in shards for x in f.result()] == want[2]
    finally:
        sys.setswitchinterval(switch)
    assert all(r == want for r in results)
