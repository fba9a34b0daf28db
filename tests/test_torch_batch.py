"""The port's continuous batching against the JAX package's.

On the CPU (the plain SHA-256, no kernel):

- **The batched program**: the port's ``batched_fused_program`` at
  B = 1, 2, 4 against JAX's ``batched_fused_program`` on the same
  inputs — decl columns scanned and encoded from ``bench.synth_repo``
  snapshots (one interner, a common bucket), their digest table and
  seeded prefix digests: the ``[B, 8 + 24C]`` stacks byte-equal, at two
  capacities; each row equal to the one-merge one-buffer row.
- **The one-buffer layout**: the port's ``_fused_merge_program`` row
  against JAX's ``_fused_merge_kernel(split=False)``, whose
  ``split=True`` parts are its three slices.
- **The engine seam** (the cases of ``tests/test_batch.py``): concurrent
  ``TorchTSBackend(device="cpu")`` merges released together by a
  barrier under an active scheduler on the CPU — same shape, bucket
  straddle (with an empty and a conflict-bearing merge), mixed repos —
  give op logs, composed stream and conflicts equal to their unbatched
  runs and to the JAX package's fused merge, and co-batch; a
  ``batch:pack`` / ``batch:dispatch`` / ``batch:scatter`` fault on one
  member degrades that member alone; postures ``off``, ``auto``,
  ``require``, and a merge on another device than the scheduler's.
- **The bucket shape**: a batched program refuses decl columns of
  another bucket.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from bench import synth_repo
from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.ops.fused import (_fused_merge_kernel,
                                          batched_fused_program as jax_batched_program)
from semantic_merge_tpu_torch import batch
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.core.encode import PAD_ID, Interner, encode_decls, pad_to
from semantic_merge_tpu_torch.errors import BatchFault
from semantic_merge_tpu_torch.frontend.scanner import scan_snapshot
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.obs import metrics as obs_metrics
from semantic_merge_tpu_torch.ops import fused
from semantic_merge_tpu_torch.utils import faults, reqenv

KW = dict(seed="s", base_rev="r", timestamp="2026-01-02T03:04:05Z")


# --- the batched program ------------------------------------------------------------

def _port_snaps(snaps):
    return tuple(Snapshot(files=list(s.files)) for s in snaps)


def _program_batch(n_merges, seed, nb=64):
    """``n_merges`` merges' inputs stacked: decl columns of
    ``synth_repo`` snapshots of several sizes, encoded by one interner
    and padded to ``nb``; the interner's digest table; seeded digests."""
    rs = np.random.RandomState(seed)
    interner = Interner()
    cols = []
    for i in range(n_merges):
        snaps = synth_repo(3 + (seed + i) % 4, 2, divergent=bool(i % 2))
        stacked = []
        for snap in snaps:
            t = encode_decls(scan_snapshot(snap.files), interner)
            stacked.append(np.stack([pad_to(t.sym, nb, PAD_ID), pad_to(t.addr, nb, -1),
                                     pad_to(t.name, nb, -1), pad_to(t.file, nb, -1)]))
        cols.append(stacked)
    b, l, r = (np.stack([c[k] for c in cols]) for k in range(3))
    tab = fused.DeviceStrings(interner, torch.device("cpu")).sync().numpy()
    tabs = np.stack([tab] * n_merges)
    digs = [rs.randint(0, 256, (n_merges, 16)).astype(np.uint8) for _ in range(2)]
    return b, l, r, tabs, digs[0], digs[1]


@pytest.mark.parametrize("B,C", [(1, 64), (2, 64), (4, 64), (4, 8)])
def test_batched_program_matches_jax(B, C):
    inputs = _program_batch(B, seed=B + C)
    nb = inputs[0].shape[-1]
    want = np.asarray(jax_batched_program(B, nb, nb, nb, C)(*inputs))
    got = fused.batched_fused_program(B, nb, nb, nb, C)(*map(torch.from_numpy, inputs))
    assert got.dtype == torch.int32 and got.shape == (B, 8 + 24 * C)
    assert got.numpy().tobytes() == want.tobytes()
    rows = got.numpy()
    assert (rows[:, 4] == ((rows[:, 0] > C) | (rows[:, 1] > C))).all()  # overflow flags
    for i in range(B):  # each lane is the one-merge one-buffer row
        one = fused._fused_merge_program(*(torch.from_numpy(x[i]) for x in inputs), C=C)
        assert one.numpy().tobytes() == got[i].numpy().tobytes()


def test_one_buffer_layout_matches_jax():
    b, l, r, tabs, dl, dr = _program_batch(1, seed=7)
    nb, C = b.shape[-1], 64
    args = (b[0], l[0], r[0], tabs[0], dl[0], dr[0])
    want = np.asarray(_fused_merge_kernel(*args, nb=nb, nl=nb, nr=nb, C=C, split=False))
    targs = [torch.from_numpy(x) for x in args]
    row = fused._fused_merge_program(*targs, C=C)
    assert row.numpy().tobytes() == want.tobytes()
    parts = _fused_merge_kernel(*args, nb=nb, nl=nb, nr=nb, C=C, split=True)
    assert b"".join(np.asarray(x).tobytes() for x in parts) == want.tobytes()


def test_batched_program_refuses_another_bucket_shape():
    with pytest.raises(ValueError):
        fused.batched_fused_program(2, 16, 16, 16, 8)(*map(torch.from_numpy,
                                                           _program_batch(2, seed=1, nb=24)))


# --- the engine seam ----------------------------------------------------------------

def fingerprint(merge_result):
    """Everything a merge observably produces: both op logs, the
    composed stream and the conflicts."""
    result, composed, conflicts = merge_result
    return ([op.to_dict() for op in result.op_log_left],
            [op.to_dict() for op in result.op_log_right],
            [op.to_dict() for op in composed],
            [c.to_dict() for c in conflicts])


def baseline(snaps):
    assert batch.current() is None
    return fingerprint(TorchTSBackend(device="cpu").merge(*_port_snaps(snaps), **KW))


def jax_baseline(snaps):
    return fingerprint(TpuTSBackend(mesh=False).merge(*snaps, **KW))


@contextlib.contextmanager
def active_batching(**kwargs):
    batch.activate(device="cpu", **kwargs)
    try:
        yield batch.current()
    finally:
        batch.deactivate()


def run_concurrent(jobs):
    """Run ``jobs`` — ``(snapshots, overlay env or None)`` — one thread
    each, released together by a barrier so they land in one batch
    window. Each thread owns a fresh backend, warmed through the bypass
    posture first. Returns the fingerprints; re-raises the first error."""
    n = len(jobs)
    results = [None] * n
    errors = [None] * n
    barrier = threading.Barrier(n)

    def work(i, snaps, env):
        try:
            be = TorchTSBackend(device="cpu")
            snaps = _port_snaps(snaps)
            with reqenv.overlay({batch.ENV_POSTURE: "off"}):
                be.merge(*snaps, **KW)  # warm caches off the batched path
            barrier.wait(timeout=60)
            with reqenv.overlay(env or {}):
                results[i] = fingerprint(be.merge(*snaps, **KW))
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors[i] = exc
            with contextlib.suppress(threading.BrokenBarrierError):
                barrier.abort()

    threads = [threading.Thread(target=work, args=(i, snaps, env))
               for i, (snaps, env) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for exc in errors:
        if exc is not None:
            raise exc
    return results


def outcome_total(outcome: str) -> float:
    return obs_metrics.REGISTRY.counter("batch_requests_total").value(outcome=outcome)


@pytest.fixture
def clean():
    faults.reset()
    yield
    batch.deactivate()
    faults.reset()


def test_cobatched_same_shape_parity(clean):
    snaps = synth_repo(4, 2)
    want = baseline(snaps)
    assert want == jax_baseline(snaps)
    with active_batching(window_ms=200.0) as sched:
        got = run_concurrent([(snaps, None)] * 4)
        stats = sched.stats()
    for i, fp in enumerate(got):
        assert fp == want, f"request {i} diverged from the unbatched run"
    assert stats["requests_batched"] == 4 and stats["device"] == "cpu"
    assert stats["mean_batch_size"] > 1.0


def test_bucket_ladder_straddle_parity(clean):
    base, _, _ = synth_repo(4, 2)
    scenarios = [synth_repo(3, 2), synth_repo(6, 3), synth_repo(12, 2),
                 (base, base, base), synth_repo(6, 2, divergent=True)]
    want = [baseline(s) for s in scenarios]
    assert want[3][2] == [] and want[4][3]  # an empty merge, a conflict
    assert want[4] == jax_baseline(scenarios[4])
    with active_batching(window_ms=200.0) as sched:
        got = run_concurrent([(s, None) for s in scenarios])
        stats = sched.stats()
    for i, fp in enumerate(got):
        assert fp == want[i], f"scenario {i} diverged from its unbatched run"
    assert stats["requests_batched"] == len(scenarios)


def test_mixed_repos_one_window_parity(clean):
    snaps_a = synth_repo(4, 2)
    snaps_b = tuple(Snapshot(files=[{**f, "path": "pkg/" + f["path"]} for f in s.files])
                    for s in snaps_a)
    want_a, want_b = baseline(snaps_a), baseline(snaps_b)
    assert want_a != want_b
    with active_batching(window_ms=200.0) as sched:
        got = run_concurrent([(snaps_a, None), (snaps_b, None),
                              (snaps_a, None), (snaps_b, None)])
        stats = sched.stats()
    assert got == [want_a, want_b, want_a, want_b]
    assert stats["requests_batched"] == 4 and stats["mean_batch_size"] > 1.0


@pytest.mark.parametrize("stage", ["batch:pack", "batch:dispatch", "batch:scatter"])
def test_midflight_fault_degrades_only_affected_request(clean, stage):
    snaps = synth_repo(4, 2)
    want = baseline(snaps)
    degraded_before = outcome_total("degraded")
    batched_before = outcome_total("batched")
    with active_batching(window_ms=200.0):
        got = run_concurrent([(snaps, {"SEMMERGE_FAULT": f"{stage}:fault"}),
                              (snaps, None)])
    assert got == [want, want]
    assert outcome_total("degraded") >= degraded_before + 1
    assert outcome_total("batched") >= batched_before + 1


def test_posture_off_bypasses_subsystem(clean):
    snaps = synth_repo(4, 2)
    want = baseline(snaps)
    bypass_before = outcome_total("bypass")
    with active_batching(window_ms=20.0) as sched:
        with reqenv.overlay({batch.ENV_POSTURE: "off"}):
            got = fingerprint(TorchTSBackend(device="cpu").merge(*_port_snaps(snaps), **KW))
        stats = sched.stats()
    assert got == want and stats["requests_batched"] == 0
    assert outcome_total("bypass") >= bypass_before + 1


def test_posture_auto_batches_a_lone_request(clean):
    snaps = synth_repo(4, 2)
    want = baseline(snaps)
    with active_batching(window_ms=1.0) as sched:
        got = fingerprint(TorchTSBackend(device="cpu").merge(*_port_snaps(snaps), **KW))
        stats = sched.stats()
    assert got == want
    assert stats["requests_batched"] == 1 and stats["batches_total"] >= 1


def test_posture_require_without_scheduler_raises(clean):
    assert batch.current() is None
    with reqenv.overlay({batch.ENV_POSTURE: "require"}):
        with pytest.raises(BatchFault) as info:
            batch.plan_for_request(torch.device("cpu"))
    assert info.value.exit_code == 16


def test_merge_on_another_device_never_joins_the_batch(clean):
    """A ``--device cpu`` merge inside a CUDA daemon: ``auto`` bypasses
    the scheduler, ``require`` raises."""
    sched = batch.activate(device="cuda")  # never handed a request here
    try:
        bypass_before = outcome_total("bypass")
        assert batch.plan_for_request(torch.device("cpu")) is None
        assert outcome_total("bypass") == bypass_before + 1
        with reqenv.overlay({batch.ENV_POSTURE: "require"}):
            with pytest.raises(BatchFault):
                batch.plan_for_request(torch.device("cpu"))
        assert batch.plan_for_request(torch.device("cuda")) is sched
    finally:
        batch.deactivate()


def test_require_under_active_scheduler_batches_and_fault_escapes(clean):
    snaps = synth_repo(4, 2)
    want = baseline(snaps)
    with active_batching(window_ms=1.0):
        with reqenv.overlay({batch.ENV_POSTURE: "require"}):
            got = fingerprint(TorchTSBackend(device="cpu").merge(*_port_snaps(snaps), **KW))
        assert got == want
        with reqenv.overlay({batch.ENV_POSTURE: "require",
                             "SEMMERGE_FAULT": "batch:dispatch:fault"}):
            with pytest.raises(BatchFault):
                TorchTSBackend(device="cpu").merge(*_port_snaps(snaps), **KW)



@pytest.mark.parametrize("valid,shards", [(1, 1), (3, 1), (5, 4), (3, 4), (8, 2)])
def test_packer_ladder_and_placement_match_jax(valid, shards):
    from semantic_merge_tpu.batch import packer as jax_packer
    from semantic_merge_tpu_torch.batch import packer
    padded = packer.batch_bucket(valid, shards)
    assert padded == jax_packer.batch_bucket(valid, shards)
    assert packer.placement_for(valid, padded, shards) == \
        jax_packer.placement_for(valid, padded, shards)
