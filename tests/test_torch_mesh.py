"""The port's meshes, posture, process contract and batch mesh against
the JAX package's, in one process (no process group).

- ``mesh_posture`` over every spelling of ``SEMMERGE_MESH`` and
  ``[engine] mesh`` (the environment wins; legacy ``off`` aliases;
  unknown values read as ``auto``);
- ``parse_mesh_spec`` / ``parse_mesh_shape``, errors included;
- ``build_mesh``'s axis sizes (and errors) for 1, 2, 4, 6 and 8 devices
  and the requested layouts of ``tests/test_models_parallel.py``;
- ``batch_mesh_shards``; ``resolve_distributed_config`` over the
  environments of ``tests/test_distributed.py``; ``build_hybrid_mesh``'s
  rank layout against the JAX device-id layout for explicit slice ids;
- ``MeshFault`` (exit 18, stage ``mesh``);
- the batch dispatcher's mesh: ``mesh_stats``, the fallbacks by reason,
  ``require``'s fault, and the batched program over 2, 4 and 8 CPU
  devices, row-equal to the single-device program.
"""
import concurrent.futures
import itertools

import numpy as np
import pytest
import torch

import jax

from semantic_merge_tpu import errors as jax_errors
from semantic_merge_tpu.parallel import distributed as jax_dist
from semantic_merge_tpu.parallel import mesh as jax_mesh
from semantic_merge_tpu_torch import batch, errors
from semantic_merge_tpu_torch.batch import dispatcher
from semantic_merge_tpu_torch.batch.packer import BatchRequest
from semantic_merge_tpu_torch.obs import metrics
from semantic_merge_tpu_torch.ops.fused import batched_fused_program
from semantic_merge_tpu_torch.parallel import distributed, mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_mesh_env(monkeypatch):
    monkeypatch.delenv("SEMMERGE_MESH", raising=False)


# --- the posture ---------------------------------------------------------------------

ENV = [None, "", "off", "auto", "require", "none", "single", "0", "bogus", " Require "]
CONFIGURED = [None, "off", "auto", "require", "single"]


@pytest.mark.parametrize("env,configured", list(itertools.product(ENV, CONFIGURED)))
def test_mesh_posture_matches_the_jax_package(monkeypatch, env, configured):
    if env is not None:
        monkeypatch.setenv("SEMMERGE_MESH", env)
    assert mesh.mesh_posture(configured) == jax_mesh.mesh_posture(configured)


def test_legacy_alias_warns_once(monkeypatch, caplog):
    monkeypatch.setattr(mesh, "_warned_aliases", set())
    monkeypatch.setenv("SEMMERGE_MESH", "single")
    with caplog.at_level("WARNING", logger="semantic_merge_tpu_torch"):
        assert mesh.mesh_posture() == mesh.mesh_posture() == "off"
    assert sum("deprecated alias" in r.getMessage() for r in caplog.records) == 1


# --- the shapes ----------------------------------------------------------------------

SPECS = ["", "auto", "dp=4,tp=2", "dp=1", " dp=2 , sp=4", "bogus=2", "dp=x",
         "hybrid:dcn=dp,dp=8", "hybrid:dp=4,tp=2", "hybrid:dcn=sp,sp=4", "hybrid:dcn=zz,dp=2",
         "hybrid"]


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_and_shape(spec):
    assert _outcome(mesh.parse_mesh_spec, spec) == _outcome(jax_mesh.parse_mesh_spec, spec)
    assert (_outcome(mesh.parse_mesh_shape, spec)
            == _outcome(jax_mesh.parse_mesh_shape, spec))


REQUESTS = [{}, {"dp": 1}, {"dp": 2}, {"sp": 2}, {"tp": 2, "dp": 2}, {"dp": 3},
            {"dp": 3, "pp": 1, "sp": 1, "tp": 1, "ep": 1},
            {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}, {"ep": 2, "pp": 2}]


@pytest.mark.parametrize("n,req", list(itertools.product([1, 2, 4, 6, 8], REQUESTS)),
                         ids=lambda v: str(v))
def test_build_mesh_axis_sizes_match(n, req):
    port = _outcome(lambda: mesh.build_mesh(list(range(n)), **req).axis_sizes)
    want = _outcome(lambda: jax_mesh.build_mesh(jax.devices()[:n], **req).axis_sizes)
    assert port == want


def test_build_mesh_gauges_and_identity_collectives():
    m = mesh.build_mesh([0], dp=1, device="cpu")
    reg = metrics.REGISTRY
    assert reg.gauge("semmerge_mesh_devices").value() == 1
    assert reg.gauge("semmerge_mesh_axis_size").value(axis="dp") == 1
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert m.axis_index("dp") == 0 and m.rank == 0
    assert torch.equal(m.all_gather(x, "dp"), x[None])
    assert torch.equal(m.all_gather(x, "dp", tiled=True, dim=1), x)
    assert torch.equal(m.pmax(x, "dp"), x) and torch.equal(m.psum(x, "dp"), x)
    layout_only = mesh.build_mesh(list(range(4)), dp=4)
    with pytest.raises(RuntimeError, match="no process group"):
        layout_only.pmax(x, "dp")


@pytest.mark.parametrize("n", range(0, 10))
def test_batch_mesh_shards(n):
    assert mesh.batch_mesh_shards([CPU] * n) == jax_mesh.batch_mesh_shards(list(range(n)))


def test_build_batch_mesh():
    bm = mesh.build_batch_mesh([CPU] * 5)
    assert bm.shards == 4 and bm.axis_names == (mesh.BATCH_AXIS,) == ("batch",)
    assert metrics.REGISTRY.gauge("semmerge_batch_mesh_shards").value() == 4
    with pytest.raises(ValueError):
        mesh.build_batch_mesh([CPU] * 2, shards=3)


# --- the processes ----------------------------------------------------------------------

CONFIG_ENVS = [
    {},
    {"SEMMERGE_COORDINATOR": "10.0.0.1:1234", "SEMMERGE_NUM_PROCESSES": "4",
     "SEMMERGE_PROCESS_ID": "2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
    {"SEMMERGE_NUM_PROCESSES": "2"},
    {"SEMMERGE_COORDINATOR": "a:1", "JAX_COORDINATOR_ADDRESS": "b:2",
     "JAX_NUM_PROCESSES": "3", "SEMMERGE_PROCESS_ID": "0"},
]


@pytest.mark.parametrize("env", CONFIG_ENVS, ids=range(len(CONFIG_ENVS)))
def test_resolve_distributed_config_matches(env):
    def plain(cfg):
        return (cfg.coordinator_address, cfg.num_processes, cfg.process_id, cfg.multi_host)

    port = _outcome(lambda: plain(distributed.resolve_distributed_config(env=env)))
    assert port == _outcome(lambda: plain(jax_dist.resolve_distributed_config(env=env)))


def test_one_process_needs_no_group():
    assert distributed.init_distributed(distributed.DistributedConfig(None, 1, 0)).num_processes == 1
    assert distributed.world() == (0, 1) and distributed.is_writer()
    assert distributed.agree_exit_code(7) == 7


HYBRID = [dict(sp=2, tp=1, pp=1, ep=1), dict(dp=4), dict(), dict(dp=2, sp=2, tp=2),
          dict(dp=3, sp=1, tp=1, pp=1, ep=1)]


@pytest.mark.parametrize("kw", HYBRID, ids=range(len(HYBRID)))
@pytest.mark.parametrize("slice_ids", [[0] * 4 + [1] * 4, [0, 1] * 4, [0] * 8],
                         ids=["blocks", "interleaved", "one"])
def test_hybrid_mesh_rank_layout_matches(kw, slice_ids):
    devices = jax.devices()
    ids = {d: i for i, d in enumerate(devices)}

    def jax_layout():
        m = jax_dist.build_hybrid_mesh(devices, slice_ids=slice_ids, dcn_axis="dp", **kw)
        return np.vectorize(ids.get)(m.mesh.devices).tolist()

    port = _outcome(lambda: distributed.build_hybrid_mesh(
        list(range(8)), slice_ids=slice_ids, dcn_axis="dp", **kw).layout.tolist())
    assert port == _outcome(jax_layout)


# --- the fault -----------------------------------------------------------------------------

def test_mesh_fault():
    assert errors.MeshFault.exit_code == jax_errors.MeshFault.exit_code == 18
    assert errors.fault_for_stage("mesh") is errors.MeshFault
    assert errors.EXIT_CODES["MeshFault"] == 18
    assert not errors.is_device_fault(errors.MeshFault("x"))
    with pytest.raises(errors.MeshFault):
        with errors.fault_boundary("mesh"):
            raise OSError("no group")


# --- the batch mesh ----------------------------------------------------------------------------

def _lanes(B: int, seed: int = 0, nb: int = 64, C: int = 64):
    """Random program inputs of B merges on the CPU."""
    rng = np.random.default_rng(seed)

    def decls():
        sym = rng.integers(0, 40, (B, nb))
        sym[:, -8:] = 2**31 - 1  # padding slots
        cols = np.stack([sym, rng.integers(0, 200, (B, nb)), rng.integers(-1, 30, (B, nb)),
                         rng.integers(0, 9, (B, nb))], axis=1)
        return torch.from_numpy(cols.astype(np.int32))

    hash_tab = torch.from_numpy(rng.integers(0, 256, (B, 256, 10)).astype(np.uint8))
    digs = [torch.from_numpy(rng.integers(0, 256, (B, 16)).astype(np.uint8)) for _ in range(2)]
    return (decls(), decls(), decls(), hash_tab, *digs), (nb, C)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_batched_program_over_cpu_devices_equals_one_device(n_devices):
    B = 8
    arrays, (nb, C) = _lanes(B, seed=n_devices)
    single = batched_fused_program(B, nb, nb, nb, C)(*arrays)
    bm = mesh.build_batch_mesh([CPU] * n_devices)
    assert bm.shards == n_devices
    sharded = batched_fused_program(B, nb, nb, nb, C, mesh=bm)(*arrays)
    assert torch.equal(sharded, single)
    with pytest.raises(ValueError):
        batched_fused_program(6, nb, nb, nb, C, mesh=mesh.build_batch_mesh([CPU] * 4))


class _Sched:
    device = CPU

    def __init__(self, mesh_config=None, mesh_devices=None):
        self.mesh_config = mesh_config
        self.mesh_devices = mesh_devices
        self.noted = []

    def note_batch(self, valid, padded):
        self.noted.append((valid, padded))


def _members(n: int):
    arrays, (nb, C) = _lanes(n, seed=3)
    reqs = [BatchRequest(*(a[i] for a in arrays), nb=nb, nl=nb, nr=nb, C=C) for i in range(n)]
    return [(r, concurrent.futures.Future()) for r in reqs], arrays, (nb, C)


@pytest.fixture
def fresh_stats(monkeypatch):
    monkeypatch.setattr(dispatcher, "_mesh_stats", {
        "dispatches": 0, "mesh_dispatches": 0, "last_shape": None,
        "last_rows_per_chip": 0, "last_chip_rows": [], "fallbacks": {}})
    monkeypatch.setattr(dispatcher, "_mesh_cache", {})


def test_dispatch_over_a_batch_mesh(fresh_stats):
    members, arrays, (nb, C) = _members(3)
    sched = _Sched(mesh_devices=[CPU] * 2)
    dispatcher.dispatch_group(sched, members)
    want = batched_fused_program(3, nb, nb, nb, C)(*arrays).numpy()
    for i, (_req, fut) in enumerate(members):
        np.testing.assert_array_equal(fut.result(), want[i])
    stats = dispatcher.mesh_stats()
    assert stats["posture"] == "auto" and stats["mesh_dispatches"] == 1
    assert stats["last_shape"] == "batch=2" and stats["last_chip_rows"] == [2, 1]
    assert stats["last_rows_per_chip"] == 2 and sched.noted == [(3, 4)]
    assert metrics.REGISTRY.gauge("batch_mesh_occupancy_ratio").value() == 0.75


def test_one_device_falls_back_and_require_raises(fresh_stats, monkeypatch):
    members, arrays, _ = _members(2)
    dispatcher.dispatch_group(_Sched(mesh_devices=[CPU]), members)
    assert all(fut.done() for _, fut in members)
    stats = dispatcher.mesh_stats()
    assert stats["fallbacks"] == {"single-device": 1} and stats["mesh_dispatches"] == 0
    assert stats["dispatches"] == 1
    members, _, _ = _members(2)
    with pytest.raises(errors.MeshFault) as info:
        dispatcher.dispatch_group(_Sched(mesh_config="require", mesh_devices=[CPU]), members)
    assert info.value.exit_code == 18 and info.value.cause == "single-device"
    monkeypatch.setenv("SEMMERGE_MESH", "off")
    members, _, _ = _members(2)
    dispatcher.dispatch_group(_Sched(mesh_config="require", mesh_devices=[CPU] * 2), members)
    assert dispatcher.mesh_stats()["posture"] == "off"
    assert dispatcher.mesh_stats()["fallbacks"] == {"single-device": 2}


def test_mesh_fault_under_require_is_not_degraded(monkeypatch):
    monkeypatch.setenv("SEMMERGE_BATCH", "auto")
    fault = errors.MeshFault("no mesh", cause="single-device")
    batch.degrade_or_raise(errors.BatchFault("x"))  # auto: degrades
    batch.degrade_or_raise(fault)
    monkeypatch.setenv("SEMMERGE_MESH", "require")
    with pytest.raises(errors.MeshFault):
        batch.degrade_or_raise(fault)


def test_mesh_stats_keys_match_the_jax_package():
    from semantic_merge_tpu.batch import dispatcher as jax_dispatcher
    assert set(dispatcher.mesh_stats()) == set(jax_dispatcher.mesh_stats())
