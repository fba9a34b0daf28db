"""Process bring-up for a merge sharded over several cards.

The port of the JAX package's ``parallel/distributed.py``, in
PyTorch's idiom: one process per card, joined by a
``torch.distributed`` process group. A user shards a merge over N cards
by starting the same command N times with the JAX package's
environment contract (:func:`resolve_distributed_config`):

    SEMMERGE_COORDINATOR=host:port SEMMERGE_NUM_PROCESSES=N SEMMERGE_PROCESS_ID=i \\
        python -m semantic_merge_tpu_torch semmerge BASE A B --inplace

- :func:`init_distributed` joins the group once per process (a no-op for
  one process): NCCL when every rank of the host has its own card,
  gloo on the CPU and when ranks share a card. Rank ``i`` runs on
  ``cuda:(i % device_count)`` (:func:`rank_device`).
- :func:`build_hybrid_mesh` lays the ranks out so that only the ``dcn``
  axis crosses hosts (ranks that share a hostname form one host, the
  JAX package's "slice"); every other axis stays inside a host.

Every rank scans, encodes and runs the device programs; only rank 0
writes (:func:`is_writer`): the in-place lock, the tree, notes,
artifacts and stdout. The others leave after the last collective with
rank 0's exit code (:func:`agree_exit_code`).
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceUnavailable
from ..utils.loggingx import logger


@dataclass(frozen=True)
class DistributedConfig:
    """Resolved bring-up parameters (all optional for one process)."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1


def resolve_distributed_config(env: Optional[dict] = None) -> DistributedConfig:
    """The environment contract: ``SEMMERGE_COORDINATOR`` (host:port),
    ``SEMMERGE_NUM_PROCESSES``, ``SEMMERGE_PROCESS_ID`` — falling back
    to ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``, then to one process. Several processes without a
    coordinator raise ``ValueError``."""
    env = env if env is not None else dict(os.environ)

    def pick(*names: str, default: Optional[str] = None) -> Optional[str]:
        for name in names:
            value = env.get(name)
            if value:
                return value
        return default

    coord = pick("SEMMERGE_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
    n = int(pick("SEMMERGE_NUM_PROCESSES", "JAX_NUM_PROCESSES", default="1"))
    pid = int(pick("SEMMERGE_PROCESS_ID", "JAX_PROCESS_ID", default="0"))
    if n > 1 and coord is None:
        raise ValueError(
            "multi-process run (num_processes > 1) needs a coordinator "
            "address (SEMMERGE_COORDINATOR=host:port)")
    return DistributedConfig(coordinator_address=coord, num_processes=n,
                             process_id=pid)


_cpu_only = False


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """Whether this process writes the merge's outputs: rank 0, or the
    only process. Before the group is up, the contract's process id
    decides (a run recovers its in-place journal before it joins)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    try:
        return resolve_distributed_config().process_id == 0
    except ValueError:
        return True


def rank_device() -> torch.device:
    """This rank's device: the CPU when the group was brought up for it,
    else ``cuda:(rank % device_count)``. A rank of a group brought up
    for the card on a host without one raises :class:`DeviceUnavailable`
    (never a quiet CPU run); a single process without a card gets the
    CPU (a mesh built only for its layout)."""
    rank, size = world()
    if _cpu_only:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        if size > 1:
            raise DeviceUnavailable(
                "no CUDA device is available for this rank; the port runs on an NVIDIA "
                "GPU (pass --device cpu to every rank to run on the CPU)")
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


#: How long a rank waits in a collective for the others.
_GROUP_TIMEOUT = timedelta(seconds=600)


def _backend_for(config: DistributedConfig, device: str | None) -> str:
    """NCCL when every rank can have its own card (one host, enough
    cards), gloo on the CPU and when ranks share a card."""
    if device == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if config.num_processes <= torch.cuda.device_count() else "gloo"


def init_distributed(config: Optional[DistributedConfig] = None,
                     device: str | None = None) -> DistributedConfig:
    """Join the process group once per process; a no-op for one
    process. ``device`` is what the command asked for (``"cpu"`` keeps
    every rank on the CPU). Records the ``init_distributed`` span and
    sets ``semmerge_distributed_processes``."""
    global _cpu_only
    import torch.distributed as dist
    config = config or resolve_distributed_config()
    if not config.multi_host or dist.is_initialized():
        return config
    from ..obs import metrics as obs_metrics, spans as obs_spans
    backend = _backend_for(config, device)
    _cpu_only = device == "cpu"
    with obs_spans.span("init_distributed", layer="parallel",
                        processes=config.num_processes, process_id=config.process_id):
        if backend == "nccl":
            torch.cuda.set_device(config.process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://{config.coordinator_address}",
            world_size=config.num_processes, rank=config.process_id,
            timeout=_GROUP_TIMEOUT)
    obs_metrics.REGISTRY.gauge(
        "semmerge_distributed_processes",
        "Process count of the torch.distributed job").set(config.num_processes)
    logger.info("torch.distributed up (%s): process %d/%d via %s", backend,
                config.process_id, config.num_processes, config.coordinator_address)
    return config


def agree_exit_code(code: int) -> int:
    """Rank 0's ``code`` on every rank (the last collective of a sharded
    command, a broadcast over the group, one rank's included); ``code``
    itself for a process with no group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return code
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(code)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def host_slice_ids() -> list[int]:
    """Per rank, the index of its host among the sorted hostnames of the
    group (ranks that share a hostname share a "slice")."""
    import torch.distributed as dist
    rank, size = world()
    if size == 1:
        return [0]
    names: list = [None] * size
    dist.all_gather_object(names, socket.gethostname())
    order = {name: i for i, name in enumerate(sorted(set(names)))}
    return [order[name] for name in names]


def build_hybrid_mesh(devices: Optional[Sequence[int]] = None, *,
                      num_slices: Optional[int] = None, dcn_axis: str = "dp",
                      slice_ids: Optional[Sequence[int]] = None,
                      dp: Optional[int] = None, pp: Optional[int] = None,
                      sp: Optional[int] = None, tp: Optional[int] = None,
                      ep: Optional[int] = None, device=None):
    """A :class:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh`
    whose ``dcn_axis`` factor spans hosts and all other axes stay within
    one host: the JAX package's device layout, over ranks.

    ``slice_ids`` default to :func:`host_slice_ids` and ``num_slices``
    to their distinct count; one slice gives the plain
    :func:`~semantic_merge_tpu_torch.parallel.mesh.build_mesh`. The
    ranks of each slice are laid out by the one-slice factorization and
    the slices stacked as the outermost factor of ``dcn_axis``, so only
    that axis has strides that cross hosts. ``device`` is where this
    rank's blocks live (default :func:`rank_device`)."""
    import math

    from .mesh import MESH_AXES, _finish_mesh, build_mesh, mesh_sizes

    if devices is None:
        devices = list(range(world()[1]))
    devices = [int(d) for d in devices]
    if slice_ids is None:
        slice_ids = host_slice_ids() if len(devices) == world()[1] else [0] * len(devices)
    if num_slices is None:
        num_slices = len(set(slice_ids))
    if num_slices <= 1:
        return build_mesh(devices, dp=dp, pp=pp, sp=sp, tp=tp, ep=ep, device=device)

    by_slice: dict = {}
    for d, s in zip(devices, slice_ids):
        by_slice.setdefault(s, []).append(d)
    groups = [by_slice[s] for s in sorted(by_slice)]
    per_slice = len(groups[0])
    if any(len(g) != per_slice for g in groups):
        raise ValueError("slices expose unequal device counts: "
                         f"{[len(g) for g in groups]}")

    requested = {"dp": dp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    intra = dict(requested)
    if requested[dcn_axis] is None:
        intra[dcn_axis] = None  # inferred per slice; total = inferred * num_slices
    elif requested[dcn_axis] % num_slices != 0:
        raise ValueError(
            f"{dcn_axis}={requested[dcn_axis]} must be a multiple of "
            f"num_slices={num_slices} (the slice factor rides DCN)")
    else:
        intra[dcn_axis] = requested[dcn_axis] // num_slices

    inner_shape = mesh_sizes(per_slice, **intra)
    sizes = dict(zip(MESH_AXES, inner_shape))
    sizes[dcn_axis] *= num_slices
    if math.prod(sizes.values()) != len(devices):
        raise ValueError(f"axis sizes {sizes} do not cover {len(devices)} devices")
    arr = np.stack([np.asarray(g, dtype=np.int64).reshape(inner_shape) for g in groups])
    arr = np.moveaxis(arr, 0, MESH_AXES.index(dcn_axis))
    return _finish_mesh(arr.reshape([sizes[name] for name in MESH_AXES]), device)
