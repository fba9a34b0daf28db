"""Meshes, the mesh posture and the collectives of the sharded programs.

The port of the JAX package's ``parallel/mesh.py``. Five named axes
cover the parallelism strategies:

- ``dp`` — data parallel: the decl/op row axis of the merge programs
  (:mod:`semantic_merge_tpu_torch.ops.sharded`);
- ``pp``, ``sp``, ``tp``, ``ep`` — the model half's axes (pipeline,
  sequence, tensor and expert parallel), sized like the JAX package's.

JAX drives every local chip from one process and runs the collectives
inside ``shard_map``. PyTorch's idiom is one process per card: the
devices of an **engine mesh** (:class:`MergeMesh`) are the ranks of a
``torch.distributed`` process group
(:mod:`semantic_merge_tpu_torch.parallel.distributed`), laid out over
the five axes, with one subgroup per axis. A sharded program runs on
every rank at once on that rank's block of rows; :meth:`MergeMesh.
all_gather`, :meth:`~MergeMesh.psum` and :meth:`~MergeMesh.pmax` are
the JAX collectives it needs, each on one named axis. An axis of size 1
needs no group, so a one-rank mesh (``[engine] mesh_shape = "dp=1"``)
runs the sharded programs with no process group at all, as a
one-device JAX mesh runs ``shard_map``.

The model half (the sharded encoder and its training) differentiates
through its collectives: :meth:`~MergeMesh.gather`, the copy/reduce
pair :meth:`~MergeMesh.copy` and :meth:`~MergeMesh.reduce`,
:meth:`~MergeMesh.all_to_all` and :meth:`~MergeMesh.broadcast` are
autograd functions, and :meth:`~MergeMesh.ring_shift` moves the ring's
chunks (``batch_isend_irecv`` from axis position j to j + 1; the point-
to-point calls take global ranks, mapped through ``layout``).

The **batch mesh** (:class:`BatchMesh`) has no collective: the lanes of
the batched fused program are independent, so it stays in one process
(the merge service daemon) as a list of its local devices, lane block
``i`` on device ``i``.

Under gloo a collective of CUDA tensors (two ranks sharing one card)
stages through host memory: every collective of this module copies its
tensor to the host, runs there and copies the result back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

MESH_AXES = ("dp", "pp", "sp", "tp", "ep")

#: Axis name of the batch dispatch mesh: the packed merge axis of the
#: batched fused program splits over it, one lane block per device.
BATCH_AXIS = "batch"

#: The ``SEMMERGE_MESH`` postures (``[engine] mesh``; the environment,
#: read through the per-request overlay, wins over the config):
#:
#: - ``off``     — the single-device programs everywhere;
#: - ``auto``    — (default) a mesh when one is usable: a merge started
#:   on several ranks shards its decl axis over them, the batching
#:   daemon shards its packed merge axis over its cards; one rank or
#:   card, or a failed build, falls back to the single-device programs
#:   (the same bytes);
#: - ``require`` — a mesh must be used; failure raises
#:   :class:`~semantic_merge_tpu_torch.errors.MeshFault` (exit 18).
MESH_POSTURES = ("off", "auto", "require")

#: Older spellings of ``off``: still read, with a one-time note.
_LEGACY_OFF_ALIASES = ("none", "single", "0")

_warned_aliases: set = set()


def mesh_posture(configured: str | None = None) -> str:
    """The ``SEMMERGE_MESH`` posture in force: the environment (through
    the per-request overlay, so a daemon honours a client's setting)
    when set, else the ``[engine] mesh`` value ``configured``, else
    ``auto``. ``none``/``single``/``0`` read as ``off`` with a one-time
    deprecation note; unknown values read as ``auto``."""
    from ..utils import reqenv
    raw = (reqenv.get("SEMMERGE_MESH") or "").strip().lower()
    if not raw:
        raw = (configured or "auto").strip().lower()
    if raw in _LEGACY_OFF_ALIASES:
        if raw not in _warned_aliases:
            _warned_aliases.add(raw)
            from ..utils.loggingx import logger
            logger.warning(
                "SEMMERGE_MESH=%s is a deprecated alias of 'off' — use "
                "off|auto|require (see runbook 'Environment variables')", raw)
        return "off"
    return raw if raw in MESH_POSTURES else "auto"


def local_devices(device: str | torch.device | None = None) -> list:
    """The devices of this process a batch mesh may span: every CUDA
    card for a CUDA ``device`` (the default), the one CPU for ``cpu``."""
    dev = torch.device(device or "cuda")
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def batch_mesh_shards(devices: Sequence | None = None) -> int:
    """Batch-axis size for :func:`build_batch_mesh`: the largest power of
    two ≤ the device count (the merge-axis bucket ladder is power-of-two,
    so a power-of-two axis always divides the padded batch)."""
    n = len(local_devices() if devices is None else devices)
    shards = 1
    while shards * 2 <= n:
        shards *= 2
    return shards


@dataclass(frozen=True)
class BatchMesh:
    """The one-axis dispatch mesh of the batching subsystem: lane block
    ``i`` of the batched program runs on ``devices[i]``."""

    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return (BATCH_AXIS,)

    @property
    def shards(self) -> int:
        return len(self.devices)


def build_batch_mesh(devices: Sequence | None = None, *,
                     shards: int | None = None) -> BatchMesh:
    """The batch dispatch mesh: the first ``shards`` of ``devices``
    (default :func:`local_devices`; ``shards`` default
    :func:`batch_mesh_shards`) under :data:`BATCH_AXIS`. The lanes are
    independent, so no collective crosses the axis and the rows equal
    the single-device program's. Sets ``semmerge_batch_mesh_shards`` and
    records the ``batch_mesh_built`` event."""
    devices = list(local_devices() if devices is None else devices)
    if shards is None:
        shards = batch_mesh_shards(devices)
    if shards < 1 or shards > len(devices):
        raise ValueError(f"batch mesh wants {shards} of {len(devices)} devices")
    from ..obs import event as obs_event, metrics as obs_metrics
    obs_metrics.REGISTRY.gauge(
        "semmerge_batch_mesh_shards",
        "Batch-axis size of the last batch dispatch mesh built").set(shards)
    obs_event("batch_mesh_built", devices=len(devices), shards=shards)
    return BatchMesh(tuple(torch.device(d) for d in devices[:shards]))


def _wire_device(t: torch.Tensor, group) -> torch.device:
    """Where a collective of ``group`` takes ``t``: the host for a CUDA
    tensor under gloo (its CUDA support does not cover every collective
    and dtype), else ``t``'s own device."""
    import torch.distributed as dist
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return t.device


@dataclass
class MergeMesh:
    """An engine mesh: ``layout`` holds the ranks, shaped by the five
    axis sizes in :data:`MESH_AXES` order; ``rank`` is this process's,
    ``device`` the device its blocks live on, and ``groups`` the process
    subgroup of each axis of size > 1 that this rank belongs to (empty
    for a layout-only mesh built without a process group)."""

    layout: np.ndarray
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return MESH_AXES

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(MESH_AXES, self.layout.shape))

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        coords = np.argwhere(self.layout == self.rank)[0]
        return int(coords[MESH_AXES.index(axis)])

    def _group(self, axis: str):
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(f"mesh axis {axis!r} of size {self.axis_size(axis)} "
                               "has no process group (build the mesh after "
                               "init_distributed)")
        return group

    def all_gather(self, t: torch.Tensor, axis: str, *, tiled: bool = False,
                   dim: int = 0) -> torch.Tensor:
        """Every shard's ``t`` along ``axis`` in axis order: stacked on a
        new leading axis of size k, or with ``tiled`` concatenated along
        ``dim``."""
        if self.axis_size(axis) == 1:
            return t.clone() if tiled else t[None].clone()
        import torch.distributed as dist
        group = self._group(axis)
        src = t.detach().to(_wire_device(t, group)).contiguous()
        if src.dtype == torch.bool:  # gloo moves no bool: its bytes go as uint8
            src = src.view(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, src, group=group)
        ordered = [None] * len(parts)
        for g, pos in enumerate(self._group_order(axis)):
            ordered[pos] = parts[g]
        out = torch.cat(ordered, dim=dim) if tiled else torch.stack(ordered)
        return (out.view(torch.bool) if t.dtype == torch.bool else out).to(t.device)

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise sum of ``t`` over ``axis``."""
        return self._reduce(t, axis, "SUM")

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise maximum of ``t`` over ``axis``."""
        return self._reduce(t, axis, "MAX")

    def _reduce(self, t: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return t.clone()
        import torch.distributed as dist
        group = self._group(axis)
        out = t.detach().to(_wire_device(t, group), copy=True).contiguous()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
        return out.to(t.device)

    # --- the model half: differentiable collectives on a named axis ------------
    #
    # The encoder keeps every activation either replicated over an axis
    # (the same values on every rank of it) or split over it. The pair
    # copy/reduce (Megatron's f and g) marks where a replicated tensor
    # feeds a split computation and where the split partials are summed
    # back; with it, the gradient of a replicated tensor arrives whole and
    # equal on every rank of the axis. So the backward of ``gather`` is
    # this shard's slice of that gradient (the psum's slice divided by
    # k), and the backward of ``reduce`` is the identity.

    def line(self, axis: str) -> list:
        """The global ranks along ``axis`` through this rank, in axis
        order (``torch.distributed``'s point-to-point calls and ``src``
        arguments take global ranks)."""
        coords = np.argwhere(self.layout == self.rank)[0]
        ax = MESH_AXES.index(axis)
        rest = tuple(int(c) for c in np.delete(coords, ax))
        return [int(r) for r in np.moveaxis(self.layout, ax, -1)[rest]]

    def _group_order(self, axis: str) -> list:
        """Axis position of each group rank: a group ranks its members in
        the order of their global ranks."""
        line = self.line(axis)
        return [line.index(r) for r in sorted(line)]

    def _live(self, axes) -> tuple:
        return tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                     if self.axis_size(a) > 1)

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every shard's ``t`` concatenated along ``dim`` in axis order,
        differentiable: the backward is this shard's slice of the
        (replicated) gradient."""
        if self.axis_size(axis) == 1:
            return t
        return _Gather.apply(t, self, axis, dim)

    def reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum of the split partials ``t`` over ``axes`` (in f32, cast
        back), differentiable: its result is replicated, so the backward
        is the identity."""
        axes = self._live(axes)
        return _Reduce.apply(t, self, axes) if axes else t

    def copy(self, t: torch.Tensor, axes) -> torch.Tensor:
        """A replicated ``t`` entering a computation split over ``axes``:
        the identity forward, the sum of the split gradients backward."""
        axes = self._live(axes)
        return _Copy.apply(t, self, axes) if axes else t

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``t`` cut in k blocks along ``split_dim``, block j sent to axis
        position j, the blocks received concatenated along ``concat_dim``
        in axis order (JAX's tiled ``all_to_all``), differentiable: the
        backward is the inverse exchange."""
        if self.axis_size(axis) == 1:
            return t
        return _AllToAll.apply(t, self, axis, split_dim, concat_dim)

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """Axis position ``src``'s ``t`` on every rank of ``axis`` (the
        others pass a buffer of its shape), differentiable: every rank
        computes the same from it, so ``src`` keeps its own gradient."""
        if self.axis_size(axis) == 1:
            return t
        return _Broadcast.apply(t, self, axis, src)

    def ring_shift(self, tensors, axis: str) -> list:
        """``tensors`` sent from axis position j to j + 1 (mod k), the
        previous position's received, in one message: JAX's ``ppermute``
        with ``perm = [(j, (j + 1) % k)]``. Not differentiable."""
        if self.axis_size(axis) == 1:
            return list(tensors)
        return self._shift_raw(list(tensors), axis)

    def _sum_raw(self, t, axes):
        """The sum over ``axes``, taken in f32 and cast back."""
        out = t.float()
        for axis in axes:
            out = self._reduce(out, axis, "SUM")
        return out.to(t.dtype)

    def _a2a_raw(self, t, axis, split_dim, concat_dim):
        import torch.distributed as dist
        group = self._group(axis)
        order = self._group_order(axis)
        blocks = t.detach().chunk(self.axis_size(axis), dim=split_dim)
        src = torch.stack([blocks[pos] for pos in order]).to(_wire_device(t, group))
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src.contiguous(), group=group)
        got = [None] * len(order)
        for g, pos in enumerate(order):
            got[pos] = out[g]
        return torch.cat(got, dim=concat_dim).to(t.device)

    def _bcast_raw(self, t, axis, src):
        import torch.distributed as dist
        group = self._group(axis)
        out = t.detach().to(_wire_device(t, group), copy=True).contiguous()
        dist.broadcast(out, src=self.line(axis)[src], group=group)
        return out.to(t.device)

    def _shift_raw(self, tensors, axis):
        import torch.distributed as dist
        group = self._group(axis)
        line = self.line(axis)
        pos, k = line.index(self.rank), len(line)
        buf, layout = _pack(tensors, _wire_device(tensors[0], group))
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, line[(pos + 1) % k], group),
               dist.P2POp(dist.irecv, recv, line[(pos - 1) % k], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _unpack(recv.to(tensors[0].device), layout)


def _pack(tensors, device):
    """One uint8 buffer on ``device`` holding ``tensors``' bytes, each
    segment starting on a 16-byte boundary (the kernels read 16-byte
    aligned operands), and the layout to cut it back."""
    layout, segments, offset = [], [], 0
    for t in tensors:
        raw = t.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 16
        layout.append((offset, raw.numel(), t.dtype, tuple(t.shape)))
        segments.append(raw)
        if pad:
            segments.append(torch.zeros(pad, dtype=torch.uint8, device=device))
        offset += raw.numel() + pad
    return torch.cat(segments), layout


def _unpack(buf, layout) -> list:
    return [buf[off:off + n].view(dtype).view(shape) for off, n, dtype, shape in layout]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return mesh.all_gather(t, axis, tiled=True, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        pos = ctx.mesh.axis_index(ctx.axis)
        return grad.narrow(ctx.dim, pos * ctx.n, ctx.n).contiguous(), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh._sum_raw(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._sum_raw(grad, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return mesh._a2a_raw(t, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, split_dim, concat_dim = ctx.args
        return mesh._a2a_raw(grad, axis, concat_dim, split_dim), None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, src):
        ctx.mine = mesh.axis_index(axis) == src
        return mesh._bcast_raw(t, axis, src)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.mine else None), None, None, None


def _factor(n: int, weights: Sequence[int]) -> list[int]:
    """Greedily factor ``n`` devices over the axes, preferring axes with
    higher weight. Sizes multiply to exactly ``n`` (n must be 2^k)."""
    sizes = [1] * len(weights)
    remaining = n
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    while remaining > 1:
        progressed = False
        for i in order:
            if remaining <= 1:
                break
            if weights[i] > 0:
                sizes[i] *= 2
                remaining //= 2
                progressed = True
        if not progressed:
            sizes[order[0]] *= remaining
            remaining = 1
    return sizes


def parse_mesh_spec(spec: str) -> tuple:
    """Parse ``[engine] mesh_shape`` into ``(kind, dcn_axis, sizes)``.

    - ``"auto"`` / empty → ``("flat", None, {})``;
    - ``"dp=4,tp=2"`` → ``("flat", None, {...})``;
    - ``"hybrid:dcn=dp,dp=4,tp=2"`` → ``("hybrid", "dp", {...})`` — the
      ``dcn`` axis spans hosts
      (:func:`semantic_merge_tpu_torch.parallel.distributed.build_hybrid_mesh`),
      every other axis stays within one host.
    """
    spec = (spec or "").strip()
    kind = "flat"
    dcn_axis = None
    if spec.startswith("hybrid"):
        kind = "hybrid"
        _, _, spec = spec.partition(":")
        parts = []
        for part in spec.split(","):
            name, _, value = part.partition("=")
            if name.strip() == "dcn":
                dcn_axis = value.strip()
                if dcn_axis not in MESH_AXES:
                    raise ValueError(
                        f"mesh_shape dcn axis {dcn_axis!r} not one of {MESH_AXES}")
            elif part.strip():
                parts.append(part)
        spec = ",".join(parts)
        dcn_axis = dcn_axis or "dp"
    return kind, dcn_axis, parse_mesh_shape(spec)


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """Parse a ``[engine] mesh_shape`` value like ``"dp=4,tp=2"`` into
    :func:`build_mesh` axis sizes. ``"auto"`` (or empty) returns ``{}``
    — let :func:`build_mesh` infer."""
    spec = (spec or "").strip()
    if not spec or spec == "auto":
        return {}
    sizes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        name = name.strip()
        if name not in MESH_AXES:
            raise ValueError(f"mesh_shape axis {name!r} not one of {MESH_AXES}")
        try:
            sizes[name] = int(value)
        except ValueError as exc:
            raise ValueError(f"mesh_shape {part!r}: size must be an int") from exc
    return sizes


def mesh_sizes(n: int, *, dp: int | None = None, pp: int | None = None,
               sp: int | None = None, tp: int | None = None,
               ep: int | None = None) -> list[int]:
    """The five axis sizes of a mesh of ``n`` devices: given sizes are
    kept, the rest goes to ``dp`` first, then ``sp``, then ``tp`` (the
    JAX package's factorization and errors)."""
    requested = {"dp": dp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    fixed = math.prod(v for v in requested.values() if v)
    if fixed and n % fixed != 0:
        raise ValueError(f"requested axis sizes {requested} do not divide {n} devices")
    free = n // fixed if fixed else n
    auto = _factor(free, [3 if requested["dp"] is None else 0, 0,
                          2 if requested["sp"] is None else 0,
                          1 if requested["tp"] is None else 0, 0])
    sizes = [requested[name] if requested[name] else auto[i]
             for i, name in enumerate(MESH_AXES)]
    if math.prod(sizes) != n:
        # Every axis given but their product < n: the remainder has no
        # auto slot to land in.
        raise ValueError(f"axis sizes {dict(zip(MESH_AXES, sizes))} use "
                         f"{math.prod(sizes)} of {n} devices")
    return sizes


def build_mesh(devices: Sequence[int] | None = None, *, dp: int | None = None,
               pp: int | None = None, sp: int | None = None, tp: int | None = None,
               ep: int | None = None, device: str | torch.device | None = None) -> MergeMesh:
    """A five-axis engine mesh over ``devices``, the ranks of the process
    group (default: every rank; one rank without a process group).

    Axis sizes as :func:`mesh_sizes` gives them. With a process group
    every rank must call this together: it makes the subgroup of each
    axis of size > 1 (``torch.distributed.new_group`` is collective).
    ``device`` is where this rank's blocks live (default
    :func:`~semantic_merge_tpu_torch.parallel.distributed.rank_device`).
    Sets ``semmerge_mesh_axis_size{axis}`` and ``semmerge_mesh_devices``
    and records the ``mesh_built`` event."""
    from .distributed import world
    if devices is None:
        devices = list(range(world()[1]))
    devices = [int(d) for d in devices]
    n = len(devices)
    sizes = mesh_sizes(n, dp=dp, pp=pp, sp=sp, tp=tp, ep=ep)
    return _finish_mesh(np.asarray(devices, dtype=np.int64).reshape(sizes), device)


def _finish_mesh(layout: np.ndarray, device=None) -> MergeMesh:
    """A :class:`MergeMesh` over ``layout`` with its axis subgroups (when
    a process group covers it), its gauges and its event."""
    from .distributed import rank_device, world
    rank, size = world()
    groups: Dict[str, object] = {}
    if size > 1 and layout.size == size:
        import torch.distributed as dist
        for ax, name in enumerate(MESH_AXES):
            k = layout.shape[ax]
            if k == 1:
                continue
            if k == size:
                groups[name] = dist.group.WORLD
                continue
            # One subgroup per line of the layout along this axis, made
            # in the same order on every rank.
            lines = np.moveaxis(layout, ax, -1).reshape(-1, k)
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = group
    axis_sizes = dict(zip(MESH_AXES, layout.shape))
    from ..obs import event as obs_event, metrics as obs_metrics
    gauge = obs_metrics.REGISTRY.gauge(
        "semmerge_mesh_axis_size", "Device-mesh axis sizes of the last "
        "mesh built (shard counts per parallelism axis)")
    for name, k in axis_sizes.items():
        gauge.set(int(k), axis=name)
    obs_metrics.REGISTRY.gauge("semmerge_mesh_devices",
                               "Devices in the last mesh built").set(int(layout.size))
    obs_event("mesh_built", devices=int(layout.size),
              **{k: int(v) for k, v in axis_sizes.items()})
    dev = torch.device(device) if device is not None else rank_device()
    return MergeMesh(layout=layout, rank=rank if layout.size == size else int(layout.flat[0]),
                     device=dev, groups=groups)


__all__ = ["BATCH_AXIS", "MESH_AXES", "MESH_POSTURES", "BatchMesh", "MergeMesh",
           "batch_mesh_shards", "build_batch_mesh", "build_mesh", "local_devices",
           "mesh_posture", "mesh_sizes", "parse_mesh_shape", "parse_mesh_spec"]
