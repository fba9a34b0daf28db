"""Device telemetry — the card-facing third of
:mod:`semantic_merge_tpu_torch.obs`, the JAX package's ``obs/device.py``
rewritten on torch.

Captures, per run: the device the merge ran on (:func:`note_device`,
called by the backend), host↔device transfer bytes and counts
(:func:`record_transfer`, at the fused engine's and the renderer's own
copies, where the JAX program moves its buffers), the card's allocated
bytes and their high-water mark (``torch.cuda.memory_allocated`` /
``max_memory_allocated``), and the port's own builds
(:func:`record_build`: ``nvcc`` for ``kernels/*.cu``, ``g++`` for the
native scanner; a hit reuses a built library, a miss runs the build).
Everything lands in the shared metrics registry, and :func:`snapshot`
summarizes it for the ``.semmerge-trace.json`` artifact.

:func:`snapshot` keeps every key of the JAX block
(``scripts/check_trace_schema.py`` requires them): ``jax_imported`` is
``False``, which is true of the port; ``platform`` is ``"gpu"`` on the
card and ``"cpu"`` under ``--device cpu`` (``None`` before a backend
chose a device); ``compile_cache_events`` and ``compile_seconds`` read
the build metrics, ``semmerge_kernel_build_events_total{event,kernel}``
and ``semmerge_kernel_build_seconds_total{kernel}`` — the one naming
difference from the JAX registry, whose compile metrics say ``jax``.
Nothing here initializes CUDA on its own: device queries run only after
a backend noted a CUDA device.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import metrics

_TRANSFER_BYTES = "semmerge_device_transfer_bytes_total"
_TRANSFER_COUNT = "semmerge_device_transfers_total"
_LIVE_BYTES_HWM = "semmerge_device_live_buffer_bytes_hwm"
BUILD_EVENTS = "semmerge_kernel_build_events_total"
BUILD_SECONDS = "semmerge_kernel_build_seconds_total"

#: The device of the last backend constructed (a ``torch.device``).
_device = None


def note_device(device) -> None:
    """Remember the device this process merges on (the backend's
    constructor calls it with its resolved ``torch.device``)."""
    global _device
    _device = device


def record_transfer(direction: str, nbytes: int, count: int = 1) -> None:
    """Account one host↔device transfer. ``direction`` is ``"h2d"`` or
    ``"d2h"``; call sites are the port's own copies, so the numbers
    measure the merge pipeline (on the CPU the same copies are counted,
    as the JAX package counts its CPU device's)."""
    metrics.REGISTRY.counter(
        _TRANSFER_BYTES, "Bytes moved between host and device by the "
        "merge pipeline").inc(float(nbytes), direction=direction)
    metrics.REGISTRY.counter(
        _TRANSFER_COUNT, "Host<->device transfer operations"
    ).inc(float(count), direction=direction)


def record_build(kernel: str, built: bool, seconds: float = 0.0) -> None:
    """Account one build lookup of ``kernel``: a miss ran the compiler
    for ``seconds``, a hit reused the library on disk."""
    metrics.REGISTRY.counter(
        BUILD_EVENTS, "Kernel and native-library build lookups: hit reuses a "
        "built library, miss runs the compiler").inc(
            1.0, event="miss" if built else "hit", kernel=kernel)
    if built:
        metrics.REGISTRY.counter(
            BUILD_SECONDS, "Cumulative compiler seconds of kernel and "
            "native-library builds").inc(float(seconds), kernel=kernel)


def _on_card() -> bool:
    return _device is not None and getattr(_device, "type", None) == "cuda"


def update_live_buffer_hwm() -> Optional[int]:
    """Refresh the card's allocated-bytes high-water mark from the
    caching allocator; returns the bytes allocated now, or ``None`` when
    the merge does not run on a CUDA device."""
    if not _on_card():
        return None
    import torch
    try:
        live = int(torch.cuda.memory_allocated(_device))
        peak = int(torch.cuda.max_memory_allocated(_device))
    except Exception:
        return None
    metrics.REGISTRY.gauge(
        _LIVE_BYTES_HWM, "High-water mark of live device buffer bytes"
    ).max(float(peak))
    return live


def _counter_by_label(name: str, label: str) -> Dict[str, float]:
    metric = metrics.REGISTRY.counter(name)
    out: Dict[str, float] = {}
    for key, value in metric._labelled():
        k = dict(key).get(label, "?")
        out[k] = out.get(k, 0.0) + float(value)
    return out


def snapshot() -> dict:
    """One JSON-able record of device state for the trace artifact;
    every key always present."""
    out = {
        "jax_imported": False,
        "platform": None,
        "device_count": 0,
        "device_kinds": [],
        "process_index": 0,
        "process_count": 1,
        "live_buffer_bytes": None,
        "live_buffer_bytes_hwm": metrics.REGISTRY.gauge(_LIVE_BYTES_HWM).value(),
        "transfer_bytes": _counter_by_label(_TRANSFER_BYTES, "direction"),
        "transfer_count": _counter_by_label(_TRANSFER_COUNT, "direction"),
        "compile_cache_events": _counter_by_label(BUILD_EVENTS, "event"),
        "compile_seconds": _counter_by_label(BUILD_SECONDS, "kernel"),
    }
    if _device is None:
        return out
    if not _on_card():
        out.update(platform="cpu", device_count=1, device_kinds=["cpu"])
        return out
    import torch
    try:
        count = torch.cuda.device_count()
        out.update(platform="gpu", device_count=count,
                   device_kinds=sorted({torch.cuda.get_device_name(i)
                                        for i in range(count)}))
    except Exception:
        # A half-initialized runtime must not take the artifact down.
        out["platform"] = "gpu"
    out["live_buffer_bytes"] = update_live_buffer_hwm()
    out["live_buffer_bytes_hwm"] = metrics.REGISTRY.gauge(_LIVE_BYTES_HWM).value()
    return out
