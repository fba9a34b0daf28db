"""The backend seam: the op-log records, the name registry and the merge
through a backend — the port's copy of the JAX package's
``backends/base.py``.

A backend implements ``build_and_diff`` / ``diff`` / ``compose`` over
snapshots (reference worker protocol ``workers/ts/src/protocol.ts:15-27``:
``(base, left, right snapshots) → {opLogLeft, opLogRight, symbolMaps,
diagnostics}``) and is selected by name, ``--backend`` or ``[engine]
backend`` (:func:`get_backend`). Every backend of the port diffs and
composes on its device: there is no host compose here (the JAX package's
``host_compose``), because each backend's ``compose`` is the device
compose (:func:`~semantic_merge_tpu_torch.ops.compose.compose_oplogs_device`),
which the JAX package itself holds to its host compose.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from ..core.ops import Op
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans


@dataclass
class BuildAndDiffResult:
    """Both sides' op logs of a three-way merge (reference worker
    protocol ``workers/ts/src/protocol.ts:15-27``)."""

    op_log_left: List[Op]
    op_log_right: List[Op]
    symbol_maps: Dict[str, List[dict]]
    diagnostics: List[object] = field(default_factory=list)


def symbol_map(nodes) -> List[dict]:
    """SymbolMaps payload entry (reference ``workers/ts/src/index.ts:30-35``)."""
    return [{"symbolId": n.symbolId, "addressId": n.addressId} for n in nodes]


def run_merge(backend, base, left, right, *, base_rev: str = "base", seed: str = "0",
              timestamp: str | None = None, change_signature: bool = False,
              structured_apply: bool = False, signature_matcher=None,
              statement_ops: bool = False):
    """A three-way merge through ``backend``: its ``merge`` when it has
    one (the port's TypeScript engine, fused), else ``build_and_diff``
    then ``compose``, each in its span (layer ``backend``). Counts the
    merge in ``semmerge_merges_total{backend}``, ``semmerge_ops_total
    {side}`` and ``semmerge_conflicts_total``. Returns
    ``(BuildAndDiffResult, composed ops, conflicts)``."""
    name = getattr(backend, "name", "?")
    kw = dict(base_rev=base_rev, seed=seed, timestamp=timestamp,
              change_signature=change_signature, structured_apply=structured_apply,
              signature_matcher=signature_matcher, statement_ops=statement_ops)
    merge = getattr(backend, "merge", None)
    if merge is not None:
        result, composed, conflicts = merge(base, left, right, **kw)
    else:
        with obs_spans.span("build_and_diff", layer="backend", backend=name):
            result = backend.build_and_diff(base, left, right, **kw)
        with obs_spans.span("compose", layer="backend", backend=name):
            composed, conflicts = backend.compose(result.op_log_left, result.op_log_right)
    reg = obs_metrics.REGISTRY
    reg.counter("semmerge_merges_total",
                "Three-way merges run, by backend").inc(1, backend=name)
    reg.counter("semmerge_ops_total", "Ops emitted by diff, by side").inc(
        len(result.op_log_left), side="left")
    reg.counter("semmerge_ops_total").inc(len(result.op_log_right), side="right")
    conflict_list = conflicts if isinstance(conflicts, list) else list(conflicts)
    reg.counter("semmerge_conflicts_total", "Merge conflicts surfaced").inc(
        len(conflict_list))
    return result, composed, conflict_list


#: Names → factories. Each factory takes ``device`` (``None``/``"cuda"``
#: or ``"cpu"``) and ``host_workers`` keywords.
_REGISTRY: Dict[str, Callable[..., object]] = {}


def register_backend(name: str, factory: Callable[..., object]) -> None:
    _REGISTRY[name] = factory


#: The built-in engine names (the JAX package's) → the module of the
#: port that registers them, imported on first use.
BUILTIN_BACKENDS: Dict[str, str] = {
    "tpu": "ts_torch", "ts_tpu": "ts_torch", "host": "ts_torch", "ts_host": "ts_torch",
    "java": "java", "cs": "cs", "csharp": "cs", "subprocess": "subproc", "worker": "subproc",
}


def known_backend(name: str) -> bool:
    """Is ``name`` a built-in or registered backend?"""
    return name in BUILTIN_BACKENDS or name in _REGISTRY


def get_backend(name: str, *, device: str | None = None, host_workers: int | None = None):
    """A new backend of the engine ``name`` (the JAX package's names) on
    ``device``: ``tpu``, ``ts_tpu``, ``host`` and ``ts_host`` are the
    port's TypeScript engine (``host`` is not the CPU), ``java``, ``cs``
    and ``csharp`` the C-family engines, ``subprocess`` and ``worker``
    the out-of-process worker seam. Raises ``KeyError`` for any other
    name."""
    if name not in _REGISTRY and name in BUILTIN_BACKENDS:
        importlib.import_module(f"{__package__}.{BUILTIN_BACKENDS[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"Unknown backend {name!r}; known: "
                       f"{sorted(set(BUILTIN_BACKENDS) | set(_REGISTRY))}")
    return _REGISTRY[name](device=device, host_workers=host_workers)
