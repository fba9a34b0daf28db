"""Per-language routing: one merge, several language backends — the
port's copy of the JAX package's ``backends/multi.py``.

A :class:`MultiBackend` fans the snapshots out to every routed backend
(each filters to its own extensions), concatenates the per-language op
logs, symbol maps and diagnostics in backend order, and composes the
combined log once, by the primary on its device, so one ``semmerge`` merges every enabled language
semantically and the text layer covers only the files no backend
indexes (:attr:`MultiBackend.extensions`, the union).

Selected by the CLI when ``.semmerge.toml`` enables languages beyond
TypeScript (``[languages.java] enabled = true``); ``--backend`` /
``[engine] backend`` still picks the primary. No ``merge`` method: a
routed merge is ``build_and_diff`` then ``compose``
(``backends/base.py::run_merge``), with the JAX spans, and the TS half
runs the two-program path, never the fused engine.
"""
from __future__ import annotations

from typing import Dict, List

from ..core.ops import Op
from .base import BuildAndDiffResult

#: ``[languages.<name>]`` config key → registered backend name.
LANGUAGE_BACKENDS: Dict[str, str] = {
    "java": "java",
    "csharp": "cs",
    "cs": "cs",
}


class MultiBackend:
    """``phases`` holds the last call's seconds per phase: the primary's
    under their own names, every other backend's as ``<name>.<phase>``
    (``java.scan``, ``cs.device_diff``, ...)."""

    name = "multi"

    def __init__(self, backends: List) -> None:
        assert backends, "MultiBackend needs at least one backend"
        self.backends = backends
        self.extensions = frozenset().union(*(b.extensions for b in backends))
        #: The primary's device: the matcher and the resolution tier run there.
        self.device = backends[0].device
        #: The device-batched CRDT apply stays on when any routed
        #: backend provides it (the TypeScript engine does).
        self.device_crdt = any(getattr(b, "device_crdt", False) for b in backends)
        self.phases: Dict[str, float | int | str] = {}

    def _collect_phases(self) -> None:
        self.phases.clear()
        for i, b in enumerate(self.backends):
            for key, value in b.phases.items():
                self.phases[key if i == 0 else f"{b.name}.{key}"] = value

    def build_and_diff(self, base, left, right, **kwargs) -> BuildAndDiffResult:
        results = [b.build_and_diff(base, left, right, **kwargs) for b in self.backends]
        self._collect_phases()
        merged = BuildAndDiffResult(op_log_left=[], op_log_right=[],
                                    symbol_maps={"base": [], "left": [], "right": []})
        for r in results:
            merged.op_log_left.extend(r.op_log_left)
            merged.op_log_right.extend(r.op_log_right)
            for k in merged.symbol_maps:
                merged.symbol_maps[k].extend(r.symbol_maps.get(k, []))
            merged.diagnostics.extend(r.diagnostics)
        return merged

    def diff(self, base, right, **kwargs) -> List[Op]:
        ops: List[Op] = []
        for b in self.backends:
            ops.extend(b.diff(base, right, **kwargs))
        self._collect_phases()
        return ops

    def compose(self, delta_a: List[Op], delta_b: List[Op]):
        """One composition over the combined multi-language log, by the
        primary (every backend of the port composes; the JAX package's
        takes the first that does): chain state and conflict detection
        see every op, as a single backend's would (symbol ids are
        signature hashes, so languages interleave without a namespace)."""
        return self.backends[0].compose(delta_a, delta_b)

    def configure(self, config) -> None:
        for b in self.backends:
            configure = getattr(b, "configure", None)
            if configure is not None:
                configure(config)

    def close(self) -> None:
        for b in self.backends:
            b.close()


def route_backends(primary, config, *, device: str | None = None) -> "MultiBackend | None":
    """The multi-language route from ``config``: the primary backend
    (the TypeScript engine choice) then one backend per additionally
    enabled language, in sorted config-key order with ``csharp``/``cs``
    deduplicated, each on ``device``. ``None`` when no extra language is
    enabled (the single-backend path)."""
    from .base import get_backend

    extra: List[str] = []
    for lang, lcfg in sorted(config.languages.items()):
        backend_name = LANGUAGE_BACKENDS.get(lang)
        if backend_name and getattr(lcfg, "enabled", False) and backend_name not in extra:
            extra.append(backend_name)
    if not extra:
        return None
    return MultiBackend([primary, *[get_backend(n, device=device) for n in extra]])
