"""``.semmerge.toml``: the keys the port's ``semdiff`` and ``semmerge`` read.

The same file and search rule as the JAX package's ``config.py``
(``.semmerge.toml`` in the start directory or any parent), with the same
defaults. The port reads these keys and honours them as the JAX package
does:

    [core]
    deterministic_seed = "auto"    # "auto" => derived from the base rev
    memory_cap_mb = 4096           # half of it bounds the decl cache

    [engine]
    change_signature = false       # detect changeSignature ops
    signature_matcher = false      # pair renamed+retyped decls by embeddings
    signature_threshold = 0.85     # cosine acceptance threshold
    matcher_ckpt_dir = "DIR"       # matcher checkpoint (save_matcher_checkpoint)
    conflict_mode = "parity"       # "parity" | "strict" (all [CFR-002]
                                   # categories; implies statement_ops)
    statement_ops = false          # editStmtBlock / extract / inline ops
    structured_apply = false       # ops carry decl text and spans
    text_fallback = true           # 3-way text merge for files the
                                   # TypeScript pipeline does not index
    formatter_scope = "tree"       # "tree" | "touched"
    host_workers = 0               # fused path's host-tail worker threads
                                   # (0 = auto)

    [languages.typescript]
    formatter_cmd = ["npx", "prettier", "--write"]

    [ci]
    require_typecheck = true

    [slo]                          # the merge service's objectives
    objectives = "merge:p99<800ms,err<1%"
    fast_window_s = 300.0
    slow_window_s = 3600.0

    [engine]
    backend = "tpu"                # the engine, as the JAX package names it
    worker_cmd = ["prog", "arg"]   # the subprocess backend's worker
    incremental = true             # scope the scan to changed files
                                   # (every engine; cli.py::_snapshots)

    [languages.java]               # also [languages.csharp] / [languages.cs]
    enabled = true                 # route .java (.cs) files to that engine

``[engine] backend`` (or ``--backend``) names the engine as in the JAX
package (:func:`resolve_backend`, the names of
``backends/base.py::get_backend``); a name it does not know runs as
``host``. ``[engine] mesh`` (the posture, under ``SEMMERGE_MESH``) and
``mesh_shape`` pick the engine mesh as in the JAX package
(``backends/ts_torch.py::TorchTSBackend.configure``). Every other key
leaves the output unchanged; ``cli.py``'s docstring says why for each.
"""
from __future__ import annotations

import pathlib
import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List

from .utils.loggingx import logger


@dataclass
class CoreConfig:
    deterministic_seed: str = "auto"
    memory_cap_mb: int = 4096


@dataclass
class EngineConfig:
    backend: str = "tpu"
    change_signature: bool = False
    signature_matcher: bool = False
    signature_threshold: float = 0.85
    matcher_ckpt_dir: str | None = None
    conflict_mode: str = "parity"
    statement_ops: bool = False
    structured_apply: bool = False
    text_fallback: bool = True
    formatter_scope: str = "tree"
    host_workers: int = 0
    mesh: str = "auto"
    mesh_shape: str = "auto"
    worker_cmd: List[str] | None = None
    incremental: bool = True


@dataclass
class LanguageConfig:
    enabled: bool = False
    formatter_cmd: List[str] | None = None


@dataclass
class CiConfig:
    require_typecheck: bool = True


@dataclass
class SloConfig:
    """``[slo]``: the merge service's objectives, in the grammar of
    ``SEMMERGE_SLO`` (which overrides it), e.g. ``"merge:p99<800ms,err<1%;
    diff:p99<200ms"``; a TOML list of objective strings is joined with
    ``;``."""

    objectives: str | None = None
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0


@dataclass
class Config:
    core: CoreConfig = field(default_factory=CoreConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    languages: Dict[str, LanguageConfig] = field(default_factory=dict)
    ci: CiConfig = field(default_factory=CiConfig)
    slo: SloConfig = field(default_factory=SloConfig)


def find_config_file(start: pathlib.Path) -> pathlib.Path | None:
    """Search ``start`` and its parents for ``.semmerge.toml``."""
    for directory in [start, *start.parents]:
        candidate = directory / ".semmerge.toml"
        if candidate.is_file():
            return candidate
    return None


def load_config(start: pathlib.Path | None = None) -> Config:
    # The scoped request root inside a merge service request, the
    # process's working directory otherwise (utils/workdir).
    from .utils import workdir
    start = pathlib.Path(start) if start is not None else workdir.root()
    cfg_path = find_config_file(start)
    config = Config()
    if cfg_path is None:
        return config
    with cfg_path.open("rb") as fh:
        data = tomllib.load(fh)
    core, engine, ci = data.get("core", {}), data.get("engine", {}), data.get("ci", {})
    defaults = config.engine
    config.core = CoreConfig(
        deterministic_seed=str(core.get("deterministic_seed", config.core.deterministic_seed)),
        memory_cap_mb=int(core.get("memory_cap_mb", config.core.memory_cap_mb)))
    config.engine = EngineConfig(
        backend=str(engine.get("backend", defaults.backend)),
        change_signature=bool(engine.get("change_signature", defaults.change_signature)),
        signature_matcher=bool(engine.get("signature_matcher", defaults.signature_matcher)),
        signature_threshold=float(
            engine.get("signature_threshold", defaults.signature_threshold)),
        matcher_ckpt_dir=(str(engine["matcher_ckpt_dir"])
                          if engine.get("matcher_ckpt_dir") else None),
        conflict_mode=_validated(
            str(engine.get("conflict_mode", defaults.conflict_mode)),
            "engine.conflict_mode", ("parity", "strict")),
        statement_ops=bool(engine.get("statement_ops", defaults.statement_ops)),
        structured_apply=bool(engine.get("structured_apply", defaults.structured_apply)),
        text_fallback=bool(engine.get("text_fallback", defaults.text_fallback)),
        formatter_scope=_validated(
            str(engine.get("formatter_scope", defaults.formatter_scope)),
            "engine.formatter_scope", ("tree", "touched")),
        host_workers=int(engine.get("host_workers", defaults.host_workers)),
        mesh=_validated(str(engine.get("mesh", defaults.mesh)).strip().lower(),
                        "engine.mesh", ("off", "auto", "require")),
        mesh_shape=str(engine.get("mesh_shape", defaults.mesh_shape)),
        worker_cmd=[str(c) for c in _as_list(engine.get("worker_cmd", []))] or None,
        incremental=bool(engine.get("incremental", defaults.incremental)),
    )
    for lang, ldata in data.get("languages", {}).items():
        config.languages[lang] = LanguageConfig(
            enabled=bool(ldata.get("enabled", False)),
            formatter_cmd=[str(c) for c in _as_list(ldata.get("formatter_cmd", []))] or None)
    config.ci = CiConfig(require_typecheck=bool(
        ci.get("require_typecheck", config.ci.require_typecheck)))
    slo = data.get("slo", {})
    objectives = slo.get("objectives")
    if isinstance(objectives, (list, tuple)):
        objectives = ";".join(str(o) for o in objectives if o)
    config.slo = SloConfig(
        objectives=str(objectives) if objectives else None,
        fast_window_s=float(slo.get("fast_window_s", config.slo.fast_window_s)),
        slow_window_s=float(slo.get("slow_window_s", config.slo.slow_window_s)))
    return config


def resolve_backend(config: Config, flag: str | None = None) -> str:
    """The engine name in force, as the JAX CLI's ``_resolve_backend``
    picks it: ``--backend`` (``flag``) over ``[engine] backend``. A name
    :func:`~semantic_merge_tpu_torch.backends.base.get_backend` knows
    comes back as it is; any other logs the JAX CLI's warning and comes
    back as ``host``, its fallback."""
    from .backends.base import known_backend
    name = flag or config.engine.backend
    if known_backend(name):
        return name
    logger.warning("Backend %r unavailable (%s); falling back to host", name,
                   f"unknown backend {name!r}")
    return "host"


def load_engine_config(start: pathlib.Path | None = None) -> EngineConfig:
    return load_config(start).engine


def _validated(value: str, key: str, allowed: tuple) -> str:
    if value not in allowed:
        raise ValueError(f"{key} must be one of {allowed}, got {value!r}")
    return value


def _as_list(value: Any) -> List[Any]:
    if isinstance(value, (list, tuple)):
        return [v for v in value if v is not None]
    return [value] if value else []
