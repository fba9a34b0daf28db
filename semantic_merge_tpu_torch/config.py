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

It also reads three keys only to refuse values it does not implement
(:func:`refused_settings`): ``[engine] backend``, ``[engine] mesh`` and
``[languages.<name>] enabled``, and refuses the environment postures
of :func:`refused_environment`. Every other key leaves the output
unchanged; ``cli.py``'s docstring says why for each.
"""
from __future__ import annotations

import os
import pathlib
import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List


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


@dataclass
class LanguageConfig:
    enabled: bool = False
    formatter_cmd: List[str] | None = None


@dataclass
class CiConfig:
    require_typecheck: bool = True


@dataclass
class Config:
    core: CoreConfig = field(default_factory=CoreConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    languages: Dict[str, LanguageConfig] = field(default_factory=dict)
    ci: CiConfig = field(default_factory=CiConfig)


def find_config_file(start: pathlib.Path) -> pathlib.Path | None:
    """Search ``start`` and its parents for ``.semmerge.toml``."""
    for directory in [start, *start.parents]:
        candidate = directory / ".semmerge.toml"
        if candidate.is_file():
            return candidate
    return None


def load_config(start: pathlib.Path | None = None) -> Config:
    start = pathlib.Path(start) if start is not None else pathlib.Path.cwd()
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
    )
    for lang, ldata in data.get("languages", {}).items():
        config.languages[lang] = LanguageConfig(
            enabled=bool(ldata.get("enabled", False)),
            formatter_cmd=[str(c) for c in _as_list(ldata.get("formatter_cmd", []))] or None)
    config.ci = CiConfig(require_typecheck=bool(
        ci.get("require_typecheck", config.ci.require_typecheck)))
    return config


#: The JAX package's language backends other than TypeScript
#: (``backends/multi.py::LANGUAGE_BACKENDS``): enabling one routes its
#: files through another merge engine, which the port does not have.
OTHER_LANGUAGES = ("cs", "csharp", "java")
#: ``[engine] backend`` values whose output the port reproduces.
PORTED_BACKENDS = ("tpu", "ts_tpu", "host", "ts_host")


def refused_settings(config: Config, command: str) -> List[str]:
    """The settings in ``config`` and the environment that would change
    the JAX package's op logs, tree, conflicts artifact or exit code and
    that the port does not implement, each as ``"name = value"``. The
    CLI refuses to run when this is not empty."""
    refused = [f"[languages.{lang}] enabled = true"
               for lang in OTHER_LANGUAGES
               if lang in config.languages and config.languages[lang].enabled]
    if config.engine.backend not in PORTED_BACKENDS:
        refused.append(f"[engine] backend = {config.engine.backend!r}")
    mesh_env = (os.environ.get("SEMMERGE_MESH") or "").strip().lower()
    if mesh_env == "require":
        refused.append("SEMMERGE_MESH=require")
    elif not mesh_env and config.engine.mesh == "require":
        refused.append('[engine] mesh = "require"')
    return refused + refused_environment(command)


def refused_environment(command: str) -> List[str]:
    """The environment postures the port cannot honour for ``command``
    (``semdiff``, ``semmerge`` or ``semrebase``): ``SEMMERGE_DAEMON=require``
    (there is no merge service daemon; ``off`` and ``auto`` run
    one-shot) and, for ``semmerge``, ``SEMMERGE_BATCH=require``."""
    refused = []
    if (os.environ.get("SEMMERGE_DAEMON") or "").strip().lower() == "require":
        refused.append("SEMMERGE_DAEMON=require")
    if command == "semmerge" and \
            (os.environ.get("SEMMERGE_BATCH") or "").strip().lower() == "require":
        refused.append("SEMMERGE_BATCH=require")
    return refused


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
