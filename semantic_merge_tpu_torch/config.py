"""``.semmerge.toml``: the keys the port's ``semdiff`` and ``semmerge`` read.

The same file and search rule as the JAX package's ``config.py``
(``.semmerge.toml`` in the start directory or any parent), with the same
defaults; the port reads only the keys its commands honour and ignores
the rest:

    [core]
    deterministic_seed = "auto"    # "auto" => derived from the base rev

    [engine]
    change_signature = false       # detect changeSignature ops
    signature_matcher = false      # pair renamed+retyped decls by embeddings
    signature_threshold = 0.85     # cosine acceptance threshold
    matcher_ckpt_dir = "DIR"       # matcher checkpoint (save_matcher_checkpoint)
    text_fallback = true           # 3-way text merge for files the
                                   # TypeScript pipeline does not index
    formatter_scope = "tree"       # "tree" | "touched"
    host_workers = 0               # fused path's host-tail worker threads
                                   # (0 = auto; SEMMERGE_HOST_WORKERS wins)

    [languages.typescript]
    formatter_cmd = ["npx", "prettier", "--write"]

    [ci]
    require_typecheck = true
"""
from __future__ import annotations

import pathlib
import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class CoreConfig:
    deterministic_seed: str = "auto"


@dataclass
class EngineConfig:
    change_signature: bool = False
    signature_matcher: bool = False
    signature_threshold: float = 0.85
    matcher_ckpt_dir: str | None = None
    text_fallback: bool = True
    formatter_scope: str = "tree"
    host_workers: int = 0


@dataclass
class LanguageConfig:
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
    config.core = CoreConfig(deterministic_seed=str(
        core.get("deterministic_seed", config.core.deterministic_seed)))
    config.engine = EngineConfig(
        change_signature=bool(engine.get("change_signature", defaults.change_signature)),
        signature_matcher=bool(engine.get("signature_matcher", defaults.signature_matcher)),
        signature_threshold=float(
            engine.get("signature_threshold", defaults.signature_threshold)),
        matcher_ckpt_dir=(str(engine["matcher_ckpt_dir"])
                          if engine.get("matcher_ckpt_dir") else None),
        text_fallback=bool(engine.get("text_fallback", defaults.text_fallback)),
        formatter_scope=_validated(
            str(engine.get("formatter_scope", defaults.formatter_scope)),
            "engine.formatter_scope", ("tree", "touched")),
        host_workers=int(engine.get("host_workers", defaults.host_workers)),
    )
    for lang, ldata in data.get("languages", {}).items():
        config.languages[lang] = LanguageConfig(formatter_cmd=[
            str(c) for c in _as_list(ldata.get("formatter_cmd", []))] or None)
    config.ci = CiConfig(require_typecheck=bool(
        ci.get("require_typecheck", config.ci.require_typecheck)))
    return config


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
