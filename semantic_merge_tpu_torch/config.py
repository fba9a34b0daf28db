"""``.semmerge.toml``: the ``[engine]`` keys the semantic diff reads.

The same file and search rule as the JAX package's ``config.py``
(``.semmerge.toml`` in the start directory or any parent); the port
reads only the keys its ``semdiff`` honours and ignores the rest:

    [engine]
    change_signature = false       # detect changeSignature ops
    signature_matcher = false      # pair renamed+retyped decls by embeddings
    signature_threshold = 0.85     # cosine acceptance threshold
    matcher_ckpt_dir = "DIR"       # matcher checkpoint (save_matcher_checkpoint)
"""
from __future__ import annotations

import pathlib
import tomllib
from dataclasses import dataclass


@dataclass
class EngineConfig:
    change_signature: bool = False
    signature_matcher: bool = False
    signature_threshold: float = 0.85
    matcher_ckpt_dir: str | None = None


def find_config_file(start: pathlib.Path) -> pathlib.Path | None:
    """Search ``start`` and its parents for ``.semmerge.toml``."""
    for directory in [start, *start.parents]:
        candidate = directory / ".semmerge.toml"
        if candidate.is_file():
            return candidate
    return None


def load_engine_config(start: pathlib.Path | None = None) -> EngineConfig:
    start = pathlib.Path(start) if start is not None else pathlib.Path.cwd()
    cfg_path = find_config_file(start)
    config = EngineConfig()
    if cfg_path is None:
        return config
    with cfg_path.open("rb") as fh:
        engine = tomllib.load(fh).get("engine", {})
    return EngineConfig(
        change_signature=bool(engine.get("change_signature", config.change_signature)),
        signature_matcher=bool(engine.get("signature_matcher", config.signature_matcher)),
        signature_threshold=float(
            engine.get("signature_threshold", config.signature_threshold)),
        matcher_ckpt_dir=(str(engine["matcher_ckpt_dir"])
                          if engine.get("matcher_ckpt_dir") else None),
    )
