"""Command line of the port: the semantic diff.

    python -m semantic_merge_tpu_torch semdiff REV1 REV2 [--json-out]
        [--change-signature] [--signature-matcher] [--device cuda|cpu]

Prints the op log between two revisions of the git repository in the
working directory, exactly as the JAX package's ``semdiff`` does: one
pretty line per op, or with ``--json-out`` the op records as indented
JSON. ``.semmerge.toml``'s ``[engine]`` keys ``change_signature``,
``signature_matcher``, ``signature_threshold`` and ``matcher_ckpt_dir``
apply as they do there. The diff runs on the CUDA card; ``--device cpu``
runs it on the CPU instead. Without a card and without that flag the
command exits with status 2 and says why.

The JAX CLI's incremental scope (diffing only the files that changed)
is collision-safe by construction, so the full-tree diff here gives the
same op log. There is no fallback to another backend: a failure exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .backends.ts_torch import TorchTSBackend
from .config import load_engine_config
from .core.ops import Op
from .device import DeviceUnavailable
from .runtime.git import (archive_bytes, commit_timestamp_iso, resolve_rev,
                          snapshot_from_bytes)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m semantic_merge_tpu_torch",
        description="Semantic merge engine on an NVIDIA GPU (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)
    p_diff = sub.add_parser("semdiff", help="Semantic diff: print op log between two revisions")
    p_diff.add_argument("rev1")
    p_diff.add_argument("rev2")
    p_diff.add_argument("--json-out", action="store_true",
                        help="Emit JSON instead of a pretty listing")
    p_diff.add_argument("--change-signature", action="store_true",
                        help="Detect changeSignature ops instead of delete+add "
                             "(also [engine].change_signature in .semmerge.toml)")
    p_diff.add_argument("--signature-matcher", action="store_true",
                        help="Pair renamed+retyped decls by embedding "
                             "similarity (also [engine].signature_matcher)")
    p_diff.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="Where to run (default: cuda; cpu only when asked)")
    return parser


@dataclass
class SemdiffResult:
    ops: List[Op]
    #: The embedding matcher the diff used, or None.
    matcher: object | None
    #: Seconds per phase: snapshot, then the backend's phases.
    phases: Dict[str, float] = field(default_factory=dict)


def semdiff(args: argparse.Namespace) -> SemdiffResult:
    """Run ``semdiff`` for parsed ``args`` in the working directory."""
    config = load_engine_config()
    backend = TorchTSBackend(device=args.device)
    change_sig = args.change_signature or config.change_signature
    matcher = None
    if change_sig and (args.signature_matcher or config.signature_matcher):
        from .models.signature import EmbeddingSignatureMatcher
        matcher = EmbeddingSignatureMatcher(threshold=config.signature_threshold,
                                            ckpt_dir=config.matcher_ckpt_dir,
                                            device=backend.device)
    t0 = time.perf_counter()
    base_snap = snapshot_from_bytes(archive_bytes(args.rev1))
    right_snap = snapshot_from_bytes(archive_bytes(args.rev2))
    phases = {"snapshot": time.perf_counter() - t0}
    ops = backend.diff(base_snap, right_snap,
                       base_rev=resolve_rev(args.rev1),
                       timestamp=commit_timestamp_iso(args.rev2),
                       change_signature=change_sig,
                       signature_matcher=matcher)
    phases.update(backend.phases)
    return SemdiffResult(ops=ops, matcher=matcher, phases=phases)


def render(ops: Sequence[Op], json_out: bool) -> str:
    if json_out:
        return json.dumps([op.to_dict() for op in ops], indent=2)
    return "\n".join(op.pretty() for op in ops)


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        result = semdiff(args)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    except subprocess.CalledProcessError as exc:
        cmd = exc.cmd if isinstance(exc.cmd, str) else " ".join(map(str, exc.cmd))
        print(f"error: subprocess failed ({cmd}): exit {exc.returncode}", file=sys.stderr)
        return 3
    text = render(result.ops, args.json_out)
    if text:
        print(text)
    return 0
