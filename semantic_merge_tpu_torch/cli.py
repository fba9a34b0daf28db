"""Command line of the port: the semantic diff and the three-way merge.

    python -m semantic_merge_tpu_torch semdiff REV1 REV2 [--json-out]
        [--change-signature] [--signature-matcher] [--device cuda|cpu]
    python -m semantic_merge_tpu_torch semmerge BASE A B [--inplace]
        [--resume] [--seed SEED] [--change-signature] [--signature-matcher]
        [--device cuda|cpu]

``semdiff`` prints the op log between two revisions of the git
repository in the working directory, exactly as the JAX package's
``semdiff`` does: one pretty line per op, or with ``--json-out`` the op
records as indented JSON.

``semmerge`` merges A and B against BASE with the same observable output
as the JAX package's ``semmerge --backend tpu``: the exit code, the
merged work tree (with ``--inplace``, committed crash-safely),
``.semmerge-conflicts.json`` and the op logs of A and B as ``semmerge``
git notes. Exit codes: 0 merged, 1 conflicts, 2 type errors, 3 a git or
other subprocess failed; 11 the device engine failed or there is no
CUDA device, 13 the in-place commit failed, 15 a typecheck deadline
expired. ``--resume`` completes (or rolls back) an interrupted
``--inplace`` commit and exits.

``.semmerge.toml`` applies as in the JAX package: ``[engine]``
``change_signature``, ``signature_matcher``, ``signature_threshold``,
``matcher_ckpt_dir``, ``text_fallback`` and ``formatter_scope``; ``[core]
deterministic_seed``; ``[languages.typescript] formatter_cmd``; ``[ci]
require_typecheck``.

Both commands run on the CUDA card; ``--device cpu`` runs them on the
CPU instead. Without a card and without that flag they say why and exit,
``semdiff`` with status 2 and ``semmerge`` with 11, before reading any
revision or touching the work tree. There is no fallback to another
backend or to a text-only merge: a failure exits non-zero.

The JAX CLI's incremental scope (diffing only the files that changed)
is collision-safe by construction, so the full-tree diff here gives the
same op logs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .backends.ts_torch import BuildAndDiffResult, TorchTSBackend
from .config import load_config
from .core.conflict import conflicts_payload
from .core.ops import Op, OpLog
from .device import DeviceUnavailable
from .errors import KernelFault, MergeFault
from .runtime.applier import _normalize_relpath, apply_ops, touched_paths
from .runtime.emitter import PRETTIER_EXTENSIONS, emit_files
from .runtime.git import (archive_bytes, commit_timestamp_iso, resolve_rev,
                          snapshot_from_bytes, temp_tree)
from .runtime.inplace import commit_tree_inplace, recover, repo_lock
from .runtime.notes import notes_put
from .runtime.textmerge import apply_text_fallback
from .runtime.verify import typecheck_ts

CONFLICTS_ARTIFACT = ".semmerge-conflicts.json"
#: ``semmerge``'s exit without a device: the JAX package's KernelFault
#: code, so that it is never read as 2 ("type errors").
EXIT_NO_DEVICE_MERGE = KernelFault.exit_code


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
    p_merge = sub.add_parser("semmerge", help="Semantic merge base A B into working tree")
    p_merge.add_argument("base", nargs="?", default=None)
    p_merge.add_argument("a", nargs="?", default=None)
    p_merge.add_argument("b", nargs="?", default=None)
    p_merge.add_argument("--inplace", action="store_true",
                         help="Write the merge result into the current working tree "
                              "(crash-safe: staged, journaled, atomically committed)")
    p_merge.add_argument("--resume", action="store_true",
                         help="Complete (or roll back) an interrupted --inplace "
                              "commit in the current directory, then exit")
    p_merge.add_argument("--seed", default=None, help="Deterministic id seed override")
    for p in (p_diff, p_merge):
        p.add_argument("--change-signature", action="store_true",
                       help="Detect changeSignature ops instead of delete+add "
                            "(also [engine].change_signature in .semmerge.toml)")
        p.add_argument("--signature-matcher", action="store_true",
                       help="Pair renamed+retyped decls by embedding "
                            "similarity (also [engine].signature_matcher)")
        p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                       help="Where to run (default: cuda; cpu only when asked)")
    return parser


def _signature_matcher(args, engine, change_sig: bool, device):
    """The embedding matcher when enabled (CLI flag or config)."""
    if not (change_sig and (args.signature_matcher or engine.signature_matcher)):
        return None
    from .models.signature import EmbeddingSignatureMatcher
    return EmbeddingSignatureMatcher(threshold=engine.signature_threshold,
                                     ckpt_dir=engine.matcher_ckpt_dir, device=device)


@dataclass
class SemdiffResult:
    ops: List[Op]
    #: The embedding matcher the diff used, or None.
    matcher: object | None
    #: Seconds per phase: snapshot, then the backend's phases.
    phases: Dict[str, float] = field(default_factory=dict)


def semdiff(args: argparse.Namespace) -> SemdiffResult:
    """Run ``semdiff`` for parsed ``args`` in the working directory."""
    config = load_config().engine
    backend = TorchTSBackend(device=args.device, host_workers=config.host_workers)
    change_sig = args.change_signature or config.change_signature
    matcher = _signature_matcher(args, config, change_sig, backend.device)
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


@dataclass
class SemmergeResult:
    #: The command's exit code.
    code: int
    #: Both sides' op logs (None when the merge did not get that far).
    result: BuildAndDiffResult | None = None
    composed: List[Op] = field(default_factory=list)
    conflicts: list = field(default_factory=list)
    #: The embedding matcher the merge used, or None.
    matcher: object | None = None
    #: Seconds per phase: snapshot, the backend's phases, then extract
    #: (the base tree onto disk), apply, text, format, typecheck, commit
    #: and notes.
    phases: Dict[str, float] = field(default_factory=dict)


def _write_conflict_reports(conflicts) -> None:
    (pathlib.Path.cwd() / CONFLICTS_ARTIFACT).write_text(
        json.dumps(conflicts_payload(conflicts), indent=2), encoding="utf-8")


def semmerge(args: argparse.Namespace) -> SemmergeResult:
    """Run ``semmerge`` for parsed ``args`` in the working directory.

    The body of the JAX package's ``cli._semantic_attempt`` (non-strict
    branch), without its degradation ladder and resolution tier."""
    backend = TorchTSBackend(device=args.device)  # no device: raises here
    if args.resume:
        with repo_lock():
            action, n_writes = recover()
        detail = f" ({n_writes} writes)" if action == "rolled-forward" else ""
        print(f"inplace recovery: {action}{detail}")
        return SemmergeResult(code=0)
    if not (args.base and args.a and args.b):
        print("error: semmerge requires BASE A B revisions (or --resume)",
              file=sys.stderr)
        return SemmergeResult(code=2)
    if args.inplace:
        # A journal/stage left by an interrupted --inplace commit is
        # resolved before this merge touches anything.
        with repo_lock():
            recover()
    config = load_config()
    engine = config.engine
    backend.host_workers = engine.host_workers
    change_sig = args.change_signature or engine.change_signature
    out = SemmergeResult(code=0, matcher=_signature_matcher(
        args, engine, change_sig, backend.device))
    phases = out.phases
    t = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    base_tar, left_tar, right_tar = (archive_bytes(rev) for rev in (args.base, args.a, args.b))
    snaps = [snapshot_from_bytes(tar) for tar in (base_tar, left_tar, right_tar)]
    base_rev = resolve_rev(args.base)
    seed = args.seed or config.core.deterministic_seed
    if seed == "auto":
        seed = base_rev
    timestamp = commit_timestamp_iso(args.base)
    lap("snapshot")
    try:
        out.result, out.composed, out.conflicts = backend.merge(
            *snaps, base_rev=base_rev, seed=seed, timestamp=timestamp,
            change_signature=change_sig, signature_matcher=out.matcher)
    except Exception as exc:  # the device engine's failure is the merge's
        raise KernelFault(f"{type(exc).__name__}: {exc}", stage="merge") from exc
    phases.update(backend.phases)
    t = time.perf_counter()
    if out.conflicts:
        _write_conflict_reports(out.conflicts)
        out.code = 1
        return out
    # A clean merge must not leave a stale artifact from a previous
    # conflicted run next to a success exit code.
    (pathlib.Path.cwd() / CONFLICTS_ARTIFACT).unlink(missing_ok=True)

    merged_tree = None
    try:
        with temp_tree(base_tar) as base_tree:
            lap("extract")
            merged_tree = apply_ops(base_tree, out.composed)
        lap("apply")
        deleted_paths: list = []
        text_written: list = []
        if engine.text_fallback:
            # Files outside the backend's extensions merge textually.
            text_conflicts, deleted_paths, text_written = apply_text_fallback(
                merged_tree, base_tar, left_tar, right_tar,
                indexed_extensions=backend.extensions)
            lap("text")
            if text_conflicts:
                out.conflicts = text_conflicts
                _write_conflict_reports(text_conflicts)
                out.code = 1
                return out
        ts_cfg = config.languages.get("typescript")
        formatter = list(ts_cfg.formatter_cmd) if ts_cfg and ts_cfg.formatter_cmd else None
        touched = None
        if engine.formatter_scope == "touched":
            # Everything the merge wrote: the op stream's path params,
            # plus text-merged files of suffixes the formatter parses.
            touched = touched_paths(out.composed)
            touched.update(str(_normalize_relpath(p)) for p in text_written
                           if pathlib.PurePosixPath(p).suffix.lower() in PRETTIER_EXTENSIONS)
        emit_files(merged_tree, formatter, paths=touched)
        lap("format")
        ok, diagnostics = typecheck_ts(merged_tree) if config.ci.require_typecheck else (True, [])
        lap("typecheck")
        if not ok:
            for line in diagnostics:
                print(line, file=sys.stderr)
            out.code = 2
            return out
        if args.inplace:
            with repo_lock():
                commit_tree_inplace(merged_tree, deletes=deleted_paths)
            lap("commit")
        notes_put(resolve_rev(args.a), OpLog(out.result.op_log_left))
        notes_put(resolve_rev(args.b), OpLog(out.result.op_log_right))
        lap("notes")
        return out
    finally:
        if merged_tree is not None:
            shutil.rmtree(merged_tree, ignore_errors=True)


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "semmerge":
            return semmerge(args).code
        result = semdiff(args)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return EXIT_NO_DEVICE_MERGE if args.command == "semmerge" else 2
    except subprocess.CalledProcessError as exc:
        cmd = exc.cmd if isinstance(exc.cmd, str) else " ".join(map(str, exc.cmd))
        print(f"error: subprocess failed ({cmd}): exit {exc.returncode}", file=sys.stderr)
        return 3
    except MergeFault as fault:
        traceback.print_exception(fault, file=sys.stderr)
        print(f"{args.command}: {fault.describe()} (exit {fault.exit_code})",
              file=sys.stderr)
        return fault.exit_code
    text = render(result.ops, args.json_out)
    if text:
        print(text)
    return 0
