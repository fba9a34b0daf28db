"""Command line of the port: the semantic diff, the three-way merge and
the op-log replay.

    python -m semantic_merge_tpu_torch semdiff REV1 REV2 [--json-out]
        [--change-signature] [--signature-matcher] [--statement-ops]
        [--device cuda|cpu]
    python -m semantic_merge_tpu_torch semmerge BASE A B [--inplace]
        [--resume] [--git] [--no-degrade] [--resolve [off|auto|require]]
        [--seed SEED] [--change-signature] [--signature-matcher]
        [--strict-conflicts] [--structured-apply] [--statement-ops]
        [--device cuda|cpu]
    python -m semantic_merge_tpu_torch semrebase COMMIT ONTO [--inplace]
        [--device cuda|cpu]

``semdiff`` prints the op log between two revisions of the git
repository in the working directory, exactly as the JAX package's
``semdiff`` does: one pretty line per op, or with ``--json-out`` the op
records as indented JSON.

``semmerge`` merges A and B against BASE with the same observable output
as the JAX package's ``semmerge --backend tpu``: the exit code, the
merged work tree (with ``--inplace``, committed crash-safely),
``.semmerge-conflicts.json`` and the op logs of A and B as ``semmerge``
git notes. ``--resume`` completes (or rolls back) an interrupted
``--inplace`` commit and exits. ``--strict-conflicts`` detects every
[CFR-002] category (DivergentRename, DivergentMove,
IncompatibleSignatureChange, DeleteVsEdit, ConcurrentStmtEdit,
ExtractVsInline) before the compose and implies ``--statement-ops``;
``--structured-apply`` makes ops carry decl text and spans. ``--git``
marks a run started by the git merge driver
(``python -m semantic_merge_tpu_torch.driver``); like the JAX CLI, the
merge does not read it.

The resolution tier (``--resolve`` / ``SEMMERGE_RESOLVE``, default
``off``; a bare ``--resolve`` is ``auto``): when the compose yields
conflicts, :mod:`semantic_merge_tpu_torch.resolve` proposes a rewrite of
the op streams per conflict and accepts the set only if every verify
gate passes (the re-compose runs on the device); the merge then exits
0 with the audit trail in ``.semmerge-conflicts.json``, and otherwise
falls back to conflict-as-result (exit 1). Under ``require`` a resolver
fault writes the artifact and exits 17. Strict mode forces it off.

``semrebase`` replays the op log stored in COMMIT's ``semmerge`` note
onto ONTO: with ``--inplace`` into the work tree (the crash-safe
commit), else into a temporary directory whose path it prints; exit 1
when COMMIT has no note.

The degradation ladder of ``semmerge`` has two rungs: the semantic merge
on the device, then a whole-tree textual three-way merge (the JAX
package's ``_textual_rung``: every file through the text layer, no
formatter, no typecheck; "never worse than git merge"). A fault of the
semantic rung moves the merge to the text rung, logged as "merge
degrading torch -> text after ...", unless strict mode is on
(``--no-degrade`` or ``SEMMERGE_STRICT=1``): then it exits with the
fault's code and the work tree untouched. There is no rung that runs the
engine on the host: a device fault never degrades, under any posture,
and exits with its own code — a ``KernelFault`` of the ``merge``,
``kernel`` or ``chain`` stage (11), no CUDA device (11), a failed
``nvcc`` build (11) or ``g++`` build of the native scanner (10). The
one output that differs from the JAX CLI's: where the JAX CLI merges a
``SEMMERGE_FAULT=kernel:fault`` run on its host backend, this one exits
11 with the tree untouched. For the host stages (scan, apply, emit) the
JAX host rung meets the same fault and also ends on the text rung, so
the bytes agree. ``SEMMERGE_FAULT=stage:kind[:nth]`` injects faults
(:mod:`semantic_merge_tpu_torch.utils.faults`).

Exit codes: 0 merged, 1 conflicts, 2 type errors (and ``semdiff``
without a CUDA device), 3 a git or other subprocess failed, 10 the scan
failed or the native scanner could not be built, 11 the device engine
failed or there is no CUDA device, 13 apply or the in-place commit
failed, 14 the formatter stage failed (fault injection), 15 a
typecheck deadline expired, 17 the resolution tier failed under
``--resolve require``, 70 a refused setting (below). Codes 10-17 exit a
``semmerge`` only in strict mode, when the text rung itself fails, or
(11, 10 for a failed build) on a device fault.

``.semmerge.toml`` applies as in the JAX package: ``[core]
deterministic_seed``, ``memory_cap_mb`` (the decl cache's budget);
``[engine]`` ``change_signature``, ``signature_matcher``,
``signature_threshold``, ``matcher_ckpt_dir``, ``conflict_mode``,
``statement_ops``, ``structured_apply``, ``text_fallback``,
``formatter_scope``, ``host_workers``; ``[languages.typescript]
formatter_cmd``; ``[ci] require_typecheck``.

Refused, with exit 70 before a revision is read or the work tree is
touched, because the port does not implement what they select:
``[languages.java|csharp|cs] enabled = true`` (another language's merge
engine); ``[engine] backend`` other than ``tpu``/``host`` (``subprocess``
runs ``worker_cmd``, another program); ``[engine] mesh = "require"`` or
``SEMMERGE_MESH=require`` (a device mesh); ``SEMMERGE_DAEMON=require``
(the merge service daemon; ``off`` and ``auto`` run one-shot, as the
JAX client's ``auto`` does when it finds no daemon, with the same
bytes); for ``semmerge``, ``SEMMERGE_BATCH=require`` (the batching
tier).

Read by the JAX package and left alone here, since they do not change
its output: ``[engine] backend = "tpu"|"host"`` (the two give the same
bytes), ``incremental`` (its scope is collision-safe, so the full-tree
diff here gives the same op logs), ``mesh = "off"|"auto"`` and
``mesh_shape`` (the sharded programs give the single-device bytes),
``max_nodes_per_bucket`` (padding only), ``parity_mode``, ``[core]
formatter``, ``[languages.*] project_globs``, ``[ci] require_tests``
(read, never used), ``worker_cmd`` (used only by the refused
``subprocess`` backend), ``[slo]`` (telemetry); ``SEMMERGE_BREAKER``
(the ladder's and the resolution tier's circuit breakers, a no-op
outside the JAX package's daemon unless ``on``; not ported).
``--trace`` / ``--profile`` are not ported yet.

The commands run on the CUDA card; ``--device cpu`` runs them on the
CPU instead. Without a card and without that flag they say why and exit,
``semdiff`` with status 2, ``semmerge`` and ``semrebase`` with 11,
before reading any revision or touching the work tree.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .backends.ts_torch import BuildAndDiffResult, TorchTSBackend
from .config import load_config, refused_environment, refused_settings
from .core.conflict import conflicts_payload
from .core.strict_conflicts import detect_conflicts_strict
from .core.ops import Op, OpLog
from .device import DeviceUnavailable, resolve_device
from .errors import (KernelFault, MergeFault, UnsupportedSetting, fault_boundary,
                     is_device_fault)
from .frontend.declcache import configure as configure_decl_cache
from .runtime.applier import _normalize_relpath, apply_ops, touched_paths
from .runtime.emitter import PRETTIER_EXTENSIONS, emit_files
from .runtime.git import (archive_bytes, checkout_tree_to_temp, commit_timestamp_iso,
                          resolve_rev, snapshot_from_bytes, temp_tree)
from .runtime.inplace import commit_tree_inplace, recover, repo_lock
from .runtime.notes import notes_get, notes_put
from .runtime.textmerge import apply_text_fallback
from .runtime.verify import typecheck_ts

logger = logging.getLogger(__name__)

CONFLICTS_ARTIFACT = ".semmerge-conflicts.json"
#: ``semmerge``'s and ``semrebase``'s exit without a device: the JAX
#: package's KernelFault code, so that it is never read as 2 ("type
#: errors").
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
    p_diff.add_argument("--statement-ops", action="store_true",
                        help="Extract editStmtBlock ops for body-only decl "
                             "edits (also [engine].statement_ops)")
    p_merge = sub.add_parser("semmerge", help="Semantic merge base A B into working tree")
    p_merge.add_argument("base", nargs="?", default=None)
    p_merge.add_argument("a", nargs="?", default=None)
    p_merge.add_argument("b", nargs="?", default=None)
    p_merge.add_argument("--inplace", action="store_true",
                         help="Write the merge result into the current working tree "
                              "(crash-safe: staged, journaled, atomically committed)")
    p_merge.add_argument("--no-degrade", action="store_true",
                         help="Fail fast with the fault's documented exit code "
                              "instead of merging as text (same as SEMMERGE_STRICT=1)")
    p_merge.add_argument("--resolve", nargs="?", const="auto", default=None,
                         choices=("off", "auto", "require"),
                         help="Conflict-resolution tier posture (also "
                              "SEMMERGE_RESOLVE). auto: resolve when every "
                              "verify gate passes, fall back to conflict-as-"
                              "result otherwise; require: a resolver fault "
                              "exits 17 instead of falling back. Always off "
                              "under --no-degrade/SEMMERGE_STRICT=1")
    p_merge.add_argument("--resume", action="store_true",
                         help="Complete (or roll back) an interrupted --inplace "
                              "commit in the current directory, then exit")
    p_merge.add_argument("--git", action="store_true",
                         help="Flag set when invoked via git merge driver")
    p_merge.add_argument("--seed", default=None, help="Deterministic id seed override")
    p_merge.add_argument("--strict-conflicts", action="store_true",
                         help="Detect all [CFR-002] conflict categories via a "
                              "full symbol join (also [engine].conflict_mode)")
    p_merge.add_argument("--structured-apply", action="store_true",
                         help="Ops carry decl text/spans so add/delete/"
                              "changeSignature materialize structurally "
                              "(also [engine].structured_apply)")
    p_merge.add_argument("--statement-ops", action="store_true",
                         help="Extract editStmtBlock ops for body-only decl "
                              "edits (also [engine].statement_ops; implied "
                              "by --strict-conflicts)")
    for p in (p_diff, p_merge):
        p.add_argument("--change-signature", action="store_true",
                       help="Detect changeSignature ops instead of delete+add "
                            "(also [engine].change_signature in .semmerge.toml)")
        p.add_argument("--signature-matcher", action="store_true",
                       help="Pair renamed+retyped decls by embedding "
                            "similarity (also [engine].signature_matcher)")
    p_rebase = sub.add_parser("semrebase",
                              help="Replay a commit's stored op log onto a revision")
    p_rebase.add_argument("commit", help="Commit whose semmerge note holds the op log")
    p_rebase.add_argument("onto", help="Revision to replay onto")
    p_rebase.add_argument("--inplace", action="store_true")
    for p in (p_diff, p_merge, p_rebase):
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


def _refuse(refused: List[str]) -> None:
    if refused:
        raise UnsupportedSetting(
            f"{', '.join(refused)}: not implemented by this port (it would change the "
            "JAX package's output); unset it or use python -m semantic_merge_tpu",
            stage="config")


def _load_config(command: str):
    """The ``.semmerge.toml`` in force, with the decl cache's budget
    applied; raises :class:`UnsupportedSetting` on a refused setting."""
    config = load_config()
    _refuse(refused_settings(config, command))
    configure_decl_cache(config.core.memory_cap_mb)
    return config


def semdiff(args: argparse.Namespace) -> SemdiffResult:
    """Run ``semdiff`` for parsed ``args`` in the working directory."""
    config = _load_config("semdiff").engine
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
                       signature_matcher=matcher,
                       statement_ops=args.statement_ops or config.statement_ops)
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
    #: The resolution tier's audit records (None when it did not run).
    resolutions: List[dict] | None = None
    #: The embedding matcher the merge used, or None.
    matcher: object | None = None
    #: Seconds per phase: snapshot, the backend's phases, then resolve,
    #: extract (the base tree onto disk), apply, text, format,
    #: typecheck, commit and notes; ``text_merge`` on the textual rung.
    phases: Dict[str, float] = field(default_factory=dict)


def _write_conflict_reports(conflicts, resolutions=None) -> None:
    (pathlib.Path.cwd() / CONFLICTS_ARTIFACT).write_text(
        json.dumps(conflicts_payload(conflicts, resolutions), indent=2), encoding="utf-8")


def _strict_mode(args: argparse.Namespace) -> bool:
    """Fail-fast mode: ``--no-degrade`` or ``SEMMERGE_STRICT=1``."""
    return (getattr(args, "no_degrade", False)
            or (os.environ.get("SEMMERGE_STRICT", "") or "").strip() == "1")


def _fail_fast(fault: MergeFault, command: str = "semmerge") -> int:
    """Report a fault that ends the command; returns its exit code."""
    traceback.print_exception(fault, file=sys.stderr)
    print(f"{command}: {fault.describe()} (exit {fault.exit_code})", file=sys.stderr)
    return fault.exit_code


def _record_degradation(frm: str, to: str, fault: MergeFault) -> None:
    """One ladder rung transition: the log line."""
    logger.warning("merge degrading %s -> %s after %s", frm, to, fault.describe())


def semmerge(args: argparse.Namespace) -> SemmergeResult:
    """Run ``semmerge`` for parsed ``args`` in the working directory:
    the degradation ladder of the JAX package's ``cli._merge_ladder``
    without its host rung. The semantic attempt runs first; a
    :class:`MergeFault` from it moves the merge to the textual rung
    unless strict mode is on or it is a device fault
    (:func:`~semantic_merge_tpu_torch.errors.is_device_fault`), which
    propagate (``main`` exits with the fault's code). A fault of the
    textual rung propagates too."""
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
    config = _load_config("semmerge")
    if args.inplace:
        # A journal/stage left by an interrupted --inplace commit is
        # resolved before this merge touches anything.
        with repo_lock():
            recover()
    try:
        return _semantic_attempt(args, config, backend)
    except MergeFault as fault:
        if _strict_mode(args) or is_device_fault(fault):
            raise
        _record_degradation(backend.name, "text", fault)
    t0 = time.perf_counter()
    code = _textual_rung(args)
    return SemmergeResult(code=code, phases={"text_merge": time.perf_counter() - t0})


def _semantic_attempt(args: argparse.Namespace, config,
                      backend: TorchTSBackend) -> SemmergeResult:
    """The semantic rung (the JAX package's ``cli._semantic_attempt``).
    Returns the merge's result (exit 0, 1 or 2, or 17 under ``--resolve
    require``); raises :class:`MergeFault` when a stage fails, each
    stage inside a :class:`~semantic_merge_tpu_torch.errors.fault_boundary`
    that classifies its unexpected exceptions. In strict conflict mode
    the op logs come from :meth:`TorchTSBackend.build_and_diff`, the
    strict detection drops the conflicting ops from both, and the device
    compose merges the rest, its conflicts appended to the strict ones."""
    engine = config.engine
    backend.host_workers = engine.host_workers
    change_sig = args.change_signature or engine.change_signature
    structured = args.structured_apply or engine.structured_apply
    strict = args.strict_conflicts or engine.conflict_mode == "strict"
    # Strict mode implies statement ops: the ConcurrentStmtEdit
    # category has no inputs without editStmtBlock extraction.
    stmt_ops = args.statement_ops or engine.statement_ops or strict
    out = SemmergeResult(code=0, matcher=_signature_matcher(
        args, engine, change_sig, backend.device))
    phases = out.phases
    t = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    with fault_boundary("snapshot"):
        base_tar, left_tar, right_tar = (archive_bytes(rev) for rev in (args.base, args.a, args.b))
        snaps = [snapshot_from_bytes(tar) for tar in (base_tar, left_tar, right_tar)]
    base_rev = resolve_rev(args.base)
    seed = args.seed or config.core.deterministic_seed
    if seed == "auto":
        seed = base_rev
    timestamp = commit_timestamp_iso(args.base)
    lap("snapshot")
    kw = dict(base_rev=base_rev, seed=seed, timestamp=timestamp,
              change_signature=change_sig, structured_apply=structured,
              signature_matcher=out.matcher, statement_ops=stmt_ops)
    # The engine's stages: the scan raises its own ParseFault, anything
    # else unexpected is the device engine's (KernelFault).
    with fault_boundary("merge"):
        if strict:
            out.result = backend.build_and_diff(*snaps, **kw)
            phases.update(backend.phases)
            t = time.perf_counter()
            ops_left, ops_right, out.conflicts = detect_conflicts_strict(
                out.result.op_log_left, out.result.op_log_right)
            lap("strict_detect")
            out.composed, walk_conflicts = backend.compose(ops_left, ops_right)
            out.conflicts.extend(walk_conflicts)
            lap("compose")
        else:
            out.result, out.composed, out.conflicts = backend.merge(*snaps, **kw)
            phases.update(backend.phases)
    t = time.perf_counter()

    if out.conflicts:
        from .resolve import posture as resolve_posture
        # Strict mode forces the tier off: fail-fast runs must not
        # synthesize output, whatever the posture says.
        posture = "off" if _strict_mode(args) else resolve_posture(args)
        resolved = False
        if posture != "off":
            from .resolve import engine as resolve_engine
            outcome = None
            try:
                with fault_boundary("resolve"):
                    outcome = resolve_engine.resolve_conflicts(
                        out.conflicts, list(out.result.op_log_left),
                        list(out.result.op_log_right), composed=out.composed,
                        base_tar=base_tar, left_tar=left_tar, right_tar=right_tar,
                        strict_detect=strict, config=config, device=backend.device)
            except MergeFault as fault:
                if is_device_fault(fault):
                    raise
                if posture == "require":
                    # Tier availability is the require contract: the
                    # conflicts are still computed results, so the
                    # artifact is written before the fault exit.
                    _write_conflict_reports(out.conflicts)
                    out.code = _fail_fast(fault)
                    return out
                resolve_engine.record_resolver_fault(fault)
            lap("resolve")
            if outcome is not None:
                out.resolutions = outcome.records
                if outcome.accepted:
                    out.composed = outcome.composed
                    resolved = True
        # The artifact carries the audit trail whenever the tier ran:
        # rejected proposals on the conflict exit, accepted ones next to
        # the success exit.
        _write_conflict_reports(out.conflicts, out.resolutions)
        if not resolved:
            out.code = 1
            return out
    else:
        # A clean merge must not leave a stale artifact from a previous
        # conflicted run next to a success exit code.
        (pathlib.Path.cwd() / CONFLICTS_ARTIFACT).unlink(missing_ok=True)

    merged_tree = None
    try:
        with fault_boundary("apply"):
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
                    _write_conflict_reports(text_conflicts, out.resolutions)
                    out.code = 1
                    return out
        with fault_boundary("format"):
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
        with fault_boundary("verify"):
            ok, diagnostics = (typecheck_ts(merged_tree) if config.ci.require_typecheck
                               else (True, []))
        lap("typecheck")
        if not ok:
            for line in diagnostics:
                print(line, file=sys.stderr)
            out.code = 2
            return out
        if args.inplace:
            with fault_boundary("commit"):
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


def _textual_rung(args: argparse.Namespace) -> int:
    """The ladder's floor: a whole-tree textual three-way merge — every
    file through :func:`runtime.textmerge.apply_text_fallback` with an
    EMPTY indexed set, i.e. git-equivalent three-way semantics for the
    whole tree. No semantic engine, no formatter, no typecheck, no
    notes: "never worse than ``git merge``"."""
    with fault_boundary("apply"):
        base_tar, left_tar, right_tar = (archive_bytes(rev) for rev in (args.base, args.a, args.b))
        with temp_tree(base_tar) as merged_tree:
            conflicts, deleted_paths, _written = apply_text_fallback(
                merged_tree, base_tar, left_tar, right_tar,
                indexed_extensions=frozenset())
            if conflicts:
                _write_conflict_reports(conflicts)
                return 1
            (pathlib.Path.cwd() / CONFLICTS_ARTIFACT).unlink(missing_ok=True)
            if args.inplace:
                with fault_boundary("commit"):
                    with repo_lock():
                        commit_tree_inplace(merged_tree, deletes=deleted_paths)
    return 0


def semrebase(args: argparse.Namespace) -> int:
    """Replay the op log stored on ``args.commit`` onto ``args.onto``
    (the JAX package's ``cli.cmd_semrebase``): apply, the default
    formatter, then the crash-safe commit with ``--inplace``, else print
    the replayed tree's temporary directory (left for the caller)."""
    resolve_device(args.device)  # the merge family's device contract
    _refuse(refused_environment("semrebase"))
    oplog = notes_get(resolve_rev(args.commit))
    if oplog is None:
        print(f"No semmerge op log stored for {args.commit}", file=sys.stderr)
        return 1
    base_tree = checkout_tree_to_temp(args.onto)
    try:
        merged = apply_ops(base_tree, list(oplog))
        emit_files(merged)
        if args.inplace:
            with repo_lock():
                commit_tree_inplace(merged)
            shutil.rmtree(merged, ignore_errors=True)
        else:
            print(str(merged))
    finally:
        shutil.rmtree(base_tree, ignore_errors=True)
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "semmerge":
            return semmerge(args).code
        if args.command == "semrebase":
            return semrebase(args)
        result = semdiff(args)
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2 if args.command == "semdiff" else EXIT_NO_DEVICE_MERGE
    except subprocess.CalledProcessError as exc:
        cmd = exc.cmd if isinstance(exc.cmd, str) else " ".join(map(str, exc.cmd))
        print(f"error: subprocess failed ({cmd}): exit {exc.returncode}", file=sys.stderr)
        return 3
    except UnsupportedSetting as fault:
        print(f"{args.command}: {fault.describe()} (exit {fault.exit_code})",
              file=sys.stderr)
        return fault.exit_code
    except MergeFault as fault:
        return _fail_fast(fault, args.command)
    text = render(result.ops, args.json_out)
    if text:
        print(text)
    return 0
