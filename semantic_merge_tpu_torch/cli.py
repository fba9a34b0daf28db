"""Command line of the port: the semantic diff, the three-way merge and
the op-log replay.

    python -m semantic_merge_tpu_torch semdiff REV1 REV2 [--json-out]
        [--change-signature] [--signature-matcher] [--statement-ops]
        [--trace] [--profile DIR] [--backend NAME] [--device cuda|cpu]
    python -m semantic_merge_tpu_torch semmerge BASE A B [--inplace]
        [--resume] [--git] [--no-degrade] [--resolve [off|auto|require]]
        [--seed SEED] [--change-signature] [--signature-matcher]
        [--strict-conflicts] [--structured-apply] [--statement-ops]
        [--trace] [--profile DIR] [--backend NAME] [--device cuda|cpu]
    python -m semantic_merge_tpu_torch semrebase COMMIT ONTO [--inplace]
        [--device cuda|cpu]
    python -m semantic_merge_tpu_torch serve [--socket PATH] [--workers N] [--queue N]
        [--idle-exit S] [--events PATH] [--status] [--supervise] [--device cuda|cpu]
    python -m semantic_merge_tpu_torch stats [ARTIFACT | --daemon] [--json | --prometheus]
    python -m semantic_merge_tpu_torch trace analyze ARTIFACT|DIR [--json]
        [--since DURATION]
    python -m semantic_merge_tpu_torch trace diff A B [--json]
    python -m semantic_merge_tpu_torch profile --daemon [--seconds S] [--out DIR]
        [--socket PATH] [--json]
    python -m semantic_merge_tpu_torch perf record|compare [SNAPSHOT ...]
        [--baseline PATH] [--daemon] ...
    python -m semantic_merge_tpu_torch top [--socket PATH] [--interval S] [--once]
        [--json]
    python -m semantic_merge_tpu_torch train-matcher [--steps N] [--batch N]
        [--seq N] [--seed N] [--ckpt-dir DIR] [--ckpt-every N] [--no-resume]
        [--eval] [--device cuda|cpu]

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

The degradation ladder of ``semmerge`` (:func:`_merge_ladder`): the
semantic merge on the engine in force, then a whole-tree textual
three-way merge (the JAX package's ``_textual_rung``: every file through
the text layer, no formatter, no typecheck; "never worse than git
merge"). For the port's TypeScript engine these are the two rungs, and a
fault of the semantic rung is logged as "merge degrading torch -> text
after ..."; for the other engines (``subprocess``/``worker``, ``java``,
``cs``, a routed ``multi``) the JAX middle rung ``host`` comes between:
the port's engine on the same device, with the config's language
routing. In strict mode (``--no-degrade`` or ``SEMMERGE_STRICT=1``) a
fault exits with its code and the work tree untouched. There is no rung
that runs the engine on the CPU: a device fault never degrades, under
any posture,
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
failed or there is no CUDA device, 12 the merge service refused or
could not serve the request, 13 apply or the in-place commit failed, 14
the formatter stage failed (fault injection), 15 a typecheck or request
deadline expired, 16 a batching fault under ``SEMMERGE_BATCH=require``,
17 the resolution tier failed under ``--resolve require``, 70 a refused
setting (below). Codes 10-17 exit a ``semmerge`` only in strict mode,
when the text rung itself fails, or (11 and 16, 10 for a failed build)
on a device fault.

``--backend NAME`` and ``[engine] backend`` (the flag wins) name the
engine as in the JAX CLI (:mod:`semantic_merge_tpu_torch.backends`):
``tpu``, ``ts_tpu``, ``host`` and ``ts_host``, which give the same bytes
there, run this port's TypeScript engine on the device it was given
(``host`` does not mean the CPU); ``java``, ``cs`` and ``csharp`` the
C-family engine of that language alone; ``subprocess`` and ``worker``
the engine in a supervised child process (``[engine] worker_cmd``, by
default ``python -m semantic_merge_tpu_torch.runtime.worker``, on this
run's device). A name the JAX CLI does not know logs its warning
("Backend 'NAME' unavailable (...); falling back to host") and runs as
``host``. ``[languages.java|csharp|cs] enabled = true`` routes those
files to their C-family engine beside the one in force
(:mod:`semantic_merge_tpu_torch.backends.multi`): one run merges every
enabled language semantically, and the text layer only the rest.

``.semmerge.toml`` applies as in the JAX package: ``[core]
deterministic_seed``, ``memory_cap_mb`` (the decl cache's budget);
``[engine]`` ``change_signature``, ``signature_matcher``,
``signature_threshold``, ``matcher_ckpt_dir``, ``conflict_mode``,
``statement_ops``, ``structured_apply``, ``text_fallback``,
``formatter_scope``, ``host_workers``, ``backend``, ``worker_cmd``;
``[languages.typescript] formatter_cmd``; ``[languages.java|csharp|cs]
enabled``; ``[ci] require_typecheck``.

The merge service (:mod:`semantic_merge_tpu_torch.service`): ``serve``
runs a warm daemon on a unix socket (default
``$XDG_RUNTIME_DIR/semmerge-torch.sock``, else
``/tmp/semmerge-torch-<uid>.sock``, never the JAX package's; or
``SEMMERGE_SERVICE_SOCKET``, or ``--socket``) on the card (``--device
cpu`` for tests; without a card it exits 11 before it binds; a daemon
the client spawns for a ``--device cpu`` request runs on the CPU); ``--status`` prints a running daemon's
status, ``--supervise`` respawns a crashed daemon. With
``SEMMERGE_DAEMON=auto|require`` the three verbs go to the daemon
(spawned if absent): ``auto`` runs one-shot when no daemon of this
package answers, ``require`` exits 12; a JAX daemon on the socket counts
as none. A request runs on the device its argv names, with the client's
``SEMMERGE_*`` settings; the daemon co-batches concurrent merges on its
device (``SEMMERGE_BATCH=off|auto|require``, ``SEMMERGE_BATCH_WINDOW_MS``,
``_MAX``, ``_INFLIGHT``), keeps repeat bases resident
(``SEMMERGE_RESIDENCY_CACHE``, ``_MB``), runs the circuit breakers
(``SEMMERGE_BREAKER``, ``_THRESHOLD``, ``_WINDOW``, ``_COOLDOWN``; on
inside the daemon, a no-op one-shot unless ``on``), serves ``/metrics``
and ``/healthz`` on loopback (``SEMMERGE_METRICS_PORT``) and evaluates
``SEMMERGE_SLO`` / ``[slo]``. Its exits: 12 queue full, draining,
overload or an open breaker under ``--no-degrade``; 15 a request past
``SEMMERGE_SERVICE_DEADLINE``; 16 a batching fault under
``SEMMERGE_BATCH=require`` (also a one-shot ``semmerge`` with it, before
anything is read: no scheduler runs outside the daemon). ``stats
--daemon`` renders the live status, ``top`` the JAX CLI's one-screen
dashboard of it. With ``SEMMERGE_OTLP_ENDPOINT`` the daemon ships each
served request's trace to an OTLP collector
(:mod:`semantic_merge_tpu_torch.obs.export`); a one-shot run exports
nothing, as in the JAX CLI. ``profile --daemon`` captures a bounded
``torch.profiler`` window from the running daemon, and
``SEMMERGE_SLO_AUTOPROFILE`` makes the daemon capture one on its first
SLO trip.

``semdiff``, ``semmerge`` and ``semrebase`` run under the one-shot GC
posture (:mod:`semantic_merge_tpu_torch.utils.gctune`; off with
``SEMMERGE_GC_TUNE=0``, which the daemon sets for itself), as the JAX
CLI's do.

``fleet`` runs the JAX CLI's routing tier
(:mod:`semantic_merge_tpu_torch.fleet`): a router on the service socket
in front of ``--members`` supervised port daemons, each on ``--device``
(default ``cuda``; without a card and without ``--device cpu`` it exits
11 before it binds or spawns anything, as ``serve`` does), with
rendezvous-hash repo affinity, a dispatch WAL, failover and hedged
reads; ``fleet --status``, ``--drain MEMBER|all`` and ``--leave MEMBER``
query and steer a running one. ``serve --socket tcp://HOST:PORT --join
ROUTER`` (``--advertise``, ``--capacity``, ``--member-id``) adds a
remote member over TCP, mTLS under ``SEMMERGE_FLEET_TLS_*``; ``serve
--status --fleet`` prints every member's status through the router.
Under ``SEMMERGE_FLEET=auto|require`` a merge verb routes through the
router (``require`` with none exits 19, a transport failure 21). Same
flags, exit codes and stdout as the JAX CLI's.

Refused, with exit 70 before a revision is read or the work tree is
touched, because the port does not implement what they select:
``[engine] mesh = "require"`` or ``SEMMERGE_MESH=require`` (a device
mesh).

``incremental`` scopes the scan to the files either side touched, for
every engine, with the JAX CLI's collision guard (:func:`_snapshots`).

Read by the JAX package and left alone here, since they do not change
its output: ``mesh = "off"|"auto"`` and
``mesh_shape`` (the sharded programs give the single-device bytes),
``max_nodes_per_bucket`` (padding only), ``parity_mode``, ``[core]
formatter``, ``[languages.*] project_globs``, ``[ci] require_tests``
(read, never used).

Telemetry (:mod:`semantic_merge_tpu_torch.obs`,
:mod:`semantic_merge_tpu_torch.runtime.trace`), as the JAX CLI records
it: ``--trace`` writes ``.semmerge-trace.json`` (phases, counters, the
span tree, the device block, the metrics registry) and
``.semmerge-events.jsonl`` into the working directory; ``--profile DIR``
captures the run with ``torch.profiler`` (the card's kernels too, unless
``--device cpu``), every phase a ``semmerge/<phase>`` range, and writes
the profiler's Chrome trace and ``DIR/semmerge-trace.json``. Neither
changes an output byte, and neither records or profiles anything
without the flag. Every ladder transition counts in
``merge_degradations_total{from,to,fault}``, records a ``degradation``
span and writes a ``degradation`` postmortem bundle
(``.semmerge-postmortem/``); a fault that ends the command counts in
``merge_faults_total{fault,stage}``, writes a ``fault-escape`` bundle and
ends its stderr line with ``[trace <id>]``. ``SEMMERGE_METRICS=path``
dumps the registry at exit. ``stats`` pretty-prints a trace, events or
metrics artifact (``--json``, ``--prometheus``), ``trace analyze`` its
critical path (one file, or p50/p99 over a directory), ``trace diff``
two artifacts phase by phase; their output is the JAX CLI's for the
same artifact. ``perf record|compare`` is the JAX CLI's perf sentinel
(:mod:`semantic_merge_tpu_torch.obs.perf`) over bench snapshots or a
live daemon's latency window, with the same output, exit codes and
baseline format; point ``--baseline`` outside the checkout, whose
``PERF_BASELINE.json`` holds the TPU's numbers. ``stats --daemon
--fleet`` renders a fleet router's aggregated status, ``trace analyze
--fleet`` the router-hop breakdown of a stitched fleet trace.

``train-matcher`` trains the signature matcher's encoder as the JAX
package's ``train-matcher`` does (InfoNCE over synthetic declaration
pairs, AdamW; :mod:`semantic_merge_tpu_torch.models.training`), with
the same flags and output lines: ``trained N steps, final loss X[,
checkpoints in DIR]`` or ``nothing to do: ...``, and with ``--eval`` one
``{"matcher_eval": {...}}`` line of held-out pairing precision and
recall. ``--ckpt-dir DIR`` saves every ``--ckpt-every`` steps and at the
last (``torch.save`` files, the newest three kept), resumes from the
latest unless ``--no-resume``, and writes ``DIR/matcher.pt``, so
``[engine] matcher_ckpt_dir = DIR`` makes ``--signature-matcher`` score
with the trained weights. The JAX package's orbax checkpoints are not
read.

The commands run on the CUDA card; ``--device cpu`` runs them on the
CPU instead. Without a card and without that flag they say why and exit,
``semdiff`` and ``train-matcher`` with status 2, ``semmerge`` and
``semrebase`` with 11, before reading any revision, touching the work
tree or training.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .backends.base import BuildAndDiffResult, get_backend, run_merge
from .backends.multi import route_backends
from .backends.ts_torch import TorchTSBackend
from .config import load_config, refused_environment, refused_settings, resolve_backend
from .core.conflict import conflicts_payload
from .core.strict_conflicts import detect_conflicts_strict
from .core.ops import Op, OpLog
from .device import DeviceUnavailable, resolve_device
from .errors import (BatchFault, KernelFault, MergeFault, UnsupportedSetting, WorkerFault,
                     fault_boundary, is_device_fault)
from .frontend.declcache import configure as configure_decl_cache
from .frontend.declcache import global_cache, publish_metrics
from .obs import flight as obs_flight
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .runtime.applier import _normalize_relpath, apply_ops, touched_paths
from .runtime.emitter import PRETTIER_EXTENSIONS, emit_files
from .frontend.snapshot import annotate_residency
from .runtime.git import (archive_bytes, checkout_tree_to_temp, collision_safe_scope,
                          commit_timestamp_iso, diff_scope, merge_scope, resolve_rev,
                          snapshot_from_bytes, temp_tree, tree_oid)
from .runtime.inplace import commit_tree_inplace, recover, repo_lock
from .runtime.notes import notes_get, notes_put
from .runtime.textmerge import apply_text_fallback
from .runtime.trace import Tracer
from .runtime.verify import typecheck_ts
from .service import residency
from .service.resilience import breakers
from .utils import reqenv, workdir
from .utils.loggingx import logger

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
        p.add_argument("--trace", action="store_true",
                       help="Write .semmerge-trace.json and .semmerge-events.jsonl")
        p.add_argument("--profile", metavar="DIR", default=None,
                       help="Capture a torch.profiler trace into DIR (phases "
                            "annotated as semmerge/<phase> ranges)")
        p.add_argument("--change-signature", action="store_true",
                       help="Detect changeSignature ops instead of delete+add "
                            "(also [engine].change_signature in .semmerge.toml)")
        p.add_argument("--signature-matcher", action="store_true",
                       help="Pair renamed+retyped decls by embedding "
                            "similarity (also [engine].signature_matcher)")
        p.add_argument("--backend", default=None,
                       help="Engine, as the JAX CLI names it (overrides "
                            "[engine].backend): tpu, ts_tpu, host, ts_host run "
                            "this port's engine on its device; java, cs, "
                            "csharp the C-family engine; subprocess, worker "
                            "the engine in a supervised child process; any "
                            "other name falls back to host with a warning")
    p_rebase = sub.add_parser("semrebase",
                              help="Replay a commit's stored op log onto a revision")
    p_rebase.add_argument("commit", help="Commit whose semmerge note holds the op log")
    p_rebase.add_argument("onto", help="Revision to replay onto")
    p_rebase.add_argument("--inplace", action="store_true")
    for p in (p_diff, p_merge, p_rebase):
        p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                       help="Where to run (default: cuda; cpu only when asked)")
    p_serve = sub.add_parser("serve",
                             help="Run the warm-state merge service daemon on a "
                                  "unix socket")
    p_serve.add_argument("--socket", default=None,
                         help="Unix socket path or tcp://host:port (tcp://host:0 "
                              "picks an ephemeral port; mTLS via "
                              "SEMMERGE_FLEET_TLS_*). Default: SEMMERGE_SERVICE_SOCKET, "
                              "else $XDG_RUNTIME_DIR/semmerge-torch.sock, else "
                              "/tmp/semmerge-torch-<uid>.sock")
    p_serve.add_argument("--join", default=None, metavar="ROUTER",
                         help="Announce this daemon to a fleet router (unix path or "
                              "tcp://host:port) and keep re-announcing every "
                              "SEMMERGE_FLEET_JOIN_INTERVAL seconds")
    p_serve.add_argument("--advertise", default=None, metavar="ADDR",
                         help="Address the router should dial this member on "
                              "(default: the bound --socket)")
    p_serve.add_argument("--capacity", type=int, default=None,
                         help="Relative capacity announced in the join handshake "
                              "(default 1)")
    p_serve.add_argument("--member-id", default=None,
                         help="Stable member id to join as (default: router-assigned "
                              "r1, r2, ...)")
    p_serve.add_argument("--workers", type=int, default=None,
                         help="Executor threads (SEMMERGE_SERVICE_WORKERS, default 4)")
    p_serve.add_argument("--queue", type=int, default=None,
                         help="Admission queue bound (SEMMERGE_SERVICE_QUEUE, default "
                              "16); a full queue rejects with a typed WorkerFault, "
                              "exit 12")
    p_serve.add_argument("--idle-exit", type=float, default=None,
                         help="Exit after this many idle seconds "
                              "(SEMMERGE_SERVICE_IDLE_EXIT, default 900; 0 disables)")
    p_serve.add_argument("--events", default=None,
                         help="Write the daemon's span/event stream to this JSONL "
                              "path on exit")
    p_serve.add_argument("--status", action="store_true",
                         help="Query a running daemon's status and exit "
                              "(does not start one)")
    p_serve.add_argument("--supervise", action="store_true",
                         help="Run under a supervisor that respawns a crashed "
                              "daemon with capped backoff")
    p_serve.add_argument("--device", choices=("cuda", "cpu"), default=None,
                         help="The daemon's device (default: cuda; cpu only when asked)")
    p_serve.add_argument("--fleet", action="store_true",
                         help="With --status against a fleet router: include every "
                              "member's status block, aggregated through the router")
    p_fleet = sub.add_parser(
        "fleet",
        help="Run a fault-tolerant routing tier over N supervised merge daemons: "
             "consistent-hash repo affinity, health-aware failover, a durable "
             "dispatch WAL, and hedged reads")
    p_fleet.add_argument("--socket", default=None,
                         help="Client-facing unix socket or tcp://host:port (same "
                              "resolution chain as serve; mTLS via "
                              "SEMMERGE_FLEET_TLS_*); local members bind <socket>.m0, "
                              ".m1, ...")
    p_fleet.add_argument("--members", type=int, default=None,
                         help="Local member daemons to supervise (SEMMERGE_FLEET_MEMBERS, "
                              "default 3; 0 = pure-remote fleet serving only members "
                              "that `serve --join` in)")
    p_fleet.add_argument("--workers", type=int, default=None,
                         help="Executor threads per member (SEMMERGE_SERVICE_WORKERS, "
                              "default 4)")
    p_fleet.add_argument("--queue", type=int, default=None,
                         help="Admission queue bound per member")
    p_fleet.add_argument("--wal-dir", default=None,
                         help="Dispatch WAL directory (SEMMERGE_FLEET_WAL_DIR, default "
                              "<socket>.semmerge-fleet-wal/)")
    p_fleet.add_argument("--status", action="store_true",
                         help="Query a running router's status and exit")
    p_fleet.add_argument("--drain", default=None, metavar="MEMBER",
                         help="Drain one member (e.g. m1) out of a running fleet and "
                              "exit; 'all' drains the router itself")
    p_fleet.add_argument("--leave", default=None, metavar="MEMBER",
                         help="Remove a joined remote member (by id or advertised "
                              "address) from a running fleet and exit")
    p_fleet.add_argument("--device", choices=("cuda", "cpu"), default=None,
                         help="The members' device (default: cuda; cpu only when "
                              "asked); the router itself never touches it")
    p_train = sub.add_parser("train-matcher",
                             help="Train the decl-similarity matcher (torch "
                                  "checkpoints; resumes from the latest)")
    p_train.add_argument("--steps", type=int, default=200)
    p_train.add_argument("--batch", type=int, default=32)
    p_train.add_argument("--seq", type=int, default=64)
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--ckpt-dir", default=None)
    p_train.add_argument("--ckpt-every", type=int, default=50)
    p_train.add_argument("--no-resume", action="store_true")
    p_train.add_argument("--eval", action="store_true",
                         help="After training, report held-out pairing "
                              "precision/recall (models.evaluate)")
    p_train.add_argument("--device", choices=("cuda", "cpu"), default=None,
                         help="Where to run (default: cuda; cpu only when asked)")
    from .obs import report
    report.add_parsers(sub)
    return parser


_MATCHERS: Dict[tuple, object] = {}


def _signature_matcher(args, engine, change_sig: bool, device):
    """The embedding matcher when enabled (CLI flag or config): loaded
    once per process and setting, so the merge service keeps it warm."""
    if not (change_sig and (args.signature_matcher or engine.signature_matcher)):
        return None
    key = (engine.signature_threshold, engine.matcher_ckpt_dir, str(device))
    matcher = _MATCHERS.get(key)
    if matcher is None:
        from .models.signature import EmbeddingSignatureMatcher
        matcher = _MATCHERS[key] = EmbeddingSignatureMatcher(
            threshold=engine.signature_threshold, ckpt_dir=engine.matcher_ckpt_dir,
            device=device)
    return matcher


@dataclass
class SemdiffResult:
    ops: List[Op]
    #: The embedding matcher the diff used, or None.
    matcher: object | None
    #: Seconds per phase: snapshot, then the backend's phases.
    phases: Dict[str, float] = field(default_factory=dict)
    #: The run's tracer, closed; ``tracer.write()`` writes its artifacts
    #: (``main`` does, after printing the op log, as the JAX CLI does).
    tracer: Tracer | None = None


def _refuse(refused: List[str]) -> None:
    if refused:
        raise UnsupportedSetting(
            f"{', '.join(refused)}: not implemented by this port (it would change the "
            "JAX package's output); unset it or use python -m semantic_merge_tpu",
            stage="config")


def _load_config(command: str, backend: str | None = None):
    """The ``.semmerge.toml`` in force, with ``--backend`` (``backend``)
    resolved into ``engine.backend`` and the decl cache's budget applied;
    raises :class:`UnsupportedSetting` on a refused setting."""
    config = load_config()
    _refuse(refused_settings(config, command))
    config.engine.backend = resolve_backend(config, backend)
    configure_decl_cache(config.core.memory_cap_mb)
    return config


def _build_backend(name: str, config, device: str | None):
    """The engine ``name`` on ``device`` (the JAX CLI's
    ``_resolve_backend``): the registry's backend
    (:func:`~semantic_merge_tpu_torch.backends.base.get_backend`), wrapped
    with one backend per language ``config`` enables beyond TypeScript
    (:func:`~semantic_merge_tpu_torch.backends.multi.route_backends`),
    then configured from ``config`` (``[engine] worker_cmd``)."""
    backend = get_backend(name, device=device, host_workers=config.engine.host_workers)
    backend = route_backends(backend, config, device=device) or backend
    configure = getattr(backend, "configure", None)
    if configure is not None:
        configure(config)
    return backend


def _tracer(args: argparse.Namespace, device) -> Tracer:
    """The run's tracer: ``--trace`` / ``--profile DIR``, profiling the
    card's activity unless the run is on the CPU."""
    return Tracer(enabled=args.trace, profile_dir=args.profile, cuda=device.type == "cuda")


def _annotate_base(snap, rev: str, scope=None) -> None:
    """Key the base snapshot into the warm residency cache (inside the
    merge service; the JAX CLI's ``annotate_residency`` calls), with its
    incremental ``scope``: the base tree repeats across a repository's
    merges, so a daemon serving the repeats skips its scan, encode and
    h2d copy. The enabled check comes first, so one-shot runs make no
    extra ``rev-parse``."""
    if residency.residency_enabled():
        annotate_residency(snap, str(workdir.current()), tree_oid(rev), scope=scope)


def _snapshots(config, tars, base: str, scope_of):
    """The snapshots of ``tars`` (the base's first) and their scope, as
    the JAX CLI's ``cmd_semdiff`` and ``_semantic_attempt`` make them.
    Under ``[engine] incremental`` (default on) every engine scans only
    the files either side touched (``scope_of()`` is
    :func:`~semantic_merge_tpu_torch.runtime.git.merge_scope` or
    ``diff_scope``); the collision guard falls back to the full tree,
    with the JAX CLI's log line, when a scoped symbolId has an
    out-of-scope twin (the restriction could change which occurrence a
    join keeps). The full tars still feed extract, apply and the text
    layer; the base's residency annotation carries the scope, whose
    fingerprint keeps a scoped and a full base apart."""
    scope = scope_of() if config.engine.incremental else None
    snaps = [snapshot_from_bytes(tar, paths=scope) for tar in tars]
    if scope is not None and collision_safe_scope(scope, tars[0], resolve_rev(base),
                                                  snaps) is None:
        logger.info("incremental scope disabled: a scoped symbolId has an out-of-scope twin")
        scope = None
        snaps = [snapshot_from_bytes(tar) for tar in tars]
    _annotate_base(snaps[0], base, scope)
    return snaps, scope


def semdiff(args: argparse.Namespace) -> SemdiffResult:
    """Run ``semdiff`` for parsed ``args`` in the working directory: the
    ``snapshot`` and ``diff`` phases of the JAX CLI's ``cmd_semdiff``."""
    full = _load_config("semdiff", args.backend)
    config = full.engine
    backend = _build_backend(config.backend, full, args.device)
    change_sig = args.change_signature or config.change_signature
    matcher = _signature_matcher(args, config, change_sig, backend.device)
    tracer = _tracer(args, backend.device)
    try:
        t0 = time.perf_counter()
        with tracer.phase("snapshot"):
            (base_snap, right_snap), _ = _snapshots(
                full, [archive_bytes(rev) for rev in (args.rev1, args.rev2)], args.rev1,
                lambda: diff_scope(args.rev1, args.rev2))
        phases = {"snapshot": time.perf_counter() - t0}
        with tracer.phase("diff"):
            ops = backend.diff(base_snap, right_snap,
                               base_rev=resolve_rev(args.rev1),
                               timestamp=commit_timestamp_iso(args.rev2),
                               change_signature=change_sig,
                               signature_matcher=matcher,
                               statement_ops=args.statement_ops or config.statement_ops)
    finally:
        backend.close()
        tracer.close()
    phases.update(backend.phases)
    return SemdiffResult(ops=ops, matcher=matcher, phases=phases, tracer=tracer)


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


def _conflicts_path() -> pathlib.Path:
    return workdir.root() / CONFLICTS_ARTIFACT


def _write_conflict_reports(conflicts, resolutions=None) -> None:
    _conflicts_path().write_text(
        json.dumps(conflicts_payload(conflicts, resolutions), indent=2), encoding="utf-8")


def _strict_mode(args: argparse.Namespace) -> bool:
    """Fail-fast mode: ``--no-degrade`` or ``SEMMERGE_STRICT=1`` (read
    through the request overlay, so a daemon request carries its
    client's posture)."""
    return (getattr(args, "no_degrade", False)
            or (reqenv.get("SEMMERGE_STRICT", "") or "").strip() == "1")


def _fail_fast(fault: MergeFault, command: str = "semmerge") -> int:
    """Report a fault that ends the command; returns its exit code. It
    counts in ``merge_faults_total{fault,stage}`` and leaves a
    ``fault-escape`` postmortem bundle (the flight ring, the fault
    chain, the registry) beside the repository, keyed by the trace id
    that ends the stderr line."""
    traceback.print_exception(fault, file=sys.stderr)
    obs_metrics.REGISTRY.counter(
        "merge_faults_total",
        "Merge runs failed on a contained fault, by fault and stage",
    ).inc(1, fault=type(fault).__name__, stage=fault.stage)
    tid = obs_spans.trace_id() or obs_flight.default_trace_id()
    obs_flight.dump(tid, "fault-escape", fault=fault, breakers=breakers().snapshot(),
                    root=workdir.root())
    print(f"{command}: {fault.describe()} (exit {fault.exit_code}) [trace {tid}]",
          file=sys.stderr)
    return fault.exit_code


def _record_degradation(frm: str, to: str, fault: MergeFault, tracer: Tracer) -> None:
    """One ladder rung transition: the log line,
    ``merge_degradations_total{from,to,fault}``, a ``degradation`` span,
    a ``degradation`` postmortem bundle and the trace's
    ``degradations`` counter. The bundle carries the breakers' states
    (empty with the breakers off: one-shot, ``SEMMERGE_BREAKER`` unset)."""
    name = type(fault).__name__
    logger.warning("merge degrading %s -> %s after %s", frm, to, fault.describe())
    obs_metrics.REGISTRY.counter(
        "merge_degradations_total",
        "Degradation-ladder rung transitions, by fault",
    ).inc(1, **{"from": frm, "to": to, "fault": name})
    obs_spans.record("degradation", 0.0, layer="cli",
                     **{"from": frm, "to": to, "fault": name, "stage": fault.stage})
    obs_flight.dump(obs_spans.trace_id(), "degradation", fault=fault,
                    breakers=breakers().snapshot(), root=workdir.root(),
                    extra={"degradation": {"from": frm, "to": to}})
    tracer.count("degradations", tracer.counters.get("degradations", 0) + 1)


def semmerge(args: argparse.Namespace) -> SemmergeResult:
    """Run ``semmerge`` for parsed ``args`` in the working directory (the
    JAX CLI's ``cmd_semmerge``): recovery of an interrupted commit, then
    the degradation ladder under the run's :class:`Tracer`, whose
    artifacts are written on every exit path. A fault that ends the
    merge is reported here (:func:`_fail_fast`) and its code returned."""
    device = resolve_device(args.device)  # no device: raises here
    from . import batch
    if batch.posture() == "require" and batch.current() is None:
        # Outside the merge service no scheduler ever runs: fail before
        # anything is read or recovered (the JAX CLI's host rung would
        # merge such a run; the port has no host rung).
        raise BatchFault("SEMMERGE_BATCH=require but no batch scheduler is active "
                         "(batching runs in the merge service: serve)", stage="batch")
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
    config = _load_config("semmerge", args.backend)
    logger.info("Starting semantic merge base=%s A=%s B=%s", args.base, args.a, args.b)
    if args.inplace:
        # A journal/stage left by an interrupted --inplace commit is
        # resolved before this merge touches anything.
        with repo_lock():
            recover()
    tracer = _tracer(args, device)
    try:
        return _merge_ladder(args, config, tracer)
    finally:
        tracer.write()
        publish_metrics()


def _breaker_open_fault(rung: str) -> MergeFault:
    return WorkerFault(f"circuit breaker open for rung {rung!r}: "
                       f"skipping without an attempt", stage="breaker",
                       cause="breaker-open")


def _merge_ladder(args: argparse.Namespace, config, tracer: Tracer) -> SemmergeResult:
    """The degradation ladder of the JAX package's ``cli._merge_ladder``.
    The semantic attempt on the engine in force runs first. The port's
    TypeScript engine (rung ``torch``) has no rung below it but the text
    rung: the JAX host rung would run the same engine on the same device.
    Every other engine (``subprocess``/``worker``, ``java``, ``cs``, a
    routed ``multi``) has the JAX middle rung, ``host``: the port's
    engine on the same device, re-resolved with the config's language
    routing. A :class:`MergeFault` moves the merge one rung down,
    recorded as a degradation, unless strict mode is on or it is a
    device fault (:func:`~semantic_merge_tpu_torch.errors.is_device_fault`):
    then the merge fails fast with the fault's code, as it does when the
    textual rung itself fails.

    Each rung consults its circuit breaker under its JAX rung name
    (:mod:`semantic_merge_tpu_torch.service.resilience`; a no-op outside
    the merge service unless ``SEMMERGE_BREAKER=on``): an open breaker
    skips the rung without an attempt, recorded as a degradation with
    ``cause="breaker-open"`` (exit 12 in strict mode on the first rung).
    A result (0, 1, 2, 17) counts as the rung's success, a fault that
    degrades as its failure; a device fault does not count, since it
    never degrades and must not open a way around the device."""
    board = breakers()
    backend = _build_backend(config.engine.backend, config, args.device)
    rungs = [backend.name] + (["host"] if backend.name != TorchTSBackend.name else [])
    for i, rung in enumerate(rungs):
        below = rungs[i + 1] if i + 1 < len(rungs) else "text"
        if not board.allow(rung):
            if i == 0:
                backend.close()
            fault = _breaker_open_fault(rung)
            if i == 0 and _strict_mode(args):
                return SemmergeResult(code=_fail_fast(fault))
            _record_degradation(rung, below, fault, tracer)
            continue
        try:
            if i > 0:
                with fault_boundary("merge"):
                    backend = _build_backend("host", config, args.device)
            try:
                out = _semantic_attempt(args, config, backend, tracer)
            finally:
                backend.close()
            board.record_success(rung)
            return out
        except MergeFault as fault:
            if is_device_fault(fault):
                return SemmergeResult(code=_fail_fast(fault))
            board.record_failure(rung)
            if _strict_mode(args):
                return SemmergeResult(code=_fail_fast(fault))
            _record_degradation(rung, below, fault, tracer)
    t0 = time.perf_counter()
    try:
        code = _textual_rung(args, tracer)
    except MergeFault as fault:
        return SemmergeResult(code=_fail_fast(fault))
    return SemmergeResult(code=code, phases={"text_merge": time.perf_counter() - t0})


def _semantic_attempt(args: argparse.Namespace, config, backend,
                      tracer: Tracer) -> SemmergeResult:
    """The semantic rung (the JAX package's ``cli._semantic_attempt``).
    Returns the merge's result (exit 0, 1 or 2, or 17 under ``--resolve
    require``); raises :class:`MergeFault` when a stage fails, each
    stage inside a :class:`~semantic_merge_tpu_torch.errors.fault_boundary`
    that classifies its unexpected exceptions. In strict conflict mode
    the op logs come from the backend's ``build_and_diff``, the strict
    detection drops the conflicting ops from both, and the backend's
    compose merges the rest, its conflicts appended to the strict ones.
    Otherwise the merge runs through
    :func:`~semantic_merge_tpu_torch.backends.base.run_merge`: the
    TypeScript engine's ``merge``, or ``build_and_diff`` then ``compose``
    for the engines without one (C-family, routed, the worker).

    The tracer's phases and counters are the JAX CLI's: ``snapshot``,
    ``merge`` (or ``build_and_diff`` and ``compose``), ``resolve``,
    ``materialize``, ``format``, ``typecheck``, ``notes``; the in-place
    commit is its own spans. ``out.phases`` keeps the port's finer
    split (extract, apply, text, commit) from the same clock."""
    engine = config.engine
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

    with tracer.phase("snapshot"), fault_boundary("snapshot"):
        base_tar, left_tar, right_tar = (archive_bytes(rev) for rev in (args.base, args.a, args.b))
        snaps, scope = _snapshots(config, (base_tar, left_tar, right_tar), args.base,
                                  lambda: merge_scope(args.base, args.a, args.b))
        if scope is not None:
            tracer.count("scope_files", len(scope))
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
    if strict:
        with tracer.phase("build_and_diff", backend=backend.name), fault_boundary("merge"):
            out.result = backend.build_and_diff(*snaps, **kw)
        phases.update(backend.phases)
        t = time.perf_counter()
        with tracer.phase("compose"), fault_boundary("merge"):
            with obs_spans.span("strict_detect", layer="core",
                                n_a=len(out.result.op_log_left),
                                n_b=len(out.result.op_log_right)):
                ops_left, ops_right, out.conflicts = detect_conflicts_strict(
                    out.result.op_log_left, out.result.op_log_right)
            lap("strict_detect")
            out.composed, walk_conflicts = backend.compose(ops_left, ops_right)
            out.conflicts.extend(walk_conflicts)
        lap("compose")
    else:
        with tracer.phase("merge", backend=backend.name), fault_boundary("merge"):
            out.result, out.composed, out.conflicts = run_merge(backend, *snaps, **kw)
        phases.update(backend.phases)
    tracer.count("ops_left", len(out.result.op_log_left))
    tracer.count("ops_right", len(out.result.op_log_right))
    cache = global_cache()
    tracer.count("decl_cache_hits", cache.hits)
    tracer.count("decl_cache_misses", cache.misses)
    tracer.count("composed_ops", len(out.composed))
    tracer.count("conflicts", len(out.conflicts))
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
                with tracer.phase("resolve"), fault_boundary("resolve"):
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
        _conflicts_path().unlink(missing_ok=True)

    merged_tree = None
    try:
        with tracer.phase("materialize"), fault_boundary("apply"):
            with temp_tree(base_tar) as base_tree:
                lap("extract")
                # The TypeScript engine: the merge's reorderImports
                # lists materialize as one batched device program.
                merged_tree = apply_ops(base_tree, out.composed,
                                        device_crdt=getattr(backend, "device_crdt", False),
                                        device=backend.device)
            lap("apply")
            deleted_paths: list = []
            text_written: list = []
            if engine.text_fallback:
                # Files outside the backend's extensions merge textually.
                text_conflicts, deleted_paths, text_written = apply_text_fallback(
                    merged_tree, base_tar, left_tar, right_tar,
                    indexed_extensions=backend.extensions)
                lap("text")
                tracer.count("text_conflicts", len(text_conflicts))
                if text_conflicts:
                    out.conflicts = text_conflicts
                    _write_conflict_reports(text_conflicts, out.resolutions)
                    out.code = 1
                    return out
        with tracer.phase("format"), fault_boundary("format"):
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
        with tracer.phase("typecheck"), fault_boundary("verify"):
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
        with tracer.phase("notes"):
            notes_put(resolve_rev(args.a), OpLog(out.result.op_log_left))
            notes_put(resolve_rev(args.b), OpLog(out.result.op_log_right))
        lap("notes")
        logger.info("Merge complete")
        return out
    finally:
        if merged_tree is not None:
            shutil.rmtree(merged_tree, ignore_errors=True)


def _textual_rung(args: argparse.Namespace, tracer: Tracer) -> int:
    """The ladder's floor: a whole-tree textual three-way merge — every
    file through :func:`runtime.textmerge.apply_text_fallback` with an
    EMPTY indexed set, i.e. git-equivalent three-way semantics for the
    whole tree. No semantic engine, no formatter, no typecheck, no
    notes: "never worse than ``git merge``". Its phase is ``text_merge``."""
    with tracer.phase("text_merge"), fault_boundary("apply"):
        base_tar, left_tar, right_tar = (archive_bytes(rev) for rev in (args.base, args.a, args.b))
        with temp_tree(base_tar) as merged_tree:
            conflicts, deleted_paths, _written = apply_text_fallback(
                merged_tree, base_tar, left_tar, right_tar,
                indexed_extensions=frozenset())
            tracer.count("text_conflicts", len(conflicts))
            if conflicts:
                _write_conflict_reports(conflicts)
                return 1
            _conflicts_path().unlink(missing_ok=True)
            if args.inplace:
                with fault_boundary("commit"):
                    with repo_lock():
                        commit_tree_inplace(merged_tree, deletes=deleted_paths)
    logger.info("Merge complete (textual fallback)")
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


def serve(args: argparse.Namespace) -> int:
    """Start (with ``--status``, query; with ``--supervise``, supervise)
    the merge service daemon. The daemon resolves its device before it
    binds: without a card (and without ``--device cpu``) it raises
    :class:`DeviceUnavailable`, which :func:`main` turns into exit 11."""
    from .service import client as service_client
    _refuse(refused_environment("serve"))
    if args.status:
        method = "member_status" if args.fleet else "status"
        try:
            status = service_client.call_control(method, path=args.socket)
        except service_client.DaemonUnavailable as exc:
            print(f"semmerge serve: no daemon running ({exc})", file=sys.stderr)
            return 1
        print(json.dumps(status, indent=2, default=str))
        return 0
    if args.supervise:
        resolve_device(args.device)  # no card: exit 11 before any child starts
        from .service.supervisor import Supervisor, serve_argv
        return Supervisor(serve_argv(args)).run()
    from .service.daemon import Daemon
    daemon = Daemon(socket_path=args.socket, workers=args.workers,
                    queue_size=args.queue, idle_exit=args.idle_exit,
                    events_path=args.events, device=args.device, join=args.join,
                    advertise=args.advertise, capacity=args.capacity,
                    member_id=args.member_id)
    return daemon.serve_forever()


def fleet(args: argparse.Namespace) -> int:
    """Start (or query, drain, or remove a member of) the fleet router,
    as the JAX CLI's ``cmd_fleet``. Before the router binds or spawns a
    member, the members' device is checked in this process (no card and
    no ``--device cpu``: :class:`DeviceUnavailable`, exit 11); the check
    asks only whether CUDA is available, which makes no CUDA context,
    and the router module imports no torch."""
    from .service import client as service_client
    control = None
    if args.status:
        control = ("status", {})
    elif args.drain:
        control = ("drain", {} if args.drain == "all" else {"member": args.drain})
    elif args.leave:
        control = ("leave", {"member": args.leave})
    if control is not None:
        try:
            result = service_client.call_control(control[0], params=control[1],
                                                 path=args.socket)
        except service_client.DaemonUnavailable as exc:
            print(f"semmerge fleet: no router running ({exc})", file=sys.stderr)
            return 1
        print(json.dumps(result, indent=2, default=str))
        return 0 if result.get("fleet" if args.status else "ok") else 1
    resolve_device(args.device)
    from .fleet.router import FleetRouter
    router = FleetRouter(socket_path=args.socket, members=args.members,
                         workers=args.workers, queue_size=args.queue,
                         wal_dir=args.wal_dir, device=args.device or "cuda")
    return router.serve_forever()


def train_matcher(args) -> int:
    """``train-matcher``: the JAX CLI's ``cmd_train_matcher``, on
    ``--device`` (the card unless ``cpu``; without one,
    :class:`DeviceUnavailable` before any step)."""
    from .models.training import TrainConfig, train_matcher as train
    device = resolve_device(args.device)
    cfg = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                      seed=args.seed, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    _, _, loss, ran = train(cfg, device, resume=not args.no_resume)
    where = f", checkpoints in {args.ckpt_dir}" if args.ckpt_dir else ""
    if ran == 0:  # e.g. resumed at or past --steps
        print(f"nothing to do: checkpoint already at step {args.steps}{where}")
    else:
        print(f"trained {ran} steps, final loss {loss:.4f}{where}")
    if args.eval:
        # Held-out pairing precision/recall, from the checkpoint just
        # written (or seeded params when no --ckpt-dir — reported with
        # trained=false so the number cannot masquerade as quality).
        from .models.evaluate import evaluate_matcher
        from .models.signature import EmbeddingSignatureMatcher
        matcher = EmbeddingSignatureMatcher(ckpt_dir=args.ckpt_dir,
                                            allow_untrained=True, device=device)
        print(json.dumps({"matcher_eval": evaluate_matcher(matcher)}))
    return 0


_LAST = threading.local()


def last_phases() -> Dict[str, float] | None:
    """The seconds per phase of the last ``semdiff`` or ``semmerge`` that
    :func:`main` ran on this thread (``None`` if it failed or ran
    another command): the merge service returns them with the request."""
    return getattr(_LAST, "phases", None)


def main(argv: Sequence[str] | None = None, *, delegate: bool = True) -> int:
    """The CLI. With ``delegate`` (the default) a merge-shaped command
    goes to a warm daemon first, under ``SEMMERGE_DAEMON=auto|require``
    (:func:`semantic_merge_tpu_torch.service.client.delegate`); the
    package's ``__main__`` delegates before importing this module and
    passes ``delegate=False``, as does the daemon itself."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if delegate:
        from .service import client as service_client
        code = service_client.delegate(argv)
        if code is not None:
            return code
    if args.command in ("semdiff", "semmerge", "semrebase"):
        # Only the process that does the merge, and only for the
        # one-shot merge verbs (the daemon turns it off for itself).
        from .utils.gctune import tune_for_merge
        tune_for_merge()
    try:
        if args.command in ("stats", "trace", "profile", "perf", "top"):
            from .obs import report
            return report.run(args)
        if args.command == "serve":
            return serve(args)
        if args.command == "fleet":
            return fleet(args)
        if args.command == "train-matcher":
            return train_matcher(args)
        _refuse(refused_environment(args.command))
        _LAST.phases = None
        if args.command == "semmerge":
            merged = semmerge(args)
            _LAST.phases = merged.phases
            return merged.code
        if args.command == "semrebase":
            return semrebase(args)
        result = semdiff(args)
        _LAST.phases = result.phases
    except DeviceUnavailable as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2 if args.command in ("semdiff", "train-matcher") else EXIT_NO_DEVICE_MERGE
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
    result.tracer.write()
    return 0
