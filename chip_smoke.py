#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``semantic_merge_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure, each printing its seconds:

1. probe: CUDA must be available; prints the card's name, power limit
   and maximum SM clock.
2. build: compiles every kernel of the port (``kernels/*.cu``), one
   nvcc per source, all started together, for sm_90a; prints ptxas's
   registers and spills (fails on a spill) and, where the toolkit has
   cuobjdump, SASS counts per kernel: the instruction total, the ALU-
   and FMA-pipe totals, HMMA, LDSM, LDGSTS and LDS for ``flash_chunk``
   (fails without HMMA), HMMA, LDSM, LDGSTS, FFMA, LDS, STS, LDG, STG and
   MUFU for ``flash_chunk_bwd`` (fails without HMMA: its five products
   run on the tensor cores), SHF, LOP3, IADD3, PRMT,
   ISETP and IMAD for
   ``sha256`` (fails without SHF, the rotates; its bound in phase 5 is
   counted from these, so it fails there without cuobjdump). Then
   ``g++`` builds the native scanner
   (``frontend/semmerge_native.cpp``), then the C op factory
   (``frontend/opfactory.c``, against the interpreter's headers), which
   must load; prints their build seconds.
2b. train, before any matcher runs: ``train-matcher --steps 200
   --ckpt-dir DIR --ckpt-every 100 --eval`` in this process at the
   default width (batch 32, seq 64): exit 0, its two output lines, a
   finite loss lower at step 200 than at step 1 (printed every 20 steps),
   1,600 ``flash_chunk`` and 1,600 ``flash_chunk_bwd`` launches in the
   training (8 a step) and no ``sha256``, ``matcher_eval`` with
   ``trained`` true, the checkpoint in DIR loading through
   ``EmbeddingSignatureMatcher``; ms per step and the idle share over
   steps 101-120 (torch.profiler), and the host ms per step over the
   same steps in each part of a step: the batch's tokenization, its h2d
   copy, the forward, ``backward()``, AdamW's ``step()`` (host clock,
   the loop's seams wrapped from here; two checkpoints, each timed, fall
   outside the window), then the same parts as torch.profiler CPU
   ranges over steps 21-40 of a separate 40-step run; the first 3 losses equal the CPU
   plain path's from the same initial weights within 2e-2; then 20 steps
   with ``moe_mode="topk"`` through the Python API: finite, falling, 8 +
   8 launches a step. The merges below keep the seeded checkpoint.
3. repo: a git repository of the bench's ``synth_repo`` shape at its
   rung5 size (10,000 files x 4 decls): the side branch renames
   functions in every even file and renames AND retypes the first
   function of 256 other files, and the other branch moves every 4th
   file to ``lib/``. Beside it a repository of the same shape at the
   bench's rung3 size (1,000 files x 6 decls, side and other alike) for
   the strict, driver, resolve and concurrent service merges: its stmt
   branch edits the body of the last function of every 3rd file, its drv branch
   renames the last function of every 16th file (63), and its rsv_base
   gives the last function of every 4th file (250) a three-line body
   whose first line rsv_a edits and whose second rsv_b edits. A matcher
   checkpoint from the port's seeded (untrained) initializer. One ``git
   fast-import`` writes every branch's commit of a repository; only
   side's tree is written to disk, by its checkout.
4. Five runs of the port's CLI functions, each under a torch.profiler
   trace (wall, phases, device busy time and idle share), with the decl
   cache emptied and the launch counts and shapes set to 0 just before
   and read just after; each must scan with the native scanner (its
   scan seconds and the cache's hits and misses printed):
   - matcher semdiff: ``semdiff base side --json-out --change-signature
     --signature-matcher`` (the two-program path): 8 ``flash_chunk``
     launches, no ``sha256``, no ``flash_chunk_bwd`` (no merge path
     takes a gradient);
   - fused semdiff: ``semdiff base side --json-out``: the fused engine,
     ``sha256`` launched (2 on a cold engine), no ``flash_chunk``; op
     counts; every op id equals ``core/ids.py::deterministic_op_id``
     recomputed with hashlib on the host; the op log rendered on the
     card equals ``_json_rows``'s host rendering;
   - fused semmerge: ``semmerge base side other --inplace`` in a second
     work tree of the repository (``git worktree add``): exit 0, the
     fused path taken (the backend's phases hold ``fused`` and no
     ``compose``, the composed stream is a column-backed view), 4
     ``sha256`` launches, renames in every moved file, both README
     edits, each note's op count and bytes (device-rendered) equal to
     ``_json_rows``'s rendering, and ``compose_oplogs_device`` on the
     card over the materialized op logs equal to the fused composed
     stream; then each op log through the port's native C++ serializer
     and the Python one (both equal to the note) and through the C op
     factory and the Python builder (equal ops), each timed;
   - matcher semmerge: ``semmerge base side other --inplace
     --change-signature --signature-matcher`` in a work tree of the
     rung3 repository (its depth cut from rung5 to keep the smoke
     inside its time limit): the fused engine runs first (4
     ``sha256`` launches) and its result is set aside, since the matcher
     could pair deletes with adds; then the two-program path with 16
     ``flash_chunk`` launches; the tree and notes; then the device
     compose of its op logs on the card against the CPU, and timed
     alone;
   - strict semmerge: ``semmerge base side stmt --inplace
     --strict-conflicts --structured-apply --change-signature
     --signature-matcher`` in a work tree of the rung3 repository (its
     depth cut from rung5 to keep the smoke inside its time limit; 334
     body edits): no fused engine (0
     ``sha256``), 8 ``flash_chunk`` launches (the matcher refines A as
     in the matcher semdiff), exit 0 with no conflict, B's op log one
     ``editStmtBlock`` per edited body, every edited body and every
     function of side in the tree, both op logs in the notes.
5. kernels: each kernel's wrapper on the card at the shapes the paths
   launched it with (and edge shapes), held against its plain PyTorch
   version: ``flash_chunk`` within atol/rtol 2e-3 (normalised output
   and rebased row sums; bf16 inputs, f32 sums in another order; the
   plain f32 einsums run with TF32 off, and l = Lk on all-masked rows),
   ``flash_chunk_bwd`` within atol/rtol 1e-2 on dq, dk and dv (bf16
   outputs of f32 sums) at the training shape, the matcher's inference
   shapes (B=256 and 384) and edge shapes, all-masked rows sending no dq
   or dk, and a second launch on the same inputs bit-identical to the
   first (no atomics),
   ``sha256`` bit-exact and against hashlib (lengths 0, 1, 55, 56, 63,
   64, 119 and 120, capacities of 1-3 blocks, 1 row and a row count
   that is no multiple of the CTA). Timed at the path shapes: CUDA-event
   and host time per call, device time (torch.profiler), CUDA-graph
   back-to-back time, the plain version's time, and for ``flash_chunk``
   one library call (``scaled_dot_product_attention``, a yardstick
   only), for ``flash_chunk_bwd`` SDPA's backward (the same, at the
   training and inference shapes); the bound from this run's shapes
   (for the backward: q, k, v, O, dO, m, l, dq, dk, dv against its five
   products on the bf16 tensor cores). Then the fused merge and
   diff programs and the render program, on the inputs the fused paths
   gave them: device time, kernels and host time per call. With them the
   batched fused program (``ops/fused.py::batched_fused_program``) at
   B=4 on the fused semmerge's captured inputs (C = 32,768, four copies
   on the merge axis): each row byte-equal to the one-merge program's
   one-buffer row, the same ``sha256`` launches (2, over 4C rows each)
   and at most 1.1x the kernels of one one-merge call; its device ms,
   kernels and host ms per call printed beside the one-merge call's.
5a. crdt: 1,024 RGA lists of 1 to 64 elements with moves and
   tombstones through ``ops/crdt.py::materialize_batch`` on the card,
   equal to the host RGA's and to the same tensor code on the CPU; then
   1,024 ``reorderImports`` ops (files of 1 to 64 import lines) through
   the object applier with ``device_crdt`` on the card: one program
   launch, a tree equal to the host RGA's; the program timed as the
   fused programs are.
5b. trace (in-process, no profiler of this script around it): the
   fused semmerge of the rung3 repository, untraced (under this script's
   profiler, as in phase 4) in a work tree at side, then ``semmerge
   base side other --inplace --trace --profile DIR`` in another: exit 0,
   the tree and both notes equal the untraced merge's, as many
   ``sha256`` launches (each from a cold engine), ``.semmerge-trace.json``,
   ``.semmerge-events.jsonl``
   and ``DIR/semmerge-trace.json`` pass ``scripts/check_trace_schema.py``
   (``validate_trace``, ``validate_events``) with ``platform`` ``gpu``
   and the card's name in the device block, the span tree holds
   ``fused_merge``, ``apply_columnar`` and ``inplace_commit``, the
   profile in DIR holds one ``sha256`` kernel record per launch and a
   ``semmerge/<phase>`` range per CLI phase, and no profiler capture
   failed; then ``semdiff base side --json-out --change-signature
   --signature-matcher --profile DIR2``: 8 ``flash_chunk`` launches and
   8 records in its profile, its phase ranges, a valid
   ``DIR2/semmerge-trace.json``. Prints the traced merge's wall beside
   the untraced one's and each profile's size.
5c. scope: every run of phase 4 and the rung3 merge print their
   ``scope_files`` (the incremental scope's path count) beside their
   ``scan`` and ``encode`` seconds; the rung3 notes came from the native
   serializer (the device render below 4,096 rows is off). The rung3
   fused semmerge again in another work tree with ``[engine]
   incremental = false``: the scoped merge's tree and notes. A small
   repository whose collision guard falls back to the full tree (A
   renames a function beside one whose signature an untouched file
   shares): the fallback merge's tree and notes equal an unscoped
   merge's in a clone.
5d. mesh: the sharded programs (``ops/sharded.py``'s diff pair and
   compose, ``ops/fused.py::_fused_merge_sharded``) on phase 4's rung5
   inputs (the fused semmerge's decl columns, digests and capacity, and
   its two op logs): their bytes against the one-device
   programs' at k = 1 under an explicit one-rank NCCL group (its size-1
   axes are the identity: the programs run no collective there, and the
   port's ``agree_exit_code`` is checked as one real NCCL broadcast),
   and at k = 2 in two child processes of this script
   (``--mesh-rank``) joined over gloo with the ``SEMMERGE_*`` contract,
   both on ``cuda:0``; per program the host wall, the device's busy
   time and (k = 2) the collectives' share, and 2 ``sha256`` launches
   per rank in one fused merge. The port's own NCCL bring-up
   (``init_distributed`` for several ranks, one card each) needs a
   second card and does not run here. Then ``semmerge --inplace`` on the rung3 repository with
   ``[engine] mesh_shape = "dp=1"`` in process, and at world size 2
   (two CLI children, rank 1 in its own work tree): the one-device
   merge's tree and notes; rank 1 prints nothing and leaves its tree as
   it was; rank 0's trace shows the two-rank mesh. The batched program
   (phase 5's B = 4) over the batch mesh ``[cuda:0, cuda:0]``: the
   one-device rows. ``SEMMERGE_MESH=require`` merges (exit 0) and
   ``[engine] mesh = "require"`` exits 18 on a small repository, as the
   JAX CLI does on one device. (The service phase checks that the
   daemon's batch mesh reports posture ``auto`` and single-device
   fallbacks.) Prints the phase's seconds and the card.
5e. mesh model: the matcher's training step at full width (the default
   ``EncoderConfig``, ``train-matcher``'s batch 32 and sequence 64) from
   one set of seeded weights over three batches of its stream: on one
   device (soft and top-k: 8 ``flash_chunk`` and 8 ``flash_chunk_bwd``
   launches a step); ``make_sharded_train_step`` at k = 1 over an
   explicit one-rank NCCL group (the one-device losses exactly); and at
   k = 2 in one pair of child processes (``--mesh-model-rank``) joined
   over gloo on ``cuda:0``, which take three steps on each mesh in turn:
   ``sp=2`` ring (16 + 16 launches a step: two ring steps each way),
   ``sp=2`` Ulysses, ``dp=2``, ``tp=2``, ``pp=2``, ``ep=2`` with
   ``moe_mode="topk"`` (8 + 8), each loss within 2e-2 of the one-device
   step's and the same on both ranks. On the ring's mesh, first, the
   ring's output and dq, dk, dv through the kernels against the plain
   ring on the same CUDA tensors. Then ``train-matcher --steps 20`` as
   two ranks (``dp=2``): rank 0 prints the JAX CLI's line, rank 1
   nothing, and rank 0's checkpoint loads in a one-device
   ``EmbeddingSignatureMatcher``. Every kernel shape the phase launched
   that the kernels phase did not hold is held against its plain
   version here. Prints per mesh the ms per step, the collectives'
   share of the wall and the launches, beside the card's name and
   power limit.
6. driver merge (not in-process): ``git merge --no-ff drv`` on side in
   a clone of the rung3 repository, with ``python -m semantic_merge_tpu_torch.driver %O %A %B
   %P`` registered as ``merge.semmerge.driver`` for ``*.ts`` in
   ``.git/info/attributes``, the default engine settings (the fused
   engine) and ``SEMMERGE_DAEMON=off`` (the driver's default, ``auto``,
   would spawn a merge service daemon; phase 7b measures that): git
   exits 0 without degrading, the merge commit's tree is
   side's with drv's 63 renames, the work tree differs from it in
   exactly the files that side retyped or added a function to (35 in
   the rung3 repository, whatever drv renames: the engine's in-place
   tree, as the JAX driver leaves it), the latch
   exists, notes sit on both heads (drv's: 63 renames and their 63
   moves), git started the driver 63 times (its trace2 log, required),
   and a process other than this one held the card during the merge
   (the CLI child: the card's used memory up by 100 MiB or more);
   prints git's wall, the child's and the other starts'.
7. resolve semmerge, in-process and traced as in phase 4: ``semmerge
   rsv_base rsv_a rsv_b --inplace --strict-conflicts --resolve auto``
   in a work tree of the rung3 repository: exit 0,
   250 ConcurrentStmtEdit conflicts each ``accepted`` in
   ``.semmerge-conflicts.json`` with its four gates passed, both edits
   in every such file, no ``sha256`` or ``flash_chunk`` launch (strict
   mode skips the fused engine); prints the resolve phase and each
   gate's ms.
7a. languages: a mixed repository of the rung3 file count (500 TS
   files x 6 decls, 300 Java files x 8: a package line and one class
   with 2 fields, 1 constructor and 4 methods; 200 C# files x 8: a
   file-scoped namespace, a class with 2 auto-properties, 1 constructor
   and 3 methods, and a record struct; unique parameter lists, no method
   signature shared across languages, and the fields, constructors,
   classes and one property per C# file colliding within their language
   as real trees do). side renames the second method of every even Java
   file, ``Head`` of every even C# file and the first function of every
   16th TS file, and renames AND retypes the first method of 32 Java
   files; other moves every 4th Java and C# file to a sibling directory;
   side2 / other2 are a TS-only pair (renames of every 16th file, moves
   of every 4th). In-process under torch.profiler as in phase 4:
   ``semmerge base side other --inplace`` with ``[languages.java]`` and
   ``[languages.csharp]`` enabled and ``change_signature`` plus
   ``signature_matcher`` on the train phase's checkpoint: exit 0, no
   conflicts file, ops per language and type as the synthesis gives
   them (the renames, the moves their addresses make, the retypes as
   deleteDecl + changeSignature with an addDecl per deleteDecl), every
   rename and move in the tree, ``flash_chunk`` launched (the matcher
   refines the Java candidates) and ``sha256`` not (no fused engine on a
   routed merge); prints the TS, Java and C# scan seconds. Then
   ``semdiff base side --json-out --backend java`` and ``--backend cs``
   (no routing): only that language's ops, the synthesis's count. Then
   the worker seam, each in a ``git clone --local`` at side2 with the
   plain settings: ``semmerge base side2 other2 --inplace`` in process,
   ``--backend subprocess`` (the port's worker in a child process on the
   card; its ``_worker`` phases printed) and the same with
   ``SEMMERGE_FAULT=worker-serve:exit`` (one degradation to ``host``):
   exit 0 and the in-process tree and notes each time.
7b. service: ``python -m semantic_merge_tpu_torch serve --workers 4`` in
   a child (``SEMMERGE_BATCH_WINDOW_MS=2000``): it must come up, answer
   ``serve --status`` with the port's package and platform ``gpu``, and
   hold the card (used memory up 100 MiB or more while it serves the
   cold merge). All of it in the rung3 repository (its depth cut from
   rung5), against the references of phase 5b's untraced rung3 fused
   semmerge and of a fused and a matcher semdiff run in process just
   before. Then, ``SEMMERGE_DAEMON=require``: the cold ``semmerge
   base side other --inplace`` from a client process in a work
   tree whose ``.semmerge.toml`` turns the incremental scope off (a
   resident base is keyed by its scope; exit 0, tree and notes equal
   the scoped fused semmerge's, 1
   request and 4 ``sha256`` launches in the daemon's status); the warm
   ``semdiff base side --json-out`` (op log equal to the reference's, one
   residency hit; its scan and encode seconds printed beside the
   reference's); the matcher semdiff with ``--profile DIR`` (op log equal to
   the reference's, 8 ``flash_chunk`` records in DIR, 8 launches in the
   daemon); four ``--inplace`` clients at once in four ``git clone
   --local`` copies of the rung3 repository, each
   tree equal to a one-shot merge's, co-batched (``requests_batched``
   >= 2, ``mean_batch_size`` > 1); SIGTERM, a drain to exit 0. Prints
   each client's wall, the batch and residency stats. (The warm and
   matcher semdiffs go over the wire from this process, which reads the
   daemon's reply ``meta``.) The live tools, on the same daemon: it runs
   with ``SEMMERGE_OTLP_ENDPOINT`` at a loopback collector thread of
   this script, which must receive one ``/v1/traces`` payload per served
   request, each passing ``validate_export`` with the requests' trace
   ids left-padded to 32 digits, and ``otlp_exported_total{kind=
   "traces"}`` equal to it, no error, no drop (prints the conversion's
   microseconds per request); ``profile --daemon --seconds 2 --json
   --out DIR`` from a client process while warm fused semdiffs (no
   ``--profile``) are served: a bundle with the JAX bundle's keys and a
   trace of the daemon's process holding ``sha256`` kernel records
   (prints the kernel names and whether the executor threads' CPU ops
   are there); a capture beside the profiled matcher semdiff: both
   answer, its op log phase 4's (prints which one held the process's
   one profiler session); ``top --once --json``, ``top --once`` and
   ``perf record --daemon`` then ``perf compare --daemon`` (the baseline
   and ``SEMMERGE_BENCH_TRAJECTORY`` under the scratch directory; the
   checkout's ``PERF_BASELINE.json`` and ``BENCH_trajectory.jsonl``
   unchanged). After the drain, the one-shot GC posture: the fused
   semdiff at rung5 in child processes with ``SEMMERGE_GC_TUNE=0`` and
   as shipped, and the fused semmerge in two more rung3 clones as
   shipped and with ``=0``: byte-identical outputs (op log; exit code,
   stdout, tree, notes); prints every child's wall and its seconds per
   phase (``SEMMERGE_METRICS``).
7c. fleet, on a repository of the rung3 shape at 250 files (its depth
   cut from rung3's 1,000 files to keep the smoke inside its time
   limit): ``fleet --members 2`` (a router on
   a socket under the scratch directory, two members it supervises) and
   ``serve --socket tcp://127.0.0.1:0 --join SOCKET --member-id t0``,
   three CUDA processes beside this one; hedging pushed out of reach,
   so each request runs on its rendezvous owner. Prints each member's
   seconds from its start to the ring; every member's status must name
   the card (``stats --daemon --fleet``). Under
   ``SEMMERGE_FLEET=require``, from client processes in a clone whose
   owner is a supervised member: the fused ``semmerge base side other
   --inplace`` (exit code, tree and notes equal to this process's run of
   the same merge in another clone; the owner's ``sha256`` launches
   equal that run's) and the matcher semdiff (its op log; the owner's
   ``flash_chunk`` launches equal the in-process run's), the launches
   read from the members' status through the router. Then the owner is
   SIGKILLed: the next request (a fused semdiff over the wire) is
   answered by another member's pid, ``fleet_failovers_total`` >= 1.
   The TCP member drains, leaves (``fleet --drain t0``, ``--leave t0``)
   and drains to exit 0 on SIGTERM. With both supervised members back
   and drained (an empty ring), a ``semmerge --inplace`` client
   (``SEMMERGE_SERVICE_RETRIES=0``) is journaled; the router is
   SIGKILLed (the client exits 19, its tree untouched) and restarted:
   the replay runs the merge once (no dispatch before the kill; one
   dispatch, one ack, one payload; one request served by the new
   members; tree and notes the in-process merge's). Last a SIGTERM
   drains the router to exit 0, and no member process is left. Prints
   every wall beside the card's name and power limit.
7d. soak: the port's chaos soak (``python -m
   semantic_merge_tpu_torch.scripts.chaos_soak``, a child process) with
   a CUDA daemon (``serve --supervise`` on the card): 24 mixed requests
   (clean, degrade-scan, degrade-apply, strict-scan, resolve),
   concurrency 4, one daemon SIGKILL mid-soak; every invariant of the
   soak must hold (byte-exact settled trees, documented exits only, a
   respawned pid, the supervisor's restart count) within 240 s, and no
   process of it may be left; prints its report and wall.
8. reference: small inputs on the card and on the CPU must give
   identical op logs (a matcher semdiff) and identical exit codes,
   trees, conflicts and notes (fused semmerges, one with a
   DivergentRename conflict, which runs the host cursor walk, and a
   DivergentRename merge with --change-signature that takes the
   two-program path and its compose's host cursor walk), and three
   ``--strict-conflicts`` merges that report DeleteVsEdit,
   ConcurrentStmtEdit and ExtractVsInline, three ``--resolve auto``
   merges: a DivergentRename resolved for the side with a reference, a
   symmetric rename that ties (exit 1), and disjoint edits of one body
   under ``--strict-conflicts`` merged line by line (the gates' wall
   times masked in the comparison), and two routed merges with Java and
   C# enabled: a dozen Java and C# files with colliding signatures
   (renames, a move, an edit the last-wins map does not see; exit 0) and
   a C# DivergentRename (exit 1), each through the routed path (no fused
   engine, one compose on the TS engine).

At the end, pass or fail, every child this run started that still runs
is stopped, and so is any process whose working directory lies in the
run's scratch directory; no other process is matched.

Prints the kernels' JSON line, the card line, and last the device JSON.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / "_smoke"  # scratch git repository and checkpoint (gitignored)

#: The rung5 size; ``--files N`` scales a rehearsal down (and the
#: retyped files in proportion).
N_FILES, DECLS, N_RETYPED = 10_000, 4, 256
TOL = 2e-3
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM data sheet
H100_SMS = 132  # SMs of the H100 SXM (Hopper white paper)
#: Per-SM thread-instructions per clock on Hopper (CUDA C++ Programming
#: Guide, arithmetic instruction throughput, compute capability 9.0):
#: the ALU pipe's integer and logic instructions, the FMA pipe's integer
#: multiply-adds, and the four schedulers' issue of one warp instruction
#: each. The pipes run side by side; each bounds on its own.
SM_RATES = {"alu": 64, "fma": 64, "issue": 128}
#: SASS opcodes of each pipe (the ALU pipe as Nsight Compute's pipe
#: names describe it: integer and logic, without IMAD and IMUL).
ALU_OPS = frozenset(("IADD3", "LOP3", "PLOP3", "SHF", "SHL", "SHR", "PRMT", "ISETP", "SEL",
                     "LEA", "IMNMX", "IABS", "FLO", "POPC", "BREV", "BMSK", "SGXT", "MOV"))
FMA_OPS = frozenset(("IMAD", "IMUL"))
_SIG_TYPES = ("string", "number", "boolean", "bigint", "symbol", "object",
              "unknown", "never", "void", "undefined", "null")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.3f} s", flush=True)
    return now


# --- phase 2: build ----------------------------------------------------------

#: SASS instructions printed per kernel, and the one each must hold.
SASS_OPS = {"flash_chunk": ("HMMA", "LDSM", "LDGSTS", "LDS"),
            "flash_chunk_bwd": ("HMMA", "LDSM", "LDGSTS", "FFMA", "LDS", "STS", "LDG", "STG",
                                "MUFU"),
            "sha256": ("SHF", "LOP3", "IADD3", "PRMT", "ISETP", "IMAD")}
SASS_REQUIRED = {"flash_chunk": "HMMA", "flash_chunk_bwd": "HMMA", "sha256": "SHF"}


def report_ptxas(name: str, log: str) -> None:
    """Prints ptxas's entry, register and spill lines; fails on a spill."""
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and (int(spills.group(1)) or int(spills.group(2))):
            fail(f"{name}: ptxas reports spills: {line.strip()}")


def report_sass(kernels, name: str) -> dict:
    """Prints, per kernel function in the built library, its SASS
    instruction total (NOPs left out), the counts of ``SASS_OPS[name]``
    and its ALU- and FMA-pipe totals; fails if there is SASS but no
    ``SASS_REQUIRED[name]`` instruction. Returns ``{function: {opcode:
    count}}`` (``{}`` where the toolkit has no cuobjdump)."""
    try:
        tool = kernels.toolkit_tool("cuobjdump")
    except kernels.KernelBuildError:
        print(f"sass {name}: cuobjdump not found, counts not taken")
        return {}
    sass = subprocess.run([tool, "-sass", str(kernels.library_path(name))], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            function = header.group(1)
            counts[function] = {}
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)[.\s;]", line)
        if function and op and op.group(1) != "NOP":
            counts[function][op.group(1)] = counts[function].get(op.group(1), 0) + 1
    for function, ops in counts.items():
        dh = re.search(r"ILi(\d+)E", function)
        label = f"Dh={dh.group(1)}" if dh else function[-40:]
        pipes = _pipe_counts(ops)
        print(f"sass {name} {label}: instructions {pipes['issue']} "
              + " ".join(f"{k} {ops.get(k, 0)}" for k in SASS_OPS[name])
              + f"; ALU pipe {pipes['alu']}, FMA pipe {pipes['fma']}")
    need = SASS_REQUIRED[name]
    if counts and not sum(ops.get(need, 0) for ops in counts.values()):
        fail(f"{name}: no {need} instruction in the built SASS")
    return counts


def _pipe_counts(ops: dict) -> dict:
    """ALU-pipe, FMA-pipe and issued instructions of an opcode count."""
    return {"alu": sum(n for k, n in ops.items() if k in ALU_OPS),
            "fma": sum(n for k, n in ops.items() if k in FMA_OPS),
            "issue": sum(ops.values())}


# --- phase 4: kernels against their plain versions ---------------------------

def _attention_inputs(torch, b, lq, lk, h, dh, *, dead_rows, seed):
    """bf16 q/k/v and a ragged key mask; the last ``dead_rows`` batch
    rows have every key masked, like the matcher's bucket padding."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, lq, h, dh, device="cuda", generator=g).to(torch.bfloat16)
    k = torch.randn(b, lk, h, dh, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(b, lk, h, dh, device="cuda", generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, lk + 1, (b,), device="cuda", generator=g)
    mask = torch.arange(lk, device="cuda")[None, :] < lengths[:, None]
    if dead_rows:
        mask[-dead_rows:] = False
    return q, k, v, mask.contiguous()


def _flash_error(torch, flash, inputs, dead_rows) -> float:
    pv_k, m_k, l_k = flash.flash_chunk_attention(*inputs)
    pv_p, m_p, l_p = flash.flash_chunk_attention_plain(*inputs)
    torch.cuda.synchronize()
    out_k = pv_k / l_k.transpose(1, 2)[..., None]
    out_p = pv_p / l_p.transpose(1, 2)[..., None]
    l_rebased = l_k * torch.exp(m_k - m_p)
    for name, got, want in (("pv/l", out_k, out_p), ("l", l_rebased, l_p)):
        if not torch.isfinite(got).all():
            fail(f"flash_chunk {name}: non-finite values")
        if not torch.allclose(got, want, atol=TOL, rtol=TOL):
            fail(f"flash_chunk {name}: max abs err "
                 f"{(got - want).abs().max().item():.3e} exceeds atol/rtol {TOL}")
    lk = inputs[1].shape[1]
    if dead_rows and not bool((l_k[-dead_rows:] == lk).all()):
        fail(f"flash_chunk: an all-masked row's l is not its Lk={lk} "
             f"(got {l_k[-dead_rows:].unique().tolist()[:4]})")
    return (out_k - out_p).abs().max().item()


def _time_ms(torch, fn, input_sets, iters=40):
    """(event ms, host ms) per call: CUDA events around back-to-back
    calls, rotating over input sets whose total exceeds the 50 MB L2 so
    each call reads its inputs from HBM (host work inside ``fn`` counts
    where the host cannot keep ahead), and the host clock around the same
    loop before it synchronises (the cost of issuing one call)."""
    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*input_sets[i % len(input_sets)])
    host = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host * 1e3 / iters


def _graph_ms(torch, fn, input_sets, iters=40) -> float:
    """Mean ms per call when ``fn``'s work replays from a CUDA graph of
    ``iters`` calls: the device's time with no host work between calls."""
    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_events(prof):
    """(name, start µs, end µs) of every device activity in a trace."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(spans) -> float:
    """Length of the union of (start, end) spans."""
    busy, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    return busy


def _device_ms(torch, fn, input_sets, kernel, iters=40, tries=3):
    """Mean device time of one launch of ``kernel``: the durations of its
    launches in a torch.profiler trace over ``iters`` calls, averaged over
    the launches the trace recorded (after long traced runs a trace can
    drop records, all of them at times: then up to ``tries`` traces; how
    many records the last kept is returned beside the mean)."""
    from torch.profiler import ProfilerActivity, profile

    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*input_sets[i % len(input_sets)])
            torch.cuda.synchronize()
        spans = [e - s for name, s, e in _device_events(prof) if kernel in name]
        if spans:
            break
    return (sum(spans) / len(spans) / 1e3 if spans else None), len(spans)


#: Cycles of the sleep kernel that holds the card while a measured call
#: is issued (about 0.1 s at the H100's 1.98 GHz).
SLEEP_CYCLES = 200_000_000


def _queued_ms(torch, fn, input_sets=((),), reps=10):
    """Device time per call with no host gaps: each call is issued while
    a sleep kernel keeps the card busy, between two CUDA events, so the
    card runs the call's kernels back to back; the median over ``reps``.
    None if the card reached the first event before the call was issued."""
    fn(*input_sets[0])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(*input_sets[i % len(input_sets)])
        stop.record()
        if start.query():
            return None
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def _work(b, lq, lk, h, dh):
    """(bytes, flops) a launch must move and do: each input read once,
    each output written once; QK^T and PV over every key."""
    nbytes = (b * lq * h * dh * 2 + 2 * b * lk * h * dh * 2 + b * lk  # q, k, v bf16 + mask
              + b * lq * h * dh * 4 + 2 * b * h * lq * 4)  # pv, m, l f32 written once
    return nbytes, 4 * b * h * lq * lk * dh


def _roofline(nbytes, device_ms, bound_ms):
    """Achieved GB/s and the share of the bound, from device time."""
    if device_ms is None:
        return None, None
    return nbytes / (device_ms * 1e-3) / 1e9, bound_ms / device_ms


def check_kernels(torch, path_shapes: dict) -> dict:
    """Holds the kernel against its plain version at every shape the
    semdiff and the semmerge launched it with (``path_shapes``: shape →
    launches of both paths) and at wider ones, and times it at the
    paths' shapes. The row's times and bound are per launch, weighted by
    the paths' launches at each shape."""
    import torch.nn.functional as F

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.parallel import flash

    shapes = [(f"path x{n}", *shape, shape[0] // 8)
              for shape, n in sorted(path_shapes.items())]
    shapes += [  # (label, B, Lq, Lk, H, Dh, dead rows)
        ("matcher cap", 512, 64, 64, 8, 32, 64),
        ("multi-block", 4, 1024, 1000, 8, 32, 1),
        ("Dh=64", 8, 128, 96, 4, 64, 1),
        ("Dh=128", 4, 256, 200, 2, 128, 1),
        # edges of the 64-row / 64-key tiling
        ("one query, one key", 4, 1, 1, 8, 32, 1),
        ("ragged tiles", 6, 17, 65, 8, 32, 1),
        ("two query blocks", 6, 65, 64, 8, 32, 1),
        ("Dh=128 long chunk", 3, 130, 1000, 2, 128, 1),
    ]
    errs = []
    for i, (label, b, lq, lk, h, dh, dead) in enumerate(shapes):
        err = _flash_error(torch, flash, _attention_inputs(
            torch, b, lq, lk, h, dh, dead_rows=dead, seed=i), dead)
        errs.append(err)
        print(f"flash_chunk {label} B={b} Lq={lq} Lk={lk} H={h} Dh={dh}: "
              f"max abs err {err:.3e} (atol/rtol {TOL}); all-masked rows: l = Lk",
              flush=True)

    def sdpa(q, k, v, mask):  # yardstick only: normalised output, (B, H, L, Dh)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :])

    per_shape = []
    for (b, lq, lk, h, dh), n in sorted(path_shapes.items()):
        sets = [_attention_inputs(torch, b, lq, lk, h, dh, dead_rows=b // 8, seed=100 + s)
                for s in range(4)]
        nbytes, flops = _work(b, lq, lk, h, dh)
        bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
        ms, host_ms = _time_ms(torch, flash.flash_chunk_attention, sets)
        row = {
            "B": b, "Lq": lq, "Lk": lk, "H": h, "Dh": dh, "launches": n,
            "ms": ms, "host_ms": host_ms,
            "device_ms": None, "device_records": None,
            "graph_ms": _graph_ms(torch, flash.flash_chunk_attention, sets),
            "plain_ms": _time_ms(torch, flash.flash_chunk_attention_plain, sets)[0],
            "library_ms": _time_ms(torch, sdpa, sets)[0],
            "library_device_ms": _queued_ms(torch, sdpa, sets),
            "library_graph_ms": _graph_ms(torch, sdpa, sets),
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        }
        row["device_ms"], row["device_records"] = _device_ms(
            torch, flash.flash_chunk_attention, sets, "flash_chunk_kernel")
        row["gb_per_s"], row["bound_share"] = _roofline(
            nbytes, row["device_ms"], max(bytes_ms, ops_ms))
        per_shape.append(row)
        print(f"flash_chunk timing {json.dumps(row)}", flush=True)

    total = sum(s["launches"] for s in per_shape)

    def mean(key):
        if any(s[key] is None for s in per_shape):
            return None
        return sum(s[key] * s["launches"] for s in per_shape) / total

    bytes_ms, ops_ms = mean("bytes_ms"), mean("ops_ms")
    bound_ms = max(bytes_ms, ops_ms)
    gb_per_s, bound_share = _roofline(mean("bytes"), mean("device_ms"), bound_ms)
    return {
        "name": "flash_chunk",
        "route": "cuda",
        "source": "semantic_merge_tpu_torch/kernels/flash_chunk.cu",
        "replaces": "semantic_merge_tpu/parallel/flash.py:45",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": mean("ms"),
        "host_ms": mean("host_ms"),
        "device_ms": mean("device_ms"),
        "graph_ms": mean("graph_ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": mean("library_ms"),
        "library_device_ms": mean("library_device_ms"),
        "library_graph_ms": mean("library_graph_ms"),
        "gb_per_s": gb_per_s,
        "bound_share": bound_share,
        "shapes": per_shape,
    }


#: The backward kernel's tolerance against its plain version: its bf16
#: outputs round f32 sums taken in another order (bf16 keeps 8 bits).
TOL_BWD = 1e-2


def _bwd_inputs(torch, flash, b, lq, lk, h, dh, *, dead_rows, seed):
    """The backward's arguments on the card: q, k, v and the mask of
    :func:`_attention_inputs`, the plain forward's m, l and f32 output, and
    a bf16 output gradient."""
    q, k, v, mask = _attention_inputs(torch, b, lq, lk, h, dh, dead_rows=dead_rows, seed=seed)
    pv, m, l = flash.flash_chunk_attention_plain(q, k, v, mask)
    o = (pv / l.transpose(1, 2)[..., None]).contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(b, lq, h, dh, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, mask, m, l, o, do


def _bwd_error(torch, flash, inputs, dead_rows) -> float:
    """Max abs error of the kernel's dq, dk, dv against the plain
    backward's; fails beyond atol/rtol ``TOL_BWD``, on a non-finite
    value, if an all-masked row sends gradient to its q or keys, or if a
    second launch on the same inputs gives other bits."""
    got = flash.flash_chunk_backward(*inputs)
    again = flash.flash_chunk_backward(*inputs)
    want = flash.flash_attention_backward_plain(*inputs)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f"flash_chunk_bwd {name}: two launches on the same inputs differ")
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float()
        if not torch.isfinite(g).all():
            fail(f"flash_chunk_bwd {name}: non-finite values")
        if not torch.allclose(g, w, atol=TOL_BWD, rtol=TOL_BWD):
            fail(f"flash_chunk_bwd {name}: max abs err {(g - w).abs().max().item():.3e} "
                 f"exceeds atol/rtol {TOL_BWD}")
        err = max(err, (g - w).abs().max().item())
    if dead_rows and (got[0][-dead_rows:].any() or got[1][-dead_rows:].any()):
        fail("flash_chunk_bwd: an all-masked row sent gradient to its q or keys")
    return err


def _bwd_work(b, lq, lk, h, dh):
    """(bytes, flops) a backward launch must move and do: q, k, v, dO
    (bf16), O (f32), m, l and the mask read once; dq, dk, dv (bf16)
    written once; five products over every (query, key) pair (S, dO V^T,
    dV, dK, dQ)."""
    nbytes = (2 * b * lq * h * dh * 2 + 2 * b * lk * h * dh * 2 + b * lk  # q, dO, k, v, mask
              + b * lq * h * dh * 4 + 2 * b * h * lq * 4  # O, m, l
              + b * lq * h * dh * 2 + 2 * b * lk * h * dh * 2)  # dq, dk, dv
    return nbytes, 10 * b * h * lq * lk * dh


def check_flash_bwd(torch, path_shapes: dict, inference_shapes) -> dict:
    """Holds the backward kernel against its plain version at the shapes
    the training path launched it with (``path_shapes``: shape →
    launches), at the matcher's inference shapes (``inference_shapes``),
    on all-masked rows and at edge shapes, and times it at the training
    and inference shapes, beside the plain backward and SDPA's backward (a
    yardstick the port never calls). The row's times and bound are per
    launch, weighted by the paths' launches at each shape."""
    import torch.nn.functional as F

    from semantic_merge_tpu_torch.parallel import flash

    timed = dict(path_shapes)
    for shape in inference_shapes:
        timed.setdefault(shape, 0)
    shapes = [(f"path x{n}", *shape, shape[0] // 8) for shape, n in sorted(timed.items())]
    shapes += [  # (label, B, Lq, Lk, H, Dh, dead rows)
        ("multi-block (dq in f32 scratch)", 4, 1024, 1000, 8, 32, 1),
        ("Dh=64", 8, 128, 96, 4, 64, 1),
        ("Dh=128", 4, 256, 200, 2, 128, 1),
        ("one query, one key", 4, 1, 1, 8, 32, 1),
        ("ragged tiles", 6, 17, 65, 8, 32, 1),
    ]
    errs = []
    for i, (label, b, lq, lk, h, dh, dead) in enumerate(shapes):
        err = _bwd_error(torch, flash, _bwd_inputs(torch, flash, b, lq, lk, h, dh,
                                                   dead_rows=dead, seed=200 + i), dead)
        errs.append(err)
        print(f"flash_chunk_bwd {label} B={b} Lq={lq} Lk={lk} H={h} Dh={dh}: max abs err of "
              f"dq, dk, dv {err:.3e} (atol/rtol {TOL_BWD}); all-masked rows: no dq, dk; "
              "two launches bit-identical",
              flush=True)

    def sdpa_backward(q, k, v, mask, do):
        """One SDPA backward over prepared (B, H, L, Dh) leaves."""
        return torch.autograd.grad(sdpa_out[id(q)], (q, k, v), do, retain_graph=True)

    per_shape, sdpa_out = [], {}
    for (b, lq, lk, h, dh), n in sorted(timed.items()):
        sets = [_bwd_inputs(torch, flash, b, lq, lk, h, dh, dead_rows=b // 8, seed=300 + s)
                for s in range(4)]
        library_sets = []
        for q, k, v, mask, _, _, _, do in sets:
            lq_, lk_, lv_ = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sdpa_out[id(lq_)] = F.scaled_dot_product_attention(
                lq_, lk_, lv_, attn_mask=mask[:, None, None, :])
            library_sets.append((lq_, lk_, lv_, mask, do.transpose(1, 2)))
        nbytes, flops = _bwd_work(b, lq, lk, h, dh)
        bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
        ms, host_ms = _time_ms(torch, flash.flash_chunk_backward, sets)
        row = {
            "B": b, "Lq": lq, "Lk": lk, "H": h, "Dh": dh, "launches": n,
            "ms": ms, "host_ms": host_ms,
            "device_ms": None, "device_records": None,
            "graph_ms": _graph_ms(torch, flash.flash_chunk_backward, sets),
            "plain_ms": _time_ms(torch, flash.flash_attention_backward_plain, sets)[0],
            "library_ms": _time_ms(torch, sdpa_backward, library_sets)[0],
            "library_device_ms": _queued_ms(torch, sdpa_backward, library_sets),
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        }
        row["device_ms"], row["device_records"] = _device_ms(
            torch, flash.flash_chunk_backward, sets, "flash_chunk_bwd_kernel")
        row["gb_per_s"], row["bound_share"] = _roofline(
            nbytes, row["device_ms"], max(bytes_ms, ops_ms))
        per_shape.append(row)
        sdpa_out.clear()
        print(f"flash_chunk_bwd timing {json.dumps(row)}", flush=True)

    weighted = [r for r in per_shape if r["launches"]]
    bytes_ms, ops_ms = _weighted(weighted, "bytes_ms"), _weighted(weighted, "ops_ms")
    bound_ms = max(bytes_ms, ops_ms)
    gb_per_s, bound_share = _roofline(_weighted(weighted, "bytes"),
                                      _weighted(weighted, "device_ms"), bound_ms)
    return {
        "name": "flash_chunk_bwd",
        "route": "cuda",
        "source": "semantic_merge_tpu_torch/kernels/flash_chunk_bwd.cu",
        "replaces": "semantic_merge_tpu/parallel/flash.py:45",
        "computes": "the backward of _chunk_kernel, which the JAX package takes by "
                    "autodiff of semantic_merge_tpu/parallel/ring.py:27 _chunk_stats_einsum",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": _weighted(weighted, "ms"),
        "host_ms": _weighted(weighted, "host_ms"),
        "device_ms": _weighted(weighted, "device_ms"),
        "graph_ms": _weighted(weighted, "graph_ms"),
        "plain_ms": _weighted(weighted, "plain_ms"),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": _weighted(weighted, "library_ms"),
        "library_device_ms": _weighted(weighted, "library_device_ms"),
        "gb_per_s": gb_per_s,
        "bound_share": bound_share,
        "shapes": per_shape,
    }


def _weighted(rows, key):
    """Mean of ``key`` per launch, weighted by the rows' launches."""
    total = sum(r["launches"] for r in rows)
    if not total or any(r[key] is None for r in rows):
        return None
    return sum(r[key] * r["launches"] for r in rows) / total


SHA_EDGES = (0, 1, 55, 56, 63, 64, 119, 120)


def _sha_inputs(torch, n, blocks, lens=None, seed=0):
    """uint8 rows of junk (ignored past each length) and int32 lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    msg = torch.randint(0, 256, (n, blocks * 64), generator=g, device="cuda",
                        dtype=torch.int32).to(torch.uint8)
    if lens is None:
        lens = torch.randint(0, blocks * 64 - 8, (n,), generator=g, device="cuda")
    return msg, torch.as_tensor(lens, device="cuda").to(torch.int32)


def _sha_check(torch, sha, msg, lens, n_words) -> None:
    """The kernel against its plain version (bit-exact) and hashlib."""
    import hashlib

    got = sha.sha256_device(msg, lens, n_words)
    want = sha.sha256_device_plain(msg, lens, n_words)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=1).sum())
        fail(f"sha256: {bad} of {msg.shape[0]} rows differ from the plain version")
    host_msg, host_len = msg.cpu().numpy(), lens.cpu().numpy()
    words = got.cpu().numpy().view("uint32")
    for i in range(msg.shape[0]):
        digest = hashlib.sha256(host_msg[i, :host_len[i]].tobytes()).hexdigest()
        if "".join(f"{int(w):08x}" for w in words[i]) != digest[:8 * n_words]:
            fail(f"sha256 row {i} (length {host_len[i]}) differs from hashlib")


def _sha_work(n, blocks, n_words, lens, pipes):
    """(bytes, SM clocks) of one call: each row read once with its
    length, the digest words written once; and for each block of each
    row's own padded length, one pass of the kernel's instructions
    (``pipes``: its static SASS counts per pipe, one block's loop body
    with the row's set-up and stores; an upper estimate for rows of one
    block, as on the fused path), at the slowest pipe's rate."""
    used = int(((lens.long() + 9 + 63) // 64).clamp(max=blocks).sum())
    return (n * (blocks * 64 + 4 + 4 * n_words),
            used * max(pipes[k] / SM_RATES[k] for k in SM_RATES))


def check_sha256(torch, path_shapes: dict, clock_hz: float, sass: dict) -> dict:
    """Holds the SHA-256 kernel against its plain version and hashlib at
    the paths' shapes (payload rows of 51 bytes, as the fused engine
    hashes) and at edge shapes, and times it at the paths' shapes. Its
    operations bound comes from the kernel's SASS (``sass``, as
    :func:`report_sass` counted it): per pipe, instructions over the
    pipe's per-SM rate, times 132 SMs at the card's maximum clock."""
    from semantic_merge_tpu_torch.ops import sha256 as sha

    checks = [("path", n, blocks, n_words, [51] * n)
              for (n, blocks, n_words) in sorted(path_shapes)]
    for blocks in (1, 2, 3):
        edges = [x for x in SHA_EDGES if x <= blocks * 64 - 9]
        checks.append((f"edges {blocks} block(s)", len(edges), blocks, 8, edges))
    checks += [("one row", 1, 1, 8, [3]), ("1000 rows", 1000, 2, 4, None),
               ("129 rows", 129, 3, 8, None)]
    for i, (label, n, blocks, n_words, lens) in enumerate(checks):
        msg, ln = _sha_inputs(torch, n, blocks, lens, seed=i)
        _sha_check(torch, sha, msg, ln, n_words)
        print(f"sha256 {label} n={n} blocks={blocks} words={n_words}: equal to the plain "
              "version (bit-exact) and to hashlib", flush=True)

    functions = [ops for f, ops in sass.items() if "sha256_rows_kernel" in f]
    if len(functions) != 1:
        fail(f"sha256: {len(functions)} sha256_rows_kernel functions in the SASS, expected 1 "
             "(its operations bound is counted from them)")
    pipes = _pipe_counts(functions[0])
    sm_clocks_per_s = H100_SMS * clock_hz
    rows = []
    for (n, blocks, n_words), launches in sorted(path_shapes.items()):
        sets = [_sha_inputs(torch, n, blocks, [51] * n, seed=100 + k) for k in range(4)]
        nbytes, sm_clocks = _sha_work(n, blocks, n_words, sets[0][1], pipes)
        fn = lambda m, ln: sha.sha256_device(m, ln, n_words)  # noqa: E731
        plain = lambda m, ln: sha.sha256_device_plain(m, ln, n_words)  # noqa: E731
        ms, host_ms = _time_ms(torch, fn, sets)
        row = {"n": n, "blocks": blocks, "words": n_words, "launches": launches,
               "ms": ms, "host_ms": host_ms,
               "graph_ms": _graph_ms(torch, fn, sets),
               "plain_ms": _time_ms(torch, plain, sets, iters=4)[0],
               "bytes": nbytes, "sm_clocks": sm_clocks,
               "bytes_ms": nbytes / H100_BYTES_PER_S * 1e3,
               "ops_ms": sm_clocks / sm_clocks_per_s * 1e3}
        row["device_ms"], row["device_records"] = _device_ms(torch, fn, sets,
                                                             "sha256_rows_kernel")
        row["bound_share"] = (max(row["bytes_ms"], row["ops_ms"]) / row["device_ms"]
                              if row["device_ms"] else None)
        rows.append(row)
        print(f"sha256 timing {json.dumps(row)}", flush=True)
    bytes_ms, ops_ms = _weighted(rows, "bytes_ms"), _weighted(rows, "ops_ms")
    device_ms = _weighted(rows, "device_ms")
    return {
        "name": "sha256",
        "route": "cuda",
        "source": "semantic_merge_tpu_torch/kernels/sha256.cu",
        "replaces": "semantic_merge_tpu/ops/sha256.py:112",
        "launches": None,
        "max_abs_err": 0,
        "ms": _weighted(rows, "ms"),
        "host_ms": _weighted(rows, "host_ms"),
        "device_ms": device_ms,
        "graph_ms": _weighted(rows, "graph_ms"),
        "plain_ms": _weighted(rows, "plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes SHA-256
        "sass_per_block": pipes,
        "sm_rates": SM_RATES,
        "clock_hz": clock_hz,
        "bound_share": max(bytes_ms, ops_ms) / device_ms if device_ms else None,
        "shapes": rows,
    }


def time_programs(torch, captured: dict) -> dict:
    """The fused merge and diff programs and the render program, on the
    inputs the fused paths gave them: device time per call with the
    kernels back to back (:func:`_queued_ms`), the kernels and copies of
    one call (the most any of five single-call traces recorded), and the
    CUDA-event and host (issuing) time per call when the host paces it."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (fn, args, kwargs) in captured.items():
        call = lambda: fn(*args, **kwargs)  # noqa: E731
        call()
        torch.cuda.synchronize()
        reps = 10
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        stop.record()
        torch.cuda.synchronize()
        counts = []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [n for n, _, _ in _device_events(prof)]
            kern = [n for n in names if not n.startswith("Mem")]
            counts.append((len(kern), len(names) - len(kern),
                           sum("sha256_rows_kernel" in n for n in kern)))
        kernels_, copies, sha_launches = max(counts)
        out[name] = {"device_ms": _queued_ms(torch, call), "kernels": kernels_,
                     "copies": copies, "sha256_launches": sha_launches,
                     "event_ms": start.elapsed_time(stop) / reps, "host_ms": host_ms}
        print(f"program {name}: {json.dumps(out[name])}", flush=True)
    return out


class Capture:
    """Wraps ``module.name`` so that its first and last calls' arguments
    and its last return value are kept (the function then runs as
    before); counts its calls."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0
        self.first = self.last = self.returned = None

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls += 1
            self.last = (self.fn, args, kwargs)
            self.first = self.first or self.last
            self.returned = self.fn(*args, **kwargs)
            return self.returned

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def check_batched_program(torch, captured) -> dict:
    """The batched fused program at B = 4 on the inputs the fused
    semmerge gave the one-merge program (the captured call: decl
    columns, digest table, digests and capacity, four copies stacked on
    the merge axis): each of its 4 rows byte-equal to the one-merge
    program's one-buffer row, exactly as many ``sha256`` launches (one
    per side, over ``4 * C`` rows each) as one one-merge call, by the
    wrappers' counts. Returns the batched program for :func:`time_programs`."""
    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.ops import fused

    _fn, args, _kwargs = captured
    B, C = 4, args[6]
    single_args = (*args[:7],)
    stacked = [a.unsqueeze(0).expand(B, *a.shape).contiguous() for a in args[:6]]
    program = fused.batched_fused_program(B, *(a.shape[-1] for a in args[:3]), C)
    kernels.reset_launches()
    one = fused._fused_merge_program(*single_args)
    torch.cuda.synchronize()
    single_sha = kernels.LAUNCHES["sha256"]
    kernels.reset_launches()
    rows = program(*stacked)
    torch.cuda.synchronize()
    batched_sha = kernels.LAUNCHES["sha256"]
    kernels.reset_launches()
    one_bytes = one.cpu().numpy().tobytes()
    host = rows.cpu().numpy()
    if host.shape != (B, 8 + 24 * C):
        fail(f"the batched program gave {host.shape}, expected {(B, 8 + 24 * C)}")
    for i in range(B):
        if host[i].tobytes() != one_bytes:
            fail(f"row {i} of the batched program differs from the one-merge program's row")
    if batched_sha != single_sha or single_sha != 2:
        fail(f"the batched program launched sha256 {batched_sha} times, one merge "
             f"{single_sha} (expected 2 each: one per side)")
    print(f"batched program: B={B}, C={C}: {B} rows byte-equal to the one-merge one-buffer "
          f"row; sha256 launches {batched_sha} (one merge: {single_sha}; {B * C} rows each)",
          flush=True)
    return {f"batched merge program (B={B})": (program, stacked, {})}


def check_batched_timing(programs: dict) -> dict:
    """The batched program's kernels against one one-merge call's: at
    most 1.1x, and the same ``sha256`` launches, from the profiles of
    :func:`time_programs`."""
    single = programs["fused merge program"]
    batched = programs["batched merge program (B=4)"]
    if batched["kernels"] > 1.1 * single["kernels"]:
        fail(f"the batched program issued {batched['kernels']} kernels, one merge "
             f"{single['kernels']} (at most 1.1x)")
    if batched["sha256_launches"] != single["sha256_launches"]:
        fail(f"sha256 records: batched {batched['sha256_launches']}, one merge "
             f"{single['sha256_launches']}")
    out = {"kernels_ratio": batched["kernels"] / single["kernels"],
           "host_ms_batched": batched["host_ms"], "host_ms_single": single["host_ms"],
           "host_ms_four_singles": 4 * single["host_ms"],
           "device_ms_batched": batched["device_ms"], "device_ms_single": single["device_ms"]}
    print(f"batched program against one merge: {json.dumps(out)}", flush=True)
    return out


# --- the train phase ---------------------------------------------------------

#: Steps, checkpoint interval and the profiled window of the train phase.
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_WINDOW = 200, 100, (101, 120)
#: The steps of a separate run whose CPU ranges torch.profiler records
#: (so that its overhead stays out of the main run's step time).
RANGE_STEPS, RANGE_WINDOW = 40, (21, 40)
#: The CPU tests' tolerance on a training step's loss (bf16 matmuls
#: rounding at other points).
TOL_LOSS = 2e-2


class TrainWatch:
    """Wraps ``training.train_step``: keeps each step's loss (a tensor,
    read at the end), the host clock before the first step and, after a
    synchronise, after step ``total`` (no other step waits for the card),
    the launch counts and shapes after every step (so the last are the
    training's, before anything that follows), and a torch.profiler
    device trace over the steps of ``window``."""

    def __init__(self, torch, training, kernels, total: int, window=None) -> None:
        self.torch, self.training, self.kernels = torch, training, kernels
        self.fn = training.train_step
        self.total, self.window = total, window
        self.losses, self.steps = [], 0
        self.t_first = self.t_last = None
        self.launches, self.shapes = {}, {}
        self.window_wall = self.window_busy = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        prof = None

        def wrapper(*args, **kwargs):
            nonlocal prof
            self.steps += 1
            if self.t_first is None:
                self.t_first = time.perf_counter()
            if self.window and self.steps == self.window[0]:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                self.window_t0 = time.perf_counter()
            loss = self.fn(*args, **kwargs)
            self.losses.append(loss)
            if self.window and self.steps == self.window[1]:
                torch.cuda.synchronize()
                self.window_wall = time.perf_counter() - self.window_t0
                prof.__exit__(None, None, None)
                self.window_busy = _busy_us([(s, e) for _, s, e in _device_events(prof)]) / 1e6
            if self.steps == self.total:
                torch.cuda.synchronize()
                self.t_last = time.perf_counter()
            self.launches = dict(self.kernels.LAUNCHES)
            self.shapes = {k: dict(v) for k, v in self.kernels.LAUNCH_SHAPES.items()}
            return loss

        self.training.train_step = wrapper
        return self

    def __exit__(self, *exc):
        self.training.train_step = self.fn
        return False

    def curve(self) -> list:
        return [float(x) for x in self.losses]


class TrainSplit:
    """Host time of each part of a training step, from outside the
    package: for the life of the ``with`` it wraps the training loop's
    seams (the batch stream, ``training.batch_on``, ``train_step``,
    ``matcher.loss_fn``, ``Tensor.backward``, the optimizer's ``step``,
    ``training._save``) and sums the host clock of each part over the
    steps of ``window`` (the batch and its h2d copy count for the step
    they feed; a checkpoint for the step it saves). Every part is also a
    ``train/<part>`` range, which a torch.profiler trace with CPU
    activity records; with ``profile`` such a trace covers the window.
    Every checkpoint's seconds are kept, in the window or not. Entered
    inside a :class:`TrainWatch`, it wraps the step the watch calls, so
    the watch's own work (its profiler's start and stop) stays out."""

    PARTS = ("batch", "h2d", "forward", "backward", "step", "checkpoint")

    def __init__(self, torch, training, matcher, window, profile: bool = False) -> None:
        self.torch, self.training, self.matcher = torch, training, matcher
        self.window, self.profile = window, profile
        self.host = dict.fromkeys(self.PARTS + ("train_step",), 0.0)
        self.saves = []
        self.steps = 0
        self.prof = None

    def _timed(self, name: str, fn, after: bool = False):
        """``fn`` timed as part ``name`` of the step in progress, or with
        ``after`` of the step just done (``self.steps`` counts the steps
        whose ``train_step`` returned)."""
        def wrapper(*args, **kwargs):
            step = self.steps + (0 if after else 1)
            if self.profile and step == self.window[0] and self.prof is None:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CPU])
                self.prof.__enter__()
            t0 = time.perf_counter()
            with self.torch.profiler.record_function(f"train/{name}"):
                out = fn(*args, **kwargs)
            seconds = time.perf_counter() - t0
            if name == "checkpoint":
                self.saves.append(seconds)
            if self.window[0] <= step <= self.window[1]:
                self.host[name] += seconds
            return out
        return wrapper

    def __enter__(self):
        tr, mt, tensor = self.training, self.matcher, self.torch.Tensor
        self._restore = [(tr, k, getattr(tr, k)) for k in (
            "batches", "batch_on", "_save", "optimizer", "train_step")]
        self._restore += [(mt, "loss_fn", mt.loss_fn), (tensor, "backward", tensor.backward)]
        batches, make_optimizer, train_step = tr.batches, tr.optimizer, tr.train_step

        def timed_batches(cfg):
            stream = batches(cfg)
            draw = self._timed("batch", lambda: next(stream))
            while True:
                yield draw()

        def optimizer(*args, **kwargs):
            opt = make_optimizer(*args, **kwargs)
            opt.step = self._timed("step", opt.step)
            return opt

        timed_step = self._timed("train_step", train_step)

        def step(*args, **kwargs):
            out = timed_step(*args, **kwargs)
            self.steps += 1
            if self.steps == self.window[1] and self.prof is not None:
                self.prof.__exit__(None, None, None)
            return out

        tr.batches, tr.optimizer, tr.train_step = timed_batches, optimizer, step
        tr.batch_on = self._timed("h2d", tr.batch_on)
        tr._save = self._timed("checkpoint", tr._save, after=True)
        mt.loss_fn = self._timed("forward", mt.loss_fn)
        tensor.backward = self._timed("backward", tensor.backward)
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._restore:
            setattr(owner, name, value)
        return False

    def per_step_ms(self) -> dict:
        """Host ms per step of each part over the window; ``other``, what
        ``train_step`` spends beside the forward, ``backward()`` and
        ``step()`` (``zero_grad``, the loss's detach); and ``wall``, their
        sum with the batch, the h2d copy and the checkpoints."""
        n = self.window[1] - self.window[0] + 1
        out = {name: self.host[name] * 1e3 / n for name in self.PARTS}
        call = self.host["train_step"] * 1e3 / n
        out["other"] = call - out["forward"] - out["backward"] - out["step"]
        out["wall"] = call + out["batch"] + out["h2d"] + out["checkpoint"]
        return out

    def range_ms(self) -> dict:
        """CPU ms per step of each ``train/<part>`` range in the profiled
        window."""
        n = self.window[1] - self.window[0] + 1
        totals = {e.key: e.cpu_time_total for e in self.prof.key_averages()}
        return {name: totals.get(f"train/{name}", 0.0) / 1e3 / n for name in self.PARTS}


def _check_curve(label: str, curve: list) -> None:
    if not curve or not all(map(lambda x: x == x and abs(x) != float("inf"), curve)):
        fail(f"{label}: a non-finite loss in {curve}")
    if not curve[-1] < curve[0]:
        fail(f"{label}: the loss did not fall: step 1 {curve[0]:.4f}, last {curve[-1]:.4f}")


def run_train_phase(torch, work: pathlib.Path) -> tuple:
    """``train-matcher --steps 200 --ckpt-dir D --ckpt-every 100 --eval``
    in this process on the card at the default width: exit 0, its output
    lines, a finite loss lower at the end than at step 1, 1,600
    ``flash_chunk`` and 1,600 ``flash_chunk_bwd`` launches (8 per step)
    and no ``sha256``, ``matcher_eval`` trained, the checkpoint loading
    through ``EmbeddingSignatureMatcher``; the first 3 steps' losses equal
    the CPU plain path's from the same initial weights within the CPU
    tests' 2e-2; then 20 steps with ``moe_mode="topk"`` through the
    Python API: finite, falling, 8 + 8 launches a step. Returns (the
    launches and shapes of the training, a summary)."""
    import contextlib
    import io

    from semantic_merge_tpu_torch import cli, kernels
    from semantic_merge_tpu_torch.models import matcher as matcher_module
    from semantic_merge_tpu_torch.models import training
    from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import MatcherConfig, optimizer, train_step
    from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher

    ckpt = work / "trained"
    argv = ["train-matcher", "--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--eval"]
    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with TrainSplit(torch, training, matcher_module, TRAIN_WINDOW) as split, \
            TrainWatch(torch, training, kernels, TRAIN_STEPS, TRAIN_WINDOW) as watch, \
            contextlib.redirect_stdout(out):
        code = cli.main(argv, delegate=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = dict(kernels.LAUNCHES)
    lines = out.getvalue().splitlines()
    print(f"{' '.join(argv)}: exit {code}, wall {wall:.3f} s; output: {lines}", flush=True)
    if code != 0:
        fail(f"train-matcher exited {code}")
    curve = watch.curve()
    if watch.steps != TRAIN_STEPS:
        fail(f"train-matcher ran {watch.steps} steps, expected {TRAIN_STEPS}")
    _check_curve("train-matcher", curve)
    expect_launches("train-matcher's training", watch.launches,
                    {"flash_chunk": 8 * TRAIN_STEPS, "flash_chunk_bwd": 8 * TRAIN_STEPS,
                     "sha256": 0})
    if len(lines) != 2 or not re.fullmatch(
            rf"trained {TRAIN_STEPS} steps, final loss \d+\.\d{{4}}, checkpoints in "
            + re.escape(str(ckpt)), lines[0]):
        fail(f"train-matcher printed {lines}")
    if abs(float(lines[0].split("final loss ")[1].split(",")[0]) - curve[-1]) > 1e-4:
        fail(f"the printed final loss is not the last step's {curve[-1]:.4f}")
    evaluation = json.loads(lines[1])["matcher_eval"]
    if evaluation.get("trained") is not True:
        fail(f"matcher_eval is not of a trained matcher: {evaluation}")
    step_ms = (watch.t_last - watch.t_first) / TRAIN_STEPS * 1e3
    idle = 1 - watch.window_busy / watch.window_wall
    print("train-matcher loss every 20 steps: " + json.dumps(
        {i + 1: round(curve[i], 4) for i in range(0, TRAIN_STEPS, 20)} | {
            TRAIN_STEPS: round(curve[-1], 4)}), flush=True)
    print(f"train-matcher: {step_ms:.3f} ms per step (host clock over the loop, "
          f"checkpoints included); steps {TRAIN_WINDOW[0]}-{TRAIN_WINDOW[1]} profiled: "
          f"wall {watch.window_wall:.4f} s, device busy {watch.window_busy:.4f} s, idle share "
          f"{idle:.4f}; launches in training {watch.launches}, with --eval {total}; "
          f"matcher_eval {json.dumps(evaluation)}", flush=True)

    host_split = split.per_step_ms()
    save_ms = [round(x * 1e3, 3) for x in split.saves]
    print(f"train-matcher host ms per step, steps {TRAIN_WINDOW[0]}-{TRAIN_WINDOW[1]} (host "
          f"clock): {json.dumps({k: round(v, 3) for k, v in host_split.items()})}; "
          f"checkpoints (steps {TRAIN_CKPT_EVERY} and {TRAIN_STEPS}, none in the window): "
          f"{save_ms} ms each, {sum(split.saves) * 1e3 / TRAIN_STEPS:.3f} ms per step over "
          f"the {TRAIN_STEPS}", flush=True)
    if len(split.saves) != TRAIN_STEPS // TRAIN_CKPT_EVERY:
        fail(f"train-matcher saved {len(split.saves)} checkpoints, expected "
             f"{TRAIN_STEPS // TRAIN_CKPT_EVERY}")
    # The same parts as torch.profiler's CPU ranges, in a run of their own.
    with TrainSplit(torch, training, matcher_module, RANGE_WINDOW, profile=True) as ranged:
        training.train_matcher(training.TrainConfig(steps=RANGE_STEPS), "cuda")
    range_split = ranged.range_ms()
    print(f"train-matcher torch.profiler CPU ranges, ms per step, steps {RANGE_WINDOW[0]}-"
          f"{RANGE_WINDOW[1]} of a {RANGE_STEPS}-step run: "
          f"{json.dumps({k: round(v, 3) for k, v in range_split.items()})}; the same steps "
          f"by the host clock under that profiler: "
          f"{json.dumps({k: round(v, 3) for k, v in ranged.per_step_ms().items()})}",
          flush=True)

    matcher = EmbeddingSignatureMatcher(ckpt_dir=str(ckpt))
    z = matcher.embed_texts(["export function f(a: number): number {\n  return a;\n}\n"])
    if not matcher.trained or not bool(torch.isfinite(torch.from_numpy(z)).all()):
        fail(f"the checkpoint in {ckpt} does not load as a trained matcher")

    # The first three steps on the CPU, plain path, from the same weights
    # and batches.
    cfg = training.TrainConfig()
    encoder = Encoder(cfg.matcher.encoder, generator=torch.Generator().manual_seed(cfg.seed))
    opt = optimizer(encoder, cfg.matcher)
    stream = training.batches(cfg)
    cpu = [float(train_step(encoder, opt, training.batch_on(next(stream), torch.device("cpu")),
                            cfg.matcher)) for _ in range(3)]
    worst = max(abs(a - b) for a, b in zip(cpu, curve[:3]))
    print(f"train-matcher: first 3 losses on the card {[round(x, 6) for x in curve[:3]]}, "
          f"on the CPU (plain path) {[round(x, 6) for x in cpu]}; max abs diff {worst:.3e} "
          f"(atol {TOL_LOSS})", flush=True)
    if worst > TOL_LOSS:
        fail(f"the card's first losses differ from the CPU's by {worst:.3e}")

    topk_steps = 20
    kernels.reset_launches()
    with TrainWatch(torch, training, kernels, topk_steps) as topk:
        training.train_matcher(training.TrainConfig(
            matcher=MatcherConfig(encoder=EncoderConfig(moe_mode="topk")), steps=topk_steps),
            "cuda")
    topk_curve = topk.curve()
    _check_curve("topk training", topk_curve)
    expect_launches("topk training", topk.launches,
                    {"flash_chunk": 8 * topk_steps, "flash_chunk_bwd": 8 * topk_steps,
                     "sha256": 0})
    topk_ms = (topk.t_last - topk.t_first) / topk_steps * 1e3
    print(f"topk training (moe_mode=topk, {topk_steps} steps): losses "
          f"{[round(x, 4) for x in topk_curve]}; {topk_ms:.3f} ms per step; launches "
          f"{topk.launches}", flush=True)
    summary = {"wall_s": wall, "step_ms": step_ms, "idle_share": idle,
               "window_wall_s": watch.window_wall, "window_busy_s": watch.window_busy,
               "first_loss": curve[0], "final_loss": curve[-1], "cpu_first3_max_diff": worst,
               "host_split_ms": host_split, "checkpoint_ms": save_ms,
               "profiler_range_ms": range_split,
               "matcher_eval": evaluation, "topk_step_ms": topk_ms,
               "topk_first_loss": topk_curve[0], "topk_final_loss": topk_curve[-1]}
    return (watch.launches, watch.shapes), summary


# --- phase 3: the semantic diff end to end -----------------------------------

def _unique_params(idx: int, n_digits: int) -> str:
    digits = []
    for _ in range(n_digits):
        digits.append(_SIG_TYPES[idx % len(_SIG_TYPES)])
        idx //= len(_SIG_TYPES)
    return ", ".join(f"p{k}: {t}" for k, t in enumerate(digits))


README = "".join(f"line {k} of the readme\n" for k in range(1, 21))


def synth_trees(n_files: int, decls: int, n_retyped: int):
    """(base, side, other) path→content maps in the shape of the bench's
    ``synth_repo``: unique signatures per decl and a README.md.

    The side (A) renames the first function of every even file, adds one
    to every 51st odd file (every 17th in the bench; sparser here so
    that the residual adds stay under the matcher's cap of 512
    candidates), renames AND retypes (return type number→string) the
    first function of the first ``n_retyped`` other odd files, and edits
    line 2 of the README.

    The other branch (B) moves every 4th file (all renamed on A) from
    ``src/`` to ``lib/``, renames AND retypes (number→boolean) the first
    function of the next ``n_retyped`` odd files that A leaves unchanged,
    and edits line 19 of the README, so the text layer merges it.

    The statement branch edits the body of the last function of every
    3rd file, ``{ return 3; }`` → ``{ return 3 + i; }`` for file ``i``:
    the last, because an address holds the decl's offset, and an edit to
    an earlier body would shift the decls after it by another amount
    than A's rename does (a DivergentMove in strict mode).

    Returns (base, side, other, stmt)."""
    n_digits = 1
    while len(_SIG_TYPES) ** n_digits < n_files * decls:
        n_digits += 1
    base, side, other, stmt = {"README.md": README}, {}, {}, {"README.md": README}
    side["README.md"] = README.replace("line 2 of", "line 2 (edited on A) of")
    other["README.md"] = README.replace("line 19 of", "line 19 (edited on B) of")
    retyped = retyped_other = 0
    for i in range(n_files):
        path = f"src/mod{i:05d}.ts"
        content = "\n".join(
            f"export function fn{i}_{d}({_unique_params(i * decls + d, n_digits)})"
            f": number {{ return {d}; }}" for d in range(decls)) + "\n"
        base[path] = content
        other[f"lib/mod{i:05d}.ts" if i % 4 == 0 else path] = content
        last = decls - 1
        stmt[path] = (content.replace(f"{{ return {last}; }}\n", f"{{ return {last} + {i}; }}\n")
                      if i % 3 == 0 else content)
        if i % 2 == 0:
            side[path] = content.replace(f"function fn{i}_0(", f"function renamed{i}_0(")
        elif i % 51 == 0:
            side[path] = content + f"export function added{i}(x: string): string {{ return x; }}\n"
        elif retyped < n_retyped:
            side[path] = _reshape(content, f"fn{i}_0", f"reshaped{i}_0", "string")
            retyped += 1
        else:
            side[path] = content
            if retyped_other < n_retyped:
                other[path] = _reshape(content, f"fn{i}_0", f"reshapedB{i}_0", "boolean")
                retyped_other += 1
    if retyped != n_retyped or retyped_other != n_retyped:
        raise ValueError(f"only {retyped} / {retyped_other} files to retype")
    return base, side, other, stmt


#: The rung3 repository: the bench's rung3 size (1,000 files x 6 decls,
#: ``bench.py``'s ladder). The driver merge and the resolve merge run in
#: it, not at rung5 (every rung5 merge spends a minute or more of host
#: time in extract, apply and commit, and on a card whose host disk is
#: slow the run would outgrow its time limit), and so do the service's
#: concurrent merges and the GC posture's.
RUNG3_FILES, RUNG3_DECLS = 1_000, 6
#: The fleet phase's repository: the rung3 shape at a quarter of its
#: files (its depth cut so that the smoke stays inside its time limit).
FLEET_FILES = 250
#: In it the driver merge's branch edits every 16th file (63 driver
#: starts) and the resolve merge's branches every 4th (250 conflicts).
DRV_EVERY, RSV_EVERY = 16, 4


#: The body ``rsv_base`` gives the last function of every 4th file, and
#: the two disjoint edits of it on ``rsv_a`` (line 1) and ``rsv_b``
#: (line 2).
RSV_BODY = "{\n  n = n + 1;\n  n = n * 2;\n  return n;\n}\n"


def extra_branches(base: dict, n_files: int, decls: int) -> dict:
    """Four more branches of a repository of ``n_files`` files of
    ``decls`` functions, each as (start, {path: content} of the files it
    changes):

    - ``drv`` (on base) renames the last function of every 16th file,
      ``fn<i>_5`` -> ``drv<i>_5`` (each such file is even, so side
      renames its first function: git starts the merge driver for every
      one of them). A rename and not a body edit: with the default
      engine settings a body edit is no op and the merge drops it, in
      the JAX package as in the port (``tests/test_torch_driver.py``);
    - ``rsv_base`` (on base) gives the last function of every 4th file
      a three-line body (:data:`RSV_BODY`); on it ``rsv_a`` edits its
      first line (``n = n + i;``) and ``rsv_b`` its second (``n = n *
      4;``): a ConcurrentStmtEdit per file under ``--strict-conflicts``,
      which the resolution tier merges line by line."""
    last = decls - 1
    branches = {"drv": ("base", {}), "rsv_base": ("base", {}),
                "rsv_a": ("rsv_base", {}), "rsv_b": ("rsv_base", {})}
    for i in range(n_files):
        path = f"src/mod{i:05d}.ts"
        content = base[path]
        if i % DRV_EVERY == 0:
            branches["drv"][1][path] = drv_rename(content, i, decls)
        if i % RSV_EVERY == 0:
            body = content.replace(f"{{ return {last}; }}\n", RSV_BODY)
            branches["rsv_base"][1][path] = body
            branches["rsv_a"][1][path] = body.replace("n = n + 1;", f"n = n + {i};")
            branches["rsv_b"][1][path] = body.replace("n = n * 2;", "n = n * 4;")
    return branches


def drv_rename(content: str, i: int, decls: int) -> str:
    """The drv branch's change to file ``i``: its last function renamed."""
    last = decls - 1
    return content.replace(f"function fn{i}_{last}(", f"function drv{i}_{last}(")


def _reshape(content: str, name: str, new_name: str, new_return: str) -> str:
    """Renames the file's first function and changes its return type."""
    head, rest = content.split("\n", 1)
    head = head.replace(f"function {name}(", f"function {new_name}(")
    return head.replace("): number {", f"): {new_return} {{") + "\n" + rest


def make_repo(root: pathlib.Path, base: dict, side: dict, other: dict,
              stmt: dict | None = None, extras: dict | None = None) -> None:
    """A git repository with branches ``base``, ``side`` and ``other``
    (and ``stmt`` if given), each a commit on ``base`` holding exactly
    its tree, ``side`` checked out. ``extras`` ({branch: (start,
    {path: content})}, in order) adds a commit per branch on its start
    that writes only those files (a content of None deletes the file). One ``git fast-import`` writes every
    commit (no work tree is written but ``side``'s, by the checkout)."""
    env = dict(os.environ, GIT_AUTHOR_NAME="smoke", GIT_AUTHOR_EMAIL="smoke@example.com",
               GIT_COMMITTER_NAME="smoke", GIT_COMMITTER_EMAIL="smoke@example.com")

    def git(*args):
        subprocess.run(["git", *args], cwd=root, env=env, check=True,
                       stdout=subprocess.DEVNULL)

    root.mkdir(parents=True)
    git("init", "-q", "-b", "base")
    git("config", "user.email", "smoke@example.com")  # git notes needs an identity
    git("config", "user.name", "smoke")
    stream = bytearray()

    def data(payload: bytes) -> None:
        stream.extend(b"data %d\n" % len(payload) + payload + b"\n")

    def commit(name: str, start: str | None, files: dict, whole_tree: bool) -> None:
        stream.extend(f"commit refs/heads/{name}\n"
                      "author smoke <smoke@example.com> 1704067200 +0000\n"
                      "committer smoke <smoke@example.com> 1704153600 +0000\n".encode())
        data(name.encode())
        if start is not None:
            stream.extend(f"from refs/heads/{start}\n".encode())
        if whole_tree:
            stream.extend(b"deleteall\n")
        for path, text in files.items():
            if text is None:
                stream.extend(f"D {path}\n".encode())
                continue
            stream.extend(f"M 100644 inline {path}\n".encode())
            data(text.encode())

    commit("base", None, base, True)
    for name, tree in (("other", other), ("stmt", stmt), ("side", side)):
        if tree is not None:
            commit(name, "base", tree, True)
    for name, (start, files) in (extras or {}).items():
        commit(name, start, files, False)
    subprocess.run(["git", "fast-import", "--quiet"], cwd=root, env=env, check=True,
                   input=bytes(stream), stdout=subprocess.DEVNULL)
    git("checkout", "-q", "-f", "side")


def _scans_of_run():
    """Wraps ``frontend.scanner.scan_snapshot_keyed`` for the callers that
    look it up at call time (the incremental scope's collision guard,
    ``runtime/git.py``; the engine binds its own): returns the wrapper's
    restore function and the :class:`ScanStats` its calls add up to."""
    from semantic_merge_tpu_torch.frontend import scanner

    total, orig = scanner.ScanStats(), scanner.scan_snapshot_keyed

    def counting(files, **kwargs):
        own = kwargs.get("stats")
        kwargs["stats"] = stats = scanner.ScanStats()
        try:
            return orig(files, **kwargs)
        finally:
            for name in ("native_files", "python_files", "hits", "misses"):
                setattr(total, name, getattr(total, name) + getattr(stats, name))
                if own is not None:
                    setattr(own, name, getattr(own, name) + getattr(stats, name))

    scanner.scan_snapshot_keyed = counting
    return (lambda: setattr(scanner, "scan_snapshot_keyed", orig)), total


def run_cli(torch, repo: pathlib.Path, argv: list, scanners: tuple = ("native",)):
    """Runs the port's ``semdiff`` or ``semmerge`` CLI function for
    ``argv`` in ``repo`` under a torch.profiler device trace, with the
    decl cache emptied and the launch counts and shapes set to 0 just
    before and read just after; fails unless the run's TypeScript scans
    are one of ``scanners`` (by default the native scanner, for every file
    the cache missed; none for the engines that scan no TypeScript in
    this process: the C-family engine, the worker). With the incremental
    scope the collision guard scans first (in the snapshot phase) and the
    engine's scan may then be all cache hits of this run's own native
    scans: the guard's scans count too. Returns the result, the counts,
    the shapes, the host wall and the device's busy time (union of its
    activities) in seconds."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch import cli, kernels
    from semantic_merge_tpu_torch.frontend.declcache import global_cache

    args = cli.build_parser().parse_args(argv)
    run = cli.semdiff if argv[0] == "semdiff" else cli.semmerge
    cwd = os.getcwd()
    os.chdir(repo)
    restore, guard = _scans_of_run()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # The CLI runs in this process: a cache warm from the last run
            # would make this run's scan look free.
            global_cache().clear()
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
    finally:
        restore()
        os.chdir(cwd)
    busy = _busy_us([(s, e) for _, s, e in _device_events(prof)]) / 1e6
    print(f"{' '.join(argv)}: wall {wall:.3f} s (under a torch.profiler trace); device busy "
          f"{busy:.4f} s, idle share {1 - busy / wall:.4f}; launches {launches}; launch shapes "
          f"{shapes}; phases (s) "
          + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                        for k, v in result.phases.items()}), flush=True)
    phases = result.phases
    if not scanners:
        return result, launches, shapes, wall, busy
    engine = phases.get("scanner")
    ran = {engine} | ({guard.scanner} if guard.native_files or guard.python_files else set())
    ran.discard("cache")
    if engine not in scanners and not (engine == "cache" and ran and ran <= set(scanners)):
        fail(f"{argv[0]} scanned with {engine!r} (the scope's guard: {guard.scanner!r}), "
             f"expected one of {scanners}")
    print(f"{' '.join(argv)}: scan {phases['scan']:.4f} s, {engine}; decl cache "
          f"{phases['decl_cache_hits']} hits, {phases['decl_cache_misses']} misses; the "
          f"scope's guard scanned {guard.native_files} files natively, "
          f"{guard.python_files} in Python ({guard.hits} hits)", flush=True)
    return result, launches, shapes, wall, busy


def expect_launches(path: str, launches: dict, want: dict) -> None:
    """Fails unless every kernel launched as often as ``want`` says on
    this path (``None``: at least once)."""
    for name, n in want.items():
        got = launches.get(name, 0)
        if (n is None and got == 0) or (n is not None and got != n):
            fail(f"{got} {name} launches on the {path} path, expected "
                 f"{'at least 1' if n is None else n}")


def write_config(root: pathlib.Path, ckpt: pathlib.Path, incremental: bool = True) -> str:
    """Writes the repository's ``.semmerge.toml`` (untracked, so no
    revision holds it): the matcher's checkpoint, a formatter that does
    nothing and no typecheck, so that the merge never waits on an
    ``npx`` without a network; ``incremental = false`` unless
    ``incremental``. Returns what it set."""
    text = (f'[engine]\nmatcher_ckpt_dir = "{ckpt}"\n'
            + ("" if incremental else "incremental = false\n") +
            '[languages.typescript]\nformatter_cmd = ["true"]\n'
            '[ci]\nrequire_typecheck = false\n')
    (root / ".semmerge.toml").write_text(text)
    return text


def _counts(ops) -> dict:
    counts: dict = {}
    for op in ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    return dict(sorted(counts.items()))


def check_semmerge(repo: pathlib.Path, result, n_files: int) -> None:
    """The merged work tree of a repository of ``n_files`` files, the
    text-merged README and the notes."""
    if result.code != 0:
        fail(f"semmerge exited {result.code}, expected 0")
    for i in range(0, n_files, 4):
        path = repo / "lib" / f"mod{i:05d}.ts"
        if not path.is_file() or f"renamed{i}_0" not in path.read_text():
            fail(f"{path.relative_to(repo)} is missing or lacks renamed{i}_0")
    readme = (repo / "README.md").read_text()
    if "(edited on A)" not in readme or "(edited on B)" not in readme:
        fail("README.md does not hold both sides' edits")
    for rev, log in (("side", result.result.op_log_left), ("other", result.result.op_log_right)):
        note = _note(repo, rev)
        if len(json.loads(note)) != len(log):
            fail(f"the semmerge note on {rev} holds {len(json.loads(note))} ops, "
                 f"its op log {len(log)}")


def _note(repo: pathlib.Path, rev: str) -> bytes:
    return subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=repo,
                          check=True, stdout=subprocess.PIPE).stdout


def _host_json(view) -> bytes:
    """An op-stream view's op log as the host serializer renders it."""
    return ("[" + ",".join(view._json_rows(0, len(view))) + "]").encode("utf-8")


def fused_semdiff_counts() -> dict:
    """Op counts of the fused semdiff base→side. At the rung5 size:
    5,000 renames (each also moves its decl, whose address holds its
    name, and shifts the other three decls of its file: 20,000 moves),
    256 retyped functions (a new signature, so a delete and an add, and
    three shifted decls each: 768 moves) and 98 added functions."""
    added = sum(1 for i in range(N_FILES) if i % 2 and i % 51 == 0)
    return {"addDecl": added + N_RETYPED, "deleteDecl": N_RETYPED,
            "moveDecl": 4 * ((N_FILES + 1) // 2) + 3 * N_RETYPED,
            "renameSymbol": (N_FILES + 1) // 2}


def check_fused_semdiff(torch, result) -> dict:
    """The fused semdiff's op log: an op-stream view with the expected
    counts, every id recomputed on the host with hashlib, and the op log
    rendered on the card equal to the host serializer's bytes."""
    from semantic_merge_tpu_torch.core.ids import deterministic_op_id
    from semantic_merge_tpu_torch.ops.oplog_view import OpStreamView
    from semantic_merge_tpu_torch.ops.render import render_view

    view = result.ops
    if not isinstance(view, OpStreamView) or "fused" not in result.phases:
        fail(f"the semdiff did not take the fused path (got {type(view).__name__})")
    counts, want = _counts(view), fused_semdiff_counts()
    print(f"fused semdiff ops by type {json.dumps(counts)}", flush=True)
    if counts != want:
        fail(f"fused semdiff op counts {counts}, expected {want}")
    types = ("renameSymbol", "moveDecl", "addDecl", "deleteDecl")
    rev = view.prov["rev"]
    ids = view.ids()
    for i, (k, a, b) in enumerate(zip(view.kind.tolist(), view.a_slot.tolist(),
                                      view.b_slot.tolist())):
        an = view.base_nodes[a] if types[k] != "addDecl" else None
        bn = view.side_nodes[b] if types[k] != "deleteDecl" else None
        want = deterministic_op_id("0/R", rev, i, types[k], (an or bn).symbolId,
                                   an.addressId if an else "", bn.addressId if bn else "")
        if ids[i] != want:
            fail(f"fused semdiff op {i}: id {ids[i]} != hashlib's {want}")
    t0 = time.perf_counter()
    rendered = render_view(view, "cuda").json_bytes()
    render_s = time.perf_counter() - t0
    if rendered != _host_json(view):
        fail("the fused semdiff's op log rendered on the card differs from _json_rows")
    return {"ops": len(view), "ids_checked": len(ids), "render_s": render_s,
            "rendered_bytes": len(rendered)}


def check_fused_semmerge(torch, work: pathlib.Path, merged) -> dict:
    """The fused semmerge: the path taken, the tree and notes as in
    :func:`check_semmerge`, each note's bytes (rendered on the card)
    equal to the host serializer's, and the device compose of the
    materialized op logs, on the card, equal to the fused composed
    stream."""
    from semantic_merge_tpu_torch.ops.compose import compose_oplogs_device
    from semantic_merge_tpu_torch.ops.oplog_view import ComposedOpView

    if not (isinstance(merged.composed, ComposedOpView) and merged.composed.supports_columns
            and "fused" in merged.phases and "compose" not in merged.phases):
        fail("the semmerge did not take the fused path")
    check_semmerge(work, merged, N_FILES)
    left, right = merged.result.op_log_left, merged.result.op_log_right
    for rev, view in (("side", left), ("other", right)):
        if view.render is None:
            fail(f"the op log of {rev} ({len(view)} ops) was not rendered on the card")
        if _note(work, rev).rstrip(b"\n") != _host_json(view):
            fail(f"the semmerge note on {rev} differs from _json_rows's rendering")
    fused_composed = [o.to_dict() for o in merged.composed]
    ops, conflicts = compose_oplogs_device(list(left), list(right), device="cuda")
    if ([o.to_dict() for o in ops] != fused_composed
            or [c.to_dict() for c in conflicts] != [c.to_dict() for c in merged.conflicts]):
        fail("compose_oplogs_device on the card differs from the fused composed stream")
    counts = {"A": _counts(left), "B": _counts(right), "composed": _counts(merged.composed),
              "conflicts": len(merged.conflicts)}
    print(f"fused semmerge ops by type {json.dumps(counts)}; notes rendered on the card "
          "equal _json_rows; compose_oplogs_device on the card equals the fused composed "
          "stream", flush=True)
    if len(fused_composed) != len(left) + len(right) or merged.conflicts:
        fail(f"{len(fused_composed)} composed ops from {len(left)} + {len(right)}, "
             f"{len(merged.conflicts)} conflicts")
    return counts


def check_strict_semmerge(work: pathlib.Path, side: dict, merged, n_files: int,
                          decls: int) -> dict:
    """The strict merge of side and stmt (of a repository of ``n_files``
    files x ``decls`` decls): exit 0 and no conflict, taken
    without the fused engine (build-and-diff, strict detection, device
    compose), B's op log one ``editStmtBlock`` per edited body, every
    edited body and every function of side (renamed, retyped, added) in
    the merged tree, and both op logs in the notes."""
    if merged.code != 0 or merged.conflicts:
        fail(f"the strict semmerge exited {merged.code} with {len(merged.conflicts)} conflicts, "
             "expected 0 and none")
    if "fused" in merged.phases or not {"strict_detect", "compose"} <= set(merged.phases):
        fail("the strict semmerge did not take build-and-diff, strict detection and compose")
    left, right = merged.result.op_log_left, merged.result.op_log_right
    counts = {"A": _counts(left), "B": _counts(right), "composed": _counts(merged.composed)}
    print(f"strict semmerge ops by type {json.dumps(counts)}", flush=True)
    edited = range(0, n_files, 3)
    if counts["B"] != {"editStmtBlock": len(edited)}:
        fail(f"B's op log is {counts['B']}, expected {len(edited)} editStmtBlock ops")
    last = decls - 1
    for i in edited:
        text = (work / "src" / f"mod{i:05d}.ts").read_text()
        if f"{{ return {last} + {i}; }}" not in text:
            fail(f"src/mod{i:05d}.ts lacks its body edit")
    for path, content in side.items():
        if not path.endswith(".ts"):
            continue
        text = (work / path).read_text()
        for name in re.findall(r"function (\w+)\(", content):
            if f"function {name}(" not in text:
                fail(f"{path} lacks side's function {name}")
    for rev, log in (("side", left), ("stmt", right)):
        note = json.loads(_note(work, rev))
        types = [o["type"] for o in note]
        if {t: types.count(t) for t in set(types)} != _counts(log):
            fail(f"the semmerge note on {rev} does not hold its op log")
    return counts


def check_compose(torch, result) -> dict:
    """The merge's two op logs composed again on the CPU must give the
    card's composed stream and conflicts; then the device compose alone,
    at that shape: device time and kernels of one call (torch.profiler),
    torch.sort's share of that time, and host time per call."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch.ops.compose import compose_oplogs_device

    left, right = result.result.op_log_left, result.result.op_log_right
    cpu_ops, cpu_conflicts = compose_oplogs_device(left, right, device="cpu")
    if ([o.to_dict() for o in cpu_ops] != [o.to_dict() for o in result.composed]
            or [c.to_dict() for c in cpu_conflicts] != [c.to_dict() for c in result.conflicts]):
        fail("the device compose on the card differs from the CPU's")
    compose_oplogs_device(left, right, device="cuda")  # warm
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        compose_oplogs_device(left, right, device="cuda")
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compose_oplogs_device(left, right, device="cuda")
        torch.cuda.synchronize()
    events = _device_events(prof)
    kernels_ = [(n, s, e) for n, s, e in events if not n.startswith("Mem")]
    device_ms = sum(e - s for _, s, e in events) / 1e3
    sort_ms = sum(e - s for n, s, e in kernels_ if "sort" in n.lower()) / 1e3
    return {"n_a": len(left), "n_b": len(right), "n_out": len(result.composed),
            "conflicts": len(result.conflicts), "host_ms_per_call": host_ms,
            "device_ms": device_ms, "device_kernels": len(kernels_),
            "device_copies": len(events) - len(kernels_), "sort_ms": sort_ms,
            "sort_share": sort_ms / device_ms if device_ms else None}


class GpuSampler:
    """Samples the card's used memory (``cudaMemGetInfo``, the whole
    device) every ``every`` seconds in a thread, from ``__enter__`` to
    ``__exit__``: ``rise_mib`` is the most it rose above its level at the
    start while this process allocated nothing. (``nvidia-smi``'s list of
    compute processes cannot tell this process from another in a
    container whose processes it lists as pid 1.)"""

    def __init__(self, every: float = 0.5) -> None:
        self.every, self.samples, self.rise_mib = every, 0, 0.0

    def _used_mib(self) -> float:
        import torch
        free, total = torch.cuda.mem_get_info(0)
        return (total - free) / 2**20

    def __enter__(self):
        import threading
        self.baseline_mib = self._used_mib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(self.every):
                self.rise_mib = max(self.rise_mib, self._used_mib() - self.baseline_mib)
                self.samples += 1

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def driver_starts(trace: pathlib.Path) -> list:
    """Seconds each start of the port's driver took, from git's trace2
    event log (``child_start`` / ``child_exit`` of ``git merge``)."""
    started, seconds = {}, []
    for line in trace.read_text().splitlines() if trace.is_file() else []:
        event = json.loads(line)
        key = (event.get("sid"), event.get("child_id"))
        if event.get("event") == "child_start" and \
                "semantic_merge_tpu_torch.driver" in " ".join(event.get("argv", [])):
            started[key] = True
        elif event.get("event") == "child_exit" and key in started:
            seconds.append(float(event["t_rel"]))
    return seconds


#: The least rise of the card's used memory that counts as another
#: process's CUDA context (a context takes several hundred MiB).
CONTEXT_MIB = 100


def run_driver_merge(repo: pathlib.Path, clone: pathlib.Path, ckpt: pathlib.Path,
                     expected: dict, dirty: set, n_drv: int) -> dict:
    """``git merge --no-ff drv`` on ``side`` in a clone of ``repo`` with
    the port's merge driver registered for ``*.ts`` (in
    ``.git/info/attributes``, so no tree changes) and the default engine
    settings: git starts the driver once per file both branches changed,
    and the first start runs the whole merge through the CLI
    (``semmerge base side drv --inplace --git``: the fused engine).
    Fails unless git exits 0 without degrading, the merge commit's tree
    is ``expected`` ({path: content}), the work tree differs from it in
    the paths ``dirty`` and no other (the engine writes its whole merged
    tree in place, git commits its own merge of the files one side
    changed), the driver's latch exists, the notes sit on both heads
    (drv's: ``n_drv`` renames and their moves), git's trace2 log holds
    ``n_drv`` starts of the driver, and a process other than this one
    held a context on the card during the merge: the card's used memory
    rose by at least :data:`CONTEXT_MIB` while this process allocated
    nothing."""
    subprocess.run(["git", "clone", "-q", "--shared", str(repo), str(clone)], check=True)

    def git(*args, env=None):
        return subprocess.run(["git", *args], cwd=clone, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)

    git("checkout", "-q", "side")
    git("branch", "-q", "drv", "origin/drv")
    git("config", "user.email", "smoke@example.com")
    git("config", "user.name", "smoke")
    git("config", "merge.semmerge.driver", " ".join(
        [sys.executable, "-m", "semantic_merge_tpu_torch.driver", "%O", "%A", "%B", "%P"]))
    (clone / ".git" / "info").mkdir(exist_ok=True)
    (clone / ".git" / "info" / "attributes").write_text("*.ts merge=semmerge\n")
    write_config(clone, ckpt)
    trace = clone.parent / "driver-trace2.jsonl"
    trace.unlink(missing_ok=True)
    # SEMMERGE_DAEMON=off: the driver's default posture (auto) would spawn
    # a merge service daemon on the default socket and hand it the merge;
    # this phase measures the one-shot child, the service phase the daemon.
    env = dict(os.environ, PYTHONPATH=str(REPO), GIT_TRACE2_EVENT=str(trace),
               SEMMERGE_DAEMON="off",
               GIT_AUTHOR_DATE="2024-01-03T00:00:00Z", GIT_COMMITTER_DATE="2024-01-03T00:00:00Z")
    heads = [git("rev-parse", rev).stdout.strip() for rev in ("side", "drv")]
    t0 = time.perf_counter()
    with GpuSampler() as sampler:
        proc = git("merge", "--no-ff", "drv", "-m", "driver merge", env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"git merge through the driver exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    if "merge degrading" in proc.stderr:
        fail(f"the driver's merge degraded to the text rung:\n{proc.stderr[-3000:]}")
    parents = git("rev-list", "--parents", "-n", "1", "HEAD").stdout.split()[1:]
    if parents != heads:
        fail(f"HEAD is not the merge of side and drv (parents {parents})")
    committed = _tree_blobs(clone, "HEAD")
    if set(committed) != set(expected):
        fail(f"the merge commit holds {len(committed)} files, expected {len(expected)}")
    wrong = [p for p in sorted(expected) if committed[p] != expected[p].encode()]
    if wrong:
        fail(f"{len(wrong)} files of the merge commit differ from side's tree with drv's "
             f"renames, e.g. {wrong[:3]}")
    unlike_head = set(git("diff", "--name-only", "HEAD").stdout.split())
    if unlike_head != dirty:
        fail(f"{len(unlike_head)} work-tree files differ from the merge commit, expected the "
             f"{len(dirty)} side retyped or added to; e.g. {sorted(unlike_head ^ dirty)[:3]}")
    if not (clone / ".git" / ".semmerge.lock").is_file():
        fail("the driver's latch .git/.semmerge.lock is missing")
    note_ops = {}
    for rev, sha in zip(("side", "drv"), heads):
        note = git("notes", "--ref", "semmerge", "show", sha)
        if note.returncode != 0:
            fail(f"no semmerge note on {rev}")
        note_ops[rev] = _counts_json(json.loads(note.stdout))
    if note_ops["drv"] != {"moveDecl": n_drv, "renameSymbol": n_drv}:
        fail(f"the note on drv holds {note_ops['drv']}, expected {n_drv} renames and moves")
    starts = driver_starts(trace)
    if len(starts) != n_drv:
        fail(f"git's trace2 log holds {len(starts)} starts of the driver, expected {n_drv}")
    out = {"git_wall_s": wall, "driver_starts": len(starts), "child_wall_s": max(starts),
           "other_starts_s": sum(starts) - max(starts), "notes": note_ops,
           "work_tree_files_unlike_head": len(unlike_head),
           "card_used_rise_mib": sampler.rise_mib, "samples": sampler.samples}
    if sampler.rise_mib < CONTEXT_MIB:
        fail(f"no process other than this one held the card during the driver's merge: "
             f"{json.dumps(out)}")
    return out


# --- the trace phase ---------------------------------------------------------

def _schema_checker():
    """``scripts/check_trace_schema.py`` (standard library only, outside
    both packages), loaded from the checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_trace_schema", REPO / "scripts" / "check_trace_schema.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cli_traced(repo: pathlib.Path, argv: list):
    """Runs the port's CLI function for ``argv`` (which carries
    ``--trace`` and/or ``--profile DIR``) in ``repo``, with no profiler
    of this script around it (the CLI's own ``--profile`` runs one), the
    decl cache emptied and the launch counts set to 0 just before and
    read just after. For ``semdiff`` the tracer's artifacts are written
    as ``main`` writes them. Returns the result, the counts and the
    wall (s, ending in ``torch.cuda.synchronize()``)."""
    import torch

    from semantic_merge_tpu_torch import cli, kernels
    from semantic_merge_tpu_torch.frontend.declcache import global_cache

    args = cli.build_parser().parse_args(argv)
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        global_cache().clear()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if argv[0] == "semdiff":
            result = cli.semdiff(args)
            result.tracer.write()
        else:
            result = cli.semmerge(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        os.chdir(cwd)
    return result, launches, wall


def _work_tree(root: pathlib.Path, config: bool = True) -> dict:
    """{path: bytes} of every file of a work tree but ``.git`` and the
    trace artifacts (and, unless ``config``, its ``.semmerge.toml``)."""
    skip = {".git", ".semmerge-trace.json", ".semmerge-events.jsonl", ".semmerge-postmortem"}
    if not config:
        skip.add(".semmerge.toml")
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and not skip & set(p.relative_to(root).parts)}


def profile_records(profile_dir: pathlib.Path) -> tuple:
    """(kernel name → records, ``semmerge/<phase>`` range names, bytes)
    of the one torch.profiler trace in ``profile_dir``."""
    traces = sorted(profile_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"{profile_dir} holds {len(traces)} torch.profiler traces, expected 1")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels_: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            for name in ("sha256", "flash_chunk"):
                if name in e.get("name", ""):
                    kernels_[name] = kernels_.get(name, 0) + 1
    ranges = {e["name"] for e in events if str(e.get("name", "")).startswith("semmerge/")}
    return kernels_, ranges, traces[0].stat().st_size


def check_trace_artifacts(schema, trace_path: pathlib.Path, events_path: pathlib.Path | None,
                          card: str) -> dict:
    """The trace (and events) pass ``validate_trace`` / ``validate_events``;
    the device block names the card. Returns the trace."""
    trace = json.loads(trace_path.read_text())
    errors = schema.validate_trace(trace)
    if events_path is not None:
        errors += schema.validate_events(events_path.read_text().splitlines())
    if errors:
        fail(f"{trace_path.name}: schema errors {errors[:5]}")
    device = trace["device"]
    if device["platform"] != "gpu" or card not in device["device_kinds"] \
            or device["jax_imported"] is not False:
        fail(f"the trace's device block {json.dumps(device)} does not name the card {card!r}")
    return trace


def check_traced_fused_semmerge(repo: pathlib.Path, fused_tree: pathlib.Path,
                                trace_tree: pathlib.Path, ckpt: pathlib.Path,
                                untraced: dict, card: str) -> dict:
    """Phase ``trace`` (a): ``semmerge base side other --inplace --trace
    --profile DIR`` in a fresh work tree at side must leave the untraced
    fused merge's tree and notes, launch ``sha256`` as often from a cold
    engine, write artifacts that pass the schema script with the card in
    the device block, a profile with one ``sha256`` record per launch and
    a ``semmerge/<phase>`` range per CLI phase, and a span tree holding
    ``fused_merge``, ``apply_columnar`` and ``inplace_commit``.
    ``untraced`` holds the untraced merge's ``notes``, ``sha256``
    launches and ``wall``."""
    schema = _schema_checker()
    subprocess.run(["git", "worktree", "add", "-q", "--detach", str(trace_tree), "side"],
                   cwd=repo, check=True)
    write_config(trace_tree, ckpt)
    prof_dir = WORK / "profile_merge"
    merged, launches, wall = run_cli_traced(
        trace_tree, ["semmerge", "base", "side", "other", "--inplace", "--trace",
                     "--profile", str(prof_dir)])
    if merged.code != 0:
        fail(f"the traced semmerge exited {merged.code}")
    if launches.get("sha256") != untraced["sha256"]:
        fail(f"the traced semmerge launched sha256 {launches.get('sha256')} times, the "
             f"untraced one {untraced['sha256']} (both from a cold engine)")
    if _work_tree(trace_tree) != _work_tree(fused_tree):
        fail("the traced semmerge's tree differs from the untraced fused merge's")
    if {rev: _note(repo, rev) for rev in ("side", "other")} != untraced["notes"]:
        fail("the traced semmerge's notes differ from the untraced fused merge's")
    trace = check_trace_artifacts(schema, trace_tree / ".semmerge-trace.json",
                                  trace_tree / ".semmerge-events.jsonl", card)
    if json.loads((prof_dir / "semmerge-trace.json").read_text())["phases"] != trace["phases"]:
        fail("DIR/semmerge-trace.json holds other phases than .semmerge-trace.json")
    names = {s["name"] for s in trace["spans"]}
    missing = {"fused_merge", "apply_columnar", "inplace_commit"} - names
    if missing:
        fail(f"the traced semmerge's span tree lacks {sorted(missing)}")
    records, ranges, size = profile_records(prof_dir)
    phases = [p["name"] for p in trace["phases"]]
    if records.get("sha256", 0) != launches["sha256"]:
        fail(f"the profile holds {records.get('sha256', 0)} sha256 records for "
             f"{launches['sha256']} launches")
    if {f"semmerge/{name}" for name in phases} - ranges:
        fail(f"the profile lacks ranges {sorted({f'semmerge/{n}' for n in phases} - ranges)}")
    failures = trace["metrics"]["counters"].get("profiler_capture_failures_total")
    if failures and failures["series"]:
        fail(f"profiler capture failures: {failures['series']}")
    return {"wall_s": wall, "untraced_wall_s": untraced["wall"],
            "sha256_launches": launches["sha256"],
            "sha256_records": records.get("sha256", 0), "phases": phases,
            "ranges": sorted(ranges), "spans": len(trace["spans"]),
            "profile_bytes": size, "trace_bytes": (trace_tree / ".semmerge-trace.json").stat().st_size,
            "transfer_bytes": trace["device"]["transfer_bytes"],
            "live_buffer_bytes_hwm": trace["device"]["live_buffer_bytes_hwm"],
            "span_totals_s": {p["name"]: p["seconds"] for p in trace["phases"]}}


def check_profiled_matcher_semdiff(repo: pathlib.Path, card: str) -> dict:
    """Phase ``trace`` (b): ``semdiff base side --json-out
    --change-signature --signature-matcher --profile DIR2``: its profile
    holds one ``flash_chunk`` record per launch (8), its
    ``DIR2/semmerge-trace.json`` passes the schema script."""
    schema = _schema_checker()
    prof_dir = WORK / "profile_semdiff"
    result, launches, wall = run_cli_traced(
        repo, ["semdiff", "base", "side", "--json-out", "--change-signature",
               "--signature-matcher", "--profile", str(prof_dir)])
    expect_launches("profiled matcher semdiff", launches, {"flash_chunk": 8, "sha256": 0})
    check_trace_artifacts(schema, prof_dir / "semmerge-trace.json", None, card)
    if (repo / ".semmerge-trace.json").exists():
        fail("--profile without --trace wrote .semmerge-trace.json")
    records, ranges, size = profile_records(prof_dir)
    if records.get("flash_chunk", 0) != launches["flash_chunk"]:
        fail(f"the profile holds {records.get('flash_chunk', 0)} flash_chunk records for "
             f"{launches['flash_chunk']} launches")
    if {"semmerge/snapshot", "semmerge/diff"} - ranges:
        fail(f"the semdiff profile lacks its phase ranges: {sorted(ranges)}")
    return {"wall_s": wall, "flash_chunk_launches": launches["flash_chunk"],
            "flash_chunk_records": records.get("flash_chunk", 0), "ranges": sorted(ranges),
            "profile_bytes": size, "ops": len(result.ops)}


# --- the service phase -------------------------------------------------------

#: The concurrent leg's clients: four clones of the rung3 repository
#: merged at once.
SVC_CLIENTS = 4
#: The checkout's TPU-era perf records: ``perf`` must never write them.
PERF_FILES = ("PERF_BASELINE.json", "BENCH_trajectory.jsonl")


def _digest(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()


def _svc_env(sock: pathlib.Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMMERGE_")}
    env.update(PYTHONPATH=str(REPO), SEMMERGE_SERVICE_SOCKET=str(sock), **extra)
    return env


def _svc_status(sock: pathlib.Path) -> dict:
    from semantic_merge_tpu_torch.service import client
    return client.call_control("status", path=str(sock), timeout=60)


def _svc_verb(sock: pathlib.Path, root: pathlib.Path, verb: str, argv: list) -> dict:
    """One request on the wire, as a client process sends it (argv, cwd,
    env): the result frame, with the daemon's ``meta`` (its queue wait
    and the CLI's phases)."""
    from semantic_merge_tpu_torch.service import client
    t0 = time.perf_counter()
    resp = client.call_verb(verb, {"argv": argv, "cwd": str(root), "env": {}},
                            path=str(sock), timeout=900)
    if "result" not in resp:
        fail(f"the daemon refused {verb} {' '.join(argv)}: {resp.get('error')}")
    resp["result"]["wall_s"] = time.perf_counter() - t0
    return resp["result"]


def _clone_at_side(src: pathlib.Path, dst: pathlib.Path, ckpt: pathlib.Path) -> None:
    subprocess.run(["git", "clone", "-q", "--local", "--no-checkout", str(src), str(dst)],
                   check=True)
    for rev in ("base", "side", "other"):
        if rev != "side":
            subprocess.run(["git", "branch", "-q", rev, f"origin/{rev}"], cwd=dst, check=True)
    subprocess.run(["git", "checkout", "-q", "-B", "side", "origin/side"], cwd=dst, check=True)
    for key, value in (("user.email", "smoke@example.com"), ("user.name", "smoke")):
        subprocess.run(["git", "config", key, value], cwd=dst, check=True)
    write_config(dst, ckpt)


class OtlpCollector:
    """A loopback OTLP/HTTP collector on a thread of this process: every
    POST's path and JSON body, answered 200, until :meth:`close`."""

    def __init__(self) -> None:
        import http.server
        import threading
        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                received.append((self.path, json.loads(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=30)


def _counter(st: dict, name: str, **labels) -> float:
    series = ((st.get("metrics") or {}).get("counters") or {}).get(name, {}).get("series", [])
    return sum(s["value"] for s in series if all(s["labels"].get(k) == v
                                                for k, v in labels.items()))


def check_export(sock: pathlib.Path, collector: OtlpCollector, known: list) -> dict:
    """Every served request's trace reached the collector: one valid
    ``/v1/traces`` payload per request (``validate_export``), the
    requests whose trace ids this script knows among them (left-padded
    to 32 hex digits), ``otlp_exported_total{kind="traces"}`` equal to
    the payloads received, no error and no drop. Also times the
    conversion a request pays on its executor thread
    (``spans_to_otlp`` of the largest payload's spans, then its JSON)."""
    from semantic_merge_tpu_torch.obs import export

    t0 = time.perf_counter()
    while True:
        st = _svc_status(sock)
        served = st["served_total"]
        done = sum(_counter(st, name, **labels) for name, labels in (
            ("otlp_exported_total", {"kind": "traces"}), ("otlp_errors_total", {}),
            ("otlp_dropped_total", {"kind": "traces"})))
        if done >= served or time.perf_counter() - t0 > 60:
            break
        time.sleep(0.2)
    exported = _counter(st, "otlp_exported_total", kind="traces")
    errors, dropped = _counter(st, "otlp_errors_total"), _counter(st, "otlp_dropped_total")
    traces = [body for path, body in collector.received if path == "/v1/traces"]
    if errors or dropped or not exported == len(traces) == served:
        fail(f"OTLP export: {served} requests served, {len(traces)} traces received, "
             f"exported {exported}, errors {errors}, dropped {dropped}")
    schema = _schema_checker()
    ids = set()
    for body in traces:
        errs = schema.validate_export(body)
        scopes = body["resourceSpans"][0]["scopeSpans"]
        spans = [sp for scope in scopes for sp in scope["spans"]]
        tids = {sp["traceId"] for sp in spans}
        if errs or len(tids) != 1 or {sc["scope"]["name"] for sc in scopes} != \
                {"semantic_merge_tpu_torch"}:
            fail(f"an exported trace: schema errors {errs[:3]}, trace ids {sorted(tids)}")
        ids |= tids
    missing = {tid.rjust(32, "0") for tid in known} - ids
    if missing:
        fail(f"OTLP export: no trace for the requests {sorted(missing)}")
    # What a request pays on its executor thread: the conversion of its
    # span rows (the largest payload's, rebuilt as rows), then its JSON.
    spans = max(([sp for sc in b["resourceSpans"][0]["scopeSpans"] for sp in sc["spans"]]
                 for b in traces), key=len)
    epoch = min(int(sp["startTimeUnixNano"]) for sp in spans)
    rows = [{"name": sp["name"], "span_id": int(sp["spanId"], 16),
             "parent_id": int(sp["parentSpanId"], 16) if "parentSpanId" in sp else -1,
             "t_start": (int(sp["startTimeUnixNano"]) - epoch) / 1e9,
             "seconds": (int(sp["endTimeUnixNano"]) - int(sp["startTimeUnixNano"])) / 1e9,
             "meta": {a["key"]: next(iter(a["value"].values())) for a in sp["attributes"]}}
            for sp in spans]
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        json.dumps(export.spans_to_otlp("0" * 16, rows, epoch_unix_nano=epoch))
    return {"requests": served, "traces_received": len(traces), "exported": exported,
            "errors": errors, "known_trace_ids": len(known), "largest_trace_spans": len(spans),
            "conversion_us_per_request": (time.perf_counter() - t0) / reps * 1e6}


#: ``bundle.json``'s keys in the JAX daemon's ``_capture_profile``.
JAX_BUNDLE_KEYS = {"schema", "ok", "profiler_started", "seconds", "t_start", "t_end", "pid",
                   "metrics_before", "metrics_after", "spans", "slo"}


def _bundle(result: dict, daemon_pid: int) -> tuple:
    """(``bundle.json``, the trace's events) of a capture's bundle, its
    keys the JAX bundle's and its trace written by the daemon."""
    bundle_dir = pathlib.Path(result["dir"])
    bundle = json.loads((bundle_dir / "bundle.json").read_text())
    if set(bundle) != JAX_BUNDLE_KEYS or bundle["pid"] != daemon_pid:
        fail(f"bundle.json keys {sorted(bundle)} (pid {bundle['pid']}), expected "
             f"{sorted(JAX_BUNDLE_KEYS)} from {daemon_pid}")
    traces = sorted(bundle_dir.glob("*.pt.trace.json"))
    if not result["profiler_started"]:
        return bundle, None
    if len(traces) != 1 or not traces[0].name.split(".")[0].endswith(f"_{daemon_pid}"):
        fail(f"the bundle {bundle_dir} holds {[t.name for t in traces]}, expected one "
             f"trace of the daemon's process {daemon_pid}")
    return bundle, json.loads(traces[0].read_text())["traceEvents"]


def _threads(events: list, cat: str) -> dict:
    tids: dict = {}
    for e in events:
        if e.get("cat") == cat:
            tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    return tids


def check_daemon_profile(sock: pathlib.Path, root: pathlib.Path, phase4: dict,
                         daemon_pid: int) -> dict:
    """``profile --daemon --seconds 2 --json --out DIR`` from a client
    process, while warm fused semdiffs (no ``--profile``) are served one
    after another: exit 0, ``ok`` and ``profiler_started``, a bundle
    with the JAX bundle's keys, and a trace of the daemon's process
    holding ``sha256`` kernel records (CUPTI records every thread's
    kernels). Prints the kernel names seen and whether the executor
    threads' CPU ops are in the trace."""
    out_dir = WORK / "profile_daemon"
    t0 = time.perf_counter()
    proc = started(subprocess.Popen(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "profile", "--daemon", "--seconds",
         "2", "--json", "--out", str(out_dir)], cwd=WORK, env=_svc_env(sock),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    while not any(out_dir.glob("profile-*")):
        if proc.poll() is not None or time.perf_counter() - t0 > 180:
            fail(f"profile --daemon opened no bundle (exit {proc.poll()})")
        time.sleep(0.02)
    walls = []
    while proc.poll() is None or not walls:
        warm = _svc_verb(sock, root, "semdiff", ["base", "side", "--json-out"])
        if warm["exit_code"] != 0 or _digest(warm["stdout"]) != phase4["fused_semdiff"]:
            fail("a warm semdiff served during the capture gave another op log than phase 4's")
        walls.append(warm["wall_s"])
    stdout, stderr = proc.communicate(timeout=180)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"profile --daemon exited {proc.returncode}: {stderr[-2000:]}")
    result = json.loads(stdout)
    if not (result["ok"] and result["profiler_started"] and "bundle.json" in result["files"]):
        fail(f"profile --daemon answered {json.dumps(result)}")
    bundle, events = _bundle(result, daemon_pid)
    kernel_names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    sha = sum(1 for e in events if e.get("cat") == "kernel" and "sha256" in e["name"])
    if not sha:
        fail(f"the daemon capture holds no sha256 kernel record: kernels {kernel_names[:20]}")
    cpu_ops, runtime = _threads(events, "cpu_op"), _threads(events, "cuda_runtime")
    ranges = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("semmerge/")})
    print(f"service: profile --daemon (2 s window, {len(walls)} warm semdiffs served in it): "
          f"{len(kernel_names)} kernel names, {sha} sha256 records; kernels "
          f"{json.dumps(kernel_names[:12])}; executor-side CPU ops in the trace: "
          f"{'yes' if cpu_ops else 'no'} ({sum(cpu_ops.values())} cpu_op events on "
          f"{len(cpu_ops)} threads; CUDA runtime calls on {len(runtime)} threads); "
          f"semmerge/ ranges {ranges}", flush=True)
    return {"client_wall_s": wall, "window_s": result["seconds"], "warm_semdiffs": len(walls),
            "warm_semdiff_walls_s": walls, "files": result["files"],
            "kernel_names": len(kernel_names), "sha256_records": sha,
            "cpu_op_events": sum(cpu_ops.values()), "cpu_op_threads": len(cpu_ops),
            "cuda_runtime_threads": len(runtime), "flight_spans": len(bundle["spans"])}


def check_profile_overlap(sock: pathlib.Path, root: pathlib.Path, phase4: dict,
                          daemon_pid: int) -> dict:
    """A daemon capture (2 s) and the profiled matcher semdiff (``--profile
    DIR``) at once: the process holds one profiler session, so one of
    them runs without it; both answer, the semdiff's op log is phase
    4's, and the daemon still answers ``status``."""
    import threading

    from semantic_merge_tpu_torch.service import client
    cap_dir, req_dir = WORK / "profile_overlap", WORK / "profile_overlap_request"
    box: dict = {}

    def capture():
        box["result"] = client.capture_profile(2.0, out_dir=str(cap_dir), path=str(sock))

    before = _counter(_svc_status(sock), "profiler_capture_failures_total", reason="busy")
    thread = threading.Thread(target=capture, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    while not any(cap_dir.glob("profile-*")):
        if not thread.is_alive() or time.perf_counter() - t0 > 60:
            fail(f"the overlapping capture opened no bundle: {box}")
        time.sleep(0.01)
    matcher = _svc_verb(sock, root, "semdiff",
                        ["base", "side", "--json-out", "--change-signature",
                         "--signature-matcher", "--profile", str(req_dir)])
    thread.join(timeout=180)
    result = box.get("result") or {}
    if matcher["exit_code"] != 0 or _digest(matcher["stdout"]) != phase4["matcher_semdiff"]:
        fail(f"the matcher semdiff served during a capture: exit {matcher['exit_code']}, "
             "op log other than phase 4's")
    if not result.get("ok"):
        fail(f"the capture beside a profiled request answered {result}")
    _, events = _bundle(result, daemon_pid)
    st = _svc_status(sock)
    busy = _counter(st, "profiler_capture_failures_total", reason="busy") - before
    req_traces = sorted(req_dir.glob("*.pt.trace.json"))
    flash = None if events is None else sum(
        1 for e in events if e.get("cat") == "kernel" and "flash_chunk" in e["name"])
    return {"capture_profiler_started": result["profiler_started"],
            "request_profile_traces": len(req_traces), "busy_refusals": busy,
            "capture_flash_chunk_records": flash, "matcher_wall_s": matcher["wall_s"]}


def check_top_and_perf(sock: pathlib.Path, daemon_pid: int) -> dict:
    """``top --once --json``, ``top --once`` and ``perf record --daemon``
    from client processes at once, then ``perf compare --daemon``, with
    the baseline and the trajectory under this run's scratch directory
    (never the checkout's ``PERF_BASELINE.json``): exit 0 each, the
    status's package and pid, the JAX frame's head line, the record's
    line, and a compare of the same window that finds no regression."""
    env = _svc_env(sock, SEMMERGE_BENCH_TRAJECTORY=str(WORK / "bench_trajectory.jsonl"))
    baseline = WORK / "perf_baseline.json"
    cmd = [sys.executable, "-m", "semantic_merge_tpu_torch"]

    def run(argvs: dict) -> dict:
        procs = {name: started(subprocess.Popen(cmd + argv, cwd=WORK, env=env,
                                                stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True))
                 for name, argv in argvs.items()}
        outs = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"{' '.join(argvs[name])} exited {proc.returncode}: {err[-2000:]}")
            outs[name] = out
        return outs

    t0 = time.perf_counter()
    outs = run({"top_json": ["top", "--once", "--json"], "top": ["top", "--once"],
                "record": ["perf", "record", "--daemon", "--baseline", str(baseline)]})
    outs.update(run({"compare": ["perf", "compare", "--daemon", "--baseline", str(baseline)]}))
    wall = time.perf_counter() - t0
    snap = json.loads(outs["top_json"])
    if snap["status"]["package"] != "semantic_merge_tpu_torch" or \
            snap["status"]["pid"] != daemon_pid or snap["members"] is not None:
        fail(f"top --once --json: {json.dumps(snap)[:500]}")
    if not outs["top"].startswith(f"semmerge top — merge daemon pid {daemon_pid}  uptime "):
        fail(f"top --once printed {outs['top'][:300]!r}")
    if outs["record"] != f"recorded 1 entry into {baseline}: daemon\n":
        fail(f"perf record --daemon printed {outs['record']!r}")
    if not outs["compare"].startswith(f"perf compare vs {baseline}: OK\n"):
        fail(f"perf compare --daemon printed {outs['compare']!r}")
    print(f"service: top --once\n{outs['top']}service: perf compare --daemon\n"
          f"{outs['compare']}", end="", flush=True)
    return {"served_total": snap["status"]["served_total"], "wall_s": wall,
            "baseline_entry": json.loads(baseline.read_text())["entries"]["daemon"]}


def _phase_sums(dump: pathlib.Path) -> dict:
    """Seconds per phase in a ``SEMMERGE_METRICS`` dump."""
    hist = json.loads(dump.read_text())["histograms"]["semmerge_phase_seconds"]
    return {s["labels"]["phase"]: round(s["sum"], 4) for s in hist["series"]}


def check_gc_posture(rung5: pathlib.Path, clones: list, phase4: dict, expected: dict) -> dict:
    """The one-shot GC posture (``utils/gctune.py``) both ways, in child
    processes with no daemon: the fused semdiff in ``rung5`` (the
    service's work tree: the rung3 repository)
    (``SEMMERGE_GC_TUNE=0``, then as shipped) and the fused semmerge of
    the rung3 repository in two clones (as shipped, then ``=0``). The
    outputs (op log; exit code, stdout, tree and notes) must be
    byte-identical. Returns each child's wall and its seconds per phase
    (``SEMMERGE_METRICS``)."""
    base_env = {k: v for k, v in os.environ.items() if not k.startswith("SEMMERGE_")}
    base_env.update(PYTHONPATH=str(REPO), SEMMERGE_DAEMON="off")

    def child(cwd, argv, off, tag):
        dump = WORK / f"gc_metrics_{tag}.json"
        env = dict(base_env, SEMMERGE_METRICS=str(dump),
                   **({"SEMMERGE_GC_TUNE": "0"} if off else {}))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", *argv],
                              cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{' '.join(argv)} (SEMMERGE_GC_TUNE={'0' if off else 'unset'}) exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return proc.stdout, {"wall_s": wall, "phases_s": _phase_sums(dump)}

    out: dict = {"semdiff": {}, "semmerge": {}}
    outputs = set()
    for off in (True, False):
        stdout, row = child(rung5, ["semdiff", "base", "side", "--json-out"], off,
                            f"semdiff_{'off' if off else 'shipped'}")
        outputs.add(stdout)
        out["semdiff"]["off" if off else "shipped"] = row
    if len(outputs) != 1 or _digest(outputs.pop().decode()) != phase4["fused_semdiff"]:
        fail("the fused semdiff's op log differs with and without the GC posture")
    merged = []
    for clone, off in zip(clones, (False, True)):
        stdout, row = child(clone, ["semmerge", "base", "side", "other", "--inplace"], off,
                            f"semmerge_{'off' if off else 'shipped'}")
        out["semmerge"]["off" if off else "shipped"] = row
        merged.append((stdout, _work_tree(clone),
                       {rev: _note(clone, rev) for rev in ("side", "other")}))
    if merged[0] != merged[1] or merged[0][1] != expected:
        fail("the rung3 semmerge's stdout, tree or notes differ with and without the GC "
             "posture, or from the one-shot merge's tree")
    return out


def run_service_phase(torch, repo: pathlib.Path, fused_tree: pathlib.Path, ckpt: pathlib.Path,
                      untraced: dict, phase4: dict, rung3: pathlib.Path) -> dict:
    """The merge service on the card: ``serve --workers 4`` in a child
    (a 2 s batch window, ``SEMMERGE_OTLP_ENDPOINT`` at a collector of
    this process), then, from clients, the cold fused semmerge in a
    sixth work tree (its tree and notes phase 4's), the warm fused
    semdiff (phase 4's op log, one residency hit), the profiled matcher
    semdiff (phase 4's op log, 8 ``flash_chunk`` records from the
    daemon's process), ``profile --daemon`` over warm semdiffs, a
    capture beside the profiled matcher semdiff, four concurrent merges
    of four clones of a rung3 repository (each the one-shot tree;
    co-batched), ``top`` and ``perf``, the OTLP traces of every served
    request, SIGTERM (a drain to exit 0), and last the one-shot GC
    posture both ways. Returns what it measured."""
    from semantic_merge_tpu_torch import cli

    guarded = {name: (REPO / name).read_bytes() for name in PERF_FILES}
    collector = OtlpCollector()
    known: list = []
    sock = WORK / "svc.sock"
    svc_tree = WORK / "service"
    subprocess.run(["git", "worktree", "add", "-q", "--detach", str(svc_tree), "side"],
                   cwd=repo, check=True)
    # The whole tree: a resident base is keyed by its incremental scope,
    # and the warm semdiff must find the cold merge's base (whose scope,
    # with the scope on, would be the merge's, not the diff's).
    write_config(svc_tree, ckpt, incremental=False)
    log = open(WORK / "svc.log", "wb")
    out: dict = {}
    with GpuSampler() as sampler:
        t0 = time.perf_counter()
        daemon = started(subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "serve", "--socket", str(sock),
             "--workers", "4", "--idle-exit", "1200"],
            cwd=WORK, stdout=log, stderr=subprocess.STDOUT,
            env=_svc_env(sock, SEMMERGE_BATCH_WINDOW_MS="2000",
                         SEMMERGE_OTLP_ENDPOINT=collector.endpoint)))
        try:
            from semantic_merge_tpu_torch.service import client
            while client.hello(str(sock), timeout=1.0) is None:
                if daemon.poll() is not None or time.perf_counter() - t0 > 180:
                    fail(f"the daemon did not come up (exit {daemon.poll()}): "
                         f"{(WORK / 'svc.log').read_text()[-3000:]}")
                time.sleep(0.2)
            out["daemon_start_s"] = time.perf_counter() - t0
            st = json.loads(subprocess.run(
                [sys.executable, "-m", "semantic_merge_tpu_torch", "serve", "--status"],
                env=_svc_env(sock), check=True, stdout=subprocess.PIPE, text=True,
                timeout=120).stdout)
            if st["package"] != "semantic_merge_tpu_torch" or st["device"]["platform"] != "gpu":
                fail(f"serve --status answers {st['package']!r} on {st['device']}")
            # The cold merge, from a client process.
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge", "base", "side",
                 "other", "--inplace"], cwd=svc_tree, env=_svc_env(sock, SEMMERGE_DAEMON="require"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=900)
            out["cold_merge_client_wall_s"] = time.perf_counter() - t0
        except BaseException:
            daemon.kill()
            raise
    try:
        if proc.returncode != 0:
            fail(f"the daemon-served semmerge exited {proc.returncode}: {proc.stderr[-3000:]}")
        out["card_used_rise_mib"] = sampler.rise_mib
        if sampler.rise_mib < CONTEXT_MIB:
            fail(f"the daemon held no context on the card: {json.dumps(out)}")
        if _work_tree(svc_tree, config=False) != _work_tree(fused_tree, config=False):
            fail("the daemon-served semmerge's tree differs from phase 4's fused semmerge's")
        if {rev: _note(repo, rev) for rev in ("side", "other")} != untraced["notes"]:
            fail("the daemon-served semmerge's notes differ from phase 4's")
        st = _svc_status(sock)
        if st["served_total"] != 1 or st["device"]["launches"]["sha256"] != untraced["sha256"]:
            fail(f"after the cold merge the daemon served {st['served_total']} requests with "
                 f"{st['device']['launches']} launches (expected 1, {untraced['sha256']} sha256)")
        out["cold_merge_launches"] = dict(st["device"]["launches"])

        # The warm semdiff: the base is resident (scan, encode, h2d skipped).
        warm = _svc_verb(sock, svc_tree, "semdiff", ["base", "side", "--json-out"])
        known.append(warm["meta"]["trace_id"])
        if warm["exit_code"] != 0 or _digest(warm["stdout"]) != phase4["fused_semdiff"]:
            fail(f"the daemon-served fused semdiff's op log differs from phase 4's "
                 f"(exit {warm['exit_code']})")
        st = _svc_status(sock)
        if st["residency"]["hits"] != 1:
            fail(f"residency after the warm semdiff: {st['residency']}")
        ph, cold = warm["meta"]["phases"], phase4["fused_semdiff_phases"]
        out["warm_semdiff"] = {
            "client_wall_s": warm["wall_s"], "residency_hits": ph.get("residency_hits"),
            "scan_s": ph["scan"], "encode_s": ph["encode"],
            "phase4_scan_s": cold["scan"], "phase4_encode_s": cold["encode"],
            "fused_s": ph.get("fused"), "phase4_fused_s": cold.get("fused")}
        print(f"service: warm semdiff scan {ph['scan']:.4f} s, encode {ph['encode']:.4f} s "
              f"(phase 4, cold: scan {cold['scan']:.4f} s, encode {cold['encode']:.4f} s); "
              f"residency {json.dumps(st['residency'])}", flush=True)

        # The matcher semdiff, profiled inside the daemon.
        prof_dir = WORK / "profile_service"
        launched = dict(st["device"]["launches"])
        matcher = _svc_verb(sock, svc_tree, "semdiff",
                            ["base", "side", "--json-out", "--change-signature",
                             "--signature-matcher", "--profile", str(prof_dir)])
        known.append(matcher["meta"]["trace_id"])
        if matcher["exit_code"] != 0 or _digest(matcher["stdout"]) != phase4["matcher_semdiff"]:
            fail(f"the daemon-served matcher semdiff's op log differs from phase 4's "
                 f"(exit {matcher['exit_code']})")
        records, _ranges, _size = profile_records(prof_dir)
        st = _svc_status(sock)
        flash = st["device"]["launches"]["flash_chunk"] - launched["flash_chunk"]
        if records.get("flash_chunk", 0) != 8 or flash != 8:
            fail(f"the daemon-served matcher semdiff: {records} kernel records, {flash} "
                 "flash_chunk launches (expected 8 and 8)")
        out["matcher_semdiff"] = {"client_wall_s": matcher["wall_s"],
                                  "flash_chunk_records": records.get("flash_chunk", 0)}

        # profile --daemon over warm semdiffs, then a capture beside the
        # profiled matcher semdiff (the process's one profiler session).
        out["profile"] = check_daemon_profile(sock, svc_tree, phase4, daemon.pid)
        out["profile_overlap"] = check_profile_overlap(sock, svc_tree, phase4, daemon.pid)
        print(f"service: a capture beside the profiled matcher semdiff: "
              f"{json.dumps(out['profile_overlap'])}", flush=True)
        st = _svc_status(sock)

        # The concurrent leg: four clones of the rung3 repository at once.
        # clone 0: the one-shot merge; 1-4: the concurrent clients; 5, 6:
        # the GC posture's merges.
        clones = [WORK / f"svc_clone{i}" for i in range(SVC_CLIENTS + 3)]
        for clone in clones:
            _clone_at_side(rung3, clone, ckpt)
        cwd = os.getcwd()
        os.chdir(clones[0])
        try:
            t0 = time.perf_counter()
            code = cli.main(["semmerge", "base", "side", "other", "--inplace"], delegate=False)
            out["one_shot_wall_s"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        if code != 0:
            fail(f"the one-shot rung3 semmerge exited {code}")
        expected = _work_tree(clones[0])
        before = st["batch"]
        t0 = time.perf_counter()
        procs = [started(subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge", "base", "side",
             "other", "--inplace"], cwd=clone, env=_svc_env(sock, SEMMERGE_DAEMON="require"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for clone in clones[1:SVC_CLIENTS + 1]]
        walls = []
        for p in procs:
            _o, err = p.communicate(timeout=600)
            walls.append(time.perf_counter() - t0)
            if p.returncode != 0:
                fail(f"a concurrent daemon-served semmerge exited {p.returncode}: {err[-2000:]}")
        for clone in clones[1:SVC_CLIENTS + 1]:
            if _work_tree(clone) != expected:
                fail(f"{clone.name}'s merged tree differs from the one-shot merge's")
        st = _svc_status(sock)
        batch = st["batch"]
        leg_batches = batch["batches_total"] - before["batches_total"]
        leg_requests = batch["requests_batched"] - before["requests_batched"]
        out["concurrent"] = {"client_walls_s": walls, "batches": leg_batches,
                             "requests_batched": leg_requests,
                             "mean_batch_size": leg_requests / max(leg_batches, 1)}
        if batch["requests_batched"] < 2 or batch["mean_batch_size"] <= 1 or \
                leg_requests <= leg_batches:
            fail(f"the concurrent merges did not co-batch: {json.dumps(batch)}")
        mesh = batch["mesh"]
        if mesh["posture"] != "auto" or mesh["fallbacks"].get("single-device", 0) < 1:
            fail(f"the daemon's batch mesh block on one card: {json.dumps(mesh)} (expected "
                 "posture auto and single-device fallbacks)")
        print(f"service: batch mesh on one card: {json.dumps(mesh)}", flush=True)
        out["batch"] = batch
        out["residency"] = st["residency"]
        out["tools"] = check_top_and_perf(sock, daemon.pid)
        out["export"] = check_export(sock, collector, known)
        out["served_total"] = _svc_status(sock)["served_total"]
    finally:
        t0 = time.perf_counter()
        daemon.send_signal(signal.SIGTERM)
        try:
            rc = daemon.wait(timeout=180)
        except subprocess.TimeoutExpired:
            daemon.kill()
            rc = "killed after 180 s"
        log.close()
        collector.close()
    out["drain_s"] = time.perf_counter() - t0
    if rc != 0:
        fail(f"the daemon did not drain to exit 0 on SIGTERM: {rc}")
    t0 = time.perf_counter()
    out["gc_posture"] = check_gc_posture(svc_tree, clones[SVC_CLIENTS + 1:], phase4, expected)
    out["gc_posture"]["seconds"] = time.perf_counter() - t0
    print(f"service: GC posture (child walls, s): fused semdiff rung3 as shipped "
          f"{out['gc_posture']['semdiff']['shipped']['wall_s']}, "
          f"SEMMERGE_GC_TUNE=0 {out['gc_posture']['semdiff']['off']['wall_s']}; "
          f"fused semmerge rung3 as shipped {out['gc_posture']['semmerge']['shipped']['wall_s']}, "
          f"SEMMERGE_GC_TUNE=0 {out['gc_posture']['semmerge']['off']['wall_s']}; outputs "
          "byte-identical", flush=True)
    changed = [name for name, data in guarded.items() if (REPO / name).read_bytes() != data]
    if changed:
        fail(f"the service phase wrote the checkout's {changed}")
    return out


# --- the fleet phase ---------------------------------------------------------

#: The fleet phase's time budget (seconds): printed beside its wall.
FLEET_BUDGET_S = 150.0
#: The TCP member's id (``serve --join ... --member-id``).
FLEET_TCP_ID = "t0"


def _fleet_env(sock: pathlib.Path, **extra) -> dict:
    """A fleet process's environment: the service socket, a fast health
    tick, and hedging pushed out of reach, so each request runs on its
    rendezvous owner and the owner's launch counts are the request's."""
    return _svc_env(sock, SEMMERGE_FLEET_HEALTH_INTERVAL="0.25",
                    SEMMERGE_FLEET_HEDGE_MS="600000", SEMMERGE_FLEET_HEDGE_CAP_MS="600000",
                    SEMMERGE_FLEET_JOIN_INTERVAL="1", **extra)


def _fleet_status(sock: pathlib.Path):
    from semantic_merge_tpu_torch.service import client
    try:
        return client.call_control("status", path=str(sock), timeout=30)
    except client.DaemonUnavailable:
        return None


def _fleet_cli(sock: pathlib.Path, cwd: pathlib.Path, argv: list, **env):
    """One CLI process of the port, as a user runs it: its result and
    wall."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", *argv], cwd=cwd,
                          env=_fleet_env(sock, **env), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def _start_router(sock: pathlib.Path, log) -> subprocess.Popen:
    return started(subprocess.Popen(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "fleet", "--socket", str(sock),
         "--members", "2"], cwd=WORK, stdout=log, stderr=subprocess.STDOUT,
        env=_fleet_env(sock), start_new_session=True))


def _await_ring(sock: pathlib.Path, router: subprocess.Popen, want: int, starts: dict,
                limit_s: float = 180.0) -> dict:
    """Polls the router's status until ``want`` members are in the ring;
    ``starts`` maps a member id to the moment its process was started
    (``perf_counter``), and gets each member's seconds to the ring."""
    t0, ring_at = time.perf_counter(), {}
    while True:
        st = _fleet_status(sock)
        for m in (st or {}).get("members", []):
            if m["in_ring"] and m["id"] not in ring_at:
                ring_at[m["id"]] = time.perf_counter()
        if st is not None and st["members_up"] >= want:
            return {"status": st, "start_s": {mid: at - starts.get(mid, t0)
                                              for mid, at in sorted(ring_at.items())}}
        if router.poll() is not None:
            fail(f"the fleet router exited {router.returncode}: "
                 f"{(WORK / 'fleet.log').read_text()[-3000:]}")
        if time.perf_counter() - t0 > limit_s:
            fail(f"{want} fleet members not up within {limit_s:.0f} s: {json.dumps(st)}")
        time.sleep(0.2)


def _fleet_members(sock: pathlib.Path, cli: bool = False) -> dict:
    """The router's status and every member's own (``member_status``,
    what ``stats --daemon --fleet --json`` prints): from this process,
    or with ``cli`` from a client process running that command."""
    if not cli:
        from semantic_merge_tpu_torch.service import client
        return client.call_control("member_status", path=str(sock), timeout=60)
    proc, _ = _fleet_cli(sock, WORK, ["stats", "--daemon", "--fleet", "--json"])
    if proc.returncode != 0:
        fail(f"stats --daemon --fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def _launch_delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in sorted(set(after) | set(before))}


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _owned_clone(repo: pathlib.Path, ckpt: pathlib.Path, stem: str, ring: list,
                 local: set) -> tuple:
    """A clone of ``repo`` at side whose rendezvous owner in
    ``ring`` is a router-spawned member (so a SIGKILL of the owner is a
    crash its supervisor answers)."""
    from semantic_merge_tpu_torch.fleet import hashring
    for i in range(64):
        clone = WORK / f"{stem}{i}"
        owner = hashring.owner(hashring.repo_key(str(clone)), ring)
        if owner in local:
            _clone_at_side(repo, clone, ckpt)
            return clone, owner
    fail(f"no clone name of 64 hashes to a local member of {ring}")


def run_fleet_phase(torch, repo: pathlib.Path, ckpt: pathlib.Path) -> dict:
    """The fleet on the card: ``fleet --members 2`` and one ``serve
    --socket tcp://127.0.0.1:0 --join`` member, three CUDA processes;
    the routed fused semmerge (tree, notes and exit code of the
    in-process merge of a copy; ``sha256`` in the owner) and matcher
    semdiff (op log of the in-process one; ``flash_chunk`` in the
    owner), read from the members through ``stats --daemon --fleet``; a
    SIGKILL of the owner (the survivor answers, ``fleet_failovers_total``
    >= 1); the TCP member drained and left; the router SIGKILLed with a
    request journaled but not acked, restarted, and the WAL replay's
    one effect; the router drained, no process left. Returns what it
    measured."""
    from semantic_merge_tpu_torch.fleet import wal as fleet_wal

    out: dict = {}
    t_phase = time.perf_counter()
    sock = WORK / "fleet.sock"
    wal_dir = pathlib.Path(fleet_wal.default_dir(str(sock)))
    log = open(WORK / "fleet.log", "wb")
    tcp_log = open(WORK / "fleet_tcp.log", "wb")
    router = tcp = None
    pids: set = set()
    try:
        # 1. The router with two members, and a TCP member that joins it;
        # they start while this process runs the in-process references.
        t0 = time.perf_counter()
        router = _start_router(sock, log)
        while _fleet_status(sock) is None:
            if router.poll() is not None or time.perf_counter() - t0 > 60:
                fail(f"the fleet router did not answer: "
                     f"{(WORK / 'fleet.log').read_text()[-3000:]}")
            time.sleep(0.1)
        t_tcp = time.perf_counter()
        tcp = started(subprocess.Popen(
            [sys.executable, "-m", "semantic_merge_tpu_torch", "serve", "--socket",
             "tcp://127.0.0.1:0", "--join", str(sock), "--member-id", FLEET_TCP_ID,
             "--idle-exit", "0"], cwd=WORK, stdout=tcp_log, stderr=subprocess.STDOUT,
            env=_fleet_env(sock)))
        out.update(_fleet_steps(torch, repo, ckpt, sock, wal_dir, log, router, tcp,
                                {"m0": t0, "m1": t0, FLEET_TCP_ID: t_tcp}, pids))
        router = out.pop("router")
    finally:
        for proc in (router, tcp):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        log.close()
        tcp_log.close()
    out["wall_s"] = time.perf_counter() - t_phase
    out["budget_s"] = FLEET_BUDGET_S
    return out


def _fleet_steps(torch, repo: pathlib.Path, ckpt: pathlib.Path, sock: pathlib.Path,
                 wal_dir: pathlib.Path, log, router: subprocess.Popen,
                 tcp: subprocess.Popen, starts: dict, pids: set) -> dict:
    """Steps 2-7 of the fleet phase, on a router and TCP member just
    started (``starts``: when each member's process was). Returns what
    they measured, and the router process last running under
    ``"router"``."""
    from semantic_merge_tpu_torch.fleet import wal as fleet_wal

    out: dict = {}
    # The in-process references, on a copy.
    ref = WORK / "fleet_ref"
    _clone_at_side(repo, ref, ckpt)
    matcher_argv = ["semdiff", "base", "side", "--json-out", "--change-signature",
                    "--signature-matcher"]
    from semantic_merge_tpu_torch import cli
    result, ref_semdiff_launches, _, _, _ = run_cli(torch, ref, matcher_argv)
    ref_semdiff = _digest(cli.render(result.ops, True) + "\n")
    result, _, _, _, _ = run_cli(torch, ref, ["semdiff", "base", "side", "--json-out"])
    ref_fused_semdiff = _digest(cli.render(result.ops, True) + "\n")
    merged, ref_merge_launches, _, ref_wall, _ = run_cli(
        torch, ref, ["semmerge", "base", "side", "other", "--inplace"])
    ref_tree = _work_tree(ref)
    ref_notes = {rev: _note(ref, rev) for rev in ("side", "other")}
    out["in_process"] = {"semmerge_wall_s": ref_wall, "semmerge_launches": ref_merge_launches,
                         "semdiff_launches": ref_semdiff_launches}
    # 2. Three members up, each on the card.
    up = _await_ring(sock, router, 3, starts)
    out["member_start_s"] = up["start_s"]
    print(f"fleet: 3 members up; seconds from each member's start to the ring "
          f"{json.dumps(up['start_s'])} (the in-process fused semmerge: "
          f"{ref_wall:.3f} s)", flush=True)
    agg = _fleet_members(sock)
    devices = {mid: (m.get("device") or {}).get("platform")
               for mid, m in agg["members"].items()}
    if devices != {"m0": "gpu", "m1": "gpu", FLEET_TCP_ID: "gpu"}:
        fail(f"the fleet's members are not all on the card: {devices}")
    pids |= {m["pid"] for m in agg["members"].values()}
    ring = sorted(devices)

    # 3. Routed merges under SEMMERGE_FLEET=require, in a clone whose
    # owner is a router-spawned member.
    route, owner = _owned_clone(repo, ckpt, "fleet_route", ring, {"m0", "m1"})
    before = agg["members"][owner]["device"]["launches"]
    proc, wall = _fleet_cli(sock, route, ["semmerge", "base", "side", "other", "--inplace"],
                            SEMMERGE_FLEET="require")
    if (proc.returncode, merged.code) != (0, 0):
        fail(f"the routed semmerge exited {proc.returncode} (in process: {merged.code}): "
             f"{proc.stderr[-2000:]}")
    if _work_tree(route) != ref_tree:
        fail("the routed semmerge's tree differs from the in-process merge's")
    if {rev: _note(route, rev) for rev in ("side", "other")} != ref_notes:
        fail("the routed semmerge's notes differ from the in-process merge's")
    agg = _fleet_members(sock)
    merge_launches = _launch_delta(agg["members"][owner]["device"]["launches"], before)
    if merge_launches["sha256"] != ref_merge_launches["sha256"] or \
            merge_launches["sha256"] < 1:
        fail(f"the owner {owner} launched {merge_launches} for the routed semmerge "
             f"(in process: {ref_merge_launches})")
    out["routed_semmerge"] = {"client_wall_s": wall, "owner": owner,
                              "owner_launches": merge_launches}
    before = agg["members"][owner]["device"]["launches"]
    proc, wall = _fleet_cli(sock, route, matcher_argv, SEMMERGE_FLEET="require")
    if proc.returncode != 0 or _digest(proc.stdout) != ref_semdiff:
        fail(f"the routed matcher semdiff exited {proc.returncode} or gave another op log "
             f"than the in-process one: {proc.stderr[-2000:]}")
    # 4. The owner's launches, read from its status through the router:
    # here per request, and by `stats --daemon --fleet` in all.
    agg = _fleet_members(sock)
    semdiff_launches = _launch_delta(agg["members"][owner]["device"]["launches"], before)
    shown = _fleet_members(sock, cli=True)["members"][owner]["device"]["launches"]
    if shown != agg["members"][owner]["device"]["launches"] or shown["sha256"] != \
            merge_launches["sha256"] or shown["flash_chunk"] != \
            semdiff_launches["flash_chunk"]:
        fail(f"stats --daemon --fleet shows {owner}'s launches {shown}")
    if semdiff_launches["flash_chunk"] != ref_semdiff_launches["flash_chunk"] or \
            semdiff_launches["flash_chunk"] < 1:
        fail(f"the owner {owner} launched {semdiff_launches} for the routed matcher "
             f"semdiff (in process: {ref_semdiff_launches})")
    out["routed_semdiff"] = {"client_wall_s": wall, "owner_launches": semdiff_launches}
    print(f"fleet: routed semmerge and matcher semdiff on {owner}: "
          f"{json.dumps(out['routed_semmerge'])}; {json.dumps(out['routed_semdiff'])}",
          flush=True)

    # 5. SIGKILL the owner: the next request is the survivor's.
    killed = agg["members"][owner]["pid"]
    os.kill(killed, signal.SIGKILL)
    t0 = t_kill = time.perf_counter()
    from semantic_merge_tpu_torch.service import client
    resp = client.call_verb("semdiff", {"argv": ["base", "side", "--json-out"],
                                        "cwd": str(route), "env": {}},
                            path=str(sock), timeout=600)
    failover_wall = time.perf_counter() - t0
    result = resp.get("result") or {}
    st = _fleet_status(sock)
    failovers = _counter(st, "fleet_failovers_total")
    if result.get("exit_code") != 0 or _digest(result.get("stdout", "")) != \
            ref_fused_semdiff or result["meta"]["pid"] == killed or failovers < 1:
        fail(f"after the owner's SIGKILL: {json.dumps(resp.get('error'))}, answered by "
             f"{result.get('meta', {}).get('pid')} (killed {killed}), "
             f"fleet_failovers_total {failovers}")
    out["failover"] = {"wall_s": failover_wall, "answered_by": result["meta"]["pid"],
                       "killed": killed, "fleet_failovers_total": failovers}
    print(f"fleet: {owner} (pid {killed}) SIGKILLed; the next request answered by pid "
          f"{result['meta']['pid']} in {failover_wall:.3f} s, fleet_failovers_total "
          f"{failovers}", flush=True)

    # 7a. Drain and leave the TCP member; it drains to exit 0.
    for verb in ("--drain", "--leave"):
        proc, _ = _fleet_cli(sock, WORK, ["fleet", "--socket", str(sock), verb,
                                          FLEET_TCP_ID])
        if proc.returncode != 0 or not json.loads(proc.stdout).get("ok"):
            fail(f"fleet {verb} {FLEET_TCP_ID} exited {proc.returncode}: {proc.stdout}")
    st = _fleet_status(sock)
    if any(m["id"] == FLEET_TCP_ID for m in st["members"]):
        fail(f"{FLEET_TCP_ID} is still a member after --leave")
    tcp.send_signal(signal.SIGTERM)
    if tcp.wait(timeout=60) != 0:
        fail(f"the TCP member did not drain to exit 0: {tcp.returncode}")

    # 6. The WAL: every member drained (the ring empty, once the
    # killed owner is back), a request journaled and never acked
    # when the router is SIGKILLed; the restarted router replays it.
    t0 = time.perf_counter()
    back = _await_ring(sock, router, 2, {owner: t_kill})
    out["respawn_s"] = back["start_s"].get(owner)
    pids |= {m["pid"] for m in back["status"]["members"] if m["pid"]}
    from semantic_merge_tpu_torch.service import client
    for mid in ("m0", "m1"):
        ack = client.call_control("drain", {"member": mid}, path=str(sock), timeout=60)
        if not ack.get("ok"):
            fail(f"the drain of {mid}: {ack}")
    if _fleet_status(sock)["members_up"] != 0:
        fail("members still in the ring after draining both")
    wal_clone = WORK / "fleet_wal"
    _clone_at_side(repo, wal_clone, ckpt)
    untouched = _work_tree(wal_clone)
    waiting = started(subprocess.Popen(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge", "base", "side",
         "other", "--inplace"], cwd=wal_clone,
        env=_fleet_env(sock, SEMMERGE_FLEET="require", SEMMERGE_SERVICE_RETRIES="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    key = None
    while key is None:
        for rec in fleet_wal.read_records(str(wal_dir)):
            if rec.get("kind") == "request" and \
                    (rec.get("params") or {}).get("cwd") == str(wal_clone):
                key = rec["key"]
        if waiting.poll() is not None or time.perf_counter() - t0 > 120:
            fail(f"the request was not journaled (client exit {waiting.poll()})")
        time.sleep(0.05)
    st = _fleet_status(sock)
    if st["wal"]["open"] != 1:
        fail(f"the WAL holds {st['wal']['open']} open entries before the kill, expected 1")
    router.send_signal(signal.SIGKILL)
    router.wait(timeout=30)
    _o, err = waiting.communicate(timeout=120)
    if waiting.returncode != 19 or _work_tree(wal_clone) != untouched:
        fail(f"the client of the killed router exited {waiting.returncode} (expected 19, "
             f"the tree untouched): {err[-2000:]}")
    dispatched = sum(1 for r in fleet_wal.read_records(str(wal_dir))
                     if r.get("kind") == "dispatch" and r.get("key") == key)
    t0 = time.perf_counter()
    router = _start_router(sock, log)
    back = _await_ring(sock, router, 2, {"m0": t0, "m1": t0})
    out["restart_member_start_s"] = back["start_s"]
    while True:
        st = _fleet_status(sock)
        if st["wal"]["replayed"] >= 1 and st["wal"]["open"] == 0:
            break
        if time.perf_counter() - t0 > 240:
            fail(f"the WAL was not replayed: {json.dumps(st['wal'])}")
        time.sleep(0.2)
    out["replay_s"] = time.perf_counter() - t0
    records = [r for r in fleet_wal.read_records(str(wal_dir)) if r.get("key") == key]
    kinds = [r["kind"] for r in records]
    payloads = {json.dumps([r.get("verb"), r.get("params")], sort_keys=True)
                for r in records if r["kind"] == "request"}
    agg = _fleet_members(sock)
    served = {mid: m.get("served_total") for mid, m in agg["members"].items()}
    if dispatched != 0 or kinds.count("dispatch") != 1 or kinds.count("ack") != 1 or \
            len(payloads) != 1 or sum(served.values()) != 1 or \
            st["wal"]["replayed"] != 1:
        fail(f"the WAL replay's effects: {dispatched} dispatches before the kill, records "
             f"{kinds}, {len(payloads)} payloads, served {served}, wal {st['wal']}")
    if _work_tree(wal_clone) != ref_tree or \
            {rev: _note(wal_clone, rev) for rev in ("side", "other")} != ref_notes:
        fail("the replayed merge's tree or notes differ from the in-process merge's")
    replay_launches = {mid: m["device"]["launches"] for mid, m in agg["members"].items()}
    out["wal"] = {"records": kinds, "served": served, "status": st["wal"],
                  "launches": replay_launches}
    pids |= {m["pid"] for m in agg["members"].values()}
    print(f"fleet: router SIGKILLed with {key} journaled (0 dispatches); restarted, "
          f"members up {json.dumps(back['start_s'])} s, replayed in "
          f"{out['replay_s']:.3f} s; records {kinds}; served {served}; tree and notes "
          "the in-process merge's", flush=True)

    # 7b. Drain the router: it and every member exit; nothing is left.
    t0 = time.perf_counter()
    router.send_signal(signal.SIGTERM)
    rc = router.wait(timeout=120)
    out["drain_s"] = time.perf_counter() - t0
    deadline = time.monotonic() + 60
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = sorted(p for p in pids if _alive(p))
    if rc != 0 or left or sock.exists():
        fail(f"the fleet drain: router exit {rc}, members left {left}, "
             f"socket {'left' if sock.exists() else 'gone'}")
    out["router"] = router
    return out


#: The long-lived children this run started (the daemon, its clients).
_STARTED: list = []


def started(proc: subprocess.Popen) -> subprocess.Popen:
    """Register a child for :func:`stop_leftovers`."""
    _STARTED.append(proc)
    return proc


def stop_leftovers() -> None:
    """Every process this run started has ended. A registered child
    still running, and any process whose working directory lies in this
    run's scratch directory ``WORK`` (a descendant such as a driver's
    CLI child or a daemon a client spawned), is named on stderr, sent
    SIGTERM and waited for; nothing else on the machine is touched."""
    for proc in _STARTED:
        if proc.poll() is None:
            print(f"chip_smoke: stopping a leftover child {proc.pid}: {proc.args}",
                  file=sys.stderr, flush=True)
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    me, work = os.getpid(), str(WORK)
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit() or int(entry.name) == me:
            continue
        try:
            cwd = os.readlink(entry / "cwd").removesuffix(" (deleted)")
            argv = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if cwd != work and not cwd.startswith(work + os.sep):
            continue
        text = " ".join(a.decode(errors="replace") for a in argv if a)
        print(f"chip_smoke: stopping a leftover process {entry.name} (cwd {cwd}): {text}",
              file=sys.stderr, flush=True)
        try:
            os.kill(int(entry.name), signal.SIGTERM)
        except OSError:
            pass


def _tree_blobs(root: pathlib.Path, rev: str) -> dict:
    """{path: bytes} of every file of ``rev``'s tree, read with one
    ``git cat-file --batch``."""
    entries = [line.split("\t", 1) for line in subprocess.run(
        ["git", "ls-tree", "-r", rev], cwd=root, check=True, stdout=subprocess.PIPE,
        text=True).stdout.splitlines()]
    shas = [meta.split()[2] for meta, _ in entries]
    raw = subprocess.run(["git", "cat-file", "--batch"], cwd=root, check=True,
                         input="\n".join(shas).encode() + b"\n",
                         stdout=subprocess.PIPE).stdout
    out, pos = {}, 0
    for (_, path), sha in zip(entries, shas):
        header_end = raw.index(b"\n", pos)
        size = int(raw[pos:header_end].split()[2])
        out[path] = raw[header_end + 1:header_end + 1 + size]
        pos = header_end + 1 + size + 1
    return out


def _counts_json(ops) -> dict:
    counts: dict = {}
    for op in ops:
        counts[op["type"]] = counts.get(op["type"], 0) + 1
    return dict(sorted(counts.items()))


def check_resolve_semmerge(work: pathlib.Path, merged, n_rsv: int, n_files: int) -> dict:
    """The resolve merge of rsv_a and rsv_b: exit 0, one
    ConcurrentStmtEdit per file both edited, each ``accepted``
    (``merged3way``) in ``.semmerge-conflicts.json`` with every gate
    passed, and both edits in every such file. Returns the gates' ms."""
    if merged.code != 0:
        fail(f"the resolve semmerge exited {merged.code}, expected 0")
    payload = json.loads((work / ".semmerge-conflicts.json").read_text())
    records = payload.get("resolutions", []) if isinstance(payload, dict) else []
    if (len(payload.get("conflicts", [])) != n_rsv or len(records) != n_rsv
            or {r["status"] for r in records} != {"accepted"}
            or {r["category"] for r in records} != {"ConcurrentStmtEdit"}
            or {r["candidate"]["id"] for r in records} != {"merged3way"}):
        fail(f"expected {n_rsv} accepted ConcurrentStmtEdit resolutions, got "
             f"{len(records)} records: {records[:1]}")
    gates = records[0]["gates"]
    if [g["gate"] for g in gates] != ["recompose", "parity", "typecheck", "format"] or \
            not all(g["ok"] for g in gates):
        fail(f"the verify gates did not all pass: {gates}")
    for i in range(0, n_files, RSV_EVERY):
        text = (work / "src" / f"mod{i:05d}.ts").read_text()
        if f"n = n + {i};" not in text or "n = n * 4;" not in text:
            fail(f"src/mod{i:05d}.ts does not hold both sides' edits")
    return {g["gate"]: g["ms"] for g in gates}


# --- phase 7a: languages -------------------------------------------------------

#: The mixed repository of the languages phase, at the rung3 file count:
#: TypeScript, Java and C# files.
LANG_TS, LANG_JAVA, LANG_CS = 500, 300, 200
#: Java files whose first method side renames AND retypes: the
#: matcher's changeSignature candidates.
LANG_RETYPED = 32
#: Side renames a function of every 16th TS file; the worker's branch
#: pair renames one of every 16th (side2) and moves every 4th (other2).
LANG_TS_EVERY = 16
#: Parameter types of the Java and the C# methods: no type in both, and
#: 3 parameters against TS's 4, so that no method's symbol id (its
#: name-free signature) is another language's. Symbol ids carry no
#: language, and the one compose of a routed merge would chain ops of
#: two languages that share one.
_JAVA_TYPES = ("int", "long", "boolean", "String", "double", "char", "byte", "short",
               "float", "Object", "Integer")
_CS_TYPES = ("bool", "string", "object", "decimal", "uint", "ulong", "sbyte", "ushort",
             "nint", "nuint", "Guid")


def _typed_params(idx: int, n_digits: int, types: tuple) -> str:
    """A parameter list unique to ``idx`` (Java and C# order: type, name)."""
    digits = []
    for _ in range(n_digits):
        digits.append(types[idx % len(types)])
        idx //= len(types)
    return ", ".join(f"{t} p{k}" for k, t in enumerate(digits))


def _java_path(i: int, moved: bool = False) -> str:
    return f"java/{'lib' if moved else 'src'}/Cls{i:04d}.java"


def _cs_path(i: int, moved: bool = False) -> str:
    return f"cs/{'lib' if moved else 'src'}/Svc{i:04d}.cs"


def _ts_path(i: int, moved: bool = False) -> str:
    return f"ts/{'lib' if moved else 'src'}/mod{i:05d}.ts"


def _java_file(i: int) -> str:
    """A package line and one public class: 2 fields, 1 constructor and
    4 methods (8 decls). The fields (``vars{1}``), the constructor
    (``ctor(int,String)``) and the class (``class{7}``) share their
    symbol ids with every other Java file's: the collisions of a real
    Java tree. The methods' parameter lists are unique."""
    methods = "".join(
        f"    public int m{i}_{k}({_typed_params(i * 4 + k, 3, _JAVA_TYPES)}) "
        f"{{ return {k}; }}\n" for k in range(4))
    return (f"package lang.p{i};\n\npublic class Cls{i} {{\n"
            "    private int count;\n    private String label;\n\n"
            f"    public Cls{i}(int count, String label) {{\n"
            "        this.count = count;\n        this.label = label;\n    }\n\n"
            f"{methods}}}\n")


def _cs_file(i: int) -> str:
    """A file-scoped namespace, a class with 2 auto-properties (``Head``
    of the file's own record type, unique; ``Count``, ``prop:int`` like
    every other file's), 1 constructor and 3 methods, and a ``record
    struct`` (8 decls)."""
    methods = "".join(
        f"    public int M{i}_{k}({_typed_params(i * 3 + k, 3, _CS_TYPES)}) => {k};\n"
        for k in range(3))
    return (f"namespace Lang.N{i};\n\npublic class Svc{i}\n{{\n"
            f"    public Rec{i} Head {{ get; set; }}\n    public int Count {{ get; set; }}\n\n"
            f"    public Svc{i}(int count) {{ Count = count; }}\n\n{methods}}}\n\n"
            f"public record struct Rec{i}(int A, int B);\n")


def _ts_file(i: int) -> str:
    return "\n".join(
        f"export function fn{i}_{d}({_unique_params(i * RUNG3_DECLS + d, 4)})"
        f": number {{ return {d}; }}" for d in range(RUNG3_DECLS)) + "\n"


def lang_trees():
    """(base, side, other, extras) of the languages phase's repository.

    side renames the second method of every even Java file, the ``Head``
    property of every even C# file (to ``Lead``) and the first function
    of every 16th TS file, each to a name of the same length, and renames
    AND retypes (``int`` -> ``long``) the first method of the first 32
    odd Java files. A decl's address holds its name and its offset, so
    each rename also moves its decl (a ``moveDecl``), and each retype
    moves the 3 methods after it, one character on. other moves every
    4th Java and C# file from ``src/`` to ``lib/`` (which sorts first,
    so the colliding decls' last-wins occurrence, in the last file of
    each language, stays put). The extras are the worker's TS-only pair
    on base: side2 renames the first function of every 16th TS file,
    other2 moves every 4th TS file to ``ts/lib/``. Returns the trees and
    the expected ops per language and type of side's and other's op
    logs (side's Java ``deleteDecl + changeSignature`` and ``addDecl``
    left out: the matcher decides between them)."""
    base, side, other = {"README.md": README}, {"README.md": README}, {"README.md": README}
    side2, other2 = {}, {}
    for i in range(LANG_TS):
        text = _ts_file(i)
        base[_ts_path(i)] = side[_ts_path(i)] = other[_ts_path(i)] = text
        if i % LANG_TS_EVERY == 0:
            side[_ts_path(i)] = side2[_ts_path(i)] = text.replace(
                f"function fn{i}_0(", f"function tx{i}_0(")
        if i % 4 == 0:
            other2[_ts_path(i)] = None
            other2[_ts_path(i, moved=True)] = text
    retyped = 0
    for i in range(LANG_JAVA):
        text = _java_file(i)
        base[_java_path(i)] = side[_java_path(i)] = text
        other[_java_path(i, moved=i % 4 == 0)] = text
        if i % 2 == 0:
            side[_java_path(i)] = text.replace(f" m{i}_1(", f" r{i}_1(")
        elif retyped < LANG_RETYPED:
            side[_java_path(i)] = text.replace(f"public int m{i}_0(", f"public long s{i}_0(")
            retyped += 1
    for i in range(LANG_CS):
        text = _cs_file(i)
        base[_cs_path(i)] = side[_cs_path(i)] = text
        other[_cs_path(i, moved=i % 4 == 0)] = text
        if i % 2 == 0:
            side[_cs_path(i)] = text.replace(f"Rec{i} Head ", f"Rec{i} Lead ")
    n_ts = len(range(0, LANG_TS, LANG_TS_EVERY))
    expected = {
        "left": {"ts": {"moveDecl": n_ts, "renameSymbol": n_ts},
                 "java": {"moveDecl": (LANG_JAVA + 1) // 2 + 3 * LANG_RETYPED,
                          "renameSymbol": (LANG_JAVA + 1) // 2},
                 "cs": {"moveDecl": (LANG_CS + 1) // 2, "renameSymbol": (LANG_CS + 1) // 2}},
        # Each moved file's decls with a symbol id of their own: Java's
        # 4 methods, C#'s 3 methods and Head.
        "right": {"java": {"moveDecl": 4 * len(range(0, LANG_JAVA, 4))},
                  "cs": {"moveDecl": 4 * len(range(0, LANG_CS, 4))}},
    }
    extras = {"side2": ("base", side2), "other2": ("base", other2)}
    return base, side, other, extras, expected


def _lang_of(op) -> str:
    params = op["params"] if isinstance(op, dict) else op.params
    path = params.get("file") or params.get("newFile") or params.get("oldFile") or ""
    return {".ts": "ts", ".java": "java", ".cs": "cs"}.get(pathlib.PurePosixPath(path).suffix,
                                                          "?")


def _lang_counts(ops) -> dict:
    counts: dict = {}
    for op in ops:
        kind = op["type"] if isinstance(op, dict) else op.type
        by_type = counts.setdefault(_lang_of(op), {})
        by_type[kind] = by_type.get(kind, 0) + 1
    return {lang: dict(sorted(c.items())) for lang, c in sorted(counts.items())}


def lang_config(root: pathlib.Path, ckpt: pathlib.Path, routed: bool = True,
                matcher: bool = True) -> str:
    """The repository's ``.semmerge.toml`` (untracked): the settings of
    :func:`write_config`, with ``matcher`` changeSignature and the
    matcher on ``ckpt``, with ``routed`` Java and C# enabled. Returns
    what it set."""
    text = (f'[engine]\nmatcher_ckpt_dir = "{ckpt}"\n'
            + ("change_signature = true\nsignature_matcher = true\n" if matcher else "")
            + '[languages.typescript]\nformatter_cmd = ["true"]\n'
            + ("[languages.java]\nenabled = true\n[languages.csharp]\nenabled = true\n"
               if routed else "")
            + '[ci]\nrequire_typecheck = false\n')
    (root / ".semmerge.toml").write_text(text)
    return text


def _check_lang_counts(label: str, got: dict, want: dict, retyped: bool) -> None:
    """``got`` holds exactly ``want``'s ops per language and type, and
    with ``retyped`` side's 32 Java candidates as deleteDecl +
    changeSignature and as many addDecl as deleteDecl."""
    got = {lang: dict(c) for lang, c in got.items()}
    if retyped:
        java = got.get("java", {})
        folded = java.pop("changeSignature", 0)
        deleted = java.pop("deleteDecl", 0)
        added = java.pop("addDecl", 0)
        if folded + deleted != LANG_RETYPED or added != deleted:
            fail(f"{label}: Java changeSignature {folded} + deleteDecl {deleted} != "
                 f"{LANG_RETYPED}, or addDecl {added} != deleteDecl")
    if got != want:
        fail(f"{label}: ops by language and type {got}, expected {want}")


def _clone_at(src: pathlib.Path, dst: pathlib.Path, branch: str, revs: tuple) -> None:
    """A ``git clone --local`` of ``src`` at ``branch``, with ``revs`` as
    local branches and an identity for the notes."""
    subprocess.run(["git", "clone", "-q", "--local", "--no-checkout", str(src), str(dst)],
                   check=True)
    for rev in revs:
        if rev != branch:
            subprocess.run(["git", "branch", "-q", rev, f"origin/{rev}"], cwd=dst, check=True)
    subprocess.run(["git", "checkout", "-q", "-B", branch, f"origin/{branch}"], cwd=dst,
                   check=True)
    for key, value in (("user.email", "smoke@example.com"), ("user.name", "smoke")):
        subprocess.run(["git", "config", key, value], cwd=dst, check=True)


def _degradations(to: str) -> float:
    from semantic_merge_tpu_torch.obs import metrics as obs_metrics
    metric = obs_metrics.REGISTRY.to_dict().get("counters", {}).get(
        "merge_degradations_total", {})
    return sum(s["value"] for s in metric.get("series", []) if s["labels"].get("to") == to)


def run_languages_phase(torch, work: pathlib.Path, trained: pathlib.Path) -> tuple:
    """Phase 7a: the multi-language merge, each C-family engine alone and
    the worker seam, on the card. Returns (its launches and shapes for
    the kernel line, a summary)."""
    from semantic_merge_tpu_torch import cli

    repo = work / "lang"
    base, side, other, extras, expected = lang_trees()
    make_repo(repo, base, side, other, extras=extras)
    n_decls = (LANG_TS * RUNG3_DECLS + LANG_JAVA * 8 + LANG_CS * 8)
    print(f"languages: {LANG_TS} TS files x {RUNG3_DECLS} decls, {LANG_JAVA} Java files x 8, "
          f"{LANG_CS} C# files x 8 ({n_decls} decls); side: {expected['left']} renames and "
          f"{LANG_RETYPED} Java methods renamed+retyped; other: every 4th Java and C# file "
          f"moved src/ -> lib/ ({expected['right']}); matcher: the trained checkpoint of the "
          "train phase", flush=True)
    summary = {}

    # 1. The multi-language merge.
    from semantic_merge_tpu_torch.frontend import native
    from semantic_merge_tpu_torch.frontend.declcache import global_cache

    config = lang_config(repo, trained)
    print("languages: .semmerge.toml " + config.replace("\n", "; "), flush=True)
    # A routed merge reads the incremental scope, whose collision guard
    # scans the base tree's TS files through the decl cache first: the
    # engine's scan of the scoped snapshots then hits the cache only.
    misses = global_cache().misses
    merged, launches, shapes, wall, busy = run_cli(
        torch, repo, ["semmerge", "base", "side", "other", "--inplace"],
        scanners=("native", "cache"))
    misses = global_cache().misses - misses
    if misses < LANG_TS or native._lib is None:
        fail(f"the routed semmerge's scans missed the decl cache {misses} times (the guard "
             f"scans {LANG_TS} base files), native library loaded: {native._lib is not None}")
    print(f"languages: routed semmerge: TS scanner {merged.phases.get('scanner')!r} over the "
          f"scoped snapshots, {misses} decl-cache misses in all, each scanned by the native "
          "library (ASCII files)", flush=True)
    expect_launches("multi-language semmerge", launches, {"flash_chunk": None, "sha256": 0})
    if merged.code != 0 or (repo / ".semmerge-conflicts.json").exists():
        fail(f"the multi-language semmerge exited {merged.code} (conflicts file: "
             f"{(repo / '.semmerge-conflicts.json').exists()}), expected 0 and none")
    left = _lang_counts(merged.result.op_log_left)
    right = _lang_counts(merged.result.op_log_right)
    print(f"languages: ops by language and type: A {json.dumps(left)}; B {json.dumps(right)}; "
          f"composed {json.dumps(_lang_counts(merged.composed))}", flush=True)
    _check_lang_counts("multi-language semmerge A", left, expected["left"], retyped=True)
    _check_lang_counts("multi-language semmerge B", right, expected["right"], retyped=False)
    for i in range(LANG_JAVA):
        text = (repo / _java_path(i, moved=i % 4 == 0)).read_text()
        # A retyped method's changeSignature (or delete and add) carries
        # no text without structured apply: the file keeps base's method,
        # in the JAX package too.
        want = [f"m{i}_2(", f"m{i}_3("] + [f"r{i}_1(" if i % 2 == 0 else f"m{i}_1("]
        if not all(w in text for w in want):
            fail(f"{_java_path(i, moved=i % 4 == 0)} lacks one of {want}")
    for i in range(LANG_CS):
        text = (repo / _cs_path(i, moved=i % 4 == 0)).read_text()
        want = [f"M{i}_{k}(" for k in range(3)] + [
            f"Rec{i} Lead " if i % 2 == 0 else f"Rec{i} Head "]
        if not all(w in text for w in want):
            fail(f"{_cs_path(i, moved=i % 4 == 0)} lacks one of {want}")
    for i in range(0, LANG_TS, LANG_TS_EVERY):
        if f"function tx{i}_0(" not in (repo / _ts_path(i)).read_text():
            fail(f"{_ts_path(i)} lacks tx{i}_0")
    scan = {k: round(v, 4) for k, v in merged.phases.items()
            if k.endswith("scan") and isinstance(v, float)}
    print(f"languages: multi-language semmerge: exit 0, every rename and move in the tree; "
          f"wall {wall:.3f} s, idle share {1 - busy / wall:.4f}; scan seconds {scan}",
          flush=True)
    summary["multi"] = {"wall_s": round(wall, 3), "busy_s": round(busy, 4), "scan_s": scan,
                        "launches": launches}
    runs = {"multi": (launches, shapes)}

    # 2. Each C-family engine alone (no routing: a routed language
    # beside --backend java would diff the Java files twice, in the JAX
    # package as here).
    lang_config(repo, trained, routed=False)
    for name, lang in (("java", "java"), ("cs", "cs")):
        result, launches, shapes, wall, busy = run_cli(
            torch, repo, ["semdiff", "base", "side", "--json-out", "--backend", name],
            scanners=())
        got = _lang_counts(result.ops)
        if set(got) != {lang}:
            fail(f"semdiff --backend {name} printed ops of {sorted(got)}")
        _check_lang_counts(f"semdiff --backend {name}", got, {lang: expected["left"][lang]},
                           retyped=lang == "java")
        expect_launches(f"semdiff --backend {name}", launches, {"sha256": 0})
        summary[f"semdiff_{name}"] = {"wall_s": round(wall, 3), "ops": got[lang],
                                      "launches": launches}
        runs[f"semdiff_{name}"] = (launches, shapes)

    # 3. The worker seam: the TS-only pair through the port's worker on
    # the card, against the in-process engine; then with the worker dying.
    revs = ("base", "side2", "other2")
    outcome = {}
    for label, argv_extra, env in (("in-process", [], {}),
                                   ("worker", ["--backend", "subprocess"], {}),
                                   ("worker-exit", ["--backend", "subprocess"],
                                    {"SEMMERGE_FAULT": "worker-serve:exit"})):
        clone = work / f"lang-{label}"
        _clone_at(repo, clone, "side2", revs)
        lang_config(clone, trained, routed=False, matcher=False)
        degraded = _degradations("host")
        os.environ.update(env)
        try:
            result, launches, shapes, wall, busy = run_cli(
                torch, clone, ["semmerge", *revs, "--inplace", *argv_extra],
                scanners=() if argv_extra else ("native",))
        finally:
            for key in env:
                os.environ.pop(key, None)
        if result.code != 0:
            fail(f"the {label} semmerge of side2 and other2 exited {result.code}")
        outcome[label] = (_work_tree(clone), [_note(clone, r) for r in revs[1:]])
        worker = {k: round(v, 4) for k, v in result.phases.items() if k.startswith("worker")}
        summary[label] = {"wall_s": round(wall, 3), "worker_phases": worker,
                          "degradations_to_host": _degradations("host") - degraded}
        if label == "worker" and not worker.get("worker.buildAndDiff"):
            fail(f"the worker semmerge reported no _worker phases: {result.phases}")
        if label == "worker-exit" and summary[label]["degradations_to_host"] != 1:
            fail("SEMMERGE_FAULT=worker-serve:exit recorded no degradation to host")
    for label in ("worker", "worker-exit"):
        if outcome[label] != outcome["in-process"]:
            fail(f"the {label} semmerge's tree or notes differ from the in-process engine's")
    print(f"languages: worker seam: side2/other2 through the port's worker on the card "
          f"(and dying, SEMMERGE_FAULT=worker-serve:exit, degraded to host): the in-process "
          f"engine's tree and notes; {json.dumps(summary)}", flush=True)
    return runs, summary


_SMALL_UTIL = "export function foo(n: number): number {\n  return n;\n}\n"
_SMALL_G = "export function g(a: boolean, b: boolean): void {}\n"
_SMALL_H = "export function h(s: string): string {\n  return s;\n}\n"
_BLOCK = "{ return s.trim(); }"
_BIG = "export function big(s: string): string "
_CALLER = "export function caller(s: string, n: number, b: boolean): string "
_HELPER = "export function helper(s: string, n: number): string "
_SMALL_USE = "export function use(s: string): number {{\n  return {}(s.length);\n}}\n"
_SMALL_CALC = ("export function calc(n: number): number {\n  n = n + 1;\n  n = n * 2;\n"
               "  return n;\n}\n")
#: name → (flags, extra files {path: (base, side, other)}, other's tree,
#: exit code, path taken). The side renames foo to bar and edits line 2
#: of the README; an extra file's None is no file. In the third case the
#: side also retypes g, a delete+add pair of one (file, name, kind) that
#: --change-signature could fold, so the merge leaves the fused result
#: for the two-program path, whose compose walks the DivergentRename on
#: the host. The strict cases run no fused engine: build-and-diff, the
#: strict detection and the compose (which finds nothing left to walk).
#: In the last strict one, the side extracts big's block into a new
#: function and the other inlines helper, whose block is the same, into
#: caller. The resolve cases run the resolution tier: the side's rename
#: has a reference beside it and wins (2 references against 1), the same
#: renames without it tie (exit 1), and disjoint edits of one body merge
#: line by line under --strict-conflicts.
SMALL_MERGES = {
    "divergent_rename": ([], {}, {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"),
                                  "README.md": README}, 1, "fused"),
    "rename_vs_move": ([], {}, {"lib/util.ts": _SMALL_UTIL,
                                "README.md": README.replace("line 19 of", "line 19 (B) of")},
                       0, "fused"),
    "divergent_rename_changesig": (
        ["--change-signature"],
        {"src/g.ts": (_SMALL_G, _SMALL_G.replace("a: boolean", "a: string"), _SMALL_G)},
        {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"), "README.md": README}, 1,
        "two-program"),
    "strict_delete_vs_edit": (
        ["--strict-conflicts"],
        {"src/h.ts": (_SMALL_H, None, _SMALL_H.replace("return s;", "return s + s;"))},
        {"src/util.ts": _SMALL_UTIL, "README.md": README}, 1, "strict"),
    "strict_concurrent_stmt_edit": (
        ["--strict-conflicts"],
        {"src/h.ts": (_SMALL_H, _SMALL_H.replace("return s;", "return s + 'a';"),
                      _SMALL_H.replace("return s;", "return s + 'b';"))},
        {"src/util.ts": _SMALL_UTIL, "README.md": README}, 1, "strict"),
    "strict_extract_vs_inline": (
        ["--strict-conflicts"],
        {"src/big.ts": (_BIG + _BLOCK + "\n", _BIG + "{ return ex(s, 0, 0); }\n",
                        _BIG + _BLOCK + "\n"),
         "src/ex.ts": (None, "export function ex(s: string, x: number, y: number): string "
                       + _BLOCK + "\n", None),
         "src/helper.ts": (_HELPER + _BLOCK + "\n", _HELPER + _BLOCK + "\n", None),
         "src/caller.ts": (_CALLER + "{ return helper(s, 0); }\n",
                           _CALLER + "{ return helper(s, 0); }\n", _CALLER + _BLOCK + "\n")},
        {"src/util.ts": _SMALL_UTIL, "README.md": README}, 1, "strict"),
    "resolve_divergent_rename": (
        ["--resolve", "auto"],
        {"src/use.ts": (_SMALL_USE.format("foo"), _SMALL_USE.format("bar"),
                        _SMALL_USE.format("foo"))},
        {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"), "README.md": README}, 0, "fused"),
    "resolve_symmetric_tie": (
        ["--resolve", "auto"], {},
        {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"), "README.md": README}, 1, "fused"),
    "resolve_strict_stmt_edit": (
        ["--strict-conflicts", "--resolve", "auto"],
        {"src/calc.ts": (_SMALL_CALC, _SMALL_CALC.replace("n + 1;", "n + 3;"),
                         _SMALL_CALC.replace("n * 2;", "n * 4;"))},
        {"src/util.ts": _SMALL_UTIL, "README.md": README}, 0, "strict"),
}


def _small_java(k: int, method: str = "") -> str:
    """Small Java file ``k``: a field, ``run()``, ``f<k>(int)`` and
    ``h<k>(String)`` share their symbol ids with every other such file's;
    ``u<k>`` (``k + 1`` long parameters) has one of its own."""
    longs = ", ".join(f"long a{n}" for n in range(k + 1))
    return (f"class A{k} {{\n  int x;\n  void run() {{}}\n"
            f"  int f{k}(int a) {{ return a; }}\n  String h{k}(String s) {{ return s; }}\n"
            f"  long {method or f'u{k}'}({longs}) {{ return 0; }}\n}}\n")


def _small_cs(k: int, prop: str = "Count", only: str = "Only") -> str:
    """Small C# file ``k``: ``Count`` (``prop:int``), ``F<k>(int)`` and
    ``G(string)`` collide across files; ``Only`` (``k + 3`` long
    parameters) does not."""
    longs = ", ".join(f"long a{n}" for n in range(k + 3))
    return (f"namespace Small;\n\npublic class S{k}\n{{\n"
            f"    public int {prop} {{ get; set; }}\n    int F{k}(int a) => a;\n"
            f"    string G(string s) => s;\n    public long {only}({longs}) => 0;\n}}\n")


#: The routed cases' Java and C# files: six of each, path → (base, side,
#: other). Side renames A0's own method and A1's colliding one (which
#: the last-wins map does not see) and C# S2's Count; other moves A3 to
#: ``jl/`` and edits S4's colliding F4 away.
_SMALL_ROUTED = {
    **{f"j/A{k}.java": (_small_java(k), _small_java(k), _small_java(k)) for k in range(6)},
    **{f"c/S{k}.cs": (_small_cs(k), _small_cs(k), _small_cs(k)) for k in range(6)},
    "j/A0.java": (_small_java(0), _small_java(0, method="renamedU0"), _small_java(0)),
    "j/A1.java": (_small_java(1), _small_java(1).replace("f1(", "g1("), _small_java(1)),
    "j/A3.java": (_small_java(3), _small_java(3), None),
    "jl/A3.java": (None, None, _small_java(3)),
    "c/S2.cs": (_small_cs(2), _small_cs(2, prop="Total"), _small_cs(2)),
    "c/S4.cs": (_small_cs(4), _small_cs(4), _small_cs(4).replace("    int F4(int a) => a;\n",
                                                                 "")),
}
SMALL_MERGES.update({
    "routed_languages": ([], _SMALL_ROUTED, {"src/util.ts": _SMALL_UTIL, "README.md": README},
                         0, "routed"),
    "routed_divergent_rename_cs": (
        [], {**{f"c/S{k}.cs": (_small_cs(k),) * 3 for k in range(5)},
             "c/S5.cs": (_small_cs(5), _small_cs(5, only="Left"), _small_cs(5, only="Right"))},
        {"src/util.ts": _SMALL_UTIL, "README.md": README}, 1, "routed"),
})
#: The ``.semmerge.toml`` lines each case adds: the routed cases enable
#: Java and C# beside TypeScript.
SMALL_TOML = {name: "[languages.java]\nenabled = true\n[languages.csharp]\nenabled = true\n"
              for name in ("routed_languages", "routed_divergent_rename_cs")}
#: Path taken → (fused engine runs, two-program composes, host walks). A
#: routed merge runs no fused engine: the TS engine's build_and_diff, the
#: C-family engines', one compose on the TS engine's device.
SMALL_PATH_CALLS = {"fused": (1, 0, 0), "two-program": (1, 1, 1), "strict": (0, 1, 0),
                    "routed": (0, 1, 1)}
#: Conflict category each strict case must report.
SMALL_STRICT_CATEGORY = {"strict_delete_vs_edit": "DeleteVsEdit",
                         "strict_concurrent_stmt_edit": "ConcurrentStmtEdit",
                         "strict_extract_vs_inline": "ExtractVsInline"}
#: Each resolve case's one resolution record: (category, status, cause).
SMALL_RESOLVE = {"resolve_divergent_rename": ("DivergentRename", "accepted", None),
                 "resolve_symmetric_tie": ("DivergentRename", "rejected", "tie"),
                 "resolve_strict_stmt_edit": ("ConcurrentStmtEdit", "accepted", None)}


def _gate_ms_masked(tree: dict) -> dict:
    """``tree`` with the verify gates' wall times in its conflicts
    artifact set to 0 (they differ between any two runs)."""
    raw = tree.get(".semmerge-conflicts.json")
    payload = json.loads(raw) if raw is not None else None
    if not isinstance(payload, dict):
        return tree
    for rec in payload.get("resolutions", []):
        for gate in rec.get("gates", []):
            gate["ms"] = 0
    return dict(tree, **{".semmerge-conflicts.json": json.dumps(payload).encode()})


def check_reference_merges(work: pathlib.Path, ckpt: pathlib.Path) -> dict:
    """Small three-way merges through the CLI, each in a fresh copy of
    its repository, on the card and with ``--device cpu``: the exit
    code, the work tree (with ``.semmerge-conflicts.json``) and the notes
    on both sides must be identical. Each merge must take the path
    ``SMALL_MERGES`` names (``SMALL_PATH_CALLS``), each strict merge
    report its category and each resolve merge its resolution (the
    gates' wall times masked in the comparison)."""
    from semantic_merge_tpu_torch import cli
    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    from semantic_merge_tpu_torch.ops import compose
    from semantic_merge_tpu_torch.ops.fused import FusedMergeEngine

    codes = {}
    for name, (flags, extra, other, expect, path) in SMALL_MERGES.items():
        base = {"src/util.ts": _SMALL_UTIL, "README.md": README}
        side = {"src/util.ts": _SMALL_UTIL.replace("foo", "bar"),
                "README.md": README.replace("line 2 of", "line 2 (A) of")}
        other = dict(other)
        for file, texts in extra.items():
            for tree, text in zip((base, side, other), texts):
                if text is not None:
                    tree[file] = text
        origin = work / name / "origin"
        make_repo(origin, base, side, other)
        outcome = {}
        for device in ("cuda", "cpu"):
            copy = work / name / device
            shutil.copytree(origin, copy)
            write_config(copy, ckpt)
            with (copy / ".semmerge.toml").open("a") as fh:
                fh.write(SMALL_TOML.get(name, ""))
            cwd = os.getcwd()
            os.chdir(copy)
            try:
                with Capture(FusedMergeEngine, "merge") as fused_runs, \
                        Capture(TorchTSBackend, "compose") as composes, \
                        Capture(compose, "_walk_on_host") as walks:
                    code = cli.main(["semmerge", "base", "side", "other", "--inplace",
                                     "--device", device, *flags])
            finally:
                os.chdir(cwd)
            want = SMALL_PATH_CALLS[path]
            if path in ("two-program", "routed") and expect != 1:
                want = want[:2] + (0,)
            if (fused_runs.calls, composes.calls, walks.calls) != want:
                fail(f"small merge {name} on {device}: the fused engine, the two-program "
                     f"compose and its host walk ran {fused_runs.calls}, {composes.calls} "
                     f"and {walks.calls} times, expected {want} (the {path} path)")
            tree = {p.relative_to(copy).as_posix(): p.read_bytes()
                    for p in sorted(copy.rglob("*"))
                    if p.is_file() and ".git" not in p.relative_to(copy).parts}
            notes = [subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev],
                                    cwd=copy, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL).stdout
                     for rev in ("side", "other")]
            outcome[device] = (code, _gate_ms_masked(tree), notes)
        if outcome["cuda"][0] != expect:
            fail(f"small merge {name}: exit {outcome['cuda'][0]} on the card, expected {expect}")
        if outcome["cuda"] != outcome["cpu"]:
            fail(f"small merge {name}: the card's exit code, tree or notes differ from the CPU's")
        if name in SMALL_STRICT_CATEGORY:
            artifact = json.loads(outcome["cuda"][1][".semmerge-conflicts.json"])
            if SMALL_STRICT_CATEGORY[name] not in [c["category"] for c in artifact]:
                fail(f"small merge {name}: no {SMALL_STRICT_CATEGORY[name]} conflict")
        if name in SMALL_RESOLVE:
            artifact = json.loads(outcome["cuda"][1][".semmerge-conflicts.json"])
            records = [(r["category"], r["status"], r["cause"])
                       for r in artifact["resolutions"]]
            if records != [SMALL_RESOLVE[name]]:
                fail(f"small merge {name}: resolutions {records}, expected "
                     f"[{SMALL_RESOLVE[name]}]")
        codes[name] = f"exit {expect}, {path} path"
    return codes


def check_reference(torch, ckpt: pathlib.Path) -> float:
    """Small input: the card's op log must equal the CPU's, and the
    card's embeddings must match the CPU's (plain attention) within 2e-2."""
    import numpy as np

    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
    from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher

    base = ("export function computeTotal(a: number, b: number): number {\n"
            "  const sum = a + b;\n  return sum * 2;\n}\n"
            "export function loadWidgets(path: string): string {\n  return path;\n}\n")
    side = ("export function computeSum(a: string, b: number): number {\n"
            "  const sum = a + b;\n  return sum * 2;\n}\n"
            "export function loadWidgets(path: string): string {\n  return path;\n}\n"
            "export function unrelatedRegistry(keys: boolean): boolean {\n"
            "  return !keys;\n}\n")
    logs, embeddings = {}, {}
    for device in ("cuda", "cpu"):
        matcher = EmbeddingSignatureMatcher(ckpt_dir=str(ckpt), device=device)
        ops = TorchTSBackend(device=device).diff(
            Snapshot(files=[{"path": "a.ts", "content": base}]),
            Snapshot(files=[{"path": "a.ts", "content": side}]),
            change_signature=True, signature_matcher=matcher)
        logs[device] = [op.to_dict() for op in ops]
        embeddings[device] = matcher.embed_texts([base, side, "let x = 1;"])
    if logs["cuda"] != logs["cpu"]:
        fail("small-input op log on the card differs from the CPU's")
    err = float(np.abs(embeddings["cuda"] - embeddings["cpu"]).max())
    if not np.isfinite(embeddings["cuda"]).all() or err > 2e-2:
        fail(f"card embeddings differ from the CPU's by {err:.3e} (atol 2e-2)")
    return err


# --- slice 15: scope, serializers, the device CRDT, the soak -------------------

def report_scope(label: str, snaps: "Capture", result) -> dict:
    """The incremental scope the CLI's ``_snapshots`` returned for one run
    (``scope_files``: its path count; ``None`` for the full tree) beside
    the run's ``scan`` and ``encode`` seconds."""
    scope = snaps.returned[1] if snaps.returned is not None else None
    phases = result.phases
    out = {"scope_files": None if scope is None else len(scope),
           "scan_s": phases.get("scan"), "encode_s": phases.get("encode")}
    print(f"scope: {label}: {json.dumps(out)}", flush=True)
    return out


def check_serializers(merged, repo: pathlib.Path) -> dict:
    """The rung5 fused semmerge's op logs through every serializer and
    op builder: the notes came from the device render (``serializer``);
    the port's native C++ serializer (``smn_oplog_json``) and the Python
    serializer give the notes' bytes; the C op factory's ops equal the
    Python builder's, by ``to_dict``. Each timed on the host clock."""
    from semantic_merge_tpu_torch.core.ops import Op, Target
    from semantic_merge_tpu_torch.frontend import native

    fac = native.load_opfactory()
    out = {}
    for rev, view in (("side", merged.result.op_log_left), ("other", merged.result.op_log_right)):
        note = _note(repo, rev).rstrip(b"\n")
        t0 = time.perf_counter()
        raw = view._to_json_native_bytes()
        t1 = time.perf_counter()
        py = view._to_json_py_bytes()
        t2 = time.perf_counter()
        if raw is None:
            fail("the native op-log serializer did not run (SEMMERGE_NATIVE=0?)")
        if not (raw == py == note):
            fail(f"the native serializer's bytes of {rev}'s op log differ from the Python "
                 "serializer's or the note's")
        t3 = time.perf_counter()
        built = fac.stream_ops(*view._c_stream_args(), view.prov, Op, Target)
        t4 = time.perf_counter()
        plain = [view._build_one(i) for i in range(len(view))]
        t5 = time.perf_counter()
        if [o.to_dict() for o in built] != [o.to_dict() for o in plain]:
            fail(f"the op factory's ops of {rev}'s op log differ from the Python builder's")
        out[rev] = {"ops": len(view), "notes_serializer": view.serializer,
                    "native_ms": (t1 - t0) * 1e3, "python_ms": (t2 - t1) * 1e3,
                    "opfactory_ms": (t4 - t3) * 1e3, "python_build_ms": (t5 - t4) * 1e3,
                    "bytes": len(raw)}
    print(f"serializers: rung5 fused semmerge op logs: native serializer bytes == Python "
          f"serializer bytes == notes; op factory ops == Python ops; {json.dumps(out)}",
          flush=True)
    return out


#: The device CRDT phase: lists and their longest length.
CRDT_LISTS, CRDT_MAX = 1024, 64


def crdt_rgas(n_lists: int, seed: int):
    """``n_lists`` RGA lists of 1 to :data:`CRDT_MAX` inserts each, with
    moves and tombstones, from ``seed``."""
    import random

    from semantic_merge_tpu_torch.core.crdt import RGA, Key

    rng = random.Random(seed)
    out = []
    for i in range(n_lists):
        r = RGA()
        n = 1 + (i * 37) % CRDT_MAX
        for j in range(n):
            r.insert(Key(rng.choice("pqrs"), rng.randint(0, 50), rng.choice("uvw"),
                         f"op{i}.{j}"), f"v{j}")
        for j in range(n // 5):
            r.move(f"v{rng.randrange(n)}", Key(rng.choice("pqrs"), rng.randint(0, 50), "m",
                                               f"mv{i}.{j}"))
        for _ in range(n // 7):
            r.delete(f"v{rng.randrange(n)}")
        out.append(r)
    return out


def crdt_tree_and_ops(root: pathlib.Path, n_files: int, seed: int):
    """A tree of ``n_files`` TypeScript files with 1 to :data:`CRDT_MAX`
    import lines each and one ``reorderImports`` op per file whose CRDT
    order reshuffles them."""
    import random

    from semantic_merge_tpu_torch.core.ops import Op, Target

    rng = random.Random(seed)
    ops = []
    for i in range(n_files):
        n = 1 + (i * 37) % CRDT_MAX
        lines = [f'import {{ v{j} }} from "./dep{j}";' for j in range(n)]
        path = root / "src" / f"imp{i:05d}.ts"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + f"\nexport function f{i}(): number {{\n"
                        "  return 1;\n}\n")
        order = [{"value": v, "anchor": rng.choice("xyz"), "t": rng.randint(0, 9),
                  "author": rng.choice("uv"), "opid": f"o{i}.{k}"}
                 for k, v in enumerate(rng.sample(lines, n))]
        ops.append(Op.new("reorderImports", Target(symbolId=f"imp{i}", addressId=None),
                          params={"file": f"src/imp{i:05d}.ts", "order": order},
                          op_id=f"{i:032x}"))
    return ops


def run_crdt_phase(torch, work: pathlib.Path) -> dict:
    """The device RGA materialization (``ops/crdt.py``): 1,024 lists of
    up to 64 elements with moves and tombstones through
    ``materialize_batch`` on the card, against the host RGA and the same
    tensor code on the CPU; then a synthetic op log of 1,024
    ``reorderImports`` ops through the object applier with
    ``device_crdt`` on the card (one program launch, counted), against
    the host RGA's tree; the program timed as the other non-Pallas
    programs."""
    from semantic_merge_tpu_torch.ops import crdt
    from semantic_merge_tpu_torch.runtime.applier import apply_ops

    rgas = crdt_rgas(CRDT_LISTS, seed=15)
    t0 = time.perf_counter()
    on_card = crdt.materialize_batch(rgas, "cuda")
    t1 = time.perf_counter()
    host = [list(r.materialize()) for r in rgas]
    t2 = time.perf_counter()
    if on_card != host or on_card != crdt.materialize_batch(rgas, "cpu"):
        fail("materialize_batch on the card differs from the host RGA or the CPU run")
    n_dead = sum(e.tombstone for r in rgas for e in r.elems)
    base = work / "crdt_base"
    ops = crdt_tree_and_ops(base, CRDT_LISTS, seed=16)
    trees = {}
    with Capture(crdt, "_materialize_program") as program:
        t3 = time.perf_counter()
        merged = apply_ops(base, ops, device_crdt=True, device=torch.device("cuda"))
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t3
    launches = program.calls
    if launches != 1:
        fail(f"the object applier launched the CRDT program {launches} times, expected 1")
    for label, tree in (("card", merged), ("host", apply_ops(base, ops))):
        trees[label] = _work_tree(tree)
        shutil.rmtree(tree, ignore_errors=True)
    if trees["card"] != trees["host"]:
        fail("the applier's tree with the CRDT on the card differs from the host RGA's")
    if trees["card"] == _work_tree(base):
        fail("the reorderImports ops changed no file")
    timed = time_programs(torch, {"crdt program": program.last})["crdt program"]
    out = {"lists": CRDT_LISTS, "elements": sum(len(r.elems) for r in rgas),
           "tombstones": n_dead, "batch_card_ms": (t1 - t0) * 1e3,
           "batch_host_rga_ms": (t2 - t1) * 1e3, "apply_ops": len(ops),
           "apply_s": apply_s, "launches": launches, "program": timed}
    print(f"crdt: materialize_batch on the card == host RGA == CPU tensor code; object "
          f"applier tree (device_crdt, card) == host RGA's; {json.dumps(out)}", flush=True)
    return out


def _twin_trees():
    """A small repository whose incremental scope the collision guard
    drops: A renames a function in a file whose other function shares
    its structural signature with a function in an untouched file."""
    def decl(i, name):
        params = ", ".join(f"p{k}: number" for k in range(i + 1))
        return f"export function {name}({params}): number {{\n  return {i};\n}}\n"

    dup = "export function %s(a: string, b: string, c: string): string { return a; }\n"
    base = {f"src/m{i}.ts": decl(i, f"fn{i}") for i in range(12)}
    base["src/m0.ts"] += dup % "dupScoped"
    base["src/zzz_twin.ts"] = dup % "dupTwin"
    side = dict(base, **{"src/m0.ts": decl(0, "renamed0") + dup % "dupRenamed"})
    other = {k: v for k, v in base.items() if k != "src/m3.ts"}
    other["lib/m3.ts"] = base["src/m3.ts"]
    return base, side, other


def check_scope_equivalence(torch, rung3: pathlib.Path, scoped_tree: pathlib.Path,
                            scoped_notes: dict, ckpt: pathlib.Path) -> dict:
    """The incremental scope changes no byte: the rung3 fused semmerge
    (scoped, run in ``scoped_tree``) against the same merge with
    ``[engine] incremental = false`` in another work tree (tree and
    notes); then a small repository whose collision guard falls back to
    the full tree (scope None though either side touched files), against
    its unscoped merge in a clone."""
    from semantic_merge_tpu_torch import cli

    out = {}
    full = WORK / "unscoped3"
    subprocess.run(["git", "worktree", "add", "-q", "--detach", str(full), "side"],
                   cwd=rung3, check=True)
    write_config(full, ckpt, incremental=False)
    with Capture(cli, "_snapshots") as snaps:
        merged, _, _, wall, _ = run_cli(torch, full, ["semmerge", "base", "side", "other",
                                                      "--inplace"])
    if merged.code != 0 or snaps.returned[1] is not None:
        fail(f"the unscoped rung3 semmerge exited {merged.code} or ran scoped")
    want, got = _work_tree(scoped_tree, config=False), _work_tree(full, config=False)
    notes = {rev: _note(rung3, rev) for rev in ("side", "other")}
    if got != want or notes != scoped_notes:
        fail("the rung3 semmerge with incremental = false differs from the scoped merge "
             "(tree or notes)")
    out["rung3_unscoped"] = {"wall_s": wall, "scan_s": merged.phases.get("scan"),
                             "encode_s": merged.phases.get("encode")}
    twin = WORK / "twin"
    make_repo(twin, *_twin_trees())
    write_config(twin, ckpt)
    runs = {}
    for label, root in (("scoped", twin), ("unscoped", WORK / "twin_full")):
        if label == "unscoped":
            subprocess.run(["git", "clone", "-q", "--shared", str(twin), str(root)], check=True)
            for args in (["branch", "-q", "base", "origin/base"],
                         ["branch", "-q", "other", "origin/other"],
                         ["config", "user.email", "smoke@example.com"],  # for git notes
                         ["config", "user.name", "smoke"]):
                subprocess.run(["git", *args], cwd=root, check=True)
            write_config(root, ckpt, incremental=False)
        with Capture(cli, "_snapshots") as snaps:
            merged, _, _, wall, _ = run_cli(torch, root, ["semmerge", "base", "side", "other",
                                                          "--inplace"])
        if merged.code != 0:
            fail(f"the {label} twin semmerge exited {merged.code}")
        runs[label] = {"tree": _work_tree(root, config=False),
                       "notes": {rev: _note(root, rev) for rev in ("side", "other")},
                       "scope": snaps.returned[1], "wall_s": wall}
    if runs["scoped"]["scope"] is not None:
        fail("the collision guard did not fall back to the full tree on the twin repository")
    if runs["scoped"]["tree"] != runs["unscoped"]["tree"] or \
            runs["scoped"]["notes"] != runs["unscoped"]["notes"]:
        fail("the twin repository's fallback merge differs from its unscoped merge")
    if b"renamed0" not in runs["scoped"]["tree"]["src/m0.ts"]:
        fail("the twin repository's merge lacks A's rename")
    out["twin_fallback"] = {label: {"wall_s": r["wall_s"]} for label, r in runs.items()}
    print(f"scope: the rung3 semmerge with incremental = false gives the scoped merge's tree "
          f"and notes; the twin repository's guard fell back to the full tree, with the "
          f"unscoped merge's tree and notes; {json.dumps(out)}", flush=True)
    return out


#: The short soak on the card: requests, repositories, concurrency, kills.
SOAK = {"requests": 24, "repos": 4, "concurrency": 4, "kills": 1, "seed": 1}
#: Seconds the soak may take (it took 41-48 s beside an H100 80GB HBM3).
SOAK_BUDGET_S = 240.0


def _soak_processes(workdir: pathlib.Path) -> list:
    """Pids of the processes whose argv names ``workdir`` (the soak's
    supervisor and daemon: their socket lies under it)."""
    pids, key = [], str(workdir).encode()
    for entry in pathlib.Path("/proc").iterdir():
        if entry.name.isdigit() and int(entry.name) != os.getpid():
            try:
                if key in (entry / "cmdline").read_bytes():
                    pids.append(int(entry.name))
            except OSError:
                continue
    return pids


def run_soak_phase() -> dict:
    """The port's chaos soak (``scripts/chaos_soak.py``) with a CUDA
    daemon, as its command line runs it, in a child process:
    :data:`SOAK`'s mixed traffic against ``serve --supervise`` on the
    card, one daemon SIGKILL mid-soak; every invariant of the soak must
    hold, within :data:`SOAK_BUDGET_S` (past it the child and the soak's
    daemons are killed and the daemons' log tail printed). The daemons
    find a stub ``npx`` that fails first on their PATH: the card's
    machine has no network, where an ``npx`` would wait on the registry;
    the formatter then logs and the typecheck passes vacuously, as where
    ``npx`` is absent."""
    work = WORK / "soak"
    stub = WORK / "soak_bin"
    stub.mkdir(parents=True, exist_ok=True)
    (stub / "npx").write_text("#!/bin/sh\nexit 1\n")
    (stub / "npx").chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PATH=f"{stub}{os.pathsep}{os.environ.get('PATH', '')}")
    argv = [sys.executable, "-m", "semantic_merge_tpu_torch.scripts.chaos_soak", "--json",
            "--hard-mb", "16384", "--workdir", str(work),
            *[a for k, v in SOAK.items() for a in (f"--{k}", str(v))]]
    print(f"soak: {' '.join(argv[1:])} (npx outside the stub: {shutil.which('npx')})",
          flush=True)
    t0 = time.perf_counter()
    proc = started(subprocess.Popen(argv, cwd=WORK, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
    try:
        stdout, stderr = proc.communicate(timeout=SOAK_BUDGET_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        log = work / "chaos.sock.log"
        tail = log.read_text(errors="replace")[-6000:] if log.is_file() else "(no log)"
        for pid in _soak_processes(work):
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        fail(f"the soak did not end within {SOAK_BUDGET_S:.0f} s; its stderr: "
             f"{stderr[-3000:]}; its daemons' log: {tail}")
    wall = time.perf_counter() - t0
    try:
        report = json.loads(stdout)
    except ValueError:
        fail(f"the soak exited {proc.returncode} without a report: {stderr[-3000:]}")
    if proc.returncode != 0 or not report["ok"]:
        fail("the soak on the card failed: " + "; ".join(report["errors"][:10]))
    if report["kills"] != SOAK["kills"] or report["daemon_pids_seen"] < 2 or \
            not report["supervisor_restarts"]:
        fail(f"the soak's kill did not land or no respawn was seen: {json.dumps(report)}")
    if _soak_processes(work):
        fail(f"the soak left processes running: {_soak_processes(work)}")
    keep = ("outcomes", "kills", "daemon_pids_seen", "supervisor_restarts",
            "transport_retries", "breaker_transitions", "breaker_rungs", "final_rss_mb",
            "served_total", "elapsed_s")
    out = {k: report.get(k) for k in keep}
    out["wall_s"] = wall
    print(f"soak: {json.dumps(out)}", flush=True)
    return out


# --- the mesh --------------------------------------------------------------------

#: The mesh phase's own budget (its two CLI merges run at rung3).
MESH_BUDGET_S = 90.0
MESH_PROGRAMS = ("diff_pair_sharded", "compose_sharded", "fused_merge_sharded")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_inputs(captured, compose_in) -> dict:
    """Host copies of the sharded programs' rung5 inputs: the decl
    columns and digests the fused semmerge gave its one-merge program,
    as decl tensors (their valid prefixes) and as the program's padded
    arrays, and its two op logs, materialized."""
    from semantic_merge_tpu_torch.core.encode import PAD_ID, DeclTensor

    _fn, args, _kwargs = captured
    decls = []
    for cols in args[:3]:
        host = cols.cpu().numpy()
        n = int((host[0] != PAD_ID).sum())
        decls.append(DeclTensor(sym=host[0, :n].copy(), addr=host[1, :n].copy(),
                                name=host[2, :n].copy(), file=host[3, :n].copy(), n=n))
    return {"decls": decls, "fused": tuple(a.cpu().numpy() for a in args[:6]) + (int(args[6]),),
            "compose": (list(compose_in[0]), list(compose_in[1]))}


def _mesh_digest(name: str, result) -> str:
    """The bytes of a program's result, hashed: the diff tensors' rows up
    to their op counts, the composed ops and conflicts as JSON, the fused
    merge's one-buffer row."""
    import hashlib

    h = hashlib.sha256()
    if name.startswith("diff"):
        for t in result:
            h.update(str(t.n_ops).encode())
            for field in ("kind", "sym", "a_addr", "a_name", "a_file", "b_addr", "b_name",
                          "b_file"):
                h.update(getattr(t, field)[:t.n_ops].tobytes())
    elif name.startswith("compose"):
        ops, conflicts = result
        h.update(json.dumps([[o.to_dict() for o in ops], [c.to_dict() for c in conflicts]],
                            sort_keys=True).encode())
    else:
        h.update(result.cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_timing(torch, call, mesh=None, reps=2) -> dict:
    """One program's times: the host wall of a call (the median of
    ``reps``, the card synchronised after), the device's busy time in one
    call (union of its activities in a torch.profiler trace) and, on a
    mesh, the host wall inside its collectives (each timed between two
    synchronisations, gloo's host staging included)."""
    from torch.profiler import ProfilerActivity, profile

    spent = [0.0]

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
        return wrapper

    # On a one-device mesh the collectives are the identity: none timed.
    sharded = mesh is not None and mesh.layout.size > 1
    wrapped = ("all_gather", "_reduce") if sharded else ()
    for name in wrapped:
        setattr(mesh, name, timed(getattr(mesh, name)))
    walls = []
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        for name in wrapped:
            delattr(mesh, name)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = _device_events(prof)
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    out = {"wall_ms": wall_ms,
           "device_ms": _busy_us([(s, e) for _, s, e in events]) / 1e3 if events else None,
           "device_records": len(events)}
    if sharded:
        out["collective_ms"] = spent[0] * 1e3 / reps
        out["collective_share"] = out["collective_ms"] / wall_ms
    return out


def run_mesh_programs(torch, inputs: dict, mesh=None) -> dict:
    """The three programs on ``inputs``: over ``mesh``, the sharded diff
    pair, compose and fused merge on this rank's blocks; without it, the
    one-device programs on the card. Per program: the result's digest,
    the ``sha256`` launches of one call (by the wrapper's count, set to 0
    just before) and :func:`_mesh_timing`."""
    import numpy as np

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.ops import compose, diff, fused, sharded

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    base, left, right = inputs["decls"]
    b, l, r, hash_tab, dig_l, dig_r, C = inputs["fused"]
    k, j = (1, 0) if mesh is None else (mesh.axis_size("dp"), mesh.axis_index("dp"))

    def block(a):
        s = a.shape[1] // k
        return torch.from_numpy(np.ascontiguousarray(a[:, j * s:(j + 1) * s])).to(dev)

    fargs = (block(b), block(l), block(r), *(torch.from_numpy(a).to(dev)
                                               for a in (hash_tab, dig_l, dig_r)))
    ops_a, ops_b = inputs["compose"]
    if mesh is None:
        calls = {"diff_pair_sharded": lambda: diff.diff_lift_device_pair(base, left, right, dev),
                 "compose_sharded": lambda: compose.compose_oplogs_device(ops_a, ops_b, dev),
                 "fused_merge_sharded": lambda: fused._fused_merge_program(*fargs, C)}
    else:
        calls = {"diff_pair_sharded": lambda: sharded.diff_lift_device_pair_sharded(
                     base, left, right, mesh),
                 "compose_sharded": lambda: sharded.compose_oplogs_device_sharded(
                     ops_a, ops_b, mesh),
                 "fused_merge_sharded": lambda: fused._fused_merge_sharded(*fargs, C, mesh)}
    out = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = call()  # also the warm-up of the timed calls
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        out[name] = {"digest": _mesh_digest(name, result),
                     "sha256_launches": launches.get("sha256", 0),
                     **_mesh_timing(torch, call, mesh)}
    return out


def mesh_child(inputs_path: str) -> int:
    """One rank of phase 5d's two-rank group (``--mesh-rank PATH``): joins
    the group through the port's ``init_distributed`` with the
    ``SEMMERGE_*`` contract in its environment, builds the ``dp = 2``
    mesh on its card and runs :func:`run_mesh_programs` on the pickled
    inputs; prints one ``MESH_RESULT`` JSON line."""
    import pickle

    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from semantic_merge_tpu_torch.parallel.distributed import init_distributed, world
    from semantic_merge_tpu_torch.parallel.mesh import build_mesh

    init_distributed()
    rank, size = world()
    mesh = build_mesh(dp=size, pp=1, sp=1, tp=1, ep=1)
    with open(inputs_path, "rb") as fh:
        inputs = pickle.load(fh)
    programs = run_mesh_programs(torch, inputs, mesh)
    print("MESH_RESULT " + json.dumps({"rank": rank, "size": size, "device": str(mesh.device),
                                       "backend": dist.get_backend(), "programs": programs}),
          flush=True)
    dist.destroy_process_group()
    return 0


def _engine_config(root: pathlib.Path, ckpt: pathlib.Path, line: str = "") -> None:
    """:func:`write_config` with ``line`` added to its ``[engine]`` table."""
    text = write_config(root, ckpt)
    if line:
        (root / ".semmerge.toml").write_text(text.replace("[engine]\n", f"[engine]\n{line}\n", 1))


def _rung3_tree(rung3: pathlib.Path, root: pathlib.Path, ckpt: pathlib.Path,
                line: str = "") -> None:
    """A work tree of the rung3 repository at side, configured."""
    subprocess.run(["git", "worktree", "add", "-q", "--detach", str(root), "side"],
                   cwd=rung3, check=True)
    _engine_config(root, ckpt, line)


def _mesh_posture_runs(work: pathlib.Path, ckpt: pathlib.Path) -> dict:
    """``SEMMERGE_MESH=require`` and ``[engine] mesh = "require"`` on this
    one-card host, in-process on a small repository: the environment's
    merges on the host engine (exit 0, the tree of a merge without the
    setting), the config's ends with MeshFault (exit 18, the tree
    untouched), as the JAX CLI does on one device
    (``tests/test_torch_mesh_cli.py``)."""
    from semantic_merge_tpu_torch import cli

    types = ("string", "number", "boolean", "bigint")
    base = {f"src/m{i}.ts": f"export function f{i}(x: {t}): {t} {{ return x; }}\n"
            for i, t in enumerate(types)}
    side = dict(base, **{"src/m0.ts": base["src/m0.ts"].replace("f0", "g0")})
    other = {p.replace("src/m1", "lib/m1"): t for p, t in base.items()}
    out = {}
    for label, env, line, want in (("plain", {}, "", 0),
                                   ("env_require", {"SEMMERGE_MESH": "require"}, "", 0),
                                   ("config_require", {}, 'mesh = "require"', 18)):
        root = work / f"posture_{label}"
        make_repo(root, base, side, other)
        _engine_config(root, ckpt, line)
        before = _work_tree(root)
        saved = {k: os.environ.get(k) for k in ("SEMMERGE_MESH", "SEMMERGE_DAEMON")}
        os.environ.update(env, SEMMERGE_DAEMON="off")
        cwd = os.getcwd()
        os.chdir(root)
        try:
            code = cli.main(["semmerge", "base", "side", "other", "--inplace"], delegate=False)
        finally:
            os.chdir(cwd)
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        if code != want:
            fail(f"{label}: semmerge exited {code}, the JAX CLI on one device exits {want}")
        after = _work_tree(root, config=False)
        if label == "plain":
            merged_tree = after
        elif want == 0 and after != merged_tree:
            fail(f"{label}: the tree is not the plain merge's")
        elif want == 18 and _work_tree(root) != before:
            fail(f"{label}: the tree changed")
        out[label] = code
    return out


def run_mesh_phase(torch, captured, compose_in, batched, rung3: pathlib.Path,
                   ckpt: pathlib.Path, ref_tree: pathlib.Path, ref: dict, card: str) -> dict:
    """Phase 5d (see the module docstring)."""
    import pickle

    import torch.distributed as dist

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.ops import fused
    from semantic_merge_tpu_torch.parallel.distributed import agree_exit_code
    from semantic_merge_tpu_torch.parallel.mesh import build_batch_mesh, build_mesh

    t_phase = time.perf_counter()
    inputs = mesh_inputs(captured, compose_in)
    one = run_mesh_programs(torch, inputs)
    out = {"inputs": {"base_decls": inputs["decls"][0].n, "C": inputs["fused"][6],
                      "ops_a": len(inputs["compose"][0]), "ops_b": len(inputs["compose"][1])},
           "one_device": one}

    # a. World size 1 over NCCL: an explicit one-rank group (the port's
    # init_distributed brings a group up only for several processes).
    # Its size-1 axes are the identity, so the programs run no
    # collective; the exit-code broadcast is the one NCCL call.
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh1 = build_mesh(dp=1, pp=1, sp=1, tp=1, ep=1, device="cuda:0")
        k1 = run_mesh_programs(torch, inputs, mesh1)
        out["k1_backend"] = dist.get_backend()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agreed = agree_exit_code(7)
        out["k1_nccl_broadcast_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    if agreed != 7:
        fail(f"agree_exit_code over the one-rank NCCL group gave {agreed}, expected 7")
    out["k1"] = k1
    for name in MESH_PROGRAMS:
        if k1[name]["digest"] != one[name]["digest"]:
            fail(f"k = 1 (NCCL): {name} differs from the one-device program")
    if k1["fused_merge_sharded"]["sha256_launches"] != 2:
        fail(f"k = 1: {k1['fused_merge_sharded']['sha256_launches']} sha256 launches in one "
             "sharded fused merge, expected 2 (one per side)")
    dp1 = WORK / "mesh_dp1"
    _rung3_tree(rung3, dp1, ckpt, 'mesh_shape = "dp=1"')
    merged, launches, _shapes, wall, _busy = run_cli(
        torch, dp1, ["semmerge", "base", "side", "other", "--inplace"])
    if merged.code != 0 or merged.result.op_log_left.render is not None:
        fail(f"the dp=1 semmerge exited {merged.code} or rendered on the card under a mesh")
    if _work_tree(dp1, config=False) != _work_tree(ref_tree, config=False):
        fail("the dp=1 semmerge's tree differs from the one-device merge's")
    notes = {rev: _note(rung3, rev) for rev in ("side", "other")}
    if notes != ref["notes"]:
        fail("the dp=1 semmerge's notes differ from the one-device merge's")
    if launches["sha256"] != ref["sha256"]:
        fail(f"the dp=1 semmerge launched sha256 {launches['sha256']} times, the one-device "
             f"merge {ref['sha256']}")
    out["cli_dp1"] = {"wall_s": wall, "launches": launches}

    # b. Two ranks on the one card over gloo, in two child processes.
    path = WORK / "mesh_inputs.pkl"
    with open(path, "wb") as fh:
        pickle.dump(inputs, fh)
    contract = dict(os.environ, SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}",
                    SEMMERGE_NUM_PROCESSES="2", SEMMERGE_DAEMON="off")
    t0 = time.perf_counter()
    procs = [started(subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--mesh-rank", str(path)], cwd=WORK,
        env=dict(contract, SEMMERGE_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for rank in range(2)]
    ranks = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=400)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("MESH_RESULT ")]
        if proc.returncode != 0 or not lines:
            fail(f"a mesh rank exited {proc.returncode}: {stderr[-3000:]}")
        ranks.append(json.loads(lines[-1][len("MESH_RESULT "):]))
    out["k2_wall_s"] = time.perf_counter() - t0
    for got in ranks:
        if (got["size"], got["backend"], got["device"]) != (2, "gloo", "cuda:0"):
            fail(f"rank {got['rank']}: {got['size']} ranks over {got['backend']} on "
                 f"{got['device']}, expected 2 over gloo on cuda:0")
        for name in MESH_PROGRAMS:
            if got["programs"][name]["digest"] != one[name]["digest"]:
                fail(f"k = 2 (gloo): rank {got['rank']}'s {name} differs from the one-device "
                     "program")
        if got["programs"]["fused_merge_sharded"]["sha256_launches"] != 2:
            fail(f"k = 2: rank {got['rank']} launched sha256 "
                 f"{got['programs']['fused_merge_sharded']['sha256_launches']} times in one "
                 "sharded fused merge, expected 2 (one per side, C / 2 rows each)")
    out["k2"] = {f"rank{got['rank']}": got["programs"] for got in ranks}

    trees = {rank: WORK / f"mesh_rank{rank}" for rank in range(2)}
    for tree in trees.values():
        _rung3_tree(rung3, tree, ckpt)
    rank1_before = (_work_tree(trees[1]), subprocess.run(
        ["git", "status", "--porcelain"], cwd=trees[1], stdout=subprocess.PIPE,
        text=True, check=True).stdout)
    contract = dict(os.environ, PYTHONPATH=str(REPO), SEMMERGE_DAEMON="off",
                    SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}", SEMMERGE_NUM_PROCESSES="2")
    t0 = time.perf_counter()
    procs = {rank: started(subprocess.Popen(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "semmerge", "base", "side", "other",
         "--inplace", "--trace"], cwd=trees[rank],
        env=dict(contract, SEMMERGE_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for rank in range(2)}
    cli2 = {}
    for rank, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=400)
        cli2[rank] = (proc.returncode, stdout, stderr)
    out["cli_k2_wall_s"] = time.perf_counter() - t0
    for rank, (code, stdout, stderr) in cli2.items():
        if code != 0 or f"process {rank}/2" not in stderr:
            fail(f"the two-rank semmerge's rank {rank} exited {code}: {stderr[-3000:]}")
    if cli2[1][1]:
        fail(f"rank 1 printed to stdout: {cli2[1][1][:500]!r}")
    if _work_tree(trees[0], config=False) != _work_tree(ref_tree, config=False):
        fail("the two-rank semmerge's tree differs from the one-device merge's")
    if {rev: _note(rung3, rev) for rev in ("side", "other")} != ref["notes"]:
        fail("the two-rank semmerge's notes differ from the one-device merge's")
    status1 = subprocess.run(["git", "status", "--porcelain"], cwd=trees[1],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
    if (_work_tree(trees[1]), status1) != rank1_before or \
            (trees[1] / ".semmerge-trace.json").exists():
        fail("rank 1 wrote to its work tree")
    trace = json.loads((trees[0] / ".semmerge-trace.json").read_text())
    gauges = trace["metrics"]["gauges"]
    mesh_devices = [s["value"] for s in gauges["semmerge_mesh_devices"]["series"]]
    if mesh_devices != [2]:
        fail(f"rank 0's trace shows a mesh of {mesh_devices} devices, expected [2]")

    # c. The batched program's merge axis over [cuda:0, cuda:0].
    (program, stacked, _kw), = batched.values()
    B, C = stacked[0].shape[0], inputs["fused"][6]
    single = program(*stacked).cpu().numpy()
    bmesh = build_batch_mesh([torch.device("cuda", 0)] * 2)
    kernels.reset_launches()
    rows = fused.batched_fused_program(B, *(a.shape[-1] for a in stacked[:3]), C,
                                       mesh=bmesh)(*stacked)
    torch.cuda.synchronize()
    batch_sha = kernels.LAUNCHES["sha256"]
    kernels.reset_launches()
    if rows.cpu().numpy().tobytes() != single.tobytes():
        fail("the batched program over [cuda:0, cuda:0] differs from the one-device program")
    out["batch_mesh"] = {"B": B, "shards": bmesh.shards, "sha256_launches": batch_sha}

    # d. The require postures on this one-card host.
    (WORK / "mesh").mkdir(exist_ok=True)
    out["posture"] = _mesh_posture_runs(WORK / "mesh", ckpt)
    out["wall_s"] = time.perf_counter() - t_phase
    out["card"] = card
    for name in MESH_PROGRAMS:
        print(f"mesh: {name}: one device {one[name]['device_ms']:.4f} device ms "
              f"(wall {one[name]['wall_ms']:.3f} ms); k=1 (one-rank NCCL group, no "
              f"collective) {k1[name]['device_ms']:.4f} (wall {k1[name]['wall_ms']:.3f}); "
              "k=2 gloo rank 0 "
              f"{out['k2']['rank0'][name]['device_ms']} (wall "
              f"{out['k2']['rank0'][name]['wall_ms']:.3f}, collectives "
              f"{out['k2']['rank0'][name]['collective_share']:.3f} of it); card: {card}",
              flush=True)
    print(f"mesh: the exit-code broadcast over the one-rank NCCL group "
          f"{out['k1_nccl_broadcast_ms']:.3f} ms; phase wall {out['wall_s']:.3f} s "
          f"(budget {MESH_BUDGET_S:.0f} s); card: {card}", flush=True)
    return out


# --- the mesh model (phase 5e) -----------------------------------------------------

#: The mesh model phase's own budget.
MESH_MODEL_BUDGET_S = 90.0
#: The two-rank meshes of phase 5e, in the children's order: (label, the
#: axis of size 2, the encoder config's changes).
MESH_MODELS = (("sp2_ring", "sp", {}), ("sp2_ulysses", "sp", {"attn_mode": "ulysses"}),
               ("dp2", "dp", {}), ("tp2", "tp", {}), ("pp2", "pp", {}),
               ("ep2_topk", "ep", {"moe_mode": "topk"}))
MESH_MODEL_STEPS = 3
#: The sharded steps' losses against the one-device port's on the card.
MESH_MODEL_LOSS_TOL = 2e-2
#: The collectives of a mesh, timed one by one between synchronisations.
MESH_COLLECTIVES = ("all_gather", "_reduce", "_a2a_raw", "_bcast_raw", "_shift_raw")


def model_inputs(torch) -> tuple:
    """The full-width matcher's seeded initial weights (seed 0) and the
    first batches of ``train-matcher``'s stream (batch 32, seq 64)."""
    from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
    from semantic_merge_tpu_torch.models.training import TrainConfig, batches
    encoder = Encoder(EncoderConfig(), generator=torch.Generator().manual_seed(0))
    stream = batches(TrainConfig())
    return ({k: v.detach().clone() for k, v in encoder.state_dict().items()},
            [next(stream) for _ in range(MESH_MODEL_STEPS)])


def model_steps(torch, state: dict, batches: list, changes: dict, mesh=None) -> dict:
    """``MESH_MODEL_STEPS`` training steps at full width from ``state`` on
    the card: one device (``mesh`` None) through ``train_step``, else this
    rank's shards through ``make_sharded_train_step``. Per step: the
    loss, the host wall to a synchronise, each kernel's launches (the
    wrappers' counts, set to 0 just before the step) and, on a mesh of
    several ranks, the time inside its collectives (each timed between
    two synchronisations, gloo's host staging included)."""
    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import (MatcherConfig, batch_on,
                                                         make_sharded_train_step, optimizer,
                                                         shard_state, train_step)

    cfg = MatcherConfig(encoder=EncoderConfig(**changes))
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    encoder = Encoder(cfg.encoder, mesh=mesh).to(dev)
    encoder.load_state_dict(shard_state(state, mesh) if mesh is not None else state)
    opt = optimizer(encoder, cfg)
    if mesh is None:
        def step(enc, opt_, batch):
            return train_step(enc, opt_, batch_on(batch, dev), cfg)
    else:
        step = make_sharded_train_step(cfg, mesh)
    spent = [0.0]

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
        return wrapper

    sharded = mesh is not None and mesh.layout.size > 1
    for name in MESH_COLLECTIVES if sharded else ():
        setattr(mesh, name, timed(getattr(mesh, name)))
    steps = []
    try:
        for batch in batches:
            torch.cuda.synchronize()
            kernels.reset_launches()
            spent[0] = 0.0
            t0 = time.perf_counter()
            loss = float(step(encoder, opt, batch))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps.append({"loss": loss, "ms": wall * 1e3,
                          "collective_ms": spent[0] * 1e3 if sharded else 0.0,
                          "launches": {k: kernels.LAUNCHES[k] for k in
                                       ("flash_chunk", "flash_chunk_bwd", "sha256")},
                          "shapes": {k: [list(s) for s in kernels.LAUNCH_SHAPES[k]]
                                     for k in ("flash_chunk", "flash_chunk_bwd")}})
            kernels.reset_launches()
    finally:
        for name in MESH_COLLECTIVES if sharded else ():
            delattr(mesh, name)
    # Steady steps: the first pays the card's and the kernels' first use.
    steady = steps[1:]
    ms = sorted(s["ms"] for s in steady)[len(steady) // 2]
    return {"losses": [s["loss"] for s in steps], "ms_per_step": ms,
            "collective_share": (sum(s["collective_ms"] for s in steady)
                                 / sum(s["ms"] for s in steady)) if sharded else 0.0,
            "launches_per_step": [s["launches"] for s in steps],
            "shapes": sorted({(k, tuple(shape)) for s in steps
                              for k, shapes in s["shapes"].items() for shape in shapes})}


def ring_check(torch, mesh) -> dict:
    """The ring over ``sp`` at the training shape (B 32, L 64 cut in two,
    H 8, Dh 32, bf16; a row whose second half, this ring's second chunk,
    is padding and a row with every key masked), on this rank's block:
    its output and dq, dk, dv through the kernels against the plain ring
    (the same ring through the ``_plain`` functions) on the same CUDA
    tensors: out within atol/rtol 1e-2 (bf16); each gradient element
    sums k launches' bf16 results, so within the sum of their tolerances,
    ``k * TOL_BWD + TOL_BWD * sum_i |plain step i|`` (the magnitudes from
    the plain ring run on absolute values). Fails on a difference;
    returns the max abs errors and the largest share of the tolerance."""
    from semantic_merge_tpu_torch.parallel.flash import (flash_attention_backward_plain,
                                                         flash_chunk_attention_plain)
    from semantic_merge_tpu_torch.parallel.ring import ring_attention, ring_backward, ring_forward

    b, L, h, dh = 32, 64, 8, 32
    g = torch.Generator(device="cuda").manual_seed(17)  # the same global tensors on every rank
    q, k, v, do = (torch.randn(b, L, h, dh, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    lengths = torch.randint(1, L + 1, (b,), device="cuda", generator=g)
    mask = torch.arange(L, device="cuda")[None, :] < lengths[:, None]
    mask[0, L // 2:] = False
    mask[1] = False
    n, j = mesh.axis_size("sp"), mesh.axis_index("sp")
    lo, hi = j * L // n, (j + 1) * L // n
    block = [t[:, lo:hi].contiguous() for t in (q, k, v, mask, do)]
    leaves = [t.clone().requires_grad_() for t in block[:3]]
    out = ring_attention(*leaves, block[3], mesh)
    out.backward(block[4])
    kernel_run = [out.detach().float()] + [t.grad.float() for t in leaves]
    qb, kb, vb, mb, dob = block

    def shift(tensors):
        return mesh.ring_shift(tensors, "sp")

    # The plain ring, rounded to the dtypes the ring returns.
    o, m, l = ring_forward(qb, kb, vb, mb, n, shift, flash_chunk_attention_plain)
    grads = ring_backward(qb, kb, vb, mb, m, l, o, dob, n, shift,
                          flash_attention_backward_plain)
    plain_run = [t.to(torch.bfloat16).float() for t in (o, *grads)]
    mags = ring_backward(qb, kb, vb, mb, m, l, o, dob, n, shift, lambda *args: tuple(
        t.abs() for t in flash_attention_backward_plain(*args)))
    torch.cuda.synchronize()
    errs = {}
    for name, got, want, mag in zip(("out", "dq", "dk", "dv"), kernel_run, plain_run,
                                   (None, *mags)):
        tol = (1e-2 + 1e-2 * want.abs() if mag is None else n * TOL_BWD + TOL_BWD * mag)
        err = (got - want).abs()
        if not torch.isfinite(got).all():
            fail(f"the ring's {name} on rank {mesh.rank}: non-finite values")
        if bool((err > tol).any()):
            fail(f"the ring's {name} on rank {mesh.rank}: max abs err {err.max().item():.3e} "
                 f"against the plain ring, beyond its tolerance at {int((err > tol).sum())} "
                 "elements")
        errs[name] = {"max_abs_err": err.max().item(), "tol_share": (err / tol).max().item()}
    return errs


def mesh_model_child(inputs_path: str) -> int:
    """One rank of phase 5e's two-rank group (``--mesh-model-rank PATH``):
    joins the group through the port's ``init_distributed`` with the
    ``SEMMERGE_*`` contract, then on each mesh of :data:`MESH_MODELS` in
    turn (the same order on both ranks) runs :func:`model_steps` from
    the pickled weights and batches, with :func:`ring_check` first on
    the ring's mesh; prints one ``MESH_MODEL_RESULT`` JSON line."""
    import pickle

    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.parallel.distributed import init_distributed, world
    from semantic_merge_tpu_torch.parallel.mesh import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed()
    rank, size = world()
    with open(inputs_path, "rb") as fh:
        state, batches = pickle.load(fh)
    out = {"rank": rank, "size": size, "backend": dist.get_backend(), "meshes": {}}
    for label, axis, changes in MESH_MODELS:
        mesh = build_mesh(**{a: (size if a == axis else 1) for a in ("dp", "pp", "sp", "tp", "ep")})
        if label == "sp2_ring":
            out["ring_check"] = ring_check(torch, mesh)
            kernels.reset_launches()
        out["device"] = str(mesh.device)
        out["meshes"][label] = model_steps(torch, state, batches, changes, mesh)
    print("MESH_MODEL_RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def _check_model_run(label: str, run: dict, want_losses: list, ring_steps: int = 1,
                     exact: bool = False) -> None:
    """The losses against the one-device steps' (``exact``: equal), and
    each kernel's launches a step: 8 (4 layers x 2 towers) at one ring
    step, 8k on a ring of k steps."""
    for i, (got, want) in enumerate(zip(run["losses"], want_losses)):
        if exact and got != want:
            fail(f"{label}: step {i + 1}'s loss {got!r} is not the one-device step's {want!r}")
        if not abs(got - want) <= MESH_MODEL_LOSS_TOL:
            fail(f"{label}: step {i + 1}'s loss {got} is not within {MESH_MODEL_LOSS_TOL} of "
                 f"the one-device step's {want}")
    n = 8 * ring_steps
    for i, launches in enumerate(run["launches_per_step"]):
        if (launches["flash_chunk"], launches["flash_chunk_bwd"], launches["sha256"]) != (n, n, 0):
            fail(f"{label}: step {i + 1} launched {launches}, expected flash_chunk {n}, "
                 f"flash_chunk_bwd {n}, sha256 0")


def run_mesh_model_phase(torch, card: str, checked_shapes: set) -> dict:
    """Phase 5e (see the module docstring). ``checked_shapes``: the
    (kernel, shape) pairs the kernels phase already held against their
    plain versions; every other shape this phase launched is held here."""
    import pickle

    import numpy as np
    import torch.distributed as dist

    from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher
    from semantic_merge_tpu_torch.models.training import saved_steps
    from semantic_merge_tpu_torch.parallel import flash
    from semantic_merge_tpu_torch.parallel.mesh import build_mesh

    t_phase = time.perf_counter()
    state, batches = model_inputs(torch)
    one = {"soft": model_steps(torch, state, batches, {}),
           "topk": model_steps(torch, state, batches, {"moe_mode": "topk"})}
    for name, run in one.items():
        _check_model_run(f"one device ({name})", run, run["losses"])
    out = {"one_device": one}

    # a. k = 1 over an explicit one-rank NCCL group: the sharded step with
    # size-1 axes runs the one-device step's operations.
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh1 = build_mesh(dp=1, pp=1, sp=1, tp=1, ep=1, device="cuda:0")
        out["k1"] = model_steps(torch, state, batches, {}, mesh1)
        out["k1_backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    _check_model_run("k = 1 (one-rank NCCL group)", out["k1"], one["soft"]["losses"],
                     exact=True)

    # b. Two gloo ranks on cuda:0: one pair of children through every mesh.
    path = WORK / "mesh_model_inputs.pkl"
    with open(path, "wb") as fh:
        pickle.dump((state, batches), fh)
    contract = dict(os.environ, SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}",
                    SEMMERGE_NUM_PROCESSES="2", SEMMERGE_DAEMON="off")
    t0 = time.perf_counter()
    procs = [started(subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--mesh-model-rank", str(path)], cwd=WORK,
        env=dict(contract, SEMMERGE_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for rank in range(2)]
    ranks = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("MESH_MODEL_RESULT ")]
        if proc.returncode != 0 or not lines:
            fail(f"a mesh model rank exited {proc.returncode}: {stderr[-3000:]}")
        ranks.append(json.loads(lines[-1][len("MESH_MODEL_RESULT "):]))
    out["k2_wall_s"] = time.perf_counter() - t0
    for got in ranks:
        if (got["size"], got["backend"], got["device"]) != (2, "gloo", "cuda:0"):
            fail(f"mesh model rank {got['rank']}: {got['size']} ranks over {got['backend']} "
                 f"on {got['device']}, expected 2 over gloo on cuda:0")
        for label, _axis, changes in MESH_MODELS:
            want = one["topk" if changes.get("moe_mode") == "topk" else "soft"]["losses"]
            _check_model_run(f"{label} (rank {got['rank']})", got["meshes"][label], want,
                             ring_steps=2 if label == "sp2_ring" else 1)
    for label, _axis, _changes in MESH_MODELS:
        if ranks[0]["meshes"][label]["losses"] != ranks[1]["meshes"][label]["losses"]:
            fail(f"{label}: the two ranks' losses differ (each must be the global batch's)")
    out["ring_check"] = {f"rank{got['rank']}": got["ring_check"] for got in ranks}
    out["k2"] = ranks[0]["meshes"]

    # c. train-matcher --steps 20 as two ranks (dp = 2); rank 0's
    # checkpoint in a one-device signature matcher.
    ckpt = WORK / "mesh_model_ckpt"
    contract = dict(os.environ, PYTHONPATH=str(REPO), SEMMERGE_DAEMON="off",
                    SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}", SEMMERGE_NUM_PROCESSES="2")
    t0 = time.perf_counter()
    procs = [started(subprocess.Popen(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "train-matcher", "--steps", "20",
         "--ckpt-every", "20", "--ckpt-dir", str(ckpt)], cwd=WORK,
        env=dict(contract, SEMMERGE_PROCESS_ID=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for rank in range(2)]
    cli = [proc.communicate(timeout=300) + (proc.returncode,) for proc in procs]
    out["cli_wall_s"] = time.perf_counter() - t0
    for rank, (_stdout, stderr, code) in enumerate(cli):
        if code != 0 or f"process {rank}/2" not in stderr:
            fail(f"the two-rank train-matcher's rank {rank} exited {code}: {stderr[-3000:]}")
    if not re.fullmatch(rf"trained 20 steps, final loss \d+\.\d{{4}}, checkpoints in "
                        rf"{re.escape(str(ckpt))}\n", cli[0][0]) or cli[1][0]:
        fail(f"the two-rank train-matcher printed {cli[0][0]!r} (rank 0) and {cli[1][0]!r} "
             "(rank 1)")
    if [s for s, _ in saved_steps(ckpt)] != [20]:
        fail(f"the two-rank train-matcher saved steps {saved_steps(ckpt)}, expected [20]")
    matcher = EmbeddingSignatureMatcher(ckpt_dir=str(ckpt))
    z = matcher.embed_texts([f"export function f{i}(x: number): number {{ return x + {i}; }}"
                             for i in range(4)])
    if not matcher.trained or z.shape != (4, 256) or not np.isfinite(z).all():
        fail(f"rank 0's checkpoint did not load in a one-device matcher (trained "
             f"{matcher.trained}, embeddings {z.shape})")
    out["cli"] = {"stdout": cli[0][0].strip(), "matcher_device": str(matcher.device)}

    # d. Every kernel shape this phase launched, against its plain version.
    shapes = {(k, tuple(s)) for run in (*one.values(), out["k1"], *out["k2"].values())
              for k, s in run["shapes"]} - checked_shapes
    errs = {}
    for i, (kernel, (b, lq, lk, h, dh)) in enumerate(sorted(shapes)):
        if kernel == "flash_chunk":
            err = _flash_error(torch, flash, _attention_inputs(
                torch, b, lq, lk, h, dh, dead_rows=1, seed=500 + i), 1)
        else:
            err = _bwd_error(torch, flash, _bwd_inputs(
                torch, flash, b, lq, lk, h, dh, dead_rows=1, seed=600 + i), 1)
        errs[f"{kernel} B={b} Lq={lq} Lk={lk} H={h} Dh={dh}"] = err
    out["kernel_errors"] = errs
    out["wall_s"] = time.perf_counter() - t_phase
    out["card"] = card
    runs = {"one device": one["soft"], "one device (topk)": one["topk"], "k=1 NCCL": out["k1"],
            **{f"k=2 {label}": out["k2"][label] for label, _a, _c in MESH_MODELS}}
    for label, run in runs.items():
        print(f"mesh model: {label}: {run['ms_per_step']:.3f} ms per step (median of steps "
              f"2-{MESH_MODEL_STEPS}), collectives {run['collective_share']:.3f} of the wall, "
              f"launches per step {run['launches_per_step'][-1]}, losses {run['losses']}; "
              f"card: {card}", flush=True)
    print(f"mesh model: the ring against the plain ring {json.dumps(out['ring_check'])}; "
          f"new kernel shapes against their plain versions {json.dumps(errs)}; two-rank "
          f"train-matcher wall {out['cli_wall_s']:.3f} s; phase wall {out['wall_s']:.3f} s "
          f"(budget {MESH_MODEL_BUDGET_S:.0f} s); card: {card}", flush=True)
    return out


def main() -> int:
    global N_FILES, N_RETYPED
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the port")
    parser.add_argument("--files", type=int, default=N_FILES,
                        help="repository size (default: the rung5 size, 10,000 files)")
    parser.add_argument("--mesh-rank", default=None, metavar="INPUTS",
                        help="run as one rank of the mesh phase's two-rank group")
    parser.add_argument("--mesh-model-rank", default=None, metavar="INPUTS",
                        help="run as one rank of the mesh model phase's two-rank group")
    cli_args = parser.parse_args()
    N_FILES = cli_args.files
    N_RETYPED = min(N_RETYPED, N_FILES * N_RETYPED // 10_000)
    if not (REPO / "semantic_merge_tpu_torch" / "kernels" / "flash_chunk.cu").is_file():
        fail(f"the port's sources are not beside this script in {REPO}")
    if cli_args.mesh_rank:
        return mesh_child(cli_args.mesh_rank)
    if cli_args.mesh_model_rank:
        return mesh_model_child(cli_args.mesh_model_rank)
    sys.path.insert(0, str(REPO))
    import torch

    t = t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, stdout=subprocess.PIPE, text=True).stdout.split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}; "
          f"max SM clock {clock_mhz:.0f} MHz", flush=True)
    # The plain versions' f32 einsums are the references: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"references: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}", flush=True)
    t = phase("probe", t)

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import save_matcher_checkpoint
    from semantic_merge_tpu_torch.ops import fused, render

    from semantic_merge_tpu_torch.errors import ParseFault
    from semantic_merge_tpu_torch.frontend import native

    sass = {}
    for name, log in kernels.build_all(sorted(kernels.LAUNCHES)).items():
        report_ptxas(name, log)
        sass[name] = report_sass(kernels, name)
    try:
        native_s = native.build()
    except ParseFault as exc:
        fail(f"the native scanner did not build: {exc}")
    print(f"native scanner: {native.library_path().relative_to(REPO)} built in "
          f"{native_s:.3f} s (g++ {' '.join(native.CXX_FLAGS)}; 0 = already built)",
          flush=True)
    try:
        factory_s = native.build_opfactory()
        native.load_opfactory()
    except ParseFault as exc:
        fail(f"the op factory did not build or load: {exc}")
    print(f"op factory: {native.opfactory_path().relative_to(REPO)} built in "
          f"{factory_s:.3f} s (g++ {' '.join(native.OPFACTORY_FLAGS)} against "
          f"{native._python_include()}; 0 = already built)", flush=True)
    t = phase("build", t)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        # Training first, before any matcher runs: the merges below keep
        # their seeded checkpoint.
        WORK.mkdir(parents=True)
        train_run, train = run_train_phase(torch, WORK)
        print(f"train: {json.dumps(train)}", flush=True)
        t = phase("train", t)

        repo, ckpt, fused_tree = WORK / "repo", WORK / "ckpt", WORK / "fused"
        strict_tree, rsv_tree = WORK / "strict", WORK / "resolve"
        trees = synth_trees(N_FILES, DECLS, N_RETYPED)
        make_repo(repo, *trees[:3])
        rung3 = WORK / "rung3"
        rung3_trees = synth_trees(RUNG3_FILES, RUNG3_DECLS, RUNG3_FILES * N_RETYPED // N_FILES)
        extras = extra_branches(rung3_trees[0], RUNG3_FILES, RUNG3_DECLS)
        make_repo(rung3, *rung3_trees, extras=extras)
        encoder = Encoder(EncoderConfig(), generator=torch.Generator().manual_seed(0))
        save_matcher_checkpoint(ckpt, encoder.state_dict())
        config = write_config(repo, ckpt)
        last3 = RUNG3_DECLS - 1
        print(f"repo: {N_FILES} files x {DECLS} decls and a README.md; side (A): "
              f"{(N_FILES + 1) // 2} renames, {N_RETYPED} renamed+retyped, README line 2; "
              f"other (B): {(N_FILES + 3) // 4} files moved src/ -> lib/, {N_RETYPED} other "
              f"files renamed+retyped, README line 19; the rung3 repository ({RUNG3_FILES} "
              f"files x {RUNG3_DECLS} decls, side and other alike) adds stmt: "
              f"{len(range(0, RUNG3_FILES, 3))} body edits of fn<i>_{RUNG3_DECLS - 1}; drv: "
              f"{len(extras['drv'][1])} renames of fn<i>_{last3} (every {DRV_EVERY}th "
              f"file); rsv_base: {len(extras['rsv_base'][1])} three-line bodies of "
              f"fn<i>_{last3} (every {RSV_EVERY}th file), rsv_a / rsv_b: an edit of line 1 / "
              "line 2 of each; matcher checkpoint: the port's "
              "seeded init (seed 0), UNTRAINED random weights; .semmerge.toml: "
              + config.replace("\n", "; "), flush=True)
        t = phase("repo", t)

        # The matcher semdiff (two-program path). Every semdiff and
        # semmerge below scans the incremental scope (scope_files).
        from semantic_merge_tpu_torch import cli
        scopes = {}
        with Capture(cli, "_snapshots") as snaps:
            result, launches, shapes, wall, busy = run_cli(
                torch, repo, ["semdiff", "base", "side", "--json-out", "--change-signature",
                              "--signature-matcher"])
        scopes["matcher_semdiff"] = report_scope("matcher semdiff", snaps, result)
        expect_launches("matcher semdiff", launches,
                        {"flash_chunk": 8, "flash_chunk_bwd": 0, "sha256": 0})
        if result.matcher is None or result.matcher.encoder is None:
            fail("the signature matcher did not run")
        devices = {p.device.type for p in result.matcher.encoder.parameters()}
        if devices != {"cuda"}:
            fail(f"encoder parameters on {devices}, expected cuda")
        phase4 = {"matcher_semdiff": _digest(cli.render(result.ops, True) + "\n")}
        counts = _counts(result.ops)
        print(f"matcher semdiff ops by type {json.dumps(counts)}", flush=True)
        if counts.get("renameSymbol") != (N_FILES + 1) // 2:
            fail(f"{counts.get('renameSymbol')} renameSymbol ops, expected {(N_FILES + 1) // 2}")
        if counts.get("deleteDecl", 0) + counts.get("changeSignature", 0) != N_RETYPED:
            fail(f"deleteDecl + changeSignature != {N_RETYPED}")
        runs = {"train": train_run, "semdiff": (launches, shapes)}
        t = phase("semdiff", t)

        # The fused semdiff.
        with Capture(fused, "_fused_diff_program") as diff_program, \
                Capture(cli, "_snapshots") as snaps:
            result, launches, shapes, wall, busy = run_cli(
                torch, repo, ["semdiff", "base", "side", "--json-out"])
        scopes["fused_semdiff"] = report_scope("fused semdiff", snaps, result)
        expect_launches("fused semdiff", launches, {"flash_chunk": 0, "sha256": None})
        phase4["fused_semdiff"] = _digest(cli.render(result.ops, True) + "\n")
        phase4["fused_semdiff_phases"] = dict(result.phases)
        print(f"fused semdiff checks: {json.dumps(check_fused_semdiff(torch, result))}",
              flush=True)
        runs["fused_semdiff"] = (launches, shapes)
        t = phase("fused semdiff", t)

        # The fused semmerge, in a second work tree at `side`, before the
        # matcher merge rewrites the notes.
        subprocess.run(["git", "worktree", "add", "-q", "--detach", str(fused_tree), "side"],
                       cwd=repo, check=True)
        write_config(fused_tree, ckpt)
        with Capture(fused, "_fused_merge_program") as merge_program, \
                Capture(render, "_render_program") as render_program, \
                Capture(cli, "_snapshots") as snaps:
            merged, launches, shapes, wall, busy = run_cli(
                torch, fused_tree, ["semmerge", "base", "side", "other", "--inplace"])
        scopes["fused_semmerge"] = report_scope("fused semmerge", snaps, merged)
        expect_launches("fused semmerge", launches, {"flash_chunk": 0, "sha256": 4})
        check_fused_semmerge(torch, fused_tree, merged)
        serializers = check_serializers(merged, fused_tree)
        runs["fused_semmerge"] = (launches, shapes)
        compose_in = (merged.result.op_log_left, merged.result.op_log_right)
        untraced = {"notes": {rev: _note(repo, rev) for rev in ("side", "other")},
                    "sha256": launches["sha256"], "wall": wall}
        t = phase("fused semmerge", t)

        # The matcher semmerge (two-program path), in a work tree of the
        # rung3 repository (its depth cut from rung5: the smoke passed
        # 1,000 s of its 1,200 s limit with the mesh phase).
        matcher_tree = WORK / "matcher"
        subprocess.run(["git", "worktree", "add", "-q", "--detach", str(matcher_tree), "side"],
                       cwd=rung3, check=True)
        write_config(matcher_tree, ckpt)
        with Capture(cli, "_snapshots") as snaps:
            merged, launches, shapes, wall, busy = run_cli(
                torch, matcher_tree, ["semmerge", "base", "side", "other", "--inplace",
                                      "--change-signature", "--signature-matcher"])
        scopes["matcher_semmerge"] = report_scope("matcher semmerge", snaps, merged)
        # The fused engine runs first, as in the JAX package, and its
        # result is set aside: the matcher could pair its deletes and adds.
        expect_launches("matcher semmerge", launches,
                        {"flash_chunk": 16, "flash_chunk_bwd": 0, "sha256": 4})
        if not {"fused", "compose"} <= set(merged.phases):
            fail("the matcher semmerge did not try the fused engine first, then compose")
        if merged.result is not None:
            print(f"semmerge ops by type: A {json.dumps(_counts(merged.result.op_log_left))}; "
                  f"B {json.dumps(_counts(merged.result.op_log_right))}; composed "
                  f"{json.dumps(_counts(merged.composed))}; conflicts {len(merged.conflicts)}")
        check_semmerge(matcher_tree, merged, RUNG3_FILES)
        runs["semmerge"] = (launches, shapes)
        t = phase("semmerge", t)
        compose = check_compose(torch, merged)
        print(f"compose: card and CPU give identical composed streams and conflicts; "
              f"alone on the card {json.dumps(compose)}", flush=True)
        t = phase("compose", t)

        # The strict merge with structured apply and statement ops, in a
        # work tree of the rung3 repository (its depth cut from rung5 to
        # keep the smoke inside its time limit): no fused engine, so no
        # sha256; the matcher refines A (B only edits bodies).
        subprocess.run(["git", "worktree", "add", "-q", "--detach", str(strict_tree), "side"],
                       cwd=rung3, check=True)
        write_config(strict_tree, ckpt)
        with Capture(cli, "_snapshots") as snaps:
            merged, launches, shapes, wall, busy = run_cli(
                torch, strict_tree, ["semmerge", "base", "side", "stmt", "--inplace",
                                     "--strict-conflicts", "--structured-apply",
                                     "--change-signature", "--signature-matcher"])
        scopes["strict_semmerge"] = report_scope("strict semmerge", snaps, merged)
        expect_launches("strict semmerge", launches,
                        {"flash_chunk": 8, "flash_chunk_bwd": 0, "sha256": 0})
        check_strict_semmerge(strict_tree, rung3_trees[1], merged, RUNG3_FILES, RUNG3_DECLS)
        runs["strict_semmerge"] = (launches, shapes)
        t = phase("strict semmerge", t)

        def path_shapes(kernel):
            union: dict = {}
            for _, shapes_ in runs.values():
                for shape, n in shapes_.get(kernel, {}).items():
                    union[shape] = union.get(shape, 0) + n
            return union

        # Timed before the driver's and the resolve merges: after longer
        # traced runs torch.profiler kept no kernel records (PERF.md §6).
        # Neither of those merges launches a hand kernel in this process.
        inference = {shape for name, (_, shapes_) in runs.items() if name != "train"
                     for shape in shapes_.get("flash_chunk", {})}
        rows = [check_kernels(torch, path_shapes("flash_chunk")),
                check_flash_bwd(torch, path_shapes("flash_chunk_bwd"), sorted(inference)),
                check_sha256(torch, path_shapes("sha256"), clock_mhz * 1e6,
                             sass["sha256"])]
        for row in rows:
            row["launches"] = {path: launches_.get(row["name"], 0)
                               for path, (launches_, _) in runs.items()}
        batched = check_batched_program(torch, merge_program.last)
        programs = time_programs(torch, {"fused merge program": merge_program.last,
                                         "fused diff program": diff_program.last,
                                         "render program (A)": render_program.first,
                                         **batched})
        check_batched_timing(programs)
        t = phase("kernels", t)

        # The device CRDT: reorderImports lists batched on the card.
        crdt_out = run_crdt_phase(torch, WORK)
        t = phase("crdt", t)

        # --trace and --profile: the fused merge of the rung3 repository,
        # untraced in one work tree, then traced and profiled by the CLI in
        # another, against the untraced run's tree, notes and launches (at
        # rung3: a rung5 merge costs 60-110 s of host disk, and the smoke
        # must end inside its limit on a slow host); then the matcher
        # semdiff profiled. After the kernels phase: its short profiler
        # sessions come first.
        card_name = torch.cuda.get_device_name(0)
        trace_ref = WORK / "traced_ref"
        subprocess.run(["git", "worktree", "add", "-q", "--detach", str(trace_ref), "side"],
                       cwd=rung3, check=True)
        write_config(trace_ref, ckpt)
        with Capture(cli, "_snapshots") as snaps:
            merged, launches, shapes, wall, busy = run_cli(
                torch, trace_ref, ["semmerge", "base", "side", "other", "--inplace"])
        if merged.code != 0:
            fail(f"the untraced rung3 fused semmerge exited {merged.code}")
        scopes["rung3_fused_semmerge"] = report_scope("rung3 fused semmerge", snaps, merged)
        # Below 4,096 rows the op logs are not rendered on the card: the
        # notes came from the native serializer.
        rung3_serializers = {}
        for rev, view in (("side", merged.result.op_log_left),
                          ("other", merged.result.op_log_right)):
            rung3_serializers[rev] = view.serializer
            if view.serializer != ("device" if view.render is not None else "native"):
                fail(f"the rung3 note on {rev} was serialized by {view.serializer!r}")
        untraced3 = {"notes": {rev: _note(rung3, rev) for rev in ("side", "other")},
                     "sha256": launches["sha256"], "wall": wall}
        traced = check_traced_fused_semmerge(rung3, trace_ref, WORK / "traced", ckpt,
                                             untraced3, card_name)
        print(f"trace: semmerge base side other --inplace --trace --profile DIR (rung3): wall "
              f"{traced['wall_s']:.3f} s (the untraced fused semmerge, under this script's "
              f"profiler: {traced['untraced_wall_s']:.3f} s); tree and notes equal the "
              f"untraced merge's; {json.dumps(traced)}", flush=True)
        profiled = check_profiled_matcher_semdiff(repo, card_name)
        print(f"trace: semdiff base side --json-out --change-signature --signature-matcher "
              f"--profile DIR2: {json.dumps(profiled)}", flush=True)
        t = phase("trace", t)

        # The incremental scope changes no byte (rung3, and a repository
        # whose collision guard falls back).
        scope_eq = check_scope_equivalence(torch, rung3, trace_ref, untraced3["notes"], ckpt)
        print(f"scope: {json.dumps(scopes)}; rung3 notes serializer {rung3_serializers}; "
              f"card: {card}", flush=True)
        t = phase("scope", t)

        # The mesh: the sharded programs at rung5 widths at k = 1 (NCCL)
        # and k = 2 (two gloo ranks on the card), the CLI merges at rung3
        # with mesh_shape = "dp=1" and at world size 2, the batch mesh,
        # and the require postures on this one-card host.
        mesh_out = run_mesh_phase(torch, merge_program.last, compose_in, batched, rung3, ckpt,
                                  trace_ref, untraced3, card)
        for row in rows:
            row["launches"]["mesh_cli_dp1"] = mesh_out["cli_dp1"]["launches"].get(row["name"], 0)
        print(f"mesh: {json.dumps(mesh_out)}", flush=True)
        t = phase("mesh", t)

        # The mesh model: the matcher's training step over the model axes
        # (one device, k = 1 over NCCL, k = 2 over gloo on the card through
        # sp ring / sp Ulysses / dp / tp / pp / ep top-k) and train-matcher
        # as two ranks.
        checked = ({("flash_chunk", shape) for shape in path_shapes("flash_chunk")}
                   | {("flash_chunk_bwd", shape) for shape in
                      set(path_shapes("flash_chunk_bwd")) | inference})
        model = run_mesh_model_phase(torch, card, checked)
        model_runs = {"mesh_model_one_device": model["one_device"]["soft"],
                      "mesh_model_one_device_topk": model["one_device"]["topk"],
                      "mesh_model_k1": model["k1"],
                      **{f"mesh_model_{label}": model["k2"][label]
                         for label, _axis, _changes in MESH_MODELS}}
        for row in rows:
            for path, run in model_runs.items():
                row["launches"][path] = sum(step.get(row["name"], 0)
                                            for step in run["launches_per_step"])
        print(f"mesh model: {json.dumps(model)}", flush=True)
        t = phase("mesh model", t)

        # The merge driver: git merge in a clone; the driver's first start
        # runs the CLI in a child process on the card.
        expected = dict(rung3_trees[1])
        for path in extras["drv"][1]:
            expected[path] = drv_rename(expected[path], int(path[len("src/mod"):-len(".ts")]),
                                        RUNG3_DECLS)
        dirty = {path for path, text in rung3_trees[1].items()
                 if "function added" in text or "function reshaped" in text}
        drv = run_driver_merge(rung3, WORK / "driver", ckpt, expected, dirty,
                               len(extras["drv"][1]))
        print(f"driver merge: git merge --no-ff drv on side, {drv['driver_starts']} driver "
              f"starts, git wall {drv['git_wall_s']:.3f} s, the CLI child's start "
              f"{drv['child_wall_s']} s, the other starts {drv['other_starts_s']} s in all; "
              f"{json.dumps(drv)}", flush=True)
        t = phase("driver merge", t)

        # The resolution tier, in a fourth work tree: one ConcurrentStmtEdit
        # per file both rsv branches edited, each merged line by line.
        # (Strict mode: the parity compose's cursor walk reports only the
        # divergent renames whose heads meet, so a merge of many of them
        # cannot resolve; see PERF.md.) No fused engine, so no sha256.
        subprocess.run(["git", "worktree", "add", "-q", "--detach", str(rsv_tree), "rsv_a"],
                       cwd=rung3, check=True)
        write_config(rsv_tree, ckpt)
        merged, launches, shapes, wall, busy = run_cli(
            torch, rsv_tree, ["semmerge", "rsv_base", "rsv_a", "rsv_b", "--inplace",
                              "--strict-conflicts", "--resolve", "auto"])
        expect_launches("resolve semmerge", launches, {"flash_chunk": 0, "sha256": 0})
        n_rsv = len(extras["rsv_a"][1])
        gates = check_resolve_semmerge(rsv_tree, merged, n_rsv, RUNG3_FILES)
        print(f"resolve semmerge: {n_rsv} ConcurrentStmtEdit conflicts, each accepted "
              f"(merged3way); resolve phase {merged.phases['resolve']:.4f} s; gates (ms) "
              f"{json.dumps(gates)}; launches {launches}", flush=True)
        runs["resolve_semmerge"] = (launches, shapes)
        for row in rows:
            row["launches"]["resolve_semmerge"] = launches.get(row["name"], 0)
        t = phase("resolve semmerge", t)

        # Other languages and the worker seam: a mixed TS + Java + C#
        # repository merged in one run, each C-family engine alone, and
        # the merge engine in a supervised child process on the card.
        lang_runs, lang = run_languages_phase(torch, WORK, WORK / "trained")
        for label, (launches_, _) in lang_runs.items():
            for row in rows:
                row["launches"][f"languages_{label}"] = launches_.get(row["name"], 0)
        print(f"languages: {json.dumps(lang)}", flush=True)
        t = phase("languages", t)

        # The merge service: the same merges, served by a warm daemon, in
        # the rung3 repository (its depth cut from rung5 to keep the smoke
        # inside its time limit), against in-process references.
        phase4_3 = {}
        for key, argv in (("matcher_semdiff", ["--change-signature", "--signature-matcher"]),
                          ("fused_semdiff", [])):
            ref_run, *_ = run_cli(torch, trace_ref, ["semdiff", "base", "side", "--json-out",
                                                     *argv])
            phase4_3[key] = _digest(cli.render(ref_run.ops, True) + "\n")
            phase4_3[f"{key}_phases"] = dict(ref_run.phases)
        svc = run_service_phase(torch, rung3, trace_ref, ckpt, untraced3, phase4_3, rung3)
        print(f"service: {json.dumps(svc)}", flush=True)
        t = phase("service", t)

        # The fleet: a router, two members it supervises and one that
        # joins over TCP, each on the card; the routed merges' launches
        # are the owner member's, read from its status.
        fleet_repo = WORK / "fleet_repo"
        make_repo(fleet_repo, *synth_trees(FLEET_FILES, RUNG3_DECLS,
                                           max(1, FLEET_FILES * N_RETYPED // N_FILES))[:3])
        flt = run_fleet_phase(torch, fleet_repo, ckpt)
        for row in rows:
            for path, key in (("fleet_semmerge", "routed_semmerge"),
                              ("fleet_semdiff", "routed_semdiff")):
                row["launches"][path] = flt[key]["owner_launches"].get(row["name"], 0)
        print(f"fleet: {json.dumps(flt)}", flush=True)
        print(f"fleet: phase wall {flt['wall_s']:.3f} s (budget {FLEET_BUDGET_S:.0f} s), "
              f"members to the ring {json.dumps(flt['member_start_s'])} s, routed semmerge "
              f"client {flt['routed_semmerge']['client_wall_s']:.3f} s vs in process "
              f"{flt['in_process']['semmerge_wall_s']:.3f} s; card: {card}", flush=True)
        t = phase("fleet", t)

        # The chaos soak with a CUDA daemon: one SIGKILL mid-soak.
        soak = run_soak_phase()
        print(f"soak: wall {soak['wall_s']:.3f} s; card: {card}", flush=True)
        t = phase("soak", t)

        emb_err = check_reference(torch, ckpt)
        print(f"reference: small-input op log identical on card and CPU; "
              f"embedding max abs err {emb_err:.3e} (atol 2e-2)")
        codes = check_reference_merges(WORK / "small", ckpt)
        print(f"reference: small merges {json.dumps(codes)} give identical exit codes, "
              "trees, conflicts and notes on the card and the CPU")
        t = phase("reference", t)
    finally:
        stop_leftovers()
        shutil.rmtree(WORK, ignore_errors=True)

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
