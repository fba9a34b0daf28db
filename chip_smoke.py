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
   (fails without HMMA), SHF, LOP3, IADD3, PRMT, ISETP and IMAD for
   ``sha256`` (fails without SHF, the rotates; its bound in phase 5 is
   counted from these, so it fails there without cuobjdump).
3. repo: a git repository of the bench's ``synth_repo`` shape at its
   rung5 size (10,000 files x 4 decls): the side branch renames
   functions in every even file and renames AND retypes the first
   function of 256 other files, the other branch moves every 4th file
   to ``lib/``; a matcher checkpoint from the port's seeded (untrained)
   initializer.
4. Four runs of the port's CLI functions, each under a torch.profiler
   trace (wall, phases, device busy time and idle share), with the
   launch counts and shapes set to 0 just before and read just after:
   - matcher semdiff: ``semdiff base side --json-out --change-signature
     --signature-matcher`` (the two-program path): 8 ``flash_chunk``
     launches, no ``sha256``;
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
     stream;
   - matcher semmerge: ``semmerge base side other --inplace
     --change-signature --signature-matcher``: the fused engine runs
     first (4 ``sha256`` launches) and its result is set aside, since
     the matcher could pair deletes with adds; then the two-program path
     with 16 ``flash_chunk`` launches; the tree and notes; then the
     device compose of its op logs on the card against the CPU, and
     timed alone.
5. kernels: each kernel's wrapper on the card at the shapes the paths
   launched it with (and edge shapes), held against its plain PyTorch
   version: ``flash_chunk`` within atol/rtol 2e-3 (normalised output
   and rebased row sums; bf16 inputs, f32 sums in another order; the
   plain f32 einsums run with TF32 off, and l = Lk on all-masked rows),
   ``sha256`` bit-exact and against hashlib (lengths 0, 1, 55, 56, 63,
   64, 119 and 120, capacities of 1-3 blocks, 1 row and a row count
   that is no multiple of the CTA). Timed at the path shapes: CUDA-event
   and host time per call, device time (torch.profiler), CUDA-graph
   back-to-back time, the plain version's time, and for ``flash_chunk``
   one library call (``scaled_dot_product_attention``, a yardstick
   only); the bound from this run's shapes. Then the fused merge and
   diff programs and the render program, on the inputs the fused paths
   gave them: device time, kernels and host time per call.
6. reference: small inputs on the card and on the CPU must give
   identical op logs (a matcher semdiff) and identical exit codes,
   trees, conflicts and notes (fused semmerges, one with a
   DivergentRename conflict, which runs the host cursor walk, and a
   DivergentRename merge with --change-signature that takes the
   two-program path and its compose's host cursor walk).

Prints the kernels' JSON line, the card line, and last the device JSON.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
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
            "sha256": ("SHF", "LOP3", "IADD3", "PRMT", "ISETP", "IMAD")}
SASS_REQUIRED = {"flash_chunk": "HMMA", "sha256": "SHF"}


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


def _device_ms(torch, fn, input_sets, kernel, iters=40):
    """Mean device time of one launch of ``kernel``: the durations of its
    launches in a torch.profiler trace over ``iters`` calls, averaged over
    the launches the trace recorded (after long traced runs a trace can
    drop records; how many it kept is returned beside the mean)."""
    from torch.profiler import ProfilerActivity, profile

    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])
        torch.cuda.synchronize()
    spans = [e - s for name, s, e in _device_events(prof) if kernel in name]
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
    are kept (the function then runs as before); counts its calls."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0
        self.first = self.last = None

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls += 1
            self.last = (self.fn, args, kwargs)
            self.first = self.first or self.last
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


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
    and edits line 19 of the README, so the text layer merges it."""
    n_digits = 1
    while len(_SIG_TYPES) ** n_digits < n_files * decls:
        n_digits += 1
    base, side, other = {"README.md": README}, {}, {}
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
    return base, side, other


def _reshape(content: str, name: str, new_name: str, new_return: str) -> str:
    """Renames the file's first function and changes its return type."""
    head, rest = content.split("\n", 1)
    head = head.replace(f"function {name}(", f"function {new_name}(")
    return head.replace("): number {", f"): {new_return} {{") + "\n" + rest


def make_repo(root: pathlib.Path, base: dict, side: dict, other: dict) -> None:
    """A git repository with branches ``base``, ``side`` and ``other``
    (each a commit on ``base``), ``side`` checked out."""
    env = dict(os.environ, GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-02T00:00:00Z",
               GIT_AUTHOR_NAME="smoke", GIT_AUTHOR_EMAIL="smoke@example.com",
               GIT_COMMITTER_NAME="smoke", GIT_COMMITTER_EMAIL="smoke@example.com")

    def git(*args):
        subprocess.run(["git", *args], cwd=root, env=env, check=True,
                       stdout=subprocess.DEVNULL)

    def commit(tree, message):
        for top in ("src", "lib"):
            shutil.rmtree(root / top, ignore_errors=True)
        for path, text in tree.items():
            (root / path).parent.mkdir(parents=True, exist_ok=True)
            (root / path).write_text(text)
        git("add", "-A")
        git("commit", "-q", "-m", message)

    root.mkdir(parents=True)
    git("init", "-q", "-b", "base")
    git("config", "user.email", "smoke@example.com")  # git notes needs an identity
    git("config", "user.name", "smoke")
    commit(base, "base")
    git("checkout", "-q", "-b", "other")
    commit(other, "other")
    git("checkout", "-q", "-b", "side", "base")
    commit(side, "side")


def run_cli(torch, repo: pathlib.Path, argv: list):
    """Runs the port's ``semdiff`` or ``semmerge`` CLI function for
    ``argv`` in ``repo`` under a torch.profiler device trace, with the
    launch counts and shapes set to 0 just before and read just after;
    returns the result, the counts, the shapes, the host wall and the
    device's busy time (union of its activities) in seconds."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch import cli, kernels

    args = cli.build_parser().parse_args(argv)
    run = cli.semdiff if argv[0] == "semdiff" else cli.semmerge
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
    finally:
        os.chdir(cwd)
    busy = _busy_us([(s, e) for _, s, e in _device_events(prof)]) / 1e6
    print(f"{' '.join(argv)}: wall {wall:.3f} s (under a torch.profiler trace); device busy "
          f"{busy:.4f} s, idle share {1 - busy / wall:.4f}; launches {launches}; launch shapes "
          f"{shapes}; phases (s) "
          + json.dumps({k: round(v, 4) for k, v in result.phases.items()}), flush=True)
    return result, launches, shapes, wall, busy


def expect_launches(path: str, launches: dict, want: dict) -> None:
    """Fails unless every kernel launched as often as ``want`` says on
    this path (``None``: at least once)."""
    for name, n in want.items():
        got = launches.get(name, 0)
        if (n is None and got == 0) or (n is not None and got != n):
            fail(f"{got} {name} launches on the {path} path, expected "
                 f"{'at least 1' if n is None else n}")


def write_config(root: pathlib.Path, ckpt: pathlib.Path) -> str:
    """Writes the repository's ``.semmerge.toml`` (untracked, so no
    revision holds it): the matcher's checkpoint, a formatter that does
    nothing and no typecheck, so that the merge never waits on an
    ``npx`` without a network. Returns what it set."""
    text = (f'[engine]\nmatcher_ckpt_dir = "{ckpt}"\n'
            '[languages.typescript]\nformatter_cmd = ["true"]\n'
            '[ci]\nrequire_typecheck = false\n')
    (root / ".semmerge.toml").write_text(text)
    return text


def _counts(ops) -> dict:
    counts: dict = {}
    for op in ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    return dict(sorted(counts.items()))


def check_semmerge(repo: pathlib.Path, result) -> None:
    """The merged work tree, the text-merged README and the notes."""
    if result.code != 0:
        fail(f"semmerge exited {result.code}, expected 0")
    for i in range(0, N_FILES, 4):
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
    check_semmerge(work, merged)
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


_SMALL_UTIL = "export function foo(n: number): number {\n  return n;\n}\n"
_SMALL_G = "export function g(a: boolean, b: boolean): void {}\n"
#: name → (flags, extra files {path: (base and other, side)}, other's
#: tree, exit code, path taken); the side renames foo to bar and edits
#: line 2 of the README. In the last case the side also retypes g, a
#: delete+add pair of one (file, name, kind) that --change-signature
#: could fold, so the merge leaves the fused result for the two-program
#: path, whose compose walks the DivergentRename on the host.
SMALL_MERGES = {
    "divergent_rename": ([], {}, {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"),
                                  "README.md": README}, 1, "fused"),
    "rename_vs_move": ([], {}, {"lib/util.ts": _SMALL_UTIL,
                                "README.md": README.replace("line 19 of", "line 19 (B) of")},
                       0, "fused"),
    "divergent_rename_changesig": (
        ["--change-signature"], {"src/g.ts": (_SMALL_G, _SMALL_G.replace("a: boolean",
                                                                         "a: string"))},
        {"src/util.ts": _SMALL_UTIL.replace("foo", "baz"), "README.md": README}, 1,
        "two-program"),
}


def check_reference_merges(work: pathlib.Path, ckpt: pathlib.Path) -> dict:
    """Small three-way merges through the CLI, each in a fresh copy of
    its repository, on the card and with ``--device cpu``: the exit
    code, the work tree (with ``.semmerge-conflicts.json``) and the notes
    on both sides must be identical. Each merge must take the path
    ``SMALL_MERGES`` names: the fused engine runs once in every merge;
    the two-program path is the backend's ``compose``, and there the
    DivergentRename conflict runs the compose's host cursor walk."""
    from semantic_merge_tpu_torch import cli
    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    from semantic_merge_tpu_torch.ops import compose
    from semantic_merge_tpu_torch.ops.fused import FusedMergeEngine

    codes = {}
    for name, (flags, extra, other, expect, path) in SMALL_MERGES.items():
        base = {"src/util.ts": _SMALL_UTIL, "README.md": README}
        side = {"src/util.ts": _SMALL_UTIL.replace("foo", "bar"),
                "README.md": README.replace("line 2 of", "line 2 (A) of")}
        for file, (both, side_text) in extra.items():
            base[file], side[file], other = both, side_text, {**other, file: both}
        origin = work / name / "origin"
        make_repo(origin, base, side, other)
        outcome = {}
        for device in ("cuda", "cpu"):
            copy = work / name / device
            shutil.copytree(origin, copy)
            write_config(copy, ckpt)
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
            want = (1, 1 if path == "two-program" else 0,
                    1 if path == "two-program" and expect == 1 else 0)
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
            outcome[device] = (code, tree, notes)
        if outcome["cuda"][0] != expect:
            fail(f"small merge {name}: exit {outcome['cuda'][0]} on the card, expected {expect}")
        if outcome["cuda"] != outcome["cpu"]:
            fail(f"small merge {name}: the card's exit code, tree or notes differ from the CPU's")
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


def main() -> int:
    global N_FILES, N_RETYPED
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the port")
    parser.add_argument("--files", type=int, default=N_FILES,
                        help="repository size (default: the rung5 size, 10,000 files)")
    N_FILES = parser.parse_args().files
    N_RETYPED = min(N_RETYPED, N_FILES * N_RETYPED // 10_000)
    if not (REPO / "semantic_merge_tpu_torch" / "kernels" / "flash_chunk.cu").is_file():
        fail(f"the port's sources are not beside this script in {REPO}")
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

    sass = {}
    for name, log in kernels.build_all(sorted(kernels.LAUNCHES)).items():
        report_ptxas(name, log)
        sass[name] = report_sass(kernels, name)
    t = phase("build", t)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        repo, ckpt, fused_tree = WORK / "repo", WORK / "ckpt", WORK / "fused"
        make_repo(repo, *synth_trees(N_FILES, DECLS, N_RETYPED))
        encoder = Encoder(EncoderConfig(), generator=torch.Generator().manual_seed(0))
        save_matcher_checkpoint(ckpt, encoder.state_dict())
        config = write_config(repo, ckpt)
        print(f"repo: {N_FILES} files x {DECLS} decls and a README.md; side (A): "
              f"{(N_FILES + 1) // 2} renames, {N_RETYPED} renamed+retyped, README line 2; "
              f"other (B): {(N_FILES + 3) // 4} files moved src/ -> lib/, {N_RETYPED} other "
              "files renamed+retyped, README line 19; matcher checkpoint: the port's "
              "seeded init (seed 0), UNTRAINED random weights; .semmerge.toml: "
              + config.replace("\n", "; "), flush=True)
        t = phase("repo", t)

        # The matcher semdiff (two-program path).
        result, launches, shapes, wall, busy = run_cli(
            torch, repo, ["semdiff", "base", "side", "--json-out", "--change-signature",
                          "--signature-matcher"])
        expect_launches("matcher semdiff", launches, {"flash_chunk": 8, "sha256": 0})
        if result.matcher is None or result.matcher.encoder is None:
            fail("the signature matcher did not run")
        devices = {p.device.type for p in result.matcher.encoder.parameters()}
        if devices != {"cuda"}:
            fail(f"encoder parameters on {devices}, expected cuda")
        counts = _counts(result.ops)
        print(f"matcher semdiff ops by type {json.dumps(counts)}", flush=True)
        if counts.get("renameSymbol") != (N_FILES + 1) // 2:
            fail(f"{counts.get('renameSymbol')} renameSymbol ops, expected {(N_FILES + 1) // 2}")
        if counts.get("deleteDecl", 0) + counts.get("changeSignature", 0) != N_RETYPED:
            fail(f"deleteDecl + changeSignature != {N_RETYPED}")
        runs = {"semdiff": (launches, shapes)}
        t = phase("semdiff", t)

        # The fused semdiff.
        with Capture(fused, "_fused_diff_program") as diff_program:
            result, launches, shapes, wall, busy = run_cli(
                torch, repo, ["semdiff", "base", "side", "--json-out"])
        expect_launches("fused semdiff", launches, {"flash_chunk": 0, "sha256": None})
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
                Capture(render, "_render_program") as render_program:
            merged, launches, shapes, wall, busy = run_cli(
                torch, fused_tree, ["semmerge", "base", "side", "other", "--inplace"])
        expect_launches("fused semmerge", launches, {"flash_chunk": 0, "sha256": 4})
        check_fused_semmerge(torch, fused_tree, merged)
        runs["fused_semmerge"] = (launches, shapes)
        t = phase("fused semmerge", t)

        # The matcher semmerge (two-program path), in the first work tree.
        merged, launches, shapes, wall, busy = run_cli(
            torch, repo, ["semmerge", "base", "side", "other", "--inplace",
                          "--change-signature", "--signature-matcher"])
        # The fused engine runs first, as in the JAX package, and its
        # result is set aside: the matcher could pair its deletes and adds.
        expect_launches("matcher semmerge", launches, {"flash_chunk": 16, "sha256": 4})
        if not {"fused", "compose"} <= set(merged.phases):
            fail("the matcher semmerge did not try the fused engine first, then compose")
        if merged.result is not None:
            print(f"semmerge ops by type: A {json.dumps(_counts(merged.result.op_log_left))}; "
                  f"B {json.dumps(_counts(merged.result.op_log_right))}; composed "
                  f"{json.dumps(_counts(merged.composed))}; conflicts {len(merged.conflicts)}")
        check_semmerge(repo, merged)
        runs["semmerge"] = (launches, shapes)
        t = phase("semmerge", t)
        compose = check_compose(torch, merged)
        print(f"compose: card and CPU give identical composed streams and conflicts; "
              f"alone on the card {json.dumps(compose)}", flush=True)
        t = phase("compose", t)

        def path_shapes(kernel):
            union: dict = {}
            for _, shapes_ in runs.values():
                for shape, n in shapes_.get(kernel, {}).items():
                    union[shape] = union.get(shape, 0) + n
            return union

        rows = [check_kernels(torch, path_shapes("flash_chunk")),
                check_sha256(torch, path_shapes("sha256"), clock_mhz * 1e6,
                             sass["sha256"])]
        for row in rows:
            row["launches"] = {path: launches_.get(row["name"], 0)
                               for path, (launches_, _) in runs.items()}
        time_programs(torch, {"fused merge program": merge_program.last,
                              "fused diff program": diff_program.last,
                              "render program (A)": render_program.first})
        t = phase("kernels", t)

        emb_err = check_reference(torch, ckpt)
        print(f"reference: small-input op log identical on card and CPU; "
              f"embedding max abs err {emb_err:.3e} (atol 2e-2)")
        codes = check_reference_merges(WORK / "small", ckpt)
        print(f"reference: small merges {json.dumps(codes)} give identical exit codes, "
              "trees, conflicts and notes on the card and the CPU")
        t = phase("reference", t)
    finally:
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
