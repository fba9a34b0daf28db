#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``semantic_merge_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. probe: CUDA must be available; prints the card's name and power limit.
2. build: compiles every kernel of the port with nvcc (sm_90a), prints
   ptxas's registers and spills (and fails on a spill) and, where the
   toolkit has cuobjdump, the SASS counts of HMMA, LDSM, LDGSTS and LDS
   (and fails if no tensor-core instruction was emitted).
3. repo + semdiff: builds a git repository of the bench's ``synth_repo``
   shape at its rung5 size (10,000 files x 4 decls) whose side branch
   renames functions in every even file and renames AND retypes the
   first function of 256 other files, writes a matcher checkpoint from
   the port's seeded (untrained) initializer, and runs
   ``semdiff base side --json-out --change-signature --signature-matcher``
   through the port's CLI under a torch.profiler trace (for the device's
   idle share). Launch counts and shapes are set to 0 just before and
   read just after; every kernel of the path must have launched.
4. kernels: calls each kernel's wrapper on the card at every shape the
   semdiff launched it with (and at the matcher's cap, a multi-block,
   wider-head and ragged edge shapes), holds the result against its
   plain PyTorch version (normalised output and rebased row sums,
   atol/rtol 2e-3: bf16 inputs, f32 sums in another order; the plain
   f32 einsums run with TF32 off) and requires l = Lk on all-masked rows,
   and times, at each path shape, the wrapper, the plain version and one
   library call (``scaled_dot_product_attention``, a yardstick only) with
   CUDA events (and the wrapper's host cost per call), the kernel and the
   library call on the device with torch.profiler (the kernel's achieved
   GB/s and share of the bound come from this device time), and both
   replayed back to back from a CUDA graph.
5. reference: the same diff of a small input on the card and on the CPU
   (plain versions) must give identical op logs, and the card's
   embeddings must match the CPU's.

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

N_FILES, DECLS, N_RETYPED = 10_000, 4, 256
TOL = 2e-3
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM data sheet
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

SASS_OPS = ("HMMA", "LDSM", "LDGSTS", "LDS")


def report_ptxas(name: str, log: str) -> None:
    """Prints ptxas's entry, register and spill lines; fails on a spill."""
    for line in log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and (int(spills.group(1)) or int(spills.group(2))):
            fail(f"{name}: ptxas reports spills: {line.strip()}")


def report_sass(kernels, name: str) -> None:
    """Prints, per kernel function in the built library, how many HMMA
    (tensor-core MMA), LDSM (ldmatrix), LDGSTS (cp.async) and LDS
    instructions its SASS holds; fails if there is SASS but no HMMA."""
    try:
        tool = kernels.toolkit_tool("cuobjdump")
    except kernels.KernelBuildError:
        print(f"sass {name}: cuobjdump not found, counts not taken")
        return
    sass = subprocess.run([tool, "-sass", str(kernels.library_path(name))], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        header = re.search(r"Function : (\S+)", line)
        if header:
            function = header.group(1)
            counts[function] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)[.\s]", line)
        if function and op and op.group(1) in SASS_OPS:
            counts[function][op.group(1)] += 1
    for function, ops in counts.items():
        dh = re.search(r"ILi(\d+)E", function)
        label = f"Dh={dh.group(1)}" if dh else function[:60]
        print(f"sass {name} {label}: " + " ".join(f"{k} {v}" for k, v in ops.items()))
    if counts and not sum(ops["HMMA"] for ops in counts.values()):
        fail(f"{name}: no HMMA (tensor-core) instruction in the built SASS")


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


def _device_ms(torch, fn, input_sets, kernel=None, iters=40):
    """Mean device time per call of ``fn``: the summed device activities
    of a torch.profiler trace over ``iters`` calls (only those whose name
    holds ``kernel``, if given), divided by ``iters``; None if the trace
    holds none."""
    from torch.profiler import ProfilerActivity, profile

    for inputs in input_sets:
        fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*input_sets[i % len(input_sets)])
        torch.cuda.synchronize()
    spans = [(s, e) for name, s, e in _device_events(prof)
             if kernel is None or kernel in name]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / iters / 1e3


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
            "device_ms": _device_ms(torch, flash.flash_chunk_attention, sets,
                                    "flash_chunk_kernel"),
            "graph_ms": _graph_ms(torch, flash.flash_chunk_attention, sets),
            "plain_ms": _time_ms(torch, flash.flash_chunk_attention_plain, sets)[0],
            "library_ms": _time_ms(torch, sdpa, sets)[0],
            "library_device_ms": _device_ms(torch, sdpa, sets),
            "library_graph_ms": _graph_ms(torch, sdpa, sets),
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        }
        row["gb_per_s"], row["bound_share"] = _roofline(
            nbytes, row["device_ms"], max(bytes_ms, ops_ms))
        per_shape.append(row)
        print(f"flash_chunk timing {json.dumps(row)}", flush=True)

    total = sum(s["launches"] for s in per_shape)

    def mean(key):
        if any(s[key] is None for s in per_shape):
            return None
        return sum(s[key] * s["launches"] for s in per_shape) / total

    kernels_built = sorted(kernels.LAUNCHES)
    if kernels_built != ["flash_chunk"]:
        fail(f"unexpected kernel set {kernels_built}")
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


def run_semdiff(torch, repo: pathlib.Path):
    """Runs the semdiff under a torch.profiler device trace; returns its
    result, the launch counts and shapes, the op log, the host wall and
    the device's busy time (union of its activities) in seconds."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch import cli, kernels

    args = cli.build_parser().parse_args(
        ["semdiff", "base", "side", "--json-out", "--change-signature",
         "--signature-matcher"])
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = cli.semdiff(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
        text = cli.render(result.ops, json_out=True)
    finally:
        os.chdir(cwd)
    busy = _busy_us([(s, e) for _, s, e in _device_events(prof)]) / 1e6
    return result, launches, shapes, json.loads(text), wall, busy


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


def run_semmerge(torch, repo: pathlib.Path):
    """Runs ``semmerge base side other --inplace --change-signature
    --signature-matcher`` through the port's CLI function, with ``side``
    checked out, under a torch.profiler device trace; returns its
    result, the launch counts and shapes, the host wall and the device's
    busy time in seconds."""
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch import cli, kernels

    args = cli.build_parser().parse_args(
        ["semmerge", "base", "side", "other", "--inplace", "--change-signature",
         "--signature-matcher"])
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = cli.semmerge(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            shapes = {k: dict(v) for k, v in kernels.LAUNCH_SHAPES.items()}
    finally:
        os.chdir(cwd)
    busy = _busy_us([(s, e) for _, s, e in _device_events(prof)]) / 1e6
    return result, launches, shapes, wall, busy


def check_semmerge(repo: pathlib.Path, result, launches) -> None:
    """The merged work tree, the text-merged README and the notes."""
    if result.code != 0:
        fail(f"semmerge exited {result.code}, expected 0")
    if launches.get("flash_chunk") != 16:
        fail(f"{launches.get('flash_chunk')} flash_chunk launches on the semmerge path, "
             "expected 16 (2 sides x 2 embeds x 4 layers)")
    for i in range(0, N_FILES, 4):
        path = repo / "lib" / f"mod{i:05d}.ts"
        if not path.is_file() or f"renamed{i}_0" not in path.read_text():
            fail(f"{path.relative_to(repo)} is missing or lacks renamed{i}_0")
    readme = (repo / "README.md").read_text()
    if "(edited on A)" not in readme or "(edited on B)" not in readme:
        fail("README.md does not hold both sides' edits")
    for rev, log in (("side", result.result.op_log_left), ("other", result.result.op_log_right)):
        note = subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=repo,
                              check=True, stdout=subprocess.PIPE, text=True).stdout
        if len(json.loads(note)) != len(log):
            fail(f"the semmerge note on {rev} holds {len(json.loads(note))} ops, "
                 f"its op log {len(log)}")


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
#: name → (base, other's tree, exit code); the side renames foo to bar
#: and edits line 2 of the README.
SMALL_MERGES = {
    "divergent_rename": ({"src/util.ts": _SMALL_UTIL.replace("foo", "baz"), "README.md": README},
                         1),
    "rename_vs_move": ({"lib/util.ts": _SMALL_UTIL,
                        "README.md": README.replace("line 19 of", "line 19 (B) of")}, 0),
}


def check_reference_merges(work: pathlib.Path, ckpt: pathlib.Path) -> dict:
    """Small three-way merges through the CLI, each in a fresh copy of
    its repository, on the card and with ``--device cpu``: the exit
    code, the work tree (with ``.semmerge-conflicts.json``) and the notes
    on both sides must be identical."""
    from semantic_merge_tpu_torch import cli

    base = {"src/util.ts": _SMALL_UTIL, "README.md": README}
    side = {"src/util.ts": _SMALL_UTIL.replace("foo", "bar"),
            "README.md": README.replace("line 2 of", "line 2 (A) of")}
    codes = {}
    for name, (other, expect) in SMALL_MERGES.items():
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
                code = cli.main(["semmerge", "base", "side", "other", "--inplace",
                                 "--device", device])
            finally:
                os.chdir(cwd)
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
        codes[name] = expect
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
    if not (REPO / "semantic_merge_tpu_torch" / "kernels" / "flash_chunk.cu").is_file():
        fail(f"the port's sources are not beside this script in {REPO}")
    sys.path.insert(0, str(REPO))
    import torch

    t = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          stdout=subprocess.PIPE, text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)
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

    for name in sorted(kernels.LAUNCHES):
        report_ptxas(name, kernels.build(name))
        report_sass(kernels, name)
    t = phase("build", t)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        repo, ckpt = WORK / "repo", WORK / "ckpt"
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

        result, launches, shapes, ops, wall, busy = run_semdiff(torch, repo)
        t = phase("semdiff", t)
        counts = {}
        for op in ops:
            counts[op["type"]] = counts.get(op["type"], 0) + 1
        print("semdiff phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in result.phases.items()}))
        print(f"semdiff wall {wall:.3f} s (under a torch.profiler trace); "
              f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}; "
              f"ops by type {json.dumps(counts, sort_keys=True)}; "
              f"changeSignature {counts.get('changeSignature', 0)}; launches {launches}; "
              f"launch shapes (B, Lq, Lk, H, Dh) {shapes}")
        missing = [name for name, n in launches.items() if n == 0]
        if missing:
            fail(f"kernels never launched on the semdiff path: {missing}")
        if result.matcher is None or result.matcher.encoder is None:
            fail("the signature matcher did not run")
        devices = {p.device.type for p in result.matcher.encoder.parameters()}
        if devices != {"cuda"}:
            fail(f"encoder parameters on {devices}, expected cuda")
        expect_renames = (N_FILES + 1) // 2
        if counts.get("renameSymbol") != expect_renames:
            fail(f"{counts.get('renameSymbol')} renameSymbol ops, expected {expect_renames}")
        if counts.get("deleteDecl", 0) + counts.get("changeSignature", 0) != N_RETYPED:
            fail(f"deleteDecl + changeSignature != {N_RETYPED}")

        merged, merge_launches, merge_shapes, merge_wall, merge_busy = run_semmerge(torch, repo)
        t = phase("semmerge", t)
        print("semmerge phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in merged.phases.items()}))
        print(f"semmerge exit {merged.code}, wall {merge_wall:.3f} s (under a torch.profiler "
              f"trace); device busy {merge_busy:.4f} s, idle share "
              f"{1 - merge_busy / merge_wall:.4f}; launches {merge_launches}; launch shapes "
              f"(B, Lq, Lk, H, Dh) {merge_shapes}")
        if merged.result is not None:
            print(f"semmerge ops by type: A {json.dumps(_counts(merged.result.op_log_left))}; "
                  f"B {json.dumps(_counts(merged.result.op_log_right))}; composed "
                  f"{json.dumps(_counts(merged.composed))}; conflicts {len(merged.conflicts)}")
        check_semmerge(repo, merged, merge_launches)
        compose = check_compose(torch, merged)
        print(f"compose: card and CPU give identical composed streams and conflicts; "
              f"alone on the card {json.dumps(compose)}", flush=True)
        t = phase("compose", t)

        path_shapes = dict(shapes["flash_chunk"])
        for shape, n in merge_shapes["flash_chunk"].items():
            path_shapes[shape] = path_shapes.get(shape, 0) + n
        row = check_kernels(torch, path_shapes)
        t = phase("kernels", t)

        emb_err = check_reference(torch, ckpt)
        print(f"reference: small-input op log identical on card and CPU; "
              f"embedding max abs err {emb_err:.3e} (atol 2e-2)")
        codes = check_reference_merges(WORK / "small", ckpt)
        print(f"reference: small merges {codes} (name: exit) give identical exit codes, "
              "trees, conflicts and notes on the card and the CPU")
        t = phase("reference", t)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    row["launches"] = {"semdiff": launches["flash_chunk"],
                       "semmerge": merge_launches["flash_chunk"]}
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
