#!/usr/bin/env python3
"""How many kernel records a torch.profiler session keeps, session after
session, in one process (NVIDIA GPU; the port's SHA-256 kernel as the
probe).

    python3 scripts/profiler_records.py [--long-seconds 15] [--rounds 3]

Each session profiles CPU and CUDA activity around 40 launches of
``kernels/sha256.cu`` (32,768 rows) and counts the ``sha256`` kernel
records in its exported Chrome trace, beside the launch (runtime API)
records and the gap between each kernel record and its launch record.
Order: one short session, then per round a long session (the launches,
then ``--long-seconds`` of idle host time) followed by three short
ones: plain, with 1 s of idle before the launches, and with 1 s after
them. A last round repeats one long and one short session in a child
process whose Kineto buffer is raised to 2 GB
(``KINETO_CONFIG`` with ``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=2048``).
Prints one JSON line per session and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
LAUNCHES = 40


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--long-seconds", type=float, default=15.0)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--tag", default="default-buffer")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from semantic_merge_tpu_torch import kernels
    from semantic_merge_tpu_torch.ops.sha256 import sha256_device

    if not torch.cuda.is_available():
        print("profiler_records: needs a CUDA device", file=sys.stderr)
        return 1
    kernels.build("sha256")
    msg = torch.zeros((32768, 64), dtype=torch.uint8, device="cuda")
    lens = torch.full((32768,), 51, dtype=torch.int32, device="cuda")
    sha256_device(msg, lens)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="profiler_records_"))

    def session(name: str, before: float = 0.0, after: float = 0.0) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(before)
            for _ in range(LAUNCHES):
                sha256_device(msg, lens)
            torch.cuda.synchronize()
            time.sleep(after)
        path = out_dir / f"{name}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        kern = [e for e in events if e.get("cat") == "kernel" and "sha256" in e["name"]]
        launch = {e["args"].get("correlation"): e["ts"] for e in events
                  if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")}
        gaps = [k["ts"] - launch[k["args"]["correlation"]] for k in kern
                if k["args"].get("correlation") in launch]
        print(json.dumps({"buffer": args.tag, "session": name,
                          "t_s": round(time.perf_counter() - t_start, 3),
                          "launches": LAUNCHES, "kernel_records": len(kern),
                          "launch_records": len(launch),
                          "kernel_after_launch_us": [min(gaps), max(gaps)] if gaps else None}),
              flush=True)

    session("first")
    for r in range(args.rounds):
        session(f"long{r}", after=args.long_seconds)
        session(f"short{r}")
        session(f"short{r}_idle_before", before=1.0)
        session(f"short{r}_idle_after", after=1.0)
    if args.tag == "default-buffer":
        config = out_dir / "kineto.conf"
        config.write_text("ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=2048\n")
        env = dict(os.environ, KINETO_CONFIG=str(config))
        subprocess.run([sys.executable, __file__, "--rounds", "1", "--long-seconds",
                        str(args.long_seconds), "--tag", "2GB-buffer"], env=env, check=True,
                       timeout=600)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], stdout=subprocess.PIPE,
                              text=True).stdout.strip()
        print(f"card: {card}; torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
