"""Out-of-process language worker: newline JSON-RPC over stdio — the
port's copy of the JAX package's ``runtime/worker.py``.

    python -m semantic_merge_tpu_torch.runtime.worker [--backend host] [--device cuda|cpu]

serves the protocol on stdin/stdout, delegating to an in-process backend
of the port (:func:`~semantic_merge_tpu_torch.backends.base.get_backend`;
``host`` is the port's engine on its device, not the CPU). The worker
runs on the card unless given ``--device cpu``: without a card it prints
the device error and exits 11 before reading a request, which the client
(:class:`~semantic_merge_tpu_torch.backends.subproc.SubprocessBackend`)
surfaces as a ``WorkerError``. It never carries on on the CPU.

Wire protocol (reference ``workers/ts/src/protocol.ts``):

    → {"id": 1, "method": "buildAndDiff", "params": {"base": [...],
       "left": [...], "right": [...], "baseRev": "…", "seed": "…",
       "timestamp": "…", "changeSignature": false,
       "structuredApply": false, "statementOps": false}}
    ← {"id": 1, "result": {"opLogLeft": [...], "opLogRight": [...],
       "symbolMaps": {...}, "diagnostics": []}}

Methods ``ping``, ``buildAndDiff``, ``diff``, ``compose`` and
``shutdown``. Errors return ``{"id": n, "error": {"message": "…"}}`` and
the worker survives them; it exits on EOF or ``shutdown``.

Tracing: a request may carry a ``trace_id``. A successful response gains
a ``_worker`` block, ``{"seconds": …, "phases": {name: seconds},
"trace_id": …}``: the worker's wall time for the request and its seconds
per phase (the span phases recorded while it ran, and the backend's own
phases: ``scan``, ``encode``, ``device_diff``, ...); the client records
them as ``worker.<phase>`` spans in the request's trace.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict

def _snapshot(files):
    from ..frontend.snapshot import Snapshot
    return Snapshot(files=[{"path": f["path"], "content": f["content"]} for f in files])


def _flags(params: Dict[str, Any]) -> Dict[str, Any]:
    return dict(base_rev=params.get("baseRev", "base"), seed=params.get("seed", "0"),
                timestamp=params.get("timestamp"),
                change_signature=bool(params.get("changeSignature", False)),
                structured_apply=bool(params.get("structuredApply", False)),
                statement_ops=bool(params.get("statementOps", False)))


def _handle(backend, method: str, params: Dict[str, Any]) -> Dict[str, Any]:
    if method == "ping":
        return {"pong": True, "backend": backend.name}
    if method == "buildAndDiff":
        result = backend.build_and_diff(
            _snapshot(params["base"]), _snapshot(params["left"]),
            _snapshot(params["right"]), **_flags(params))
        return {
            "opLogLeft": [op.to_dict() for op in result.op_log_left],
            "opLogRight": [op.to_dict() for op in result.op_log_right],
            "symbolMaps": result.symbol_maps,
            "diagnostics": list(result.diagnostics),
        }
    if method == "diff":
        ops = backend.diff(_snapshot(params["base"]), _snapshot(params["right"]),
                           **_flags(params))
        return {"opLog": [op.to_dict() for op in ops]}
    if method == "compose":
        from ..core.ops import Op
        composed, conflicts = backend.compose(
            [Op.from_dict(o) for o in params["deltaA"]],
            [Op.from_dict(o) for o in params["deltaB"]])
        return {"composed": [op.to_dict() for op in composed],
                "conflicts": [c.to_dict() for c in conflicts]}
    raise ValueError(f"unknown method {method!r}")


def _phases(before: Dict[str, float], backend) -> Dict[str, float]:
    from ..obs import metrics as obs_metrics
    phases = {name: round(secs, 6)
              for name, secs in obs_metrics.phase_totals_since(before).items()}
    for name, secs in backend.phases.items():
        if isinstance(secs, float):
            phases.setdefault(name, round(secs, 6))
    return phases


def serve(backend_name: str = "host", stdin=None, stdout=None, *,
          device: str | None = None) -> int:
    """Serve the protocol until EOF or ``shutdown`` with the backend
    ``backend_name`` on ``device``. Any per-request exception becomes an
    error *response*: the worker survives it."""
    from ..backends.base import get_backend
    from ..obs import metrics as obs_metrics
    from ..utils import faults

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    backend = get_backend(backend_name, device=device)
    try:
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            # Supervision-test seam: SEMMERGE_FAULT=worker-serve:KIND
            # makes this process wedge (hang), die (exit/kill), or
            # answer garbage, so the client's deadline and respawn logic
            # meets a real misbehaving worker.
            if faults.check("worker-serve") == "garbage":
                stdout.write("this is not json\n")
                stdout.flush()
                continue
            req_id = None
            try:
                request = json.loads(line)
                req_id = request.get("id")
                method = request["method"]
                if method == "shutdown":
                    stdout.write(json.dumps({"id": req_id, "result": {}}) + "\n")
                    stdout.flush()
                    return 0
                before = obs_metrics.phase_totals()
                backend.phases.clear()  # this request's phases only
                t0 = time.perf_counter()
                result = _handle(backend, method, request.get("params", {}))
                elapsed = time.perf_counter() - t0
                result["_worker"] = {"seconds": round(elapsed, 6),
                                     "phases": _phases(before, backend),
                                     "trace_id": request.get("trace_id")}
                response = {"id": req_id, "result": result}
            except Exception as exc:  # noqa: BLE001 — becomes the error reply
                response = {"id": req_id,
                            "error": {"message": f"{type(exc).__name__}: {exc}"}}
            stdout.write(json.dumps(response) + "\n")
            stdout.flush()
    finally:
        backend.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="semmerge-worker")
    parser.add_argument("--backend", default="host",
                        help="in-process backend the worker delegates to")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="Where to run (default: cuda; cpu only when asked)")
    args = parser.parse_args(argv)
    from ..device import DeviceUnavailable
    from ..errors import KernelFault
    try:
        return serve(args.backend, device=args.device)
    except DeviceUnavailable as exc:
        # The CLI's exit without a device (its KernelFault code).
        print(f"semmerge-worker: error: {exc}", file=sys.stderr)
        return KernelFault.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
