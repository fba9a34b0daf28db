"""One rank of a gloo process group on the CPU, for the port's sharded
programs (``tests/test_torch_sharded.py``).

``GlooGroup(world)`` starts ``world`` of these processes on a free
loopback port; each joins the group through the port's
``init_distributed`` with the ``SEMMERGE_*`` contract, builds the
``dp = world`` engine mesh, then serves calls: the parent writes one
pickled ``(case, args)`` to every rank's stdin, every rank runs
``CASES[case](mesh, *args)`` and writes back its pickled result.
Imports torch and the port only, never JAX.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent


def _send(stream, obj) -> None:
    data = pickle.dumps(obj)
    stream.write(struct.pack("<Q", len(data)) + data)
    stream.flush()


def _recv(stream):
    head = stream.read(8)
    if len(head) < 8:
        raise EOFError("rank closed its pipe")
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(stream.read(n))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class GlooGroup:
    """``world`` CPU ranks serving the sharded cases; :meth:`run` calls
    one case on every rank and returns the ranks' results in rank
    order."""

    def __init__(self, world: int, timeout: float = 120.0) -> None:
        self.world = world
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k != "XLA_FLAGS" and not k.startswith(("SEMMERGE_", "JAX_"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", SEMMERGE_DAEMON="off",
                   SEMMERGE_COORDINATOR=f"127.0.0.1:{port}",
                   SEMMERGE_NUM_PROCESSES=str(world))
        self.procs = [subprocess.Popen(
            [sys.executable, __file__], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=dict(env, SEMMERGE_PROCESS_ID=str(rank)), cwd=str(REPO))
            for rank in range(world)]
        for proc in self.procs:
            assert _recv(proc.stdout) == "ready"

    def run(self, case: str, *args):
        for proc in self.procs:
            _send(proc.stdin, (case, args))
        out = [_recv(proc.stdout) for proc in self.procs]
        for result in out:
            if isinstance(result, BaseException):
                raise result
        return out

    def close(self) -> None:
        for proc in self.procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


# --- the rank side ----------------------------------------------------------------

def _diff(mesh, base, side):
    from semantic_merge_tpu_torch.ops.sharded import diff_lift_device_sharded
    return _trim(diff_lift_device_sharded(base, side, mesh))


def _diff_pair(mesh, base, left, right):
    from semantic_merge_tpu_torch.ops.sharded import diff_lift_device_pair_sharded
    return [_trim(t) for t in diff_lift_device_pair_sharded(base, left, right, mesh)]


def _trim(t):
    fields = ("kind", "sym", "a_addr", "a_name", "a_file", "b_addr", "b_name", "b_file")
    return t.n_ops, {f: getattr(t, f)[:t.n_ops].tolist() for f in fields}


def _compose(mesh, delta_a, delta_b):
    from semantic_merge_tpu_torch.ops.sharded import compose_oplogs_device_sharded
    ops, conflicts = compose_oplogs_device_sharded(delta_a, delta_b, mesh)
    return [o.to_dict() for o in ops], [c.to_dict() for c in conflicts]


def _fused(mesh, b, l, r, hash_tab, dig_l, dig_r, C):
    """The sharded fused merge's packed row from full host columns (each
    rank takes its block)."""
    import torch

    from semantic_merge_tpu_torch.ops.fused import _fused_merge_sharded
    k, j = mesh.axis_size("dp"), mesh.axis_index("dp")

    def blk(a):
        s = a.shape[1] // k
        return torch.from_numpy(a[:, j * s:(j + 1) * s].copy())

    row = _fused_merge_sharded(blk(b), blk(l), blk(r), torch.from_numpy(hash_tab),
                               torch.from_numpy(dig_l), torch.from_numpy(dig_r), C, mesh)
    return row.numpy()


def _scan(mesh, seg_sym, vals):
    import torch

    from semantic_merge_tpu_torch.ops.sharded import _dist_seg_scan
    return _dist_seg_scan(mesh, torch.from_numpy(seg_sym), torch.from_numpy(vals)).numpy()


def _rank(mesh):
    return mesh.rank, mesh.axis_index("dp"), mesh.axis_sizes


CASES = {"diff": _diff, "diff_pair": _diff_pair, "compose": _compose, "fused": _fused,
         "scan": _scan, "rank": _rank}


def main() -> None:
    out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    sys.stdout = sys.stderr  # nothing else may write the result pipe
    inp = sys.stdin.buffer
    from semantic_merge_tpu_torch.parallel.distributed import init_distributed, world
    from semantic_merge_tpu_torch.parallel.mesh import build_mesh
    init_distributed(device="cpu")
    mesh = build_mesh(dp=world()[1], pp=1, sp=1, tp=1, ep=1)
    _send(out, "ready")
    while True:
        try:
            case, args = _recv(inp)
        except EOFError:
            break
        try:
            result = CASES[case](mesh, *args)
        except Exception as exc:  # the parent re-raises it
            result = RuntimeError(f"rank {mesh.rank}: {type(exc).__name__}: {exc}")
        _send(out, result)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
