"""One rank of a gloo process group on the CPU, for the port's sharded
programs (``tests/test_torch_sharded.py``) and its model half over
several devices (``tests/test_torch_model_parallel*.py``).

``GlooGroup(world)`` starts ``world`` of these processes on a free
loopback port; each joins the group through the port's
``init_distributed`` with the ``SEMMERGE_*`` contract, builds the
``dp = world`` engine mesh, then serves calls: the parent writes one
pickled ``(case, args)`` to every rank's stdin, every rank runs
``CASES[case](mesh, *args)`` and writes back its pickled result. The
model cases take the mesh's axis sizes as their first argument and
build that mesh (once per shape: every rank runs the same cases in the
same order, so every rank makes the same subgroups in the same order).
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


# --- the model half --------------------------------------------------------------

_MESHES: dict = {}


def _model_mesh(sizes: dict):
    key = tuple(sorted(sizes.items()))
    if key not in _MESHES:
        from semantic_merge_tpu_torch.parallel.mesh import build_mesh
        _MESHES[key] = build_mesh(**sizes)
    return _MESHES[key]


def _coords(mesh) -> dict:
    return {a: mesh.axis_index(a) for a in ("dp", "pp", "sp", "tp", "ep")}


def _qkv_block(mesh, x):
    """This rank's (rows over dp, positions over sp, heads over tp) block."""
    (dp, i), (sp, j), (tp, t) = ((mesh.axis_size(a), mesh.axis_index(a))
                                 for a in ("dp", "sp", "tp"))
    b, l, h = x.shape[0] // dp, x.shape[1] // sp, x.shape[2] // tp
    return x[i * b:(i + 1) * b, j * l:(j + 1) * l, t * h:(t + 1) * h]


def _attention(_mesh, sizes, mode, q, k, v, kmask, do):
    """This rank's block of the ring's (or Ulysses') output and of the
    gradients of ``sum(out * do)`` in q, k and v, with its coordinates."""
    import torch

    from semantic_merge_tpu_torch.models.matcher import local_block
    from semantic_merge_tpu_torch.parallel.ring import ring_attention
    from semantic_merge_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = _model_mesh(sizes)
    qb, kb, vb = (torch.from_numpy(_qkv_block(mesh, x).copy()).requires_grad_()
                  for x in (q, k, v))
    mb = torch.from_numpy(local_block(kmask, mesh).copy())
    fn = ulysses_attention if mode == "ulysses" else ring_attention
    out = fn(qb, kb, vb, mb, mesh)
    (out * torch.from_numpy(_qkv_block(mesh, do).copy())).sum().backward()
    return _coords(mesh), [t.detach().numpy() for t in (out, qb.grad, kb.grad, vb.grad)]


def _ulysses_refusal(_mesh, sizes, heads):
    import torch

    from semantic_merge_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = _model_mesh(sizes)
    x = torch.zeros(2, 4, heads, 8)
    try:
        ulysses_attention(x, x, x, torch.ones(2, 4, dtype=torch.bool), mesh)
    except ValueError as exc:
        return str(exc)
    return None


def _routed_moe(_mesh, sizes, cfg, h, logits, w1, w2, mask, dout):
    """The routed MoE on this rank's block of tokens (rows over dp,
    positions over sp), its experts (ep) and FFN slice (tp), as the
    encoder calls it: the output summed over tp and ep, and the
    gradients of ``sum(out * dout)``: this block's of h and of the gate
    logits, and the full w1 and w2 (each rank's partial summed over dp
    and sp, the shards gathered). Returns the coordinates too."""
    import torch

    from semantic_merge_tpu_torch.models.encoder import (EncoderConfig, _routed_moe,
                                                         gather_tensor, shard_tensor)
    from semantic_merge_tpu_torch.models.matcher import local_block
    mesh = _model_mesh(sizes)
    specs = {"w1": ("ep", None, "tp"), "w2": ("ep", "tp", None)}
    hb, gb = (torch.from_numpy(local_block(x, mesh).copy()).requires_grad_()
              for x in (h, logits))
    ws = {n: shard_tensor(torch.from_numpy(w), specs[n], mesh).requires_grad_()
          for n, w in (("w1", w1), ("w2", w2))}
    out = _routed_moe(mesh.copy(hb.bfloat16(), ("tp", "ep")), gb, ws["w1"].bfloat16(),
                      ws["w2"].bfloat16(), EncoderConfig(**cfg),
                      torch.from_numpy(local_block(mask, mesh).copy()), mesh)
    out = mesh.reduce(out, ("tp", "ep")).float()
    (out * torch.from_numpy(local_block(dout, mesh).copy())).sum().backward()
    full = {n: gather_tensor(mesh.reduce(w.grad, ("dp", "sp")), specs[n], mesh).numpy()
            for n, w in ws.items()}
    return _coords(mesh), [t.detach().numpy() for t in (out, hb.grad, gb.grad)], full


def _encoder(cfg: dict, state: dict, mesh):
    from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import params_from_jax, shard_state
    encoder = Encoder(EncoderConfig(**cfg), mesh=mesh)
    encoder.load_state_dict(shard_state(params_from_jax(state), mesh))
    return encoder


def _embed(_mesh, sizes, cfg, state, tokens, mask):
    """The sharded encoder's embeddings of the global batch (each rank
    embeds its block; the rows are gathered over dp)."""
    import torch

    from semantic_merge_tpu_torch.models.matcher import embed_global
    encoder = _encoder(cfg, state, _model_mesh(sizes))
    with torch.inference_mode():
        return embed_global(encoder, torch.from_numpy(tokens).long(),
                            torch.from_numpy(mask)).numpy()


def _train(_mesh, sizes, cfg, state, batches, temperature=0.07):
    """``make_sharded_train_step`` from the given weights over
    ``batches``: the losses and the gathered full state."""
    from semantic_merge_tpu_torch.models.encoder import EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import (MatcherConfig, gather_state,
                                                         make_sharded_train_step, optimizer)
    mesh = _model_mesh(sizes)
    mcfg = MatcherConfig(encoder=EncoderConfig(**cfg), temperature=temperature)
    encoder = _encoder(cfg, state, mesh)
    opt = optimizer(encoder, mcfg)
    step = make_sharded_train_step(mcfg, mesh)
    losses = [float(step(encoder, opt, batch)) for batch in batches]
    return losses, {k: v.numpy() for k, v in gather_state(encoder.state_dict(), mesh).items()}


def _scores(_mesh, sizes, cfg, state, batch, steps):
    """``steps`` sharded train steps on ``batch``, then ``make_scorer``'s
    scores of the true pairs and of the pairs shifted by one."""
    import numpy as np

    from semantic_merge_tpu_torch.models.encoder import EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import (MatcherConfig, make_scorer,
                                                         make_sharded_train_step, optimizer)
    mesh = _model_mesh(sizes)
    mcfg = MatcherConfig(encoder=EncoderConfig(**cfg))
    encoder = _encoder(cfg, state, mesh)
    opt = optimizer(encoder, mcfg)
    step = make_sharded_train_step(mcfg, mesh)
    for _ in range(steps):
        step(encoder, opt, batch)
    score = make_scorer(mcfg, mesh)
    shifted = np.roll(np.arange(batch["tokens_b"].shape[0]), 1)
    true = score(encoder, batch["tokens_a"], batch["mask_a"], batch["tokens_b"], batch["mask_b"])
    cross = score(encoder, batch["tokens_a"], batch["mask_a"], batch["tokens_b"][shifted],
                  batch["mask_b"][shifted])
    return true.numpy(), cross.numpy()


def _train_matcher(_mesh, sizes, cfg, train):
    """``train_matcher`` on the mesh with ``TrainConfig(**train)`` (a
    checkpoint directory shared by the ranks): the last loss, the steps
    run and the gathered full state."""
    from semantic_merge_tpu_torch.models.encoder import EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import MatcherConfig, gather_state
    from semantic_merge_tpu_torch.models.training import TrainConfig, train_matcher
    mesh = _model_mesh(sizes)
    tcfg = TrainConfig(matcher=MatcherConfig(encoder=EncoderConfig(**cfg)), **train)
    encoder, _opt, loss, ran = train_matcher(tcfg, mesh=mesh)
    return loss, ran, {k: v.numpy() for k, v in gather_state(encoder.state_dict(), mesh).items()}


def _pairs(_mesh, sizes, ckpt_dir, cfg, deletes, adds, threshold):
    """The signature matcher's pairing and embeddings on the mesh."""
    from semantic_merge_tpu_torch.models.encoder import EncoderConfig
    from semantic_merge_tpu_torch.models.matcher import MatcherConfig
    from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher
    mesh = _model_mesh(sizes)
    matcher = EmbeddingSignatureMatcher(threshold=threshold, ckpt_dir=ckpt_dir, seq_len=32,
                                        cfg=MatcherConfig(encoder=EncoderConfig(**cfg)),
                                        allow_untrained=True, mesh=mesh)
    return matcher.pair(deletes, adds), matcher.embed_texts([t for _, t in deletes])


CASES = {"diff": _diff, "diff_pair": _diff_pair, "compose": _compose, "fused": _fused,
         "scan": _scan, "rank": _rank, "attention": _attention,
         "ulysses_refusal": _ulysses_refusal, "routed_moe": _routed_moe, "embed": _embed,
         "train": _train, "scores": _scores, "train_matcher": _train_matcher,
         "pairs": _pairs}


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
