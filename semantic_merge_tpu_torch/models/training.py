"""Matcher training loop: data synthesis, checkpoints, resume.

The port of the JAX package's ``models/training.py``. The data side
synthesizes contrastive pairs the way the merge pipeline meets them: a
declaration and its renamed / edited twin (positive), everything else
in the batch (negatives); :func:`synth_pair` and :func:`batches` make
the JAX package's strings and token arrays exactly (the same
``np.random.RandomState`` calls in the same order). Each step is
:func:`semantic_merge_tpu_torch.models.matcher.train_step` on the card
(or on the CPU when asked for).

Checkpoints are ``torch.save`` files in ``ckpt_dir``: ``step_<N>.pt``
holds the parameters, the AdamW state and the step, the newest ``keep``
of them are kept, and every save also writes ``matcher.pt``
(:func:`semantic_merge_tpu_torch.models.matcher.save_matcher_checkpoint`),
which the signature matcher reads, so ``[engine] matcher_ckpt_dir`` can
name a ``train-matcher --ckpt-dir``. A run resumes from the newest
``step_<N>.pt`` and fast-forwards the data stream, so that a resumed run
equals an uninterrupted one.

On a mesh (:func:`train_matcher`'s ``mesh``, every rank calling it
together) every rank draws the same stream and trains its shards on its
block (:func:`~semantic_merge_tpu_torch.models.matcher.make_sharded_train_step`);
each checkpoint is the gathered full state in the same format, written
by rank 0 alone (:func:`~semantic_merge_tpu_torch.parallel.distributed.is_writer`),
and a resume cuts it into this mesh's shards. So a one-device run
resumes from a sharded run's checkpoint and the other way round, on any
mesh shape.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.loggingx import logger
from ..parallel.distributed import is_writer
from .encoder import Encoder, EncoderConfig, gather_tensor, param_shapes, param_specs, shard_tensor
from .features import encode_batch
from .matcher import (MatcherConfig, batch_on, gather_state, make_sharded_train_step,
                      optimizer, save_matcher_checkpoint, shard_state, train_step)


@dataclass(frozen=True)
class TrainConfig:
    matcher: MatcherConfig = MatcherConfig()
    batch: int = 32
    seq: int = 64
    steps: int = 200
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3


_TYPES = ("number", "string", "boolean", "void", "string[]", "number[]")
_VERBS = ("get", "set", "make", "load", "store", "filter", "map", "merge",
          "resolve", "apply", "lift", "scan", "encode", "index")
_NOUNS = ("user", "node", "decl", "file", "symbol", "op", "tree", "batch",
          "merge", "config", "token", "chunk", "shard", "mesh")


def synth_pair(rng: np.random.RandomState) -> Tuple[str, str]:
    """One (decl, edited twin) pair: same structure, renamed symbol and
    light body edits — the signal the matcher must learn to keep
    together; parameter/return types stay (changeSignature candidates
    score through the structural channel)."""
    verb, noun = rng.choice(_VERBS), rng.choice(_NOUNS)
    n_params = int(rng.randint(1, 4))
    params = ", ".join(
        f"p{k}: {rng.choice(_TYPES)}" for k in range(n_params))
    ret = rng.choice(_TYPES)
    body_const = int(rng.randint(0, 100))
    name_a = f"{verb}{noun.capitalize()}"
    name_b = f"{rng.choice(_VERBS)}{noun.capitalize()}V2"
    src = (f"export function {name_a}({params}): {ret} {{\n"
           f"  const k = {body_const};\n  return undefined as any;\n}}\n")
    edited = src.replace(name_a, name_b).replace(
        f"const k = {body_const}", f"const k = {body_const + 1}")
    return src, edited


def batches(cfg: TrainConfig) -> Iterator[dict]:
    rng = np.random.RandomState(cfg.seed)
    vocab = cfg.matcher.encoder.vocab
    while True:
        pairs = [synth_pair(rng) for _ in range(cfg.batch)]
        ta, ma = encode_batch([p[0] for p in pairs], vocab, cfg.seq)
        tb, mb = encode_batch([p[1] for p in pairs], vocab, cfg.seq)
        yield {"tokens_a": ta, "mask_a": ma, "tokens_b": tb, "mask_b": mb}


_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def saved_steps(ckpt_dir) -> List[Tuple[int, pathlib.Path]]:
    """``(step, path)`` of every training checkpoint in ``ckpt_dir``,
    oldest first."""
    path = pathlib.Path(ckpt_dir)
    found = [(int(m.group(1)), p) for p in path.glob("step_*.pt")
             if (m := _STEP_FILE.fullmatch(p.name))]
    return sorted(found)


def _moments(opt_state: dict, cfg: EncoderConfig, mesh, move) -> dict:
    """An AdamW state dict with each parameter's moments passed through
    ``move(tensor, spec, mesh)`` (the parameters in registration order)."""
    names, specs = list(param_shapes(cfg)), param_specs()
    state = {idx: {key: move(value, specs[names[idx]], mesh)
                   if key in ("exp_avg", "exp_avg_sq") else value
                   for key, value in entry.items()}
             for idx, entry in opt_state["state"].items()}
    return {**opt_state, "state": state}


def _save(cfg: TrainConfig, step: int, encoder: Encoder, opt, mesh=None) -> None:
    params, opt_state = encoder.state_dict(), opt.state_dict()
    if mesh is not None:
        params = gather_state(params, mesh)
        opt_state = _moments(opt_state, cfg.matcher.encoder, mesh,
                             lambda t, spec, m: gather_tensor(t, spec, m).cpu())
    if is_writer():
        path = pathlib.Path(cfg.ckpt_dir)
        out = path / f"step_{step:08d}.pt"
        tmp = out.with_suffix(".tmp")
        torch.save({"step": step,
                    "encoder_config": dataclasses.asdict(cfg.matcher.encoder),
                    "params": {k: v.detach().cpu() for k, v in params.items()},
                    "optimizer": opt_state}, tmp)
        tmp.replace(out)
        save_matcher_checkpoint(path, params, cfg.matcher.encoder)
        for _, old in saved_steps(path)[:-cfg.keep]:
            old.unlink()
    if mesh is not None:
        _barrier()


def _barrier() -> None:
    """Every rank waits for the others (rank 0's files are then on disk)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _same_config(stored: dict, cfg: EncoderConfig) -> bool:
    """Whether a checkpoint's stored config is ``cfg`` (fields a file
    written before they existed take their defaults)."""
    return {**dataclasses.asdict(EncoderConfig()), **stored} == dataclasses.asdict(cfg)


def train_matcher(cfg: TrainConfig, device: str | torch.device | None = None, mesh=None, *,
                  resume: bool = True):
    """Run the training loop on ``device`` (CUDA unless ``"cpu"`` is asked
    for), or on ``mesh`` (every rank of it calling this together, each
    on the mesh's device); returns ``(encoder, optimizer, last_loss,
    steps_run)``, on a mesh this rank's shards. With ``ckpt_dir`` set,
    saves every ``ckpt_every`` steps and at the last step, and resumes
    from the latest checkpoint when ``resume``. The initial parameters
    come from the port's seeded initializer (``cfg.seed``; on a mesh,
    the shards of the same values), whose values differ from
    ``jax.random``'s."""
    dev = mesh.device if mesh is not None else \
        resolve_device(str(device) if device is not None else None)
    encoder = Encoder(cfg.matcher.encoder, generator=torch.Generator().manual_seed(cfg.seed),
                      mesh=mesh).to(dev)
    opt = optimizer(encoder, cfg.matcher)
    start_step = 0
    if cfg.ckpt_dir:
        pathlib.Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
        saved = saved_steps(cfg.ckpt_dir)
        if resume and saved:
            data = torch.load(saved[-1][1], map_location="cpu", weights_only=True)
            if not _same_config(data["encoder_config"], cfg.matcher.encoder):
                raise ValueError(f"{saved[-1][1]}: encoder config {data['encoder_config']} "
                                 f"is not this run's {cfg.matcher.encoder}")
            params, opt_state = data["params"], data["optimizer"]
            if mesh is not None:
                params = shard_state(params, mesh)
                opt_state = _moments(opt_state, cfg.matcher.encoder, mesh, shard_tensor)
            encoder.load_state_dict(params)
            opt.load_state_dict(opt_state)
            start_step = data["step"]
            logger.info("resumed matcher training at step %d from %s",
                        start_step, cfg.ckpt_dir)

    stream = batches(cfg)
    # Fast-forward the stream so a resumed run sees the batches it would
    # have seen uninterrupted.
    for _ in range(start_step):
        next(stream)
    if mesh is not None:
        step_fn = make_sharded_train_step(cfg.matcher, mesh)
    else:
        def step_fn(encoder, opt, batch):
            return train_step(encoder, opt, batch_on(batch, dev), cfg.matcher)

    loss = None
    step = start_step
    for step in range(start_step + 1, cfg.steps + 1):
        loss = step_fn(encoder, opt, next(stream))
        if cfg.ckpt_dir and (step % cfg.ckpt_every == 0 or step == cfg.steps):
            _save(cfg, step, encoder, opt, mesh)
    if loss is not None:
        loss = float(loss)
    return encoder, opt, loss, step - start_step
