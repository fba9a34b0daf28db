"""Similarity matcher: embeddings, contrastive training, weight carry-over
and checkpoints.

The port of the JAX package's ``models/matcher.py``: declarations embed
through the encoder as masked-mean-pooled, L2-normalised vectors, and
candidate pairs score by cosine similarity. Matched pairs train with the
symmetric InfoNCE loss (:func:`info_nce`) and AdamW over every parameter
(:func:`optimizer`, :func:`train_step`); the attention's gradient is the
hand-written backward kernel on the card. The loop, its data and its
checkpoints are :mod:`semantic_merge_tpu_torch.models.training`.

Over a mesh (an encoder built with a
:class:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh`, see
:mod:`~semantic_merge_tpu_torch.models.encoder`) every rank runs the same
code on its block of the batch (:func:`local_block`): the masked mean
pool sums its sums and counts over ``sp``, InfoNCE runs over the
**global** batch (the embeddings gathered over ``dp``), so every rank
holds the same loss, and each shard's gradient is summed over ``dp`` and
``sp`` before AdamW, so that it equals the matching slice of the
one-device gradient (:func:`make_sharded_train_step`). :func:`make_scorer`
scores global batches on a mesh. :func:`shard_state` and
:func:`gather_state` move a full state dict to the shards and back.

Matcher checkpoints are ``torch.save`` files of the encoder's state dict
plus its config. The JAX package's orbax checkpoints cannot be read
without orbax; its weights come over through :func:`params_from_jax`,
which takes the ``init_encoder`` pytree (or a restored one) as numpy
arrays, to every rank of a mesh through :func:`shard_state`.
"""
from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .encoder import (Encoder, EncoderConfig, gather_tensor, param_shapes, param_specs,
                      shard_tensor)

CHECKPOINT_FILE = "matcher.pt"
#: The encoder config fields a checkpoint's parameter shapes do not give.
ROUTING_FIELDS = ("attn_mode", "moe_mode", "moe_top_k", "moe_capacity_factor")


@dataclass(frozen=True)
class MatcherConfig:
    encoder: EncoderConfig = EncoderConfig()
    temperature: float = 0.07
    learning_rate: float = 3e-4
    weight_decay: float = 0.01


def optimizer(encoder: Encoder, cfg: MatcherConfig) -> torch.optim.AdamW:
    """AdamW over every parameter (norms and embedding included: optax's
    ``adamw`` applies no mask), with optax's defaults for the rest."""
    return torch.optim.AdamW(encoder.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def embed(encoder: Encoder, tokens, mask) -> torch.Tensor:
    """(B, L) tokens → (B, D) f32 L2-normalised embeddings (masked mean
    pool). On a mesh: this rank's block in, its rows' embeddings out."""
    mesh = encoder.mesh
    h = encoder(tokens, mask).float()
    denom = mask.sum(dim=-1, keepdim=True)
    sums = (h * mask[..., None]).sum(dim=1)
    if mesh is not None:
        denom, sums = mesh.reduce(denom, "sp"), mesh.reduce(sums, "sp")
    pooled = sums / denom.clamp_min(1).float()
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)


def embed_global(encoder: Encoder, tokens, mask) -> torch.Tensor:
    """:func:`embed` of a global (B, L) batch on every rank of the
    encoder's mesh: each rank embeds its block, the rows are gathered
    over ``dp``. Without a mesh, :func:`embed`."""
    mesh = encoder.mesh
    if mesh is None:
        return embed(encoder, tokens, mask)
    z = embed(encoder, local_block(tokens, mesh), local_block(mask, mesh))
    return mesh.gather(z, "dp", 0)


def info_nce(za: torch.Tensor, zb: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE: row i of ``za`` matches row i of ``zb``."""
    logits = za @ zb.T / temperature
    labels = torch.arange(za.shape[0], device=za.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def loss_fn(encoder: Encoder, batch: dict, cfg: MatcherConfig) -> torch.Tensor:
    """InfoNCE of a batch; on a mesh, ``batch`` is this rank's block and
    the loss the global batch's, the same on every rank."""
    za = embed(encoder, batch["tokens_a"], batch["mask_a"])
    zb = embed(encoder, batch["tokens_b"], batch["mask_b"])
    if encoder.mesh is not None:
        za, zb = encoder.mesh.gather(za, "dp", 0), encoder.mesh.gather(zb, "dp", 0)
    return info_nce(za, zb, cfg.temperature)


def train_step(encoder: Encoder, opt: torch.optim.Optimizer, batch: dict,
               cfg: MatcherConfig) -> torch.Tensor:
    """One full training step: forward, backward, AdamW update, in place.
    ``batch`` holds ``tokens_a``/``mask_a``/``tokens_b``/``mask_b`` on the
    encoder's device (on a mesh, this rank's block). Returns the loss (a
    0-dim tensor, not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(encoder, batch, cfg)
    loss.backward()
    if encoder.mesh is not None:
        _sum_grads(encoder, encoder.mesh)
    opt.step()
    return loss.detach()


def _sum_grads(encoder: Encoder, mesh) -> None:
    """Each shard's gradient summed over the axes that split the data
    (``dp`` rows, ``sp`` positions), in one message per axis: the matching
    slice of the one-device gradient. Over ``tp``, ``ep`` and ``pp`` it
    is already whole."""
    axes = mesh._live(("dp", "sp"))
    if not axes:
        return
    params = list(encoder.parameters())
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    for axis in axes:
        flat = mesh.psum(flat, axis)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def local_block(x, mesh):
    """This rank's block of a global (B, L, ...) array or tensor: rows
    over ``dp``, positions over ``sp``."""
    if mesh is None:
        return x
    (dp, i), (sp, j) = ((mesh.axis_size(a), mesh.axis_index(a)) for a in ("dp", "sp"))
    B, L = x.shape[:2]
    if B % dp or L % sp:
        raise ValueError(f"a ({B}, {L}) batch does not split over dp={dp}, sp={sp}")
    b, l = B // dp, L // sp
    return x[i * b:(i + 1) * b, j * l:(j + 1) * l]


def batch_on(batch: dict, device) -> dict:
    """Numpy (or CPU tensor) batch arrays as tensors on ``device``, tokens
    as int64."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) \
            else value
        out[key] = t.to(device, torch.long if key.startswith("tokens") else None)
    return out


def make_sharded_train_step(cfg: MatcherConfig, mesh):
    """The training step on ``mesh``: ``step(encoder, opt, batch)`` with
    the **global** batch (numpy arrays or tensors; every rank passes the
    same), ``encoder`` built on ``mesh`` and ``opt`` over its shards.
    Each rank takes its block, runs forward and backward, sums its
    gradients over ``dp`` and ``sp`` and applies AdamW to its shards.
    Returns the global loss, the same on every rank."""

    def step(encoder: Encoder, opt: torch.optim.Optimizer, batch: dict) -> torch.Tensor:
        if encoder.mesh is not mesh:
            raise ValueError("the encoder was not built on this step's mesh")
        local = batch_on({k: local_block(v, mesh) for k, v in batch.items()}, mesh.device)
        return train_step(encoder, opt, local, cfg)

    return step


def make_scorer(cfg: MatcherConfig, mesh):
    """Cosine-similarity scorer of candidate pairs on ``mesh``:
    ``score(encoder, tokens_a, mask_a, tokens_b, mask_b)`` with global
    batches gives the (B,) scores on every rank."""

    def score(encoder: Encoder, tokens_a, mask_a, tokens_b, mask_b) -> torch.Tensor:
        if encoder.mesh is not mesh:
            raise ValueError("the encoder was not built on this scorer's mesh")
        batch = batch_on({"tokens_a": tokens_a, "mask_a": mask_a, "tokens_b": tokens_b,
                           "mask_b": mask_b}, mesh.device)
        with torch.inference_mode():
            za = embed_global(encoder, batch["tokens_a"], batch["mask_a"])
            zb = embed_global(encoder, batch["tokens_b"], batch["mask_b"])
            return (za * zb).sum(dim=-1)

    return score


def params_from_jax(np_params: dict) -> dict:
    """The JAX encoder's parameter pytree, as numpy arrays, → a state
    dict for :class:`Encoder` (same names, same layouts, f32)."""
    return {name: torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
            for name, value in np_params.items()}


def shard_state(state: dict, mesh) -> dict:
    """This rank's shards of a full encoder state dict (JAX's weights
    through :func:`params_from_jax` included), by :func:`param_specs`."""
    specs = param_specs()
    return {name: shard_tensor(torch.as_tensor(value), specs[name], mesh)
            for name, value in state.items()}


def gather_state(shard: dict, mesh) -> dict:
    """The full state dict on every rank from each rank's shards (a
    collective of every mesh axis), on the CPU."""
    specs = param_specs()
    return {name: gather_tensor(value, specs[name], mesh).cpu()
            for name, value in shard.items()}


def _config_for(state: dict, routing: dict | None = None) -> EncoderConfig:
    """The encoder config whose parameter shapes match ``state``, with the
    routing fields (:data:`ROUTING_FIELDS`) from ``routing`` where it has
    them and the defaults elsewhere."""
    L, D, H, Dh = state["wq"].shape
    E, Fd = state["w1"].shape[1], state["w1"].shape[3]
    cfg = EncoderConfig(vocab=state["embed"].shape[0], d_model=D, n_heads=H,
                        d_head=Dh, n_layers=L, d_ff=Fd, n_experts=E,
                        **{k: v for k, v in (routing or {}).items() if k in ROUTING_FIELDS})
    for name, shape in param_shapes(cfg).items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"checkpoint parameter {name} has shape "
                             f"{tuple(state[name].shape)}, expected {shape}")
    return cfg


def save_matcher_checkpoint(ckpt_dir, state: dict,
                            cfg: EncoderConfig | None = None) -> pathlib.Path:
    """Write an encoder state dict to ``ckpt_dir/matcher.pt``, with its
    config (``cfg``, whose shapes must match ``state``; default: the
    shapes' config with the default routing), through a temporary file
    and a rename."""
    path = pathlib.Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    cfg = _config_for(state, dataclasses.asdict(cfg) if cfg is not None else None)
    out = path / CHECKPOINT_FILE
    tmp = out.with_suffix(".tmp")
    torch.save({"encoder_config": dataclasses.asdict(cfg),
                "params": {k: v.detach().cpu() for k, v in state.items()}}, tmp)
    tmp.replace(out)
    return out


def load_matcher_checkpoint(ckpt_dir) -> tuple[EncoderConfig, dict] | None:
    """``(config, state dict)`` from ``ckpt_dir``, or ``None`` when the
    directory holds no matcher checkpoint."""
    path = pathlib.Path(ckpt_dir) / CHECKPOINT_FILE
    if not path.is_file():
        return None
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data["params"]
    stored = data["encoder_config"]
    cfg = _config_for(state, stored)
    # Files written before the routing fields existed lack them: those
    # take the defaults. Every field a file does hold must agree.
    fields = dataclasses.asdict(cfg)
    if any(fields.get(k) != v for k, v in stored.items()):
        raise ValueError(f"{path}: stored config {stored} does "
                         f"not match the parameter shapes")
    return cfg, state
