"""Similarity matcher: embeddings, contrastive training, weight carry-over
and checkpoints.

The port of the JAX package's ``models/matcher.py``: declarations embed
through the encoder as masked-mean-pooled, L2-normalised vectors, and
candidate pairs score by cosine similarity. Matched pairs train with the
symmetric InfoNCE loss (:func:`info_nce`) and AdamW over every parameter
(:func:`optimizer`, :func:`train_step`); the attention's gradient is the
hand-written backward kernel on the card. The loop, its data and its
checkpoints are :mod:`semantic_merge_tpu_torch.models.training`.

Matcher checkpoints are ``torch.save`` files of the encoder's state dict
plus its config. The JAX package's orbax checkpoints cannot be read
without orbax; its weights come over through :func:`params_from_jax`,
which takes the ``init_encoder`` pytree (or a restored one) as numpy
arrays.
"""
from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .encoder import Encoder, EncoderConfig, param_shapes

CHECKPOINT_FILE = "matcher.pt"
#: The encoder config fields a checkpoint's parameter shapes do not give.
ROUTING_FIELDS = ("moe_mode", "moe_top_k", "moe_capacity_factor")


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
    """(B, L) tokens → (B, D) f32 L2-normalised embeddings (masked mean pool)."""
    h = encoder(tokens, mask).float()
    denom = mask.sum(dim=-1, keepdim=True).clamp_min(1).float()
    pooled = (h * mask[..., None]).sum(dim=1) / denom
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)


def info_nce(za: torch.Tensor, zb: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE: row i of ``za`` matches row i of ``zb``."""
    logits = za @ zb.T / temperature
    labels = torch.arange(za.shape[0], device=za.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


def loss_fn(encoder: Encoder, batch: dict, cfg: MatcherConfig) -> torch.Tensor:
    za = embed(encoder, batch["tokens_a"], batch["mask_a"])
    zb = embed(encoder, batch["tokens_b"], batch["mask_b"])
    return info_nce(za, zb, cfg.temperature)


def train_step(encoder: Encoder, opt: torch.optim.Optimizer, batch: dict,
               cfg: MatcherConfig) -> torch.Tensor:
    """One full training step: forward, backward, AdamW update, in place.
    ``batch`` holds ``tokens_a``/``mask_a``/``tokens_b``/``mask_b`` on the
    encoder's device. Returns the loss (a 0-dim tensor, not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(encoder, batch, cfg)
    loss.backward()
    opt.step()
    return loss.detach()


def params_from_jax(np_params: dict) -> dict:
    """The JAX encoder's parameter pytree, as numpy arrays, → a state
    dict for :class:`Encoder` (same names, same layouts, f32)."""
    return {name: torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
            for name, value in np_params.items()}


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
