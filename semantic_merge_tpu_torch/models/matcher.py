"""Similarity matcher: embeddings, weight carry-over and checkpoints.

The inference half of the JAX package's ``models/matcher.py``:
declarations embed through the encoder as masked-mean-pooled,
L2-normalised vectors, and candidate pairs score by cosine similarity.
Training (InfoNCE with AdamW) is not ported yet.

Checkpoints are ``torch.save`` files of the encoder's state dict plus its
config. The JAX package's orbax checkpoints cannot be read without
orbax; its weights come over through :func:`params_from_jax`, which
takes the ``init_encoder`` pytree (or a restored one) as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from .encoder import Encoder, EncoderConfig, param_shapes

CHECKPOINT_FILE = "matcher.pt"


@dataclass(frozen=True)
class MatcherConfig:
    encoder: EncoderConfig = EncoderConfig()


def embed(encoder: Encoder, tokens, mask) -> torch.Tensor:
    """(B, L) tokens → (B, D) f32 L2-normalised embeddings (masked mean pool)."""
    h = encoder(tokens, mask).float()
    denom = mask.sum(dim=-1, keepdim=True).clamp_min(1).float()
    pooled = (h * mask[..., None]).sum(dim=1) / denom
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-6)


def params_from_jax(np_params: dict) -> dict:
    """The JAX encoder's parameter pytree, as numpy arrays, → a state
    dict for :class:`Encoder` (same names, same layouts, f32)."""
    return {name: torch.from_numpy(np.asarray(value, dtype=np.float32).copy())
            for name, value in np_params.items()}


def _config_for(state: dict) -> EncoderConfig:
    """The encoder config whose parameter shapes match ``state``."""
    L, D, H, Dh = state["wq"].shape
    E, Fd = state["w1"].shape[1], state["w1"].shape[3]
    cfg = EncoderConfig(vocab=state["embed"].shape[0], d_model=D, n_heads=H,
                        d_head=Dh, n_layers=L, d_ff=Fd, n_experts=E)
    for name, shape in param_shapes(cfg).items():
        if tuple(state[name].shape) != shape:
            raise ValueError(f"checkpoint parameter {name} has shape "
                             f"{tuple(state[name].shape)}, expected {shape}")
    return cfg


def save_matcher_checkpoint(ckpt_dir, state: dict) -> pathlib.Path:
    """Write an encoder state dict to ``ckpt_dir/matcher.pt``."""
    path = pathlib.Path(ckpt_dir)
    path.mkdir(parents=True, exist_ok=True)
    cfg = _config_for(state)
    out = path / CHECKPOINT_FILE
    torch.save({"encoder_config": dataclasses.asdict(cfg),
                "params": {k: v.detach().cpu() for k, v in state.items()}}, out)
    return out


def load_matcher_checkpoint(ckpt_dir) -> tuple[EncoderConfig, dict] | None:
    """``(config, state dict)`` from ``ckpt_dir``, or ``None`` when the
    directory holds no matcher checkpoint."""
    path = pathlib.Path(ckpt_dir) / CHECKPOINT_FILE
    if not path.is_file():
        return None
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data["params"]
    cfg = _config_for(state)
    if dataclasses.asdict(cfg) != data["encoder_config"]:
        raise ValueError(f"{path}: stored config {data['encoder_config']} does "
                         f"not match the parameter shapes")
    return cfg, state
