"""Declaration-token sequence encoder in PyTorch.

The port of the JAX package's ``models/encoder.py``: a compact pre-norm
transformer encoder whose parameters are stacked on a leading
``n_layers`` axis (the JAX layout, so weights carry over unchanged) and
whose layers run in a Python loop. Numerics follow the JAX encoder:

- bf16 activations and matmuls (f32 accumulation inside the GEMMs);
  the embedding table is cast to bf16 before the gather;
- RMS norm computes in f32 and casts back;
- attention is :func:`semantic_merge_tpu_torch.parallel.ring.ring_attention`
  (the hand-written flash-chunk kernel on the card);
- the FFN is the soft mixture of experts: every expert computes and the
  outputs blend by the gate softmax, taken in f32 and cast to bf16;
- ``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default.

The routed top-k mixture (``moe_mode="topk"``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.ring import ring_attention


@dataclass(frozen=True)
class EncoderConfig:
    vocab: int = 4096
    d_model: int = 256
    n_heads: int = 8
    d_head: int = 32
    n_layers: int = 4
    d_ff: int = 512
    n_experts: int = 4
    moe_mode: str = "soft"

    def __post_init__(self):
        if self.moe_mode != "soft":
            raise ValueError(f"moe_mode {self.moe_mode!r} is not ported; use 'soft'")


def param_shapes(cfg: EncoderConfig) -> dict:
    """Parameter name → shape: the keys and shapes of the JAX pytree
    (``init_encoder``), layer parameters stacked on axis 0."""
    L, D, H, Dh, Fd, E = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_experts)
    return {
        "embed": (cfg.vocab, D),
        "wq": (L, D, H, Dh), "wk": (L, D, H, Dh), "wv": (L, D, H, Dh),
        "wo": (L, H, Dh, D), "gate": (L, D, E),
        "w1": (L, E, D, Fd), "w2": (L, E, Fd, D),
        "ln1": (L, D), "ln2": (L, D), "ln_out": (D,),
    }


def _fan_in(name: str, cfg: EncoderConfig) -> int:
    if name == "wo":
        return cfg.n_heads * cfg.d_head
    if name == "w2":
        return cfg.d_ff
    return cfg.d_model


def _rms_norm(x, scale):
    x32 = x.float()
    rms = torch.sqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 / rms * scale).to(x.dtype)


class Encoder(nn.Module):
    """tokens (B, L) int, mask (B, L) bool → hidden states (B, L, D) bf16.

    Parameters are f32 and named as in the JAX pytree; ``generator``
    seeds the initializer (normal × fan_in^-0.5, norms at one). The
    values differ from ``jax.random``'s for the same seed; carry JAX
    weights over with :func:`semantic_merge_tpu_torch.models.matcher.params_from_jax`.
    """

    def __init__(self, cfg: EncoderConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        for name, shape in param_shapes(cfg).items():
            if name.startswith("ln"):
                t = torch.ones(shape)
            else:
                t = torch.randn(shape, generator=generator) * (_fan_in(name, cfg) ** -0.5)
            self.register_parameter(name, nn.Parameter(t.to(device), requires_grad=False))

    def forward(self, tokens, mask):
        cfg = self.cfg
        bf16 = torch.bfloat16
        B, L = tokens.shape
        D, H, Dh = cfg.d_model, cfg.n_heads, cfg.d_head
        x = self.embed.to(bf16)[tokens]
        x = x * mask[..., None].to(bf16)
        for i in range(cfg.n_layers):
            h = _rms_norm(x, self.ln1[i]).reshape(B * L, D)
            # (B·L, D) @ (D, H·Dh) lands in the (B, L, H, Dh) layout the
            # attention kernel reads, with no copy.
            q = (h @ self.wq[i].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            k = (h @ self.wk[i].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            v = (h @ self.wv[i].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            attn = ring_attention(q, k, v, mask)
            x = x + (attn.reshape(B * L, H * Dh)
                     @ self.wo[i].to(bf16).reshape(H * Dh, D)).view(B, L, D)

            h = _rms_norm(x, self.ln2[i])
            gate_logits = torch.einsum("bld,de->ble", h, self.gate[i].to(bf16)).float()
            gate = torch.softmax(gate_logits, dim=-1).to(bf16)
            up = F.gelu(torch.einsum("bld,edf->blef", h, self.w1[i].to(bf16)),
                        approximate="tanh")
            down = torch.einsum("blef,efd->bled", up, self.w2[i].to(bf16))
            x = x + torch.einsum("bled,ble->bld", down, gate)
        return _rms_norm(x, self.ln_out)
