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
- the FFN is the soft mixture of experts (``moe_mode="soft"``): every
  expert computes and the outputs blend by the gate softmax, taken in
  f32 and cast to bf16; or the routed top-k mixture (``"topk"``,
  :func:`_routed_moe`): each token goes to its ``moe_top_k`` best experts
  through capacity-bounded one-hot dispatch and combine;
- ``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default.

The parameters are trainable (:mod:`semantic_merge_tpu_torch.models.training`);
inference runs under ``torch.inference_mode``.
"""
from __future__ import annotations

import math
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
    # FFN mixture: "soft" (every expert computes, outputs blend by the
    # gate) or "topk" (routed: each token's moe_top_k best experts, each
    # expert with ceil(moe_capacity_factor * k * tokens / E) slots).
    moe_mode: str = "soft"
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.moe_mode not in ("soft", "topk"):
            raise ValueError(f"moe_mode must be 'soft' or 'topk', got {self.moe_mode!r}")
        if not 1 <= self.moe_top_k <= self.n_experts:
            raise ValueError("moe_top_k must be in [1, n_experts]")


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


def _routed_moe(h, gate_logits, w1, w2, cfg: EncoderConfig, mask):
    """Routed top-k mixture of experts (the GShard / Switch formulation),
    as the JAX package's ``_routed_moe``: each expert owns ``C =
    max(1, ceil(cf * k * N / E))`` slots; a token's pick beyond its
    expert's capacity is dropped (its combine weight is 0, the residual
    carries it); padding tokens take no slot. Picks are first-max argmax
    of the gate softmax with earlier picks zeroed; slots go to tokens in
    order, after the slots earlier picks took.

    h: (B, L, D) bf16; gate_logits: (B, L, E) f32; w1: (E, D, F) and
    w2: (E, F, D) bf16; mask: (B, L) bool. Returns (B, L, D) bf16.
    """
    B, L, D = h.shape
    E = gate_logits.shape[-1]
    N = B * L
    C = max(1, math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * N / E))
    hf = h.reshape(N, D)
    probs = torch.softmax(gate_logits, dim=-1).reshape(N, E)
    maskf = mask.reshape(N).float()
    experts = torch.arange(E, device=h.device)
    slots = torch.arange(C, device=h.device)

    counts = torch.zeros(E, device=h.device)
    dispatch = torch.zeros(N, E, C, device=h.device)
    combine = torch.zeros(N, E, C, device=h.device)
    remaining = probs
    for _ in range(cfg.moe_top_k):
        choice = torch.argmax(remaining, dim=-1)  # first max, as jnp.argmax
        prob = remaining.gather(-1, choice[:, None])[:, 0]
        onehot_e = (choice[:, None] == experts).float() * maskf[:, None]
        pos = torch.cumsum(onehot_e, dim=0) - onehot_e + counts[None, :]
        slot = (pos * onehot_e).sum(dim=-1)
        # A slot past C matches no column: the pick is dropped.
        onehot_c = (slot.long()[:, None] == slots).float()
        mask_ec = onehot_e[:, :, None] * onehot_c[:, None, :]
        dispatch = dispatch + mask_ec
        combine = combine + mask_ec * prob[:, None, None]
        counts = counts + onehot_e.sum(dim=0)
        remaining = remaining * (1.0 - onehot_e)

    bf16 = torch.bfloat16
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(bf16), hf)
    up = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w1), approximate="tanh")
    down = torch.einsum("ecf,efd->ecd", up, w2)
    out = torch.einsum("nec,ecd->nd", combine.to(bf16), down)
    return out.reshape(B, L, D)


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
            self.register_parameter(name, nn.Parameter(t.to(device)))

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
            if cfg.moe_mode == "topk":
                x = x + _routed_moe(h, gate_logits, self.w1[i].to(bf16),
                                    self.w2[i].to(bf16), cfg, mask)
            else:
                gate = torch.softmax(gate_logits, dim=-1).to(bf16)
                up = F.gelu(torch.einsum("bld,edf->blef", h, self.w1[i].to(bf16)),
                            approximate="tanh")
                down = torch.einsum("blef,efd->bled", up, self.w2[i].to(bf16))
                x = x + torch.einsum("bled,ble->bld", down, gate)
        return _rms_norm(x, self.ln_out)
