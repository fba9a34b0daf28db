"""Declaration-token sequence encoder in PyTorch, on one device or a mesh.

The port of the JAX package's ``models/encoder.py``: a compact pre-norm
transformer encoder whose parameters are stacked on a leading
``n_layers`` axis (the JAX layout, so weights carry over unchanged) and
whose layers run in a Python loop. Numerics follow the JAX encoder:

- bf16 activations and matmuls (f32 accumulation inside the GEMMs);
  the embedding table is cast to bf16 before the gather;
- RMS norm computes in f32 and casts back;
- attention is :func:`semantic_merge_tpu_torch.parallel.ring.ring_attention`
  (``attn_mode="ring"``) or
  :func:`semantic_merge_tpu_torch.parallel.ulysses.ulysses_attention`
  (``"ulysses"``), the hand-written flash-chunk kernel on the card;
- the FFN is the soft mixture of experts (``moe_mode="soft"``): every
  expert computes and the outputs blend by the gate softmax, taken in
  f32 and cast to bf16; or the routed top-k mixture (``"topk"``,
  :func:`_routed_moe`): each token goes to its ``moe_top_k`` best experts
  through capacity-bounded one-hot dispatch and combine;
- ``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default.

**Over a mesh** (an :class:`Encoder` built with a
:class:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh`) each rank
holds its shard of every parameter, as the JAX table
:func:`param_specs` lays them out, and runs the forward on its block of
the batch:

- ``dp`` splits the batch rows and ``sp`` the sequence positions
  (attention over ``sp`` by the ring or Ulysses);
- ``tp`` splits the heads (the columns of ``wq``/``wk``/``wv``, the rows
  of ``wo``, the partial products summed over ``tp``), the FFN's hidden
  features (``w1`` columns, ``w2`` rows, summed) and the embedding's D
  (gathered at the lookup);
- ``ep`` splits the experts: the gate logits are gathered over ``ep``
  for the softmax and the experts' outputs summed; top-k routing gives
  each token its slot in the **global** token order (every rank's gate
  probabilities gathered over ``dp`` and ``sp``), so the capacity drops
  are the one-device model's;
- ``pp`` splits the layers, each stage holding ``n_layers / pp`` of
  them; a layer's parameters are broadcast from their stage when the
  layer runs, and every rank runs every layer. This is the counterpart
  of XLA's ``lax.scan`` over a ``pp``-sharded stack, not a pipeline
  schedule: no stage waits for another's activations.

Activations are replicated over ``tp``, ``ep`` and ``pp``; the
copy/reduce pairs of :class:`~semantic_merge_tpu_torch.parallel.mesh.MergeMesh`
mark where they feed a split computation, so every gradient is exact.
Without a mesh, or on axes of size 1, no collective runs and the forward
is the one-device one, operation for operation.

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
from ..parallel.ulysses import ulysses_attention

#: The parameters stacked on the layer axis.
LAYER_PARAMS = ("wq", "wk", "wv", "wo", "gate", "w1", "w2", "ln1", "ln2")


@dataclass(frozen=True)
class EncoderConfig:
    vocab: int = 4096
    d_model: int = 256
    n_heads: int = 8
    d_head: int = 32
    n_layers: int = 4
    d_ff: int = 512
    n_experts: int = 4
    # Sequence-parallel attention over the `sp` axis: "ring" (K/V chunks
    # rotate around the ring) or "ulysses" (head/sequence all-to-all).
    attn_mode: str = "ring"
    # FFN mixture: "soft" (every expert computes, outputs blend by the
    # gate) or "topk" (routed: each token's moe_top_k best experts, each
    # expert with ceil(moe_capacity_factor * k * tokens / E) slots).
    moe_mode: str = "soft"
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.attn_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_mode must be 'ring' or 'ulysses', got {self.attn_mode!r}")
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


def param_specs(cfg: EncoderConfig | None = None) -> dict:
    """Parameter name → the mesh axis that splits each of its dims
    (``None``: not split): the JAX package's ``param_specs`` table (the
    same for every config)."""
    return {
        "embed": (None, "tp"),
        "wq": ("pp", None, "tp", None),
        "wk": ("pp", None, "tp", None),
        "wv": ("pp", None, "tp", None),
        "wo": ("pp", "tp", None, None),
        "gate": ("pp", None, "ep"),
        "w1": ("pp", "ep", None, "tp"),
        "w2": ("pp", "ep", "tp", None),
        "ln1": ("pp", None),
        "ln2": ("pp", None),
        "ln_out": (None,),
    }


def shard_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        k = 1 if axis is None else mesh.axis_size(axis)
        if k == 1:
            continue
        n = t.shape[dim]
        if n % k:
            raise ValueError(f"dim {dim} of size {n} does not split over {axis}={k}")
        t = t.narrow(dim, mesh.axis_index(axis) * (n // k), n // k)
    return t.contiguous()


def gather_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` under ``spec`` (a
    collective of every axis in ``spec``; no gradient)."""
    t = t.detach()
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = mesh.gather(t, axis, dim)
    return t


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


def _copy(t, mesh, axes):
    return t if mesh is None else mesh.copy(t, axes)


def _reduce(t, mesh, axes):
    return t if mesh is None else mesh.reduce(t, axes)


def _gather(t, mesh, axis, dim):
    return t if mesh is None else mesh.gather(t, axis, dim)


def _local_experts(t, mesh, e_loc: int):
    """The last axis's slice of this rank's ``ep`` block of experts."""
    if mesh is None or t.shape[-1] == e_loc:
        return t
    return t.narrow(-1, mesh.axis_index("ep") * e_loc, e_loc)


def _token_rows(mesh, b: int, l: int, device) -> torch.Tensor | None:
    """The global token indices (row-major over the global (B, L)) of
    this rank's (b, l) block; ``None`` when the block is everything."""
    if mesh is None or mesh.axis_size("dp") * mesh.axis_size("sp") == 1:
        return None
    rows = mesh.axis_index("dp") * b + torch.arange(b, device=device)
    cols = mesh.axis_index("sp") * l + torch.arange(l, device=device)
    return (rows[:, None] * (l * mesh.axis_size("sp")) + cols[None, :]).reshape(-1)


def _routed_moe(h, gate_logits, w1, w2, cfg: EncoderConfig, mask, mesh=None):
    """Routed top-k mixture of experts (the GShard / Switch formulation),
    as the JAX package's ``_routed_moe``: each expert owns ``C =
    max(1, ceil(cf * k * N / E))`` slots; a token's pick beyond its
    expert's capacity is dropped (its combine weight is 0, the residual
    carries it); padding tokens take no slot. Picks are first-max argmax
    of the gate softmax with earlier picks zeroed; slots go to tokens in
    order, after the slots earlier picks took.

    h: (B, L, D) bf16; gate_logits: (B, L, E) f32 over every expert;
    w1: (E, D, F) and w2: (E, F, D) bf16; mask: (B, L) bool. Returns
    (B, L, D) bf16. Over a mesh: this rank's tokens, ``h`` already copied
    into the (``tp``, ``ep``) split, ``w1``/``w2`` its experts and F
    slice; N and the slots are the global token order's, and the result
    is this rank's partial over ``tp`` and ``ep`` (the caller sums it).
    """
    B, L, D = h.shape
    E = gate_logits.shape[-1]
    probs = torch.softmax(gate_logits, dim=-1).reshape(B * L, E)
    maskf = mask.reshape(B * L).float()
    rows = _token_rows(mesh, B, L, h.device)
    # The routing runs over every token of the global batch, in its order.
    route = probs.detach()
    route_mask = maskf
    if rows is not None:
        route = mesh.gather(mesh.gather(route.view(B, L, E), "sp", 1), "dp", 0).reshape(-1, E)
        route_mask = mesh.gather(mesh.gather(mask, "sp", 1), "dp", 0).reshape(-1).float()
    if mesh is not None:
        probs = mesh.copy(probs, ("tp", "ep"))
    N = route.shape[0]
    C = max(1, math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * N / E))
    hf = h.reshape(B * L, D)
    experts = torch.arange(E, device=h.device)
    slots = torch.arange(C, device=h.device)

    counts = torch.zeros(E, device=h.device)
    dispatch = torch.zeros(B * L, E, C, device=h.device)
    combine = torch.zeros(B * L, E, C, device=h.device)
    remaining = probs
    for _ in range(cfg.moe_top_k):
        choice_all = torch.argmax(route, dim=-1)  # first max, as jnp.argmax
        onehot_all = (choice_all[:, None] == experts).float() * route_mask[:, None]
        pos = torch.cumsum(onehot_all, dim=0) - onehot_all + counts[None, :]
        slot_all = (pos * onehot_all).sum(dim=-1)
        counts = counts + onehot_all.sum(dim=0)
        route = route * (1.0 - onehot_all)
        choice, onehot_e, slot = ((choice_all, onehot_all, slot_all) if rows is None else
                                  (choice_all[rows], onehot_all[rows], slot_all[rows]))
        prob = remaining.gather(-1, choice[:, None])[:, 0]
        # A slot past C matches no column: the pick is dropped.
        onehot_c = (slot.long()[:, None] == slots).float()
        mask_ec = onehot_e[:, :, None] * onehot_c[:, None, :]
        dispatch = dispatch + mask_ec
        combine = combine + mask_ec * prob[:, None, None]
        remaining = remaining * (1.0 - onehot_e)

    bf16 = torch.bfloat16
    e_loc = w1.shape[0]
    dispatch = _local_experts(dispatch.transpose(1, 2), mesh, e_loc).transpose(1, 2)
    combine = _local_experts(combine.transpose(1, 2), mesh, e_loc).transpose(1, 2)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(bf16), hf)
    if mesh is not None:
        # Each slot holds one token of one rank: the sum over dp and sp
        # fills every slot; each rank's gradient of it is a partial.
        axes = ("dp", "sp")
        expert_in = mesh.copy(mesh.reduce(expert_in, axes), axes)
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

    With ``mesh``, the parameters are this rank's shards of the same
    initial values (the full tensors are drawn, then cut), and
    :meth:`forward` takes this rank's block of tokens and mask (rows
    over ``dp``, positions over ``sp``) and returns its block of the
    hidden states.
    """

    def __init__(self, cfg: EncoderConfig, *, device=None,
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        specs = param_specs(cfg)
        for name, shape in param_shapes(cfg).items():
            if name.startswith("ln"):
                t = torch.ones(shape)
            else:
                t = torch.randn(shape, generator=generator) * (_fan_in(name, cfg) ** -0.5)
            if mesh is not None:
                t = shard_tensor(t, specs[name], mesh)
            self.register_parameter(name, nn.Parameter(t.to(device)))

    def _layer(self, i: int) -> dict:
        """Layer ``i``'s parameters (this rank's tp/ep shards): from the
        local stack, or over ``pp`` broadcast from the stage that holds
        them, in one message."""
        mesh = self.mesh
        pp = 1 if mesh is None else mesh.axis_size("pp")
        if pp == 1:
            return {name: getattr(self, name)[i] for name in LAYER_PARAMS}
        stage, j = divmod(i, self.cfg.n_layers // pp)
        stacks = [getattr(self, name) for name in LAYER_PARAMS]
        if mesh.axis_index("pp") == stage:
            flat = torch.cat([p[j].reshape(-1) for p in stacks])
        else:
            flat = torch.empty(sum(p[0].numel() for p in stacks), device=stacks[0].device)
        flat = mesh.broadcast(flat, "pp", stage)
        out, offset = {}, 0
        for name, p in zip(LAYER_PARAMS, stacks):
            out[name] = flat[offset:offset + p[0].numel()].view(p.shape[1:])
            offset += p[0].numel()
        return out

    def forward(self, tokens, mask):
        cfg, mesh = self.cfg, self.mesh
        bf16 = torch.bfloat16
        B, L = tokens.shape
        D, Dh = cfg.d_model, cfg.d_head
        H = self.wq.shape[2]  # this rank's heads
        attention = ulysses_attention if cfg.attn_mode == "ulysses" else ring_attention
        x = _gather(self.embed.to(bf16)[tokens], mesh, "tp", -1)
        x = x * mask[..., None].to(bf16)
        for i in range(cfg.n_layers):
            lp = self._layer(i)
            h = _copy(_rms_norm(x, lp["ln1"]), mesh, "tp").reshape(B * L, D)
            # (B·L, D) @ (D, H·Dh) lands in the (B, L, H, Dh) layout the
            # attention kernel reads, with no copy.
            q = (h @ lp["wq"].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            k = (h @ lp["wk"].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            v = (h @ lp["wv"].to(bf16).reshape(D, H * Dh)).view(B, L, H, Dh)
            attn = attention(q, k, v, mask, mesh)
            x = x + _reduce((attn.reshape(B * L, H * Dh)
                             @ lp["wo"].to(bf16).reshape(H * Dh, D)).view(B, L, D), mesh, "tp")

            h = _rms_norm(x, lp["ln2"])
            gate_logits = _gather(torch.einsum("bld,de->ble", _copy(h, mesh, "ep"),
                                               lp["gate"].to(bf16)).float(), mesh, "ep", -1)
            h = _copy(h, mesh, ("tp", "ep"))
            if cfg.moe_mode == "topk":
                moe = _routed_moe(h, gate_logits, lp["w1"].to(bf16), lp["w2"].to(bf16), cfg,
                                  mask, mesh)
            else:
                gate = _copy(torch.softmax(gate_logits, dim=-1).to(bf16), mesh, ("tp", "ep"))
                gate = _local_experts(gate, mesh, lp["w1"].shape[0])
                up = F.gelu(torch.einsum("bld,edf->blef", h, lp["w1"].to(bf16)),
                            approximate="tanh")
                down = torch.einsum("blef,efd->bled", up, lp["w2"].to(bf16))
                moe = torch.einsum("bled,ble->bld", down, gate)
            x = x + _reduce(moe, mesh, ("tp", "ep"))
        return _rms_norm(x, self.ln_out)
