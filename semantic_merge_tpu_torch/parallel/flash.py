"""The per-chunk attention step: a CUDA kernel on the card.

The port of the JAX package's ``parallel/flash.py`` (its Pallas TPU
kernel ``_chunk_kernel``). :func:`flash_chunk_attention` returns the
*partial* softmax statistics ``(pv, m, l)`` of q over one resident K/V
chunk — the unnormalised weighted values, the row max and the row sum —
so a caller can merge chunks with the standard online-softmax
combination. On a CUDA tensor it launches the hand-written kernel
(``kernels/flash_chunk.cu``); on a CPU tensor it runs
:func:`flash_chunk_attention_plain`, the same arithmetic in plain
PyTorch (the counterpart of the JAX package's ``_chunk_stats_einsum``),
which the tests and the on-card comparison use. There is no fallback
from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def flash_chunk_attention_plain(q, k, v, kmask):
    """Partial softmax stats in plain PyTorch, f32 throughout.

    q: (B, Lq, H, Dh); k, v: (B, Lk, H, Dh); kmask: (B, Lk) bool.
    Returns pv (B, Lq, H, Dh) f32 unnormalised and m, l (B, H, Lq) f32,
    with m the row max over the chunk and l the row sum relative to it.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~kmask[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return pv, m, l


def flash_chunk_attention(q, k, v, kmask):
    """Partial-softmax attention of ``q`` over one resident K/V chunk.

    Same arguments and results as :func:`flash_chunk_attention_plain`.
    A CUDA call takes bf16 q/k/v (16-byte aligned) and a bool mask, all
    contiguous, with Dh in :data:`SUPPORTED_HEAD_DIMS`, and raises on
    anything else. Its m and l are the two halves of one buffer.
    """
    if q.device.type == "cpu":
        return flash_chunk_attention_plain(q, k, v, kmask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_chunk_attention: unsupported device {q.device}")
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    device = q.device
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_chunk_attention: Dh={dh} not in {SUPPORTED_HEAD_DIMS}")
    if k.shape != (b, lk, h, dh) or v.shape != k.shape or kmask.shape != (b, lk):
        raise ValueError("flash_chunk_attention: shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"kmask {tuple(kmask.shape)} do not agree")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("kmask", kmask, torch.bool)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"flash_chunk_attention: {name} must be a contiguous "
                             f"{dtype} tensor on {device}")
        if name != "kmask" and t.data_ptr() % 16:
            raise ValueError(f"flash_chunk_attention: {name} must be 16-byte aligned")
    pv = torch.empty((b, lq, h, dh), dtype=torch.float32, device=device)
    m, l = torch.empty((2, b, h, lq), dtype=torch.float32, device=device)
    fn = _entry_point()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmask.data_ptr(),
                 pv.data_ptr(), m.data_ptr(), l.data_ptr(),
                 b, lq, lk, h, dh, dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_chunk kernel launch failed: cudaError {err}")
    kernels.LAUNCHES["flash_chunk"] += 1
    shapes = kernels.LAUNCH_SHAPES["flash_chunk"]
    shapes[(b, lq, lk, h, dh)] = shapes.get((b, lq, lk, h, dh), 0) + 1
    return pv, m, l


def _entry_point():
    fn = kernels.load("flash_chunk").flash_chunk_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
