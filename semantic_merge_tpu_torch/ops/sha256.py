"""Batched SHA-256 on the device: a CUDA kernel on the card.

The port of the JAX package's ``ops/sha256.py``. The merge engine's
deterministic op identity is SHA-256 over a fixed 51-byte payload
(:func:`semantic_merge_tpu_torch.core.ids.deterministic_op_id`), and the
composition sort ranks those ids, so the fused merge
(:mod:`semantic_merge_tpu_torch.ops.fused`) hashes every op on the
device between the diff join and the compose.

:func:`sha256_device` takes fixed-capacity rows (``B`` 64-byte blocks)
with a byte length per row, applies the standard SHA padding, and
returns the leading digest words. On a CUDA tensor it launches the
hand-written kernel ``kernels/sha256.cu`` (one thread per row, the
state and the message schedule in registers); on a CPU tensor it runs
:func:`sha256_device_plain`, the same function in plain PyTorch, which
the tests and the on-card comparison use. There is no fallback from the
kernel to the plain version.

torch on the CPU has no usable uint32 add or shift, so the plain
version works in int64 and masks with ``& 0xFFFFFFFF`` after every add
and rotate. Digest words come back as int32 holding the uint32 bits
(words of 2**31 and above are negative), the way the JAX engine's
packed fetch bitcasts them.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

#: Round constants (FIPS 180-4).
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _pad_and_pack(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """SHA padding and big-endian packing: uint8 ``[n, B*64]`` messages
    (bytes past the row's length are ignored) and int32 ``[n]`` lengths
    → int64 ``[n, B*16]`` words in ``[0, 2**32)``.

    Each row is padded to its *own* last block — 0x80 after the
    message, the 64-bit big-endian bit length in the last 8 bytes of
    block ``ceil((len + 9) / 64)`` — not to the buffer's capacity."""
    n, cap = msg.shape
    pos = torch.arange(cap, device=msg.device)[None, :]
    length = msg_len.long()[:, None]
    endpos = (length + 9 + 63) // 64 * 64
    b = torch.where(pos < length, msg.long(), 0)
    b = torch.where(pos == length, 0x80, b)
    shift = (8 * (endpos - 1 - pos)).clamp(0, 63)
    in_zone = (pos >= endpos - 8) & (pos < endpos)
    b = b | torch.where(in_zone, ((length * 8) >> shift) & 0xFF, 0)
    w = b.view(n, cap // 4, 4)
    return (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]


def _compress_block(state, block):
    """One compression of a ``[n, 16]`` block into the 8-word state."""
    w = [block[:, t] for t in range(16)]
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & _M32)
        t1 = (h + s1 + ch + _K[t] + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & _M32, a, b, c,
                                  (d + t1) & _M32, e, f, g)
    return [(s + o) & _M32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` → int32 holding the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def sha256_device_plain(msg: torch.Tensor, msg_len: torch.Tensor,
                        n_words: int = 8) -> torch.Tensor:
    """Batched SHA-256 in plain PyTorch: uint8 ``[n, B*64]`` and int32
    ``[n]`` lengths (each at most ``B*64 - 9``) → int32 ``[n, n_words]``
    big-endian digest words (uint32 bits). A row stops at its own last
    block, so every row hashes as :mod:`hashlib` would."""
    n, cap = msg.shape
    if cap % 64:
        raise ValueError("message capacity must be whole SHA blocks")
    words = _pad_and_pack(msg, msg_len)
    n_blocks = (msg_len.long() + 9 + 63) // 64
    state = [torch.full((n,), h, dtype=torch.long, device=msg.device) for h in _H0]
    for blk in range(cap // 64):
        nxt = _compress_block(state, words[:, blk * 16:(blk + 1) * 16])
        keep = blk < n_blocks  # rows already finished stay frozen
        state = [torch.where(keep, nw, old) for nw, old in zip(nxt, state)]
    return as_int32_bits(torch.stack(state[:n_words], dim=1))


def sha256_device(msg: torch.Tensor, msg_len: torch.Tensor,
                  n_words: int = 8) -> torch.Tensor:
    """Batched SHA-256; same arguments and result as
    :func:`sha256_device_plain`. A CUDA call takes a contiguous,
    16-byte-aligned uint8 message matrix and contiguous int32 lengths on
    the same card, launches ``kernels/sha256.cu`` once (none for 0 rows)
    and raises on anything else."""
    if msg.device.type == "cpu":
        return sha256_device_plain(msg, msg_len, n_words)
    if msg.device.type != "cuda":
        raise ValueError(f"sha256_device: unsupported device {msg.device}")
    if msg.dim() != 2 or msg.shape[1] % 64 or msg.shape[1] == 0:
        raise ValueError(f"sha256_device: messages must be [n, B*64], got {tuple(msg.shape)}")
    n, cap = msg.shape
    if not 1 <= n_words <= 8:
        raise ValueError(f"sha256_device: n_words={n_words} not in 1..8")
    if msg.dtype != torch.uint8 or not msg.is_contiguous() or msg.data_ptr() % 16:
        raise ValueError("sha256_device: msg must be a contiguous, 16-byte aligned "
                         "uint8 tensor")
    if (msg_len.dtype != torch.int32 or not msg_len.is_contiguous()
            or msg_len.shape != (n,) or msg_len.device != msg.device):
        raise ValueError(f"sha256_device: msg_len must be a contiguous int32 [{n}] "
                         f"tensor on {msg.device}")
    out = torch.empty((n, n_words), dtype=torch.int32, device=msg.device)
    if n == 0:
        return out
    fn = _entry_point()
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream(msg.device).cuda_stream
        err = fn(msg.data_ptr(), msg_len.data_ptr(), out.data_ptr(),
                 n, cap // 64, n_words, stream)
    if err != 0:
        raise RuntimeError(f"sha256 kernel launch failed: cudaError {err}")
    kernels.LAUNCHES["sha256"] += 1
    shapes = kernels.LAUNCH_SHAPES["sha256"]
    shapes[(n, cap // 64, n_words)] = shapes.get((n, cap // 64, n_words), 0) + 1
    return out


def _entry_point():
    fn = kernels.load("sha256").sha256_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
