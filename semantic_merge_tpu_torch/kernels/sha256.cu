// Batched SHA-256 for Hopper (sm_90a): one thread hashes one row.
//
// Replaces the JAX package's semantic_merge_tpu/ops/sha256.py
// (sha256_device: _pad_and_pack, _compress_block), a jitted jax.numpy
// program that the fused merge calls once per side to mint every op's
// deterministic id (ops/fused.py::_op_id_words). The port's plain
// PyTorch version of the same function is
// semantic_merge_tpu_torch/ops/sha256.py::sha256_device_plain.
//
// In:  msg uint8 [n, n_blocks * 64] (row-major, 16-byte aligned rows),
//      len int32 [n], each at most n_blocks * 64 - 9.
// Out: out uint32 [n, n_words], the big-endian digest words.
// Padding (0x80, zeros, the 64-bit big-endian bit length) is applied
// here, per row, stopping at the row's own last block
// ceil((len + 9) / 64), so every row hashes as hashlib does; bytes past
// a row's length are ignored.
//
// What bounds it: 32-bit integer instructions on the ALU pipe. A 64-byte
// block is about 1,600 of them (funnel-shift rotates, three-input LOP3
// and IADD3; chip_smoke.py counts them in the built SASS) against 80
// bytes read and 16 written per row on the fused path, far above the
// card's ~5 ALU instructions per byte of memory bandwidth. So the design
// keeps everything in registers: the 8-word state and a 16-word ring of
// the message schedule with every index a compile-time constant (both
// loops fully unrolled), rotates as __funnelshift_r, the round constants
// as immediates; no shared memory, one 16-byte load per schedule
// quarter. Rows are independent, so 128 threads per block over
// ceil(n / 128) blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __constant__ uint32_t kRound[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Big-endian word from four little-endian-loaded bytes.
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Message word t of block `base` (a byte offset): the row's bytes below
// `len`, the 0x80 marker at byte `len`, zeros elsewhere. The bit length
// is written by the caller into the last block's words 14 and 15.
__device__ __forceinline__ uint32_t padded_word(uint32_t raw, int base, int t, int len) {
  const int p0 = base + 4 * t;
  const int valid = len - p0;  // message bytes of this word, if in [0, 4)
  uint32_t w = raw;
  if (valid < 4) {
    w = valid <= 0 ? 0u : (w & ~(0xffffffffu >> (8 * valid)));
    if (valid >= 0) w |= 0x80u << (8 * (3 - valid));
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
sha256_rows_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ lens,
                   uint32_t* __restrict__ out, int n, int n_blocks, int n_words) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int len = lens[row];
  const int total_blocks = (len + 9 + 63) / 64;  // the row's own padded length
  const int stop = total_blocks < n_blocks ? total_blocks : n_blocks;
  const uint4* src = reinterpret_cast<const uint4*>(msg + static_cast<size_t>(row) * n_blocks * 64);
  const uint64_t bitlen = static_cast<uint64_t>(len) * 8u;

  uint32_t h0 = 0x6a09e667u, h1 = 0xbb67ae85u, h2 = 0x3c6ef372u, h3 = 0xa54ff53au;
  uint32_t h4 = 0x510e527fu, h5 = 0x9b05688cu, h6 = 0x1f83d9abu, h7 = 0x5be0cd19u;

  for (int blk = 0; blk < stop; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(src + blk * 4 + q);
      w[4 * q + 0] = padded_word(bswap(v.x), blk * 64, 4 * q + 0, len);
      w[4 * q + 1] = padded_word(bswap(v.y), blk * 64, 4 * q + 1, len);
      w[4 * q + 2] = padded_word(bswap(v.z), blk * 64, 4 * q + 2, len);
      w[4 * q + 3] = padded_word(bswap(v.w), blk * 64, 4 * q + 3, len);
    }
    if (blk == total_blocks - 1) {
      w[14] = static_cast<uint32_t>(bitlen >> 32);
      w[15] = static_cast<uint32_t>(bitlen);
    }
    uint32_t a = h0, b = h1, c = h2, d = h3, e = h4, f = h5, g = h6, h = h7;
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        const uint32_t x = w[(t - 15) & 15], y = w[(t - 2) & 15];
        const uint32_t s0 = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
        const uint32_t s1 = rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10);
        wt = w[t & 15] = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      }
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = h + S1 + ch + kRound[t] + wt;
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + S0 + maj;
    }
    h0 += a; h1 += b; h2 += c; h3 += d; h4 += e; h5 += f; h6 += g; h7 += h;
  }

  const uint32_t state[8] = {h0, h1, h2, h3, h4, h5, h6, h7};
  uint32_t* dst = out + static_cast<size_t>(row) * n_words;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < n_words) dst[i] = state[i];
}

}  // namespace

// Plain C entry point (bound with ctypes): hashes n rows on `stream`.
// Returns the launch's cudaError_t (0 on success). n must be positive:
// the wrapper makes no launch for 0 rows.
extern "C" int sha256_rows(const void* msg, const void* lens, void* out,
                           int n, int n_blocks, int n_words, void* stream) {
  if (n <= 0 || n_blocks <= 0 || n_words < 1 || n_words > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(msg) & 15) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kThreads - 1) / kThreads;
  sha256_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(msg), static_cast<const int32_t*>(lens),
      static_cast<uint32_t*>(out), n, n_blocks, n_words);
  return static_cast<int>(cudaGetLastError());
}
