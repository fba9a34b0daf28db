// Backward of the flash-chunk attention, for Hopper.
//
// The JAX package has no kernel for this: its gradient is autodiff of the
// einsum path (semantic_merge_tpu/parallel/ring.py, _chunk_stats_einsum
// plus the normalisation o = pv / max(l, 1e-30)), the backward of the
// Pallas kernel _chunk_kernel (semantic_merge_tpu/parallel/flash.py:45).
// This kernel computes exactly that gradient, for the one-device ring
// step of semantic_merge_tpu_torch/parallel/ring.py:
//
//   P  = exp(S - m) / l     S = scale * Q K^T, -1e30 at masked keys
//   D  = rowsum(dO * O)     O the f32 output (pv / l) of the forward
//   dV = P^T dO
//   dS = P * (dO V^T - D),  0 at masked keys (where() passes no gradient)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// with m and l the forward's saved row max and row sum, q, k, v, dO bf16
// (B, L, H, Dh), kmask (B, Lk) bool, O f32 (B, Lq, H, Dh), m and l f32
// (B, H, Lq); dq, dk, dv are written in bf16 in q's layout.
//
// P is recomputed from the saved m and l, not from a logsumexp: a row
// whose keys are all masked has m = -1e30 and l = Lk, and in f32
// m + log(l) rounds to m, so exp(S - lse) would give 1 where the
// reference has 1 / Lk. Such rows still send dV += P^T dO (the reference
// does too) and no gradient to q or k, since every key of theirs is
// masked. Keys at index >= Lk do not exist (P = 0, no dk / dv row), as in
// the forward; P is kept in f32 throughout (the forward's hi / lo bf16
// split is a forward trick only).
//
// What bounds it: bytes. At the training shape (B=32, L=64, H=8, Dh=32) a
// launch must read q, k, v, dO (4.2 MB bf16), O (2.1 MB f32), m, l and the
// mask and write dq, dk, dv (3.1 MB bf16): 9.5 MB, 2.8 us at 3.35 TB/s;
// its five products are 0.34 GFLOP, 0.34 us at the bf16 tensor-core peak.
//
// Design, simple and correct first (making it fast is later work): one CTA
// of 256 threads per (b, h). It walks the keys in tiles of 64 and, inside,
// the queries in tiles of 64. A tile of K, V, Q and dO sits in shared
// memory as bf16 (rows padded to an odd number of 32-bit words, so that 16
// threads reading one word of 16 different rows hit 16 banks); P and dS
// of the 64 x 64 tile sit beside them in f32. Every product is a scalar f32
// FMA: each thread owns a 4 x 4 block of S and dO V^T (rows ty + 16a, keys
// tx + 16b) and, for the three gradient products, 4 rows by Dh / 16
// columns taken as bf16 pairs (columns 2 tx + 32 c, + 1). dK and dV of
// the key tile accumulate in registers across the query tiles. With one
// key tile (Lk <= 64, the matcher's shapes) dQ is complete after its only
// tile and is written in bf16 at once; with more, the CTA adds each key
// tile's share into an f32 scratch row that only it touches (each thread
// reads back only what it wrote: no atomics, no order across CTAs), and
// converts it to bf16 at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // queries and keys per tile
constexpr int kPad = kTile + 1;  // f32 row stride of the P and dS tiles
constexpr float kMasked = -1e30f;

template <int DH>
struct Smem {
  static constexpr int kRow = DH + 2;  // bf16 row stride: DH / 2 + 1 words, odd
  static constexpr int kTileHalves = kTile * kRow;
  // K | V | Q | dO (bf16), then P | dS (f32), then m, l, D, key state (f32).
  static constexpr int kBytes =
      4 * kTileHalves * 2 + 2 * kTile * kPad * 4 + 4 * kTile * 4;
};

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows first .. first + 63 of one (b, h) slice (row stride `stride`
// elements) into a padded bf16 tile, zero past `count` rows.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int first, int count) {
  constexpr int kWords = DH / 2;
  for (int i = threadIdx.x; i < kTile * kWords; i += kThreads) {
    const int row = i / kWords;
    const int w = i % kWords;
    uint32_t bits = 0;
    if (row < count)
      bits = *reinterpret_cast<const uint32_t*>(src + (first + row) * stride + 2 * w);
    *reinterpret_cast<uint32_t*>(dst + row * Smem<DH>::kRow + 2 * w) = bits;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_chunk_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const uint8_t* __restrict__ kmask,
                       const float* __restrict__ m_in, const float* __restrict__ l_in,
                       const float* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc,
                       int Lq, int Lk, int H, float scale) {
  constexpr int R = Smem<DH>::kRow;
  constexpr int kCols = DH / 32;  // column pairs per thread: 2 tx + 32 c
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + Smem<DH>::kTileHalves;
  __nv_bfloat16* q_s = v_s + Smem<DH>::kTileHalves;
  __nv_bfloat16* do_s = q_s + Smem<DH>::kTileHalves;
  float* p_s = reinterpret_cast<float*>(do_s + Smem<DH>::kTileHalves);
  float* ds_s = p_s + kTile * kPad;
  float* m_s = ds_s + kTile * kPad;
  float* l_s = m_s + kTile;
  float* d_s = l_s + kTile;
  float* key_s = d_s + kTile;  // 1 live, 0 masked, -1 no such key

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15
  const int tx = tid & 15;  // 0..15
  const size_t stride = static_cast<size_t>(H) * DH;
  const size_t q_base = (static_cast<size_t>(b) * Lq * H + h) * DH;
  const size_t k_base = (static_cast<size_t>(b) * Lk * H + h) * DH;
  const size_t stat_base = (static_cast<size_t>(b) * H + h) * Lq;
  const int n_qt = (Lq + kTile - 1) / kTile;
  const int n_kt = (Lk + kTile - 1) / kTile;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    const int nk = min(kTile, Lk - k0);
    load_tile<DH>(k_s, k + k_base, stride, k0, nk);
    load_tile<DH>(v_s, v + k_base, stride, k0, nk);
    if (tid < kTile)
      key_s[tid] = tid < nk ? (kmask[static_cast<size_t>(b) * Lk + k0 + tid] ? 1.f : 0.f) : -1.f;

    float dk_acc[4][kCols][2], dv_acc[4][kCols][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dk_acc[a][c][0] = dk_acc[a][c][1] = dv_acc[a][c][0] = dv_acc[a][c][1] = 0.f;

    for (int i = 0; i < n_qt; ++i) {
      const int q0 = i * kTile;
      const int nq = min(kTile, Lq - q0);
      __syncthreads();  // the last tile's readers are done with q_s, do_s, p_s, ds_s
      load_tile<DH>(q_s, q + q_base, stride, q0, nq);
      load_tile<DH>(do_s, dout + q_base, stride, q0, nq);
      if (tid < kTile) {
        const bool live = tid < nq;
        m_s[tid] = live ? m_in[stat_base + q0 + tid] : 0.f;
        l_s[tid] = live ? fmaxf(l_in[stat_base + q0 + tid], 1e-30f) : 1.f;
      }
      __syncthreads();

      // D = rowsum(dO * O): four threads per row, a quarter of Dh each.
      {
        const int row = tid >> 2;
        const int part = tid & 3;
        float sum = 0.f;
        if (row < nq) {
          const float* o_row = o + q_base + (q0 + row) * stride;
#pragma unroll
          for (int d = part * (DH / 4); d < (part + 1) * (DH / 4); ++d)
            sum += __bfloat162float(do_s[row * R + d]) * o_row[d];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) d_s[row] = sum;
      }

      // S = Q K^T and dP = dO V^T for rows ty + 16a, keys tx + 16b.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 2) {
        float2 qa[4], oa[4], kb[4], vb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qa[a] = load_pair(q_s + (ty + 16 * a) * R + d);
          oa[a] = load_pair(do_s + (ty + 16 * a) * R + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kb[c] = load_pair(k_s + (tx + 16 * c) * R + d);
          vb[c] = load_pair(v_s + (tx + 16 * c) * R + d);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(qa[a].x, kb[c].x, s[a][c]);
            s[a][c] = fmaf(qa[a].y, kb[c].y, s[a][c]);
            dp[a][c] = fmaf(oa[a].x, vb[c].x, dp[a][c]);
            dp[a][c] = fmaf(oa[a].y, vb[c].y, dp[a][c]);
          }
      }
      __syncthreads();  // d_s is written

      // P and dS of the tile, 0 for padding rows and missing keys; dS also
      // 0 at masked keys.
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = ty + 16 * a;
        const bool row_live = row < nq;
        const float m = m_s[row], l = l_s[row], dsum = d_s[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tx + 16 * c;
          const float state = key_s[key];
          float p = 0.f, ds = 0.f;
          if (row_live && state >= 0.f) {
            const float x = state > 0.f ? s[a][c] * scale : kMasked;
            p = expf(x - m) / l;
            if (state > 0.f) ds = p * (dp[a][c] - dsum);
          }
          p_s[row * kPad + key] = p;
          ds_s[row * kPad + key] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for keys ty + 16a; dQ = dS K for
      // rows ty + 16a; columns 2 tx + 32 c and the one after.
      float dq_t[4][kCols][2];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq_t[a][c][0] = dq_t[a][c][1] = 0.f;
      for (int r = 0; r < nq; ++r) {
        float2 dor[kCols], qr[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dor[c] = load_pair(do_s + r * R + 2 * tx + 32 * c);
          qr[c] = load_pair(q_s + r * R + 2 * tx + 32 * c);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = p_s[r * kPad + ty + 16 * a];
          const float ds = ds_s[r * kPad + ty + 16 * a];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[a][c][0] = fmaf(p, dor[c].x, dv_acc[a][c][0]);
            dv_acc[a][c][1] = fmaf(p, dor[c].y, dv_acc[a][c][1]);
            dk_acc[a][c][0] = fmaf(ds, qr[c].x, dk_acc[a][c][0]);
            dk_acc[a][c][1] = fmaf(ds, qr[c].y, dk_acc[a][c][1]);
          }
        }
      }
      for (int key = 0; key < nk; ++key) {
        float2 kr[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kr[c] = load_pair(k_s + key * R + 2 * tx + 32 * c);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ds = ds_s[(ty + 16 * a) * kPad + key];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dq_t[a][c][0] = fmaf(ds, kr[c].x, dq_t[a][c][0]);
            dq_t[a][c][1] = fmaf(ds, kr[c].y, dq_t[a][c][1]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = ty + 16 * a;
        if (row >= nq) continue;
        const size_t at = q_base + (q0 + row) * stride;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = 2 * tx + 32 * c;
          float x = dq_t[a][c][0] * scale, y = dq_t[a][c][1] * scale;
          if (n_kt == 1) {
            *reinterpret_cast<__nv_bfloat162*>(dq + at + col) = __floats2bfloat162_rn(x, y);
          } else {
            float2* acc = reinterpret_cast<float2*>(dq_acc + at + col);
            if (j > 0) {
              const float2 prev = *acc;
              x += prev.x;
              y += prev.y;
            }
            *acc = make_float2(x, y);
          }
        }
      }
    }

    // This key tile's dK and dV.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = ty + 16 * a;
      if (key >= nk) continue;
      const size_t at = k_base + (k0 + key) * stride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = 2 * tx + 32 * c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(dk_acc[a][c][0] * scale, dk_acc[a][c][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dv_acc[a][c][0], dv_acc[a][c][1]);
      }
    }
    __syncthreads();  // k_s, v_s and key_s are reloaded next
  }

  // Several key tiles: dQ from the f32 rows this thread wrote. With no
  // key at all, dQ is 0.
  if (n_kt == 1) return;
  for (int i = 0; i < n_qt; ++i) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i * kTile + ty + 16 * a;
      if (row >= Lq) continue;
      const size_t at = q_base + row * stride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = 2 * tx + 32 * c;
        const float2 x = n_kt ? *reinterpret_cast<const float2*>(dq_acc + at + col)
                              : make_float2(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dq + at + col) = __floats2bfloat162_rn(x.x, x.y);
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kmask, const void* m,
           const void* l, const void* o, const void* dout, void* dq, void* dk, void* dv,
           void* dq_acc, int B, int Lq, int Lk, int H, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<DH>::kBytes;
  // Above 48 KB only by opting in, once per device (so that a launch
  // captured into a CUDA graph makes no such call).
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(flash_chunk_bwd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const long long blocks = static_cast<long long>(B) * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_chunk_bwd_kernel<DH><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kmask),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dq_acc), Lq, Lk, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are contiguous device
// buffers in the layouts above; kmask holds one byte per key (torch.bool).
// Every pointer must be 16-byte aligned. dq_acc is an f32 (B, Lq, H, Dh)
// scratch buffer, needed only when Lk > 64 (NULL otherwise). Returns the
// launch's cudaError_t (0 on success); an unsupported Dh, a bad size or
// alignment, a missing scratch buffer or a grid too large for one launch
// returns cudaErrorInvalidValue.
extern "C" int flash_chunk_backward(const void* q, const void* k, const void* v,
                                    const void* kmask, const void* m, const void* l,
                                    const void* o, const void* dout, void* dq, void* dk,
                                    void* dv, void* dq_acc, int B, int Lq, int Lk, int H,
                                    int Dh, float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk < 0 || H <= 0 || (Lk > kTile && dq_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                        reinterpret_cast<uintptr_t>(dq_acc);
  if (any & 15) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return launch<32>(q, k, v, kmask, m, l, o, dout, dq, dk, dv, dq_acc, B, Lq, Lk, H, scale, s);
    case 64: return launch<64>(q, k, v, kmask, m, l, o, dout, dq, dk, dv, dq_acc, B, Lq, Lk, H, scale, s);
    case 128: return launch<128>(q, k, v, kmask, m, l, o, dout, dq, dk, dv, dq_acc, B, Lq, Lk, H, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
