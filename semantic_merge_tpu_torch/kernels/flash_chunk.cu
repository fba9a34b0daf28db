// Partial-softmax attention of q over one resident K/V chunk, for Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
// semantic_merge_tpu/parallel/flash.py, _chunk_kernel launched by
// flash_chunk_attention. Same contract: non-causal attention of q
// (B, Lq, H, Dh) over k/v (B, Lk, H, Dh) in bf16 under a key-padding mask
// kmask (B, Lk); masked scores are -1e30 (not -inf, so rows whose keys are
// all masked stay finite); scale Dh^-0.5 applied to the f32 QK^T; online
// row max / sum; f32 accumulation. Outputs the unnormalised pv
// (B, Lq, H, Dh) f32 and the row max m and row sum l, (B, H, Lq) f32.
// Keys at index >= Lk do not exist (they add nothing to l), as in the
// einsum path; no input or output is padded or transposed.
//
// What bounds it: at the matcher's shape (H=8, Dh=32, L=64) a row does
// 2*Lk*Dh multiply-adds against 2*Dh bf16 inputs and Dh f32 outputs, about
// 25 flops per byte moved: far below the card's balance point, so the
// bytes bound it (each input read once, each output written once).
//
// Design (first version: right and simple; no tensor cores, no TMA):
// - one CTA of 128 threads per (block of 32 query rows, head, batch row):
//   four lanes share a query row, each owning the dims d = lane + 4*i,
//   so the row's q and accumulator stay in registers (Dh/4 each) and
//   neighbouring lanes read neighbouring shared-memory words;
// - the K/V chunk streams through shared memory in tiles of 32 keys,
//   converted to f32 once on load; every row of the CTA reads the same
//   key at the same time, which shared memory broadcasts;
// - a score is the lanes' partial dot products summed with two xor
//   shuffles; each tile updates the online max/sum once (one rescale of
//   the accumulator per tile, as the Pallas kernel does per block);
// - ragged Lq and Lk are handled by bounds checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 4;
constexpr int kRows = 32;                        // query rows per CTA
constexpr int kThreads = kRows * kLanesPerRow;   // 128
constexpr int kTileK = 32;                       // keys per shared tile
constexpr float kNegInf = -1e30f;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const uint8_t* __restrict__ kmask,
                   float* __restrict__ pv, float* __restrict__ m_out,
                   float* __restrict__ l_out, int Lq, int Lk, int H,
                   float scale) {
  constexpr int kDimsPerLane = DH / kLanesPerRow;
  __shared__ float k_tile[kTileK][DH];
  __shared__ float v_tile[kTileK][DH];
  __shared__ float key_live[kTileK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const int qi = blockIdx.x * kRows + row;
  const bool active = qi < Lq;

  float qr[kDimsPerLane];
  float acc[kDimsPerLane];
  const size_t q_base = ((static_cast<size_t>(b) * Lq + qi) * H + h) * DH;
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    qr[i] = active ? __bfloat162float(q[q_base + lane + kLanesPerRow * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int nk = min(kTileK, Lk - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTileK * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = ((static_cast<size_t>(b) * Lk + k0 + j) * H + h) * DH + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    if (threadIdx.x < kTileK) {
      const int j = threadIdx.x;
      key_live[j] = (j < nk && kmask[static_cast<size_t>(b) * Lk + k0 + j]) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[kTileK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i)
        part = fmaf(qr[i], k_tile[j][lane + kLanesPerRow * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = key_live[j] != 0.f ? part * scale : kNegInf;
      if (j < nk) tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= corr;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        p_sum += p;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i)
          acc[i] = fmaf(p, v_tile[j][lane + kLanesPerRow * i], acc[i]);
      }
    }
    l = l * corr + p_sum;
    m = m_new;
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) pv[q_base + lane + kLanesPerRow * i] = acc[i];
  if (lane == 0) {
    const size_t stat = (static_cast<size_t>(b) * H + h) * Lq + qi;
    m_out[stat] = m;
    l_out[stat] = l;
  }
}

template <int DH>
void launch(const void* q, const void* k, const void* v, const void* kmask,
            void* pv, void* m, void* l, int B, int Lq, int Lk, int H,
            float scale, cudaStream_t stream) {
  const dim3 grid((Lq + kRows - 1) / kRows, H, B);
  flash_chunk_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kmask),
      static_cast<float*>(pv), static_cast<float*>(m), static_cast<float*>(l),
      Lq, Lk, H, scale);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are contiguous device
// buffers in the layouts above; kmask holds one byte per key (torch.bool).
// Returns the launch's cudaError_t (0 on success); an unsupported Dh or a
// grid too large for one launch returns cudaErrorInvalidValue.
extern "C" int flash_chunk_forward(const void* q, const void* k, const void* v,
                                   const void* kmask, void* pv, void* m, void* l,
                                   int B, int Lq, int Lk, int H, int Dh,
                                   float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || H <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: launch<32>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s); break;
    case 64: launch<64>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s); break;
    case 128: launch<128>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
