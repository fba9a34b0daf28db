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
// Keys at index >= Lk do not exist: they get p = 0 and stay out of the row
// max (as in the einsum path), so an all-masked row has l = Lk exactly.
// No input or output is padded or transposed.
//
// What bounds it: bytes. At the matcher's shape (B=256, L=64, H=8, Dh=32)
// a launch must read q, k, v (25.2 MB bf16) and the mask and write pv
// (16.8 MB f32) and m, l (1.0 MB): 43 MB, 12.8 us at 3.35 TB/s. Its 1.07
// GFLOP take 1.1 us at the bf16 tensor-core peak.
//
// What the first version (scalar f32 FMAs) lost its time on, and what this
// design does about each:
// - One shared-memory load per multiply-add: four lanes shared a query row
//   and read k/v at a stride of 4 floats, 1,024 LDS per thread per launch,
//   16.8 M warp-wide loads at B=256 (~65-70 us of its 124 us), plus two
//   shuffles per key. Here S = Q K^T and P V run on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate) with fragments from
//   ldmatrix: about 18 ldmatrix.x4 per warp per (b, h) at that shape.
//   Row max and sum are reduced across a quad once per 32 keys, not per
//   key; stepping 32 keys at a time (two steps per 64-key tile) halves the
//   score registers, so Dh=32 fits in 96 registers with no spill and 5 CTAs
//   (20 warps) share an SM while their loads are in flight.
// - K/V read twice per (b, h), by two CTAs of 32 query rows: here one CTA of
//   4 warps owns 64 query rows (16 per warp), so at L=64 each (b, h) is one
//   CTA and reads K/V once. The grid is ordered h fastest, so neighbouring
//   CTAs read neighbouring 64-byte pieces of the same 512-byte token rows.
// - 2-byte global loads: Q, K and V tiles come in as 16-byte cp.async copies
//   (zero-filled past Lq / Lk), double-buffered when Lk > 64 so the next
//   tile's copy overlaps this tile's math. Rows are XOR-swizzled in shared
//   memory so that ldmatrix reads are free of bank conflicts.
// - p keeps ~16 bits: the reference keeps p in f32 and bf16 rounding of p
//   (2^-9) can exceed the 2e-3 tolerance at |v| of a few units, so P V is
//   two MMAs into one f32 accumulator, p = p_hi + p_lo, both bf16 with
//   p_lo = bf16(p - p_hi). l is summed from the f32 p.
// - pv is stored as float2 from the accumulator fragments (each quad writes
//   32 contiguous bytes of a row); m and l once per row from one lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per CTA, 16 per warp
constexpr int kTileK = 64;     // keys per K/V tile
constexpr int kSubK = 32;      // keys per online-softmax step
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `row` in a tile of C chunks per
// row. The chunk index is XORed with bits of the row so that the 8 rows an
// ldmatrix phase reads (8-aligned) fall on 8 distinct 16-byte bank groups.
// The XOR sees only row % 8 (C >= 8) or row % 8 / 2 (C = 4), so moving
// by 16 rows adds 16 * C * 16 bytes: a lane's offset for rows r + 16 i is
// its offset for row r plus a constant.
template <int C>
__device__ __forceinline__ uint32_t chunk_offset(int row, int c) {
  const int x = (C == 4) ? ((row >> 1) & 3) : (row & 7);
  return static_cast<uint32_t>((row * C + (c ^ x)) * 16);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool live) {
  const int n = live ? 16 : 0;  // 0: read nothing, fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as bf16x2 (x in the low half), rounded to nearest; `lo` gets the
// bf16 of what the rounding left out.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// This CTA's (head, query block, batch row): h fastest. Read from the
// special register each time it is asked for, so that the epilogue's
// copy is not kept live across the key loop.
struct Work {
  int h, qb, b;
};

__device__ __forceinline__ Work work_of_block(int H, int n_qblocks) {
  int blk;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(blk));
  const int h = blk % H;
  blk /= H;
  return {h, blk % n_qblocks, blk / n_qblocks};
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + t. The f32
// accumulator holds rows g (regs 0, 1) and g + 8 (regs 2, 3) at columns
// 2t, 2t + 1 of its 8-column tile; an A fragment holds rows g, g + 8 at
// columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9 (regs 2, 3). So two
// neighbouring S tiles of 8 keys are, as bf16, the A fragment of P over
// those 16 keys.
//
// Registers decide how many CTAs share an SM while they wait on memory:
// at Dh=32 the cap of 96 lets 5 CTAs (20 warps) in, against 4 at 128.
// (Dh=64 and 128 are off the matcher's path and take what they need.)
template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 5 : 1)
flash_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const uint8_t* __restrict__ kmask,
                   float* __restrict__ pv, float* __restrict__ m_out,
                   float* __restrict__ l_out, int Lq, int Lk, int H, int n_qblocks,
                   float scale) {
  constexpr int C = DH / 8;                    // 16-byte chunks per row
  constexpr int kTileBytes = kRows * C * 16;   // one Q, K or V tile
  constexpr int kKB = DH / 16;                 // k-steps of Q K^T; dim pairs of P V
  constexpr int kNT = kSubK / 8;               // 8-key tiles of S
  constexpr int kDT = DH / 8;                  // 8-dim tiles of pv

  // Q | K[stages] | V[stages] | mask bits [stages][2]
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (Lk + kTileK - 1) / kTileK;
  const int stages = n_tiles > 1 ? 2 : 1;
  const uint32_t q_s = smem_addr(smem);
  const uint32_t k_s = q_s + kTileBytes;
  const uint32_t v_s = k_s + stages * kTileBytes;
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + (1 + 2 * stages) * kTileBytes);

  const Work w = work_of_block(H, n_qblocks);
  const int h = w.h;
  const int b = w.b;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = w.qb * kRows;
  const size_t stride = static_cast<size_t>(H) * DH;  // elements between tokens
  const __nv_bfloat16* q_bh = q + (static_cast<size_t>(b) * Lq * H + h) * DH;
  const __nv_bfloat16* k_bh = k + (static_cast<size_t>(b) * Lk * H + h) * DH;
  const __nv_bfloat16* v_bh = v + (static_cast<size_t>(b) * Lk * H + h) * DH;
  const uint8_t* mask_b = kmask + static_cast<size_t>(b) * Lk;

  // Rows first .. first + count - 1 of a (b, h) slice into a swizzled tile;
  // rows past count are zero-filled (their source is row `first`, unread).
  auto load_tile = [&](uint32_t dst, const __nv_bfloat16* src, int first, int count) {
#pragma unroll
    for (int r = 0; r < kRows * C / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int row = i / C;
      const int c = i % C;
      const bool live = row < count;
      cp_async_16(dst + chunk_offset<C>(row, c),
                  src + static_cast<size_t>(first + (live ? row : 0)) * stride + c * 8, live);
    }
  };
  // Warps 0 and 1 turn the tile's 64 mask bytes into two words of bits.
  auto store_mask_bits = [&](int stage, int byte) {
    if (warp < 2) {
      const uint32_t bits = __ballot_sync(0xffffffffu, byte != 0);
      if (lane == 0) mask_s[2 * stage + warp] = bits;
    }
  };

  load_tile(q_s, q_bh, q0, min(kRows, Lq - q0));
  if (n_tiles > 0) {
    load_tile(k_s, k_bh, 0, min(kTileK, Lk));
    load_tile(v_s, v_bh, 0, min(kTileK, Lk));
  }
  cp_async_commit();
  if (n_tiles > 0) store_mask_bits(0, tid < Lk && tid < kTileK ? mask_b[tid] : 0);

  const bool warp_live = q0 + warp * 16 < Lq;  // warp-uniform
  constexpr uint32_t k16Rows = 16 * C * 16;   // bytes of 16 tile rows
  // This lane's ldmatrix offsets in the first 16 rows of a K / V tile.
  uint32_t k_off[kKB], v_off[kKB];
#pragma unroll
  for (int kb = 0; kb < kKB; ++kb) {
    k_off[kb] = chunk_offset<C>((lane & 7) + (lane >> 4) * 8, 2 * kb + ((lane >> 3) & 1));
    v_off[kb] = chunk_offset<C>((lane & 7) + ((lane >> 3) & 1) * 8, 2 * kb + (lane >> 4));
  }
  uint32_t qa[kKB][4];
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {kMasked, kMasked};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & (stages - 1);
    const bool more = t + 1 < n_tiles;
    int next_byte = 0;  // held in a register until this tile's math is done
    if (more) {
      const int k0 = (t + 1) * kTileK;
      const int count = min(kTileK, Lk - k0);
      load_tile(k_s + (stage ^ 1) * kTileBytes, k_bh, k0, count);
      load_tile(v_s + (stage ^ 1) * kTileBytes, v_bh, k0, count);
      cp_async_commit();
      if (tid < count) next_byte = mask_b[k0 + tid];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      if (t == 0) {
#pragma unroll
        for (int kb = 0; kb < kKB; ++kb)
          ldmatrix_x4(q_s + chunk_offset<C>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                            2 * kb + (lane >> 4)),
                      qa[kb]);
      }
      const uint32_t ks = k_s + stage * kTileBytes;
      const uint32_t vs = v_s + stage * kTileBytes;
      const int nk = min(kTileK, Lk - t * kTileK);

      // The tile's keys in two halves of 32, each with its own online
      // max / sum step: half the score registers of one 64-key step.
#pragma unroll
      for (int half = 0; half < kTileK / kSubK; ++half) {
        if (half * kSubK >= nk) break;  // warp-uniform: no key left
        const uint32_t rows16 = half * (kSubK / 16) * k16Rows;

        // S = Q K^T: K as stored is the col-major B operand.
        float s[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(ks + rows16 + k_off[kb] + np * k16Rows, bk);
            mma_bf16(s[2 * np], qa[kb], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa[kb], bk[2], bk[3]);
          }
        }

        // Scale, mask, online max / sum on the f32 accumulator.
        const uint32_t bits = mask_s[2 * stage + half];
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t4 + (e & 1);
            float x = ((bits >> key) & 1u) ? s[j][e] * scale : kMasked;
            if (half * kSubK + key >= nk) x = -INFINITY;  // no such key
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);
          corr[r] = expf(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= corr[r];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - m_r[e >> 1]);
            l_r[e >> 1] += s[j][e];
          }
        }
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }

        // pv += P V over 16 keys at a time: V through ldmatrix.trans is
        // the col-major B operand; P as hi + lo bf16 A fragments.
#pragma unroll
        for (int kb = 0; kb < kNT / 2; ++kb) {
          uint32_t ph[4], pl[4];
          split_bf16x2(s[2 * kb][0], s[2 * kb][1], ph[0], pl[0]);
          split_bf16x2(s[2 * kb][2], s[2 * kb][3], ph[1], pl[1]);
          split_bf16x2(s[2 * kb + 1][0], s[2 * kb + 1][1], ph[2], pl[2]);
          split_bf16x2(s[2 * kb + 1][2], s[2 * kb + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int dp = 0; dp < kKB; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(vs + rows16 + v_off[dp] + kb * k16Rows, bv);
            mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
            mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
            mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }

    if (more) store_mask_bits(stage ^ 1, next_byte);
    __syncthreads();  // this stage is free for the copy started next round
  }
  cp_async_wait<0>();  // Lk = 0 started copies that nothing waited for

  if (!warp_live) return;
  const Work e = work_of_block(H, n_qblocks);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = e.qb * kRows + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    float* out = pv + (static_cast<size_t>(e.b) * Lq + row) * stride + e.h * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (t4 == 0) {
      const size_t stat = (static_cast<size_t>(e.b) * H + e.h) * Lq + row;
      m_out[stat] = m_r[r];
      l_out[stat] = l_r[r];
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kmask, void* pv,
           void* m, void* l, int B, int Lq, int Lk, int H, float scale,
           cudaStream_t stream) {
  constexpr int kTileBytes = kRows * DH * 2;
  const int n_tiles = (Lk + kTileK - 1) / kTileK;
  const int stages = n_tiles > 1 ? 2 : 1;
  const int smem = (1 + 2 * stages) * kTileBytes + 8 * stages;
  if (smem > 48 * 1024) {  // Dh=128 only: opt in to its two-stage size
    const cudaError_t err = cudaFuncSetAttribute(
        flash_chunk_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, 5 * kTileBytes + 16);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qblocks = (Lq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(B) * n_qblocks * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_chunk_kernel<DH><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kmask),
      static_cast<float*>(pv), static_cast<float*>(m), static_cast<float*>(l), Lq, Lk, H,
      n_qblocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are contiguous device
// buffers in the layouts above; kmask holds one byte per key (torch.bool).
// q, k and v must be 16-byte aligned (the copies are 16 bytes), pv 8-byte
// aligned. Returns the launch's cudaError_t (0 on success); an unsupported
// Dh, a bad size or alignment, or a grid too large for one launch returns
// cudaErrorInvalidValue.
extern "C" int flash_chunk_forward(const void* q, const void* k, const void* v,
                                   const void* kmask, void* pv, void* m, void* l,
                                   int B, int Lq, int Lk, int H, int Dh,
                                   float scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk < 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t misaligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                 reinterpret_cast<uintptr_t>(v)) & 15) |
                               (reinterpret_cast<uintptr_t>(pv) & 7);
  if (misaligned) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return launch<32>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s);
    case 64: return launch<64>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s);
    case 128: return launch<128>(q, k, v, kmask, pv, m, l, B, Lq, Lk, H, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
