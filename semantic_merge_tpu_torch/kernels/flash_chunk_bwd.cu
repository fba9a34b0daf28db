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
// the forward.
//
// What bounds it: bytes. At the training shape (B=32, L=64, H=8, Dh=32) a
// launch must read q, k, v, dO (4.2 MB bf16), O (2.1 MB f32), m, l and the
// mask and write dq, dk, dv (3.1 MB bf16): 9.57 MB, 2.86 us at 3.35 TB/s;
// its five products are 0.34 GFLOP, 0.34 us at the bf16 tensor-core peak.
// So mma.sync is enough, as in the forward (flash_chunk.cu).
//
// The first version ran every product as scalar f32 FMAs fed by two or
// three shared-memory loads each, loaded tiles 4 bytes at a time and kept
// P and dS in f32 shared memory: 0.13-0.14 of its bound on an H100. This
// design, in the order of the FlashAttention-2 backward:
// - One CTA of 4 warps per (b, h), h fastest in the grid, walks the keys
//   in tiles of 64 and, inside, the queries in tiles of 64. Each warp owns
//   16 keys of the key tile. It computes S^T = K Q^T and dP^T = V dO^T for
//   its keys against 16 queries at a time on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate; fragments from ldmatrix),
//   forms P^T and dS^T in registers, and accumulates dV += P^T dO and
//   dK += dS^T Q in its own accumulator fragments: two neighbouring
//   8-query accumulator tiles are, as bf16, the A fragment of the next
//   product, and dO and Q come in as B fragments through ldmatrix.trans.
//   So P never touches shared memory, and dK and dV need no sum across
//   warps. At Dh=128 the query tiles are walked twice, for 64 dims of dK
//   and dV each: 128 accumulator registers per thread would spill.
// - dQ sums over all 64 keys, so across the 4 warps: each warp writes its
//   dS^T into an XOR-swizzled bf16 tile in shared memory; after one
//   __syncthreads each warp computes dQ for 16 query rows as dS K, dS
//   through ldmatrix.trans and K from the tile already resident. With one
//   key tile (Lk <= 64, the training and matcher shapes) dQ is written in
//   bf16 at once; with more, the CTA adds each key tile's share into an
//   f32 scratch row that only it touches (each thread reads back only what
//   it wrote: no atomics, so two launches give the same bits).
// - Q, K, V and dO come in as 16-byte cp.async copies, zero-filled past Lq
//   and Lk; Q and dO are double-buffered when Lq > 64, so the next query
//   tile's copy overlaps this tile's math. D = rowsum(dO * O) is summed
//   from O in f32 (16-byte loads) while the tiles are in flight.
// - bf16 A operands keep ~16 bits: dS reaches ~10 and a column of P can
//   sum to several units over the queries, and one bf16 rounding (2^-8) of
//   either uses up the 1e-2 tolerance (with P rounded once, dv failed it at
//   B=32 and Dh=64 on an H100), so each is split as in the forward,
//   x = x_hi + x_lo with both bf16, into two MMAs that share one f32
//   accumulator.
// - P = 2^(S scale log2 e - m log2 e) / l, one MUFU per element, with the
//   key's state folded into per-lane factors (no branch per element).
// - Shared memory: K, V, Q, dO tiles and the dS^T hi and lo tiles, 33.5 KB
//   at Dh=32 (41.7 KB double-buffered), against 52 KB for 256 threads
//   before; 128 registers at Dh=32 (no spill), so 4 CTAs share an SM.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): about half
// of the bytes bound at the matcher's B=256 / 384, under SDPA's backward
// at every timed shape; what holds it there is instruction issue (the
// splits, the exponentials and the addressing) and each CTA's load,
// compute, store order, with 4 CTAs per SM to overlap them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // queries and keys per tile; 16 keys (16 query rows of dQ) per warp
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `row` in a tile of C chunks per
// row (flash_chunk.cu). The chunk index is XORed with bits of the row so
// that the 8 rows an ldmatrix phase reads (8-aligned) fall on 8 distinct
// 16-byte bank groups. The XOR sees only row % 8 (C >= 8) or row % 8 / 2
// (C = 4), so moving by 8 rows adds 8 * C * 16 bytes.
template <int C>
__device__ __forceinline__ uint32_t chunk_offset(int row, int c) {
  const int x = (C == 4) ? ((row >> 1) & 3) : (row & 7);
  return static_cast<uint32_t>((row * C + (c ^ x)) * 16);
}

// One lane's ldmatrix offsets in the first 16 rows of a tile of C chunks:
// row `row`, chunk 2 kb + `bit`. As 2 kb + bit = 2 kb ^ bit, the swizzled
// chunk is 2 kb ^ (bit ^ x), x the row's XOR bits (chunk_offset): one
// LOP3 and one LEA per kb, known or not. Other 16-row blocks add
// 16 * C * 16 bytes.
template <int C>
struct LaneChunks {
  uint32_t row_bytes;
  int mask;
  __device__ __forceinline__ LaneChunks(int row, int bit)
      : row_bytes(static_cast<uint32_t>(row * C * 16)),
        mask(bit ^ ((C == 4) ? ((row >> 1) & 3) : (row & 7))) {}
  __device__ __forceinline__ uint32_t operator()(int kb) const {
    return row_bytes + static_cast<uint32_t>(((2 * kb) ^ mask) << 4);
  }
};

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

// 2^x, one MUFU instruction (max error 2 ulp; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory: K | V | dS^T hi | dS^T lo | m, 1/l, D | Q[stages] | dO[stages].
template <int DH>
struct Layout {
  static constexpr int kTileBytes = kTile * DH * 2;     // one Q, dO, K or V tile
  static constexpr int kDsBytes = kTile * kTile * 2;    // one dS^T tile (keys x queries)
  static constexpr int kStats = 2 * kTileBytes + 2 * kDsBytes;
  static constexpr int kQ = kStats + 3 * kTile * 4;
  static constexpr int bytes(int stages) { return kQ + 2 * stages * kTileBytes; }
};

// Registers decide how many CTAs share an SM while they wait on memory:
// at Dh=32 the cap of 128 lets 4 CTAs (16 warps) in. (Dh=64 and 128 are
// off the training and matcher paths and take what they need.)
template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 32 ? 4 : 1)
flash_chunk_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const uint8_t* __restrict__ kmask,
                       const float* __restrict__ m_in, const float* __restrict__ l_in,
                       const float* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc,
                       int Lq, int Lk, int H, float scale) {
  using L = Layout<DH>;
  constexpr int C = DH / 8;      // 16-byte chunks per row of a Q, dO, K or V tile
  constexpr int kKB = DH / 16;   // k-steps of S^T and dP^T
  // dK and dV dims a pass over the query tiles accumulates: all of them
  // up to Dh=64; at Dh=128 two passes of 64 (S^T and dP^T computed twice),
  // since 128 accumulator registers per thread would spill.
  constexpr int kPassDims = DH > 64 ? 64 : DH;
  constexpr int kPasses = DH / kPassDims;
  constexpr int kDT = kPassDims / 8;  // 8-dim tiles of dK and dV a pass
  constexpr uint32_t kRows16 = 16 * C * 16;  // bytes of 16 rows of a Q, dO, K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  const int n_qt = (Lq + kTile - 1) / kTile;
  const int n_kt = (Lk + kTile - 1) / kTile;
  const int stages = n_qt > 1 ? 2 : 1;
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + L::kTileBytes;
  const uint32_t dsh_s = v_s + L::kTileBytes;
  const uint32_t dsl_s = dsh_s + L::kDsBytes;
  float* m_s = reinterpret_cast<float*>(smem + L::kStats);  // m log2(e); +inf past Lq
  float* il_s = m_s + kTile;                                // 1 / max(l, 1e-30)
  float* d_s = il_s + kTile;                                // rowsum(dO * O)
  const uint32_t q_s = k_s + L::kQ;
  const uint32_t do_s = q_s + stages * L::kTileBytes;

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t stride = static_cast<size_t>(H) * DH;  // elements between tokens
  const size_t q_base = (static_cast<size_t>(b) * Lq * H + h) * DH;
  const size_t k_base = (static_cast<size_t>(b) * Lk * H + h) * DH;
  const size_t stat_base = (static_cast<size_t>(b) * H + h) * Lq;

  // Rows first .. first + count - 1 of a (b, h) slice into a swizzled tile;
  // rows past count are zero-filled (their source is row `first`, unread).
  auto load_tile = [&](uint32_t dst, const __nv_bfloat16* src, int first, int count) {
#pragma unroll
    for (int r = 0; r < kTile * C / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int row = i / C;
      const int c = i % C;
      const bool live = row < count;
      cp_async_16(dst + chunk_offset<C>(row, c),
                  src + static_cast<size_t>(first + (live ? row : 0)) * stride + c * 8, live);
    }
  };

  // ldmatrix lane offsets in a 16-row block. a_lane: the A operand from a
  // row-major tile (K, V), and with .trans the B operand from a tile whose
  // rows are B's rows (dO, Q, K); b_lane: the B operand from a tile whose
  // rows are B's columns (Q, dO), and with .trans (ds_lane) the A operand
  // from a tile whose rows are A's columns (dS^T).
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_chunk = (lane >> 3) & 1;
  const LaneChunks<C> a_lane((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);
  const LaneChunks<C> b_lane(b_row, b_chunk);
  const uint32_t ds_lane = chunk_offset<8>(b_row, 2 * warp + b_chunk);  // dS of dQ

  load_tile(q_s, q + q_base, 0, min(kTile, Lq));
  load_tile(do_s, dout + q_base, 0, min(kTile, Lq));
  cp_async_commit();

  int step = 0;  // (key tile, pass, query tile) steps done; Q and dO alternate stages by it
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    const int nk = min(kTile, Lk - k0);
    if (j > 0) __syncthreads();  // every warp is done with the last tile's K (dQ)
    load_tile(k_s, k + k_base, k0, nk);
    load_tile(v_s, v + k_base, k0, nk);
    cp_async_commit();

    // This lane's keys, rows g and g + 8 of its warp's 16, as factors of
    // P = 2^(S key_mul + key_add - m log2 e) / l and dS = key_ds P (dP - D):
    // a live key scores S scale; a masked one scores -1e30, whatever S, and
    // passes no gradient; a key past Lk has P = 0.
    float key_mul[2], key_add[2], key_ds[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = warp * 16 + g + 8 * r;
      const bool exists = key < nk;
      const bool live = exists && kmask[static_cast<size_t>(b) * Lk + k0 + key];
      key_mul[r] = live ? scale * kLog2e : 0.f;
      key_add[r] = live ? 0.f : (exists ? kMasked * kLog2e : -INFINITY);
      key_ds[r] = live ? 1.f : 0.f;
    }
    const bool warp_keys = warp * 16 < nk;  // warp-uniform
#pragma unroll 1
    for (int pass = 0; pass < kPasses; ++pass) {
      const int dim0 = pass * kPassDims;
      float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

      for (int i = 0; i < n_qt; ++i, ++step) {
        const int q0 = i * kTile;
        const int nq = min(kTile, Lq - q0);
        const int stage = step & (stages - 1);
        bool prefetched = false;
        if (stages == 2) {  // the next step's Q and dO into the other stage
          const int ni = i + 1 < n_qt ? i + 1 : 0;
          if (i + 1 < n_qt || pass + 1 < kPasses || j + 1 < n_kt) {
            const int nq0 = ni * kTile;
            load_tile(q_s + (stage ^ 1) * L::kTileBytes, q + q_base, nq0, min(kTile, Lq - nq0));
            load_tile(do_s + (stage ^ 1) * L::kTileBytes, dout + q_base, nq0,
                      min(kTile, Lq - nq0));
            cp_async_commit();
            prefetched = true;
          }
        }
        // The rows' statistics, and D from global memory while the copies
        // are in flight: two threads per row, half of Dh each.
        if (tid < kTile) {
          const bool live = tid < nq;
          m_s[tid] = live ? m_in[stat_base + q0 + tid] * kLog2e : INFINITY;  // P = 0 past Lq
          il_s[tid] = live ? 1.f / fmaxf(l_in[stat_base + q0 + tid], 1e-30f) : 0.f;
        }
        {
          const int row = tid >> 1;
          const int part = tid & 1;
          float sum = 0.f;
          if (row < nq) {
            const size_t at = q_base + static_cast<size_t>(q0 + row) * stride;
#pragma unroll 2
            for (int c = part * (C / 2); c < (part + 1) * (C / 2); ++c) {
              const uint4 raw = *reinterpret_cast<const uint4*>(dout + at + 8 * c);
              const float4 o0 = *reinterpret_cast<const float4*>(o + at + 8 * c);
              const float4 o1 = *reinterpret_cast<const float4*>(o + at + 8 * c + 4);
              const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
              const float2 a = __bfloat1622float2(d2[0]), bb = __bfloat1622float2(d2[1]);
              const float2 cc = __bfloat1622float2(d2[2]), dd = __bfloat1622float2(d2[3]);
              sum += a.x * o0.x + a.y * o0.y + bb.x * o0.z + bb.y * o0.w;
              sum += cc.x * o1.x + cc.y * o1.y + dd.x * o1.z + dd.y * o1.w;
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          if (part == 0) d_s[row] = sum;
        }
        if (prefetched) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // tiles, m, 1/l and D are in shared memory

        const uint32_t qt = q_s + stage * L::kTileBytes;
        const uint32_t dot = do_s + stage * L::kTileBytes;
        if (warp_keys) {
#pragma unroll 1
          for (int qs = 0; qs < kTile / 16; ++qs) {  // 16 queries a step
            if (qs * 16 >= nq) break;  // warp-uniform: no query left
            const uint32_t q16 = qs * kRows16;

            // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the
            // step's 16 queries (two 8-query tiles n): K and V as stored are
            // row-major A operands, Q and dO as stored the col-major B
            // operands.
            float s[2][4], dp[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
            for (int kb = 0; kb < kKB; ++kb) {
              uint32_t ka[4], va[4], bq[4], bo[4];
              ldmatrix_x4(k_s + warp * kRows16 + a_lane(kb), ka);
              ldmatrix_x4(v_s + warp * kRows16 + a_lane(kb), va);
              ldmatrix_x4(qt + q16 + b_lane(kb), bq);
              ldmatrix_x4(dot + q16 + b_lane(kb), bo);
              mma_bf16(s[0], ka, bq[0], bq[1]);
              mma_bf16(s[1], ka, bq[2], bq[3]);
              mma_bf16(dp[0], va, bo[0], bo[1]);
              mma_bf16(dp[1], va, bo[2], bo[3]);
            }

            // P^T and dS^T (keys are rows here) as the bf16 hi and lo A
            // fragments of the next two products: the two 8-query tiles hold
            // rows g, g + 8 (r = 0, 1) at queries 2 t4, 2 t4 + 1 of each, A
            // fragment register 2 n + r (PTX ISA, mma.m16n8k16). dS^T also
            // goes into the shared hi and lo tiles for dQ.
            uint32_t pah[4], pal[4], sah[4], sal[4];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int qc = qs * 16 + n * 8 + 2 * t4;
              const float2 mq = *reinterpret_cast<const float2*>(m_s + qc);
              const float2 il = *reinterpret_cast<const float2*>(il_s + qc);
              const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int f = 2 * n + r;
                const float p0 = ex2(fmaf(s[n][2 * r], key_mul[r], key_add[r]) - mq.x) * il.x;
                const float p1 = ex2(fmaf(s[n][2 * r + 1], key_mul[r], key_add[r]) - mq.y) * il.y;
                split_bf16x2(p0, p1, pah[f], pal[f]);
                split_bf16x2(p0 * key_ds[r] * (dp[n][2 * r] - dd.x),
                             p1 * key_ds[r] * (dp[n][2 * r + 1] - dd.y), sah[f], sal[f]);
                if (pass == 0) {
                  const uint32_t at = chunk_offset<8>(warp * 16 + g + 8 * r, 2 * qs + n) + 4 * t4;
                  *reinterpret_cast<uint32_t*>(smem + (dsh_s - k_s) + at) = sah[f];
                  *reinterpret_cast<uint32_t*>(smem + (dsl_s - k_s) + at) = sal[f];
                }
              }
            }

            // dV += P^T dO and dK += dS^T Q over the pass's dims, dO and Q
            // through ldmatrix.trans.
#pragma unroll
            for (int d2 = 0; d2 < kDT / 2; ++d2) {
              uint32_t bo[4];
              ldmatrix_x4_trans(dot + q16 + a_lane(dim0 / 16 + d2), bo);
              mma_bf16(dv_acc[2 * d2], pah, bo[0], bo[1]);
              mma_bf16(dv_acc[2 * d2], pal, bo[0], bo[1]);
              mma_bf16(dv_acc[2 * d2 + 1], pah, bo[2], bo[3]);
              mma_bf16(dv_acc[2 * d2 + 1], pal, bo[2], bo[3]);
            }
#pragma unroll
            for (int d2 = 0; d2 < kDT / 2; ++d2) {
              uint32_t bq[4];
              ldmatrix_x4_trans(qt + q16 + a_lane(dim0 / 16 + d2), bq);
              mma_bf16(dk_acc[2 * d2], sah, bq[0], bq[1]);
              mma_bf16(dk_acc[2 * d2], sal, bq[0], bq[1]);
              mma_bf16(dk_acc[2 * d2 + 1], sah, bq[2], bq[3]);
              mma_bf16(dk_acc[2 * d2 + 1], sal, bq[2], bq[3]);
            }
          }
        }
        __syncthreads();  // dS^T of all 64 keys is in shared memory

        // dQ = scale * dS K for the warp's 16 query rows, 32 dims at a time
        // (in the first pass): dS through ldmatrix.trans of the dS^T tiles,
        // K through ldmatrix.trans of the resident tile.
        if (pass == 0 && warp * 16 < nq) {
          const int n_kb = (nk + 15) / 16;
#pragma unroll 1
          for (int gd = 0; gd < DH / 32; ++gd) {
            float acc[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
            for (int kk = 0; kk < n_kb; ++kk) {
              uint32_t ah[4], al[4];
              ldmatrix_x4_trans(dsh_s + kk * (16 * kTile * 2) + ds_lane, ah);
              ldmatrix_x4_trans(dsl_s + kk * (16 * kTile * 2) + ds_lane, al);
#pragma unroll
              for (int d2 = 0; d2 < 2; ++d2) {
                uint32_t bk[4];
                ldmatrix_x4_trans(k_s + kk * kRows16 + a_lane(2 * gd + d2), bk);
                mma_bf16(acc[2 * d2], ah, bk[0], bk[1]);
                mma_bf16(acc[2 * d2], al, bk[0], bk[1]);
                mma_bf16(acc[2 * d2 + 1], ah, bk[2], bk[3]);
                mma_bf16(acc[2 * d2 + 1], al, bk[2], bk[3]);
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + g + 8 * r;
              if (row >= nq) continue;
              const size_t at =
                  q_base + static_cast<size_t>(q0 + row) * stride + 32 * gd + 2 * t4;
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                float x = acc[n][2 * r] * scale, y = acc[n][2 * r + 1] * scale;
                if (n_kt == 1) {
                  *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * n) = __floats2bfloat162_rn(x, y);
                } else {
                  float2* sum = reinterpret_cast<float2*>(dq_acc + at + 8 * n);
                  if (j > 0) {
                    const float2 prev = *sum;
                    x += prev.x;
                    y += prev.y;
                  }
                  *sum = make_float2(x, y);
                }
              }
            }
          }
        }
      }

      // This key tile's dK and dV of the pass's dims, from the warp's
      // accumulators.
      if (warp_keys) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = warp * 16 + g + 8 * r;
          if (key >= nk) continue;
          const size_t at = k_base + static_cast<size_t>(k0 + key) * stride + dim0 + 2 * t4;
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * n) = __floats2bfloat162_rn(
                dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * n) =
                __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // Lk = 0 started copies that nothing waited for

  // Several key tiles: dQ from the f32 rows this thread wrote. With no
  // key at all, dQ is 0.
  if (n_kt == 1) return;
  for (int i = 0; i < n_qt; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i * kTile + warp * 16 + g + 8 * r;
      if (row >= Lq) continue;
      const size_t at = q_base + static_cast<size_t>(row) * stride + 2 * t4;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const float2 x = n_kt ? *reinterpret_cast<const float2*>(dq_acc + at + 8 * n)
                              : make_float2(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * n) = __floats2bfloat162_rn(x.x, x.y);
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kmask, const void* m,
           const void* l, const void* o, const void* dout, void* dq, void* dk, void* dv,
           void* dq_acc, int B, int Lq, int Lk, int H, float scale, cudaStream_t stream) {
  const int stages = Lq > kTile ? 2 : 1;
  const int smem = Layout<DH>::bytes(stages);
  // Above 48 KB (Dh >= 64) only by opting in, once per device (so that a
  // launch captured into a CUDA graph makes no such call).
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(flash_chunk_bwd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<DH>::bytes(2));
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
