// Tensor-core block body of the bf16 prefill and extend kernels
// (flash_prefill.cu, flash_extend.cu, paged_extend.cu,
// paged_extend_quant.cu).
//
// It computes what `attend_block` (attention_common.cuh) computes for a
// `Rows` policy, for bf16 q/k/v and head_dim D in {64, 128}: one block owns
// kRows = 64 query rows that share one KV head (row r is position
// q0 + r / G, head kh * G + r % G, as attend_block folds the GQA group), and
// sweeps keys [0, kv_end) in tiles of kTileK = 64 positions. 64 divides the
// engine's 128-token page, so StageTcPaged loads one page as two tiles, each
// through one block-table read.
//
// Design, for an H100 (sm_90a):
//   * Tensor cores through `mma.sync.aligned.m16n8k16` (bf16 in, fp32
//     accumulate), fed by `ldmatrix` from XOR-swizzled shared memory. One
//     warpgroup (4 warps) owns the 64 rows, each warp 16 of them. The choice
//     of mma.sync over wgmma was made when the kernel was designed: its
//     fragment layouts are fixed by the PTX ISA, so they could be written and
//     reviewed without the card at hand, while a wgmma shared-memory
//     descriptor (swizzle mode, leading and stride byte offsets, the
//     transposed V operand) can only be checked on the card. wgmma is the next
//     step for this body.
//   * S = Q K^T: the warp's Q rows are loaded once into registers (A
//     fragments); K fragments come from the swizzled K tile (`ldmatrix`).
//   * O += P V: P is the S accumulator itself, rounded to bf16 and repacked
//     in registers as the A operand (the m16n8 accumulator layout of two
//     adjacent key octets is the m16k16 A layout); V fragments come from the
//     swizzled V tile with `ldmatrix.trans`. No score tile in shared memory.
//   * Online softmax in registers: a thread holds two rows (g, g + 8) of its
//     warp's 16; a row lives on the 4 threads of a quad, so two
//     `__shfl_xor_sync` steps finish its max. The rescale multiplies the O
//     accumulators in registers; the row sums stay per thread and are summed
//     over the quad once, at the end.
//   * Only a tile that reaches past the keys every row sees (the causal
//     diagonal) or past kv_end applies the mask; interior tiles skip it.
//   * K and V tiles move with `cp.async` (16 bytes a thread) into a ring of
//     kStages = 2 stages: tile i + 1 is in flight while tile i's two
//     products run. Keys past kv_end are zero-filled, never read.
//   * Shared memory at D = 128: q 16 KB + 2 stages x (K 16 KB + V 16 KB) =
//     80 KB, so two blocks (eight warps) fit on an SM.
//
// How a key tile reaches the swizzled bf16 K and V tiles is the `Stage`
// template parameter, as in attend_block:
//   * StageTcPlain (the default: flash_prefill.cu, flash_extend.cu): one
//     cp.async per 16-byte chunk from rw.k_row(c) / rw.v_row(c).
//   * StageTcPaged (paged_extend.cu, bf16 pools [P, PS, K, D]): the same
//     copies through the block table, read once per tile when 64 divides the
//     page size (the tile then lies in one page, its rows K cells apart), else
//     once per key row; never once per 16-byte chunk (2 x D / 8 dependent
//     loads a key).
//   * StageTcInt8 (paged_extend_quant.cu, int8 codes [P, PS, K, D] and f32
//     scales [P, PS, K], bf16 q): cp.async copies the raw codes and scales
//     into a 2-stage ring; once a tile has landed, one pass writes
//     bf16(float(code) * scale) (round to nearest even: dequantize_kv's and
//     the Pallas kernel's rounding) into ONE bf16 K/V stage, and the two
//     products run from it as above. The copy of tile i + 1 still overlaps
//     tile i's products; the dequant pass does not. Shared memory at
//     D = 128: q 16 KB + K 16 KB + V 16 KB + 2 x (codes 16 KB + scales
//     0.5 KB) = 81 KB, so two blocks still fit on an SM (a second bf16 stage
//     would make it 113 KB and one block).
//   All three write the same bf16 values for the same keys, so the paged bf16
//   extend gives flash_extend's bits over a dense row holding the same keys,
//   and the int8 extend gives the bf16 extend's bits over the pools
//   dequantized with dequantize_kv.
//
// Numerics follow _online_update in llmlb_tpu/ops/pallas_attention.py:
// fp32 scores scaled by `scale` after the dot; the running max and the sum
// l taken from the fp32 probabilities; the probabilities rounded to bf16 for
// the PV product, accumulated in fp32; a masked key has probability exactly
// 0 (exp(-inf)); a row that saw no key ends with l == 0 and writes 0.
//
// `Rows` supplies what attend_block's policies supply (rows, row_valid,
// q_off, kv_end, allowed; for StageTcPlain k_row, v_row) and one more:
//   int unmasked_end()   keys [0, unmasked_end) are visible to every row
// The paged stages read, instead of k_row and v_row:
//   k_pages, v_pages     the pools (bf16 values, or int8 codes)
//   k_scales, v_scales   (StageTcInt8) the f32 scales [P, PS, K]
//   page_size, kv_heads  PS and K of the pools
//   size_t cell(int c)   index of key c's (position, KV head) cell in
//                        [P, PS, K]: one block-table read
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace llmlb {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: 4 warps x 16 rows
constexpr int kRows = 64;      // query rows of a block (positions x group)
constexpr int kTileK = 64;     // key positions per tile
constexpr int kStages = 2;     // K/V tiles in flight

// Byte offset of 16-byte chunk `c` of row `r` in a tile of D bf16 values a
// row. The chunk index is XORed with r % 8, so the 8 row addresses of one
// ldmatrix matrix (8 rows, one chunk) fall on 8 different bank groups.
template <int D> __device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// The body's shared memory: q rows, Stage::kTiles swizzled bf16 K tiles and
// as many V tiles, then the Stage's own raw area. Shared-space addresses for
// cp.async and ldmatrix; `base` is the generic pointer of the same memory.
struct Tiles {
  unsigned char* base;
  uint32_t q, k, v, raw;
};

template <int D> __host__ __device__ constexpr uint32_t tile_bytes() {
  return kTileK * D * 2;
}

// StageTcPlain: one cp.async per 16-byte chunk of rw.k_row(c), rw.v_row(c).
struct StageTcPlain {
  static constexpr int kTiles = kStages;  // bf16 K/V tiles: the copy ring
  template <int D>
  __host__ __device__ static constexpr size_t raw_bytes() {
    return 0;
  }

  // issue the copies of key tile `tile` into ring slot `slot` (no commit)
  template <int D, typename Rows>
  __device__ static void load(const Rows& rw, const Tiles& sm, int tile,
                              int slot, int kv_end, const bf16* zero_src) {
    constexpr int kChunks = D / 8;
    const int t0 = tile * kTileK;
    for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = t0 + r < kv_end;
      const uint32_t off = slot * tile_bytes<D>() + swz<D>(r, c);
      cp_async16(sm.k + off, ok ? rw.k_row(t0 + r) + c * 8 : zero_src, ok);
      cp_async16(sm.v + off, ok ? rw.v_row(t0 + r) + c * 8 : zero_src, ok);
    }
  }
  // the K/V stage holding the tile of ring slot `slot`, once its copies
  // have landed
  template <int D>
  __device__ static int ready(const Tiles&, int slot) { return slot; }
};

// Cell index of key row t0 + r of a tile in [P, PS, K]. When 64 divides the
// page size the tile lies in one page, so `cell0` (= rw.cell(t0), read once
// per tile) plus r rows of K cells is the cell; else the row reads its own
// page. Only called for keys below kv_end.
template <typename Rows>
__device__ __forceinline__ size_t tile_cell(const Rows& rw, bool one_page,
                                            size_t cell0, int t0, int r) {
  return one_page ? cell0 + (size_t)r * rw.kv_heads : rw.cell(t0 + r);
}

// StageTcPaged: StageTcPlain's copies, addressed through the block table.
struct StageTcPaged {
  static constexpr int kTiles = kStages;
  template <int D>
  __host__ __device__ static constexpr size_t raw_bytes() {
    return 0;
  }

  template <int D, typename Rows>
  __device__ static void load(const Rows& rw, const Tiles& sm, int tile,
                              int slot, int kv_end, const bf16* zero_src) {
    constexpr int kChunks = D / 8;
    const int t0 = tile * kTileK;  // < kv_end: the tile has a key
    const bool one_page = rw.page_size % kTileK == 0;
    const size_t cell0 = one_page ? rw.cell(t0) : 0;
    for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = t0 + r < kv_end;
      const size_t e =
          ok ? tile_cell(rw, one_page, cell0, t0, r) * D + c * 8 : 0;
      const uint32_t off = slot * tile_bytes<D>() + swz<D>(r, c);
      cp_async16(sm.k + off, ok ? rw.k_pages + e : zero_src, ok);
      cp_async16(sm.v + off, ok ? rw.v_pages + e : zero_src, ok);
    }
  }
  template <int D>
  __device__ static int ready(const Tiles&, int slot) { return slot; }
};

// bf16(float(code) * scale) of 8 int8 codes, packed in memory order
__device__ __forceinline__ uint4 dequant8(uint2 codes, float s) {
  union {
    uint2 u;
    int8_t b[8];
  } c;
  c.u = codes;
  uint4 o;
  o.x = pack_bf16((float)c.b[0] * s, (float)c.b[1] * s);
  o.y = pack_bf16((float)c.b[2] * s, (float)c.b[3] * s);
  o.z = pack_bf16((float)c.b[4] * s, (float)c.b[5] * s);
  o.w = pack_bf16((float)c.b[6] * s, (float)c.b[7] * s);
  return o;
}

// StageTcInt8: raw codes and scales through a 2-stage cp.async ring, then one
// dequant pass a tile into a single bf16 K/V stage.
struct StageTcInt8 {
  static constexpr int kTiles = 1;
  // a raw slot: K codes [64][D], V codes [64][D], K scales [64], V scales [64]
  template <int D>
  __host__ __device__ static constexpr uint32_t slot_bytes() {
    return 2 * kTileK * D + 2 * kTileK * 4;
  }
  template <int D>
  __host__ __device__ static constexpr size_t raw_bytes() {
    return (size_t)kStages * slot_bytes<D>();
  }

  template <int D, typename Rows>
  __device__ static void load(const Rows& rw, const Tiles& sm, int tile,
                              int slot, int kv_end, const bf16* zero_src) {
    constexpr int kChunks = D / 16;  // 16 codes a copy
    const int t0 = tile * kTileK;
    const bool one_page = rw.page_size % kTileK == 0;
    const size_t cell0 = one_page ? rw.cell(t0) : 0;
    const uint32_t raw = sm.raw + slot * slot_bytes<D>();
    for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = t0 + r < kv_end;
      const size_t e =
          ok ? tile_cell(rw, one_page, cell0, t0, r) * D + c * 16 : 0;
      const uint32_t off = r * D + c * 16;
      cp_async16(raw + off, ok ? rw.k_pages + e : (const void*)zero_src, ok);
      cp_async16(raw + kTileK * D + off,
                 ok ? rw.v_pages + e : (const void*)zero_src, ok);
    }
    for (int i = threadIdx.x; i < 2 * kTileK; i += kThreads) {
      const int r = i % kTileK;
      const bool ok = t0 + r < kv_end;
      const float* scales = i < kTileK ? rw.k_scales : rw.v_scales;
      const size_t cell = ok ? tile_cell(rw, one_page, cell0, t0, r) : 0;
      cp_async4(raw + 2 * kTileK * D + i * 4,
                ok ? scales + cell : (const void*)zero_src, ok);
    }
  }

  template <int D>
  __device__ static int ready(const Tiles& sm, int slot) {
    constexpr int kChunks = D / 8;  // 8 codes -> one 16-byte bf16 chunk
    const unsigned char* raw =
        sm.base + (sm.raw - sm.q) + slot * slot_bytes<D>();
    const float* scales = reinterpret_cast<const float*>(raw + 2 * kTileK * D);
    unsigned char* kt = sm.base + (sm.k - sm.q);
    unsigned char* vt = sm.base + (sm.v - sm.q);
    for (int i = threadIdx.x; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const uint2 kc = *reinterpret_cast<const uint2*>(raw + r * D + c * 8);
      const uint2 vc =
          *reinterpret_cast<const uint2*>(raw + kTileK * D + r * D + c * 8);
      *reinterpret_cast<uint4*>(kt + swz<D>(r, c)) = dequant8(kc, scales[r]);
      *reinterpret_cast<uint4*>(vt + swz<D>(r, c)) =
          dequant8(vc, scales[kTileK + r]);
    }
    __syncthreads();  // the bf16 tiles are whole before any ldmatrix
    return 0;
  }
};

template <int D, typename Stage = StageTcPlain>
constexpr size_t smem_bytes() {
  return (size_t)kRows * D * 2                          // q rows
         + (size_t)2 * Stage::kTiles * tile_bytes<D>()  // K and V tiles
         + Stage::template raw_bytes<D>();              // the raw ring
}

template <int D, typename Stage = StageTcPlain, typename Rows>
__device__ void attend_block_tc(const Rows& rw, const bf16* __restrict__ q,
                                bf16* __restrict__ out, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16, <= 128");
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kTileBytes = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles sm;
  sm.base = smem;
  sm.q = (uint32_t)__cvta_generic_to_shared(smem);
  sm.k = sm.q + kRows * D * 2;  // Stage::kTiles K tiles
  sm.v = sm.k + Stage::kTiles * kTileBytes;
  sm.raw = sm.v + Stage::kTiles * kTileBytes;
  const uint32_t s_q = sm.q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // quad and place in it
  const int n_rows = rw.rows();
  const int kv_end = rw.kv_end();
  const int n_tiles = (kv_end + kTileK - 1) / kTileK;
  const int clean_end = min(kv_end, rw.unmasked_end());
  // this thread's two accumulator rows of the block
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};

  // q rows to shared memory; rows past the block's rows or the sequence are
  // zero and never written back
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < n_rows && rw.row_valid(r);
    cp_async16(s_q + swz<D>(r, c), ok ? q + rw.q_off(r) + c * 8 : q, ok);
  }
  if (n_tiles > 0) Stage::template load<D>(rw, sm, 0, 0, kv_end, q);
  cp_async_commit();  // group: q and tile 0

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums
  uint32_t qf[D / 16][4];       // A fragments of the warp's 16 q rows

  for (int it = 0; it < n_tiles; ++it) {
    // the next tile's copy overlaps this tile's two products; the ring slot
    // it overwrites was released by the __syncthreads that ended the last
    // iteration
    if (it + 1 < n_tiles)
      Stage::template load<D>(rw, sm, it + 1, (it + 1) % kStages, kv_end, q);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile `it` has landed
    __syncthreads();
    const int stage = Stage::template ready<D>(sm, it % kStages);
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(s_q + swz<D>(r, 2 * kk + (lane >> 4)), qf[kk][0], qf[kk][1],
                qf[kk][2], qf[kk][3]);
      }
    }

    // -- S = Q K^T (fp32), 16 rows x 64 keys a warp ---------------------------
    float s[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t kt = sm.k + stage * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTileK / 16; ++np) {
        // matrices: keys +0..7 / +8..15 of the pair x d chunks 2kk, 2kk + 1
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kt + swz<D>(key, 2 * kk + ((lane >> 3) & 1)), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // -- scale, mask (diagonal and last tiles only), online softmax ---------
    const int t0 = it * kTileK;
    const bool masked = t0 + kTileK > clean_end;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int c = t0 + j * 8 + 2 * t4 + (e & 1);
          if (!(c < kv_end && rw.allowed(row[e >> 1], c))) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // no key seen yet
      corr[h] = __expf(m_run[h] - base[h]);        // 0 while m_run is -inf
      m_run[h] = mx[h];
    }
    uint32_t pf[kTileK / 16][4];  // P as A fragments, bf16
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
      const float p0 = __expf(s[j][0] - base[0]);
      const float p1 = __expf(s[j][1] - base[0]);
      const float p2 = __expf(s[j][2] - base[1]);
      const float p3 = __expf(s[j][3] - base[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      // key octet j is half (j % 2) of the 16-key k-step j / 2
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + psum[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // -- O += P V --------------------------------------------------------------
    const uint32_t vt = sm.v + stage * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // matrices: keys +0..7 / +8..15 of the k-step x d chunks 2dp, 2dp + 1
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(vt + swz<D>(key, 2 * dp + (lane >> 4)), b0, b1, b2, b3);
        mma_bf16(o[2 * dp], pf[kk], b0, b1);
        mma_bf16(o[2 * dp + 1], pf[kk], b2, b3);
      }
    }
    __syncthreads();  // the next iteration's copy reuses this slot
  }
  cp_async_wait<0>();  // nothing left in flight (no tile: the q group)

  // -- out = O / l, in bf16 ---------------------------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int r = row[h];
    if (r < n_rows && rw.row_valid(r)) {
      bf16* dst = out + rw.q_off(r) + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

// Launch helper: as llmlb::launch, with kThreads threads a block.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The block's tile of query positions and (KV head, batch row), from a flat
// grid of n_qtiles * kv_heads * batch blocks ordered longest tile first: the
// tiles at the end of a sequence sweep the most keys, so they start first
// and the short ones fill in behind them instead of forming the tail.
struct TileIndex {
  int tile, kh, b;
};
__device__ __forceinline__ TileIndex tile_index(int n_qtiles, int kv_heads,
                                                int batch) {
  const int per_tile = kv_heads * batch;
  const int i = (int)blockIdx.x;
  const int rest = i % per_tile;
  return {n_qtiles - 1 - i / per_tile, rest % kv_heads, rest / kv_heads};
}

}  // namespace tc
}  // namespace llmlb
