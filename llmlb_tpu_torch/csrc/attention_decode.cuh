// Split-K block body of the one-token decode kernels (flash_decode.cu over
// the dense slot cache, paged_decode_quant.cu over int8 pages).
//
// A decode row is G query rows (one GQA group) against one KV head's keys
// [0, stop), stop = min(kv_lens[b], sweep). One block per (key split, KV
// head, batch row): split s covers the absolute keys [s * kSplitKeys,
// (s + 1) * kSplitKeys). The boundaries depend on nothing but the constant,
// so a row's arithmetic is the same whatever the batch, the sweep or the
// other rows: computed alone or in a batch, under a window of 256 or 4096,
// a row gives the same bits. A block whose split starts at or past `stop`
// reads nothing and exits.
//
// What bounds it on an H100: bytes. Each key is read once (K and V rows of
// D values: 512 B in bf16 at D = 128, 2 x (128 + 4) B in int8) and feeds G
// multiply-adds per element, far below the ~295 ops/byte line, so tensor
// cores buy nothing. The design keeps bytes in flight on every SM:
//   * the split-K grid: at 8 rows of contexts 4096..1 it is 408 live
//     blocks on 132 SMs (3 fit on an SM), where one block per (KV head,
//     row) was 64;
//   * K and V tiles of kTileK = 64 keys (for int8: the raw codes and their
//     float32 scales) move with `cp.async` into a 2-stage ring, so tile
//     i + 1 is on its way while tile i computes; keys past the split's last
//     are zero-filled, never read;
//   * int8 codes are dequantized when read from the ring, into registers,
//     not into a second tile;
//   * kRows, the block's query rows, is 4 or 8: a group of G <= 4 runs the
//     4-row build, 5..8 the 8-row build.
//
// Work of a 256-thread block on one tile:
//   * scores: thread t takes key t / 4 and a quarter of its 16-byte chunks
//     (chunks p, p + 4, ... for p = t % 4), dots them with the kRows fp32 q
//     rows in shared memory, and the quad sums its four parts by shuffles;
//     K rows are stored with chunk c of key j at c ^ 4 (j odd), so the two
//     keys a quarter-warp reads fall on different banks;
//   * online softmax: one warp per row, as attend_block;
//   * P V: thread t takes four columns and one of 1024 / D key groups of
//     the tile; the probabilities are stored key-major, so one 16-byte load
//     gives four rows' of a key; the thread's kRows x 4 accumulators stay
//     in registers across tiles and the key groups are summed, in order,
//     once at the end of the split.
//
// Numerics, as attend_block and the Pallas decode kernels: fp32 scores
// scaled after the dot; fp32 running max and sum l; the probabilities
// rounded to q's dtype before the PV product, accumulated in fp32; an int8
// code dequantized in fp32 (code * scale) and rounded to q's dtype before
// either product.
//
// The end of a split: with one split (n_splits == 1: every decode whose
// sweep is at most kSplitKeys) the block writes out = acc / l itself, one
// launch. With more, each block writes its partial (m, l, acc[G, D]) in
// fp32 to scratch laid out [B, K, n_splits, G] (acc, then m, then l), and
// decode_combine_kernel merges the live splits of each (row, KV head) in
// split order: m = max m_s, l = sum l_s e^(m_s - m), out = sum acc_s
// e^(m_s - m) / l. A lone live split combines as acc * 1 / l, exactly the
// one-split result; a row with no key writes 0, as attend_block does.
//
// `Rows` supplies:
//   int rows()             the block's query rows (G <= kRows)
//   size_t q_off(int r)    element offset of row r in q and in out
//   int kv_end()           stop: keys [0, stop) are visible
//   size_t cell(int c)     index of key c's (position, KV head) vector
// and what its Stage reads from the cell (StagePlain: k_src(), v_src();
// StageInt8: also k_scales(), v_scales()).
#pragma once

#include "attention_common.cuh"

namespace llmlb {
namespace dec {

constexpr int kSplitKeys = 256;  // keys of one split
constexpr int kStages = 2;       // K/V tiles in flight
static_assert(kSplitKeys % kTileK == 0 && kSplitKeys >= 256,
              "a split is whole 64-key tiles, at least the 256-key window");

// Splits of a sweep of `sweep` keys (at least one).
__host__ __device__ constexpr int n_splits(int sweep) {
  return sweep <= kSplitKeys ? 1 : (sweep + kSplitKeys - 1) / kSplitKeys;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stored place of 16-byte chunk `c` of tile key `j`, in a row of `n_chunks`
// chunks: rows of 8 or more chunks swap their chunk halves of 4 on odd keys.
__device__ __forceinline__ int swz(int j, int c, int n_chunks) {
  return n_chunks >= 8 ? c ^ ((j & 1) << 2) : c;
}

// 16 bytes of T as floats
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* x);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* x) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                                    float* x) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Four consecutive values as floats (8- or 16-byte aligned).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A stage of the ring: the K rows of a tile (chunks swizzled), then its V
// rows, each row D elements of Elem; StageInt8 adds the tile's K and V
// scales. `issue` starts the copies of tile keys [0, n) (cells[j] is key j's
// cell), `k_chunk` gives logical chunk c of key j's K row as kChunkElems
// floats, `v_quad` columns col..col + 3 of key j's V row.
template <typename T>
struct StagePlain {
  using Elem = T;
  static constexpr int kChunkElems = 16 / (int)sizeof(T);
  __host__ __device__ static size_t bytes(int d) {
    return 2 * (size_t)kTileK * d * sizeof(T);
  }
  template <typename Rows>
  __device__ static void issue(const Rows& rw, unsigned char* st,
                               const unsigned* cells, int n, int d) {
    const int chunks = d / kChunkElems;
    T* ks = reinterpret_cast<T*>(st);
    T* vs = ks + (size_t)kTileK * d;
    for (int i = threadIdx.x; i < kTileK * chunks; i += kThreads) {
      const int j = i / chunks, c = i % chunks;
      const bool ok = j < n;
      const size_t off = ok ? (size_t)cells[j] * d + c * kChunkElems : 0;
      cp_async16(ks + (size_t)j * d + swz(j, c, chunks) * kChunkElems,
                 rw.k_src() + off, ok);
      cp_async16(vs + (size_t)j * d + c * kChunkElems, rw.v_src() + off, ok);
    }
  }
  __device__ static void k_chunk(const unsigned char* st, int j, int c, int d,
                                 float* x) {
    const T* ks = reinterpret_cast<const T*>(st);
    const int chunks = d / kChunkElems;
    unpack16<T>(*reinterpret_cast<const uint4*>(
                    ks + (size_t)j * d + swz(j, c, chunks) * kChunkElems),
                x);
  }
  __device__ static float4 v_quad(const unsigned char* st, int j, int col,
                                  int d) {
    const T* vs = reinterpret_cast<const T*>(st) + (size_t)kTileK * d;
    return load4<T>(vs + (size_t)j * d + col);
  }
};

template <typename T>
struct StageInt8 {
  using Elem = int8_t;
  static constexpr int kChunkElems = 16;
  __host__ __device__ static size_t bytes(int d) {
    return 2 * (size_t)kTileK * d + 2 * sizeof(float) * kTileK;
  }
  template <typename Rows>
  __device__ static void issue(const Rows& rw, unsigned char* st,
                               const unsigned* cells, int n, int d) {
    const int chunks = d / kChunkElems;
    int8_t* kc = reinterpret_cast<int8_t*>(st);
    int8_t* vc = kc + (size_t)kTileK * d;
    float* sc = reinterpret_cast<float*>(vc + (size_t)kTileK * d);
    for (int i = threadIdx.x; i < kTileK * chunks; i += kThreads) {
      const int j = i / chunks, c = i % chunks;
      const bool ok = j < n;
      const size_t off = ok ? (size_t)cells[j] * d + c * kChunkElems : 0;
      cp_async16(kc + (size_t)j * d + swz(j, c, chunks) * kChunkElems,
                 rw.k_src() + off, ok);
      cp_async16(vc + (size_t)j * d + c * kChunkElems, rw.v_src() + off, ok);
    }
    // scales: K's for keys 0..63, then V's
    for (int i = threadIdx.x; i < 2 * kTileK; i += kThreads) {
      const int j = i % kTileK;
      const bool ok = j < n;
      const float* src = i < kTileK ? rw.k_scales() : rw.v_scales();
      cp_async4(sc + i, src + (ok ? cells[j] : 0), ok);
    }
  }
  __device__ static void k_chunk(const unsigned char* st, int j, int c, int d,
                                 float* x) {
    const int8_t* kc = reinterpret_cast<const int8_t*>(st);
    const float s = reinterpret_cast<const float*>(st + 2 * (size_t)kTileK * d)[j];
    union { uint4 u; int8_t b[16]; } codes;
    codes.u = *reinterpret_cast<const uint4*>(
        kc + (size_t)j * d + swz(j, c, d / kChunkElems) * kChunkElems);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      x[e] = to_f<T>(from_f<T>(static_cast<float>(codes.b[e]) * s));
  }
  __device__ static float4 v_quad(const unsigned char* st, int j, int col,
                                  int d) {
    const int8_t* vc = reinterpret_cast<const int8_t*>(st) + (size_t)kTileK * d;
    const float s =
        reinterpret_cast<const float*>(st + 2 * (size_t)kTileK * d)[kTileK + j];
    const char4 v = *reinterpret_cast<const char4*>(vc + (size_t)j * d + col);
    return make_float4(to_f<T>(from_f<T>(static_cast<float>(v.x) * s)),
                       to_f<T>(from_f<T>(static_cast<float>(v.y) * s)),
                       to_f<T>(from_f<T>(static_cast<float>(v.z) * s)),
                       to_f<T>(from_f<T>(static_cast<float>(v.w) * s)));
  }
};

// Bytes of the ring region: the stages, or the end-of-split reduction
// buffer (1024 / D key groups x kRows x D floats) that reuses them.
template <int kRows, typename Stage>
__host__ __device__ inline size_t ring_bytes(int d) {
  const size_t stages = kStages * Stage::bytes(d);
  const size_t red = sizeof(float) * 1024 * (size_t)kRows;
  return stages > red ? stages : red;
}

template <int kRows, typename Stage>
__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)kRows * d                 // q rows as fp32
         + ring_bytes<kRows, Stage>(d)                     // K/V ring
         + sizeof(float) * (size_t)kRows * kTileK          // probabilities
         + sizeof(float) * 3 * (size_t)kRows               // m, l, rescale
         + sizeof(unsigned) * (size_t)kSplitKeys;          // the split's cells
}

// One block: split blockIdx.x of KV head blockIdx.y of row blockIdx.z.
// part == nullptr: write out = acc / l (the grid has one split); else write
// the partial (m, l, acc) of this split to part.
template <typename T, int kRows, typename Stage, typename Rows>
__device__ void decode_split(const Rows& rw, const T* __restrict__ q,
                             T* __restrict__ out, float* __restrict__ part,
                             int d, float scale) {
  static_assert(kRows <= kThreads / 32 && kRows % 4 == 0,
                "one softmax warp per row; rows read four at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k0 = (int)blockIdx.x * kSplitKeys;
  const int n_keys = min(kSplitKeys, rw.kv_end() - k0);
  const int tid = threadIdx.x;
  const int n_rows = rw.rows();
  if (n_keys <= 0) {  // the same for the whole block: nothing to read
    // a row with no key writes 0 (with more splits, the combine does)
    if (part == nullptr)
      for (int i = tid; i < n_rows * d; i += kThreads)
        out[rw.q_off(i / d) + i % d] = from_f<T>(0.f);
    return;
  }
  const int warp = tid / 32, lane = tid % 32;
  const size_t stage_bytes = Stage::bytes(d);

  float* q_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* ring = reinterpret_cast<unsigned char*>(q_s + (size_t)kRows * d);
  float* p_s = reinterpret_cast<float*>(ring + ring_bytes<kRows, Stage>(d));
  float* m_s = p_s + (size_t)kRows * kTileK;
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  unsigned* cells = reinterpret_cast<unsigned*>(c_s + kRows);

  for (int j = tid; j < n_keys; j += kThreads) cells[j] = (unsigned)rw.cell(k0 + j);
  __syncthreads();  // cells are read by every thread's copies
  const int n_tiles = (n_keys + kTileK - 1) / kTileK;
  Stage::issue(rw, ring, cells, min(kTileK, n_keys), d);
  cp_async_commit();

  // while tile 0 is on its way (the loop's first barrier publishes these)
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    q_s[i] = r < n_rows ? to_f<T>(q[rw.q_off(r) + i % d]) : 0.f;
  }
  // rows past the group keep probability 0 and rescale 1: their
  // accumulators stay 0 and are never written
  for (int i = tid; i < kRows * kTileK; i += kThreads) p_s[i] = 0.f;
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }

  // scores: key sk of the tile, chunks sp, sp + 4, ...
  const int sk = tid / 4, sp = tid % 4;
  const int chunks = d / Stage::kChunkElems;
  // P V: columns pc..pc + 3, keys [pg * kpg, (pg + 1) * kpg) of the tile
  const int pc = 4 * (tid % (d / 4));
  const int kpg = d / 16;  // = kTileK / (1024 / d)
  const int pg = tid / (d / 4);
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const unsigned char* st = ring + (size_t)(it % kStages) * stage_bytes;
    // the next tile's copies overlap this tile's work; the stage they fill
    // was released by the __syncthreads that ended the last iteration
    if (it + 1 < n_tiles) {
      const int t1 = (it + 1) * kTileK;
      Stage::issue(rw, ring + (size_t)((it + 1) % kStages) * stage_bytes,
                   cells + t1, min(kTileK, n_keys - t1), d);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile `it` has landed
    __syncthreads();
    const int n = min(kTileK, n_keys - it * kTileK);

    // -- scores: fp32 dot, scaled after the dot ------------------------------
    {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      if (sk < n) {
        for (int c = sp; c < chunks; c += 4) {
          float x[Stage::kChunkElems];
          Stage::k_chunk(st, sk, c, d, x);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4* qr =
                reinterpret_cast<const float4*>(q_s + (size_t)r * d + c * Stage::kChunkElems);
#pragma unroll
            for (int e = 0; e < Stage::kChunkElems / 4; ++e) {
              const float4 qq = qr[e];
              s[r] += qq.x * x[4 * e] + qq.y * x[4 * e + 1] + qq.z * x[4 * e + 2] +
                      qq.w * x[4 * e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r % 4 == sp && r < n_rows) p_s[sk * kRows + r] = s[r] * scale;
    }
    __syncthreads();

    // -- online softmax, one warp per row ------------------------------------
    if (warp < n_rows) {
      const int r = warp;
      const int c0 = lane, c1 = lane + 32;
      const bool ok0 = c0 < n, ok1 = c1 < n;
      const float s0 = ok0 ? p_s[c0 * kRows + r] : kNegInf;
      const float s1 = ok1 ? p_s[c1 * kRows + r] : kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      // the PV product reads the probabilities in q's dtype
      p_s[c0 * kRows + r] = to_f<T>(from_f<T>(p0));
      p_s[c1 * kRows + r] = to_f<T>(from_f<T>(p1));
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // -- acc = acc * rescale + P @ V -----------------------------------------
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float corr = c_s[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= corr;
    }
    const int j_end = min(n, (pg + 1) * kpg);
    for (int j = pg * kpg; j < j_end; ++j) {
      const float4 v = Stage::v_quad(st, j, pc, d);
      const float4* pj = reinterpret_cast<const float4*>(p_s + j * kRows);
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        const float4 p4 = pj[r4];  // rows 4 r4 .. 4 r4 + 3 of key j
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[4 * r4 + i];
          a[0] += p[i] * v.x;
          a[1] += p[i] * v.y;
          a[2] += p[i] * v.z;
          a[3] += p[i] * v.w;
        }
      }
    }
    __syncthreads();  // the next tile's copies overwrite this stage
  }
  cp_async_wait<0>();  // the last (empty) group

  // -- sum the key groups in order, then write ---------------------------------
  float* red = reinterpret_cast<float*>(ring);  // [1024 / d][kRows][d]
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float4*>(red + ((size_t)pg * kRows + r) * d + pc) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int groups = 1024 / d;
  const size_t prow0 = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                        blockIdx.x) * n_rows;  // this split's row 0 in part
  const size_t part_rows = (size_t)gridDim.z * gridDim.y * gridDim.x * n_rows;
  for (int i = tid; i < n_rows * d; i += kThreads) {
    const int r = i / d, col = i % d;
    float sum = red[(size_t)r * d + col];
    for (int g = 1; g < groups; ++g) sum += red[((size_t)g * kRows + r) * d + col];
    if (part == nullptr) {
      const float l = l_s[r];
      out[rw.q_off(r) + col] = from_f<T>(sum / (l == 0.f ? 1.f : l));
    } else {
      part[(prow0 + r) * d + col] = sum;
      if (col == 0) {
        part[part_rows * d + prow0 + r] = m_s[r];
        part[part_rows * (d + 1) + prow0 + r] = l_s[r];
      }
    }
  }
}

// Merge the partials of decode_split over the live splits of each (row,
// KV head): grid (kv_heads, batch), (splits + 1) x groups floats of shared
// memory. stop and the live splits are computed as the split blocks
// computed them. The weights e^(m_s - m) and l are taken once per row; the
// element loop's loads do not depend on each other, so they are unrolled.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ kv_lens, T* __restrict__ out,
                      int heads, int groups, int d, int sweep, int splits) {
  extern __shared__ float w_s[];  // [live][groups] weights, then [groups] l
  const int kh = blockIdx.x, b = blockIdx.y;
  const int kv_heads = gridDim.x;
  const int stop = max(0, min(kv_lens[b], sweep));
  const int live = (stop + kSplitKeys - 1) / kSplitKeys;
  const size_t part_rows = (size_t)gridDim.y * kv_heads * splits * groups;
  const float* p_m = part + part_rows * d;
  const float* p_l = p_m + part_rows;
  const size_t row0 = ((size_t)b * kv_heads + kh) * splits * groups;
  float* l_s = w_s + (size_t)live * groups;
  for (int r = threadIdx.x; r < groups && live > 0; r += kThreads) {
    float m = p_m[row0 + r];
#pragma unroll 8
    for (int s = 1; s < live; ++s)
      m = fmaxf(m, p_m[row0 + (size_t)s * groups + r]);
    // the split that holds the max weighs exactly 1, so a lone live split
    // gives acc / l, the one-split result
    float l = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t pr = row0 + (size_t)s * groups + r;
      const float w = p_m[pr] == m ? 1.f : expf(p_m[pr] - m);
      w_s[s * groups + r] = w;
      l = s == 0 ? p_l[pr] * w : l + p_l[pr] * w;
    }
    l_s[r] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < groups * d; i += kThreads) {
    const int r = i / d, col = i % d;
    float res = 0.f;
    if (live > 0) {
      const float* acc = part + (row0 + r) * d + col;
      float num = acc[0] * w_s[r];
#pragma unroll 4
      for (int s = 1; s < live; ++s)
        num += acc[(size_t)s * groups * d] * w_s[s * groups + r];
      const float l = l_s[r];
      res = l == 0.f ? 0.f : num / l;
    }
    out[((size_t)b * heads + kh * groups + r) * d + col] = from_f<T>(res);
  }
}

// Launch `kernel(args...)` over the grid (splits, kv_heads, batch), then,
// with more than one split, decode_combine_kernel over the partials in
// `part`: one kernel for one split, two for more, from one entry point.
template <typename T, typename Kernel, typename... Args>
inline int launch_split(Kernel kernel, size_t smem, int splits, int kv_heads,
                        int batch, const float* part, const int* kv_lens,
                        T* out, int heads, int d, int sweep,
                        cudaStream_t stream, Args... args) {
  const int rc = launch(kernel, dim3(splits, kv_heads, batch), smem, stream,
                        args...);
  if (rc != 0 || splits == 1) return rc;
  const int groups = heads / kv_heads;
  const size_t w_bytes = sizeof(float) * (size_t)(splits + 1) * groups;
  return launch(decode_combine_kernel<T>, dim3(kv_heads, batch), w_bytes,
                stream, part, kv_lens, out, heads, groups, d, sweep, splits);
}

}  // namespace dec
}  // namespace llmlb
