// Shared tile machinery of the attention kernels: the CUDA-core block body
// `attend_block` of paged_extend.cu, paged_extend_quant.cu and the fp32
// flash_prefill.cu and flash_extend.cu, and the constants and conversions
// the tensor-core (attention_tc.cuh) and split-K decode
// (attention_decode.cuh) bodies share.
//
// One thread block owns a set of query ROWS that share one KV head: the G
// query heads of a GQA group, times a tile of query positions (the Pallas
// kernels fold the group into the row dimension the same way). The block
// walks its own key range in tiles of kTileK positions: it stages the K and V
// rows of the tile in shared memory, computes fp32 scores, runs the online
// softmax (running max m, running sum l, rescale factor per row), and adds
// P @ V into fp32 accumulators kept in registers. Nothing is carried between
// blocks, so blocks run in any order on any SM.
//
// Numerics follow ops/pallas_attention.py of the JAX package:
//   * scores are the fp32 dot product of the q and k values, multiplied by
//     scale = D^-0.5 AFTER the dot;
//   * l sums the fp32 probabilities, while the PV product uses the
//     probabilities rounded to the KV dtype (bf16 for the 8B model);
//   * a row that saw no valid key ends with l == 0 and writes 0.
// Keys that the mask rejects get probability exactly 0 (never exp(0) of a
// masked -1e30 pair), so rows with at least one valid key are exact and rows
// with none are 0.
//
// The kernel family differs only in how rows map to query positions and
// heads, where key rows live (a fresh [B, T, K, D] tensor or a paged pool
// read through a block table) and which keys a row may see. Each kernel file
// supplies that as a small "Rows" policy struct. How a tile of K and V rows
// reaches shared memory is a second policy, the "Stage": StagePlain copies
// rows of T; StageInt8 reads int8 codes and their float32 scales and writes
// the dequantized values, rounded to T, so the rest of the block body is the
// same for both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace llmlb {

constexpr int kThreads = 256;  // threads per block
constexpr int kTileK = 64;     // key positions staged per tile
constexpr int kMaxRows = 64;   // query rows per block (positions x group)
constexpr int kMaxD = 128;     // largest head_dim the kernels take
constexpr int kSStride = kTileK + 1;  // padded score row (floats)
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// Two consecutive elements of a staged K row as floats. fp32 K rows have an
// odd word stride, so they are read element by element (no 8-byte alignment).
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return make_float2(p[0], p[1]);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// K rows in shared memory are padded by one 32-bit word so that the row
// stride in words is odd: the score loop reads one row per lane, and an odd
// stride puts the 32 lanes of a warp on 32 different banks.
template <typename T> __host__ __device__ constexpr int k_stride(int d) {
  return d + static_cast<int>(4 / sizeof(T));
}

template <typename T> __host__ __device__ inline size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (size_t)rows * d                 // q rows as fp32
         + sizeof(T) * (size_t)kTileK * k_stride<T>(d)    // K tile (padded)
         + sizeof(T) * (size_t)kTileK * d                 // V tile
         + sizeof(float) * (size_t)rows * kSStride        // scores / probabilities
         + sizeof(float) * 3 * (size_t)rows;              // m, l, rescale
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Staging policies: copy the K and V rows of key positions [t0, t0 + n)
// into k_s (row stride kd elements) and v_s (row stride d). Loads are 16
// bytes wide and unrolled, so a thread's loads are in flight together
// rather than one after another.
//
// StagePlain: Rows supplies `const T* k_row(int c), v_row(int c)`, the
// D-element key / value rows of position c.
struct StagePlain {
  template <typename T, typename Rows>
  __device__ static void run(const Rows& rw, T* k_s, T* v_s, int kd, int d,
                             int t0, int n) {
    const int vec_per_row = d * (int)sizeof(T) / 16;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * vec_per_row; i += kThreads) {
      const int c = i / vec_per_row, j = i % vec_per_row;
      const uint4 kv = __ldg(reinterpret_cast<const uint4*>(rw.k_row(t0 + c)) + j);
      const uint4 vv = __ldg(reinterpret_cast<const uint4*>(rw.v_row(t0 + c)) + j);
      uint32_t* kdst = reinterpret_cast<uint32_t*>(k_s + (size_t)c * kd) + 4 * j;
      kdst[0] = kv.x;
      kdst[1] = kv.y;
      kdst[2] = kv.z;
      kdst[3] = kv.w;
      reinterpret_cast<uint4*>(v_s + (size_t)c * d)[j] = vv;
    }
  }
};

// Sixteen dequantized values rounded to T, stored at dst (4-byte aligned).
template <typename T> __device__ __forceinline__ void store16(T* dst, const float* x);
template <> __device__ __forceinline__ void store16<float>(float* dst, const float* x) {
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[e] = x[e];
}
template <> __device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst,
                                                                   const float* x) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int e = 0; e < 8; ++e) d2[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
}

// StageInt8: Rows supplies `const int8_t* k_codes(int c), v_codes(int c)`,
// the D int8 codes of position c, and `float k_scale(int c), v_scale(int c)`,
// the vector's scale, read through the same block-table page. Each thread
// loads 16 codes per 16-byte load (D / 16 loads per row) and writes
// from_f<T>(float(code) * scale) into the tile: fp32 dequant, then the round
// to q's dtype that the Pallas quant kernels do before their dots.
struct StageInt8 {
  template <typename T, typename Rows>
  __device__ static void run(const Rows& rw, T* k_s, T* v_s, int kd, int d,
                             int t0, int n) {
    const int vec_per_row = d / 16;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * vec_per_row; i += kThreads) {
      const int c = i / vec_per_row, j = i % vec_per_row;
      union { uint4 u; int8_t b[16]; } kc, vc;
      kc.u = __ldg(reinterpret_cast<const uint4*>(rw.k_codes(t0 + c)) + j);
      vc.u = __ldg(reinterpret_cast<const uint4*>(rw.v_codes(t0 + c)) + j);
      const float ks = rw.k_scale(t0 + c), vs = rw.v_scale(t0 + c);
      float kx[16], vx[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        kx[e] = static_cast<float>(kc.b[e]) * ks;
        vx[e] = static_cast<float>(vc.b[e]) * vs;
      }
      store16<T>(k_s + (size_t)c * kd + 16 * j, kx);
      store16<T>(v_s + (size_t)c * d + 16 * j, vx);
    }
  }
};

// The CUDA-core block body. kRows bounds the block's rows at compile time
// and sizes the per-thread register arrays: the prefill and extend blocks
// fill 64 rows.
// `Rows` supplies:
//   int rows()                  number of query rows of this block (<= kMaxRows)
//   bool row_valid(int r)       the row exists (last position tile may be short)
//   size_t q_off(int r)         element offset of row r in q and in out
//   int kv_end()                keys [0, kv_end) are swept
//   bool allowed(int r, int c)  key position c is visible to row r
// and what its `Stage` reads (see StagePlain and StageInt8).
template <typename T, int kRows, typename Stage = StagePlain, typename Rows>
__device__ void attend_block(const Rows& rw, const T* __restrict__ q,
                             T* __restrict__ out, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kAccPerThread = kRows * kMaxD / kThreads;
  constexpr int kScoreRowsPerThread = kRows / (kThreads / kTileK);
  static_assert(kScoreRowsPerThread >= 1, "kRows too small for the tile");
  const int n_rows = rw.rows();  // <= kRows
  const int kd = k_stride<T>(d);

  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* k_s = reinterpret_cast<T*>(q_s + (size_t)n_rows * d);
  T* v_s = k_s + (size_t)kTileK * kd;
  float* s_s = reinterpret_cast<float*>(v_s + (size_t)kTileK * d);
  float* m_s = s_s + (size_t)n_rows * kSStride;
  float* l_s = m_s + n_rows;
  float* c_s = l_s + n_rows;

  for (int i = tid; i < n_rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    q_s[i] = rw.row_valid(r) ? to_f<T>(q[rw.q_off(r) + j]) : 0.f;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Accumulator ownership: column dd of rows acc_r0 + i * acc_rstep.
  // d divides kThreads, so dd is the same for every i and each staged V value
  // is read once per thread and reused across its rows.
  const int dd = tid % d;
  const int acc_r0 = tid / d;
  const int acc_rstep = kThreads / d;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  // Score ownership: key column sc of rows s_r0 + 4 * i.
  const int sc = tid % kTileK;
  const int s_r0 = tid / kTileK;
  constexpr int s_rstep = kThreads / kTileK;

  const int kv_end = rw.kv_end();
  __syncthreads();

  for (int t0 = 0; t0 < kv_end; t0 += kTileK) {
    const int n = min(kTileK, kv_end - t0);

    // -- stage K and V rows of the tile
    Stage::template run<T>(rw, k_s, v_s, kd, d, t0, n);
    __syncthreads();

    // -- scores: fp32 dot, scaled after the dot ------------------------------
    {
      float sacc[kScoreRowsPerThread];
#pragma unroll
      for (int i = 0; i < kScoreRowsPerThread; ++i) sacc[i] = 0.f;
      if (sc < n) {
        const T* krow = k_s + (size_t)sc * kd;
        for (int j = 0; j < d; j += 2) {
          const float2 kk = load2<T>(krow + j);
#pragma unroll
          for (int i = 0; i < kScoreRowsPerThread; ++i) {
            const int r = s_r0 + s_rstep * i;
            if (r < n_rows) {
              const float* qr = q_s + (size_t)r * d + j;
              sacc[i] += qr[0] * kk.x + qr[1] * kk.y;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kScoreRowsPerThread; ++i) {
        const int r = s_r0 + s_rstep * i;
        if (r < n_rows) s_s[(size_t)r * kSStride + sc] = sacc[i] * scale;
      }
    }
    __syncthreads();

    // -- online softmax, one warp per row ------------------------------------
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      float* srow = s_s + (size_t)r * kSStride;
      const int c0 = lane, c1 = lane + 32;
      const bool ok0 = c0 < n && rw.allowed(r, t0 + c0);
      const bool ok1 = c1 < n && rw.allowed(r, t0 + c1);
      const float s0 = ok0 ? srow[c0] : kNegInf;
      const float s1 = ok1 ? srow[c1] : kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      // the PV product reads the probabilities in the KV dtype
      srow[c0] = to_f<T>(from_f<T>(p0));
      srow[c1] = to_f<T>(from_f<T>(p1));
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
    for (int i = 0; i < kAccPerThread; ++i) {
      const int r = acc_r0 + acc_rstep * i;
      if (r < n_rows) acc[i] *= c_s[r];
    }
    for (int c = 0; c < n; ++c) {
      const float vv = to_f<T>(v_s[(size_t)c * d + dd]);
#pragma unroll
      for (int i = 0; i < kAccPerThread; ++i) {
        const int r = acc_r0 + acc_rstep * i;
        if (r < n_rows) acc[i] += s_s[(size_t)r * kSStride + c] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites K, V and the scores
  }

#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int r = acc_r0 + acc_rstep * i;
    if (r < n_rows && rw.row_valid(r)) {
      const float l = l_s[r];
      out[rw.q_off(r) + dd] = from_f<T>(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

// Launch helper: opt in to more than 48 KB of dynamic shared memory, launch
// on the caller's stream, and report the launch status (a refused launch
// never runs, and a later synchronize would not report it).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace llmlb
