// Batched grouped LoRA delta (bgmv): one adapter per batch row.
//
// Replaces: llmlb_tpu/ops/lora.py, `lora_delta_pallas` (the Pallas TPU
// kernel `_bgmv_kernel`).
//
// Computes out[b, t] = (x[b, t] @ A[idx[b]]) @ B[idx[b]] with fp32
// accumulation through both products and an fp32 output; the rank-R middle
// u = x @ A stays fp32 (it is not rounded). x [B, T, IN] and the pools
// a [N, IN, R], b [N, R, OUT] share one dtype (fp32 or bf16); idx [B] int32
// names each row's pool row, row 0 being the all-zero identity adapter, whose
// delta comes out exactly +0.0 (every sum starts at +0.0 and adds +-0.0).
//
// What bounds it on an H100: bytes. At R = 16 a bf16 element of x feeds 2R
// = 32 operations (16 per byte) and an fp32 output takes 32 (8 per byte),
// below the ~295 ops/byte of the bf16 tensor cores and even below the ~20 of
// the fp32 CUDA cores. The least it must move is x once, the factor rows the
// batch selects once (IN * R + R * OUT elements per distinct adapter) and
// the fp32 output once.
//
// Design: two kernels behind one entry point (one launch of `lora_delta`).
// The Pallas kernel holds a row's whole [IN, R] and [R, OUT] blocks in VMEM;
// at IN or OUT = 14336 that is more than a block's 227 KB of shared memory,
// so both products are tiled instead.
//  * shrink: a block takes (IN split s, a tile of kShrinkT positions, row b),
//    reads idx[b] itself (there is no scalar prefetch), and walks its share
//    of IN in chunks of kChunk: the x chunk of its positions and the
//    matching A rows (contiguous kChunk * R elements) are staged in shared
//    memory as fp32 with 16-byte loads, and each thread keeps up to
//    kShrinkT * kMaxRank / kThreads (position, rank) sums in registers. Each
//    split writes its R partial sums per position to the fp32 scratch
//    u [B, T, splits, R]. Decode (T = 1) has only B positions, so IN is split
//    across blocks to fill the card; a long T needs no split. The split
//    count depends on IN and T alone, so a row's sums do not depend on what
//    else shares its batch.
//  * expand: a block takes (a tile of kThreads output columns, kExpandT
//    positions, row b): it sums the splits of u in a fixed order into shared
//    memory, then each thread reads its column of B[idx[b]] (coalesced across
//    the block), one rank at a time, and keeps kExpandT fp32 sums in
//    registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace llmlb {
namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;      // IN elements staged per step
constexpr int kXStride = kChunk + 1;  // padded x row: positions on other banks
constexpr int kShrinkT = 32;     // positions per shrink block
constexpr int kMaxRank = 64;
constexpr int kShrinkAcc = kShrinkT * kMaxRank / kThreads;  // sums per thread
constexpr int kExpandT = 16;     // positions per expand block

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The 16 / sizeof(T) elements of one 16-byte load, as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
shrink_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const int* __restrict__ idx, float* __restrict__ u, int t_len,
              int in_dim, int rank, int splits, int split_len) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                        // [kShrinkT][kXStride]
  float* a_s = smem + kShrinkT * kXStride;  // [kChunk][rank]
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  const int s = blockIdx.x, t0 = blockIdx.y * kShrinkT, b = blockIdx.z;
  const int n_t = min(kShrinkT, t_len - t0);
  const int k_lo = s * split_len, k_hi = min(in_dim, k_lo + split_len);
  const T* a_row = a + (size_t)idx[b] * in_dim * rank;
  const T* x_row = x + ((size_t)b * t_len + t0) * in_dim;

  float acc[kShrinkAcc];
#pragma unroll
  for (int j = 0; j < kShrinkAcc; ++j) acc[j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
    const int n = min(kChunk, k_hi - k0);  // a multiple of V
    // -- stage x[b, t0 .. t0 + n_t, k0 .. k0 + n) and A[idx[b], k0 .. k0 + n, :]
    const int xv = n / V;
    for (int i = tid; i < n_t * xv; i += kThreads) {
      const int t = i / xv, j = i % xv;
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
                                x_row + (size_t)t * in_dim + k0) + j);
      float f[V];
      Vec<T>::unpack(w, f);
#pragma unroll
      for (int e = 0; e < V; ++e) x_s[t * kXStride + j * V + e] = f[e];
    }
    const int av = n * rank / V;
    const uint4* a_src = reinterpret_cast<const uint4*>(a_row + (size_t)k0 * rank);
    for (int i = tid; i < av; i += kThreads) {
      float f[V];
      Vec<T>::unpack(__ldg(a_src + i), f);
#pragma unroll
      for (int e = 0; e < V; ++e) a_s[i * V + e] = f[e];
    }
    __syncthreads();
    // -- the (position, rank) sums this thread owns
#pragma unroll
    for (int j = 0; j < kShrinkAcc; ++j) {
      const int o = tid + kThreads * j;
      const int t = o / rank, r = o % rank;
      if (t < n_t) {
        const float* xr = x_s + t * kXStride;
        float sum = acc[j];
        for (int i = 0; i < n; ++i) sum += xr[i] * a_s[i * rank + r];
        acc[j] = sum;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged tiles
  }
#pragma unroll
  for (int j = 0; j < kShrinkAcc; ++j) {
    const int o = tid + kThreads * j;
    const int t = o / rank, r = o % rank;
    if (t < n_t)
      u[(((size_t)b * t_len + t0 + t) * splits + s) * rank + r] = acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ u, const T* __restrict__ bpool,
              const int* __restrict__ idx, float* __restrict__ out, int t_len,
              int rank, int out_dim, int splits) {
  __shared__ float u_s[kExpandT * kMaxRank];
  const int tid = threadIdx.x;
  const int o = blockIdx.x * kThreads + tid;
  const int t0 = blockIdx.y * kExpandT, b = blockIdx.z;
  const int n_t = min(kExpandT, t_len - t0);
  for (int i = tid; i < n_t * rank; i += kThreads) {
    const int t = i / rank, r = i % rank;
    const float* src = u + ((size_t)b * t_len + t0 + t) * splits * rank + r;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += src[(size_t)s * rank];  // fixed order
    u_s[i] = sum;
  }
  __syncthreads();
  if (o >= out_dim) return;
  const T* b_col = bpool + (size_t)idx[b] * rank * out_dim + o;
  float acc[kExpandT];
#pragma unroll
  for (int t = 0; t < kExpandT; ++t) acc[t] = 0.f;
  for (int r = 0; r < rank; ++r) {
    const float bv = to_f<T>(b_col[(size_t)r * out_dim]);
#pragma unroll
    for (int t = 0; t < kExpandT; ++t) acc[t] += u_s[t * rank + r] * bv;
  }
  float* out_row = out + ((size_t)b * t_len + t0) * out_dim + o;
#pragma unroll
  for (int t = 0; t < kExpandT; ++t)
    if (t < n_t) out_row[(size_t)t * out_dim] = acc[t];
}

template <typename T>
int run(const void* x, const void* a, const void* bpool, const void* idx,
        void* u, void* out, int batch, int t_len, int in_dim, int rank,
        int out_dim, int splits, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  if (rank < 1 || rank > kMaxRank || in_dim % V || splits < 1)
    return (int)cudaErrorInvalidValue;
  // each split covers whole chunks (a multiple of kChunk); a split that
  // starts past IN sums nothing and writes zeros
  const int per = (in_dim + splits - 1) / splits;
  const int split_len = (per + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * ((size_t)kShrinkT * kXStride
                                       + (size_t)kChunk * rank);
  cudaError_t err = cudaFuncSetAttribute(
      shrink_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1(splits, (t_len + kShrinkT - 1) / kShrinkT, batch);
  shrink_kernel<T><<<g1, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const int*>(idx), static_cast<float*>(u), t_len, in_dim, rank,
      splits, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((out_dim + kThreads - 1) / kThreads,
                (t_len + kExpandT - 1) / kExpandT, batch);
  expand_kernel<T><<<g2, kThreads, 0, stream>>>(
      static_cast<const float*>(u), static_cast<const T*>(bpool),
      static_cast<const int*>(idx), static_cast<float*>(out), t_len, rank,
      out_dim, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. `u` is fp32 scratch of B * T * splits * R
// elements. Returns a cudaError_t (0 = both kernels launched).
extern "C" int llmlb_lora_bgmv(const void* x, const void* a, const void* b,
                               const void* idx, void* u, void* out, int batch,
                               int t_len, int in_dim, int rank, int out_dim,
                               int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(x, a, b, idx, u, out, batch, t_len, in_dim, rank,
                             out_dim, splits, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(x, a, b, idx, u, out, batch, t_len,
                                     in_dim, rank, out_dim, splits, s);
  return (int)cudaErrorInvalidValue;
}
