// Ragged one-token GQA decode attention over the dense slot cache.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `flash_decode` (the Pallas
// TPU kernel `_decode_kernel`).
//
// Computes out[b, h] = softmax_j(q[b,h] . K[b,j] * D^-0.5) V[b,j] over
// positions j < min(kv_lens[b], sweep), where K[b, j] is position j of slot
// b's row of the cache [B, S, K, D]. q [B, H, D]; kv_lens [B] int32. The
// caller passes sweep = max(min(128, S), min(window, S)) (S without a
// window), the Pallas kernel's bound: rows with kv_lens[b] <= sweep are
// exact; longer rows (parked or freed slots) attend over the swept cells
// only, and the caller discards them.
//
// What bounds it on an H100: bytes. Each row reads kv_len * K * D * 2
// elements of the cache once and does G multiply-adds per element read (G =
// 4 for Llama-3-8B), far below the ~295 ops/byte line.
//
// Design: the split-K decode body of attention_decode.cuh with the slot's
// own contiguous row as the cell map (StagePlain: K and V rows copied as
// they are by cp.async): one block per (split of kSplitKeys keys, KV head,
// slot), the G query rows of the head, and a combine kernel when the sweep
// is longer than one split. Cells past kv_len, or past the sweep, are never
// read.
#include "attention_decode.cuh"

namespace llmlb {
namespace {

template <typename T>
struct DenseDecodeRows {
  const T* k_cache;
  const T* v_cache;
  int heads, kv_heads, d, groups, s_len;
  int b, kh, kv_stop;

  __device__ int rows() const { return groups; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  __device__ size_t cell(int c) const {
    return ((size_t)b * s_len + c) * kv_heads + kh;
  }
  __device__ const T* k_src() const { return k_cache; }
  __device__ const T* v_src() const { return v_cache; }
};

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ part, int heads, int kv_heads, int d,
                    int s_len, int sweep, float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], sweep));
  DenseDecodeRows<T> rw{k_cache, v_cache, heads, kv_heads, d,
                        heads / kv_heads, s_len, b, (int)blockIdx.y, stop};
  dec::decode_split<T, kRows, dec::StagePlain<T>>(rw, q, out, part, d, scale);
}

template <typename T, int kRows>
int run_rows(const void* q, const void* k_cache, const void* v_cache,
             const void* kv_lens, void* out, void* part, int batch, int heads,
             int kv_heads, int d, int s_len, int sweep, int splits,
             float scale, cudaStream_t stream) {
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  return dec::launch_split<T>(
      flash_decode_kernel<T, kRows>,
      dec::smem_bytes<kRows, dec::StagePlain<T>>(d), splits, kv_heads, batch,
      p, lens, o, heads, d, sweep, stream, static_cast<const T*>(q),
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache), lens, o,
      splits == 1 ? nullptr : p, heads, kv_heads, d, s_len, sweep, scale);
}

template <typename T>
int run(const void* q, const void* k_cache, const void* v_cache,
        const void* kv_lens, void* out, void* part, int batch, int heads,
        int kv_heads, int d, int s_len, int sweep, int splits, float scale,
        cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (d % 16 || splits != dec::n_splits(sweep) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (groups <= 4)
    return run_rows<T, 4>(q, k_cache, v_cache, kv_lens, out, part, batch,
                          heads, kv_heads, d, s_len, sweep, splits, scale,
                          stream);
  if (groups <= 8)
    return run_rows<T, 8>(q, k_cache, v_cache, kv_lens, out, part, batch,
                          heads, kv_heads, d, s_len, sweep, splits, scale,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. part: fp32 scratch of B * K * splits *
// G * (D + 2) floats when splits > 1 (else unused); splits must be
// ceil(sweep / kSplitKeys). Returns a cudaError_t (0 = launched).
extern "C" int llmlb_flash_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const void* kv_lens,
                                  void* out, void* part, int batch, int heads,
                                  int kv_heads, int d, int s_len, int sweep,
                                  int splits, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_cache, v_cache, kv_lens, out, part, batch,
                             heads, kv_heads, d, s_len, sweep, splits, scale,
                             s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_cache, v_cache, kv_lens, out, part,
                                     batch, heads, kv_heads, d, s_len, sweep,
                                     splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
