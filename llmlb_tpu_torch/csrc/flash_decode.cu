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
// What bounds it on an H100: bytes, as paged_decode.cu. Each row reads
// kv_len * K * D * 2 elements of the cache once and does G multiply-adds per
// element read (G = 4 for Llama-3-8B), far below the ~295 ops/byte line.
//
// Design: paged_decode.cu's block with the block table replaced by the
// slot's own contiguous row: one block per (KV head, slot) holding the G
// query rows of that head, so every K/V element is read from device memory
// once, staged 64 positions a tile with 16-byte loads (StagePlain). Cells
// past kv_len, or past the sweep, are never read.
#include "attention_common.cuh"

namespace llmlb {
namespace {

template <typename T>
struct DenseDecodeRows {
  const T* k_cache;
  const T* v_cache;
  int heads, kv_heads, d, groups, s_len;
  int b, kh, kv_stop;

  __device__ int rows() const { return groups; }
  __device__ bool row_valid(int) const { return true; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  __device__ bool allowed(int, int) const { return true; }
  __device__ size_t cell(int c) const {
    return (((size_t)b * s_len + c) * kv_heads + kh) * d;
  }
  __device__ const T* k_row(int c) const { return k_cache + cell(c); }
  __device__ const T* v_row(int c) const { return v_cache + cell(c); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int heads, int kv_heads, int d, int s_len, int sweep,
                    float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], sweep));
  DenseDecodeRows<T> rw{k_cache, v_cache, heads, kv_heads, d,
                        heads / kv_heads, s_len, b, (int)blockIdx.y, stop};
  attend_block<T, kDecodeRows>(rw, q, out, d, scale);
}

template <typename T>
int run(const void* q, const void* k_cache, const void* v_cache,
        const void* kv_lens, void* out, int batch, int heads, int kv_heads,
        int d, int s_len, int sweep, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > kDecodeRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(1, kv_heads, batch);
  return launch(flash_decode_kernel<T>, grid, smem_bytes<T>(groups, d),
                stream, static_cast<const T*>(q),
                static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
                static_cast<const int*>(kv_lens), static_cast<T*>(out), heads,
                kv_heads, d, s_len, sweep, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int llmlb_flash_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const void* kv_lens,
                                  void* out, int batch, int heads,
                                  int kv_heads, int d, int s_len, int sweep,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_cache, v_cache, kv_lens, out, batch, heads,
                             kv_heads, d, s_len, sweep, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_cache, v_cache, kv_lens, out, batch,
                                     heads, kv_heads, d, s_len, sweep, scale,
                                     s);
  return (int)cudaErrorInvalidValue;
}
