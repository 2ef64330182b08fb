// Causal, ragged GQA self-attention over a fresh bucketed prompt.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `flash_prefill` (the Pallas
// TPU kernel `_prefill_kernel`).
//
// Computes out[b, t, h] = softmax_j(q[b,t,h] . k[b,j,h/G] * D^-0.5) v[b,j,h/G]
// over keys j <= t and j < prompt_lens[b]; q [B, T, H, D], k/v [B, T, K, D],
// out [B, T, H, D] in q's dtype (fp32 or bf16).
//
// What bounds it on an H100: bytes at the engine's buckets, operations for
// longer prompts. A row of n tokens does 2 * H * D * n(n+1)/2 * 2 operations
// (QK and PV over the causal half) against (2 * H + 2 * K) * D * n elements
// moved (q, k, v read once, out written once): H * n / (2 * (H + K)) ops per
// byte in bf16, about 205 at n = 512 for Llama-3-8B, under the ~295 ops/byte
// line of bf16 tensor cores; the line is crossed near n = 740. This first
// version runs the dot products on the fp32 CUDA cores out of shared memory,
// not on the tensor cores (wgmma), so it sits far above either bound.
//
// Design: one block per (tile of query positions, KV head, batch row). The
// G query heads of the group and TQ positions fold into TQ*G <= 64 rows that
// share every staged K/V tile (the Pallas kernel folds the group the same
// way). A block sweeps keys [0, min(q_tile_end, prompt_len)): key tiles wholly
// in the future of the query tile, or past the prompt, are never loaded.
#include "attention_common.cuh"

namespace llmlb {
namespace {

template <typename T>
struct PrefillRows {
  const T* k;
  const T* v;
  int t_len, heads, kv_heads, d, groups, tq;
  int b, kh, q0, prompt_len;

  __device__ int rows() const { return tq * groups; }
  __device__ int pos(int r) const { return q0 + r / groups; }
  __device__ bool row_valid(int r) const { return pos(r) < t_len; }
  __device__ size_t q_off(int r) const {
    const int h = kh * groups + r % groups;
    return ((size_t)(b * t_len + pos(r)) * heads + h) * d;
  }
  __device__ int kv_end() const {
    return min(min(q0 + tq, t_len), prompt_len);  // causal and ragged skip
  }
  __device__ bool allowed(int r, int c) const { return c <= pos(r); }
  __device__ const T* k_row(int c) const {
    return k + ((size_t)(b * t_len + c) * kv_heads + kh) * d;
  }
  __device__ const T* v_row(int c) const {
    return v + ((size_t)(b * t_len + c) * kv_heads + kh) * d;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ prompt_lens,
                     T* __restrict__ out, int t_len, int heads, int kv_heads,
                     int d, int tq, float scale) {
  const int b = blockIdx.z;
  PrefillRows<T> rw{k, v, t_len, heads, kv_heads, d, heads / kv_heads, tq,
                    b, (int)blockIdx.y, (int)blockIdx.x * tq, prompt_lens[b]};
  attend_block<T, kMaxRows>(rw, q, out, d, scale);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* prompt_lens,
        void* out, int batch, int t_len, int heads, int kv_heads, int d,
        float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(flash_prefill_kernel<T>, grid, smem_bytes<T>(tq * groups, d),
                stream, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const int*>(prompt_lens),
                static_cast<T*>(out), t_len, heads, kv_heads, d, tq, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int llmlb_flash_prefill(const void* q, const void* k, const void* v,
                                   const void* prompt_lens, void* out, int batch,
                                   int t_len, int heads, int kv_heads, int d,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k, v, prompt_lens, out, batch, t_len, heads,
                             kv_heads, d, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k, v, prompt_lens, out, batch, t_len,
                                     heads, kv_heads, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
