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
// line of bf16 tensor cores; the line is crossed near n = 740. Either way the
// bound is ~0.01 ms for the engine's 8 x 512 bucket (the H100 SXM's published
// 3.35 TB/s and 989 TFLOP/s at its 700 W limit), so what the kernel must do
// about it is keep the products on the tensor cores and the K/V copies off
// their critical path.
//
// Two routes, chosen by dtype in the C entry point below:
//   * bf16, head_dim 64 or 128: the tensor-core body attend_block_tc
//     (attention_tc.cuh): mma.sync m16n8k16 from swizzled shared memory,
//     P kept in registers, a 2-stage cp.async K/V ring, the mask only on the
//     diagonal and last tiles, blocks launched longest query tile first. Any
//     other bf16 head_dim is refused (the wrapper raises before the launch).
//   * fp32 (the debug and test dtype): attend_block (attention_common.cuh) on
//     the fp32 CUDA cores; TF32 tensor cores could not meet the fp32 limit of
//     1e-4.
//
// Design: one block per (tile of query positions, KV head, batch row). The
// G query heads of the group and TQ positions fold into TQ*G <= 64 rows that
// share every staged K/V tile (the Pallas kernel folds the group the same
// way). A block sweeps keys [0, min(q_tile_end, prompt_len)): key tiles wholly
// in the future of the query tile, or past the prompt, are never loaded.
#include "attention_common.cuh"
#include "attention_tc.cuh"

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
  __device__ int unmasked_end() const { return q0 + 1; }  // row 0 sees [0, q0]
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

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_prefill_tc_kernel(const tc::bf16* __restrict__ q,
                        const tc::bf16* __restrict__ k,
                        const tc::bf16* __restrict__ v,
                        const int* __restrict__ prompt_lens,
                        tc::bf16* __restrict__ out, int t_len, int heads,
                        int kv_heads, int tq, int batch, float scale) {
  const tc::TileIndex ti = tc::tile_index((t_len + tq - 1) / tq, kv_heads,
                                          batch);
  PrefillRows<tc::bf16> rw{k, v, t_len, heads, kv_heads, D, heads / kv_heads,
                           tq, ti.b, ti.kh, ti.tile * tq, prompt_lens[ti.b]};
  tc::attend_block_tc<D>(rw, q, out, scale);
}

// fp32: attend_block on the CUDA cores
int run_fp32(const void* q, const void* k, const void* v,
             const void* prompt_lens, void* out, int batch, int t_len,
             int heads, int kv_heads, int d, float scale,
             cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(flash_prefill_kernel<float>, grid,
                smem_bytes<float>(tq * groups, d), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const int*>(prompt_lens), static_cast<float*>(out),
                t_len, heads, kv_heads, d, tq, scale);
}

// bf16: the tensor-core body, instantiated for head_dim D
template <int D>
int run_bf16(const void* q, const void* k, const void* v,
             const void* prompt_lens, void* out, int batch, int t_len,
             int heads, int kv_heads, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > tc::kRows) return (int)cudaErrorInvalidValue;
  const int tq = tc::kRows / groups;
  const dim3 grid(((t_len + tq - 1) / tq) * kv_heads * batch);
  return tc::launch(flash_prefill_tc_kernel<D>, grid, tc::smem_bytes<D>(),
                    stream, static_cast<const tc::bf16*>(q),
                    static_cast<const tc::bf16*>(k),
                    static_cast<const tc::bf16*>(v),
                    static_cast<const int*>(prompt_lens),
                    static_cast<tc::bf16*>(out), t_len, heads, kv_heads, tq,
                    batch, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32 (attend_block), 1 = bfloat16 (the tensor-core body,
// head_dim 64 or 128 only). Returns a cudaError_t (0 = launched).
extern "C" int llmlb_flash_prefill(const void* q, const void* k, const void* v,
                                   const void* prompt_lens, void* out, int batch,
                                   int t_len, int heads, int kv_heads, int d,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run_fp32(q, k, v, prompt_lens, out, batch, t_len, heads,
                           kv_heads, d, scale, s);
  if (dtype == 1 && d == 64)
    return llmlb::run_bf16<64>(q, k, v, prompt_lens, out, batch, t_len, heads,
                               kv_heads, scale, s);
  if (dtype == 1 && d == 128)
    return llmlb::run_bf16<128>(q, k, v, prompt_lens, out, batch, t_len,
                                heads, kv_heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
