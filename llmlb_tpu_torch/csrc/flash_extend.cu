// Chunked-prefill attention over the dense slot cache: T contiguous queries
// per row attend causally over that row's cached keys.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `flash_extend` (the Pallas
// TPU kernel `_extend_kernel`).
//
// Query i of row b sits at position start_pos[b] + i and sees key positions
// j <= start_pos[b] + i of the row k_cache[b] (the chunk's own K/V were
// written there before the call). q [B, T, H, D]; k_cache, v_cache
// [B, S, K, D]; start_pos, chunk_lens [B] int32. Only rows i < chunk_lens[b]
// are defined; query tiles made wholly of padding write zeros.
//
// What bounds it on an H100: as paged_extend.cu, bytes for a chunk at the
// start of a prompt (about 205 ops/byte for a 512-token chunk at position 0)
// and operations from a start of a few hundred tokens on (about 700 ops/byte
// for the last chunk of a 1500-token prompt): ~0.01 ms either way at the
// engine's shapes (the H100 SXM's published 3.35 TB/s and 989 TFLOP/s at
// its 700 W limit), so the products belong on the tensor cores.
//
// Two routes, chosen by dtype in the C entry point below:
//   * bf16, head_dim 64 or 128: the tensor-core body attend_block_tc
//     (attention_tc.cuh): mma.sync m16n8k16 from swizzled shared memory,
//     P kept in registers, a 2-stage cp.async K/V ring, the mask only on the
//     tiles that reach past the chunk's first query or past kv_end, blocks
//     launched longest query tile first. With one row of 476 queries and 8
//     KV heads the 64-row blocks make 240 working blocks, about two an SM.
//     Any other bf16 head_dim is refused (the wrapper raises first).
//   * fp32 (the debug and test dtype): attend_block (attention_common.cuh) on
//     the fp32 CUDA cores; TF32 tensor cores could not meet the fp32 limit of
//     1e-4.
//
// Design: paged_extend.cu with the block-table walk replaced by the row's
// contiguous cells: one block per (query tile, KV head, batch row), TQ*G <= 64
// rows sharing each staged tile. A block sweeps keys up to its last query's
// position, so key tiles wholly in the future of the tile are never read,
// and an all-padding tile reads none.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace llmlb {
namespace {

template <typename T>
struct DenseExtendRows {
  const T* k_cache;
  const T* v_cache;
  int t_len, heads, kv_heads, d, groups, tq, s_len;
  int b, kh, q0, start, chunk_len;

  __device__ int rows() const { return tq * groups; }
  __device__ int idx(int r) const { return q0 + r / groups; }
  __device__ bool row_valid(int r) const { return idx(r) < t_len; }
  __device__ size_t q_off(int r) const {
    const int h = kh * groups + r % groups;
    return ((size_t)(b * t_len + idx(r)) * heads + h) * d;
  }
  __device__ int kv_end() const {
    if (q0 >= chunk_len) return 0;  // all-padding tile: writes zeros
    return max(0, min(start + min(q0 + tq, t_len), s_len));
  }
  __device__ bool allowed(int r, int c) const { return c <= start + idx(r); }
  __device__ int unmasked_end() const { return start + q0 + 1; }  // row 0's keys
  __device__ size_t cell(int c) const {
    return (((size_t)b * s_len + c) * kv_heads + kh) * d;
  }
  __device__ const T* k_row(int c) const { return k_cache + cell(c); }
  __device__ const T* v_row(int c) const { return v_cache + cell(c); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_extend_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ start_pos,
                    const int* __restrict__ chunk_lens, T* __restrict__ out,
                    int t_len, int heads, int kv_heads, int d, int tq,
                    int s_len, float scale) {
  const int b = blockIdx.z;
  DenseExtendRows<T> rw{k_cache, v_cache, t_len, heads, kv_heads, d,
                        heads / kv_heads, tq, s_len, b, (int)blockIdx.y,
                        (int)blockIdx.x * tq, start_pos[b], chunk_lens[b]};
  attend_block<T, kMaxRows>(rw, q, out, d, scale);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_extend_tc_kernel(const tc::bf16* __restrict__ q,
                       const tc::bf16* __restrict__ k_cache,
                       const tc::bf16* __restrict__ v_cache,
                       const int* __restrict__ start_pos,
                       const int* __restrict__ chunk_lens,
                       tc::bf16* __restrict__ out, int t_len, int heads,
                       int kv_heads, int tq, int s_len, int batch,
                       float scale) {
  const tc::TileIndex ti = tc::tile_index((t_len + tq - 1) / tq, kv_heads,
                                          batch);
  DenseExtendRows<tc::bf16> rw{k_cache, v_cache, t_len, heads, kv_heads, D,
                               heads / kv_heads, tq, s_len, ti.b, ti.kh,
                               ti.tile * tq, start_pos[ti.b],
                               chunk_lens[ti.b]};
  tc::attend_block_tc<D>(rw, q, out, scale);
}

// fp32: attend_block on the CUDA cores
int run_fp32(const void* q, const void* k_cache, const void* v_cache,
             const void* start_pos, const void* chunk_lens, void* out,
             int batch, int t_len, int heads, int kv_heads, int d, int s_len,
             float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(flash_extend_kernel<float>, grid,
                smem_bytes<float>(tq * groups, d), stream,
                static_cast<const float*>(q),
                static_cast<const float*>(k_cache),
                static_cast<const float*>(v_cache),
                static_cast<const int*>(start_pos),
                static_cast<const int*>(chunk_lens), static_cast<float*>(out),
                t_len, heads, kv_heads, d, tq, s_len, scale);
}

// bf16: the tensor-core body, instantiated for head_dim D
template <int D>
int run_bf16(const void* q, const void* k_cache, const void* v_cache,
             const void* start_pos, const void* chunk_lens, void* out,
             int batch, int t_len, int heads, int kv_heads, int s_len,
             float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > tc::kRows) return (int)cudaErrorInvalidValue;
  const int tq = tc::kRows / groups;
  const dim3 grid(((t_len + tq - 1) / tq) * kv_heads * batch);
  return tc::launch(flash_extend_tc_kernel<D>, grid, tc::smem_bytes<D>(),
                    stream, static_cast<const tc::bf16*>(q),
                    static_cast<const tc::bf16*>(k_cache),
                    static_cast<const tc::bf16*>(v_cache),
                    static_cast<const int*>(start_pos),
                    static_cast<const int*>(chunk_lens),
                    static_cast<tc::bf16*>(out), t_len, heads, kv_heads, tq,
                    s_len, batch, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32 (attend_block), 1 = bfloat16 (the tensor-core body,
// head_dim 64 or 128 only). Returns a cudaError_t (0 = launched).
extern "C" int llmlb_flash_extend(const void* q, const void* k_cache,
                                  const void* v_cache, const void* start_pos,
                                  const void* chunk_lens, void* out, int batch,
                                  int t_len, int heads, int kv_heads, int d,
                                  int s_len, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run_fp32(q, k_cache, v_cache, start_pos, chunk_lens, out,
                           batch, t_len, heads, kv_heads, d, s_len, scale, s);
  if (dtype == 1 && d == 64)
    return llmlb::run_bf16<64>(q, k_cache, v_cache, start_pos, chunk_lens, out,
                               batch, t_len, heads, kv_heads, s_len, scale, s);
  if (dtype == 1 && d == 128)
    return llmlb::run_bf16<128>(q, k_cache, v_cache, start_pos, chunk_lens,
                                out, batch, t_len, heads, kv_heads, s_len,
                                scale, s);
  return (int)cudaErrorInvalidValue;
}
