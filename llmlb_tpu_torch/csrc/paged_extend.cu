// Paged chunked-prefill attention: T contiguous queries per row attend
// causally over that row's pages.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `paged_flash_extend` (the
// Pallas TPU kernel `_paged_extend_kernel`).
//
// Query i of row b sits at position start_pos[b] + i and sees logical key
// positions j <= start_pos[b] + i; position j lives in pool page
// block_tables[b, j / PS] at offset j % PS (the chunk's own K/V were written
// there before the call). q [B, T, H, D]; pools [P, PS, K, D]; block_tables
// [B, PPN]; start_pos, chunk_lens [B] int32. Only rows i < chunk_lens[b] are
// defined; query tiles made wholly of padding write zeros and read no key.
//
// What bounds it on an H100: operations at serving shapes. A 512-token chunk
// at position S0 does about 4 * H * D * 512 * (S0 + 256) operations against
// (S0 + 512) * K * D * 2 elements of KV plus 512 * H * D * 2 of q and out:
// about 205 ops/byte at S0 = 0 and above the ~295 ops/byte line of bf16
// tensor cores from S0 of a few hundred on (the last 476-token chunk of a
// 1500-token prompt, at 1024, does 9.9e9 operations: 0.010 ms at the H100
// SXM's published 989 TFLOP/s and 700 W). So the products belong on the
// tensor cores and the page-table walk off the copies' critical path.
//
// Two routes, chosen by dtype in the C entry point below:
//   * bf16, head_dim 64 or 128: the tensor-core body attend_block_tc
//     (attention_tc.cuh: mma.sync m16n8k16 from swizzled shared memory, P
//     in registers, a 2-stage cp.async K/V ring, the mask only on the
//     diagonal and last tiles, blocks launched longest query tile first)
//     with the StageTcPaged policy. A 64-key tile's rows are found through
//     the block table ONCE PER TILE when 64 divides the page size: the tile
//     then lies in one page (the engine's 128-token page is two tiles), and
//     its rows are K cells apart, so a tile costs one dependent table load
//     before its cp.async copies issue instead of one per 16-byte chunk
//     (2 x D / 8 = 32 a key at D = 128). Smaller or odd pages read one table
//     entry per key row. Shared memory 80 KB a block at D = 128, two blocks
//     (eight warps) an SM. It runs the same body on the same bf16 tiles as
//     flash_extend.cu, so it gives flash_extend's bits over a dense row that
//     holds the same keys. Any other bf16 head_dim is refused (the wrapper
//     raises first).
//   * fp32 (the debug and test dtype): attend_block (attention_common.cuh)
//     on the fp32 CUDA cores; TF32 tensor cores could not meet the fp32
//     limit of 1e-4.
//
// Design: one block per (query tile, KV head, batch row), TQ*G <= 64 rows
// sharing each staged tile. A block sweeps keys up to its last query's
// position, so key pages wholly in the future of the tile are never read.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace llmlb {
namespace {

template <typename T>
struct ExtendRows {
  const T* k_pages;
  const T* v_pages;
  const int* tables;
  int t_len, heads, kv_heads, d, groups, tq, page_size, ppn;
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
    return min(start + min(q0 + tq, t_len), ppn * page_size);
  }
  __device__ bool allowed(int r, int c) const { return c <= start + idx(r); }
  __device__ int unmasked_end() const { return start + q0 + 1; }  // row 0's keys
  // index of the (position c, head kh) cell in [P, PS, K]
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return ((size_t)page * page_size + c % page_size) * kv_heads + kh;
  }
  __device__ const T* k_row(int c) const { return k_pages + cell(c) * d; }
  __device__ const T* v_row(int c) const { return v_pages + cell(c) * d; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_extend_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ start_pos,
                    const int* __restrict__ chunk_lens, T* __restrict__ out,
                    int t_len, int heads, int kv_heads, int d, int tq,
                    int page_size, int ppn, float scale) {
  const int b = blockIdx.z;
  ExtendRows<T> rw{k_pages, v_pages, tables, t_len, heads, kv_heads, d,
                   heads / kv_heads, tq, page_size, ppn, b, (int)blockIdx.y,
                   (int)blockIdx.x * tq, start_pos[b], chunk_lens[b]};
  attend_block<T, kMaxRows>(rw, q, out, d, scale);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
paged_extend_tc_kernel(const tc::bf16* __restrict__ q,
                       const tc::bf16* __restrict__ k_pages,
                       const tc::bf16* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ start_pos,
                       const int* __restrict__ chunk_lens,
                       tc::bf16* __restrict__ out, int t_len, int heads,
                       int kv_heads, int tq, int page_size, int ppn, int batch,
                       float scale) {
  const tc::TileIndex ti = tc::tile_index((t_len + tq - 1) / tq, kv_heads,
                                          batch);
  ExtendRows<tc::bf16> rw{k_pages, v_pages, tables, t_len, heads, kv_heads, D,
                          heads / kv_heads, tq, page_size, ppn, ti.b, ti.kh,
                          ti.tile * tq, start_pos[ti.b], chunk_lens[ti.b]};
  tc::attend_block_tc<D, tc::StageTcPaged>(rw, q, out, scale);
}

// fp32: attend_block on the CUDA cores
int run_fp32(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* start_pos, const void* chunk_lens,
             void* out, int batch, int t_len, int heads, int kv_heads, int d,
             int page_size, int ppn, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(paged_extend_kernel<float>, grid,
                smem_bytes<float>(tq * groups, d), stream,
                static_cast<const float*>(q),
                static_cast<const float*>(k_pages),
                static_cast<const float*>(v_pages),
                static_cast<const int*>(tables),
                static_cast<const int*>(start_pos),
                static_cast<const int*>(chunk_lens), static_cast<float*>(out),
                t_len, heads, kv_heads, d, tq, page_size, ppn, scale);
}

// bf16: the tensor-core body with the paged stage, for head_dim D
template <int D>
int run_bf16(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* start_pos, const void* chunk_lens,
             void* out, int batch, int t_len, int heads, int kv_heads,
             int page_size, int ppn, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > tc::kRows) return (int)cudaErrorInvalidValue;
  const int tq = tc::kRows / groups;
  const dim3 grid(((t_len + tq - 1) / tq) * kv_heads * batch);
  return tc::launch(paged_extend_tc_kernel<D>, grid,
                    tc::smem_bytes<D, tc::StageTcPaged>(), stream,
                    static_cast<const tc::bf16*>(q),
                    static_cast<const tc::bf16*>(k_pages),
                    static_cast<const tc::bf16*>(v_pages),
                    static_cast<const int*>(tables),
                    static_cast<const int*>(start_pos),
                    static_cast<const int*>(chunk_lens),
                    static_cast<tc::bf16*>(out), t_len, heads, kv_heads, tq,
                    page_size, ppn, batch, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32 (attend_block), 1 = bfloat16 (the tensor-core body,
// head_dim 64 or 128 only). Returns a cudaError_t (0 = launched).
extern "C" int llmlb_paged_flash_extend(const void* q, const void* k_pages,
                                        const void* v_pages, const void* tables,
                                        const void* start_pos,
                                        const void* chunk_lens, void* out,
                                        int batch, int t_len, int heads,
                                        int kv_heads, int d, int page_size,
                                        int ppn, float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run_fp32(q, k_pages, v_pages, tables, start_pos, chunk_lens,
                           out, batch, t_len, heads, kv_heads, d, page_size,
                           ppn, scale, s);
  if (dtype == 1 && d == 64)
    return llmlb::run_bf16<64>(q, k_pages, v_pages, tables, start_pos,
                               chunk_lens, out, batch, t_len, heads, kv_heads,
                               page_size, ppn, scale, s);
  if (dtype == 1 && d == 128)
    return llmlb::run_bf16<128>(q, k_pages, v_pages, tables, start_pos,
                                chunk_lens, out, batch, t_len, heads, kv_heads,
                                page_size, ppn, scale, s);
  return (int)cudaErrorInvalidValue;
}
