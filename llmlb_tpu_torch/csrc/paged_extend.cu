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
// defined; query tiles made wholly of padding write zeros.
//
// What bounds it on an H100: operations once the chunk starts past the
// first few hundred tokens. A 512-token chunk at position S0 does about
// 4 * H * D * 512 * (S0 + 256) operations against (S0 + 512) * K * D * 2
// elements of KV plus 512 * H * D * 2 of q and out: about 205 ops/byte at
// S0 = 0 (bytes-bound, like a fresh prefill) and above the ~295 ops/byte line
// from S0 of a few hundred on (about 700 for the last chunk of a 1500-token
// prompt). Like flash_prefill.cu this version computes on the fp32 CUDA
// cores, not wgmma.
//
// Design: flash_prefill.cu's structure with K/V read through the block
// table: one block per (query tile, KV head, batch row), TQ*G <= 64 rows
// sharing each staged tile. A block sweeps keys up to its last query's
// position, so key pages wholly in the future of the tile are never read.
#include "attention_common.cuh"

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
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return (((size_t)page * page_size + c % page_size) * kv_heads + kh) * d;
  }
  __device__ const T* k_row(int c) const { return k_pages + cell(c); }
  __device__ const T* v_row(int c) const { return v_pages + cell(c); }
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

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* start_pos, const void* chunk_lens,
        void* out, int batch, int t_len, int heads, int kv_heads, int d,
        int page_size, int ppn, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(paged_extend_kernel<T>, grid, smem_bytes<T>(tq * groups, d),
                stream, static_cast<const T*>(q),
                static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
                static_cast<const int*>(tables),
                static_cast<const int*>(start_pos),
                static_cast<const int*>(chunk_lens), static_cast<T*>(out),
                t_len, heads, kv_heads, d, tq, page_size, ppn, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
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
    return llmlb::run<float>(q, k_pages, v_pages, tables, start_pos, chunk_lens,
                             out, batch, t_len, heads, kv_heads, d, page_size,
                             ppn, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_pages, v_pages, tables, start_pos,
                                     chunk_lens, out, batch, t_len, heads,
                                     kv_heads, d, page_size, ppn, scale, s);
  return (int)cudaErrorInvalidValue;
}
