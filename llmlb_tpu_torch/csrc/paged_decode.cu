// Ragged paged one-token GQA decode attention.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `paged_flash_decode` (the
// Pallas TPU kernel `_paged_decode_kernel`).
//
// Computes out[b, h] = softmax_j(q[b,h] . K[j] * D^-0.5) V[j] over logical
// positions j < min(kv_lens[b], pages * PS), where position j of row b lives
// in pool page block_tables[b, j / PS] at offset j % PS. q [B, H, D]; pools
// [P, PS, K, D]; block_tables [B, PPN] int32; kv_lens [B] int32. Rows whose
// kv_lens reach past the `pages` bound attend over the swept pages only: the
// caller discards them (parked or freed slots), as with the Pallas kernel.
//
// What bounds it on an H100: bytes. Each row reads kv_len * K * D * 2 (K and
// V) elements of the pool once and does only G multiply-adds per element read
// (G = 4 for Llama-3-8B), far below the ~295 ops/byte line.
//
// Design: the split-K decode body of attention_decode.cuh with the block
// table as the cell map and the StagePlain policy, as flash_decode.cu runs it
// over the dense cache: one block per (split of kSplitKeys keys, KV head,
// row), a split's cells looked up in the block table once when the block
// starts (one table read per key, cached as unsigned cell indices: the
// wrapper refuses a pool of 2^32 (position, KV head) cells or more), K and
// V tiles copied by 16-byte cp.async into a 2-stage ring, and the combine
// kernel when the sweep holds more than one split. The same body and
// numerics as flash_decode, so a row gives the same bits through the pages
// as through the dense slot cache holding the same keys.
#include "attention_decode.cuh"

namespace llmlb {
namespace {

template <typename T>
struct DecodeRows {
  const T* k_pages;
  const T* v_pages;
  const int* tables;
  int heads, kv_heads, d, groups, page_size, ppn;
  int b, kh, kv_stop;

  __device__ int rows() const { return groups; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  // index of the (position c, head kh) vector in [P, PS, K]
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return ((size_t)page * page_size + c % page_size) * kv_heads + kh;
  }
  __device__ const T* k_src() const { return k_pages; }
  __device__ const T* v_src() const { return v_pages; }
};

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ part, int heads, int kv_heads, int d,
                    int page_size, int ppn, int sweep, float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], sweep));
  DecodeRows<T> rw{k_pages, v_pages, tables, heads, kv_heads, d,
                   heads / kv_heads, page_size, ppn, b, (int)blockIdx.y, stop};
  dec::decode_split<T, kRows, dec::StagePlain<T>>(rw, q, out, part, d, scale);
}

template <typename T, int kRows>
int run_rows(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* kv_lens, void* out, void* part,
             int batch, int heads, int kv_heads, int d, int page_size, int ppn,
             int sweep, int splits, float scale, cudaStream_t stream) {
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  return dec::launch_split<T>(
      paged_decode_kernel<T, kRows>,
      dec::smem_bytes<kRows, dec::StagePlain<T>>(d), splits, kv_heads, batch,
      p, lens, o, heads, d, sweep, stream, static_cast<const T*>(q),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), lens, o, splits == 1 ? nullptr : p,
      heads, kv_heads, d, page_size, ppn, sweep, scale);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* kv_lens, void* out, void* part,
        int batch, int heads, int kv_heads, int d, int page_size, int ppn,
        int pages, int splits, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int sweep = pages * page_size;  // keys of the swept pages
  if (d % 16 || splits != dec::n_splits(sweep) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (groups <= 4)
    return run_rows<T, 4>(q, k_pages, v_pages, tables, kv_lens, out, part,
                          batch, heads, kv_heads, d, page_size, ppn, sweep,
                          splits, scale, stream);
  if (groups <= 8)
    return run_rows<T, 8>(q, k_pages, v_pages, tables, kv_lens, out, part,
                          batch, heads, kv_heads, d, page_size, ppn, sweep,
                          splits, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. part: fp32 scratch of B * K * splits *
// G * (D + 2) floats when splits > 1 (else unused); splits must be
// ceil(pages * PS / kSplitKeys). Returns a cudaError_t (0 = launched).
extern "C" int llmlb_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages, const void* tables,
                                        const void* kv_lens, void* out,
                                        void* part, int batch, int heads,
                                        int kv_heads, int d, int page_size,
                                        int ppn, int pages, int splits,
                                        float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_pages, v_pages, tables, kv_lens, out, part,
                             batch, heads, kv_heads, d, page_size, ppn, pages,
                             splits, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_pages, v_pages, tables, kv_lens, out,
                                     part, batch, heads, kv_heads, d,
                                     page_size, ppn, pages, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
