// Ragged paged one-token GQA decode attention over int8 KV pools.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `paged_flash_decode_quant`
// (the Pallas TPU kernel `_paged_decode_quant_kernel`).
//
// Computes what paged_decode.cu computes, over pools of int8 codes
// [P, PS, K, D] with one float32 scale per (token, head) vector [P, PS, K]:
// the K and V rows of position j of row b are codes[page, off, kh, :] *
// scales[page, off, kh], page = block_tables[b, j / PS], off = j % PS,
// dequantized in fp32 and rounded to q's dtype before the dot, as the Pallas
// kernel does. Keys j < min(kv_lens[b], pages * PS) are visible; rows past
// the `pages` bound are garbage the caller discards.
//
// What bounds it on an H100: bytes. Each (position, KV head) cell is D bytes
// of codes plus a 4-byte scale, for K and V (264 bytes at D = 128, against
// 512 in bf16), and the block does G multiply-adds per dequantized element
// (G = 4 for Llama-3-8B), far below the ~295 ops/byte line.
//
// Design: the split-K decode body of attention_decode.cuh with the block
// table as the cell map and the StageInt8 policy: a split's cells are looked
// up in the block table once, when the block starts; each tile's codes
// arrive by 16-byte cp.async and its scales by 4-byte cp.async into the
// ring, and a code is dequantized (code * scale in fp32, rounded to q's
// dtype) when the score or P V loop reads it.
#include "attention_decode.cuh"

namespace llmlb {
namespace {

struct DecodeQuantRows {
  const int8_t* k_pages;
  const float* k_scale_pool;
  const int8_t* v_pages;
  const float* v_scale_pool;
  const int* tables;
  int heads, kv_heads, d, groups, page_size, ppn;
  int b, kh, kv_stop;

  __device__ int rows() const { return groups; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  // index of the (position c, head kh) cell in [P, PS, K]
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return ((size_t)page * page_size + c % page_size) * kv_heads + kh;
  }
  __device__ const int8_t* k_src() const { return k_pages; }
  __device__ const int8_t* v_src() const { return v_pages; }
  __device__ const float* k_scales() const { return k_scale_pool; }
  __device__ const float* v_scales() const { return v_scale_pool; }
};

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
paged_decode_quant_kernel(const T* __restrict__ q,
                          const int8_t* __restrict__ k_pages,
                          const float* __restrict__ k_scales,
                          const int8_t* __restrict__ v_pages,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens, T* __restrict__ out,
                          float* __restrict__ part, int heads, int kv_heads,
                          int d, int page_size, int ppn, int sweep,
                          float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], sweep));
  DecodeQuantRows rw{k_pages, k_scales, v_pages, v_scales, tables, heads,
                     kv_heads, d, heads / kv_heads, page_size, ppn, b,
                     (int)blockIdx.y, stop};
  dec::decode_split<T, kRows, dec::StageInt8<T>>(rw, q, out, part, d, scale);
}

template <typename T, int kRows>
int run_rows(const void* q, const void* k_pages, const void* k_scales,
             const void* v_pages, const void* v_scales, const void* tables,
             const void* kv_lens, void* out, void* part, int batch, int heads,
             int kv_heads, int d, int page_size, int ppn, int sweep,
             int splits, float scale, cudaStream_t stream) {
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  float* p = static_cast<float*>(part);
  return dec::launch_split<T>(
      paged_decode_quant_kernel<T, kRows>,
      dec::smem_bytes<kRows, dec::StageInt8<T>>(d), splits, kv_heads, batch,
      p, lens, o, heads, d, sweep, stream, static_cast<const T*>(q),
      static_cast<const int8_t*>(k_pages), static_cast<const float*>(k_scales),
      static_cast<const int8_t*>(v_pages), static_cast<const float*>(v_scales),
      static_cast<const int*>(tables), lens, o, splits == 1 ? nullptr : p,
      heads, kv_heads, d, page_size, ppn, sweep, scale);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* k_scales,
        const void* v_pages, const void* v_scales, const void* tables,
        const void* kv_lens, void* out, void* part, int batch, int heads,
        int kv_heads, int d, int page_size, int ppn, int pages, int splits,
        float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const int sweep = pages * page_size;  // keys of the swept pages
  if (d % 16 || splits != dec::n_splits(sweep) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (groups <= 4)
    return run_rows<T, 4>(q, k_pages, k_scales, v_pages, v_scales, tables,
                          kv_lens, out, part, batch, heads, kv_heads, d,
                          page_size, ppn, sweep, splits, scale, stream);
  if (groups <= 8)
    return run_rows<T, 8>(q, k_pages, k_scales, v_pages, v_scales, tables,
                          kv_lens, out, part, batch, heads, kv_heads, d,
                          page_size, ppn, sweep, splits, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace llmlb

// dtype (of q and out): 0 = float32, 1 = bfloat16. part: fp32 scratch of
// B * K * splits * G * (D + 2) floats when splits > 1 (else unused); splits
// must be ceil(pages * PS / kSplitKeys). Returns a cudaError_t (0 =
// launched).
extern "C" int llmlb_paged_flash_decode_quant(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* tables,
    const void* kv_lens, void* out, void* part, int batch, int heads,
    int kv_heads, int d, int page_size, int ppn, int pages, int splits,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_pages, k_scales, v_pages, v_scales, tables,
                             kv_lens, out, part, batch, heads, kv_heads, d,
                             page_size, ppn, pages, splits, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales,
                                     tables, kv_lens, out, part, batch, heads,
                                     kv_heads, d, page_size, ppn, pages,
                                     splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
