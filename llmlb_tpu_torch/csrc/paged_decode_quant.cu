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
// Design: paged_decode.cu's (one block per (KV head, batch row), the G
// query rows of the head, the 8-row build) with the StageInt8 policy of
// attention_common.cuh: a tile's codes arrive 16 per 16-byte load, its
// scales through the same block-table page, and the tile in shared memory
// holds the dequantized values in q's dtype, so the score, softmax and PV
// code is the bf16 kernel's. Split-K and pipelined loads are later work, as
// for paged_decode.cu.
#include "attention_common.cuh"

namespace llmlb {
namespace {

struct DecodeQuantRows {
  const int8_t* k_pages;
  const float* k_scales;
  const int8_t* v_pages;
  const float* v_scales;
  const int* tables;
  int heads, kv_heads, d, groups, page_size, ppn;
  int b, kh, kv_stop;

  __device__ int rows() const { return groups; }
  __device__ bool row_valid(int) const { return true; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  __device__ bool allowed(int, int) const { return true; }
  // index of the (position c, head kh) cell in [P, PS, K]
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return ((size_t)page * page_size + c % page_size) * kv_heads + kh;
  }
  __device__ const int8_t* k_codes(int c) const { return k_pages + cell(c) * d; }
  __device__ const int8_t* v_codes(int c) const { return v_pages + cell(c) * d; }
  __device__ float k_scale(int c) const { return __ldg(k_scales + cell(c)); }
  __device__ float v_scale(int c) const { return __ldg(v_scales + cell(c)); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_quant_kernel(const T* __restrict__ q,
                          const int8_t* __restrict__ k_pages,
                          const float* __restrict__ k_scales,
                          const int8_t* __restrict__ v_pages,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens, T* __restrict__ out,
                          int heads, int kv_heads, int d, int page_size,
                          int ppn, int pages, float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], pages * page_size));
  DecodeQuantRows rw{k_pages, k_scales, v_pages, v_scales, tables, heads,
                     kv_heads, d, heads / kv_heads, page_size, ppn, b,
                     (int)blockIdx.y, stop};
  attend_block<T, kDecodeRows, StageInt8>(rw, q, out, d, scale);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* k_scales,
        const void* v_pages, const void* v_scales, const void* tables,
        const void* kv_lens, void* out, int batch, int heads, int kv_heads,
        int d, int page_size, int ppn, int pages, float scale,
        cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > kDecodeRows || d % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid(1, kv_heads, batch);
  return launch(paged_decode_quant_kernel<T>, grid, smem_bytes<T>(groups, d),
                stream, static_cast<const T*>(q),
                static_cast<const int8_t*>(k_pages),
                static_cast<const float*>(k_scales),
                static_cast<const int8_t*>(v_pages),
                static_cast<const float*>(v_scales),
                static_cast<const int*>(tables),
                static_cast<const int*>(kv_lens), static_cast<T*>(out), heads,
                kv_heads, d, page_size, ppn, pages, scale);
}

}  // namespace
}  // namespace llmlb

// dtype (of q and out): 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int llmlb_paged_flash_decode_quant(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* tables,
    const void* kv_lens, void* out, int batch, int heads, int kv_heads, int d,
    int page_size, int ppn, int pages, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_pages, k_scales, v_pages, v_scales, tables,
                             kv_lens, out, batch, heads, kv_heads, d,
                             page_size, ppn, pages, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales,
                                     tables, kv_lens, out, batch, heads,
                                     kv_heads, d, page_size, ppn, pages, scale,
                                     s);
  return (int)cudaErrorInvalidValue;
}
