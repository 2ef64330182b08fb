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
// Design: one block per (KV head, batch row) holding the G query rows of that
// head, so every K/V element is read from device memory exactly once. The
// block reads the block table itself and stages 64 positions of K and V per
// tile with 16-byte loads. Pages past kv_len, and past the `pages` bound, are
// never read. The block is built with an 8-row bound (GQA groups up to 8, all
// the presets have), so a thread's loops cover its few rows and no
// predicated-off work (the 64-row build of the prefill kernels spent most of
// its issue slots on rows a decode block does not have). At 8 slots x 8 KV heads this is 64 blocks, half of the 132 SMs,
// and each block loads and computes in turn with no overlap: splitting the
// key range across blocks (split-K) and pipelining the loads are the next
// steps for this kernel.
#include "attention_common.cuh"

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
  __device__ bool row_valid(int) const { return true; }
  __device__ size_t q_off(int r) const {
    return ((size_t)b * heads + kh * groups + r) * d;
  }
  __device__ int kv_end() const { return kv_stop; }
  __device__ bool allowed(int, int) const { return true; }
  __device__ size_t cell(int c) const {
    const int page = tables[(size_t)b * ppn + c / page_size];
    return (((size_t)page * page_size + c % page_size) * kv_heads + kh) * d;
  }
  __device__ const T* k_row(int c) const { return k_pages + cell(c); }
  __device__ const T* v_row(int c) const { return v_pages + cell(c); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int heads, int kv_heads, int d, int page_size, int ppn,
                    int pages, float scale) {
  const int b = blockIdx.z;
  const int stop = max(0, min(kv_lens[b], pages * page_size));
  DecodeRows<T> rw{k_pages, v_pages, tables, heads, kv_heads, d,
                   heads / kv_heads, page_size, ppn, b, (int)blockIdx.y, stop};
  attend_block<T, kDecodeRows>(rw, q, out, d, scale);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* tables, const void* kv_lens, void* out, int batch,
        int heads, int kv_heads, int d, int page_size, int ppn, int pages,
        float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > kDecodeRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(1, kv_heads, batch);
  return launch(paged_decode_kernel<T>, grid,
                smem_bytes<T>(groups, d), stream,
                static_cast<const T*>(q), static_cast<const T*>(k_pages),
                static_cast<const T*>(v_pages), static_cast<const int*>(tables),
                static_cast<const int*>(kv_lens), static_cast<T*>(out), heads,
                kv_heads, d, page_size, ppn, pages, scale);
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int llmlb_paged_flash_decode(const void* q, const void* k_pages,
                                        const void* v_pages, const void* tables,
                                        const void* kv_lens, void* out,
                                        int batch, int heads, int kv_heads,
                                        int d, int page_size, int ppn,
                                        int pages, float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(q, k_pages, v_pages, tables, kv_lens, out, batch,
                             heads, kv_heads, d, page_size, ppn, pages, scale, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(q, k_pages, v_pages, tables, kv_lens, out,
                                     batch, heads, kv_heads, d, page_size, ppn,
                                     pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
