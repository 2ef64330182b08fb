// Paged chunked-prefill attention over int8 KV pools: T contiguous queries
// per row attend causally over that row's pages.
//
// Replaces: llmlb_tpu/ops/pallas_attention.py, `paged_flash_extend_quant`
// (the Pallas TPU kernel `_paged_extend_quant_kernel`).
//
// Computes what paged_extend.cu computes, over pools of int8 codes
// [P, PS, K, D] with one float32 scale per (token, head) vector [P, PS, K]:
// query i of row b at position start_pos[b] + i sees keys j <= its
// position, each K and V row dequantized in fp32 (codes * scale, read
// through the same block-table page) and rounded to q's dtype before the
// dot, as the Pallas kernel does. Only rows i < chunk_lens[b] are defined;
// query tiles made wholly of padding write zeros and read no key.
//
// What bounds it on an H100: operations at serving shapes. A 476-token chunk
// at position 1024 does 4 * H * D * (visible keys) = 9.9e9 operations at
// H = 32, D = 128 (0.010 ms at the H100 SXM's published 989 TFLOP/s and
// 700 W) against 1500 keys x K x 264 bytes of codes and scales plus q and
// out: well above the ~295 ops/byte line of bf16 tensor cores. So the
// products belong on the tensor cores; the int8 codes halve the bytes the
// copies move, and the dequantization must not cost a product's time.
//
// Two routes, chosen by q's dtype in the C entry point below:
//   * bf16 q, head_dim 64 or 128: the tensor-core body attend_block_tc
//     (attention_tc.cuh) with the StageTcInt8 policy. cp.async copies each
//     64-key tile's raw codes (64 x D bytes for K and for V) and their f32
//     scales into a 2-stage ring, addressed through the block table once per
//     tile when 64 divides the page size (else once per key row), as
//     paged_extend.cu. Once a tile has landed, one pass writes
//     bf16(float(code) * scale) into one swizzled bf16 K/V stage, and the
//     two mma.sync products run from it. Tile i + 1's copy overlaps tile i's
//     products; the dequant pass does not. Shared memory at D = 128: q 16 KB
//     + K 16 KB + V 16 KB + 2 x (codes 16 KB + scales 0.5 KB) = 81 KB a
//     block, so two blocks (eight warps) fit on an SM; a second bf16 stage
//     would make it 113 KB, one block an SM. The tiles hold exactly the
//     values dequantize_kv(codes, scales, bf16) gives, so this route gives
//     the bf16 route's bits over the dequantized pools. Any other bf16
//     head_dim is refused (the wrapper raises first).
//   * fp32 q (the debug and test dtype): attend_block<float, kMaxRows,
//     StageInt8> (attention_common.cuh) on the fp32 CUDA cores.
//
// Design: paged_extend.cu's (one block per (query tile, KV head, batch
// row), TQ*G <= 64 rows sharing each staged tile, keys swept up to the
// tile's last position).
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace llmlb {
namespace {

struct ExtendQuantRows {
  const int8_t* k_pages;
  const float* k_scales;
  const int8_t* v_pages;
  const float* v_scales;
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
  __device__ const int8_t* k_codes(int c) const { return k_pages + cell(c) * d; }
  __device__ const int8_t* v_codes(int c) const { return v_pages + cell(c) * d; }
  __device__ float k_scale(int c) const { return __ldg(k_scales + cell(c)); }
  __device__ float v_scale(int c) const { return __ldg(v_scales + cell(c)); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_extend_quant_kernel(const T* __restrict__ q,
                          const int8_t* __restrict__ k_pages,
                          const float* __restrict__ k_scales,
                          const int8_t* __restrict__ v_pages,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ tables,
                          const int* __restrict__ start_pos,
                          const int* __restrict__ chunk_lens,
                          T* __restrict__ out, int t_len, int heads,
                          int kv_heads, int d, int tq, int page_size, int ppn,
                          float scale) {
  const int b = blockIdx.z;
  ExtendQuantRows rw{k_pages, k_scales, v_pages, v_scales, tables, t_len,
                     heads, kv_heads, d, heads / kv_heads, tq, page_size, ppn,
                     b, (int)blockIdx.y, (int)blockIdx.x * tq, start_pos[b],
                     chunk_lens[b]};
  attend_block<T, kMaxRows, StageInt8>(rw, q, out, d, scale);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
paged_extend_quant_tc_kernel(const tc::bf16* __restrict__ q,
                             const int8_t* __restrict__ k_pages,
                             const float* __restrict__ k_scales,
                             const int8_t* __restrict__ v_pages,
                             const float* __restrict__ v_scales,
                             const int* __restrict__ tables,
                             const int* __restrict__ start_pos,
                             const int* __restrict__ chunk_lens,
                             tc::bf16* __restrict__ out, int t_len, int heads,
                             int kv_heads, int tq, int page_size, int ppn,
                             int batch, float scale) {
  const tc::TileIndex ti = tc::tile_index((t_len + tq - 1) / tq, kv_heads,
                                          batch);
  ExtendQuantRows rw{k_pages, k_scales, v_pages, v_scales, tables, t_len,
                     heads, kv_heads, D, heads / kv_heads, tq, page_size, ppn,
                     ti.b, ti.kh, ti.tile * tq, start_pos[ti.b],
                     chunk_lens[ti.b]};
  tc::attend_block_tc<D, tc::StageTcInt8>(rw, q, out, scale);
}

// fp32 q: attend_block on the CUDA cores
int run_fp32(const void* q, const void* k_pages, const void* k_scales,
             const void* v_pages, const void* v_scales, const void* tables,
             const void* start_pos, const void* chunk_lens, void* out,
             int batch, int t_len, int heads, int kv_heads, int d,
             int page_size, int ppn, float scale, cudaStream_t stream) {
  if (d % 16) return (int)cudaErrorInvalidValue;
  const int groups = heads / kv_heads;
  const int tq = kMaxRows / groups > 0 ? kMaxRows / groups : 1;
  const dim3 grid((t_len + tq - 1) / tq, kv_heads, batch);
  return launch(paged_extend_quant_kernel<float>, grid,
                smem_bytes<float>(tq * groups, d), stream,
                static_cast<const float*>(q),
                static_cast<const int8_t*>(k_pages),
                static_cast<const float*>(k_scales),
                static_cast<const int8_t*>(v_pages),
                static_cast<const float*>(v_scales),
                static_cast<const int*>(tables),
                static_cast<const int*>(start_pos),
                static_cast<const int*>(chunk_lens), static_cast<float*>(out),
                t_len, heads, kv_heads, d, tq, page_size, ppn, scale);
}

// bf16 q: the tensor-core body with the int8 stage, for head_dim D
template <int D>
int run_bf16(const void* q, const void* k_pages, const void* k_scales,
             const void* v_pages, const void* v_scales, const void* tables,
             const void* start_pos, const void* chunk_lens, void* out,
             int batch, int t_len, int heads, int kv_heads, int page_size,
             int ppn, float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  if (groups > tc::kRows) return (int)cudaErrorInvalidValue;
  const int tq = tc::kRows / groups;
  const dim3 grid(((t_len + tq - 1) / tq) * kv_heads * batch);
  return tc::launch(paged_extend_quant_tc_kernel<D>, grid,
                    tc::smem_bytes<D, tc::StageTcInt8>(), stream,
                    static_cast<const tc::bf16*>(q),
                    static_cast<const int8_t*>(k_pages),
                    static_cast<const float*>(k_scales),
                    static_cast<const int8_t*>(v_pages),
                    static_cast<const float*>(v_scales),
                    static_cast<const int*>(tables),
                    static_cast<const int*>(start_pos),
                    static_cast<const int*>(chunk_lens),
                    static_cast<tc::bf16*>(out), t_len, heads, kv_heads, tq,
                    page_size, ppn, batch, scale);
}

}  // namespace
}  // namespace llmlb

// dtype (of q and out): 0 = float32 (attend_block), 1 = bfloat16 (the
// tensor-core body, head_dim 64 or 128 only). Returns a cudaError_t
// (0 = launched).
extern "C" int llmlb_paged_flash_extend_quant(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* tables,
    const void* start_pos, const void* chunk_lens, void* out, int batch,
    int t_len, int heads, int kv_heads, int d, int page_size, int ppn,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run_fp32(q, k_pages, k_scales, v_pages, v_scales, tables,
                           start_pos, chunk_lens, out, batch, t_len, heads,
                           kv_heads, d, page_size, ppn, scale, s);
  if (dtype == 1 && d == 64)
    return llmlb::run_bf16<64>(q, k_pages, k_scales, v_pages, v_scales, tables,
                               start_pos, chunk_lens, out, batch, t_len, heads,
                               kv_heads, page_size, ppn, scale, s);
  if (dtype == 1 && d == 128)
    return llmlb::run_bf16<128>(q, k_pages, k_scales, v_pages, v_scales,
                                tables, start_pos, chunk_lens, out, batch,
                                t_len, heads, kv_heads, page_size, ppn, scale,
                                s);
  return (int)cudaErrorInvalidValue;
}
