// Batched grouped LoRA delta (bgmv): one adapter per batch row, as one
// launch of a thread block cluster kernel.
//
// Replaces: llmlb_tpu/ops/lora.py, `lora_delta_pallas` (the Pallas TPU
// kernel `_bgmv_kernel`).
//
// Computes delta[b, t] = (x[b, t] @ A[idx[b]]) @ B[idx[b]] with fp32
// accumulation through both products; the rank-R middle u = x @ A stays
// fp32 (it is not rounded). x [B, T, IN] and the pools a [N, IN, R],
// b [N, R, OUT] share one dtype (fp32 or bf16); idx [B] int32 names each
// row's pool row, row 0 being the all-zero identity adapter. Two epilogues
// behind one kernel:
//   (a) out != nullptr: write delta as fp32 [B, T, OUT] (lora_delta);
//   (b) y != nullptr: add it into the projection's output y [B, T, OUT] (x's
//       dtype) in place, y = round(float(y) + float(round(delta))): bit for
//       bit what `y + delta.to(y.dtype)` gives. Every row takes the add, the
//       identity row too (its delta is +0.0 for finite x, and y + 0.0 turns
//       a -0.0 of y into +0.0, as the unfused add does).
//
// What bounds it on an H100: bytes. At R = 16 a bf16 element of x feeds 2R
// = 32 operations (16 per byte), below the ~295 ops/byte of the bf16 tensor
// cores and even below the ~20 of the fp32 CUDA cores. The least it must
// move is x once, the factor rows the batch selects once (IN * R + R * OUT
// elements per distinct adapter), and the fp32 output once, or in mode (b)
// y read and written once. At decode (B = 8, T = 1) that is a few hundred
// KB: a call is latency, so the design spends no launch and no round trip
// through device memory it can avoid.
//
// Design: one cluster of C blocks per (batch row b, tile of TT positions),
// grid (C, T tiles, B), 256 threads a block.
//  * shrink: block i of the cluster (its rank) takes slice i of IN, stages
//    the slice's x rows of its tile and the matching contiguous A rows
//    (kc IN elements a chunk) with 16-byte cp.async into a 2-stage ring in
//    shared memory. A thread keeps the sums of one position and V ranks
//    (V = 8 in bf16, 4 in fp32): for each IN element it reads one x value
//    and one 16-byte chunk of the A row, V multiply-adds for two shared
//    memory loads. When the tile has fewer than 256 such units, kp threads
//    share a unit over interleaved IN elements and are summed in a fixed
//    tree (shuffles within a warp, then the warps in order). The block's
//    partial u_i [TT, R] stays in its own shared memory;
//  * a cluster barrier; then every block reads the C partials through
//    distributed shared memory (mapa + ld.shared::cluster) and sums them in
//    rank order 0..C-1, so every block holds the same u, which never
//    reaches device memory;
//  * expand: block i takes slice i of OUT; a thread takes four consecutive
//    columns (8- or 16-byte loads of B's rows, coalesced across the block)
//    and up to kExpandPositions positions of the tile, and keeps one fp32
//    sum per position and column, over r = 0..R-1 in order (so the bits do
//    not depend on how positions are shared out); the epilogue writes (a)
//    or (b).
//  * a block does not exit before every block of its cluster has read its
//    partial (the arrive after the reads, the wait at the end).
// TT, C, the slices and the chunk are functions of (T, IN, R, OUT) and the
// dtype alone (`Plan`), so a row's bits do not depend on B or on what else
// shares its batch. A cluster has 16 blocks up to T = 128 (decode
// included), 8 at T = 256 and 4 at 512: a lone row's call then spreads
// over about 128 blocks, and a long T gets wide slices (fewer blocks re-read
// A and x per tile: 4 beat 8 and 16 at T = 512 on the card). Cluster sizes
// past 8 need cudaFuncAttributeNonPortableClusterSizeAllowed, set once per
// kernel and device with the shared-memory limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace llmlb {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 64;
constexpr int kTileT = 16;         // positions of the longest tile
constexpr int kClusterMax = 16;  // blocks of a cluster: at most (non-portable)
constexpr int kClusterMin = 4;   // and at least
constexpr int kRowBlocks = 128;  // blocks one row's call should spread over
constexpr int kStageBytes = 32 * 1024;  // x and A rows of one chunk
constexpr int kExpandPositions = 4;  // positions of a tile one expand thread keeps
constexpr int kMaxDevices = 64;

// Positions of a tile: T rounded up to a power of two, at most kTileT.
__host__ __device__ constexpr int tile_positions(int t) {
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : t <= 8 ? 8 : kTileT;
}
// Blocks of a cluster for T positions: enough for a lone row's tiles to
// spread over about kRowBlocks blocks (a power of two in [kClusterMin,
// kClusterMax]); a function of T alone, never of the batch.
__host__ __device__ constexpr int cluster_blocks(int t) {
  const int tiles = (t + tile_positions(t) - 1) / tile_positions(t);
  int c = kClusterMin;
  while (c < kClusterMax && c * tiles < kRowBlocks) c *= 2;
  return c;
}

struct Plan {
  int tt;         // positions of a tile
  int c;          // blocks of a cluster
  int in_slice;   // IN elements of a block's shrink (a multiple of V)
  int out_slice;  // OUT columns of a block's expand (a multiple of 4)
  int kc;         // IN elements of one staged chunk (a multiple of V)
  int stages;     // chunks in flight (1 when the slice is one chunk)
  size_t smem;    // dynamic shared memory of a block
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The plan of a call: T, IN, R, OUT and the element size alone.
__host__ __device__ inline Plan make_plan(int t, int in_dim, int rank,
                                          int out_dim, int esize) {
  Plan p;
  const int v = 16 / esize;  // elements of a 16-byte copy
  p.tt = tile_positions(t);
  p.c = cluster_blocks(t);
  p.in_slice = ((in_dim + p.c - 1) / p.c + v - 1) / v * v;
  p.out_slice = ((out_dim + p.c - 1) / p.c + 3) / 4 * 4;
  const int fit = kStageBytes / ((p.tt + rank) * esize) / v * v;
  p.kc = p.in_slice < fit ? p.in_slice : (fit < v ? v : fit);
  p.stages = p.in_slice > p.kc ? 2 : 1;
  p.smem = align16(sizeof(float) * (2 * (size_t)p.tt * rank + kThreads)) +
           (size_t)p.stages * (p.tt + rank) * p.kc * esize;
  return p;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

// Four consecutive values as floats (8- or 16-byte aligned), and back.
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(
    __nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The 16 / sizeof(T) values of one 16-byte chunk, as floats.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                                    float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- thread block cluster primitives (sm_90) ---------------------------------
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {  // release this block's writes
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire the others'
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float at `local` (a shared-memory address of this block) in the
// shared memory of cluster block `rank`.
__device__ __forceinline__ float load_remote(const float* local, unsigned rank) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote)
               : "memory");
  return v;
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
bgmv_cluster_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ bpool, const int* __restrict__ idx,
                    float* __restrict__ out, T* __restrict__ y, int t_len,
                    int in_dim, int rank, int out_dim, int in_slice,
                    int out_slice, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  const unsigned crank = cluster_rank();
  const unsigned c = gridDim.x;  // the cluster spans the grid's x extent
  const int t0 = blockIdx.y * TT, b = blockIdx.z;
  const int n_t = min(TT, t_len - t0);
  const int row = idx[b];
  const int n_sums = TT * rank;  // (position, rank) sums of the tile

  float* part = reinterpret_cast<float*>(smem);  // [TT][R] this block's u_i
  float* u_s = part + TT * rank;                 // [TT][R] the cluster's u
  float* red = u_s + TT * rank;                  // shrink parts of the warps
  unsigned char* ring =
      smem + align16(sizeof(float) * (2 * (size_t)TT * rank + kThreads));
  const size_t stage_bytes = (size_t)(TT + rank) * kc * sizeof(T);

  // -- shrink: u_i[t, r] = sum over this block's IN slice -----------------------
  // A unit is (position ut, ranks ur .. ur + V - 1): one 16-byte row chunk of
  // A feeds its V sums for each IN element. kp threads (a power of two, on
  // consecutive lanes) share a unit over interleaved IN elements.
  const int k_lo = min(in_dim, (int)crank * in_slice);
  const int k_hi = min(in_dim, k_lo + in_slice);
  const int n_chunks = (k_hi - k_lo + kc - 1) / kc;
  const int groups = (rank + V - 1) / V;  // rank groups of a position
  const int units = TT * groups;
  int kp = 1;
  while (2 * kp * units <= kThreads) kp *= 2;
  const int unit = tid / kp, p = tid % kp;
  const bool active = unit < units;
  const int ut = unit / groups, ur = (unit % groups) * V;
  const T* a_row = a + (size_t)row * in_dim * rank;
  const T* x_tile = x + ((size_t)b * t_len + t0) * in_dim;
  const int kcv = kc / V;

  // chunk ci into stage s: x [TT][kc] (rows past the tile zero-filled), then
  // A [kc][R], the chunk's contiguous A rows
  auto issue = [&](int ci, int s) {
    T* xs = reinterpret_cast<T*>(ring + (size_t)s * stage_bytes);
    T* as = xs + (size_t)TT * kc;
    const int k0 = k_lo + ci * kc;
    const int nv = min(kc, k_hi - k0) / V;
    for (int i = tid; i < TT * kcv; i += kThreads) {
      const int t = i / kcv, j = i % kcv;
      const bool ok = t < n_t && j < nv;
      cp_async16(xs + (size_t)t * kc + j * V,
                 ok ? x_tile + (size_t)t * in_dim + k0 + j * V : x, ok);
    }
    const T* src = a_row + (size_t)k0 * rank;
    for (int i = tid; i < nv * rank; i += kThreads)
      cp_async16(as + (size_t)i * V, src + (size_t)i * V, true);
  };

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (n_chunks > 0) issue(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    // the next chunk's copies overlap this chunk's sums; the stage they
    // fill was released by the barrier that ended the last iteration
    if (ci + 1 < n_chunks) issue(ci + 1, (ci + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: chunk ci has landed
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(ring + (size_t)(ci % 2) * stage_bytes);
    const T* xr = xs + (size_t)ut * kc;
    const T* ar = xs + (size_t)TT * kc + ur;
    const int n = min(kc, k_hi - (k_lo + ci * kc));
    if (active && rank % V == 0) {  // whole 16-byte chunks of A rows
      for (int k = p; k < n; k += kp) {
        const float xv = to_f<T>(xr[k]);
        float av[V];
        unpack16<T>(*reinterpret_cast<const uint4*>(ar + (size_t)k * rank), av);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += xv * av[e];
      }
    } else if (active) {  // a rank group may end past R
      for (int k = p; k < n; k += kp) {
        const float xv = to_f<T>(xr[k]);
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (ur + e < rank) acc[e] += xv * to_f<T>(ar[(size_t)k * rank + e]);
      }
    }
    __syncthreads();  // the next chunk's copies overwrite this stage
  }
  cp_async_wait<0>();  // the last (empty) group

  // sum a unit's kp parts in a fixed tree: a butterfly over its lanes (every
  // lane ends with the same bits), then its warps in order
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    if (off < kp) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
  }
  if (kp <= 32) {
    if (active && p == 0)
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (ur + e < rank) part[ut * rank + ur + e] = acc[e];
  } else {
    const int wpu = kp / 32;  // warps of a unit
    if (active && p % 32 == 0)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(unit * wpu + p / 32) * V + e] = acc[e];
    __syncthreads();
    for (int o = tid; o < units * V; o += kThreads) {
      const int un = o / V, e = o % V, r = (un % groups) * V + e;
      if (r >= rank) continue;
      float sum = red[un * wpu * V + e];
      for (int w = 1; w < wpu; ++w) sum += red[(un * wpu + w) * V + e];
      part[(un / groups) * rank + r] = sum;
    }
  }

  // -- u = sum of the cluster's partials, in rank order --------------------------
  cluster_arrive();  // this block's partial is written
  cluster_wait();    // and every other block's
  for (int o = tid; o < n_sums; o += kThreads) {
    float v[kClusterMax];  // every load issued before the first add
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      v[q] = q < (int)c ? load_remote(part + o, q) : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kClusterMax; ++q)
      if (q < (int)c) sum += v[q];
    u_s[o] = sum;
  }
  cluster_arrive();  // done reading the others' partials
  __syncthreads();   // u_s is read by every thread

  // -- expand: four columns and EP positions of this block's OUT slice a
  // thread; the PG threads of a column group read the same B rows ----------
  constexpr int EP = TT < kExpandPositions ? TT : kExpandPositions;
  constexpr int PG = TT / EP;
  const int o_lo = min(out_dim, (int)crank * out_slice);
  const int o_hi = min(out_dim, o_lo + out_slice);
  const int n_items = (o_hi - o_lo) / 4 * PG;
  const T* b_row = bpool + (size_t)row * rank * out_dim;
  for (int item = tid; item < n_items; item += kThreads) {
    const int o0 = o_lo + 4 * (item / PG);
    const int tb = (item % PG) * EP;  // the item's first position
    if (tb >= n_t) continue;
    float s[EP][4];
#pragma unroll
    for (int t = 0; t < EP; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll 8
    for (int r = 0; r < rank; ++r) {
      const float4 bv = load4<T>(b_row + (size_t)r * out_dim + o0);
#pragma unroll
      for (int t = 0; t < EP; ++t) {
        const float u = u_s[(tb + t) * rank + r];
        s[t][0] += u * bv.x;
        s[t][1] += u * bv.y;
        s[t][2] += u * bv.z;
        s[t][3] += u * bv.w;
      }
    }
#pragma unroll
    for (int t = 0; t < EP; ++t) {
      if (tb + t >= n_t) break;
      const size_t off = ((size_t)b * t_len + t0 + tb + t) * out_dim + o0;
      if (y == nullptr) {
        *reinterpret_cast<float4*>(out + off) =
            make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
      } else {
        const float4 yv = load4<T>(y + off);
        // round the delta to y's dtype, add in fp32, round once more
        store4<T>(y + off,
                  make_float4(yv.x + to_f<T>(from_f<T>(s[t][0])),
                              yv.y + to_f<T>(from_f<T>(s[t][1])),
                              yv.z + to_f<T>(from_f<T>(s[t][2])),
                              yv.w + to_f<T>(from_f<T>(s[t][3]))));
      }
    }
  }
  cluster_wait();  // no block leaves while another may read its partial
}

// Set the kernel's shared-memory limit and, for 16-block clusters, the
// non-portable cluster size: once per kernel and device, not per call.
template <typename T, int TT>
cudaError_t configure() {
  static bool done[kMaxDevices] = {};  // one flag array per kernel
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  // the largest plan: two stages of kStageBytes and the sums of a 16-position
  // tile at rank 64
  const int smem = (int)(align16(sizeof(float) * (2 * kTileT * kMaxRank + kThreads)) +
                         2 * kStageBytes + 2 * 16 * (kTileT + kMaxRank));
  auto kernel = bgmv_cluster_kernel<T, TT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <typename T, int TT>
int launch_tt(const Plan& pl, const void* x, const void* a, const void* bpool,
              const void* idx, void* out, void* y, int batch, int t_len,
              int in_dim, int rank, int out_dim, cudaStream_t stream) {
  auto kernel = bgmv_cluster_kernel<T, TT>;
  cudaError_t err = configure<T, TT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.c, (t_len + TT - 1) / TT, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(a), static_cast<const T*>(bpool),
                           static_cast<const int*>(idx), static_cast<float*>(out),
                           static_cast<T*>(y), t_len, in_dim, rank, out_dim,
                           pl.in_slice, pl.out_slice, pl.kc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* a, const void* bpool, const void* idx,
        void* out, void* y, int batch, int t_len, int in_dim, int rank,
        int out_dim, int cluster, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  if (rank < 1 || rank > kMaxRank || in_dim % V || out_dim % 4 ||
      (out == nullptr) == (y == nullptr) || cluster != cluster_blocks(t_len))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(t_len, in_dim, rank, out_dim, (int)sizeof(T));
  switch (pl.tt) {
    case 1: return launch_tt<T, 1>(pl, x, a, bpool, idx, out, y, batch, t_len, in_dim, rank, out_dim, stream);
    case 2: return launch_tt<T, 2>(pl, x, a, bpool, idx, out, y, batch, t_len, in_dim, rank, out_dim, stream);
    case 4: return launch_tt<T, 4>(pl, x, a, bpool, idx, out, y, batch, t_len, in_dim, rank, out_dim, stream);
    case 8: return launch_tt<T, 8>(pl, x, a, bpool, idx, out, y, batch, t_len, in_dim, rank, out_dim, stream);
    default: return launch_tt<T, kTileT>(pl, x, a, bpool, idx, out, y, batch, t_len, in_dim, rank, out_dim, stream);
  }
}

}  // namespace
}  // namespace llmlb

// dtype: 0 = float32, 1 = bfloat16. Exactly one of `out` (mode a: fp32
// delta [B, T, OUT]) and `y` (mode b: the projection's output [B, T, OUT]
// in x's dtype, updated in place) is non-null. `cluster` must be the
// cluster size the kernel picks for T (cluster_blocks). Returns a
// cudaError_t (0 = launched).
extern "C" int llmlb_lora_bgmv(const void* x, const void* a, const void* b,
                               const void* idx, void* out, void* y, int batch,
                               int t_len, int in_dim, int rank, int out_dim,
                               int cluster, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return llmlb::run<float>(x, a, b, idx, out, y, batch, t_len, in_dim, rank,
                             out_dim, cluster, s);
  if (dtype == 1)
    return llmlb::run<__nv_bfloat16>(x, a, b, idx, out, y, batch, t_len,
                                     in_dim, rank, out_dim, cluster, s);
  return (int)cudaErrorInvalidValue;
}
