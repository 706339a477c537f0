// K3: per-graph edge aggregation of the dense layout (the GINet conv).
//
//   out[g, n, f] = sum_{e : row[g, e] == n, 0 <= col[g, e] < S} xw[g, col[g, e], f]
//
// for xw [G, S, F] fp32 and row, col [G, E] int32; an index outside [0, S)
// (the collate's sentinel S) drops its edge. Each sum adds its edges in
// ascending edge order, fp32 adds only, so the result is bitwise the plain
// version's on the CPU (index_add_ there adds in index order). The backward
// of this op is the same op with row and col swapped, so one kernel serves
// both directions.
//
// Replaces deeprank_gnn_tpu/ops/pallas/__init__.py:fused_gin_conv (the Pallas
// body _fused_pallas). That kernel builds [E, S] one-hot matrices in VMEM and
// runs two MXU contractions per graph, with a three-way bf16 split for fp32
// exactness, because the TPU has no fast gather or scatter.
//
// Bound: bytes. The kernel must read the xw rows that valid edges name, row
// and col once each, and write all of out once: ~7.1 MB for conv1 at the
// paper's width (G 128, S 272 run-padded slots of ~130 nodes, F 32, E 512),
// 2.12 us at 3.35 TB/s. The arithmetic is one fp32 add per valid edge and
// column.
//
// Design. A graph's S output rows are split over ceil(S / 128) blocks of 256
// threads, as evenly as they go (conv1: 3 blocks of 91 rows, 384 blocks in
// all; conv2, S 32: one block per graph). A block
//  1. requests the first tile of the graph's edges (up to 2,048; each warp a
//     contiguous segment in 32-edge chunks, coalesced), then has one thread
//     start a bulk copy (TMA: cp.async.bulk, completing on an mbarrier) of
//     the graph's [S, F] slab of xw into shared memory when it fits there.
//     The index loads go first so that they do not queue behind the copy;
//     the copy runs while the block does steps 2-4. The few floats before
//     the first and after the last 16-byte boundary of the slab are plain
//     loads.
//  2. keeps the edges whose row falls in its own range and whose row and col
//     are in [0, S), and counts them per (warp, row). __match_any_sync on the
//     row gives a kept edge its peers in the chunk and its rank among them; a
//     warp walks its chunks in order, so its count of a row before a chunk
//     is the rank of that row's next edge. The leader of each peer group adds
//     the group's size: no atomics.
//  3. scans the counts, per row over the warps in order and then over the
//     rows: each row's offset, and each (warp, row)'s base within the row.
//  4. writes each kept edge's col at offset + base + rank: a CSR of the tile
//     in shared memory whose runs hold each row's edges in ascending edge
//     order.
//  5. sums each run. A group of lanes owns an output row, lanes over the
//     columns, a float4 each where F is a multiple of 4 (else a float); the
//     group is the next power of two of F / 4 (or F), at most a warp (conv1:
//     8 lanes, 32 rows at a time). It loads the run's source rows from the
//     slab (from device memory when the slab does not fit) four at a time,
//     adds them in edge order in registers and writes the row once. A row
//     without edges writes 0, so out needs no fill.
//  6. With more edges than one tile, the tiles go in order, and the lanes
//     that own a row carry its partial sum through out from one tile to the
//     next, so the order stays the edge order.
// Two launches are bitwise equal. Rows need not be sorted. S has no limit: a
// block's counters cover its own rows only.
//
// The fast variant (fused_gin_conv_bf16) is the same kernel on bf16 xw, the
// counterpart of the Pallas body's non-exact branch (a single bf16 MXU pass,
// fp32 accumulation; deeprank_gnn_tpu/ops/pallas/__init__.py:178). The
// caller rounds xw to bf16; the kernel widens each element to fp32 exactly
// and sums in fp32 in edge order, so its result is bitwise the fp32 kernel's
// on the rounded values, and it writes fp32. The slab in shared memory, and
// the bytes read, halve: conv1's [272, 32] slab takes 17.4 KB instead of
// 34.8 KB.
//
// Why not the tensor cores: the op is one add per edge and column. As a
// one-hot product it would do S / degree times the work, and it would need
// the TPU's three-way bf16 split to stay fp32-exact. Bytes and latency bound
// it, not arithmetic.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxRows = 128;    // output rows of one block, at most
constexpr int kEdgeTile = 2048;  // edges sorted in shared memory at a time
constexpr int kChunks = kEdgeTile / kThreads;  // 32-edge chunks of a warp per tile
constexpr int kUnroll = 4;       // source rows a lane loads before it adds them
constexpr int kBarBytes = 16;    // the mbarrier, padded to the slab's alignment

static_assert(kMaxRows <= kThreads, "the row scan gives one row to a thread");
static_assert(kEdgeTile <= 1 << 15, "a rank and a row share one int");

// Elements of shared memory for a slab of `n` elements, `epv` of them to 16
// bytes: room to start it at the same offset modulo 16 bytes as in device
// memory, in whole 16-byte units.
__host__ __device__ inline size_t slab_elems(size_t n, size_t epv) {
  return (n + 2 * (epv - 1)) / epv * epv;
}

// Edges of a warp's segment of a tile of `tlen`: whole chunks, the tile's
// first edges to warp 0.
__device__ __forceinline__ int tile_seg(int tlen) {
  return kWarp * ((tlen + kThreads - 1) / kThreads);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 only: start copying `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device memory into shared memory; `bar` completes
// its phase 0 when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One element, or four consecutive ones, of xw widened to fp32, exactly: a
// bf16 is the high half of the fp32 of the same value, so the widening is a
// shift (measured a little faster than the cvt intrinsics here).
template <typename T, typename In> __device__ __forceinline__ T load_as(const In* p);
template <> __device__ __forceinline__ float load_as<float, float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float4 load_as<float4, float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(*p)) << 16);
}
template <>
__device__ __forceinline__ float4 load_as<float4, __nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(0u) : "memory");
  }
}

// Loads of a tile's edges [t0, t0 + tlen) for one warp: its segment of
// `seg` edges, chunk k at lane `lane`; -1 past the tile.
__device__ __forceinline__ void load_edges(const int* row_g, const int* col_g, int t0, int tlen,
                                           int seg, int warp, int lane, int (&r)[kChunks],
                                           int (&c)[kChunks]) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int e = warp * seg + k * kWarp + lane;
    r[k] = -1;
    c[k] = -1;
    if (k * kWarp < seg && e < tlen) {
      r[k] = row_g[t0 + e];
      c[k] = col_g[t0 + e];
    }
  }
}

// Sums of the runs of rows [0, n_rows) of a tile's CSR into out rows r0 +
// lr, with T (float or float4) a lane's share of a row per pass: a group of
// lanes (the next power of two of F / |T| floats, at most a warp) owns a row.
// The run's source rows (of In, float or bf16) are loaded kUnroll at a time,
// widened to fp32 and added in edge order. With `carry`, a row adds to what
// these lanes wrote on the last tile, and a row without edges here is left
// alone.
template <typename T, typename In>
__device__ __forceinline__ void sum_runs(const In* xs, float* dst, const int* row_off,
                                         const int* csr, int r0, int n_rows, int n_cols,
                                         bool carry) {
  constexpr int kV = sizeof(T) / sizeof(float);
  const int need = (n_cols + kV - 1) / kV;
  const int group = need > 16 ? kWarp : need > 8 ? 16 : need > 4 ? 8 : need > 2 ? 4 : need;
  const int glane = threadIdx.x % group;
  for (int lr = threadIdx.x / group; lr < n_rows; lr += kThreads / group) {
    const int lo = row_off[lr];
    const int hi = row_off[lr + 1];
    if (carry && lo == hi) continue;
    float* out_row = dst + static_cast<size_t>(r0 + lr) * n_cols;
    for (int f = glane * kV; f < n_cols; f += group * kV) {
      T acc = carry ? *reinterpret_cast<const T*>(out_row + f) : zero<T>();
      for (int j = lo; j < hi; j += kUnroll) {
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < hi) {
            v[u] = load_as<T>(xs + static_cast<size_t>(csr[j + u]) * n_cols + f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < hi) add(acc, v[u]);
        }
      }
      *reinterpret_cast<T*>(out_row + f) = acc;
    }
  }
}

template <typename In, bool kSlab>
__global__ void __launch_bounds__(kThreads)
fused_gin_conv_kernel(const In* __restrict__ xw, const int* __restrict__ row,
                      const int* __restrict__ col, float* __restrict__ out, int n_slots,
                      int n_cols, int n_edges, int rows_per_block, int blocks_per_graph,
                      int edge_tile) {
  constexpr int kEpv = 16 / sizeof(In);  // elements of xw in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slab = static_cast<size_t>(n_slots) * n_cols;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  In* slab_s = reinterpret_cast<In*>(smem + kBarBytes);
  int* hist = reinterpret_cast<int*>(slab_s + (kSlab ? slab_elems(slab, kEpv) : 0));  // [kWarps][R]
  int* row_off = hist + kWarps * rows_per_block;  // [R + 1]
  int* warp_sum = row_off + rows_per_block + 1;   // [kWarps]
  int* csr = warp_sum + kWarps;                   // [edge_tile]

  const size_t g = blockIdx.x / blocks_per_graph;
  const int r0 = static_cast<int>(blockIdx.x % blocks_per_graph) * rows_per_block;
  const int n_rows = min(rows_per_block, n_slots - r0);
  const In* src = xw + g * slab;
  float* dst = out + g * slab;
  const int* row_g = row + g * n_edges;
  const int* col_g = col + g * n_edges;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  // the first tile's edges, requested before the slab so that they do not
  // queue behind it
  int key[kChunks];      // row, then rank << 16 | local row, or -1 for a dropped edge
  int src_col[kChunks];  // col of a kept edge
  load_edges(row_g, col_g, 0, edge_tile, tile_seg(edge_tile), warp, lane, key, src_col);

  // 1. the slab: slab_g[i] is 16-byte aligned where src + i is
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(In));
  In* slab_g = slab_s + shift;
  if (kSlab) {
    const size_t head_to_16 = static_cast<size_t>((kEpv - shift) & (kEpv - 1));
    const size_t head = slab < head_to_16 ? slab : head_to_16;
    const size_t body = (slab - head) & ~static_cast<size_t>(kEpv - 1);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (body > 0) {
        bulk_copy(slab_g + head, src + head, static_cast<uint32_t>(body * sizeof(In)), bar);
      } else {
        asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                     :: "r"(smem_u32(bar)) : "memory");
      }
    }
    for (size_t i = tid; i < head; i += kThreads) slab_g[i] = src[i];
    for (size_t i = head + body + tid; i < slab; i += kThreads) slab_g[i] = src[i];
  }
  const In* xs = kSlab ? slab_g : src;

  const unsigned lanes_below = (1u << lane) - 1;
  int* warp_hist = hist + warp * rows_per_block;
  // four columns to a load when every row of xs starts on four elements'
  // bytes and every row of out on 16 bytes
  const bool vec4 = n_cols % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(xs) & (4 * sizeof(In) - 1)) == 0 &&
                    (reinterpret_cast<uintptr_t>(dst) & 15) == 0;

  for (int t0 = 0; t0 < n_edges; t0 += edge_tile) {
    const int tlen = min(edge_tile, n_edges - t0);
    for (int i = tid; i < kWarps * rows_per_block; i += kThreads) hist[i] = 0;
    __syncthreads();

    // 2. keep, count and rank: each warp a contiguous segment of the tile
    const int seg = tile_seg(tlen);
    if (t0 > 0) load_edges(row_g, col_g, t0, tlen, seg, warp, lane, key, src_col);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k * kWarp < seg) {  // the same for the whole block
        const int r = key[k];
        const int c = src_col[k];
        const int lr = r >= r0 && r < r0 + n_rows && c >= 0 && c < n_slots ? r - r0 : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, lr);
        const int before = lr >= 0 ? warp_hist[lr] : 0;
        __syncwarp();
        if (lr >= 0 && lane == __ffs(peers) - 1) warp_hist[lr] = before + __popc(peers);
        __syncwarp();
        key[k] = lr >= 0 ? (before + __popc(peers & lanes_below)) << 16 | lr : -1;
      }
    }
    __syncthreads();

    // 3. row offsets, and each warp's base within a row (hist, in place)
    int total = 0;
    if (tid < n_rows) {
      int h[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) h[w] = hist[w * rows_per_block + tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        hist[w * rows_per_block + tid] = total;
        total += h[w];
      }
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == kWarp - 1) warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += warp_sum[w];
    if (tid < n_rows) {
      row_off[tid] = incl - total;
      if (tid == n_rows - 1) row_off[n_rows] = incl;
    }
    __syncthreads();

    // 4. the tile's CSR: each kept edge's col at its place in its row's run
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (key[k] >= 0) {
        const int lr = key[k] & 0xffff;
        csr[row_off[lr] + warp_hist[lr] + (key[k] >> 16)] = src_col[k];
      }
    }
    __syncthreads();
    if (kSlab && t0 == 0) wait_phase0(bar);

    // 5. sum each run in order; rows without edges write 0 on the first
    // tile and are left alone after it
    if (vec4) {
      sum_runs<float4>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
    } else {
      sum_runs<float>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
    }
  }
}

struct Plan {
  int slab;              // 1: the [S, F] slab is staged in shared memory
  int rows_per_block;    // output rows of one block
  int blocks_per_graph;  // ceil(S / rows_per_block)
  int edge_tile;         // edges per tile
  size_t smem;           // dynamic shared memory of one block, bytes
};

// The launch for these sizes (S, F, E > 0) and xw elements of `in_bytes`
// (4 or 2), from the device's shared memory.
cudaError_t make_plan(int n_slots, int n_cols, int n_edges, int in_bytes, Plan* p) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  p->blocks_per_graph = (n_slots + kMaxRows - 1) / kMaxRows;
  p->rows_per_block = (n_slots + p->blocks_per_graph - 1) / p->blocks_per_graph;
  p->edge_tile = n_edges < kEdgeTile ? n_edges : kEdgeTile;
  const size_t ints = static_cast<size_t>(kWarps + 1) * p->rows_per_block + 1 + kWarps +
                      p->edge_tile;
  const size_t base = kBarBytes + ints * sizeof(int);
  const size_t slab_bytes =
      slab_elems(static_cast<size_t>(n_slots) * n_cols, 16 / in_bytes) * in_bytes;
  p->slab = base + slab_bytes <= static_cast<size_t>(optin);
  p->smem = base + (p->slab ? slab_bytes : 0);
  return cudaSuccess;
}

template <typename In>
using Kernel = void (*)(const In*, const int*, const int*, float*, int, int, int, int, int, int);

template <typename In>
Kernel<In> kernel_of(const Plan& p) {
  return p.slab ? fused_gin_conv_kernel<In, true> : fused_gin_conv_kernel<In, false>;
}

template <typename In>
cudaError_t allow_smem(Kernel<In> kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename In>
cudaError_t plan_of(int n_slots, int n_cols, int n_edges, int* plan) {
  Plan p;
  cudaError_t err = make_plan(n_slots, n_cols, n_edges, sizeof(In), &p);
  if (err != cudaSuccess) return err;
  const Kernel<In> kernel = kernel_of<In>(p);
  int resident = 0;
  err = allow_smem(kernel, p.smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, p.smem);
  }
  if (err != cudaSuccess) return err;
  plan[0] = p.slab;
  plan[1] = p.rows_per_block;
  plan[2] = p.blocks_per_graph;
  plan[3] = static_cast<int>(p.smem);
  plan[4] = resident;
  return cudaSuccess;
}

template <typename In>
cudaError_t launch(const In* xw, const int* row, const int* col, float* out, int n_graphs,
                   int n_slots, int n_cols, int n_edges, cudaStream_t s) {
  if (n_graphs == 0 || n_slots == 0 || n_cols == 0) return cudaSuccess;
  if (n_edges == 0) {
    const size_t bytes = static_cast<size_t>(n_graphs) * n_slots * n_cols * sizeof(float);
    return cudaMemsetAsync(out, 0, bytes, s);
  }
  Plan p;
  cudaError_t err = make_plan(n_slots, n_cols, n_edges, sizeof(In), &p);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(n_graphs) * p.blocks_per_graph;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const Kernel<In> kernel = kernel_of<In>(p);
  err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, p.smem, s>>>(
      xw, row, col, out, n_slots, n_cols, n_edges, p.rows_per_block, p.blocks_per_graph,
      p.edge_tile);
  return cudaGetLastError();
}

}  // namespace

// The launch fused_gin_conv_f32 (bf16 == 0) or fused_gin_conv_bf16 (bf16 ==
// 1) makes for these sizes (all > 0), into plan[0..4]: 1 when the slab is
// staged in shared memory (else 0), rows per block, blocks per graph, dynamic
// shared memory per block in bytes, and blocks resident per SM. Returns a
// CUDA error code (0 on success).
extern "C" int fused_gin_conv_plan(int n_slots, int n_cols, int n_edges, int bf16, int* plan) {
  return static_cast<int>(bf16 ? plan_of<__nv_bfloat16>(n_slots, n_cols, n_edges, plan)
                               : plan_of<float>(n_slots, n_cols, n_edges, plan));
}

// xw [G, S, F] fp32, row and col [G, E] int32, out [G, S, F] fp32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Allocates nothing.
extern "C" int fused_gin_conv_f32(const float* xw, const int* row, const int* col, float* out,
                                  int n_graphs, int n_slots, int n_cols, int n_edges,
                                  void* stream) {
  return static_cast<int>(launch(xw, row, col, out, n_graphs, n_slots, n_cols, n_edges,
                                 static_cast<cudaStream_t>(stream)));
}

// The fast variant: xw [G, S, F] bf16, the rest as fused_gin_conv_f32; the
// sums run in fp32 and out is fp32.
extern "C" int fused_gin_conv_bf16(const void* xw, const int* row, const int* col, float* out,
                                   int n_graphs, int n_slots, int n_cols, int n_edges,
                                   void* stream) {
  return static_cast<int>(launch(static_cast<const __nv_bfloat16*>(xw), row, col, out,
                                 n_graphs, n_slots, n_cols, n_edges,
                                 static_cast<cudaStream_t>(stream)));
}
