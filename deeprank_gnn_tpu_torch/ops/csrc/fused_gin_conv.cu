// Per-graph edge aggregation of the dense layout (the GINet conv).
//
//   out[g, n, f] = sum_{e : row[g, e] == n, 0 <= col[g, e] < S} xw[g, col[g, e], f]
//
// for xw [G, S, F] fp32 and row, col [G, E] int32; an index outside [0, S)
// (the collate's sentinel S) drops its edge. The backward of this op is the
// same op with row and col swapped, so one kernel serves both directions.
//
// Replaces deeprank_gnn_tpu/ops/pallas/__init__.py:fused_gin_conv (the Pallas
// body _fused_pallas). That kernel builds [E, S] one-hot matrices in VMEM and
// runs two MXU contractions per graph, with a three-way bf16 split for fp32
// exactness, because the TPU has no fast gather or scatter. None of that
// carries over: the work is one add per edge per column.
//
// Bound: bytes. The kernel must read the xw rows that valid edges name, row
// and col once each, and write all of out once: ~7.1 MB for conv1 at the
// paper's width (G 128, S 272 run-padded slots of ~130 nodes, F 32, E 512),
// ~2.1 us at 3.35 TB/s.
//
// Design: one block per graph. The block stages a tile of the graph's edges in
// shared memory (row set to -1 for an edge whose row or col is out of range)
// and, when it fits, the graph's whole [S, F] slab of xw. One warp owns an
// output row n: it walks the tile 32 edges at a time, finds the edges of row n
// with __ballot_sync, and adds their xw rows in ascending edge order, lane l
// holding columns l, l+32, ... in registers. A row with no edges gets 0. No
// atomics and a fixed summation order: two launches are bitwise equal. Rows
// need not be sorted. When the slab does not fit in shared memory (thousands
// of slots at atomic-graph scale), the warps read xw rows from device memory
// instead; when the edges do not fit in one tile, each warp carries its rows'
// partial sums through `out` from one tile to the next (it alone owns them, so
// the summation order stays the edge order).
//
// Cost: each row scans all E edges of its graph, O(S * E / 32) ballots per
// graph. That is acceptable at residue scale; a shared-memory CSR or the
// tensor cores would be the way to make it fast.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunks = 4;        // register columns per lane: 4 x 32 = 128 per pass
constexpr int kEdgeTile = 4096;   // edges staged in shared memory at a time

template <bool kSlab>
__global__ void __launch_bounds__(kThreads)
fused_gin_conv_kernel(const float* __restrict__ xw, const int* __restrict__ row,
                      const int* __restrict__ col, float* __restrict__ out,
                      int n_slots, int n_cols, int n_edges, int edge_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* row_s = reinterpret_cast<int*>(smem);
  int* col_s = row_s + edge_tile;
  float* xw_s = reinterpret_cast<float*>(col_s + edge_tile);

  const size_t slab = static_cast<size_t>(n_slots) * n_cols;
  const size_t g = blockIdx.x;
  const float* src = xw + g * slab;
  float* dst = out + g * slab;
  const int* row_g = row + g * n_edges;
  const int* col_g = col + g * n_edges;

  if (kSlab) {
    for (size_t i = threadIdx.x; i < slab; i += kThreads) xw_s[i] = src[i];
  }
  const float* xs = kSlab ? xw_s : src;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  for (int t0 = 0; t0 < n_edges; t0 += edge_tile) {
    const int tlen = min(edge_tile, n_edges - t0);
    __syncthreads();  // the previous tile is consumed (and the slab staged)
    for (int i = threadIdx.x; i < tlen; i += kThreads) {
      const int r = row_g[t0 + i];
      const int c = col_g[t0 + i];
      const bool ok = r >= 0 && r < n_slots && c >= 0 && c < n_slots;
      row_s[i] = ok ? r : -1;
      col_s[i] = c;
    }
    __syncthreads();
    for (int n = warp; n < n_slots; n += kWarps) {
      float* out_row = dst + static_cast<size_t>(n) * n_cols;
      for (int f0 = 0; f0 < n_cols; f0 += kChunks * kWarp) {
        float acc[kChunks];
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int f = f0 + k * kWarp + lane;
          // this lane wrote out_row[f] itself on the previous tile
          acc[k] = (t0 > 0 && f < n_cols) ? out_row[f] : 0.0f;
        }
        for (int e0 = 0; e0 < tlen; e0 += kWarp) {
          const int e = e0 + lane;
          unsigned hit = __ballot_sync(0xffffffffu, e < tlen && row_s[e] == n);
          while (hit) {
            const int b = __ffs(hit) - 1;
            hit &= hit - 1;
            const float* xr = xs + static_cast<size_t>(col_s[e0 + b]) * n_cols;
#pragma unroll
            for (int k = 0; k < kChunks; ++k) {
              const int f = f0 + k * kWarp + lane;
              if (f < n_cols) acc[k] += xr[f];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int f = f0 + k * kWarp + lane;
          if (f < n_cols) out_row[f] = acc[k];
        }
      }
    }
  }
}

// Which path a launch takes: 1 when the slab and an edge tile fit in the
// block's shared memory, 0 when xw is read from device memory; a negative
// CUDA error code when the device cannot be queried. Sets *smem_bytes.
int choose_path(int n_slots, int n_cols, int n_edges, size_t* smem_bytes) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int tile = n_edges < kEdgeTile ? n_edges : kEdgeTile;
  const size_t idx_bytes = 2 * static_cast<size_t>(tile) * sizeof(int);
  const size_t slab_bytes = static_cast<size_t>(n_slots) * n_cols * sizeof(float);
  const bool slab = idx_bytes + slab_bytes <= static_cast<size_t>(optin);
  *smem_bytes = idx_bytes + (slab ? slab_bytes : 0);
  return slab ? 1 : 0;
}

}  // namespace

// 1 when fused_gin_conv_f32 stages the [S, F] slab in shared memory for these
// sizes, 0 when it reads xw from device memory, negative on a CUDA error.
extern "C" int fused_gin_conv_uses_slab(int n_slots, int n_cols, int n_edges) {
  size_t smem = 0;
  return choose_path(n_slots, n_cols, n_edges, &smem);
}

// xw [G, S, F] fp32, row and col [G, E] int32, out [G, S, F] fp32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Allocates nothing.
extern "C" int fused_gin_conv_f32(const float* xw, const int* row, const int* col,
                                  float* out, int n_graphs, int n_slots, int n_cols,
                                  int n_edges, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_edges == 0) {
    const size_t bytes = static_cast<size_t>(n_graphs) * n_slots * n_cols * sizeof(float);
    return static_cast<int>(cudaMemsetAsync(out, 0, bytes, s));
  }
  size_t smem = 0;
  const int path = choose_path(n_slots, n_cols, n_edges, &smem);
  if (path < 0) return -path;
  const int tile = n_edges < kEdgeTile ? n_edges : kEdgeTile;
  auto kernel = path == 1 ? fused_gin_conv_kernel<true> : fused_gin_conv_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_graphs, kThreads, smem, s>>>(xw, row, col, out, n_slots, n_cols, n_edges, tile);
  return static_cast<int>(cudaGetLastError());
}
