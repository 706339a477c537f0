// Segment sum over row-sorted edges, and that sum copied back onto each edge
// of the row, as one CSR pass.
//
//   out[n, f] = sum_{e in [row_ptr[n], row_ptr[n+1])} data[e, f]
//   d2[e, f]  = out[n, f] for every e in row n's run, and 0 for every edge
//               outside [row_ptr[0], row_ptr[N]) (padding)
//
// Replaces deeprank_gnn_tpu/ops/pallas/segment.py:sorted_scatter_gather (a
// two-phase sequential grid: a windowed one-hot MXU scatter into a
// VMEM-resident accumulator, then the dual one-hot contraction to gather it
// back, each split three ways in bf16 for fp32 exactness). That design exists
// because the TPU has no fast scatter or gather. Here the rows are sorted and
// their CSR pointers exist, so the gather-back is a write of each row's sum
// over that row's own run of edges.
//
// Bound: bytes. The kernel does one add per valid input float, far below the
// card's fp32 rate, so it can go no faster than reading data[:row_ptr[N]] and
// row_ptr once and writing out and d2 whole once. On the attention softmax
// path (batch 128, ~130 nodes and 500 directed edges per graph, F = 1) that
// is ~0.6 MB per conv1 call: ~0.2 us at 3.35 TB/s, so the launch and a few
// memory round trips are all the time there is. chip_smoke.py recomputes the
// bound from the shapes it runs.
//
// F = 1 (the softmax's denominator, the only width on the model path): a
// thread per row walking its own run serially made neighbouring threads load
// with the stride of a run's length (~3.8 edges in conv1, ~11.5 in conv2).
// Instead a block of one warp owns 32 consecutive rows, whose runs form one
// contiguous span of edges, [row_ptr[r0], row_ptr[r0 + 32]). The warp
// stages the span into shared memory in tiles of kTileEdges edges with
// coalesced 16-byte loads (each tile sits in shared memory at its
// device-memory offset modulo 16, plain loads at its two ends). Each row's
// thread adds the part of its run that lies in the tile, in ascending edge
// order, carrying its sum from tile to tile, so a run of any length works.
// When the sum is final the thread writes out[n] and then the sum over its
// run of d2; between them the warp's stores cover its span, whole cache
// lines. At the path's shapes a warp's span (~120 edges in conv1, ~370 in
// conv2) is one tile: one round trip for the row pointers, one for the
// edges. On an H100, in the conditions of a model pass (input just written,
// in L2), blocks of one warp were faster at both conv shapes than blocks of
// 64, 128 or 256 rows (256 rows make 15 blocks of conv2's 3,712 rows), and
// storing d2 straight from the threads faster than staging it in shared
// memory for 16-byte stores.
//
// Other widths (F = 16 at bench.py's shapes; the edge cases): a group of G
// lanes per output row, G the smallest power of two at or above F, at most a
// warp (32): lane l of the group owns columns l, l+G, ... It sums its column
// over the row's run in edge order, writes out[n], then writes the same
// register value into d2[e] for each e of the run. Neighbouring lanes touch
// neighbouring floats of one edge row, so those loads and stores coalesce.
//
// Both paths: each row is summed in edge order in fp32 from 0, so out is
// bitwise what sorted_segment_sum.cu computes and what the plain version
// computes on the CPU, and d2 is bitwise out[rows]. No atomics and no scratch
// in device memory: the result is the same from run to run. Blocks past the
// last row zero the edges outside every run, so d2 needs no zero fill before
// the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // lane path: threads per block
constexpr int kTileRows = 32;     // F = 1: rows, and threads, per block (one warp)
constexpr int kTileEdges = 1024;  // F = 1: edges staged per tile (4 KB)
constexpr int kFillBlocks = 32;   // blocks that zero the edges outside every run
constexpr int kTileLoads = kTileEdges / 4 / kTileRows;  // float4 loads per thread per tile

enum Path { kTiles = 0, kLanes = 1 };

struct Plan {
  int path;
  int threads;         // per block
  int lanes;           // lanes per row (kLanes path)
  int rows_per_block;
  int row_blocks;
};

Plan make_plan(int n_rows, int n_cols) {
  Plan p;
  p.path = n_cols == 1 ? kTiles : kLanes;
  p.threads = p.path == kTiles ? kTileRows : kThreads;
  p.lanes = 1;
  while (p.lanes < n_cols && p.lanes < 32) p.lanes *= 2;
  p.rows_per_block = p.path == kTiles ? kTileRows : kThreads / p.lanes;
  p.row_blocks = (n_rows + p.rows_per_block - 1) / p.rows_per_block;
  return p;
}

// Blocks past the row blocks: d2 = 0 on [0, lead) and [trail, E), which lie
// outside every row's run; clamped so that a malformed row_ptr can never
// write outside d2.
__device__ void zero_padding(const int* __restrict__ row_ptr, float* __restrict__ d2,
                             int n_rows, int n_cols, int n_edges, int row_blocks) {
  const size_t cols = static_cast<size_t>(n_cols);
  const int lead = min(max(row_ptr[0], 0), n_edges);
  const int trail = min(max(row_ptr[n_rows], lead), n_edges);
  const size_t lead_floats = static_cast<size_t>(lead) * cols;
  const size_t total = lead_floats + static_cast<size_t>(n_edges - trail) * cols;
  const size_t stride = static_cast<size_t>(gridDim.x - row_blocks) * blockDim.x;
  for (size_t k = static_cast<size_t>(blockIdx.x - row_blocks) * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    d2[k < lead_floats ? k : static_cast<size_t>(trail) * cols + (k - lead_floats)] = 0.0f;
  }
}

// Floats before `p` reaches a 16-byte boundary (0 to 3).
__device__ __forceinline__ int misalignment(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// tile[k] = src[k] for k < n (n <= kTileEdges), where tile and src share
// their address modulo 16: 16-byte loads in the aligned middle, all issued
// before any is stored, and plain loads at the two ends.
__device__ __forceinline__ void stage_in(const float* __restrict__ src, int n, float* tile) {
  const int head = min((4 - misalignment(src)) & 3, n);
  const int body = (n - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* t4 = reinterpret_cast<float4*>(tile + head);
  float4 v[kTileLoads];
#pragma unroll
  for (int j = 0; j < kTileLoads; ++j) {
    const int i = threadIdx.x + j * kTileRows;
    if (i < body) v[j] = __ldg(s4 + i);
  }
#pragma unroll
  for (int j = 0; j < kTileLoads; ++j) {
    const int i = threadIdx.x + j * kTileRows;
    if (i < body) t4[i] = v[j];
  }
  const int done = head + 4 * body;
  if (static_cast<int>(threadIdx.x) < head) tile[threadIdx.x] = __ldg(src + threadIdx.x);
  if (static_cast<int>(threadIdx.x) < n - done) {
    tile[done + threadIdx.x] = __ldg(src + done + threadIdx.x);
  }
}

__global__ void __launch_bounds__(kTileRows)
sorted_scatter_gather_tiles_kernel(const float* __restrict__ data,
                                   const int* __restrict__ row_ptr, float* __restrict__ out,
                                   float* __restrict__ d2, int n_rows, int n_edges,
                                   int row_blocks) {
  if (static_cast<int>(blockIdx.x) >= row_blocks) {
    zero_padding(row_ptr, d2, n_rows, 1, n_edges, row_blocks);
    return;
  }
  __shared__ int ptr[kTileRows + 1];
  // 4 floats of room to place a tile at its device-memory offset modulo 16
  __shared__ __align__(16) float tile[kTileEdges + 4];
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n_rows - r0);
  // clamped so that a malformed row_ptr can never reach outside data or d2
  for (int i = threadIdx.x; i <= rows; i += kTileRows) {
    ptr[i] = min(max(row_ptr[r0 + i], 0), n_edges);
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int begin = t < rows ? ptr[t] : 0;
  const int end = t < rows ? max(ptr[t + 1], begin) : 0;
  const int span_begin = ptr[0];
  const int span_end = max(ptr[rows], span_begin);

  float acc = 0.0f;
  for (int t0 = span_begin; t0 < span_end; t0 += kTileEdges) {
    const int t1 = min(t0 + kTileEdges, span_end);
    float* slots = tile + misalignment(data + t0);  // slots[k] holds data[t0 + k]
    __syncthreads();  // every thread is done with the previous tile
    stage_in(data + t0, t1 - t0, slots);
    __syncthreads();
    const int hi = min(end, t1);
    for (int e = max(begin, t0); e < hi; ++e) acc += slots[e - t0];
  }
  if (t < rows) out[r0 + t] = acc;
  for (int e = begin; e < end; ++e) d2[e] = acc;
}

__global__ void __launch_bounds__(kThreads)
sorted_scatter_gather_lanes_kernel(const float* __restrict__ data,
                                   const int* __restrict__ row_ptr, float* __restrict__ out,
                                   float* __restrict__ d2, int n_rows, int n_cols, int n_edges,
                                   int group, int row_blocks) {
  if (static_cast<int>(blockIdx.x) >= row_blocks) {
    zero_padding(row_ptr, d2, n_rows, n_cols, n_edges, row_blocks);
    return;
  }
  const size_t cols = static_cast<size_t>(n_cols);
  const int row = blockIdx.x * (kThreads / group) + threadIdx.x / group;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % group;
  // clamp so that a malformed row_ptr can never read outside data
  const int begin = max(row_ptr[row], 0);
  const int end = min(row_ptr[row + 1], n_edges);
  for (int f = lane; f < n_cols; f += group) {
    float acc = 0.0f;
    for (int e = begin; e < end; ++e) {
      acc += data[static_cast<size_t>(e) * cols + f];
    }
    out[static_cast<size_t>(row) * cols + f] = acc;
    for (int e = begin; e < end; ++e) {
      d2[static_cast<size_t>(e) * cols + f] = acc;
    }
  }
}

// A kernel's static shared memory and its blocks resident per SM.
template <typename Kernel>
cudaError_t describe(Kernel kernel, int threads, int* smem, int* resident) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, threads, 0);
}

}  // namespace

// The launch sorted_scatter_gather_f32 makes for n_rows x n_cols: plan[0]
// the path (0: shared-memory tiles, F = 1; 1: lane groups), plan[1] rows
// per block, plan[2] edges per tile (0 on the lane path), plan[3] blocks
// (row blocks and the padding's zero-fill blocks), plan[4] static shared
// memory per block in bytes, plan[5] blocks resident per SM, plan[6]
// threads per block. Returns a CUDA error code (0 on success).
extern "C" int sorted_scatter_gather_plan(int n_rows, int n_cols, int* plan) {
  const Plan p = make_plan(n_rows, n_cols);
  int smem = 0, resident = 0;
  const cudaError_t err =
      p.path == kTiles
          ? describe(sorted_scatter_gather_tiles_kernel, p.threads, &smem, &resident)
          : describe(sorted_scatter_gather_lanes_kernel, p.threads, &smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.path;
  plan[1] = p.rows_per_block;
  plan[2] = p.path == kTiles ? kTileEdges : 0;
  plan[3] = p.row_blocks + kFillBlocks;
  plan[4] = smem;
  plan[5] = resident;
  plan[6] = p.threads;
  return 0;
}

// data [n_edges, n_cols] fp32, row_ptr [n_rows + 1] int32 (nondecreasing),
// out [n_rows, n_cols] and d2 [n_edges, n_cols] fp32, all contiguous on the
// device; n_cols >= 1. Launches on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted). Allocates nothing.
extern "C" int sorted_scatter_gather_f32(const float* data, const int* row_ptr,
                                         float* out, float* d2, int n_rows,
                                         int n_cols, int n_edges, void* stream) {
  const Plan p = make_plan(n_rows, n_cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.path == kTiles) {
    sorted_scatter_gather_tiles_kernel<<<p.row_blocks + kFillBlocks, p.threads, 0, s>>>(
        data, row_ptr, out, d2, n_rows, n_edges, p.row_blocks);
  } else {
    sorted_scatter_gather_lanes_kernel<<<p.row_blocks + kFillBlocks, p.threads, 0, s>>>(
        data, row_ptr, out, d2, n_rows, n_cols, n_edges, p.lanes, p.row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
