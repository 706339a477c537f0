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
// their CSR pointers exist, so the gather-back is a contiguous write of each
// row's sum over that row's own run of edges.
//
// Design: a group of G lanes per output row, G the smallest power of two at
// or above F, at most a warp (32): lane l of the group owns columns l, l+G,
// ... It sums its column over the row's run in edge order, in fp32, writes
// out[n], then writes the same register value into d2[e] for each e of the
// run. For F = 1 (the attention softmax's denominator) a group is one
// thread, so no lane idles. Neighbouring lanes touch neighbouring floats of
// one edge row, so loads and stores of an edge row are coalesced. No atomics
// and no scratch: the result is bitwise the same from run to run, out is
// bitwise what sorted_segment_sum.cu computes, and d2 is bitwise out[rows].
// Blocks past the last row zero the edges outside every run, so d2 needs no
// zero fill before the launch.
//
// Bound: bytes. The kernel does one add per valid input float, far below the
// card's fp32 rate, so it can go no faster than reading data[:row_ptr[N]] and
// row_ptr once and writing out and d2 whole once. On the attention softmax
// path (batch 128, ~130 nodes and 500 directed edges per graph, F = 1) that
// is ~0.6 MB per conv1 call: ~0.2 us at 3.35 TB/s, so launch latency will
// dominate. At the JAX package's bench.py shapes (N 81,920, E 983,040,
// F 16) it is 135.0 MB: 40.3 us. Making the kernel fast is a later change.
// chip_smoke.py recomputes the bound from the shapes it runs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFillBlocks = 32;  // blocks that zero the edges outside every run

__global__ void __launch_bounds__(kThreads)
sorted_scatter_gather_kernel(const float* __restrict__ data,
                             const int* __restrict__ row_ptr,
                             float* __restrict__ out, float* __restrict__ d2,
                             int n_rows, int n_cols, int n_edges, int group,
                             int row_blocks) {
  const size_t cols = static_cast<size_t>(n_cols);
  if (static_cast<int>(blockIdx.x) >= row_blocks) {
    // [0, lead) and [trail, E) lie outside every row's run; clamped so that
    // a malformed row_ptr can never write outside d2
    const int lead = min(max(row_ptr[0], 0), n_edges);
    const int trail = min(max(row_ptr[n_rows], lead), n_edges);
    const size_t lead_floats = static_cast<size_t>(lead) * cols;
    const size_t total = lead_floats + static_cast<size_t>(n_edges - trail) * cols;
    const size_t stride = static_cast<size_t>(gridDim.x - row_blocks) * kThreads;
    for (size_t k = static_cast<size_t>(blockIdx.x - row_blocks) * kThreads + threadIdx.x;
         k < total; k += stride) {
      d2[k < lead_floats ? k : static_cast<size_t>(trail) * cols + (k - lead_floats)] = 0.0f;
    }
    return;
  }
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

}  // namespace

// data [n_edges, n_cols] fp32, row_ptr [n_rows + 1] int32 (nondecreasing),
// out [n_rows, n_cols] and d2 [n_edges, n_cols] fp32, all contiguous on the
// device; n_cols >= 1. Launches on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted). Allocates nothing.
extern "C" int sorted_scatter_gather_f32(const float* data, const int* row_ptr,
                                         float* out, float* d2, int n_rows,
                                         int n_cols, int n_edges, void* stream) {
  int group = 1;
  while (group < n_cols && group < 32) group *= 2;
  const int rows_per_block = kThreads / group;
  const int row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  sorted_scatter_gather_kernel<<<row_blocks + kFillBlocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      data, row_ptr, out, d2, n_rows, n_cols, n_edges, group, row_blocks);
  return static_cast<int>(cudaGetLastError());
}
