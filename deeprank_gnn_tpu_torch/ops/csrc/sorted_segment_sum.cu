// Segment sum over row-sorted edges, as a CSR segmented reduction.
//
//   out[n, f] = sum_{e in [row_ptr[n], row_ptr[n+1])} data[e, f]
//
// Replaces deeprank_gnn_tpu/ops/pallas/segment.py:sorted_segment_sum (the
// windowed one-hot contraction). That design exists because the TPU has no
// fast scatter; here each output row reads its own contiguous run of edges,
// so the result needs no one-hot, no atomics and no scratch memory.
//
// Design: one warp per output row. Lane l owns columns l, l+32, ...; it sums
// its column over the row's run in edge order, in fp32, and writes 0 for an
// empty run. Neighbouring lanes read neighbouring floats of one edge row, so
// every load is coalesced. No atomics: the result is bitwise the same from
// run to run. Padding edges lie at or past row_ptr[N] and are never read.
//
// Bound: bytes. The kernel does one add per input float, far below the card's
// fp32 rate, so it can go no faster than reading data[:row_ptr[N]] and
// row_ptr once and writing out once. On the GINet serving path (batch 128,
// ~130 nodes and 500 directed edges per graph) that is ~10.4 MB per conv1
// call (E ~ 64,000, F = 32, N = 16,640): ~3.1 us at 3.35 TB/s; and at most
// ~17.3 MB per conv2 call (E <= 64,000 pooled edges, F = 64, N ~ 3,712):
// <= 5.2 us. At these sizes launch latency likely dominates; making the
// kernel fast (several rows per warp for short runs, vector loads) is a
// later change. chip_smoke.py recomputes both bounds from the shapes it runs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 rows per block
constexpr int kRowsPerBlock = kThreads / kWarp;

__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const float* __restrict__ data,
                          const int* __restrict__ row_ptr,
                          float* __restrict__ out,
                          int n_rows, int n_cols, int n_edges) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % kWarp;
  // clamp so that a malformed row_ptr can never read outside data
  const int begin = max(row_ptr[row], 0);
  const int end = min(row_ptr[row + 1], n_edges);
  const size_t cols = static_cast<size_t>(n_cols);
  for (int f = lane; f < n_cols; f += kWarp) {
    float acc = 0.0f;
    for (int e = begin; e < end; ++e) {
      acc += data[static_cast<size_t>(e) * cols + f];
    }
    out[static_cast<size_t>(row) * cols + f] = acc;
  }
}

}  // namespace

// data [n_edges, n_cols] fp32, row_ptr [n_rows + 1] int32, out [n_rows, n_cols]
// fp32, all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Allocates nothing.
extern "C" int sorted_segment_sum_f32(const float* data, const int* row_ptr,
                                      float* out, int n_rows, int n_cols,
                                      int n_edges, void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  sorted_segment_sum_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      data, row_ptr, out, n_rows, n_cols, n_edges);
  return static_cast<int>(cudaGetLastError());
}
