// Segment sum over row-sorted edges, as a CSR segmented reduction.
//
//   out[n, f] = sum_{e in [row_ptr[n], row_ptr[n+1])} data[e, f]
//
// Replaces deeprank_gnn_tpu/ops/pallas/segment.py:sorted_segment_sum (the
// windowed one-hot contraction). That design exists because the TPU has no
// fast scatter; here each output row reads its own contiguous run of edges,
// so the result needs no one-hot, no atomics and no scratch memory.
//
// Bound: bytes. The kernel does one add per input float, far below the card's
// fp32 rate, so it can go no faster than reading data[:row_ptr[N]] and
// row_ptr once and writing out once. On the GINet serving path (batch 128,
// ~130 nodes and 500 directed edges per graph) that is ~10.4 MB per conv1
// call (E ~ 64,000, F = 32, N = 16,640): ~3.1 us at 3.35 TB/s; the attention
// path's convs run at F = 16 and 32. chip_smoke.py recomputes the bound from
// the shapes it runs.
//
// Design: a group of G lanes per output row, sized to F. Each lane reads V
// consecutive columns, G is the smallest power of two at or above
// ceil(F / V), at most 32, and a warp serves 32 / G rows. A fixed warp of 32
// lanes per row left half of every warp idle at the attention path's F = 16
// (and 31 of 32 lanes at F = 1). V is 4 (float4) or 2 (float2) where F and
// the alignment of data and out allow, else 1. Of 4 and 2 the kernel takes 2,
// which puts twice the lanes on a row and halves each lane's serial work,
// while N * G stays within 3/4 of the threads the card holds resident and
// one pass covers the row; else 4. Measured on an H100 in the conditions of
// a model pass (input just written, in L2), float2 was faster at the
// attention path's conv1 (N 16,640, F 16) and at both pooled-edge convs (N
// 3,712, F 32 and 64, runs of ~11.5 edges), and float4 at paper mode's conv1
// (N 16,640, F 32 and 64), where float2 would fill every resident thread of
// the card or more.
// Each lane issues its loads for the next L edges of its run before it adds
// any of them (L = 4 float4s or 8 narrower loads: 64 bytes in flight), then
// adds them one by one in edge order: several loads are in flight, and each
// column is still summed in ascending edge order in fp32 from 0, so the
// result is bitwise the plain version's on the CPU (index_add_ in edge order)
// and the same from run to run. No atomics. Padding edges lie at or past
// row_ptr[N] and are never read; an empty run gives 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Plan {
  int vec;             // columns a lane reads per load (V: 1, 2 or 4)
  int lanes;           // lanes per output row (G)
  int rows_per_block;  // kThreads / lanes
  int blocks;
  int loads;           // edges whose loads a lane has in flight at once (L)
};

int lanes_for(int n_cols, int vec) {
  const int chunks = (n_cols + vec - 1) / vec;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

// `align`: the bytes to which data and out are both aligned (4, 8 or 16);
// `resident`: the threads the card holds resident at once.
Plan make_plan(int n_rows, int n_cols, int align, int resident) {
  Plan p;
  p.vec = 1;
  if (n_cols % 4 == 0 && align >= 16) {
    p.vec = 4;
  } else if (n_cols % 2 == 0 && align >= 8) {
    p.vec = 2;
  }
  if (p.vec == 4 && n_cols <= 64 &&
      4LL * n_rows * lanes_for(n_cols, 2) <= 3LL * resident) {
    p.vec = 2;
  }
  p.lanes = lanes_for(n_cols, p.vec);
  p.rows_per_block = kThreads / p.lanes;
  p.blocks = (n_rows + p.rows_per_block - 1) / p.rows_per_block;
  p.loads = p.vec == 4 ? 4 : 8;
  return p;
}

cudaError_t resident_threads(int* threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  *threads = sms * per_sm;
  return err;
}

int alignment(const void* a, const void* b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return (bits & 15) == 0 ? 16 : (bits & 7) == 0 ? 8 : 4;
}

__device__ __forceinline__ void set_zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void set_zero(float2& a) { a = make_float2(0.0f, 0.0f); }
__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// T is float, float2 or float4 (V = 1, 2, 4) and kLoads is L; `chunks` is
// F / V, the row stride of data and out in units of T.
template <typename T, int kLoads>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ row_ptr,
                          T* __restrict__ out, int n_rows, int chunks, int n_edges, int lanes) {
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % lanes;
  // clamp so that a malformed row_ptr can never read outside data
  const int begin = max(row_ptr[row], 0);
  const int end = min(row_ptr[row + 1], n_edges);
  const size_t stride = static_cast<size_t>(chunks);
  for (int q = lane; q < chunks; q += lanes) {
    T acc;
    set_zero(acc);
    for (int e = begin; e < end; e += kLoads) {
      T v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (e + u < end) {
          v[u] = __ldg(data + static_cast<size_t>(e + u) * stride + q);
        } else {
          set_zero(v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (e + u < end) add_to(acc, v[u]);
      }
    }
    out[static_cast<size_t>(row) * stride + q] = acc;
  }
}

template <typename T, int kLoads>
void launch(const Plan& p, const float* data, const int* row_ptr, float* out, int n_rows,
            int n_cols, int n_edges, cudaStream_t s) {
  sorted_segment_sum_kernel<T, kLoads><<<p.blocks, kThreads, 0, s>>>(
      reinterpret_cast<const T*>(data), row_ptr, reinterpret_cast<T*>(out), n_rows,
      n_cols / p.vec, n_edges, p.lanes);
}

}  // namespace

// The launch sorted_segment_sum_f32 makes on the current device for n_rows x
// n_cols, with data and out both aligned to `align` bytes (4, 8 or 16):
// plan[0] columns per load (V), plan[1] lanes per row (G), plan[2] rows per
// block, plan[3] blocks, plan[4] loads in flight per lane (L), plan[5]
// blocks resident per SM. Returns a CUDA error code (0 on success).
extern "C" int sorted_segment_sum_plan(int n_rows, int n_cols, int align, int* plan) {
  int resident = 0;
  cudaError_t err = resident_threads(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(n_rows, n_cols, align, resident);
  int per_sm = 0;
  if (p.vec == 4) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sorted_segment_sum_kernel<float4, 4>, kThreads, 0);
  } else if (p.vec == 2) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sorted_segment_sum_kernel<float2, 8>, kThreads, 0);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sorted_segment_sum_kernel<float, 8>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.vec;
  plan[1] = p.lanes;
  plan[2] = p.rows_per_block;
  plan[3] = p.blocks;
  plan[4] = p.loads;
  plan[5] = per_sm;
  return 0;
}

// data [n_edges, n_cols] fp32, row_ptr [n_rows + 1] int32, out [n_rows, n_cols]
// fp32, all contiguous on the device; n_rows, n_cols >= 1. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
// Allocates nothing.
extern "C" int sorted_segment_sum_f32(const float* data, const int* row_ptr,
                                      float* out, int n_rows, int n_cols,
                                      int n_edges, void* stream) {
  int resident = 0;
  const cudaError_t err = resident_threads(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(n_rows, n_cols, alignment(data, out), resident);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.vec == 4) {
    launch<float4, 4>(p, data, row_ptr, out, n_rows, n_cols, n_edges, s);
  } else if (p.vec == 2) {
    launch<float2, 8>(p, data, row_ptr, out, n_rows, n_cols, n_edges, s);
  } else {
    launch<float, 8>(p, data, row_ptr, out, n_rows, n_cols, n_edges, s);
  }
  return static_cast<int>(cudaGetLastError());
}
