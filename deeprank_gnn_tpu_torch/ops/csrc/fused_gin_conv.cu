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
// The fast variant (fused_gin_conv_fast) is the counterpart of the Pallas
// body's non-exact branch (a single bf16 MXU pass, fp32 accumulation;
// deeprank_gnn_tpu/ops/pallas/__init__.py:178): the sums of the bf16-rounded
// xw, in fp32 in edge order, so its result is bitwise the fp32 plain version's
// on the rounded values, written fp32. It shares steps 1-4 and 6 with the
// exact kernel and has a sum step of its own (kFast), designed for bf16:
//  - it takes fp32 xw, so the path launches no cast before each call. The
//    block stages the fp32 slab with the exact kernel's bulk copy (which
//    overlaps the CSR's build), then rounds the whole slab once, to nearest
//    even, into a bf16 copy in shared memory (round_slab), which step 5
//    reads. Only where the slab does not fit in shared memory does step 5
//    read fp32 xw from device memory and round each element as it loads it;
//  - a lane owns 8 columns of a row: one 16-byte load of 8 bf16 from the
//    copy, held packed while the loads are in flight and widened by a shift
//    or a mask, so a row of F 32 takes 4 lanes (the exact kernel: 8 lanes of
//    float4) and a pass covers twice the rows;
//  - a block takes up to 256 rows (kFastRows; the exact kernel: 128), so a
//    graph of up to 256 slots takes one block and one slab copy, and conv1's
//    272 slots two (the exact kernel: three); a lane loads 2 source rows
//    before it adds them (kFastUnroll). Both were chosen by timing 64, 128
//    and 256 rows a block with 2 and 4 rows in flight on the card.
// Other forms measured slower on the card, as the path runs them: a cast
// launch before each call and then this kernel on bf16 xw (the kernel alone
// was faster, the pair slower); rounding each element as it is loaded from
// the fp32 slab (the conversions repeat for every edge that reads a row);
// staging with thread loads that round on the way in (they do not overlap
// the CSR's build as the bulk copy does).
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
constexpr int kFastRows = 256;   // the fast variant's output rows of one block, at most
constexpr int kFastUnroll = 2;   // the fast variant's kUnroll
constexpr int kBarBytes = 16;    // the mbarrier, padded to the slab's alignment

static_assert(kMaxRows <= kThreads && kFastRows <= kThreads,
              "the row scan gives one row to a thread");
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

// One element, or four consecutive ones, of xw.
template <typename T> __device__ __forceinline__ T load_as(const float* p);
template <> __device__ __forceinline__ float load_as<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float4 load_as<float4>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// The run's source rows are loaded kUnroll at a time and added in edge
// order. With `carry`, a row adds to what these lanes wrote on the last
// tile, and a row without edges here is left alone.
template <typename T>
__device__ __forceinline__ void sum_runs(const float* xs, float* dst, const int* row_off,
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

// Steps 2-4 for one tile whose edges a warp holds in key (row) and src_col
// (col), its segment of `seg` edges: keep the edges of this block's rows
// [r0, r0 + n_rows) whose row and col lie in [0, S), count and rank them per
// (warp, row) into hist [kWarps][rows_per_block] (zeroed by the caller),
// scan the counts into row_off [n_rows + 1] and each (warp, row)'s base
// (hist, in place), and write each kept edge's col at its place in csr. It
// ends with the block synchronised and the tile's CSR in shared memory.
__device__ __forceinline__ void tile_csr(int (&key)[kChunks], const int (&src_col)[kChunks],
                                         int seg, int r0, int n_rows, int n_slots,
                                         int rows_per_block, int* hist, int* row_off,
                                         int* warp_sum, int* csr) {
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const unsigned lanes_below = (1u << lane) - 1;
  int* warp_hist = hist + warp * rows_per_block;

  // 2. keep, count and rank: each warp a contiguous segment of the tile
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
}

// The fast variant's loads: bf16 operands, widened to fp32 exactly.

// Two fp32 rounded to bf16 (nearest even), packed: the first in the low half.
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

// bf16 widened to fp32 exactly: a bf16 is the high half of the fp32 of the
// same value, so the widening is a shift (the low element of a word) or a
// mask (the high one).
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(x)) << 16);
}
__device__ __forceinline__ void widen8(const uint4 u, float (&v)[8]) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
  v[4] = __uint_as_float(u.z << 16);
  v[5] = __uint_as_float(u.z & 0xffff0000u);
  v[6] = __uint_as_float(u.w << 16);
  v[7] = __uint_as_float(u.w & 0xffff0000u);
}

// Eight elements of xw as loaded: two float4, or 16 bytes of bf16.
template <typename In> struct Raw8;
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ Raw8<float> load_raw8(const float* p) {
  return {*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load_raw8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ uint4 pack8(const Raw8<float>& r) {
  return make_uint4(pack2(r.a.x, r.a.y), pack2(r.a.z, r.a.w), pack2(r.b.x, r.b.y),
                    pack2(r.b.z, r.b.w));
}
__device__ __forceinline__ uint4 pack8(const Raw8<__nv_bfloat16>& r) { return r.a; }

// Elements of shared memory for a bf16 copy of a slab of `n`, in whole 16
// bytes.
__host__ __device__ inline size_t bf16_elems(size_t n) { return (n + 7) / 8 * 8; }

// The staged fp32 slab (src, n elements) rounded to bf16 (nearest even) into
// dst (16-byte aligned) by the whole block: eight elements to a thread's
// 16-byte store where src is 16-byte aligned, else one at a time.
__device__ __forceinline__ void round_slab(const float* src, __nv_bfloat16* dst, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int c = threadIdx.x; c < n / 8; c += kThreads) d[c] = pack8(load_raw8(src + 8 * c));
    done = n / 8 * 8;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = to_bf16(src[i]);
}

// Sums of the runs of rows [0, n_rows) of a tile's CSR into out rows r0 +
// lr: a group of lanes (the next power of two of F / kV, at most a warp)
// owns a row, each lane kV columns per pass (8: one 16-byte load of bf16 a
// source row, two float4 stores). The run's source rows (Src: the bf16
// copy, or fp32 rounded here) are loaded kFastUnroll at a time and held
// packed as bf16 (4 registers for 8 columns), then widened and added in edge
// order in fp32. With `carry` a row adds to what these lanes wrote on the
// last tile, and a row without edges is left alone.
template <int kV, typename Src>
__device__ __forceinline__ void sum_runs_fast(const Src* xs, float* dst, const int* row_off,
                                              const int* csr, int r0, int n_rows, int n_cols,
                                              bool carry) {
  const int need = (n_cols + kV - 1) / kV;
  const int group = need > 16 ? kWarp : need > 8 ? 16 : need > 4 ? 8 : need > 2 ? 4 : need;
  const int glane = threadIdx.x % group;
  for (int lr = threadIdx.x / group; lr < n_rows; lr += kThreads / group) {
    const int lo = row_off[lr];
    const int hi = row_off[lr + 1];
    if (carry && lo == hi) continue;
    float* out_row = dst + static_cast<size_t>(r0 + lr) * n_cols;
    for (int f = glane * kV; f < n_cols; f += group * kV) {
      float acc[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) acc[k] = carry ? out_row[f + k] : 0.0f;
      for (int j = lo; j < hi; j += kFastUnroll) {
        if constexpr (kV == 8) {
          uint4 raw[kFastUnroll];
#pragma unroll
          for (int u = 0; u < kFastUnroll; ++u) {
            if (j + u < hi) {
              raw[u] = pack8(load_raw8(xs + static_cast<size_t>(csr[j + u]) * n_cols + f));
            }
          }
#pragma unroll
          for (int u = 0; u < kFastUnroll; ++u) {
            if (j + u < hi) {
              float w[8];
              widen8(raw[u], w);
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[k] += w[k];
            }
          }
        } else {
          float v[kFastUnroll];
#pragma unroll
          for (int u = 0; u < kFastUnroll; ++u) {
            if (j + u < hi) {
              v[u] = widen(to_bf16(xs[static_cast<size_t>(csr[j + u]) * n_cols + f]));
            }
          }
#pragma unroll
          for (int u = 0; u < kFastUnroll; ++u) {
            if (j + u < hi) acc[0] += v[u];
          }
        }
      }
      if constexpr (kV == 8) {
        float4* o = reinterpret_cast<float4*>(out_row + f);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        out_row[f] = acc[0];
      }
    }
  }
}

// The body of both kernels, exact (kFast false: sums of float4 or float
// lanes) or fast (kFast: the staged slab rounded to bf16 once into a copy in
// shared memory, or without a slab each element rounded as it is loaded;
// sums of 8 columns a lane, kFastUnroll source rows loaded at a time).
template <bool kSlab, bool kFast>
__device__ __forceinline__ void gin_conv_body(const float* __restrict__ xw,
                                              const int* __restrict__ row,
                                              const int* __restrict__ col,
                                              float* __restrict__ out, int n_slots, int n_cols,
                                              int n_edges, int rows_per_block,
                                              int blocks_per_graph, int edge_tile) {
  constexpr int kEpv = 4;  // elements of xw in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slab = static_cast<size_t>(n_slots) * n_cols;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* slab_s = reinterpret_cast<float*>(smem + kBarBytes);
  // the fast variant: the staged slab rounded to bf16, once
  __nv_bfloat16* slab_b = reinterpret_cast<__nv_bfloat16*>(
      slab_s + (kSlab ? slab_elems(slab, kEpv) : 0));
  constexpr bool kRound = kFast && kSlab;
  int* hist = reinterpret_cast<int*>(slab_b + (kRound ? bf16_elems(slab) : 0));  // [kWarps][R]
  int* row_off = hist + kWarps * rows_per_block;  // [R + 1]
  int* warp_sum = row_off + rows_per_block + 1;   // [kWarps]
  int* csr = warp_sum + kWarps;                   // [edge_tile]

  const size_t g = blockIdx.x / blocks_per_graph;
  const int r0 = static_cast<int>(blockIdx.x % blocks_per_graph) * rows_per_block;
  const int n_rows = min(rows_per_block, n_slots - r0);
  const float* src = xw + g * slab;
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
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(float));
  float* slab_g = slab_s + shift;
  if (kSlab) {
    const size_t head_to_16 = static_cast<size_t>((kEpv - shift) & (kEpv - 1));
    const size_t head = slab < head_to_16 ? slab : head_to_16;
    const size_t body = (slab - head) & ~static_cast<size_t>(kEpv - 1);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (body > 0) {
        bulk_copy(slab_g + head, src + head, static_cast<uint32_t>(body * sizeof(float)), bar);
      } else {
        asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                     :: "r"(smem_u32(bar)) : "memory");
      }
    }
    for (size_t i = tid; i < head; i += kThreads) slab_g[i] = src[i];
    for (size_t i = head + body + tid; i < slab; i += kThreads) slab_g[i] = src[i];
  }
  const float* xs = kSlab ? slab_g : src;

  // four columns to a load when every row of xs and of out starts on 16
  // bytes
  const bool vec4 = n_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  // the fast variant: eight columns to a lane when every row of its source
  // (the bf16 copy, or xs) and of out starts on 16 bytes
  const bool vec8 = n_cols % 8 == 0 &&
                    (kRound || (reinterpret_cast<uintptr_t>(xs) & 15) == 0) &&
                    (reinterpret_cast<uintptr_t>(dst) & 15) == 0;

  for (int t0 = 0; t0 < n_edges; t0 += edge_tile) {
    const int tlen = min(edge_tile, n_edges - t0);
    for (int i = tid; i < kWarps * rows_per_block; i += kThreads) hist[i] = 0;
    __syncthreads();

    // 2-4. keep, count and rank, scan, and the tile's CSR
    if (t0 > 0) load_edges(row_g, col_g, t0, tlen, tile_seg(tlen), warp, lane, key, src_col);
    tile_csr(key, src_col, tile_seg(tlen), r0, n_rows, n_slots, rows_per_block, hist, row_off,
             warp_sum, csr);
    if (kSlab && t0 == 0) wait_phase0(bar);

    // 5. sum each run in order; rows without edges write 0 on the first
    // tile and are left alone after it
    if constexpr (kRound) {
      if (t0 == 0) {
        round_slab(slab_g, slab_b, static_cast<int>(slab));
        __syncthreads();
      }
      if (vec8) {
        sum_runs_fast<8>(slab_b, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
      } else {
        sum_runs_fast<1>(slab_b, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
      }
    } else if constexpr (kFast) {
      if (vec8) {
        sum_runs_fast<8>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
      } else {
        sum_runs_fast<1>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
      }
    } else if (vec4) {
      sum_runs<float4>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
    } else {
      sum_runs<float>(xs, dst, row_off, csr, r0, n_rows, n_cols, t0 > 0);
    }
  }
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads)
fused_gin_conv_kernel(const float* __restrict__ xw, const int* __restrict__ row,
                      const int* __restrict__ col, float* __restrict__ out, int n_slots,
                      int n_cols, int n_edges, int rows_per_block, int blocks_per_graph,
                      int edge_tile) {
  gin_conv_body<kSlab, false>(xw, row, col, out, n_slots, n_cols, n_edges, rows_per_block,
                              blocks_per_graph, edge_tile);
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads)
fused_gin_conv_fast_kernel(const float* __restrict__ xw, const int* __restrict__ row,
                           const int* __restrict__ col, float* __restrict__ out, int n_slots,
                           int n_cols, int n_edges, int rows_per_block, int blocks_per_graph,
                           int edge_tile) {
  gin_conv_body<kSlab, true>(xw, row, col, out, n_slots, n_cols, n_edges, rows_per_block,
                             blocks_per_graph, edge_tile);
}

struct Plan {
  int slab;              // 1: the [S, F] slab is staged in shared memory
  int rows_per_block;    // output rows of one block
  int blocks_per_graph;  // ceil(S / rows_per_block)
  int edge_tile;         // edges per tile
  size_t smem;           // dynamic shared memory of one block, bytes
};

// The launch for these sizes (S, F, E > 0), with at most `max_rows` output
// rows a block and, with `bf16_copy`, room for the slab's bf16 copy beside
// it, from the device's shared memory.
cudaError_t make_plan(int n_slots, int n_cols, int n_edges, int max_rows, bool bf16_copy,
                      Plan* p) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  p->blocks_per_graph = (n_slots + max_rows - 1) / max_rows;
  p->rows_per_block = (n_slots + p->blocks_per_graph - 1) / p->blocks_per_graph;
  p->edge_tile = n_edges < kEdgeTile ? n_edges : kEdgeTile;
  const size_t ints = static_cast<size_t>(kWarps + 1) * p->rows_per_block + 1 + kWarps +
                      p->edge_tile;
  const size_t base = kBarBytes + ints * sizeof(int);
  const size_t n = static_cast<size_t>(n_slots) * n_cols;
  const size_t slab_bytes =
      slab_elems(n, 4) * sizeof(float) + (bf16_copy ? bf16_elems(n) * 2 : 0);
  p->slab = base + slab_bytes <= static_cast<size_t>(optin);
  p->smem = base + (p->slab ? slab_bytes : 0);
  return cudaSuccess;
}

using Kernel = void (*)(const float*, const int*, const int*, float*, int, int, int, int, int,
                        int);

// The plan and kernel of the exact kernel, or of the fast variant.
cudaError_t plan_kernel(int n_slots, int n_cols, int n_edges, bool fast, Plan* p,
                        Kernel* kernel) {
  const cudaError_t err =
      make_plan(n_slots, n_cols, n_edges, fast ? kFastRows : kMaxRows, fast, p);
  if (err != cudaSuccess) return err;
  if (fast) {
    *kernel = p->slab ? fused_gin_conv_fast_kernel<true> : fused_gin_conv_fast_kernel<false>;
  } else {
    *kernel = p->slab ? fused_gin_conv_kernel<true> : fused_gin_conv_kernel<false>;
  }
  if (p->smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(p->smem));
}

// Lanes that own an output row in the fast variant's sum step, and the
// columns of one lane.
int fast_cols_per_lane(int n_cols) { return n_cols % 8 == 0 ? 8 : 1; }
int fast_lanes_per_row(int n_cols) {
  const int need = (n_cols + fast_cols_per_lane(n_cols) - 1) / fast_cols_per_lane(n_cols);
  return need > 16 ? kWarp : need > 8 ? 16 : need > 4 ? 8 : need > 2 ? 4 : need;
}

cudaError_t plan_of(int n_slots, int n_cols, int n_edges, bool fast, int* plan) {
  Plan p;
  Kernel kernel = nullptr;
  cudaError_t err = plan_kernel(n_slots, n_cols, n_edges, fast, &p, &kernel);
  int resident = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, p.smem);
  }
  if (err != cudaSuccess) return err;
  plan[0] = p.slab;
  plan[1] = p.rows_per_block;
  plan[2] = p.blocks_per_graph;
  plan[3] = static_cast<int>(p.smem);
  plan[4] = resident;
  if (fast) {
    plan[5] = fast_lanes_per_row(n_cols);
    plan[6] = fast_cols_per_lane(n_cols);
    plan[7] = kFastUnroll;
  }
  plan[fast ? 8 : 5] = p.edge_tile;
  return cudaSuccess;
}

cudaError_t launch(const float* xw, const int* row, const int* col, float* out, int n_graphs,
                   int n_slots, int n_cols, int n_edges, bool fast, cudaStream_t s) {
  if (n_graphs == 0 || n_slots == 0 || n_cols == 0) return cudaSuccess;
  if (n_edges == 0) {
    const size_t bytes = static_cast<size_t>(n_graphs) * n_slots * n_cols * sizeof(float);
    return cudaMemsetAsync(out, 0, bytes, s);
  }
  Plan p;
  Kernel kernel = nullptr;
  cudaError_t err = plan_kernel(n_slots, n_cols, n_edges, fast, &p, &kernel);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(n_graphs) * p.blocks_per_graph;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, p.smem, s>>>(
      xw, row, col, out, n_slots, n_cols, n_edges, p.rows_per_block, p.blocks_per_graph,
      p.edge_tile);
  return cudaGetLastError();
}

}  // namespace

// The launch fused_gin_conv_f32 makes for these sizes (all > 0), into
// plan[0..5]: 1 when the slab is staged in shared memory (else 0), rows per
// block, blocks per graph, dynamic shared memory per block in bytes, blocks
// resident per SM, and edges per tile (a block walks ceil(E / tile) tiles).
// Returns a CUDA error code (0 on success).
extern "C" int fused_gin_conv_plan(int n_slots, int n_cols, int n_edges, int* plan) {
  return static_cast<int>(plan_of(n_slots, n_cols, n_edges, false, plan));
}

// xw [G, S, F] fp32, row and col [G, E] int32, out [G, S, F] fp32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Allocates nothing.
extern "C" int fused_gin_conv_f32(const float* xw, const int* row, const int* col, float* out,
                                  int n_graphs, int n_slots, int n_cols, int n_edges,
                                  void* stream) {
  return static_cast<int>(launch(xw, row, col, out, n_graphs, n_slots, n_cols, n_edges, false,
                                 static_cast<cudaStream_t>(stream)));
}

// The launch fused_gin_conv_fast makes for these sizes (all > 0), into
// plan[0..8]: the first five fields of fused_gin_conv_plan, then lanes per
// row, columns per lane, source rows loaded before they are added, and edges
// per tile.
extern "C" int fused_gin_conv_fast_plan(int n_slots, int n_cols, int n_edges, int* plan) {
  return static_cast<int>(plan_of(n_slots, n_cols, n_edges, true, plan));
}

// The fast variant: xw rounded to bf16 (nearest even) in the kernel, fp32
// sums in edge order into out; the arguments as fused_gin_conv_f32's.
extern "C" int fused_gin_conv_fast(const float* xw, const int* row, const int* col, float* out,
                                   int n_graphs, int n_slots, int n_cols, int n_edges,
                                   void* stream) {
  return static_cast<int>(launch(xw, row, col, out, n_graphs, n_slots, n_cols, n_edges, true,
                                 static_cast<cudaStream_t>(stream)));
}
