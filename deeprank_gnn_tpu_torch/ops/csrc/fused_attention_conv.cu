// K4: the dense attention conv of GINet (attention=True), forward and
// backward, over a per-graph CSR of its edge lanes.
//
// For xw [G, S, F] fp32 (x W, one row per node slot), p, q [G, S] (xw . a[:F]
// and xw . a[F:2F]), b [G, E] (the edge term (e W_e) . a[2F:]) and row, col
// [G, E] int32, a lane e of graph g with row r and col c in [0, S) has the
// logit
//
//   z_e = leaky_relu((p[r] + q[c]) + b_e),  slope 0.01,
//
// and the conv is a softmax of the logits over each row's lanes, then the sum
// of xw[c] weighted by it:
//
//   m_r = max z_e,  d_r = sum exp(z_e - m_r),  alpha_e = exp(z_e - m_r) / d_r,
//   out[r] = sum alpha_e * xw[c].
//
// A lane whose row or col lies outside [0, S) (the collate's sentinel) drops
// out: alpha 0, no term anywhere. A row without lanes gives 0.
//
// It replaces no TPU kernel: the JAX package leaves the attention conv to XLA
// (deeprank_gnn_tpu/models/ginet.py conv_att, the one-hot products of
// ops/dense.py). The port first ran it as plain torch over [G, E, F] edge
// slots: two gathers of xw, the logits' concatenation, a softmax over
// flattened slots and an edge-to-slot sum, each sum an index_add_ that sorts
// its indices. On the atomic graphs that took 61 ms a training step.
//
// Bound: bytes. A forward call reads xw's rows that lanes name, p, q, b, col
// and the CSR once, and writes out and alpha once: ~77 MB at conv1's atomic
// shapes (G 64, S 5,216, F 16, E 30,080), 23 us at 3.35 TB/s. The arithmetic
// is a few flops per lane and column.
//
// Design.
//  - attention_csr: one block a graph sorts its lanes by one index (row, or
//    col for the backward's second pass) into ptr [G, S + 1] and perm [G, E]:
//    each row's lanes in ascending lane order, then the dropped lanes in
//    ascending order from ptr[S]. Each warp takes a contiguous segment of the
//    lanes in 32-lane chunks; __match_any_sync gives a lane its peers in the
//    chunk and its rank among them, and the leader of each peer group adds
//    the group's size to the warp's count of that row in shared memory (no
//    atomics). A scan over the rows, and over the warps within a row, turns
//    the counts into each (warp, row)'s first place; a second walk over the
//    same chunks writes every lane's index at its place. A step builds four
//    (row and col of conv1 and of conv2), and all four convs of both towers
//    and their backward read them.
//  - forward: a group of lanes owns a row (the next power of two of F / 4
//    float4 columns, at most a warp: conv1 4 lanes, conv2 8), and its lanes
//    take the row's lanes a chunk of the group's size at a time (the passes'
//    section below): the logits and their max, exp and the denominator, the
//    weights, then the weighted sum of the xw rows in registers, each lane
//    its columns. It writes the row once. Each graph has one more task, which
//    writes alpha 0 at the dropped lanes, so alpha needs no fill. xw is read
//    from device memory through L2 (conv1's [5,216, 16] slab is 334 KB a
//    graph; the batch's 21 MB of xw stay in the 50 MB L2).
//  - backward, pass R (by row): dA_e = dout[r] . xw[c] (one lane an edge, in
//    column order), s_r = sum alpha_e dA_e, then dpre_e = alpha_e (dA_e -
//    s_r) times leaky_relu's slope at the pre-activation, written to db, and
//    dp[r] = sum dpre_e.
//  - backward, pass C (by col, over the col CSR): dxw[c] = sum alpha_e
//    dout[row_e] and dq[c] = sum dpre_e.
// Every sum runs in ascending lane order, a product rounded before its add
// (the plain version's msg * alpha, then index_add_), with no atomics: two
// launches are bitwise equal, and each sum is the plain version's where the
// terms are. exp is expf (no fast math), so alpha matches the plain version
// on the card; dA_e's dot product adds in its own order. Nothing allocates
// or synchronises with the host, so a step with these launches captures into
// a CUDA graph.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;       // the conv passes' block
constexpr int kCsrMaxWarps = 8;     // warps of the CSR build's block, at most
constexpr int kCsrBatch = 4;        // 32-lane chunks a CSR warp loads at a time
constexpr float kSlope = 0.01f;     // leaky_relu's negative slope

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <typename T> __device__ __forceinline__ T load_as(const float* p);
template <> __device__ __forceinline__ float load_as<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float4 load_as<float4>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + v * a, the product rounded before the add
__device__ __forceinline__ void add_scaled(float& acc, float v, float a) {
  acc = __fadd_rn(acc, __fmul_rn(v, a));
}
__device__ __forceinline__ void add_scaled(float4& acc, const float4& v, float a) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, a));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, a));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, a));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, a));
}

// the dot product of a lane's columns, in column order
__device__ __forceinline__ float dot_add(float acc, float u, float v) {
  return __fmaf_rn(u, v, acc);
}
__device__ __forceinline__ float dot_add(float acc, const float4& u, const float4& v) {
  acc = __fmaf_rn(u.x, v.x, acc);
  acc = __fmaf_rn(u.y, v.y, acc);
  acc = __fmaf_rn(u.z, v.z, acc);
  return __fmaf_rn(u.w, v.w, acc);
}

// (p_r + q_c) + b_e: the logit before leaky_relu
__device__ __forceinline__ float pre_logit(float pr, float qc, float be) {
  return __fadd_rn(__fadd_rn(pr, qc), be);
}
__device__ __forceinline__ float leaky(float x) { return x > 0.0f ? x : __fmul_rn(x, kSlope); }

// ---------------------------------------------------------------------------
// attention_csr

// A lane's bucket: its key where key and other lie in [0, S), else S (the
// dropped lanes, last).
__device__ __forceinline__ int bucket(int key, int other, int n_slots) {
  return key >= 0 && key < n_slots && other >= 0 && other < n_slots ? key : n_slots;
}

// Walks one warp's segment [e0, e1) in 32-lane chunks, kCsrBatch chunks'
// loads at a time, and calls visit(e, k, peers) in every lane of each chunk:
// its lane e, its bucket k (-1 past e1) and the lanes of the chunk that share
// k.
template <typename Visit>
__device__ __forceinline__ void walk_segment(const int* key, const int* other, int e0, int e1,
                                             int n_slots, Visit visit) {
  const int lane = threadIdx.x % kWarp;
  for (int base = e0; base < e1; base += kWarp * kCsrBatch) {
    int k[kCsrBatch];
#pragma unroll
    for (int u = 0; u < kCsrBatch; ++u) {
      const int e = base + u * kWarp + lane;
      k[u] = e < e1 ? bucket(key[e], other[e], n_slots) : -1;
    }
#pragma unroll
    for (int u = 0; u < kCsrBatch; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, k[u]);
      visit(base + u * kWarp + lane, k[u], peers);
    }
  }
}

__global__ void __launch_bounds__(kCsrMaxWarps * kWarp)
attention_csr_kernel(const int* __restrict__ key, const int* __restrict__ other,
                     int* __restrict__ ptr, int* __restrict__ perm, int n_slots, int n_edges) {
  extern __shared__ int cnt[];  // [warps][S + 1], then [warps] warp sums
  const int warps = blockDim.x / kWarp;
  const int nb = n_slots + 1;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t g = blockIdx.x;
  const int* key_g = key + g * n_edges;
  const int* other_g = other + g * n_edges;
  int* ptr_g = ptr + g * nb;
  int* perm_g = perm + g * n_edges;
  int* wc = cnt + warp * nb;
  int* warp_sum = cnt + warps * nb;

  for (int i = tid; i < warps * nb; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  // each warp a contiguous segment of whole chunks, warp 0 the first lanes
  const int seg = ((n_edges + warps - 1) / warps + kWarp - 1) / kWarp * kWarp;
  const int e0 = min(warp * seg, n_edges);
  const int e1 = min(e0 + seg, n_edges);

  // 1. count each bucket per warp
  walk_segment(key_g, other_g, e0, e1, n_slots, [&](int, int k, unsigned peers) {
    if (k >= 0 && lane == __ffs(peers) - 1) wc[k] += __popc(peers);
    __syncwarp();
  });
  __syncthreads();

  // 2. scan: a thread takes a contiguous range of buckets; each bucket's
  // start, and each warp's first place in it (cnt, in place)
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int k0 = min(tid * per, nb);
  const int k1 = min(k0 + per, nb);
  int total = 0;
  for (int k = k0; k < k1; ++k) {
    for (int w = 0; w < warps; ++w) total += cnt[w * nb + k];
  }
  int incl = total;
  for (int d = 1; d < kWarp; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == kWarp - 1) warp_sum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_sum[w];
  int start = incl - total;
  for (int k = k0; k < k1; ++k) {
    ptr_g[k] = start;
    for (int w = 0; w < warps; ++w) {
      const int c = cnt[w * nb + k];
      cnt[w * nb + k] = start;
      start += c;
    }
  }
  __syncthreads();

  // 3. place: the same walk, each lane at its warp's next place in its bucket
  walk_segment(key_g, other_g, e0, e1, n_slots, [&](int e, int k, unsigned peers) {
    const int before = k >= 0 ? wc[k] : 0;
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) wc[k] = before + __popc(peers);
    __syncwarp();
    if (k >= 0) perm_g[before + __popc(peers & lanes_below)] = e;
  });
}

// ---------------------------------------------------------------------------
// the conv's passes
//
// A group of kG lanes owns a row (pass C: a col). Its lanes take the row's
// lanes kG at a time, lane l the l-th of each chunk, for what is one value a
// lane (the logits, exp, the weights, dA_e by a dot product over all F
// columns, dpre_e): the index loads and that arithmetic are spread over the
// group. A sum over the row runs in ascending lane order: each chunk's kG
// values are passed round the group by shuffles and every lane adds them in
// order, so all lanes hold the same sum. The weighted sums of rows (out,
// dxw) are the other way round: each lane owns kV columns (a float4 or a
// float), the chunk's indices and weights are passed round, and each lane
// adds its columns of the chunk's rows in order. Per-lane values a later
// step reads (the logits, then exp, then alpha; dA_e, then dpre_e) are kept
// in alpha and db at the lane's own entries, read back by the same lane.

struct Task {
  size_t g;   // graph
  int r;      // row (or col), S for the dropped lanes
  int glane;  // lane within the group
};

// This thread's task over G * n_tasks tasks a graph, or false past them.
template <int kG>
__device__ __forceinline__ bool task_of(int n_graphs, int n_tasks, Task* t) {
  const long long i = static_cast<long long>(blockIdx.x) * (kThreads / kG) + threadIdx.x / kG;
  if (i >= static_cast<long long>(n_graphs) * n_tasks) return false;
  t->g = static_cast<size_t>(i / n_tasks);
  t->r = static_cast<int>(i % n_tasks);
  t->glane = threadIdx.x % kG;
  return true;
}

// The lanes of this thread's group in its warp, for the group's shuffles.
template <int kG>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned bits = kG == kWarp ? 0xffffffffu : (1u << kG) - 1u;
  return bits << (threadIdx.x % kWarp / kG * kG);
}

// sum += the chunk's first n values of v, lane 0's first, in every lane
template <int kG>
__device__ __forceinline__ void add_in_order(float& sum, float v, int n, unsigned mask) {
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const float w = __shfl_sync(mask, v, k, kG);
    if (k < n) sum = __fadd_rn(sum, w);
  }
}

// acc (this lane's kV columns at f) += the chunk's first n rows `idx` of src,
// each times its weight `a`, lane 0's first; `has` false: the lane owns no
// columns here (it still passes its values round)
template <typename T, int kG>
__device__ __forceinline__ void add_rows_in_order(T& acc, const float* src, int idx, float a,
                                                  int n, int f, int n_cols, bool has,
                                                  unsigned mask) {
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const int ik = __shfl_sync(mask, idx, k, kG);
    const float ak = __shfl_sync(mask, a, k, kG);
    if (k < n && has) add_scaled(acc, load_as<T>(src + static_cast<size_t>(ik) * n_cols + f), ak);
  }
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ p,
                     const float* __restrict__ q, const float* __restrict__ b,
                     const int* __restrict__ col, const int* __restrict__ ptr,
                     const int* __restrict__ perm, float* __restrict__ out,
                     float* __restrict__ alpha, int n_graphs, int n_slots, int n_cols,
                     int n_edges) {
  constexpr int kV = sizeof(T) / sizeof(float);
  const int nb = n_slots + 1;
  Task t;
  if (!task_of<kG>(n_graphs, nb, &t)) return;
  const int* ptr_g = ptr + t.g * nb;
  const int* perm_g = perm + t.g * n_edges;
  float* alpha_g = alpha + t.g * n_edges;
  const int lo = ptr_g[t.r];
  if (t.r == n_slots) {  // the dropped lanes: weight 0
    for (int j = lo + t.glane; j < n_edges; j += kG) alpha_g[perm_g[j]] = 0.0f;
    return;
  }
  const int hi = ptr_g[t.r + 1];
  const int* col_g = col + t.g * n_edges;
  const float* b_g = b + t.g * n_edges;
  const float* q_g = q + t.g * n_slots;
  const float* xw_g = xw + t.g * n_slots * n_cols;
  const float pr = p[t.g * n_slots + t.r];
  const unsigned mask = group_mask<kG>();

  // 1. the logits (kept in alpha) and their max
  float m = -INFINITY;
  for (int j = lo + t.glane; j < hi; j += kG) {
    const int e = perm_g[j];
    const float z = leaky(pre_logit(pr, q_g[col_g[e]], b_g[e]));
    alpha_g[e] = z;
    m = fmaxf(m, z);
  }
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(mask, m, o, kG));
  // 2. exp (kept in alpha) and the denominator
  float den = 0.0f;
  for (int jb = lo; jb < hi; jb += kG) {
    const int j = jb + t.glane;
    float ex = 0.0f;
    if (j < hi) {
      const int e = perm_g[j];
      ex = expf(__fsub_rn(alpha_g[e], m));
      alpha_g[e] = ex;
    }
    add_in_order<kG>(den, ex, hi - jb, mask);
  }
  // 3. the weights
  for (int j = lo + t.glane; j < hi; j += kG) {
    const int e = perm_g[j];
    alpha_g[e] = __fdiv_rn(alpha_g[e], den);
  }
  // 4. the weighted sum of the xw rows, written once
  float* out_r = out + (t.g * n_slots + t.r) * n_cols;
  for (int f0 = 0; f0 < n_cols; f0 += kG * kV) {
    const int f = f0 + t.glane * kV;
    const bool has = f < n_cols;
    T acc = zero<T>();
    for (int jb = lo; jb < hi; jb += kG) {
      const int j = jb + t.glane;
      int c = 0;
      float a = 0.0f;
      if (j < hi) {
        const int e = perm_g[j];
        c = col_g[e];
        a = alpha_g[e];
      }
      add_rows_in_order<T, kG>(acc, xw_g, c, a, hi - jb, f, n_cols, has, mask);
    }
    if (has) *reinterpret_cast<T*>(out_r + f) = acc;
  }
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const float* __restrict__ dout, const float* __restrict__ xw,
                          const float* __restrict__ p, const float* __restrict__ q,
                          const float* __restrict__ b, const int* __restrict__ col,
                          const float* __restrict__ alpha, const int* __restrict__ ptr,
                          const int* __restrict__ perm, float* __restrict__ db,
                          float* __restrict__ dp, int n_graphs, int n_slots, int n_cols,
                          int n_edges) {
  constexpr int kV = sizeof(T) / sizeof(float);
  const int nb = n_slots + 1;
  Task t;
  if (!task_of<kG>(n_graphs, nb, &t)) return;
  const int* ptr_g = ptr + t.g * nb;
  const int* perm_g = perm + t.g * n_edges;
  float* db_g = db + t.g * n_edges;
  const int lo = ptr_g[t.r];
  if (t.r == n_slots) {  // the dropped lanes: no gradient
    for (int j = lo + t.glane; j < n_edges; j += kG) db_g[perm_g[j]] = 0.0f;
    return;
  }
  const int hi = ptr_g[t.r + 1];
  const int* col_g = col + t.g * n_edges;
  const float* alpha_g = alpha + t.g * n_edges;
  const float* xw_g = xw + t.g * n_slots * n_cols;
  const float* dout_r = dout + (t.g * n_slots + t.r) * n_cols;
  const unsigned mask = group_mask<kG>();

  // 1. dA_e = dout[r] . xw[c] (kept in db) and s_r = sum alpha_e dA_e
  float s = 0.0f;
  for (int jb = lo; jb < hi; jb += kG) {
    const int j = jb + t.glane;
    float term = 0.0f;
    if (j < hi) {
      const int e = perm_g[j];
      const float* xc = xw_g + static_cast<size_t>(col_g[e]) * n_cols;
      float da = 0.0f;
      for (int f = 0; f < n_cols; f += kV) {
        da = dot_add(da, load_as<T>(dout_r + f), load_as<T>(xc + f));
      }
      db_g[e] = da;
      term = __fmul_rn(alpha_g[e], da);
    }
    add_in_order<kG>(s, term, hi - jb, mask);
  }
  // 2. dpre_e = alpha_e (dA_e - s_r) leaky_relu'(pre_e) into db, and dp[r]
  const float* b_g = b + t.g * n_edges;
  const float* q_g = q + t.g * n_slots;
  const float pr = p[t.g * n_slots + t.r];
  float dps = 0.0f;
  for (int jb = lo; jb < hi; jb += kG) {
    const int j = jb + t.glane;
    float d = 0.0f;
    if (j < hi) {
      const int e = perm_g[j];
      const float u = __fmul_rn(alpha_g[e], __fsub_rn(db_g[e], s));
      d = pre_logit(pr, q_g[col_g[e]], b_g[e]) > 0.0f ? u : __fmul_rn(u, kSlope);
      db_g[e] = d;
    }
    add_in_order<kG>(dps, d, hi - jb, mask);
  }
  if (t.glane == 0) dp[t.g * n_slots + t.r] = dps;
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_kernel(const float* __restrict__ dout, const int* __restrict__ row,
                          const float* __restrict__ alpha, const float* __restrict__ db,
                          const int* __restrict__ ptr, const int* __restrict__ perm,
                          float* __restrict__ dxw, float* __restrict__ dq, int n_graphs,
                          int n_slots, int n_cols, int n_edges) {
  constexpr int kV = sizeof(T) / sizeof(float);
  Task t;
  if (!task_of<kG>(n_graphs, n_slots, &t)) return;
  const int* ptr_g = ptr + t.g * (n_slots + 1);
  const int* perm_g = perm + t.g * n_edges;
  const int* row_g = row + t.g * n_edges;
  const float* alpha_g = alpha + t.g * n_edges;
  const float* db_g = db + t.g * n_edges;
  const float* dout_g = dout + t.g * n_slots * n_cols;
  const int lo = ptr_g[t.r];
  const int hi = ptr_g[t.r + 1];
  const unsigned mask = group_mask<kG>();

  // dxw[c] = sum alpha_e dout[row_e], written once
  float* dxw_c = dxw + (t.g * n_slots + t.r) * n_cols;
  for (int f0 = 0; f0 < n_cols; f0 += kG * kV) {
    const int f = f0 + t.glane * kV;
    const bool has = f < n_cols;
    T acc = zero<T>();
    for (int jb = lo; jb < hi; jb += kG) {
      const int j = jb + t.glane;
      int r = 0;
      float a = 0.0f;
      if (j < hi) {
        const int e = perm_g[j];
        r = row_g[e];
        a = alpha_g[e];
      }
      add_rows_in_order<T, kG>(acc, dout_g, r, a, hi - jb, f, n_cols, has, mask);
    }
    if (has) *reinterpret_cast<T*>(dxw_c + f) = acc;
  }
  // dq[c] = sum dpre_e
  float dqs = 0.0f;
  for (int jb = lo; jb < hi; jb += kG) {
    const int j = jb + t.glane;
    add_in_order<kG>(dqs, j < hi ? db_g[perm_g[j]] : 0.0f, hi - jb, mask);
  }
  if (t.glane == 0) dq[t.g * n_slots + t.r] = dqs;
}

// One instantiation of a conv pass for a group of `group` lanes (a power of
// two up to a warp).
#define K4_FOR_GROUP(kernel, T, group)                                                  \
  ((group) == 1 ? kernel<T, 1> : (group) == 2 ? kernel<T, 2> : (group) == 4 ? kernel<T, 4> \
   : (group) == 8 ? kernel<T, 8> : (group) == 16 ? kernel<T, 16> : kernel<T, 32>)

// ---------------------------------------------------------------------------
// plans and launches

// Lanes of a group that owns a row: the next power of two of the row's
// float4 (or float) columns, at most a warp.
int group_of(int n_cols, int vec) {
  const int need = (n_cols + vec - 1) / vec;
  return need > 16 ? kWarp : need > 8 ? 16 : need > 4 ? 8 : need > 2 ? 4 : need > 1 ? 2 : 1;
}

bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

// Warps of the CSR build's block and its shared memory: as many warps (at
// most kCsrMaxWarps) as the per-warp counts of S + 1 buckets fit.
cudaError_t csr_plan(int n_slots, int* warps, size_t* smem) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  for (int w = kCsrMaxWarps; w >= 1; w /= 2) {
    const size_t bytes = (static_cast<size_t>(w) * (n_slots + 1) + w) * sizeof(int);
    if (bytes <= static_cast<size_t>(optin)) {
      *warps = w;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // S too large for one graph's counts
}

long long conv_blocks(int n_graphs, int n_tasks, int group) {
  const int per_block = kThreads / group;
  return (static_cast<long long>(n_graphs) * n_tasks + per_block - 1) / per_block;
}

}  // namespace

// The launches for these sizes (S, F > 0), into plan[0..4]: lanes a row's
// group, floats a lane loads at a time (4 where F is a multiple of 4, else
// 1; the launch takes 1 where a pointer is not 16-byte aligned), rows a
// block, the CSR build's warps, and its dynamic shared memory in bytes.
extern "C" int fused_attention_conv_plan(int n_slots, int n_cols, int* plan) {
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err = csr_plan(n_slots, &warps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n_cols % 4 == 0 ? 4 : 1;
  plan[0] = group_of(n_cols, vec);
  plan[1] = vec;
  plan[2] = kThreads / plan[0];
  plan[3] = warps;
  plan[4] = static_cast<int>(smem);
  return 0;
}

// key, other [G, E] int32; ptr [G, S + 1] and perm [G, E] int32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted). Allocates nothing.
extern "C" int attention_csr(const int* key, const int* other, int* ptr, int* perm,
                             int n_graphs, int n_slots, int n_edges, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_graphs == 0) return 0;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = csr_plan(n_slots, &warps, &smem);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_csr_kernel<<<n_graphs, warps * kWarp, smem, s>>>(key, other, ptr, perm, n_slots,
                                                             n_edges);
  return static_cast<int>(cudaGetLastError());
}

// xw [G, S, F], p, q [G, S], b [G, E] fp32; col [G, E] int32; ptr [G, S + 1]
// and perm [G, E] the row CSR (attention_csr of row, col); out [G, S, F] and
// alpha [G, E] fp32: all contiguous on the current device. Launches on
// `stream`; returns cudaGetLastError(). Allocates nothing.
extern "C" int fused_attention_conv_f32(const float* xw, const float* p, const float* q,
                                        const float* b, const int* col, const int* ptr,
                                        const int* perm, float* out, float* alpha, int n_graphs,
                                        int n_slots, int n_cols, int n_edges, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_graphs == 0) return 0;
  const bool vec4 = n_cols % 4 == 0 && aligned16(xw) && aligned16(out);
  const int group = group_of(n_cols, vec4 ? 4 : 1);
  const long long blocks = conv_blocks(n_graphs, n_slots + 1, group);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = vec4 ? K4_FOR_GROUP(attention_fwd_kernel, float4, group)
                           : K4_FOR_GROUP(attention_fwd_kernel, float, group);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xw, p, q, b, col, ptr, perm, out, alpha, n_graphs, n_slots, n_cols, n_edges);
  return static_cast<int>(cudaGetLastError());
}

// The backward of fused_attention_conv_f32 for the cotangent dout [G, S, F]:
// pass R over the row CSR (ptr_r, perm_r) writes db [G, E] and dp [G, S],
// then pass C over the col CSR (ptr_c, perm_c: attention_csr of col, row)
// writes dxw [G, S, F] and dq [G, S]; xw, p, q, b, row, col and alpha as the
// forward had them. Two launches on `stream`; returns cudaGetLastError().
// Allocates nothing.
extern "C" int fused_attention_conv_bwd_f32(
    const float* dout, const float* xw, const float* p, const float* q, const float* b,
    const int* row, const int* col, const float* alpha, const int* ptr_r, const int* perm_r,
    const int* ptr_c, const int* perm_c, float* dxw, float* dp, float* dq, float* db,
    int n_graphs, int n_slots, int n_cols, int n_edges, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_graphs == 0) return 0;
  const bool vec4 = n_cols % 4 == 0 && aligned16(dout) && aligned16(xw) && aligned16(dxw);
  const int group = group_of(n_cols, vec4 ? 4 : 1);
  const long long rows_blocks = conv_blocks(n_graphs, n_slots + 1, group);
  const long long cols_blocks = conv_blocks(n_graphs, n_slots, group);
  if (rows_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto pass_r = vec4 ? K4_FOR_GROUP(attention_bwd_rows_kernel, float4, group)
                           : K4_FOR_GROUP(attention_bwd_rows_kernel, float, group);
  pass_r<<<static_cast<unsigned>(rows_blocks), kThreads, 0, s>>>(
      dout, xw, p, q, b, col, alpha, ptr_r, perm_r, db, dp, n_graphs, n_slots, n_cols, n_edges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cols_blocks == 0) return 0;  // S 0: no col to sum into
  const auto pass_c = vec4 ? K4_FOR_GROUP(attention_bwd_cols_kernel, float4, group)
                           : K4_FOR_GROUP(attention_bwd_cols_kernel, float, group);
  pass_c<<<static_cast<unsigned>(cols_blocks), kThreads, 0, s>>>(
      dout, row, alpha, db, ptr_c, perm_c, dxw, dq, n_graphs, n_slots, n_cols, n_edges);
  return static_cast<int>(cudaGetLastError());
}
