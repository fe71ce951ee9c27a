// Pass 1 and the lossless top-m selection shared by the top-K and coarse
// top-m kernels.
//
// Order: (value desc, index asc), which is jax.lax.top_k's tie rule over the
// whole masked score row. Both kernels select in two passes:
//   pass 1 (chunk_kernel below), one CTA per (item chunk of kChunk rows, kQ
//     queries): unpack the codes with shift+mask from the chunk-interleaved
//     layout (any width <= the packed width, so padded packs work), turn
//     each into the value staged in shared memory kDT features at a time
//     (Step::stage), form each dot as one sequential fp32 FMA chain, and
//     turn it into the item's score (Step::score). Tail rows past n_items
//     score -inf; each query's exclusion ids that fall in the chunk set
//     their score to -inf. A warp then ranks one query's chunk scores:
//     entry t lands in slot rank(t) of the chunk's list when
//     rank(t) < L = min(m, kChunk), rank(t) being the number of entries
//     ahead of it in the order. The list is sorted and exact: the top L of
//     the chunk.
//   pass 2 (merge_lists below): ceil(log2(n_chunks)) rounds each merge list
//     pairs (2j, 2j+1) into list j, truncated to m. An entry's place in the
//     merged list is its place in its own list plus the count of entries of
//     the other list ahead of it (a binary search). Indices are distinct, so
//     the places form a permutation: every round is exact, for any
//     1 <= m <= n_items, m = n_items included.
// Entries of the tail chunk past n_items (ghost rows) carry -inf and ids
// >= n_items, so with m <= n_items none survives to the result.
//
// A Step is the per-item arithmetic of one kernel:
//   static float stage(const ChunkArgs&, int item, int col, unsigned code)
//     the value staged for (item, col); code is the unpacked code (0 when
//     bits == 0);
//   static float score(const ChunkArgs&, int b, int item, float dot)
//     the score of item for query b from its dot with q.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace topk_select {

constexpr int kChunk = 128;  // items per CTA in pass 1
constexpr int kQ = 32;       // queries per CTA in pass 1
constexpr int kDT = 32;      // features staged per step
constexpr int kThreads = 256;
constexpr int kItemsPerThread = kQ * kChunk / kThreads;  // 16
constexpr int kGroup = kThreads / kQ;                    // threads per query
constexpr int kMergeThreads = 256;

// The inputs of pass 1. q is (B, dim) fp32; packed (n_items, dp) uint8 at
// bits in {1,2,4,8}, or items (n_items, dim) fp32 at bits == 0; scale/zero
// (n_items,) fp32; qmeta (B, 2) fp32 or null; excl (B, P) int32, -1 pads.
struct ChunkArgs {
  const float* q;
  const float* qmeta;
  int B;
  int dim;
  const uint8_t* packed;
  int dp;
  int bits;
  const float* items;
  const float* scale;
  const float* zero;
  const int* excl;
  int P;
  int n_items;
};

// (value desc, index asc)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Pass 1 for one score row s[0, n) with ids i0 + t, run by the 32 lanes of
// one warp: writes the top L entries, sorted, to out_v/out_i.
__device__ __forceinline__ void select_chunk(const float* s, int n, int i0,
                                             int L, float* out_v, int* out_i,
                                             int lane) {
  for (int t = lane; t < n; t += 32) {
    const float v = s[t];
    const int i = i0 + t;
    int rank = 0;
    for (int u = 0; u < n; ++u) rank += better(s[u], i0 + u, v, i) ? 1 : 0;
    if (rank < L) {
      out_v[rank] = v;
      out_i[rank] = i;
    }
  }
}

// Pass 1: the top L of each chunk, per query, into cand_v/cand_i at
// b * row + chunk * L.
template <class Step>
__global__ void chunk_kernel(ChunkArgs a, int L, size_t row,
                             float* __restrict__ cand_v,
                             int* __restrict__ cand_i) {
  __shared__ float sx[kChunk][kDT + 1];
  __shared__ float sq[kQ][kDT + 1];
  __shared__ float ss[kQ][kChunk + 1];

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * kQ;
  const int i0 = chunk * kChunk;
  const int tid = threadIdx.x;
  const int qb = tid / kGroup;  // this thread's query row in the CTA
  const int ig = tid % kGroup;  // items ig, ig+kGroup, ...
  const unsigned mask = (1u << a.bits) - 1u;

  float acc[kItemsPerThread];
#pragma unroll
  for (int t = 0; t < kItemsPerThread; ++t) acc[t] = 0.0f;

  for (int j0 = 0; j0 < a.dim; j0 += kDT) {
    for (int e = tid; e < kChunk * kDT; e += kThreads) {
      const int ii = e / kDT, jj = e % kDT;
      const int item = i0 + ii, col = j0 + jj;
      float v = 0.0f;
      if (item < a.n_items && col < a.dim) {
        unsigned code = 0;
        if (a.bits > 0) {
          const unsigned byte =
              a.packed[static_cast<size_t>(item) * a.dp + col % a.dp];
          code = (byte >> ((col / a.dp) * a.bits)) & mask;
        }
        v = Step::stage(a, item, col, code);
      }
      sx[ii][jj] = v;
    }
    for (int e = tid; e < kQ * kDT; e += kThreads) {
      const int qq = e / kDT, jj = e % kDT;
      const int b = q0 + qq, col = j0 + jj;
      sq[qq][jj] = (b < a.B && col < a.dim)
                       ? a.q[static_cast<size_t>(b) * a.dim + col] : 0.0f;
    }
    __syncthreads();
    const int n_j = min(kDT, a.dim - j0);
    for (int jj = 0; jj < n_j; ++jj) {
      const float qv = sq[qb][jj];
#pragma unroll
      for (int t = 0; t < kItemsPerThread; ++t)
        acc[t] = fmaf(qv, sx[ig + kGroup * t][jj], acc[t]);
    }
    __syncthreads();
  }

  const int bq = q0 + qb;
#pragma unroll
  for (int t = 0; t < kItemsPerThread; ++t) {
    const int ii = ig + kGroup * t;
    const int item = i0 + ii;
    ss[qb][ii] = (item < a.n_items && bq < a.B)
                     ? Step::score(a, bq, item, acc[t]) : -INFINITY;
  }
  __syncthreads();
  for (int e = tid; e < kQ * a.P; e += kThreads) {
    const int qq = e / a.P, p = e % a.P;
    const int b = q0 + qq;
    if (b >= a.B) continue;
    const int id = a.excl[static_cast<size_t>(b) * a.P + p];
    if (id >= i0 && id < i0 + kChunk) ss[qq][id - i0] = -INFINITY;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int qq = warp; qq < kQ; qq += kThreads / 32) {
    const int b = q0 + qq;
    if (b >= a.B) break;
    const size_t off = static_cast<size_t>(b) * row +
                       static_cast<size_t>(chunk) * L;
    select_chunk(ss[qq], kChunk, i0, L, cand_v + off, cand_i + off, lane);
  }
}

// Entries of the sorted list (v, id)[0, n) ahead of (bv, bi).
__device__ __forceinline__ int count_ahead(const float* v, const int* id,
                                           int n, float bv, int bi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(v[mid], id[mid], bv, bi)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge round; blockIdx.x is the output list j, blockIdx.y the row.
// Input lists of a row sit stride_in apart: all hold len_in entries but the
// last, which holds last_in. Output list j holds min(m, len_a + len_b).
__global__ void merge_round_kernel(const float* __restrict__ in_v,
                                   const int* __restrict__ in_i, int n_in,
                                   int stride_in, int len_in, int last_in,
                                   size_t row_in, float* __restrict__ out_v,
                                   int* __restrict__ out_i, int stride_out,
                                   size_t row_out, int m) {
  const int j = blockIdx.x;
  const size_t b = blockIdx.y;
  const int la = 2 * j, lb = 2 * j + 1;
  const int len_a = la == n_in - 1 ? last_in : len_in;
  const int len_b = lb < n_in ? (lb == n_in - 1 ? last_in : len_in) : 0;
  const float* av = in_v + b * row_in + static_cast<size_t>(la) * stride_in;
  const int* ai = in_i + b * row_in + static_cast<size_t>(la) * stride_in;
  const float* bv = av + stride_in;
  const int* bi = ai + stride_in;
  const int n_out = min(m, len_a + len_b);
  float* ov = out_v + b * row_out + static_cast<size_t>(j) * stride_out;
  int* oi = out_i + b * row_out + static_cast<size_t>(j) * stride_out;
  for (int t = threadIdx.x; t < len_a + len_b; t += blockDim.x) {
    const bool in_a = t < len_a;
    const int own = in_a ? t : t - len_a;   // place in its own list
    if (own >= n_out) continue;
    const float v = in_a ? av[own] : bv[own];
    const int id = in_a ? ai[own] : bi[own];
    const int pos = own + (in_a ? count_ahead(bv, bi, len_b, v, id)
                                : count_ahead(av, ai, len_a, v, id));
    if (pos < n_out) {
      ov[pos] = v;
      oi[pos] = id;
    }
  }
}

// Pass 2 over B rows, each holding n_lists sorted lists of len entries
// (the last of last_len) at stride len in buffer a (row stride `row`).
// Rounds alternate between buffers a and b; the last writes out (B, m).
// n_lists must be > 1, and n_lists * len >= m. Returns cudaGetLastError().
inline cudaError_t merge_lists(float* a_v, int* a_i, float* b_v, int* b_i,
                               size_t row, int B, int n_lists, int len,
                               int last_len, int m, float* out_v, int* out_i,
                               cudaStream_t s) {
  float* in_v = a_v;
  int* in_i = a_i;
  float* nx_v = b_v;
  int* nx_i = b_i;
  while (n_lists > 1) {
    const int n_out = (n_lists + 1) / 2;
    const int len_out = std::min(m, 2 * len);
    const int last_out =
        n_lists % 2 ? last_len : std::min(m, len + last_len);
    const bool final_round = n_out == 1;
    merge_round_kernel<<<dim3(n_out, B), kMergeThreads, 0, s>>>(
        in_v, in_i, n_lists, len, len, last_len, row,
        final_round ? out_v : nx_v, final_round ? out_i : nx_i, len_out,
        final_round ? static_cast<size_t>(m) : row, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    float* tv = in_v;
    int* ti = in_i;
    in_v = nx_v;
    in_i = nx_i;
    nx_v = tv;
    nx_i = ti;
    n_lists = n_out;
    len = len_out;
    last_len = last_out;
  }
  return cudaGetLastError();
}

// Both passes over a.B queries: out_v (B, m) fp32, out_i (B, m) int32.
// cand_v/cand_i and cand2_v/cand2_i are scratch of
// B*ceil(n_items/kChunk)*min(m, kChunk) each. Requires 1 <= m <= n_items.
// Returns cudaGetLastError() after the last launch.
template <class Step>
cudaError_t select_topm(const ChunkArgs& a, int m, float* cand_v,
                        int* cand_i, float* cand2_v, int* cand2_i,
                        float* out_v, int* out_i, cudaStream_t s) {
  if (a.B <= 0 || a.n_items <= 0 || m <= 0) return cudaGetLastError();
  const int n_chunks = (a.n_items + kChunk - 1) / kChunk;
  const int L = m < kChunk ? m : kChunk;
  const bool one = n_chunks == 1;   // the chunk list is the result
  const size_t row = one ? static_cast<size_t>(m)
                         : static_cast<size_t>(n_chunks) * L;
  const dim3 grid1(n_chunks, (a.B + kQ - 1) / kQ);
  chunk_kernel<Step><<<grid1, kThreads, 0, s>>>(a, L, row,
                                                one ? out_v : cand_v,
                                                one ? out_i : cand_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  return merge_lists(cand_v, cand_i, cand2_v, cand2_i, row, a.B, n_chunks, L,
                     L, m, out_v, out_i, s);
}

}  // namespace topk_select
