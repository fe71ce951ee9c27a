// The schedule, the selection and the merges shared by the top-K and coarse
// top-m kernels (topk_score.cu, coarse_topm.cu).
//
// Result: the top m of each masked score row, ordered by (value desc, index
// asc), which is jax.lax.top_k's tie rule, for any 1 <= m <= n_items.
//
// Pass 1 (scan_kernel) is persistent. The work is U = n_qtiles * n_tiles
// units, one unit a (query tile of QT rows, item tile of kTile = 128 items);
// CTA c of the grid (as many a SM as fit) takes the contiguous units [c*U/G,
// (c+1)*U/G), so the CTAs differ by at most one unit of work. Per unit the
// kernel's Product forms the QT x 128 score tile in shared memory (fp32
// FMAs for top-K, int8 tensor-core MMAs for coarse), exclusion ids in the
// tile set their scores to -inf, and one warp a query updates that query's
// running list: the best L = min(m, 128) entries seen so far, sorted, in
// shared memory. A score enters only if it is better than the list's last
// entry, the running threshold, which is exact under the order; after the
// first tile of a run most scores fail that one compare. When more than 32
// pass and L <= 32, the L-th best of the lanes' best entries tightens the
// threshold for the tile (at least L entries of the tile are not worse).
// Passing entries are compacted; up to kSmallInsert are inserted one by one
// (a ballot finds the place, the tail shifts down), more are sorted by a
// warp bitonic network (32, 64 or 128 at once) and merged with the list by
// rank (each entry's place is its own index plus the count of the other
// side ahead of it). Where a CTA's run leaves a query tile (a segment), the
// lists go to global memory as that segment's slot.
//
// Pass 2, threshold route (m <= 128): merge_rows_kernel, one CTA per query
// row, bounds the row's lists (about G / n_qtiles + 1 of m) by the m-th
// best of their first entries, gathers the few entries not worse than that
// bound and places each by its rank among them: 2 CUDA launches a call, 1
// when every query tile is one segment. make_plan caps G so that the row
// fits in one CTA's shared memory.
//
// Large m (m > 128), rounds route: pass 1 flushes one list of 128 per item
// tile (the tile sorted), and merge_lists runs ceil(log2(n_tiles)) merge
// rounds over global memory, each list pair truncated to m: any m up to
// n_items, the m = n_items anchor included.
//
// The plan (make_plan, on the host; the wrapper reads it through the .cu's
// *_plan entry only to allocate the scratch): the query tile QT is the
// smallest of kQTiles >= B (B past the largest in tiles of it), so from B 8
// on at most half the rows are padding; the grid is the scan CTAs the SMs
// hold at once (occupancy, queried once per device, list length and width),
// one a SM where the units are fewer than two a CTA, and fewer where a
// row's lists would not fit the row merge's shared memory. Both kernels'
// dynamic shared-memory caps are raised once, to all the device allows,
// when a device is first seen: a cap set per launch would race between
// threads launching different sizes.
//
// What bounds it on the H100 (PERF.md): the bytes bound both kernels at the
// engine's batches and the FMAs top-K at B 128, but the time goes to the
// product's shared-memory loads (a 4 x 4 register tile loads one float per
// FMA issued: twice the FMA time), to each step's global-load latency, and
// to the selection: its warp sorts and searches are chains of dependent
// shuffles and shared loads, and they run between the product's steps.
//
// Every merge is stable, list a first: an entry of a counts the entries of
// b strictly better than it, an entry of b those of a not worse. Real ids
// are distinct; list slots no item filled hold the sentinel (-inf, INT_MAX),
// worse than every real entry, -inf ones included. With m <= n_items no
// sentinel reaches the result.
//
// A Product is the per-tile arithmetic of one kernel:
//   Product(const ScanArgs&, unsigned char* smem);  static smem_bytes(dim)
//   int n_steps()                 steps (feature slices) per tile
//   load(Regs&, buf, q0, i0, step)  global -> registers or shared buffer
//                                 buf by cp.async (one step ahead)
//   store(const Regs&, buf, q0, i0, step)   registers -> shared buffer buf
//   compute(buf, Acc&, step)      shared buffer -> accumulators
//   write_scores(const Acc&, ss, q0, i0)    accumulators -> score tile
//   zero(Acc&)
//   kMinBlocks                    CTAs an SM must hold (caps registers)
//   kBuffers                      2: step t+1's loads fly while step t
//                                 computes, one __syncthreads a step
//                                 separating the buffers; 1: a single
//                                 buffer, refilled once every warp is past
//                                 it (at a tile's end, during the selection)
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace topk_select {

constexpr int kTile = 128;         // items per unit
constexpr int kThreads = 256;      // pass-1 CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSS = kTile + 4;     // row stride of the score tile (floats)
constexpr int kMaxList = 128;      // longest running list (threshold route)
constexpr int kSmallInsert = 4;    // passing entries inserted one by one
constexpr int kMergeThreads = 1024;
constexpr int kRoundThreads = 256;
constexpr int kMaxSmem = 232448;   // 227 KB, the most a CTA can take
constexpr unsigned kFull = 0xffffffffu;
// query tiles (ascending): 8 is the tensor-core MMA's query block (coarse)
constexpr int kQTiles[] = {8, 16, 32};

// The inputs of pass 1. q is (B, dim) fp32; packed (n_items, dp) uint8, or
// items (n_items, dim) fp32 for a dense table; scale/zero (n_items,) fp32;
// qmeta (B, 2) fp32 or null; excl (B, P) int32, -1 pads.
struct ScanArgs {
  const float* q;
  const float* qmeta;
  int B;
  int dim;
  const uint8_t* packed;
  int dp;
  const float* items;
  const float* scale;
  const float* zero;
  const int* excl;
  int P;
  int n_items;
};

struct __align__(8) Entry {
  float v;
  int i;
};

__device__ __forceinline__ Entry sentinel() {
  return Entry{-INFINITY, INT_MAX};
}

// Asynchronous global -> shared copies (cp.async): issued where they stand
// in the code, so a step's loads fly while the previous step computes; a
// thread waits for its own copies (cp_async_wait) before reading them.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// (value desc, index asc)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}
__device__ __forceinline__ bool better(Entry a, Entry b) {
  return better(a.v, a.i, b.v, b.i);
}

// Entries of the sorted list[0, n) strictly better than e.
__device__ __forceinline__ int count_better(const Entry* list, int n,
                                            Entry e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(list[mid], e)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Entries of the sorted list[0, n) not worse than e.
__device__ __forceinline__ int count_not_worse(const Entry* list, int n,
                                               Entry e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!better(e, list[mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The persistent schedule of pass 1: `units` = n_qtiles * n_tiles units,
// `grid` CTAs, CTA c on [first_unit(c), first_unit(c + 1)).
struct Schedule {
  int n_tiles;
  int n_qtiles;
  int grid;
  long long units;

  __host__ __device__ long long first_unit(int c) const {
    return static_cast<long long>(c) * units / grid;
  }
  // the CTA whose run holds unit x
  __host__ __device__ int cta_of(long long x) const {
    return static_cast<int>(((x + 1) * grid + units - 1) / units - 1);
  }
  __host__ __device__ int first_cta(int qt) const {
    return cta_of(static_cast<long long>(qt) * n_tiles);
  }
  // segments (list slots) of query tile qt
  __host__ __device__ int n_slots(int qt) const {
    return cta_of(static_cast<long long>(qt + 1) * n_tiles - 1) -
           first_cta(qt) + 1;
  }
  int max_slots() const {
    int s = 0;
    for (int qt = 0; qt < n_qtiles; ++qt)
      s = n_slots(qt) > s ? n_slots(qt) : s;
    return s;
  }
};

// -- the warp selection ------------------------------------------------------

// Compare-exchange of registers r < r2 of a lane (entries r*32 + lane and
// r2*32 + lane): the better goes to r when that pair sorts best first.
template <int R>
__device__ __forceinline__ void exchange(float (&v)[R], int (&id)[R], int r,
                                         int r2, bool desc) {
  const bool swap = desc ? better(v[r2], id[r2], v[r], id[r])
                         : better(v[r], id[r], v[r2], id[r2]);
  if (swap) {
    const float tv = v[r];
    const int ti = id[r];
    v[r] = v[r2];
    id[r] = id[r2];
    v[r2] = tv;
    id[r2] = ti;
  }
}

// Sorts 32*R entries (R 1, 2 or 4), entry r*32 + lane in register r of the
// lane, best first: a bitonic network, by shuffles between lanes and by
// exchanges between a lane's registers (partner distance 32 and 64).
template <int R>
__device__ __forceinline__ void warp_sort(float (&v)[R], int (&id)[R],
                                          int lane) {
  static_assert(R == 1 || R == 2 || R == 4, "warp_sort: 32, 64, 128");
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        if constexpr (R == 2) {
          exchange<R>(v, id, 0, 1, (lane & k) == 0);
        } else if constexpr (R == 4) {
          // each pair's direction is its lower entry's bit k
          if (j == 32) {
            exchange<R>(v, id, 0, 1, (lane & k) == 0);
            exchange<R>(v, id, 2, 3, ((64 + lane) & k) == 0);
          } else {  // j == 64
            exchange<R>(v, id, 0, 2, (lane & k) == 0);
            exchange<R>(v, id, 1, 3, ((32 + lane) & k) == 0);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ov = __shfl_xor_sync(kFull, v[r], j);
          const int oi = __shfl_xor_sync(kFull, id[r], j);
          const bool desc = ((r * 32 + lane) & k) == 0;
          const bool keep_better = ((lane & j) == 0) == desc;
          const bool take = keep_better ? better(ov, oi, v[r], id[r])
                                        : better(v[r], id[r], ov, oi);
          if (take) {
            v[r] = ov;
            id[r] = oi;
          }
        }
      }
    }
  }
}

// Inserts e into the sorted list lst[0, L) if it beats the last entry. Run
// by the whole warp with the same e.
__device__ __forceinline__ void insert_one(Entry* lst, int L, Entry e,
                                           int lane) {
  if (!better(e, lst[L - 1])) return;
  int pos = 0;
#pragma unroll
  for (int r = 0; r < kMaxList / 32; ++r) {
    const int t = r * 32 + lane;
    pos += __popc(__ballot_sync(kFull, t < L && better(lst[t], e)));
  }
  Entry moved[kMaxList / 32];
#pragma unroll
  for (int r = 0; r < kMaxList / 32; ++r) {
    const int t = r * 32 + lane;
    if (t >= pos && t < L - 1) moved[r] = lst[t];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxList / 32; ++r) {
    const int t = r * 32 + lane;
    if (t >= pos && t < L - 1) lst[t + 1] = moved[r];
  }
  if (lane == 0) lst[pos] = e;
  __syncwarp();
}

// Merges the cnt candidates in sc (unsorted, cnt <= 32*R) into lst[0, L):
// sort them, then place every entry by rank; the top L stay.
template <int R>
__device__ __forceinline__ void sort_merge(Entry* lst, int L, Entry* sc,
                                           int cnt, int lane) {
  float v[R];
  int id[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const Entry x = e < cnt ? sc[e] : sentinel();
    v[r] = x.v;
    id[r] = x.i;
  }
  warp_sort<R>(v, id, lane);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) sc[r * 32 + lane] = Entry{v[r], id[r]};
  __syncwarp();
  Entry le[kMaxList / 32];
  int lp[kMaxList / 32];
#pragma unroll
  for (int r = 0; r < kMaxList / 32; ++r) {
    const int t = r * 32 + lane;
    lp[r] = INT_MAX;
    if (t < L) {
      le[r] = lst[t];
      lp[r] = t + count_not_worse(sc, 32 * R, le[r]);
    }
  }
  int cp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    cp[r] = e < L ? e + count_better(lst, L, Entry{v[r], id[r]}) : INT_MAX;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxList / 32; ++r)
    if (lp[r] < L) lst[lp[r]] = le[r];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (cp[r] < L) lst[cp[r]] = Entry{v[r], id[r]};
  __syncwarp();
}

// The filter of one query's score row srow (ids i0 + t, t < n_valid): each
// lane's scores and the ballots of those better than the list's last entry;
// returns how many pass.
__device__ __forceinline__ int filter_row(const float* srow, int i0,
                                          int n_valid, const Entry* lst,
                                          int L, int lane,
                                          float (&s)[kTile / 32],
                                          unsigned (&bal)[kTile / 32]) {
  const Entry thr = lst[L - 1];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kTile / 32; ++r) {
    const int t = r * 32 + lane;
    s[r] = srow[t];
    bal[r] = __ballot_sync(
        kFull, t < n_valid && better(s[r], i0 + t, thr.v, thr.i));
    cnt += __popc(bal[r]);
  }
  return cnt;
}

// The list update for the cnt > 0 entries filter_row passed.
__device__ __forceinline__ void update_row(int cnt,
                                           const float (&s)[kTile / 32],
                                           unsigned (&bal)[kTile / 32],
                                           int i0, int n_valid, Entry* lst,
                                           int L, Entry* sc, int lane) {
  if (cnt > 32 && L <= 32) {
    // At least L entries of the tile are not worse than the L-th best of
    // the lanes' best entries, so no entry worse than it can make the top
    // L: keep only those (about L of the 128 where the list is new).
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < kTile / 32; ++r) {
      const int t = r * 32 + lane;
      if (t < n_valid && better(s[r], i0 + t, bv, bi)) {
        bv = s[r];
        bi = i0 + t;
      }
    }
    float mv[1] = {bv};
    int mi[1] = {bi};
    warp_sort<1>(mv, mi, lane);
    const float tv = __shfl_sync(kFull, mv[0], L - 1);
    const int ti = __shfl_sync(kFull, mi[0], L - 1);
    cnt = 0;
#pragma unroll
    for (int r = 0; r < kTile / 32; ++r) {
      const int t = r * 32 + lane;
      bal[r] &= __ballot_sync(kFull, !better(tv, ti, s[r], i0 + t));
      cnt += __popc(bal[r]);
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int r = 0; r < kTile / 32; ++r) {
    if ((bal[r] >> lane) & 1u)
      sc[base + __popc(bal[r] & below)] = Entry{s[r], i0 + r * 32 + lane};
    base += __popc(bal[r]);
  }
  __syncwarp();
  if (cnt <= kSmallInsert) {
    for (int e = 0; e < cnt; ++e) insert_one(lst, L, sc[e], lane);
  } else if (cnt <= 32) {
    sort_merge<1>(lst, L, sc, cnt, lane);
  } else if (cnt <= 64) {
    sort_merge<2>(lst, L, sc, cnt, lane);
  } else {
    sort_merge<kTile / 32>(lst, L, sc, cnt, lane);
  }
}

// One tile's selection: warp w takes queries w, w + kWarps, ... in turn.
template <int QT>
__device__ __forceinline__ void select_tile(const float* ss, Entry* lists,
                                            Entry* sc, int L, int B, int q0,
                                            int i0, int n_valid, int warp,
                                            int lane) {
  for (int qq = warp; qq < QT && q0 + qq < B; qq += kWarps) {
    float s[kTile / 32];
    unsigned bal[kTile / 32];
    const int cnt = filter_row(ss + qq * kSS, i0, n_valid, lists + qq * L,
                               L, lane, s, bal);
    if (cnt > 0) update_row(cnt, s, bal, i0, n_valid, lists + qq * L, L, sc,
                            lane);
  }
}

// -- pass 1 -------------------------------------------------------------------

template <class P, int QT>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
    scan_kernel(ScanArgs a, Schedule s, int L, int per_tile, int S,
                Entry* __restrict__ cand, float* __restrict__ out_v,
                int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* lists = reinterpret_cast<Entry*>(smem);
  Entry* scratch = lists + QT * L;
  float* ss = reinterpret_cast<float*>(scratch + kWarps * kTile);
  P prod(a, reinterpret_cast<unsigned char*>(ss + QT * kSS));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x;
  long long u = s.first_unit(c);
  const long long u1 = s.first_unit(c + 1);
  const int n_steps = prod.n_steps();

  for (int e = tid; e < QT * L; e += kThreads) lists[e] = sentinel();
  typename P::Regs regs;
  typename P::Acc acc;
  prod.zero(acc);
  if (u < u1)
    prod.load(regs, 0, static_cast<int>(u / s.n_tiles) * QT,
              static_cast<int>(u % s.n_tiles) * kTile, 0);
  int step = 0, buf = 0;
  while (u < u1) {
    const int qt = static_cast<int>(u / s.n_tiles);
    const int tile = static_cast<int>(u % s.n_tiles);
    const int q0 = qt * QT, i0 = tile * kTile;
    prod.store(regs, buf, q0, i0, step);
    __syncthreads();
    long long nu = u;
    int ns = step + 1;
    if (ns == n_steps) {
      ns = 0;
      ++nu;
    }
    const int nq0 = static_cast<int>(nu / s.n_tiles) * QT;
    const int ni0 = static_cast<int>(nu % s.n_tiles) * kTile;
    if constexpr (P::kBuffers == 2) {
      if (nu < u1) prod.load(regs, buf ^ 1, nq0, ni0, ns);
    }
    prod.compute(buf, acc, step);
    if constexpr (P::kBuffers == 2) buf ^= 1;
    if (ns != 0 && P::kBuffers == 1) {
      __syncthreads();  // every warp is past the buffer
      if (nu < u1) prod.load(regs, 0, nq0, ni0, ns);
    }
    if (ns == 0) {  // the tile's scores are complete
      prod.write_scores(acc, ss, q0, i0);
      prod.zero(acc);
      __syncthreads();
      if constexpr (P::kBuffers == 1) {  // flies during the selection
        if (nu < u1) prod.load(regs, 0, nq0, ni0, ns);
      }
      const int n_valid = min(kTile, a.n_items - i0);
      for (int e = tid; e < QT * a.P; e += kThreads) {
        const int qq = e / a.P;
        const int b = q0 + qq;
        if (b >= a.B) break;
        const int id = a.excl[static_cast<size_t>(b) * a.P + (e - qq * a.P)];
        if (id >= i0 && id < i0 + n_valid) ss[qq * kSS + id - i0] = -INFINITY;
      }
      __syncthreads();
      select_tile<QT>(ss, lists, scratch + warp * kTile, L, a.B, q0, i0,
                      n_valid, warp, lane);
      __syncthreads();
      if (per_tile || nu == u1 || nu % s.n_tiles == 0) {  // segment ends
        const int slot = per_tile ? tile : c - s.first_cta(qt);
        for (int e = tid; e < QT * L; e += kThreads) {
          const int qq = e / L, t = e - qq * L;
          const int b = q0 + qq;
          if (b >= a.B) break;
          const Entry x = lists[e];
          if (cand == nullptr) {
            out_v[static_cast<size_t>(b) * L + t] = x.v;
            out_i[static_cast<size_t>(b) * L + t] = x.i;
          } else {
            cand[(static_cast<size_t>(b) * S + slot) * L + t] = x;
          }
        }
        __syncthreads();
        for (int e = tid; e < QT * L; e += kThreads) lists[e] = sentinel();
        __syncthreads();
      }
    }
    u = nu;
    step = ns;
  }
}

// -- pass 2 -------------------------------------------------------------------

// Threshold route: row b's n_slots(b / QT) lists of L (slots S apart) ->
// its top L, in shared memory. First a bound: every list's first k =
// ceil(L / n) entries are n*k >= L distinct entries, so the L-th best of
// them, T, has at least L entries not worse than it, and no entry worse
// than T is in the top L. A binary search per list counts the entries not
// worse than T (the survivors, usually little more than L), they are
// gathered, and each one's rank among them is its place in the result.
// More than kMergeThreads survivors (heavy ties) take pairwise merge rounds
// instead, each entry placed by a binary search of the other list.
__global__ void __launch_bounds__(kMergeThreads)
    merge_rows_kernel(const Entry* __restrict__ cand, Schedule s, int QT,
                      int S, int L, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* cur = reinterpret_cast<Entry*>(smem);
  Entry* nxt = cur + static_cast<size_t>(S) * L;     // S*L + kMergeThreads
  int* offs = reinterpret_cast<int*>(nxt + static_cast<size_t>(S) * L +
                                     kMergeThreads);  // S + 1
  __shared__ Entry thr;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  int n = s.n_slots(b / QT);
  const Entry* src = cand + static_cast<size_t>(b) * S * L;
  // eight loads in flight a thread: one CTA reads the row's lists alone
  constexpr int kBatch = 8;
  for (int t0 = tid; t0 < n * L; t0 += kBatch * kMergeThreads) {
    Entry e[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + j * kMergeThreads;
      if (t < n * L) e[j] = src[t];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + j * kMergeThreads;
      if (t < n * L) cur[t] = e[j];
    }
  }
  if (tid == 0) thr = sentinel();
  __syncthreads();

  // the bound T: the entry of rank L - 1 among the lists' first k entries
  // (none when those hold fewer than L real entries: T stays the sentinel)
  const int k = (L + n - 1) / n;
  for (int c = tid; c < n * k; c += kMergeThreads)
    nxt[c] = cur[(c / k) * L + c % k];
  __syncthreads();
  for (int c = tid; c < n * k; c += kMergeThreads) {
    const Entry e = nxt[c];
    int rank = 0;
    for (int c2 = 0; c2 < n * k; ++c2) rank += better(nxt[c2], e) ? 1 : 0;
    if (rank == L - 1) thr = e;
  }
  __syncthreads();
  for (int l = tid; l < n; l += kMergeThreads)
    offs[l + 1] = count_not_worse(cur + l * L, L, thr);
  __syncthreads();
  if (tid < 32) {  // offs[l] = survivors of the lists before l
    int run = 0;
    for (int base = 0; base < n; base += 32) {
      const int l = base + tid;
      int x = l < n ? offs[l + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (tid >= o) x += y;
      }
      if (l < n) offs[l + 1] = run + x;
      run += __shfl_sync(kFull, x, 31);
    }
    if (tid == 0) offs[0] = 0;
  }
  __syncthreads();
  const int total = offs[n];
  if (total <= kMergeThreads) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int l = warp; l < n; l += kMergeThreads / 32)
      for (int t = lane; t < offs[l + 1] - offs[l]; t += 32)
        nxt[offs[l] + t] = cur[l * L + t];
    __syncthreads();
    if (tid < total) {
      const Entry e = nxt[tid];
      int rank = 0;
      for (int j = 0; j < total; ++j) rank += better(nxt[j], e) ? 1 : 0;
      if (rank < L) {
        out_v[static_cast<size_t>(b) * L + rank] = e.v;
        out_i[static_cast<size_t>(b) * L + rank] = e.i;
      }
    }
    return;
  }

  while (n > 1) {
    for (int t = tid; t < n * L; t += kMergeThreads) {
      const int l = t / L, own = t - l * L;
      const int other = l ^ 1;
      const Entry e = cur[t];
      int pos = own;
      if (other < n)
        pos += (l & 1) ? count_not_worse(cur + other * L, L, e)
                       : count_better(cur + other * L, L, e);
      if (pos < L) nxt[(l >> 1) * L + pos] = e;
    }
    __syncthreads();
    Entry* t = cur;
    cur = nxt;
    nxt = t;
    n = (n + 1) / 2;
  }
  for (int t = tid; t < L; t += kMergeThreads) {
    out_v[static_cast<size_t>(b) * L + t] = cur[t].v;
    out_i[static_cast<size_t>(b) * L + t] = cur[t].i;
  }
}

// Rounds route, one round; blockIdx.x is the output list j, blockIdx.y the
// row. Input lists of a row sit len_in apart: all hold len_in entries but
// the last, which holds last_in. Output list j holds min(m, len_a + len_b),
// at stride stride_out; the last round (out == null) writes out_v/out_i.
__global__ void merge_round_kernel(const Entry* __restrict__ in, int n_in,
                                   int len_in, int last_in, size_t row_in,
                                   Entry* __restrict__ out, int stride_out,
                                   size_t row_out, int m,
                                   float* __restrict__ out_v,
                                   int* __restrict__ out_i) {
  const int j = blockIdx.x;
  const size_t b = blockIdx.y;
  const int la = 2 * j, lb = 2 * j + 1;
  const int len_a = la == n_in - 1 ? last_in : len_in;
  const int len_b = lb < n_in ? (lb == n_in - 1 ? last_in : len_in) : 0;
  const Entry* A = in + b * row_in + static_cast<size_t>(la) * len_in;
  const Entry* Bl = A + len_in;
  const int n_out = min(m, len_a + len_b);
  const size_t o = b * row_out + static_cast<size_t>(j) * stride_out;
  for (int t = threadIdx.x; t < len_a + len_b; t += blockDim.x) {
    const bool in_a = t < len_a;
    const int own = in_a ? t : t - len_a;
    if (own >= n_out) continue;
    const Entry e = in_a ? A[own] : Bl[own];
    const int pos = own + (in_a ? count_better(Bl, len_b, e)
                                : count_not_worse(A, len_a, e));
    if (pos >= n_out) continue;
    if (out != nullptr) {
      out[o + pos] = e;
    } else {
      out_v[o + pos] = e.v;
      out_i[o + pos] = e.i;
    }
  }
}

// n_lists (> 1) sorted lists of len per row in buffer a (row stride `row`
// entries) -> (B, m) in out_v/out_i, rounds alternating between a and b;
// one is added to *started at each round's launch.
inline cudaError_t merge_lists(Entry* a, Entry* b, size_t row, int B,
                               int n_lists, int len, int m, float* out_v,
                               int* out_i, cudaStream_t st, int* started) {
  int last = len;
  while (n_lists > 1) {
    const int n_out = (n_lists + 1) / 2;
    const int len_out = len * 2 < m ? len * 2 : m;
    const int last_out = n_lists % 2 ? last : (len + last < m ? len + last : m);
    const bool final_round = n_out == 1;
    merge_round_kernel<<<dim3(n_out, B), kRoundThreads, 0, st>>>(
        a, n_lists, len, last, row, final_round ? nullptr : b, len_out,
        final_round ? static_cast<size_t>(m) : row, m, out_v, out_i);
    ++*started;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    Entry* t = a;
    a = b;
    b = t;
    n_lists = n_out;
    len = len_out;
    last = last_out;
  }
  return cudaSuccess;
}

// Shared memory of merge_rows_kernel: two copies of a row's lists, room
// for kMergeThreads survivors, and the lists' offsets.
inline size_t merge_smem_bytes(int slots, int L) {
  return (2 * static_cast<size_t>(slots) * L + kMergeThreads) *
             sizeof(Entry) +
         (static_cast<size_t>(slots) + 1) * sizeof(int);
}

// Shared memory of one scan CTA.
template <class P, int QT>
size_t scan_bytes(const ScanArgs& a, int L) {
  return static_cast<size_t>(QT) * L * sizeof(Entry) +
         static_cast<size_t>(kWarps) * kTile * sizeof(Entry) +
         static_cast<size_t>(QT) * kSS * sizeof(float) + P::smem_bytes(a.dim);
}

// Raises kernel f's dynamic shared-memory cap on device dev to all the
// device lets a CTA take beside f's static shared memory; *cap is that cap.
template <class F>
cudaError_t raise_smem_cap(F* f, int dev, int* cap) {
  cudaFuncAttributes attr;
  int optin = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *cap = optin - static_cast<int>(attr.sharedSizeBytes);
  return cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *cap);
}

// What the plan needs of the current device for the scan of product P at
// query tile QT with lists of L: the scan CTAs an SM holds at once (0 when
// the scan cannot launch), the SMs, and the row merge's shared-memory cap.
// Queried once per (device, L, dim) under a lock; the first query of each
// also raises both kernels' caps (raise_smem_cap), before any launch of
// theirs on that device.
struct DeviceFit {
  int ctas_per_sm;
  int n_sm;
  int merge_cap;
};

template <class P, int QT>
cudaError_t device_fit(const ScanArgs& a, int L, DeviceFit* fit) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, DeviceFit> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, L, a.dim);
  const std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(key);
  if (it == seen.end()) {
    DeviceFit f{0, 0, 0};
    int scan_cap = 0;
    err = raise_smem_cap(scan_kernel<P, QT>, dev, &scan_cap);
    if (err == cudaSuccess)
      err = raise_smem_cap(merge_rows_kernel, dev, &f.merge_cap);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&f.n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    const size_t bytes = scan_bytes<P, QT>(a, L);
    if (err == cudaSuccess && bytes <= static_cast<size_t>(scan_cap))
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &f.ctas_per_sm, scan_kernel<P, QT>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    it = seen.emplace(key, f).first;
  }
  *fit = it->second;
  return cudaSuccess;
}

// How one call runs (see the notes at the top). scratch_bytes is the size of
// each of the n_buffers scratch buffers the caller allocates.
struct Plan {
  int qt;
  int grid;
  int slots;        // lists a query row leaves in the scratch
  int list_len;
  long long scratch_bytes;
  int n_buffers;
  int n_kernels;    // CUDA launches a call
};

// The query tile for B rows: the smallest of the tiles >= B, the largest
// past them.
inline int pick_qt(int B) {
  for (const int t : kQTiles)
    if (t >= B) return t;
  return kQTiles[sizeof(kQTiles) / sizeof(kQTiles[0]) - 1];
}

// The tag a .cu's dispatch hands to its callers: product P at query tile QT.
template <class P, int QT>
struct Tag {
  using Product = P;
  static constexpr int kQT = QT;
};

// f(Tag<Product<BITS, qt>, qt>{}), or cudaErrorInvalidValue for a query
// tile not in kQTiles.
template <template <int, int> class Product, int BITS, class F>
cudaError_t at_tile(int qt, F& f) {
  switch (qt) {
    case 8: return f(Tag<Product<BITS, 8>, 8>{});
    case 16: return f(Tag<Product<BITS, 16>, 16>{});
    case 32: return f(Tag<Product<BITS, 32>, 32>{});
  }
  return cudaErrorInvalidValue;
}

template <class P, int QT>
Schedule schedule_of(const ScanArgs& a, int grid) {
  Schedule s;
  s.n_tiles = (a.n_items + kTile - 1) / kTile;
  s.n_qtiles = (a.B + QT - 1) / QT;
  s.units = static_cast<long long>(s.n_tiles) * s.n_qtiles;
  s.grid = grid;
  return s;
}

// The plan of a call over a.B queries and a.n_items items keeping the top
// m, at query tile QT. Requires 1 <= m <= n_items.
template <class P, int QT>
cudaError_t make_plan(const ScanArgs& a, int m, Plan* p) {
  if (a.B <= 0 || a.n_items <= 0 || m <= 0 || m > a.n_items)
    return cudaErrorInvalidValue;
  DeviceFit fit;
  const cudaError_t err =
      device_fit<P, QT>(a, m < kMaxList ? m : kMaxList, &fit);
  if (err != cudaSuccess) return err;
  if (fit.ctas_per_sm <= 0) return cudaErrorInvalidValue;
  Schedule s = schedule_of<P, QT>(a, 0);
  // more CTAs an SM only where each still runs two units or more: a run's
  // first tile builds its lists from nothing, the dearest selection
  const int ctas = s.units < 2LL * fit.n_sm * fit.ctas_per_sm
                       ? 1 : fit.ctas_per_sm;
  s.grid = static_cast<int>(s.units < static_cast<long long>(fit.n_sm) * ctas
                                ? s.units : fit.n_sm * ctas);
  if (m > kMaxList) {  // rounds route: one list of kTile per item tile
    int rounds = 0;
    while ((1 << rounds) < s.n_tiles) ++rounds;
    *p = Plan{QT, s.grid, s.n_tiles, kTile,
              static_cast<long long>(a.B) * s.n_tiles * kTile *
                  static_cast<long long>(sizeof(Entry)),
              2, 1 + rounds};
    return cudaSuccess;
  }
  int slots = s.max_slots();
  while (slots > 1 &&
         merge_smem_bytes(slots, m) > static_cast<size_t>(fit.merge_cap)) {
    --s.grid;
    slots = s.max_slots();
  }
  *p = Plan{QT, s.grid, slots, m,
            slots > 1 ? static_cast<long long>(a.B) * slots * m *
                            static_cast<long long>(sizeof(Entry))
                      : 0,
            slots > 1 ? 1 : 0, slots > 1 ? 2 : 1};
  return cudaSuccess;
}

template <class P, int QT>
cudaError_t launch_scan(const ScanArgs& a, const Schedule& s, int L,
                        bool per_tile, int S, Entry* cand, float* out_v,
                        int* out_i, cudaStream_t st, int* started) {
  scan_kernel<P, QT><<<s.grid, kThreads, scan_bytes<P, QT>(a, L), st>>>(
      a, s, L, per_tile ? 1 : 0, S, cand, out_v, out_i);
  ++*started;
  return cudaGetLastError();
}

// Both passes over a.B queries at query tile QT, as make_plan says: out_v
// (B, m) fp32, out_i (B, m) int32. cand_a and cand_b are the plan's scratch
// buffers of scratch_bytes each (null where it needs fewer). Returns
// cudaGetLastError() after the last launch, or cudaErrorInvalidValue when
// the inputs or the scratch do not fit the plan. *started counts the CUDA
// kernels launched, one at each launch (the plan's n_kernels when all go).
template <class P, int QT>
cudaError_t select_topm(const ScanArgs& a, int m, Entry* cand_a,
                        Entry* cand_b, long long scratch_bytes, float* out_v,
                        int* out_i, cudaStream_t st, int* started) {
  Plan p;
  cudaError_t err = make_plan<P, QT>(a, m, &p);
  if (err != cudaSuccess) return err;
  if ((p.n_buffers > 0 && (cand_a == nullptr ||
                           scratch_bytes < p.scratch_bytes)) ||
      (p.n_buffers > 1 && cand_b == nullptr))
    return cudaErrorInvalidValue;
  const Schedule s = schedule_of<P, QT>(a, p.grid);
  if (m > kMaxList) {  // rounds route
    err = launch_scan<P, QT>(a, s, kTile, true, p.slots, cand_a, nullptr,
                             nullptr, st, started);
    if (err != cudaSuccess) return err;
    return merge_lists(cand_a, cand_b, static_cast<size_t>(p.slots) * kTile,
                       a.B, s.n_tiles, kTile, m, out_v, out_i, st, started);
  }
  if (p.slots == 1)
    return launch_scan<P, QT>(a, s, m, false, 1, nullptr, out_v, out_i, st,
                              started);
  err = launch_scan<P, QT>(a, s, m, false, p.slots, cand_a, nullptr, nullptr,
                           st, started);
  if (err != cudaSuccess) return err;
  merge_rows_kernel<<<a.B, kMergeThreads, merge_smem_bytes(p.slots, m), st>>>(
      cand_a, s, QT, p.slots, m, out_v, out_i);
  ++*started;
  return cudaGetLastError();
}

// The C entries' plan output: qt, grid, slots, list_len, scratch_bytes,
// n_buffers, n_kernels.
inline void write_plan(const Plan& p, long long* out) {
  out[0] = p.qt;
  out[1] = p.grid;
  out[2] = p.slots;
  out[3] = p.list_len;
  out[4] = p.scratch_bytes;
  out[5] = p.n_buffers;
  out[6] = p.n_kernels;
}

}  // namespace topk_select
