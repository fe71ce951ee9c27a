// Fixed-order segment sum: out[r] = sum of y[perm[s]] over the slots
// row_start[r] <= s < row_end[r] of row r's run (one level of a
// data/csr.py:SegmentRuns grouping).
//
// Port-only, no TPU counterpart (kernels/spmm.py: segment_sum_cuda). The
// backward of a gather, grad_table[v] = sum of grad_out[e] over the edges e
// of row v: the attention's gathers by destination, source and relation,
// the tier store's row gradients and the row blocks' backward. The JAX
// package leaves it to XLA's scatter-add; index_add_ adds with atomics, in
// an order that changes from run to run.
//
// Order of summation, a fixed contract. Each row's run is cut at
// run-relative offsets into chunks [row_start + k*C, min(row_start +
// (k+1)*C, row_end)) of C = kChunk = 256 slots. Each chunk is one fp32 sum
// in slot order (__fadd_rn from 0); a row of more than one chunk then adds
// its chunks' sums in chunk order (from 0). A row's bits depend on its own
// run alone, never on where it lies in the slot array or on how the work
// was scheduled, and a run of at most C slots is one sum in slot order:
// the bits of a plain loop over its slots (and of spmm.cu's route, which
// summed every run whole). No floating-point atomics, so two runs give the
// same bits. C is 256 because the relation groupings' chunk levels
// (data/csr.py:REL_CHUNK) hold runs of at most 256: each stays one chunk.
// An empty row is written as 0.
//
// Bound on the H100: bytes. The (n_rows, d) input read once (one d-wide
// row a slot), a perm entry a slot, the row pointers, and the (n_out, d)
// output written once; the adds are far below the fp32 peak.
//
// Design. spmm.cu gave each output row one group of lanes that walked the
// row's run alone: on a zipf-skewed block one hub row held tens of
// thousands of slots and the card waited on one half-warp. Here the work is
// split by slots. The unit is an item, one (row, chunk): no group walks
// more than C slots. A host plan (data/csr.py:segment_plan, built once per
// grouping) gives each row its items (item_ptr, a prefix sum of
// ceil(len / C)) and cuts the rows into tiles of at most kTile rows plus
// slot positions: a tile holds a contiguous range of items and of rows, so
// tiles carry about equal work however the slots fall. The grid is
// persistent: each block walks tiles t, t + grid, ..., and stages the next
// tile's item pointers, row pointers and perm entries in shared memory with
// cp.async while it works on the current one (two buffers), so no gather
// waits on a dependent index load from device memory. In a tile the block
// writes the empty rows as zeros with coalesced stores, then its groups
// take items (the narrow kernel's threads, and the wide kernel's groups,
// every G-th), find each item's row by a binary search of the staged item
// pointers, and sum its slots:
//   d > 4 (seg_wide_kernel): the block streams the rows of the tile's
//     slots, in slot order, through two windows of shared memory (16 KB
//     each, 64 slot rows at d 64) with cp.async, every thread a few 16-byte
//     copies, neighbouring threads on neighbouring columns of a row; a group
//     of L lanes an item (16 lanes x float4 at d 64) adds each window's
//     rows of its open item in slot order from shared memory;
//   d <= 4 (seg_narrow_kernel): the whole block first gathers the rows of
//     every staged slot into shared memory (each thread a few independent
//     loads), then each thread sums whole items from there: 32 items a
//     warp, where a group of lanes per row would leave most lanes idle.
// Either way the gathers are independent copies that the whole block keeps
// in flight, and the dependent chain of adds reads shared memory. A lane
// group that walks its item's gathers itself (16 in flight a lane) keeps
// too few rows in flight where a tile holds a few long chunks: tried on
// the H100, such a kernel ran runs of 256 slots well behind spmm.cu.
// Wide rows with few tiles (an LM's embedding gradient: 8,192 positions of
// 5,120 floats make 32 tiles) would leave most SMs idle, each block
// streaming its tile's whole rows: the grid's second dimension splits the
// columns into slabs of whole passes, one block a (tile, slab), enough
// slabs to fill the card. A column's sum is the same chain of adds in any
// slab, so the bits do not depend on the split.
// Tiles of kTile = 512 rows plus slot positions keep four blocks on an SM
// (at most 64 registers a thread, 52 KB of shared memory a block): tried
// on the H100, tiles of 1,024 with three blocks an SM ran the full graph's
// runs behind spmm.cu's route, and smaller windows or deeper rings were
// slower still.
// A single-chunk row writes its output row; the chunks of a longer row
// write their sums to a scratch buffer the wrapper allocates, and
// seg_combine_kernel (one block a long row, launched only when the level
// has one) adds them in chunk order, staging tiles of partials in shared
// memory with cp.async, two buffers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 256;                 // C (data/csr.py SEG_CHUNK)
constexpr int kTile = 512;                  // data/csr.py SEG_TILE
constexpr int kThreads = 256;
constexpr int kRowsCap = kTile + 1;         // rows a tile stages
constexpr int kSpanCap = kTile + 2 * kChunk;  // perm entries a tile stages
// ints of one stage: item_ptr (rows + 1), row_start, row_end, perm;
// a multiple of 4, so that the narrow kernel's float4 buffer after two
// stages starts on 16 bytes
constexpr int kStageInts =
    ((kRowsCap + 1) + 2 * kRowsCap + kSpanCap + 3) / 4 * 4;
constexpr int kNarrowMaxD = 4;
constexpr int kCombineFloats = 4096;        // floats of one combine stage
constexpr int kRingFloats = 4096;           // floats of one window (wide)
constexpr int kRingBufs = 2;                // windows in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T load_shared(const float* p) {
    return *p;
  }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T add(T a, T v) { return __fadd_rn(a, v); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T load_shared(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T add(T a, T v) {
    return make_float4(__fadd_rn(a.x, v.x), __fadd_rn(a.y, v.y),
                       __fadd_rn(a.z, v.z), __fadd_rn(a.w, v.w));
  }
};

// One level's arrays (data/csr.py SegmentRuns and its SegmentPlan).
struct Level {
  const int* perm;
  const int* row_start;
  const int* row_end;
  int n_out;
  const int* item_ptr;
  const int* tile_item;
  const int* tile_row;
  const int* tile_slot;
  int n_tiles;
  const int* long_rows;
  const int* long_part;
  int n_long;
};

// Tile t: items [i0, i1); empty rows of [r0, r1) written as zeros; rows
// r0 .. r0 + nr staged (the last item's row may be r1); perm staged for
// slots [s0, s0 + ns).
struct Tile {
  int i0, i1, r0, r1, nr, s0, ns;
};

__device__ __forceinline__ Tile tile_of(const Level& lv, int t) {
  Tile d;
  d.i0 = __ldg(lv.tile_item + t);
  d.i1 = __ldg(lv.tile_item + t + 1);
  d.r0 = __ldg(lv.tile_row + t);
  d.r1 = __ldg(lv.tile_row + t + 1);
  d.nr = min(min(d.r1 + 1, lv.n_out) - d.r0, kRowsCap);
  d.s0 = __ldg(lv.tile_slot + t);
  d.ns = min(__ldg(lv.tile_slot + t + 1) - d.s0, kSpanCap);
  return d;
}

// One stage's arrays in shared memory.
struct Stage {
  int* ip;  // item_ptr[r0 .. r0 + nr]
  int* rs;  // row_start[r0 .. r0 + nr)
  int* re;  // row_end[r0 .. r0 + nr)
  int* pm;  // perm[s0 .. s0 + ns)
};

__device__ __forceinline__ Stage stage_at(int* base) {
  Stage s;
  s.ip = base;
  s.rs = s.ip + kRowsCap + 1;
  s.re = s.rs + kRowsCap;
  s.pm = s.re + kRowsCap;
  return s;
}

__device__ __forceinline__ void issue_stage(const Level& lv, const Tile& d,
                                            const Stage& st) {
  for (int j = threadIdx.x; j <= d.nr; j += kThreads)
    cp_async4(st.ip + j, lv.item_ptr + d.r0 + j);
  for (int j = threadIdx.x; j < d.nr; j += kThreads) {
    cp_async4(st.rs + j, lv.row_start + d.r0 + j);
    cp_async4(st.re + j, lv.row_end + d.r0 + j);
  }
  for (int j = threadIdx.x; j < d.ns; j += kThreads)
    cp_async4(st.pm + j, lv.perm + d.s0 + j);
}

// The largest j in [lo, hi] with ip[j] <= gi: the row of item gi (an empty
// row shares its item pointer with the next row, so it is never chosen).
__device__ __forceinline__ int find_row(const int* ip, int lo, int hi,
                                        int gi) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ip[mid] <= gi)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Where item (row r, chunk k) writes: the output row when the row has one
// chunk, else its partial in the scratch buffer.
__device__ __forceinline__ float* item_dst(const Level& lv, const Stage& st,
                                           int j, int r, int k, int d,
                                           float* scratch, float* out) {
  if (st.ip[j + 1] - st.ip[j] == 1) return out + static_cast<size_t>(r) * d;
  int lo = 0, hi = lv.n_long - 1;   // r is among the ascending long rows
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(lv.long_rows + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return scratch + static_cast<size_t>(__ldg(lv.long_part + lo) + k) * d;
}

// Persistent loop over the tiles, the next tile staged while `body` works
// on the current one.
template <typename Body>
__device__ __forceinline__ void for_tiles(const Level& lv, int* smem,
                                          Body body) {
  int cur = 0;
  int t = blockIdx.x;
  if (t < lv.n_tiles) issue_stage(lv, tile_of(lv, t), stage_at(smem));
  cp_async_commit();
  for (; t < lv.n_tiles; t += gridDim.x) {
    const int nt = t + gridDim.x;
    if (nt < lv.n_tiles)
      issue_stage(lv, tile_of(lv, nt), stage_at(smem + (cur ^ 1) * kStageInts));
    cp_async_commit();
    cp_async_wait<1>();        // this thread's copies of tile t are in
    __syncthreads();           // and every thread's
    body(tile_of(lv, t), stage_at(smem + cur * kStageInts));
    __syncthreads();           // before the buffer is staged again
    cur ^= 1;
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One group's current item: slots [a, b) of its row, written to dst.
struct Item {
  int a, b;
  float* dst;
};

// d > 4: the block streams the tile's slot rows (columns c0 .. c0 + cw at
// a time) through a window of shared memory, `rows` slots a window, two
// windows in flight (cp.async, every thread a few 16- or 4-byte copies);
// group g owns items i0 + g, i0 + g + G, ... and adds each window's rows
// of its open item in slot order, so the sequential chain reads shared
// memory and never waits on a gather. Items lie in slot order, so at most
// one item of a group is open across a window's end.
template <int L, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
    seg_wide_kernel(const float* __restrict__ y, int d, int n_rows, Level lv,
                    float* __restrict__ scratch, float* __restrict__ out) {
  using V = Vec<VEC>;
  constexpr int G = kThreads / L;
  extern __shared__ __align__(16) int smem[];
  float* ring = reinterpret_cast<float*>(smem + 2 * kStageInts);
  const int tid = static_cast<int>(threadIdx.x);
  const int g = tid / L;
  const int sub = tid % L;
  const int cols = d / VEC;
  // this block's slab of columns: whole passes of L * VEC
  const int passes = (d + L * VEC - 1) / (L * VEC);
  const int per = (passes + static_cast<int>(gridDim.y) - 1) /
                  static_cast<int>(gridDim.y);
  const int c_lo = static_cast<int>(blockIdx.y) * per * L * VEC;
  const int c_hi = min(d, c_lo + per * L * VEC);
  for_tiles(lv, smem, [&](const Tile& td, const Stage& st) {
    const int nz = blockIdx.y == 0 ? td.r1 - td.r0 : 0;   // empty rows once
    for (int e = tid; e < nz * cols; e += kThreads) {
      const int j = e / cols;
      if (st.ip[j + 1] == st.ip[j])
        V::store(out + static_cast<size_t>(td.r0 + j) * d + (e - j * cols) * VEC,
                 V::zero());
    }
    int lo = 0;
    // item gi of this tile: its row by a search of the staged pointers
    auto item = [&](int gi) {
      const int j = find_row(st.ip, lo, td.nr - 1, gi);
      lo = j;
      const int k = gi - st.ip[j];
      Item it;
      it.a = st.rs[j] + k * kChunk;
      it.b = min(it.a + kChunk, st.re[j]);
      it.dst = item_dst(lv, st, j, td.r0 + j, k, d, scratch, out);
      return it;
    };
    for (int c0 = c_lo; c0 < c_hi; c0 += L * VEC) {
      const int cw = min(d - c0, L * VEC);      // columns this pass
      const int pieces = cw / VEC;              // copies a slot row
      const int rows = min(kRingFloats / cw, kSpanCap);
      const int n_win = (td.ns + rows - 1) / rows;
      const int c = c0 + sub * VEC;
      const bool col = sub * VEC < cw;
      auto gather = [&](int w) {
        float* buf = ring + (w % kRingBufs) * kRingFloats;
        const int o0 = w * rows;
        const int n = min(rows, td.ns - o0) * pieces;
        for (int e = tid; e < n; e += kThreads) {
          const int o = e / pieces;
          const unsigned p = static_cast<unsigned>(st.pm[o0 + o]);
          if (p >= static_cast<unsigned>(n_rows)) continue;   // a pad slot
          const int q = e - o * pieces;
          const float* src = y + static_cast<size_t>(p) * d + c0 + q * VEC;
          if (VEC == 4)
            cp_async16(buf + o * cw + q * 4, src);
          else
            cp_async4(buf + o * cw + q, src);
        }
      };
      lo = 0;                                   // each pass walks again
      int gi = td.i0 + g;
      Item it{0, 0, nullptr};
      typename V::T acc = V::zero();
      if (gi < td.i1) it = item(gi);
      for (int w = 0; w < kRingBufs - 1; ++w) {
        if (w < n_win) gather(w);
        cp_async_commit();
      }
      for (int w = 0; w < n_win; ++w) {
        if (w + kRingBufs - 1 < n_win) gather(w + kRingBufs - 1);
        cp_async_commit();
        cp_async_wait<kRingBufs - 1>();
        __syncthreads();
        const float* buf = ring + (w % kRingBufs) * kRingFloats;
        const int w_lo = td.s0 + w * rows;
        const int w_hi = w_lo + rows;
        while (gi < td.i1 && it.a < w_hi) {
          if (it.a < td.s0 || it.b > td.s0 + td.ns) {
            // outside the staged span (the plan never makes one): gathered
            // here, in slot order
            acc = V::zero();
            for (int s = it.a; s < it.b; ++s)
              if (col)
                acc = V::add(acc, V::load(y + static_cast<size_t>(__ldg(
                                                  lv.perm + s)) * d + c));
          } else {
            const int from = max(it.a, w_lo);
            const int to = min(it.b, w_hi);
            if (col) {
              const float* src = buf + (from - w_lo) * cw + sub * VEC;
              for (int s = from; s < to; ++s, src += cw)
                acc = V::add(acc, V::load_shared(src));
            }
            if (it.b > w_hi) break;               // open into the next window
          }
          if (col) V::store(it.dst + c, acc);
          acc = V::zero();
          gi += G;
          if (gi < td.i1) it = item(gi);
        }
        __syncthreads();                          // before buf is refilled
      }
      for (; gi < td.i1; gi += G) {             // (none: see above)
        it = item(gi);
        acc = V::zero();
        for (int s = it.a; s < it.b; ++s)
          if (col)
            acc = V::add(acc, V::load(y + static_cast<size_t>(__ldg(
                                              lv.perm + s)) * d + c));
        if (col) V::store(it.dst + c, acc);
      }
    }
  });
}

// d <= 4: the block gathers every staged slot's row into shared memory
// (D floats a slot), then each thread sums whole items from there.
template <int D, bool V4>
__global__ void __launch_bounds__(kThreads)
    seg_narrow_kernel(const float* __restrict__ y, int n_rows, Level lv,
                      float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  float* ys = reinterpret_cast<float*>(smem + 2 * kStageInts);
  for_tiles(lv, smem, [&](const Tile& td, const Stage& st) {
    for (int o = threadIdx.x; o < td.ns; o += kThreads) {
      const unsigned p = static_cast<unsigned>(st.pm[o]);
      if (p >= static_cast<unsigned>(n_rows)) continue;   // a pad slot
      if (V4) {
        *reinterpret_cast<float4*>(ys + o * 4) =
            __ldg(reinterpret_cast<const float4*>(y) + p);
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c)
          ys[o * D + c] = __ldg(y + static_cast<size_t>(p) * D + c);
      }
    }
    const int nz = td.r1 - td.r0;
    for (int e = threadIdx.x; e < nz * D; e += kThreads) {
      const int j = e / D;
      if (st.ip[j + 1] == st.ip[j])
        out[static_cast<size_t>(td.r0) * D + e] = 0.0f;
    }
    __syncthreads();
    const int n_items = td.i1 - td.i0;
    int lo = 0;
    for (int i = threadIdx.x; i < n_items; i += kThreads) {
      const int gi = td.i0 + i;
      const int j = find_row(st.ip, lo, td.nr - 1, gi);
      lo = j;
      const int k = gi - st.ip[j];
      const int a = st.rs[j] + k * kChunk;
      const int b = min(a + kChunk, st.re[j]);
      float* dst = item_dst(lv, st, j, td.r0 + j, k, D, scratch, out);
      float acc[D];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = 0.0f;
      if (a >= td.s0 && b <= td.s0 + td.ns) {
        const float* src = ys + static_cast<size_t>(a - td.s0) * D;
#pragma unroll 4
        for (int s = 0; s < b - a; ++s) {
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] = __fadd_rn(acc[c], src[s * D + c]);
        }
      } else {
        for (int s = a; s < b; ++s) {
          const size_t p = static_cast<size_t>(__ldg(lv.perm + s));
#pragma unroll
          for (int c = 0; c < D; ++c)
            acc[c] = __fadd_rn(acc[c], __ldg(y + p * D + c));
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) dst[c] = acc[c];
    }
  });
}

// One block a long row: its partials (contiguous rows of the scratch
// buffer) added in chunk order, a thread a column, tiles of partials staged
// in shared memory with cp.async (two buffers).
__global__ void __launch_bounds__(kThreads)
    seg_combine_kernel(const float* __restrict__ scratch, int d,
                       const int* __restrict__ long_rows,
                       const int* __restrict__ long_part,
                       float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kCombineFloats];
  const int tid = static_cast<int>(threadIdx.x);
  const int row = __ldg(long_rows + blockIdx.x);
  const int p0 = __ldg(long_part + blockIdx.x);
  const int p1 = __ldg(long_part + blockIdx.x + 1);
  for (int c0 = 0; c0 < d; c0 += kThreads) {
    const int dc = min(d - c0, kThreads);
    const int tp = kCombineFloats / dc;          // partials a stage
    const int n_st = (p1 - p0 + tp - 1) / tp;
    auto issue = [&](int stg) {
      const int q0 = p0 + stg * tp;
      const int n = min(tp, p1 - q0) * dc;
      float* dst = buf[stg & 1];
      for (int e = tid; e < n; e += kThreads) {
        const int q = e / dc;
        cp_async4(dst + e,
                  scratch + static_cast<size_t>(q0 + q) * d + c0 + (e - q * dc));
      }
    };
    float acc = 0.0f;
    issue(0);
    cp_async_commit();
    for (int stg = 0; stg < n_st; ++stg) {
      if (stg + 1 < n_st) issue(stg + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (tid < dc) {
        const int nq = min(tp, p1 - (p0 + stg * tp));
        const float* src = buf[stg & 1] + tid;
        for (int q = 0; q < nq; ++q) acc = __fadd_rn(acc, src[q * dc]);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    if (tid < dc) out[static_cast<size_t>(row) * d + c0 + tid] = acc;
  }
}

// Blocks of a persistent grid: as many as the SMs hold at once, at most one
// a tile. Each kernel's occupancy is read (and its larger shared memory
// allowed) on its first launch: `occupancy` is that kernel's own cache.
template <typename K>
int persistent_grid(K kernel, int smem_bytes, int n_tiles, int* occupancy) {
  if (*occupancy <= 0) {
    if (smem_bytes > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem_bytes);
    *occupancy = (per_sm > 1 ? per_sm : 1) * (n_sm > 1 ? n_sm : 1);
  }
  return n_tiles < *occupancy ? n_tiles : *occupancy;
}

template <int L, int VEC>
void launch_wide(const float* y, int d, int n_rows, const Level& lv,
                 float* scratch, float* out, cudaStream_t st, int* kernels) {
  static int occupancy = 0;
  const int smem = 2 * kStageInts * 4 + kRingBufs * kRingFloats * 4;
  int gx = persistent_grid(seg_wide_kernel<L, VEC>, smem, lv.n_tiles,
                           &occupancy);
  // column slabs: as many as fill the resident blocks, in whole passes
  const int passes = (d + L * VEC - 1) / (L * VEC);
  int gy = occupancy / (lv.n_tiles > 0 ? lv.n_tiles : 1);
  gy = gy < 1 ? 1 : gy > passes ? passes : gy;
  const int per = (passes + gy - 1) / gy;
  gy = (passes + per - 1) / per;
  if (gy > 1) gx = lv.n_tiles;
  seg_wide_kernel<L, VEC><<<dim3(gx, gy), kThreads, smem, st>>>(
      y, d, n_rows, lv, scratch, out);
  ++*kernels;
}

template <int D, bool V4>
void launch_narrow(const float* y, int n_rows, const Level& lv,
                   float* scratch, float* out, cudaStream_t st,
                   int* kernels) {
  static int occupancy = 0;
  const int smem = 2 * kStageInts * 4 + kSpanCap * D * 4;
  const int grid = persistent_grid(seg_narrow_kernel<D, V4>, smem,
                                   lv.n_tiles, &occupancy);
  seg_narrow_kernel<D, V4>
      <<<grid, kThreads, smem, st>>>(y, n_rows, lv, scratch, out);
  ++*kernels;
}

template <int VEC>
void wide(int lanes, const float* y, int d, int n_rows, const Level& lv,
          float* scratch, float* out, cudaStream_t st, int* kernels) {
  switch (lanes) {
    case 1: launch_wide<1, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
    case 2: launch_wide<2, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
    case 4: launch_wide<4, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
    case 8: launch_wide<8, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
    case 16: launch_wide<16, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
    default: launch_wide<32, VEC>(y, d, n_rows, lv, scratch, out, st, kernels); break;
  }
}

}  // namespace

// y (n_rows, d) fp32; perm (n_slots,), row_start/row_end (n_out,) int32:
// one level's runs; item_ptr (n_out + 1,), tiles (3, n_tiles + 1),
// long_rows (n_long,), long_part (n_long + 1,) int32: its plan
// (data/csr.py:segment_plan); scratch (long_part[n_long], d) fp32 for the
// long rows' partials (unused when n_long is 0) -> out (n_out, d) fp32,
// every row written. One CUDA kernel, two when n_long > 0: each launch
// adds one to *n_kernels (a host int, set to 0 first), which the wrapper
// reports. Returns cudaGetLastError() after the launches.
extern "C" int segment_sum_launch(const void* y, int d, int n_rows,
                                  const void* perm, const void* row_start,
                                  const void* row_end, int n_out,
                                  const void* item_ptr, const void* tiles,
                                  int n_tiles, const void* long_rows,
                                  const void* long_part, int n_long,
                                  void* scratch, void* out, void* stream,
                                  void* n_kernels) {
  auto* k = static_cast<int*>(n_kernels);
  *k = 0;
  if (n_out > 0 && d > 0 && n_tiles > 0) {
    const auto* tl = static_cast<const int*>(tiles);
    Level lv{static_cast<const int*>(perm),
             static_cast<const int*>(row_start),
             static_cast<const int*>(row_end),
             n_out,
             static_cast<const int*>(item_ptr),
             tl,
             tl + (n_tiles + 1),
             tl + 2 * (n_tiles + 1),
             n_tiles,
             static_cast<const int*>(long_rows),
             static_cast<const int*>(long_part),
             n_long};
    const auto* yf = static_cast<const float*>(y);
    auto* sf = static_cast<float*>(scratch);
    auto* of = static_cast<float*>(out);
    auto* st = static_cast<cudaStream_t>(stream);
    // float4 columns when every row of y, out and scratch starts on 16 bytes
    const bool vec4 = d % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      (n_long == 0 || reinterpret_cast<uintptr_t>(scratch) % 16 == 0);
    if (d <= kNarrowMaxD) {
      switch (d) {
        case 1: launch_narrow<1, false>(yf, n_rows, lv, sf, of, st, k); break;
        case 2: launch_narrow<2, false>(yf, n_rows, lv, sf, of, st, k); break;
        case 3: launch_narrow<3, false>(yf, n_rows, lv, sf, of, st, k); break;
        default:
          if (vec4)
            launch_narrow<4, true>(yf, n_rows, lv, sf, of, st, k);
          else
            launch_narrow<4, false>(yf, n_rows, lv, sf, of, st, k);
      }
    } else {
      const int vec = vec4 ? 4 : 1;
      const int cols = d / vec;
      int lanes = 1;
      while (lanes < 32 && lanes < cols) lanes *= 2;
      if (vec4)
        wide<4>(lanes, yf, d, n_rows, lv, sf, of, st, k);
      else
        wide<1>(lanes, yf, d, n_rows, lv, sf, of, st, k);
    }
    if (n_long > 0) {
      seg_combine_kernel<<<n_long, kThreads, 0, st>>>(
          sf, d, static_cast<const int*>(long_rows),
          static_cast<const int*>(long_part), of);
      ++*k;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
