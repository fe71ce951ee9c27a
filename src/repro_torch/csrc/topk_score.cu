// Fused dequantize * score * top-K retrieval over a packed item table.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py:_topk_kernel.
//
// Bound on the H100: the packed table (I*ceil(d*b/8) bytes), 8 bytes of
// scale/zero per item, the queries and the exclusion lists are read once,
// (B, k) values and indices are written once; against 2*B*I*d fp32 flops on
// the CUDA cores. At the eval's B 128 the flops bound it (about 0.025 ms at
// I 24,915, d 256); at the engine's B <= 8 the bytes.
//
// Design. The selection, the persistent schedule and the merges are
// topk_select.cuh's, shared with the coarse top-m kernel; this file holds
// the product (FmaProduct). A unit is QT queries x 128 items; the item tile
// is decoded into shared memory a step of features at a time, and each
// thread holds a TQ x 4 register tile of dots, so one shared load feeds
// TQ or 4 FMAs:
//   QT 32: 4 x 4 (a warp 16 queries x 32 items), QT 16: 2 x 4, QT 8: 1 x 4;
// the plan takes the smallest QT >= B (B > 32 in tiles of 32). Below 8
// queries the padded rows cost FMAs only: tiles 2 and 4 saved at most 1.4
// us of device time a call at B 1-2 and lost at B 4 (PERF.md). Each dot
// is one fp32 FMA chain in feature order from 0, whatever the tile: the
// values do not depend on B or on the schedule (a card test holds them to
// that chain, emulated in float64, bit for bit).
// Decode: a step is 32 features (128 below QT 32) of one chunk of the
// chunk-interleaved pack (feature c*dp + byte sits in byte `byte` at shift
// c*BITS). A thread's half of its item's step is copied to shared memory by
// cp.async, 16 bytes a copy (byte by byte when the table is not 16-byte
// aligned or dp % 16 != 0), one step ahead, so the copies fly while the
// current step's FMAs run; then shifted by the chunk's constant (BITS a
// template parameter; no division runs per code). scale and zero are read
// once per item per tile, and x = code*scale + zero keeps the plain
// version's two roundings (__fmul_rn, __fadd_rn). A dense fp32 table (BITS
// 0) is read as is. The query tile is staged whole, once per run of a query
// tile, where it fits (d <= 256 at every tile here); else a step's slice
// comes with the step. At QT 32 two CTAs share an SM (the plan's grid), so
// one CTA's selection overlaps the other's product.
// What bounds it (PERF.md): the 4 x 4 tile issues one shared load per FMA,
// twice the FMA time at B 128, and the selection's dependent chains.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk_select.cuh"

namespace {

using topk_select::kThreads;
using topk_select::kTile;
using topk_select::kWarps;
using topk_select::ScanArgs;

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// BITS in {1, 2, 4, 8} reads the packed table, BITS 0 the dense one.
template <int BITS, int QT>
struct FmaProduct {
  static constexpr int TQ = QT >= 32 ? 4 : QT >= 16 ? 2 : 1;
  static constexpr int TI = 4;
  static constexpr int WQ = QT >= 32 ? 4 : 8;                 // lanes on q
  static constexpr int WI = 32 / WQ;                          // lanes on items
  static constexpr int WARPS_I = kTile / (TI * WI);
  static_assert(QT / (TQ * WQ) * WARPS_I == kWarps, "tile shape");
  // features a step: 128 below QT 32, where a step's FMAs are few and the
  // loads' latency shows, so more of a tile's bytes fly at once; 32 at QT
  // 32, whose smaller footprint lets two CTAs share an SM
  static constexpr int kDT = BITS == 0 || QT >= 32 ? 32 : 128;
  static constexpr int kFT = kDT / 2;   // features a thread stages a step
  static constexpr int kSX = kTile + 4; // row stride of the staged items
  static constexpr int CH = BITS ? 8 / BITS : 1;
  static constexpr unsigned kMask = BITS ? (1u << BITS) - 1u : 0u;
  static constexpr int kSQ = QT + 4;    // row stride of the staged queries
  static constexpr int kQTotal = QT * kDT / 4;  // float4 query jobs a step
  static constexpr int kQJobs = (kQTotal + kThreads - 1) / kThreads;

  static constexpr int kBuffers = 2;
  static constexpr int kMinBlocks = 1;
  static constexpr int NV = BITS ? kFT / 16 : kFT / 4;  // 16-byte loads
  struct Regs {
    float4 q[kQJobs];
  };
  struct Acc {
    float a[TQ][TI];
  };

  // The query tile is staged whole, once per run of a query tile (q_once),
  // where its dim x kSQ floats fit beside the rest at the longest list;
  // else a step's slice is staged with the step.
  // staged items, then each thread's raw bytes and its item's scale/zero
  static constexpr size_t kSXBytes = 2 * kDT * kSX * sizeof(float) +
                                     NV * kThreads * sizeof(uint4) +
                                     2 * kThreads * sizeof(float);
  static constexpr size_t kQBudget =
      topk_select::kMaxSmem - kSXBytes -
      (QT * topk_select::kMaxList + kWarps * kTile) *
          sizeof(topk_select::Entry) -
      QT * topk_select::kSS * sizeof(float);
  static __host__ __device__ bool q_fits(int dim) {
    return static_cast<size_t>(dim) * kSQ * sizeof(float) <= kQBudget;
  }

  const ScanArgs a;
  float* sx;   // [2][kDT][kSX] items, feature-major
  uint4* raw;  // [NV][kThreads] a step's bytes, by cp.async
  float* rsz;  // [2][kThreads] the thread's item's scale and zero
  float* sq;   // [dim][kSQ] with q_once, else [2][kDT][kSQ]
  int dp;     // bytes a packed row; the dense row's width
  int spc;    // steps a chunk
  bool vec;
  bool vecq;
  bool q_once;
  int staged_q0 = -1;

  static size_t smem_bytes(int dim) {
    return kSXBytes + (q_fits(dim) ? static_cast<size_t>(dim) * kSQ
                                   : 2 * kDT * kSQ) * sizeof(float);
  }

  __device__ FmaProduct(const ScanArgs& args, unsigned char* smem)
      : a(args),
        sx(reinterpret_cast<float*>(smem)),
        raw(reinterpret_cast<uint4*>(sx + 2 * kDT * kSX)),
        rsz(reinterpret_cast<float*>(raw + NV * kThreads)),
        sq(rsz + 2 * kThreads) {
    q_once = q_fits(a.dim);
    dp = BITS ? a.dp : a.dim;
    spc = (dp + kDT - 1) / kDT;
    const uintptr_t base = BITS ? reinterpret_cast<uintptr_t>(a.packed)
                                : reinterpret_cast<uintptr_t>(a.items);
    vec = base % 16 == 0 && (BITS ? dp % 16 == 0 : dp % 4 == 0);
    vecq = reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && a.dim % 4 == 0 &&
           dp % 4 == 0;
  }

  __device__ int n_steps() const { return CH * spc; }

  // step -> (chunk c, byte offset b0 in the row, first feature f0, width w)
  __device__ void slice(int step, int& c, int& b0, int& f0, int& w) const {
    c = step / spc;
    b0 = (step - c * spc) * kDT;
    f0 = c * dp + b0;
    w = min(min(kDT, dp - b0), a.dim - f0);
  }

  __device__ void zero(Acc& acc) const {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) acc.a[i][j] = 0.0f;
  }

  // The step's bytes of this thread's item go to raw by cp.async (16 bytes
  // a copy; byte by byte, synchronously, where the table is not aligned),
  // and at step 0 the item's scale and zero; the query slice to registers.
  __device__ void load(Regs& r, int, int q0, int i0, int step) const {
    int c, b0, f0, w;
    slice(step, c, b0, f0, w);
    const int tid = threadIdx.x;
    const int item = i0 + (tid & (kTile - 1));
    const int h = (tid >> 7) * kFT;  // this thread's features of the step
    const int nb = min(kFT, w - h);
    const bool real = item < a.n_items && nb > 0;
    if constexpr (BITS > 0) {
      if (step == 0 && item < a.n_items) {
        topk_select::cp_async4(rsz + tid, a.scale + item);
        topk_select::cp_async4(rsz + kThreads + tid, a.zero + item);
      }
    }
    const unsigned char* p =
        BITS ? a.packed + static_cast<size_t>(item) * dp + b0 + h
             : reinterpret_cast<const unsigned char*>(
                   a.items + static_cast<size_t>(item) * dp + f0 + h);
    if (real && vec && nb == kFT) {
#pragma unroll
      for (int t = 0; t < NV; ++t)
        topk_select::cp_async16(raw + t * kThreads + tid, p + 16 * t);
    } else {
      uint32_t wd[4 * NV];
#pragma unroll
      for (int t = 0; t < 4 * NV; ++t) wd[t] = 0;
      if (real) {
        if constexpr (BITS > 0) {
          for (int f = 0; f < nb; ++f)
            wd[f >> 2] |= static_cast<uint32_t>(p[f]) << (8 * (f & 3));
        } else {
          for (int f = 0; f < nb; ++f)
            wd[f] = reinterpret_cast<const uint32_t*>(p)[f];
        }
      }
#pragma unroll
      for (int t = 0; t < NV; ++t)
        raw[t * kThreads + tid] =
            make_uint4(wd[4 * t], wd[4 * t + 1], wd[4 * t + 2], wd[4 * t + 3]);
    }
    topk_select::cp_async_commit();
    // four consecutive features of one query a job: a warp reads whole
    // 128-byte rows
    if (q_once) return;
#pragma unroll
    for (int k = 0; k < kQJobs; ++k) {
      const int job = tid + k * kThreads;
      const int qq = job / (kDT / 4), j4 = (job % (kDT / 4)) * 4;
      const int b = q0 + qq;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (job < kQTotal && b < a.B && j4 < w) {
        const float* p = a.q + static_cast<size_t>(b) * a.dim + f0 + j4;
        if (vecq && j4 + 4 <= w) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = p[0];
          if (j4 + 1 < w) v.y = p[1];
          if (j4 + 2 < w) v.z = p[2];
          if (j4 + 3 < w) v.w = p[3];
        }
      }
      r.q[k] = v;
    }
  }

  __device__ void store(const Regs& r, int buf, int q0, int i0, int step) {
    int c, b0, f0, w;
    slice(step, c, b0, f0, w);
    const int tid = threadIdx.x;
    const int il = tid & (kTile - 1);
    const int h = (tid >> 7) * kFT;
    float* X = sx + buf * kDT * kSX;
    const bool real = i0 + il < a.n_items;
    topk_select::cp_async_wait();
    uint4 xr[NV];
#pragma unroll
    for (int t = 0; t < NV; ++t) xr[t] = raw[t * kThreads + tid];
    const uint32_t* words = reinterpret_cast<const uint32_t*>(xr);
    float sc = 0.0f, z = 0.0f;
    if constexpr (BITS > 0) {
      sc = rsz[tid];
      z = rsz[kThreads + tid];
    }
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      float x = 0.0f;
      if (real && h + f < w) {
        if constexpr (BITS > 0) {
          const unsigned byte = (words[f >> 2] >> (8 * (f & 3))) & 0xffu;
          const unsigned code = (byte >> (c * BITS)) & kMask;
          x = __fadd_rn(__fmul_rn(static_cast<float>(code), sc), z);
        } else {
          x = __uint_as_float(words[f]);
        }
      }
      X[(h + f) * kSX + il] = x;
    }
    if (q_once) {
      // a new query tile: every warp is past the last tile's product (the
      // tile epilogue's barriers), and the next barrier guards the reads
      if (step == 0 && q0 != staged_q0) stage_queries(q0);
      return;
    }
    float* Q = sq + buf * kDT * kSQ;
#pragma unroll
    for (int k = 0; k < kQJobs; ++k) {
      const int job = tid + k * kThreads;
      if (job >= kQTotal) break;
      const int qq = job / (kDT / 4), j4 = (job % (kDT / 4)) * 4;
      Q[(j4 + 0) * kSQ + qq] = r.q[k].x;
      Q[(j4 + 1) * kSQ + qq] = r.q[k].y;
      Q[(j4 + 2) * kSQ + qq] = r.q[k].z;
      Q[(j4 + 3) * kSQ + qq] = r.q[k].w;
    }
  }

  // The whole query tile into sq[f][qq], four features of a row a job.
  __device__ void stage_queries(int q0) {
    staged_q0 = q0;
    const int n4 = (a.dim + 3) / 4;
    for (int job = threadIdx.x; job < QT * n4; job += kThreads) {
      const int qq = job / n4, f = (job - qq * n4) * 4;
      const int b = q0 + qq;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b < a.B) {
        const float* p = a.q + static_cast<size_t>(b) * a.dim + f;
        if (vecq) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = p[0];
          if (f + 1 < a.dim) v.y = p[1];
          if (f + 2 < a.dim) v.z = p[2];
          if (f + 3 < a.dim) v.w = p[3];
        }
      }
      sq[f * kSQ + qq] = v.x;
      if (f + 1 < a.dim) sq[(f + 1) * kSQ + qq] = v.y;
      if (f + 2 < a.dim) sq[(f + 2) * kSQ + qq] = v.z;
      if (f + 3 < a.dim) sq[(f + 3) * kSQ + qq] = v.w;
    }
  }

  __device__ void compute(int buf, Acc& acc, int step) const {
    int c, b0, f0, w;
    slice(step, c, b0, f0, w);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int qrow = ((warp / WARPS_I) * WQ + lane / WI) * TQ;
    const int icol = ((warp % WARPS_I) * WI + lane % WI) * TI;
    const float* X = sx + buf * kDT * kSX + icol;
    const float* Q = (q_once ? sq + f0 * kSQ : sq + buf * kDT * kSQ) + qrow;
    if (w == kDT) {
#pragma unroll
      for (int jj = 0; jj < kDT; ++jj)
        fma_step(acc, Q + jj * kSQ, X + jj * kSX);
    } else {
      for (int jj = 0; jj < w; ++jj) fma_step(acc, Q + jj * kSQ, X + jj * kSX);
    }
  }

  __device__ __forceinline__ static void fma_step(Acc& acc, const float* Q,
                                                  const float* X) {
    float qv[TQ], xv[TI];
    load_vec<TQ>(Q, qv);
    load_vec<TI>(X, xv);
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j)
        acc.a[i][j] = fmaf(qv[i], xv[j], acc.a[i][j]);
  }

  __device__ void write_scores(const Acc& acc, float* ss, int, int) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int qrow = ((warp / WARPS_I) * WQ + lane / WI) * TQ;
    const int icol = ((warp % WARPS_I) * WI + lane % WI) * TI;
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j)
        ss[(qrow + i) * topk_select::kSS + icol + j] = acc.a[i][j];
  }
};

// The product at bits (0: the dense table) and query tile qt (0: picked by
// B) handed to f.
template <class F>
cudaError_t dispatch(int bits, int qt, int B, F&& f) {
  if (qt <= 0) qt = topk_select::pick_qt(B);
  switch (bits) {
    case 0: return topk_select::at_tile<FmaProduct, 0>(qt, f);
    case 1: return topk_select::at_tile<FmaProduct, 1>(qt, f);
    case 2: return topk_select::at_tile<FmaProduct, 2>(qt, f);
    case 4: return topk_select::at_tile<FmaProduct, 4>(qt, f);
    case 8: return topk_select::at_tile<FmaProduct, 8>(qt, f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, dim) fp32; packed (n_items, dp) uint8 with bits in {1,2,4,8}, or
// items (n_items, dim) fp32 with bits == 0; scale/zero (n_items,) fp32 (unused
// when bits == 0); excl (B, P) int32, -1 pads; qt the query tile (0: picked
// by B); cand_a/cand_b the scratch buffers of scratch_bytes each that
// topk_plan asks for (null where it asks for fewer) -> out_v (B, k) fp32,
// out_i (B, k) int32. Requires 1 <= k <= n_items. Returns
// cudaGetLastError() after the last launch, cudaErrorInvalidValue when the
// inputs or the scratch do not fit; *started gains one at each CUDA kernel
// launched.
extern "C" int topk_launch(const void* q, int B, int dim, const void* packed,
                           int dp, int bits, const void* items,
                           const void* scale, const void* zero,
                           const void* excl, int P, int n_items, int k,
                           int qt, void* cand_a, void* cand_b,
                           long long scratch_bytes, void* out_v, void* out_i,
                           void* stream, int* started) {
  const ScanArgs a{static_cast<const float*>(q), nullptr, B, dim,
                   static_cast<const uint8_t*>(packed), dp,
                   static_cast<const float*>(items),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(zero),
                   static_cast<const int*>(excl), P, n_items};
  return static_cast<int>(dispatch(bits, qt, B, [&](auto tag) {
    using T = decltype(tag);
    return topk_select::select_topm<typename T::Product, T::kQT>(
        a, k, static_cast<topk_select::Entry*>(cand_a),
        static_cast<topk_select::Entry*>(cand_b), scratch_bytes,
        static_cast<float*>(out_v), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream), started);
  }));
}

// The plan of a topk_launch with these shapes on the current device, into
// out[7] (topk_select::write_plan); cudaErrorInvalidValue when none fits.
extern "C" int topk_plan(int B, int n_items, int k, int dim, int dp,
                         int bits, int qt, long long* out) {
  ScanArgs a{};
  a.B = B;
  a.dim = dim;
  a.dp = dp;
  a.n_items = n_items;
  topk_select::Plan p;
  const cudaError_t err = dispatch(bits, qt, B, [&](auto tag) {
    using T = decltype(tag);
    return topk_select::make_plan<typename T::Product, T::kQT>(a, k, &p);
  });
  if (err == cudaSuccess) topk_select::write_plan(p, out);
  return static_cast<int>(err);
}
