// Coarse top-m scan of two-stage retrieval, in the packed code domain.
//
// Replaces the TPU kernel src/repro/kernels/topk_score.py:_coarse_kernel.
//
// Score of item i for query b: dot * (qs_b * scale_i) + sq_b * zero_i, where
// dot = q8_b . codes_i is the integer product of the symmetric INT8 query
// codes (integer-valued fp32 in [-127, 127]) and the item's unsigned b-bit
// codes, and qmeta_b = [qs_b, sq_b] (scorer.quantize_query). Item rows are
// never dequantized and no fp32 item row is written to memory.
//
// Bound on the H100: the packed table (I*ceil(d*b/8) bytes), 8 bytes of
// scale/zero per item, q8 (B*d*4), qmeta (B*8) and the exclusion lists read
// once, (B, m) values and indices written once; against 2*B*I*d operations
// for the dot at the int8 tensor-core rate (1,979 TOP/s), so the bytes bound
// it at every batch the path gives it.
//
// Design. The selection, the persistent schedule and the merges are
// topk_select.cuh's, shared with the top-K kernel; this file holds the
// product (MmaProduct): the integer dot on the int8 tensor cores,
// mma.sync.m16n8k32 with the item codes as the u8 A operand (16 items x 32
// codes) and the query codes as the s8 B operand (32 codes x 8 queries),
// accumulated in s32, which is exact. A unit is QT queries (8, 16 or 32: the
// smallest >= B, B > 32 in tiles of 32) x 128 items; each warp owns 16 items
// and all of the unit's queries. Padded query rows cost only tensor-core
// MMAs, which are nowhere near the bound at these shapes. The dot is order
// free, so the K axis is the pack's own (chunk c, byte) order, chunk width
// dp rounded up to 16: the tile's packed rows go to shared memory by
// cp.async, 16 bytes a copy (byte by byte when the table is not 16-byte
// aligned or dp % 16 != 0), issued as soon as every warp is past the last
// tile's product so they fly during its selection; each thread then
// unpacks its own copies in place (BITS a template parameter; a word-wide
// shift and mask, no per-code division; INT8 codes are the bytes). The
// query codes are staged in the same order (feature c*dp + byte, zero past
// dp or dim), converted to s8, once per run of a query tile where a tile is
// one step (K <= 256), else with every step. The dot then turns into float
// (exact below 2^24, which the wrapper checks) and the affine step rounds
// the three products and the sum apart (__fmul_rn/__fadd_rn, no
// contraction) in the plain version's order, so kernel and plain version
// agree bit for bit on any input. One staging buffer and at most 128
// registers a thread let two CTAs share an SM (the plan's grid at B 128),
// so one CTA's selection overlaps the other's staging.
// What bounds it (PERF.md): the selection. Lists of m = 80 make each run's
// first tiles sort and merge most of their 128 scores; the tensor cores and
// the bytes are nowhere near their bounds.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk_select.cuh"

namespace {

using topk_select::kThreads;
using topk_select::kTile;
using topk_select::ScanArgs;

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BITS, int QT>
struct MmaProduct {
  // one step a tile at d <= 256: a single buffer, refilled while the
  // selection runs, and at most 128 registers a thread keep the footprint
  // small enough for two CTAs an SM, so one CTA's selection overlaps the
  // other's staging
  static constexpr int kBuffers = 1;
  static constexpr int kMinBlocks = 2;
  static constexpr int NB = QT / 8;         // n8 blocks of queries
  static constexpr int KS = 256;            // codes (bytes of K) a step
  static constexpr int kRow = KS + 16;      // staged row stride (bytes)
  static constexpr int CH = 8 / BITS;
  static constexpr uint32_t kMask4 = ((1u << BITS) - 1u) * 0x01010101u;
  static constexpr int kBlocks = kTile * KS / 16 / kThreads;   // 8
  static constexpr int kQTotal = QT * KS / 4;  // 4-code query jobs a step
  static constexpr int kQJobs = (kQTotal + kThreads - 1) / kThreads;

  struct Regs {
    float4 q[kQJobs];
  };
  struct Acc {
    int d[NB][4];
  };

  const ScanArgs a;
  uint8_t* sa;  // [kTile][kRow] item codes (u8)
  uint8_t* sb;  // [QT][kRow] query codes (s8)
  int dpp;      // chunk width in K: dp rounded up to 16
  int ktot;     // CH * dpp rounded up to 32
  bool vec;
  bool vecq;
  bool q_once;  // one step a tile: the query codes stay for the whole run
  int staged_q0 = -1;

  static size_t smem_bytes(int) {
    return static_cast<size_t>(kTile + QT) * kRow;
  }

  __device__ MmaProduct(const ScanArgs& args, unsigned char* smem)
      : a(args), sa(smem), sb(smem + kTile * kRow) {
    dpp = (a.dp + 15) / 16 * 16;
    ktot = (CH * dpp + 31) / 32 * 32;
    vec = reinterpret_cast<uintptr_t>(a.packed) % 16 == 0 && a.dp % 16 == 0;
    vecq = reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && a.dim % 4 == 0 &&
           a.dp % 4 == 0;
    q_once = n_steps() == 1;
  }

  __device__ int n_steps() const { return (ktot + KS - 1) / KS; }

  __device__ void zero(Acc& acc) const {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc.d[n][t] = 0;
  }

  // The step's packed bytes go straight to the shared buffer by cp.async
  // (16 bytes a copy; byte by byte, synchronously, where the table is not
  // aligned); store() unpacks them in place.
  __device__ void load(Regs& r, int, int q0, int i0, int step) const {
    const int tid = threadIdx.x;
    const int k0 = step * KS;
    uint8_t* A = sa;
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const int blk = tid + j * kThreads;
      const int il = blk / (KS / 16);
      const int item = i0 + il;
      const int k = k0 + (blk % (KS / 16)) * 16;
      const int c = k / dpp;
      const int byte0 = k - c * dpp;
      uint8_t* dst = A + il * kRow + (blk % (KS / 16)) * 16;
      const bool real = item < a.n_items && c < CH && byte0 < a.dp;
      const uint8_t* p =
          a.packed + static_cast<size_t>(item) * a.dp + byte0;
      if (real && vec) {
        topk_select::cp_async16(dst, p);
      } else {
        uint32_t wd[4] = {0, 0, 0, 0};
        if (real) {
          const int nb = min(16, a.dp - byte0);
          for (int f = 0; f < nb; ++f)
            wd[f >> 2] |= static_cast<uint32_t>(p[f]) << (8 * (f & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2],
                                                    wd[3]);
      }
    }
    topk_select::cp_async_commit();
    if (!q_once) load_queries(r, q0, step);
  }

  // Four consecutive K indices of one query a job (one chunk, since dpp is
  // a multiple of 16): a warp reads 128 consecutive codes of a row.
  __device__ void load_queries(Regs& r, int q0, int step) const {
    const int tid = threadIdx.x;
    const int k0 = step * KS;
#pragma unroll
    for (int j = 0; j < kQJobs; ++j) {
      const int job = tid + j * kThreads;
      const int qq = job / (KS / 4);
      const int b = q0 + qq;
      const int k = k0 + (job % (KS / 4)) * 4;
      const int c = k / dpp;
      const int byte = k - c * dpp;
      const int f = c * a.dp + byte;  // the feature of K index k
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (job < kQTotal && b < a.B && c < CH && byte < a.dp && f < a.dim) {
        const float* p = a.q + static_cast<size_t>(b) * a.dim + f;
        if (vecq && byte + 4 <= a.dp && f + 4 <= a.dim) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = p[0];
          if (byte + 1 < a.dp && f + 1 < a.dim) v.y = p[1];
          if (byte + 2 < a.dp && f + 2 < a.dim) v.z = p[2];
          if (byte + 3 < a.dp && f + 3 < a.dim) v.w = p[3];
        }
      }
      r.q[j] = v;
    }
  }

  __device__ void store(Regs& r, int, int q0, int, int step) {
    const int tid = threadIdx.x;
    const int k0 = step * KS;
    topk_select::cp_async_wait();
    if constexpr (BITS < 8) {  // each thread unpacks the blocks it loaded
      uint8_t* A = sa;
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        const int blk = tid + j * kThreads;
        const int kb = blk % (KS / 16);
        uint4* p = reinterpret_cast<uint4*>(A + (blk / (KS / 16)) * kRow +
                                            kb * 16);
        uint4 w = *p;
        const int shift = ((k0 + kb * 16) / dpp) * BITS;
        w.x = (w.x >> shift) & kMask4;
        w.y = (w.y >> shift) & kMask4;
        w.z = (w.z >> shift) & kMask4;
        w.w = (w.w >> shift) & kMask4;
        *p = w;
      }
    }
    if (q_once) {
      // a new query tile: every warp is past the last tile's product (the
      // tile epilogue's barriers), and the next barrier guards the reads
      if (q0 == staged_q0) return;
      staged_q0 = q0;
      load_queries(r, q0, 0);
    }
    uint8_t* Bq = sb;
#pragma unroll
    for (int j = 0; j < kQJobs; ++j) {
      const int job = tid + j * kThreads;
      if (job >= kQTotal) break;
      const int qq = job / (KS / 4);
      const int kq = (job % (KS / 4)) * 4;
      const float4 v = r.q[j];
      const uint32_t w4 =
          (static_cast<uint32_t>(__float2int_rn(v.x)) & 0xffu) |
          (static_cast<uint32_t>(__float2int_rn(v.y)) & 0xffu) << 8 |
          (static_cast<uint32_t>(__float2int_rn(v.z)) & 0xffu) << 16 |
          (static_cast<uint32_t>(__float2int_rn(v.w)) & 0xffu) << 24;
      *reinterpret_cast<uint32_t*>(Bq + qq * kRow + kq) = w4;
    }
  }

  __device__ void compute(int, Acc& acc, int step) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int kw = min(KS, ktot - step * KS);
    const uint8_t* A = sa + (warp * 16 + g) * kRow + tig * 4;
    const uint8_t* Bq = sb + g * kRow + tig * 4;
    for (int kk = 0; kk < kw; kk += 32) {
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(A + kk);
      af[1] = *reinterpret_cast<const uint32_t*>(A + 8 * kRow + kk);
      af[2] = *reinterpret_cast<const uint32_t*>(A + kk + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(A + 8 * kRow + kk + 16);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const uint8_t* bp = Bq + n * 8 * kRow + kk;
        mma_u8s8(acc.d[n], af, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 16));
      }
    }
  }

  __device__ __forceinline__ float score(int b, int item, int dot) const {
    if (b >= a.B || item >= a.n_items) return 0.0f;
    const float qs = a.qmeta[static_cast<size_t>(b) * 2];
    const float sum_q = a.qmeta[static_cast<size_t>(b) * 2 + 1];
    return __fadd_rn(__fmul_rn(static_cast<float>(dot),
                               __fmul_rn(qs, a.scale[item])),
                     __fmul_rn(sum_q, a.zero[item]));
  }

  // D fragment: d[0], d[1] item g, queries 2*tig and 2*tig + 1; d[2], d[3]
  // item g + 8, the same queries.
  __device__ void write_scores(const Acc& acc, float* ss, int q0,
                               int i0) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int it0 = warp * 16 + g, it1 = it0 + 8;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int qa = n * 8 + 2 * tig, qb = qa + 1;
      ss[qa * topk_select::kSS + it0] = score(q0 + qa, i0 + it0, acc.d[n][0]);
      ss[qb * topk_select::kSS + it0] = score(q0 + qb, i0 + it0, acc.d[n][1]);
      ss[qa * topk_select::kSS + it1] = score(q0 + qa, i0 + it1, acc.d[n][2]);
      ss[qb * topk_select::kSS + it1] = score(q0 + qb, i0 + it1, acc.d[n][3]);
    }
  }
};

// The product at bits and query tile qt (0: picked by B) handed to f.
template <class F>
cudaError_t dispatch(int bits, int qt, int B, F&& f) {
  if (qt <= 0) qt = topk_select::pick_qt(B);
  switch (bits) {
    case 1: return topk_select::at_tile<MmaProduct, 1>(qt, f);
    case 2: return topk_select::at_tile<MmaProduct, 2>(qt, f);
    case 4: return topk_select::at_tile<MmaProduct, 4>(qt, f);
    case 8: return topk_select::at_tile<MmaProduct, 8>(qt, f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q8 (B, dim) fp32 integer-valued codes; qmeta (B, 2) fp32 [qs, sum q];
// packed (n_items, dp) uint8 with bits in {1,2,4,8}; scale/zero (n_items,)
// fp32; excl (B, P) int32, -1 pads; qt the query tile (0: picked by B);
// cand_a/cand_b the scratch buffers of scratch_bytes each that
// coarse_topm_plan asks for (null where it asks for fewer) -> out_v (B, m)
// fp32, out_i (B, m) int32. Requires 1 <= m <= n_items. Returns
// cudaGetLastError() after the last launch, cudaErrorInvalidValue when the
// inputs or the scratch do not fit.
extern "C" int coarse_topm_launch(const void* q8, const void* qmeta, int B,
                                  int dim, const void* packed, int dp,
                                  int bits, const void* scale,
                                  const void* zero, const void* excl, int P,
                                  int n_items, int m, int qt, void* cand_a,
                                  void* cand_b, long long scratch_bytes,
                                  void* out_v, void* out_i, void* stream) {
  const ScanArgs a{static_cast<const float*>(q8),
                   static_cast<const float*>(qmeta), B, dim,
                   static_cast<const uint8_t*>(packed), dp, nullptr,
                   static_cast<const float*>(scale),
                   static_cast<const float*>(zero),
                   static_cast<const int*>(excl), P, n_items};
  return static_cast<int>(dispatch(bits, qt, B, [&](auto tag) {
    using T = decltype(tag);
    return topk_select::select_topm<typename T::Product, T::kQT>(
        a, m, static_cast<topk_select::Entry*>(cand_a),
        static_cast<topk_select::Entry*>(cand_b), scratch_bytes,
        static_cast<float*>(out_v), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream));
  }));
}

// The plan of a coarse_topm_launch with these shapes on the current device,
// into out[7] (topk_select::write_plan); cudaErrorInvalidValue when none
// fits.
extern "C" int coarse_topm_plan(int B, int n_items, int m, int dim, int dp,
                                int bits, int qt, long long* out) {
  ScanArgs a{};
  a.B = B;
  a.dim = dim;
  a.dp = dp;
  a.n_items = n_items;
  topk_select::Plan p;
  const cudaError_t err = dispatch(bits, qt, B, [&](auto tag) {
    using T = decltype(tag);
    return topk_select::make_plan<typename T::Product, T::kQT>(a, m, &p);
  });
  if (err == cudaSuccess) topk_select::write_plan(p, out);
  return static_cast<int>(err);
}
