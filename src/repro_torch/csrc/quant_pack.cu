// Fused per-row min/max + quantize (nearest or counter-hash SR) + bit-pack.
//
// Replaces the TPU kernel src/repro/kernels/quant_pack.py:_quant_kernel.
//
// Input: fp32, or bf16 (a bf16 value is the top half of an fp32, so it
// widens exactly, in registers: the codes, scale and zero of a bf16 row
// are those of its fp32 upcast, bit for bit, as the TPU kernel casts to
// fp32 inside). One code path for both, templated on the element E; the
// byte counts below are for fp32, a bf16 input reads half as many.
//
// Bound on the H100: bytes. It reads R*d*4 bytes of fp32 and writes
// R*ceil(d*b/8) packed bytes plus 8 bytes of scale/zero per row: at
// 3.35 TB/s about 0.84 G elements a ms. The SMs issue about 33 T
// thread-instructions a second (4 warp-instructions a clock x 132 SMs x
// 1.98 GHz), so the byte bound leaves about 40 instructions an element, and
// the SR hash and the fp32 steps of a code take about 20 of them: the
// design is as much about instructions as about bytes. chip_smoke.py counts
// the built kernels' SASS instructions an element (cuobjdump -sass) and
// prints them beside the bound.
//
// Design. A tile of T consecutive rows of the contiguous (rows, d) input is
// one contiguous span of T*d floats, its packed output one span of T*dp
// bytes, its scale and zero T floats each, and an element's SR counter is
// its flat position in the input. So the bytes move as whole spans at any
// d, and the per-row structure exists only in shared memory
// (quant_tile_kernel):
// - a persistent grid (blocks an SM from the occupancy of the tile's shared
//   memory, the SM count read once and cached) walks tiles t, t + grid, ...;
// - each block keeps a ring of kStages = 2 tile buffers: while it works on
//   tile i, tile i+1 is in flight. Thread 0 issues a tile's copy: its
//   16-byte aligned interior as one TMA bulk copy (cp.async.bulk, completion
//   on the buffer's mbarrier), a misaligned head and tail (at most 3 floats
//   each: a table that is a row slice of another at an odd d) as 4-byte
//   cp.async tracked by the same mbarrier (bf16: at most 7 elements each,
//   copied by thread 0 with plain loads and stores before its arrival,
//   which releases them: cp.async moves no 2-byte unit). Every byte of x
//   is read from
//   device memory once. Two 32 KB buffers (three blocks an SM) beat three
//   (two blocks) and smaller or larger tiles on the H100;
// - T is picked per d: a stage of about kStageFloats floats, T*d a
//   multiple of 4 and T*dp of 16 where the stage allows it (then every tile
//   starts on the same alignment), and the tile's packed words a near whole
//   number of rounds of the block's threads;
// - min/max: groups of G lanes a row over the whole block, G sized to T and
//   d so that one pass covers the tile, float4 reads where rows sit on 16
//   bytes; the butterfly of __shfl_xor_sync (width G) is exact, so its
//   order does not matter. Spreading the rows over the block, instead of a
//   warp's groups looping over them, was the largest single gain on the
//   H100 at ogbn-products' widths: each pass of such a loop paid a shuffle
//   chain and a division;
// - codes: flat over the tile's packed bytes, each thread makes whole 32-bit
//   words, each byte from its cpb = 8/bits source columns j, dp+j, 2dp+j,
//   ... (the chunk-interleaved layout of DESIGN.md section 2); pad codes
//   past d pack as 0. A thread's (row, byte) position advances by a
//   precomputed step, so no division by d or dp runs per word. Where packed
//   rows are whole words (d a multiple of 4*cpb) a word's codes are cpb
//   float4 reads under one (lo, inv) and the word goes straight to device
//   memory; else a word's bytes may lie in two rows, are visited in an order
//   rotated by lane/8 (a warp's reads of one step fall in 32 banks), and
//   the words are staged in shared memory and leave as 16-byte stores (a
//   misaligned first or last chunk byte by byte);
// - a row wider than one stage is a tile of one row (the row kept in shared
//   memory).
// A table of at most 2^16 elements (2^18 with d >= 32), or with rows wider
// than two buffers of the opt-in shared memory (d > about 28,000), takes
// quant_rows_kernel: a warp a row, min/max from device memory, then the
// codes from a second read (L1/L2). On a table of a few thousand rows the
// time is the chain of dependent steps, and a warp a row has the shortest.
// One CUDA kernel a call either way.
//
// Numerics follow the reference's fp32 order exactly, with no contraction:
// inv = bins / max(R, 1e-12); normed = (x - lo) * inv; scale = R * fl(1/bins)
// (XLA compiles the reference's R / bins, a division by a constant, into a
// multiply by the float32-rounded reciprocal; the port keeps that rounding).
// Nearest rounding is rintf (half to even, like jnp.round); SR compares a
// murmur3 uniform of the global element index row*d+col (uint32, mod 2^32)
// with the fractional part.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdlib>

#include "hashrng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;                 // tile buffers in the ring
constexpr int kStageFloats = 8192;         // x floats a stage aims at (32 KB)
constexpr int kSmallElems = 1 << 16;       // a table this small: warp a row
constexpr int kBarBytes = 16;              // the stages' mbarriers
constexpr int kRowsThreads = 256;          // quant_rows_kernel

// -- PTX helpers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The thread's earlier cp.async copies arrive on `bar` when they land; the
// arrival is counted in the barrier's initial count (.noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* s, const void* g,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s)),
      "l"(g), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- one code ------------------------------------------------------------------

// (x - lo) * inv rounded (SR: up with probability frac, from the counter
// hash of gidx; else to nearest, half to even), at most bins. normed >= 0
// (x - lo >= 0), so only the top needs a clamp; the conversion saturates
// below at 0 all the same.
template <int BITS, bool SR>
__device__ __forceinline__ uint32_t code_of(float x, float2 li,
                                            uint32_t gidx, uint32_t seed) {
  constexpr float kBins = static_cast<float>((1 << BITS) - 1);
  const float normed = __fmul_rn(__fsub_rn(x, li.x), li.y);
  float code;
  if (SR) {
    const float fl = floorf(normed);
    code = fl + (hash_uniform(gidx, seed) < __fsub_rn(normed, fl) ? 1.0f
                                                                  : 0.0f);
  } else {
    code = rintf(normed);
  }
  return __float2uint_rz(fminf(code, kBins));
}

// -- input elements -----------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {    // bf16: exact
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// four consecutive elements from an aligned address (16 bytes of fp32, 8
// of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// a tile's misaligned head or tail, elements [i0, i1)
__device__ __forceinline__ void copy_edge(float* s, const float* g, int i0,
                                          int i1) {
  for (int i = i0; i < i1; ++i) cp_async4(s + i, g + i);
}
__device__ __forceinline__ void copy_edge(uint16_t* s, const uint16_t* g,
                                          int i0, int i1) {
  for (int i = i0; i < i1; ++i) s[i] = g[i];
}

// -- the tile route ------------------------------------------------------------

struct TileArgs {
  const void* x;              // float or uint16_t (bf16) elements
  uint8_t* packed;
  float* scale;
  float* zero;
  int rows, d, dp;
  uint32_t seed;
  int T;        // rows a tile
  int sf;       // elements a stage buffer (>= T*d + 8 + 2*(v-1), a
                //  multiple of v = the elements in 16 bytes)
  int pb;       // bytes of the packed staging buffer (a multiple of 16)
  int tiles;
  int G;        // lanes a row in the min/max
};

// Tile k of this block: its first row, its rows, and the element offset
// of its span from 16-byte alignment.
struct TilePos {
  int64_t row0;
  int nrows, mis;
};

template <typename E>
__device__ __forceinline__ TilePos tile_pos(const TileArgs& a, int k) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  TilePos t;
  t.row0 = static_cast<int64_t>(blockIdx.x + k * gridDim.x) * a.T;
  t.nrows = static_cast<int>(a.rows - t.row0 < a.T ? a.rows - t.row0 : a.T);
  t.mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(static_cast<const E*>(a.x) +
                                   t.row0 * a.d) /
       sizeof(E)) &
      (kVec - 1));
  return t;
}

// Thread 0 starts the copy of the block's tile k into stage buffer `buf`:
// element i of the tile lands at buf[mis + i], so the 16-byte aligned
// interior is one bulk copy; the misaligned head and tail (at most 3
// floats or 7 bf16 each) go by copy_edge, tracked by the same barrier.
template <typename E>
__device__ __forceinline__ void issue_tile(const TileArgs& a, int k, E* buf,
                                           uint64_t* bar) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  const TilePos t = tile_pos<E>(a, k);
  const int n = t.nrows * a.d;
  const E* g = static_cast<const E*>(a.x) + t.row0 * a.d;
  E* s = buf + t.mis;
  const int head = min((kVec - t.mis) & (kVec - 1), n);
  const int n_int = (n - head) & ~(kVec - 1);
  copy_edge(s, g, 0, head);
  copy_edge(s, g, head + n_int, n);
  if (n_int > 0) {
    const uint32_t bytes = static_cast<uint32_t>(n_int) * sizeof(E);
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy(s + head, g + head, bytes, bar);
  } else {
    mbar_arrive(bar);
  }
  cp_async_arrive_noinc(bar);
}

// Per-row min/max of a staged tile: groups of G lanes a row over the whole
// block (G from the plan spreads the block's threads over the tile's rows,
// so most tiles take one pass), reads of four elements where the rows sit
// on their size in shared memory (d % 4 == 0 and a tile offset by a
// multiple of 4 elements), else one element a lane. Each group's first
// lane writes its row's (lo, inv) to shared memory and scale, zero to
// device memory.
template <int BITS, typename E>
__device__ __forceinline__ void minmax_pass(const TileArgs& a, const E* xs,
                                            bool vec4,
                                            const TilePos& t,
                                            float2* lo_inv) {
  constexpr float kBins = static_cast<float>((1 << BITS) - 1);
  constexpr float kRecip = 1.0f / kBins;     // fl(1 / bins), as XLA's R / B
  const int d = a.d, G = a.G;
  const int gl = threadIdx.x & (G - 1);
  for (int rb = 0; rb < t.nrows; rb += kThreads / G) {
    const int r = rb + static_cast<int>(threadIdx.x) / G;
    float lo = INFINITY, hi = -INFINITY;
    if (r < t.nrows) {
      const E* xr = xs + r * d;
      if (vec4) {
#pragma unroll 4
        for (int c = gl; c < (d >> 2); c += G) {
          const float4 v = load4(xr + 4 * c);
          lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
          hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
        }
      } else {
#pragma unroll 4
        for (int c = gl; c < d; c += G) {
          const float v = to_f(xr[c]);
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off, G));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off, G));
    }
    if (gl == 0 && r < t.nrows) {
      const float rng = __fsub_rn(hi, lo);
      lo_inv[r] = make_float2(lo, __fdiv_rn(kBins, fmaxf(rng, 1e-12f)));
      a.scale[t.row0 + r] = __fmul_rn(rng, kRecip);
      a.zero[t.row0 + r] = lo;
    }
  }
}

// A thread's walk over a tile's packed words tid, tid + kThreads, ...: (r,
// j) of its first word's first byte, and the step of kThreads words, so
// no division by d or dp runs per word.
struct Walk {
  int r_first, j_first, r_step, j_step;
};

__device__ __forceinline__ void walk_on(const Walk& wk, int dp, int& r,
                                        int& j) {
  j += wk.j_step;
  r += wk.r_step;
  if (j >= dp) {
    j -= dp;
    ++r;
  }
}

// The codes where every packed row is whole words (d a multiple of 4*cpb:
// dp % 4 == 0, no pads) on an aligned tile: word w is bytes j..j+3 of one
// row, its codes cpb reads of four elements under one (lo, inv), and it
// goes straight to device memory (the words of a warp: 128 contiguous
// bytes).
template <int BITS, bool SR, typename E>
__device__ __forceinline__ void codes_rowwords(const TileArgs& a,
                                               const E* xs,
                                               const float2* lo_inv,
                                               int nrows, uint32_t gbase,
                                               const Walk& wk,
                                               uint32_t* out) {
  constexpr int kCpb = 8 / BITS;
  const int d = a.d, dp = a.dp;
  int r = wk.r_first, j = wk.j_first;
  for (int w = threadIdx.x; r < nrows; w += kThreads) {
    const float2 li = lo_inv[r];
    const int idx = r * d + j;
    uint32_t word = 0;
#pragma unroll
    for (int kk = 0; kk < kCpb; ++kk) {
      const float4 v = load4(xs + idx + kk * dp);
      const uint32_t g = gbase + static_cast<uint32_t>(idx + kk * dp);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        word += code_of<BITS, SR>(e[q], li, g + q, a.seed)
                << (8 * q + kk * BITS);
    }
    out[w] = word;
    walk_on(wk, dp, r, j);
  }
}

// The codes of any staged tile, flat over its packed bytes, into the
// staging words pw: staging byte b holds the tile's packed byte b - h (h:
// the span's offset from 16-byte alignment). (r, j): the (row, byte in
// row) of the thread's current word's first byte. A word's bytes may lie
// in two rows (SMALL: dp < 4, more); they are visited in an order rotated
// by lane / 8, so a warp's reads of one step fall in 32 banks. PAD: d is
// not a multiple of cpb, so some codes are pads (0).
template <int BITS, bool SR, bool PAD, bool SMALL, typename E>
__device__ __forceinline__ void codes_flat(const TileArgs& a, const E* xs,
                                           const float2* lo_inv, int nrows,
                                           uint32_t gbase, int r, int j,
                                           const Walk& wk, uint32_t* pw) {
  constexpr int kCpb = 8 / BITS;
  const int d = a.d, dp = a.dp;
  const int rot = (threadIdx.x >> 3) & 3;
  int kdp[kCpb];
#pragma unroll
  for (int k = 0; k < kCpb; ++k) kdp[k] = k * dp;
  for (int w = threadIdx.x; r < nrows; w += kThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = (i + rot) & 3;
      int js = j + q, rs = r;
      if (SMALL) {
        while (js >= dp) {
          js -= dp;
          ++rs;
        }
      } else if (js >= dp) {
        js -= dp;
        ++rs;
      }
      const bool ok = static_cast<unsigned>(rs) < static_cast<unsigned>(nrows);
      const int rc = ok ? rs : 0;
      const float2 li = lo_inv[rc];
      const int idx = rc * d + js;
      uint32_t byte = 0;
#pragma unroll
      for (int kk = 0; kk < kCpb; ++kk) {
        // a pad code reads a neighbour's element (inside the buffer: sf's
        // slack) and is masked
        uint32_t c = code_of<BITS, SR>(
            to_f(xs[idx + kdp[kk]]), li,
            gbase + static_cast<uint32_t>(idx + kdp[kk]), a.seed);
        if (PAD && kdp[kk] + js >= d) c = 0;
        byte += c << (kk * BITS);
      }
      word += ok ? byte << (8 * q) : 0u;
    }
    pw[w] = word;
    walk_on(wk, dp, r, j);
  }
}

// The staged packed tile (bytes [h, nb) of pst) leaves as 16-byte chunks
// of the aligned span gdst; a partial first or last chunk byte by byte.
__device__ __forceinline__ void store_tile(const unsigned char* pst,
                                           uint8_t* gdst, int h, int nb) {
  for (int c = threadIdx.x; c * 16 < nb; c += kThreads) {
    const int b0 = c * 16;
    if (b0 >= h && b0 + 16 <= nb) {
      *reinterpret_cast<uint4*>(gdst + b0) =
          *reinterpret_cast<const uint4*>(pst + b0);
    } else {
      const int e = min(b0 + 16, nb);
      for (int q = max(b0, h); q < e; ++q) gdst[q] = pst[q];
    }
  }
}

// A persistent block walks tiles k = 0, 1, ... (tile blockIdx + k*grid)
// through the ring: min/max, barrier, codes, barrier, (store the staged
// words, barrier,) refill the buffer with tile k + kStages.
template <int BITS, bool SR, typename E>
__global__ void __launch_bounds__(kThreads)
    quant_tile_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  E* stage0 = reinterpret_cast<E*>(smem + kBarBytes);
  unsigned char* pst = smem + kBarBytes + kStages * a.sf * sizeof(E);
  float2* lo_inv = reinterpret_cast<float2*>(pst + a.pb);

  const int tid = threadIdx.x;
  const int d = a.d, dp = a.dp;
  const int bx = static_cast<int>(blockIdx.x);
  const int n_mine = bx < a.tiles ? (a.tiles - 1 - bx) / gridDim.x + 1 : 0;
  if (tid == 0) {
    // two arrivals a phase: thread 0's (with the bulk bytes expected) and
    // its cp.async head/tail copies' (.noinc)
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kStages && k < n_mine; ++k)
      issue_tile(a, k, stage0 + k * a.sf, &bars[k]);
  }
  __syncthreads();

  Walk wk;
  wk.r_first = (4 * tid) / dp;
  wk.j_first = 4 * tid - wk.r_first * dp;
  wk.r_step = (4 * kThreads) / dp;
  wk.j_step = 4 * kThreads - wk.r_step * dp;
  const bool pad = d % (8 / BITS) != 0, small = dp < 4;
  const bool rowwords = d % (32 / BITS) == 0;

  for (int k = 0; k < n_mine; ++k) {
    const int s = k % kStages;
    const TilePos t = tile_pos<E>(a, k);
    const E* xs = stage0 + s * a.sf + t.mis;
    const bool vec4 = (t.mis & 3) == 0;     // fp32: an aligned tile
    mbar_wait(&bars[s], static_cast<uint32_t>((k / kStages) & 1));
    minmax_pass<BITS>(a, xs, (d & 3) == 0 && vec4, t, lo_inv);
    __syncthreads();

    const int64_t p0 = t.row0 * dp;
    const int h = static_cast<int>(
        reinterpret_cast<uintptr_t>(a.packed + p0) & 15);
    const uint32_t gbase = static_cast<uint32_t>(t.row0) *
                           static_cast<uint32_t>(d);
    uint32_t* pw = reinterpret_cast<uint32_t*>(pst);
    const bool direct = rowwords && h == 0 && vec4;
    if (direct) {
      codes_rowwords<BITS, SR>(a, xs, lo_inv, t.nrows, gbase, wk,
                               reinterpret_cast<uint32_t*>(a.packed + p0));
    } else {
      int r = wk.r_first, j = wk.j_first;
      if (h != 0) {               // floor division of 4*tid - h (>= -15)
        const int b = 4 * tid - h + 16 * dp;
        r = b / dp;
        j = b - r * dp;
        r -= 16;
      }
      if (small) {
        if (pad) codes_flat<BITS, SR, true, true>(a, xs, lo_inv, t.nrows, gbase, r, j, wk, pw);
        else codes_flat<BITS, SR, false, true>(a, xs, lo_inv, t.nrows, gbase, r, j, wk, pw);
      } else {
        if (pad) codes_flat<BITS, SR, true, false>(a, xs, lo_inv, t.nrows, gbase, r, j, wk, pw);
        else codes_flat<BITS, SR, false, false>(a, xs, lo_inv, t.nrows, gbase, r, j, wk, pw);
      }
    }
    __syncthreads();
    if (!direct) {
      store_tile(pst, a.packed + p0 - h, h, h + t.nrows * dp);
      __syncthreads();
    }
    if (tid == 0 && k + kStages < n_mine) {   // stage s is free
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_tile(a, k + kStages, stage0 + s * a.sf, &bars[s]);
    }
  }
}

// -- a warp a row: small tables and rows wider than two stage buffers ---------

// Each warp takes rows row, row + warps, ...: lanes stride the row for the
// min/max (reduced with shuffles), then build whole packed bytes: byte j
// gathers codes j, dp+j, 2*dp+j, ... The row is read twice, the second
// time from L1/L2. Its chain of dependent steps is the shortest, which is
// what a table of a few thousand rows waits on.
template <int BITS, bool SR, typename E>
__global__ void __launch_bounds__(kRowsThreads)
    quant_rows_kernel(const void* __restrict__ xv, int rows, int d,
                      uint32_t seed, uint8_t* __restrict__ packed,
                      float* __restrict__ scale, float* __restrict__ zero) {
  const E* __restrict__ x = static_cast<const E*>(xv);
  constexpr int kCpb = 8 / BITS;
  constexpr float kBins = static_cast<float>((1 << BITS) - 1);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kRowsThreads / 32);
  const int dp = (d + kCpb - 1) / kCpb;
  for (int row = blockIdx.x * (kRowsThreads / 32) + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const E* xr = x + static_cast<int64_t>(row) * d;
    float lo = INFINITY, hi = -INFINITY;
    for (int c = lane; c < d; c += 32) {
      const float v = to_f(xr[c]);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const float rng = __fsub_rn(hi, lo);
    const float2 li = make_float2(lo, __fdiv_rn(kBins, fmaxf(rng, 1e-12f)));
    const uint32_t gbase = static_cast<uint32_t>(row) *
                           static_cast<uint32_t>(d);
    for (int j = lane; j < dp; j += 32) {
      uint32_t byte = 0;
#pragma unroll
      for (int k = 0; k < kCpb; ++k) {
        const int col = k * dp + j;
        if (col < d)
          byte |= code_of<BITS, SR>(to_f(xr[col]), li,
                                    gbase + static_cast<uint32_t>(col), seed)
                  << (k * BITS);
      }
      packed[static_cast<int64_t>(row) * dp + j] = static_cast<uint8_t>(byte);
    }
    if (lane == 0) {
      scale[row] = __fmul_rn(rng, 1.0f / kBins);
      zero[row] = lo;
    }
  }
}

// -- the plan ------------------------------------------------------------------

struct Plan {
  int route;      // 0: tiles (quant_tile_kernel), 1: quant_rows_kernel
  int T, sf, pb, smem, tiles, G;
};

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

int device_attr(cudaDeviceAttr attr) {
  static int cached[2][16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int* c = &cached[attr == cudaDevAttrMultiProcessorCount][dev & 15];
  if (*c <= 0) cudaDeviceGetAttribute(c, attr, dev);
  return *c;
}

int sm_count() { return device_attr(cudaDevAttrMultiProcessorCount); }

// esize: bytes an input element (4 fp32, 2 bf16)
Plan make_plan(int rows, int d, int bits, int esize) {
  Plan p{};
  p.route = 1;
  // a small table: a warp a row has the shortest chain of steps (a narrow
  // row, under 32 floats, would idle most of a warp)
  const long long elems = static_cast<long long>(rows) * d;
  if (elems <= kSmallElems || (elems <= 4LL * kSmallElems && d >= 32))
    return p;
  const int cpb = 8 / bits;
  const int dp = (d + cpb - 1) / cpb;
  const int vec = 16 / esize;                // elements in 16 bytes
  const int q_load = vec / gcd(d, vec);      // T*d % vec == 0
  const int q_store = 16 / gcd(dp, 16);      // T*dp % 16 == 0
  const int q = q_load * q_store / gcd(q_load, q_store);
  // T: a multiple of m whose stage holds at most 2 * kStageFloats floats;
  // of those whose stage holds at least half kStageFloats, the one whose
  // packed words fill the block's threads best (1.2 words a thread would
  // idle most of a second round), then the one nearest kStageFloats
  auto pick = [&](int m) {
    int best = 0;
    double best_score = -1.0;
    for (int t = m; t * d <= 2 * kStageFloats; t += m) {
      const int words = (t * dp + 3) / 4;
      const int rounds = (words + kThreads - 1) / kThreads;
      const double score = (2 * t * d >= kStageFloats ? 1.0 : 0.0) +
                           static_cast<double>(words) / (rounds * kThreads);
      if (score > best_score + 1e-9 ||
          (score > best_score - 1e-9 &&
           std::abs(t * d - kStageFloats) < std::abs(best * d - kStageFloats))) {
        best = t;
        best_score = score;
      }
    }
    return best;
  };
  int T = pick(q);
  if (T == 0) T = pick(q_load);
  if (T == 0) T = kStageFloats / d > 1 ? kStageFloats / d : 1;
  // a small table: tiles of fewer rows, so that every SM gets two
  const int spread = (rows + 2 * sm_count() - 1) / (2 * sm_count());
  if (spread < T) {
    const int m = spread >= q ? q : spread >= q_load ? q_load : 1;
    T = (spread + m - 1) / m * m;
  }
  if (T > rows) T = rows;                    // one tile: no alignment needed
  p.T = T;
  // + 8: a pad code's read past the last row stays inside the buffer
  p.sf = (T * d + (vec - 1) + 8 + (vec - 1)) & ~(vec - 1);
  p.pb = (15 + T * dp + 15) & ~15;
  p.tiles = (rows + T - 1) / T;
  // lanes a row in the min/max: the block's threads over the tile's rows,
  // at most one lane a float4 (a float where d % 4 != 0)
  const int reads = d % 4 == 0 ? d / 4 : d;
  p.G = 32;
  while (p.G > 1 && (p.G * T > kThreads || p.G > reads)) p.G >>= 1;
  // the ring, the packed staging, (lo, inv) of T rows; where a ring of
  // one-row tiles does not fit, a warp a row
  const long long smem =
      kBarBytes + 1LL * esize * kStages * p.sf + p.pb + 8LL * T;
  if (smem <= device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin)) {
    p.route = 0;
    p.smem = static_cast<int>(smem);
  }
  return p;
}

struct Occ {
  const void* fn;
  int smem;
  int per_sm;
};

// blocks an SM for `kernel` at `smem` bytes, read once per pair
template <typename K>
int blocks_per_sm(K kernel, int smem) {
  static Occ cache[64];
  static int n = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n; ++i)
    if (cache[i].fn == fn && cache[i].smem == smem) return cache[i].per_sm;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  if (per_sm < 1) per_sm = 1;
  if (n < 64) cache[n++] = Occ{fn, smem, per_sm};
  return per_sm;
}

// the kernels for (bits, stochastic, element)
using TileKernel = void (*)(TileArgs);
using RowsKernel = void (*)(const void*, int, int, uint32_t, uint8_t*,
                            float*, float*);

template <typename E>
TileKernel tile_kernel_of(int bits, bool sr) {
  switch (bits * 2 + (sr ? 1 : 0)) {
    case 2: return quant_tile_kernel<1, false, E>;
    case 3: return quant_tile_kernel<1, true, E>;
    case 4: return quant_tile_kernel<2, false, E>;
    case 5: return quant_tile_kernel<2, true, E>;
    case 8: return quant_tile_kernel<4, false, E>;
    case 9: return quant_tile_kernel<4, true, E>;
    case 16: return quant_tile_kernel<8, false, E>;
    default: return quant_tile_kernel<8, true, E>;
  }
}

template <typename E>
RowsKernel rows_kernel_of(int bits, bool sr) {
  switch (bits * 2 + (sr ? 1 : 0)) {
    case 2: return quant_rows_kernel<1, false, E>;
    case 3: return quant_rows_kernel<1, true, E>;
    case 4: return quant_rows_kernel<2, false, E>;
    case 5: return quant_rows_kernel<2, true, E>;
    case 8: return quant_rows_kernel<4, false, E>;
    case 9: return quant_rows_kernel<4, true, E>;
    case 16: return quant_rows_kernel<8, false, E>;
    default: return quant_rows_kernel<8, true, E>;
  }
}

TileKernel tile_kernel(int bits, bool sr, bool bf16) {
  return bf16 ? tile_kernel_of<uint16_t>(bits, sr)
              : tile_kernel_of<float>(bits, sr);
}

RowsKernel rows_kernel(int bits, bool sr, bool bf16) {
  return bf16 ? rows_kernel_of<uint16_t>(bits, sr)
              : rows_kernel_of<float>(bits, sr);
}

int grid_of(const Plan& p, int rows, int bits, bool sr, bool bf16) {
  if (p.route == 0) {
    const int cap =
        blocks_per_sm(tile_kernel(bits, sr, bf16), p.smem) * sm_count();
    return p.tiles < cap ? p.tiles : cap;
  }
  const int rows_a_block = kRowsThreads / 32;
  const int blocks = (rows + rows_a_block - 1) / rows_a_block;
  const int cap = 8 * sm_count();
  return blocks < cap ? blocks : cap;
}

int launch(const void* x, bool bf16, int rows, int d, int bits,
           int stochastic, unsigned int seed, void* packed, void* scale,
           void* zero, void* stream) {
  if (rows > 0 && d > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool sr = stochastic != 0;
    const Plan p = make_plan(rows, d, bits, bf16 ? 2 : 4);
    const int grid = grid_of(p, rows, bits, sr, bf16);
    if (p.route == 0) {
      const int cpb = 8 / bits;
      const TileArgs a{x,
                       static_cast<uint8_t*>(packed),
                       static_cast<float*>(scale),
                       static_cast<float*>(zero),
                       rows, d, (d + cpb - 1) / cpb, seed, p.T, p.sf, p.pb,
                       p.tiles, p.G};
      tile_kernel(bits, sr, bf16)<<<grid, kThreads, p.smem, st>>>(a);
    } else {
      rows_kernel(bits, sr, bf16)<<<grid, kRowsThreads, 0, st>>>(
          x, rows, d, seed, static_cast<uint8_t*>(packed),
          static_cast<float*>(scale), static_cast<float*>(zero));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, d) fp32
extern "C" int quant_pack_launch(const void* x, int rows, int d, int bits,
                                 int stochastic, unsigned int seed,
                                 void* packed, void* scale, void* zero,
                                 void* stream) {
  return launch(x, false, rows, d, bits, stochastic, seed, packed, scale,
                zero, stream);
}

// x: (rows, d) bf16, read as 16-bit words
extern "C" int quant_pack_launch_bf16(const void* x, int rows, int d,
                                      int bits, int stochastic,
                                      unsigned int seed, void* packed,
                                      void* scale, void* zero, void* stream) {
  return launch(x, true, rows, d, bits, stochastic, seed, packed, scale,
                zero, stream);
}

// The plan the launch follows for (rows, d, bits) from fp32 (x_bf16 0) or
// bf16 (1): out[0..6] = route (0 tiles, 1 a warp a row), rows a tile,
// stage buffers, elements a buffer, dynamic shared memory, tiles, lanes a
// row in the min/max; out[7] the grid the launch takes.
extern "C" int quant_pack_plan(int rows, int d, int bits, int stochastic,
                               int x_bf16, int* out) {
  rows = rows > 0 ? rows : 1;
  d = d > 0 ? d : 1;
  const bool bf16 = x_bf16 != 0;
  const Plan p = make_plan(rows, d, bits, bf16 ? 2 : 4);
  const int fields[8] = {p.route, p.T,     p.route == 0 ? kStages : 0,
                         p.sf,    p.smem,  p.tiles, p.G,
                         grid_of(p, rows, bits, stochastic != 0, bf16)};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return static_cast<int>(cudaGetLastError());
}
