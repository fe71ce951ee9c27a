// Fused dequantize + transposed GEMM for the ACT weight gradient:
// dW = x_hat^T @ g, x_hat = code * scale + zero from the packed b-bit
// residual, x_hat never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/dequant_matmul.py:_dqmm_kernel.
//
// Bound on the H100: bytes. The function reads R * ceil(dim*b/8) packed
// bytes, 8 bytes of scale/zero a row and the (R, N) fp32 g once, and writes
// the (dim, N) output once: at R 184,166, dim = N = 64 that is 51.6 MB,
// 0.0154 ms at 3.35 TB/s. Its products run on the tensor cores (below): 3 x
// 2 * R * dim * N = 4.5 G operations, 0.0046 ms at the 989 TFLOP/s bf16 rate.
//
// Arithmetic: exact products on the bf16 tensor cores. With
// x_hat[r,f] = c[r,f] * s_r + z_r and a centre c0 = (2^b - 1) / 2,
//
//   dW[f,:] = sum_r (c[r,f] - c0) * h_r + sum_r z'_r * g_r,
//   h_r = s_r * g_r (one rounding),  z'_r = fma(c0, s_r, z_r).
//
// c - c0 is a half-integer in [-127.5, 127.5]: 8 significant bits, exact in
// bf16. Each h is split into three bf16 parts h = h1 + h2 + h3 (h1 =
// bf16_rn(h), h2 = bf16_rn(h - h1), h3 = bf16_rn(h - h1 - h2); every
// remainder is exact in fp32, and the three parts sum to h exactly), so
// every product (c - c0) * h_i is exact and only the fp32 sums round: three
// mma.sync.m16n8k16 bf16 products with fp32 accumulators, A the centred
// codes, B the parts of h. The centre keeps the two sums from cancelling:
// for rows centred on 0, z' is near 0; for rows offset far from 0, the code
// term is small. The zero term is an fp32 SIMT column sum beside the
// products. The tensor cores' fp32 accumulation may truncate, so a CTA
// sums each 64-row stage into fresh accumulators (12 products a chain) and
// adds those to its running sums with rounded fp32 adds. Features >= dim of
// a padded pack, and rows past R, contribute 0.
//
// Data flow. A persistent grid: at most 264 CTAs (two on each of 132 SMs)
// of 256 threads, CTA (chunk, f-tile, n-tile) over a contiguous range of
// rows and one 64 x 64 output tile. A ring of 4 stages of 64 rows in shared
// memory is filled by cp.async (16-byte copies where the rows are aligned;
// packed bytes are loaded one by one where they are not; the ragged edge
// zero-filled). One barrier a stage: after it, the threads issue the copies of
// stage t + 3, unpack the codes of stage t + 1 once into the A fragments'
// register order (bf16, 8 KB, double-buffered), and run the products of
// stage t. Warp w takes columns [8w, 8w + 8): it reads its g values
// straight from the stage in B fragment order (rows padded to 68 floats: no
// bank conflicts), forms h and its three parts in registers, adds z' * g to
// its column sums, and issues 4 x 3 mma.sync a 16-row step. Each h is
// formed by one warp, each code unpacked once per CTA.
//
// Determinism. Each CTA writes its partial tile (products plus zero term)
// to scratch; a second kernel sums the <= 264 partials of every output in
// a fixed order (16 warps over contiguous chunk ranges, then the 16 sums in
// warp order). No atomics: two runs give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;      // rows a stage
constexpr int kTile = 64;      // output tile edge (features x columns)
constexpr int kWarps = 8;      // warp w: columns [8w, 8w + 8) of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;     // ring depth
constexpr int kMaxCtas = 264;  // two CTAs on each of the H100's 132 SMs
constexpr int kGStride = 68;   // floats a staged g row (64 + 4: no conflicts)
constexpr int kPStride = 80;   // bytes a staged packed row (<= 64 used)
constexpr int kKSteps = kRows / 16;

// One ring stage: g rows, scale, zero, packed window.
constexpr int kGBytes = kRows * kGStride * 4;
constexpr int kSBytes = kRows * 4;
constexpr int kPBytes = kRows * kPStride;
constexpr int kStageBytes = kGBytes + 2 * kSBytes + kPBytes;
// A fragments of one stage: kKSteps x 4 m-tiles x 32 lanes x 4 registers.
constexpr int kABytes = kKSteps * 4 * 32 * 16;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kABytes;

constexpr int kReduceWarps = 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats to a bf16x2 register, round to nearest: lo in bits 0-15.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}

__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// h = p1 + p2 + p3 exactly, for the pair (x: lo, y: hi).
__device__ __forceinline__ void split3(float x, float y, uint32_t* p) {
  p[0] = pack_bf16x2(x, y);
  const float rx = __fsub_rn(x, lo_f(p[0]));
  const float ry = __fsub_rn(y, hi_f(p[0]));
  p[1] = pack_bf16x2(rx, ry);
  p[2] = pack_bf16x2(__fsub_rn(rx, lo_f(p[1])), __fsub_rn(ry, hi_f(p[1])));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const uint8_t* packed;
  const float* scale;
  const float* zero;
  const float* g;
  float* partial;
  int rows, dp, bits, dim, n, rows_per_cta;
  int g_vec;    // 1: 16-byte g copies (g 16-byte aligned, n % 4 == 0)
  int p_vec;    // 1: 16-byte packed copies, 0: byte loads
};

// Issue the copies of the stage holding rows [r0, r0 + kRows) of the CTA's
// range (rows >= r_end zero-filled) into ring buffer `buf`.
__device__ __forceinline__ void issue_stage(const Args& a, uint8_t* buf,
                                            int r0, int r_end, int n0,
                                            int b0, int pw) {
  float* gs = reinterpret_cast<float*>(buf);
  float* ss = reinterpret_cast<float*>(buf + kGBytes);
  float* zs = reinterpret_cast<float*>(buf + kGBytes + kSBytes);
  uint8_t* ps = buf + kGBytes + 2 * kSBytes;
  const int tid = threadIdx.x;
  if (a.g_vec) {
    for (int u = tid; u < kRows * (kTile / 4); u += kThreads) {
      const int row = u >> 4;
      const int col = n0 + (u & 15) * 4;
      const int r = r0 + row;
      const bool ok = r < r_end && col < a.n;
      cp_async16(gs + row * kGStride + (u & 15) * 4,
                 ok ? a.g + static_cast<size_t>(r) * a.n + col : a.g, ok);
    }
  } else {
    for (int u = tid; u < kRows * kTile; u += kThreads) {
      const int row = u >> 6;
      const int col = n0 + (u & 63);
      const int r = r0 + row;
      const bool ok = r < r_end && col < a.n;
      cp_async4(gs + row * kGStride + (u & 63),
                ok ? a.g + static_cast<size_t>(r) * a.n + col : a.g, ok);
    }
  }
  if (tid < 2 * kRows) {
    const int row = tid & (kRows - 1);
    const int r = r0 + row;
    const bool ok = r < r_end;
    if (tid < kRows)
      cp_async4(ss + row, ok ? a.scale + r : a.scale, ok);
    else
      cp_async4(zs + row, ok ? a.zero + r : a.zero, ok);
  }
  if (a.p_vec) {
    const int per_row = pw / 16;
    for (int u = tid; u < kRows * per_row; u += kThreads) {
      const int row = u / per_row;
      const int off = (u - row * per_row) * 16;
      const int r = r0 + row;
      const bool ok = r < r_end;
      cp_async16(ps + row * kPStride + off,
                 ok ? a.packed + static_cast<size_t>(r) * a.dp + b0 + off
                    : a.packed,
                 ok);
    }
  } else {
    // any alignment, and a window that wraps past dp: byte by byte
    for (int u = tid; u < kRows * pw; u += kThreads) {
      const int row = u / pw;
      const int j = u - row * pw;
      const int r = r0 + row;
      int byte = b0 + j;
      if (byte >= a.dp) byte -= a.dp;
      ps[row * kPStride + j] =
          r < r_end ? a.packed[static_cast<size_t>(r) * a.dp + byte] : 0;
    }
  }
}

// Unpack the stage's codes into A fragments: fragment (k-step ks, m-tile
// mt, lane) holds the centred codes of rows ks*16 + 2tq + {0, 1, 8, 9} at
// the thread's two features (rows gq and gq + 8 of m-tile mt).
__device__ __forceinline__ void unpack_stage(const uint8_t* ps, uint4* afrag,
                                             const int* slot,
                                             const int* shift,
                                             const bool* fvalid,
                                             unsigned cmask, float c0) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int mt = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int i = 0; i < kKSteps / 2; ++i) {
    const int ks = (threadIdx.x >> 7) + 2 * i;
    float v[2][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = ks * 16 + 2 * tq + (k & 1) + 8 * (k >> 1);
        const unsigned code =
            (static_cast<unsigned>(ps[row * kPStride + slot[f]]) >>
             shift[f]) & cmask;
        v[f][k] = fvalid[f] ? static_cast<float>(code) - c0 : 0.0f;
      }
    uint4 fr;
    fr.x = pack_bf16x2(v[0][0], v[0][1]);  // row gq, k 2tq, 2tq+1
    fr.y = pack_bf16x2(v[1][0], v[1][1]);  // row gq+8
    fr.z = pack_bf16x2(v[0][2], v[0][3]);  // row gq, k 2tq+8, 2tq+9
    fr.w = pack_bf16x2(v[1][2], v[1][3]);  // row gq+8
    afrag[(ks * 4 + mt) * 32 + lane] = fr;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
dqmm_mma_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* afrags = reinterpret_cast<uint4*>(smem + kStages * kStageBytes);
  const int chunk = blockIdx.x;
  const int f0 = blockIdx.y * kTile;
  const int n0 = blockIdx.z * kTile;
  const int r_begin = chunk * a.rows_per_cta;
  const int r_end = min(a.rows, r_begin + a.rows_per_cta);
  const int n_stages = (r_end - r_begin + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in group

  // the packed window of this f-tile: bytes (b0 + j) % dp, j < pw
  const int b0 = a.dp > kTile ? f0 % a.dp : 0;
  const int pw = a.dp > kTile ? kTile : a.dp;
  const unsigned cmask = (1u << a.bits) - 1u;
  const float c0 = 0.5f * static_cast<float>(cmask);

  // the two features whose codes this thread unpacks (m-tile warp % 4)
  int slot[2], shift[2];
  bool fvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + (warp & 3) * 16 + gq + 8 * i;
    fvalid[i] = f < a.dim;
    shift[i] = (f / a.dp) * a.bits;
    int s = f % a.dp - b0;
    if (s < 0) s += a.dp;
    slot[i] = s;
  }

  float acc[4][4];   // [m-tile][fragment register], n-tile `warp`
  float zacc = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages)
      issue_stage(a, smem + t * kStageBytes, r_begin + t * kRows, r_end, n0,
                  b0, pw);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  unpack_stage(smem + kGBytes + 2 * kSBytes, afrags, slot, shift, fvalid,
               cmask, c0);

  for (int t = 0; t < n_stages; ++t) {
    // stage t + 1 landed, stage t unpacked; every warp is done with stage
    // t - 1 (its ring buffer and A buffer are free)
    cp_async_wait<kStages - 3>();
    __syncthreads();
    {
      const int tn = t + kStages - 1;
      if (tn < n_stages)
        issue_stage(a, smem + (tn % kStages) * kStageBytes,
                    r_begin + tn * kRows, r_end, n0, b0, pw);
      cp_async_commit();
    }
    if (t + 1 < n_stages)
      unpack_stage(smem + ((t + 1) % kStages) * kStageBytes + kGBytes +
                       2 * kSBytes,
                   afrags + ((t + 1) & 1) * (kABytes / 16), slot, shift,
                   fvalid, cmask, c0);
    const uint8_t* buf = smem + (t % kStages) * kStageBytes;
    const float* gs = reinterpret_cast<const float*>(buf);
    const float* ss = reinterpret_cast<const float*>(buf + kGBytes);
    const float* zs = reinterpret_cast<const float*>(buf + kGBytes + kSBytes);
    const uint4* afrag = afrags + (t & 1) * (kABytes / 16);

    float tmp[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[mt][e] = 0.0f;

#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      float h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = ks * 16 + 2 * tq + (k & 1) + 8 * (k >> 1);
        const float s = ss[row];
        const float gv = gs[row * kGStride + warp * 8 + gq];
        h[k] = __fmul_rn(s, gv);
        zacc = __fmaf_rn(__fmaf_rn(c0, s, zs[row]), gv, zacc);
      }
      uint32_t b0p[3], b1p[3];
      split3(h[0], h[1], b0p);   // rows 2tq, 2tq+1
      split3(h[2], h[3], b1p);   // rows 2tq+8, 2tq+9
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint4 fr = afrag[(ks * 4 + mt) * 32 + lane];
        const uint32_t af[4] = {fr.x, fr.y, fr.z, fr.w};
#pragma unroll
        for (int p = 0; p < 3; ++p) mma_bf16(tmp[mt], af, b0p[p], b1p[p]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][e] = __fadd_rn(acc[mt][e], tmp[mt][e]);
  }
  cp_async_wait<0>();

  // zero term: lane (gq, tq) holds column gq over its rows; sum the four
  // tq lanes (every lane of the group gets the same bits), then fetch the
  // columns 2tq, 2tq+1 of this lane's accumulator registers
  float zsum = __fadd_rn(zacc, __shfl_xor_sync(0xffffffffu, zacc, 1));
  zsum = __fadd_rn(zsum, __shfl_xor_sync(0xffffffffu, zsum, 2));
  const float z_lo = __shfl_sync(0xffffffffu, zsum, (2 * tq) * 4);
  const float z_hi = __shfl_sync(0xffffffffu, zsum, (2 * tq + 1) * 4);
  float* out = a.partial + static_cast<size_t>(chunk) * a.dim * a.n;
  const int col = n0 + warp * 8 + 2 * tq;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + mt * 16 + gq + 8 * (e >> 1);
      const int c = col + (e & 1);
      if (f < a.dim && c < a.n)
        out[static_cast<size_t>(f) * a.n + c] =
            __fadd_rn(acc[mt][e], (e & 1) ? z_hi : z_lo);
    }
}

// out[e] = sum over chunks of partial[chunk][e], in a fixed order: warp w
// sums its contiguous range of chunks in order (8 loads in flight), then
// the warp sums are added in warp order. 32 outputs a CTA (lane = output).
__global__ void __launch_bounds__(kReduceWarps * 32)
dqmm_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                   int count, float* __restrict__ out) {
  __shared__ float part[kReduceWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  const int per = (n_chunks + kReduceWarps - 1) / kReduceWarps;
  const int c_lo = min(n_chunks, warp * per);
  const int c_hi = min(n_chunks, c_lo + per);
  float s = 0.0f;
  if (e < count) {
    const float* p = partial + e;
    int c = c_lo;
    for (; c + 8 <= c_hi; c += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = p[static_cast<size_t>(c + k) * count];
#pragma unroll
      for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[k]);
    }
    for (; c < c_hi; ++c) s = __fadd_rn(s, p[static_cast<size_t>(c) * count]);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < count) {
    float t = part[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) t = __fadd_rn(t, part[w][lane]);
    out[e] = t;
  }
}

int n_tiles(int x) { return (x + kTile - 1) / kTile; }

// Rows per CTA (a multiple of kRows) and the chunk count covering `rows`:
// at most kMaxCtas CTAs over all output tiles.
void split_rows(int rows, int dim, int n, int* chunks, int* per) {
  const int tiles = n_tiles(dim) * n_tiles(n);
  int c = tiles > 0 ? kMaxCtas / tiles : 1;
  if (c < 1) c = 1;
  const int stages = (rows + kRows - 1) / kRows;
  if (c > stages) c = stages;
  int p = c > 0 ? (rows + c - 1) / c : kRows;
  p = (p + kRows - 1) / kRows * kRows;
  *per = p;
  *chunks = rows > 0 ? (rows + p - 1) / p : 0;
}

}  // namespace

// The number of row chunks (partial tiles) the launch for `rows` x (dim, n)
// uses; the caller allocates partial as (chunks, dim, n) fp32.
extern "C" int dequant_matmul_chunks(int rows, int dim, int n) {
  int chunks, per;
  split_rows(rows, dim, n, &chunks, &per);
  return chunks;
}

// packed (rows, dp) uint8 chunk-interleaved codes of `bits` bits with
// dp * (8 / bits) >= dim; scale/zero (rows,) fp32; g (rows, n) fp32;
// partial (dequant_matmul_chunks(rows, dim, n), dim, n) fp32 scratch ->
// out (dim, n) fp32 (zeros at rows == 0). Returns cudaGetLastError() after
// the launches.
extern "C" int dequant_matmul_launch(const void* packed, int dp, int bits,
                                     int dim, const void* scale,
                                     const void* zero, const void* g,
                                     int rows, int n, void* partial,
                                     void* out, void* stream) {
  if (dim <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  int chunks, per;
  split_rows(rows, dim, n, &chunks, &per);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    Args a;
    a.packed = static_cast<const uint8_t*>(packed);
    a.scale = static_cast<const float*>(scale);
    a.zero = static_cast<const float*>(zero);
    a.g = static_cast<const float*>(g);
    a.partial = static_cast<float*>(partial);
    a.rows = rows;
    a.dp = dp;
    a.bits = bits;
    a.dim = dim;
    a.n = n;
    a.rows_per_cta = per;
    a.g_vec = (reinterpret_cast<uintptr_t>(g) % 16 == 0 && n % 4 == 0);
    // 16-byte packed copies where every f-tile's window is one aligned run
    // of whole 16-byte units inside the row; byte loads otherwise
    bool vec = dp % 16 == 0;
    for (int f0 = 0; vec && f0 < dim; f0 += kTile) {
      const int b0 = dp > kTile ? f0 % dp : 0;
      const int pw = dp > kTile ? kTile : dp;
      vec = pw % 16 == 0 && b0 + pw <= dp &&
            (reinterpret_cast<uintptr_t>(packed) + b0) % 16 == 0;
    }
    a.p_vec = vec;
    // the shared-memory opt-in, once per device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(dqmm_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    const dim3 grid(chunks, n_tiles(dim), n_tiles(n));
    dqmm_mma_kernel<<<grid, kThreads, kSmemBytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int count = dim * n;
  dqmm_reduce_kernel<<<(count + 31) / 32, kReduceWarps * 32, 0, st>>>(
      static_cast<const float*>(partial), chunks, count,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
