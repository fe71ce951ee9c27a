// Fused dequantize + transposed GEMM for the ACT weight gradient:
// dW = x_hat^T @ g, x_hat = code * scale + zero from the packed b-bit
// residual, fp32 accumulation, x_hat never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/dequant_matmul.py:_dqmm_kernel.
//
// Bound on the H100: operations, at the paper's width. The function reads
// R * ceil(dim*b/8) packed bytes, 8 bytes of scale/zero a row and the
// (R, N) fp32 g once, and writes the (dim, N) output once; it does
// 2 * R * dim * N flops. At R 184,166, dim = N = 64 that is 51.6 MB
// (0.015 ms at 3.35 TB/s) against 1.51 GFLOP (0.023 ms at the 67 TFLOP/s
// fp32 rate outside the tensor cores). This kernel uses no tensor cores and
// no TF32: wgmma is later work.
//
// Design. R is long (every node of the graph) and the output small, so the
// TPU kernel's sequential reduction over row tiles becomes a split over R:
// CTA (c, dt, nt) takes rows [c*rows_per_cta, (c+1)*rows_per_cta) and the
// 64x64 output tile (dt, nt). It stages 32 rows at a time into shared
// memory (x_hat unpacked there: feature j from byte j % dp at shift
// (j / dp) * bits, features >= dim and rows >= R as 0), and each of its 256
// threads keeps a 4x4 block of the tile in registers, accumulating the rows
// in order with fma. The CTA writes its partial tile; a second kernel sums
// the partials of every output element in chunk order. No atomics: two runs
// give the same bits. x_hat is rounded as the port's dequantize:
// __fmul_rn then __fadd_rn, never one fma.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;     // output tile edge (features x columns)
constexpr int kRows = 32;     // rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxChunks = 132 * 4;

__global__ void dqmm_partial_kernel(const uint8_t* __restrict__ packed,
                                    int dp, int bits, int dim,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ zero,
                                    const float* __restrict__ g, int rows,
                                    int n, int rows_per_cta,
                                    float* __restrict__ partial) {
  __shared__ float xs[kRows][kTile];
  __shared__ float gs[kRows][kTile];
  const int chunk = blockIdx.x;
  const int d0 = blockIdx.y * kTile;
  const int n0 = blockIdx.z * kTile;
  const int r_begin = chunk * rows_per_cta;
  const int r_end = min(rows, r_begin + rows_per_cta);
  const int tx = threadIdx.x % 16;  // output columns n0 + tx + 16*j
  const int ty = threadIdx.x / 16;  // output features d0 + ty + 16*i
  const unsigned mask = (1u << bits) - 1u;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int rr = i / kTile;
      const int c = i % kTile;
      const int r = r0 + rr;
      float xv = 0.0f;
      float gv = 0.0f;
      if (r < r_end) {
        const int f = d0 + c;
        if (f < dim) {
          const unsigned code =
              (packed[static_cast<size_t>(r) * dp + f % dp] >>
               ((f / dp) * bits)) & mask;
          xv = __fadd_rn(__fmul_rn(static_cast<float>(code), scale[r]),
                         zero[r]);
        }
        if (n0 + c < n) gv = g[static_cast<size_t>(r) * n + n0 + c];
      }
      xs[rr][c] = xv;
      gs[rr][c] = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(chunk) * dim * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = d0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (f < dim && c < n) out[static_cast<size_t>(f) * n + c] = acc[i][j];
    }
  }
}

__global__ void dqmm_reduce_kernel(const float* __restrict__ partial,
                                   int n_chunks, int count,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    s += partial[static_cast<size_t>(c) * count + i];
  out[i] = s;
}

// Rows per CTA (a multiple of kRows) and the chunk count covering `rows`.
void split_rows(int rows, int* chunks, int* per) {
  int c = (rows + kRows - 1) / kRows;
  if (c > kMaxChunks) c = kMaxChunks;
  int p = c > 0 ? (rows + c - 1) / c : kRows;
  p = (p + kRows - 1) / kRows * kRows;
  *per = p;
  *chunks = rows > 0 ? (rows + p - 1) / p : 0;
}

}  // namespace

// The number of row chunks (partial tiles) the launch for `rows` rows uses;
// the caller allocates partial as (chunks, dim, n) fp32.
extern "C" int dequant_matmul_chunks(int rows) {
  int chunks, per;
  split_rows(rows, &chunks, &per);
  return chunks;
}

// packed (rows, dp) uint8 chunk-interleaved codes of `bits` bits with
// dp * (8 / bits) >= dim; scale/zero (rows,) fp32; g (rows, n) fp32;
// partial (dequant_matmul_chunks(rows), dim, n) fp32 scratch -> out
// (dim, n) fp32. Returns cudaGetLastError() after the two launches.
extern "C" int dequant_matmul_launch(const void* packed, int dp, int bits,
                                     int dim, const void* scale,
                                     const void* zero, const void* g,
                                     int rows, int n, void* partial,
                                     void* out, void* stream) {
  int chunks, per;
  split_rows(rows, &chunks, &per);
  if (chunks == 0 || dim <= 0 || n <= 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, (dim + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  dqmm_partial_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), dp, bits, dim,
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<const float*>(g), rows, n, per,
      static_cast<float*>(partial));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int count = dim * n;
  dqmm_reduce_kernel<<<(count + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), chunks, count,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
