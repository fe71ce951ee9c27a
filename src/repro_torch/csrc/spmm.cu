// Weighted SPMM over the blocked-CSR layout: out[v] = sum_{e -> v} ew[e] * x[src_e].
//
// Replaces the TPU kernels src/repro/kernels/spmm.py:_spmm_kernel (table in
// VMEM) and :_spmm_dma_kernel (table in HBM, double-buffered row DMA). On
// Hopper every table is gathered from device memory, so one kernel covers
// both; a pipelined cp.async/TMA gather is later work.
//
// Bound on the H100: bytes. The function must read the (n_src, d) fp32
// table once, a source index and a weight per edge and the row pointers,
// and write the (n_out, d) output once; 2*E*d flops are far below the fp32
// peak. This kernel gathers one d-wide row per edge (E*d*4 bytes, E/n_src
// times the table) and reads 12 bytes of layout per slot, so it nears that
// bound only as far as the L2 keeps the table's rows between their reuses.
//
// Design. The TPU kernel accumulates a destination tile across consecutive
// grid steps by revisiting its output block. CUDA blocks run in parallel and
// in no order, so one CTA owns a whole tile: tile_ptr[t] .. tile_ptr[t+1]
// are its slot blocks. The layout sorts a tile's real edges by destination
// (stable) and puts its pad slots after them, so each destination row's
// edges are one contiguous run of slots. The CTA first finds every row's run
// (start/end in shared memory), then each warp takes whole rows and its
// lanes take columns: the warp walks the row's run in slot order and keeps
// the sums in registers. Every output element is therefore one sequential
// fp32 sum in slot order, written once: no atomics, and two runs give the
// same bits. Pad slots (perm == n_edges) are skipped, which is what their
// zero weight in the reference amounts to. ew == nullptr means weight 1.
//
// The kernel takes one direction's arrays; the transpose direction of the
// layout (t_* arrays) runs through it unchanged.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerLane = 4;  // columns a lane sums per pass over a run

__global__ void spmm_kernel(const float* __restrict__ x, int d,
                            const float* __restrict__ ew, int n_edges,
                            const int* __restrict__ gat,
                            const int* __restrict__ ldst,
                            const int* __restrict__ perm,
                            const int* __restrict__ tile_ptr, int block_e,
                            int block_rows, int n_out,
                            float* __restrict__ out) {
  extern __shared__ int run[];  // [0, block_rows): start; then end
  int* run_start = run;
  int* run_end = run + block_rows;
  const int tile = blockIdx.x;
  const int s0 = tile_ptr[tile] * block_e;
  const int s1 = tile_ptr[tile + 1] * block_e;

  for (int r = threadIdx.x; r < block_rows; r += blockDim.x) {
    run_start[r] = 0;
    run_end[r] = 0;
  }
  __syncthreads();
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    if (perm[s] >= n_edges) continue;  // pad slot
    const int r = ldst[s];
    if (s == s0 || perm[s - 1] >= n_edges || ldst[s - 1] != r) run_start[r] = s;
    if (s + 1 == s1 || perm[s + 1] >= n_edges || ldst[s + 1] != r)
      run_end[r] = s + 1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < block_rows; r += n_warps) {
    const int row = tile * block_rows + r;
    if (row >= n_out) break;
    const int a = run_start[r];
    const int b = run_end[r];
    for (int c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
      float acc[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int s = a; s < b; ++s) {
        const float w = ew != nullptr ? ew[perm[s]] : 1.0f;
        const float* xr = x + static_cast<size_t>(gat[s]) * d;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + j * 32 + lane;
          if (c < d) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, xr[c]));
        }
      }
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = c0 + j * 32 + lane;
        if (c < d) out[static_cast<size_t>(row) * d + c] = acc[j];
      }
    }
  }
}

}  // namespace

// x (n_src, d) fp32; ew (n_edges,) fp32 or null; gat/ldst/perm
// (n_blocks*block_e,) int32; tile_ptr (n_tiles+1,) int32 -> out (n_out, d)
// fp32, every row written. Returns cudaGetLastError() after the launch.
extern "C" int spmm_launch(const void* x, int d, const void* ew, int n_edges,
                           const void* gat, const void* ldst, const void* perm,
                           const void* tile_ptr, int n_tiles, int block_e,
                           int block_rows, int n_out, void* out,
                           void* stream) {
  if (n_tiles > 0 && d > 0) {
    const size_t smem = 2 * static_cast<size_t>(block_rows) * sizeof(int);
    spmm_kernel<<<n_tiles, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), d, static_cast<const float*>(ew),
        n_edges, static_cast<const int*>(gat), static_cast<const int*>(ldst),
        static_cast<const int*>(perm), static_cast<const int*>(tile_ptr),
        block_e, block_rows, n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
