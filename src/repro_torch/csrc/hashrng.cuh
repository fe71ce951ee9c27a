// Counter hash for in-kernel stochastic rounding: the device copy of
// repro_torch.kernels.hashrng.hash_uniform (murmur3 32-bit finalizer over
// element index XOR seed, top 24 bits as a float in [0, 1)). Both give the
// same bits for the same (index, seed), so the CUDA quantizer and its plain
// PyTorch version draw identical noise.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t murmur3_fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  // 24 bits -> exact float32 in [0, 1)
  return static_cast<float>(murmur3_fmix(idx ^ seed) >> 8) *
         (1.0f / 16777216.0f);
}
