// Shared helpers of the CNN-block kernels (conv1_block.cu, conv_block.cu).
#pragma once

#include <cuda_runtime.h>

namespace cutdet {

// A pooled output row r reads conv rows 3r..3r+2, which read input rows
// 3r-1..3r+3 (zero 'same' padding): five staged input rows per block.
constexpr int kRowsStaged = 5;

// Allow more than the default 48 KB of dynamic shared memory when a
// launch needs it (up to the 227 KB a Hopper block may use).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Eval-BN affine y = m*s + t with two roundings, exactly as the plain
// version computes it (no FMA contraction).
__device__ __forceinline__ float bn_affine(float m, float s, float t) {
  return __fadd_rn(__fmul_rn(m, s), t);
}

}  // namespace cutdet
