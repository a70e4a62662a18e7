// Shared helpers of the CNN-block kernels (conv_block.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cutdet {

using bf16 = __nv_bfloat16;

// A pooled output row r reads conv rows 3r..3r+2, which read input rows
// 3r-1..3r+3 (zero 'same' padding): five staged input rows per block.
constexpr int kRowsStaged = 5;

// Eval-BN affine y = m*s + t with two roundings, exactly as the plain
// version computes it (no FMA contraction).
__device__ __forceinline__ float bn_affine(float m, float s, float t) {
  return __fadd_rn(__fmul_rn(m, s), t);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}

// v rounded to T (nearest even), as float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// *p as an operand of type Op, widened to float: rounded only where its
// own type is wider than Op.
template <typename Op, typename T>
__device__ __forceinline__ float operand(const T* p) {
  if constexpr (std::is_same_v<Op, T>) {
    return load(p);
  } else {
    return round_to<Op>(load(p));
  }
}

// What a block does after its conv, to the largest f32 accumulator of a
// pool window (bias add, ReLU, the roundings and the BN are all monotonic
// non-decreasing, so they commute with the max pool):
//   kF32       relu(acc + bias), then the f32 BN affine (float32 and
//              bfloat16 rungs);
//   kRoundAct  relu(acc + bias) rounded to bf16, then the f32 BN affine
//              (the Pallas kernels K1, K3, K4);
//   kXla       XLA's bfloat16_full: a bf16 rounding after every op — the
//              accumulator, its sum with the bf16 bias, then the BN's
//              product with bf16(s) and its sum with bf16(t).  The last
//              rounding is the store's: a bf16 output rounds the sum, an
//              f32 one keeps it, as XLA does where it fuses that sum into
//              an f32 consumer;
//   kI8        the int8_mxu block's (int32 accumulators): per conv pixel
//              z = f32(acc) * so[c] + ring[c] before the pool, since the
//              ring varies by pixel; then quantize_i8 of the window's
//              largest z.
enum class Epilogue { kF32, kRoundAct, kXla, kI8 };

template <Epilogue E>
__device__ __forceinline__ float epilogue(float acc, float bias, float s,
                                          float t) {
  if constexpr (E == Epilogue::kXla) {
    const float z = round_to<bf16>(
        __fadd_rn(round_to<bf16>(acc), round_to<bf16>(bias)));
    const float m = fmaxf(z, 0.f);
    return __fadd_rn(round_to<bf16>(__fmul_rn(m, round_to<bf16>(s))),
                     round_to<bf16>(t));
  } else {
    float m = fmaxf(__fadd_rn(acc, bias), 0.f);
    if constexpr (E == Epilogue::kRoundAct) m = round_to<bf16>(m);
    return bn_affine(m, s, t);
  }
}

// The int8_mxu block's z of a conv pixel from its sum as f32, sum * so +
// ring, with two roundings as the plain version's separate torch ops (no
// contraction).  The int32 sum is exact and below 2^24 in magnitude at
// the prod net's widths, so its f32 is exact too; __int2float_rn rounds
// larger ones as torch's conversion does.
__device__ __forceinline__ float dequant_i8(float sum, float so, float ring) {
  return __fadd_rn(__fmul_rn(sum, so), ring);
}

// The int8_mxu code of a pooled z: clip(rint(relu(z) / scale) - 128, -128,
// 127), each f32 step rounded as the plain version's separate torch ops
// round (an IEEE division, no contraction).  ReLU and the quantization are
// nondecreasing in z, so the code of the window's largest z is the largest
// of its nine codes: one division per output instead of nine.  A z <= 0
// is code -128 (relu(z) / scale = 0) without the division: a zero
// dividend sends the IEEE division down its slow path.
__device__ __forceinline__ uint32_t quantize_i8(float z, float scale) {
  const float q = rintf(__fdiv_rn(z > 0.f ? z : scale, scale)) - 128.f;
  const float c = z > 0.f ? fminf(fmaxf(q, -128.f), 127.f) : -128.f;
  return static_cast<uint32_t>(__float2int_rn(c)) & 0xFFu;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace cutdet
