// Mid-stack CNN block, fused: conv3x3 (zero pad 1) + bias -> ReLU ->
// maxpool 3x3 stride 3 (floor) -> eval-BN affine, NHWC in and out.
//
// Replaces the Pallas kernel fused_conv_block_pm
// (cut_detection_tpu/ops/pallas/fused_block_pm.py).  One source,
// templated on the operand type:
//   float          true f32 operands and accumulation, no tensor cores —
//                  the float32 path (layers 2 and 3 of the prod net);
//   __nv_bfloat16  the Pallas kernel's numerics: bf16 operands, f32
//                  accumulation, relu(acc + bias) rounded to bf16 before
//                  the pool, f32 output (its out_dtype=float32).
//
// What bounds it on an H100: at the prod layer-2 shape (48x85x48 -> 16x28
// x48) a frame needs 16*28*9 conv pixels x 9*48*48 MACs (~84 M MAC) against
// ~0.8 MB of f32 input, ~100 FLOP per byte — compute on the CUDA cores
// again, not memory.  The fused block keeps the [48,85,48] conv output on
// chip.
//
// The simple design: one block per (tile of 8 pooled columns, pooled row,
// frame).  The block stages its 5 x 26 x Cin input window in shared
// memory as f32 (zero-padded, so any H and W >= 3 work), then each thread
// owns one (output channel, pooled column) pair and keeps the 3x3 conv
// outputs under its pool window in nine accumulators: per (dy, c) three
// weights (read through L1, coalesced over the channel) and, per conv row,
// five staged pixels feed nine FMAs.
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kTilePx = 8;                  // pooled columns per block
constexpr int kTileCols = 3 * kTilePx + 2;  // staged columns, with halo

template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round_act(float v) { return v; }
};

template <>
struct Operand<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round_act(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__global__ void conv_block_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ offset,
                                  float* __restrict__ out, int H, int W,
                                  int Cin, int Cout, int Hp, int Wp) {
  extern __shared__ float tile[];  // [kRowsStaged][kTileCols][Cin]
  const int px0 = blockIdx.x * kTilePx;
  const int r = blockIdx.y;  // pooled row
  const int b = blockIdx.z;  // frame
  const int o = threadIdx.x;  // output channel (blockDim.x == Cout)
  const int lpx = threadIdx.y;  // pooled column within the tile
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int row_elems = kTileCols * Cin;
  const int col0 = 3 * px0 - 1;

  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;
  for (int i = tid; i < cutdet::kRowsStaged * row_elems; i += nthreads) {
    const int sr = i / row_elems;
    const int rem = i - sr * row_elems;
    const int sc = rem / Cin;
    const int c = rem - sc * Cin;
    const int y = 3 * r - 1 + sr;
    const int xc = col0 + sc;
    float v = 0.f;
    if (y >= 0 && y < H && xc >= 0 && xc < W) {
      v = Operand<T>::load(xb + (static_cast<size_t>(y) * W + xc) * Cin + c);
    }
    tile[i] = v;
  }
  __syncthreads();

  const int px = px0 + lpx;
  if (px >= Wp) return;

  float acc[3][3];
#pragma unroll
  for (int cy = 0; cy < 3; ++cy)
#pragma unroll
    for (int cx = 0; cx < 3; ++cx) acc[cy][cx] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    const T* wrow = w + static_cast<size_t>(dy * 3) * Cin * Cout + o;
    for (int c = 0; c < Cin; ++c) {
      // HWIO rows (dy*3 + dx)*Cin + c, dx = 0, 1, 2.
      const float w0 = Operand<T>::load(wrow + static_cast<size_t>(c) * Cout);
      const float w1 =
          Operand<T>::load(wrow + static_cast<size_t>(Cin + c) * Cout);
      const float w2 =
          Operand<T>::load(wrow + static_cast<size_t>(2 * Cin + c) * Cout);
#pragma unroll
      for (int cy = 0; cy < 3; ++cy) {
        // Staged columns 3*lpx .. 3*lpx+4 of staged row cy+dy.
        const float* p = tile + ((cy + dy) * kTileCols + 3 * lpx) * Cin + c;
        const float v0 = p[0], v1 = p[Cin], v2 = p[2 * Cin];
        const float v3 = p[3 * Cin], v4 = p[4 * Cin];
        acc[cy][0] = fmaf(v2, w2, fmaf(v1, w1, fmaf(v0, w0, acc[cy][0])));
        acc[cy][1] = fmaf(v3, w2, fmaf(v2, w1, fmaf(v1, w0, acc[cy][1])));
        acc[cy][2] = fmaf(v4, w2, fmaf(v3, w1, fmaf(v2, w0, acc[cy][2])));
      }
    }
  }

  const float bo = bias[o];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int cy = 0; cy < 3; ++cy)
#pragma unroll
    for (int cx = 0; cx < 3; ++cx) {
      const float z = fmaxf(__fadd_rn(acc[cy][cx], bo), 0.f);
      m = fmaxf(m, Operand<T>::round_act(z));
    }
  out[((static_cast<size_t>(b) * Hp + r) * Wp + px) * Cout + o] =
      cutdet::bn_affine(m, scale[o], offset[o]);
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* scale,
           const void* offset, void* out, int B, int H, int W, int Cin,
           int Cout, void* stream) {
  if (B <= 0 || H < 3 || W < 3 || Cin <= 0 || Cout <= 0 ||
      Cout * kTilePx > 1024 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Hp = H / 3;
  const int Wp = (W - 3) / 3 + 1;
  const dim3 block(Cout, kTilePx);
  const dim3 grid((Wp + kTilePx - 1) / kTilePx, Hp, B);
  const size_t smem =
      sizeof(float) * cutdet::kRowsStaged * kTileCols * static_cast<size_t>(Cin);
  cudaError_t err = cutdet::allow_smem(conv_block_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_kernel<T><<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<float*>(out), H, W, Cin,
      Cout, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cutdet_conv_block_f32(const void* x, const void* w,
                                     const void* bias, const void* scale,
                                     const void* offset, void* out, int B,
                                     int H, int W, int Cin, int Cout,
                                     void* stream) {
  return launch<float>(x, w, bias, scale, offset, out, B, H, W, Cin, Cout,
                       stream);
}

extern "C" int cutdet_conv_block_bf16(const void* x, const void* w,
                                      const void* bias, const void* scale,
                                      const void* offset, void* out, int B,
                                      int H, int W, int Cin, int Cout,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, scale, offset, out, B, H, W, Cin,
                               Cout, stream);
}
