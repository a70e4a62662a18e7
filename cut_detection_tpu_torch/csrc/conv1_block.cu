// Layer-1 CNN block, fused: conv3x3 (zero pad 1) + bias -> ReLU ->
// maxpool 3x3 stride 3 (floor) -> eval-BN affine, from raw uint8 BGR.
//
// One source, templated on the weight type, the epilogue (common.cuh) and
// the output type; three instances:
//   f32   replaces the Pallas kernel conv1_pool_fused
//         (cut_detection_tpu/ops/pallas/conv1_kernel.py): f32 pixels,
//         weights, accumulation and output — layer 1 of the float32 path,
//         and of the bfloat16 rung with its weights rounded to bf16 (uint8
//         pixels are exact in bf16, so that is the rung's exact numerics);
//   bf16  replaces the Pallas kernel fused_conv1_pool
//         (cut_detection_tpu/ops/pallas/fused_conv1.py, "K1"): bf16
//         weights, f32 accumulation, relu(acc + bias) rounded to bf16
//         before the pool, the BN affine in f32, a bf16 output — layer 1
//         of the bench's K1 graphs.  Unlike K1 it takes any H >= 3;
//   bf16_xla  the same bf16 weights and f32 accumulation with XLA's
//         bfloat16_full epilogue (a bf16 rounding after every op) — the
//         JAX rung's layer 1, and the port's at bfloat16_full.
// Both take the preprocess-folded kernel (flip + /255 folded into the
// weights), so the raw pixels are the input.
//
// What bounds it on an H100: per 144x256 frame the block reads ~110 KB of
// uint8 and writes ~0.78 MB of pooled f32 (half in bf16), but does 27*48
// MACs for each of the 144*255 conv pixels (~95 MFLOP/frame) — about 100
// FLOP per byte,
// far above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s), so
// the f32 CUDA cores bound it, not memory (bf16 weights and output change
// the bytes, not the FMAs).  The unfused version also round-trips the
// [144,256,48] conv output (7 MB/frame in f32) through device memory;
// this kernel never writes it.
//
// The simple design: one block per (pooled row, frame).  The five input
// rows that row needs are staged once in shared memory as f32, zero-padded
// on all sides, so any H >= 3 and W >= 3 work (floor pooling).  Each
// thread owns one output channel, keeps its 27 weights in registers, and
// walks pooled columns; per (dy, c, cy) five staged pixels feed nine FMAs
// (the 3x3 conv outputs under one pool window).  Pool windows do not
// overlap (stride = window), so no conv value is computed twice.  No
// tensor cores: bf16 weights times integer pixels are exact in f32, so
// both instances run plain f32 FMAs.
#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kCin = 3;                 // BGR
constexpr int kTaps = 9 * kCin;         // 3x3 window x channels

using cutdet::Epilogue;

template <typename Wt, Epilogue E, typename Out>
struct Instance {
  using w_t = Wt;
  static constexpr Epilogue epi = E;
  using out_t = Out;
};

using cutdet::bf16;
using F32 = Instance<float, Epilogue::kF32, float>;
using Bf16 = Instance<bf16, Epilogue::kRoundAct, bf16>;
using Bf16Xla = Instance<bf16, Epilogue::kXla, bf16>;

template <typename I>
__global__ void conv1_block_kernel(const uint8_t* __restrict__ x,
                                   const typename I::w_t* __restrict__ w,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ offset,
                                   typename I::out_t* __restrict__ out,
                                   int H, int W, int Cout, int Hp, int Wp) {
  extern __shared__ float tile[];  // [kRowsStaged][W + 2][kCin]
  const int r = blockIdx.x;        // pooled row
  const int b = blockIdx.y;        // frame
  const int o = threadIdx.x;       // output channel (blockDim.x == Cout)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int ws = W + 2;
  const int row_elems = ws * kCin;

  const uint8_t* xb = x + static_cast<size_t>(b) * H * W * kCin;
  for (int i = tid; i < cutdet::kRowsStaged * row_elems; i += nthreads) {
    const int sr = i / row_elems;
    const int rem = i - sr * row_elems;
    const int sc = rem / kCin;
    const int c = rem - sc * kCin;
    const int y = 3 * r - 1 + sr;
    const int xc = sc - 1;
    float v = 0.f;
    if (y >= 0 && y < H && xc >= 0 && xc < W) {
      v = static_cast<float>(xb[(static_cast<size_t>(y) * W + xc) * kCin + c]);
    }
    tile[i] = v;
  }

  float wr[kTaps];  // HWIO row (dy*3 + dx)*kCin + c of channel o
#pragma unroll
  for (int k = 0; k < kTaps; ++k) wr[k] = cutdet::load(w + k * Cout + o);
  const float bo = bias[o];
  const float so = scale[o];
  const float to = offset[o];
  __syncthreads();

  typename I::out_t* orow =
      out + (static_cast<size_t>(b) * Hp + r) * Wp * Cout;
  for (int px = threadIdx.y; px < Wp; px += blockDim.y) {
    float acc[3][3];
#pragma unroll
    for (int cy = 0; cy < 3; ++cy)
#pragma unroll
      for (int cx = 0; cx < 3; ++cx) acc[cy][cx] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int c = 0; c < kCin; ++c) {
        const float w0 = wr[(dy * 3 + 0) * kCin + c];
        const float w1 = wr[(dy * 3 + 1) * kCin + c];
        const float w2 = wr[(dy * 3 + 2) * kCin + c];
#pragma unroll
        for (int cy = 0; cy < 3; ++cy) {
          // Staged columns 3*px .. 3*px+4 of staged row cy+dy.
          const float* p = tile + ((cy + dy) * ws + 3 * px) * kCin + c;
          const float v0 = p[0], v1 = p[kCin], v2 = p[2 * kCin];
          const float v3 = p[3 * kCin], v4 = p[4 * kCin];
          acc[cy][0] = fmaf(v2, w2, fmaf(v1, w1, fmaf(v0, w0, acc[cy][0])));
          acc[cy][1] = fmaf(v3, w2, fmaf(v2, w1, fmaf(v1, w0, acc[cy][1])));
          acc[cy][2] = fmaf(v4, w2, fmaf(v3, w1, fmaf(v2, w0, acc[cy][2])));
        }
      }
    }
    float m = -CUDART_INF_F;
#pragma unroll
    for (int cy = 0; cy < 3; ++cy)
#pragma unroll
      for (int cx = 0; cx < 3; ++cx) m = fmaxf(m, acc[cy][cx]);
    cutdet::store(orow + px * Cout + o,
                  cutdet::epilogue<I::epi>(m, bo, so, to));
  }
}

template <typename I>
int launch(const void* x, const void* w, const void* bias, const void* scale,
           const void* offset, void* out, int B, int H, int W, int Cout,
           void* stream) {
  const int Hp = H / 3;
  const int Wp = (W - 3) / 3 + 1;
  if (B <= 0 || B > 65535 || H < 3 || W < 3 || Cout <= 0 || Cout > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows = 1024 / Cout;
  if (rows > 8) rows = 8;
  const dim3 block(Cout, rows);
  const dim3 grid(Hp, B);
  const size_t smem =
      sizeof(float) * cutdet::kRowsStaged * (W + 2) * kCin;
  cudaError_t err = cutdet::allow_smem(conv1_block_kernel<I>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1_block_kernel<I><<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x),
      static_cast<const typename I::w_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset),
      static_cast<typename I::out_t*>(out), H, W, Cout, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cutdet_conv1_block(const void* x, const void* w,
                                  const void* bias, const void* scale,
                                  const void* offset, void* out, int B, int H,
                                  int W, int Cout, void* stream) {
  return launch<F32>(x, w, bias, scale, offset, out, B, H, W, Cout, stream);
}

extern "C" int cutdet_conv1_block_bf16(const void* x, const void* w,
                                       const void* bias, const void* scale,
                                       const void* offset, void* out, int B,
                                       int H, int W, int Cout, void* stream) {
  return launch<Bf16>(x, w, bias, scale, offset, out, B, H, W, Cout, stream);
}

extern "C" int cutdet_conv1_block_bf16_xla(const void* x, const void* w,
                                           const void* bias,
                                           const void* scale,
                                           const void* offset, void* out,
                                           int B, int H, int W, int Cout,
                                           void* stream) {
  return launch<Bf16Xla>(x, w, bias, scale, offset, out, B, H, W, Cout,
                         stream);
}

extern "C" const char* cutdet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
