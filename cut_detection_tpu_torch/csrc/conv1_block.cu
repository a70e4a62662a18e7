// Layer-1 CNN block, fused: conv3x3 (zero pad 1) + bias -> ReLU ->
// maxpool 3x3 stride 3 (floor) -> eval-BN affine, from raw uint8 BGR.
//
// Replaces the Pallas kernel conv1_pool_fused
// (cut_detection_tpu/ops/pallas/conv1_kernel.py), the float32 instance:
// f32 pixels, weights, accumulation and output.  Feed it the
// preprocess-folded kernel (flip + /255 folded into the weights), so the
// raw pixels are the input.
//
// What bounds it on an H100: per 144x256 frame the block reads ~110 KB of
// uint8 and writes ~0.78 MB of pooled f32, but does 27*48 MACs for each of
// the 144*255 conv pixels (~95 MFLOP/frame) — about 100 FLOP per byte,
// far above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s), so
// the f32 CUDA cores bound it, not memory.  The unfused version also
// round-trips the [144,256,48] f32 conv output (7 MB/frame) through
// device memory; this kernel never writes it.
//
// The simple design: one block per (pooled row, frame).  The five input
// rows that row needs are staged once in shared memory as f32, zero-padded
// on all sides, so any H >= 3 and W >= 3 work (floor pooling).  Each
// thread owns one output channel, keeps its 27 weights in registers, and
// walks pooled columns; per (dy, c, cy) five staged pixels feed nine FMAs
// (the 3x3 conv outputs under one pool window).  Pool windows do not
// overlap (stride = window), so no conv value is computed twice.  No
// tensor cores: this is the exact-f32 path.
#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kCin = 3;                 // BGR
constexpr int kTaps = 9 * kCin;         // 3x3 window x channels

__global__ void conv1_block_kernel(const uint8_t* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ offset,
                                   float* __restrict__ out,
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
  for (int k = 0; k < kTaps; ++k) wr[k] = w[k * Cout + o];
  const float bo = bias[o];
  const float so = scale[o];
  const float to = offset[o];
  __syncthreads();

  float* orow = out + (static_cast<size_t>(b) * Hp + r) * Wp * Cout;
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
      for (int cx = 0; cx < 3; ++cx) m = fmaxf(m, __fadd_rn(acc[cy][cx], bo));
    // relu(max) == max(relu): the ReLU commutes with the pool.
    orow[px * Cout + o] = cutdet::bn_affine(fmaxf(m, 0.f), so, to);
  }
}

}  // namespace

extern "C" int cutdet_conv1_block(const void* x, const void* w,
                                  const void* bias, const void* scale,
                                  const void* offset, void* out, int B, int H,
                                  int W, int Cout, void* stream) {
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
  cudaError_t err = cutdet::allow_smem(conv1_block_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1_block_kernel<<<grid, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<float*>(out), H, W,
      Cout, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cutdet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
