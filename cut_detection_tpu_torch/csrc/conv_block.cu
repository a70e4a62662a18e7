// Mid-stack CNN block, fused: conv3x3 (zero pad 1) + bias -> ReLU ->
// maxpool 3x3 stride 3 (floor) -> eval-BN affine.
//
// Replaces two Pallas kernels: fused_conv_block_pm
// (cut_detection_tpu/ops/pallas/fused_block_pm.py, NHWC) and
// fused_conv_block (cut_detection_tpu/ops/pallas/fused_conv_block.py,
// channel-major).  One source, templated on the types of the input, the
// weights, the operands (what both are rounded to as they are read), the
// post-ReLU activation (what it is rounded to before the pool) and the
// output, and on the layouts of the input and the output: NHWC, or
// channel-major [B, C, H, W].  Three NHWC instances:
//   f32            f32 operands and accumulation, no tensor cores — the
//                  float32 path (layers 2 and 3 of the prod net);
//   bf16_out       the Pallas kernel's numerics: bf16 operands, f32
//                  accumulation, relu(acc + bias) rounded to bf16 before
//                  the pool, bf16 output (its default out_dtype) —
//                  layers 2 and 3 of the bfloat16_full rung;
//   bf16_operands  f32 input rounded to bf16 as it is staged, f32 weights
//                  rounded to bf16 as they are read, f32 accumulation,
//                  f32 activations with no rounding, f32 output — the
//                  bfloat16 rung's conv2d_same(compute_dtype="bfloat16")
//                  -> ReLU -> pool -> BN (layers.py:109-123).
// and two channel-major ones, fused_conv_block's numerics (those of
// bf16_out) with channel-major input and output:
//   cm_bf16        bf16 output (its default out_dtype);
//   cm_f32         f32 output (out_dtype=float32).
// Floor pooling at any H: pooled row r reads conv rows 3r..3r+2, which
// read input rows 3r-1..3r+3, so the last pooled row reads input row
// h_eff = 3*(H/3) and nothing below it; where h_eff == H that row is the
// zero padding (the staging loop's y < H test).
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
// five staged pixels feed nine FMAs.  bf16 values are exact in f32, so
// the rounded operands multiply exactly and the FMAs accumulate in f32.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kTilePx = 8;                  // pooled columns per block
constexpr int kTileCols = 3 * kTilePx + 2;  // staged columns, with halo

template <typename In, typename Wt, typename Op, typename Act, typename Out,
          bool InChannelMajor = false, bool OutChannelMajor = false>
struct Instance {
  using in_t = In;
  using w_t = Wt;
  using op_t = Op;
  using act_t = Act;
  using out_t = Out;
  static constexpr bool in_cm = InChannelMajor;
  static constexpr bool out_cm = OutChannelMajor;
};

using cutdet::bf16;
using F32 = Instance<float, float, float, float, float>;
using Bf16Out = Instance<bf16, bf16, bf16, bf16, bf16>;
using Bf16Operands = Instance<float, float, bf16, float, float>;
using CmBf16 = Instance<bf16, bf16, bf16, bf16, bf16, true, true>;
using CmF32 = Instance<bf16, bf16, bf16, bf16, float, true, true>;

template <typename I>
__global__ void conv_block_kernel(const typename I::in_t* __restrict__ x,
                                  const typename I::w_t* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ offset,
                                  typename I::out_t* __restrict__ out, int H,
                                  int W, int Cin, int Cout, int Hp, int Wp) {
  using Op = typename I::op_t;
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

  const typename I::in_t* xb = x + static_cast<size_t>(b) * H * W * Cin;
  // The tile is [row][column][channel] either way; the loop walks the
  // input's fastest axis with the threads, so neighbouring threads read
  // neighbouring addresses: the channel for NHWC, the column for
  // channel-major.
  for (int i = tid; i < cutdet::kRowsStaged * row_elems; i += nthreads) {
    const int sr = i / row_elems;
    const int rem = i - sr * row_elems;
    int sc, c;
    if constexpr (I::in_cm) {
      c = rem / kTileCols;
      sc = rem - c * kTileCols;
    } else {
      sc = rem / Cin;
      c = rem - sc * Cin;
    }
    const int y = 3 * r - 1 + sr;
    const int xc = col0 + sc;
    float v = 0.f;
    if (y >= 0 && y < H && xc >= 0 && xc < W) {
      const size_t at =
          I::in_cm ? (static_cast<size_t>(c) * H + y) * W + xc
                   : (static_cast<size_t>(y) * W + xc) * Cin + c;
      v = cutdet::operand<Op>(xb + at);
    }
    tile[(sr * kTileCols + sc) * Cin + c] = v;
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
    const typename I::w_t* wrow =
        w + static_cast<size_t>(dy * 3) * Cin * Cout + o;
    for (int c = 0; c < Cin; ++c) {
      // HWIO rows (dy*3 + dx)*Cin + c, dx = 0, 1, 2.
      const float w0 =
          cutdet::operand<Op>(wrow + static_cast<size_t>(c) * Cout);
      const float w1 =
          cutdet::operand<Op>(wrow + static_cast<size_t>(Cin + c) * Cout);
      const float w2 =
          cutdet::operand<Op>(wrow + static_cast<size_t>(2 * Cin + c) * Cout);
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
      m = fmaxf(m, cutdet::round_to<typename I::act_t>(z));
    }
  const size_t at =
      I::out_cm ? ((static_cast<size_t>(b) * Cout + o) * Hp + r) * Wp + px
                : ((static_cast<size_t>(b) * Hp + r) * Wp + px) * Cout + o;
  cutdet::store(out + at, cutdet::bn_affine(m, scale[o], offset[o]));
}

template <typename I>
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
  cudaError_t err = cutdet::allow_smem(conv_block_kernel<I>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_kernel<I><<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename I::in_t*>(x),
      static_cast<const typename I::w_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset),
      static_cast<typename I::out_t*>(out), H, W, Cin, Cout, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define CUTDET_CONV_BLOCK(NAME, INSTANCE)                                   \
  extern "C" int NAME(const void* x, const void* w, const void* bias,        \
                      const void* scale, const void* offset, void* out,      \
                      int B, int H, int W, int Cin, int Cout, void* stream) { \
    return launch<INSTANCE>(x, w, bias, scale, offset, out, B, H, W, Cin,    \
                            Cout, stream);                                   \
  }

CUTDET_CONV_BLOCK(cutdet_conv_block_f32, F32)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_out, Bf16Out)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_operands, Bf16Operands)
CUTDET_CONV_BLOCK(cutdet_conv_block_cm_bf16, CmBf16)
CUTDET_CONV_BLOCK(cutdet_conv_block_cm_f32, CmF32)
