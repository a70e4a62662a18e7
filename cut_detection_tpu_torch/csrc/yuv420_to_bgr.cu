// Planar YUV420 -> BGR24, exact with swscale's same-size converter.
//
// Replaces the conversion the JAX package leaves to XLA
// (cut_detection_tpu/ops/yuv.py, yuv420_to_bgr): not a Pallas kernel, but
// on the card PyTorch has no fusion for it, and its plain version
// (ops/yuv.py) makes a dozen int32 passes over every pixel.  The
// arithmetic is ops/yuv.py's: per chroma sample
//   bu = (132201 * (u - 128)) >> 16
//   gu = (-25671 * (u - 128)) >> 16,  gv = (-53279 * (v - 128)) >> 16
//   rv = (104597 * (v - 128)) >> 16
// per luma pixel ly = (76309 * (y - 16) + 512) >> 16, and
//   B = clip8(ly + bu), G = clip8(ly + gu + gv), R = clip8(ly + rv),
// the chroma sample shared by its 2x2 luma block (nearest upsample).
// '>>' on a signed int is an arithmetic shift in CUDA, so it floors as
// numpy's and torch's int32 shifts do.
//
// Layout: x is [B, H*W + 2*(H/2)*(W/2)] uint8 (Y plane, then U, then V,
// tight), out is [B, H, W, 3] uint8 BGR, NHWC (the uint8 input of
// layer 1's kernel).  Even H and W only (the wrapper refuses odd ones).
//
// One thread per 2x2 luma block: it reads two 2-byte Y pairs, one U and
// one V byte, computes the chroma terms once and the luma term per
// pixel, and writes two rows of 6 bytes.  What bounds it on an H100:
// memory.  A batch of 128 at 144x256 reads 7,077,888 bytes and writes
// 14,155,776, about 0.0063 ms at 3.35 TB/s; a handful of integer
// operations a byte is far below the ALU rate.  Neighbouring threads
// read neighbouring Y pairs and write neighbouring 6-byte groups, so a
// warp's accesses fall in a few contiguous runs of each row.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint8_t clip8(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

__device__ __forceinline__ int luma(int y) {
  return (76309 * (y - 16) + 512) >> 16;
}

__global__ void yuv420_to_bgr_kernel(const uint8_t* __restrict__ x,
                                     uint8_t* __restrict__ out, int H, int W,
                                     int blocks_per_frame) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // within a frame
  if (t >= blocks_per_frame) return;
  const int b = blockIdx.y;
  const int cw = W / 2;
  const int ci = t / cw;  // chroma row
  const int cj = t % cw;  // chroma column
  const size_t luma_size = static_cast<size_t>(H) * W;
  const size_t chroma_size = static_cast<size_t>(H / 2) * cw;
  const uint8_t* frame = x + static_cast<size_t>(b) *
                                 (luma_size + 2 * chroma_size);
  // W is even and a frame's size is even, so each Y pair is 2-aligned.
  const uchar2* y0 = reinterpret_cast<const uchar2*>(
      frame + static_cast<size_t>(2 * ci) * W + 2 * cj);
  const uchar2* y1 = reinterpret_cast<const uchar2*>(
      reinterpret_cast<const uint8_t*>(y0) + W);
  const uchar2 top = __ldg(y0);
  const uchar2 bottom = __ldg(y1);
  const int u = static_cast<int>(__ldg(frame + luma_size + t)) - 128;
  const int v =
      static_cast<int>(__ldg(frame + luma_size + chroma_size + t)) - 128;
  const int bu = (132201 * u) >> 16;
  const int guv = ((-25671 * u) >> 16) + ((-53279 * v) >> 16);
  const int rv = (104597 * v) >> 16;

  const int ly[4] = {luma(top.x), luma(top.y), luma(bottom.x),
                     luma(bottom.y)};
  uint8_t* row0 = out + ((static_cast<size_t>(b) * H + 2 * ci) * W + 2 * cj)
                            * 3;
  uint8_t* rows[2] = {row0, row0 + static_cast<size_t>(W) * 3};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint8_t* o = rows[p / 2] + 3 * (p % 2);
    o[0] = clip8(ly[p] + bu);
    o[1] = clip8(ly[p] + guv);
    o[2] = clip8(ly[p] + rv);
  }
}

}  // namespace

extern "C" int cutdet_yuv420_to_bgr(const void* x, void* out, int B, int H,
                                    int W, void* stream) {
  const long long blocks = static_cast<long long>(H / 2) * (W / 2);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 2 || W % 2 ||
      blocks > INT_MAX - 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((blocks + kThreads - 1) / kThreads),
                  B);
  yuv420_to_bgr_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), H, W,
      static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}
