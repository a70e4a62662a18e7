// Fused frame preprocess: bilinear resize + BGR->RGB + /255, from uint8 BGR.
//
// Replaces the Pallas kernel fused_resize_normalize
// (cut_detection_tpu/ops/pallas/preprocess_kernel.py).  That kernel casts
// the resize as two banded matmuls per (frame, channel),
// out = (R_h @ plane) @ R_w, with /255 folded into R_h and the flip in its
// output index map, on a planar transpose of the frames — all to feed the
// TPU's 128x128 matrix unit.  Each row of R_h and each column of R_w holds
// at most two nonzeros (the bilinear taps), so the host reduces both
// matrices to those (index, weight) pairs, read from the matrices as they
// are stored (border rows whose two taps clamp to one source row hold the
// merged weight), and the kernel does the two-tap sums directly.
//
// One thread per output (pixel, channel), reading the interleaved BGR
// frame as it arrives.  The vertical pass comes first, as in the matmul
// order:
//   r_j = wy0 * p[y0, j, c] + wy1 * p[y1, j, c]       for j in {x0, x1}
//   out[b, i, j', 2 - c] = r_x0 * wx0 + r_x1 * wx1    (f32 RGB NHWC)
//
// What bounds it on an H100: memory.  Each output element costs three
// multiplies and three FMAs against 4 bytes written and at most 4 read.
// At 1280x720 -> 256x144 a
// batch of 128 writes 56.6 MB of f32 and reads at most the 288 source rows
// its taps sample (128 * 288 * 1280 * 3 B = 141.6 MB; a 32-byte sector of a
// sampled row always holds a sampled pixel at this ratio, so all of those
// rows' bytes move): ~198 MB, about 0.06 ms at 3.35 TB/s.  The dense
// matmul form would read every source row and do ~138 GFLOP per batch.
// Neighbouring threads write neighbouring floats (coalesced); their reads
// fall in two source rows a few hundred bytes wide per warp, served by L1.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void resize_normalize_kernel(const uint8_t* __restrict__ x,
                                        const int2* __restrict__ row_idx,
                                        const float2* __restrict__ row_w,
                                        const int2* __restrict__ col_idx,
                                        const float2* __restrict__ col_w,
                                        float* __restrict__ out, int H, int W,
                                        int out_w, int per_frame) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // within a frame
  if (t >= per_frame) return;
  const int b = blockIdx.y;
  const int c = 2 - t % 3;  // BGR source channel of RGB output channel t % 3
  const int pix = t / 3;
  const int j = pix % out_w;
  const int i = pix / out_w;
  const int2 yi = row_idx[i];
  const float2 wy = row_w[i];
  const int2 xi = col_idx[j];
  const float2 wx = col_w[j];

  const uint8_t* frame = x + static_cast<size_t>(b) * H * W * 3;
  const uint8_t* r0 = frame + static_cast<size_t>(yi.x) * W * 3 + c;
  const uint8_t* r1 = frame + static_cast<size_t>(yi.y) * W * 3 + c;
  const float a0 = static_cast<float>(__ldg(r0 + 3 * xi.x));
  const float a1 = static_cast<float>(__ldg(r1 + 3 * xi.x));
  const float b0 = static_cast<float>(__ldg(r0 + 3 * xi.y));
  const float b1 = static_cast<float>(__ldg(r1 + 3 * xi.y));
  const float r_x0 = fmaf(wy.y, a1, wy.x * a0);
  const float r_x1 = fmaf(wy.y, b1, wy.x * b0);
  out[static_cast<size_t>(b) * per_frame + t] = fmaf(r_x1, wx.y, r_x0 * wx.x);
}

}  // namespace

extern "C" int cutdet_resize_normalize(const void* x, const void* row_idx,
                                       const void* row_w, const void* col_idx,
                                       const void* col_w, void* out, int B,
                                       int H, int W, int out_h, int out_w,
                                       void* stream) {
  const long long per_frame = 3LL * out_h * out_w;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || out_h <= 0 || out_w <= 0 ||
      per_frame > INT_MAX - 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((per_frame + kThreads - 1) / kThreads),
                  B);
  resize_normalize_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int2*>(row_idx),
      static_cast<const float2*>(row_w), static_cast<const int2*>(col_idx),
      static_cast<const float2*>(col_w), static_cast<float*>(out), H, W,
      out_w, static_cast<int>(per_frame));
  return static_cast<int>(cudaGetLastError());
}
