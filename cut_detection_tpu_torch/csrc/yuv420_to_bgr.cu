// Planar YUV420 -> BGR24, exact with swscale's same-size converter.
//
// Replaces the conversion the JAX package leaves to XLA
// (cut_detection_tpu/ops/yuv.py:79, yuv420_to_bgr): not a Pallas kernel,
// but on the card PyTorch has no fusion for it, and its plain version
// (ops/yuv.py) makes a dozen int32 passes over every pixel.  The
// arithmetic is ops/yuv.py's: per chroma sample
//   bu = (132201 * (u - 128)) >> 16
//   gu = (-25671 * (u - 128)) >> 16,  gv = (-53279 * (v - 128)) >> 16
//   rv = (104597 * (v - 128)) >> 16
// per luma pixel ly = (76309 * (y - 16) + 512) >> 16, and
//   B = clip8(ly + bu), G = clip8(ly + gu + gv), R = clip8(ly + rv),
// the chroma sample shared by its 2x2 luma block (nearest upsample).
// '>>' on a signed int is an arithmetic shift in CUDA, so it floors as
// numpy's and torch's int32 shifts do.  Integer arithmetic only.
//
// Layout: x is [B, H*W + 2*(H/2)*(W/2)] uint8 (Y plane, then U, then V,
// tight), out is [B, H, W, 3] uint8 BGR, NHWC (the uint8 input of
// layer 1's kernel).  Even H and W, an even base address (the wrapper
// refuses the rest).
//
// What bounds it on an H100: memory.  A batch of 128 at 144x256 reads
// 7,077,888 bytes and writes 14,155,776, about 0.0063 ms at 3.35 TB/s;
// a few integer operations a byte are far below the ALU rate.  The first
// design gave a thread one 2x2 luma block (16 bytes moved, twelve 1-byte
// stores: each warp store wrote 32 bytes spread over 192, about 440k of
// them a batch).  This one gives a thread a strip of two rows by 16
// pixels, which share 8 chroma samples:
// - two 16-byte Y loads and one 8-byte load each of U and V, issued
//   before any arithmetic (48 bytes in flight a thread, a warp's loads
//   contiguous);
// - the 8 chroma terms computed once and packed as signed 16-bit pairs
//   in the order the BGR bytes leave, so two pixels take three paired
//   add-and-clamps (Hopper's DPX __viaddmin_s16x2_relu: max(min(a + b,
//   255), 0) on each half) and every output word one byte permute;
// - the 96 bytes staged in shared memory (16-byte stores at a 48-byte
//   stride, conflict-free) and written out by the warp as contiguous
//   16-byte stores (direct 16-byte stores at a 48-byte stride touch 48
//   sectors a warp store, half of each, and ran slower).
// Threads run over strips along x (blockIdx.x), row pairs along y and
// frames along z: no division.  With W % 16 == 0 the frame stride
// 1.5*H*W is a multiple of 16, so one check of the two base addresses
// holds for every frame.  A width off 16 or a base off 16 takes the
// first design's scalar 2x2 code for each block of each strip, in the
// other instance of the same kernel; the main path's 144x256 runs the
// vector instance only.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, batch
// 128 at 144x256, with the calls queued behind a sleep on the card so
// that the host stays ahead: 0.0069 ms a call (92% of the bound), 0.0097
// from cold L2 (65%; a PyTorch clone moving the same bytes 0.0104); in
// the step's trace 0.0072 ms a batch, where the first design took
// 0.0170.  The wrapper takes 0.018-0.029 ms a call on the host, more
// than this kernel, so calls streamed back to back without that queue
// run at the host's pace; the first design streamed at 0.0232 ms a
// call, about 0.017 of it its own.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 16;     // pixels of each of a thread's two rows
constexpr int kThreads = 128;  // a block's threads

// The 16.16 constants of ops/yuv.py; luma folds the -16 into its bias.
constexpr int kLy = 76309, kLyBias = 512 - 16 * kLy;
constexpr int kBu = 132201, kGu = -25671, kGv = -53279, kRv = 104597;

__device__ __forceinline__ int luma(int y) {
  return (kLy * y + kLyBias) >> 16;
}

__device__ __forceinline__ uint8_t clip8(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// Byte i of w, zero-extended.
__device__ __forceinline__ int byte_of(unsigned w, int i) {
  return static_cast<int>(__byte_perm(w, 0, 0x4440 | i));
}

// The low halfwords of a (low half) and b (high half).
__device__ __forceinline__ unsigned pair(int a, int b) {
  return __byte_perm(static_cast<unsigned>(a), static_cast<unsigned>(b),
                     0x5410);
}

// clip8(a + b) on each signed halfword, in one DPX instruction.
__device__ __forceinline__ unsigned add_clip2(unsigned a, unsigned b) {
  return __viaddmin_s16x2_relu(a, b, 0x00ff00ffu);
}

// The chroma terms of one (u, v) sample: B, G and R's.
struct Chroma {
  int bu, guv, rv;
};

__device__ __forceinline__ Chroma chroma(int u, int v) {
  u -= 128;
  v -= 128;
  return {(kBu * u) >> 16, ((kGu * u) >> 16) + ((kGv * v) >> 16),
          (kRv * v) >> 16};
}

// The same as the three halfword pairs its two pixels' BGR bytes need:
// (bu, guv), (rv, bu) and (guv, rv).
struct ChromaPairs {
  unsigned a, b, c;
};

__device__ __forceinline__ ChromaPairs chroma_pairs(int u, int v) {
  const Chroma c = chroma(u, v);
  return {pair(c.bu, c.guv), pair(c.rv, c.bu), pair(c.guv, c.rv)};
}

// One row of a strip: 16 luma bytes in y, pixels 2k and 2k + 1 sharing
// chroma c[k]; writes the 48 BGR bytes to o (16-aligned).
__device__ __forceinline__ void convert_row(const uint4& y,
                                            const ChromaPairs (&c)[8],
                                            uint8_t* o) {
  const unsigned yw[4] = {y.x, y.y, y.z, y.w};
  unsigned w[12];
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    // Pixels 2k .. 2k + 3: six halfword pairs, 12 bytes, three words.
    unsigned q[6];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 2 * (k + h);
      const int l0 = luma(byte_of(yw[p >> 2], p & 3));
      const int l1 = luma(byte_of(yw[p >> 2], (p & 3) + 1));
      q[3 * h] = add_clip2(pair(l0, l0), c[k + h].a);      // B, G of p
      q[3 * h + 1] = add_clip2(pair(l0, l1), c[k + h].b);  // R p, B p + 1
      q[3 * h + 2] = add_clip2(pair(l1, l1), c[k + h].c);  // G, R of p + 1
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[3 * k / 2 + j] = __byte_perm(q[2 * j], q[2 * j + 1], 0x6420);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(o);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  dst[2] = make_uint4(w[8], w[9], w[10], w[11]);
}

// The scalar route: one 2x2 luma block at y0 (its top-left pixel), its
// chroma u and v, its output at o (top-left pixel's B byte).
__device__ __forceinline__ void convert_block(const uint8_t* y0, int W,
                                              int u, int v, uint8_t* o) {
  // W is even and so is every base, so each Y pair is 2-aligned.
  const uchar2 top = __ldg(reinterpret_cast<const uchar2*>(y0));
  const uchar2 bottom = __ldg(reinterpret_cast<const uchar2*>(y0 + W));
  const Chroma c = chroma(u, v);
  const int ly[4] = {luma(top.x), luma(top.y), luma(bottom.x),
                     luma(bottom.y)};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint8_t* px = o + (p / 2) * static_cast<size_t>(W) * 3 + 3 * (p % 2);
    px[0] = clip8(ly[p] + c.bu);
    px[1] = clip8(ly[p] + c.guv);
    px[2] = clip8(ly[p] + c.rv);
  }
}

// kVec: W % 16 == 0 and x and out 16-aligned, so every frame's Y, U, V
// and output rows are aligned for the vector accesses.  A block is bx
// strips (a power of two, at most 32) by `by` row pairs, so each warp
// holds 32 / bx whole row pairs of it: the warp converts its strips into
// its own 3 KB of the tile in shared memory, then writes those rows out
// as 16-byte stores, one contiguous run where the block spans whole rows
// and one run a row otherwise.  No block barrier: warps go at their own
// pace.  Without kVec each strip takes the scalar route, its 2x2 blocks
// one by one, straight to the output.  Frames run along z.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    yuv420_to_bgr_kernel(const uint8_t* __restrict__ x,
                         uint8_t* __restrict__ out, int H, int W) {
  __shared__ __align__(16) uint8_t tile[kVec ? kThreads * 2 * 3 * kStrip
                                             : 16];
  const int bx = blockDim.x, by = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z;
  const int cw = W / 2;
  const size_t luma_size = static_cast<size_t>(H) * W;
  const size_t chroma_size = static_cast<size_t>(H / 2) * cw;
  const size_t row3 = static_cast<size_t>(W) * 3;
  const uint8_t* frame = x + b * (luma_size + 2 * chroma_size);
  // The block's first column and the pixels it spans in each row.
  const long long bx0 = static_cast<long long>(blockIdx.x) * bx * kStrip;
  const int span = static_cast<int>(min(static_cast<long long>(bx) * kStrip,
                                        W - bx0));
  const int x0 = static_cast<int>(bx0) + tx * kStrip;  // when tx < span / 16
  const bool in_row = tx * kStrip < span;
  // Row pairs (chroma rows) in a grid-stride loop over y.
  for (int cr0 = blockIdx.y * by; cr0 < H / 2; cr0 += gridDim.y * by) {
    const int cr = cr0 + ty;
    const bool live = in_row && cr < H / 2;
    const uint8_t* y0 = frame + static_cast<size_t>(2 * cr) * W + x0;
    const uint8_t* u = frame + luma_size + static_cast<size_t>(cr) * cw +
                       x0 / 2;
    const uint8_t* v = u + chroma_size;
    if (kVec) {
      // The tile holds the block's rows, bx * 48 bytes each.
      uint8_t* row_tile = tile + 2 * ty * (bx * 3 * kStrip);
      if (live) {
        const uint4 ya = __ldg(reinterpret_cast<const uint4*>(y0));
        const uint4 yb = __ldg(reinterpret_cast<const uint4*>(y0 + W));
        const uint2 uu = __ldg(reinterpret_cast<const uint2*>(u));
        const uint2 vv = __ldg(reinterpret_cast<const uint2*>(v));
        ChromaPairs c[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          c[k] = chroma_pairs(byte_of(k < 4 ? uu.x : uu.y, k & 3),
                              byte_of(k < 4 ? vv.x : vv.y, k & 3));
        }
        convert_row(ya, c, row_tile + tx * 3 * kStrip);
        convert_row(yb, c, row_tile + (bx + tx) * 3 * kStrip);
      }
      __syncwarp();
      // The warp's rows, from its first row pair wr0 within the block's:
      // 2 a live row pair, `seg` 16-byte words each.
      const int lane = (ty * bx + tx) % 32;
      const int pairs = 32 / bx;
      const int wr0 = (ty * bx + tx) / 32 * pairs;
      const int rows = 2 * max(0, min(pairs, H / 2 - cr0 - wr0));
      const int seg = span * 3 / 16;
      const uint4* src =
          reinterpret_cast<const uint4*>(tile) + 2 * wr0 * bx * 3;
      uint8_t* dst = out + (static_cast<size_t>(b) * H + 2 * (cr0 + wr0)) *
                               row3 + static_cast<size_t>(bx0) * 3;
      if (static_cast<size_t>(seg) * 16 == row3 && seg == bx * 3) {
        uint4* d = reinterpret_cast<uint4*>(dst);
        for (int i = lane; i < rows * seg; i += 32) d[i] = src[i];
      } else {
        for (int r = 0; r < rows; ++r) {
          uint4* d = reinterpret_cast<uint4*>(dst + r * row3);
          for (int i = lane; i < seg; i += 32) d[i] = src[r * bx * 3 + i];
        }
      }
      __syncwarp();  // before the next row pairs overwrite the tile
    } else if (live) {
      uint8_t* o0 = out + (static_cast<size_t>(b) * H + 2 * cr) * row3 +
                    static_cast<size_t>(x0) * 3;
      for (int j = 0; j < kStrip / 2 && 2 * j < W - x0; ++j) {
        convert_block(y0 + 2 * j, W, __ldg(u + j), __ldg(v + j), o0 + 6 * j);
      }
    }
  }
}

}  // namespace

extern "C" int cutdet_yuv420_to_bgr(const void* x, void* out, int B, int H,
                                    int W, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 2 || W % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A block covers bx strips of by row pairs: bx the strips of a row
  // rounded up to a power of two, at most a warp's 32.
  const int strips = (W + kStrip - 1) / kStrip;
  int bx = 1;
  while (bx < strips && bx < 32) bx *= 2;
  const int by = kThreads / bx;
  const int row_blocks = (H / 2 + by - 1) / by;
  const dim3 grid((strips + bx - 1) / bx, row_blocks < 65535 ? row_blocks
                                                             : 65535, B);
  const dim3 block(bx, by);
  const bool vec = W % kStrip == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(x);
  auto* bgr = static_cast<uint8_t*>(out);
  if (vec) {
    yuv420_to_bgr_kernel<true><<<grid, block, 0, s>>>(in, bgr, H, W);
  } else {
    yuv420_to_bgr_kernel<false><<<grid, block, 0, s>>>(in, bgr, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
