// CNN block, fused: conv3x3 (zero pad 1) + bias -> ReLU -> maxpool 3x3
// stride 3 (floor) -> eval-BN affine, for every layer of the net.
//
// Replaces four Pallas kernels: fused_conv_block_pm
// (cut_detection_tpu/ops/pallas/fused_block_pm.py, NHWC, K3) and
// fused_conv_block (cut_detection_tpu/ops/pallas/fused_conv_block.py,
// channel-major, K4) at the mid-stack layers; conv1_pool_fused
// (cut_detection_tpu/ops/pallas/conv1_kernel.py, K2) and fused_conv1_pool
// (cut_detection_tpu/ops/pallas/fused_conv1.py, K1) at layer 1, from raw
// uint8 BGR and the preprocess-folded kernel.  One source, templated on
// the types of the input, the weights and the output, on the epilogue
// (common.cuh: what is rounded to bf16 after the conv, and the BN's form)
// and on the layouts of the input and the output: NHWC, or channel-major
// [B, C, H, W].  Instances (cutdet_conv_block_*):
//   f32            f32 operands and accumulation on the CUDA cores — the
//                  float32 path (layers 2 and 3 of the prod net);
//   bf16_operands  f32 input and weights rounded to bf16 as they are
//                  staged, f32 accumulation, f32 activations with no
//                  rounding, f32 output — the bfloat16 rung;
//   bf16_xla       bf16 in, XLA's bfloat16_full epilogue (a bf16 rounding
//                  after every op), bf16 out — the bfloat16_full rung;
//   bf16_out       bf16 in, the Pallas kernel's numerics: relu(acc + bias)
//                  rounded to bf16 before the pool, f32 BN, bf16 out;
//   cm_bf16        fused_conv_block's numerics (bf16_out's) with
//   cm_f32         channel-major input and output, bf16 or f32 out.
// and at layer 1, uint8 in (cutdet_conv1_block*; uint8 is exact in f32
// and in bf16, so widening it rounds nothing):
//   f32 (U8F32)    K2: f32 weights and accumulation, on the CUDA cores —
//                  layer 1 of float32, and of bfloat16 on bf16-rounded
//                  weights (that rung's exact numerics);
//   bf16 (U8Bf16)  K1's numerics: bf16 weights, f32 accumulation,
//                  relu(acc + bias) rounded to bf16, f32 BN, bf16 out —
//                  the bench's K1 graphs;
//   bf16_xla       XLA's bfloat16_full epilogue — layer 1 of that rung.
// and the int8_mxu block, which the JAX package leaves to XLA
// (cut_detection_tpu/models/layers.py:229, apply_conv_block_i8; its conv
// cut_detection_tpu/ops/nn.py:73, conv2d_same_i8), on s8 wgmma with exact
// int32 sums (cutdet_conv_block_i8, cutdet_conv1_block_i8):
//   i8 (I8)        int8 codes in, int8 weights; per conv pixel z = f32(sum)
//                  * so + ring (the ring varies by pixel, so this comes
//                  before the pool); the window's largest z to its code
//                  clip(rint(relu(z) / scale) - 128, -128, 127) — the
//                  mid-stack blocks of int8_mxu;
//   i8 (U8I8)      the same from raw uint8 BGR, shifted by -128 as it is
//                  packed (the shift's constant lives in the ring) —
//                  layer 1 of int8_mxu.
// And the stage bisection of layer 1 (cutdet_conv1_stages, conv1_stages<S>
// in namespace stages): conv1_block_mma's chain cut after each step, on
// the planar input of scripts/profile_fused_conv1.py's _kernel, which it
// replaces.
// The int8 codes equal the plain version's (ops/kernels/conv_block_i8.py)
// with a max diff of 0: the sums are exact (|sum| <= 432 * 128 * 127 <
// 2^24 at the prod widths, so f32(sum) is exact too) and the f32 steps
// round as its torch ops, in its order.
// Floor pooling at any H: pooled row r reads conv rows 3r..3r+2, which
// read input rows 3r-1..3r+3, so the last pooled row reads input row
// h_eff = 3*(H/3) and nothing below it; where h_eff == H that row is the
// zero padding.
//
// What bounds it on an H100: at the prod layer-2 shape (48x85x48 ->
// 16x28x48) a frame needs 48*84 conv pixels x 9*48*48 MACs (~84 M MAC)
// against ~0.4 MB of bf16 input (0.8 MB in f32).  In bf16 on the tensor
// cores (989 TFLOP/s) that is ~0.02 ms a batch of 128 — about the time to
// read the input once, so neither side dominates and a kernel that keeps
// both the tensor cores and the loads busy wins.  In f32 on the CUDA cores
// (67 TFLOP/s) the FMAs bound it at ~0.32 ms a batch.  Layer 1 (144x256x3
// -> 48x85x48) does 27 MACs per conv pixel and output channel: ~0.18 ms of
// f32 FMAs a batch, but in bf16 its bytes (110 KB of uint8 in, 0.4 MB of
// bf16 out a frame) bound it at ~0.02 ms, and its 6,144 items a batch
// (3x layer 2's) make the staging and the epilogue the work to hide.  In
// int8 (1,979 TOPS) layer 2 is 21.4 G operations a batch, 0.0108 ms,
// against 25.1 MB in and 2.8 MB out (0.0083 ms); layer 1 is bound by its
// bytes, 14.2 MB in and 25.1 MB of codes out (0.0117 ms).
//
// The design, for both routes: persistent blocks, about one per SM, each
// walking work items (frame, pooled row).  A block stages its weights in
// shared memory once, not once per item, and each item's five input rows
// whole (all of W, zero-padded, so any H and W >= 3 work).  Where the
// weights of all Cout do not fit, the output channels are split into
// groups (blockIdx.y), each block holding one group's.
//
// bf16-operand instances (conv_block_mma): an implicit GEMM on wgmma,
// M = conv pixels, N = Cout (32, 48 or 64 a group), K = 9 * Cin ordered
// (dy, dx, c) with Cin zero-padded to 16 per tap.  An M tile of 64 rows is
// a 3 x 21 band of conv pixels (7 pool windows) plus one pad row; each
// consumer warpgroup takes the item's tiles in turn (Wp = 28 is exactly
// 4, one each).  B, the weights, sits in shared memory in wgmma's K-major
// no-swizzle layout.  A comes from registers: each lane gives ldmatrix.x4
// the address of its own conv pixel shifted by (dy, dx), so the im2col is
// an address and is never written; a pixel's staged stride is Cin + 8
// channels, an odd number of 16-byte units, so an ldmatrix's eight row
// addresses hit eight bank groups.  The k16 steps go in groups of three,
// two groups in flight (A in two register sets), with no wgmma under a
// branch.  After the last step the 64 x N f32 accumulators go to shared
// memory, and 7 x N threads each take the max of their window's nine
// values through the instance's epilogue and store it, coalesced over
// channels (NHWC) or columns (channel-major).  Staging: bf16 NHWC input
// is copied by cp.async, 16 bytes a thread, by a producer warpgroup into
// a double buffer while the consumers run the previous item; f32 input
// (rounded to bf16 as it is staged) and channel-major input (transposed)
// pass through registers, which is latency-bound, so there every thread
// of the block stages, between items, issuing all its loads before it
// uses any loaded value.
//
// int8 on the same route: k32 steps, whose A fragment is bf16's k16 one
// byte for byte, so the same ldmatrix.x4 at shifted pixel addresses loads
// it.  K is ordered (dy, then the 3 * ps contiguous bytes of the kernel
// row's three staged pixels): with ps = Cin = 48 bytes (three 16-byte
// units, an odd number) a row is five k32 steps and a tile 15, where 16
// channels a tap would take 18; the fifth step's last 16 bytes read the
// next pixel and meet zero weights (16 bytes of slack past the buffer).
// Other Cin pad the stride to an odd number of 16-byte units with zero
// channels.  The producer stages int8 NHWC rows by cp.async of 16 bytes
// (4 where Cin % 16 or the input's alignment rules 16 out).  The int32
// accumulators go through the same scratch; the pool's thread takes 4
// channels of a window, z of each of its nine pixels (the ring read as
// float4, coalesced over channels), the max, the codes, one word a store.
//
// Layer 1 (conv1_block_mma, uint8 BGR, 3 channels).  Padding each tap to
// 16 k would leave 19% of K useful, so the taps are packed: a pixel's
// B column holds its three dx columns x 3 channels (k = dx * 3 + c) and
// K is 3 k16 steps, one per dy.  Layer 1 has 9x layer 2's outputs a
// batch, and the band's round trip of the accumulators through shared
// memory to the pool would cost more than the MMAs, so here M is the
// output channels (64 a group; the weights stay in registers as A for
// the whole kernel) and N the 72 conv pixels of 8 pool windows, ordered
// so that each thread's accumulators hold whole windows: the pool is a
// max over its registers.  Each warpgroup walks its own items: it copies
// an item's raw rows two items ahead (cp.async), packs each N tile's B
// from them and runs it, with one warpgroup barrier a tile and none
// across the block.  int8 takes the same tile in bytes: three k32 steps,
// one per dy, of a pixel's 9 bytes (dx, c), shifted by xor 0x80 as they
// are packed (the frame's pads hold 0x80, so the 'same' padding is int8
// 0); N = 80, the nearest s8 width (72 is none), its last 8 columns
// unused.  One k32 step holding a pixel's whole 3 x 3 x 3 window (27 of
// 32 bytes) was measured slower at 8 and 16 windows a tile: each B column
// then gathers three runs of three raw rows, and 16 windows take 72
// accumulators a thread, too many registers for five warpgroups.  The
// ring varies by pixel, so the epilogue takes z = f32(sum) * so + ring
// before the max, except where a window's nine pixels share one ring
// value (all but the frame's edges) and so >= 0: z is then nondecreasing
// in the sum, and the max of the nine sums is dequantized once.  The
// ring's interior row sits in shared memory, once per block.
//
// f32 (conv_block_fma): register-blocked FMAs.  Each thread owns 4 output
// channels x 1 pooled column (9 conv outputs x 4 = 36 accumulators), and
// a block runs as many items at once as fill its 384 threads (one at
// layer 2, three at layer 3).  Weights are staged (cp.async) as
// [dy][dx][c][Cout] so a thread's 4 channels are one float4, pixels as
// [row][column][c] (stride Cin + 4, so neighbouring threads' columns fall
// in other banks); per (dy, 4 input channels) a thread loads 12 weight
// and 15 pixel float4s for 432 FMAs.  Layer 1 (uint8, conv1_rounds): a
// thread holds the 5 x 5 pixels x 3 channels under one pool window in
// registers and walks the output channels four at a time, 27 weight
// float4s (one address across the warp) for 972 FMAs, none on a fourth,
// zero channel; the raw rows are copied a round ahead and each item's
// output, gathered in shared memory, leaves by one bulk (TMA) copy.
// Summation stays f32 fmaf, in another order than the plain version.
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using cutdet::bf16;
using cutdet::Epilogue;

constexpr int kBandCols = 21;                 // conv columns of an M tile
constexpr int kBandWindows = kBandCols / 3;   // pool windows of an M tile
// Layer 1 on the tensor cores: output channels on M (64 a group), the
// conv pixels of 8 pool windows on N (72 = 3 conv rows x 24 columns; in
// int8 N = 80, the nearest s8 width, its last 8 columns unused).
constexpr int kConv1Windows = 8;
constexpr int kConv1Cols = 3 * kConv1Windows;
constexpr int kConv1NI8 = 80;
constexpr int kConv1Warpgroups = 5;  // layer 1's tensor-core blocks
constexpr int kTileRows = 64;                 // wgmma M
constexpr int kMaxWarpgroups = 4;
constexpr int kFmaThreads = 384;
constexpr size_t kSmemLimit = 227 * 1024;

template <typename In, typename Wt, Epilogue E, typename Out,
          bool InChannelMajor = false, bool OutChannelMajor = false>
struct Instance {
  using in_t = In;
  using w_t = Wt;
  static constexpr Epilogue epi = E;
  using out_t = Out;
  static constexpr bool in_cm = InChannelMajor;
  static constexpr bool out_cm = OutChannelMajor;
};

using F32 = Instance<float, float, Epilogue::kF32, float>;
using Bf16Operands = Instance<float, float, Epilogue::kF32, float>;
using Bf16Xla = Instance<bf16, bf16, Epilogue::kXla, bf16>;
using Bf16XlaF32 = Instance<bf16, bf16, Epilogue::kXla, float>;
using Bf16Out = Instance<bf16, bf16, Epilogue::kRoundAct, bf16>;
using CmBf16 = Instance<bf16, bf16, Epilogue::kRoundAct, bf16, true, true>;
using CmF32 = Instance<bf16, bf16, Epilogue::kRoundAct, float, true, true>;
// Layer 1 from raw uint8 BGR (conv1_block): K2's numerics, K1's, XLA's.
using U8F32 = Instance<uint8_t, float, Epilogue::kF32, float>;
using U8Bf16 = Instance<uint8_t, bf16, Epilogue::kRoundAct, bf16>;
using U8Bf16Xla = Instance<uint8_t, bf16, Epilogue::kXla, bf16>;
// The int8_mxu block: int8 codes (layer 1: raw uint8 BGR, shifted by -128
// as it is packed) and int8 weights, exact int32 sums on s8 wgmma, the kI8
// epilogue, int8 codes out.
using I8 = Instance<int8_t, int8_t, Epilogue::kI8, int8_t>;
using U8I8 = Instance<uint8_t, int8_t, Epilogue::kI8, int8_t>;

template <typename I>
constexpr bool kU8 = std::is_same_v<typename I::in_t, uint8_t>;
template <typename I>
constexpr bool kI8 = I::epi == Epilogue::kI8;

inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

// Blocks of the persistent grid in x, for ``groups`` output-channel
// groups in y: as many as fit on the card at once, at most one per item.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, int items,
                      int groups) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int total = sm_count() * (per_sm > 0 ? per_sm : 1);
  const int per_group = total / groups > 0 ? total / groups : 1;
  return per_group < items ? per_group : items;
}

// What both kernels know of the shapes.
struct Shape {
  int H, W, Cin, Cout, Hp, Wp;
  int items;  // B * Hp work items (frame, pooled row)
};

// ---------------------------------------------------------------------
// Staging helpers.

// ``store(i, load(i))`` for i in [t, total) step nt, with U loads in
// flight per thread before their stores (the loads' latency, not their
// bytes, bounds a staging loop).
template <int U, typename Load, typename Store>
__device__ __forceinline__ void unrolled(int total, int t, int nt, Load load,
                                         Store store) {
  for (int i0 = t; i0 < total; i0 += nt * U) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt;
      if (i < total) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt;
      if (i < total) store(i, v[u]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Layer 1's raw rows: an item's five input rows of uint8 BGR, input row
// 3r - 1 + sr at byte sr * rs of ``raw``, input column xc at byte 16 + 3
// * xc, with zeros left and right of the frame (the caller zeroes bytes
// [0, 16) and [16 + 3W, rs) of each row once) and for rows outside it.
constexpr int kRawLead = 16;

// Set the bytes of ``rows`` raw rows outside the frame's columns to
// ``fill``: 0, or 0x80 where the packing shifts bytes by -128.
__device__ void zero_raw_pads(unsigned char* raw, int rows, int rs, int W,
                              int t, int nt, unsigned char fill = 0) {
  const int tail = rs - kRawLead - 3 * W;
  for (int i = t; i < rows * (kRawLead + tail); i += nt) {
    const int row = i / (kRawLead + tail), e = i - row * (kRawLead + tail);
    raw[row * rs + (e < kRawLead ? e : 3 * W + e)] = fill;
  }
}

// Copy an item's raw rows (frame rows outside [0, H) as zeros): by 16-byte
// cp.async where every row is 16-byte aligned (``vec``; the caller commits
// and waits), else byte by byte through registers.
__device__ void copy_rows(const uint8_t* __restrict__ x, unsigned char* raw,
                          int item, const Shape& s, int rs, bool vec, int t,
                          int nt) {
  const int b = item / s.Hp, r = item - b * s.Hp;
  const int row = 3 * s.W;
  const uint8_t* xb = x + static_cast<size_t>(b) * s.H * row;
  if (vec) {
    const uint32_t base = static_cast<uint32_t>(
        __cvta_generic_to_shared(raw + kRawLead));
    const int chunks = row / 16;
    for (int i = t; i < cutdet::kRowsStaged * chunks; i += nt) {
      const int sr = i / chunks, ch = i - sr * chunks;
      const int y = 3 * r - 1 + sr;
      const bool ok = y >= 0 && y < s.H;
      cutdet::cp_async16(base + sr * rs + ch * 16,
                         ok ? xb + y * row + ch * 16 : xb, ok);
    }
    return;
  }
  unrolled<8>(
      cutdet::kRowsStaged * row, t, nt,
      [&](int i) {
        const int y = 3 * r - 1 + i / row;
        return y >= 0 && y < s.H ? __ldg(xb + (3 * r - 1) * row + i)
                                 : static_cast<unsigned char>(0);
      },
      [&](int i, unsigned char v) {
        raw[(i / row) * rs + kRawLead + i % row] = v;
      });
}

// Two uint8 values (byte ka of wa, byte kb of wb) as a bf16 pair, exactly:
// 0x4B0000vv is the float 2^23 + v, so one subtraction gives v as a float,
// whose top 16 bits are its bf16 (v has at most 8 significant bits).
__device__ __forceinline__ uint32_t u8_pair_bf16(uint32_t wa, int ka,
                                                 uint32_t wb, int kb) {
  const float a = __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7540 | ka));
  const float b = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7540 | kb));
  return __byte_perm(__float_as_uint(a - 8388608.f),
                     __float_as_uint(b - 8388608.f), 0x7632);
}

// ---------------------------------------------------------------------
// Tensor-core route.

// How an item is staged: 16-byte cp.async of bf16 NHWC rows (kCopy);
// float4 loads of f32 NHWC rows rounded to bf16 (kF32x4); element by
// element, for channel-major input (transposed) or a Cin the vectors do
// not divide (kElement).
enum class Staging { kCopy, kF32x4, kElement };

struct MmaPlan {
  Shape s;
  int cpad;    // bf16: Cin rounded up to 16
  int ps;      // staged pixel stride, elements: bf16 cpad + 8; int8 an odd
               // number of 16-byte units >= Cin
  int kc;      // k steps per tap (bf16, k16) or per kernel row (int8, k32)
  int steps;   // k steps: 9 * kc (bf16), 3 * kc (int8)
  int chunk;   // int8: bytes a cp.async stages (16, or 4 where the input's
               // channels or alignment rule 16 out)
  int tiles;   // M tiles per item
  int wst;     // staged columns: 21 * tiles + 2
  int nwg;     // consumer warpgroups per block (one more stages)
  int nbuf;    // staged items: 2 (double buffer) or 1
  Staging staging;
  bool wvec;   // weights read 8 output channels at a time
  uint32_t w_bytes, off_bytes, scratch_bytes, buf_bytes;
};

// Stage item ``item``'s five input rows, all columns (staged column 0 is
// input column -1), as bf16 [row][column][ps] with zeros outside the
// input and in channels >= Cin; run by the producer's ``nt`` threads.
template <typename I>
__device__ void stage_mma(const typename I::in_t* __restrict__ x,
                          unsigned char* dst, int item, const MmaPlan& p,
                          int t, int nt) {
  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  const typename I::in_t* xb = x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const int y0 = 3 * r - 1;
  bf16* out = reinterpret_cast<bf16*>(dst);
  if constexpr (!I::in_cm && std::is_same_v<typename I::in_t, bf16>) {
    if (p.staging == Staging::kCopy) {
      const uint32_t base =
          static_cast<uint32_t>(__cvta_generic_to_shared(dst));
      const int chunks = p.cpad / 8;
      const int total = cutdet::kRowsStaged * p.wst * chunks;
      for (int i = t; i < total; i += nt) {
        const int ch = i % chunks;
        const int rest = i / chunks;
        const int col = rest % p.wst;
        const int sr = rest / p.wst;
        const int y = y0 + sr, xc = col - 1;
        const bool valid = y >= 0 && y < s.H && xc >= 0 && xc < s.W &&
                           ch * 8 < s.Cin;
        const bf16* src =
            valid ? xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin + ch * 8
                  : xb;
        cutdet::cp_async16(base + ((sr * p.wst + col) * p.ps + ch * 8) * 2,
                           src, valid);
      }
      cutdet::cp_async_wait_all();
      return;
    }
  }
  // The paths below pass the input through registers.  Each thread
  // issues all its loads (of valid addresses: the frame's first element
  // stands in for padding) before it touches any loaded value, so they
  // are in flight together; the masking, rounding and packing come in
  // the store phase.
  if constexpr (!I::in_cm && std::is_same_v<typename I::in_t, float>) {
    if (p.staging == Staging::kF32x4) {
      const int chunks = p.cpad / 4;
      auto where = [&](int i, int& c, int& pix, bool& ok) {
        c = (i % chunks) * 4;
        pix = i / chunks;
        const int sr = pix / p.wst, col = pix - sr * p.wst;
        const int y = y0 + sr, xc = col - 1;
        ok = y >= 0 && y < s.H && xc >= 0 && xc < s.W && c < s.Cin;
        return ok ? xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin + c
                  : xb;
      };
      unrolled<4>(
          cutdet::kRowsStaged * p.wst * chunks, t, nt,
          [&](int i) {
            int c, pix;
            bool ok;
            return __ldg(reinterpret_cast<const float4*>(where(i, c, pix,
                                                               ok)));
          },
          [&](int i, float4 v) {
            int c, pix;
            bool ok;
            where(i, c, pix, ok);
            if (!ok) v = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<uint2*>(out + pix * p.ps + c) =
                make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
          });
      return;
    }
  }
  using In = typename I::in_t;
  // An element's raw bits, and the same widened to float.
  auto bits = [](const In* q) -> uint32_t {
    if constexpr (std::is_same_v<In, float>) {
      return __float_as_uint(__ldg(q));
    } else {
      return __ldg(reinterpret_cast<const unsigned short*>(q));
    }
  };
  auto widen = [](uint32_t v) {
    if constexpr (std::is_same_v<In, float>) {
      return __uint_as_float(v);
    } else {
      return __uint_as_float(v << 16);
    }
  };
  if constexpr (I::in_cm) {
    // Channel-major: 32 neighbouring threads take 4 channels of one
    // staged row at 32 neighbouring columns (coalesced reads along W);
    // each writes the 4 channels of its pixel as one 8-byte store.
    const int quads = p.cpad / 4;
    const int chunks = (p.wst + 31) / 32;
    auto where = [&](int i, int& sr, int& c, int& col, bool& ok) {
      const int q = i / 32;
      const int g = q / chunks;
      col = (q - g * chunks) * 32 + i % 32;
      sr = g / quads;
      c = (g - sr * quads) * 4;
      const int y = y0 + sr, xc = col - 1;
      ok = col < p.wst && y >= 0 && y < s.H && xc >= 0 && xc < s.W;
      return ok ? xb + (static_cast<size_t>(c) * s.H + y) * s.W + xc : xb;
    };
    struct Raw {
      uint32_t v[4];
    };
    unrolled<8>(
        cutdet::kRowsStaged * quads * chunks * 32, t, nt,
        [&](int i) {
          int sr, c, col;
          bool ok;
          const In* q = where(i, sr, c, col, ok);
          Raw r;
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
            r.v[ci] = bits(ok && c + ci < s.Cin
                               ? q + static_cast<size_t>(ci) * s.H * s.W
                               : xb);
          return r;
        },
        [&](int i, const Raw& r) {
          int sr, c, col;
          bool ok;
          where(i, sr, c, col, ok);
          if (col >= p.wst) return;
          float v[4];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
            v[ci] = ok && c + ci < s.Cin ? widen(r.v[ci]) : 0.f;
          *reinterpret_cast<uint2*>(out + (sr * p.wst + col) * p.ps + c) =
              make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
        });
  } else {
    // NHWC, Cin not a multiple of the vectors (the unfolded layer 1's 3
    // channels): a thread takes 8 channels of one pixel, zero-padded, and
    // writes them as one 16-byte store.
    const int octs = p.cpad / 8;
    auto where = [&](int i, int& c, int& pix, bool& ok) {
      pix = i / octs;
      c = (i - pix * octs) * 8;
      const int sr = pix / p.wst, col = pix - sr * p.wst;
      const int y = y0 + sr, xc = col - 1;
      ok = y >= 0 && y < s.H && xc >= 0 && xc < s.W;
      return ok ? xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin + c : xb;
    };
    struct Raw {
      uint32_t v[8];
    };
    unrolled<2>(
        cutdet::kRowsStaged * p.wst * octs, t, nt,
        [&](int i) {
          int c, pix;
          bool ok;
          const In* q = where(i, c, pix, ok);
          Raw r;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            r.v[k] = bits(ok && c + k < s.Cin ? q + k : xb);
          return r;
        },
        [&](int i, const Raw& r) {
          int c, pix;
          bool ok;
          where(i, c, pix, ok);
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = ok && c + k < s.Cin ? widen(r.v[k]) : 0.f;
          *reinterpret_cast<uint4*>(out + pix * p.ps + c) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        });
  }
}

// The weights of output channels n0..n0+N-1, once per block, by all its
// threads: k step st, channel n, k kk at core matrix (st, n/8, kk/8), row
// n%8, column kk%8 (wgmma's K-major layout without swizzle).
template <typename I, int N>
__device__ void stage_weights_mma(const typename I::w_t* __restrict__ w,
                                  bf16* wsm, int n0, const MmaPlan& p) {
  auto at = [](int st, int n, int kk) {
    return ((st * (N / 8) + n / 8) * 2 + kk / 8) * 64 + (n % 8) * 8 + kk % 8;
  };
  auto src = [&](int st, int kk, int o) {
    const int tap = st / p.kc;
    const int c = (st - tap * p.kc) * 16 + kk;
    return c < p.s.Cin && o < p.s.Cout
               ? w + (static_cast<size_t>(tap) * p.s.Cin + c) * p.s.Cout + o
               : nullptr;
  };
  if (p.wvec) {
    // Eight consecutive output channels (16 or 32 bytes) a load.
    unrolled<4>(
        p.steps * 16 * (N / 8), threadIdx.x, blockDim.x,
        [&](int i) {
          const int g = i % (N / 8);
          const int rest = i / (N / 8);
          const auto* q = src(rest / 16, rest % 16, n0 + 8 * g);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (q != nullptr) {
            if constexpr (std::is_same_v<typename I::w_t, bf16>) {
              v = __ldg(reinterpret_cast<const uint4*>(q));
            } else {
              const float4 lo = __ldg(reinterpret_cast<const float4*>(q));
              const float4 hi = __ldg(reinterpret_cast<const float4*>(q) + 1);
              v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                             pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
            }
          }
          return v;
        },
        [&](int i, uint4 v) {
          const int g = i % (N / 8);
          const int rest = i / (N / 8);
          const uint32_t words[4] = {v.x, v.y, v.z, v.w};
          auto* bits = reinterpret_cast<unsigned short*>(wsm);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            bits[at(rest / 16, 8 * g + k, rest % 16)] =
                static_cast<unsigned short>(words[k / 2] >> (16 * (k % 2)));
        });
  } else {
    unrolled<4>(
        p.steps * 16 * N, threadIdx.x, blockDim.x,
        [&](int i) {
          const int n = i % N;
          const int rest = i / N;
          const auto* q = src(rest / 16, rest % 16, n0 + n);
          return q != nullptr ? cutdet::operand<bf16>(q) : 0.f;
        },
        [&](int i, float v) {
          const int n = i % N;
          const int rest = i / N;
          wsm[at(rest / 16, n, rest % 16)] = __float2bfloat16_rn(v);
        });
  }
}

// int8: stage item ``item``'s five input rows, all columns (staged column
// 0 is input column -1), as int8 [row][column][ps] by cp.async of
// ``p.chunk`` bytes, zero-filled outside the input and in channels >= Cin;
// run by the producer's ``nt`` threads.
__device__ void stage_mma_i8(const int8_t* __restrict__ x, unsigned char* dst,
                             int item, const MmaPlan& p, int t, int nt) {
  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  const int8_t* xb = x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int chunks = p.ps / p.chunk;
  const int total = cutdet::kRowsStaged * p.wst * chunks;
  for (int i = t; i < total; i += nt) {
    const int ch = i % chunks;
    const int pix = i / chunks;
    const int sr = pix / p.wst, col = pix - sr * p.wst;
    const int y = 3 * r - 1 + sr, xc = col - 1;
    const bool valid = y >= 0 && y < s.H && xc >= 0 && xc < s.W &&
                       ch * p.chunk < s.Cin;
    const int8_t* src =
        valid ? xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin + ch * p.chunk
              : xb;
    const uint32_t at = base + pix * p.ps + ch * p.chunk;
    if (p.chunk == 16) {
      cutdet::cp_async16(at, src, valid);
    } else {
      cutdet::cp_async4(at, src, valid);
    }
  }
  cutdet::cp_async_wait_all();
}

// int8: the weights of output channels n0..n0+N-1, once per block, in
// wgmma's K-major layout without swizzle (k step st, channel n, byte kk at
// core matrix (st, n/8, kk/16), row n%8, byte kk%16).  Step st reads
// kernel row dy = st / kc at bytes 32 * (st % kc) + kk of the three staged
// pixels that row covers, each ps bytes: tap dx = that / ps, channel c =
// that % ps.  Zero where c >= Cin (the staged stride's pad), dx > 2 (the
// last step's bytes past the third pixel, which read into the next one)
// or n0 + n >= Cout.  A thread packs 16 bytes of one channel and step.
template <int N>
__device__ void stage_weights_i8(const int8_t* __restrict__ w,
                                 unsigned char* wsm, int n0,
                                 const MmaPlan& p) {
  for (int i = threadIdx.x; i < p.steps * 2 * N; i += blockDim.x) {
    const int n = i % N, rest = i / N, h = rest % 2, st = rest / 2;
    const int dy = st / p.kc, o = n0 + n;
    const int kb0 = (st - dy * p.kc) * 32 + 16 * h;
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int dx = (kb0 + e) / p.ps, c = kb0 + e - dx * p.ps;
      if (dx < 3 && c < p.s.Cin && o < p.s.Cout) {
        const int8_t v =
            w[(static_cast<size_t>(dy * 3 + dx) * p.s.Cin + c) * p.s.Cout + o];
        words[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                        << (8 * (e % 4));
      }
    }
    *reinterpret_cast<uint4*>(wsm + ((st * (N / 8) + n / 8) * 2 + h) * 128 +
                              (n % 8) * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// Steps a consumer warpgroup keeps in each of its two register sets of A;
// it divides the step count, 9 * (Cin rounded up to 16) / 16 in bf16 and
// 3 * kc in int8.
constexpr int kGroupSteps = 3;

// One M tile (pool windows 7j..7j+6 of the item) on one warpgroup.  For
// the int8 instance ``bias``, ``scale`` and ``offset`` are the block's so,
// ring strip and activation scale.
template <typename I, int N>
__device__ void mma_tile(uint32_t buf, uint32_t wts, const int* step_off,
                         float* scratch, int j, int item, int n0, int wg,
                         const MmaPlan& p, const float* __restrict__ bias,
                         const float* __restrict__ scale,
                         const float* __restrict__ offset,
                         typename I::out_t* __restrict__ out) {
  const int lt = threadIdx.x % 128;
  const int warp = lt / 32, lane = lt % 32;
  // int32 sums (int8) or f32; bytes of a staged element (int8 or bf16).
  using Acc = std::conditional_t<kI8<I>, int, float>;
  constexpr int kElem = kI8<I> ? 1 : 2;

  // This lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (k bytes 0-15 |
  // 16-31) of its warp's 16 rows, as mma.sync's m16k16 bf16 (m16k32 s8) A
  // fragment.
  int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if (row >= 3 * kBandCols) row = 3 * kBandCols - 1;  // the pad row
  const int cy = row / kBandCols, cx = row - cy * kBandCols;
  const uint32_t a_base =
      buf + (cy * p.wst + kBandCols * j + cx) * p.ps * kElem + (lane >> 4) * 16;
  // B of a step: N rows (output channels) x 32 bytes of k, core matrices
  // 128 bytes apart along k and 256 bytes apart along N.
  auto b_desc = [&](int step) {
    return cutdet::smem_desc(wts + step * N * 32, 128, 256);
  };

  Acc d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  using Set = uint32_t[kGroupSteps][4];
  Set a0, a1;
  auto load = [&](Set& a, int s0) {
#pragma unroll
    for (int i = 0; i < kGroupSteps; ++i)
      cutdet::ldmatrix_x4(a[i], a_base + step_off[s0 + i]);
  };
  auto issue = [&](Set& a, int s0) {
    cutdet::wgmma_fence();
#pragma unroll
    for (int i = 0; i < kGroupSteps; ++i) {
      if constexpr (kI8<I>) {
        cutdet::WgmmaS8<N>::mma(d, a[i], b_desc(s0 + i), 1);
      } else {
        cutdet::Wgmma<N>::mma(d, a[i], b_desc(s0 + i));
      }
    }
    cutdet::wgmma_commit();
  };
#pragma unroll
  for (int i = 0; i < N / 2; ++i) cutdet::fence_operand(d[i]);
  // Two groups in flight: a set of A registers is reloaded only after
  // wait_group has retired the group that reads it.
  load(a0, 0);
  for (int s0 = 0; s0 < p.steps; s0 += 2 * kGroupSteps) {
    issue(a0, s0);
    cutdet::wgmma_wait<1>();
    if (s0 + kGroupSteps < p.steps) {
      load(a1, s0 + kGroupSteps);
      issue(a1, s0 + kGroupSteps);
    }
    cutdet::wgmma_wait<1>();
    if (s0 + 2 * kGroupSteps < p.steps) load(a0, s0 + 2 * kGroupSteps);
  }
  cutdet::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) cutdet::fence_operand(d[i]);

  // Accumulators to shared memory, [64][N + 8] f32 or int32: thread (warp,
  // lane) holds rows 16*warp + lane/4 (+8), columns 8i + 2*(lane%4) (+1).
  constexpr int kStride = N + 8;
  using Acc2 = std::conditional_t<kI8<I>, int2, float2>;
  Acc* acc = reinterpret_cast<Acc*>(scratch);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = 8 * i + 2 * t;
    *reinterpret_cast<Acc2*>(acc + (warp * 16 + g) * kStride + c) =
        Acc2{d[4 * i], d[4 * i + 1]};
    *reinterpret_cast<Acc2*>(acc + (warp * 16 + g + 8) * kStride + c) =
        Acc2{d[4 * i + 2], d[4 * i + 3]};
  }
  cutdet::warpgroup_sync(1 + wg);

  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  const int windows = min(kBandWindows, s.Wp - kBandWindows * j);
  if constexpr (kI8<I>) {
    // z = f32(sum) * so + ring for each conv pixel (the ring row of its
    // conv row's class: 0, interior, H - 1), the max of the window's nine,
    // its code; four channels a thread, stored as one word.
    const float* so = bias;
    const float* qscale = offset;
    const float* ring[3];
#pragma unroll
    for (int wy = 0; wy < 3; ++wy) {
      const int y = 3 * r + wy;
      ring[wy] = scale + static_cast<size_t>(y == 0 ? 0 : y == s.H - 1 ? 2 : 1)
                             * s.W * s.Cout;
    }
    for (int idx = lt; idx < kBandWindows * (N / 4); idx += 128) {
      const int o = 4 * (idx % (N / 4)), q = idx / (N / 4);
      const int oc = n0 + o;
      if (q >= windows || oc >= s.Cout) continue;
      const float4 sv = __ldg(reinterpret_cast<const float4*>(so + oc));
      const float4 qv = __ldg(reinterpret_cast<const float4*>(qscale + oc));
      const float so4[4] = {sv.x, sv.y, sv.z, sv.w};
      const float qs4[4] = {qv.x, qv.y, qv.z, qv.w};
      float m[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                    -CUDART_INF_F};
#pragma unroll
      for (int wy = 0; wy < 3; ++wy)
#pragma unroll
        for (int wx = 0; wx < 3; ++wx) {
          const int col = 3 * q + wx;
          const int4 a = *reinterpret_cast<const int4*>(
              acc + (wy * kBandCols + col) * kStride + o);
          const float4 rv = __ldg(reinterpret_cast<const float4*>(
              ring[wy] + static_cast<size_t>(kBandCols * j + col) * s.Cout +
              oc));
          const int sum[4] = {a.x, a.y, a.z, a.w};
          const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            m[c] = fmaxf(m[c], cutdet::dequant_i8(__int2float_rn(sum[c]),
                                                  so4[c], rr[c]));
        }
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        word |= cutdet::quantize_i8(m[c], qs4[c]) << (8 * c);
      const int px = kBandWindows * j + q;
      *reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(b) * s.Hp + r) * s.Wp + px) * s.Cout +
          oc) = word;
    }
  } else {
    for (int idx = lt; idx < kBandWindows * N; idx += 128) {
      int q, o;
      if constexpr (I::out_cm) {
        q = idx % kBandWindows;
        o = idx / kBandWindows;
      } else {
        o = idx % N;
        q = idx / N;
      }
      const int oc = n0 + o;
      if (q >= windows || oc >= s.Cout) continue;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int wy = 0; wy < 3; ++wy)
#pragma unroll
        for (int wx = 0; wx < 3; ++wx)
          m = fmaxf(m, acc[(wy * kBandCols + 3 * q + wx) * kStride + o]);
      const int px = kBandWindows * j + q;
      const size_t at =
          I::out_cm
              ? ((static_cast<size_t>(b) * s.Cout + oc) * s.Hp + r) * s.Wp + px
              : ((static_cast<size_t>(b) * s.Hp + r) * s.Wp + px) * s.Cout + oc;
      cutdet::store(out + at, cutdet::epilogue<I::epi>(m, bias[oc], scale[oc],
                                                       offset[oc]));
    }
  }
  cutdet::warpgroup_sync(1 + wg);  // the scratch is free again
}

// Threads of a tensor-core block: the consumer warpgroups, and a
// producer warpgroup where the input can be staged by cp.async (bf16 or
// int8 NHWC).
template <typename I>
constexpr int kMmaThreads =
    128 * (kMaxWarpgroups +
           ((std::is_same_v<typename I::in_t, bf16> || kI8<I>) && !I::in_cm
                ? 1
                : 0));

template <typename I, int N>
__global__ void __launch_bounds__(kMmaThreads<I>)
    conv_block_mma(const typename I::in_t* __restrict__ x,
                   const typename I::w_t* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   typename I::out_t* __restrict__ out, MmaPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int item = blockIdx.x;
  if (item >= p.s.items) return;
  const int n0 = blockIdx.y * N;
  const int wg = threadIdx.x / 128;
  const bool producer = wg == p.nwg;

  if constexpr (kI8<I>) {
    stage_weights_i8<N>(w, smem, n0, p);
  } else {
    stage_weights_mma<I, N>(w, reinterpret_cast<bf16*>(smem), n0, p);
  }
  cutdet::fence_proxy_async();  // wgmma reads them through the async proxy
  // Byte offset of each k step's A rows from a lane's own pixel: bf16, tap
  // (dy, dx) and 16-channel chunk cc; int8, kernel row dy and 32-byte
  // chunk cc of the row's three pixels.
  int* step_off = reinterpret_cast<int*>(smem + p.w_bytes);
  for (int st = threadIdx.x; st < p.steps; st += blockDim.x) {
    if constexpr (kI8<I>) {
      const int dy = st / p.kc, cc = st - dy * p.kc;
      step_off[st] = dy * p.wst * p.ps + cc * 32;
    } else {
      const int tap = st / p.kc, cc = st - tap * p.kc;
      const int dy = tap / 3, dx = tap - dy * 3;
      step_off[st] = ((dy * p.wst + dx) * p.ps + cc * 16) * 2;
    }
  }

  const uint32_t wts = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* scratch = reinterpret_cast<float*>(smem + p.w_bytes + p.off_bytes) +
                   wg * kTileRows * (N + 8);
  unsigned char* bufs = smem + p.w_bytes + p.off_bytes + p.scratch_bytes;
  const int pt = threadIdx.x - 128 * p.nwg;  // producer thread

  // cp.async staging: the producer stages item k+1 while the consumers
  // run item k (with one buffer, the two take turns).  Staging through
  // registers (f32 rounded to bf16, channel-major transposed, or element
  // by element) is latency-bound, so there every thread of the block
  // stages, between items, with its loads in flight together.
  const bool coop = p.staging != Staging::kCopy;
  const bool overlap = !coop && p.nbuf == 2;
  auto stage = [&](int it, unsigned char* dst) {
    if constexpr (kI8<I>) {
      if (producer) stage_mma_i8(x, dst, it, p, pt, 128);
    } else if (coop) {
      stage_mma<I>(x, dst, it, p, threadIdx.x, blockDim.x);
    } else if (producer) {
      stage_mma<I>(x, dst, it, p, pt, 128);
    }
  };
  stage(item, bufs);
  __syncthreads();
  for (int k = 0; item < p.s.items; ++k, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (producer) {
      if (overlap && next < p.s.items)
        stage(next, bufs + ((k + 1) & 1) * p.buf_bytes);
    } else {
      const uint32_t cur = static_cast<uint32_t>(__cvta_generic_to_shared(
          bufs + (overlap ? (k & 1) * p.buf_bytes : 0)));
      for (int j = wg; j < p.tiles; j += p.nwg) {
        mma_tile<I, N>(cur, wts, step_off, scratch, j, item, n0, wg, p, bias,
                       scale, offset, out);
      }
    }
    __syncthreads();
    if (!overlap && next < p.s.items) {
      stage(next, bufs);
      __syncthreads();
    }
  }
}

template <typename I, int N>
int launch_mma_n(const void* x, const void* w, const void* bias,
                 const void* scale, const void* offset, void* out,
                 const MmaPlan& p, size_t smem, cudaStream_t stream) {
  auto kernel = conv_block_mma<I, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // A producer warpgroup only where it overlaps cp.async staging.
  const int threads = 128 * (p.nwg + (p.staging == Staging::kCopy ? 1 : 0));
  const int groups = (p.s.Cout + N - 1) / N;
  const dim3 grid(
      persistent_blocks(kernel, threads, smem, p.s.items, groups), groups);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename I::in_t*>(x),
      static_cast<const typename I::w_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset),
      static_cast<typename I::out_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// Layer 1's plan.
struct Conv1Plan {
  Shape s;
  int tiles;   // N tiles (8 windows each) per item
  int rs;      // bytes per raw row
  int nwg;     // warpgroups per block
  bool rvec;   // raw rows copied by 16-byte cp.async
  uint32_t tile_bytes, raw_bytes;
  uint32_t ring_bytes;  // int8: the ring's interior row, once per block
};

// int8: the block's copy of the ring strip's interior row, [column][64 +
// 12] floats for every column the tiles reach (zero past W): a warp reads
// 8 channels at each of 4 windows 6 columns apart, and 6 * 76 = 8 (mod
// 32) puts those 4 x 8 floats in 32 distinct banks.
constexpr int kRingStride = 76;

// Layer 1's B tile (N tile j: windows 8j .. 8j+7, conv columns 24j ..
// 24j+23), taps packed: for staged row sr and conv column c, k = dx * 3 +
// ch holds channel ch of input column 24j + c + dx - 1, zeros for k >= 9,
// so one k16 step takes a row's three taps and three steps, one per dy,
// make the conv.  A row is three 8-pixel core-matrix blocks of wgmma's
// K-major layout (k 0-7, then k 8-15, 128 bytes each), and its columns
// are ordered so that lane t of the accumulator holds whole windows:
// window 2t + u / 3, pixel u % 3 (u = 0..5) sits at column 8 * (u / 2) +
// 2t + u % 2.  A pixel's nine bytes lie together in the raw row at any
// byte offset: three aligned words, two funnel shifts and integer and add
// instructions make the bf16s.  One pixel a thread (5 x 24 = 120).
// In int8 (kInt8) the same geometry in bytes: k is byte k of the column's
// k32 step, each byte shifted by -128 (xor 0x80); its bytes 9-31 meet zero
// weights, so the k 16-31 half is never written.  The 'same' padding must
// then be int8 0, as the plain version pads the shifted frame: the pads
// around the frame's columns hold 0x80 (zero_raw_pads) and a row outside
// the frame (input row 3r - 1 + sr) is written as zeros.
template <bool kInt8, bool kSum = false>
__device__ void pack_tile(const unsigned char* raw, unsigned char* dst, int j,
                          int r, const Conv1Plan& p, int lt,
                          uint32_t* sum = nullptr) {
  if (lt >= cutdet::kRowsStaged * kConv1Cols) return;
  const int sr = lt / kConv1Cols, c = lt - sr * kConv1Cols;
  const int o = kRawLead + 3 * (kConv1Cols * j + c - 1);
  const int sh = (o & 3) * 8;
  const uint32_t* q =
      reinterpret_cast<const uint32_t*>(raw + sr * p.rs + (o & ~3));
  const uint32_t w0 = q[0], w1 = q[1], w2 = q[2];
  const uint32_t b0 = __funnelshift_r(w0, w1, sh);  // bytes 0-3
  const uint32_t b1 = __funnelshift_r(w1, w2, sh);  // bytes 4-7
  const int wl = c / 3, u = (wl & 1) * 3 + c % 3;
  const int at = (sr * 3 + u / 2) * 256 + ((wl >> 1) * 2 + (u & 1)) * 16;
  uint4* out = reinterpret_cast<uint4*>(dst + at);
  if constexpr (kInt8) {
    const int y = 3 * r - 1 + sr;
    out[0] = y >= 0 && y < p.s.H
                 ? make_uint4(b0 ^ 0x80808080u, b1 ^ 0x80808080u,
                              ((w2 >> sh) & 0xFFu) ^ 0x80u, 0u)
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
    const uint4 lo =
        make_uint4(u8_pair_bf16(b0, 0, b0, 1), u8_pair_bf16(b0, 2, b0, 3),
                   u8_pair_bf16(b1, 0, b1, 1), u8_pair_bf16(b1, 2, b1, 3));
    const uint32_t hi = u8_pair_bf16(w2 >> sh, 0, 0u, 0);  // k 8
    out[0] = lo;
    out[8] = make_uint4(hi, 0u, 0u, 0u);
    if constexpr (kSum) {
      // The tile's checksum (conv1_stages' taps): each word written times
      // 2 * its word index in the tile + 1, mod 2^32.
      const uint32_t i = at / 4;
      *sum += lo.x * (2 * i + 1) + lo.y * (2 * i + 3) + lo.z * (2 * i + 5) +
              lo.w * (2 * i + 7) + hi * (2 * i + 65);
    }
  }
  cutdet::fence_proxy_async();  // wgmma reads the tile through the async proxy
}

// Layer 1's N tile j on one warpgroup: D[64 channels x 72 pixels] =
// weights (A, in registers) x the packed pixels (B), three k steps.  D's
// columns 24cy + (8i + 2t + e) are conv row cy of the tile's pixels, so
// a thread holds, for its channels 16 * warp + g and + 8, every value of
// windows 2t and 2t + 1: the pool is a max over its own registers.
__device__ __forceinline__ void conv1_mma(uint32_t b_tile,
                                          const uint32_t (&wa)[3][4],
                                          float (&d)[36]) {
#pragma unroll
  for (int i = 0; i < 36; ++i) d[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 36; ++i) cutdet::fence_operand(d[i]);
  cutdet::wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
    cutdet::Wgmma<72>::mma(
        d, wa[dy], cutdet::smem_desc(b_tile + dy * 3 * 256, 128, 256));
  cutdet::wgmma_commit();
  cutdet::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 36; ++i) cutdet::fence_operand(d[i]);
}

// The pool of conv1_mma's accumulators: for channel row h (g or g + 8),
// the maxes m0 and m1 of the thread's windows 2t and 2t + 1.
__device__ __forceinline__ void conv1_pool(const float (&d)[36], int h,
                                           float& m0, float& m1) {
  m0 = -CUDART_INF_F;
  m1 = -CUDART_INF_F;
#pragma unroll
  for (int cy = 0; cy < 3; ++cy) {
    const float* v = d + 12 * cy + 2 * h;  // d[4 * (3cy + i) + 2h + e]
    m0 = fmaxf(m0, fmaxf(fmaxf(v[0], v[1]), v[4]));
    m1 = fmaxf(m1, fmaxf(fmaxf(v[5], v[8]), v[9]));
  }
}

// Layer 1's N tile j: conv1_mma, conv1_pool, then the epilogue (the
// channels' bias and BN affine in ``par``) and a bf16 store per window
// and channel.
template <typename I>
__device__ void conv1_tile(uint32_t b_tile, const uint32_t (&wa)[3][4], int j,
                           int item, int n0, const Conv1Plan& p,
                           const float (&par)[6],
                           typename I::out_t* __restrict__ out) {
  float d[36];
  conv1_mma(b_tile, wa, d);

  const int lt = threadIdx.x % 128, warp = lt / 32;
  const int g = (lt % 32) >> 2, t = lt & 3;
  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  const int q = kConv1Windows * j + 2 * t;  // this thread's first window
  typename I::out_t* orow =
      out + ((static_cast<size_t>(b) * s.Hp + r) * s.Wp + q) * s.Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // channel rows g, g + 8
    const int oc = n0 + 16 * warp + g + 8 * h;
    float m0, m1;
    conv1_pool(d, h, m0, m1);
    if (oc >= s.Cout || q >= s.Wp) continue;
    const float* pc = par + 3 * h;
    cutdet::store(orow + oc, cutdet::epilogue<I::epi>(m0, pc[0], pc[1], pc[2]));
    if (q + 1 < s.Wp)
      cutdet::store(orow + s.Cout + oc,
                    cutdet::epilogue<I::epi>(m1, pc[0], pc[1], pc[2]));
  }
}

// Layer 1's int8 N tile j on one warpgroup: D[64 channels x 80 pixels] =
// weights (A, in registers) x the packed pixels (B), three k32 steps, one
// per dy, each overwriting (dy = 0) or adding to the accumulators, which
// the caller keeps from tile to tile.  D's columns are conv_tile's, so a
// thread holds, for its channels 16 * warp + g and + 8, the nine pixels
// of windows 8j + 2t and + 1: z = f32(sum) * so + ring for each, the max
// of the nine, the code, one byte a window and channel.  Where the nine
// share one ring value (away from the frame's edges every pixel's ring is
// the same dot product) and so >= 0, z is nondecreasing in the sum, so
// the window's largest z is z of its largest sum: one dequantization
// instead of nine.  The ring of an interior conv row comes from the
// block's copy ``ring_s``, of the frame's top and bottom rows from the
// strip ``ring``.  ``par``: so and the activation scale of each channel.
__device__ void conv1_tile_i8(uint32_t b_tile, const uint32_t (&wa)[3][4],
                              int (&d)[kConv1NI8 / 2], int j, int b, int r,
                              int n0, const Conv1Plan& p,
                              const float (&par)[4], const float* ring_s,
                              const float* __restrict__ ring,
                              int8_t* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < kConv1NI8 / 2; ++i) cutdet::fence_operand(d[i]);
  cutdet::wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
    cutdet::WgmmaS8<kConv1NI8>::mma(
        d, wa[dy], cutdet::smem_desc(b_tile + dy * 3 * 256, 128, 256),
        dy > 0);
  cutdet::wgmma_commit();
  cutdet::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kConv1NI8 / 2; ++i) cutdet::fence_operand(d[i]);

  const int lt = threadIdx.x % 128, warp = lt / 32;
  const int g = (lt % 32) >> 2, t = lt & 3;
  const Shape& s = p.s;
  if (n0 + 16 * warp >= s.Cout) return;  // this warp's channels are pads
  // Conv row 3r is the frame's top row (the ring's row 0) only at r = 0,
  // and 3r + 2 its bottom row (row 2) only where H = 3 * Hp, at the last r.
  const bool top = r == 0, bottom = 3 * r + 2 == s.H - 1;
  int8_t* orow = out + (static_cast<size_t>(b) * s.Hp + r) * s.Wp * s.Cout;
  // d's index of pixel (cy, cx) of the thread's window v: column 24cy +
  // 8(u / 2) + 2t + u % 2 with u = 3v + cx (conv1_tile's order).
  constexpr int kAt[6] = {0, 1, 4, 5, 8, 9};
  // With no branch inside a window (the stores predicated; windows past
  // Wp read the ring copy's zero columns) the windows' chains interleave;
  // the top and bottom rows' items take their ring from the strip.
  auto pool = [&](auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // channel rows g, g + 8
      const int c = 16 * warp + g + 8 * h, oc = n0 + c;
      const float so = par[2 * h];
      const float* mid = ring_s + c;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int q = kConv1Windows * j + 2 * t + v;
        float rc[3];  // the ring of the window's columns, interior rows
#pragma unroll
        for (int cx = 0; cx < 3; ++cx) rc[cx] = mid[(3 * q + cx) * kRingStride];
        float m = -CUDART_INF_F;
        if (!kEdge && rc[0] == rc[1] && rc[1] == rc[2] && so >= 0.f) {
          int top_sum = d[kAt[3 * v] + 2 * h];
#pragma unroll
          for (int u = 1; u < 9; ++u)
            top_sum = max(top_sum,
                          d[12 * (u / 3) + kAt[3 * v + u % 3] + 2 * h]);
          m = cutdet::dequant_i8(__int2float_rn(top_sum), so, rc[0]);
        } else {
#pragma unroll
          for (int cx = 0; cx < 3; ++cx) {
            const int col = 3 * q + cx;
#pragma unroll
            for (int cy = 0; cy < 3; ++cy) {
              float rv = rc[cx];
              if constexpr (kEdge) {
                const size_t at = static_cast<size_t>(min(col, s.W - 1)) *
                                      s.Cout + min(oc, s.Cout - 1);
                if (cy == 0 && top) rv = __ldg(ring + at);
                if (cy == 2 && bottom)
                  rv = __ldg(ring + static_cast<size_t>(2 * s.W) * s.Cout +
                             at);
              }
              m = fmaxf(m, cutdet::dequant_i8(
                               __int2float_rn(
                                   d[12 * cy + kAt[3 * v + cx] + 2 * h]),
                               so, rv));
            }
          }
        }
        const uint32_t code = cutdet::quantize_i8(m, par[2 * h + 1]);
        if (oc < s.Cout && q < s.Wp)
          orow[static_cast<size_t>(q) * s.Cout + oc] =
              static_cast<int8_t>(code);
      }
    }
  };
  if (top || bottom) {
    pool(std::true_type{});
  } else {
    pool(std::false_type{});
  }
}

// Layer 1 on the tensor cores (uint8 in, 3 channels, taps packed).  Each
// thread keeps its A fragments (the weights of its two channels) in
// registers for the whole kernel.  Each warpgroup walks items of its own,
// with its own raw-row slots and two B tiles, so no barrier spans the
// block: it copies the raw rows of its item two ahead (cp.async groups),
// and for each N tile packs its B (pack_tile) and runs conv1_tile, one
// warpgroup barrier a tile.
template <typename I>
__global__ void __launch_bounds__(128 * kConv1Warpgroups)
    conv1_block_mma(const uint8_t* __restrict__ x,
                    const typename I::w_t* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ offset,
                    typename I::out_t* __restrict__ out, Conv1Plan p) {
  static_assert(std::is_same_v<typename I::w_t, bf16> || kI8<I>);
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape& s = p.s;
  const int n0 = blockIdx.y * 64;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int g = (lt % 32) >> 2, t = lt & 3;
  const int oc0 = n0 + 16 * (lt / 32) + g;  // channels oc0 and oc0 + 8
  unsigned char* mine =
      smem + p.ring_bytes + wg * (2 * p.tile_bytes + 3 * p.raw_bytes);
  unsigned char* raws = mine + 2 * p.tile_bytes;
  zero_raw_pads(raws, 3 * cutdet::kRowsStaged, p.rs, s.W, lt, 128,
                kI8<I> ? 0x80 : 0);
  // int8: the ring's interior row for this group's channels (``scale`` is
  // the strip), zero past them.
  float* ring_s = reinterpret_cast<float*>(smem);
  if constexpr (kI8<I>) {
    auto at = [&](int i, int& col, int& c) {
      col = i / kRingStride;
      c = i - col * kRingStride;
      return col < s.W && c < 64 && n0 + c < s.Cout;
    };
    unrolled<8>(
        kConv1Cols * p.tiles * kRingStride, threadIdx.x, blockDim.x,
        [&](int i) {
          int col, c;
          return at(i, col, c) ? __ldg(scale + (static_cast<size_t>(s.W) +
                                                col) * s.Cout + n0 + c)
                               : 0.f;
        },
        [&](int i, float v) { ring_s[i] = v; });
    __syncthreads();
  }
  // A of k step dy, as mma.sync's m16k16 bf16 (m16k32 s8) fragment: rows
  // (channels) oc0 and oc0 + 8, k = dx * 3 + c; bf16: k 2t, 2t + 1 and
  // 2t + 8, 2t + 9; int8: bytes 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3.
  uint32_t wa[3][4];
  if constexpr (kI8<I>) {
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int k0 = 4 * t + (f >> 1) * 16, oc = oc0 + (f & 1) * 8;
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + e < 9 && oc < s.Cout)
            word |= static_cast<uint32_t>(wb[(dy * 9 + k0 + e) * s.Cout + oc])
                    << (8 * e);
        wa[dy][f] = word;
      }
  } else {
    const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w);
    auto wt = [&](int dy, int k, int oc) -> uint32_t {
      return k < 9 && oc < s.Cout ? wbits[((dy * 3 + k / 3) * 3 + k % 3) *
                                              s.Cout + oc]
                                  : 0u;
    };
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int k = 2 * t + (f >> 1) * 8, oc = oc0 + (f & 1) * 8;
        wa[dy][f] = wt(dy, k, oc) | wt(dy, k + 1, oc) << 16;
      }
  }
  // bf16: bias, BN scale, BN offset of oc0, then of oc0 + 8; int8: so and
  // the activation scale (``bias`` and ``offset``; ``scale`` is the ring).
  float par[kI8<I> ? 4 : 6];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oc = oc0 + 8 * h;
    if constexpr (kI8<I>) {
      par[2 * h] = oc < s.Cout ? bias[oc] : 0.f;
      par[2 * h + 1] = oc < s.Cout ? offset[oc] : 1.f;
    } else {
      par[3 * h] = oc < s.Cout ? bias[oc] : 0.f;
      par[3 * h + 1] = oc < s.Cout ? scale[oc] : 0.f;
      par[3 * h + 2] = oc < s.Cout ? offset[oc] : 0.f;
    }
  }
  cutdet::warpgroup_sync(1 + wg);  // the pads before the copies

  const uint32_t tiles = static_cast<uint32_t>(__cvta_generic_to_shared(mine));
  const int step = gridDim.x * p.nwg;
  const int first = blockIdx.x * p.nwg + wg;
  for (int k = 0; k < 2; ++k) {
    if (first + k * step < s.items)
      copy_rows(x, raws + k * p.raw_bytes, first + k * step, s, p.rs, p.rvec,
                lt, 128);
    cutdet::cp_async_commit();
  }
  // int8: the accumulators, which each tile's first step overwrites.
  int d[kI8<I> ? kConv1NI8 / 2 : 1] = {};
  for (int k = 0, item = first; item < s.items; ++k, item += step) {
    cutdet::cp_async_wait_group<1>();  // this item's rows have landed
    cutdet::warpgroup_sync(1 + wg);
    if (item + 2 * step < s.items)
      copy_rows(x, raws + (k + 2) % 3 * p.raw_bytes, item + 2 * step, s, p.rs,
                p.rvec, lt, 128);
    cutdet::cp_async_commit();
    const unsigned char* raw = raws + k % 3 * p.raw_bytes;
    const int b = item / s.Hp, r = item - b * s.Hp;
    for (int j = 0; j < p.tiles; ++j) {
      // Tile j's B goes to buffer j & 1: the barrier after it also
      // retires every wgmma of tile j - 2, which read that buffer.
      const uint32_t tile = tiles + (j & 1) * p.tile_bytes;
      pack_tile<kI8<I>>(raw, mine + (j & 1) * p.tile_bytes, j, r, p, lt);
      cutdet::warpgroup_sync(1 + wg);
      if constexpr (kI8<I>) {
        conv1_tile_i8(tile, wa, d, j, b, r, n0, p, par, ring_s, scale, out);
      } else {
        conv1_tile<I>(tile, wa, j, item, n0, p, par, out);
      }
    }
  }
}

// Layer 1's launch: N tiles of 8 windows, two B tiles and three raw-row
// slots a warpgroup, as many warpgroups a block as fit, output channels in
// groups of 64 (blockIdx.y).
template <typename I>
int launch_conv1(const void* x, const void* w, const void* bias,
                 const void* scale, const void* offset, void* out,
                 const Shape& s, cudaStream_t stream) {
  if (s.Cin != 3) return static_cast<int>(cudaErrorInvalidValue);
  Conv1Plan p{};
  p.s = s;
  p.tiles = (s.Wp + kConv1Windows - 1) / kConv1Windows;
  p.rvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && 3 * s.W % 16 == 0;
  // A row holds the frame's columns and every byte the pack reads past
  // them (three words from the last tile's last pixel).
  const int reach = kRawLead + 3 * (kConv1Cols * p.tiles - 1) + 12;
  const int need = kRawLead + 3 * s.W > reach ? kRawLead + 3 * s.W : reach;
  p.rs = (need + 15) / 16 * 16;
  p.raw_bytes = static_cast<uint32_t>(cutdet::kRowsStaged * p.rs);
  // (int8: one more 8-column group, which dy = 2 reads for N's unused
  // columns 72-79.)
  p.tile_bytes = (cutdet::kRowsStaged * 3 + (kI8<I> ? 1 : 0)) * 256;
  const size_t per_wg = 2 * p.tile_bytes + 3 * p.raw_bytes;
  p.ring_bytes = static_cast<uint32_t>(
      kI8<I> ? align128(size_t(kConv1Cols) * p.tiles * kRingStride * 4) : 0);
  p.nwg = kConv1Warpgroups;
  while (p.nwg > 1 && p.ring_bytes + p.nwg * per_wg > kSmemLimit) --p.nwg;
  const size_t smem = p.ring_bytes + p.nwg * per_wg;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv1_block_mma<I>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128 * p.nwg;
  const int groups = (s.Cout + 63) / 64;
  const dim3 grid(persistent_blocks(kernel, threads, smem,
                                    (s.items + p.nwg - 1) / p.nwg, groups),
                  groups);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(x),
      static_cast<const typename I::w_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset),
      static_cast<typename I::out_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Stage bisection of layer 1's tensor-core chain (conv1_stages): the
// chain of conv1_block_mma, cut after each step, on the TPU stage-bisection
// kernel's input, so that the cuts' times split the chain's cost.
//
// Replaces the TPU kernel ``_kernel`` of scripts/profile_fused_conv1.py
// (its pallas_call in ``build``), stage for stage, at its only shape: a
// 144x256 frame in the planar flat layout (3 planes of (144 + 2) rows x
// 258 lanes, the row pads included, uint8) and [48, 32] bf16 weights (k =
// (dy * 3 + dx) * 3 + c; columns 27-31 meet the TPU's zero im2col rows and
// are not read).  Its conv is a 1-D one over a plane's flat index u:
// conv[o][u] = sum W[o][k] * x[c][u + 258 dy + dx - 1], zero outside the
// plane, for the 144 x 258 positions u.  As conv1_block_mma's item, an
// item here is a pooled row r: conv rows 3r .. 3r + 2 from plane rows 3r
// .. 3r + 4, its raw rows (raw row sr, pixel xc = x[.][(3r + sr) * 258 +
// xc] for xc from -1, at byte kRawLead + 3 xc); 11 N tiles of 24
// positions a conv row, the last with 18 real ones (its pads read the
// next row and are left out of every result).  Each warpgroup runs
// conv1_block_mma's steps on its items: the raw bytes copied ahead
// (cp.async), then per tile pack_tile, a warpgroup barrier and
// conv1_mma (three k16 steps, one per dy, k = dx * 3 + c), then
// conv1_pool.  What differs: the copy is of the planar planes, one item
// ahead into two slots (conv1_block_mma: two ahead, three slots; the
// partials below take the room), and an interleave pass at the item's
// turn makes the raw rows that conv1_block_mma copies straight from NHWC
// frames; a block takes one frame (the TPU's grid step) and its five
// warpgroups walk its 48 items (r = wg, wg + 5, ...), where
// conv1_block_mma's persistent grid deals items of every frame; and
// results are summed into the warpgroup's own shared partial (plain
// adds: a thread owns its elements), where conv1_block_mma stores them to
// global memory (shared float atomics into one block partial cost more
// than the wgmma step).
// What each stage leaves in ``out`` ([B, 128, 128] f32, every element
// written, zero where the stage defines nothing) and in ``sink`` ([B]):
//   cast   + staging (the copy and the interleave); out[0:48, 0:128] =
//          x[0, 0:128], read back from the raw rows of item 0.
//   taps   + pack_tile for every tile; sink = pack_tile's checksum (the
//          words of every tile, each times 2 * its word index + 1, summed
//          mod 2^32; int32 bits), which only this stage computes.
//   dotn   + conv1_mma (M = the 48 channels, padded to 64, N = the tile's
//          72 positions); out[0:48, 0:128] = the sum over the 12 strips
//          (items r = 4s, conv row 0, tiles 0-5) of acc[:, 0:128].
//   dott   taps, then the other operand roles (the mid-stack kernel's):
//          M = positions, A by ldmatrix from the packed tile, N = the 48
//          channels, W^T staged once as B.  The tile's 72 positions are
//          9/8 of wgmma's M, so each k step runs two m64n48: slots 0-63
//          and 8-71, of which the second keeps 64-71.  sink = sum of acc
//          * ((u mod 7) + 1) * ((o mod 5) + 1) over positions u and
//          channels o.
//   tpose  dotn + an epilogue on every accumulator: relu, then bf16
//          rounding; out[0:48, 0:128] = the sum over the strips of
//          bf16(relu(acc))[:, 0:128]; sink = the xor of the rounded
//          values (keeps them; follows the accumulation order, compared
//          with nothing).
//   full   dotn + conv1_pool, relu and bf16 rounding of each window's max
//          (relu and rounding are monotonic, so they commute with the
//          max); out[0:85, 0:48] = the sum over the 48 items of the
//          pooled row [85, 48].
// What bounds it on an H100, at batch 128: 14.5 MB of uint8 in and 8.4 MB
// of f32 out, 0.0068 ms at 3.35 TB/s, bound cast and taps; the products
// the conv needs, 2 * 48 * 27 * 3096 * 12 * 128 = 1.23e10 bf16
// operations, 0.0125 ms at 989 TFLOP/s, bound the rest.
namespace stages {

enum Stage { kCast = 0, kTaps, kDotn, kDott, kTpose, kFull };

constexpr int kWs = 258;                // lanes of a plane row
constexpr int kFlat = (144 + 2) * kWs;  // 37,668 bytes a plane
constexpr int kItems = 48;              // pooled rows a frame
constexpr int kOutW = (256 - 3) / 3 + 1;  // 85 pooled columns
constexpr int kCout = 48;
constexpr int kK = 32;    // the weights' row
constexpr int kOut = 128;  // out is [128, 128] a frame
constexpr int kThreads = 128 * kConv1Warpgroups;
constexpr int kTiles = (kWs + kConv1Cols - 1) / kConv1Cols;  // 11
// launch_conv1's raw-row bytes for 11 tiles: the row's pixels -1 .. 266.
constexpr int kRs = 832;
constexpr int kRawBytes = cutdet::kRowsStaged * kRs;
constexpr int kTileBytes = cutdet::kRowsStaged * 3 * 256;
// An item's copy, per plane: flat bytes from base = (3r * 258 - 4) & ~3
// (4-byte aligned), lead = 0 or 2 bytes before pixel -4 of plane row 3r,
// through pixel 267 of plane row 3r + 4; zero outside the plane.
constexpr int kSpanWords = (2 + 4 * kWs + 272 + 3) / 4;  // 327
constexpr int kSpanPlane = 1312;  // 16-byte multiple >= 4 * kSpanWords
constexpr int kSpanSlot = 3 * kSpanPlane;  // one item, three planes
constexpr int kGroups = 68;  // 4-pixel groups a raw row: pixels -4 .. 267
constexpr int kPerWg = 2 * kTileBytes + 2 * kSpanSlot + kRawBytes;
constexpr int kPartBytes = kCout * kOut * 4;  // a warpgroup's partial
constexpr int kWtBytes = 3 * kCout * 16 * 2;  // dott's W^T, in the partials'
                                              // room (dott has none)
constexpr size_t kSmem =
    kConv1Warpgroups * (kPartBytes + kPerWg) + 128;

static_assert(kSmem <= kSmemLimit, "conv1_stages: shared memory");
static_assert(kRs >= kRawLead + 3 * (kConv1Cols * kTiles - 1) + 12,
              "conv1_stages: raw row");
static_assert(kRs >= kRawLead + 3 * (4 * kGroups - 4) + 12,
              "conv1_stages: interleave");

// Copy item r's planar bytes of frame b to ``slot`` (one cp.async group
// per thread).
__device__ __forceinline__ void copy_span(const uint8_t* __restrict__ x,
                                          unsigned char* slot, int b, int r,
                                          int lt) {
  const uint32_t dst0 = static_cast<uint32_t>(__cvta_generic_to_shared(slot));
  const int base = (3 * r * kWs - 4) & ~3;
  for (int i = lt; i < 3 * kSpanWords; i += 128) {
    const int c = i / kSpanWords, wd = i - c * kSpanWords;
    const int at = base + 4 * wd;
    const bool valid = at >= 0 && at + 4 <= kFlat;
    const uint8_t* src =
        valid ? x + (static_cast<size_t>(b) * 3 + c) * kFlat + at : x;
    cutdet::cp_async4(dst0 + c * kSpanPlane + 4 * wd, src, valid);
  }
  cutdet::cp_async_commit();
}

// Item r's raw rows from its copy: raw row sr, pixels 4g - 4 .. 4g - 1,
// as 12 interleaved bytes (plane 0, 1, 2 of each pixel), three words.
__device__ __forceinline__ void interleave(const unsigned char* span,
                                           unsigned char* raw, int r,
                                           int lt) {
  const int lead = (3 * r * kWs - 4) - ((3 * r * kWs - 4) & ~3);
  const uint32_t* sp = reinterpret_cast<const uint32_t*>(span);
  for (int i = lt; i < cutdet::kRowsStaged * kGroups; i += 128) {
    const int sr = i / kGroups, g = i - sr * kGroups;
    const int o = lead + sr * kWs + 4 * g;
    const int a = o >> 2, sh = (o & 3) * 8;
    uint32_t p[3];  // pixels 4g - 4 .. 4g - 1 of plane c
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = __funnelshift_r(sp[c * (kSpanPlane / 4) + a],
                             sp[c * (kSpanPlane / 4) + a + 1], sh);
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(raw + sr * kRs + kRawLead - 12 + 12 * g);
    dst[0] = __byte_perm(__byte_perm(p[0], p[1], 0x1040), p[2], 0x3410);
    dst[1] = __byte_perm(__byte_perm(p[1], p[0], 0x2601), p[2], 0x3250);
    dst[2] = __byte_perm(__byte_perm(p[2], p[0], 0x3072), p[1], 0x3710);
  }
}

// Column (within the tile) of slot sn (0-23) of a conv row of the tile:
// the inverse of pack_tile's order (slot 8 (u / 2) + 2 (wl / 2) + u % 2
// holds column 3 wl + c % 3, u = 3 (wl % 2) + c % 3).
__device__ __forceinline__ int slot_col(int sn) {
  const int i = sn / 8, rr = sn % 8, u = 2 * i + (rr & 1);
  return 3 * (2 * (rr / 2) + u / 3) + u % 3;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
    conv1_stages(const uint8_t* __restrict__ x, const bf16* __restrict__ w,
                 float* __restrict__ out, float* __restrict__ sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int warp = lt / 32, g = (lt % 32) >> 2, t = lt & 3;
  float* part = reinterpret_cast<float*>(smem + wg * kPartBytes);
  unsigned char* wt = smem;
  unsigned char* mine = smem + kConv1Warpgroups * kPartBytes + wg * kPerWg;
  unsigned char* tiles = mine;
  unsigned char* spans = mine + 2 * kTileBytes;
  unsigned char* raw = spans + 2 * kSpanSlot;
  float* red = reinterpret_cast<float*>(
      smem + kConv1Warpgroups * (kPartBytes + kPerWg));
  Conv1Plan plan{};
  plan.rs = kRs;

  if constexpr (S != kDott)
    for (int i = lt; i < kCout * kOut; i += 128) part[i] = 0.f;
  const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w);
  auto wv = [&](int o, int dy, int k) -> uint32_t {
    return k < 9 && o < kCout ? wbits[o * kK + dy * 9 + k] : 0u;
  };
  if constexpr (S == kDott) {  // B of step dy: W^T [16 k x 48], K-major
    for (int i = threadIdx.x; i < 3 * kCout * 16; i += kThreads) {
      const int dy = i / (kCout * 16), n = (i / 16) % kCout, k = i % 16;
      reinterpret_cast<unsigned short*>(
          wt + dy * (kCout * 32) + (n / 8) * 256 + (k / 8) * 128 +
          (n % 8) * 16)[k % 8] = static_cast<unsigned short>(wv(n, dy, k));
    }
    cutdet::fence_proxy_async();
  }
  // conv1_block_mma's A: step dy's m16k16 fragment, rows (channels)
  // 16 warp + g and + 8, k 2t, 2t + 1 and 2t + 8, 2t + 9 (k = dx * 3 + c).
  uint32_t wa[3][4];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int k = 2 * t + (f >> 1) * 8, o = 16 * warp + g + (f & 1) * 8;
      wa[dy][f] = wv(o, dy, k) | wv(o, dy, k + 1) << 16;
    }
  __syncthreads();

  uint32_t chk = 0;  // taps: the packed words' sum; tpose: xor
  float sum = 0.f;   // dott: the weighted sum of acc
  float cw[12];      // dott: the weights of this thread's channels
#pragma unroll
  for (int i = 0; i < 12; ++i)
    cw[i] = static_cast<float>((8 * (i / 2) + 2 * t + i % 2) % 5 + 1);
  const uint32_t tile_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(tiles));
  const uint32_t wt_s = static_cast<uint32_t>(__cvta_generic_to_shared(wt));
  constexpr int kStep = kConv1Warpgroups;
  copy_span(x, spans, b, wg, lt);
  for (int k = 0, r = wg; r < kItems; ++k, r += kStep) {
    // The next item's copy goes to the slot whose interleave the barrier
    // after it closed.
    if (r + kStep < kItems)
      copy_span(x, spans + ((k + 1) & 1) * kSpanSlot, b, r + kStep, lt);
    else
      cutdet::cp_async_commit();
    cutdet::cp_async_wait_group<1>();  // this item's bytes have landed
    cutdet::warpgroup_sync(1 + wg);
    interleave(spans + (k & 1) * kSpanSlot, raw, r, lt);
    cutdet::warpgroup_sync(1 + wg);
    if constexpr (S == kCast) {
      if (r == 0)
        for (int i = lt; i < kCout * kOut; i += 128)
          part[i] = static_cast<float>(raw[kRawLead + 3 * (i % kOut)]);
    } else {
      for (int j = 0; j < kTiles; ++j) {
        const uint32_t tile = tile_s + (j & 1) * kTileBytes;
        pack_tile<false, S == kTaps>(raw, tiles + (j & 1) * kTileBytes, j, r,
                                     plan, lt, &chk);
        cutdet::warpgroup_sync(1 + wg);
        if constexpr (S == kTaps) continue;
        if constexpr (S == kDott) {
          const int mi = (lt % 32) / 8, r8 = lt % 8;
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            float d[24];
#pragma unroll
            for (int i = 0; i < 24; ++i) d[i] = 0.f;
#pragma unroll
            for (int i = 0; i < 24; ++i) cutdet::fence_operand(d[i]);
            uint32_t a[3][4];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              cutdet::ldmatrix_x4(a[dy], tile + (3 * dy + pass + 2 * warp +
                                                 (mi & 1)) * 256 +
                                             (mi >> 1) * 128 + r8 * 16);
            cutdet::wgmma_fence();
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              cutdet::Wgmma<48>::mma(
                  d, a[dy],
                  cutdet::smem_desc(wt_s + dy * (kCout * 32), 128, 256));
            cutdet::wgmma_commit();
            cutdet::wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 24; ++i) cutdet::fence_operand(d[i]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = 8 * pass + 16 * warp + g + 8 * h;  // tile slot
              const int cy = n / 24, col = kConv1Cols * j + slot_col(n % 24);
              if ((pass == 0 || n >= 64) && col < kWs) {
                const float pw =
                    static_cast<float>(((3 * r + cy) * kWs + col) % 7 + 1);
#pragma unroll
                for (int i = 0; i < 12; ++i)
                  sum = fmaf(d[2 * (i / 2) * 2 + 2 * h + i % 2] * pw, cw[i],
                             sum);
              }
            }
          }
          continue;
        }
        float d[36];
        conv1_mma(tile, wa, d);
        if constexpr (S == kTpose) {
#pragma unroll
          for (int i = 0; i < 36; i += 2) {
            const __nv_bfloat162 z =
                __floats2bfloat162_rn(fmaxf(d[i], 0.f), fmaxf(d[i + 1], 0.f));
            chk ^= *reinterpret_cast<const uint32_t*>(&z);
            d[i] = __low2float(z);
            d[i + 1] = __high2float(z);
          }
        }
        if constexpr (S == kDotn || S == kTpose) {
          // Conv row 0 of item 4s is row 0 of strip s; tiles 0-5 hold its
          // columns 0-143.
          if (r % 4 == 0 && j < 6) {
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = kConv1Cols * j + slot_col(8 * i + 2 * t + e);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int o = 16 * warp + g + 8 * h;
                  if (o < kCout && col < kOut)
                    part[o * kOut + col] += d[4 * i + 2 * h + e];
                }
              }
          }
        }
        if constexpr (S == kFull) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = 16 * warp + g + 8 * h;
            float m[2];
            conv1_pool(d, h, m[0], m[1]);
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int q = kConv1Windows * j + 2 * t + v;
              if (o < kCout && q < kOutW)
                part[q * kCout + o] += __bfloat162float(
                    __float2bfloat16_rn(fmaxf(m[v], 0.f)));
            }
          }
        }
      }
    }
  }
  cutdet::cp_async_wait_group<0>();

  // The checksum: summed (taps, dott) or xored (tpose) over the block.
  if constexpr (S == kTaps || S == kTpose) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, chk, off);
      chk = S == kTaps ? chk + other : chk ^ other;
    }
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = __uint_as_float(chk);
  } else if constexpr (S == kDott) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    if constexpr (S == kTaps || S == kTpose) {
      uint32_t all = 0;
      for (int i = 0; i < kThreads / 32; ++i) {
        const uint32_t c = __float_as_uint(red[i]);
        all = S == kTaps ? all + c : all ^ c;
      }
      v = __uint_as_float(all);
    } else if constexpr (S == kDott) {
      for (int i = 0; i < kThreads / 32; ++i) v += red[i];
    }
    sink[b] = v;
  }

  // out: the partials added in warpgroup order; zero where the stage
  // defines nothing.
  float* o = out + static_cast<size_t>(b) * kOut * kOut;
  const float* p0 = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < kOut * kOut; i += kThreads) {
    const int row = i / kOut, col = i % kOut;
    int at = -1;
    if constexpr (S == kCast || S == kDotn || S == kTpose) {
      if (row < kCout) at = i;
    } else if constexpr (S == kFull) {
      if (row < kOutW && col < kCout) at = row * kCout + col;
    }
    float v = 0.f;
    if (at >= 0)
      for (int k = 0; k < kConv1Warpgroups; ++k)
        v += p0[k * (kPartBytes / 4) + at];
    o[i] = v;
  }
}

template <int S>
int launch_stages(const void* x, const void* w, void* out, void* sink,
                  int batch, cudaStream_t stream) {
  auto kernel = conv1_stages<S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, kSmem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const bf16*>(w),
      static_cast<float*>(out), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stages


template <typename I>
int launch_mma(const void* x, const void* w, const void* bias,
               const void* scale, const void* offset, void* out,
               const Shape& s, cudaStream_t stream) {
  // The narrowest N that needs no more channel groups than N = 64 does.
  const int groups64 = (s.Cout + 63) / 64;
  const int N = (s.Cout + 31) / 32 <= groups64   ? 32
                : (s.Cout + 47) / 48 <= groups64 ? 48
                                                 : 64;
  using In = typename I::in_t;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  MmaPlan p{};
  p.s = s;
  p.tiles = (s.Wp + kBandWindows - 1) / kBandWindows;
  p.wst = kBandCols * p.tiles + 2;
  if constexpr (kI8<I>) {
    // K ordered (dy, then the 3 * ps contiguous bytes of the row's three
    // staged pixels) in k32 steps: at Cin = 48, ps = 48 and a row is 5
    // steps, the fifth's last 16 bytes reading the next pixel against zero
    // weights.  An odd number of 16-byte units keeps an ldmatrix's eight
    // rows in eight bank groups.
    if (s.Cin % 4 || s.Cout % 4) return static_cast<int>(cudaErrorInvalidValue);
    p.ps = 16 * (((s.Cin + 15) / 16) | 1);
    p.kc = (3 * p.ps + 31) / 32;
    p.steps = 3 * p.kc;
    p.staging = Staging::kCopy;
    p.chunk = s.Cin % 16 == 0 && x16 ? 16 : 4;
  } else {
    p.cpad = (s.Cin + 15) / 16 * 16;
    p.ps = p.cpad + 8;
    p.kc = p.cpad / 16;
    p.steps = 9 * p.kc;
    p.staging = Staging::kElement;
    if (!I::in_cm && x16 && std::is_same_v<In, bf16> && s.Cin % 8 == 0)
      p.staging = Staging::kCopy;
    if (!I::in_cm && x16 && std::is_same_v<In, float> && s.Cin % 4 == 0)
      p.staging = Staging::kF32x4;
    p.wvec = s.Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  }
  p.w_bytes = static_cast<uint32_t>(align128(size_t(p.steps) * N * 32));
  p.off_bytes = static_cast<uint32_t>(align128(size_t(p.steps) * 4));
  // (int8: 16 bytes of slack for the last pixel's read past its row.)
  p.buf_bytes = static_cast<uint32_t>(
      align128(size_t(cutdet::kRowsStaged) * p.wst * p.ps * (kI8<I> ? 1 : 2) +
               (kI8<I> ? 16 : 0)));
  const size_t scratch_wg = size_t(kTileRows) * (N + 8) * 4;
  size_t smem = 0;
  for (int nwg = p.tiles < kMaxWarpgroups ? p.tiles : kMaxWarpgroups;
       nwg >= 1 && !smem; --nwg) {
    for (int nbuf = p.staging == Staging::kCopy ? 2 : 1; nbuf >= 1 && !smem;
         --nbuf) {
      const size_t need =
          p.w_bytes + p.off_bytes + nwg * scratch_wg + nbuf * p.buf_bytes;
      if (need <= kSmemLimit) {
        p.nwg = nwg;
        p.nbuf = nbuf;
        p.scratch_bytes = static_cast<uint32_t>(nwg * scratch_wg);
        smem = need;
      }
    }
  }
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 32:
      return launch_mma_n<I, 32>(x, w, bias, scale, offset, out, p, smem,
                                 stream);
    case 48:
      return launch_mma_n<I, 48>(x, w, bias, scale, offset, out, p, smem,
                                 stream);
    default:
      return launch_mma_n<I, 64>(x, w, bias, scale, offset, out, p, smem,
                                 stream);
  }
}

// ---------------------------------------------------------------------
// CUDA-core route (f32).

struct FmaPlan {
  Shape s;
  int c4;      // Cin rounded up to 4
  int sp;      // staged pixel stride, floats (c4 + 4)
  int wst;     // staged columns: 3 * Wp + 2
  int cg;      // output channels per group (a multiple of 4)
  int ip;      // items a block stages and runs at once
  int tasks;   // threads' work per item: (cg / 4) * Wp (uint8: Wp)
  int rs;      // uint8: bytes per raw row
  bool vec;    // 16-byte cp.async staging of the input (Cin % 4 == 0)
  bool wvec;   // ... and of the weights (Cout % 4 == 0)
  bool rvec;   // uint8: raw rows copied by 16-byte cp.async
  bool bulk;   // uint8: each item's output stored by one bulk copy
  uint32_t w_bytes, buf_bytes;
  // uint8: the bias and BN affine, an item's raw rows and its pooled
  // output ([Wp][Cout] floats, as in ``out``).
  uint32_t par_bytes, raw_bytes, out_bytes;
};

__device__ void stage_fma(const float* __restrict__ x, float* dst, int item,
                          const FmaPlan& p) {
  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  const float* xb = x + static_cast<size_t>(b) * s.H * s.W * s.Cin;
  const int y0 = 3 * r - 1;
  if (p.vec) {
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int chunks = p.c4 / 4;
    const int total = cutdet::kRowsStaged * p.wst * chunks;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int ch = i % chunks;
      const int rest = i / chunks;
      const int col = rest % p.wst;
      const int sr = rest / p.wst;
      const int y = y0 + sr, xc = col - 1;
      const bool valid = y >= 0 && y < s.H && xc >= 0 && xc < s.W;
      const float* src =
          valid ? xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin + ch * 4
                : xb;
      cutdet::cp_async16(base + (rest * p.sp + ch * 4) * 4, src, valid);
    }
    return;
  }
  unrolled<8>(
      cutdet::kRowsStaged * p.wst * p.c4, threadIdx.x, blockDim.x,
      [&](int i) {
        const int c = i % p.c4;
        const int rest = i / p.c4;
        const int col = rest % p.wst;
        const int sr = rest / p.wst;
        const int y = y0 + sr, xc = col - 1;
        return y >= 0 && y < s.H && xc >= 0 && xc < s.W && c < s.Cin
                   ? __ldg(xb + (static_cast<size_t>(y) * s.W + xc) * s.Cin +
                           c)
                   : 0.f;
      },
      [&](int i, float v) { dst[(i / p.c4) * p.sp + i % p.c4] = v; });
}

// Channels 4*o4..4*o4+3 of the group at pooled column px.
template <typename I>
__device__ void fma_task(const float* in, const float* wsm, int o4, int px,
                         int item, int o_base, const FmaPlan& p,
                         const float* __restrict__ bias,
                         const float* __restrict__ scale,
                         const float* __restrict__ offset,
                         float* __restrict__ out) {
  float acc[3][3][4];  // conv row, conv column, channel
#pragma unroll
  for (int cy = 0; cy < 3; ++cy)
#pragma unroll
    for (int cx = 0; cx < 3; ++cx)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[cy][cx][i] = 0.f;
  const float* wv = wsm + 4 * o4;
  for (int dy = 0; dy < 3; ++dy) {
    for (int c = 0; c < p.c4; c += 4) {
      float4 wq[3][4];  // dx, input channel c + ci -> 4 output channels
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
          wq[dx][ci] = *reinterpret_cast<const float4*>(
              wv + ((dy * 3 + dx) * p.c4 + c + ci) * p.cg);
#pragma unroll
      for (int cy = 0; cy < 3; ++cy) {
        // Staged columns 3px .. 3px+4 of staged row cy + dy.
        const float* prow = in + ((cy + dy) * p.wst + 3 * px) * p.sp + c;
        float4 v[5];
#pragma unroll
        for (int k = 0; k < 5; ++k)
          v[k] = *reinterpret_cast<const float4*>(prow + k * p.sp);
#pragma unroll
        for (int cx = 0; cx < 3; ++cx)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float vc[4] = {v[cx + dx].x, v[cx + dx].y, v[cx + dx].z,
                                 v[cx + dx].w};
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) {
              const float4 wc = wq[dx][ci];
              float(&a)[4] = acc[cy][cx];
              a[0] = fmaf(vc[ci], wc.x, a[0]);
              a[1] = fmaf(vc[ci], wc.y, a[1]);
              a[2] = fmaf(vc[ci], wc.z, a[2]);
              a[3] = fmaf(vc[ci], wc.w, a[3]);
            }
          }
      }
    }
  }
  const Shape& s = p.s;
  const int b = item / s.Hp, r = item - b * s.Hp;
  float* orow =
      out + ((static_cast<size_t>(b) * s.Hp + r) * s.Wp + px) * s.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oc = o_base + 4 * o4 + i;
    if (oc >= s.Cout) continue;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int cy = 0; cy < 3; ++cy)
#pragma unroll
      for (int cx = 0; cx < 3; ++cx) m = fmaxf(m, acc[cy][cx][i]);
    orow[oc] = cutdet::epilogue<I::epi>(m, bias[oc], scale[oc], offset[oc]);
  }
}

// Layer 1 (uint8, exactly 3 channels): every output channel of the group
// at pooled column px.  The thread widens the 5 x 5 pixels x 3 channels
// under its pool window (staged rows 0-4, input columns 3px-1 .. 3px+3)
// from the raw rows into registers once, then walks the channels four at
// a time: 27 weight float4s, the same address across the warp (one
// shared-memory wavefront each), for 972 FMAs, none on a pad.  The pooled
// outputs, with the bias and BN affine from ``par``, go to ``dst``, the
// column's row of the item's output in shared memory.
template <typename I>
__device__ void fma_column(const unsigned char* raw, const float* wsm,
                           const float* par, int px, const FmaPlan& p,
                           float* dst) {
  float v[5][5][3];  // staged row, column from 3px - 1, channel
#pragma unroll
  for (int sr = 0; sr < 5; ++sr)
#pragma unroll
    for (int e = 0; e < 15; ++e)  // zeros outside the frame (copy_rows)
      v[sr][e / 3][e % 3] = raw[sr * p.rs + kRawLead + 3 * (3 * px - 1) + e];
#pragma unroll 1
  for (int o = 0; o < p.cg; o += 4) {
    float acc[3][3][4];  // conv row, conv column, channel
#pragma unroll
    for (int cy = 0; cy < 3; ++cy)
#pragma unroll
      for (int cx = 0; cx < 3; ++cx)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[cy][cx][i] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 wv = *reinterpret_cast<const float4*>(
              wsm + ((dy * 3 + dx) * p.c4 + c) * p.cg + o);
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int cy = 0; cy < 3; ++cy)
#pragma unroll
            for (int cx = 0; cx < 3; ++cx)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[cy][cx][i] =
                    fmaf(v[cy + dy][cx + dx][c], wc[i], acc[cy][cx][i]);
        }
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int cy = 0; cy < 3; ++cy)
#pragma unroll
        for (int cx = 0; cx < 3; ++cx) m = fmaxf(m, acc[cy][cx][i]);
      y[i] = cutdet::epilogue<I::epi>(m, par[o + i], par[p.cg + o + i],
                                      par[2 * p.cg + o + i]);
    }
    if (p.s.Cout % 4 == 0) {
      *reinterpret_cast<float4*>(dst + o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (o + i < p.s.Cout) dst[o + i] = y[i];
    }
  }
}

// Layer 1 on the CUDA cores (uint8 in, one output-channel group): ip
// items a round, one pooled column a thread.  The next round's raw rows
// are copied while this round's run; each item's output, gathered in
// shared memory, leaves by one bulk copy that runs on into the next round
// (or, where the sizes do not allow it, by all threads).
template <typename I>
__device__ void conv1_rounds(const uint8_t* __restrict__ x, const float* wsm,
                             float* bufs, const FmaPlan& p,
                             const float* __restrict__ bias,
                             const float* __restrict__ scale,
                             const float* __restrict__ offset,
                             float* __restrict__ out) {
  const Shape& s = p.s;
  float* par = bufs - p.par_bytes / 4;
  for (int i = threadIdx.x; i < 3 * p.cg; i += blockDim.x) {
    const int oc = i % p.cg;
    const float* src = i < p.cg ? bias : i < 2 * p.cg ? scale : offset;
    par[i] = oc < s.Cout ? src[oc] : 0.f;
  }
  unsigned char* raws = reinterpret_cast<unsigned char*>(bufs);
  float* outs = reinterpret_cast<float*>(raws + 2 * p.ip * p.raw_bytes);
  zero_raw_pads(raws, 2 * p.ip * cutdet::kRowsStaged, p.rs, s.W, threadIdx.x,
                blockDim.x);
  __syncthreads();  // the pads before the copies
  const int stride = gridDim.x * p.ip, n = s.Wp * s.Cout;
  auto copy = [&](int base, int slot) {
    for (int j = 0; j < p.ip && base + j < s.items; ++j)
      copy_rows(x, raws + (slot * p.ip + j) * p.raw_bytes, base + j, s, p.rs,
                p.rvec, threadIdx.x, blockDim.x);
  };
  copy(blockIdx.x * p.ip, 0);
  for (int k = 0, base = blockIdx.x * p.ip; base < s.items;
       ++k, base += stride) {
    cutdet::cp_async_wait_all();
    if (threadIdx.x == 0) cutdet::bulk_wait_read<0>();  // outs is free
    __syncthreads();
    if (base + stride < s.items) copy(base + stride, (k + 1) & 1);
    for (int t = threadIdx.x; t < p.ip * p.tasks; t += blockDim.x) {
      const int j = t / p.tasks;
      if (base + j >= s.items) break;
      const int px = t - j * p.tasks;
      fma_column<I>(raws + ((k & 1) * p.ip + j) * p.raw_bytes, wsm, par, px,
                    p, outs + j * (p.out_bytes / 4) + px * s.Cout);
    }
    cutdet::fence_proxy_async();  // the bulk copy reads outs
    __syncthreads();
    for (int j = 0; j < p.ip && base + j < s.items; ++j) {
      float* dst = out + static_cast<size_t>(base + j) * n;
      const float* src = outs + j * (p.out_bytes / 4);
      if (p.bulk) {
        if (threadIdx.x == 0)
          cutdet::bulk_store(dst,
                             static_cast<uint32_t>(
                                 __cvta_generic_to_shared(src)),
                             n * 4);
      } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
      }
    }
    if (p.bulk && threadIdx.x == 0) cutdet::bulk_commit();
  }
  if (threadIdx.x == 0) cutdet::bulk_wait_all();
}

template <typename I>
__global__ void __launch_bounds__(kFmaThreads, 1)
    conv_block_fma(const typename I::in_t* __restrict__ x,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset, float* __restrict__ out,
                   FmaPlan p) {
  extern __shared__ __align__(128) float fsm[];
  if (blockIdx.x * p.ip >= p.s.items) return;
  const int o_base = blockIdx.y * p.cg;

  // Weights of this group, once: [dy*3 + dx][c][cg].
  float* wsm = fsm;
  if (p.wvec) {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));
    const int chunks = p.cg / 4;
    for (int i = threadIdx.x; i < 9 * p.c4 * chunks; i += blockDim.x) {
      const int ch = i % chunks;
      const int rest = i / chunks;
      const int c = rest % p.c4;
      const int tap = rest / p.c4;
      const int o = o_base + 4 * ch;
      const bool valid = c < p.s.Cin && o < p.s.Cout;
      cutdet::cp_async16(
          base + i * 16,
          valid ? w + (static_cast<size_t>(tap) * p.s.Cin + c) * p.s.Cout + o
                : w,
          valid);
    }
  } else {
    unrolled<8>(
        9 * p.c4 * p.cg, threadIdx.x, blockDim.x,
        [&](int i) {
          const int o = o_base + i % p.cg;
          const int rest = i / p.cg;
          const int c = rest % p.c4;
          const int tap = rest / p.c4;
          return c < p.s.Cin && o < p.s.Cout
                     ? __ldg(w + (static_cast<size_t>(tap) * p.s.Cin + c) *
                                     p.s.Cout +
                             o)
                     : 0.f;
        },
        [&](int i, float v) { wsm[i] = v; });
  }
  float* bufs = fsm + (p.w_bytes + p.par_bytes) / 4;
  if constexpr (kU8<I>) {
    conv1_rounds<I>(x, wsm, bufs, p, bias, scale, offset, out);
  } else {
    // ip items at a time: stage them all, then every thread runs tasks.
    for (int base = blockIdx.x * p.ip; base < p.s.items;
         base += gridDim.x * p.ip) {
      for (int j = 0; j < p.ip && base + j < p.s.items; ++j)
        stage_fma(x, bufs + j * (p.buf_bytes / 4), base + j, p);
      cutdet::cp_async_wait_all();
      __syncthreads();
      const int per = p.cg / 4;
      for (int t = threadIdx.x; t < p.ip * p.tasks; t += blockDim.x) {
        const int j = t / p.tasks;
        if (base + j >= p.s.items) break;
        const int tt = t - j * p.tasks;
        fma_task<I>(bufs + j * (p.buf_bytes / 4), wsm, tt % per, tt / per,
                    base + j, o_base, p, bias, scale, offset, out);
      }
      __syncthreads();
    }
  }
}

template <typename I>
int launch_fma(const void* x, const void* w, const void* bias,
               const void* scale, const void* offset, void* out,
               const Shape& s, cudaStream_t stream) {
  FmaPlan p{};
  p.s = s;
  p.c4 = (s.Cin + 3) / 4 * 4;
  p.sp = p.c4 + 4;
  p.wst = 3 * s.Wp + 2;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec = !kU8<I> && s.Cin % 4 == 0 && x16;
  p.wvec = s.Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // Per item: a staged f32 tile, or (uint8) two slots of its raw rows
  // (zero pads around the frame's columns) and its output.
  p.buf_bytes = static_cast<uint32_t>(
      kU8<I> ? 0 : align128(size_t(cutdet::kRowsStaged) * p.wst * p.sp * 4));
  // (3 bytes past the frame: the last window's pixels reach column W.)
  p.rs = (kRawLead + 3 * s.W + 3 + 15) / 16 * 16;
  p.rvec = x16 && 3 * s.W % 16 == 0;
  p.raw_bytes = static_cast<uint32_t>(kU8<I> ? cutdet::kRowsStaged * p.rs : 0);
  p.out_bytes = static_cast<uint32_t>(
      kU8<I> ? align128(size_t(s.Wp) * s.Cout * 4) : 0);
  p.bulk = reinterpret_cast<uintptr_t>(out) % 16 == 0 && s.Wp * s.Cout % 4 == 0;
  const size_t item_bytes = p.buf_bytes + 2 * size_t(p.raw_bytes) + p.out_bytes;
  if (kU8<I> && s.Cin != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int cout4 = (s.Cout + 3) / 4 * 4;
  size_t smem = 0;
  // The fewest output-channel groups whose weights fit beside one item
  // (uint8: one group), then as many items at once as fill the block's
  // threads and fit.
  for (int groups = 1; groups <= (kU8<I> ? 1 : cout4 / 4) && !smem;
       ++groups) {
    const int per = (cout4 / 4 + groups - 1) / groups * 4;
    p.par_bytes = static_cast<uint32_t>(kU8<I> ? align128(3 * per * 4) : 0);
    const size_t wb = align128(size_t(9) * p.c4 * per * 4) + p.par_bytes;
    if (wb + item_bytes > kSmemLimit) continue;
    p.cg = per;
    p.w_bytes = static_cast<uint32_t>(wb - p.par_bytes);
    p.tasks = (kU8<I> ? 1 : per / 4) * s.Wp;
    p.ip = kFmaThreads / p.tasks > 1 ? kFmaThreads / p.tasks : 1;
    while (p.ip > 1 && wb + p.ip * item_bytes > kSmemLimit) --p.ip;
    smem = wb + p.ip * item_bytes;
  }
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cout4 + p.cg - 1) / p.cg;
  int threads = (p.ip * p.tasks + 31) / 32 * 32;
  if (threads > kFmaThreads) threads = kFmaThreads;
  auto kernel = conv_block_fma<I>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rounds = (s.items + p.ip - 1) / p.ip;
  const dim3 grid(persistent_blocks(kernel, threads, smem, rounds, groups),
                  groups);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename I::in_t*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename I, bool Fma>
int launch(const void* x, const void* w, const void* bias, const void* scale,
           const void* offset, void* out, int B, int H, int W, int Cin,
           int Cout, void* stream) {
  if (B <= 0 || H < 3 || W < 3 || Cin <= 0 || Cout <= 0 || Cout > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{H, W, Cin, Cout, H / 3, (W - 3) / 3 + 1, B * (H / 3)};
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (Fma) {
    return launch_fma<I>(x, w, bias, scale, offset, out, s, st);
  } else if constexpr (kU8<I>) {
    return launch_conv1<I>(x, w, bias, scale, offset, out, s, st);
  } else {
    return launch_mma<I>(x, w, bias, scale, offset, out, s, st);
  }
}

}  // namespace

#define CUTDET_CONV_BLOCK(NAME, INSTANCE, FMA)                              \
  extern "C" int NAME(const void* x, const void* w, const void* bias,        \
                      const void* scale, const void* offset, void* out,      \
                      int B, int H, int W, int Cin, int Cout, void* stream) { \
    return launch<INSTANCE, FMA>(x, w, bias, scale, offset, out, B, H, W,    \
                                 Cin, Cout, stream);                         \
  }

CUTDET_CONV_BLOCK(cutdet_conv_block_f32, F32, true)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_operands, Bf16Operands, false)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_xla, Bf16Xla, false)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_xla_f32, Bf16XlaF32, false)
CUTDET_CONV_BLOCK(cutdet_conv_block_bf16_out, Bf16Out, false)
CUTDET_CONV_BLOCK(cutdet_conv_block_cm_bf16, CmBf16, false)
CUTDET_CONV_BLOCK(cutdet_conv_block_cm_f32, CmF32, false)

// Layer 1 (conv1_block): B frames of uint8 [H, W, 3].
#define CUTDET_CONV1_BLOCK(NAME, INSTANCE, FMA)                             \
  extern "C" int NAME(const void* x, const void* w, const void* bias,        \
                      const void* scale, const void* offset, void* out,      \
                      int B, int H, int W, int Cout, void* stream) {         \
    return launch<INSTANCE, FMA>(x, w, bias, scale, offset, out, B, H, W, 3, \
                                 Cout, stream);                              \
  }

CUTDET_CONV1_BLOCK(cutdet_conv1_block, U8F32, true)
CUTDET_CONV1_BLOCK(cutdet_conv1_block_bf16, U8Bf16, false)
CUTDET_CONV1_BLOCK(cutdet_conv1_block_bf16_xla, U8Bf16Xla, false)

// The int8_mxu block: its so (f32 [Cout], the weight scale), ring (f32 [3,
// W, Cout], the constant term's top, interior and bottom rows) and scale
// (f32 [Cout], the activation scale) take the places of the other
// instances' bias, BN scale and BN offset.  Mid-stack: int8 codes [B, H, W,
// Cin], Cin % 4 == 0; layer 1: uint8 BGR [B, H, W, 3].  Cout % 4 == 0.
extern "C" int cutdet_conv_block_i8(const void* x, const void* w,
                                    const void* so, const void* ring,
                                    const void* scale, void* out, int B,
                                    int H, int W, int Cin, int Cout,
                                    void* stream) {
  return launch<I8, false>(x, w, so, ring, scale, out, B, H, W, Cin, Cout,
                           stream);
}

extern "C" int cutdet_conv1_block_i8(const void* x, const void* w,
                                     const void* so, const void* ring,
                                     const void* scale, void* out, int B,
                                     int H, int W, int Cout, void* stream) {
  return launch<U8I8, false>(x, w, so, ring, scale, out, B, H, W, 3, Cout,
                             stream);
}

// The stage-bisection kernel of layer 1: x [batch, 3, 37668] uint8
// (4-byte aligned), w [48, 32] bf16; out [batch, 128, 128] f32, sink
// [batch] f32.
extern "C" int cutdet_conv1_stages(int stage, const void* x, const void* w,
                                   void* out, void* sink, int batch,
                                   cudaStream_t stream) {
  using namespace stages;
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case kCast: return launch_stages<kCast>(x, w, out, sink, batch, stream);
    case kTaps: return launch_stages<kTaps>(x, w, out, sink, batch, stream);
    case kDotn: return launch_stages<kDotn>(x, w, out, sink, batch, stream);
    case kDott: return launch_stages<kDott>(x, w, out, sink, batch, stream);
    case kTpose:
      return launch_stages<kTpose>(x, w, out, sink, batch, stream);
    case kFull: return launch_stages<kFull>(x, w, out, sink, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cutdet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
