// The int8_mxu block: int8 x int8 -> int32 conv3x3 (zero pad 1), the
// deferred affine's epilogue, max pool 3x3/3 (floor), int8 codes out.
//
// Replaces what the JAX package leaves to XLA at --precision int8_mxu
// (cut_detection_tpu/models/layers.py:229-280, apply_conv_block_i8, with
// the conv of cut_detection_tpu/ops/nn.py:73, conv2d_same_i8): no Pallas
// kernel lies behind it, and PyTorch has no int8 convolution with int32
// sums on CUDA.  Per output channel c of a conv pixel:
//   zi = sum over 3x3 taps and input channels of x_i8 * w_i8   (exact)
//   z  = zi * so[c] + ring[c]      so: the weight scale, ring: the
//                                  constant term conv(b*1, W) + bias
//   q  = clip(rint(relu(z) / scale[c]) - 128, -128, 127)   as int8
// then the max over each 3x3 window.  ReLU and the quantization are
// nondecreasing in z, so the kernel pools z first and quantizes the
// window's maximum once: the same code as quantize-then-pool, with one
// division per output instead of nine.  The f32 steps use the _rn
// intrinsics (no FMA contraction, IEEE division), as the plain version's
// separate torch ops round; zi is an integer below 2^24 in magnitude,
// so its conversion to f32 is exact.  The codes equal the plain
// version's (ops/kernels/conv_block_i8.py) with a max diff of 0.
//
// Two entry points:
//   cutdet_conv1_block_i8  layer 1 from raw uint8 BGR [B,H,W,3]: each
//                          pixel is shifted by -128 as it is staged and
//                          its 3 channels padded to one int8x4 word;
//   cutdet_conv_block_i8   int8 NHWC [B,H,W,Cin], Cin % 4 == 0 (48 in
//                          the prod net: 12 words a pixel).
// The kernel is HWIO int8 [3,3,Cin,Cout], Cout % 8 == 0; so and scale are
// f32 [Cout]; out is int8 [B, H/3, (W-3)/3+1, Cout].  The ring comes as
// a strip f32 [3, W, Cout]: the top row, any interior row and the bottom
// row of the [H, W, Cout] canvas, which const_conv_ring builds with all
// interior rows identical (only rows 0 and H-1 see the zero padding).
// The canvas itself would cost 7 MB of re-reads a frame at layer 1.
//
// Design: one block per (pooled row, frame) stages the five input rows
// that row's conv rows read (zero-padded, as int8x4 words with an odd
// word stride per pixel, so a warp's loads at a 3-pixel stride hit
// distinct banks) and the whole kernel, packed to int8x4 words
// [tap][word][Cout], in shared memory.  A thread holds 8 output channels
// of one pool window: for each of its three conv rows it accumulates the
// row's three conv pixels with __dp4a on the CUDA cores (x words reused
// across the three dx taps that read them, weight words broadcast across
// the warp), folds them into the window's running max of z, and at the
// end quantizes and stores 8 bytes.
//
// What bounds it on an H100 (batch 128, prod net): operations, by the
// tensor cores' 1,979 dense int8 TOPS, for the mid-stack block (layer 2
// at 48x85: 21.4 G operations, 0.0108 ms; its 25.1 MB in and 2.8 MB out
// take 0.0083 ms at 3.35 TB/s) and bytes for layer 1 (14.2 MB in, 25.1 MB
// out: 0.0117 ms; 12.2 G operations).  This kernel runs on the CUDA
// cores, whose dp4a rate is a fraction of that: s8 wgmma is the later
// step (ROADMAP), with this kernel's times as its yardstick.
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;          // output channels a thread holds
constexpr int kMaxThreads = 256;
constexpr int kRows = 5;           // input rows a pooled row's conv reads
constexpr size_t kSmemLimit = 227 * 1024;

struct Shape {
  int H, W, Cin, Cout, Hp, Wp;
  int CW;    // int8x4 words per input pixel
  int CWP;   // their stride in shared memory (odd)
  int Wpad;  // W plus the two zero columns
};

__device__ __forceinline__ uint32_t byte_at(int v, int j) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * j);
}

template <bool kU8>
__global__ void __launch_bounds__(kMaxThreads)
    conv_block_i8_kernel(const void* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ so,
                         const float* __restrict__ ring,
                         const float* __restrict__ scale,
                         int8_t* __restrict__ out, Shape s) {
  extern __shared__ int4 smem4[];
  int* xs = reinterpret_cast<int*>(smem4);  // [kRows][Wpad][CWP]
  const int xs_words = (kRows * s.Wpad * s.CWP + 3) & ~3;
  int* ws = xs + xs_words;                  // [9][CW][Cout], 16-aligned
  const int pr = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int CW = kU8 ? 1 : s.CW;

  // The kernel as int8x4 words: channel 4k + j in byte j of word k (the
  // byte order of the x words, so __dp4a pairs like channels).
  const int nw = 9 * CW * s.Cout;
  for (int i = tid; i < nw; i += nt) {
    const int o = i % s.Cout, k = (i / s.Cout) % CW, tap = i / (s.Cout * CW);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * k + j;
      if (c < s.Cin) {
        word |= byte_at(
            w[(static_cast<size_t>(tap) * s.Cin + c) * s.Cout + o], j);
      }
    }
    ws[i] = static_cast<int>(word);
  }
  // Input rows 3pr-1 .. 3pr+3 and columns -1 .. W, zero outside the frame.
  const int nx = kRows * s.Wpad * CW;
  for (int i = tid; i < nx; i += nt) {
    const int k = i % CW, col = (i / CW) % s.Wpad, row = i / (CW * s.Wpad);
    const int gr = 3 * pr - 1 + row, gc = col - 1;
    int v = 0;
    if (gr >= 0 && gr < s.H && gc >= 0 && gc < s.W) {
      const size_t pix = (static_cast<size_t>(b) * s.H + gr) * s.W + gc;
      if constexpr (kU8) {
        const uint8_t* p = static_cast<const uint8_t*>(x) + pix * 3;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          word |= byte_at(static_cast<int>(__ldg(p + j)) - 128, j);
        }
        v = static_cast<int>(word);
      } else {
        v = __ldg(static_cast<const int*>(x) + pix * CW + k);
      }
    }
    xs[(row * s.Wpad + col) * s.CWP + k] = v;
  }
  __syncthreads();

  const int items = s.Wp * (s.Cout / kGroup);
  for (int item = tid; item < items; item += nt) {
    const int pc = item % s.Wp, c0 = (item / s.Wp) * kGroup;
    float sov[kGroup], scv[kGroup], m[kGroup];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(so + c0) + h);
      const float4 d =
          __ldg(reinterpret_cast<const float4*>(scale + c0) + h);
      sov[4 * h] = a.x, sov[4 * h + 1] = a.y, sov[4 * h + 2] = a.z,
              sov[4 * h + 3] = a.w;
      scv[4 * h] = d.x, scv[4 * h + 1] = d.y, scv[4 * h + 2] = d.z,
              scv[4 * h + 3] = d.w;
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) m[c] = -INFINITY;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      int acc[3][kGroup];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[dx][c] = 0;
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // Conv pixels 3pc..3pc+2 read staged columns 3pc..3pc+4.
        const int* xr = xs + ((dy + ky) * s.Wpad + 3 * pc) * s.CWP;
        const int* wr = ws + 3 * ky * CW * s.Cout + c0;
        for (int k = 0; k < CW; ++k) {
          int xv[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) xv[j] = xr[j * s.CWP + k];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int4* wp =
                reinterpret_cast<const int4*>(wr + (kx * CW + k) * s.Cout);
            const int4 w0 = wp[0], w1 = wp[1];
            const int wv[kGroup] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
              for (int c = 0; c < kGroup; ++c) {
                acc[dx][c] = __dp4a(xv[dx + kx], wv[c], acc[dx][c]);
              }
            }
          }
        }
      }
      // z = zi * so + ring for conv row r, into the window's max.
      const int r = 3 * pr + dy;
      const int rs = r == 0 ? 0 : (r == s.H - 1 ? 2 : 1);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4* rp = reinterpret_cast<const float4*>(
            ring + (static_cast<size_t>(rs) * s.W + 3 * pc + dx) * s.Cout +
            c0);
        const float4 r0 = __ldg(rp), r1 = __ldg(rp + 1);
        const float rv[kGroup] = {r0.x, r0.y, r0.z, r0.w,
                                  r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          const float z = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[dx][c]), sov[c]), rv[c]);
          m[c] = fmaxf(m[c], z);
        }
      }
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      float q = rintf(__fdiv_rn(fmaxf(m[c], 0.f), scv[c])) - 128.f;
      q = fminf(fmaxf(q, -128.f), 127.f);
      const uint32_t byte = byte_at(__float2int_rn(q), c % 4);
      if (c < 4) {
        lo |= byte;
      } else {
        hi |= byte;
      }
    }
    *reinterpret_cast<uint2*>(
        out + ((static_cast<size_t>(b) * s.Hp + pr) * s.Wp + pc) * s.Cout +
        c0) = make_uint2(lo, hi);
  }
}

template <bool kU8>
int launch(const void* x, const void* w, const void* so, const void* ring,
           const void* scale, void* out, int B, int H, int W, int Cin,
           int Cout, void* stream) {
  if (B <= 0 || B > 65535 || H < 3 || W < 3 || Cout <= 0 ||
      Cout % kGroup || (kU8 ? Cin != 3 : (Cin <= 0 || Cin % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s;
  s.H = H, s.W = W, s.Cin = Cin, s.Cout = Cout;
  s.Hp = H / 3, s.Wp = (W - 3) / 3 + 1;
  s.CW = (Cin + 3) / 4, s.CWP = s.CW | 1, s.Wpad = W + 2;
  const size_t xs_words =
      (static_cast<size_t>(kRows) * s.Wpad * s.CWP + 3) & ~size_t{3};
  const size_t smem =
      (xs_words + 9 * static_cast<size_t>(s.CW) * Cout) * sizeof(int);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_block_i8_kernel<kU8>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int items = s.Wp * (Cout / kGroup);
  const int threads = items < kMaxThreads ? (items + 31) / 32 * 32
                                          : kMaxThreads;
  const dim3 grid(s.Hp, B);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const int8_t*>(w), static_cast<const float*>(so),
      static_cast<const float*>(ring), static_cast<const float*>(scale),
      static_cast<int8_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cutdet_conv1_block_i8(const void* x, const void* w,
                                     const void* so, const void* ring,
                                     const void* scale, void* out, int B,
                                     int H, int W, int Cout, void* stream) {
  return launch<true>(x, w, so, ring, scale, out, B, H, W, 3, Cout, stream);
}

extern "C" int cutdet_conv_block_i8(const void* x, const void* w,
                                    const void* so, const void* ring,
                                    const void* scale, void* out, int B,
                                    int H, int W, int Cin, int Cout,
                                    void* stream) {
  return launch<false>(x, w, so, ring, scale, out, B, H, W, Cin, Cout,
                       stream);
}
