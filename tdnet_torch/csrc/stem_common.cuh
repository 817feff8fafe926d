// Arithmetic shared by the fused-stem forward (stem.cu) and backward
// (stem_bwd.cu). Both kernels recompute the conv through the same code, so
// the compute-dtype activations the backward routes the pool gradient on are
// bit-identical to the ones the forward pooled.
//
// - normalize<T> and the folded BN (bn) serve both compute dtypes.
// - f32: conv_pixel, the 7x7x3 conv of one pixel on the CUDA cores (taps in
//   (kr, kc, ch) order, one fmaf chain per channel from 0). f32 must match
//   the plain version's full-f32 conv, which the tensor cores (TF32) cannot.
// - bf16: namespace tile, the conv of a tile of conv pixels as a GEMM on the
//   tensor cores. The contraction runs over the 147 taps of the 7x7x3
//   window, zero-padded to K = 160 (8% of K wasted), against N = 64 output
//   channels; M is the tile's conv pixels. The bf16 operands are what the
//   contract already rounds (normalized input and weights, as the Pallas
//   kernel's MXU dots take them), products accumulate in f32 (mma.sync
//   m16n8k16). One output element's value depends only on its im2col row,
//   the weights, the K order (taps in (kr, kc, ch) order, then the zero
//   pad) and the k-step chunking (10 steps of 16 taps, accumulated in order
//   from 0): those are fixed here, so z is the same bit for bit whichever
//   warp or tile computes it.
#pragma once

#include "mma.cuh"

namespace tdnet {
namespace stem {

constexpr int kF = 64;              // output channels
constexpr int kTaps = 7 * 7 * 3;

// (x - mean) * scale, rounded to the compute dtype T, as float
template <typename T>
__device__ __forceinline__ float normalize(uint8_t x, float mean, float scale) {
  return to_float(round_to(
      __fmul_rn(__fsub_rn(static_cast<float>(x), mean), scale), T()));
}

// Conv of one output pixel for NCH consecutive channels. x0 points at the
// pixel's top-left tap in an input window of `row` floats per row (pixels x
// 3 channels interleaved); w at channel 0 of the pixel's channel group in
// (kr, kc, ch, f) weights. acc[j] is the f32 sum for channel j. The result
// of a channel does not depend on NCH: each channel is its own fmaf chain.
template <int NCH>
__device__ __forceinline__ void conv_pixel(const float* __restrict__ x0,
                                           int row,
                                           const float* __restrict__ w,
                                           float (&acc)[NCH]) {
  static_assert(NCH % 4 == 0, "channel groups are float4-aligned");
#pragma unroll
  for (int j = 0; j < NCH; ++j) acc[j] = 0.0f;
  for (int kr = 0; kr < 7; ++kr) {
    for (int kc = 0; kc < 7; ++kc) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float x = x0[kr * row + kc * 3 + ch];
        const float4* wv = reinterpret_cast<const float4*>(
            w + ((kr * 7 + kc) * 3 + ch) * kF);
#pragma unroll
        for (int q = 0; q < NCH / 4; ++q) {
          const float4 wq = wv[q];
          acc[4 * q + 0] = fmaf(x, wq.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x, wq.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x, wq.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x, wq.w, acc[4 * q + 3]);
        }
      }
    }
  }
}

// folded frozen BN in f32, as separate IEEE ops (no contraction)
__device__ __forceinline__ float bn(float z, float inv, float off) {
  return __fadd_rn(__fmul_rn(z, inv), off);
}

// ReLU, rounded to the compute dtype T, as float: the pooled values
template <typename T>
__device__ __forceinline__ float activation(float wp) {
  return to_float(round_to(fmaxf(wp, 0.0f), T()));
}

// ------------------------------------------- the bf16 tensor-core conv tile
//
// A tile is 4 x 8 pooled pixels of one image: 9 x 17 = 153 conv pixels (the
// pool windows overlap by one conv row and column, so a tile recomputes its
// neighbours' edge), M = 160 rows (10 m16 tiles, rows 153-159 zero), from a
// 23 x 39-pixel input window. A warp owns two m16 tiles (32 rows) by all or
// half of the 64 channels. Per tile:
//   1. load_window: cp.async copies the window's uint8 bytes, 4 at a time,
//      into one of two staging buffers (the caller double-buffers across the
//      tiles of its persistent block);
//   2. normalize_window: normalize<bf16> into a bf16 window, 0 outside the
//      image (the conv's zero padding, in normalized space);
//   3. build_im2col: conv pixel m's row of K = 160 taps; its kernel row kr
//      is 21 contiguous values of window row 2r + kr from element 6c on,
//      copied as 4-byte words;
//   4. conv_mma: ldmatrix A (im2col, row stride 336 B: the 8 rows of an
//      8x8 load fall in distinct bank groups) and B (weights, 144 B), 10
//      k-steps of mma.sync into acc[2][NT][4].
namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kTP = 4;                  // pooled rows of a tile
constexpr int kTQ = 8;                  // pooled cols of a tile
constexpr int kCR = 2 * kTP + 1;        // conv rows
constexpr int kCC = 2 * kTQ + 1;        // conv cols
constexpr int kPix = kCR * kCC;         // 153 conv pixels
constexpr int kM = 160;                 // GEMM rows (10 m16 tiles)
constexpr int kIR = 4 * kTP + 7;        // input rows of the window
constexpr int kIC = 4 * kTQ + 7;        // input cols of the window
constexpr int kWinRow = kIC * 3;        // 117 values a window row
constexpr int kWinWords = 30;           // staged 4-byte words a window row
constexpr int kU8Ld = 4 * kWinWords;    // staged bytes a row (byte 3 = col 0)
constexpr int kU8Bytes = kIR * kU8Ld;   // one staging buffer
constexpr int kWinElems = (kIR * kWinRow + 7) / 8 * 8;  // 16-byte padded
constexpr int kK = 160;                 // taps, zero-padded
constexpr int kKSteps = kK / 16;
constexpr int kALd = kK + 8;            // im2col row stride (elements)
constexpr int kBLd = kF + 8;            // weight / activation row stride
constexpr int kMPairs = kM / 32;        // warp row blocks of two m16 tiles

struct Tile {
  int b, p0, q0;                        // image, first pooled row and col
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  Tile r;
  r.q0 = (t % tiles_x) * kTQ;
  r.p0 = ((t / tiles_x) % tiles_y) * kTP;
  r.b = t / (tiles_x * tiles_y);
  return r;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
using tdnet::cp_async16;
using tdnet::cp_async_commit;
using tdnet::cp_async_wait;

// Stage the weights (7, 7, 3, 64) f32 as (kK, kBLd) bf16, rows 147-159 zero.
__device__ __forceinline__ void stage_weights(bf16* s_w, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < kK * kF; i += blockDim.x) {
    const int k = i / kF, f = i - k * kF;
    s_w[k * kBLd + f] = __float2bfloat16_rn(k < kTaps ? w[i] : 0.0f);
  }
}

// Issue the cp.async copies of tile t's uint8 window into buf. The window
// starts at pixel column 4*q0 - 3, byte 12*q0 - 9 of a row; staging from
// the 4-byte word at 12*q0 - 12 puts window column 0 at byte 3. Row starts
// are 4-byte aligned (wd % 4 == 0). Rows outside the image and words
// outside a row are not copied: normalize_window zeroes those pixels.
__device__ __forceinline__ void load_window(uint8_t* buf, const uint8_t* __restrict__ in,
                                            Tile t, int h, int wd) {
  const int row_words = 3 * wd / 4;
  const int w0 = 3 * t.q0 - 3;
  const int ir0 = 4 * t.p0 - 3;
  const uint32_t* img = reinterpret_cast<const uint32_t*>(
      in + static_cast<int64_t>(t.b) * h * wd * 3);
  for (int i = threadIdx.x; i < kIR * kWinWords; i += blockDim.x) {
    const int r = i / kWinWords, j = i - r * kWinWords;
    const int gr = ir0 + r, wi = w0 + j;
    if (gr >= 0 && gr < h && wi >= 0 && wi < row_words) {
      cp_async4(buf + r * kU8Ld + 4 * j,
                img + static_cast<int64_t>(gr) * row_words + wi);
    }
  }
}

__device__ __forceinline__ void normalize_window(bf16* win, const uint8_t* buf, Tile t,
                                                 int h, int wd, float m0, float m1,
                                                 float m2, float scale) {
  const int ir0 = 4 * t.p0 - 3, ic0 = 4 * t.q0 - 3;
  for (int i = threadIdx.x; i < kIR * kIC; i += blockDim.x) {
    const int r = i / kIC, c = i - r * kIC;
    const int gr = ir0 + r, gc = ic0 + c;
    const uint8_t* x = buf + r * kU8Ld + 3 + 3 * c;
    bf16* y = win + r * kWinRow + 3 * c;
    if (gr >= 0 && gr < h && gc >= 0 && gc < wd) {
      // exact: normalize<bf16> is on the bf16 grid
      y[0] = __float2bfloat16_rn(normalize<bf16>(x[0], m0, scale));
      y[1] = __float2bfloat16_rn(normalize<bf16>(x[1], m1, scale));
      y[2] = __float2bfloat16_rn(normalize<bf16>(x[2], m2, scale));
    } else {
      y[0] = y[1] = y[2] = __float2bfloat16_rn(0.0f);
    }
  }
}

// im2col taps 0..146 of rows 0..kPix-1, in (kr, kc, ch) order: one item
// copies kernel row kr of conv pixel m, 21 values. The window's row stride
// (117) is odd and a conv pixel starts at an even column (6c), so the
// source and the destination (21*kr) are 4-byte aligned alike: 10 words
// and one half-word. Taps 147..159 and rows kPix..kM-1 are left as they
// are (the caller zeroes them once).
__device__ __forceinline__ void build_im2col(bf16* a, const bf16* win) {
  for (int i = threadIdx.x; i < kPix * 7; i += blockDim.x) {
    const int m = i / 7, kr = i - 7 * m;
    const int r = m / kCC, c = m - r * kCC;
    const bf16* src = win + (2 * r + kr) * kWinRow + 6 * c;
    bf16* dst = a + m * kALd + 21 * kr;
    const int lead = kr & 1;  // a half-word first, then the words
    if (lead) dst[0] = src[0];
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src + lead);
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + lead);
#pragma unroll
    for (int k = 0; k < 10; ++k) d32[k] = s32[k];
    if (!lead) dst[20] = src[20];
  }
}

// acc[i][j] = the m16 x n8 tile (rows m0 + 16i .., channels n0 + 8j ..)
// of im2col . weights, over the 10 k-steps in order from 0. A warp takes
// 32 rows by NT n8 tiles (NT = 8: all 64 channels; 4: half of them).
template <int NT>
__device__ __forceinline__ void conv_mma(const bf16* a, const bf16* s_w, int m0, int n0,
                                         int lane, float (&acc)[2][NT][4]) {
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans loads two n8 tiles");
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const unsigned arow = smem_addr(a + (m0 + lane % 16) * kALd + (lane / 16) * 8);
  const int kr = lane % 8 + 8 * ((lane / 8) % 2);
  const unsigned brow = smem_addr(s_w + kr * kBLd + n0 + 8 * (lane / 16));
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    unsigned af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4(arow + 2 * (16 * i * kALd + 16 * ks), af[i]);
#pragma unroll
    for (int nq = 0; nq < NT / 2; ++nq) {
      unsigned b[4];
      ldsm_x4_trans(brow + 2 * (16 * ks * kBLd + 16 * nq), b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * nq], af[i], b[0], b[1]);
        mma_bf16(acc[i][2 * nq + 1], af[i], b[2], b[3]);
      }
    }
  }
}

// the tile row and channel of accumulator element e of acc[i][j], for a
// warp whose block starts at row m0 and channel n0
__device__ __forceinline__ int acc_row(int m0, int lane, int i, int e) {
  return m0 + 16 * i + lane / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int lane, int j, int e) {
  return n0 + 8 * j + 2 * (lane % 4) + (e & 1);
}

// whether tile row m (< kPix) is a conv pixel of the image
__device__ __forceinline__ bool inside(Tile t, int m, int h2, int w2) {
  const int r = m / kCC, c = m - r * kCC;
  return 2 * t.p0 + r < h2 && 2 * t.q0 + c < w2;
}

}  // namespace tile
}  // namespace stem
}  // namespace tdnet
