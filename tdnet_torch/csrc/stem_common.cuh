// Arithmetic shared by the fused-stem forward (stem.cu) and backward
// (stem_bwd.cu). Both kernels recompute the same values through these
// functions: the normalized input, the 7x7x3 conv of one pixel (taps in
// (kr, kc, ch) order, one fmaf chain per channel from 0), and the folded BN.
// So the compute-dtype activations the backward routes the pool gradient
// on are bit-identical to the ones the forward pooled.
#pragma once

#include "common.cuh"

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

}  // namespace stem
}  // namespace tdnet
