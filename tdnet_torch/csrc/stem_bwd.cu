// Backward of the fused ingest + ResNet stem: from packed uint8 rows
// (B, H, W*3), the stem parameters and the pooled cotangent dy
// (B, H/4, W/4, 64), the f32 gradients dkernel7 (7, 7, 3, 64), dinv (64,)
// and doff (64,).
//
// Replaces the Pallas kernel tdnet/ops/pallas_stem.py fused_stem_bwd_packed
// (_make_bwd_kernel, and the un-banding of its dG after the call). Its S
// matrix, banded G, selection-matrix upsample and roll-based un-banding are
// Mosaic devices; this kernel follows the contract:
//
//   1. recompute the normalized, compute-dtype-rounded, zero-padded input
//      and the 7x7/2 conv z in f32, through stem_common.cuh, so the values
//      are bit-identical to what the forward kernel (stem.cu) pooled;
//   2. wp = z*inv + off (f32), a = round_to_compute(relu(wp));
//   3. route each pooled dy to the FIRST maximum of its 3x3 window in
//      row-major (dr, dc) order, comparing the rounded a (the forward's
//      'SAME' pad and conv pixels past the image are -inf);
//   4. dwp = (wp > 0) ? da : 0; doff += sum dwp; dinv += sum dwp*z;
//   5. dz = round_to_compute(dwp*inv); dkernel7[t, f] += sum dz * x[t].
//
// Bound on the H100: reckoned at (8, 800, 1344) in bf16, the conv
// recompute and the filter gradient are 2 x 40.5 GFLOP (0.082 ms on the
// bf16 tensor cores at 989 TFLOP/s) against 25.8 MB of bytes and 68.8 MB of
// dy (0.028 ms at 3.35 TB/s): operations bound. This first kernel does both
// contractions as f32 FMAs (K is only 147, and the window gather does not
// fit a tensor-core tile without an im2col), so its floor is the FP32 rate,
// ~1.2 ms; a wgmma version is later work.
//
// Design. The TPU grid carries its dG accumulator from step to step; CUDA
// blocks cannot. So the grid is a fixed 264 persistent blocks (2 per SM on
// 132 SMs), each walking tiles of 4x8 pooled pixels (9x17 conv pixels,
// 23x39 input pixels) of all images. A block keeps the rounded weights in
// shared memory for the whole run, and its part of the filter gradient in
// registers: thread (cg, tg) owns channels 4cg..4cg+3 of taps tg + 16k.
// dinv/doff partials stay in registers too (one channel per thread). At the
// end each block writes one 9536-float partial; a second kernel sums the
// partials in block order. No atomics: the result is the same on every run.
//
// Per tile: stage the normalized window; conv the 153 pixels (8 channels
// an item) into z; pick each pooled pixel's first-max slot per channel;
// gather, per conv pixel, the dy of the (up to 4) pooled windows that chose
// it, in (p, q) order; overwrite z with dz; accumulate the filter gradient.
// A conv row or column shared by two tiles (the windows overlap by one)
// gets each tile's share separately, rounded to the compute dtype per tile,
// as in the Pallas kernel (its 2*tm+1 conv rows per block overlap the same
// way); in f32 the two orders agree to rounding.
#include <math.h>

#include "stem_common.cuh"

namespace {

using tdnet::stem::kF;
using tdnet::stem::kTaps;
constexpr int kTP = 4;              // pooled rows per tile
constexpr int kTQ = 8;              // pooled cols per tile
constexpr int kCR = 2 * kTP + 1;    // conv rows per tile
constexpr int kCC = 2 * kTQ + 1;    // conv cols per tile
constexpr int kPix = kCR * kCC;
constexpr int kIR = 4 * kTP + 7;    // input rows per tile
constexpr int kIC = 4 * kTQ + 7;    // input cols per tile
constexpr int kZS = kF + 4;         // padded channel stride of the z tile
constexpr int kCh = 8;              // conv channels per item
constexpr int kThreads = 256;
constexpr int kTapGroups = kThreads / (kF / 4);          // 16
constexpr int kTapsPerThread = (kTaps + kTapGroups - 1) / kTapGroups;  // 10
constexpr int kOut = kTaps * kF + 2 * kF;  // dkernel7, dinv, doff
constexpr unsigned char kNone = 255;

constexpr size_t kSmemBytes =
    sizeof(float) * kTaps * kF          // rounded weights
    + sizeof(float) * kPix * kZS        // z, then dz
    + sizeof(float) * kIR * kIC * 3     // normalized input window
    + sizeof(float) * 2 * kF            // bn inv/off
    + kTP * kTQ * kF;                   // first-max slot per pooled value

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_bwd_kernel(const uint8_t* __restrict__ in, const float* __restrict__ w,
                const float* __restrict__ inv, const float* __restrict__ off,
                const T* __restrict__ dy, float* __restrict__ partial,
                int nb, int h, int wd, float m0, float m1, float m2,
                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  float* s_z = s_w + kTaps * kF;
  float* s_in = s_z + kPix * kZS;
  float* s_inv = s_in + kIR * kIC * 3;
  float* s_off = s_inv + kF;
  unsigned char* s_arg = reinterpret_cast<unsigned char*>(s_off + kF);

  const int tid = threadIdx.x;
  const int h2 = h / 2, w2 = wd / 2, h4 = h / 4, w4 = wd / 4;
  const int tiles_x = (w4 + kTQ - 1) / kTQ;
  const int tiles_y = (h4 + kTP - 1) / kTP;
  const int n_tiles = nb * tiles_x * tiles_y;

  for (int i = tid; i < kTaps * kF; i += kThreads) {
    s_w[i] = tdnet::to_float(tdnet::round_to(w[i], T()));
  }
  for (int i = tid; i < kF; i += kThreads) {
    s_inv[i] = inv[i];
    s_off[i] = off[i];
  }

  // filter-gradient ownership: channels 4cg..4cg+3 of taps tg + 16k
  const int cg = tid % (kF / 4);
  const int tg = tid / (kF / 4);
  int tap_off[kTapsPerThread];   // the tap's offset in the input window
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k) {
    const int t = min(tg + kTapGroups * k, kTaps - 1);
    const int kr = t / 21, kc = (t % 21) / 3, ch = t % 3;
    tap_off[k] = (kr * kIC + kc) * 3 + ch;
  }
  const int last_taps = kTaps - kTapGroups * (kTapsPerThread - 1);  // 3
  float dw[kTapsPerThread][4];
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dw[k][j] = 0.0f;
  }
  // BN partials: channel tid % 64 over the pixels of item slot tid / 64
  const int f_own = tid % kF;
  float dinv_acc = 0.0f, doff_acc = 0.0f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x;
    const int ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int p0 = ty * kTP, q0 = tx * kTQ;
    const int ir0 = 4 * p0 - 3, ic0 = 4 * q0 - 3;
    __syncthreads();  // the previous tile's readers of s_in/s_z are done

    // ---- 1. normalized input window (zero pad in normalized space)
    const uint8_t* img = in + static_cast<int64_t>(b) * h * wd * 3;
    for (int i = tid; i < kIR * kIC * 3; i += kThreads) {
      const int r = i / (kIC * 3);
      const int rem = i - r * (kIC * 3);
      const int ch = rem % 3;
      const int gr = ir0 + r;
      const int gc = ic0 + rem / 3;
      float v = 0.0f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < wd) {
        const float mean = ch == 0 ? m0 : (ch == 1 ? m1 : m2);
        v = tdnet::stem::normalize<T>(
            img[(static_cast<int64_t>(gr) * wd + gc) * 3 + ch], mean, scale);
      }
      s_in[i] = v;
    }
    __syncthreads();

    // ---- 1. conv z (f32) of the tile's conv pixels; 0 past the image
    for (int item = tid; item < (kF / kCh) * kPix; item += kThreads) {
      const int g = item / kPix;
      const int pix = item - g * kPix;
      const int r = pix / kCC;
      const int c = pix - r * kCC;
      float4* dst = reinterpret_cast<float4*>(s_z + pix * kZS + g * kCh);
      float acc[kCh];
      if (2 * p0 + r < h2 && 2 * q0 + c < w2) {
        tdnet::stem::conv_pixel<kCh>(s_in + (2 * r * kIC + 2 * c) * 3,
                                     kIC * 3, s_w + g * kCh, acc);
      } else {
#pragma unroll
        for (int j = 0; j < kCh; ++j) acc[j] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kCh / 4; ++q) {
        dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                             acc[4 * q + 3]);
      }
    }
    __syncthreads();

    // ---- 2-3. first maximum of each pooled window, per channel
    for (int item = tid; item < kTP * kTQ * kF; item += kThreads) {
      const int f = item % kF;
      const int pq = item / kF;
      const int p = pq / kTQ;
      const int q = pq - p * kTQ;
      if (p0 + p >= h4 || q0 + q >= w4) {
        s_arg[item] = kNone;
        continue;
      }
      const float fi = s_inv[f], fo = s_off[f];
      float a[9];
      float m = -INFINITY;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int rr = 2 * p + dr, cc = 2 * q + dc;
          float v = -INFINITY;
          if (2 * p0 + rr < h2 && 2 * q0 + cc < w2) {
            v = tdnet::stem::activation<T>(
                tdnet::stem::bn(s_z[(rr * kCC + cc) * kZS + f], fi, fo));
          }
          a[dr * 3 + dc] = v;
          m = fmaxf(m, v);
        }
      }
      unsigned char slot = 8;
#pragma unroll
      for (int k = 8; k >= 0; --k) {
        if (a[k] == m) slot = static_cast<unsigned char>(k);
      }
      s_arg[item] = slot;
    }
    __syncthreads();

    // ---- 3-5. gather da per conv pixel, BN/ReLU backward, dz in place
    const T* dyb = dy + static_cast<int64_t>(b) * h4 * w4 * kF;
    for (int item = tid; item < kPix * kF; item += kThreads) {
      const int pix = item / kF;   // item % kF == f_own
      const int r = pix / kCC;
      const int c = pix - r * kCC;
      const int p_lo = max(0, (r - 1) / 2), p_hi = min(kTP - 1, r / 2);
      const int q_lo = max(0, (c - 1) / 2), q_hi = min(kTQ - 1, c / 2);
      float da = 0.0f;
      for (int p = p_lo; p <= p_hi; ++p) {
        for (int q = q_lo; q <= q_hi; ++q) {
          const int slot = (r - 2 * p) * 3 + (c - 2 * q);
          if (s_arg[(p * kTQ + q) * kF + f_own] == slot) {
            da += tdnet::to_float(
                dyb[(static_cast<int64_t>(p0 + p) * w4 + q0 + q) * kF + f_own]);
          }
        }
      }
      const bool inside = 2 * p0 + r < h2 && 2 * q0 + c < w2;
      const float fi = s_inv[f_own];
      const float z = s_z[pix * kZS + f_own];
      const float wp = tdnet::stem::bn(z, fi, s_off[f_own]);
      const float dwp = (inside && wp > 0.0f) ? da : 0.0f;
      doff_acc += dwp;
      dinv_acc = fmaf(dwp, z, dinv_acc);
      s_z[pix * kZS + f_own] =
          tdnet::to_float(tdnet::round_to(__fmul_rn(dwp, fi), T()));
    }
    __syncthreads();

    // ---- 5. filter gradient: dw[t, f] += sum over pixels of dz * x[t]
    for (int pix = 0; pix < kPix; ++pix) {
      const int r = pix / kCC;
      const int c = pix - r * kCC;
      const float4 d = *reinterpret_cast<const float4*>(s_z + pix * kZS + 4 * cg);
      const float* xb = s_in + (2 * r * kIC + 2 * c) * 3;
#pragma unroll
      for (int k = 0; k < kTapsPerThread; ++k) {
        if (k < kTapsPerThread - 1 || tg < last_taps) {
          const float x = xb[tap_off[k]];
          dw[k][0] = fmaf(d.x, x, dw[k][0]);
          dw[k][1] = fmaf(d.y, x, dw[k][1]);
          dw[k][2] = fmaf(d.z, x, dw[k][2]);
          dw[k][3] = fmaf(d.w, x, dw[k][3]);
        }
      }
    }
  }

  // ---- the block's partial: filter gradient, then dinv, doff
  float* part = partial + static_cast<int64_t>(blockIdx.x) * kOut;
#pragma unroll
  for (int k = 0; k < kTapsPerThread; ++k) {
    if (k < kTapsPerThread - 1 || tg < last_taps) {
      const int t = tg + kTapGroups * k;
      *reinterpret_cast<float4*>(part + t * kF + 4 * cg) =
          make_float4(dw[k][0], dw[k][1], dw[k][2], dw[k][3]);
    }
  }
  __syncthreads();  // s_z is free: sum the 4 pixel slots of each channel
  s_z[tid] = dinv_acc;
  s_z[kThreads + tid] = doff_acc;
  __syncthreads();
  if (tid < kF) {
    float si = 0.0f, so = 0.0f;
    for (int j = 0; j < kThreads / kF; ++j) {
      si += s_z[j * kF + tid];
      so += s_z[kThreads + j * kF + tid];
    }
    part[kTaps * kF + tid] = si;
    part[kTaps * kF + kF + tid] = so;
  }
}

// out[i] = sum of the blocks' partials in block order (deterministic)
__global__ void sum_partials(const float* __restrict__ partial, int blocks,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kOut) return;
  float s = 0.0f;
#pragma unroll 8
  for (int g = 0; g < blocks; ++g) s += partial[static_cast<int64_t>(g) * kOut + i];
  out[i] = s;
}

template <typename T>
int launch(const void* in, const void* w, const void* inv, const void* off,
           const void* dy, void* partial, void* out, int b, int h, int wd,
           float m0, float m1, float m2, float scale, int blocks,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_bwd_kernel<T><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<const float*>(w),
      static_cast<const float*>(inv), static_cast<const float*>(off),
      static_cast<const T*>(dy), static_cast<float*>(partial), b, h, wd, m0,
      m1, m2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(kOut + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (b, h, wd*3) uint8; w: (7, 7, 3, 64) float32 HWIO; inv/off: (64,)
// float32; dy: (b, h/4, wd/4, 64) of kind (tdnet::OutKind, also the compute
// dtype); partial: (blocks, 9536) float32 scratch; out: (9536,) float32 =
// dkernel7 (7*7*3*64, HWIO order), dinv (64), doff (64). Needs h % 4 == 0,
// wd % 4 == 0 and 1 <= blocks.
TDNET_EXPORT int tdnet_fused_stem_bwd(const void* in, const void* w,
                                      const void* inv, const void* off,
                                      const void* dy, void* partial, void* out,
                                      int b, int h, int wd, float m0, float m1,
                                      float m2, float scale, int kind,
                                      int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == tdnet::kBFloat16) {
    return launch<__nv_bfloat16>(in, w, inv, off, dy, partial, out, b, h, wd,
                                 m0, m1, m2, scale, blocks, s);
  }
  if (kind == tdnet::kFloat32) {
    return launch<float>(in, w, inv, off, dy, partial, out, b, h, wd, m0, m1,
                         m2, scale, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
