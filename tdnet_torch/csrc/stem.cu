// Fused ingest + ResNet stem: packed uint8 rows (B, H, W*3) -> normalize ->
// zero pad 3 -> 7x7/2 conv 3->64 (f32 accumulate) -> folded frozen BN (f32)
// -> ReLU -> round to the compute dtype -> 3x3/2 'SAME' max-pool ->
// NHWC (B, H/4, W/4, 64).
//
// Replaces the Pallas kernel tdnet/ops/pallas_stem.py fused_stem_packed
// (_make_kernel). Its six byte planes, 21-piece S matrix, banded weight
// matrix, selection-matrix downsample and channel-major output are TPU
// workarounds; this kernel is written from the contract instead.
//
// Bound on the H100 by the conv's FMAs: 147 per conv output, 64 channels,
// (H/2)(W/2) conv pixels per image, with only 3 input channels, so a
// tensor-core GEMM would waste most of its K. Each block owns one image and
// a tile of 4x16 pooled pixels. It stages the (4*4+7) x (4*16+7) input
// window, normalized and rounded to the compute dtype, and the 7x7x3x64
// weights (rounded the same way) in shared memory; computes the 9x33 conv
// pixels it needs (each thread 16 channels of one pixel, f32 FMAs, weights
// read as broadcast float4); applies BN, ReLU and the rounding; keeps the
// conv tile in shared memory; and max-pools it straight into NHWC output,
// so only the pooled activations reach device memory. Conv pixels past the
// image's last row or column are -inf, the pool's 'SAME' padding. The
// normalize, conv and BN arithmetic is in stem_common.cuh, which the
// backward (stem_bwd.cu) calls too.
#include <math.h>

#include "stem_common.cuh"

namespace {

using tdnet::stem::kF;
using tdnet::stem::kTaps;
constexpr int kTP = 4;              // pooled rows per block
constexpr int kTQ = 16;             // pooled cols per block
constexpr int kCR = 2 * kTP + 1;    // conv rows per block
constexpr int kCC = 2 * kTQ + 1;    // conv cols per block
constexpr int kIR = 4 * kTP + 7;    // input rows per block
constexpr int kIC = 4 * kTQ + 7;    // input cols per block
constexpr int kGroups = kF / 16;    // 16 channels per thread
constexpr int kThreads = 256;

// padded channel stride of the conv tile: 16-byte rows whose starts fall in
// different shared-memory banks
template <typename T>
__host__ __device__ constexpr int conv_stride() {
  return sizeof(T) == 4 ? kF + 4 : kF + 8;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * kTaps * kF                         // weights
         + sizeof(T) * kCR * kCC * conv_stride<T>()         // conv tile
         + sizeof(float) * 2 * kF                           // bn inv/off
         + sizeof(float) * kIR * kIC * 3;                   // input window
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const uint8_t* __restrict__ in, const float* __restrict__ w,
                  const float* __restrict__ inv, const float* __restrict__ off,
                  T* __restrict__ out, int h, int wd, float m0, float m1,
                  float m2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem);
  T* s_conv = reinterpret_cast<T*>(s_w + kTaps * kF);
  float* s_inv = reinterpret_cast<float*>(s_conv + kCR * kCC * conv_stride<T>());
  float* s_off = s_inv + kF;
  float* s_in = s_off + kF;

  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kTP;       // first pooled row
  const int q0 = blockIdx.x * kTQ;       // first pooled col
  const int ir0 = 4 * p0 - 3;            // first input row (pad 3)
  const int ic0 = 4 * q0 - 3;            // first input col
  const int h2 = h / 2, w2 = wd / 2, h4 = h / 4, w4 = wd / 4;
  const int tid = threadIdx.x;

  // ---- stage weights, BN, and the normalized input window
  for (int i = tid; i < kTaps * kF; i += kThreads) {
    s_w[i] = tdnet::to_float(tdnet::round_to(w[i], T()));
  }
  for (int i = tid; i < kF; i += kThreads) {
    s_inv[i] = inv[i];
    s_off[i] = off[i];
  }
  const uint8_t* img = in + static_cast<int64_t>(b) * h * wd * 3;
  for (int i = tid; i < kIR * kIC * 3; i += kThreads) {
    const int r = i / (kIC * 3);
    const int rem = i - r * (kIC * 3);   // local col * 3 + channel
    const int ch = rem % 3;
    const int gr = ir0 + r;
    const int gc = ic0 + rem / 3;
    float v = 0.0f;  // the conv's zero padding, in normalized space
    if (gr >= 0 && gr < h && gc >= 0 && gc < wd) {
      const float mean = ch == 0 ? m0 : (ch == 1 ? m1 : m2);
      v = tdnet::stem::normalize<T>(
          img[(static_cast<int64_t>(gr) * wd + gc) * 3 + ch], mean, scale);
    }
    s_in[i] = v;
  }
  __syncthreads();

  // ---- conv + BN + ReLU for the block's conv pixels, 16 channels a thread
  constexpr int kPix = kCR * kCC;
  for (int item = tid; item < kGroups * kPix; item += kThreads) {
    const int g = item / kPix;
    const int pix = item - g * kPix;
    const int r = pix / kCC;
    const int c = pix - r * kCC;
    T* dst = s_conv + pix * conv_stride<T>() + g * 16;
    if (2 * p0 + r >= h2 || 2 * q0 + c >= w2) {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = tdnet::round_to(-INFINITY, T());
      continue;
    }
    float acc[16];
    tdnet::stem::conv_pixel<16>(s_in + (2 * r * kIC + 2 * c) * 3, kIC * 3,
                                s_w + g * 16, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f = g * 16 + j;
      const float y = tdnet::stem::bn(acc[j], s_inv[f], s_off[f]);
      dst[j] = tdnet::round_to(fmaxf(y, 0.0f), T());
    }
  }
  __syncthreads();

  // ---- 3x3/2 max-pool (windows at conv rows/cols 2m..2m+2) -> NHWC
  for (int i = tid; i < kTP * kTQ * kF; i += kThreads) {
    const int f = i % kF;
    const int pq = i / kF;
    const int p = pq / kTQ;
    const int q = pq - p * kTQ;
    if (p0 + p >= h4 || q0 + q >= w4) continue;
    float m = -INFINITY;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const int pix = (2 * p + dr) * kCC + 2 * q + dc;
        m = fmaxf(m, tdnet::to_float(s_conv[pix * conv_stride<T>() + f]));
      }
    }
    out[((static_cast<int64_t>(b) * h4 + p0 + p) * w4 + q0 + q) * kF + f] =
        tdnet::round_to(m, T());  // exact: m is already on T's grid
  }
}

template <typename T>
int launch(const void* in, const void* w, const void* inv, const void* off,
           void* out, int b, int h, int wd, float m0, float m1, float m2,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd / 4 + kTQ - 1) / kTQ, (h / 4 + kTP - 1) / kTP, b);
  fused_stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<const float*>(w),
      static_cast<const float*>(inv), static_cast<const float*>(off),
      static_cast<T*>(out), h, wd, m0, m1, m2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (b, h, wd*3) uint8; w: (7, 7, 3, 64) float32 HWIO; inv/off: (64,)
// float32; out: (b, h/4, wd/4, 64) of out_kind (tdnet::OutKind), which is
// also the compute dtype. Needs h % 4 == 0 and wd % 4 == 0.
TDNET_EXPORT int tdnet_fused_stem(const void* in, const void* w,
                                  const void* inv, const void* off, void* out,
                                  int b, int h, int wd, float m0, float m1,
                                  float m2, float scale, int out_kind,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == tdnet::kBFloat16) {
    return launch<__nv_bfloat16>(in, w, inv, off, out, b, h, wd, m0, m1, m2,
                                 scale, s);
  }
  if (out_kind == tdnet::kFloat32) {
    return launch<float>(in, w, inv, off, out, b, h, wd, m0, m1, m2, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
