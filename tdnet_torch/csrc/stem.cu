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
// What bounds it on the H100: operations. At (16, 800, 1344) the conv is
// 4.3 M conv pixels x 64 channels x 147 taps, 81 GFLOP, 0.082 ms on the bf16
// tensor cores at 989 TFLOP/s, against 52 MB of uint8 in and 69 MB of bf16
// out (0.036 ms at 3.35 TB/s). The contraction runs over all 147 taps of the
// 7x7x3 window, so as a GEMM (M = conv pixels, N = 64, K = 147 padded to
// 160) it fits the tensor cores with 8% of K wasted.
//
// bf16 (stem_mma_kernel): a persistent grid of 2 blocks a SM, 10 warps
// each (5 row pairs x 2 channel halves of the GEMM), walks tiles of 4x8 pooled pixels through the tensor-core conv tile
// of stem_common.cuh (cp.async double-buffered uint8 windows, normalize,
// im2col, mma.sync with the 160x64 bf16 weights held in shared memory for
// the block's whole run). The epilogue applies BN, ReLU and the rounding to
// the accumulators (conv pixels past the image are -inf, the pool's 'SAME'
// padding) into a bf16 conv tile in shared memory, and the 3x3/2 pool reads
// it 8 channels at a time and writes 16-byte NHWC stores, so only the pooled
// activations reach device memory. A tile recomputes the conv row and column
// it shares with its neighbours (153 conv pixels for 128 pooled ones' 4x
// down-sampled area). The backward (stem_bwd.cu) runs the same conv tile.
//
// f32 (fused_stem_kernel): CUDA-core FMAs, as f32 must equal the plain
// version's full-f32 conv (the tensor cores would take TF32). A block owns
// one image's 4x16 pooled pixels: it stages the (4*4+7) x (4*16+7) input
// window, normalized, and the 7x7x3x64 weights in shared memory; computes
// the 9x33 conv pixels it needs (each thread 16 channels of one pixel,
// weights read as broadcast float4); applies BN, ReLU and the rounding; and
// max-pools the conv tile straight into NHWC output.
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

// ------------------------------------------------- bf16 on the tensor cores

namespace tl = tdnet::stem::tile;
using bf16 = __nv_bfloat16;

constexpr size_t kMmaSmemBytes =
    sizeof(bf16) * tl::kM * tl::kALd          // im2col
    + sizeof(bf16) * tl::kK * tl::kBLd        // weights
    + sizeof(bf16) * tl::kM * tl::kBLd        // conv tile (activations)
    + sizeof(float) * 2 * kF                  // bn inv/off
    + sizeof(bf16) * tl::kWinElems            // normalized window
    + 2 * tl::kU8Bytes;                       // uint8 window, two buffers

constexpr int kNT = 4;  // n8 tiles a warp: 10 warps = 5 row pairs x 2 channel halves
constexpr int kMmaThreads = 32 * tl::kMPairs * (8 / kNT);

__global__ void __launch_bounds__(kMmaThreads, 2)
stem_mma_kernel(const uint8_t* __restrict__ in, const float* __restrict__ w,
                const float* __restrict__ inv, const float* __restrict__ off,
                bf16* __restrict__ out, int nb, int h, int wd, float m0,
                float m1, float m2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + tl::kM * tl::kALd;
  bf16* s_act = s_w + tl::kK * tl::kBLd;
  float* s_inv = reinterpret_cast<float*>(s_act + tl::kM * tl::kBLd);
  float* s_off = s_inv + kF;
  bf16* s_win = reinterpret_cast<bf16*>(s_off + kF);
  uint8_t* s_u8 = reinterpret_cast<uint8_t*>(s_win + tl::kWinElems);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 32 * (warp % tl::kMPairs);   // the warp's GEMM rows
  const int col0 = 8 * kNT * (warp / tl::kMPairs);  // and channels
  const int h2 = h / 2, w2 = wd / 2, h4 = h / 4, w4 = wd / 4;
  const int tiles_x = (w4 + tl::kTQ - 1) / tl::kTQ;
  const int tiles_y = (h4 + tl::kTP - 1) / tl::kTP;
  const int n_tiles = nb * tiles_x * tiles_y;

  tl::stage_weights(s_w, w);
  for (int i = tid; i < kF; i += kMmaThreads) {
    s_inv[i] = inv[i];
    s_off[i] = off[i];
  }
  for (int i = tid; i < tl::kM * tl::kALd; i += kMmaThreads) {
    s_a[i] = __float2bfloat16_rn(0.0f);  // the zero pad rows and taps stay
  }

  int tile = blockIdx.x;
  if (tile < n_tiles) {
    tl::load_window(s_u8, in, tl::tile_at(tile, tiles_x, tiles_y), h, wd);
  }
  tl::cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      tl::load_window(s_u8 + ((it + 1) & 1) * tl::kU8Bytes, in,
                      tl::tile_at(next, tiles_x, tiles_y), h, wd);
    }
    tl::cp_async_commit();
    tl::cp_async_wait<1>();  // this tile's window has landed
    __syncthreads();
    const tl::Tile t = tl::tile_at(tile, tiles_x, tiles_y);
    tl::normalize_window(s_win, s_u8 + (it & 1) * tl::kU8Bytes, t, h, wd, m0,
                         m1, m2, scale);
    __syncthreads();
    tl::build_im2col(s_a, s_win);
    __syncthreads();

    float acc[2][kNT][4];
    tl::conv_mma<kNT>(s_a, s_w, row0, col0, lane, acc);
    // BN + ReLU + rounding into the conv tile; -inf past the image
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = tl::acc_row(row0, lane, i, e);
        if (m >= tl::kPix) continue;
        const bool in_img = tl::inside(t, m, h2, w2);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int f = tl::acc_col(col0, lane, j, e);
          float y[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            y[u] = in_img ? fmaxf(tdnet::stem::bn(acc[i][j][e + u], s_inv[f + u],
                                                  s_off[f + u]), 0.0f)
                          : -INFINITY;
          }
          *reinterpret_cast<__nv_bfloat162*>(s_act + m * tl::kBLd + f) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
    __syncthreads();

    // 3x3/2 max-pool, 8 channels an item -> 16-byte NHWC stores
    for (int item = tid; item < tl::kTP * tl::kTQ * (kF / 8); item += kMmaThreads) {
      const int g = item % (kF / 8);
      const int pq = item / (kF / 8);
      const int p = pq / tl::kTQ, q = pq - p * tl::kTQ;
      if (t.p0 + p >= h4 || t.q0 + q >= w4) continue;
      uint4 mv = *reinterpret_cast<const uint4*>(
          s_act + (2 * p * tl::kCC + 2 * q) * tl::kBLd + 8 * g);
      __nv_bfloat162* m2v = reinterpret_cast<__nv_bfloat162*>(&mv);
#pragma unroll
      for (int d = 1; d < 9; ++d) {
        const int pix = (2 * p + d / 3) * tl::kCC + 2 * q + d % 3;
        uint4 v = *reinterpret_cast<const uint4*>(s_act + pix * tl::kBLd + 8 * g);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u) m2v[u] = __hmax2(m2v[u], v2[u]);
      }
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(t.b) * h4 + t.p0 + p) * w4 + t.q0 + q) * kF +
          8 * g) = mv;
    }
  }
}

int launch_mma(const void* in, const void* w, const void* inv, const void* off,
               void* out, int b, int h, int wd, float m0, float m1, float m2,
               float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = b * ((wd / 4 + tl::kTQ - 1) / tl::kTQ) *
                    ((h / 4 + tl::kTP - 1) / tl::kTP);
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;  // persistent: 2 a SM
  stem_mma_kernel<<<grid, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<const float*>(w),
      static_cast<const float*>(inv), static_cast<const float*>(off),
      static_cast<bf16*>(out), b, h, wd, m0, m1, m2, scale);
  return static_cast<int>(cudaGetLastError());
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
// also the compute dtype: bf16 runs stem_mma_kernel, f32 fused_stem_kernel.
// Needs h % 4 == 0, wd % 4 == 0, and `in` 4-byte aligned (cp.async words).
TDNET_EXPORT int tdnet_fused_stem(const void* in, const void* w,
                                  const void* inv, const void* off, void* out,
                                  int b, int h, int wd, float m0, float m1,
                                  float m2, float scale, int out_kind,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == tdnet::kBFloat16) {
    return launch_mma(in, w, inv, off, out, b, h, wd, m0, m1, m2, scale, s);
  }
  if (out_kind == tdnet::kFloat32) {
    return launch<float>(in, w, inv, off, out, b, h, wd, m0, m1, m2, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
