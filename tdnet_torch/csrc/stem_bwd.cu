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
// What bounds it on the H100: operations. At (8, 800, 1344) in bf16 the
// conv recompute and the filter gradient are GEMMs of 2 x 40.5 GFLOP
// (0.082 ms on the bf16 tensor cores at 989 TFLOP/s) against 25.8 MB of
// pages and 68.8 MB of dy (0.028 ms at 3.35 TB/s).
//
// Both dtypes use a fixed persistent grid (the wrapper's 264 blocks, 2 a
// SM), because the TPU grid carries its dG accumulator from step to step
// and CUDA blocks cannot: each block keeps its share of the gradients in
// registers over the tiles it walks, writes one 9536-float partial at the
// end, and a second kernel sums the partials in block order. No atomics:
// the result is the same on every run.
//
// bf16 (stem_bwd_mma_kernel): 10 warps (5 row pairs x 2 channel halves of
// each GEMM) walk tiles of 4x8 pooled pixels through the forward's
// tensor-core conv tile (stem_common.cuh: cp.async double-buffered window,
// im2col, mma.sync; the same K order and k-steps, so z is the forward's bit
// for bit). The tile's dy block is copied by cp.async into the window
// buffer once im2col is built, and lands while the conv runs. The z
// accumulators stay in registers: their activations go to a bf16 tile for
// the first-max pick (8 channels a 16-byte load); the owner of each z then
// gathers its da from the (up to 2x2) windows that hold its conv pixel in a
// fixed loop (static indices: z stays in registers), applies the BN/ReLU
// backward, adds to its channels' dinv/doff sums (kept in registers across
// tiles, reduced over lanes and warps at the end), and writes the rounded
// dz over its activation. The filter gradient is a second mma.sync GEMM,
// A = im2col transposed (ldmatrix.trans of the same tile), B = dz, K = the
// tile's 160 rows (153 conv pixels and 7 zero rows); each warp accumulates
// 32 taps x 32 channels of it in f32 registers across the block's tiles.
// The routing step takes the largest share of the time
// (tools/torch_stem_bwd_phases.py times the kernel with each phase left
// out); at 20 warps an SM the kernel has 96 registers and spills some.
//
// f32 (stem_bwd_kernel): CUDA-core FMAs, as f32 must match the plain
// version's full-f32 conv. 256 threads walk 4x8-pooled tiles; the weights
// sit in shared memory; thread (cg, tg) owns channels 4cg..4cg+3 of taps
// tg + 16k of the filter gradient, in registers. Per tile: stage the
// normalized window; conv the 153 pixels into z; pick each pooled pixel's
// first-max slot per channel; gather each conv pixel's da; overwrite z with
// dz; accumulate the filter gradient.
//
// In both, a conv row or column shared by two tiles (the windows overlap by
// one) gets each tile's share separately, rounded to the compute dtype per
// tile, as in the Pallas kernel (its 2*tm+1 conv rows per block overlap the
// same way); in f32 the two orders agree to rounding.
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

// ------------------------------------------------- bf16 on the tensor cores

namespace tl = tdnet::stem::tile;
using bf16 = __nv_bfloat16;

// row strides of the staged dy (bf16) and first-max slots (bytes) of a
// pooled pixel: padded so the windows of a warp's pixels hit other banks
constexpr int kDyLd = kF + 8;
constexpr int kArgLd = kF + 8;

constexpr size_t kMmaSmemBytes =
    sizeof(bf16) * tl::kM * tl::kALd          // im2col
    + sizeof(bf16) * tl::kK * tl::kBLd        // weights
    + sizeof(bf16) * tl::kM * tl::kBLd        // activations, then dz
    + sizeof(float) * 2 * kF                  // bn inv/off
    + sizeof(bf16) * tl::kWinElems            // normalized window
    + 2 * tl::kU8Bytes                        // uint8 window, two buffers
    + tl::kTP * tl::kTQ * kArgLd;             // first-max slot per pooled value

// 10 warps: 5 row pairs x 2 channel halves of each GEMM (n8 tiles a warp:
// kNT = 4), 2 blocks a SM. On the H100 this beat 5 warps with all 64
// channels each (2 blocks a SM: capped at 168 registers, it spills more)
// and 10 warps in one block a SM.
constexpr int kNT = 4;
constexpr int kMmaWarps = tl::kMPairs * (8 / kNT);
constexpr int kMmaThreads = 32 * kMmaWarps;

// `pooled`, when not null, receives the pooled maximum of the activations
// the routing compares (B, H/4, W/4, 64): the forward kernel's output, if
// the recomputed conv is bit-identical.
__global__ void __launch_bounds__(kMmaThreads, 2)
stem_bwd_mma_kernel(const uint8_t* __restrict__ in, const float* __restrict__ w,
                    const float* __restrict__ inv, const float* __restrict__ off,
                    const bf16* __restrict__ dy, float* __restrict__ partial,
                    bf16* __restrict__ pooled, int nb, int h, int wd, float m0,
                    float m1, float m2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + tl::kM * tl::kALd;
  bf16* s_act = s_w + tl::kK * tl::kBLd;
  float* s_inv = reinterpret_cast<float*>(s_act + tl::kM * tl::kBLd);
  float* s_off = s_inv + kF;
  bf16* s_win = reinterpret_cast<bf16*>(s_off + kF);
  uint8_t* s_u8 = reinterpret_cast<uint8_t*>(s_win + tl::kWinElems);
  unsigned char* s_arg = s_u8 + 2 * tl::kU8Bytes;
  bf16* s_dy = s_win;  // after im2col: the tile's dy, (kTP * kTQ, kDyLd)
  static_assert(tl::kTP * tl::kTQ * kDyLd <= tl::kWinElems, "dy fits the window buffer");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 32 * (warp % tl::kMPairs);   // GEMM rows (conv: pixels; dW: taps)
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
  // zero pad rows and taps of im2col, and dz rows kPix..kM-1, for good
  for (int i = tid; i < tl::kM * tl::kALd; i += kMmaThreads) {
    s_a[i] = __float2bfloat16_rn(0.0f);
  }
  for (int i = tid; i < (tl::kM - tl::kPix) * tl::kBLd; i += kMmaThreads) {
    s_act[tl::kPix * tl::kBLd + i] = __float2bfloat16_rn(0.0f);
  }

  // filter gradient: taps row0 .. row0 + 31 x channels col0 .. col0 + 31
  // (acc layout)
  float dacc[2][kNT][4];
  // dinv (u = 0, 1) and doff (u = 2, 3) of channel col0 + 8j + 2(lane % 4)
  // + u % 2, over this thread's rows of every tile
  float bn_acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[0][j][e] = dacc[1][j][e] = bn_acc[j][e] = 0.0f;
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
    __syncthreads();         // ... and the previous tile's readers are done
    const tl::Tile t = tl::tile_at(tile, tiles_x, tiles_y);
    tl::normalize_window(s_win, s_u8 + (it & 1) * tl::kU8Bytes, t, h, wd, m0,
                         m1, m2, scale);
    __syncthreads();
    tl::build_im2col(s_a, s_win);
    __syncthreads();
    // the tile's dy block (kTP x kTQ pooled pixels x 64) into the window's
    // buffer, which im2col no longer needs; it lands during the conv
    {
      const bf16* dyb = dy + static_cast<int64_t>(t.b) * h4 * w4 * kF;
      constexpr int kChunks = tl::kTP * tl::kTQ * kF / 8;  // 16-byte chunks
      for (int i = tid; i < kChunks; i += kMmaThreads) {
        const int pq = i / (kF / 8), p = pq / tl::kTQ, q = pq - p * tl::kTQ;
        if (t.p0 + p < h4 && t.q0 + q < w4) {
          tl::cp_async16(s_dy + pq * kDyLd + 8 * (i % (kF / 8)),
                         dyb + (static_cast<int64_t>(t.p0 + p) * w4 + t.q0 + q) * kF +
                             8 * (i % (kF / 8)));
        }
      }
      tl::cp_async_commit();
    }

    // ---- 1-2. z = the forward's conv; a = round(relu(bn(z))), -inf outside
    float z[2][kNT][4];
    tl::conv_mma<kNT>(s_a, s_w, row0, col0, lane, z);
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
            y[u] = in_img ? fmaxf(tdnet::stem::bn(z[i][j][e + u], s_inv[f + u],
                                                  s_off[f + u]), 0.0f)
                          : -INFINITY;
          }
          *reinterpret_cast<__nv_bfloat162*>(s_act + m * tl::kBLd + f) =
              __floats2bfloat162_rn(y[0], y[1]);
        }
      }
    }
    __syncthreads();

    // ---- 3. first maximum of each pooled window, 8 channels an item
    for (int item = tid; item < tl::kTP * tl::kTQ * (kF / 8); item += kMmaThreads) {
      const int g8 = item % (kF / 8);
      const int pq = item / (kF / 8);
      const int p = pq / tl::kTQ, q = pq - p * tl::kTQ;
      unsigned char* arg = s_arg + pq * kArgLd + 8 * g8;
      if (t.p0 + p >= h4 || t.q0 + q >= w4) {
        *reinterpret_cast<uint2*>(arg) = make_uint2(0xffffffffu, 0xffffffffu);  // kNone
        continue;
      }
      float mx[8];
      unsigned char slot[8];
#pragma unroll
      for (int d = 0; d < 9; ++d) {  // strictly greater: the first maximum stays
        const int pix = (2 * p + d / 3) * tl::kCC + 2 * q + d % 3;
        uint4 v = *reinterpret_cast<const uint4*>(s_act + pix * tl::kBLd + 8 * g8);
        const bf16* a8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float x = __bfloat162float(a8[u]);
          if (d == 0 || x > mx[u]) {
            mx[u] = x;
            slot[u] = static_cast<unsigned char>(d);
          }
        }
      }
      *reinterpret_cast<uint2*>(arg) = *reinterpret_cast<const uint2*>(slot);
      if (pooled != nullptr) {
        __nv_bfloat162 o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] = __floats2bfloat162_rn(mx[2 * u], mx[2 * u + 1]);
        *reinterpret_cast<uint4*>(
            pooled + ((static_cast<int64_t>(t.b) * h4 + t.p0 + p) * w4 + t.q0 + q) * kF +
            8 * g8) = *reinterpret_cast<const uint4*>(o);
      }
    }
    tl::cp_async_wait<0>();  // the tile's dy block has landed
    __syncthreads();

    // ---- 3-5. each z's owner: gather da from the (up to 2x2) pooled
    // windows holding its conv pixel, in row-major order; BN/ReLU
    // backward; dinv/doff; dz rounded over its activation
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = tl::acc_row(row0, lane, i, e);
        if (m >= tl::kPix) continue;
        const int r = m / tl::kCC, c = m - r * tl::kCC;
        const bool in_img = 2 * t.p0 + r < h2 && 2 * t.q0 + c < w2;
        const int p_lo = max(0, (r - 1) / 2), q_lo = max(0, (c - 1) / 2);
        const int np = min(tl::kTP - 1, r / 2) - p_lo;  // 0 or 1
        const int nq = min(tl::kTQ - 1, c / 2) - q_lo;
        const int slot0 = (r - 2 * p_lo) * 3 + (c - 2 * q_lo);
        const int w0 = p_lo * tl::kTQ + q_lo;            // window (p_lo, q_lo)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int f = tl::acc_col(col0, lane, j, e);
          float da[2] = {0.0f, 0.0f};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int dp = v >> 1, dq = v & 1;
            if (dp > np || dq > nq) continue;
            const int wi = w0 + dp * tl::kTQ + dq;
            const unsigned sl =
                *reinterpret_cast<const unsigned short*>(s_arg + wi * kArgLd + f);
            const unsigned want = slot0 - 6 * dp - 2 * dq;
            const bool hit0 = (sl & 0xffu) == want, hit1 = (sl >> 8) == want;
            if (hit0 || hit1) {
              const float2 g = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(s_dy + wi * kDyLd + f));
              if (hit0) da[0] += g.x;
              if (hit1) da[1] += g.y;
            }
          }
          float dz[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float zv = z[i][j][e + u];
            const float wp = tdnet::stem::bn(zv, s_inv[f + u], s_off[f + u]);
            const float dwp = (in_img && wp > 0.0f) ? da[u] : 0.0f;
            bn_acc[j][u] = fmaf(dwp, zv, bn_acc[j][u]);
            bn_acc[j][2 + u] += dwp;
            dz[u] = __fmul_rn(dwp, s_inv[f + u]);
          }
          *reinterpret_cast<__nv_bfloat162*>(s_act + m * tl::kBLd + f) =
              __floats2bfloat162_rn(dz[0], dz[1]);
        }
      }
    }
    __syncthreads();

    // ---- 5. filter gradient: dacc += im2col^T . dz over the tile's rows
    {
      const int tr = lane % 8 + 8 * (lane / 16);       // row (conv pixel)
      const int tc = 8 * ((lane / 8) % 2);              // column offset (tap)
      const unsigned arow = tdnet::smem_addr(s_a + tr * tl::kALd + row0 + tc);
      const int kr = lane % 8 + 8 * ((lane / 8) % 2);
      const unsigned brow = tdnet::smem_addr(s_act + kr * tl::kBLd + col0 + 8 * (lane / 16));
#pragma unroll
      for (int ks = 0; ks < tl::kM / 16; ++ks) {
        unsigned af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tdnet::ldsm_x4_trans(arow + 2 * (16 * ks * tl::kALd + 16 * i), af[i]);
        }
#pragma unroll
        for (int nq = 0; nq < kNT / 2; ++nq) {
          unsigned b[4];
          tdnet::ldsm_x4_trans(brow + 2 * (16 * ks * tl::kBLd + 16 * nq), b);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tdnet::mma_bf16(dacc[i][2 * nq], af[i], b[0], b[1]);
            tdnet::mma_bf16(dacc[i][2 * nq + 1], af[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // ---- the block's partial: filter gradient, then dinv, doff
  float* part = partial + static_cast<int64_t>(blockIdx.x) * kOut;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int tap = tl::acc_row(row0, lane, i, e);
      if (tap >= kTaps) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(part + tap * kF + tl::acc_col(col0, lane, j, e)) =
            make_float2(dacc[i][j][e], dacc[i][j][e + 1]);
      }
    }
  }
  // dinv/doff: sum the 8 lanes of equal lane % 4 (the warp's rows), then
  // the warps in warp order
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        bn_acc[j][u] += __shfl_xor_sync(0xffffffffu, bn_acc[j][u], x);
      }
    }
  }
  __syncthreads();  // s_act is free
  float* s_red = reinterpret_cast<float*>(s_act);  // [2][kMmaWarps][kF]
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s_red[((u / 2) * kMmaWarps + warp) * kF + col0 + 8 * j + 2 * lane + u % 2] =
            bn_acc[j][u];
      }
    }
  }
  __syncthreads();
  if (tid < kF) {  // the warps holding channel tid, in warp order
    const int w0 = tl::kMPairs * (tid / (8 * kNT));
    float si = 0.0f, so = 0.0f;
    for (int wi = w0; wi < w0 + tl::kMPairs; ++wi) {
      si += s_red[wi * kF + tid];
      so += s_red[(kMmaWarps + wi) * kF + tid];
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

int launch_mma(const void* in, const void* w, const void* inv, const void* off,
               const void* dy, void* partial, void* out, void* pooled, int b,
               int h, int wd, float m0, float m1, float m2, float scale,
               int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_bwd_mma_kernel<<<blocks, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<const float*>(w),
      static_cast<const float*>(inv), static_cast<const float*>(off),
      static_cast<const bf16*>(dy), static_cast<float*>(partial),
      static_cast<bf16*>(pooled), b, h, wd, m0, m1, m2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(kOut + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
// dtype: bf16 runs stem_bwd_mma_kernel, f32 stem_bwd_kernel); partial:
// (blocks, 9536) float32 scratch; out: (9536,) float32 = dkernel7
// (7*7*3*64, HWIO order), dinv (64), doff (64). Needs h % 4 == 0,
// wd % 4 == 0, 1 <= blocks, and (bf16) `in` 4-byte aligned.
TDNET_EXPORT int tdnet_fused_stem_bwd(const void* in, const void* w,
                                      const void* inv, const void* off,
                                      const void* dy, void* partial, void* out,
                                      int b, int h, int wd, float m0, float m1,
                                      float m2, float scale, int kind,
                                      int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == tdnet::kBFloat16) {
    return launch_mma(in, w, inv, off, dy, partial, out, nullptr, b, h, wd, m0,
                      m1, m2, scale, blocks, s);
  }
  if (kind == tdnet::kFloat32) {
    return launch<float>(in, w, inv, off, dy, partial, out, b, h, wd, m0, m1,
                         m2, scale, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 backward with `pooled` ((b, h/4, wd/4, 64) bf16) set: it also
// writes the pooled maximum of the activations it routes on, for the check
// that they equal the forward kernel's output bit for bit.
TDNET_EXPORT int tdnet_fused_stem_bwd_pooled(const void* in, const void* w,
                                             const void* inv, const void* off,
                                             const void* dy, void* partial,
                                             void* out, void* pooled, int b,
                                             int h, int wd, float m0, float m1,
                                             float m2, float scale, int blocks,
                                             void* stream) {
  if (blocks < 1 || pooled == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma(in, w, inv, off, dy, partial, out, pooled, b, h, wd, m0, m1,
                    m2, scale, blocks, static_cast<cudaStream_t>(stream));
}
