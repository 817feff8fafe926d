// One identity ResNet bottleneck, fused: 1x1 C->M + BN + ReLU, 3x3 SAME
// M->M + BN + ReLU, 1x1 M->C + BN, + x, ReLU. NHWC, float32 or bfloat16.
//
// Replaces the Pallas kernel tdnet/ops/pallas_block.py fused_bottleneck_chain
// (_make_chain_kernel; fused_bottleneck is its depth-1 form). The Python
// wrapper (tdnet_torch/ops/block.py) runs a chain of D blocks as D launches
// of this kernel: the C-channel activations between blocks go through device
// memory (rounded to the compute dtype, as the Pallas chain rounds them in
// VMEM), while each block's two M-channel intermediates t1 and t2 never
// leave the SM. Fusing across blocks is later work.
//
// Numerics are the Pallas kernel's: operands in the compute dtype, products
// accumulated in f32, BN (x * inv + off) and ReLU in f32 with IEEE-rounded
// multiply and add, then one rounding to the compute dtype for t1 and t2; the
// residual is the block input, added in f32 before the last ReLU and the
// output's rounding. conv2's SAME padding applies to t1: a t1 pixel outside
// the image is zero (a zero x pixel would give relu(off1) != 0).
//
// Design. A block of 256 threads owns an output tile of TH x 8 pixels of one
// image. Phase 1 computes t1 over the (TH+2) x 10 window (the tile and its
// one-pixel halo) from x and w1 into shared memory; phase 2 computes t2 for
// the tile from the nine shifted views of t1 and w2 (K = 9M) into shared
// memory; phase 3 computes the 1x1 back to C, adds the residual from x and
// writes the output. Each phase is a product of a 64-pixel row block by a
// 64-channel column block, with the weights streamed from L2 into shared
// memory chunk by chunk. bf16 runs the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulation, bottleneck_mma_kernel) and needs
// M % 32 == 0 (every ResNet width); f32 runs them on the CUDA cores as 4x4
// f32-FMA micro-tiles (bottleneck_kernel). TH is 8, or smaller where t1 and
// t2 do not fit 227 KB (f32 at M 512: TH 4).
//
// What bounds it on the H100: operations. ResNet-101's identity runs at a
// 1024^2 page are ~265 GFLOP, ~0.27 ms at the bf16 tensor-core peak (989
// TFLOP/s). The tensor-core path recomputes conv1 over the halo (100 window
// pixels for 64 output pixels), reads every operand through ldmatrix from
// shared memory that a barrier refills at each 32-deep chunk, with no
// double buffering and a 32 x 16 warp tile, so it runs far below the peak;
// wgmma with TMA-fed, double-buffered tiles and one launch per chain are the
// levers. The tensor cores' f32 accumulation does not round like an FMA
// chain, so bf16 outputs sit within a few ulp of the plain version, not
// within one.
#include "mma.cuh"

namespace {

using tdnet::ldsm_x4;
using tdnet::ldsm_x4_trans;
using tdnet::mma_bf16;
using tdnet::smem_addr;

constexpr int kThreads = 256;
constexpr int kTileW = 8;   // output columns of a tile
constexpr int kWinW = kTileW + 2;
constexpr int kKC = 16;     // k-chunk of a product
constexpr int kRB = 64;     // rows (pixels) of a product pass
constexpr int kCB = 64;     // columns (channels) of a product pass
constexpr int kAsLd = kKC + 1;  // staged x chunk row stride (no bank conflicts)

constexpr int kPadF32 = 4;   // smem row padding (elements) of t1 and t2
constexpr int kPadBf16 = 8;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rows k0..k0+15, columns cb..cb+63 of the (kdim, ndim) weight matrix into
// bs (zero beyond the matrix); ndim % 4 == 0
__device__ __forceinline__ void stage_weights(float* bs, const float* __restrict__ wgt,
                                              int kdim, int ndim, int k0, int cb) {
  const int kr = threadIdx.x / 16, nq = (threadIdx.x % 16) * 4;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (k0 + kr < kdim && cb + nq < ndim) {
    load4(wgt + static_cast<size_t>(k0 + kr) * ndim + cb + nq, v);
  }
  store4(bs + kr * kCB + nq, v);
}

// acc[i][j] += sum_kk a[arow[i] + k0 + kk] * bs[kk][tx*4 + j], kk < kn
__device__ __forceinline__ void mac(float acc[4][4], const float* a, const int arow[4],
                                    int k0, int kn, const float* bs, int tx) {
  auto step = [&](int kk) {
    const float4 b = *reinterpret_cast<const float4*>(bs + kk * kCB + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai = a[arow[i] + k0 + kk];
      acc[i][0] = fmaf(ai, b.x, acc[i][0]);
      acc[i][1] = fmaf(ai, b.y, acc[i][1]);
      acc[i][2] = fmaf(ai, b.z, acc[i][2]);
      acc[i][3] = fmaf(ai, b.w, acc[i][3]);
    }
  };
  if (kn == kKC) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) step(kk);
  } else {
    for (int kk = 0; kk < kn; ++kk) step(kk);
  }
}

__device__ __forceinline__ float bn_relu(float acc, float inv, float off) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, inv), off), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ w1, const float* __restrict__ w2,
                  const float* __restrict__ w3,
                  const float* __restrict__ i1, const float* __restrict__ o1,
                  const float* __restrict__ i2, const float* __restrict__ o2,
                  const float* __restrict__ i3, const float* __restrict__ o3,
                  int h, int w, int c, int m, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldt = m + kPadF32;
  const int pw = (th + 2) * kWinW;  // window pixels
  const int p = th * kTileW;        // output pixels
  float* t1 = reinterpret_cast<float*>(smem);
  float* t2 = t1 + pw * ldt;
  float* bs = t2 + p * ldt;                            // kKC x kCB
  float* as = bs + kKC * kCB;                          // kRB x kAsLd

  const int y0 = blockIdx.y * th, x0 = blockIdx.x * kTileW;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // ---- phase 1: t1 = relu(bn1(x . w1)) over the window, 0 outside the image
  for (int rb = 0; rb < pw; rb += kRB) {
    int arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) arow[i] = (ty + 16 * i) * kAsLd;
    for (int cb = 0; cb < m; cb += kCB) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < c; k0 += kKC) {  // c % 64 == 0: whole chunks
        {
          const int r = rb + threadIdx.x / 4, kq = (threadIdx.x % 4) * 4;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (r < pw) {
            const int iy = y0 - 1 + r / kWinW, ix = x0 - 1 + r % kWinW;
            if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
              load4(x + (img + static_cast<size_t>(iy) * w + ix) * c + k0 + kq, v);
            }
          }
          float* dst = as + (threadIdx.x / 4) * kAsLd + kq;
          dst[0] = v[0]; dst[1] = v[1]; dst[2] = v[2]; dst[3] = v[3];
        }
        stage_weights(bs, w1, c, m, k0, cb);
        __syncthreads();
        mac(acc, as, arow, 0, kKC, bs, tx);
        __syncthreads();
      }
      const int n = cb + tx * 4;
      if (n < m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rb + ty + 16 * i;
          if (r >= pw) continue;
          const int iy = y0 - 1 + r / kWinW, ix = x0 - 1 + r % kWinW;
          const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = inside ? bn_relu(acc[i][j], i1[n + j], o1[n + j]) : 0.0f;
          }
          store4(t1 + r * ldt + n, v);
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: t2 = relu(bn2(3x3 SAME conv of t1)), the nine taps as K
  for (int cb = 0; cb < m; cb += kCB) {
    float acc[4][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int arow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i < p ? ty + 16 * i : 0;
        arow[i] = ((r / kTileW + dy) * kWinW + r % kTileW + dx) * ldt;
      }
      const float* wt = w2 + static_cast<size_t>(tap) * m * m;
      for (int k0 = 0; k0 < m; k0 += kKC) {
        stage_weights(bs, wt, m, m, k0, cb);
        __syncthreads();
        mac(acc, t1, arow, k0, min(kKC, m - k0), bs, tx);
        __syncthreads();
      }
    }
    const int n = cb + tx * 4;
    if (n < m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= p) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = bn_relu(acc[i][j], i2[n + j], o2[n + j]);
        store4(t2 + r * ldt + n, v);
      }
    }
  }
  __syncthreads();

  // ---- phase 3: out = relu(bn3(t2 . w3) + x)
  int arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) arow[i] = (ty + 16 * i < p ? ty + 16 * i : 0) * ldt;
  for (int cb = 0; cb < c; cb += kCB) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < m; k0 += kKC) {
      stage_weights(bs, w3, m, c, k0, cb);
      __syncthreads();
      mac(acc, t2, arow, k0, min(kKC, m - k0), bs, tx);
      __syncthreads();
    }
    const int n = cb + tx * 4;  // < c: c % 64 == 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int oy = y0 + r / kTileW, ox = x0 + r % kTileW;
      if (r >= p || oy >= h) continue;
      const size_t at = (img + static_cast<size_t>(oy) * w + ox) * c + n;
      float res[4], v[4];
      load4(x + at, res);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(acc[i][j], i3[n + j]), o3[n + j]),
                               res[j]), 0.0f);
      }
      store4(out + at, v);
    }
  }
}

// ------------------------------------------------- bf16 on the tensor cores
//
// The same three phases with bf16 operands on mma.sync m16n8k16 (f32
// accumulation), for M % 32 == 0 (every ResNet width; the wrapper rejects
// other bf16 widths). The 8 warps of a
// block tile a 64-row x 64-column pass as 2 x 4 warp tiles of 32 x 16.
// Operand fragments come from shared memory through ldmatrix: A rows are
// pixel rows of t1 (phase 2 hands each lane the row of its shifted pixel,
// so the 3x3 im2col costs nothing), t2 (phase 3) or a staged chunk of x
// (phase 1); the weights are staged in 32 x 64 tiles and read transposed.

constexpr int kMKC = 32;         // k-chunk of a tensor-core pass
constexpr int kBLd = kCB + 8;    // staged weight tile row stride (elements)
constexpr int kALd = kMKC + 8;   // staged x chunk row stride (elements)
using bf16 = __nv_bfloat16;

// rows k0..k0+31, columns cb..cb+63 of the (kdim, ndim) bf16 weight matrix
// into bs (zero beyond ndim); kdim % 32 == 0, ndim % 8 == 0
__device__ __forceinline__ void stage_weights_mma(bf16* bs, const bf16* __restrict__ wgt,
                                                  int ndim, int k0, int cb) {
  const int kr = threadIdx.x / 8, nq = (threadIdx.x % 8) * 8;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (cb + nq < ndim) {
    v = *reinterpret_cast<const uint4*>(wgt + static_cast<size_t>(k0 + kr) * ndim + cb + nq);
  }
  *reinterpret_cast<uint4*>(bs + kr * kBLd + nq) = v;
}

// acc[i][j] += A(m-tile i of the warp) . B(n-tile j of the warp) over one
// 32-deep chunk; arow[i] is the shared address of this lane's A row (lane
// % 16 of m-tile i) at the chunk's first column
__device__ __forceinline__ void mma_chunk(float acc[2][2][4], const unsigned arow[2],
                                          const bf16* bs, int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < kMKC; ks += 16) {
    unsigned a[2][4], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4(arow[i] + (ks + (lane / 16) * 8) * 2, a[i]);
    const int kr = ks + lane % 8 + 8 * ((lane / 8) % 2);
    ldsm_x4_trans(smem_addr(bs + kr * kBLd + wn * 16 + 8 * (lane / 16)), b);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bf16(acc[i][0], a[i], b[0], b[1]);
      mma_bf16(acc[i][1], a[i], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                      const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ w3,
                      const float* __restrict__ i1, const float* __restrict__ o1,
                      const float* __restrict__ i2, const float* __restrict__ o2,
                      const float* __restrict__ i3, const float* __restrict__ o3,
                      int h, int w, int c, int m, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldt = m + kPadBf16;
  const int pw = (th + 2) * kWinW;  // window pixels
  const int p = th * kTileW;        // output pixels
  bf16* t1 = reinterpret_cast<bf16*>(smem);
  bf16* t2 = t1 + pw * ldt;
  bf16* bs = t2 + p * ldt;          // kMKC x kBLd
  bf16* as = bs + kMKC * kBLd;      // kRB x kALd

  const int y0 = blockIdx.y * th, x0 = blockIdx.x * kTileW;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;  // 32-row, 16-column warp tile
  const int g = lane / 4, tq = lane % 4;   // accumulator row and column pair
  auto inside = [&](int r) {
    const int iy = y0 - 1 + r / kWinW, ix = x0 - 1 + r % kWinW;
    return iy >= 0 && iy < h && ix >= 0 && ix < w;
  };

  // ---- phase 1: t1 over the window, 0 outside the image
  for (int rb = 0; rb < pw; rb += kRB) {
    unsigned arow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) arow[i] = smem_addr(as + (wm * 32 + i * 16 + lane % 16) * kALd);
    for (int cb = 0; cb < m; cb += kCB) {
      float acc[2][2][4] = {};
      for (int k0 = 0; k0 < c; k0 += kMKC) {
        {
          const int r = rb + threadIdx.x / 4, kq = (threadIdx.x % 4) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (r < pw && inside(r)) {
            const int iy = y0 - 1 + r / kWinW, ix = x0 - 1 + r % kWinW;
            v = *reinterpret_cast<const uint4*>(
                x + (img + static_cast<size_t>(iy) * w + ix) * c + k0 + kq);
          }
          *reinterpret_cast<uint4*>(as + (threadIdx.x / 4) * kALd + kq) = v;
        }
        stage_weights_mma(bs, w1, m, k0, cb);
        __syncthreads();
        mma_chunk(acc, arow, bs, wn, lane);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = cb + wn * 16 + j * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rb + wm * 32 + i * 16 + g + 8 * half;
            if (r >= pw || n >= m) continue;
            float v0 = 0.0f, v1 = 0.0f;
            if (inside(r)) {
              v0 = bn_relu(acc[i][j][2 * half], i1[n], o1[n]);
              v1 = bn_relu(acc[i][j][2 * half + 1], i1[n + 1], o1[n + 1]);
            }
            *reinterpret_cast<__nv_bfloat162*>(t1 + r * ldt + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: t2 from the nine shifted views of t1
  for (int cb = 0; cb < m; cb += kCB) {
    float acc[2][2][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned arow[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int r = wm * 32 + i * 16 + lane % 16;
        r = r < p ? r : 0;
        arow[i] = smem_addr(t1 + ((r / kTileW + dy) * kWinW + r % kTileW + dx) * ldt);
      }
      const bf16* wt = w2 + static_cast<size_t>(tap) * m * m;
      for (int k0 = 0; k0 < m; k0 += kMKC) {
        stage_weights_mma(bs, wt, m, k0, cb);
        __syncthreads();
        const unsigned at[2] = {arow[0] + k0 * 2, arow[1] + k0 * 2};
        mma_chunk(acc, at, bs, wn, lane);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = cb + wn * 16 + j * 8 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + i * 16 + g + 8 * half;
          if (r >= p || n >= m) continue;
          *reinterpret_cast<__nv_bfloat162*>(t2 + r * ldt + n) = __floats2bfloat162_rn(
              bn_relu(acc[i][j][2 * half], i2[n], o2[n]),
              bn_relu(acc[i][j][2 * half + 1], i2[n + 1], o2[n + 1]));
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 3: out = relu(bn3(t2 . w3) + x)
  unsigned arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wm * 32 + i * 16 + lane % 16;
    arow[i] = smem_addr(t2 + (r < p ? r : 0) * ldt);
  }
  for (int cb = 0; cb < c; cb += kCB) {
    float acc[2][2][4] = {};
    for (int k0 = 0; k0 < m; k0 += kMKC) {
      stage_weights_mma(bs, w3, c, k0, cb);
      __syncthreads();
      const unsigned at[2] = {arow[0] + k0 * 2, arow[1] + k0 * 2};
      mma_chunk(acc, at, bs, wn, lane);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = cb + wn * 16 + j * 8 + 2 * tq;  // < c: c % 64 == 0
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + i * 16 + g + 8 * half;
          const int oy = y0 + r / kTileW, ox = x0 + r % kTileW;
          if (r >= p || oy >= h) continue;
          const size_t at = (img + static_cast<size_t>(oy) * w + ox) * c + n;
          const float2 res = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + at));
          const float v0 = fmaxf(__fadd_rn(__fadd_rn(
              __fmul_rn(acc[i][j][2 * half], i3[n]), o3[n]), res.x), 0.0f);
          const float v1 = fmaxf(__fadd_rn(__fadd_rn(
              __fmul_rn(acc[i][j][2 * half + 1], i3[n + 1]), o3[n + 1]), res.y), 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <typename T>
size_t smem_bytes(int m, int th) {
  const bool tensor_cores = sizeof(T) == sizeof(bf16);
  const size_t ldt = m + (tensor_cores ? kPadBf16 : kPadF32);
  const size_t tiles = ((th + 2) * kWinW + th * kTileW) * ldt * sizeof(T);
  return tensor_cores ? tiles + (kMKC * kBLd + kRB * kALd) * sizeof(bf16)
                      : tiles + (kKC * kCB + kRB * kAsLd) * sizeof(float);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* x, void* out,
           const void* w1, const void* w2, const void* w3,
           const float* const bn[6], int b, int h, int w, int c, int m,
           cudaStream_t stream) {
  // the tallest tile whose t1 and t2 fit one block's shared memory
  int th = 8;
  while (th > 1 && smem_bytes<T>(m, th) > 232448) th /= 2;
  const size_t smem = smem_bytes<T>(m, th);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(w / kTileW, (h + th - 1) / th, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3), bn[0], bn[1], bn[2],
      bn[3], bn[4], bn[5], h, w, c, m, th);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/out: (b, h, w, c) NHWC in the compute dtype (kind 0 float32, 1 bfloat16),
// distinct buffers; w1 (c, m), w2 (3, 3, m, m), w3 (m, c) in the compute
// dtype; bn1/bn2 inv and off (m,), bn3 inv and off (c,) float32. Needs
// w % 8 == 0, c % 64 == 0, m % 8 == 0 (bfloat16: m % 32 == 0) and 16-byte
// aligned pointers.
TDNET_EXPORT int tdnet_bottleneck(const void* x, void* out, const void* w1,
                                  const void* w2, const void* w3,
                                  const void* i1, const void* o1,
                                  const void* i2, const void* o2,
                                  const void* i3, const void* o3,
                                  int b, int h, int w, int c, int m, int kind,
                                  void* stream) {
  const float* bn[6] = {static_cast<const float*>(i1), static_cast<const float*>(o1),
                        static_cast<const float*>(i2), static_cast<const float*>(o2),
                        static_cast<const float*>(i3), static_cast<const float*>(o3)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == tdnet::kBFloat16) {
    if (m % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<bf16>(bottleneck_mma_kernel, x, out, w1, w2, w3, bn, b, h, w, c, m, s);
  }
  return launch<float>(bottleneck_kernel, x, out, w1, w2, w3, bn, b, h, w, c, m, s);
}
