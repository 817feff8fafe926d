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
// Design. Three phases per output tile: phase 1 computes t1 over the tile's
// window (the tile and its one-pixel halo) from x and w1 into shared
// memory; phase 2 computes t2 for the tile from the nine shifted views of
// t1 and w2 (K = 9M) into shared memory; phase 3 computes the 1x1 back to
// C, adds the residual from x and writes the output.
//
// bf16 (config 4's path; bottleneck_tc_kernel, M % 32 == 0) runs the
// products on Hopper's warpgroup tensor-core product (wgmma, f32
// accumulation). What bounds it on the H100: at ResNet-101's 1024^2 stages,
// one launch at batch 16 is 146 GFLOP, 0.148 ms at the bf16 peak (stages 4,
// 5), or 0.54-1.07 GB of activations, 0.16-0.32 ms at the HBM rate (stages
// 2, 3). But every tile streams the block's whole weights (2.2 MB at stage
// 4) through L2, and every product waits on its operands, so the design
// fights L2 traffic and latency first:
//   - tiles of 16 x 8 pixels (an 18 x 10 window; 8 x 8 where t1 and t2 do
//     not fit, stage 5) halve the weight bytes an output pixel, and cut
//     conv1's halo work from 1.56x to 1.41x;
//   - the weights (and phase 1's x chunks) arrive through a 3-stage ring
//     of 64-deep chunks by cp.async, one wait and one barrier a chunk, the
//     next two chunks in flight while one computes; the weights are laid
//     out K-major by the wrapper and land in wgmma's 128-byte swizzle;
//   - each warpgroup multiplies 64-row blocks by its half of a pass's
//     columns (wgmma m64nNk16, N = 64 for 128-channel passes): A from
//     registers, each warp's 16 rows loaded by ldmatrix with per-lane row
//     addresses (so phase 2's shifted views of t1 cost nothing), B read
//     from the ring by descriptor;
//   - phase 3 copies each pass's residual tile into the t1 region by
//     cp.async, adds it in place and stores the tile with 16-byte copies;
//   - a persistent grid (one block an SM) walks the tiles in a fixed order,
//     and the products run in k order from 0, so outputs do not depend on
//     scheduling.
// Left: each stage's products are waited for before the next barrier, so
// they do not overlap the next stage's wait and copies (a fourth stage or
// a producer warp with mbarriers would); each phase fills the ring anew
// (3 fills a tile, which shows at stage 2's short phases); the weights are
// read once per tile from L2 (TMA multicast across a cluster would share
// them); one launch per block of a chain.
//
// f32 (bottleneck_kernel) runs the products on the CUDA cores as 4x4
// f32-FMA micro-tiles of 64 x 64 passes, the weights staged 16 rows at a
// time; its tile is TH x 8 pixels, TH 8 or smaller where t1 and t2 do not
// fit 227 KB (M 512: TH 4). TF32 would break the f32 contract.
//
// The tensor cores' f32 accumulation does not round like an FMA chain, so
// bf16 outputs sit within a few ulp of the plain version, not within one.
#include "mma.cuh"

namespace {

using tdnet::ldsm_x4;
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
// The same three phases with bf16 operands on wgmma (f32 accumulation over
// all of K, k-steps in order from 0), for M % 32 == 0. A persistent grid
// walks the tiles in a fixed order; a tile is TH x 8 output pixels (TH 16
// where t1, t2 and the ring fit, else 8). Each phase is a sequence of
// passes of NB output channels; a pass multiplies A rows (phase 1: a staged
// chunk of the x window; phase 2: the shifted views of t1, each lane handed
// the row of its shifted pixel; phase 3: t2) by the weights, which a
// 3-stage ring of 64-deep chunks feeds: cp.async copies, one wait and one
// barrier a chunk, chunks i+1 and i+2 in flight while chunk i computes,
// across the passes of a phase. The two warpgroups split a pass's columns;
// each multiplies all of its m64 blocks (3 or 2 in phase 1, 2 or 1 after).

namespace tc {

using bf16 = __nv_bfloat16;
using tdnet::cp_async16;
using tdnet::cp_async16_or_zero;
using tdnet::cp_async_commit;
using tdnet::cp_async_wait;
using tdnet::wgmma_bf16;
using tdnet::wgmma_commit;
using tdnet::wgmma_desc_sw128;
using tdnet::wgmma_fence;
using tdnet::wgmma_fence_operand;
using tdnet::wgmma_wait;

constexpr int kKS = 64;           // K of a ring stage
constexpr int kStages = 3;
constexpr int kXLd = kKS + 8;     // x stage row stride (elements)
constexpr int kWarpRows = 4, kWarpCols = 2;  // warps of a warpgroup, warpgroups
constexpr int kWgThreads = kThreads / kWarpCols;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

template <int TH, int NB>
struct Shape {
  static constexpr int kWin = (TH + 2) * kWinW;  // window pixels: t1's rows
  static constexpr int kPix = TH * kTileW;        // output pixels
  static constexpr int kMT1 = (kWin + 63) / 64;   // m64 blocks, phase 1
  static constexpr int kMT2 = kPix / 64;          // m64 blocks, phases 2, 3
  static constexpr int kRows1 = kMT1 * 64;        // phase 1's A rows (window, padded)
  static constexpr int kNW = NB / kWarpCols;      // a warpgroup's columns (wgmma N)
  static constexpr int kNT = kNW / 8;             // its n8 tiles
  static constexpr int kWStage = NB * kKS;        // K-major weight stage, elements
  static constexpr int kXStage = kRows1 * kXLd;
  static_assert(kPix % 64 == 0 && kNW % 16 == 0, "tile shape");
};

__host__ __device__ constexpr size_t align1k(size_t n) { return (n + 1023) / 1024 * 1024; }

// shared memory: t1 | kStages weight stages (1024-byte aligned, for the
// swizzle) | phase 1's x stages, then t2; 1024 bytes of slack to align it
template <int TH, int NB>
size_t smem_bytes(int m) {
  using S = Shape<TH, NB>;
  const size_t ldt = m + kPadBf16;
  const size_t xs = static_cast<size_t>(kStages) * S::kXStage, t2 = S::kPix * ldt;
  return 1024 + align1k(S::kWin * ldt * sizeof(bf16)) +
         (kStages * S::kWStage + (xs > t2 ? xs : t2)) * sizeof(bf16);
}

struct Params {
  const bf16* x;
  bf16* out;
  const bf16 *w1, *w2, *w3;
  const float *i1, *o1, *i2, *o2, *i3, *o3;
  int h, w, c, m, tiles_x, tiles_y, tiles;
};

// rows cb..cb+ROWS-1 of the K-major (ndim, kdim) weights, columns
// k0..k0+63 (those below kdim), into ROWS rows of a ring stage at ws, by
// NTHR threads (tid the caller's index among them): rows of 128 bytes,
// 16-byte chunk j of row n at chunk j ^ (n % 8) (wgmma's 128-byte swizzle;
// cb and ws at multiples of 8 rows)
template <int ROWS, int NTHR>
__device__ __forceinline__ void load_weights(bf16* ws, const bf16* __restrict__ wt,
                                             int kdim, int k0, int cb, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NTHR; ++i) {
    const int s = tid + i * NTHR, n = s / 8, seg = s % 8;
    if (k0 + seg * 8 < kdim) {
      cp_async16(ws + n * kKS + (seg ^ (n % 8)) * 8,
                 wt + static_cast<size_t>(cb + n) * kdim + k0 + seg * 8);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma_fence_operand(acc[i][j][e]);
}

// acc += A . B over the first `ksteps` k16 steps of a ring stage: this warp
// loads its A fragments with ldmatrix (a_addr(i, ks): this lane's row of m64
// block i at k-step ks), its warpgroup multiplies them on wgmma by the
// warpgroup's NT * 8 columns of B at wb, and waits for the products
template <int MT, int NT, class AAddr>
__device__ __forceinline__ void wgmma_stage(float (&acc)[MT][NT][4], const bf16* wb,
                                            int ksteps, AAddr a_addr) {
  unsigned a[kKS / 16][MT][4];
#pragma unroll
  for (int ks = 0; ks < kKS / 16; ++ks) {
    if (ks < ksteps) {
#pragma unroll
      for (int i = 0; i < MT; ++i) ldsm_x4(a_addr(i, ks), a[ks][i]);
    }
  }
  fence_acc(acc);
  wgmma_fence();
  const unsigned b0 = smem_addr(wb);
#pragma unroll
  for (int ks = 0; ks < kKS / 16; ++ks) {
    if (ks < ksteps) {
      const uint64_t desc = wgmma_desc_sw128(b0 + ks * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_bf16<NT * 8>(acc[i], a[ks][i], desc);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// Barriers: of the block, or of one warpgroup (named barrier 1 + wg), for
// phases whose warpgroups share nothing until the phase ends.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kWgThreads) : "memory");
  }
};

// The npass passes of a phase, nk chunks each, through the ring: load(p,
// kc, stage) issues the copies of chunk kc of pass p, mma(acc, kc, stage)
// multiplies a chunk, epi(p, acc) consumes the pass's sums; sync() is the
// barrier of the threads that share the ring (the block, or a warpgroup
// that owns its half). start(p) runs after the barrier of the pass's first
// chunk (every sharing thread is past the previous epilogue) and may issue
// copies of its own, which have landed and are visible when epi(p) runs.
// Returns with no copy in flight and every thread of the block past its
// last epilogue.
template <int MT, int NT, class Load, class Start, class Mma, class Epi, class Sync>
__device__ __forceinline__ void run_passes(int npass, int nk, Load load, Start start, Mma mma,
                                           Epi epi, Sync sync) {
  int lp = 0, lk = 0;  // the next chunk to copy
  auto issue = [&](int stage) {
    if (lp < npass) {
      load(lp, lk, stage);
      if (++lk == nk) lk = 0, ++lp;
    }
    cp_async_commit();  // one group a chunk, empty past the last
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  int stage = 0;
  for (int p = 0; p < npass; ++p) {
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kStages - 2>();  // this thread's copies of chunk kc landed
      sync();  // everyone's landed; everyone is done with the last stage
      if (kc == 0) start(p);
      issue(stage == 0 ? kStages - 1 : stage - 1);
      mma(acc, kc, stage);
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    if (nk < kStages) {  // start(p)'s group is not yet waited for
      cp_async_wait<0>();
      sync();
    }
    epi(p, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int TH, int NB>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_tc_kernel(const Params q) {
  using S = Shape<TH, NB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-smem_addr(smem_raw) & 1023u);
  const int c = q.c, m = q.m, ldt = m + kPadBf16;
  bf16* t1 = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + align1k(S::kWin * ldt * sizeof(bf16)));
  bf16* xs = ring + kStages * S::kWStage;  // phase 1's x stages ...
  bf16* t2 = xs;                           // ... where phases 2 and 3 keep t2
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // warpgroup wg owns columns [wg * kNW, (wg + 1) * kNW) of a pass; its warp
  // wm rows [64 i + 16 wm, 64 i + 16 wm + 16) of each m64 block i
  const int wm = warp % kWarpRows, wg = warp / kWarpRows, wcol = wg * S::kNW;
  const int g = lane / 4, tq = lane % 4;  // accumulator row and column pair
  // phases 2 and 3: each warpgroup streams its own half of the weights and
  // syncs alone, so one's waits overlap the other's products
  const int wtid = threadIdx.x % kWgThreads;
  const GroupSync wg_sync{1 + wg};

  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    const int x0 = (tile % q.tiles_x) * kTileW;
    const int y0 = ((tile / q.tiles_x) % q.tiles_y) * TH;
    const size_t img = static_cast<size_t>(tile / (q.tiles_x * q.tiles_y)) * q.h * q.w;
    auto inside = [&](int r) {  // window pixel r lies in the image
      const int iy = y0 - 1 + r / kWinW, ix = x0 - 1 + r % kWinW;
      return r < S::kWin && iy >= 0 && iy < q.h && ix >= 0 && ix < q.w;
    };

    // ---- phase 1: t1 over the window, 0 outside the image
    {
      constexpr int kPer = S::kRows1 * (kKS / 8) / kThreads;  // x copies a thread a chunk
      const bf16* src[kPer];
      bool in[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int s = threadIdx.x + i * kThreads, r = s / 8;
        in[i] = inside(r);
        src[i] = q.x + s % 8 * 8;
        if (in[i]) {
          src[i] += (img + static_cast<size_t>(y0 - 1 + r / kWinW) * q.w + x0 - 1 + r % kWinW) * c;
        }
      }
      auto load = [&](int p, int kc, int stage) {
        bf16* dst = xs + stage * S::kXStage;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int s = threadIdx.x + i * kThreads;
          cp_async16_or_zero(dst + s / 8 * kXLd + s % 8 * 8, src[i] + kc * kKS, in[i]);
        }
        load_weights<NB, kThreads>(ring + stage * S::kWStage, q.w1, c, kc * kKS, p * NB,
                                   threadIdx.x);
      };
      auto mma = [&](auto& acc, int, int stage) {
        const unsigned a0 = smem_addr(xs + stage * S::kXStage +
                                      (wm * 16 + lane % 16) * kXLd + lane / 16 * 8);
        wgmma_stage<S::kMT1, S::kNT>(
            acc, ring + stage * S::kWStage + wcol * kKS, kKS / 16,
            [&](int i, int ks) { return a0 + (i * 64 * kXLd + ks * 16) * 2; });
      };
      auto epi = [&](int p, auto& acc) {
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          const int n = p * NB + wcol + j * 8 + 2 * tq;
          const float2 inv = __ldg(reinterpret_cast<const float2*>(q.i1 + n));
          const float2 off = __ldg(reinterpret_cast<const float2*>(q.o1 + n));
#pragma unroll
          for (int i = 0; i < S::kMT1; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = i * 64 + wm * 16 + g + 8 * half;
              if (r >= S::kWin) continue;
              float v0 = 0.0f, v1 = 0.0f;
              if (inside(r)) {
                v0 = bn_relu(acc[i][j][2 * half], inv.x, off.x);
                v1 = bn_relu(acc[i][j][2 * half + 1], inv.y, off.y);
              }
              *reinterpret_cast<__nv_bfloat162*>(t1 + r * ldt + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      };
      run_passes<S::kMT1, S::kNT>(m / NB, c / kKS, load, [](int) {}, mma, epi, BlockSync{});
    }

    // this lane's A row of m16 tile i in phases 2 and 3: output pixel r
    int pix[S::kMT2];
#pragma unroll
    for (int i = 0; i < S::kMT2; ++i) pix[i] = i * 64 + wm * 16 + lane % 16;

    // ---- phase 2: t2 from the nine shifted views of t1 (K = 9M, tap-major)
    {
      unsigned a0[S::kMT2];  // tap (0, 0)
#pragma unroll
      for (int i = 0; i < S::kMT2; ++i) {
        a0[i] = smem_addr(t1 + (pix[i] / kTileW * kWinW + pix[i] % kTileW) * ldt + lane / 16 * 8);
      }
      const int kdim = 9 * m;
      auto load = [&](int p, int kc, int stage) {
        load_weights<S::kNW, kWgThreads>(ring + stage * S::kWStage + wcol * kKS, q.w2, kdim,
                                         kc * kKS, p * NB + wcol, wtid);
      };
      auto mma = [&](auto& acc, int kc, int stage) {
        const int k0 = kc * kKS, tap0 = k0 / m, ch0 = k0 - tap0 * m;
        wgmma_stage<S::kMT2, S::kNT>(
            acc, ring + stage * S::kWStage + wcol * kKS, min(kKS, kdim - k0) / 16,
            [&](int i, int ks) {
              int ch = ch0 + ks * 16, tap = tap0;  // a 64-deep chunk crosses a tap at most once
              if (ch >= m) ch -= m, ++tap;
              return a0[i] + ((tap / 3 * kWinW + tap % 3) * ldt + ch) * 2;
            });
      };
      auto epi = [&](int p, auto& acc) {
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          const int n = p * NB + wcol + j * 8 + 2 * tq;
          const float2 inv = __ldg(reinterpret_cast<const float2*>(q.i2 + n));
          const float2 off = __ldg(reinterpret_cast<const float2*>(q.o2 + n));
#pragma unroll
          for (int i = 0; i < S::kMT2; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = i * 64 + wm * 16 + g + 8 * half;
              *reinterpret_cast<__nv_bfloat162*>(t2 + r * ldt + n) = __floats2bfloat162_rn(
                  bn_relu(acc[i][j][2 * half], inv.x, off.x),
                  bn_relu(acc[i][j][2 * half + 1], inv.y, off.y));
            }
          }
        }
      };
      run_passes<S::kMT2, S::kNT>(m / NB, (kdim + kKS - 1) / kKS, load, [](int) {}, mma,
                                  epi, wg_sync);
    }

    // ---- phase 3: out = relu(bn3(t2 . w3) + x)
    {
      unsigned a0[S::kMT2];
#pragma unroll
      for (int i = 0; i < S::kMT2; ++i) a0[i] = smem_addr(t2 + pix[i] * ldt + lane / 16 * 8);
      auto load = [&](int p, int kc, int stage) {
        load_weights<S::kNW, kWgThreads>(ring + stage * S::kWStage + wcol * kKS, q.w3, m,
                                         kc * kKS, p * NB + wcol, wtid);
      };
      auto mma = [&](auto& acc, int kc, int stage) {
        const int k0 = kc * kKS;
        wgmma_stage<S::kMT2, S::kNT>(
            acc, ring + stage * S::kWStage + wcol * kKS, min(kKS, m - k0) / 16,
            [&](int i, int ks) { return a0[i] + (k0 + ks * 16) * 2; });
      };
      // The pass's residual tile goes through the t1 region, free now:
      // start copies the warpgroup's columns in, the epilogue adds them and
      // writes the result back in place, and the warpgroup stores them with
      // 16-byte copies.
      constexpr int kSeg = S::kNW / 8;
      constexpr int kRLd = NB + 8;
      bf16* rt = t1 + wcol;  // (kPix, kRLd), this warpgroup's columns
      auto pixel_at = [&](int r) -> long long {  // element offset, -1 below the image
        const int oy = y0 + r / kTileW, ox = x0 + r % kTileW;
        return oy < q.h ? static_cast<long long>((img + static_cast<size_t>(oy) * q.w + ox) * c)
                        : -1;
      };
      auto start = [&](int p) {
        for (int s = wtid; s < S::kPix * kSeg; s += kWgThreads) {
          const long long at = pixel_at(s / kSeg);
          if (at >= 0) {
            cp_async16(rt + s / kSeg * kRLd + s % kSeg * 8,
                       q.x + at + p * NB + wcol + s % kSeg * 8);
          }
        }
      };
      auto epi = [&](int p, auto& acc) {
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) {
          const int col = j * 8 + 2 * tq, n = p * NB + wcol + col;
          const float2 inv = __ldg(reinterpret_cast<const float2*>(q.i3 + n));
          const float2 off = __ldg(reinterpret_cast<const float2*>(q.o3 + n));
#pragma unroll
          for (int i = 0; i < S::kMT2; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = i * 64 + wm * 16 + g + 8 * half;
              auto* at = reinterpret_cast<__nv_bfloat162*>(rt + r * kRLd + col);
              const float2 res = __bfloat1622float2(*at);
              const float v0 = fmaxf(__fadd_rn(__fadd_rn(
                  __fmul_rn(acc[i][j][2 * half], inv.x), off.x), res.x), 0.0f);
              const float v1 = fmaxf(__fadd_rn(__fadd_rn(
                  __fmul_rn(acc[i][j][2 * half + 1], inv.y), off.y), res.y), 0.0f);
              *at = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
        wg_sync();
        for (int s = wtid; s < S::kPix * kSeg; s += kWgThreads) {
          const long long at = pixel_at(s / kSeg);
          if (at >= 0) {
            *reinterpret_cast<uint4*>(q.out + at + p * NB + wcol + s % kSeg * 8) =
                *reinterpret_cast<const uint4*>(rt + s / kSeg * kRLd + s % kSeg * 8);
          }
        }
      };
      run_passes<S::kMT2, S::kNT>(c / NB, (m + kKS - 1) / kKS, load, start, mma, epi,
                                  wg_sync);
    }
  }
}

// Launch (or, with info, only describe: {TH, NB, shared bytes, grid,
// tiles, blocks an SM}) the tensor-core body with tile height TH.
template <int TH, int NB>
int launch(Params q, int b, cudaStream_t stream, int* info) {
  const auto kernel = bottleneck_tc_kernel<TH, NB>;
  const size_t smem = smem_bytes<TH, NB>(q.m);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  q.tiles_x = q.w / kTileW;
  q.tiles_y = (q.h + TH - 1) / TH;
  q.tiles = q.tiles_x * q.tiles_y * b;
  const int grid = q.tiles < sms * per_sm ? q.tiles : sms * per_sm;
  if (info != nullptr) {
    const int v[6] = {TH, NB, static_cast<int>(smem), grid, q.tiles, per_sm};
    for (int i = 0; i < 6; ++i) info[i] = v[i];
    return 0;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// the tallest tile (16 or 8 rows) whose t1, t2 and ring fit
template <int NB>
int launch_nb(const Params& q, int b, cudaStream_t stream, int* info) {
  if (smem_bytes<16, NB>(q.m) <= kMaxSmem) return launch<16, NB>(q, b, stream, info);
  if (smem_bytes<8, NB>(q.m) <= kMaxSmem) return launch<8, NB>(q, b, stream, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

// passes of 128 channels where M and C allow, else 64 or 32
int launch_bf16(const Params& q, int b, cudaStream_t stream, int* info) {
  if (q.m % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q.m % 128 == 0 && q.c % 128 == 0) return launch_nb<128>(q, b, stream, info);
  if (q.m % 64 == 0) return launch_nb<64>(q, b, stream, info);
  return launch_nb<32>(q, b, stream, info);
}

}  // namespace tc

size_t smem_bytes_f32(int m, int th) {
  const size_t ldt = m + kPadF32;
  const size_t tiles = ((th + 2) * kWinW + th * kTileW) * ldt * sizeof(float);
  return tiles + (kKC * kCB + kRB * kAsLd) * sizeof(float);
}

int launch_f32(const float* x, float* out, const float* w1, const float* w2,
               const float* w3, const float* const bn[6], int b, int h, int w,
               int c, int m, cudaStream_t stream) {
  // the tallest tile whose t1 and t2 fit one block's shared memory
  int th = 8;
  while (th > 1 && smem_bytes_f32(m, th) > tc::kMaxSmem) th /= 2;
  const size_t smem = smem_bytes_f32(m, th);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(w / kTileW, (h + th - 1) / th, b);
  bottleneck_kernel<<<grid, kThreads, smem, stream>>>(
      x, out, w1, w2, w3, bn[0], bn[1], bn[2], bn[3], bn[4], bn[5], h, w, c, m, th);
  return static_cast<int>(cudaGetLastError());
}

tc::Params bf16_params(const void* x, void* out, const void* w1, const void* w2,
                       const void* w3, const float* const bn[6], int h, int w, int c,
                       int m) {
  using tc::bf16;
  return {static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(w1),
          static_cast<const bf16*>(w2), static_cast<const bf16*>(w3), bn[0], bn[1], bn[2],
          bn[3], bn[4], bn[5], h, w, c, m, 0, 0, 0};
}

}  // namespace

// x/out: (b, h, w, c) NHWC in the compute dtype (kind 0 float32, 1 bfloat16),
// distinct buffers; bn1/bn2 inv and off (m,), bn3 inv and off (c,) float32.
// float32 weights: w1 (c, m), w2 (3, 3, m, m) HWIO, w3 (m, c); bfloat16
// weights K-major (each output channel's inputs contiguous): w1 (m, c), w2
// (m, 9m) with k = (3 dy + dx) m + input channel, w3 (c, m). Needs w % 8 ==
// 0, c % 64 == 0, m % 8 == 0 (bfloat16: m % 32 == 0, and m <= 544 so that
// an 8-row tile fits shared memory) and 16-byte aligned pointers.
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
    return tc::launch_bf16(bf16_params(x, out, w1, w2, w3, bn, h, w, c, m), b, s, nullptr);
  }
  return launch_f32(static_cast<const float*>(x), static_cast<float*>(out),
                    static_cast<const float*>(w1), static_cast<const float*>(w2),
                    static_cast<const float*>(w3), bn, b, h, w, c, m, s);
}

// What tdnet_bottleneck would launch for a bfloat16 (b, h, w, c) input with
// width m on the current device, without launching: info[0..5] = tile
// height, pass width NB, dynamic shared bytes, grid, tiles, blocks an SM.
TDNET_EXPORT int tdnet_bottleneck_launch_info(int b, int h, int w, int c, int m, int* info) {
  const float* bn[6] = {};
  return tc::launch_bf16(bf16_params(nullptr, nullptr, nullptr, nullptr, nullptr, bn, h, w,
                                     c, m),
                         b, nullptr, info);
}
