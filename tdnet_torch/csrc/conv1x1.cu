// Fused 1x1 convolution + folded frozen BN + optional residual + optional
// ReLU: out = [relu]((x . w) * inv + off [+ residual]) over an (M, K) x
// (K, N) product, float32 or bfloat16.
//
// Replaces the Pallas kernel tdnet/ops/pallas_conv.py fused_conv1x1
// (_kernel_res, _kernel_nores). Its contract, not its tiling: operands in
// the compute dtype (the wrapper casts the weight and the residual), products
// accumulated in f32, the accumulator rounded to the compute dtype BEFORE the
// affine (as the unfused conv emits it), inv and off rounded to the compute
// dtype, then y * inv, + off, + residual and the ReLU each computed in f32
// and rounded to the compute dtype after every operation (what XLA and
// PyTorch do for bf16 elementwise ops). IEEE-rounded multiply and add: nvcc
// would otherwise contract y * inv + off into one FMA with a single rounding,
// which moves a share of the bf16 outputs by an ulp. The Pallas kernel pads M
// and N to its tiles (a TPU constraint); here every load and store is
// guarded, so any M and N work.
//
// Design. A block of 256 threads owns a 64 x 64 output tile; the grid is
// one-dimensional with the N tiles of one row tile adjacent, so the blocks
// that share x rows run together and find them in L2.
// - bf16 (mma_kernel): 8 warps tile the 64 x 64 block as 2 x 4 warp tiles
//   of 32 x 16 on mma.sync m16n8k16 (f32 accumulation), operands staged in
//   shared memory in 32-deep k-chunks and read through ldmatrix (the
//   fragment code of block.cu). K % 16 == 0 (every ResNet width; the wrapper
//   rejects other K); a half chunk is zero-filled. The epilogue goes through
//   shared memory: the accumulator, rounded to bf16, is written there, and
//   each thread then applies the affine, residual and ReLU to 8 consecutive
//   columns with 16-byte residual loads and output stores.
// - f32 (fma_kernel): 4 x 4 outputs a thread on CUDA-core FMAs (f32 must
//   match the plain version with TF32 off, which the tensor cores cannot),
//   k-chunks of 16 staged in shared memory, any K.
//
// What bounds it on the H100: at the conv3 shapes of ResNet stages 2-5 with
// a residual, bytes (x, the residual and the output: 2-3 bytes moved per
// 2K-16K operations, below the 295 operations a byte that the bf16 tensor
// cores need). The design keeps the product's operands out of registers'
// way and makes the residual read and the output write 16-byte coalesced;
// x is re-read once per 64 output columns, from L2. No double buffering, no
// TMA or wgmma: later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;          // output rows of a block
constexpr int kBN = 64;          // output columns of a block
constexpr int kKC = 32;          // k-chunk of a tensor-core pass
constexpr int kALd = kKC + 8;    // staged x chunk row stride (bf16 elements)
constexpr int kBLd = kBN + 8;    // staged weight tile row stride (elements)
constexpr int kOLd = kBN + 8;    // staged output tile row stride (elements)
constexpr int kFKC = 16;         // k-chunk of the f32 body
using bf16 = __nv_bfloat16;

// the epilogue of one element, y already rounded to T
template <typename T>
__device__ __forceinline__ float epilogue(float y, float inv, float off,
                                          bool has_res, float res, bool relu) {
  const T dummy{};
  y = tdnet::to_float(tdnet::round_to(__fmul_rn(y, inv), dummy));
  y = tdnet::to_float(tdnet::round_to(__fadd_rn(y, off), dummy));
  if (has_res) y = tdnet::to_float(tdnet::round_to(__fadd_rn(y, res), dummy));
  return relu ? fmaxf(y, 0.0f) : y;
}

// ------------------------------------------------- bf16 on the tensor cores

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 values at p, zero beyond `valid` of them (16-byte load when all
// are valid and `vec`)
__device__ __forceinline__ uint4 load8(const bf16* p, int valid, bool vec) {
  if (valid >= 8 && vec) return *reinterpret_cast<const uint4*>(p);
  union { uint4 v; bf16 e[8]; } u;
#pragma unroll
  for (int i = 0; i < 8; ++i) u.e[i] = i < valid ? p[i] : __float2bfloat16_rn(0.0f);
  return u.v;
}

__global__ void __launch_bounds__(kThreads)
mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const float* __restrict__ inv, const float* __restrict__ off,
           const bf16* __restrict__ res, bf16* __restrict__ out,
           int m, int k, int n, int relu) {
  __shared__ __align__(16) bf16 as[kBM * kALd];
  __shared__ __align__(16) bf16 bs[kKC * kBLd];
  __shared__ __align__(16) bf16 os[kBM * kOLd];
  const int n_tiles = (n + kBN - 1) / kBN;
  const int row0 = static_cast<int>(blockIdx.x / n_tiles) * kBM;
  const int col0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;  // 32-row, 16-column warp tile
  const int g = lane / 4, tq = lane % 4;   // accumulator row and column pair
  const bool nvec = n % 8 == 0;

  unsigned arow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) arow[i] = smem_addr(as + (wm * 32 + i * 16 + lane % 16) * kALd);

  float acc[2][2][4] = {};
  for (int k0 = 0; k0 < k; k0 += kKC) {
    {  // x rows row0.., columns k0..k0+31: one 16-byte piece a thread
      const int r = threadIdx.x / 4, kq = (threadIdx.x % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < m && k0 + kq < k) {
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * k + k0 + kq);
      }
      *reinterpret_cast<uint4*>(as + r * kALd + kq) = v;
    }
    {  // weight rows k0..k0+31, columns col0..col0+63
      const int kr = threadIdx.x / 8, nq = (threadIdx.x % 8) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + kr < k && col0 + nq < n) {
        v = load8(w + static_cast<size_t>(k0 + kr) * n + col0 + nq, n - col0 - nq, nvec);
      }
      *reinterpret_cast<uint4*>(bs + kr * kBLd + nq) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
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
    __syncthreads();
  }

  // the accumulator rounded to bf16 (the conv's output) into shared memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 16 + j * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + i * 16 + g + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(os + r * kOLd + c) =
            __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
  __syncthreads();

  // epilogue: 8 consecutive columns a thread, two passes over 64 x 64
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int r = pass * 32 + threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
    const int row = row0 + r, col = col0 + c;
    if (row >= m || col >= n) continue;
    const int valid = min(8, n - col);
    const size_t at = static_cast<size_t>(row) * n + col;
    union { uint4 v; bf16 e[8]; } y, rv, o;
    y.v = *reinterpret_cast<const uint4*>(os + r * kOLd + c);
    rv.v = res != nullptr ? load8(res + at, valid, nvec) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int cc = e < valid ? col + e : col;
      const float iv = __bfloat162float(__float2bfloat16_rn(inv[cc]));
      const float of = __bfloat162float(__float2bfloat16_rn(off[cc]));
      o.e[e] = __float2bfloat16_rn(epilogue<bf16>(
          __bfloat162float(y.e[e]), iv, of, res != nullptr,
          __bfloat162float(rv.e[e]), relu != 0));
    }
    if (valid == 8 && nvec) {
      *reinterpret_cast<uint4*>(out + at) = o.v;
    } else {
      for (int e = 0; e < valid; ++e) out[at + e] = o.e[e];
    }
  }
}

// ------------------------------------------------------ f32 on the CUDA cores

__global__ void __launch_bounds__(kThreads)
fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ inv, const float* __restrict__ off,
           const float* __restrict__ res, float* __restrict__ out,
           int m, int k, int n, int relu) {
  __shared__ float as[kBM * (kFKC + 1)];
  __shared__ float bs[kFKC * kBN];
  const int n_tiles = (n + kBN - 1) / kBN;
  const int row0 = static_cast<int>(blockIdx.x / n_tiles) * kBM;
  const int col0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  // this thread's outputs: rows ty + 16 i, columns tx + 16 j (a warp's
  // stores cover 16 consecutive columns of two rows)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kFKC) {
#pragma unroll
    for (int i = 0; i < kBM * kFKC / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kFKC, kk = e % kFKC;
      as[r * (kFKC + 1) + kk] = (row0 + r < m && k0 + kk < k)
          ? x[static_cast<size_t>(row0 + r) * k + k0 + kk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kFKC * kBN / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int kk = e / kBN, c = e % kBN;
      bs[kk * kBN + c] = (k0 + kk < k && col0 + c < n)
          ? w[static_cast<size_t>(k0 + kk) * n + col0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFKC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * (kFKC + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      const size_t at = static_cast<size_t>(row) * n + col;
      out[at] = epilogue<float>(acc[i][j], inv[col], off[col], res != nullptr,
                                res != nullptr ? res[at] : 0.0f, relu != 0);
    }
  }
}

}  // namespace

// x (m, k), w (k, n), residual (m, n) or null and out (m, n), all in the
// compute dtype (kind 0 float32, 1 bfloat16), row-major; inv and off (n,)
// float32. bfloat16 needs k % 16 == 0 and 16-byte aligned x, w, residual
// and out.
TDNET_EXPORT int tdnet_conv1x1(const void* x, const void* w, const void* inv,
                               const void* off, const void* res, void* out,
                               int m, int k, int n, int relu, int kind,
                               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float* fi = static_cast<const float*>(inv);
  const float* fo = static_cast<const float*>(off);
  if (kind == tdnet::kBFloat16) {
    if (k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), fi, fo,
        static_cast<const bf16*>(res), static_cast<bf16*>(out), m, k, n, relu);
  } else {
    fma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), fi, fo,
        static_cast<const float*>(res), static_cast<float*>(out), m, k, n, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
