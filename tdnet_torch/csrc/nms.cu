// Exact greedy NMS keep mask over score-sorted boxes: an IoU bitmask built
// over the whole card, then one warp a row scanning it.
//
// Replaces the Pallas kernels tdnet/ops/pallas_nms.py pallas_nms_keep
// (_nms_kernel) and pallas_nms_keep_rows (_nms_kernel_rows): both compute
// the same contract, so one pair of kernels serves both. A box is kept iff
// it is valid and no kept higher-ranked box has IoU above the threshold
// (strict >; IoU is 0 where the union is <= 0); an invalid box suppresses
// nothing; K need not be a multiple of anything.
//
// Bound on the H100 by latency, not bytes or FLOPs: greedy NMS is a chain
// of K dependent decisions a row. Walked with one block a row and a barrier
// a step, config 1's 16 rows kept 16 of 132 SMs busy for 1024 barriers.
// Here the chain carries no arithmetic and no barrier:
//
// - nms_mask_kernel computes every IoU the walk might need, spread over the
//   card: one 64-thread block per (row, 64-box block ib of i, 64-box block
//   jb >= ib of j), one thread per i, writing the 64-bit word whose bit b
//   says that i is valid and overlaps j = 64 jb + b above the threshold
//   (j > i, j < K). Words left of the diagonal are never written or read.
//   Most pairs do not meet; their IoU is 0 without the IEEE division,
//   whose range check sends a zero numerator down its slow path.
// - nms_scan_kernel walks a row with one warp: lane l holds the "removed"
//   words l, l + 32, ... in registers. Each 64-box chunk's mask rows arrive
//   in shared memory by one bulk copy (TMA) while the chunk before is
//   walked. Every lane resolves the chunk alike, box by box in rank order:
//   a box is kept iff valid and not removed, and then its diagonal word,
//   fetched from the lane that holds it by shuffle, joins the chunk's
//   removed set, so no lane has to broadcast the kept set. Each lane then
//   ORs the kept boxes' words for later chunks into its own words.
//
// The mask is scratch of R rows of K * ceil(K/64) words (padded to even)
// that the wrapper allocates: 2 MiB at 16 rows of 1024, 16 MiB at 128, so
// it stays in the 50 MB L2 between the two kernels.
//
// The IoU reproduces _pairwise_iou_tk (pallas_nms.py) operation for
// operation with explicitly rounded IEEE intrinsics, so nvcc cannot
// contract a multiply and an add into an FMA and flip a mask at IoU ~ thr.
#include "common.cuh"
#include "mma.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kChunk = 64;     // boxes a mask word covers
// the scan's two staged chunks, 2 * 64 * words * 8 bytes of shared memory,
// fit one block's 232,448: K <= 224 * 64 = 14336 (7 words a lane)
constexpr int kMaxWords = 224;
constexpr unsigned kFull = 0xffffffffu;

// a row's words in the mask, K * words rounded up to even, so that every
// chunk starts 16-byte aligned
__host__ __device__ __forceinline__ int64_t row_words(int k, int words) {
  const int64_t n = static_cast<int64_t>(k) * words;
  return n + (n & 1);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU of the higher-ranked box i with box j
__device__ __forceinline__ float box_iou(float4 bi, float ai, float4 bj, float aj) {
  const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  // inter / uni is 0 where inter is 0 (most pairs): no division there
  return uni > 0.0f && inter != 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// grid (rows, words * (words + 1) / 2): blockIdx.y counts the (ib <= jb)
// block pairs column by column, t = jb * (jb + 1) / 2 + ib
__global__ void __launch_bounds__(kChunk)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                u64* __restrict__ mask, int k, int words, float thr) {
  __shared__ float4 sbox[kChunk];
  __shared__ float sarea[kChunk];
  const int t = blockIdx.y;
  int jb = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (jb * (jb + 1) / 2 > t) --jb;
  while ((jb + 1) * (jb + 2) / 2 <= t) ++jb;
  const int ib = t - jb * (jb + 1) / 2;
  const int64_t row = blockIdx.x;

  const int jload = jb * kChunk + threadIdx.x;
  const float4 bj = jload < k ? boxes[row * k + jload] : make_float4(0.f, 0.f, 0.f, 0.f);
  sbox[threadIdx.x] = bj;
  sarea[threadIdx.x] = box_area(bj);
  __syncthreads();

  const int i = ib * kChunk + threadIdx.x;
  if (i >= k) return;
  u64 word = 0;
  if (valid[row * k + i]) {
    const float4 bi = boxes[row * k + i];
    const float ai = box_area(bi);
#pragma unroll
    for (int b = 0; b < kChunk; ++b) {
      if (box_iou(bi, ai, sbox[b], sarea[b]) > thr) word |= 1ull << b;
    }
    // only later boxes of the row: j > i, j < K
    const int n = k - jb * kChunk;
    if (n < kChunk) word &= (1ull << n) - 1;
    if (ib == jb) word &= threadIdx.x == kChunk - 1 ? 0ull : ~0ull << (threadIdx.x + 1);
  }
  mask[row * row_words(k, words) + static_cast<int64_t>(i) * words + jb] = word;
}

// ---- the bulk copy engine (TMA) and its shared-memory barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(tdnet::smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// copy `bytes` (a multiple of 16, both ends 16-byte aligned) global ->
// shared; the barrier's phase completes when they have landed
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tdnet::smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(tdnet::smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(tdnet::smem_addr(bar)) : "memory");
}

// wait for the barrier's phase of this parity; a copy that never lands
// ends the kernel with an error instead of hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int tries = 0; tries < (1 << 22); ++tries) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(tdnet::smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
  }
  __trap();
}

// one warp a row; WPL removed words a lane (words <= 32 * WPL). Shared
// memory holds the mask rows of two 64-box chunks: the one being walked,
// and the next one, arriving by one bulk copy meanwhile.
template <int WPL>
__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint8_t* __restrict__ valid, const u64* __restrict__ mask,
                uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ __align__(128) u64 stage[];  // [2][kChunk][words]
  __shared__ uint64_t bar[2];
  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const u64* rmask = mask + row * row_words(k, words);
  const uint8_t* rvalid = valid + row * k;
  uint8_t* rkeep = keep + row * k;

  // a chunk's rows are contiguous and start 16-byte aligned; an odd word
  // count rounds up into the row's padding word
  auto stage_chunk = [&](int c) {
    if (lane == 0) {
      const int n = min(kChunk, k - c * kChunk) * words;
      bulk_load(stage + (c & 1) * kChunk * words,
                rmask + static_cast<int64_t>(c) * kChunk * words,
                static_cast<unsigned>((n + (n & 1)) * sizeof(u64)), &bar[c & 1]);
    }
  };

  if (lane == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncwarp();
  stage_chunk(0);
  u64 removed[WPL];
#pragma unroll
  for (int q = 0; q < WPL; ++q) removed[q] = 0;
  int lo = lane, hi = 32 + lane;  // this lane's boxes of the chunk
  bool vlo = lo < k && rvalid[lo], vhi = hi < k && rvalid[hi];

  for (int c = 0; c < words; ++c) {
    if (c + 1 < words) stage_chunk(c + 1);
    mbar_wait(&bar[c & 1], (c >> 1) & 1);
    const u64* rows = stage + (c & 1) * kChunk * words;

    // the chunk's removed word, held by lane c % 32
    u64 own = 0;
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      if (q == c >> 5) own = removed[q];
    }
    const u64 rem = __shfl_sync(kFull, own, c & 31);
    // greedy within the chunk, the same in every lane, a 32-box half at a
    // time: box b is kept iff valid and not removed, and then its diagonal
    // word (boxes after b only, and b itself), fetched from lane b % 32 by
    // shuffle, leaves the set still to decide. Bit-reversed (box b at bit
    // 31 - b), __clz finds the next box in one step.
    const u64 dlo = rows[lane * words + c] | 1ull << lane;
    const u64 dhi = rows[(32 + lane) * words + c] | 1ull << (32 + lane);
    const unsigned lo_lo = __brev(static_cast<unsigned>(dlo));
    const unsigned lo_hi = __brev(static_cast<unsigned>(dlo >> 32));
    const unsigned hi_hi = __brev(static_cast<unsigned>(dhi >> 32));
    unsigned todo_lo = __brev(__ballot_sync(kFull, vlo) & ~static_cast<unsigned>(rem));
    unsigned todo_hi = __brev(__ballot_sync(kFull, vhi) & ~static_cast<unsigned>(rem >> 32));
    unsigned kept_lo = 0, kept_hi = 0;
    while (todo_lo) {
      const int b = __clz(todo_lo);
      kept_lo |= 1u << b;
      todo_lo &= ~__shfl_sync(kFull, lo_lo, b);
      todo_hi &= ~__shfl_sync(kFull, lo_hi, b);
    }
    while (todo_hi) {
      const int b = __clz(todo_hi);
      kept_hi |= 1u << b;
      todo_hi &= ~__shfl_sync(kFull, hi_hi, b);
    }
    if (lo < k) rkeep[lo] = static_cast<uint8_t>((kept_lo >> lane) & 1);
    if (hi < k) rkeep[hi] = static_cast<uint8_t>((kept_hi >> lane) & 1);
    if (c + 1 == words) break;
    lo += kChunk;
    hi += kChunk;
    vlo = lo < k && rvalid[lo];
    vhi = hi < k && rvalid[hi];

    // forward: the kept boxes' words for later chunks join this lane's
    // words, four kept boxes' loads in flight at a time
    const unsigned stride = words * sizeof(u64);
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const int w = lane + 32 * q;
      const bool later = w > c && w < words;
      const char* col = reinterpret_cast<const char*>(rows + min(w, words - 1));
      u64 acc = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned left = later ? (half ? kept_hi : kept_lo) : 0u;
        const char* base = col + half * 32 * stride;
        while (left) {
          u64 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int b = __ffs(left) - 1;  // -1 once none is left
            left &= left - 1;
            v[u] = b >= 0 ? *reinterpret_cast<const u64*>(base + b * stride) : 0ull;
          }
          acc |= v[0] | v[1] | v[2] | v[3];
        }
      }
      removed[q] |= acc;
    }
    __syncwarp();  // every lane is done with this buffer before it is restaged
  }
}

template <int WPL>
cudaError_t launch_scan(const uint8_t* valid, const u64* mask, uint8_t* keep,
                        int rows, int k, int words, cudaStream_t stream) {
  const int smem = 2 * kChunk * words * static_cast<int>(sizeof(u64));
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel<WPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nms_scan_kernel<WPL><<<rows, 32, smem, stream>>>(valid, mask, keep, k, words);
  return cudaGetLastError();
}

}  // namespace

// boxes: (rows, k, 4) float32, 16-byte aligned; valid/keep: (rows, k)
// bytes; mask: scratch of rows * row_words(k, ceil(k / 64)) 64-bit words.
TDNET_EXPORT int tdnet_nms_keep(const void* boxes, const void* valid, void* keep,
                                void* mask, int rows, int k, float thr,
                                void* stream) {
  const int words = (k + kChunk - 1) / kChunk;
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, words * (words + 1) / 2);
  nms_mask_kernel<<<grid, kChunk, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<u64*>(mask), k, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const u64* m = static_cast<const u64*>(mask);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (words <= 32) err = launch_scan<1>(v, m, out, rows, k, words, s);
  else if (words <= 64) err = launch_scan<2>(v, m, out, rows, k, words, s);
  else if (words <= 128) err = launch_scan<4>(v, m, out, rows, k, words, s);
  else err = launch_scan<8>(v, m, out, rows, k, words, s);
  return static_cast<int>(err);
}
