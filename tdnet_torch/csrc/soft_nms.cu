// Soft-NMS rescoring, one block per (batch, class) row, one barrier a pick.
//
// Replaces the Pallas kernel tdnet/ops/soft_nms.py soft_nms_rescore_batched
// (_soft_nms_kernel). Each row makes up to `iters` greedy picks: the largest
// remaining score, the LOWEST index on ties (the Pallas kernel's min-lane
// reduction, jnp.argmax's order). A pick above the threshold keeps its
// current score; the others are decayed by their exact IoU with it
// (gaussian exp(-iou^2 / sigma), or linear 1 - iou above the IoU
// threshold); a removed box is -inf and is never multiplied (linear decay is
// 0 at IoU 1, and -inf * 0 is NaN). Unpicked boxes get 0. The row stops as
// soon as its best remaining score is at or below the threshold (the Pallas
// kernel stops per tile of 8 rows; the output is the same, since scores
// only decay).
//
// Bound on the H100 by latency: 300 picks a row in a dependent chain, each
// a block-wide argmax and then K IoUs and decays. Three block barriers and
// two shuffle reductions a pick cost ~2.7 us in the first port, for four
// IoUs a thread. Here each thread owns CPT consecutive candidates (one for
// K <= 1024) and keeps their boxes, areas and remaining scores in
// registers; the row's boxes are staged once in shared memory, so the
// pick's box is read by index. A candidate that does not meet the pick
// takes the decay of IoU 0, computed once. Decaying and choosing the next
// pick are one
// step: each thread decays its candidates and forms an order-preserving
// 32-bit key of its best remaining score (its lowest index on ties);
// __reduce_max_sync over the keys, then __ballot_sync + __ffs, give the
// warp's lowest-index maximum (lanes, and then warps, hold ascending
// indices); the warp's leader writes (key, index) into a shared slot
// double-buffered by the pick's parity; one __syncthreads; then every warp
// reduces the slots itself. One barrier a pick instead of three.
//
// The IoU and the decay keep the first port's operation order with
// explicitly rounded IEEE intrinsics, so nvcc cannot contract a multiply and
// an add into an FMA; the gaussian uses expf (not __expf) and __fdiv_rn.
// The output is bit-equal to the first port's.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0;  // below every score's key

// larger score -> larger key; -0 and +0 get one key (they compare equal)
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// gaussian exp(-iou^2 / sigma), or linear 1 - iou above the IoU threshold
__device__ __forceinline__ float decay_of(float iou, int linear, float sigma,
                                          float iou_thr) {
  if (linear) return iou > iou_thr ? __fsub_rn(1.0f, iou) : 1.0f;
  return expf(__fdiv_rn(-__fmul_rn(iou, iou), sigma));
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                float* __restrict__ out, int k, int iters, int linear,
                float sigma, float iou_thr, float score_thr) {
  extern __shared__ float4 sbox[];
  __shared__ unsigned long long slot[2][kMaxWarps];  // key << 32 | index

  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = threadIdx.x * CPT;
  float4 box[CPT];
  float area[CPT], rem[CPT], picked[CPT];
  unsigned best = kNone;
  int best_j = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c;
    picked[c] = 0.0f;
    rem[c] = -INFINITY;
    if (j < k) {
      box[c] = boxes[base + j];
      sbox[j] = box[c];
      area[c] = box_area(box[c]);
      const float s = scores[base + j];
      if (s > score_thr) rem[c] = s;
      const unsigned key = score_key(rem[c]);
      if (key > best) {  // j ascends: the first maximum of this thread's share
        best = key;
        best_j = j;
      }
    }
  }
  // the first pick's barrier also publishes sbox
  // the decay where the boxes do not meet (IoU 0), computed once: most do
  // not, and the IEEE division's range check sends a zero numerator down
  // its slow path
  const float decay_zero = decay_of(0.0f, linear, sigma, iou_thr);

  for (int t = 0; t < iters; ++t) {
    const unsigned wmax = __reduce_max_sync(kFull, best);
    if (lane == __ffs(__ballot_sync(kFull, best == wmax)) - 1) {
      slot[t & 1][warp] = static_cast<unsigned long long>(wmax) << 32 |
                          static_cast<unsigned>(best_j);
    }
    __syncthreads();
    // every warp reduces the slots: the lowest-index maximum of the row
    const unsigned long long s =
        lane < static_cast<int>(blockDim.x >> 5) ? slot[t & 1][lane] : 0ull;
    const unsigned skey = static_cast<unsigned>(s >> 32);
    const unsigned top_key = __reduce_max_sync(kFull, skey);
    const int src = __ffs(__ballot_sync(kFull, skey == top_key)) - 1;
    const int sel = __shfl_sync(kFull, static_cast<int>(s & 0xffffffffu), src);
    if (!(key_score(top_key) > score_thr)) break;  // the same in every thread

    const float4 bb = sbox[sel];
    const float ba = box_area(bb);
    best = kNone;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      if (j >= k) continue;
      const float r = rem[c];
      if (j == sel) {
        picked[c] = r;
        rem[c] = -INFINITY;
      } else if (r != -INFINITY) {
        const float4 b = box[c];
        const float iw = fmaxf(__fsub_rn(fminf(b.z, bb.z), fmaxf(b.x, bb.x)), 0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(b.w, bb.w), fmaxf(b.y, bb.y)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(area[c], ba), inter);
        rem[c] = __fmul_rn(r, uni > 0.0f && inter != 0.0f
                                  ? decay_of(__fdiv_rn(inter, uni), linear, sigma, iou_thr)
                                  : decay_zero);
      }
      const unsigned key = score_key(rem[c]);
      if (key > best) {
        best = key;
        best_j = j;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (j0 + c < k) out[base + j0 + c] = picked[c];
  }
}

template <int CPT>
cudaError_t launch(const float4* boxes, const float* scores, float* out, int rows,
                   int k, int iters, int linear, float sigma, float iou_thr,
                   float score_thr, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = ((k + CPT - 1) / CPT + 31) / 32 * 32;
  soft_nms_kernel<CPT><<<rows, threads, smem, stream>>>(
      boxes, scores, out, k, iters, linear, sigma, iou_thr, score_thr);
  return cudaGetLastError();
}

}  // namespace

// boxes: (rows, k, 4) float32, 16-byte aligned; scores/out: (rows, k) float32.
TDNET_EXPORT int tdnet_soft_nms(const void* boxes, const void* scores, void* out,
                                int rows, int k, int iters, int linear,
                                float sigma, float iou_thr, float score_thr,
                                void* stream) {
  const float4* b = static_cast<const float4*>(boxes);
  const float* s = static_cast<const float*>(scores);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= kMaxThreads) {
    err = launch<1>(b, s, o, rows, k, iters, linear, sigma, iou_thr, score_thr, st);
  } else if (k <= 2 * kMaxThreads) {
    err = launch<2>(b, s, o, rows, k, iters, linear, sigma, iou_thr, score_thr, st);
  } else if (k <= 4 * kMaxThreads) {
    err = launch<4>(b, s, o, rows, k, iters, linear, sigma, iou_thr, score_thr, st);
  } else if (k <= 8 * kMaxThreads) {
    err = launch<8>(b, s, o, rows, k, iters, linear, sigma, iou_thr, score_thr, st);
  } else if (k <= 16 * kMaxThreads) {
    err = launch<16>(b, s, o, rows, k, iters, linear, sigma, iou_thr, score_thr, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
