// Soft-NMS rescoring, one block per (batch, class) row.
//
// Replaces the Pallas kernel tdnet/ops/soft_nms.py soft_nms_rescore_batched
// (_soft_nms_kernel). Each row makes up to `iters` greedy picks: the largest
// remaining score, the LOWEST index on ties (the Pallas kernel's min-lane
// reduction, jnp.argmax's order). A pick above the threshold keeps its
// current score; the others are decayed by their exact IoU with it
// (gaussian exp(-iou^2 / sigma), or linear 1 - iou above the IoU
// threshold); a removed box is -inf and is never multiplied (linear decay is
// 0 at IoU 1, and -inf * 0 is NaN). Unpicked boxes get 0.
//
// Bound on the H100 by latency: a row is 1024 candidates (24 KB) and each
// pick is K IoUs plus a block-wide argmax, 300 picks in a dependent chain.
// The TPU kernel vectorised 8 rows on sublanes and extracted the pick with
// one-hot reductions because Mosaic has no dynamic slice; here the row's
// boxes, areas and remaining scores sit in shared memory, the argmax is a
// warp-shuffle reduction then one across warps, and the pick is read back
// by index. The row stops as soon as its best remaining score is at or below
// the threshold (the Pallas kernel stops per tile of 8 rows; the output is
// the same, since scores only decay).
//
// The IoU and the decay follow the reference's operation order with
// explicitly rounded IEEE intrinsics, so nvcc cannot contract a multiply and
// an add into an FMA; the gaussian uses expf (not __expf).
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) becomes the better of itself and (ov, oi): larger value, then lower
// index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                float* __restrict__ out, int k, int iters, int linear,
                float sigma, float iou_thr, float score_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  float* srem = sarea + k;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float top_v;
  __shared__ int top_i;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float4 b = boxes[base + j];
    sbox[j] = b;
    sarea[j] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    const float s = scores[base + j];
    srem[j] = s > score_thr ? s : -INFINITY;
    out[base + j] = 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = 0; t < iters; ++t) {
    // block-wide argmax, lowest index on ties
    float v = -INFINITY;
    int idx = INT_MAX;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      const float r = srem[j];
      if (r > v) {  // j ascends: the first maximum of this thread's share
        v = r;
        idx = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      take_better(v, idx, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, idx, off));
    }
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : -INFINITY;
      idx = lane < kWarps ? warp_i[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        take_better(v, idx, __shfl_down_sync(0xffffffffu, v, off),
                    __shfl_down_sync(0xffffffffu, idx, off));
      }
      if (lane == 0) {
        top_v = v;
        top_i = idx;
      }
    }
    __syncthreads();
    const float top = top_v;
    const int sel = top_i;
    if (!(top > score_thr)) break;  // the same in every thread
    if (threadIdx.x == 0) out[base + sel] = top;

    const float4 bb = sbox[sel];
    const float ba = sarea[sel];
    for (int j = threadIdx.x; j < k; j += kThreads) {
      if (j == sel) {
        srem[j] = -INFINITY;
        continue;
      }
      const float r = srem[j];
      if (r == -INFINITY) continue;
      const float4 b = sbox[j];
      const float iw = fmaxf(__fsub_rn(fminf(b.z, bb.z), fmaxf(b.x, bb.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(b.w, bb.w), fmaxf(b.y, bb.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sarea[j], ba), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      float decay;
      if (linear) {
        decay = iou > iou_thr ? __fsub_rn(1.0f, iou) : 1.0f;
      } else {
        decay = expf(__fdiv_rn(-__fmul_rn(iou, iou), sigma));
      }
      srem[j] = __fmul_rn(r, decay);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes: (rows, k, 4) float32, 16-byte aligned; scores/out: (rows, k) float32.
TDNET_EXPORT int tdnet_soft_nms(const void* boxes, const void* scores, void* out,
                                int rows, int k, int iters, int linear,
                                float sigma, float iou_thr, float score_thr,
                                void* stream) {
  const size_t smem = static_cast<size_t>(k) * (sizeof(float4) + 2 * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      soft_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  soft_nms_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<float*>(out), k, iters, linear, sigma, iou_thr, score_thr);
  return static_cast<int>(cudaGetLastError());
}
