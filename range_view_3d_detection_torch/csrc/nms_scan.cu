// Greedy (weighted) NMS scan (K2) for Hopper, fp32.
//
// Replaces range_view_3d_detection_tpu/kernels/nms_pallas.py::
// nms_scan_pallas (_nms_scan_kernel). Boxes come in descending score
// order with a precomputed (cap, cap) rotated-IoU matrix. For each box i
// still alive, in order: keep it; set its output to the score-weighted
// mean of the payload over the alive boxes j with iou[i, j] >= merge_thr
// (box i weighs at least its own score, so HARD mode's merge_thr 1.01
// leaves it alone); then kill every alive box with iou[i, j] > iou_thr.
// A box that is not alive keeps its own payload and is not kept.
//
// Bound on the H100: the IoU matrix is the only large input, 8.4 MB at
// B=2, cap=1024, read in 2.5 us at 3.35 TB/s. The real limit is the chain
// of cap dependent steps, each of which needs the previous step's alive
// set: a latency chain of block-wide barriers and reductions.
//
// Design. One block per image, one thread per candidate lane (cap/1024
// lanes per thread beyond 1024). alive, scores and the payload live in
// shared memory for the whole scan. A step whose box is dead costs no
// barrier and no reduction. A live step reads its IoU row once, makes the
// 10 fp32 block reductions (wsum and the 9 payload dot products) with
// warp shuffles and one shared-memory pass, and applies the suppression
// after the first barrier so no thread can see box i die before it has
// read that box i is alive. keep depends only on IoU comparisons and
// alive, so it is exact; merged differs from the plain scan only by the
// order of the fp32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 9;            // payload: x, y, z, l, w, h, sin, cos, score
constexpr int kR = kP + 1;       // reductions per live step: wsum + payload
constexpr int kMaxLanes = 32;    // lanes per thread (suppression bitmask)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void nms_scan_kernel(const float* __restrict__ iou,
                                const float* __restrict__ scores,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ payload,
                                uint8_t* __restrict__ keep,
                                float* __restrict__ merged, int cap,
                                float iou_thr, float merge_thr) {
  extern __shared__ float smem[];
  float* alive_s = smem;                 // (cap,) 0/1
  float* score_s = alive_s + cap;        // (cap,)
  float* pay_s = score_s + cap;          // (cap, kP)
  float* red_s = pay_s + (size_t)cap * kP;  // (32, kR) warp partials

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* iou_b = iou + (size_t)b * cap * cap;
  const float* pay_b = payload + (size_t)b * cap * kP;
  uint8_t* keep_b = keep + (size_t)b * cap;
  float* merged_b = merged + (size_t)b * cap * kP;

  for (int j = tid; j < cap; j += nthreads) {
    alive_s[j] = valid[(size_t)b * cap + j] ? 1.f : 0.f;
    score_s[j] = scores[(size_t)b * cap + j];
    keep_b[j] = 0;
  }
  for (int j = tid; j < cap * kP; j += nthreads) pay_s[j] = pay_b[j];
  __syncthreads();

  for (int i = 0; i < cap; ++i) {
    if (alive_s[i] == 0.f) {  // uniform: alive_s[i] last changed before a barrier
      if (tid < kP) merged_b[(size_t)i * kP + tid] = pay_s[i * kP + tid];
      continue;
    }
    const float* row = iou_b + (size_t)i * cap;
    float part[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) part[k] = 0.f;
    uint32_t kill = 0;
    for (int j = tid, l = 0; j < cap; j += nthreads, ++l) {
      const float r = row[j];
      float w = r >= merge_thr ? score_s[j] * alive_s[j] : 0.f;
      if (j == i) w = fmaxf(w, score_s[i]);
      part[0] += w;
#pragma unroll
      for (int k = 0; k < kP; ++k) part[k + 1] += w * pay_s[j * kP + k];
      if (r > iou_thr) kill |= 1u << l;
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) part[k] = warp_sum(part[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kR; ++k) red_s[warp * kR + k] = part[k];
    }
    __syncthreads();  // every thread has read alive_s[i] and alive_s[own]
    for (int j = tid, l = 0; j < cap; j += nthreads, ++l)
      if (kill & (1u << l)) alive_s[j] = 0.f;
    if (warp == 0) {
      float tot[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k)
        tot[k] = warp_sum(lane < nwarps ? red_s[lane * kR + k] : 0.f);
      if (lane == 0) {
        const float wsum = fmaxf(tot[0], 1e-8f);
#pragma unroll
        for (int k = 0; k < kP; ++k)
          merged_b[(size_t)i * kP + k] = tot[k + 1] / wsum;
        keep_b[i] = 1;
      }
    }
    __syncthreads();  // suppression visible; red_s free for the next step
  }
}

}  // namespace

// iou: (B, cap, cap) fp32; scores: (B, cap) fp32; valid: (B, cap) bool
// (one byte each); payload: (B, cap, P) fp32 with P == 9; keep: (B, cap)
// bool out; merged: (B, cap, P) fp32 out. One block per image.
extern "C" int rv3d_nms_scan(const void* iou, const void* scores,
                             const void* valid, const void* payload,
                             void* keep, void* merged, int B, int cap, int P,
                             float iou_thr, float merge_thr, void* stream) {
  if (P != kP || B <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const int threads = cap >= 1024 ? 1024 : ((cap + 31) / 32) * 32;
  if ((cap + threads - 1) / threads > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)cap * (2 + kP) + 32 * kR) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_scan_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const float*)scores, (const uint8_t*)valid,
      (const float*)payload, (uint8_t*)keep, (float*)merged, cap, iou_thr,
      merge_thr);
  return (int)cudaGetLastError();
}
