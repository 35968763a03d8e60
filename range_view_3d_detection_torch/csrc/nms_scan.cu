// Greedy (weighted) NMS scan (K2) for Hopper, fp32, in three launches.
//
// Replaces range_view_3d_detection_tpu/kernels/nms_pallas.py::
// nms_scan_pallas (_nms_scan_kernel). Boxes come in descending score
// order with a precomputed (cap, cap) rotated-IoU matrix. Box i is kept
// when it is valid and no kept box k < i has iou[k, i] > iou_thr. A kept
// box's output is the score-weighted mean of the payload over the boxes j
// alive at step i with iou[i, j] >= merge_thr (box i weighs at least its
// own score, so HARD mode's merge_thr 1.01 leaves it alone). j is alive
// at step i when it is valid and killed_at[j] >= i, killed_at[j] being
// the first kept k with iou[k, j] > iou_thr (cap if none): j is not in
// R_i, the set that ~valid and the kept rows before i have removed. A
// box that is not kept keeps its own payload.
//
// What bounds it on the H100. The IoU matrix is the only large input:
// 8.4 MB at B=2, cap=1024, read once in 2.5 us at 3.35 TB/s. The greedy
// keep is a chain of dependent steps, each needing the set the earlier
// steps removed; at one shared-memory round trip (about 30 cycles) a live
// step, the 742 live steps of the longer flagship image take about 11 us
// (a model of the chain's floor, not a measurement).
// The chain runs through comparisons only; the weighted merge is the only
// arithmetic, and it can run once the chain is known.
//
// Design.
// 1. nms_mask_kernel, over all SMs: one warp per row (b, i) turns
//    iou[b, i, :] > iou_thr into 32-bit words (16-byte loads, four
//    columns a lane, the nibbles OR-ed across eight lanes; a word-wide
//    ballot where cap % 4 != 0): the (B, 32 * W, W) uint32 mask, W =
//    ceil(cap / 32), 256 KB at B=2, cap=1024.
// 2. nms_keep_kernel, one warp per image: the removed set (initially
//    ~valid and the bits past cap) lives in registers, word w in lane
//    w % 32. It walks 32-row slabs of the mask, each copied into shared
//    memory by cp.async kStages - 1 slabs ahead. Within a slab every lane
//    resolves the diagonal word in registers (row r is kept when bit r of
//    the removed word is clear; a kept row ORs its diagonal word in), then
//    ORs the kept rows into every word of the removed set in ascending
//    order. Before a kept row's OR each lane stores its word of the set,
//    so R_i lands in seen[b, i] (one coalesced store a kept row); keep is
//    exact, as it depends on comparisons only. Recording killed_at bit by
//    bit instead (a divergent loop a kept row, every kept box killing
//    itself) made this phase 89 us at B=2, cap=1024 on an H100 80GB HBM3
//    at 700 W; as it is, it takes about 52 us there, five times the chain
//    floor, and the single warp's time is not split further (PERF.md).
//    Past cap 4096 the set no longer fits a warp's registers (4 words a
//    lane), and a slab of full rows no longer fits the ring (kStages x
//    32 x W words: 147 KB at cap 9216, 262 KB at 16384, past the 227 KB a
//    block may hold). nms_keep_big_kernel, four warps an image, keeps the
//    set in shared memory (W words: 1.2 KB at cap 9216, 8 KB at 65,536)
//    and streams each slab in column chunks of at most 256 words, the
//    chunk that holds the slab's diagonal word first: the diagonal decides
//    the slab's kept rows, and the other chunks' words then take the same
//    ORs in any order. Its mask rows are padded to L = W rounded up to 4
//    words, so every chunk row starts on a 16-byte boundary.
// 3. nms_merge_kernel, over all SMs: one warp per row. A kept row reads
//    its IoU row (16-byte loads where cap % 4 == 0) and its R_i once and
//    forms the 10 fp32 sums of w_ij (wsum and the 9 payload dot
//    products); a row that is not kept copies its payload. merged differs
//    from the plain scan only by the order of the fp32 sums. The box
//    payload (P = 9) has its own instance; any other P >= 1 runs the same
//    loop in passes over groups of kPass payload columns, each pass
//    reading the IoU row again and forming wsum and kPass sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 9;             // payload: x, y, z, l, w, h, sin, cos, score
constexpr int kPass = 8;          // payload columns a pass of the any-P merge
constexpr int kRegCap = 4096;     // the register keep warp's largest cap
constexpr int kMaxWordsPerLane = kRegCap / 32 / 32;  // removed-set words a lane
constexpr int kStages = 4;        // mask slabs in flight in phase 2
constexpr int kRowsPerBlock = 8;  // phases 1 and 3: one warp per row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBigThreads = 128;  // the shared-memory keep: four warps an image
constexpr int kChunkWords = 256;  // its slab chunks' largest width in words
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Phase 1: mask[b, i, w] bit t = iou[b, i, 32 w + t] > iou_thr; rows of
// ld >= nwords words.
template <bool kVec>
__global__ void nms_mask_kernel(const float* __restrict__ iou,
                                uint32_t* __restrict__ mask, int rows,
                                int cap, int nwords, int ld, float iou_thr) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp
  const int b = row / cap;
  const int i = row - b * cap;
  const float* src = iou + (size_t)row * cap;
  uint32_t* dst = mask + ((size_t)b * 32 * nwords + i) * ld;
  if (kVec) {
    // 128 columns an iteration; cap % 4 == 0, so a float4 is all in or out.
#pragma unroll 4
    for (int c0 = 0; c0 < cap; c0 += 128) {
      const int col = c0 + 4 * lane;
      uint32_t nib = 0;
      if (col < cap) {
        const float4 v = *reinterpret_cast<const float4*>(src + col);
        nib = (uint32_t)(v.x > iou_thr) | ((uint32_t)(v.y > iou_thr) << 1) |
              ((uint32_t)(v.z > iou_thr) << 2) | ((uint32_t)(v.w > iou_thr) << 3);
      }
      uint32_t word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      const int w = (c0 >> 5) + (lane >> 3);
      if ((lane & 7) == 0 && w < nwords) dst[w] = word;
    }
  } else {
    for (int w = 0; w < nwords; ++w) {
      const int col = 32 * w + lane;
      const uint32_t word = __ballot_sync(kFull, col < cap && src[col] > iou_thr);
      if (lane == 0) dst[w] = word;
    }
  }
}

// Phase 2: the greedy keep of one image, one warp.
__global__ void __launch_bounds__(32)
    nms_keep_kernel(const uint32_t* __restrict__ mask,
                    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                    uint32_t* __restrict__ seen, int cap, int nwords) {
  extern __shared__ __align__(16) uint32_t slab_s[];  // kStages x (32, nwords)
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int slab_words = 32 * nwords;
  const uint32_t* mask_b = mask + (size_t)b * slab_words * nwords;
  const uint8_t* valid_b = valid + (size_t)b * cap;
  uint8_t* keep_b = keep + (size_t)b * cap;
  uint32_t* seen_b = seen + (size_t)b * cap * nwords;

  auto prefetch = [&](int s) {
    if (s < nwords) {
      const uint32_t* src = mask_b + (size_t)s * slab_words;
      uint32_t* dst = slab_s + (s % kStages) * slab_words;
      for (int c = 4 * lane; c < slab_words; c += 4 * 32) cp_async16(dst + c, src + c);
    }
    cp_async_commit();  // an empty group keeps the group count uniform
  };
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // Removed set: ~valid, and every bit past cap (rows past cap never keep);
  // word w = 32 k + l is rem[k] of lane l.
  uint32_t rem[kMaxWordsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxWordsPerLane; ++k) {
    rem[k] = kFull;
    if (32 * k >= nwords) continue;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const int j = 32 * (32 * k + l) + lane;
      const uint32_t dead = __ballot_sync(kFull, j >= cap || valid_b[j] == 0);
      if (lane == l) rem[k] = dead;
    }
  }

  for (int s = 0; s < nwords; ++s) {
    prefetch(s + kStages - 1);  // refills the buffer slab s - 1 left
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of slab s are in
    const uint32_t* slab = slab_s + (s % kStages) * slab_words;
    uint32_t diag = 0;
#pragma unroll
    for (int k = 0; k < kMaxWordsPerLane; ++k)
      if (k == (s >> 5)) diag = rem[k];
    diag = __shfl_sync(kFull, diag, s & 31);
    uint32_t kept = 0;
    if (diag != kFull) {
      // The slab's diagonal words, then the greedy chain in registers:
      // row r is kept when bit r is clear, and then ORs in its word.
      uint32_t d[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) d[r] = slab[r * nwords + s];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const uint32_t live = ~diag & (1u << r);
        kept |= live;
        diag |= live ? d[r] : 0u;
      }
      // The kept rows, in ascending order, into every word of the set;
      // each first leaves the set it saw in seen. The words are loaded
      // before the chain, which then runs in registers.
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int w = lane + 32 * k;
        if (w < nwords) {
          uint32_t m[32];
#pragma unroll
          for (int r = 0; r < 32; ++r) m[r] = slab[r * nwords + w];
          uint32_t r_k = rem[k];
          uint32_t* seen_w = seen_b + (size_t)32 * s * nwords + w;
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const bool take = (kept >> r) & 1u;  // the same in every lane
            if (take) seen_w[(size_t)r * nwords] = r_k;
            r_k |= take ? m[r] : 0u;
          }
          rem[k] = r_k;
        }
      }
    }
    const int row = 32 * s + lane;
    if (row < cap) keep_b[row] = (uint8_t)((kept >> lane) & 1u);
    __syncwarp();  // slab s read by every lane before its buffer is refilled
  }
  cp_async_wait<0>();
}

// Phase 2 past cap 4096: the removed set in shared memory, each 32-row
// slab in nchunks column chunks of cw words (the diagonal's chunk first),
// kBigThreads threads an image, word w of a chunk to thread w % 128.
__global__ void __launch_bounds__(kBigThreads)
    nms_keep_big_kernel(const uint32_t* __restrict__ mask,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, uint32_t* __restrict__ seen,
                        int cap, int nwords, int ld, int cw, int nchunks) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                          // kStages x (32, cw)
  uint32_t* rem = smem + (size_t)kStages * 32 * cw;  // nwords
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t* mask_b = mask + (size_t)b * 32 * nwords * ld;
  const uint8_t* valid_b = valid + (size_t)b * cap;
  uint8_t* keep_b = keep + (size_t)b * cap;
  uint32_t* seen_b = seen + (size_t)b * cap * nwords;
  const int steps = nwords * nchunks;  // step t: slab t / nchunks, its chunk j
  auto chunk_of = [&](int t) {
    const int s = t / nchunks;
    return (s / cw + t - s * nchunks) % nchunks;
  };

  auto prefetch = [&](int t) {
    if (t < steps) {
      const int s = t / nchunks;
      const int w0 = chunk_of(t) * cw;
      const int q4 = min(cw, ld - w0) / 4;  // 16-byte pieces a row
      const uint32_t* src = mask_b + (size_t)32 * s * ld + w0;
      uint32_t* dst = ring + (size_t)(t % kStages) * 32 * cw;
      for (int q = tid; q < 32 * q4; q += kBigThreads) {
        const int r = q / q4;
        const int c4 = 4 * (q - r * q4);
        cp_async16(dst + r * cw + c4, src + (size_t)r * ld + c4);
      }
    }
    cp_async_commit();  // an empty group keeps the group count uniform
  };

  // Removed set: ~valid, and every bit past cap.
  for (int w = tid >> 5; w < nwords; w += kBigThreads / 32) {
    const int j = 32 * w + lane;
    const uint32_t dead = __ballot_sync(kFull, j >= cap || valid_b[j] == 0);
    if (lane == 0) rem[w] = dead;
  }
  for (int t = 0; t < kStages - 1; ++t) prefetch(t);

  uint32_t kept = 0;
  for (int t = 0; t < steps; ++t) {
    const int s = t / nchunks;
    const int j = t - s * nchunks;
    const int c = chunk_of(t);
    prefetch(t + kStages - 1);  // refills the buffer step t - 1 left
    cp_async_wait<kStages - 1>();
    __syncthreads();  // every thread's copies of step t are in; rem is current
    const uint32_t* chunk = ring + (size_t)(t % kStages) * 32 * cw;
    if (j == 0) {
      // The diagonal's chunk: the greedy chain over the slab's 32 rows.
      uint32_t diag = rem[s];
      kept = 0;
      if (diag != kFull) {
        const int col = s - c * cw;
        uint32_t d[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) d[r] = chunk[r * cw + col];
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const uint32_t live = ~diag & (1u << r);
          kept |= live;
          diag |= live ? d[r] : 0u;
        }
      }
      __syncthreads();  // rem[s] read by every thread before its owner ORs
    }
    if (kept) {
      // The kept rows, in ascending order, into this chunk's words of the
      // set; each first leaves the set it saw in seen.
      const int w0 = c * cw;
      const int width = min(cw, nwords - w0);
      for (int k = tid; k < width; k += kBigThreads) {
        const int w = w0 + k;
        uint32_t m[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) m[r] = chunk[r * cw + k];
        uint32_t r_k = rem[w];
        uint32_t* seen_w = seen_b + (size_t)32 * s * nwords + w;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const bool take = (kept >> r) & 1u;  // the same in every thread
          if (take) seen_w[(size_t)r * nwords] = r_k;
          r_k |= take ? m[r] : 0u;
        }
        rem[w] = r_k;
      }
    }
    if (j == nchunks - 1 && tid < 32) {
      const int row = 32 * s + tid;
      if (row < cap) keep_b[row] = (uint8_t)((kept >> tid) & 1u);
    }
    __syncthreads();  // step t's buffer read before it is refilled
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Phase 3: the weighted merge of each kept row; other rows copy.
// acc[0] += w, acc[1 + k] += w * payload[j, c0 + k] for the kCols columns
// from c0 that lie below P.
template <int kCols>
__device__ __forceinline__ void merge_term(float w, int j, const float* pay_b, int P,
                                           int c0, float* acc) {
  if (w != 0.f) {
    acc[0] += w;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c0 + k < P) acc[k + 1] += w * pay_b[(size_t)j * P + c0 + k];
  }
}

// kFixedP: the payload width when it is known here (9, the box payload),
// else 0 and the runtime P, merged in passes of kPass columns.
template <bool kVec, int kFixedP>
__global__ void nms_merge_kernel(const float* __restrict__ iou,
                                 const float* __restrict__ scores,
                                 const float* __restrict__ payload,
                                 const uint8_t* __restrict__ keep,
                                 const uint32_t* __restrict__ seen,
                                 float* __restrict__ merged, int rows, int cap,
                                 int nwords, int runtime_p, float merge_thr) {
  constexpr int kCols = kFixedP > 0 ? kFixedP : kPass;
  const int P = kFixedP > 0 ? kFixedP : runtime_p;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp
  const int b = row / cap;
  const int i = row - b * cap;
  const float* pay_b = payload + (size_t)b * cap * P;
  float* out = merged + (size_t)row * P;
  if (!keep[row]) {
    for (int k = lane; k < P; k += 32) out[k] = pay_b[(size_t)i * P + k];
    return;
  }
  const float* iou_row = iou + (size_t)row * cap;
  const float* score_b = scores + (size_t)b * cap;
  const uint32_t* removed = seen + (size_t)row * nwords;  // R_i
  const float self = score_b[i];
  for (int c0 = 0; c0 < P; c0 += kCols) {
    float acc[kCols + 1];
#pragma unroll
    for (int k = 0; k <= kCols; ++k) acc[k] = 0.f;
    if (kVec) {
      // Four columns a lane, 128 a warp; cap % 4 == 0.
      for (int j0 = 4 * lane; j0 < cap; j0 += 128) {
        const float4 v = *reinterpret_cast<const float4*>(iou_row + j0);
        const float4 sc = *reinterpret_cast<const float4*>(score_b + j0);
        const uint32_t dead = removed[j0 >> 5] >> (j0 & 31);
        const float vq[4] = {v.x, v.y, v.z, v.w};
        const float sq[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w = (!((dead >> q) & 1u) && vq[q] >= merge_thr) ? sq[q] : 0.f;
          if (j0 + q == i) w = fmaxf(w, self);
          merge_term<kCols>(w, j0 + q, pay_b, P, c0, acc);
        }
      }
    } else {
      for (int j = lane; j < cap; j += 32) {
        const bool alive = !((removed[j >> 5] >> lane) & 1u);
        float w = (alive && iou_row[j] >= merge_thr) ? score_b[j] : 0.f;
        if (j == i) w = fmaxf(w, self);
        merge_term<kCols>(w, j, pay_b, P, c0, acc);
      }
    }
#pragma unroll
    for (int k = 0; k <= kCols; ++k) acc[k] = warp_sum(acc[k]);
    const float wsum = fmaxf(acc[0], 1e-8f);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (lane == k && c0 + k < P) out[c0 + k] = acc[k + 1] / wsum;
  }
}

}  // namespace

// iou: (B, cap, cap) fp32; scores: (B, cap) fp32; valid: (B, cap) bool
// (one byte each); payload: (B, cap, P) fp32, any P >= 1; keep: (B, cap)
// bool out; merged: (B, cap, P) fp32 out; mask: (B, 32 W, L) and seen:
// (B, cap, W) uint32 scratch, W = ceil(cap / 32); the caller sizes the
// mask's rows, ld words each, and this checks them: ld = W for the
// register keep (big_keep == 0, cap <= 4096: it reads rows of W words), a
// multiple of 4 at least W for the shared-memory keep (big_keep != 0: it
// copies 16-byte pieces). p9_merge != 0 runs the merge's P = 9 instance
// (P must be 9), else the any-P one. The caller's plan
// (kernels/nms.py::k2_plan) sets both. Any cap whose scratch fits. Three
// launches on `stream`; returns the cudaError_t of the first that fails.
extern "C" int rv3d_nms_scan(const void* iou, const void* scores,
                             const void* valid, const void* payload,
                             void* keep, void* merged, void* mask, void* seen,
                             int B, int cap, int ld, int P, int big_keep,
                             int p9_merge, float iou_thr, float merge_thr,
                             void* stream) {
  const bool big = big_keep != 0;
  if (P <= 0 || B <= 0 || cap <= 0 || (!big && cap > kRegCap) || (p9_merge && P != kP))
    return (int)cudaErrorInvalidValue;
  const int nwords = (cap + 31) / 32;
  if (big ? (ld < nwords || ld % 4 != 0) : ld != nwords)
    return (int)cudaErrorInvalidValue;
  // The big keep's chunks: at most kChunkWords words, each a multiple of 4.
  int nchunks = (ld + kChunkWords - 1) / kChunkWords;
  const int cw = ((ld + nchunks - 1) / nchunks + 3) / 4 * 4;
  nchunks = (ld + cw - 1) / cw;
  const size_t smem = big ? ((size_t)kStages * 32 * cw + nwords) * sizeof(uint32_t)
                          : (size_t)kStages * 32 * nwords * sizeof(uint32_t);
  if (smem > kMaxSmem || (size_t)B * cap > (size_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int rows = B * cap;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = cap % 4 == 0 && ((uintptr_t)iou & 15) == 0 &&
                   ((uintptr_t)scores & 15) == 0;
  if (vec) {
    nms_mask_kernel<true><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        (const float*)iou, (uint32_t*)mask, rows, cap, nwords, ld, iou_thr);
  } else {
    nms_mask_kernel<false><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        (const float*)iou, (uint32_t*)mask, rows, cap, nwords, ld, iou_thr);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (big) {
    if (smem > 48 * 1024) {  // set on every call: the attribute is per device
      e = cudaFuncSetAttribute(nms_keep_big_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    nms_keep_big_kernel<<<B, kBigThreads, smem, st>>>(
        (const uint32_t*)mask, (const uint8_t*)valid, (uint8_t*)keep,
        (uint32_t*)seen, cap, nwords, ld, cw, nchunks);
  } else {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(nms_keep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    nms_keep_kernel<<<B, 32, smem, st>>>((const uint32_t*)mask, (const uint8_t*)valid,
                                         (uint8_t*)keep, (uint32_t*)seen, cap, nwords);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto merge = p9_merge ? (vec ? nms_merge_kernel<true, kP> : nms_merge_kernel<false, kP>)
                       : (vec ? nms_merge_kernel<true, 0> : nms_merge_kernel<false, 0>);
  merge<<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      (const float*)iou, (const float*)scores, (const float*)payload,
      (const uint8_t*)keep, (const uint32_t*)seen, (float*)merged, rows, cap,
      nwords, P, merge_thr);
  return (int)cudaGetLastError();
}
