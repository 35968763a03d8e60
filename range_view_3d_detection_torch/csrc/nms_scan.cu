// Greedy (weighted) NMS scan (K2) for Hopper, fp32: three launches up to
// cap 4096, four past it (and a memset of the non-finite counts).
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
// 8.4 MB at B=2, cap=1024, read once in 2.5 us at 3.35 TB/s; 679.5 MB at
// B=2, cap=9216, 0.203 ms. The greedy keep is a chain of dependent steps,
// each needing the set the earlier steps removed; at one shared-memory
// round trip (about 30 cycles) a live step, the 742 live steps of the
// longer flagship image take about 11 us, the 2,950 of the longer image
// of chip_smoke's cap-9216 case about 45 us (a model of the chain's
// floor, not a measurement). The chain runs through comparisons only; the
// weighted merge is the only arithmetic, and it can run once the chain is
// known.
//
// Design.
// 1. nms_mask_kernel, over all SMs: one warp per row (b, i) turns
//    iou[b, i, :] > iou_thr into 32-bit words (16-byte loads, four
//    columns a lane, the nibbles OR-ed across eight lanes; a word-wide
//    ballot where cap % 4 != 0): the (B, 32 * W, L) uint32 mask, W =
//    ceil(cap / 32) words a row in rows of L words, 256 KB at B=2,
//    cap=1024.
// 2. Up to cap 4096, nms_keep_kernel, one warp per image: the removed set
//    (initially ~valid and the bits past cap) lives in registers, word w
//    in lane w % 32. It walks 32-row slabs of the mask, each copied into
//    shared memory by cp.async kStages - 1 slabs ahead. Within a slab
//    every lane resolves the diagonal word in registers (row r is kept
//    when bit r of the removed word is clear; a kept row ORs its diagonal
//    word in), then ORs the kept rows into every word of the removed set
//    in ascending order. Before a kept row's OR each lane stores its word
//    of the set, so R_i lands in seen[b, i] (one coalesced store a kept
//    row); keep is exact, as it depends on comparisons only. Recording
//    killed_at bit by bit instead (a divergent loop a kept row, every kept
//    box killing itself) made this phase 89 us at B=2, cap=1024 on an H100
//    80GB HBM3 at 700 W; as it is, it takes about 52 us there, five times
//    the chain floor, and the single warp's time is not split further
//    (PERF.md).
//    Past cap 4096 the set no longer fits a warp's registers (4 words a
//    lane) and a slab of whole rows no longer fits the ring, so
//    nms_keep_ahead_kernel keeps it, one block of ten warps an image. The
//    chain of slab s needs one word of the set, word s, and only the kept
//    rows of slabs before s - 1 in it, so the chain runs off the block
//    barrier and ahead of the rest of the work:
//    - warp 1's lane 0 streams the upper triangle of the image's mask by
//      TMA: for slab s, row words from s rounded down to 4 up to W, in
//      boxes of 32 rows x 256 words (TMA's widest; zeros past W, so the
//      offsets are constants), through a ring of `stages` stages with
//      full and empty mbarriers. At cap 9216 that is 320 boxes and 5.33 MB
//      an image, where the shared-memory keep before it read the whole
//      10.6 MB.
//    - warp 0 runs the chain. Lane r reads its row's words s and s + 1
//      (mask[32 s + r][s], mask[32 s + r][s + 1]) from L2 two slabs ahead,
//      not from the ring, whose boxes it would wait for (10% of the keep
//      on an H100: PERF.md), and stages the diagonal words for every lane in
//      shared memory a slab ahead. For slab s it waits for ready[s] (word
//      s holds every kept row of slab s - 2 and before), ORs in slab s -
//      1's own kept rows (one redux.sync.or over the lanes' words s), runs
//      the 32-step chain in registers, stores keep and hands the slab's
//      kept bits to the updaters through a ring of 16 words, with an
//      mbarrier arrive. It waits for no thread but the owner of word s.
//    - warps 2-9, the updaters: thread u owns words w = u (mod 256) of
//      the set, in shared memory. Each decided slab t, in order, it ORs
//      the kept rows' words into its words w >= t + 2 (words up to t + 1
//      are final or the chain's), box by box in ascending order, so word
//      t + 2, the one the chain needs soonest, comes first; its owner then
//      sets ready[t + 2]. A thread takes at most one word a box (32
//      independent predicated loads): no second pass. Each warp releases a
//      box with one arrive. No role divides: stages and phases advance
//      with the slabs (SlabBoxes).
//    Shared memory: stages x 32 KB of ring, the set (W x 4 bytes), ready
//    (W bytes), the kept-bits ring, the chain's staged diagonal (256
//    bytes) and the barriers, within the 227 KB a block holds: stages =
//    min(8, what fits), at least 2 (7 at cap 9216, 226.97 KB in all; the
//    set and ready take 1.4 KB there; 6 at cap 16384). Any cap whose IoU
//    matrix the card holds fits (W up to 33,000 words). The keep also
//    sets killed_at to cap.
// 3. Past cap 4096, nms_killed_at_kernel, over all SMs: killed_at[b, j]
//    for valid j, the first kept row whose mask bit j is set (cap if
//    none). A thread takes one word column and a slab (kKillRows = 32
//    rows): it reads the slab's keep bytes, then the kept rows' words at
//    once (32 independent predicated loads; a warp's 32 columns are 128
//    bytes of a row), and lowers killed_at with atomicMin at the slab's
//    first kept row that sets each bit. It reads only kept rows: about a
//    third of the 21.2 MB mask at B=2, cap 9216. killed_at is (B, cap)
//    int32, where the register keep's seen is (B, cap, W) uint32 (21.2 MB
//    there).
// 4. nms_merge_kernel, over all SMs: one warp per row. A kept row reads
//    its IoU row (16-byte loads where cap % 4 == 0) and R_i once: up to cap
//    4096 its seen words and the scores; past it, only for the columns
//    whose IoU merges, valid, killed_at and the score (j alive at step i:
//    valid[j] && killed_at[j] >= i). It forms the 10 fp32 sums of w_ij
//    (wsum and the 9 payload dot products); a row that is not kept copies
//    its payload. merged differs from the plain scan only by the order of
//    the fp32 sums. The box payload (P = 9) has its own instance; any
//    other P >= 1 runs the same loop in passes over groups of kPass
//    payload columns, each pass reading the IoU row again and forming
//    wsum and kPass sums.
//    Non-finite payloads (a model a step from random weights decodes
//    infinite box sizes). The reference's merge is a dot product over all
//    cap boxes, so a box of weight 0 with an infinite or NaN value makes
//    the column NaN (0 x inf); the merge here skips weight-0 boxes. So
//    phase 1 also counts each image's non-finite payload values by column
//    (nonfinite, (B, P) int32, zeroed first), the merge counts those among
//    its own terms, and a column with fewer is NaN; its own terms give
//    the reference's infinity or NaN as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kP = 9;             // payload: x, y, z, l, w, h, sin, cos, score
constexpr int kPass = 8;          // payload columns a pass of the any-P merge
constexpr int kRegCap = 4096;     // the register keep warp's largest cap
constexpr int kMaxWordsPerLane = kRegCap / 32 / 32;  // removed-set words a lane
constexpr int kStages = 4;        // mask slabs in flight in phase 2
constexpr int kRowsPerBlock = 8;  // phases 1 and 4: one warp per row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAheadWarps = 10;   // the keep past cap 4096: chain, producer, updaters
constexpr int kAheadThreads = 32 * kAheadWarps;
constexpr int kUpdaterBase = 64;  // its first updater thread
constexpr int kUpdaters = kAheadThreads - kUpdaterBase;  // 256: word w to thread w % 256
constexpr int kBoxWords = 256;    // the keep's TMA boxes: 32 rows x 256 words (TMA's widest)
constexpr int kMaxAheadStages = 8;  // its ring's deepest
// The kept bits' ring, from the chain to the updaters. The chain leads the
// slowest updater warp by at most stages + 2 slabs (it waits for word s,
// whose owner needs slab s - 2's first box, which the ring loads only once
// every warp has released the box `stages` before it), so 16 slots never
// let a barrier's phase come round twice under a waiting warp.
constexpr int kKeptSlots = 16;
constexpr int kKillRows = 32;     // phase 3: rows a thread (a slab)
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
// ld >= nwords words. Also nonfinite[b, c] += 1 for each non-finite
// payload[b, i, c] (rare: an atomic each).
template <bool kVec>
__global__ void nms_mask_kernel(const float* __restrict__ iou,
                                uint32_t* __restrict__ mask, int rows,
                                int cap, int nwords, int ld, float iou_thr,
                                const float* __restrict__ payload, int P,
                                int* __restrict__ nonfinite) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp
  const int b = row / cap;
  const int i = row - b * cap;
  // Loaded now, tested after the row's words: its latency hides behind them.
  const float pv = lane < P ? payload[(size_t)row * P + lane] : 0.f;
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
  if (!isfinite(pv)) atomicAdd(&nonfinite[b * P + lane], 1);
  for (int k = lane + 32; k < P; k += 32)
    if (!isfinite(payload[(size_t)row * P + k])) atomicAdd(&nonfinite[b * P + k], 1);
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

// Spins until *flag is set; like mbar_wait, a wait of more than 2^32
// cycles (about 2 s) traps, so a fault is a launch failure, not a hang.
__device__ __forceinline__ void wait_flag(const volatile uint8_t* flag) {
  long long t0 = -1;
  while (*flag == 0) {
    if (t0 < 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}

// The ring's boxes slab by slab: slab s's words from s rounded down to 4
// (16-byte reads) up to W, kBoxWords a box; its first box's stage and
// phase parity, kept without a division as s advances.
struct SlabBoxes {
  int nb;    // boxes of slab s
  int rest;  // W - (s rounded down to 4)
  int st;    // its first box's stage
  int ph;    // and the parity of that stage's phase
  __device__ explicit SlabBoxes(int nwords)
      : nb((nwords + kBoxWords - 1) / kBoxWords), rest(nwords), st(0), ph(0) {}
  // From slab s to slab s + 1.
  __device__ void next(int s, int stages) {
    st += nb;
    while (st >= stages) {
      st -= stages;
      ph ^= 1;
    }
    if (((s + 1) & 3) == 0) {
      rest -= 4;
      if (rest <= (nb - 1) * kBoxWords) --nb;
    }
  }
};

// Phase 2 past cap 4096: the chain warp ahead of the updater warps, the
// mask's upper triangle by TMA for the updaters (`map`: B x 32 W rows of W
// words, rows ld words apart; boxes of 32 rows x kBoxWords words), the
// chain's two words a row from `mask` itself; killed_at set to cap.
__global__ void __launch_bounds__(kAheadThreads, 1)
    nms_keep_ahead_kernel(const __grid_constant__ CUtensorMap map,
                          const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                          int* __restrict__ killed_at, const uint32_t* __restrict__ mask,
                          int cap, int nwords, int ld, int stages) {
  constexpr int kBox = 32 * kBoxWords;  // a stage's words
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);  // stages x (32, kBoxWords)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * kBox);
  uint64_t* empty = full + stages;
  uint64_t* decided = empty + stages;                  // kKeptSlots
  uint32_t* kept_q = reinterpret_cast<uint32_t*>(decided + kKeptSlots);
  uint32_t* diag_s = kept_q + kKeptSlots;              // the chain's 2 x 32 diagonal words
  uint32_t* rem = diag_s + 64;                         // the removed set, nwords
  volatile uint8_t* ready = reinterpret_cast<volatile uint8_t*>(rem + nwords);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint8_t* valid_b = valid + (size_t)b * cap;

  // killed_at starts at cap (phase 3 lowers it); the removed set at ~valid
  // and the bits past cap; word w is ready once slab w - 2 is in it (words
  // 0 and 1 at once: slab s - 1's rows the chain ORs in itself).
  for (int j = tid; j < cap; j += kAheadThreads) killed_at[(size_t)b * cap + j] = cap;
  for (int w = warp; w < nwords; w += kAheadWarps) {
    const int j = 32 * w + lane;
    const uint32_t dead = __ballot_sync(kFull, j >= cap || valid_b[j] == 0);
    if (lane == 0) {
      rem[w] = dead;
      ready[w] = w < 2;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive, and the TMA's bytes
      mbar_init(&empty[s], kUpdaters / 32);  // each updater warp
    }
    for (int q = 0; q < kKeptSlots; ++q) mbar_init(&decided[q], 1);  // the chain
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  SlabBoxes slab(nwords);
  if (warp == 1) {
    // The producer: every box of the upper triangle, in slab order.
    if (lane == 0) {
      int issued = 0;
      for (int s = 0; s < nwords; slab.next(s, stages), ++s) {
        int st = slab.st, ph = slab.ph;
        for (int k = 0; k < slab.nb; ++k, ++issued) {
          if (issued >= stages) mbar_wait(&empty[st], ph ^ 1);
          mbar_arrive_tx(&full[st], kBox * 4);
          tma_load_2d(ring + (size_t)st * kBox, &map, &full[st], (s & ~3) + k * kBoxWords,
                      (b * nwords + s) * 32);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else if (warp == 0) {
    // The chain warp.
    uint8_t* keep_b = keep + (size_t)b * cap;
    uint32_t fold = 0;  // slab s - 1's kept rows in word s
    // Lane r's words s and s + 1 of row 32 s + r, read from L2 (the mask
    // kernel has just written them) two slabs ahead: the chain waits for
    // no box of the ring.
    const uint32_t* row_r = mask + ((size_t)b * 32 * nwords + lane) * ld;
    auto words_of = [&](int s, uint32_t& diag_word, uint32_t& next_word) {
      if (s < nwords) {
        const uint32_t* w = row_r + (size_t)32 * s * ld + s;
        diag_word = w[0];
        next_word = s + 1 < nwords ? w[1] : 0u;
      }
    };
    uint32_t d1 = 0, n1 = 0, d2 = 0, n2 = 0;  // slabs s + 1 and s + 2
    words_of(0, d1, n1);
    words_of(1, d2, n2);
    diag_s[lane] = d1;
    __syncwarp();
    for (int s = 0; s < nwords; ++s) {
      // Slab s's diagonal words d[r] = mask[32 s + r][s] in every lane, from
      // diag_s (eight 16-byte broadcast loads: the keep 6% faster than with
      // 32 shuffles on an H100, PERF.md), and lane r's next = mask[32 s +
      // r][s + 1]; slab s + 1's words into the other half of diag_s, slab
      // s + 2's loads.
      const uint32_t next = n1;
      uint32_t d[32];
      const uint4* dq = reinterpret_cast<const uint4*>(diag_s + 32 * (s & 1));
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint4 q = dq[k];
        d[4 * k] = q.x;
        d[4 * k + 1] = q.y;
        d[4 * k + 2] = q.z;
        d[4 * k + 3] = q.w;
      }
      d1 = d2;
      n1 = n2;
      words_of(s + 2, d2, n2);
      diag_s[32 * ((s + 1) & 1) + lane] = d1;  // loaded a slab ago
      __syncwarp();
      // Word s from the updaters: every kept row of slab s - 2 and before.
      wait_flag(ready + s);
      __threadfence_block();
      uint32_t diag = *reinterpret_cast<volatile uint32_t*>(rem + s) | fold;
      // The greedy chain over the slab's 32 rows, in registers.
      uint32_t kept = 0;
      if (diag != kFull) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const uint32_t live = ~diag & (1u << r);
          kept |= live;
          diag |= live ? d[r] : 0u;
        }
      }
      // Publish the slab's kept rows to the updaters.
      if (lane == 0) {
        kept_q[s % kKeptSlots] = kept;
        mbar_arrive(&decided[s % kKeptSlots]);
      }
      // Slab s's own rows into word s + 1, for the next slab.
      fold = __reduce_or_sync(kFull, (kept >> lane) & 1u ? next : 0u);
      const int row = 32 * s + lane;
      if (row < cap) keep_b[row] = (uint8_t)((kept >> lane) & 1u);
    }
  } else {
    // The updaters: thread u owns words w = u (mod kUpdaters).
    const int u = tid - kUpdaterBase;
    for (int t = 0; t < nwords; slab.next(t, stages), ++t) {
      // The kept bits of slab t.
      mbar_wait(&decided[t % kKeptSlots], (t / kKeptSlots) & 1);
      const uint32_t kept = kept_q[t % kKeptSlots];
      int st = slab.st, ph = slab.ph;
      for (int k = 0; k < slab.nb; ++k) {
        // Box k of slab t: its words base .. base + kBoxWords - 1, one of
        // them this thread's.
        const int base = (t & ~3) + k * kBoxWords;
        const int w = base + ((u - base) & (kUpdaters - 1));
        mbar_wait(&full[st], ph);
        if (w - base < kBoxWords && w >= t + 2 && w < nwords) {
          const uint32_t* col = ring + (size_t)st * kBox + (w - base);
          uint32_t acc = 0;
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const uint32_t x = col[r * kBoxWords];  // every row's: no load waits on a branch
            acc |= (kept >> r) & 1u ? x : 0u;
          }
          rem[w] |= acc;
          if (w == t + 2) {  // its last slab: word w is final for the chain
            __threadfence_block();
            ready[w] = 1;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);  // box read by the warp
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  }
}

// Phase 3 past cap 4096: for word w and slab c (rows 32 c .. 32 c + 31),
// killed_at[b, j] = min(killed_at[b, j], the slab's first kept row whose
// word w holds bit j), for valid j in word w.
__global__ void __launch_bounds__(128)
    nms_killed_at_kernel(const uint32_t* __restrict__ mask,
                         const uint8_t* __restrict__ valid,
                         const uint8_t* __restrict__ keep, int* __restrict__ killed_at,
                         int cap, int nwords, int ld) {
  const int w = blockIdx.x * 128 + threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kKillRows;
  const uint8_t* keep_b = keep + (size_t)b * cap + i0;
  uint32_t kept = 0;  // the same in every thread of the block
#pragma unroll
  for (int r = 0; r < kKillRows; ++r)
    if (i0 + r < cap && keep_b[r]) kept |= 1u << r;
  if (w >= nwords || kept == 0) return;
  const uint32_t* col = mask + ((size_t)b * 32 * nwords + i0) * ld + w;
  uint32_t m[kKillRows];
#pragma unroll
  for (int r = 0; r < kKillRows; ++r) m[r] = (kept >> r) & 1u ? col[(size_t)r * ld] : 0u;
  const uint8_t* valid_b = valid + (size_t)b * cap;
  int* out = killed_at + (size_t)b * cap;
  uint32_t found = 0;
#pragma unroll
  for (int r = 0; r < kKillRows; ++r) {
    for (uint32_t fresh = m[r] & ~found; fresh; fresh &= fresh - 1) {
      const int j = 32 * w + __ffs(fresh) - 1;
      if (valid_b[j]) atomicMin(out + j, i0 + r);  // bits past cap are never set
    }
    found |= m[r];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Phase 4: the weighted merge of each kept row; other rows copy.
// acc[0] += w, acc[1 + k] += w * payload[j, c0 + k] for the kCols columns
// from c0 that lie below P, and nf[k] += 1 where that value is not finite.
template <int kCols>
__device__ __forceinline__ void merge_term(float w, int j, const float* pay_b, int P,
                                           int c0, float* acc, int* nf) {
  if (w != 0.f) {
    acc[0] += w;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c0 + k < P) {
        const float x = pay_b[(size_t)j * P + c0 + k];
        acc[k + 1] += w * x;
        nf[k] += !isfinite(x);
      }
  }
}

// kFixedP: the payload width when it is known here (9, the box payload),
// else 0 and the runtime P, merged in passes of kPass columns. kKilled:
// the removed set R_i as valid and killed_at (B, cap) past cap 4096, else
// as the seen words (B, cap, W).
template <bool kVec, int kFixedP, bool kKilled>
__global__ void nms_merge_kernel(const float* __restrict__ iou,
                                 const float* __restrict__ scores,
                                 const float* __restrict__ payload,
                                 const uint8_t* __restrict__ keep,
                                 const uint8_t* __restrict__ valid,
                                 const uint32_t* __restrict__ removed_set,
                                 const int* __restrict__ nonfinite,
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
  const uint32_t* removed = removed_set + (kKilled ? 0 : (size_t)row * nwords);  // R_i
  const int* killed_b = reinterpret_cast<const int*>(removed_set) + (size_t)b * cap;
  const uint8_t* valid_b = valid + (size_t)b * cap;
  const float self = score_b[i];
  for (int c0 = 0; c0 < P; c0 += kCols) {
    float acc[kCols + 1];
    int nf[kCols];
#pragma unroll
    for (int k = 0; k <= kCols; ++k) acc[k] = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) nf[k] = 0;
    if (kVec && kKilled) {
      // Four columns a lane, 128 a warp, four such chunks of the IoU row in
      // flight; valid, killed_at and the score (loaded together) only where
      // the IoU merges: most are under merge_thr, and box i's own term needs
      // none of them. cap % 4 == 0.
      for (int j0 = 4 * lane; j0 < cap; j0 += 4 * 128) {
        float vq[16];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 128 * u;
          const float4 v = j < cap ? *reinterpret_cast<const float4*>(iou_row + j)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          vq[4 * u] = v.x;
          vq[4 * u + 1] = v.y;
          vq[4 * u + 2] = v.z;
          vq[4 * u + 3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + 128 * u + q;
            if (j >= cap) continue;
            uint8_t ok = 0;
            int killed = 0;
            float sc = 0.f;
            if (vq[4 * u + q] >= merge_thr) {
              ok = valid_b[j];
              killed = killed_b[j];
              sc = score_b[j];
            }
            float w = ok && killed >= i ? sc : 0.f;
            if (j == i) w = fmaxf(w, self);
            merge_term<kCols>(w, j, pay_b, P, c0, acc, nf);
          }
        }
      }
    } else if (kVec) {
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
          merge_term<kCols>(w, j0 + q, pay_b, P, c0, acc, nf);
        }
      }
    } else {
      for (int j = lane; j < cap; j += 32) {
        float w;
        if constexpr (kKilled) {  // as above: the rest only where the IoU merges
          uint8_t ok = 0;
          int killed = 0;
          float sc = 0.f;
          if (iou_row[j] >= merge_thr) {
            ok = valid_b[j];
            killed = killed_b[j];
            sc = score_b[j];
          }
          w = ok && killed >= i ? sc : 0.f;
        } else {
          const bool alive = !((removed[j >> 5] >> lane) & 1u);
          w = (alive && iou_row[j] >= merge_thr) ? score_b[j] : 0.f;
        }
        if (j == i) w = fmaxf(w, self);
        merge_term<kCols>(w, j, pay_b, P, c0, acc, nf);
      }
    }
#pragma unroll
    for (int k = 0; k <= kCols; ++k) acc[k] = warp_sum(acc[k]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) nf[k] = (int)__reduce_add_sync(kFull, (unsigned)nf[k]);
    const float wsum = fmaxf(acc[0], 1e-8f);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (lane == k && c0 + k < P)  // fewer non-finite terms than values: 0 x inf
        out[c0 + k] = nf[k] < nonfinite[b * P + c0 + k] ? __int_as_float(0x7fffffff)
                                                         : acc[k + 1] / wsum;
  }
}

template <bool kKilled>
cudaError_t launch_merge(bool vec, bool p9, int blocks, cudaStream_t st, const void* iou,
                         const void* scores, const void* payload, const void* keep,
                         const void* valid, const void* removed_set, const void* nonfinite,
                         void* merged, int rows, int cap, int nwords, int P,
                         float merge_thr) {
  auto merge = p9 ? (vec ? nms_merge_kernel<true, kP, kKilled>
                         : nms_merge_kernel<false, kP, kKilled>)
                  : (vec ? nms_merge_kernel<true, 0, kKilled>
                         : nms_merge_kernel<false, 0, kKilled>);
  merge<<<blocks, 32 * kRowsPerBlock, 0, st>>>(
      (const float*)iou, (const float*)scores, (const float*)payload,
      (const uint8_t*)keep, (const uint8_t*)valid, (const uint32_t*)removed_set,
      (const int*)nonfinite, (float*)merged, rows, cap, nwords, P, merge_thr);
  return cudaGetLastError();
}

}  // namespace

// iou: (B, cap, cap) fp32; scores: (B, cap) fp32; valid: (B, cap) bool
// (one byte each); payload: (B, cap, P) fp32, any P >= 1; keep: (B, cap)
// bool out; merged: (B, cap, P) fp32 out; mask: (B, 32 W, L) uint32
// scratch, W = ceil(cap / 32); scratch: the removed sets, (B, cap, W)
// uint32 seen for the register keep, (B, cap) int32 killed_at for the
// keep past cap 4096. The caller sizes the mask's rows, ld words each,
// and this checks them: ld = W for the register keep (ahead_keep == 0,
// cap <= 4096: it reads rows of W words), a multiple of 4 at least W for
// the keep past 4096 (ahead_keep != 0: TMA's 16-byte row strides).
// p9_merge != 0 runs the merge's P = 9 instance (P must be 9), else the
// any-P one. The caller's plan (kernels/nms.py::k2_plan) sets both.
// nonfinite: (B, P) int32 scratch, zeroed here (the last argument, so a
// caller of an earlier revision's signature is still a prefix). Any cap
// whose scratch fits. A memset and three launches (four past 4096) on
// `stream`; returns the cudaError_t of the first that fails.
extern "C" int rv3d_nms_scan(const void* iou, const void* scores,
                             const void* valid, const void* payload,
                             void* keep, void* merged, void* mask, void* scratch,
                             int B, int cap, int ld, int P, int ahead_keep,
                             int p9_merge, float iou_thr, float merge_thr,
                             void* stream, void* nonfinite) {
  const bool ahead = ahead_keep != 0;
  if (P <= 0 || B <= 0 || cap <= 0 || (!ahead && cap > kRegCap) || (p9_merge && P != kP) ||
      nonfinite == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nwords = (cap + 31) / 32;
  if (ahead ? (ld < nwords || ld % 4 != 0) : ld != nwords)
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * 32 * nwords > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  // The keep past 4096: as many stages of 32 x kBoxWords words as fit
  // beside the set, ready, the kept-bits ring and the barriers (and 1 KB
  // for the ring's alignment).
  const size_t stage = (size_t)32 * kBoxWords * sizeof(uint32_t);
  const size_t fixed = 1024 + 8 * (2 * kMaxAheadStages + kKeptSlots) +
                       4 * (kKeptSlots + 64) + (size_t)nwords * 5;
  const int stages =
      fixed < kMaxSmem ? (int)std::min<size_t>(kMaxAheadStages, (kMaxSmem - fixed) / stage)
                       : 0;
  const size_t smem = ahead ? fixed + stages * stage
                            : (size_t)kStages * 32 * nwords * sizeof(uint32_t);
  if ((ahead && stages < 2) || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int rows = B * cap;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = cap % 4 == 0 && ((uintptr_t)iou & 15) == 0 &&
                   ((uintptr_t)scores & 15) == 0;
  cudaError_t e = cudaMemsetAsync(nonfinite, 0, (size_t)B * P * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (vec) {
    nms_mask_kernel<true><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        (const float*)iou, (uint32_t*)mask, rows, cap, nwords, ld, iou_thr,
        (const float*)payload, P, (int*)nonfinite);
  } else {
    nms_mask_kernel<false><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        (const float*)iou, (uint32_t*)mask, rows, cap, nwords, ld, iou_thr,
        (const float*)payload, P, (int*)nonfinite);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (ahead) {
    // The mask as B x 32 W rows of W words, ld apart: TMA reads zeros past W.
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)nwords, (cuuint64_t)B * 32 * nwords};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(uint32_t)};
    const cuuint32_t box[2] = {kBoxWords, 32};
    const cuuint32_t elem_strides[2] = {1, 1};
    if (cuTensorMapEncodeTiled(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, mask, dims, strides,
                               box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    // Set on every call: the attribute is per device.
    e = cudaFuncSetAttribute(nms_keep_ahead_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    nms_keep_ahead_kernel<<<B, kAheadThreads, smem, st>>>(
        map, (const uint8_t*)valid, (uint8_t*)keep, (int*)scratch, (const uint32_t*)mask, cap,
        nwords, ld, stages);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((nwords + 127) / 128, (cap + kKillRows - 1) / kKillRows, B);
    nms_killed_at_kernel<<<grid, 128, 0, st>>>((const uint32_t*)mask, (const uint8_t*)valid,
                                               (const uint8_t*)keep, (int*)scratch, cap,
                                               nwords, ld);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_merge<true>(vec, p9_merge != 0, blocks, st, iou, scores, payload,
                                   keep, valid, scratch, nonfinite, merged, rows, cap,
                                   nwords, P, merge_thr);
  }
  if (smem > 48 * 1024) {  // set on every call: the attribute is per device
    e = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_keep_kernel<<<B, 32, smem, st>>>((const uint32_t*)mask, (const uint8_t*)valid,
                                       (uint8_t*)keep, (uint32_t*)scratch, cap, nwords);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_merge<false>(vec, p9_merge != 0, blocks, st, iou, scores, payload,
                                  keep, valid, scratch, nonfinite, merged, rows, cap,
                                  nwords, P, merge_thr);
}
