// Fused eval MetaKernel stem on int8 operands (K4) for Hopper (sm_90a).
//
// Replaces range_view_3d_detection_tpu/kernels/stem_pallas.py::
// meta_kernel_fused_i8 (_stem_kernel_i8), the int8 twin of K1
// (csrc/meta_kernel_fused.cu). Per pixel p of a (B, H, W, C) image and
// neighbour n = 3 dy + dx (out-of-image neighbours read zeros):
//
//   x0 = float(bf16(g(p + d_n) - g(p)))
//   hq = min(rint(relu(x0 * a0 + b0)), 127)                 int8
//   z  = hq @ W1                                            int32
//   p  = relu(float(z) * a1 + b1)
//   pq = clip(rint(p * float(feats(p + d_n))), -127, 127)   int8
//   acc += float(pq @ K_n) * kdq[n]                         fp32, n in order
//
// The caller folds the activation scales into a0, b0, a1, b1 and kdq
// (models/stems.py), as the JAX package does. Every product and sum of
// the affines is rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), rint rounds half to even, and |z|, |pq @ K_n| stay below
// 2^24 at C = 256, so float() is exact: the kernel equals its plain twin
// (kernels/stem.py::meta_kernel_fused_i8_plain) bit for bit.
//
// Bound on the H100: two C x C int8 GEMMs per neighbour and pixel, 5.46e11
// operations at B=2, 64x1808, C=256, i.e. 0.28 ms at 1979 TOP/s; the bytes
// (g and feats in bf16 read once, fp32 out written once, ~0.47 GB) take
// 0.14 ms. The quantize/round/convert work per element is fp32 on the
// CUDA cores and not in that bound.
//
// Design: K1's (see its header), in int8.
// - C is any multiple of 32 up to 256, through a template over a padded
//   width Cp of 128 (C <= 128) or 256: the weight boxes, the hq/pq tile and
//   the accumulators are Cp wide, and channels C..Cp-1 are zeros (the TMA
//   fills the weights outside the C x C matrices with zeros; hq and pq
//   there are 0 with zero affines; they are not stored).
// - A block owns 64 pixels of one row and all Cp output channels and loops
//   over the 9 neighbours. Two consumer warpgroups split the output
//   channels: warpgroup j owns columns [j Cp/2, (j + 1) Cp/2) of z, of the
//   per-neighbour product d = pq @ K_n and of the accumulator (wgmma
//   m64nNk32 s8 x s8 -> s32 with N = Cp/2, A and B from shared memory,
//   both K-major as s8 requires). z and d share Cp/4 int32 registers a
//   thread (z dies in the epilogue; each GEMM starts with scale-d = 0),
//   beside Cp/4 fp32 of the accumulator.
// - The weights arrive by TMA as W1^T and K_n^T ([n][k] int8) in the
//   128-byte swizzle, the K-major layout a wgmma descriptor reads (a k32
//   step is 32 bytes, as K1's bf16 k16 step). W1^T is the same for every
//   neighbour and stays in shared memory (Cp x Cp bytes, loaded once);
//   K_n^T streams through an mbarrier ring fed by one thread of the
//   producer warpgroup in boxes of 128 k x Cp/2 n, one warpgroup's
//   columns each, so a warpgroup waits only for its own boxes. The L2
//   weight stream is a quarter of K1's (int8, and no W1 per neighbour).
// - hq is built by the producer warpgroup's other three warps, one
//   neighbour ahead, into one of two 64 x Cp int8 buffers (mbarriers
//   hq_full / hq_empty). K1's builders are bound by the latency of their
//   g loads (chip_probe_k1.py), so here the builders read g from two rows
//   staged in shared memory by TMA: row h (the centre pixels, and the
//   shifted ones of dy = 1) for the whole block, and row h - 1, replaced
//   by row h + 1 once the builders are past neighbour 2 (mbarriers g_full,
//   g_edge_free). A row is the tile's 64 pixels and one halo pixel on each
//   side, from a 4-D tensor map whose out-of-image boxes arrive as zeros,
//   so the builders need no bounds checks.
// - Per neighbour the consumers run GEMM1 (z = hq @ W1), the BN1/ReLU/x
//   fs/quantize epilogue, which writes pq over hq once both warpgroups'
//   GEMM1 has retired, and GEMM2 (d = pq @ K_n over the full K = Cp),
//   which frees the buffer; then acc += float(d) * kdq[n].
//   Named barriers over the 256 consumer threads join the steps; generic
//   stores are made visible to wgmma with fence.proxy.async.
// - No conversion instructions (16 a clock an SM, the slowest pipe, and
//   the builders and the epilogue convert every element two or three
//   times): x0 is one bf16x2 subtraction a pair, int -> float and rint to
//   int8 are exact ALU forms (bf16x2_sub, small_int_to_float,
//   rint_i8_bits).
// - Shared memory at Cp = 256: W1^T (64 KB), 3 boxes of ring (48 KB), 2
//   hq/pq tiles (32 KB), 2 g rows (66 KB), the BN affines and kdq (13 KB):
//   224 KB, one block an SM. At Cp = 128 the ring has 6 boxes.
// - Host side: the two weight tensor maps and g's are encoded per launch
//   (cuTensorMapEncodeTiled, libcuda) and passed as __grid_constant__.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxC = 256;
constexpr int kTileP = 64;                // pixels per block: one m64 tile
constexpr int kRowPix = kTileP + 2;       // a staged g row: the tile and its two halo pixels
constexpr int kKBlock = 128;              // int8 channels of one 128-byte swizzle row
constexpr int kAtomBytes = kSw128AtomBytes;  // one k-block of hq: 64 rows x 128 B
constexpr int kConsumerThreads = 256;
// + one producer warpgroup: one thread of its first warp issues the
// weight loads, its other three warps build hq. K1's register split
// (80 / 208): the launch holds 64,512 registers, and a split above that
// makes setmaxnreg.inc wait forever.
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kBuilders = 96;
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 208;

// K_n ring stages of the Cp-wide instance (boxes of 128 k x Cp/2 n): 3 at
// Cp = 256 fit beside the resident W1 and the two staged g rows.
template <int kCp>
constexpr int kStagesFor = kCp == 256 ? 3 : 6;
// One staged g row, [kRowPix][C] bf16, in 1 KB units.
template <int kCp>
constexpr int kRowBytes = (kRowPix * kCp * 2 + 1023) / 1024 * 1024;
// Shared memory of the Cp-wide instance: W1, the K_n ring, two hq/pq
// tiles, two g rows, the four BN affines and the nine kdq rows, the
// mbarriers, and room to align W1 to 1024 bytes.
template <int kCp>
constexpr int kSmemBytes = kCp * kCp + kStagesFor<kCp> * kKBlock * kCp / 2 +
                           2 * (kCp / kKBlock) * kAtomBytes + 2 * kRowBytes<kCp> +
                           13 * kCp * 4 + (2 * kStagesFor<kCp> + 8) * 8 + 1024;

// The conversions between float, int and bf16 run on the SM's slowest
// pipe (16 a clock), and the builders and the epilogue convert every
// element two or three times, so they take these exact ALU forms.
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

// v + 1.5 * 2^23 for |v| <= 127: the sum rounds v to an integer, half to
// even, and its low byte is that integer as an int8 (two's complement).
__device__ __forceinline__ uint32_t rint_i8_bits(float v) {
  return __float_as_uint(__fadd_rn(v, kRound));
}
// float(i), exactly, for |i| < 2^22 (|z|, |d| <= 256 * 127 * 128 here).
__device__ __forceinline__ float small_int_to_float(int i) {
  return __fsub_rn(__int_as_float(i + 0x4B400000), kRound);
}
// bf16(a - b) for both halves of two bf16 pairs, in one bf16x2
// subtraction. It rounds once, the twin (and XLA) twice (fp32, then
// bf16), and the two agree: where the fp32 difference is inexact, |b| <
// 2^-16 |a| (or the reverse), and both land on a (or -b), far from a bf16
// rounding boundary.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}
// The low bytes of a and b in bytes 0 and 1.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x0040);
}

__device__ __forceinline__ void consumer_sync() {
  named_barrier_sync<kConsumerThreads>(1);
}

// d = A @ B (scale_d == 0) or d += A @ B for one k32 step, N = 128 (Cp =
// 256) or 64 (Cp = 128) by the size of the accumulator.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kCp>
__global__ void __launch_bounds__(kThreads, 1)
    meta_kernel_fused_i8_wgmma(const __grid_constant__ CUtensorMap w1map,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap gmap,
                               const __nv_bfloat16* __restrict__ f,
                               const float* __restrict__ a0, const float* __restrict__ b0,
                               const float* __restrict__ a1, const float* __restrict__ b1,
                               const float* __restrict__ kdq, float* __restrict__ out,
                               int H, int W, int C) {
  constexpr int kStages = kStagesFor<kCp>;
  constexpr int kHalfN = kCp / 2;              // output channels per consumer warpgroup
  constexpr int kKB = kCp / kKBlock;           // 128-channel k-blocks
  constexpr int kW1Box = kKBlock * kCp;        // W1^T, k-block kb: 128 k x Cp n
  constexpr int kBoxBytes = kKBlock * kHalfN;  // a K_n^T box: 128 k x Cp/2 n
  constexpr int kHqBytes = kKB * kAtomBytes;   // one hq/pq tile, two of them
  constexpr int kBoxesPerNb = 2 * kKB;         // (kb, warpgroup) of K_n^T
  constexpr int kJ = kHalfN / 8;               // 8-column groups of a warpgroup
  // Builders: kCp / 8 threads of 8 channels cover a pixel; the 96 threads
  // cover kPixGroups pixels at a time.
  constexpr int kPixGroups = kBuilders / (kCp / 8);
  constexpr int kPixSteps = (kTileP + kPixGroups - 1) / kPixGroups;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* w1_s = smem;
  uint8_t* ring = w1_s + kKB * kW1Box;
  uint8_t* hq = ring + kStages * kBoxBytes;
  uint8_t* g_mid = hq + 2 * kHqBytes;              // g row h, then the other row:
  uint8_t* g_edge = g_mid + kRowBytes<kCp>;        // h - 1, then h + 1
  float* a1_s = reinterpret_cast<float*>(g_edge + kRowBytes<kCp>);
  float* b1_s = a1_s + kCp;
  float* a0_s = b1_s + kCp;
  float* b0_s = a0_s + kCp;
  float* kdq_s = b0_s + kCp;  // [9][kCp]
  uint64_t* full = reinterpret_cast<uint64_t*>(kdq_s + 9 * kCp);
  uint64_t* empty = full + kStages;
  uint64_t* hq_full = empty + kStages;  // hq buffer b holds neighbour nb, nb % 2 == b
  uint64_t* hq_empty = hq_full + 2;
  uint64_t* g_full = hq_empty + 2;  // [0]: row h; [1]: row h - 1 (phase 0), h + 1 (phase 1)
  uint64_t* g_edge_free = g_full + 2;
  uint64_t* w1_full = g_edge_free + 1;

  const int w0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t img = (size_t)b * H;

  for (int i = threadIdx.x; i < kCp; i += kThreads) {
    const bool real = i < C;  // padded channels get zero affines
    a0_s[i] = real ? a0[i] : 0.f;
    b0_s[i] = real ? b0[i] : 0.f;
    a1_s[i] = real ? a1[i] : 0.f;
    b1_s[i] = real ? b1[i] : 0.f;
  }
  for (int i = threadIdx.x; i < 9 * kCp; i += kThreads) {
    const int nb = i / kCp, c = i - nb * kCp;
    kdq_s[i] = c < C ? kdq[nb * C + c] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                         // the TMA's bytes
      mbar_init(&empty[s], 4);                        // the warps of one warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&hq_full[i], kBuilders / 32);         // each builder warp
      mbar_init(&hq_empty[i], kConsumerThreads / 32);  // each consumer warp
      mbar_init(&g_full[i], 1);                       // the TMA's bytes
    }
    mbar_init(g_edge_free, kBuilders / 32);           // each builder warp
    mbar_init(w1_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---------------- producer: one thread streams the weight boxes, three
    // warps build hq one neighbour ahead of the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumerThreads + 32) {
      // This thread's 8 channels [ch, ch + 8), for pixels p0 + kPixGroups i,
      // read from the staged g rows, where pixel w0 - 1 + i is row entry i
      // and pixels outside the image are zeros (the TMA's fill).
      const int bt = threadIdx.x - kConsumerThreads - 32;
      const int ch = (bt % (kCp / 8)) * 8;
      const int p0 = bt / (kCp / 8);
      const bool ch_ok = ch < C;
      float sa0[8], sb0[8];
      *reinterpret_cast<float4*>(sa0) = *reinterpret_cast<const float4*>(a0_s + ch);
      *reinterpret_cast<float4*>(sa0 + 4) = *reinterpret_cast<const float4*>(a0_s + ch + 4);
      *reinterpret_cast<float4*>(sb0) = *reinterpret_cast<const float4*>(b0_s + ch);
      *reinterpret_cast<float4*>(sb0 + 4) = *reinterpret_cast<const float4*>(b0_s + ch + 4);
      const __nv_bfloat16* gc_row = reinterpret_cast<const __nv_bfloat16*>(g_mid) + C + ch;
      mbar_wait(&g_full[0], 0);
      for (int nb = 0; nb < 9; ++nb) {
        const int buf = nb & 1;
        if (nb >= 2) mbar_wait(&hq_empty[buf], ((nb >> 1) - 1) & 1);
        uint8_t* dst = hq + buf * kHqBytes;
        const int dy = nb / 3;
        const int dx = nb - dy * 3;
        if (nb == 0 || nb == 6) mbar_wait(&g_full[1], nb == 6);
        // This thread's channels of pixel p: gc_row[p C], shifted gs_row[p C].
        const __nv_bfloat16* gs_row =
            reinterpret_cast<const __nv_bfloat16*>(dy == 1 ? g_mid : g_edge) + dx * C + ch;
        // hq = min(rint(relu(a0 * bf16(g(p + d) - g(p)) + b0)), 127), 8
        // bytes a thread and pixel; rows past W get finite values and are
        // not stored.
#pragma unroll 2
        for (int i = 0; i < kPixSteps; ++i) {
          const int p = p0 + kPixGroups * i;
          if (p >= kTileP) break;
          uint4 gc = make_uint4(0, 0, 0, 0), gs = make_uint4(0, 0, 0, 0);
          if (ch_ok) {
            gc = *reinterpret_cast<const uint4*>(gc_row + p * C);
            gs = *reinterpret_cast<const uint4*>(gs_row + p * C);
          }
          const uint32_t cw[4] = {gc.x, gc.y, gc.z, gc.w};
          const uint32_t sw[4] = {gs.x, gs.y, gs.z, gs.w};
          uint32_t two[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t x0 = bf16x2_sub(sw[q], cw[q]);
            const float x0a = bf16_lo(x0);
            const float x0b = bf16_hi(x0);
            const float ha = fmaxf(__fadd_rn(__fmul_rn(x0a, sa0[2 * q]), sb0[2 * q]), 0.f);
            const float hb =
                fmaxf(__fadd_rn(__fmul_rn(x0b, sa0[2 * q + 1]), sb0[2 * q + 1]), 0.f);
            two[q] = low_bytes(rint_i8_bits(fminf(ha, 127.f)), rint_i8_bits(fminf(hb, 127.f)));
          }
          *reinterpret_cast<uint2*>(dst + sw128(p, ch)) = make_uint2(
              __byte_perm(two[0], two[1], 0x5410), __byte_perm(two[2], two[3], 0x5410));
        }
        fence_proxy_async();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) {
          mbar_arrive(&hq_full[buf]);
          if (nb == 2) mbar_arrive(g_edge_free);  // row h - 1 is read
        }
      }
    } else if (threadIdx.x == kConsumerThreads) {
      // W1^T once; g rows h and h - 1 (row entry i is pixel w0 - 1 + i),
      // then h + 1 once the builders are past neighbour 2; K_n^T box by box,
      // box i = (kKB nb + kb) 2 + wg for warpgroup wg's columns.
      mbar_arrive_tx(w1_full, kKB * kW1Box);
      for (int kb = 0; kb < kKB; ++kb)
        tma_load_3d(w1_s + kb * kW1Box, &w1map, w1_full, kb * kKBlock, 0, 0);
      const int row_bytes = kRowPix * C * 2;
      mbar_arrive_tx(&g_full[0], row_bytes);
      tma_load_4d(g_mid, &gmap, &g_full[0], 0, w0 - 1, h, b);
      mbar_arrive_tx(&g_full[1], row_bytes);
      tma_load_4d(g_edge, &gmap, &g_full[1], 0, w0 - 1, h - 1, b);
      for (int i = 0; i < 9 * kBoxesPerNb; ++i) {
        if (i == 4 * kBoxesPerNb) {
          mbar_wait(g_edge_free, 0);
          mbar_arrive_tx(&g_full[1], row_bytes);
          tma_load_4d(g_edge, &gmap, &g_full[1], 0, w0 - 1, h + 1, b);
        }
        const int s = i % kStages;
        const int lap = i / kStages;
        if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
        mbar_arrive_tx(&full[s], kBoxBytes);
        const int nb = i / kBoxesPerNb;
        const int r = i % kBoxesPerNb;
        tma_load_3d(ring + s * kBoxBytes, &kmap, &full[s], (r >> 1) * kKBlock,
                    (r & 1) * kHalfN, nb);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns output columns
    // [kHalfN wg, kHalfN (wg + 1)).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int wq = t / 32;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t ring_u32 = smem_u32(ring);
    const uint32_t hq_u32 = smem_u32(hq);

    float acc[kHalfN / 2];
    int zd[kHalfN / 2];  // z, then d = pq @ K_n
#pragma unroll
    for (int i = 0; i < kHalfN / 2; ++i) {
      acc[i] = 0.f;
      zd[i] = 0;
    }

    const uint32_t w1_u32 = smem_u32(w1_s) + wg * kHalfN * 128;
    // d = A @ B over K = Cp, A the hq/pq tile at a_u32: B is W1^T (resident)
    // for neighbour nb < 0, else this warpgroup's boxes of K_nb^T, each
    // released once the wgmma group that read it has retired. The first
    // k32 step overwrites d (scale-d = 0).
    auto gemm = [&](int (&d)[kHalfN / 2], uint32_t a_u32, int nb) {
#pragma unroll
      for (int i = 0; i < kHalfN / 2; ++i) fence_operand(d[i]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
        const int box = (nb * kKB + kb) * 2 + wg;
        uint32_t b_u32 = w1_u32 + kb * kW1Box;
        if (nb >= 0) {
          mbar_wait(&full[box % kStages], (box / kStages) & 1);
          b_u32 = ring_u32 + (box % kStages) * kBoxBytes;
        }
        const uint64_t da = desc_sw128(a_u32 + kb * kAtomBytes);
        const uint64_t db = desc_sw128(b_u32);
#pragma unroll
        for (int k32 = 0; k32 < 4; ++k32)
          wgmma_s8(d, da + 2 * k32, db + 2 * k32, kb | k32);  // +32 bytes
        wgmma_commit();
        if (kb > 0 && nb >= 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(box - 2) % kStages]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kHalfN / 2; ++i) fence_operand(d[i]);
      if (nb >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[((nb * kKB + kKB - 1) * 2 + wg) % kStages]);
      }
    };

    mbar_wait(w1_full, 0);
    for (int nb = 0; nb < 9; ++nb) {
      const int dy = nb / 3;
      const int dx = nb - dy * 3;
      const int hs = h + dy - 1;
      const bool row_ok = hs >= 0 && hs < H;

      const int buf = nb & 1;
      uint8_t* hq_b = hq + buf * kHqBytes;
      const uint32_t hq_b_u32 = hq_u32 + buf * kHqBytes;

      // The shifted feats at this thread's accumulator rows and columns,
      // in flight while hq is awaited and GEMM1 runs.
      uint32_t fs[kJ][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int w = w0 + wq * 16 + gid + 8 * r;
        const int ws = w + dx - 1;
        const bool ok = w < W && row_ok && ws >= 0 && ws < W;
        const __nv_bfloat16* fp = f + ((img + hs) * W + ws) * C + wg * kHalfN + tig * 2;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const bool col_ok = wg * kHalfN + j * 8 < C;
          fs[j][r] = ok && col_ok ? __ldg(reinterpret_cast<const unsigned int*>(fp + j * 8)) : 0u;
        }
      }

      // 1. z = hq @ W1 (int32), this warpgroup's columns, once the builders
      // have filled hq's buffer.
      mbar_wait(&hq_full[buf], (nb >> 1) & 1);
      gemm(zd, hq_b_u32, -1);
      consumer_sync();  // both warpgroups' GEMM1 has read hq

      // 2. pq = clip(rint(relu(a1 * z + b1) * fs), +-127) over hq, in its
      // layout.
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = wg * kHalfN + j * 8 + tig * 2;
        const float2 s1 = *reinterpret_cast<const float2*>(a1_s + n);
        const float2 t1 = *reinterpret_cast<const float2*>(b1_s + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = wq * 16 + gid + 8 * r;
          const float pa = fmaxf(
              __fadd_rn(__fmul_rn(small_int_to_float(zd[4 * j + 2 * r]), s1.x), t1.x), 0.f);
          const float pb = fmaxf(
              __fadd_rn(__fmul_rn(small_int_to_float(zd[4 * j + 2 * r + 1]), s1.y), t1.y), 0.f);
          const float qa = fminf(fmaxf(__fmul_rn(pa, bf16_lo(fs[j][r])), -127.f), 127.f);
          const float qb = fminf(fmaxf(__fmul_rn(pb, bf16_hi(fs[j][r])), -127.f), 127.f);
          *reinterpret_cast<uint16_t*>(hq_b + sw128(m, n)) =
              static_cast<uint16_t>(low_bytes(rint_i8_bits(qa), rint_i8_bits(qb)));
        }
      }
      fence_proxy_async();
      consumer_sync();

      // 3. d = pq @ K_n over the full K = Cp; then the buffer is free, and
      // acc += float(d) * kdq[n].
      gemm(zd, hq_b_u32, nb);
      __syncwarp();
      if (lane == 0) mbar_arrive(&hq_empty[buf]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float2 q = *reinterpret_cast<const float2*>(
            kdq_s + nb * kCp + wg * kHalfN + j * 8 + tig * 2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& ea = acc[4 * j + 2 * r];
          float& eb = acc[4 * j + 2 * r + 1];
          ea = __fadd_rn(ea, __fmul_rn(small_int_to_float(zd[4 * j + 2 * r]), q.x));
          eb = __fadd_rn(eb, __fmul_rn(small_int_to_float(zd[4 * j + 2 * r + 1]), q.y));
        }
      }
    }

    // Store this thread's accumulator rows and its columns below C.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int w = w0 + wq * 16 + gid + 8 * r;
      if (w >= W) continue;
      float* op = out + ((img + h) * W + w) * C + wg * kHalfN + tig * 2;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (wg * kHalfN + j * 8 < C)
          *reinterpret_cast<float2*>(op + j * 8) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// A 4-D bf16 tensor map over g (B, H, W, C), boxes of one row of kRowPix
// pixels x C channels, unswizzled; pixels outside the image arrive as zeros.
bool row_map(CUtensorMap* map, const void* g, int B, int H, int W, int C) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, kRowPix, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                const_cast<void*>(g), dims, strides, box, elem_strides,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kCp>
int launch(const void* g, const void* feats, const void* w1t, const void* kt,
           const void* a0, const void* b0, const void* a1, const void* b1,
           const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  CUtensorMap w1map, kmap, gmap;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!stem_weight_map(&w1map, kU8, 1, w1t, C, kCp, 1) ||
      !stem_weight_map(&kmap, kU8, 1, kt, C, kCp / 2, 9) || !row_map(&gmap, g, B, H, W, C))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = kSmemBytes<kCp>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      meta_kernel_fused_i8_wgmma<kCp>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + kTileP - 1) / kTileP, H, B);
  meta_kernel_fused_i8_wgmma<kCp><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      w1map, kmap, gmap, (const __nv_bfloat16*)feats,
      (const float*)a0, (const float*)b0, (const float*)a1, (const float*)b1,
      (const float*)kdq, (float*)out, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// g, feats: (B, H, W, C) bf16; w1t: (C, C) int8 = W1^T; kt: (9, C, C) int8
// with kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; kdq: (9, C) fp32;
// out: (B, H, W, C) fp32. C must be a multiple of 32 up to 256 (C <= 128
// runs the 128-wide instance, the rest the 256-wide one); w1t and kt
// 16-byte aligned.
extern "C" int rv3d_meta_kernel_fused_i8(
    const void* g, const void* feats, const void* w1t, const void* kt,
    const void* a0, const void* b0, const void* a1, const void* b1,
    const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  if (C <= 0 || C % 32 || C > kMaxC || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  return C <= 128
             ? launch<128>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, stream)
             : launch<256>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, stream);
}
