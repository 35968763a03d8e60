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
// - With bf16 g and feats, C is any multiple of 16 up to 256 (the int8
//   weights' TMA strides need C % 16 == 0), through a template over a
//   padded width Cp of 128 (C <= 128) or 256: the weight boxes, the hq/pq
//   tile and the accumulators are Cp wide, and channels C..Cp-1 are zeros
//   (the TMA fills the weights outside the C x C matrices with zeros; hq
//   and pq there are 0 with zero affines; they are not stored). The
//   wrapper pads a bf16 C that is not a multiple of 16 with zero channels.
//   fp32 g and feats at C <= 256, and C above 256 in either dtype, take the
//   output-tiled kernel at the end of this file, on the same int8 wgmma.
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

// A 4-D tensor map over g (B, H, W, C) of `elem`-byte elements, boxes of
// one row of kRowPix pixels x C channels, unswizzled; pixels outside the
// image arrive as zeros.
bool row_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* g, int B,
             int H, int W, int C) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * elem, (cuuint64_t)W * C * elem,
                                 (cuuint64_t)H * W * C * elem};
  const cuuint32_t box[4] = {(cuuint32_t)C, kRowPix, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, type, 4,
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
      !stem_weight_map(&kmap, kU8, 1, kt, C, kCp / 2, 9) ||
      !row_map(&gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, B, H, W, C))
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

// ---------------- The output-tiled kernel: fp32 g at C <= 256, C past 256.
//
// The instances above read bf16 g through a TMA row map and keep z and d
// of the whole tile (Cp <= 256) in one set of registers. This kernel takes
// the rest (kernels/stem.py::k4_plan), on the same int8 wgmma (m64nNk32
// s8, A and B from shared memory) and with the same warp roles: one
// producer thread streams weight boxes by TMA through an mbarrier ring,
// three builder warps build hq one neighbour ahead, two consumer
// warpgroups split the output tile's columns.
// - Form 1: fp32 g and feats at C <= 256 (an int8 model quantized from
//   fp32: x0 = g(p + d) - g(p) and p * feats in fp32, stem_pallas.py
//   _stem_kernel_i8 with cdt = float32), one 128- or 256-wide tile.
// - Form 2: g in either dtype past C = 256, in 256-wide output tiles.
// Form 2 takes fp32 at C <= 256 as well (one tile), but at the flagship
// stem (2, 64, 1808, 256) it takes 1.8x form 1's time on an H100: its
// builders wait on g from L2 where form 1's read staged rows, and its
// chain of two chunks a neighbour has less to overlap (chip_probe_k4.py
// --dtype fp32 times both; PERF.md). So form 1 stays.
//
// Bound on the H100: two C x C int8 GEMMs a neighbour and pixel, 5.46e11
// operations at (2, 64, 1808, 256), 0.276 ms at 1979 TOP/s; 1.09e12 at
// (1, 64, 1808, 512), 0.552 ms, of which form 2 does 1.5x (it repeats the
// W1 product for each 256-wide output tile: 0.83 ms).
//
// Form 1, the reckoning. At Cp = 256 the bf16 instance fills 224 of the
// 227 KB a block may have: W1 64 KB, 3 ring boxes 48 KB, 2 hq/pq tiles 32
// KB, two staged g rows of 66 pixels 2 x 33 KB, the affines and kdq 13 KB.
// In fp32 the two rows are 2 x 66 KB, 290 KB in all. The ways out:
// - stage only the centre row and read the shifted ones from L2: the
//   builders wait on those loads, as K1's did before its rows were staged
//   (chip_probe_k1.py; staging the rows took K4's bf16 instance from 2.02
//   to 1.69 ms by graph replay on an H100);
// - stage the rows a 128-channel k-block at a time: 9 x 135 KB of L2
//   re-reads a block, 4.5 GB a flagship call;
// - a pre-pass writing hq for the 9 neighbours as int8: 9 x 59 MB through
//   HBM and back, about 0.3 ms at the flagship;
// - stream W1 through the ring with K_n: 64 KB more of L2 reads a block
//   and neighbour (2.1 GB a flagship call, the K_n stream's size again),
//   made by the TMA, out of the builders' way.
// This kernel takes the last. Shared memory at Cp = 256: 3 ring boxes (48
// KB: W1^T and K_n^T boxes of 128 k x 128 n, one warpgroup's columns
// each), 2 hq/pq tiles (32 KB), two fp32 g rows (132 KB), the affines and
// kdq (13 KB): 226 KB, 0.9 KB to spare. At Cp = 128 the ring has 6 boxes.
// Registers: z and d share Cp/4 int32 a thread (z dies in the epilogue),
// beside Cp/4 fp32 of the accumulator, as above; the shifted fp32 feats
// would take Cp/4 more if held across GEMM1 (the bf16 instances hold
// Cp/8), so they are loaded two 8-column groups at a time, two steps
// ahead of the epilogue's use (the first two before GEMM1). |z|, |d| <
// 2^22 at C <= 256, so small_int_to_float is exact.
//
// Form 2, C past 256 (either dtype; any C that is a multiple of 16):
// - The grid's z walks B x ceil(C / 256) output tiles. Per neighbour and
//   per 128-wide chunk j of z: z_j = hq @ W1[:, j] over K = C (each
//   warpgroup 64 of the chunk's columns, m64n64k32), the BN1/ReLU/x
//   fs/quantize epilogue into pq_j (64 x 128 int8, two tiles in turn, so
//   a warpgroup writes the next while the other's GEMM2 reads the last),
//   then d += pq_j @ K_n[j, tile] (m64n128k32). After the last chunk,
//   acc += float(d) * kdq[n]: d stays one exact integer over the chunks of
//   a neighbour, as the twin's sum is (kernels/stem.py rounds
//   float(d) * kdq[n] once), so z_j, d and the accumulator are registers of
//   their own: 32 + 64 + 64 a thread. ptxas keeps them at zero spills with
//   the shifted feats loaded one step ahead (not two) and setmaxnreg 72 /
//   216 (the builders need no more than 72).
// - hq (64 x C int8, 32 KB at C = 512) is built once a neighbour and lives
//   across the chunks: in two buffers up to C = 1152, in one up to 2304
//   (the builders then wait for the neighbour's last GEMM1). Past that it
//   does not fit, and the builders build it a slab of 1152 channels at a
//   time, two buffers deep, for each chunk again (nchunks times the
//   building, where a wider stem would pay for its size). W1 (C x C) does
//   not fit either and streams through the ring, in boxes of 128 k x 64
//   n, once per output tile.
// - The builders read g and the BN0 affine from L2 with the image's
//   bounds checked per pixel: two rows of 66 pixels x C do not fit beside
//   hq, and nothing in shared memory grows with C but hq.
// - |z| and |d| reach C x 127 x 128: past 2^22 at C = 512 (8.3e6), where
//   small_int_to_float stops being exact, and past 2^24 at C > 1032, where
//   float() rounds. int_to_float_rn is correctly rounded at every int32,
//   as the twin's conversion of the exact fp64 integer is.
//
// The twin's arithmetic step for step, as above (__fmul_rn/__fadd_rn, rint
// half to even, exact int32 sums), so the kernel equals
// kernels/stem.py::meta_kernel_fused_i8_plain bit for bit. What holds each
// form back on the card (chip_probe_k4.py --ablate): PERF.md.

// float(i), correctly rounded (half to even), for every int i: i = 4096 hi
// + lo with hi = i >> 12 and 0 <= lo < 4096, both exact in float (lo as
// 2^23 + lo less 2^23), and one fused multiply-add rounds the exact sum.
__device__ __forceinline__ float int_to_float_rn(int i) {
  const float hi = small_int_to_float(i >> 12);
  const float lo = __fsub_rn(__int_as_float((i & 0xFFF) | 0x4B000000), 8388608.f);
  return __fmaf_rn(hi, 4096.f, lo);
}

// 16-byte words of 8 elements of T.
template <typename T>
constexpr int kWords8 = sizeof(T) / 2;

// hq of 8 channels: x0 = T(s - c), min(rint(relu(a0 x0 + b0)), 127), as
// 8 int8 bytes (c, s: 8 elements of T each).
template <typename T>
__device__ __forceinline__ uint2 hq8(const uint4 (&c)[kWords8<T>], const uint4 (&s)[kWords8<T>],
                                     const float (&a0)[8], const float (&b0)[8]) {
  float x[8];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint32_t cw[4] = {c[v].x, c[v].y, c[v].z, c[v].w};
      const uint32_t sw[4] = {s[v].x, s[v].y, s[v].z, s[v].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[4 * v + e] = __fsub_rn(__uint_as_float(sw[e]), __uint_as_float(cw[e]));
    }
  } else {
    const uint32_t cw[4] = {c[0].x, c[0].y, c[0].z, c[0].w};
    const uint32_t sw[4] = {s[0].x, s[0].y, s[0].z, s[0].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x0 = bf16x2_sub(sw[q], cw[q]);
      x[2 * q] = bf16_lo(x0);
      x[2 * q + 1] = bf16_hi(x0);
    }
  }
  uint32_t two[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float ha = fmaxf(__fadd_rn(__fmul_rn(x[2 * q], a0[2 * q]), b0[2 * q]), 0.f);
    const float hb = fmaxf(__fadd_rn(__fmul_rn(x[2 * q + 1], a0[2 * q + 1]), b0[2 * q + 1]), 0.f);
    two[q] = low_bytes(rint_i8_bits(fminf(ha, 127.f)), rint_i8_bits(fminf(hb, 127.f)));
  }
  return make_uint2(__byte_perm(two[0], two[1], 0x5410), __byte_perm(two[2], two[3], 0x5410));
}

// Two feats values (columns n, n + 1) of T, and their floats.
template <typename T>
struct FsPair;
template <>
struct FsPair<float> {
  using V = float2;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ V zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float lo(V v) { return v.x; }
  static __device__ __forceinline__ float hi(V v) { return v.y; }
};
template <>
struct FsPair<__nv_bfloat16> {
  using V = uint32_t;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ V zero() { return 0u; }
  static __device__ __forceinline__ float lo(V v) { return bf16_lo(v); }
  static __device__ __forceinline__ float hi(V v) { return bf16_hi(v); }
};

// The instance's shapes: T the dtype of g and feats, kN the output tile's
// width, kTiled form 2.
template <typename T, int kN, bool kTiled>
struct Tl {
  static constexpr int kHalf = kN / 2;            // d and acc columns a warpgroup
  static constexpr int kZ = kTiled ? 128 : kN;    // the width of a chunk of z
  static constexpr int kZHalf = kZ / 2;           // z columns a warpgroup
  static constexpr int kW1Box = kKBlock * kZHalf;  // W1^T box: 128 k x kZHalf n
  static constexpr int kKBox = kKBlock * kHalf;    // K_n^T box: 128 k x kHalf n
  static constexpr int kSlot = kKBox;              // a ring stage (>= kW1Box)
  static constexpr int kStages = kTiled ? 4 : (kN == 256 ? 3 : 6);
  static constexpr int kRing = kStages * kSlot;
  // Form 1: one staged fp32 row [kRowPix][C], in 1 KB units.
  static constexpr int kRowBytes = (kRowPix * kN * (int)sizeof(T) + 1023) / 1024 * 1024;
  static constexpr int kBars = (2 * kStages + 4 + (kTiled ? 0 : 3)) * 8;
  // setmaxnreg: form 1 the instances' 80 / 208; form 2's consumers hold z_j,
  // d and the accumulator (160 registers a thread) and take 216, which
  // keeps ptxas at zero spills (128 x 72 + 256 x 216 = 64,512, the launch's
  // registers).
  static constexpr int kRegsProducer = kTiled ? 72 : kProducerRegs;
  static constexpr int kRegsConsumer = kTiled ? 216 : kConsumerRegs;
  // Shared memory beside form 2's hq tiles (form 1: all of it).
  static constexpr int kFixedSmem =
      kTiled ? kRing + 2 * kAtomBytes + kBars + 1024
             : kRing + 2 * (kN / kKBlock) * kAtomBytes + 2 * kRowBytes + 13 * kN * 4 + kBars +
                   1024;
};

constexpr int kMaxSmem = 232448;  // the H100's dynamic shared memory a block

// d = A @ B (acc_in false: the first k32 step overwrites d) or d += A @ B
// over nkb k-blocks: A the K-major tile at a_u32 (one 8 KB atom a
// k-block), B this warpgroup's next nkb boxes of the ring, each released
// once the wgmma group that read it has retired. Box i of the stream is
// warpgroup i % 2's; `cnt` counts this warpgroup's.
template <int kS, int kSlot, int kAccN>
__device__ __forceinline__ void ring_gemm(int (&d)[kAccN], uint32_t a_u32, int nkb, bool acc_in,
                                          int& cnt, int wg, uint64_t* full, uint64_t* empty,
                                          uint32_t ring_u32) {
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < kAccN; ++i) fence_operand(d[i]);
  wgmma_fence();
  int prev = 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const int box = 2 * cnt++ + wg;
    const int s = box % kS;
    mbar_wait(&full[s], (box / kS) & 1);
    const uint64_t da = desc_sw128(a_u32 + kb * kAtomBytes);
    const uint64_t db = desc_sw128(ring_u32 + s * kSlot);
#pragma unroll
    for (int k32 = 0; k32 < 4; ++k32)
      wgmma_s8(d, da + 2 * k32, db + 2 * k32, acc_in || kb || k32);  // +32 bytes
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lead) mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kAccN; ++i) fence_operand(d[i]);
  __syncwarp();
  if (lead) mbar_arrive(&empty[prev]);
}

// z's registers: their own in form 2, d's in form 1.
template <bool kTiled, int kA, int kB>
__device__ __forceinline__ decltype(auto) z_regs(int (&own)[kA], int (&d)[kB]) {
  if constexpr (kTiled)
    return (own);
  else
    return (d);
}

template <typename T, int kN, bool kTiled>
__global__ void __launch_bounds__(kThreads, 1)
    meta_kernel_fused_i8_tiles(const __grid_constant__ CUtensorMap w1map,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap gmap,
                               const T* __restrict__ g, const T* __restrict__ f,
                               const float* __restrict__ a0, const float* __restrict__ b0,
                               const float* __restrict__ a1, const float* __restrict__ b1,
                               const float* __restrict__ kdq, float* __restrict__ out, int H,
                               int W, int C, int tiles, int nbuf, int slab) {
  using L = Tl<T, kN, kTiled>;
  using Fs = FsPair<T>;
  constexpr int kS = L::kStages;
  constexpr int kHalf = L::kHalf;
  constexpr int kZHalf = L::kZHalf;
  constexpr int kV = kWords8<T>;
  // Form 1's hq/pq tile is kN wide. Form 2's pq is one atom, and its hq
  // `slab` atoms: all of C in one build a neighbour where that fits (nslab
  // = 1), else one build a chunk of z and slab of k.
  const int nkb1 = kTiled ? (C + kKBlock - 1) / kKBlock : kN / kKBlock;
  if constexpr (!kTiled) slab = nkb1;
  const int nslab = (nkb1 + slab - 1) / slab;
  const int hq_bytes = slab * kAtomBytes;
  const int nchunks = kTiled ? (C + L::kZ - 1) / L::kZ : 1;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* pq = ring + L::kRing;                        // form 2: two pq_j tiles
  uint8_t* hq = pq + (kTiled ? 2 * kAtomBytes : 0);     // nbuf hq tiles (form 1: hq/pq, 2)
  uint8_t* g_mid = hq + (kTiled ? nbuf : 2) * hq_bytes;  // form 1: g row h, then
  uint8_t* g_edge = g_mid + (kTiled ? 0 : L::kRowBytes);  // h - 1, then h + 1
  // Form 1 only, as are the g rows: the affines and kdq ([9][kN]).
  float* a0_s = reinterpret_cast<float*>(g_edge + (kTiled ? 0 : L::kRowBytes));
  float* b0_s = a0_s + kN;
  float* a1_s = b0_s + kN;
  float* b1_s = a1_s + kN;
  float* kdq_s = b1_s + kN;
  uint64_t* full = reinterpret_cast<uint64_t*>(kTiled ? a0_s : kdq_s + 9 * kN);
  uint64_t* empty = full + kS;
  uint64_t* hq_full = empty + kS;  // hq buffer u & (nbuf - 1) holds build u
  uint64_t* hq_empty = hq_full + 2;
  uint64_t* g_full = hq_empty + 2;  // form 1: [0] row h; [1] row h - 1, then h + 1
  uint64_t* g_edge_free = g_full + 2;
  if constexpr (!kTiled) nbuf = 2;

  const int w0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int b = blockIdx.z / tiles;
  const int n0 = (blockIdx.z % tiles) * kN;
  const size_t img = (size_t)b * H;

  if constexpr (!kTiled) {
    for (int i = threadIdx.x; i < kN; i += kThreads) {
      const bool real = i < C;  // padded channels get zero affines
      a0_s[i] = real ? a0[i] : 0.f;
      b0_s[i] = real ? b0[i] : 0.f;
      a1_s[i] = real ? a1[i] : 0.f;
      b1_s[i] = real ? b1[i] : 0.f;
    }
    for (int i = threadIdx.x; i < 9 * kN; i += kThreads) {
      const int nb = i / kN, c = i - nb * kN;
      kdq_s[i] = c < C ? kdq[nb * C + c] : 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);   // the TMA's bytes
      mbar_init(&empty[s], 4);  // the warps of the box's warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&hq_full[i], kBuilders / 32);          // each builder warp
      mbar_init(&hq_empty[i], kConsumerThreads / 32);  // each consumer warp
    }
    if constexpr (!kTiled) {
      mbar_init(&g_full[0], 1);
      mbar_init(&g_full[1], 1);
      mbar_init(g_edge_free, kBuilders / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---------------- producer: one thread streams the weight boxes (and
    // in form 1 the g rows), three warps build hq one neighbour ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kRegsProducer));
    if (threadIdx.x >= kConsumerThreads + 32) {
      const int bt = threadIdx.x - kConsumerThreads - 32;
      if constexpr (!kTiled) {
        // This thread's 8 channels [ch, ch + 8), for pixels p0 + kPixGroups
        // i, from the staged rows (row entry i is pixel w0 - 1 + i; pixels
        // outside the image are the TMA's zeros).
        constexpr int kPixGroups = kBuilders / (kN / 8);
        constexpr int kPixSteps = (kTileP + kPixGroups - 1) / kPixGroups;
        const int ch = (bt % (kN / 8)) * 8;
        const int p0 = bt / (kN / 8);
        const bool ch_ok = ch < C;
        float sa0[8], sb0[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sa0[e] = a0_s[ch + e];
          sb0[e] = b0_s[ch + e];
        }
        const T* gc_row = reinterpret_cast<const T*>(g_mid) + C + ch;
        mbar_wait(&g_full[0], 0);
        for (int nb = 0; nb < 9; ++nb) {
          const int buf = nb & 1;
          if (nb >= 2) mbar_wait(&hq_empty[buf], ((nb >> 1) - 1) & 1);
          uint8_t* dst = hq + buf * hq_bytes;
          const int dy = nb / 3;
          const int dx = nb - dy * 3;
          if (nb == 0 || nb == 6) mbar_wait(&g_full[1], nb == 6);
          const T* gs_row = reinterpret_cast<const T*>(dy == 1 ? g_mid : g_edge) + dx * C + ch;
#pragma unroll 2
          for (int i = 0; i < kPixSteps; ++i) {
            const int p = p0 + kPixGroups * i;
            if (p >= kTileP) break;
            uint4 gc[kV], gs[kV];
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              gc[v] = ch_ok ? reinterpret_cast<const uint4*>(gc_row + p * C)[v]
                            : make_uint4(0, 0, 0, 0);
              gs[v] = ch_ok ? reinterpret_cast<const uint4*>(gs_row + p * C)[v]
                            : make_uint4(0, 0, 0, 0);
            }
            *reinterpret_cast<uint2*>(dst + sw128(p, ch)) = hq8<T>(gc, gs, sa0, sb0);
          }
          fence_proxy_async();
          __syncwarp();
          if ((threadIdx.x & 31) == 0) {
            mbar_arrive(&hq_full[buf]);
            if (nb == 2) mbar_arrive(g_edge_free);  // row h - 1 is read
          }
        }
      } else {
        // Build u of hq: slab sl's channels [c0, c0 + 8 ng), items (pixel
        // p, 8-channel group cg) of the tile, bt + 96 i in order, read from
        // g in L2; zeros outside the image.
        int u = 0;
        for (int nb = 0; nb < 9; ++nb) {
          // One build a neighbour, or one a chunk and slab of k.
          for (int jb = 0; jb < (nslab == 1 ? 1 : nchunks); ++jb) {
            for (int sl = 0; sl < nslab; ++sl, ++u) {
              const int c0 = sl * slab * kKBlock;
              const int ng = min(C - c0, slab * kKBlock) / 8;
              const int buf = u & (nbuf - 1);  // nbuf is 1 or 2
              if (u >= nbuf) mbar_wait(&hq_empty[buf], ((u >> (nbuf - 1)) - 1) & 1);
              uint8_t* dst = hq + buf * hq_bytes;
              const int dy = nb / 3;
              const int dx = nb - dy * 3;
              const int hs = h + dy - 1;
              const bool row_ok = hs >= 0 && hs < H;
              auto load = [&](int p, int cg, uint4 (&gc)[kV], uint4 (&gs)[kV]) {
                const int w = w0 + p;
                const int ws = w + dx - 1;
                const bool c_ok = w < W;
                const bool s_ok = c_ok && row_ok && ws >= 0 && ws < W;
                const uint4* cp = reinterpret_cast<const uint4*>(
                    g + ((img + h) * W + (c_ok ? w : 0)) * C + c0 + 8 * cg);
                const uint4* sp = reinterpret_cast<const uint4*>(
                    g + ((img + (s_ok ? hs : h)) * W + (s_ok ? ws : 0)) * C + c0 + 8 * cg);
#pragma unroll
                for (int v = 0; v < kV; ++v) {
                  gc[v] = c_ok ? __ldg(cp + v) : make_uint4(0, 0, 0, 0);
                  gs[v] = s_ok ? __ldg(sp + v) : make_uint4(0, 0, 0, 0);
                }
              };
              auto build = [&](int p, int cg, const uint4 (&gc)[kV], const uint4 (&gs)[kV]) {
                float sa0[8], sb0[8];
                const float4* ap = reinterpret_cast<const float4*>(a0 + c0 + 8 * cg);
                const float4* bp = reinterpret_cast<const float4*>(b0 + c0 + 8 * cg);
                *reinterpret_cast<float4*>(sa0) = __ldg(ap);
                *reinterpret_cast<float4*>(sa0 + 4) = __ldg(ap + 1);
                *reinterpret_cast<float4*>(sb0) = __ldg(bp);
                *reinterpret_cast<float4*>(sb0 + 4) = __ldg(bp + 1);
                *reinterpret_cast<uint2*>(dst + sw128(p, 8 * cg)) = hq8<T>(gc, gs, sa0, sb0);
              };
              auto next = [&](int& p, int& cg) {
                cg += kBuilders;
                while (cg >= ng) {
                  cg -= ng;
                  ++p;
                }
              };
              int p = bt / ng, cg = bt - (bt / ng) * ng;
              while (p < kTileP) {
                if constexpr (kV == 1) {
                  // bf16: two items a step, both loads in flight.
                  int p2 = p, cg2 = cg;
                  next(p2, cg2);
                  uint4 gc0[kV], gs0[kV], gc1[kV], gs1[kV];
                  load(p, cg, gc0, gs0);
                  if (p2 < kTileP) load(p2, cg2, gc1, gs1);
                  build(p, cg, gc0, gs0);
                  if (p2 < kTileP) build(p2, cg2, gc1, gs1);
                  p = p2;
                  cg = cg2;
                } else {
                  // fp32: one item a step (two spill at 72 registers).
                  uint4 gc0[kV], gs0[kV];
                  load(p, cg, gc0, gs0);
                  build(p, cg, gc0, gs0);
                }
                next(p, cg);
              }
              fence_proxy_async();
              __syncwarp();
              if ((threadIdx.x & 31) == 0) mbar_arrive(&hq_full[buf]);
            }
          }
        }
      }
    } else if (threadIdx.x == kConsumerThreads) {
      // Form 1: g rows h and h - 1 (row entry i is pixel w0 - 1 + i), then
      // h + 1 once the builders are past neighbour 2. Per neighbour and
      // chunk j of z: W1^T's boxes of the chunk (k-block kb, warpgroup wg's
      // columns), then K_n^T's of the chunk's k rows (wg's columns of the
      // output tile).
      const int row_bytes = kRowPix * C * (int)sizeof(T);
      if constexpr (!kTiled) {
        mbar_arrive_tx(&g_full[0], row_bytes);
        tma_load_4d(g_mid, &gmap, &g_full[0], 0, w0 - 1, h, b);
        mbar_arrive_tx(&g_full[1], row_bytes);
        tma_load_4d(g_edge, &gmap, &g_full[1], 0, w0 - 1, h - 1, b);
      }
      int i = 0;
      auto put = [&](const CUtensorMap* map, int bytes, int c0, int c1, int c2) {
        const int s = i % kS;
        const int lap = i / kS;
        if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
        mbar_arrive_tx(&full[s], bytes);
        tma_load_3d(ring + s * L::kSlot, map, &full[s], c0, c1, c2);
        ++i;
      };
      for (int nb = 0; nb < 9; ++nb) {
        if (!kTiled && nb == 4) {
          mbar_wait(g_edge_free, 0);
          mbar_arrive_tx(&g_full[1], row_bytes);
          tma_load_4d(g_edge, &gmap, &g_full[1], 0, w0 - 1, h + 1, b);
        }
        for (int j0 = 0; j0 < (kTiled ? C : 1); j0 += L::kZ) {
          for (int kb = 0; kb < nkb1; ++kb)
            for (int wg = 0; wg < 2; ++wg)
              put(&w1map, L::kW1Box, kb * kKBlock, j0 + wg * kZHalf, 0);
          for (int kb = 0; kb < L::kZ / kKBlock; ++kb)
            for (int wg = 0; wg < 2; ++wg)
              put(&kmap, L::kKBox, j0 + kb * kKBlock, n0 + wg * kHalf, nb);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns output columns
    // [n0 + kHalf wg, n0 + kHalf (wg + 1)) and columns [kZHalf wg, kZHalf
    // (wg + 1)) of each chunk of z.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kRegsConsumer));
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int m0 = (t / 32) * 16 + (lane >> 2);  // this thread's rows: m0, m0 + 8
    const int tig = lane & 3;
    const uint32_t ring_u32 = smem_u32(ring);
    constexpr int kJ = kZHalf / 8;  // 8-column groups of a warpgroup's chunk
    // The epilogue's shifted feats, two groups a step, kD steps ahead
    // (form 2: one, beside its three sets of registers).
    constexpr int kSteps = kJ / 2;
    constexpr int kD = kTiled ? 1 : 2;
    using V = typename Fs::V;

    float acc[kHalf / 2];
    int d[kHalf / 2];  // form 1: z, then d = pq @ K_n; form 2: d
    int zt[kTiled ? kZHalf / 2 : 1];
    auto& z = z_regs<kTiled>(zt, d);  // form 1: d's registers
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) {
      acc[i] = 0.f;
      d[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < (kTiled ? kZHalf / 2 : 1); ++i) zt[i] = 0;

    int cnt = 0;  // this warpgroup's ring boxes so far
    int pqt = 0;  // form 2: chunks so far (pq tile pqt % 2)
    int u = 0;    // hq builds read to their end so far (buffer u & (nbuf - 1))
    for (int nb = 0; nb < 9; ++nb) {
      const int dy = nb / 3;
      const int dx = nb - dy * 3;
      const int hs = h + dy - 1;
      const bool row_ok = hs >= 0 && hs < H;
      // This thread's shifted feats rows (pixels m0, m0 + 8 of the tile).
      const T* fp[2];
      bool fok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int w = w0 + m0 + 8 * r;
        const int ws = w + dx - 1;
        fok[r] = w < W && row_ok && ws >= 0 && ws < W;
        fp[r] = f + (fok[r] ? ((img + hs) * W + ws) * C : 0) + wg * kZHalf + tig * 2;
      }

      for (int j = 0; j < nchunks; ++j) {
        const int j0 = j * L::kZ;  // the chunk's first column of z
        V fq[kD + 1][2][2];
        auto load_step = [&](int st, V (&dst)[2][2]) {
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            const int col = j0 + wg * kZHalf + (2 * st + gi) * 8;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              dst[gi][r] = fok[r] && col < C ? Fs::load(fp[r] + j0 + (2 * st + gi) * 8)
                                             : Fs::zero();
          }
        };
#pragma unroll
        for (int st = 0; st < kD; ++st) load_step(st, fq[st]);

        // 1. z_j = hq @ W1[:, chunk j] (int32), this warpgroup's columns,
        // over K = C a slab of k at a time; a build is free after its last
        // read (form 1: after GEMM2, which reads pq over it).
        for (int sl = 0; sl < nslab; ++sl) {
          const int buf = u & (nbuf - 1);
          if (nslab > 1 || j == 0) mbar_wait(&hq_full[buf], (u >> (nbuf - 1)) & 1);
          ring_gemm<kS, L::kSlot>(z, smem_u32(hq) + buf * hq_bytes,
                                  min(slab, nkb1 - sl * slab), sl > 0, cnt, wg, full, empty,
                                  ring_u32);
          if (kTiled && (nslab > 1 || j == nchunks - 1)) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&hq_empty[buf]);
            ++u;
          }
        }
        uint8_t* pq_b;
        if constexpr (kTiled) {
          pq_b = pq + (pqt & 1) * kAtomBytes;
        } else {
          consumer_sync();  // both warpgroups' GEMM1 has read hq: pq goes over it
          pq_b = hq + (u & 1) * hq_bytes;
        }

        // 2. pq_j = clip(rint(relu(a1 float(z) + b1) * fs), +-127), in the
        // A layout, zeros past C.
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          if (st + kD < kSteps) load_step(st + kD, fq[(st + kD) % (kD + 1)]);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            const int jj = 2 * st + gi;
            const int nl = wg * kZHalf + jj * 8 + tig * 2;  // column in the chunk
            const int n = j0 + nl;
            float2 s1, t1;
            if constexpr (kTiled) {
              const bool ok = n < C;
              s1 = ok ? __ldg(reinterpret_cast<const float2*>(a1 + n)) : make_float2(0.f, 0.f);
              t1 = ok ? __ldg(reinterpret_cast<const float2*>(b1 + n)) : make_float2(0.f, 0.f);
            } else {
              s1 = *reinterpret_cast<const float2*>(a1_s + n);
              t1 = *reinterpret_cast<const float2*>(b1_s + n);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int za = z[4 * jj + 2 * r], zb = z[4 * jj + 2 * r + 1];
              const float fa = kTiled ? int_to_float_rn(za) : small_int_to_float(za);
              const float fb = kTiled ? int_to_float_rn(zb) : small_int_to_float(zb);
              const float pa = fmaxf(__fadd_rn(__fmul_rn(fa, s1.x), t1.x), 0.f);
              const float pb = fmaxf(__fadd_rn(__fmul_rn(fb, s1.y), t1.y), 0.f);
              const V fs = fq[st % (kD + 1)][gi][r];
              const float qa = fminf(fmaxf(__fmul_rn(pa, Fs::lo(fs)), -127.f), 127.f);
              const float qb = fminf(fmaxf(__fmul_rn(pb, Fs::hi(fs)), -127.f), 127.f);
              *reinterpret_cast<uint16_t*>(pq_b + sw128(m0 + 8 * r, nl)) =
                  static_cast<uint16_t>(low_bytes(rint_i8_bits(qa), rint_i8_bits(qb)));
            }
          }
          asm volatile("" ::: "memory");
        }
        fence_proxy_async();
        consumer_sync();

        // 3. d (+)= pq_j @ K_n[chunk j's k, this warpgroup's columns].
        if constexpr (kTiled) {
          ring_gemm<kS, L::kSlot>(d, smem_u32(pq_b), 1, j > 0, cnt, wg, full, empty, ring_u32);
          ++pqt;
        } else {
          ring_gemm<kS, L::kSlot>(d, smem_u32(pq_b), kN / kKBlock, false, cnt, wg, full, empty,
                                  ring_u32);
          __syncwarp();
          if (lane == 0) mbar_arrive(&hq_empty[u & 1]);
          ++u;
        }
      }

      // 4. acc += float(d) * kdq[n], in neighbour order.
#pragma unroll
      for (int jj = 0; jj < kHalf / 8; ++jj) {
        const int n = wg * kHalf + jj * 8 + tig * 2;  // column in the tile
        float2 q;
        if constexpr (kTiled) {
          q = n0 + n < C ? __ldg(reinterpret_cast<const float2*>(kdq + nb * C + n0 + n))
                         : make_float2(0.f, 0.f);
        } else {
          q = *reinterpret_cast<const float2*>(kdq_s + nb * kN + n);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int da = d[4 * jj + 2 * r], db = d[4 * jj + 2 * r + 1];
          const float fa = kTiled ? int_to_float_rn(da) : small_int_to_float(da);
          const float fb = kTiled ? int_to_float_rn(db) : small_int_to_float(db);
          acc[4 * jj + 2 * r] = __fadd_rn(acc[4 * jj + 2 * r], __fmul_rn(fa, q.x));
          acc[4 * jj + 2 * r + 1] = __fadd_rn(acc[4 * jj + 2 * r + 1], __fmul_rn(fb, q.y));
        }
      }
    }

    // Store this thread's accumulator rows and its columns below C.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int w = w0 + m0 + 8 * r;
      if (w >= W) continue;
      float* op = out + ((img + h) * W + w) * C + n0 + wg * kHalf + tig * 2;
#pragma unroll
      for (int jj = 0; jj < kHalf / 8; ++jj)
        if (n0 + wg * kHalf + jj * 8 < C)
          *reinterpret_cast<float2*>(op + jj * 8) =
              make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
}

template <typename T, int kN, bool kTiled>
int launch_tiles(const void* g, const void* feats, const void* w1t, const void* kt,
                 const void* a0, const void* b0, const void* a1, const void* b1,
                 const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  using L = Tl<T, kN, kTiled>;
  CUtensorMap w1map, kmap, gmap;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!stem_weight_map(&w1map, kU8, 1, w1t, C, L::kZHalf, 1) ||
      !stem_weight_map(&kmap, kU8, 1, kt, C, L::kHalf, 9))
    return (int)cudaErrorInvalidValue;
  if constexpr (kTiled) {
    gmap = w1map;  // unread
  } else if (!row_map(&gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, B, H, W, C)) {
    return (int)cudaErrorInvalidValue;
  }
  // Form 2's hq: a neighbour's whole tile in two buffers where they fit
  // (C <= 1152), else in one (C <= 2304), else two buffers of slabs.
  int nbuf = 2, slab = 0;
  if constexpr (kTiled) {
    const int room = (kMaxSmem - L::kFixedSmem) / kAtomBytes;
    const int nkb = (C + kKBlock - 1) / kKBlock;
    nbuf = 2 * nkb <= room || nkb > room ? 2 : 1;
    slab = nkb <= room / nbuf ? nkb : room / 2;
  }
  const int smem = L::kFixedSmem + nbuf * slab * kAtomBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(meta_kernel_fused_i8_tiles<T, kN, kTiled>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (C + kN - 1) / kN;
  const dim3 grid((W + kTileP - 1) / kTileP, H, B * tiles);
  meta_kernel_fused_i8_tiles<T, kN, kTiled><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      w1map, kmap, gmap, (const T*)g, (const T*)feats, (const float*)a0, (const float*)b0,
      (const float*)a1, (const float*)b1, (const float*)kdq, (float*)out, H, W, C, tiles,
      nbuf, slab);
  return (int)cudaGetLastError();
}

}  // namespace

// g, feats: (B, H, W, C) bf16; w1t: (C, C) int8 = W1^T; kt: (9, C, C) int8
// with kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; kdq: (9, C) fp32;
// out: (B, H, W, C) fp32. C must be a multiple of 16 up to 256 (C <= 128
// runs the 128-wide instance, the rest the 256-wide one); g, feats, w1t
// and kt 16-byte aligned.
extern "C" int rv3d_meta_kernel_fused_i8(
    const void* g, const void* feats, const void* w1t, const void* kt,
    const void* a0, const void* b0, const void* a1, const void* b1,
    const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  if (C <= 0 || C % 16 || C > kMaxC || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  return C <= 128
             ? launch<128>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, stream)
             : launch<256>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H, W, C, stream);
}

// The output-tiled kernel. g, feats: (B, H, W, C), bf16 (fp32 == 0) or
// fp32 (fp32 != 0); w1t: (C, C) int8 = W1^T; kt: (9, C, C) int8 with
// kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; kdq: (9, C) fp32; out: (B, H,
// W, C) fp32. C a multiple of 16; form 1 (tiled == 0): fp32, C <= 256 (C
// <= 128 runs the 128-wide instance, the rest the 256-wide one); form 2
// (tiled != 0): either dtype, any C with B * ceil(C / 256) <= 65535. H <=
// 65535; g, feats, w1t and kt 16-byte aligned.
extern "C" int rv3d_meta_kernel_fused_i8_tiles(
    const void* g, const void* feats, const void* w1t, const void* kt,
    const void* a0, const void* b0, const void* a1, const void* b1,
    const void* kdq, void* out, int B, int H, int W, int C, int fp32, int tiled,
    void* stream) {
  if (C <= 0 || C % 16 || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      (long)B * ((C + 255) / 256) > 65535 || (!tiled && (!fp32 || C > kMaxC)))
    return (int)cudaErrorInvalidValue;
  if (tiled)
    return fp32 ? launch_tiles<float, 256, true>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out,
                                                 B, H, W, C, stream)
                : launch_tiles<__nv_bfloat16, 256, true>(g, feats, w1t, kt, a0, b0, a1, b1,
                                                         kdq, out, B, H, W, C, stream);
  return C <= 128 ? launch_tiles<float, 128, false>(g, feats, w1t, kt, a0, b0, a1, b1, kdq,
                                                    out, B, H, W, C, stream)
                  : launch_tiles<float, 256, false>(g, feats, w1t, kt, a0, b0, a1, b1, kdq,
                                                    out, B, H, W, C, stream);
}
