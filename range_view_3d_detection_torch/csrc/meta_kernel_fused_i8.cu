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
//   wrapper pads a bf16 C that is not a multiple of 16 with zero channels;
//   fp32 g and feats and C above 256 take the tiled kernel at the end of
//   this file.
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

// ---------------- The tiled kernel: any C, g and feats in bf16 or fp32.
//
// The wgmma instances above take bf16 g through a TMA row map and C a
// multiple of 16 up to 256 (their z and accumulator live in registers).
// The wrapper sends this kernel fp32 g and feats (an int8 model quantized
// from fp32: x0 = g(p + d) - g(p) and p * feats are fp32 there, as in
// stem_pallas.py:97-107) and C above 256; it also takes bf16 at any C.
//
// Bound: two C x C integer products a neighbour and pixel, here on the
// CUDA cores (dp4a, four int8 products a lane and instruction), besides
// the quantize work per element.
//
// Design (a simple tiled dp4a kernel, K1's tiled kernel in int8):
// - A block owns a tile of output channels kTN wide (64 where C <= 64,
//   else 256; the grid's z walks B x ceil(C / kTN) tiles) for 1024 / (kTN
//   / 8) pixels of one row (128 or 32). Per neighbour it loops over
//   kTN-wide chunks j of z: z_j = hq @ W1[:, j] over K = C in steps of 4
//   kTKW channels (64, or 32 in the 64-wide instance, whose 128-pixel
//   stage holds as many g values), hq built from g as it is staged; then
//   pq_j =
//   clip(rint(relu(a1 float(z_j) + b1) * fs), +-127) into shared memory;
//   then d += pq_j @ K_n[j, tile] in int32. After the chunks, acc +=
//   float(d) * kdq[n], so the neighbour's sum is one exact integer before
//   it meets the fp32 accumulator, as in the twin.
// - 256 threads, each 4 pixels x 8 channels (two runs of 4, kTN / 2
//   apart) of z, d and the accumulator; operands are int8 quadruples along
//   K (one 32-bit word), from shared memory as 16-byte loads. The stages
//   are double-buffered, and each thread's share of the next stage is
//   loaded into registers while the current one is multiplied (K1's tiled
//   kernel's pipeline).
// - The twin's arithmetic step for step (__fmul_rn/__fadd_rn, rint half
//   to even by __float2int_rn, exact int32 sums; float(z) and float(d)
//   round as the twin's fp64 -> fp32 conversion of the same integer), so
//   it equals kernels/stem.py::meta_kernel_fused_i8_plain bit for bit.
constexpr int kTThreads = 256;

// The tile of the kTN-wide instance: kTX threads across its channels,
// kTY thread rows of 4 pixels each.
template <int kTN>
struct Tile {
  static constexpr int kTX = kTN / 8;
  static constexpr int kTY = kTThreads / kTX;
  static constexpr int kTP = 4 * kTY;      // pixels of one row per block
  static constexpr int kTKW = kTN == 64 ? 8 : 16;  // words (4 channels) of K a stage
  static constexpr int kAW = kTKW + 4;     // row stride of the hq tile [kTP][kAW]
  static constexpr int kBW = kTN + 4;      // row stride of a weight stage [kTKW][kBW]
  static constexpr int kPW = kTN / 4 + 4;  // row stride of the pq tile [kTP][kPW]
  static constexpr int kNA = kTP * kTKW / kTThreads;  // hq words a thread stages
  static constexpr int kNB = kTN * kTKW / kTThreads;  // weight words a thread stages
  // Output channel of a thread's q-th column (q < 8).
  static __device__ __forceinline__ int col(int q, int tx) {
    return (q >> 2) * (kTN / 2) + tx * 4 + (q & 3);
  }
};

// Bytes p[0 .. min(avail, 4)) as one word (zeros past avail), low byte
// first.
__device__ __forceinline__ int load_s8x4(const int8_t* p, int avail) {
  if (avail >= 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const int*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < avail) v |= (uint32_t)(uint8_t)__ldg(p + e) << (8 * e);
  return (int)v;
}

// d[i][q] += sum_kw dp4a(a[(4 ty + i) as + kw], b[kw kBW + Tile::col(q)]),
// kw < kTKW.
template <int kTN>
__device__ __forceinline__ void dp4a_tile(int (&d)[4][8], const int* a, int as,
                                          const int* b, int ty, int tx) {
  constexpr int kBW = Tile<kTN>::kBW, kTKW = Tile<kTN>::kTKW;
  // One group of 4 k at a time: its 16-byte operand loads, no more, are
  // live beside the accumulators and the next stage's prefetched elements.
#pragma unroll 1
  for (int k4 = 0; k4 < kTKW; k4 += 4) {
    int4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const int4*>(a + (4 * ty + i) * as + k4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int4 lo = *reinterpret_cast<const int4*>(b + (k4 + u) * kBW + tx * 4);
      const int4 hi = *reinterpret_cast<const int4*>(b + (k4 + u) * kBW + kTN / 2 + tx * 4);
      const int bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ai = lane4(av[i], u);
#pragma unroll
        for (int q = 0; q < 8; ++q) d[i][q] = __dp4a(ai, bv[q], d[i][q]);
      }
    }
  }
}

// A thread's share of one weight stage, words (kw, n) = wt[(c0 + n) C + k0
// + 4 kw ..][+4] for kw < kTKW, n < kTN (wt is [n][k]), into registers;
// zeros past C in either index. Sixteen neighbouring threads read one
// row's 64 consecutive bytes.
template <int kTN>
__device__ __forceinline__ void fetch_weights(int (&wr)[Tile<kTN>::kNB], const int8_t* wt,
                                              int C, int k0, int c0, int tid) {
  constexpr int kTKW = Tile<kTN>::kTKW;
  const int kb = k0 + 4 * (tid % kTKW);
#pragma unroll
  for (int r = 0; r < Tile<kTN>::kNB; ++r) {
    const int col = c0 + tid / kTKW + r * (kTThreads / kTKW);
    wr[r] = col < C ? load_s8x4(wt + (size_t)col * C + kb, C - kb) : 0;
  }
}

// The same share, from registers into a weight stage [kTKW][kBW].
template <int kTN>
__device__ __forceinline__ void store_weights(int* b_s, const int (&wr)[Tile<kTN>::kNB],
                                              int tid) {
  constexpr int kTKW = Tile<kTN>::kTKW;
#pragma unroll
  for (int r = 0; r < Tile<kTN>::kNB; ++r)
    b_s[(tid % kTKW) * Tile<kTN>::kBW + tid / kTKW + r * (kTThreads / kTKW)] = wr[r];
}

template <typename T, int kTN>
__global__ void __launch_bounds__(kTThreads, 1)
    meta_kernel_fused_i8_tiled(const T* __restrict__ g, const T* __restrict__ f,
                               const int8_t* __restrict__ w1t,
                               const int8_t* __restrict__ kt,
                               const float* __restrict__ a0, const float* __restrict__ b0,
                               const float* __restrict__ a1, const float* __restrict__ b1,
                               const float* __restrict__ kdq, float* __restrict__ out,
                               int H, int W, int C, int tiles) {
  using Tl = Tile<kTN>;
  constexpr int kTP = Tl::kTP, kPW = Tl::kPW, kNA = Tl::kNA;
  constexpr int kTKW = Tl::kTKW, kAW = Tl::kAW;
  constexpr int kA = kTP * kAW, kB = kTKW * Tl::kBW;
  __shared__ __align__(16) int a_s[2 * kA];        // hq words: 2 x [kTP][kAW]
  __shared__ __align__(16) int b_s[2 * kB];        // weight words: 2 x [kTKW][kBW]
  __shared__ __align__(16) int p_s[kTP * kPW];     // pq words of chunk j: [kTP][kPW]
  const int tid = threadIdx.x, tx = tid % Tl::kTX, ty = tid / Tl::kTX;
  // Stage s writes buffer s % 2 (counted across both products), then one
  // barrier, then the products read it (K1's tiled kernel's order).
  int par = 0;
  float ga[kNA][4], gb[kNA][4];  // the next stage's g(p), g(p + d)
  int wr[Tl::kNB];               // and its weight words
  const int w0 = blockIdx.x * kTP, h = blockIdx.y;
  const int b = blockIdx.z / tiles, n0 = (blockIdx.z % tiles) * kTN;
  const size_t img = (size_t)b * H;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  for (int nb = 0; nb < 9; ++nb) {
    const int dy = nb / 3, dx = nb - 3 * (nb / 3);
    const int hs = h + dy - 1;
    const bool row_ok = hs >= 0 && hs < H;
    const int8_t* kn = kt + (size_t)nb * C * C;
    int d[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) d[i][q] = 0;
    for (int j0 = 0; j0 < C; j0 += kTN) {
      // 1. z_j = hq @ W1[:, j0 : j0 + kTN], hq = min(rint(relu(a0 x0 + b0)),
      // 127) with x0 = T(g(p + d) - g(p)).
      int z[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) z[i][q] = 0;
      auto fetch1 = [&](int k0) {
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          const int idx = tid + a * kTThreads;
          const int w = w0 + idx / kTKW, ws = w + dx - 1;
          const bool s_ok = row_ok && ws >= 0 && ws < W;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + 4 * (idx % kTKW) + e;
            const bool ok = c < C && w < W;
            ga[a][e] = ok ? ld_elem(g + ((img + h) * W + w) * C + c) : 0.f;
            gb[a][e] = ok && s_ok ? ld_elem(g + ((img + hs) * W + ws) * C + c) : 0.f;
          }
        }
        fetch_weights<kTN>(wr, w1t, C, k0, j0, tid);
      };
      const int steps1 = (C + 4 * kTKW - 1) / (4 * kTKW);
      fetch1(0);
      for (int st = 0; st < steps1; ++st, par ^= 1) {
        int* a_b = a_s + par * kA;
        int* b_b = b_s + par * kB;
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          const int idx = tid + a * kTThreads;
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = st * 4 * kTKW + 4 * (idx % kTKW) + e;
            if (c < C) {
              const float x0 = round_to<T>(__fsub_rn(gb[a][e], ga[a][e]));
              const float hv =
                  fmaxf(__fadd_rn(__fmul_rn(x0, __ldg(a0 + c)), __ldg(b0 + c)), 0.f);
              word |= (uint32_t)(__float2int_rn(fminf(hv, 127.f)) & 0xff) << (8 * e);
            }
          }
          a_b[(idx / kTKW) * kAW + idx % kTKW] = (int)word;
        }
        store_weights<kTN>(b_b, wr, tid);
        __syncthreads();
        if (st + 1 < steps1) fetch1((st + 1) * 4 * kTKW);
        dp4a_tile<kTN>(z, a_b, kAW, b_b, ty, tx);
      }

      // 2. pq_j = clip(rint(relu(a1 float(z) + b1) * fs), +-127), zero past
      // C and outside the image.
      float s1[8], t1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = j0 + Tl::col(q, tx);
        s1[q] = col < C ? __ldg(a1 + col) : 0.f;
        t1[q] = col < C ? __ldg(b1 + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * ty + i, w = w0 + p, ws = w + dx - 1;
        const bool ok = w < W && row_ok && ws >= 0 && ws < W;
        uint32_t word[2] = {0, 0};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = j0 + Tl::col(q, tx);
          const float fs =
              ok && col < C ? ld_elem(f + ((img + hs) * W + ws) * C + col) : 0.f;
          const float pv =
              fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(z[i][q]), s1[q]), t1[q]), 0.f);
          const float qv = fminf(fmaxf(__fmul_rn(pv, fs), -127.f), 127.f);
          word[q >> 2] |= (uint32_t)(__float2int_rn(qv) & 0xff) << (8 * (q & 3));
        }
        p_s[p * kPW + tx] = (int)word[0];
        p_s[p * kPW + kTN / 8 + tx] = (int)word[1];
      }

      // 3. d += pq_j @ K_n[j0 : j0 + kTN, n0 : n0 + kTN] (int32; the
      // barrier of its first stage also publishes pq_j).
      const int steps2 = ((min(kTN, C - j0) + 3) / 4 + kTKW - 1) / kTKW;
      fetch_weights<kTN>(wr, kn, C, j0, n0, tid);
      for (int st = 0; st < steps2; ++st, par ^= 1) {
        int* b_b = b_s + par * kB;
        store_weights<kTN>(b_b, wr, tid);
        __syncthreads();
        if (st + 1 < steps2) fetch_weights<kTN>(wr, kn, C, j0 + 4 * kTKW * (st + 1), n0, tid);
        dp4a_tile<kTN>(d, p_s + st * kTKW, kPW, b_b, ty, tx);
      }
    }
    // 4. acc += float(d) * kdq[n], in neighbour order.
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = n0 + Tl::col(q, tx);
      const float s = col < C ? __ldg(kdq + nb * C + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(__int2float_rn(d[i][q]), s));
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = w0 + 4 * ty + i;
    if (w >= W) continue;
    float* op = out + ((img + h) * W + w) * C;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = n0 + Tl::col(q, tx);
      if (col < C) op[col] = acc[i][q];
    }
  }
}

template <typename T, int kTN>
int launch_tiled(const void* g, const void* feats, const void* w1t, const void* kt,
                 const void* a0, const void* b0, const void* a1, const void* b1,
                 const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  const int tiles = (C + kTN - 1) / kTN;
  const dim3 grid((W + Tile<kTN>::kTP - 1) / Tile<kTN>::kTP, H, B * tiles);
  meta_kernel_fused_i8_tiled<T, kTN><<<grid, kTThreads, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)feats, (const int8_t*)w1t, (const int8_t*)kt,
      (const float*)a0, (const float*)b0, (const float*)a1, (const float*)b1,
      (const float*)kdq, (float*)out, H, W, C, tiles);
  return (int)cudaGetLastError();
}

// The 64-wide instance where C <= 64, the 256-wide one past it.
template <typename T>
int launch_tiled_any(const void* g, const void* feats, const void* w1t, const void* kt,
                     const void* a0, const void* b0, const void* a1, const void* b1,
                     const void* kdq, void* out, int B, int H, int W, int C,
                     void* stream) {
  return C <= 64 ? launch_tiled<T, 64>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H,
                                       W, C, stream)
                 : launch_tiled<T, 256>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B, H,
                                        W, C, stream);
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

// The tiled kernel. g, feats: (B, H, W, C), bf16 (fp32 == 0) or fp32
// (fp32 != 0); w1t: (C, C) int8 = W1^T; kt: (9, C, C) int8 with kt[n] =
// K_n^T; a0, b0, a1, b1: (C,) fp32; kdq: (9, C) fp32; out: (B, H, W, C)
// fp32. Any C >= 1 with B * ceil(C / 256) <= 65535 and H <= 65535 (C <= 64
// runs the 64-wide instance, the rest the 256-wide one).
extern "C" int rv3d_meta_kernel_fused_i8_tiled(
    const void* g, const void* feats, const void* w1t, const void* kt,
    const void* a0, const void* b0, const void* a1, const void* b1,
    const void* kdq, void* out, int B, int H, int W, int C, int fp32, void* stream) {
  if (C <= 0 || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      (long)B * ((C + 255) / 256) > 65535)
    return (int)cudaErrorInvalidValue;
  return fp32 ? launch_tiled_any<float>(g, feats, w1t, kt, a0, b0, a1, b1, kdq, out, B,
                                        H, W, C, stream)
              : launch_tiled_any<__nv_bfloat16>(g, feats, w1t, kt, a0, b0, a1, b1, kdq,
                                                out, B, H, W, C, stream);
}
