// Fused eval MetaKernel stem (K1) for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces range_view_3d_detection_tpu/kernels/stem_pallas.py::
// meta_kernel_fused (_stem_kernel). Per pixel p of a (B, H, W, C) image:
//
//   geo(p) = sum_n [ bf16(relu(a1 * (bf16(relu(a0 * x0_n + b0)) @ W1) + b1))
//                    * fs_n ] @ K_n,       x0_n = bf16(g(p + d_n) - g(p)),
//
// over the 3x3 neighbours d_n (dy-major). Out-of-image neighbours read
// zeros for both g and feats (the Pallas kernel's zero column shift and
// zeroed edge rows). The bf16 rounding points are the Pallas kernel's, and
// those of the plain twin (kernels/stem.py::meta_kernel_fused_plain).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W) at B=2, 64x1808, C=256:
// two C x C GEMMs per neighbour and pixel, 5.46e11 flop, 0.552 ms at 989
// TFLOP/s bf16; the bytes (g and feats read once, fp32 out written once,
// 474 MB) take 0.14 ms. So the operations bound it. But every block needs
// all of W1 and the nine K_n (1.25 MB bf16) for every neighbour: at 64
// pixels a block that is 2.36 MB a block, 8.8 GB of L2 reads a call (3712
// blocks), and a shared-memory hh/pf tile has to be built between the
// GEMMs of every neighbour.
//
// Design, from that:
// - In bf16, C is any multiple of 8 up to 256 (the configs' META stems are
//   256, 128 and 32 wide; the TMA's global strides and the 16-byte g loads
//   need C % 8 == 0). The kernel is a template over a padded width Cp, 128
//   (C <= 128) or 256: the weight boxes, the hh/pf tile and the
//   accumulators are Cp wide, and channels C..Cp-1 are zeros (the TMA
//   fills the weights outside the C x C matrices with zeros, hh and pf
//   there are relu(0 * 0 + 0) with zero BN affines, and they are not
//   stored). The wrapper pads a bf16 C that is not a multiple of 8 with
//   zero channels; fp32 g and feats and C above 256 take the tiled kernel
//   at the end of this file.
// - A block owns 64 pixels of one row and all Cp output channels and loops
//   over the 9 neighbours. Two consumer warpgroups split the output
//   channels: warpgroup j owns columns [j Cp/2, (j + 1) Cp/2) of both z and
//   the accumulator, Cp/4 + Cp/4 fp32 registers a thread (wgmma m64nNk16
//   with N = Cp/2, bf16 in, fp32 accumulate, A and B from shared memory).
// - The weights arrive by TMA as W1^T and K_n^T ([n][k] bf16), in boxes of
//   64 k x Cp n (128-byte swizzle: the K-major layout a wgmma descriptor
//   reads), through a 4-stage mbarrier ring fed by one thread of the
//   producer warpgroup. A neighbour is 2 Cp / 64 boxes (W1^T, then K_n^T),
//   so the ring runs straight across neighbours and GEMMs; each stage is
//   released as soon as the wgmma group that read it has retired
//   (wait_group 1). Warpgroup j's B descriptor starts at its half of the
//   box.
// - What limits it, measured by chip_probe_k1.py at C = 256: with the
//   consumers building hh themselves, a neighbour took hh build 2.8 us,
//   GEMM1 1.5 us (0.5 of it waiting for weights), epilogue and syncs
//   2.2 us, GEMM2 1.3 us. So hh is built by the producer warpgroup's other
//   three warps, one neighbour ahead, into one of two buffers (mbarriers
//   hh_full / hh_empty), and the consumers load fs before GEMM1: 2.02-2.05
//   -> 1.83 ms (CUDA-graph replay). The builders now take 6.3 us a
//   neighbour and set the pace. Without the g and feats loads the kernel
//   takes 1.12 ms, with the weights loaded for one neighbour only
//   1.64-1.68 ms: the activation loads, more than the weight stream, bound
//   it. (Sharing each weight box between a 2-block cluster by TMA
//   multicast halves the L2 weight reads and took 2.80 ms.)
// - Per neighbour the consumers run GEMM1 (z = hh @ W1 in registers), the
//   BN1/ReLU/x fs epilogue, which writes pf over hh once both warpgroups'
//   GEMM1 has retired, and GEMM2 (acc += pf @ K_n over the full K = Cp),
//   which frees the buffer. Named barriers over the 256 consumer threads
//   join the steps; generic stores are made visible to wgmma with
//   fence.proxy.async.
// - Shared memory: 4 boxes of ring + 2 hh/pf tiles + the BN affines (at
//   Cp = 256: 128 + 64 + 4 KB), one block an SM.
// - Host side: the two weight tensor maps are encoded per launch
//   (cuTensorMapEncodeTiled, libcuda) and passed as __grid_constant__.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxC = 256;
constexpr int kTileP = 64;       // pixels per block: one m64 tile
constexpr int kStages = 4;
constexpr int kAtomBytes = kSw128AtomBytes;  // one k-block of hh: 64 rows x 128 B
constexpr int kConsumerThreads = 256;
// + one producer warpgroup: one thread of its first warp issues the
// weight loads, its other three warps build hh. 384 threads start at 168
// registers a thread; setmaxnreg moves 88 a thread from the producer to
// the consumers (80 / 208: the fastest split without spills on the H100
// at Cp = 256; 72 / 216 spills in the builders, and a split above the
// 64,512 registers that the launch holds makes setmaxnreg.inc wait
// forever).
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kBuilders = 96;
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 208;

// Shared memory of the Cp-wide instance: ring, two hh/pf tiles, the four
// BN affines, the mbarriers, and room to align the ring to 1024 bytes.
template <int kCp>
constexpr int kSmemBytes = kStages * 64 * kCp * 2 + 2 * (kCp / 64) * kAtomBytes +
                           4 * kCp * 4 + 2 * (kStages + 2) * 8 + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void consumer_sync() {
  named_barrier_sync<kConsumerThreads>(1);
}

// d (+)= A @ B for one k16 step, N = 128 (Cp = 256) or 64 (Cp = 128) by the
// size of the accumulator.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int kCp>
__global__ void __launch_bounds__(kThreads, 1)
    meta_kernel_fused_wgmma(const __grid_constant__ CUtensorMap w1map,
                            const __grid_constant__ CUtensorMap kmap,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ f,
                            const float* __restrict__ a0, const float* __restrict__ b0,
                            const float* __restrict__ a1, const float* __restrict__ b1,
                            float* __restrict__ out, int H, int W, int C) {
  constexpr int kHalfN = kCp / 2;             // output channels per consumer warpgroup
  constexpr int kKB = kCp / 64;               // 64-channel k-blocks (128-byte swizzle rows)
  constexpr int kBoxBytes = 64 * kCp * 2;     // one weight box: 64 k x Cp n
  constexpr int kHhBytes = kKB * kAtomBytes;  // one hh/pf tile, two of them
  constexpr int kBoxesPerNb = 2 * kKB;        // W1^T, then K_n^T
  constexpr int kJ = kHalfN / 8;              // 8-column groups of a warpgroup
  // Builders: kCp / 8 threads of 8 channels cover a pixel; the 96 threads
  // cover kPixGroups pixels at a time.
  constexpr int kPixGroups = kBuilders / (kCp / 8);
  constexpr int kPixSteps = (kTileP + kPixGroups - 1) / kPixGroups;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* hh = smem + kStages * kBoxBytes;
  float* a1_s = reinterpret_cast<float*>(hh + 2 * kHhBytes);
  float* b1_s = a1_s + kCp;
  float* a0_s = b1_s + kCp;
  float* b0_s = a0_s + kCp;
  uint64_t* full = reinterpret_cast<uint64_t*>(b0_s + kCp);
  uint64_t* empty = full + kStages;
  uint64_t* hh_full = empty + kStages;  // hh buffer b holds neighbour nb, nb % 2 == b
  uint64_t* hh_empty = hh_full + 2;

  const int w0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const size_t img = (size_t)blockIdx.z * H;

  for (int i = threadIdx.x; i < kCp; i += kThreads) {
    const bool real = i < C;  // padded channels get zero affines
    a0_s[i] = real ? a0[i] : 0.f;
    b0_s[i] = real ? b0[i] : 0.f;
    a1_s[i] = real ? a1[i] : 0.f;
    b1_s[i] = real ? b1[i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                         // the TMA's bytes
      mbar_init(&empty[s], kConsumerThreads / 32);    // each consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&hh_full[b], kBuilders / 32);         // each builder warp
      mbar_init(&hh_empty[b], kConsumerThreads / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---------------- producer: one thread streams the weight boxes, three
    // warps build hh one neighbour ahead of the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= kConsumerThreads + 32) {
      // This thread's 8 channels [ch, ch + 8), for pixels p0 + kPixGroups i;
      // BN0's affine for them is read from shared memory as 16-byte loads.
      const int bt = threadIdx.x - kConsumerThreads - 32;
      const int ch = (bt % (kCp / 8)) * 8;
      const int p0 = bt / (kCp / 8);
      const bool ch_ok = ch < C;
      for (int nb = 0; nb < 9; ++nb) {
        const int buf = nb & 1;
        if (nb >= 2) mbar_wait(&hh_empty[buf], ((nb >> 1) - 1) & 1);
        uint8_t* dst = hh + buf * kHhBytes;
        const int dy = nb / 3;
        const int dx = nb - dy * 3;
        const int hs = h + dy - 1;
        const bool row_ok = hs >= 0 && hs < H;
        // This thread's channels of pixel p: gc_row[p C], shifted gs_row[p C].
        const __nv_bfloat16* gc_row = g + ((img + h) * W + w0) * C + ch;
        const __nv_bfloat16* gs_row = g + ((img + hs) * W + w0 + dx - 1) * C + ch;
        // hh = bf16(relu(a0 * bf16(g(p + d) - g(p)) + b0)), 16 bytes a
        // thread and pixel, 4 pixels' loads in flight; rows past W get
        // finite values and are not stored.
        for (int i0 = 0; i0 < kPixSteps; i0 += 4) {
          uint4 gc[4], gs[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p0 + kPixGroups * (i0 + u);
            const int w = w0 + p;
            const int ws = w + dx - 1;
            gc[u] = make_uint4(0, 0, 0, 0);
            gs[u] = make_uint4(0, 0, 0, 0);
            if (p < kTileP && w < W && ch_ok) {
              gc[u] = __ldg(reinterpret_cast<const uint4*>(gc_row + p * C));
              if (row_ok && ws >= 0 && ws < W)
                gs[u] = __ldg(reinterpret_cast<const uint4*>(gs_row + p * C));
            }
          }
          float sa0[8], sb0[8];
          *reinterpret_cast<float4*>(sa0) = *reinterpret_cast<const float4*>(a0_s + ch);
          *reinterpret_cast<float4*>(sa0 + 4) = *reinterpret_cast<const float4*>(a0_s + ch + 4);
          *reinterpret_cast<float4*>(sb0) = *reinterpret_cast<const float4*>(b0_s + ch);
          *reinterpret_cast<float4*>(sb0 + 4) = *reinterpret_cast<const float4*>(b0_s + ch + 4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p0 + kPixGroups * (i0 + u);
            if (p >= kTileP) continue;
            const uint32_t cw[4] = {gc[u].x, gc[u].y, gc[u].z, gc[u].w};
            const uint32_t sw[4] = {gs[u].x, gs[u].y, gs[u].z, gs[u].w};
            uint32_t o[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float x0a = round_bf16(__fsub_rn(bf16_lo(sw[q]), bf16_lo(cw[q])));
              const float x0b = round_bf16(__fsub_rn(bf16_hi(sw[q]), bf16_hi(cw[q])));
              o[q] = pack_bf16(
                  fmaxf(__fadd_rn(__fmul_rn(x0a, sa0[2 * q]), sb0[2 * q]), 0.f),
                  fmaxf(__fadd_rn(__fmul_rn(x0b, sa0[2 * q + 1]), sb0[2 * q + 1]), 0.f));
            }
            *reinterpret_cast<uint4*>(dst + sw128(p, 2 * ch)) = make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
        fence_proxy_async();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(&hh_full[buf]);
      }
    } else if (threadIdx.x == kConsumerThreads) {
      for (int i = 0; i < 9 * kBoxesPerNb; ++i) {
        const int s = i % kStages;
        const int lap = i / kStages;
        if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
        mbar_arrive_tx(&full[s], kBoxBytes);
        const int nb = i / kBoxesPerNb;
        const int r = i % kBoxesPerNb;
        const int k0 = (r % kKB) * 64;
        if (r < kKB) {
          tma_load_3d(ring + s * kBoxBytes, &w1map, &full[s], k0, 0, 0);
        } else {
          tma_load_3d(ring + s * kBoxBytes, &kmap, &full[s], k0, 0, nb);
        }
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
    const uint32_t hh_u32 = smem_u32(hh);

    float acc[kHalfN / 2];
#pragma unroll
    for (int i = 0; i < kHalfN / 2; ++i) {
      acc[i] = 0.f;
      fence_operand(acc[i]);
    }

    int box = 0;  // weight boxes consumed so far
    // d (+)= A @ B over K = Cp: A is the hh/pf tile at a_u32, B the next
    // kKB boxes.
    auto gemm = [&](float (&d)[kHalfN / 2], uint32_t a_u32) {
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
        const int s = box % kStages;
        mbar_wait(&full[s], (box / kStages) & 1);
        const uint64_t da = desc_sw128(a_u32 + kb * kAtomBytes);
        const uint64_t db = desc_sw128(ring_u32 + s * kBoxBytes + wg * kHalfN * 128);
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          wgmma_bf16(d, da + 2 * k16, db + 2 * k16);  // +32 bytes
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(box - 1) % kStages]);
        }
        ++box;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kHalfN / 2; ++i) fence_operand(d[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(box - 1) % kStages]);
    };

    for (int nb = 0; nb < 9; ++nb) {
      const int dy = nb / 3;
      const int dx = nb - dy * 3;
      const int hs = h + dy - 1;
      const bool row_ok = hs >= 0 && hs < H;

      const int buf = nb & 1;
      uint8_t* hh_b = hh + buf * kHhBytes;
      const uint32_t hh_b_u32 = hh_u32 + buf * kHhBytes;

      // The shifted feats at this thread's accumulator rows and columns,
      // in flight while hh is awaited and GEMM1 runs.
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

      // 1. z = hh @ W1 (fp32), this warpgroup's columns, once the builders
      // have filled hh's buffer.
      mbar_wait(&hh_full[buf], (nb >> 1) & 1);
      float z[kHalfN / 2];
#pragma unroll
      for (int i = 0; i < kHalfN / 2; ++i) {
        z[i] = 0.f;
        fence_operand(z[i]);
      }
      gemm(z, hh_b_u32);
      consumer_sync();  // both warpgroups' GEMM1 has read hh

      // 2. pf = bf16(bf16(relu(a1 * z + b1)) * fs) over hh, in its layout.
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = wg * kHalfN + j * 8 + tig * 2;
        const float2 s1 = *reinterpret_cast<const float2*>(a1_s + n);
        const float2 t1 = *reinterpret_cast<const float2*>(b1_s + n);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = wq * 16 + gid + 8 * r;
          const float pa =
              round_bf16(fmaxf(__fadd_rn(__fmul_rn(z[4 * j + 2 * r], s1.x), t1.x), 0.f));
          const float pb = round_bf16(
              fmaxf(__fadd_rn(__fmul_rn(z[4 * j + 2 * r + 1], s1.y), t1.y), 0.f));
          *reinterpret_cast<uint32_t*>(hh_b + sw128(m, 2 * n)) =
              pack_bf16(__fmul_rn(pa, bf16_lo(fs[j][r])), __fmul_rn(pb, bf16_hi(fs[j][r])));
        }
      }
      fence_proxy_async();
      consumer_sync();

      // 3. acc += pf @ K_n over the full K = Cp; then the buffer is free.
      gemm(acc, hh_b_u32);
      __syncwarp();
      if (lane == 0) mbar_arrive(&hh_empty[buf]);
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

template <int kCp>
int launch(const void* g, const void* feats, const void* w1t, const void* kt,
           const void* a0, const void* b0, const void* a1, const void* b1, void* out,
           int B, int H, int W, int C, void* stream) {
  CUtensorMap w1map, kmap;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!stem_weight_map(&w1map, kBf16, 2, w1t, C, kCp, 1) ||
      !stem_weight_map(&kmap, kBf16, 2, kt, C, kCp, 9))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = kSmemBytes<kCp>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      meta_kernel_fused_wgmma<kCp>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((W + kTileP - 1) / kTileP, H, B);
  meta_kernel_fused_wgmma<kCp><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      w1map, kmap, (const __nv_bfloat16*)g, (const __nv_bfloat16*)feats,
      (const float*)a0, (const float*)b0, (const float*)a1, (const float*)b1,
      (float*)out, H, W, C);
  return (int)cudaGetLastError();
}

// ---------------- The tiled kernel: any C, g and feats in bf16 or fp32.
//
// The wgmma instances above hold a tile's whole z and accumulator (Cp <=
// 256) in registers and read bf16 through TMA. The wrapper sends this
// kernel fp32 g and feats (an fp32 model's stem; the tensor cores have no
// fp32 path that keeps fp32 accuracy, and TF32 keeps 10 mantissa bits)
// and C above 256; it also takes bf16 at any C.
//
// Bound: the operations on the CUDA cores, 2 x 9 x 2 C^2 flop a pixel (in
// fp32 at the flagship's B=2, 64x1808, C=256: 5.46e11 flop, 8.15 ms at the
// H100's 67 TFLOP/s outside the tensor cores).
//
// Design, from that (a simple tiled FFMA kernel):
// - A block owns a tile of output channels kTN wide (64 where C <= 64,
//   else 256; the grid's z walks B x ceil(C / kTN) tiles) for 1024 / (kTN
//   / 8) pixels of one row (128 or 32). Per neighbour it loops over
//   kTN-wide chunks j of z: z_j = hh @ W1[:, j] over K = C in steps of kTK
//   channels, hh built from g as it is staged; then pf_j = T(T(relu(a1
//   z_j + b1)) * fs) into shared memory; then acc += pf_j @ K_n[j, tile].
//   Past C = 256 every output tile repeats the W1 product (1.5x the flops
//   at C = 512).
// - 256 threads, each 4 pixels x 8 channels (two runs of 4, kTN / 2
//   apart) of z and of the accumulator, operands from shared memory as
//   16-byte loads (the pixel tiles k-contiguous, the weight rows
//   n-contiguous). The stages are double-buffered, and each thread's share
//   of the next stage (its g and weight elements) is loaded into registers
//   while the current one is multiplied, so the L2 latency of the weight
//   rows hides behind the FMAs; one barrier a stage.
// - The twin's rounding points (kernels/stem.py::meta_kernel_fused_plain)
//   with T the compute dtype, each product and sum of the affines rounded
//   on its own; only the order of the fp32 sums differs. Channels past C
//   are zeros, and so are neighbours outside the image.
constexpr int kTK = 16;           // channels of K staged per step
constexpr int kTThreads = 256;
constexpr int kAS = kTK + 4;      // row stride of the hh tile [kTP][kAS]

// The tile of the kTN-wide instance: kTX threads across its channels,
// kTY thread rows of 4 pixels each.
template <int kTN>
struct Tile {
  static constexpr int kTX = kTN / 8;
  static constexpr int kTY = kTThreads / kTX;
  static constexpr int kTP = 4 * kTY;   // pixels of one row per block
  static constexpr int kPS = kTN + 4;   // row stride of the pf tile [kTP][kPS]
  static constexpr int kA = kTP * kAS;  // one hh stage (floats)
  static constexpr int kB = kTK * kTN;  // one weight stage (floats)
  static constexpr int kNA = kTP * kTK / kTThreads;  // hh elements a thread stages
  static constexpr int kNB = kB / kTThreads;         // weights a thread stages
  // Two hh stages, two weight stages, the pf tile.
  static constexpr int kSmemBytes = (2 * kA + 2 * kB + kTP * kPS) * 4;
  // Output channel of a thread's q-th column (q < 8).
  static __device__ __forceinline__ int col(int q, int tx) {
    return (q >> 2) * (kTN / 2) + tx * 4 + (q & 3);
  }
};

// d[i][q] += sum_k a[(4 ty + i) as + k] * b[k kTN + Tile::col(q)], k < kTK.
template <int kTN>
__device__ __forceinline__ void fma_tile(float (&d)[4][8], const float* a, int as,
                                         const float* b, int ty, int tx) {
  // One group of 4 k at a time: its 16-byte operand loads, no more, are
  // live beside the accumulators and the next stage's prefetched elements.
#pragma unroll 1
  for (int k4 = 0; k4 < kTK; k4 += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * as + k4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 lo = *reinterpret_cast<const float4*>(b + (k4 + u) * kTN + tx * 4);
      const float4 hi =
          *reinterpret_cast<const float4*>(b + (k4 + u) * kTN + kTN / 2 + tx * 4);
      const float bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = lane4(av[i], u);
#pragma unroll
        for (int q = 0; q < 8; ++q) d[i][q] = fmaf(ai, bv[q], d[i][q]);
      }
    }
  }
}

template <typename T, int kTN>
__global__ void __launch_bounds__(kTThreads, 1)
    meta_kernel_fused_tiled(const T* __restrict__ g, const T* __restrict__ f,
                            const T* __restrict__ w1, const T* __restrict__ k,
                            const float* __restrict__ a0, const float* __restrict__ b0,
                            const float* __restrict__ a1, const float* __restrict__ b1,
                            float* __restrict__ out, int H, int W, int C, int tiles) {
  using Tl = Tile<kTN>;
  constexpr int kTP = Tl::kTP, kPS = Tl::kPS;
  constexpr int kNA = Tl::kNA, kNB = Tl::kNB;
  extern __shared__ float4 tiled_smem[];
  float* a_s = reinterpret_cast<float*>(tiled_smem);  // hh: 2 x [kTP][kAS]
  float* b_s = a_s + 2 * Tl::kA;                       // W1 or K_n rows: 2 x [kTK][kTN]
  float* p_s = b_s + 2 * Tl::kB;                       // pf of chunk j: [kTP][kPS]
  const int tid = threadIdx.x, tx = tid % Tl::kTX, ty = tid / Tl::kTX;
  // Stage s writes buffer s % 2 (counted across both products), then one
  // barrier, then the FMAs read it: a buffer is written again only after
  // every thread has passed the barrier that follows its last read.
  int par = 0;
  float ga[kNA], gb[kNA], wr[kNB];  // the next stage: g(p), g(p + d), weights
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
    const T* kn = k + (size_t)nb * C * C;
    for (int j0 = 0; j0 < C; j0 += kTN) {
      // 1. z_j = hh @ W1[:, j0 : j0 + kTN].
      float z[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) z[i][q] = 0.f;
      auto fetch1 = [&](int k0) {
#pragma unroll
        for (int e = 0; e < kNA; ++e) {
          const int idx = tid + e * kTThreads;
          const int c = k0 + idx % kTK, w = w0 + idx / kTK, ws = w + dx - 1;
          const bool ok = c < C && w < W;
          ga[e] = ok ? ld_elem(g + ((img + h) * W + w) * C + c) : 0.f;
          gb[e] = ok && row_ok && ws >= 0 && ws < W
                      ? ld_elem(g + ((img + hs) * W + ws) * C + c)
                      : 0.f;
        }
#pragma unroll
        for (int e = 0; e < kNB; ++e) {
          const int idx = tid + e * kTThreads;
          const int c = k0 + idx / kTN, n = j0 + idx % kTN;
          wr[e] = c < C && n < C ? ld_elem(w1 + (size_t)c * C + n) : 0.f;
        }
      };
      const int steps1 = (C + kTK - 1) / kTK;
      fetch1(0);
      for (int st = 0; st < steps1; ++st, par ^= 1) {
        float* a_b = a_s + par * Tl::kA;
        float* b_b = b_s + par * Tl::kB;
#pragma unroll
        for (int e = 0; e < kNA; ++e) {
          const int idx = tid + e * kTThreads;
          const int c = st * kTK + idx % kTK;
          float v = 0.f;
          if (c < C) {
            const float x0 = round_to<T>(__fsub_rn(gb[e], ga[e]));
            v = round_to<T>(
                fmaxf(__fadd_rn(__fmul_rn(x0, __ldg(a0 + c)), __ldg(b0 + c)), 0.f));
          }
          a_b[(idx / kTK) * kAS + idx % kTK] = v;
        }
#pragma unroll
        for (int e = 0; e < kNB; ++e) b_b[tid + e * kTThreads] = wr[e];
        __syncthreads();
        if (st + 1 < steps1) fetch1((st + 1) * kTK);
        fma_tile<kTN>(z, a_b, kAS, b_b, ty, tx);
      }

      // 2. pf_j = T(T(relu(a1 z + b1)) * fs), zero past C and outside the
      // image.
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
        float pf[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = j0 + Tl::col(q, tx);
          const float fs =
              ok && col < C ? ld_elem(f + ((img + hs) * W + ws) * C + col) : 0.f;
          const float pv =
              round_to<T>(fmaxf(__fadd_rn(__fmul_rn(z[i][q], s1[q]), t1[q]), 0.f));
          pf[q] = round_to<T>(__fmul_rn(pv, fs));
        }
        *reinterpret_cast<float4*>(p_s + p * kPS + tx * 4) =
            make_float4(pf[0], pf[1], pf[2], pf[3]);
        *reinterpret_cast<float4*>(p_s + p * kPS + kTN / 2 + tx * 4) =
            make_float4(pf[4], pf[5], pf[6], pf[7]);
      }

      // 3. acc += pf_j @ K_n[j0 : j0 + kTN, n0 : n0 + kTN] (the barrier of
      // its first stage also publishes pf_j).
      const int kj = min(kTN, C - j0);
      auto fetch2 = [&](int k0) {
#pragma unroll
        for (int e = 0; e < kNB; ++e) {
          const int idx = tid + e * kTThreads;
          const int kk = k0 + idx / kTN, n = n0 + idx % kTN;
          wr[e] = kk < kj && n < C ? ld_elem(kn + (size_t)(j0 + kk) * C + n) : 0.f;
        }
      };
      const int steps2 = (kj + kTK - 1) / kTK;
      fetch2(0);
      for (int st = 0; st < steps2; ++st, par ^= 1) {
        float* b_b = b_s + par * Tl::kB;
#pragma unroll
        for (int e = 0; e < kNB; ++e) b_b[tid + e * kTThreads] = wr[e];
        __syncthreads();
        if (st + 1 < steps2) fetch2((st + 1) * kTK);
        fma_tile<kTN>(acc, p_s + st * kTK, kPS, b_b, ty, tx);
      }
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
int launch_tiled(const void* g, const void* feats, const void* w1, const void* k,
                 const void* a0, const void* b0, const void* a1, const void* b1,
                 void* out, int B, int H, int W, int C, void* stream) {
  using Tl = Tile<kTN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(meta_kernel_fused_tiled<T, kTN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (C + kTN - 1) / kTN;
  const dim3 grid((W + Tl::kTP - 1) / Tl::kTP, H, B * tiles);
  meta_kernel_fused_tiled<T, kTN><<<grid, kTThreads, Tl::kSmemBytes, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)feats, (const T*)w1, (const T*)k, (const float*)a0,
      (const float*)b0, (const float*)a1, (const float*)b1, (float*)out, H, W, C, tiles);
  return (int)cudaGetLastError();
}

// The 64-wide instance where C <= 64, the 256-wide one past it.
template <typename T>
int launch_tiled_any(const void* g, const void* feats, const void* w1, const void* k,
                     const void* a0, const void* b0, const void* a1, const void* b1,
                     void* out, int B, int H, int W, int C, void* stream) {
  return C <= 64 ? launch_tiled<T, 64>(g, feats, w1, k, a0, b0, a1, b1, out, B, H, W, C,
                                       stream)
                 : launch_tiled<T, 256>(g, feats, w1, k, a0, b0, a1, b1, out, B, H, W, C,
                                        stream);
}

}  // namespace

// g, feats: (B, H, W, C) bf16; w1t: (C, C) bf16 = W1^T; kt: (9, C, C) bf16
// with kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; out: (B, H, W, C) fp32.
// C must be a multiple of 8 up to 256 (C <= 128 runs the 128-wide
// instance, the rest the 256-wide one); g, feats, w1t and kt 16-byte
// aligned.
extern "C" int rv3d_meta_kernel_fused(const void* g, const void* feats,
                                      const void* w1t, const void* kt,
                                      const void* a0, const void* b0,
                                      const void* a1, const void* b1,
                                      void* out, int B, int H, int W, int C,
                                      void* stream) {
  if (C <= 0 || C % 8 || C > kMaxC || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  return C <= 128 ? launch<128>(g, feats, w1t, kt, a0, b0, a1, b1, out, B, H, W, C, stream)
                  : launch<256>(g, feats, w1t, kt, a0, b0, a1, b1, out, B, H, W, C, stream);
}

// The tiled kernel. g, feats: (B, H, W, C), bf16 (fp32 == 0) or fp32
// (fp32 != 0); w1: (C, C) = W1 ([k][n], x @ W1) and k: (9, C, C) with k[n]
// = K_n, both in the dtype of g; a0, b0, a1, b1: (C,) fp32; out: (B, H, W,
// C) fp32. Any C >= 1 with B * ceil(C / 256) <= 65535 and H <= 65535 (C
// <= 64 runs the 64-wide instance, the rest the 256-wide one).
extern "C" int rv3d_meta_kernel_fused_tiled(const void* g, const void* feats,
                                            const void* w1, const void* k,
                                            const void* a0, const void* b0,
                                            const void* a1, const void* b1,
                                            void* out, int B, int H, int W, int C,
                                            int fp32, void* stream) {
  if (C <= 0 || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      (long)B * ((C + 255) / 256) > 65535)
    return (int)cudaErrorInvalidValue;
  return fp32 ? launch_tiled_any<float>(g, feats, w1, k, a0, b0, a1, b1, out, B, H, W, C,
                                        stream)
              : launch_tiled_any<__nv_bfloat16>(g, feats, w1, k, a0, b0, a1, b1, out, B,
                                                H, W, C, stream);
}
