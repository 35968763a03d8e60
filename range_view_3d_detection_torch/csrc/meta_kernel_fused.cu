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
//   zero channels; fp32 g and feats (as 3xTF32) and bf16 C above 256 take
//   the register-A kernel at the end of this file.
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

// ---------------- The register-A kernel: fp32 as 3xTF32, bf16 past C = 256.
//
// The wgmma instances above hold a tile's whole z and accumulator (Cp <=
// 256) in registers and read bf16 through TMA. The wrapper sends this
// kernel fp32 g and feats (an fp32 model's stem) at every C, and bf16 past
// C = 256 (kernels/stem.py::k1_plan).
//
// fp32 on the tensor cores as 3xTF32: TF32 keeps 10 mantissa bits, but an
// fp32 x is the sum of two TF32 values, hi = rna(x) and lo = rna(x - hi)
// (cvt.rna.tf32.f32: x - hi is exact in fp32, and lo carries the next 11
// bits), and a product x y is hi_x hi_y + hi_x lo_y + lo_x hi_y up to the
// dropped lo_x lo_y and lo's own rounding, about 2^-21 of |x y|. So each
// GEMM runs three wgmma k8 products into its fp32 accumulator, and the
// result keeps the fp32 twin's accuracy (held to 1e-4 x max|ref| on the
// card, as the FFMA kernel this replaces was).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W) at B=2, 64x1808, C=256
// in fp32: 3 x 5.46e11 TF32 flop at 495 TFLOP/s dense, 3.31 ms (the
// FFMA bound of the same work is 8.15 ms at 67 TFLOP/s). A 64-pixel
// block streams W1 and K_n once per neighbour, hi and lo: 1 MB a
// neighbour, 34 GB of L2 reads a call (3712 blocks), 5-7 ms at the L2's
// 5-7 TB/s, which the design was reckoned to be bound by (6-8 ms). A
// 128-pixel block would halve the stream but needs twice the
// accumulators (z and acc of 128 pixels x 256 channels do not fit in 256
// threads' registers beside the operands), so the block keeps 64 pixels.
// The wrapper splits the weights into hi and lo once a launch
// (kernels/stem.py::split_tf32): splitting the boxes in the kernel, in the
// producer's idle warps or in the consumers, measured slower (PERF.md's
// findings on this kernel).
//
// Shared memory decides the rest. hi and lo tiles of hh (64 pixels x C
// fp32, twice) would take 128 KB at C = 256 beside a ring of 64 KB
// stages; so A never sits in shared memory as hi/lo: wgmma takes A from
// registers, and each thread builds its A words where it needs them.
//
// Design, from that:
// - A block owns 64 pixels of one row and kN output channels (kN = 64
//   or 128 where an fp32 C is at most that, else 256; the grid's z walks
//   B x ceil(C / kN) output tiles). Two consumer warpgroups split the
//   tile's columns, kN/2 each (z and the accumulator in registers, 2 x
//   kN/4 fp32 a thread).
//   Per neighbour and per kN-wide chunk j of z: z_j = hh @ W1[:, j] over K
//   = C, the BN1/ReLU/x fs epilogue into pf_j, then acc += pf_j @ K_n[j,
//   tile]. Past C = kN every output tile repeats the W1 product (1.5x the
//   flops at C = 512).
// - GEMM1's A is hh itself: each thread loads the 16 bytes of g it needs
//   (centre and neighbour, its two rows m and m + 8 of the warp's 16),
//   computes hh = T(relu(a0 T(g(p + d) - g(p)) + b0)) and, in fp32,
//   splits it into hi and lo words; the next box's g is in flight while
//   the current one multiplies. The two warpgroups read the same g (L1).
// - The k order inside each group of 64 bytes (16 fp32 or 32 bf16
//   channels: two k-steps) is permuted so that a thread's four A words of
//   both steps are one 16-byte load: A fragment word (step s, half h) of
//   thread t (lane % 4) is physical word 4 t + 2 s + h of the group,
//   logical word 8 s + 4 h + t; the wrapper gathers the weights' k rows
//   in the same order (kernels/stem.py::k1_operands), so the sum is the
//   same.
// - GEMM2's A is pf_j, which both warpgroups need in full: the epilogue
//   writes it in T to a shared-memory tile (rows padded by 64 bytes, so a
//   warp's 16-byte loads of 8 rows hit distinct banks), and GEMM2 loads
//   its words from there (and splits them in fp32).
// - The weights arrive by TMA as W1^T and K_n^T ([n][k], k permuted), in
//   boxes of 128 bytes of k x kN n (128-byte swizzle, the K-major layout a
//   wgmma descriptor reads), hi and lo together in fp32, through a ring
//   fed by one thread of the producer warpgroup (2 stages of 64 KB in
//   fp32, 4 of 32 KB in bf16). Each consumer waits for its box's wgmma
//   group before it releases the stage and rewrites its A words; the other
//   warpgroup's products fill the gap.
// - setmaxnreg 32 / 232 (the producer only issues TMA loads): 128 x 32 +
//   256 x 232 of the 64,512 registers the 384-thread launch holds.
// - The twin's rounding points (kernels/stem.py::meta_kernel_fused_plain)
//   with T the compute dtype; channels past C are zeros, and so are
//   neighbours outside the image. C is a multiple of the group (the
//   wrapper pads it).
constexpr int kRsProducerRegs = 32;
constexpr int kRsConsumerRegs = 232;

template <bool kTf32, int kN>
struct Rs {
  static constexpr int kElem = kTf32 ? 4 : 2;        // bytes of an element of g, feats, weights
  static constexpr int kBoxK = 128 / kElem;          // k of one weight box: a 128-byte row
  static constexpr int kGroup = 64 / kElem;          // k of an A group: two k-steps
  static constexpr int kParts = kTf32 ? 2 : 1;       // boxes a stage: hi and lo, or one
  static constexpr int kStages = kTf32 ? 2 : 4;
  static constexpr int kBoxBytes = 128 * kN;
  static constexpr int kStageBytes = kParts * kBoxBytes;
  static constexpr int kHalf = kN / 2;               // output channels a warpgroup
  static constexpr int kAcc = kHalf / 2;             // its fp32 accumulators a thread
  static constexpr int kJ = kHalf / 8;               // its 8-column groups
  static constexpr int kRowBytes = kN * kElem + 64;  // a row of the pf tile
  static constexpr int kSmem =
      kStages * kStageBytes + kTileP * kRowBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (+)= A @ B for one k-step, A from registers (this thread's four words
// of the fragment), B K-major from shared memory: m64nNk8 tf32 or
// m64nNk16 bf16, N = 128, 64 or 32 by the size of the accumulator.
template <bool kTf32>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kTf32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
// The 64- and 32-wide forms (fp32 at C <= 128 and C <= 64; no bf16
// instance takes them).
template <bool kTf32>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  static_assert(kTf32, "tf32 only");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <bool kTf32>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  static_assert(kTf32, "tf32 only");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One box's A operand for a consumer thread: [group q][row r][word], hi
// (or the bf16 words) and lo (fp32 only).
struct RsA {
  uint32_t hi[2][2][4];
  uint32_t lo[2][2][4];
};

// A words of x (fp32: split into hi and lo).
template <bool kTf32>
__device__ __forceinline__ void rs_split(RsA& a, int q, int r, const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kTf32) {
      const float x = __uint_as_float(w[e]);
      a.hi[q][r][e] = tf32_rna(x);
      a.lo[q][r][e] = tf32_rna(__fsub_rn(x, __uint_as_float(a.hi[q][r][e])));
    } else {
      a.hi[q][r][e] = w[e];
    }
  }
}

// The wgmmas of box `a` (groups q < nq) into d: B's hi part at descriptor
// bh, lo at bl. In fp32 each k-step is lo_a hi_b + hi_a lo_b + hi_a hi_b.
template <bool kTf32, int kAccN>
__device__ __forceinline__ void rs_box(float (&d)[kAccN], const RsA& a, int nq, uint64_t bh,
                                       uint64_t bl) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q >= nq) break;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // Fragment words (rows m, m + 8; halves k = t, t + 4 of the step).
      const uint32_t hi[4] = {a.hi[q][0][2 * s], a.hi[q][1][2 * s], a.hi[q][0][2 * s + 1],
                              a.hi[q][1][2 * s + 1]};
      const int step = 4 * q + 2 * s;  // 32 bytes a k-step
      if constexpr (kTf32) {
        const uint32_t lo[4] = {a.lo[q][0][2 * s], a.lo[q][1][2 * s], a.lo[q][0][2 * s + 1],
                                a.lo[q][1][2 * s + 1]};
        wgmma_rs<true>(d, lo, bh + step);
        wgmma_rs<true>(d, hi, bl + step);
      }
      wgmma_rs<kTf32>(d, hi, bh + step);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kAccN; ++i) fence_operand(d[i]);
}

template <bool kTf32, int kN>
__global__ void __launch_bounds__(kThreads, 1)
    meta_kernel_fused_rs(const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap w1lo_map,
                         const __grid_constant__ CUtensorMap klo_map,
                         const uint8_t* __restrict__ g, const uint8_t* __restrict__ f,
                         const float* __restrict__ aff, float* __restrict__ out, int H,
                         int W, int C, int tiles) {
  using R = Rs<kTf32, kN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* tile = smem + R::kStages * R::kStageBytes;  // pf_j: [64][kRowBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + kTileP * R::kRowBytes);
  uint64_t* empty = full + R::kStages;

  const int w0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int n0 = (blockIdx.z % tiles) * kN;
  const size_t img = (size_t)(blockIdx.z / tiles) * H;
  const int nkb1 = (C + R::kBoxK - 1) / R::kBoxK;  // boxes of GEMM1 (K = C)

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);                       // the TMA's bytes
      mbar_init(&empty[s], kConsumerThreads / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---------------- producer: one thread streams the weight boxes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRsProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      int i = 0;
      for (int nb = 0; nb < 9; ++nb) {
        for (int j0 = 0; j0 < C; j0 += kN) {
          const int nkb2 = (min(kN, C - j0) + R::kBoxK - 1) / R::kBoxK;
          for (int r = 0; r < nkb1 + nkb2; ++r, ++i) {
            const int s = i % R::kStages;
            const int lap = i / R::kStages;
            if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
            mbar_arrive_tx(&full[s], R::kStageBytes);
            uint8_t* dst = ring + s * R::kStageBytes;
            if (r < nkb1) {  // W1^T rows [j0, j0 + kN), k of box r
              tma_load_3d(dst, &w1map, &full[s], r * R::kBoxK, j0, 0);
              if constexpr (kTf32)
                tma_load_3d(dst + R::kBoxBytes, &w1lo_map, &full[s], r * R::kBoxK, j0, 0);
            } else {  // K_n^T rows [n0, n0 + kN), k of chunk j's box
              const int k0 = j0 + (r - nkb1) * R::kBoxK;
              tma_load_3d(dst, &kmap, &full[s], k0, n0, nb);
              if constexpr (kTf32)
                tma_load_3d(dst + R::kBoxBytes, &klo_map, &full[s], k0, n0, nb);
            }
          }
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns output columns
    // [n0 + kHalf wg, n0 + kHalf (wg + 1)) and the same columns of z_j.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRsConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int m0 = (t / 32) * 16 + gid;  // this thread's rows: m0, m0 + 8
    // This warpgroup's n rows of a box.
    const uint32_t ring_u32 = smem_u32(ring) + wg * R::kHalf * 128;
    const int ng1 = C / R::kGroup;             // A groups of GEMM1
    const int lc = tig * (16 / R::kElem);      // this thread's first channel in a group

    float acc[R::kAcc];
#pragma unroll
    for (int i = 0; i < R::kAcc; ++i) {
      acc[i] = 0.f;
      fence_operand(acc[i]);
    }

    int box = 0;  // weight boxes consumed so far
    // Waits for the next box; its hi and lo B descriptors.
    auto next_box = [&](uint64_t& bh, uint64_t& bl) {
      const int s = box % R::kStages;
      mbar_wait(&full[s], (box / R::kStages) & 1);
      bh = desc_sw128(ring_u32 + s * R::kStageBytes);
      bl = desc_sw128(ring_u32 + s * R::kStageBytes + (R::kParts - 1) * R::kBoxBytes);
    };
    // Its wgmmas have retired: the stage is free.
    auto release_box = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[box % R::kStages]);
      ++box;
    };

    for (int nb = 0; nb < 9; ++nb) {
      const int dy = nb / 3;
      const int dx = nb - dy * 3;
      const int hs = h + dy - 1;
      const bool row_ok = hs >= 0 && hs < H;
      // Byte offsets of this thread's two pixels (centre) and of their
      // neighbours in g and feats; ok_*: inside the image.
      size_t oc[2], os[2];
      bool okc[2], oks[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int w = w0 + m0 + 8 * r;
        const int ws = w + dx - 1;
        okc[r] = w < W;
        oks[r] = okc[r] && row_ok && ws >= 0 && ws < W;
        oc[r] = okc[r] ? ((img + h) * W + w) * C * R::kElem : 0;
        os[r] = oks[r] ? ((img + hs) * W + ws) * C * R::kElem : 0;
      }

      for (int j0 = 0; j0 < C; j0 += kN) {
        // 1. z = hh @ W1[:, j0 + this warpgroup's columns], K = C.
        float z[R::kAcc];
#pragma unroll
        for (int i = 0; i < R::kAcc; ++i) {
          z[i] = 0.f;
          fence_operand(z[i]);
        }
        // g's 16 bytes of box kb's groups: centre gc and neighbour gn.
        uint4 gc[2][2], gn[2][2];
        auto load_g = [&](int kb) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int grp = 2 * kb + q;
            const int off = (grp * R::kGroup + lc) * R::kElem;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              gc[q][r] = make_uint4(0, 0, 0, 0);
              gn[q][r] = make_uint4(0, 0, 0, 0);
              if (grp < ng1 && okc[r]) {
                gc[q][r] = __ldg(reinterpret_cast<const uint4*>(g + oc[r] + off));
                if (oks[r]) gn[q][r] = __ldg(reinterpret_cast<const uint4*>(g + os[r] + off));
              }
            }
          }
        };
        load_g(0);
        for (int kb = 0; kb < nkb1; ++kb) {
          // hh = T(relu(a0 T(g(p + d) - g(p)) + b0)) of this box's groups.
          RsA a;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c = (2 * kb + q) * R::kGroup + lc;
            const bool in = 2 * kb + q < ng1;
            if constexpr (kTf32) {
              const float4 sa = in ? __ldg(reinterpret_cast<const float4*>(aff + c))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
              const float4 sb = in ? __ldg(reinterpret_cast<const float4*>(aff + C + c))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
              const float a0v[4] = {sa.x, sa.y, sa.z, sa.w};
              const float b0v[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const uint32_t cw[4] = {gc[q][r].x, gc[q][r].y, gc[q][r].z, gc[q][r].w};
                const uint32_t nw[4] = {gn[q][r].x, gn[q][r].y, gn[q][r].z, gn[q][r].w};
                uint32_t hv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float x0 = __fsub_rn(__uint_as_float(nw[e]), __uint_as_float(cw[e]));
                  hv[e] = __float_as_uint(
                      fmaxf(__fadd_rn(__fmul_rn(x0, a0v[e]), b0v[e]), 0.f));
                }
                rs_split<true>(a, q, r, make_uint4(hv[0], hv[1], hv[2], hv[3]));
              }
            } else {
              float a0v[8], b0v[8];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float4 sa = in ? __ldg(reinterpret_cast<const float4*>(aff + c + 4 * u))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
                const float4 sb =
                    in ? __ldg(reinterpret_cast<const float4*>(aff + C + c + 4 * u))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
                const float sav[4] = {sa.x, sa.y, sa.z, sa.w};
                const float sbv[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  a0v[4 * u + e] = sav[e];
                  b0v[4 * u + e] = sbv[e];
                }
              }
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const uint32_t cw[4] = {gc[q][r].x, gc[q][r].y, gc[q][r].z, gc[q][r].w};
                const uint32_t nw[4] = {gn[q][r].x, gn[q][r].y, gn[q][r].z, gn[q][r].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float x0a = round_bf16(__fsub_rn(bf16_lo(nw[e]), bf16_lo(cw[e])));
                  const float x0b = round_bf16(__fsub_rn(bf16_hi(nw[e]), bf16_hi(cw[e])));
                  a.hi[q][r][e] = pack_bf16(
                      fmaxf(__fadd_rn(__fmul_rn(x0a, a0v[2 * e]), b0v[2 * e]), 0.f),
                      fmaxf(__fadd_rn(__fmul_rn(x0b, a0v[2 * e + 1]), b0v[2 * e + 1]), 0.f));
                }
              }
            }
          }
          if (kb + 1 < nkb1) load_g(kb + 1);  // in flight while this box multiplies
          uint64_t bh, bl;
          next_box(bh, bl);
          rs_box<kTf32>(z, a, min(2, ng1 - 2 * kb), bh, bl);
          release_box();
        }

        // 2. pf_j = T(T(relu(a1 z + b1)) * fs) into the tile, once the
        // other warpgroup's GEMM2 has read the last one.
        consumer_sync();
#pragma unroll
        for (int j = 0; j < R::kJ; ++j) {
          // A quarter of the columns at a time: their loads, no more, are
          // live beside z and the accumulator.
          if (j % (R::kJ / 4) == 0) asm volatile("" ::: "memory");
          const int nl = wg * R::kHalf + j * 8 + tig * 2;  // column in the chunk
          const int n = j0 + nl;
          const bool col_ok = n < C;
          const float2 s1 = col_ok ? *reinterpret_cast<const float2*>(aff + 2 * C + n)
                                   : make_float2(0.f, 0.f);
          const float2 t1 = col_ok ? *reinterpret_cast<const float2*>(aff + 3 * C + n)
                                   : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bool ok = oks[r] && col_ok;
            const float pa =
                fmaxf(__fadd_rn(__fmul_rn(z[4 * j + 2 * r], s1.x), t1.x), 0.f);
            const float pb =
                fmaxf(__fadd_rn(__fmul_rn(z[4 * j + 2 * r + 1], s1.y), t1.y), 0.f);
            uint8_t* dst = tile + (m0 + 8 * r) * R::kRowBytes + nl * R::kElem;
            if constexpr (kTf32) {
              const float2 fs = ok ? *reinterpret_cast<const float2*>(f + os[r] + n * 4)
                                   : make_float2(0.f, 0.f);
              *reinterpret_cast<float2*>(dst) = make_float2(__fmul_rn(pa, fs.x),
                                                            __fmul_rn(pb, fs.y));
            } else {
              const uint32_t fs =
                  ok ? *reinterpret_cast<const unsigned int*>(f + os[r] + n * 2) : 0u;
              *reinterpret_cast<uint32_t*>(dst) =
                  pack_bf16(__fmul_rn(round_bf16(pa), bf16_lo(fs)),
                            __fmul_rn(round_bf16(pb), bf16_hi(fs)));
            }
          }
        }
        consumer_sync();

        // 3. acc += pf_j @ K_n[j0 + k, this warpgroup's columns], K = the
        // chunk's channels below C.
        const int ng2 = min(kN, C - j0) / R::kGroup;
        for (int kb = 0; 2 * kb < ng2; ++kb) {
          RsA a;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int grp = 2 * kb + q;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint4 v =
                  grp < ng2 ? *reinterpret_cast<const uint4*>(
                                  tile + (m0 + 8 * r) * R::kRowBytes + grp * 64 + tig * 16)
                            : make_uint4(0, 0, 0, 0);
              rs_split<kTf32>(a, q, r, v);
            }
          }
          uint64_t bh, bl;
          next_box(bh, bl);
          rs_box<kTf32>(acc, a, min(2, ng2 - 2 * kb), bh, bl);
          release_box();
        }
      }
    }

    // Store this thread's accumulator rows and its columns below C.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int w = w0 + m0 + 8 * r;
      if (w >= W) continue;
      float* op = out + ((img + h) * W + w) * C;
#pragma unroll
      for (int j = 0; j < R::kJ; ++j) {
        const int n = n0 + wg * R::kHalf + j * 8 + tig * 2;
        if (n < C)
          *reinterpret_cast<float2*>(op + n) = make_float2(acc[4 * j + 2 * r],
                                                           acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <bool kTf32, int kN>
int launch_rs(const void* g, const void* feats, const void* w1t, const void* kt,
              const void* w1t_lo, const void* kt_lo, const void* aff, void* out, int B, int H,
              int W, int C, void* stream) {
  using R = Rs<kTf32, kN>;
  const auto type = kTf32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // W1^T and K^T, and in fp32 their lo parts (bf16 passes the hi maps
  // again in their place, unread).
  CUtensorMap maps[4];
  const void* bases[4] = {w1t, kt, w1t_lo, kt_lo};
  for (int m = 0; m < 2 * R::kParts; ++m)
    if (!stem_weight_map(&maps[m], type, R::kElem, bases[m], C, kN, m % 2 ? 9 : 1))
      return (int)cudaErrorInvalidValue;
  if constexpr (!kTf32) maps[2] = maps[0], maps[3] = maps[1];
  static const cudaError_t attr = cudaFuncSetAttribute(
      meta_kernel_fused_rs<kTf32, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (C + kN - 1) / kN;
  const dim3 grid((W + kTileP - 1) / kTileP, H, B * tiles);
  meta_kernel_fused_rs<kTf32, kN><<<grid, kThreads, R::kSmem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const uint8_t*)g, (const uint8_t*)feats,
      (const float*)aff, (float*)out, H, W, C, tiles);
  return (int)cudaGetLastError();
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

// The register-A kernel. g, feats: (B, H, W, C), bf16 (fp32 == 0) or fp32
// (fp32 != 0); w1t: (C, C) = W1^T and kt: (9, C, C) with kt[n] = K_n^T,
// their k (last) axis in the kernel's order (kernels/stem.py::
// k1_operands), TF32 hi parts in fp32 and w1t_lo, kt_lo the lo parts (in
// bf16 they are null); aff: (4, C) fp32, rows a0, b0, a1,
// b1; out: (B, H, W, C) fp32. C a multiple of 16 in fp32 (C <= 64 runs
// the 64-wide instance, C <= 128 the 128-wide one, the rest the 256-wide
// one), of 32 in bf16, with B
// * ceil(C / 256) <= 65535 and H <= 65535; every pointer 16-byte aligned.
extern "C" int rv3d_meta_kernel_fused_rs(const void* g, const void* feats, const void* w1t,
                                         const void* kt, const void* w1t_lo,
                                         const void* kt_lo, const void* aff, void* out,
                                         int B, int H, int W, int C, int fp32,
                                         void* stream) {
  if (C <= 0 || C % (fp32 ? 16 : 32) || B <= 0 || H <= 0 || W <= 0 || H > 65535 ||
      (long)B * ((C + 255) / 256) > 65535)
    return (int)cudaErrorInvalidValue;
  if (!fp32)
    return launch_rs<false, 256>(g, feats, w1t, kt, w1t_lo, kt_lo, aff, out, B, H, W, C,
                                 stream);
  if (C <= 64)
    return launch_rs<true, 64>(g, feats, w1t, kt, w1t_lo, kt_lo, aff, out, B, H, W, C,
                               stream);
  return C <= 128 ? launch_rs<true, 128>(g, feats, w1t, kt, w1t_lo, kt_lo, aff, out, B, H, W,
                                         C, stream)
                  : launch_rs<true, 256>(g, feats, w1t, kt, w1t_lo, kt_lo, aff, out, B, H, W,
                                         C, stream);
}
