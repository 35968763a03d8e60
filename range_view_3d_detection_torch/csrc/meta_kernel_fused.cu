// Fused eval MetaKernel stem (K1) for Hopper, bf16 in, fp32 out.
//
// Replaces range_view_3d_detection_tpu/kernels/stem_pallas.py::
// meta_kernel_fused (_stem_kernel). Per pixel p of a (B, H, W, C) image:
//
//   geo(p) = sum_n [ bf16(relu(a1 * (bf16(relu(a0 * x0_n + b0)) @ W1) + b1))
//                    * fs_n ] @ K_n,       x0_n = bf16(g(p + d_n) - g(p)),
//
// over the 3x3 neighbours d_n (dy-major). Out-of-image neighbours read
// zeros for both g and feats (the Pallas kernel's zero column shift and
// zeroed edge rows). The bf16 rounding points are the Pallas kernel's.
//
// Bound on the H100: two C x C GEMMs per neighbour and pixel, 5.46e11 flop
// at B=2, 64x1808, C=256, i.e. 0.55 ms at 989 TFLOP/s bf16; the bytes
// (g and feats read once, fp32 out written once, ~474 MB) take 0.14 ms, so
// the kernel is compute-bound.
//
// Design. Pallas ran a sequential (B, H, 3) grid and carried the output
// block across the dy steps; a GPU has no carry between blocks, so one
// block owns a tile of kTileP pixels of one row and all C output channels
// and loops over the 9 neighbours with the fp32 accumulator in registers.
// Warp w owns output columns [32w, 32w + 32) for all kTileP rows, so the
// block has C/32 warps. Per neighbour:
//   A. all threads build hh (kTileP x C bf16) in shared memory;
//   B. each warp computes its z = hh @ W1 slice with mma.sync m16n8k16
//      (bf16 in, fp32 accumulate), applies BN1 + ReLU, rounds to bf16,
//      multiplies by the shifted feats in bf16 and stores pf to shared
//      memory;
//   C. each warp accumulates pf @ K_n into its registers.
// The weights are passed transposed ([n][k], 1.25 MB in all) so each mma's
// B fragment is two 32-bit loads straight from L2, where all of them stay.
// No wgmma, TMA or software pipelining yet: this is the simple version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 32;  // pixels per block: two 16-row mma tiles
constexpr int kPad = 8;     // bf16 padding per shared-memory row (banks)

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[mt][nt] += A[kTileP x C] (shared, row stride lda) @ B[C x C] for this
// warp's columns [n0, n0 + 32); B is given transposed, bt[n * C + k].
__device__ __forceinline__ void warp_gemm(float (&acc)[2][4][4],
                                          const __nv_bfloat16* a_s, int lda,
                                          const __nv_bfloat16* __restrict__ bt,
                                          int C, int n0, int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* r0 = a_s + (mt * 16 + gid) * lda + k0 + tig * 2;
      const __nv_bfloat16* r1 = r0 + 8 * lda;
      a[mt][0] = ld_u32(r0);
      a[mt][1] = ld_u32(r1);
      a[mt][2] = ld_u32(r0 + 8);
      a[mt][3] = ld_u32(r1 + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* bp =
          bt + (size_t)(n0 + nt * 8 + gid) * C + k0 + tig * 2;
      uint32_t b[2];
      b[0] = __ldg(reinterpret_cast<const unsigned int*>(bp));
      b[1] = __ldg(reinterpret_cast<const unsigned int*>(bp + 8));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b);
    }
  }
}

__global__ void meta_kernel_fused_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f,
    const __nv_bfloat16* __restrict__ w1t, const __nv_bfloat16* __restrict__ kt,
    const float* __restrict__ a0, const float* __restrict__ b0,
    const float* __restrict__ a1, const float* __restrict__ b1,
    float* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = C + kPad;
  __nv_bfloat16* hh_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* pf_s = hh_s + kTileP * lda;

  const int w0 = blockIdx.x * kTileP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = (tid >> 5) * 32;
  const int half_c = C / 2;
  const size_t img = (size_t)b * H;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int nb = 0; nb < 9; ++nb) {
    const int dy = nb / 3;
    const int dx = nb - dy * 3;
    const int hs = h + dy - 1;
    const bool row_ok = hs >= 0 && hs < H;

    // A. hh = bf16(relu(a0 * bf16(g(p + d) - g(p)) + b0)) for the tile.
    for (int idx = tid; idx < kTileP * half_c; idx += blockDim.x) {
      const int p = idx / half_c;
      const int c = (idx - p * half_c) * 2;
      const int w = w0 + p;
      const int ws = w + dx - 1;
      float2 gc = make_float2(0.f, 0.f);
      float2 gs = make_float2(0.f, 0.f);
      if (w < W) {
        gc = ld_bf16x2(g + ((img + h) * W + w) * C + c);
        if (row_ok && ws >= 0 && ws < W)
          gs = ld_bf16x2(g + ((img + hs) * W + ws) * C + c);
      }
      const float x0a = round_bf16(__fsub_rn(gs.x, gc.x));
      const float x0b = round_bf16(__fsub_rn(gs.y, gc.y));
      const float ha = fmaxf(__fadd_rn(__fmul_rn(x0a, a0[c]), b0[c]), 0.f);
      const float hb =
          fmaxf(__fadd_rn(__fmul_rn(x0b, a0[c + 1]), b0[c + 1]), 0.f);
      *reinterpret_cast<__nv_bfloat162*>(hh_s + p * lda + c) =
          __floats2bfloat162_rn(ha, hb);
    }
    __syncthreads();

    // B. z = hh @ W1 (fp32), p = bf16(relu(a1 * z + b1)), pf = bf16(p * fs).
    float z[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) z[mt][nt][r] = 0.f;
    warp_gemm(z, hh_s, lda, w1t, C, n0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + nt * 8 + tig * 2;
      const float s0 = a1[c], s1 = a1[c + 1];
      const float t0 = b1[c], t1 = b1[c + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = mt * 16 + gid + r * 8;
          const int w = w0 + p;
          const int ws = w + dx - 1;
          float2 fs = make_float2(0.f, 0.f);
          if (w < W && row_ok && ws >= 0 && ws < W)
            fs = ld_bf16x2(f + ((img + hs) * W + ws) * C + c);
          const float pa = round_bf16(
              fmaxf(__fadd_rn(__fmul_rn(z[mt][nt][2 * r], s0), t0), 0.f));
          const float pb = round_bf16(
              fmaxf(__fadd_rn(__fmul_rn(z[mt][nt][2 * r + 1], s1), t1), 0.f));
          *reinterpret_cast<__nv_bfloat162*>(pf_s + p * lda + c) =
              __floats2bfloat162_rn(__fmul_rn(pa, fs.x), __fmul_rn(pb, fs.y));
        }
      }
    }
    __syncthreads();

    // C. acc += pf @ K_n.
    warp_gemm(acc, pf_s, lda, kt + (size_t)nb * C * C, C, n0, lane);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = mt * 16 + gid + r * 8;
        const int w = w0 + p;
        if (w < W) {
          const int c = n0 + nt * 8 + tig * 2;
          *reinterpret_cast<float2*>(out + ((img + h) * W + w) * C + c) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
      }
}

}  // namespace

// g, feats: (B, H, W, C) bf16; w1t: (C, C) bf16 = W1^T; kt: (9, C, C) bf16
// with kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; out: (B, H, W, C) fp32.
// C must be a multiple of 32 and at most 256 (one warp per 32 channels;
// the two tiles then take at most 33 KB of shared memory).
extern "C" int rv3d_meta_kernel_fused(const void* g, const void* feats,
                                      const void* w1t, const void* kt,
                                      const void* a0, const void* b0,
                                      const void* a1, const void* b1,
                                      void* out, int B, int H, int W, int C,
                                      void* stream) {
  if (C % 32 != 0 || C <= 0 || C > 256 || B <= 0 || H <= 0 || W <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2u * kTileP * (C + kPad) * sizeof(__nv_bfloat16);
  const dim3 grid((W + kTileP - 1) / kTileP, H, B);
  meta_kernel_fused_kernel<<<grid, C, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)feats,
      (const __nv_bfloat16*)w1t, (const __nv_bfloat16*)kt, (const float*)a0,
      (const float*)b0, (const float*)a1, (const float*)b1, (float*)out, H, W,
      C);
  return (int)cudaGetLastError();
}
