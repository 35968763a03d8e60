// Fused eval MetaKernel stem on int8 operands (K4) for Hopper.
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
// 2^24 at C = 256, so float() is exact.
//
// Bound on the H100: two C x C int8 GEMMs per neighbour and pixel, 5.46e11
// operations at B=2, 64x1808, C=256, i.e. 0.28 ms at 1979 TOP/s; the bytes
// (g and feats in bf16 read once, fp32 out written once, ~0.47 GB) take
// 0.14 ms. The quantize/round/convert work per element is fp32 on the
// CUDA cores and not in that bound.
//
// Design: K1's. One block owns 32 pixels of one row and all C output
// channels (a warp per 32 channels), loops over the 9 neighbours with the
// fp32 accumulator in registers; per neighbour it builds hq in shared
// memory, each warp computes its z slice with mma.sync m16n8k32 s8
// (int32), quantizes pq in registers and stores it to shared memory as the
// A operand of the second product, whose int32 sum is dequantized into the
// accumulator. Weights are passed transposed ([n][k], 0.6 MB) and each B
// fragment is two 32-bit loads from L2. No wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 32;  // pixels per block: two 16-row mma tiles
constexpr int kPad = 16;    // int8 padding per shared-memory row (banks)

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int8_t to_i8(float integral) {
  return (int8_t)__float2int_rn(integral);
}

// acc[mt][nt] = A[kTileP x C] (shared, int8, row stride lda) @ B[C x C] for
// this warp's columns [n0, n0 + 32); B is given transposed, bt[n * C + k].
__device__ __forceinline__ void warp_gemm_s8(int (&acc)[2][4][4],
                                             const int8_t* a_s, int lda,
                                             const int8_t* __restrict__ bt,
                                             int C, int n0, int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;
  for (int k0 = 0; k0 < C; k0 += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* r0 = a_s + (mt * 16 + gid) * lda + k0 + tig * 4;
      const int8_t* r1 = r0 + 8 * lda;
      a[mt][0] = ld_u32(r0);
      a[mt][1] = ld_u32(r1);
      a[mt][2] = ld_u32(r0 + 16);
      a[mt][3] = ld_u32(r1 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* bp = bt + (size_t)(n0 + nt * 8 + gid) * C + k0 + tig * 4;
      uint32_t b[2];
      b[0] = __ldg(reinterpret_cast<const unsigned int*>(bp));
      b[1] = __ldg(reinterpret_cast<const unsigned int*>(bp + 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8_16832(acc[mt][nt], a[mt], b);
    }
  }
}

__global__ void meta_kernel_fused_i8_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f,
    const int8_t* __restrict__ w1t, const int8_t* __restrict__ kt,
    const float* __restrict__ a0, const float* __restrict__ b0,
    const float* __restrict__ a1, const float* __restrict__ b1,
    const float* __restrict__ kdq, float* __restrict__ out, int H, int W,
    int C) {
  extern __shared__ __align__(16) int8_t smem_i8[];
  const int lda = C + kPad;
  int8_t* hq_s = smem_i8;
  int8_t* pq_s = hq_s + kTileP * lda;

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

    // A. hq = min(rint(relu(a0 * bf16(g(p + d) - g(p)) + b0)), 127).
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
      char2 q;
      q.x = to_i8(fminf(rintf(ha), 127.f));
      q.y = to_i8(fminf(rintf(hb), 127.f));
      *reinterpret_cast<char2*>(hq_s + p * lda + c) = q;
    }
    __syncthreads();

    // B. z = hq @ W1 (int32), p = relu(a1 * z + b1), pq = clip(rint(p * fs)).
    int z[2][4][4];
    warp_gemm_s8(z, hq_s, lda, w1t, C, n0, lane);
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
          const float pa = fmaxf(
              __fadd_rn(__fmul_rn(__int2float_rn(z[mt][nt][2 * r]), s0), t0),
              0.f);
          const float pb = fmaxf(
              __fadd_rn(__fmul_rn(__int2float_rn(z[mt][nt][2 * r + 1]), s1),
                        t1),
              0.f);
          char2 q;
          q.x = to_i8(fminf(fmaxf(rintf(__fmul_rn(pa, fs.x)), -127.f), 127.f));
          q.y = to_i8(fminf(fmaxf(rintf(__fmul_rn(pb, fs.y)), -127.f), 127.f));
          *reinterpret_cast<char2*>(pq_s + p * lda + c) = q;
        }
      }
    }
    __syncthreads();

    // C. acc += float(pq @ K_n) * kdq[n].
    int d[2][4][4];
    warp_gemm_s8(d, pq_s, lda, kt + (size_t)nb * C * C, C, n0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + nt * 8 + tig * 2;
      const float q0 = kdq[nb * C + c], q1 = kdq[nb * C + c + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mt][nt][r] = __fadd_rn(
              acc[mt][nt][r],
              __fmul_rn(__int2float_rn(d[mt][nt][r]), (r & 1) ? q1 : q0));
    }
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

// g, feats: (B, H, W, C) bf16; w1t: (C, C) int8 = W1^T; kt: (9, C, C) int8
// with kt[n] = K_n^T; a0, b0, a1, b1: (C,) fp32; kdq: (9, C) fp32;
// out: (B, H, W, C) fp32. C must be a multiple of 32 and at most 256.
extern "C" int rv3d_meta_kernel_fused_i8(
    const void* g, const void* feats, const void* w1t, const void* kt,
    const void* a0, const void* b0, const void* a1, const void* b1,
    const void* kdq, void* out, int B, int H, int W, int C, void* stream) {
  if (C % 32 != 0 || C <= 0 || C > 256 || B <= 0 || H <= 0 || W <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2u * kTileP * (C + kPad);
  const dim3 grid((W + kTileP - 1) / kTileP, H, B);
  meta_kernel_fused_i8_kernel<<<grid, C, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)g, (const __nv_bfloat16*)feats,
      (const int8_t*)w1t, (const int8_t*)kt, (const float*)a0,
      (const float*)b0, (const float*)a1, (const float*)b1,
      (const float*)kdq, (float*)out, H, W, C);
  return (int)cudaGetLastError();
}
