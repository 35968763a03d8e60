// Fused int8 3x3 'same' conv + per-channel dequant (K3) for Hopper.
//
// Replaces range_view_3d_detection_tpu/kernels/conv_pallas.py::
// conv3x3_i8_fused (_conv_kernel, _conv_kernel_s2). For int8 x (B, H, W,
// Cin), int8 taps wt (9, Cout, Cin) ([n][k], dy-major) and fp32 dq (Cout):
//
//   out[b, h, w, n] = out_dtype( float(acc) * dq[n] ),
//   acc = sum_{dy, dx, k} x[b, h + dy - 1, s*w + dx - 1, k] * wt[3dy+dx, n, k]
//
// with int32 accumulation, zeros outside the image, width stride s in
// {1, 2} and Wo = (W - 1) / s + 1. float(acc) rounds once to nearest
// (__int2float_rn): at Cin = 512, |acc| can pass 2^24.
//
// Bound on the H100: the 512-channel head towers (B=2, 64x1808, 512 ->
// 512) are 2*231424*4608*512 = 1.09e12 int8 operations each, 0.55 ms at
// the 1979 TOP/s dense int8 peak, against ~0.24 GB of int8 in and bf16
// out (0.07 ms): compute-bound, like every conv of the path except the
// narrowest backbone ones.
//
// Design. The Pallas kernel ran a sequential (B, H, 3) grid with the s32
// accumulator in VMEM and pre-split stride-2 inputs into even/odd columns
// in XLA, both to suit Mosaic. Here a block owns kTileP = 128 output
// pixels of one row and kTileN = 128 output channels; its 8 warps split
// them 4 x 2 (32 pixels x 64 channels each, 64 int32 accumulators a
// thread, in registers for the whole conv). The reduction runs over Cin in
// chunks of 32 channels; for each chunk the block stages, with cp.async
// (zero-fill for rows and columns outside the image), the three input rows
// it reads (tile plus a one-column halo; stride 2 reads 2*kTileP + 1
// columns, de-interleaved into odd and even columns so that every tap
// reads consecutive rows) and the 9 taps' weights, double-buffered so
// the next chunk loads while this one computes. Each tap is one
// mma.sync.m16n8k32 s8 step per 16x8 tile, fragments loaded with
// ldmatrix from rows of 32 bytes whose 16-byte halves swap every 4 rows
// (no bank conflicts). The epilogue dequantizes in registers: the s32
// tensor never reaches device memory. No wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 128;  // output pixels of one row per block
constexpr int kTileN = 128;  // output channels per block
constexpr int kChunk = 32;   // input channels per stage (one mma k-step)
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of the 16-byte half `half` of 32-byte row `row` (swizzled).
__device__ __forceinline__ int swz(int row, int half) {
  return row * kChunk + ((half ^ ((row >> 2) & 1)) << 4);
}

template <int kStride, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv3x3_i8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ wt,
                      const float* __restrict__ dq, OutT* __restrict__ out,
                      int H, int W, int Cin, int Cout, int Wo) {
  // Rows of staged input per dy: stride 1 reads columns w0-1 .. w0+kTileP;
  // stride 2 reads 2*w0-1 .. 2*(w0+kTileP-1)+1, stored odd columns first
  // (kTileP + 1 rows), then even columns (kTileP rows).
  constexpr int kRows = kStride == 1 ? kTileP + 2 : 2 * kTileP + 1;
  constexpr int kXBytes = 3 * kRows * kChunk;
  constexpr int kWBytes = 9 * kTileN * kChunk;
  constexpr int kStage = kXBytes + kWBytes;
  extern __shared__ __align__(128) int8_t smem[];

  const int w0 = blockIdx.x * kTileP;
  const int n0 = blockIdx.y * kTileN;
  const int bh = blockIdx.z;  // b * H + h
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // 32-pixel slice
  const int wn = warp >> 2;  // 64-channel slice
  const int col0 = w0 * kStride - 1;
  const size_t img_row = (size_t)(bh - h) * W;  // b * H * W

  auto load_stage = [&](int chunk, int8_t* st) {
    const int k0 = chunk * kChunk;
    // Input: 3 rows x kRows columns x 2 halves.
    for (int i = tid; i < 3 * kRows * 2; i += kThreads) {
      const int half = i & 1;
      const int j = (i >> 1) % kRows;
      const int dy = (i >> 1) / kRows;
      const int hs = h + dy - 1;
      const int col = col0 + j;
      const bool ok = hs >= 0 && hs < H && col >= 0 && col < W;
      const int8_t* src =
          ok ? x + ((img_row + (size_t)hs * W + col) * Cin + k0 + half * 16)
             : x;
      const int r = kStride == 1 ? j : ((j & 1) ? kTileP + 1 + (j >> 1) : (j >> 1));
      cp_async16(st + dy * kRows * kChunk + swz(r, half), src, ok ? 16 : 0);
    }
    // Weights: 9 taps x kTileN channels x 2 halves.
    int8_t* sw = st + kXBytes;
    for (int i = tid; i < 9 * kTileN * 2; i += kThreads) {
      const int half = i & 1;
      const int n = (i >> 1) % kTileN;
      const int t = (i >> 1) / kTileN;
      const bool ok = n0 + n < Cout;
      const int8_t* src =
          ok ? wt + (((size_t)t * Cout + n0 + n) * Cin + k0 + half * 16) : wt;
      cp_async16(sw + t * kTileN * kChunk + swz(n, half), src, ok ? 16 : 0);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

  const int nchunks = Cin / kChunk;
  load_stage(0, smem);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load_stage(c + 1, smem + ((c + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* sx = smem + (c & 1) * kStage;
    const int8_t* sw = sx + kXBytes;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // Staged row of pixel p for this tap.
        const int base = kStride == 1 ? dx : (dx == 0 ? 0 : (dx == 1 ? kTileP + 1 : 1));
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = base + wm * 32 + mt * 16 + (lane & 15);
          ldmatrix_x4(a[mt], sx + dy * kRows * kChunk + swz(r, lane >> 4));
        }
        const int8_t* swt = sw + (dy * 3 + dx) * kTileN * kChunk;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = wn * 64 + q * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t b[4];
          ldmatrix_x4(b, swt + swz(n, (lane >> 3) & 1));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8_16832(acc[mt][2 * q], a[mt], b[0], b[1]);
            mma_s8_16832(acc[mt][2 * q + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: dequantize in registers and store.
  const int gid = lane >> 2;
  const int tig = lane & 3;
  OutT* orow = out + ((size_t)bh * Wo) * Cout;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + wn * 64 + nt * 8 + tig * 2;
    if (n >= Cout) continue;
    const float s0 = dq[n], s1 = dq[n + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int w = w0 + wm * 32 + mt * 16 + gid + r * 8;
        if (w >= Wo) continue;
        const float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * r]), s0);
        const float v1 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * r + 1]), s1);
        OutT* o = orow + (size_t)w * Cout + n;
        if constexpr (sizeof(OutT) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int kStride, typename OutT>
int launch(const void* x, const void* wt, const void* dq, void* out, int B,
           int H, int W, int Cin, int Cout, cudaStream_t stream) {
  constexpr int kRows = kStride == 1 ? kTileP + 2 : 2 * kTileP + 1;
  const int smem = 2 * (3 * kRows * kChunk + 9 * kTileN * kChunk);
  auto kernel = conv3x3_i8_kernel<kStride, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int Wo = (W - 1) / kStride + 1;
  const dim3 grid((Wo + kTileP - 1) / kTileP, (Cout + kTileN - 1) / kTileN,
                  B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)wt, (const float*)dq, (OutT*)out, H, W,
      Cin, Cout, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) int8; wt: (9, Cout, Cin) int8; dq: (Cout,) fp32;
// out: (B, H, (W - 1) / stride + 1, Cout), bf16 if out_bf16 else fp32.
// Cin must be a multiple of 32, Cout of 16, stride 1 or 2, B * H <= 65535.
extern "C" int rv3d_conv3x3_i8(const void* x, const void* wt, const void* dq,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int stride, int out_bf16,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % kChunk ||
      Cout % 16 || (stride != 1 && stride != 2) || (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stride == 1)
    return out_bf16 ? launch<1, __nv_bfloat16>(x, wt, dq, out, B, H, W, Cin, Cout, s)
                    : launch<1, float>(x, wt, dq, out, B, H, W, Cin, Cout, s);
  return out_bf16 ? launch<2, __nv_bfloat16>(x, wt, dq, out, B, H, W, Cin, Cout, s)
                  : launch<2, float>(x, wt, dq, out, B, H, W, Cin, Cout, s);
}
