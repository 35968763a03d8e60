// Fused int8 3x3 conv + per-channel dequant (K3) for Hopper (sm_90a).
//
// Replaces range_view_3d_detection_tpu/kernels/conv_pallas.py::
// conv3x3_i8_fused (_conv_kernel, _conv_kernel_s2). With taps wt (9, Cout,
// Cin) int8 ([n][k], dy-major) and fp32 dq (Cout):
//
//   out[b, h, w, n] = out_dtype( float(acc) * dq[n] ),
//   acc = sum_{dy, dx, k} q(x[b, h + dy - 1, s*w + dx - 1, k]) * wt[3dy+dx, n, k]
//
// with int32 accumulation, zeros outside the image, width stride s in
// {1, 2} and Wo = (W - 1) / s + 1. float(acc) rounds once to nearest
// (__int2float_rn): at Cin = 512, |acc| can pass 2^24. x is int8 (q is the
// identity: the TPU kernel's operand form) or the bf16/fp32 activation with
// a per-tensor scale s_in, quantized while it is staged:
//   q(v) = clamp(rint(v / s_in), -127, 127)
// with an IEEE division and round half to even: exactly the JAX package's
// clip(round(x.astype(f32) / in_scale), +-127). q(0) = 0, so the zero
// padding is exact.
//
// What bounds it on the H100: operations at the wide convs, bytes at the
// narrowest. The 512-channel head towers (B=2, 64x1808, 512 -> 512) are
// 1.09e12 int8 operations, 0.55 ms at the 1979 TOP/s dense int8 peak,
// against 0.47 GB of bf16 in and out (0.14 ms); the 256-channel stage-0
// convs likewise. The 128-channel backbone convs at W 113-904 are a few
// us of work bound by their bytes, where launch and pipeline fill cost
// as much as the work.
//
// Design, from that:
// - The tensor-core rate needs wgmma (m64n128k32, s8 x s8 -> s32), so a
//   block is warp-specialized: two consumer warpgroups accumulate in
//   registers (each two output rows of 64 pixels x 128 channels, one m64
//   tile a row, 128 int32 accumulators a thread); two producer warpgroups
//   fill a ring of 3-4 stages of 32 input channels, and thread 0 of them
//   loads the 9 taps' weights of the stage with one TMA copy (box (32,
//   128, 9), 32-byte swizzle: the wgmma K-major shared-memory layout for
//   one k32 step). Completion and release go through mbarriers (full: the
//   weights' bytes and the 8 producer warps; empty: the 8 consumer warps).
//   setmaxnreg moves registers from the producers to the consumers.
// - The 3x3 shift: tap dx reads the staged input rows shifted by dx
//   pixels, and a wgmma shared-memory descriptor cannot start inside a
//   swizzled 8-row group. So A goes through registers: ldmatrix at any
//   row offset from the staged tile (32-byte rows whose 16-byte halves
//   swap every 4 rows, the same 32-byte swizzle: conflict-free at every
//   offset), then wgmma with A in registers and B from shared memory. The
//   A fragments are double-buffered across taps (wait_group 1), so one
//   tap's ldmatrix overlaps the previous tap's wgmma.
// - The fused quantize: the producers stage A through registers anyway
//   (16 channels a 16-byte shared store), so they read the bf16/fp32
//   activation and quantize as they stage (Quantizer below: exact, 9
//   instructions an element); no quantized copy of the activation reaches
//   device memory, and no separate pass runs. The staging is the slower
//   side of the pipeline, so a thread's stage-invariant addressing is
//   computed once and its next batch of loads is in flight while it
//   quantizes.
// - Tiling: a block is 4 rows x 64 pixels, so the narrow convs still make
//   64-480 blocks a 128-channel tile (W 113-904) and the staged input is 6
//   rows for 4 outputs; the towers make 3712 blocks.
// - Stride 2: staged columns are de-interleaved into odd and even
//   columns, so every tap reads consecutive staged rows.
// - The epilogue dequantizes in registers (fp32 product, rounded once to
//   the output type): the s32 tensor never reaches device memory.
// - Any channel counts: a stage is 32 input channels, so the wrapper
//   (kernels/conv.py) pads another Cin with zero channels of x and of the
//   weights (q(0) = 0: the int32 sums are unchanged); the TMA reads output
//   channels past Cout as zero weights, and the epilogue stores none of
//   them (pairs of channels one at a time when Cout is odd).
// - Host side: the weight tensor map is encoded per launch
//   (cuTensorMapEncodeTiled, libcuda) and passed as a __grid_constant__;
//   the shared-memory attribute is set once per template instance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 32;        // input channels per stage (one wgmma k-step)
constexpr int kConsumerWGs = 2;   // two output rows each (one m64 tile a row)
constexpr int kMT = 2;            // m64 tiles per consumer
constexpr int kRows = kConsumerWGs * kMT;  // output rows per block
constexpr int kPw = 64;           // output pixels of a row in a block
constexpr int kBN = 128;          // output channels per block
// Two producer warpgroups: the staging with the quantize is the slower
// side of the pipeline.
constexpr int kProducerThreads = 256;
constexpr int kThreads = 128 * kConsumerWGs + kProducerThreads;
// 512 threads start at 128 registers; setmaxnreg moves 48 a thread from
// the producers to the consumers (the best of 64/72/80/88 on the H100),
// so that wgmma is not serialized for want of registers.
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 256 - kProducerRegs;
constexpr int kMaxSmem = 232448;  // per block, sm_90

template <int kStride>
struct Smem {
  static constexpr int kCols = kStride == 1 ? kPw + 2 : 2 * kPw + 1;
  static constexpr int kInRows = kRows + 2;
  static constexpr int kABytes = (kInRows * kCols * kChunk + 1023) / 1024 * 1024;
  static constexpr int kBBytes = 9 * kBN * kChunk;
  static constexpr int kStage = kBBytes + kABytes;
  static constexpr int kFit = (kMaxSmem - 3072) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBytes = kStages * kStage + 2048;  // + barriers, alignment
  static_assert(kStages >= 2, "K3: not enough shared memory for 2 stages");
};

// Byte offset of 16-byte half `half` of 32-byte row `row`: the 32-byte
// swizzle (bit 4 ^= bit 7 of the address), as TMA's SWIZZLE_32B writes it
// and wgmma's 32-byte-swizzle descriptors read it.
__device__ __forceinline__ int swz(int row, int half) {
  return row * kChunk + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Shared-memory matrix descriptor: K-major, 32-byte swizzle, 8-row groups
// 256 bytes apart (SBO); the leading offset is unused for one k32 step.
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The per-tensor quantizer q(v) = clamp(rint(v / s), -127, 127), with
// v / s correctly rounded, as an IEEE division gives it, in 9 pipelined
// instructions an element and no branch (div.rn is a branchy subroutine).
// - v is first clamped to +-RN(127 s): |v / s| beyond 127 gives +-127
//   either way, and nothing below can overflow.
// - The division is Markstein's: with r = RN(1/s), q0 = RN(v r) and one
//   fma correction q1 = RN(q0 + RN(v - q0 s) r) lie within an ulp of
//   v / s; then v - q1 s is exact in one fma and RN(q1 + (v - q1 s) r) is
//   RN(v / s). A scale within 2^+-60 keeps the remainder of any
//   |v / s| >= 1/4 normal (a smaller quotient rounds to 0 either way);
//   another scale takes div.rn. The choice is made once a kernel, not per
//   element (a branch per element costs as much as the quantize).
// - Adding 1.5 * 2^23 rounds half to even; the sum's low mantissa byte is
//   then q as a two's-complement byte, which byte permutes pack.
struct Quantizer {
  float s, r, lim;
  bool markstein;

  static __device__ __forceinline__ Quantizer of(float scale) {
    return {scale, __frcp_rn(scale), __fmul_rn(127.f, scale),
            scale >= 0x1p-60f && scale <= 0x1p60f};
  }

  // RN(v / s) + 1.5 * 2^23, for |v| <= 127 s.
  template <bool kMarkstein>
  __device__ __forceinline__ float biased(float v) const {
    v = fminf(fmaxf(v, -lim), lim);
    float y;
    if constexpr (kMarkstein) {
      const float q0 = __fmul_rn(v, r);
      const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
      y = __fmaf_rn(__fmaf_rn(-q1, s, v), r, q1);
    } else {
      y = __fdiv_rn(v, s);
    }
    return __fadd_rn(y, 12582912.f);
  }

  // Four quantized values, packed low byte first.
  template <bool kM>
  __device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) const {
    const uint32_t ab = __byte_perm(__float_as_uint(biased<kM>(a)),
                                    __float_as_uint(biased<kM>(b)), 0x0040);
    const uint32_t cd = __byte_perm(__float_as_uint(biased<kM>(c)),
                                    __float_as_uint(biased<kM>(d)), 0x0040);
    return __byte_perm(ab, cd, 0x5410);
  }
};

// 16 input elements (one 16-byte half of a 32-channel row) in registers.
template <typename InT>
struct Staged {
  static constexpr int kVecs = sizeof(InT);  // 16-byte loads per 16 elements
  uint4 v[kVecs];

  __device__ __forceinline__ void load(const InT* src, bool ok) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = ok ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
  }

  // The 16 elements quantized to int8 (int8 input passes through).
  template <bool kM>
  __device__ __forceinline__ uint4 quantized(const Quantizer& q) const {
    if constexpr (std::is_same<InT, int8_t>::value) {
      return v[0];
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        if constexpr (std::is_same<InT, float>::value) {
          const uint4 u = v[j];
          f[0] = __uint_as_float(u.x);
          f[1] = __uint_as_float(u.y);
          f[2] = __uint_as_float(u.z);
          f[3] = __uint_as_float(u.w);
        } else {  // bf16: 8 elements per 16-byte vector
          const uint4 u = v[j >> 1];
          const uint32_t lo = (j & 1) ? u.z : u.x;
          const uint32_t hi = (j & 1) ? u.w : u.y;
          f[0] = __uint_as_float(lo << 16);
          f[1] = __uint_as_float(lo & 0xffff0000u);
          f[2] = __uint_as_float(hi << 16);
          f[3] = __uint_as_float(hi & 0xffff0000u);
        }
        w[j] = q.template pack4<kM>(f[0], f[1], f[2], f[3]);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// A producer thread's share of one stage's input, kUnroll 16-byte halves
// at a time: loaded into registers, then quantized into shared memory.
template <typename InT, int kUnroll>
struct Batch {
  Staged<InT> in[kUnroll];
  int dst[kUnroll];  // byte offset in the stage's A tile, -1 past the end
};

template <int kStride, typename InT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_i8_wgmma(const __grid_constant__ CUtensorMap wmap,
                     const InT* __restrict__ x, const float* __restrict__ in_scale,
                     const float* __restrict__ dq, void* __restrict__ out,
                     int out_bf16, int H, int W, int Cin, int Cout, int Wo) {
  using S = Smem<kStride>;
  constexpr int kCols = S::kCols, kStages = S::kStages;
  constexpr int kItems = S::kInRows * kCols * 2;  // 16-byte halves per stage
  // 16-byte halves per producer batch (16 registers of data), two batches
  // in flight; int8 input at stride 1 takes two halves (8 registers): with
  // four it spilled in the 80-register producers (ptxas: 4 bytes stored, 8
  // loaded), and with two at stride 2 it spilled 16 bytes, so that
  // instance keeps four.
  constexpr int kUnroll = sizeof(InT) == 1 && kStride == 1 ? 2 : 4 / sizeof(InT);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStage);
  uint64_t* empty = full + kStages;
  auto stage_b = [&](int st) { return smem + st * S::kStage; };
  auto stage_a = [&](int st) { return smem + st * S::kStage + S::kBBytes; };

  const int w0 = blockIdx.x * kPw;
  const int n0 = blockIdx.y * kBN;
  const int hblocks = (H + kRows - 1) / kRows;
  const int b = blockIdx.z / hblocks;
  const int h0 = (blockIdx.z % hblocks) * kRows;
  const int nchunks = Cin / kChunk;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: each producer warp, and the weights' TMA; empty: each
      // consumer warp.
      mbar_init(&full[s], kProducerThreads / 32 + 1);
      mbar_init(&empty[s], 4 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= kConsumerWGs) {
    // ---------------- producers: weights by TMA, input through registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - 128 * kConsumerWGs;
    const Quantizer quant =
        Quantizer::of(std::is_same<InT, int8_t>::value ? 1.f : *in_scale);
    const int col0 = w0 * kStride - 1;
    constexpr int kPerBatch = kProducerThreads * kUnroll;
    constexpr int kBatches = (kItems + kPerBatch - 1) / kPerBatch;  // per stage
    // A thread's halves are the same in every stage but for the channel
    // offset: their offsets (-1: outside the image, zeros) and shared-memory
    // destinations (-1: past the tile) are computed once.
    const InT* xb = x + (size_t)b * H * W * Cin;
    int src[kBatches][kUnroll], dst[kBatches][kUnroll];
#pragma unroll
    for (int k = 0; k < kBatches; ++k) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = k * kPerBatch + u * kProducerThreads + pt;
        const int half = i & 1;
        const int j = (i >> 1) % kCols;  // staged column
        const int row = (i >> 1) / kCols;
        const int hs = h0 + row - 1;
        const int col = col0 + j;
        const bool ok = i < kItems && hs >= 0 && hs < H && col >= 0 && col < W;
        src[k][u] = ok ? (hs * W + col) * Cin + half * 16 : -1;
        // Stride 2 stores even staged columns (odd input columns) first.
        const int slot = kStride == 1 ? j : ((j & 1) ? kPw + 1 + (j >> 1) : (j >> 1));
        dst[k][u] = i < kItems ? swz(row * kCols + slot, half) : -1;
      }
    }
    auto load = [&](int c, int k, Batch<InT, kUnroll>& bt) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        bt.in[u].load(xb + src[k][u] + c * kChunk, src[k][u] >= 0);
    };
    auto store = [&](int c, int k, const Batch<InT, kUnroll>& bt, auto markstein) {
      const int st = c % kStages;
      if (k == 0) {
        const int lap = c / kStages;
        if (lap > 0) mbar_wait(&empty[st], (lap - 1) & 1);
        if (pt == 0) {
          mbar_arrive_tx(&full[st], S::kBBytes);
          tma_load_3d(stage_b(st), &wmap, &full[st], c * kChunk, n0, 0);
        }
      }
      uint8_t* sa = stage_a(st);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dst[k][u] >= 0)
          *reinterpret_cast<uint4*>(sa + dst[k][u]) =
              bt.in[u].template quantized<decltype(markstein)::value>(quant);
      }
      if (k == kBatches - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    };
    // Batches run across stage boundaries: batch k + 1 (or the next
    // stage's first) loads while batch k is quantized and stored, and
    // while the producer waits for a free stage.
    auto run = [&](auto markstein) {
      Batch<InT, kUnroll> cur, nxt;
      load(0, 0, cur);
      for (int c = 0; c < nchunks; ++c) {
#pragma unroll
        for (int k = 0; k < kBatches; ++k) {
          if (k + 1 < kBatches) {
            load(c, k + 1, nxt);
          } else if (c + 1 < nchunks) {
            load(c + 1, 0, nxt);
          }
          store(c, k, cur, markstein);
          cur = nxt;
        }
      }
    };
    if (std::is_same<InT, int8_t>::value || quant.markstein) {
      run(std::true_type());
    } else {
      run(std::false_type());
    }
  } else {
    // ---------------- consumers: output rows h0 + wg * kMT + mt (one m64
    // tile each), wgmma with A from registers.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wq = (threadIdx.x / 32) & 3;  // warp within the warpgroup
    int acc[kMT][kBN / 2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        acc[mt][i] = 0;
        fence_operand(acc[mt][i]);
      }
    uint32_t afrag[2][kMT][4];

    // One stage; kPar makes the A double buffer's index a constant.
    auto consume = [&](int c, auto par) {
      constexpr int kPar = decltype(par)::value;
      const int st = c % kStages;
      mbar_wait(&full[st], (c / kStages) & 1);
      const uint8_t* sa = stage_a(st);
      const uint8_t* sb = stage_b(st);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t % 3;
        const int base = kStride == 1 ? dx : (dx == 0 ? 0 : (dx == 1 ? kPw + 1 : 1));
        uint32_t (&a)[kMT][4] = afrag[(t + kPar) & 1];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r = (wg * kMT + mt + dy) * kCols + base + wq * 16 + (lane & 15);
          ldmatrix_x4(a[mt], sa + swz(r, lane >> 4));
        }
        wgmma_fence();
        const uint64_t desc = desc_sw32(sb + t * kBN * kChunk);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) wgmma_m64n128k32(acc[mt], a[mt], desc);
        wgmma_commit();
        wgmma_wait<1>();
        if (t == 0 && c > 0) {  // the previous stage's last wgmma is done
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(c - 1) % kStages]);
        }
      }
    };
    for (int c = 0; c < nchunks; c += 2) {
      consume(c, std::integral_constant<int, 0>());
      if (c + 1 < nchunks) consume(c + 1, std::integral_constant<int, 1>());
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[mt][i]);

    // Epilogue: dequantize in registers and store; channels past Cout are
    // not stored (an odd Cout stores its pairs one element at a time).
    const int gid = lane >> 2, tig = lane & 3;
    const bool pairs = (Cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + j * 8 + tig * 2;
      if (n >= Cout) continue;
      const bool second = n + 1 < Cout;
      const float s0 = dq[n], s1 = second ? dq[n + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int h = h0 + wg * kMT + mt;
        if (h >= H) continue;
        const size_t orow = ((size_t)b * H + h) * Wo;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int w = w0 + wq * 16 + gid + r * 8;
          if (w >= Wo) continue;
          const float v0 = __fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * r]), s0);
          const float v1 = __fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * r + 1]), s1);
          const size_t o = (orow + w) * Cout + n;
          if (out_bf16) {
            __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(ob) = __floats2bfloat162_rn(v0, v1);
            } else {
              ob[0] = __float2bfloat16_rn(v0);
              if (second) ob[1] = __float2bfloat16_rn(v1);
            }
          } else {
            float* of = static_cast<float*>(out) + o;
            if (pairs) {
              *reinterpret_cast<float2*>(of) = make_float2(v0, v1);
            } else {
              of[0] = v0;
              if (second) of[1] = v1;
            }
          }
        }
      }
    }
  }
}

template <int kStride, typename InT>
int launch(const CUtensorMap& wmap, const void* x, const void* in_scale,
           const void* dq, void* out, int out_bf16, int B, int H, int W, int Cin,
           int Cout, cudaStream_t stream) {
  using S = Smem<kStride>;
  auto kernel = conv3x3_i8_wgmma<kStride, InT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int Wo = (W - 1) / kStride + 1;
  const dim3 grid((Wo + kPw - 1) / kPw, (Cout + kBN - 1) / kBN,
                  B * ((H + kRows - 1) / kRows));
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      wmap, (const InT*)x, (const float*)in_scale, (const float*)dq, out, out_bf16,
      H, W, Cin, Cout, Wo);
  return (int)cudaGetLastError();
}

template <typename InT>
int launch_stride(int stride, const CUtensorMap& wmap, const void* x,
                  const void* in_scale, const void* dq, void* out, int out_bf16,
                  int B, int H, int W, int Cin, int Cout, cudaStream_t s) {
  return stride == 1
             ? launch<1, InT>(wmap, x, in_scale, dq, out, out_bf16, B, H, W, Cin, Cout, s)
             : launch<2, InT>(wmap, x, in_scale, dq, out, out_bf16, B, H, W, Cin, Cout, s);
}

}  // namespace

// x: (B, H, W, Cin), int8 (in_kind 0), bf16 (1, quantized with *in_scale)
// or fp32 (2, likewise); wt: (9, Cout, Cin) int8; dq: (Cout,) fp32;
// in_scale: fp32 scalar on the device (unused for int8 x);
// out: (B, H, (W - 1) / stride + 1, Cout), bf16 if out_bf16 else fp32.
// Cin must be a multiple of 32 (the wrapper pads any other Cin with zero
// channels), Cout any, stride 1 or 2, B * ceil(H / 4) <= 65535,
// H * W * Cin < 2^31; x and wt 16-byte aligned.
extern "C" int rv3d_conv3x3_i8(const void* x, const void* wt, const void* dq,
                               const void* in_scale, void* out, int B, int H,
                               int W, int Cin, int Cout, int stride, int in_kind,
                               int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % kChunk ||
      (stride != 1 && stride != 2) || in_kind < 0 || in_kind > 2 ||
      (in_kind != 0 && in_scale == nullptr) ||
      (long)B * ((H + kRows - 1) / kRows) > 65535 || (long)H * W * Cin >= (1l << 31))
    return (int)cudaErrorInvalidValue;
  // Weights as a 3-D tensor (Cin, Cout, 9), innermost first; one box holds
  // the 9 taps of 32 input channels for the block's 128 output channels.
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin, (cuuint64_t)Cout * Cin};
  const cuuint32_t box[3] = {kChunk, kBN, 9};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      &wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wt), dims, strides,
      box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_kind) {
    case 0:
      return launch_stride<int8_t>(stride, wmap, x, in_scale, dq, out, out_bf16, B, H, W,
                                   Cin, Cout, s);
    case 1:
      return launch_stride<__nv_bfloat16>(stride, wmap, x, in_scale, dq, out, out_bf16,
                                          B, H, W, Cin, Cout, s);
    default:
      return launch_stride<float>(stride, wmap, x, in_scale, dq, out, out_bf16, B, H, W,
                                  Cin, Cout, s);
  }
}
