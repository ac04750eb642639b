// int8 x int8 -> int32 convolutions for Hopper (sm_90a): a dense implicit GEMM on the
// int8 tensor cores (wgmma) behind a one-pass quantize, and a halo-tiled depthwise
// convolution.
//
// Replaces XLA's int8 conv_general_dilated(preferred_element_type=int32) of the JAX
// package, tmv_tpu/quant/static.py:212 (static_int8_conv) and
// tmv_tpu/quant/dynamic.py:85 (dynamic_int8_conv); there is no Pallas kernel there.
// PyTorch has no int8 convolution on CUDA (F.conv2d refuses int8, torch._int_mm is a
// matrix product only), so the conv is written here. For every output pixel m =
// (b, ho, wo) and output channel o:
//
//   xq[b, y, x, c] = clip(rint(x[b, y, x, c] * r[c]), -127, 127),  r[c] = 127 / a[c]
//   acc[m, o]      = sum_{dy, dx, c} xq[b, ho*S - pt + dy, wo*S - pl + dx, c] * wq[o, dy, dx, c]
//   out[m, o]      = float(acc[m, o]) * deq[o] + offset[o]    (f32, or rounded to bf16)
//
// a is one per-tensor absmax or a per-input-channel vector; a tap outside the image
// reads zero (explicit top/left pads, the bottom/right ones follow from the output
// size: Darknet's top-left pad and TF-SAME are both covered). The reciprocal is
// taken first (IEEE division, __fdiv_rn) and the product rounded half to even; the
// multiply and add of the epilogue are rounded apart (__fmul_rn, __fadd_rn), as XLA
// and the plain PyTorch version compute them. So xq and acc are exact (int32 sums do
// not depend on their order) and the output is the plain version's to the bit.
// Activations are NHWC (a channels_last (B, C, H, W) tensor), f32 or bf16; the output
// is NHWC, f32 or (the cast that follows in a bf16 model, fused) rounded to bf16 to
// nearest even. A test entry writes the int32 accumulator instead of the output.
//
// int8_conv (groups = 1) is two launches on the caller's stream.
//
// 1. int8_quantize_kernel: x -> xq, int8 NHWC with the channels padded with zeros to
//    Cp, a multiple of 16 (Cin = 3 -> 16), so that every 16-byte chunk of xq is 16
//    channels of one pixel. Each activation element is read and quantised once per
//    conv, off the warps that feed the tensor cores (quantising on load would repeat
//    it kh*kw times). One thread a chunk: two 16-byte loads of 8 channels (bf16) or four
//    (f32) where Cin % 8 == 0, else element loads; the per-channel reciprocals are
//    taken once per block into shared memory; one 16-byte store. Bound by bytes: the
//    input read once and Cp bytes a pixel written.
// 2. int8_gemm_kernel: the implicit GEMM. M = B*Ho*Wo rows, N = Cout, K = kh*kw*Cp
//    with k = (dy*kw + dx)*Cp + c, both operands K-major as int8 wgmma requires; the
//    weights are packed at prepare to (Cout, Kpad), Kpad a multiple of the 64-deep
//    stage (pack_dense). A tile is 128 output pixels x BN channels, BN in {32, 64, 128}
//    chosen from Cout so that the Cout = 32/64 layers fill their tile. Persistent blocks
//    (as many as fit on the card) walk the tiles N first, so that the blocks running
//    together share their A rows in L2. Warp-specialised, 384 threads:
//    - a producer warpgroup fills a ring of 4 shared-memory stages (128 rows of A and
//      BN rows of B, 64 bytes of K each) for the consumers, ahead of them by up to the
//      whole ring, both operands under the 64-byte swizzle. B, the weights, comes by
//      TMA: one thread starts the copy of the (kt*64, n0) box of the (Cout, Kpad)
//      weights (rows past Cout zero-filled) with its byte count on the stage's "full"
//      mbarrier; the tensor map is encoded once per weight tensor
//      (tmv_int8_weight_map, cached by the wrapper) and passed as a __grid_constant__
//      parameter. A is the implicit im2col gather (each 16-byte chunk is one tap of 16
//      channels of one pixel; taps outside the image and K past kh*kw*Cp read as
//      zeros): each thread loads its chunks with 16-byte read-only loads, the next
//      stage's (across tiles too) in flight while it stores this one, then fences
//      the stores for the async proxy and arrives on "full"; it waits on the stage's
//      "empty" mbarrier before storing. Register-staged and not cp.async: on the H100
//      the 16-byte cp.async gather of the same chunks was the slower of the two at
//      YOLOv4's 3x3 shapes, with mbarrier and with cp.async-group completion alike
//      (measured while choosing the design; those timings are not kept); not TMA: the
//      activation's tensor map would bind the data pointer and be encoded on the host
//      for every call on a path bound by the host at B = 1, and a tiled TMA box cannot
//      express the strided, top-left padded gather of a 128-row M tile spanning
//      several image rows.
//    - two consumer warpgroups (rows 0-63 and 64-127 of the tile) wait on "full" and
//      run wgmma.mma_async.m64nBNk32.s32.s8.s8 twice a stage, both operands from
//      shared memory by descriptor (the 64-byte swizzle keeps wgmma's operand reads
//      free of bank conflicts), keep one
//      wgmma group in flight and hand the previous stage back on "empty". The int32
//      accumulators stay in registers (BN/2 a thread).
//    - the epilogue: float(acc) * deq + offset rounded apart, f32 or bf16 (or the raw
//      int32), staged through shared memory (a buffer of its own, so that the
//      producers fill the next tile's stages meanwhile) and written by every thread
//      of the warpgroup in 16-byte row-contiguous stores where Cout allows (8, 4 or 2
//      bytes otherwise).
//    What bounds it on the H100: bytes at YOLOv4's 1x1 and first layers (the input
//    read once, the output written once, over 3.35 TB/s), operations at its 3x3
//    layers at depth (2*M*N*K over 1,979 int8 TOP/s); in practice the on-chip traffic
//    of the gather (each xq chunk is loaded kh*kw times and each weight once a tile,
//    from L2) and the producer's load latency.
//
// int8_dwconv (groups = C, EfficientDet's depthwise sites), the design of
// dwconv_bn_swish.cu with an int8 middle: no contraction axis, so no tensor-core
// product, and bound by bytes (the input read once, the output written once, over
// 3.35 TB/s). Persistent blocks each own TH x TW = 8 x 8 output pixels x 32 channels
// of one image at a time; the input halo ((TH-1)*S + k)^2 pixels x 32 channels is
// staged with cp.async (zero-filled past the image and past C) into a double buffer,
// the next tile's copy overlapping this tile's work. Each staged element is quantised
// once into an int8 halo (the reciprocals once per block, in shared memory); each
// thread holds a channel pair's k*k taps in registers and slides its window over 2 x 4
// outputs in int32, reading each int8 pixel pair of the window once; the outputs leave
// as channel-pair vector stores. Index arithmetic is 32-bit, per tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------------ common pieces

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int quantize(float v, float r) {
  const int q = __float2int_rn(__fmul_rn(v, r));   // rint: half to even
  return max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (uint32_t(q0) & 0xffu) | ((uint32_t(q1) & 0xffu) << 8) |
         ((uint32_t(q2) & 0xffu) << 16) | ((uint32_t(q3) & 0xffu) << 24);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Copies 16 (or 8) bytes, or zero-fills them when src_bytes == 0 (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_ACC = 2 };

// ------------------------------------------------------------------ 1. quantize pass

struct QuantParams {
  const void* x;            // (pixels, c) f32 or bf16
  const float* absmax;      // 1 or c values
  int8_t* xq;               // (pixels, cp) int8
  int pixels, c, cp, per_channel, vec;
};

constexpr int Q_THREADS = 256;

// 8 bf16 values of a 16-byte word as floats.
__device__ __forceinline__ void bf16x8(const uint4 u, float* v) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// 8 channels [c0, c0 + 8) of one pixel's row in device memory as floats, zero past c.
template <typename T>
__device__ __forceinline__ void load8(const T* row, int c0, int c, bool vec, float* v) {
  if (vec && c0 + 8 <= c) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + c0));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + c0) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      bf16x8(__ldg(reinterpret_cast<const uint4*>(row + c0)), v);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < c ? to_float(row[c0 + e]) : 0.0f;
  }
}

// 8 values at a 16-byte aligned shared-memory address as floats.
template <typename T>
__device__ __forceinline__ void smem8(const unsigned char* at, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(at)[0];
    const float4 b = reinterpret_cast<const float4*>(at)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    bf16x8(*reinterpret_cast<const uint4*>(at), v);
  }
}

// Index of channel c in the reciprocal table: a pad word every 16 channels, so that
// the lanes of a warp, each on its own 16-channel chunk, read 32 distinct banks.
__device__ __forceinline__ int r_slot(int c) { return c + (c >> 4); }

template <typename T>
__global__ void __launch_bounds__(Q_THREADS) int8_quantize_kernel(const QuantParams p) {
  extern __shared__ float s_r[];   // per-channel reciprocals (r_slot), 0 past c
  const bool per_channel = p.per_channel != 0;
  const float r_tensor = per_channel ? 0.0f : __fdiv_rn(127.0f, p.absmax[0]);
  if (per_channel) {
    for (int c = threadIdx.x; c < p.cp; c += Q_THREADS)
      s_r[r_slot(c)] = c < p.c ? __fdiv_rn(127.0f, p.absmax[c]) : 0.0f;
  }
  __syncthreads();
  const T* x = static_cast<const T*>(p.x);
  const int chunks = p.cp >> 4;
  const int total = p.pixels * chunks;
  for (int i = blockIdx.x * Q_THREADS + threadIdx.x; i < total; i += gridDim.x * Q_THREADS) {
    const int pix = i / chunks;
    const int c0 = (i - pix * chunks) << 4;
    const T* row = x + static_cast<size_t>(pix) * p.c;
    uint32_t words[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[8], r[8];
      load8<T>(row, c0 + 8 * half, p.c, p.vec != 0, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = per_channel ? s_r[r_slot(c0 + 8 * half + e)] : r_tensor;
      words[2 * half] = pack4(quantize(v[0], r[0]), quantize(v[1], r[1]),
                              quantize(v[2], r[2]), quantize(v[3], r[3]));
      words[2 * half + 1] = pack4(quantize(v[4], r[4]), quantize(v[5], r[5]),
                                  quantize(v[6], r[6]), quantize(v[7], r[7]));
    }
    *reinterpret_cast<uint4*>(p.xq + static_cast<size_t>(pix) * p.cp + c0) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// ------------------------------------------------------------------ 2. implicit GEMM

constexpr int BM = 128;                // output pixels per tile: two wgmma m64
constexpr int BK = 64;                 // bytes of K per stage (two wgmma k32)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;         // two warpgroups: warps 0-7, rows 64*wg + [0, 64)
constexpr int PRODUCERS = 128;         // one warpgroup: warps 8-11
constexpr int GEMM_THREADS = CONSUMERS + PRODUCERS;
constexpr int GROUP = 8 * BK;          // bytes of 8 rows x 64 bytes of K: one swizzle atom

template <int BN>
struct GemmSmem {
  static constexpr int A_STAGE = BM * BK;
  static constexpr int B_STAGE = BN * BK;
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int OUT_ROW = BN * 4 + 16;      // epilogue staging row (f32/int32 + pad)
  static constexpr int OUT = BM * OUT_ROW;
  static constexpr int BYTES = RING + OUT + 2 * STAGES * 8;   // + full/empty mbarriers
};

struct GemmParams {
  const int8_t* xq;         // (B, H, W, cp)
  const int8_t* wq;         // (cout, kpad)
  const float* deq;         // (cout,)
  const float* offset;      // (cout,) or null
  void* out;                // (M, cout): f32, bf16 or int32
  int out_kind, store_bytes;
  int h, w, cp, cout, kh, kw, stride, pad_top, pad_left, h_out, w_out, kpad;
  int m_total, n_tiles, k_tiles, tiles;
};

// Shared-memory matrix descriptor of a K-major operand stored as rows of 64 bytes under
// the 64-byte swizzle (8-row atoms of 512 bytes, each 1 KB aligned ring stage holding
// whole atoms): start address, leading offset 1 (unused by swizzled K-major layouts),
// stride 512 bytes between 8-row groups (16-byte units), base offset 0, layout 2
// (64-byte swizzle). Advancing the start by 32 bytes moves to the second k32 of a row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(GROUP >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

template <int BN> struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
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
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Keeps the compiler from moving accumulator accesses across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives and adds `bytes` to the transaction count the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the box at (x, y) of a 2-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
      "r"(y), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t addr, const uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1) int8_gemm_kernel(
    const GemmParams p, const __grid_constant__ CUtensorMap wmap) {
  using L = GemmSmem<BN>;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  unsigned char* smem = gemm_smem;
  const uint32_t base = smem_addr(smem);
  const uint32_t a_ring = base, b_ring = base + STAGES * L::A_STAGE;
  unsigned char* staging = smem + L::RING;
  const uint32_t full = base + L::RING + L::OUT, empty = full + STAGES * 8;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // one arrival per producer thread, one more with the weights' TMA bytes
      mbar_init(full + 8 * s, PRODUCERS + 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers. Row r of a stage holds its 64 bytes of K as four 16-byte chunks,
    // chunk j at r*64 + 16*(j ^ ((r >> 1) & 3)): the 64-byte swizzle that wgmma's
    // descriptors name, so that its operand reads are free of bank conflicts, and that
    // TMA writes for the weights (the box of BN rows x 64 bytes at (kt*64, n0) of the
    // (Cout, Kpad) weights, rows past Cout zero-filled). Thread t gathers chunk j = t & 3
    // of A rows (t >> 2) + 32*i; thread 0 also starts the weights' copy.
    const int t = tid - CONSUMERS;
    const int j = t & 3;
    const int row0 = t >> 2;   // + 32*i
    constexpr int A_COPIES = BM * BK / 16 / PRODUCERS;   // 4
    const int hw_out = p.h_out * p.w_out;
    // the position of the next stage to gather: its tile's A rows, its K (channel c of
    // tap (dy, dx)), its tile index kt along K and its tile's first column n0
    int tile = blockIdx.x, kt = 0, n0 = 0, c = 0, dx = 0, dy = 0;
    int a_off[A_COPIES], a_iy[A_COPIES], a_ix[A_COPIES];
    auto start_tile = [&]() {
      const int m0 = (tile / p.n_tiles) * BM;
      n0 = (tile % p.n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int m = m0 + row0 + 32 * i;
        a_off[i] = 0;
        a_iy[i] = -(1 << 28);   // a row past M reads zeros: every tap is "outside"
        a_ix[i] = 0;
        if (m < p.m_total) {
          const int b = m / hw_out, rem = m - b * hw_out;
          const int ho = rem / p.w_out, wo = rem - ho * p.w_out;
          a_off[i] = b * p.h * p.w * p.cp;
          a_iy[i] = ho * p.stride - p.pad_top;
          a_ix[i] = wo * p.stride - p.pad_left;
        }
      }
      kt = 0;
      c = 16 * j;
      dx = dy = 0;
      while (c >= p.cp) {
        c -= p.cp;
        if (++dx == p.kw) { dx = 0; ++dy; }
      }
    };
    // gathers the next stage into registers (16-byte loads through the read-only path)
    // → its (kt, n0); then moves on, to the next tile's first stage after the last
    auto gather = [&](uint4 (&va)[A_COPIES], int& at_kt, int& at_n0) {
      const bool tap_ok = dy < p.kh;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
        const bool ok = tap_ok && static_cast<unsigned>(iy) < static_cast<unsigned>(p.h) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(p.w);
        va[i] = ok ? __ldg(reinterpret_cast<const uint4*>(p.xq + a_off[i] + (iy * p.w + ix) * p.cp + c))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      at_kt = kt;
      at_n0 = n0;
      if (++kt == p.k_tiles) {
        tile += gridDim.x;
        if (tile < p.tiles) start_tile();
        return;
      }
      c += BK;
      while (c >= p.cp) {
        c -= p.cp;
        if (++dx == p.kw) { dx = 0; ++dy; }
      }
    };
    if (tile >= p.tiles) return;
    start_tile();
    // the stage being stored (va) while the next one's loads (na) are in flight
    uint4 va[A_COPIES], na[A_COPIES];
    int st_kt, st_n0, nx_kt = 0, nx_n0 = 0;
    gather(va, st_kt, st_n0);
    for (int it = 0;; ++it) {
      const bool more = tile < p.tiles;
      if (more) gather(na, nx_kt, nx_n0);
      const int s = it % STAGES;
      mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      if (t == 0) {
        mbar_arrive_expect_tx(full + 8 * s, L::B_STAGE);
        tma_load_2d(b_ring + s * L::B_STAGE, &wmap, st_kt * BK, st_n0, full + 8 * s);
      }
      // rows row0 + 32*i share (row >> 1) & 3, so one swizzled offset serves them all
      const uint32_t a_dst = a_ring + s * L::A_STAGE + row0 * BK + 16 * (j ^ ((row0 >> 1) & 3));
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) st_shared16(a_dst + 32 * BK * i, va[i]);
      // wgmma reads the ring through the async proxy: order these generic-proxy stores
      // before it, then announce them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
      if (!more) break;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) va[i] = na[i];
      st_kt = nx_kt;
      st_n0 = nx_n0;
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows 64*wg + [0, 64) of each tile; thread (g, t4)
  // of its warp w holds rows 16w + g (+ 8) and columns 8j + 2*t4 (+ 1) at
  // acc[4j + 2*half (+ 1)]
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int osize = p.out_kind == OUT_BF16 ? 2 : 4;
  const int bar_id = 1 + wg;   // named barrier of this warpgroup's 128 threads
  unsigned char* out = static_cast<unsigned char*>(p.out);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.n_tiles) * BM + 64 * wg, n0 = (tile % p.n_tiles) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t da = smem_desc(a_ring + s * L::A_STAGE + wg * 64 * BK + kk * 32);
        const uint64_t db = smem_desc(b_ring + s * L::B_STAGE + kk * 32);
        Wgmma<BN>::mma(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      // the previous stage's products are done: hand it back to the producers
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

    // epilogue, staged in this warpgroup's half of the staging buffer (which its
    // previous tile's stores have finished reading)
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(128) : "memory");
    unsigned char* half_rows = staging + 64 * wg * L::OUT_ROW;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = 8 * jj + 2 * t4, n = n0 + col;
      float d0 = 0.f, d1 = 0.f, o0 = 0.f, o1 = 0.f;
      if (p.out_kind != OUT_ACC) {
        if (n < p.cout) d0 = __ldg(p.deq + n);
        if (n + 1 < p.cout) d1 = __ldg(p.deq + n + 1);
        if (p.offset) {
          if (n < p.cout) o0 = __ldg(p.offset + n);
          if (n + 1 < p.cout) o1 = __ldg(p.offset + n + 1);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half;
        const int a0 = acc[4 * jj + 2 * half], a1 = acc[4 * jj + 2 * half + 1];
        unsigned char* dst = half_rows + row * L::OUT_ROW + col * osize;
        if (p.out_kind == OUT_ACC) {
          *reinterpret_cast<int2*>(dst) = make_int2(a0, a1);
          continue;
        }
        float y0 = __fmul_rn(static_cast<float>(a0), d0);
        float y1 = __fmul_rn(static_cast<float>(a1), d1);
        if (p.offset) {
          y0 = __fadd_rn(y0, o0);
          y1 = __fadd_rn(y1, o1);
        }
        if (p.out_kind == OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      }
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(128) : "memory");
    // every (row, vector) pair of the half tile, spread over all 128 threads
    const int cols = min(BN, p.cout - n0);
    const int vw = p.store_bytes, vecs = cols * osize / vw;
    const int rows = min(64, p.m_total - m0);
    const int tid_wg = tid & 127;
    for (int i = tid_wg; i < rows * vecs; i += 128) {
      const int row = i / vecs, v = (i - row * vecs) * vw;
      unsigned char* dst = out + (static_cast<size_t>(m0 + row) * p.cout + n0) * osize + v;
      const unsigned char* src = half_rows + row * L::OUT_ROW + v;
      if (vw == 16) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if (vw == 8) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      else if (vw == 4) *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      else *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
    }
  }
}

// ------------------------------------------------------------------ int8 depthwise

constexpr int TH = 8;                         // output rows per tile
constexpr int TW = 8;                         // output columns per tile
constexpr int CB = 32;                        // channels per tile
constexpr int RH = 2;                         // output rows per thread
constexpr int RW = 4;                         // output columns per thread
constexpr int CPAIRS = CB / 2;                // channel pairs: one half-warp
constexpr int DW_THREADS = CPAIRS * (TH / RH) * (TW / RW);   // 128
constexpr int PAD_BYTES = 16;                 // per staged pixel, against bank conflicts
constexpr int Q_PIX = CB + PAD_BYTES;         // bytes of one int8 halo pixel

struct DwParams {
  const void* x;
  const float* absmax;      // 1 or c values
  const int8_t* wq;         // (k*k, c)
  const float* deq;         // (c,)
  const float* offset;      // (c,) or null
  void* out;                // f32, bf16 or int32
  int out_kind;
  int batch, h, w, c, h_out, w_out, pad_top, pad_left, per_channel;
  int unit;        // staging copy: 16 or 8 bytes by cp.async, 0 element by element
  int unit_shift;  // log2(copies per staged pixel) when unit > 0
  int pair_store;  // 1: store channel pairs (c even, aligned output)
  int tiles_y, tiles_x;
};

template <typename T, int K, int S>
struct DwTile {
  static constexpr int HP = (TH - 1) * S + K;   // halo rows
  static constexpr int WP = (TW - 1) * S + K;   // halo columns
  static constexpr int RAW_PIX = CB * static_cast<int>(sizeof(T)) + PAD_BYTES;
  static constexpr int RAW_BUF = HP * WP * RAW_PIX;
  static constexpr int Q_BUF = HP * WP * Q_PIX;
  static constexpr int SMEM_BYTES = 2 * RAW_BUF + Q_BUF + CB * 4;   // + reciprocals
};

// Stages the raw input halo of output tile (b, ty, tx), channels [c0, c0 + CB), in buf.
template <typename T, int K, int S>
__device__ __forceinline__ void dw_stage(unsigned char* buf, const DwParams& p, int b, int ty,
                                         int tx, int c0) {
  using G = DwTile<T, K, S>;
  const int gy0 = ty * TH * S - p.pad_top;
  const int gx0 = tx * TW * S - p.pad_left;
  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.h * p.w * p.c;
  if (p.unit > 0) {
    const int per_unit = p.unit / static_cast<int>(sizeof(T));   // channels per copy
    for (int i = threadIdx.x; i < (G::HP * G::WP) << p.unit_shift; i += DW_THREADS) {
      const int pix = i >> p.unit_shift, u = i & ((1 << p.unit_shift) - 1);
      const int hy = pix / G::WP, hx = pix - hy * G::WP;
      const int gy = gy0 + hy, gx = gx0 + hx, ch = c0 + u * per_unit;
      const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w && ch < p.c;
      const T* src = in ? xb + (gy * p.w + gx) * p.c + ch : xb;
      const uint32_t dst = smem_addr(buf + pix * G::RAW_PIX + u * p.unit);
      if (p.unit == 16) cp_async16(dst, src, in ? 16 : 0);
      else cp_async8(dst, src, in ? 8 : 0);
    }
  } else {
    using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
    const Raw* xr = reinterpret_cast<const Raw*>(xb);
    for (int i = threadIdx.x; i < G::HP * G::WP * CB; i += DW_THREADS) {
      const int pix = i / CB, ch = i - pix * CB;
      const int hy = pix / G::WP, hx = pix - hy * G::WP;
      const int gy = gy0 + hy, gx = gx0 + hx;
      const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.w && c0 + ch < p.c;
      reinterpret_cast<Raw*>(buf + pix * G::RAW_PIX)[ch] =
          in ? xr[(gy * p.w + gx) * p.c + c0 + ch] : Raw(0);
    }
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(DW_THREADS, 4) int8_dwconv_kernel(const DwParams p) {
  using G = DwTile<T, K, S>;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  unsigned char* smem = dw_smem;
  int8_t* q_buf = reinterpret_cast<int8_t*>(smem + 2 * G::RAW_BUF);
  float* s_r = reinterpret_cast<float*>(smem + 2 * G::RAW_BUF + G::Q_BUF);

  // Thread -> (channel pair, output patch), as dwconv_bn_swish.cu: the two half-warps
  // of a warp take neighbouring patches whose int8 pixels lie 16 banks apart.
  const int cpair = threadIdx.x % CPAIRS;
  const int q = threadIdx.x / CPAIRS;
  const int rowg = S == 1 ? q / 2 : q % 4;
  const int colg = S == 1 ? q % 2 : q / 4;
  const int oy0 = rowg * RH, ox0 = colg * RW;
  const int c0 = blockIdx.y * CB;
  const int c = c0 + 2 * cpair;
  const bool has0 = c < p.c, has1 = c + 1 < p.c;

  // the reciprocals once per block (the block keeps its channel chunk)
  if (threadIdx.x < CB) {
    const int ch = c0 + threadIdx.x;
    s_r[threadIdx.x] = ch < p.c ? __fdiv_rn(127.0f, p.absmax[p.per_channel ? ch : 0]) : 0.0f;
  }
  int taps[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    taps[t][0] = has0 ? p.wq[t * p.c + c] : 0;
    taps[t][1] = has1 ? p.wq[t * p.c + c + 1] : 0;
  }

  const int per_image = p.tiles_y * p.tiles_x;
  const int tiles = p.batch * per_image;
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  {
    const int b = tile / per_image, r = tile - b * per_image;
    dw_stage<T, K, S>(smem, p, b, r / p.tiles_x, r % p.tiles_x, c0);
  }
  cp_commit();

  const int u = threadIdx.x & 3;   // this thread's 8 channels of every pixel it quantises
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int b = next / per_image, r = next - b * per_image;
      dw_stage<T, K, S>(smem + ((it + 1) & 1) * G::RAW_BUF, p, b, r / p.tiles_x,
                        r % p.tiles_x, c0);
    }
    cp_commit();   // possibly empty: the wait below then still means "this tile"
    cp_wait_one();
    __syncthreads();

    // quantise the staged halo once into int8
    const unsigned char* raw = smem + (it & 1) * G::RAW_BUF;
    for (int i = threadIdx.x; i < G::HP * G::WP * (CB / 8); i += DW_THREADS) {
      const int pix = i >> 2;
      float v[8];
      smem8<T>(raw + pix * G::RAW_PIX + 8 * u * static_cast<int>(sizeof(T)), v);
      const float* r = s_r + 8 * u;
      *reinterpret_cast<uint2*>(q_buf + pix * Q_PIX + 8 * u) = make_uint2(
          pack4(quantize(v[0], r[0]), quantize(v[1], r[1]), quantize(v[2], r[2]),
                quantize(v[3], r[3])),
          pack4(quantize(v[4], r[4]), quantize(v[5], r[5]), quantize(v[6], r[6]),
                quantize(v[7], r[7])));
    }
    __syncthreads();

    const int8_t* qb = q_buf + ((oy0 * S) * G::WP + ox0 * S) * Q_PIX + 2 * cpair;
    int acc[RH][RW][2];
#pragma unroll
    for (int oy = 0; oy < RH; ++oy)
#pragma unroll
      for (int ox = 0; ox < RW; ++ox) acc[oy][ox][0] = acc[oy][ox][1] = 0;

#pragma unroll
    for (int r = 0; r < (RH - 1) * S + K; ++r) {
#pragma unroll
      for (int col = 0; col < (RW - 1) * S + K; ++col) {
        const char2 xv = *reinterpret_cast<const char2*>(qb + (r * G::WP + col) * Q_PIX);
        const int v0 = xv.x, v1 = xv.y;
#pragma unroll
        for (int oy = 0; oy < RH; ++oy) {
          const int dy = r - oy * S;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int ox = 0; ox < RW; ++ox) {
            const int dx = col - ox * S;
            if (dx < 0 || dx >= K) continue;
            acc[oy][ox][0] += v0 * taps[dy * K + dx][0];
            acc[oy][ox][1] += v1 * taps[dy * K + dx][1];
          }
        }
      }
    }

    const int b = tile / per_image, rem = tile - b * per_image;
    const int gy0 = (rem / p.tiles_x) * TH + oy0, gx0 = (rem % p.tiles_x) * TW + ox0;
    float d0 = 0.f, d1 = 0.f, o0 = 0.f, o1 = 0.f;
    if (p.out_kind != OUT_ACC) {
      d0 = has0 ? p.deq[c] : 0.f;
      d1 = has1 ? p.deq[c + 1] : 0.f;
      if (p.offset) {
        o0 = has0 ? p.offset[c] : 0.f;
        o1 = has1 ? p.offset[c + 1] : 0.f;
      }
    }
    const int img = b * p.h_out * p.w_out;
#pragma unroll
    for (int oy = 0; oy < RH; ++oy) {
#pragma unroll
      for (int ox = 0; ox < RW; ++ox) {
        const int gy = gy0 + oy, gx = gx0 + ox;
        if (!has0 || gy >= p.h_out || gx >= p.w_out) continue;
        const size_t at = static_cast<size_t>(img + gy * p.w_out + gx) * p.c + c;
        const int a0 = acc[oy][ox][0], a1 = acc[oy][ox][1];
        if (p.out_kind == OUT_ACC) {
          int* d = static_cast<int*>(p.out) + at;
          if (p.pair_store) {
            *reinterpret_cast<int2*>(d) = make_int2(a0, a1);
          } else {
            d[0] = a0;
            if (has1) d[1] = a1;
          }
          continue;
        }
        float y0 = __fmul_rn(static_cast<float>(a0), d0);
        float y1 = __fmul_rn(static_cast<float>(a1), d1);
        if (p.offset) {
          y0 = __fadd_rn(y0, o0);
          y1 = __fadd_rn(y1, o1);
        }
        if (p.out_kind == OUT_BF16) {
          __nv_bfloat16* d = static_cast<__nv_bfloat16*>(p.out) + at;
          if (p.pair_store) {
            *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(y0, y1);
          } else {
            d[0] = __float2bfloat16_rn(y0);
            if (has1) d[1] = __float2bfloat16_rn(y1);
          }
        } else {
          float* d = static_cast<float*>(p.out) + at;
          if (p.pair_store) {
            *reinterpret_cast<float2*>(d) = make_float2(y0, y1);
          } else {
            d[0] = y0;
            if (has1) d[1] = y1;
          }
        }
      }
    }
    __syncthreads();   // every thread is done with both halos before they are refilled
  }
}

// ------------------------------------------------------------------ host side

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename T>
cudaError_t launch_quantize(const QuantParams& p, cudaStream_t stream) {
  const int total = p.pixels * (p.cp >> 4);
  const int need = (total + Q_THREADS - 1) / Q_THREADS;
  const int cap = sm_count() * 8;
  const size_t smem = p.per_channel ? (p.cp + p.cp / 16) * sizeof(float) : 0;
  int8_quantize_kernel<T><<<need < cap ? need : cap, Q_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gemm(GemmParams p, const CUtensorMap& wmap, cudaStream_t stream) {
  static int resident = 0;   // blocks of this instantiation that fit on the card at once
  if (!resident) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmSmem<BN>::BYTES);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_gemm_kernel<BN>, GEMM_THREADS,
                                                  GemmSmem<BN>::BYTES);
    resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  const long long tiles = (static_cast<long long>(p.m_total) + BM - 1) / BM * p.n_tiles;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  const int grid = p.tiles < resident ? p.tiles : resident;
  int8_gemm_kernel<BN><<<grid, GEMM_THREADS, GemmSmem<BN>::BYTES, stream>>>(p, wmap);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up in the copy the CUDA runtime has loaded
// (so the library needs no link to libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <typename T, int K, int S>
cudaError_t dw_prepare(int* resident) {
  // Once per instantiation: allow its shared memory and count the blocks that fit.
  static int cached = 0;
  if (cached == 0) {
    auto kernel = int8_dwconv_kernel<T, K, S>;
    const int smem = DwTile<T, K, S>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DW_THREADS, smem);
    if (err != cudaSuccess) return err;
    cached = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  *resident = cached;
  return cudaSuccess;
}

template <typename T, int K, int S>
cudaError_t launch_dw(DwParams p, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = dw_prepare<T, K, S>(&resident);
  if (err != cudaSuccess) return err;
  p.tiles_y = (p.h_out + TH - 1) / TH;
  p.tiles_x = (p.w_out + TW - 1) / TW;
  const long long tiles = static_cast<long long>(p.batch) * p.tiles_y * p.tiles_x;
  const int chunks = (p.c + CB - 1) / CB;
  if (tiles > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidConfiguration;
  const long long per_chunk = (resident + chunks - 1) / chunks;
  const int blocks = static_cast<int>(tiles < per_chunk ? tiles : per_chunk);
  int8_dwconv_kernel<T, K, S><<<dim3(blocks, chunks), DW_THREADS, DwTile<T, K, S>::SMEM_BYTES,
                                stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_pick(const DwParams& p, int k, int stride, cudaStream_t s) {
  if (k == 3) return stride == 1 ? launch_dw<T, 3, 1>(p, s) : launch_dw<T, 3, 2>(p, s);
  return stride == 1 ? launch_dw<T, 5, 1>(p, s) : launch_dw<T, 5, 2>(p, s);
}

cudaError_t attributes(const void* fn, int smem, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = smem + static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  out[4] = threads;
  return cudaSuccess;
}

}  // namespace

// Quantises x (pixels, cin) NHWC, f32 (bf16 == 0) or bf16, into xq (pixels, cp) int8,
// cp a multiple of 16 >= cin, zeros past cin. vec: cin % 8 == 0 and x 16-byte aligned.
extern "C" int tmv_int8_quantize(const void* x, const float* absmax, int per_channel, int8_t* xq,
                                 int pixels, int cin, int cp, int bf16, int vec, void* stream) {
  if (pixels <= 0 || cin <= 0 || cp % 16 != 0 || cp < cin || cp > 8192 ||
      static_cast<long long>(pixels) * cp >= (1LL << 31) || (vec && cin % 8 != 0) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0)
    return cudaErrorInvalidValue;
  const QuantParams p{x, absmax, xq, pixels, cin, cp, per_channel, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_quantize<__nv_bfloat16>(p, s) : launch_quantize<float>(p, s);
}

// The dense int8 conv: the quantize pass into the scratch xq (batch*h*w*cp bytes,
// 16-byte aligned), then the implicit GEMM with BN = block_n columns a block; wmap is
// tmv_int8_weight_map's encoding of wq for block_n.
// out_kind: 0 f32, 1 bf16, 2 the int32 accumulator. wq (cout, kpad), kpad a multiple
// of 64 >= kh*kw*cp, 16-byte aligned. Returns a cudaError_t; does not synchronise.
extern "C" int tmv_int8_conv(const void* x, const float* absmax, int per_channel, int8_t* xq,
                             const int8_t* wq, const void* wmap, int kpad, const float* deq,
                             const float* offset,
                             void* out, int out_kind, int batch, int h, int w, int cin, int cp,
                             int cout, int kh, int kw, int stride, int pad_top, int pad_left,
                             int h_out, int w_out, int block_n, int bf16, int vec, void* stream) {
  const long long m_total = static_cast<long long>(batch) * h_out * w_out;
  if (batch <= 0 || h_out <= 0 || w_out <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || kpad % BK != 0 || kpad < kh * kw * cp || m_total >= (1LL << 31) ||
      static_cast<long long>(cout) * kpad >= (1LL << 31) || out_kind < 0 || out_kind > 2 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      (block_n != 32 && block_n != 64 && block_n != 128))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = static_cast<cudaError_t>(
      tmv_int8_quantize(x, absmax, per_channel, xq, batch * h * w, cin, cp, bf16, vec, stream));
  if (err != cudaSuccess) return err;
  GemmParams p{};
  p.xq = xq;
  p.wq = wq;
  p.deq = deq;
  p.offset = offset;
  p.out = out;
  p.out_kind = out_kind;
  p.h = h;
  p.w = w;
  p.cp = cp;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.h_out = h_out;
  p.w_out = w_out;
  p.kpad = kpad;
  p.m_total = static_cast<int>(m_total);
  p.n_tiles = (cout + block_n - 1) / block_n;
  p.k_tiles = kpad / BK;
  // the widest row store that every row start of the output allows
  const int osize = out_kind == OUT_BF16 ? 2 : 4;
  p.store_bytes = osize;
  for (int vw = 16; vw > osize; vw >>= 1) {
    if ((cout * osize) % vw == 0 && reinterpret_cast<uintptr_t>(out) % vw == 0) {
      p.store_bytes = vw;
      break;
    }
  }
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  if (block_n == 32) return launch_gemm<32>(p, map, s);
  if (block_n == 64) return launch_gemm<64>(p, map, s);
  return launch_gemm<128>(p, map, s);
}

// Encodes the TMA map of packed weights wq (cout, kpad) for tiles of block_n rows x 64
// bytes under the 64-byte swizzle into out (128 bytes, host memory): once per weight
// tensor, reused by every call (the map holds the pointer and the shape, nothing else).
extern "C" int tmv_int8_weight_map(const int8_t* wq, int cout, int kpad, int block_n, void* out) {
  if (cout <= 0 || kpad <= 0 || kpad % BK != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      (block_n != 32 && block_n != 64 && block_n != 128))
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(block_n)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wq),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  memcpy(out, &map, sizeof(map));
  return cudaSuccess;
}

// The depthwise int8 conv, k in {3, 5}, stride in {1, 2}. vec: c % 4 == 0 and x aligned
// to 4 elements (the halo is staged with 16- or 8-byte cp.async). out_kind as above.
extern "C" int tmv_int8_dwconv(const void* x, const float* absmax, int per_channel,
                               const int8_t* wq, const float* deq, const float* offset,
                               void* out, int out_kind, int batch, int h, int w, int c, int k,
                               int stride, int pad_top, int pad_left, int h_out, int w_out,
                               int bf16, int vec, void* stream) {
  if (batch <= 0 || h_out <= 0 || w_out <= 0 || c <= 0 || (k != 3 && k != 5) ||
      (stride != 1 && stride != 2) || (vec && c % 4 != 0) || out_kind < 0 || out_kind > 2 ||
      static_cast<long long>(batch) * h * w * c >= (1LL << 31) ||
      static_cast<long long>(batch) * h_out * w_out * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  DwParams p{x, absmax, wq, deq, offset, out, out_kind, batch, h, w, c, h_out, w_out,
             pad_top, pad_left, per_channel, 0, 0, 0, 0, 0};
  const int esize = bf16 ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (vec) {
    p.unit = ((c * esize) % 16 == 0 && xa % 16 == 0) ? 16 : 8;
    for (int copies = CB * esize / p.unit; copies > 1; copies >>= 1) ++p.unit_shift;
  }
  const int osize = out_kind == OUT_BF16 ? 2 : 4;
  p.pair_store = c % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * osize) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dw_pick<__nv_bfloat16>(p, k, stride, s) : dw_pick<float>(p, k, stride, s);
}

// What an instantiation uses on this card: out[0] registers per thread, out[1] shared
// memory per block in bytes, out[2] spilled (local) bytes per thread, out[3] resident
// blocks per SM, out[4] threads per block. kind 0: the GEMM with a = BN (32, 64, 128);
// kind 1: the quantize pass, a = bf16, at 64 channels; kind 2: the depthwise kernel,
// a = bf16, b = k, c = stride.
extern "C" int tmv_int8_kernel_info(int kind, int a, int b, int c, int* out) {
  if (kind == 0) {
    if (a == 32) return attributes((const void*)int8_gemm_kernel<32>, GemmSmem<32>::BYTES, GEMM_THREADS, out);
    if (a == 64) return attributes((const void*)int8_gemm_kernel<64>, GemmSmem<64>::BYTES, GEMM_THREADS, out);
    if (a == 128) return attributes((const void*)int8_gemm_kernel<128>, GemmSmem<128>::BYTES, GEMM_THREADS, out);
  } else if (kind == 1) {
    return attributes(a ? (const void*)int8_quantize_kernel<__nv_bfloat16>
                        : (const void*)int8_quantize_kernel<float>, 68 * 4, Q_THREADS, out);
  } else if (kind == 2 && (b == 3 || b == 5) && (c == 1 || c == 2)) {
    const int key = (a ? 4 : 0) + (b == 5 ? 2 : 0) + (c == 2 ? 1 : 0);
    switch (key) {
      case 0: return attributes((const void*)int8_dwconv_kernel<float, 3, 1>, DwTile<float, 3, 1>::SMEM_BYTES, DW_THREADS, out);
      case 1: return attributes((const void*)int8_dwconv_kernel<float, 3, 2>, DwTile<float, 3, 2>::SMEM_BYTES, DW_THREADS, out);
      case 2: return attributes((const void*)int8_dwconv_kernel<float, 5, 1>, DwTile<float, 5, 1>::SMEM_BYTES, DW_THREADS, out);
      case 3: return attributes((const void*)int8_dwconv_kernel<float, 5, 2>, DwTile<float, 5, 2>::SMEM_BYTES, DW_THREADS, out);
      case 4: return attributes((const void*)int8_dwconv_kernel<__nv_bfloat16, 3, 1>, DwTile<__nv_bfloat16, 3, 1>::SMEM_BYTES, DW_THREADS, out);
      case 5: return attributes((const void*)int8_dwconv_kernel<__nv_bfloat16, 3, 2>, DwTile<__nv_bfloat16, 3, 2>::SMEM_BYTES, DW_THREADS, out);
      case 6: return attributes((const void*)int8_dwconv_kernel<__nv_bfloat16, 5, 1>, DwTile<__nv_bfloat16, 5, 1>::SMEM_BYTES, DW_THREADS, out);
      default: return attributes((const void*)int8_dwconv_kernel<__nv_bfloat16, 5, 2>, DwTile<__nv_bfloat16, 5, 2>::SMEM_BYTES, DW_THREADS, out);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
