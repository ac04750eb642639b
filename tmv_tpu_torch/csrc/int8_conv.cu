// int8 x int8 -> int32 convolutions for Hopper (sm_90a): a dense implicit GEMM on the
// int8 tensor cores and a direct depthwise convolution, both quantising their
// activations on load.
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
// taken first and the product rounded half to even, with IEEE division and the
// multiply and add of the epilogue rounded apart (__fmul_rn, __fadd_rn), as XLA
// and the plain PyTorch version compute them; so xq and acc are exact and the
// output is the plain version's to the bit. Activations are NHWC (a channels_last
// (B, C, H, W) tensor), f32 or bf16; the output is NHWC, f32 or (the cast that
// follows in a bf16 model, fused) rounded to bf16 to nearest even. A test entry
// writes the int32 accumulator instead of the output.
//
// int8_conv (groups = 1). GEMM view: M = B*Ho*Wo rows, N = Cout columns, K =
// kh*kw*Cin, with k = (dy*kw + dx)*Cin + c, so that a run of k is a run of channels
// of one input pixel. The weights are stored (Cout, Kpad), K padded with zeros to
// the 64-deep tile. What bounds it on the H100: at YOLOv4's 3x3 shapes the
// operations (2*M*N*K over 1,979 int8 TOP/s) and, at its 1x1 shapes with small
// Cout, the bytes (the f32/bf16 input read once, the f32 output written once, over
// 3.35 TB/s). The design is the simplest that feeds the tensor cores:
//
// - A block owns a 128-row x BN-column output tile (BN = 64 or 128 by Cout) and
//   walks K in 64-deep tiles. 8 warps, 4 x 2 over the tile; each warp issues
//   mma.sync.m16n8k32.s32.s8.s8.s32 on 32 x BN/2 of it (2 x BN/16 products per
//   32 of K), its accumulators in registers.
// - The im2col gather is implicit: each thread owns one output pixel's row of the
//   A tile and 32 of its 64 k, loads them from the activation (8 channels of one
//   pixel in one 32- or 16-byte load where Cin % 8 == 0, else element by
//   element), quantises them with the channel's reciprocal (per-channel ones
//   staged in shared memory once per block) and stores int8 to shared memory.
// - Two shared-memory stages: the next tile's global loads are issued into
//   registers before this tile's products and stored after them, one barrier a
//   tile. Rows are padded to 80 bytes, so the fragment loads (rows 0-7 of a
//   quad-group, 4 bytes each) fall on 32 distinct banks.
// - The epilogue writes pairs of channels, f32 or bf16.
// wgmma, TMA and a ring of stages are for a later PR.
//
// int8_dwconv (groups = C, EfficientDet's depthwise sites). No contraction axis,
// so no tensor-core product: one thread owns 4 (or 1) channels of one output pixel,
// sums its k*k taps in int32 (int8 x int8 products) and writes f32 or bf16. Bound by
// bytes (input read, output written once, over 3.35 TB/s); neighbouring threads
// read neighbouring channels, and the k*k re-reads of a pixel come from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // output pixels per block
constexpr int BK = 64;             // K per tile
constexpr int ROW = BK + 16;       // shared-memory row stride in bytes (bank-conflict pad)
constexpr int THREADS = 256;       // 8 warps

struct ConvParams {
  const void* x;
  const float* absmax;     // 1 or Cin values
  const int8_t* wq;        // (Cout, Kpad)
  const float* deq;        // (Cout,)
  const float* offset;     // (Cout,) or null
  void* out;               // (M, Cout) f32 or bf16, or null when acc_out is given
  int32_t* acc_out;        // (M, Cout) int32 (test entry), or null
  int batch, h, w, cin, cout, kh, kw, stride, pad_top, pad_left, h_out, w_out;
  int per_channel, k, kpad, out_bf16;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize(float v, float r) {
  const int q = __float2int_rn(__fmul_rn(v, r));   // rint: half to even
  return max(-127, min(127, q));
}

// Store y0 (and y1 at the next channel where `two`) at out[at], f32 or bf16.
__device__ __forceinline__ void store_out(void* out, bool bf16, size_t at, float y0, float y1,
                                          bool two, bool pairs) {
  if (bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
    if (two && pairs) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
    } else {
      o[0] = __float2bfloat16_rn(y0);
      if (two) o[1] = __float2bfloat16_rn(y1);
    }
  } else {
    float* o = static_cast<float*>(out) + at;
    if (two && pairs) {
      *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
    } else {
      o[0] = y0;
      if (two) o[1] = y1;
    }
  }
}

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (uint32_t(q0) & 0xffu) | ((uint32_t(q1) & 0xffu) << 8) |
         ((uint32_t(q2) & 0xffu) << 16) | ((uint32_t(q3) & 0xffu) << 24);
}

// 8 activation values of one A group, kept raw until after the tile's products.
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void set(int e, float v) {
    switch (e) {
      case 0: a.x = v; break; case 1: a.y = v; break; case 2: a.z = v; break;
      case 3: a.w = v; break; case 4: b.x = v; break; case 5: b.y = v; break;
      case 6: b.z = v; break; default: b.w = v; break;
    }
  }
  __device__ __forceinline__ void values(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};
template <> struct Raw8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void set(int e, __nv_bfloat16 v) {
    const uint32_t bits = __bfloat16_as_ushort(v);
    uint32_t* word = (e >> 1) == 0 ? &a.x : (e >> 1) == 1 ? &a.y : (e >> 1) == 2 ? &a.z : &a.w;
    *word = (e & 1) ? ((*word & 0xffffu) | (bits << 16)) : ((*word & 0xffff0000u) | bits);
  }
  __device__ __forceinline__ void values(float* f) const {
    const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const ConvParams p) {
  constexpr int WN = BN / 2;              // warp tile columns
  constexpr int NT = WN / 8;              // n8 products per warp per k32
  constexpr int B_CHUNKS = BN * BK / 16 / THREADS;   // 16-byte weight loads per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem);                 // [2][BM][ROW]
  int8_t* sb = sa + 2 * BM * ROW;                               // [2][BN][ROW]
  float* s_r = reinterpret_cast<float*>(sb + 2 * BN * ROW);     // [cin] when per-channel

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const long long m_total = (long long)p.batch * p.h_out * p.w_out;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* x = static_cast<const T*>(p.x);

  // reciprocals of the activation absmax, taken once per block
  float r_tensor = 0.f;
  if (p.per_channel) {
    for (int c = tid; c < p.cin; c += THREADS) s_r[c] = __fdiv_rn(127.0f, p.absmax[c]);
  } else {
    r_tensor = __fdiv_rn(127.0f, p.absmax[0]);
  }

  // this thread's A row: one output pixel, 32 of the tile's 64 k
  const int a_row = tid >> 1, a_half = tid & 1;
  const long long m = m0 + a_row;
  const bool m_ok = m < m_total;
  int iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (m_ok) {
    const int hw = p.h_out * p.w_out;
    const int b = int(m / hw);
    const int rem = int(m - (long long)b * hw);
    const int ho = rem / p.w_out, wo = rem - (rem / p.w_out) * p.w_out;
    iy0 = ho * p.stride - p.pad_top;
    ix0 = wo * p.stride - p.pad_left;
    xb = x + (size_t)b * p.h * p.w * p.cin;
  }

  Raw8<T> raw[4];
  int ci0[4];
  int4 braw[B_CHUNKS];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kt * BK + a_half * 32 + 8 * j;
      int tap = k / p.cin;
      int c = k - tap * p.cin;
      ci0[j] = c;
      if constexpr (VEC) {
        const int dy = tap / p.kw, dx = tap - (tap / p.kw) * p.kw;
        const int iy = iy0 + dy, ix = ix0 + dx;
        const bool ok = m_ok && k < p.k && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
        if (ok) raw[j].load(xb + ((size_t)iy * p.w + ix) * p.cin + c);
        else raw[j].zero();
      } else {
        raw[j].zero();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int dy = tap / p.kw, dx = tap - (tap / p.kw) * p.kw;
          const int iy = iy0 + dy, ix = ix0 + dx;
          if (m_ok && k + e < p.k && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
            raw[j].set(e, xb[((size_t)iy * p.w + ix) * p.cin + c]);
          if (++c == p.cin) { c = 0; ++tap; }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < B_CHUNKS; ++s) {
      const int q = tid + s * THREADS;
      const int row = q >> 2, col = (q & 3) * 16;
      const int n = n0 + row;
      braw[s] = n < p.cout
          ? __ldg(reinterpret_cast<const int4*>(p.wq + (size_t)n * p.kpad + kt * BK + col))
          : make_int4(0, 0, 0, 0);
    }
  };

  auto store_tile = [&](int stage) {
    int8_t* a_dst = sa + (stage * BM + a_row) * ROW + a_half * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[8];
      raw[j].values(v);
      int q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float r = r_tensor;
        if (p.per_channel) {
          int c = ci0[j] + e;
          if constexpr (!VEC) c %= p.cin;
          r = s_r[c];
        }
        q[e] = quantize(v[e], r);
      }
      uint2 packed = make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
      *reinterpret_cast<uint2*>(a_dst + 8 * j) = packed;
    }
#pragma unroll
    for (int s = 0; s < B_CHUNKS; ++s) {
      const int q = tid + s * THREADS;
      const int row = q >> 2, col = (q & 3) * 16;
      *reinterpret_cast<int4*>(sb + (stage * BN + row) * ROW + col) = braw[s];
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = p.kpad / BK;
  __syncthreads();                  // s_r ready
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) load_tile(kt + 1);
    const int8_t* a_base = sa + (stage * BM + wm * 32) * ROW;
    const int8_t* b_base = sb + (stage * BN + wn * WN) * ROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = a_base + (i * 16 + g) * ROW + kk + 4 * t4;
        const int8_t* r1 = r0 + 8 * ROW;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* c0 = b_base + (j * 8 + g) * ROW + kk + 4 * t4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (more) store_tile(stage ^ 1);
    __syncthreads();
  }

  // epilogue: float(acc) * deq + offset, rounded apart, f32 NHWC
  const bool pairs = (p.cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * WN + j * 8 + 2 * t4;
    if (n >= p.cout) continue;
    const bool two = n + 1 < p.cout;
    const float d0 = p.deq[n], d1 = two ? p.deq[n + 1] : 0.f;
    const float o0 = p.offset ? p.offset[n] : 0.f;
    const float o1 = (p.offset && two) ? p.offset[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wm * 32 + i * 16 + g + 8 * half;
        if (row >= m_total) continue;
        const int c0 = acc[i][j][2 * half], c1 = acc[i][j][2 * half + 1];
        const size_t at = (size_t)row * p.cout + n;
        if (p.acc_out) {
          p.acc_out[at] = c0;
          if (two) p.acc_out[at + 1] = c1;
          continue;
        }
        float y0 = __fmul_rn(float(c0), d0), y1 = __fmul_rn(float(c1), d1);
        if (p.offset) { y0 = __fadd_rn(y0, o0); y1 = __fadd_rn(y1, o1); }
        store_out(p.out, p.out_bf16, at, y0, y1, two, pairs);
      }
    }
  }
}

struct DwParams {
  const void* x;
  const float* absmax;     // 1 or C values
  const int8_t* wq;        // (k*k, C)
  const float* deq;        // (C,)
  const float* offset;     // (C,) or null
  void* out;               // f32 or bf16
  int32_t* acc_out;
  int batch, h, w, c, k, stride, pad_top, pad_left, h_out, w_out, per_channel, out_bf16;
};

template <typename T, int V>
__global__ void __launch_bounds__(256) int8_dwconv_kernel(const DwParams p) {
  const T* x = static_cast<const T*>(p.x);
  const int groups = p.c / V;
  const long long total = (long long)p.batch * p.h_out * p.w_out * groups;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int cg = int(idx % groups);
    const long long pix = idx / groups;
    const int wo = int(pix % p.w_out);
    const long long rest = pix / p.w_out;
    const int ho = int(rest % p.h_out);
    const int b = int(rest / p.h_out);
    const int c = cg * V;
    float r[V];
    int acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      r[v] = __fdiv_rn(127.0f, p.absmax[p.per_channel ? c + v : 0]);
      acc[v] = 0;
    }
    const T* xb = x + (size_t)b * p.h * p.w * p.c + c;
    for (int dy = 0; dy < p.k; ++dy) {
      const int iy = ho * p.stride - p.pad_top + dy;
      if (iy < 0 || iy >= p.h) continue;
      for (int dx = 0; dx < p.k; ++dx) {
        const int ix = wo * p.stride - p.pad_left + dx;
        if (ix < 0 || ix >= p.w) continue;
        const T* src = xb + ((size_t)iy * p.w + ix) * p.c;
        const int8_t* wsrc = p.wq + (size_t)(dy * p.k + dx) * p.c + c;
        float xv[V];
        int wv[V];
        if constexpr (V == 4) {
          if constexpr (sizeof(T) == 4) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(src));
            xv[0] = f.x; xv[1] = f.y; xv[2] = f.z; xv[3] = f.w;
          } else {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
            xv[0] = __uint_as_float(u.x << 16);
            xv[1] = __uint_as_float(u.x & 0xffff0000u);
            xv[2] = __uint_as_float(u.y << 16);
            xv[3] = __uint_as_float(u.y & 0xffff0000u);
          }
          const char4 q = __ldg(reinterpret_cast<const char4*>(wsrc));
          wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
        } else {
          xv[0] = to_float(src[0]);
          wv[0] = wsrc[0];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += quantize(xv[v], r[v]) * wv[v];
      }
    }
    const size_t at = (size_t)pix * p.c + c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (p.acc_out) {
        p.acc_out[at + v] = acc[v];
      } else {
        float y = __fmul_rn(float(acc[v]), p.deq[c + v]);
        if (p.offset) y = __fadd_rn(y, p.offset[c + v]);
        store_out(p.out, p.out_bf16, at + v, y, 0.f, false, false);
      }
    }
  }
}

template <typename T, int BN, bool VEC>
int launch_conv(const ConvParams& p, cudaStream_t stream) {
  static int prepared = 0;   // dynamic shared memory above 48 KB needs the opt-in
  const size_t smem = 2 * (BM + BN) * ROW + (p.per_channel ? sizeof(float) * p.cin : 0);
  if (!prepared) {
    const cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<T, BN, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 2 * (BM + BN) * ROW + 4 * 8192);
    if (err != cudaSuccess) return err;
    prepared = 1;
  }
  const long long m_total = (long long)p.batch * p.h_out * p.w_out;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((p.cout + BN - 1) / BN));
  int8_conv_kernel<T, BN, VEC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_conv(const ConvParams& p, int vec, cudaStream_t stream) {
  if (p.cout <= 64) return vec ? launch_conv<T, 64, true>(p, stream) : launch_conv<T, 64, false>(p, stream);
  return vec ? launch_conv<T, 128, true>(p, stream) : launch_conv<T, 128, false>(p, stream);
}

template <typename T, int V>
int launch_dw(const DwParams& p, cudaStream_t stream) {
  static int blocks = 0;   // resident blocks that fill the card
  if (!blocks) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_dwconv_kernel<T, V>, 256, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long total = (long long)p.batch * p.h_out * p.w_out * (p.c / V);
  const long long need = (total + 255) / 256;
  const int grid = int(need < blocks ? need : blocks);
  int8_dwconv_kernel<T, V><<<grid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tmv_int8_conv(const void* x, const float* absmax, int per_channel,
                             const int8_t* wq, int k, int kpad, const float* deq,
                             const float* offset, void* out, int32_t* acc_out, int batch,
                             int h, int w, int cin, int cout, int kh, int kw, int stride,
                             int pad_top, int pad_left, int h_out, int w_out, int bf16, int vec,
                             int out_bf16, void* stream) {
  if (batch <= 0 || h_out <= 0 || w_out <= 0 || cout <= 0 || cin <= 0 || cin > 8192 ||
      kpad % BK != 0 || k > kpad || k != kh * kw * cin || (vec && cin % 8 != 0) ||
      (out == nullptr) == (acc_out == nullptr) ||
      (long long)batch * h_out * w_out > (long long)(1u << 31) * BM)
    return cudaErrorInvalidValue;
  ConvParams p{x, absmax, wq, deq, offset, out, acc_out, batch, h, w, cin, cout, kh, kw,
               stride, pad_top, pad_left, h_out, w_out, per_channel, k, kpad, out_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_conv<__nv_bfloat16>(p, vec, s) : dispatch_conv<float>(p, vec, s);
}

extern "C" int tmv_int8_dwconv(const void* x, const float* absmax, int per_channel,
                               const int8_t* wq, const float* deq, const float* offset,
                               void* out, int32_t* acc_out, int batch, int h, int w, int c,
                               int k, int stride, int pad_top, int pad_left, int h_out,
                               int w_out, int bf16, int vec, int out_bf16, void* stream) {
  if (batch <= 0 || h_out <= 0 || w_out <= 0 || c <= 0 || k <= 0 || (vec && c % 4 != 0) ||
      (out == nullptr) == (acc_out == nullptr))
    return cudaErrorInvalidValue;
  DwParams p{x, absmax, wq, deq, offset, out, acc_out, batch, h, w, c, k, stride,
             pad_top, pad_left, h_out, w_out, per_channel, out_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return vec ? launch_dw<__nv_bfloat16, 4>(p, s) : launch_dw<__nv_bfloat16, 1>(p, s);
  return vec ? launch_dw<float, 4>(p, s) : launch_dw<float, 1>(p, s);
}

// What an int8_conv instantiation uses: registers per thread, static shared memory,
// spilled bytes per thread (local memory), threads per block.
extern "C" int tmv_int8_conv_info(int bn, int bf16, int vec, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  const void* fn;
  if (bn == 64) {
    fn = bf16 ? (vec ? (const void*)int8_conv_kernel<__nv_bfloat16, 64, true>
                     : (const void*)int8_conv_kernel<__nv_bfloat16, 64, false>)
              : (vec ? (const void*)int8_conv_kernel<float, 64, true>
                     : (const void*)int8_conv_kernel<float, 64, false>);
  } else if (bn == 128) {
    fn = bf16 ? (vec ? (const void*)int8_conv_kernel<__nv_bfloat16, 128, true>
                     : (const void*)int8_conv_kernel<__nv_bfloat16, 128, false>)
              : (vec ? (const void*)int8_conv_kernel<float, 128, true>
                     : (const void*)int8_conv_kernel<float, 128, false>);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int(2 * (BM + bn) * ROW);
  out[2] = int(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
