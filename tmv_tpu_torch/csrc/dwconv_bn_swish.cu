// Fused depthwise convolution + folded BatchNorm + swish for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tmv_tpu/kernels/dwconv_pallas.py::_fused_s1
// (body _dw_kernel_s1_folded) and ::_fused_s2 (body _dw_kernel_s2_whole) with
// one kernel for both strides:
//
//   y = sum_{dy,dx < k} x[b, ho*S - pad_top + dy, wo*S - pad_left + dx, c] * w[dy, dx, c]
//   out[b, ho, wo, c] = swish(y * scale[c] + offset[c])
//
// with TF-SAME padding: a tap that falls outside the image reads zero.
// Activations are NHWC (a channels_last (B, C, H, W) tensor) in f32 or bf16;
// taps (k, k, C), scale and offset (C,) are f32; sums are taken in f32 and the
// output is written in the activations' type. k is 3 or 5, the stride 1 or 2,
// and any C, H and W work.
//
// What bounds it on the H100: device-memory bytes. A depthwise convolution has
// no contraction dimension, so the tensor cores have nothing to do; each output
// element costs 2k^2 + 6 f32 operations, while each input element need be read
// once from device memory and each output element written once. At every
// EfficientDet-D0 @512 shape the bytes over 3.35 TB/s take 3-10x longer than the
// operations over 67 TFLOP/s. So the design is about bytes in flight and reuse
// on chip:
//
// - Halo tile in shared memory. A block owns a tile of TH x TW output pixels x
//   CB channels of one image and stages its input halo, ((TH-1)*S + k) x
//   ((TW-1)*S + k) pixels x CB channels, in shared memory once, so each input
//   element of a tile comes from device memory once. The copy is cp.async with
//   zero fill (src-size 0) for the TF-SAME border and for channels past C, so
//   there are no bounds checks in the inner loop and no padded copy. cp.async
//   and not TMA: a tensor map binds the data pointer and has to be encoded on
//   the host for every call (this kernel runs 16 times per D0 forward on a path
//   bound by the host's call rate at B = 1), and TMA needs 16-byte strides,
//   which C*sizeof(T) % 16 != 0 layouts (C = 4 in bf16, odd C) do not have;
//   cp.async covers them with 8-byte copies or element loads in the same kernel.
// - Double buffering. Blocks are persistent: grid.y walks the channel chunks,
//   grid.x holds as many blocks per chunk as fit on the card at once, and each
//   block walks its chunk's tiles (neighbouring blocks on neighbouring tiles,
//   so the overlapping halos meet in L2). The next tile's copy is issued
//   before this tile's compute and overlaps it.
// - Sliding window in registers. Thread t owns a channel pair (bf16x2 or
//   float2) of an RH x RW patch of output pixels. It reads each staged input
//   pixel of its patch's window once from shared memory and feeds it to every
//   output of the patch that uses it: (RH-1)S+k rows x (RW-1)S+k columns of
//   loads for RH*RW outputs (48 for 8 outputs at k = 5, stride 1, where the k^2
//   loads per output would be 200). The two half-warps read two pixels whose
//   shared-memory rows are 16 banks apart (a 16-byte pad per staged pixel), so
//   the loads are free of bank conflicts.
// - Register budget. The thread's k^2 x 2 taps are loaded once per block into
//   registers (the block keeps one channel chunk), with 16 accumulators; scale
//   and offset are read in the epilogue. __launch_bounds__(128, 4) holds it to
//   <= 128 registers, so four 4-warp blocks fit an SM where shared memory
//   allows (bf16: 3 at k = 5, stride 2; f32 at stride 2: 2).
// - Filling the card at B = 1: 8 x 8 pixels x 32 channels give 144 tiles at the
//   smallest D0 shape (16 x 16 x 1152). Ragged H, W and C are masked.
//
// Instantiations: T in {f32, bf16} x k in {3, 5} x stride in {1, 2}, all with
// 128 threads; the staging copy width (16- or 8-byte cp.async, or element
// loads) and the output store (channel pairs, or single channels for odd C) are
// chosen per call from C and the pointers' alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TH = 8;                        // output rows per tile
constexpr int TW = 8;                        // output columns per tile
constexpr int CB = 32;                       // channels per tile
constexpr int RH = 2;                        // output rows per thread
constexpr int RW = 4;                        // output columns per thread
constexpr int CPAIRS = CB / 2;               // channel pairs: one half-warp
constexpr int SLOTS = (TH / RH) * (TW / RW);  // thread patches per channel pair
constexpr int THREADS = CPAIRS * SLOTS;      // 128
constexpr int PAD_BYTES = 16;                // per staged pixel, against bank conflicts

struct Params {
  const void* x;
  const float* w;
  const float* scale;
  const float* offset;
  void* out;
  int batch, h, width, c, h_out, w_out, pad_top, pad_left;
  int unit;        // staging copy: 16 or 8 bytes by cp.async, 0 element by element
  int unit_shift;  // log2(copies per staged pixel) when unit > 0
  int pair_store;  // 1: store channel pairs (C even, aligned output)
  int tiles_y, tiles_x;
};

template <typename T, int K, int S>
struct Tile {
  static constexpr int HP = (TH - 1) * S + K;  // halo rows
  static constexpr int WP = (TW - 1) * S + K;  // halo columns
  static constexpr int PIX_BYTES = CB * static_cast<int>(sizeof(T)) + PAD_BYTES;
  static constexpr int BUF_BYTES = HP * WP * PIX_BYTES;
  static constexpr int SMEM_BYTES = 2 * BUF_BYTES;  // double buffer
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `unit` bytes, or zero-fills them when src_bytes == 0 (nothing is read).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int unit, int src_bytes) {
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Stages the input halo of output tile (b, ty, tx), channels [c0, c0 + CB), in buf.
template <typename T, int K, int S>
__device__ __forceinline__ void stage(unsigned char* buf, const Params& p, int b, int ty,
                                      int tx, int c0) {
  using G = Tile<T, K, S>;
  const int gy0 = ty * TH * S - p.pad_top;
  const int gx0 = tx * TW * S - p.pad_left;
  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.h * p.width * p.c;
  if (p.unit > 0) {
    const int per_unit = p.unit / static_cast<int>(sizeof(T));  // channels per copy
    for (int i = threadIdx.x; i < (G::HP * G::WP) << p.unit_shift; i += THREADS) {
      const int pix = i >> p.unit_shift, u = i & ((1 << p.unit_shift) - 1);
      const int hy = pix / G::WP, hx = pix - hy * G::WP;
      const int gy = gy0 + hy, gx = gx0 + hx, ch = c0 + u * per_unit;
      const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.width && ch < p.c;
      const T* src = in ? xb + (static_cast<size_t>(gy) * p.width + gx) * p.c + ch : xb;
      cp_async(smem_addr(buf + pix * G::PIX_BYTES + u * p.unit), src, p.unit, in ? p.unit : 0);
    }
  } else {
    using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
    const Raw* xr = reinterpret_cast<const Raw*>(xb);
    for (int i = threadIdx.x; i < G::HP * G::WP * CB; i += THREADS) {
      const int pix = i / CB, ch = i - pix * CB;
      const int hy = pix / G::WP, hx = pix - hy * G::WP;
      const int gy = gy0 + hy, gx = gx0 + hx;
      const bool in = gy >= 0 && gy < p.h && gx >= 0 && gx < p.width && c0 + ch < p.c;
      reinterpret_cast<Raw*>(buf + pix * G::PIX_BYTES)[ch] =
          in ? xr[(static_cast<size_t>(gy) * p.width + gx) * p.c + c0 + ch] : Raw(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_pair(const unsigned char* s, float& a, float& b) {
  if constexpr (sizeof(T) == 4) {
    const float2 f = *reinterpret_cast<const float2*>(s);
    a = f.x;
    b = f.y;
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(s);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store_one(T* d, float v) {
  if constexpr (sizeof(T) == 4) *d = v;
  else *d = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* d, float a, float b) {
  if constexpr (sizeof(T) == 4) *reinterpret_cast<float2*>(d) = make_float2(a, b);
  else *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}

// z * sigmoid(z) with the fast exponential and division (2 ulp each): the IEEE
// expf and division cost as much as the k^2 taps at k = 3. For z below about
// -88 the denominator overflows and the result is 0, as swish tends to.
__device__ __forceinline__ float swish(float z) { return __fdividef(z, 1.0f + __expf(-z)); }

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS, 4) dw_bn_swish_tiled(const Params p) {
  using G = Tile<T, K, S>;
  extern __shared__ __align__(16) unsigned char smem[];

  // Thread -> (channel pair, output patch). The two half-warps of a warp take
  // neighbouring patches whose staged pixels lie 16 banks apart: along W at
  // stride 1, along H at stride 2.
  const int cp = threadIdx.x % CPAIRS;
  const int q = threadIdx.x / CPAIRS;
  const int rowg = S == 1 ? q / 2 : q % 4;
  const int colg = S == 1 ? q % 2 : q / 4;
  const int oy0 = rowg * RH, ox0 = colg * RW;
  const int c0 = blockIdx.y * CB;
  const int c = c0 + 2 * cp;
  const bool has0 = c < p.c, has1 = c + 1 < p.c;

  float taps[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    taps[t][0] = has0 ? p.w[static_cast<size_t>(t) * p.c + c] : 0.0f;
    taps[t][1] = has1 ? p.w[static_cast<size_t>(t) * p.c + c + 1] : 0.0f;
  }

  const int per_image = p.tiles_y * p.tiles_x;
  const int tiles = p.batch * per_image;
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  {
    const int b = tile / per_image, r = tile - b * per_image;
    stage<T, K, S>(smem, p, b, r / p.tiles_x, r % p.tiles_x, c0);
  }
  cp_commit();

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int b = next / per_image, r = next - b * per_image;
      stage<T, K, S>(smem + ((it + 1) & 1) * G::BUF_BYTES, p, b, r / p.tiles_x,
                     r % p.tiles_x, c0);
    }
    cp_commit();   // possibly empty: the wait below then still means "this tile"
    cp_wait_one();
    __syncthreads();

    const unsigned char* base = smem + (it & 1) * G::BUF_BYTES +
                                ((oy0 * S) * G::WP + ox0 * S) * G::PIX_BYTES +
                                cp * 2 * static_cast<int>(sizeof(T));
    float acc[RH][RW][2];
#pragma unroll
    for (int oy = 0; oy < RH; ++oy)
#pragma unroll
      for (int ox = 0; ox < RW; ++ox) acc[oy][ox][0] = acc[oy][ox][1] = 0.0f;

#pragma unroll
    for (int r = 0; r < (RH - 1) * S + K; ++r) {
#pragma unroll
      for (int col = 0; col < (RW - 1) * S + K; ++col) {
        float v0, v1;
        load_pair<T>(base + (r * G::WP + col) * G::PIX_BYTES, v0, v1);
#pragma unroll
        for (int oy = 0; oy < RH; ++oy) {
          const int dy = r - oy * S;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int ox = 0; ox < RW; ++ox) {
            const int dx = col - ox * S;
            if (dx < 0 || dx >= K) continue;
            acc[oy][ox][0] = fmaf(v0, taps[dy * K + dx][0], acc[oy][ox][0]);
            acc[oy][ox][1] = fmaf(v1, taps[dy * K + dx][1], acc[oy][ox][1]);
          }
        }
      }
    }

    const int b = tile / per_image, rem = tile - b * per_image;
    const int gy0 = (rem / p.tiles_x) * TH + oy0, gx0 = (rem % p.tiles_x) * TW + ox0;
    T* ob = static_cast<T*>(p.out) + static_cast<size_t>(b) * p.h_out * p.w_out * p.c;
    // read here (L1 hits) rather than held through the tile loop: 4 registers
    const float sc0 = has0 ? p.scale[c] : 0.0f, sc1 = has1 ? p.scale[c + 1] : 0.0f;
    const float of0 = has0 ? p.offset[c] : 0.0f, of1 = has1 ? p.offset[c + 1] : 0.0f;
#pragma unroll
    for (int oy = 0; oy < RH; ++oy) {
#pragma unroll
      for (int ox = 0; ox < RW; ++ox) {
        const int gy = gy0 + oy, gx = gx0 + ox;
        if (!has0 || gy >= p.h_out || gx >= p.w_out) continue;
        const float y0 = swish(acc[oy][ox][0] * sc0 + of0);
        const float y1 = swish(acc[oy][ox][1] * sc1 + of1);
        T* d = ob + (static_cast<size_t>(gy) * p.w_out + gx) * p.c + c;
        if (p.pair_store) {
          store_pair<T>(d, y0, y1);
        } else {
          store_one<T>(d, y0);
          if (has1) store_one<T>(d + 1, y1);
        }
      }
    }
    __syncthreads();   // every thread is done with this buffer before it is refilled
  }
}

template <typename T, int K, int S>
cudaError_t prepare(int* resident) {
  // Once per instantiation: allow its shared memory and count the blocks that
  // fit on the card at once.
  static int cached = 0;
  if (cached == 0) {
    auto kernel = dw_bn_swish_tiled<T, K, S>;
    const int smem = Tile<T, K, S>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    cached = (per_sm > 0 ? per_sm : 1) * sms;
  }
  *resident = cached;
  return cudaSuccess;
}

template <typename T, int K, int S>
cudaError_t launch(Params p, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = prepare<T, K, S>(&resident);
  if (err != cudaSuccess) return err;
  p.tiles_y = (p.h_out + TH - 1) / TH;
  p.tiles_x = (p.w_out + TW - 1) / TW;
  const long long tiles = static_cast<long long>(p.batch) * p.tiles_y * p.tiles_x;
  if (tiles == 0 || p.c == 0) return cudaSuccess;
  const int chunks = (p.c + CB - 1) / CB;
  if (tiles > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidConfiguration;
  const long long per_chunk = (resident + chunks - 1) / chunks;
  const int blocks = static_cast<int>(tiles < per_chunk ? tiles : per_chunk);
  dw_bn_swish_tiled<T, K, S><<<dim3(blocks, chunks), THREADS, Tile<T, K, S>::SMEM_BYTES,
                               stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t pick_stride(const Params& p, int stride, cudaStream_t s) {
  return stride == 2 ? launch<T, K, 2>(p, s) : launch<T, K, 1>(p, s);
}

template <typename T>
cudaError_t pick_k(const Params& p, int k, int stride, cudaStream_t s) {
  return k == 5 ? pick_stride<T, 5>(p, stride, s) : pick_stride<T, 3>(p, stride, s);
}

template <typename T, int K, int S>
cudaError_t info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, dw_bn_swish_tiled<T, K, S>);
  if (err != cudaSuccess) return err;
  int resident = 0, dev = 0, sms = 1;
  if ((err = prepare<T, K, S>(&resident)) != cudaSuccess) return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes) + Tile<T, K, S>::SMEM_BYTES;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = resident / sms;
  out[4] = THREADS;
  return cudaSuccess;
}

}  // namespace

// x (batch, h, width, c) NHWC, f32 (bf16 == 0) or bf16 (bf16 == 1); w (k, k, c),
// scale (c,), offset (c,) f32; out (batch, h_out, w_out, c) NHWC in x's type; all
// on the device. vec is 4 (c % 4 == 0 and x aligned to 4 elements: the halo is
// staged with 16- or 8-byte cp.async) or 1 (element by element). Returns a
// cudaError_t; does not synchronise.
extern "C" int tmv_dw_bn_swish(const void* x, const float* w, const float* scale,
                               const float* offset, void* out, int batch, int h,
                               int width, int c, int h_out, int w_out, int pad_top,
                               int pad_left, int k, int stride, int bf16, int vec,
                               void* stream) {
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || (vec != 1 && vec != 4) ||
      c % vec != 0)
    return cudaErrorInvalidValue;
  Params p{x, w, scale, offset, out, batch, h, width, c, h_out, w_out, pad_top, pad_left,
           0, 0, 0, 0, 0};
  const size_t esize = bf16 ? 2 : 4;
  const size_t row = static_cast<size_t>(c) * esize;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (vec == 4) {
    p.unit = (row % 16 == 0 && xa % 16 == 0) ? 16 : 8;
    for (int copies = CB * static_cast<int>(esize) / p.unit; copies > 1; copies >>= 1)
      ++p.unit_shift;
  }
  p.pair_store = c % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * esize) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? pick_k<__nv_bfloat16>(p, k, stride, s) : pick_k<float>(p, k, stride, s);
}

// What the instantiation for (k, stride, bf16) uses on this card: out[0]
// registers per thread, out[1] shared memory per block in bytes (the double
// buffer included), out[2] local (spilled) bytes per thread, out[3] resident
// blocks per SM, out[4] threads per block. Returns a cudaError_t.
extern "C" int tmv_dw_bn_swish_info(int k, int stride, int bf16, int* out) {
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2)) return cudaErrorInvalidValue;
  const int key = (bf16 ? 4 : 0) + (k == 5 ? 2 : 0) + (stride == 2 ? 1 : 0);
  switch (key) {
    case 0: return info<float, 3, 1>(out);
    case 1: return info<float, 3, 2>(out);
    case 2: return info<float, 5, 1>(out);
    case 3: return info<float, 5, 2>(out);
    case 4: return info<__nv_bfloat16, 3, 1>(out);
    case 5: return info<__nv_bfloat16, 3, 2>(out);
    case 6: return info<__nv_bfloat16, 5, 1>(out);
    default: return info<__nv_bfloat16, 5, 2>(out);
  }
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
