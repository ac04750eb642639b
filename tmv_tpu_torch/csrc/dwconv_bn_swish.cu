// Fused depthwise convolution + folded BatchNorm + swish for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels tmv_tpu/kernels/dwconv_pallas.py::_fused_s1
// (body _dw_kernel_s1_folded) and ::_fused_s2 (body _dw_kernel_s2_whole) with
// one kernel for both strides:
//
//   y = sum_{dy,dx < k} x[b, ho*S - pad_top + dy, wo*S - pad_left + dx, c] * w[dy, dx, c]
//   out[b, ho, wo, c] = swish(y * scale[c] + offset[c])
//
// with TF-SAME padding: a tap that falls outside the image reads zero, by a
// bounds check (no padded copy is made). Activations are NHWC (a channels_last
// (B, C, H, W) tensor) in f32 or bf16; taps (k, k, C), scale and offset (C,) are
// f32; sums are taken in f32 and the output is written in the activations' type.
// k is 3 or 5, the stride 1 or 2, and any C works: a C that is a multiple of 4
// (every EfficientNet-B0 width) takes 4-channel vector loads, any other C one
// channel per thread.
//
// What bounds it on the H100: device-memory bytes. A depthwise convolution has
// no contraction dimension, so the tensor cores have nothing to do; each output
// element costs 2k^2 + ~6 f32 operations, while each input element is read
// about once from device memory and each output element written once. Over the
// 16 launches of an EfficientDet-D0 @512 forward that is ~64 MB per image in
// bf16 against ~0.3 GFLOP: at 3.35 TB/s and 67 TFLOP/s (f32 outside the tensor
// cores) the bytes take several times longer than the arithmetic at every shape.
//
// The design, simple first: thread t owns VEC neighbouring channels of PIX
// neighbouring output pixels of one output row, and neighbouring threads own
// neighbouring channel groups, so the loads of one tap across a warp are
// contiguous 8- or 16-byte vectors along C. A thread reads its k^2 x VEC taps and
// its scale and offset once into registers and reuses them for its PIX pixels.
// The k^2 input loads of neighbouring pixels and rows overlap; L1 and L2 serve
// the repeats, so device memory sees about one read of each input element. No
// shared memory and no tensor cores. Staging a halo tile in shared memory, TMA
// and tuning PIX are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX = 4;        // output pixels per thread, along W
constexpr int THREADS = 256;  // threads per block

struct Params {
  const void* x;
  const float* w;
  const float* scale;
  const float* offset;
  void* out;
  int batch, h, width, c, h_out, w_out, pad_top, pad_left;
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (sizeof(T) == 4) {
    v[0] = *reinterpret_cast<const float*>(p);
  } else {
    v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = v[0];
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v[0]);
  }
}

template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(THREADS)
dw_bn_swish_kernel(const Params p) {
  const int groups = p.c / V;
  const int w_tiles = (p.w_out + PIX - 1) / PIX;
  const long long total = static_cast<long long>(p.batch) * p.h_out * w_tiles * groups;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int g = static_cast<int>(tid % groups);
  long long rest = tid / groups;
  const int wt = static_cast<int>(rest % w_tiles);
  rest /= w_tiles;
  const int ho = static_cast<int>(rest % p.h_out);
  const int b = static_cast<int>(rest / p.h_out);
  const int c0 = g * V;

  float taps[K * K][V];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    load_vec<float, V>(p.w + static_cast<size_t>(t) * p.c + c0, taps[t]);
  float sc[V], of[V];
  load_vec<float, V>(p.scale + c0, sc);
  load_vec<float, V>(p.offset + c0, of);

  const T* xb = static_cast<const T*>(p.x) + static_cast<size_t>(b) * p.h * p.width * p.c;
  T* orow = static_cast<T*>(p.out) +
            (static_cast<size_t>(b) * p.h_out + ho) * p.w_out * p.c;
  const int hi0 = ho * S - p.pad_top;
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int wo = wt * PIX + q;
    if (wo < p.w_out) {
      const int wi0 = wo * S - p.pad_left;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int hi = hi0 + dy;
        if (hi < 0 || hi >= p.h) continue;
        const T* row = xb + static_cast<size_t>(hi) * p.width * p.c;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int wi = wi0 + dx;
          if (wi < 0 || wi >= p.width) continue;
          float v[V];
          load_vec<T, V>(row + static_cast<size_t>(wi) * p.c + c0, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(v[i], taps[dy * K + dx][i], acc[i]);
        }
      }
      float y[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = acc[i] * sc[i] + of[i];
        y[i] = z / (1.0f + expf(-z));
      }
      store_vec<T, V>(orow + static_cast<size_t>(wo) * p.c + c0, y);
    }
  }
}

template <typename T, int K, int S, int V>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.batch) * p.h_out *
                          ((p.w_out + PIX - 1) / PIX) * (p.c / V);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dw_bn_swish_kernel<T, K, S, V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K, int S>
cudaError_t pick_vec(const Params& p, int vec, cudaStream_t s) {
  return vec == 4 ? launch<T, K, S, 4>(p, s) : launch<T, K, S, 1>(p, s);
}

template <typename T, int K>
cudaError_t pick_stride(const Params& p, int stride, int vec, cudaStream_t s) {
  return stride == 2 ? pick_vec<T, K, 2>(p, vec, s) : pick_vec<T, K, 1>(p, vec, s);
}

template <typename T>
cudaError_t pick_k(const Params& p, int k, int stride, int vec, cudaStream_t s) {
  return k == 5 ? pick_stride<T, 5>(p, stride, vec, s) : pick_stride<T, 3>(p, stride, vec, s);
}

}  // namespace

// x (batch, h, width, c) NHWC, f32 (bf16 == 0) or bf16 (bf16 == 1); w (k, k, c),
// scale (c,), offset (c,) f32; out (batch, h_out, w_out, c) NHWC in x's type; all
// on the device. vec is 4 (c % 4 == 0, vector-aligned pointers) or 1. Returns a
// cudaError_t; does not synchronise.
extern "C" int tmv_dw_bn_swish(const void* x, const float* w, const float* scale,
                               const float* offset, void* out, int batch, int h,
                               int width, int c, int h_out, int w_out, int pad_top,
                               int pad_left, int k, int stride, int bf16, int vec,
                               void* stream) {
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || (vec != 1 && vec != 4) ||
      c % vec != 0)
    return cudaErrorInvalidValue;
  const Params p{x, w, scale, offset, out, batch, h, width, c, h_out, w_out, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? pick_k<__nv_bfloat16>(p, k, stride, vec, s)
              : pick_k<float>(p, k, stride, vec, s);
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
