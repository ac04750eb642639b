// Greedy NMS suppression sweep for Hopper (sm_90a): a parallel IoU bitmask, then
// a one-warp scan per image.
//
// Replaces the Pallas TPU kernel tmv_tpu/kernels/nms_pallas.py::greedy_sweep_pallas
// (body _sweep_kernel). Given the score-sorted candidates of B images, each padded
// to N, it computes the kept mask: for i in order, an eligible box that no earlier
// kept box suppressed is kept and suppresses every later box j with
// IoU(i, j) >= threshold (and, class-aware, the same class id).
//
// The IoU arithmetic follows tmv_tpu/ops/iou.py, the CPU oracle, operation by
// operation (box i is b1, box j is b2), not the Pallas kernel's formulas:
//   xyxy iou : inter / (area1 + area2 - inter), unclamped widths, no zero guard;
//   xyxy diou: iou - (u / c)^0.6, iou kept where c == 0 (the YOLOv4 quirk);
//   yxyx iou : clamped widths, divide-no-nan;
//   yxyx diou: iou - divide_no_nan(u, c) (standard DIoU).
// Built with -fmad=false so that every product and sum rounds as in the plain
// PyTorch version and the kept sets compare exactly (a NaN IoU, as from two
// zero-area xyxy boxes, fails the >= test on both sides).
//
// What bounds it on the H100: latency, not bytes or FLOPs. At N = 1024 an image's
// candidates are 22.5 KB and the pairs ~46 operations each, but greedy order is
// sequential. One block walking the candidates with a block barrier per kept box
// keeps one SM of 132 busy per image and pays ~1 us per kept box. This design
// takes the IoU work out of the sequential part:
//
// 1. Mask kernel. The grid is the upper triangle of 64 x 64 tiles of the N x N
//    pair matrix, per image (136 tiles at N = 1024: one wave at B = 1). A block
//    stages its 64 column boxes in shared memory; thread i of the row tile
//    writes one 64-bit word, bit j set iff j > i, IoU(b_i, b_j) >= threshold and,
//    class-aware, c_i == c_j. mask is (B, N, ceil(N / 64)) words; the words left
//    of a row's own word are never written and never read.
//    Four threads share a row, 16 columns each. The DIoU variants first test
//    the plain IoU, which bounds the DIoU from above, and skip the distance
//    term (a powf for YOLOv4's quirk) for the pairs it already rules out.
// 2. Scan kernel, one warp per image. The image's mask is first copied into
//    shared memory by cp.async, all copies in flight together, when it fits
//    (N <= ~1,300 beside the eligible flags), else read from L2. For each word
//    of 64 candidates in order, the warp decides them in registers from the
//    eligible bits, the removed bits gathered so far and the rows' diagonal
//    words (the next word's are loaded ahead): ballots transpose the diagonal
//    into each candidate's column of earlier rows that mark it, and rounds of
//    ballots settle every candidate whose earlier markers are settled, so the
//    latency is one round per link of the longest chain of suppressions in the
//    word, not one per kept box. Then each lane ORs the kept rows' later words
//    into the removed words it owns (words w + 1 + l, w + 33 + l, ...), 64
//    loads in flight at once. kept = eligible & ~removed.
//
// A sweep is these two launches; tmv_nms_sweep issues both on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant { XYXY_IOU = 0, XYXY_DIOU = 1, YXYX_IOU = 2, YXYX_DIOU = 3 };

constexpr int TILE = 64;            // candidates per mask word and per tile side
constexpr int PART = 4;             // mask kernel: threads per row, 16 columns each
constexpr int MASK_THREADS = TILE * PART;
constexpr int SCAN_THREADS = 256;   // stage the mask with 8 warps; warp 0 scans
constexpr int MAX_WORDS = 192;      // mask words per row: N <= 12,288
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float div_no_nan(float a, float b) {
  return b == 0.0f ? 0.0f : a / b;
}

// tmv_tpu/ops/iou.py::iou_xyxy with b1 = (x1, y1, x2, y2) of box i.
template <bool DIOU>
__device__ __forceinline__ float iou_xyxy(float4 b1, float4 b2) {
  float iw = fmaxf(fminf(b1.z, b2.z) - fmaxf(b1.x, b2.x), 0.0f);
  float ih = fmaxf(fminf(b1.w, b2.w) - fmaxf(b1.y, b2.y), 0.0f);
  float inter = iw * ih;
  float area1 = (b1.z - b1.x) * (b1.w - b1.y);
  float area2 = (b2.z - b2.x) * (b2.w - b2.y);
  float iou = inter / (area1 + area2 - inter);
  if (!DIOU) return iou;
  float ubw = fmaxf(b1.z, b2.z) - fminf(b1.x, b2.x);
  float ubh = fmaxf(b1.w, b2.w) - fminf(b1.y, b2.y);
  float c = ubw * ubw + ubh * ubh;
  float dx = (b1.z + b1.x) / 2.0f - (b2.z + b2.x) / 2.0f;
  float dy = (b1.w + b1.y) / 2.0f - (b2.w + b2.y) / 2.0f;
  float u = dx * dx + dy * dy;
  float d = u / c;
  return c == 0.0f ? iou : iou - powf(d, 0.6f);
}

// tmv_tpu/ops/iou.py::iou_yxyx with b1 = (y1, x1, y2, x2) of box i.
template <bool DIOU>
__device__ __forceinline__ float iou_yxyx(float4 b1, float4 b2) {
  float w1 = fmaxf(0.0f, b1.w - b1.y);
  float h1 = fmaxf(0.0f, b1.z - b1.x);
  float w2 = fmaxf(0.0f, b2.w - b2.y);
  float h2 = fmaxf(0.0f, b2.z - b2.x);
  float area1 = w1 * h1;
  float area2 = w2 * h2;
  float inter = fmaxf(0.0f, fminf(b1.w, b2.w) - fmaxf(b1.y, b2.y)) *
                fmaxf(0.0f, fminf(b1.z, b2.z) - fmaxf(b1.x, b2.x));
  float iou = div_no_nan(inter, area1 + area2 - inter);
  if (!DIOU) return iou;
  float ey1 = fminf(b1.x, b2.x), ex1 = fminf(b1.y, b2.y);
  float ey2 = fmaxf(b1.z, b2.z), ex2 = fmaxf(b1.w, b2.w);
  float dy = (b2.x + b2.z) / 2.0f - (b1.x + b1.z) / 2.0f;
  float dx = (b2.y + b2.w) / 2.0f - (b1.y + b1.w) / 2.0f;
  float euclid = dy * dy + dx * dx;
  float diag = (ey2 - ey1) * (ey2 - ey1) + (ex2 - ex1) * (ex2 - ex1);
  return iou - div_no_nan(euclid, diag);
}

template <int VARIANT>
__device__ __forceinline__ float pair_iou(float4 bi, float4 bj) {
  if (VARIANT == XYXY_IOU) return iou_xyxy<false>(bi, bj);
  if (VARIANT == XYXY_DIOU) return iou_xyxy<true>(bi, bj);
  if (VARIANT == YXYX_IOU) return iou_yxyx<false>(bi, bj);
  return iou_yxyx<true>(bi, bj);
}

// The pair's plain IoU bounds its DIoU from above (the distance term is >= 0,
// so the subtraction rounds to at most the IoU, and a NaN stays NaN): when the
// IoU misses the threshold, pair_iou<VARIANT> would too and is not computed.
template <int VARIANT>
__device__ __forceinline__ bool suppresses(float4 bi, float4 bj, float threshold) {
  if (VARIANT == XYXY_DIOU && !(iou_xyxy<false>(bi, bj) >= threshold)) return false;
  if (VARIANT == YXYX_DIOU && !(iou_yxyx<false>(bi, bj) >= threshold)) return false;
  return pair_iou<VARIANT>(bi, bj) >= threshold;
}

template <int VARIANT, bool CLASS_AWARE>
__global__ void __launch_bounds__(MASK_THREADS) nms_mask_kernel(
    const float4* __restrict__ boxes, const int32_t* __restrict__ classes,
    unsigned long long* __restrict__ mask, int n, int words, float threshold) {
  // blockIdx.x enumerates the tiles (row tile rt, column tile ct >= rt)
  int t = blockIdx.x, rt = 0;
  while (t >= words - rt) {
    t -= words - rt;
    ++rt;
  }
  const int ct = rt + t;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;

  __shared__ float4 sbox[TILE];
  __shared__ int32_t scls[TILE];
  const int j = ct * TILE + threadIdx.x;
  if (threadIdx.x < TILE && j < n) {
    sbox[threadIdx.x] = boxes[base + j];
    scls[threadIdx.x] = CLASS_AWARE ? classes[base + j] : 0;
  }
  __syncthreads();

  // PART neighbouring lanes share row i, each testing TILE / PART columns.
  const int i = rt * TILE + threadIdx.x / PART;
  const int k0 = (threadIdx.x % PART) * (TILE / PART);
  unsigned long long bits = 0;
  if (i < n) {
    const float4 bi = boxes[base + i];
    const int32_t ci = CLASS_AWARE ? classes[base + i] : 0;
    const int k1 = min(k0 + TILE / PART, n - ct * TILE);
    for (int k = k0; k < k1; ++k) {
      if (ct * TILE + k <= i) continue;
      if (CLASS_AWARE && scls[k] != ci) continue;
      if (suppresses<VARIANT>(bi, sbox[k], threshold)) bits |= 1ull << k;
    }
  }
#pragma unroll
  for (int d = 1; d < PART; d <<= 1) bits |= __shfl_xor_sync(FULL, bits, d);
  if (i < n && k0 == 0) mask[(base + i) * words + ct] = bits;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(SCAN_THREADS) nms_scan_kernel(
    const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ eligible,
    uint8_t* __restrict__ kept, int n, int words, int staged) {
  extern __shared__ __align__(16) unsigned long long smask[];
  __shared__ unsigned long long removed[MAX_WORDS];
  __shared__ uint8_t selig[MAX_WORDS * TILE];
  const size_t img = static_cast<size_t>(blockIdx.x);
  const unsigned long long* m = mask + img * n * words;
  const uint8_t* elig = eligible + img * n;

  // Stage: the mask by cp.async, every copy in flight at once; the eligible
  // flags padded with zeros to whole words; the removed words cleared.
  if (staged) {
    const int total = n * words;
    if (reinterpret_cast<uintptr_t>(m) % 16 == 0 && total % 2 == 0) {
      for (int k = threadIdx.x; k < total / 2; k += SCAN_THREADS)
        cp_async(smask + 2 * k, m + 2 * k, 16);
    } else {
      for (int k = threadIdx.x; k < total; k += SCAN_THREADS) cp_async(smask + k, m + k, 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int k = threadIdx.x; k < words * TILE; k += SCAN_THREADS)
    selig[k] = k < n ? elig[k] : 0;
  for (int k = threadIdx.x; k < words; k += SCAN_THREADS) removed[k] = 0;
  if (staged) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    m = smask;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  uint8_t* out = kept + img * n;
  // diagonal words of the current word's rows; the next word's are loaded ahead
  unsigned long long d0 = lane < n ? m[static_cast<size_t>(lane) * words] : 0ull;
  unsigned long long d1 = lane + 32 < n ? m[static_cast<size_t>(lane + 32) * words] : 0ull;
  for (int w = 0; w < words; ++w) {
    const int r0 = (w + 1) * TILE + lane, r1 = r0 + 32;
    const unsigned long long n0 = r0 < n ? m[static_cast<size_t>(r0) * words + w + 1] : 0ull;
    const unsigned long long n1 = r1 < n ? m[static_cast<size_t>(r1) * words + w + 1] : 0ull;

    // Decide the word's 64 candidates (candidate lane in bit lane, lane + 32 in
    // bit lane + 32) without a serial chain through them. Transpose: col0 / col1
    // hold the available earlier rows of the word whose IoU bit marks this
    // lane's candidates. Then rounds: an undecided candidate is removed once a
    // kept candidate marks it, and kept once every available candidate that
    // could mark it is decided and none was kept; the lowest undecided one is
    // always ready, so each round decides at least one.
    const unsigned lo = __ballot_sync(FULL, selig[w * TILE + lane]);
    const unsigned hi = __ballot_sync(FULL, selig[w * TILE + 32 + lane]);
    const unsigned long long avail =
        ((static_cast<unsigned long long>(hi) << 32) | lo) & ~removed[w];
    const bool a0 = (avail >> lane) & 1ull, a1 = (avail >> (lane + 32)) & 1ull;
    unsigned long long col0 = 0, col1 = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {   // rows >= 32 mark only candidates >= 33
      const unsigned c = __ballot_sync(FULL, a0 && ((d0 >> i) & 1ull));
      if (lane == i) col0 = c;
    }
#pragma unroll
    for (int i = 32; i < TILE; ++i) {
      const unsigned c = __ballot_sync(FULL, a0 && ((d0 >> i) & 1ull));
      const unsigned c1 = __ballot_sync(FULL, a1 && ((d1 >> i) & 1ull));
      if (lane == i - 32) col1 = (static_cast<unsigned long long>(c1) << 32) | c;
    }
    unsigned long long keep = 0, decided = ~avail;
    while (decided != ~0ull) {
      bool k0 = false, k1 = false, x0 = false, x1 = false;
      if (!((decided >> lane) & 1ull)) {
        x0 = (col0 & keep) != 0 || (col0 & ~decided) == 0;
        k0 = (col0 & keep) == 0 && (col0 & ~decided) == 0;
      }
      if (!((decided >> (lane + 32)) & 1ull)) {
        x1 = (col1 & keep) != 0 || (col1 & ~decided) == 0;
        k1 = (col1 & keep) == 0 && (col1 & ~decided) == 0;
      }
      keep |= (static_cast<unsigned long long>(__ballot_sync(FULL, k1)) << 32) |
              __ballot_sync(FULL, k0);
      decided |= (static_cast<unsigned long long>(__ballot_sync(FULL, x1)) << 32) |
                 __ballot_sync(FULL, x0);
    }
    if (w * TILE + lane < n) out[w * TILE + lane] = static_cast<uint8_t>((keep >> lane) & 1ull);
    if (w * TILE + lane + 32 < n)
      out[w * TILE + lane + 32] = static_cast<uint8_t>((keep >> (lane + 32)) & 1ull);

    // Each lane ORs the kept rows' later words into the removed words it owns
    // (w + 1 + lane, w + 33 + lane, ...). A word with later words has all 64
    // rows; the 64 loads do not wait on each other, and a row that was not kept
    // contributes nothing.
    for (int wk = w + 1 + lane; wk < words; wk += 32) {
      const unsigned long long* col = m + static_cast<size_t>(w) * TILE * words + wk;
      unsigned long long acc = 0;
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        acc |= col[static_cast<size_t>(r) * words] & (0ull - ((keep >> r) & 1ull));
      removed[wk] |= acc;
    }
    __syncwarp();
    d0 = n0;
    d1 = n1;
  }
}

template <int VARIANT, bool CLASS_AWARE>
cudaError_t launch_mask(const float* boxes, const int32_t* classes, unsigned long long* mask,
                        int batch, int n, float threshold, cudaStream_t stream) {
  const int words = (n + TILE - 1) / TILE;
  const int tiles = words * (words + 1) / 2;
  nms_mask_kernel<VARIANT, CLASS_AWARE><<<dim3(tiles, batch), MASK_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), classes, mask, n, words, threshold);
  return cudaGetLastError();
}

bool shapes_ok(int batch, int n) {
  return batch > 0 && batch <= 65535 && n > 0 && (n + TILE - 1) / TILE <= MAX_WORDS;
}

}  // namespace

// Stage 1. boxes (batch, n, 4) f32, classes (batch, n) i32 or null; mask
// (batch, n, ceil(n / 64)) u64 out (only each row's own word and the words right
// of it are written); all contiguous on the device. variant: 0 xyxy iou, 1 xyxy
// diou, 2 yxyx iou, 3 yxyx diou. Returns a cudaError_t; does not synchronise.
extern "C" int tmv_nms_mask(const float* boxes, const int32_t* classes, void* mask, int batch,
                            int n, float threshold, int variant, void* stream) {
  if (!shapes_ok(batch, n)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* mk = static_cast<unsigned long long*>(mask);
  switch (variant * 2 + (classes != nullptr ? 1 : 0)) {
    case 0: return launch_mask<XYXY_IOU, false>(boxes, classes, mk, batch, n, threshold, s);
    case 1: return launch_mask<XYXY_IOU, true>(boxes, classes, mk, batch, n, threshold, s);
    case 2: return launch_mask<XYXY_DIOU, false>(boxes, classes, mk, batch, n, threshold, s);
    case 3: return launch_mask<XYXY_DIOU, true>(boxes, classes, mk, batch, n, threshold, s);
    case 4: return launch_mask<YXYX_IOU, false>(boxes, classes, mk, batch, n, threshold, s);
    case 5: return launch_mask<YXYX_IOU, true>(boxes, classes, mk, batch, n, threshold, s);
    case 6: return launch_mask<YXYX_DIOU, false>(boxes, classes, mk, batch, n, threshold, s);
    case 7: return launch_mask<YXYX_DIOU, true>(boxes, classes, mk, batch, n, threshold, s);
    default: return cudaErrorInvalidValue;
  }
}

// Stage 2. mask from stage 1, eligible (batch, n) u8, kept (batch, n) u8 out.
extern "C" int tmv_nms_scan(const void* mask, const uint8_t* eligible, uint8_t* kept,
                            int batch, int n, void* stream) {
  if (!shapes_ok(batch, n)) return cudaErrorInvalidValue;
  static int room = -1;   // dynamic shared memory a scan block may ask for
  if (room < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nms_scan_kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    room = optin - static_cast<int>(attr.sharedSizeBytes);
  }
  const int words = (n + TILE - 1) / TILE;
  const size_t bytes = static_cast<size_t>(n) * words * sizeof(unsigned long long);
  const int staged = bytes <= static_cast<size_t>(room);
  nms_scan_kernel<<<batch, SCAN_THREADS, staged ? bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask), eligible, kept, n, words, staged);
  return cudaGetLastError();
}

// The whole sweep: stage 1 then stage 2 on one stream (two kernel launches).
// mask is the caller's (batch, n, ceil(n / 64)) u64 scratch.
extern "C" int tmv_nms_sweep(const float* boxes, const uint8_t* eligible,
                             const int32_t* classes, void* mask, uint8_t* kept, int batch,
                             int n, float threshold, int variant, void* stream) {
  const int err = tmv_nms_mask(boxes, classes, mask, batch, n, threshold, variant, stream);
  if (err != cudaSuccess) return err;
  return tmv_nms_scan(mask, eligible, kept, batch, n, stream);
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
