// Greedy NMS suppression sweep for Hopper (sm_90a), one thread block per image.
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
// PyTorch version and the kept sets compare exactly.
//
// What bounds it on the H100: latency, not bytes or FLOPs. At N = 1024 an image's
// candidates are 22.5 KB and one step is ~20 FLOPs per candidate, but the steps
// are sequential: each kept box is one pass over the later candidates followed by
// one block barrier. The design keeps everything in shared memory (no device
// memory traffic inside the sweep), gives each thread ceil(N / blockDim)
// candidates, skips the barrier on steps whose box is not kept (the decision is
// uniform across the block, and such a step writes nothing), and runs the B
// images of a batch as B independent blocks of one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant { XYXY_IOU = 0, XYXY_DIOU = 1, YXYX_IOU = 2, YXYX_DIOU = 3 };

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

template <int VARIANT, bool CLASS_AWARE>
__global__ void nms_sweep_kernel(const float4* __restrict__ boxes,
                                 const uint8_t* __restrict__ eligible,
                                 const int32_t* __restrict__ classes,
                                 uint8_t* __restrict__ kept, int n,
                                 float threshold) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                   // n boxes
  int32_t* scls = reinterpret_cast<int32_t*>(sbox + n);  // n class ids
  uint8_t* ssup = reinterpret_cast<uint8_t*>(scls + n);  // n suppressed flags
  uint8_t* selig = ssup + n;                             // n eligible flags

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sbox[j] = boxes[base + j];
    scls[j] = CLASS_AWARE ? classes[base + j] : 0;
    ssup[j] = 0;
    selig[j] = eligible[base + j];
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // Every thread reads the same flags, written at the latest before the last
    // barrier, so the branch is uniform and a skipped step needs no barrier.
    if (ssup[i] || !selig[i]) continue;
    const float4 bi = sbox[i];
    const int32_t ci = scls[i];
    // Thread t owns candidates j = t, t + blockDim, ...; only j > i matter.
    int j = threadIdx.x;
    if (j <= i) j += ((i - j) / blockDim.x + 1) * blockDim.x;
    for (; j < n; j += blockDim.x) {
      if (ssup[j]) continue;
      if (CLASS_AWARE && scls[j] != ci) continue;
      if (pair_iou<VARIANT>(bi, sbox[j]) >= threshold) ssup[j] = 1;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x)
    kept[base + j] = selig[j] && !ssup[j];
}

template <int VARIANT, bool CLASS_AWARE>
cudaError_t launch(const float* boxes, const uint8_t* eligible,
                   const int32_t* classes, uint8_t* kept, int batch, int n,
                   float threshold, cudaStream_t stream) {
  auto kernel = nms_sweep_kernel<VARIANT, CLASS_AWARE>;
  const size_t smem = static_cast<size_t>(n) *
                      (sizeof(float4) + sizeof(int32_t) + 2 * sizeof(uint8_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  kernel<<<batch, threads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), eligible, classes, kept, n,
      threshold);
  return cudaGetLastError();
}

}  // namespace

// boxes (batch, n, 4) f32, eligible (batch, n) u8, classes (batch, n) i32 or
// null, kept (batch, n) u8 out; all contiguous on the device. variant: 0 xyxy
// iou, 1 xyxy diou, 2 yxyx iou, 3 yxyx diou. Returns a cudaError_t; does not
// synchronise.
extern "C" int tmv_nms_sweep(const float* boxes, const uint8_t* eligible,
                             const int32_t* classes, uint8_t* kept, int batch,
                             int n, float threshold, int variant,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aware = classes != nullptr;
  switch (variant * 2 + (aware ? 1 : 0)) {
    case 0: return launch<XYXY_IOU, false>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 1: return launch<XYXY_IOU, true>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 2: return launch<XYXY_DIOU, false>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 3: return launch<XYXY_DIOU, true>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 4: return launch<YXYX_IOU, false>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 5: return launch<YXYX_IOU, true>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 6: return launch<YXYX_DIOU, false>(boxes, eligible, classes, kept, batch, n, threshold, s);
    case 7: return launch<YXYX_DIOU, true>(boxes, eligible, classes, kept, batch, n, threshold, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tmv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
